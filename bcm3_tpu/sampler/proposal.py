"""Device-side adaptive proposals for the PT sampler.

JAX re-design of the reference proposal hierarchy
(reference: src/sampler/Proposal.cpp, ProposalGaussianMixture.cpp,
ProposalGlobalCovariance.cpp). The reference holds one C++ object per
(chain, block); here a proposal for one variable block is a *stacked
pytree of arrays with a leading chain axis*, padded to a common
component count, so that drawing/evaluating/adapting proposals for all
chains is one vmapped, jit-compiled computation — no per-chain objects,
no host round-trips inside the sampling loop.

Semantics kept bit-faithful to the reference:
- responsibility-weighted component selection and per-component adaptive
  scales initialized to 2.38/sqrt(d) (ProposalGaussianMixture.cpp:20-42, 248)
- the mixture MH correction including its use of -log(scale^2)
  (ProposalGaussianMixture.cpp:44-63)
- acceptance-rate-EMA stochastic scale adaptation, clamped to
  [1e-4, 10] (ProposalGaussianMixture.cpp:65-99, Proposal.cpp:201-222)
- reflect-on-bounds for bounded priors (Proposal.cpp:385-397)
- the t-distributed proposal's Gamma(nu/2, scale=nu/2) mixing variable
  (ProposalGlobalCovariance.cpp:17-23 with RNG::GetGamma's
  shape/scale convention, src/utils/RNG.cpp:84-110)
- dimension-dependent target acceptance rates 0.44/0.35/0.30/0.234
  (Proposal.cpp:47-55)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.scipy.special import logsumexp

# defaults from the reference Proposal constructor (Proposal.cpp:25-26);
# the sampler-level recomputed values are never propagated to the proposals
# in the reference, so these are the values actually in effect.
SCALING_EMA_PERIOD = 1000.0
SCALING_LEARNING_RATE = 0.05

# every f32 contraction runs at full float32 precision: a GPU may
# otherwise run it in TF32 (about three decimal digits), and the MH
# acceptance ratio is computed from these
_HIGHEST = jax.lax.Precision.HIGHEST

# update rules
RULE_GMM = 0  # ProposalGaussianMixture::Update
RULE_BASE = 1  # Proposal::Update (used by global_covariance)


def target_acceptance_rate(num_variables: int) -> float:
    """reference: Proposal.cpp:47-55."""
    if num_variables == 1:
        return 0.44
    if num_variables == 2:
        return 0.35
    if num_variables == 3:
        return 0.3
    return 0.234


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "means",
        "chols",
        "inv_chols",
        "log_weights",
        "log_c",
        "scales",
        "acc_ema",
        "selected",
    ],
    meta_fields=["t_dof", "target_accept", "update_rule", "symmetric", "clustered"],
)
@dataclass
class BlockProposal:
    """Adaptive mixture proposal for one variable block, stacked over chains.

    Shapes: C = chains, K = padded component count, d = block size.
    Padding components have log_weights = -inf and identity Cholesky.
    """

    means: jax.Array  # (C, K, d)
    chols: jax.Array  # (C, K, d, d) lower
    # chols^-1, precomputed on the host at adaptation time so Mahalanobis
    # terms are matmuls instead of batched triangular solves (trsm is
    # sequential over d)
    inv_chols: jax.Array  # (C, K, d, d) lower
    log_weights: jax.Array  # (C, K), -inf on padding
    log_c: jax.Array  # (C, K) log MVN normalization constants
    scales: jax.Array  # (C, K) per-component adaptive scales
    acc_ema: jax.Array  # (C, K) acceptance-rate EMAs
    selected: jax.Array  # (C,) int32, component picked for the previous draw; -1 none
    t_dof: float = 0.0
    target_accept: float = 0.234
    update_rule: int = RULE_GMM
    symmetric: bool = False  # True for global_covariance (MH ratio 0)
    # clustered_covariance mode: component = externally supplied cluster
    # assignment instead of a responsibility draw
    # (reference: ProposalClusteredCovariance.cpp:26-56)
    clustered: bool = False

    @property
    def num_chains(self) -> int:
        return self.means.shape[0]

    @property
    def max_components(self) -> int:
        return self.means.shape[1]

    @property
    def block_dim(self) -> int:
        return self.means.shape[2]


def reflect_on_bounds(x, lower, upper):
    """Closed-form equivalent of the reference's reflection loop
    (reference: Proposal.cpp:385-397): fold x into [lower, upper] as a
    triangle wave. Infinite bounds pass through unchanged."""
    span = upper - lower
    finite = jnp.isfinite(lower) & jnp.isfinite(upper)
    safe_span = jnp.where(finite, span, 1.0)
    y = jnp.mod(x - lower, 2.0 * safe_span)
    y = jnp.where(y > safe_span, 2.0 * safe_span - y, y)
    folded = lower + y
    # one-sided bounds: reflect once off the finite side
    lo_only = jnp.isfinite(lower) & ~jnp.isfinite(upper)
    hi_only = ~jnp.isfinite(lower) & jnp.isfinite(upper)
    folded = jnp.where(lo_only, lower + jnp.abs(x - lower), folded)
    folded = jnp.where(hi_only, upper - jnp.abs(upper - x), folded)
    return jnp.where(finite, folded, jnp.where(lo_only | hi_only, folded, x))


# ---------------------------------------------------------------------------
# Per-chain kernels (vmapped over the chain axis by the engine)


def _component_log_pdfs(prop: BlockProposal, x):
    """Per-component log N(x; mean_k, Sigma_k) for ONE chain slice.

    prop fields here have shapes (K, d) / (K, d, d); x is (d,).
    """
    d = x - prop.means  # (K, d)
    s = jnp.einsum("kij,kj->ki", prop.inv_chols, d, precision=_HIGHEST)
    return prop.log_c - 0.5 * jnp.sum(s * s, axis=-1)  # (K,)


def responsibilities_log(prop: BlockProposal, x):
    lp = _component_log_pdfs(prop, x) + prop.log_weights
    return lp - logsumexp(lp)


def update_scales(prop: BlockProposal, key) -> BlockProposal:
    """Adaptive scale update, one chain slice (reference:
    ProposalGaussianMixture.cpp:66-86 for the GMM rule, Proposal.cpp:201-212
    for the base rule used by global_covariance)."""
    u = jax.random.uniform(key, dtype=prop.scales.dtype)
    lr = SCALING_LEARNING_RATE
    t = prop.target_accept
    n_active = jnp.sum(jnp.isfinite(prop.log_weights))

    if prop.update_rule == RULE_GMM:
        learn_rate = 1.0 + u * lr * n_active
        sel = prop.selected
        valid = sel >= 0
        sel_c = jnp.clip(sel, 0, prop.scales.shape[0] - 1)
        ema = prop.acc_ema[sel_c]
        scale = prop.scales[sel_c]
        down = ema < t / (1.0 - lr)
        up = ema > (1.0 + lr) * t
        new_scale = jnp.where(
            down,
            jnp.maximum(scale / learn_rate, 1e-4),
            jnp.where(up, jnp.minimum(scale * learn_rate, 10.0), scale),
        )
        scales = jnp.where(
            valid, prop.scales.at[sel_c].set(new_scale), prop.scales
        )
    else:
        learn_rate = 1.0 + u * lr
        ema = prop.acc_ema[0]
        scale = prop.scales[0]
        down = ema < 0.952381 * t
        up = ema > 1.05 * t
        new_scale = jnp.where(
            down,
            jnp.maximum(scale / learn_rate, 1e-4),
            jnp.where(up, jnp.minimum(scale * learn_rate, 10.0), scale),
        )
        scales = prop.scales.at[0].set(new_scale)

    return dataclasses.replace(prop, scales=scales)


def propose(prop: BlockProposal, x_block, lower, upper, key):
    """Draw a new block position, one chain slice (reference:
    ProposalGaussianMixture.cpp:20-42). Returns (new_block, selected)."""
    kk, kz, kg = jax.random.split(key, 3)
    log_resp = responsibilities_log(prop, x_block)
    selected = jax.random.categorical(kk, log_resp)

    z = jax.random.normal(kz, x_block.shape, dtype=x_block.dtype)
    step = jnp.matmul(prop.chols[selected], z, precision=_HIGHEST)

    if prop.t_dof > 0.0:
        # reference quirk preserved: w ~ Gamma(nu/2, SCALE=nu/2)
        w = jax.random.gamma(kg, 0.5 * prop.t_dof, dtype=x_block.dtype) * (
            0.5 * prop.t_dof
        )
        t_scale = jax.lax.rsqrt(w)
    else:
        t_scale = jnp.asarray(1.0, dtype=x_block.dtype)

    new_block = x_block + step * (t_scale * prop.scales[selected])
    new_block = reflect_on_bounds(new_block, lower, upper)
    return new_block, selected.astype(jnp.int32)


def mh_log_ratio(prop: BlockProposal, x_block, new_block):
    """Mixture MH correction, one chain slice (reference:
    ProposalGaussianMixture.cpp:44-63, including the -log(scale^2) factor
    which the reference uses regardless of block dimension)."""
    if prop.symmetric:
        return jnp.zeros((), dtype=x_block.dtype)
    log_fwd_resp = responsibilities_log(prop, x_block)
    log_rev_resp = responsibilities_log(prop, new_block)

    v = (new_block - x_block)[None, :] / prop.scales[:, None]  # (K, d)
    s_fwd = jnp.einsum("kij,kj->ki", prop.inv_chols, v, precision=_HIGHEST)
    # the Gaussian is symmetric in v -> forward and reverse Mahalanobis terms
    # are identical; only the responsibilities differ
    quad = -0.5 * jnp.sum(s_fwd * s_fwd, axis=-1)
    base = -2.0 * jnp.log(prop.scales) + prop.log_c + quad
    fwd = logsumexp(base + log_fwd_resp)
    rev = logsumexp(base + log_rev_resp)
    return rev - fwd


# ---------------------------------------------------------------------------
# Ensemble-batched kernels for the shared (L, K, ...) mixture layout.
#
# Under the engine's nested vmap (ensembles x ladder), every contraction
# against the shared Cholesky factors is auto-batched into a dot_general
# whose matrix operand XLA broadcasts to a per-chain (C, K, d, d)
# intermediate — measured 87 GB at 65,536 chains x d=520 (compile-time
# OOM), and ~100 MB of pure HBM traffic per mutate block even at d=20.
# These kernels keep the factors unbatched: the ensemble axis enters as
# the FREE dimension of one (l,k)-batched matmul, so nothing of shape
# (C, K, d, d) ever exists. Per-lane RNG
# keeps the exact split structure of the per-chain kernels, so the
# random stream is unchanged.


def _ensemble_log_pdfs(prop: BlockProposal, x_el):
    """(E, L, K) log N(x; mean_lk, Sigma_lk); mixture fields at (L, ...)."""
    diff = x_el[:, :, None, :] - prop.means[None]  # (E, L, K, d)
    s = jnp.einsum("lkij,elkj->elki", prop.inv_chols, diff, precision=_HIGHEST)
    return prop.log_c[None] - 0.5 * jnp.sum(s * s, axis=-1)


def _ensemble_log_resp(prop: BlockProposal, x_el):
    lp = _ensemble_log_pdfs(prop, x_el) + prop.log_weights[None]
    return lp - logsumexp(lp, axis=-1, keepdims=True)


def propose_ensemble(prop: BlockProposal, x_el, lower, upper, keys_el):
    """Batched `propose` over (E, L) lanes with shared mixture params.

    x_el: (E, L, d); keys_el: (E, L) PRNG keys (same per-lane keys the
    vmapped path would receive). Returns (new_block (E, L, d),
    selected (E, L) int32, log_resp (E, L, K)) — the forward
    responsibilities are returned so `mh_log_ratio_ensemble` can reuse
    them instead of recomputing the mixture pass at x."""
    E, L, d = x_el.shape
    K = prop.means.shape[1]
    log_resp = _ensemble_log_resp(prop, x_el)  # (E, L, K)

    t_dof = prop.t_dof

    def draw(key, lr):
        # identical split structure to propose(): kk, kz, kg
        kk, kz, kg = jax.random.split(key, 3)
        sel = jax.random.categorical(kk, lr)
        z = jax.random.normal(kz, (d,), dtype=x_el.dtype)
        if t_dof > 0.0:
            w = jax.random.gamma(kg, 0.5 * t_dof, dtype=x_el.dtype) * (
                0.5 * t_dof
            )
            t_scale = jax.lax.rsqrt(w)
        else:
            t_scale = jnp.asarray(1.0, dtype=x_el.dtype)
        return sel, z, t_scale

    sel, z, t_scale = jax.vmap(jax.vmap(draw))(keys_el, log_resp)

    # steps for every component via one shared-matrix matmul, then a
    # one-hot pick — K x the matvec FLOPs (K <= 13) instead of a
    # per-lane (C, d, d) gather materialization
    # (E, L, K, d)
    steps = jnp.einsum("lkij,elj->elki", prop.chols, z, precision=_HIGHEST)
    onehot = jax.nn.one_hot(sel, K, dtype=x_el.dtype)  # (E, L, K)
    step = jnp.einsum("elk,elki->eli", onehot, steps, precision=_HIGHEST)
    scales_el = prop.scales.reshape(E, L, K)
    scale_sel = jnp.sum(onehot * scales_el, axis=-1)  # (E, L)

    new_block = x_el + step * (t_scale * scale_sel)[..., None]
    new_block = reflect_on_bounds(new_block, lower, upper)
    return new_block, sel.astype(jnp.int32), log_resp


def mh_log_ratio_ensemble(prop: BlockProposal, x_el, new_el,
                          log_fwd_resp=None):
    """Batched `mh_log_ratio` over (E, L) lanes with shared mixture
    params. Returns (E, L). Pass `log_fwd_resp` (the responsibilities
    at x_el that `propose_ensemble` already computed) to skip one of
    the three mixture passes per step."""
    if prop.symmetric:
        return jnp.zeros(x_el.shape[:2], dtype=x_el.dtype)
    E, L, d = x_el.shape
    K = prop.means.shape[1]
    if log_fwd_resp is None:
        log_fwd_resp = _ensemble_log_resp(prop, x_el)
    log_rev_resp = _ensemble_log_resp(prop, new_el)

    scales_el = prop.scales.reshape(E, L, K)
    v = (new_el - x_el)[:, :, None, :] / scales_el[..., None]  # (E, L, K, d)
    s = jnp.einsum("lkij,elkj->elki", prop.inv_chols, v, precision=_HIGHEST)
    quad = -0.5 * jnp.sum(s * s, axis=-1)
    base = -2.0 * jnp.log(scales_el) + prop.log_c[None] + quad
    fwd = logsumexp(base + log_fwd_resp, axis=-1)
    rev = logsumexp(base + log_rev_resp, axis=-1)
    return rev - fwd


def propose_clustered_ensemble(
    prop: BlockProposal, x_el, cluster_el, lower, upper, keys_el
):
    """Batched `propose_clustered` over (E, L) lanes with shared mixture
    params (same rationale as `propose_ensemble`: a per-lane
    `chols[cluster]` gather against the shared (L, K, d, d) factors
    materializes a (C, d, d) intermediate; the one-hot einsum form keeps
    the factors unbatched). Per-lane RNG split structure (kz, kg) is
    identical to the per-chain kernel, so the random stream is
    unchanged. Returns (new_block (E, L, d), selected (E, L) int32)."""
    E, L, d = x_el.shape
    K = prop.means.shape[1]
    selected = jnp.clip(cluster_el, 0, K - 1)

    t_dof = prop.t_dof

    def draw(key):
        kz, kg = jax.random.split(key)
        z = jax.random.normal(kz, (d,), dtype=x_el.dtype)
        if t_dof > 0.0:
            w = jax.random.gamma(kg, 0.5 * t_dof, dtype=x_el.dtype) * (
                0.5 * t_dof
            )
            t_scale = jax.lax.rsqrt(w)
        else:
            t_scale = jnp.asarray(1.0, dtype=x_el.dtype)
        return z, t_scale

    z, t_scale = jax.vmap(jax.vmap(draw))(keys_el)

    # (E, L, K, d)
    steps = jnp.einsum("lkij,elj->elki", prop.chols, z, precision=_HIGHEST)
    onehot = jax.nn.one_hot(selected, K, dtype=x_el.dtype)  # (E, L, K)
    step = jnp.einsum("elk,elki->eli", onehot, steps, precision=_HIGHEST)
    scales_el = prop.scales.reshape(E, L, K)
    scale_sel = jnp.sum(onehot * scales_el, axis=-1)  # (E, L)

    new_block = x_el + step * (t_scale * scale_sel)[..., None]
    new_block = reflect_on_bounds(new_block, lower, upper)
    return new_block, selected.astype(jnp.int32)


def mh_log_ratio_clustered_ensemble(
    prop: BlockProposal, x_el, new_el, cur_cluster_el, new_cluster_el
):
    """Batched `mh_log_ratio_clustered` over (E, L) lanes with shared
    mixture params. The single-component density of the step is symmetric
    in ±diff, so the (E, L, K) density table is computed once and the
    forward/backward terms are one-hot picks. Returns (E, L)."""
    E, L, d = x_el.shape
    K = prop.means.shape[1]
    cc = jnp.clip(cur_cluster_el, 0, K - 1)
    nc = jnp.clip(new_cluster_el, 0, K - 1)

    scales_el = prop.scales.reshape(E, L, K)
    v = (new_el - x_el)[:, :, None, :] / scales_el[..., None]  # (E, L, K, d)
    s = jnp.einsum("lkij,elkj->elki", prop.inv_chols, v, precision=_HIGHEST)
    quad = -0.5 * jnp.sum(s * s, axis=-1)
    base = -2.0 * jnp.log(scales_el) + prop.log_c[None] + quad  # (E, L, K)

    oh_cc = jax.nn.one_hot(cc, K, dtype=x_el.dtype)
    oh_nc = jax.nn.one_hot(nc, K, dtype=x_el.dtype)
    log_fwd = jnp.sum(oh_cc * base, axis=-1)
    log_bwd = jnp.sum(oh_nc * base, axis=-1)
    return jnp.where(cc == nc, 0.0, log_bwd - log_fwd).astype(x_el.dtype)


def propose_clustered(prop: BlockProposal, x_block, cluster, lower, upper, key):
    """Clustered-covariance draw, one chain slice: the component is the
    cluster of the current (full) position instead of a responsibility draw
    (reference: ProposalClusteredCovariance.cpp GetNewSample:26-56).
    Returns (new_block, selected)."""
    kz, kg = jax.random.split(key)
    selected = jnp.clip(cluster, 0, prop.means.shape[0] - 1)

    z = jax.random.normal(kz, x_block.shape, dtype=x_block.dtype)
    step = jnp.matmul(prop.chols[selected], z, precision=_HIGHEST)

    if prop.t_dof > 0.0:
        # same Gamma(nu/2, scale=nu/2) mixing quirk as the mixture proposal
        # (reference: ProposalClusteredCovariance.cpp:37-43)
        w = jax.random.gamma(kg, 0.5 * prop.t_dof, dtype=x_block.dtype) * (
            0.5 * prop.t_dof
        )
        t_scale = jax.lax.rsqrt(w)
    else:
        t_scale = jnp.asarray(1.0, dtype=x_block.dtype)

    new_block = x_block + step * (t_scale * prop.scales[selected])
    new_block = reflect_on_bounds(new_block, lower, upper)
    return new_block, selected.astype(jnp.int32)


def mh_log_ratio_clustered(prop: BlockProposal, x_block, new_block, cur_cluster, new_cluster):
    """MH correction for cross-cluster moves, one chain slice (reference:
    ProposalClusteredCovariance.cpp CalculateMHRatio:58-84): symmetric
    within a cluster; across clusters the ratio of the two single-component
    densities of the step, each including the -log(scale^2) factor."""
    cc = jnp.clip(cur_cluster, 0, prop.means.shape[0] - 1)
    nc = jnp.clip(new_cluster, 0, prop.means.shape[0] - 1)

    def comp_logp(comp, v):
        vv = v / prop.scales[comp]
        s = jnp.matmul(prop.inv_chols[comp], vv, precision=_HIGHEST)
        return -2.0 * jnp.log(prop.scales[comp]) + prop.log_c[comp] - 0.5 * jnp.sum(s * s)

    diff = new_block - x_block
    log_fwd = comp_logp(cc, diff)
    log_bwd = comp_logp(nc, -diff)
    return jnp.where(cc == nc, 0.0, log_bwd - log_fwd).astype(x_block.dtype)


def notify_accepted(prop: BlockProposal, accepted) -> BlockProposal:
    """EMA update for the selected component, one chain slice (reference:
    ProposalGaussianMixture.cpp:89-99; base rule Proposal.cpp:214-222
    also only has the single slot 0 for global_covariance)."""
    ema_alpha = 2.0 / (SCALING_EMA_PERIOD + 1.0)
    sel = jnp.clip(prop.selected, 0, prop.acc_ema.shape[0] - 1)
    target = jnp.where(accepted, 1.0, 0.0).astype(prop.acc_ema.dtype)
    new_ema = prop.acc_ema[sel] + (target - prop.acc_ema[sel]) * ema_alpha
    return dataclasses.replace(prop, acc_ema=prop.acc_ema.at[sel].set(new_ema))


# ---------------------------------------------------------------------------
# Host-side construction


def build_block_proposal(
    gmms,
    num_chains: int,
    block_dim: int,
    dtype,
    t_dof: float = 0.0,
    proposal_type: str = "gaussian_mixture",
) -> BlockProposal:
    """Assemble a stacked BlockProposal from host GMM fits.

    ``gmms`` is a list of bcm3_tpu.stats.gmm.GMM objects: either one per
    chain (len == num_chains) or one per LADDER POSITION shared by every
    ensemble (len == num_chains / num_ensembles). The mixture parameters
    (means/chols/weights) are stored at the length of ``gmms`` — storing
    them per chain is the dominant HBM cost of large ensemble runs
    (measured 3.2 GiB at 32k ensembles, see BASELINE.md) — while the
    acceptance-EMA scale state is always per chain (the reference adapts
    scales per chain, Proposal.cpp:201-222). Components are padded to
    the max K; fit-failed entries should already carry the
    prior-variance fallback.
    """
    K = max(g.num_components for g in gmms)
    d = block_dim
    n_mix = len(gmms)
    means = np.zeros((n_mix, K, d))
    chols = np.tile(np.eye(d), (n_mix, K, 1, 1))
    inv_chols = np.tile(np.eye(d), (n_mix, K, 1, 1))
    log_w = np.full((n_mix, K), -np.inf)
    log_c = np.zeros((n_mix, K))
    scales = np.full((num_chains, K), 2.38 / np.sqrt(d))
    ta = target_acceptance_rate(d)
    acc_ema = np.full((num_chains, K), ta)

    from scipy.linalg import solve_triangular as _host_trsm

    # distinct GMM objects may repeat (legacy per-chain lists):
    # invert each distinct GMM's factors once
    inv_cache: dict[int, np.ndarray] = {}
    for c, g in enumerate(gmms):
        k = g.num_components
        means[c, :k] = g.means
        chols[c, :k] = g.chols
        cached = inv_cache.get(id(g))
        if cached is None:
            cached = np.stack(
                [
                    _host_trsm(np.asarray(g.chols[ki]), np.eye(d), lower=True)
                    for ki in range(k)
                ]
            )
            inv_cache[id(g)] = cached
        inv_chols[c, :k] = cached
        with np.errstate(divide="ignore"):
            log_w[c, :k] = np.log(g.weights)
        log_c[c, :k] = g.log_c

    rule = RULE_BASE if proposal_type == "global_covariance" else RULE_GMM
    symmetric = proposal_type == "global_covariance"
    clustered = proposal_type == "clustered_covariance"
    if clustered and any(g.num_components != K for g in gmms):
        raise ValueError(
            "clustered proposals require component index == cluster index; "
            "all chains must carry exactly num_clusters components"
        )
    return BlockProposal(
        means=jnp.asarray(means, dtype=dtype),
        chols=jnp.asarray(chols, dtype=dtype),
        inv_chols=jnp.asarray(inv_chols, dtype=dtype),
        log_weights=jnp.asarray(log_w, dtype=dtype),
        log_c=jnp.asarray(log_c, dtype=dtype),
        scales=jnp.asarray(scales, dtype=dtype),
        acc_ema=jnp.asarray(acc_ema, dtype=dtype),
        selected=jnp.full((num_chains,), -1, dtype=jnp.int32),
        t_dof=float(t_dof),
        target_accept=ta,
        update_rule=rule,
        symmetric=symmetric,
        clustered=clustered,
    )
