"""Parallel-tempered Metropolis-Hastings sampler.

Re-design of the reference PT engine (reference: src/sampler/SamplerPT.cpp,
SamplerPTChain.cpp) for the XLA compilation model:

- the reference advances each tempered chain as a thread-pool task
  (SamplerPT.cpp:308-319); here the whole chain population is one stacked
  array advanced by a single jit-compiled, vmapped update, so every
  likelihood evaluation in an iteration is one batched call that can fill
  the device;
- whole *segments* of the run (all iterations between two proposal
  adaptations) execute on device inside one `lax.scan`, emitting thinned
  samples; the host is only involved at adaptation boundaries, where it
  pulls the device sample history, fits GMMs (bcm3_tpu/stats/gmm.py) and
  pushes back new stacked proposal arrays — mirroring the reference's
  pause-adapt-reset structure (SamplerPT.cpp:231-249) as a natural jit
  boundary;
- replica exchange (SamplerPT.cpp:277-306) is a masked permutation of the
  chain axis computed from even/odd pair parity — a static collective
  pattern when the chain axis is sharded over a device mesh;
- per-thread RNG (Sampler.cpp:91-98) is replaced by counter-based
  `jax.random` keys split per (iteration, chain), making runs reproducible
  independent of device count — removing the reference's thread-count
  dependent seeding caveat (Sampler.cpp:147).

Statistical semantics kept faithful:
- power posterior lprior + T*llh with the T=0 chain sampling directly
  from the prior and the -inf*0 convention (SamplerPTChain.cpp:221-240)
- power-law temperature ladder with T[0] = 0 (SamplerPT.cpp:87-93)
- deterministic/stochastic even-odd and stochastic-random swap schemes
  (SamplerPT.cpp:28-32, 277-306)
- per-block proposals with the mixture MH correction and acceptance-EMA
  scale adaptation (see bcm3_tpu/sampler/proposal.py)
- float32 ring-buffer sample history with subsampling (SampleHistory.cpp)
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.likelihoods import Likelihood
from bcm3_tpu.model.prior import Prior
from bcm3_tpu.sampler import blocking as blocking_mod
from bcm3_tpu.sampler import proposal as prop_mod
from bcm3_tpu.sampler import spectral as spectral_mod
from bcm3_tpu.sampler.proposal import BlockProposal
from bcm3_tpu.stats.gmm import GMM, fit_gmm_best_aic, fit_gmm

logger = logging.getLogger("bcm3_tpu.sampler")

_NEG_INF = -np.inf


def _to_host(arr) -> np.ndarray:
    """Device array -> host numpy, transparently across processes.

    In a multi-process (jax.distributed) run, globally-sharded arrays are
    not fully addressable from one process; gather them with an
    all-gather collective so every process sees the full value (used for
    the host-side adaptation/statistics boundaries, which must compute
    identically on every process)."""
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def _local_chain_rows(arr) -> Tuple[np.ndarray, int]:
    """Extract this process's contiguous chain-axis block of a globally
    sharded (S, C, ...) emission array. Returns (local_rows, chain_start).

    Used for per-host sharded emission: each host materializes and writes
    only the chains it owns (SURVEY §5 'sharded sample store') instead of
    funnelling the full population through host 0."""
    shards = [
        s for s in arr.addressable_shards
    ]
    shards.sort(key=lambda s: (s.index[1].start or 0))
    start = shards[0].index[1].start or 0
    parts = [np.asarray(s.data) for s in shards]
    local = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    return local, start


@dataclass
class PTConfig:
    """Sampler configuration; defaults match the reference option tables
    (reference: Sampler.cpp:142-149, SamplerPT.cpp:147-172)."""

    num_samples: int = 2500
    use_every_nth: int = 1
    seed: int = 0

    num_chains: int = 6
    blocking_strategy: str = "one_block"
    proposal_type: str = "gaussian_mixture"
    adapt_proposal_samples: int = 2000
    adapt_proposal_times: int = 2
    max_history_size: int = 2000
    adapt_proposal_max_history_samples: int = 2000
    adapt_proposal_max_clustering_samples: int = 1000
    # accepted for config compatibility; in the reference the flag it sets
    # (proposal_scaling_adaptations_done, SamplerPT.cpp:250-255) is never
    # consulted by any proposal — scale adaptation continues regardless, so
    # the option's only observable effect is a log line
    stop_proposal_scaling: int = 6000
    sample_clustering_nn: int = 3
    sample_clustering_nn2: int = 7
    sample_clustering_num_clusters: int = 4
    swapping_scheme: str = "deterministic_even_odd"
    exchange_probability: float = 0.5
    num_exploration_steps: int = 1
    temperature_schedule_power: float = 3.0
    temperature_schedule_max: float = 1.0
    output_proposal_adaptation: bool = False
    # Dump each adaptation's spectral-clustering intermediates (scaled
    # input samples, kernel K, embedding Y, assignments) for R-side
    # inspection via sample_history_clustering.nc (reference:
    # SampleHistoryClustering.h:32 output_sample_clustering,
    # SampleHistoryClustering.cpp:40-56). Only applies when clustering
    # runs (clustered_covariance proposal / clustered_autoblock).
    output_sample_clustering: bool = False
    proposal_t_dof: float = 0.0
    initial_position_tries: int = 100
    dtype: Any = None  # defaults to float64 under x64, else float32
    # extension (no reference equivalent): number of independent
    # PT replicas advanced in the same batched device computation. Each
    # replica owns a full temperature ladder and exchanges only internally;
    # emitted samples from all replicas are pooled per temperature. This is
    # the lever that fills the chip when the ladder alone is too small.
    num_ensembles: int = 1
    # extension: mid-run checkpoint/resume (the reference cannot
    # resume a crashed run, SURVEY §5). When set, the full sampler state is
    # saved at every segment boundary and restored on the next run().
    checkpoint_file: str = ""
    # extension: shard the chain population over all available
    # devices (jax.sharding.Mesh over the chain axis). Replica-exchange
    # permutations lower to collective permutes between devices. Requires the
    # total chain count (num_chains * num_ensembles) to be divisible by
    # the device count.
    shard_over_devices: bool = False
    # Use only the first `mesh_devices` devices for the chain mesh
    # (None = all). Lets scaling benchmarks sweep device counts.
    mesh_devices: int | None = None
    # GMM adaptation fits: "host" = numpy EM (the reference-mirroring
    # implementation), "device" = batched jitted EM over all
    # (component count, retry) fits at once (stats/gmm_device.py),
    # "auto" = device for high-dimensional targets where the host EM
    # stalls the sampler, host otherwise.
    gmm_fit_backend: str = "auto"
    # Emitted samples are pulled to the host in chunks of this many
    # emissions, overlapping device compute with device->host transfer.
    # None = auto-size chunks to ~32 MB per pull; 0 = one monolithic
    # pull per segment. Results are
    # bit-identical for any chunk size; only the transfer schedule
    # changes.
    emit_chunk_size: int | None = None
    # extension: when set, the run is captured with the JAX
    # profiler (TensorBoard trace) — the deep-profiling story the
    # reference's wall-clock-only Timer lacks (SURVEY §5).
    profile_dir: str = ""
    # Dtype for emitted samples pulled to the host (None = sampler dtype).
    # float32 halves device->host transfer volume, which dominates
    # end-to-end time on bandwidth-limited links; the in-sampler chain
    # state stays at full precision, only the emitted copies are cast
    # (the reference's own SampleHistory is float32, SampleHistory.cpp:41).
    emit_dtype: Any = None
    # Emit only the fixed-temperature (T=1) row of each ladder, exactly
    # like the reference's EmitSample (reference: SamplerPT.cpp:321-330
    # emits only chains with GetIsFixedTemperature()). Cuts device->host
    # transfer by the ladder length; the heated chains remain on device
    # for exchange moves. Default False keeps the all-temperature store
    # (needed by predict over temperatures / marginal-likelihood sums).
    emit_fixed_only: bool = False

    def resolved_dtype(self):
        if self.dtype is not None:
            return self.dtype
        return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def temperature_ladder(
    num_chains: int, power: float = 3.0, t_max: float = 1.0
) -> np.ndarray:
    """Power-law ladder with T[0] = 0 (reference: SamplerPT.cpp:87-93)."""
    temps = np.zeros(num_chains)
    for i in range(1, num_chains - 1):
        temps[i] = t_max * (i / (num_chains - 1)) ** power
    temps[num_chains - 1] = t_max
    return temps


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "x",
        "lprior",
        "llh",
        "att_mut",
        "acc_mut",
        "att_exc",
        "acc_exc",
        "history",
        "hist_adds",
        "swap_parity",
        "key",
    ],
    meta_fields=[],
)
@dataclass
class PTState:
    x: jax.Array  # (C, D)
    lprior: jax.Array  # (C,)
    llh: jax.Array  # (C,)
    att_mut: jax.Array  # (C,) int32
    acc_mut: jax.Array  # (C,)
    att_exc: jax.Array  # (C,)
    acc_exc: jax.Array  # (C,)
    # (C, H*D) float32 ring buffer, row h of chain c at columns
    # [h*D, (h+1)*D). Stored FLATTENED: the natural (C, H, D) shape puts
    # the tiny D axis in the minor-two layout dims, and one XLA
    # layout-assignment copy into {D, C, H}:T(8,128) pads D -> 128 lanes
    # (measured: a 590 MB logical buffer materialized as a 37.7 GB
    # allocation at the banana config, D=2). A 2-D array can only pad
    # 8x128 on two large axes, which is bounded by ~2%.
    history: jax.Array
    hist_adds: jax.Array  # () int32 — number of AddSample calls (lockstep)
    swap_parity: jax.Array  # () int32: 0 -> next swap starts even
    key: jax.Array


class SamplerPT:
    """Parallel-tempered MH sampler over a chain population."""

    def __init__(
        self,
        prior: Prior,
        likelihood: Likelihood,
        config: PTConfig,
        sample_handlers: Optional[Sequence] = None,
    ):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers = list(sample_handlers or [])
        self.dtype = config.resolved_dtype()

        C = config.num_chains
        E = max(1, config.num_ensembles)
        self.ladder_size = C
        self.num_ensembles = E
        # total chain population advanced on device: E replicas x C temperatures
        self.num_chains = E * C
        self.num_variables = prior.num_variables
        self.ladder = temperature_ladder(
            C, config.temperature_schedule_power, config.temperature_schedule_max
        )
        self.temperatures = np.tile(self.ladder, E)
        # emission view: all temperatures, or only the fixed (T=1) row per
        # ladder (reference: SamplerPT.cpp:321-330)
        self._emit_L = 1 if (config.emit_fixed_only and C > 1) else C
        self.emit_ladder = self.ladder[C - self._emit_L:]

        ptype = config.proposal_type
        if ptype == "parametric_mixture":
            # legacy alias used by reference example configs
            ptype = "gaussian_mixture"
        self._use_mtfa_fit = False
        if ptype == "gaussian_mixture_fit_in_r":
            # the reference shells out to an R fitting service per adaptation
            # (reference: ProposalGaussianMixtureFitInR.cpp:60-135 runs
            # R/fit_proposal.r: EMMIXmfa::mtfa over a component x factor
            # grid with BIC selection, mclust fallback); the in-process
            # mixture-of-t-factor-analyzers fit (bcm3_tpu/stats/mfa.py)
            # reproduces that procedure without the Rscript round trip.
            # Device-side proposal machinery is the same Gaussian mixture —
            # only the adaptation-time fit differs.
            logger.info(
                "gaussian_mixture_fit_in_r: using the in-process "
                "mixture-of-t-factor-analyzers fit (replaces the "
                "reference's Rscript round trip)"
            )
            self._use_mtfa_fit = True
            ptype = "gaussian_mixture"
        if ptype not in (
            "gaussian_mixture",
            "gaussian_mixture_adjustedAIC",
            "global_covariance",
            "clustered_covariance",
        ):
            raise ValueError(f"Unknown proposal type '{config.proposal_type}'")
        self.proposal_type = ptype
        # spectral-clustering assigner for clustered proposals / blocking
        # (reference: SamplerPTChain owns a SampleHistoryClustering per
        # chain; here ONE clustering fit on the pooled fixed-temperature
        # history is shared by all chains so assignment stays a single
        # batched device computation — a documented batching deviation,
        # like the shared block structure)
        self._assigner = None

        # History sizing (reference: SamplerPT.cpp:115-128)
        expected = config.adapt_proposal_samples * config.use_every_nth
        if C > 1 and config.swapping_scheme == "deterministic_even_odd":
            expected *= config.num_exploration_steps + 1
        if expected == 0:
            expected = 1
        self.history_subsampling = max(
            1, (expected + config.max_history_size - 1) // config.max_history_size
        )
        self.history_size = max(1, expected // self.history_subsampling)

        self.adaptations_done = 0
        self.blocks: List[np.ndarray] = blocking_mod.get_blocks(
            "one_block"
            if config.blocking_strategy in ("one_block",)
            else "no_blocking"
            if config.blocking_strategy == "no_blocking"
            else "no_blocking",  # Turek variants start unblocked (no history yet)
            self.num_variables,
        )
        if config.blocking_strategy not in (
            "one_block",
            "no_blocking",
            "Turek",
            "clustered_autoblock",
        ):
            raise ValueError(
                f"Unknown blocking strategy '{config.blocking_strategy}'"
            )

        self.proposals: List[BlockProposal] = self._initial_proposals(self.blocks)

        # GMM adaptation backend (see PTConfig.gmm_fit_backend)
        if config.gmm_fit_backend not in ("auto", "host", "device"):
            raise ValueError(
                f"Unknown gmm_fit_backend '{config.gmm_fit_backend}'"
            )
        use_device_gmm = config.gmm_fit_backend == "device" or (
            config.gmm_fit_backend == "auto" and self.num_variables >= 8
        )
        self._gmm_fitter_multi = None
        if self._use_mtfa_fit:
            from bcm3_tpu.stats.mfa import fit_proposal_mtfa

            self._gmm_fitter = fit_proposal_mtfa
        elif use_device_gmm:
            from bcm3_tpu.stats.gmm_device import (
                fit_gmm_best_aic_device,
                fit_gmm_best_aic_device_multi,
            )

            self._gmm_fitter = fit_gmm_best_aic_device
            # whole-ladder batched fit: all positions' (k, retry) EM fits
            # in one device program (the adaptation-boundary stall is
            # dominated by sequential per-position EM launches otherwise)
            self._gmm_fitter_multi = fit_gmm_best_aic_device_multi
        else:
            self._gmm_fitter = fit_gmm_best_aic

        # RNG streams: device sampling key + host adaptation rng
        seed = config.seed if config.seed != 0 else int(time.time_ns() % (2**31))
        self._root_key = jax.random.PRNGKey(seed)
        self._host_rng = np.random.default_rng(seed ^ 0x9E3779B9)

        self.total_evaluations = 0
        # optional throttled console progress sink
        # (reference: ProgressIndicatorConsole wired by Sampler::Run,
        # Sampler.cpp:190-201); attached by the CLI, off in library use
        self.progress = None
        self._segment_fns = {}
        # adaptation dumps for sampler_adaptation.nc: list of
        # (iteration, [(block, gmm-of-fixed-T-chain), ...], history or None)
        self.adaptation_iteration = 0
        self.adaptation_dumps = []
        if config.output_proposal_adaptation:
            self.adaptation_dumps.append(
                (
                    0,
                    [(b, self._fallback_gmm(b)) for b in self.blocks],
                    None,
                )
            )
        self.adaptation_iteration = 1
        # spectral-clustering dumps for sample_history_clustering.nc:
        # list of (clustering iteration, {name: array}) — reference:
        # SampleHistoryClustering.cpp:40-56
        self.clustering_dumps = []
        self.clustering_iteration = 0

    @property
    def expected_emitted_samples(self) -> int:
        """Rows in the output store: per emitted step, one row per ensemble."""
        return self.config.num_samples * self.num_ensembles

    # ------------------------------------------------------------------
    # Proposal construction

    def _fallback_gmm(self, block: np.ndarray) -> GMM:
        """Single Gaussian with prior mean/variance (reference:
        ProposalGaussianMixture.cpp:212-246)."""
        mean = self.prior.marginal_mean()[block]
        var = self.prior.marginal_variance()[block]
        gmm = GMM.from_params(
            mean[None, :], np.diag(var)[None, :, :], np.ones(1)
        )
        if gmm is None:
            gmm = GMM.from_params(
                np.zeros((1, len(block))),
                np.eye(len(block))[None],
                np.ones(1),
            )
        return gmm

    def _initial_proposals(self, blocks: List[np.ndarray]) -> List[BlockProposal]:
        # before any history exists a clustered proposal degenerates to a
        # single prior-variance Gaussian with no cluster structure
        # (reference: ProposalClusteredCovariance.cpp InitializeImpl:154-183)
        ptype = (
            "gaussian_mixture"
            if self.proposal_type == "clustered_covariance"
            else self.proposal_type
        )
        props = []
        for block in blocks:
            fallback = self._fallback_gmm(block)
            prop = prop_mod.build_block_proposal(
                [fallback] * self.ladder_size,
                self.num_chains,
                len(block),
                self.dtype,
                t_dof=self.config.proposal_t_dof,
                proposal_type=ptype,
            )
            props.append(prop)
        return props

    # ------------------------------------------------------------------
    # Device-side evaluation

    def _evaluate(self, x):
        """Batched prior + likelihood evaluation. x: (C, D).

        NaNs are mapped to -inf (proposal rejection), the framework-level
        equivalent of the reference's soft-fail convention
        (reference: LikelihoodPopPKTrajectory.cpp:400-424).
        """
        lprior = self.prior.log_pdf(x)
        # likelihoods may provide a natively batched path (e.g. the PopPK
        # transit kernel, bcm3_tpu/ops/transit_pallas.py)
        batched = getattr(self.likelihood, "log_prob_batched", None)
        llh = batched(x) if batched is not None else jax.vmap(
            self.likelihood.log_prob
        )(x)
        if self.likelihood.learning_rate != 1.0:
            llh = llh * self.likelihood.learning_rate
        lprior = jnp.where(jnp.isnan(lprior), _NEG_INF, lprior)
        llh = jnp.where(jnp.isnan(llh), _NEG_INF, llh)
        return lprior.astype(self.dtype), llh.astype(self.dtype)

    def _lpp(self, lprior, llh, temps):
        """Power posterior with the reference's T=0 convention
        (reference: SamplerPTChain.cpp:231-237)."""
        return jnp.where(temps == 0.0, lprior, lprior + temps * llh)

    # ------------------------------------------------------------------
    # Moves

    def _history_add(self, state: PTState, x, mask=None) -> PTState:
        """Ring-buffer add with subsampling for all T != 0 chains
        (reference: SampleHistory.cpp AddSample)."""
        n = state.hist_adds + 1
        do_write = (n % self.history_subsampling) == 0
        ix = ((n // self.history_subsampling) - 1) % self.history_size
        temps = jnp.asarray(self.temperatures, dtype=self.dtype)
        write_mask = temps != 0.0
        if mask is not None:
            write_mask = write_mask & mask
        D = self.num_variables
        col = (ix * D).astype(jnp.int32)
        cur = jax.lax.dynamic_slice(
            state.history, (jnp.int32(0), col), (state.history.shape[0], D)
        )
        rows = jnp.where(write_mask[:, None], x.astype(jnp.float32), cur)
        new_hist = jax.lax.cond(
            do_write,
            lambda h: jax.lax.dynamic_update_slice(h, rows, (jnp.int32(0), col)),
            lambda h: h,
            state.history,
        )
        return dataclasses.replace(state, history=new_hist, hist_adds=n)

    _PROP_SHARED = ("means", "chols", "inv_chols", "log_weights", "log_c")
    _PROP_PER_CHAIN = ("scales", "acc_ema", "selected")

    def _prop_apply(self, fn, prop, *args, returns_prop=False):
        """vmap ``fn(per_chain_prop, *args)`` over the chain population.

        Mixture parameters (means/chols/...) are stored once per LADDER
        POSITION and broadcast to every ensemble through a nested vmap
        with in_axes=None — never materialized at (C, ...). Storing them
        per chain was the dominant HBM cost of large ensemble runs
        (3.2 GiB at 32k ensembles, BASELINE.md). Per-chain scale/EMA
        state batches normally. Falls back to a flat vmap when the
        proposal carries legacy per-chain mixture arrays (old
        checkpoints).
        """
        C = self.num_chains
        E, L = self.num_ensembles, self.ladder_size
        if prop.means.shape[0] == C and E > 1:
            # legacy layout: everything per chain
            out = jax.vmap(fn)(prop, *args)
            if returns_prop:
                return dataclasses.replace(
                    prop,
                    **{f: getattr(out, f) for f in self._PROP_PER_CHAIN},
                )
            return out

        shared = tuple(getattr(prop, f) for f in self._PROP_SHARED)
        per = tuple(
            getattr(prop, f).reshape((E, L) + getattr(prop, f).shape[1:])
            for f in self._PROP_PER_CHAIN
        )
        argsr = tuple(a.reshape((E, L) + a.shape[1:]) for a in args)
        static = dict(
            t_dof=prop.t_dof,
            target_accept=prop.target_accept,
            update_rule=prop.update_rule,
            symmetric=prop.symmetric,
            clustered=prop.clustered,
        )

        def call(sh, pc, *aa):
            p = BlockProposal(
                **dict(zip(self._PROP_SHARED, sh)),
                **dict(zip(self._PROP_PER_CHAIN, pc)),
                **static,
            )
            out = fn(p, *aa)
            if returns_prop:
                return tuple(getattr(out, f) for f in self._PROP_PER_CHAIN)
            return out

        inner = jax.vmap(call, in_axes=(0, 0) + (0,) * len(args))
        outer = jax.vmap(inner, in_axes=(None, 0) + (0,) * len(args))
        out = outer(shared, per, *argsr)
        out = jax.tree_util.tree_map(
            lambda a: a.reshape((C,) + a.shape[2:]), out
        )
        if returns_prop:
            return dataclasses.replace(
                prop, **dict(zip(self._PROP_PER_CHAIN, out))
            )
        return out

    def _prop_mask_per_chain(self, new_prop, old_prop, mask):
        """Keep old per-chain proposal state where ``mask`` is True
        (shared mixture leaves are identical by construction)."""
        C = self.num_chains
        updates = {}
        for f in self._PROP_PER_CHAIN:
            new = getattr(new_prop, f)
            old = getattr(old_prop, f)
            m = jnp.reshape(mask, (C,) + (1,) * (new.ndim - 1))
            updates[f] = jnp.where(m, old, new)
        return dataclasses.replace(new_prop, **updates)

    def _mutate(self, state: PTState, proposals, key, assigner=None):
        """One mutate move for the whole chain population
        (reference: SamplerPTChain.cpp MutateMove:217-313)."""
        C, D = state.x.shape
        temps = jnp.asarray(self.temperatures, dtype=self.dtype)
        t0_mask = temps == 0.0

        x = state.x
        lprior = state.lprior
        llh = state.llh
        att_mut = state.att_mut
        acc_mut = state.acc_mut
        new_proposals = []

        k_prior, key = jax.random.split(key)
        prior_draw = self.prior.sample(k_prior, (C,)).astype(self.dtype)

        for bi, block in enumerate(self.blocks):
            prop = proposals[bi]
            block_idx = jnp.asarray(block)
            lower = jnp.asarray(self.prior.lower[block], dtype=self.dtype)
            upper = jnp.asarray(self.prior.upper[block], dtype=self.dtype)

            kb = jax.random.fold_in(key, bi)
            k_upd, k_prop, k_acc = jax.random.split(kb, 3)
            chain_keys_upd = jax.random.split(k_upd, C)
            chain_keys_prop = jax.random.split(k_prop, C)

            # 1. adaptive scale update (skipped for T=0 chains)
            prop_upd = self._prop_apply(
                prop_mod.update_scales, prop, chain_keys_upd,
                returns_prop=True,
            )
            prop = self._prop_mask_per_chain(prop_upd, prop, t0_mask)

            # 2. propose new block positions
            x_block = x[:, block_idx]
            use_clustered = prop.clustered and assigner is not None
            if use_clustered:
                # component = spectral cluster of the current full position
                # (reference: ProposalClusteredCovariance.cpp:26-35); the
                # whole population assigns in one batched kernel evaluation
                cur_cluster = spectral_mod.assign_batch(
                    assigner, x.astype(jnp.float64)
                )
                if prop.means.shape[0] == self.ladder_size:
                    # shared (L, K, ...) layout: ensemble-batched kernel
                    # (a per-lane chols[cluster] gather materializes a
                    # (C, d, d) intermediate; see proposal.py)
                    E, L = self.num_ensembles, self.ladder_size
                    d = x_block.shape[-1]
                    nb, sel = prop_mod.propose_clustered_ensemble(
                        prop,
                        x_block.reshape(E, L, d),
                        cur_cluster.reshape(E, L),
                        lower,
                        upper,
                        chain_keys_prop.reshape(
                            (E, L) + chain_keys_prop.shape[1:]
                        ),
                    )
                    new_block = nb.reshape(C, d)
                    selected = sel.reshape(C)
                else:
                    new_block, selected = self._prop_apply(
                        lambda p, xb, cl, k: prop_mod.propose_clustered(
                            p, xb, cl, lower, upper, k
                        ),
                        prop, x_block, cur_cluster, chain_keys_prop,
                    )
            elif prop.means.shape[0] == self.ladder_size:
                # shared (L, K, ...) mixture layout: ensemble-batched
                # kernel — the auto-batched per-lane form broadcasts the
                # shared Cholesky factors to a per-chain (C, K, d, d)
                # intermediate (87 GB at d=520; see proposal.py)
                E, L = self.num_ensembles, self.ladder_size
                d = x_block.shape[-1]
                nb, sel, log_fwd_resp = prop_mod.propose_ensemble(
                    prop,
                    x_block.reshape(E, L, d),
                    lower,
                    upper,
                    chain_keys_prop.reshape((E, L) + chain_keys_prop.shape[1:]),
                )
                new_block = nb.reshape(C, d)
                selected = sel.reshape(C)
            else:
                new_block, selected = self._prop_apply(
                    lambda p, xb, k: prop_mod.propose(p, xb, lower, upper, k),
                    prop, x_block, chain_keys_prop,
                )

            x_new = x.at[:, block_idx].set(new_block)
            # T=0 chains: direct prior draw replaces the whole vector, and
            # only in the first block (reference: SamplerPTChain.cpp:221-240)
            if bi == 0:
                x_new = jnp.where(t0_mask[:, None], prior_draw, x_new)
            else:
                x_new = jnp.where(t0_mask[:, None], x, x_new)

            # Dirichlet residual overwrite (reference: SamplerPTChain.cpp:270-278)
            for blk in self.prior.dirichlet_blocks:
                s = blk.start
                r = blk.residual_index
                head = x_new[:, s:r]
                x_new = x_new.at[:, r].set(1.0 - jnp.sum(head, axis=1))

            # 3. evaluate
            new_lprior, new_llh = self._evaluate(x_new)
            new_lpp = self._lpp(new_lprior, new_llh, temps)
            cur_lpp = self._lpp(lprior, llh, temps)

            # 4. MH test (reference: SamplerPTChain.cpp TestSample:465-482)
            prop = dataclasses.replace(prop, selected=selected)
            if use_clustered:
                new_cluster = spectral_mod.assign_batch(
                    assigner, x_new.astype(jnp.float64)
                )
                if prop.means.shape[0] == self.ladder_size:
                    E, L = self.num_ensembles, self.ladder_size
                    d = x_block.shape[-1]
                    mh = prop_mod.mh_log_ratio_clustered_ensemble(
                        prop,
                        x_block.reshape(E, L, d),
                        new_block.reshape(E, L, d),
                        cur_cluster.reshape(E, L),
                        new_cluster.reshape(E, L),
                    ).reshape(C)
                else:
                    mh = self._prop_apply(
                        prop_mod.mh_log_ratio_clustered,
                        prop, x_block, new_block, cur_cluster, new_cluster,
                    )
            elif prop.means.shape[0] == self.ladder_size:
                E, L = self.num_ensembles, self.ladder_size
                d = x_block.shape[-1]
                mh = prop_mod.mh_log_ratio_ensemble(
                    prop,
                    x_block.reshape(E, L, d),
                    new_block.reshape(E, L, d),
                    log_fwd_resp=log_fwd_resp,
                ).reshape(C)
            else:
                mh = self._prop_apply(
                    prop_mod.mh_log_ratio, prop, x_block, new_block
                )
            log_u = jnp.log(
                jax.random.uniform(jax.random.fold_in(k_acc, 1), (C,), dtype=self.dtype)
            )
            finite = new_lpp > _NEG_INF
            accept = finite & (log_u < (new_lpp - cur_lpp) + mh)
            accept = jnp.where(t0_mask, bi == 0, accept)  # T=0: always accept once

            x = jnp.where(accept[:, None], x_new, x)
            lprior = jnp.where(accept, new_lprior, lprior)
            llh = jnp.where(accept, new_llh, llh)

            # 5. acceptance bookkeeping
            counted = jnp.where(t0_mask, bi == 0, True)
            att_mut = att_mut + counted.astype(att_mut.dtype)
            acc_mut = acc_mut + (accept & counted).astype(acc_mut.dtype)

            prop_notified = self._prop_apply(
                prop_mod.notify_accepted, prop, accept, returns_prop=True
            )
            prop = self._prop_mask_per_chain(prop_notified, prop, t0_mask)
            new_proposals.append(prop)

        state = dataclasses.replace(
            state,
            x=x,
            lprior=lprior,
            llh=llh,
            att_mut=att_mut,
            acc_mut=acc_mut,
        )
        state = self._history_add(state, x)
        return state, tuple(new_proposals)

    def _exchange(self, state: PTState, key):
        """Even/odd replica exchange as a masked chain-axis permutation
        (reference: SamplerPT.cpp DoExchangeMove:277-306,
        SamplerPTChain.cpp ExchangeMove:328-381). With ensembles, pairs form
        only within each replica's own temperature ladder."""
        C = self.ladder_size
        E = self.num_ensembles
        total = self.num_chains
        temps = jnp.asarray(self.temperatures, dtype=self.dtype)
        idx = jnp.arange(total)
        local = idx % C
        base = idx - local

        # previous_swap_even toggling (reference: SamplerPT.cpp:283-291)
        start = jnp.where(state.swap_parity == 1, 1, 0)
        new_parity = 1 - state.swap_parity

        if self.config.swapping_scheme == "stochastic_random":
            # one random adjacent pair per ensemble (reference picks one pair
            # for its single ensemble, SamplerPT.cpp:300-305)
            ci = jax.random.randint(
                jax.random.fold_in(key, 7), (E,), 0, max(C - 1, 1)
            )
            is_leader = local == jnp.repeat(ci, C)
        else:
            rel = local - start
            is_leader = (rel >= 0) & (rel % 2 == 0)
            if C % 2 == 1:
                # odd ladder size: the wrap-around pair (C-1, 0) is handled
                # by the reference sequentially after (0,1); we drop the
                # wrap-around leader instead (the pair re-forms next parity)
                is_leader = is_leader & (local != C - 1)

        partner = base + (local + 1) % C

        lprior_p = state.lprior[partner]
        llh_p = state.llh[partner]
        # proposed power posteriors after a hypothetical swap
        prop_lpp_self = jnp.where(
            temps == 0.0, lprior_p, temps * llh_p + lprior_p
        )
        temps_partner = temps[partner]
        prop_lpp_partner = jnp.where(
            temps_partner == 0.0,
            state.lprior,
            temps_partner * state.llh + state.lprior,
        )
        cur_lpp = self._lpp(state.lprior, state.llh, temps)
        log_tp = (prop_lpp_self + prop_lpp_partner) - (cur_lpp + cur_lpp[partner])

        u = jax.random.uniform(key, (total,), dtype=self.dtype)
        swap_leader = is_leader & (jnp.log(u) < log_tp)

        def roll_within(mask):
            return jnp.roll(mask.reshape(E, C), 1, axis=1).reshape(total)

        swap_follower = roll_within(swap_leader)
        perm = jnp.where(
            swap_leader, partner, jnp.where(swap_follower, base + (local - 1) % C, idx)
        )

        x = state.x[perm]
        lprior = state.lprior[perm]
        llh = state.llh[perm]

        att_exc = state.att_exc + is_leader.astype(state.att_exc.dtype)
        acc_exc = state.acc_exc + swap_leader.astype(state.acc_exc.dtype)

        state = dataclasses.replace(
            state,
            x=x,
            lprior=lprior,
            llh=llh,
            att_exc=att_exc,
            acc_exc=acc_exc,
            swap_parity=new_parity,
        )
        # both members of every pair record history (T != 0 chains);
        # (reference: SamplerPTChain.cpp:370-376). With the stochastic_random
        # scheme only the chosen pairs participate.
        if self.config.swapping_scheme == "stochastic_random" or C % 2 == 1:
            participated = is_leader | roll_within(is_leader)
            state = self._history_add(state, x, mask=participated)
        else:
            state = self._history_add(state, x)
        return state

    # ------------------------------------------------------------------
    # Iteration + segment

    def _iteration(self, carry, key, assigner=None):
        state, proposals = carry
        scheme = self.config.swapping_scheme
        C = self.ladder_size

        if C > 1 and scheme in ("stochastic_random", "stochastic_even_odd"):
            k_choice, k_move = jax.random.split(key)
            u = jax.random.uniform(k_choice, dtype=self.dtype)

            def do_exchange(args):
                st, props = args
                return self._exchange(st, k_move), props

            def do_mutate(args):
                st, props = args
                return self._mutate(st, props, k_move, assigner)

            state, proposals = jax.lax.cond(
                u < self.config.exchange_probability,
                do_exchange,
                do_mutate,
                (state, proposals),
            )
        elif C > 1:  # deterministic_even_odd
            k_exc, k_mut = jax.random.split(key)
            state = self._exchange(state, k_exc)
            for ei in range(self.config.num_exploration_steps):
                state, proposals = self._mutate(
                    state, proposals, jax.random.fold_in(k_mut, ei), assigner
                )
        else:
            state, proposals = self._mutate(state, proposals, key, assigner)

        return (state, proposals)

    def _make_segment_fn(self, n_emit: int, with_assigner: bool = False):
        nth = self.config.use_every_nth

        def emit_step(assigner, carry, _):
            def one_iter(c, _x):
                state, proposals = c
                key, new_key = jax.random.split(state.key)
                state = dataclasses.replace(state, key=new_key)
                state, proposals = self._iteration(
                    (state, proposals), key, assigner
                )
                return (state, proposals), None

            if nth > 1:
                # inner scan instead of a Python unroll: same key threading,
                # bit-identical samples, nth-times smaller HLO to compile
                carry, _ = jax.lax.scan(one_iter, carry, None, length=nth)
                state, proposals = carry
            else:
                (state, proposals), _ = one_iter(carry, None)
            x_e, lp_e, ll_e = state.x, state.lprior, state.llh
            if self._emit_L != self.ladder_size:
                # fixed-temperature rows only (reference: SamplerPT.cpp:
                # 321-330); the slice happens on device, so the heated
                # chains never cross the host link
                L = self.ladder_size
                D = x_e.shape[-1]
                x_e = x_e.reshape(-1, L, D)[:, L - 1, :]
                lp_e = lp_e.reshape(-1, L)[:, L - 1]
                ll_e = ll_e.reshape(-1, L)[:, L - 1]
            edt = self.config.emit_dtype
            if edt is not None:
                out = (x_e.astype(edt), lp_e.astype(edt), ll_e.astype(edt))
            else:
                out = (x_e, lp_e, ll_e)
            return (state, proposals), out

        if with_assigner:

            def run_segment(state, proposals, assigner):
                (state, proposals), ys = jax.lax.scan(
                    partial(emit_step, assigner),
                    (state, proposals),
                    None,
                    length=n_emit,
                )
                return state, proposals, ys

        else:

            def run_segment(state, proposals):
                (state, proposals), ys = jax.lax.scan(
                    partial(emit_step, None), (state, proposals), None, length=n_emit
                )
                return state, proposals, ys

        return jax.jit(run_segment, donate_argnums=(0,))

    # ------------------------------------------------------------------
    # Host orchestration

    def _find_starting_position(self, key) -> PTState:
        """Prior draws until every chain has a finite power posterior
        (reference: SamplerPTChain.cpp FindStartingPosition:188-215)."""
        C = self.num_chains
        temps = np.asarray(self.temperatures, dtype=np.float64)

        # host loop with early exit, with the prior draw and the
        # likelihood evaluation as SEPARATE jitted calls and the
        # first-finite-draw selection in host numpy. Rationale: the first
        # few draws almost always succeed (the reference's retry loop is
        # also host-side, SamplerPTChain.cpp:188-215), and fusing
        # sample+evaluate+selection into one jit program made compile
        # time grow with the chain count on integrator-heavy likelihoods,
        # while the pieces compile in seconds
        sample_fn = jax.jit(
            lambda k: self.prior.sample(k, (C,)).astype(self.dtype)
        )
        eval_fn = jax.jit(self._evaluate)

        keys = jax.random.split(key, self.config.initial_position_tries)
        x = np.zeros((C, self.num_variables))
        lprior = np.full(C, _NEG_INF)
        llh = np.full(C, _NEG_INF)
        found = np.zeros(C, dtype=bool)
        for i in range(self.config.initial_position_tries):
            draw = sample_fn(keys[i])
            dl, dllh = eval_fn(draw)
            draw, dl, dllh = np.asarray(draw), np.asarray(dl), np.asarray(dllh)
            with np.errstate(invalid="ignore"):
                # power posterior with the T=0 convention (_lpp)
                lpp = np.where(temps == 0.0, dl, dl + temps * dllh)
            take = np.isfinite(lpp) & ~found
            x[take] = draw[take]
            lprior[take] = dl[take]
            llh[take] = dllh[take]
            found |= np.isfinite(lpp)
            if found.all():
                break
        if not found.all():
            raise RuntimeError(
                "Could not find starting position with finite power posterior "
                f"after {self.config.initial_position_tries} tries"
            )
        return (
            jnp.asarray(x, dtype=self.dtype),
            jnp.asarray(lprior, dtype=self.dtype),
            jnp.asarray(llh, dtype=self.dtype),
        )

    def _init_state(self) -> PTState:
        k_start, k_run = jax.random.split(self._root_key)
        x, lprior, llh = self._find_starting_position(k_start)
        C = self.num_chains
        return PTState(
            x=x,
            lprior=lprior,
            llh=llh,
            att_mut=jnp.zeros(C, dtype=jnp.int32),
            acc_mut=jnp.zeros(C, dtype=jnp.int32),
            att_exc=jnp.zeros(C, dtype=jnp.int32),
            acc_exc=jnp.zeros(C, dtype=jnp.int32),
            history=jnp.zeros(
                (C, self.history_size * self.num_variables), dtype=jnp.float32
            ),
            hist_adds=jnp.zeros((), dtype=jnp.int32),
            swap_parity=jnp.zeros((), dtype=jnp.int32),
            key=k_run,
        )

    def _history_matrices(self, state: PTState) -> Tuple[np.ndarray, int]:
        hist = (
            _to_host(state.history)
            .astype(np.float64)
            .reshape(-1, self.history_size, self.num_variables)
        )
        adds = int(state.hist_adds)
        count = min(self.history_size, adds // self.history_subsampling)
        return hist[:, :count, :], count

    def _downsample_indices(self, n: int) -> np.ndarray:
        """Row indices of the subsample-then-random-discard downsample
        (reference: Proposal.cpp:86-129). Consumes the host RNG stream
        identically whether the rows are gathered on device or host."""
        max_n = self.config.adapt_proposal_max_history_samples
        if n <= max_n:
            return np.arange(n)
        stride = n // max_n
        if stride > 1:
            ix = np.arange(0, (n // stride)) * stride
        else:
            ix = np.arange(n)
        ix = list(ix)
        while len(ix) > max_n:
            drop = int(self._host_rng.integers(0, len(ix)))
            ix.pop(drop)
        return np.asarray(ix)

    def _downsample_history(self, h: np.ndarray) -> np.ndarray:
        """Subsample-then-random-discard (reference: Proposal.cpp:86-129)."""
        return h[self._downsample_indices(len(h))]

    def _ladder_downsampled_history(self, state: PTState, count: int):
        """Per-ladder-position downsampled pooled history, gathered ON
        DEVICE so only max_history_samples rows per position cross the
        device->host link. The full history at production configs is
        gigabytes (chains x history x variables); the fits consume only
        the downsampled rows, so pulling everything first — as the
        plain `_history_matrices` path does — moves gigabytes where the
        gathered rows are ~2 MB at the 65,536-chain bench config.
        Downsample indices come from the same host-RNG
        draws as `_downsample_history`, position order, so the sampled
        stream is identical to the pull-everything path."""
        C, E = self.ladder_size, self.num_ensembles
        n = E * count
        out = []
        for i in range(C):
            ix = self._downsample_indices(n)
            e, t = ix // max(count, 1), ix % max(count, 1)
            chain_rows = jnp.asarray(i + e * C)
            # 2-D gather on the flat buffer; reshaping to (C, H, D) on
            # device would reintroduce the D-minor tiled layout
            D = self.num_variables
            cols = jnp.asarray(t)[:, None] * D + jnp.arange(D)[None, :]
            rows = state.history[chain_rows[:, None], cols]
            out.append(np.asarray(rows).astype(np.float64))
        return out

    def _adapt_proposals(self, state: PTState):
        """Host-side proposal adaptation (reference:
        SamplerPTChain.cpp AdaptProposal:109-173).

        Pulls the device history, re-computes blocks, fits GMMs per
        (chain, block), pushes back stacked proposal arrays and resets
        the history.
        """
        C, E = self.ladder_size, self.num_ensembles
        needs_clustering = (
            self.proposal_type == "clustered_covariance"
            or self.config.blocking_strategy == "clustered_autoblock"
        )
        # The full history matrix is only required by consumers that read
        # the POOLED rows (spectral clustering, Turek blocking, the
        # adaptation dump); the GMM fits read only the downsampled rows,
        # which are gathered on device instead — the full pull is
        # gigabytes at production chain counts and dominated the
        # boundary (see _ladder_downsampled_history).
        full_pull = (
            needs_clustering
            or self.config.blocking_strategy in ("Turek", "clustered_autoblock")
            or self.config.output_proposal_adaptation
        )
        if full_pull:
            hist, count = self._history_matrices(state)
        else:
            hist = None
            adds = int(_to_host(state.hist_adds))
            count = min(self.history_size, adds // self.history_subsampling)
        logger.info("Proposal adaptation with %d history samples per chain", count)

        # pool history across ensembles per temperature: every replica of
        # ladder position i targets the same tempered distribution, so the
        # pooled history is a larger sample from it (a design choice; the
        # reference has one ensemble and fits per chain)
        def ladder_history(i):
            return hist[i::C].reshape(E * count, self.num_variables)

        # spectral clustering of the pooled fixed-temperature history
        # (reference: per-chain SampleHistoryClustering.cpp Cluster; one
        # shared fit keeps assignment a single batched device kernel)
        cluster_labels = None
        if needs_clustering and count > 2:
            pooled = ladder_history(C - 1)
            dump = {} if self.config.output_sample_clustering else None
            self._assigner = spectral_mod.fit_spectral_clustering(
                pooled,
                self.config.sample_clustering_nn,
                self.config.sample_clustering_nn2,
                self.config.sample_clustering_num_clusters,
                self.config.adapt_proposal_max_clustering_samples,
                self._host_rng,
                dump_sink=dump,
            )
            if self._assigner is None:
                logger.warning(
                    "Spectral clustering failed; falling back to unclustered "
                    "proposals for this segment"
                )
            else:
                cluster_labels = spectral_mod.assign_host(self._assigner, pooled)
                if dump is not None:
                    # assignment of the full (non-downsampled) history
                    # (reference: all_assignment via
                    # AssignAllHistorySamples, :213)
                    dump["all_assignment"] = cluster_labels.astype(np.int32)
                    self.clustering_dumps.append(
                        (self.clustering_iteration, dump)
                    )
                logger.info(
                    "Spectral clustering: %d clusters over %d samples "
                    "(cluster sizes %s)",
                    self._assigner.num_clusters,
                    len(pooled),
                    np.bincount(
                        cluster_labels, minlength=self._assigner.num_clusters
                    ).tolist(),
                )
            self.clustering_iteration += 1

        # blocking from the fixed-temperature pooled history
        # (design deviation from the reference, which blocks per chain: a
        # single block structure is required to batch chains on device)
        if self.config.blocking_strategy == "Turek":
            self.blocks = blocking_mod.get_blocks(
                "Turek",
                self.num_variables,
                ladder_history(C - 1) if count > 2 else None,
            )
        elif self.config.blocking_strategy == "clustered_autoblock":
            self.blocks = blocking_mod.get_blocks(
                "clustered_autoblock",
                self.num_variables,
                ladder_history(C - 1) if count > 2 else None,
                cluster_assignment=cluster_labels,
            )
        select_adjusted = self.proposal_type == "gaussian_mixture_adjustedAIC"

        clustered_active = (
            self.proposal_type == "clustered_covariance"
            and self._assigner is not None
        )
        # per-ladder-position downsampled full-variable histories (+ their
        # cluster labels when clustering is active), shared across blocks.
        # Identical host-RNG stream in both branches (position order).
        if full_pull:
            ladder_h = [
                self._downsample_history(ladder_history(i)) for i in range(C)
            ]
        else:
            ladder_h = self._ladder_downsampled_history(state, count)
        ladder_labels = (
            [spectral_mod.assign_host(self._assigner, h) for h in ladder_h]
            if clustered_active
            else [None] * C
        )

        new_proposals = []
        adaptation_record = []
        gmm_path = not clustered_active and self.proposal_type not in (
            "global_covariance",
            "clustered_covariance",
        )
        for block in self.blocks:
            # device backend: fit every ladder position's (k, retry) EM
            # cube as ONE device program instead of C sequential launches
            # (the measured adaptation-boundary stall at the bench config
            # was dominated by these launches). RNG stream is identical
            # to the sequential path: seeds are drawn in position order.
            prefit = None
            if gmm_path and self._gmm_fitter_multi is not None:
                eligible = [
                    i
                    for i in range(C)
                    if self.ladder[i] != 0.0 and len(ladder_h[i]) >= 2
                ]
                if eligible:
                    fitted = self._gmm_fitter_multi(
                        [ladder_h[i][:, block] for i in eligible],
                        self._host_rng,
                        select_with_adjusted_aic=select_adjusted,
                        log=logger.debug,
                    )
                    prefit = dict(zip(eligible, fitted))
            ladder_gmms = []
            for i in range(C):
                if self.ladder[i] == 0.0:
                    gmm = self._fallback_gmm(block)
                    if clustered_active:
                        gmm = self._pad_gmm_components(
                            gmm, self._assigner.num_clusters, block
                        )
                    ladder_gmms.append(gmm)
                    continue
                h = ladder_h[i][:, block]
                if clustered_active:
                    gmm = self._fit_clustered_covariance(
                        h, ladder_labels[i], block
                    )
                elif not gmm_path:
                    gmm = self._fit_global_covariance(h, block)
                else:
                    gmm = None
                    if prefit is not None:
                        gmm = prefit.get(i)
                    elif len(h) >= 2:
                        gmm = self._gmm_fitter(
                            h,
                            self._host_rng,
                            select_with_adjusted_aic=select_adjusted,
                            log=logger.debug,
                        )
                    if gmm is None:
                        gmm = self._fallback_gmm(block)
                ladder_gmms.append(gmm)
            # every ensemble shares the pooled fit: the mixture arrays are
            # stored once per ladder position (see _prop_apply)
            gmms = ladder_gmms
            adaptation_record.append((block, ladder_gmms[-1]))
            if clustered_active:
                build_ptype = "clustered_covariance"
            elif self.proposal_type == "clustered_covariance":
                build_ptype = "global_covariance"  # degraded: clustering failed
            else:
                build_ptype = self.proposal_type
            new_proposals.append(
                prop_mod.build_block_proposal(
                    gmms,
                    self.num_chains,
                    len(block),
                    self.dtype,
                    t_dof=self.config.proposal_t_dof,
                    proposal_type=build_ptype,
                )
            )
        self.proposals = new_proposals

        if self.config.output_proposal_adaptation:
            self.adaptation_dumps.append(
                (self.adaptation_iteration, adaptation_record, ladder_history(C - 1))
            )
        self.adaptation_iteration += 1

        # reset history (reference: SamplerPTChain.cpp:170-171)
        state = dataclasses.replace(
            state,
            hist_adds=jnp.zeros((), dtype=jnp.int32),
        )
        return state, adaptation_record

    def _fit_global_covariance(self, h: np.ndarray, block: np.ndarray) -> GMM:
        """Empirical covariance proposal (reference:
        ProposalGlobalCovariance.cpp InitializeImpl:64-105)."""
        d = len(block)
        prior_var = self.prior.marginal_variance()[block]
        if len(h) < 2:
            cov = np.diag(prior_var)
            mean = self.prior.marginal_mean()[block]
        else:
            cov = np.cov(h, rowvar=False, ddof=1).reshape(d, d)
            diag = np.maximum(np.diag(cov), 1e-6 * prior_var)
            cov[np.diag_indices(d)] = diag
            mean = h.mean(axis=0)
        gmm = GMM.from_params(mean[None], cov[None], np.ones(1))
        if gmm is None:
            cov = cov + np.eye(d) * (1e-8 + np.abs(np.diag(cov)).max() * 1e-6)
            gmm = GMM.from_params(mean[None], cov[None], np.ones(1))
        if gmm is None:
            gmm = self._fallback_gmm(block)
        return gmm

    def _pad_gmm_components(self, gmm: GMM, k: int, block: np.ndarray) -> GMM:
        """Replicate a single-component GMM to k identical components so the
        component index aligns with the cluster index."""
        reps = int(np.ceil(k / gmm.num_components))
        means = np.tile(gmm.means, (reps, 1))[:k]
        covs = np.tile(gmm.covariances, (reps, 1, 1))[:k]
        out = GMM.from_params(means, covs, np.full(k, 1.0 / k))
        return out if out is not None else gmm

    def _fit_clustered_covariance(
        self, h: np.ndarray, labels: np.ndarray, block: np.ndarray
    ) -> GMM:
        """One covariance per spectral cluster, equal weights (reference:
        ProposalClusteredCovariance.cpp InitializeImpl:185-207). Component
        index == cluster index; clusters with too few samples fall back to
        the overall covariance of the history."""
        k = self._assigner.num_clusters
        d = len(block)
        fallback = self._fit_global_covariance(h, block)
        means = np.tile(fallback.means[0], (k, 1))
        covs = np.tile(fallback.covariances[0], (k, 1, 1))
        for ci in range(k):
            sel = h[labels == ci]
            if len(sel) >= max(2, d):
                c = np.cov(sel, rowvar=False, ddof=1).reshape(d, d)
                c[np.diag_indices(d)] += 1e-8
                if np.all(np.isfinite(c)):
                    means[ci] = sel.mean(axis=0)
                    covs[ci] = c
        gmm = GMM.from_params(means, covs, np.full(k, 1.0 / k))
        if gmm is None:
            for ci in range(k):
                covs[ci][np.diag_indices(d)] += 1e-6 * np.abs(
                    np.diag(covs[ci])
                ).max() + 1e-10
            gmm = GMM.from_params(means, covs, np.full(k, 1.0 / k))
        if gmm is None:
            gmm = self._pad_gmm_components(self._fallback_gmm(block), k, block)
        return gmm

    # ------------------------------------------------------------------
    # Main loop

    def run(self):
        """Run the sampler (reference: SamplerPT.cpp RunImpl:185-260).

        Returns a dict with samples (S, C, D), log_prior (S, C),
        log_likelihood (S, C), temperatures and acceptance statistics.
        """
        cfg = self.config
        if cfg.profile_dir:
            import contextlib

            profile_cm = jax.profiler.trace(cfg.profile_dir)
        else:
            import contextlib

            profile_cm = contextlib.nullcontext()
        with profile_cm:
            return self._run_impl()

    def _run_impl(self):
        cfg = self.config
        t_start = time.time()
        self._progress_rows = 0
        # per-run adaptation-boundary accounting (reset each run; the
        # reference logs only "Updating proposal..." with no timing)
        self.adaptation_seconds = 0.0
        self.adaptation_boundaries = 0
        if self.progress is not None:
            self.progress.start()

        emitted = 0
        if cfg.checkpoint_file and os.path.exists(cfg.checkpoint_file):
            emitted = self._restore_checkpoint(cfg.checkpoint_file)
            state = self._restored_state
            proposals = tuple(self.proposals)
            logger.info(
                "Resumed from checkpoint %s at %d emitted samples",
                cfg.checkpoint_file,
                emitted,
            )
            for handler in self.sample_handlers:
                if hasattr(handler, "set_position"):
                    handler.set_position(emitted * self.num_ensembles)
        else:
            state = self._init_state()
            proposals = tuple(self.proposals)

        if cfg.shard_over_devices and len(jax.devices()) > 1:
            from bcm3_tpu.parallel.mesh import chain_mesh, shard_leading_axis

            n_dev = len(jax.devices())
            if cfg.mesh_devices is not None:
                n_dev = min(n_dev, cfg.mesh_devices)
            if self.num_chains % n_dev != 0:
                raise ValueError(
                    f"Chain population {self.num_chains} must be divisible "
                    f"by the device count {n_dev} for sharded execution"
                )
            self._mesh = chain_mesh(n_dev)
            state = shard_leading_axis(state, self._mesh, self.num_chains)
            proposals = tuple(
                shard_leading_axis(p, self._mesh, self.num_chains)
                for p in proposals
            )
            logger.info(
                "Chain population sharded over %d devices", n_dev
            )

        all_x, all_lprior, all_llh = [], [], []
        adaptation_records = []
        while emitted < cfg.num_samples:
            # adaptation due at this point? (placed at the loop top so a
            # resume from a segment-boundary checkpoint adapts exactly like
            # the uninterrupted run)
            if cfg.adapt_proposal_samples > 0:
                pending = min(
                    emitted // cfg.adapt_proposal_samples,
                    cfg.adapt_proposal_times,
                )
                while self.adaptations_done < pending:
                    self._log_statistics(state)
                    logger.info("Updating proposal...")
                    # boundary wall cost: history pull -> GMM/clustering
                    # fit -> proposal push-back (+ re-shard). The pull
                    # blocks on the device queue, so this span is the
                    # full sampling stall the adaptation causes.
                    t_adapt = time.time()
                    state, record = self._adapt_proposals(state)
                    adaptation_records.append(record)
                    proposals = tuple(self.proposals)
                    if getattr(self, "_mesh", None) is not None:
                        from bcm3_tpu.parallel.mesh import shard_leading_axis

                        proposals = tuple(
                            shard_leading_axis(
                                p, self._mesh, self.num_chains
                            )
                            for p in proposals
                        )
                    self.adaptation_seconds += time.time() - t_adapt
                    self.adaptation_boundaries += 1
                    self.adaptations_done += 1
                    if cfg.checkpoint_file:
                        self._save_checkpoint(
                            cfg.checkpoint_file, state, emitted
                        )

            if (
                cfg.adapt_proposal_samples > 0
                and self.adaptations_done < cfg.adapt_proposal_times
            ):
                next_adapt = (
                    (emitted // cfg.adapt_proposal_samples) + 1
                ) * cfg.adapt_proposal_samples
            else:
                next_adapt = cfg.num_samples
            stop = min(cfg.num_samples, next_adapt)
            n_emit = stop - emitted

            with_assigner = self._assigner is not None
            seg_key = (
                n_emit,
                tuple(p.max_components for p in proposals),
                tuple(tuple(int(v) for v in b) for b in self.blocks),
                (len(self._assigner.sample_scale), self._assigner.num_clusters)
                if with_assigner
                else None,
            )
            # Chunked, compute-overlapped emission: the segment is split
            # into emit chunks; while the device runs chunk k+1, the host
            # materializes chunk k. The iteration/RNG stream is identical to one
            # monolithic segment (keys are threaded through the state), so
            # results are bit-equal for any chunk size.
            if cfg.emit_chunk_size is None:
                # auto: ~32 MB per pull
                bytes_per_emit = (
                    (self.num_chains // self.ladder_size) * self._emit_L
                    * (self.num_variables + 2)
                    * jnp.dtype(cfg.emit_dtype or self.dtype).itemsize
                )
                chunk = max(1, (32 << 20) // max(bytes_per_emit, 1))
            else:
                chunk = cfg.emit_chunk_size if cfg.emit_chunk_size else n_emit
            pending = None

            def _materialize(ys_dev):
                if not getattr(ys_dev[0], "is_fully_addressable", True):
                    # multi-process run: per-host sharded emission — each
                    # process materializes and stores only the ensembles it
                    # owns (no host-0 funnel); merge with
                    # bcm3_tpu.io.output.merge_sharded_results
                    L = self._emit_L
                    x_loc, c0 = _local_chain_rows(ys_dev[0])
                    if c0 % L == 0 and x_loc.shape[1] % L == 0:
                        lp_loc, _ = _local_chain_rows(ys_dev[1])
                        ll_loc, _ = _local_chain_rows(ys_dev[2])
                        e_local = x_loc.shape[1] // L
                        self._emit_shard_info = (c0 // L, e_local)
                        xs = self._pool_ensembles(x_loc, e_local)
                        lps = self._pool_ensembles(lp_loc, e_local)
                        lls = self._pool_ensembles(ll_loc, e_local)
                    else:  # shard boundary splits a ladder: gather instead
                        xs = self._pool_ensembles(_to_host(ys_dev[0]))
                        lps = self._pool_ensembles(_to_host(ys_dev[1]))
                        lls = self._pool_ensembles(_to_host(ys_dev[2]))
                else:
                    xs, lps, lls = (
                        self._pool_ensembles(np.asarray(ys_dev[0])),
                        self._pool_ensembles(np.asarray(ys_dev[1])),
                        self._pool_ensembles(np.asarray(ys_dev[2])),
                    )
                all_x.append(xs)
                all_lprior.append(lps)
                all_llh.append(lls)
                for handler in self.sample_handlers:
                    handler.receive_samples(xs, lps, lls, self.emit_ladder)
                if self.progress is not None:
                    # running MAP over the fixed-temperature chains
                    # (reference: SamplerPT.cpp:223-226)
                    lpost = lps[:, -1] + lls[:, -1]
                    if lpost.size:
                        self.progress.notify_max_lposterior(np.max(lpost))
                    self._progress_rows += xs.shape[0]
                    self.progress.update(
                        self._progress_rows / max(self.expected_emitted_samples, 1)
                    )

            done = 0
            while done < n_emit:
                m = min(chunk, n_emit - done)
                ck = seg_key[1:] + (m,)
                if ck not in self._segment_fns:
                    self._segment_fns[ck] = self._make_segment_fn(
                        m, with_assigner
                    )
                if with_assigner:
                    state, proposals, ys = self._segment_fns[ck](
                        state, proposals, self._assigner
                    )
                else:
                    state, proposals, ys = self._segment_fns[ck](
                        state, proposals
                    )
                # start the device->host copy of this chunk without
                # blocking, then drain the previous chunk while the next
                # dispatch (or this copy) proceeds
                for arr in ys:
                    if hasattr(arr, "copy_to_host_async"):
                        arr.copy_to_host_async()
                if pending is not None:
                    _materialize(pending)
                pending = ys
                done += m
            if pending is not None:
                _materialize(pending)
            emitted = stop

            if cfg.checkpoint_file:
                self._save_checkpoint(cfg.checkpoint_file, state, emitted)

        if self.progress is not None:
            self.progress.finish()
        elapsed = time.time() - t_start
        self.total_evaluations = int(_to_host(state.att_mut).sum())
        evals_per_sec = self.total_evaluations / max(elapsed, 1e-9)
        logger.info(
            "Sampling finished: %d evaluations in %.2fs (%.1f evals/s)",
            self.total_evaluations,
            elapsed,
            evals_per_sec,
        )
        self._log_statistics(state)

        if not all_x:  # resumed from a checkpoint of a finished run
            C = self._emit_L
            all_x = [np.zeros((0, C, self.num_variables))]
            all_lprior = [np.zeros((0, C))]
            all_llh = [np.zeros((0, C))]
        return {
            "samples": np.concatenate(all_x, axis=0),
            "log_prior": np.concatenate(all_lprior, axis=0),
            "log_likelihood": np.concatenate(all_llh, axis=0),
            "temperatures": self.emit_ladder,
            "acceptance": {
                "attempted_mutate": _to_host(state.att_mut),
                "accepted_mutate": _to_host(state.acc_mut),
                "attempted_exchange": _to_host(state.att_exc),
                "accepted_exchange": _to_host(state.acc_exc),
            },
            "evaluations": self.total_evaluations,
            "elapsed_seconds": elapsed,
            "evals_per_second": evals_per_sec,
            "adaptation_records": adaptation_records,
            "adaptation_seconds": self.adaptation_seconds,
            "adaptation_boundaries": self.adaptation_boundaries,
            # set in multi-process runs with per-host sharded emission:
            # (first ensemble index, ensemble count) of this process's rows
            "ensemble_shard": getattr(self, "_emit_shard_info", None),
            "num_ensembles": self.num_ensembles,
        }

    def _save_checkpoint(self, path: str, state: PTState, emitted: int):
        from bcm3_tpu.io.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            state,
            self.proposals,
            self.blocks,
            emitted,
            self.adaptations_done,
            self.adaptation_iteration,
            assigner=self._assigner,
            extra={"host_rng": self._host_rng.bit_generator.state},
        )

    def _restore_checkpoint(self, path: str) -> int:
        from bcm3_tpu.io.checkpoint import load_checkpoint

        payload = load_checkpoint(path)
        self._restored_state = payload["state"]
        self.proposals = list(payload["proposals"])
        self.blocks = [np.asarray(b) for b in payload["blocks"]]
        self.adaptations_done = payload["adaptations_done"]
        self.adaptation_iteration = payload["adaptation_iteration"]
        self._assigner = payload["assigner"]
        host_rng_state = payload["extra"].get("host_rng")
        if host_rng_state is not None:
            self._host_rng.bit_generator.state = host_rng_state
        return payload["emitted"]

    def _pool_ensembles(self, arr: np.ndarray, num_ensembles=None) -> np.ndarray:
        """(S, E*C, ...) -> (S*E, C, ...): pool replica samples per
        temperature, sample-major so every emitted step's replicas are
        adjacent in the output store. ``num_ensembles`` overrides the
        configured count for per-host shards of the ensemble axis."""
        E = self.num_ensembles if num_ensembles is None else num_ensembles
        C = self._emit_L
        if E == 1 and arr.shape[1] == C:
            return arr
        S = arr.shape[0]
        rest = arr.shape[2:]
        return arr.reshape(S, E, C, *rest).reshape(S * E, C, *rest)

    def _log_statistics(self, state: PTState):
        """Acceptance table aggregated over ensembles per temperature
        (reference: SamplerPTChain.cpp LogStatistics:383-389)."""
        C = self.ladder_size
        att_m = _to_host(state.att_mut).astype(np.float64).reshape(-1, C).sum(0)
        acc_m = _to_host(state.acc_mut).astype(np.float64).reshape(-1, C).sum(0)
        att_e = _to_host(state.att_exc).astype(np.float64).reshape(-1, C).sum(0)
        acc_e = _to_host(state.acc_exc).astype(np.float64).reshape(-1, C).sum(0)
        logger.info("Acceptance statistics:")
        logger.info("Temperature | Mutate (all) | Exchange (all)")
        for c in range(C):
            logger.info(
                "%11.7f | %12.5f | %14.5f",
                self.ladder[c],
                acc_m[c] / max(att_m[c], 1.0),
                acc_e[c] / max(att_e[c], 1.0),
            )
