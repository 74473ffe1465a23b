"""Batched on-device GMM EM for proposal adaptation.

JAX counterpart of the host EM in :mod:`bcm3_tpu.stats.gmm`
(itself a faithful mirror of the reference GMM fit, src/stats/GMM.cpp
Fit:48-160). The reference fits one GMM per (chain, block) per component
count sequentially on CPU threads; adaptation is the only point where
the sampler's device pipeline stalls on the host. Here every
(component-count k, retry) EM fit runs as ONE vmapped, jit-compiled
computation: fits are padded to the largest k in the ladder with
inactive-component masks, the 100-step EM loop is a `lax.scan` with
per-fit freeze flags once a fit converges/stops/goes singular, and the
M-step's ESS-aware eigenvalue shrinkage (GMM.cpp
CalculateMeanCovariance:248-336) is a batched `eigh`.

Semantics follow the host implementation with two documented deviations:
- k-means++ seeds for all retries are drawn up front (the host path only
  draws a retry's seed when the previous retry failed), so the RNG
  stream differs — fits are equally valid but not bit-identical.
- the reference runs retries sequentially and stops at the first
  converged one; here all retries run in parallel and the first
  converged (else the last non-singular) is selected, which matches the
  sequential choice whenever convergence flags agree.

Selection across component counts (AIC with ESS gating, including the
adjusted-AIC incumbent quirk) is identical to the host path
(reference: ProposalGaussianMixture.cpp InitializeImpl:129-210).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.stats.gmm import (
    COMPONENT_LADDER,
    GMM,
    _EM_RETRIES,
    _LOGL_EPSILON,
    _MAX_EM_STEPS,
    _kmeanspp,
    fit_gmm,
)
from bcm3_tpu.stats.summary import effective_sample_size

# full float32 contractions (a GPU may otherwise run them in TF32)
_HIGHEST = jax.lax.Precision.HIGHEST



def _m_step(samples, resp, active, ess_factor):
    """Batched weighted mean/covariance with eigenvalue shrinkage
    (reference: GMM.cpp CalculateMeanCovariance:248-336). resp: (n, K).

    Returns (mean, cov_out, weights, factor) where ``factor`` is the
    (sd, eigvec, eigval) factorization of cov_out in correlation space:
    cov_out = diag(sd) @ V diag(lam) V^T @ diag(sd). The E-step consumes
    the factorization directly, so the EM loop runs exactly ONE
    eigendecomposition per step (the shrinkage one the reference's
    regularization requires) — the former second eigh of the full
    covariance per E-step was the dominant cost of the device program.
    The +1e-8*I jitter of the covariance is expressed as a floor on the
    correlation eigenvalues (equivalent-strength regularization in the
    factored form). Degenerate branches (diag-only, low-weight,
    inactive) are encoded as V=I with the appropriate lam."""
    n, D = samples.shape
    w = jnp.where(resp >= jnp.finfo(samples.dtype).eps, resp, 0.0)  # (n, K)
    wsum = w.sum(axis=0)  # (K,)
    safe_wsum = jnp.maximum(wsum, jnp.finfo(samples.dtype).tiny)
    mean = jnp.matmul(w.T, samples, precision=_HIGHEST) / safe_wsum[:, None]  # (K, D)
    grand_mean = samples.mean(axis=0)
    low_w = wsum < 2.0
    mean = jnp.where(low_w[:, None], grand_mean, mean)

    d = samples[None, :, :] - mean[:, None, :]  # (K, n, D)
    cov = jnp.einsum("nk,kni,knj->kij", w, d, d, precision=_HIGHEST) / jnp.maximum(
        wsum - 1.0, jnp.finfo(samples.dtype).tiny
    )[:, None, None]

    # regularization
    n_eff = wsum / ess_factor
    diag_only = n_eff < 2.0
    n_eff = jnp.maximum(n_eff, float(D))

    var = jnp.diagonal(cov, axis1=-2, axis2=-1)
    sd = jnp.sqrt(jnp.maximum(var, 0.0))
    sd = jnp.where(sd > 0, sd, 1e-30)
    corr = cov / (sd[:, :, None] * sd[:, None, :])
    eye = jnp.eye(D, dtype=samples.dtype)
    corr = corr * (1.0 - eye) + eye

    eigval, eigvec = jnp.linalg.eigh(corr)  # ascending, (K, D), (K, D, D)
    # descending-position shrinkage: position i (descending) scaled by
    # n_eff/(n_eff + D + 1 - 2i) while i < floor(n_eff), zeroed beyond
    i_desc = jnp.arange(D, dtype=samples.dtype)
    factor = n_eff[:, None] / (n_eff[:, None] + D + 1.0 - 2.0 * i_desc[None, :])
    keep = i_desc[None, :] < jnp.floor(n_eff)[:, None]
    eig_desc = eigval[:, ::-1]
    shrunk_desc = jnp.where(keep, eig_desc * factor, 0.0)
    shrunk = shrunk_desc[:, ::-1]

    # singularity in correlation space: a shrunk spectrum that is not
    # positive (beyond f32 eigh noise) is what the host path's Cholesky
    # would reject (GMM.cpp:102-110)
    tol = (
        D
        * jnp.finfo(samples.dtype).eps
        * jnp.max(jnp.abs(shrunk), axis=-1, keepdims=True)
    )
    comp_pd = jnp.all(shrunk > -tol, axis=-1)
    # eigenvalue floor = the factored form of the +1e-8*I jitter
    lam = jnp.maximum(shrunk, jnp.maximum(tol[:, 0][:, None], 1e-8))

    corr_reg = jnp.einsum("kij,kj,klj->kil", eigvec, lam, eigvec, precision=_HIGHEST)
    cov_reg = corr_reg * (sd[:, :, None] * sd[:, None, :])

    diag_cov = var[:, :, None] * eye
    cov_out = jnp.where(diag_only[:, None, None], diag_cov, cov_reg)
    cov_out = jnp.where(low_w[:, None, None], eye, cov_out)
    # inactive padding components: identity (never used, keeps cholesky ok)
    cov_out = jnp.where(active[:, None, None], cov_out, eye)
    mean = jnp.where(active[:, None], mean, 0.0)
    weights = jnp.where(active, wsum / n, 0.0)

    # factored form matching cov_out's branches
    degenerate = diag_only | low_w | ~active
    sd_fac = jnp.where(
        (low_w | ~active)[:, None],
        1.0,
        jnp.where(diag_only[:, None], jnp.sqrt(jnp.maximum(var, 1e-30)), sd),
    )
    V = jnp.where(degenerate[:, None, None], eye, eigvec)
    lam_fac = jnp.where(degenerate[:, None], 1.0, lam)
    comp_pd = comp_pd | degenerate
    return mean, cov_out, weights, (sd_fac, V, lam_fac, comp_pd)


def _e_step(samples, means, fac, weights, active):
    """Batched expectation (reference: GMM.cpp EM_expectation). Returns
    (resp (n,K), logl, singular).

    Consumes the M-step's (sd, V, lam) factorization of each covariance:
    Mahalanobis terms and log-determinants are pure broadcasts and
    einsums — no factorization runs in the E-step at all."""
    n, D = samples.shape
    sd, V, lam, comp_pd = fac
    singular = ~jnp.all(comp_pd | ~active)
    log_c = (
        -0.5 * jnp.sum(jnp.log(lam), axis=-1)
        - jnp.sum(jnp.log(sd), axis=-1)
        - 0.5 * D * jnp.log(2.0 * jnp.pi)
    )
    diff = (samples[None, :, :] - means[:, None, :]) / sd[:, None, :]
    proj = jnp.einsum("knd,kde->kne", diff, V, precision=_HIGHEST) * jax.lax.rsqrt(lam)[
        :, None, :
    ]
    quad = -0.5 * jnp.sum(proj * proj, axis=-1)  # (K, n)
    logw = jnp.where(
        active & (weights > 0), jnp.log(jnp.maximum(weights, 1e-300)), -jnp.inf
    )
    comp_lp = (log_c[:, None] + quad + logw[:, None]).T  # (n, K)
    m = jnp.max(comp_lp, axis=1, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    sum_exp = jnp.sum(jnp.exp(comp_lp - m_safe), axis=1)
    sample_logl = m_safe[:, 0] + jnp.log(jnp.maximum(sum_exp, 1e-300))
    logl = jnp.sum(sample_logl)
    resp = jnp.exp(comp_lp - sample_logl[:, None])
    zero_rows = resp.sum(axis=1) == 0
    k_active = jnp.maximum(jnp.sum(active), 1)
    uniform = jnp.where(active, 1.0 / k_active, 0.0)
    resp = jnp.where(zero_rows[:, None], uniform[None, :], resp)
    return resp, logl, singular


@partial(jax.jit, static_argnames=("max_steps",))
def _em_fits(samples, resp0, active, ess_factor, max_steps: int = _MAX_EM_STEPS):
    """Run all padded EM fits in ONE device program.

    samples: (F, n, D) per-fit sample matrices (broadcast the same
    history to every row to fit one dataset; stack different ladder
    positions' histories to fit the whole ladder at once — the fits all
    advance inside a single early-exit loop, so F programs collapse to
    one launch whose trip count is the max over fits, not the sum).
    resp0: (F, n, K); active: (F, K); ess_factor: (F,).
    Returns means (F,K,D), covs, weights, logl (F,), converged (F,),
    singular (F,)."""

    def one_fit(samples, r0, act, ess_factor):
        mean0, cov0, _, fac0 = _m_step(samples, r0, act, ess_factor)
        # initial weights are uniform over active components, matching the
        # host path (gmm.py fit_gmm: weights = 1/K before the first E-step)
        k_act = jnp.maximum(jnp.sum(act), 1)
        w0 = jnp.where(act, 1.0 / k_act, 0.0)

        def step(carry):
            mean, cov, fac, w, prev_logl, logl, stopped, conv, sing, it = carry
            resp, new_logl, singular = _e_step(samples, mean, fac, w, act)
            eps = jnp.abs(new_logl) * _LOGL_EPSILON
            decreased = new_logl < prev_logl
            small_dec = (prev_logl - new_logl) < eps * 10.0
            small_inc = (new_logl - prev_logl) < eps
            now_conv = jnp.where(decreased, small_dec, small_inc)
            stop_now = singular | decreased | small_inc

            n_mean, n_cov, n_w, n_fac = _m_step(samples, resp, act, ess_factor)
            upd = ~(stopped | stop_now)
            mean = jnp.where(upd, n_mean, mean)
            cov = jnp.where(upd, n_cov, cov)
            fac = jax.tree_util.tree_map(
                lambda new, old: jnp.where(upd, new, old), n_fac, fac
            )
            w = jnp.where(upd, n_w, w)
            logl = jnp.where(stopped, logl, new_logl)
            conv = jnp.where(stopped, conv, now_conv & ~singular)
            sing = sing | (singular & ~stopped)
            prev_logl = jnp.where(stopped, prev_logl, new_logl)
            stopped = stopped | stop_now
            return (
                mean, cov, fac, w, prev_logl, logl, stopped, conv, sing,
                it + 1,
            )

        def keep_going(carry):
            stopped, it = carry[6], carry[9]
            return (~stopped) & (it < max_steps)

        big_neg = jnp.asarray(jnp.finfo(samples.dtype).min / 4, samples.dtype)
        init = (
            mean0,
            cov0,
            fac0,
            w0,
            big_neg,
            big_neg,
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(0, jnp.int32),
        )
        # early-exit loop: under vmap this runs until every fit in the
        # batch has stopped (or hit max_steps), matching the host path's
        # per-fit early break instead of always paying 100 EM steps
        (
            mean, cov, _fac, w, _, logl, stopped, conv, sing, _,
        ) = jax.lax.while_loop(keep_going, step, init)
        # fits that ran out of steps without stopping: converged=False
        return mean, cov, w, logl, conv & stopped, sing

    return jax.vmap(one_fit)(samples, resp0, active, ess_factor)


def fit_gmm_best_aic_device_multi(
    histories,
    rng: np.random.Generator,
    select_with_adjusted_aic: bool = False,
    log=None,
):
    """Fit a best-AIC GMM to EVERY history in one device program.

    ``histories`` is a list of (n, D) matrices (e.g. one per ladder
    position, all the same shape after the sampler's downsample). The
    (position, component-count, retry) fit cube is grouped by component
    count and dispatched as one padding-free :func:`_em_fits` program
    per k, pipelined with no host syncs in between, instead of
    sequential per-position programs padded to K_max with eigh in both
    EM halves. Returns a list of Optional[GMM], aligned with
    ``histories``.
    """
    num = len(histories)
    results: list = [None] * num
    metas = []  # per position: (history, ks, ess_factor, aic_adjust)
    fits = []  # stacked resp0
    fit_samples = []  # per-fit history index
    fit_meta = []  # (position, k)
    candidates: list = [[] for _ in range(num)]
    Kmax = 1

    for pos, history in enumerate(histories):
        history = np.asarray(history, dtype=np.float64)
        if history.ndim != 2 or len(history) < 2:
            metas.append(None)
            continue
        n, D = history.shape
        ess = np.array(
            [effective_sample_size(history[:, i]) for i in range(D)]
        )
        min_ess = float(np.min(ess))
        if not np.isfinite(min_ess) or min_ess <= 0:
            min_ess = 1.0
        aic_adjust_factor = min_ess / n
        ess_factor = n / min_ess

        # eligible multi-component ks (k=1 is closed form: host, cheap)
        ks = [
            k
            for k in COMPONENT_LADDER
            if k > 1
            and min_ess >= k * (1 + min(D // 2, 10))
            and n >= 2.0 * D * k
        ]
        metas.append((history, ks, ess_factor, aic_adjust_factor))

        if min_ess >= 1 * (1 + min(D // 2, 10)):
            g1 = fit_gmm(history, 1, rng, ess_factor)
            if g1 is not None:
                candidates[pos].append(g1)
            elif log:
                log(f"GMM pos={pos} k=1: fit failed")

        for k in ks:
            Kmax = max(Kmax, k)
            for _r in range(_EM_RETRIES):
                resp = _kmeanspp(history, k, rng)
                if resp is None:
                    continue
                fits.append((resp, k))
                fit_samples.append(pos)
                fit_meta.append((pos, k))

    if fits:
        shapes = {metas[p][0].shape for p in fit_samples}
        if len(shapes) > 1:
            raise ValueError(
                "fit_gmm_best_aic_device_multi requires equal-shaped "
                f"histories, got {shapes}"
            )
        n = fits[0][0].shape[0]
        # Group fits by component count: per-k groups carry NO padding
        # (the dominant cost is the m-step shrinkage eigh, whose batch
        # is then exactly the active components instead of K_max per
        # fit), and each group's early-exit loop runs its own trip
        # count (small-k fits converge much earlier than k=13). The
        # groups are dispatched back-to-back without host syncs, so the
        # device pipelines them as one stream of programs.
        by_k: dict = {}
        for i, (resp, k) in enumerate(fits):
            by_k.setdefault(k, []).append(i)
        pending = {}
        for k, idxs in by_k.items():
            resp0 = np.stack([fits[i][0] for i in idxs])
            active_k = np.ones((len(idxs), k), dtype=bool)
            samples_k = np.stack(
                [metas[fit_samples[i]][0] for i in idxs]
            )
            ess_k = np.asarray(
                [metas[fit_samples[i]][2] for i in idxs], dtype=np.float64
            )
            pending[k] = (
                idxs,
                _em_fits(
                    jnp.asarray(samples_k),
                    jnp.asarray(resp0),
                    jnp.asarray(active_k),
                    jnp.asarray(ess_k),
                ),
            )
        F = len(fits)
        D_ = metas[fit_samples[0]][0].shape[1]
        means = np.zeros((F, Kmax, D_))
        covs = np.zeros((F, Kmax, D_, D_))
        weights = np.zeros((F, Kmax))
        logl = np.zeros(F)
        conv = np.zeros(F, dtype=bool)
        sing = np.zeros(F, dtype=bool)
        for k, (idxs, out) in pending.items():
            m_k, c_k, w_k, l_k, cv_k, s_k = jax.tree_util.tree_map(
                np.asarray, out
            )
            for j, i in enumerate(idxs):
                means[i, :k] = m_k[j]
                covs[i, :k] = c_k[j]
                weights[i, :k] = w_k[j]
                logl[i] = l_k[j]
                conv[i] = cv_k[j]
                sing[i] = s_k[j]
        # per (position, k): first converged retry, else last non-singular
        for pos in range(num):
            if metas[pos] is None:
                continue
            history, ks, ess_factor, _adj = metas[pos]
            D = history.shape[1]
            for k in ks:
                idx = [
                    i
                    for i, (p, kk) in enumerate(fit_meta)
                    if p == pos and kk == k
                ]
                chosen = None
                for i in idx:
                    if conv[i] and not sing[i]:
                        chosen = i
                        break
                if chosen is None:
                    non_sing = [i for i in idx if not sing[i]]
                    if non_sing:
                        chosen = non_sing[-1]
                if chosen is None:
                    if log:
                        log(
                            f"GMM pos={pos} k={k}: fit failed "
                            "(all retries singular)"
                        )
                    continue
                g = GMM.from_params(
                    means[chosen][:k], covs[chosen][:k], weights[chosen][:k]
                )
                if g is None:
                    if log:
                        log(f"GMM pos={pos} k={k}: final cholesky failed")
                    continue
                nparam = k * (D + D * (D + 1) // 2) + k - 1
                g.logl = float(logl[chosen])
                g.aic = 2 * nparam - 2 * g.logl
                candidates[pos].append(g)

    for pos in range(num):
        if metas[pos] is None:
            continue
        aic_adjust_factor = metas[pos][3]
        best_gmm = None
        best_aic = np.inf
        for g in candidates[pos]:
            adjusted_aic = g.aic + 2.0 * (1.0 - aic_adjust_factor) * g.logl
            crit = adjusted_aic if select_with_adjusted_aic else g.aic
            if log:
                log(
                    f"GMM pos={pos} k={g.num_components}: AIC={g.aic:.6g}, "
                    f"adjusted AIC={adjusted_aic:.6g}"
                )
            if crit < best_aic:
                best_gmm = g
                best_aic = g.aic
        results[pos] = best_gmm
    return results


def fit_gmm_best_aic_device(
    history: np.ndarray,
    rng: np.random.Generator,
    select_with_adjusted_aic: bool = False,
    log=None,
) -> Optional[GMM]:
    """Device-batched drop-in for :func:`bcm3_tpu.stats.gmm.fit_gmm_best_aic`."""
    return fit_gmm_best_aic_device_multi(
        [history], rng, select_with_adjusted_aic, log
    )[0]
