"""Adaptive tempered Sequential Monte Carlo sampler.

A sampler backend beyond the reference's PT-MH/IS pair
(BASELINE north star). Where parallel tempering runs a fixed ladder of
chains through time, SMC moves one PARTICLE POPULATION through an
adaptively chosen temperature schedule — ideally suited to the chip:
every operation (reweighting, resampling, the MH mutation sweeps) is a
single batched computation over thousands of particles.

Algorithm (Del Moral, Doucet & Jasra 2006; adaptive tempering via
effective-sample-size bisection):
1. draw N particles from the prior (beta = 0);
2. find the next beta so the incremental-weight ESS is ~ess_target*N;
3. systematic resampling;
4. K Metropolis mutation sweeps at the current tempered posterior with
   a Gaussian random walk scaled to the weighted particle covariance
   (the same empirical-covariance idea as the reference's
   global-covariance proposal, ProposalGlobalCovariance.cpp:64-105);
5. repeat until beta = 1. The log marginal likelihood accumulates from
   the incremental weights for free.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, List

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class SMCConfig:
    num_particles: int = 2048
    mutation_steps: int = 5
    ess_target: float = 0.5
    seed: int = 0
    max_stages: int = 100
    step_scale: float = 0.5  # random-walk scale relative to particle sd


class SamplerSMC:
    def __init__(self, prior, likelihood, config: SMCConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self.num_ensembles = 1
        lr = likelihood.learning_rate
        self._llh = jax.jit(
            jax.vmap(lambda x: likelihood.log_prob(x) * lr)
        )
        self._lprior = jax.jit(prior.log_pdf)

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_particles

    def _find_beta(self, llh, beta):
        """Bisection for the next temperature with ESS ~ target
        (standard adaptive tempering)."""
        target = self.config.ess_target * len(llh)

        def ess_at(b):
            lw = (b - beta) * llh
            lw = lw - lw.max()
            w = np.exp(lw)
            return w.sum() ** 2 / (w * w).sum()

        if ess_at(1.0) >= target:
            return 1.0
        lo, hi = beta, 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if ess_at(mid) >= target:
                lo = mid
            else:
                hi = mid
        return lo

    def run(self):
        cfg = self.config
        N = cfg.num_particles
        D = self.prior.num_variables
        key = jax.random.PRNGKey(cfg.seed if cfg.seed else 7)
        t0 = time.time()

        key, sub = jax.random.split(key)
        x = self.prior.sample(sub, (N,))
        llh = np.asarray(self._llh(x))
        llh = np.where(np.isnan(llh), -np.inf, llh)
        x = np.asarray(x)

        lower = self.prior.lower
        upper = self.prior.upper

        @jax.jit
        def mutate(x, llh, lprior, key, beta, chol_scaled):
            """One vmapped random-walk MH sweep at temperature beta."""
            kz, ku = jax.random.split(key)
            z = jax.random.normal(kz, x.shape)
            prop = x + jnp.matmul(z, chol_scaled.T, precision=jax.lax.Precision.HIGHEST)
            # reflect on bounds like the reference proposals
            from bcm3_tpu.sampler.proposal import reflect_on_bounds

            prop = reflect_on_bounds(
                prop, jnp.asarray(lower), jnp.asarray(upper)
            )
            lp_new = self._lprior(prop)
            ll_new = jax.vmap(self.likelihood.log_prob)(prop)
            ll_new = ll_new * self.likelihood.learning_rate
            ll_new = jnp.where(jnp.isnan(ll_new), -jnp.inf, ll_new)
            logr = (lp_new + beta * ll_new) - (lprior + beta * llh)
            accept = jnp.log(jax.random.uniform(ku, (x.shape[0],))) < logr
            x = jnp.where(accept[:, None], prop, x)
            llh = jnp.where(accept, ll_new, llh)
            lprior = jnp.where(accept, lp_new, lprior)
            return x, llh, lprior, jnp.mean(accept)

        beta = 0.0
        log_ml = 0.0
        stage = 0
        while beta < 1.0 and stage < cfg.max_stages:
            stage += 1
            new_beta = self._find_beta(llh, beta)
            lw = (new_beta - beta) * llh
            m = lw.max()
            w = np.exp(lw - m)
            log_ml += m + np.log(w.mean())
            w_norm = w / w.sum()

            # systematic resampling
            key, sub = jax.random.split(key)
            u = float(jax.random.uniform(sub)) / N
            positions = u + np.arange(N) / N
            idx = np.searchsorted(np.cumsum(w_norm), positions)
            idx = np.clip(idx, 0, N - 1)
            x = x[idx]
            llh = llh[idx]
            beta = new_beta

            # mutation sweeps with covariance-scaled random walk
            cov = np.cov(x, rowvar=False).reshape(D, D)
            cov += 1e-10 * np.eye(D)
            chol = np.linalg.cholesky(cov) * (
                cfg.step_scale * 2.38 / np.sqrt(D)
            )
            lprior = np.asarray(self._lprior(jnp.asarray(x)))
            xj, llhj, lpj = jnp.asarray(x), jnp.asarray(llh), jnp.asarray(lprior)
            acc = 0.0
            for _ in range(cfg.mutation_steps):
                key, sub = jax.random.split(key)
                xj, llhj, lpj, a = mutate(
                    xj, llhj, lpj, sub, beta, jnp.asarray(chol)
                )
                acc = float(a)
            x, llh = np.asarray(xj), np.asarray(llhj)
            logger.info(
                "SMC stage %d: beta=%.4f accept=%.3f log_ml=%.3f",
                stage,
                beta,
                acc,
                log_ml,
            )

        elapsed = time.time() - t0
        lprior = np.asarray(self._lprior(jnp.asarray(x)))
        xs = x[:, None, :]
        lp = lprior[:, None]
        ll = llh[:, None]
        for handler in self.sample_handlers:
            handler.receive_samples(xs, lp, ll, self.ladder)
        logger.info(
            "SMC finished: %d particles, %d stages, %.2fs", N, stage, elapsed
        )
        return {
            "samples": xs,
            "log_prior": lp,
            "log_likelihood": ll,
            "temperatures": self.ladder,
            "log_marginal_likelihood": float(log_ml),
            "stages": stage,
            "elapsed_seconds": elapsed,
        }
