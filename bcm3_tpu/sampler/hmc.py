"""Hamiltonian Monte Carlo sampler with dual-averaging adaptation.

A sampler backend beyond the reference's PT-MH/IS pair — the
BASELINE north star asks for gradient-based backends behind the same
sampler interface (the reference has none; its samplers are
derivative-free, SamplerFactory.cpp:22-26). JAX provides exact
gradients of every likelihood in the framework (the ODE solvers,
matrix exponentials, steady-state solves and SBML RHS are all
differentiable), so HMC comes almost for free:

- C chains advance in lockstep: one vmapped leapfrog trajectory per
  iteration, so every gradient evaluation is a batched device call;
- constrained variables are reparametrized to unbounded space (logit
  for two-sided bounds, log for one-sided) with the Jacobian folded
  into the target density;
- warmup: Nesterov dual averaging of the step size toward a target
  acceptance rate (Hoffman & Gelman 2014, Algorithm 5) and a diagonal
  mass matrix estimated from the second half of warmup.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class HMCConfig:
    num_samples: int = 1000
    num_warmup: int = 500
    num_chains: int = 8
    num_leapfrog_steps: int = 16
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    seed: int = 0
    use_every_nth: int = 1


class _Reparam:
    """Bounded -> unbounded transform per variable."""

    def __init__(self, lower: np.ndarray, upper: np.ndarray):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.two_sided = np.isfinite(self.lower) & np.isfinite(self.upper)
        self.lo_only = np.isfinite(self.lower) & ~np.isfinite(self.upper)
        self.hi_only = ~np.isfinite(self.lower) & np.isfinite(self.upper)

    def to_x(self, z):
        lo = jnp.asarray(self.lower)
        hi = jnp.asarray(self.upper)
        span = jnp.where(jnp.asarray(self.two_sided), hi - lo, 1.0)
        sig = jax.nn.sigmoid(z)
        x = z
        x = jnp.where(jnp.asarray(self.two_sided), lo + span * sig, x)
        x = jnp.where(jnp.asarray(self.lo_only), lo + jnp.exp(z), x)
        x = jnp.where(jnp.asarray(self.hi_only), hi - jnp.exp(z), x)
        return x

    def log_jacobian(self, z):
        span = jnp.where(
            jnp.asarray(self.two_sided),
            jnp.asarray(self.upper) - jnp.asarray(self.lower),
            1.0,
        )
        lj = jnp.zeros_like(z)
        two = jnp.asarray(self.two_sided)
        lj = jnp.where(
            two,
            jnp.log(span) + jax.nn.log_sigmoid(z) + jax.nn.log_sigmoid(-z),
            lj,
        )
        one = jnp.asarray(self.lo_only | self.hi_only)
        lj = jnp.where(one, z, lj)
        return jnp.sum(lj, axis=-1)

    def from_x(self, x):
        lo = self.lower
        hi = self.upper
        z = np.asarray(x, dtype=np.float64).copy()
        sel = self.two_sided
        frac = np.clip((z[..., sel] - lo[sel]) / (hi[sel] - lo[sel]), 1e-9, 1 - 1e-9)
        z[..., sel] = np.log(frac / (1 - frac))
        sel = self.lo_only
        z[..., sel] = np.log(np.maximum(z[..., sel] - lo[sel], 1e-12))
        sel = self.hi_only
        z[..., sel] = np.log(np.maximum(hi[sel] - z[..., sel], 1e-12))
        return z


class SamplerHMC:
    """Batched HMC over the posterior lprior + llh."""

    def __init__(self, prior, likelihood, config: HMCConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.num_chains = config.num_chains
        self.num_ensembles = 1
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self._reparam = _Reparam(prior.lower, prior.upper)
        lr = likelihood.learning_rate

        def logpost_z(z):
            x = self._reparam.to_x(z)
            lp = prior.log_pdf(x) + self._reparam.log_jacobian(z)
            ll = likelihood.log_prob(x) * lr
            total = lp + ll
            return jnp.where(jnp.isnan(total), -jnp.inf, total)

        self._logpost = logpost_z
        self._grad = jax.grad(logpost_z)

    @property
    def expected_emitted_samples(self) -> int:
        # chains are pooled into the single-temperature store
        return self.config.num_samples * self.config.num_chains

    # ------------------------------------------------------------------

    def _leapfrog(self, z, p, eps, inv_mass):
        L = self.config.num_leapfrog_steps

        def body(carry, _):
            z, p = carry
            p = p + 0.5 * eps * self._grad(z)
            z = z + eps * inv_mass * p
            p = p + 0.5 * eps * self._grad(z)
            return (z, p), None

        (z, p), _ = jax.lax.scan(body, (z, p), None, length=L)
        return z, p

    def _step(self, z, logp, key, eps, inv_mass):
        kp, ka = jax.random.split(key)
        p = jax.random.normal(kp, z.shape) / jnp.sqrt(inv_mass)
        h0 = logp - 0.5 * jnp.sum(inv_mass * p * p)
        z_new, p_new = self._leapfrog(z, p, eps, inv_mass)
        logp_new = self._logpost(z_new)
        h1 = logp_new - 0.5 * jnp.sum(inv_mass * p_new * p_new)
        # divergent trajectories (non-finite Hamiltonian) are rejections
        log_alpha = jnp.where(
            jnp.isnan(h1 - h0), -jnp.inf, jnp.minimum(0.0, h1 - h0)
        )
        accept = jnp.log(jax.random.uniform(ka)) < log_alpha
        z = jnp.where(accept, z_new, z)
        logp = jnp.where(accept, logp_new, logp)
        return z, logp, jnp.exp(log_alpha), accept

    def run(self):
        cfg = self.config
        D = self.prior.num_variables
        C = cfg.num_chains
        key = jax.random.PRNGKey(cfg.seed if cfg.seed else 42)
        k_init, key = jax.random.split(key)

        # start from prior draws mapped to unbounded space
        x0 = np.asarray(self.prior.sample(k_init, (C,)))
        z = jnp.asarray(self._reparam.from_x(x0))
        logp = jax.vmap(self._logpost)(z)

        t0 = time.time()
        # ---- warmup with dual averaging ----
        mu = jnp.log(10.0 * cfg.initial_step_size)
        log_eps = jnp.log(jnp.asarray(cfg.initial_step_size))
        log_eps_bar = jnp.zeros(())
        h_bar = jnp.zeros(())
        gamma, t0_da, kappa = 0.05, 10.0, 0.75
        inv_mass = jnp.ones((D,))

        step_all = jax.jit(
            lambda zz, lp, keys, eps, im: jax.vmap(
                lambda z1, l1, k1: self._step(z1, l1, k1, eps, im)
            )(zz, lp, keys)
        )

        warm_hist = []
        for it in range(cfg.num_warmup):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, C)
            z, logp, alphas, _ = step_all(z, logp, keys, jnp.exp(log_eps), inv_mass)
            a = jnp.mean(jnp.nan_to_num(alphas, nan=0.0))
            m = it + 1
            h_bar = (1 - 1 / (m + t0_da)) * h_bar + (cfg.target_accept - a) / (
                m + t0_da
            )
            log_eps = mu - jnp.sqrt(m) / gamma * h_bar
            eta = m ** (-kappa)
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
            if it >= cfg.num_warmup // 2:
                warm_hist.append(np.asarray(z))
            if it == int(cfg.num_warmup * 0.75) and warm_hist:
                h = np.concatenate(warm_hist, axis=0)
                var = h.var(axis=0) + 1e-6
                inv_mass = jnp.asarray(var)

        eps_final = jnp.exp(log_eps_bar)
        logger.info(
            "HMC warmup done: step size %.4g", float(eps_final)
        )

        # ---- sampling ----
        n_accept = 0
        out_z = []
        out_logp = []
        total_iter = cfg.num_samples * cfg.use_every_nth
        for it in range(total_iter):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, C)
            z, logp, alphas, accept = step_all(
                z, logp, keys, eps_final, inv_mass
            )
            n_accept += int(jnp.sum(accept))
            if (it + 1) % cfg.use_every_nth == 0:
                out_z.append(np.asarray(z))
                out_logp.append(np.asarray(logp))

        elapsed = time.time() - t0
        zs = np.stack(out_z)  # (S, C, D)
        xs = np.asarray(
            jax.vmap(jax.vmap(self._reparam.to_x))(jnp.asarray(zs))
        )
        lprior = np.asarray(
            jax.vmap(jax.vmap(self.prior.log_pdf))(jnp.asarray(xs))
        )
        llh = np.asarray(
            jax.vmap(jax.vmap(self.likelihood.log_prob))(jnp.asarray(xs))
        ) * self.likelihood.learning_rate

        # pool chains into the (S*C, 1, D) layout of the single-temperature
        # store (every chain targets the same posterior)
        S = xs.shape[0]
        xs_flat = xs.reshape(S * C, 1, D)
        lp_flat = lprior.reshape(S * C, 1)
        ll_flat = llh.reshape(S * C, 1)
        for handler in self.sample_handlers:
            handler.receive_samples(xs_flat, lp_flat, ll_flat, self.ladder)

        accept_rate = n_accept / max(total_iter * C, 1)
        logger.info(
            "HMC: %d samples x %d chains in %.2fs (accept %.3f)",
            cfg.num_samples,
            C,
            elapsed,
            accept_rate,
        )
        return {
            "samples": xs_flat,
            "samples_per_chain": xs,  # (S, C, D)
            "log_prior": lp_flat,
            "log_likelihood": ll_flat,
            "temperatures": self.ladder,
            "accept_rate": accept_rate,
            "step_size": float(eps_final),
            "elapsed_seconds": elapsed,
        }
