"""Automatic differentiation variational inference (mean-field ADVI).

A sampler backend beyond the reference's PT-MH/IS pair
(BASELINE north star; the reference has no variational method). The
posterior is approximated with a diagonal Gaussian in the unbounded
reparametrized space (the same bounded->unbounded transforms as the HMC
backend), fit by maximizing the reparametrized-gradient ELBO with Adam
(Kucukelbir et al. 2017). Every ELBO estimate is one batched
(num_mc_samples x D) evaluation of the target — a single fused device
computation per optimization step.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, List

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.sampler.hmc import _Reparam

logger = logging.getLogger(__name__)


@dataclass
class VIConfig:
    num_iterations: int = 2000
    num_mc_samples: int = 32
    learning_rate: float = 0.05
    num_samples: int = 1000  # posterior draws emitted after the fit
    seed: int = 0


class SamplerVI:
    def __init__(self, prior, likelihood, config: VIConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder
        self.num_ensembles = 1
        self._reparam = _Reparam(prior.lower, prior.upper)
        lr = likelihood.learning_rate

        def logpost_z(z):
            x = self._reparam.to_x(z)
            lp = prior.log_pdf(x) + self._reparam.log_jacobian(z)
            ll = likelihood.log_prob(x) * lr
            total = lp + ll
            return jnp.where(jnp.isnan(total), -jnp.inf, total)

        self._logpost = logpost_z

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_samples

    def run(self):
        import optax

        cfg = self.config
        D = self.prior.num_variables
        key = jax.random.PRNGKey(cfg.seed if cfg.seed else 11)
        t0 = time.time()

        # initialize at a prior draw in unbounded space
        key, sub = jax.random.split(key)
        x0 = np.asarray(self.prior.sample(sub, (64,)))
        z0 = self._reparam.from_x(x0)
        mu = jnp.asarray(z0.mean(axis=0))
        log_sigma = jnp.asarray(np.log(z0.std(axis=0) + 1e-2))

        def elbo(params, key):
            mu, log_sigma = params
            eps = jax.random.normal(key, (cfg.num_mc_samples, D))
            z = mu + jnp.exp(log_sigma) * eps
            logp = jax.vmap(self._logpost)(z)
            logp = jnp.where(jnp.isfinite(logp), logp, -1e10)
            entropy = jnp.sum(log_sigma) + 0.5 * D * (1.0 + jnp.log(2 * jnp.pi))
            return jnp.mean(logp) + entropy

        opt = optax.adam(cfg.learning_rate)
        params = (mu, log_sigma)
        opt_state = opt.init(params)

        @jax.jit
        def step(params, opt_state, key):
            val, grads = jax.value_and_grad(
                lambda p: -elbo(p, key)
            )(params)
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, -val

        best_elbo = -np.inf
        for it in range(cfg.num_iterations):
            key, sub = jax.random.split(key)
            params, opt_state, cur = step(params, opt_state, sub)
            cur = float(cur)
            if np.isfinite(cur):
                best_elbo = max(best_elbo, cur)
            if (it + 1) % max(cfg.num_iterations // 5, 1) == 0:
                logger.info("VI iteration %d: ELBO %.4f", it + 1, cur)

        mu, log_sigma = params
        key, sub = jax.random.split(key)
        eps = jax.random.normal(sub, (cfg.num_samples, D))
        z = mu + jnp.exp(log_sigma) * eps
        xs = np.asarray(jax.vmap(self._reparam.to_x)(z))
        lprior = np.asarray(jax.vmap(self.prior.log_pdf)(jnp.asarray(xs)))
        llh = (
            np.asarray(jax.vmap(self.likelihood.log_prob)(jnp.asarray(xs)))
            * self.likelihood.learning_rate
        )
        elapsed = time.time() - t0

        xs3 = xs[:, None, :]
        lp2 = lprior[:, None]
        ll2 = llh[:, None]
        for handler in self.sample_handlers:
            handler.receive_samples(xs3, lp2, ll2, self.ladder)
        logger.info(
            "VI finished: ELBO %.4f, %d draws, %.2fs",
            float(cur),
            cfg.num_samples,
            elapsed,
        )
        return {
            "samples": xs3,
            "log_prior": lp2,
            "log_likelihood": ll2,
            "temperatures": self.ladder,
            "elbo": float(cur),
            "mean": np.asarray(mu),
            "log_sigma": np.asarray(log_sigma),
            "elapsed_seconds": elapsed,
        }
