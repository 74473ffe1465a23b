"""Prior-importance sampler.

JAX equivalent of the reference importance sampler
(reference: src/sampler/SamplerIS.cpp:47-90). The reference draws one
prior sample at a time on the host and evaluates the likelihood
serially; here draws are batched on device — one jitted
(sample, log_prior, log_likelihood) evaluation per batch of B samples —
and only the running-max weight filter runs on the host.

Semantics preserved from the reference:
- weight of a sample is exp(log_likelihood) (``lweight = llh``);
- a running maximum of the log weight is kept and any sample with
  lweight < max - ln(1e10) = 23.02585 is dropped as "too small to
  contribute" (SamplerIS.cpp:70-76); dropped samples do not count
  toward the requested sample total;
- emitted chains have a single temperature of 1.0 (SamplerIS.cpp:29).
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

LOG_WEIGHT_CUTOFF = 23.02585  # ln(1e10), reference: SamplerIS.cpp:73


@dataclass
class ISConfig:
    num_samples: int = 2500
    use_every_nth: int = 1
    seed: int = 0
    batch_size: int = 1024  # device batch per draw round
    max_rounds: int = 10_000


class SamplerIS:
    """Importance sampler: batched prior draws, weight = exp(llh)."""

    def __init__(self, prior, likelihood, config: ISConfig):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers: List[Any] = []
        self.num_chains = 1
        self.num_ensembles = 1
        self.ladder = np.array([1.0])
        self.temperatures = self.ladder

        lr = likelihood.learning_rate

        def batch_eval(key):
            xs = prior.sample(key, (config.batch_size,))
            lp = prior.log_pdf(xs)
            ll = jax.vmap(likelihood.log_prob)(xs) * lr
            return xs, lp, ll

        self._batch_eval = jax.jit(batch_eval)

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_samples * self.config.use_every_nth

    def run(self):
        cfg = self.config
        # the reference counts emitted samples against
        # num_samples * use_every_nth (SamplerIS.cpp:55)
        target = cfg.num_samples * cfg.use_every_nth
        key = jax.random.PRNGKey(cfg.seed)

        kept_x, kept_lp, kept_ll = [], [], []
        highest = -np.inf
        n_drawn = 0
        n_kept = 0
        t0 = time.time()
        for round_ix in range(cfg.max_rounds):
            if n_kept >= target:
                break
            key, sub = jax.random.split(key)
            xs, lp, ll = self._batch_eval(sub)
            xs = np.asarray(xs)
            lp = np.asarray(lp, dtype=np.float64)
            ll = np.asarray(ll, dtype=np.float64)
            n_drawn += len(ll)

            # sequential running-max filter (order matters: early samples
            # are kept against the max seen *so far*, as in the reference)
            run_max = np.maximum.accumulate(np.maximum(ll, highest))
            keep = ll >= run_max - LOG_WEIGHT_CUTOFF
            keep &= np.isfinite(lp) & np.isfinite(ll)
            highest = max(highest, float(run_max[-1]))

            xs, lp, ll = xs[keep], lp[keep], ll[keep]
            room = target - n_kept
            if len(ll) > room:
                xs, lp, ll = xs[:room], lp[:room], ll[:room]
            if len(ll):
                kept_x.append(xs)
                kept_lp.append(lp)
                kept_ll.append(ll)
                n_kept += len(ll)
        else:
            logger.warning(
                "Importance sampler hit max_rounds with %d/%d samples",
                n_kept,
                target,
            )

        elapsed = time.time() - t0
        x = np.concatenate(kept_x, axis=0)[:, None, :]  # (S, 1, D)
        lprior = np.concatenate(kept_lp, axis=0)[:, None]
        llh = np.concatenate(kept_ll, axis=0)[:, None]
        weights = np.exp(llh)  # reference emits exp(lweight), SamplerIS.cpp:78
        logger.info(
            "Importance sampling: %d draws, %d kept, %.3fs (%.1f evals/s)",
            n_drawn,
            n_kept,
            elapsed,
            n_drawn / max(elapsed, 1e-9),
        )

        for handler in self.sample_handlers:
            handler.receive_samples(x, lprior, llh, self.ladder, weights=weights)

        return {
            "samples": x,
            "log_prior": lprior,
            "log_likelihood": llh,
            "weights": weights,
            "temperatures": self.ladder,
            "num_evaluations": n_drawn,
        }
