"""No-U-Turn Sampler (NUTS).

Gradient-based sampler backend beyond the reference's derivative-free
PT-MH/IS pair (reference: SamplerFactory.cpp:22-26 registers only
ptmh|is; the north-star component list adds NUTS/HMC/SMC/VI behind the
same sampler interface). Everything in this framework's likelihood
library is differentiable through JAX, so the posterior gradient is
exact and batched.

Algorithm: multinomial NUTS with generalized U-turn termination
(Hoffman & Gelman 2014; Betancourt 2017 "A conceptual introduction to
HMC" for the multinomial/biased-progressive variant), implemented
*iteratively* so the whole transition compiles under `jit`:

- recursion over tree doublings is replaced by a `lax.while_loop` whose
  inner subtree construction runs one leapfrog step at a time and keeps
  O(max_tree_depth) momentum checkpoints; the checkpoint indices to test
  a new leaf against follow from the binary representation of the leaf
  index (the scheme introduced by NumPyro's iterative NUTS — Phan,
  Pradhan & Jankowiak 2019, arXiv:1912.11554);
- the U-turn test is the generalized criterion
  dot(v_boundary, r_segment_sum - (r_left+r_right)/2) <= 0 evaluated at
  both segment ends, applied to every balanced subtree straddled by the
  new leaf;
- proposals are drawn progressively ~ exp(logpi - H) (multinomial over
  the trajectory), with the biased outer-tree acceptance of Betancourt
  Appendix A.3;
- divergences (Delta H > 1000) terminate and reject the doubling.

All chains advance in lockstep through `vmap`, so each leapfrog step is
one batched gradient evaluation filling the chip; chains that terminate
their tree early are masked, not branched.

Warmup follows Stan's windowed scheme: dual averaging of the step size
toward `target_accept` throughout, diagonal mass (Welford variance)
re-estimated at expanding memoryless window boundaries
(75 | 25,50,100,... | 50).

Constrained variables use the same bounded->unbounded reparametrization
as HMC (bcm3_tpu/sampler/hmc.py), with the log-Jacobian in the target.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from functools import partial
from typing import Any, List

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.sampler.hmc import _Reparam

logger = logging.getLogger(__name__)

_DIVERGENCE_THRESHOLD = 1000.0


@dataclass
class NUTSConfig:
    num_samples: int = 1000
    num_warmup: int = 500
    num_chains: int = 8
    max_tree_depth: int = 8
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    seed: int = 0
    use_every_nth: int = 1


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion (Betancourt 2017, eq. A.4)."""
    v_left = inv_mass * r_left
    v_right = inv_mass * r_right
    mid = r_sum - 0.5 * (r_left + r_right)
    return (jnp.dot(v_left, mid) <= 0.0) | (jnp.dot(v_right, mid) <= 0.0)


def _leaf_idx_to_ckpt_idxs(n):
    """Checkpoint range [idx_min, idx_max] a new leaf n must be tested
    against: idx_max = popcount(n >> 1), idx_min = idx_max - (number of
    trailing one-bits of n) + 1."""
    idx_max = jnp.zeros((), jnp.int32)
    m = n >> 1

    def pc_body(c):
        m, acc = c
        return m >> 1, acc + (m & 1)

    m, idx_max = jax.lax.while_loop(lambda c: c[0] > 0, pc_body, (m, idx_max))

    trailing = jnp.zeros((), jnp.int32)

    def tr_body(c):
        m, acc = c
        return m >> 1, acc + 1

    _, trailing = jax.lax.while_loop(
        lambda c: (c[0] & 1) > 0, tr_body, (n, trailing)
    )
    return idx_max - trailing + 1, idx_max


class SamplerNUTS:
    """Batched multinomial NUTS over the posterior lprior + llh."""

    def __init__(self, prior, likelihood, config: NUTSConfig):
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
        self._vgrad = jax.value_and_grad(logpost_z)

    @property
    def expected_emitted_samples(self) -> int:
        return self.config.num_samples * self.config.num_chains

    # ------------------------------------------------------------------
    # One NUTS transition for a single chain (vmapped by the caller)

    def _transition(self, z, logp, grad, key, eps, inv_mass):
        D = z.shape[0]
        max_depth = self.config.max_tree_depth

        def leapfrog(z, r, grad, direction):
            e = direction * eps
            r = r + 0.5 * e * grad
            z = z + e * inv_mass * r
            logp, grad = self._vgrad(z)
            r = r + 0.5 * e * grad
            return z, r, logp, grad

        k_mom, k_tree = jax.random.split(key)
        r0 = jax.random.normal(k_mom, (D,)) / jnp.sqrt(inv_mass)
        energy0 = logp - 0.5 * jnp.sum(inv_mass * r0 * r0)

        # tree state: both boundaries, proposal, log weight, statistics
        tree = dict(
            z_left=z, r_left=r0, grad_left=grad,
            z_right=z, r_right=r0, grad_right=grad,
            z_prop=z, logp_prop=logp, grad_prop=grad,
            log_weight=jnp.zeros(()),  # relative to energy0
            r_sum=r0,
            depth=jnp.zeros((), jnp.int32),
            turning=jnp.zeros((), bool),
            diverging=jnp.zeros((), bool),
            sum_accept_prob=jnp.zeros(()),
            num_leaves=jnp.zeros(()),
            key=k_tree,
        )

        def build_subtree(tree, direction, depth):
            """One doubling: 2^depth leapfrog leaves grown in `direction`,
            with iterative checkpointing for internal U-turn checks."""
            num_leaves = jnp.int32(2) ** depth
            r_ckpts = jnp.zeros((max_depth, D))
            r_sum_ckpts = jnp.zeros((max_depth, D))

            sub = dict(
                z=jnp.where(direction > 0, tree["z_right"], tree["z_left"]),
                r=jnp.where(direction > 0, tree["r_right"], tree["r_left"]),
                grad=jnp.where(
                    direction > 0, tree["grad_right"], tree["grad_left"]
                ),
                z_first=jnp.zeros_like(tree["z_left"]),
                r_first=jnp.zeros_like(tree["r_left"]),
                grad_first=jnp.zeros_like(tree["grad_left"]),
                z_prop=tree["z_prop"],
                logp_prop=tree["logp_prop"],
                grad_prop=tree["grad_prop"],
                log_weight=-jnp.inf,
                r_sum=jnp.zeros_like(tree["r_sum"]),
                leaf=jnp.zeros((), jnp.int32),
                turning=jnp.zeros((), bool),
                diverging=jnp.zeros((), bool),
                sum_accept_prob=jnp.zeros(()),
                key=tree["key"],
            )

            def leaf_body(carry):
                sub, r_ckpts, r_sum_ckpts = carry
                z1, r1, logp1, grad1 = leapfrog(
                    sub["z"], sub["r"], sub["grad"], direction
                )
                energy1 = logp1 - 0.5 * jnp.sum(inv_mass * r1 * r1)
                delta = energy1 - energy0
                delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
                diverging = delta < -_DIVERGENCE_THRESHOLD
                accept_prob = jnp.minimum(1.0, jnp.exp(delta))

                is_first = sub["leaf"] == 0
                z_first = jnp.where(is_first, z1, sub["z_first"])
                r_first = jnp.where(is_first, r1, sub["r_first"])
                grad_first = jnp.where(is_first, grad1, sub["grad_first"])

                r_sum = sub["r_sum"] + r1

                # multinomial proposal update within the subtree
                new_log_weight = jnp.logaddexp(sub["log_weight"], delta)
                key, k_sel = jax.random.split(sub["key"])
                take_new = jnp.log(
                    jax.random.uniform(k_sel)
                ) < delta - new_log_weight
                z_prop = jnp.where(take_new, z1, sub["z_prop"])
                logp_prop = jnp.where(take_new, logp1, sub["logp_prop"])
                grad_prop = jnp.where(
                    take_new, grad1, sub["grad_prop"]
                )

                # checkpointing + internal U-turn checks
                leaf_idx = sub["leaf"]
                idx_min, idx_max = _leaf_idx_to_ckpt_idxs(leaf_idx)
                even = (leaf_idx % 2) == 0
                r_ckpts = jnp.where(
                    even,
                    r_ckpts.at[idx_max].set(r1),
                    r_ckpts,
                )
                r_sum_ckpts = jnp.where(
                    even,
                    r_sum_ckpts.at[idx_max].set(r_sum),
                    r_sum_ckpts,
                )

                def turning_scan(i, turning):
                    in_range = (i >= idx_min) & (i <= idx_max)
                    seg_sum = r_sum - r_sum_ckpts[i] + r_ckpts[i]
                    t = _is_turning(inv_mass, r_ckpts[i], r1, seg_sum)
                    return turning | (in_range & t)

                turning = jnp.where(
                    even,
                    jnp.zeros((), bool),
                    jax.lax.fori_loop(
                        0, max_depth, turning_scan, jnp.zeros((), bool)
                    ),
                )

                sub = dict(
                    z=z1, r=r1, grad=grad1,
                    z_first=z_first, r_first=r_first, grad_first=grad_first,
                    z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
                    log_weight=new_log_weight,
                    r_sum=r_sum,
                    leaf=leaf_idx + 1,
                    turning=turning,
                    diverging=diverging,
                    sum_accept_prob=sub["sum_accept_prob"] + accept_prob,
                    key=key,
                )
                return sub, r_ckpts, r_sum_ckpts

            def leaf_cond(carry):
                sub, _, _ = carry
                return (
                    (sub["leaf"] < num_leaves)
                    & ~sub["turning"]
                    & ~sub["diverging"]
                )

            sub, _, _ = jax.lax.while_loop(
                leaf_cond, leaf_body, (sub, r_ckpts, r_sum_ckpts)
            )
            return sub

        def doubling_body(tree):
            key, k_dir, k_accept = jax.random.split(tree["key"], 3)
            tree = dict(tree, key=key)
            direction = jnp.where(
                jax.random.bernoulli(k_dir), 1.0, -1.0
            ).astype(z.dtype)
            sub = build_subtree(tree, direction, tree["depth"])

            sub_ok = ~sub["turning"] & ~sub["diverging"]
            # biased progressive sampling across the doubling
            # (Betancourt 2017 A.3): accept the new half's proposal with
            # prob min(1, W_new / W_old)
            take_new = sub_ok & (
                jnp.log(jax.random.uniform(k_accept))
                < sub["log_weight"] - tree["log_weight"]
            )
            z_prop = jnp.where(take_new, sub["z_prop"], tree["z_prop"])
            logp_prop = jnp.where(
                take_new, sub["logp_prop"], tree["logp_prop"]
            )
            grad_prop = jnp.where(
                take_new, sub["grad_prop"], tree["grad_prop"]
            )

            # extend the boundary in the chosen direction
            def pick(a, b):
                return jnp.where(direction > 0, a, b)

            z_left = pick(tree["z_left"], sub["z"])
            r_left = pick(tree["r_left"], sub["r"])
            grad_left = pick(tree["grad_left"], sub["grad"])
            z_right = pick(sub["z"], tree["z_right"])
            r_right = pick(sub["r"], tree["r_right"])
            grad_right = pick(sub["grad"], tree["grad_right"])

            r_sum = tree["r_sum"] + sub["r_sum"]
            turning_full = _is_turning(inv_mass, r_left, r_right, r_sum)

            return dict(
                z_left=z_left, r_left=r_left, grad_left=grad_left,
                z_right=z_right, r_right=r_right, grad_right=grad_right,
                z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
                log_weight=jnp.logaddexp(
                    tree["log_weight"], sub["log_weight"]
                ),
                r_sum=r_sum,
                depth=tree["depth"] + 1,
                turning=sub["turning"] | (sub_ok & turning_full),
                diverging=sub["diverging"],
                sum_accept_prob=tree["sum_accept_prob"]
                + sub["sum_accept_prob"],
                num_leaves=tree["num_leaves"] + sub["leaf"].astype(tree["num_leaves"].dtype),
                key=tree["key"],
            )

        def doubling_cond(tree):
            return (
                (tree["depth"] < max_depth)
                & ~tree["turning"]
                & ~tree["diverging"]
            )

        tree = jax.lax.while_loop(doubling_cond, doubling_body, tree)

        accept_stat = tree["sum_accept_prob"] / jnp.maximum(
            tree["num_leaves"], 1.0
        )
        return (
            tree["z_prop"],
            tree["logp_prop"],
            tree["grad_prop"],
            accept_stat,
            tree["diverging"],
            tree["depth"],
        )

    # ------------------------------------------------------------------

    def _make_step_all(self):
        @partial(jax.jit, static_argnums=())
        def step_all(zs, logps, grads, keys, eps, inv_mass):
            return jax.vmap(
                lambda z1, l1, g1, k1: self._transition(
                    z1, l1, g1, k1, eps, inv_mass
                )
            )(zs, logps, grads, keys)

        return step_all

    @staticmethod
    def _warmup_windows(num_warmup: int):
        """Stan's warmup schedule: 75 step-size-only, expanding mass
        windows 25/50/100/..., 50 step-size-only at the end."""
        if num_warmup < 20:
            return [(0, num_warmup)]
        init = min(75, int(0.15 * num_warmup))
        term = min(50, int(0.1 * num_warmup))
        windows = []
        start = init
        size = 25
        while start + size < num_warmup - term:
            if start + 2 * size >= num_warmup - term:
                size = num_warmup - term - start  # merge the tail window
            windows.append((start, start + size))
            start += size
            size *= 2
        return windows

    def run(self):
        cfg = self.config
        D = self.prior.num_variables
        C = cfg.num_chains
        key = jax.random.PRNGKey(cfg.seed if cfg.seed else 42)
        k_init, key = jax.random.split(key)

        x0 = np.asarray(self.prior.sample(k_init, (C,)))
        zs = jnp.asarray(self._reparam.from_x(x0))
        logps, grads = jax.vmap(self._vgrad)(zs)

        step_all = self._make_step_all()
        t0 = time.time()

        # ---- warmup: dual averaging + windowed diagonal mass ----
        # All per-iteration statistics (dual-averaging state, Welford
        # mass accumulators, divergence counter) live ON DEVICE and are
        # updated by small jitted programs: the host only pulls values
        # at window boundaries; a per-iteration device->host pull would
        # stall the device every iteration.
        mu = jnp.log(10.0 * cfg.initial_step_size)
        log_eps = jnp.log(jnp.asarray(cfg.initial_step_size))
        log_eps_bar = jnp.zeros(())
        h_bar = jnp.zeros(())
        gamma, t0_da, kappa = 0.05, 10.0, 0.75
        target_accept = cfg.target_accept
        inv_mass = jnp.ones((D,))

        @jax.jit
        def da_update(h_bar, log_eps_bar, mu, astat, m):
            a = jnp.mean(jnp.nan_to_num(astat, nan=0.0))
            h_bar = (1 - 1 / (m + t0_da)) * h_bar + (target_accept - a) / (
                m + t0_da
            )
            log_eps = mu - jnp.sqrt(m) / gamma * h_bar
            eta = m ** (-kappa)
            log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
            return h_bar, log_eps, log_eps_bar

        @jax.jit
        def welford_update(n, mean, m2, batch):
            # sequential per-row merge, identical to the host Welford
            def body(carry, row):
                n, mean, m2 = carry
                n1 = n + 1.0
                d1 = row - mean
                mean = mean + d1 / n1
                m2 = m2 + d1 * (row - mean)
                return (n1, mean, m2), None

            (n, mean, m2), _ = jax.lax.scan(body, (n, mean, m2), batch)
            return n, mean, m2

        windows = self._warmup_windows(cfg.num_warmup)
        win_ix = 0
        welford_n = jnp.zeros(())
        welford_mean = jnp.zeros(D)
        welford_m2 = jnp.zeros(D)
        n_div_warm = jnp.zeros((), jnp.int32)
        # dual-averaging iteration counter, WINDOW-LOCAL as in Stan:
        # each mass-matrix update restarts the averaging (mu, h_bar,
        # eps_bar AND the counter). With a global counter, a restart
        # late in a long warmup leaves the gain sqrt(m)/gamma huge and
        # the per-step increments 1/(m+t0) tiny — an unstable
        # oscillation whose average eps_bar can come out an order of
        # magnitude too large (measured: 100% divergences at
        # num_warmup=256 while 96 warmed up fine).
        da_m = 0

        for it in range(cfg.num_warmup):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, C)
            zs, logps, grads, astat, div, _depth = step_all(
                zs, logps, grads, keys, jnp.exp(log_eps), inv_mass
            )
            n_div_warm = n_div_warm + jnp.sum(div, dtype=jnp.int32)
            da_m += 1
            h_bar, log_eps, log_eps_bar = da_update(
                h_bar, log_eps_bar, mu, astat, float(da_m)
            )

            if win_ix < len(windows):
                lo, hi = windows[win_ix]
                if lo <= it < hi:
                    welford_n, welford_mean, welford_m2 = welford_update(
                        welford_n, welford_mean, welford_m2, zs
                    )
                if it == hi - 1:
                    wn = float(welford_n)
                    if wn > 4:
                        var = np.asarray(welford_m2) / (wn - 1)
                        # Stan's shrinkage toward unit metric
                        var = (wn / (wn + 5.0)) * var + 1e-3 * (
                            5.0 / (wn + 5.0)
                        )
                        inv_mass = jnp.asarray(var)
                    # restart dual averaging around the current step
                    # size (Stan restart: counter, mu, h_bar, eps_bar)
                    mu = jnp.log(10.0) + log_eps
                    log_eps_bar = jnp.zeros(())
                    h_bar = jnp.zeros(())
                    da_m = 0
                    welford_n = jnp.zeros(())
                    welford_mean = jnp.zeros(D)
                    welford_m2 = jnp.zeros(D)
                    win_ix += 1

        eps_final = jnp.exp(log_eps_bar)
        logger.info(
            "NUTS warmup done: step size %.4g, %d divergences",
            float(eps_final),
            int(n_div_warm),
        )

        # ---- sampling ----
        t_sampling = time.time()  # post-warmup: step_all is compiled,
        # step size/mass are frozen — the steady-state sampling phase
        out_z, out_logp = [], []
        # divergence/depth counters accumulate on device; the host pulls
        # them once after the loop
        n_div_dev = jnp.zeros((), jnp.int32)
        depth_dev = jnp.zeros((), jnp.int32)
        total_iter = cfg.num_samples * cfg.use_every_nth
        for it in range(total_iter):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, C)
            zs, logps, grads, astat, div, depth = step_all(
                zs, logps, grads, keys, eps_final, inv_mass
            )
            n_div_dev = n_div_dev + jnp.sum(div, dtype=jnp.int32)
            depth_dev = depth_dev + jnp.sum(depth, dtype=jnp.int32)
            if (it + 1) % cfg.use_every_nth == 0:
                out_z.append(np.asarray(zs))
                out_logp.append(np.asarray(logps))
        n_div = int(n_div_dev)
        depth_sum = int(depth_dev)

        elapsed = time.time() - t0
        sampling_seconds = time.time() - t_sampling
        z_arr = np.stack(out_z)  # (S, C, D)
        xs = np.asarray(
            jax.vmap(jax.vmap(self._reparam.to_x))(jnp.asarray(z_arr))
        )
        lprior = np.asarray(
            jax.vmap(jax.vmap(self.prior.log_pdf))(jnp.asarray(xs))
        )
        llh = (
            np.asarray(
                jax.vmap(jax.vmap(self.likelihood.log_prob))(jnp.asarray(xs))
            )
            * self.likelihood.learning_rate
        )

        S = xs.shape[0]
        xs_flat = xs.reshape(S * C, 1, D)
        lp_flat = lprior.reshape(S * C, 1)
        ll_flat = llh.reshape(S * C, 1)
        for handler in self.sample_handlers:
            handler.receive_samples(xs_flat, lp_flat, ll_flat, self.ladder)

        logger.info(
            "NUTS: %d samples x %d chains in %.2fs "
            "(%d divergences, mean tree depth %.2f)",
            cfg.num_samples,
            C,
            elapsed,
            n_div,
            depth_sum / max(total_iter * C, 1),
        )
        return {
            "samples": xs_flat,
            "samples_per_chain": xs,
            "log_prior": lp_flat,
            "log_likelihood": ll_flat,
            "temperatures": self.ladder,
            "divergences": n_div,
            "mean_tree_depth": depth_sum / max(total_iter * C, 1),
            "step_size": float(eps_final),
            "elapsed_seconds": elapsed,
            # wall time of the post-warmup sampling loop only (step fn
            # already compiled, step size/mass frozen) — the number to
            # divide ESS by for steady-state ESS/sec
            "sampling_seconds": sampling_seconds,
        }
