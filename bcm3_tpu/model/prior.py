"""Vectorized prior over a variable set, as pure JAX functions.

JAX equivalent of the reference prior layer
(reference: src/sampler/Prior.cpp:21-66, PriorIndependence.cpp,
UnivariateMarginal.cpp). Instead of one C++ object per variable
dispatching on an enum, the prior is encoded as parallel parameter
arrays over the variable axis; `log_pdf` evaluates every distribution
family vectorized over all variables and combines them with masks, so a
single call scores the full (chains, variables) batch on the VPU with
no per-variable control flow.

Dirichlet blocks (reference: src/sampler/MultivariateMarginal.h:26-31)
are supported as contiguous index ranges whose last variable is the
residual 1 - sum(others) (reference: src/sampler/Sampler.h:38-42).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.distributions import univariate as uv
from bcm3_tpu.model.variables import VariableSet, _parse_bool

# Distribution family codes
UNIFORM = 0
NORMAL = 1
EXPONENTIAL = 2
GAMMA = 3
BETA = 4
HALF_CAUCHY = 5
BETA_PRIME = 6
EXPONENTIAL_MIX = 7
DIRICHLET_MEMBER = 8  # handled by the Dirichlet block logic, not marginals

_FAMILY_NAMES = {
    "uniform": UNIFORM,
    "normal": NORMAL,
    "exponential": EXPONENTIAL,
    "gamma": GAMMA,
    "beta": BETA,
    "half_cauchy": HALF_CAUCHY,
    "beta_prime": BETA_PRIME,
    "exponential_mix": EXPONENTIAL_MIX,
}


@dataclass
class DirichletBlock:
    start: int  # first variable index of the block (variables are contiguous)
    alphas: np.ndarray  # concentration parameters, one per member variable

    @property
    def size(self) -> int:
        return len(self.alphas)

    @property
    def residual_index(self) -> int:
        return self.start + self.size - 1


@dataclass
class Prior:
    """Independent marginals + optional Dirichlet blocks."""

    varset: VariableSet
    dist_type: np.ndarray  # (D,) int
    p1: np.ndarray  # (D,) first parameter slot
    p2: np.ndarray  # (D,) second parameter slot
    p3: np.ndarray  # (D,) third parameter slot
    lower: np.ndarray  # (D,) bounds (inclusive)
    upper: np.ndarray
    dirichlet_blocks: List[DirichletBlock] = field(default_factory=list)

    # ------------------------------------------------------------------
    # Construction

    @classmethod
    def from_xml(cls, filename: str, varset: VariableSet | None = None) -> "Prior":
        if varset is None:
            varset = VariableSet.from_xml(filename)
        tree = ET.parse(filename)
        root = tree.getroot()
        if root.tag not in ("prior", "variableset"):
            raise ValueError(f"Incorrect prior XML format: root '{root.tag}'")
        ptype = root.get("type", "independence") or "independence"
        if ptype != "independence":
            raise ValueError(f"Unknown prior type '{ptype}'")

        D = varset.num_variables
        dist_type = np.full(D, -1, dtype=np.int32)
        p1 = np.zeros(D)
        p2 = np.zeros(D)
        p3 = np.zeros(D)
        lower = np.full(D, -np.inf)
        upper = np.full(D, np.inf)
        dirichlet: dict[int, DirichletBlock] = {}

        ix = 0
        for var in root.findall("variable"):
            if _parse_bool(var.get("multivariate", "false")):
                # Dirichlet member (reference: PriorIndependence.cpp:25-67)
                dist = var.get("distribution")
                if dist != "dirichlet":
                    raise ValueError(
                        f"Only dirichlet multivariate distributions supported, got {dist}"
                    )
                did = int(var.get("id"))
                if did <= 0:
                    raise ValueError("Multivariate distribution IDs start at 1")
                alpha = float(var.get("alpha"))
                if did - 1 in dirichlet:
                    blk = dirichlet[did - 1]
                    if ix != blk.start + blk.size:
                        raise ValueError(
                            "Variables in a multivariate distribution must be contiguous"
                        )
                    blk.alphas = np.append(blk.alphas, alpha)
                else:
                    dirichlet[did - 1] = DirichletBlock(ix, np.array([alpha]))
                dist_type[ix] = DIRICHLET_MEMBER
                lower[ix] = 0.0
                upper[ix] = 1.0
                ix += 1
            else:
                repeat = int(var.get("repeat", "1"))
                name = var.get("distribution")
                if name not in _FAMILY_NAMES:
                    raise ValueError(f"Invalid distribution type '{name}'")
                code = _FAMILY_NAMES[name]
                a = b = c = 0.0
                if code == UNIFORM:
                    a, b = float(var.get("lower")), float(var.get("upper"))
                    if b <= a:
                        raise ValueError("Uniform with upper <= lower")
                elif code == NORMAL:
                    a, b = float(var.get("mu")), float(var.get("sigma"))
                    if b <= 0:
                        raise ValueError("Normal with non-positive sigma")
                elif code == EXPONENTIAL:
                    a = float(var.get("lambda"))
                    if a <= 0:
                        raise ValueError("Exponential with non-positive lambda")
                elif code == GAMMA:
                    a, b = float(var.get("k")), float(var.get("theta"))
                    if a <= 0 or b <= 0:
                        raise ValueError("Gamma with non-positive k or theta")
                elif code == BETA:
                    a, b = float(var.get("a")), float(var.get("b"))
                    if a <= 0 or b <= 0:
                        raise ValueError("Beta with non-positive a or b")
                elif code == HALF_CAUCHY:
                    a = float(var.get("scale"))
                    if a <= 0:
                        raise ValueError("HalfCauchy with non-positive scale")
                elif code == BETA_PRIME:
                    a, b = float(var.get("a")), float(var.get("b"))
                    c = float(var.get("scale"))
                elif code == EXPONENTIAL_MIX:
                    a = float(var.get("lambda"))
                    b = float(var.get("lambda2"))
                    c = float(var.get("mix"))
                for _ in range(repeat):
                    dist_type[ix] = code
                    p1[ix], p2[ix], p3[ix] = a, b, c
                    lower[ix] = cls._family_lower(code, a, b, c)
                    upper[ix] = cls._family_upper(code, a, b, c)
                    ix += 1

        if ix != D:
            raise ValueError(f"Parsed {ix} prior entries for {D} variables")
        return cls(
            varset=varset,
            dist_type=dist_type,
            p1=p1,
            p2=p2,
            p3=p3,
            lower=lower,
            upper=upper,
            dirichlet_blocks=list(dirichlet.values()),
        )

    @staticmethod
    def _family_lower(code, a, b, c) -> float:
        # reference: UnivariateMarginal.cpp GetLowerBound
        if code == UNIFORM:
            return a
        if code in (BETA, EXPONENTIAL, GAMMA, HALF_CAUCHY, BETA_PRIME):
            return 0.0
        return -np.inf

    @staticmethod
    def _family_upper(code, a, b, c) -> float:
        # reference: UnivariateMarginal.cpp GetUpperBound
        if code == UNIFORM:
            return b
        if code == BETA:
            return 1.0
        return np.inf

    @property
    def num_variables(self) -> int:
        return len(self.dist_type)

    # ------------------------------------------------------------------
    # Device-side evaluation

    def log_pdf(self, x):
        """Sum of marginal log-densities. x: (..., D) -> (...)."""
        t = jnp.asarray(self.dist_type)
        a = jnp.asarray(self.p1, dtype=x.dtype)
        b = jnp.asarray(self.p2, dtype=x.dtype)
        c = jnp.asarray(self.p3, dtype=x.dtype)

        lp = jnp.zeros_like(x)

        def put(code, values):
            return jnp.where(t == code, values, lp)

        # Evaluate each family over the full variable axis; masks select.
        # Parameters of NON-member variables are substituted with neutral
        # values (sd/rate/shape = 1, mu = 0) so every masked branch stays
        # FINITE for any x in the batch. A mere epsilon floor is not
        # enough: (x - 0)/tiny overflows to inf in float32, and reverse
        # mode then computes 0 * inf = NaN through the select — a NaN
        # gradient with a perfectly finite primal. (This broke NUTS in
        # f32 while every x64 CPU run was fine; the old 1e-300 floor
        # additionally underflowed to 0.0 in f32.)
        tiny = jnp.asarray(jnp.finfo(x.dtype).tiny, x.dtype)

        def member_or(code, arr, neutral):
            return jnp.where(t == code, jnp.maximum(arr, tiny), neutral)

        lp = put(UNIFORM, uv.logpdf_uniform(x, a, jnp.where(b > a, b, a + 1.0)))
        lp = put(
            NORMAL,
            uv.logpdf_normal(
                x, jnp.where(t == NORMAL, a, 0.0), member_or(NORMAL, b, 1.0)
            ),
        )
        lp = put(
            EXPONENTIAL, uv.logpdf_exponential(x, member_or(EXPONENTIAL, a, 1.0))
        )
        lp = put(
            GAMMA,
            uv.logpdf_gamma(
                x, member_or(GAMMA, a, 1.0), member_or(GAMMA, b, 1.0)
            ),
        )
        lp = put(
            BETA,
            uv.logpdf_beta(x, member_or(BETA, a, 1.0), member_or(BETA, b, 1.0)),
        )
        lp = put(
            HALF_CAUCHY, uv.logpdf_half_cauchy(x, member_or(HALF_CAUCHY, a, 1.0))
        )
        lp = put(
            BETA_PRIME,
            uv.logpdf_beta_prime(
                x,
                member_or(BETA_PRIME, a, 1.0),
                member_or(BETA_PRIME, b, 1.0),
                member_or(BETA_PRIME, c, 1.0),
            ),
        )
        lp = put(
            EXPONENTIAL_MIX,
            uv.logpdf_exponential_mix(
                x,
                member_or(EXPONENTIAL_MIX, a, 1.0),
                member_or(EXPONENTIAL_MIX, b, 1.0),
                jnp.clip(c, 1e-12, 1.0 - 1e-12),
            ),
        )
        # Dirichlet members contribute via the block density below
        lp = jnp.where(t == DIRICHLET_MEMBER, 0.0, lp)
        total = jnp.sum(lp, axis=-1)

        for blk in self.dirichlet_blocks:
            xs = x[..., blk.start : blk.start + blk.size]
            alphas = jnp.asarray(blk.alphas, dtype=x.dtype)
            inside = jnp.all((xs >= 0) & (xs <= 1), axis=-1)
            simplex = jnp.abs(jnp.sum(xs, axis=-1) - 1.0) < 1e-6
            from jax.scipy import special as jsp

            logb = jnp.sum(jsp.gammaln(alphas)) - jsp.gammaln(jnp.sum(alphas))
            xs_safe = jnp.clip(xs, jnp.finfo(x.dtype).tiny, 1.0)
            logd = jnp.sum((alphas - 1.0) * jnp.log(xs_safe), axis=-1) - logb
            total = total + jnp.where(inside & simplex, logd, -jnp.inf)

        return total

    def sample(self, key, shape=()):
        """Draw from the prior: returns array of shape (*shape, D)."""
        D = self.num_variables
        t = jnp.asarray(self.dist_type)
        a = jnp.asarray(self.p1)
        b = jnp.asarray(self.p2)
        c = jnp.asarray(self.p3)
        full = (*shape, D)

        ku, kn, kg, kbt, kb2, kmix = jax.random.split(key, 6)
        u = jax.random.uniform(ku, full)
        z = jax.random.normal(kn, full)

        out = jnp.zeros(full)
        out = jnp.where(t == UNIFORM, a + u * (b - a), out)
        out = jnp.where(t == NORMAL, a + b * z, out)
        tiny = jnp.finfo(out.dtype).tiny
        out = jnp.where(t == EXPONENTIAL, -jnp.log1p(-u) / jnp.maximum(a, tiny), out)
        gamma_shape = jnp.where(t == GAMMA, a, 1.0)
        g = jax.random.gamma(kg, gamma_shape, full)
        out = jnp.where(t == GAMMA, g * b, out)
        beta_a = jnp.where((t == BETA) | (t == BETA_PRIME), a, 1.0)
        beta_b = jnp.where((t == BETA) | (t == BETA_PRIME), b, 1.0)
        bt = jax.random.beta(kbt, beta_a, beta_b, full)
        out = jnp.where(t == BETA, bt, out)
        out = jnp.where(t == HALF_CAUCHY, a * jnp.tan(0.5 * jnp.pi * u), out)
        out = jnp.where(t == BETA_PRIME, c * bt / (1.0 - bt), out)
        mix_u = jax.random.uniform(kmix, full)
        u2 = jax.random.uniform(kb2, full)
        lam = jnp.where(mix_u < c, a, b)
        out = jnp.where(
            t == EXPONENTIAL_MIX, -jnp.log1p(-u2) / jnp.maximum(lam, tiny), out
        )

        for blk in self.dirichlet_blocks:
            kd = jax.random.fold_in(key, 1000 + blk.start)
            alphas = jnp.asarray(blk.alphas)
            gs = jax.random.gamma(kd, alphas, (*shape, blk.size))
            ds = gs / jnp.sum(gs, axis=-1, keepdims=True)
            out = out.at[..., blk.start : blk.start + blk.size].set(ds)

        return out

    # ------------------------------------------------------------------
    # Host-side summaries (for proposal fallbacks)

    def marginal_mean(self) -> np.ndarray:
        """reference: UnivariateMarginal.cpp EvaluateMean (undefined -> scale)."""
        t, a, b, c = self.dist_type, self.p1, self.p2, self.p3
        m = np.zeros(self.num_variables)
        m = np.where(t == UNIFORM, 0.5 * (a + b), m)
        m = np.where(t == NORMAL, a, m)
        with np.errstate(divide="ignore", invalid="ignore"):
            m = np.where(t == EXPONENTIAL, 1.0 / np.where(a > 0, a, 1.0), m)
            m = np.where(t == GAMMA, a * b, m)
            m = np.where(t == BETA, a / np.where(a + b > 0, a + b, 1.0), m)
            m = np.where(t == HALF_CAUCHY, a, m)
            bp_mean = np.where(b > 1.0, c * a / np.where(b > 1.0, b - 1.0, 1.0), c)
            m = np.where(t == BETA_PRIME, bp_mean, m)
            em = c / np.where(a > 0, a, 1.0) + (1.0 - c) / np.where(b > 0, b, 1.0)
            m = np.where(t == EXPONENTIAL_MIX, em, m)
        for blk in self.dirichlet_blocks:
            s = blk.alphas.sum()
            m[blk.start : blk.start + blk.size] = blk.alphas / s
        return m

    def marginal_variance(self) -> np.ndarray:
        """reference: UnivariateMarginal.cpp EvaluateVariance (undefined -> scale^2)."""
        t, a, b, c = self.dist_type, self.p1, self.p2, self.p3
        v = np.ones(self.num_variables)
        v = np.where(t == UNIFORM, (b - a) ** 2 / 12.0, v)
        v = np.where(t == NORMAL, b * b, v)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.where(t == EXPONENTIAL, 1.0 / np.where(a > 0, a * a, 1.0), v)
            v = np.where(t == GAMMA, a * b * b, v)
            apb = np.where(a + b > 0, a + b, 1.0)
            v = np.where(t == BETA, a * b / (apb * apb * (apb + 1.0)), v)
            v = np.where(t == HALF_CAUCHY, a * a, v)
            bm1 = np.where(b > 2.0, b - 1.0, 1.0)
            bm2 = np.where(b > 2.0, b - 2.0, 1.0)
            bp_var = np.where(b > 2.0, c * c * a * (a + b - 1.0) / (bm2 * bm1 * bm1), c * c)
            v = np.where(t == BETA_PRIME, bp_var, v)
            em = c**2 / np.where(a > 0, a * a, 1.0) + (1.0 - c) ** 2 / np.where(
                b > 0, b * b, 1.0
            )
            v = np.where(t == EXPONENTIAL_MIX, em, v)
        for blk in self.dirichlet_blocks:
            al = blk.alphas
            a0 = al.sum()
            v[blk.start : blk.start + blk.size] = (
                al * (a0 - al) / (a0 * a0 * (a0 + 1.0))
            )
        return v
