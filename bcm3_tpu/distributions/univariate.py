"""Univariate probability distributions as pure JAX functions.

JAX equivalent of the reference distribution zoo
(reference: src/utils/ProbabilityDistributions.h:5-44 and
src/sampler/UnivariateMarginal.cpp) — every function is elementwise,
broadcastable, differentiable and usable under `jit`/`vmap`.

Conventions follow the reference parameterizations:
- exponential(lambda):   rate parameterization, pdf = lambda * exp(-lambda x)
- gamma(k, theta):       shape/scale
- beta(a, b):            standard on [0, 1]
- half_cauchy(scale):    x >= 0
- beta_prime(a, b, scale): scale * (x/(1-x)) with x ~ Beta(a, b)
- exponential_mix(lambda, lambda2, mix): mix * Exp(lambda) + (1-mix) * Exp(lambda2)
- student_t(x, mu, sigma, nu): location/scale t
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy import special as jsp

_NEG_INF = -jnp.inf

# log(2) - log(pi), used by the half-Cauchy log-pdf
_LOG_2_OVER_PI = -0.4515827052894548647


# ---------------------------------------------------------------------------
# Normal


def logpdf_normal(x, mu, sigma):
    d = (x - mu) / sigma
    return -0.5 * d * d - jnp.log(sigma) - 0.5 * jnp.log(2.0 * jnp.pi)


def pdf_normal(x, mu, sigma):
    return jnp.exp(logpdf_normal(x, mu, sigma))


def cdf_normal(x, mu, sigma):
    return jsp.ndtr((x - mu) / sigma)


def quantile_normal(p, mu, sigma):
    return mu + sigma * jsp.ndtri(p)


# ---------------------------------------------------------------------------
# Uniform


def logpdf_uniform(x, lower, upper):
    inside = (x >= lower) & (x <= upper)
    return jnp.where(inside, -jnp.log(upper - lower), _NEG_INF)


def cdf_uniform(x, lower, upper):
    return jnp.clip((x - lower) / (upper - lower), 0.0, 1.0)


def quantile_uniform(p, lower, upper):
    return lower + p * (upper - lower)


# ---------------------------------------------------------------------------
# Exponential (rate lambda)


def logpdf_exponential(x, lam):
    return jnp.where(x >= 0, jnp.log(lam) - lam * x, _NEG_INF)


def cdf_exponential(x, lam):
    return jnp.where(x >= 0, -jnp.expm1(-lam * x), 0.0)


def quantile_exponential(p, lam):
    return -jnp.log1p(-p) / lam


# ---------------------------------------------------------------------------
# Gamma (shape k, scale theta)


def logpdf_gamma(x, k, theta):
    valid = x > 0
    xs = jnp.where(valid, x, 1.0)
    logp = (k - 1.0) * jnp.log(xs) - xs / theta - jsp.gammaln(k) - k * jnp.log(theta)
    return jnp.where(valid, logp, _NEG_INF)


def cdf_gamma(x, k, theta):
    return jnp.where(x > 0, jsp.gammainc(k, jnp.maximum(x, 0.0) / theta), 0.0)


# ---------------------------------------------------------------------------
# Beta


def logpdf_beta(x, a, b):
    valid = (x > 0) & (x < 1)
    xs = jnp.where(valid, x, 0.5)
    logp = (a - 1.0) * jnp.log(xs) + (b - 1.0) * jnp.log1p(-xs) - jsp.betaln(a, b)
    return jnp.where(valid, logp, _NEG_INF)


def cdf_beta(x, a, b):
    return jsp.betainc(a, b, jnp.clip(x, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Cauchy / half-Cauchy


def logpdf_cauchy(x, x0, scale):
    d = (x - x0) / scale
    return -jnp.log(jnp.pi * scale * (1.0 + d * d))


def cdf_cauchy(x, x0, scale):
    return 0.5 + jnp.arctan((x - x0) / scale) / jnp.pi


def logpdf_half_cauchy(x, scale):
    # reference: UnivariateMarginal.cpp:524-528
    logp = _LOG_2_OVER_PI - jnp.log(scale + x * x / scale)
    return jnp.where(x > 0, logp, _NEG_INF)


def cdf_half_cauchy(x, scale):
    return jnp.where(x > 0, 2.0 * jnp.arctan(x / scale) / jnp.pi, 0.0)


def quantile_half_cauchy(p, scale):
    return scale * jnp.tan(0.5 * jnp.pi * p)


# ---------------------------------------------------------------------------
# Beta-prime (scaled)


def logpdf_beta_prime(x, a, b, scale):
    valid = x > 0
    z = jnp.where(valid, x, 1.0) / scale
    logp = (
        (a - 1.0) * jnp.log(z)
        - (a + b) * jnp.log1p(z)
        - jsp.betaln(a, b)
        - jnp.log(scale)
    )
    return jnp.where(valid, logp, _NEG_INF)


def cdf_beta_prime(x, a, b, scale):
    z = jnp.maximum(x, 0.0) / scale
    return jsp.betainc(a, b, z / (1.0 + z))


# ---------------------------------------------------------------------------
# Exponential mixture


def logpdf_exponential_mix(x, lam, lam2, mix):
    lp1 = jnp.log(mix) + logpdf_exponential(x, lam)
    lp2 = jnp.log1p(-mix) + logpdf_exponential(x, lam2)
    return jnp.logaddexp(lp1, lp2)


def cdf_exponential_mix(x, lam, lam2, mix):
    return mix * cdf_exponential(x, lam) + (1.0 - mix) * cdf_exponential(x, lam2)


# ---------------------------------------------------------------------------
# Student t (location/scale)


def logpdf_t(x, mu, sigma, nu):
    d = (x - mu) / sigma
    return (
        jsp.gammaln(0.5 * (nu + 1.0))
        - jsp.gammaln(0.5 * nu)
        - 0.5 * jnp.log(nu * jnp.pi)
        - jnp.log(sigma)
        - 0.5 * (nu + 1.0) * jnp.log1p(d * d / nu)
    )


def cdf_t(x, mu, sigma, nu):
    d = (x - mu) / sigma
    z = nu / (nu + d * d)
    ib = 0.5 * jsp.betainc(0.5 * nu, 0.5, z)
    return jnp.where(d > 0, 1.0 - ib, ib)


def logpdf_truncated_t(x, mu, sigma, nu, lower, upper):
    lognorm = jnp.log(cdf_t(upper, mu, sigma, nu) - cdf_t(lower, mu, sigma, nu))
    inside = (x >= lower) & (x <= upper)
    return jnp.where(inside, logpdf_t(x, mu, sigma, nu) - lognorm, _NEG_INF)


# ---------------------------------------------------------------------------
# Truncated normal


def logpdf_truncated_normal(x, mu, sigma, lower, upper):
    lognorm = jnp.log(cdf_normal(upper, mu, sigma) - cdf_normal(lower, mu, sigma))
    inside = (x >= lower) & (x <= upper)
    return jnp.where(inside, logpdf_normal(x, mu, sigma) - lognorm, _NEG_INF)


# ---------------------------------------------------------------------------
# Generalized Pareto (reference: ProbabilityDistributions.h GPD entries)


def logpdf_gpd(x, mu, sigma, xi):
    z = (x - mu) / sigma
    # xi == 0 limit is the exponential; handle via where
    xi_safe = jnp.where(xi == 0.0, 1.0, xi)
    logp_general = -(1.0 / xi_safe + 1.0) * jnp.log1p(xi_safe * z) - jnp.log(sigma)
    logp_exp = -z - jnp.log(sigma)
    logp = jnp.where(xi == 0.0, logp_exp, logp_general)
    support = (z >= 0) & ((xi >= 0) | (z <= -1.0 / xi_safe))
    return jnp.where(support, logp, _NEG_INF)
