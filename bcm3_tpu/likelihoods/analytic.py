"""Analytic test likelihoods as pure JAX log-density functions.

JAX equivalent of the reference test likelihoods
(reference: src/likelihoods/TestLikelihood{Banana,Circular,
MultimodalGaussians,TruncatedT}.cpp, LikelihoodDummy.cpp). Each returns
a scalar log-probability for one parameter vector and batches over
chains with `vmap`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from bcm3_tpu.distributions import univariate as uv
from bcm3_tpu.distributions.mvn import logpdf_mvn_chol, logpdf_mvt_chol


def make_banana(dim: int, sd1: float, sd2: float):
    """Banana-shaped density (reference: TestLikelihoodBanana.cpp:42-55).

    First dim-1 coordinates are N(0, sd1); the last follows
    N(4y + (1-y)^2, sd2) with y the sum of the first dim-1 coordinates.
    """
    if dim < 2:
        raise ValueError("Banana dimension must be at least 2")

    def log_prob(x):
        lead = jnp.sum(uv.logpdf_normal(x[: dim - 1], 0.0, sd1))
        y = jnp.sum(x[: dim - 1])
        ridge = uv.logpdf_normal(x[dim - 1], y + 3.0 * y + (1.0 - y) ** 2, sd2)
        return lead + ridge

    return log_prob


def make_circular(dim: int, radius: float = 2.0, offset: float = 3.5, width: float = 0.1):
    """Two circular ridges (reference: TestLikelihoodCircular.cpp:43-53)."""
    mu1 = np.zeros(dim)
    mu2 = np.zeros(dim)
    mu1[0] = -offset
    mu2[0] = offset

    def log_prob(x):
        d1 = jnp.linalg.norm(x - mu1)
        d2 = jnp.linalg.norm(x - mu2)
        return jnp.logaddexp(
            uv.logpdf_normal(d1, radius, width), uv.logpdf_normal(d2, radius, width)
        )

    return log_prob


def make_multimodal_gaussians():
    """Fixed 2-D two-component mixture
    (reference: TestLikelihoodMultimodalGaussians.cpp:24-41)."""
    means = np.array([[-5.0, -5.0], [5.0, 5.0]])
    covs = np.array(
        [
            [[1.0, -0.9], [-0.9, 1.0]],
            [[2.0, -0.5], [-0.5, 1.0]],
        ]
    )
    chols = np.linalg.cholesky(covs)
    log_half = np.log(0.5)

    def log_prob(x):
        lp1 = log_half + logpdf_mvn_chol(x, means[0], chols[0])
        lp2 = log_half + logpdf_mvn_chol(x, means[1], chols[1])
        return jnp.logaddexp(lp1, lp2)

    return log_prob


def make_truncated_t(mus, sigmas, nus, weights):
    """Mixture of multivariate t densities
    (reference: TestLikelihoodTruncatedT.cpp:79-88). The truncation comes
    from the bounded prior, not the density itself.
    """
    mus = np.asarray(mus, dtype=np.float64)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    nus = np.asarray(nus, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    chols = np.linalg.cholesky(sigmas)
    log_w = np.log(weights)

    from jax.scipy.special import logsumexp

    def log_prob(x):
        lps = jnp.stack(
            [
                log_w[i] + logpdf_mvt_chol(x, mus[i], chols[i], nus[i])
                for i in range(len(nus))
            ]
        )
        return logsumexp(lps)

    return log_prob


def make_dummy():
    """Trivial likelihood (reference: LikelihoodDummy.cpp): always 0."""

    def log_prob(x):
        return jnp.zeros((), dtype=x.dtype)

    return log_prob
