"""Multivariate normal and Student-t densities in JAX.

JAX equivalent of the reference implementations
(reference: src/stats/mvn.h:5-8, src/stats/mvt.h:5-8). Densities are
computed from a Cholesky factor so they can be evaluated for many points
with one triangular solve batched over the trailing axis.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy import special as jsp
from jax.scipy.linalg import solve_triangular


def chol_logdet(chol):
    """Log-determinant of A from its lower Cholesky factor L (A = L L^T)."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)


def _solve_lower_batched(chol, dx):
    """L^{-1} dx for dx of shape (..., d) against a single (d, d) factor.

    Implemented as one matrix triangular solve over the flattened batch so
    XLA lowers it to a single op instead of a vmapped loop.
    """
    batch_shape = dx.shape[:-1]
    d = dx.shape[-1]
    flat = dx.reshape(-1, d)
    sol = solve_triangular(chol, flat.T, lower=True)
    return sol.T.reshape(*batch_shape, d)


def logpdf_mvn_chol(x, mean, chol):
    """Log N(x; mean, L L^T) given lower Cholesky factor ``chol``.

    x: (..., d); mean: (d,); chol: (d, d). Returns (...).
    """
    d = mean.shape[-1]
    v = _solve_lower_batched(chol, x - mean)
    maha = jnp.sum(v * v, axis=-1)
    return -0.5 * (maha + chol_logdet(chol) + d * jnp.log(2.0 * jnp.pi))


def logpdf_mvn(x, mean, cov):
    """Log multivariate normal density (reference: src/stats/mvn.cpp dmvnormal)."""
    return logpdf_mvn_chol(x, mean, jnp.linalg.cholesky(cov))


def logpdf_mvt_chol(x, mean, chol, nu):
    """Log multivariate-t density from a lower Cholesky factor of the scale matrix."""
    d = mean.shape[-1]
    v = _solve_lower_batched(chol, x - mean)
    maha = jnp.sum(v * v, axis=-1)
    return (
        jsp.gammaln(0.5 * (nu + d))
        - jsp.gammaln(0.5 * nu)
        - 0.5 * d * jnp.log(nu * jnp.pi)
        - 0.5 * chol_logdet(chol)
        - 0.5 * (nu + d) * jnp.log1p(maha / nu)
    )


def logpdf_mvt(x, mean, scale, nu):
    """Log multivariate-t density (reference: src/stats/mvt.cpp dmvt)."""
    return logpdf_mvt_chol(x, mean, jnp.linalg.cholesky(scale), nu)
