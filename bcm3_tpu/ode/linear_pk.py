"""Exact closed-form propagators for linear compartment PK models.

JAX replacement for CVODE integration of the PopPK structural
models (reference: src/likelihoods/LikelihoodPopPKTrajectory.cpp:446-575
derivative/Jacobian pairs, integrated one CVODE step at a time in
src/odecommon/ODESolverCVODE.cpp:322-445). The insight: between dosing
events these systems are linear time-invariant, so the solution over a
segment is a matrix exponential — and for the 2/3-state compartment
structures it has an elementary closed form. One likelihood evaluation
becomes a short `lax.scan` over dosing intervals plus one vectorized
gather/propagate for all observation times: no adaptive stepping, no
Newton iterations, exact to machine precision, and trivially vmappable
over (chains x patients) so the whole population fills the VPU.

State layout matches the reference: y = [gut, central, peripheral].

    gut'        = -(ka + ke) * gut
    central'    = ka * gut - kel * central            (one-compartment)
    central'    = ka * gut - (kel + kpf) * central + kpb * peripheral
    peripheral' = kpf * central - kpb * peripheral    (two-compartment)

Closed forms: the gut decays as exp(-a t); the central/peripheral block
is a 2x2 linear system with exponential forcing, solved by the
Lagrange-Sylvester 2x2 matrix exponential plus a particular solution
u * exp(-a t) with (A22 + a I) u = -b0.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def _expm_ratio(a, kel, dt):
    """(exp(-kel dt) - exp(-a dt)) / (a - kel) with a -> kel guard."""
    d = a - kel
    safe_d = jnp.where(jnp.abs(d) < _EPS, _EPS, d)
    general = (jnp.exp(-kel * dt) - jnp.exp(-a * dt)) / safe_d
    # limit a -> kel: dt * exp(-kel dt)
    limit = dt * jnp.exp(-kel * dt)
    return jnp.where(jnp.abs(d) < _EPS, limit, general)


def propagate_one_compartment(y, dt, ka, ke, kel):
    """Exact solution of the one-compartment model over dt.

    y: (..., 2) [gut, central]. Supports broadcasting over leading axes.
    """
    a = ka + ke
    gut = y[..., 0] * jnp.exp(-a * dt)
    central = y[..., 1] * jnp.exp(-kel * dt) + ka * y[..., 0] * _expm_ratio(
        a, kel, dt
    )
    return jnp.stack([gut, central], axis=-1)


def _expm_2x2(m00, m01, m10, m11, dt):
    """exp(dt * [[m00, m01], [m10, m11]]) for real-eigenvalue 2x2 systems
    via Lagrange-Sylvester interpolation. Returns the 4 entries."""
    tr = m00 + m11
    det = m00 * m11 - m01 * m10
    disc = tr * tr - 4.0 * det
    # compartment systems have real spectra; clamp tiny negatives from rounding
    sq = jnp.sqrt(jnp.maximum(disc, _EPS * _EPS))
    l1 = 0.5 * (tr + sq)
    l2 = 0.5 * (tr - sq)
    e1 = jnp.exp(l1 * dt)
    e2 = jnp.exp(l2 * dt)
    denom = jnp.where(jnp.abs(l1 - l2) < _EPS, _EPS, l1 - l2)
    # exp(A dt) = (e1 (A - l2 I) - e2 (A - l1 I)) / (l1 - l2)
    c1 = (e1 - e2) / denom
    c0 = (l1 * e2 - l2 * e1) / denom
    return (
        c0 + c1 * m00,
        c1 * m01,
        c1 * m10,
        c0 + c1 * m11,
    )


def propagate_two_compartment(y, dt, ka, ke, kel, kpf, kpb):
    """Exact solution of the two-compartment model over dt.

    y: (..., 3) [gut, central, peripheral].
    """
    a = ka + ke
    gut0 = y[..., 0]
    gut = gut0 * jnp.exp(-a * dt)

    # central/peripheral block: z' = A z + b0 exp(-a t), b0 = ka*gut0*e1
    m00, m01 = -(kel + kpf), kpb
    m10, m11 = kpf, -kpb

    # particular solution u: (A + a I) u = -b0
    p00, p11 = m00 + a, m11 + a
    det_p = p00 * p11 - m01 * m10
    det_p = jnp.where(jnp.abs(det_p) < _EPS, _EPS, det_p)
    b0 = ka * gut0
    # u = -(A + aI)^{-1} [b0, 0]^T
    u1 = -(p11 * b0) / det_p
    u2 = -(-m10 * b0) / det_p

    e00, e01, e10, e11 = _expm_2x2(m00, m01, m10, m11, dt)
    h1 = y[..., 1] - u1
    h2 = y[..., 2] - u2
    decay = jnp.exp(-a * dt)
    central = e00 * h1 + e01 * h2 + u1 * decay
    peripheral = e10 * h1 + e11 * h2 + u2 * decay
    return jnp.stack([gut, central, peripheral], axis=-1)


def _mm(A, B, n):
    """Unrolled f32-exact (n, n) @ (n, n): explicit multiply-add instead
    of jnp.matmul, which for tiny n inside vmapped programs lowers to
    batched dots of no use to any matrix unit."""
    rows = []
    for i in range(n):
        row = []
        for j in range(n):
            acc = A[i, 0] * B[0, j]
            for k in range(1, n):
                acc = acc + A[i, k] * B[k, j]
            row.append(acc)
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def small_expm(A, max_squarings: int = 12):
    """exp(A) for small static n via Pade-6 scaling-and-squaring with
    fully unrolled matrix ops for the pharmaco dosing-interval
    propagators (reference algorithm choice: PharmacokineticModel.cpp:146
    uses Eigen MatrixFunctions exp()).

    Unlike the generic jax.scipy.linalg.expm (Pade-13 + linalg.solve
    custom calls + dynamic squaring), this form is straight-line batched
    vector code. The Pade denominator q = I - U + V has
    ||A_scaled|| <= 0.5, making q strictly diagonally dominant, so the
    unrolled no-pivot LU solve is numerically safe."""
    n = A.shape[-1]
    dtype = A.dtype
    # scaling: s = ceil(log2(norm / 0.5)) masked squarings
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=-1))
    s = jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-30) / 0.5))
    s = jnp.clip(s, 0, max_squarings).astype(jnp.int32)
    As = A * jnp.exp2(-s.astype(dtype))

    c = (1.0, 0.5, 3.0 / 26.0, 5.0 / 312.0, 5.0 / 3432.0, 1.0 / 11440.0,
         1.0 / 308880.0)
    eye = jnp.eye(n, dtype=dtype)
    A2 = _mm(As, As, n)
    A4 = _mm(A2, A2, n)
    A6 = _mm(A4, A2, n)
    W = c[1] * eye + c[3] * A2 + c[5] * A4
    V = c[0] * eye + c[2] * A2 + c[4] * A4 + c[6] * A6
    U = _mm(As, W, n)
    p = V + U
    q = V - U
    # unrolled no-pivot LU solve: E = q^{ -1 } p (q diagonally dominant)
    q = [[q[i, j] for j in range(n)] for i in range(n)]
    p = [[p[i, j] for j in range(n)] for i in range(n)]
    for k in range(n):
        inv = 1.0 / q[k][k]
        for j in range(k + 1, n):
            q[k][j] = q[k][j] * inv
        for j in range(n):
            p[k][j] = p[k][j] * inv
        for i in range(k + 1, n):
            f = q[i][k]
            for j in range(k + 1, n):
                q[i][j] = q[i][j] - f * q[k][j]
            for j in range(n):
                p[i][j] = p[i][j] - f * p[k][j]
    for k in range(n - 1, -1, -1):
        for i in range(k):
            f = q[i][k]
            for j in range(n):
                p[i][j] = p[i][j] - f * p[k][j]
    E = jnp.stack([jnp.stack(row) for row in p])

    # masked fixed-count squaring (s is data-dependent; trip count static)
    def body(i, Ei):
        sq = _mm(Ei, Ei, n)
        return jnp.where(i < s, sq, Ei)

    import jax as _jax

    return _jax.lax.fori_loop(0, max_squarings, body, E)


def propagate(y, dt, ka, ke, kel, kpf=None, kpb=None):
    """Dispatch on state size (2 -> one-compartment, 3 -> two-compartment)."""
    if y.shape[-1] == 2:
        return propagate_one_compartment(y, dt, ka, ke, kel)
    return propagate_two_compartment(y, dt, ka, ke, kel, kpf, kpb)


def propagate_biphasic(y, dt, switch_offset, ka1, ka2, ke, kel, kpf=None, kpb=None):
    """Propagate over a window [0, dt] whose absorption rate switches from
    ka1 to ka2 at ``switch_offset`` (clamped into [0, dt]).

    Implements the biphasic-uptake models
    (reference: LikelihoodPopPKTrajectory.cpp:496-575, TreatmentCallbackBiphasic).
    """
    s = jnp.clip(switch_offset, 0.0, dt)
    if y.shape[-1] == 2:
        y_mid = propagate_one_compartment(y, s, ka1, ke, kel)
        return propagate_one_compartment(y_mid, dt - s, ka2, ke, kel)
    y_mid = propagate_two_compartment(y, s, ka1, ke, kel, kpf, kpb)
    return propagate_two_compartment(y_mid, dt - s, ka2, ke, kel, kpf, kpb)
