"""Batched L-stable Rosenbrock integrator for stiff systems.

JAX replacement for the reference's CVODE BDF wrapper on stiff
workloads (reference: src/odecommon/ODESolverCVODE.cpp). CVODE's
variable-order Nordsieck BDF with per-trajectory step control does not
vmap: its control flow is data-dependent in structure, not just in
values. A Rosenbrock-W method has *fixed structure* per step — one
Jacobian, one LU factorization, s linear solves — so the whole cell /
patient / chain population integrates in lockstep under `vmap`, with
the LU and triangular solves batched. Adaptivity (step
size) remains per-trajectory inside `lax.while_loop`.

Method: RODAS3 — 4 stages, order 3(2) embedded, L-stable, stiffly
accurate (Sandu et al., "Benchmarking stiff ODE solvers for atmospheric
chemistry problems II", Atmos. Environ. 31, 1997; the ros_Rodas3
tableau). The Jacobian is jax.jacfwd of the RHS — the role of the
reference's generated Jacobian code (SBMLModel.cpp GenerateJacobianCode)
or CVODE's difference quotients (ODESolverCVODE.cpp:485-520).

Failure semantics match the framework convention: step-limit overrun or
non-finite states yield NaN trajectories (-> -inf logp -> proposal
rejection), the batched analogue of CVODE's error return
(ODESolverCVODE.cpp:354-370).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import lu_factor, lu_solve

# RODAS3 tableau (KPP ros_Rodas3): 4 stages, order 3(2), L-stable
_GAMMA = 0.5
_ALPHA = np.array([0.0, 0.0, 1.0, 1.0])
_GAMMA_I = np.array([0.5, 1.5, 0.0, 0.0])
_A = np.zeros((4, 4))
_A[2, 0] = 2.0
_A[3, 0] = 2.0
_A[3, 2] = 1.0
_C = np.zeros((4, 4))
_C[1, 0] = 4.0
_C[2, 0] = 1.0
_C[2, 1] = -1.0
_C[3, 0] = 1.0
_C[3, 1] = -1.0
_C[3, 2] = -8.0 / 3.0
_M = np.array([2.0, 0.0, 1.0, 1.0])
_E = np.array([0.0, 0.0, 0.0, 1.0])
_ORDER = 3.0

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 6.0


class StiffResult(NamedTuple):
    ys: jax.Array  # (S, n)
    ok: jax.Array  # () bool
    n_steps: jax.Array  # () int32


def _small_lu(G):
    """Unrolled LU factorization with partial pivoting for small static n.

    The reference backs CVODE with Eigen's PartialPivLU
    (src/odecommon/LinearAlgebraSelector.h); XLA's generic `lu` lowering
    for tiny matrices inside vmapped loops is select/gather heavy, while
    this fully unrolled form (n is static and small — cell models have
    2-16 species) is straight-line vector code. Pivot swaps are masked
    row selects. Returns (LU combined, pivot one-hot masks)."""
    n = G.shape[0]
    idx = jnp.arange(n)
    A = G
    perms = []
    for k in range(n - 1):
        col = jnp.where(idx >= k, jnp.abs(A[:, k]), -jnp.inf)
        p = jnp.argmax(col)
        onehot_p = idx == p
        # swap rows k and p via masked selects
        row_p = jnp.sum(jnp.where(onehot_p[:, None], A, 0.0), axis=0)
        row_k = A[k]
        A = jnp.where((idx == k)[:, None], row_p[None, :], A)
        A = jnp.where(onehot_p[:, None], row_k[None, :], A)
        perms.append(onehot_p)
        below = idx > k
        factors = jnp.where(below, A[:, k] / A[k, k], 0.0)
        # update only columns >= k (columns < k hold stored multipliers)
        A = A - factors[:, None] * jnp.where(
            (idx >= k)[None, :], A[k][None, :], 0.0
        )
        # store the multipliers in the lower triangle (the elimination
        # zeroed the column below the diagonal exactly)
        A = A.at[:, k].set(jnp.where(below, factors, A[:, k]))
    return A, perms


def _small_solve(LU, perms, b):
    """Solve with the factors from `_small_lu` (unrolled)."""
    n = b.shape[0]
    idx = jnp.arange(n)
    x = b
    # apply row swaps in order
    for k, onehot_p in enumerate(perms):
        xk = x[k]
        xp = jnp.sum(jnp.where(onehot_p, x, 0.0))
        x = jnp.where(idx == k, xp, x)
        x = jnp.where(onehot_p, xk, x)
    # forward substitution (unit lower triangle holds multipliers).
    # explicit multiply+sum instead of jnp.dot: a reduced-precision dot
    # (bf16 or TF32 passes) would destroy the error controller's step
    # estimates in float32 runs
    for i in range(1, n):
        x = x.at[i].add(-jnp.sum(LU[i, :i] * x[:i]))
    # back substitution
    y = x
    for i in range(n - 1, -1, -1):
        s = y[i]
        if i + 1 < n:
            s = s - jnp.sum(LU[i, i + 1 :] * y[i + 1 :])
        y = y.at[i].set(s / LU[i, i])
    return y


def _rosenbrock_step(f, t, y, h, args, sparse=None):
    """One RODAS3 step. Returns (y_new, err_vec).

    ``sparse`` is an optional precompiled
    :class:`bcm3_tpu.ode.sparse_lu.SparseStageSolver` for the RHS's
    static Jacobian pattern: the stage matrix is then factored/solved
    over only the structurally nonzero entries (colored-JVP Jacobian,
    no-pivot fill-in LU) — the batched equivalent of the reference's
    sparsity-exploiting linear algebra
    (src/utils/EigenPartialPivLUSomewhatSparse.h:1-108,
    src/odecommon/LinearAlgebraSelector.h CVODE_USE_SPARSE_SOLVER)."""
    n = y.shape[0]
    # time derivative of f for non-autonomous systems
    ft = jax.jacfwd(lambda tt: f(tt, y, args))(t)

    if sparse is not None:
        inv_hg = 1.0 / (h * _GAMMA)
        f0, jac = sparse.jac_entries(lambda yy: f(t, yy, args), y)
        A = sparse.factor_G(jac, inv_hg)
        solve = lambda rhs: sparse.solve(A, rhs)
    else:
        eye = jnp.eye(n, dtype=y.dtype)
        J = jax.jacfwd(lambda yy: f(t, yy, args))(y)
        G = eye / (h * _GAMMA) - J
        import os as _os

        # unrolled-LU size cutoff: above it the generic jax.scipy
        # lu_factor lowering is used. Raiseable via BCM3_SMALL_LU_MAX
        small_max = int(_os.environ.get("BCM3_SMALL_LU_MAX", "16"))
        if n <= small_max and _os.environ.get("BCM3_SMALL_LU", "1") != "0":
            LU, perms = _small_lu(G)
            solve = lambda rhs: _small_solve(LU, perms, rhs)
        else:
            lu = lu_factor(G)
            solve = lambda rhs: lu_solve(lu, rhs)
        f0 = None

    ks = []
    for i in range(4):
        yi = y
        for j in range(i):
            yi = yi + _A[i, j] * ks[j]
        if i == 0 and f0 is not None:
            fi = f0  # stage 0 evaluates f at (t, y) = the linearization point
        else:
            fi = f(t + _ALPHA[i] * h, yi, args)
        rhs = fi + _GAMMA_I[i] * h * ft
        for j in range(i):
            rhs = rhs + (_C[i, j] / h) * ks[j]
        ks.append(solve(rhs))

    # unrolled stage combination (static coefficients; no
    # reduced-precision tensordot in float32 runs)
    y_new = y
    err = jnp.zeros_like(y)
    for i in range(4):
        if _M[i] != 0.0:
            y_new = y_new + _M[i] * ks[i]
        if _E[i] != 0.0:
            err = err + _E[i] * ks[i]
    return y_new, err


def _integrate_segment(f, t0, t1, y0, dt0, args, rtol, atol, max_steps,
                       sparse=None):
    def cond(carry):
        t, y, dt, steps, ok = carry
        return (t < t1) & ok & (steps < max_steps)

    def body(carry):
        t, y, dt, steps, ok = carry
        dt_clip = jnp.minimum(dt, t1 - t)
        y_new, err = _rosenbrock_step(f, t, y, dt_clip, args, sparse)
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
        err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
        err_norm = jnp.where(jnp.isfinite(err_norm), err_norm, jnp.inf)
        accept = err_norm <= 1.0
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** (-1.0 / _ORDER),
            _MIN_FACTOR,
            _MAX_FACTOR,
        )
        new_dt = dt_clip * factor
        t = jnp.where(accept, t + dt_clip, t)
        y = jnp.where(accept, y_new, y)
        ok = ok & (new_dt > 1e-14 * jnp.maximum(jnp.abs(t1), 1.0))
        ok = ok & jnp.all(jnp.isfinite(y))
        return (t, y, new_dt, steps + 1, ok)

    t, y, dt, steps, ok = jax.lax.while_loop(
        cond, body, (t0, y0, jnp.maximum(dt0, 1e-12), jnp.int32(0), jnp.asarray(True))
    )
    ok = (ok & (steps < max_steps)) | (t >= t1)
    ok = ok & jnp.all(jnp.isfinite(y))
    return y, dt, steps, ok


def _integrate_segment_fori(f, t0, t1, y0, dt0, args, rtol, atol, trips,
                            sparse=None):
    """Fixed-trip-count variant of `_integrate_segment` (see the DP5
    twin, ode/dp5.py:_integrate_segment_fori, for the rationale): same
    adaptive controller, static `lax.fori_loop` trip count, finished
    lanes masked to no-ops. Lanes needing more than `trips` steps fail
    (ok=False -> NaN -> -inf), the reference's max-steps soft-fail."""

    def body(i, carry):
        t, y, dt, steps, ok = carry
        active = (t < t1) & ok
        dt_clip = jnp.minimum(dt, t1 - t)
        y_new, err = _rosenbrock_step(f, t, y, dt_clip, args, sparse)
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
        err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
        err_norm = jnp.where(jnp.isfinite(err_norm), err_norm, jnp.inf)
        accept = (err_norm <= 1.0) & active
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** (-1.0 / _ORDER),
            _MIN_FACTOR,
            _MAX_FACTOR,
        )
        new_dt = jnp.where(active, dt_clip * factor, dt)
        t = jnp.where(accept, t + dt_clip, t)
        y = jnp.where(accept, y_new, y)
        ok = ok & (
            ~active
            | (
                jnp.all(jnp.isfinite(y))
                & (new_dt > 1e-14 * jnp.maximum(jnp.abs(t1), 1.0))
            )
        )
        return (t, y, new_dt, steps + active.astype(jnp.int32), ok)

    t, y, dt, steps, ok = jax.lax.fori_loop(
        0, trips, body, (t0, y0, jnp.maximum(dt0, 1e-12), jnp.int32(0), jnp.asarray(True))
    )
    ok = ok & (t >= t1) & jnp.all(jnp.isfinite(y))
    return y, dt, steps, ok


def solve_at_times_stiff(
    f: Callable,
    y0,
    stop_times,
    args=None,
    event_fn: Optional[Callable] = None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps_per_segment: int = 5000,
    first_dt: float = 1e-4,
    fixed_trips: Optional[int] = None,
    sparse=None,
) -> StiffResult:
    """Stiff counterpart of bcm3_tpu.ode.dp5.solve_at_times: integrate
    across a sorted grid of stop times, applying ``event_fn(i, t, y,
    args) -> y`` at each stop (dose additions / phase switches = the
    reference's discontinuity callbacks, ODESolver.cpp:62-77)."""
    S = stop_times.shape[0]

    def event(i, t, y):
        if event_fn is None:
            return y
        return event_fn(i, t, y, args)

    def scan_body(carry, i):
        t, y, dt, total_steps, ok = carry
        t_next = stop_times[i]
        seg_len = t_next - t
        if fixed_trips is not None:
            y_new, dt_new, steps, seg_ok = _integrate_segment_fori(
                f, t, t_next, y, dt, args, rtol, atol, fixed_trips,
                sparse=sparse,
            )
        else:
            y_new, dt_new, steps, seg_ok = _integrate_segment(
                f, t, t_next, y, dt, args, rtol, atol, max_steps_per_segment,
                sparse=sparse,
            )
        y_new = jnp.where(seg_len > 0, y_new, y)
        seg_ok = jnp.where(seg_len > 0, seg_ok, True)
        ok = ok & seg_ok
        y_rec = jnp.where(ok, y_new, jnp.full_like(y_new, jnp.nan))
        y_after = event(i, t_next, y_new)
        return (t_next, y_after, dt_new, total_steps + steps, ok), y_rec

    t0 = stop_times[0]
    y_init = event(0, t0, y0)
    init = (
        t0,
        y_init,
        jnp.asarray(first_dt, y0.dtype),
        jnp.int32(0),
        jnp.asarray(True),
    )
    (tF, yF, dtF, total_steps, ok), ys = jax.lax.scan(
        scan_body, init, jnp.arange(1, S)
    )
    ys = jnp.concatenate([y0[None, :], ys], axis=0)
    return StiffResult(ys=ys, ok=ok, n_steps=total_steps)


def solve_at_times_stiff_budget(
    f: Callable,
    y0,
    stop_times,
    args=None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    total_trips: int = 1024,
    first_dt: float = 1e-4,
    sparse=None,
) -> StiffResult:
    """Whole-trajectory step-budget form of `solve_at_times_stiff`.

    The stiff twin of `bcm3_tpu.ode.dp5.solve_at_times_budget`: ONE
    static `lax.fori_loop` of `total_trips` Rosenbrock steps with a
    stop-time pointer per lane and one-hot recording, instead of
    scan-over-segments x bounded-loop-per-segment. Stiff transients
    concentrate steps in a few segments, so a per-segment budget either
    starves them or wastes trips everywhere else; the global budget
    matches where the work actually is (see the DP5 twin). No event hook — cellpop-style solves only record at
    stop times (events are detected post-hoc from the trajectories).
    """
    S = stop_times.shape[0]
    dtype = y0.dtype
    n = y0.shape[0]
    iota_s = jnp.arange(S, dtype=jnp.int32)
    t0 = stop_times[0]
    ys0 = jnp.full((S, n), jnp.nan, dtype=dtype).at[0].set(y0)

    def body(_i, carry):
        t, y, dt, seg, ys, ok = carry
        seg_c = jnp.minimum(seg, S - 1)
        onehot = iota_s == seg_c
        t1 = jnp.sum(jnp.where(onehot, stop_times, 0.0))
        active = (seg < S) & ok
        remaining = jnp.maximum(t1 - t, 0.0)
        clipped = dt >= remaining
        # zero-length remainder: use a tiny step so G = I/(h*gamma) - J
        # stays finite; the step is then trivially accepted below
        dt_step = jnp.maximum(jnp.minimum(dt, remaining), 1e-30)
        y_new, err = _rosenbrock_step(f, t, y, dt_step, args, sparse)
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
        err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
        err_norm = jnp.where(jnp.isfinite(err_norm), err_norm, jnp.inf)
        err_norm = jnp.where(remaining > 0, err_norm, 0.0)
        y_new = jnp.where(remaining > 0, y_new, y)
        accept = (err_norm <= 1.0) & active
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** (-1.0 / _ORDER),
            _MIN_FACTOR,
            _MAX_FACTOR,
        )
        new_dt = jnp.where(
            active, jnp.where(clipped & accept, dt, dt_step * factor), dt
        )
        t_new = jnp.where(accept, jnp.where(clipped, t1, t + dt_step), t)
        y_new = jnp.where(accept, y_new, y)
        reached = accept & (t_new >= t1)
        ys = jnp.where((onehot & reached)[:, None], y_new[None, :], ys)
        seg = seg + reached.astype(jnp.int32)
        ok = ok & (
            ~active
            | (
                jnp.all(jnp.isfinite(y_new))
                & (new_dt > 1e-14 * jnp.maximum(jnp.abs(t1), 1.0))
            )
        )
        return (t_new, y_new, new_dt, seg, ys, ok)

    init = (
        t0,
        y0,
        jnp.asarray(first_dt, dtype),
        jnp.int32(1),
        ys0,
        jnp.asarray(True),
    )
    t, y, dt, seg, ys, ok = jax.lax.fori_loop(0, total_trips, body, init)
    ok = ok & (seg >= S)
    ys = jnp.where(ok, ys, jnp.full_like(ys, jnp.nan))
    return StiffResult(ys=ys, ok=ok, n_steps=jnp.int32(total_trips))
