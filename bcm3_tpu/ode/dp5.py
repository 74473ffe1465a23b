"""Batched adaptive Dormand-Prince RK5(4) integrator in JAX.

JAX replacement for the reference explicit solver
(reference: src/odecommon/ODESolverDP5.{h,cpp}) and, for non-stiff
workloads, for the CVODE wrapper's role
(reference: src/odecommon/ODESolverCVODE.cpp). Design differences that
make it a good XLA program instead of a C++ port:

- static shapes everywhere: the caller supplies a sorted grid of *stop
  times* (observation times and dose/discontinuity events merged and
  padded); the solver scans over segments and adaptively steps inside
  each with `lax.while_loop`, so it vmaps over (chains x patients x ...)
  and compiles once;
- events are state-jump functions applied at segment boundaries —
  the equivalent of the reference's discontinuity callbacks
  (reference: src/odecommon/ODESolver.cpp:62-77) with the event times
  known in advance, which they are for PK dosing;
- failure is a value, not an exception: trajectories that exceed
  `max_steps` or go non-finite return NaN, which the likelihood maps to
  -inf (proposal rejection), mirroring the reference's soft-fail
  convention (reference: ODESolverCVODE.cpp:354-370).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Dormand-Prince 5(4) Butcher tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class DP5Result(NamedTuple):
    ys: jax.Array  # (S, n) solution at each stop time
    ok: jax.Array  # () bool — whole trajectory valid
    n_steps: jax.Array  # () int32 — total accepted+rejected steps


def _step(f, t, y, dt, args):
    """One embedded RK5(4) step. Returns (y5, err_vec)."""
    n = y.shape[0]
    ks = []
    for i in range(7):
        ti = t + _C[i] * dt
        yi = y
        for j in range(i):
            yi = yi + dt * _A[i, j] * ks[j]
        ks.append(f(ti, yi, args))
    k = jnp.stack(ks)  # (7, n)
    y5 = y + dt * jnp.tensordot(
        jnp.asarray(_B5, dtype=y.dtype), k, axes=1, precision=jax.lax.Precision.HIGHEST
    )
    y4 = y + dt * jnp.tensordot(
        jnp.asarray(_B4, dtype=y.dtype), k, axes=1, precision=jax.lax.Precision.HIGHEST
    )
    return y5, y5 - y4


def _integrate_segment(f, t0, t1, y0, dt0, args, rtol, atol, max_steps, min_dt=0.0):
    """Adaptively integrate from t0 to t1 (t1 >= t0). Returns
    (y(t1), dt_next, steps_used, ok).

    ``max_steps`` may be a traced value (a remaining global budget).
    ``min_dt`` fails the trajectory as soon as the controller pushes the
    step below it — the vmapped analogue of the reference's min-step
    failure tracking (reference: ODESolverCVODE.cpp min_step guard,
    Cell.h:35 cvode_min_timestep_reached): one stiff-corner lane must
    fail fast instead of serializing the whole batch at the while_loop.
    """

    def cond(carry):
        t, y, dt, steps, ok = carry
        return (t < t1) & ok & (steps < max_steps)

    def body(carry):
        t, y, dt, steps, ok = carry
        dt_clip = jnp.minimum(dt, t1 - t)
        y5, err = _step(f, t, y, dt_clip, args)
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y5))
        err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
        accept = err_norm <= 1.0
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR
        )
        new_dt = dt_clip * factor
        t = jnp.where(accept, t + dt_clip, t)
        y = jnp.where(accept, y5, y)
        ok = ok & jnp.all(jnp.isfinite(y)) & (new_dt > min_dt)
        return (t, y, new_dt, steps + 1, ok)

    t, y, dt, steps, ok = jax.lax.while_loop(
        cond, body, (t0, y0, jnp.maximum(dt0, 1e-12), jnp.int32(0), jnp.asarray(True))
    )
    ok = ok & (steps < max_steps) | (t >= t1)
    ok = ok & jnp.all(jnp.isfinite(y))
    return y, dt, steps, ok


def _integrate_segment_fori(f, t0, t1, y0, dt0, args, rtol, atol, trips, min_dt=0.0):
    """Fixed-trip-count variant of `_integrate_segment`: the same adaptive
    step controller, but run for a static number of trips with finished
    lanes masked to no-ops, instead of a data-dependent `lax.while_loop`.

    Identical results to the while_loop version whenever `trips` covers the
    steps a lane actually needs (the controller state evolves identically;
    extra trips are masked out); lanes that would need more than `trips`
    steps fail (ok=False -> NaN -> -inf), which is the reference's
    max-steps soft-fail (ODESolverCVODE.cpp:322-445).

    Why it exists: under vmap a while_loop runs every lane until the LAST
    lane converges, and a masked while_loop inside a sampling scan
    evaluates its predicate on every trip; a static trip count bounds
    the adaptive work instead.
    """

    def body(i, carry):
        t, y, dt, steps, ok = carry
        active = (t < t1) & ok
        dt_clip = jnp.minimum(dt, t1 - t)
        y5, err = _step(f, t, y, dt_clip, args)
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y5))
        err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
        accept = (err_norm <= 1.0) & active
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR
        )
        new_dt = jnp.where(active, dt_clip * factor, dt)
        t = jnp.where(accept, t + dt_clip, t)
        y = jnp.where(accept, y5, y)
        ok = ok & (
            ~active | (jnp.all(jnp.isfinite(y)) & (new_dt > min_dt))
        )
        return (t, y, new_dt, steps + active.astype(jnp.int32), ok)

    t, y, dt, steps, ok = jax.lax.fori_loop(
        0, trips, body, (t0, y0, jnp.maximum(dt0, 1e-12), jnp.int32(0), jnp.asarray(True))
    )
    ok = ok & (t >= t1) & jnp.all(jnp.isfinite(y))
    return y, dt, steps, ok


def solve_at_times(
    f: Callable,
    y0,
    stop_times,
    args=None,
    event_fn: Optional[Callable] = None,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps_per_segment: int = 2000,
    first_dt: float = 1e-2,
    max_steps_total: Optional[int] = None,
    min_dt: float = 0.0,
    fixed_trips: Optional[int] = None,
) -> DP5Result:
    """Integrate y' = f(t, y, args) across a sorted grid of stop times.

    stop_times: (S,) increasing, starting at the initial time (ys[0] = y0
    after the first event application). Repeated times are allowed
    (zero-length segments). ``event_fn(i, t, y, args) -> y`` is applied at
    every stop time (identity by default) AFTER recording ys[i]; it
    implements dose additions / phase switches.

    ``max_steps_total`` bounds the whole-trajectory step count (the
    reference's per-Solve max-steps guard, ODESolverCVODE.cpp:322-445);
    without it a single stiff-corner parameter draw can cost
    S * max_steps_per_segment steps and, under vmap, serialize every
    other lane in the batch. ``min_dt`` fails a trajectory whose step
    size collapses below it (reference: min-step failure tracking).
    Both failures produce NaN -> -inf -> proposal rejection, the
    reference's soft-fail convention.
    """
    S = stop_times.shape[0]
    dtype = y0.dtype

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
                f, t, t_next, y, dt, args, rtol, atol, fixed_trips, min_dt
            )
        else:
            if max_steps_total is None:
                seg_budget = max_steps_per_segment
            else:
                seg_budget = jnp.minimum(
                    jnp.int32(max_steps_per_segment),
                    jnp.int32(max_steps_total) - total_steps,
                )
            y_new, dt_new, steps, seg_ok = _integrate_segment(
                f, t, t_next, y, dt, args, rtol, atol, seg_budget, min_dt
            )
        # zero-length segment: passthrough
        y_new = jnp.where(seg_len > 0, y_new, y)
        seg_ok = jnp.where(seg_len > 0, seg_ok, True)
        ok = ok & seg_ok
        y_rec = jnp.where(ok, y_new, jnp.full_like(y_new, jnp.nan))
        y_after = event(i, t_next, y_new)
        return (t_next, y_after, dt_new, total_steps + steps, ok), y_rec

    t0 = stop_times[0]
    y_init = event(0, t0, y0)
    init = (t0, y_init, jnp.asarray(first_dt, dtype), jnp.int32(0), jnp.asarray(True))
    (tF, yF, dtF, total_steps, ok), ys = jax.lax.scan(
        scan_body, init, jnp.arange(1, S)
    )
    ys = jnp.concatenate([y0[None, :], ys], axis=0)
    return DP5Result(ys=ys, ok=ok, n_steps=total_steps)


def solve_at_times_budget(
    f: Callable,
    y0,
    stop_times,
    args=None,
    event_fn: Optional[Callable] = None,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    total_trips: int = 768,
    first_dt: float = 1e-2,
    min_dt: float = 0.0,
    record: Optional[Callable] = None,
) -> DP5Result:
    """`solve_at_times` with a single whole-trajectory step budget.

    Same contract as `solve_at_times` (sorted stop-time grid, `event_fn`
    applied at each stop after recording), but structured as ONE static
    `lax.fori_loop` of `total_trips` adaptive steps with a stop-time
    pointer carried per lane, instead of scan-over-segments x
    bounded-loop-per-segment. Two wins for batched execution:

    - work is bounded by what the trajectory actually needs (a tight
      whole-trajectory budget) rather than segments x per-segment budget,
      so masked no-op trips are rare instead of the common case;
    - the step size is PRESERVED across stop-time boundaries: a step
      clipped to land exactly on a stop keeps the controller's dt for the
      next segment instead of collapsing to the clipped sliver (the
      reference gets this from CVODE's one-step mode + dense output,
      ODESolverCVODE.cpp:322-445 — it never shrinks steps to hit outputs).

    Lanes that exhaust the budget fail (NaN -> -inf -> rejection), the
    reference's max-steps soft-fail convention.

    ``record``: optional ``y -> recorded`` projection applied to the
    state before storing it at each stop. The per-trip masked write of
    the recorded buffer is the loop's main memory traffic (the rest of
    the carry lives in registers), so recording only what the caller
    scores (e.g. one compartment) directly raises the HBM-bound
    throughput ceiling of large batched solves.
    """
    S = stop_times.shape[0]
    dtype = y0.dtype
    if record is None:
        record = lambda y: y

    def event(i, t, y):
        if event_fn is None:
            return y
        return event_fn(i, t, y, args)

    t0 = stop_times[0]
    rec0 = record(y0)
    ys0 = (
        jnp.full((S,) + rec0.shape, jnp.nan, dtype=dtype).at[0].set(rec0)
    )
    y_init = event(0, t0, y0)
    iota_s = jnp.arange(S, dtype=jnp.int32)

    def body(_i, carry):
        t, y, dt, seg, ys, ok = carry
        seg_c = jnp.minimum(seg, S - 1)
        # one-hot gather/scatter instead of per-lane dynamic indexing:
        # under vmap, dynamic_slice/dynamic_update_slice with traced
        # per-lane indices lowers to gathers and scatters; a masked
        # select over the S axis stays fully vectorized
        onehot = iota_s == seg_c
        t1 = jnp.sum(jnp.where(onehot, stop_times, 0.0))
        active = (seg < S) & ok
        remaining = jnp.maximum(t1 - t, 0.0)
        clipped = dt >= remaining
        dt_step = jnp.minimum(dt, remaining)
        y5, err = _step(f, t, y, dt_step, args)
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y5))
        err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
        # zero-length remainder (repeated stop times): trivially accepted
        err_norm = jnp.where(remaining > 0, err_norm, 0.0)
        accept = (err_norm <= 1.0) & active
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR
        )
        # keep the controller's dt across clipped stop-time landings
        new_dt = jnp.where(
            active, jnp.where(clipped & accept, dt, dt_step * factor), dt
        )
        # snap clipped landings exactly onto the stop time (floating-point
        # t + (t1-t) can undershoot t1 and spin on sliver steps)
        t_new = jnp.where(accept, jnp.where(clipped, t1, t + dt_step), t)
        y_new = jnp.where(accept, y5, y)
        reached = accept & (t_new >= t1)
        # record the state at the stop (one-hot masked write), then apply
        # the event jump
        rec = record(y_new)
        mask = (onehot & reached).reshape((S,) + (1,) * rec.ndim)
        ys = jnp.where(mask, rec[None], ys)
        y_after = event(seg_c, t1, y_new)
        y_new = jnp.where(reached, y_after, y_new)
        seg = seg + reached.astype(jnp.int32)
        ok = ok & (
            ~active
            | (jnp.all(jnp.isfinite(y_new)) & (new_dt > min_dt))
        )
        return (t_new, y_new, new_dt, seg, ys, ok)

    init = (
        t0,
        y_init,
        jnp.asarray(first_dt, dtype),
        jnp.int32(1),
        ys0,
        jnp.asarray(True),
    )
    t, y, dt, seg, ys, ok = jax.lax.fori_loop(0, total_trips, body, init)
    ok = ok & (seg >= S)
    ys = jnp.where(ok, ys, jnp.full_like(ys, jnp.nan))
    return DP5Result(ys=ys, ok=ok, n_steps=jnp.int32(total_trips))
