"""Whole-trajectory step-budget integrators (ode/dp5.py, ode/rosenbrock.py).

These are the batched-device lowering of adaptive integration under the
sampler (static fori trip counts instead of data-dependent while loops;
see the module docstrings for measurements). The tests pin:
- agreement with the scan-over-segments adaptive solvers,
- event application at stop times (dose jumps),
- budget-exhaustion soft-fail (NaN, ok=False — the reference's
  max-steps convention, ODESolverCVODE.cpp:322-445),
- dt preservation across clipped stop-time landings.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.ode.dp5 import solve_at_times, solve_at_times_budget
from bcm3_tpu.ode.rosenbrock import (
    solve_at_times_stiff,
    solve_at_times_stiff_budget,
)


def _decay(t, y, args):
    return -args * y


def test_dp5_budget_matches_scan_solver():
    ts = jnp.linspace(0.0, 5.0, 21)
    y0 = jnp.asarray([1.0, 2.0])
    r1 = solve_at_times(_decay, y0, ts, args=0.8, rtol=1e-8, atol=1e-10)
    r2 = solve_at_times_budget(
        _decay, y0, ts, args=0.8, rtol=1e-8, atol=1e-10, total_trips=400
    )
    assert bool(r1.ok) and bool(r2.ok)
    np.testing.assert_allclose(r2.ys, r1.ys, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(
        r2.ys, np.asarray(y0)[None, :] * np.exp(-0.8 * np.asarray(ts))[:, None],
        rtol=1e-6,
    )


def test_dp5_budget_events_fire():
    ts = jnp.asarray([0.0, 1.0, 2.0, 3.0])

    def event(i, t, y, args):
        # add a bolus of 1.0 at every stop after recording
        return y + 1.0

    r = solve_at_times_budget(
        _decay,
        jnp.asarray([1.0]),
        ts,
        args=0.0,
        event_fn=event,
        total_trips=64,
    )
    assert bool(r.ok)
    # zero decay: y grows by exactly 1 per stop; ys records BEFORE events
    np.testing.assert_allclose(np.asarray(r.ys)[:, 0], [1.0, 2.0, 3.0, 4.0])


def test_dp5_budget_exhaustion_soft_fails():
    ts = jnp.linspace(0.0, 10.0, 5)
    r = solve_at_times_budget(
        _decay, jnp.asarray([1.0]), ts, args=50.0, rtol=1e-10, atol=1e-12,
        total_trips=6,
    )
    assert not bool(r.ok)
    assert np.isnan(np.asarray(r.ys)[1:]).all()


def test_dp5_budget_preserves_dt_across_stops():
    """A dense stop grid on a smooth problem must not starve the step
    size: with dt preserved across clipped landings, the budget form
    needs barely more trips than stops."""
    ts = jnp.linspace(0.0, 5.0, 101)  # 100 segments
    r = solve_at_times_budget(
        _decay, jnp.asarray([1.0]), ts, args=0.3, rtol=1e-6, atol=1e-9,
        total_trips=130,  # ~1.3 trips per stop
    )
    assert bool(r.ok)
    np.testing.assert_allclose(
        np.asarray(r.ys)[:, 0], np.exp(-0.3 * np.asarray(ts)), rtol=1e-5
    )


def _stiff(t, y, args):
    return jnp.stack([-1000.0 * y[0] + y[1], -0.5 * y[1]])


def test_stiff_budget_matches_while_solver():
    ts = jnp.linspace(0.0, 2.0, 9)
    y0 = jnp.asarray([1.0, 1.0])
    r1 = solve_at_times_stiff(_stiff, y0, ts, rtol=1e-6, atol=1e-9)
    r2 = solve_at_times_stiff_budget(
        _stiff, y0, ts, rtol=1e-6, atol=1e-9, total_trips=512
    )
    assert bool(r1.ok) and bool(r2.ok)
    np.testing.assert_allclose(r2.ys, r1.ys, rtol=1e-4, atol=1e-8)


def test_stiff_budget_vmaps():
    ts = jnp.linspace(0.0, 2.0, 9)
    y0 = jnp.asarray([1.0, 1.0])

    def solve(scale):
        def f(t, y, args):
            return jnp.stack([-scale * y[0] + y[1], -0.5 * y[1]])

        return solve_at_times_stiff_budget(
            f, y0, ts, rtol=1e-6, atol=1e-9, total_trips=512
        ).ys[-1]

    out = jax.jit(jax.vmap(solve))(jnp.asarray([100.0, 1000.0, 5000.0]))
    assert np.isfinite(np.asarray(out)).all()


def test_small_lu_pivoting():
    from bcm3_tpu.ode.rosenbrock import _small_lu, _small_solve

    rng = np.random.default_rng(1)
    for n in (2, 3, 4, 6, 8):
        A = rng.normal(size=(n, n))
        A[0, 0] = 0.0  # force a pivot
        b = rng.normal(size=n)
        LU, perms = _small_lu(jnp.asarray(A))
        x = np.asarray(_small_solve(LU, perms, jnp.asarray(b)))
        np.testing.assert_allclose(A @ x, b, atol=1e-9)
