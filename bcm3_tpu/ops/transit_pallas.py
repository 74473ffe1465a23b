"""Fused Pallas kernel (Triton route) for the transit-model budget DP5 solve.

The transit-compartment PopPK likelihood integrates every
(chain, patient) lane through a merged stop-time grid with the budgeted
DP5 solver (bcm3_tpu/ode/dp5.py solve_at_times_budget; reference hot
loop: src/odecommon/ODESolverCVODE.cpp:322-445 via
LikelihoodPopPKTrajectory.cpp:259-444). In XLA's lowering each of the
`trips` adaptive steps is a separate trip of a device loop, and every trip
rewrites the (S, state) recorded-stop buffer of every lane in device
memory.

This kernel runs the whole trip loop inside one program per block of
lanes. Each block holds `32 * num_warps` lanes, one lane per thread:

- the lane's stop grid and dose amounts are loaded from device memory once,
  before the loop, and stay in registers;
- the integrator state and the recorded central-compartment value at each
  stop live in registers for all trips;
- the record is written to device memory once, after the last trip.

Inputs are laid out stop-major, (S, L), so the row loads and the final
row stores are coalesced across the lanes of a block. The kernel computes
in float32 only; callers with other dtypes use the XLA path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Dormand-Prince 5(4) tableau (same constants as ode/dp5.py)
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
# the XLA path's error norm is the RMS over the augmented state
# [gut, central, last_treatment, dose]; the last two never change inside a
# step, so their error terms are zero and the mean divides by 4
_N_AUG = 4.0

NUM_WARPS = 4
BLOCK_LANES = 32 * NUM_WARPS


def _kernel(S, trips, rtol, atol, min_dt, first_dt,
            ka_ref, ke_ref, kel_ref, kt_ref, nt_ref, dose0_ref,
            grid_ref, amt_ref, out_ref, ok_ref):
    ka = ka_ref[...]
    ke = ke_ref[...]
    kel = kel_ref[...]
    k_transit = kt_ref[...]
    n_transit = nt_ref[...]
    dose0 = dose0_ref[...]
    dtype = ka.dtype
    zero = jnp.zeros_like(ka)
    nan = jnp.full_like(ka, jnp.nan)

    # Erlang log-normalizer (Stirling), loop-invariant
    log_nfac = (
        0.9189385332046727
        + (n_transit + 0.5) * jnp.log(n_transit)
        - n_transit
        + jnp.log(1.0 + 1.0 / (12.0 * n_transit))
    )

    def deriv(t, gut, cen, lt, dose):
        ts = jnp.maximum(t - lt, 0.0)
        log_t = jnp.log(jnp.maximum(k_transit * ts, 1e-30))
        transit = jnp.exp(n_transit * log_t - k_transit * ts - log_nfac)
        dgut = k_transit * transit * dose - (ka + ke) * gut
        dcen = ka * gut - kel * cen
        return dgut, dcen

    # read once per lane; kept in registers for the whole trip loop
    grid = [grid_ref[s, :] for s in range(S)]
    amts = [amt_ref[s, :] for s in range(S)]

    def body(_i, carry):
        # seg: index of the stop being integrated towards; S once every
        # stop is reached, S + 1 once the lane has failed
        t, gut, cen, lt, dose, dt, seg, *rec = carry
        active = seg < S
        hit = [seg == s for s in range(S)]
        t1 = zero
        amt = zero
        for s in range(S):
            t1 = jnp.where(hit[s], grid[s], t1)
            amt = jnp.where(hit[s], amts[s], amt)
        remaining = jnp.maximum(t1 - t, 0.0)
        clipped = dt >= remaining
        h = jnp.minimum(dt, remaining)

        # 7-stage embedded RK5(4)
        kg, kc = [], []
        for i in range(7):
            gi, ci = gut, cen
            for j in range(i):
                a = float(_A[i, j])  # python float: no x64 promotion
                if a != 0.0:
                    gi = gi + h * a * kg[j]
                    ci = ci + h * a * kc[j]
            dg, dc = deriv(t + float(_C[i]) * h, gi, ci, lt, dose)
            kg.append(dg)
            kc.append(dc)
        g5, c5, eg, ec = gut, cen, zero, zero
        for i in range(7):
            if _B5[i] != 0.0:
                g5 = g5 + h * float(_B5[i]) * kg[i]
                c5 = c5 + h * float(_B5[i]) * kc[i]
            diff = float(_B5[i] - _B4[i])
            if diff != 0.0:
                eg = eg + h * diff * kg[i]
                ec = ec + h * diff * kc[i]

        sc_g = atol + rtol * jnp.maximum(jnp.abs(gut), jnp.abs(g5))
        sc_c = atol + rtol * jnp.maximum(jnp.abs(cen), jnp.abs(c5))
        err_norm = jnp.sqrt(((eg / sc_g) ** 2 + (ec / sc_c) ** 2) / _N_AUG)
        err_norm = jnp.where(remaining > 0, err_norm, 0.0)
        accept = (err_norm <= 1.0) & active
        factor = jnp.clip(
            _SAFETY * (err_norm + 1e-30) ** -0.2, _MIN_FACTOR, _MAX_FACTOR
        )
        new_dt = jnp.where(active, jnp.where(clipped & accept, dt, h * factor), dt)
        t_new = jnp.where(accept, jnp.where(clipped, t1, t + h), t)
        gut = jnp.where(accept, g5, gut)
        cen = jnp.where(accept, c5, cen)
        reached = accept & (t_new >= t1)
        rec = [jnp.where(reached & hit[s], cen, rec[s]) for s in range(S)]

        # dose event: last_treatment <- t1 when an amount is given
        fire = reached & (amt > 0)
        lt = jnp.where(fire, t1, lt)
        dose = jnp.where(fire, amt, dose)

        finite = jnp.isfinite(gut) & jnp.isfinite(cen) & (new_dt > min_dt)
        seg = jnp.where(
            active & ~finite, S + 1, seg + reached.astype(jnp.int32)
        )
        return (t_new, gut, cen, lt, dose, new_dt, seg, *rec)

    init = (
        grid[0],
        zero,
        zero,
        zero,  # last_treatment = 0 (initial dose at t=0)
        dose0,
        jnp.full_like(ka, first_dt),
        jnp.ones(ka.shape, jnp.int32),
        zero,  # stop 0 records the initial state
        *([nan] * (S - 1)),
    )
    _, _, _, _, _, _, seg, *rec = jax.lax.fori_loop(0, trips, body, init)
    ok = seg == S
    ok_ref[...] = ok.astype(jnp.int32)
    for s in range(S):
        out_ref[s, :] = jnp.where(ok, rec[s], nan).astype(dtype)


@functools.partial(
    jax.jit,
    static_argnames=("trips", "rtol", "atol", "min_dt", "first_dt", "interpret"),
)
def _solve_call(ka, ke, kel, kt, nt, dose0, grid, amt,
                trips, rtol, atol, min_dt, first_dt, interpret):
    S, L = grid.shape
    lane_spec = pl.BlockSpec((BLOCK_LANES,), lambda i: (i,))
    stop_spec = pl.BlockSpec((S, BLOCK_LANES), lambda i: (0, i))
    return pl.pallas_call(
        functools.partial(_kernel, S, trips, rtol, atol, min_dt, first_dt),
        grid=(L // BLOCK_LANES,),
        in_specs=[lane_spec] * 6 + [stop_spec, stop_spec],
        out_specs=[stop_spec, lane_spec],
        out_shape=[
            jax.ShapeDtypeStruct((S, L), ka.dtype),
            jax.ShapeDtypeStruct((L,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="transit_dp5_budget",
    )(ka, ke, kel, kt, nt, dose0, grid, amt)


def transit_solve(
    params,  # dict of (L,) float32 arrays: ka, ke, kel, k_transit, n_transit, dose0
    grid,  # (S, L) float32 stop times, stop-major
    dose_amt,  # (S, L) float32 dose amounts (0 where no dose is given)
    trips: int = 768,
    rtol: float = 1e-6,
    atol: float = 1e-4,
    min_dt: float = 1e-5,
    first_dt: float = 1e-2,
    interpret: bool = False,
):
    """Batched budget-DP5 transit solve. Returns (central (S, L), ok (L,)).

    Semantics identical to the solve_at_times_budget path in
    bcm3_tpu/likelihoods/poppk.py _simulate_transit (same tableau, error
    norm, controller and soft-fail convention); failed lanes are NaN.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU)."""
    S, L = grid.shape
    args = [params[k] for k in ("ka", "ke", "kel", "k_transit", "n_transit",
                                "dose0")] + [grid, dose_amt]
    for a in args:
        if a.dtype != jnp.float32:
            raise TypeError(f"transit kernel computes in float32, got {a.dtype}")
    pad = -L % BLOCK_LANES
    if pad:
        # padded lanes get benign values (log(n_transit) must be finite)
        # and are sliced off below
        args = [
            jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)], constant_values=1.0)
            for a in args
        ]
    central, ok = _solve_call(
        *args,
        trips=int(trips), rtol=float(rtol), atol=float(atol),
        min_dt=float(min_dt), first_dt=float(first_dt),
        interpret=bool(interpret),
    )
    return central[:, :L], ok[:L] == 1
