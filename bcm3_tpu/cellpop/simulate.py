"""Batched heterogeneous cell-population simulator.

JAX re-design of the reference cell-population engine
(reference: src/cellpop/Experiment.cpp:635-846, Cell.cpp,
CellPopulation.cpp). The reference integrates one CVODE instance per
cell on a dynamically growing work queue serviced by auxiliary threads
(Experiment.cpp ParallelSimulation:691-779); division pushes two new
cells onto the queue. Here the population lives in a FIXED-CAPACITY
slot array and the whole simulation is one jit-compiled computation:

- `max_generations` rounds; in each round every slot integrates in
  lockstep through the vmapped DP5 or Rosenbrock solver over a shared
  cell-time grid (inactive slots integrate a masked dummy — the cost
  of a round is one batched solve, which is what fills a device);
- events (DNA replication start/finish, PCNA-gfp increase, nuclear
  envelope breakdown, anaphase onset, division, death) are detected as
  first grid-crossings with linear-interpolated crossing times — the
  batched analogue of the reference's integration-step callback with
  dense-output root finding (Cell.cpp integration_step_cb:463-538);
- children occupy deterministically allocated slots (slot-order
  first-fit, two per division, like the reference's AddNewCell order
  but independent of thread scheduling — the reference's order is
  thread-race dependent, CellPopulation.cpp:31-90);
- the Sobol variability index of a child is
  initial_cells + parent_index*2 + child_ix, exactly the reference's
  bookkeeping (CellPopulation.cpp:55-77).

Thresholds (reference: Cell.cpp:467-538): replicating_DNA > 1e-4,
replicated_DNA > 1.95, PCNA_gfp > 0.5, nuclear_envelope < 0.5,
chromatid_separation > 1e-3 (extends simulation by
simulate_past_chromatid_separation_time), cytokinesis > 1 (divide),
apoptosis > 1 (die). On division the daughters inherit the parent's
state with cytokinesis=0, nuclear_envelope=1, G1S_break=1, G2_break=1,
spindle_components=0, assembled_spindle=0, chromatid_separation=0
(Cell.cpp SetInitialConditionsFromOtherCell:120-148).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.ode.dp5 import solve_at_times
from bcm3_tpu.ode.rosenbrock import solve_at_times_stiff

# event slots in the event-times array
EV_REPLICATION_START = 0
EV_REPLICATION_FINISH = 1
EV_PCNA_GFP_INCREASE = 2
EV_NEBD = 3
EV_ANAPHASE_ONSET = 4
NUM_EVENTS = 5

_THRESHOLDS = {
    # event index -> (species key, threshold, crossing upward?)
    EV_REPLICATION_START: ("replicating_DNA", 1e-4, True),
    EV_REPLICATION_FINISH: ("replicated_DNA", 1.95, True),
    EV_PCNA_GFP_INCREASE: ("PCNA_gfp", 0.5, True),
    EV_NEBD: ("nuclear_envelope", 0.5, False),
    EV_ANAPHASE_ONSET: ("chromatid_separation", 1e-3, True),
}

# species reset on daughter cells (reference: Cell.cpp:126-133)
_DIVISION_RESETS = {
    "cytokinesis": 0.0,
    "nuclear_envelope": 1.0,
    "G1S_break": 1.0,
    "G2_break": 1.0,
    "spindle_components": 0.0,
    "assembled_spindle": 0.0,
    "chromatid_separation": 0.0,
}


@dataclass(frozen=True)
class PopulationConfig:
    """Static structure of a population simulation."""

    capacity: int  # max_number_of_cells
    initial_cells: int
    max_generations: int  # number of division rounds simulated
    divide_cells: bool = True
    event_species: Dict[str, int] = field(default_factory=dict)
    # ODE-species index of each named event species, -1 if absent
    division_reset_idx: tuple = ()  # ((species_ix, value), ...)
    solver: str = "DP5"  # "DP5" | "CVODE" (-> Rosenbrock)
    rtol: float = 1e-6
    atol: float = 1e-6
    max_steps: int = 10000
    # static per-segment adaptive-step budget: lowers the integrator to a
    # fixed-trip fori_loop (ode/dp5.py:_integrate_segment_fori) instead of
    # a masked while_loop
    solver_trips: int | None = None
    simulate_past_chromatid_separation_time: float = 0.0
    max_sobol_index: int = 0  # 0 = no variability iterator
    # precompiled SparseStageSolver for the model's static Jacobian
    # pattern (ode/sparse_lu.py) — replaces the dense stage LU in the
    # stiff solver (the reference's sparse linear-algebra path,
    # src/utils/EigenPartialPivLUSomewhatSparse.h); None = dense
    sparse: object = None

    @classmethod
    def from_model(cls, model, **kwargs) -> "PopulationConfig":
        """Resolve event/reset species indices from an SBMLModel."""
        ev = {}
        for _, (name, _thr, _up) in _THRESHOLDS.items():
            try:
                ev[name] = model.ode_species.index(name)
            except ValueError:
                ev[name] = -1
        for name in ("cytokinesis", "apoptosis"):
            try:
                ev[name] = model.ode_species.index(name)
            except ValueError:
                ev[name] = -1
        resets = []
        for name, value in _DIVISION_RESETS.items():
            if name in model.ode_species:
                resets.append((model.ode_species.index(name), value))
        return cls(event_species=ev, division_reset_idx=tuple(resets), **kwargs)


class PopulationResult(NamedTuple):
    traj: jax.Array  # (N, G, n) trajectories on the cell-time grid
    creation: jax.Array  # (N,) global creation times
    end_cell_time: jax.Array  # (N,) valid cell-time horizon per slot
    event_times: jax.Array  # (N, NUM_EVENTS) cell-time; NaN = never
    divided: jax.Array  # (N,) bool
    died: jax.Array  # (N,) bool
    division_time: jax.Array  # (N,) cell time of division (NaN = none)
    active: jax.Array  # (N,) bool — slot holds a real cell
    parent: jax.Array  # (N,) int32, -1 for initial cells
    sobol_index: jax.Array  # (N,) int32
    is_initial: jax.Array  # (N,) bool
    ok: jax.Array  # () bool — all active-cell integrations succeeded


def _first_crossing_time(grid, vals, threshold, upward):
    """Time of the first crossing of ``threshold`` on the grid, linearly
    interpolated; NaN if never crossed (the batched analogue of
    ODESolver::get_threshold_crossing_time)."""
    if upward:
        above = vals > threshold
    else:
        above = vals < threshold
    # first index where the condition holds (excluding t=0 state)
    idx = jnp.argmax(above)
    crossed = jnp.any(above)
    i = jnp.clip(idx, 1, grid.shape[0] - 1)
    v0 = vals[i - 1]
    v1 = vals[i]
    frac = jnp.where(v1 != v0, (threshold - v0) / (v1 - v0), 0.0)
    frac = jnp.clip(frac, 0.0, 1.0)
    t_cross = grid[i - 1] + frac * (grid[i] - grid[i - 1])
    # crossing at the very first sample: report the grid start
    t_cross = jnp.where(above[0], grid[0], t_cross)
    return jnp.where(crossed, t_cross, jnp.nan)


def interp_grid(grid, traj_row, t):
    """Linear interpolation of one cell's trajectory at cell time t."""
    return jnp.interp(t, grid, traj_row)


def simulate_population(
    cfg: PopulationConfig,
    rhs: Callable,  # f(t_cell, y, (cell_params, const_y, creation)) -> dydt
    initial_y: jax.Array,  # (N, n) initial states for INITIAL cells
    const_y: jax.Array,  # (N, nc)
    cell_params: jax.Array,  # (M, V) Sobol table: initial-cell params
    child_params: jax.Array,  # (M, V) Sobol table: daughter-cell params
    creation0: jax.Array,  # (N,) creation times (used for initial slots)
    grid: jax.Array,  # (G,) shared cell-time grid starting at 0
    target_time=None,  # global simulation end; default grid span
    child_ic_fn: Optional[Callable] = None,  # (y, sobol_ix) -> y
) -> PopulationResult:
    """Run the fixed-capacity population simulation.

    ``cell_params``/``child_params`` are Sobol-indexed tables (row i =
    the variability-applied parameter vector for Sobol index i); each
    slot gathers its row by its Sobol index — exactly the reference's
    per-cell pseudorandom bookkeeping (CellPopulation.cpp:55-83).
    ``child_ic_fn`` applies daughter-cell initial-condition variability
    to the inherited division state (Cell.cpp Initialize:150-177 with
    is_initial_cell=false).
    """
    N = cfg.capacity
    G = grid.shape[0]
    n = initial_y.shape[1]
    dtype = initial_y.dtype
    C0 = cfg.initial_cells

    solve = solve_at_times if cfg.solver == "DP5" else solve_at_times_stiff

    def integrate_one(y0, params, cy, creation):
        if cfg.solver_trips:
            # whole-trajectory step budget in a static fori_loop (stiff
            # transients concentrate steps in few segments, so the budget
            # is global)
            if cfg.solver == "DP5":
                from bcm3_tpu.ode.dp5 import solve_at_times_budget

                res = solve_at_times_budget(
                    rhs, y0, grid, args=(params, cy, creation),
                    rtol=cfg.rtol, atol=cfg.atol,
                    total_trips=cfg.solver_trips,
                )
            else:
                from bcm3_tpu.ode.rosenbrock import (
                    solve_at_times_stiff_budget,
                )

                res = solve_at_times_stiff_budget(
                    rhs, y0, grid, args=(params, cy, creation),
                    rtol=cfg.rtol, atol=cfg.atol,
                    total_trips=cfg.solver_trips,
                    sparse=cfg.sparse,
                )
            return res.ys, res.ok
        extra = {} if cfg.solver == "DP5" else {"sparse": cfg.sparse}
        res = solve(
            rhs,
            y0,
            grid,
            args=(params, cy, creation),
            rtol=cfg.rtol,
            atol=cfg.atol,
            max_steps_per_segment=cfg.max_steps,
            **extra,
        )
        return res.ys, res.ok

    ev = cfg.event_species

    def detect_events(traj_row):
        """Per-cell event extraction from a (G, n) trajectory."""
        times = jnp.full((NUM_EVENTS,), jnp.nan, dtype=dtype)
        for ev_ix, (name, thr, up) in _THRESHOLDS.items():
            six = ev.get(name, -1)
            if six >= 0:
                times = times.at[ev_ix].set(
                    _first_crossing_time(grid, traj_row[:, six], thr, up)
                )
        div_t = (
            _first_crossing_time(grid, traj_row[:, ev["cytokinesis"]], 1.0, True)
            if ev.get("cytokinesis", -1) >= 0 and cfg.divide_cells
            else jnp.asarray(jnp.nan, dtype=dtype)
        )
        death_t = (
            _first_crossing_time(grid, traj_row[:, ev["apoptosis"]], 1.0, True)
            if ev.get("apoptosis", -1) >= 0
            else jnp.asarray(jnp.nan, dtype=dtype)
        )
        return times, div_t, death_t

    span = grid[-1]
    if target_time is None:
        target_time = span

    # persistent slot state
    traj = jnp.full((N, G, n), jnp.nan, dtype=dtype)
    creation = jnp.asarray(creation0, dtype=dtype)
    end_cell_time = jnp.zeros((N,), dtype=dtype)
    event_times = jnp.full((N, NUM_EVENTS), jnp.nan, dtype=dtype)
    divided = jnp.zeros((N,), dtype=bool)
    died = jnp.zeros((N,), dtype=bool)
    division_time = jnp.full((N,), jnp.nan, dtype=dtype)
    active = jnp.arange(N) < C0
    parent = jnp.full((N,), -1, dtype=jnp.int32)
    sobol_index = jnp.where(
        jnp.arange(N) < C0, jnp.arange(N), 0
    ).astype(jnp.int32)
    is_initial = jnp.arange(N) < C0
    y_start = jnp.asarray(initial_y, dtype=dtype)
    newly_active = active
    ok = jnp.asarray(True)
    n_active = jnp.asarray(C0, dtype=jnp.int32)

    M = cell_params.shape[0]
    for _round in range(cfg.max_generations + 1):
        rows = jnp.clip(sobol_index, 0, M - 1)
        params_round = jnp.where(
            is_initial[:, None], cell_params[rows], child_params[rows]
        )

        # Skip the whole generation's integration at RUNTIME when no new
        # cells were spawned (lax.cond executes only the taken branch):
        # once the population hits capacity or stops dividing, the
        # remaining max_generations rounds cost one predicate each
        # instead of a full batched solve whose results would be
        # discarded by the `upd` masks below. The reference's work queue
        # gets this for free (no new work items, Experiment.cpp:691-779);
        # this is its fixed-capacity equivalent.
        def _run_round(ops):
            y0_, p_, cy_, cr_ = ops
            ys_, ok_ = jax.vmap(integrate_one)(y0_, p_, cy_, cr_)
            return ys_, ok_

        def _skip_round(ops):
            return (
                jnp.full((N, G, n), jnp.nan, dtype=dtype),
                jnp.zeros((N,), dtype=bool),
            )

        if _round == 0:
            # the first round always integrates the initial cells
            ys, solve_ok = _run_round(
                (y_start, params_round, const_y, creation)
            )
        else:
            ys, solve_ok = jax.lax.cond(
                jnp.any(newly_active),
                _run_round,
                _skip_round,
                (y_start, params_round, const_y, creation),
            )
        ev_times, div_t, death_t = jax.vmap(detect_events)(ys)

        # effective end of each cell's own simulation window: the global
        # target time in cell time (reference: Cell::Simulate
        # simulation_end_time = end_time - creation, Cell.cpp:199-203)
        horizon = jnp.clip(target_time - creation, 0.0, span)
        end_t = jnp.minimum(
            jnp.where(jnp.isnan(div_t), jnp.inf, div_t),
            jnp.where(jnp.isnan(death_t), jnp.inf, death_t),
        )
        anaphase = ev_times[:, EV_ANAPHASE_ONSET]
        extended = jnp.where(
            jnp.isnan(anaphase),
            horizon,
            jnp.maximum(
                horizon,
                anaphase + cfg.simulate_past_chromatid_separation_time,
            ),
        )
        end_t = jnp.minimum(end_t, jnp.minimum(extended, span))

        upd = newly_active
        traj = jnp.where(upd[:, None, None], ys, traj)
        event_times = jnp.where(upd[:, None], ev_times, event_times)
        end_cell_time = jnp.where(upd, end_t, end_cell_time)
        # division only happens inside the simulation window (reference:
        # Experiment.cpp SimulateCell:734 'divide && achieved < target')
        this_divided = upd & ~jnp.isnan(div_t) & (div_t < horizon)
        this_died = (
            upd
            & ~jnp.isnan(death_t)
            & (death_t < horizon)
            & (jnp.where(jnp.isnan(div_t), jnp.inf, div_t) > death_t)
        )
        this_divided = this_divided & ~this_died
        divided = jnp.where(upd, this_divided, divided)
        died = jnp.where(upd, this_died, died)
        division_time = jnp.where(upd, jnp.where(this_divided, div_t, jnp.nan), division_time)
        ok = ok & jnp.all(jnp.where(upd, solve_ok, True))

        if _round == cfg.max_generations or not cfg.divide_cells:
            break

        # ---- allocate children (slot-order first fit) ----
        parent_sobol = sobol_index
        child_sobol0 = C0 + parent_sobol * 2 + 0
        child_sobol1 = C0 + parent_sobol * 2 + 1
        can_divide = this_divided
        if cfg.max_sobol_index > 0:
            can_divide = can_divide & (child_sobol1 < cfg.max_sobol_index)
        n_children_before = 2 * jnp.cumsum(can_divide.astype(jnp.int32)) - 2 * can_divide.astype(jnp.int32)
        slot0 = n_active + n_children_before
        slot1 = slot0 + 1
        fits = can_divide & (slot1 < N)
        slot0 = jnp.where(fits, slot0, N)  # N = out-of-range scatter (dropped)
        slot1 = jnp.where(fits, slot1, N)

        # division state: interpolate the parent's trajectory at div time
        def state_at(traj_row, t):
            return jax.vmap(lambda col: jnp.interp(t, grid, col))(traj_row.T)

        y_div = jax.vmap(state_at)(ys, jnp.where(jnp.isnan(div_t), 0.0, div_t))
        for six, val in cfg.division_reset_idx:
            y_div = y_div.at[:, six].set(val)
        if child_ic_fn is not None:
            # daughter initial-condition variability, gathered by the
            # CHILD's Sobol index (two daughters differ)
            y_div0 = jax.vmap(child_ic_fn)(
                y_div, jnp.clip(child_sobol0, 0, M - 1)
            )
            y_div1 = jax.vmap(child_ic_fn)(
                y_div, jnp.clip(child_sobol1, 0, M - 1)
            )
        else:
            y_div0 = y_div
            y_div1 = y_div

        parent_ids = jnp.arange(N, dtype=jnp.int32)
        child_creation = creation + jnp.where(jnp.isnan(div_t), 0.0, div_t)

        def scatter(dest, slot, values):
            return dest.at[slot].set(values, mode="drop")

        new_active = jnp.zeros((N + 1,), dtype=bool)
        new_active = new_active.at[slot0].set(fits, mode="drop")
        new_active = new_active.at[slot1].set(fits, mode="drop")
        newly_active = new_active[:N]

        y_start = scatter(
            jnp.concatenate([y_start, jnp.zeros((1, n), dtype=dtype)]),
            slot0, y_div0,
        )[:N]
        y_start = scatter(
            jnp.concatenate([y_start, jnp.zeros((1, n), dtype=dtype)]),
            slot1, y_div1,
        )[:N]
        creation = scatter(
            jnp.concatenate([creation, jnp.zeros((1,), dtype=dtype)]),
            slot0, child_creation,
        )[:N]
        creation = scatter(
            jnp.concatenate([creation, jnp.zeros((1,), dtype=dtype)]),
            slot1, child_creation,
        )[:N]
        parent = scatter(
            jnp.concatenate([parent, jnp.zeros((1,), dtype=jnp.int32)]),
            slot0, parent_ids,
        )[:N]
        parent = scatter(
            jnp.concatenate([parent, jnp.zeros((1,), dtype=jnp.int32)]),
            slot1, parent_ids,
        )[:N]
        sobol_index = scatter(
            jnp.concatenate([sobol_index, jnp.zeros((1,), dtype=jnp.int32)]),
            slot0, child_sobol0.astype(jnp.int32),
        )[:N]
        sobol_index = scatter(
            jnp.concatenate([sobol_index, jnp.zeros((1,), dtype=jnp.int32)]),
            slot1, child_sobol1.astype(jnp.int32),
        )[:N]
        is_initial = is_initial & ~newly_active
        active = active | newly_active
        n_active = n_active + 2 * jnp.sum(fits).astype(jnp.int32)

        # note: const_y is shared (treatment species are set through the
        # rhs closure); child cells inherit the same constant species
        # (reference: Cell.cpp:124 copies constant_species_y)

    return PopulationResult(
        traj=traj,
        creation=creation,
        end_cell_time=end_cell_time,
        event_times=event_times,
        divided=divided,
        died=died,
        division_time=division_time,
        active=active,
        parent=parent,
        sobol_index=sobol_index,
        is_initial=is_initial,
        ok=ok,
    )


def species_value_at(
    result: PopulationResult,
    grid,
    species_col,  # (N, G) trajectory of one species for each cell
    cell_ix: int,
    time,
    creation,
    end_cell_time,
    sync_time=None,
):
    """Interpolated species value for one cell at an experiment time
    (reference: Cell.cpp GetInterpolatedSpeciesValue:280-340): cell_time
    = time - creation, or time + sync event time when synchronized; NaN
    outside [0, end_cell_time]."""
    if sync_time is None:
        cell_t = time - creation
    else:
        cell_t = time + sync_time
    val = jnp.interp(cell_t, grid, species_col)
    valid = (cell_t >= 0.0) & (cell_t <= end_cell_time)
    return jnp.where(valid, val, jnp.nan)
