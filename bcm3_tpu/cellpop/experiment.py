"""Cellpop experiment: SBML model + data + variability -> jittable logp.

JAX equivalent of the reference Experiment
(reference: src/cellpop/Experiment.cpp). One experiment owns an SBML
cell model, treatment trajectories, cell-variability descriptions and
data likelihoods; its log-probability simulates the whole population as
ONE batched device computation (bcm3_tpu/cellpop/simulate.py) and
evaluates the data likelihoods on the resulting trajectory tensor.

XML schema preserved (Experiment.cpp Load:403-620): attributes name,
model_file, data_file, solver_type/tolerances, num_cells, max_cells,
divide_cells, entry_time, synchronization_time_offset,
trailing_simulation_time, simulate_past_chromatid_separation_time;
child elements set_parameter, set_species, experiment_specific_parameter,
cell_variability, data, treatment_trajectory; prior-variable
conventions species_<name> (initial value from a sampled parameter) and
ratio_<name>/total_<name> (active/inactive split, Experiment.cpp
:429-485).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.cellpop import data_likelihood as dl_mod
from bcm3_tpu.cellpop.simulate import (
    EV_ANAPHASE_ONSET,
    EV_NEBD,
    EV_PCNA_GFP_INCREASE,
    EV_REPLICATION_START,
    NUM_EVENTS,
    PopulationConfig,
    simulate_population,
)
from bcm3_tpu.cellpop.treatment import create_treatment_trajectory
from bcm3_tpu.cellpop.variability import (
    ValueRef,
    VariabilityDescription,
    sobol_unit_normals,
)
from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.sbml import SBMLModel

_SYNC_EVENT = {
    "none": -1,
    "": -1,
    "DNA_replication_start": EV_REPLICATION_START,
    "PCNA_gfp_increase": EV_PCNA_GFP_INCREASE,
    "mitosis": EV_NEBD,
    "nuclear_envelope_breakdown": EV_NEBD,
    "anaphase": EV_ANAPHASE_ONSET,
    "anaphase_onset": EV_ANAPHASE_ONSET,
}


def _parse_species_target(experiment, name: str) -> dl_mod.SpeciesTarget:
    """'a+b' sums; names are ODE or constant species
    (reference: DataLikelihoodTimePoints.cpp:118-175)."""
    parts = [p.strip() for p in name.split("+")]
    idx = []
    model = experiment.model
    for p in parts:
        if p in model.ode_species:
            idx.append(model.ode_species.index(p))
        elif p in model.constant_species:
            idx.append(model.num_ode_species + model.constant_species.index(p))
        else:
            raise ValueError(
                f"Could not find species '{p}' as dynamic or constant species"
            )
    return dl_mod.SpeciesTarget(name=name, sim_indices=idx)


class Experiment:
    def __init__(
        self,
        node: ET.Element,
        varset: VariableSet,
        base_dir: str = ".",
        non_sampled_names: Optional[List[str]] = None,
    ):
        self.name = node.get("name")
        self.varset = varset
        self.non_sampled_names = list(non_sampled_names or [])
        model_file = node.get("model_file")
        if not os.path.isabs(model_file):
            model_file = os.path.join(base_dir, model_file)
        self.model = SBMLModel.from_file(model_file)

        self.initial_cells = int(node.get("num_cells", "1"))
        self.max_cells = int(node.get("max_cells", "20"))
        self.divide_cells = node.get("divide_cells", "true").lower() in ("1", "true")
        self.trailing_time = float(node.get("trailing_simulation_time", "0.0"))
        self.past_sep_time = float(
            node.get("simulate_past_chromatid_separation_time", "0.0")
        )
        self.solver_type = node.get("solver_type", "CVODE")
        self.rtol = float(
            node.get("solver_relative_tolerance", str(4 * np.finfo(np.float32).eps))
        )
        self.atol = float(
            node.get("solver_absolute_tolerance", str(4 * np.finfo(np.float32).eps))
        )
        self.max_solver_steps = int(node.get("solver_max_steps", "10000"))
        # static per-segment adaptive-step budget (extension):
        # 0 = data-dependent while_loop stepping; >0 = fixed-trip fori
        # lowering (see ode/dp5.py:_integrate_segment_fori); which is
        # faster inside vmapped sampling programs depends on the device
        self.solver_trips = int(node.get("solver_trips", "0"))

        # entry time: sampled variable, non-sampled parameter or fixed
        self.entry_time_ref = ValueRef(node.get("entry_time", "0"))
        if not self.entry_time_ref.resolve(varset, self.non_sampled_names):
            raise ValueError(
                f"Cannot resolve entry_time '{self.entry_time_ref.string}'"
            )
        sync_offset = node.get("synchronization_time_offset", "")
        self.sync_offset_ref = None
        if sync_offset:
            self.sync_offset_ref = ValueRef(sync_offset)
            if not self.sync_offset_ref.resolve(varset, self.non_sampled_names):
                raise ValueError(
                    f"Cannot resolve synchronization_time_offset '{sync_offset}'"
                )

        # fixed parameters from <set_parameter>
        self.fixed_params: Dict[str, float] = {}
        for sp in node.findall("set_parameter"):
            self.fixed_params[sp.get("parameter_name")] = float(sp.get("value"))

        # <set_species>: override an initial value (begin/end window applies
        # at experiment start; reference: Experiment.cpp:497-509)
        self.set_species: Dict[int, float] = {}
        for ss in node.findall("set_species"):
            sname = ss.get("species_name")
            if sname in self.model.ode_species:
                self.set_species[self.model.ode_species.index(sname)] = float(
                    ss.get("value")
                )

        # experiment-specific parameter replacement (Experiment.cpp:515-528)
        self.param_replacements: List[tuple] = []
        for ep in node.findall("experiment_specific_parameter"):
            self.param_replacements.append(
                (
                    varset.index_of(ep.get("parameter_name")),
                    varset.index_of(ep.get("replacement_parameter_name")),
                )
            )

        # species_<name> / ratio_<name>+total_<name> prior conventions
        self.species_init_map: List[tuple] = []  # (ode_ix, var_ix)
        self.ratio_maps: List[tuple] = []  # (active_ix, inactive_ix, ratio_var, total_var or None)
        for i, vname in enumerate(varset.names):
            if vname.startswith("species_"):
                sp = vname[len("species_"):]
                if sp in self.model.ode_species:
                    self.species_init_map.append(
                        (self.model.ode_species.index(sp), i)
                    )
            elif vname.startswith("ratio_"):
                base = vname[len("ratio_"):]
                total_ix = None
                for j, v2 in enumerate(varset.names):
                    if v2 == f"total_{base}":
                        total_ix = j
                act = f"active_{base}"
                inact = f"inactive_{base}"
                if act not in self.model.ode_species or inact not in self.model.ode_species:
                    raise ValueError(
                        f"ratio variable '{vname}' requires species "
                        f"'active_{base}' and 'inactive_{base}' in the model"
                    )
                self.ratio_maps.append(
                    (
                        self.model.ode_species.index(act),
                        self.model.ode_species.index(inact),
                        i,
                        total_ix,
                    )
                )

        # variabilities
        self.variabilities = [
            VariabilityDescription.from_xml(cv)
            for cv in node.findall("cell_variability")
        ]
        for v in self.variabilities:
            v.resolve(varset, self.non_sampled_names)
        total_dims = sum(v.num_dimensions for v in self.variabilities)
        self.sobol_normals = sobol_unit_normals(total_dims, self.initial_cells)

        # data file + data likelihoods + treatment trajectories
        self.data_likelihoods: List = []
        self.treatments: List[tuple] = []  # (constant_species_ix, trajectory)
        data_file = node.get("data_file", "")
        h5_group = None
        self._h5 = None
        if data_file:
            import h5py

            path = (
                data_file
                if os.path.isabs(data_file)
                else os.path.join(base_dir, data_file)
            )
            self._h5 = h5py.File(path, "r")
            h5_group = self._h5[self.name]

        for tnode in node.findall("treatment_trajectory"):
            sname = tnode.get("species_name")
            if sname not in self.model.constant_species:
                raise ValueError(
                    f"Treatment species '{sname}' must be a constant species"
                )
            cix = self.model.constant_species.index(sname)
            self.treatments.append(
                (cix, create_treatment_trajectory(tnode, h5_group))
            )

        for dnode in node.findall("data"):
            self.data_likelihoods.append(self._load_data_likelihood(dnode, h5_group))

        # simulation horizon & grid
        max_tp = 0.0
        for dl in self.data_likelihoods:
            tp = getattr(dl, "timepoints", None)
            if tp is not None and len(tp):
                max_tp = max(max_tp, float(np.max(tp)))
            st = getattr(dl, "simulation_time", 0.0)
            max_tp = max(max_tp, float(st))
        self.end_time = max_tp + self.trailing_time
        if self.end_time <= 0:
            self.end_time = 2000.0  # reference fallback without data

        # parameter plumbing for the RHS
        self.param_names = list(varset.names)
        rhs_core = self.model.make_rhs(
            self.param_names, self.non_sampled_names, self.fixed_params
        )
        treatments = self.treatments

        def rhs(t_cell, y, args):
            params, const_y, creation = args
            for cix, traj in treatments:
                const_y = const_y.at[cix].set(
                    traj.concentration(t_cell, creation)
                )
            return rhs_core(t_cell, y, const_y, params, jnp.zeros(0, dtype=y.dtype))

        self._rhs = rhs

        # Static-sparsity stage solver for the stiff path: the Jacobian
        # pattern is fixed by the SBML reaction structure, so the
        # no-pivot fill-in LU and the Jacobian coloring are compiled
        # once here (the reference's sparse-LU analogue,
        # src/utils/EigenPartialPivLUSomewhatSparse.h; dense fallback
        # when the pattern is near-full or via BCM3_SPARSE_STIFF=0)
        self.sparse_solver = None
        if (
            self.solver_type != "DP5"
            and os.environ.get("BCM3_SPARSE_STIFF", "1") != "0"
            and self.model.num_ode_species >= 3
        ):
            from bcm3_tpu.ode.sparse_lu import SparseStageSolver

            cand = SparseStageSolver(self.model.jacobian_sparsity())
            n = self.model.num_ode_species
            if cand.fill_nnz <= 0.6 * n * n:
                self.sparse_solver = cand

        rounds = 0
        cap = self.initial_cells
        while cap < self.max_cells and self.divide_cells:
            cap *= 2
            rounds += 1
        self.pop_config = PopulationConfig.from_model(
            self.model,
            capacity=self.max_cells,
            initial_cells=self.initial_cells,
            max_generations=min(rounds, 6),
            divide_cells=self.divide_cells,
            solver="DP5" if self.solver_type == "DP5" else "CVODE",
            rtol=self.rtol,
            atol=self.atol,
            max_steps=self.max_solver_steps,
            solver_trips=self.solver_trips or None,
            simulate_past_chromatid_separation_time=self.past_sep_time,
            max_sobol_index=len(self.sobol_normals) if total_dims else 0,
            sparse=self.sparse_solver,
        )

        # grid: dense enough for event interpolation + data reads
        G = max(128, 4 * len(self._all_timepoints()) + 8)
        self.grid = np.linspace(0.0, self.end_time * 1.0001 + 1e-6, G)

        self.non_sampled_values = np.zeros(len(self.non_sampled_names))

    def _all_timepoints(self):
        out = []
        for dl in self.data_likelihoods:
            tp = getattr(dl, "timepoints", None)
            if tp is not None:
                out.extend(np.asarray(tp).ravel().tolist())
        return out

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    # ------------------------------------------------------------------

    def _load_data_likelihood(self, node, h5_group):
        dtype = node.get("type", "time_course")
        err = dl_mod.ErrorSpec.from_xml(node)
        err.resolve(self.varset, self.non_sampled_names)
        data_name = node.get("data_name")
        sync = node.get("synchronize", "none")
        if sync not in _SYNC_EVENT:
            raise ValueError(f"Unknown synchronization '{sync}'")

        if dtype == "duration":
            observed = np.asarray(h5_group[data_name], dtype=np.float64)
            return dl_mod.DataLikelihoodDuration(
                error=err,
                observed=observed,
                period=node.get("period"),
                simulation_time=float(node.get("simulation_time", "0")),
            )

        species_names = [
            s.strip() for s in node.get("species_name").split(";") if s.strip()
        ]
        species = [_parse_species_target(self, s) for s in species_names]
        raw = np.asarray(h5_group[data_name], dtype=np.float64)
        # the time dimension name holds the timepoints
        time_dim = None
        ds = h5_group[data_name]
        if "DIMENSION_LIST" in ds.attrs:
            try:
                time_dim = np.asarray(ds.dims[0][0], dtype=np.float64)
            except Exception:
                time_dim = None
        if time_dim is None:
            tname = node.get("time_dimension", "time")
            time_dim = np.asarray(h5_group[tname], dtype=np.float64)

        if dtype == "time_points":
            obs = raw if raw.ndim == 3 else raw[:, :, None]
            return dl_mod.DataLikelihoodTimePoints(
                error=err,
                timepoints=time_dim,
                observed=obs,
                species=species,
                synchronize=sync,
            )
        if dtype == "time_course_population_average":
            obs = raw if raw.ndim == 2 else raw[None, :]
            return dl_mod.DataLikelihoodPopulationAverage(
                error=err,
                timepoints=time_dim,
                observed=obs,
                species=species,
                include_only_mitotic=node.get(
                    "include_only_cells_that_went_through_mitosis", "false"
                ).lower()
                in ("1", "true"),
            )
        if dtype == "time_course":
            # observed layout (n_cells, T) or (n_cells, T, S)
            return dl_mod.DataLikelihoodTimeCourse(
                error=err,
                timepoints=time_dim,
                observed=raw,
                species=species,
                synchronize=sync,
            )
        raise ValueError(f"Unknown data likelihood type '{dtype}'")

    # ------------------------------------------------------------------
    # Evaluation

    def _initial_state(self, tv):
        """Per-experiment initial ODE state incl. species_/ratio_ prior
        conventions and set_species overrides."""
        y0 = jnp.asarray(self.model.initial_ode_values())
        for six, val in self.set_species.items():
            y0 = y0.at[six].set(val)
        for six, vix in self.species_init_map:
            y0 = y0.at[six].set(tv[vix])
        init_base = self.model.initial_ode_values()
        for act, inact, ratio_ix, total_ix in self.ratio_maps:
            if total_ix is not None:
                y0 = y0.at[act].set(tv[ratio_ix] * tv[total_ix])
                y0 = y0.at[inact].set((1.0 - tv[ratio_ix]) * tv[total_ix])
            else:
                total = init_base[act] + init_base[inact]
                y0 = y0.at[act].set(tv[ratio_ix] * total)
                y0 = y0.at[inact].set((1.0 - tv[ratio_ix]) * total)
        return y0

    def _cell_params(self, tv, nsp, initial: bool):
        """Variability-applied per-slot parameter matrix (M, V) where M is
        the Sobol table length (gathered by slot later)."""
        M = max(len(self.sobol_normals), 1)
        base = jnp.broadcast_to(tv, (M, tv.shape[0]))
        if not self.variabilities:
            return base
        un = jnp.asarray(self.sobol_normals)
        dim0 = 0
        out = base
        for vd in self.variabilities:
            D = vd.num_dimensions
            vecs = jax.vmap(
                lambda u: vd.pseudorandom_vector(u, tv, nsp)
            )(un[:, dim0 : dim0 + D])
            for d, var in enumerate(vd.variables):
                if not var.parameter_name:
                    continue
                if var.only_initial_cells and not initial:
                    continue
                if var.parameter_name in self.varset.names:
                    pix = self.varset.index_of(var.parameter_name)
                    v = vecs[:, d]
                    if var.negate:
                        v = -v
                    out = out.at[:, pix].set(var.apply(out[:, pix], v))
            dim0 += D
        return out

    def _initial_conditions_with_variability(self, y0, tv, nsp, initial: bool):
        """(M, n) per-Sobol-row initial conditions."""
        M = max(len(self.sobol_normals), 1)
        out = jnp.broadcast_to(y0, (M, y0.shape[0]))
        if not self.variabilities:
            return out
        un = jnp.asarray(self.sobol_normals)
        dim0 = 0
        for vd in self.variabilities:
            D = vd.num_dimensions
            vecs = jax.vmap(
                lambda u: vd.pseudorandom_vector(u, tv, nsp)
            )(un[:, dim0 : dim0 + D])
            for d, var in enumerate(vd.variables):
                if not var.species_name:
                    continue
                if var.only_initial_cells and not initial:
                    continue
                if var.species_name in self.model.ode_species:
                    six = self.model.ode_species.index(var.species_name)
                    v = vecs[:, d]
                    if var.negate:
                        v = -v
                    out = out.at[:, six].set(var.apply(out[:, six], v))
            dim0 += D
        return out

    def _entry_times(self, tv, nsp):
        """Per-initial-cell creation times incl. entry-time variability."""
        N = self.max_cells
        entry = self.entry_time_ref.value(tv, nsp)
        times = jnp.zeros((N,)) + entry
        if not self.variabilities:
            return times
        un = jnp.asarray(self.sobol_normals)
        dim0 = 0
        for vd in self.variabilities:
            D = vd.num_dimensions
            for d, var in enumerate(vd.variables):
                if var.entry_time:
                    vecs = jax.vmap(
                        lambda u: vd.pseudorandom_vector(u, tv, nsp)
                    )(un[: self.initial_cells, dim0 : dim0 + D])
                    v = vecs[:, d]
                    if var.negate:
                        v = -v
                    applied = var.apply(times[: self.initial_cells], v)
                    times = times.at[: self.initial_cells].set(applied)
            dim0 += D
        return times

    def simulate(self, tv, nsp=None):
        """Run the population simulation for transformed values tv."""
        if nsp is None:
            nsp = jnp.asarray(self.non_sampled_values)
        for pix, rix in self.param_replacements:
            tv = tv.at[pix].set(tv[rix])
        y0 = self._initial_state(tv)
        cell_params_tab = self._cell_params(tv, nsp, initial=True)
        child_params_tab = self._cell_params(tv, nsp, initial=False)
        y0_tab = self._initial_conditions_with_variability(
            y0, tv, nsp, initial=True
        )

        N = self.max_cells
        # initial cells gather Sobol rows 0..C0-1 (slot == Sobol index for
        # initial cells, CellPopulation.cpp:79); daughters gather their own
        # Sobol rows inside the simulator
        slot_rows = jnp.clip(jnp.arange(N), 0, y0_tab.shape[0] - 1)
        init_y = y0_tab[slot_rows]
        const_y = jnp.broadcast_to(
            jnp.asarray(self.model.initial_constant_values()),
            (N, self.model.num_constant_species),
        )
        creation = self._entry_times(tv, nsp)

        # daughter initial-condition variability applied to the inherited
        # division state (is_initial_cell=False variables only)
        child_ic_fn = self._make_child_ic_fn(tv, nsp)

        result = simulate_population(
            self.pop_config,
            self._rhs,
            init_y,
            const_y,
            cell_params_tab,
            child_params_tab,
            creation,
            jnp.asarray(self.grid),
            target_time=self.end_time,
            child_ic_fn=child_ic_fn,
        )
        return result

    def _make_child_ic_fn(self, tv, nsp):
        """(y, sobol_ix) -> y with daughter-cell initial-condition
        variability applied (reference: Cell.cpp Initialize:150-177 with
        is_initial_cell=false)."""
        specs = []
        dim0 = 0
        for vd in self.variabilities:
            for d, var in enumerate(vd.variables):
                if (
                    var.species_name
                    and not var.only_initial_cells
                    and var.species_name in self.model.ode_species
                ):
                    specs.append((vd, dim0, d,
                                  self.model.ode_species.index(var.species_name)))
            dim0 += vd.num_dimensions
        if not specs:
            return None
        un = jnp.asarray(self.sobol_normals)

        def child_ic(y, sobol_ix):
            for vd, d0, d, six in specs:
                u_row = un[sobol_ix, d0 : d0 + vd.num_dimensions]
                vec = vd.pseudorandom_vector(u_row, tv, nsp)
                v = vec[d]
                var = vd.variables[d]
                if var.negate:
                    v = -v
                y = y.at[six].set(var.apply(y[six], v))
            return y

        return child_ic

    def _read_species(self, result, target: dl_mod.SpeciesTarget, times, sync_ev):
        """(T, N) values of one species target at experiment times."""
        n_ode = self.model.num_ode_species
        grid = jnp.asarray(self.grid)
        treat_by_cix = {cix: traj for cix, traj in self.treatments}
        cols = []
        for ix in target.sim_indices:
            if ix < n_ode:
                cols.append(result.traj[:, :, ix])  # (N, G)
            elif (ix - n_ode) in treat_by_cix:
                # treatment species: evaluate the trajectory on each cell's
                # grid (reference: Experiment.cpp:337-343 reads
                # GetConcentration at the output time)
                traj_fn = treat_by_cix[ix - n_ode]
                vals = jax.vmap(
                    lambda c: jax.vmap(
                        lambda t: traj_fn.concentration(t, c)
                    )(grid)
                )(result.creation)  # (N, G)
                cols.append(vals)
            else:
                cix = ix - n_ode
                const_val = jnp.asarray(
                    self.model.initial_constant_values()[cix]
                )
                cols.append(
                    jnp.broadcast_to(const_val, result.traj.shape[:2])
                )
        species_traj = sum(cols)  # (N, G)

        def read_cell(traj_row, creation, end_t, events):
            def read_time(t):
                if sync_ev < 0:
                    cell_t = t - creation
                else:
                    ev_t = events[sync_ev]
                    ref = jnp.where(jnp.isnan(ev_t), end_t, ev_t)
                    cell_t = t + ref
                val = jnp.interp(cell_t, grid, traj_row)
                ok = (cell_t >= 0.0) & (cell_t <= end_t)
                return jnp.where(ok, val, jnp.nan)

            return jax.vmap(read_time)(times)

        vals = jax.vmap(read_cell)(
            species_traj, result.creation, result.end_cell_time,
            result.event_times,
        )  # (N, T)
        vals = jnp.where(result.active[:, None], vals, jnp.nan)
        return vals.T  # (T, N)

    def _population_size(self, result, times):
        """Alive-cell counts at each time (reference:
        CellPopulation.cpp CountCellsAtTime:92-110)."""

        def count(t):
            cell_t = t - result.creation
            alive = (
                result.active
                & (cell_t >= 0.0)
                & (cell_t <= result.end_cell_time)
            )
            return jnp.sum(alive)

        return jax.vmap(count)(times)

    def _time_offset(self, tv, nsp):
        return (
            self.sync_offset_ref.value(tv, nsp)
            if self.sync_offset_ref is not None
            else 0.0
        )

    def _data_sim_values(self, result, dl, tv, nsp):
        """(times, sim (T, N, S)) simulated values for one data
        likelihood's timepoints (the batched analogue of the reference's
        NotifySimulatedValue collection, Experiment.cpp:296-312)."""
        time_offset = self._time_offset(tv, nsp)
        times = jnp.asarray(dl.timepoints, dtype=tv.dtype) + time_offset
        sync_ev = _SYNC_EVENT[dl.synchronize] if hasattr(dl, "synchronize") else -1
        sim = jnp.stack(
            [
                self._read_species(result, target, times, sync_ev)
                for target in dl.species
            ],
            axis=-1,
        )  # (T, N, S)
        return times, sim

    def log_prob(self, tv, nsp=None):
        """Experiment log-probability for TRANSFORMED parameter values."""
        if nsp is None:
            nsp = jnp.asarray(self.non_sampled_values)
        result = self.simulate(tv, nsp)

        logp = jnp.zeros((), dtype=tv.dtype)
        for dl in self.data_likelihoods:
            if isinstance(dl, dl_mod.DataLikelihoodDuration):
                logp = logp + dl.evaluate(
                    result.event_times, result.active, tv, nsp
                )
                continue
            times, sim = self._data_sim_values(result, dl, tv, nsp)
            if isinstance(dl, dl_mod.DataLikelihoodPopulationAverage):
                pop = self._population_size(result, times)
                logp = logp + dl.evaluate(sim, pop, tv, nsp)
            else:
                logp = logp + dl.evaluate(sim, tv, nsp)

        return jnp.where(result.ok, logp, -jnp.inf)

    def log_prob_parts(self, tv, nsp=None):
        """Jittable device half of :meth:`log_prob` for runtimes where
        host callbacks inside compiled programs are unavailable, so the
        Hungarian matching cannot run in-graph. Returns
        ``(partial_logp, ok, costs)`` where ``costs`` is a tuple of
        (cost, obs_valid, sim_valid) triples, one per Hungarian-matched
        data likelihood (time_course, duration AND time_points — the
        time_points triple is stacked (T, ...) with one matching per
        timepoint), in data-likelihood order; complete with
        :meth:`finish_log_prob_host`. The matched data likelihoods are
        exposed as :attr:`matched_dls` (static)."""
        if nsp is None:
            nsp = jnp.asarray(self.non_sampled_values)
        result = self.simulate(tv, nsp)
        logp = jnp.zeros((), dtype=tv.dtype)
        costs = []
        for dl in self.data_likelihoods:
            if isinstance(dl, dl_mod.DataLikelihoodTimeCourse):
                _times, sim = self._data_sim_values(result, dl, tv, nsp)
                costs.append(dl._cost(sim, tv, nsp))
                continue
            if isinstance(dl, dl_mod.DataLikelihoodTimePoints):
                _times, sim = self._data_sim_values(result, dl, tv, nsp)
                costs.append(dl._cost(sim, tv, nsp))  # stacked (T, ...)
                continue
            if isinstance(dl, dl_mod.DataLikelihoodDuration):
                costs.append(
                    dl._cost(result.event_times, result.active, tv, nsp)
                )
                continue
            times, sim = self._data_sim_values(result, dl, tv, nsp)
            pop = self._population_size(result, times)
            logp = logp + dl.evaluate(sim, pop, tv, nsp)
        return logp, result.ok, tuple(costs)

    @property
    def matched_dls(self):
        """The Hungarian-matched data likelihoods, in the order
        :meth:`log_prob_parts` emits their cost matrices."""
        return [
            dl
            for dl in self.data_likelihoods
            if isinstance(
                dl,
                (
                    dl_mod.DataLikelihoodTimeCourse,
                    dl_mod.DataLikelihoodTimePoints,
                    dl_mod.DataLikelihoodDuration,
                ),
            )
        ]

    @property
    def matched_weights(self):
        """Static weights of the Hungarian-matched data likelihoods, in
        the order :meth:`log_prob_parts` emits their cost matrices."""
        return [dl.error.weight for dl in self.matched_dls]

    def finish_log_prob_host_batch(self, partial_logp, ok, costs):
        """Vectorized host half of the two-phase evaluation: every leaf
        carries a leading batch axis (the vmapped
        :meth:`log_prob_parts` output pulled to numpy). All B matchings
        of a data likelihood are solved by ONE native call
        (bcm3_tpu.native.lap_match_logp_batch — C++ threads inside a
        single GIL-releasing crossing) instead of a Python loop of
        per-row solves. Semantics identical to B calls of
        :meth:`finish_log_prob_host` (equivalence-tested in
        tests/test_cellpop_matched.py)."""
        from bcm3_tpu.native import lap_match_logp_batch

        total = np.asarray(partial_logp, dtype=np.float64).copy()
        for dl, (cost, ov, sv) in zip(self.matched_dls, costs):
            c = np.asarray(cost, dtype=np.float64)
            ovn = np.asarray(ov, dtype=bool)
            svn = np.asarray(sv, dtype=bool)
            if c.ndim == 4:  # time_points: (B, T, n_obs, n_sim)
                B, T = c.shape[:2]
                matched = lap_match_logp_batch(
                    c.reshape(B * T, *c.shape[2:]),
                    ovn.reshape(B * T, -1),
                    svn.reshape(B * T, -1),
                ).reshape(B, T).sum(axis=1)
            else:
                matched = lap_match_logp_batch(c, ovn, svn)
            with np.errstate(invalid="ignore"):
                # weight 0 x -inf -> nan -> -inf below, as in the
                # serial path's Python-float arithmetic
                total = total + dl.error.weight * matched
        bad = ~np.asarray(ok, dtype=bool) | np.isnan(total)
        return np.where(bad, -np.inf, total)

    def finish_log_prob_host(self, partial_logp, ok, costs):
        """Host half of the two-phase evaluation: solve each matched
        cost matrix with the native LAP solver and add the weighted
        matched log-probabilities (numpy in, float out). A stacked
        (T, ...) triple (time_points) is one matching per timepoint."""
        total = float(partial_logp)
        for dl, (cost, ov, sv) in zip(self.matched_dls, costs):
            c = np.asarray(cost, dtype=np.float64)
            ovn = np.asarray(ov, dtype=bool)
            svn = np.asarray(sv, dtype=bool)
            if c.ndim == 3:
                s = sum(
                    dl_mod.hungarian_match_logp(c[t], ovn[t], svn[t])
                    for t in range(c.shape[0])
                )
            else:
                s = dl_mod.hungarian_match_logp(c, ovn, svn)
            total += dl.error.weight * s
        if not bool(ok) or np.isnan(total):
            return -np.inf
        return total

    # ------------------------------------------------------------------
    # Posterior-predictive accessors (the Python side of the R bridge;
    # reference: src/bcmrbridge/interface_cellpop.cpp:45-418)

    @property
    def num_species(self) -> int:
        """reference: Experiment.h:60 GetNumSpecies (ODE + constant)."""
        return self.model.num_simulated_species

    @property
    def species_names(self):
        """reference: Experiment.h:61 GetSpeciesName. Ordered ODE species
        then constant species — the same indexing _read_species and the
        data-likelihood species targets use."""
        m = self.model
        return [m.species_full_name(s) for s in m.ode_species] + [
            m.species_full_name(s) for s in m.constant_species
        ]

    def output_timepoints(self, n_timepoints: int = 500):
        """Evenly spaced global-time output grid (reference:
        Experiment.cpp:19,322-324 output_trajectory_num_timepoints=500
        over [simulation begin, simulation end])."""
        return np.linspace(0.0, self.end_time, n_timepoints)

    def simulated_trajectories(self, tv, nsp=None, n_timepoints: int = 500):
        """(timepoints (T,), values (n_cells, T, n_species), parents
        (n_cells,)) for all active cells — the analogue of
        bcm3_rbridge_cellpop_get_simulated_trajectories
        (interface_cellpop.cpp:96-148). Parents index into the returned
        cell axis; -1 marks initial cells."""
        if nsp is None:
            nsp = jnp.asarray(self.non_sampled_values)
        result = self.simulate(tv, nsp)
        times = jnp.asarray(self.output_timepoints(n_timepoints), dtype=tv.dtype)
        cols = []
        for ix in range(self.num_species):
            target = dl_mod.SpeciesTarget(
                name=self.species_names[ix], sim_indices=[ix]
            )
            cols.append(self._read_species(result, target, times, -1))  # (T, N)
        vals = jnp.stack(cols, axis=-1)  # (T, N, S)
        active = np.asarray(result.active)
        cell_ix = np.where(active)[0]
        remap = -np.ones(active.shape[0], dtype=np.int64)
        remap[cell_ix] = np.arange(len(cell_ix))
        parents = np.asarray(result.parent)[cell_ix]
        parents = np.where(parents >= 0, remap[np.clip(parents, 0, None)], -1)
        values = np.asarray(vals).transpose(1, 0, 2)[cell_ix]  # (cells, T, S)
        return np.asarray(times), values, parents

    def simulated_data(self, tv, data_ix: int, nsp=None):
        """(times, simulated values) for one data likelihood — the
        analogue of bcm3_rbridge_cellpop_get_simulated_data
        (interface_cellpop.cpp:291-416). Layouts: duration -> (N,);
        population average -> (T,); otherwise per-cell (N, T, S)."""
        if nsp is None:
            nsp = jnp.asarray(self.non_sampled_values)
        result = self.simulate(tv, nsp)
        dl = self.data_likelihoods[data_ix]
        if isinstance(dl, dl_mod.DataLikelihoodDuration):
            sim = dl.durations_from_events(result.event_times)
            sim = jnp.where(result.active, sim, jnp.nan)
            return np.zeros(1), np.asarray(sim)
        times, sim = self._data_sim_values(result, dl, tv, nsp)
        if isinstance(dl, dl_mod.DataLikelihoodPopulationAverage):
            pop = self._population_size(result, times)
            x = sim[:, :, 0]
            avg = jnp.nansum(x, axis=1) / jnp.maximum(pop, 1)
            has = jnp.any(~jnp.isnan(x), axis=1) & (pop > 0)
            return np.asarray(times), np.asarray(jnp.where(has, avg, jnp.nan))
        return np.asarray(times), np.asarray(sim).transpose(1, 0, 2)  # (N, T, S)

    def matched_simulation(self, tv, data_ix: int, nsp=None,
                           n_timepoints: int = 500):
        """(timepoints, values (n_obs, T, n_species)) — each observed
        cell's MATCHED simulated cell's full species trajectories
        (reference: interface_cellpop.cpp get_matched_simulation:418-480
        via DataLikelihoodTimeCourse::GetTrajectoryMatching)."""
        if nsp is None:
            nsp = jnp.asarray(self.non_sampled_values)
        dl = self.data_likelihoods[data_ix]
        if not isinstance(dl, dl_mod.DataLikelihoodTimeCourse):
            raise TypeError(
                "matched_simulation requires a time_course data likelihood"
            )
        result = self.simulate(tv, nsp)
        _, sim = self._data_sim_values(result, dl, tv, nsp)
        match = dl.matching(sim, tv, nsp)  # (n_obs,) sim-slot or -1
        times, values, _ = self.simulated_trajectories(tv, nsp, n_timepoints)
        active = np.asarray(result.active)
        remap = -np.ones(active.shape[0], dtype=np.int64)
        remap[np.where(active)[0]] = np.arange(int(active.sum()))
        out = np.full((len(match), len(times), self.num_species), np.nan)
        for oi, slot in enumerate(match):
            if slot >= 0 and remap[slot] >= 0:
                out[oi] = values[remap[slot]]
        return times, out
