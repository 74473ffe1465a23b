"""Cell-population data likelihoods.

JAX equivalent of the reference data-likelihood hierarchy
(reference: src/cellpop/DataLikelihoodBase.cpp,
DataLikelihoodTimePoints.cpp, DataLikelihoodTimeCourse.cpp,
DataLikelihoodTimeCoursePopulationAverage.cpp,
DataLikelihoodDuration.cpp). Error models and the observed-vs-simulated
cell matching semantics are preserved:

- error models normal / proportional_normal /
  additive_proportional_normal / student_t4
  (DataLikelihoodBase.h:33-39, DataLikelihoodTimeCourseBase.cpp
  EvaluateValue);
- stdev/offset/scale each reference a sampled variable, a non-sampled
  parameter or a fixed value, per species via ';' lists
  (DataLikelihoodBase.cpp PostInitialize);
- observed cells are matched to simulated cells by Hungarian
  minimum-cost matching on the cell-likelihood matrix
  (DataLikelihoodTimePoints.cpp:220-289, DataLikelihoodDuration.cpp
  :64-133). The matching runs as a host callback
  (scipy.optimize.linear_sum_assignment) on the device-computed
  likelihood matrix — the assignment is a tiny O(n^3) problem per
  evaluation while all density evaluations stay batched on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.cellpop.variability import ValueRef
from bcm3_tpu.likelihoods.poppk import log_pdf_tnu4

_LOG_SQRT_2PI = 0.91893853320467274178032973640562

ERROR_NORMAL = "normal"
ERROR_PROPORTIONAL = "proportional_normal"
ERROR_ADDITIVE_PROPORTIONAL = "additive_proportional_normal"
ERROR_T4 = "student_t4"

_ERROR_ALIASES = {
    "normal": ERROR_NORMAL,
    "additive_normal": ERROR_NORMAL,
    "proportional_normal": ERROR_PROPORTIONAL,
    "additive_proportional_normal": ERROR_ADDITIVE_PROPORTIONAL,
    "student_t4": ERROR_T4,
    "t4": ERROR_T4,
}


def _logpdf_normal(y, x, sd):
    d = (y - x) / sd
    return -jnp.log(sd) - _LOG_SQRT_2PI - 0.5 * d * d


def evaluate_value(error_model, observed, simulated, sd, prop_sd):
    """reference: DataLikelihoodTimeCourseBase.cpp EvaluateValue."""
    if error_model == ERROR_NORMAL:
        return _logpdf_normal(observed, simulated, sd)
    if error_model == ERROR_PROPORTIONAL:
        return _logpdf_normal(
            observed, simulated, prop_sd * jnp.maximum(simulated, 0.0)
        )
    if error_model == ERROR_ADDITIVE_PROPORTIONAL:
        return _logpdf_normal(
            observed, simulated, sd + prop_sd * jnp.maximum(simulated, 0.0)
        )
    return log_pdf_tnu4(observed, simulated, sd)


def _parse_ref_list(s: str) -> List[ValueRef]:
    return [ValueRef(tok.strip()) for tok in s.split(";") if tok.strip() != ""]


@dataclass
class ErrorSpec:
    """stdev/proportional_stdev/offset/scale references + error model."""

    error_model: str = ERROR_NORMAL
    weight: float = 1.0
    stdev: List[ValueRef] = field(default_factory=list)
    proportional_stdev: List[ValueRef] = field(default_factory=list)
    offset: List[ValueRef] = field(default_factory=list)
    scale: List[ValueRef] = field(default_factory=list)

    @classmethod
    def from_xml(cls, node) -> "ErrorSpec":
        em = node.get("error_model", "normal")
        if em not in _ERROR_ALIASES:
            raise ValueError(f"Unknown error model '{em}'")
        return cls(
            error_model=_ERROR_ALIASES[em],
            weight=float(node.get("weight", "1.0")),
            stdev=_parse_ref_list(node.get("stdev", "")),
            proportional_stdev=_parse_ref_list(
                node.get("proportional_stdev", "")
            ),
            offset=_parse_ref_list(node.get("offset", "")),
            scale=_parse_ref_list(node.get("scale", "")),
        )

    def resolve(self, varset, non_sampled_names):
        for refs in (self.stdev, self.proportional_stdev, self.offset, self.scale):
            for r in refs:
                if not r.resolve(varset, non_sampled_names):
                    raise ValueError(f"Cannot resolve reference '{r.string}'")

    def _get(self, refs, i, default, tv, nsp):
        if not refs:
            return jnp.asarray(default)
        ix = 0 if len(refs) == 1 else min(i, len(refs) - 1)
        return refs[ix].value(tv, nsp)

    def get_stdev(self, tv, nsp, i=0):
        return self._get(self.stdev, i, np.nan, tv, nsp)

    def get_proportional_stdev(self, tv, nsp, i=0):
        return self._get(self.proportional_stdev, i, 0.0, tv, nsp)

    def get_offset(self, tv, nsp, i=0):
        return self._get(self.offset, i, 0.0, tv, nsp)

    def get_scale(self, tv, nsp, i=0):
        return self._get(self.scale, i, 1.0, tv, nsp)


def hungarian_match_logp(cost_logp: np.ndarray, obs_valid: np.ndarray,
                         sim_valid: np.ndarray) -> float:
    """Host-side Hungarian matching on a (n_obs, n_sim) log-likelihood
    matrix; returns the total matched logp or -inf when not enough valid
    simulated cells exist
    (reference: DataLikelihoodTimePoints.cpp Evaluate:200-289 with
    hungarianMinimumWeightPerfectMatching). Solved by the native C++ JV
    solver (native/lap.cpp) with a scipy fallback."""
    from bcm3_tpu.native import lap_solve

    obs_ix = np.where(obs_valid)[0]
    sim_ix = np.where(sim_valid)[0]
    if len(obs_ix) == 0:
        return 0.0
    if len(sim_ix) < len(obs_ix):
        return -np.inf
    sub = cost_logp[np.ix_(obs_ix, sim_ix)]
    sub = np.where(np.isfinite(sub), sub, -1e100)
    _, neg_total = lap_solve(-sub)
    total = -neg_total
    if not np.isfinite(total) or total <= -1e90:
        return -np.inf
    return float(total)


def batched_hungarian(cost_logp, obs_valid, sim_valid):
    """jit-compatible wrapper: one host matching per call; under vmap the
    callback runs sequentially per batch member."""

    # callback result dtype must be representable under the current x64
    # mode (a hard f64 here breaks f32 sessions); the matching is
    # still solved in f64 on the host either way
    out_dtype = cost_logp.dtype

    def cb(c, ov, sv):
        return np.asarray(
            hungarian_match_logp(
                np.asarray(c, dtype=np.float64),
                np.asarray(ov, dtype=bool),
                np.asarray(sv, dtype=bool),
            ),
            dtype=out_dtype,
        )

    out = jax.pure_callback(
        cb,
        jax.ShapeDtypeStruct((), out_dtype),
        cost_logp,
        obs_valid,
        sim_valid,
        vmap_method="sequential",
    )
    return out


@dataclass
class SpeciesTarget:
    """One observed species column: a sum of model species
    (reference: DataLikelihoodTimePoints.cpp species '+' parsing)."""

    name: str
    sim_indices: List[int]  # simulated-species indices summed together


@dataclass
class DataLikelihoodTimePoints:
    """Per-timepoint matching of observed cells to simulated cells
    (reference: src/cellpop/DataLikelihoodTimePoints.cpp)."""

    error: ErrorSpec
    timepoints: np.ndarray  # (T,)
    observed: np.ndarray  # (T, n_obs_cells, n_species)
    species: List[SpeciesTarget]
    synchronize: str = "none"

    def _cost(self, sim_values, tv, nsp):
        """Stacked per-timepoint matching inputs: (cost (T, n_obs, N),
        obs_valid (T, n_obs), sim_valid (T, N)) — the device half shared
        by the in-graph and two-phase host-match evaluations
        (reference cost construction:
        DataLikelihoodTimePoints.cpp Evaluate:200-289)."""
        T, N, S = sim_values.shape
        obs = jnp.asarray(self.observed, dtype=sim_values.dtype)  # (T, n_obs, S)
        sd = jnp.stack([self.error.get_stdev(tv, nsp, l) for l in range(S)])
        psd = jnp.stack(
            [self.error.get_proportional_stdev(tv, nsp, l) for l in range(S)]
        )
        off = jnp.stack([self.error.get_offset(tv, nsp, l) for l in range(S)])
        scl = jnp.stack([self.error.get_scale(tv, nsp, l) for l in range(S)])
        x = sim_values * scl[None, None, :] + off[None, None, :]  # (T, N, S)
        pair = evaluate_value(
            self.error.error_model,
            obs[:, :, None, :],  # (T, n_obs, 1, S)
            x[:, None, :, :],  # (T, 1, N, S)
            sd[None, None, None, :],
            psd[None, None, None, :],
        )  # (T, n_obs, N, S)
        pair = jnp.where(jnp.isnan(obs[:, :, None, :]), 0.0, pair)
        cost = jnp.sum(
            jnp.where(jnp.isnan(x[:, None, :, :]), -jnp.inf, pair), axis=-1
        )  # (T, n_obs, N)
        obs_valid = jnp.any(jnp.isfinite(obs), axis=-1)  # (T, n_obs)
        sim_valid = ~jnp.isnan(x[:, :, 0])  # (T, N)
        return cost, obs_valid, sim_valid

    def evaluate(self, sim_values, tv, nsp):
        """sim_values: (T, N, n_species) simulated per-cell values (NaN
        where the cell does not exist at that time). One Hungarian
        matching per timepoint."""
        cost, obs_valid, sim_valid = self._cost(sim_values, tv, nsp)
        logp = jnp.zeros((), dtype=sim_values.dtype)
        for ti in range(cost.shape[0]):
            logp = logp + batched_hungarian(
                cost[ti], obs_valid[ti], sim_valid[ti]
            )
        return logp * self.error.weight


@dataclass
class DataLikelihoodTimeCourse:
    """Whole-trajectory matching of observed cells to simulated cells:
    the likelihood matrix sums over all timepoints before one Hungarian
    matching (reference: src/cellpop/DataLikelihoodTimeCourse.cpp)."""

    error: ErrorSpec
    timepoints: np.ndarray  # (T,)
    observed: np.ndarray  # (n_obs_cells, T) or (n_obs, T, S)
    species: List[SpeciesTarget]
    synchronize: str = "none"
    missing_simulation_time_stdev: float = 3600.0

    def _cost(self, sim_values, tv, nsp):
        """(cost (n_obs, N), obs_valid, sim_valid) log-likelihood matrix
        between observed and simulated cells."""
        obs = np.asarray(self.observed)
        if obs.ndim == 2:
            obs = obs[:, :, None]
        obs = jnp.asarray(obs, dtype=sim_values.dtype)  # (n_obs, T, S)
        T, N, S = sim_values.shape
        sd = jnp.stack([self.error.get_stdev(tv, nsp, l) for l in range(S)])
        psd = jnp.stack(
            [self.error.get_proportional_stdev(tv, nsp, l) for l in range(S)]
        )
        off = jnp.stack([self.error.get_offset(tv, nsp, l) for l in range(S)])
        scl = jnp.stack([self.error.get_scale(tv, nsp, l) for l in range(S)])

        x = sim_values * scl[None, None, :] + off[None, None, :]  # (T, N, S)
        xT = jnp.transpose(x, (1, 0, 2))  # (N, T, S)
        pair = evaluate_value(
            self.error.error_model,
            obs[:, None, :, :],  # (n_obs, 1, T, S)
            xT[None, :, :, :],  # (1, N, T, S)
            sd[None, None, None, :],
            psd[None, None, None, :],
        )
        # missing observed values are ignored; missing simulated values get
        # a time-offset penalty (simplified from DataLikelihoodTimeCourse's
        # nearest-valid-time penalty: fixed penalty per missing point)
        obs_nan = jnp.isnan(obs[:, None, :, :])
        sim_nan = jnp.isnan(xT[None, :, :, :])
        penalty = _logpdf_normal(
            jnp.asarray(self.missing_simulation_time_stdev),
            0.0,
            jnp.asarray(self.missing_simulation_time_stdev),
        )
        pair = jnp.where(obs_nan, 0.0, jnp.where(sim_nan, penalty, pair))
        cost = jnp.sum(pair, axis=(2, 3))  # (n_obs, N)
        obs_valid = jnp.any(jnp.isfinite(obs), axis=(1, 2))
        sim_valid = jnp.any(~jnp.isnan(xT[:, :, 0]), axis=1)
        return cost, obs_valid, sim_valid

    def evaluate(self, sim_values, tv, nsp):
        """sim_values: (T, N, S)."""
        cost, obs_valid, sim_valid = self._cost(sim_values, tv, nsp)
        logp = batched_hungarian(cost, obs_valid, sim_valid)
        return logp * self.error.weight

    def matching(self, sim_values, tv, nsp):
        """Observed-cell -> simulated-slot assignment (n_obs,), -1 where
        unmatched (reference: DataLikelihoodTimeCourse.cpp:187-355
        trajectory_matching). Host-side: used by the posterior-predictive
        accessors, not the sampling hot path."""
        from bcm3_tpu.native import lap_solve

        cost, obs_valid, sim_valid = self._cost(sim_values, tv, nsp)
        cost = np.asarray(cost, dtype=np.float64)
        obs_ix = np.where(np.asarray(obs_valid))[0]
        sim_ix = np.where(np.asarray(sim_valid))[0]
        match = -np.ones(cost.shape[0], dtype=np.int64)
        if len(obs_ix) == 0 or len(sim_ix) < len(obs_ix):
            return match
        sub = cost[np.ix_(obs_ix, sim_ix)]
        sub = np.where(np.isfinite(sub), sub, -1e100)
        assignment, _ = lap_solve(-sub)
        for row, col in enumerate(np.asarray(assignment, dtype=np.int64)):
            if 0 <= col < len(sim_ix):
                match[obs_ix[row]] = sim_ix[col]
        return match


@dataclass
class DataLikelihoodPopulationAverage:
    """Population-average time course
    (reference: src/cellpop/DataLikelihoodTimeCoursePopulationAverage.cpp):
    the per-timepoint average over alive cells compared against each
    observed replicate, with a time-offset penalty when the simulation
    has no alive cells at a timepoint."""

    error: ErrorSpec
    timepoints: np.ndarray  # (T,)
    observed: np.ndarray  # (n_replicates, T)
    species: List[SpeciesTarget]
    include_only_mitotic: bool = False
    missing_simulation_time_stdev: float = 3600.0

    def evaluate(self, sim_values, population_size, tv, nsp):
        """sim_values: (T, N, 1); population_size: (T,)."""
        x_cells = sim_values[:, :, 0]  # (T, N)
        avg = jnp.nansum(x_cells, axis=1) / jnp.maximum(population_size, 1)
        has_cells = jnp.any(~jnp.isnan(x_cells), axis=1) & (population_size > 0)
        avg = jnp.where(has_cells, avg, jnp.nan)

        scl = self.error.get_scale(tv, nsp, 0)
        off = self.error.get_offset(tv, nsp, 0)
        sd = self.error.get_stdev(tv, nsp, 0)
        psd = self.error.get_proportional_stdev(tv, nsp, 0)
        avg = avg * scl + off

        obs = jnp.asarray(self.observed, dtype=sim_values.dtype)  # (R, T)
        tp = jnp.asarray(self.timepoints, dtype=sim_values.dtype)
        # nearest valid simulated timepoint offset for the penalty
        # (reference: ...PopulationAverage.cpp Evaluate:52-76)
        first_valid = jnp.min(jnp.where(has_cells, tp, jnp.inf))
        last_valid = jnp.max(jnp.where(has_cells, tp, -jnp.inf))
        offset = jnp.minimum(
            jnp.abs(tp - first_valid), jnp.abs(tp - last_valid)
        )
        penalty = _logpdf_normal(
            offset, 0.0, jnp.asarray(self.missing_simulation_time_stdev)
        )
        point = evaluate_value(
            self.error.error_model, obs, avg[None, :], sd, psd
        )
        contrib = jnp.where(jnp.isnan(avg)[None, :], penalty[None, :], point)
        logp = jnp.sum(jnp.where(jnp.isnan(obs), 0.0, contrib))
        return logp * self.error.weight


@dataclass
class DataLikelihoodDuration:
    """Phase-duration matching (reference:
    src/cellpop/DataLikelihoodDuration.cpp). Durations per cell come
    from the detected event times; matching via Hungarian assignment."""

    error: ErrorSpec
    observed: np.ndarray  # (n_obs,)
    period: str  # G1phase | Sphase | G2phase | NEBD_to_AnaphaseOnset
    simulation_time: float = 0.0

    def durations_from_events(self, event_times):
        """event_times: (N, NUM_EVENTS) -> (N,) durations
        (reference: Cell.cpp GetDuration:399-413)."""
        from bcm3_tpu.cellpop.simulate import (
            EV_ANAPHASE_ONSET,
            EV_NEBD,
            EV_REPLICATION_FINISH,
            EV_REPLICATION_START,
        )

        if self.period == "G1phase":
            return event_times[:, EV_REPLICATION_START]
        if self.period == "Sphase":
            return (
                event_times[:, EV_REPLICATION_FINISH]
                - event_times[:, EV_REPLICATION_START]
            )
        if self.period == "G2phase":
            return (
                event_times[:, EV_NEBD] - event_times[:, EV_REPLICATION_FINISH]
            )
        if self.period == "NEBD_to_AnaphaseOnset":
            return (
                event_times[:, EV_ANAPHASE_ONSET] - event_times[:, EV_NEBD]
            )
        raise ValueError(f"Unknown duration period '{self.period}'")

    def _cost(self, event_times, active, tv, nsp):
        """(cost (n_obs, N), obs_valid, sim_valid) matching inputs —
        the device half shared by the in-graph and two-phase host-match
        evaluations (reference: DataLikelihoodDuration.cpp:64-133)."""
        sim = self.durations_from_events(event_times)  # (N,)
        sim = jnp.where(active, sim, jnp.nan)
        sd = self.error.get_stdev(tv, nsp, 0)
        obs = jnp.asarray(self.observed, dtype=sim.dtype)
        cost = _logpdf_normal(obs[:, None], sim[None, :], sd)
        cost = jnp.where(jnp.isnan(cost), -jnp.inf, cost)
        obs_valid = jnp.isfinite(obs)
        sim_valid = ~jnp.isnan(sim)
        return cost, obs_valid, sim_valid

    def evaluate(self, event_times, active, tv, nsp):
        cost, obs_valid, sim_valid = self._cost(event_times, active, tv, nsp)
        logp = batched_hungarian(cost, obs_valid, sim_valid)
        return logp * self.error.weight
