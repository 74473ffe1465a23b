"""Population pharmacokinetic trajectory likelihood.

Re-design of the reference's primary ODE workload
(reference: src/likelihoods/LikelihoodPopPKTrajectory.cpp). The reference
evaluates patients one at a time inside each sampling thread, integrating
each patient's compartment ODE with CVODE and memoizing recent parameter
vectors behind a spinlock (LikelihoodPopPKTrajectory.cpp:332-353). Here
the whole patient population is evaluated as one batched computation —
and when vmapped over chains by the sampler, as one (chains x patients)
batch that fills the device:

- non-transit structural models (one/two compartment, +/- biphasic
  uptake) are piecewise-LINEAR between dosing events, so they are
  propagated EXACTLY with closed-form matrix exponentials
  (bcm3_tpu/ode/linear_pk.py): a lax.scan over dosing intervals carrying
  the state, then one vectorized propagate for all observation times.
  No CVODE, no memo cache (batching makes it redundant), machine-precision
  trajectories;
- transit-compartment models have a time-varying (Erlang-shaped) inflow
  (LikelihoodPopPKTrajectory.cpp:574-640) and use the batched adaptive
  DP5 integrator (bcm3_tpu/ode/dp5.py) over a static merged grid of
  observation and dosing times;
- the dosing schedule (skipped days, intermittent patterns 1/2/3, dose
  changes — CheckGiveTreatment, LikelihoodPopPKTrajectory.cpp:643-669)
  is precomputed on the host into static per-(patient, interval) masks;
- per-patient parameters use the same non-centered transform
  10^QuantileNormal(u_j; mu, sigma) (LikelihoodPopPKTrajectory.cpp:283-310)
  and residuals the same Student-t(nu=4) with additive+proportional sd
  (LikelihoodPopPKTrajectory.cpp:416, ProbabilityDistributions.cpp:216-224);
- integration failure / non-finite trajectories yield -inf log-likelihood
  (proposal rejection), matching LikelihoodPopPKTrajectory.cpp:400-424.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import ndtri

from bcm3_tpu.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)
from bcm3_tpu.ode import linear_pk
from bcm3_tpu.ode.dp5 import solve_at_times, solve_at_times_budget

# reference: LikelihoodPopPKTrajectory.cpp:377-394
DRUG_MOLWEIGHTS = {
    "lapatinib": 581.06,
    "dacomitinib": 469.95,
    "afatinib": 485.94,
    "trametinib": 615.404,
    "mirdametinib": 482.19,
    "selumetinib": 457.68,
}

_LOG_TNU4_C = -0.9808292530117262  # log(Gamma(2.5)/(Gamma(2) sqrt(4 pi)))


def log_pdf_tnu4(x, mu, sigma):
    """Student-t nu=4 log-density (reference: ProbabilityDistributions.cpp:216-224)."""
    xn = (x - mu) / sigma
    return _LOG_TNU4_C - 2.5 * jnp.log1p(0.25 * xn * xn) - jnp.log(sigma)


@dataclass
class PopPKTrial:
    """Observed trial data (layout mirrors the reference pkdata NetCDF)."""

    time: np.ndarray  # (T,) hours
    patient_ids: np.ndarray  # (P,)
    observed: np.ndarray  # (P, T) concentrations in nM; NaN = missing
    dose: np.ndarray  # (P,) mg
    dose_after_dose_change: np.ndarray  # (P,) NaN if no change
    dose_change_time: np.ndarray  # (P,) NaN if no change
    dosing_interval: np.ndarray  # (P,) hours
    intermittent: np.ndarray  # (P,) int {0,1,2,3}
    interruptions: np.ndarray  # (P, 29) bool, day-granularity skips

    @property
    def num_patients(self) -> int:
        return len(self.patient_ids)

    @staticmethod
    def _names(drug: str):
        return [
            "time",
            "patients",
            f"{drug}_plasma_concentration",
            f"{drug}_dose",
            f"{drug}_dose_after_dose_change",
            f"{drug}_dose_change_time",
            f"{drug}_dosing_interval",
            f"{drug}_intermittent",
            "treatment_interruptions",
        ]

    @classmethod
    def load(cls, filename: str, trial: str, drug: str) -> "PopPKTrial":
        """Read the reference pkdata layout from HDF5/NetCDF-4 (h5py) with
        a NetCDF-3 fallback (scipy) for NetCDF-3 files and for
        installations without h5py."""
        names = cls._names(drug)
        data = {}
        try:
            import h5py

            with h5py.File(filename, "r") as f:
                g = f[trial]
                for name in names:
                    data[name] = np.asarray(g[name])
        except (ImportError, OSError):
            from scipy.io import netcdf_file

            with netcdf_file(filename, "r", mmap=False) as f:
                # NetCDF-3 files have no groups; variables are <trial>_<name>
                for name in names:
                    data[name] = np.asarray(f.variables[f"{trial}_{name}"][:])
        get = data.__getitem__
        return cls(
            time=get("time").astype(np.float64),
            patient_ids=get("patients"),
            observed=get(f"{drug}_plasma_concentration").astype(np.float64),
            dose=get(f"{drug}_dose").astype(np.float64),
            dose_after_dose_change=get(f"{drug}_dose_after_dose_change").astype(
                np.float64
            ),
            dose_change_time=get(f"{drug}_dose_change_time").astype(np.float64),
            dosing_interval=get(f"{drug}_dosing_interval").astype(np.float64),
            intermittent=get(f"{drug}_intermittent").astype(np.int32),
            interruptions=get("treatment_interruptions").astype(bool),
        )

    def save(self, filename: str, trial: str, drug: str):
        """Write the pkdata layout: an HDF5 group per trial when h5py is
        installed, otherwise NetCDF-3 (scipy) with <trial>_<name> variables,
        which `load` reads back."""
        values = [
            self.time,
            self.patient_ids,
            self.observed,
            self.dose,
            self.dose_after_dose_change,
            self.dose_change_time,
            self.dosing_interval,
            self.intermittent,
            self.interruptions.astype(np.uint32),
        ]
        names = self._names(drug)
        try:
            import h5py
        except ImportError:
            self._save_netcdf3(filename, trial, names, values)
            return
        with h5py.File(filename, "w") as f:
            g = f.create_group(trial)
            for name, v in zip(names, values):
                g.create_dataset(name, data=v)

    @staticmethod
    def _save_netcdf3(filename, trial, names, values):
        from scipy.io import netcdf_file

        with netcdf_file(filename, "w") as f:
            for name, v in zip(names, values):
                v = np.asarray(v)
                if v.dtype.kind in "iub":
                    v = v.astype(np.int32)  # NetCDF-3 has no 64-bit ints
                dims = []
                for axis, n in enumerate(v.shape):
                    dim = f"{trial}_{name}_{axis}"
                    f.createDimension(dim, n)
                    dims.append(dim)
                f.createVariable(f"{trial}_{name}", v.dtype, tuple(dims))[:] = v


def _give_treatment_mask(trial: PopPKTrial, dose_times: np.ndarray) -> np.ndarray:
    """CheckGiveTreatment as a static (P, K) mask
    (reference: LikelihoodPopPKTrajectory.cpp:643-669)."""
    P, K = dose_times.shape
    give = np.ones((P, K), dtype=bool)
    day = np.floor(dose_times / 24.0).astype(int)
    for j in range(P):
        skipped = np.zeros(K, dtype=bool)
        valid_day = (day[j] >= 0) & (day[j] < trial.interruptions.shape[1])
        skipped[valid_day] = trial.interruptions[j, day[j][valid_day]]
        give[j] &= ~skipped
        if trial.intermittent[j] == 1:
            tw = dose_times[j] - 7 * 24.0 * np.floor(dose_times[j] / (7 * 24.0))
            give[j] &= tw < 5 * 24.0
        elif trial.intermittent[j] == 2:
            tc = dose_times[j] - 28 * 24.0 * np.floor(dose_times[j] / (28 * 24.0))
            give[j] &= tc < 21 * 24.0
        elif trial.intermittent[j] == 3:
            tw = dose_times[j] - 7 * 24.0 * np.floor(dose_times[j] / (7 * 24.0))
            give[j] &= tw < 4 * 24.0
    return give


def _simulate_until(trial: PopPKTrial) -> np.ndarray:
    """Per-patient number of trusted timepoints
    (reference: LikelihoodPopPKTrajectory.cpp:163-186)."""
    P = trial.num_patients
    T = len(trial.time)
    until = np.full(P, T, dtype=int)
    for j in range(P):
        if trial.interruptions[j, 1]:
            # unknown interruption schedule from day 2: first day only
            for i, t in enumerate(trial.time):
                if t >= 24.0:
                    until[j] = i
                    break
        obs = trial.observed[j]
        finite_ix = np.where(np.isfinite(obs))[0]
        if len(finite_ix) and trial.time[finite_ix[0]] > 15 * 24.0:
            until[j] = 0
    return until


class PopPKLikelihood:
    """Pure-function PopPK log-likelihood over the full patient population."""

    def __init__(
        self,
        varset: VariableSet,
        trial: PopPKTrial,
        pk_type: str,
        drug: str,
        fixed_vod: float = np.nan,
        fixed_periphery_fwd: float = np.nan,
        fixed_periphery_bwd: float = np.nan,
        solver_trips: int = 768,
    ):
        self.varset = varset
        self.trial = trial
        self.drug = drug
        # whole-trajectory adaptive-step budget for the transit-model DP5
        # solve (static trip count; see ode/dp5.py:solve_at_times_budget)
        self.solver_trips = int(solver_trips)
        if drug not in DRUG_MOLWEIGHTS:
            raise ValueError(f"Unknown drug '{drug}'")

        # reference quirk preserved: both one_biphasic_uptake and
        # two_biphasic_uptake map to the two-compartment biphasic model
        # (LikelihoodPopPKTrajectory.cpp:70-84)
        aliases = {
            "one": "one",
            "two": "two",
            "one_biphasic_uptake": "two_biphasic",
            "two_biphasic_uptake": "two_biphasic",
            "one_transit": "one_transit",
            "two_transit": "two_transit",
        }
        if pk_type not in aliases:
            raise ValueError(f"Invalid PK model type '{pk_type}'")
        self.pk_type = aliases[pk_type]
        self.n_states = 2 if self.pk_type in ("one", "one_transit") else 3
        # reference: LikelihoodPopPKTrajectory.cpp:102-119
        self.num_pk_params = {
            "one": 4,
            "two": 6,
            "two_biphasic": 7,
            "one_transit": 6,
            "two_transit": 8,
        }[self.pk_type]
        self.fixed_vod = fixed_vod
        self.fixed_periphery_fwd = fixed_periphery_fwd
        self.fixed_periphery_bwd = fixed_periphery_bwd

        P, T = trial.num_patients, len(trial.time)
        fixed_count = int(np.isfinite(fixed_vod)) + int(
            np.isfinite(fixed_periphery_fwd)
        ) + int(np.isfinite(fixed_periphery_bwd))
        expected = self.num_pk_params - fixed_count + 2 * (P + 1) + 2
        if (
            not getattr(self, "_skip_varset_check", False)
            and varset.num_variables != expected
        ):
            raise ValueError(
                f"Incorrect number of variables in prior: got "
                f"{varset.num_variables}, expected {expected}"
            )

        self.sd_ix = varset.index_of("standard_deviation")
        self._named_ix = {}
        for name in (
            "n_transit",
            "mean_transit_time",
            "biphasic_uptake_time",
            "mean_absorption2",
        ):
            if name in varset.names:
                self._named_ix[name] = varset.index_of(name)

        self.simulate_until = _simulate_until(trial)
        self.conversion_base = 1e6 / DRUG_MOLWEIGHTS[drug]

        # static dosing grid: K intervals cover the full simulated horizon
        t_max = float(trial.time.max())
        k_per_patient = np.ceil(t_max / trial.dosing_interval).astype(int)
        self.K = int(k_per_patient.max())
        k_idx = np.arange(1, self.K + 1)
        # dose event times (P, K): t = k * interval (the t=0 dose is the
        # initial condition, reference: LikelihoodPopPKTrajectory.cpp:369-374)
        self.dose_times = trial.dosing_interval[:, None] * k_idx[None, :]
        give = _give_treatment_mask(trial, self.dose_times)
        # dose amount at each event: changes after dose_change_time
        changed = np.where(
            np.isfinite(trial.dose_change_time[:, None]),
            self.dose_times >= trial.dose_change_time[:, None],
            False,
        )
        amount = np.where(
            changed,
            np.nan_to_num(trial.dose_after_dose_change[:, None]),
            trial.dose[:, None],
        )
        self.dose_amount = np.where(give, amount, 0.0)  # (P, K)
        self.give_dose = give

        # observation -> interval mapping (pre-dose at exact event times)
        t = trial.time[None, :]  # (1, T)
        interval = trial.dosing_interval[:, None]
        k_obs = np.floor((t - 1e-9) / interval).astype(int)
        self.obs_interval = np.clip(k_obs, 0, self.K - 1)  # (P, T)
        self.obs_offset = np.maximum(t - self.obs_interval * interval, 0.0)  # (P, T)

        # mask of scored observations and of the simulated window
        idx = np.arange(T)[None, :]
        self.window_mask = idx < self.simulate_until[:, None]  # (P, T)
        self.obs_mask = np.isfinite(trial.observed) & self.window_mask
        # the t=0 dose is unconditional (reference: initial_conditions[0] = dose,
        # LikelihoodPopPKTrajectory.cpp:369-374 — no CheckGiveTreatment at t=0)
        self.initial_dose = trial.dose.copy()
        # biphasic: the ka1->ka2 switch only happens in intervals whose
        # starting dose was actually given (reference: TreatmentCallbackBiphasic
        # leaves biphasic_switch false over skipped intervals)
        start_given = np.concatenate(
            [np.ones((P, 1), dtype=bool), self.dose_amount[:, : self.K - 1] > 0],
            axis=1,
        )  # (P, K): interval k starts with a dose?
        self.interval_start_given = start_given

        if self.pk_type in ("one_transit", "two_transit"):
            self._prepare_transit_grid()

    # ------------------------------------------------------------------

    def _transform(self, ix: int, v):
        """Per-variable output transform (reference: VariableSet.cpp:97-112)."""
        t = self.varset.transforms[ix]
        if t == TRANSFORM_LOG:
            return jnp.exp(v)
        if t == TRANSFORM_LOG10:
            return jnp.power(10.0, v)
        if t == TRANSFORM_LOGIT:
            return jax.nn.sigmoid(v)
        return v

    def _patient_params(self, values):
        """Population -> per-patient parameter transforms
        (reference: LikelihoodPopPKTrajectory.cpp:283-310)."""
        npk = self.num_pk_params
        P = self.trial.num_patients
        j = jnp.arange(P)
        u_abs = values[npk + 2 * (j + 1) + 0]
        u_elim = values[npk + 2 * (j + 1) + 1]
        ka = jnp.power(10.0, values[0] + values[npk + 0] * ndtri(u_abs))
        ke = self._transform(1, values[1])
        vod = (
            self._transform(3, values[3])
            if not np.isfinite(self.fixed_vod)
            else jnp.asarray(self.fixed_vod, dtype=values.dtype)
        )
        kel = jnp.power(10.0, values[2] + values[npk + 1] * ndtri(u_elim)) / vod
        params = {
            "ka": ka,  # (P,)
            "ke": ke,  # scalar
            "vod": vod,
            "kel": kel,  # (P,)
        }
        if self.n_states == 3:
            if not np.isfinite(self.fixed_periphery_fwd):
                params["kpf"] = self._transform(4, values[4])
                params["kpb"] = self._transform(5, values[5])
            else:
                params["kpf"] = jnp.asarray(
                    self.fixed_periphery_fwd, dtype=values.dtype
                )
                params["kpb"] = jnp.asarray(
                    self.fixed_periphery_bwd, dtype=values.dtype
                )
        if self.pk_type in ("one_transit", "two_transit"):
            nt_ix = self._named_ix["n_transit"]
            mt_ix = self._named_ix["mean_transit_time"]
            n_transit = self._transform(nt_ix, values[nt_ix])
            params["n_transit"] = n_transit
            params["k_transit"] = (n_transit + 1.0) / self._transform(
                mt_ix, values[mt_ix]
            )
        if self.pk_type == "two_biphasic":
            bt_ix = self._named_ix["biphasic_uptake_time"]
            a2_ix = self._named_ix["mean_absorption2"]
            switch = self._transform(bt_ix, values[bt_ix])
            # reference clamps to interval - 1e-2 (cpp:305-307)
            params["switch_time"] = jnp.minimum(
                switch, jnp.asarray(self.trial.dosing_interval) - 1e-2
            )  # (P,)
            params["ka2"] = self._transform(a2_ix, values[a2_ix])
        sd = self._transform(self.sd_ix, values[self.sd_ix])
        sd2 = self._transform(self.sd_ix + 1, values[self.sd_ix + 1])
        return params, sd, sd2

    # ------------------------------------------------------------------
    # Linear-model path (exact closed form)

    def _simulate_linear(self, p, full_state=False):
        """Propagate all patients over all dosing intervals exactly.
        Returns central concentrations at the observation grid (P, T),
        or the full compartment states (P, T, n) with full_state."""
        P = self.trial.num_patients
        dtype = p["ka"].dtype
        interval = jnp.asarray(self.trial.dosing_interval, dtype=dtype)  # (P,)
        dose_amount = jnp.asarray(self.dose_amount, dtype=dtype)  # (P, K)

        y0 = jnp.zeros((P, self.n_states), dtype=dtype)
        y0 = y0.at[:, 0].set(jnp.asarray(self.initial_dose, dtype=dtype))

        kpf = p.get("kpf")
        kpb = p.get("kpb")
        if self.pk_type == "two_biphasic":
            start_given = jnp.asarray(self.interval_start_given)  # (P, K)
            switch_eff = jnp.where(
                start_given, p["switch_time"][:, None], 0.0
            )  # (P, K) — no ka1 phase in intervals without a starting dose

        def prop(y, dt, k=None, obs_switch=None):
            if self.pk_type == "two_biphasic":
                sw = switch_eff[:, k] if obs_switch is None else obs_switch
                return linear_pk.propagate_biphasic(
                    y, dt, sw, p["ka"], p["ke"], p["kel"], kpf, kpb
                )
            if self.n_states == 2:
                return linear_pk.propagate_one_compartment(
                    y, dt, p["ka"], p["ke"], p["kel"]
                )
            return linear_pk.propagate_two_compartment(
                y, dt, p["ka"], p["ke"], p["kel"], kpf, kpb
            )

        def interval_step(y, k):
            # ys output: state at the START of interval k (post-dose)
            y_start = y
            y_end = prop(y, interval, k)
            y_next = y_end.at[:, 0].add(dose_amount[:, k])
            return y_next, y_start

        _, ys = jax.lax.scan(interval_step, y0, jnp.arange(self.K))
        # ys: (K, P, n) — state at start of each interval

        # propagate each observation from its interval start
        obs_k = jnp.asarray(self.obs_interval)  # (P, T)
        obs_dt = jnp.asarray(self.obs_offset, dtype=dtype)  # (P, T)
        pidx = jnp.arange(P)[:, None]
        y_base = ys[obs_k, pidx, :]  # (P, T, n)

        if self.pk_type == "two_biphasic":
            obs_switch = jnp.take_along_axis(switch_eff, obs_k, axis=1)  # (P, T)
            y_obs = linear_pk.propagate_biphasic(
                y_base,
                obs_dt,
                obs_switch,
                p["ka"][:, None],
                p["ke"],
                p["kel"][:, None],
                kpf,
                kpb,
            )
        elif self.n_states == 2:
            y_obs = linear_pk.propagate_one_compartment(
                y_base, obs_dt, p["ka"][:, None], p["ke"], p["kel"][:, None]
            )
        else:
            y_obs = linear_pk.propagate_two_compartment(
                y_base, obs_dt, p["ka"][:, None], p["ke"], p["kel"][:, None], kpf, kpb
            )
        if full_state:
            return y_obs  # (P, T, n) in mg
        return y_obs[..., 1]  # central (P, T) in mg

    # ------------------------------------------------------------------
    # Transit-model path (DP5 over a static merged grid)

    def _prepare_transit_grid(self):
        """Merge observation and dosing times into one static sorted grid
        per patient, with event flags at dosing positions."""
        P, T = self.trial.num_patients, len(self.trial.time)
        S = T + self.K
        grid = np.empty((P, S))
        is_dose = np.zeros((P, S), dtype=bool)
        dose_amt = np.zeros((P, S))
        obs_pos = np.zeros((P, T), dtype=int)
        for j in range(P):
            times = np.concatenate([self.trial.time, self.dose_times[j]])
            flags = np.concatenate([np.zeros(T, bool), np.ones(self.K, bool)])
            amts = np.concatenate([np.zeros(T), self.dose_amount[j]])
            # stable sort keeps obs before a dose at identical times
            order = np.argsort(times, kind="stable")
            grid[j] = times[order]
            is_dose[j] = flags[order]
            dose_amt[j] = amts[order]
            inv = np.empty(S, dtype=int)
            inv[order] = np.arange(S)
            obs_pos[j] = inv[:T]
        self.tr_grid = grid
        self.tr_is_dose = is_dose
        self.tr_dose_amt = dose_amt
        self.tr_obs_pos = obs_pos

    def _simulate_transit(self, p, full_state=False):
        """Transit-compartment models via the batched DP5 integrator.

        Augmented state: [gut, central, (peripheral), last_treatment, dose].
        With full_state, returns the full augmented states at the
        observation grid (P, T, n+2) instead of the central column.
        """
        P = self.trial.num_patients
        dtype = p["ka"].dtype
        n = self.n_states
        n_aug = n + 2

        two_comp = self.pk_type == "two_transit"

        def deriv(t, y, args):
            (ka, ke, kel, kpf, kpb, k_transit, n_transit) = args
            last_treatment = y[n]
            dose = y[n + 1]
            t_since = jnp.maximum(t - last_treatment, 0.0)
            # Erlang-shaped transit inflow with Stirling's log-factorial
            # (reference: LikelihoodPopPKTrajectory.cpp:574-596)
            log_nfac = (
                0.9189385332046727
                + (n_transit + 0.5) * jnp.log(n_transit)
                - n_transit
                + jnp.log(1.0 + 1.0 / (12.0 * n_transit))
            )
            log_t = jnp.log(jnp.maximum(k_transit * t_since, 1e-300))
            transit = jnp.exp(n_transit * log_t - k_transit * t_since - log_nfac)
            transit = k_transit * transit * dose
            dgut = transit - (ka + ke) * y[0]
            if two_comp:
                dcen = ka * y[0] - kel * y[1] - kpf * y[1] + kpb * y[2]
                dper = kpf * y[1] - kpb * y[2]
                rest = (dcen, dper)
            else:
                dcen = ka * y[0] - kel * y[1]
                rest = (dcen,)
            return jnp.stack([dgut, *rest, jnp.zeros_like(dgut), jnp.zeros_like(dgut)])

        grid = jnp.asarray(self.tr_grid, dtype=dtype)  # (P, S)
        is_dose = jnp.asarray(self.tr_is_dose)  # (P, S)
        dose_amt = jnp.asarray(self.tr_dose_amt, dtype=dtype)  # (P, S)

        def solve_one(j_grid, j_is_dose, j_dose_amt, ka, kel, args_rest, init_dose):
            (ke, kpf, kpb, k_transit, n_transit) = args_rest
            args = (ka, ke, kel, kpf, kpb, k_transit, n_transit)

            S = j_grid.shape[0]

            def event(i, t, y, _args):
                # at dose events: last_treatment <- t, dose level <- amount
                # (only when the dose is actually given: amount > 0).
                # one-hot mask instead of j_is_dose[i]: under the budget
                # solver the index is per-lane traced, and a masked select
                # over the stop axis stays vectorized
                oh = jnp.arange(S, dtype=jnp.int32) == i
                fire = jnp.any(oh & j_is_dose & (j_dose_amt > 0))
                amt = jnp.sum(jnp.where(oh, j_dose_amt, 0.0))
                y = y.at[n].set(jnp.where(fire, t, y[n]))
                y = y.at[n + 1].set(jnp.where(fire, amt, y[n + 1]))
                return y

            y0 = jnp.zeros(n_aug, dtype=dtype)
            # initial dose at t=0 enters through the transit chain:
            # last_treatment=0, dose=initial (reference: initial gut = 0)
            y0 = y0.at[n + 1].set(init_dose)
            # whole-trajectory static step budget + min-step fail-fast: one
            # pathological parameter corner must reject (-inf) quickly, not
            # serialize the whole vmapped batch (reference's max-steps /
            # min-step guards, ODESolverCVODE.cpp:322-445); the budget
            # form wastes no trips on masked segment-boundary no-ops
            # (see ode/dp5.py:solve_at_times_budget)
            # tolerances exactly as the reference configures them:
            # rel 1e-6, abs = minimum dose * 1e-6
            # (LikelihoodPopPKTrajectory.cpp:238)
            res = solve_at_times_budget(
                deriv,
                y0,
                j_grid,
                args=args,
                event_fn=event,
                rtol=1e-6,
                atol=float(np.min(self.trial.dose)) * 1e-6,
                total_trips=self.solver_trips,
                min_dt=1e-5,
            )
            if full_state:
                return jnp.where(res.ok, res.ys, jnp.nan)  # (S, n_aug)
            ys = jnp.where(res.ok, res.ys[:, 1], jnp.nan)  # central (S,)
            return ys

        ke = p["ke"]
        kpf = p.get("kpf", jnp.zeros(()))
        kpb = p.get("kpb", jnp.zeros(()))
        central_grid = jax.vmap(
            lambda g, d, a, ka, kel, dose0: solve_one(
                g, d, a, ka, kel, (ke, kpf, kpb, p["k_transit"], p["n_transit"]), dose0
            )
        )(
            grid,
            is_dose,
            dose_amt,
            p["ka"],
            p["kel"],
            jnp.asarray(self.initial_dose, dtype=dtype),
        )  # (P, S) or (P, S, n_aug) with full_state
        pidx = jnp.arange(P)[:, None]
        return central_grid[pidx, jnp.asarray(self.tr_obs_pos)]  # (P, T[, n_aug])

    # ------------------------------------------------------------------

    def log_prob(self, values):
        """Full-population log-likelihood for one parameter vector."""
        p, sd, sd2 = self._patient_params(values)

        if self.pk_type in ("one_transit", "two_transit"):
            central = self._simulate_transit(p)
        else:
            central = self._simulate_linear(p)  # (P, T) in mg

        # mg -> nM conversion (reference: cpp:377-394)
        conversion = self.conversion_base / p["vod"]
        x = central * conversion  # (P, T)

        obs = jnp.asarray(self.trial.observed, dtype=values.dtype)
        mask = jnp.asarray(self.obs_mask)
        # double-where: sanitize the unscored entries BEFORE the pdf so the
        # masked-out branch is NaN-free — a NaN in the untaken branch of a
        # single where poisons reverse-mode gradients (NUTS/HMC path)
        x_sc = jnp.where(mask, x, 0.0)
        obs_sc = jnp.where(mask, obs, 0.0)
        sigma = sd + sd2 * jnp.maximum(x_sc, 0.0)
        pointwise = log_pdf_tnu4(x_sc, obs_sc, sigma)
        logp = jnp.sum(jnp.where(mask, pointwise, 0.0))
        # NaN anywhere in the simulated window -> reject
        # (reference: LikelihoodPopPKTrajectory.cpp:416-424)
        window = jnp.asarray(self.window_mask)
        bad = jnp.any(jnp.where(window, jnp.isnan(x), False)) | jnp.isnan(logp)
        return jnp.where(bad, -jnp.inf, logp)

    def _log_prob_batched_transit_kernel(self, xs, interpret=False):
        """One-compartment-transit batched evaluation through the fused
        budget-DP5 kernel (bcm3_tpu/ops/transit_pallas.py): the whole trip
        loop runs in one GPU program with the integrator state and the
        recorded stops in registers, where XLA's lowering rewrites the
        recorded-stop buffer in device memory on every trip. Same tableau,
        controller, tolerances and soft-fail semantics as the
        solve_at_times_budget path. Lanes are (chain, patient), patient
        minor."""
        from bcm3_tpu.ops.transit_pallas import transit_solve

        B = xs.shape[0]
        P = self.trial.num_patients
        S = self.tr_grid.shape[1]
        dtype = xs.dtype
        p, sd, sd2 = jax.vmap(self._patient_params)(xs)

        def flat(x):
            if x.ndim == 1:
                x = x[:, None]
            return jnp.broadcast_to(x, (B, P)).reshape(B * P)

        params = {
            "ka": flat(p["ka"]),
            "ke": flat(p["ke"]),
            "kel": flat(p["kel"]),
            "k_transit": flat(p["k_transit"]),
            "n_transit": flat(p["n_transit"]),
            "dose0": jnp.tile(jnp.asarray(self.initial_dose, dtype), B),
        }
        # stop-major (S, B*P) tables: per-patient rows tiled over chains
        grid = jnp.tile(jnp.asarray(self.tr_grid.T, dtype), (1, B))
        amt = jnp.tile(
            jnp.asarray(np.where(self.tr_is_dose, self.tr_dose_amt, 0.0).T, dtype),
            (1, B),
        )
        central, ok = transit_solve(
            params,
            grid,
            amt,
            trips=self.solver_trips,
            rtol=1e-6,
            atol=float(np.min(self.trial.dose)) * 1e-6,
            min_dt=1e-5,
            interpret=interpret,
        )
        central = central.reshape(S, B, P).transpose(1, 2, 0)  # (B, P, S)
        ok = ok.reshape(B, P)
        pidx = jnp.arange(P)[:, None]
        central_obs = central[:, pidx, jnp.asarray(self.tr_obs_pos)]  # (B,P,T)
        central_obs = jnp.where(ok[:, :, None], central_obs, jnp.nan)

        conversion = (self.conversion_base / p["vod"]).reshape(B, 1, 1)
        x = central_obs * conversion
        obs = jnp.asarray(self.trial.observed, dtype=dtype)[None]
        mask = jnp.asarray(self.obs_mask)[None]
        x_sc = jnp.where(mask, x, 0.0)  # double-where (see log_prob)
        obs_sc = jnp.where(mask, obs, 0.0)
        sigma = sd.reshape(B, 1, 1) + sd2.reshape(B, 1, 1) * jnp.maximum(
            x_sc, 0.0
        )
        pointwise = log_pdf_tnu4(x_sc, obs_sc, sigma)
        logp = jnp.sum(jnp.where(mask, pointwise, 0.0), axis=(1, 2))
        window = jnp.asarray(self.window_mask)[None]
        bad = jnp.any(jnp.where(window, jnp.isnan(x), False), axis=(1, 2))
        bad = bad | jnp.isnan(logp)
        return jnp.where(bad, -jnp.inf, logp)

    def uses_transit_kernel(self, dtype) -> bool:
        """Whether `log_prob_batched` takes the fused transit kernel: the
        one-compartment transit model, in float32, on a GPU backend. The
        kernel is compiled for the GPU only; everywhere else the batch goes
        through XLA's lowering of `log_prob`."""
        return (
            self.pk_type == "one_transit"
            and jnp.dtype(dtype) == jnp.float32
            and jax.default_backend() == "gpu"
        )

    def log_prob_batched(self, xs):
        """Natively batched evaluation over a chain population xs (B, D)."""
        if self.uses_transit_kernel(xs.dtype):
            return self._log_prob_batched_transit_kernel(xs)
        return jax.vmap(self.log_prob)(xs)

    def simulate_trajectories(self, values):
        """Central-compartment concentrations (P, T) in nM — the analogue of
        the R bridge's get_simulated_data (reference: interface_popPK.cpp:79)."""
        p, _, _ = self._patient_params(values)
        if self.pk_type in ("one_transit", "two_transit"):
            central = self._simulate_transit(p)
        else:
            central = self._simulate_linear(p)
        return central * (self.conversion_base / p["vod"])

    def simulate_states(self, values):
        """Concentrations (P, T) in nM plus the full compartment
        trajectories (P, T, n_states) in mg at the observation grid — the
        analogue of the R bridge's get_simulated_data trajectories output
        (reference: interface_popPK.cpp:79-120 out_trajectories)."""
        p, _, _ = self._patient_params(values)
        if self.pk_type in ("one_transit", "two_transit"):
            states = self._simulate_transit(p, full_state=True)
            states = states[..., : self.n_states]
        else:
            states = self._simulate_linear(p, full_state=True)
        conc = states[..., 1] * (self.conversion_base / p["vod"])
        return conc, states


def create_poppk_likelihood(varset: VariableSet, attrs):
    """Factory entry (reference: LikelihoodFactory.cpp 'pop_pk_trajectory')."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("pop_pk_trajectory likelihood requires an XML definition")
    node = root.find("pk_model")
    if node is None:
        raise ValueError("likelihood XML must contain a <pk_model> element")
    trial_name = node.get("trial")
    drug = node.get("drug")
    pkdata_file = node.get("pkdata_file")
    trial = PopPKTrial.load(pkdata_file, trial_name, drug)
    return PopPKLikelihood(
        varset,
        trial,
        node.get("type"),
        drug,
        fixed_vod=float(node.get("volume_of_distribution", "nan")),
        fixed_periphery_fwd=float(node.get("k_periphery_fwd", "nan")),
        fixed_periphery_bwd=float(node.get("k_periphery_bwd", "nan")),
        solver_trips=int(node.get("solver_trips", "768")),
    )
