"""General linear-compartment PK models solved by matrix exponential.

JAX equivalent of the reference pharmaco module
(reference: src/pharmaco/PharmacokineticModel.cpp,
PharmacoLikelihoodSingle.cpp, PharmacoLikelihoodPopulation.cpp,
PharmacoPatient.cpp). The reference builds a dense system matrix A from
the enabled model options and steps patient trajectories with Eigen's
``A.exp()`` between treatment events, one patient at a time per thread,
memoizing recent parameter vectors behind a spinlock
(PharmacoLikelihoodPopulation.cpp LookupCache). Here:

- the treatment schedule is compiled on the host into a uniform static
  dosing grid per patient (skipped doses become zero amounts — the
  trajectory is identical because segments without a dose are just
  longer matrix-exponential propagations);
- one ``expm(A * interval)`` per likelihood evaluation propagates the
  state through all K intervals with a `lax.scan`; observation values
  use a vmapped ``expm(A * offset)`` from their interval start;
- the population version vmaps the whole per-patient solve, replacing
  the spinlock memo cache with batching;
- failure (non-finite trajectory) maps to -inf, the framework-wide
  soft-fail convention (PharmacoLikelihoodSingle.cpp:203-224).

Structural options (reference: PharmacokineticModel.h:9-23): peripheral
compartment, metabolite compartment, N transit compartments, biphasic
(direct) absorption, per-patient bioavailability.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import expm as _scipy_expm

from bcm3_tpu.ode.linear_pk import _expm_2x2, small_expm


def expm(A):
    # Small PK system matrices get fast-path exponentials instead of the
    # generic jax.scipy expm (Pade-13 + linalg.solve custom calls).
    # n == 2 (gut/central, no peripheral/transit/metabolite): the
    # compartment matrix is lower-triangular, so its spectrum is real
    # and the closed-form Lagrange-Sylvester exponential applies
    # (ode/linear_pk.py _expm_2x2, the same form the PopPK propagators
    # use). Larger n: unrolled Pade-6 scaling-squaring (small_expm).
    if A.shape[-1] == 2:
        e00, e01, e10, e11 = _expm_2x2(
            A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1], 1.0
        )
        row0 = jnp.stack([e00, e01], axis=-1)
        row1 = jnp.stack([e10, e11], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    if A.shape[-1] <= 8:
        return small_expm(A)
    return _scipy_expm(A)
from jax.scipy.special import ndtri

from bcm3_tpu.likelihoods.poppk import (
    DRUG_MOLWEIGHTS,
    PopPKTrial,
    log_pdf_tnu4,
)
from bcm3_tpu.model.variables import VariableSet

TREATMENT_HORIZON_HOURS = 696.0  # reference: PharmacoPatient.cpp:50


@dataclass(frozen=True)
class PharmacoModelConfig:
    """Static structural options selected in the likelihood XML."""

    use_peripheral: bool = False
    num_transit: int = 0
    use_biphasic: bool = False
    use_metabolite: bool = False

    @property
    def num_compartments(self) -> int:
        # reference: PharmacokineticModel.cpp ConstructMatrix:188-201
        n = 2
        if self.use_peripheral:
            n += 1
        if self.use_metabolite:
            n += 1
        n += self.num_transit
        return n

    @property
    def metabolite_ix(self) -> int:
        return 2 + (1 if self.use_peripheral else 0)

    @property
    def first_transit_ix(self) -> int:
        return (
            2
            + (1 if self.use_peripheral else 0)
            + (1 if self.use_metabolite else 0)
        )


def build_matrix(
    cfg: PharmacoModelConfig,
    absorption,
    excretion,
    elimination,
    peripheral_fwd=0.0,
    peripheral_bwd=0.0,
    transit_rate=0.0,
    direct_absorption=0.0,
    metabolite_conversion=0.0,
    metabolite_elimination=1.0,
):
    """System matrix A (n, n), faithful to the reference construction
    (reference: PharmacokineticModel.cpp ConstructMatrix:188-246) —
    including its quirk that for exactly 2 transit compartments the
    inter-transit flow is skipped (the ``> 2`` guard at :212)."""
    n = cfg.num_compartments
    dtype = jnp.result_type(absorption)
    A = jnp.zeros((n, n), dtype=dtype)
    A = A.at[0, 0].add(-excretion - absorption)

    if cfg.num_transit > 0:
        ft = cfg.first_transit_ix
        k = cfg.num_transit
        A = A.at[ft, 0].add(absorption)
        if k > 2:  # reference quirk: chain only wired for > 2
            for i in range(k - 1):
                A = A.at[ft + i, ft + i].add(-transit_rate)
                A = A.at[ft + i + 1, ft + i].add(transit_rate)
        A = A.at[ft + k - 1, ft + k - 1].set(-transit_rate)
        A = A.at[1, ft + k - 1].add(transit_rate)
    else:
        A = A.at[1, 0].add(absorption)

    if cfg.use_peripheral:
        A = A.at[1, 1].add(-peripheral_fwd)
        A = A.at[2, 1].add(peripheral_fwd)
        A = A.at[1, 2].add(peripheral_bwd)
        A = A.at[2, 2].add(-peripheral_bwd)

    if cfg.use_biphasic:
        A = A.at[0, 0].add(-direct_absorption)
        A = A.at[1, 0].add(direct_absorption)

    if cfg.use_metabolite:
        m = cfg.metabolite_ix
        A = A.at[1, 1].add(-metabolite_conversion)
        A = A.at[m, 1].add(metabolite_conversion)
        A = A.at[m, m].add(-metabolite_elimination)

    A = A.at[1, 1].add(-elimination)
    return A


@dataclass
class PharmacoSchedule:
    """Host-precomputed static dosing/observation structure for patients.

    Doses land on a uniform grid of K intervals (t = k * interval,
    k = 0..K-1, amount 0 where treatment was skipped); observation i of
    patient j belongs to interval obs_interval[j, i] at offset
    obs_offset[j, i] past that interval's start.
    """

    interval: np.ndarray  # (P,)
    dose_amount: np.ndarray  # (P, K) — 0 where no dose given
    obs_interval: np.ndarray  # (P, T) int
    obs_offset: np.ndarray  # (P, T)
    obs_values: np.ndarray  # (P, T) observed concentrations, NaN padded
    obs_mask: np.ndarray  # (P, T) finite & real observation
    obs_times: np.ndarray  # (P, T)

    @classmethod
    def from_trial(cls, trial: PopPKTrial) -> "PharmacoSchedule":
        """Compile the reference's per-patient treatment plan
        (reference: PharmacoPatient.cpp Load:48-95, including the fixed
        696-hour treatment horizon and intermittent patterns 1/2/3)."""
        P, T = trial.num_patients, len(trial.time)
        K = int(np.max(np.ceil(TREATMENT_HORIZON_HOURS / trial.dosing_interval)))
        dose_times = trial.dosing_interval[:, None] * np.arange(K)[None, :]
        give = np.ones((P, K), dtype=bool)
        give &= dose_times < TREATMENT_HORIZON_HOURS
        day = np.floor(dose_times / 24.0).astype(int)
        for j in range(P):
            valid = (day[j] >= 0) & (day[j] < trial.interruptions.shape[1])
            skipped = np.zeros(K, dtype=bool)
            skipped[valid] = trial.interruptions[j, day[j][valid]]
            give[j] &= ~skipped
            t = dose_times[j]
            if trial.intermittent[j] == 1:
                give[j] &= (t - 7 * 24.0 * np.floor(t / (7 * 24.0))) < 5 * 24.0
            elif trial.intermittent[j] == 2:
                give[j] &= (t - 28 * 24.0 * np.floor(t / (28 * 24.0))) < 21 * 24.0
            elif trial.intermittent[j] == 3:
                give[j] &= (t - 7 * 24.0 * np.floor(t / (7 * 24.0))) < 4 * 24.0
        changed = np.where(
            np.isfinite(trial.dose_change_time[:, None]),
            dose_times >= trial.dose_change_time[:, None],
            False,
        )
        amount = np.where(
            changed,
            np.nan_to_num(trial.dose_after_dose_change[:, None]),
            trial.dose[:, None],
        )
        dose_amount = np.where(give, amount, 0.0)

        t = trial.time[None, :]
        interval = trial.dosing_interval[:, None]
        # an observation exactly at a dose time belongs to the *preceding*
        # interval (pre-dose), matching the reference's <= target_t loop
        # (PharmacokineticModel.cpp:141-155)
        k_obs = np.ceil(t / interval).astype(int) - 1
        k_obs = np.clip(k_obs, 0, K - 1)
        obs_offset = np.maximum(t - k_obs * interval, 0.0)
        obs_mask = np.isfinite(trial.observed)
        return cls(
            interval=trial.dosing_interval,
            dose_amount=dose_amount,
            obs_interval=k_obs,
            obs_offset=obs_offset,
            obs_values=trial.observed,
            obs_mask=obs_mask,
            obs_times=np.broadcast_to(trial.time, (P, T)).copy(),
        )


def solve_patient(A, interval, doses, obs_interval, obs_offset, bioavailability):
    """Propagate one patient: state scan over dosing intervals + vmapped
    observation read-out. Returns (T,) central-compartment values and an
    ok flag (reference: PharmacokineticModel.cpp Solve:110-176)."""
    n = A.shape[0]
    dtype = A.dtype
    M = expm(A * interval)  # one step matrix per evaluation

    def step(y, dose):
        y = y.at[0].add(dose * bioavailability)
        y_start = y  # post-dose state at the interval start
        return jnp.matmul(M, y, precision=jax.lax.Precision.HIGHEST), y_start

    y0 = jnp.zeros((n,), dtype=dtype)
    _, y_starts = jax.lax.scan(step, y0, doses)  # (K, n)

    def read(k, off):
        return jnp.matmul(expm(A * off), y_starts[k], precision=jax.lax.Precision.HIGHEST)

    traj = jax.vmap(read)(obs_interval, obs_offset)  # (T, n)
    ok = jnp.all(jnp.isfinite(traj))
    return traj, ok


_POP_MEANS = ("absorption", "excretion", "clearance", "volume_of_distribution")


class PharmacoLikelihoodSingle:
    """Single-patient general-PK likelihood
    (reference: src/pharmaco/PharmacoLikelihoodSingle.cpp). Named
    variables: absorption, clearance, volume_of_distribution, optional
    excretion, peripheral_*_rate, mean_transit_time, direct_absorption,
    metabolite_conversion_rate, and at least one of
    additive_error_standard_deviation /
    proportional_error_standard_deviation."""

    def __init__(
        self,
        varset: VariableSet,
        trial: PopPKTrial,
        drug: str,
        cfg: PharmacoModelConfig,
    ):
        if trial.num_patients != 1:
            raise ValueError("PharmacoLikelihoodSingle requires 1 patient")
        if drug not in DRUG_MOLWEIGHTS:
            raise ValueError(f"Unknown drug '{drug}'")
        self.varset = varset
        self.cfg = cfg
        self.drug = drug
        self.schedule = PharmacoSchedule.from_trial(trial)
        self._ix = _resolve_indices(varset, cfg, population=False)
        self.molweight = DRUG_MOLWEIGHTS[drug]

    def _params(self, values):
        ix = self._ix
        tv = lambda name: _transform(self.varset, ix[name], values)
        absorption = tv("absorption")
        clearance = tv("clearance")
        vod = tv("volume_of_distribution")
        excretion = tv("excretion") if "excretion" in ix else jnp.zeros(())
        kw = {}
        if self.cfg.use_peripheral:
            kw["peripheral_fwd"] = tv("peripheral_forward_rate")
            kw["peripheral_bwd"] = tv("peripheral_backward_rate")
        if self.cfg.num_transit > 0:
            mtt = tv("mean_transit_time")
            kw["transit_rate"] = (self.cfg.num_transit + 1.0) / mtt
        if self.cfg.use_biphasic:
            kw["direct_absorption"] = tv("direct_absorption")
        if self.cfg.use_metabolite:
            kw["metabolite_conversion"] = tv("metabolite_conversion_rate")
            kw["metabolite_elimination"] = 1.0  # reference fixes this to 1
        A = build_matrix(
            self.cfg, absorption, excretion, clearance / vod, **kw
        )
        add_sd = (
            _transform(self.varset, ix["additive_sd"], values)
            if "additive_sd" in ix
            else jnp.zeros(())
        )
        prop_sd = (
            _transform(self.varset, ix["proportional_sd"], values)
            if "proportional_sd" in ix
            else jnp.zeros(())
        )
        conversion = (1e6 / self.molweight) / vod
        return A, conversion, add_sd, prop_sd

    def simulate(self, values):
        A, conversion, _, _ = self._params(values)
        s = self.schedule
        traj, ok = solve_patient(
            A,
            jnp.asarray(s.interval[0], dtype=values.dtype),
            jnp.asarray(s.dose_amount[0], dtype=values.dtype),
            jnp.asarray(s.obs_interval[0]),
            jnp.asarray(s.obs_offset[0], dtype=values.dtype),
            jnp.ones((), dtype=values.dtype),
        )
        return traj[:, 1] * conversion, ok

    def observed(self):
        """(times, concentrations) of the patient's observed data
        (reference: interface_pharmaco_single.cpp get_observed_data)."""
        s = self.schedule
        return s.obs_times[0], s.obs_values[0]

    def simulate_trajectory(self, values, times):
        """Concentrations (T,) and full compartment trajectory (T, n) at
        arbitrary requested times (reference:
        interface_pharmaco_single.cpp get_simulated_trajectory ->
        PharmacoLikelihoodSingle::GetSimulatedTrajectory)."""
        times = np.asarray(times, dtype=np.float64)
        s = self.schedule
        interval = float(s.interval[0])
        K = s.dose_amount.shape[1]
        k_obs = np.clip(np.ceil(times / interval).astype(int) - 1, 0, K - 1)
        off = np.maximum(times - k_obs * interval, 0.0)
        A, conversion, _, _ = self._params(values)
        traj, ok = solve_patient(
            A,
            jnp.asarray(interval, dtype=A.dtype),
            jnp.asarray(s.dose_amount[0], dtype=A.dtype),
            jnp.asarray(k_obs),
            jnp.asarray(off, dtype=A.dtype),
            jnp.ones((), dtype=A.dtype),
        )
        return traj[:, 1] * conversion, traj, ok

    def log_prob(self, values):
        A, conversion, add_sd, prop_sd = self._params(values)
        s = self.schedule
        traj, ok = solve_patient(
            A,
            jnp.asarray(s.interval[0], dtype=values.dtype),
            jnp.asarray(s.dose_amount[0], dtype=values.dtype),
            jnp.asarray(s.obs_interval[0]),
            jnp.asarray(s.obs_offset[0], dtype=values.dtype),
            jnp.ones((), dtype=values.dtype),
        )
        x = traj[:, 1] * conversion
        obs = jnp.asarray(s.obs_values[0], dtype=values.dtype)
        mask = jnp.asarray(s.obs_mask[0])
        sigma = add_sd + prop_sd * jnp.maximum(x, 0.0)
        lp = jnp.sum(
            jnp.where(mask, log_pdf_tnu4(x, obs, sigma), 0.0)
        )
        return jnp.where(ok & jnp.isfinite(lp), lp, -jnp.inf)


class PharmacoLikelihoodPopulation:
    """Population general-PK likelihood with optional per-patient random
    effects (reference: src/pharmaco/PharmacoLikelihoodPopulation.cpp).

    For each base parameter X in {absorption, excretion, clearance,
    volume_of_distribution, transit_time}: if ``sigma_X`` exists in the
    prior, patient j's value is 10^QuantileNormal(p{j+1}_X; mean_X,
    sigma_X) with the per-patient quantile variables named p1_X, p2_X, …
    (reference: SetupSimulation:259-320, InitializePatientMarginals:
    326-338); otherwise all patients share 10^mean_X. Optional
    per-patient bioavailability variables p{j+1}_bioavailability scale
    the dose directly."""

    def __init__(
        self,
        varset: VariableSet,
        trial: PopPKTrial,
        drug: str,
        cfg: PharmacoModelConfig,
        use_bioavailability: bool = False,
    ):
        if drug not in DRUG_MOLWEIGHTS:
            raise ValueError(f"Unknown drug '{drug}'")
        self.varset = varset
        self.cfg = cfg
        self.drug = drug
        self.use_bioavailability = use_bioavailability
        self.num_patients = trial.num_patients
        self.schedule = PharmacoSchedule.from_trial(trial)
        self._ix = _resolve_indices(varset, cfg, population=True)
        self._patient_ix: Dict[str, np.ndarray] = {}
        for name in ("absorption", "excretion", "clearance",
                     "volume_of_distribution", "transit_time"):
            if f"sigma_{name}" in varset.names:
                self._patient_ix[name] = np.array(
                    [
                        varset.index_of(f"p{j + 1}_{name}")
                        for j in range(trial.num_patients)
                    ]
                )
        if use_bioavailability:
            self._patient_ix["bioavailability"] = np.array(
                [
                    varset.index_of(f"p{j + 1}_bioavailability")
                    for j in range(trial.num_patients)
                ]
            )
        self.molweight = DRUG_MOLWEIGHTS[drug]

    def _population_param(self, values, name, mean_name=None):
        """10^mean or the non-centered per-patient transform, vectorized
        over patients (reference: SetupSimulation:259-292)."""
        mean_name = mean_name or f"mean_{name}"
        mean = values[self.varset.index_of(mean_name)]
        if name in self._patient_ix:
            sigma = values[self.varset.index_of(f"sigma_{name}")]
            u = values[jnp.asarray(self._patient_ix[name])]
            return jnp.power(10.0, mean + sigma * ndtri(u))  # (P,)
        return jnp.power(10.0, mean) * jnp.ones(
            (self.num_patients,), dtype=values.dtype
        )

    def _params(self, values):
        P = self.num_patients
        cfg = self.cfg
        ones = jnp.ones((P,), dtype=values.dtype)
        zeros = jnp.zeros((P,), dtype=values.dtype)
        tv = lambda name: _transform(self.varset, self.varset.index_of(name), values)

        absorption = self._population_param(values, "absorption")
        clearance = self._population_param(values, "clearance")
        vod = self._population_param(values, "volume_of_distribution")
        excretion = (
            self._population_param(values, "excretion")
            if "mean_excretion" in self.varset.names
            else zeros
        )
        pf = tv("peripheral_forward_rate") * ones if cfg.use_peripheral else zeros
        pb = tv("peripheral_backward_rate") * ones if cfg.use_peripheral else zeros
        if cfg.num_transit > 0:
            if "transit_time" in self._patient_ix:
                mtt = self._population_param(
                    values, "transit_time", "mean_transit_time"
                )
            else:
                mtt = tv("mean_transit_time") * ones
            tr = (cfg.num_transit + 1.0) / mtt
        else:
            tr = zeros
        da = tv("direct_absorption") * ones if cfg.use_biphasic else zeros
        mc = tv("metabolite_conversion_rate") * ones if cfg.use_metabolite else zeros

        A = jax.vmap(
            lambda a, e, el, pfi, pbi, tri, dai, mci: build_matrix(
                cfg,
                a,
                e,
                el,
                peripheral_fwd=pfi,
                peripheral_bwd=pbi,
                transit_rate=tri,
                direct_absorption=dai,
                metabolite_conversion=mci,
                metabolite_elimination=1.0,
            )
        )(absorption, excretion, clearance / vod, pf, pb, tr, da, mc)
        if self.use_bioavailability:
            bio = values[jnp.asarray(self._patient_ix["bioavailability"])]
        else:
            bio = jnp.ones((P,), dtype=values.dtype)
        ix = self._ix
        add_sd = (
            _transform(self.varset, ix["additive_sd"], values)
            if "additive_sd" in ix
            else jnp.zeros(())
        )
        prop_sd = (
            _transform(self.varset, ix["proportional_sd"], values)
            if "proportional_sd" in ix
            else jnp.zeros(())
        )
        conversion = (1e6 / self.molweight) / vod  # (P,)
        return A, bio, conversion, add_sd, prop_sd

    def _simulate(self, params, dtype):
        A, bio, conversion, add_sd, prop_sd = params
        s = self.schedule
        traj, ok = jax.vmap(solve_patient)(
            A,
            jnp.asarray(s.interval, dtype=dtype),
            jnp.asarray(s.dose_amount, dtype=dtype),
            jnp.asarray(s.obs_interval),
            jnp.asarray(s.obs_offset, dtype=dtype),
            bio,
        )
        return traj[:, :, 1] * conversion[:, None], ok

    def simulate_trajectories(self, values):
        return self._simulate(self._params(values), values.dtype)

    def observed(self, patient_ix: int):
        """(times, concentrations) for one patient (reference:
        interface_pharmaco_population.cpp get_observed_data)."""
        s = self.schedule
        return s.obs_times[patient_ix], s.obs_values[patient_ix]

    def simulate_patient_trajectory(self, values, patient_ix: int, times):
        """Concentrations (T,) and compartment trajectory (T, n) for one
        patient at arbitrary requested times (reference:
        interface_pharmaco_population.cpp get_simulated_trajectory)."""
        times = np.asarray(times, dtype=np.float64)
        s = self.schedule
        interval = float(s.interval[patient_ix])
        K = s.dose_amount.shape[1]
        k_obs = np.clip(np.ceil(times / interval).astype(int) - 1, 0, K - 1)
        off = np.maximum(times - k_obs * interval, 0.0)
        A, bio, conversion, _, _ = self._params(values)
        traj, ok = solve_patient(
            A[patient_ix],
            jnp.asarray(interval, dtype=values.dtype),
            jnp.asarray(s.dose_amount[patient_ix], dtype=values.dtype),
            jnp.asarray(k_obs),
            jnp.asarray(off, dtype=values.dtype),
            bio[patient_ix],
        )
        return traj[:, 1] * conversion[patient_ix], traj, ok

    def log_prob(self, values):
        params = self._params(values)
        x, ok = self._simulate(params, values.dtype)  # (P, T)
        _, _, _, add_sd, prop_sd = params
        s = self.schedule
        obs = jnp.asarray(s.obs_values, dtype=values.dtype)
        mask = jnp.asarray(s.obs_mask)
        sigma = add_sd + prop_sd * jnp.maximum(x, 0.0)
        lp = jnp.sum(jnp.where(mask, log_pdf_tnu4(x, obs, sigma), 0.0))
        return jnp.where(jnp.all(ok) & jnp.isfinite(lp), lp, -jnp.inf)


def _transform(varset: VariableSet, ix: int, values):
    """Output transform of one variable (reference: VariableSet.cpp:97-112)."""
    t = varset.transforms[ix]
    v = values[ix]
    if t == 1:
        return jnp.exp(v)
    if t == 2:
        return jnp.power(10.0, v)
    if t == 3:
        return jax.nn.sigmoid(v)
    return v


def _resolve_indices(
    varset: VariableSet, cfg: PharmacoModelConfig, population: bool
) -> Dict[str, int]:
    ix: Dict[str, int] = {}
    if "additive_error_standard_deviation" in varset.names:
        ix["additive_sd"] = varset.index_of("additive_error_standard_deviation")
    if "proportional_error_standard_deviation" in varset.names:
        ix["proportional_sd"] = varset.index_of(
            "proportional_error_standard_deviation"
        )
    if "additive_sd" not in ix and "proportional_sd" not in ix:
        raise ValueError(
            "Neither additive_error_standard_deviation nor "
            "proportional_error_standard_deviation specified in the prior"
        )
    if not population:
        for name in ("absorption", "clearance", "volume_of_distribution"):
            ix[name] = varset.index_of(name)
        if "excretion" in varset.names:
            ix["excretion"] = varset.index_of("excretion")
        if cfg.use_peripheral:
            ix["peripheral_forward_rate"] = varset.index_of(
                "peripheral_forward_rate"
            )
            ix["peripheral_backward_rate"] = varset.index_of(
                "peripheral_backward_rate"
            )
        if cfg.num_transit > 0:
            ix["mean_transit_time"] = varset.index_of("mean_transit_time")
        if cfg.use_biphasic:
            ix["direct_absorption"] = varset.index_of("direct_absorption")
        if cfg.use_metabolite:
            ix["metabolite_conversion_rate"] = varset.index_of(
                "metabolite_conversion_rate"
            )
    return ix


def _create(varset: VariableSet, attrs, population: bool):
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("pharmaco likelihood requires an XML definition")
    node = root.find("pk_model")
    if node is None:
        raise ValueError("likelihood XML must contain a <pk_model> element")
    drug = node.get("drug")
    cfg = PharmacoModelConfig(
        use_peripheral=node.get("peripheral_compartment", "false").lower()
        in ("1", "true"),
        num_transit=int(node.get("num_transit_compartments", "0")),
        use_biphasic=node.get("biphasic_absorption", "false").lower()
        in ("1", "true"),
        use_metabolite=node.get("metabolite", "false").lower() in ("1", "true"),
    )
    pkdata_file = node.get("pkdata_file", "pkdata.nc")
    trial = PopPKTrial.load(pkdata_file, node.get("trial"), drug)
    if population:
        return PharmacoLikelihoodPopulation(
            varset,
            trial,
            drug,
            cfg,
            use_bioavailability=node.get("bioavailability", "false").lower()
            in ("1", "true"),
        )
    patient = attrs.get("pharmacosingle.patient") or node.get("patient")
    if not patient:
        raise ValueError("Patient ID has not been specified")
    from bcm3_tpu.likelihoods.pk_single import select_patient

    return PharmacoLikelihoodSingle(
        varset, select_patient(trial, patient), drug, cfg
    )


def create_pharmaco_single(varset: VariableSet, attrs):
    return _create(varset, attrs, population=False)


def create_pharmaco_population(varset: VariableSet, attrs):
    return _create(varset, attrs, population=True)
