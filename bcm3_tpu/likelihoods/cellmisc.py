"""Auxiliary cell-biology likelihoods: cell-cycle marker, mitosis-time
estimation, and the Incucyte drug-response population model.

JAX equivalent of
- reference: src/likelihoods/LikelihoodCellCycleMarker.cpp — a
  piecewise-linear cell-cycle marker signal (baseline, S-phase ramp,
  plateau ramp, post-mitosis decay) fit to one TSV track with t(nu=4)
  errors;
- reference: src/likelihoods/LikelihoodMitosisTimeEstimation.cpp —
  Sobol-generated boxcar mitosis trajectories matched to observed
  trajectories (the reference's Hungarian matching block is disabled
  behind '#if TODO'; here the clearly intended matching is implemented
  via the shared host-callback assignment);
- reference: src/likelihoods/LikelihoodIncucytePopulation.cpp — a
  3-state delay ODE (growing cells, apoptotic cells, debris) per well
  with drug-ramp effects, contact inhibition, confluence/apoptosis
  marker outputs and t(nu=3) residuals, integrated with the batched
  fixed-grid DDE solver (bcm3_tpu/ode/delay.py) instead of the
  reference's per-well CVODE delay solver: ALL wells (controls + every
  concentration) integrate as one vmapped batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.cellpop.data_likelihood import batched_hungarian
from bcm3_tpu.likelihoods.poppk import log_pdf_tnu4
from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.ode.delay import solve_dde_adaptive, solve_dde_grid

# log(Gamma(2)/(Gamma(1.5) sqrt(3 pi))) = log(2/(sqrt(3) pi))
_LOG_TNU3_NORM = float(np.log(2.0 / (np.sqrt(3.0) * np.pi)))


def log_pdf_tnu3(x, mu, sigma):
    """Student-t nu=3 log-density
    (reference: src/utils/ProbabilityDistributions.cpp LogPdfTnu3)."""
    xn = (x - mu) / sigma
    # t3: Gamma(2)/(Gamma(1.5) sqrt(3 pi)) * (1 + x^2/3)^-2
    return (
        _LOG_TNU3_NORM - 2.0 * jnp.log1p(xn * xn / 3.0) - jnp.log(sigma)
    )


# ---------------------------------------------------------------------------
# cell_cycle_marker


class CellCycleMarkerLikelihood:
    """reference: LikelihoodCellCycleMarker.cpp:44-83. 10 variables:
    [S_entry_time, S_duration, plateau_duration, base_signal,
    S_signal_increase, plateau_signal_increase, mitosis_signal_fraction,
    mitosis_signal_decrease, additive_noise, proportional_noise]."""

    def __init__(self, varset: VariableSet, data: np.ndarray):
        if varset.num_variables != 10:
            raise ValueError(
                "Variable set should contain exactly 10 variables"
            )
        self.data = np.asarray(data, dtype=np.float64)

    def log_prob(self, values):
        i = jnp.arange(len(self.data), dtype=values.dtype)
        s_entry, s_dur, plat_dur = values[0], values[1], values[2]
        plateau_time = s_entry + s_dur
        mitosis_time = plateau_time + plat_dur
        base, s_inc, plat_inc = values[3], values[4], values[5]
        mit_frac, mit_dec = values[6], values[7]
        add_noise, prop_noise = values[8], values[9]

        x = jnp.full_like(i, 0.0) + base
        in_s = (i > s_entry) & (i <= plateau_time)
        in_plateau = (i > plateau_time) & (i <= mitosis_time)
        post = i > mitosis_time
        x = jnp.where(in_s, base + s_inc * (i - s_entry), x)
        x = jnp.where(
            in_plateau, base + s_dur * s_inc + (i - plateau_time) * plat_inc, x
        )
        x = jnp.where(
            post,
            base
            + (s_dur * s_inc + plat_dur * plat_inc) * mit_frac
            - mit_dec * (i - mitosis_time),
            x,
        )
        y = jnp.asarray(self.data, dtype=values.dtype)
        sigma = add_noise + prop_noise * jnp.maximum(x, 0.0)
        pointwise = log_pdf_tnu4(y, x, sigma)
        # NaN data entries are skipped (LogPdfTnu4 skip_na=true)
        return jnp.sum(jnp.where(jnp.isnan(y), 0.0, pointwise))


def create_cell_cycle_marker(varset: VariableSet, attrs):
    import csv

    data_file = attrs.get("data_file")
    track_ix = int(attrs.get("ccm.track_ix", attrs.get("track_ix", "0")))
    with open(data_file) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    # reference CSVParser: first row = header, first column = row label
    body = rows[1:] if len(rows) > 1 else rows
    vals = [
        [float(v) if v not in ("", "na", "NA", "nan") else np.nan for v in r[1:]]
        for r in body
    ]
    data = np.asarray(vals[track_ix])
    return CellCycleMarkerLikelihood(varset, data)


# ---------------------------------------------------------------------------
# mitosis_time_estimation


class MitosisTimeEstimationLikelihood:
    """reference: LikelihoodMitosisTimeEstimation.cpp. Boxcar mitosis
    trajectories with Sobol-quantile durations/starts scaled by sampled
    stdevs, Gaussian trajectory noise, Hungarian-matched to observed."""

    def __init__(self, varset: VariableSet, timepoints, observed):
        self.varset = varset
        self.timepoints = np.asarray(timepoints, dtype=np.float64)
        self.observed = np.asarray(observed, dtype=np.float64)  # (T, ncell)
        ncell = self.observed.shape[1]
        from scipy.stats import norm, qmc

        eng = qmc.Sobol(d=2, scramble=False)
        n_pow2 = 1 << max(0, int(np.ceil(np.log2(max(ncell, 1)))))
        u = np.clip(eng.random(n_pow2)[:ncell], 1e-12, 1 - 1e-12)
        # reference: 2^QuantileNormal(u; 0, 0.5) (cpp:52-57)
        self.sobol_values = np.power(2.0, norm.ppf(u) * 0.5)
        self._ix = {
            name: varset.index_of(name)
            for name in (
                "mitosis_times_stdev",
                "entry_time_stdev",
                "trajectory_noise_stdev",
            )
        }

    def log_prob(self, values):
        mt_sd = jnp.power(10.0, values[self._ix["mitosis_times_stdev"]])
        et_sd = jnp.power(10.0, values[self._ix["entry_time_stdev"]])
        noise_sd = jnp.power(10.0, values[self._ix["trajectory_noise_stdev"]])

        sob = jnp.asarray(self.sobol_values, dtype=values.dtype)
        sim_times = sob[:, 0] * mt_sd  # (ncell,)
        start_times = sob[:, 1] * et_sd
        tp = jnp.asarray(self.timepoints, dtype=values.dtype)  # (T,)
        sim = (
            (tp[None, :] >= start_times[:, None])
            & (tp[None, :] < (start_times + sim_times)[:, None])
        ).astype(values.dtype)  # (ncell_sim, T)

        obs = jnp.asarray(self.observed.T, dtype=values.dtype)  # (ncell, T)
        T = tp.shape[0]
        inv_two = 1.0 / (2.0 * noise_sd * noise_sd)
        C = -jnp.log(noise_sd) - 0.91893853320467274178032973640562
        d = obs[:, None, :] - sim[None, :, :]
        cost = T * C - jnp.sum(d * d, axis=-1) * inv_two  # (obs, sim)
        valid = jnp.ones(cost.shape[0], dtype=bool)
        logp = batched_hungarian(cost, valid, jnp.ones(cost.shape[1], dtype=bool))
        return logp


def create_mitosis_time_estimation(varset: VariableSet, attrs):
    import h5py

    data_file = attrs.get("data_file", "trajectories.nc")
    with h5py.File(data_file, "r") as f:
        g = f["simulation"]
        timepoints = np.asarray(g["time"])
        observed = np.asarray(g["trajectories"])
    return MitosisTimeEstimationLikelihood(varset, timepoints, observed)


# ---------------------------------------------------------------------------
# incucyte_population


@dataclass
class IncucyteExperiment:
    timepoints: np.ndarray  # (T,)
    concentrations: np.ndarray  # (C,) log10
    drug_confluence: np.ndarray  # (T, C, R)
    drug_apoptosis: np.ndarray  # (T, C, R)
    neg_confluence: np.ndarray  # (T, R)
    neg_apoptosis: np.ndarray  # (T, R)
    pos_confluence: np.ndarray  # (T, R)
    pos_apoptosis: np.ndarray  # (T, R)
    ctb: np.ndarray  # (C,)
    treatment_time: float
    seeding_density: float
    experiment_ix: int


class IncucytePopulationLikelihood:
    """reference: src/likelihoods/LikelihoodIncucytePopulation.cpp.
    Variables by name: log10_cell_size, apoptotic_cell_size,
    pao_apoptotic_cell_size, debris_size, apoptosis_marker_size,
    pao_apoptosis_marker_size, debris_apoptosis_marker_size,
    proliferation_rate, apoptosis_rate, apoptosis_duration,
    apoptosis_remove_rate, drug_delay, drug_effect_time, pao_delay,
    pao_effect_time, pao_apoptosis_rate, contact_inhibition_start,
    contact_inhibition_max_confluence, contact_inhibition_apoptosis_rate,
    cell_preadherence_size, cell_adherence_time,
    starting_dead_cell_fraction, seeding_density_deviation_<i>,
    drug_proliferation_rate_<ci>, drug_apoptosis_rate_<ci>,
    sigma_confluence, sigma_apoptosis_marker, sigma_ctb."""

    def __init__(
        self,
        varset: VariableSet,
        experiments: List[IncucyteExperiment],
        use_pao_control: bool = True,
        grid_points: int = 256,
        solver: str = "ring",
        trips_per_interval: int = 8,
        ring_size: int | None = None,
    ):
        self.varset = varset
        self.experiments = experiments
        self.use_pao_control = use_pao_control
        self.grid_points = grid_points
        self.solver = solver
        self.trips_per_interval = trips_per_interval
        # sliding-ring history length: must cover the model's maximum
        # plausible delay in grid steps (delays beyond the ring clamp to
        # its oldest entry); the default covers delays up to ~ a quarter
        # of the horizon. Gather cost scales with ring_size, so tighten it
        # when the delay bound is known.
        self.ring_size = ring_size
        self._ix = {name: i for i, name in enumerate(varset.names)}

    def _v(self, values, name):
        return values[self._ix[name]]

    def _simulate_wells(self, values, e: IncucyteExperiment):
        """Integrate all wells of one experiment as a vmapped batch.
        Wells: [negative, positive(pao), drug_0..drug_{C-1}]."""
        ix = self._ix
        v = lambda name: values[ix[name]]
        C = len(e.concentrations)

        prolif = v("proliferation_rate")
        apo = v("apoptosis_rate") * prolif
        apo_duration = v("apoptosis_duration")
        remove = v("apoptosis_remove_rate")
        cell_size = jnp.power(10.0, v("log10_cell_size")) * 9.174312e-6
        debris_size = v("debris_size") * cell_size

        # per-well drug parameters (reference: EvaluateLogProbability
        # sequential-subtraction parametrization, cpp:205-225)
        rel_prolif = jnp.ones(())
        drug_prolifs = []
        drug_apos = []
        cum_apo = apo
        # reference iterates ci from high to low subtracting; rates for
        # concentration ci accumulate the deltas of all cj >= ci
        rels = []
        for ci in range(C - 1, -1, -1):
            name_p = f"drug_proliferation_rate_{ci + 1}"
            name_a = f"drug_apoptosis_rate_{ci + 1}"
            rel_prolif = jnp.maximum(rel_prolif - v(name_p), 0.0)
            cum_apo = cum_apo + v(name_a)
            rels.append((ci, rel_prolif * prolif, cum_apo))
        order = {ci: (p, a) for ci, p, a in rels}
        drug_prolifs = jnp.stack([order[ci][0] for ci in range(C)])
        drug_apos = jnp.stack([order[ci][1] for ci in range(C)])

        n_wells = 2 + C
        well_is_pao = np.zeros(n_wells, dtype=bool)
        well_is_pao[1] = True
        well_has_drug = np.ones(n_wells, dtype=bool)
        well_has_drug[0] = False

        pao_prolif = jnp.zeros(())
        pao_apo = v("pao_apoptosis_rate")
        w_prolif = jnp.concatenate(
            [jnp.stack([prolif * 0 + jnp.nan, pao_prolif]), drug_prolifs]
        )
        w_apo = jnp.concatenate(
            [jnp.stack([jnp.nan + 0 * apo, pao_apo]), drug_apos]
        )
        delay_t = jnp.where(
            jnp.asarray(well_is_pao), v("pao_delay"), v("drug_delay")
        )
        effect_t = jnp.where(
            jnp.asarray(well_is_pao), v("pao_effect_time"), v("drug_effect_time")
        )
        start_t = e.treatment_time + delay_t

        apoptotic_size = jnp.where(
            jnp.asarray(well_is_pao),
            v("pao_apoptotic_cell_size") * cell_size,
            v("apoptotic_cell_size") * cell_size,
        )

        ci_start = v("contact_inhibition_start")
        ci_max = v("contact_inhibition_max_confluence")

        seed_dev = v(f"seeding_density_deviation_{e.experiment_ix + 1}")
        dead_frac = v("starting_dead_cell_fraction")
        n0 = e.seeding_density * jnp.power(10.0, seed_dev)
        y0 = jnp.stack([n0 * (1.0 - dead_frac), dead_frac * n0, jnp.zeros(())])

        grid = jnp.linspace(
            0.0, float(e.timepoints[-1]), self.grid_points
        )

        has_drug = jnp.asarray(well_has_drug)

        def rhs(t, y, yd, args):
            wp, wa, st, et, asize, hd = args
            # drug ramp (reference: CalculateDrugEffect:414-425)
            frac = jnp.clip((t - st) / jnp.maximum(et, 1e-12), 0.0, 1.0)
            frac = jnp.where(hd & (t >= st), frac, 0.0)
            p_eff = (1.0 - frac) * prolif + frac * jnp.where(
                jnp.isnan(wp), prolif, wp
            )
            a_eff = (1.0 - frac) * apo + frac * jnp.where(
                jnp.isnan(wa), apo, wa
            )
            # contact inhibition (reference: :426-439)
            confl = 0.01 * (
                y[0] * cell_size + y[1] * asize + y[2] * debris_size
            )
            ci = jnp.clip(
                (confl - ci_start) / jnp.maximum(ci_max - ci_start, 1e-12),
                0.0,
                1.0,
            )
            p_eff = jnp.where(confl > ci_start, p_eff * (1.0 - ci), p_eff)
            return jnp.stack(
                [
                    (p_eff - a_eff) * y[0],
                    a_eff * y[0] - remove * yd[1],
                    remove * yd[1],
                ]
            )

        def solve_well(wp, wa, st, et, asize, hd):
            # Default: fixed-grid RK4 with the sliding-ring history
            # (ode/delay.py solve_dde_ring) for this smooth, slow DDE: it
            # avoids per-lane delayed lookups into the full history
            # buffer, which lower to batched gathers. Accuracy matches the adaptive controller to ~2e-6 relative
            # logp at G=256 (tests/test_small_expm.py) — far inside the
            # reference's loose incucyte tolerances (rel 1e-6/abs 1e-2,
            # LikelihoodIncucytePopulation.cpp:131) — and the trip-capped
            # adaptive form is measurably LESS robust (budget exhaustion
            # soft-fails lanes the fixed grid integrates fine). The
            # grid/adaptive/budget forms remain as regression oracles.
            if self.solver == "fixed":
                res = solve_dde_grid(
                    rhs, y0, grid, apo_duration,
                    args=(wp, wa, st, et, asize, hd),
                )
            elif self.solver == "ring":
                from bcm3_tpu.ode.delay import solve_dde_ring

                res = solve_dde_ring(
                    rhs, y0, grid, apo_duration,
                    args=(wp, wa, st, et, asize, hd),
                    ring_size=self.ring_size
                    or max(16, self.grid_points // 4),
                )
            elif self.solver == "budget":
                from bcm3_tpu.ode.delay import solve_dde_budget

                res = solve_dde_budget(
                    rhs, y0, grid, apo_duration,
                    args=(wp, wa, st, et, asize, hd),
                    rtol=1e-6, atol=1e-2,
                    total_trips=max(2 * self.grid_points, 512),
                )
            else:
                # per-interval adaptive: history recording uses the
                # UNIFORM scan index, which lowers to cheap
                # dynamic-update-slices instead of the per-lane scatter
                # of the budget form; the trip
                # budget per interval is small because the incucyte
                # dynamics need ~1 accepted step per grid interval
                res = solve_dde_adaptive(
                    rhs, y0, grid, apo_duration,
                    args=(wp, wa, st, et, asize, hd),
                    rtol=1e-6, atol=1e-2,
                    trips_per_interval=self.trips_per_interval,
                )
            tp = jnp.asarray(e.timepoints, dtype=values.dtype)
            ys = jax.vmap(
                lambda col: jnp.interp(tp, grid, col)
            )(res.ys.T)  # (3, T)
            return ys, res.ok

        ys, oks = jax.vmap(solve_well)(
            w_prolif, w_apo, start_t, effect_t, apoptotic_size, has_drug
        )  # ys: (n_wells, 3, T)
        return ys, jnp.all(oks), apoptotic_size, cell_size, debris_size

    def simulate_experiment(self, values, e: IncucyteExperiment):
        """All derived observables of one experiment's wells: the batched
        analogue of the reference's GetSimulatedCellCount /
        ApoptoticCellCount / Debris / Confluence / ApoptosisMarker / CTB
        accessors (reference: LikelihoodIncucytePopulation.h:28-35,
        consumed by interface_incucyte.cpp:55-121). Wells are ordered
        [negative, positive(pao), drug_0..drug_{C-1}]; all matrices are
        (n_wells, T)."""
        ix = self._ix
        v = lambda name: values[ix[name]]
        cell_size = jnp.power(10.0, v("log10_cell_size")) * 9.174312e-6
        marker_size = v("apoptosis_marker_size") * cell_size
        pao_marker_size = v("pao_apoptosis_marker_size") * cell_size
        debris_marker_size = v("debris_apoptosis_marker_size") * marker_size
        debris_size = v("debris_size") * cell_size
        pre_size = v("cell_preadherence_size")
        adh_time = v("cell_adherence_time")

        ys, ok, asize, _, _ = self._simulate_wells(values, e)
        tp = jnp.asarray(e.timepoints, dtype=values.dtype)
        size_factor = jnp.where(
            tp < adh_time,
            pre_size + (1.0 - pre_size) * tp / jnp.maximum(adh_time, 1e-12),
            1.0,
        )  # (T,)
        confluence = (
            ys[:, 0, :] * cell_size * size_factor[None, :]
            + ys[:, 1, :] * asize[:, None]
            + ys[:, 2, :] * debris_size
        )  # (n_wells, T)
        msize = jnp.where(
            jnp.asarray([False, True] + [False] * len(e.concentrations)),
            pao_marker_size,
            marker_size,
        )
        marker = jnp.where(
            tp[None, :] < e.treatment_time,
            0.0,
            ys[:, 1, :] * msize[:, None] + ys[:, 2, :] * debris_marker_size,
        )
        # CTB: final-time cell count relative to the negative control
        neg_final = ys[0, 0, -1]
        ctb_sim = jnp.where(neg_final > 0.0, ys[2:, 0, -1] / neg_final, 0.0)
        return {
            "cell_count": ys[:, 0, :],
            "apoptotic_cell_count": ys[:, 1, :],
            "debris": ys[:, 2, :],
            "confluence": confluence,
            "apoptosis_marker": marker,
            "ctb": ctb_sim,
            "ok": ok,
        }

    def log_prob(self, values):
        ix = self._ix
        v = lambda name: values[ix[name]]
        sigma_confl = v("sigma_confluence")
        sigma_apo = v("sigma_apoptosis_marker")
        sigma_ctb = v("sigma_ctb")

        total = jnp.zeros((), dtype=values.dtype)
        all_ok = jnp.asarray(True)
        for e in self.experiments:
            sim = self.simulate_experiment(values, e)
            all_ok = all_ok & sim["ok"]
            confluence = sim["confluence"]
            marker = sim["apoptosis_marker"]

            factor = 0.25 / len(e.timepoints)

            def well_lp(sim_c, sim_m, obs_c, obs_m):
                lc = log_pdf_tnu3(obs_c, sim_c[:, None], sigma_confl)
                lm = log_pdf_tnu3(obs_m, sim_m[:, None], sigma_apo)
                lc = jnp.where(jnp.isnan(obs_c), 0.0, lc)
                lm = jnp.where(jnp.isnan(obs_m), 0.0, lm)
                return factor * (jnp.sum(lc) + jnp.sum(lm))

            total = total + well_lp(
                confluence[0],
                marker[0],
                jnp.asarray(e.neg_confluence, dtype=values.dtype),
                jnp.asarray(e.neg_apoptosis, dtype=values.dtype),
            )
            if self.use_pao_control:
                total = total + well_lp(
                    confluence[1],
                    marker[1],
                    jnp.asarray(e.pos_confluence, dtype=values.dtype),
                    jnp.asarray(e.pos_apoptosis, dtype=values.dtype),
                )
            C = len(e.concentrations)
            for ci in range(C):
                total = total + well_lp(
                    confluence[2 + ci],
                    marker[2 + ci],
                    jnp.asarray(e.drug_confluence[:, ci, :], dtype=values.dtype),
                    jnp.asarray(e.drug_apoptosis[:, ci, :], dtype=values.dtype),
                )
            obs_ctb = jnp.asarray(e.ctb, dtype=values.dtype)
            lp_ctb = log_pdf_tnu3(obs_ctb, sim["ctb"], sigma_ctb)
            total = total + jnp.sum(jnp.where(jnp.isnan(obs_ctb), 0.0, lp_ctb))

        return jnp.where(all_ok & jnp.isfinite(total), total, -jnp.inf)


def load_incucyte_experiments(
    data_file: str, drug: str, cell_line: str
) -> List[IncucyteExperiment]:
    import h5py

    out = []
    with h5py.File(data_file, "r") as f:
        base = f[drug][cell_line]
        names = sorted(k for k in base.keys() if k.startswith("experiment"))
        for ei, name in enumerate(names):
            g = base[name]
            out.append(
                IncucyteExperiment(
                    timepoints=np.asarray(g["time"], dtype=np.float64),
                    concentrations=np.log10(
                        np.asarray(g["drug_concentrations"], dtype=np.float64)
                    ),
                    drug_confluence=np.asarray(g["drug_confluence"]),
                    drug_apoptosis=np.asarray(g["drug_apoptosis_marker"]),
                    neg_confluence=np.asarray(g["negative_control_confluence"]),
                    neg_apoptosis=np.asarray(
                        g["negative_control_apoptosis_marker"]
                    ),
                    pos_confluence=np.asarray(g["positive_control_confluence"]),
                    pos_apoptosis=np.asarray(
                        g["positive_control_apoptosis_marker"]
                    ),
                    ctb=np.asarray(g["cell_titer_blue_norm"]),
                    treatment_time=float(g.attrs["treatment_time"]),
                    seeding_density=float(g.attrs["seeding_density"]),
                    experiment_ix=ei,
                )
            )
    return out


def create_incucyte_population(varset: VariableSet, attrs):
    root = attrs.get("_xml_root")
    drug = root.get("drug") if root is not None else attrs.get("drug")
    cell_line = (
        root.get("cell_line") if root is not None else attrs.get("cell_line")
    )
    data_file = attrs.get("data_file", "drug_response_data.nc")
    if root is not None and root.get("data_file"):
        data_file = root.get("data_file")
    experiments = load_incucyte_experiments(data_file, drug, cell_line)
    use_pao = attrs.get("use_pao_control", "true")
    if root is not None and root.get("use_pao_control"):
        use_pao = root.get("use_pao_control")
    return IncucytePopulationLikelihood(
        varset,
        experiments,
        use_pao_control=str(use_pao).lower() in ("1", "true"),
    )
