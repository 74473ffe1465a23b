"""fISA likelihood: steady-state signaling activities vs observed data.

JAX equivalent of the reference fISA likelihood layer
(reference: src/fISA/fISALikelihood.cpp, fISAExperiment.cpp,
fISAExperimentSingleCondition.cpp). Single-condition experiments are
supported: per-cell-line steady-state solves (vmapped over cell lines —
the reference fans them out over a thread pool,
fISAExperimentSingleCondition.cpp StartEvaluateLogProbability) with
data parts mapping activities to measurements via optional base/scale
parameters and normal / truncated-normal / student-t / truncated-t
error models (ParseDataPartBase:243-330, EvaluateCellLine:60-200).

The Incucyte-sequential experiment variant
(fISAExperimentIncucyteSequential.cpp:24-341) is implemented as
`FISAExperimentIncucyteSequential`: per-(cell line, drug concentration)
steady-state solves with the drug node preset to each concentration and a
3-component bivariate-t mixture data likelihood on the
(proliferation, apoptosis) pair, optionally relative to a stored
single-condition experiment's proliferation. The reference's drug-range
variant (fISAExperimentDrugRange.cpp) is compiled out upstream
(`#if TODO`, dead code) and is intentionally not reproduced.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.distributions.univariate import (
    logpdf_normal,
    logpdf_t,
    logpdf_truncated_normal,
    logpdf_truncated_t,
)
from bcm3_tpu.fisa.network import SignalingNetwork
from bcm3_tpu.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)


@dataclass
class DataPart:
    """One <data> element (reference: ParseDataPartBase:243-330)."""

    model_ix: int
    data: np.ndarray  # (n_replicates, n_cell_lines)
    likelihood_fn: str = "studentt"
    weight: float = 1.0
    use_base: bool = True
    use_scale: bool = True
    scale_var_with_mean: bool = True
    data_is_inactive_form: bool = False
    scale_per_cell_line: bool = False
    base_ix: Optional[int] = None
    fixed_base: float = 0.0
    scale_ix: Optional[int] = None
    sd_ix: Optional[int] = None
    fixed_sd: float = np.nan
    expression_ix: Optional[int] = None


@dataclass
class Condition:
    model_ix: int
    values: Optional[np.ndarray] = None  # (n_cell_lines,)
    parameter_ix: Optional[int] = None


@dataclass
class ExpressionLevel:
    model_ix: int
    values: np.ndarray  # (n_cell_lines,)
    base_ix: Optional[int] = None
    scale_ix: Optional[int] = None


class FISAExperiment:
    def __init__(
        self,
        node: ET.Element,
        varset: VariableSet,
        base_dir: str = ".",
    ):
        self.name = node.get("name")
        self.varset = varset
        model_file = node.get("model_file")
        if not os.path.isabs(model_file):
            model_file = os.path.join(base_dir, model_file)
        self.network = SignalingNetwork.from_sbml(
            model_file,
            varset,
            activation_limit=node.get("activation_limit", "minmax"),
            # reference: fISALikelihood.cpp:31 — default 10 Sobol-started
            # root solves per feedback component
            multiroot_solves=int(node.get("multiroot_solves", "10")),
        )

        data_file = node.get("data_file")
        if not os.path.isabs(data_file):
            data_file = os.path.join(base_dir, data_file)
        import h5py

        self.base_dir = base_dir
        self.conditions: List[Condition] = []
        self.expression_levels: List[ExpressionLevel] = []
        self.data_parts: List[DataPart] = []
        with h5py.File(data_file, "r") as f:
            g = f[self.name]
            cl = g["cell_lines"]
            self.cell_lines = [
                c.decode() if isinstance(c, bytes) else str(c) for c in cl
            ]
            P = len(self.cell_lines)
            self._parse_type_specific(node, g)

            for cnode in node:
                if cnode.tag in ("condition", "mutation"):
                    mix = self.network.molecule_ix_by_name(
                        cnode.get("species_name")
                    )
                    c = Condition(model_ix=mix)
                    if cnode.get("data_name"):
                        c.values = self._read_2d(g, cnode.get("data_name"), P)
                    elif cnode.get("variable_name"):
                        c.parameter_ix = varset.index_of(
                            cnode.get("variable_name")
                        )
                    else:
                        c.values = np.full(P, float(cnode.get("value")))
                    self.conditions.append(c)
                elif cnode.tag == "expression_level":
                    name = cnode.get("species_name")
                    mix = self.network.molecule_ix_by_name(name)
                    if cnode.get("data_name"):
                        values = self._read_2d(g, cnode.get("data_name"), P)
                    else:
                        values = np.full(P, float(cnode.get("value")))
                    el = ExpressionLevel(model_ix=mix, values=values)
                    base_name = cnode.get(
                        "base_parameter", f"base_expression[{name}]"
                    )
                    scale_name = cnode.get(
                        "scale_parameter", f"scale_expression[{name}]"
                    )
                    if base_name in varset.names:
                        el.base_ix = varset.index_of(base_name)
                    if scale_name in varset.names:
                        el.scale_ix = varset.index_of(scale_name)
                    self.expression_levels.append(el)
                elif cnode.tag == "data":
                    self._parse_data_node(cnode, g, P)

    def _parse_type_specific(self, node, g):
        """Hook for experiment-type-specific XML nodes
        (reference: fISAExperiment::LoadTypeSpecificNodes)."""

    def _parse_data_node(self, cnode, g, P):
        self.data_parts.append(self._parse_data(cnode, g, P))

    @staticmethod
    def _read_2d(g, data_name: str, P: int) -> np.ndarray:
        """'name[i]' references row i of a 2-D [rows, cell_lines] dataset
        (reference: ParseDataFileReference)."""
        if "[" in data_name:
            base, rest = data_name.split("[", 1)
            ix = int(rest.rstrip("]"))
            return np.asarray(g[base][ix][:P], dtype=np.float64)
        arr = np.asarray(g[data_name], dtype=np.float64)
        return arr[:P] if arr.ndim == 1 else arr[0][:P]

    def _parse_data(self, node, g, P: int) -> DataPart:
        varset = self.varset
        name = node.get("species_name")
        mix = self.network.molecule_ix_by_name(name)
        raw = np.asarray(g[node.get("data_name")], dtype=np.float64)
        if raw.ndim == 1:
            raw = raw[None, :]
        suffix = node.get("base_scale_sd_suffix", "")
        dp = DataPart(
            model_ix=mix,
            data=raw,
            likelihood_fn=node.get("likelihood_function", "studentt"),
            weight=float(node.get("weight", "1.0")),
            use_base=node.get("use_base", "true").lower() in ("1", "true"),
            use_scale=node.get("use_scale", "true").lower() in ("1", "true"),
            scale_var_with_mean=node.get("scale_var_with_mean", "true").lower()
            in ("1", "true"),
            data_is_inactive_form=node.get(
                "data_is_inactive_form", "false"
            ).lower()
            in ("1", "true"),
        )
        if dp.likelihood_fn not in (
            "normal",
            "truncated_normal",
            "studentt",
            "truncated_t",
        ):
            raise ValueError(
                f"Unsupported likelihood function '{dp.likelihood_fn}'"
            )
        if dp.use_base:
            base_str = node.get("base", f"base_{suffix}")
            if base_str in varset.names:
                dp.base_ix = varset.index_of(base_str)
            else:
                dp.fixed_base = float(base_str)
        if dp.use_scale:
            dp.scale_ix = varset.index_of(f"scale_{suffix}")
        sd_str = node.get("sd", f"sd_{suffix}")
        if sd_str in varset.names:
            dp.sd_ix = varset.index_of(sd_str)
        else:
            dp.fixed_sd = float(sd_str)
        expr = node.get("expression", "")
        if expr:
            dp.expression_ix = self.network.molecule_ix_by_name(expr)
        return dp

    # ------------------------------------------------------------------

    def _prepare(self, tv, cell_ix):
        """Preset activities + expression for one cell line
        (reference: fISAExperiment PrepareActivitiesCalculation)."""
        n = self.network.num_molecules
        activities = jnp.full((n,), jnp.nan)
        # drugs default to concentration 0
        for i, m in enumerate(self.network.molecules):
            if m.mtype == "Drug":
                activities = activities.at[i].set(0.0)
        for c in self.conditions:
            if c.parameter_ix is not None:
                val = tv[c.parameter_ix]
            else:
                val = jnp.asarray(c.values)[cell_ix]
            activities = activities.at[c.model_ix].set(val)

        expression = jnp.ones((n,))
        for el in self.expression_levels:
            v = jnp.asarray(el.values)[cell_ix]
            if el.base_ix is not None and el.scale_ix is not None:
                e = (v - tv[el.base_ix]) / tv[el.scale_ix]
            elif el.base_ix is not None:
                e = (v - tv[el.base_ix]) / (1.0 - tv[el.base_ix])
            else:
                e = v
            expression = expression.at[el.model_ix].set(jnp.clip(e, 0.0, 1.0))
        return activities, expression

    def log_prob(self, tv):
        """Experiment logp over all cell lines (vmapped solves)."""
        logp, _ = self.log_prob_and_activities(tv, {})
        return logp

    def _data_logp(self, activities, expression, tv, cell_ix):
        """Data log-probability of one activity vector for one cell line
        (reference: fISAExperimentSingleCondition.cpp EvaluateCellLine
        data loop, :195-409)."""
        logp = jnp.zeros(())
        for d in self.data_parts:
            z = activities[d.model_ix]
            if d.data_is_inactive_form:
                me = self.network.max_expression(d.model_ix, expression, tv)
                z = me - z
            if d.expression_ix is not None:
                z = z * expression[d.expression_ix]
            if d.use_scale and d.scale_ix is not None:
                z = z * tv[d.scale_ix]
            if d.use_base:
                z = z + (
                    tv[d.base_ix] if d.base_ix is not None else d.fixed_base
                )
            sd = (
                tv[d.sd_ix]
                if d.sd_ix is not None
                else jnp.asarray(d.fixed_sd)
            )
            if d.scale_var_with_mean:
                sd = sd * jnp.abs(z)
            obs = jnp.asarray(d.data)[:, cell_ix]  # (n_replicates,)
            if d.likelihood_fn == "normal":
                pw = logpdf_normal(obs, z, sd)
            elif d.likelihood_fn == "truncated_normal":
                pw = logpdf_truncated_normal(obs, z, sd, 0.0, 1.0)
            elif d.likelihood_fn == "truncated_t":
                zc = jnp.minimum(z, 1.0)
                pw = logpdf_truncated_t(obs, zc, sd, 3.0, 0.0, 1.0)
            else:  # studentt (nu=3, reference LogPdfTnu3)
                pw = logpdf_t(obs, z, sd, 3.0)
            logp = logp + d.weight * jnp.sum(
                jnp.where(jnp.isnan(obs), 0.0, pw)
            )
        return logp

    def log_prob_and_activities(self, tv, stored):
        """Logp plus per-cell-line steady-state activities (P, n_molecules).

        Every feedback component is root-solved from the network's
        multiroot Sobol starts; each solve's activities are scored
        against the data and the best root per cell line is kept —
        its logp is the cell line's contribution and its activities are
        this experiment's `stored_activities`
        (reference: fISAExperimentSingleCondition.cpp:184-230,412-425)
        which later-defined relative experiments read. The M solves and
        their scoring are vmapped.
        """
        P = len(self.cell_lines)

        def cell_line_logp(cell_ix):
            preset, expression = self._prepare(tv, cell_ix)
            acts_m = self.network.calculate_multiroot(
                tv, expression, preset
            )  # (M, n_molecules)
            logps_m = jax.vmap(
                lambda a: self._data_logp(a, expression, tv, cell_ix)
            )(acts_m)
            best = jnp.argmax(logps_m)
            return logps_m[best], acts_m[best]

        logps, acts = jax.vmap(cell_line_logp)(jnp.arange(P))
        return jnp.sum(logps), acts

    # -- model accessors (reference: bcmrbridge interface_fISA.cpp:40-192) --

    def observed_data(self, data_ix: int) -> np.ndarray:
        """(n_replicates, n_cell_lines) observed matrix for one data part."""
        return np.asarray(self.data_parts[data_ix].data)

    def modeled_activities(self, tv) -> jnp.ndarray:
        """(n_cell_lines, n_molecules) steady-state activities.

        Pure recomputation replaces the reference's per-thread stored
        state (fISAExperimentSingleCondition.cpp:87)."""
        _, acts = self.log_prob_and_activities(jnp.asarray(tv), {})
        return acts

    def modeled_data(self, tv, data_ix: int) -> jnp.ndarray:
        """(n_cell_lines,) modeled values for one data part after
        base/scale/inactive-form adjustments."""
        tv = jnp.asarray(tv)
        acts = self.modeled_activities(tv)
        d = self.data_parts[data_ix]
        z = acts[:, d.model_ix]
        P = len(self.cell_lines)
        if d.data_is_inactive_form:
            me = jax.vmap(
                lambda ci: self.network.max_expression(
                    d.model_ix, self._prepare(tv, ci)[1], tv
                )
            )(jnp.arange(P))
            z = me - z
        if d.expression_ix is not None:
            expr = jax.vmap(lambda ci: self._prepare(tv, ci)[1])(
                jnp.arange(P)
            )
            z = z * expr[:, d.expression_ix]
        if d.use_scale and d.scale_ix is not None:
            z = z * tv[d.scale_ix]
        if d.use_base:
            z = z + (tv[d.base_ix] if d.base_ix is not None else d.fixed_base)
        return z


class FISAExperimentIncucyteSequential(FISAExperiment):
    """Drug-response experiment over a concentration range
    (reference: fISAExperimentIncucyteSequential.cpp:24-341).

    For every (cell line, drug concentration) pair the network is solved
    with the drug node's activity preset to the concentration
    (EvaluateCellLine:271), and the modeled (proliferation, apoptosis)
    pair is scored against a per-pair 3-component bivariate Student-t
    mixture whose parameters come from a tab-separated estimate file
    (ParseDataNode:204-228, EvaluateCellLine:311-330). Pairs whose second
    mixture mean is NaN are skipped (:312). With `type="relative"` the
    proliferation is taken relative to a previously defined
    single-condition experiment's stored activity (:279-282).

    All (cell line × concentration) solves run as one vmapped batch —
    the reference fans cell lines out over a thread pool
    (StartEvaluateLogProbability:37-40) and loops concentrations serially.
    """

    def _parse_type_specific(self, node, g):
        dr = node.find("drug_range")
        if dr is None:
            raise ValueError(
                "incucyte_sequential experiment requires a <drug_range> node"
            )
        self.drug_species_name = dr.get("species_name")
        self.drug_model_ix = self.network.molecule_ix_by_name(
            self.drug_species_name
        )
        conc = dr.get("concentrations", "")
        if conc:
            self.drug_concentrations = np.asarray(
                [float(x) for x in conc.replace(",", ";").split(";") if x],
                dtype=np.float64,
            )
        else:
            self.drug_concentrations = np.asarray(
                g[dr.get("concentrations_data_name")], dtype=np.float64
            )
        self.prolif_ix = self.network.molecule_ix_by_name("proliferation")
        self.apop_ix = self.network.molecule_ix_by_name("apoptosis")
        self.relative_reference: Optional[str] = None
        self._relative_exp: Optional[FISAExperiment] = None

    def _parse_data_node(self, cnode, g, P):
        """Load the per-(cell line, concentration) bivariate-t mixture
        table (reference ParseDataNode:204-228; the reference hardcodes
        9 rows per cell line — generalized here to n_concentrations)."""
        path = cnode.get("data_file_base")
        if not os.path.isabs(path):
            path = os.path.join(self.base_dir, path)
        table = np.genfromtxt(path, delimiter="\t", dtype=np.float64)
        if table.ndim == 1:
            table = table[None, :]
        C = len(self.drug_concentrations)
        K = 3
        self.mup = np.full((P, C, K), np.nan)
        self.mua = np.full((P, C, K), np.nan)
        self.invcov = np.zeros((P, C, K, 2, 2))
        self.logncweight = np.full((P, C, K), -np.inf)
        for i in range(P):
            for ci in range(C):
                row = table[i * C + ci]
                for ki in range(K):
                    self.mup[i, ci, ki] = row[ki * 5 + 0]
                    self.mua[i, ci, ki] = row[ki * 5 + 1]
                    cov = np.array(
                        [
                            [row[ki * 5 + 2], row[ki * 5 + 3]],
                            [row[ki * 5 + 3], row[ki * 5 + 4]],
                        ]
                    )
                    w = row[5 * K + ki]
                    det = cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0]
                    if w > 0 and np.isfinite(det) and det > 0:
                        self.invcov[i, ci, ki] = np.linalg.inv(cov)
                        self.logncweight[i, ci, ki] = np.log(w) - np.log(
                            2 * np.pi * np.sqrt(det)
                        )
        # skip pairs whose second component mean is NaN (reference :312)
        self.pair_valid = ~(
            np.isnan(self.mup[:, :, 1]) | np.isnan(self.mua[:, :, 1])
        )
        # per-component validity: NaN means/weight-0 components must not
        # enter the computation at all — masking only the VALUE leaves
        # NaN in the gradient (0 * NaN = NaN under autodiff)
        self.comp_valid = (
            np.isfinite(self.mup)
            & np.isfinite(self.mua)
            & np.isfinite(self.logncweight)
        )
        self.mup_safe = np.where(self.comp_valid, self.mup, 0.0)
        self.mua_safe = np.where(self.comp_valid, self.mua, 0.0)
        if cnode.get("type", "") == "relative":
            self.relative_reference = cnode.get("relative_reference")

    def log_prob_and_activities(self, tv, stored):
        P = len(self.cell_lines)
        C = len(self.drug_concentrations)
        concs = jnp.asarray(self.drug_concentrations)
        ref_prolif = None
        if self.relative_reference is not None:
            if self.relative_reference in stored:
                ref_acts = stored[self.relative_reference]
            else:
                # standalone accessor call (log_prob/modeled_activities):
                # recompute the reference experiment's activities directly
                if self._relative_exp is None:
                    raise ValueError(
                        f"Relative experiment '{self.relative_reference}' "
                        "has not been resolved; it must be defined before "
                        "this one and be single-condition"
                    )
                _, ref_acts = self._relative_exp.log_prob_and_activities(
                    tv, {}
                )
            ref_prolif = ref_acts[:, self.prolif_ix]

        def solve_one(cell_ix, dci):
            preset, expression = self._prepare(tv, cell_ix)
            preset = preset.at[self.drug_model_ix].set(concs[dci])
            return self.network.calculate(tv, expression, preset)

        acts = jax.vmap(
            lambda ci: jax.vmap(lambda dci: solve_one(ci, dci))(
                jnp.arange(C)
            )
        )(jnp.arange(P))  # (P, C, n_molecules)

        prolif = acts[:, :, self.prolif_ix]
        apop = acts[:, :, self.apop_ix]
        if ref_prolif is not None:
            prolif = prolif - ref_prolif[:, None]

        valid = jnp.asarray(self.comp_valid)
        tx = prolif[:, :, None] - jnp.asarray(self.mup_safe)  # (P, C, K)
        ta = apop[:, :, None] - jnp.asarray(self.mua_safe)
        iv = jnp.asarray(self.invcov)
        q = (
            iv[..., 0, 0] * tx * tx
            + iv[..., 1, 1] * ta * ta
            + (iv[..., 0, 1] + iv[..., 1, 0]) * tx * ta
        )
        # bivariate t(nu=3): lognc_k - (nu+2)/2 * log1p(q/nu)
        lognc = jnp.where(valid, jnp.asarray(self.logncweight), 0.0)
        kp = jnp.where(valid, lognc - 2.5 * jnp.log1p(q / 3.0), -jnp.inf)
        pair_lp = jax.scipy.special.logsumexp(kp, axis=-1)  # (P, C)
        logp = jnp.sum(jnp.where(jnp.asarray(self.pair_valid), pair_lp, 0.0))
        # stored activities = lowest-concentration solve (reference
        # GetModeledActivities:87-93 reports activities[ci][0])
        return logp, acts[:, 0, :]

    # -- model accessors (reference interface & GetObserved/ModeledData) --

    def observed_data(self, data_ix: int) -> np.ndarray:
        """(n_cell_lines, 1): first-component mean of proliferation
        (even data_ix) or apoptosis (odd) at concentration data_ix//2
        (reference GetObservedData:61-72)."""
        dci = data_ix // 2
        src = self.mup if data_ix % 2 == 0 else self.mua
        return src[:, dci, 0][:, None]

    def modeled_data(self, tv, data_ix: int) -> jnp.ndarray:
        tv = jnp.asarray(tv)
        P = len(self.cell_lines)
        concs = jnp.asarray(self.drug_concentrations)
        dci = data_ix // 2
        mix = self.prolif_ix if data_ix % 2 == 0 else self.apop_ix

        def solve_one(cell_ix):
            preset, expression = self._prepare(tv, cell_ix)
            preset = preset.at[self.drug_model_ix].set(concs[dci])
            return self.network.calculate(tv, expression, preset)[mix]

        return jax.vmap(solve_one)(jnp.arange(P))


class FISALikelihood:
    """Sum over experiments (reference: fISALikelihood.cpp:87-106)."""

    def __init__(self, experiments: List[FISAExperiment], varset: VariableSet):
        self.experiments = experiments
        self.varset = varset
        self._transforms = np.asarray(varset.transforms)

    def _transform(self, values):
        t = jnp.asarray(self._transforms)
        x = values
        x = jnp.where(t == TRANSFORM_LOG, jnp.exp(values), x)
        x = jnp.where(t == TRANSFORM_LOG10, jnp.power(10.0, values), x)
        x = jnp.where(t == TRANSFORM_LOGIT, 1.0 / (1.0 + jnp.exp(-values)), x)
        return x

    def log_prob(self, values):
        tv = self._transform(values)
        logp = jnp.zeros((), dtype=values.dtype)
        stored = {}
        for exp in self.experiments:
            lp, acts = exp.log_prob_and_activities(tv, stored)
            stored[exp.name] = acts
            logp = logp + lp
        return jnp.where(jnp.isnan(logp), -jnp.inf, logp)


def create_fisa_likelihood(varset: VariableSet, attrs):
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("fISA likelihood requires an XML definition")
    xml_path = attrs.get("_xml_path")
    base_dir = os.path.dirname(xml_path) if xml_path else "."
    experiment_types = {
        "single_condition": FISAExperiment,
        "incucyte_sequential": FISAExperimentIncucyteSequential,
    }
    experiments = []
    for node in root.findall("experiment"):
        etype = node.get("type", "single_condition")
        if etype not in experiment_types:
            # drug_range is dead code upstream (#if TODO); anything else
            # matches the reference's "Unknown experiment type" error
            raise ValueError(f"Unknown experiment type '{etype}'")
        experiments.append(experiment_types[etype](node, varset, base_dir))
    # resolve relative references to experiment objects (reference:
    # fISAExperimentIncucyteSequential::ParseDataNode:231-254 — the
    # target must be an earlier-defined single-condition experiment)
    by_name: dict = {}
    for exp in experiments:
        ref = getattr(exp, "relative_reference", None)
        if ref is not None:
            target = by_name.get(ref)
            if target is None or isinstance(
                target, FISAExperimentIncucyteSequential
            ):
                raise ValueError(
                    f"Experiment '{exp.name}' is relative to '{ref}', which "
                    "must be an earlier-defined single-condition experiment"
                )
            exp._relative_exp = target
        by_name[exp.name] = exp
    if not experiments:
        raise ValueError("fISA likelihood requires at least one experiment")
    return FISALikelihood(experiments, varset)
