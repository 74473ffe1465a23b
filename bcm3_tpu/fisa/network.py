"""fISA steady-state signaling network, compiled to a jittable solve.

JAX equivalent of the reference SignalingNetwork
(reference: src/fISA/SignalingNetwork.cpp). The reference compiles a
CellDesigner SBML influence graph (POSITIVE/NEGATIVE_INFLUENCE
reactions, one reactant -> one product) into a fixed structure, orders
its strongly connected components topologically, computes singleton
activities directly and solves feedback components with Newton
iteration on a sparsity-exploiting LU (EigenPartialPivLUSomewhatSparse).

Here the same structure compiles into a pure jnp computation: the SCC
order is resolved on the host at load time; singleton components are
closed-form; feedback components run a fixed number of damped Newton
steps with jax.jacfwd providing the Jacobian. The whole solve is
differentiable and vmaps over cell lines / chains.

Semantics preserved:
- activation input = base + sum of +-strength * parent activity (linear)
  or logistic(parent; steepness, inflection) (nonlinear), with drug
  inhibition factors (Precalculate:722-787, CalculateActivationInput:
  839-905);
- activation limits minmax / logistic (fixed k = 9.19024 around 0.5)
  (SignalingNetwork.cpp:13-24, Calculate:575-585);
- expression multiplies activity, optionally mixed via
  expression_mixing[name] (expression_function:42-50);
- drug effects: inhibit_activity (attenuates the parent's outgoing
  signals), inhibit_activation (multiplies the inhibition term),
  activate (adds signal), alter_susceptibility (multiplies by a
  susceptibility parameter), each optionally with an
  maxinhib/ic50/logsteepness dose-response (Precalculate:738-780);
- parameter naming: base_<n>, strength_<p>_<c>, inflection_<p>_<c>,
  steepness_<p>_<c>, maxinhib_<p>_<c>, ic50_<p>_<c>,
  logsteepness_<p>_<c>, <p>_<c>_susceptibility, expression_mixing[<n>]
  (Initialize:340-430).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

FIXED_K = 9.19024  # reference: SignalingNetwork.cpp:17-24


def logistic_activation_fixed(x):
    return jnp.where(
        x > 3.5, 1.0, 1.0 / (1.0 + jnp.exp(-FIXED_K * (x - 0.5)))
    )


def logistic_activation(x, steepness, inflection):
    return 1.0 / (1.0 + jnp.exp(-steepness * (x - inflection)))


TYPE_PROTEIN = "Protein"
TYPE_MRNA = "mRNA"
TYPE_SMALL_MOLECULE = "SmallMolecule"
TYPE_MUTATION = "Mutation"
TYPE_COMPLETE_LOSS = "CompleteLossMutation"
TYPE_DRUG = "Drug"
TYPE_PHENOTYPE = "Phenotype"
TYPE_UNKNOWN = "Unknown"
TYPE_TRANSPORTER = "DrugTransporter"

_CLASS_MAP = {
    "PROTEIN": TYPE_PROTEIN,
    "RNA": TYPE_MRNA,
    "SIMPLE_MOLECULE": TYPE_SMALL_MOLECULE,
    "GENE": TYPE_MUTATION,
    "DRUG": TYPE_DRUG,
    "PHENOTYPE": TYPE_PHENOTYPE,
    "UNKNOWN": TYPE_UNKNOWN,
}

DRUG_INHIBIT_ACTIVITY = "inhibit activity"
DRUG_INHIBIT_ACTIVITY_ALTER = "inhibit activity,alter susceptibility"
DRUG_ALTER_SUSCEPTIBILITY = "alter susceptibility"
DRUG_INHIBIT_ACTIVATION = "inhibit activation"
DRUG_ACTIVATE = "activate"


def _local(tag):
    return tag.rsplit("}", 1)[-1]


@dataclass
class Molecule:
    id: str
    name: str
    mtype: str
    drug_type: str = ""
    parents: List[int] = field(default_factory=list)
    activating: List[bool] = field(default_factory=list)
    # resolved parameter indices (None -> absent)
    base_ix: Optional[int] = None
    strength_ix: List[Optional[int]] = field(default_factory=list)
    inflection_ix: List[Optional[int]] = field(default_factory=list)
    steepness_ix: List[Optional[int]] = field(default_factory=list)
    susceptibility_ix: List[Optional[int]] = field(default_factory=list)
    expression_mixing_ix: Optional[int] = None


def _unrolled_solve(A, b):
    """Unrolled no-pivot LU solve for the small Newton systems of the
    feedback components (component size is bounded by the reference's
    16-parent limit, SignalingNetwork.h:37-90). The generic
    jnp.linalg.solve custom call on tiny matrices inside vmapped
    programs was a measured bottleneck (see ode/sparse_lu.py);
    the Newton matrix is I - dout/dsub + ridge, diagonally dominated
    near the root, so the no-pivot form is numerically safe (and a bad
    step only perturbs an iterate that Newton damping then corrects)."""
    n = b.shape[0]
    if n > 16:
        return jnp.linalg.solve(A, b)
    a = [[A[i, j] for j in range(n)] for i in range(n)]
    x = [b[i] for i in range(n)]
    for k in range(n):
        inv = 1.0 / a[k][k]
        for j in range(k + 1, n):
            a[k][j] = a[k][j] * inv
        x[k] = x[k] * inv
        for i in range(k + 1, n):
            f = a[i][k]
            for j in range(k + 1, n):
                a[i][j] = a[i][j] - f * a[k][j]
            x[i] = x[i] - f * x[k]
    for k in range(n - 1, -1, -1):
        for i in range(k):
            x[i] = x[i] - a[i][k] * x[k]
    return jnp.stack(x)


class SignalingNetwork:
    def __init__(
        self,
        molecules: List[Molecule],
        activation_limit: str,
        multiroot_solves: int = 10,
    ):
        if activation_limit not in ("minmax", "logistic"):
            raise ValueError(
                f"Invalid activation limit '{activation_limit}' "
                "(supported: minmax, logistic)"
            )
        self.molecules = molecules
        self.activation_limit = activation_limit
        self.multiroot_solves = int(multiroot_solves)
        self.name_to_ix = {m.name: i for i, m in enumerate(molecules)}
        self.id_to_ix = {m.id: i for i, m in enumerate(molecules)}
        self._order = self._scc_order()
        self.has_feedback = any(len(c) > 1 for c in self._order)
        if self.has_feedback and activation_limit != "logistic":
            # reference: SignalingNetwork.cpp:524-527 — feedback loops can
            # only be solved with logistic activation limits
            raise ValueError(
                "System contains feedback loop, but the activation limit "
                "is not logistic"
            )
        # Quasi-random Newton starting points per feedback component:
        # the reference solves each feedback system from multiroot_solves
        # Sobol points in [0,1]^d and the experiment keeps the
        # best-scoring root (SignalingNetwork.cpp:599-625 seeds one
        # d-dim boost::sobol per component and consumes one point per
        # multiroot solve). The sequences are re-seeded on every
        # Calculate, so the starts are evaluation-independent constants —
        # precomputed here on the host.
        self._multiroot_starts: List[Optional[np.ndarray]] = []
        for comp in self._order:
            if len(comp) > 1:
                import warnings

                from scipy.stats import qmc

                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    starts = qmc.Sobol(
                        d=len(comp), scramble=False
                    ).random(self.multiroot_solves)
                self._multiroot_starts.append(
                    np.asarray(starts, dtype=np.float64)
                )
            else:
                self._multiroot_starts.append(None)

    # ------------------------------------------------------------------
    # Loading

    @classmethod
    def from_sbml(
        cls,
        filename: str,
        varset,
        activation_limit="minmax",
        multiroot_solves: int = 10,
    ):
        root = ET.parse(filename).getroot()
        model = next(c for c in root if _local(c.tag) == "model")

        def first(node, name):
            for c in node:
                if _local(c.tag) == name:
                    return c
            return None

        molecules: List[Molecule] = []
        id_map: Dict[str, int] = {}
        los = first(model, "listOfSpecies")
        for sp in los if los is not None else []:
            m = Molecule(
                id=sp.get("id"),
                name=sp.get("name", sp.get("id")),
                mtype=TYPE_UNKNOWN,
            )
            for el in sp.iter():
                if _local(el.tag) == "class" and el.text:
                    cname = el.text.strip()
                    if cname not in _CLASS_MAP:
                        raise ValueError(
                            f"Unrecognized species type {cname} for {m.id}"
                        )
                    m.mtype = _CLASS_MAP[cname]
            notes = ""
            nnode = first(sp, "notes")
            if nnode is not None:
                notes = " ".join(t.strip() for t in nnode.itertext()).strip()
            if m.mtype == TYPE_DRUG:
                if notes not in (
                    DRUG_INHIBIT_ACTIVITY,
                    DRUG_INHIBIT_ACTIVITY_ALTER,
                    DRUG_ALTER_SUSCEPTIBILITY,
                    DRUG_INHIBIT_ACTIVATION,
                    DRUG_ACTIVATE,
                ):
                    raise ValueError(
                        f"Drug '{m.name}' needs a note specifying its "
                        "inhibition type"
                    )
                m.drug_type = notes
            elif m.mtype == TYPE_PROTEIN and notes == "drug_transporter":
                m.mtype = TYPE_TRANSPORTER
            elif m.mtype == TYPE_MUTATION and notes == "complete_loss":
                m.mtype = TYPE_COMPLETE_LOSS
            id_map[m.id] = len(molecules)
            molecules.append(m)

        lor = first(model, "listOfReactions")
        for re_el in lor if lor is not None else []:
            activating = True
            for el in re_el.iter():
                if _local(el.tag) == "reactionType" and el.text:
                    rt = el.text.strip()
                    if rt == "POSITIVE_INFLUENCE":
                        activating = True
                    elif rt == "NEGATIVE_INFLUENCE":
                        activating = False
                    else:
                        raise ValueError(
                            f"Unrecognized reaction type {rt}"
                        )
            reactants = [
                r.get("species")
                for lst in re_el
                if _local(lst.tag) == "listOfReactants"
                for r in lst
                if _local(r.tag) == "speciesReference"
            ]
            products = [
                r.get("species")
                for lst in re_el
                if _local(lst.tag) == "listOfProducts"
                for r in lst
                if _local(r.tag) == "speciesReference"
            ]
            if len(reactants) != 1 or len(products) != 1:
                raise ValueError(
                    "fISA reactions must have exactly 1 reactant and 1 product"
                )
            parent = id_map[reactants[0]]
            child = id_map[products[0]]
            molecules[child].parents.append(parent)
            molecules[child].activating.append(activating)

        net = cls(molecules, activation_limit, multiroot_solves)
        net._resolve_parameters(varset)
        return net

    def _resolve_parameters(self, varset):
        def ix(name):
            return varset.index_of(name) if name in varset.names else None

        for m in self.molecules:
            m.base_ix = ix(f"base_{m.name}")
            m.expression_mixing_ix = ix(f"expression_mixing[{m.name}]")
            for p in m.parents:
                pname = self.molecules[p].name
                if self.molecules[p].mtype == TYPE_DRUG:
                    m.strength_ix.append(ix(f"maxinhib_{pname}_{m.name}"))
                    m.inflection_ix.append(ix(f"ic50_{pname}_{m.name}"))
                    m.steepness_ix.append(ix(f"logsteepness_{pname}_{m.name}"))
                else:
                    s = ix(f"strength_{pname}_{m.name}")
                    if s is None and self.molecules[p].mtype != TYPE_TRANSPORTER:
                        raise ValueError(
                            f"Missing variable strength_{pname}_{m.name}"
                        )
                    m.strength_ix.append(s)
                    m.inflection_ix.append(ix(f"inflection_{pname}_{m.name}"))
                    m.steepness_ix.append(ix(f"steepness_{pname}_{m.name}"))
                m.susceptibility_ix.append(
                    ix(f"{pname}_{m.name}_susceptibility")
                )

    # ------------------------------------------------------------------
    # Structure

    def _scc_order(self):
        """Topologically ordered strongly connected components
        (reference: ConstructGraph + boost::strong_components)."""
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components

        n = len(self.molecules)
        rows, cols = [], []
        for i, m in enumerate(self.molecules):
            for p in m.parents:
                rows.append(p)
                cols.append(i)
        graph = csr_matrix(
            (np.ones(len(rows)), (rows, cols)), shape=(n, n)
        )
        n_comp, labels = connected_components(
            graph, directed=True, connection="strong"
        )
        # topological order of the condensation: order components by the
        # longest path from any root (Kahn-style levels)
        comp_members = [[] for _ in range(n_comp)]
        for i, lab in enumerate(labels):
            comp_members[lab].append(i)
        comp_edges = set()
        for i, m in enumerate(self.molecules):
            for p in m.parents:
                if labels[p] != labels[i]:
                    comp_edges.add((labels[p], labels[i]))
        indeg = {c: 0 for c in range(n_comp)}
        for a, b in comp_edges:
            indeg[b] += 1
        from collections import deque

        q = deque(c for c in range(n_comp) if indeg[c] == 0)
        order = []
        while q:
            c = q.popleft()
            order.append(c)
            for a, b in comp_edges:
                if a == c:
                    indeg[b] -= 1
                    if indeg[b] == 0:
                        q.append(b)
        return [comp_members[c] for c in order]

    @property
    def num_molecules(self):
        return len(self.molecules)

    def molecule_ix_by_name(self, name):
        return self.name_to_ix[name]

    # ------------------------------------------------------------------
    # Evaluation

    def _drug_signal(self, m: Molecule, j: int, activities, values):
        """Dose-response signal of drug parent j of molecule m
        (reference: Precalculate:738-780)."""
        p = m.parents[j]
        act = activities[p]
        maxinhib = values[m.strength_ix[j]] if m.strength_ix[j] is not None else 1.0
        activating = m.activating[j]
        if m.inflection_ix[j] is None:
            sig = jnp.where(
                activating, act * maxinhib, 1.0 - act * maxinhib
            )
        else:
            ic50 = values[m.inflection_ix[j]]
            steep = jnp.power(10.0, values[m.steepness_ix[j]])
            logc = jnp.log10(jnp.maximum(act, 1e-300))
            resp = maxinhib - maxinhib / (
                jnp.power(10.0, steep * (logc - ic50)) + 1.0
            )
            sig = jnp.where(activating, resp, 1.0 - resp)
        zero_sig = jnp.where(activating, 0.0, 1.0)
        return jnp.where(act == 0.0, zero_sig, sig)

    def _signal_inhibition(self, i: int, j: int, activities, values):
        """u_a: drug attenuation of the signal from parent j to i
        (reference: CalculateSignalInhibition:787-822)."""
        m = self.molecules[i]
        parent = self.molecules[m.parents[j]]
        inhibition = 1.0
        for k, pp in enumerate(parent.parents):
            ppm = self.molecules[pp]
            if (
                ppm.mtype == TYPE_DRUG
                and ppm.drug_type
                in (DRUG_INHIBIT_ACTIVITY, DRUG_INHIBIT_ACTIVITY_ALTER)
                and not parent.activating[k]
            ):
                sig = self._drug_signal(parent, k, activities, values)
                inhibition = inhibition * jnp.where(
                    activities[pp] > 0, sig, 1.0
                )
        for k, pp in enumerate(m.parents):
            ppm = self.molecules[pp]
            if (
                ppm.mtype == TYPE_DRUG
                and ppm.drug_type
                in (DRUG_ALTER_SUSCEPTIBILITY, DRUG_INHIBIT_ACTIVITY_ALTER)
                and m.susceptibility_ix[k] is not None
            ):
                inhibition = inhibition * jnp.where(
                    activities[pp] > 0,
                    values[m.susceptibility_ix[k]],
                    1.0,
                )
        return inhibition

    def _activation_input(self, i: int, activities, values):
        """reference: CalculateActivationInput:839-905."""
        m = self.molecules[i]
        if m.base_ix is not None:
            total = values[m.base_ix]
        elif not m.parents:
            total = jnp.asarray(1.0)
        else:
            total = jnp.asarray(0.0)
        inhibition = jnp.asarray(1.0)
        loss = jnp.asarray(False)
        for j, p in enumerate(m.parents):
            pm = self.molecules[p]
            if pm.mtype == TYPE_DRUG:
                sig = self._drug_signal(m, j, activities, values)
                if m.activating[j]:
                    total = total + sig
                else:
                    if (
                        pm.drug_type == DRUG_INHIBIT_ACTIVATION
                        or m.name == "proliferation"
                    ):
                        inhibition = inhibition * sig
                    # inhibit-activity drugs act on downstream signals only
            elif pm.mtype == TYPE_COMPLETE_LOSS:
                loss = loss | (activities[p] > 0)
            elif pm.mtype == TYPE_TRANSPORTER:
                continue
            else:
                strength = values[m.strength_ix[j]]
                sig = jnp.where(m.activating[j], strength, -strength)
                sig = sig * self._signal_inhibition(i, j, activities, values)
                if m.inflection_ix[j] is not None:
                    sig = sig * logistic_activation(
                        activities[p],
                        values[m.steepness_ix[j]],
                        values[m.inflection_ix[j]],
                    )
                else:
                    sig = sig * activities[p]
                total = total + sig
        total = jnp.where(loss, 0.0, total)
        return total, inhibition

    def _molecule_activity(self, i: int, activities, expression, values):
        m = self.molecules[i]
        total, inhibition = self._activation_input(i, activities, values)
        if self.activation_limit == "minmax":
            limited = jnp.clip(total, 0.0, 1.0)
        else:
            limited = logistic_activation_fixed(total)
        act = limited * inhibition
        e = expression[i]
        if m.expression_mixing_ix is not None:
            em = values[m.expression_mixing_ix]
            return (em * e + (1.0 - em)) * act
        return e * act

    def _calculate_impl(self, values, expression, preset_activities, starts):
        """SCC-ordered solve with per-feedback-component Newton starts.

        `starts` is a list aligned with self._order: None for singleton
        components, a (d,) start vector for feedback components
        (reference single-vector Calculate uses the fixed 0.5 start,
        SignalingNetwork.cpp:554-557; the multiroot overload seeds from
        Sobol points, :609-625).
        """
        activities = preset_activities
        for ci, comp in enumerate(self._order):
            if len(comp) == 1:
                i = comp[0]
                m = self.molecules[i]
                if m.mtype == TYPE_TRANSPORTER:
                    new = expression[i]
                else:
                    new = self._molecule_activity(
                        i, activities, expression, values
                    )
                activities = activities.at[i].set(
                    jnp.where(jnp.isnan(activities[i]), new, activities[i])
                )
            else:
                # feedback component: damped Newton
                # (reference: SolveSystem:913-1048 with
                # MAX_NEWTON_ITERATIONS=20; steps with any |delta|>0.4
                # are halved to prevent overshoot, :1000-1006)
                comp_arr = jnp.asarray(comp)
                sub0 = starts[ci]
                activities = activities.at[comp_arr].set(sub0)

                def residual(sub):
                    acts = activities.at[comp_arr].set(sub)
                    out = jnp.stack(
                        [
                            self._molecule_activity(
                                i, acts, expression, values
                            )
                            for i in comp
                        ]
                    )
                    return sub - out

                sub = sub0
                for _ in range(20):
                    r = residual(sub)
                    J = jax.jacfwd(residual)(sub)
                    delta = _unrolled_solve(
                        J + 1e-10 * jnp.eye(len(comp)), r
                    )
                    delta = jnp.where(
                        jnp.max(jnp.abs(delta)) > 0.4, 0.5 * delta, delta
                    )
                    sub = jnp.clip(sub - delta, 0.0, 1.0)
                activities = activities.at[comp_arr].set(sub)
        return activities

    def calculate(self, values, expression, preset_activities):
        """Steady-state activities, single solve from the fixed 0.5 start.

        values: (V,) transformed parameter vector; expression: (n,);
        preset_activities: (n,) with NaN for molecules to be computed
        (conditions/drug concentrations are the non-NaN entries;
        reference: fISAExperiment PrepareActivitiesCalculation). This is
        the reference's single-vector Calculate overload
        (SignalingNetwork.cpp:541-597), used by the incucyte-sequential
        experiment. Returns (n,) activities.
        """
        starts = [
            None if len(c) == 1 else jnp.full((len(c),), 0.5)
            for c in self._order
        ]
        return self._calculate_impl(
            values, expression, preset_activities, starts
        )

    def calculate_multiroot(self, values, expression, preset_activities):
        """All multiroot steady-state solves, shape (M, n).

        Batched form of the reference's multiroot Calculate overload
        (SignalingNetwork.cpp:599-697): each feedback component is
        root-solved from `multiroot_solves` Sobol starting points; the
        caller (the single-condition experiment) scores every solve's
        activities against the data and keeps the best root per cell
        line (fISAExperimentSingleCondition.cpp:184-230,412-425). The M
        solves are vmapped instead of looped. Without feedback
        components all solves coincide, so a single (1, n) solve is
        returned.
        """
        if not self.has_feedback:
            return self.calculate(values, expression, preset_activities)[
                None, :
            ]

        def solve_from(mi):
            starts = [
                None if s is None else jnp.asarray(s)[mi]
                for s in self._multiroot_starts
            ]
            return self._calculate_impl(
                values, expression, preset_activities, starts
            )

        return jax.vmap(solve_from)(jnp.arange(self.multiroot_solves))

    def max_expression(self, i, expression, values):
        """reference: max_expression_function:36-40."""
        m = self.molecules[i]
        e = expression[i]
        if m.expression_mixing_ix is not None:
            em = values[m.expression_mixing_ix]
            return em * e + (1.0 - em)
        return e
