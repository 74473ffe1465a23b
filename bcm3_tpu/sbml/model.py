"""SBML model: species classification + jittable RHS construction.

JAX equivalent of the reference SBMLModel
(reference: src/sbml/SBMLModel.cpp). Faithfully reproduced structure:

- species split into ODE-integrated vs constant: a species that is
  neither a reactant nor a product in any reaction is constant
  (SBMLModel.cpp:93-126); CellDesigner "DEGRADED" (sink) species are
  excluded entirely (:95-96);
- dy/dt = stoichiometry-weighted sum of reaction rate laws
  (SBMLModel.cpp GenerateCode:282-345);
- assignment rules computed on top of the integrated state
  (SBMLModel.cpp CalculateAssignments:726-733);
- name resolution priority in rate laws per SBMLRatelaws.cpp:152-221.

The jittable RHS replaces the reference's cmake-compile-dlopen codegen
(SolverCodeGenerator.cpp); the Jacobian the reference generates
symbolically (SBMLModel.cpp GenerateJacobianCode) is jax.jacfwd of the
RHS.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from bcm3_tpu.sbml.parser import SBMLDocument, parse_sbml_file, parse_sbml_string
from bcm3_tpu.sbml.ratelaws import RatelawCompiler


class SBMLModel:
    """Parsed model with derived index structure and RHS factory."""

    def __init__(self, doc: SBMLDocument):
        self.doc = doc

        # simulated species = everything except sinks (reference: :93-97)
        self.simulated_species: List[str] = [
            sid
            for sid in doc.species_order
            if doc.species[sid].sbml_type != "Sink"
        ]
        in_reaction = set()
        for rid in doc.reaction_order:
            r = doc.reactions[rid]
            for sid, _ in r.reactants:
                in_reaction.add(sid)
            for sid, _ in r.products:
                in_reaction.add(sid)
        self.ode_species: List[str] = [
            s for s in self.simulated_species if s in in_reaction
        ]
        self.constant_species: List[str] = [
            s for s in self.simulated_species if s not in in_reaction
        ]
        self.species_index = {s: i for i, s in enumerate(self.ode_species)}
        self.constant_species_index = {
            s: i for i, s in enumerate(self.constant_species)
        }
        self.sim_index = {s: i for i, s in enumerate(self.simulated_species)}
        self.ode_to_sim = np.array(
            [self.sim_index[s] for s in self.ode_species], dtype=np.int64
        )
        self.constant_to_sim = np.array(
            [self.sim_index[s] for s in self.constant_species], dtype=np.int64
        )

    # ------------------------------------------------------------------
    # Introspection mirroring the reference accessors

    @property
    def num_ode_species(self) -> int:
        return len(self.ode_species)

    @property
    def num_constant_species(self) -> int:
        return len(self.constant_species)

    @property
    def num_simulated_species(self) -> int:
        return len(self.simulated_species)

    def species_full_name(self, sid: str) -> str:
        return self.doc.species[sid].full_name

    def simulated_species_full_names(self) -> List[str]:
        return [self.species_full_name(s) for s in self.simulated_species]

    def ode_species_by_full_name(self, full_name: str) -> int:
        for i, s in enumerate(self.ode_species):
            if self.species_full_name(s) == full_name:
                return i
        raise KeyError(f"No ODE species with full name '{full_name}'")

    def constant_species_by_full_name(self, full_name: str) -> int:
        for i, s in enumerate(self.constant_species):
            if self.species_full_name(s) == full_name:
                return i
        raise KeyError(f"No constant species with full name '{full_name}'")

    def get_parameter_names(self) -> List[str]:
        """All parameter names referenced anywhere in the rate laws
        (reference: SBMLModel::GetParameters)."""
        names = set()

        def walk(ast):
            if ast[0] == "name":
                names.add(ast[1])
            elif ast[0] == "call":
                for a in ast[2]:
                    walk(a)
            elif ast[0] not in ("const",):
                for a in ast[1]:
                    walk(a)

        for rid in self.doc.reaction_order:
            ast = self.doc.reactions[rid].rate_ast
            if ast is not None:
                walk(ast)
        for rule in self.doc.assignment_rules:
            walk(rule.ast)
        species_ids = set(self.doc.species_order)
        return sorted(
            n
            for n in names
            if n not in species_ids and n != "__time__"
        )

    def initial_ode_values(self) -> np.ndarray:
        return np.array(
            [self.doc.species[s].initial_value for s in self.ode_species]
        )

    def initial_constant_values(self) -> np.ndarray:
        return np.array(
            [self.doc.species[s].initial_value for s in self.constant_species]
        )

    # ------------------------------------------------------------------
    # RHS construction

    def make_rhs(
        self,
        parameter_names: Sequence[str],
        non_sampled_names: Sequence[str] = (),
        fixed_values: Optional[Dict[str, float]] = None,
    ) -> Callable:
        """Build ``f(t, y, constant_y, params, nsp) -> dy/dt`` (jittable).

        ``parameter_names[i]`` maps to ``params[i]``; likewise for
        non-sampled parameters. Fixed values take priority
        (reference: SBMLRatelaws.cpp:158-165).
        """
        compiler = RatelawCompiler(
            self.doc,
            self.species_index,
            {n: i for i, n in enumerate(parameter_names)},
            self.constant_species_index,
            {n: i for i, n in enumerate(non_sampled_names)},
            fixed_values,
        )
        rate_fns = []
        for rid in self.doc.reaction_order:
            ast = self.doc.reactions[rid].rate_ast
            rate_fns.append(compiler.compile(ast) if ast is not None else None)

        # stoichiometry matrix (n_ode, n_reactions)
        n = len(self.ode_species)
        R = len(self.doc.reaction_order)
        S = np.zeros((n, R))
        for j, rid in enumerate(self.doc.reaction_order):
            r = self.doc.reactions[rid]
            for sid, st in r.products:
                if sid in self.species_index:
                    S[self.species_index[sid], j] += st
            for sid, st in r.reactants:
                if sid in self.species_index:
                    S[self.species_index[sid], j] -= st

        # static sparse stoichiometry application instead of `S @ rates`:
        # a matmul may run at reduced precision (bf16 or TF32 passes),
        # and ~1e-3-relative RHS noise makes adaptive error control at
        # rtol 1e-6 impossible (every vmapped cellpop integration
        # soft-failed that way). The matrix is tiny and mostly +/-1, so
        # the unrolled multiply-add form is both exact f32 and faster.
        terms = [
            [(j, float(S[i, j])) for j in range(R) if S[i, j] != 0.0]
            for i in range(n)
        ]

        def rhs(t, y, constant_y, params, nsp):
            rates = [
                (f(t, y, constant_y, params, nsp) if f is not None else 0.0)
                * jnp.ones((), dtype=y.dtype)
                for f in rate_fns
            ]
            zero = jnp.zeros((), dtype=y.dtype)
            dy = []
            for i in range(n):
                acc = zero
                for j, coef in terms[i]:
                    acc = acc + (rates[j] if coef == 1.0 else coef * rates[j])
                dy.append(acc)
            return jnp.stack(dy)

        return rhs

    def jacobian_sparsity(self) -> np.ndarray:
        """Structural Jacobian pattern (n_ode, n_ode) bool: J[i, j] can
        be nonzero iff some reaction changing species i has species j in
        its rate law. Derived from the SBML reaction structure, so it is
        a guaranteed superset of the numerical pattern for every
        parameter value — the static-analysis analogue of the sparsity
        pattern the reference's generated Jacobian encodes per entry
        (reference: src/sbml/SBMLModel.h:28-30 GenerateJacobianCode).
        User-defined function bodies are walked conservatively (all
        species names in the body count, including arg-shadowed ones)."""
        n = len(self.ode_species)
        P = np.zeros((n, n), dtype=bool)

        def species_deps(ast, out, seen_fns):
            kind = ast[0]
            if kind == "const":
                return
            if kind == "name":
                if ast[1] in self.species_index:
                    out.add(self.species_index[ast[1]])
                return
            if kind == "call":
                for a in ast[2]:
                    species_deps(a, out, seen_fns)
                fdef = self.doc.functions.get(ast[1])
                if fdef is not None and ast[1] not in seen_fns:
                    species_deps(fdef.body, out, seen_fns | {ast[1]})
                return
            for a in ast[1]:
                species_deps(a, out, seen_fns)

        for rid in self.doc.reaction_order:
            r = self.doc.reactions[rid]
            if r.rate_ast is None:
                continue
            deps: set = set()
            species_deps(r.rate_ast, deps, frozenset())
            rows = {
                self.species_index[sid]
                for sid, _ in list(r.products) + list(r.reactants)
                if sid in self.species_index
            }
            for i in rows:
                for j in deps:
                    P[i, j] = True
        return P

    def make_jacobian(self, rhs: Callable) -> Callable:
        """d(dy/dt)/dy via forward-mode autodiff — replaces the
        reference's symbolic per-entry Jacobian codegen
        (reference: SBMLModel.cpp GenerateJacobianCode)."""

        def jac(t, y, constant_y, params, nsp):
            return jax.jacfwd(lambda yy: rhs(t, yy, constant_y, params, nsp))(y)

        return jac

    def make_assignments(
        self,
        parameter_names: Sequence[str],
        non_sampled_names: Sequence[str] = (),
        fixed_values: Optional[Dict[str, float]] = None,
    ) -> Callable:
        """Build ``g(t, y, constant_y, params, nsp) -> (n_simulated,)``:
        the full simulated-species vector with assignment rules applied
        (reference: SBMLModel.cpp CalculateAssignments:726-733)."""
        compiler = RatelawCompiler(
            self.doc,
            self.species_index,
            {n: i for i, n in enumerate(parameter_names)},
            self.constant_species_index,
            {n: i for i, n in enumerate(non_sampled_names)},
            fixed_values,
        )
        rules = [
            (self.sim_index[r.target], compiler.compile(r.ast))
            for r in self.doc.assignment_rules
            if r.target in self.sim_index
        ]
        ode_to_sim = jnp.asarray(self.ode_to_sim)
        constant_to_sim = jnp.asarray(self.constant_to_sim)
        n_sim = self.num_simulated_species

        def assignments(t, y, constant_y, params, nsp):
            out = jnp.zeros((n_sim,), dtype=y.dtype)
            out = out.at[ode_to_sim].set(y)
            if constant_y is not None and self.num_constant_species:
                out = out.at[constant_to_sim].set(constant_y)
            for tgt, f in rules:
                out = out.at[tgt].set(f(t, y, constant_y, params, nsp))
            return out

        return assignments

    @classmethod
    def from_file(cls, filename: str) -> "SBMLModel":
        return cls(parse_sbml_file(filename))

    @classmethod
    def from_string(cls, text: str) -> "SBMLModel":
        return cls(parse_sbml_string(text))
