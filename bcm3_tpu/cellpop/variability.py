"""Cell-to-cell variability descriptions driven by a Sobol sequence.

JAX equivalent of the reference variability machinery
(reference: src/cellpop/VariabilityDescription.cpp,
VariabilityDescriptionVariable.cpp, VariabilityPseudoRandomIterator.cpp).
The reference draws a shared Sobol sequence (100 x initial cells
points), maps each point through Gaussian quantiles scaled by a
(possibly sampled) scale parameter, and applies the result to cell-
specific parameters / initial conditions / entry times.

Here the *unit* pseudorandom quantiles are precomputed on the host as a
static (max_index, D) matrix; the (sampled) scales multiply them on
device, so the whole variability application stays inside jit. Each
population slot gathers its row by Sobol index, which is a
deterministic function of the slot topology
(CellPopulation.cpp:55-77)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import jax.numpy as jnp
from jax import lax
import numpy as np
from scipy.stats import norm, qmc

APPLY_ADDITIVE = "additive"
APPLY_ADDITIVE_LOG = "additive_log"
APPLY_ADDITIVE_LOG2 = "additive_log2"
APPLY_MULTIPLICATIVE = "multiplicative"
APPLY_MULTIPLICATIVE_LOG = "multiplicative_log"
APPLY_MULTIPLICATIVE_LOG2 = "multiplicative_log2"
APPLY_REPLACE = "replace"


@dataclass
class ValueRef:
    """A value that is either a sampled variable, a non-sampled parameter
    or a fixed number (reference: src/cellpop/ValueReference.cpp)."""

    string: str
    var_ix: int = -1
    non_sampled_ix: int = -1
    fixed_value: float = np.nan

    def resolve(self, varset, non_sampled_names):
        if self.string in varset.names:
            self.var_ix = varset.index_of(self.string)
            return True
        if self.string in non_sampled_names:
            self.non_sampled_ix = list(non_sampled_names).index(self.string)
            return True
        try:
            self.fixed_value = float(self.string)
            return True
        except ValueError:
            return False

    def value(self, transformed_values, non_sampled):
        if self.var_ix >= 0:
            return transformed_values[self.var_ix]
        if self.non_sampled_ix >= 0:
            return non_sampled[self.non_sampled_ix]
        return jnp.asarray(self.fixed_value)


@dataclass
class VariabilityVariable:
    """One <variable> inside a <cell_variability>
    (reference: VariabilityDescriptionVariable.cpp Load:99-147)."""

    apply_type: str
    scale: ValueRef
    parameter_name: str = ""
    species_name: str = ""
    entry_time: bool = False
    negate: bool = False
    only_initial_cells: bool = False

    @classmethod
    def from_xml(cls, node) -> "VariabilityVariable":
        species = node.get("initial_condition_species", "")
        param = node.get("model_parameter", "")
        entry = node.get("entry_time", "") != ""
        count = sum([bool(species), bool(param), entry])
        if count != 1:
            raise ValueError(
                "cell variability variable must specify exactly one of "
                "initial_condition_species / model_parameter / entry_time"
            )
        apply_str = node.get("apply")
        if apply_str not in (
            APPLY_ADDITIVE,
            APPLY_ADDITIVE_LOG,
            APPLY_ADDITIVE_LOG2,
            APPLY_MULTIPLICATIVE,
            APPLY_MULTIPLICATIVE_LOG,
            APPLY_MULTIPLICATIVE_LOG2,
            APPLY_REPLACE,
        ):
            raise ValueError(f"Unknown variability application type '{apply_str}'")
        default_only_initial = "true" if entry else "false"
        return cls(
            apply_type=apply_str,
            scale=ValueRef(node.get("scale")),
            parameter_name=param,
            species_name=species,
            entry_time=entry,
            negate=node.get("negate", "false").lower() in ("1", "true"),
            only_initial_cells=node.get(
                "only_initial_cells", default_only_initial
            ).lower()
            in ("1", "true"),
        )

    def apply(self, x, v):
        """reference: VariabilityDescriptionVariable.cpp Apply:155-185."""
        if self.apply_type == APPLY_ADDITIVE:
            return x + v
        if self.apply_type == APPLY_ADDITIVE_LOG:
            return x + jnp.exp(v)
        if self.apply_type == APPLY_ADDITIVE_LOG2:
            return x + jnp.power(2.0, v)
        if self.apply_type == APPLY_MULTIPLICATIVE:
            return x * v
        if self.apply_type == APPLY_MULTIPLICATIVE_LOG:
            return x * jnp.exp(v)
        if self.apply_type == APPLY_MULTIPLICATIVE_LOG2:
            return x * jnp.power(2.0, v)
        return v  # replace


@dataclass
class VariabilityDescription:
    """One <cell_variability> block: a set of variables with a diagonal or
    full (spherically parametrized) Gaussian over their pseudorandom
    values (reference: VariabilityDescription.cpp:40-120)."""

    variables: List[VariabilityVariable]
    distribution: str  # "diagonal_gaussian" | "full_gaussian"
    covar_refs: List[ValueRef] = field(default_factory=list)

    @classmethod
    def from_xml(cls, node) -> "VariabilityDescription":
        variables = [
            VariabilityVariable.from_xml(v) for v in node if v.tag == "variable"
        ]
        dist = node.get("distribution")
        if dist not in ("diagonal_gaussian", "full_gaussian"):
            raise ValueError(f"Unknown distribution '{dist}' in variability")
        covar_refs = []
        if dist == "full_gaussian":
            base = node.get("covar_base_name")
            for i in range(len(variables)):
                for j in range(i):
                    covar_refs.append(ValueRef(f"{base}{j + 1}_{i + 1}"))
        return cls(variables=variables, distribution=dist, covar_refs=covar_refs)

    @property
    def num_dimensions(self) -> int:
        return len(self.variables)

    def resolve(self, varset, non_sampled_names):
        for v in self.variables:
            if not v.scale.resolve(varset, non_sampled_names):
                raise ValueError(f"Cannot resolve scale '{v.scale.string}'")
        for c in self.covar_refs:
            if not c.resolve(varset, non_sampled_names):
                raise ValueError(f"Cannot resolve covariance '{c.string}'")

    def pseudorandom_vector(self, unit_normals, transformed_values, non_sampled):
        """unit_normals: (D,) quantile-normal Sobol values for this block.
        Returns the scaled (D,) variability vector
        (reference: GetPseudorandomVector:40-118)."""
        D = self.num_dimensions
        scales = jnp.stack(
            [
                jnp.exp(v.scale.value(transformed_values, non_sampled))
                for v in self.variables
            ]
        )
        if self.distribution == "diagonal_gaussian":
            return unit_normals * scales
        # spherical log-Cholesky parametrization (Pinheiro & Bates 1996;
        # reference: VariabilityDescription.cpp:83-110)
        L = jnp.zeros((D, D))
        cov_vals = jnp.stack(
            [
                c.value(transformed_values, non_sampled) * jnp.pi
                for c in self.covar_refs
            ]
        ) if self.covar_refs else jnp.zeros((0,))
        for i in range(D):
            for j in range(i + 1):
                entry = scales[i]
                for k in range(i):
                    if k <= j:
                        cov_ix = (i - 1) * i // 2 + k
                        cv = cov_vals[cov_ix]
                        entry = entry * jnp.where(k == j, jnp.cos(cv), jnp.sin(cv))
                L = L.at[i, j].set(entry)
        return jnp.matmul(L, unit_normals, precision=lax.Precision.HIGHEST)


def sobol_unit_normals(total_dims: int, initial_cells: int) -> np.ndarray:
    """Host-precomputed quantile-normal Sobol matrix
    (reference: VariabilityPseudoRandomIterator.cpp Initialize:10-22 —
    100*initial_cells points of a ``dimensions``-dim Sobol sequence)."""
    n = initial_cells * 100
    if total_dims == 0:
        return np.zeros((n, 0))
    eng = qmc.Sobol(d=total_dims, scramble=False)
    n_pow2 = 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))
    u = eng.random(n_pow2)[:n]
    # guard against the degenerate first point (all zeros)
    u = np.clip(u, 1e-12, 1.0 - 1e-12)
    return norm.ppf(u)
