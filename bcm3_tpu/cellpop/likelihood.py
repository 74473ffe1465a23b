"""Top-level cell-population likelihood: sum over experiments.

JAX equivalent of the reference CellPopulationLikelihood
(reference: src/cellpop/CellPopulationLikelihood.cpp:15-95). The
reference clones the whole likelihood per sampling thread because it is
stateful and non-reentrant (CellPopulationLikelihood.h:23); here
``log_prob`` is a pure function of the parameter vector, so it is
reentrant by construction and vmaps over the chain population.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from bcm3_tpu.cellpop.experiment import Experiment
from bcm3_tpu.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)


class CellPopulationLikelihood:
    def __init__(
        self,
        experiments: List[Experiment],
        varset: VariableSet,
    ):
        self.experiments = experiments
        self.varset = varset
        self._transforms = np.asarray(varset.transforms)

    @classmethod
    def from_xml_node(
        cls,
        root: ET.Element,
        varset: VariableSet,
        base_dir: str = ".",
        non_sampled_names=None,
    ) -> "CellPopulationLikelihood":
        experiments = [
            Experiment(node, varset, base_dir, non_sampled_names)
            for node in root.findall("experiment")
        ]
        if not experiments:
            raise ValueError("cell_population likelihood requires experiments")
        return cls(experiments, varset)

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
        for exp in self.experiments:
            logp = logp + exp.log_prob(tv)
        return jnp.where(jnp.isnan(logp), -jnp.inf, logp)

    # Two-phase evaluation for runtimes without in-graph host callbacks:
    # the device computes everything up to the
    # Hungarian cost matrices, the host solves the matchings with the
    # native LAP solver. Semantically identical to log_prob.

    def log_prob_parts(self, values):
        """Jittable device half; see Experiment.log_prob_parts."""
        tv = self._transform(values)
        parts = []
        for exp in self.experiments:
            parts.append(exp.log_prob_parts(tv))
        return tuple(parts)

    def finish_log_prob_host(self, parts) -> float:
        total = 0.0
        for exp, (partial, ok, costs) in zip(self.experiments, parts):
            total += exp.finish_log_prob_host(partial, ok, costs)
        return total

    def log_prob_batch_hostmatch(self, values_batch) -> np.ndarray:
        """Batched two-phase evaluation: one jitted vmapped device
        program for the simulations + cost matrices, then ONE native
        GIL-releasing LAP call per data likelihood for the whole batch
        (Experiment.finish_log_prob_host_batch; C++ threads inside —
        the round-5 Python ThreadPoolExecutor attempt lost to GIL row
        bookkeeping, so the batch loop moved into C++ entirely).
        BCM3_MATCH_THREADS overrides the native thread count
        (default: all cores)."""
        import jax

        vals = jnp.asarray(values_batch)
        B = int(vals.shape[0])
        if not hasattr(self, "_parts_struct"):
            self._parts_struct = {}

            # Pack every leaf of the parts tree into ONE flat device
            # array so the host copy is a single transfer, not one per
            # leaf.
            def _packed(v):
                parts = jax.vmap(self.log_prob_parts)(v)
                leaves = jax.tree_util.tree_leaves(parts)
                dt = jnp.result_type(
                    *[l.dtype for l in leaves if l.dtype != jnp.bool_]
                )
                return jnp.concatenate(
                    [jnp.ravel(leaf).astype(dt) for leaf in leaves]
                )

            self._parts_fn = jax.jit(_packed)
        if B not in self._parts_struct:
            self._parts_struct[B] = jax.eval_shape(
                jax.vmap(self.log_prob_parts), vals
            )
        struct = self._parts_struct[B]
        flat = np.asarray(self._parts_fn(vals))
        leaves, treedef = jax.tree_util.tree_flatten(struct)
        host_leaves = []
        off = 0
        for s in leaves:
            n = int(np.prod(s.shape)) if s.shape else 1
            host_leaves.append(
                flat[off:off + n].reshape(s.shape).astype(s.dtype)
            )
            off += n
        host = jax.tree_util.tree_unflatten(treedef, host_leaves)
        total = np.zeros(B, dtype=np.float64)
        for exp, (partial, ok, costs) in zip(self.experiments, host):
            total = total + exp.finish_log_prob_host_batch(
                partial, ok, costs
            )
        return total

    def get_experiment(self, name: Optional[str] = None) -> Experiment:
        """Experiment by name (reference:
        CellPopulationLikelihood::GetExperiment); None -> first."""
        if name is None or name == "":
            return self.experiments[0]
        for exp in self.experiments:
            if exp.name == name:
                return exp
        raise KeyError(f"No experiment named '{name}'")

    # Posterior-predictive accessors on UNTRANSFORMED parameter values —
    # the Python side of the cellpop R bridge
    # (reference: src/bcmrbridge/interface_cellpop.cpp:45-418).

    def simulated_trajectories(self, values, experiment=None, **kw):
        return self.get_experiment(experiment).simulated_trajectories(
            self._transform(values), **kw
        )

    def simulated_data(self, values, data_ix: int, experiment=None):
        return self.get_experiment(experiment).simulated_data(
            self._transform(values), data_ix
        )

    def matched_simulation(self, values, data_ix: int, experiment=None, **kw):
        return self.get_experiment(experiment).matched_simulation(
            self._transform(values), data_ix, **kw
        )

    def close(self):
        for exp in self.experiments:
            exp.close()


def create_cellpop_likelihood(varset: VariableSet, attrs):
    """Factory entry (reference: LikelihoodFactory.cpp 'cell_population')."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("cell_population likelihood requires an XML definition")
    xml_path = attrs.get("_xml_path")
    base_dir = os.path.dirname(xml_path) if xml_path else "."
    return CellPopulationLikelihood.from_xml_node(root, varset, base_dir)
