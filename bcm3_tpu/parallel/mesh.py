"""Device-mesh helpers: chain-axis sharding for the PT sampler.

JAX replacement for the reference's thread-level chain
parallelism (reference: src/utils/TaskManager.h, SamplerPT.cpp:308-319):
the chain population is a stacked array sharded over a
`jax.sharding.Mesh` axis; the even/odd replica-exchange permutation
lowers to XLA collective-permutes between devices, and everything else is
embarrassingly chain-parallel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chain"


def chain_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(CHAIN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leading_axis(tree, mesh: Mesh, chain_count: int):
    """device_put every leaf: axis 0 sharded over the chain mesh axis when it
    matches the chain count, replicated otherwise."""
    cs = chain_sharding(mesh)
    rep = replicated(mesh)
    multiproc = jax.process_count() > 1

    def put(leaf):
        if multiproc and hasattr(leaf, "shape"):
            # every process computed an identical full copy (deterministic
            # init); hand numpy to device_put so it scatters each process's
            # addressable shards of the global array
            leaf = np.asarray(leaf)
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == chain_count:
            return jax.device_put(leaf, cs)
        return jax.device_put(leaf, rep)

    return jax.tree_util.tree_map(put, tree)
