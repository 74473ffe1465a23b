"""Multi-host runtime initialization.

The reference has no distributed backend at all — its parallelism is a
single-process thread pool (SURVEY.md §2.12; reference:
src/utils/TaskManager.h). The replacement is the `jax.distributed`
multi-host runtime: every host runs the same program, `initialize()`
wires the hosts into one JAX process group, and the chain population then
shards over the global device mesh exactly as it does over a single
host's devices (`bcm3_tpu/parallel/mesh.py`), with no code changes in the
sampler.

Typical multi-host launch (same command on every host, with its own
process id):

    python -c "
    from bcm3_tpu.parallel.distributed import initialize
    initialize('host0:12421', num_processes, process_id)
    ... build sampler with PTConfig(shard_over_devices=True) ...
    "

Output handling: every process runs the same sampler; process 0 owns the
sample store (is_primary()), other processes skip their sample handlers.
Because emitted arrays are globally sharded, `np.asarray` on them pulls
the full array on each host (jax gathers across processes); for very
large runs attach handlers only on the primary.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax

logger = logging.getLogger("bcm3")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the jax.distributed runtime.

    Pass coordinator_address ("host:port" of process 0), num_processes
    and process_id explicitly. Safe to call when already initialized
    (no-op with a warning)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # only the double-initialize case is benign; a coordinator
        # failure must fail fast — silently continuing would run N
        # unsynchronized single-process copies that all believe they
        # are primary
        if "already initialized" not in str(e).lower():
            raise
        logger.warning("jax.distributed.initialize: %s", e)
    logger.info(
        "Distributed runtime: process %d/%d, %d local + %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def is_primary() -> bool:
    """True on the process that should own output files."""
    return jax.process_index() == 0


def global_chain_mesh():
    """Chain mesh over every device of every host."""
    from bcm3_tpu.parallel.mesh import chain_mesh

    return chain_mesh(devices=jax.devices())
