"""Worker process for the multi-process distributed test.

Launched by tests/test_multiprocess.py with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=<local>; every process
runs the identical sharded banana PT inference over the GLOBAL device
mesh (2 processes x 4 local devices = 8 global devices) and saves its
local emission shard. The reference has no distributed execution at all
(SURVEY §2.12); this exercises the mandated jax.distributed runtime:
cross-process collectives in the replica-exchange permutation, the
all-gather adaptation boundary, and per-host sharded emission.

Usage: python _multiprocess_worker.py <proc_id> <num_procs> <port> <outdir>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    proc_id, num_procs, port, outdir = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.config.update("jax_enable_x64", True)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from bcm3_tpu.parallel.distributed import initialize, is_primary

    initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == num_procs
    assert jax.device_count() == 8, jax.devices()

    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    REF = "/root/reference/examples"
    varset = VariableSet.from_xml(f"{REF}/banana/prior.xml")
    prior = Prior.from_xml(f"{REF}/banana/prior.xml", varset)
    lik = create_likelihood(f"{REF}/banana/likelihood.xml", varset)
    cfg = PTConfig(
        num_samples=40,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=4,  # 16 global chains over 8 devices, 2 ensembles/proc
        adapt_proposal_samples=20,
        adapt_proposal_times=1,
        shard_over_devices=True,
        seed=9,
    )
    s = SamplerPT(prior, lik, cfg)
    res = s.run()

    np.savez(
        f"{outdir}/shard_{proc_id}.npz",
        samples=res["samples"],
        log_prior=res["log_prior"],
        log_likelihood=res["log_likelihood"],
        e0=res["ensemble_shard"][0] if res["ensemble_shard"] else -1,
        e_local=res["ensemble_shard"][1] if res["ensemble_shard"] else -1,
        num_ensembles=res["num_ensembles"],
        temperatures=np.asarray(res["temperatures"]),
        variables=np.array(varset.names),
        variable_transform=np.asarray(varset.transforms, dtype=np.uint32),
        evaluations=res["evaluations"],
        primary=is_primary(),
    )
    print(f"worker {proc_id} done", flush=True)


if __name__ == "__main__":
    main()
