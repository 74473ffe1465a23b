"""Multi-process distributed PT inference.

Every process runs this same script (the reference has no distributed
execution at all — its parallelism is one thread pool, SURVEY §2.12;
here the chain population shards over the global device mesh and
replica exchange rides the interconnect).

Single-host multi-process demo (CPU):

    # terminal 1
    JAX_PLATFORMS=cpu python examples/run_distributed.py 0 2
    # terminal 2
    JAX_PLATFORMS=cpu python examples/run_distributed.py 1 2

On several hosts, run it once per host with the process id, the
process count and the coordinator's address (process 0's host:port):

    python examples/run_distributed.py <pid> <nproc> <host:port>

Each process writes only its own ensemble shard
(`samples_shard<p>.npz`); merge them with
`bcm3_tpu.io.output.merge_sharded_results`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if len(sys.argv) == 3:  # local CPU demo topology
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

import numpy as np

from bcm3_tpu.parallel.distributed import initialize, is_primary


def main():
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coordinator = sys.argv[3] if len(sys.argv) > 3 else "localhost:12421"
    initialize(coordinator, nproc, pid)

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    import tempfile

    from bcm3_tpu.example_files import write_banana_example

    prior_xml, lik_xml = write_banana_example(tempfile.mkdtemp(prefix="banana_"))
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)

    cfg = PTConfig(
        num_samples=500,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=2 * jax.process_count(),
        adapt_proposal_samples=250,
        adapt_proposal_times=1,
        shard_over_devices=True,
        seed=7,
    )
    res = SamplerPT(prior, lik, cfg).run()

    np.savez(
        f"samples_shard{pid}.npz",
        samples=res["samples"],
        log_prior=res["log_prior"],
        log_likelihood=res["log_likelihood"],
        e0=res["ensemble_shard"][0] if res["ensemble_shard"] else 0,
        e_local=res["ensemble_shard"][1]
        if res["ensemble_shard"]
        else res["num_ensembles"],
        num_ensembles=res["num_ensembles"],
        temperatures=np.asarray(res["temperatures"]),
        variables=np.array(varset.names),
        variable_transform=np.asarray(varset.transforms, dtype=np.uint32),
    )
    if is_primary():
        print(
            f"{jax.process_count()} processes, {jax.device_count()} devices: "
            f"{res['evaluations']} evaluations at "
            f"{res['evals_per_second']:.0f} evals/s"
        )
        print(
            "merge the shards into an R-loadable output.nc with:\n"
            "  python -m bcm3_tpu.merge_shards samples_shard*.npz -o output.nc"
        )


if __name__ == "__main__":
    main()
