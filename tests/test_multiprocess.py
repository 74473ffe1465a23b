"""Real multi-process distributed execution (jax.distributed, 2 processes).

The reference's only parallelism is a single-process thread pool
(SURVEY §2.12; reference: src/utils/TaskManager.h); the replacement
is a jax.distributed multi-host runtime. This test launches two
OS processes, each with 4 virtual CPU devices, forming one 8-device
global mesh; both run the same sharded banana PT inference (replica
exchange = cross-process collective permutes, proposal adaptation =
all-gathered history) and emit per-host shards, which are merged and
compared against a single-process reference run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_multiprocess_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_run(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_NUM_CPU_DEVICES"] = "4"
        env.pop("JAX_PLATFORM_NAME", None)
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, str(pid), "2", str(port), str(tmp_path)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=ROOT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    shards = []
    for pid in range(2):
        z = np.load(tmp_path / f"shard_{pid}.npz")
        assert int(z["e0"]) >= 0, "per-host sharded emission did not engage"
        shards.append(
            {
                "samples": z["samples"],
                "log_prior": z["log_prior"],
                "log_likelihood": z["log_likelihood"],
                "ensemble_shard": (int(z["e0"]), int(z["e_local"])),
                "num_ensembles": int(z["num_ensembles"]),
                "temperatures": None,
            }
        )
    # the two processes own disjoint, covering ensemble blocks
    assert shards[0]["ensemble_shard"] != shards[1]["ensemble_shard"]

    from bcm3_tpu.io.output import merge_sharded_results

    merged = merge_sharded_results(shards)

    # single-process reference (8 virtual devices from conftest)
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    REF = "/root/reference/examples"
    varset = VariableSet.from_xml(f"{REF}/banana/prior.xml")
    prior = Prior.from_xml(f"{REF}/banana/prior.xml", varset)
    lik = create_likelihood(f"{REF}/banana/likelihood.xml", varset)
    res = SamplerPT(
        prior,
        lik,
        PTConfig(
            num_samples=40,
            use_every_nth=2,
            num_chains=4,
            num_ensembles=4,
            adapt_proposal_samples=20,
            adapt_proposal_times=1,
            shard_over_devices=True,
            seed=9,
        ),
    ).run()

    assert merged["samples"].shape == res["samples"].shape
    np.testing.assert_allclose(merged["samples"], res["samples"], rtol=1e-10)
    np.testing.assert_allclose(
        merged["log_likelihood"], res["log_likelihood"], rtol=1e-10
    )

    # the distributed path must end at the same R-loadable output.nc a
    # single-process run produces (VERDICT r2 item 7; reference schema:
    # src/sampler/SampleHandlerNetCDF.cpp:45-111) — merge via the CLI and
    # read it back through the hdf5r-semantics contract loader
    from bcm3_tpu.merge_shards import main as merge_main

    out_nc = str(tmp_path / "output.nc")
    rc = merge_main(
        [str(tmp_path / f"shard_{pid}.npz") for pid in range(2)]
        + ["-o", out_nc]
    )
    assert rc == 0

    import shutil

    from bcm3_tpu.io import hdf5r_compat as rload

    for fn in ("prior.xml", "likelihood.xml"):
        shutil.copy(f"{REF}/banana/{fn}", tmp_path / fn)
    post = rload.bcm3_load_results(
        str(tmp_path), ".", output_filename="output.nc",
        load_sampler_adaptation=False,
    )
    # hdf5r view: samples[var, temp, sample]
    N, L, D = merged["samples"].shape
    assert post["posterior"]["samples"].shape == (D, L, N)
    np.testing.assert_allclose(
        post["posterior"]["samples"][:, -1, :],
        merged["samples"][:, -1, :].T,
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        post["posterior"]["llikelihood"][-1, :],
        merged["log_likelihood"][:, -1],
        rtol=1e-12,
    )
