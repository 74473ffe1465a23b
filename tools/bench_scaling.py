"""Scaling-efficiency + ESS/sec benchmark harness.

BASELINE.md targets: ">=80% scaling efficiency at 2+ hosts; log-prob
evals/sec/chip and ESS/sec reported at 1 chip, 1 host, and N>=2 hosts."
The reference has no distributed execution to compare against
(SURVEY.md §2.12); this harness measures the mesh-sharded PT path.

Weak scaling: the ensemble count grows with the device count, so each
device carries a constant workload; efficiency = rate_N / (N * rate_1).
On several GPUs the mesh axis rides NVLink; by default the harness runs
on a virtual CPU device mesh (`--devices 1 2 4 8`) — virtual devices
share the same physical cores, so CPU numbers validate the *harness and
sharding correctness*, not real interconnect scaling.

Usage: python tools/bench_scaling.py [--devices 1 2 4 8] [--platform cpu]
Prints one JSON line per device count plus a summary line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--platform", default="cpu", choices=["cpu", "default"])
    ap.add_argument("--num-samples", type=int, default=400)
    ap.add_argument("--ensembles-per-device", type=int, default=16)
    ap.add_argument("--num-chains", type=int, default=8)
    args = ap.parse_args()

    max_dev = max(args.devices)
    if args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={max_dev}"
            ).strip()
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from bcm3_tpu import analysis
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    import numpy as np

    import tempfile

    from bcm3_tpu.example_files import write_banana_example

    prior_xml, lik_xml = write_banana_example(tempfile.mkdtemp(prefix="banana_"))
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)

    avail = len(jax.devices())
    results = []
    for n in args.devices:
        if n > avail:
            print(
                json.dumps({"devices": n, "skipped": f"only {avail} devices"}),
                flush=True,
            )
            continue
        cfg = PTConfig(
            num_samples=args.num_samples,
            use_every_nth=2,
            num_chains=args.num_chains,
            num_ensembles=args.ensembles_per_device * n,
            adapt_proposal_samples=0,
            adapt_proposal_times=0,
            shard_over_devices=n > 1,
            mesh_devices=n,
            seed=11,
        )
        s = SamplerPT(prior, lik, cfg)
        s.run()  # compile
        t0 = time.time()
        res = s.run()
        dt = time.time() - t0
        rate = res["evaluations"] / dt
        # total ESS/sec: per-ensemble fixed-temperature chains (the output
        # store pools ensembles sample-major: (S*E, C, D))
        E = cfg.num_ensembles
        pooled = np.asarray(res["samples"])
        per_ens = pooled.reshape(-1, E, *pooled.shape[1:])  # (S, E, C, D)
        D = per_ens.shape[-1]
        ess_total = sum(
            float(
                np.mean(
                    [
                        analysis.effective_sample_size(per_ens[:, e, -1, d])
                        for d in range(D)
                    ]
                )
            )
            for e in range(E)
        )
        results.append(
            {
                "devices": n,
                "evals_per_sec": round(rate, 1),
                "evals_per_sec_per_device": round(rate / n, 1),
                "ess_per_sec": round(ess_total / dt, 2),
                "wall_s": round(dt, 2),
            }
        )
        print(json.dumps(results[-1]), flush=True)

    if results:
        base = results[0]
        summary = {
            "metric": "pt_weak_scaling_efficiency",
            "value": round(
                results[-1]["evals_per_sec"]
                / (results[-1]["devices"] / base["devices"])
                / base["evals_per_sec"],
                3,
            ),
            "unit": f"fraction (devices {base['devices']}->{results[-1]['devices']})",
        }
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
