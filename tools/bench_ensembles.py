"""Steady-state ensemble-scaling probe (VERDICT r2 item 2).

After the proposal-memory fix (54f942f: GMM proposal params at
(L, K, D, D) instead of (C, K, D, D)) the single-chip ensemble ceiling
moved from 16,384 to 65,536 ensembles (tools/hbm_probe.py). This probe
measures the STEADY-STATE bench throughput (bench.bench_config: median
of timed runs after a warmup run) across ensemble counts to pick the
best stable headline config for bench.py.

Usage: python tools/bench_ensembles.py [--transit] [sizes...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from bcm3_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import bench


def main():
    args = [a for a in sys.argv[1:]]
    transit = "--transit" in args
    sizes = [int(a) for a in args if not a.startswith("--")]
    if not sizes:
        sizes = [1024, 2048, 4096, 8192] if transit else [8192, 16384, 32768, 65536]
    pk_type = "one_transit" if transit else "one"
    results = {}
    for ne in sizes:
        try:
            r = bench.bench_config(pk_type, ne)
            results[ne] = r
            print(
                f"ensembles={ne}: {r['evals_per_sec']:.0f} evals/s e2e "
                f"(reps {r['evals_per_sec_reps']}), "
                f"device-only {r['device_evals_per_sec']:.0f}",
                flush=True,
            )
        except Exception as e:
            print(f"ensembles={ne}: FAILED {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
    out = {
        str(k): {
            "evals_per_sec": round(v["evals_per_sec"], 1),
            "reps": v["evals_per_sec_reps"],
            "device_evals_per_sec": round(v["device_evals_per_sec"], 1),
        }
        for k, v in results.items()
    }
    print(json.dumps({"pk_type": pk_type, "results": out}))


if __name__ == "__main__":
    main()
