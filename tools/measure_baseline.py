"""Measure the CPU baseline for the PopPK workload.

The reference cannot be compiled here (no Boost), so we measure a C++
surrogate performing the same per-evaluation work with the reference's
own solver algorithm (see tools/baseline_surrogate.cpp). Writes
baseline_cpu.json at the repo root, which bench.py uses for vs_baseline.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bcm3_tpu.likelihoods.poppk_synth import synthesize_trial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(num_evals: int = 2000):
    trial, truth = synthesize_trial(num_patients=16, num_timepoints=24, seed=42)
    data_file = os.path.join(tempfile.gettempdir(), "bcm3_baseline_trial.txt")
    with open(data_file, "w") as f:
        P, T = trial.num_patients, len(trial.time)
        f.write(f"{P} {T}\n")
        f.write(" ".join(f"{v:.17g}" for v in trial.time) + "\n")
        for j in range(P):
            f.write(
                " ".join(
                    "nan" if np.isnan(v) else f"{v:.17g}" for v in trial.observed[j]
                )
                + "\n"
            )
        f.write(" ".join(f"{v:.17g}" for v in trial.dose) + "\n")
        f.write(" ".join(f"{v:.17g}" for v in trial.dosing_interval) + "\n")
        for j in range(P):
            f.write(" ".join(str(int(v)) for v in trial.interruptions[j]) + "\n")

    exe = os.path.join(tempfile.gettempdir(), "baseline_surrogate")
    subprocess.run(
        [
            "g++",
            "-O3",
            "-march=native",
            "-std=c++17",
            os.path.join(ROOT, "tools", "baseline_surrogate.cpp"),
            "-o",
            exe,
            "-pthread",
        ],
        check=True,
    )
    n_threads = os.cpu_count() or 1

    def run_model(model):
        out = subprocess.run(
            [exe, data_file, str(num_evals), str(n_threads), model],
            check=True,
            capture_output=True,
            text=True,
        ).stdout
        return json.loads(out)["evals_per_sec"]

    # cellpop anchor: dividing stiff cells, RODAS3 + analytic Jacobian
    # (see tools/baseline_cellpop.cpp; same model as tools/bench_cellpop.py)
    exe_cp = os.path.join(tempfile.gettempdir(), "baseline_cellpop")
    subprocess.run(
        [
            "g++", "-O3", "-march=native", "-std=c++17",
            os.path.join(ROOT, "tools", "baseline_cellpop.cpp"),
            "-o", exe_cp, "-pthread",
        ],
        check=True,
    )
    n_cp = max(num_evals // 20, 50)
    cp = json.loads(
        subprocess.run(
            [exe_cp, str(n_cp), str(n_threads), "128", "16"],
            check=True, capture_output=True, text=True,
        ).stdout
    )

    # sampler-engine anchor: reference-style PT-GMM loop on the banana
    # example (tools/baseline_banana.cpp) — isolates the engine ratio
    # from the batched-ODE wins
    exe_bn = os.path.join(tempfile.gettempdir(), "baseline_banana")
    subprocess.run(
        [
            "g++", "-O3", "-march=native", "-std=c++17",
            os.path.join(ROOT, "tools", "baseline_banana.cpp"),
            "-o", exe_bn, "-pthread",
        ],
        check=True,
    )
    bn = json.loads(
        subprocess.run(
            [exe_bn, "8000", str(n_threads)],
            check=True, capture_output=True, text=True,
        ).stdout
    )

    result = {
        "poppk_evals_per_sec": run_model("one"),
        "poppk_transit_evals_per_sec": run_model("one_transit"),
        "banana_ess_per_sec": bn["banana_ess_per_sec"],
        "banana_evals_per_sec": bn["evals_per_sec"],
        "cellpop_evals_per_sec": cp["cellpop_evals_per_sec"],
        "cellpop_config": {
            "max_cells": cp["max_cells"],
            "initial_cells": cp["initial_cells"],
            "num_evals": n_cp,
        },
        "threads": n_threads,
        "num_evals": num_evals,
        "workload": "PopPK 16 patients, 24 timepoints, 14-day horizon; "
        "models: one-compartment + one-compartment-transit; "
        "cellpop: dividing stiff cells (128 max, 16 initial)",
        "method": "C++ DP5 surrogate (see tools/baseline_surrogate.cpp) + "
        "C++ RODAS3 cellpop surrogate (tools/baseline_cellpop.cpp) + "
        "C++ PT-GMM engine surrogate on banana (tools/baseline_banana.cpp); "
        "reference itself unbuildable here (Boost absent)",
    }
    with open(os.path.join(ROOT, "baseline_cpu.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2000)
