"""Patient-count scaling probe (VERDICT r2 item 5).

The reference's PopPK evaluation cost is linear in the number of
patients (serial per-patient integration,
LikelihoodPopPKTrajectory.cpp:274); on the GPU the patient axis is just
another batch dimension, so evals/s should stay near-flat until the
chip saturates. This measures the headline expm config at growing
patient counts (device-only and e2e), plus the CPU surrogate at the
same trial sizes for the apples-to-apples curve.

Usage: python tools/bench_patients.py [--ensembles N] [patients...]
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from bcm3_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_rate(num_patients: int, num_evals: int = 400) -> float:
    """CPU surrogate rate at this trial size (2-thread DP5, the
    baseline_cpu.json method)."""
    from bcm3_tpu.likelihoods.poppk_synth import synthesize_trial

    trial, _ = synthesize_trial(
        num_patients=num_patients, num_timepoints=bench.NUM_TIMEPOINTS, seed=42
    )
    data_file = os.path.join(tempfile.gettempdir(), f"bcm3_trial_p{num_patients}.txt")
    with open(data_file, "w") as f:
        P, T = trial.num_patients, len(trial.time)
        f.write(f"{P} {T}\n")
        f.write(" ".join(f"{v:.17g}" for v in trial.time) + "\n")
        for j in range(P):
            f.write(" ".join(
                "nan" if np.isnan(v) else f"{v:.17g}" for v in trial.observed[j]
            ) + "\n")
        f.write(" ".join(f"{v:.17g}" for v in trial.dose) + "\n")
        f.write(" ".join(f"{v:.17g}" for v in trial.dosing_interval) + "\n")
        for j in range(P):
            f.write(" ".join(str(int(v)) for v in trial.interruptions[j]) + "\n")
    exe = os.path.join(tempfile.gettempdir(), "baseline_surrogate")
    if not os.path.exists(exe):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17",
             os.path.join(ROOT, "tools", "baseline_surrogate.cpp"),
             "-o", exe, "-pthread"],
            check=True,
        )
    out = subprocess.run(
        [exe, data_file, str(num_evals), str(os.cpu_count() or 1), "one"],
        check=True, capture_output=True, text=True,
    ).stdout
    return json.loads(out)["evals_per_sec"]


def main():
    args = sys.argv[1:]
    ens = bench.NUM_ENSEMBLES
    if "--ensembles" in args:
        i = args.index("--ensembles")
        ens = int(args[i + 1])
        del args[i:i + 2]
    skip_cpu = os.environ.get("BENCH_PATIENTS_SKIP_CPU", "0") == "1"
    # spec: "P" (headline ensembles) or "P:ensembles" — the batched expm
    # workspace scales with (patients*stops)^2 per chain, so larger
    # trials need proportionally fewer ensembles to fit
    specs = args or ["16", "64:2048", "256:512"]
    rows = []
    for spec in specs:
        if ":" in spec:
            P, e = (int(v) for v in spec.split(":"))
        else:
            P, e = int(spec), ens
        bench.NUM_PATIENTS = P
        r = bench.bench_config("one", e)
        row = {
            "patients": P,
            "ensembles": e,
            "e2e_evals_per_sec": round(r["evals_per_sec"], 1),
            "device_evals_per_sec": round(r["device_evals_per_sec"], 1),
            "patient_evals_per_sec": round(
                r["device_evals_per_sec"] * P, 1
            ),
        }
        if not skip_cpu:
            cpu = cpu_rate(P)
            row["cpu_evals_per_sec"] = round(cpu, 1)
            row["speedup_device"] = round(r["device_evals_per_sec"] / cpu, 1)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
