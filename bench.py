"""Benchmark: PT-MCMC likelihood-evaluation throughput on the PopPK workload.

The headline metric from BASELINE.json: log-prob evals/sec on the PopPK
population-pharmacokinetics ODE likelihood (the reference's primary
workload, LikelihoodPopPKTrajectory). One evaluation = simulating the full
patient population's dosing-event compartment trajectories and scoring all
observations; the sampler batches one evaluation per chain per PT step.
This matches the reference's own metric (evals/sec logged by
src/sampler/Sampler.cpp:129-137); like the reference, the count includes
the T=0 prior chain's rows — the batched evaluator computes their
likelihood too (needed for exchange moves), exactly as the reference's
T=0 chain does (SamplerPTChain.cpp:221-240).

Two configs are measured:
  - "one": one-compartment model solved by closed-form matrix exponentials
    over dosing intervals (the reference's own pharmaco module does the
    same, PharmacokineticModel.cpp:146).
  - "one_transit": transit-compartment model with an Erlang-shaped
    time-varying inflow, which has no closed form and is integrated by the
    batched adaptive DP5 solver (bcm3_tpu/ode/dp5.py) — the apples-to-apples
    comparison against the reference's adaptive-integrator hot loop
    (ODESolverCVODE.cpp:322-445 / ODESolverDP5.cpp).

Each config reports the median of N_REPS timed end-to-end runs
(steady-state: compile happens in a warmup run), plus a device-only
compute rate (no host emission) and a FLOPs estimate from XLA's
cost_analysis, from which MFU is derived against the device's published
peak (PEAKS). It needs a GPU: a run that finds none, or a device with no
entry in PEAKS, fails.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus
extra keys (device rate, MFU, transit-model numbers, CPU thread count).

vs_baseline compares against measured CPU throughput of the C++ DP5
surrogate (baseline_cpu.json, from tools/measure_baseline.py; the
reference itself is unbuildable in this image — Boost absent).
"""

import json
import os
import statistics
import sys
import tempfile
import time

NUM_PATIENTS = 16
NUM_TIMEPOINTS = 24
NUM_CHAINS = 8
# independent PT replicas batched on device, the throughput lever: 8192
# replicas x 8 chains = 65536 concurrent chains; 4096 for transit. These
# batch sizes have not been re-swept on the H100 (tools/bench_ensembles.py).
NUM_ENSEMBLES = int(os.environ.get("BENCH_ENSEMBLES", "8192"))
NUM_ENSEMBLES_TRANSIT = int(os.environ.get("BENCH_ENSEMBLES_TRANSIT", "4096"))
N_REPS = int(os.environ.get("BENCH_REPS", "3"))
NUM_SAMPLES = int(os.environ.get("BENCH_SAMPLES", "100"))
# Emit only the fixed-temperature chains, the reference's own emission
# semantics (SamplerPT.cpp:321-330 EmitSample forwards only
# GetIsFixedTemperature() chains); the heated chains never leave the
# device. Set BENCH_EMIT_FIXED=0 for the all-temperature store.
EMIT_FIXED = os.environ.get("BENCH_EMIT_FIXED", "1") != "0"

# Published peaks by JAX device_kind. H100 SXM: NVIDIA's data sheet, dense
# rates at the 700 W power limit; the bench computes in float32 outside the
# tensor cores (elementwise and control-flow heavy), so `mfu` divides by
# the 67 TFLOP/s float32 rate, and `hbm_bw_fraction` by 3.35 TB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of a device; a device not in PEAKS is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add them to "
            "bench.PEAKS with their source"
        ) from None


def build_sampler(num_samples, adapt_times, seed, pk_type="one",
                  num_ensembles=None, emit_fixed_only=False,
                  emit_dtype="float32"):
    import jax.numpy as jnp

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    d = tempfile.mkdtemp(prefix="bcm3_bench_")
    trial, truth = synthesize_trial(
        num_patients=NUM_PATIENTS, num_timepoints=NUM_TIMEPOINTS, seed=42
    )
    pkdata = os.path.join(d, "pkdata.nc")
    trial.save(pkdata, "TRIAL1", "lapatinib")
    prior_xml = os.path.join(d, "prior.xml")
    lik_xml = os.path.join(d, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, NUM_PATIENTS, pk_type)
    write_poppk_likelihood_xml(lik_xml, pkdata, "TRIAL1", "lapatinib", pk_type)

    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)
    cfg = PTConfig(
        num_samples=num_samples,
        # thin 5, matching the reference's own example configs
        # (examples/banana/config.txt: use_every_nth=5)
        use_every_nth=5,
        num_chains=NUM_CHAINS,
        num_ensembles=num_ensembles or NUM_ENSEMBLES,
        # spaced so all adapt_times boundaries fire within the run
        # (the reference adapts every adapt_proposal_samples up to
        # adapt_proposal_times, SamplerPT.cpp:231-249)
        adapt_proposal_samples=(
            num_samples // (adapt_times + 1) if adapt_times else 0
        ),
        adapt_proposal_times=adapt_times,
        max_history_size=2000,
        swapping_scheme="deterministic_even_odd",
        seed=seed,
        emit_dtype=jnp.dtype(emit_dtype),
        emit_fixed_only=emit_fixed_only,
    )
    return SamplerPT(prior, lik, cfg)


def measure_device_only(s, n_emit=20):
    """Chip-only throughput: run cached sampling segments without pulling
    samples to the host, and read XLA's FLOP estimate for the segment."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    state0 = s._init_state()
    proposals = tuple(s.proposals)
    state_host = jax.tree.map(lambda a: np.asarray(a), state0)
    fn = s._make_segment_fn(n_emit, False)
    state = jax.tree.map(jnp.asarray, state_host)
    lowered = fn.lower(state, proposals)
    compiled = lowered.compile()
    flops_per_segment = float("nan")
    bytes_per_segment = float("nan")
    try:
        ca = compiled.cost_analysis()
        flops_per_segment = float(ca["flops"])
        bytes_per_segment = float(ca.get("bytes accessed", float("nan")))
    except Exception:
        pass
    st, pr, ys = jax.block_until_ready(compiled(state, proposals))
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        st, pr, ys = compiled(st, pr)
    jax.block_until_ready((st, pr, ys))
    dt = time.time() - t0
    evals_per_segment = n_emit * s.config.use_every_nth * s.num_chains
    return {
        "device_evals_per_sec": reps * evals_per_segment / dt,
        "flops_per_eval": flops_per_segment / evals_per_segment,
        "device_flops_per_sec": reps * flops_per_segment / dt,
        "bytes_per_eval": bytes_per_segment / evals_per_segment,
        "device_bytes_per_sec": reps * bytes_per_segment / dt,
    }


def ess_stats(res, num_ensembles, elapsed, max_ensembles=256):
    """ESS/sec and samples/s/chain from a run's emitted T=1 chains.

    The emitted store pools ensembles sample-major ((S*E, L, D), row
    s*E+e), so chain e's T=1 trace is samples[e::E, -1, :]. Per-chain
    per-variable ESS is computed on a subset of ensembles (FFT-batched)
    and scaled to the full ensemble count — the chains are i.i.d.
    replicas, so the subset mean is an unbiased estimate of the
    per-chain ESS (reference quality metric: R/stats.r:86-98)."""
    import numpy as np

    from bcm3_tpu.analysis import effective_sample_size_batched

    samples = res["samples"]  # (S*E, L, D)
    E = num_ensembles
    S = samples.shape[0] // E
    D = samples.shape[2]
    Esub = min(E, max_ensembles)
    x = samples.reshape(S, E, samples.shape[1], D)[:, :Esub, -1, :]
    ess = effective_sample_size_batched(
        np.ascontiguousarray(x.reshape(S, Esub * D), dtype=np.float64)
    ).reshape(Esub, D)
    ess_mean = float(ess.mean())  # mean over variables and chains
    ess_min = float(ess.mean(axis=0).min())  # worst variable
    return {
        "samples_per_sec_per_chain": S / elapsed,
        "ess_per_chain_mean": ess_mean,
        "ess_per_chain_min_var": ess_min,
        # total sampling-quality throughput across the ensemble population
        "ess_per_sec": ess_mean * E / elapsed,
        "ess_min_var_per_sec": ess_min * E / elapsed,
    }


def bench_config(pk_type, num_ensembles, emit_fixed_only=None):
    if emit_fixed_only is None:
        emit_fixed_only = EMIT_FIXED
    s = build_sampler(NUM_SAMPLES, 0, 2024, pk_type, num_ensembles,
                      emit_fixed_only=emit_fixed_only)
    s.run()  # compile + warm caches
    rates = []
    timings = []
    res = None
    for _ in range(N_REPS):
        t0 = time.time()
        res = s.run()
        elapsed = time.time() - t0
        rates.append(res["evaluations"] / elapsed)
        timings.append(elapsed)
    dev = measure_device_only(s)
    ess = ess_stats(res, num_ensembles, statistics.median(timings))
    return {
        "evals_per_sec": statistics.median(rates),
        "evals_per_sec_reps": [round(r, 1) for r in rates],
        "num_ensembles": num_ensembles,
        **dev,
        **ess,
    }


def bench_adapted():
    """The reference's production regime: proposal adaptation ON at the
    headline config (the reference always adapts in production runs,
    SamplerPT.cpp:231-249). Measures (a) the adaptation-boundary wall
    cost — history pull -> GMM fit -> proposal push-back — and (b) the
    post-adaptation steady-state throughput/quality with the adapted
    GMM proposals (quality metric: R/stats.r:86-98)."""
    adapt_times = int(os.environ.get("BENCH_ADAPT_TIMES", "2"))
    # cold instance: compiles everything (segments + device EM) and runs
    # the adaptation boundaries once
    s = build_sampler(NUM_SAMPLES, adapt_times, 2024, "one", NUM_ENSEMBLES,
                      emit_fixed_only=EMIT_FIXED)
    t0 = time.time()
    res = s.run()
    cold_elapsed = time.time() - t0
    cold_boundary = res["adaptation_seconds"] / max(
        res["adaptation_boundaries"], 1
    )
    # warm instance: the device-EM/clustering programs are compiled and
    # segment compiles come from the persistent cache, so this run's
    # boundary span is the steady per-adaptation stall
    s2 = build_sampler(NUM_SAMPLES, adapt_times, 2024, "one", NUM_ENSEMBLES,
                       emit_fixed_only=EMIT_FIXED)
    t0 = time.time()
    res = s2.run()
    warm_elapsed = time.time() - t0
    warm_boundary = res["adaptation_seconds"] / max(
        res["adaptation_boundaries"], 1
    )
    # steady state: s2's proposals are now the adapted GMMs and no
    # further boundaries fire — these reps measure the post-adaptation
    # sampling regime
    s2.run()  # warm the full-segment compile for the adapted shapes
    rates, timings = [], []
    res = None
    for _ in range(N_REPS):
        t0 = time.time()
        res = s2.run()
        elapsed = time.time() - t0
        rates.append(res["evaluations"] / elapsed)
        timings.append(elapsed)
    ess = ess_stats(res, NUM_ENSEMBLES, statistics.median(timings))
    return {
        "evals_per_sec": statistics.median(rates),
        "evals_per_sec_reps": [round(r, 1) for r in rates],
        "adaptation_boundary_seconds": round(warm_boundary, 3),
        "adaptation_boundary_seconds_cold": round(cold_boundary, 3),
        "adaptation_boundaries": adapt_times,
        "adapted_run_seconds": round(warm_elapsed, 2),
        "cold_run_seconds": round(cold_elapsed, 2),
        **ess,
    }


def bench_nuts():
    """NUTS on the PopPK expm likelihood, ensemble-batched on the chip —
    the framework's genuinely-new capability vs the derivative-free
    reference (gradients flow through the dosing-interval expm solve).
    ESS/sec is computed over the steady-state sampling phase (warmup +
    compile excluded via the sampler's sampling_seconds)."""
    import numpy as np

    from bcm3_tpu.analysis import effective_sample_size_batched
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import NUTSConfig, SamplerNUTS

    d = tempfile.mkdtemp(prefix="bcm3_bench_nuts_")
    trial, _ = synthesize_trial(
        num_patients=NUM_PATIENTS, num_timepoints=NUM_TIMEPOINTS, seed=42
    )
    pkdata = os.path.join(d, "pkdata.nc")
    trial.save(pkdata, "TRIAL1", "lapatinib")
    prior_xml = os.path.join(d, "prior.xml")
    lik_xml = os.path.join(d, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, NUM_PATIENTS, "one")
    write_poppk_likelihood_xml(lik_xml, pkdata, "TRIAL1", "lapatinib", "one")
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)

    C = int(os.environ.get("BENCH_NUTS_CHAINS", "2048"))
    S = int(os.environ.get("BENCH_NUTS_SAMPLES", "256"))
    W = int(os.environ.get("BENCH_NUTS_WARMUP", "256"))
    # 0.9 target acceptance: the f32 leapfrog through the expm
    # recurrences carries more energy-error noise than the x64 CPU run,
    # so aim tighter than Stan's 0.8 default to keep divergences low
    ta = float(os.environ.get("BENCH_NUTS_TARGET_ACCEPT", "0.9"))
    nuts = SamplerNUTS(
        prior,
        lik,
        NUTSConfig(
            num_samples=S,
            num_warmup=W,
            num_chains=C,
            max_tree_depth=7,
            target_accept=ta,
            seed=5,
        ),
    )
    res = nuts.run()
    x = np.asarray(res["samples_per_chain"])  # (S, C, D)
    D = x.shape[2]
    Csub = min(C, 256)
    ess = effective_sample_size_batched(
        np.ascontiguousarray(
            x[:, :Csub, :].reshape(S, Csub * D), dtype=np.float64
        )
    ).reshape(Csub, D)
    per_var = ess.mean(axis=0)
    t_samp = res["sampling_seconds"]
    total_iter = S * C
    return {
        "ess_per_chain_mean": float(per_var.mean()),
        "ess_per_sec": float(per_var.mean()) * C / t_samp,
        "ess_min_var_per_sec": float(per_var.min()) * C / t_samp,
        "divergence_rate": res["divergences"] / max(total_iter, 1),
        "mean_tree_depth": float(res["mean_tree_depth"]),
        "step_size": res["step_size"],
        "sampling_seconds": round(t_samp, 2),
        "elapsed_seconds": round(res["elapsed_seconds"], 2),
        "chains": C,
        "samples": S,
    }


def bench_cellpop_matched():
    """Cellpop throughput with the Hungarian-matched per-cell
    time-course scoring (the reference's hard scoring path,
    DataLikelihoodTimeCourse.cpp + native/lap.cpp), via the two-phase
    device-cost/host-match evaluation."""
    import sys as _sys

    _sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
    import jax
    import numpy as np
    from bench_cellpop_scaling import build_likelihood

    cells = int(os.environ.get("BENCH_CELLPOP_CELLS", "128"))
    num_cells = int(os.environ.get("BENCH_CELLPOP_INITIAL", "16"))
    batch = int(os.environ.get("BENCH_CELLPOP_BATCH", "512"))
    lik = build_likelihood(0, cells, num_cells, matched=True)
    import jax.numpy as jnp

    base = jnp.asarray([0.1, 0.25, 0.15, 0.05])
    xs = base[None, :] * jnp.exp(
        0.05 * jax.random.normal(jax.random.PRNGKey(0), (batch, 4), base.dtype)
    )
    f = lik.model.log_prob_batch_hostmatch
    out = f(xs)  # compile + warmup (host matching included)
    finite = int(np.isfinite(out).sum())
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = f(xs)
    dt = (time.time() - t0) / reps
    return {
        "evals_per_sec": batch / dt,
        "ms_per_eval": dt * 1e3 / batch,
        "finite": finite,
        "config": {"max_cells": cells, "initial_cells": num_cells,
                   "batch": batch, "scoring": "hungarian_time_course"},
    }


def _bench_batched_loglik(lik, vals, batch, jitter=0.03, seed=0, reps=3):
    """Steady-state evals/sec of a vmapped log_prob at a given batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    xs = jnp.asarray(
        vals[None, :] + jitter * rng.normal(size=(batch, len(vals)))
    )
    f = jax.jit(jax.vmap(lik.log_prob))
    out = np.asarray(f(xs))  # compile + warmup
    finite = int(np.isfinite(out).sum())
    t0 = time.time()
    for _ in range(reps):
        out = f(xs)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    return {
        "evals_per_sec": batch / dt,
        "ms_per_eval": dt * 1e3 / batch,
        "finite": finite,
        "batch": batch,
    }


def bench_pharmaco():
    """pharmaco_population throughput: the general-PK likelihood solved
    by matrix exponentials over dosing intervals with per-patient random
    effects (reference: src/pharmaco/PharmacoLikelihoodPopulation.cpp:202,
    PharmacokineticModel.cpp:146)."""
    import numpy as np

    from bcm3_tpu.likelihoods.pharmaco import (
        PharmacoLikelihoodPopulation,
        PharmacoModelConfig,
    )
    from bcm3_tpu.likelihoods.poppk_synth import synthesize_trial
    from bcm3_tpu.model.variables import VariableSet

    P = int(os.environ.get("BENCH_PHARMACO_PATIENTS", "16"))
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=24, seed=31)
    vs = VariableSet()
    for n in ("mean_absorption", "sigma_absorption", "mean_clearance",
              "mean_volume_of_distribution"):
        vs.add_variable(n)
    for j in range(P):
        vs.add_variable(f"p{j+1}_absorption")
    vs.add_variable("additive_error_standard_deviation")
    lik = PharmacoLikelihoodPopulation(
        vs, trial, "lapatinib", PharmacoModelConfig()
    )
    vals = np.zeros(vs.num_variables)
    vals[vs.index_of("mean_absorption")] = -0.3
    vals[vs.index_of("sigma_absorption")] = 0.2
    vals[vs.index_of("mean_clearance")] = np.log10(18.0)
    vals[vs.index_of("mean_volume_of_distribution")] = np.log10(120.0)
    for j in range(P):
        vals[vs.index_of(f"p{j+1}_absorption")] = 0.3 + 0.02 * j
    vals[vs.index_of("additive_error_standard_deviation")] = 25.0
    # the tiny per-eval arithmetic needs a wide batch to fill the device;
    # not yet re-swept on the H100
    batch = int(os.environ.get("BENCH_PHARMACO_BATCH", "524288"))
    out = _bench_batched_loglik(lik, vals, batch)
    out["patients"] = P
    return out


def bench_incucyte():
    """incucyte_population throughput: the delay-ODE cell-growth /
    drug-response likelihood (reference:
    src/likelihoods/LikelihoodIncucytePopulation.cpp via
    CVODESolverDelay; here the batched adaptive BS3(2) DDE solver,
    ode/delay.py)."""
    import numpy as np

    _here = os.path.dirname(os.path.abspath(__file__))
    import sys as _sys

    if _here not in _sys.path:
        _sys.path.insert(0, _here)
    from tests.test_cellmisc import _incucyte_setup

    lik, values = _incucyte_setup()
    # solver resolution: grid 96 nodes over the 96 h horizon with a
    # 16-step delay ring; logp agrees with G=256 to 1.3e-5 relative over
    # 16 parameter draws and the ring covers delays up to 13 h (the
    # apoptosis_duration scale is ~6 h). Override via
    # BENCH_INCUCYTE_GRID / _RING.
    lik.grid_points = int(os.environ.get("BENCH_INCUCYTE_GRID", "96"))
    lik.ring_size = int(os.environ.get("BENCH_INCUCYTE_RING", "16"))
    # not yet re-swept on the H100
    batch = int(os.environ.get("BENCH_INCUCYTE_BATCH", "3072"))
    return _bench_batched_loglik(lik, np.asarray(values), batch,
                                 jitter=0.002)


def bench_fisa():
    """fISA steady-state signaling throughput: the bistable two-node
    feedback network with 10-start Sobol multiroot solves per eval (the
    hardest fISA path; reference: src/fISA/SignalingNetwork.cpp
    feedback solves). fISA is discontinued upstream — this row exists
    to complete likelihood-family perf coverage, no CPU anchor."""
    import tempfile

    import h5py
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.variables import VariableSet

    SBML_NS = "http://www.sbml.org/sbml/level2/version4"
    CD = "http://www.sbml.org/2001/ns/celldesigner"

    def species(sid, name):
        return (
            f'<species id="{sid}" name="{name}" initialAmount="0">'
            f'<annotation><celldesigner:extension xmlns:celldesigner="{CD}">'
            f"<celldesigner:speciesIdentity>"
            f"<celldesigner:class>PROTEIN</celldesigner:class>"
            f"</celldesigner:speciesIdentity>"
            f"</celldesigner:extension></annotation></species>"
        )

    def reaction(rid, reactant, product):
        return (
            f'<reaction id="{rid}"><annotation>'
            f'<celldesigner:extension xmlns:celldesigner="{CD}">'
            f"<celldesigner:reactionType>POSITIVE_INFLUENCE"
            f"</celldesigner:reactionType></celldesigner:extension>"
            f"</annotation>"
            f'<listOfReactants><speciesReference species="{reactant}"/>'
            f"</listOfReactants>"
            f'<listOfProducts><speciesReference species="{product}"/>'
            f"</listOfProducts></reaction>"
        )

    d = tempfile.mkdtemp(prefix="bench_fisa_")
    with open(os.path.join(d, "net.xml"), "w") as f:
        f.write(
            f'<?xml version="1.0"?>\n'
            f'<sbml xmlns="{SBML_NS}" level="2" version="4"><model id="net">'
            f"<listOfSpecies>{species('s1', 'A')}{species('s2', 'B')}"
            f"</listOfSpecies>"
            f"<listOfReactions>{reaction('r1', 's1', 's2')}"
            f"{reaction('r2', 's2', 's1')}</listOfReactions>"
            f"</model></sbml>"
        )
    with h5py.File(os.path.join(d, "data.nc"), "w") as f:
        g = f.create_group("exp1")
        g.create_dataset("cell_lines", data=np.array(["c1"], dtype="S8"))
        g.create_dataset("a_data", data=np.array([[0.057]]))
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write(
            '<bcm_likelihood type="fISA">\n'
            '<experiment name="exp1" model_file="net.xml"'
            ' data_file="data.nc" activation_limit="logistic"'
            ' multiroot_solves="10">\n'
            '  <data species_name="A" data_name="a_data"'
            ' likelihood_function="normal" use_base="false"'
            ' use_scale="false" scale_var_with_mean="false" sd="0.02"/>\n'
            "</experiment>\n"
            "</bcm_likelihood>\n"
        )
    vs = VariableSet()
    for name in ("base_A", "base_B", "strength_A_B", "strength_B_A"):
        vs.add_variable(name)
    lik = create_likelihood(os.path.join(d, "likelihood.xml"), vs)
    vals = np.asarray([0.15, 0.15, 0.8, 0.8])
    # not yet re-swept on the H100
    batch = int(os.environ.get("BENCH_FISA_BATCH", "65536"))
    return _bench_batched_loglik(lik, vals, batch, jitter=0.01)


def _bench_pt_example(example, num_chains, E, S, adapt_times, seed=7,
                      files=None):
    """ESS/sec + per-temperature acceptance rates on one reference
    example config (analytic target; sampling QUALITY per second).
    Acceptance rates pool all ensembles per ladder position — the same
    statistic the reference logs per temperature
    (SamplerPTChain.cpp:383-389). ``files`` = (prior.xml, likelihood.xml)
    overrides the upstream example directory."""
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    ref = f"/root/reference/examples/{example}"
    prior_xml, lik_xml = files or (os.path.join(ref, "prior.xml"),
                                   os.path.join(ref, "likelihood.xml"))
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)
    cfg = PTConfig(
        num_samples=S,
        use_every_nth=5,
        num_chains=num_chains,
        num_ensembles=E,
        adapt_proposal_samples=(S // 2 if adapt_times else 0),
        adapt_proposal_times=adapt_times,
        max_history_size=2000,
        swapping_scheme="deterministic_even_odd",
        seed=seed,
        emit_dtype=None,
        # reference-parity emission (EmitSample forwards only the
        # fixed-temperature chains, SamplerPT.cpp:321-330); the ESS is
        # computed on T=1 only, so pulling the heated chains was pure
        # transfer overhead
        emit_fixed_only=True,
    )
    s = SamplerPT(prior, lik, cfg)
    s.run()  # compile + adapt warmup
    # median of reps, the headline row's convention
    reps = int(os.environ.get("BENCH_PT_REPS", "3"))
    elapsed_reps = []
    for _ in range(reps):
        t0 = time.time()
        res = s.run()
        elapsed_reps.append(time.time() - t0)
    elapsed = statistics.median(elapsed_reps)
    # drop the pre-adaptation half (the reference's stats also discard
    # burn-in via sample_ix)
    samples = res["samples"].reshape(S, E, 1, -1)[S // 2:]
    from bcm3_tpu.analysis import effective_sample_size_batched

    Esub = min(E, 256)
    x = samples[:, :Esub, -1, :]
    n, D = x.shape[0], x.shape[2]
    ess = effective_sample_size_batched(
        np.ascontiguousarray(x.reshape(n, Esub * D), dtype=np.float64)
    ).reshape(Esub, D)

    acc = res.get("acceptance", {})
    rates = {}
    if acc:
        L = num_chains
        att_m = np.asarray(acc["attempted_mutate"], dtype=np.float64)
        acc_m = np.asarray(acc["accepted_mutate"], dtype=np.float64)
        att_e = np.asarray(acc["attempted_exchange"], dtype=np.float64)
        acc_e = np.asarray(acc["accepted_exchange"], dtype=np.float64)
        att_m = att_m.reshape(E, L).sum(0)
        acc_m = acc_m.reshape(E, L).sum(0)
        att_e = att_e.reshape(E, L).sum(0)
        acc_e = acc_e.reshape(E, L).sum(0)
        rates = {
            "mutate_rate": [
                round(a / m, 4) if m else None for a, m in zip(acc_m, att_m)
            ],
            "exchange_rate": [
                round(a / m, 4) if m else None for a, m in zip(acc_e, att_e)
            ],
            # binomial MC standard error per rate (pooled attempts)
            "mutate_rate_se": [
                round(float(np.sqrt(max(p * (1 - p), 1e-12) / m)), 5)
                if m else None
                for p, m in zip(acc_m / np.maximum(att_m, 1), att_m)
            ],
        }

    return {
        "evals_per_sec": res["evaluations"] / elapsed,
        "ess_per_chain_mean": float(ess.mean()),
        "ess_per_sec": float(ess.mean()) * E / elapsed,
        "samples_per_sec_per_chain": S / elapsed,
        "ensembles": E,
        "elapsed_reps": [round(e, 2) for e in elapsed_reps],
        **rates,
    }


def bench_banana(adapt_times=1):
    """The banana example at the reference's own config shape
    (examples/banana/config.txt: 6 chains, GMM proposal, thin 5, one
    adaptation). adapt_times=0 gives the never-adapted A/B arm."""
    from bcm3_tpu.example_files import write_banana_example

    # per-chain ESS does not depend on the ensemble count, so the
    # ensembles are quality throughput; not yet re-swept on the H100
    E = int(os.environ.get("BENCH_BANANA_ENSEMBLES", "8192"))
    S = int(os.environ.get("BENCH_BANANA_SAMPLES", "800"))
    files = write_banana_example(tempfile.mkdtemp(prefix="bcm3_bench_banana_"))
    return _bench_pt_example("banana", 6, E, S, adapt_times, files=files)


def bench_circular(adapt_times=1):
    """The multimodal circular-ridge example (the reference's own
    multimodal showcase: 16-chain ladder, deterministic even/odd swaps,
    examples/multimodal_circular_ridge/config.txt) — the A/B target for
    'adaptation buys mixing on multimodal posteriors'."""
    E = int(os.environ.get("BENCH_CIRCULAR_ENSEMBLES", "2048"))
    S = int(os.environ.get("BENCH_CIRCULAR_SAMPLES", "800"))
    return _bench_pt_example("multimodal_circular_ridge", 16, E, S,
                             adapt_times)


def bench_cellpop21():
    """Reference-shaped cellpop: the 21-species stiff kinase-cascade
    model (real cell-cycle models have tens of species,
    src/cellpop/Experiment.cpp SBML models) through the sparse-pattern
    stage solver (ode/sparse_lu.py). The CPU anchor is the same-shape
    C++ RODAS3 cascade (tools/baseline_cellpop.cpp modules=8)."""
    import sys as _sys

    _sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench_cellpop_scaling import build_likelihood

    cells = int(os.environ.get("BENCH_CELLPOP_CELLS", "128"))
    num_cells = int(os.environ.get("BENCH_CELLPOP_INITIAL", "16"))
    # not yet re-swept on the H100
    batch = int(os.environ.get("BENCH_CELLPOP21_BATCH", "512"))
    lik = build_likelihood(8, cells, num_cells, matched=False)
    base = jnp.asarray([0.1, 0.25, 0.15, 0.05])
    xs = base[None, :] * jnp.exp(
        0.05 * jax.random.normal(jax.random.PRNGKey(0), (batch, 4), base.dtype)
    )
    f = jax.jit(jax.vmap(lik.log_prob))
    out = np.asarray(f(xs))
    finite = int(np.isfinite(out).sum())
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = f(xs)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    return {
        "evals_per_sec": batch / dt,
        "ms_per_eval": dt * 1e3 / batch,
        "finite": finite,
        "config": {"species": 21, "max_cells": cells,
                   "initial_cells": num_cells, "batch": batch},
    }


def bench_cellpop():
    """Cell-population likelihood throughput: dividing stiff cells with
    Sobol variability under batched evaluation (the deepest reference
    workload, src/cellpop/Experiment.cpp:635-846). Config via
    BENCH_CELLPOP_* env; returns evals/sec at steady state."""
    import sys as _sys

    _sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
    import jax
    import numpy as np
    from bench_cellpop import build_likelihood

    cells = int(os.environ.get("BENCH_CELLPOP_CELLS", "128"))
    num_cells = int(os.environ.get("BENCH_CELLPOP_INITIAL", "16"))
    # not yet re-swept on the H100
    batch = int(os.environ.get("BENCH_CELLPOP_BATCH", "512"))
    # 0 = adaptive while_loop stepping; >0 = the static budget form
    trips = int(os.environ.get("BENCH_CELLPOP_TRIPS", "0"))
    solver = os.environ.get("BENCH_CELLPOP_SOLVER", "CVODE")
    lik = build_likelihood(cells, num_cells, solver, trips)
    import jax.numpy as jnp

    base = jnp.asarray([0.1, 0.25, 0.15, 0.05])
    xs = base[None, :] * jnp.exp(
        0.05 * jax.random.normal(jax.random.PRNGKey(0), (batch, 4), base.dtype)
    )
    f = jax.jit(jax.vmap(lik.log_prob))
    out = np.asarray(f(xs))  # compile + warmup
    finite = int(np.isfinite(out).sum())
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = f(xs)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    return {
        "evals_per_sec": batch / dt,
        "ms_per_eval": dt * 1e3 / batch,
        "finite": finite,
        "config": {
            "max_cells": cells,
            "initial_cells": num_cells,
            "batch": batch,
            "solver": solver,
            "trips": trips,
        },
    }


def _acceptance_parity(banana, base):
    """Side-by-side per-temperature mutate/exchange acceptance rates:
    this engine vs the C++ engine anchor (baseline_cpu.json
    banana_acceptance), same ladder/proposal/adaptation cadence.
    Agreement within a few binomial MC standard errors closes the
    BASELINE.md swap-rate-parity target
    (reference: SamplerPTChain.cpp:383-389, SamplerPT.cpp:262-275)."""
    cpu = base.get("banana_acceptance")
    engine_m = banana.get("mutate_rate")
    engine_e = banana.get("exchange_rate")
    if not cpu or not engine_m:
        return None
    cm = cpu.get("mutate_rate", [])
    ce = cpu.get("exchange_rate", [])
    dm = [
        round(abs(a - b), 4)
        for a, b in zip(engine_m, cm)
        if a is not None and b is not None
    ]
    de = [
        round(abs(a - b), 4)
        for a, b in zip(engine_e, ce)
        if a is not None and b is not None
    ]
    return {
        "temperatures": cpu.get("temperatures"),
        "engine_mutate_rate": engine_m,
        "cpu_mutate_rate": cm,
        "engine_exchange_rate": engine_e,
        "cpu_exchange_rate": ce,
        "max_abs_diff_mutate": max(dm) if dm else None,
        "max_abs_diff_exchange": max(de) if de else None,
    }


def main():
    import jax

    from bcm3_tpu.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {jax.devices()}")
    enable_compile_cache()
    device_kind = dev.device_kind
    peaks = device_peaks(device_kind)
    peak = peaks["flops"]

    headline = bench_config("one", NUM_ENSEMBLES)
    print(
        f"# headline done: {headline['evals_per_sec']:.0f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        transit = bench_config("one_transit", NUM_ENSEMBLES_TRANSIT)
    except Exception as e:  # keep the headline even if transit fails
        print(f"# transit config failed: {e!r}", file=sys.stderr, flush=True)
        nan = float("nan")
        transit = {
            "evals_per_sec": nan,
            "evals_per_sec_reps": [],
            "device_evals_per_sec": nan,
            "flops_per_eval": nan,
            "device_flops_per_sec": nan,
            "num_ensembles": NUM_ENSEMBLES_TRANSIT,
        }
    print(
        f"# transit done: {transit['evals_per_sec']:.0f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        adapted = bench_adapted()
    except Exception as e:
        print(f"# adapted config failed: {e!r}", file=sys.stderr, flush=True)
        nan = float("nan")
        adapted = {
            "evals_per_sec": nan,
            "evals_per_sec_reps": [],
            "adaptation_boundary_seconds": nan,
            "adaptation_boundary_seconds_cold": nan,
            "adaptation_boundaries": 0,
            "ess_per_sec": nan,
            "ess_per_chain_mean": nan,
            "ess_min_var_per_sec": nan,
            "samples_per_sec_per_chain": nan,
        }
    print(
        f"# adapted done: {adapted['evals_per_sec']:.0f} evals/s, "
        f"boundary {adapted['adaptation_boundary_seconds']}s",
        file=sys.stderr,
        flush=True,
    )
    try:
        nuts = bench_nuts()
    except Exception as e:
        print(f"# nuts config failed: {e!r}", file=sys.stderr, flush=True)
        nan = float("nan")
        nuts = {
            "ess_per_sec": nan,
            "ess_per_chain_mean": nan,
            "ess_min_var_per_sec": nan,
            "divergence_rate": nan,
            "mean_tree_depth": nan,
            "sampling_seconds": nan,
            "chains": 0,
        }
    print(
        f"# nuts done: {nuts['ess_per_sec']:.0f} ESS/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        cellpop = bench_cellpop()
    except Exception as e:
        print(f"# cellpop config failed: {e!r}", file=sys.stderr, flush=True)
        cellpop = {"evals_per_sec": float("nan"), "config": {}}
    print(
        f"# cellpop done: {cellpop['evals_per_sec']:.1f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        cellpop_matched = bench_cellpop_matched()
    except Exception as e:
        print(
            f"# cellpop matched config failed: {e!r}", file=sys.stderr,
            flush=True,
        )
        cellpop_matched = {"evals_per_sec": float("nan"), "config": {}}
    print(
        f"# cellpop matched done: {cellpop_matched['evals_per_sec']:.1f} "
        "evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        pharmaco = bench_pharmaco()
    except Exception as e:
        print(f"# pharmaco config failed: {e!r}", file=sys.stderr, flush=True)
        pharmaco = {"evals_per_sec": float("nan")}
    print(
        f"# pharmaco done: {pharmaco['evals_per_sec']:.0f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        incucyte = bench_incucyte()
    except Exception as e:
        print(f"# incucyte config failed: {e!r}", file=sys.stderr, flush=True)
        incucyte = {"evals_per_sec": float("nan")}
    print(
        f"# incucyte done: {incucyte['evals_per_sec']:.0f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        fisa = bench_fisa()
    except Exception as e:
        print(f"# fisa config failed: {e!r}", file=sys.stderr, flush=True)
        fisa = {"evals_per_sec": float("nan")}
    print(
        f"# fisa done: {fisa['evals_per_sec']:.0f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        cellpop21 = bench_cellpop21()
    except Exception as e:
        print(f"# cellpop21 config failed: {e!r}", file=sys.stderr, flush=True)
        cellpop21 = {"evals_per_sec": float("nan"), "config": {}}
    print(
        f"# cellpop21 done: {cellpop21['evals_per_sec']:.1f} evals/s",
        file=sys.stderr,
        flush=True,
    )
    _nan_banana = {
        "evals_per_sec": float("nan"),
        "ess_per_sec": float("nan"),
        "ess_per_chain_mean": float("nan"),
        "samples_per_sec_per_chain": float("nan"),
    }
    try:
        banana = bench_banana()
    except Exception as e:
        print(f"# banana config failed: {e!r}", file=sys.stderr, flush=True)
        banana = dict(_nan_banana)
    print(
        f"# banana done: {banana['ess_per_sec']:.0f} ESS/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        banana_un = bench_banana(adapt_times=0)
    except Exception as e:
        print(f"# banana unadapted failed: {e!r}", file=sys.stderr, flush=True)
        banana_un = dict(_nan_banana)
    print(
        f"# banana unadapted done: {banana_un['ess_per_sec']:.0f} ESS/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        circular = bench_circular()
    except Exception as e:
        print(f"# circular config failed: {e!r}", file=sys.stderr, flush=True)
        circular = dict(_nan_banana)
    print(
        f"# circular done: {circular['ess_per_sec']:.0f} ESS/s",
        file=sys.stderr,
        flush=True,
    )
    try:
        circular_un = bench_circular(adapt_times=0)
    except Exception as e:
        print(f"# circular unadapted failed: {e!r}", file=sys.stderr,
              flush=True)
        circular_un = dict(_nan_banana)
    print(
        f"# circular unadapted done: {circular_un['ess_per_sec']:.0f} ESS/s",
        file=sys.stderr,
        flush=True,
    )

    base = {}
    baseline_file = os.path.join(os.path.dirname(__file__), "baseline_cpu.json")
    if os.path.exists(baseline_file):
        with open(baseline_file) as f:
            base = json.load(f)

    def ratio(v, key):
        ref = base.get(key)
        if not ref or v != v:
            return None
        return round(v / ref, 3)

    def mfu(r):
        if peak and r["device_flops_per_sec"] == r["device_flops_per_sec"]:
            return round(r["device_flops_per_sec"] / peak, 6)
        return None

    peak_bw = peaks["hbm_bytes_per_s"]

    def hbm_frac(r):
        v = r.get("device_bytes_per_sec", float("nan"))
        if peak_bw and v == v:
            return round(v / peak_bw, 4)
        return None

    def rnd(x, k=1):
        return round(x, k) if x == x else None

    out = {
        "metric": "poppk_pt_mcmc_llh_evals_per_sec",
        "value": round(headline["evals_per_sec"], 1),
        "unit": "evals/s",
        "vs_baseline": ratio(headline["evals_per_sec"], "poppk_evals_per_sec"),
        "reps": headline["evals_per_sec_reps"],
        "device_only_evals_per_sec": round(headline["device_evals_per_sec"], 1),
        "flops_per_eval": round(headline["flops_per_eval"], 1),
        "mfu": mfu(headline),
        "bytes_per_eval": rnd(headline["bytes_per_eval"]),
        "hbm_bw_fraction": hbm_frac(headline),
        "samples_per_sec_per_chain": rnd(headline["samples_per_sec_per_chain"], 2),
        "ess_per_chain_mean": rnd(headline["ess_per_chain_mean"], 2),
        "ess_per_sec": rnd(headline["ess_per_sec"]),
        "ess_min_var_per_sec": rnd(headline["ess_min_var_per_sec"]),
        "transit_evals_per_sec": round(transit["evals_per_sec"], 1),
        "transit_vs_baseline": ratio(
            transit["evals_per_sec"], "poppk_transit_evals_per_sec"
        ),
        "transit_reps": transit["evals_per_sec_reps"],
        "transit_device_only_evals_per_sec": round(
            transit["device_evals_per_sec"], 1
        ),
        "transit_mfu": mfu(transit),
        "transit_hbm_bw_fraction": hbm_frac(transit),
        "transit_ess_per_sec": rnd(transit.get("ess_per_sec", float("nan"))),
        # adaptation-ON regime (the reference's production configuration)
        "adapted_evals_per_sec": rnd(adapted["evals_per_sec"]),
        "adapted_evals_per_sec_reps": adapted.get("evals_per_sec_reps"),
        "adapted_ess_per_sec": rnd(adapted["ess_per_sec"]),
        "adapted_ess_min_var_per_sec": rnd(adapted["ess_min_var_per_sec"]),
        "adapted_ess_per_chain_mean": rnd(adapted["ess_per_chain_mean"], 2),
        "adapted_samples_per_sec_per_chain": rnd(
            adapted.get("samples_per_sec_per_chain", float("nan")), 2
        ),
        "adaptation_boundary_seconds": adapted["adaptation_boundary_seconds"],
        "adaptation_boundary_seconds_cold": adapted[
            "adaptation_boundary_seconds_cold"
        ],
        "adaptation_boundaries": adapted["adaptation_boundaries"],
        # NUTS on-device (capability the derivative-free reference lacks)
        "nuts_ess_per_sec": rnd(nuts["ess_per_sec"]),
        "nuts_ess_min_var_per_sec": rnd(nuts["ess_min_var_per_sec"]),
        "nuts_ess_per_chain_mean": rnd(nuts["ess_per_chain_mean"], 2),
        "nuts_divergence_rate": rnd(nuts["divergence_rate"], 5),
        "nuts_mean_tree_depth": rnd(nuts["mean_tree_depth"], 2),
        "nuts_chains": nuts["chains"],
        "nuts_sampling_seconds": nuts["sampling_seconds"],
        "cellpop_evals_per_sec": rnd(cellpop["evals_per_sec"], 2),
        "cellpop_vs_baseline": ratio(
            cellpop["evals_per_sec"], "cellpop_evals_per_sec"
        ),
        "cellpop_config": cellpop.get("config"),
        "cellpop_matched_evals_per_sec": rnd(
            cellpop_matched["evals_per_sec"], 2
        ),
        # CPU anchor: the same-shape Hungarian-matched C++ run
        # (tools/baseline_cellpop.cpp matched=1)
        "cellpop_matched_vs_baseline": ratio(
            cellpop_matched["evals_per_sec"], "cellpop_matched_evals_per_sec"
        ),
        "cellpop_matched_config": cellpop_matched.get("config"),
        # reference-shaped (21-species) cellpop through the sparse stage
        # solver, with its same-shape CPU anchor
        "cellpop21_evals_per_sec": rnd(cellpop21["evals_per_sec"], 2),
        "cellpop21_vs_baseline": ratio(
            cellpop21["evals_per_sec"], "cellpop21_evals_per_sec"
        ),
        "cellpop21_config": cellpop21.get("config"),
        # remaining live likelihood families (reference:
        # src/pharmaco/PharmacoLikelihoodPopulation.cpp,
        # src/likelihoods/LikelihoodIncucytePopulation.cpp)
        "pharmaco_evals_per_sec": rnd(pharmaco["evals_per_sec"]),
        "pharmaco_vs_baseline": ratio(
            pharmaco["evals_per_sec"], "pharmaco_evals_per_sec"
        ),
        "pharmaco_batch": pharmaco.get("batch"),
        "incucyte_evals_per_sec": rnd(incucyte["evals_per_sec"], 2),
        "incucyte_vs_baseline": ratio(
            incucyte["evals_per_sec"], "incucyte_evals_per_sec"
        ),
        "incucyte_batch": incucyte.get("batch"),
        # fISA (discontinued upstream; row completes family coverage)
        "fisa_evals_per_sec": rnd(fisa["evals_per_sec"]),
        "fisa_batch": fisa.get("batch"),
        "banana_ess_per_sec": rnd(banana["ess_per_sec"]),
        # vs the C++ CPU PT-GMM surrogate on the same target (isolates
        # the sampler ENGINE ratio from the batched-ODE wins)
        "banana_vs_baseline": ratio(
            banana["ess_per_sec"], "banana_ess_per_sec"
        ),
        "banana_ess_per_chain_mean": rnd(banana["ess_per_chain_mean"], 2),
        "banana_samples_per_sec_per_chain": rnd(
            banana["samples_per_sec_per_chain"], 2
        ),
        "banana_evals_per_sec": rnd(banana["evals_per_sec"]),
        # A/B: the flagship adaptation machinery vs the never-adapted
        # prior-scaled proposal, on the multimodal showcases
        "banana_ess_per_sec_unadapted": rnd(banana_un["ess_per_sec"]),
        "banana_ess_per_chain_mean_unadapted": rnd(
            banana_un["ess_per_chain_mean"], 2
        ),
        "circular_ess_per_sec": rnd(circular["ess_per_sec"]),
        "circular_ess_per_chain_mean": rnd(
            circular["ess_per_chain_mean"], 2
        ),
        "circular_ess_per_sec_unadapted": rnd(circular_un["ess_per_sec"]),
        "circular_ess_per_chain_mean_unadapted": rnd(
            circular_un["ess_per_chain_mean"], 2
        ),
        # swap/mutate acceptance-rate parity: this engine vs the C++
        # engine on the same config/ladder (SamplerPTChain.cpp:383-389)
        "banana_acceptance_parity": _acceptance_parity(banana, base),
        "device": {"platform": dev.platform, "kind": device_kind,
                   "count": len(jax.devices())},
        "cpu_baseline_threads": base.get("threads"),
        "config": {
            "patients": NUM_PATIENTS,
            "timepoints": NUM_TIMEPOINTS,
            "chains": NUM_CHAINS,
            "ensembles": NUM_ENSEMBLES,
            "ensembles_transit": NUM_ENSEMBLES_TRANSIT,
            "thin": 5,
            "samples": NUM_SAMPLES,
            "emit_fixed_only": EMIT_FIXED,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
