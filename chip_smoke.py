"""Proof that the PT-MCMC main path runs on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: sharded headline vs one GPU

Phases (one process; each prints its numbers beside the card's name and
power limit):

1. device: the first JAX device must be a GPU;
2. transit kernel: the fused budget-DP5 kernel against XLA's lowering of
   the same likelihood at 524,288 solver lanes (f32), and a subset against
   the same likelihood in f64 on the CPU; both timed;
3. PopPK "one" headline: prior/likelihood XML -> create_likelihood ->
   SamplerPT.run() at 8 chains x 8192 ensembles, one adaptation boundary;
4. PopPK "one_transit": the same at 8 chains x 4096 ensembles;
5. banana: PT with GMM adaptation against the C++ engine
   (tools/baseline_banana.cpp, baseline_cpu.json banana_engine_cpp): T=1
   moments and per-temperature acceptance rates; quadrature printed;
6. CLI: a PopPK config.txt run through bcm3_tpu.cli.main, output.nc read
   back (needs h5py).

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed. The script exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

PATIENTS = 16
TIMEPOINTS = 24
LADDER = 8
ENSEMBLES_ONE = 8192  # 65,536 chains
ENSEMBLES_TRANSIT = 4096  # 32,768 chains x 16 patients = 524,288 lanes
THIN = 5
HISTORY = 2000
# "one": 220 emitted samples with one adaptation boundary after 200, so the
# history ring holds 200 x thin 5 x 2 = 2000 rows (max_history_size), the
# size a default run (adapt_proposal_samples=2000) uses: 65,536 chains x
# 2000 rows x D=40 x 4 bytes = 21 GB on the device
ONE_SAMPLES = 220
ONE_ADAPT_AT = 200
# "one_transit" and --four: 40 emitted samples, the boundary after 20
# (a 200-row ring)
PT_SAMPLES = 40
PT_ADAPT_AT = 20
LOGLIK_DRAWS = 4096
TRANSIT_CPU_DRAWS = 1024
TIMING_CALLS = 7

# Tolerances, fixed before any chip run, as (rtol, atol, largest share of
# draws whose soft-fail status may differ, largest median relative
# difference). Entries finite on both sides must agree within
# atol + rtol * |reference|.
# - "one" (closed form), GPU f32 against CPU f64: f32 rounding only; draws
#   in the prior's tails over- or underflow exp() in f32 and soft-fail
#   (CPU f32 vs f64, 4096 draws: max rel 2.7e-5, 0.66% flips).
# - "one_transit", f32 against f64, and the kernel against XLA (both f32):
#   the solve runs its step controller at rtol 1e-6, at the f32 noise
#   floor, so a last-bit difference can flip an accept/reject decision and
#   move a lane onto another step sequence or over its step budget
#   (CPU f32 vs f64, 1024 draws: median rel 1.4e-7, 99th percentile
#   3.2e-3, max 1.1e-2, 0.2% flips; kernel in the interpreter vs XLA f32:
#   max 1.2e-2, 0.2% flips). The median bounds a systematic difference.
LOGLIK_TOL = {
    "one": (1e-4, 1e-2, 0.02, 1e-6),
    "one_transit": (5e-2, 1e-2, 0.01, 1e-5),
}
KERNEL_TOL = LOGLIK_TOL["one_transit"]
BANANA_LADDER = 6
BANANA_ENSEMBLES = 32
BANANA_SAMPLES = 8000  # x thin 5, adapt once after 2000: the anchor's run
BANANA_ADAPT_AT = 2000
BANANA_HISTORY = 5000
N_SIGMA = 4.0


class PhaseFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peak_bytes(device) -> int:
    return int(device.memory_stats().get("peak_bytes_in_use", -1))


def timed_median(fn, *args, calls=TIMING_CALLS):
    """Median wall time of ``calls`` calls after one warm-up call, each
    ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def compare(got, ref, rtol, atol, max_flip_share, max_median=np.inf):
    """Soft-fail sets may differ in at most ``max_flip_share`` of entries;
    entries finite in both agree within atol + rtol*|ref|, and their median
    relative difference is at most ``max_median``."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    fin_g, fin_r = np.isfinite(got), np.isfinite(ref)
    both = fin_g & fin_r
    flips = int(np.sum(fin_g != fin_r))
    g, r = got[both], ref[both]
    rel = np.abs(g - r) / np.maximum(np.abs(r), 1e-300)
    n_bad = int(np.sum(np.abs(g - r) > atol + rtol * np.abs(r)))
    return {
        "n": int(got.size),
        "finite_both": int(both.sum()),
        "softfail_differs": flips,
        "max_rel_diff": float(rel.max()) if both.any() else None,
        "median_rel_diff": float(np.median(rel)) if both.any() else None,
        "outside_tol": n_bad,
        "ok": bool(
            both.any()
            and n_bad == 0
            and flips <= max_flip_share * got.size
            and np.median(rel) <= max_median
        ),
    }


def build_poppk(directory, pk_type):
    """The PopPK cell's model through the user's entry points: synthetic
    trial data file, prior.xml and likelihood.xml, create_likelihood."""
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet

    trial, _ = synthesize_trial(
        num_patients=PATIENTS, num_timepoints=TIMEPOINTS, seed=42
    )
    pkdata = os.path.join(directory, f"pkdata_{pk_type}.nc")
    trial.save(pkdata, "TRIAL1", "lapatinib")
    prior_xml = os.path.join(directory, f"prior_{pk_type}.xml")
    lik_xml = os.path.join(directory, f"likelihood_{pk_type}.xml")
    write_poppk_prior_xml(prior_xml, PATIENTS, pk_type)
    write_poppk_likelihood_xml(lik_xml, pkdata, "TRIAL1", "lapatinib", pk_type)
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    return prior, create_likelihood(lik_xml, varset), (prior_xml, lik_xml)


def poppk_config(num_ensembles, num_samples=PT_SAMPLES, adapt_at=PT_ADAPT_AT,
                 seed=2024, **kw):
    import jax.numpy as jnp

    from bcm3_tpu.sampler import PTConfig

    return PTConfig(
        num_samples=num_samples,
        use_every_nth=THIN,
        num_chains=LADDER,
        num_ensembles=num_ensembles,
        adapt_proposal_samples=adapt_at,
        adapt_proposal_times=1,
        max_history_size=HISTORY,
        swapping_scheme="deterministic_even_odd",
        seed=seed,
        dtype=jnp.float32,
        emit_dtype=jnp.float32,
        emit_fixed_only=True,
        **kw,
    )


def prior_draws(prior, n, seed):
    import jax
    import jax.numpy as jnp

    return prior.sample(jax.random.PRNGKey(seed), (n,)).astype(jnp.float32)


def loglik_cpu_f64(lik, xs):
    """The same likelihood in float64 on the host CPU (the reference)."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        x = jax.device_put(np.asarray(xs, np.float64), cpu)
        return np.asarray(jax.jit(jax.vmap(lik.log_prob))(x))


def acceptance_rates(res, ladder):
    acc = res["acceptance"]

    def pooled(name):
        return np.asarray(acc[name], np.float64).reshape(-1, ladder).sum(0)

    return {
        "mutate_attempts": pooled("attempted_mutate"),
        "mutate_rate": pooled("accepted_mutate")
        / np.maximum(pooled("attempted_mutate"), 1),
        "exchange_attempts": pooled("attempted_exchange"),
        "exchange_rate": pooled("accepted_exchange")
        / np.maximum(pooled("attempted_exchange"), 1),
    }


# ---------------------------------------------------------------------------
# phases


def phase_transit_kernel(directory, tag, ensembles=ENSEMBLES_TRANSIT,
                         cpu_draws=TRANSIT_CPU_DRAWS, calls=TIMING_CALLS):
    import jax

    prior, lik, _ = build_poppk(directory, "one_transit")
    model = lik.model
    n = ensembles * LADDER
    lanes = n * PATIENTS
    xs = prior_draws(prior, n, seed=11)
    check(model.uses_transit_kernel(xs.dtype),
          "the transit kernel is not dispatched for f32 on this backend")
    kernel_fn = jax.jit(lik.log_prob_batched)
    xla_fn = jax.jit(jax.vmap(lik.log_prob))
    got = np.asarray(kernel_fn(xs))
    ref = np.asarray(xla_fn(xs))
    rtol, atol, flip, med = KERNEL_TOL
    vs_xla = compare(got, ref, rtol, atol, flip, med)
    print(f"transit kernel vs XLA f32, {lanes} lanes ({n} draws), "
          f"rtol={rtol} atol={atol} softfail share<={flip} median<={med}: "
          f"{json.dumps(vs_xla)} {tag}")
    rtol64, atol64, flip64, med64 = LOGLIK_TOL["one_transit"]
    vs_f64 = compare(got[:cpu_draws], loglik_cpu_f64(lik, xs[:cpu_draws]),
                     rtol64, atol64, flip64, med64)
    print(f"transit kernel f32 vs CPU f64, {cpu_draws} draws, "
          f"rtol={rtol64} atol={atol64} softfail share<={flip64} "
          f"median<={med64}: "
          f"{json.dumps(vs_f64)} {tag}")
    t_kernel = timed_median(kernel_fn, xs, calls=calls)
    t_xla = timed_median(xla_fn, xs, calls=calls)
    print(f"transit log-likelihood at {lanes} lanes, median of {calls} "
          f"calls: kernel {t_kernel:.6f} s, XLA {t_xla:.6f} s "
          f"({t_xla / t_kernel:.3f}x) {tag}")
    check(vs_xla["ok"], f"kernel disagrees with XLA: {vs_xla}")
    check(vs_f64["ok"], f"kernel disagrees with the f64 reference: {vs_f64}")
    return {"kernel_seconds": t_kernel, "xla_seconds": t_xla}


def phase_pt(directory, pk_type, ensembles, tag, draws=LOGLIK_DRAWS,
             num_samples=PT_SAMPLES, adapt_at=PT_ADAPT_AT):
    import jax

    from bcm3_tpu.sampler import SamplerPT

    prior, lik, _ = build_poppk(directory, pk_type)
    D = prior.num_variables
    # GPU f32 (the sampler's batched path) against CPU f64
    xs = prior_draws(prior, draws, seed=5)
    gpu = np.asarray(jax.jit(lik.log_prob_batched)(xs))
    rtol, atol, flip, med = LOGLIK_TOL[pk_type]
    vs_f64 = compare(gpu, loglik_cpu_f64(lik, xs), rtol, atol, flip, med)
    print(f"{pk_type}: log-likelihood of {draws} prior draws, GPU f32 vs "
          f"CPU f64, rtol={rtol} atol={atol} softfail share<={flip} "
          f"median<={med}: "
          f"{json.dumps(vs_f64)} {tag}")

    cfg = poppk_config(ensembles, num_samples, adapt_at)
    t0 = time.time()
    cold = SamplerPT(prior, lik, cfg)
    cold.run()
    cold_seconds = time.time() - t0
    del cold
    # a fresh sampler: its programs come from the compile cache, so this
    # run's time is the sampling, the adaptation boundary and the emission
    s = SamplerPT(prior, lik, cfg)
    res = s.run()
    chains = s.num_chains
    print(f"{pk_type}: D={D}, {LADDER} chains x {ensembles} ensembles = "
          f"{chains} chains, {num_samples} samples x thin {THIN}, "
          f"{res['adaptation_boundaries']} adaptation boundary: "
          f"{res['evals_per_second']:.1f} evals/s "
          f"({res['evaluations']} evaluations in "
          f"{res['elapsed_seconds']:.3f} s; cold run with compilation "
          f"{cold_seconds:.3f} s) {tag}")
    # memory of the segment program, lowered from a fresh state (its
    # compilation comes from the cache)
    state = s._init_state()
    seg_fn = list(s._segment_fns.values())[-1]
    mem = seg_fn.lower(state, tuple(s.proposals)).compile().memory_analysis()
    print(f"{pk_type}: segment program memory_analysis: {mem} {tag}")
    print(f"{pk_type}: history ring {s.history_size} rows x {chains} chains "
          f"x D={D}: {state.history.nbytes} bytes {tag}")
    del state
    rates = acceptance_rates(res, LADDER)
    print(f"{pk_type}: temperatures {np.round(s.ladder, 6).tolist()}, "
          f"mutate {np.round(rates['mutate_rate'], 5).tolist()}, "
          f"exchange {np.round(rates['exchange_rate'], 5).tolist()} {tag}")
    check(res["samples"].shape == (num_samples * ensembles, 1, D),
          f"samples shape {res['samples'].shape}")
    check(np.isfinite(res["samples"]).all(), "non-finite samples")
    check(res["adaptation_boundaries"] == 1, "no adaptation boundary ran")
    # the T=0 chain draws from the prior and is accepted by construction
    m, e = rates["mutate_rate"][1:], rates["exchange_rate"]
    check(np.all((m > 0) & (m < 1)), f"mutate rates not inside (0, 1): {m}")
    check(np.all((e > 0) & (e < 1)), f"exchange rates not inside (0, 1): {e}")
    check(vs_f64["ok"], f"GPU f32 disagrees with CPU f64: {vs_f64}")
    return {"evals_per_second": res["evals_per_second"]}


def banana_quadrature():
    from bcm3_tpu.example_files import BANANA_PRIOR_BOX, BANANA_SD

    (lo1, hi1), (lo2, hi2) = BANANA_PRIOR_BOX
    x1 = np.linspace(lo1, hi1, 1500)
    x2 = np.linspace(lo2, hi2, 3000)
    X1, X2 = np.meshgrid(x1, x2, indexing="ij")
    logp = (-0.5 * (X1 / BANANA_SD[0]) ** 2
            - 0.5 * ((X2 - (4 * X1 + (1 - X1) ** 2)) / BANANA_SD[1]) ** 2)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    m = np.array([(p * X1).sum(), (p * X2).sum()])
    sd = np.sqrt([(p * (X1 - m[0]) ** 2).sum(), (p * (X2 - m[1]) ** 2).sum()])
    return m, sd


def banana_run(directory, ensembles, num_samples, adapt_at, dtype, seed=7):
    """The banana example through the user's entry points: PT with GMM
    adaptation at the C++ anchor's configuration (6 chains, thin 5, one
    adaptation, history 5000)."""
    from bcm3_tpu.example_files import write_banana_example
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    prior_xml, lik_xml = write_banana_example(os.path.join(directory, "banana"))
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)
    cfg = PTConfig(
        num_samples=num_samples,
        use_every_nth=THIN,
        num_chains=BANANA_LADDER,
        num_ensembles=ensembles,
        proposal_type="gaussian_mixture",
        adapt_proposal_samples=adapt_at,
        adapt_proposal_times=1,
        max_history_size=BANANA_HISTORY,
        swapping_scheme="deterministic_even_odd",
        seed=seed,
        dtype=dtype,
        emit_fixed_only=True,
    )
    return SamplerPT(prior, lik, cfg).run()


def banana_moments(res, ensembles, num_samples, adapt_at):
    """T=1 mean and sd of the samples emitted after the adaptation
    boundary, pooled over the ensembles."""
    x = res["samples"].reshape(num_samples, ensembles, 2)[adapt_at:]
    flat = x.reshape(-1, 2).astype(np.float64)
    return {"mean": flat.mean(0), "sd": flat.std(0)}


def run_level_z(got, ref, ref_sd, seeds):
    """z of one run's statistic against the mean over ``seeds`` reference
    runs of the same shape whose between-seed sd is ``ref_sd``: if both
    come from one distribution they differ by ref_sd * sqrt(1 + 1/seeds).
    A statistic that does not vary between seeds (sd 0) must match."""
    diff = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    se = np.asarray(ref_sd, np.float64) * np.sqrt(1.0 + 1.0 / seeds)
    return np.divide(diff, se, out=np.where(diff == 0, 0.0, np.inf),
                     where=se > 0)


def phase_banana(directory, tag, ensembles=BANANA_ENSEMBLES,
                 num_samples=BANANA_SAMPLES, adapt_at=BANANA_ADAPT_AT):
    """The GPU's f32 run against the C++ engine (tools/baseline_banana.cpp
    in its pooled mode, baseline_cpu.json banana_engine_cpp): T=1 means and
    sds after the adaptation boundary and per-temperature mutate and
    exchange rates, each within N_SIGMA run-level standard errors. A C++
    run has this run's shape, its ladders run as ensembles that share one
    GMM fit per temperature, so the spread of its statistics over seeds is
    the run-level error: it holds the randomness of the shared fit, which
    neither a within-run ESS nor a binomial error sees. Quadrature is
    printed beside them and not checked, because this algorithm misses it
    in the C++ engine as well (banana_engine_cpp, and with the scales
    frozen at the boundary banana_engine_cpp_frozen_scales)."""
    import jax.numpy as jnp

    base_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline_cpu.json")
    with open(base_file) as f:
        base = json.load(f)
    cpp = base["banana_engine_cpp"]
    check(cpp["ladders"] == ensembles and cpp["num_samples"] == num_samples,
          f"banana_engine_cpp is for {cpp['ladders']} ladders x "
          f"{cpp['num_samples']} samples")
    res = banana_run(directory, ensembles, num_samples, adapt_at, jnp.float32)
    mom = banana_moments(res, ensembles, num_samples, adapt_at)
    rates = acceptance_rates(res, BANANA_LADDER)
    print(f"banana: {BANANA_LADDER} chains x {ensembles} ensembles, "
          f"{num_samples} samples x thin {THIN}, adapted after {adapt_at}: "
          f"{res['elapsed_seconds']:.3f} s {tag}")
    failures = []
    for key, got in (("mean", mom["mean"]), ("sd", mom["sd"]),
                     ("mutate_rate", rates["mutate_rate"]),
                     ("exchange_rate", rates["exchange_rate"])):
        ref_sd = cpp[f"{key}_between_seed_sd"]
        z = run_level_z(got, cpp[key], ref_sd, cpp["seeds"])
        print(f"banana {key}: GPU f32 {np.round(got, 5).tolist()} vs C++ "
              f"engine over {cpp['seeds']} seeds {np.round(cpp[key], 5).tolist()}"
              f" (between-seed sd {np.round(ref_sd, 5).tolist()}), z "
              f"{np.round(z, 3).tolist()}, limit {N_SIGMA} {tag}")
        if np.any(np.abs(z) > N_SIGMA):
            failures.append(f"{key}: z={z}")

    # quadrature, in units of the run-level error: this run, and the mean
    # over seeds of the C++ engine with adapting and with frozen scales
    quad = dict(zip(("mean", "sd"), banana_quadrature()))
    frozen = base["banana_engine_cpp_frozen_scales"]
    for key, q in quad.items():
        sd = np.asarray(cpp[f"{key}_between_seed_sd"])
        sd_f = np.asarray(frozen[f"{key}_between_seed_sd"])
        z_run = (mom[key] - q) / sd
        z_cpp = (np.asarray(cpp[key]) - q) / (sd / np.sqrt(cpp["seeds"]))
        z_frozen = (np.asarray(frozen[key]) - q) / (sd_f / np.sqrt(frozen["seeds"]))
        print(f"banana T=1 {key} vs quadrature {np.round(q, 5).tolist()}: z "
              f"this run {np.round(z_run, 3).tolist()}, C++ engine "
              f"{np.round(z_cpp, 3).tolist()}, C++ engine with frozen scales "
              f"{np.round(z_frozen, 3).tolist()} (reported, not checked) {tag}")
    check(not failures, "; ".join(failures))


def phase_cli(directory, tag):
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        print(f"cli: not run, h5py does not import ({e}); output.nc is "
              f"written with h5py {tag}")
        return "not run (h5py missing)"
    from bcm3_tpu import cli
    from bcm3_tpu.io.output import load_results

    _, _, (prior_xml, lik_xml) = build_poppk(directory, "one")
    out = os.path.join(directory, "cli_out")
    cfg = os.path.join(directory, "config.txt")
    num_samples, chains = 20, 4
    with open(cfg, "w") as f:
        f.write(
            f"[sampler]\nnum_samples={num_samples}\nuse_every_nth=2\n"
            "rngseed=3\n\n[ptmhsampler]\n"
            f"num_chains={chains}\nadapt_proposal_samples=10\n"
            f"adapt_proposal_times=1\n\n[output]\nfolder={out}\n"
        )
    t0 = time.time()
    rc = cli.main(["-c", cfg, "--prior", prior_xml, "--likelihood", lik_xml])
    res = load_results(os.path.join(out, "output.nc"))
    D = len(res["variables"])
    print(f"cli: rc={rc}, output.nc samples {res['samples'].shape}, "
          f"{time.time() - t0:.3f} s {tag}")
    check(rc == 0, f"cli.main returned {rc}")
    check(res["samples"].shape == (num_samples, chains, D),
          f"output.nc samples shape {res['samples'].shape}")
    check(np.isfinite(res["samples"]).all(), "non-finite samples in output.nc")


def phase_four(directory, tag, ensembles=ENSEMBLES_ONE):
    """The headline sharded over 4 GPUs against the same seed and config on
    one GPU of the same machine."""
    import jax

    from bcm3_tpu.parallel.mesh import chain_mesh, chain_sharding
    from bcm3_tpu.sampler import SamplerPT

    check(len(jax.devices()) == 4, f"--four needs 4 GPUs, found {jax.devices()}")
    prior, lik, _ = build_poppk(directory, "one")
    n = ensembles * LADDER
    xs = prior_draws(prior, n, seed=13)
    f = jax.jit(lik.log_prob_batched)
    one = np.asarray(f(jax.device_put(xs, jax.devices()[0])))
    four = np.asarray(f(jax.device_put(xs, chain_sharding(chain_mesh(4)))))
    ll = compare(four, one, 1e-6, 0.0, 0.0)
    print(f"four: per-chain log-likelihood of {n} draws, 4 GPUs vs 1, "
          f"rtol=1e-6: {json.dumps(ll)} {tag}")

    out = {}
    for name, shard in (("1 GPU", False), ("4 GPUs", True)):
        cfg = poppk_config(ensembles, shard_over_devices=shard)
        SamplerPT(prior, lik, cfg).run()  # compiles
        s = SamplerPT(prior, lik, cfg)
        out[name] = s.run()
        print(f"four: {name}: {out[name]['evals_per_second']:.1f} evals/s "
              f"({out[name]['evaluations']} evaluations in "
              f"{out[name]['elapsed_seconds']:.3f} s) {tag}")
    # first segment: the samples emitted before the adaptation boundary,
    # (samples x ensembles, 1, D) pooled sample-major
    a = out["1 GPU"]["samples"][: PT_ADAPT_AT * ensembles]
    b = out["4 GPUs"]["samples"][: PT_ADAPT_AT * ensembles]
    a = a.reshape(PT_ADAPT_AT, ensembles, -1)
    b = b.reshape(PT_ADAPT_AT, ensembles, -1)
    close = np.isclose(a, b, rtol=1e-5, atol=1e-6).all(axis=(0, 2))
    share = 1.0 - close.mean()
    print(f"four: first segment, T=1 chains whose samples diverge (a flipped "
          f"MH decision): {int((~close).sum())} of {ensembles} "
          f"({share:.6f}), limit 0.01 {tag}")
    check(ll["ok"], f"sharded log-likelihoods differ: {ll}")
    check(share < 0.01, f"{share:.4%} of chains diverge")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded headline against 1 GPU")
    args = ap.parse_args(argv)
    try:
        from bcm3_tpu.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke.py must run from a bcm3_tpu checkout: {e}",
              file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = card_label()
    print(f"card: {card}")
    tag = f"[{card}]"
    dev = devices[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(devices)} {tag}")

    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [
            ("transit_kernel", phase_transit_kernel),
            ("pt_one", lambda d, t: phase_pt(d, "one", ENSEMBLES_ONE, t,
                                             num_samples=ONE_SAMPLES,
                                             adapt_at=ONE_ADAPT_AT)),
            ("pt_one_transit",
             lambda d, t: phase_pt(d, "one_transit", ENSEMBLES_TRANSIT, t)),
            ("banana", phase_banana),
            ("cli", phase_cli),
        ]
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as directory:
        for name, fn in phases:
            t0 = time.time()
            try:
                out = fn(directory, tag)
                # a phase that could not run says so instead of passing
                status = out if isinstance(out, str) else "passed"
            except Exception:
                traceback.print_exc()
                failed.append(name)
                status = "FAILED"
            gc.collect()
            print(f"phase {name}: {status} in {time.time() - t0:.3f} s, peak "
                  f"device memory {peak_bytes(dev)} bytes {tag}", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
