"""NUTS vs PT sampling quality on the PopPK likelihood (VERDICT r2 item 8).

The gradient path through the expm dosing-interval solve is this
framework's unique capability — the reference sampler is derivative-free
(random-walk/GMM proposals, src/sampler/Proposal*). This tool runs both
backends on the same synthetic trial and reports ESS/sec over the
emitted fixed-temperature chains (the reference's quality metric,
R/stats.r:86-98), so the NUTS-vs-PT tradeoff is on record.

Usage: python tools/bench_nuts_poppk.py [--patients 8] [--chains 64]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_enable_x64", True)
from bcm3_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np


def build(patients, timepoints):
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet

    d = tempfile.mkdtemp(prefix="nuts_bench_")
    trial, truth = synthesize_trial(
        num_patients=patients, num_timepoints=timepoints, seed=17
    )
    pkdata = os.path.join(d, "pkdata.nc")
    trial.save(pkdata, "TRIAL1", "lapatinib")
    prior_xml = os.path.join(d, "prior.xml")
    lik_xml = os.path.join(d, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, patients, "one")
    write_poppk_likelihood_xml(lik_xml, pkdata, "TRIAL1", "lapatinib", "one")
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)
    return prior, lik, varset


def ess_per_sec(x, elapsed, max_chains=64):
    """x: (S, C, D) post-burn-in draws."""
    from bcm3_tpu.analysis import effective_sample_size_batched

    S, C, D = x.shape
    Csub = min(C, max_chains)
    ess = effective_sample_size_batched(
        np.ascontiguousarray(
            x[:, :Csub, :].reshape(S, Csub * D), dtype=np.float64
        )
    ).reshape(Csub, D)
    per_chain = ess.mean(axis=0)  # per variable
    return {
        "ess_per_chain_mean": float(per_chain.mean()),
        "ess_per_chain_min_var": float(per_chain.min()),
        "ess_per_sec": float(per_chain.mean()) * C / elapsed,
        "ess_min_var_per_sec": float(per_chain.min()) * C / elapsed,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--patients", type=int, default=8)
    ap.add_argument("--timepoints", type=int, default=12)
    ap.add_argument("--nuts-chains", type=int, default=64)
    ap.add_argument("--nuts-samples", type=int, default=400)
    ap.add_argument("--nuts-warmup", type=int, default=400)
    ap.add_argument("--pt-ensembles", type=int, default=64)
    ap.add_argument("--pt-samples", type=int, default=1000)
    args = ap.parse_args()

    prior, lik, varset = build(args.patients, args.timepoints)
    D = varset.num_variables

    from bcm3_tpu.sampler import NUTSConfig, PTConfig, SamplerNUTS, SamplerPT

    # --- NUTS
    nuts = SamplerNUTS(
        prior, lik,
        NUTSConfig(
            num_samples=args.nuts_samples,
            num_warmup=args.nuts_warmup,
            num_chains=args.nuts_chains,
            max_tree_depth=7,
            seed=5,
        ),
    )
    t0 = time.time()
    nres = nuts.run()
    n_el = time.time() - t0
    nx = nres["samples_per_chain"]  # (S, C, D)
    n_stats = ess_per_sec(np.asarray(nx), n_el)
    n_out = {
        "sampler": "nuts",
        "elapsed_s": round(n_el, 1),
        "divergences": int(nres["divergences"]),
        "mean_tree_depth": round(float(nres["mean_tree_depth"]), 2),
        "chains": args.nuts_chains,
        **{k: round(v, 3) for k, v in n_stats.items()},
    }
    print(json.dumps(n_out), flush=True)

    # --- PT at the same target
    pt = SamplerPT(
        prior, lik,
        PTConfig(
            num_samples=args.pt_samples,
            use_every_nth=2,
            num_chains=4,
            num_ensembles=args.pt_ensembles,
            adapt_proposal_samples=args.pt_samples // 4,
            adapt_proposal_times=2,
            max_history_size=2000,
            swapping_scheme="deterministic_even_odd",
            seed=31,
        ),
    )
    t0 = time.time()
    pres = pt.run()
    p_el = time.time() - t0
    E = args.pt_ensembles
    S = pres["samples"].shape[0] // E
    px = pres["samples"].reshape(S, E, -1, D)[S // 2:, :, -1, :]
    p_stats = ess_per_sec(np.asarray(px), p_el)
    p_out = {
        "sampler": "pt",
        "elapsed_s": round(p_el, 1),
        "chains": E,
        **{k: round(v, 3) for k, v in p_stats.items()},
    }
    print(json.dumps(p_out), flush=True)

    print(json.dumps({
        "patients": args.patients,
        "D": D,
        "nuts": n_out,
        "pt": p_out,
        "nuts_over_pt_ess_per_sec": round(
            n_stats["ess_per_sec"] / max(p_stats["ess_per_sec"], 1e-12), 2
        ),
    }))


if __name__ == "__main__":
    main()
