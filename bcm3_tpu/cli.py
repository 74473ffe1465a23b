"""bcminf-equivalent command-line tool.

Re-implementation of the reference inference CLI
(reference: src/bcminf/main.cpp). `run` loads prior.xml/likelihood.xml +
config.txt, runs the PT sampler and writes output.nc (+ log.txt,
sampler_adaptation.nc); `--predict` re-evaluates the likelihood over a
previous run's stored samples and writes prediction.nc
(reference: src/bcminf/main.cpp:142-278).

Usage:
    python -m bcm3_tpu.cli -c config.txt
    python -m bcm3_tpu.cli -c config.txt --predict
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np

from bcm3_tpu import __version__


def _setup_logging(output_path: str):
    os.makedirs(output_path, exist_ok=True)
    handlers = [
        logging.StreamHandler(),
        logging.FileHandler(os.path.join(output_path, "log.txt"), mode="w"),
    ]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )


def run(opts) -> int:
    import h5py
    import jax

    from bcm3_tpu.io.bundler import write_adaptation_dump
    from bcm3_tpu.io.output import SampleHandlerHDF5
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler.factory import create_sampler

    output_path = opts["output.folder"]
    _setup_logging(output_path)
    log = logging.getLogger("bcminf")
    log.info("bcm3_tpu inference tool - version %s", __version__)
    log.info("JAX devices: %s", jax.devices())

    varset = VariableSet.from_xml(opts["prior"])
    prior = Prior.from_xml(opts["prior"], varset)
    likelihood = create_likelihood(opts["likelihood"], varset)
    likelihood.learning_rate = float(opts.get("learning_rate", "1.0"))

    sampler = create_sampler(prior, likelihood, opts)
    if hasattr(sampler, "progress"):
        from bcm3_tpu.io.progress import ProgressIndicatorConsole

        sampler.progress = ProgressIndicatorConsole(
            update_time=float(opts.get("progress_update_time", "0.5"))
        )

    handler = SampleHandlerHDF5(
        os.path.join(output_path, "output.nc"),
        sampler.expected_emitted_samples,
        varset.names,
        varset.transforms,
        getattr(sampler, "emit_ladder", sampler.ladder),
    )
    sampler.sample_handlers.append(handler)

    t0 = time.time()
    sampler.run()
    handler.close()
    log.info("Total run time: %.2fs", time.time() - t0)

    if getattr(sampler, "adaptation_dumps", None):
        fn = os.path.join(output_path, "sampler_adaptation.nc")
        if os.path.exists(fn):
            os.remove(fn)
        for iteration, record, history in sampler.adaptation_dumps:
            write_adaptation_dump(fn, iteration, record, history)
        log.info("Wrote %s", fn)
    if getattr(sampler, "clustering_dumps", None):
        # per-adaptation spectral-clustering diagnostics, group iterN
        # (reference: SampleHistoryClustering.cpp:40-56 writes
        # sample_history_clustering.nc for R-side inspection)
        from bcm3_tpu.io.bundler import HDF5Bundler

        fn = os.path.join(output_path, "sample_history_clustering.nc")
        if os.path.exists(fn):
            os.remove(fn)
        with HDF5Bundler(fn) as bundle:
            for iteration, dump in sampler.clustering_dumps:
                grp = f"iter{iteration}"
                for name in (
                    "clustering_input_samples",
                    "K",
                    "Y",
                ):
                    bundle.add_matrix(grp, name, dump[name])
                bundle.add_vector(
                    grp,
                    "clustering_input_sample_scaling",
                    dump["clustering_input_sample_scaling"],
                )
                bundle.add_vector(grp, "assignment", dump["assignment"])
                bundle.add_vector(
                    grp, "all_assignment", dump["all_assignment"]
                )
        log.info("Wrote %s", fn)
    return 0


def predict(opts) -> int:
    """Re-evaluate the likelihood over stored samples
    (reference: src/bcminf/main.cpp:142-278): for each temperature, every
    (skip_n+1)-th sample in the second half of the chain."""
    import h5py
    import jax
    import jax.numpy as jnp

    from bcm3_tpu.io.output import NC_FILL_DOUBLE, load_results
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet

    output_path = opts["output.folder"]
    _setup_logging(output_path)
    log = logging.getLogger("bcminf")

    varset = VariableSet.from_xml(opts["prior"])
    likelihood = create_likelihood(opts["likelihood"], varset)
    likelihood.learning_rate = float(opts.get("learning_rate", "1.0"))

    res = load_results(os.path.join(output_path, opts["predict.input"]))
    samples = res["samples"]  # (S, C, D)
    S, C, D = samples.shape
    skip_n = int(opts.get("predict.skip_n", "0"))
    use_ix = np.arange(S // 2, S, skip_n + 1)

    spec_t = opts.get("predict.specific_temperature", "")
    temp_ix = range(C) if spec_t in ("", None) else [int(spec_t)]

    log_prob = jax.jit(jax.vmap(likelihood.log_prob))
    pred = np.full((S, C), NC_FILL_DOUBLE)
    t0 = time.time()
    n_eval = 0
    for ti in temp_ix:
        xs = jnp.asarray(samples[use_ix, ti, :])
        vals = np.asarray(log_prob(xs))
        pred[use_ix, ti] = vals * likelihood.learning_rate
        n_eval += len(use_ix)
    elapsed = time.time() - t0
    log.info(
        "Prediction: %d evaluations in %.3fs (%.1f evals/s)",
        n_eval,
        elapsed,
        n_eval / max(elapsed, 1e-9),
    )

    out_fn = os.path.join(output_path, opts["predict.output"])
    with h5py.File(out_fn, "w") as f:
        g = f.create_group("predictions")
        g.create_dataset("log_likelihood", data=pred, fillvalue=NC_FILL_DOUBLE)
        g.create_dataset("temperature", data=res["temperatures"])
    log.info("Wrote %s", out_fn)
    return 0


def bcmopt(opts) -> int:
    """MAP re-estimation over stored samples
    (reference: src/bcmopt/main.cpp:15-240): for each temperature and
    every subsampled stored sample, fix the non-sampled parameters (the
    stored variables not in the current prior), run a short sampler with
    a MAP sink and record MAP_estimates.tsv +
    MAP_estimates_paramvalues.tsv."""
    import numpy as np

    from bcm3_tpu.io.output import SampleHandlerMAP, load_results
    from bcm3_tpu.likelihoods import Likelihood, create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler.factory import create_sampler

    output_path = opts["output.folder"]
    _setup_logging(output_path)
    log = logging.getLogger("bcmopt")

    varset = VariableSet.from_xml(opts["prior"])
    prior = Prior.from_xml(opts["prior"], varset)

    res = load_results(os.path.join(output_path, opts["bcmopt.input"]))
    stored_names = res["variables"]
    stored_transforms = res["variable_transform"]
    samples = res["samples"]  # (S, C, Dfull)
    temps = res["temperatures"]
    S = samples.shape[0]

    # non-sampled parameters = stored variables not in the current prior
    # (reference: src/bcmopt/main.cpp:134-149)
    non_sampled_ix = [
        i for i, name in enumerate(stored_names) if name not in varset.names
    ]
    non_sampled_names = [stored_names[i] for i in non_sampled_ix]
    sampled_pos = [stored_names.index(n) for n in varset.names]

    # likelihood over the FULL stored variable layout; sampled entries are
    # substituted at evaluation time
    full_varset = VariableSet()
    for i, name in enumerate(stored_names):
        full_varset.names.append(name)
        full_varset.transforms.append(int(stored_transforms[i]))
    full_lik = create_likelihood(opts["likelihood"], full_varset)

    num_input = int(opts.get("bcmopt.num_samples", "10"))
    start_ix = S // 2
    use_ix = [
        start_ix
        + i * (S - start_ix) // num_input
        + ((S - start_ix) // num_input - 1)
        for i in range(num_input)
    ]

    import jax.numpy as jnp

    fn1 = os.path.join(output_path, "MAP_estimates.tsv")
    fn2 = os.path.join(output_path, "MAP_estimates_paramvalues.tsv")
    f1 = open(fn1, "w")
    f1.write("temperature" + "".join(f"\t{i}" for i in range(num_input)) + "\n")
    f2 = open(fn2, "w")
    f2.write(
        "temperature_sample\tlog posterior\tlog likelihood"
        + "".join(f"\tfixed_{n}" for n in non_sampled_names)
        + "".join(f"\toptimized_{n}" for n in varset.names)
        + "\n"
    )

    for ti in range(len(temps)):
        log.info("Temperature %d (%g)...", ti, temps[ti])
        f1.write(f"{temps[ti]:g}")
        for si in use_ix:
            fixed_full = jnp.asarray(samples[si, ti, :])
            pos = jnp.asarray(sampled_pos)

            def log_prob(values, _fixed=fixed_full, _pos=pos):
                full = _fixed.at[_pos].set(values)
                return full_lik.log_prob(full)

            sub_lik = Likelihood("bcmopt", log_prob)
            sampler = create_sampler(prior, sub_lik, opts)
            handler = SampleHandlerMAP()
            sampler.sample_handlers.append(handler)
            sampler.run()
            f1.write(f"\t{handler.map_lposterior:g}")
            f2.write(
                f"{temps[ti]:g}_{si}\t{handler.map_lposterior:g}"
                f"\t{handler.map_llikelihood:g}"
            )
            for i in non_sampled_ix:
                f2.write(f"\t{samples[si, ti, i]:g}")
            if handler.map_sample is not None:
                for v in handler.map_sample:
                    f2.write(f"\t{v:g}")
            f2.write("\n")
        f1.write("\n")
    f1.close()
    f2.close()
    log.info("Wrote %s and %s", fn1, fn2)
    return 0


def main(argv=None) -> int:
    from bcm3_tpu.compile_cache import enable_compile_cache
    from bcm3_tpu.io.config import build_arg_parser, options_from_args

    enable_compile_cache()
    args = build_arg_parser().parse_args(argv)
    opts = options_from_args(args)
    if args.predict:
        return predict(opts)
    if getattr(args, "bcmopt", False):
        return bcmopt(opts)
    return run(opts)


if __name__ == "__main__":
    sys.exit(main())
