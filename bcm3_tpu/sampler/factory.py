"""Sampler factory: ``sampler.type`` string -> sampler instance.

JAX equivalent of the reference factory
(reference: src/sampler/SamplerFactory.cpp:22-43).
"""

from __future__ import annotations

from typing import Dict

from bcm3_tpu.sampler.importance import ISConfig, SamplerIS
from bcm3_tpu.sampler.pt import SamplerPT


def create_sampler(prior, likelihood, opts: Dict[str, str]):
    """Build a sampler from a merged option map (see io.config.load_options)."""
    from bcm3_tpu.io.config import load_options, pt_config_from_options

    opts = load_options(None, opts)  # fill in defaults for missing keys
    stype = opts.get("sampler.type", "ptmh")
    if stype in ("ptmh", "parallel_tempered_Metropolis_Hastings"):
        return SamplerPT(prior, likelihood, pt_config_from_options(opts))
    if stype in ("is", "importance_sampling"):
        cfg = ISConfig(
            num_samples=int(opts.get("sampler.num_samples", "2500")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            seed=int(opts.get("sampler.rngseed", "0")),
            batch_size=int(opts.get("issampler.batch_size", "1024")),
        )
        return SamplerIS(prior, likelihood, cfg)
    if stype == "hmc":
        from bcm3_tpu.sampler.hmc import HMCConfig, SamplerHMC

        cfg = HMCConfig(
            num_samples=int(opts.get("sampler.num_samples", "1000")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            num_warmup=int(opts.get("hmcsampler.num_warmup", "500")),
            num_chains=int(opts.get("hmcsampler.num_chains", "8")),
            num_leapfrog_steps=int(
                opts.get("hmcsampler.num_leapfrog_steps", "16")
            ),
            target_accept=float(opts.get("hmcsampler.target_accept", "0.8")),
            seed=int(opts.get("sampler.rngseed", "0")),
        )
        return SamplerHMC(prior, likelihood, cfg)
    if stype == "nuts":
        from bcm3_tpu.sampler.nuts import NUTSConfig, SamplerNUTS

        cfg = NUTSConfig(
            num_samples=int(opts.get("sampler.num_samples", "1000")),
            use_every_nth=int(opts.get("sampler.use_every_nth", "1")),
            num_warmup=int(opts.get("nutssampler.num_warmup", "500")),
            num_chains=int(opts.get("nutssampler.num_chains", "8")),
            max_tree_depth=int(opts.get("nutssampler.max_tree_depth", "8")),
            target_accept=float(opts.get("nutssampler.target_accept", "0.8")),
            seed=int(opts.get("sampler.rngseed", "0")),
        )
        return SamplerNUTS(prior, likelihood, cfg)
    if stype == "smc":
        from bcm3_tpu.sampler.smc import SamplerSMC, SMCConfig

        cfg = SMCConfig(
            num_particles=int(opts.get("smcsampler.num_particles", "2048")),
            mutation_steps=int(opts.get("smcsampler.mutation_steps", "5")),
            ess_target=float(opts.get("smcsampler.ess_target", "0.5")),
            seed=int(opts.get("sampler.rngseed", "0")),
        )
        return SamplerSMC(prior, likelihood, cfg)
    if stype == "vi":
        from bcm3_tpu.sampler.vi import SamplerVI, VIConfig

        cfg = VIConfig(
            num_iterations=int(opts.get("visampler.num_iterations", "2000")),
            num_mc_samples=int(opts.get("visampler.num_mc_samples", "32")),
            learning_rate=float(opts.get("visampler.learning_rate", "0.05")),
            num_samples=int(opts.get("sampler.num_samples", "1000")),
            seed=int(opts.get("sampler.rngseed", "0")),
        )
        return SamplerVI(prior, likelihood, cfg)
    raise ValueError(
        f"Unknown sampler.type '{stype}' (expected ptmh|is|hmc|nuts|smc|vi)"
    )
