"""End-to-end A/B of the fused transit kernel against XLA's lowering.

Runs the PopPK "one_transit" PT configuration of chip_smoke.py phase 4
(8 chains x 4096 ensembles, 524,288 solver lanes, one adaptation
boundary) with the likelihood's batched path (the kernel) and with plain
vmap(log_prob) (XLA), in turns kernel, XLA, XLA, kernel after one cold
run of each, and first repeats chip_smoke's kernel phase (kernel vs XLA at
the log-likelihood level). Needs one GPU:

    python tools/transit_kernel_ab.py
"""

import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    import jax

    import chip_smoke as cs
    from bcm3_tpu.compile_cache import enable_compile_cache
    from bcm3_tpu.sampler import SamplerPT

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()}")
    enable_compile_cache()
    tag = f"[{cs.card_label()}]"
    with tempfile.TemporaryDirectory() as d:
        cs.phase_transit_kernel(d, tag)
        prior, lik, _ = cs.build_poppk(d, "one_transit")
        variants = {
            "kernel": lik,
            "xla": dataclasses.replace(lik, log_prob_batched=None),
        }
        cfg = cs.poppk_config(cs.ENSEMBLES_TRANSIT)
        for name, v in variants.items():
            res = SamplerPT(prior, v, cfg).run()
            print(f"cold {name}: {res['elapsed_seconds']:.3f} s {tag}",
                  flush=True)
        for name in ("kernel", "xla", "xla", "kernel"):
            res = SamplerPT(prior, variants[name], cfg).run()
            print(f"{name}: {res['evals_per_second']:.1f} evals/s "
                  f"({res['evaluations']} evaluations in "
                  f"{res['elapsed_seconds']:.3f} s) {tag}", flush=True)


if __name__ == "__main__":
    main()
