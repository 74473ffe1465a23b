"""HBM headroom probe for the ensemble axis (VERDICT r1 item 9).

Round 1 reported OOM at 32,768 ensembles with no analysis. This probe
builds the bench.py expm-model sampler at growing ensemble counts,
accounts the resident state analytically, reads device memory stats
when the runtime exposes them, and runs one short segment — printing
either the throughput or the OOM error per size.

Usage: python tools/hbm_probe.py [sizes...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from bcm3_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

import bench


def fmt_bytes(n):
    return f"{n/2**20:.1f} MiB"


def state_budget(s):
    """Analytic accounting of the sampler's resident device state."""
    C, D = s.num_chains, s.num_variables
    esz = np.dtype(s.dtype).itemsize
    rows = {
        "x (C,D)": C * D * esz,
        "lprior/llh/counters (6C)": 6 * C * esz,
        "history (C,H,D) f32": C * s.history_size * D * 4,
    }
    # proposal state: stacked per chain (means/chols/scales per component)
    psz = 0
    for p in s.proposals:
        for leaf in jax.tree_util.tree_leaves(p):
            if hasattr(leaf, "nbytes"):
                psz += leaf.nbytes
    rows["proposals"] = psz
    # emission staging: one chunk of (chunk, C, D+2) at emit dtype, x2 for
    # the pipelined pending chunk
    edt = np.dtype(s.config.emit_dtype or s.dtype).itemsize
    bytes_per_emit = C * (D + 2) * edt
    chunk = max(1, (32 << 20) // bytes_per_emit)
    rows["emission staging (2 chunks)"] = 2 * chunk * bytes_per_emit
    # donation: one transient copy of x + scalars during the segment swap
    rows["donation transient (~x)"] = C * D * esz
    return rows


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [8192, 16384, 32768, 65536]
    for ne in sizes:
        s = bench.build_sampler(10, 0, 2024, "one", ne)
        rows = state_budget(s)
        total = sum(rows.values())
        print(f"\n=== ensembles={ne} (chains={s.num_chains}) ===", flush=True)
        for k, v in rows.items():
            print(f"  {k:34s} {fmt_bytes(v)}")
        print(f"  {'TOTAL (analytic)':34s} {fmt_bytes(total)}")
        try:
            t0 = time.time()
            res = s.run()
            dt = time.time() - t0
            print(
                f"  run ok: {res['evaluations']/dt:.0f} evals/s "
                f"({dt:.1f}s incl. per-run init)",
                flush=True,
            )
        except Exception as e:
            print(f"  run FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
        dev = jax.devices()[0]
        stats = getattr(dev, "memory_stats", lambda: None)()
        if stats:
            peak = stats.get("peak_bytes_in_use")
            lim = stats.get("bytes_limit")
            if peak:
                print(f"  device peak bytes in use: {fmt_bytes(peak)}"
                      + (f" / limit {fmt_bytes(lim)}" if lim else ""))
        del s


if __name__ == "__main__":
    main()
