"""Top device kernels for the wideband channelize+decode graph.

Builds the same one-graph step as experiments/wideband64.py (periodic-
exact channelizer + N-station ChannelBank segment decode), profiles a
few reps, and ranks kernels — the hunt tool for the
mixing/fold traffic that bounds the 64-station north-star demo.

Usage: python experiments/trace_wideband.py [--stations 64] [--seg 12]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=64)
    ap.add_argument("--seg", type=int, default=12)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace-dir", default="chiprun_out/trace_wideband")
    ap.add_argument("--path", choices=("u8", "fused"), default="fused",
                    help="which wideband frontend to trace (the fused "
                         "one-matmul path is the serving default)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from real_time_sdr_tpu.utils import compile_cache
    compile_cache.enable()
    import numpy as np

    from real_time_sdr_tpu.models.channelizer import Channelizer
    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.parallel.channel import ChannelBank
    from experiments.tracekit import profile_reps, rank_kernels

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs = 8 * cfg.rf_fs
    n_st = args.stations
    offs = [int((k - (n_st - 1) / 2) * 300_000) for k in range(n_st)]
    if args.path == "fused":
        from real_time_sdr_tpu.models.wideband_frontend import (
            FusedWidebandFrontend)
        ch = FusedWidebandFrontend(cfg, wide_fs, offs)
    else:
        ch = Channelizer(cfg, wide_fs, offs)
    bank = ChannelBank(rx, n_st)

    block_pairs = cfg.block_size_iq * ch.decim
    n = args.seg * block_pairs
    rng = np.random.default_rng(0)
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1)

    def step(cstate, bstate, i, q):
        if args.path == "fused":
            bstate, out, cstate = bank.run_channelized_fused(
                bstate, ch, i, q, cstate, group=16)
        else:
            bstate, out, cstate = bank.run_channelized(bstate, ch, i, q,
                                                       cstate)
        sums = [jnp.sum(o if o.dtype != jnp.int32 else o.astype(jnp.float32))
                for o in jax.tree_util.tree_leaves(out)]
        return cstate, bstate, sum(sums)

    jstep = jax.jit(step)
    cs, bs = ch.init_state(), rx.init_state(batch=(n_st,))
    t0 = time.perf_counter()
    _, _, dig = jstep(cs, bs, iw, qw)
    float(np.asarray(dig))
    print(f"# compile+first: {time.perf_counter()-t0:.1f} s",
          file=sys.stderr)

    def run():
        c, b = cs, bs
        dig = None
        for _ in range(args.reps):
            c, b, dig = jstep(c, b, iw, qw)
        float(np.asarray(dig))

    run()  # warm
    profile_reps(args.trace_dir, run)
    rank_kernels(args.trace_dir, args.reps, args.top,
                 header=f"wideband {n_st}st seg{args.seg}: ")


if __name__ == "__main__":
    main()
