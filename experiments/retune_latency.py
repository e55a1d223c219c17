"""Measure the runtime-retune path: operand-weights
serving cost vs jit constants, and the end-to-end latency of re-pointing
one station (host column rebuild + device re-upload + next dispatch).

The reference's only retune is restarting ``rtl_sdr -f`` and the whole
binary (model/fmMonoBasic.py:30-42) — seconds and all state lost. Here
the serving graph never recompiles and every other station's DSP state
carries through.

Usage: python experiments/retune_latency.py [--stations 64] [--seg 8]
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
    ap.add_argument("--seg", type=int, default=8)
    ap.add_argument("--reps", type=int, default=32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from real_time_sdr_tpu.utils import compile_cache
    compile_cache.enable()
    import numpy as np

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.models.wideband_frontend import (
        FusedWidebandFrontend)
    from real_time_sdr_tpu.parallel.channel import ChannelBank

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    n_st = args.stations
    offs = [int((k - (n_st - 1) / 2) * 300_000) for k in range(n_st)]
    span = max(abs(o) for o in offs) + 150_000
    mult = 8
    while mult * cfg.rf_fs // 2 < span:
        mult += 2
    wide_fs = mult * cfg.rf_fs
    wf = FusedWidebandFrontend(cfg, wide_fs, offs,
                               taps_factor=max(2, mult // 4))
    bank = ChannelBank(rx, n_st)
    n = args.seg * cfg.block_size_iq * wf.decim
    rng = np.random.default_rng(0)
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1)

    def measure(weights, label):
        bs, ws = bank.init_state(), wf.init_state()
        t0 = time.perf_counter()
        bs, out, ws = bank.run_wideband_jit(bs, wf, iw, qw, ws,
                                            weights=weights)
        np.asarray(out.rds_nbits)[:4]
        print(f"# {label}: compile+first {time.perf_counter()-t0:.1f} s",
              file=sys.stderr)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            bs, out, ws = bank.run_wideband_jit(bs, wf, iw, qw, ws,
                                                weights=weights)
        np.asarray(out.rds_nbits)[:4]
        per = (time.perf_counter() - t0) / args.reps
        agg = (args.stations * args.seg * cfg.block_size_iq
               / cfg.rf_fs / per)
        print(f"# {label}: {per*1e3:.2f} ms/run ({agg:.0f}x aggregate "
              f"station realtime, {n / wide_fs / per:.1f}x wideband)",
              file=sys.stderr)
        return bs, ws, per

    measure(None, f"{n_st} st, jit-constant weights")
    wts = wf.device_weights()
    bs, ws, per = measure(wts, f"{n_st} st, operand weights")

    # retune: host column rebuild + re-upload + next dispatch
    lat = []
    for r in range(8):
        si = (7 * r + 3) % n_st
        t0 = time.perf_counter()
        wf.retune(si, offs[si])       # same raster point: worst-case-equal
        wts = wf.device_weights()
        bs, out, ws = bank.run_wideband_jit(bs, wf, iw, qw, ws,
                                            weights=wts)
        np.asarray(out.rds_nbits)[:4]     # visible effect on host
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    print(f"# retune->decoded latency over steady serving: "
          f"p50 {np.percentile(lat, 50):.0f} ms  min {lat.min():.0f}  "
          f"max {lat.max():.0f} ms (vs {per*1e3:.2f} ms steady run; "
          f"the delta is the host rebuild + weight re-upload)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
