"""Decompose the measured per-block-channel cost by receiver subsystem.

Times the 32ch x 12blk digest step for a ladder of receiver configs
(mono ... full stereo+RDS) on the device JAX runs on, so the gap between
the measured step and the modeled memory-bound floor
(utils/logging.speed_of_light_report, at the device's published peaks)
can be attributed to a stage instead of guessed at. Companion to
experiments/barrier_ab.py.

Usage: python experiments/stage_decompose.py [--channels 32 --blocks 12]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", type=int, default=0)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--min-measure", type=float, default=1.5)
    args = ap.parse_args()

    import jax

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import benchkit, compile_cache, synth
    from real_time_sdr_tpu.utils.logging import device_peaks, stage_costs

    compile_cache.enable()
    HBM_GBPS = device_peaks()["hbm_bps"] / 1e9

    configs = [
        ("mono", dict(stereo=False, rds=False)),
        ("stereo", dict(stereo=True, rds=False)),
        # DSP half only: emit_bits=False makes XLA dead-code-eliminate the
        # per-block slicer scan, isolating its cost from the RDS DSP chain
        ("stereo+rds-nobits", dict(stereo=True, rds=True)),
        ("stereo+rds", dict(stereo=True, rds=True)),
    ]
    n_ch, n_blk = args.channels, args.blocks
    results = {}
    prev = 0.0
    for name, kw in configs:
        rx = Receiver(args.mode, pll_tier=3, **kw)
        if name.endswith("-nobits"):
            rx.rds_path.emit_bits = False
        cfg = rx.cfg
        n_len = n_blk * 2 * cfg.block_size_iq
        iq, _ = synth.station_iq(cfg, n_blk)
        seg = benchkit.shifted_channel_segments(iq, n_ch, n_len)
        st = rx.init_state(batch=(n_ch,))
        step = benchkit.digest_step(rx)
        t0 = time.perf_counter()
        jax.block_until_ready(step(st, seg))
        compile_s = time.perf_counter() - t0
        reps, per_run = 1, None
        while True:
            t0 = time.perf_counter()
            s = st
            for _ in range(reps):
                s, dig = step(s, seg)
            jax.block_until_ready((s, dig))
            dt = time.perf_counter() - t0
            per_run = dt / reps
            if dt >= args.min_measure or reps >= 4096:
                break
            reps = min(4096, max(reps * 2, int(
                reps * 1.3 * args.min_measure / max(dt, 1e-3))))
        us_blk_ch = per_run / (n_ch * n_blk) * 1e6
        # amortize weight streams over the dispatch (see
        # utils/logging.speed_of_light_report): XLA einsum weights divide
        # by ch*blk
        floor_us = sum(
            c["bytes"] - c.get("w_bytes", 0)
            + c.get("w_bytes", 0) / (n_ch * n_blk)
            for _, c in stage_costs(rx, channels=n_ch)) / HBM_GBPS / 1e3
        results[name] = {
            "per_run_ms": round(per_run * 1e3, 3),
            "us_per_blk_ch": round(us_blk_ch, 3),
            "delta_us_vs_prev": round(us_blk_ch - prev, 3),
            "floor_us": round(floor_us, 3),
            "pct_of_floor": round(100 * floor_us / us_blk_ch, 1),
            "compile_s": round(compile_s, 1),
            "device": jax.devices()[0].device_kind,
        }
        prev = us_blk_ch
        print(f"{name:12s} {json.dumps(results[name])}", file=sys.stderr,
              flush=True)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
