"""Per-mode speed-of-light floors vs measured throughput.

For each reference CLI mode (0-3: the sample-rate tables at
src/project.cpp:67-108 of the reference) build the full stereo+RDS tier-3
receiver, compute its modeled per-block floor from the same cost()
plumbing speed_of_light_report uses (max of memory and matmul time per
stage, at the published peaks of the device JAX runs on), and measure the
32ch x 12blk digest step on that device. Prints a
mode | measured | floor | pct-of-floor matrix so an under-performing mode
is visible as a LOW PERCENTAGE rather than as a small absolute number
(modes 1/3 have less signal per block, so their x-realtime is lower even
at identical efficiency).

Usage: python experiments/mode_floors.py [--channels 32 --blocks 12]
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
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--min-measure", type=float, default=1.5)
    args = ap.parse_args()

    import jax

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import benchkit, compile_cache, synth
    from real_time_sdr_tpu.utils.logging import speed_of_light_report

    compile_cache.enable()

    n_ch, n_blk = args.channels, args.blocks
    results = {}
    for mode in (0, 1, 2, 3):
        rx = Receiver(mode, stereo=True, rds=True, pll_tier=3)
        cfg = rx.cfg
        budget = cfg.block_size_iq / cfg.rf_fs
        with open(os.devnull, "w") as devnull:
            sol = speed_of_light_report(rx, file=devnull,
                                        channels=n_ch, blocks=n_blk)
        n_len = n_blk * 2 * cfg.block_size_iq
        iq, _ = synth.station_iq(cfg, n_blk)
        st = rx.init_state(batch=(n_ch,))
        seg = benchkit.shifted_channel_segments(iq, n_ch, n_len)
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
        t_blk_ch = per_run / (n_ch * n_blk)
        results[f"mode{mode}"] = {
            "block_ms_of_signal": round(budget * 1e3, 3),
            "us_per_blk_ch": round(t_blk_ch * 1e6, 3),
            "floor_us": round(sol["floor_s"] * 1e6, 3),
            "pct_of_floor": round(100 * sol["floor_s"] / t_blk_ch, 1),
            "measured_x": round(budget / t_blk_ch, 1),
            "ceiling_x": round(sol["ceiling_x"], 1),
            "compile_s": round(compile_s, 1),
            "device": jax.devices()[0].device_kind,
        }
        print(f"mode{mode}  {json.dumps(results[f'mode{mode}'])}",
              file=sys.stderr, flush=True)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
