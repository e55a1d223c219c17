"""A/B: which fusion barriers actually pay for themselves on the device?

The receiver can put ``optimization_barrier`` calls at FIR-stage inputs
and around the PLL because XLA's fusion search over chained
frame-construction patterns (pad/reshape/slice/concat) can explode
compile time and runtime on the full RDS chain. Every site but
"chanfold" ships barrier-free (ops/fir.py _DEFAULT_OFF). This experiment
re-measures each site via the ``RTSDR_NO_BARRIER`` hook, force-pinning all
non-dropped sites so "baseline" always means ALL barriers regardless of
the shipping default.

Each config runs in a SUBPROCESS under a hard timeout (a fusion explosion
must not take the session down) and reports compile seconds, per-run
milliseconds, aggregate realtime-x at 32ch x 12blk, and an output digest
checked against the baseline config for numerical equivalence.

Usage:  python experiments/barrier_ab.py            # parent sweep
        python experiments/barrier_ab.py --child    # one measurement
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CONFIGS = [
    ("baseline", ""),
    ("no-pll", "pll"),
    ("no-polyfir", "polyfir"),
    ("no-shared", "shared"),
    ("no-frontend", "frontend,dualphase"),
    # pairwise combos: check that single-site effects compose
    ("no-fe-poly", "frontend,dualphase,polyfir"),
    ("no-fe-poly-pll", "frontend,dualphase,polyfir,pll"),
    ("no-fir-all", "polyfir,shared"),
    ("ship-noshared", "frontend,dualphase,shared"),
    ("ship-all-off", "frontend,dualphase,polyfir,shared,pll"),
    ("no-all", "all"),
]


def child(args) -> None:
    # script lives in experiments/, so the repo root isn't auto-added
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax
    import jax.numpy as jnp
    import numpy as np

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import compile_cache, synth

    compile_cache.enable()

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    n_ch, n_blk = args.channels, args.blocks
    from real_time_sdr_tpu.utils import benchkit

    n_len = n_blk * 2 * cfg.block_size_iq
    iq, _ = synth.station_iq(cfg, n_blk)
    segs = benchkit.shifted_channel_segments(iq, n_ch, n_len)
    digest_v = benchkit.digest_step(rx)
    state = rx.init_state(batch=(n_ch,))

    t0 = time.perf_counter()
    s2, dig = digest_v(state, segs)
    d0 = float(np.asarray(dig).ravel()[0])
    t_compile = time.perf_counter() - t0

    # measure: chain state through reps dependent runs, one sync at the end
    reps, per_run = 1, None
    while True:
        t0 = time.perf_counter()
        s = state
        for _ in range(reps):
            s, dig = digest_v(s, segs)
        jax.block_until_ready((s, dig))
        dt = time.perf_counter() - t0
        per_run = dt / reps
        if dt >= 2.0 or reps >= 4096:
            break
        reps = min(4096, max(reps * 2, int(reps * 1.3 * 2.0 / max(dt, 1e-3))))

    ms = n_ch * n_blk * cfg.block_size_iq / per_run / 1e6
    print(json.dumps({
        "compile_s": round(t_compile, 1),
        "per_run_ms": round(per_run * 1e3, 3),
        "realtime_x": round(ms / (cfg.rf_fs / 1e6), 1),
        "digest": d0,
        "device": jax.devices()[0].device_kind,
    }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--timeout", type=float, default=480.0,
                    help="per-config hard timeout (fusion explosions)")
    ap.add_argument("--only", default=None,
                    help="comma-separated config names to run")
    args = ap.parse_args()
    if args.child:
        child(args)
        return

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.append(repo)  # the parent also imports the tag universe
    want = set(args.only.split(",")) if args.only else None
    results = {}
    for name, no_barrier in CONFIGS:
        if want and name not in want:
            continue
        # The production default now drops the frontend-site barriers
        # (ops/fir.py _DEFAULT_OFF); force every barrier a config does
        # not explicitly drop, so "baseline" still means ALL barriers.
        dropped = {t.strip() for t in no_barrier.split(",") if t.strip()}
        from real_time_sdr_tpu.ops.fir import ALL_BARRIER_TAGS
        forced = ("" if "all" in dropped else ",".join(
            sorted(ALL_BARRIER_TAGS - dropped)))
        env = dict(os.environ, RTSDR_NO_BARRIER=no_barrier,
                   RTSDR_BARRIER=forced)
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               "--channels", str(args.channels), "--blocks",
               str(args.blocks)]
        t0 = time.perf_counter()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=args.timeout, env=env, cwd=repo)
            line = [ln for ln in out.stdout.splitlines()
                    if ln.startswith("{")]
            r = json.loads(line[-1]) if line else {
                "error": (out.stderr or "no output")[-400:]}
        except subprocess.TimeoutExpired:
            r = {"error": f"TIMEOUT >{args.timeout:.0f}s (fusion explosion?)"}
        r["wall_s"] = round(time.perf_counter() - t0, 1)
        results[name] = r
        print(f"{name:12s} {json.dumps(r)}", file=sys.stderr, flush=True)

    base = results.get("baseline", {}).get("digest")
    if base is not None:
        for name, r in results.items():
            if "digest" in r and abs(r["digest"] - base) > 1e-3 * abs(base):
                print(f"# WARNING {name}: digest {r['digest']} != baseline "
                      f"{base}", file=sys.stderr)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
