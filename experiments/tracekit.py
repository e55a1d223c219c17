"""Device-trace profiling: which kernels take the device time.

`profile_reps` wraps a warm run in jax.profiler; `rank_kernels` reads the
newest ``*.xplane.pb`` under the trace directory with
``jax.profiler.ProfileData`` and prints the top device kernels by total
time, the device busy time per run and the idle share of the traced
window. Run as a script it traces the stereo+RDS 32ch x 12blk bank step
(the bench's serving cell), or with ``--stage frontend`` the XLA frontend
alone on the same input:

    python experiments/tracekit.py [--stage bank|frontend] [--mode 0]

On a GPU the device planes are ``/device:GPU:N``; their per-stream lines
carry one event per kernel launch. A plane that also carries derived
"XLA Ops" lines is ranked by those instead, so nothing is counted twice.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys


def profile_reps(trace_dir: str, run) -> None:
    """Profile `run()` (which should execute the warm reps and block)."""
    import jax

    shutil.rmtree(trace_dir, ignore_errors=True)
    jax.profiler.start_trace(trace_dir)
    run()
    jax.profiler.stop_trace()


def _device_events(path: str):
    """[(line name, event name, start_ns, dur_ns)] of every device plane,
    taking the "XLA Ops" lines where a plane has them, else every line."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        if "/device:" not in plane.name:
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name.startswith("XLA Ops")]
        for ln in ops or [ln for ln in lines
                          if not ln.name.startswith(("XLA Modules",
                                                     "Steps"))]:
            for ev in ln.events:
                out.append((ln.name, ev.name, ev.start_ns, ev.duration_ns))
    return out


def _busy_ns(events) -> float:
    """Length of the union of the event intervals."""
    busy, end = 0.0, None
    for _, _, s, d in sorted(events, key=lambda e: e[2]):
        if end is None or s > end:
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    return busy


def rank_kernels(trace_dir: str, reps: int, top: int = 20,
                 header: str = "") -> float:
    """Parse the newest trace under trace_dir; print the top kernels.

    Returns device busy ms per run."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    events = _device_events(max(paths, key=os.path.getmtime))
    if not events:
        raise RuntimeError("the trace holds no device events")
    lines: dict[str, int] = {}
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for ln, name, _, dur in events:
        lines[ln] = lines.get(ln, 0) + 1
        totals[name] = totals.get(name, 0.0) + dur
        counts[name] = counts.get(name, 0) + 1
    busy = _busy_ns(events)
    t0 = min(e[2] for e in events)
    t1 = max(e[2] + e[3] for e in events)
    print(f"# {header}{reps} reps; device lines "
          + ", ".join(f"{k} ({v} events)" for k, v in sorted(lines.items())))
    print(f"# device busy {busy/1e6/reps:.3f} ms/run; idle share of the "
          f"traced device window {1 - busy / max(t1 - t0, 1):.3f}")
    grand = sum(totals.values())
    for name, tot in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{tot/1e3/reps:9.1f} us/run {100*tot/grand:5.1f}%"
              f"  x{counts[name]//reps:<4d} {name[:100]}")
    return busy / 1e6 / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("bank", "frontend"), default="bank")
    ap.add_argument("--mode", type=int, default=0)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace-dir", default=None,
                    help="default chiprun_out/trace_<stage>")
    args = ap.parse_args(argv)
    trace_dir = args.trace_dir or f"chiprun_out/trace_{args.stage}"

    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import benchkit, compile_cache, synth

    compile_cache.enable()
    rx = Receiver(args.mode, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    n_ch, n_blk = args.channels, args.blocks
    n_len = n_blk * 2 * cfg.block_size_iq
    iq, _ = synth.station_iq(cfg, n_blk)
    cell = benchkit.shifted_channel_segments(iq, n_ch, n_len)
    if args.stage == "bank":
        st = rx.init_state(batch=(n_ch,))
        step = benchkit.digest_step(rx)
    else:
        st = rx.frontend.init_state(batch=(n_ch,))
        fe = jax.jit(jax.vmap(rx.frontend.__call__))

        def step(s, x):
            d, s = fe(x, s)
            return s, d
    jax.block_until_ready(step(st, cell))  # compile + warm

    def run():
        s, dig = st, None
        for _ in range(args.reps):
            s, dig = step(s, cell)
        jax.block_until_ready((s, dig))

    profile_reps(trace_dir, run)
    rank_kernels(trace_dir, args.reps, args.top,
                 header=f"{jax.devices()[0].device_kind} {args.stage} mode "
                        f"{args.mode} {n_ch}x{n_blk}: ")


if __name__ == "__main__":
    main()
