"""End-to-end latency through the native I/O path on real hardware.

Drives `python -m real_time_sdr_tpu.cli` as a SUBPROCESS through real
pipes — raw uint8 IQ paced at the live-capture rate into stdin, PCM
drained from stdout — and reports the CLI's own --stats p50/p99
ingest->PCM block latency. A second run throttles the sink (reads PCM
slower than real time) with --drop-oldest and asserts the overload path
actually sheds input blocks instead of backpressuring the source.

Usage: python experiments/e2e_latency.py [--blocks 40] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _spawn(extra, env):
    return subprocess.Popen(
        [sys.executable, "-m", "real_time_sdr_tpu.cli", "0", "r",
         "--warmup", "--stats", *extra],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, cwd=REPO)


def _feed(proc, iq_bytes, block_bytes, budget_s, n_blocks, paced=True):
    """Write blocks at the real-time cadence (a live SDR source)."""
    try:
        t0 = time.perf_counter()
        for b in range(n_blocks):
            if paced:
                target = t0 + b * budget_s
                dt = target - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
            off = (b * block_bytes) % (len(iq_bytes) - block_bytes)
            proc.stdin.write(iq_bytes[off:off + block_bytes])
            proc.stdin.flush()
        proc.stdin.close()
    except BrokenPipeError:
        pass


def _drain(proc, per_read_sleep=0.0, chunk=1 << 16):
    while True:
        buf = proc.stdout.read(chunk)
        if not buf:
            return
        if per_read_sleep:
            time.sleep(per_read_sleep)


def _read_stderr(proc, sink):
    """Drain stderr concurrently: --stats emits a line per dispatch, and a
    full 64 KB stderr pipe would block the child (and then the feeder)."""
    sink.append(proc.stderr.read().decode())


def _run_wideband(args, env) -> None:
    """Live-paced WIDEBAND serving: one 9.6 MS/s capture with real FM
    stations piped into `cli 0 r --stations ...` at the capture's real
    byte rate; asserts the CLI sustains >= real time
    AND decodes RDS PS live (the fused wideband frontend serving path)."""
    import tempfile

    import numpy as np

    from real_time_sdr_tpu.config import mode_config
    from real_time_sdr_tpu.utils import synth

    cfg = mode_config(0)
    n_st = max(2, args.wideband)
    wide_fs = 4 * cfg.rf_fs
    # load stations spread over the usable band (NOT a one-sided ladder:
    # 2.3 MHz + k*300 kHz crosses the 4.8 MHz Nyquist at k>=9 and the
    # aliased 'stations' would overlap instead of adding load)
    span = wide_fs // 2 - 300_000
    loads = [int(round((-span + 2 * span * k / max(n_st - 3, 1)) / 1e5)
                 * 100_000) for k in range(n_st - 2)]
    offs = [-1_700_000, 800_000]
    for o in loads:
        while o in offs:  # keep every load station DISTINCT (a duplicate
            o -= 100_000  # would under-load by one channel silently)
        offs.append(o)
    assert max(abs(o) for o in offs) + 150_000 <= wide_fs // 2, offs
    assert len(set(offs)) == len(offs), offs
    scene = [dict(offset_hz=offs[0], ps_name="LIVE-WB0", pi=0x7A7A, pty=1),
             dict(offset_hz=offs[1], ps_name="LIVE-WB1", pi=0x7B7B, pty=2)]
    # cover the whole run: cycling a short fixture wraps the RDS bit
    # stream mid-group and PS assembly never completes
    nb_gen = args.blocks + 6
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, nb_gen)
    x = np.empty(2 * iw.shape[0], np.float32)
    x[0::2], x[1::2] = iw, qw
    iq_bytes = np.clip(np.round(128.0 + 127.0 * x), 0,
                       255).astype(np.uint8).tobytes()
    decim = wide_fs // cfg.rf_fs
    block_bytes = 2 * cfg.block_size_iq * decim
    budget = cfg.block_size_iq / cfg.rf_fs

    with tempfile.TemporaryDirectory() as outdir:
        p = subprocess.Popen(
            [sys.executable, "-m", "real_time_sdr_tpu.cli", "0", "r",
             "--warmup", "--stats",
             "--stations=" + ",".join(str(o) for o in offs),
             "--wide-fs", str(wide_fs), "--output-dir", outdir,
             "--segment", str(args.segment),
             "--pipeline", str(args.pipeline),
             "--max-blocks", str(args.blocks),
             *(["--cpu"] if args.cpu else [])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, cwd=REPO)
        esink: list = []
        te = threading.Thread(target=_read_stderr, args=(p, esink),
                              daemon=True)
        te.start()
        _feed(p, iq_bytes, block_bytes, budget, args.blocks + 2)
        p.wait(timeout=900)
        te.join(timeout=30)
        err = esink[0] if esink else ""
    for line in err.splitlines():
        if line.startswith(("wideband frontend", "warmed", "total:")) \
                or " ps: " in line:
            print(line, flush=True)
    total = [ln for ln in err.splitlines() if ln.startswith("total:")]
    assert total, err[-2000:]
    rt = float(total[0].rsplit(",", 1)[-1].split("x")[0])
    assert rt >= 1.0, f"wideband live serving fell behind: {total[0]}"
    for ps in ("LIVE-WB0", "LIVE-WB1"):
        assert ps in err, f"PS {ps!r} not decoded live"
    print(f"wideband live OK: {n_st} stations sustained {rt:.1f}x "
          f"real time", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--pipeline", type=int, default=2)
    ap.add_argument("--segment", type=int, default=6)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--wideband", type=int, default=0, metavar="N",
                    help="run the live-paced WIDEBAND serving check with "
                         "N stations instead of the single-station runs")
    args = ap.parse_args()

    import numpy as np

    from real_time_sdr_tpu.config import mode_config
    from real_time_sdr_tpu.utils import synth

    cfg = mode_config(0)
    block_bytes = 2 * cfg.block_size_iq
    budget = cfg.block_size_iq / cfg.rf_fs
    iq, _ = synth.station_iq(cfg, 8, ps_name="LATENCY ")
    iq_bytes = np.asarray(iq, np.uint8).tobytes()

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    extra_cpu = ["--cpu"] if args.cpu else []

    if args.wideband:
        _run_wideband(args, env)
        return

    # --- run 1: real-time-paced source, fast sink -> p50/p99 latency ------
    p = _spawn(["--pipeline", str(args.pipeline),
                "--segment", str(args.segment),
                "--max-blocks", str(args.blocks), *extra_cpu], env)
    th = threading.Thread(target=_drain, args=(p,), daemon=True)
    th.start()
    esink: list = []
    te = threading.Thread(target=_read_stderr, args=(p, esink), daemon=True)
    te.start()
    _feed(p, iq_bytes, block_bytes, budget, args.blocks + 4)
    p.wait(timeout=600)
    te.join(timeout=30)
    th.join(timeout=10)
    err = esink[0] if esink else ""
    for line in err.splitlines():
        if line.startswith(("block latency", "total:", "warmed")):
            print(line, flush=True)
    assert "block latency" in err, err[-2000:]

    # --- run 2: slow sink + --drop-oldest -> overload sheds input ---------
    # sink sleeps ~3x real time per PCM block; with depth-4 drop-oldest the
    # reader must report dropped blocks rather than stall the paced source
    pcm_block = 2 * cfg.audio_block * 2
    p = _spawn(["--pipeline", "1", "--drop-oldest", "--io-depth", "2",
                "--max-blocks", str(args.blocks), *extra_cpu], env)
    th = threading.Thread(
        target=_drain, args=(p, 3.0 * budget, pcm_block), daemon=True)
    th.start()
    esink = []
    te = threading.Thread(target=_read_stderr, args=(p, esink), daemon=True)
    te.start()
    _feed(p, iq_bytes, block_bytes, budget, args.blocks + 4)
    p.wait(timeout=600)
    te.join(timeout=30)
    th.join(timeout=10)
    err = esink[0] if esink else ""
    dropped = [ln for ln in err.splitlines() if ln.startswith("dropped")]
    lat = [ln for ln in err.splitlines() if ln.startswith("block latency")]
    print((dropped + ["dropped: none reported"])[0], flush=True)
    if lat:
        print("overload " + lat[0], flush=True)
    assert dropped, "slow sink + --drop-oldest reported no drops:\n" + \
        err[-2000:]


if __name__ == "__main__":
    main()
