"""Benchmark: aggregate real-time multiple on the full FM stereo+RDS chain.

Runs a channel bank of mode-0 receivers (2.4 MS/s IQ each) through the fused
segment-mode graph and reports how many times faster than real time the
aggregate decode runs. The reference's implicit contract is 1.0x on a host
CPU (SURVEY.md section 6); the printed ``vs_baseline`` is the same multiple.

Prints exactly ONE JSON line:
  {"metric": "aggregate_realtime_x", "value": N, "unit": ..., "vs_baseline": N,
   "platform": ..., "device_kind": ...}

Design:

- a LADDER of configs, smallest first, so a valid number exists early;
  later rungs scale up to 128ch x 48blk and replace the result if they
  finish within the wall-clock budget (--budget / BENCH_BUDGET_S);
- SIGTERM/SIGINT handlers + atexit print the best completed measurement
  (exactly once) if a time limit kills the run;
- timing chains state through R dependent executions and waits with
  ``block_until_ready`` on the last one. Each run reduces every output to
  one on-device digest (a jnp.sum), which keeps XLA from dropping outputs
  as dead code without moving audio to the host;
- a measurement needs the GPU: without one (and without --cpu) the run
  exits non-zero and prints no number.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

_result: dict | None = None
_printed = False


def _emit(*_args) -> None:
    """Print the best result exactly once (normal exit or signal)."""
    global _printed
    if _result is not None and not _printed:
        _printed = True
        print(json.dumps(_result), flush=True)
    if _args:
        # signal path: NEVER swallow SIGTERM/SIGINT (a handler that
        # returns would keep the process alive past the time limit)
        os._exit(0 if _result is not None else 143)


def _better(new: dict | None, old: dict | None) -> dict | None:
    if old is None:
        return new
    if new is None:
        return old
    return new if new["value"] >= old["value"] else old


def require_platform(cpu: bool) -> tuple[str, str]:
    """(platform, device_kind) of the first JAX device. Exits non-zero
    unless it is a GPU, or the CPU that --cpu asked for: a measurement
    never falls back to another device."""
    import jax
    d = jax.devices()[0]
    want = "cpu" if cpu else "gpu"
    if d.platform != want:
        print(f"# bench needs a {want} device, found {d.platform} "
              f"({d.device_kind}); pass --cpu to measure the CPU",
              file=sys.stderr)
        raise SystemExit(2)
    return d.platform, d.device_kind


def main(argv=None) -> None:
    global _result
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=None,
                    help="fix the channel count (disables the ladder)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="fix the block count (disables the ladder)")
    ap.add_argument("--mode", type=int, default=0)
    ap.add_argument("--pll-tier", type=int, default=3,
                    help="1 exact scan, 2 Newton, 3 feedforward (fastest)")
    ap.add_argument("--no-rds", action="store_true")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("BENCH_BUDGET_S", "460")),
                    help="total wall-clock budget in seconds")
    ap.add_argument("--min-measure", type=float, default=1.5,
                    help="minimum measured span per rung (seconds)")
    ap.add_argument("--cpu", action="store_true",
                    help="measure the CPU backend (otherwise a GPU is "
                         "required)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage speed-of-light accounting to stderr")
    ap.add_argument("--group", type=int, default=32,
                    help="serve wide channel batches as sequential groups of "
                         "this width (0 = one wide batch)")
    ap.add_argument("--tile", type=int, default=12,
                    help="serve long rungs as host-chained segment calls of "
                         "this many blocks (dispatches pipeline "
                         "asynchronously; 0 = one wide in-graph pass)")
    ap.add_argument("--wideband", type=int, default=8, metavar="N",
                    help="also measure the wideband serving path: N "
                         "stations out of ONE 4x-rate wideband capture, "
                         "decoded as a bank (models/wideband_frontend.py); "
                         "prints a stderr line (0 disables; runs only if "
                         "budget remains after the ladder)")
    ap.add_argument("--latency", action="store_true",
                    help="also measure BLOCK-mode per-step latency vs the "
                         "real-time deadline (the reference's contract is "
                         "one block per block-duration, src/Makefile:4-5)")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    remaining = lambda: args.budget - (time.perf_counter() - t_start)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from real_time_sdr_tpu.utils import compile_cache
    compile_cache.enable()
    platform, device_kind = require_platform(args.cpu)

    signal.signal(signal.SIGTERM, _emit)
    signal.signal(signal.SIGINT, _emit)
    import atexit
    atexit.register(_emit)

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import benchkit, synth

    rx = Receiver(args.mode, stereo=True, rds=not args.no_rds,
                  pll_tier=args.pll_tier)
    cfg = rx.cfg
    unit = (f"x_realtime_{cfg.rf_fs/1e6:g}MSps_fm_stereo"
            + ("" if args.no_rds else "_rds"))

    if args.channels is not None or args.blocks is not None:
        rungs = [(args.channels or 128, args.blocks or 48)]
    else:
        # smallest first: rung 0 exists to guarantee a number. (128, 12)
        # and (128, 48) reuse the 32x12 graph through host cells, so the
        # larger rungs pay no additional compile.
        rungs = [(16, 12), (32, 12), (128, 12), (128, 48)]

    # One synth segment covering the largest rung; channels get distinct
    # time shifts of it.
    max_blocks = max(b for _, b in rungs)
    iq, _ = synth.station_iq(cfg, max_blocks)

    # ONE jitted graph serves every rung cell: wide channel banks split
    # into --group-wide sub-banks and long captures into --tile-block
    # chunks ON THE HOST, with each (group, chunk) cell a separate async
    # dispatch of this same executable.
    digest_v = benchkit.digest_step(rx)

    last_rung_cost = 0.0
    g = n_chunks = n_blk = None
    for n_ch, n_blk in rungs:
        # Heuristic gate: a fresh rung needs compile (~ last rung's cost or
        # more) plus measurement time; stop rather than time out mid-compile.
        need = max(90.0, 1.4 * last_rung_cost)
        if _result is not None and remaining() < need:
            print(f"# skipping rung {n_ch}x{n_blk}: {remaining():.0f}s left "
                  f"< {need:.0f}s needed", file=sys.stderr)
            break
        t_rung = time.perf_counter()
        try:
            n_len = n_blk * 2 * cfg.block_size_iq
            if args.tile and n_blk > args.tile and n_blk % args.tile == 0:
                n_chunks = n_blk // args.tile
            else:
                n_chunks = 1
            g = args.group
            if not g or n_ch <= g or n_ch % g:
                g = n_ch
            n_g = n_ch // g
            chunk_len = n_len // n_chunks
            per_ch_dev = benchkit.shifted_channel_segments(iq, n_ch, n_len)
            # cells[gi][k]: (g, chunk_len) uint8 for sub-bank gi, chunk k
            cells = [[jax.device_put(
                per_ch_dev[gi * g:(gi + 1) * g,
                           k * chunk_len:(k + 1) * chunk_len])
                for k in range(n_chunks)] for gi in range(n_g)]
            states = [rx.init_state(batch=(g,)) for _ in range(n_g)]
            # compile + warm up
            _, dig = digest_v(states[0], cells[0][0])
            jax.block_until_ready(dig)
            t_compile = time.perf_counter() - t_rung

            # measure: chain each sub-bank's state through its chunks,
            # reps times; waiting on the last digest syncs the pipeline
            reps = 1
            per_run = None
            while remaining() > 5.0:
                t0 = time.perf_counter()
                ss = list(states)
                for _ in range(reps):
                    for k in range(n_chunks):
                        for gi in range(n_g):
                            ss[gi], dig = digest_v(ss[gi], cells[gi][k])
                jax.block_until_ready((ss, dig))
                dt = time.perf_counter() - t0
                per_run = dt / reps
                if dt >= args.min_measure or reps >= 4096:
                    break
                reps = min(4096, max(reps * 2, int(
                    reps * 1.3 * args.min_measure / max(dt, 1e-3))))
            if per_run is None:
                break
            iq_samples = n_ch * n_blk * cfg.block_size_iq
            ms_per_s = iq_samples / per_run / 1e6
            realtime_x = ms_per_s / (cfg.rf_fs / 1e6)
            _result = _better({
                "metric": "aggregate_realtime_x",
                "value": round(realtime_x, 2),
                "unit": unit,
                "vs_baseline": round(realtime_x, 2),
                "platform": platform,
                "device_kind": device_kind,
            }, _result)
            last_rung_cost = time.perf_counter() - t_rung
            print(f"# rung {n_ch}ch x {n_blk}blk: {realtime_x:.0f}x realtime "
                  f"({ms_per_s:.1f} MS/s, {per_run*1e3:.1f} ms/run x {reps} "
                  f"reps, setup+compile {t_compile:.0f}s) on "
                  f"{device_kind}", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 - keep earlier rung's number
            print(f"# rung {n_ch}x{n_blk} failed: {e!r}", file=sys.stderr)
            break

    if args.wideband and _result is not None and remaining() > 60:
        # Wideband serving path: one wideband stream in, N stations out.
        try:
            from real_time_sdr_tpu.models.wideband_frontend import (
                FusedWidebandFrontend, make_wideband_frontend)
            wide_fs = 4 * cfg.rf_fs
            n_st = args.wideband
            span = wide_fs // 2 - cfg.rf_fs // 2
            # snap to the 100 kHz FM channel raster (real tuners do):
            # keeps the periodic-exact tones AND the static-tone fold
            offs = [int(round((-span + (2 * span) * k / max(n_st - 1, 1))
                              / 100e3) * 100e3) for k in range(n_st)]
            ch = make_wideband_frontend(cfg, wide_fs, offs)
            wb_fused = isinstance(ch, FusedWidebandFrontend)
            from real_time_sdr_tpu.parallel.channel import ChannelBank
            bank = ChannelBank(rx, n_st)
            # segment serving: one device call channelizes + decodes
            # wb_seg blocks
            wb_seg = 24 if wb_fused else 12
            n_wb = 2  # wideband segments cycled through the chain
            block_pairs = cfg.block_size_iq * ch.decim
            rng = np.random.default_rng(0)
            # SEPARATE device arrays per cycled segment: indexing one
            # (n_wb, N) array per rep dispatches an extra full-segment
            # slice copy each call
            iw = [jnp.asarray(rng.standard_normal(
                (wb_seg * block_pairs,)).astype(np.float32) * 0.1)
                for _ in range(n_wb)]
            qw = [jnp.asarray(rng.standard_normal(
                (wb_seg * block_pairs,)).astype(np.float32) * 0.1)
                for _ in range(n_wb)]

            def wb_step(cstate, bstate, i, q):
                if wb_fused:
                    bstate, out, cstate = bank.run_channelized_fused(
                        bstate, ch, i, q, cstate)
                else:
                    bstate, out, cstate = bank.run_channelized(
                        bstate, ch, i, q, cstate)
                sums = [jnp.sum(o if o.dtype != jnp.int32
                                else o.astype(jnp.float32))
                        for o in jax.tree_util.tree_leaves(out)]
                return cstate, bstate, sum(sums)

            wb_jit = jax.jit(wb_step)
            cs, bs = ch.init_state(), rx.init_state(batch=(n_st,))
            _, _, dig = wb_jit(cs, bs, iw[0], qw[0])
            jax.block_until_ready(dig)
            # adaptive reps: grow until the span is >= 1 s. per_block is
            # set INSIDE the loop (before reps updates) so a budget-bounded
            # exit still reports span/reps consistently
            reps, per_block = 16, None
            while remaining() > 10.0:
                t0 = time.perf_counter()
                c, b = cs, bs
                for r in range(reps):
                    c, b, dig = wb_jit(c, b, iw[r % n_wb], qw[r % n_wb])
                jax.block_until_ready((c, b, dig))
                span = time.perf_counter() - t0
                per_block = span / reps / wb_seg
                if span >= 1.0 or reps >= 4096:
                    break
                reps = min(4096, max(reps * 2,
                                     int(reps * 1.3 / max(span, 1e-3))))
            if per_block is None:
                raise RuntimeError("no budget left for the wideband rung")
            wb_ms = block_pairs / per_block / 1e6
            rt = wb_ms / (wide_fs / 1e6)
            print(f"# wideband channelize+decode ({n_st} stations from one "
                  f"{wide_fs/1e6:g} MS/s capture, {wb_seg}-block segments, "
                  f"{'fused' if wb_fused else 'u8'} frontend): "
                  f"{per_block*1e3:.2f} ms/block, {wb_ms:.0f} MS/s wideband "
                  f"= {rt:.0f}x realtime on {device_kind}", file=sys.stderr)
        except Exception as e:  # noqa: BLE001
            print(f"# wideband measurement failed: {e!r}", file=sys.stderr)

    if args.latency and _result is not None and remaining() > 60:
        # Real-time serving latency: single-block steps (the streaming-mode
        # graph), chained through carried state. Per-block latency must stay
        # under the block deadline (block_size_iq / rf_fs, 30.625 ms at
        # mode 0) for live `rtl_sdr | ... | aplay` operation.
        try:
            n_lat = min(c for c, _ in rungs)
            blk = 2 * cfg.block_size_iq
            blocks = jnp.asarray(np.stack(
                [np.roll(iq[:blk], 2 * 997 * c) for c in range(n_lat)]))
            step_v = jax.jit(jax.vmap(rx.step))
            st = rx.init_state(batch=(n_lat,))
            jax.block_until_ready(step_v(st, blocks))
            reps = 64
            t0 = time.perf_counter()
            s = st
            for _ in range(reps):
                s, out = step_v(s, blocks)
            jax.block_until_ready((s, out))
            per_block = (time.perf_counter() - t0) / reps
            deadline = cfg.block_size_iq / cfg.rf_fs
            # NB: this is the SUSTAINED step time under pipelined dispatch
            # (what determines whether a live stream keeps up with the
            # deadline), not the one-block wall latency.
            print(f"# block-mode sustained step ({n_lat} ch): "
                  f"{per_block*1e3:.2f} ms/block vs {deadline*1e3:.2f} ms "
                  f"real-time deadline ({deadline/per_block:.0f}x headroom, "
                  f"pipelined)", file=sys.stderr)
        except Exception as e:  # noqa: BLE001
            print(f"# latency measurement failed: {e!r}", file=sys.stderr)

    if args.stats and _result is not None:
        from real_time_sdr_tpu.utils.logging import speed_of_light_report
        # amortize over the DISPATCH CELL (host-cell group x tile), not
        # the rung totals: wide/long rungs serve as chained g x tile
        # cells, so weights stream once per cell, not once per rung
        cell_ch, cell_blk = g, n_blk // n_chunks
        speed_of_light_report(rx, file=sys.stderr,
                              channels=cell_ch, blocks=cell_blk,
                              device_kind=device_kind)
        # per-mode ceilings from the same cost() plumbing (static math, no
        # compiles) — so a low non-flagship x-realtime number can be judged
        # against ITS OWN floor (experiments/mode_floors.py measures them)
        print(f"# per-mode speed-of-light ceilings (stereo"
              f"{'' if args.no_rds else '+RDS'}, tier {args.pll_tier}):",
              file=sys.stderr)
        with open(os.devnull, "w") as devnull:
            for m in (0, 1, 2, 3):
                rxm = rx if m == args.mode else Receiver(
                    m, stereo=True, rds=not args.no_rds,
                    pll_tier=args.pll_tier)
                sol = speed_of_light_report(rxm, file=devnull,
                                            channels=cell_ch,
                                            blocks=cell_blk,
                                            device_kind=device_kind)
                print(f"#   mode {m}: floor {sol['floor_s']*1e6:6.2f} "
                      f"us/block -> ceiling {sol['ceiling_x']:,.0f}x "
                      f"realtime/channel", file=sys.stderr)

    _emit()


if __name__ == "__main__":
    main()
