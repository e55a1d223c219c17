"""Command-line receiver: uint8 IQ on stdin -> int16 PCM on stdout,
RDS text on stderr.

Drop-in workflow twin of the reference binary (src/project.cpp:26-141):

    rtl_sdr -f 99.9M -s 2.4M - | python -m real_time_sdr_tpu.cli 0 s | aplay ...

Positional args <mode 0-3> <type m|s|r> exactly as the reference; EOF on
stdin ends the stream (the reference exit(1)s, src/rffrontend.cpp:50-52).
The host loop double-buffers: block k+1 is read from the pipe and shipped to
the device while block k computes (JAX dispatch is async), then k's PCM is
fetched and written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="real_time_sdr_tpu",
        description="FM mono/stereo receiver with RDS decoding (JAX)")
    # both positionals are optional: the reference defaults to mode-0 mono
    # when launched with fewer than two args (src/project.cpp:46-47)
    ap.add_argument("mode", type=int, choices=(0, 1, 2, 3), nargs="?",
                    default=0,
                    help="sample-rate mode (src/project.cpp:67-108); "
                         "default 0")
    ap.add_argument("type", choices=("m", "s", "r"), nargs="?", default="m",
                    help="m=mono, s=stereo, r=stereo+RDS; default m")
    ap.add_argument("--input", default="-", help="raw uint8 IQ file, -=stdin")
    ap.add_argument("--output", default="-", help="PCM out, - = stdout")
    ap.add_argument("--pll-tier", type=int, default=1, choices=(1, 2, 3),
                    help="1=exact sequential PLL, 2=block-parallel Newton, "
                         "3=feedforward sync (fastest; approximates the "
                         "locked loop, not the acquisition transient)")
    ap.add_argument("--rds-timing", choices=("comb", "tracked"),
                    default="comb",
                    help="RDS symbol clock: comb=per-block argmax CDR "
                         "(reference behaviour), tracked=drift-following "
                         "interpolating CDR (survives tuner ppm error)")
    ap.add_argument("--rds-correct", type=int, default=2,
                    metavar="SPAN", choices=range(0, 6),
                    help="max burst span (bits) the RDS framer repairs per "
                         "26-bit block (0=detect only like the reference; "
                         "code limit 5; default 2 keeps false corrections "
                         "on garbage rare)")
    ap.add_argument("--checkpoint", default=None,
                    help="state .npz to resume from / save on EOF")
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--stats", action="store_true",
                    help="per-block wall clock vs real-time budget on stderr")
    ap.add_argument("--warmup", action="store_true",
                    help="compile the receiver on a silent block BEFORE "
                         "consuming the pipe, so a live source (rtl_sdr) is "
                         "not backpressured through the first jit compile")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--io-depth", type=int, default=4,
                    help="ring-buffer depth for the native I/O threads")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="device calls kept in flight before the PCM fetch "
                         "syncs; each adds latency but hides dispatch and "
                         "fetch time (0 = fully synchronous)")
    ap.add_argument("--segment", type=int, default=1, metavar="G",
                    help="aggregate G input blocks per device call (segment "
                         "serving): amortizes the per-call dispatch, upload "
                         "and fetch overhead to 1/G and runs the wideband "
                         "DSP as one graph; adds G-1 blocks of latency. Use "
                         "it when a per-block call's fixed overhead does "
                         "not fit the block deadline")
    ap.add_argument("--drop-oldest", action="store_true",
                    help="real-time mode: drop stale input blocks instead of "
                         "backpressuring the source")
    ap.add_argument("--monitor", default=None, metavar="PATH",
                    help="write an atomic .npz diagnostic snapshot (latest "
                         "audio block, RDS matched-filter output, decode "
                         "stats) every --monitor-every blocks; view live "
                         "with `python -m real_time_sdr_tpu.viz <mode> "
                         "--live PATH` (the reference's fmMonoAnim "
                         "while-processing view, model/fmMonoAnim.py:42-66)")
    ap.add_argument("--monitor-every", type=int, default=4,
                    help="blocks between --monitor snapshots")
    ap.add_argument("--stations", default=None,
                    help="comma-separated station offsets in Hz: treat the "
                         "input as ONE wideband capture and channelize all "
                         "stations (requires --wide-fs, --output-dir)")
    ap.add_argument("--wide-fs", type=int, default=None,
                    help="wideband capture sample rate (integer multiple of "
                         "the mode's RF rate)")
    ap.add_argument("--output-dir", default=None,
                    help="per-station PCM output directory (wideband mode)")
    ap.add_argument("--retune", action="append", default=None,
                    metavar="SEG:STATION:HZ",
                    help="at dispatched segment index SEG (0-based), "
                         "re-point station STATION to offset HZ without "
                         "recompiling (fused wideband path only: weights "
                         "are served as device operands; other stations' "
                         "DSP state is untouched). Repeatable. The "
                         "reference's only retune is restarting rtl_sdr "
                         "-f (model/fmMonoBasic.py:30-42)")
    return ap


def _monitor_snapshot(path: str, cfg, stereo: bool, framer, block: int,
                      pcm_np, clean_np) -> None:
    """Atomic .npz snapshot of the running decode for `viz --live`."""
    import numpy as np
    audio = pcm_np[0::2] if stereo else pcm_np  # int16, one block
    ev = framer.events if framer is not None else None
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, block=block, fs=float(cfg.audio_fs),
                 audio=np.asarray(audio),
                 clean=(np.zeros(0, np.float32) if clean_np is None
                        else np.asarray(clean_np, np.float32)),
                 sps=int(cfg.sps),
                 ps=str((ev.ps_name if ev else None) or ""),
                 pi=int((ev.pi if ev else 0) or 0),
                 groups=int(ev.groups_decoded if ev else 0))
    os.replace(tmp, path)


def _atomic_json(path: str, obj) -> None:
    """Write-then-rename so a mid-dump kill never leaves a truncated file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def run_wideband(args, rx, cfg) -> int:
    """Multi-station mode: channelize a wideband capture and decode every
    station in parallel through a channel bank."""
    import jax
    import jax.numpy as jnp

    from real_time_sdr_tpu.models.wideband_frontend import (
        FusedWidebandFrontend, make_wideband_frontend)
    from real_time_sdr_tpu.models.rds_framing import RdsFramer
    from real_time_sdr_tpu.parallel.channel import ChannelBank
    from real_time_sdr_tpu.utils.audio import mono_pcm, stereo_pcm
    from real_time_sdr_tpu.utils import state as state_util

    if args.io_depth != 4 or args.drop_oldest or args.monitor:
        print("warning: --io-depth/--drop-oldest/--monitor apply to the "
              "single-station native I/O path and are ignored in "
              "--stations mode", file=sys.stderr)
    try:
        offsets = [int(x) for x in args.stations.split(",")]
    except ValueError:
        print(f"error: --stations must be comma-separated integer Hz "
              f"offsets, got {args.stations!r}", file=sys.stderr)
        return 2
    wide_fs = args.wide_fs or 4 * cfg.rf_fs
    if wide_fs % cfg.rf_fs != 0:
        print(f"error: --wide-fs {wide_fs} must be an integer multiple of "
              f"the mode RF rate {cfg.rf_fs}", file=sys.stderr)
        return 2
    ch = make_wideband_frontend(cfg, wide_fs, offsets)
    fused = isinstance(ch, FusedWidebandFrontend)
    print(f"wideband frontend: "
          f"{'fused one-matmul' if fused else 'two-stage uint8'} path",
          file=sys.stderr)
    retunes: dict[int, list[tuple[int, int]]] = {}
    if args.retune:
        try:
            for spec in args.retune:
                a, b, c = spec.split(":")
                if not 0 <= int(b) < len(offsets):
                    raise ValueError(spec)
                retunes.setdefault(int(a), []).append((int(b), int(c)))
        except ValueError:
            print(f"error: --retune takes SEG:STATION:HZ with STATION < "
                  f"{len(offsets)}, got {args.retune!r}", file=sys.stderr)
            return 2
        if not fused:
            print("error: --retune requires the fused wideband frontend "
                  "(RTSDR_WB_FUSED=0 or an ineligible grid forces the "
                  "two-stage path, whose weights are jit constants)",
                  file=sys.stderr)
            return 2
    # operand-weights serving: retunable without recompiling
    weights = ch.device_weights() if retunes else None
    bank = ChannelBank(rx, n_channels=len(offsets))
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    outdir = args.output_dir or "."
    os.makedirs(outdir, exist_ok=True)
    outs = [open(os.path.join(outdir, f"station_{k}.pcm"), "wb")
            for k in range(len(offsets))]
    framers = [RdsFramer(on_event=lambda kind, val, k=k: print(
        f"ch{k} {kind}: {val}", file=sys.stderr),
        correct_bursts=args.rds_correct)
        for k in range(len(offsets))] if rx.rds else None

    block_pairs = cfg.block_size_iq * ch.decim
    budget = cfg.block_size_iq / cfg.rf_fs
    cstate = ch.init_state()
    bstate = bank.init_state()
    if args.checkpoint:
        try:
            cstate, bstate = state_util.load_state(args.checkpoint,
                                                   (cstate, bstate))
            print(f"resumed state from {args.checkpoint}", file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as e:  # shape-incompatible (e.g. older release's
            # state layout) or corrupt npz: never fatal, start fresh
            print(f"warning: could not resume DSP state ({e!r}); "
                  "starting fresh", file=sys.stderr)
        if framers is not None:
            try:
                with open(args.checkpoint + ".rds.json") as f:
                    d = json.load(f)
                if (d.get("kind") != "wideband"
                        or d.get("stations") != offsets):
                    print(f"warning: {args.checkpoint}.rds.json does not "
                          f"match --stations {offsets}; starting framers "
                          "fresh", file=sys.stderr)
                else:
                    for fr, fd in zip(framers, d["framers"]):
                        fr.load_state_dict(fd)
                    print(f"resumed {len(framers)} RDS framers from "
                          f"{args.checkpoint}.rds.json", file=sys.stderr)
            except FileNotFoundError:
                pass
            except Exception as e:  # truncated/corrupt sidecar: never fatal
                # Some framers may already be (half-)loaded; rebuild them all
                # so "starting fresh" is actually true.
                framers = [RdsFramer(on_event=lambda kind, val, k=k: print(
                    f"ch{k} {kind}: {val}", file=sys.stderr),
                    correct_bursts=args.rds_correct)
                    for k in range(len(offsets))]
                print(f"warning: could not resume RDS framer state ({e!r});"
                      " starting fresh", file=sys.stderr)
    seg_n = max(1, args.segment)
    if args.warmup:
        t0 = time.perf_counter()
        zu = jnp.full((seg_n * 2 * block_pairs,), 128, jnp.uint8)
        _, wout, _ = bank.run_wideband_u8_jit(bstate, ch, zu, cstate,
                                              weights=weights)
        # warm the per-station PCM conversion (its first-use compile
        # otherwise lands on the first live segment)
        wpcm = (stereo_pcm(wout.left, wout.right) if rx.stereo
                else mono_pcm(wout.mono))
        np.asarray(wpcm).ravel()[:1]
        print(f"warmed up (compiled) in {time.perf_counter()-t0:.1f} s",
              file=sys.stderr)
    n_blocks = 0
    t_total = 0.0
    # (batched (S, ...) pcm device array, out, real blocks, dispatched
    # blocks incl. EOF pad) awaiting fetch
    in_flight = []

    def drain_one():
        # ONE batched device_get per drained entry: per-station
        # np.asarray/int() fetches each pay a device sync and a transfer,
        # which with N stations adds up
        pcms, out, nb_real, nb_disp = in_flight.pop(0)
        if framers is not None:
            pcm_np, nb_np, bits_np = jax.device_get(
                (pcms, out.rds_nbits, out.rds_bits))
        else:
            pcm_np = jax.device_get(pcms)
            nb_np = bits_np = None
        for k in range(len(offsets)):
            row = np.asarray(pcm_np[k])
            if nb_real < nb_disp:
                # trim the EOF silence padding (dispatched at the
                # compiled segment shape) back to the blocks actually read
                row = row[: (row.shape[-1] // nb_disp) * nb_real]
            row.astype("<i2").tofile(outs[k])
            if framers is not None:
                # (nb,) per-block counts in segment mode, a scalar otherwise
                nbk = np.atleast_1d(np.asarray(nb_np[k]))[:nb_real]
                bitsk = np.atleast_2d(np.asarray(bits_np[k]))
                for bi in range(nbk.shape[0]):
                    if nbk[bi] > 0:
                        framers[k].feed(bitsk[bi][:nbk[bi]])

    seg_i = 0
    while True:
        if seg_i in retunes:
            # drain first: pending outputs belong to the old grid and
            # must reach the old framers before the station re-points
            while in_flight:
                drain_one()
            for si, hz in retunes.pop(seg_i):
                ch.retune(si, hz)
                if framers is not None:
                    framers[si] = RdsFramer(
                        on_event=lambda kind, val, k=si: print(
                            f"ch{k} {kind}: {val}", file=sys.stderr),
                        correct_bursts=args.rds_correct)
                print(f"retuned station {si} -> {hz} Hz at segment "
                      f"{seg_i} (no recompile)", file=sys.stderr)
            weights = ch.device_weights()
        # --segment G: channelize + decode G wideband blocks per device
        # call (one graph, G times fewer dispatches — same serving shape as
        # the station bank; the trailing partial segment shrinks to what the
        # pipe delivered, at worst one extra compile at stream end).
        # Clamp to --max-blocks so segment mode does not overshoot, and
        # keep the blocking pipe read OUT of the timed span (a paced live
        # source would otherwise be misreported as barely real-time).
        want = seg_n
        if args.max_blocks:
            want = min(want, args.max_blocks - n_blocks)
            if want <= 0:
                break
        buf = fin.read(want * 2 * block_pairs)
        nb_got = 0 if buf is None else len(buf) // (2 * block_pairs)
        if not nb_got:
            break
        t0 = time.perf_counter()
        # ship RAW BYTES: f32 rails are 4x the host-to-device upload
        raw = np.frombuffer(buf[:nb_got * 2 * block_pairs], dtype=np.uint8)
        pad_blocks = 0
        if nb_got < seg_n and not args.checkpoint:
            # trailing partial group: pad with 0x80 "silence" to the
            # ALREADY-COMPILED segment shape — a fresh tail-shape compile
            # costs seconds mid-stream
            # (same rule as the single-station loop; the pad's PCM/RDS
            # rows are trimmed in the drain; --checkpoint keeps the
            # exact-shape dispatch so saved state stays faithful)
            pad_blocks = seg_n - nb_got
            raw = np.concatenate([raw, np.full(pad_blocks * 2 * block_pairs,
                                               128, np.uint8)])
        bstate, out, cstate = bank.run_wideband_u8_jit(  # async dispatch
            bstate, ch, jnp.asarray(raw), cstate, weights=weights)
        seg_i += 1
        # ONE batched (S, ...) PCM array: a per-station list would make the
        # drain's device_get fetch N+2 leaves, each its own transfer
        if rx.stereo:
            pcms = stereo_pcm(out.left, out.right)
        else:
            pcms = mono_pcm(out.mono)
        in_flight.append((pcms, out, nb_got, nb_got + pad_blocks))
        if len(in_flight) > args.pipeline:  # defer fetch to overlap dispatch
            drain_one()
        n_blocks += nb_got
        dt = time.perf_counter() - t0
        t_total += dt
        if args.stats:
            print(f"block {n_blocks}: {dt*1e3:.2f} ms "
                  f"({nb_got*budget/dt:.1f}x real time)", file=sys.stderr)
        if args.max_blocks and n_blocks >= args.max_blocks:
            break
    while in_flight:
        drain_one()
    for f in outs:
        f.close()
    if args.checkpoint:
        state_util.save_state(args.checkpoint, (cstate, bstate))
        if framers is not None:
            _atomic_json(args.checkpoint + ".rds.json",
                         # ch.offsets, not the parsed --stations list:
                         # --retune re-points stations mid-stream and the
                         # sidecar must describe the grid the saved state
                         # was actually built on
                         {"kind": "wideband", "stations": list(ch.offsets),
                          "framers": [fr.state_dict() for fr in framers]})
        print(f"saved state to {args.checkpoint}", file=sys.stderr)
    if args.stats and n_blocks:
        print(f"total: {n_blocks} blocks, avg {t_total/n_blocks*1e3:.2f} ms"
              f"/block, {budget*n_blocks/t_total:.1f}x real time",
              file=sys.stderr)
    print(f"channelized {len(offsets)} stations x {n_blocks} blocks",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.io_depth < 1:
        print(f"error: --io-depth must be >= 1, got {args.io_depth}",
              file=sys.stderr)
        return 2
    if args.pipeline < 0:
        print(f"error: --pipeline must be >= 0, got {args.pipeline}",
              file=sys.stderr)
        return 2

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from real_time_sdr_tpu.utils import compile_cache
    compile_cache.enable()

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.models.rds_framing import RdsFramer
    from real_time_sdr_tpu.utils.audio import mono_pcm, stereo_pcm
    from real_time_sdr_tpu.utils import native_io
    from real_time_sdr_tpu.utils import state as state_util

    stereo = args.type in ("s", "r")
    rds = args.type == "r"
    rx = Receiver(args.mode, stereo=stereo, rds=rds, pll_tier=args.pll_tier,
                  rds_timing=args.rds_timing)
    cfg = rx.cfg

    if args.stations:
        return run_wideband(args, rx, cfg)
    block_bytes = 2 * cfg.block_size_iq
    budget = cfg.block_size_iq / cfg.rf_fs  # real-time seconds per block

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    fout = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    # Native threaded ring-buffered I/O (native/io_runtime.cpp); transparent
    # Python fallback when the shared library is unavailable.
    reader = native_io.BlockReader(fin, block_bytes,
                                   depth=args.io_depth,
                                   drop_oldest=args.drop_oldest)
    max_pcm_bytes = (2 if stereo else 1) * cfg.audio_block * 2
    writer = native_io.BlockWriter(fout, max_pcm_bytes, depth=2 * args.io_depth)

    state = rx.init_state()
    if args.checkpoint:
        try:
            state = state_util.load_state(args.checkpoint, state)
            print(f"resumed state from {args.checkpoint}", file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as e:  # shape-incompatible (e.g. older release's
            # state layout) or corrupt npz: never fatal, start fresh
            print(f"warning: could not resume DSP state ({e!r}); "
                  "starting fresh", file=sys.stderr)

    print(f"output: {int(cfg.audio_fs)} Hz s16le "
          f"{'stereo' if stereo else 'mono'}  (play with: aplay -r "
          f"{int(cfg.audio_fs)} -f S16_LE -c {2 if stereo else 1})",
          file=sys.stderr)
    if args.warmup:
        t0 = time.perf_counter()
        # compile the shape the stream will actually use (--segment blocks
        # per call); a mid-stream compile would back up a live source
        n2_w = max(1, args.segment) * block_bytes
        silent = jnp.full((n2_w,), 128, jnp.uint8)
        _, wout = rx.jit_step(state, silent)  # discarded
        # warm the PCM conversion too: its first-use compile otherwise
        # lands on the first live block and backs up a paced source
        wpcm = (stereo_pcm(wout.left, wout.right) if stereo
                else mono_pcm(wout.mono))
        np.asarray(wpcm).ravel()[:1]
        print(f"warmed up (compiled) in {time.perf_counter()-t0:.1f} s",
              file=sys.stderr)

    def emit(kind, val):
        if kind == "group":
            pi, gt, pty = val
            print(f"PI: {pi:x}", file=sys.stderr)
            print(f"PTY: {pty}", file=sys.stderr)
        elif kind == "ps":
            print(f"Program Service: {val}", file=sys.stderr)
        elif kind == "radiotext":
            print(f"RadioText: {val}", file=sys.stderr)
        elif kind == "ptyn":
            print(f"Program Type Name: {val}", file=sys.stderr)
        elif kind == "clock":
            print(f"Clock Time: {val}", file=sys.stderr)
        elif kind == "af":
            print("Alternative Frequencies: "
                  + ", ".join(f"{f:.1f}" for f in val), file=sys.stderr)

    framer = (RdsFramer(on_event=emit, correct_bursts=args.rds_correct)
              if rds else None)
    if framer is not None and args.checkpoint:
        try:
            with open(args.checkpoint + ".rds.json") as f:
                d = json.load(f)
            if d.get("kind") != "single":
                print(f"warning: {args.checkpoint}.rds.json is not a "
                      "single-station checkpoint; starting framer fresh",
                      file=sys.stderr)
            else:
                framer.load_state_dict(d["framer"])
                print(f"resumed RDS framer from {args.checkpoint}.rds.json",
                      file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as e:  # truncated/corrupt sidecar: never fatal
            print(f"warning: could not resume RDS framer state ({e!r}); "
                  "starting fresh", file=sys.stderr)
            framer = RdsFramer(on_event=emit,
                               correct_bursts=args.rds_correct)

    def read_block():
        buf = reader.next()
        if buf is None:
            return None
        # timestamp at ingest: end-to-end block latency is measured from
        # the moment the raw bytes leave the input ring to the moment the
        # block's PCM enters the output ring
        return buf, time.perf_counter()

    def read_group():
        """Read up to --segment blocks as ONE device operand. Aggregating
        g blocks amortizes the per-call upload, dispatch and fetch overhead
        to 1/g of it per block, at g blocks of added latency
        (experiments/e2e_latency.py measures it)."""
        want = max(1, args.segment)
        if args.max_blocks:
            want = min(want, args.max_blocks - n_disp)
            if want <= 0:
                return None
        bufs, t_in = [], None
        while len(bufs) < want:
            nb = read_block()
            if nb is None:
                break
            buf, t = nb
            bufs.append(buf)
            t_in = t_in if t_in is not None else t
        if not bufs:
            return None
        arr = bufs[0] if len(bufs) == 1 else np.concatenate(bufs)
        return arr, t_in, len(bufs)

    n_disp = 0

    n_blocks = 0
    t_total = 0.0
    latencies: list[float] = []
    # Pipelined dispatch: keep up to --pipeline blocks in flight before
    # forcing the PCM fetch (the only device sync). Device programs
    # execute in order, so results arrive in order; the fetch of block
    # k-N overlaps the compute of block k. Each queued block adds one
    # block-duration of audio latency; the win is hiding dispatch and the
    # host-device round trip behind device work.
    from collections import deque
    in_flight: deque = deque()

    def drain(k: int):
        """Fetch k queued blocks with ONE device_get. Per-leaf
        np.asarray/int() fetches each pay a device sync and a transfer;
        batching k blocks amortizes that round trip to 1/k of it."""
        nonlocal n_blocks
        take = [in_flight.popleft() for _ in range(k)]
        if framer is not None:
            # only entries that will actually emit a --monitor snapshot
            # ship their (larger) RRC output through the fetch
            ev = max(1, args.monitor_every)
            needs, base = [], n_blocks
            for _, _o, _, g in take:
                needs.append(bool(args.monitor) and rds and any(
                    (base + j + 1) % ev == 0 for j in range(g)))
                base += g
            fetched = jax.device_get(
                [(p_, o.rds_nbits, o.rds_bits,
                  o.rds_clean if need else None)
                 for (p_, o, _, _), need in zip(take, needs)])
        else:
            fetched = jax.device_get(
                [(p_, None, None, None) for p_, o, _, _ in take])
        for (pcm_np, n, bits_np, clean_np), (_, _, t_in, g) in zip(fetched,
                                                                   take):
            step_len = pcm_np.shape[0] // g
            for j in range(g):
                writer.write(pcm_np[j * step_len:(j + 1) * step_len])
                if framer is not None:
                    # dimension (not g) test: a padded EOF tail can have
                    # g == 1 with multi-block output arrays
                    nj = int(n[j]) if np.ndim(n) else int(n)
                    if nj > 0:
                        framer.feed((bits_np[j] if bits_np.ndim > 1
                                     else bits_np)[:nj])
                n_blocks += 1
                if args.monitor and n_blocks % max(1, args.monitor_every) == 0:
                    _monitor_snapshot(
                        args.monitor, cfg, stereo, framer, n_blocks,
                        pcm_np[j * step_len:(j + 1) * step_len],
                        None if clean_np is None
                        else (clean_np[j] if clean_np.ndim > 1
                              else clean_np))
            latencies.append(time.perf_counter() - t_in)

    nxt = read_group()
    while nxt is not None:
        t0 = time.perf_counter()
        seg, t_in, g = nxt
        pad_blocks = 0
        if g < max(1, args.segment) and not args.checkpoint:
            # EOF tail group: pad with 0x80 "silence" to the segment
            # shape so the ALREADY-COMPILED graph serves it — a fresh
            # tail-shape compile costs seconds at stream end. The
            # pad's PCM/RDS rows are sliced off below; the carried state
            # absorbs the silent pad, which is fine at stream end —
            # --checkpoint keeps the exact-shape dispatch instead so the
            # saved state stays faithful to the real input.
            pad_blocks = max(1, args.segment) - g
            seg = np.concatenate(
                [seg, np.full(pad_blocks * block_bytes, 128, np.uint8)])
        state, out = rx.jit_step(state, jnp.asarray(seg))  # async dispatch
        n_disp += g              # (jit caches one graph per segment shape)
        r0 = time.perf_counter()
        nxt = read_group()
        read_wait = time.perf_counter() - r0  # blocked on the SOURCE, not
        # processing: a paced live source delivers a g-block group in
        # g*30.6 ms — counting that wait as work would misreport a
        # keeping-up pipeline as slower than real time
        if stereo:
            pcm = stereo_pcm(out.left, out.right)
        else:
            pcm = mono_pcm(out.mono)
        if pad_blocks:
            pcm = pcm[:g * (pcm.shape[0] // (g + pad_blocks))]
        in_flight.append((pcm, out, t_in, g))
        if len(in_flight) > args.pipeline:
            # drain half the window per fetch: the queue stays half full so
            # dispatches keep overlapping, and the fetch amortizes over k
            drain(max(1, (len(in_flight) + 1) // 2))
        dt = max(time.perf_counter() - t0 - read_wait, 1e-9)
        t_total += dt
        if args.stats:
            print(f"block {n_blocks}: {dt*1e3:.2f} ms "
                  f"({g*budget/dt:.1f}x real time)", file=sys.stderr)
    while in_flight:
        drain(len(in_flight))
    reader.close()
    writer.close()  # drains the ring
    if reader.dropped:
        print(f"dropped {reader.dropped} input blocks (consumer too slow)",
              file=sys.stderr)
    fout.flush()

    if framer is not None and framer.events.groups_decoded:
        ev = framer.events
        print(f"RDS summary: {ev.groups_decoded} groups decoded, "
              f"{ev.blocks_corrected} blocks burst-corrected", file=sys.stderr)
    if args.checkpoint:
        state_util.save_state(args.checkpoint, state)
        if framer is not None:
            _atomic_json(args.checkpoint + ".rds.json",
                         {"kind": "single", "framer": framer.state_dict()})
        print(f"saved state to {args.checkpoint}", file=sys.stderr)
    if args.stats and n_blocks:
        print(f"total: {n_blocks} blocks, avg {t_total/n_blocks*1e3:.2f} ms"
              f"/block, {budget*n_blocks/t_total:.1f}x real time",
              file=sys.stderr)
        if latencies:
            lat = np.sort(np.asarray(latencies))
            p50 = lat[len(lat) // 2]
            p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
            # steady state = last half: separates the startup transient
            # (first-call setup, queue fill) from whether the pipeline is
            # KEEPING UP (a falling-behind pipeline grows without bound)
            half = np.sort(np.asarray(latencies[len(latencies) // 2:]))
            print(f"block latency (ingest->PCM out): p50 {p50*1e3:.1f} ms, "
                  f"p99 {p99*1e3:.1f} ms, max {lat[-1]*1e3:.1f} ms, "
                  f"steady-state p50 {half[len(half)//2]*1e3:.1f} ms vs "
                  f"{budget*1e3:.2f} ms block deadline "
                  f"(dropped {reader.dropped})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
