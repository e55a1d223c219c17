"""Smoke test of the FM stereo+RDS receiver on one GPU.

    python chip_smoke.py            # phases 0-4 on one card
    python chip_smoke.py --multi    # the four-card phase only

Drives the system's main path through the entry points a user calls, with
every stage compiled for the card, and checks what comes out by the repo's
own means (the float64 golden chain, the RDS framer, and the same program
run on the host CPU in this process). Every phase asserts; a failed phase
ends the run with a non-zero exit before the result line.

0. Environment: the card's name and power limit, the JAX version and
   devices, the compile-cache directory. Fails unless the first JAX device
   is a GPU.
1. The live CLI (``real_time_sdr_tpu.cli.main``, mode 0 stereo+RDS) on a
   synthesized 40-block capture, at the default PLL tier and at tier 3:
   PS, PI and PTY exact, PCM length exact, per-block L/R audio against the
   golden chain above the repo's bound (tests/test_chain_golden_parity.py),
   and the sustained per-block time against the 30.625 ms block deadline.
2. The full-width bank: ``ChannelBank`` of 32 mode-0 stereo+RDS tier-3
   receivers on three chained 12-block segments (56 MB of IQ per call),
   each channel a distinct time shift of one capture. Channels 0, 15 and
   31 must match the same program on the CPU (RDS bits exact, audio
   >= 90 dB: float32 with Precision.HIGHEST differs only in summation
   order, a TF32 leak would read near 60 dB); PS decodes on every
   channel. Prints compile time, warm timings, and the XLA frontend alone
   at the same shape: its share of the step and its distance from the
   roofline.
3. The wideband serving default: 8 stations on the 100 kHz raster in one
   9.6 MS/s capture through ``make_wideband_frontend`` +
   ``ChannelBank.run_channelized_fused`` (three chained 12-block
   segments). Every PS decodes; station 0
   matches the CPU run (>= 90 dB, RDS bits exact).
4. Modes 1-3: one stereo+RDS stream each through ``Receiver.run_segment``
   (two chained 12-block segments, enough RDS groups for a PS): PS
   decodes and audio meets the golden bound.

``--multi`` needs four cards and runs only the multi-device paths, each
against the single-card run: ``ChannelBank`` on a 4-card mesh (32 channels
x 12 blocks), ``time_sharded_run`` over 4 cards, ``ShardedFusedWideband``
at 8 stations, and the joint 2x2 channel x time run. Each output must sit
on all four cards.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
from jax.sharding import Mesh

from golden.chain import run_stages
from real_time_sdr_tpu import cli
from real_time_sdr_tpu.config import AUDIO_SCALE, mode_config
from real_time_sdr_tpu.models.rds_framing import PTY_NAMES, RdsFramer
from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.wideband_frontend import (
    FusedWidebandFrontend, make_wideband_frontend)
from real_time_sdr_tpu.parallel.channel import ChannelBank
from real_time_sdr_tpu.utils import compile_cache, synth
from real_time_sdr_tpu.utils.logging import device_peaks
from real_time_sdr_tpu.utils.viz import snr_db

GOLDEN_STEREO_DB = 40.0   # tests/test_chain_golden_parity.py, blocks >= 1
CPU_PARITY_DB = 90.0      # same program on the CPU: summation order only
SHIFT = 2 * 997           # per-channel time shift in bytes (whole IQ pairs)


def check_devices(devices, count: int = 1) -> dict:
    """The result's device record; exits non-zero unless the first device
    is a GPU and there are at least ``count`` of them."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{d.platform} ({d.device_kind})")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found "
                         f"{len(devices)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def card_lines() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def decode_rds(bits_blocks, nbits_blocks) -> RdsFramer:
    """Feed (B, max_bits) bits with (B,) counts to a fresh framer."""
    fr = RdsFramer()
    for bits, n in zip(np.asarray(bits_blocks), np.asarray(nbits_blocks)):
        if n > 0:
            fr.feed(bits[:n])
    return fr


def timings(call, reps: int) -> np.ndarray:
    """Wall seconds of ``reps`` synchronous calls (block_until_ready)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def fmt_times(ts: np.ndarray, signal_s: float) -> str:
    med = float(np.median(ts))
    return (f"median {med * 1e3:.3f} ms (min {ts.min() * 1e3:.3f}, max "
            f"{ts.max() * 1e3:.3f}, n={ts.size}) = "
            f"{signal_s / med:.1f}x real time")


def shifted_streams(cfg, n_ch: int, n_blocks: int, **station_kw):
    """(n_ch, n_blocks*blk) uint8: channel c is one capture delayed by
    c*SHIFT bytes (each a real, continuous broadcast)."""
    blk = 2 * cfg.block_size_iq
    extra = -(-(n_ch - 1) * SHIFT // blk)
    iq, truth = synth.station_iq(cfg, n_blocks + extra, **station_kw)
    n = n_blocks * blk
    return np.stack([iq[c * SHIFT:c * SHIFT + n] for c in range(n_ch)]), truth


def channel(out, i):
    """Channel ``i`` of a batched ReceiverOutput (None leaves stay None)."""
    return type(out)(*[None if x is None else x[i] for x in out])


def audio_snr(got, ref) -> float:
    """The worse of the L/R audio SNRs of ``got`` against ``ref``."""
    return min(snr_db(ref.left, got.left), snr_db(ref.right, got.right))


def assert_parity(tag: str, got, ref, min_db: float) -> float:
    """Audio SNR of ``got`` vs ``ref`` (ReceiverOutput-like, numpy) and
    exact RDS; returns the worse of the L/R SNRs."""
    snr = audio_snr(got, ref)
    assert snr >= min_db, f"{tag}: audio {snr:.1f} dB < {min_db} dB"
    np.testing.assert_array_equal(got.rds_nbits, ref.rds_nbits,
                                  err_msg=f"{tag}: RDS bit counts differ")
    np.testing.assert_array_equal(got.rds_bits, ref.rds_bits,
                                  err_msg=f"{tag}: RDS bits differ")
    return snr


def stereo_golden_snrs(cfg, iq, left, right, n_blocks: int) -> list[float]:
    """Per-block min(L, R) SNR against the float64 golden chain, blocks
    after the acquisition block."""
    gold = run_stages(cfg, iq, stereo=True, rds=False)
    gl = gold["left"].reshape(n_blocks, -1)
    gr = gold["right"].reshape(n_blocks, -1)
    left = np.asarray(left).reshape(n_blocks, -1)
    right = np.asarray(right).reshape(n_blocks, -1)
    return [min(snr_db(gl[b], left[b]), snr_db(gr[b], right[b]))
            for b in range(1, n_blocks)]


def phase_cli(n_blocks: int = 40, tiers=(None, 3)) -> None:
    cfg = mode_config(0)
    ps, pi, pty = "SMOKE-FM", 0x5A17, 10
    iq, _ = synth.station_iq(cfg, n_blocks, ps_name=ps, pi=pi, pty=pty)
    deadline = cfg.block_size_iq / cfg.rf_fs
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "station.raw")
        iq.tofile(raw)
        for tier in tiers:
            out = os.path.join(tmp, f"tier{tier}.pcm")
            argv = ["0", "r", "--input", raw, "--output", out, "--warmup",
                    "--stats"]
            if tier is not None:
                argv += ["--pll-tier", str(tier)]
            name = f"tier {tier}" if tier is not None else (
                f"tier {cli.make_parser().parse_args([]).pll_tier} "
                f"(default)")
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            log = log.getvalue()
            assert rc == 0, f"cli {name} exited {rc}:\n{log[-2000:]}"
            assert f"Program Service: {ps}" in log, log[-2000:]
            assert f"PI: {pi:x}" in log, log[-2000:]
            assert f"PTY: {PTY_NAMES[pty]}" in log, log[-2000:]
            pcm = np.fromfile(out, "<i2")
            assert pcm.size == n_blocks * cfg.audio_block * 2, pcm.size
            lr = pcm.reshape(n_blocks, cfg.audio_block, 2) / AUDIO_SCALE
            snrs = stereo_golden_snrs(cfg, iq, lr[..., 0], lr[..., 1],
                                      n_blocks)
            assert min(snrs) >= GOLDEN_STEREO_DB, (name, snrs)
            warm = re.search(r"warmed up \(compiled\) in ([\d.]+) s", log)
            blocks = np.asarray([float(x) for x in re.findall(
                r"^block \d+: ([\d.]+) ms", log, re.M)]) / 1e3
            steady = blocks[len(blocks) // 4:]
            med = float(np.median(steady))
            print(f"# phase 1 cli 0 r {name}: PS/PI/PTY ok, PCM "
                  f"{pcm.size} samples ok, golden L/R min "
                  f"{min(snrs):.1f} dB (bound {GOLDEN_STEREO_DB}); "
                  f"warmup compile {warm.group(1) if warm else '?'} s, "
                  f"wall {wall:.1f} s; sustained per-block median "
                  f"{med * 1e3:.2f} ms (p90 "
                  f"{np.percentile(steady, 90) * 1e3:.2f} ms) vs "
                  f"{deadline * 1e3:.3f} ms deadline -> "
                  f"{'meets' if med < deadline else 'MISSES'} it "
                  f"({deadline / med:.2f}x)", flush=True)


def phase_bank(n_ch: int = 32, n_blk: int = 12, n_seg: int = 3,
               check=(0, 15, 31), reps: int = 7) -> None:
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    seg = n_blk * 2 * cfg.block_size_iq
    ps, pi = "BANK-32 ", 0x4B32
    streams, _ = shifted_streams(cfg, n_ch, n_seg * n_blk, ps_name=ps,
                                 pi=pi, pty=4)
    segs = [jax.device_put(streams[:, k * seg:(k + 1) * seg])
            for k in range(n_seg)]
    bank = ChannelBank(rx, n_ch)
    state = bank.init_state()
    t0 = time.perf_counter()
    state, out = bank.run_segment(state, segs[0])
    jax.block_until_ready(out)
    t_first = time.perf_counter() - t0
    outs = [out]
    for k in range(1, n_seg):
        state, out = bank.run_segment(state, segs[k])
        outs.append(out)
    outs = jax.device_get(outs)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        rx_c = Receiver(0, stereo=True, rds=True, pll_tier=3)
        bank_c = ChannelBank(rx_c, len(check))
        st_c = bank_c.init_state()
        worst = np.inf
        for k in range(n_seg):
            st_c, ref = bank_c.run_segment(st_c, jax.device_put(
                streams[list(check), k * seg:(k + 1) * seg], cpu))
            ref = jax.device_get(ref)
            for j, c in enumerate(check):
                worst = min(worst, assert_parity(
                    f"bank channel {c} segment {k}", channel(outs[k], c),
                    channel(ref, j), CPU_PARITY_DB))
    for c in range(n_ch):
        fr = decode_rds(np.concatenate([o.rds_bits[c] for o in outs]),
                        np.concatenate([o.rds_nbits[c] for o in outs]))
        assert fr.events.ps_name == ps and fr.events.pi == pi, (
            f"bank channel {c}: PS {fr.events.ps_name!r} PI {fr.events.pi}")

    box = {"s": state}

    def step():
        box["s"], o = bank.run_segment(box["s"], segs[1 % n_seg])
        return box["s"], o

    ts = timings(step, reps)
    signal_s = n_ch * n_blk * cfg.block_size_iq / cfg.rf_fs
    med = float(np.median(ts))
    print(f"# phase 2 bank {n_ch}ch x {n_blk}blk mode 0 stereo+RDS tier 3 "
          f"({segs[0].nbytes / 1e6:.1f} MB IQ/call): channels {list(check)}"
          f" vs CPU min {worst:.1f} dB, RDS exact; PS on all {n_ch} ok; "
          f"first call (compile+run) {t_first:.1f} s; warm "
          f"{fmt_times(ts, signal_s)}", flush=True)

    # the XLA frontend alone at the same shape (its share of the step)
    fe = jax.jit(jax.vmap(rx.frontend.__call__))
    fst = rx.frontend.init_state(batch=(n_ch,))
    t0 = time.perf_counter()
    demod, _ = jax.block_until_ready(fe(segs[0], fst))
    t_fc = time.perf_counter() - t0
    tf = timings(lambda: fe(segs[0], fst), reps)
    fe_med = float(np.median(tf))
    byts = segs[0].nbytes + demod.nbytes
    flops = n_ch * rx.frontend.rf_fir.cost(seg)["flops"]
    kind = jax.devices()[0].device_kind
    pk = device_peaks(kind)
    t_mem, t_mm = byts / pk["hbm_bps"], flops / pk["bf16_flops"]
    bound = "memory" if t_mem >= t_mm else "bf16 matmul"
    print(f"# phase 2 frontend alone (DualPhaseFIR + fm_demod, {n_ch}ch x "
          f"{n_blk}blk): first call {t_fc:.1f} s; warm "
          f"{fmt_times(tf, signal_s)}; {100 * fe_med / med:.1f}% of the "
          f"bank step; u8 in + f32 demod out = {byts / 1e6:.1f} MB, "
          f"{flops / 1e9:.1f} GFLOP; roofline floor "
          f"{max(t_mem, t_mm) * 1e6:.1f} us ({bound}-bound, published "
          f"peaks of {kind}) = {100 * max(t_mem, t_mm) / fe_med:.1f}% of "
          f"the measured time", flush=True)


def raster_offsets(cfg, wide_fs: int, n_st: int) -> list[int]:
    """n_st stations spread over the capture, snapped to the 100 kHz FM
    channel raster (bench.py's wideband grid)."""
    span = wide_fs // 2 - cfg.rf_fs // 2
    return [int(round((-span + 2 * span * k / max(n_st - 1, 1)) / 100e3)
                * 100e3) for k in range(n_st)]


def wideband_capture(cfg, n_st: int, n_blocks: int):
    wide_fs = 4 * cfg.rf_fs
    offs = raster_offsets(cfg, wide_fs, n_st)
    stations = [dict(offset_hz=o, ps_name=f"WBAND-{k:02d}", pi=0x7100 + k,
                     pty=1 + k % 8, tone_left=400.0 + 100 * k,
                     tone_right=1500.0 - 100 * k)
                for k, o in enumerate(offs)]
    iw, qw, truths = synth.wideband_iq(cfg, wide_fs, stations, n_blocks)
    return wide_fs, offs, iw, qw, truths


def phase_wideband(n_st: int = 8, n_blk: int = 12, n_seg: int = 3,
                   reps: int = 7) -> None:
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs, offs, iw, qw, truths = wideband_capture(cfg, n_st,
                                                     n_seg * n_blk)
    wf = make_wideband_frontend(cfg, wide_fs, offs)
    assert isinstance(wf, FusedWidebandFrontend), type(wf)
    n = n_blk * cfg.block_size_iq * wf.decim
    rails = [(jax.device_put(iw[k * n:(k + 1) * n]),
              jax.device_put(qw[k * n:(k + 1) * n])) for k in range(n_seg)]
    bank = ChannelBank(rx, n_st)
    bs, ws = bank.init_state(), wf.init_state()
    t0 = time.perf_counter()
    bs, out, ws = bank.run_channelized_fused_jit(bs, wf, *rails[0], ws)
    jax.block_until_ready(out)
    t_first = time.perf_counter() - t0
    outs = [out]
    for k in range(1, n_seg):
        bs, out, ws = bank.run_channelized_fused_jit(bs, wf, *rails[k], ws)
        outs.append(out)
    outs = jax.device_get(outs)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        rx_c = Receiver(0, stereo=True, rds=True, pll_tier=3)
        wf_c = make_wideband_frontend(cfg, wide_fs, offs)
        bank_c = ChannelBank(rx_c, n_st)
        bs_c, ws_c = bank_c.init_state(), wf_c.init_state()
        worst0, worst_all = np.inf, np.inf
        for k in range(n_seg):
            bs_c, ref, ws_c = bank_c.run_channelized_fused_jit(
                bs_c, wf_c, jax.device_put(iw[k * n:(k + 1) * n], cpu),
                jax.device_put(qw[k * n:(k + 1) * n], cpu), ws_c)
            ref = jax.device_get(ref)
            worst_all = min([worst_all] + [
                audio_snr(channel(outs[k], s), channel(ref, s))
                for s in range(n_st)])
            worst0 = min(worst0, assert_parity(
                f"wideband station 0 segment {k}", channel(outs[k], 0),
                channel(ref, 0), CPU_PARITY_DB))
    for s, truth in enumerate(truths):
        fr = decode_rds(np.concatenate([o.rds_bits[s] for o in outs]),
                        np.concatenate([o.rds_nbits[s] for o in outs]))
        assert (fr.events.ps_name == truth["ps_name"]
                and fr.events.pi == truth["pi"]), (
            f"station {s}: PS {fr.events.ps_name!r} PI {fr.events.pi}")

    box = {"b": bs, "w": ws}

    def step():
        box["b"], o, box["w"] = bank.run_channelized_fused_jit(
            box["b"], wf, *rails[1 % n_seg], box["w"])
        return box["b"], o, box["w"]

    ts = timings(step, reps)
    print(f"# phase 3 wideband {n_st} stations from one "
          f"{wide_fs / 1e6:g} MS/s capture ({n_blk}-block segments, fused "
          f"frontend, {wf.compute_dtype}): PS on all {n_st} ok; station 0 "
          f"vs CPU {worst0:.1f} dB, RDS exact (all stations min "
          f"{worst_all:.1f} dB); first call (compile+run) {t_first:.1f} s; "
          f"warm {fmt_times(ts, n_blk * cfg.block_size_iq / cfg.rf_fs)} "
          f"of the capture", flush=True)


def phase_modes(modes=(1, 2, 3), n_blk: int = 12, n_seg: int = 2) -> None:
    for m in modes:
        rx = Receiver(m, stereo=True, rds=True, pll_tier=3)
        cfg = rx.cfg
        ps, pi = f"MODE-{m}OK", 0x6A00 + m
        nb = n_seg * n_blk
        iq, _ = synth.station_iq(cfg, nb, ps_name=ps, pi=pi, pty=m)
        seg = n_blk * 2 * cfg.block_size_iq
        run = jax.jit(rx.run_segment)
        st = rx.init_state()
        t0 = time.perf_counter()
        outs = []
        for k in range(n_seg):
            st, out = run(st, iq[k * seg:(k + 1) * seg])
            outs.append(jax.device_get(out))
            if k == 0:
                t_first = time.perf_counter() - t0
        fr = decode_rds(np.concatenate([o.rds_bits for o in outs]),
                        np.concatenate([o.rds_nbits for o in outs]))
        assert fr.events.ps_name == ps and fr.events.pi == pi, (
            f"mode {m}: PS {fr.events.ps_name!r} PI {fr.events.pi}")
        snrs = stereo_golden_snrs(
            cfg, iq, np.concatenate([o.left for o in outs]),
            np.concatenate([o.right for o in outs]), nb)
        assert min(snrs) >= GOLDEN_STEREO_DB, (m, snrs)
        print(f"# phase 4 mode {m} stereo+RDS tier 3, {n_seg}x{n_blk} "
              f"blocks: PS/PI ok, golden L/R min {min(snrs):.1f} dB "
              f"(bound {GOLDEN_STEREO_DB}); first call (compile+run) "
              f"{t_first:.1f} s", flush=True)


def on_all_devices(tag: str, tree, n: int) -> None:
    for leaf in jax.tree_util.tree_leaves(tree):
        devs = {s.device for s in leaf.addressable_shards}
        assert len(devs) == n, f"{tag}: a leaf sits on {len(devs)} devices"


def phase_multi(devices, n_ch: int = 32, n_blk: int = 12,
                n_time_blocks: int = 12) -> None:
    n = len(devices)
    assert n == 4, n
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    blk = 2 * cfg.block_size_iq

    # channel bank on a 4-card mesh vs the same bank on one card
    streams, _ = shifted_streams(cfg, n_ch, n_blk)
    bank_m = ChannelBank(rx, n_ch, mesh=Mesh(np.array(devices), ("ch",)))
    t0 = time.perf_counter()
    _, out_m = bank_m.run_segment(bank_m.init_state(),
                                  bank_m.place(streams))
    jax.block_until_ready(out_m)
    t_m = time.perf_counter() - t0
    on_all_devices("mesh bank", out_m, n)
    bank_1 = ChannelBank(rx, n_ch)
    _, out_1 = bank_1.run_segment(bank_1.init_state(),
                                  jax.device_put(streams, devices[0]))
    out_m, out_1 = jax.device_get((out_m, out_1))
    worst = min(assert_parity(f"mesh bank channel {c}", channel(out_m, c),
                              channel(out_1, c), 80.0)
                for c in range(n_ch))
    print(f"# multi: ChannelBank {n_ch}ch x {n_blk}blk on a {n}-card mesh: "
          f"all channels vs one card min {worst:.1f} dB, RDS exact; first "
          f"call {t_m:.1f} s", flush=True)

    # time sharding over 4 cards vs the sequential receiver
    iq, _ = synth.station_iq(cfg, n_time_blocks, ps_name="TIME-4  ")
    # host arrays: the sharded entries place them on the mesh themselves
    stream = iq.reshape(n_time_blocks, blk)
    from real_time_sdr_tpu.parallel.time_shard import (
        time_sharded_run, time_sharded_run_bank)
    t0 = time.perf_counter()
    outs = time_sharded_run(rx, Mesh(np.array(devices), ("time",)), stream,
                            axis="time", overlap=1)
    jax.block_until_ready(outs)
    t_t = time.perf_counter() - t0
    on_all_devices("time_sharded_run", outs, n)
    _, seq = rx.jit_run_blocks(rx.init_state(), stream)
    snr = assert_parity("time_sharded_run", jax.device_get(outs),
                        jax.device_get(seq), 60.0)
    print(f"# multi: time_sharded_run {n_time_blocks} blocks over {n} "
          f"cards vs sequential {snr:.1f} dB, RDS exact; first call "
          f"{t_t:.1f} s", flush=True)

    # sharded fused wideband (8 stations) vs the unsharded fused chain
    from real_time_sdr_tpu.parallel.wideband import ShardedFusedWideband
    wide_fs, offs, iw, qw, _ = wideband_capture(cfg, 8, n_blk)
    wf = FusedWidebandFrontend(cfg, wide_fs, offs)
    sf = ShardedFusedWideband(wf, rx, Mesh(np.array(devices), ("ch",)))
    ws, bs = sf.init_state()
    t0 = time.perf_counter()
    _, _, out_f = sf.step(ws, bs, iw, qw)
    jax.block_until_ready(out_f)
    t_w = time.perf_counter() - t0
    on_all_devices("ShardedFusedWideband", out_f, n)
    demod_u, _ = wf(jax.device_put(iw, devices[0]),
                    jax.device_put(qw, devices[0]), wf.init_state())
    _, out_u = jax.vmap(rx.run_segment_demod)(rx.init_state(batch=(8,)),
                                              demod_u)
    out_f, out_u = jax.device_get((out_f, out_u))
    snr = assert_parity("ShardedFusedWideband", out_f, out_u, 70.0)
    print(f"# multi: ShardedFusedWideband 8 stations over {n} cards vs "
          f"unsharded {snr:.1f} dB, RDS exact; first call {t_w:.1f} s",
          flush=True)

    # joint 2x2 channel x time vs each channel's sequential receiver
    cstream = np.stack([iq.reshape(n_time_blocks, blk),
                        np.roll(iq, SHIFT).reshape(n_time_blocks, blk)])
    t0 = time.perf_counter()
    outs_j = time_sharded_run_bank(
        rx, Mesh(np.array(devices).reshape(2, 2), ("ch", "time")),
        cstream, overlap=1)
    jax.block_until_ready(outs_j)
    t_j = time.perf_counter() - t0
    on_all_devices("joint ch x time", outs_j, n)
    outs_j = jax.device_get(outs_j)
    worst = np.inf
    for c in range(2):
        _, seq_c = rx.jit_run_blocks(rx.init_state(), cstream[c])
        worst = min(worst, assert_parity(
            f"joint channel {c}", channel(outs_j, c),
            jax.device_get(seq_c), 60.0))
    print(f"# multi: joint 2x2 ch x time vs sequential min {worst:.1f} dB, "
          f"RDS exact; first call {t_j:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    cache = compile_cache.enable()
    devices = jax.devices()
    print(f"# phase 0 jax {jax.__version__}, devices {devices}, compile "
          f"cache {cache}", flush=True)
    device = check_devices(devices, 4 if args.multi else 1)
    print(card_lines(), flush=True)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(devices[:4])
    else:
        phase_cli()
        phase_bank()
        phase_wideband()
        phase_modes()
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
