"""North-star configs[4]: 64+ FM stations channelized + fully demodulated
in parallel from ONE wideband capture (BASELINE.md).

One 19.2 MS/s complex capture (8x the mode-0 station rate) carries 64
stations on a 300 kHz raster; the periodic-exact channelizer mixes and
decimates all of them in one graph (tone tables are (64, lcm<=192)
statics — the naive per-sample tables would need multi-GB at segment
lengths) and the 64-wide channel bank decodes stereo+RDS for every
station. Reports ms/block and x-realtime on the WIDEBAND input rate.

Scale beyond 64 (fused frontend only): the capture rate auto-widens to
fit the raster span (--wide-mult overrides) and the combined-filter tap
count scales with the decimation so the transition band stays ~one
raster step.

Usage: python experiments/wideband64.py [--stations 64] [--seg 4]
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
    ap.add_argument("--seg", type=int, default=None,
                    help="wideband blocks per device call (default: 8 for "
                         "the fused frontend, 24 for the u8 path)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timing reps (default: scaled with the station "
                         "count)")
    ap.add_argument("--path", choices=("auto", "fused", "u8"),
                    default="auto",
                    help="wideband frontend: fused one-matmul demod "
                         "(models/wideband_frontend.py, the serving "
                         "default on periodic grids) or the two-stage "
                         "uint8 Channelizer path")
    ap.add_argument("--wide-mult", type=int, default=None,
                    help="capture rate as a multiple of the station rate "
                         "(default: smallest even multiple fitting the "
                         "300 kHz raster span, 8 at 64 stations, 16 at "
                         "128)")
    ap.add_argument("--decode-check", action="store_true",
                    help="also synthesize 3 real stations in the scene and "
                         "assert their PS decode (slow: host-side synth)")
    ap.add_argument("--operand-weights", action="store_true",
                    help="serve the fused fold weights as DEVICE OPERANDS "
                         "(wf.device_weights) instead of jit constants — "
                         "the runtime-retunable form; it also keeps "
                         "hundreds of stations' weights out of the "
                         "compiled program)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from real_time_sdr_tpu.utils import compile_cache
    compile_cache.enable()

    from real_time_sdr_tpu.models.channelizer import Channelizer
    from real_time_sdr_tpu.models.wideband_frontend import (
        FusedWidebandFrontend)
    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.parallel.channel import ChannelBank
    from real_time_sdr_tpu.utils import synth

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    n_st = args.stations
    # 300 kHz raster centered on DC; integer offsets keep the
    # periodic-exact tone mode. The capture rate is the smallest even
    # station-rate multiple whose Nyquist covers the raster span
    # (64 st -> 8x = 19.2 MS/s, 128 st -> 16x = 38.4 MS/s)
    offs = [int((k - (n_st - 1) / 2) * 300_000) for k in range(n_st)]
    span = max(abs(o) for o in offs) + 150_000
    mult = args.wide_mult
    if mult is None:
        mult = 8
        while mult * cfg.rf_fs // 2 < span:
            mult += 2
    wide_fs = mult * cfg.rf_fs
    assert wide_fs // 2 >= span, (wide_fs, span)
    # combined-filter taps scale with the decimation so the transition
    # band stays ~one raster step (taps_factor 2 at decim 8 = the
    # historic 64-station design; 4 at decim 16)
    tf = max(2, mult // 4)
    if args.path == "fused":
        ch = FusedWidebandFrontend(cfg, wide_fs, offs, taps_factor=tf)
    elif args.path == "u8":
        ch = Channelizer(cfg, wide_fs, offs, taps_factor=tf)
        assert ch.tone_period, "expected the periodic-exact tone mode"
    else:
        from real_time_sdr_tpu.models.wideband_frontend import (
            make_wideband_frontend)
        ch = make_wideband_frontend(cfg, wide_fs, offs, taps_factor=tf)
    fused = isinstance(ch, FusedWidebandFrontend)
    if args.seg is None:
        args.seg = 8 if fused else 24
    if args.reps is None:
        args.reps = max(8, 512 // args.seg)
    print(f"# frontend: {'fused one-matmul demod' if fused else 'two-stage uint8'}"
          + (f" (lo={ch.lo}, R={ch.r_n}, {ch.compute_dtype})" if fused
             else f" (tone lcm {ch.tone_period})"), file=sys.stderr)
    bank = ChannelBank(rx, n_st)

    block_pairs = cfg.block_size_iq * ch.decim
    n = args.seg * block_pairs
    rng = np.random.default_rng(0)
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1)

    wts = None
    if args.operand_weights:
        assert fused, "--operand-weights needs the fused frontend"
        wts = ch.device_weights()

    def step(cstate, bstate, i, q, w=None):
        if fused:
            bstate, out, cstate = bank.run_channelized_fused(
                bstate, ch, i, q, cstate, group=16, weights=w)
        else:
            bstate, out, cstate = bank.run_channelized(
                bstate, ch, i, q, cstate)
        sums = [jnp.sum(o if o.dtype != jnp.int32 else o.astype(jnp.float32))
                for o in jax.tree_util.tree_leaves(out)]
        return cstate, bstate, sum(sums)

    jstep_w = jax.jit(step)
    jstep = ((lambda c, b, i, q: jstep_w(c, b, i, q, wts))
             if wts is not None else jstep_w)
    cs, bs = ch.init_state(), rx.init_state(batch=(n_st,))
    t0 = time.perf_counter()
    c2, b2, dig = jstep(cs, bs, iw, qw)
    float(np.asarray(dig))
    print(f"# compile+first: {time.perf_counter()-t0:.1f} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    c, b = cs, bs
    for _ in range(args.reps):
        c, b, dig = jstep(c, b, iw, qw)
    float(np.asarray(dig))
    per_block = (time.perf_counter() - t0) / args.reps / args.seg
    wb_ms = block_pairs / per_block / 1e6
    print(f"# {n_st} stations from one {wide_fs/1e6:g} MS/s capture "
          f"({args.seg}-block segments): {per_block*1e3:.2f} ms/block, "
          f"{wb_ms:.0f} MS/s wideband = {wb_ms/(wide_fs/1e6):.1f}x realtime"
          f" ({n_st * cfg.rf_fs / 1e6:g} MS/s of station IQ decoded)",
          file=sys.stderr)

    if args.decode_check:
        picks = sorted({min(3, n_st - 1), n_st // 2, max(n_st - 2, 0)})
        scene = [dict(offset_hz=offs[k], ps_name=f"WB64-{k:03d}"[:8],
                      pi=0x1000 + k, pty=4) for k in picks]
        nb = 26
        iw2, qw2, truths = synth.wideband_iq(cfg, wide_fs, scene, nb)
        cs, bs = ch.init_state(), rx.init_state(batch=(n_st,))
        from real_time_sdr_tpu.models.rds_framing import RdsFramer
        framers = {k: RdsFramer() for k in picks}
        for s0 in range(0, nb, args.seg):
            blks = min(args.seg, nb - s0)
            sl = slice(s0 * block_pairs, (s0 + blks) * block_pairs)
            bs, out, cs = bank.run_wideband_jit(
                bs, ch, jnp.asarray(iw2[sl]), jnp.asarray(qw2[sl]), cs,
                weights=wts)
            nbits = np.asarray(out.rds_nbits)
            bits = np.asarray(out.rds_bits)
            for k in picks:
                for bi in range(nbits.shape[1]):
                    if nbits[k, bi] > 0:
                        framers[k].feed(bits[k, bi][:nbits[k, bi]])
        for k in picks:
            ev = framers[k].events
            print(f"# station {k} @ {offs[k]/1e6:+.1f} MHz: "
                  f"PS={ev.ps_name!r} PI={ev.pi:#06x} "
                  f"groups={ev.groups_decoded}", file=sys.stderr)
            assert ev.ps_name == f"WB64-{k:03d}"[:8], (k, ev.ps_name)
        print("# decode check OK (3/3 stations)", file=sys.stderr)


if __name__ == "__main__":
    main()
