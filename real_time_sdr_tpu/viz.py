"""One-command diagnostic sheet for a capture: ``python -m
real_time_sdr_tpu.viz <mode> [capture.raw] --out data/viz``.

Runs the capture (or, with no file, a synthesized stereo+RDS station)
through the receiver once and renders every figure the reference produces
across three separate workflows — PSD panels per stage (model/fmMonoBlock.py
in-lab figure), the PSD-over-time animation (model/fmMonoAnim.py) as a
waterfall, and the gnuplot RDS eye overlay (data/example.gnuplot:14-22) as
an eye diagram + symbol constellation — so "debugging a bad channel" is one
command instead of hand-plotting ``logVector`` dumps.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu.viz",
        description="Render the diagnostic figure sheet for an IQ capture.")
    ap.add_argument("mode", type=int, choices=(0, 1, 2, 3))
    ap.add_argument("capture", nargs="?", default=None,
                    help="raw interleaved uint8 IQ; omit for a synthetic "
                         "stereo+RDS demo station")
    ap.add_argument("--out", default="data/viz", help="output directory")
    ap.add_argument("--blocks", type=int, default=24,
                    help="number of blocks to analyze (from the start)")
    ap.add_argument("--golden", action="store_true",
                    help="also run the float64 golden oracle over the same "
                         "capture and render device-vs-golden PSD overlays "
                         "with per-stage SNR (regression triage)")
    ap.add_argument("--alt", action="store_true",
                    help="also run the alternative RDS receiver "
                         "(models/rds_alt) and render its Costas frequency "
                         "track + complex constellation")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--ber", action="store_true",
                    help="instead of the figure sheet, sweep AWGN levels on "
                         "a synthesized station and render the RDS BER / "
                         "decode-survival curve (ber_curve.png + table on "
                         "stderr); use >=30 --blocks so the PS name has "
                         "time to decode")
    ap.add_argument("--sigmas", default="0,0.02,0.05,0.08,0.12,0.16,0.22,0.3",
                    help="comma-separated AWGN sigma sweep for --ber")
    ap.add_argument("--impair", choices=("none", "multipath", "tuner"),
                    default="none",
                    help="--ber channel: 'multipath' adds a 2-ray "
                         "time-varying (1 Hz doppler beat) echo channel on "
                         "top of each AWGN point; 'tuner' adds datasheet-"
                         "typical RTL-SDR analog artifacts (0.5 dB/2 deg "
                         "IQ imbalance, 3%+2% DC offset, 30 Hz-linewidth "
                         "phase noise, 400 Hz CFO)")
    ap.add_argument("--live", default=None, metavar="PATH",
                    help="live diagnostic view: poll the .npz snapshot a "
                         "running `cli --monitor PATH` decode refreshes and "
                         "re-render <out>/live.png on every update (the "
                         "reference's while-processing FuncAnimation PSD, "
                         "model/fmMonoAnim.py:42-66, headless-friendly)")
    ap.add_argument("--frames", type=int, default=0,
                    help="--live: stop after N rendered frames "
                         "(0 = until the snapshot stops updating)")
    ap.add_argument("--refresh", type=float, default=0.5,
                    help="--live: poll interval seconds")
    ap.add_argument("--live-timeout", type=float, default=8.0,
                    help="--live: exit after this many seconds without a "
                         "snapshot update")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from real_time_sdr_tpu.utils import compile_cache
    compile_cache.enable()
    import jax.numpy as jnp
    import numpy as np

    from real_time_sdr_tpu.config import mode_config
    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import viz

    cfg = mode_config(args.mode)
    if args.live:
        return _live_view(cfg, args)
    if args.ber:
        return _ber_curve(cfg, args)
    blk = 2 * cfg.block_size_iq
    if args.capture:
        iq = np.fromfile(args.capture, dtype=np.uint8)
        nb = min(args.blocks, len(iq) // blk)
        if nb == 0:
            print("capture shorter than one block", file=sys.stderr)
            return 1
        iq = iq[: nb * blk]
    else:
        from real_time_sdr_tpu.utils.synth import station_iq
        iq, _ = station_iq(cfg, args.blocks, ps_name="VIZ-DEMO")
        nb = args.blocks

    rx = Receiver(cfg, stereo=True, rds=True, pll_tier=1)
    state = rx.init_state()
    # the PSD panels/waterfall only need a prefix of the demod signal
    # (512-point Bartlett segments) — don't pay a second full frontend
    # pass over the whole capture on top of run_segment's
    nb_psd = min(nb, 8)
    demod, _ = rx.frontend(jnp.asarray(iq[: nb_psd * blk]), state.frontend)
    _, out = rx.jit_step(state, jnp.asarray(iq))
    demod = np.asarray(demod)
    left = np.asarray(out.left).ravel()
    right = np.asarray(out.right).ravel()
    clean = np.asarray(out.rds_clean).ravel()
    from real_time_sdr_tpu.ops.rds_bits import cdr_offset
    off = int(cdr_offset(jnp.asarray(clean[len(clean) // 2:]), cfg.sps))

    os.makedirs(args.out, exist_ok=True)
    p = lambda n: os.path.join(args.out, n)
    iq_f = (iq.astype(np.float32) - 128.0) / 128.0
    written = [
        viz.psd_figure(p("psd_stages.png"), [
            (iq_f[0::2][: 40 * 512], cfg.rf_fs, 0.7, "Raw I (uint8 in)"),
            (demod, cfg.if_fs, 1.0, "FM demod (IF)"),
            (left, float(cfg.audio_fs), 1.0, "Audio L"),
            (right, float(cfg.audio_fs), 1.0, "Audio R"),
        ]),
        viz.waterfall(p("waterfall.png"), demod, cfg.if_fs,
                      title="FM demod PSD over time"),
        viz.eye_diagram(p("rds_eye.png"), clean[len(clean) // 2 + off:],
                        cfg.sps),
        viz.constellation(p("rds_constellation.png"),
                          clean[len(clean) // 2:], cfg.sps, offset=off),
        viz.write_gnuplot_overlay(args.out, ["rds_clean"], title="rds_eye"),
    ]
    from real_time_sdr_tpu.utils.logging import log_vector
    log_vector("rds_clean", clean[: 4000], out_dir=args.out)

    if args.golden:
        from golden.chain import run_stages
        from real_time_sdr_tpu.utils.viz import psd_overlay_figure, snr_db
        # golden oracle over the same prefix the device PSDs use; the
        # device-side stages come from a block-by-block (nb==1) run so the
        # per-block resampler truncation matches the oracle exactly
        n_gold = nb_psd
        gold = run_stages(cfg, iq[: n_gold * blk])
        s_dev = rx.init_state()
        dev = {"left": [], "right": [], "rds_clean": []}
        for b in range(n_gold):
            s_dev, ob = rx.jit_step(
                s_dev, jnp.asarray(iq[b * blk:(b + 1) * blk]))
            dev["left"].append(np.asarray(ob.left).ravel())
            dev["right"].append(np.asarray(ob.right).ravel())
            dev["rds_clean"].append(np.asarray(ob.rds_clean).ravel())
        dev_left = np.concatenate(dev["left"])
        dev_right = np.concatenate(dev["right"])
        dev_clean = np.concatenate(dev["rds_clean"])
        panels = [
            (demod, gold["demod"], cfg.if_fs, 1.0, "FM demod (IF)"),
            (dev_left, gold["left"], float(cfg.audio_fs), 1.0, "Audio L"),
            (dev_right, gold["right"], float(cfg.audio_fs), 1.0, "Audio R"),
            (dev_clean, gold["rds_clean"], cfg.rds_fs, 1.0,
             "RDS RRC output"),
        ]
        written.append(
            psd_overlay_figure(p("psd_golden_overlay.png"), panels))
        for d, g, _, _, name in panels:
            print(f"golden SNR {name}: {snr_db(g, d):.1f} dB",
                  file=sys.stderr)

    if args.alt:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from real_time_sdr_tpu.models.rds_alt import AltRdsReceiver
        dec, diag = AltRdsReceiver(cfg).decode(iq)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ax1.plot(diag.freq_log, lw=0.9)
        ax1.set_xlabel("Bit index"); ax1.set_ylabel("Freq estimate (Hz)")
        ax1.set_title("Costas frequency track"); ax1.grid(alpha=0.4)
        d = diag.derotated[200:]
        ax2.scatter(d.real, d.imag, s=4, alpha=0.35, color="#aa0000")
        ax2.axhline(0, color="k", lw=0.5); ax2.axvline(0, color="k", lw=0.5)
        ax2.set_xlabel("Re"); ax2.set_ylabel("Im"); ax2.grid(alpha=0.4)
        ax2.set_title(f"Alt-path constellation "
                      f"(PS={dec.events.ps_name!r})")
        fig.tight_layout()
        fig.savefig(p("alt_rds.png"), dpi=110)
        plt.close(fig)
        written.append(p("alt_rds.png"))
        print(f"alt path: PS={dec.events.ps_name!r} "
              f"groups={dec.events.groups_decoded}", file=sys.stderr)

    for w in written:
        print(w)
    return 0


def _live_view(cfg, args) -> int:
    """Poll a `cli --monitor` snapshot and re-render live.png per update.

    The reference renders a FuncAnimation PSD while processing
    (model/fmMonoAnim.py:42-66); this is its headless twin: the decode
    process owns the device, the viewer owns matplotlib, and the .npz
    snapshot file (atomically replaced) is the only coupling — so the
    viewer can attach/detach freely and runs over ssh.
    """
    import time

    import numpy as np

    from real_time_sdr_tpu.utils import viz as V

    os.makedirs(args.out, exist_ok=True)
    out_png = os.path.join(args.out, "live.png")
    plt = V._mpl()

    rendered = 0
    last_mtime = None
    t_last = time.monotonic()
    while True:
        try:
            mtime = os.stat(args.live).st_mtime_ns
        except FileNotFoundError:
            mtime = None
        if mtime is not None and mtime != last_mtime:
            try:
                with np.load(args.live) as d:
                    snap = {k: d[k] for k in d.files}
            except Exception:
                # mid-replace on a non-atomic filesystem, or a stale
                # truncated snapshot: retry on the NORMAL poll cadence and
                # fall through to the --live-timeout check below (a
                # permanently unreadable file must not spin forever)
                snap = None
            if snap is None:
                if time.monotonic() - t_last > args.live_timeout:
                    print(f"snapshot unreadable/idle > "
                          f"{args.live_timeout:.0f}s; exiting "
                          f"({rendered} frames rendered)", file=sys.stderr)
                    return 0 if rendered else 1
                time.sleep(args.refresh)
                continue
            last_mtime = mtime
            t_last = time.monotonic()
            fig = plt.figure(figsize=(7.5, 5.4))
            ax = fig.add_subplot(2, 1, 1)
            audio = snap["audio"].astype(np.float64) / 32768.0
            V.plot_psd(ax, audio, float(snap["fs"]))
            ax.set_title(
                f"block {int(snap['block'])}  PI {int(snap['pi']):04x}  "
                f"PS '{str(snap['ps'])}'  groups {int(snap['groups'])}")
            ax.set_ylabel("audio PSD (dB)")
            clean = snap["clean"]
            ax2 = fig.add_subplot(2, 1, 2)
            if clean.size:
                sps = int(snap["sps"])
                n_tr = min(120, clean.size // (2 * sps) - 1)
                for k in range(max(n_tr, 0)):
                    ax2.plot(np.arange(2 * sps),
                             clean[k * 2 * sps:(k + 1) * 2 * sps],
                             color="#000088", alpha=0.12, lw=0.7)
                ax2.set_ylabel("RDS eye (RRC out)")
            else:
                ax2.text(0.5, 0.5, "no RDS branch", ha="center")
            ax2.set_xlabel(f"sample (2 symbols @ sps={int(snap['sps'])})")
            fig.tight_layout()
            tmp = out_png + ".tmp.png"
            fig.savefig(tmp, dpi=100)
            plt.close(fig)
            os.replace(tmp, out_png)
            rendered += 1
            print(f"frame {rendered}: block {int(snap['block'])} -> "
                  f"{out_png}", file=sys.stderr, flush=True)
            if args.frames and rendered >= args.frames:
                return 0
        if time.monotonic() - t_last > args.live_timeout:
            print(f"snapshot idle > {args.live_timeout:.0f}s; exiting "
                  f"({rendered} frames rendered)", file=sys.stderr)
            return 0 if rendered else 1
        time.sleep(args.refresh)


def _ber_curve(cfg, args) -> int:
    # the full operating-curve matrix lives in _viz_ber (timing x framer x
    # burst-correction span, optional time-varying multipath)
    from real_time_sdr_tpu._viz_ber import ber_curve
    return ber_curve(cfg, args)


if __name__ == "__main__":
    sys.exit(main())
