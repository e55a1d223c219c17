"""The --ber operating-curve sweep for python -m real_time_sdr_tpu.viz.

Full robustness matrix, not a single curve:

    AWGN sigma  x  CDR timing {comb, tracked}
                x  framer {matrix RdsFramer, SyncByOffsetDecoder}
                x  burst-correction span {0, 2, 5}
                (+ optional 2-ray time-varying multipath on every point)

Per (sigma, timing) the bit stream is decoded ONCE on device and the
six (framer, correct) decoders consume the same bits on the host, so the
matrix costs two device sweeps. Outputs: a table on stderr, a CSV, and
ber_curve.png (BER curves per timing on top; groups-decoded survival per
decoder config below).
"""

from __future__ import annotations

import os
import sys

__all__ = ["ber_curve"]


def ber_curve(cfg, args) -> int:
    import numpy as np
    import jax.numpy as jnp

    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.models.rds_framing import (RdsFramer,
                                                      SyncByOffsetDecoder)
    from real_time_sdr_tpu.utils.synth import impair_iq, station_iq

    nb = args.blocks
    sigmas = [float(s) for s in args.sigmas.split(",") if s.strip()]
    timings = ("comb", "tracked")
    rxs = {t: Receiver(cfg, stereo=True, rds=True, pll_tier=1,
                       rds_timing=t) for t in timings}
    # 2-ray echo channel whose rays rotate at 1/2 Hz (constructive ->
    # destructive beat WITHIN the capture: a time-varying channel, not a
    # static filter)
    multipath = [(2.0e-6, 0.45, 0.7), (5.3e-6, 0.30, 2.1)]
    decoders = [("matrix", RdsFramer), ("syncbyoff", SyncByOffsetDecoder)]
    spans = (0, 2, 5)

    rows = []
    for sigma in sigmas:
        iq, truth = station_iq(cfg, nb, ps_name="BER-SWP ", pi=0x7A7A,
                               pty=6,
                               noise_std=0.0 if args.impair != "none"
                               else sigma)
        if args.impair == "multipath":
            iq = impair_iq(iq, cfg.rf_fs, multipath=multipath,
                           doppler_hz=0.5, noise_std=sigma)
        elif args.impair == "tuner":
            # datasheet-typical RTL-SDR analog front end (R820T-class)
            iq = impair_iq(iq, cfg.rf_fs, iq_gain_db=0.5, iq_phase_deg=2.0,
                           dc_offset=0.03 + 0.02j,
                           phase_noise_linewidth_hz=30.0,
                           freq_offset_hz=400.0, noise_std=sigma)
        period = len(truth["bits"])
        for timing in timings:
            rx = rxs[timing]
            # same segment shape every sigma -> one compile per timing
            _, out = rx.jit_step(rx.init_state(), jnp.asarray(iq))
            nbits = np.asarray(out.rds_nbits)
            bits = np.asarray(out.rds_bits)
            # steady-state BER: skip acquisition/settle blocks so the curve
            # reflects channel noise, not the PLL transient
            settle = min(8, nb // 3)
            got = "".join(str(b) for k in range(settle, nb) if nbits[k] > 0
                          for b in bits[k][:nbits[k]])
            if got:
                # repeat the transmitted groups far enough that the
                # reference covers the decoded stream at EVERY search
                # offset (a short repetition would let zip() truncate
                # silently and deflate the BER)
                reps = (len(got) + 2 * period) // period + 2
                ref = "".join(map(str, truth["bits"] * reps))
                best = min(sum(a != b
                               for a, b in zip(got, ref[off:off + len(got)]))
                           for off in range(2 * period))
                ber = best / len(got)
            else:
                ber = float("nan")  # synchronizer never produced bits
            # the decoder matrix consumes the SAME bit stream on the host
            surv = {}
            for dname, dcls in decoders:
                for span in spans:
                    d = dcls(correct_bursts=span)
                    for k in range(nb):
                        if nbits[k] > 0:
                            d.feed(bits[k][:nbits[k]])
                    surv[(dname, span)] = (
                        d.events.groups_decoded,
                        d.events.ps_name == "BER-SWP ",
                        getattr(d.events, "blocks_corrected", 0))
            rows.append(dict(sigma=sigma, timing=timing, ber=ber,
                             bits=len(got), surv=surv))
            g22 = surv[("matrix", 2)]
            print(f"sigma={sigma:.2f} {timing:7s} BER={ber:.2e} "
                  f"bits={len(got)} matrix groups "
                  f"{surv[('matrix', 0)][0]}/{g22[0]}/"
                  f"{surv[('matrix', 5)][0]} (corr 0/2/5, "
                  f"{g22[2]} repaired) syncbyoff "
                  f"{surv[('syncbyoff', 0)][0]}/{surv[('syncbyoff', 2)][0]}/"
                  f"{surv[('syncbyoff', 5)][0]} PS={g22[1]}",
                  file=sys.stderr, flush=True)

    os.makedirs(args.out, exist_ok=True)
    csv_path = os.path.join(args.out, "ber_curve.csv")
    with open(csv_path, "w") as f:
        f.write("sigma,timing,impair,ber,bits,"
                + ",".join(f"{d}_c{s}_groups,{d}_c{s}_ps"
                           for d, _ in decoders for s in spans) + "\n")
        for r in rows:
            cells = [f"{r['sigma']}", r["timing"], args.impair,
                     f"{r['ber']:.6g}", f"{r['bits']}"]
            for d, _ in decoders:
                for s in spans:
                    g, ok, _c = r["surv"][(d, s)]
                    cells += [str(g), str(int(ok))]
            f.write(",".join(cells) + "\n")

    path = os.path.join(args.out, "ber_curve.png")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax, axg) = plt.subplots(2, 1, figsize=(7.5, 7.2), sharex=True,
                                  height_ratios=[3, 3])
    colors = {"comb": "#000088", "tracked": "#886600"}
    for timing in timings:
        sub = [r for r in rows if r["timing"] == timing
               and r["ber"] == r["ber"]]
        xs = [r["sigma"] for r in sub]
        ys = [max(r["ber"], 1e-5) for r in sub]
        ax.semilogy(xs, ys, "o-", color=colors[timing], label=timing)
        for r in sub:
            ok = r["surv"][("matrix", 2)][1]
            ax.annotate("PS" if ok else "x", (r["sigma"],
                                              max(r["ber"], 1e-5)),
                        textcoords="offset points", xytext=(0, 8),
                        ha="center",
                        color="#008800" if ok else "#aa0000", fontsize=8)
    for r in rows:
        if r["ber"] != r["ber"]:
            ax.axvline(r["sigma"], color="#aa0000", ls=":", alpha=0.4)
    ax.set_ylabel("post-differential BER")
    ax.set_title(f"RDS operating curve (mode {cfg.mode}, {nb} blocks, "
                 f"channel={args.impair}; PS = Program Service decoded)")
    ax.legend(fontsize=8)
    ax.grid(which="both", alpha=0.4)
    styles = {0: ":", 2: "-", 5: "--"}
    dcolors = {"matrix": "#008800", "syncbyoff": "#555555"}
    for dname, _ in decoders:
        for span in spans:
            sub = [r for r in rows if r["timing"] == "comb"]
            axg.plot([r["sigma"] for r in sub],
                     [r["surv"][(dname, span)][0] for r in sub],
                     styles[span], color=dcolors[dname], marker=".",
                     label=f"{dname} corr={span}")
    axg.set_xlabel("AWGN sigma on unit-amplitude IQ")
    axg.set_ylabel("groups decoded (comb timing)")
    axg.legend(fontsize=7, ncol=2)
    axg.grid(alpha=0.4)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(csv_path)
    print(path)
    return 0
