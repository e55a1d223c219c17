"""Spectral / signal visualization: headless twins of the reference's
debugging figures.

The reference debugs channels three ways: ``fmPlotPSD`` axis formatting
(model/fmSupportLib.py:292-320), the per-block PSD animation
(model/fmMonoAnim.py), and gnuplot overlays of ``logVector`` dumps
(data/example.gnuplot:14-22 — RDS eye/impulse traces). All three assume an
interactive display; an accelerator host is headless, so every figure
here renders straight to PNG (matplotlib Agg) and the PSD math runs through
our own device op (ops.spectrum.estimate_psd, the Bartlett twin) instead of
``ax.psd``. ``python -m real_time_sdr_tpu.viz`` drives a whole capture
through the receiver and emits the full diagnostic sheet in one command.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "plot_psd", "psd_figure", "psd_overlay_figure", "waterfall",
    "eye_diagram", "constellation", "write_gnuplot_overlay",
]


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _psd(samples: np.ndarray, fs: float, nfft: int = 512):
    from real_time_sdr_tpu.ops.spectrum import estimate_psd
    f, p = estimate_psd(np.asarray(samples, np.float32), fs, nfft)
    return np.asarray(f), np.asarray(p)


def plot_psd(ax, samples, fs: float, height: float = 1.0,
             title: str = "") -> None:
    """fmPlotPSD twin (model/fmSupportLib.py:292-320): same grid recipe —
    Fs/12 x-major, 20 dB y-major, 100*height dB span below +10 dB — but the
    estimate is our Bartlett device op rather than ``ax.psd``."""
    freqs, psd_db = _psd(samples, fs)
    ax.plot(freqs / 1e3, psd_db, lw=0.8)
    x_max, y_max = 1e-3 + fs / 2e3, 10.0
    y_min = y_max - 100.0 * height
    ax.set_xlim([0, x_max])
    ax.set_ylim([y_min, y_max])
    ax.set_xticks(np.arange(0, x_max, fs / 12e3))
    ax.set_xticks(np.arange(0, x_max, fs / 48e3), minor=True)
    ax.set_yticks(np.arange(y_min, y_max, 20.0))
    ax.grid(which="major", alpha=0.75)
    ax.grid(which="minor", alpha=0.25)
    ax.set_xlabel("Frequency (kHz)")
    ax.set_ylabel("PSD (dB/Hz)")
    ax.set_title(title)


def psd_figure(path: str, panels) -> str:
    """Stacked PSD panels, one per pipeline stage — the fmMonoBlock in-lab
    figure. panels: iterable of (samples, fs, height, title)."""
    plt = _mpl()
    panels = list(panels)
    fig, axes = plt.subplots(len(panels), 1,
                             figsize=(9, 2.6 * len(panels)))
    if len(panels) == 1:
        axes = [axes]
    for ax, (samples, fs, height, title) in zip(axes, panels):
        plot_psd(ax, samples, fs, height, title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def snr_db(ref, got) -> float:
    """SNR of ``got`` against oracle ``ref`` over the common prefix (dB)."""
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    n = min(len(ref), len(got))
    ref, got = ref[:n], got[:n]
    e = np.mean((ref - got) ** 2)
    return float("inf") if e == 0 else float(
        10 * np.log10(np.mean(ref ** 2) / max(e, 1e-300)))


def psd_overlay_figure(path: str, panels) -> str:
    """Device-vs-golden PSD overlay, one panel per stage, SNR in the title.

    panels: iterable of (device_samples, golden_samples, fs, height, title).
    The regression-triage figure: a stage whose device curve departs from
    the float64 oracle curve is the stage that broke."""
    plt = _mpl()
    panels = list(panels)
    fig, axes = plt.subplots(len(panels), 1,
                             figsize=(9, 2.6 * len(panels)))
    if len(panels) == 1:
        axes = [axes]
    for ax, (dev, gold, fs, height, title) in zip(axes, panels):
        f_g, p_g = _psd(gold, fs)
        f_d, p_d = _psd(dev, fs)
        ax.plot(f_g / 1e3, p_g, lw=1.6, color="#aa0000", alpha=0.7,
                label="golden (f64)")
        ax.plot(f_d / 1e3, p_d, lw=0.8, color="#000088", label="device")
        x_max, y_max = 1e-3 + fs / 2e3, 10.0
        y_min = y_max - 100.0 * height
        ax.set_xlim([0, x_max])
        ax.set_ylim([y_min, y_max])
        ax.set_xticks(np.arange(0, x_max, fs / 12e3))
        ax.set_yticks(np.arange(y_min, y_max, 20.0))
        ax.grid(which="major", alpha=0.75)
        ax.legend(loc="upper right", fontsize=8)
        ax.set_xlabel("Frequency (kHz)")
        ax.set_ylabel("PSD (dB/Hz)")
        ax.set_title(f"{title} — SNR {snr_db(gold, dev):.1f} dB")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def waterfall(path: str, samples, fs: float, n_rows: int = 64,
              nfft: int = 512, title: str = "PSD over time") -> str:
    """fmMonoAnim headless twin: the animation's successive PSD frames
    stacked into one waterfall image (time down, frequency across)."""
    plt = _mpl()
    samples = np.asarray(samples, np.float32).ravel()
    if len(samples) < nfft:  # too short for even one PSD row: pad one segment
        samples = np.pad(samples, (0, nfft - len(samples)))
    seg = max(nfft, len(samples) // n_rows // nfft * nfft)
    rows = []
    for r in range(min(n_rows, len(samples) // seg)):
        _, p = _psd(samples[r * seg:(r + 1) * seg], fs, nfft)
        rows.append(p)
    img = np.stack(rows)
    fig, ax = plt.subplots(figsize=(9, 5))
    extent = [0, fs / 2e3, len(rows) * seg / fs, 0]
    im = ax.imshow(img, aspect="auto", extent=extent, cmap="viridis",
                   vmin=np.percentile(img, 5), vmax=np.percentile(img, 99.5))
    fig.colorbar(im, ax=ax, label="PSD (dB/Hz)")
    ax.set_xlabel("Frequency (kHz)")
    ax.set_ylabel("Time (s)")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def eye_diagram(path: str, clean, sps: int, n_traces: int = 200,
                title: str = "RDS eye (RRC output)") -> str:
    """Two-symbol-period trace overlay of the RRC output — the PNG version
    of the reference's gnuplot rds_clean/rds_check overlay
    (data/example.gnuplot:14-22)."""
    plt = _mpl()
    clean = np.asarray(clean, np.float32).ravel()
    span = 2 * sps
    n = min(n_traces, len(clean) // span - 1)
    fig, ax = plt.subplots(figsize=(7, 4))
    t = np.arange(span) / sps
    for k in range(n):
        ax.plot(t, clean[k * span:(k + 1) * span], color="#000088",
                alpha=0.12, lw=0.8)
    ax.grid(alpha=0.4)
    ax.set_xlabel("Symbol periods")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def constellation(path: str, clean, sps: int, offset: int = 0,
                  title: str = "RDS symbol constellation") -> str:
    """Sampled-symbol scatter: consecutive symbol samples as (x, y) pairs.
    Four tight clusters at (+/-A, +/-A) == healthy BPSK timing; smearing
    toward the origin == ISI or a timing/carrier problem. The diagnostic the
    reference's pySDRRDS model plots after its Costas loop
    (model/pySDRRDS.py, constellation scatter)."""
    plt = _mpl()
    clean = np.asarray(clean, np.float32).ravel()
    sym = clean[offset::sps]
    sym = sym[: (len(sym) // 2) * 2]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(sym[0::2], sym[1::2], s=4, alpha=0.35, color="#aa0000")
    lim = 1.1 * max(1e-6, np.percentile(np.abs(sym), 99))
    ax.set_xlim([-lim, lim]); ax.set_ylim([-lim, lim])
    ax.axhline(0, color="k", lw=0.5); ax.axvline(0, color="k", lw=0.5)
    ax.grid(alpha=0.4)
    ax.set_xlabel("Symbol 2k"); ax.set_ylabel("Symbol 2k+1")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def write_gnuplot_overlay(out_dir: str, names, title: str = "overlay",
                          xrange: int = 1000) -> str:
    """Emit a ready-to-run gnuplot script over log_vector .dat dumps — the
    data/example.gnuplot workflow for users who prefer gnuplot to PNGs."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{title}.gnuplot")
    colors = ["#000088", "#aa0000", "#008800", "#888800"]
    plots = ", \\\n".join(
        f"'{n}.dat' using 1:2 with lines lt 1 lw 2 lc rgb "
        f"'{colors[i % 4]}' title '{n}'" for i, n in enumerate(names))
    with open(path, "w") as f:
        f.write("reset\nset grid xtics ytics\n"
                "set grid lt 1 lc rgb '#cccccc' lw 1\n"
                f"set xlabel 'Sample #'\nset ylabel 'Sample value'\n"
                f"set xrange [0:{xrange}]\n"
                f"plot {plots}\n")
    return path
