"""Spectral observability: Bartlett-averaged PSD estimate.

Twin of the reference's ``estimatePSD`` (src/fourier.cpp:36-92,
model/fmSupportLib.py:214-289): split the block into NFFT/2-advance... the
reference uses non-overlapping segments of length NFFT, Hann-windowed
(sin^2), magnitude-squared DFT averaged across segments, scaled and
converted to dB. Used for debugging/visualization, not the audio path —
so we use jnp.fft rather than re-deriving a hand FFT (the reference's
DFT/FFT_* ladder is pedagogical; XLA's FFT is the production kernel).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

NFFT = 512  # reference: include/dy4.h:18


def estimate_psd(samples: jax.Array, fs: float, nfft: int = NFFT,
                 method: str = "matmul"):
    """Returns (freqs (nfft/2,), psd_db (nfft/2,)).

    Matches model/fmSupportLib.py:214-289: segments of length nfft, Hann
    window, per-segment |X_k|^2 * (1/(Fs*nfft/2)) * 2, first half of bins,
    averaged, 10*log10.

    method selects the transform from the ops.fourier ladder: "matmul"
    (default — the O(N^2) DFT as resident-twiddle matmuls over the whole
    segment batch), "fft" (XLA), or "stockham" (the vectorized radix-2
    autosort).
    """
    from real_time_sdr_tpu.ops import fourier
    n = samples.shape[-1]
    n_seg = n // nfft
    segs = samples[..., : n_seg * nfft].reshape(
        samples.shape[:-1] + (n_seg, nfft))
    i = np.arange(nfft)
    window = np.sin(i * np.pi / nfft) ** 2  # Hann via sin^2
    windowed = segs * jnp.asarray(window, samples.dtype)
    if method == "matmul":
        spec = fourier.dft_matmul(windowed)
    elif method == "stockham":
        spec = fourier.fft_stockham(windowed)
    else:
        spec = jnp.fft.fft(windowed, axis=-1)
    half = spec[..., : nfft // 2]
    psd = (jnp.abs(half) ** 2) * (2.0 / (fs * nfft / 2.0))
    # the reference averages the PER-SEGMENT dB VALUES, not linear power
    # (model/fmSupportLib.py:270-289 AND src/fourier.cpp:77-91 both
    # convert each segment to dB first) — mean-of-logs sits ~2.5 dB below
    # log-of-mean on noise bins, a divergence the round-5 cross-oracle
    # caught (tests/test_reference_oracle.py::test_estimate_psd...); this
    # framework had shipped linear averaging with a golden twin that
    # repeated the same deviation.
    psd_db_seg = 10.0 * jnp.log10(jnp.maximum(psd, 1e-30))
    psd_db = jnp.mean(psd_db_seg, axis=-2)
    freqs = np.arange(nfft // 2) * fs / nfft
    return freqs, psd_db


def freq_response(h: np.ndarray, fs: float, n: int = 4096):
    """|H(f)| on a dense grid — the freqzPlot twin
    (model/fmSupportLib.py:185-208)."""
    resp = np.abs(np.fft.rfft(np.asarray(h), n))
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    return freqs, resp
