"""Fourier transforms: an accelerator-idiomatic implementation ladder.

The reference carries a pedagogical ladder of hand transforms — DFT O(N^2),
recursive FFT, precomputed-twiddle FFT, iterative bit-reversed FFT
(src/fourier.cpp:14-215) — asserted pairwise-equivalent by its unit tests
(test/fft_unittest.cpp:53-90). A faithful translation would be slow on an
accelerator (bit-reversal is a gather; scalar recursion doesn't trace), so
this module
rebuilds the ladder out of shapes the hardware likes:

- ``dft_matmul`` — the O(N^2) transform AS A MATMUL: at PSD size
  (N=512) the twiddle matrix is resident and the batch of segments rides
  one (S, 512) x (512, 512) pass per real/imag part. The "naive" algorithm
  is the FAST one when a matrix unit does the work and S is large.
- ``fft_stockham`` — radix-2 Stockham autosort FFT: log2(N) vectorized
  butterfly stages built from reshape/concat (NO bit-reversal permutation,
  no gathers — the autosort formulation reorders implicitly through the
  (l, m) shape walk, which XLA lowers to cheap layout ops).
- ``dft``/``fft`` — XLA's native FFT, the production default.
- ``dft_naive`` — the float64 host oracle the equivalence tests chain to.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dft", "idft", "fft", "magnitude", "dft_naive", "dft_matmul",
           "fft_stockham"]


def dft(x: jax.Array) -> jax.Array:
    """Forward DFT, reference sign convention (src/fourier.cpp:14-22)."""
    return jnp.fft.fft(x)


def idft(x: jax.Array) -> jax.Array:
    """Inverse DFT with 1/N normalization (src/fourier.cpp:96-105)."""
    return jnp.fft.ifft(x)


def fft(x: jax.Array) -> jax.Array:
    """Alias of dft — XLA's FFT is the optimized path; the reference's
    FFT_recursive/FFT_improved/FFT_optimized ladder (src/fourier.cpp:136-215)
    exists to be equivalent to its DFT, which these wrappers are by
    construction (asserted in tests the same way)."""
    return jnp.fft.fft(x)


def magnitude(spectrum: jax.Array) -> jax.Array:
    """|X_k| (``computeVectorMagnitude``, src/fourier.cpp:25-32)."""
    return jnp.abs(spectrum)


_TWIDDLE_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _twiddle_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(Re, Im) of the n-point DFT matrix, f32 (src/fourier.cpp:129-134
    precomputes the same values as a vector; for a matmul the natural
    layout is the full matrix)."""
    if n not in _TWIDDLE_CACHE:
        k = np.arange(n)
        ang = -2.0 * np.pi * np.outer(k, k) / n
        _TWIDDLE_CACHE[n] = (np.cos(ang).astype(np.float32),
                             np.sin(ang).astype(np.float32))
    return _TWIDDLE_CACHE[n]


def dft_matmul(x: jax.Array) -> jax.Array:
    """O(N^2) DFT as matmuls over the last axis; real or complex input.

    The reference's ``DFT`` (src/fourier.cpp:14-22) re-shaped for the
    hardware: a batch of S segments is two/four (S, N) x (N, N) matmuls.
    For the Bartlett PSD's N=512 this is the matmul path — the twiddle
    matrix stays resident across the whole batch."""
    wr, wi = _twiddle_mats(x.shape[-1])
    wr = jnp.asarray(wr)
    wi = jnp.asarray(wi)
    hi = jax.lax.Precision.HIGHEST
    if jnp.iscomplexobj(x):
        xr, xi = jnp.real(x), jnp.imag(x)
        re = (jnp.matmul(xr, wr, precision=hi)
              - jnp.matmul(xi, wi, precision=hi))
        im = (jnp.matmul(xr, wi, precision=hi)
              + jnp.matmul(xi, wr, precision=hi))
    else:
        xr = x.astype(jnp.float32)
        re = jnp.matmul(xr, wr, precision=hi)
        im = jnp.matmul(xr, wi, precision=hi)
    return jax.lax.complex(re, im)


def fft_stockham(x: jax.Array) -> jax.Array:
    """Radix-2 Stockham autosort FFT over the last axis (power-of-2 N).

    The vectorized twin of the reference's iterative ``FFT_optimized``
    (src/fourier.cpp:193-215): that version needs a bit-reversal
    permutation (``bit_reversal``, src/fourier.cpp:107-127) — a gather,
    slow on accelerator layouts. Stockham's (l, m) shape walk performs the
    reordering implicitly: every stage is a split + twiddle-multiply +
    concat, all vectorized, log2(N) stages unrolled at trace time."""
    n = x.shape[-1]
    assert n and (n & (n - 1)) == 0, f"power-of-2 length required, got {n}"
    X = x.astype(jnp.complex64)[..., None]     # (..., l=n, m=1)
    l = n
    while l > 1:
        hl = l // 2
        a = X[..., :hl, :]
        b = X[..., hl:, :]
        # DIF butterfly: even half-spectrum a+b; odd (a-b) spun by w_l^j
        ang = -2.0 * math.pi * np.arange(hl, dtype=np.float64) / l
        tw = jnp.asarray(np.exp(1j * ang).astype(np.complex64))[:, None]
        X = jnp.concatenate([a + b, (a - b) * tw], axis=-1)  # (..., hl, 2m)
        l = hl
    return X[..., 0, :]


def dft_naive(x: np.ndarray) -> np.ndarray:
    """Host-side O(N^2) direct DFT — the independent oracle the
    equivalence tests compare against (twin of src/fourier.cpp:14-22)."""
    x = np.asarray(x, dtype=np.complex128)
    n = len(x)
    k = np.arange(n)
    twiddle = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return twiddle @ x
