"""Decision-directed carrier recovery for BPSK: 2nd-order Costas loop.

Twin of the fine-frequency sync stage in the reference's alternative RDS
model (model/pySDRRDS.py:60-84): per sample, derotate by the estimated
phase, form the BPSK error Re(out)*Im(out), and advance a PI loop
(freq += beta*err; phase += freq + alpha*err).

The loop is a true per-sample recurrence, but it runs at the 1187.5 Hz
post-timing-recovery rate — a whole second of signal is ~1188 iterations,
so a ``lax.scan`` costs microseconds and there is nothing to vectorize
away. (Contrast the 19 kHz pilot PLL, where ops.pll/ops.sync replace the
scan with Newton / feedforward forms; at this rate the scan IS the right
device program.)

Gains: the reference uses (alpha=8.0, beta=0.002) on its capture, whose
baseband amplitude happens to be ~0.05 — the error Re*Im scales with
amplitude^2, so those constants are amplitude-calibrated. Here the input
is AGC-normalized to unit RMS first, making the defaults
(alpha=0.02, beta=1e-4) capture-independent.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["CostasCarry", "costas_init", "costas_scan", "coarse_freq_bpsk"]

_TWO_PI = 2.0 * jnp.pi


class CostasCarry(NamedTuple):
    phase: jax.Array  # f32 rad
    freq: jax.Array   # f32 rad/sample


def costas_init(batch: tuple = ()) -> CostasCarry:
    z = jnp.zeros(batch, jnp.float32)
    return CostasCarry(z, z)


def coarse_freq_bpsk(z: jax.Array, nfft: int = 4096) -> jax.Array:
    """Coarse carrier estimate for BPSK: squaring removes the modulation
    (z = s*e^{j*th}, s real => z^2 = |s|^2 * e^{2j*th}), leaving a tone at
    twice the residual carrier; one XLA FFT finds it. Returns f32 rad/sample.

    The 2nd-order Costas loop's pull-in range is only ~alpha*|err|
    rad/sample; seeding ``CostasCarry.freq`` with this estimate (accurate
    to half an FFT bin) extends acquisition to the full +-fs/4. The
    reference model has no coarse stage and relies on minutes of capture
    (model/pySDRRDS.py:60-84). ``z`` is 1-D (one channel); batch with
    jax.vmap."""
    assert z.ndim == 1, "coarse_freq_bpsk takes a 1-D stream; vmap to batch"
    n = z.shape[-1]
    sq = jnp.zeros((nfft,), jnp.complex64)
    sq = sq.at[: min(n, nfft)].set((z * z)[:nfft])
    spec = jnp.abs(jnp.fft.fft(sq))
    k = jnp.argmax(spec)
    # map bin to signed frequency, halve (tone sits at 2*df)
    f2 = jnp.where(k > nfft // 2, k - nfft, k).astype(jnp.float32) / nfft
    return jnp.float32(jnp.pi) * f2  # == 0.5 * 2*pi*f2


def costas_scan(z: jax.Array, carry: CostasCarry, alpha: float = 0.02,
                beta: float = 1e-4):
    """z: (..., N) complex64 at ~symbol rate, unit-RMS. Returns
    (derotated (..., N) complex64, freq_log (..., N) f32 rad/sample,
    new_carry)."""

    def step(c: CostasCarry, zk):
        rot = jnp.exp(-1j * c.phase.astype(jnp.complex64))
        out = zk * rot
        err = jnp.real(out) * jnp.imag(out)
        freq = c.freq + beta * err
        phase = jnp.mod(c.phase + freq + alpha * err, _TWO_PI)
        return CostasCarry(phase, freq), (out, freq)

    zs = jnp.moveaxis(z, -1, 0)
    new_carry, (out, freq_log) = jax.lax.scan(step, carry, zs)
    return (jnp.moveaxis(out, 0, -1), jnp.moveaxis(freq_log, 0, -1),
            new_carry)
