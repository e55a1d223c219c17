"""Alternative RDS architecture: non-coherent complex baseband + M&M + Costas.

Twin of the reference's second, independent RDS receiver
(model/pySDRRDS.py) — the "PySDR" architecture, which shares *nothing* with
the production chain (models/rds.py): instead of a coherent squared-pilot
PLL at the 19 kHz-centred IF, it

1. frequency-shifts the FM discriminator output by -57 kHz into a COMPLEX
   baseband (pySDRRDS.py:18-23),
2. low-pass filters and resamples to 19 kHz = 16 samples/bit
   (pySDRRDS.py:25-34) — one polyphase stage here (19/if_fs rational,
   one matmul via ops.fir.PolyFIR) instead of the reference's
   convolve + ::10 + resample_poly(19, 25) ladder,
3. recovers bit timing with a Mueller–Muller loop
   (ops.symbol_timing.mm_timing; pySDRRDS.py:36-55),
4. removes the residual carrier with a decision-directed Costas loop
   (ops.costas.costas_scan; pySDRRDS.py:60-84),
5. slices Re > 0 and differentially decodes (pySDRRDS.py:88-90), then
6. frames with the sync-by-offset decoder (models/rds_framing.
   SyncByOffsetDecoder — the same Annex-C state machine pySDRRDS.py:96+
   ports from GNU Radio).

Because the carrier is never phase-locked (only frequency-locked, with a
180-degree ambiguity), the differential code is what makes the bits
polarity-immune — same reason the reference gives at pySDRRDS.py:89.

This is an offline/diagnostic receiver, like the reference model it twins:
``decode(iq_u8)`` takes a whole capture. The production streaming path
remains models/rds.py.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.config import ReceiverConfig, mode_config
from real_time_sdr_tpu.models.frontend import Frontend
from real_time_sdr_tpu.models.rds_framing import SyncByOffsetDecoder
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops.costas import (CostasCarry, coarse_freq_bpsk,
                                          costas_scan)
from real_time_sdr_tpu.ops.fir import PolyFIR, init_state
from real_time_sdr_tpu.ops.symbol_timing import comb_acquire, mm_timing

__all__ = ["AltRdsReceiver", "AltRdsDiag"]

RDS_CARRIER = 57_000.0
BIT_RATE = 1187.5
BB_FS = 19_000          # 16 samples per 1187.5 Hz bit (pySDRRDS.py:33-38)
SPS = 16


class AltRdsDiag(NamedTuple):
    """Diagnostics mirroring what the reference model plots."""
    baseband: np.ndarray   # complex64 at 19 kHz (post-LPF)
    symbols: np.ndarray    # complex64 at 1187.5 Hz (post-M&M, pre-Costas)
    derotated: np.ndarray  # complex64 post-Costas (constellation)
    freq_log: np.ndarray   # Costas frequency estimate, Hz
    bits: np.ndarray       # differential-decoded bits


class AltRdsReceiver:
    """One-shot capture decoder via the pySDRRDS architecture."""

    def __init__(self, cfg: ReceiverConfig | int = 0, *,
                 mm_gain: float = 0.01, costas_alpha: float = 0.02,
                 costas_beta: float = 1e-4):
        if isinstance(cfg, int):
            cfg = mode_config(cfg)
        self.cfg = cfg
        self.frontend = Frontend(cfg)
        r = Fraction(BB_FS, cfg.if_fs)
        self.up, self.down = r.numerator, r.denominator
        # anti-alias LPF for the 19 kHz output band, designed at the
        # upsampled rate with gain=up (polyphase convention, models/rds.py);
        # 7.5 kHz cutoff == firwin(101, 7.5e3) at pySDRRDS.py:26
        self.bb_fir = PolyFIR(
            filters.design_lpf(cfg.if_fs * self.up, 7_500.0,
                               cfg.rf_taps * self.up, gain=self.up),
            up=self.up, down=self.down)
        self.mm_gain = mm_gain
        self.costas_alpha = costas_alpha
        self.costas_beta = costas_beta
        self._jit = jax.jit(self._device_chain)

    # -- device half -------------------------------------------------------

    def _device_chain(self, demod: jax.Array):
        cfg = self.cfg
        n = demod.shape[-1]
        # complex mix: x * exp(-j 2 pi 57k t) (pySDRRDS.py:18-23). The
        # mixer phase is generated EXACTLY via the rational ratio
        # 57000/if_fs = num/den (den <= 128 for all modes): float32
        # absolute phase (2*pi*57000*t) has ~0.25 rad ulp already at
        # t = 10 s and is pure noise beyond a minute — precisely the
        # capture lengths this offline model advertises. Integer
        # (num*k) mod den never leaves [0, den), so cos/sin stay exact
        # for any capture length (same trick as ops.pll.trig_angle).
        # LPF+resample then runs as ONE polyphase matmul on the stacked
        # (re, im) pair — one frame matrix serves both rails.
        import math
        g = math.gcd(int(RDS_CARRIER), cfg.if_fs)
        num, den = int(RDS_CARRIER) // g, cfg.if_fs // g
        k = jnp.arange(n, dtype=jnp.int32) % den  # exact below 2^31 samples
        frac = (num * k) % den
        ang = jnp.float32(-2.0 * np.pi / den) * frac.astype(jnp.float32)
        mixed = jnp.stack([demod * jnp.cos(ang), demod * jnp.sin(ang)])
        tail = init_state(self.bb_fir.num_taps, self.bb_fir.up, batch=(2,))
        bb_ri, _ = self.bb_fir(mixed, tail)
        bb = jax.lax.complex(bb_ri[0], bb_ri[1])
        # AGC to unit RMS so the M&M rails and Costas gains are
        # capture-amplitude independent (see ops/costas.py docstring)
        rms = jnp.sqrt(jnp.mean(jnp.abs(bb) ** 2) + 1e-12)
        bb = (bb / rms.astype(jnp.complex64))
        mu0 = comb_acquire(bb, SPS)
        syms, n_valid = mm_timing(bb, float(SPS), gain=self.mm_gain,
                                  mu0=mu0)
        # mm_timing's buffer is zero beyond n_valid already; the mask is
        # only needed for the differential bits below
        mask = jnp.arange(syms.shape[-1]) < n_valid
        # coarse acquisition (FFT of squared symbols) seeds the loop's
        # frequency state; Costas then tracks fine phase/frequency
        f0 = coarse_freq_bpsk(syms)
        derot, freq_log, _ = costas_scan(
            syms, CostasCarry(jnp.float32(0.0), f0),
            alpha=self.costas_alpha, beta=self.costas_beta)
        hard = (jnp.real(derot) > 0).astype(jnp.int32)
        bits = jnp.where(mask[1:], (hard[..., 1:] - hard[..., :-1]) % 2, 0)
        return bb, syms, derot, freq_log, bits, n_valid

    # -- host driver -------------------------------------------------------

    def decode(self, iq_u8: np.ndarray):
        """iq_u8: raw interleaved uint8 capture (whole-block multiple).

        Returns (SyncByOffsetDecoder with events populated, AltRdsDiag)."""
        blk = 2 * self.cfg.block_size_iq
        n_blocks = len(iq_u8) // blk
        iq = jnp.asarray(np.asarray(iq_u8[: n_blocks * blk], np.uint8))
        demod, _ = self.frontend(iq, self.frontend.init_state())
        bb, syms, derot, freq_log, bits, n_valid = self._jit(demod)
        nv = int(n_valid)
        bits_np = np.asarray(bits)[: max(0, nv - 1)]
        dec = SyncByOffsetDecoder()
        dec.feed(bits_np)
        diag = AltRdsDiag(
            baseband=np.asarray(bb),
            symbols=np.asarray(syms)[:nv],
            derotated=np.asarray(derot)[:nv],
            freq_log=np.asarray(freq_log)[:nv] * (BIT_RATE / (2 * np.pi)),
            bits=bits_np)
        return dec, diag
