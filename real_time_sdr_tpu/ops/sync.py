"""Tier-3 carrier synchronizer: feedforward analytic-phase estimation.

The reference regenerates the 38/57 kHz carriers with a per-sample PLL
(src/pll.cpp) — an inherently sequential recurrence. Tiers 1/2 (ops.pll)
reproduce that loop exactly / via block-parallel Newton. This module is the
fully vectorized alternative: *no recurrence at all*.

    pilot -> [ONE complex FIR: Hilbert pair (*) ramp-modulated smoother]
          -> rotate by the exact nominal carrier ramp (integer-wrapped,
             static table — modulation commutes with LTI filtering, so the
             rotate-then-smooth chain collapses into the filter design)
          -> residual phase = atan2(Im, Re); unwrap = one matmul prefix sum
          -> carrier = cos(scale * (nominal ramp + residual) + adjust)

Everything is one shared-frame FIR matmul plus a handful of full-block
vectorized ops, so cost is independent of any loop bandwidth and the graph
depth is O(1) — this is what lets a whole multi-block segment's carrier
recovery run as a few device kernels.

Semantics: approximates the locked PLL (validated e2e: stereo separation and
RDS BER); it does not reproduce the reference's acquisition transient.
The phase estimate at FIR output k describes input sample k-D (group delay
D); consumers get cos at the (k-1) convention of the reference by advancing
the residual linearly by its measured per-block slope — exact for the
nominal ramp, first-order for the residual.
"""

from __future__ import annotations

import math

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.ops.fir import FIRBank, PolyFIR
from real_time_sdr_tpu.ops.pll import PllParams
from real_time_sdr_tpu.ops.prefix import prefix_sum

__all__ = ["FeedforwardSync", "FFSyncCarry"]

import os as _os

_TWO_PI = 2.0 * math.pi
_FOUR_PI = 4.0 * math.pi


def _hilbert_taps(taps: int) -> np.ndarray:
    """Type-III FIR Hilbert transformer, Hann-windowed (odd length)."""
    assert taps % 2 == 1
    m = (taps - 1) // 2
    k = np.arange(taps) - m
    h = np.zeros(taps)
    odd = (k % 2) != 0
    h[odd] = 2.0 / (np.pi * k[odd])
    i = np.arange(taps, dtype=np.float64)
    w = np.sin(i * np.pi / taps) ** 2
    return h * w


class FFSyncCarry(NamedTuple):
    in_tail: jax.Array      # input tail of the ONE combined complex FIR
                            # (Hilbert pair and smoother collapsed — see
                            # FeedforwardSync.__init__)
    trig: jax.Array         # int32 global sample counter mod period
    resid: jax.Array        # unwrapped residual phase at the last sample


def _wrap_pi(x):
    return x - _TWO_PI * jnp.round(x / _TWO_PI)


class FeedforwardSync:
    """Drop-in carrier synchronizer with the (pilot, carry, params) call
    signature of ops.pll.pll_scan."""

    def __init__(self, p: PllParams, hilbert_taps: int = 63,
                 smooth_taps: int = 65, derive2: bool | None = None):
        self.p = p
        # stereo double-angle carrier: derive cos/sin(2*ramp) from (ce, se)
        # by register algebra vs the exact rolled tables. Pays where the
        # graph is bound by table memory traffic and costs where it is bound
        # by elementwise work — the caller picks per mode;
        # RTSDR_SYNC_TBL2=1/0 force-overrides.
        env = _os.environ.get("RTSDR_SYNC_TBL2")
        self.derive2 = (env != "1") if env is not None else bool(derive2)
        h_h = _hilbert_taps(hilbert_taps)
        m = (hilbert_taps - 1) // 2
        delay = np.zeros(hilbert_taps)
        delay[m] = 1.0
        # Smoothing: normalized Hann — plays the loop filter's noise-
        # averaging role (equivalent noise bandwidth ~ fs/smooth_taps).
        i = np.arange(smooth_taps, dtype=np.float64)
        w = np.sin(i * np.pi / smooth_taps) ** 2
        w = w / w.sum()
        # COLLAPSE the chain [analytic FIR pair] -> [rotate by the nominal
        # ramp] -> [smooth both rails] into ONE complex FIR + a rotation
        # AFTER: for the exact integer ramp theta_k = w0*(trig+k-m),
        #     sum_m w[m] e^{-j theta_{k-m}} z_{k-m}
        #   = e^{-j theta_k} * (z * w~)_k,   w~[m] = w[m] e^{+j w0 m},
        # and z = (delta_m + j h_hilbert) * x, so the whole front half is
        #     s_k = e^{-j theta_k} * (x * c)_k,  c = (delta + j h) * w~.
        # One shared-frame FIR bank (Re c, Im c — one matmul) replaces
        # three FIR dispatches and two smoother tails; the rotation fuses
        # into the atan2 block. Exact in exact arithmetic; f32-level
        # equivalent in practice (e2e SNR/BER gates unchanged).
        w0 = 2.0 * np.pi * p.freq / p.fs
        wm = w * np.exp(1j * w0 * np.arange(smooth_taps))
        c = np.convolve(delay + 1j * h_h, wm)   # complex, 127 taps
        self.cr_fir = PolyFIR(c.real)
        self.ci_fir = PolyFIR(c.imag)
        self._bank = FIRBank([self.cr_fir, self.ci_fir])
        # Group delay: the analytic estimate at FIR output k describes
        # input sample k-m (Hilbert pair); the smoother adds
        # (smooth_taps-1)/2 more delay, but only to the slowly-rotating
        # RESIDUAL (the nominal ramp is removed by the rotation) — so the
        # ramp rotation uses m alone and the residual-slope compensation
        # uses the total.
        self.hilbert_delay = m
        self.group_delay = m + (smooth_taps - 1) // 2
        # rolled-table mechanism: "rot" (default) rotates STATIC tiled
        # tables by one per-channel scalar phase — under vmap the
        # dynamic_slice roll becomes a gather that XLA lowers to a WHILE
        # LOOP per table (~7 loops x ~25 us/run at mode-0 32x12, the
        # largest remaining non-FIR cost); the ramp is linear in integer
        # phase, so tbl[(start+j)%per] == rot(theta_start) applied to
        # tbl[j] exactly (same identity as derive2). "slice" restores the
        # dynamic_slice roll (bit-identical table values).
        self._roll_mode = _os.environ.get("RTSDR_SYNC_ROLL", "rot")
        self._tiled_cache: dict[int, tuple] = {}

    def _tiled_tables(self, p, n: int):
        """Static length-n cos/sin/angle tables of the nominal ramp from
        index 0 (host-precomputed constants, one set per (params, segment
        length) — the params override of __call__ is honored)."""
        key = (p._ratio, n)
        hit = self._tiled_cache.get(key)
        if hit is None:
            # pure numpy (this may run inside a jit trace — omnistaging
            # would stage jnp ops even on concrete inputs): replicate
            # trig_angle's exact integer-phase arithmetic host-side
            fr, fsr = p._ratio
            k = np.arange(p.period, dtype=np.int64)
            frac = (fr * k) % (2 * fsr)
            ang = ((2.0 * np.pi / fsr)
                   * frac.astype(np.float32)).astype(np.float64)
            reps = -(-n // p.period)
            a = np.tile(ang, reps)[:n]
            # cache NUMPY (this can run inside a trace; caching the jnp
            # constants would leak tracers across traces)
            hit = (np.cos(a).astype(np.float32),
                   np.sin(a).astype(np.float32),
                   a.astype(np.float32))
            self._tiled_cache[key] = hit
        return tuple(jnp.asarray(t) for t in hit)

    def _ramp_cos_sin(self, p, start: jax.Array, n: int):
        """cos/sin of the nominal ramp at positions start..start+n-1.

        "rot" mode: ONE scalar rotation of the static tables —
        cos(th_s + th_j) expanded by the angle-sum identity, exact in
        integer phase, ~1e-6 max f32 rounding vs the exact per-phase
        values (measured at the stereo period; the derive2 error class).
        "slice" mode: the bit-exact dynamic_slice roll (gather/while
        under vmap)."""
        if self._roll_mode == "slice":
            angle_tbl = p.trig_angle(jnp.arange(p.period, dtype=jnp.int32))
            return (self._rolled_table(jnp.cos(angle_tbl), start, n),
                    self._rolled_table(jnp.sin(angle_tbl), start, n))
        ct, st_, _ = self._tiled_tables(p, n)
        th = p.trig_angle(start % p.period)
        cs, sn = jnp.cos(th)[..., None], jnp.sin(th)[..., None]
        return cs * ct - sn * st_, sn * ct + cs * st_

    def _ramp_angle(self, p, start: jax.Array, n: int):
        """Canonical wrapped ramp ANGLE at start..start+n-1 (the RDS
        general path's phase accumulator input). trig_angle lives in
        [0, 4*pi) — the nco_scale=0.5 half-angle consumer's parity range
        — so "rot" adds the scalar phase and subtracts 4*pi on overflow:
        both addends are canonical, so the sum reproduces the canonical
        branch exactly (no 4*pi-sized jumps vs the exact table, only
        ~1e-7 addition rounding — far from a parity flip)."""
        if self._roll_mode == "slice":
            angle_tbl = p.trig_angle(jnp.arange(p.period, dtype=jnp.int32))
            return self._rolled_table(angle_tbl, start, n)
        _, _, at = self._tiled_tables(p, n)
        th = p.trig_angle(start % p.period)[..., None]
        s = th + at
        return s - jnp.where(s >= _FOUR_PI, _FOUR_PI, 0.0)

    def init(self, batch: tuple = ()) -> FFSyncCarry:
        t = lambda n: jnp.zeros(batch + (n,), jnp.float32)
        return FFSyncCarry(
            in_tail=t(self.cr_fir.tail_len),
            trig=jnp.zeros(batch, jnp.int32),
            resid=jnp.zeros(batch, jnp.float32))

    @staticmethod
    def _rolled_table(table: jax.Array, start: jax.Array, n: int):
        """table[(start + j) % period] for j in [0, n) — the nominal carrier
        ramp is integer-periodic (period = 2*fs/gcd, <= ~720), so per-sample
        trig/angle sequences are a PERIOD-sized static table cycled from a
        carried phase: one dynamic_slice of a doubled table + tile + slice,
        all fusible — no length-n transcendental evaluation. Values are
        bit-identical to evaluating at every sample (the table holds the
        exact f32 per-phase values). NB a one-hot-dot-against-circulant
        variant (to avoid the batched dynamic_slice's gather lowering)
        measured 3x SLOWER overall — the circulant did not const-fold;
        the ~30 us/run gather is the cheaper evil."""
        per = table.shape[-1]
        doubled = jnp.concatenate([table, table], axis=-1)
        rolled = jax.lax.dynamic_slice_in_dim(
            doubled, start % per, per, axis=-1)
        reps = -(-n // per)
        return jnp.tile(rolled, reps)[..., :n]

    def __call__(self, x: jax.Array, carry: FFSyncCarry, p: PllParams = None):
        p = p or self.p
        n = x.shape[-1]
        # ONE shared-frame matmul runs the whole filter front half (delay +
        # Hilbert + modulated smoother collapsed into a complex FIR, see
        # __init__); the rotation by the nominal ramp happens on the
        # smoothed output (algebraically identical for the exact integer
        # ramp) and fuses into the atan2 block. cos/sin of the ramp come
        # from static period-length tables cycled by the carried phase
        # (bit-identical values, _rolled_table) — per-sample trig was half
        # of the most expensive elementwise fusion in the receiver graph.
        (c_re, c_im), in_tail = self._bank(x, carry.in_tail)
        d_total = self.group_delay
        ce, se = self._ramp_cos_sin(p, carry.trig + 1 - self.hilbert_delay,
                                    n)
        zr = c_re * ce + c_im * se
        zi = c_im * ce - c_re * se

        resid_w = jnp.arctan2(zi, zr)
        prev = jnp.concatenate([_wrap_pi(carry.resid)[..., None],
                                resid_w[..., :-1]], axis=-1)
        d = _wrap_pi(resid_w - prev)

        # Consumer-visible phase: the locked reference loop's carrier sits at
        # the current sample's pilot phase (measured against ground truth),
        # so emit phi(k): nominal ramp exactly at trig + k, residual advanced
        # by its measured mean slope across the D-sample estimator lag.
        # Slope from the block's SECOND HALF only: a cold start (zero FIR
        # tails) corrupts the first ~(hilbert+smooth taps) deltas, and any
        # contamination of mu rotates the carrier for the whole block —
        # this keeps warm-up blocks (parallel.time_shard halos) convergent
        # and is the fresher estimate in steady state too.
        mu = jnp.mean(d[..., d.shape[-1] // 2:], axis=-1, keepdims=True)

        if p.nco_scale == 2.0 and p.phase_adjust == 0.0:
            # DOUBLE-ANGLE fast path (the stereo 19->38 kHz carrier):
            # cos(2*(ramp + resid_u + D*mu)) is invariant under the 2*pi*k
            # unwrap shift, so the residual enters only through
            # cos/sin(2*resid_w) — pure algebra on the unit vector
            # (zr, zi)/|z|, NO prefix-sum unwrap and NO length-n cosine.
            # The last-sample carry still needs the unwrap LEVEL, which is
            # just carry.resid + sum(d) — a plain reduction.
            r2 = zr * zr + zi * zi
            safe = jnp.where(r2 > 0.0, r2, 1.0)
            cos2r = jnp.where(r2 > 0.0, (zr * zr - zi * zi) / safe, 1.0)
            sin2r = jnp.where(r2 > 0.0, 2.0 * zr * zi / safe, 0.0)
            two_mu = 2.0 * d_total * mu
            cm, sm_ = jnp.cos(two_mu), jnp.sin(two_mu)   # per-block scalars
            cb = cos2r * cm - sin2r * sm_                # cos 2(resid+Dmu)
            sb = sin2r * cm + cos2r * sm_
            if self.derive2 or self._roll_mode != "slice":
                # rot mode: the "exact c2/s2 tables" are themselves
                # rotation-derived, so the derive2 algebra (which reuses
                # the already-loaded ce/se) strictly dominates — the
                # historic mode-0 derive2=False choice only applies to
                # RTSDR_SYNC_ROLL=slice
                # derive cos/sin(2*ramp) from the ALREADY-LOADED (ce, se):
                # the ramp is linear mod 2*pi, so the table offset between
                # the (trig+1) and (trig+1-hilbert_delay) phases is the
                # CONSTANT angle delta = trig_angle(hilbert_delay); the
                # double-angle identity + that constant rotation is pure
                # fusible register algebra — the two (..., n) c2/s2 table
                # materializations (two tile kernels + 2x HBM round trips,
                # ~110 us/run at mode-1 32x12) never happen. ~1e-7 carrier
                # phase error vs the exact tables (f32 product rounding),
                # far below the downstream u8/bf16 floors; RTSDR_SYNC_TBL2
                # =1 restores the exact-table path.
                delta = p.trig_angle(
                    jnp.asarray(self.hilbert_delay, jnp.int32))
                cph, sph = jnp.cos(2.0 * delta), jnp.sin(2.0 * delta)
                cos2e = ce * ce - se * se
                sin2e = 2.0 * ce * se
                c2 = cos2e * cph - sin2e * sph
                s2 = sin2e * cph + cos2e * sph
            else:
                # exact-table fallback (RTSDR_SYNC_TBL2=1): the DOUBLED
                # angle's canonical tables, rolled by the same mechanism
                angle_tbl = p.trig_angle(
                    jnp.arange(p.period, dtype=jnp.int32))
                c2 = self._rolled_table(jnp.cos(2.0 * angle_tbl),
                                        carry.trig + 1, n)
                s2 = self._rolled_table(jnp.sin(2.0 * angle_tbl),
                                        carry.trig + 1, n)
            carrier = c2 * cb - s2 * sb
            resid_last = carry.resid + jnp.sum(d, axis=-1)
        else:
            # general path (e.g. the RDS 114->57 kHz half-angle carrier,
            # nco_scale 0.5, where the 2*pi*k unwrap parity flips the
            # carrier sign and the full unwrap is load-bearing): inclusive
            # prefix sum of the wrapped deltas via matmuls, NOT
            # jnp.cumsum (whose reduce_window lowering was the most
            # expensive kernel in the whole receiver graph; ops/prefix.py)
            resid_u = carry.resid[..., None] + prefix_sum(d)
            ramp_out = self._ramp_angle(p, carry.trig + 1, n)
            phase = ramp_out + resid_u + d_total * mu
            carrier = jnp.cos(p.nco_scale * phase + p.phase_adjust)
            resid_last = resid_u[..., -1]

        new = FFSyncCarry(
            in_tail=in_tail,
            trig=(carry.trig + n) % p.period,
            resid=jnp.mod(resid_last, _FOUR_PI))
        return carrier, new
