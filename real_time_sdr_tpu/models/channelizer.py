"""Wideband channelizer: one capture -> many station basebands.

A capability beyond the reference (which relies on the RTL-SDR tuner to
deliver one station per 2.4 MS/s stream): ingest a single wideband IQ
capture and extract every station in it on-device, feeding the channel-bank
receivers. This is the "64+ FM stations channelized and demodulated in
parallel" configuration of the project north star.

Per station: complex mix by the offset tone, then low-pass + decimate both
rails with the framed-matmul FIR (batched over stations).

Mixer exactness: the per-sample tone exp(-2*pi*j*(f*k mod fs)/fs) is
computed on the host with arbitrary-precision integer phase reduction (a
device-side f*k product overflows int32 by orders of magnitude).

Two tone mechanisms, picked automatically:

- PERIODIC (real station grids): every integer offset f has tone period
  fs/gcd(f, fs); on a 100 kHz raster at 19.2 MS/s that's <= 192 samples.
  When lcm(periods) <= 65536 the tones are (S, lcm) STATIC tables cycled
  by ONE carried integer position (all stations advance in lockstep) —
  one scalar dynamic_slice + tile per segment, so memory is O(S * lcm)
  instead of O(S * n) (64 stations x 12-block segments would otherwise
  need multi-GB tables) and cross-segment continuity is integer-EXACT.
- GENERAL (pathological offsets): full-length cached tables + a carried
  unit phasor advanced by the per-segment rotation (f32 continuity,
  ~1e-7 rad/segment, renormalized).

FOLDED-TONE mode (the periodic default, RTSDR_CHAN_FOLD=0 restores
mix-then-filter): mixing commutes with LTI filtering —

    y_s[m] = sum_t h[t] * x[mD-t] * e^{-j*w_s*(mD-t)}
           = e^{-j*w_s*mD} * sum_t (h[t] e^{+j*w_s*t}) * x[mD-t]

so the per-station tone FOLDS into the taps (a static complex bandpass
per station) and the (2S, n_wide) mixed rails — the dominant HBM
arrays of the whole wideband pipeline — are never materialized. The
shared wideband i/q rails are framed ONCE and hit one matmul
(frames (c, 2J) x weights (2J, R*2S)); the leftover per-station tone
runs at the DECIMATED rate (D-times less traffic) from the same
integer-exact rolled static tables (period at output rate divides the
input-rate lcm). Algebraically identical to mix-then-filter; traffic
drops from O(S * n_wide) to O(n_wide + S * n_wide / D).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.config import ReceiverConfig
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops.fir import PolyFIR


def fold_epilogue_u8(y: jax.Array, pc: jax.Array, ps: jax.Array,
                     r_n: int, s_ch: int, n_out: int) -> jax.Array:
    """Static-tone fold epilogue: y (c, r_n*2*s_ch) matmul output, pc/ps
    (s_ch,) residual rotation -> (s_ch, 2*n_out) interleaved uint8 station
    streams. Quantizes BEFORE the station-major transpose so the single
    relayout moves uint8, not f32."""
    y4 = y.reshape(-1, r_n, 2, s_ch)
    vr, vi = y4[:, :, 0, :], y4[:, :, 1, :]      # (c, R, S)
    i_full = vr * pc - vi * ps
    q_full = vi * pc + vr * ps
    z = jnp.stack([i_full, q_full], axis=-1)     # (c, R, S, 2)
    u8 = jnp.clip(jnp.round(128.0 + 127.0 * z), 0, 255).astype(jnp.uint8)
    return u8.transpose(2, 0, 1, 3).reshape(s_ch, -1)[:, :2 * n_out]


class ChannelizerState(NamedTuple):
    i_tails: jax.Array   # (S, T-1) per-station decimator tails
    q_tails: jax.Array
    ph_re: jax.Array     # (S,) carried tone phasor (general mode; unused —
    ph_im: jax.Array     # held at (1, 0) — in periodic mode)
    pos: jax.Array       # () int32 table position mod lcm (periodic mode)


class Channelizer:
    """Extract S stations from a wideband complex capture.

    wide_fs must be an integer multiple of the per-station rate
    (cfg.rf_fs); offsets_hz are integer station offsets from the capture
    center.
    """

    def __init__(self, cfg: ReceiverConfig, wide_fs: int,
                 offsets_hz: list[int], taps_factor: int = 2):
        assert wide_fs % cfg.rf_fs == 0
        self.cfg = cfg
        self.wide_fs = int(wide_fs)
        self.decim = self.wide_fs // cfg.rf_fs
        self.offsets = [int(f) for f in offsets_hz]
        taps = cfg.rf_taps * taps_factor + 1
        h = filters.design_lpf(self.wide_fs, cfg.rf_fs / 2 * 0.8, taps)
        self._h64 = np.asarray(h, dtype=np.float64)
        # own barrier tag: a SINGLE FIR stage fed by elementwise mixing
        # (not the chained-FIR pattern the "polyfir" barrier guards), so
        # its fusion behaviour is A/B-able independently (RTSDR_NO_BARRIER
        # =chan) — the barrier materializes (2S, n_wide) f32 stage inputs
        # that dominate wideband serving at large S.
        # RTSDR_CHAN_FIR=bf16 runs this stage as one bf16 pass with f32
        # accumulation: its consumer re-encodes to uint8 (to_uint8, ~-49 dB
        # quantization), a harder floor than bf16's ~-54 dB.
        self.fir = PolyFIR(h, up=1, down=self.decim, barrier_tag="chan",
                           compute_dtype=os.environ.get("RTSDR_CHAN_FIR",
                                                        "f32"))
        self._tone_cache: dict[int, tuple] = {}
        # periodic-exact tone mode (see module docstring)
        import math as _math
        pers = [self.wide_fs // _math.gcd(f % self.wide_fs, self.wide_fs)
                if f % self.wide_fs else 1 for f in self.offsets]
        lcm = 1
        for q in pers:
            lcm = lcm * q // _math.gcd(lcm, q)
            if lcm > 65536:
                break
        self.tone_period = lcm if lcm <= 65536 else 0
        if self.tone_period:
            p, L = self.wide_fs, self.tone_period
            k = np.arange(L, dtype=np.int64)
            ang = np.stack([-2.0 * np.pi
                            * (((f % p) * k) % p).astype(np.float64) / p
                            for f in self.offsets])
            self._per_c = jnp.asarray(np.cos(ang).astype(np.float32))
            self._per_s = jnp.asarray(np.sin(ang).astype(np.float32))
        # folded-tone mode (module docstring): periodic grids default to
        # folding the tone into per-station complex bandpass taps so the
        # (2S, n_wide) mixed rails never exist. RTSDR_CHAN_FOLD=0 restores
        # mix-then-filter; RTSDR_CHAN_FOLD_R tunes outputs-per-frame.
        self.fold = bool(self.tone_period) and (
            os.environ.get("RTSDR_CHAN_FOLD", "1") != "0")
        self._fold_static = False
        if self.fold:
            self._init_fold(taps,
                            int(os.environ.get("RTSDR_CHAN_FOLD_R", "8")))

    def _init_fold(self, taps: int, fold_r: int) -> None:
        """Precompute the folded weight matrix and output-rate tone tables.

        Weight layout (one matmul for everything): frames are the shared
        i-rail and q-rail windows concatenated, (c, 2J); columns are
        r-major (col = r*2S + u) so the matmul result reshapes STRAIGHT to
        (n_out, 2S) with u < S the pre-tone real rail and u >= S the
        imaginary rail:

            v_re = i (*) hc - q (*) hs        hc[s,t] = h[t] cos(w_s t)
            v_im = i (*) hs + q (*) hc        hs[s,t] = h[t] sin(w_s t)

        STATIC-TONE fold (the default when the output-rate tone lcm `lo`
        is small, e.g. 8 on the 64-station 300 kHz raster, 24 on a
        100 kHz raster): pick R = lcm(R, lo); then the output tone
        e^{-j*w_s*D*m} at m = c*R + r splits as theta(r) + theta(pos),
        because e^{-j*w_s*D*R*c} == 1 exactly (integer phase: (f*d*R) %
        p == 0 for every station). theta(r) is STATIC and folds into the
        weight columns; only the per-segment theta(pos) — one (S,) scalar
        rotation — remains at runtime. The (S, n_out) tone tables, their
        tile/relayout traffic, and the f32 transpose epilogue all vanish.
        RTSDR_CHAN_FOLD_STATIC=0 restores the runtime
        tone; RTSDR_CHAN_FOLD_STATIC_MAX (default 32) caps the lo that
        may be promoted (J = taps + (R-1)*D grows with R, adding matmul
        work: +18% at R=8, +60% at R=24 over the tap-only frame)."""
        import math as _math
        p, d, s_ch = self.wide_fs, self.decim, len(self.offsets)
        h, k_taps = self._h64, taps
        # output-rate tone e^{-j*w_s*D*u}: period divides the input lcm
        pers = [p // _math.gcd((f * d) % p, p) if (f * d) % p else 1
                for f in self.offsets]
        lo = 1
        for q in pers:
            lo = lo * q // _math.gcd(lo, q)
        assert lo <= self.tone_period  # divides the input-rate lcm
        self._fold_L = lo
        cap = int(os.environ.get("RTSDR_CHAN_FOLD_STATIC_MAX", "32"))
        self._fold_static = (
            os.environ.get("RTSDR_CHAN_FOLD_STATIC", "1") != "0"
            and lo <= cap)
        r_n = max(1, fold_r)
        if self._fold_static:
            r_n = r_n * lo // _math.gcd(r_n, lo)    # lo | R
        j_w = k_taps + (r_n - 1) * d        # window samples per frame
        t = np.arange(k_taps, dtype=np.int64)
        hc = np.empty((s_ch, k_taps))
        hs = np.empty((s_ch, k_taps))
        for si, f in enumerate(self.offsets):
            fr = f % p
            ang = 2.0 * np.pi * ((fr * t) % p).astype(np.float64) / p
            hc[si] = h * np.cos(ang)
            hs[si] = h * np.sin(ang)
        w2 = np.zeros((2 * j_w, r_n * 2 * s_ch))
        cols_s = np.arange(s_ch)[:, None]   # (S, 1) station columns
        for r in range(r_n):
            # output r of a frame reads xx[(K-1) + r*D - t] (PolyFIR's
            # up=1 indexing, ops/fir.py:155-161)
            rows = ((k_taps - 1) + r * d - t)[None, :]  # (1, K)
            base = r * 2 * s_ch
            w2[rows, base + cols_s] = hc
            w2[j_w + rows, base + cols_s] = -hs
            w2[rows, base + s_ch + cols_s] = hs
            w2[j_w + rows, base + s_ch + cols_s] = hc
        u = np.arange(max(lo, r_n), dtype=np.int64)
        ang = np.stack([-2.0 * np.pi
                        * ((((f * d) % p) * u) % p).astype(np.float64) / p
                        for f in self.offsets])     # (S, max(lo, R))
        if self._fold_static:
            # rotate each (re, im) column pair by the static r-part of
            # the tone: v' = v * e^{j*theta(r)} folded into the weights
            uc_r, us_r = np.cos(ang[:, :r_n]), np.sin(ang[:, :r_n])
            for r in range(r_n):
                base = r * 2 * s_ch
                cre = base + np.arange(s_ch)
                cim = base + s_ch + np.arange(s_ch)
                wre, wim = w2[:, cre].copy(), w2[:, cim].copy()
                w2[:, cre] = wre * uc_r[:, r] - wim * us_r[:, r]
                w2[:, cim] = wim * uc_r[:, r] + wre * us_r[:, r]
        self._fold_R, self._fold_J = r_n, j_w
        self._fold_W = w2.astype(np.float32)
        self._fold_tail = k_taps - 1
        self._fold_uc = jnp.asarray(np.cos(ang[:, :lo]).astype(np.float32))
        self._fold_us = jnp.asarray(np.sin(ang[:, :lo]).astype(np.float32))
        # residual pos-rotation tables, (lo, S) for one-row dynamic_slice
        self._fold_pc = jnp.asarray(
            np.cos(ang[:, :lo]).T.astype(np.float32))
        self._fold_ps = jnp.asarray(
            np.sin(ang[:, :lo]).T.astype(np.float32))
        self._fold_plan_cache: dict[int, tuple] = {}

    def _tones(self, n: int):
        """Exact (S, n) float32 cos/sin tables of -2*pi*f*k/fs, plus the
        per-segment continuation rotations (S,) complex128."""
        if n in self._tone_cache:
            return self._tone_cache[n]
        p = self.wide_fs
        k = np.arange(n, dtype=np.int64)
        cs, sn, rots = [], [], []
        for f in self.offsets:
            fr = f % p
            assert fr * n < 2**63  # int64 modular phase stays exact
            frac = ((fr * k) % p).astype(np.float64) / p
            ang = -2.0 * np.pi * frac
            cs.append(np.cos(ang))
            sn.append(np.sin(ang))
            rots.append(np.exp(-2j * np.pi * ((fr * n) % p) / p))
        tone_c = jnp.asarray(np.stack(cs).astype(np.float32))
        tone_s = jnp.asarray(np.stack(sn).astype(np.float32))
        rot = np.array(rots)
        out = (tone_c, tone_s,
               jnp.asarray(rot.real.astype(np.float32)),
               jnp.asarray(rot.imag.astype(np.float32)))
        self._tone_cache[n] = out
        return out

    def init_state(self) -> ChannelizerState:
        s = len(self.offsets)
        if self.fold and self.tone_period:
            # folded mode carries the RAW wideband history (one rail pair
            # serves every station) and `pos` at the OUTPUT rate mod the
            # decimated-tone lcm; ph_re/ph_im are unused placeholders.
            t = jnp.zeros((1, self._fold_tail), jnp.float32)
        else:
            t = jnp.zeros((s, self.fir.tail_len), jnp.float32)
        return ChannelizerState(t, t, jnp.ones((s,), jnp.float32),
                                jnp.zeros((s,), jnp.float32),
                                jnp.zeros((), jnp.int32))

    def _fold_plan(self, n: int):
        if n in self._fold_plan_cache:
            return self._fold_plan_cache[n]
        assert n % self.decim == 0, \
            "folded channelizer needs decimation-aligned segments"
        r_n, j_w, d = self._fold_R, self._fold_J, self.decim
        n_out = n // d
        stride = r_n * d
        c_frames = -(-n_out // r_n)
        s_over = -(-j_w // stride)
        pad_to = (c_frames + s_over) * stride
        plan = (n_out, stride, c_frames, s_over, pad_to)
        self._fold_plan_cache[n] = plan
        return plan

    def _fold_frames(self, xx: jax.Array, plan) -> jax.Array:
        """(n + tail,) rail -> (c_frames, J) windows, PolyFIR-style
        (shifted slices of one reshape — no gathers)."""
        n_out, stride, c_frames, s_over, pad_to = plan
        pad = pad_to - xx.shape[-1]
        xp = jnp.pad(xx, [(0, pad)]) if pad > 0 else xx
        rows = xp.reshape(-1, stride)
        parts = [rows[s:s + c_frames, :] for s in range(s_over)]
        return jnp.concatenate(parts, axis=-1)[:, :self._fold_J]

    def _fold_call(self, i_wide: jax.Array, q_wide: jax.Array,
                   state: ChannelizerState, emit: str = "f32"):
        from real_time_sdr_tpu.ops.fir import barrier
        n = i_wide.shape[-1]
        plan = self._fold_plan(n)
        n_out = plan[0]
        s_ch = len(self.offsets)
        bf16 = self.fir.compute_dtype == "bf16"
        dt = jnp.bfloat16 if bf16 else jnp.float32
        xi = jnp.concatenate([state.i_tails[0].astype(dt),
                              i_wide.astype(dt)])
        xq = jnp.concatenate([state.q_tails[0].astype(dt),
                              q_wide.astype(dt)])
        # "chanfold" site, default ON: without it XLA's fusion search
        # across the fold frame construction + a large station bank
        # explodes compile time
        xi = barrier(xi, "chanfold")
        xq = barrier(xq, "chanfold")
        fr = jnp.concatenate([self._fold_frames(xi, plan),
                              self._fold_frames(xq, plan)], axis=-1)
        if bf16:
            y = jnp.einsum("cj,jr->cr", fr,
                           jnp.asarray(self._fold_W, dtype=jnp.bfloat16),
                           preferred_element_type=jnp.float32)
        else:
            y = jnp.einsum("cj,jr->cr", fr, jnp.asarray(self._fold_W),
                           precision=jax.lax.Precision.HIGHEST)
        lo = self._fold_L
        pos = state.pos % lo
        if self._fold_static:
            # weights already carry theta(r); only the per-segment
            # theta(pos) scalar rotation remains. All elementwise work
            # happens in the einsum's own (c, R*2S) layout.
            r_n = self._fold_R
            pc = jax.lax.dynamic_slice_in_dim(self._fold_pc, pos, 1, 0)[0]
            ps = jax.lax.dynamic_slice_in_dim(self._fold_ps, pos, 1, 0)[0]
            if emit == "u8":
                out = fold_epilogue_u8(y, pc, ps, r_n, s_ch, n_out)
            else:
                y4 = y.reshape(-1, r_n, 2, s_ch)
                vr, vi = y4[:, :, 0, :], y4[:, :, 1, :]      # (c, R, S)
                i_full = vr * pc - vi * ps
                q_full = vi * pc + vr * ps
                i_ds = i_full.transpose(2, 0, 1).reshape(s_ch, -1)[:, :n_out]
                q_ds = q_full.transpose(2, 0, 1).reshape(s_ch, -1)[:, :n_out]
        else:
            # r-major columns: (c, R*2S) reshapes straight to (n_out, 2S)
            v = y.reshape(-1, 2 * s_ch)[:n_out].T        # (2S, n_out) f32
            v_re, v_im = v[:s_ch], v[s_ch:]

            # decimated-rate tone e^{-j*w*D*(pos+m)}, integer-exact roll
            def roll(tbl):
                doubled = jnp.concatenate([tbl, tbl], axis=-1)
                rolled = jax.lax.dynamic_slice_in_dim(doubled, pos, lo,
                                                      axis=-1)
                return jnp.tile(rolled, (1, -(-n_out // lo)))[:, :n_out]

            uc, us = roll(self._fold_uc), roll(self._fold_us)
            # (v_re + j v_im) * (uc + j us): the tables hold the -w
            # angle, so this is the same plain complex multiply as the
            # mixing path
            i_ds = uc * v_re - us * v_im
            q_ds = uc * v_im + us * v_re
            if emit == "u8":
                out = self.to_uint8(i_ds, q_ds)
        # raw-rail tails straight from the f32 inputs (no bf16 round-trip)
        tl = self._fold_tail
        i_t = jnp.concatenate([state.i_tails, i_wide[None]], -1)[:, -tl:]
        q_t = jnp.concatenate([state.q_tails, q_wide[None]], -1)[:, -tl:]
        new = ChannelizerState(i_t, q_t, state.ph_re, state.ph_im,
                               (state.pos + n_out) % lo)
        if emit == "u8":
            return out, new
        return (i_ds, q_ds), new

    def _periodic_tones(self, n: int, pos: jax.Array):
        """(S, n) tone tables cycled from the carried integer position:
        tone[s, k] = T[s, (pos + k) mod L] — one scalar dynamic_slice of
        the doubled static tables + tile, exact and O(S*L) memory."""
        L = self.tone_period

        def roll_tile(tbl):
            doubled = jnp.concatenate([tbl, tbl], axis=-1)
            rolled = jax.lax.dynamic_slice_in_dim(doubled, pos % L, L,
                                                  axis=-1)
            return jnp.tile(rolled, (1, -(-n // L)))[:, :n]

        return roll_tile(self._per_c), roll_tile(self._per_s)

    def __call__(self, i_wide: jax.Array, q_wide: jax.Array,
                 state: ChannelizerState):
        """i_wide, q_wide: (N,) float32 at wide_fs.

        Returns ((S, N//decim) i/q station basebands, new state)."""
        if self.fold and self.tone_period:
            return self._fold_call(i_wide, q_wide, state)
        n = i_wide.shape[-1]
        if self.tone_period:
            c, s_ = self._periodic_tones(n, state.pos)
        else:
            tone_c, tone_s, rot_re, rot_im = self._tones(n)
            # effective tone = table * carried phasor (complex multiply)
            c = tone_c * state.ph_re[:, None] - tone_s * state.ph_im[:, None]
            s_ = tone_s * state.ph_re[:, None] + tone_c * state.ph_im[:, None]
        # (i + jq) * (c + j s_): downshift by +offset. In the bf16-FIR
        # mode the mixed rails are emitted bf16 — they are the dominant
        # (2S, n_wide) HBM arrays of the whole wideband pipeline and feed
        # a bf16 matmul anyway
        mi = i_wide[None, :] * c - q_wide[None, :] * s_
        mq = q_wide[None, :] * c + i_wide[None, :] * s_
        if self.fir.compute_dtype == "bf16":
            mi = mi.astype(jnp.bfloat16)
            mq = mq.astype(jnp.bfloat16)
        # both rails through ONE framed-matmul dispatch (stays 2-D per call)
        s_ch = len(self.offsets)
        ds, tails = self.fir(
            jnp.concatenate([mi, mq], axis=0),
            jnp.concatenate([state.i_tails, state.q_tails], axis=0))
        i_ds, q_ds = ds[:s_ch], ds[s_ch:]
        i_tails, q_tails = tails[:s_ch], tails[s_ch:]
        if self.tone_period:
            new = ChannelizerState(i_tails, q_tails, state.ph_re,
                                   state.ph_im,
                                   (state.pos + n) % self.tone_period)
        else:
            # advance + renormalize the continuity phasor
            pr = state.ph_re * rot_re - state.ph_im * rot_im
            pi_ = state.ph_re * rot_im + state.ph_im * rot_re
            norm = jax.lax.rsqrt(pr * pr + pi_ * pi_)
            new = ChannelizerState(i_tails, q_tails, pr * norm, pi_ * norm,
                                   state.pos)
        return (i_ds, q_ds), new

    def call_u8(self, i_wide: jax.Array, q_wide: jax.Array,
                state: ChannelizerState):
        """Channelize straight to the receivers' interleaved uint8
        interface: (u8 (S, 2*N//decim), new state).

        Same math as ``to_uint8(*self(i, q, state))`` (bit-identical in
        static-tone fold mode — quantization commutes elementwise with
        the transpose), but the fused epilogue quantizes before the
        station-major relayout so the (2S, n_out) f32 intermediates never
        reach device memory. All wideband serving paths should use this
        entry."""
        if self.fold and self.tone_period and self._fold_static:
            return self._fold_call(i_wide, q_wide, state, emit="u8")
        (i_ds, q_ds), st = self(i_wide, q_wide, state)
        return self.to_uint8(i_ds, q_ds), st

    def to_uint8(self, i_ds: jax.Array, q_ds: jax.Array) -> jax.Array:
        """Re-encode station basebands to the receivers' interleaved uint8
        interface (one extra quantization, as a hardware tuner would)."""
        s, n = i_ds.shape
        iq = jnp.stack([i_ds, q_ds], axis=-1).reshape(s, 2 * n)
        return jnp.clip(jnp.round(128.0 + 127.0 * iq), 0, 255
                        ).astype(jnp.uint8)
