"""Fused wideband frontend: one matmul from wideband IQ to per-station
FM demod at the IF rate.

The two-stage wideband chain (models/channelizer.py fold matmul ->
rotate/quantize/pack epilogue -> per-station receiver frontend) carries a
uint8 hop that exists only to feed the receivers through their
hardware-tuner byte interface. Both stages are LTI decimators and mixing
commutes with LTI filtering, so the whole cascade folds into ONE framed
matmul at the wide rate:

    h_eq = h_chan (*) upsample_D(h_front)        (exact polyphase identity)
    y_s[u] = e^{-j*w_s*Dt*u} * sum_t (h_eq[t] e^{+j*w_s*t}) * x[u*Dt - t]

with Dt = D * rf_decim the combined decimation (wide rate -> IF rate
directly). On a periodic station grid the output-rate tone
e^{-j*w_s*Dt*u} static-folds into the weights exactly as in the
channelizer (models/channelizer.py _init_fold): pick R = lcm(R, lo) so
e^{-j*w_s*Dt*R*c} == 1 in integer phase, fold theta(r) into the weight
columns, and only a per-segment (S,) scalar rotation survives. The FM
discriminator (ops/demod.fm_demod) is scale-invariant elementwise work
on the matmul result, so demod comes out directly — no uint8 hop, no
epilogue kernel, no frontend kernel, no staging, and HALF the matmul
FLOPs of the two-stage fold (outputs emerge at the IF rate, rf_decim
times fewer than the channelizer's station rate).

Fidelity: the default (RTSDR_WB_FIR=f32) runs Precision.HIGHEST, exact
f32. RTSDR_WB_FIR=bf16 rounds the rails (~-48 dB per sample) and the
combined taps once to bf16 — comparable to the uint8 re-quantization
(~-49 dB) of the two-stage chain; =bf16x2 splits the taps hi+lo (full f32
tap precision) at 2x matmul cost over bf16.

Reference scope: this replaces src/rffrontend.cpp:45-74 + the mixer for
the many-station configuration; single-station serving keeps the uint8
interface (models/frontend.py).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.config import ReceiverConfig
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops.fir import barrier


def make_wideband_frontend(cfg: ReceiverConfig, wide_fs: int,
                           offsets_hz: list[int], taps_factor: int = 2):
    """Serving-path factory: the fused one-matmul frontend when the
    station grid is eligible (every real raster is), else the two-stage
    Channelizer + uint8 receiver path. RTSDR_WB_FUSED=0 forces the
    two-stage path (e.g. to reproduce the uint8-interface bitstreams).
    This is the ONE policy point for the fused/u8 choice — every serving
    entry (cli --stations, bench --wideband, wideband64) goes through it.

    Returns the frontend object; feed it to
    parallel.channel.ChannelBank.run_wideband_jit, which dispatches on
    its type."""
    fused = os.environ.get("RTSDR_WB_FUSED", "1") != "0"
    if fused and FusedWidebandFrontend.eligible(cfg, wide_fs, offsets_hz):
        return FusedWidebandFrontend(cfg, wide_fs, offsets_hz,
                                     taps_factor=taps_factor)
    from real_time_sdr_tpu.models.channelizer import Channelizer
    return Channelizer(cfg, wide_fs, offsets_hz, taps_factor=taps_factor)


class FusedWidebandState(NamedTuple):
    i_tail: jax.Array   # (K_eq-1,) raw wideband rail history
    q_tail: jax.Array
    prev_i: jax.Array   # (S,) carried discriminator samples
    prev_q: jax.Array
    pos: jax.Array      # () int32 IF-rate sample count mod lo


def u8_to_rails(raw_u8: jax.Array):
    """Interleaved raw uint8 capture (2N,) -> ((N,) f32 i, q) ON DEVICE.

    Live ingest ships BYTES to the device (a quarter of the f32 rails'
    traffic), so the deinterleave runs device-side. The form matters for
    compile time: normalize f32 then take TWO STRIDE-2 SLICES of the flat
    array. A reshape (N, 2) + column slices puts a 2-minor layout on the
    whole downstream graph (the (..., 2, n) rail-batch pathology), and
    interleaved frames with row-interleaved weights send the fusion search
    into a compile-time explosion on the doubled-stride frame pattern.
    """
    x = (raw_u8.astype(jnp.float32) - 128.0) * (1.0 / 128.0)
    n2 = x.shape[-1]
    i_wide = jax.lax.slice(x, (0,), (n2 - 1,), (2,))
    q_wide = jax.lax.slice(x, (1,), (n2,), (2,))
    return i_wide, q_wide


class FusedWidebandFrontend:
    """Wideband rails -> per-station IF-rate FM demod, one matmul.

    Requires a periodic station grid (integer offsets on a raster whose
    output-rate tone lcm is small — every real FM raster qualifies; see
    ``eligible``). For pathological grids use Channelizer + the uint8
    receiver path.
    """

    @staticmethod
    def _tone_period(f: int, dt: int, p: int) -> int:
        """IF-rate output-tone period of one station offset."""
        fd = (int(f) * dt) % p
        return p // math.gcd(fd, p) if fd else 1

    @classmethod
    def output_lcm(cls, wide_fs: int, rf_fs: int, rf_decim: int,
                   offsets_hz: list[int]) -> int:
        """lcm over stations of the IF-rate tone period (lo)."""
        p = int(wide_fs)
        dt = (p // int(rf_fs)) * int(rf_decim)
        lo = 1
        for f in offsets_hz:
            per = cls._tone_period(f, dt, p)
            lo = lo * per // math.gcd(lo, per)
        return lo

    @classmethod
    def eligible(cls, cfg: ReceiverConfig, wide_fs: int,
                 offsets_hz: list[int], cap: int | None = None) -> bool:
        """True when the fused path applies. The tone-lcm cap bounds the
        fold weight matrix, which grows ~quadratically with the lcm
        (rows k_eq + (R-1)*dt with R = lcm(8, lo), columns R*2S): at
        lo=32/dt=80/S=64 the f32 weights are ~114 MB, at lo=64 ~400 MB —
        beyond the default cap the two-stage Channelizer path is the
        better program, not just the safer one. RTSDR_WB_LCM_MAX
        overrides (the same number the constructor enforces, so the
        factory's eligible->construct sequence can never crash)."""
        if wide_fs % cfg.rf_fs:
            return False
        if cap is None:
            cap = int(os.environ.get("RTSDR_WB_LCM_MAX", "32"))
        return cls.output_lcm(wide_fs, cfg.rf_fs, cfg.rf_decim,
                              offsets_hz) <= cap

    def __init__(self, cfg: ReceiverConfig, wide_fs: int,
                 offsets_hz: list[int], taps_factor: int = 2,
                 compute_dtype: str | None = None):
        assert wide_fs % cfg.rf_fs == 0, (wide_fs, cfg.rf_fs)
        self.cfg = cfg
        self.wide_fs = int(wide_fs)
        self.offsets = [int(f) for f in offsets_hz]
        d = self.wide_fs // cfg.rf_fs
        self.decim = d
        self.dt = d * cfg.rf_decim          # wide rate -> IF rate
        # combined taps: channelizer LPF (same design as Channelizer)
        # convolved with the frontend LPF upsampled to the wide rate
        k_c = cfg.rf_taps * taps_factor + 1
        h_c = np.asarray(filters.design_lpf(self.wide_fs,
                                            cfg.rf_fs / 2 * 0.8, k_c),
                         dtype=np.float64)
        h_f = np.asarray(filters.design_lpf(cfg.rf_fs, cfg.rf_fc,
                                            cfg.rf_taps), dtype=np.float64)
        h_up = np.zeros(d * (cfg.rf_taps - 1) + 1, dtype=np.float64)
        h_up[::d] = h_f
        self._h_eq = np.convolve(h_c, h_up)
        self.k_eq = self._h_eq.shape[0]     # k_c + d*(rf_taps-1)
        self.tail_len = self.k_eq - 1
        lo = self.output_lcm(self.wide_fs, cfg.rf_fs, cfg.rf_decim,
                             self.offsets)
        cap = int(os.environ.get("RTSDR_WB_LCM_MAX", "32"))
        if lo > cap:
            raise ValueError(
                f"station grid's IF-rate tone lcm {lo} > {cap}; use "
                "Channelizer + the uint8 receiver path for this grid")
        self.lo = lo
        if compute_dtype is None:
            compute_dtype = os.environ.get("RTSDR_WB_FIR", "f32")
        assert compute_dtype in ("bf16", "bf16x2", "f32"), compute_dtype
        self.compute_dtype = compute_dtype
        r_n = max(1, int(os.environ.get("RTSDR_WB_R", "8")))
        r_n = r_n * lo // math.gcd(r_n, lo)  # lo | R: static-tone fold
        self._init_weights(r_n)
        self._plan_cache: dict[int, tuple] = {}

    def _station_cols(self, f: int):
        """One station's fold columns + residual-rotation rows, host f64.

        Returns (a_cols (2J, R) real-rail columns, b_cols (2J, R) imag,
        pc_col (lo,), ps_col (lo,)): the station tone e^{+j*w_s*t} folds
        per-tap, the static r-part of the IF-rate output tone
        e^{-j*w_s*dt*r} rotates each r-column pair (integer phase — see
        models/channelizer.py:_init_fold, same construction). Per-station
        so ``retune`` can rebuild a single station's columns in-place."""
        p, dt, k_eq, h = self.wide_fs, self.dt, self.k_eq, self._h_eq
        r_n, j_w = self.r_n, self.j_w
        t = np.arange(k_eq, dtype=np.int64)
        ang_t = 2.0 * np.pi * (((f % p) * t) % p).astype(np.float64) / p
        hc, hs = h * np.cos(ang_t), h * np.sin(ang_t)
        u = np.arange(max(self.lo, r_n), dtype=np.int64)
        ang_u = (-2.0 * np.pi
                 * ((((f * dt) % p) * u) % p).astype(np.float64) / p)
        uc_r, us_r = np.cos(ang_u[:r_n]), np.sin(ang_u[:r_n])
        a_cols = np.zeros((2 * j_w, r_n))
        b_cols = np.zeros((2 * j_w, r_n))
        for r in range(r_n):
            rows = (k_eq - 1) + r * dt - t
            a = np.zeros(2 * j_w)
            b = np.zeros(2 * j_w)
            a[rows], a[j_w + rows] = hc, -hs
            b[rows], b[j_w + rows] = hs, hc
            a_cols[:, r] = a * uc_r[r] - b * us_r[r]
            b_cols[:, r] = b * uc_r[r] + a * us_r[r]
        return a_cols, b_cols, np.cos(ang_u[:self.lo]), np.sin(ang_u[:self.lo])

    def _init_weights(self, r_n: int) -> None:
        """(2J, R*2S) fold weights, col = r*2S + u (u < S real rail)."""
        s_ch = len(self.offsets)
        self.r_n = r_n
        self.j_w = self.k_eq + (r_n - 1) * self.dt
        w2 = np.zeros((2 * self.j_w, r_n * 2 * s_ch))
        pc = np.zeros((self.lo, s_ch))
        ps = np.zeros((self.lo, s_ch))
        for si, f in enumerate(self.offsets):
            a_cols, b_cols, pc[:, si], ps[:, si] = self._station_cols(f)
            for r in range(r_n):
                base = r * 2 * s_ch
                w2[:, base + si] = a_cols[:, r]
                w2[:, base + s_ch + si] = b_cols[:, r]
        self._w = w2.astype(np.float32)
        self._pc_np = pc.astype(np.float32)
        self._ps_np = ps.astype(np.float32)
        # per-segment residual rotation tables, (lo, S) for one-row slice
        self._pc = jnp.asarray(self._pc_np)
        self._ps = jnp.asarray(self._ps_np)
        self._dev_weights = None   # device-operand cache (device_weights)

    def device_weights(self):
        """The fold weights as DEVICE OPERANDS: (w, pc, ps), precast to the
        matmul dtype (bf16 modes upload ~half the bytes of f32).

        Serving with operands instead of jit-constants makes the station
        grid RUNTIME-RETUNABLE: ``retune`` rebuilds one station's columns
        host-side and the next ``device_weights`` call re-uploads — no
        recompile, no weight re-baking of the other stations, receiver
        state untouched (the sharded path,
        parallel.wideband.ShardedFusedWideband, already passes weights as
        shard_map operands through the same ``core``). The reference
        retunes by restarting ``rtl_sdr -f`` (model/fmMonoBasic.py:30-42).
        """
        if self._dev_weights is None:
            w = (self._w.astype(np.dtype("bfloat16"))
                 if self.compute_dtype == "bf16" else self._w)
            self._dev_weights = (jnp.asarray(w), self._pc, self._ps)
        return self._dev_weights

    def retune(self, station: int, offset_hz: int) -> None:
        """Re-point one station of the grid at a new offset (host-side
        weight rebuild, O(2J*R) — microseconds; no recompile when served
        through ``device_weights`` operands).

        The new offset must keep the grid's static-tone geometry: its
        IF-rate tone period must divide the constructed ``lo`` (true for
        any retune within the same raster the frontend was built on)."""
        if not 0 <= station < len(self.offsets):
            # no negative indexing: `base + station` arithmetic below
            # would write another station's columns for r >= 1
            raise ValueError(
                f"station {station} out of range [0, {len(self.offsets)})")
        f = int(offset_hz)
        per = self._tone_period(f, self.dt, self.wide_fs)
        if self.lo % per:
            raise ValueError(
                f"offset {f} Hz has IF-tone period {per}, not a divisor "
                f"of this grid's lo={self.lo}; rebuild the frontend for "
                "off-raster offsets")
        s_ch = len(self.offsets)
        a_cols, b_cols, pc_col, ps_col = self._station_cols(f)
        # COPY-ON-WRITE, never mutate in place: jnp.asarray of a numpy
        # array is zero-copy on CPU, so the previous _w/_pc_np buffers may
        # be ALIASED by live device arrays (operand uploads still feeding
        # in-flight dispatches) and by baked jit constants — an in-place
        # column write would corrupt results already dispatched (observed
        # as a flaky pre-retune segment showing the post-retune tone).
        w = self._w.copy()
        pc = self._pc_np.copy()
        ps = self._ps_np.copy()
        for r in range(self.r_n):
            base = r * 2 * s_ch
            w[:, base + station] = a_cols[:, r]
            w[:, base + s_ch + station] = b_cols[:, r]
        pc[:, station] = pc_col
        ps[:, station] = ps_col
        self._w, self._pc_np, self._ps_np = w, pc, ps
        self._pc = jnp.asarray(pc)
        self._ps = jnp.asarray(ps)
        self.offsets[station] = f
        self._dev_weights = None   # re-upload on next device_weights()

    def init_state(self) -> FusedWidebandState:
        s = len(self.offsets)
        z = jnp.zeros((self.tail_len,), jnp.float32)
        return FusedWidebandState(z, z, jnp.zeros((s,), jnp.float32),
                                  jnp.zeros((s,), jnp.float32),
                                  jnp.zeros((), jnp.int32))

    def _plan(self, n: int):
        if n in self._plan_cache:
            return self._plan_cache[n]
        assert n % self.dt == 0, (n, self.dt)
        n_if = n // self.dt
        stride = self.r_n * self.dt
        c_frames = -(-n_if // self.r_n)
        s_over = -(-self.j_w // stride)
        pad_to = (c_frames + s_over) * stride
        plan = (n_if, stride, c_frames, s_over, pad_to)
        self._plan_cache[n] = plan
        return plan

    def _frames(self, xx: jax.Array, plan) -> jax.Array:
        """(n + tail,) rail -> (c_frames, J) windows (shifted slices of one
        reshape — no gathers; PolyFIR's framing scheme)."""
        n_if, stride, c_frames, s_over, pad_to = plan
        pad = pad_to - xx.shape[-1]
        xp = jnp.pad(xx, [(0, pad)]) if pad > 0 else xx
        rows = xp.reshape(-1, stride)
        parts = [rows[s:s + c_frames, :] for s in range(s_over)]
        return jnp.concatenate(parts, axis=-1)[:, :self.j_w]

    def cost(self, n: int) -> dict:
        """Speed-of-light accounting (see PolyFIR.cost)."""
        n_if, stride, c_frames, s_over, pad_to = self._plan(n)
        s_ch = len(self.offsets)
        passes = 2 if self.compute_dtype == "bf16x2" else 1
        flops = passes * 2 * c_frames * 2 * self.j_w * self.r_n * 2 * s_ch
        ebytes = 2 if self.compute_dtype.startswith("bf16") else 4
        byts = (2 * ebytes * (n + self.tail_len)      # two rails, read once
                + passes * ebytes * 2 * self.j_w * self.r_n * 2 * s_ch
                + 4 * s_ch * n_if * 2)                # demod out + transpose
        return {"kind": f"fused_wb_{self.compute_dtype}", "flops": flops,
                "bytes": byts,
                "w_bytes": passes * ebytes * 2 * self.j_w
                * self.r_n * 2 * s_ch,
                "dims": (c_frames, 2 * self.j_w, self.r_n * 2 * s_ch)}

    def _matmul(self, fr: jax.Array, w) -> jax.Array:
        # w is a numpy constant (unsharded path) or a traced shard_map
        # operand. Numpy weights are precast on HOST for the bf16 modes:
        # baking the f32 matrix and casting in-graph would double the
        # jit-constant size for no reason — ~114 MB f32 vs ~57 MB bf16 at
        # 64 stations
        is_np = isinstance(w, np.ndarray)
        if self.compute_dtype == "bf16":
            w_b = (jnp.asarray(w, dtype=jnp.bfloat16) if is_np
                   else jnp.asarray(w).astype(jnp.bfloat16))
            return jnp.einsum("cj,jr->cr", fr, w_b,
                              preferred_element_type=jnp.float32)
        if self.compute_dtype == "bf16x2":
            if is_np:
                w_hi = w.astype(jnp.bfloat16)
                w_lo = jnp.asarray(
                    (w - np.asarray(w_hi, np.float32)).astype(jnp.bfloat16))
                w_hi = jnp.asarray(w_hi)
            else:
                w_t = jnp.asarray(w)
                w_hi = w_t.astype(jnp.bfloat16)
                w_lo = (w_t - w_hi.astype(jnp.float32)).astype(jnp.bfloat16)
            return (jnp.einsum("cj,jr->cr", fr, w_hi,
                               preferred_element_type=jnp.float32)
                    + jnp.einsum("cj,jr->cr", fr, w_lo,
                                 preferred_element_type=jnp.float32))
        return jnp.einsum("cj,jr->cr", fr, jnp.asarray(w),
                          precision=jax.lax.Precision.HIGHEST)

    def core(self, w_cols, pc_t, ps_t, i_tail, q_tail, prev_i, prev_q,
             pos, i_wide: jax.Array, q_wide: jax.Array):
        """The complete fused-frontend math on an arbitrary station-column
        subset — the SINGLE implementation behind both ``__call__`` and
        the per-shard body of parallel.wideband.ShardedFusedWideband, so
        the two can never drift.

        w_cols: (2J, R*2*s_l) weights (numpy constant or a traced
        shard_map operand); pc_t/ps_t: (lo, s_l) residual-rotation
        tables; prev_i/prev_q: (s_l,) carried discriminator samples.
        Returns (demod (s_l, n_if), last_i, last_q)."""
        n = i_wide.shape[-1]
        plan = self._plan(n)
        n_if = plan[0]
        r_n = self.r_n
        s_l = w_cols.shape[-1] // (2 * r_n)
        bf16 = self.compute_dtype.startswith("bf16")
        dtype = jnp.bfloat16 if bf16 else jnp.float32
        xi = jnp.concatenate([i_tail, i_wide]).astype(dtype)
        xq = jnp.concatenate([q_tail, q_wide]).astype(dtype)
        # same fusion-explosion guard as the channelizer fold (the frame
        # construction below feeding the station bank is the exact graph
        # shape the "chanfold" barrier exists for)
        xi = barrier(xi, "chanfold")
        xq = barrier(xq, "chanfold")
        fr = jnp.concatenate([self._frames(xi, plan),
                              self._frames(xq, plan)], axis=-1)
        y = self._matmul(fr, w_cols)
        # residual per-segment rotation (constant over the segment)
        pos_l = pos % self.lo
        pc = jax.lax.dynamic_slice_in_dim(pc_t, pos_l, 1, 0)[0]
        ps = jax.lax.dynamic_slice_in_dim(ps_t, pos_l, 1, 0)[0]
        y4 = y.reshape(-1, r_n, 2, s_l)
        vr, vi = y4[:, :, 0, :], y4[:, :, 1, :]          # (c, R, s_l)
        i_t = (vr * pc - vi * ps).reshape(-1, s_l)[:n_if]   # (n_if, s_l)
        q_t = (vi * pc + vr * ps).reshape(-1, s_l)[:n_if]
        # discriminator in the matmul's own time-major layout; ONE f32
        # transpose of the demod result replaces the u8 path's quantize/
        # pack/relayout/stage chain
        ip = jnp.concatenate([prev_i[None, :], i_t[:-1]], axis=0)
        qp = jnp.concatenate([prev_q[None, :], q_t[:-1]], axis=0)
        num = i_t * (q_t - qp) - q_t * (i_t - ip)
        den = i_t * i_t + q_t * q_t
        zero = (i_t == 0.0) & (q_t == 0.0)
        demod_t = jnp.where(zero, 0.0,
                            num / jnp.where(den == 0.0, 1.0, den))
        return demod_t.T, i_t[n_if - 1], q_t[n_if - 1]

    def __call__(self, i_wide: jax.Array, q_wide: jax.Array,
                 state: FusedWidebandState, weights=None):
        """i_wide, q_wide: (N,) float32 at wide_fs, N % (D*rf_decim) == 0.

        ``weights``: optional (w, pc, ps) DEVICE OPERANDS from
        ``device_weights()`` — the runtime-retunable serving form (the
        weights become traced jit arguments instead of baked constants).
        Returns (demod (S, N // (D*rf_decim)) float32, new state)."""
        w, pc, ps = weights if weights is not None else (
            self._w, self._pc, self._ps)
        demod, last_i, last_q = self.core(
            w, pc, ps, state.i_tail, state.q_tail,
            state.prev_i, state.prev_q, state.pos, i_wide, q_wide)
        tl = self.tail_len
        new = FusedWidebandState(
            jnp.concatenate([state.i_tail, i_wide])[-tl:],
            jnp.concatenate([state.q_tail, q_wide])[-tl:],
            last_i, last_q,
            (state.pos + demod.shape[-1]) % self.lo)
        return demod, new
