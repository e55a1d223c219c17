"""RDS chain: 57 kHz BPSK subcarrier -> RRC-clean samples -> decoded bits.

Redesign of the reference's RDS thread DSP half
(src/rds.cpp:95-133) and the slicer/decoder entry (src/rds.cpp:135-167):

  BPF 54-60 kHz -> squaring nonlinearity -> BPF 113.5-114.5 kHz ->
  PLL(114 kHz, ncoScale 0.5, bw 0.001) -> 57 kHz carrier ->
  APF delay-match -> x2 mix -> polyphase resample to sps*2375 S/s ->
  RRC matched filter -> CDR + slice + Manchester + differential (ops.rds_bits)

The resample ratio is derived per mode (config.rds_resample) instead of the
reference's hard-coded 247/640 (only correct at 240 kS/s IF with 39 sps).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from real_time_sdr_tpu import config as C
from real_time_sdr_tpu.config import ReceiverConfig
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops.fir import FIRBank, PolyFIR, barrier, state_len
from real_time_sdr_tpu.ops.pll import (PllCarry, PllParams, pll_init,
                                       pll_newton, pll_scan)
from real_time_sdr_tpu.ops.rds_bits import (BitSyncState, TimingTrack,
                                            bit_sync_init, decode_block_bits,
                                            decode_block_bits_tracked,
                                            timing_init)
from real_time_sdr_tpu.ops.sync import FeedforwardSync


class RdsState(NamedTuple):
    band_tail: jax.Array
    pilot_tail: jax.Array
    delay_tail: jax.Array
    baseband_tail: jax.Array
    rrc_tail: jax.Array
    pll: PllCarry
    bits: BitSyncState
    block_count: jax.Array  # int32; decode gated to block_count > 5
    track: TimingTrack | None = None  # tracking-CDR carry (timing="tracked")


class RdsPath:
    """fm_demod -> (bits, n_bits, rds_clean) per block.

    timing: "comb" = the reference's per-block argmax CDR
    (src/rds_utilities.cpp:4-21); "tracked" = polyphase-interpolating CDR
    with drift accumulator (twin of the Muller-Mueller tracking in
    model/pySDRRDS.py:36-55, redesigned feedforward) — follows a
    symbol-clock ppm error the fixed comb cannot.
    """

    def __init__(self, cfg: ReceiverConfig, pll_tier: int = 1,
                 timing: str = "comb"):
        assert timing in ("comb", "tracked")
        self.timing = timing
        # set False (before first trace) to skip bit emission — the DSP
        # half still runs; see _decode_one
        self.emit_bits = True
        self.cfg = cfg
        fs_if = cfg.if_fs
        up, down = cfg.rds_resample
        self.band_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.RDS_BAND, cfg.rf_taps))
        self.pilot_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.RDS_SQUARED_BAND, cfg.rf_taps))
        self.delay_fir = PolyFIR(filters.design_apf(cfg.rf_taps))
        # Baseband LPF designed at the upsampled rate with gain=up
        # (src/rds.cpp:61: impulseResponseLPF(if_Fs*247, 3e3, taps*247, 247)).
        self.baseband_fir = PolyFIR(
            filters.design_lpf(fs_if * up, 3_000.0, cfg.rf_taps * up,
                               gain=up),
            up=up, down=down)
        self.rrc_fir = PolyFIR(
            filters.design_rrc(cfg.rds_fs, cfg.rf_taps,
                               symbol_rate=C.RDS_SYMBOL_RATE,
                               beta=C.RDS_RRC_BETA))
        self._band_bank = FIRBank([self.band_fir])
        self._pilot_bank = FIRBank([self.pilot_fir])
        self._baseband_bank = FIRBank([self.baseband_fir])
        self._rrc_bank = FIRBank([self.rrc_fir])
        self.pll_params = PllParams(freq=int(C.RDS_PILOT_FREQ), fs=fs_if,
                                    nco_scale=0.5, phase_adjust=0.0,
                                    norm_bw=C.PLL_BW_RDS)
        if pll_tier == 3:
            # narrower smoothing matches the RDS loop's 10x narrower bw
            self._sync = FeedforwardSync(self.pll_params, smooth_taps=129)
            self._pll = self._sync.__call__
        else:
            self._sync = None
            self._pll = pll_scan if pll_tier == 1 else pll_newton

    def init_state(self, batch: tuple = ()) -> RdsState:
        t = lambda n: jnp.zeros(batch + (n,), jnp.float32)
        k = state_len(self.cfg.rf_taps)
        return RdsState(
            band_tail=t(k), pilot_tail=t(k), delay_tail=t(k),
            baseband_tail=t(self.baseband_fir.tail_len),
            rrc_tail=t(self.rrc_fir.tail_len),
            pll=(self._sync.init(batch) if self._sync is not None
                 else pll_init(batch)),
            bits=bit_sync_init(batch),
            block_count=jnp.zeros(batch, jnp.int32),
            track=(timing_init(batch) if self.timing == "tracked" else None))

    def _decode_one(self, clean: jax.Array, bit_state: BitSyncState,
                    track, block_count: jax.Array):
        """Per-RDS-block slicer/decoder with the reference's 5-block warm-up
        gate (src/rds.cpp:135): before warm-up the decoder does not run at
        all, so the carried bit state holds."""
        cfg = self.cfg
        if not self.emit_bits:
            # DSP-only mode (parallel/time_shard runs ONE global decode
            # scan over the gathered exact RRC stream): emit constants so
            # XLA dead-code-eliminates the per-shard slicer entirely
            bits = jnp.zeros(clean.shape[:-1] + (cfg.max_bits,), jnp.int32)
            n_bits = jnp.zeros(clean.shape[:-1], jnp.int32)
            return bits, n_bits, bit_state, track
        if self.timing == "tracked":
            bits, n_bits, new_bits, new_track = decode_block_bits_tracked(
                clean, bit_state, track, cfg.sps, cfg.max_symbols,
                cfg.max_bits)
        else:
            bits, n_bits, new_bits = decode_block_bits(
                clean, bit_state, cfg.sps, cfg.max_symbols, cfg.max_bits)
            new_track = None
        warm = block_count > 5
        n_bits = jnp.where(warm, n_bits, 0)
        new_bits = jax.tree_util.tree_map(
            lambda new, old: jnp.where(warm, new, old), new_bits, bit_state)
        # the timing loop is NOT gated: it locks during warm-up
        return bits, n_bits, new_bits, new_track

    def __call__(self, demod: jax.Array, state: RdsState, band_pre=None):
        """demod: (if_block,) for block mode, or (nb*if_block,) for segment
        mode. Segment mode runs the wideband stages (band/pilot BPFs, PLL,
        mix) over the whole segment in one pass, then scans the narrowband
        tail (baseband resample, RRC, slicer) per block so the decoded bits
        are identical to block-by-block execution.

        band_pre: optional (band, new_tail) from the receiver-level
        shared-frame IF matmul.

        Returns ((bits, n_bits, clean), state) with a leading nb axis on the
        outputs in segment mode.
        """
        cfg = self.cfg
        nb = demod.shape[-1] // cfg.if_block
        if band_pre is not None:
            band, band_tail = band_pre
        else:
            (band,), band_tail = self._band_bank(demod, state.band_tail)
        squared = band * band
        (pilot,), pilot_tail = self._pilot_bank(squared, state.pilot_tail)
        carrier, pll = self._pll(barrier(pilot, "pll"),
                                 state.pll, self.pll_params)
        carrier = barrier(carrier, "pll")
        delayed, delay_tail = self.delay_fir(band, state.delay_tail)
        mixed = 2.0 * delayed * carrier

        if nb == 1:
            (filt,), baseband_tail = self._baseband_bank(
                mixed, state.baseband_tail)
            (clean,), rrc_tail = self._rrc_bank(filt, state.rrc_tail)
            bits, n_bits, bit_state, track = self._decode_one(
                clean, state.bits, state.track, state.block_count)
            new_state = RdsState(band_tail, pilot_tail, delay_tail,
                                 baseband_tail, rrc_tail, pll, bit_state,
                                 state.block_count + 1, track)
            return (bits, n_bits, clean), new_state

        # Segment mode: per-block narrowband processing, but BATCHED — the
        # FIR carried state is pure input history, so block b's tail is just
        # a slice of block b-1's data, all available in the segment. Both
        # FIRs run once over a (nb, ...) batch; results are exactly the
        # per-block execution (incl. the reference's per-block resampler
        # output truncation). Only the bit-sync state machine stays a scan.
        mixed_blocks = mixed.reshape((nb, cfg.if_block))
        bb_tails = jnp.concatenate(
            [state.baseband_tail[None],
             mixed_blocks[:-1, cfg.if_block - self.baseband_fir.tail_len:]],
            axis=0)
        (filt,), _ = self._baseband_bank(mixed_blocks, bb_tails)
        rrc_tails = jnp.concatenate(
            [state.rrc_tail[None],
             filt[:-1, filt.shape[-1] - self.rrc_fir.tail_len:]], axis=0)
        (clean,), _ = self._rrc_bank(filt, rrc_tails)

        if self.timing == "comb" and self.emit_bits:
            # batched slicer: no per-block scan (the scan version measured
            # ~1.5 us/blk/ch of pure dispatch, experiments/stage_decompose)
            from real_time_sdr_tpu.ops.rds_bits import decode_segment_bits
            bits, n_bits, bit_state = decode_segment_bits(
                clean, state.bits, state.block_count, cfg.sps,
                cfg.max_symbols, cfg.max_bits)
            track = state.track
            count = state.block_count + nb
        else:
            def body(carry, clean_b):
                bit_state, track, count = carry
                bits, n_bits, bit_state, track = self._decode_one(
                    clean_b, bit_state, track, count)
                return (bit_state, track, count + 1), (bits, n_bits)

            (bit_state, track, count), (bits, n_bits) = jax.lax.scan(
                body, (state.bits, state.track, state.block_count), clean)
        bb_tail = mixed_blocks[-1, cfg.if_block - self.baseband_fir.tail_len:]
        rrc_tail = filt[-1, filt.shape[-1] - self.rrc_fir.tail_len:]
        new_state = RdsState(band_tail, pilot_tail, delay_tail, bb_tail,
                             rrc_tail, pll, bit_state, count, track)
        return (bits, n_bits, clean), new_state
