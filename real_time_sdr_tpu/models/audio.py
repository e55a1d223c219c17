"""Audio chains: mono extraction and stereo pilot-PLL matrixing.

Redesign of the reference's audio threads (src/mono.cpp:8-50,
src/stereo.cpp:10-115). The stages compose into one jitted dataflow per
block; the thread/queue structure of the reference collapses because the
device graph already evaluates mono, stereo, and (separately) RDS branches
from the same demodulated block.
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
from real_time_sdr_tpu.ops.sync import FeedforwardSync


def _audio_bank(cfg: ReceiverConfig):
    """Polyphase audio LPF: designed at if_fs*up with taps*up and gain up
    (src/mono.cpp:22, src/stereo.cpp:64)."""
    up = cfg.audio_up
    h = filters.design_lpf(cfg.if_fs * up, cfg.audio_fc, cfg.rf_taps * up,
                           gain=up)
    return PolyFIR(h, up=up, down=cfg.audio_down)


class MonoState(NamedTuple):
    audio_tail: jax.Array


class MonoPath:
    """fm_demod -> audio-rate mono samples (float; int16 scaling in utils)."""

    def __init__(self, cfg: ReceiverConfig):
        self.cfg = cfg
        self.audio_fir = _audio_bank(cfg)
        self._audio_bank = FIRBank([self.audio_fir])

    def init_state(self, batch: tuple = ()) -> MonoState:
        return MonoState(jnp.zeros(batch + (self.audio_fir.tail_len,),
                                   jnp.float32))

    def __call__(self, demod: jax.Array, state: MonoState):
        (audio,), tail = self._audio_bank(demod, state.audio_tail)
        return audio, MonoState(tail)


class StereoState(NamedTuple):
    # one tail serves BOTH the pilot and stereo band BPFs: they read the
    # same input history through the shared frame matrix
    # (ops.fir.shared_frames_apply), so a separate band_tail would be a
    # byte-for-byte duplicate
    pilot_tail: jax.Array
    delay_tail: jax.Array
    mono_tail: jax.Array
    stereo_tail: jax.Array
    pll: PllCarry


class StereoPath:
    """fm_demod -> (left, right) audio via 19 kHz pilot PLL + DSB-SC mix.

    Chain (src/stereo.cpp:69-111): pilot BPF 18.5-19.5 kHz -> PLL x2 ->
    38 kHz carrier; stereo BPF 22-54 kHz -> x carrier x2 -> baseband L-R;
    mono path through an APF delay for group-delay alignment; both polyphase
    resampled to audio rate; matrix L = M+S, R = M-S.
    """

    def __init__(self, cfg: ReceiverConfig, pll_tier: int = 1):
        self.cfg = cfg
        fs_if = cfg.rf_fs // cfg.rf_decim  # == cfg.if_fs
        self.pilot_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.PILOT_BAND, cfg.rf_taps))
        self.band_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.STEREO_BAND, cfg.rf_taps))
        self.delay_fir = PolyFIR(filters.design_apf(cfg.rf_taps))
        self.mono_fir = _audio_bank(cfg)
        # same tap bank, different input stream; PolyFIR is stateless
        # (tails are passed in), so one designed object serves both rails
        self.stereo_fir = self.mono_fir
        self._pb_bank = FIRBank([self.pilot_fir, self.band_fir])
        self.pll_params = PllParams(freq=int(C.PILOT_FREQ), fs=fs_if,
                                    nco_scale=2.0, phase_adjust=0.0,
                                    norm_bw=C.PLL_BW_STEREO)
        if pll_tier == 3:
            # derive2 for modes 1-3, the exact rolled tables for mode 0
            # (see FeedforwardSync: which one pays depends on whether the
            # mode's graph is bound by table traffic or elementwise work)
            self._sync = FeedforwardSync(self.pll_params,
                                         derive2=(cfg.mode != 0))
            self._pll = self._sync.__call__
        else:
            self._sync = None
            self._pll = pll_scan if pll_tier == 1 else pll_newton

    def init_state(self, batch: tuple = ()) -> StereoState:
        t = lambda n: jnp.zeros(batch + (n,), jnp.float32)
        k = state_len(self.cfg.rf_taps)
        return StereoState(
            pilot_tail=t(k), delay_tail=t(k),
            mono_tail=t(self.mono_fir.tail_len),
            stereo_tail=t(self.stereo_fir.tail_len),
            pll=(self._sync.init(batch) if self._sync is not None
                 else pll_init(batch)))

    def __call__(self, demod: jax.Array, state: StereoState, shared=None):
        """shared: optional (pilot, band, new_tail) precomputed by the
        receiver-level shared-frame IF matmul (ops.fir.shared_frames_apply)
        so the stereo and RDS band filters ride one matmul."""
        if shared is not None:
            pilot, band, pilot_tail = shared
        else:
            (pilot, band), pilot_tail = self._pb_bank(demod,
                                                      state.pilot_tail)
        carrier, pll = self._pll(barrier(pilot, "pll"),
                                 state.pll, self.pll_params)
        carrier = barrier(carrier, "pll")
        stereo_dc = 2.0 * band * carrier
        mono_delay, delay_tail = self.delay_fir(demod, state.delay_tail)
        # the two rails stay separate 2-D stages: a stacked 3-D frame
        # construction sends XLA's fusion search into a compile-time
        # explosion
        mono, mono_tail = self.mono_fir(mono_delay, state.mono_tail)
        sub, stereo_tail = self.stereo_fir(stereo_dc, state.stereo_tail)
        left = mono + sub
        right = mono - sub
        new_state = StereoState(pilot_tail, delay_tail,
                                mono_tail, stereo_tail, pll)
        return (left, right), new_state
