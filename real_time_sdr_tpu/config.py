"""Receiver configuration: the four sample-rate modes and derived quantities.

Re-design of the reference CLI/config layer
(reference: src/project.cpp:67-108 mode switch, include/args.h:6-19 struct args).

The reference carries a mutable ``args`` struct into each pipeline thread. Here
the config is an immutable dataclass of *static* quantities: every derived
number (block sizes, resampler ratios, filter specs) is a Python int computed
at trace time, so every array shape inside ``jit`` is static.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Static configuration for one FM receiver chain.

    Defaults mirror the reference's default ``args`` instance
    (src/project.cpp:31-44): 2.4 MS/s in, 100 kHz RF cutoff, 101 taps,
    decimate 10 -> 240 kS/s IF, resample 1/5 -> 48 kHz audio, 39 samples
    per RDS symbol.
    """

    mode: int = 0
    rf_fs: int = 2_400_000      # RF (input IQ) sample rate
    rf_fc: int = 100_000        # RF front-end low-pass cutoff
    rf_taps: int = 101          # base FIR tap count used throughout
    rf_decim: int = 10          # RF -> IF decimation
    audio_up: int = 1           # audio polyphase upsample factor
    audio_down: int = 5         # audio polyphase downsample factor
    if_fs: int = 240_000        # intermediate (demodulated) rate
    audio_fc: int = 16_000      # audio low-pass cutoff
    sps: int = 39               # RDS samples per symbol at the RRC rate

    # --- derived sizes (reference: src/rffrontend.cpp:21 block formula) ---

    @property
    def block_size_iq(self) -> int:
        """IQ pairs per input block: (1470 * rf_decim * audio_down) / audio_up."""
        n = 1470 * self.rf_decim * self.audio_down
        assert n % self.audio_up == 0
        return n // self.audio_up

    @property
    def if_block(self) -> int:
        """Samples per block at IF rate (after RF decimation)."""
        assert self.block_size_iq % self.rf_decim == 0
        return self.block_size_iq // self.rf_decim

    @property
    def audio_block(self) -> int:
        """Audio samples per block (after polyphase resample)."""
        return (self.if_block * self.audio_up) // self.audio_down

    @property
    def audio_fs(self) -> Fraction:
        """Audio output rate = if_fs * up / down (48k / 40k / 44.1k)."""
        return Fraction(self.if_fs * self.audio_up, self.audio_down)

    # --- RDS chain rates ---
    # The reference hard-codes the 247/640 resample (src/rds.cpp:130), which
    # is only correct for mode 0 (240 kS/s * 247/640 = 92.625 kS/s = 39 sps
    # x 2375 baud). We derive the ratio from (sps, if_fs) so every mode gets
    # a consistent RDS rate.

    @property
    def rds_fs(self) -> int:
        """RDS processing rate: sps * 2375 symbol/s."""
        return self.sps * 2375

    @property
    def rds_resample(self) -> tuple[int, int]:
        """(up, down) rational resample IF -> RDS rate, reduced."""
        f = Fraction(self.rds_fs, self.if_fs)
        return f.numerator, f.denominator

    @property
    def rds_block(self) -> int:
        """RDS-rate samples per block (C++ integer truncation semantics,
        reference: src/filter.cpp:124 ``y.resize(x.size()*up/down)``)."""
        up, down = self.rds_resample
        return (self.if_block * up) // down

    @property
    def max_symbols(self) -> int:
        """Static upper bound on RDS symbols sliced per block (ceil)."""
        return -(-self.rds_block // self.sps)

    @property
    def max_bits(self) -> int:
        """Static upper bound on Manchester-decoded bits per block (half
        the symbols, +1 for a carried half-symbol, +1 ceil slack)."""
        return self.max_symbols // 2 + 2

    def __post_init__(self):
        assert (1470 * self.rf_decim * self.audio_down) % self.audio_up == 0
        assert self.rf_taps % 2 == 1, "odd tap count keeps group delay integral"
        # audio.py derives its IF rate as rf_fs // rf_decim while rds.py
        # reads if_fs directly; both paths share one demod stream, so a
        # mismatched custom config would silently decode garbage
        assert self.if_fs == self.rf_fs // self.rf_decim, (
            f"if_fs {self.if_fs} != rf_fs/rf_decim "
            f"{self.rf_fs // self.rf_decim}")


def mode_config(mode: int) -> ReceiverConfig:
    """The four canonical modes (reference: src/project.cpp:67-108).

    mode 0: 2.4   MS/s -> /10 -> 240 kS/s -> *1/5    -> 48   kHz, sps 39
    mode 1: 1.44  MS/s -> /4  -> 360 kS/s -> *1/9    -> 40   kHz, sps 39
    mode 2: 2.4   MS/s -> /10 -> 240 kS/s -> *147/800  -> 44.1 kHz, sps 20
    mode 3: 1.152 MS/s -> /3  -> 384 kS/s -> *147/1280 -> 44.1 kHz, sps 20
    """
    if mode == 0:
        return ReceiverConfig(mode=0)
    if mode == 1:
        return ReceiverConfig(mode=1, rf_fs=1_440_000, rf_decim=4,
                              audio_down=9, if_fs=360_000)
    if mode == 2:
        return ReceiverConfig(mode=2, rf_fs=2_400_000, rf_decim=10,
                              audio_down=800, audio_up=147, if_fs=240_000,
                              sps=20)
    if mode == 3:
        return ReceiverConfig(mode=3, rf_fs=1_152_000, rf_decim=3,
                              audio_down=1280, audio_up=147, if_fs=384_000,
                              sps=20)
    raise ValueError(f"unknown mode {mode!r} (expected 0-3)")


# Band-plan constants shared by the stereo and RDS chains
# (reference: src/stereo.cpp:59-61, src/rds.cpp:58-59).
PILOT_BAND = (18_500.0, 19_500.0)       # 19 kHz stereo pilot
STEREO_BAND = (22_000.0, 54_000.0)      # L-R DSB-SC subchannel
RDS_BAND = (54_000.0, 60_000.0)         # RDS BPSK subcarrier band
RDS_SQUARED_BAND = (113_500.0, 114_500.0)  # squared-RDS pilot at 114 kHz
PILOT_FREQ = 19_000.0
RDS_PILOT_FREQ = 114_000.0
RDS_SYMBOL_RATE = 2375.0
RDS_RRC_BETA = 0.90
PLL_BW_STEREO = 0.01
PLL_BW_RDS = 0.001
AUDIO_SCALE = 16384.0                   # int16 PCM scaling (src/mono.cpp:41)
