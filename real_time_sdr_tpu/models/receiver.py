"""Full receiver: one jitted (state, IQ-block) -> (state, outputs) step.

This is the device-graph replacement for the reference's three-thread pipeline
(src/project.cpp:134-140 + include/threadsafequeue.h): on device there is no
need for pipeline threads or a broadcast rendezvous queue — the mono/stereo
and RDS branches are just two consumers of the same ``fm_demod`` value inside
one XLA graph. Sequential-block semantics live in ``lax.scan`` (offline /
throughput mode) or a host streaming loop (real-time mode); the carried
state pytree is exactly the reference's cross-block state surface
(SURVEY.md section 5 'checkpoint/resume'), which makes state serialization
trivial (utils.state).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from real_time_sdr_tpu.config import ReceiverConfig, mode_config
from real_time_sdr_tpu.models.audio import MonoPath, StereoPath
from real_time_sdr_tpu.models.frontend import Frontend
from real_time_sdr_tpu.models.rds import RdsPath


class ReceiverState(NamedTuple):
    frontend: Any
    audio: Any
    rds: Any        # RdsState or None


class ReceiverOutput(NamedTuple):
    mono: Any       # (..., audio_block) float32, mono mode only, else None
    left: Any       # (..., audio_block) float32, stereo mode only, else None
    right: Any
    rds_bits: Any   # (..., max_bits) int32 or None
    rds_nbits: Any  # (...,) int32 or None
    rds_clean: Any = None  # (..., rds_block) float32 RRC output (RDS mode)


class Receiver:
    """Configured receiver chain.

    mode/type mirror the reference CLI (src/project.cpp:67-132): type 'm' is
    mono, 's' adds the stereo decoder, 'r' is stereo + RDS. The RDS branch can
    also be enabled independently.
    """

    def __init__(self, cfg: ReceiverConfig | int = 0, *, stereo: bool = False,
                 rds: bool = False, pll_tier: int = 1,
                 rds_timing: str = "comb"):
        if isinstance(cfg, int):
            cfg = mode_config(cfg)
        if pll_tier not in (1, 2, 3):
            raise ValueError(f"pll_tier must be 1 (exact scan), 2 (Newton) "
                             f"or 3 (feedforward); got {pll_tier!r}")
        self.cfg = cfg
        self.stereo = stereo
        self.rds = rds
        self.frontend = Frontend(cfg)
        self.audio = StereoPath(cfg, pll_tier) if stereo else MonoPath(cfg)
        self.rds_path = (RdsPath(cfg, pll_tier, timing=rds_timing)
                         if rds else None)
        if stereo and rds:
            # stereo pilot + stereo band + RDS band BPFs share one frame
            # matrix and run as ONE matmul (ops.fir.shared_frames_apply)
            from real_time_sdr_tpu.ops.fir import FIRBank
            self._if_bank = FIRBank([self.audio.pilot_fir,
                                     self.audio.band_fir,
                                     self.rds_path.band_fir])
        else:
            self._if_bank = None
        self._jit_step = jax.jit(self.step)
        self._jit_scan = jax.jit(self.run_blocks)

    # -- state -------------------------------------------------------------

    def init_state(self, batch: tuple = ()) -> ReceiverState:
        return ReceiverState(
            frontend=self.frontend.init_state(batch),
            audio=self.audio.init_state(batch),
            rds=self.rds_path.init_state(batch) if self.rds_path else None)

    # -- execution ---------------------------------------------------------

    def _check_batch(self, iq_u8, core_ndim: int) -> None:
        """Reject explicit leading batch dims on stereo/RDS receivers.

        Only the mono chain is written for arbitrary leading batch dims;
        the stereo/RDS synchronizer and decode stages assume a 1-D sample
        axis and would fail at trace time deep inside the chain (or worse).
        Batched decode goes through jax.vmap / ChannelBank — under vmap the
        per-trace operand is unbatched, so this check stays silent there.
        """
        ndim = getattr(iq_u8, "ndim", None)
        if (ndim is not None and ndim > core_ndim
                and (self.stereo or self.rds_path is not None)):
            raise ValueError(
                f"stereo/RDS receivers take a {core_ndim}-D IQ operand "
                f"(got ndim={ndim}); batch channels with jax.vmap or "
                "parallel.channel.ChannelBank instead")

    def step(self, state: ReceiverState, iq_u8: jax.Array):
        """One block: iq_u8 (2*block_size_iq,) uint8 (mono-only receivers
        also accept leading batch dims; for stereo/RDS, batch via jax.vmap
        or parallel.channel.ChannelBank — see _check_batch)."""
        self._check_batch(iq_u8, 1)
        demod, f_state = self.frontend(iq_u8, state.frontend)
        return self._post_frontend(demod, f_state, state)

    def _post_frontend(self, demod, f_state, state: ReceiverState):
        shared = band_pre = None
        if self._if_bank is not None:
            (pilot, band_s, band_r), if_tail = self._if_bank(
                demod, state.audio.pilot_tail)
            shared = (pilot, band_s, if_tail)
            band_pre = (band_r, if_tail)
        if self.stereo:
            (left, right), a_state = self.audio(demod, state.audio,
                                                shared=shared)
            mono = None
        else:
            mono, a_state = self.audio(demod, state.audio)
            left = right = None
        if self.rds_path is not None:
            (bits, n_bits, clean), r_state = self.rds_path(
                demod, state.rds, band_pre=band_pre)
        else:
            bits = n_bits = clean = r_state = None
        out = ReceiverOutput(mono=mono, left=left, right=right,
                             rds_bits=bits, rds_nbits=n_bits,
                             rds_clean=clean)
        return ReceiverState(f_state, a_state, r_state), out

    def jit_step(self, state, iq_u8):
        return self._jit_step(state, iq_u8)

    def run_blocks(self, state: ReceiverState, iq_blocks: jax.Array):
        """Throughput mode: scan over (B, 2*block_size_iq) uint8 blocks.

        Returns (final_state, ReceiverOutput stacked along a leading B axis).
        """
        return jax.lax.scan(self.step, state, iq_blocks)

    def jit_run_blocks(self, state, iq_blocks):
        return self._jit_scan(state, iq_blocks)

    def run_segment(self, state: ReceiverState, iq_segment: jax.Array):
        """Segment mode: process B blocks as ONE contiguous pass.

        iq_segment: (B * 2*block_size_iq,) uint8 (leading batch dims only
        for mono-only receivers; batch stereo/RDS via jax.vmap or
        ChannelBank — see _check_batch). All wideband stages
        (frontend, audio, stereo PLL, RDS band/carrier recovery) run over the
        whole segment — amortizing per-op dispatch across B blocks — while
        the narrowband RDS tail keeps exact per-block semantics internally.
        Audio comes back as (..., B*audio_block); RDS bits as
        (..., B, max_bits). Numerically equivalent to run_blocks in EVERY
        mode: integer-ratio modes (0/1) trivially, and the fractional modes
        (2/3) because the reference's own block geometry makes the per-block
        resampler output count an exact integer (if_block*up % down == 0),
        so uniform segment resampling and the reference's per-block
        truncation (src/filter.cpp:124) coincide — pinned by
        tests/test_segment_mode.py::test_segment_equals_blocks_fractional
        (>110 dB audio, bit-identical RDS).
        """
        return self.step(state, iq_segment)

    def run_segment_demod(self, state: ReceiverState, demod: jax.Array):
        """Post-frontend entry: ``demod`` (n_blocks*if_block,) float32 is
        the FM-discriminated IF signal computed EXTERNALLY (the fused
        wideband frontend, models/wideband_frontend.py, emits it straight
        from one wide-rate matmul). Runs the audio + RDS chains exactly as
        ``run_segment`` would after its frontend; ``state.frontend``
        passes through untouched (the external frontend carries its own
        state)."""
        self._check_batch(demod, 1)
        return self._post_frontend(demod, state.frontend, state)

    def run_segment_tiled(self, state: ReceiverState, iq_segment: jax.Array,
                          tile_blocks: int = 12):
        """Long segment as sequential ``tile_blocks``-sized segment passes
        inside one jitted graph (lax.scan with carried state).

        Outputs are reshaped to exactly ``run_segment``'s layout; the
        carried state chains across tiles, so results equal a single pass
        up to f32 reduction order.

        Prefer HOST-chained 12-block ``run_segment`` calls for serving:
        dispatches pipeline asynchronously, the compiled graph stays at one
        shape, and compile time stays bounded. This in-graph scan form
        exists for single-dispatch contexts (e.g. inside a larger jit).
        """
        blk = 2 * self.cfg.block_size_iq
        n_blocks = iq_segment.shape[-1] // blk
        # tile_blocks >= 2: the nb==1 step path emits outputs without a
        # block axis, which the per-tile joins below cannot restack
        if tile_blocks < 2 or n_blocks <= tile_blocks:
            return self.step(state, iq_segment)  # one small pass is fine
        if n_blocks % tile_blocks:
            # refusing beats silently compiling the giant untiled graph
            # the tiling exists to avoid (compile blow-up, CLAUDE.md)
            raise ValueError(
                f"run_segment_tiled: {n_blocks} blocks not divisible by "
                f"tile_blocks={tile_blocks}; pad the segment or pick a "
                "divisor (host-chained run_segment calls are the "
                "recommended serving path anyway)")
        n_tiles = n_blocks // tile_blocks
        lead = iq_segment.shape[:-1]
        tiles = jnp.moveaxis(
            iq_segment.reshape(lead + (n_tiles, tile_blocks * blk)),
            -2, 0)  # (n_tiles, ..., tile_blocks*blk)
        final, outs = jax.lax.scan(self.step, state, tiles)

        def stream(leaf):  # (n_tiles, ..., T) -> (..., n_tiles*T)
            if leaf is None:
                return None
            x = jnp.moveaxis(leaf, 0, -2)
            return x.reshape(lead + (-1,))

        def blocks(leaf):  # (n_tiles, ..., tile, k) -> (..., n_blocks, k)
            if leaf is None:
                return None
            x = jnp.moveaxis(leaf, 0, -3)
            return x.reshape(lead + (n_blocks, leaf.shape[-1]))

        out = ReceiverOutput(
            mono=stream(outs.mono), left=stream(outs.left),
            right=stream(outs.right), rds_bits=blocks(outs.rds_bits),
            rds_nbits=stream(outs.rds_nbits),
            rds_clean=blocks(outs.rds_clean))
        return final, out
