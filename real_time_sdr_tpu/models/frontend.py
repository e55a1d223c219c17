"""RF front end: uint8 IQ block -> FM-demodulated IF block.

Redesign of the reference's frontend thread
(src/rffrontend.cpp:9-77). The reference deinterleaves with a scalar loop and
runs two decimating FIRs plus the discriminator as separate passes; here the
whole stage is a few fused tensor ops inside one jit region — XLA fuses
normalize/deinterleave into the convolution input and the discriminator into
its output, so the block makes one round trip through device memory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from real_time_sdr_tpu.config import ReceiverConfig
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops.demod import fm_demod
from real_time_sdr_tpu.ops.fir import DualPhaseFIR


class FrontendState(NamedTuple):
    iq_tail: jax.Array  # (2*taps-2,) interleaved overlap-save tail
    prev_i: jax.Array   # carried discriminator samples (src/demod.cpp:21-22)
    prev_q: jax.Array


class Frontend:
    """Per-block: normalize, LPF + decimate I/Q, discriminate.

    The deinterleave never happens explicitly: the dual-phase FIR consumes
    the interleaved stream directly (ops.fir.DualPhaseFIR), and
    ops.demod.fm_demod fuses into its output, so XLA materializes only the
    frame matrix between the raw bytes and the demod signal.
    """

    def __init__(self, cfg: ReceiverConfig):
        self.cfg = cfg
        h_rf = filters.design_lpf(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps)
        self.rf_fir = DualPhaseFIR(h_rf, down=cfg.rf_decim)

    def init_state(self, batch: tuple = ()) -> FrontendState:
        # raw uint8 tail; 128 is the "zero-signal" byte
        z = jnp.full(batch + (self.rf_fir.tail_len,), 128, jnp.uint8)
        s = jnp.zeros(batch, jnp.float32)
        return FrontendState(z, s, s)

    def __call__(self, iq_u8: jax.Array, state: FrontendState):
        """iq_u8: (..., 2*block_size_iq) uint8 interleaved I,Q.

        Returns (fm_demod (..., if_block), new_state)."""
        i_ds, q_ds, iq_tail = self.rf_fir(iq_u8, state.iq_tail)
        demod, prev_i, prev_q = fm_demod(i_ds, q_ds, state.prev_i,
                                         state.prev_q)
        return demod, FrontendState(iq_tail, prev_i, prev_q)
