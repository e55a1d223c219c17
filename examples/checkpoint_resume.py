"""Checkpoint/resume: decode half a capture, save state, resume exactly.

Usage: python examples/checkpoint_resume.py

The whole receiver's carried DSP state (filter tails, synchronizer
carries, RDS bit-alignment) is one explicit pytree, so resuming a decode
is: save the pytree, reload it, keep feeding blocks. The two-run output
is verified bit-identical to a single uninterrupted run — the reference
has no equivalent (its state lives in C++ stack variables).
"""

import os
import sys
import tempfile

sys.path.append(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root

# JAX's default backend; JAX_PLATFORMS=cpu runs it on a CPU-only host
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.utils import state as state_util
from real_time_sdr_tpu.utils import synth


def main() -> None:
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    iq, _ = synth.station_iq(cfg, 12)
    blocks = jnp.asarray(iq.reshape(12, 2 * cfg.block_size_iq))

    # one uninterrupted run
    _, ref = rx.jit_run_blocks(rx.init_state(), blocks)

    # run 1: first half, then checkpoint
    ckpt = os.path.join(tempfile.mkdtemp(), "receiver.npz")
    st, out1 = rx.jit_run_blocks(rx.init_state(), blocks[:6])
    state_util.save_state(ckpt, st)
    print(f"run 1 decoded 6 blocks, state saved to {ckpt} "
          f"({os.path.getsize(ckpt)} bytes)")

    # run 2 (fresh process in real use): load and continue
    st2 = state_util.load_state(ckpt, rx.init_state())
    _, out2 = rx.jit_run_blocks(st2, blocks[6:])
    print("run 2 resumed and decoded the remaining 6 blocks")

    resumed = np.concatenate([np.asarray(out1.left).ravel(),
                              np.asarray(out2.left).ravel()])
    exact = np.array_equal(resumed, np.asarray(ref.left).ravel())
    bits_exact = np.array_equal(
        np.concatenate([np.asarray(out1.rds_bits), np.asarray(out2.rds_bits)]),
        np.asarray(ref.rds_bits))
    print(f"split run == uninterrupted run: audio {exact}, "
          f"RDS bits {bits_exact}")
    assert exact and bits_exact


if __name__ == "__main__":
    main()
