"""Sequence parallelism: shard one long capture across 8 devices in TIME.

Usage: python examples/time_sharded_offline.py

The block stream is strictly sequential in the reference (carried filter
tails + PLL phase). Here a 16-block capture is split across 8 devices
(2 blocks each), halos and carrier-phase corrections exchanged via
ppermute, and — because every recurrence in the tier-3 receiver is
feedforward — the sharded RDS bits are BIT-IDENTICAL to the sequential
decode and the audio matches to float32 reduction order (>120 dB; the
boundary phase correction is algebraically exact but rounds in the last
ulp). See parallel/time_shard.py, exact mode.

Shards over up to 8 of the default backend's devices (16 blocks divide
evenly over 1, 2, 4 or 8); with JAX_PLATFORMS=cpu it runs on 8 virtual CPU
devices.
"""

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # default backend; JAX_PLATFORMS=cpu runs it on a CPU-only host

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.parallel.time_shard import time_sharded_run
from real_time_sdr_tpu.utils import synth


def main() -> None:
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    n_blocks = 16
    iq, _ = synth.station_iq(cfg, n_blocks, ps_name="SHARDED!")
    blocks = jnp.asarray(iq.reshape(n_blocks, 2 * cfg.block_size_iq))

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("time",))
    print(f"devices: {len(devs)} x {devs[0].device_kind}")

    outs = time_sharded_run(rx, mesh, blocks, axis="time", overlap=1)

    # prove exactness against the sequential receiver
    _, seq = rx.jit_run_blocks(rx.init_state(), blocks)
    ref, got = np.asarray(seq.left), np.asarray(outs.left)
    snr = 10 * np.log10(np.mean(ref ** 2)
                        / (np.mean((ref - got) ** 2) + 1e-300))
    same_bits = np.array_equal(np.asarray(outs.rds_bits),
                               np.asarray(seq.rds_bits))
    print(f"sharded vs sequential: audio {snr:.0f} dB "
          f"(float32 reduction-order), RDS bits identical: {same_bits}")
    assert snr > 120 and same_bits


if __name__ == "__main__":
    main()
