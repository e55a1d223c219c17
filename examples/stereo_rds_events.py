"""Decode stereo audio + every RDS data service from a capture.

Usage: python examples/stereo_rds_events.py [capture.raw] [--mode N]

Without a capture path, synthesizes a station broadcasting the full RDS
metadata set this framework decodes: PS name, RadioText, clock-time (4A),
an alternative-frequency list, and the TP flag. Prints each decoded event
as it happens (the reference prints PI/PTY/PS to stderr,
src/rds_utilities.cpp:180-196).
"""

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root

# JAX's default backend; JAX_PLATFORMS=cpu runs it on a CPU-only host
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.rds_framing import RdsFramer
from real_time_sdr_tpu.utils import synth


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("--mode", type=int, default=0)
    args = ap.parse_args()

    rx = Receiver(args.mode, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg

    if args.capture:
        iq = np.fromfile(args.capture, dtype=np.uint8)
        n_blocks = iq.size // (2 * cfg.block_size_iq)
        iq = iq[:n_blocks * 2 * cfg.block_size_iq]
    else:
        iq, _ = synth.station_iq(
            cfg, 96, ps_name="EXAMPLE ", pi=0x3A5C, pty=9,
            radiotext="JAX SDR EXAMPLE",
            clock=(2026, 8, 18, 12, 0, -8), af_mhz=(98.1, 101.5))
        print("synthesized 96 blocks with PS+RadioText+CT+AF")

    framer = RdsFramer(on_event=lambda kind, val: print(f"  {kind}: {val}"))
    state = rx.init_state()
    state, out = rx.run_segment(state, jnp.asarray(iq))
    bits = np.asarray(out.rds_bits)
    nbits = np.asarray(out.rds_nbits)
    for b in range(bits.shape[0]):
        framer.feed(bits[b, :nbits[b]])

    ev = framer.events
    pi = f"{ev.pi:#06x}" if ev.pi is not None else "never synced"
    print(f"\nstation summary: PI={pi} PTY={ev.pty!r} PS={ev.ps_name!r}")
    print(f"  RadioText: {ev.radiotext.rstrip()!r}")
    print(f"  Clock:     {ev.clock_utc}")
    print(f"  AF:        {ev.alt_freqs_mhz} MHz  TP={ev.traffic_program}")
    left = np.asarray(out.left).ravel()
    right = np.asarray(out.right).ravel()
    print(f"  audio:     {left.size} samples/ch at {cfg.audio_fs} Hz, "
          f"L rms {np.sqrt(np.mean(left**2)):.3f} "
          f"R rms {np.sqrt(np.mean(right**2)):.3f}")


if __name__ == "__main__":
    main()
