"""Decode a raw uint8 IQ capture to a mono WAV file.

Usage: python examples/mono_to_wav.py [capture.raw] [out.wav] [--mode N]

Without a capture path, synthesizes 24 blocks of a clean FM station
carrying a 440/1200 Hz stereo pair (decoded here as mono). This is the
JAX twin of the reference workflow documented at
model/fmMonoBasic.py:30-42 (rtl_sdr capture -> decode -> .wav).
"""

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root

# JAX's default backend; JAX_PLATFORMS=cpu runs it on a CPU-only host
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.utils import synth
from real_time_sdr_tpu.utils.io import write_wav


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("out_wav", nargs="?", default="mono.wav")
    ap.add_argument("--mode", type=int, default=0)
    args = ap.parse_args()

    rx = Receiver(args.mode, stereo=False, rds=False)
    cfg = rx.cfg

    if args.capture:
        iq = np.fromfile(args.capture, dtype=np.uint8)
        n_blocks = iq.size // (2 * cfg.block_size_iq)
        iq = iq[:n_blocks * 2 * cfg.block_size_iq]
        print(f"loaded {args.capture}: {n_blocks} blocks")
    else:
        iq, _ = synth.station_iq(cfg, 24)
        print("synthesized 24 blocks (440 Hz left / 1200 Hz right tones)")

    state = rx.init_state()
    state, out = rx.run_segment(state, jnp.asarray(iq))
    audio = np.asarray(out.mono).ravel()

    out_path = args.out_wav
    write_wav(out_path, audio, cfg.audio_fs, stereo=False)
    print(f"wrote {out_path}: {audio.size} samples at {cfg.audio_fs} Hz "
          f"({audio.size / cfg.audio_fs:.2f} s), peak {np.abs(audio).max():.3f}")


if __name__ == "__main__":
    main()
