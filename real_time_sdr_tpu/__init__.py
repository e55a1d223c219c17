"""real_time_sdr_tpu: a JAX/XLA FM broadcast receiver
framework — mono/stereo audio + RDS decoding — with the full capability
surface of the reference real-time-SDR project, re-designed for
accelerators (the package name records where it started).

Layers (see SURVEY.md for the reference layer map):
  config    — mode presets + derived static shapes
  ops       — DSP kernel library (FIR/polyphase, discriminator, PLL, PSD)
  models    — receiver chains (frontend, mono, stereo, RDS) as pure
              (state, block) -> (state, outputs) functions
  parallel  — channel-bank and time-axis sharding over a jax Mesh
  utils     — host I/O, streaming runtime bindings, observability
"""

from real_time_sdr_tpu.config import ReceiverConfig, mode_config

# Lazy top-level exports (PEP 562): the main user-facing classes without
# paying the jax import at package-import time.
_LAZY = {
    "Receiver": "real_time_sdr_tpu.models.receiver",
    "RdsFramer": "real_time_sdr_tpu.models.rds_framing",
    "SyncByOffsetDecoder": "real_time_sdr_tpu.models.rds_framing",
    "AltRdsReceiver": "real_time_sdr_tpu.models.rds_alt",
    "Channelizer": "real_time_sdr_tpu.models.channelizer",
    "ChannelBank": "real_time_sdr_tpu.parallel.channel",
    "time_sharded_run": "real_time_sdr_tpu.parallel.time_shard",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = ["ReceiverConfig", "mode_config", *_LAZY]
__version__ = "0.1.0"
