"""Test harness config: force the CPU backend with 8 virtual devices so the
multi-device sharding paths compile and execute without accelerator
hardware. The override goes through jax.config *before* backend
initialization, so it holds whatever JAX_PLATFORMS says.
"""

import pytest

import jax

from real_time_sdr_tpu.utils import compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
compile_cache.enable()


def pytest_collection_modifyitems(items):
    """Everything not marked slow is the smoke set: `-m smoke` keeps the
    inner loop to a few minutes; `pytest tests/ -q` still runs it all."""
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.smoke)


def mk_channelizer(cfg, wide_fs, offs, fold: bool):
    """Construct a Channelizer with the fold mode pinned via its env knob
    (read once at __init__); shared by the channelizer/parallel suites."""
    import os
    from real_time_sdr_tpu.models.channelizer import Channelizer

    key = "RTSDR_CHAN_FOLD"
    old = os.environ.get(key)
    os.environ[key] = "1" if fold else "0"
    try:
        ch = Channelizer(cfg, wide_fs, offs)
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old
    assert ch.fold == fold
    return ch
