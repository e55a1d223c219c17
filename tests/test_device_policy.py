"""What the package assumes about the device it runs on: where the compile
cache lives, the published-peak table, the refusals of the measurement
entry points (bench.py, chip_smoke.py) on a device they were not written
for, the trace reduction, and that no accelerator-specific kernel or
backend branch is left in the package."""

import json
import os
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from experiments import tracekit
from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.utils import compile_cache
from real_time_sdr_tpu.utils.logging import (PEAKS, device_peaks,
                                             speed_of_light_report)

H100 = "NVIDIA H100 80GB HBM3"
PKG = os.path.join(compile_cache.CHECKOUT, "real_time_sdr_tpu")


def test_compile_cache_env_set_is_used_as_is(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []      # nothing set in code when the env names it


def test_compile_cache_env_unset_goes_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(compile_cache.CHECKOUT, ".jax_cache")
    assert compile_cache.enable() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    assert os.path.isfile(os.path.join(compile_cache.CHECKOUT,
                                       "chip_smoke.py"))


def _dev(platform, kind):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_chip_smoke_refuses_cpu_devices():
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_devices([_dev("cpu", "cpu")])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit):
        chip_smoke.check_devices(jax.devices())


def test_chip_smoke_accepts_gpu_and_counts_for_multi():
    one = [_dev("gpu", H100)]
    assert chip_smoke.check_devices(one) == {
        "platform": "gpu", "kind": H100, "count": 1}
    with pytest.raises(SystemExit):
        chip_smoke.check_devices(one, count=4)
    assert chip_smoke.check_devices(one * 4, count=4)["count"] == 4


def test_chip_smoke_result_line_shape():
    dev = chip_smoke.check_devices([_dev("gpu", H100)])
    line = chip_smoke.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": H100, "count": 1}}


def test_chip_smoke_shifted_streams_are_delayed_copies():
    from real_time_sdr_tpu.config import mode_config
    cfg = mode_config(0)
    streams, truth = chip_smoke.shifted_streams(cfg, 3, 1,
                                                ps_name="SHIFTED ")
    assert streams.shape == (3, 2 * cfg.block_size_iq)
    assert streams.dtype == np.uint8 and truth["ps_name"] == "SHIFTED "
    s = chip_smoke.SHIFT
    assert s % 2 == 0       # whole I/Q pairs
    np.testing.assert_array_equal(streams[1][:-s], streams[0][s:])
    np.testing.assert_array_equal(streams[2][:-s], streams[1][s:])


def test_chip_smoke_assert_parity():
    out = SimpleNamespace(left=np.sin(np.arange(100.0)),
                          right=np.cos(np.arange(100.0)),
                          rds_bits=np.ones((2, 5), np.int32),
                          rds_nbits=np.array([5, 3], np.int32))
    near = SimpleNamespace(**{**vars(out), "left": out.left * (1 + 1e-6)})
    assert chip_smoke.assert_parity("same", near, out, 90.0) > 110.0
    flipped = SimpleNamespace(**{**vars(out),
                                 "rds_bits": out.rds_bits.copy()})
    flipped.rds_bits[1, 2] = 0
    with pytest.raises(AssertionError):
        chip_smoke.assert_parity("bit flip", flipped, out, 90.0)
    with pytest.raises(AssertionError):
        chip_smoke.assert_parity(
            "tf32-like", SimpleNamespace(**{**vars(out),
                                            "left": out.left * 1.001}),
            out, 90.0)


def test_peak_table_known_kind():
    pk = device_peaks(H100)
    assert pk is PEAKS[H100]
    assert pk["bf16_flops"] == 989e12 and pk["f32_flops"] == 67e12
    assert pk["hbm_bps"] == 3.35e12 and pk["source"]


def test_peak_table_unknown_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("Some Future Accelerator")
    with pytest.raises(KeyError):
        device_peaks()      # the test host's CPU is not in the table


def test_speed_of_light_report_uses_card_rates(capsys):
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    sol = speed_of_light_report(rx, channels=32, blocks=12,
                                device_kind=H100)
    assert sol["floor_s"] > 0 and sol["ceiling_x"] > 1
    # f32 HIGHEST stages run at the f32 rate: the floor can be no lower
    # than their FLOPs over 67 TFLOP/s
    from real_time_sdr_tpu.utils.logging import stage_costs
    f32 = sum(c["flops"] for _, c in stage_costs(rx, channels=32)
              if c["kind"].startswith("fir_f32"))
    assert sol["floor_s"] >= f32 / 67e12
    assert "floor" in capsys.readouterr().err
    with pytest.raises(KeyError):
        speed_of_light_report(rx, device_kind="unknown accelerator")


def test_bench_refuses_cpu_without_flag(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--channels", "1", "--blocks", "1"])
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert out == ""        # no number printed
    assert "needs a gpu device" in err
    assert bench.require_platform(cpu=True) == (
        "cpu", jax.devices()[0].device_kind)


def test_tracekit_busy_is_interval_union():
    ev = [("s", "a", 0, 10), ("s", "b", 5, 10), ("s", "c", 30, 5),
          ("s", "d", 31, 2)]
    assert tracekit._busy_ns(ev) == 20
    assert tracekit._busy_ns([]) == 0


def test_no_accelerator_specific_code_left():
    """Plain JAX/XLA only: no Pallas import and no backend-name branch in
    the package, bench.py, examples/ or experiments/."""
    roots = [PKG, os.path.join(compile_cache.CHECKOUT, "examples"),
             os.path.join(compile_cache.CHECKOUT, "experiments")]
    files = [os.path.join(compile_cache.CHECKOUT, "bench.py")]
    for root in roots:
        for d, _, names in os.walk(root):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = re.compile(r"experimental\.pallas|default_backend\(\)|"
                     r"RTSDR_FRONTEND|RTSDR_FIR_(?!PREC)[A-Z]|RTSDR_FIR\"|"
                     r"RTSDR_CHAN_EPI")
    hits = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            hits += [f"{f}:{i}" for i, line in enumerate(fh, 1)
                     if bad.search(line)]
    assert hits == []


def test_wideband_group_default_is_ungrouped(monkeypatch):
    from real_time_sdr_tpu.parallel.channel import _default_wb_group
    monkeypatch.delenv("RTSDR_WB_GROUP", raising=False)
    assert _default_wb_group() == 0
    monkeypatch.setenv("RTSDR_WB_GROUP", "16")
    assert _default_wb_group() == 16
