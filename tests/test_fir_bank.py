"""FIRBank and PolyFIR against the golden float64 loop oracle.

Geometry coverage mirrors every bank the receiver builds: the IF BPF
triple sharing one frame matrix (down=1), the mode-0/1 audio decimators
(down=5/9), the RDS 247/640 baseband resampler and the RRC, plus plain
decimating PolyFIRs at down 1/5/10.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from golden import dsp
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops.fir import FIRBank, PolyFIR

_RNG = np.random.default_rng(7)


def _golden(f: PolyFIR, x, tail):
    if f.up == 1:
        return dsp.fir_block(x, f._h, tail, f.down)[0]
    return dsp.fir_resample_block(x, f._h, tail, f.up, f.down)[0]


def _check(firs, n, batch=()):
    """Every bank output against the oracle at each batch index; the one
    shared tail is the input history."""
    bank = FIRBank(firs)
    x = _RNG.standard_normal(batch + (n,))
    tail = _RNG.standard_normal(batch + (bank.tail_len,))
    ys, new_tail = bank(jnp.asarray(x, jnp.float32),
                        jnp.asarray(tail, jnp.float32))
    assert len(ys) == len(firs)
    for f, y in zip(firs, ys):
        y = np.asarray(y, np.float64)
        assert y.shape == batch + ((n * f.up) // f.down,)
        for idx in np.ndindex(*batch):
            ref = _golden(f, x[idx], tail[idx])
            err = np.max(np.abs(y[idx] - ref))
            assert err <= 1e-5 * max(np.max(np.abs(ref)), 1.0), err
    np.testing.assert_array_equal(
        np.asarray(new_tail),
        np.concatenate([tail, x], -1)[..., -bank.tail_len:].astype(
            np.float32))


def test_if_bpf_triple_shared_frames():
    fs = 240e3
    firs = [PolyFIR(filters.design_bpf(fs, 18.5e3, 19.5e3, 101)),
            PolyFIR(filters.design_bpf(fs, 22e3, 54e3, 101)),
            PolyFIR(filters.design_bpf(fs, 54e3, 60e3, 101))]
    _check(firs, 7350, batch=(3,))


def test_audio_decimator_mode0():
    h = filters.design_lpf(240e3, 16e3, 101)
    _check([PolyFIR(h, up=1, down=5)], 7350 * 4)


def test_audio_decimator_mode1():
    h = filters.design_lpf(360e3, 16e3, 101)
    _check([PolyFIR(h, up=1, down=9)], 360 * 49)


def test_rds_baseband_247_640():
    h = filters.design_lpf(240e3 * 247, 3e3, 101 * 247, gain=247)
    _check([PolyFIR(h, up=247, down=640)], 7350, batch=(2,))


def test_rrc_multibatch():
    rrc = filters.design_rrc(92625, 101, symbol_rate=2375, beta=0.9)
    _check([PolyFIR(rrc)], 2836, batch=(2, 3))


@pytest.mark.parametrize("down", [1, 5, 10])
def test_polyfir_matches_golden(down):
    rng = np.random.default_rng(1)
    K, N, C = 101, 2560, 2
    h = rng.standard_normal(K)
    x = rng.standard_normal((C, N)).astype(np.float32)
    tail = rng.standard_normal((C, K - 1)).astype(np.float32)
    y, _ = PolyFIR(h, up=1, down=down)(jnp.asarray(x), jnp.asarray(tail))
    for c in range(C):
        ref, _ = dsp.fir_block(x[c], h, tail[c].astype(np.float64), down)
        np.testing.assert_allclose(np.asarray(y)[c], ref, atol=5e-5)


def test_f32_precision_default_is_highest():
    """Exact f32 unless RTSDR_FIR_PREC asks otherwise: on a GPU an f32 dot
    without a precision may run in TF32."""
    import jax
    from real_time_sdr_tpu.ops import fir
    assert fir._F32_PREC_NAME == "highest"
    assert fir._f32_precision() == jax.lax.Precision.HIGHEST
