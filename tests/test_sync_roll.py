"""Pin the scalar-rotation ramp tables (RTSDR_SYNC_ROLL=rot, the default)
against the bit-exact dynamic-slice roll (=slice).

The rot mode replaced seven vmapped dynamic_slice table rolls (each an XLA
while-loop gather) with ONE scalar rotation of static tiled tables —
faster — but it is an *approximation*:
cos(th_s + th_j) expanded by the angle-sum identity carries ~1e-6 f32
product rounding vs the exact per-phase table values. These tests bound
that error class at both production operating points (stereo 19 kHz
nco_scale=2, RDS 114 kHz nco_scale=0.5), prove it does NOT accumulate
across a long segment (the carried trig counter is integer-exact, so every
block's rotation starts from an exact phase), and require the end-to-end
RDS bit decisions to be identical under both settings (the project's
post-slicer bit-exactness rule).

Note on the angle table: rot and slice may differ by exactly 4*pi at
isolated samples where th_start + th_j rounds across the canonical [0,4*pi)
boundary. That is NOT an error for any consumer: the phase feeds
cos(nco_scale * phase) with nco_scale in {0.5, 1, 2}, all 4*pi-periodic
(the half-angle RDS consumer is the binding case — 2*pi parity is
load-bearing there, 4*pi is invariant). The deviation bound is therefore
taken mod 4*pi.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp

from real_time_sdr_tpu.ops.pll import PllParams
from real_time_sdr_tpu.ops import sync as sync_mod

_FOUR_PI = 4.0 * math.pi

STEREO = PllParams(freq=19_000, fs=240_000, nco_scale=2.0, norm_bw=0.01)
RDS = PllParams(freq=114_000, fs=240_000, nco_scale=0.5, norm_bw=0.001)


def _mk(monkeypatch, mode: str, p: PllParams) -> sync_mod.FeedforwardSync:
    monkeypatch.setenv("RTSDR_SYNC_ROLL", mode)
    s = sync_mod.FeedforwardSync(p)
    assert s._roll_mode == mode
    return s


@pytest.mark.parametrize("p", [STEREO, RDS], ids=["stereo", "rds"])
def test_ramp_table_deviation_bounded(monkeypatch, p):
    rot = _mk(monkeypatch, "rot", p)
    sl = _mk(monkeypatch, "slice", p)
    n = 6 * p.period + 1717   # several table periods, non-aligned length
    starts = [0, 1, 137 % p.period, p.period - 1, 12345 % p.period]
    for start in starts:
        s = jnp.asarray(start, jnp.int32)
        cr, sr = rot._ramp_cos_sin(p, s, n)
        cs, ss = sl._ramp_cos_sin(p, s, n)
        assert float(jnp.abs(cr - cs).max()) < 5e-6
        assert float(jnp.abs(sr - ss).max()) < 5e-6
        d = np.asarray(rot._ramp_angle(p, s, n)
                       - sl._ramp_angle(p, s, n), np.float64)
        dev = np.abs(d - _FOUR_PI * np.round(d / _FOUR_PI)).max()
        assert dev < 1e-5


@pytest.mark.parametrize("p", [STEREO, RDS], ids=["stereo", "rds"])
def test_carrier_deviation_does_not_accumulate(monkeypatch, p):
    """60 carried blocks: rot-vs-slice carrier deviation stays at the
    single-rotation f32 rounding level in EVERY block — the integer trig
    carry means each block's rotation starts from an exact phase, so there
    is no drift mechanism. Measured ~1.9e-6 max at authoring time."""
    rot = _mk(monkeypatch, "rot", p)
    sl = _mk(monkeypatch, "slice", p)
    rng = np.random.default_rng(0)
    n, nb = 5120, 60
    t = np.arange(n * nb)
    wander = 0.3 * np.sin(2 * np.pi * t / (n * 7.3))
    x = (np.cos(2 * np.pi * p.freq * t / p.fs + wander)
         + 0.02 * rng.standard_normal(n * nb)).astype(np.float32)
    cr, cs = rot.init(), sl.init()
    devs = []
    for b in range(nb):
        xb = jnp.asarray(x[b * n:(b + 1) * n])
        yr, cr = rot(xb, cr)
        ys, cs = sl(xb, cs)
        devs.append(float(jnp.abs(yr - ys).max()))
    devs = np.asarray(devs)
    assert devs.max() < 1e-5                      # bounded everywhere
    assert devs[-10:].max() < devs[:10].max() * 3 + 1e-6   # no growth
    # the carried residual/trig state must agree too (mod the same class)
    assert abs(int(cr.trig) - int(cs.trig)) == 0


def test_rds_bits_identical_rot_vs_slice(monkeypatch):
    """Full receiver decode (tier-3 sync, mode 0): the post-slicer RDS bit
    stream must be IDENTICAL under both roll modes — the ~1e-6 carrier
    rounding is ~6 orders below the slicer's decision margin."""
    from real_time_sdr_tpu.models.receiver import Receiver
    from real_time_sdr_tpu.utils import synth

    outs = {}
    for mode in ("rot", "slice"):
        monkeypatch.setenv("RTSDR_SYNC_ROLL", mode)
        rx = Receiver(0, stereo=True, rds=True)
        iq, _ = synth.station_iq(rx.cfg, 16, ps_name="ROLLTEST",
                                 pi=0x1234, pty=2)
        _, out = rx.run_segment(rx.init_state(), jnp.asarray(iq))
        outs[mode] = (np.asarray(out.rds_bits), np.asarray(out.rds_nbits))
    assert np.array_equal(outs["rot"][1], outs["slice"][1])
    nb = outs["rot"][1]
    bits_r, bits_s = outs["rot"][0], outs["slice"][0]
    for b in range(bits_r.shape[0]):
        assert np.array_equal(bits_r[b][:nb[b]], bits_s[b][:nb[b]]), b
