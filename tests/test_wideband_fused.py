"""Fused wideband frontend (models/wideband_frontend.py): one wide-rate
matmul from the capture straight to per-station IF demod — correctness vs
a float64 cascade oracle, segment continuity, bf16 mode, checkpointing,
and end-to-end decode through ChannelBank.run_channelized_fused."""

import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.rds_framing import RdsFramer
from real_time_sdr_tpu.models.wideband_frontend import (
    FusedWidebandFrontend, FusedWidebandState)
from real_time_sdr_tpu.parallel.channel import ChannelBank
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.utils import synth


def _oracle_demod(cfg, iw, qw, wide_fs, offsets):
    """Float64 two-stage cascade: mix -> channelizer LPF decimate D ->
    frontend LPF decimate rf_decim -> quadrature discriminator. The fused
    path must equal this (it IS this cascade, folded into one matmul)."""
    p = int(wide_fs)
    d = p // cfg.rf_fs
    down = cfg.rf_decim
    h_c = np.asarray(filters.design_lpf(p, cfg.rf_fs / 2 * 0.8,
                                        cfg.rf_taps * 2 + 1), np.float64)
    h_f = np.asarray(filters.design_lpf(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps),
                     np.float64)
    x = iw.astype(np.float64) + 1j * qw.astype(np.float64)
    n = x.shape[0]
    k = np.arange(n, dtype=np.int64)
    outs = []
    for f in offsets:
        fr = int(f) % p
        tone = np.exp(-2j * np.pi * ((fr * k) % p).astype(np.float64) / p)
        b = x * tone
        y1 = np.convolve(b, h_c)[:n:d]                    # y[m]=sum h[t]b[mD-t]
        n1 = n // d
        y2 = np.convolve(y1, h_f)[:n1:down]
        iq = y2[: n1 // down]
        i_s, q_s = iq.real, iq.imag
        ip = np.concatenate([[0.0], i_s[:-1]])
        qp = np.concatenate([[0.0], q_s[:-1]])
        num = i_s * (q_s - qp) - q_s * (i_s - ip)
        den = i_s * i_s + q_s * q_s
        outs.append(np.where((i_s == 0) & (q_s == 0), 0.0,
                             num / np.where(den == 0, 1.0, den)))
    return np.stack(outs)


def _mk(cfg, wide_fs, offs, dtype="f32"):
    return FusedWidebandFrontend(cfg, wide_fs, offs, compute_dtype=dtype)


def test_fused_demod_matches_float64_oracle():
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_700_000, 800_000, 2_300_000]      # 100 kHz raster
    wf = _mk(cfg, wide_fs, offs)
    assert wf.lo <= 12

    rng = np.random.default_rng(11)
    n = 2 * cfg.block_size_iq * wf.decim
    iw = rng.standard_normal(n).astype(np.float32) * 0.3
    qw = rng.standard_normal(n).astype(np.float32) * 0.3

    demod, st = wf(jnp.asarray(iw), jnp.asarray(qw), wf.init_state())
    assert demod.shape == (3, n // wf.dt)
    ref = _oracle_demod(cfg, iw, qw, wide_fs, offs)
    for s in range(len(offs)):
        a, b = np.asarray(demod)[s], ref[s]
        snr = 10 * np.log10(np.mean(b ** 2) /
                            (np.mean((a - b) ** 2) + 1e-30))
        assert snr > 80, f"station {s}: {snr:.1f} dB"
    assert int(st.pos) == (n // wf.dt) % wf.lo


def test_fused_segment_continuity():
    """Two chained segment calls must equal one double-length call —
    the raw-rail tail, carried discriminator samples, and the residual
    pos-rotation all line up across the boundary."""
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_300_000, 2_300_000]
    wf = _mk(cfg, wide_fs, offs)
    # 1-block segments move pos by a non-multiple of lo (the rotation
    # residual is exercised, not vacuous)
    assert (cfg.block_size_iq // cfg.rf_decim) % wf.lo != 0

    rng = np.random.default_rng(17)
    n = 2 * cfg.block_size_iq * wf.decim
    iw = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.3)

    full, _ = wf(iw, qw, wf.init_state())
    st = wf.init_state()
    parts = []
    for seg in (slice(0, n // 2), slice(n // 2, n)):
        d, st = wf(iw[seg], qw[seg], st)
        parts.append(np.asarray(d))
    got = np.concatenate(parts, axis=-1)
    a, b = got, np.asarray(full)
    snr = 10 * np.log10(np.mean(b ** 2) / (np.mean((a - b) ** 2) + 1e-30))
    # not bit-exact: XLA's f32 K-reduction blocking differs with the
    # frame-count (M) dimension; 100 dB == pure f32 rounding
    assert snr > 100, f"split-vs-single {snr:.1f} dB"


def test_fused_bf16_parity_and_dtypes():
    """bf16 weights/rails (the opt-in RTSDR_WB_FIR=bf16 mode) vs f32-HIGHEST: the
    injected noise must stay comparable to the uint8 hop it replaces
    (~-49 dB); bf16x2 (hi+lo split taps) must land between the two.
    Output demod and all state leaves stay f32 (npz contract)."""
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_700_000, 800_000]
    # a REAL FM multiplex input: the discriminator is num/den and den is
    # the squared envelope — on noise input den passes near zero and the
    # bf16-vs-f32 comparison is ill-conditioned (measured 6.5 dB on
    # noise, >35 dB on FM signal); FM signals have constant envelope
    stations = [dict(offset_hz=o, ps_name="PARITY-T", pi=0x1234, pty=1,
                     tone_left=700.0, tone_right=700.0) for o in offs]
    iw_np, qw_np, _ = synth.wideband_iq(cfg, wide_fs, stations, 3)
    iw, qw = jnp.asarray(iw_np), jnp.asarray(qw_np)

    d_f32, _ = _mk(cfg, wide_fs, offs, "f32")(iw, qw,
                                              _mk(cfg, wide_fs, offs,
                                                  "f32").init_state())
    for dtype, bound in (("bf16", 35), ("bf16x2", 45)):
        wf = _mk(cfg, wide_fs, offs, dtype)
        d, st = wf(iw, qw, wf.init_state())
        assert d.dtype == jnp.float32
        for leaf in jax.tree_util.tree_leaves(st):
            assert leaf.dtype in (jnp.float32, jnp.int32)
        a, b = np.asarray(d), np.asarray(d_f32)
        snr = 10 * np.log10(np.mean(b ** 2) /
                            (np.mean((a - b) ** 2) + 1e-30))
        assert snr > bound, f"{dtype}: {snr:.1f} dB"


def test_fused_state_checkpoint_roundtrip():
    from real_time_sdr_tpu.utils.state import save_state, load_state

    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_300_000, 800_000]
    wf = _mk(cfg, wide_fs, offs)
    rng = np.random.default_rng(29)
    n = cfg.block_size_iq * wf.decim
    iw = jnp.asarray(rng.standard_normal(2 * n).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal(2 * n).astype(np.float32) * 0.3)

    _, st = wf(iw[:n], qw[:n], wf.init_state())
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "wb_state")
        save_state(p, st)
        st2 = load_state(p, wf.init_state())
    d_a, _ = wf(iw[n:], qw[n:], st)
    d_b, _ = wf(iw[n:], qw[n:], st2)
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))


def test_fused_eligibility():
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    assert FusedWidebandFrontend.eligible(cfg, wide_fs, [-300_000, 100_000])
    # a pathological off-raster offset blows the IF-rate tone lcm
    assert not FusedWidebandFrontend.eligible(cfg, wide_fs, [7])
    with pytest.raises(ValueError):
        FusedWidebandFrontend(cfg, wide_fs, [7])


def test_wideband_u8_ingest_matches_rails():
    """run_wideband_u8_jit (live ingest: raw interleaved bytes up the
    link, device-side stride-slice deinterleave — u8_to_rails) must
    equal the f32-rails entry bit-for-bit (the normalize (x-128)/128 is
    the exact same arithmetic host or device), for BOTH frontends,
    including carried state across a segment boundary."""
    from real_time_sdr_tpu.models.channelizer import Channelizer
    from real_time_sdr_tpu.parallel.channel import ChannelBank

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_700_000, 800_000]
    rng = np.random.default_rng(31)
    n = 2 * cfg.block_size_iq * (wide_fs // cfg.rf_fs)
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    x = (raw.astype(np.float32) - 128.0) / 128.0
    iw, qw = jnp.asarray(x[0::2]), jnp.asarray(x[1::2])

    for fe in (_mk(cfg, wide_fs, offs), Channelizer(cfg, wide_fs, offs)):
        bank = ChannelBank(rx, n_channels=2)
        sa, ba = fe.init_state(), rx.init_state(batch=(2,))
        sb, bb = fe.init_state(), rx.init_state(batch=(2,))
        for k in range(2):
            s2 = slice(k * n // 2, (k + 1) * n // 2)
            s2b = slice(k * n, (k + 1) * n)
            ba, out_a, sa = bank.run_wideband_jit(ba, fe, iw[s2], qw[s2],
                                                  sa)
            bb, out_b, sb = bank.run_wideband_u8_jit(
                bb, fe, jnp.asarray(raw[s2b]), sb, group=0)
            np.testing.assert_allclose(np.asarray(out_a.left),
                                       np.asarray(out_b.left), atol=2e-6)
            np.testing.assert_array_equal(np.asarray(out_a.rds_bits),
                                          np.asarray(out_b.rds_bits))


def test_fused_grouped_bank_matches_ungrouped():
    """run_channelized_fused(group=g) — the lax.map cache-locality
    sub-batching — must produce the ungrouped outputs (same per-station
    work, different batching): audio to f32 tolerance, RDS bits equal."""
    from real_time_sdr_tpu.parallel.channel import ChannelBank

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_700_000, -600_000, 800_000, 2_300_000]
    wf = _mk(cfg, wide_fs, offs)
    bank = ChannelBank(rx, n_channels=4)
    rng = np.random.default_rng(19)
    n = cfg.block_size_iq * wf.decim
    iw = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.2)
    qw = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.2)

    bs_a, out_a, _ = bank.run_channelized_fused(
        bank.init_state(), wf, iw, qw, wf.init_state())
    bs_b, out_b, _ = bank.run_channelized_fused(
        bank.init_state(), wf, iw, qw, wf.init_state(), group=2)
    a, b = np.asarray(out_a.left), np.asarray(out_b.left)
    snr = 10 * np.log10(np.mean(a ** 2) / (np.mean((a - b) ** 2) + 1e-30))
    assert snr > 100, f"grouped audio diverges {snr:.1f} dB"
    np.testing.assert_array_equal(np.asarray(out_a.rds_bits),
                                  np.asarray(out_b.rds_bits))
    for la, lb in zip(jax.tree_util.tree_leaves(bs_a),
                      jax.tree_util.tree_leaves(bs_b)):
        assert la.shape == lb.shape


def test_sharded_fused_wideband_matches_unsharded():
    """ShardedFusedWideband (fused frontend + bank in ONE mesh
    computation, station axis sharded over 8 devices via shard_map on
    the weight columns) must equal the unsharded fused chain: audio to
    f32 tolerance, RDS bit decisions equal — across two carried-state
    segments."""
    from jax.sharding import Mesh
    from real_time_sdr_tpu.parallel.wideband import ShardedFusedWideband

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    n_st = 8
    offs = [int((k - (n_st - 1) / 2) * 300_000) for k in range(n_st)]
    wf = _mk(cfg, wide_fs, offs)

    rng = np.random.default_rng(13)
    nseg = 2 * cfg.block_size_iq * wf.decim
    iw = rng.standard_normal(2 * nseg).astype(np.float32) * 0.2
    qw = rng.standard_normal(2 * nseg).astype(np.float32) * 0.2

    mesh = Mesh(np.array(jax.devices()), ("ch",))
    sw = ShardedFusedWideband(wf, rx, mesh)
    ws, bs = sw.init_state()
    leaf = jax.tree_util.tree_leaves(bs)[0]
    assert len(leaf.sharding.device_set) == 8, leaf.sharding
    assert len(ws.prev_i.sharding.device_set) == 8, ws.prev_i.sharding

    from real_time_sdr_tpu.parallel.channel import ChannelBank
    bank = ChannelBank(rx, n_st)
    ws_u, bs_u = wf.init_state(), rx.init_state(batch=(n_st,))

    for seg in (slice(0, nseg), slice(nseg, 2 * nseg)):
        ws, bs, out = sw.step(ws, bs, iw[seg], qw[seg])
        bs_u, out_u, ws_u = bank.run_channelized_fused(
            bs_u, wf, jnp.asarray(iw[seg]), jnp.asarray(qw[seg]), ws_u)
        a, b = np.asarray(out.left), np.asarray(out_u.left)
        snr = 10 * np.log10(np.mean(b ** 2) /
                            (np.mean((a - b) ** 2) + 1e-30))
        assert snr > 70, f"{seg}: sharded audio diverges {snr:.1f} dB"
        np.testing.assert_array_equal(np.asarray(out.rds_nbits),
                                      np.asarray(out_u.rds_nbits))
        np.testing.assert_array_equal(np.asarray(out.rds_bits),
                                      np.asarray(out_u.rds_bits))
        np.testing.assert_array_equal(np.asarray(ws.pos),
                                      np.asarray(ws_u.pos))


@pytest.mark.slow
def test_fused_adjacent_channel_interferer():
    """+20 dB adjacent-channel interferer one raster step away: the
    combined channelizer*frontend filter must isolate the weak station
    for full stereo + RDS PS decode (the fused path's selectivity is the
    cascade's — both filters apply before the discriminator)."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    stations = [
        dict(offset_hz=-400_000, ps_name="WEAK-OK ", pi=0x3E3E, pty=4,
             tone_left=700.0, tone_right=700.0, amp=1.0),
        dict(offset_hz=-200_000, ps_name="LOUD-ADJ", pi=0x4F4F, pty=8,
             tone_left=1800.0, tone_right=1800.0, amp=10.0),  # +20 dB
    ]
    nb = 26
    iw, qw, truths = synth.wideband_iq(cfg, wide_fs, stations, nb)
    wf = _mk(cfg, wide_fs, [s["offset_hz"] for s in stations])
    bank = ChannelBank(rx, n_channels=2)
    state, out, _ = bank.run_channelized_fused(
        bank.init_state(), wf, jnp.asarray(iw), jnp.asarray(qw),
        wf.init_state())
    fs = float(cfg.audio_fs)
    for s_idx, (truth, tone_hz) in enumerate(zip(truths, (700.0, 1800.0))):
        left = np.asarray(out.left)[s_idx]
        left = left[len(left) // 3:]
        sp = np.abs(np.fft.rfft(left * np.hanning(len(left))))
        tone = np.fft.rfftfreq(len(left), 1 / fs)[sp.argmax()]
        assert abs(tone - tone_hz) < 10, f"station {s_idx}: tone {tone:.0f}"
        framer = RdsFramer()
        bits = np.asarray(out.rds_bits)[s_idx]
        nbs = np.asarray(out.rds_nbits)[s_idx]
        for b in range(bits.shape[0]):
            if nbs[b] > 0:
                framer.feed(bits[b][:nbs[b]])
        assert framer.events.ps_name == truth["ps_name"], f"station {s_idx}"
        assert framer.events.pi == truth["pi"]


@pytest.mark.slow
def test_fused_decode_survives_tuner_artifacts():
    """Datasheet-typical RTL-SDR tuner artifacts (IQ imbalance, DC
    offset, phase noise, AWGN) applied to the WIDEBAND capture: the
    fused serving path must still decode PS on both stations — extends
    the station-path tuner gates (tests/test_noise_ber.py) to the
    wideband frontend."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    stations = [
        dict(offset_hz=-1_700_000, ps_name="TUNER-A ", pi=0x8181, pty=3,
             tone_left=440.0, tone_right=440.0),
        dict(offset_hz=2_300_000, ps_name="TUNER-B ", pi=0x8282, pty=6,
             tone_left=900.0, tone_right=900.0),
    ]
    nb = 26
    iw, qw, truths = synth.wideband_iq(cfg, wide_fs, stations, nb)
    x = np.empty(2 * iw.shape[0], np.float32)
    x[0::2], x[1::2] = iw, qw
    u8 = np.clip(np.round(128.0 + 127.0 * x), 0, 255).astype(np.uint8)
    u8 = synth.impair_iq(
        u8, wide_fs, iq_gain_db=0.5, iq_phase_deg=2.0,
        dc_offset=0.02 + 0.015j, phase_noise_linewidth_hz=50.0,
        noise_std=0.02, seed=7)
    xi = (u8.astype(np.float32) - 128.0) / 128.0

    wf = _mk(cfg, wide_fs, [s["offset_hz"] for s in stations])
    bank = ChannelBank(rx, n_channels=2)
    _, out, _ = bank.run_channelized_fused(
        bank.init_state(), wf, jnp.asarray(xi[0::2]), jnp.asarray(xi[1::2]),
        wf.init_state())
    for s_idx, truth in enumerate(truths):
        framer = RdsFramer()
        bits = np.asarray(out.rds_bits)[s_idx]
        nbs = np.asarray(out.rds_nbits)[s_idx]
        for b in range(bits.shape[0]):
            if nbs[b] > 0:
                framer.feed(bits[b][:nbs[b]])
        assert framer.events.ps_name == truth["ps_name"], (
            f"station {s_idx}: {framer.events.ps_name!r}")
        assert framer.events.pi == truth["pi"]


@pytest.mark.slow
def test_fused_channelize_and_decode_two_stations():
    """End-to-end: wideband capture -> fused frontend -> ChannelBank
    audio+RDS decode; stereo tones and PS names must come out, matching
    the uint8 two-stage path's decisions (the fused path skips the uint8
    re-quantization, so audio is compared by decode results, not bits)."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    stations = [
        dict(offset_hz=-1_700_000, ps_name="STATION1", pi=0x1111, pty=5,
             tone_left=440.0, tone_right=440.0),
        dict(offset_hz=2_300_000, ps_name="STATION2", pi=0x2222, pty=9,
             tone_left=900.0, tone_right=900.0),
    ]
    nb = 26
    iw, qw, truths = synth.wideband_iq(cfg, wide_fs, stations, nb)

    wf = _mk(cfg, wide_fs, [s["offset_hz"] for s in stations])
    bank = ChannelBank(rx, n_channels=2)
    state, out, wstate = bank.run_channelized_fused(
        bank.init_state(), wf, jnp.asarray(iw), jnp.asarray(qw),
        wf.init_state())

    fs = float(cfg.audio_fs)
    for s_idx, truth in enumerate(truths):
        left = np.asarray(out.left)[s_idx]
        left = left[len(left) // 3:]
        sp = np.abs(np.fft.rfft(left * np.hanning(len(left))))
        tone = np.fft.rfftfreq(len(left), 1 / fs)[sp.argmax()]
        expected = 440.0 if s_idx == 0 else 900.0
        assert abs(tone - expected) < 10
        framer = RdsFramer()
        bits = np.asarray(out.rds_bits)[s_idx]
        nbs = np.asarray(out.rds_nbits)[s_idx]
        for b in range(bits.shape[0]):
            if nbs[b] > 0:
                framer.feed(bits[b][:nbs[b]])
        assert framer.events.ps_name == truth["ps_name"], f"station {s_idx}"
        assert framer.events.pi == truth["pi"]
