"""Wideband channelizer: extract and fully decode multiple stations from a
single capture (the north-star multi-station configuration)."""

import numpy as np
import jax.numpy as jnp
import pytest

from real_time_sdr_tpu.models.channelizer import Channelizer
from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.rds_framing import RdsFramer
from real_time_sdr_tpu.parallel.channel import ChannelBank
from real_time_sdr_tpu.utils import synth
from conftest import mk_channelizer as _mk_chan


@pytest.mark.slow
def test_channelize_and_decode_two_stations():
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs  # 9.6 MS/s capture
    stations = [
        dict(offset_hz=-1_700_000, ps_name="STATION1", pi=0x1111, pty=5,
             tone_left=440.0, tone_right=440.0),
        dict(offset_hz=2_300_000, ps_name="STATION2", pi=0x2222, pty=9,
             tone_left=900.0, tone_right=900.0),
    ]
    nb = 26
    iw, qw, truths = synth.wideband_iq(cfg, wide_fs, stations, nb)

    ch = Channelizer(cfg, wide_fs, [s["offset_hz"] for s in stations])
    (i_ds, q_ds), _ = ch(jnp.asarray(iw), jnp.asarray(qw), ch.init_state())
    u8 = ch.to_uint8(i_ds, q_ds)  # (2, 2*nb*block_size_iq)

    bank = ChannelBank(rx, n_channels=2)
    state, out = bank.run_segment(bank.init_state(), u8)

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


@pytest.mark.slow
def test_adjacent_channel_interferer():
    """A +20 dB adjacent-channel interferer 200 kHz away (one FM raster
    step): the channelizer's decimation filter must isolate the weak
    station well enough for full stereo + RDS PS decode (VERDICT r2 #7)."""
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

    ch = Channelizer(cfg, wide_fs, [s["offset_hz"] for s in stations])
    (i_ds, q_ds), _ = ch(jnp.asarray(iw), jnp.asarray(qw), ch.init_state())
    u8 = ch.to_uint8(i_ds, q_ds)

    bank = ChannelBank(rx, n_channels=2)
    state, out = bank.run_segment(bank.init_state(), u8)

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


def test_periodic_tone_mode_matches_general():
    """Integer station grids select the periodic-exact tone mode (static
    (S, lcm) tables + ONE carried integer position, O(S*lcm) memory);
    its mixed/decimated output must match the general full-table+phasor
    mechanism, including across segment boundaries where the periodic
    carry is integer-exact."""
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_700_000, 300_000, 2_300_000]  # 100 kHz raster
    ch_p = Channelizer(cfg, wide_fs, offs)
    assert ch_p.tone_period and ch_p.tone_period <= 96, ch_p.tone_period
    ch_g = Channelizer(cfg, wide_fs, offs)
    ch_g.tone_period = 0  # force the general phasor path

    rng = np.random.default_rng(5)
    n = 2 * cfg.block_size_iq * ch_p.decim
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)

    sp, sg = ch_p.init_state(), ch_g.init_state()
    for seg in (slice(0, n // 2), slice(n // 2, n)):
        (ip, qp), sp = ch_p(iw[seg], qw[seg], sp)
        (ig, qg), sg = ch_g(iw[seg], qw[seg], sg)
        for a, b in ((ip, ig), (qp, qg)):
            a, b = np.asarray(a), np.asarray(b)
            snr = 10 * np.log10(np.mean(b ** 2) /
                                (np.mean((a - b) ** 2) + 1e-30))
            assert snr > 110, f"{seg}: {snr:.1f} dB"


def test_bf16_channelizer_fir_parity():
    """The opt-in bf16 channelizer FIR (RTSDR_CHAN_FIR=bf16): output stays
    f32 and agrees with the f32-HIGHEST path above the uint8 re-encode
    floor (~-49 dB), and the carried tails stay f32 in the state pytree
    (the npz round-trip rule)."""
    import os as _os
    import jax as _jax

    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_000_000, 1_500_000]
    _os.environ["RTSDR_CHAN_FIR"] = "bf16"
    try:
        ch_b = Channelizer(cfg, wide_fs, offs)
    finally:
        del _os.environ["RTSDR_CHAN_FIR"]
    assert ch_b.fir.compute_dtype == "bf16"
    ch_f = Channelizer(cfg, wide_fs, offs)
    assert ch_f.fir.compute_dtype == "f32"  # the default

    rng = np.random.default_rng(9)
    n = 2 * cfg.block_size_iq * ch_b.decim
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)

    sb, sf = ch_b.init_state(), ch_f.init_state()
    for seg in (slice(0, n // 2), slice(n // 2, n)):
        (ib, qb), sb = ch_b(iw[seg], qw[seg], sb)
        (if_, qf), sf = ch_f(iw[seg], qw[seg], sf)
        assert ib.dtype == jnp.float32 and qb.dtype == jnp.float32
        for a, b in ((ib, if_), (qb, qf)):
            a, b = np.asarray(a), np.asarray(b)
            snr = 10 * np.log10(np.mean(b ** 2) /
                                (np.mean((a - b) ** 2) + 1e-30))
            assert snr > 45, f"{seg}: bf16-vs-f32 {snr:.1f} dB"
    for leaf, name in ((sb.i_tails, "i_tails"), (sb.q_tails, "q_tails")):
        assert leaf.dtype == jnp.float32, name  # state contract preserved


def test_fold_matches_mix_then_filter():
    """EXPLICIT fold==mix parity (VERDICT r3 #1): the folded-tone
    channelizer (tone folded into per-station complex bandpass taps +
    decimated-rate tone) must equal mix-then-filter sample-for-sample,
    including across segment boundaries where the two paths carry
    different state shapes (raw-rail tail + output-rate pos vs per-station
    tails + input-rate pos)."""
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 8 * cfg.rf_fs  # 19.2 MS/s, the 64-station capture rate
    offs = [-3_700_000, -1_300_000, 800_000, 2_300_000]  # 100 kHz raster
    ch_f = _mk_chan(cfg, wide_fs, offs, fold=True)
    ch_m = _mk_chan(cfg, wide_fs, offs, fold=False)
    assert ch_f.tone_period == ch_m.tone_period > 0

    rng = np.random.default_rng(33)
    n = 3 * cfg.block_size_iq * ch_f.decim
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)

    sf, sm = ch_f.init_state(), ch_m.init_state()
    segs = (slice(0, n // 3), slice(n // 3, 2 * n // 3),
            slice(2 * n // 3, n))
    for seg in segs:
        (i_f, q_f), sf = ch_f(iw[seg], qw[seg], sf)
        (i_m, q_m), sm = ch_m(iw[seg], qw[seg], sm)
        for a, b, rail in ((i_f, i_m, "i"), (q_f, q_m, "q")):
            a, b = np.asarray(a), np.asarray(b)
            snr = 10 * np.log10(np.mean(b ** 2) /
                                (np.mean((a - b) ** 2) + 1e-30))
            assert snr > 110, f"{seg} {rail}: fold-vs-mix {snr:.1f} dB"


def test_fold_runtime_tone_matches_mix():
    """The runtime-tone fold fallback (RTSDR_CHAN_FOLD_STATIC=0, used
    when the output-rate tone lcm exceeds the promotion cap) must also
    equal mix-then-filter — keeps the non-static branch covered now that
    real rasters default to the static-tone fold."""
    import os as _os
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 8 * cfg.rf_fs
    offs = [-3_700_000, 800_000, 2_300_000]
    _os.environ["RTSDR_CHAN_FOLD_STATIC"] = "0"
    try:
        ch_f = _mk_chan(cfg, wide_fs, offs, fold=True)
    finally:
        del _os.environ["RTSDR_CHAN_FOLD_STATIC"]
    assert not ch_f._fold_static
    ch_m = _mk_chan(cfg, wide_fs, offs, fold=False)

    rng = np.random.default_rng(41)
    n = 2 * cfg.block_size_iq * ch_f.decim
    iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.3)
    sf, sm = ch_f.init_state(), ch_m.init_state()
    for seg in (slice(0, n // 2), slice(n // 2, n)):
        (i_f, q_f), sf = ch_f(iw[seg], qw[seg], sf)
        (i_m, q_m), sm = ch_m(iw[seg], qw[seg], sm)
        for a, b, rail in ((i_f, i_m, "i"), (q_f, q_m, "q")):
            a, b = np.asarray(a), np.asarray(b)
            snr = 10 * np.log10(np.mean(b ** 2) /
                                (np.mean((a - b) ** 2) + 1e-30))
            assert snr > 110, f"{seg} {rail}: runtime-fold {snr:.1f} dB"


def test_call_u8_bit_exact_vs_two_step():
    """call_u8 (fused quantize-before-transpose epilogue) must be
    BIT-IDENTICAL to to_uint8(*__call__) in every tone mode — the
    quantization commutes elementwise with the relayout — including
    across segments where the static-fold residual pos-rotation is
    non-trivial (1-block segments shift pos by block_size % lo != 0)."""
    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 8 * cfg.rf_fs
    offs = [-3_700_000, -1_300_000, 800_000, 2_300_000]  # lo=24: static
    for fold in (True, False):
        ch = _mk_chan(cfg, wide_fs, offs, fold=fold)
        if fold:
            assert ch._fold_static
            assert cfg.block_size_iq % ch._fold_L != 0  # pos moves
        rng = np.random.default_rng(5)
        n = 2 * cfg.block_size_iq * ch.decim
        iw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * .3)
        qw = jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * .3)
        sa = sb = ch.init_state()
        for seg in (slice(0, n // 2), slice(n // 2, n)):
            u8_a, sa = ch.call_u8(iw[seg], qw[seg], sa)
            (i_ds, q_ds), sb = ch(iw[seg], qw[seg], sb)
            u8_b = ch.to_uint8(i_ds, q_ds)
            np.testing.assert_array_equal(np.asarray(u8_a),
                                          np.asarray(u8_b))
        import jax
        for la, lb in zip(jax.tree_util.tree_leaves(sa),
                          jax.tree_util.tree_leaves(sb)):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_fold_state_checkpoint_roundtrip():
    """Fold-mode ChannelizerState (raw-rail (1, T-1) tails + output-rate
    pos) must round-trip through utils/state.py save/load (the npz state
    contract rule) and keep producing identical output."""
    import tempfile, os as _os
    from real_time_sdr_tpu.utils.state import save_state, load_state

    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_700_000, 2_300_000]
    ch = _mk_chan(cfg, wide_fs, offs, fold=True)

    rng = np.random.default_rng(7)
    n = cfg.block_size_iq * ch.decim
    iw = jnp.asarray(rng.standard_normal((2 * n,)).astype(np.float32) * 0.3)
    qw = jnp.asarray(rng.standard_normal((2 * n,)).astype(np.float32) * 0.3)

    _, st = ch(iw[:n], qw[:n], ch.init_state())
    with tempfile.TemporaryDirectory() as td:
        p = _os.path.join(td, "chan_state")
        save_state(p, st)
        st2 = load_state(p, ch.init_state())
    (i_a, q_a), _ = ch(iw[n:], qw[n:], st)
    (i_b, q_b), _ = ch(iw[n:], qw[n:], st2)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))
    np.testing.assert_array_equal(np.asarray(q_a), np.asarray(q_b))


def test_channelizer_matches_float64_oracle():
    """Device channelizer (framed-matmul FIR + periodic-exact tones,
    f32/bf16) vs the float64 direct-convolution oracle in golden/chain.py
    — including the cross-segment tone/tail continuity (two device calls
    against the oracle's single pass)."""
    from golden.chain import run_channelizer

    rx = Receiver(0, stereo=False, rds=False)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-1_300_000, 800_000]
    ch = Channelizer(cfg, wide_fs, offs)

    rng = np.random.default_rng(21)
    n = 2 * cfg.block_size_iq * ch.decim
    iw = rng.standard_normal(n).astype(np.float32) * 0.3
    qw = rng.standard_normal(n).astype(np.float32) * 0.3

    st = ch.init_state()
    halves = []
    for seg in (slice(0, n // 2), slice(n // 2, n)):
        (i_ds, q_ds), st = ch(jnp.asarray(iw[seg]), jnp.asarray(qw[seg]), st)
        halves.append(np.asarray(i_ds) + 1j * np.asarray(q_ds))
    got = np.concatenate(halves, axis=-1)

    ref = run_channelizer(cfg, iw, qw, wide_fs, offs)
    assert got.shape == ref.shape
    # skip the filter warm-up transient (zero tails vs the oracle's
    # implicit zero prefix match exactly, but keep the bound honest)
    for s in range(len(offs)):
        a, b = got[s], ref[s]
        err = np.mean(np.abs(a - b) ** 2)
        sig = np.mean(np.abs(b) ** 2)
        snr = 10 * np.log10(sig / (err + 1e-30))
        # f32 device vs f64 oracle; bf16 mode still clears ~45 dB
        bound = 45 if ch.fir.compute_dtype == "bf16" else 90
        assert snr > bound, f"station {s}: {snr:.1f} dB"
