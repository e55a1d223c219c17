"""Auxiliary component parity: Fourier wrappers, binary I/O, logging,
signal generators, and the alternative sync-by-offset RDS decoder."""

import os

import numpy as np
import jax.numpy as jnp

from real_time_sdr_tpu.models.rds_framing import SyncByOffsetDecoder
from real_time_sdr_tpu.ops import fourier
from real_time_sdr_tpu.utils import io as rtio
from real_time_sdr_tpu.utils import synth
from real_time_sdr_tpu.utils.logging import BlockTimer, log_vector


def test_fft_equivalence_ladder():
    # the reference's test strategy: implementations agree with the naive DFT
    # (test/fft_unittest.cpp:53-90 — with a real epsilon, not their 10-2)
    x = synth.random_samples(512, seed=3) + 1j * synth.random_samples(
        512, seed=4)
    ref = fourier.dft_naive(x)
    xc = jnp.asarray(x.astype(np.complex64))
    # every rung of the transform ladder agrees with the float64 oracle:
    # XLA FFT, the matmul DFT, and the Stockham autosort radix-2
    for fn in (fourier.fft, fourier.dft_matmul, fourier.fft_stockham):
        got = np.asarray(fn(xc))
        np.testing.assert_allclose(got, ref, atol=1e-2)
    # real-input batch path (the PSD's shape): matmul == stockham == fft
    xb = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
    fref = np.asarray(jnp.fft.fft(xb))
    np.testing.assert_allclose(np.asarray(fourier.dft_matmul(xb)), fref,
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(fourier.fft_stockham(xb)), fref,
                               atol=1e-2)
    # IDFT(DFT(x)) ~= x (test/idft_unittest.cpp:50-60)
    back = np.asarray(fourier.idft(fourier.dft(
        jnp.asarray(x.astype(np.complex64)))))
    np.testing.assert_allclose(back, x, atol=1e-4)
    assert np.asarray(fourier.magnitude(jnp.asarray(ref))).min() >= 0
    # Parseval energy check (model/fourierTransform.py:219-228): time-domain
    # energy == spectrum energy / N, for every rung of the ladder
    e_time = float(np.sum(np.abs(x) ** 2))
    for fn in (fourier.fft, fourier.dft_matmul, fourier.fft_stockham):
        e_freq = float(np.sum(np.abs(np.asarray(fn(xc))) ** 2)) / len(x)
        np.testing.assert_allclose(e_freq, e_time, rtol=1e-4)


def test_bin_io_roundtrip(tmp_path):
    data = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    p = str(tmp_path / "dump.bin")
    rtio.write_bin_f32(p, data)
    np.testing.assert_array_equal(rtio.read_bin_f32(p), data)
    iqp = str(tmp_path / "cap.raw")
    iq = np.random.default_rng(1).integers(0, 256, 2000).astype(np.uint8)
    rtio.write_iq_u8(iqp, iq)
    np.testing.assert_array_equal(rtio.read_iq_u8(iqp), iq)
    np.testing.assert_array_equal(rtio.read_iq_u8(iqp, max_pairs=10),
                                  iq[:20])


def test_wav_export(tmp_path):
    import wave
    p = str(tmp_path / "a.wav")
    rtio.write_wav(p, np.sin(np.arange(4800) * 0.1), 48000)
    with wave.open(p) as w:
        assert w.getframerate() == 48000
        assert w.getnchannels() == 1
        assert w.getnframes() == 4800


def test_log_vector(tmp_path):
    p = log_vector("probe", [1.0, 2.5, -3.0], out_dir=str(tmp_path))
    lines = open(p).read().strip().splitlines()
    assert lines[1].split("\t") == ["0", "1"]
    assert len(lines) == 4


def test_block_timer():
    bt = BlockTimer(budget_s=0.030625)
    for _ in range(3):
        with bt.block():
            pass
    assert bt.realtime_factor > 1
    assert "3 blocks" in bt.summary()


def test_generators():
    s = synth.generate_sin(48e3, 1000.0, 480)
    assert abs(s).max() <= 1.0
    multi = synth.add_sin(48e3, [1000.0, 2000.0], 480, amplitudes=[1, 0.5])
    assert multi.shape == (480,)
    r = synth.random_samples(100, max_value=2.0, seed=1)
    assert (np.abs(r) <= 2.0).all()


def test_sync_by_offset_decoder_lifecycle():
    events = []
    dec = SyncByOffsetDecoder(on_event=lambda k, v: events.append((k, v)))
    groups = synth.ps_groups(0x8421, 7, "ALTRDS  ")
    bits = [b for g in groups for b in synth.group_to_bits(g)]
    rng = np.random.default_rng(0)
    dec.feed(np.array(list(rng.integers(0, 2, 41)) + bits * 3))
    assert dec.synced
    assert dec.events.ps_name == "ALTRDS  "
    assert dec.events.pi == 0x8421
    assert ("sync", events[0][1]) == events[0]
    # sustained garbage loses sync (>40 bad of 50, src/rds_utilities.cpp:293)
    dec.feed(rng.integers(0, 2, 26 * 60))
    assert not dec.synced
    assert any(k == "sync_lost" for k, _ in events)
    # and clean bits re-acquire
    dec.feed(np.array(bits * 3))
    assert dec.synced


def test_sync_by_offset_tolerates_bit_errors():
    # a few corrupted blocks must not break sync (only groups are dropped)
    dec = SyncByOffsetDecoder()
    groups = synth.ps_groups(0x5A5A, 3, "ROBUST  ")
    bits = np.array([b for g in groups for b in synth.group_to_bits(g)] * 6)
    bits[500] ^= 1
    bits[1201] ^= 1
    dec.feed(bits)
    assert dec.synced
    assert dec.events.ps_name == "ROBUST  "


def test_rate_change_cross_mode_decode():
    # a mode-0 capture resampled to mode-3's rate decodes correctly
    # (fmRateChange.py workflow)
    import jax.numpy as jnp
    from real_time_sdr_tpu.config import mode_config
    from real_time_sdr_tpu.models.receiver import Receiver
    cfg0, cfg3 = mode_config(0), mode_config(3)
    iq0, _ = synth.station_iq(cfg0, 8, tone_left=600.0, tone_right=600.0)
    iq3 = synth.rate_change(iq0, cfg0.rf_fs, cfg3.rf_fs)
    rx = Receiver(3, stereo=False, rds=False)
    nb = len(iq3) // (2 * cfg3.block_size_iq)
    _, out = rx.run_segment(rx.init_state(),
                            jnp.asarray(iq3[:nb * 2 * cfg3.block_size_iq]))
    a = np.asarray(out.mono)[cfg3.audio_block:]
    sp = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1 / float(cfg3.audio_fs))[sp.argmax()]
    assert abs(f - 600.0) < 10


def test_print_vectors(capsys):
    rtio.print_real_vector(np.arange(20.0))
    rtio.print_complex_vector(np.arange(3) + 1j)
    out = capsys.readouterr().out
    assert "(20 total)" in out and "+1j" in out
