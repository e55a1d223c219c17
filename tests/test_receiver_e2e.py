"""End-to-end receiver tests on synthetic FM multiplex fixtures.

The framework twin of the reference's listen-to-the-wav / read-the-stderr
validation (SURVEY.md section 4 'End-to-end'), made deterministic: synthesize
a station with known tones + RBDS groups, run the full jitted chain, assert
on recovered audio spectra and decoded protocol text.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.rds_framing import RdsFramer
from real_time_sdr_tpu.utils import synth
from real_time_sdr_tpu.utils.audio import stereo_pcm, mono_pcm


def dominant_tone(x, fs):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.fft.rfftfreq(len(x), 1 / fs)[sp.argmax()]


def band_power(x, fs, f, width=30.0):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    return sp[(freqs > f - width) & (freqs < f + width)].sum()


def run_rx(rx, iq, framer=None):
    nb = len(iq) // (2 * rx.cfg.block_size_iq)
    blocks = jnp.asarray(iq.reshape(nb, -1))
    state = rx.init_state()
    outs = []
    for b in range(nb):
        state, out = rx.jit_step(state, blocks[b])
        if framer is not None and out.rds_nbits is not None:
            n = int(out.rds_nbits)
            if n > 0:
                framer.feed(np.asarray(out.rds_bits)[:n])
        outs.append(out)
    return outs, state


@pytest.fixture(scope="module")
def stereo_rds_run():
    rx = Receiver(0, stereo=True, rds=True)
    iq, truth = synth.station_iq(
        rx.cfg, 30, ps_name="CHFI-FM ", pi=0x2B9A, pty=11,
        tone_left=440.0, tone_right=1200.0)
    framer = RdsFramer()
    outs, state = run_rx(rx, iq, framer)
    return rx, outs, framer, truth


def test_stereo_tones_recovered(stereo_rds_run):
    rx, outs, framer, truth = stereo_rds_run
    skip = 3 * rx.cfg.audio_block
    left = np.concatenate([np.asarray(o.left) for o in outs])[skip:]
    right = np.concatenate([np.asarray(o.right) for o in outs])[skip:]
    fs = float(rx.cfg.audio_fs)
    assert abs(dominant_tone(left, fs) - 440.0) < 5
    assert abs(dominant_tone(right, fs) - 1200.0) < 5
    # stereo separation: each tone must be >=15 dB down on the other channel
    sep_l = band_power(left, fs, 440) / band_power(right, fs, 440)
    sep_r = band_power(right, fs, 1200) / band_power(left, fs, 1200)
    assert sep_l > 30 and sep_r > 30


def test_rds_ps_and_pi_decoded(stereo_rds_run):
    rx, outs, framer, truth = stereo_rds_run
    assert framer.events.ps_name == truth["ps_name"]
    assert framer.events.pi == truth["pi"]
    assert framer.events.pty == "Oldies"
    assert framer.events.groups_decoded >= 4


def test_pcm_formatting(stereo_rds_run):
    rx, outs, framer, truth = stereo_rds_run
    pcm = stereo_pcm(outs[-1].left, outs[-1].right)
    assert pcm.dtype == jnp.int16
    assert pcm.shape[-1] == 2 * rx.cfg.audio_block
    inter = np.asarray(pcm)
    # even index left, odd right (src/stereo.cpp:100-107)
    np.testing.assert_array_equal(
        inter[0::2], np.asarray((16384 * outs[-1].left)).astype(np.int16))


def test_mono_receiver_tone():
    rx = Receiver(0, stereo=False, rds=False)
    n = rx.cfg.block_size_iq * 8
    t = np.arange(n) / rx.cfg.rf_fs
    tone = np.sin(2 * np.pi * 1000.0 * t)
    iq = synth.fm_iq(rx.cfg.rf_fs, n, mono=tone)
    outs, _ = run_rx(rx, iq)
    audio = np.concatenate([np.asarray(o.mono) for o in outs])
    audio = audio[2 * rx.cfg.audio_block:]
    assert abs(dominant_tone(audio, float(rx.cfg.audio_fs)) - 1000.0) < 5
    pcm = mono_pcm(jnp.asarray(audio))
    assert pcm.dtype == jnp.int16
    assert np.abs(np.asarray(pcm)).max() > 3000  # sane level


def test_mono_only_station_keeps_stereo_silent():
    # a pure-mono station through the stereo decoder: L == R (no phantom
    # stereo), both carrying the tone
    rx = Receiver(0, stereo=True, rds=False)
    n = rx.cfg.block_size_iq * 8
    t = np.arange(n) / rx.cfg.rf_fs
    tone = np.sin(2 * np.pi * 800.0 * t)
    iq = synth.fm_iq(rx.cfg.rf_fs, n, mono=tone)
    outs, _ = run_rx(rx, iq)
    skip = 3 * rx.cfg.audio_block
    left = np.concatenate([np.asarray(o.left) for o in outs])[skip:]
    right = np.concatenate([np.asarray(o.right) for o in outs])[skip:]
    fs = float(rx.cfg.audio_fs)
    assert abs(dominant_tone(left, fs) - 800.0) < 5
    diff_power = np.mean((left - right) ** 2)
    tone_power = np.mean(((left + right) / 2) ** 2)
    assert diff_power < tone_power * 0.02


@pytest.mark.slow
def test_radiotext_decoded():
    # one full cycle of 4 PS + 7 RadioText groups is ~1144 bits ~= 0.96 s;
    # 90 blocks (~2.75 s) covers warm-up plus two complete cycles
    rx = Receiver(0, stereo=True, rds=True)
    iq, truth = synth.station_iq(
        rx.cfg, 90, ps_name="JAX-SDR ", pi=0x1ABC, pty=2,
        radiotext="HELLO FROM THE JAX RECEIVER ")
    framer = RdsFramer()
    run_rx(rx, iq, framer)
    assert framer.events.ps_name == "JAX-SDR "
    assert framer.events.radiotext.startswith("HELLO FROM THE JAX RECEIVER")


def test_scan_runner_matches_stepwise():
    rx = Receiver(0, stereo=False, rds=False)
    iq, _ = synth.station_iq(rx.cfg, 4)
    blocks = jnp.asarray(iq.reshape(4, -1))
    s0 = rx.init_state()
    sA, outA = rx.jit_run_blocks(s0, blocks)
    sB = s0
    step_audio = []
    for b in range(4):
        sB, o = rx.jit_step(sB, blocks[b])
        step_audio.append(np.asarray(o.mono))
    np.testing.assert_allclose(np.asarray(outA.mono),
                               np.stack(step_audio), rtol=2e-4, atol=2e-5)
