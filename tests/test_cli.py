"""CLI end-to-end: the reference's pipe workflow
(rtl_sdr | ./project <mode> <type> | aplay) driven through subprocesses."""

import os
import subprocess
import sys

import numpy as np
import pytest

from real_time_sdr_tpu.config import mode_config
from real_time_sdr_tpu.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# subprocess e2e: each process pays backend init + (cached) compiles
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def station_file(tmp_path_factory):
    cfg = mode_config(0)
    iq, truth = synth.station_iq(cfg, 24, ps_name="CLI-TEST", pi=0x6D0F,
                                 pty=3)
    p = tmp_path_factory.mktemp("iq") / "station.raw"
    iq.tofile(p)
    return p, truth, cfg


def run_cli(args, stdin_file):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(stdin_file, "rb") as f:
        return subprocess.run(
            [sys.executable, "-m", "real_time_sdr_tpu.cli", "--cpu", *args],
            stdin=f, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, timeout=600)


def test_cli_stereo_rds(station_file):
    path, truth, cfg = station_file
    r = run_cli(["0", "r"], path)
    assert r.returncode == 0
    pcm = np.frombuffer(r.stdout, dtype="<i2")
    assert len(pcm) == 24 * cfg.audio_block * 2  # stereo interleaved
    err = r.stderr.decode()
    assert "Program Service: CLI-TEST" in err
    assert "PI: 6d0f" in err
    assert "PTY: Sports" in err


def test_cli_pipeline_depth_identical(station_file):
    # deeper in-flight pipelining must not change a single output bit
    # (device programs complete in order; only the fetch point moves)
    path, truth, cfg = station_file
    r0 = run_cli(["0", "r", "--pipeline", "0", "--max-blocks", "8"], path)
    r4 = run_cli(["0", "r", "--pipeline", "4", "--max-blocks", "8"], path)
    assert r0.returncode == 0 and r4.returncode == 0
    assert r0.stdout == r4.stdout
    assert len(r0.stdout) == 8 * cfg.audio_block * 2 * 2


def test_cli_mono(station_file):
    path, truth, cfg = station_file
    r = run_cli(["0", "m", "--max-blocks", "6", "--stats"], path)
    assert r.returncode == 0
    pcm = np.frombuffer(r.stdout, dtype="<i2")
    assert len(pcm) == 6 * cfg.audio_block
    assert b"x real time" in r.stderr


def test_cli_checkpoint_resume(station_file, tmp_path):
    path, truth, cfg = station_file
    ckpt = tmp_path / "state.npz"
    r1 = run_cli(["0", "m", "--max-blocks", "4", "--checkpoint", str(ckpt)],
                 path)
    assert r1.returncode == 0
    assert ckpt.exists()
    r2 = run_cli(["0", "m", "--max-blocks", "4", "--checkpoint", str(ckpt)],
                 path)
    assert b"resumed state" in r2.stderr


def test_cli_bad_args(station_file):
    path, _, _ = station_file
    r = run_cli(["7", "m"], path)
    assert r.returncode != 0


def test_cli_defaults_to_mode0_mono(station_file):
    # no positionals => mode-0 mono, like the reference's argc<3 default
    # (src/project.cpp:46-47)
    path, truth, cfg = station_file
    r = run_cli(["--max-blocks", "3"], path)
    assert r.returncode == 0
    pcm = np.frombuffer(r.stdout, dtype="<i2")
    assert len(pcm) == 3 * cfg.audio_block  # mono, mode-0 audio rate


def test_cli_rejects_degenerate_flags():
    # validated before any jax/device work, so call main() in-process
    from real_time_sdr_tpu import cli
    assert cli.main(["0", "m", "--io-depth", "0"]) == 2
    assert cli.main(["0", "m", "--pipeline", "-1"]) == 2


def test_cli_wideband_multistation(tmp_path):
    from real_time_sdr_tpu.utils import synth as _synth

    cfg = mode_config(0)
    iw, qw, truths = _synth.wideband_iq(
        cfg, 4 * cfg.rf_fs,
        [dict(offset_hz=-2_000_000, ps_name="WIDE-A  ", pi=0xA0A0, pty=5),
         dict(offset_hz=1_500_000, ps_name="WIDE-B  ", pi=0xB0B0, pty=9)],
        26)
    iq = np.empty(2 * len(iw))
    iq[0::2] = iw
    iq[1::2] = qw
    u8 = np.clip(np.round(128 + 127 * iq), 0, 255).astype(np.uint8)
    wb = tmp_path / "wideband.raw"
    u8.tofile(wb)

    outdir = tmp_path / "stations"
    r = run_cli(["0", "r", "--stations=-2000000,1500000",
                 "--wide-fs", "9600000", "--output-dir", str(outdir)], wb)
    assert r.returncode == 0
    err = r.stderr.decode()
    assert "ch0 ps: WIDE-A" in err
    assert "ch1 ps: WIDE-B" in err
    for k in range(2):
        pcm = np.fromfile(outdir / f"station_{k}.pcm", "<i2")
        assert len(pcm) == 26 * cfg.audio_block * 2

    # pipelined dispatch (deferred fetches) must be byte-identical
    outdir2 = tmp_path / "stations_pipelined"
    r2 = run_cli(["0", "r", "--stations=-2000000,1500000",
                  "--wide-fs", "9600000", "--output-dir", str(outdir2),
                  "--pipeline", "4"], wb)
    assert r2.returncode == 0
    assert "ch0 ps: WIDE-A" in r2.stderr.decode()
    for k in range(2):
        a = (outdir / f"station_{k}.pcm").read_bytes()
        b = (outdir2 / f"station_{k}.pcm").read_bytes()
        assert a == b

    # segment serving (G wideband blocks per device call): same stream
    # semantics — audio agrees to int16 rounding (tier-1 PLL wrap points
    # move to call boundaries, the known f32-order difference) and the RDS
    # text decodes identically
    outdir3 = tmp_path / "stations_segmented"
    r3 = run_cli(["0", "r", "--stations=-2000000,1500000",
                  "--wide-fs", "9600000", "--output-dir", str(outdir3),
                  "--segment", "13"], wb)
    assert r3.returncode == 0
    assert "ch0 ps: WIDE-A" in r3.stderr.decode()
    assert "ch1 ps: WIDE-B" in r3.stderr.decode()
    for k in range(2):
        a = np.frombuffer((outdir / f"station_{k}.pcm").read_bytes(),
                          "<i2").astype(np.int32)
        c = np.frombuffer((outdir3 / f"station_{k}.pcm").read_bytes(),
                          "<i2").astype(np.int32)
        assert a.shape == c.shape
        assert np.abs(a - c).max() <= 8  # f32 wrap-order, ~4e-4 relative

    # EOF partial group (26 % 8 != 0): padded to the compiled segment
    # shape on dispatch, trimmed in the drain — output must still be
    # exactly 26 blocks of audio with the PS decoded
    outdir4 = tmp_path / "stations_eof_pad"
    r4 = run_cli(["0", "r", "--stations=-2000000,1500000",
                  "--wide-fs", "9600000", "--output-dir", str(outdir4),
                  "--segment", "8"], wb)
    assert r4.returncode == 0
    assert "ch0 ps: WIDE-A" in r4.stderr.decode()
    for k in range(2):
        pcm = np.fromfile(outdir4 / f"station_{k}.pcm", "<i2")
        assert len(pcm) == 26 * cfg.audio_block * 2


def test_cli_wideband_retune_midstream(tmp_path):
    """--retune SEG:STATION:HZ re-points one station mid-stream with no
    recompile: station 1 follows its old program in the first segments
    and the new transmitter's program after the retune point."""
    from real_time_sdr_tpu.utils import synth as _synth

    cfg = mode_config(0)
    sky = [dict(offset_hz=-600_000, tone_left=400.0, tone_right=400.0),
           dict(offset_hz=800_000, tone_left=900.0, tone_right=900.0),
           dict(offset_hz=1_200_000, tone_left=2500.0, tone_right=2500.0)]
    iw, qw, _ = _synth.wideband_iq(cfg, 4 * cfg.rf_fs, sky, 8)
    iq = np.empty(2 * len(iw))
    iq[0::2] = iw
    iq[1::2] = qw
    wb = tmp_path / "wideband.raw"
    np.clip(np.round(128 + 127 * iq), 0, 255).astype(np.uint8).tofile(wb)

    outdir = tmp_path / "stations"
    r = run_cli(["0", "m", "--stations=-600000,800000",
                 "--wide-fs", "9600000", "--output-dir", str(outdir),
                 "--segment", "4", "--retune", "1:1:1200000"], wb)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert "retuned station 1 -> 1200000 Hz at segment 1" in r.stderr.decode()

    pcm = np.fromfile(outdir / "station_1.pcm", "<i2").astype(np.float64)
    half = len(pcm) // 2

    def tone(x):
        sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        return np.fft.rfftfreq(len(x), 1 / float(cfg.audio_fs))[sp.argmax()]

    assert abs(tone(pcm[half // 3:half]) - 900.0) < 20
    assert abs(tone(pcm[half + half // 3:]) - 2500.0) < 20
    # station 0 never moved
    pcm0 = np.fromfile(outdir / "station_0.pcm", "<i2").astype(np.float64)
    assert abs(tone(pcm0[len(pcm0) // 3:]) - 400.0) < 20


def test_cli_wideband_corrupt_sidecar_starts_fresh(tmp_path):
    """A truncated/corrupt .rds.json must rebuild ALL framers (not leave
    half-loaded state) and still decode correctly."""
    from real_time_sdr_tpu.utils import synth as _synth

    cfg = mode_config(0)
    iw, qw, _ = _synth.wideband_iq(
        cfg, 4 * cfg.rf_fs,
        [dict(offset_hz=-1_000_000, ps_name="FRESH-OK", pi=0xC1C1, pty=2)],
        26)
    iq = np.empty(2 * len(iw))
    iq[0::2] = iw
    iq[1::2] = qw
    wb = tmp_path / "wb.raw"
    np.clip(np.round(128 + 127 * iq), 0, 255).astype(np.uint8).tofile(wb)

    ck = tmp_path / "ck"
    args = ["0", "r", "--stations=-1000000", "--wide-fs", "9600000",
            "--output-dir", str(tmp_path / "out"), "--checkpoint", str(ck),
            "--warmup"]  # also covers the wideband compile-before-consume path
    r1 = run_cli(args, wb)
    assert r1.returncode == 0
    assert b"warmed up (compiled)" in r1.stderr
    assert (tmp_path / "ck.rds.json").exists()
    # corrupt the sidecar: truncated JSON (e.g. a crash mid-write without
    # the atomic rename)
    (tmp_path / "ck.rds.json").write_text('{"kind": "wideband", "framers"')
    (tmp_path / "ck.npz").unlink()  # DSP state fresh too: clean restart
    r2 = run_cli(args, wb)
    assert r2.returncode == 0
    err = r2.stderr.decode()
    assert "starting fresh" in err
    assert "ch0 ps: FRESH-OK" in err  # rebuilt framers still decode


def test_cli_mode2_stereo_rds(tmp_path):
    """A non-mode-0 rate preset (fractional audio resample) end-to-end
    through the CLI pipe contract."""
    from real_time_sdr_tpu.utils import synth as _synth

    cfg2 = mode_config(2)
    n_blk = 40  # mode-2 blocks carry fewer groups each; PS needs 4 segments
    iq, _ = _synth.station_iq(cfg2, n_blk, ps_name="MODE2-OK", pi=0x9292,
                              pty=7)
    p = tmp_path / "m2.raw"
    iq.tofile(p)
    r = run_cli(["2", "r", "--output", str(tmp_path / "m2.pcm")], p)
    assert r.returncode == 0
    err = r.stderr.decode()
    assert "PI: 9292" in err
    assert "Program Service: MODE2-OK" in err
    pcm = np.fromfile(tmp_path / "m2.pcm", "<i2")
    assert len(pcm) == n_blk * cfg2.audio_block * 2
    assert np.abs(pcm).max() > 1000  # real audio, not silence


def test_cli_survives_pure_noise(tmp_path):
    """Tuned to static: random IQ must stream through the full stereo+RDS
    chain without a crash, producing the right PCM byte count (protocol
    events on garbage are statistically possible but the decoder must not
    wedge or error)."""
    cfg = mode_config(0)
    rng = np.random.default_rng(11)
    nb = 8
    rng.integers(0, 256, size=nb * 2 * cfg.block_size_iq,
                 dtype=np.uint8).tofile(tmp_path / "noise.raw")
    r = run_cli(["0", "r", "--output", str(tmp_path / "n.pcm")],
                tmp_path / "noise.raw")
    assert r.returncode == 0
    assert len(np.fromfile(tmp_path / "n.pcm", "<i2")) == (
        nb * cfg.audio_block * 2)


def test_cli_segment_serving_identical(station_file):
    # --segment G (one device call per G blocks, the remote-attachment
    # serving shape): same stream semantics as per-block calls. Audio
    # agrees to int16 rounding (the tier-1 PLL wraps phase mod 4*pi at
    # call rather than block boundaries — the f32-reduction-order
    # difference test_segment_mode pins at library level); RDS text is
    # identical.
    path, truth, cfg = station_file
    r1 = run_cli(["0", "r", "--max-blocks", "12"], path)
    rg = run_cli(["0", "r", "--segment", "4", "--max-blocks", "12"], path)
    assert r1.returncode == 0 and rg.returncode == 0
    a = np.frombuffer(r1.stdout, dtype="<i2").astype(np.int32)
    b = np.frombuffer(rg.stdout, dtype="<i2").astype(np.int32)
    assert len(b) == 12 * cfg.audio_block * 2  # stereo interleaved samples
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2, np.abs(a - b).max()

    def rds_lines(r):
        return [ln for ln in r.stderr.decode().splitlines()
                if ln.startswith(("PI:", "PTY:", "Program Service:",
                                  "RadioText:", "RDS summary:"))]

    assert rds_lines(rg) == rds_lines(r1)  # identical decode trail
    assert rds_lines(rg), "no RDS events decoded in either mode"


def test_cli_partial_tail_group_padded(station_file):
    """A stream whose length is NOT a multiple of --segment ends with a
    partial group; the CLI pads it to the compiled segment shape (a
    fresh tail-shape compile costs seconds through a remote device) and
    trims the pad's PCM — output length must be EXACTLY the real block
    count and the decode trail identical to per-block serving."""
    path, truth, cfg = station_file
    r1 = run_cli(["0", "r", "--max-blocks", "14"], path)
    rg = run_cli(["0", "r", "--segment", "4", "--max-blocks", "14"], path)
    assert r1.returncode == 0 and rg.returncode == 0
    b = np.frombuffer(rg.stdout, dtype="<i2").astype(np.int32)
    assert len(b) == 14 * cfg.audio_block * 2  # pad trimmed exactly
    a = np.frombuffer(r1.stdout, dtype="<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 2, np.abs(a - b).max()

    def rds_lines(r):
        return [ln for ln in r.stderr.decode().splitlines()
                if ln.startswith(("PI:", "PTY:", "Program Service:"))]

    assert rds_lines(rg) == rds_lines(r1)
    assert rds_lines(rg), "no RDS events decoded"


def test_cli_incompatible_checkpoint_starts_fresh(station_file, tmp_path):
    """A checkpoint from an older state layout (or a corrupt npz) must warn
    and start fresh, not crash the stream (carried-state pytrees may gain
    or lose leaves across releases — e.g. the tier-3 sync collapse)."""
    path, truth, cfg = station_file
    ckpt = tmp_path / "state.npz"
    np.savez(ckpt, bogus=np.zeros(3, np.float32))
    r = run_cli(["0", "m", "--max-blocks", "3", "--checkpoint", str(ckpt)],
                path)
    assert r.returncode == 0
    assert b"starting fresh" in r.stderr
    pcm = np.frombuffer(r.stdout, dtype="<i2")
    assert len(pcm) == 3 * cfg.audio_block
