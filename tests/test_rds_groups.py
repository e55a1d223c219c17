"""Group-type coverage beyond the reference's PS parser: version-B layouts
(0B/2B, transmitted under the C' offset word) and 4A clock-time/date.

The reference parses type 0 only (src/rds_utilities.cpp:172-199); its models
add 2A RadioText (model/OurRDSOurDSP.py:486-528). These tests pin the
RBDS-standard extensions both framers now share via _GroupParsing.
"""

import datetime

import numpy as np

from real_time_sdr_tpu.models.rds_framing import (RdsFramer,
                                                  SyncByOffsetDecoder,
                                                  mjd_to_date)
from real_time_sdr_tpu.utils import synth

_MJD_EPOCH_ORDINAL = datetime.date(1858, 11, 17).toordinal()


def _feed(framer, groups, repeats=2):
    bits = []
    for _ in range(repeats):
        for g in groups:
            bits.extend(synth.group_to_bits(g))
    rng = np.random.default_rng(7)
    stream = list(rng.integers(0, 2, 31)) + bits
    framer.feed(np.asarray(stream, dtype=np.int8))
    return framer


def test_mjd_conversion_round_trips_against_datetime():
    for ordinal in range(datetime.date(1990, 1, 1).toordinal(),
                         datetime.date(2035, 1, 1).toordinal(), 97):
        day = datetime.date.fromordinal(ordinal)
        mjd = synth.date_to_mjd(day.year, day.month, day.day)
        assert mjd == ordinal - _MJD_EPOCH_ORDINAL
        assert mjd_to_date(mjd) == (day.year, day.month, day.day)


def test_clocktime_group_decodes_in_both_framers():
    g = synth.clocktime_group(0x54A8, 5, 2026, 8, 18, 14, 37,
                              offset_half_hours=-9)
    for framer in (RdsFramer(), SyncByOffsetDecoder()):
        _feed(framer, [g], repeats=4)
        assert framer.events.clock_utc == "2026-08-18 14:37 UTC-4.5", \
            type(framer).__name__
        assert framer.events.pi == 0x54A8


def test_clocktime_rejects_invalid_fields():
    g = synth.clocktime_group(0x54A8, 5, 2026, 8, 18, 14, 37)
    g[3] = (g[3] & ~(0x3F << 6)) | (61 << 6)  # minute = 61: invalid
    fr = _feed(RdsFramer(), [g], repeats=4)
    assert fr.events.clock_utc is None
    assert fr.events.groups_decoded > 0  # the group itself was assembled


def test_radiotext_2b_decodes_in_both_framers():
    groups = synth.radiotext_2b_groups(0x3100, 1, "SHORT 2B MESSAGE")
    for framer in (RdsFramer(), SyncByOffsetDecoder()):
        _feed(framer, groups)
        assert framer.events.radiotext.startswith("SHORT 2B MESSAGE"), \
            type(framer).__name__


def test_version_b_groups_use_c_prime_offset():
    """Block 3 of a version-B group must carry the C' offset word."""
    g = synth.encode_group(0x1000, 2, 0, 0, 0x1000, 0x4142, version_b=True)
    bits = synth.group_to_bits(g)
    block3 = 0
    for b in bits[52:78]:
        block3 = (block3 << 1) | b
    check = block3 & 0x3FF
    from real_time_sdr_tpu.ops.rds_bits import _crc_remainder
    assert check == (_crc_remainder(0x1000, 16) ^ 0x350)  # C', not C (0x168)


def test_type0_flags_af_and_di_decode():
    groups = synth.ps_groups(0x54A8, 5, "FLAGTEST",
                             af_mhz=(98.1, 101.5, 87.6), tp=True, ta=True,
                             music=True, di=0b1010)
    for framer in (RdsFramer(), SyncByOffsetDecoder()):
        _feed(framer, groups, repeats=2)
        ev = framer.events
        assert ev.ps_name == "FLAGTEST", type(framer).__name__
        assert ev.traffic_program is True
        assert ev.traffic_announcement is True
        assert ev.music is True
        assert ev.di == 0b1010
        assert ev.alt_freqs_mhz == (87.6, 98.1, 101.5)


def test_type0_defaults_leave_flags_off_and_af_empty():
    fr = _feed(RdsFramer(), synth.ps_groups(0x54A8, 5, "PLAINPSN"),
               repeats=2)
    ev = fr.events
    assert ev.ps_name == "PLAINPSN"
    assert ev.traffic_program is False and ev.traffic_announcement is False
    assert ev.music is False and ev.di == 0
    assert ev.alt_freqs_mhz == ()


def test_burst_error_table_is_collision_free():
    from real_time_sdr_tpu.models.rds_framing import burst_error_table
    table = burst_error_table()
    # bursts spanning <=5 bits in 26 positions: 26+25+2*24+4*23+8*22
    assert len(table) == 26 + 25 + 2 * 24 + 4 * 23 + 8 * 22  # 367, no alias
    from real_time_sdr_tpu.ops.rds_bits import _crc_remainder
    for syn, (pattern, length) in list(table.items())[::17]:
        assert _crc_remainder(pattern, 26) == syn
        span = pattern.bit_length() - (pattern & -pattern).bit_length() + 1
        assert span == length <= 5


def _bits_with_burst(groups, repeats, block_idx, burst, offset_in_block=4):
    bits = []
    for _ in range(repeats):
        for g in groups:
            bits.extend(synth.group_to_bits(g))
    out = np.asarray(bits, dtype=np.int8)
    pos = block_idx * 26 + offset_in_block
    out[pos:pos + len(burst)] ^= np.asarray(burst, dtype=np.int8)
    return out


def test_burst_correction_recovers_groups_in_both_framers():
    groups = synth.ps_groups(0x54A8, 5, "FIXEDPSN")
    # corrupt 2 adjacent bits inside block 6 (a data block mid-stream)
    dirty = _bits_with_burst(groups, 3, block_idx=6, burst=[1, 1])
    for cls in (RdsFramer, SyncByOffsetDecoder):
        fixed = cls()
        fixed.feed(dirty)
        assert fixed.events.blocks_corrected >= 1, cls.__name__
        assert fixed.events.ps_name == "FIXEDPSN", cls.__name__


def test_burst_correction_respects_max_span():
    groups = synth.ps_groups(0x54A8, 5, "SPANSPAN")
    # a 5-bit burst: beyond the default <=2 limit, within the code's 5
    dirty = _bits_with_burst(groups, 3, block_idx=6, burst=[1, 0, 1, 0, 1])
    fr = RdsFramer()  # default correct_bursts=2
    fr.feed(dirty)
    assert fr.events.blocks_corrected == 0
    fr5 = RdsFramer(correct_bursts=5)
    fr5.feed(dirty)
    assert fr5.events.blocks_corrected >= 1
    assert fr5.events.ps_name == "SPANSPAN"
    off = RdsFramer(correct_bursts=0)
    off.feed(dirty)
    assert off.events.blocks_corrected == 0


def test_burst_correction_improves_group_survival_at_ber():
    """At BER 3e-3 most failures are single-bit: correction should roughly
    triple group survival (analytically 73% -> 99% for 4-block groups)."""
    rng = np.random.default_rng(3)
    groups = synth.ps_groups(0x54A8, 5, "SURVIVAL") * 60  # 240 groups
    bits = np.asarray([b for g in groups for b in synth.group_to_bits(g)],
                      dtype=np.int8)
    noisy = bits ^ (rng.random(len(bits)) < 3e-3).astype(np.int8)
    plain = RdsFramer(correct_bursts=0)
    plain.feed(noisy)
    corr = RdsFramer()
    corr.feed(noisy)
    assert corr.events.blocks_corrected > 10
    assert corr.events.groups_decoded > plain.events.groups_decoded * 1.2
    assert corr.events.groups_decoded > 0.9 * len(groups)


def test_framers_survive_random_streams_and_recover():
    """Fuzz: arbitrary bit garbage must never raise, corrupt parser state,
    or prevent re-acquisition once a clean signal returns."""
    rng = np.random.default_rng(42)
    groups = synth.ps_groups(0x54A8, 5, "RECOVERY")
    clean = []
    for _ in range(3):
        for g in groups:
            clean.extend(synth.group_to_bits(g))
    for framer in (RdsFramer(), SyncByOffsetDecoder()):
        # phase 1: pure noise in awkward chunk sizes (incl. empty)
        for size in (0, 1, 7, 25, 26, 27, 104, 1000):
            framer.feed(rng.integers(0, 2, size).astype(np.int8))
        # phase 2: clean groups with bit errors sprinkled in
        noisy = np.asarray(clean, dtype=np.int8)
        flip = rng.integers(0, len(noisy), 12)
        noisy[flip] ^= 1
        framer.feed(noisy)
        # phase 3: clean signal again -> must decode
        framer.feed(np.asarray(clean, dtype=np.int8))
        assert framer.events.ps_name == "RECOVERY", type(framer).__name__


def test_radiotext_ab_flag_toggle_clears_old_message():
    """Spec: toggling the type-2 text A/B flag announces a NEW message;
    receivers must clear the previous text rather than interleave."""
    long_msg = "NOW PLAYING: A VERY LONG SONG TITLE HERE"
    short_msg = "SONG TWO"
    for framer in (RdsFramer(), SyncByOffsetDecoder()):
        _feed(framer, synth.radiotext_groups(0x3100, 1, long_msg, ab_flag=0))
        assert framer.events.radiotext.rstrip() == long_msg
        # message switch arrives on the SAME contiguous bit stream (a real
        # transmitter keeps block alignment across messages)
        cont = [b for g in synth.radiotext_groups(0x3100, 1, short_msg,
                                                  ab_flag=1) * 2
                for b in synth.group_to_bits(g)]
        framer.feed(np.asarray(cont, dtype=np.int8))
        assert framer.events.radiotext.rstrip() == short_msg, \
            type(framer).__name__  # no residue of the long message


def test_framer_state_roundtrips_through_json():
    """Checkpoint/resume for the host framers: splitting the bit stream at
    an awkward point (mid-group) and JSON-round-tripping the state must
    give identical events to an uninterrupted decode."""
    import json

    pi, pty = 0x2B1C, 9
    groups = (synth.ps_groups(pi, pty, "RESUMED!", af_mhz=(99.9,))
              + synth.radiotext_groups(pi, pty, "SPLIT ACROSS RUNS")
              + [synth.clocktime_group(pi, pty, 2026, 8, 18, 3, 7)])
    bits = []
    for _ in range(3):
        for g in groups:
            bits.extend(synth.group_to_bits(g))
    rng = np.random.default_rng(5)
    stream = np.asarray(list(rng.integers(0, 2, 31)) + bits, dtype=np.int8)
    cut = len(stream) // 2 + 13  # mid-block, mid-group

    for cls in (RdsFramer, SyncByOffsetDecoder):
        whole = cls()
        whole.feed(stream)

        first = cls()
        first.feed(stream[:cut])
        blob = json.dumps(first.state_dict())  # through real JSON
        resumed = cls()
        resumed.load_state_dict(json.loads(blob))
        resumed.feed(stream[cut:])

        assert resumed.events == whole.events, cls.__name__
        # and the internal walk state converged too: both decode nothing
        # further from an empty feed
        resumed.feed(np.zeros(0, dtype=np.int8))


def test_mixed_group_schedule_full_station_metadata():
    """A realistic schedule: PS + 2A RadioText + CT interleaved."""
    pi, pty = 0x2B1C, 9
    groups = (synth.ps_groups(pi, pty, "JAX SDR ")
              + synth.radiotext_groups(pi, pty, "ALL GROUP TYPES AT ONCE")
              + [synth.clocktime_group(pi, pty, 2031, 12, 31, 23, 59,
                                       offset_half_hours=2)])
    fr = _feed(RdsFramer(), groups, repeats=2)
    assert fr.events.ps_name == "JAX SDR "
    assert fr.events.radiotext.startswith("ALL GROUP TYPES AT ONCE")
    assert fr.events.clock_utc == "2031-12-31 23:59 UTC+1.0"


def test_ptyn_10a_decodes_in_both_framers():
    groups = synth.ptyn_groups(0x6F01, 10, "FOOTBALL")
    for framer in (RdsFramer(), SyncByOffsetDecoder()):
        _feed(framer, groups, repeats=3)
        assert framer.events.ptyn == "FOOTBALL", type(framer).__name__
        assert framer.events.pi == 0x6F01


def test_ptyn_ab_flag_toggle_clears_previous_name():
    fr = RdsFramer()
    _feed(fr, synth.ptyn_groups(0x6F01, 10, "FOOTBALL", ab_flag=0), repeats=2)
    assert fr.events.ptyn == "FOOTBALL"
    # new message under the toggled flag: only segment 1 arrives first,
    # so the stale "FOOT" chars must have been cleared, not kept
    seg1_only = synth.ptyn_groups(0x6F01, 10, "NEWS    ", ab_flag=1)[1:]
    _feed(fr, seg1_only, repeats=2)
    assert fr.events.ptyn == "        "  # segment 0 not yet received


def test_ptyn_state_survives_checkpoint():
    fr = RdsFramer()
    _feed(fr, synth.ptyn_groups(0x6F01, 10, "FOOTBALL")[:1], repeats=1)
    blob = fr.state_dict()
    resumed = RdsFramer()
    resumed.load_state_dict(blob)
    _feed(resumed, synth.ptyn_groups(0x6F01, 10, "FOOTBALL")[1:], repeats=1)
    assert resumed.events.ptyn == "FOOTBALL"
