"""Golden NumPy models: the test oracle for the JAX receiver.

This plays the role the reference's ``model/`` directory plays for its C++
(model-as-oracle cross-validation, see SURVEY.md section 4): every on-device
kernel has a scalar/loop float64 twin here, written from the reference's
*math* (src/filter.cpp, src/demod.cpp, src/pll.cpp, src/rds_utilities.cpp,
model/fmSupportLib.py, model/fmPll.py), not from its code.

Everything is deliberately simple and slow: explicit loops, float64,
per-block carried state passed in and out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


# ----------------------------------------------------------------------------
# Block FIR with carried state
# ----------------------------------------------------------------------------

def fir_block(x, h, state, decim=1):
    """Causal FIR + decimation with overlap-save state.

    Twin of the reference's ``convolveFIR(y, x, h, state, decim)``
    (src/filter.cpp:106-121): y[n] = sum_k h[k] * xx[n*decim - k] with the
    previous block's tail supplying negative indices; outputs only every
    ``decim``-th sample. Returns (y, new_state) where new_state is the last
    len(h)-1 input samples.
    """
    x = np.asarray(x, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    taps = len(h)
    assert len(state) == taps - 1
    xx = np.concatenate([np.asarray(state, dtype=np.float64), x])
    n_out = len(x) // decim
    y = np.zeros(n_out)
    for n in range(n_out):
        pos = taps - 1 + n * decim
        y[n] = np.dot(h, xx[pos - np.arange(taps)])
    return y, x[-(taps - 1):].copy()


def fir_resample_block(x, h, state, up, down):
    """Polyphase rational resampler with carried state.

    Twin of ``convolveFIR(y, x, h, state, up, down)`` (src/filter.cpp:123-147)
    and ``convfilter_resample`` (model/fmSupportLib.py:95-114): for each output
    n, phase = (n*down) % up and only the phase's tap bank touches real input
    samples. State is the last ceil(len(h)/up)-1 *input* samples (the reference
    stores len(h)-1, of which only these are ever read).
    """
    x = np.asarray(x, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    K = len(h)
    T = -(-K // up)  # ceil: real input samples per output dot
    assert len(state) == T - 1, (len(state), T - 1)
    xx = np.concatenate([np.asarray(state, dtype=np.float64), x])
    n_out = (len(x) * up) // down
    y = np.zeros(n_out)
    for n in range(n_out):
        phase = (n * down) % up
        q = (n * down - phase) // up  # == floor(n*down/up)
        for m, k in enumerate(range(phase, K, up)):
            # x index q - m; negative comes from state via the xx prefix
            y[n] += h[k] * xx[T - 1 + q - m]
    return y, xx[len(xx) - (T - 1):].copy()


# ----------------------------------------------------------------------------
# FM discriminator
# ----------------------------------------------------------------------------

def fm_demod_block(i_sig, q_sig, prev_i, prev_q):
    """Arctan-free FM discriminator (src/demod.cpp:3-24,
    model/fmSupportLib.py:164-183):
    d[n] = (I[n] dQ[n] - Q[n] dI[n]) / (I[n]^2 + Q[n]^2), zero-guarded.
    """
    i_sig = np.asarray(i_sig, dtype=np.float64)
    q_sig = np.asarray(q_sig, dtype=np.float64)
    ii = np.concatenate([[prev_i], i_sig])
    qq = np.concatenate([[prev_q], q_sig])
    num = i_sig * np.diff(qq) - q_sig * np.diff(ii)
    den = i_sig * i_sig + q_sig * q_sig
    out = np.where((i_sig == 0) & (q_sig == 0), 0.0, num / np.where(den == 0, 1.0, den))
    return out, i_sig[-1], q_sig[-1]


def fm_demod_arctan_block(i_sig, q_sig, prev_phase=0.0):
    """Arctan+unwrap discriminator, loop-level (fmDemodArctan,
    model/fmSupportLib.py:116-145; used by the primary oracle
    model/fmMonoBlock.py:101). Carries the running unwrapped phase."""
    out = np.empty(len(i_sig))
    for k in range(len(i_sig)):
        cur = math.atan2(q_sig[k], i_sig[k])
        prev_phase, cur = np.unwrap([prev_phase, cur])
        out[k] = cur - prev_phase
        prev_phase = cur
    return out, prev_phase


# ----------------------------------------------------------------------------
# PLL + NCO
# ----------------------------------------------------------------------------

@dataclass
class PllState:
    """Carried loop state (reference: include/pll.h:10-17 + pll.cpp:18)."""
    integrator: float = 0.0
    phase_est: float = 0.0
    feedback_i: float = 1.0
    feedback_q: float = 0.0
    trig_offset: int = 0
    last_nco: float = 1.0  # previous block's final NCO sample -> out[0]


def pll_block(x, freq, fs, state: PllState, nco_scale=1.0, phase_adjust=0.0,
              norm_bw=0.01):
    """Type-2 second-order PLL with NCO, per-sample recurrence.

    Twin of ``fmpll`` (src/pll.cpp:4-61) / ``fmPll`` (model/fmPll.py:103-175).
    Returns (out, new_state) where out has len(x)+1 entries and out[0] is the
    *previous* block's last NCO sample — consumers index out[0:len(x)], so the
    carrier is effectively one sample delayed, exactly as in the reference
    (src/stereo.cpp:83-85, src/rds.cpp:125-127).
    """
    cp, ci = 2.666, 3.555
    kp = norm_bw * cp
    ki = norm_bw * norm_bw * ci
    omega = 2.0 * math.pi * freq / fs

    fbi, fbq = state.feedback_i, state.feedback_q
    integ, phase = state.integrator, state.phase_est
    trig = state.trig_offset

    out = np.empty(len(x) + 1)
    out[0] = state.last_nco
    for k in range(len(x)):
        err_i = x[k] * fbi
        err_q = x[k] * (-fbq)
        err_d = math.atan2(err_q, err_i)
        integ = integ + ki * err_d
        phase = phase + kp * err_d + integ
        trig += 1
        arg = omega * trig + phase
        fbi = math.cos(arg)
        fbq = math.sin(arg)
        out[k + 1] = math.cos(arg * nco_scale + phase_adjust)

    new = PllState(integrator=integ, phase_est=phase, feedback_i=fbi,
                   feedback_q=fbq, trig_offset=trig, last_nco=out[-1])
    return out, new


# ----------------------------------------------------------------------------
# RDS bit-level decode
# ----------------------------------------------------------------------------

def cdr(sps, signal):
    """Clock/data recovery: argmax-|energy| comb phase
    (src/rds_utilities.cpp:4-21). Only the first floor(N/sps)*sps samples
    participate, like the reference's integer loop bound."""
    n = len(signal) // sps
    best_i, best_v = 0, 0.0
    for i in range(sps):
        s = np.abs(np.asarray(signal[: n * sps : 1], dtype=np.float64)[i::sps][:n]).sum()
        if s > best_v:
            best_v, best_i = s, i
    return best_i


def slice_symbols(rds_clean, offset, sps):
    """Every sps-th sample > 0 starting at offset (src/rds.cpp:157-161)."""
    return [1 if rds_clean[i] > 0 else 0
            for i in range(offset, len(rds_clean), sps)]


@dataclass
class ManchesterState:
    start: int = 0
    half_symbol: int = 0


def manchester_block(symbols, block_index, st: ManchesterState):
    """Manchester alignment + decode (src/rds_utilities.cpp:34-68).

    Bit = first symbol of each aligned pair. On the first block the
    alignment ``start`` is scored by XOR of even- vs odd-started pairs.
    A trailing unpaired symbol is carried as ``half_symbol`` and emitted
    as the first bit of the next block.
    """
    if not symbols:
        return []  # nothing to pair; any carried half symbol stays carried
    bits = []
    if st.start:
        bits.append(st.half_symbol)
    if block_index == 0:
        score = 0
        for i in range(0, len(symbols) - 1, 2):
            score += symbols[i] ^ symbols[i + 1]
        for j in range(1, len(symbols) - 1, 2):
            score -= symbols[j] ^ symbols[j + 1]
        st.start = 1 if score < 0 else 0
    for i in range(st.start, len(symbols) - 1, 2):
        bits.append(symbols[i])
    if ((len(symbols) - st.start) & 1) == 1:
        st.half_symbol = symbols[-1]
        st.start = 1
    else:
        st.start = 0
    return bits


def differential_block(bits, block_index, last_bit):
    """Differential decode with carried last bit
    (src/rds_utilities.cpp:70-88)."""
    if not bits:
        return [], last_bit
    out = [bits[0] if block_index == 0 else bits[0] ^ last_bit]
    for i in range(1, len(bits)):
        out.append(bits[i] ^ bits[i - 1])
    return out, bits[-1]


# ----------------------------------------------------------------------------
# RBDS framing: CRC, parity matrix, frame sync, group parse
# ----------------------------------------------------------------------------

RDS_POLY = 0x5B9  # RBDS generator polynomial (src/rds_utilities.cpp:90-109)

# 26x10 parity-check matrix H: column c of the syndrome is
# parity(window AND PARITY_COLS[c]). Derived from the RBDS generator:
# rows 0..15 are the remainders of x^(25-i) mod g(x), rows 16..25 identity.
# (The reference hard-codes the same matrix, src/rds_utilities.cpp:122-133.)


def _crc_remainder(value, nbits):
    """Remainder of value * x^10 divided by g(x) over GF(2).

    Twin of ``calc_syndrome(x, mlen)`` (src/rds_utilities.cpp:90-109): shift
    nbits message bits then 10 zeros through the LFSR.
    """
    reg = 0
    for i in range(nbits, 0, -1):
        reg = (reg << 1) | ((value >> (i - 1)) & 1)
        if reg & (1 << 10):
            reg ^= RDS_POLY
    for _ in range(10):
        reg <<= 1
        if reg & (1 << 10):
            reg ^= RDS_POLY
    return reg & 0x3FF


calc_syndrome = _crc_remainder


def parity_matrix():
    """H as a (26, 10) 0/1 int array: syndrome = bits(26) @ H mod 2."""
    h = np.zeros((26, 10), dtype=np.int64)
    for i in range(26):
        # 26-bit block with a single 1 at position i (MSB-first)
        rem = _crc_remainder(1 << (25 - i), 26)
        for c in range(10):
            h[i, c] = (rem >> (9 - c)) & 1
    return h


# Offset words A, B, C, C', D (RBDS standard; the reference's dormant decoder
# lists them in order A,B,C,D,C' with block positions {0,1,2,3,2},
# src/rds_utilities.cpp:205-207).
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}
OFFSET_ORDER = ["A", "B", "C", "Cp", "D"]


def offset_syndromes():
    """Expected 10-bit syndrome for each offset word: since data*x^10 is a
    codeword, syndrome(block) = syndrome of the offset word alone."""
    return {name: _crc_remainder(w, 26) for name, w in OFFSET_WORDS.items()}


PTY_NAMES = [
    "Undefined", "News", "Information", "Sports", "Talk", "Rock",
    "Classic Rock", "Adult Hits", "Soft Rock", "Top 40", "Country", "Oldies",
    "Soft", "Nostalgia", "Jazz", "Classical", "Rhythm & Blues",
    "Soft Rhythm & Blues", "Language", "Religious Music", "Religious Talk",
    "Personality", "Public", "College", "Spanish Talk", "Spanish Music",
    "Hip Hop", "Unassigned", "Unassigned", "Weather", "Emergency Test",
    "Emergency",
]


@dataclass
class GroupAssembler:
    """A->B->C->D sliding sequence detector + PS-name assembler.

    Twin of isSequenceABCD/uint_copy/parse (src/rds_utilities.cpp:172-199,
    313-350): 16 data bits per matched block pack into a 64-bit group
    register; a full A,B,C,D run emits the group. Group type 0 fills the
    8-char Program Service name two chars at a time; group type 2 fills
    RadioText (the reference models parse it at model/OurRDSOurDSP.py:486-528).
    """
    reg: int = 0
    window: list = field(default_factory=list)
    ps_chars: int = 0
    ps_name: str | None = None
    radiotext: list = field(default_factory=lambda: [" "] * 64)
    events: list = field(default_factory=list)

    def feed(self, offset_type, data16):
        data16 = int(data16)
        if offset_type in ("A", "B", "C", "Cp", "D"):
            # C' occupies the C block position (version-B groups); the
            # production RdsFramer maps it the same way (rds_framing._block).
            slot = {"A": 0, "B": 1, "C": 2, "Cp": 2, "D": 3}[offset_type]
            mask = ~(0xFFFF << (48 - 16 * slot)) & ((1 << 64) - 1)
            self.reg = (self.reg & mask) | (data16 << (48 - 16 * slot))
        self.window.append("C" if offset_type == "Cp" else offset_type)
        if len(self.window) > 4:
            self.window.pop(0)
        if self.window == ["A", "B", "C", "D"]:
            self._parse(self.reg)

    def _parse(self, g):
        pi = (g >> 48) & 0xFFFF
        group_type = (g >> 44) & 0xF
        pty = (g >> 37) & 0x1F
        placement = (g >> 32) & 0x3
        self.events.append(("group", pi, group_type, PTY_NAMES[pty]))
        if group_type == 0:
            word = g & 0xFFFF
            mask = ~(0xFFFF << (48 - 16 * placement)) & ((1 << 64) - 1)
            self.ps_chars = (self.ps_chars & mask) | (word << (16 * (3 - placement)))
            if placement == 3:
                name = "".join(chr((self.ps_chars >> (8 * (7 - i))) & 0xFF)
                               for i in range(8))
                self.ps_name = name
                self.events.append(("ps", name))
        elif group_type == 2:
            seg = (g >> 32) & 0xF
            c = g & 0xFFFFFFFF
            for j in range(4):
                ch = (c >> (8 * (3 - j))) & 0xFF
                self.radiotext[seg * 4 + j] = chr(ch) if 32 <= ch < 127 else " "


@dataclass
class FrameSyncState:
    tail_bits: list = field(default_factory=list)
    assembler: GroupAssembler = field(default_factory=GroupAssembler)


def frame_sync(bit_stream, st: FrameSyncState):
    """Sliding 26-bit window frame sync (src/rds_utilities.cpp:384-400):
    step 26 on a syndrome hit, 1 on a miss; tail bits carry to next call."""
    stream = st.tail_bits + list(bit_stream)
    synd = offset_syndromes()
    idx = 0
    while idx + 26 <= len(stream):
        window = stream[idx:idx + 26]
        val = 0
        for b in window:
            val = (val << 1) | int(b)
        s = _crc_remainder(val, 26)
        hit = None
        for name in OFFSET_ORDER:
            if s == synd[name]:
                hit = name
                break
        if hit is not None:
            st.assembler.feed(hit, val >> 10)
            idx += 26
        else:
            idx += 1
    st.tail_bits = stream[idx:]
    return st


# ----------------------------------------------------------------------------
# RDS transmit-side encoding (for synthetic end-to-end fixtures)
# ----------------------------------------------------------------------------

def encode_group(pi, group_type, pty, placement, data_c, data_d):
    """Build the four 16-bit data words of one RBDS group."""
    b = (group_type << 12) | (0 << 11) | (0 << 10) | (pty << 5) | placement
    return [pi, b, data_c, data_d]


def group_to_bits(words):
    """Four data words -> 104 bits with CRC+offset checkwords appended.

    Version-B groups (bit 11 of block B) put block 3 under the C' offset."""
    offsets = ["A", "B", "Cp" if (words[1] >> 11) & 1 else "C", "D"]
    bits = []
    for word, offset in zip(words, offsets):
        check = _crc_remainder(word, 16) ^ OFFSET_WORDS[offset]
        block = (word << 10) | check
        bits.extend((block >> (25 - i)) & 1 for i in range(26))
    return bits


def ps_groups(pi, pty, ps_name):
    """Group-type-0 sequence carrying an 8-char Program Service name."""
    assert len(ps_name) == 8
    groups = []
    for placement in range(4):
        chars = ps_name[2 * placement: 2 * placement + 2]
        word_d = (ord(chars[0]) << 8) | ord(chars[1])
        groups.append(encode_group(pi, 0, pty, placement, 0x0000, word_d))
    return groups


def differential_encode(bits, prev=0):
    """Inverse of differential_block: out[i] = bits[i] ^ out[i-1]."""
    out = []
    for b in bits:
        prev = b ^ prev
        out.append(prev)
    return out


def manchester_encode(bits):
    """bit b -> symbol pair (b, 1-b): the decoder takes the first of each
    pair (src/rds_utilities.cpp:53-57)."""
    syms = []
    for b in bits:
        syms.extend([b, 1 - b])
    return syms
