"""On-device RDS symbol/bit operations under XLA's static-shape rule.

Redesign of the reference's bit-serial decode utilities
(src/rds_utilities.cpp): clock/data recovery as a reshape-reduce-argmax,
symbol slicing as a masked gather, Manchester/differential decoding as masked
XOR algebra with a tiny carried state, and the RBDS syndrome as a mod-2
matmul of all sliding 26-bit windows against the parity matrix at once
(replacing the sequential shift-register walk, src/rds_utilities.cpp:384-400).

Everything here has static shapes: per block we emit ``max_bits`` bit slots
plus a valid count, exactly mirroring the reference's variable-length
vectors + carried half-symbol state (src/rds_utilities.cpp:61-66).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BitSyncState", "bit_sync_init", "cdr_offset", "decode_block_bits",
    "TimingTrack", "timing_init", "cdr_tracked", "decode_block_bits_tracked",
    "parity_matrix_np", "OFFSET_SYNDROMES",
]

_RDS_POLY = 0x5B9


def _crc_remainder(value: int, nbits: int) -> int:
    """Remainder of value * x^10 mod g(x) over GF(2) (host, design time)."""
    reg = 0
    for i in range(nbits, 0, -1):
        reg = (reg << 1) | ((value >> (i - 1)) & 1)
        if reg & (1 << 10):
            reg ^= _RDS_POLY
    for _ in range(10):
        reg <<= 1
        if reg & (1 << 10):
            reg ^= _RDS_POLY
    return reg & 0x3FF


def parity_matrix_np() -> np.ndarray:
    """(26, 10) RBDS parity-check matrix H; syndrome = bits @ H mod 2."""
    h = np.zeros((26, 10), dtype=np.int32)
    for i in range(26):
        rem = _crc_remainder(1 << (25 - i), 26)
        for c in range(10):
            h[i, c] = (rem >> (9 - c)) & 1
    return h


# RBDS offset words in block order (A, B, C, C', D) — the single source of
# truth for the framework (the float64 oracle in golden/dsp.py keeps its own
# copy on purpose, for independence).
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}

# Offset-word syndromes; values equal the reference's dormant-decoder table
# {383, 14, 303, 663, 748} reordered (src/rds_utilities.cpp:205 lists
# A,B,C,D,C').
OFFSET_SYNDROMES = {k: _crc_remainder(w, 26) for k, w in OFFSET_WORDS.items()}


class BitSyncState(NamedTuple):
    """Carried Manchester/differential state
    (reference: src/rds.cpp:28-31 locals + rds_utilities.cpp:61-66,:87)."""
    first: jax.Array        # bool: no block decoded yet (alignment unscored)
    start: jax.Array        # int32 0/1: alignment / prepend flag
    half_symbol: jax.Array  # int32: carried trailing symbol
    last_bit: jax.Array     # int32: last pre-differential bit


def bit_sync_init(batch: tuple = ()) -> BitSyncState:
    i32 = partial(jnp.full, batch, dtype=jnp.int32)
    return BitSyncState(first=jnp.full(batch, True), start=i32(0),
                        half_symbol=i32(0), last_bit=i32(0))


def cdr_offset(signal: jax.Array, sps: int) -> jax.Array:
    """Clock/data recovery: max-|energy| comb phase
    (src/rds_utilities.cpp:4-21). signal: (L,) -> int32 offset in [0, sps)."""
    n = signal.shape[-1] // sps
    comb = jnp.abs(signal[..., : n * sps].reshape(signal.shape[:-1] + (n, sps)))
    energy = comb.sum(axis=-2)
    # ties resolve to the lowest index, and the reference's strict '>' keeps
    # the first maximum as well
    return jnp.argmax(energy, axis=-1).astype(jnp.int32)


def decode_block_bits(rds_clean: jax.Array, state: BitSyncState, sps: int,
                      max_symbols: int, max_bits: int):
    """Slice symbols at the CDR phase and Manchester+differentially decode.

    rds_clean: (L,). Returns (bits (max_bits,) int32, n_bits int32, state).
    Follows src/rds.cpp:137-167: slice every sps-th sample > 0 from the CDR
    offset, carry a trailing half symbol across blocks, take the first symbol
    of each aligned pair as the bit, then XOR-differential with carried bit.
    """
    L = rds_clean.shape[-1]
    offset = cdr_offset(rds_clean, sps)
    # symbols[i] = clean[offset + i*sps] > 0, valid while in range
    pos = offset + sps * jnp.arange(max_symbols, dtype=jnp.int32)
    valid = pos < L
    sym = (jnp.take(rds_clean, jnp.clip(pos, 0, L - 1)) > 0).astype(jnp.int32)
    sym = jnp.where(valid, sym, 0)
    n_sym = valid.sum().astype(jnp.int32)  # == ceil((L-offset)/sps)
    return _symbols_to_bits(sym, n_sym, state, max_symbols, max_bits)


def _symbols_to_bits(sym: jax.Array, n_sym: jax.Array, state: BitSyncState,
                     max_symbols: int, max_bits: int):
    """Manchester-align + differential-decode a sliced symbol block.

    sym: (max_symbols,) int32 in {0,1} with the first n_sym valid.
    Shared by the fixed-comb CDR (decode_block_bits) and the tracking CDR
    (decode_block_bits_tracked)."""
    # Block-0 alignment scoring (src/rds_utilities.cpp:42-51): pairs starting
    # even minus pairs starting odd, over indices < n_sym-1.
    nxt = jnp.roll(sym, -1)
    x = jnp.bitwise_xor(sym, nxt)
    idx = jnp.arange(max_symbols, dtype=jnp.int32)
    in_range = idx < (n_sym - 1)
    even = (idx % 2 == 0) & in_range
    odd = (idx % 2 == 1) & in_range
    score = jnp.sum(jnp.where(even, x, 0)) - jnp.sum(jnp.where(odd, x, 0))
    start = jnp.where(state.first, (score < 0).astype(jnp.int32), state.start)
    prepend = state.start  # carried half-symbol emission flag

    # Aligned bits: b[j] = sym[start + 2j], count = (n_sym - start) // 2
    # (length of range(start, n_sym-1, 2)).
    j = jnp.arange(max_bits, dtype=jnp.int32)
    take_pos = start + 2 * j
    n_main = jnp.maximum(n_sym - start, 0) // 2
    main_bits = jnp.take(sym, jnp.clip(take_pos, 0, max_symbols - 1))
    # shift by one slot when the carried half symbol is prepended
    bits = jnp.where(
        prepend > 0,
        jnp.where(j == 0, state.half_symbol,
                  jnp.take(sym, jnp.clip(start + 2 * (j - 1), 0,
                                         max_symbols - 1))),
        main_bits)
    n_bits = n_main + prepend
    bits = jnp.where(j < n_bits, bits, 0)

    # Trailing half symbol (src/rds_utilities.cpp:61-66)
    odd_tail = ((n_sym - start) % 2) == 1
    last_sym = jnp.take(sym, jnp.clip(n_sym - 1, 0, max_symbols - 1))
    new_half = jnp.where(odd_tail, last_sym, state.half_symbol)
    new_start = odd_tail.astype(jnp.int32)

    # Differential decode (src/rds_utilities.cpp:70-88)
    prev = jnp.roll(bits, 1)
    first_bit_prev = jnp.where(state.first, 0, state.last_bit)
    prev = prev.at[0].set(first_bit_prev)
    decoded = jnp.bitwise_xor(bits, prev)
    decoded = jnp.where(j < n_bits, decoded, 0)
    new_last = jnp.take(bits, jnp.clip(n_bits - 1, 0, max_bits - 1))
    new_last = jnp.where(n_bits > 0, new_last, state.last_bit)

    new_state = BitSyncState(
        first=jnp.zeros_like(state.first),  # scoring happens on block 0 only
        start=new_start, half_symbol=new_half, last_bit=new_last)
    return decoded, n_bits, new_state


def _onehot_select(values: jax.Array, index: jax.Array) -> jax.Array:
    """values[..., index] as a masked sum (..., n) x (...,) -> (...,).

    Gathers can lower to slow scalar loads; a compare+select+reduce over n
    lanes stays elementwise and fuses into neighbours. Exact for int and for
    float (one nonzero addend)."""
    n = values.shape[-1]
    idx = jnp.arange(n, dtype=index.dtype)
    return jnp.sum(jnp.where(idx == index[..., None], values,
                             jnp.zeros((), values.dtype)), axis=-1)


def decode_segment_bits(clean: jax.Array, state: BitSyncState,
                        block_count: jax.Array, sps: int, max_symbols: int,
                        max_bits: int, warm_after: int = 5):
    """Batched slicer: nb blocks decoded with NO per-block scan.

    Bit-identical to scanning ``decode_block_bits`` (with the reference's
    warm-up gate, src/rds.cpp:135) over the leading axis of ``clean``
    (nb, L) — the scan version is all per-iteration overhead (its modeled
    floor is zero, experiments/stage_decompose.py). The cross-block
    couplings are tiny and close-form:

    - the Manchester ``start`` parity chains as start_{b+1} = start_b XOR
      (n_sym_b mod 2) -> an exclusive prefix-XOR (cumsum mod 2);
    - ``half_symbol`` and ``last_bit`` are "most recent block that emitted
      one" fill-forwards -> an exclusive cummax of tagged block indices;
    - the warm-up gate freezes the carried state, and since warm blocks
      are a SUFFIX (block counts increase), frozen blocks all see the
      initial state and the chain anchors at the first warm block k.

    GATHER-FREE on purpose: a first version used take_along_axis and
    was slower than the scan it replaced (the gathers serialized); every
    indexed read here is a reshaped strided slice, a parity-pair select, or
    a one-hot masked sum.

    clean: (nb, L) f32; state leaves are scalars (channel batching is
    jax.vmap's job, models/receiver._check_batch). Returns
    (bits (nb, max_bits) i32, n_bits (nb,) i32, new_state).
    """
    assert clean.ndim == 2, clean.shape
    nb, L = clean.shape
    i32 = jnp.int32
    S = max_symbols
    assert S * sps >= L, (S, sps, L)  # config: max_symbols = ceil(L/sps)

    # --- per-block independent half: comb CDR + slice (fully batched) ----
    offset = cdr_offset(clean, sps)                       # (nb,)
    # symbol k of block b sits at clean[b, offset_b + k*sps]: zero-pad to a
    # whole (S, sps) frame grid and select comb phase `offset` per block
    padded = jnp.pad(clean, ((0, 0), (0, S * sps - L)))
    frames = padded.reshape(nb, S, sps)
    phase_hit = (jnp.arange(sps, dtype=i32)[None] == offset[:, None])
    soft = jnp.sum(jnp.where(phase_hit[:, None, :], frames, 0.0), axis=-1)
    sym = (soft > 0).astype(i32)                          # (nb, S)
    idxS = jnp.arange(S, dtype=i32)
    n_sym = (L - offset + sps - 1) // sps                 # == sum(pos < L)
    sym = jnp.where(idxS[None] < n_sym[:, None], sym, 0)

    # per-block alignment score (used only where the first-flag applies)
    nxt = jnp.roll(sym, -1, axis=-1)
    x = jnp.bitwise_xor(sym, nxt)
    idx = jnp.arange(max_symbols, dtype=i32)[None]
    in_range = idx < (n_sym[:, None] - 1)
    even = (idx % 2 == 0) & in_range
    odd = (idx % 2 == 1) & in_range
    score = (jnp.sum(jnp.where(even, x, 0), axis=-1)
             - jnp.sum(jnp.where(odd, x, 0), axis=-1))    # (nb,)

    # --- warm-up geometry: frozen prefix [0, k), warm suffix [k, nb) ------
    b_idx = jnp.arange(nb, dtype=i32)
    is_warm = (block_count + b_idx) > warm_after
    k = jnp.clip(warm_after + 1 - block_count, 0, nb)     # first warm index
    st0 = state.start.astype(i32)

    # --- start chain (exclusive prefix-XOR over warm blocks) -------------
    par = n_sym % 2
    cum_par = jnp.cumsum(jnp.where(is_warm, par, 0)) % 2
    ex_par = jnp.concatenate([jnp.zeros((1,), i32), cum_par[:-1]])
    # every frozen block AND the anchor use the initial-state formula
    # (score only when state.first, else carried start)
    init_start = jnp.where(state.first, (score < 0).astype(i32), st0)
    anchor_start = _onehot_select(init_start, jnp.clip(k, 0, nb - 1))
    start_slice = jnp.where(b_idx < k, init_start, anchor_start ^ ex_par)
    prepend = jnp.where(b_idx <= k, st0, start_slice)

    # --- half-symbol fill-forward -----------------------------------------
    odd_tail = par ^ start_slice                          # (nb,) in {0,1}
    last_sym = _onehot_select(sym, jnp.clip(n_sym - 1, 0, S - 1))
    tag_h = jnp.where(is_warm & (odd_tail > 0), b_idx + 1, 0)
    cm_h = jax.lax.cummax(tag_h)
    ex_h = jnp.concatenate([jnp.zeros((1,), i32), cm_h[:-1]])
    half0 = state.half_symbol.astype(i32)
    half_enter = jnp.where(
        ex_h > 0,
        _onehot_select(last_sym, jnp.clip(ex_h - 1, 0, nb - 1)), half0)

    # --- per-block bit counts + final bit ---------------------------------
    n_main = jnp.maximum(n_sym - start_slice, 0) // 2
    n_bits = n_main + prepend
    fin_idx = start_slice + 2 * (n_bits - 1 - prepend)
    fin_sym = _onehot_select(sym, jnp.clip(fin_idx, 0, S - 1))
    final_bit = jnp.where((prepend > 0) & (n_bits == 1), half_enter, fin_sym)

    # --- last-bit fill-forward (differential-decode seed) ------------------
    tag_b = jnp.where(is_warm & (n_bits > 0), b_idx + 1, 0)
    cm_b = jax.lax.cummax(tag_b)
    ex_b = jnp.concatenate([jnp.zeros((1,), i32), cm_b[:-1]])
    last0 = state.last_bit.astype(i32)
    prev0 = jnp.where(
        ex_b > 0,
        _onehot_select(final_bit, jnp.clip(ex_b - 1, 0, nb - 1)), last0)
    # blocks at/before the anchor see the initial first-flag semantics
    prev0 = jnp.where(state.first & (b_idx <= k), 0, prev0)

    # --- assemble bits + differential decode (batched) --------------------
    # main_bits[b, j] = sym[b, start_b + 2j] with start in {0, 1}: the two
    # candidates are the even/odd parity slices of sym — a select, no gather.
    # Out-of-range reads (gather version: clipped then masked by `live`) are
    # zero-padded here and masked by the same `live`.
    j = jnp.arange(max_bits, dtype=i32)[None]             # (1, MB)
    sym_p = jnp.pad(sym, ((0, 0), (0, max(2 * max_bits + 2 - S, 0))))
    even_bits = sym_p[:, 0::2][:, :max_bits]
    odd_bits = sym_p[:, 1::2][:, :max_bits]
    main_bits = jnp.where(start_slice[:, None] == 0, even_bits, odd_bits)
    # shifted[b, j] = sym[b, start_b + 2(j-1)] = main_bits rolled right one
    # slot; its j==0 lane is never read (the half-symbol occupies it)
    shifted = jnp.roll(main_bits, 1, axis=-1)
    bits = jnp.where(prepend[:, None] > 0,
                     jnp.where(j == 0, half_enter[:, None], shifted),
                     main_bits)
    live = j < n_bits[:, None]
    bits = jnp.where(live, bits, 0)
    prev = jnp.roll(bits, 1, axis=-1)
    prev = prev.at[:, 0].set(prev0)
    decoded = jnp.where(live, jnp.bitwise_xor(bits, prev), 0)
    n_out = jnp.where(is_warm, n_bits, 0)

    # --- exit state (identical to the held-during-warm-up scan) -----------
    any_warm = is_warm[-1]  # warm blocks are a suffix
    new_first = jnp.logical_and(state.first, jnp.logical_not(any_warm))
    new_start = jnp.where(any_warm, odd_tail[-1], st0)
    half_exit = jnp.where(odd_tail[-1] > 0, last_sym[-1], half_enter[-1])
    new_half = jnp.where(any_warm, half_exit, half0)
    new_last = jnp.where(cm_b[-1] > 0,
                         _onehot_select(final_bit,
                                        jnp.clip(cm_b[-1] - 1, 0, nb - 1)),
                         last0)
    new_state = BitSyncState(first=new_first, start=new_start,
                             half_symbol=new_half, last_bit=new_last)
    return decoded, n_out, new_state


class TimingTrack(NamedTuple):
    """Tracking-CDR carry: symbol-clock phase and rate across blocks.

    The reference's per-block argmax CDR (src/rds_utilities.cpp:4-21)
    re-estimates an integer comb phase each block and cannot follow a
    sample-clock ppm error WITHIN a block (its alt model tracks with a
    Muller-Mueller loop, model/pySDRRDS.py:36-55). This carry holds the
    fractional next-symbol position, the per-symbol period deviation, and
    the previous block's final sample for cross-boundary interpolation."""
    offset: jax.Array   # f32: next-symbol position relative to block start
    rate: jax.Array     # f32: samples-per-symbol deviation from sps
    last: jax.Array     # f32: previous block's final RRC sample
    locked: jax.Array   # int32: 0 until the first block initializes phase


def timing_init(batch: tuple = ()) -> TimingTrack:
    f32 = partial(jnp.zeros, batch, dtype=jnp.float32)
    return TimingTrack(offset=f32(), rate=f32(), last=f32(),
                       locked=jnp.zeros(batch, jnp.int32))


def comb_peak_phase(energy: jax.Array, sps: int) -> jax.Array:
    """Fractional comb phase in [0, sps): cyclic argmax of the per-phase
    energy (..., sps) refined by a parabolic fit of the peak and its
    neighbours. Shared by cdr_tracked and ops.symbol_timing.comb_acquire."""
    m = jnp.argmax(energy, axis=-1)
    em = jnp.take_along_axis(energy, m[..., None], axis=-1)[..., 0]
    el = jnp.take_along_axis(energy, ((m - 1) % sps)[..., None],
                             axis=-1)[..., 0]
    er = jnp.take_along_axis(energy, ((m + 1) % sps)[..., None],
                             axis=-1)[..., 0]
    denom = el - 2.0 * em + er
    delta = jnp.where(jnp.abs(denom) > 1e-9,
                      0.5 * (el - er) / jnp.where(denom == 0, 1.0, denom),
                      0.0)
    return jnp.mod(m.astype(jnp.float32) + jnp.clip(delta, -0.5, 0.5),
                   float(sps))


def cdr_tracked(rds_clean: jax.Array, track: TimingTrack, sps: int,
                max_symbols: int, phase_gain: float = 0.3,
                rate_gain: float = 0.08):
    """Polyphase-interpolating CDR with a drift accumulator (feedforward
    within a block, a 2nd-order PI phase loop across blocks — fully
    vectorized, no per-symbol recurrence).

    Per block: (1) full-block comb |energy| with parabolic sub-sample
    interpolation around the argmax -> one fractional phase measurement;
    (2) PI update against the carried prediction (phase_gain on the wrapped
    innovation, rate_gain/symbols into the per-symbol period deviation) —
    a transmitter clock ppm error appears as a constant phase ramp and the
    integrator converges to it; (3) slice by LINEAR INTERPOLATION at
    drifting positions p_k = offset + k*(sps + rate). Returns
    (sym (max_symbols,) i32, soft (max_symbols,) f32, n_sym, new_track).
    """
    L = rds_clean.shape[-1]
    a = jnp.abs(rds_clean)
    n_comb = L // sps
    energy = a[..., :n_comb * sps].reshape(
        a.shape[:-1] + (n_comb, sps)).sum(axis=-2)   # (..., sps)
    o_meas = comb_peak_phase(energy, sps)

    def wrap_half(d):
        return jnp.mod(d + 0.5 * sps, sps) - 0.5 * sps

    cold = track.locked == 0
    o_pred = track.offset
    e = wrap_half(o_meas - o_pred)
    o0 = jnp.where(cold, o_meas, o_pred + phase_gain * e)
    nom_syms = float(L) / sps
    rate = jnp.where(cold, 0.0,
                     track.rate + rate_gain * e / nom_syms)
    # +-2000 ppm capture range; also keeps the max symbol count per block
    # within the static max_symbols=ceil(L/sps) bound
    rate = jnp.clip(rate, -0.002 * sps, 0.002 * sps)
    # keep the slice start in [-1, sps+rate): dropping/adding one boundary
    # symbol is handled by the Manchester parity carry, whereas an
    # unbounded offset would walk off the block (positive feedback)
    period = sps + rate
    o0 = o0 - period * jnp.floor((o0 + 1.0) / period)

    # count from the drift-corrected grid alone; p >= -1 holds by the wrap
    k = jnp.arange(max_symbols, dtype=jnp.float32)
    p = o0[..., None] + k * period[..., None]
    valid = p < L - 1
    pp = jnp.clip(p + 1.0, 0.0, float(L) - 1e-3)
    i0 = jnp.floor(pp).astype(jnp.int32)
    frac = pp - i0.astype(jnp.float32)
    # padded with the carried boundary sample so p in [-1, 0) interpolates
    # across the block seam
    padded = jnp.concatenate([track.last[..., None], rds_clean], axis=-1)
    # per-channel gather: jnp.take would flatten leading batch dims and
    # read every channel's symbols out of channel 0's sample range
    y0 = jnp.take_along_axis(padded, i0, axis=-1)
    y1 = jnp.take_along_axis(padded, jnp.minimum(i0 + 1, L), axis=-1)
    soft = jnp.where(valid, y0 * (1.0 - frac) + y1 * frac, 0.0)
    sym = (soft > 0).astype(jnp.int32)
    n_sym = valid.sum(axis=-1).astype(jnp.int32)

    next_off = o0 + n_sym.astype(jnp.float32) * period - L
    new_track = TimingTrack(offset=next_off, rate=rate,
                            last=rds_clean[..., -1],
                            locked=jnp.ones_like(track.locked))
    return sym, soft, n_sym, new_track


def decode_block_bits_tracked(rds_clean: jax.Array, state: BitSyncState,
                              track: TimingTrack, sps: int,
                              max_symbols: int, max_bits: int):
    """decode_block_bits with the tracking CDR in place of the fixed comb."""
    sym, _soft, n_sym, track = cdr_tracked(rds_clean, track, sps,
                                           max_symbols)
    bits, n_bits, state = _symbols_to_bits(sym, n_sym, state, max_symbols,
                                           max_bits)
    return bits, n_bits, state, track


# NOTE: the sliding-window mod-2 syndrome matmul (the replacement for the
# reference's bit-serial 26-bit register walk, src/rds_utilities.cpp:384-400)
# lives in models.rds_framing.RdsFramer.syndromes, on the HOST: per-channel
# bit streams are variable-length (n_bits varies block to block), so they are
# concatenated host-side anyway, and at 1187.5 bps/channel the matmul is
# sub-microsecond — shipping it back to the device would cost more in
# transfers than it computes. A device twin existed in round 1 but was dead
# code and was removed.
