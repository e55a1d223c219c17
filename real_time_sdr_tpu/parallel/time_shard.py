"""Time-axis sequence parallelism: exact (tier 3) and halo-re-acquisition.

The reference scales an infinite sample stream by strictly sequential block
processing with carried state (SURVEY.md section 5 'long-context'). To shard
*time* across devices we exploit the structure of that carried state:

- FIR tails, the discriminator's previous sample, and the feedforward
  synchronizer's delay lines are pure INPUT HISTORY: a shard that also sees
  the last ``overlap`` blocks of its left neighbour (exchanged via
  ``lax.ppermute`` over the ICI ring) reproduces them exactly.
- The tier-3 feedforward synchronizer (ops.sync) carries no loop recurrence,
  only a residual-phase LEVEL. Starting a shard with level 0 shifts its
  unwrapped residual by a constant 2*pi*k relative to the sequential run;
  the nominal-ramp counter offset cancels algebraically (ramp_out and the
  residual shift by opposite amounts). A 2*pi*k level shift leaves the
  stereo carrier (nco_scale 2.0) bit-identical and flips the 57 kHz RDS
  carrier (nco_scale 0.5) by a constant per-shard SIGN when k is odd. Each
  shard therefore emits its boundary residual levels; comparing neighbours'
  levels at the shared boundary sample recovers k's parity, and the signs
  chain left-to-right so every shard's RDS baseband matches shard 0's —
  which IS the sequential receiver (shard 0 starts from the true initial
  state, no warm-up).
- The RDS bit-sync state machine is a genuine sequential recurrence, but it
  runs at 92.625 kS/s — 3.9% of the input rate. ``exact`` mode gathers the
  (float-exact) RRC output stream and scans the slicer/decoder over all
  blocks in order, so decoded bits are BIT-IDENTICAL to the sequential
  receiver. The wideband DSP — where the FLOPs are — stays fully parallel.

Tiers 1/2 carry a nonlinear per-sample PLL recurrence, which cannot be
sharded exactly without serializing; for them the ``overlap`` halo doubles
as a warm-up region in which each shard's loop re-acquires (bounded
divergence, the reference's own acquisition behaviour). ``exact=None`` picks
exact mode automatically whenever every carrier-recovery stage is tier 3.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.ops.rds_bits import bit_sync_init, timing_init
from real_time_sdr_tpu.ops.sync import FeedforwardSync

_TWO_PI = 2.0 * math.pi


def _all_feedforward(rx: Receiver) -> bool:
    """True when every carrier-recovery stage in rx is tier-3 feedforward
    (MonoPath has none; StereoPath/RdsPath expose ``_sync``)."""
    for path in (rx.audio, rx.rds_path):
        if path is None:
            continue
        sync = getattr(path, "_sync", None)
        has_pll = hasattr(path, "pll_params")
        if has_pll and not isinstance(sync, FeedforwardSync):
            return False
    return True


def time_sharded_run(rx: Receiver, mesh: Mesh, blocks: jax.Array,
                     axis: str = "time", overlap: int = 1,
                     exact: bool | None = None):
    """Run ``blocks`` (B, 2*block_size_iq) uint8 sharded in time.

    B must be divisible by the mesh axis size. Returns the stacked
    ReceiverOutput for all B blocks (leading axis B, time-ordered).

    exact=True (default for all-tier-3 receivers): RDS bits match the
    sequential ``rx.run_blocks`` bit-for-bit; audio matches to float32
    reduction order (>120 dB — the boundary phase correction is
    algebraically exact but rounds in the last ulp; see module docstring).
    exact=False: per-shard warm-up re-acquisition; steady-state audio
    matches within SNR bounds, RDS bits are per-shard re-aligned.
    """
    if exact is None:
        exact = _all_feedforward(rx)
    elif exact and not _all_feedforward(rx):
        raise ValueError(
            "exact time sharding requires every carrier-recovery stage at "
            "tier 3 (feedforward); this receiver carries a sequential PLL "
            "recurrence that cannot be sharded exactly. Use exact=False "
            "(warm-up re-acquisition) or build the receiver with pll_tier=3")
    t = mesh.shape[axis]
    b = blocks.shape[0]
    assert b % t == 0, f"blocks {b} not divisible by time shards {t}"

    if not exact:
        return _approx_run(rx, mesh, blocks, axis, overlap, t)
    if t == 1:
        _, outs = rx.jit_run_blocks(rx.init_state(), blocks)
        return outs

    # The whole exact pipeline (sharded DSP + sign chain + global decode)
    # is built ONCE per (mesh, geometry) and jitted — a fresh jax.jit per
    # call would re-trace and re-compile the B-block decode scan every
    # invocation. The DSP pass runs on a twin receiver whose RDS path
    # skips bit emission (rds.emit_bits=False): the per-shard slicer would
    # otherwise run on every device only to be discarded and recomputed by
    # the global decode; as a constant output it is dead code to XLA.
    cache = rx.__dict__.setdefault("_time_shard_cache", {})
    key = (mesh, axis, overlap, blocks.shape, str(blocks.dtype))
    fn = cache.get(key)
    if fn is None:
        fn = _build_exact_pipeline(rx, mesh, axis, overlap, t)
        cache[key] = fn
    return fn(blocks)


def _build_exact_pipeline(rx: Receiver, mesh: Mesh, axis: str,
                          overlap: int, t: int):
    if rx.rds_path is not None:
        dsp_rx = Receiver(rx.cfg, stereo=rx.stereo, rds=True, pll_tier=3,
                          rds_timing=rx.rds_path.timing)
        dsp_rx.rds_path.emit_bits = False
    else:
        dsp_rx = rx
    perm = [(i, (i + 1) % t) for i in range(t)]

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(axis),
        out_specs=(P(axis), P(axis)), check_vma=False)
    def run_dsp(local_blocks):
        halo = jax.lax.ppermute(local_blocks[-overlap:], axis, perm=perm)
        my_id = jax.lax.axis_index(axis)
        init = dsp_rx.init_state()
        warm, _ = dsp_rx.run_blocks(init, halo)
        # Shard 0 is the true stream head: it keeps the initial state and is
        # therefore IDENTICAL to the sequential receiver from sample 0.
        state0 = jax.tree_util.tree_map(
            lambda a, b_: jnp.where(my_id == 0, a, b_), init, warm)

        def level(st):
            # Total carrier phase (nominal ramp + residual) mod 4*pi at the
            # carried sample. The residual alone is NOT comparable across
            # shards: each shard's residual absorbs its local ramp offset.
            if dsp_rx.rds_path is None:
                return jnp.float32(0.0)
            p = dsp_rx.rds_path.pll_params
            c = st.rds.pll
            return jnp.mod(p.trig_angle(c.trig) + c.resid, 2.0 * _TWO_PI)

        final, outs = dsp_rx.run_blocks(state0, local_blocks)
        # boundary phase levels: [after-warm-up, end-of-segment]
        levels = jnp.stack([level(state0), level(final)])[None]  # (1, 2)
        return outs, levels

    rds = rx.rds_path

    def decode(clean_blocks):
        def body(carry, clean_b):
            bit_state, track, count = carry
            bits, n_bits, bit_state, track = rds._decode_one(
                clean_b, bit_state, track, count)
            return (bit_state, track, count + 1), (bits, n_bits)

        track0 = timing_init() if rds.timing == "tracked" else None
        carry0 = (bit_sync_init(), track0, jnp.zeros((), jnp.int32))
        _, (bits, n_bits) = jax.lax.scan(body, carry0, clean_blocks)
        return bits, n_bits

    @jax.jit
    def pipeline(blocks):
        outs, levels = run_dsp(blocks)
        if rds is None:
            return outs

        # -- per-shard RDS carrier sign, chained across boundaries ----------
        # Shard k+1's level at its warm-up end and shard k's level at its
        # segment end describe the SAME boundary sample; both are wrapped
        # mod 4*pi and agree mod 2*pi, so their difference is (near) an
        # integer multiple of 2*pi whose parity is k's relative carrier
        # sign.
        starts = levels[1:, 0]
        ends = levels[:-1, 1]
        m = jnp.round((starts - ends) / _TWO_PI).astype(jnp.int32)
        parity = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                  jnp.cumsum(m) % 2])
        sign = jnp.where(parity == 0, 1.0, -1.0).astype(jnp.float32)  # (t,)
        nb_local = blocks.shape[0] // t
        sign_blocks = jnp.repeat(sign, nb_local)  # (B,)
        clean = outs.rds_clean * sign_blocks[:, None]

        # -- sequential decode over the gathered exact RRC stream -----------
        bits, n_bits = decode(clean)
        return outs._replace(rds_bits=bits, rds_nbits=n_bits,
                             rds_clean=clean)

    return pipeline


def time_sharded_run_bank(rx: Receiver, mesh: Mesh, blocks: jax.Array,
                          ch_axis: str = "ch", time_axis: str = "time",
                          overlap: int = 1):
    """JOINT channel x time sharding on a 2-D mesh (exact mode, tier 3).

    blocks: (C, B, 2*block_size_iq) uint8 — C independent stations, each a
    B-block stream. Channels shard over ``ch_axis`` (zero coupling), each
    channel's block stream shards over ``time_axis`` with the same
    ppermute-halo + phase-parity sign chain as :func:`time_sharded_run`;
    the halo exchange rides the time axis of the SAME mesh, so a (ch, time)
    pod runs C*B blocks with every device busy. RDS bits are BIT-IDENTICAL
    to the per-channel sequential receiver; audio is float-exact to
    reduction order (same guarantees as the 1-D exact mode, proven in
    tests/test_parallel.py::test_joint_channel_time_sharding).
    """
    if not _all_feedforward(rx):
        raise ValueError("joint channel x time sharding is exact-mode only: "
                         "build the receiver with pll_tier=3")
    c_sh = mesh.shape[ch_axis]
    t = mesh.shape[time_axis]
    C, B = blocks.shape[0], blocks.shape[1]
    assert C % c_sh == 0, f"channels {C} not divisible by {c_sh}"
    assert B % t == 0, f"blocks {B} not divisible by time shards {t}"

    cache = rx.__dict__.setdefault("_time_shard_cache", {})
    key = ("bank", mesh, ch_axis, time_axis, overlap, blocks.shape,
           str(blocks.dtype))
    fn = cache.get(key)
    if fn is None:
        fn = _build_exact_bank_pipeline(rx, mesh, ch_axis, time_axis,
                                        overlap, t)
        cache[key] = fn
    return fn(blocks)


def _build_exact_bank_pipeline(rx: Receiver, mesh: Mesh, ch_axis: str,
                               time_axis: str, overlap: int, t: int):
    """(C, B, blk) twin of _build_exact_pipeline: vmap over local channels
    inside a 2-D shard_map; the sign chain and global decode run per
    channel."""
    if rx.rds_path is not None:
        dsp_rx = Receiver(rx.cfg, stereo=rx.stereo, rds=True, pll_tier=3,
                          rds_timing=rx.rds_path.timing)
        dsp_rx.rds_path.emit_bits = False
    else:
        dsp_rx = rx
    perm = [(i, (i + 1) % t) for i in range(t)]

    def level(st):
        if dsp_rx.rds_path is None:
            return jnp.float32(0.0)
        p = dsp_rx.rds_path.pll_params
        c = st.rds.pll
        return jnp.mod(p.trig_angle(c.trig) + c.resid, 2.0 * _TWO_PI)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(ch_axis, time_axis),
        out_specs=(P(ch_axis, time_axis), P(ch_axis, time_axis)),
        check_vma=False)
    def run_dsp(local):                       # (Cl, Bl, blk)
        halo = jax.lax.ppermute(local[:, -overlap:], time_axis, perm=perm)
        my_t = jax.lax.axis_index(time_axis)

        def one_channel(blocks_ch, halo_ch):
            init = dsp_rx.init_state()
            warm, _ = dsp_rx.run_blocks(init, halo_ch)
            state0 = jax.tree_util.tree_map(
                lambda a, b_: jnp.where(my_t == 0, a, b_), init, warm)
            final, outs = dsp_rx.run_blocks(state0, blocks_ch)
            levels = jnp.stack([level(state0), level(final)])  # (2,)
            return outs, levels

        outs, levels = jax.vmap(one_channel)(local, halo)
        return outs, levels[:, None]          # (Cl, 1, 2) -> global (C, t, 2)

    rds = rx.rds_path

    def decode(clean_blocks):                 # (B, rds_block) one channel
        def body(carry, clean_b):
            bit_state, track, count = carry
            bits, n_bits, bit_state, track = rds._decode_one(
                clean_b, bit_state, track, count)
            return (bit_state, track, count + 1), (bits, n_bits)

        track0 = timing_init() if rds.timing == "tracked" else None
        carry0 = (bit_sync_init(), track0, jnp.zeros((), jnp.int32))
        _, (bits, n_bits) = jax.lax.scan(body, carry0, clean_blocks)
        return bits, n_bits

    @jax.jit
    def pipeline(blocks):
        outs, levels = run_dsp(blocks)
        if rds is None:
            return outs
        starts = levels[:, 1:, 0]             # (C, t-1)
        ends = levels[:, :-1, 1]
        m = jnp.round((starts - ends) / _TWO_PI).astype(jnp.int32)
        parity = jnp.concatenate(
            [jnp.zeros((m.shape[0], 1), jnp.int32),
             jnp.cumsum(m, axis=1) % 2], axis=1)
        sign = jnp.where(parity == 0, 1.0, -1.0).astype(jnp.float32)
        nb_local = blocks.shape[1] // t
        sign_blocks = jnp.repeat(sign, nb_local, axis=1)   # (C, B)
        clean = outs.rds_clean * sign_blocks[..., None]
        bits, n_bits = jax.vmap(decode)(clean)
        return outs._replace(rds_bits=bits, rds_nbits=n_bits,
                             rds_clean=clean)

    return pipeline


def _approx_run(rx: Receiver, mesh: Mesh, blocks: jax.Array, axis: str,
                overlap: int, t: int):
    """Warm-up re-acquisition sharding for tier-1/2 (loop PLL) receivers."""
    # cached per (mesh, geometry) like the exact pipeline — a fresh closure
    # per call would re-trace and re-compile the B-block scan every time
    cache = rx.__dict__.setdefault("_time_shard_cache", {})
    key = ("approx", mesh, axis, overlap, blocks.shape, str(blocks.dtype))
    fn = cache.get(key)
    if fn is not None:
        return fn(blocks)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(axis),
        out_specs=P(axis), check_vma=False)
    def run(local_blocks):
        tail = local_blocks[-overlap:]
        halo = jax.lax.ppermute(
            tail, axis, perm=[(i, (i + 1) % t) for i in range(t)])
        my_id = jax.lax.axis_index(axis)
        # Warm each shard's loop state on its left-neighbour halo, then run
        # the local blocks from that state. Shard 0 is the true stream
        # head: it keeps the INITIAL state (its ppermute halo is shard
        # t-1's tail — the warm-up runs on it uniformly but the result is
        # discarded by the select), so the head of the output is identical
        # to the sequential receiver rather than a state that had already
        # consumed the shard's own leading blocks (a backwards time-jump).
        init = rx.init_state()
        warm, _ = rx.run_blocks(init, halo)
        state0 = jax.tree_util.tree_map(
            lambda a, b_: jnp.where(my_id == 0, a, b_), init, warm)
        _final, outs = rx.run_blocks(state0, local_blocks)
        return outs

    jit_run = jax.jit(run)
    cache[key] = jit_run
    return jit_run(blocks)
