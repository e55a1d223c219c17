"""Channel-bank parallelism: many FM stations decoded at once.

The reference decodes one station on three CPU threads; the free-scaling
dimension on an accelerator is a *channel axis* (SURVEY.md section 2.3
'Data parallelism'): the whole per-block receiver step vmaps over channels
with zero cross-channel coupling, and the channel axis shards across
devices/hosts (the interconnect never sees anything but the initial
placement).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from real_time_sdr_tpu.models.receiver import Receiver


def _default_wb_group() -> int:
    """Fused wideband bank sub-batch width: 0 (one vmap over all
    stations) unless RTSDR_WB_GROUP sets it; ONE resolution point so the
    rails and u8-ingest entries can't diverge."""
    import os
    return int(os.environ.get("RTSDR_WB_GROUP", "0"))


class ChannelBank:
    """A bank of ``n_channels`` independent receivers, optionally sharded.

    With a mesh, channel axis 0 of every state/input/output leaf is sharded
    over ``axis`` — XLA partitions the whole graph with no collectives.
    """

    def __init__(self, rx: Receiver, n_channels: int,
                 mesh: Mesh | None = None, axis: str = "ch"):
        self.rx = rx
        self.n = n_channels
        self.mesh = mesh
        self.axis = axis
        self._grouped_cache: dict[int, object] = {}
        self._chan_jit_cache: dict[int, object] = {}
        self._step = jax.jit(jax.vmap(rx.step))
        self._run = jax.jit(jax.vmap(rx.run_blocks, in_axes=(0, 1),
                                     out_axes=(0, 1)))
        # placement relies on committed INPUT sharding (init_state/place);
        # XLA propagates it through the vmapped graph, no constraints needed
        self._sharding = NamedSharding(mesh, P(axis)) if mesh else None

    def init_state(self):
        state = self.rx.init_state(batch=(self.n,))
        if self._sharding is not None:
            state = jax.device_put(
                state, jax.tree_util.tree_map(lambda _: self._sharding,
                                              state))
        return state

    def place(self, arr):
        """Shard a (C, ...) or (B, C, ...) channel-major array."""
        if self._sharding is None:
            return jnp.asarray(arr)
        ndim = jnp.ndim(arr)
        if ndim >= 3:  # (B, C, ...): channel axis second
            sh = NamedSharding(self.mesh, P(None, self.axis))
        else:
            sh = self._sharding
        return jax.device_put(jnp.asarray(arr), sh)

    def step(self, state, blocks):
        """blocks: (C, 2*block_size_iq) uint8 — one block per channel."""
        return self._step(state, blocks)

    def run(self, state, blocks):
        """blocks: (B, C, 2*block_size_iq) uint8 — scan over B blocks."""
        return self._run(state, blocks)

    def run_segment(self, state, segments):
        """segments: (C, B*2*block_size_iq) uint8 — one fused pass per
        channel (see Receiver.run_segment)."""
        return self._step(state, segments)

    def run_channelized(self, state, ch, i_wide, q_wide, cstate):
        """Wideband segment pass fed straight from a Channelizer:
        ``(bank_state, out, chan_state)`` — the one entry every wideband
        serving path uses, so channelizer-side fast paths (the fused u8
        epilogue) apply everywhere at once."""
        u8, cstate = ch.call_u8(i_wide, q_wide, cstate)
        state, out = self.run_segment(state, u8)
        return state, out, cstate

    def run_channelized_fused(self, state, wf, i_wide, q_wide, wstate,
                              group: int = 0, weights=None):
        """Wideband segment pass through the FUSED wideband frontend
        (models/wideband_frontend.py): one wide-rate matmul emits every
        station's IF demod directly — no uint8 hop, no per-station
        frontend. ``wf`` is a FusedWidebandFrontend; same outputs as
        ``run_channelized`` up to the uint8 re-quantization the fused
        path no longer performs (it is the higher-fidelity serving path;
        decode decisions agree — tests/test_wideband_fused.py).

        ``group`` > 0 runs the station bank as C/group sequential
        lax.map sub-batches inside the same graph (the
        run_segment_grouped cache-locality trick: the per-station IF
        chains dominate the fused graph).

        ``weights``: optional (w, pc, ps) device operands from
        ``wf.device_weights()`` — the runtime-retunable serving form."""
        demod, wstate = wf(i_wide, q_wide, wstate, weights)
        state, out = self._bank_demod(state, demod, group)
        return state, out, wstate

    def _bank_demod(self, state, demod, group: int = 0):
        if group and group < self.n and self.n % group == 0:
            g = int(group)
            G = self.n // g
            split = lambda l: l.reshape((G, g) + l.shape[1:])
            join = lambda l: l.reshape((self.n,) + l.shape[2:])
            st_g = jax.tree_util.tree_map(split, state)
            d_g = demod.reshape(G, g, -1)
            new_st_g, out_g = jax.lax.map(
                lambda a: jax.vmap(self.rx.run_segment_demod)(a[0], a[1]),
                (st_g, d_g))
            return (jax.tree_util.tree_map(join, new_st_g),
                    jax.tree_util.tree_map(join, out_g))
        return self._step_demod(state, demod)

    @property
    def _step_demod(self):
        fn = getattr(self, "_step_demod_cache", None)
        if fn is None:
            fn = jax.jit(jax.vmap(self.rx.run_segment_demod))
            self._step_demod_cache = fn
        return fn

    def run_channelized_jit(self, state, ch, i_wide, q_wide, cstate):
        """Jitted ``run_channelized`` for eager serving loops (one cached
        graph per channelizer; shapes retrace as usual)."""
        fn = self._chan_jit_cache.get(id(ch))
        if fn is None:
            fn = self._chan_jit_cache[id(ch)] = jax.jit(
                lambda s, i, q, c: self.run_channelized(s, ch, i, q, c))
        return fn(state, i_wide, q_wide, cstate)

    def run_channelized_fused_jit(self, state, wf, i_wide, q_wide, wstate,
                                  group: int | None = None, weights=None):
        """Jitted ``run_channelized_fused`` for eager serving loops.

        ``group`` defaults to RTSDR_WB_GROUP (0, no grouping, when
        unset). ``weights``: (w, pc, ps) device operands
        (``wf.device_weights()``) for runtime-retunable serving."""
        if group is None:
            group = _default_wb_group()
        key = (id(wf), group)
        fn = self._chan_jit_cache.get(key)
        if fn is None:
            # ONE jitted fn: weights=None is an empty pytree, so jax
            # keeps separate traces for the constant / operand forms
            fn = self._chan_jit_cache[key] = jax.jit(
                lambda s, i, q, w, wts: self.run_channelized_fused(
                    s, wf, i, q, w, group=group, weights=wts))
        return fn(state, i_wide, q_wide, wstate, weights)

    def run_wideband_u8_jit(self, state, fe, raw_u8, festate,
                            group: int | None = None, weights=None):
        """LIVE-ingest wideband serving: interleaved raw uint8 capture
        bytes in, station decodes out — the upload stays bytes (a quarter
        of the host-to-device traffic of f32 rails). Both frontends
        deinterleave ON DEVICE via u8_to_rails (normalize + two stride-2
        slices — see its docstring for why that form)."""
        from real_time_sdr_tpu.models.wideband_frontend import (
            FusedWidebandFrontend, u8_to_rails)
        if group is None:
            group = _default_wb_group()
        if weights is not None and not isinstance(fe, FusedWidebandFrontend):
            raise ValueError(
                "operand weights (retunable serving) need the fused "
                "wideband frontend; the two-stage Channelizer path bakes "
                "its weights as jit constants")
        key = (id(fe), group, "u8")
        fn = self._chan_jit_cache.get(key)
        if fn is None:
            if isinstance(fe, FusedWidebandFrontend):
                # weights=None is an empty pytree: one jitted fn serves
                # both the constant- and operand-weights forms
                def _u8_step(s, raw, w, wts):
                    demod, w = fe(*u8_to_rails(raw), w, wts)
                    s, out = self._bank_demod(s, demod, group)
                    return s, out, w
            else:
                def _u8_step(s, raw, c, wts):
                    i_wide, q_wide = u8_to_rails(raw)
                    return self.run_channelized(s, fe, i_wide, q_wide, c)
            fn = self._chan_jit_cache[key] = jax.jit(_u8_step)
        return fn(state, raw_u8, festate, weights)

    def run_wideband_jit(self, state, fe, i_wide, q_wide, festate,
                         weights=None):
        """Serving entry for EITHER wideband frontend: dispatches on the
        object built by models.wideband_frontend.make_wideband_frontend
        (FusedWidebandFrontend or Channelizer). ``weights``: optional
        retunable device operands (fused frontend only)."""
        from real_time_sdr_tpu.models.wideband_frontend import \
            FusedWidebandFrontend
        if isinstance(fe, FusedWidebandFrontend):
            return self.run_channelized_fused_jit(state, fe, i_wide,
                                                  q_wide, festate,
                                                  weights=weights)
        if weights is not None:
            raise ValueError(
                "operand weights (retunable serving) need the fused "
                "wideband frontend; the two-stage Channelizer path bakes "
                "its weights as jit constants")
        return self.run_channelized_jit(state, fe, i_wide, q_wide, festate)

    def run_segment_grouped(self, state, segments, group: int = 32):
        """Segment pass over C channels executed as C/group sequential
        sub-batches inside ONE jitted graph.

        Where the per-sample cost of a segment pass rises with the channel
        batch (the working set leaves cache and per-byte weight reuse
        falls), ``lax.map`` over (C/group, group, ...) keeps each resident
        working set at a narrower width while XLA still sees a single
        compiled program. Results are exactly ``run_segment`` (the
        channels never interact)."""
        if group >= self.n:
            return self._step(state, segments)
        assert self.n % group == 0, (self.n, group)
        fn = self._grouped_cache.get(group)
        if fn is None:
            g = int(group)

            def grouped(state, segments):
                G = self.n // g
                split = lambda l: l.reshape((G, g) + l.shape[1:])
                join = lambda l: l.reshape((self.n,) + l.shape[2:])
                st_g = jax.tree_util.tree_map(split, state)
                seg_g = segments.reshape((G, g) + segments.shape[1:])
                new_st_g, out_g = jax.lax.map(
                    lambda a: jax.vmap(self.rx.step)(a[0], a[1]),
                    (st_g, seg_g))
                return (jax.tree_util.tree_map(join, new_st_g),
                        jax.tree_util.tree_map(join, out_g))

            fn = self._grouped_cache[group] = jax.jit(grouped)
        return fn(state, segments)
