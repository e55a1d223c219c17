"""Sharded wideband serving: channelizer + channel bank in ONE mesh
computation.

The channel bank already shards its station axis (parallel/channel.py);
this module puts the CHANNELIZER inside the same pjit so a single wideband
capture is decoded to S stations across the device mesh without leaving
the graph (SURVEY.md section 2.3 data-parallelism row: "64+ FM stations
... sharded").

Sharding layout (station axis ``ch``):

- wideband i/q rails: replicated (every device reads the full capture —
  it is the SMALL array: n_wide vs S * n_wide / D of station output);
- mix-then-filter mode: per-station tone tables, mixed rails, decimator
  tails and basebands all shard on the station axis, so the big
  (2S, n_wide) intermediates never exist on any one device;
- folded-tone mode: the raw-rail history is tiny and replicated; the
  folded weight matrix columns (r-major, station-minor) and everything
  downstream of the matmul shard on stations via the constraint on the
  (S, n_out) basebands;
- receiver bank state/outputs: station axis sharded exactly as
  ChannelBank does.

XLA inserts no collectives in mix mode (the tone mix, FIR and receivers
are channel-local given a replicated input); fold mode's single shared
matmul partitions by output columns.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from real_time_sdr_tpu.models.channelizer import Channelizer, ChannelizerState
from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.wideband_frontend import (
    FusedWidebandFrontend, FusedWidebandState)


class ShardedWideband:
    """One wideband capture in, S sharded station decodes out."""

    def __init__(self, ch: Channelizer, rx: Receiver, mesh: Mesh,
                 axis: str = "ch"):
        assert len(ch.offsets) % mesh.shape[axis] == 0, (
            f"{len(ch.offsets)} stations do not tile the {axis} axis "
            f"({mesh.shape[axis]} shards)")
        self.ch = ch
        self.rx = rx
        self.mesh = mesh
        self.axis = axis
        self._sh_ch = NamedSharding(mesh, P(axis))
        self._sh_ch2 = NamedSharding(mesh, P(axis, None))
        self._sh_rep = NamedSharding(mesh, P())
        self._jit = jax.jit(self._step)

    # -- placement ---------------------------------------------------------

    def _chan_state_shardings(self):
        st = self.ch.init_state()
        if self.ch.fold and self.ch.tone_period:
            # raw-rail history (1, T-1) + scalars: replicate everything
            return jax.tree_util.tree_map(lambda _: self._sh_rep, st)
        return ChannelizerState(
            i_tails=self._sh_ch2, q_tails=self._sh_ch2,
            ph_re=self._sh_ch, ph_im=self._sh_ch, pos=self._sh_rep)

    def init_state(self):
        # build the states INSIDE a jit with out_shardings (instead of
        # device_put) so the same code works on a multi-process mesh, where
        # host arrays cannot be device_put across non-addressable devices
        cs = self.ch.init_state()
        bs = self.rx.init_state(batch=(len(self.ch.offsets),))
        sh = (self._chan_state_shardings(),
              jax.tree_util.tree_map(lambda _: self._sh_ch, bs))
        return jax.jit(lambda: (cs, bs), out_shardings=sh)()

    # -- the fused step ------------------------------------------------------

    def _step(self, cstate, bstate, i_wide, q_wide):
        if self.ch._fold_static:
            # fused epilogue: the (S, n_out) f32 rails never materialize;
            # the station shard constraint rides the u8 output (columns of
            # the fold matmul partition by station exactly as before)
            u8, cstate = self.ch.call_u8(i_wide, q_wide, cstate)
            u8 = jax.lax.with_sharding_constraint(u8, self._sh_ch2)
        else:
            (i_ds, q_ds), cstate = self.ch(i_wide, q_wide, cstate)
            i_ds = jax.lax.with_sharding_constraint(i_ds, self._sh_ch2)
            q_ds = jax.lax.with_sharding_constraint(q_ds, self._sh_ch2)
            u8 = jax.lax.with_sharding_constraint(
                self.ch.to_uint8(i_ds, q_ds), self._sh_ch2)
        bstate, out = jax.vmap(self.rx.run_segment)(bstate, u8)
        return cstate, bstate, out

    def replicate(self, arr: np.ndarray) -> jax.Array:
        """Host rail -> globally replicated device array (every process
        must pass identical data — the wideband capture is shared)."""
        arr = np.asarray(arr)
        return jax.make_array_from_callback(arr.shape, self._sh_rep,
                                            lambda idx: arr[idx])

    def step(self, cstate, bstate, i_wide, q_wide):
        """i_wide/q_wide: (n,) f32 wideband rails (host or replicated
        global arrays); returns (cstate, bstate, out) with every
        station-major leaf sharded."""
        if not (isinstance(i_wide, jax.Array)
                and i_wide.sharding == self._sh_rep):
            i_wide = self.replicate(i_wide)
        if not (isinstance(q_wide, jax.Array)
                and q_wide.sharding == self._sh_rep):
            q_wide = self.replicate(q_wide)
        return self._jit(cstate, bstate, i_wide, q_wide)


class ShardedFusedWideband:
    """One wideband capture in, S sharded station decodes out — through
    the FUSED one-matmul frontend (models/wideband_frontend.py, the
    single-chip wideband serving default).

    Sharding layout (station axis ``ch``):

    - wideband rails, raw-rail tails and the tone position: replicated
      (the rails are the SMALL shared operand; each device re-runs the
      elementwise frame construction locally rather than receiving a
      broadcast of station outputs);
    - the fold weight matrix, viewed (2J, R, 2, S), shards on its
      station axis — each device's matmul covers only ITS stations'
      columns (1/n of the FLOPs), run under ``shard_map`` so the
      partitioning is explicit, not a GSPMD guess;
    - residual rotation tables, carried discriminator samples, the
      (S, n_if) demod, and the whole receiver bank shard on stations.

    No collectives anywhere: the only shared value is the replicated
    input, exactly like the mix-mode ShardedWideband.
    """

    def __init__(self, wf: FusedWidebandFrontend, rx: Receiver, mesh: Mesh,
                 axis: str = "ch"):
        s_ch = len(wf.offsets)
        assert s_ch % mesh.shape[axis] == 0, (
            f"{s_ch} stations do not tile the {axis} axis "
            f"({mesh.shape[axis]} shards)")
        self.wf = wf
        self.rx = rx
        self.mesh = mesh
        self.axis = axis
        self._sh_ch = NamedSharding(mesh, P(axis))
        self._sh_rep = NamedSharding(mesh, P())
        self._w_src = None   # identity token: wf.retune swaps wf._w
        self._jit = jax.jit(self._step)

    def _weights(self):
        """Current fold weights as DEVICE OPERANDS, station-major on the
        LAST axis of a (2J, R, 2, S) view (the shard-local reshape back
        to (2J, R*2*S_local) is exactly the unsharded column layout with
        s_ch -> S_local). Re-uploaded when ``wf.retune`` swapped the
        host matrix (retune is copy-on-write, so object identity is the
        staleness token) — weights are jit ARGUMENTS here, never baked
        constants, so a retune propagates without retracing."""
        wf = self.wf
        if self._w_src is not wf._w:
            s_ch = len(wf.offsets)
            self._w_src = wf._w
            self._w4 = jnp.asarray(
                wf._w.reshape(2 * wf.j_w, wf.r_n, 2, s_ch))
        return self._w4, wf._pc, wf._ps

    def init_state(self):
        ws = self.wf.init_state()
        bs = self.rx.init_state(batch=(len(self.wf.offsets),))
        sh = (FusedWidebandState(
                  i_tail=self._sh_rep, q_tail=self._sh_rep,
                  prev_i=self._sh_ch, prev_q=self._sh_ch,
                  pos=self._sh_rep),
              jax.tree_util.tree_map(lambda _: self._sh_ch, bs))
        return jax.jit(lambda: (ws, bs), out_shardings=sh)()

    def _frontend_local(self, w4_l, pc_l, ps_l, i_tail, q_tail,
                        prev_i_l, prev_q_l, pos, i_wide, q_wide):
        """Per-shard body: FusedWidebandFrontend.core on this shard's
        (2J, R, 2, S_local) weight block — the SAME implementation as the
        unsharded path, so the two cannot drift."""
        wf = self.wf
        s_l = w4_l.shape[-1]
        w_l = w4_l.reshape(2 * wf.j_w, wf.r_n * 2 * s_l)
        return wf.core(w_l, pc_l, ps_l, i_tail, q_tail,
                       prev_i_l, prev_q_l, pos, i_wide, q_wide)

    def _step(self, wstate, bstate, i_wide, q_wide, w4, pc, ps):
        wf = self.wf
        ax = self.axis
        fe = jax.shard_map(
            self._frontend_local, mesh=self.mesh,
            in_specs=(P(None, None, None, ax), P(None, ax), P(None, ax),
                      P(), P(), P(ax), P(ax), P(), P(), P()),
            out_specs=(P(ax), P(ax), P(ax)),
            check_vma=False)
        demod, prev_i, prev_q = fe(
            w4, pc, ps,
            wstate.i_tail, wstate.q_tail, wstate.prev_i, wstate.prev_q,
            wstate.pos, i_wide, q_wide)
        n_if = demod.shape[-1]
        tl = wf.tail_len
        new_w = FusedWidebandState(
            jnp.concatenate([wstate.i_tail, i_wide])[-tl:],
            jnp.concatenate([wstate.q_tail, q_wide])[-tl:],
            prev_i, prev_q, (wstate.pos + n_if) % wf.lo)
        bstate, out = jax.vmap(self.rx.run_segment_demod)(bstate, demod)
        return new_w, bstate, out

    def replicate(self, arr: np.ndarray) -> jax.Array:
        arr = np.asarray(arr)
        return jax.make_array_from_callback(arr.shape, self._sh_rep,
                                            lambda idx: arr[idx])

    def step(self, wstate, bstate, i_wide, q_wide):
        """i_wide/q_wide: (n,) f32 wideband rails (host or replicated
        global arrays); returns (wstate, bstate, out) with every
        station-major leaf sharded."""
        if not (isinstance(i_wide, jax.Array)
                and i_wide.sharding == self._sh_rep):
            i_wide = self.replicate(i_wide)
        if not (isinstance(q_wide, jax.Array)
                and q_wide.sharding == self._sh_rep):
            q_wide = self.replicate(q_wide)
        w4, pc, ps = self._weights()
        return self._jit(wstate, bstate, i_wide, q_wide, w4, pc, ps)
