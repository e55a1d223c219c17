"""Shared measurement scaffolding for bench.py and experiments/.

Two pieces every whole-receiver measurement needs, kept in one place so the
benchmark and the A/B experiments cannot drift apart:

- a vmapped, jitted "digest step": runs the receiver over a segment batch
  and reduces every output leaf to ONE scalar, so XLA cannot drop any
  output as dead code and a timed run moves no audio back to the host
  (time it with ``jax.block_until_ready`` on the digest).
- decorrelated per-channel inputs built ON DEVICE: one host->device
  transfer of the base segment, then per-channel time shifts via
  dynamic_slice of a doubled copy.
"""

from __future__ import annotations


def digest_step(rx):
    """jit(vmap((state, seg) -> (state, scalar))) over ``rx.run_segment``.

    The scalar sums every output leaf (int32 leaves cast to f32), so any
    numerical change anywhere in the chain moves the digest — A/B configs
    compare it to prove equivalence.
    """
    import jax
    import jax.numpy as jnp

    def digest_fn(state, seg):
        s2, out = rx.run_segment(state, seg)
        sums = [jnp.sum(o if o.dtype != jnp.int32 else o.astype(jnp.float32))
                for o in jax.tree_util.tree_leaves(out)]
        return s2, sum(sums)

    return jax.jit(jax.vmap(digest_fn))


def shifted_channel_segments(iq, n_ch: int, n_len: int):
    """(n_ch, n_len) uint8: per-channel cyclic time shifts of ``iq[:n_len]``,
    built on device from one transferred base segment."""
    import jax
    import jax.numpy as jnp

    base2 = jnp.concatenate([jnp.asarray(iq[:n_len])] * 2)
    shifts = jnp.asarray([(2 * 997 * c) % n_len for c in range(n_ch)],
                         jnp.int32)
    return jax.jit(jax.vmap(
        lambda s: jax.lax.dynamic_slice(base2, (s,), (n_len,))))(shifts)
