"""Long-axis inclusive prefix sum as matmuls.

XLA lowers ``jnp.cumsum`` over a long axis to ``reduce_window_sum``, a
windowed reduction whose cost grows with the axis (the tier-3 sync's phase
unwrap, ops/sync.py, runs one over every IF sample).

The matmul form: tile the axis into (rows, 128), compute every within-row
prefix with ONE dot against a constant lower-triangular ones matrix, then
add the exclusive row offsets (a recursively tiny prefix sum of the row
totals). Work is 128x the data (one 128-MAC dot per element) but runs on
the matrix unit with no sequential dependence; numerics are f32 dot
accumulation (tree order) instead of sequential adds — same error class,
not bit-identical.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["prefix_sum"]

_TILE = 128


def prefix_sum(x: jax.Array, *, min_matmul: int = 1024) -> jax.Array:
    """Inclusive prefix sum along the last axis (f32).

    Equivalent to ``jnp.cumsum(x, axis=-1)`` up to f32 summation order.
    Sizes below ``min_matmul`` fall through to ``jnp.cumsum`` (the
    reduce_window lowering is fine when the window is short).
    """
    n = x.shape[-1]
    if n <= min_matmul:
        return jnp.cumsum(x, axis=-1)
    rows = -(-n // _TILE)
    pad = rows * _TILE - n
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)]) if pad else x
    t = xp.reshape(x.shape[:-1] + (rows, _TILE))
    # L[k, j] = 1 for k <= j: within[..., r, j] = sum_{k<=j} t[..., r, k]
    lower = jnp.asarray(np.tril(np.ones((_TILE, _TILE), np.float32)).T)
    within = jnp.einsum("...rk,kj->...rj", t, lower,
                        precision=jax.lax.Precision.HIGHEST)
    totals = within[..., -1]                       # (..., rows)
    off = prefix_sum(totals, min_matmul=min_matmul) - totals  # exclusive
    out = within + off[..., None]
    return out.reshape(x.shape[:-1] + (rows * _TILE,))[..., :n]
