"""FM discriminators: arctan-free quadrature derivative demodulator and the
arctan+unwrap variant.

Device twin of ``fmDemodNoArctan`` (reference: src/demod.cpp:3-24; Python
model ``fmDemod``, model/fmSupportLib.py:164-183):

    d[n] = (I[n]*(Q[n]-Q[n-1]) - Q[n]*(I[n]-I[n-1])) / (I[n]^2 + Q[n]^2)

with a zero-sample guard and the previous block's final (I, Q) carried as
state; and of ``fmDemodArctan`` (model/fmSupportLib.py:116-145, the demod
used by the primary block oracle model/fmMonoBlock.py:101):

    d[n] = wrap_pi(atan2(Q[n], I[n]) - atan2(Q[n-1], I[n-1]))

The reference carries the running UNWRAPPED phase; only its value mod 2*pi
ever affects the output, so the carried state here is the previous wrapped
angle. Both are pure elementwise work — XLA fuses them into the graph.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = ["fm_demod", "fm_demod_arctan"]

_TWO_PI = 2.0 * math.pi


def fm_demod(i_sig, q_sig, prev_i, prev_q):
    """Demodulate one block.

    i_sig, q_sig: (..., N); prev_i, prev_q: (...,) carried samples.
    Returns (demod (..., N), new_prev_i, new_prev_q).
    """
    di = jnp.diff(i_sig, axis=-1, prepend=prev_i[..., None])
    dq = jnp.diff(q_sig, axis=-1, prepend=prev_q[..., None])
    num = i_sig * dq - q_sig * di
    den = i_sig * i_sig + q_sig * q_sig
    zero = (i_sig == 0) & (q_sig == 0)
    out = jnp.where(zero, 0.0, num / jnp.where(den == 0, 1.0, den))
    return out, i_sig[..., -1], q_sig[..., -1]


def fm_demod_arctan(i_sig, q_sig, prev_theta):
    """Arctan+unwrap demodulation of one block (``fmDemodArctan`` twin).

    i_sig, q_sig: (..., N); prev_theta: (...,) previous wrapped angle.
    Returns (demod (..., N), new_prev_theta). np.unwrap's strict |d| > pi
    correction leaves d == +-pi untouched, matched here by shifting only
    when round(d / 2pi) is nonzero (round-half-even at the boundary).
    """
    theta = jnp.arctan2(q_sig, i_sig)
    d = jnp.diff(theta, axis=-1, prepend=prev_theta[..., None])
    out = d - _TWO_PI * jnp.round(d / _TWO_PI)
    return out, theta[..., -1]
