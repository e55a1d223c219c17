"""Mueller–Muller decision-directed symbol-timing recovery (complex BPSK).

Twin of the symbol-sync loop in the reference's alternative RDS model
(model/pySDRRDS.py:36-55): per output symbol, take the sample at the
current fractional position, form the M&M error from the last three
symbol decisions, and advance the position by ``sps + gain*err``.

Differences from the reference, both accelerator-shaped:

- the reference pre-interpolates the whole stream 32x with resample_poly
  and indexes ``i_in*32 + int(mu*32)``; here the fractional sample is a
  2-point linear interpolation fetched with ``dynamic_slice`` — same
  quantization-free timing without materializing a 32x stream;
- the loop itself is a ``lax.while_loop`` with an integer/fractional
  split position carry (i_in, mu) exactly like the reference's — at the
  19 kHz input rate one second of signal is ~1188 iterations of a few
  elementwise ops, which is the cheapest correct program (cf.
  ops.rds_bits.cdr_tracked for the feedforward production-path variant).

Output symbols land in a fixed-size buffer (static shapes under jit);
``n_valid`` reports how many were produced.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["mm_timing"]


class _MMCarry(NamedTuple):
    i_in: jax.Array    # int32 integer input index
    mu: jax.Array      # f32 fractional part in [0, 1)
    i_out: jax.Array   # int32 symbols produced
    out1: jax.Array    # complex64 previous symbol
    out2: jax.Array    # complex64 symbol before that
    rail1: jax.Array   # complex64 sign-rail of out1
    rail2: jax.Array
    buf: jax.Array     # (n_max,) complex64


def _rail(c):
    return ((jnp.real(c) > 0).astype(jnp.float32)
            + 1j * (jnp.imag(c) > 0).astype(jnp.float32))


def comb_acquire(z: jax.Array, sps: int) -> jax.Array:
    """Initial timing phase by comb energy: argmax over the ``sps`` phases
    of mean |z[p::sps]|^2, refined to sub-sample by a parabolic fit of the
    peak and its neighbours (same estimator as ops.rds_bits.cdr_tracked).

    The M&M loop's decision-directed error has a weak acquisition basin on
    biphase-coded signals (it free-runs if started near an energy null —
    the reference model gets away with mu0=0.01 only because its capture
    is minutes long, model/pySDRRDS.py:41); one vectorized reshape-reduce
    puts the loop on a peak immediately. Returns f32 phase in [0, sps)."""
    from real_time_sdr_tpu.ops.rds_bits import comb_peak_phase

    n = (z.shape[-1] // sps) * sps
    e = jnp.mean(jnp.abs(z[..., :n].reshape(-1, sps)) ** 2, axis=0)
    return comb_peak_phase(e, sps)


def mm_timing(z: jax.Array, sps: float, gain: float = 0.01,
              mu0: float | jax.Array = 0.01):
    """z: (N,) complex64 at ``sps`` samples/symbol. ``mu0``: initial
    fractional sample position (may exceed 1, e.g. from comb_acquire).

    Returns (symbols (n_max,) complex64 zero-padded, n_valid int32)."""
    n = z.shape[-1]
    # 1% rate margin: a fast transmitter clock produces more than n/sps
    # symbols and the loop must not truncate the tail (10000 ppm headroom
    # vs the +-400 ppm the tests drive)
    n_max = int(n / sps * 1.01) + 8

    def interp(i, mu):
        pair = jax.lax.dynamic_slice(z, (i,), (2,))
        return pair[0] * (1.0 - mu) + pair[1] * mu

    def cond(c: _MMCarry):
        return (c.i_in < n - 2) & (c.i_out < n_max)

    def body(c: _MMCarry):
        cur = interp(c.i_in, c.mu)
        railc = _rail(cur)
        x = (railc - c.rail2) * jnp.conj(c.out1)
        y = (cur - c.out2) * jnp.conj(c.rail1)
        err = jnp.real(y - x)
        mu = c.mu + sps + gain * err
        adv = jnp.floor(mu)
        buf = jax.lax.dynamic_update_slice(c.buf, cur[None], (c.i_out,))
        return _MMCarry(c.i_in + adv.astype(jnp.int32), mu - adv,
                        c.i_out + 1, cur, c.out1, railc, c.rail1, buf)

    zero_c = jnp.zeros((), jnp.complex64)
    mu0 = jnp.asarray(mu0, jnp.float32)
    i0 = jnp.floor(mu0)
    init = _MMCarry(i0.astype(jnp.int32), mu0 - i0, jnp.int32(0),
                    zero_c, zero_c, zero_c, zero_c,
                    jnp.zeros((n_max,), jnp.complex64))
    final = jax.lax.while_loop(cond, body, init)
    return final.buf, final.i_out
