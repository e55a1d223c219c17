"""Type-2 second-order PLL + NCO, two execution tiers.

Redesign of ``fmpll`` (reference: src/pll.cpp:4-61; Python model
model/fmPll.py:103-175). Loop constants Cp=2.666, Ci=3.555; per sample:

    e       = atan2(-x*fbQ, x*fbI)            # phase detector
    integ  += Ki*e                            # loop integrator
    phase  += Kp*e + integ                    # phase estimate
    trig   += 1
    arg     = 2*pi*(f/Fs)*trig + phase
    fb      = (cos arg, sin arg)              # feedback oscillator
    nco     = cos(arg*ncoScale + phaseAdjust) # scaled NCO output

Consumers see the NCO *delayed by one sample* (the reference emits N+1
samples with out[0] = previous block's final NCO and indexes 0..N-1,
src/pll.cpp:18 + src/stereo.cpp:83-85); :func:`pll_scan` returns that
consumer-visible N-vector directly.

Tier 1 (``pll_scan``): exact per-sample ``lax.scan`` recurrence — bit-faithful
but serial in time.

Tier 2 (``pll_newton``): block-parallel solve. The only nonlinearity is the
atan2 detector, whose derivative w.r.t. the oscillator angle is exactly -1
wherever the input is nonzero. Newton's method therefore converges
quadratically: linearize e around the current phase trajectory, solve the
resulting affine 2x2 recurrence in (integrator, phase) with a single
``lax.associative_scan`` of affine maps, repeat ``iters`` times. Each sweep is
log-depth and fully vectorized. Role: the block-parallel twin of the exact
loop for correctness work (reference-semantics parity tests, the dryrun's dp
configuration) — NOT the production path: the tier-3 feedforward
synchronizer (ops.sync) carries no recurrence at all and is what ships.

Numerical hygiene not in the reference: the oscillator ramp 2*pi*(f/Fs)*trig
is computed from an *integer* counter wrapped modulo 2*Fs/gcd(f,Fs) (exact),
and the phase estimate is wrapped modulo 4*pi at block boundaries (invariant
for ncoScale in {0.5, 1, 2}), so float32 never evaluates trig of large args.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["PllCarry", "PllParams", "pll_init", "pll_scan", "pll_newton"]

_CP = 2.666
_CI = 3.555
_FOUR_PI = 4.0 * math.pi


class PllCarry(NamedTuple):
    """Carried loop state (reference: include/pll.h:10-17)."""
    fbi: jax.Array        # feedback cos(arg)
    fbq: jax.Array        # feedback sin(arg)
    integ: jax.Array      # loop-filter integrator
    phase: jax.Array      # phase estimate (wrapped mod 4*pi across blocks)
    trig: jax.Array       # int32 oscillator counter, wrapped mod period
    last_nco: jax.Array   # previous block's final NCO sample


class PllParams(NamedTuple):
    """Static loop configuration (python ints/floats; hashable for jit)."""
    freq: int             # oscillator nominal frequency, Hz (integer)
    fs: int               # sample rate, Hz (integer)
    nco_scale: float = 1.0
    phase_adjust: float = 0.0
    norm_bw: float = 0.01

    @property
    def kp(self):
        return self.norm_bw * _CP

    @property
    def ki(self):
        return self.norm_bw * self.norm_bw * _CI

    @property
    def _ratio(self):
        g = math.gcd(self.freq, self.fs)
        return self.freq // g, self.fs // g

    @property
    def period(self) -> int:
        """Integer counter period: trig and trig+period give oscillator
        angles differing by a multiple of 4*pi."""
        _, fsr = self._ratio
        return 2 * fsr

    def trig_angle(self, trig):
        """Exact wrapped 2*pi*(f/Fs)*trig in [0, 4*pi)."""
        fr, fsr = self._ratio
        frac = (fr * trig) % (2 * fsr)   # int32; bounded by 2*fsr*fr
        return (2.0 * math.pi / fsr) * frac.astype(jnp.float32)


def pll_init(batch: tuple = ()) -> PllCarry:
    """Initial state matching the reference's block-arg init
    (src/stereo.cpp:52-58, src/rds.cpp:51-56; initial out[0]=1 comes from the
    carrier vector's seeded last element, src/stereo.cpp:44)."""
    f32 = partial(jnp.full, batch, dtype=jnp.float32)
    return PllCarry(fbi=f32(1.0), fbq=f32(0.0), integ=f32(0.0),
                    phase=f32(0.0), trig=jnp.full(batch, 0, dtype=jnp.int32),
                    last_nco=f32(1.0))


@partial(jax.jit, static_argnames=("p",))
def pll_scan(x: jax.Array, carry: PllCarry, p: PllParams):
    """Tier 1: exact sequential recurrence. x: (N,) -> (carrier (N,), carry).

    The returned carrier is the consumer-visible, one-sample-delayed NCO.
    """
    kp, ki = p.kp, p.ki

    def step(c: PllCarry, xk):
        e = jnp.arctan2(xk * (-c.fbq), xk * c.fbi)
        integ = c.integ + ki * e
        phase = c.phase + kp * e + integ
        trig = (c.trig + 1) % p.period
        arg = p.trig_angle(trig) + phase
        nco = jnp.cos(arg * p.nco_scale + p.phase_adjust)
        return PllCarry(jnp.cos(arg), jnp.sin(arg), integ, phase, trig,
                        nco), nco

    new_carry, ncos = jax.lax.scan(step, carry, x)
    carrier = jnp.concatenate([carry.last_nco[None], ncos[:-1]])
    new_carry = new_carry._replace(phase=jnp.mod(new_carry.phase, _FOUR_PI))
    return carrier, new_carry


def _largest_divisor_leq(n: int, target: int) -> int:
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


@partial(jax.jit, static_argnames=("p", "iters", "chunk_target"))
def pll_newton(x: jax.Array, carry: PllCarry, p: PllParams, iters: int = 3,
               chunk_target: int = 512):
    """Tier 2: chunked block-parallel Newton solve of the loop recurrence.

    Same interface as :func:`pll_scan`. The block is split into chunks of
    ~``chunk_target`` samples processed sequentially (lax.scan); inside each
    chunk the recurrence is solved by Newton sweeps that are fully parallel
    over time (one vectorized atan2 pass + one associative scan of 2x2 affine
    maps per sweep). Linearization error heals front-to-back by several
    hundred samples per sweep (the loop's closed-loop time constant is
    ~1/(kp) samples), so with chunk <= ~512 and ``iters`` >= 2 the chunk
    converges to the sequential solution even during acquisition transients.
    Sequential depth drops from N scan steps to N/chunk * iters scans.
    """
    n = x.shape[0]
    chunk = _largest_divisor_leq(n, chunk_target)

    def chunk_step(c, xc):
        ncos, c2 = _newton_chunk(xc, c, p, iters)
        return c2, ncos

    new_carry, ncos = jax.lax.scan(chunk_step, carry, x.reshape(-1, chunk))
    ncos = ncos.reshape(n)
    carrier = jnp.concatenate([carry.last_nco[None], ncos[:-1]])
    return carrier, new_carry


def _newton_chunk(x: jax.Array, carry: PllCarry, p: PllParams, iters: int):
    """Solve one chunk in parallel; returns (ncos (n,), new_carry)."""
    n = x.shape[0]
    kp, ki = p.kp, p.ki
    kpi = kp + ki

    # Oscillator ramp angles a[k] = wrapped 2*pi*(f/Fs)*(trig0+k+1), k=0..N-1.
    ks = jnp.arange(1, n + 1, dtype=jnp.int32)
    a = p.trig_angle((carry.trig + ks) % p.period)  # exact mod-4pi ramp

    # e_0 is always exact (detector angle comes from the carried feedback).
    e0 = jnp.arctan2(x[0] * (-carry.fbq), x[0] * carry.fbi)
    mask = (x != 0.0).astype(x.dtype)  # detector output is 0 at zero samples

    s0 = jnp.stack([carry.integ, carry.phase])  # [integrator, phase]

    def detector(phi):
        """e_k for k=1..N-1 given phase trajectory phi[k] (k=1..N-1)."""
        psi = a[:-1] + phi  # detector angle = previous step's arg
        return jnp.arctan2(x[1:] * (-jnp.sin(psi)), x[1:] * jnp.cos(psi))

    def solve(e_lin, m, phi_ref):
        """Solve s_{k+1} = A_k s_k + b_k for the linearized detector
        e_k ~= e_lin_k - m_k*(phi_k - phi_ref_k); k=0 uses the exact e0
        (m_0 = 0). Returns phase trajectory phi[1..N].

        The 2x2 affine maps are carried as six SEPARATE (n,)-arrays so every
        combine is a lane-aligned elementwise op — materializing (n, 2, 2)
        tensors would pad each tiny matrix to a full hardware tile.
        """
        g = e_lin + m * phi_ref
        ones = jnp.ones_like(m)
        elems = (ones, -ki * m,            # a11, a12
                 ones, 1.0 - kpi * m,      # a21, a22
                 ki * g, kpi * g)          # b1, b2

        def combine(l, r):
            l11, l12, l21, l22, lb1, lb2 = l
            r11, r12, r21, r22, rb1, rb2 = r
            return (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
                    r21 * l11 + r22 * l21, r21 * l12 + r22 * l22,
                    r11 * lb1 + r12 * lb2 + rb1,
                    r21 * lb1 + r22 * lb2 + rb2)

        p11, p12, p21, p22, v1, v2 = jax.lax.associative_scan(
            combine, elems, axis=-1)
        i0, ph0 = s0[0], s0[1]
        return p21 * i0 + p22 * ph0 + v2  # phi[1..N]

    # Initial trajectory: extrapolate the carried phase with the integrator,
    # which in lock equals the per-sample frequency correction
    # (phase_{k+1} - phase_k = kp*e_k + integ_{k+1} ~= integ). A constant
    # guess would drift > pi across a block under any frequency offset and
    # strand Newton on the wrong atan2 branch.
    zeros_m = jnp.zeros((), x.dtype)
    phi = carry.phase + jnp.arange(1, n + 1, dtype=x.dtype) * carry.integ
    for _ in range(iters):
        e_rest = detector(phi[:-1] if n > 1 else phi[:0])
        e_lin = jnp.concatenate([e0[None], e_rest])
        m = jnp.concatenate([zeros_m[None], mask[1:]])
        phi_ref = jnp.concatenate([jnp.zeros((1,), x.dtype), phi[:-1]])
        phi = solve(e_lin, m, phi_ref)

    # Final exact forward quantities from the converged trajectory.
    e_rest = detector(phi[:-1] if n > 1 else phi[:0])
    e_all = jnp.concatenate([e0[None], e_rest])
    integ = carry.integ + ki * jnp.cumsum(e_all)          # integ_{k+1}
    # phase_{k+1} = phase_0 + sum_{j<=k} (kp*e_j + integ_{j+1})
    phase_full = carry.phase + jnp.cumsum(kp * e_all + integ)
    arg = a + phase_full
    ncos = jnp.cos(arg * p.nco_scale + p.phase_adjust)
    new_carry = PllCarry(
        fbi=jnp.cos(arg[-1]), fbq=jnp.sin(arg[-1]),
        integ=integ[-1], phase=jnp.mod(phase_full[-1], _FOUR_PI),
        trig=(carry.trig + n) % p.period, last_nco=ncos[-1])
    return ncos, new_carry
