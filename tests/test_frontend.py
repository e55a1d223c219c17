"""Frontend parity: DualPhaseFIR + fm_demod (models/frontend.Frontend)
against the golden float64 loop oracle, under the reference state contract
(src/filter.cpp:119 FIR tails + src/demod.cpp:21-22 carried discriminator
samples)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from golden import dsp as g
from real_time_sdr_tpu.config import mode_config
from real_time_sdr_tpu.models.frontend import Frontend, FrontendState


def _snr(ref, y):
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _golden_frontend(x, tail, h, down, prev_i, prev_q):
    K = len(h)
    xx = np.concatenate([tail, x])
    s = (xx.astype(np.float64) - 128.0) / 128.0
    i_s, q_s = s[0::2], s[1::2]
    gi, _ = g.fir_block(i_s[K - 1:], h, i_s[:K - 1], down)
    gq, _ = g.fir_block(q_s[K - 1:], h, q_s[:K - 1], down)
    return g.fm_demod_block(gi, gq, prev_i, prev_q)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_frontend_golden_parity(mode):
    """On random uint8 noise the demod's 1/|IQ|^2 amplifies rounding at
    near-zero-envelope samples (real FM is constant-modulus), so the gate
    is a 60 dB floor, not the >100 dB the FIR alone reaches."""
    cfg = mode_config(mode)
    rng = np.random.default_rng(7 + mode)
    fe = Frontend(cfg)
    n2 = 2 * cfg.block_size_iq
    x = rng.integers(0, 256, (n2,), dtype=np.uint8)
    tail = rng.integers(0, 256, (fe.rf_fir.tail_len,), dtype=np.uint8)
    gd, gpi, gpq = _golden_frontend(x, tail, fe.rf_fir._h, cfg.rf_decim,
                                    0.1, -0.2)
    st = FrontendState(jnp.asarray(tail), jnp.float32(0.1),
                       jnp.float32(-0.2))
    d, new = jax.jit(fe.__call__)(jnp.asarray(x), st)
    assert d.shape == gd.shape == (cfg.if_block,)
    assert _snr(gd, d) > 60.0
    assert np.array_equal(np.asarray(new.iq_tail), x[-fe.rf_fir.tail_len:])
    assert abs(float(new.prev_i) - gpi) < 1e-4
    assert abs(float(new.prev_q) - gpq) < 1e-4


def test_frontend_streaming_matches_oneshot():
    """Three chained blocks == one triple-length call (state contract).
    An FM (constant-envelope) input: on noise the discriminator's num/den
    is ill-conditioned and amplifies f32 reduction-order differences."""
    from real_time_sdr_tpu.utils import synth

    cfg = mode_config(0)
    fe = Frontend(cfg)
    n2 = 2 * cfg.block_size_iq
    xs, _ = synth.station_iq(cfg, 3)
    d_all, _ = fe(jnp.asarray(xs), fe.init_state())
    st, parts = fe.init_state(), []
    for b in range(3):
        d, st = fe(jnp.asarray(xs[b * n2:(b + 1) * n2]), st)
        parts.append(np.asarray(d))
    assert _snr(np.asarray(d_all, np.float64), np.concatenate(parts)) > 90.0


def test_frontend_batched():
    """vmap over a channel axis matches per-channel calls."""
    cfg = mode_config(0)
    rng = np.random.default_rng(13)
    fe = Frontend(cfg)
    n2 = 2 * cfg.block_size_iq
    xs = rng.integers(0, 256, (3, n2), dtype=np.uint8)
    st = FrontendState(
        jnp.asarray(rng.integers(0, 256, (3, fe.rf_fir.tail_len),
                                 dtype=np.uint8)),
        jnp.asarray([0.1, -0.5, 0.0], jnp.float32),
        jnp.asarray([0.2, 0.0, -0.3], jnp.float32))
    db, _ = jax.vmap(fe.__call__)(jnp.asarray(xs), st)
    for c in range(3):
        st_c = jax.tree_util.tree_map(lambda a: a[c], st)
        dc, _ = fe(jnp.asarray(xs[c]), st_c)
        np.testing.assert_allclose(np.asarray(db[c]), np.asarray(dc),
                                   atol=1e-6)
