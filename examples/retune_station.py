"""Re-point one station of a live wideband grid WITHOUT recompiling.

Usage: python examples/retune_station.py

The reference retunes by restarting ``rtl_sdr -f`` (and the receiver with
it) — seconds of dead air, all state lost. Here the fused wideband
frontend's fold weights are served as DEVICE OPERANDS
(``FusedWidebandFrontend.device_weights``), so ``retune(station, hz)``
rebuilds one station's weight columns host-side (microseconds of numpy),
re-uploads, and the SAME compiled graph keeps serving: every other
station's DSP and framer state carries straight through
(experiments/retune_latency.py measures retune->decoded latency). The CLI
twin is
``--retune SEG:STATION:HZ``.
"""

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root

# JAX's default backend; JAX_PLATFORMS=cpu runs it on a CPU-only host
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.models.wideband_frontend import FusedWidebandFrontend
from real_time_sdr_tpu.models.rds_framing import RdsFramer
from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.parallel.channel import ChannelBank
from real_time_sdr_tpu.utils import synth


def main() -> None:
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    # three transmitters on the air; our 2-station grid starts on A+B
    sky = [dict(offset_hz=-600_000, ps_name="SVC-A   ", pi=0xA111),
           dict(offset_hz=800_000, ps_name="SVC-B   ", pi=0xB222),
           dict(offset_hz=1_200_000, ps_name="SVC-C   ", pi=0xC333)]
    n_blocks = 48
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, sky, n_blocks)

    wf = FusedWidebandFrontend(cfg, wide_fs, [-600_000, 800_000])
    bank = ChannelBank(rx, n_channels=2)
    bs, ws = bank.init_state(), wf.init_state()
    framers = [RdsFramer(), RdsFramer()]

    seg = 12
    n_seg = cfg.block_size_iq * wf.decim * seg

    def serve(lo, hi):
        nonlocal bs, ws
        bs, out, ws = bank.run_wideband_jit(
            bs, wf, jnp.asarray(iw[lo:hi]), jnp.asarray(qw[lo:hi]), ws,
            weights=wf.device_weights())
        nbits = np.asarray(out.rds_nbits)
        bits = np.asarray(out.rds_bits)
        for k in range(2):
            for bi in range(nbits.shape[1]):
                if nbits[k, bi] > 0:
                    framers[k].feed(bits[k, bi][:nbits[k, bi]])

    for s in range(2):
        serve(s * n_seg, (s + 1) * n_seg)
    print(f"before retune: ch0 PS={framers[0].events.ps_name!r}  "
          f"ch1 PS={framers[1].events.ps_name!r}")

    wf.retune(1, 1_200_000)          # re-point station 1: B -> C
    framers[1] = RdsFramer()         # new program, fresh framer
    print("retuned station 1 -> +1.2 MHz (same compiled graph)")

    for s in range(2, 4):
        serve(s * n_seg, (s + 1) * n_seg)
    print(f"after  retune: ch0 PS={framers[0].events.ps_name!r}  "
          f"ch1 PS={framers[1].events.ps_name!r}")
    assert framers[0].events.ps_name == "SVC-A   "
    assert framers[1].events.ps_name == "SVC-C   "
    print("OK: station 0 uninterrupted, station 1 now decodes SVC-C")


if __name__ == "__main__":
    main()
