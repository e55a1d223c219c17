"""Decode 4 FM stations in parallel from ONE wideband capture.

Usage: python examples/wideband_multistation.py

Synthesizes a 9.6 MS/s wideband capture containing four stations at
different frequency offsets, channelizes it (exact integer-phase mixers +
anti-alias decimation, models/channelizer.py), and decodes every station
through a vmapped receiver bank — the reference needs one rtl_sdr stream
and one process per station; here one capture feeds them all.
"""

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root

# JAX's default backend; JAX_PLATFORMS=cpu runs it on a CPU-only host
import jax.numpy as jnp
import numpy as np

from real_time_sdr_tpu.models.wideband_frontend import make_wideband_frontend
from real_time_sdr_tpu.models.receiver import Receiver
from real_time_sdr_tpu.models.rds_framing import RdsFramer
from real_time_sdr_tpu.utils import synth


def main() -> None:
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs  # 9.6 MS/s
    stations = [
        dict(offset_hz=-3_000_000, ps_name="STATION1", pi=0x1001),
        dict(offset_hz=-1_000_000, ps_name="STATION2", pi=0x1002),
        dict(offset_hz=1_000_000, ps_name="STATION3", pi=0x1003),
        dict(offset_hz=3_000_000, ps_name="STATION4", pi=0x1004),
    ]
    n_blocks = 24
    print(f"synthesizing {wide_fs/1e6:g} MS/s wideband capture, "
          f"{len(stations)} stations, {n_blocks} blocks ...")
    i_wide, q_wide, truths = synth.wideband_iq(cfg, wide_fs, stations,
                                               n_blocks)

    # the serving factory picks the fused one-matmul frontend on any
    # real station raster (RTSDR_WB_FUSED=0 restores the two-stage
    # Channelizer + uint8 receiver path)
    from real_time_sdr_tpu.parallel.channel import ChannelBank
    ch = make_wideband_frontend(cfg, wide_fs,
                                [s["offset_hz"] for s in stations])
    bank = ChannelBank(rx, n_channels=len(stations))
    framers = [RdsFramer() for _ in stations]

    def step(cstate, bstate, i, q):
        bstate, out, cstate = bank.run_wideband_jit(bstate, ch, i, q,
                                                    cstate)
        return cstate, bstate, out

    cstate = ch.init_state()
    bstate = rx.init_state(batch=(len(stations),))
    block_wide = cfg.block_size_iq * ch.decim
    for b in range(n_blocks):
        sl = slice(b * block_wide, (b + 1) * block_wide)
        cstate, bstate, out = step(cstate, bstate,
                                   jnp.asarray(i_wide[sl]),
                                   jnp.asarray(q_wide[sl]))
        bits = np.asarray(out.rds_bits)
        nbits = np.asarray(out.rds_nbits)
        for k, fr in enumerate(framers):
            fr.feed(bits[k, :nbits[k]])

    ok = 0
    for k, (st, fr) in enumerate(zip(stations, framers)):
        got = fr.events.ps_name
        mark = "ok" if got == st["ps_name"] else "MISMATCH"
        ok += got == st["ps_name"]
        print(f"  station {k} @ {st['offset_hz']/1e6:+.1f} MHz: "
              f"PS={got!r} (sent {st['ps_name']!r}) {mark}")
    print(f"{ok}/{len(stations)} stations decoded from one capture")


if __name__ == "__main__":
    main()
