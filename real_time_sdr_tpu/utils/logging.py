"""Observability: gnuplot-style vector dumps and per-block timing traces.

Twin of the reference's logfunc layer (src/logfunc.cpp:14-43 ``logVector``
writing ../data/<name>.dat consumed by data/example.gnuplot) plus the
framework-level additions the reference lacks (SURVEY.md section 5):
a real-time budget tracker and a speed-of-light cost model.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


def log_vector(name: str, data, out_dir: str = "data",
               index=None) -> str:
    """Dump (index, value) pairs to <out_dir>/<name>.dat (logVector twin)."""
    os.makedirs(out_dir, exist_ok=True)
    data = np.asarray(data).ravel()
    if index is None:
        index = np.arange(len(data))
    path = os.path.join(out_dir, f"{name}.dat")
    with open(path, "w") as f:
        f.write(f"# {name}\n")
        for i, v in zip(np.asarray(index).ravel(), data):
            f.write(f"{i}\t{v:.8g}\n")
    return path


class BlockTimer:
    """Tracks per-block wall clock against the real-time budget."""

    def __init__(self, budget_s: float):
        self.budget = budget_s
        self.times: list[float] = []

    @contextlib.contextmanager
    def block(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def realtime_factor(self) -> float:
        tot = sum(self.times)
        return (self.budget * len(self.times) / tot) if tot else float("inf")

    def summary(self) -> str:
        if not self.times:
            return "no blocks timed"
        arr = np.array(self.times)
        return (f"{len(arr)} blocks: mean {arr.mean()*1e3:.2f} ms, "
                f"p99 {np.quantile(arr, 0.99)*1e3:.2f} ms, budget "
                f"{self.budget*1e3:.2f} ms, {self.realtime_factor:.1f}x "
                f"real time")


# Published per-device peaks for speed-of-light accounting, keyed by
# jax.Device.device_kind. H100 SXM: NVIDIA's data sheet, dense rates
# without sparsity, at the full 700 W power limit. "f32" is the rate
# outside the tensor cores, which is where Precision.HIGHEST f32 dots run;
# "bf16" is the tensor-core rate that bf16 operands with f32 accumulation
# reach. A device missing from the table is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "hbm_bps": 3.35e12,
                              "source": "NVIDIA H100 SXM data sheet"},
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peak table entry for ``device_kind`` (default: the first JAX
    device's). Raises KeyError for a device the table does not know."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to utils.logging.PEAKS (known: {sorted(PEAKS)})") from None


def _merge_shared(costs: list[dict], n: int, tail_len: int) -> dict:
    """Combine cost dicts of FIRs that ride ONE shared frame matrix
    (ops.fir.FIRBank / shared_frames_apply): the stage input is read
    once, not once per member."""
    el = 2 if all("bf16" in c["kind"] for c in costs) else 4
    byts = sum(c["bytes"] for c in costs) \
        - (len(costs) - 1) * el * (n + tail_len)
    return {"kind": costs[0]["kind"] + f"_x{len(costs)}shared",
            "flops": sum(c["flops"] for c in costs), "bytes": byts,
            "w_bytes": sum(c.get("w_bytes", 0) for c in costs),
            "dims": costs[0]["dims"]}


def _ew(n_streams: float, n: int, const_streams: float = 0.0,
        channels: int = 1) -> dict:
    """Elementwise-chain cost: ``n_streams`` f32 arrays of length ``n``
    read or written in device memory, plus ``const_streams`` whose source is a
    per-dispatch CONSTANT shared by every channel (trig/angle tables —
    amortized over the channel batch; they already scale with blocks, so
    only the channel factor divides). FLOPs are negligible next to the
    byte traffic (elementwise work at these sizes is memory-bound)."""
    return {"kind": "elementwise", "flops": 0,
            "bytes": int(4 * n * (n_streams + const_streams / channels)),
            "w_bytes": 0, "dims": (0, 0, 0)}


def stage_costs(rx, channels: int = 1) -> list[tuple[str, dict]]:
    """Walk a Receiver's stages and collect per-block cost dicts.

    Per channel, per block; segment mode and channel banks scale the
    signal-proportional terms linearly (same per-sample work), while
    "w_bytes" (weights) and table constants stream once per dispatch —
    ``speed_of_light_report(rx, channels=, blocks=)`` amortizes them.
    Stages that share one frame matrix (the IF-bank BPF triple, each
    sync's complex FIR pair) are merged so their common input is charged
    once. Beyond the FIR matmuls the model charges the ELEMENTWISE
    chains' device-memory traffic (sync epilogues, mixes, matrixing, the
    RDS decode tail): each fused elementwise kernel reads its materialized
    inputs and writes its stage-boundary output once — counts below are
    stream tallies of the shipping graph."""
    cfg = rx.cfg
    out = [("frontend.rf(u8)", rx.frontend.rf_fir.cost(2 * cfg.block_size_iq))]
    n_if = cfg.if_block

    def add(prefix, obj, names, n):
        for name in names:
            f = getattr(obj, name, None)
            if f is not None:
                out.append((f"{prefix}.{name}", f.cost(n)))

    add("audio", rx.audio, ("audio_fir",), n_if)          # mono path
    if getattr(rx, "_if_bank", None) is not None:
        # stereo+RDS: pilot + stereo band + RDS band share ONE frame
        # matrix (models/receiver.py _if_bank)
        trio = [rx.audio.pilot_fir, rx.audio.band_fir,
                rx.rds_path.band_fir]
        out.append(("if.bank(3 shared BPFs)", _merge_shared(
            [f.cost(n_if) for f in trio], n_if, trio[0].tail_len)))
        add("audio", rx.audio, ("delay_fir", "mono_fir", "stereo_fir"),
            n_if)
    elif getattr(rx.audio, "_pb_bank", None) is not None:
        # stereo-only: pilot + stereo band share one frame matrix too
        # (models/audio.py _pb_bank)
        duo = [rx.audio.pilot_fir, rx.audio.band_fir]
        out.append(("audio.pb_bank(2 shared)", _merge_shared(
            [f.cost(n_if) for f in duo], n_if, duo[0].tail_len)))
        add("audio", rx.audio, ("delay_fir", "mono_fir", "stereo_fir"),
            n_if)
    else:
        add("audio", rx.audio, ("pilot_fir", "band_fir", "delay_fir",
                                "mono_fir", "stereo_fir"), n_if)

    def add_sync(prefix, sync, n):
        # the whole filter front half is ONE combined complex FIR (Hilbert
        # pair convolved with the ramp-modulated smoother, ops/sync.py);
        # its Re/Im taps ride one shared-frame matmul
        out.append((f"{prefix}.cfir(2 shared)", _merge_shared(
            [sync.cr_fir.cost(n), sync.ci_fir.cost(n)], n,
            sync.cr_fir.tail_len)))

    sync = getattr(rx.audio, "_sync", None)
    if sync is not None:
        add_sync("audio.sync", sync, n_if)
    if rx.rds_path is not None:
        r = rx.rds_path
        if getattr(rx, "_if_bank", None) is None:
            add("rds", r, ("band_fir",), n_if)
        add("rds", r, ("pilot_fir", "delay_fir"), n_if)
        out.append(("rds.baseband_fir", r.baseband_fir.cost(n_if)))
        out.append(("rds.rrc_fir", r.rrc_fir.cost(cfg.rds_block)))
        if r._sync is not None:
            add_sync("rds.sync", r._sync, n_if)

    # -- elementwise chains (tier-3 graph; bytes-only, see _ew) ----------
    n_audio = n_if * cfg.audio_up // cfg.audio_down
    if sync is not None:
        # sync epilogue + DSB mix: reads c_re/c_im (cfir outputs), the
        # stereo band and the delay slice; writes the mixed stream (the
        # stereo_fir stage input). ce/se ride the per-segment-length
        # tiled tables — constants shared by the whole channel batch.
        out.append(("audio.sync.epi+mix", _ew(5, n_if, 2, channels)))
        # L/R matrixing at the audio rate: read mono + stereo audio,
        # write left + right (the receiver outputs)
        out.append(("audio.matrix", _ew(4, n_audio)))
    elif rx.stereo:
        # tier-1/2 PLL path: the scan's carrier write + mix traffic
        out.append(("audio.pll+mix", _ew(5, n_if)))
    if rx.rds_path is not None and rx.rds_path._sync is not None:
        # general-path epilogue: c_re/c_im + delay reads, the wrapped-
        # delta stream through the matmul prefix sum (write + read), mixed
        # write; the angle table is a shared constant
        out.append(("rds.sync.epi+unwrap+mix", _ew(6, n_if, 1, channels)))
        # decode tail at the RDS rate: RRC output re-read by the CDR comb
        # and the slicer, per-block reductions, bit/segment emission
        out.append(("rds.decode-tail", _ew(5, cfg.rds_block)))
    elif rx.rds_path is not None:
        out.append(("rds.pll+mix", _ew(5, n_if)))
        out.append(("rds.decode-tail", _ew(5, cfg.rds_block)))
    return out


def speed_of_light_report(rx, file=None, channels: int = 1,
                          blocks: int = 1,
                          device_kind: str | None = None) -> dict:
    """Print per-stage FLOPs / bytes / speed-of-light floor per blk/ch.

    The SoL floor per stage is max(flops/peak_flops, bytes/peak_bw); the
    block's real-time budget is block_size_iq / rf_fs seconds, so
    budget/floor is the per-stage per-channel ceiling on x-realtime.

    ``channels``/``blocks`` describe the SERVING SHAPE the floor is for:
    weight matrices stream once per dispatch, not once per block-channel
    — an XLA batched einsum reads its weights once for the whole
    (channels, frames) batch, so "w_bytes" divides by channels*blocks.

    Peaks come from ``device_peaks(device_kind)`` (default: the first JAX
    device), which raises for a device it does not know. f32 stages run
    at the device's f32 rate (Precision.HIGHEST stays off the tensor
    cores), bf16 stages at its bf16 rate."""
    import sys as _sys
    file = file or _sys.stderr
    peaks = device_peaks(device_kind)
    cfg = rx.cfg
    budget = cfg.block_size_iq / cfg.rf_fs
    rows = stage_costs(rx, channels=channels)
    tot_f = tot_b = tot_t = 0.0
    print(f"# speed-of-light per blk/ch at serving shape "
          f"{channels}ch x {blocks}blk ({budget*1e3:.2f} ms of signal):",
          file=file)
    for name, c in rows:
        peak = (peaks["bf16_flops"] if "bf16" in c["kind"]
                else peaks["f32_flops"])
        w_b = c.get("w_bytes", 0)
        byts = c["bytes"] - w_b + w_b / (channels * blocks)
        t_f = c["flops"] / peak
        t_b = byts / peaks["hbm_bps"]
        t = max(t_f, t_b)
        bound = "compute" if t_f >= t_b else "memory"
        tot_f += c["flops"]; tot_b += byts; tot_t += t
        cf, j, r = c["dims"]
        print(f"#  {name:24s} {c['flops']/1e6:9.2f} MFLOP "
              f"{byts/1e3:9.1f} kB  ({cf}x{j}x{r})  "
              f"floor {t*1e6:8.2f} us  [{bound}-bound]", file=file)
    print(f"#  {'TOTAL':24s} {tot_f/1e6:9.2f} MFLOP {tot_b/1e3:9.1f} kB"
          f"{'':20s}floor {tot_t*1e6:8.2f} us -> SoL ceiling "
          f"{budget/tot_t:,.0f}x realtime per channel", file=file)
    return {"flops": tot_f, "bytes": tot_b, "floor_s": tot_t,
            "ceiling_x": budget / tot_t}
