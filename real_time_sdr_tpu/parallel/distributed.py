"""Multi-host deployment helpers.

The reference is strictly single-host (SURVEY.md section 5: shared-memory
mutex/condvar only). This framework scales across hosts the standard JAX
way: ``jax.distributed.initialize`` + a global device mesh; the channel axis
shards freely (zero coupling, the network only sees placement) and the time
axis rides the device interconnect via the halo exchange in
parallel.time_shard.

Per-host input feeding: each host reads/captures only the IQ channels that
land on its local devices (``host_channel_slice``), then
``jax.make_array_from_process_local_data`` assembles the global array.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up multi-host JAX (no-op on a single process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def channel_mesh(axis: str = "ch") -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def channel_time_mesh(n_ch_shards: int, axis_ch: str = "ch",
                      axis_time: str = "time") -> Mesh:
    devs = np.array(jax.devices())
    assert len(devs) % n_ch_shards == 0
    return Mesh(devs.reshape(n_ch_shards, -1), (axis_ch, axis_time))


def host_channel_slice(n_channels: int) -> slice:
    """Which channel rows this host process feeds (even split required)."""
    count = jax.process_count()
    if n_channels % count:
        raise ValueError(
            f"n_channels={n_channels} does not divide evenly over "
            f"{count} processes; the remainder channels would silently "
            "be fed by no host")
    per = n_channels // count
    start = jax.process_index() * per
    return slice(start, start + per)


def make_global_channel_array(mesh: Mesh, local_rows: np.ndarray,
                              axis: str = "ch"):
    """Assemble a (C_total, ...) global array from per-host channel rows."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_rows)
