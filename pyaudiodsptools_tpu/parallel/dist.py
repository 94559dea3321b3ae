"""Multi-host distributed runtime (SURVEY.md §2.4, §7 step 6).

The reference has no distributed layer at all; this module supplies one:
``jax.distributed.initialize`` with an explicit coordinator, a global
('channel', 'time') mesh spanning all hosts (channel groups cross the
network between hosts, time halos stay on the links within a host), and
per-host channel I/O helpers so each host only touches its own shard of the
audio.

Single-host multi-device works through the same path (initialize() is then a
no-op). Multi-host correctness is CI-tested via the virtual-device mesh
(tests/test_parallel.py) and the multi-process CPU test
(tests/test_dist_multiprocess.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from ..core.config import EngineConfig
from ..engine.chain import Chain
from .sharding import ShardedRenderer


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the JAX distributed runtime. Pass the coordinator
    (``host:port``), process count and this process's id; with no arguments
    JAX can only auto-detect a cluster environment that provides them."""
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(time: int = 1) -> Mesh:
    """('channel', 'time') mesh over ALL devices in the job (every host's
    chips). Channel groups land on different hosts first, so cross-host
    traffic is the embarrassingly-parallel channel axis, while time halos
    stay within a host's devices."""
    devices = jax.devices()
    n = len(devices)
    if n % time:
        raise ValueError(f"{n} devices not divisible by time={time}")
    arr = np.asarray(devices).reshape(n // time, time)
    return Mesh(arr, axis_names=("channel", "time"))


def host_channel_slice(total_channels: int) -> slice:
    """The channel range this host is responsible for feeding/draining."""
    pid, np_ = jax.process_index(), jax.process_count()
    if total_channels % np_:
        raise ValueError(f"{total_channels} channels not divisible by "
                         f"{np_} hosts")
    per = total_channels // np_
    return slice(pid * per, (pid + 1) * per)


def distributed_renderer(chain: Chain, cfg: EngineConfig,
                         time: int = 1) -> ShardedRenderer:
    """A ShardedRenderer over the global multi-host mesh."""
    return ShardedRenderer(chain, cfg, global_mesh(time=time))


def render_local_channels(renderer: ShardedRenderer,
                          local_signal) -> "jax.Array":
    """Multi-host render where each host feeds ONLY its own channels.

    ``local_signal``: (local_channels, n) float32 on this host —
    ``host_channel_slice``'s share of the global channel range (every host
    must pass the same n). The global device array is assembled shard-wise
    (no host ever materializes other hosts' audio), rendered once, and this
    host's output shard is returned as (local_channels, n).
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core import block as blk

    local_signal = np.asarray(local_signal, dtype=np.float32)
    if local_signal.ndim != 2:
        raise ValueError("render_local_channels expects (channels, n) audio")
    n = local_signal.shape[1]
    cfg = renderer.cfg
    mesh = renderer.mesh
    pad = (-n) % (mesh.shape["time"] * cfg.block_size)
    if pad:
        local_signal = np.pad(local_signal, ((0, 0), (0, pad)))
    local_blocks = np.asarray(
        blk.make_blocks(jnp.asarray(local_signal), cfg.block_size))
    total_channels = local_signal.shape[0] * jax.process_count()
    global_shape = (total_channels,) + local_blocks.shape[1:]
    sharding = NamedSharding(mesh, P("channel", "time", None))
    blocks = jax.make_array_from_process_local_data(
        sharding, local_blocks, global_shape)
    out = renderer.render_blocks(blocks)
    local_out = jnp.concatenate(_gather_local(out), axis=0)
    return blk.combine_blocks(local_out)[..., :n]


def _gather_local(out):
    """This host's output shards assembled into (channel_group, nb, B)
    arrays: shards sharing a channel range are concatenated along time,
    channel groups returned in order."""
    rows: dict[int, list] = {}
    for s in sorted(out.addressable_shards,
                    key=lambda s: (s.index[0].start or 0,
                                   s.index[1].start or 0)):
        c0 = s.index[0].start or 0
        rows.setdefault(c0, []).append(np.asarray(s.data))
    return [np.concatenate(parts, axis=1) for _, parts in sorted(rows.items())]


def sharded_meters(out_blocks) -> dict:
    """Global peak / RMS over a sharded render result — the cross-shard
    reductions (max/mean) compile to psum/all-reduce collectives over the
    mesh (SURVEY.md §5 metering plan)."""
    import jax.numpy as jnp

    @jax.jit
    def meters(o):
        return {"peak": jnp.max(jnp.abs(o)),
                "rms": jnp.sqrt(jnp.mean(jnp.square(o)))}

    return {k: float(v) for k, v in meters(out_blocks).items()}
