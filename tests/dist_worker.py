"""Subprocess worker for the 2-process jax.distributed CPU test.

Each process pins the CPU backend with N virtual devices IN-PROCESS (so a
JAX_PLATFORMS or XLA_FLAGS inherited from the parent cannot change it),
joins the distributed runtime, renders ONLY its own channel shard through
``parallel.dist``, and writes the local result to an .npy for the parent
test to compare against a single-process render.

Usage: python dist_worker.py <pid> <nprocs> <port> <devices_per_proc> <out.npy>
"""

import sys


def main() -> None:
    pid, nprocs, port, dev_per_proc = map(int, sys.argv[1:5])
    out_path = sys.argv[5]

    import jax

    jax.config.update("jax_num_cpu_devices", dev_per_proc)
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from pyaudiodsptools_tpu import Chain, EngineConfig, ops
    from pyaudiodsptools_tpu.parallel import dist

    dist.init_distributed(f"localhost:{port}", num_processes=nprocs,
                          process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()

    cfg = EngineConfig(sample_rate=44100, block_size=512)
    # FIR (time-parallel, halo exchange) + stateless + a recurrent op (channel
    # -gathered path) — all three sharding behaviors cross the process split.
    chain = Chain([
        ops.lowcut(cfg, 200.0),
        ops.tremolo(cfg, 0.3, 5.0),
        ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
        ops.softclipper(cfg, 0.44),
    ])

    total_channels = 4
    n = 512 * 8
    rng = np.random.default_rng(11)
    sig = (rng.standard_normal((total_channels, n)) * 0.4).astype(np.float32)

    renderer = dist.distributed_renderer(chain, cfg, time=dev_per_proc)
    local = sig[dist.host_channel_slice(total_channels)]
    out = dist.render_local_channels(renderer, local)
    np.save(out_path, np.asarray(out))


if __name__ == "__main__":
    main()
