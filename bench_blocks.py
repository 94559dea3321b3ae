"""Chain throughput across block sizes: the flagship 8-effect chain at the
reference's realtime size (512) up to the offline size (4096).

Block size changes the FIR planning unit and the streaming windows; this
records that the whole chain, not just the conv geometry tests, holds up at
each size. Each timed run renders 8 chained passes and stops the clock on
``block_until_ready``. Prints one JSON object.
"""

from __future__ import annotations

import json
import time

import numpy as np

SAMPLE_RATE = 44100
CHANNELS = 64
SECONDS = 30.0


def main() -> None:
    import jax
    import jax.numpy as jnp

    from pyaudiodsptools_tpu import EngineConfig
    from pyaudiodsptools_tpu.core import settings
    from __graft_entry__ import _chain8

    settings.enable_compile_cache()
    rows = {}
    for B in (512, 1024, 4096):
        cfg = EngineConfig(sample_rate=SAMPLE_RATE, block_size=B)
        chain = _chain8(cfg)
        n = int(SECONDS * SAMPLE_RATE)
        nb = -(-n // B)
        blocks = jax.jit(lambda k, nb=nb, B=B: jnp.clip(
            0.25 * jax.random.normal(k, (CHANNELS, nb, B), jnp.float32),
            -0.99, 0.99))(jax.random.key(0))
        out = chain.render_blocks(blocks).block_until_ready()
        assert np.isfinite(float(jnp.max(jnp.abs(out))))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            o = out
            for _ in range(8):
                o = chain.render_blocks(o)
            o.block_until_ready()
            times.append((time.perf_counter() - t0) / 8)
        dt = min(times)
        total = CHANNELS * nb * B
        rows[B] = {"wall_ms": round(dt * 1e3, 3),
                   "gsamples_per_s": round(total / dt / 1e9, 3)}
        print(f"# B={B}: {rows[B]}", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "8-effect chain throughput by block size, 64 channels",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "seconds": SECONDS, "channels": CHANNELS,
        "by_block_size": rows,
    }))


if __name__ == "__main__":
    main()
