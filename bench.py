"""Headline benchmark: full 8-effect chain, 64 channels, samples/s per chip.

Matches BASELINE.json's metric ("samples/s/chip through full 8-effect chain")
and config 4 (8-effect serial chain, 64 parallel channels). Baseline to beat:
the reference's measured single-core chain throughput, 0.28 Msamples/s
(BASELINE.md, measured by running the reference's own harness configs).

One run measures BOTH block sizes:
  * B=4096 — the BASELINE config-4 geometry. This is the HEADLINE value so
    `vs_baseline` stays apples-to-apples with the reference measurement.
  * B=512 — the reference's realtime chunk size, reported alongside in
    `detail.by_block_size`.

Each timed run renders N_PASSES chained passes (pass i+1 renders pass i's
output, so passes cannot overlap) and stops the clock on
``block_until_ready``.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N}
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_SAMPLES_PER_S = 0.28e6  # reference 8-effect chain, 1 CPU core
SAMPLE_RATE = 44100
HEADLINE_BLOCK = 4096            # BASELINE config 4 geometry
BLOCK_SIZES = (4096, 512)
CHANNELS = 64
SECONDS = 30.0
N_PASSES = 32


def _measure(jax, jnp, block_size: int):
    """Render SECONDS of generated audio through the flagship chain at one
    block size; returns (samples_per_s, wall_s_per_pass)."""
    from pyaudiodsptools_tpu import EngineConfig
    from __graft_entry__ import _chain8

    cfg = EngineConfig(sample_rate=SAMPLE_RATE, block_size=block_size)
    chain = _chain8(cfg)

    # Generate the test signal ON DEVICE: production audio is device-resident
    # after a single load. Band-limited-ish noise with bursts exercises every
    # automaton mode of the dynamics ops.
    n = int(SECONDS * SAMPLE_RATE)
    nb = -(-n // block_size)

    @jax.jit
    def gen(key):
        noise = 0.25 * jax.random.normal(key, (CHANNELS, nb * block_size),
                                         dtype=jnp.float32)
        t = jnp.arange(nb * block_size, dtype=jnp.float32)
        burst = (jnp.sin(2 * jnp.pi * t / (SAMPLE_RATE // 3)) > 0.6).astype(
            jnp.float32) * 0.5 + 0.3
        sig = jnp.clip(noise * burst, -0.99, 0.99)
        return sig.reshape(CHANNELS, nb, block_size)

    blocks = gen(jax.random.key(0)).block_until_ready()
    total_samples = CHANNELS * nb * block_size

    render = chain.render_blocks
    out = render(blocks).block_until_ready()  # compile + warm up
    peak = float(jnp.max(jnp.abs(out)))
    assert np.isfinite(peak) and peak > 0, f"bad output (peak={peak})"

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        o = out
        for _ in range(N_PASSES):
            o = render(o)
        o.block_until_ready()
        runs.append((time.perf_counter() - t0) / N_PASSES)
    dt = min(runs)
    return total_samples / dt, dt


def main() -> None:
    import jax
    import jax.numpy as jnp

    from pyaudiodsptools_tpu.core import settings

    settings.enable_compile_cache()
    by_block = {}
    for bs in BLOCK_SIZES:
        sps, dt = _measure(jax, jnp, bs)
        by_block[bs] = {"samples_per_s": round(sps, 1),
                        "wall_s": round(dt, 6)}

    head = by_block[HEADLINE_BLOCK]
    samples_per_s = head["samples_per_s"]
    dev = jax.devices()[0]
    result = {
        "metric": "8-effect chain throughput, 64 channels, 1 device",
        "value": samples_per_s,
        "unit": "samples/s",
        "vs_baseline": round(samples_per_s / BASELINE_SAMPLES_PER_S, 2),
        "detail": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "seconds_of_audio": SECONDS,
            "channels": CHANNELS,
            "block_size": HEADLINE_BLOCK,
            "wall_s": head["wall_s"],
            "passes_per_timed_region": N_PASSES,
            "realtime_factor_per_device": round(samples_per_s / SAMPLE_RATE,
                                                1),
            "by_block_size": {str(k): v for k, v in by_block.items()},
            "settings": settings.snapshot(),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
