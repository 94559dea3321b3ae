"""Realtime streaming — the reference's Example3.py.

The reference runs a PyAudio duplex stream with the effect in the C callback
(Example3.py:20-46) and polls CPU load. Here the native ring-buffer runtime
pumps fixed blocks through the precompiled chain step. When a PortAudio
binding (sounddevice / pyaudio) is installed, real duplex hardware drives
the rings via runtime.DuplexAudioStream — Example3's exact role; otherwise a
synthetic producer stands in, and deadline stats replace get_cpu_load().
"""

import time

import numpy as np

import os as _os
import sys as _sys

# allow standalone `python examples/<name>.py` without installing:
# the repo root is the import path when run from a checkout
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

from pyaudiodsptools_tpu import Chain, EngineConfig, ops
from pyaudiodsptools_tpu.core import generators
from pyaudiodsptools_tpu.runtime import (DuplexAudioStream, RealtimeEngine,
                                         available_backend)

cfg = EngineConfig(sample_rate=44100, block_size=512)
chain = Chain([ops.lowcut(cfg, 160), ops.compressor(cfg, -20.0, 0.5)])

engine = RealtimeEngine(chain, cfg)

if available_backend() is not None:
    # Real hardware: mic -> chain -> speakers for 10 s (Example3.py:39-46).
    with DuplexAudioStream(engine) as stream:
        for _ in range(10):
            time.sleep(1.0)
            s = engine.stats()
            print(f"live: {s['blocks']} blocks, worst "
                  f"{s['worst_ns'] / 1e6:.2f} ms, xruns {s['xruns']}, "
                  f"underrun {stream.underrun_samples}")
    raise SystemExit(0)

engine.start()

sig = np.asarray(generators.sine(440.0, cfg.sample_rate * 2, cfg.sample_rate)) * 0.5
budget_ms = cfg.block_duration_ms
try:
    i = 0
    while i < sig.size:
        i += engine.push(sig[i : i + 2048])
        time.sleep(0.001)
    engine.drain()
    out = engine.pull(sig.size)
finally:
    engine.stop()

stats = engine.stats()
print(f"processed {stats['blocks']} blocks of {cfg.block_size} "
      f"(budget {budget_ms:.1f} ms/block)")
print(f"mean {stats['mean_ns']/1e6:.3f} ms, worst {stats['worst_ns']/1e6:.3f} ms, "
      f"xruns {stats['xruns']}")
