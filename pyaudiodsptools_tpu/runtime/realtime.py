"""Realtime engine: native ring buffers around the jit-compiled chain step.

The reference's realtime story is a PyAudio duplex stream whose C callback
thread calls device.apply (Example3.py:20-46). The equivalent here:

  audio producer ──> NativeRing (in) ──> pump thread: device chain step
                                            │
  audio consumer <── NativeRing (out) <─────┘

The pump thread pops fixed blocks, runs the precompiled chain step (one
device dispatch), pushes results, and records deadline stats in the native
layer (blocks, xruns, worst-case ns vs the block_size/sample_rate budget —
the reference documents this budget in ModuleTests.py:24).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core.config import EngineConfig
from ..engine.chain import Chain
from ..engine.stream import StreamProcessor
from . import native_lib


class RealtimeEngine:
    """Push/pull streaming around a chain with native SPSC rings.

    >>> eng = RealtimeEngine(chain, cfg)
    >>> eng.start()
    >>> eng.push(samples)          # producer thread (e.g. audio input)
    >>> out = eng.pull(n)          # consumer thread (e.g. audio output)
    >>> eng.stop(); eng.stats()
    """

    def __init__(self, chain: Chain, cfg: EngineConfig,
                 ring_blocks: int = 64):
        self.cfg = cfg
        self.processor = StreamProcessor(chain, cfg)
        capacity = ring_blocks * cfg.block_size
        self.in_ring = native_lib.NativeRing(capacity)
        self.out_ring = native_lib.NativeRing(capacity)
        deadline_ns = int(1e9 * cfg.block_size / cfg.sample_rate)
        self._stats = native_lib.PumpStats(deadline_ns)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._busy = threading.Event()  # pump holds a popped, unwritten block
        self.dropped_samples = 0        # output-ring overflow loss (counted)

    def start(self) -> None:
        self.processor.warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def push(self, samples: np.ndarray) -> int:
        """Producer side: enqueue input samples; returns count accepted."""
        return self.in_ring.write(samples)

    def pull(self, n: int) -> np.ndarray:
        """Consumer side: dequeue up to n processed samples."""
        return self.out_ring.read(n)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until all queued input has been processed AND its output
        written to the out ring (a popped block in flight counts as queued)."""
        deadline = time.monotonic() + timeout
        B = self.cfg.block_size
        while ((self.in_ring.available() >= B or self._busy.is_set())
               and time.monotonic() < deadline):
            time.sleep(0.001)

    def stats(self) -> dict:
        s = self._stats.snapshot()
        s["dropped_samples"] = self.dropped_samples
        return s

    def _pump(self) -> None:
        B = self.cfg.block_size
        while not self._stop.is_set():
            if self.in_ring.available() < B:
                time.sleep(0.0005)
                continue
            self._busy.set()
            block = self.in_ring.read(B)
            t0 = time.perf_counter_ns()
            out = self.processor.process(block)
            elapsed = time.perf_counter_ns() - t0
            self._stats.record(elapsed)
            # A full out ring means the consumer is behind: retry briefly
            # rather than silently dropping; count whatever is still lost so
            # misalignment is observable (stats()['dropped_samples']).
            written = self.out_ring.write(out)
            tries = 0
            while written < len(out) and tries < 200 and not self._stop.is_set():
                time.sleep(0.0005)
                written += self.out_ring.write(out[written:])
                tries += 1
            if written < len(out):
                self.dropped_samples += len(out) - written
            self._busy.clear()
