"""pyaudiodsptools_tpu — an accelerator-native audio-effects framework.

A from-scratch JAX/XLA re-design of the capabilities of pyAudioDspTools
(reference mounted read-only at /root/reference): effects are pure
``(params, state, block) -> (state, block)`` functions, chains are
jit-compiled pipelines, offline renders are block-parallel batched programs,
and multi-channel / long-audio workloads shard over a device mesh (see
``pyaudiodsptools_tpu.parallel``).

Layers:
  core      config, blocking, wav I/O, generators, gain/metering/dither
  ops       the effect kernel library (all reference effects)
  engine    Chain composition, offline render, streaming driver
  parallel  mesh building, channel/time sharding, halo exchange
  compat    drop-in ``pyAudioDspTools`` API (Create*().apply(chunk))
"""

from .core.config import EngineConfig
from .core import block, generators, metering, utility, wavio
from . import ops
from .engine import Chain, StreamProcessor, render, render_file

__version__ = "0.1.0"

__all__ = [
    "EngineConfig", "block", "generators", "metering", "utility", "wavio",
    "ops", "Chain", "StreamProcessor", "render", "render_file",
]
