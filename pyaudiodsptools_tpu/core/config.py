"""Engine configuration.

The reference library uses a mutable module-as-singleton config
(``/root/reference/pyAudioDspTools/config.py:20-36``) whose values are snapshotted
by every device constructor — re-initializing after construction silently
desynchronizes devices. This framework replaces that with an immutable
:class:`EngineConfig` passed explicitly to op factories, so a config is bound to
the params it built, never global state.

A thin compatibility shim (``pyaudiodsptools_tpu.compat.config``) offers the
reference's ``initialize(sampling_rate, chunk_size)`` entry point for users
migrating from ``pyAudioDspTools``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Immutable engine-wide parameters.

    Attributes
    ----------
    sample_rate:
        Samples per second (Hz). Reference default is 44100.
    block_size:
        Samples per processing block ("chunk size" / "buffer size" in the
        reference, ``config.py:26-29``).
    dtype:
        Compute dtype for the signal path. float32 matches the reference's
        audio dtype and is the accelerators' native choice.
    """

    sample_rate: int = 44100
    block_size: int = 512
    dtype: Any = jnp.float32

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError(f"sample_rate must be positive, got {self.sample_rate}")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")

    @property
    def block_duration_ms(self) -> float:
        """Realtime budget per block in milliseconds (ModuleTests.py:24)."""
        return 1000.0 * self.block_size / self.sample_rate

    def ms_to_samples(self, ms: float) -> int:
        """Millisecond → sample conversion used throughout the reference
        (e.g. EffectCompressor.py:29, EffectDelay.py:31)."""
        return int((self.sample_rate / 1000) * ms)
