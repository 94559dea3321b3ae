"""Streaming driver: realtime-style block-by-block processing.

The reference's realtime path is a PyAudio callback mutating device state
(Example3.py:20-25) with an 11.6 ms deadline per 512-sample block
(ModuleTests.py:24). The equivalent here (SURVEY.md §3.4): a host-side driver
that feeds fixed-shape blocks to a pre-compiled chain step and carries the
state pytree explicitly. ``warmup()`` triggers compilation before the first
deadline; state snapshot/restore gives checkpoint/resume for long renders
(SURVEY.md §5).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import EngineConfig
from .chain import Chain


class StreamProcessor:
    """Carries chain state across fixed-size blocks.

    >>> sp = StreamProcessor(chain, cfg)
    >>> sp.warmup()                  # compile before the realtime deadline
    >>> out = sp.process(block)      # inside the audio callback
    """

    def __init__(self, chain: Chain, cfg: EngineConfig,
                 batch_shape: tuple[int, ...] = ()):
        self.chain = chain
        self.cfg = cfg
        self.batch_shape = batch_shape
        self.state = chain.init_state(batch_shape)

    def warmup(self) -> None:
        """Compile the step and discard the result (state is unchanged)."""
        silent = jnp.zeros(self.batch_shape + (self.cfg.block_size,), jnp.float32)
        self.chain.step(self.state, silent)

    def process(self, block) -> np.ndarray:
        """Process one ``(..., block_size)`` block, advancing internal state."""
        block = jnp.asarray(block)
        if block.shape[-1] != self.cfg.block_size:  # pad the final partial block
            pad = self.cfg.block_size - block.shape[-1]
            n = block.shape[-1]
            block = jnp.pad(block, [(0, 0)] * (block.ndim - 1) + [(0, pad)])
            self.state, out = self.chain.step(self.state, block)
            return np.asarray(out)[..., :n]
        self.state, out = self.chain.step(self.state, block)
        return np.asarray(out)

    def process_stream(self, blocks: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        for b in blocks:
            yield self.process(b)

    def reset(self) -> None:
        self.state = self.chain.init_state(self.batch_shape)

    # -- checkpoint / resume -------------------------------------------------
    # The entire engine state is one pytree (filter histories, envelope
    # counters, delay buffers, LFO phase) — serializing it and feeding it back
    # is all resume takes (SURVEY.md §5 "checkpoint/resume").

    def save_state(self, path: str) -> None:
        leaves, _ = jax.tree.flatten(self.state)
        np.savez(path, *[np.asarray(leaf) for leaf in leaves])

    def load_state(self, path: str) -> None:
        archive = np.load(path)
        leaves = [archive[k] for k in archive.files]
        _, treedef = jax.tree.flatten(self.state)
        self.state = jax.tree.unflatten(treedef, [jnp.asarray(l) for l in leaves])
