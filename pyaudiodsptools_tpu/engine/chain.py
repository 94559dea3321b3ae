"""Effect chains: composition, state, and jit-compiled execution.

The reference's execution model is a nested Python loop — ``for chunk: for
device: chunk = device.apply(chunk)`` (Example1.py:14-18). Here a chain is
function composition over ``(params, state, block)`` ops; a whole offline
render is one jit-compiled program (each op's block-parallel ``offline`` path
chained, falling back to ``lax.scan`` of its streaming step), and a streaming
step is one jit-compiled block function with a single state pytree.

Params are passed as jit *arguments* (not captured as HLO constants), so
re-parameterizing a chain never retraces and the compiled program is shared
across chains with the same op structure.

Per-device-sequential offline processing is equivalent to the reference's
chunk-major loop because each device's state depends only on its own input
stream — the loop orders commute (SURVEY.md §3.2).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ..ops.base import Effect


class Chain:
    """An ordered effect chain with explicit state.

    >>> chain = Chain([ops.lowcut(cfg, 800), ops.compressor(cfg)])
    >>> state = chain.init_state()
    >>> state, out = chain.step(state, block)          # streaming (jitted)
    >>> out_blocks = chain.render_blocks(blocks)       # offline (jitted)
    """

    def __init__(self, effects: Sequence[Effect], fuse: bool = True):
        self.effects = tuple(effects)
        # The fusion structure below bakes in the CURRENT backend (the
        # fuse_lti_runs dynamics dispatch). A Chain built before the backend
        # is configured would silently carry the wrong structure, so the
        # build-time backend is stamped here and validated on first use.
        from ..core.settings import current_backend

        self._built_backend = current_backend()
        self._backend_checked = False
        # Consecutive LTI effects collapse into ONE segmented convolution
        # (their cascade's impulse response is the convolution of their
        # effective kernels) — e.g. lowcut -> highcut -> eq3band_fft becomes
        # a single FFT pass instead of three. Identical math, ~3x fewer
        # FFTs/HBM passes on FIR-heavy chains.
        # With fuse=False every op runs alone, but a dynamics op still takes
        # the backend's dynamics path (fuse_lti_runs on runs of length 1).
        self._exec_effects = fuse_lti_runs(self.effects) if fuse \
            else sum((fuse_lti_runs((e,)) for e in self.effects), ())
        # The op structure (pure function tuples) is the static jit key; the
        # params pytree is a runtime argument.
        self._structure = tuple(
            (e.init_state, e.step, e.offline) for e in self._exec_effects
        )
        self.params = tuple(e.params for e in self._exec_effects)
        self._jit_step = jax.jit(partial(chain_step, self._structure))
        self._jit_render = jax.jit(partial(chain_render, self._structure))
        # Donating variant: XLA reuses the input blocks' HBM for the first
        # intermediate, cutting the render's high-water memory by one full
        # signal buffer. Step state is NOT donated: state pytrees may alias
        # buffers across leaves (shared zeros at init, XLA output CSE), and
        # re-donating a shared buffer is a hard runtime error.
        self._jit_render_donate = jax.jit(
            partial(chain_render, self._structure), donate_argnums=(1,))

    def __iter__(self):
        return iter(self.effects)

    def __len__(self) -> int:
        return len(self.effects)

    @property
    def exec_effects(self) -> tuple[Effect, ...]:
        """The effects actually executed (LTI runs fused), in order."""
        return self._exec_effects

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> tuple[Any, ...]:
        return tuple(e.state(batch_shape) for e in self._exec_effects)

    def _check_backend(self):
        if self._backend_checked:
            return
        self._backend_checked = True
        from ..core.settings import current_backend

        now = current_backend()
        if now != self._built_backend:
            import warnings

            warnings.warn(
                f"Chain was built while the JAX backend was "
                f"'{self._built_backend}' but is executing on '{now}': "
                "its fusion structure was planned for the build-time "
                "backend. Rebuild the Chain after backend "
                "configuration (see pyaudiodsptools_tpu/core/settings.py).",
                stacklevel=3)

    def step(self, state, block):
        """Process one block through the whole chain (compiled once per
        block shape)."""
        self._check_backend()
        return self._jit_step(self.params, state, block)

    def render_blocks(self, blocks: jnp.ndarray,
                      donate: bool = False) -> jnp.ndarray:
        """Offline: process all ``(..., num_blocks, block_size)`` blocks.

        ``donate=True`` hands ownership of ``blocks`` to the render (the
        caller must not use it afterwards); saves one signal-sized HBM
        buffer on large renders."""
        self._check_backend()
        if donate:
            return self._jit_render_donate(self.params, blocks)
        return self._jit_render(self.params, blocks)


def fuse_lti_runs(effects: tuple[Effect, ...]) -> tuple[Effect, ...]:
    """Fuse runs of consecutive fusable effects:

    * runs of >= 2 LTI effects (carry an ``lti_kernel``) -> one FIR whose
      impulse response is the cascade's (ops/fft_filter.fuse_lti);
    * runs of dynamics automatons (compressor/gate, params is
      DynamicsParams), a lone one included -> one walk-kernel Effect
      (kernels.dynamics_walk.walk_effect) where
      core.settings.use_walk_kernel() says so. Elsewhere the faithful scans
      stay separate. Lone ops are routed too: the scan costs one device
      loop iteration per sample, so an unwrapped lone op would dominate any
      chain it appears in.
    """
    from ..core.settings import use_walk_kernel
    from ..ops.dynamics import DynamicsParams
    from ..ops.fft_filter import fuse_lti

    walk = use_walk_kernel()

    def kind(e: Effect) -> str:
        if e.lti_kernel is not None:
            return "lti"
        if walk and isinstance(e.params, DynamicsParams):
            return "dyn"
        return ""

    out: list[Effect] = []
    run: list[Effect] = []
    run_kind = ""

    def flush():
        if len(run) >= 2 and run_kind == "lti":
            out.append(fuse_lti(run))
        elif run_kind == "dyn" and run:
            from ..kernels.dynamics_walk import walk_effect

            out.append(walk_effect(run))
        else:
            out.extend(run)
        run.clear()

    for e in effects:
        k = kind(e)
        if k and k == run_kind:
            run.append(e)
        else:
            flush()
            run_kind = k
            if k:
                run.append(e)
            else:
                out.append(e)
    flush()
    return tuple(out)


def chain_step(structure, params, state, block):
    """Pure streaming step over an op-structure tuple; jit with ``structure``
    bound statically (e.g. via functools.partial)."""
    new_states = []
    for (init_fn, step_fn, offline_fn), p, st in zip(structure, params, state):
        st, block = step_fn(p, st, block)
        new_states.append(st)
    return tuple(new_states), block


def scan_offline(init_fn, step_fn, params, blocks: jnp.ndarray) -> jnp.ndarray:
    """Fallback offline path: lax.scan of a streaming step over blocks."""
    state = init_fn(params, blocks.shape[:-2])
    xs = jnp.moveaxis(blocks, -2, 0)

    def body(st, blk):
        return step_fn(params, st, blk)

    _, ys = jax.lax.scan(body, state, xs)
    return jnp.moveaxis(ys, 0, -2)


def chain_render(structure, params, blocks):
    """Pure offline render over an op-structure tuple."""
    for (init_fn, step_fn, offline_fn), p in zip(structure, params):
        if offline_fn is not None:
            blocks = offline_fn(p, blocks)
        else:
            blocks = scan_offline(init_fn, step_fn, p, blocks)
    return blocks
