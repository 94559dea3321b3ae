"""Resumable offline rendering: crash recovery for long renders.

SURVEY.md §5 failure-detection plan: the reference has nothing; the minimal
mechanism is deterministic re-render from block k — snapshot the
chain state every N blocks, and on restart resume from the last complete
segment. Because every op's state is an explicit pytree, a snapshot is just
arrays; determinism comes from jit purity.

Crash-safety protocol: every file is written to a temp name and
``os.replace``d (atomic on POSIX), and ``meta.json`` — written LAST — names
the exact state file that matches its segment counter. A crash between any
two writes leaves the previous consistent (meta, state) pair intact, so
resume never pairs a segment counter with a state from a different segment.

Checkpoint layout (directory):
    meta.json               {"segment": k, "shape": [...], "state": "..."}
    state_0000k.npz         chain-state leaves entering segment k
    out_00000.npy ...       rendered output segments
"""

from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .chain import Chain, chain_step


def _atomic_write(path: str, write_fn) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def _save_state(path: str, state) -> None:
    leaves, _ = jax.tree.flatten(state)
    _atomic_write(path, lambda f: np.savez(
        f, *[np.asarray(l) for l in leaves]))


def _load_state(path: str, template):
    archive = np.load(path)
    leaves = [jnp.asarray(archive[k]) for k in archive.files]
    _, treedef = jax.tree.flatten(template)
    return jax.tree.unflatten(treedef, leaves)


def _render_segment(structure, params, state, seg_blocks):
    """One checkpointed segment: scan the chain step over its blocks."""
    xs = jnp.moveaxis(seg_blocks, -2, 0)

    def body(st, blk):
        return chain_step(structure, params, st, blk)

    state, ys = jax.lax.scan(body, state, xs)
    return state, jnp.moveaxis(ys, 0, -2)


def render_resumable(chain: Chain, blocks: jnp.ndarray, ckpt_dir: str,
                     segment_blocks: int = 64,
                     stop_after: int | None = None) -> jnp.ndarray:
    """Render ``(..., nb, B)`` blocks with periodic checkpoints; resumes
    automatically if ``ckpt_dir`` holds a partial run for the same shape.

    ``stop_after`` aborts after that many segments (fault-injection hook for
    testing crash/resume behavior)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    meta_path = os.path.join(ckpt_dir, "meta.json")

    nb = blocks.shape[-2]
    n_seg = -(-nb // segment_blocks)
    batch_shape = blocks.shape[:-2]

    start_seg = 0
    state = chain.init_state(batch_shape)
    if os.path.exists(meta_path):
        try:
            meta = json.load(open(meta_path))
        except (ValueError, OSError):  # pragma: no cover - atomic writes
            meta = {}
        state_file = meta.get("state")
        if (meta.get("shape") == list(blocks.shape)
                and meta.get("segment", 0) < n_seg and state_file
                and os.path.exists(os.path.join(ckpt_dir, state_file))):
            start_seg = meta["segment"]
            state = _load_state(os.path.join(ckpt_dir, state_file), state)

    # One traced program per segment length (the tail may be shorter),
    # shared across all segments of the render.
    seg_fn = jax.jit(partial(_render_segment, chain._structure))

    outs = []
    for seg in range(n_seg):
        seg_path = os.path.join(ckpt_dir, f"out_{seg:05d}.npy")
        lo, hi = seg * segment_blocks, min((seg + 1) * segment_blocks, nb)
        if seg < start_seg:
            outs.append(jnp.asarray(np.load(seg_path)))
            continue
        if stop_after is not None and seg >= start_seg + stop_after:
            raise RuntimeError(f"injected fault after segment {seg}")
        state, out = seg_fn(chain.params, state, blocks[..., lo:hi, :])
        _atomic_write(seg_path, lambda f: np.save(f, np.asarray(out)))
        state_file = f"state_{seg + 1:05d}.npz"
        _save_state(os.path.join(ckpt_dir, state_file), state)
        # meta LAST: it only ever references files that already exist.
        _atomic_write(meta_path, lambda f: f.write(json.dumps(
            {"segment": seg + 1, "shape": list(blocks.shape),
             "state": state_file}).encode()))
        prev = os.path.join(ckpt_dir, f"state_{seg:05d}.npz")
        if os.path.exists(prev):
            os.remove(prev)
        outs.append(out)
    return jnp.concatenate(outs, axis=-2)
