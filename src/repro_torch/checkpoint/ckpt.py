"""Checkpointing: step-tagged, atomic, async-capable, restart-discoverable.
The port of ``repro.checkpoint.ckpt``, in its format.

Format: one ``.npz`` per checkpoint holding the flattened pytree
('/'-joined key paths, dict keys in sorted order: the reference's
``_flatten``) plus a JSON sidecar with step / metadata, so a checkpoint
written by either package restores in the other. Writes go to a temp file
+ atomic rename, so a node failure mid-write never corrupts the latest
checkpoint — the trainer's auto-resume picks the newest *complete*
checkpoint. A bfloat16 leaf is stored widened to float32 (numpy has no
bfloat16) and narrows back exactly on load; the reference's own bfloat16
leaves arrive as raw 2-byte records (numpy's ``V2``), read as their
bits.

Async mode hands serialization to a background thread so the train loop
only blocks on the previous save; the tensors are copied to host memory
before the hand-off.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time

import numpy as np
import torch

from repro_torch._tree import leaves_with_path, map_with_path


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy().copy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in leaves_with_path(tree)}


def _unflatten_like(tree, flat: dict[str, np.ndarray]):
    def leaf_for(path, leaf):
        arr = np.array(flat[path])
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(arr)
        if isinstance(leaf, torch.Tensor):
            return arr.to(device=leaf.device, dtype=leaf.dtype)
        return arr

    return map_with_path(leaf_for, tree)


def _write(directory: pathlib.Path, step: int, flat: dict[str, np.ndarray],
           metadata=None) -> str:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp_ckpt_{step}.npz"
    final = directory / f"ckpt_{step:08d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    tmp.rename(final)  # atomic
    meta = {"step": step, "time": time.time(), **(metadata or {})}
    (directory / f"ckpt_{step:08d}.json").write_text(json.dumps(meta))
    return str(final)


def save_checkpoint(directory, step: int, tree, *, metadata=None) -> str:
    return _write(pathlib.Path(directory), step, _flatten(tree), metadata)


def latest_step(directory) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1])
                   for p in directory.glob("ckpt_*.npz"))
    return steps[-1] if steps else None


def load_checkpoint(directory, like_tree, *, step: int | None = None):
    """Returns (tree, step) or (None, None) when no checkpoint exists; the
    tree has ``like_tree``'s structure, dtypes and devices."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None, None
    with np.load(directory / f"ckpt_{step:08d}.npz") as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_like(like_tree, flat), step


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async writes."""

    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, metadata=None):
        # copy to host BEFORE handing off: the next step makes new tensors
        # and the card may reuse these buffers
        flat = _flatten(tree)
        self.wait()

        def _do():
            _write(self.directory, step, flat, metadata)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def restore(self, like_tree):
        self.wait()
        return load_checkpoint(self.directory, like_tree)

    def _gc(self):
        ckpts = sorted(self.directory.glob("ckpt_*.npz"))
        for old in ckpts[: -self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)
