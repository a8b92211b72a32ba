"""Atomic publishing helpers shared by the fit and serving checkpointers,
the config fingerprint, and the LM substrate's `CheckpointStore`.

A checkpoint is written into a `.tmp` staging directory (or file), every
file under it is fsynced, then one `os.rename` publishes it and the parent
directory is fsynced so the rename itself survives a crash. A writer
killed at any point leaves either the previous published state or the
new one, never a torn mix.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.tree import flatten_with_path, unflatten_like


def fsync_path(path: str) -> None:
    """fsync one file or directory (directory fsync persists the entry
    names themselves — rename atomicity is only durable once the parent
    directory is synced)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return                       # non-POSIX / disappeared: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_tree(directory: str) -> None:
    """fsync every regular file under `directory`, then the directory.
    Called on the `.tmp` staging dir BEFORE the atomic rename: without
    it, the rename can land in the journal while the payload pages are
    still dirty in the page cache — a crash then publishes a step whose
    arrays are torn on disk. After the tree sync, rename + parent-dir
    sync makes the publish itself durable."""
    for root, _dirs, files in os.walk(directory):
        for name in files:
            fsync_path(os.path.join(root, name))
        fsync_path(root)


def config_fingerprint(cfg) -> str:
    """16 hex characters of sha256 over `repr(cfg)`: the same key gives
    the same fingerprint in both packages."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# CheckpointStore: the LM substrate's keep-N step directories
# ---------------------------------------------------------------------------

def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file stores: bf16 as f32 (numpy has
    no bfloat16; the upcast is lossless, restore casts back)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    """{keystr: leaf} in pytree order (the JAX package's keys, e.g.
    ``['params']['groups'][0]['b0']['wq']``)."""
    return dict(flatten_with_path(tree))


class CheckpointStore:
    """Atomic, keep-N checkpoints of a tree of tensors or numpy arrays:
    `step_XXXXXXXX/` with `leaves.npz` and `manifest.json`, written into a
    `.tmp` directory, fsynced and renamed. The files are the JAX package's:
    either package restores the other's. `restore` refuses a checkpoint
    whose config fingerprint differs."""

    def __init__(self, directory: str, keep: int = 3,
                 fingerprint: str = ""):
        self.dir = directory
        self.keep = keep
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree) -> str:
        arrays = {k: _host(v) for k, v in _flatten(tree).items()}
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "leaves.npz"),
                 **{str(i): a for i, a in enumerate(arrays.values())})
        manifest = {
            "step": step,
            "fingerprint": self.fingerprint,
            "keys": list(arrays.keys()),
            "shapes": [list(a.shape) for a in arrays.values()],
            "dtypes": [str(a.dtype) for a in arrays.values()],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        fsync_tree(tmp)                     # payload durable before publish
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        fsync_path(self.dir)                # the rename itself durable
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def restore(self, step: int, like_tree):
        """Restore into the structure of `like_tree`: each leaf cast to the
        like leaf's dtype, a tensor put on the like tensor's device."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if self.fingerprint and manifest["fingerprint"] != self.fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {manifest['fingerprint']} does not "
                f"match config {self.fingerprint}")
        with np.load(os.path.join(path, "leaves.npz")) as data:
            arrays = {k: data[str(i)]
                      for i, k in enumerate(manifest["keys"])}
        flat_like = _flatten(like_tree)
        if set(flat_like.keys()) != set(arrays.keys()):
            missing = set(flat_like) ^ set(arrays)
            raise ValueError(f"checkpoint/model structure mismatch: {missing}")
        out = []
        for k, like in flat_like.items():
            a = arrays[k]
            if isinstance(like, torch.Tensor):
                out.append(torch.from_numpy(np.asarray(a, order="C")).to(
                    device=like.device, dtype=like.dtype))
            else:
                out.append(a.astype(np.asarray(like).dtype))
        return unflatten_like(like_tree, out)
