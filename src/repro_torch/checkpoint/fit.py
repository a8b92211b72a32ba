"""Mid-fit checkpoint/resume for the secure k-means loop.

A `FitState` is everything a killed fit needs to finish bit-exact:

* the secret-shared model — mu shares, and (mid-iteration, minibatch only)
  the four partial accumulator shares + completed batches' assignment
  shares;
* the cursor — completed iterations, completed batches inside the current
  iteration;
* the dealer stream positions — NOT raw `bit_generator` states but the
  per-class consumed-request counts. Every dealer derives its class streams
  from `(seed, class_key)` and draws a fixed word count per request, so
  `_advanced_rng(seed, key, consumed)` reconstructs the exact position with
  one PCG64 jump; the counts themselves are recomputable from the plan ×
  cursor (the resume path recomputes them and cross-checks the stored copy
  as an integrity test);
* the bookkeeping — CommLog tallies and dealer counters, restored so a
  resumed fit's final accounting equals the uninterrupted run's.

Atomicity: arrays + manifest land in `step_XXXXXXXXXX.tmp/`, every file
is fsynced, then one `os.rename` publishes — a writer killed mid-save can
never leave a half-checkpoint that `latest()` picks up.

The files are the JAX package's: `state.npz` of uint64 words plus a JSON
`manifest.json`, so a checkpoint written by either package resumes in the
other. The arrays here are uint64 numpy; the fit converts its int64 device
words with `ring.to_u64_numpy` / `ring.from_u64_numpy` (a view of the same
64 bits, never a value cast).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from repro_torch.checkpoint.store import fsync_path, fsync_tree
from repro_torch.core import faultpoints as _fp
from repro_torch.core.triples import _key_from_str, _key_to_str
from repro_torch.obs import trace as _trace


class FingerprintMismatch(ValueError):
    """Checkpoint was written under a different (cfg, data-shape)
    fingerprint. A config error, not disk damage — recovery must refuse
    loudly instead of falling back to an older step."""


@dataclasses.dataclass
class FitState:
    """One resumable cut of a fit. `iteration` counts COMPLETED iterations;
    `batch` counts completed batches inside iteration `iteration + 1` (0 at
    an iteration boundary — the full-batch loop only ever writes 0)."""

    iteration: int
    batch: int
    mu0: np.ndarray
    mu1: np.ndarray
    counters: dict          # {"n_matmul": int, "n_mul": int, "n_bin": int}
    comm: dict              # CommLog.state()
    advance: dict           # {class_key tuple: consumed request count}
    fingerprint: str = ""
    acc: list | None = None         # 4 partial accumulator share arrays
    c0_parts: list = dataclasses.field(default_factory=list)
    c1_parts: list = dataclasses.field(default_factory=list)

    @property
    def step(self) -> int:
        return self.iteration * 1_000_000 + self.batch


class FitCheckpointer:
    """Atomic keep-N store of `FitState`s + the save policy.

    `every`: checkpoint at the end of every Nth iteration. `batch_every`:
    additionally checkpoint after every Nth completed minibatch — only
    legal on the sequential executor (`pipeline=False`); the pipelined
    executor runs batch t+1's host exchange before batch t's accumulate, so
    mid-iteration the live CommLog is not the canonical prefix a resume
    must restore (`core/kmeans.py` enforces this with a `ValueError`).
    `after_save(state, path)` is a test seam — chaos tests use it to kill
    the process deterministically right after a publish."""

    def __init__(self, directory: str, *, every: int = 1,
                 batch_every: int | None = None, keep: int = 3,
                 fingerprint: str = "", after_save=None):
        self.dir = directory
        self.every = max(1, int(every))
        self.batch_every = None if batch_every is None \
            else max(1, int(batch_every))
        self.keep = int(keep)
        self.fingerprint = fingerprint
        self.after_save = after_save
        os.makedirs(directory, exist_ok=True)

    # -- policy ----------------------------------------------------------
    def want_iter(self, it: int, iters: int) -> bool:
        """Checkpoint after completed iteration `it`? Never after the last:
        the fit is about to return its result anyway."""
        return it < iters and it % self.every == 0

    def want_batch(self, b: int, n_batches: int) -> bool:
        """Checkpoint after completed batch `b` (1-based)? Never after the
        last — that cut is the iteration boundary."""
        return (self.batch_every is not None and b < n_batches
                and b % self.batch_every == 0)

    # -- persistence -----------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, state: FitState) -> str:
        with _trace.span("checkpoint.fit_save", step=int(state.step),
                         iteration=int(state.iteration),
                         batch=int(state.batch)):
            return self._save(state)

    def _save(self, state: FitState) -> str:
        arrays = {"mu0": np.asarray(state.mu0, np.uint64),
                  "mu1": np.asarray(state.mu1, np.uint64)}
        if state.acc is not None:
            for i, a in enumerate(state.acc):
                arrays[f"acc{i}"] = np.asarray(a, np.uint64)
        for t, (a0, a1) in enumerate(zip(state.c0_parts, state.c1_parts)):
            arrays[f"cp{t}_s0"] = np.asarray(a0, np.uint64)
            arrays[f"cp{t}_s1"] = np.asarray(a1, np.uint64)
        manifest = {
            "iteration": int(state.iteration),
            "batch": int(state.batch),
            "fingerprint": state.fingerprint or self.fingerprint,
            "counters": {k: int(v) for k, v in state.counters.items()},
            "comm": state.comm,
            "advance": {_key_to_str(k): int(v)
                        for k, v in state.advance.items()},
            "has_acc": state.acc is not None,
            "n_parts": len(state.c0_parts),
        }
        final = self._path(state.step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        fsync_tree(tmp)                     # payload durable before publish
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        fsync_path(self.dir)                # the rename itself durable
        self._gc()
        if self.after_save is not None:
            self.after_save(state, final)
        _fp.probe("fit.publish")            # chaos kill-point: post-publish
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest(self) -> FitState | None:
        """Newest LOADABLE step: a published step whose arrays turn out
        torn on disk (pre-fsync writer + machine crash) is skipped with a
        warning and the previous step is recovered instead. Fingerprint
        mismatches are NOT skipped — that's a config error, not damage."""
        for s in reversed(self.all_steps()):
            try:
                return self.load(s)
            except FingerprintMismatch:
                raise                   # config error: refuse loudly
            except Exception as e:      # torn npz/manifest: fall back
                import warnings
                warnings.warn(f"checkpoint step {s} unreadable ({e}); "
                              "falling back to the previous step")
        return None

    def step_at_or_before(self, step: int) -> int | None:
        """Largest published step ≤ `step` — what the resume negotiation
        loads after both parties agree on `min(step)` (a party may hold a
        NEWER published step than the agreement; it must rewind to one
        the peer also witnessed). None == no such step: start fresh."""
        ok = [s for s in self.all_steps() if s <= int(step)]
        return max(ok) if ok else None

    def load(self, step: int) -> FitState:
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if self.fingerprint and manifest["fingerprint"] \
                and manifest["fingerprint"] != self.fingerprint:
            raise FingerprintMismatch(
                f"checkpoint fingerprint {manifest['fingerprint']} does not "
                f"match this fit's config fingerprint {self.fingerprint} — "
                "refusing to resume a different (cfg, data-shape) run")
        with np.load(os.path.join(path, "state.npz")) as z:
            mu0, mu1 = z["mu0"], z["mu1"]
            acc = [z[f"acc{i}"] for i in range(4)] \
                if manifest["has_acc"] else None
            c0 = [z[f"cp{t}_s0"] for t in range(manifest["n_parts"])]
            c1 = [z[f"cp{t}_s1"] for t in range(manifest["n_parts"])]
        return FitState(
            iteration=int(manifest["iteration"]),
            batch=int(manifest["batch"]),
            mu0=mu0, mu1=mu1,
            counters={k: int(v) for k, v in manifest["counters"].items()},
            comm=manifest["comm"],
            advance={_key_from_str(k): int(v)
                     for k, v in manifest["advance"].items()},
            fingerprint=manifest["fingerprint"],
            acc=acc, c0_parts=c0, c1_parts=c1)
