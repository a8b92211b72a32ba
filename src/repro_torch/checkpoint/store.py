"""Atomic publishing helpers shared by the fit and serving checkpointers.

A checkpoint is written into a `.tmp` staging directory (or file), every
file under it is fsynced, then one `os.rename` publishes it and the parent
directory is fsynced so the rename itself survives a crash. A writer
killed at any point leaves either the previous published state or the
new one, never a torn mix.
"""
from __future__ import annotations

import hashlib
import os


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
