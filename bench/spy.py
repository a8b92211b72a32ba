"""Instruments the program from outside, for the traced run only.

`KernelSpy` wraps the kernel wrappers `modmatmul.ring_matmul` and
`ksadder.ks_carry_share` by module attribute (the cuda ring backend calls
them through the module): each call gets a `torch.profiler` range of its
own, so the device time of its kernels can be told apart, and while
`recording` is set it notes the shapes that the kernels' bounds are
computed from. `count_online_bytes` tallies the program's CommLog sends.
"""
from __future__ import annotations

import contextlib

import torch

RANGES = {"ring_matmul": "bench.ring_matmul",
          "ks_carry_share": "bench.ks_carry_share"}


class KernelSpy:
    def __init__(self):
        self.recording = False
        self.mm: list[tuple[int, int, int]] = []
        self.ks: list[int] = []

    def __enter__(self):
        from repro_torch.kernels import ksadder, modmatmul
        self._orig = (modmatmul.ring_matmul, ksadder.ks_carry_share)
        mm0, ks0 = self._orig

        def mm(a, b):
            if self.recording:
                self.mm.append((a.shape[0], a.shape[1], b.shape[1]))
            with torch.profiler.record_function(RANGES["ring_matmul"]):
                return mm0(a, b)

        def ks(*args, party0):
            if self.recording:
                self.ks.append(args[0].numel())
            with torch.profiler.record_function(RANGES["ks_carry_share"]):
                return ks0(*args, party0=party0)

        modmatmul.ring_matmul, ksadder.ks_carry_share = mm, ks
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ksadder, modmatmul
        modmatmul.ring_matmul, ksadder.ks_carry_share = self._orig


@contextlib.contextmanager
def count_online_bytes(tally: dict):
    """Adds to tally["bytes"] every online-phase byte that the program's
    CommLog records while the block runs (both parties' messages)."""
    from repro_torch.core.channel import CommLog
    orig = CommLog.send

    def send(self, nbytes, *, tag="misc", phase="online", rounds=1):
        if phase == "online":
            tally["bytes"] = tally.get("bytes", 0) + int(nbytes)
        return orig(self, nbytes, tag=tag, phase=phase, rounds=rounds)

    CommLog.send = send
    try:
        yield tally
    finally:
        CommLog.send = orig
