"""Communication accounting and network cost models.

`CommLog` tallies bytes/rounds keyed by (phase, tag); every protocol op
reports its traffic, which is fully determined by tensor shapes. This
reproduces the paper's Tables 1-2 / Figures 2-4 cost columns. Only the
accounting half of the reference module is here: `wire` stays None until
the transports are ported.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class NetModel:
    """One-way latency is rtt/2; paper quotes round-trip latency."""

    name: str
    bandwidth_bps: float
    rtt_s: float

    def time_s(self, nbytes: int, rounds: int) -> float:
        return nbytes * 8.0 / self.bandwidth_bps + rounds * self.rtt_s


# Paper Sec 5.1: LAN 10 Gbps / 0.02 ms RTT; WAN 20 Mbps / 40 ms RTT.
LAN = NetModel("LAN", 10e9, 0.02e-3)
WAN = NetModel("WAN", 20e6, 40e-3)


class CommLog:
    """Byte/round tallies keyed by (phase, tag). Every tally mutation/read
    holds `_lock` (defaultdict `+=` is a read-modify-write)."""

    def __init__(self) -> None:
        self.bytes = defaultdict(int)   # (phase, tag) -> bytes
        self.rounds = defaultdict(int)  # (phase, tag) -> rounds
        self.wire = None
        self._lock = threading.Lock()

    def send(self, nbytes: int, *, tag: str = "misc", phase: str = "online",
             rounds: int = 1) -> None:
        with self._lock:
            self.bytes[(phase, tag)] += int(nbytes)
            self.rounds[(phase, tag)] += int(rounds)

    # ---- queries -------------------------------------------------------
    def total_bytes(self, phase: str | None = None) -> int:
        with self._lock:
            return sum(v for (p, _), v in self.bytes.items()
                       if phase is None or p == phase)

    def total_rounds(self, phase: str | None = None) -> int:
        with self._lock:
            return sum(v for (p, _), v in self.rounds.items()
                       if phase is None or p == phase)

    def by_tag(self, phase: str) -> dict:
        out = defaultdict(lambda: [0, 0])
        with self._lock:
            for (p, t), v in self.bytes.items():
                if p == phase:
                    out[t][0] += v
            for (p, t), v in self.rounds.items():
                if p == phase:
                    out[t][1] += v
        return {t: tuple(v) for t, v in out.items()}

    def time_estimate(self, net: NetModel, phase: str | None = None) -> float:
        return net.time_s(self.total_bytes(phase), self.total_rounds(phase))

    def merge(self, other: "CommLog", phase: str | None = None) -> None:
        """Accumulate another log's tallies (optionally one phase only)."""
        with other._lock:
            ob = dict(other.bytes)
            orn = dict(other.rounds)
        with self._lock:
            for (p, t), v in ob.items():
                if phase is None or p == phase:
                    self.bytes[(p, t)] += v
            for (p, t), v in orn.items():
                if phase is None or p == phase:
                    self.rounds[(p, t)] += v

    def copy(self) -> "CommLog":
        out = CommLog()
        out.merge(self)
        return out

    def state(self) -> dict:
        """JSON-serializable tally state (tuple keys flattened)."""
        with self._lock:
            return {"bytes": [[p, t, v] for (p, t), v in self.bytes.items()],
                    "rounds": [[p, t, v]
                               for (p, t), v in self.rounds.items()]}

    def restore(self, state: dict) -> None:
        """Replace the tallies with a `state()` snapshot."""
        with self._lock:
            self.bytes.clear()
            self.rounds.clear()
            for p, t, v in state["bytes"]:
                self.bytes[(p, t)] = int(v)
            for p, t, v in state["rounds"]:
                self.rounds[(p, t)] = int(v)

    def reset(self) -> None:
        with self._lock:
            self.bytes.clear()
            self.rounds.clear()
