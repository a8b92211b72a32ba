"""Serving-plane checkpoint: exactly-once responses across a crash.

A `ServeCheckpointer` owns two artifacts inside its directory:

* **`bank.npz`** — the provision-time `TripleBank` snapshot, written once
  right after `ScoringService.warm()` provisions the ladder (atomic tmp +
  rename). The bank file is never rewritten while serving: consumption is
  tracked in the journal instead, so a crash can't tear it.
* **`journal/batch_NNNNNNNN.npz`** — one atomically-published file per
  drain batch, holding every response the batch resolved (request id,
  labels, scores, rows, error) PLUS the bank's cumulative per-class
  consumed-request counts at publish time.

Restart contract (the exactly-once argument):

1. *Replay* — a journaled request id is answered verbatim from the
   journal; the handler never runs again, no triple is drawn.
2. *Realign* — the reloaded bank starts at the provision-time snapshot;
   `TripleBank.discard(latest consumed counts)` drains exactly the
   requests the dead process consumed, so no word is ever served twice.
3. *Re-score* — a request that died in flight (drawn but not journaled)
   re-draws the SAME words after realignment, because the journal's
   counts stop *before* its draw — so its eventual response is bit-exact
   with what the dead process would have answered.

Journal publish happens BEFORE the response is exposed to the caller, so
the only crash windows are (a) before publish — the request is re-scored
identically — and (b) after publish — the request is replayed. Either
way the client observes exactly one response, and it is the same one.

`after_record(total_responses, path)` is a test seam mirroring
`FitCheckpointer.after_save`: chaos tests use it to `os._exit` the
serving process deterministically right after a journal publish.

The files are the JAX package's (`TripleBank.save`'s npz, and the same
journal format), so either package restarts from the other's directory.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.checkpoint.store import fsync_path
from repro_torch.core.triples import TripleBank, _key_from_str, _key_to_str
from repro_torch.obs import trace as _trace

JOURNAL_FORMAT = "repro.servejournal"
JOURNAL_VERSION = 1


class ServeCheckpointer:
    """Atomic response journal + bank snapshot for a `ScoringService`."""

    def __init__(self, directory: str, *, after_record=None):
        self.dir = directory
        self.journal_dir = os.path.join(directory, "journal")
        os.makedirs(self.journal_dir, exist_ok=True)
        self.after_record = after_record
        self._batch = self._next_batch()
        self.recorded = 0           # responses journaled THIS incarnation

    # -- bank snapshot ---------------------------------------------------
    @property
    def bank_path(self) -> str:
        return os.path.join(self.dir, "bank.npz")

    def has_bank(self) -> bool:
        return os.path.exists(self.bank_path)

    def save_bank(self, bank: TripleBank) -> None:
        tmp = self.bank_path + ".tmp"
        bank.save(tmp)
        fsync_path(tmp)                          # payload durable first
        os.replace(tmp, self.bank_path)          # atomic publish
        fsync_path(self.dir)

    def load_bank(self, **kw) -> TripleBank:
        """The provision-time snapshot; `kw` goes to `TripleBank.load`
        (`device=` places its words)."""
        return TripleBank.load(self.bank_path, **kw)

    # -- journal ---------------------------------------------------------
    def _next_batch(self) -> int:
        mx = -1
        for name in os.listdir(self.journal_dir):
            if name.startswith("batch_") and name.endswith(".npz"):
                mx = max(mx, int(name[6:-4]))
        return mx + 1

    def record(self, responses, consumed: dict) -> str:
        """Atomically journal one drain batch's responses together with
        the bank's CUMULATIVE per-class consumed counts at publish time.
        Later batches carry larger counts, so the newest file alone
        realigns a reloaded bank."""
        with _trace.span("checkpoint.journal", batch=int(self._batch),
                         responses=len(responses)):
            return self._record(responses, consumed)

    def _record(self, responses, consumed: dict) -> str:
        arrays = {}
        metas = []
        for j, r in enumerate(responses):
            arrays[f"r{j}_labels"] = np.asarray(r.labels, np.int64)
            if r.scores is not None:
                arrays[f"r{j}_scores"] = np.asarray(r.scores, np.float64)
            metas.append({"rid": int(r.request_id), "rows": int(r.rows),
                          "error": r.error,
                          "has_scores": r.scores is not None})
        manifest = {"format": JOURNAL_FORMAT, "version": JOURNAL_VERSION,
                    "responses": metas,
                    "consumed": {_key_to_str(k): int(v)
                                 for k, v in consumed.items()}}
        final = os.path.join(self.journal_dir, f"batch_{self._batch:08d}.npz")
        self._batch += 1
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, manifest=np.frombuffer(
                json.dumps(manifest).encode(), np.uint8), **arrays)
            f.flush()
            os.fsync(f.fileno())                 # payload durable first
        os.replace(tmp, final)                   # atomic publish
        fsync_path(self.journal_dir)
        self.recorded += len(metas)
        if self.after_record is not None:
            self.after_record(self.recorded, final)
        return final

    def load_journal(self) -> tuple[dict, dict]:
        """Read every published batch: `(rid -> ScoringResponse replayed
        verbatim, latest cumulative consumed counts)`. A `.tmp` straggler
        from a mid-write crash is ignored — it was never published."""
        from repro_torch.serve.service import ScoringResponse
        out: dict[int, ScoringResponse] = {}
        consumed: dict = {}
        names = sorted(n for n in os.listdir(self.journal_dir)
                       if n.startswith("batch_") and n.endswith(".npz"))
        for name in names:
            with np.load(os.path.join(self.journal_dir, name)) as z:
                manifest = json.loads(bytes(z["manifest"]).decode())
                if manifest.get("format") != JOURNAL_FORMAT \
                        or manifest.get("version") != JOURNAL_VERSION:
                    raise ValueError(
                        f"unrecognized serve journal {name!r}: "
                        f"{manifest.get('format')!r} "
                        f"v{manifest.get('version')!r}")
                for j, m in enumerate(manifest["responses"]):
                    scores = z[f"r{j}_scores"] if m["has_scores"] else None
                    out[int(m["rid"])] = ScoringResponse(
                        int(m["rid"]), z[f"r{j}_labels"], scores,
                        int(m["rows"]), m["error"])
                consumed = {_key_from_str(k): int(v)
                            for k, v in manifest["consumed"].items()}
        return out, consumed
