"""Double-buffered host/device pipeline executor.

One online *step* — a minibatch of a Lloyd iteration — decomposes into
four phases:

    pre     host work that depends on nothing in flight: the Protocol-2
            exchange computable from the centroid shares, plus pinning the
            step's offline tranche (SlotDealer.acquire +
            materialize_offline)
    launch  the program's kernels, queued on the current CUDA stream: the
            host gets control back while the device works
    mid     host work on the launch's outputs: the sparse S2 exchange runs
            here on the assignment shares
    post    the final launch / result assembly

`run_pipeline(pipeline=True)` slides step t+1's `pre` into the window where
step t's launch is on the device — that is the ONLY reordering. Every phase
still runs exactly once per step, `pre` order stays monotonic in t, and all
correlated randomness is pinned per slot (the dealer fixes the served words
at generation time, in canonical slot order, never at acquisition time), so
pipeline=True and pipeline=False consume identical dealer words and give
identical shares and CommLog tallies.

The overlap comes from PyTorch's asynchronous kernel launches, as JAX's
asynchronous dispatch gives it in the JAX package; nothing in a `pre` may
wait for the device (`core.ring.upload`). Each phase records a
`pipeline.pre` / `.launch` / `.mid` / `.post` span, as the JAX package's
executor does; all on the calling thread, since the executor is
single-threaded.

Used by `SecureKMeans._fit_minibatch` (overlap batch t+1's Protocol-2
exchange and tranche pin with batch t's S1 launch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class PipelineError:
    """Sentinel slotted into `run_pipeline`'s result list where task
    `index` raised (capture_errors=True): the failed task's remaining
    phases are skipped, every other task still runs. Only `Exception`s
    are captured — KeyboardInterrupt and friends always propagate."""

    index: int
    exc: Exception


class StageTask(NamedTuple):
    """One pipeline step. `mid`/`post` are optional; phase signatures:

        prep = pre()
        out  = launch(prep)
        m    = mid(prep, out)          # may wait for device results
        res  = post(prep, out, m)      # appended to run_pipeline's result
    """

    pre: Callable[[], Any]
    launch: Callable[[Any], Any]
    mid: Callable[[Any, Any], Any] | None = None
    post: Callable[[Any, Any, Any], Any] | None = None


def run_pipeline(tasks, pipeline: bool = True,
                 capture_errors: bool = False) -> list:
    """Execute `tasks` in order, returning one result per task.

    pipeline=False: strict sequence pre -> launch -> mid -> post per task.
    pipeline=True: after launching task t, task t+1's `pre` runs while the
    device is busy; then t's mid/post complete before t+1's launch.
    Single-threaded on the host.

    capture_errors=False (default): the first raising phase propagates,
    aborting the run — right for the fit loop, where batches are causally
    chained. capture_errors=True: a task whose phase raises an `Exception`
    contributes a `PipelineError` result and its remaining phases are
    skipped; the other tasks still run — right for independent requests."""
    tasks = list(tasks)
    results = []
    span = _trace.span   # per-phase spans: one branch each when disabled

    def _launch(t, i, prep):
        with span("pipeline.launch", task=i):
            return t.launch(prep)

    def _mid_post(t, i, prep, out):
        if t.mid is not None:
            with span("pipeline.mid", task=i):
                m = t.mid(prep, out)
        else:
            m = None
        if t.post is None:
            return out
        with span("pipeline.post", task=i):
            return t.post(prep, out, m)

    def _phases(t, i):
        with span("pipeline.pre", task=i):
            prep = t.pre()
        out = _launch(t, i, prep)
        return _mid_post(t, i, prep, out)

    if not pipeline:
        for i, t in enumerate(tasks):
            if capture_errors:
                try:
                    results.append(_phases(t, i))
                except Exception as e:
                    results.append(PipelineError(i, e))
            else:
                results.append(_phases(t, i))
        return results

    def _pre(i):
        if i >= len(tasks):
            return None
        if not capture_errors:
            with span("pipeline.pre", task=i):
                return tasks[i].pre()
        try:
            with span("pipeline.pre", task=i):
                return tasks[i].pre()
        except Exception as e:
            return PipelineError(i, e)

    _unset = object()
    prep = _pre(0)
    for i, t in enumerate(tasks):
        if isinstance(prep, PipelineError):
            results.append(prep)
            prep = _pre(i + 1)
            continue
        nxt = _unset
        if capture_errors:
            try:
                out = _launch(t, i, prep)
                nxt = _pre(i + 1)
                res = _mid_post(t, i, prep, out)
            except Exception as e:
                res = PipelineError(i, e)
                if nxt is _unset:
                    # launch died before the overlap window opened; t+1's
                    # pre runs un-overlapped — never twice (pre() draws
                    # dealer words, so re-running it would corrupt streams)
                    nxt = _pre(i + 1)
        else:
            out = _launch(t, i, prep)
            nxt = _pre(i + 1)
            res = _mid_post(t, i, prep, out)
        results.append(res)
        prep = nxt
    return results
