"""Spans and counters of the port, on the profiler's clock.

:func:`span` marks a stretch of host work with a
``torch.profiler.record_function`` range named ``repro_torch.<name>``, and
:func:`count` adds to a named counter. Both act only while a torch
profiler records (``torch.profiler.profile``, or
``torch.autograd.profiler.emit_nvtx`` under Nsight): that is the one
switch. Otherwise a span is a shared no-op context and a count does
nothing, at the cost of one check of the profiler's state, where an
unconditional ``record_function`` costs tens of times as much even with
no profiler running. The ranges land on the profiler's timeline beside
the device's events, nested as the calls are.

Spans and counts add no device synchronise, no host copy and no device
allocation: a count is taken from host shapes (``ndarray.nbytes``, a
tensor's ``numel() * element_size()``) or host clocks that the code
already has. The counters are one process-wide registry, like the
profiler itself: :func:`counters` returns a snapshot, :func:`reset`
clears it. :func:`capture` runs a block under the profiler and writes its
Chrome trace and counters (``knn_build`` and ``knn_serve --trace-out``).

Build path (``launch/knn_build.build`` and what it calls): ``build`` (the
root), ``sketch.fingerprint``, ``clustering.hash``, ``clustering.split``,
``build.partials``, ``build.ckpt``, and Step 2's ``step2.alloc``,
``step2.hyrec``, ``step2.upload``, then per batch ``step2.pack``,
``step2.wait`` and ``step2.scatter`` (over a device list, one
``step2.pack`` builds every batch and ``step2.launch`` queues them all
before the first ``step2.wait``); ``merge``. Counters
``build.calls``, ``clustering.h2d_bytes``, ``clustering.d2h_bytes`` and
``clustering.device_calls`` (Step 1's distinct-hash table from the card:
the CSR arrays up, the table back, one a build on a card),
``step2.h2d_bytes``, ``step2.d2h_bytes``, ``merge.h2d_bytes``,
``merge.d2h_bytes``.

Serve path (``query/engine.QueryEngine.step``): ``serve.step`` (the
root), ``serve.sync``, ``serve.schedule``, ``serve.admit.fingerprint``,
``serve.admit.cache``, ``serve.admit.route``, ``serve.admit.scatter``,
``serve.hop``, ``serve.descend`` (waves), ``serve.complete``,
``serve.maintain``. Counters ``serve.steps``, ``serve.admitted``,
``serve.queue_wait_s`` (seconds from submission to admission, summed
over the admitted requests).
"""
from __future__ import annotations

import contextlib
import json

import torch
from torch.autograd.profiler import record_function

PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()
_counts: dict[str, float] = {}

# True while a torch profiler (or emit_nvtx) records: the gate of every
# span and count.
enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A context that records ``repro_torch.<name>`` on the profiler's
    timeline while a profiler records; a shared no-op context otherwise."""
    if enabled():
        return record_function(PREFIX + name)
    return _NULL


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if enabled():
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, float]:
    """A snapshot of the counters."""
    return dict(_counts)


def reset() -> None:
    """Clear the counters."""
    _counts.clear()


@contextlib.contextmanager
def capture(path, device):
    """Run the block under ``torch.profiler`` (CPU activity, and CUDA's
    where ``device`` is a CUDA device) with the counters cleared; write its
    Chrome trace to ``path`` and the counters to ``<path>.counters.json``.
    Without ``path`` the block runs as it is."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(path))
    with open(f"{path}.counters.json", "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)
