"""The search's steps on ``torch.profiler``'s timeline, and the cells its
launches step.

``span(name, **counts)`` marks one step of a search. While a profiler
session records, it is ``torch.profiler.record_function("seqalign.<name>")``:
the step is an event on the profiler's timeline and clock, nested in the
steps open on its thread. A span given counters also appends
``{"name": "seqalign.<name>", "counts": counts}`` to a list in memory, which
``recorded()`` returns, since the profiler's events carry no counters.
These spans have counters:

- ``seqalign.launch``: ``cells_real`` and ``cells_launched`` (``swbench``'s
  ``cell_fill_pct`` reads them);
- a search's ``seqalign.plan`` of its chunks' plans: ``plan_hits`` and
  ``plan_misses``, from the pipeline's plan memo or made now
  (``plan_hit_pct``);
- the alignment step after a search (``ops.traceback.topk_alignments``):
  ``seqalign.align``, ``hits``; ``seqalign.select``, ``records``;
  ``seqalign.ends`` and ``seqalign.fill``, ``cells_host`` or
  ``cells_device`` (``align_host_cell_pct`` reads them).

Counters come from data the host holds (shapes, plans); no span reads a
device value or waits for the device.

Outside a profiler session ``span`` returns one shared object that does
nothing: it reads no clock, records nothing and calls no profiler function.
The list keeps the counted spans of every profiled stretch of the process
until ``clear()`` empties it.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "seqalign."

_records: list[dict] = []


class _Off:
    """The span of a search no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **counts):
    """A context manager marking the step ``name`` (``seqalign.<name>`` on
    the profiler's timeline), with ``counts`` its counters. Records only
    while a profiler session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if counts:
        _records.append({"name": PREFIX + name, "counts": counts})
    return torch.profiler.record_function(PREFIX + name)


def recorded() -> list[dict]:
    """The counted spans recorded since the process started or the last
    ``clear()``, in the order they opened."""
    return _records


def clear() -> None:
    _records.clear()
