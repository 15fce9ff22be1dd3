"""What a traced run reads from ``torch.profiler``, as plain intervals.

The profiled stretch runs from the start of the window's first search to
the end of its last, as the harness's own ``swbench.search`` spans mark
them. Device activity is every device-side event (kernels, copies, sets);
the device is busy for the union of their intervals, so that work on two
streams at once counts once.
"""

from __future__ import annotations

import bisect
import dataclasses

SEARCH_SPAN = "swbench.search"
NO_OP = "host outside any torch op (Python, numpy)"


@dataclasses.dataclass
class Trace:
    """Seconds on the profiler's clock."""

    stretch: tuple[float, float]
    device: list[tuple[str, float, float]]  # (name, start, end)
    host: list[tuple[str, float, float]]  # innermost host ops only


def from_profiler(prof) -> Trace | None:
    """The trace of a finished ``torch.profiler.profile``, read from its raw
    events (building the profiler's own event tree costs more than the
    window it describes); None where it holds no search span."""
    import torch

    spans, device, threads = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name, iv = ev.name(), (ev.start_ns() / 1e9, ev.end_ns() / 1e9)
        if name == SEARCH_SPAN:
            # The profiler also draws the span on the device's timeline, as
            # an annotation: it is no device activity.
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append(iv)
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((name, *iv))
        else:
            threads.setdefault(ev.start_thread_id(), []).append((name, *iv))
    if not spans:
        return None
    return Trace((min(s for s, _ in spans), max(e for _, e in spans)), device,
                 [ev for evs in threads.values() for ev in innermost(evs)])


def innermost(events):
    """The events of one thread that hold no other: host ops nest, so
    sorted by start (the longer first) an op holds another exactly when
    the next one starts before it ends."""
    evs = sorted(events, key=lambda ev: (ev[1], -ev[2]))
    return [ev for ev, nxt in zip(evs, evs[1:] + [None]) if nxt is None or nxt[1] >= ev[2]]


def clip(intervals, stretch):
    a, b = stretch
    return [(n, max(s, a), min(e, b)) for n, s, e in intervals if e > a and s < b]


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(name, start, end)`` intervals, merged and sorted."""
    merged: list[list[float]] = []
    for _, s, e in sorted(intervals, key=lambda iv: iv[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in union(clip(trace.device, trace.stretch)))


def window_seconds(trace: Trace) -> float:
    return trace.stretch[1] - trace.stretch[0]


def device_seconds(trace: Trace, keep) -> float:
    """Device time, inside the stretch, of the events whose names ``keep``
    takes."""
    return sum(e - s for n, s, e in clip(trace.device, trace.stretch) if keep(n))


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    a, b = trace.stretch
    gaps, t = [], a
    for s, e in union(clip(trace.device, trace.stretch)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if b > t:
        gaps.append((t, b))
    return gaps


def top_device_ops(trace: Trace, n: int = 10) -> list[list]:
    """``[name, seconds]`` of the ``n`` device operations that took most
    time inside the stretch, summed by name."""
    total: dict[str, float] = {}
    for name, s, e in clip(trace.device, trace.stretch):
        total[name] = total.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(trace: Trace, n: int = 10) -> list[list]:
    """``[what the host ran, seconds]``: the device's idle time inside the
    stretch, split by the innermost host op running meanwhile (``NO_OP``
    where none ran), the ``n`` largest."""
    gaps = idle_gaps(trace)
    starts = [s for s, _ in gaps]
    total: dict[str, float] = {}
    covered = 0.0
    for name, s, e in trace.host:
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(gaps) and gaps[k][0] < e:
            part = min(e, gaps[k][1]) - max(s, gaps[k][0])
            if part > 0:
                total[name] = total.get(name, 0.0) + part
                covered += part
            k += 1
    rest = sum(e - s for s, e in gaps) - covered
    if rest > 0:
        total[NO_OP] = total.get(NO_OP, 0.0) + rest
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
