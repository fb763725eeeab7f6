"""The traced window: ``torch.profiler`` over the host and the card, read in
memory (no trace file), reduced to what the per-layer readers take.

* Device events: every kernel, copy and fill on the card, with its start and
  end in the profiler's clock.
* Host events: every operator and range on the host, for naming idle gaps.
* The window: the benchmark's own ``bench.window`` range; the device's busy
  time is the union of device events inside it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.yardstick.grouping import group_of

Event = Tuple[str, float, float]  # name, start us, end us


def _events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished profiler."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        (dev if e.device_type() == DeviceType.CUDA else host).append((e.name(), start, end))
    return dev, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _name_gaps(host: List[Event], gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Seconds of idle gaps by the host event open at each gap's midpoint
    that started last (a sweep over host events sorted by start)."""
    host = sorted(host, key=lambda h: h[1])
    out: Dict[str, float] = {}
    stack: List[Tuple[float, str]] = []
    i = 0
    for a, b in sorted(gaps):
        t = (a + b) / 2
        while i < len(host) and host[i][1] <= t:
            stack.append((host[i][2], host[i][0]))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        name = stack[-1][1] if stack else "(no host range)"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def reduce(prof, window: str = "bench.window") -> Dict:
    """:func:`reduce_events` of a finished profiler."""
    return reduce_events(*_events(prof), window=window)


def reduce_events(dev: List[Event], host: List[Event], window: str = "bench.window") -> Dict:
    """The traced window's numbers: ``window_s``, ``busy_s``, kernel time by
    name and by group, the breakdown's top device operations and idle gaps."""
    # A host range also shows on the card's timeline (as a user annotation
    # under the range's name): only kernels, copies and fills are device work.
    host_names = {n for n, _, _ in host}
    dev = [d for d in dev if d[0] not in host_names]
    spans = [(s, e) for n, s, e in host if n == window]
    if not spans:
        raise RuntimeError(f"no {window!r} range in the trace")
    w0, w1 = spans[0][0], spans[-1][1]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in inside])
    busy_us = sum(e - s for s, e in busy)
    kernels = [(n, s, e) for n, s, e in inside
               if not n.startswith("Memcpy") and not n.startswith("Memset")]
    by_name: Dict[str, float] = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    by_group: Dict[str, float] = {}
    for n, s, e in kernels:
        g = group_of(n)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e6
    host = [h for h in host if h[0] != window and h[2] > w0 and h[1] < w1]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = _name_gaps(host, [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": {n: v for n, v in by_name.items()},
        "group_s": by_group,
        "breakdown": {"device_ops": [[n, v] for n, v in top_ops],
                      "idle_gaps": [[n, v] for n, v in top_gaps]},
    }


class Profiled:
    """``with Profiled(on) as p:`` runs its body under the profiler when
    ``on``; ``p.result`` is :func:`reduce`'s dict after the block (None when
    off). The body marks its window with ``record_function("bench.window")``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.result = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.result = reduce(self.prof)
            self.prof = None
        return False
