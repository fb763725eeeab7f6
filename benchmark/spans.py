"""The program's spans in a traced window: each device operation given to
the span that launched it, the card's idle time to the range the host was
in, and the six per-layer readings those give.

The program (``whisper_finetune_torch``) marks its layer boundaries with
``runtime.span``: a ``record_function`` range under the profiler, named
``wft.*`` (the table is in PERF.md). This module reads them from the same
``torch.profiler`` run the benchmark's traced window makes.

**The owner of a device operation.** Each kernel, copy or fill is followed to
the runtime call that launched it (the device event's ``correlation_id`` is
its launching call's; a device event without one is followed through its
``linked_correlation_id`` to the operator that was open), which gives the
launch's thread and time. Its owner is, in order:

* (a) the innermost ``wft.*`` span open on that thread at the launch;
* (b) otherwise, for a launch inside an autograd backward node (an event
  with a ``sequence_nr`` and a ``fwd_thread_id``), the innermost ``wft.*``
  span open where that node's forward operator ran (the operator of the same
  ``sequence_nr`` on the forward thread);
* (c) otherwise, the innermost ``wft.*`` or ``bench.*`` range open on the
  window's main thread (the thread of ``bench.window``, itself such a range);
* (d) otherwise (a launch before the window opened) ``(none)``.

Each owned second is counted under a phase: ``replay`` where the owning span
is, or sits inside, a block span (``wft.enc_block``, ``wft.dec_block``)
opened during a backward, that is on another thread than the main one (the
autograd engine's: the remat recompute) or inside ``wft.backward`` (the
manual backward's layer replay); ``bwd`` for the other spans opened during a
backward and for every owner found by rule (b); ``fwd`` otherwise. The GPU
user annotations that carry a range's name on the device's row are no work
and are left out, as ``benchmark/trace.py`` leaves them out of ``busy_s``.
The card's idle time (the window less the union of its device operations)
goes to the innermost ``wft.*`` or ``bench.*`` range open on the main thread
at each instant of the gap, or to ``(none)``.

:func:`own_events` returns, beside the trace's own fields:

* ``span_device_s``: ``{owner: {phase: seconds}}``, device seconds;
* ``span_kernels``: ``{owner: kernels}`` (copies and fills not counted);
* ``span_group_s``: ``{owner: {kernel group: seconds}}``, the groups of
  ``yardstick/grouping.py`` and ``copy`` for copies and fills;
* ``span_idle_s``: ``{range: seconds}``;
* ``span_count``: ``{span: spans opened in the window}``, on every thread;
* ``ops_busy_s``: the union of the kernels, copies and fills alone, which
  equals the trace's ``busy_s`` when no annotation enters it; ``owned_share``:
  the share of device seconds that ``wft.*`` spans own.

**The readings** (each ``None`` off its kind or without its spans, never 0):

| Reading | Unit | Reads | Moves |
| --- | --- | --- | --- |
| ``train.loss_ms`` | ms/step | device time owned by ``wft.loss``, every phase | ``train_audio_h_per_s`` |
| ``train.recompute_ms`` | ms/step | device time of phase ``replay`` | ``train_audio_h_per_s`` |
| ``train.attn_ms`` | ms/step | device time owned by ``wft.attn``, every phase | ``train_audio_h_per_s`` |
| ``train.batch_idle_ms`` | ms/step | idle time in ``wft.collate`` / ``wft.stack`` / ``wft.to_device`` | ``train_audio_h_per_s`` |
| ``decode.token_step_ms`` | ms | host wall time a ``wft.decode.token_step``, by the span clock with the profiler off | ``decode_tokens_per_s`` |
| ``decode.kernels_per_token`` | kernels | kernels owned by ``wft.decode.token_step`` a token step | ``decode_tokens_per_s`` |

``decode.token_step_ms`` reads ``record["span_clock"]``: the table of
``runtime.timed()`` over one more call of the cell, made after the traced
window has closed, outside the served tokens.

    python3 -m benchmark.spans --workload <cell> --seed <n> [--out FILE]

runs a cell's traced window on the card as ``benchmark.run --trace 1`` does,
with this reduction added to the trace's, and prints the span tables and the
readings as one JSON line (and to ``FILE``). It reads spans only: the
reference and the correctness check are not run. For a decode cell it also
times the set-up's call made again, span clock off and on in turns, right
after set-up and again after the run, so that the two sides of the traced
window can be compared.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from typing import Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

from benchmark.yardstick.grouping import group_of

BLOCKS = ("wft.enc_block", "wft.dec_block")
BACKWARD = "wft.backward"
DATA = ("wft.collate", "wft.stack", "wft.to_device")
TOKEN_STEP = "wft.decode.token_step"
NONE = "(none)"


class Ev(NamedTuple):
    """One profiler event, host or device; times in microseconds."""

    name: str
    start: float
    end: float
    thread: int = 0
    corr: int = 0  # a launching call's and its device operation's correlation id
    link: int = 0  # a device operation's (and runtime call's) open operator
    seq: int = -1  # autograd sequence number: a forward op's node, a backward node's own
    fwd_thread: int = 0  # a backward node's forward thread (0 elsewhere)
    annotation: bool = False  # a user range (record_function), on either row


def events_of(prof) -> Tuple[List[Ev], List[Ev]]:
    """(device events, host events) of a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        ev = Ev(e.name(), start, start + e.duration_ns() / 1e3, e.start_thread_id(),
                e.correlation_id(), e.linked_correlation_id(), e.sequence_nr(),
                e.fwd_thread_id(), bool(e.is_user_annotation()))
        (dev if e.device_type() == DeviceType.CUDA else host).append(ev)
    return dev, host


def _is_runtime_call(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)."""
    return name.startswith("cu") and "::" not in name


def _nest(spans: List[Ev]) -> List[int]:
    """Each span's parent index in ``spans`` (one thread, sorted by start,
    properly nested), -1 at the top."""
    parent, stack = [], []
    for i, s in enumerate(spans):
        while stack and spans[stack[-1]].end < s.start:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return parent


def _innermost(spans: List[Ev], times: Sequence[float]) -> List[int]:
    """For each time, the index of the innermost span of ``spans`` (one
    thread, sorted by start, nested) open at it, or -1."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [-1] * len(times)
    stack: List[int] = []
    i = 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i].start <= t:
            while stack and spans[stack[-1]].end < spans[i].start:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]].end < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


class _Threads:
    """Ranges (``wft.*`` or, with ``bench``, also ``bench.*``) by thread,
    each with its phase."""

    def __init__(self, host: Iterable[Ev], main: int, prefixes: Tuple[str, ...]):
        self.by_thread: Dict[int, List[Ev]] = {}
        for h in host:
            if h.name.startswith(prefixes):
                self.by_thread.setdefault(h.thread, []).append(h)
        self.phase: Dict[int, List[str]] = {}
        for th, spans in self.by_thread.items():
            spans.sort(key=lambda s: (s.start, -s.end))
            parent = _nest(spans)
            back, replay, phase = [], [], []
            for i, s in enumerate(spans):
                p = parent[i]
                b = s.name == BACKWARD or th != main or (p >= 0 and back[p])
                r = (p >= 0 and replay[p]) or (s.name in BLOCKS and b)
                back.append(b)
                replay.append(r)
                phase.append("replay" if r else "bwd" if b else "fwd")
            self.phase[th] = phase

    def lookup(self, queries: List[Tuple[int, float]]) -> List[Optional[Tuple[str, str]]]:
        """(name, phase) of the innermost range open at each (thread, time),
        or None."""
        out: List[Optional[Tuple[str, str]]] = [None] * len(queries)
        by_thread: Dict[int, List[int]] = {}
        for q, (th, _) in enumerate(queries):
            by_thread.setdefault(th, []).append(q)
        for th, qs in by_thread.items():
            spans = self.by_thread.get(th)
            if not spans:
                continue
            for q, i in zip(qs, _innermost(spans, [queries[q][1] for q in qs])):
                if i >= 0:
                    out[q] = (spans[i].name, self.phase[th][i])
        return out


def _backward_nodes(host: List[Ev]) -> Dict[int, List[Ev]]:
    """Autograd backward node events by thread, sorted by start."""
    out: Dict[int, List[Ev]] = {}
    for h in host:
        if h.seq >= 0 and h.fwd_thread > 0:
            out.setdefault(h.thread, []).append(h)
    for v in out.values():
        v.sort(key=lambda s: (s.start, -s.end))
    return out


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _idle_by_range(main_ranges: List[Ev], gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Seconds of each gap by the innermost range open on the main thread at
    each instant of it: the gap cut at every range's start and end."""
    cuts = sorted({t for r in main_ranges for t in (r.start, r.end)})
    pieces = []
    for a, b in gaps:
        edges = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        pieces += [(x, y) for x, y in zip(edges, edges[1:]) if y > x]
    owners = _innermost(main_ranges, [(x + y) / 2 for x, y in pieces])
    out: Dict[str, float] = {}
    for (x, y), i in zip(pieces, owners):
        name = main_ranges[i].name if i >= 0 else NONE
        out[name] = out.get(name, 0.0) + (y - x) / 1e6
    return out


def own_events(dev: List[Ev], host: List[Ev], window: str = "bench.window") -> Dict:
    """The span fields of a traced window (see the module docstring)."""
    win = sorted((h for h in host if h.name == window), key=lambda h: h.start)
    if not win:
        raise RuntimeError(f"no {window!r} range in the trace")
    w0, w1, main = win[0].start, win[-1].end, win[0].thread
    host_names = {h.name for h in host}
    work = [d for d in dev if not d.annotation and d.name not in host_names]
    inside = [d._replace(start=max(d.start, w0), end=min(d.end, w1))
              for d in work if d.end > w0 and d.start < w1]
    busy = _union([(d.start, d.end) for d in inside])

    launch = {h.corr: h for h in host if _is_runtime_call(h.name) and h.corr}
    ops = {h.corr: h for h in host if not _is_runtime_call(h.name) and h.corr}
    where: List[Tuple[int, float]] = []
    for d in inside:
        src = launch.get(d.corr) or ops.get(d.link)
        where.append((src.thread, src.start) if src is not None else (main, d.start))

    wft = _Threads(host, main, ("wft.",))
    owner = wft.lookup(where)  # (a)
    pending = [k for k, o in enumerate(owner) if o is None]
    nodes = _backward_nodes(host)
    fwd_ops = {}
    for h in sorted(host, key=lambda h: h.start):
        if h.seq >= 0 and h.fwd_thread == 0:
            fwd_ops.setdefault((h.thread, h.seq), h)
    back_q, back_k = [], []
    for th in {where[k][0] for k in pending}:
        ks = [k for k in pending if where[k][0] == th and th in nodes]
        for k, i in zip(ks, _innermost(nodes.get(th, []), [where[k][1] for k in ks])):
            if i < 0:
                continue
            node = nodes[th][i]
            op = fwd_ops.get((node.fwd_thread, node.seq))
            if op is not None:
                back_q.append((op.thread, op.start))
                back_k.append(k)
    for k, o in zip(back_k, wft.lookup(back_q)):  # (b)
        if o is not None:
            owner[k] = (o[0], "bwd")
    rest = [k for k, o in enumerate(owner) if o is None]
    ranges = _Threads(host, main, ("wft.", "bench."))
    for k, o in zip(rest, ranges.lookup([(main, where[k][1]) for k in rest])):  # (c), (d)
        owner[k] = o or (NONE, "fwd")

    device_s: Dict[str, Dict[str, float]] = {}
    group_s: Dict[str, Dict[str, float]] = {}
    kernels: Dict[str, int] = {}
    for d, (name, phase) in zip(inside, owner):
        sec = (d.end - d.start) / 1e6
        by_phase = device_s.setdefault(name, {})
        by_phase[phase] = by_phase.get(phase, 0.0) + sec
        copy = d.name.startswith(("Memcpy", "Memset"))
        group = "copy" if copy else group_of(d.name)
        by_group = group_s.setdefault(name, {})
        by_group[group] = by_group.get(group, 0.0) + sec
        if not copy:
            kernels[name] = kernels.get(name, 0) + 1
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    main_ranges = ranges.by_thread.get(main, [])
    count: Dict[str, int] = {}
    for h in host:
        if h.name.startswith("wft.") and w0 <= h.start < w1:
            count[h.name] = count.get(h.name, 0) + 1
    total = sum(v for p in device_s.values() for v in p.values())
    owned = sum(v for n, p in device_s.items() if n.startswith("wft.") for v in p.values())
    return {
        "span_device_s": device_s,
        "span_kernels": kernels,
        "span_group_s": group_s,
        "span_idle_s": _idle_by_range(main_ranges, gaps),
        "span_count": count,
        "ops_busy_s": sum(b - a for a, b in busy) / 1e6,
        "owned_share": owned / total if total > 0 else 0.0,
    }


def own(prof, window: str = "bench.window") -> Dict:
    """:func:`own_events` of a finished profiler."""
    return own_events(*events_of(prof), window=window)


# ---------------------------------------------------------------------------
# The readings
# ---------------------------------------------------------------------------

def _spans(record: Mapping, kind: str) -> Optional[Mapping]:
    tr = record.get("trace")
    if record.get("kind") != kind or not tr or "span_device_s" not in tr:
        return None
    return tr


def _owned_ms_per_step(record: Mapping, names=None, phase=None) -> Optional[float]:
    tr = _spans(record, "train")
    if tr is None or record.get("steps", 0) <= 0:
        return None
    s = sum(v for n, by_phase in tr["span_device_s"].items()
            if names is None or n in names
            for p, v in by_phase.items() if phase is None or p == phase)
    return 1e3 * s / record["steps"] if s > 0 else None


def loss_ms(record: Mapping) -> Optional[float]:
    """``train.loss_ms``: device ms a step owned by ``wft.loss``."""
    return _owned_ms_per_step(record, names=("wft.loss",))


def recompute_ms(record: Mapping) -> Optional[float]:
    """``train.recompute_ms``: device ms a step in replayed blocks."""
    return _owned_ms_per_step(record, phase="replay")


def attn_ms(record: Mapping) -> Optional[float]:
    """``train.attn_ms``: device ms a step owned by ``wft.attn``."""
    return _owned_ms_per_step(record, names=("wft.attn",))


def batch_idle_ms(record: Mapping) -> Optional[float]:
    """``train.batch_idle_ms``: idle ms a step while the host is in the
    data spans."""
    tr = _spans(record, "train")
    if tr is None or record.get("steps", 0) <= 0:
        return None
    idle = tr["span_idle_s"]
    if not any(n in idle for n in DATA) and not any(n in tr["span_count"] for n in DATA):
        return None
    return 1e3 * sum(idle.get(n, 0.0) for n in DATA) / record["steps"]


def token_step_ms(record: Mapping) -> Optional[float]:
    """``decode.token_step_ms``: host ms a token step, span clock."""
    entry = (record.get("span_clock") or {}).get(TOKEN_STEP)
    if record.get("kind") != "decode" or not entry or entry[0] <= 0:
        return None
    return 1e3 * entry[1] / entry[0]


def kernels_per_token(record: Mapping) -> Optional[float]:
    """``decode.kernels_per_token``: kernels owned by the token steps over
    the token steps of the traced calls."""
    tr = _spans(record, "decode")
    if tr is None or tr["span_count"].get(TOKEN_STEP, 0) <= 0:
        return None
    return tr["span_kernels"].get(TOKEN_STEP, 0) / tr["span_count"][TOKEN_STEP]


READINGS = {
    "train.loss_ms": loss_ms, "train.recompute_ms": recompute_ms,
    "train.attn_ms": attn_ms, "train.batch_idle_ms": batch_idle_ms,
    "decode.token_step_ms": token_step_ms, "decode.kernels_per_token": kernels_per_token,
}


def readings(record: Mapping) -> Dict[str, float]:
    """Every reading that finds something to read in ``record``."""
    out = {}
    for name, read in READINGS.items():
        v = read(record)
        if v is not None:
            out[name] = float(v)
    return out


# ---------------------------------------------------------------------------
# A traced run with the spans' reduction
# ---------------------------------------------------------------------------

class _DecodeCalls:
    """While on, ``transcribe_batch`` as the decode kind calls it. With
    ``rounds``, the kind's first call (set-up, before the traced window) is
    made again ``2 * rounds`` times right after it returns, and
    :meth:`timed_calls` makes the last call again after the run."""

    def __init__(self, rounds: int):
        from whisper_finetune_torch.models import decoding

        self.mod, self.real, self.last = decoding, None, None
        self.rounds, self.before = rounds, None

    def __call__(self, *args, **kwargs):
        first = self.last is None
        self.last = (args, kwargs)
        out = self.real(*args, **kwargs)
        if first and self.rounds:
            self.before = self.timed_calls()
        return out

    def __enter__(self):
        self.real = self.mod.transcribe_batch
        self.mod.transcribe_batch = self
        return self

    def __exit__(self, *exc):
        self.mod.transcribe_batch = self.real
        return False

    def timed_calls(self) -> Dict:
        """Wall seconds of the last call made again, span clock off and on
        in turns (off, on, on, off, ...), and the clock's table of the
        first call with it on (no table, and only calls with it off, in a
        program without the span clock)."""
        import torch

        from whisper_finetune_torch import runtime

        timed = getattr(runtime, "timed", None)
        args, kwargs = self.last
        secs: Dict[str, List[float]] = {"off": [], "on": []}
        clock = None
        for r in range(self.rounds):
            for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
                if mode == "on" and timed is None:
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "on":
                    with timed() as table:
                        self.real(*args, **kwargs)
                    clock = clock or table
                else:
                    self.real(*args, **kwargs)
                torch.cuda.synchronize()
                secs[mode].append(time.perf_counter() - t0)
        return {"call_s": secs, "span_clock": clock}


def traced_run(cell: Mapping, seed: int, device="cuda", dims_override=None) -> Dict:
    """One traced window of ``cell`` with the spans' fields added to its
    trace (on a card); the reference and the check are not run."""
    import importlib

    from benchmark import trace

    kind_name = cell["traffic_spec"]["kind"]
    kind = importlib.import_module(f"benchmark.kinds.{kind_name}")
    real_reduce = trace.reduce

    def reduce_with_spans(prof, window="bench.window"):
        out = real_reduce(prof, window)
        out.update(own(prof, window))
        return out

    saved = {}
    if kind_name == "train":
        saved["reference_readings"] = kind.reference_readings
        kind.reference_readings = lambda cell, recipe, dims, seed, dev, feed, gen_states: {
            "losses": [0.0, 0.0], "grad_norms": [1.0], "change_norms": [1.0]}
        saved["compare"] = kind.compare
        kind.compare = lambda prog, ref: {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    else:
        saved["read_rows"] = kind.read_rows
        kind.read_rows = lambda *a, **k: {name: 0.0 for name in cell["limits"]}
    trace.reduce = reduce_with_spans
    calls = _DecodeCalls(2 if device == "cuda" else 0) if kind_name == "decode" else None
    try:
        if calls is not None:
            with calls:
                res = kind.run(cell, seed, 1.0, True, time.monotonic(), device=device,
                               dims_override=dims_override)
        else:
            res = kind.run(cell, seed, 1.0, True, time.monotonic(), device=device,
                           dims_override=dims_override)
    finally:
        trace.reduce = real_reduce
        for name, fn in saved.items():
            setattr(kind, name, fn)
    record = res["record"]
    if calls is not None and calls.rounds:
        after = calls.timed_calls()
        record["span_clock"] = after["span_clock"]
        record["span_clock_before"] = calls.before["span_clock"]
        record["call_s"] = {"before": calls.before["call_s"], "after": after["call_s"]}
    return record


def summary(record: Mapping) -> Dict:
    """The line :func:`main` prints: the window, the span tables, the
    readings."""
    tr = record.get("trace") or {}
    out = {"kind": record.get("kind"), "steps": record.get("steps"),
           "calls": record.get("calls"), "window_s": tr.get("window_s"),
           "busy_s": tr.get("busy_s")}
    for key in ("ops_busy_s", "owned_share", "span_count", "span_kernels"):
        out[key] = tr.get(key)
    out["device_s_by_span"] = tr.get("span_device_s")
    out["device_s_by_span_group"] = tr.get("span_group_s")
    out["idle_s_by_span"] = tr.get("span_idle_s")
    for key in ("span_clock", "span_clock_before", "call_s"):
        if key in record:
            out[key] = record[key]
    if "call_s" in record:
        out["call_s_median"] = {f"{when}.{mode}": statistics.median(v)
                                for when, by_mode in record["call_s"].items()
                                for mode, v in by_mode.items() if v}
    out["readings"] = readings(record)
    if record.get("span_clock_before"):
        out["token_step_ms_before_window"] = token_step_ms(
            {"kind": "decode", "span_clock": record["span_clock_before"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import run, spec

    run._cache_dirs()
    sys.path.insert(0, str(spec.ROOT))
    cell = spec.cell(args.workload)
    why_not = run.device_ok(int(cell["chips"]))
    if why_not:
        print(f"benchmark.spans: {why_not}", file=sys.stderr)
        return 2
    import torch

    line = summary(traced_run(cell, args.seed))
    line["workload"], line["seed"] = args.workload, args.seed
    line["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
