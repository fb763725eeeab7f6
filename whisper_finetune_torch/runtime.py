"""Process runtime and the metrics facade, the port of
``whisper_finetune_tpu/runtime.py``.

The same module-global facade as the JAX package (and the reference's
``runtime.py``), so call sites never check the rank:

* :func:`setup_distributed` reads ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). At a
  world size above 1 it starts the default ``torch.distributed`` process
  group (``nccl`` for a card, ``gloo`` on the CPU, or the backend the caller
  names) that ``parallel/`` runs its collectives in, and it raises when that
  fails instead of carrying on alone; one process drives one card
  (``cuda:LOCAL_RANK`` unless the caller names a device). There is no DDP
  wrapper: the train step reduces the gradient sums itself, once per
  optimizer step (``train/step.py``);
* :func:`barrier` waits for every process; :func:`cleanup` destroys the
  group;
* metrics go to W&B when it is installed *and* enabled (imported only
  then), and always to ``metrics.jsonl`` in the run directory, with the
  same records as the JAX package: ``_step``, ``_time`` and the values,
  histogram records (``{"_type": "histogram", "counts", "edges"}``) as
  they are. Only rank 0 logs;
* :func:`span` marks a layer boundary (``wft.encoder``, ``wft.loss``, ...):
  a ``torch.profiler`` range while a profiler runs, and host wall time in
  the table of :func:`timed` while one is open. With neither, it does
  nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from datetime import timedelta
from typing import Any, Dict, Iterator, List, Optional, Union

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

RANK = 0
WORLD_SIZE = 1
LOCAL_RANK = 0
IS_DISTRIBUTED = False
IS_MAIN = True

_wandb = None
_metrics_file = None


def setup_distributed(device: Union[str, torch.device] = "cuda",
                      backend: Optional[str] = None,
                      timeout_s: float = 1800.0) -> torch.device:
    """Read the rank globals from ``torchrun``'s environment (one process
    when ``WORLD_SIZE`` is unset or 1) and return this process's device:
    ``device`` itself, where a bare ``cuda`` means ``cuda:LOCAL_RANK``.

    At ``WORLD_SIZE > 1``, or when the caller names a ``backend``, it starts
    the default process group at ``MASTER_ADDR:MASTER_PORT`` with that
    backend (default ``nccl`` for a card, ``gloo`` for the CPU) and raises
    ``RuntimeError`` if it cannot."""
    global RANK, WORLD_SIZE, LOCAL_RANK, IS_DISTRIBUTED, IS_MAIN
    import torch.distributed as dist

    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wants_group = world_size > 1 or backend is not None
    if wants_group and not (dist.is_available() and dist.is_initialized()):
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        try:
            kwargs = {"device_id": dev} if backend == "nccl" else {}
            dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                    world_size=world_size, rank=rank,
                                    timeout=timedelta(seconds=timeout_s), **kwargs)
        except Exception as exc:
            raise RuntimeError(
                f"rank {rank} of {world_size}: could not start the {backend} process "
                f"group at {addr}:{port}: {exc}") from exc
    RANK, WORLD_SIZE, LOCAL_RANK = rank, world_size, local_rank
    IS_DISTRIBUTED = WORLD_SIZE > 1
    IS_MAIN = RANK == 0
    return dev


def is_main() -> bool:
    return IS_MAIN


def print_once(*args, **kwargs) -> None:
    if IS_MAIN:
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every process of the group (a no-op in one process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _close_metrics() -> None:
    global _metrics_file
    if _metrics_file is not None:
        _metrics_file.close()
        _metrics_file = None


def cleanup() -> None:
    """Close the metrics file and destroy the process group, if any."""
    import torch.distributed as dist

    _close_metrics()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Metrics facade: W&B when installed and enabled, local JSONL always (rank 0).
# ---------------------------------------------------------------------------

def setup_wandb(config: Optional[Dict[str, Any]] = None,
                metrics_dir: Optional[str] = None, **kwargs) -> None:
    """Start the metrics sinks on the main process: ``wandb.init`` unless
    ``mode`` is ``disabled`` (or wandb is not installed), and
    ``metrics.jsonl`` in ``metrics_dir`` (default: the config's
    ``save_dir``)."""
    global _wandb, _metrics_file

    if not IS_MAIN:
        return
    if kwargs.get("mode") != "disabled":
        try:
            import wandb
        except ImportError:
            print("wandb is not installed; logging metrics to local JSONL only.")
        else:
            wandb.init(config=config, **kwargs)
            _wandb = wandb

    if metrics_dir is None and config is not None:
        metrics_dir = config.get("save_dir")
    if metrics_dir:
        os.makedirs(metrics_dir, exist_ok=True)
        _metrics_file = open(os.path.join(metrics_dir, "metrics.jsonl"), "a")


def _is_histogram_record(value: Any) -> bool:
    return isinstance(value, dict) and value.get("_type") == "histogram"


def log(data: Dict[str, Any], step: Optional[int] = None) -> None:
    if not IS_MAIN:
        return
    if _wandb is not None:
        _wandb.log({k: (_wandb.Histogram(np_histogram=(v["counts"], v["edges"]))
                        if _is_histogram_record(v) else v)
                    for k, v in data.items()}, step=step)
    if _metrics_file is not None:
        record = {"_step": step, "_time": time.time()}
        record.update({k: _to_jsonable(v) for k, v in data.items()})
        _metrics_file.write(json.dumps(record) + "\n")
        _metrics_file.flush()


def _to_jsonable(value: Any) -> Any:
    try:
        json.dumps(value)
        return value
    except TypeError:
        try:
            return float(value)
        except (TypeError, ValueError):
            return str(value)


def watch(params, **kwargs) -> None:
    """``wandb.watch(model, log="all")``'s place, kept so that call sites
    shaped like the reference's work: a no-op, because the training loop
    already logs what it would (gradient histograms from the train step as
    ``grads_hist/*``, parameter histograms as ``params_hist/*`` and norms as
    ``params/*``, in ``scripts/finetune.py``)."""


def save_wandb_file(path: str) -> None:
    if _wandb is not None:
        _wandb.save(path)


def update_wandb_config(data: Dict[str, Any], **kwargs) -> None:
    if _wandb is not None:
        _wandb.config.update(data, **kwargs)


def set_wandb_summary(key: str, value: Any) -> None:
    if _wandb is not None:
        _wandb.summary[key] = value


def finish_wandb() -> None:
    global _wandb
    if _wandb is not None:
        _wandb.finish()
        _wandb = None
    _close_metrics()


# ---------------------------------------------------------------------------
# Spans: the program's layer boundaries, for the profiler and the span clock.
# ---------------------------------------------------------------------------

_clock: Optional[Dict[str, List]] = None  # {name: [count, seconds]} while timed() is open
_clock_lock = threading.Lock()  # spans also close on the autograd engine's thread
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.t0 = 0

    def __enter__(self):
        if _profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        table = _clock
        if table is not None:
            with _clock_lock:
                entry = table.setdefault(self.name, [0, 0.0])
                entry[0] += 1
                entry[1] += dt / 1e9
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """``with span("wft.loss"):`` marks the block as the layer ``name``.
    While a ``torch.profiler`` runs it is a ``record_function`` range, on the
    same timeline as the card's kernels; while :func:`timed` is open its host
    wall time adds to that table. Otherwise it costs a flag check and
    ``torch.autograd._profiler_enabled()``, and enters no range."""
    if _clock is None and not _profiler_enabled():
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def timed() -> Iterator[Dict[str, List]]:
    """Turns the span clock on for the block and yields its table,
    ``{span name: [count, seconds]}``: every span that closes inside the
    block, on any thread, adds its count and host wall time
    (``time.perf_counter_ns``). An outer ``timed`` block's table gets
    nothing while an inner one is open."""
    global _clock
    outer, table = _clock, {}
    _clock = table
    try:
        yield table
    finally:
        _clock = outer
