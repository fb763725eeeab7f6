"""Process runtime and the metrics facade, the port of
``whisper_finetune_tpu/runtime.py``.

The same module-global facade as the JAX package (and the reference's
``runtime.py``), so call sites never check the rank:

* the rank globals come from the environment as ``torchrun`` sets it
  (``RANK``, ``WORLD_SIZE``); one process drives one card. A world size
  above 1 raises: data parallelism is ROADMAP item 12;
* :func:`barrier` is a no-op at world size 1;
* metrics go to W&B when it is installed *and* enabled (imported only
  then), and always to ``metrics.jsonl`` in the run directory, with the
  same records as the JAX package: ``_step``, ``_time`` and the values,
  histogram records (``{"_type": "histogram", "counts", "edges"}``) as
  they are.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

RANK = 0
WORLD_SIZE = 1
IS_MAIN = True

_wandb = None
_metrics_file = None


def setup_distributed() -> None:
    """Read the rank globals from ``RANK`` / ``WORLD_SIZE`` (1 process when
    unset)."""
    global RANK, WORLD_SIZE, IS_MAIN

    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world_size > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world_size}: the PyTorch port trains on one card; "
            "data parallelism (DDP, ZeRO-1) is ROADMAP item 12"
        )
    RANK, WORLD_SIZE = rank, world_size
    IS_MAIN = RANK == 0


def print_once(*args, **kwargs) -> None:
    if IS_MAIN:
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every process: a no-op in the one process the port runs."""


def cleanup() -> None:
    global _metrics_file
    if _metrics_file is not None:
        _metrics_file.close()
        _metrics_file = None


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
    cleanup()
