"""Helpers the per-layer readers share: the traced window's numbers."""

from __future__ import annotations

from typing import Mapping, Optional


def trace(record: Mapping) -> Optional[Mapping]:
    """The traced window's reduction, or None where the run traced nothing."""
    tr = record.get("trace")
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    return tr


def idle_pct(record: Mapping) -> Optional[float]:
    tr = trace(record)
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_s(record: Mapping, needle: str) -> float:
    tr = trace(record) or {}
    return sum(v for k, v in tr.get("kernel_s", {}).items() if needle in k)
