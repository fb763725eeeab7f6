"""``chip_smoke.py`` on the CPU: it imports without a card, and the bounds it
prints are the benchmark's yardstick (``benchmark/yardstick/roofline.py``),
not copies of it."""

import importlib.util
from pathlib import Path

import pytest
import torch

from benchmark.yardstick import roofline
from whisper_finetune_torch.models.dims import MODEL_PRESETS

ROOT = Path(__file__).resolve().parent.parent


def _import_chip_smoke(monkeypatch):
    """A fresh import of ``chip_smoke.py``, with every way into CUDA raising."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("chip_smoke touched CUDA at import")

    for name in ("_lazy_init", "init", "is_available", "device_count", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_imports_the_yardstick_without_a_card(monkeypatch):
    """Importing it touches no CUDA; it defines none of the yardstick's
    former copies; its greedy token bound for large-v3 at 8 rows and 224
    positions is ``roofline.decode_token_bound_s``'s."""
    cs = _import_chip_smoke(monkeypatch)
    assert not torch.cuda.is_initialized()
    for name in ("bound_ms", "_flops_per_sample", "decode_token_bound", "profile_steps"):
        assert not hasattr(cs, name), name
    dims = MODEL_PRESETS["large-v3"]
    assert cs.token_bound_ms(dims, 8, 224) == roofline.decode_token_bound_s(dims.to_dict(), 8, 224) * 1e3


def test_chip_smoke_beam_bound_adds_the_cache_reorder(monkeypatch):
    """A beam token step's bound is the greedy bound at its rows plus the
    caches' reorder over 3.35 TB/s. large-v3 at 40 rows (8 clips x 5 beams)
    and 224 positions: 32 layers' self-attention K and V, 40 x 224 x 1,280
    bf16 each, read and written once, are 2,936,012,800 bytes: 0.876422 ms."""
    cs = _import_chip_smoke(monkeypatch)
    dims = MODEL_PRESETS["large-v3"]
    extra = cs.token_bound_ms(dims, 40, 224, beam=True) - cs.token_bound_ms(dims, 40, 224)
    assert extra == pytest.approx(2_936_012_800 / 3.35e12 * 1e3, rel=1e-9)
    assert extra == pytest.approx(0.8764217313, rel=1e-9)
