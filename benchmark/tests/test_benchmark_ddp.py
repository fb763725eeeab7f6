"""The data-parallel training kind on the CPU: ranks over gloo at tiny widths
give the one-card cell's first steps, each rank's microbatches and
SpecAugment draws are the one-card step's, and the NCCL reader reads only
a run across ranks."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import spec
from benchmark.kinds import train, train_ddp
from benchmark.reference import audio
from benchmark.tests.tiny import TINY_DIMS

SEED = 2**31 + 404


def _cell(name: str, world: int) -> dict:
    cell = copy.deepcopy(spec.cell(name))
    cell["chips"] = world
    cell["traffic_spec"].update(distinct_rows=8, reference_slice_rows=1)
    cell["overrides"] = {"dataset.batch_size": 2, "training.accum_grad_steps": 4}
    return cell


def test_two_ranks_give_the_one_card_steps():
    res = train_ddp.run(_cell("large-v3.muon-ddp4", 2), SEED, 0.1, False, time.monotonic(),
                        device="cpu", dims_override=TINY_DIMS)
    one = train.run(_cell("large-v3.muon-b32a8", 1), SEED, 0.1, False, time.monotonic(),
                    device="cpu", dims_override=TINY_DIMS)
    assert res["correct"] is True and res["readings"]["world"] == 2
    assert res["readings"]["program"]["losses"] == pytest.approx(
        one["readings"]["program"]["losses"], abs=1e-5)
    assert res["record"]["accum"] == 2 and res["attempted"] % 8 == 0


def test_rank_batches_and_draws_are_the_steps():
    cell = _cell("large-v3.muon-ddp4", 2)
    recipe = train.load_recipe(cell)
    from whisper_finetune_torch.models.dims import MODEL_PRESETS

    dims = MODEL_PRESETS["large-v3"].replace(**TINY_DIMS).to_dict()
    whole = train.Feed(cell["traffic_spec"], recipe, dims, SEED, "cpu").host_batch(3)
    parts = [train_ddp.RankFeed(cell["traffic_spec"], recipe, dims, SEED, "cpu", r, 2)
             for r in range(2)]
    for key, a in whole.items():
        got = [p.host_batch(3)[key] for p in parts]
        assert (torch.from_numpy(a[:2]).equal(torch.from_numpy(got[0]))
                and torch.from_numpy(a[2:]).equal(torch.from_numpy(got[1]))), key
    # rank 1's generator, advanced past rank 0's passes, draws what one
    # card's draws for the step's third and fourth microbatches
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    one = audio.spec_augment_draws(state, 2, 4, 3000,
                                   int(recipe["augmentation"]["spec_augment"]["time_warp_w"]),
                                   "cpu")
    train_ddp.advance(gen, recipe, 2, 2)
    rank1 = audio.spec_augment_draws(gen.get_state(), 2, 2, 3000,
                                     int(recipe["augmentation"]["spec_augment"]["time_warp_w"]),
                                     "cpu")
    for a, b in zip(one[2:], rank1):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_nccl_reader_reads_runs_across_ranks():
    trace = {"window_s": 3.0, "busy_s": 2.9,
             "kernel_s": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.05, "nvjet_x": 1.0}}
    rec = {"kind": "train", "world": 4, "steps": 1, "trace": trace}
    reader = spec.metric_reader("ddp.nccl_ms")
    assert reader.read(rec) == pytest.approx(50.0)
    assert reader.read(dict(rec, world=1)) is None and reader.read({}) is None


def test_no_grad_reduce_fails_a_limit():
    """Without the all-reduce of the gradient sums each rank updates with
    its own microbatches' gradients: the check fails, and the exchange is
    back once the run ends."""
    from whisper_finetune_torch import parallel

    real = parallel.all_reduce
    res = train_ddp.run(_cell("large-v3.muon-ddp4", 2), SEED, 0.1, False, time.monotonic(),
                        device="cpu", dims_override=TINY_DIMS, fault="no_grad_reduce")
    assert res["correct"] is False, res["check"]
    assert parallel.all_reduce is real
