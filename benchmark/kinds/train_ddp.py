"""The ``train_ddp`` kind: a shipped data-parallel training recipe on every
card of the cell, one process a card, as ``launchers/torchrun_finetune.sh``
starts them: ``runtime.setup_distributed`` reads each rank's globals and
starts the process group (NCCL across cards, gloo on the CPU), and the
program's step reduces the gradients once an optimizer step.

The benchmark's process is rank 0; it starts the other ranks as
``python3 -m benchmark.kinds.train_ddp --worker <file>`` and each builds the
same step through ``kinds/train.py``'s builders, with the optimizer the
training script makes in a process group (Muon's Newton-Schulz sharded over
the ranks). The recipe's ``accum_grad_steps`` is global: each rank runs
``accum / world`` microbatches of ``batch_size`` clips a step, so a step
is the same optimizer step as the one-card cell of the recipe's batch.

Data and draws are those of the one-card ``train`` kind (``Feed``): the
global step's microbatches in order, rank ``r`` taking the ``r``-th run of
``accum / world`` of them, with their stochastic-depth draws. The SpecAugment
generator of each rank starts every step where one card's generator would
stand after the microbatches before the rank's (its draws made again on a
copy of the step's generator state), so that the ranks together draw what
one card draws. The window ends when rank 0 says so (one broadcast a step,
after the loss has been read).

``train_audio_h_per_s`` counts every rank's clips; ``peak_mem_gib`` is the
largest rank's. The check: rank 0, after the window, follows the first two
steps with the float32 reference at the whole global batch
(``kinds/train.py::reference_readings``), as the one-card cell does. The
reference stays whole on one card: spread over the ranks, its gradients
would meet through the same collective the check holds the program's
exchange to. A traced run times rank 0's ``fused_apply`` with CUDA events,
as ``kinds/train.py`` does (``train.update_ms``).

``fault`` plants a fault in every rank's program, for the readings that set
the cell's limits: ``no_grad_reduce`` leaves out the all-reduce of the
gradient sums, so each rank updates with its own microbatches' gradients.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from benchmark.kinds import train as T
from benchmark.trace import Profiled

GIB = float(1 << 30)


class RankFeed(T.Feed):
    """``Feed`` whose step batches hold only the rank's microbatches
    (``micro``, indices into the global step's); ``micro`` may be set to
    every microbatch for the reference."""

    def __init__(self, traffic, recipe, dims, seed, device, rank: int, world: int):
        super().__init__(traffic, recipe, dims, seed, device)
        self.local = self.accum // world
        self.micro = range(rank * self.local, (rank + 1) * self.local)

    def host_batch(self, k: int) -> Dict[str, np.ndarray]:
        from whisper_finetune_torch.data import collate, stack_microbatches

        per_step = self.rows * self.accum
        micro = []
        for m in self.micro:
            idx = [int(self.order[(k * per_step + m * self.rows + j) % len(self.order)])
                   for j in range(self.rows)]
            samples = [{"audio": self.clips[r], "crop_frames": 3000,
                        "dec_input": self.tokens[r][0], "dec_output": self.tokens[r][1]}
                       for r in idx]
            micro.append(collate(samples, pad_to=self.pad_to))
        return stack_microbatches(micro)

    def rank_draws(self, k: int):
        d = self.draws(k)
        return [d[m] for m in self.micro]


def advance(gen: torch.Generator, recipe: Mapping, rows: int, passes: int) -> None:
    """Makes on ``gen`` the SpecAugment draws of ``passes`` feature passes
    of ``rows`` clips, in the program's order (``featurize_impl``)."""
    sa = recipe["augmentation"]["spec_augment"]
    if not sa.get("apply"):
        return
    dev, W, T_ = gen.device, int(sa["time_warp_w"]), 3000
    for _ in range(passes):
        torch.rand((rows,), generator=gen, device=dev)
        if T_ > 2 * W + 1:
            torch.randint(W, T_ - W, (rows,), generator=gen, device=dev)
            torch.randint(-W, W, (rows,), generator=gen, device=dev)
        torch.rand((rows, 2), generator=gen, device=dev)
        torch.rand((rows, 2), generator=gen, device=dev)


def build_step(recipe: Mapping, dims_obj, seed: int, device, horizon: int, world: int):
    """``kinds/train.py::build_step`` with the optimizer the training script
    makes at a world above 1 (Muon's Newton-Schulz over ``world`` ranks)."""
    import whisper_finetune_torch.optim as optim_mod
    from whisper_finetune_torch.parallel import DATA_AXIS

    real = optim_mod.get_optimizer

    def sharded(*args, **kwargs):
        return real(*args, data_shard_axis=DATA_AXIS, data_axis_size=world, **kwargs)

    optim_mod.get_optimizer = sharded
    try:
        return T.build_step(recipe, dims_obj, seed, device, horizon)
    finally:
        optim_mod.get_optimizer = real


FAULTS = ("no_grad_reduce",)


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The program with ``fault`` (one of :data:`FAULTS`, or None) planted
    for the block."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    from whisper_finetune_torch import parallel

    real = parallel.all_reduce

    def local_sums(t, op="sum"):
        return t if op == "sum" and t.dim() > 0 else real(t, op)

    parallel.all_reduce = local_sums
    try:
        yield
    finally:
        parallel.all_reduce = real


def rank_main(job: Mapping) -> Dict:
    """One rank's run: set-up and the first two steps, the window, and
    (rank 0) the reference's check. Returns rank 0's result."""
    with planted(job.get("fault")):
        return _rank_main(job)


def _rank_main(job: Mapping) -> Dict:
    import torch.autograd.profiler as tprof
    import torch.distributed as dist

    from whisper_finetune_torch import runtime
    from whisper_finetune_torch.models.dims import MODEL_PRESETS

    cell, seed, rank, world = job["cell"], int(job["seed"]), int(job["rank"]), int(job["world"])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(job["port"]))
    torch.set_num_threads(1)  # as torchrun sets OMP_NUM_THREADS for each rank
    dev = runtime.setup_distributed(job["device"], timeout_s=600.0)
    cuda = dev.type == "cuda"
    dims_obj = MODEL_PRESETS[cell["config_spec"]["preset"]]
    if job.get("dims_override"):
        dims_obj = dims_obj.replace(**job["dims_override"])
    dims = dims_obj.to_dict()
    recipe = T.load_recipe(cell)
    horizon = int(cell["traffic_spec"]["schedule_steps"])
    feed = RankFeed(cell["traffic_spec"], recipe, dims, seed, dev, rank, world)
    if feed.accum % world:
        raise ValueError(f"accum_grad_steps {feed.accum} does not divide over {world} ranks")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    step, state, tx, model, config = build_step(recipe, dims_obj, seed, dev, horizon, world)
    named_paths = [path for path, _ in model.leaves()]
    if named_paths != [s[0] for s in T.leaf_specs(dims)]:
        raise RuntimeError("the program's leaves are not the benchmark's weights' leaves")
    glob = torch.Generator(device=dev)
    glob.manual_seed((seed * 13 + 5) % (1 << 63))
    gen = torch.Generator(device=dev)

    def run_step(k: int, batch):
        gen.set_state(glob.get_state())
        advance(gen, recipe, feed.rows, feed.micro.start)
        out = step(state, batch, gen, T.program_draws(feed.rank_draws(k)))
        advance(glob, recipe, feed.rows, feed.accum)
        return out

    b1 = float((config["optimizer"].get("params") or {}).get("betas", (0.9, 0.999))[0])
    prog = {"losses": []}
    gen_states = []
    batch = feed.device_batch(0)
    for k in range(2):
        gen_states.append(glob.get_state())
        state, loss = run_step(k, batch)[:2]
        batch = feed.device_batch(k + 1)
        prog["losses"].append(float(loss))
        if k == 0:
            prog["grad_norms"] = T.first_gradient_norms(
                state.opt_state, tx, [p for _, p in model.leaves()], b1)
    prog["change_norms"] = T.change_norms([p for _, p in model.leaves()], dims, seed, dev)
    setup_s = time.monotonic() - job["t_start"]

    trace = bool(job["trace"]) and cuda and rank == 0
    tx.timing = trace
    c0 = T._counters()
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    n_steps, k = 0, 2
    trace_steps = int(cell["traffic_spec"]["trace_steps"])
    with Profiled(trace) as prof:
        with tprof.record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                with tprof.record_function("bench.step"):
                    state, loss = run_step(k, batch)[:2]
                with tprof.record_function("bench.host_batch"):
                    batch = feed.device_batch(k + 1)
                with tprof.record_function("bench.loss_sync"):
                    float(loss)
                n_steps += 1
                k += 1
                if rank == 0:
                    done = ((n_steps >= trace_steps) if job["trace"]
                            else (time.perf_counter() - t0 >= job["seconds"]))
                    flag.fill_(int(done))
                dist.broadcast(flag, 0)
                if int(flag.item()):
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    c1 = T._counters()
    update_ms = [a.elapsed_time(b) for a, b in tx.events]
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if cuda else 0],
                        dtype=torch.int64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    dist.barrier()
    del step, state, tx, model, batch
    runtime.cleanup()
    if rank:
        return {}
    T._free()
    t_window_end = time.monotonic()
    feed.micro = range(feed.accum)
    ref = T.reference_readings(cell, recipe, dims, seed, dev, feed, gen_states)
    numbers = T.compare(prog, ref)
    limits = cell["limits"]
    check = {name: {"value": numbers[name], "limit": float(limits[name])}
             for name in ("loss_gap", "grad_gap", "change_gap")}
    correct = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in check.values())
    samples = n_steps * feed.rows * feed.accum
    record = {"kind": "train", "world": world, "dims": dims, "rows": feed.rows,
              "accum": feed.local, "steps": n_steps, "window_s": window_s,
              "trace": prof.result, "counters": {key: c1[key] - c0[key] for key in c0},
              "update_ms": update_ms}
    return {
        "correct": bool(correct), "attempted": samples, "failed": 0,
        "e2e": {"train_audio_h_per_s": samples * 30.0 / 3600.0 / window_s,
                "peak_mem_gib": float(peak) / GIB, "setup_s": setup_s},
        "record": record, "peak_bytes": int(peak), "check": check,
        "readings": {"program": prog, "reference": ref, "numbers": numbers, "world": world,
                     "seconds": {"setup": setup_s, "window": window_s,
                                 "reference": time.monotonic() - t_window_end}},
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def run(cell: Mapping, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", dims_override: Optional[Mapping] = None,
        fault: Optional[str] = None) -> Dict:
    """One run of a ``train_ddp`` cell over ``cell["chips"]`` ranks: this
    process is rank 0, the others are started here and waited for."""
    world = int(cell["chips"])
    job = {"cell": dict(cell), "seed": int(seed), "seconds": float(seconds),
           "trace": bool(trace), "device": str(device), "dims_override": dims_override,
           "world": world, "port": _free_port(), "t_start": t_start, "fault": fault}
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tmp = tempfile.mkdtemp(prefix="train_ddp_")
    procs: List = []
    for r in range(1, world):
        path = os.path.join(tmp, f"rank{r}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({**job, "rank": r, "t_start": 0.0}, f)
        log = open(os.path.join(tmp, f"rank{r}.log"), "w", encoding="utf-8")
        procs.append((subprocess.Popen([sys.executable, "-m", "benchmark.kinds.train_ddp",
                                        "--worker", path], cwd=root, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    try:
        res = rank_main({**job, "rank": 0})
    except BaseException:
        for p, _ in procs:
            p.kill()
        raise
    finally:
        bad = []
        for r, (p, log) in enumerate(procs, start=1):
            try:
                rc = p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = "killed"
            log.close()
            if rc != 0:
                with open(log.name, encoding="utf-8") as f:
                    bad.append(f"rank {r} exited {rc}:\n{f.read()[-4000:]}")
        for text in bad:
            print(text, file=sys.stderr)
    if bad:
        raise RuntimeError(f"{len(bad)} of {world - 1} worker ranks failed")
    return res


def _worker(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a train_ddp run")
    ap.add_argument("--worker", required=True)
    args = ap.parse_args(argv)
    with open(args.worker, encoding="utf-8") as f:
        job = json.load(f)
    rank_main(job)
    return 0


if __name__ == "__main__":
    sys.exit(_worker())
