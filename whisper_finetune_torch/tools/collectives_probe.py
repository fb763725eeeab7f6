"""Which collectives a process-group backend takes, on which device:
``python -m whisper_finetune_torch.tools.collectives_probe``.

Starts two ``gloo`` ranks on ``cuda:0`` (both on the one card: NCCL
refuses two ranks of a communicator on one GPU), one ``nccl`` rank of a
group of one, and two ``gloo`` ranks on the CPU, and tries in each every
collective the data-parallel step, the evaluator and the train-state save
use (``parallel/``), in float32, bfloat16 and int64: all-reduce (sum, min,
max), reduce-scatter (one tensor and a list), all-gather (into one tensor
and a list), broadcast and a barrier. Prints one JSON line a rank:
``[rank, backend, device, {collective: "ok" | "FAIL <error>"}]``. Without
a card it probes the CPU alone.
"""

from __future__ import annotations

import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probe(rank: int, world: int, port: int, backend: str, device: str, queue) -> None:
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    res = {}

    def attempt(name, fn):
        try:
            fn()
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as exc:  # noqa: BLE001 - the probe reports every failure
            res[name] = f"FAIL {type(exc).__name__}: {str(exc).splitlines()[0][:160]}"

    rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        tag = str(dt).split(".")[1]
        x = torch.ones(8, 4, dtype=dt, device=device)
        part = torch.empty(8 // world, 4, dtype=dt, device=device)
        full = torch.empty(8 * world, 4, dtype=dt, device=device)
        for op in ("SUM", "MIN", "MAX"):
            attempt(f"all_reduce_{op.lower()}_{tag}",
                    lambda op=op: dist.all_reduce(x.clone(), op=getattr(dist.ReduceOp, op)))
        attempt(f"reduce_scatter_tensor_{tag}", lambda: rs(part, x))
        attempt(f"reduce_scatter_list_{tag}",
                lambda: dist.reduce_scatter(part, list(x.chunk(world))))
        attempt(f"all_gather_into_tensor_{tag}", lambda: ag(full, x))
        attempt(f"all_gather_list_{tag}",
                lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x))
        attempt(f"broadcast_{tag}", lambda: dist.broadcast(x, 0))
    attempt("barrier", dist.barrier)
    queue.put((rank, backend, device, res))
    dist.destroy_process_group()


def main() -> int:
    configs = [("gloo", 2, "cpu")]
    if torch.cuda.is_available():
        configs = [("gloo", 2, "cuda:0"), ("nccl", 1, "cuda:0")] + configs
    ctx = mp.get_context("spawn")
    failed = False
    for backend, world, device in configs:
        queue, port = ctx.Queue(), _free_port()
        procs = [ctx.Process(target=_probe, args=(r, world, port, backend, device, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            results = sorted((queue.get(timeout=300) for _ in procs), key=lambda r: r[0])
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
        for r in results:
            print(json.dumps(r), flush=True)
            failed |= any(v != "ok" for v in r[3].values())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
