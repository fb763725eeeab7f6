"""The ranks of the port's multi-process CPU tests, and the helper that
starts them.

``run_ranks(case, spec, world, tmp)`` writes ``spec`` to a file and starts
``world`` processes of this script over ``gloo`` (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` as ``torchrun`` sets them); each runs
``CASES[case](spec)`` through ``runtime.setup_distributed`` and saves what it
returns, which ``run_ranks`` hands back per rank. The ranks import torch and
the port, never JAX (``assert_no_jax``); the same case functions run in the
test process itself as the one-process reference (no process group).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def assert_no_jax() -> None:
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "whisper_finetune_tpu")))
    assert not bad, f"a rank imported {bad[:5]}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case: str, spec: dict, world: int, tmp, timeout: float = 240.0) -> list:
    """Run ``case`` in ``world`` gloo ranks; returns each rank's result."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = tmp / f"{case}_spec.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        env.pop("XLA_FLAGS", None)
        out = tmp / f"{case}_rank{r}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, __file__, case, str(spec_path), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out))
    logs = []
    try:
        for p, _ in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, f"rank exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out, weights_only=False) for _, out in procs]


def one_process(case: str, spec: dict) -> dict:
    """``case`` in this process (no process group), on one thread as each
    rank runs, so its float32 products round as the ranks' do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return CASES[case](spec)
    finally:
        torch.set_num_threads(threads)


def split_rows(batches: list, n: int) -> list:
    """The microbatches of ``n`` ranks in one process: (accum, B) ->
    (accum * n, B / n), microbatch (i, r) holding rank r's rows of
    microbatch i."""
    def split(v):
        a, b = v.shape[:2]
        return v.reshape(a * n, b // n, *v.shape[2:])

    return [{k: split(v) for k, v in b.items()} for b in batches]


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _model(spec):
    from whisper_finetune_torch.models import params_from_jax
    from whisper_finetune_torch.models.dims import ModelDimensions

    return params_from_jax(spec["params"], ModelDimensions(**spec["dims"]), device="cpu")


def _local(batch: dict, n: int, r: int) -> dict:
    """Rank ``r``'s rows of each microbatch of a global (accum, B, ...)
    batch, as JAX's ``shard_batch`` splits B over the data axis."""
    per = batch["mel"].shape[1] // n
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, r * per:(r + 1) * per]))
            .to(torch.long if v.dtype.kind == "i" else torch.float32) for k, v in batch.items()}


def _moments_np(tx, opt_state, n_leaves):
    from whisper_finetune_torch.optim.quantized import QMoment
    from whisper_finetune_torch.train.zero import owned_moments

    return [[(m.codes.numpy().copy(), m.scale.numpy().copy()) if isinstance(m, QMoment)
             else m.float().numpy().copy() for m in ms]
            for ms in owned_moments(tx, opt_state, n_leaves)]


def steps_case(spec: dict) -> dict:
    """One optimizer step of ``make_train_step`` for each global batch of
    ``spec["batches"]``, on this rank's rows of it. With ``save_after`` the
    state is saved to ``state_path`` after that many steps, a fresh state is
    built and loaded from the file, and the rest run on it; with
    ``resume_from`` the run starts from that file (``train/state_io.py``)."""
    from whisper_finetune_torch import parallel
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.optim import get_optimizer
    from whisper_finetune_torch.train import TrainState, make_train_step
    from whisper_finetune_torch.train.state_io import load_train_state, save_train_state
    from whisper_finetune_torch.train.zero import zero_opt_partition, zero_shard_state
    from whisper_finetune_torch.models.dims import ModelDimensions

    n, r = parallel.world(), parallel.rank()
    zero = bool(spec.get("zero")) and n > 1
    shard_muon = bool(spec.get("shard_muon"))
    hist_every = spec.get("hist_every")

    def build():
        model = _model(spec)
        tx, _ = get_optimizer(model.leaves(), spec["opt"],
                              data_shard_axis="data" if shard_muon else None,
                              data_axis_size=n if shard_muon else 1)
        leaves = [p for _, p in model.leaves()]
        opt_state = tx.init(leaves)
        if zero:
            opt_state = zero_shard_state(tx, opt_state, leaves)
        return TrainState(model, opt_state, 0), tx

    def make_step(tx):
        return make_train_step(ModelDimensions(**spec["dims"]), ForwardConfig(**spec["fcfg"]),
                               tx, spec.get("smoothing", 0.0),
                               max_grad_norm=spec.get("max_grad_norm"),
                               accum_dtype=spec.get("accum_dtype"),
                               grad_hist_every=hist_every, zero_shard=zero,
                               split_update=bool(spec.get("split")), device="cpu")

    state, tx = build()
    if spec.get("resume_from"):
        state = load_train_state(spec["resume_from"], state, tx, zero)
    step = make_step(tx)
    leaves = [p for _, p in state.model.leaves()]
    flags = zero_opt_partition(tx, state.opt_state, leaves, n) if zero else [False] * len(leaves)
    losses, hists, params_after, moments_after = [], [], [], []
    parallel.reset_counts()
    for i, batch in enumerate(spec["batches"]):
        if spec.get("save_after") == i:
            path = spec["state_path"]
            save_train_state(path, state, tx, zero)
            if n > 1:
                torch.distributed.barrier()
            state, tx = build()  # fresh weights and state, then the file's
            state = load_train_state(path, state, tx, zero)
            step = make_step(tx)
        out = step(state, _local(batch, n, r))
        state, loss = out[0], out[1]
        losses.append(float(loss))
        if hist_every:
            hists.append({k: (c.numpy().copy(), float(lo), float(hi))
                          for k, (c, lo, hi) in out[2].items()})
        params_after.append({".".join(path): p.detach().numpy().copy()
                             for path, p in state.model.leaves()})
        moments_after.append(_moments_np(tx, state.opt_state, len(leaves)))
    return {
        "losses": losses,
        "params": params_after,
        "moments": moments_after,
        "flags": flags,
        "hists": hists,
        "step": state.step,
        "count": state.opt_state.count,
        "comm": parallel.counts(),
        "labels": getattr(tx, "labels", None),
        "split_step": hasattr(step, "last_timing"),
    }


def eval_case(spec: dict) -> dict:
    """``evaluate_multiple_datasets`` over fixed host batches."""
    from whisper_finetune_torch.eval import evaluate_multiple_datasets, make_eval_step
    from whisper_finetune_torch.models.dims import ModelDimensions
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.tokenizer import get_tokenizer

    model = _model(spec)
    step = make_eval_step(ModelDimensions(**spec["dims"]), ForwardConfig(**spec["fcfg"]))
    loaders = {name: (lambda b=batches: iter(b)) for name, batches in spec["loaders"].items()}
    metrics, macro = evaluate_multiple_datasets(step, model, loaders, get_tokenizer(),
                                                device="cpu")
    return {"datasets": [m.__dict__ for m in metrics], "macro": macro}


def driver_case(spec: dict) -> dict:
    """``scripts/finetune.main`` on ``spec["config"]``; the run's
    metrics.jsonl records and its final step."""
    import json

    from whisper_finetune_torch.scripts import finetune

    state, run_dir = finetune.main(spec["config"], device="cpu")
    run = Path(run_dir)  # only rank 0 makes it
    records = ([json.loads(line) for line in open(run / "metrics.jsonl")]
               if (run / "metrics.jsonl").exists() else [])
    return {"records": records, "step": state.step, "run_dir": run_dir,
            "files": sorted(os.listdir(run)) if run.exists() else []}


CASES = {"steps": steps_case, "eval": eval_case, "driver": driver_case}


def _main(argv) -> None:
    case, spec_path, out_path = argv
    torch.set_num_threads(1)
    import whisper_finetune_torch.runtime as rt

    spec = torch.load(spec_path, weights_only=False)
    rt.setup_distributed("cpu")
    try:
        result = CASES[case](spec)
        assert_no_jax()
        torch.save(result, out_path)
    finally:
        rt.cleanup()


if __name__ == "__main__":
    _main(sys.argv[1:])
