"""Batch packaging: fetch a list of checkpoints (W&B runs or local paths),
convert each to HF + CTranslate2, and publish each to its paired Hub repo
(or a local HF-cache repo). The port of
``whisper_finetune_tpu/scripts/wandb_to_ct2_upload.py``.

    python -m whisper_finetune_torch.scripts.wandb_to_ct2_upload \\
        --pairs pairs.tsv [--workdir hub_upload] [--local-only] [--no-ct2] [--device cpu]

Driven by the constant lists below (zipped index-wise) or by ``--pairs``, a
file of ``<checkpoint-or-wandb-run>\\t<repo-id>`` lines; each pair runs
:func:`whisper_finetune_torch.scripts.upload_model_to_hub.main`.
"""

from __future__ import annotations

import argparse
import os

from whisper_finetune_torch.scripts import upload_model_to_hub
from whisper_finetune_torch.scripts.upload_model_to_hub import main as upload_main

# ---------------------------------------------------------------------------
# Edit these lists (zipped index-wise), or pass --pairs file.tsv.
# ---------------------------------------------------------------------------
SOURCES = [
    # "output/12345/best_model.pt",
    # "my-entity/my-project/run_id",
]
REPO_IDS = [
    # "my-org/whisper-large-v3-de",
]
QUANTIZATIONS = ["float16"]  # broadcast if length 1


def run_batch(sources, repo_ids, quantizations, workdir, local_only, convert_ct2,
              cache_dir=None, device="cuda"):
    """Package every (source, repo id, quantization): a source that exists
    on disk is a checkpoint, anything else a W&B run (its
    ``best_model.pt``). One quantization is broadcast to every source.
    Every other argument of ``upload_model_to_hub`` takes its CLI default."""
    if len(quantizations) == 1:
        quantizations = quantizations * len(sources)
    if not (len(sources) == len(repo_ids) == len(quantizations)):
        raise ValueError(
            f"List lengths differ: {len(sources)} sources, {len(repo_ids)} "
            f"repos, {len(quantizations)} quantizations"
        )
    for src, repo, quant in zip(sources, repo_ids, quantizations):
        is_local = os.path.exists(src)
        args = upload_model_to_hub.build_parser().parse_args(["--repo-id", repo])
        args.checkpoint = src if is_local else None
        args.wandb_run = None if is_local else src
        args.wandb_file = "best_model.pt"
        args.workdir = workdir
        args.convert_hf = True
        args.convert_ct2 = convert_ct2
        args.quantization = quant
        args.local_only = local_only
        args.token = os.environ.get("HF_TOKEN")
        args.cache_dir = cache_dir
        args.device = device
        print(f"\n=== {src} -> {repo} ({quant}) ===")
        upload_main(args)


def read_pairs(path: str):
    """(sources, repo ids) from a ``<source>\\t<repo-id>`` file; blank lines
    and ``#`` comments are skipped."""
    sources, repos = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            src, repo = line.split("\t")
            sources.append(src)
            repos.append(repo)
    return sources, repos


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Batch checkpoint publishing")
    parser.add_argument("--pairs", help="TSV file: <source>\\t<repo-id> per line")
    parser.add_argument("--workdir", default="hub_upload")
    parser.add_argument("--local-only", action="store_true")
    parser.add_argument("--no-ct2", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="Device of the HF conversions: cuda (default) or cpu")
    return parser


def cli(argv=None) -> None:
    args = build_parser().parse_args(argv)
    sources, repos = list(SOURCES), list(REPO_IDS)
    if args.pairs:
        more_sources, more_repos = read_pairs(args.pairs)
        sources += more_sources
        repos += more_repos
    if not sources:
        raise SystemExit("No sources configured (edit SOURCES or pass --pairs)")
    run_batch(sources, repos, QUANTIZATIONS, args.workdir, args.local_only,
              convert_ct2=not args.no_ct2, device=args.device)


if __name__ == "__main__":
    cli()
