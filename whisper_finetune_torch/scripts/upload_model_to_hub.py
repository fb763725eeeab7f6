"""Package and publish a fine-tuned checkpoint: .pt -> HF Transformers ->
CTranslate2, uploaded to the HuggingFace Hub or written as a local HF-cache
repo. The port of ``whisper_finetune_tpu/scripts/upload_model_to_hub.py``.

    python -m whisper_finetune_torch.scripts.upload_model_to_hub \\
        --checkpoint output/<run>/best_model.pt --repo-id org/name \\
        [--convert-hf] [--convert-ct2 --quantization int8] \\
        [--local-only --cache-dir DIR] [--device cpu]

The source is a local ``.pt`` or a file of a W&B run. ``--convert-hf``
converts on ``--device`` (the card by default) and ships the deployment
assets (``tokenizer.json``, ``config.json``, ``preprocessor_config.json``)
beside the weights; ``--convert-ct2`` converts that folder with CTranslate2.
``--local-only`` writes an HF-hub-cache-shaped repo whose revision is derived
from its content, so ``from_pretrained`` and faster-whisper resolve the repo
id offline. ``ctranslate2``, ``huggingface_hub`` and ``wandb`` are imported
only when their feature is asked for, and raise an ``ImportError`` that says
what to do where they are missing.
"""

from __future__ import annotations

import argparse
import os
import shutil
from datetime import date

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fetch_checkpoint(args) -> str:
    """The source checkpoint's path: ``args.checkpoint``, or
    ``args.wandb_file`` (default ``best_model.pt``) of the W&B run
    ``args.wandb_run`` downloaded into ``args.workdir``."""
    if args.checkpoint:
        if not os.path.isfile(args.checkpoint):
            raise FileNotFoundError(args.checkpoint)
        return args.checkpoint
    if args.wandb_run:
        try:
            import wandb
        except ImportError as exc:
            raise ImportError(
                "--wandb-run requires the wandb package; pass --checkpoint "
                "with a local .pt instead."
            ) from exc
        run = wandb.Api().run(args.wandb_run)
        target = args.wandb_file or "best_model.pt"
        os.makedirs(args.workdir, exist_ok=True)
        run.file(target).download(root=args.workdir, replace=True)
        return os.path.join(args.workdir, target)
    raise ValueError("Provide --checkpoint or --wandb-run")


def convert_to_hf(checkpoint_path: str, out_dir: str, tokenizer_dir=None,
                  device="cuda") -> str:
    """``out_dir/hf``: the converted model (built on ``device``) and its
    deployment assets."""
    from whisper_finetune_torch.scripts.convert_openai_to_hf import (
        convert_openai_whisper_to_tfms,
    )

    hf_dir = os.path.join(out_dir, "hf")
    convert_openai_whisper_to_tfms(checkpoint_path, hf_dir, device=device)
    _copy_deployment_assets(checkpoint_path, hf_dir, tokenizer_dir)
    return hf_dir


# What a CTranslate2 / faster-whisper consumer needs beside the weights.
DEPLOYMENT_ASSET_FILES = ("tokenizer.json", "config.json", "preprocessor_config.json")


def _dims(checkpoint_path: str) -> dict:
    with open(checkpoint_path, "rb") as fp:
        return torch.load(fp, map_location="cpu", weights_only=True)["dims"]


def resolve_tokenizer_dir(checkpoint_path: str, tokenizer_dir=None):
    """The tokenizer-asset directory for a checkpoint. An explicit
    ``tokenizer_dir`` wins; ``"auto"`` or None picks by the checkpoint's
    dims among the asset sets at the repo root: ``whisper_v3_turbo_utils``
    for the 4-text-layer turbo family, ``whisper_v3_utils`` for the other
    51866-vocabulary (large-v3) models, and None for vocabularies the
    packaged assets do not match."""
    if tokenizer_dir and tokenizer_dir != "auto":
        return tokenizer_dir
    dims = _dims(checkpoint_path)
    if int(dims.get("n_vocab", 0)) != 51866:
        return None
    name = "whisper_v3_turbo_utils" if int(dims.get("n_text_layer", 0)) == 4 else "whisper_v3_utils"
    candidate = os.path.join(_REPO_ROOT, name)
    return candidate if os.path.isdir(candidate) else None


def _copy_deployment_assets(checkpoint_path: str, hf_dir: str, tokenizer_dir=None) -> None:
    """Copy the three deployment JSONs next to the converted weights (an
    asset directory missing one of them raises). Without a matching asset
    set the converter's own ``config.json`` stays, a preprocessor config is
    written from the checkpoint's dims, and there is no tokenizer (a
    warning says so)."""
    import json

    resolved = resolve_tokenizer_dir(checkpoint_path, tokenizer_dir)
    if resolved is not None:
        missing = [f for f in DEPLOYMENT_ASSET_FILES
                   if not os.path.isfile(os.path.join(resolved, f))]
        if missing:
            raise FileNotFoundError(f"tokenizer dir {resolved} is missing {missing}")
        for f in DEPLOYMENT_ASSET_FILES:
            shutil.copyfile(os.path.join(resolved, f), os.path.join(hf_dir, f))
        return

    print("warning: no packaged tokenizer assets match this checkpoint's "
          "vocabulary; shipping generated config + preprocessor only")
    preprocessor = {
        "chunk_length": 30,
        "feature_extractor_type": "WhisperFeatureExtractor",
        "feature_size": int(_dims(checkpoint_path)["n_mels"]),
        "hop_length": 160,
        "n_fft": 400,
        "n_samples": 480000,
        "nb_max_frames": 3000,
        "padding_side": "right",
        "padding_value": 0.0,
        "processor_class": "WhisperProcessor",
        "return_attention_mask": False,
        "sampling_rate": 16000,
    }
    with open(os.path.join(hf_dir, "preprocessor_config.json"), "w") as f:
        json.dump(preprocessor, f, indent=2)


def convert_to_ct2(hf_dir: str, out_dir: str, quantization: str) -> str:
    """``out_dir/ct2-<quantization>``: the HF folder converted by
    CTranslate2's ``TransformersConverter``."""
    try:
        from ctranslate2.converters import TransformersConverter
    except ImportError as exc:
        raise ImportError(
            "CTranslate2 conversion requires the ctranslate2 package "
            "(offline image: run this step on a deployment host)."
        ) from exc
    ct2_dir = os.path.join(out_dir, f"ct2-{quantization}")
    TransformersConverter(hf_dir).convert(ct2_dir, quantization=quantization, force=True)
    return ct2_dir


def build_readme(repo_id: str, source: str, has_pt: bool = True, has_ct2: bool = False,
                 quantization: str = "float16", wandb_run_url: str = None,
                 readme_arg: str = None) -> str:
    """README text: a user-supplied file or literal wins; otherwise the
    contents, faster-whisper usage and W&B provenance, generated."""
    if readme_arg:
        if os.path.isfile(readme_arg):
            with open(readme_arg) as f:
                return f.read()
        return readme_arg

    text = (
        "---\n"
        "library_name: whisper_finetune_torch\n"
        "tags: [whisper, speech-recognition, ctranslate2]\n"
        "---\n\n"
        f"# {repo_id.split('/')[-1]}\n\n"
        "This repository contains a fine-tuned Whisper model "
        f"(exported {date.today().isoformat()} from "
        f"`{os.path.basename(source)}` by whisper_finetune_torch).\n\n"
        "## Contents\n\n"
    )
    if has_pt:
        text += f"- `{os.path.basename(source)}`: Original OpenAI Whisper format checkpoint\n"
    if has_ct2:
        text += "- CTranslate2/faster-whisper model files (at repo root)\n"
        text += f"""
## Usage with faster-whisper

```python
from faster_whisper import WhisperModel

# Load directly from HuggingFace Hub
model = WhisperModel("{repo_id}", device="cuda", compute_type="{quantization}")
segments, info = model.transcribe("audio.mp3", language="de")

for segment in segments:
    print(f"[{{segment.start:.2f}}s -> {{segment.end:.2f}}s] {{segment.text}}")
```
"""
    if wandb_run_url:
        text += f"\n## Training\n\nW&B Run: {wandb_run_url}\n"
    return text


def write_readme(out_dir: str, repo_id: str, source: str, **kwargs) -> None:
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(build_readme(repo_id, source, **kwargs))


# ---------------------------------------------------------------------------
# The HF-cache-shaped local repo
# ---------------------------------------------------------------------------

def _repo_folder_name(repo_id: str, repo_type: str = "model") -> str:
    """'org/repo' -> 'models--org--repo' (the HF hub cache's convention)."""
    return f"{repo_type}s--" + "--".join(repo_id.split("/"))


def _digest_file(hasher, path: str, chunk: int = 1 << 20) -> None:
    with open(path, "rb") as f:
        for buf in iter(lambda: f.read(chunk), b""):
            hasher.update(buf)


def snapshot_revision(repo_id: str, file_paths, readme_text=None) -> str:
    """The snapshot's pseudo-commit hash, from the content deposited:
    sha256 over the repo id, every file's relative name and bytes (in name
    order) and the README text, cut to 40 hex digits (the HF cache expects
    commit-shaped names). The same content gives the same snapshot, whatever
    the files' times; a changed byte gives a new one."""
    import hashlib

    h = hashlib.sha256(repo_id.encode())
    for rel_name, path in sorted(file_paths):
        h.update(b"\x00" + rel_name.encode() + b"\x00")
        _digest_file(h, path)
    if readme_text is not None:
        h.update(b"\x00README.md\x00" + readme_text.encode())
    return h.hexdigest()[:40]


def write_to_hf_cache(repo_id: str, pt_path: str = None, ct2_folder: str = None,
                      readme_text: str = None, revision: str = "main",
                      cache_dir: str = None, extra_files=None) -> str:
    """Write the model files into an HF-hub-cache-shaped local repo,

        {cache_dir}/models--{org}--{repo}/
            refs/{revision}        # the commit hash
            snapshots/{hash}/      # the files

    so that ``from_pretrained(repo_id)`` and faster-whisper find the model
    offline. ``extra_files`` (e.g. ``tokenizer.json``) go to the snapshot's
    root; on a name collision the first entry wins, so a CT2 folder keeps its
    own ``config.json``. Returns the snapshot directory."""
    if cache_dir is None:
        cache_dir = os.environ.get("HF_HUB_CACHE") or os.path.join(
            os.path.expanduser("~"), ".cache", "huggingface", "hub")
    repo_folder = os.path.join(cache_dir, _repo_folder_name(repo_id))

    manifest = []  # (relative name, source path): the revision hashes these
    if ct2_folder and os.path.isdir(ct2_folder):
        for root, _, files in os.walk(ct2_folder):
            for name in files:
                full = os.path.join(root, name)
                manifest.append((os.path.relpath(full, ct2_folder), full))
    if pt_path and os.path.exists(pt_path):
        manifest.append((os.path.basename(pt_path), pt_path))
    taken = {rel for rel, _ in manifest}
    for path in extra_files or ():
        if os.path.exists(path) and os.path.basename(path) not in taken:
            manifest.append((os.path.basename(path), path))
            taken.add(os.path.basename(path))

    commit_hash = snapshot_revision(repo_id, manifest, readme_text)
    refs_dir = os.path.join(repo_folder, "refs")
    snapshot_dir = os.path.join(repo_folder, "snapshots", commit_hash)
    os.makedirs(refs_dir, exist_ok=True)
    os.makedirs(snapshot_dir, exist_ok=True)
    with open(os.path.join(refs_dir, revision), "w") as f:
        f.write(commit_hash)
    for rel_name, src in manifest:
        dest = os.path.join(snapshot_dir, rel_name)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(src, dest)
    if readme_text is not None:
        with open(os.path.join(snapshot_dir, "README.md"), "w") as f:
            f.write(readme_text)

    print(f"local HF cache repo ready: {repo_id} -> {repo_folder} "
          f"(revision {commit_hash}, {len(manifest)} files)")
    return snapshot_dir


def upload_to_hub(repo_id: str, paths, token=None) -> None:
    """Create the Hub repo if needed and upload each path: a folder under
    its own name, a file at the root."""
    try:
        from huggingface_hub import HfApi
    except ImportError as exc:
        raise ImportError(
            "Hub upload requires huggingface_hub; use --local-only here."
        ) from exc
    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    for path in paths:
        if os.path.isdir(path):
            api.upload_folder(folder_path=path, repo_id=repo_id,
                              path_in_repo=os.path.basename(path))
        else:
            api.upload_file(path_or_fileobj=path, repo_id=repo_id,
                            path_in_repo=os.path.basename(path))


def main(args) -> None:
    """Package ``args`` (the namespace :func:`build_parser` gives): copy the
    checkpoint into ``workdir/<repo id>``, convert as asked, write the
    README, then write the local cache repo (``local_only``) or upload."""
    ckpt = fetch_checkpoint(args)
    out_dir = os.path.join(args.workdir, args.repo_id.replace("/", "__"))
    os.makedirs(out_dir, exist_ok=True)
    pt_copy = os.path.join(out_dir, os.path.basename(ckpt))
    shutil.copy2(ckpt, pt_copy)
    artifacts = [pt_copy]

    ct2_dir = hf_dir = None
    if args.convert_hf or args.convert_ct2:
        hf_dir = convert_to_hf(ckpt, out_dir, tokenizer_dir=args.tokenizer_dir,
                               device=args.device)
        artifacts.append(hf_dir)
        if args.convert_ct2:
            ct2_dir = convert_to_ct2(hf_dir, out_dir, args.quantization)
            artifacts.append(ct2_dir)

    wandb_run_url = f"https://wandb.ai/{args.wandb_run}" if args.wandb_run else None
    readme_text = build_readme(
        args.repo_id, ckpt, has_pt=True, has_ct2=ct2_dir is not None,
        quantization=args.quantization, wandb_run_url=wandb_run_url, readme_arg=args.readme)
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(readme_text)
    artifacts.append(os.path.join(out_dir, "README.md"))

    if args.local_only:
        # The snapshot's root carries the deployment JSONs: from the converted
        # folder if there is one, else the packaged set matching the
        # checkpoint. Beside a CT2 folder its own config.json stays.
        asset_src = hf_dir if hf_dir is not None else resolve_tokenizer_dir(
            ckpt, args.tokenizer_dir)
        asset_names = (tuple(f for f in DEPLOYMENT_ASSET_FILES if f != "config.json")
                       if ct2_dir else DEPLOYMENT_ASSET_FILES)
        assets = [os.path.join(asset_src, f) for f in asset_names
                  if asset_src and os.path.isfile(os.path.join(asset_src, f))]
        snapshot = write_to_hf_cache(
            args.repo_id, pt_path=pt_copy, ct2_folder=ct2_dir, readme_text=readme_text,
            cache_dir=args.cache_dir, extra_files=assets)
        print(f"Local repo written to {out_dir}; HF cache snapshot: {snapshot}")
        for a in artifacts:
            print(f"  - {a}")
        return
    upload_to_hub(args.repo_id, artifacts, token=args.token)
    print(f"Uploaded {len(artifacts)} artifacts to {args.repo_id}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Package/publish a checkpoint")
    parser.add_argument("--checkpoint", help="Local OpenAI-format .pt")
    parser.add_argument("--wandb-run", help="W&B run path entity/project/run_id")
    parser.add_argument("--wandb-file", default=None, help="File inside the run")
    parser.add_argument("--repo-id", required=True, help="HF hub repo id")
    parser.add_argument("--workdir", default="hub_upload")
    parser.add_argument("--convert-hf", action="store_true")
    parser.add_argument("--convert-ct2", action="store_true")
    parser.add_argument("--quantization", default="float16",
                        choices=["float16", "int8", "int8_float16"])
    parser.add_argument("--local-only", action="store_true")
    parser.add_argument("--tokenizer-dir", default="auto",
                        help="Directory with tokenizer.json/config.json/"
                             "preprocessor_config.json (default: pick the "
                             "packaged whisper_v3[_turbo]_utils set matching "
                             "the checkpoint dims)")
    parser.add_argument("--readme", default=None,
                        help="README path or literal text (default: auto)")
    parser.add_argument("--cache-dir", default=None,
                        help="HF-cache root for --local-only (default: "
                             "HF_HUB_CACHE or ~/.cache/huggingface/hub)")
    parser.add_argument("--token", default=None)
    parser.add_argument("--device", default="cuda",
                        help="Device of the HF conversion: cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
