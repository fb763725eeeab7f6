"""The reference's training steps: what a training cell's first steps should
give, worked out from the inputs the benchmark hands both sides (the seed's
weights, the batches, the forward draws, the SpecAugment generator state).

One step is ``accum`` microbatches; each microbatch's loss is the
label-smoothed cross entropy, the mean over its kept target tokens (-100
ignored), and the step's loss is the mean over its microbatches. The
gradient of that mean is clipped to the recipe's global norm (factor
``min(1, max_norm / (norm + 1e-6))``) and handed to the optimizer. A
microbatch runs in slices of ``slice_rows`` rows, whose sums are the
microbatch's, so that float32 fits on the card (without recompute at two
rows a slice; ``remat`` recomputes each block in its backward instead).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from benchmark.reference import audio, optim
from benchmark.reference.whisper import Draws, Precision, forward


def smoothed_ce_sum(logits: torch.Tensor, targets: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Sum over kept positions of (1 - s) * NLL + s * mean over the
    vocabulary of -log p."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = targets != -100
    safe = torch.where(mask, targets, 0)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    per = (1.0 - smoothing) * nll + smoothing * (-logp.mean(dim=-1))
    return torch.where(mask, per, 0.0).sum()


def _flatten(tree: Mapping, prefix=()) -> List:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_flatten(v, prefix + (k,)) if isinstance(v, Mapping) else [(prefix + (k,), v)])
    return out


def features(batch_audio, crop, sa: Mapping, n_mels: int, draws: Optional[Dict]):
    mel = audio.crop_min_pad(audio.log_mel(batch_audio, n_mels), crop)
    if draws is not None:
        mel = audio.spec_augment(mel, draws, float(sa.get("p", 1.0)), int(sa["time_mask_param"]),
                                 int(sa["freq_mask_param"]), int(sa["time_warp_w"]))
    return mel


class ReferenceTrainer:
    """The recipe's steps in the reference's precision over weights ``w``
    (the benchmark's float32 tree, trained in place)."""

    def __init__(self, w: Mapping, dims: Mapping, recipe: Mapping, horizon: int,
                 pr: Precision, slice_rows: int = 2, remat: bool = False):
        self.w, self.dims, self.recipe, self.pr = w, dims, recipe, pr
        self.named = _flatten(w)
        for _, leaf in self.named:
            leaf.requires_grad_(True)
        self.opt = optim.build(recipe, self.named, horizon, pr)
        self.slice_rows, self.remat = slice_rows, remat
        t = recipe["training"]
        aug = recipe["augmentation"]
        dsa = aug["deep_spec_augment"]
        self.train_cfg = {
            "stochastic_depth": float(t.get("stochastic_depth", 0.0)),
            "dsa": {"apply": bool(dsa.get("apply")), "p": float(dsa.get("p", 1.0)),
                    "time_mask_param": int(dsa["time_mask_param"]),
                    "freq_mask_param": int(dsa["freq_mask_param"])},
        }
        self.sa = aug["spec_augment"]
        self.count = 0

    def step(self, batch: Mapping[str, torch.Tensor], draws: Sequence[Draws],
             gen_state: torch.Tensor) -> Dict:
        """One optimizer step. ``batch``: (accum, B, ...) tensors ``audio``,
        ``crop_frames``, ``dec_input``, ``dec_output``. Returns the loss and
        the gradient as the optimizer got it (one tensor a leaf)."""
        t = self.recipe["training"]
        accum, rows = batch["audio"].shape[:2]
        dev = batch["audio"].device
        sa_draws = ([None] * accum if not self.sa.get("apply") else
                    audio.spec_augment_draws(gen_state, rows, accum, 3000,
                                             int(self.sa["time_warp_w"]), dev))
        leaves = [leaf for _, leaf in self.named]
        for p in leaves:
            p.grad = None
        loss_sum = 0.0
        smoothing = float(t.get("label_smoothing", 0.0))
        n_mels = int(self.dims["n_mels"])
        for i in range(accum):
            with torch.no_grad():
                mel = features(batch["audio"][i], batch["crop_frames"][i], self.sa, n_mels,
                               sa_draws[i])
            targets = batch["dec_output"][i]
            count = float(max(1, int((targets != -100).sum())))
            for s in range(0, rows, self.slice_rows):
                sl = slice(s, s + self.slice_rows)
                logits = forward(self.w, mel[sl], batch["dec_input"][i][sl], self.dims, self.pr,
                                 draws[i], self.train_cfg, remat=self.remat)
                loss = smoothed_ce_sum(logits, targets[sl], smoothing) / count
                del logits
                loss.backward()  # sums into each leaf's .grad
                loss_sum += float(loss.detach())
                del loss
        grad_sum = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        for p in leaves:
            p.grad = None
        for g in grad_sum:
            g.div_(accum)
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grad_sum))
        max_norm = t.get("max_grad_norm")
        if max_norm is not None:
            clip = min(1.0, float(max_norm) / (norm + 1e-6))
            for g in grad_sum:
                g.mul_(clip)
        with torch.no_grad():
            self.opt.apply(grad_sum, self.count)
        self.count += 1
        return {"loss": loss_sum / accum, "grads": grad_sum}
