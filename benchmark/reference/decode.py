"""The reference's reading of served greedy tokens.

For each sampled row: the clip's log-mel (no SpecAugment), the encoder, and
one teacher-forced decoder pass over the prompt followed by the served
tokens. At every served position the logits pass the cell's filter table
(ids always suppressed; ids suppressed at the first sampled position only),
and the gap is the best filtered logit less the served token's logit: 0 for
a token the reference would have chosen itself.

The program's own mean log-probability of each row's served tokens (what
its greedy loop accumulates from the filtered logits it computed) is
compared with the reference's mean over the same tokens: that number moves
with every logit, where the served tokens of a random-weight model move
only at near ties.

The control reads, at the same positions, the gap under the float32
reference of the token that a lower precision puts first, and the lower
precision's own mean log-probability of the served tokens.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch

from benchmark.reference import audio
from benchmark.reference.whisper import Precision, decode, encode


def filtered_logits(w: Mapping, clip: torch.Tensor, prompt: Sequence[int],
                    served: Sequence[int], dims: Mapping, pr: Precision,
                    suppress: Sequence[int], blank: Sequence[int]) -> torch.Tensor:
    """(len(served), n_vocab) float32: the logits that chose each served
    token, filtered."""
    dev = clip.device
    mel = audio.log_mel(clip[None], int(dims["n_mels"]))
    xa = encode(w, mel, dims, pr)
    seq = torch.tensor([list(prompt) + list(served)], dtype=torch.long, device=dev)
    logits = decode(w, seq[:, :-1], xa, dims, pr)[0, len(prompt) - 1:]
    logits = logits.index_fill(1, torch.tensor(list(suppress), device=dev), float("-inf"))
    logits[0, torch.tensor(list(blank), device=dev)] = float("-inf")
    return logits


def served_gaps(logits: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """Best filtered logit less the served token's, a position."""
    tok = torch.tensor(list(served), dtype=torch.long, device=logits.device)
    return logits.amax(dim=-1) - logits.gather(1, tok[:, None])[:, 0]


def mean_logprob(logits: torch.Tensor, served: Sequence[int]) -> float:
    """The served tokens' mean log-probability under the filtered logits."""
    tok = torch.tensor(list(served), dtype=torch.long, device=logits.device)
    return float(torch.log_softmax(logits, dim=-1).gather(1, tok[:, None]).mean())


def read_rows(w: Mapping, rows: List[Dict], dims: Mapping, filters: Mapping,
              control: bool = False) -> Dict:
    """``rows``: dicts with ``clip`` (480000,) on the card, ``prompt`` and
    ``served`` id lists and the program's ``mean_logprob`` of them. Returns
    the widest gap of the served tokens (``logit_gap``) and the widest
    difference between the program's mean log-probability of a row's served
    tokens and the reference's (``logprob_gap``); with ``control``, the same
    two read for the fp8 control: the gap of the tokens it puts first, and
    its mean log-probability of the served tokens."""
    ref, low = Precision("float32"), Precision("fp8")
    out = {"logit_gap": 0.0, "logprob_gap": 0.0, "tokens": 0}
    if control:
        out.update(control_logit_gap=0.0, control_logprob_gap=0.0)
    with torch.no_grad():
        for r in rows:
            lg = filtered_logits(w, r["clip"], r["prompt"], r["served"], dims, ref,
                                 filters["suppress"], filters["blank"])
            lp_ref = mean_logprob(lg, r["served"])
            out["logit_gap"] = max(out["logit_gap"], float(served_gaps(lg, r["served"]).max()))
            out["logprob_gap"] = max(out["logprob_gap"], abs(r["mean_logprob"] - lp_ref))
            out["tokens"] += len(r["served"])
            if control:
                lc = filtered_logits(w, r["clip"], r["prompt"], r["served"], dims, low,
                                     filters["suppress"], filters["blank"])
                pick = lc.argmax(dim=-1).tolist()
                out["control_logit_gap"] = max(out["control_logit_gap"],
                                               float(served_gaps(lg, pick).max()))
                out["control_logprob_gap"] = max(out["control_logprob_gap"],
                                                 abs(mean_logprob(lc, r["served"]) - lp_ref))
    return out
