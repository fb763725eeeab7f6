"""The hand-written gradient-accumulating backward, the port of
``whisper_finetune_tpu/train/manual_grad.py``.

The automatic path (``train/step.py``) calls ``torch.autograd.grad`` over
every leaf once a microbatch: at the end of each backward a whole float32
gradient tree is alive (6.2 GB for large-v3) beside the accumulator. This
module keeps the same math and never builds that tree: the forward runs
under ``no_grad`` through the model's own segment functions (``conv_stem``,
``_encoder_block`` / ``_decoder_block`` under ``_stochastic``,
``decoder_embed``, ``decoder_head``), keeping each kept layer's input, which
is exactly what full remat keeps; the backward then replays one layer at a
time from its saved input, takes ``(dx, dW[, dxa])`` of that layer with one
``torch.autograd.grad`` and adds ``dW`` straight into the layer's slice of
the stacked accumulator, in place. The replay is the recompute: each kept
block runs its attention kernels twice a microbatch, as under full remat.

Randomness is the automatic path's: the stochastic-depth coins and the deep
SpecAugment masks come from the same :class:`ForwardDraws` (drawn for all
microbatches at once from the generator), and SpecAugment of the features
draws from the generator microbatch by microbatch, so one generator gives
the same loss on both paths. A layer dropped by its coin adds nothing to its
slice.

Weights in a bf16 forward: each layer's float32 matrices are cast at use
(``_dense``), or with ``precast`` each stacked matrix is cast once a
microbatch and the layers read bf16 views of it. The gradient is taken
against the very tensors the replayed block reads, so the bf16 matrices give
bf16 cotangents and the float32 vectors (layer-norm gains, biases) float32
ones; either way the values that land in the accumulator are the automatic
path's. The tied ``tok_emb`` gets the head's and the embedding's
contributions summed in float32 before the one cast to the accumulator.

Scope: full fine-tuning only (no LoRA, no frozen leaf) under ``remat_policy:
full``: the replay is the remat, so no other policy means anything here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import (
    ForwardConfig,
    ForwardDraws,
    Params,
    _decoder_block,
    _encoder_block,
    _kept,
    _layer_views,
    _set,
    _stochastic,
    conv_stem,
    decoder_embed,
    decoder_forward,
    decoder_head,
    draw_forward,
    dsa_masks,
    encoder_forward,
    flatten,
    layer_norm,
)
from whisper_finetune_torch.runtime import span


def _add(bufs: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]]) -> None:
    """``buf += g`` for each pair, in the accumulator's dtype (a leaf no path
    used: no-op), inside the span ``wft.grad_reduce``."""
    with span("wft.grad_reduce"):
        for buf, g in zip(bufs, grads):
            if g is not None:
                buf.add_(g.to(buf.dtype))


def make_manual_accumulator(dims: ModelDimensions, fcfg: ForwardConfig,
                            loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                            feat_cfg=None, precast: bool = False) -> Callable:
    """Build ``accumulate(params, batch, generator, grad_buf, draws=None) ->
    (grad_buf, loss_sum)``.

    ``params`` is the model's nested dict (every leaf trainable), ``batch``
    holds ``(accum, B, ...)`` tensors (``audio`` + ``crop_frames`` with
    ``feat_cfg``, else ``mel``; ``dec_input``, ``dec_output``), ``grad_buf``
    a tree like ``params`` in the accumulator dtype whose leaves are added
    to in place. ``draws`` (one :class:`ForwardDraws` a microbatch) replaces
    the draws the automatic path would make from ``generator``; the
    features' SpecAugment draws from ``generator``. ``loss_sum`` is the sum
    of the microbatches' losses, a float32 0-dim tensor."""
    if fcfg.lora_scale:
        raise ValueError("manual backward does not support LoRA runs")
    if fcfg.remat_policy != "full":
        raise ValueError(
            f"training.remat_policy={fcfg.remat_policy!r} cannot be combined with "
            "training.manual_backward: the manual backward replays every layer from "
            "its input, which is remat_policy 'full'")
    dtype = fcfg.dtype
    precast = bool(precast) and dtype != torch.float32
    Le, Ld = dims.n_audio_layer, dims.n_text_layer
    nh_e, nh_d = dims.n_audio_head, dims.n_text_head

    def replay(block, x_in: torch.Tensor, layer: Params, dx: torch.Tensor, *args, xa=None):
        """One layer again from its input, with fresh leaves over its weight
        views as the tensors the block reads and the gradient is taken
        against: (dx, [(path, the weight's gradient)][, dxa])."""
        pairs = flatten(layer)
        ws = [v.detach().requires_grad_() for _, v in pairs]
        bp: Params = {}
        for (path, _), w in zip(pairs, ws):
            _set(bp, path, w)
        x_in = x_in.requires_grad_()
        inputs = [x_in, *ws] + ([xa] if xa is not None else [])
        with torch.enable_grad():
            out = block(x_in, bp, *args) if xa is None else block(x_in, bp, xa, *args)
        grads = torch.autograd.grad(out, inputs, dx, allow_unused=True)
        dxa = grads[-1] if xa is not None else None
        return grads[0], [(p, g) for (p, _), g in zip(pairs, grads[1:1 + len(ws)])], dxa

    def microbatch(params: Params, buf: Params, mb: Dict[str, torch.Tensor],
                   generator, draws: Optional[ForwardDraws]) -> torch.Tensor:
        enc, dec = params["encoder"], params["decoder"]
        benc, bdec = buf["encoder"], buf["decoder"]
        with torch.no_grad():
            if feat_cfg is not None:
                from whisper_finetune_torch.ops.spec_augment import featurize_impl

                with span("wft.features"):
                    mel = featurize_impl(mb["audio"], mb["crop_frames"], generator, feat_cfg,
                                         train=True)
            else:
                mel = mb["mel"]

            # ===== forward: keep each kept layer's input =====
            with span("wft.encoder"):
                x = conv_stem(enc, mel, dims, dtype)
                kept_e = _kept(draws.enc_coin if draws else None, fcfg.sd_encoder, Le)
                dsa_on, time_keep, feat_keep = dsa_masks(fcfg, draws, Le, x)
                enc_block = _stochastic(_encoder_block,
                                        1.0 - fcfg.sd_encoder if draws else 1.0)
                enc_views = _layer_views(enc["blocks"], Le, dtype, precast)
                enc_masks = [(time_keep[i], feat_keep[i]) if dsa_on[i] else (None, None)
                             for i in range(Le)]
                enc_inputs: List[Optional[torch.Tensor]] = [None] * Le
                for i in range(Le):
                    if kept_e[i]:
                        encoder_forward.blocks_run += 1
                        enc_inputs[i] = x
                        x = enc_block(x, enc_views[i], fcfg, nh_e, *enc_masks[i], None)
                x_enc = x
                xa = layer_norm(x_enc, enc["ln_post"]).float().to(dtype)

            with span("wft.decoder"):
                x = decoder_embed(dec, mb["dec_input"], dtype)
                kept_d = _kept(draws.dec_coin if draws else None, fcfg.sd_decoder, Ld)
                dec_block = _stochastic(_decoder_block,
                                        1.0 - fcfg.sd_decoder if draws else 1.0)
                dec_views = _layer_views(dec["blocks"], Ld, dtype, precast)
                dec_inputs: List[Optional[torch.Tensor]] = [None] * Ld
                for i in range(Ld):
                    if kept_d[i]:
                        decoder_forward.blocks_run += 1
                        dec_inputs[i] = x
                        x = dec_block(x, dec_views[i], xa, fcfg, nh_d, None)
                x_dec = x

        # ===== backward =====
        with span("wft.backward"):
            # Head + loss seed dx; tok_emb's head contribution waits for its
            # gather contribution (both float32) before the cast.
            x_dec.requires_grad_()
            ln = dec["ln"]
            with span("wft.loss"):
                with torch.enable_grad():
                    loss = loss_fn(decoder_head(dec, x_dec, dtype), mb["dec_output"])
                d_ln_s, d_ln_b, d_tok_head, dx = torch.autograd.grad(
                    loss, [ln["scale"], ln["bias"], dec["tok_emb"], x_dec])
            _add([bdec["ln"]["scale"], bdec["ln"]["bias"]], [d_ln_s, d_ln_b])

            # Decoder layers in reverse: each layer's weight gradients into
            # its slice of the stacked buffer; the cross-attention cotangents
            # summed.
            xa_in = xa.detach().requires_grad_()
            dxa = torch.zeros_like(xa)
            dec_buf = dict(flatten(bdec["blocks"]))
            for i in reversed(range(Ld)):
                if not kept_d[i]:
                    continue  # identity: dx passes through, the slice gets nothing
                dx, dws, dxa_i = replay(dec_block, dec_inputs[i], dec_views[i], dx, fcfg,
                                        nh_d, None, xa=xa_in)
                dec_inputs[i] = None
                _add([dec_buf[path][i] for path, _ in dws], [g for _, g in dws])
                if dxa_i is not None:
                    dxa.add_(dxa_i)

            tok, pos = dec["tok_emb"], dec["pos_emb"]
            with torch.enable_grad():
                xd0 = decoder_embed({"tok_emb": tok, "pos_emb": pos}, mb["dec_input"], dtype)
            d_tok_gather, d_pos = torch.autograd.grad(xd0, [tok, pos], dx)
            _add([bdec["tok_emb"], bdec["pos_emb"]], [d_tok_head + d_tok_gather, d_pos])
            del d_tok_head, d_tok_gather

            # Encoder head, then the encoder layers in reverse.
            x_enc.requires_grad_()
            lnp = enc["ln_post"]
            with torch.enable_grad():
                xa_re = layer_norm(x_enc, lnp).float().to(dtype)
            d_lp_s, d_lp_b, dx = torch.autograd.grad(xa_re, [lnp["scale"], lnp["bias"], x_enc],
                                                     dxa)
            _add([benc["ln_post"]["scale"], benc["ln_post"]["bias"]], [d_lp_s, d_lp_b])
            enc_buf = dict(flatten(benc["blocks"]))
            for i in reversed(range(Le)):
                if not kept_e[i]:
                    continue
                dx, dws, _ = replay(enc_block, enc_inputs[i], enc_views[i], dx, fcfg, nh_e,
                                    *enc_masks[i], None)
                enc_inputs[i] = None
                _add([enc_buf[path][i] for path, _ in dws], [g for _, g in dws])

            # The stem, replayed (its activations were not kept).
            convs = [enc["conv1"]["w"], enc["conv1"]["b"], enc["conv2"]["w"],
                     enc["conv2"]["b"]]
            with torch.enable_grad():
                x0 = conv_stem(enc, mel, dims, dtype)
            _add([benc["conv1"]["w"], benc["conv1"]["b"], benc["conv2"]["w"],
                  benc["conv2"]["b"]], torch.autograd.grad(x0, convs, dx))
            return loss.detach()

    def accumulate(params: Params, batch: Dict[str, torch.Tensor], generator,
                   grad_buf: Params, draws: Optional[Sequence[ForwardDraws]] = None):
        if not all(p.requires_grad for _, p in flatten(params)):
            raise ValueError("manual backward needs full fine-tuning (no frozen leaves: "
                             "no LoRA, no train_only_*)")
        keys = (("audio", "crop_frames") if feat_cfg is not None else ("mel",)) + (
            "dec_input", "dec_output")
        accum = batch[keys[0]].shape[0]
        dev = batch[keys[0]].device
        if draws is None:
            draws = (draw_forward(generator, dims, dev, accum) if fcfg.needs_draws
                     else [None] * accum)
        elif len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(accum):
            loss_sum = loss_sum + microbatch(params, grad_buf, {k: batch[k][i] for k in keys},
                                             generator, draws[i])
        return grad_buf, loss_sum

    return accumulate
