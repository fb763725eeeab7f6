"""The training step, the port of ``whisper_finetune_tpu/train/step.py``.

One optimizer step = ``accum`` microbatches, each contributing the
label-smoothed cross entropy (``-100`` ignored), gradients summed in the
accumulator dtype (bf16 on the main path), then ONE fused update: the mean
divisor and the global-norm clip factor ride into the optimizer's one-pass
``fused_apply`` as a single float32 scalar (``reduce_sums``), so no mean/clip
pass over the gradient tree exists. Any optimizer of ``optim/`` serves
(8-bit or float32 Adam/AdamW, Muon with its auxiliary AdamW); its learning
rate is ``base_lr * schedule(count)`` read from its own count of updates.

Stochastic depth and deep SpecAugment draw all their random numbers for all
microbatches of a step at once (``draw_forward``: one transfer to the host a
step), before the first forward.

Frozen parameters (LoRA's base weights, the other side of a
``train_only_encoder`` / ``train_only_decoder`` run) have
``requires_grad=False`` (:func:`mark_trainable`): the step differentiates,
clips and updates only the trainable leaves, in the JAX flatten order, and
the optimizer's state covers those alone.

With ``grad_hist_every`` the step also returns per-module histograms of
the step's gradients (:func:`grad_histograms`, the ``wandb.watch(log="all")``
telemetry) on every ``grad_hist_every``-th optimizer step, zeros otherwise.

Data parallelism (one process per card, ``parallel/``) keeps the JAX
step's shape rather than DDP's bucketed hooks: each rank accumulates its
local microbatches, then ONE reduction of the gradient sums per optimizer
step, in the accumulator dtype (what the reference's ``no_sync`` amounts
to); the mean divisor ``1 / (accum_local * world)`` and the clip factor are
computed from the reduced sums and ride in the one ``g_scale``. With
``zero_shard`` at a world above 1 the step is ZeRO-1 (JAX's
``zero_shard=True`` branch): gradients of the leaves that shard
(:func:`train.zero.zero_opt_partition`) are reduce-scattered over rows and
divided by the world, the others averaged; the global norm is rebuilt from
the shards; the optimizer updates each rank's row views of the parameters
with its shard of the state (:func:`train.zero.zero_shard_state`), and the
updated rows are all-gathered.

With ``split_update`` (JAX's split program; inert under ZeRO at a world
above 1, where the one-pass step stays) a step runs the accumulation into a
persistent gradient buffer, reduces the sums once as above, retires the
accumulation by reading the loss, then runs the update through
``tx.fused_apply`` on the same sums: the same update as the one-pass step.
After the update the buffer is zeroed in place and reused by the next step.
Histograms are a pass of their own after the update, on histogram steps
only. ``manual_backward`` (split only) accumulates through the hand-written
backward of :mod:`whisper_finetune_torch.train.manual_grad`, which never
builds a whole-tree float32 gradient; ``manual_precast`` casts each block
stack to the compute dtype once a microbatch there.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from whisper_finetune_torch import parallel
from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import (
    ForwardConfig,
    ForwardDraws,
    Params,
    Whisper,
    _set,
    draw_forward,
    flatten,
    forward_impl,
)
from whisper_finetune_torch.optim.quantized import _div
from whisper_finetune_torch.runtime import span
from whisper_finetune_torch.train.zero import zero_opt_partition

IGNORE_INDEX = -100


class TrainState(NamedTuple):
    model: Whisper  # the parameters, updated in place by the step
    opt_state: Any  # the optimizer's own state; ``.count`` updates applied
    step: int


# ---------------------------------------------------------------------------
# Frozen vs trainable parameters
# ---------------------------------------------------------------------------

def build_trainable_mask(params: Params, t_config: Dict, lora_mask: Optional[Params] = None
                         ) -> Params:
    """The trainable mask (a tree of bools like ``params``): LoRA's mask
    (adapters only) or all True, then ``train_only_decoder`` freezes the
    encoder and ``train_only_encoder`` the decoder."""

    def fill(tree, value):
        return {k: fill(v, value) if isinstance(v, dict) else value for k, v in tree.items()}

    mask = lora_mask if lora_mask is not None else fill(params, True)
    if t_config["train_only_decoder"]:
        mask = {**mask, "encoder": fill(mask["encoder"], False)}
    if t_config["train_only_encoder"]:
        mask = {**mask, "decoder": fill(mask["decoder"], False)}
    return mask


def mark_trainable(params: Params, trainable_mask: Optional[Params]) -> None:
    """Sets ``requires_grad`` of every leaf from ``trainable_mask`` (a tree
    of bools like ``params``; None trains everything): the port's partition,
    which :func:`trainable_leaves` reads."""
    for path, leaf in flatten(params):
        train = True
        if trainable_mask is not None:
            train = trainable_mask
            for k in path:
                train = train[k]
        leaf.requires_grad_(bool(train))


def trainable_leaves(model: Whisper):
    """(path, leaf) of the trainable leaves in flatten order: what the
    optimizer's ``init`` and ``get_optimizer`` take."""
    return [(path, p) for path, p in model.leaves() if p.requires_grad]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

class _CrossEntropy(torch.autograd.Function):
    """Reduction-form smoothed CE: ``-logp[target] = lse - logit[target]``
    and ``mean(-logp) = lse - mean(logits)``, so the forward needs three row
    reductions and never builds the log-softmax. Saves the logits (already
    live) and the (B, T) log-sum-exp; the backward rebuilds the softmax in one
    pass and subtracts the target term with a scatter, so no (B, T, V)
    one-hot exists."""

    @staticmethod
    def forward(ctx, logits, targets, label_smoothing: float):
        mask = targets != IGNORE_INDEX
        safe = torch.where(mask, targets, 0).long()
        l32 = logits.float()
        m = l32.amax(dim=-1)
        lse = m + torch.log(torch.sum(torch.exp(l32 - m[..., None]), dim=-1))
        l_t = torch.gather(l32, -1, safe[..., None])[..., 0]
        nll = lse - l_t
        if label_smoothing > 0.0:
            smooth = lse - l32.mean(dim=-1)
            per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
        else:
            per_tok = nll
        per_tok = torch.where(mask, per_tok, 0.0)
        count = torch.clamp(mask.sum(), min=1).float()
        ctx.save_for_backward(logits, safe, mask, lse, count)
        ctx.label_smoothing = label_smoothing
        return per_tok.sum() / count

    @staticmethod
    def backward(ctx, g):
        with span("wft.loss"):
            logits, safe, mask, lse, count = ctx.saved_tensors
            ls = ctx.label_smoothing
            coeff = (g * mask.float() / count)[..., None]
            dl = torch.exp(logits.float() - lse[..., None])
            dl.sub_(ls / logits.shape[-1]).mul_(coeff)
            dl.scatter_add_(-1, safe[..., None], -(1.0 - ls) * coeff)
            return dl.to(logits.dtype), None, None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Label-smoothed cross entropy with ``-100`` ignore positions, mean over
    the kept tokens (``F.cross_entropy(..., label_smoothing=s,
    ignore_index=-100)`` semantics)."""
    return _CrossEntropy.apply(logits, targets, label_smoothing)


# ---------------------------------------------------------------------------
# Gradient histograms (the wandb.watch(log="all") telemetry)
# ---------------------------------------------------------------------------

_HIST_CHUNK = 1 << 24  # elements binned at a time: bounds the float32 and index temporaries


def _hist_groups(named_leaves) -> Dict[str, list]:
    """Leaves grouped by their top-two path keys ('encoder.blocks',
    'decoder.tok_emb', ...), in flatten order."""
    groups: Dict[str, list] = {}
    for path, leaf in named_leaves:
        groups.setdefault(".".join(path[:2]), []).append(leaf)
    return groups


def _leaf_histogram(leaf: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    bins: int) -> torch.Tensor:
    """Counts of ``leaf`` in ``bins`` equal bins over [lo, hi], in float32
    with JAX's index rule (``int32((x - lo) / span * bins)``, clipped)."""
    span = torch.clamp(hi - lo, min=1e-12)
    counts = torch.zeros((bins,), dtype=torch.int64, device=leaf.device)
    for chunk in leaf.detach().reshape(-1).split(_HIST_CHUNK):
        idx = ((chunk.float() - lo) / span * bins).to(torch.int32).clamp_(0, bins - 1)
        counts += torch.bincount(idx, minlength=bins)
    return counts


def grad_histograms(named_leaves, bins: int,
                    shard_flags: Optional[Sequence[bool]] = None) -> Dict[str, tuple]:
    """Per-module-group ``{name: (counts, lo, hi)}`` histograms of
    ``(path, tensor)`` pairs (gradients or parameters), computed on their
    device: one range per group (the min and max of its leaves, float32),
    counts summed over the group's leaves. ``shard_flags`` (one bool a leaf)
    marks leaves that are this rank's ZeRO row shard: their ranges take the
    min and max across ranks and their counts the sum, so the result is the
    histogram of the whole gradient on every rank (JAX's pmin / pmax /
    psum)."""
    named_leaves = list(named_leaves)
    flags = [False] * len(named_leaves) if shard_flags is None else list(shard_flags)
    out = {}
    for name, items in _hist_groups(
            [(path, (leaf, f)) for (path, leaf), f in zip(named_leaves, flags)]).items():
        los = [leaf.detach().min().float() for leaf, _ in items]
        his = [leaf.detach().max().float() for leaf, _ in items]
        sharded = [i for i, (_, f) in enumerate(items) if f]
        if sharded:
            lo_s = parallel.all_reduce(torch.stack([los[i] for i in sharded]), "min")
            hi_s = parallel.all_reduce(torch.stack([his[i] for i in sharded]), "max")
            for k, i in enumerate(sharded):
                los[i], his[i] = lo_s[k], hi_s[k]
        lo, hi = torch.stack(los).min(), torch.stack(his).max()
        counts = sum(_leaf_histogram(leaf, lo, hi, bins) for leaf, f in items if not f)
        if sharded:
            counts = counts + parallel.all_reduce(
                sum(_leaf_histogram(items[i][0], lo, hi, bins) for i in sharded))
        out[name] = (counts, lo, hi)
    return out


def _zeros_histograms(named_leaves, bins: int, device) -> Dict[str, tuple]:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {name: (torch.zeros((bins,), dtype=torch.int64, device=device), zero, zero)
            for name in _hist_groups(named_leaves)}


# ---------------------------------------------------------------------------
# Train step factory
# ---------------------------------------------------------------------------

def make_train_step(
    dims: ModelDimensions,
    fcfg: ForwardConfig,
    tx,
    label_smoothing: float = 0.0,
    feat_cfg=None,
    max_grad_norm: Optional[float] = None,
    accum_dtype: Optional[str] = None,
    grad_hist_every: Optional[int] = None,
    grad_hist_bins: int = 64,
    zero_shard: bool = False,
    split_update: bool = False,
    manual_backward: bool = False,
    manual_precast: bool = False,
    device="cuda",
) -> Callable[..., tuple]:
    """Build ``step(state, batch, generator=None, draws=None) -> (state, loss)``,
    or ``(state, loss, hists)`` with ``grad_hist_every``: :func:`grad_histograms`
    of the mean gradients on steps where ``(state.step + 1) %
    grad_hist_every == 0`` (computed on the gradient sums, whose counts are
    the same, with the ranges scaled by 1 / accum), zero counts and ranges
    otherwise.
    ``tx`` is any optimizer with ``init`` / ``fused_apply`` over the
    trainable leaves (:func:`trainable_leaves`; ``optim.get_optimizer``).

    Batch tensors are shaped ``(accum, B, ...)`` on ``device``: ``audio`` +
    ``crop_frames`` with ``feat_cfg`` (log-mel and SpecAugment run inside the
    step, their draws from ``generator``), else ``mel``; plus ``dec_input``
    and ``dec_output``. ``draws`` (one :class:`ForwardDraws` a microbatch)
    replaces the stochastic-depth and deep-SpecAugment draws that the step
    otherwise makes from ``generator``. The parameters and optimizer buffers
    update in place; the returned loss is a 0-dim float32 tensor (reading it
    syncs).

    In a process group (``parallel``) the batch is this rank's, the loss is
    the mean over ranks and the update is the same on every rank. With
    ``zero_shard`` at a world above 1, ``state.opt_state`` is this rank's
    shard (:func:`whisper_finetune_torch.train.zero.zero_shard_state`).

    With ``split_update`` (not under ZeRO at a world above 1) the returned
    step is the split step: same signature and results, histograms from the
    state's own ``step``, and ``step.last_timing = {"accum_s", "update_s"}``
    the wall times of its last call. ``manual_backward`` needs
    ``split_update``."""
    resolve_device(device)
    if manual_backward and not split_update:
        raise ValueError("manual_backward requires split_update=True")
    fcfg.check_supported(dims.n_audio_layer)
    if not hasattr(tx, "fused_apply"):
        raise TypeError(f"{type(tx).__name__} has no fused_apply(grads, state, params, g_scale)")
    acc_dt = getattr(torch, accum_dtype) if accum_dtype else None
    data_keys = (("audio", "crop_frames", "dec_input", "dec_output")
                 if feat_cfg is not None else ("mel", "dec_input", "dec_output"))

    def loss_fn(params, mb: Dict[str, torch.Tensor], generator, draws):
        if feat_cfg is not None:
            from whisper_finetune_torch.ops.spec_augment import featurize_impl

            with span("wft.features"):
                mel = featurize_impl(mb["audio"], mb["crop_frames"], generator,
                                     feat_cfg, train=True)
        else:
            mel = mb["mel"]
        logits = forward_impl(params, mel, mb["dec_input"], dims, fcfg, train=True,
                              draws=draws)
        with span("wft.loss"):
            return cross_entropy_loss(logits, mb["dec_output"], label_smoothing)

    manual_acc = None
    if manual_backward:
        from whisper_finetune_torch.train.manual_grad import make_manual_accumulator

        manual_acc = make_manual_accumulator(
            dims, fcfg, lambda logits, targets: cross_entropy_loss(logits, targets,
                                                                   label_smoothing),
            feat_cfg=feat_cfg, precast=manual_precast)

    def accumulate(params, leaves, batch, generator, draws, grad_buf=None):
        """Per-microbatch backward; gradient sums in the accumulator dtype
        (each microbatch's gradients are float32 before the cast), added
        into ``grad_buf`` (zeroed, in the leaves' order) where one is given."""
        accum = batch[data_keys[0]].shape[0]
        if draws is None:
            draws = (draw_forward(generator, dims, leaves[0].device, accum, lora=fcfg.lora_draws)
                     if fcfg.needs_draws else [None] * accum)
        elif len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")
        grad_sum = grad_buf
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum):
            loss = loss_fn(params, {k: batch[k][i] for k in data_keys}, generator, draws[i])
            # A leaf no kept layer used (stochastic depth dropped them all)
            # has no gradient: zeros, as in JAX.
            with span("wft.backward"):
                grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
            with span("wft.grad_reduce"):
                if grad_sum is not None:
                    for j, a in enumerate(grad_sum):
                        g, grads[j] = grads[j], None  # each float32 gradient freed once added
                        if g is not None:
                            a.add_(g.to(acc_dt) if acc_dt else g)
                else:
                    for j, g in enumerate(grads):
                        if g is None:
                            grads[j] = torch.zeros_like(leaves[j], dtype=acc_dt)
                        else:
                            grads[j] = g.to(acc_dt) if acc_dt else g  # frees the fp32 copy
                    grad_sum = grads
            del grads
            loss_sum = loss_sum + loss.detach()
        return grad_sum, accum, loss_sum / accum

    def reduce_sums(grad_sum, accum: int, n: int):
        """The cross-rank sum of the gradient sums, in place and in the
        accumulator dtype, and the float32 scalar that turns them into
        clipped means."""
        with span("wft.grad_reduce"):
            for g in grad_sum:
                parallel.all_reduce(g)
            dev = grad_sum[0].device
            scale = torch.tensor(1.0 / (accum * n), dtype=torch.float32, device=dev)
            if max_grad_norm is None:
                return scale
            sq = sum(torch.sum(torch.square(g.float())) for g in grad_sum)
            gnorm = torch.sqrt(sq) * scale
            return scale * clip_factor(gnorm)

    def clip_factor(gnorm):
        limit = torch.tensor(max_grad_norm, dtype=torch.float32, device=gnorm.device)
        return torch.clamp(limit / (gnorm + 1e-6), max=1.0)

    def reduce_to_shards(grad_sum, accum: int, n: int, flags):
        """ZeRO-1: each leaf's mean gradient, as this rank's row shard for
        the leaves that shard (reduce-scattered over rows, then / n) and
        whole for the others (summed, then / n), in the accumulator dtype
        and then float32 as JAX casts it; ``grad_sum`` is emptied as it
        goes, so the whole sums are freed leaf by leaf."""
        out = []
        with span("wft.grad_reduce"):
            for j, f in enumerate(flags):
                g, grad_sum[j] = grad_sum[j], None
                if accum > 1:
                    g = _div(g, accum)
                g = _div(parallel.reduce_scatter_rows(g) if f else parallel.all_reduce(g), n)
                out.append(g.float() if acc_dt else g)
        return out

    def want_hists(state) -> bool:
        return bool(grad_hist_every) and (state.step + 1) % grad_hist_every == 0

    def mean_histograms(named, grad_sum, denominator: int) -> Dict[str, tuple]:
        """Histograms of the mean gradients from the sums: the counts are the
        same, the ranges scaled as JAX scales them (float32 ranges times
        float32(1 / denominator))."""
        scale = 1.0 / denominator
        with span("wft.grad_reduce"):
            return {name: (c, lo * scale, hi * scale) for name, (c, lo, hi) in
                    grad_histograms([(path, g) for (path, _), g in zip(named, grad_sum)],
                                    grad_hist_bins).items()}

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Sequence[ForwardDraws]] = None):
        named = trainable_leaves(state.model)
        leaves = [p for _, p in named]
        grad_sum, accum, loss = accumulate(state.model.params(), leaves, batch, generator,
                                           draws)
        n = parallel.world()
        loss = _div(parallel.all_reduce(loss), n)
        hists = None
        if zero_shard and n > 1:
            flags = zero_opt_partition(tx, state.opt_state, leaves, n)
            grads = reduce_to_shards(grad_sum, accum, n, flags)
            with span("wft.grad_reduce"):
                if want_hists(state):
                    hists = grad_histograms([(path, g) for (path, _), g in zip(named, grads)],
                                            grad_hist_bins, flags)
                g_scale = None
                if max_grad_norm is not None:
                    # The global norm from the shards: shard squares summed
                    # over the ranks, whole leaves' squares counted once.
                    sq_shard = sq_whole = torch.zeros((), dtype=torch.float32,
                                                      device=leaves[0].device)
                    for g, f in zip(grads, flags):
                        sq = torch.sum(torch.square(g.float()))
                        if f:
                            sq_shard = sq_shard + sq
                        else:
                            sq_whole = sq_whole + sq
                    g_scale = clip_factor(torch.sqrt(parallel.all_reduce(sq_shard) + sq_whole))
            params = [parallel.shard_rows(p) if f else p for p, f in zip(leaves, flags)]
            with span("wft.update"):
                opt_state = tx.fused_apply(grads, state.opt_state, params, g_scale=g_scale)
                with torch.no_grad():
                    for p, shard, f in zip(leaves, params, flags):
                        if f:
                            parallel.all_gather_rows(shard, out=p)
        else:
            g_scale = reduce_sums(grad_sum, accum, n)
            if want_hists(state):
                hists = mean_histograms(named, grad_sum, accum * n)
            with span("wft.update"):
                opt_state = tx.fused_apply(grad_sum, state.opt_state, leaves, g_scale=g_scale)
        new_state = TrainState(state.model, opt_state, state.step + 1)
        if grad_hist_every:
            if hists is None:
                hists = _zeros_histograms(named, grad_hist_bins, leaves[0].device)
            return new_state, loss, hists
        return new_state, loss

    if not split_update or (zero_shard and parallel.world() > 1):
        return step

    class SplitStep:
        """The split step: ``step(state, batch, generator=None, draws=None)``
        as the one-pass step's. An object rather than a closure that names
        itself, so that its buffer goes with its last reference and not at
        the next garbage collection."""

        def __init__(self):
            self._grad_buf = None  # allocated once, zeroed in place after every update
            self._zero_hists = None
            self.last_timing = None

        def accumulate(self, state: TrainState, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Sequence[ForwardDraws]] = None):
            """The accumulation alone: (the gradient sums in the step's
            buffer, in the trainable leaves' order; the mean loss). The
            buffer is the caller's from here on."""
            named = trainable_leaves(state.model)
            buf, self._grad_buf = self._grad_buf, None
            if buf is None:
                buf = [torch.zeros(p.shape, dtype=acc_dt or p.dtype, device=p.device)
                       for _, p in named]
            accum = batch[data_keys[0]].shape[0]
            if manual_acc is None:
                leaves = [p for _, p in named]
                return buf, accumulate(state.model.params(), leaves, batch, generator, draws,
                                       buf)[2]
            tree: Params = {}
            for (path, _), b in zip(named, buf):
                _set(tree, path, b)
            _, loss_sum = manual_acc(state.model.params(), batch, generator, tree, draws)
            return buf, loss_sum / accum

        def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[ForwardDraws]] = None):
            t0 = time.perf_counter()
            named = trainable_leaves(state.model)
            leaves = [p for _, p in named]
            dev = leaves[0].device
            buf, loss = self.accumulate(state, batch, generator, draws)
            accum = batch[data_keys[0]].shape[0]
            n = parallel.world()
            loss = _div(parallel.all_reduce(loss), n)
            g_scale = reduce_sums(buf, accum, n)
            with span("wft.sync"):
                loss.item()  # retires the accumulation before the update starts
            t1 = time.perf_counter()
            with span("wft.update"):
                opt_state = tx.fused_apply(buf, state.opt_state, leaves, g_scale=g_scale)
            if dev.type == "cuda":
                with span("wft.sync"):
                    torch.cuda.synchronize(dev)  # retires the update
            t2 = time.perf_counter()
            new_state = TrainState(state.model, opt_state, state.step + 1)
            hists = None
            if grad_hist_every:
                if want_hists(state):
                    hists = mean_histograms(named, buf, accum * n)
                else:
                    if self._zero_hists is None:
                        self._zero_hists = _zeros_histograms(named, grad_hist_bins, dev)
                    hists = self._zero_hists
            with span("wft.grad_reduce"):
                for b in buf:
                    b.zero_()
            self._grad_buf = buf
            self.last_timing = {"accum_s": t1 - t0, "update_s": t2 - t1}
            if grad_hist_every:
                return new_state, loss, hists
            return new_state, loss

    return SplitStep()
