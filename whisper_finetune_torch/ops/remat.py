"""Rematerialisation policies and named sites: the port of ``_remat``
(``whisper_finetune_tpu/models/whisper.py:143-194``) and of JAX's
``checkpoint_name``.

``ForwardConfig.remat_policy`` grammar, as in JAX:

* ``full``: recompute everything inside a checkpointed block;
* ``dots``: keep the output of every matrix product without batch dimensions
  (``dots_with_no_batch_dims_saveable``): the (B, T, D)·(D, F) projections,
  not the batched products of attention;
* ``attn``: keep ``attn_probs`` and ``cross_attn_probs``;
* ``save:<names>``: keep exactly the listed sites;
* ``offload:<names>``: copy the listed sites to pinned host memory on the
  forward pass and back on the backward pass;
* ``+`` joins ``save:`` and ``offload:`` segments (a name in both is kept).

The model marks a site with :func:`named` around ONE dispatcher op whose
output is the site's tensor (an ``addmm`` / ``mm``, a layer norm or its
cast, the probabilities' cast). A checkpointed block runs under
``torch.utils.checkpoint`` (non-reentrant) with a ``context_fn`` whose two
contexts make a :class:`_Frame` current: in the forward pass a kept site's op
runs under a ``TorchDispatchMode`` that stores its output (or a host copy of
it); in the recompute the same mode hands the stored value back instead of
running the op. The mode sits below autograd, so the recompute builds the
same autograd node with the same saved inputs; only the op's work is
skipped, as in torch's selective checkpointing. Two differences from
``create_selective_checkpoint_contexts``: only kept sites pass through
Python dispatch (nothing else of the block does), and an offloaded site
stores a host copy, which torch's eager selective checkpointing does not do
(it recomputes every output it does not keep on the device).

What the eager recompute skips is the kept op itself: ops before it still
run where the backward needs their saved tensors. The attention kernels are
ctypes launches that write into ``torch.empty`` buffers, so no site holds
them and their forward is recomputed under every policy, as in JAX, where the
kernel call is no ``dot``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, FrozenSet, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

SAVE, OFFLOAD = "save", "offload"


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """A parsed ``remat_policy``: what a checkpointed block keeps."""

    dots: bool = False
    saved: FrozenSet[str] = frozenset()
    offloaded: FrozenSet[str] = frozenset()

    @property
    def is_full(self) -> bool:
        return not (self.dots or self.saved or self.offloaded)

    def action(self, name: Optional[str], dot: bool) -> Optional[str]:
        """SAVE, OFFLOAD or None (recompute) for a site."""
        if (self.dots and dot) or name in self.saved:
            return SAVE
        if name in self.offloaded:
            return OFFLOAD
        return None

    def contexts(self) -> Tuple["_Pass", "_Pass"]:
        """``context_fn`` of ``torch.utils.checkpoint``: one frame a call."""
        frame = _Frame(self)
        return _Pass(frame, recompute=False), _Pass(frame, recompute=True)


@functools.lru_cache(maxsize=None)
def parse_remat_policy(policy: str) -> RematPolicy:
    """The policy string as a :class:`RematPolicy`; ``ValueError`` with the
    JAX package's messages for a bad segment, no names, or an unknown
    policy."""
    if policy == "full":
        return RematPolicy()
    if policy == "dots":
        return RematPolicy(dots=True)
    if policy == "attn":
        return RematPolicy(saved=frozenset(("attn_probs", "cross_attn_probs")))
    if policy.startswith(("save:", "offload:")):
        saved, offloaded = [], []
        for seg in policy.split("+"):
            if seg.startswith("save:"):
                dst, body = saved, seg[len("save:"):]
            elif seg.startswith("offload:"):
                dst, body = offloaded, seg[len("offload:"):]
            else:
                raise ValueError(
                    f"remat_policy segment {seg!r}: expected 'save:...' or 'offload:...'")
            dst.extend(n.strip() for n in body.split(",") if n.strip())
        if not saved and not offloaded:
            raise ValueError("remat_policy 'save:'/'offload:' needs at least one name")
        return RematPolicy(saved=frozenset(saved), offloaded=frozenset(offloaded))
    raise ValueError(f"Unknown remat_policy: {policy}")


class _Frame:
    """One checkpointed call: what its forward kept, by the order in which
    kept sites are reached (the recompute reaches them in the same order)."""

    def __init__(self, policy: RematPolicy):
        self.policy = policy
        self.stored: Dict[Tuple[int, int], object] = {}
        self.sites = 0
        self.recompute = False


_LOCAL = threading.local()  # .frames: the current frames of this thread


def _frames() -> list:
    frames = getattr(_LOCAL, "frames", None)
    if frames is None:
        frames = _LOCAL.frames = []
    return frames


class _Pass:
    """The forward or the recompute context of one checkpointed call. The
    recompute drops whatever it did not take back (the recompute stops after
    the last tensor the backward needs)."""

    def __init__(self, frame: _Frame, recompute: bool):
        self.frame, self.recompute = frame, recompute

    def __enter__(self):
        self.frame.recompute, self.frame.sites = self.recompute, 0
        _frames().append(self.frame)
        return self

    def __exit__(self, *exc):
        _frames().pop()
        if self.recompute:
            self.frame.stored.clear()
        return False


def named(name: Optional[str], fn: Callable, *args, dot: bool = False):
    """``fn(*args)`` as the remat site ``name`` (``dot``: a matrix product
    without batch dimensions, which ``dots`` keeps). ``fn`` must run one
    dispatcher op (views aside) whose output is the site's tensor. Outside a
    checkpointed block, or where the policy recomputes the site, it is a
    plain call."""
    frames = getattr(_LOCAL, "frames", None)
    if not frames:
        return fn(*args)
    frame = frames[-1]
    how = frame.policy.action(name, dot)
    if how is None:
        return fn(*args)
    site = frame.sites
    frame.sites += 1
    with _SiteMode(frame, site, how):
        return fn(*args)


# Ops that checkpointing itself issues (a different number of detaches in
# the forward and the recompute; device queries of its determinism check):
# run, never stored.
_PASS_THROUGH = frozenset((torch.ops.aten.detach.default, torch.ops.prim.device.default))


class _SiteMode(TorchDispatchMode):
    def __init__(self, frame: _Frame, site: int, how: str):
        super().__init__()
        self.frame, self.site, self.how, self.ops = frame, site, how, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PASS_THROUGH:
            return func(*args, **kwargs)
        key = (self.site, self.ops)
        self.ops += 1
        if self.frame.recompute:
            stored = self.frame.stored.pop(key, None)
            if stored is None:
                raise RuntimeError(f"remat site {key}: {func} in the recompute was not "
                                   "stored by the forward")
            return tree_map(_unstage, stored) if self.how == OFFLOAD else stored
        out = func(*args, **kwargs)
        keep = offload_to_host if self.how == OFFLOAD else _detach
        self.frame.stored[key] = tree_map(keep, out)
        return out


def _detach(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


class _Staged:
    """A host copy of a site's tensor; ``done`` is the event that ends a
    copy from the card (None for a CPU tensor)."""

    __slots__ = ("host", "done", "device")

    def __init__(self, host, done, device):
        self.host, self.done, self.device = host, done, device


def offload_to_host(x):
    """A :class:`_Staged` host copy of ``x``. A CUDA tensor goes to pinned
    memory on a side stream, ordered after the work that made it; its device
    memory is not reused until the copy is done. A CPU tensor (the CPU tests)
    is copied. Adds the bytes to ``offload_to_host.bytes``."""
    if not isinstance(x, torch.Tensor):
        return x
    offload_to_host.bytes += x.numel() * x.element_size()
    if not x.is_cuda:
        return _Staged(x.detach().clone(), None, x.device)
    side = _SIDE_STREAMS.get(x.device)
    if side is None:
        side = _SIDE_STREAMS[x.device] = torch.cuda.Stream(x.device)
    host = torch.empty_like(x, device="cpu", pin_memory=True)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    x.record_stream(side)
    return _Staged(host, done, x.device)


offload_to_host.bytes = 0


def _unstage(entry):
    """The device copy of an offloaded tensor, made on the current stream
    once its host copy is done."""
    if not isinstance(entry, _Staged):
        return entry
    if entry.done is None:
        return entry.host
    torch.cuda.current_stream(entry.device).wait_event(entry.done)
    return entry.host.to(entry.device, non_blocking=True)
