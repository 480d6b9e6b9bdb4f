"""Rematerialisation of transformer blocks: `torch.utils.checkpoint` with
the JAX package's named policies.

Counterpart of `voicebox_tpu/models/transformer.py::_resolve_remat_policy`
and its `checkpoint_name` tags. A policy is None (full recompute: the
backward runs the block's forward again) or "+"-joined parts:

* "dots": save the output of every matmul (`mm`, `addmm`, `bmm`,
  `baddbmm`), recompute the elementwise work;
* "dots_no_batch": save only matmuls without batch dimensions (the linear
  layers, not the attention products of the plain attention);
* a tag of `REMAT_TAGS`: save the tensors tagged with that name.

A tag is `checkpoint_name(x, name)`: the identity, except inside a block
whose policy saves `name`, where it is the registered op
`voicebox_tpu_torch::checkpoint_name` (a copy), which the policy sees and
saves. "attn_out" + "attn_lse" together save the attention kernel's outputs:
inside such a block `flash_attention` runs K1 as the registered op
`voicebox_tpu_torch::flash_attention_fwd`, whose outputs the policy saves,
so the backward's recompute does not launch K1 again (full remat and "dots"
launch it twice a step, as the JAX package's Pallas kernel runs twice).

Random draws made inside a block (attention dropout's keep mask from an
explicit generator) are saved under every policy, so the recompute sees the
same mask.
"""

from __future__ import annotations

import contextvars
from functools import partial
from typing import Callable, FrozenSet, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

__all__ = ["REMAT_TAGS", "checkpoint_name", "parse_policy", "remat_call", "saves"]

# the tensors the JAX package tags with jax.ad_checkpoint.checkpoint_name
REMAT_TAGS = ("attn_probs", "qk_rotary", "norm_out", "gelu_out", "attn_out", "attn_lse")

_aten = torch.ops.aten
_DOTS = {
    "dots": frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                       _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}
_RANDOM = frozenset({_aten.rand.generator, _aten.rand.default})  # dropout's keep masks

# the tag names saved by the block that runs now (None outside remat)
_SAVED: contextvars.ContextVar[Optional[FrozenSet[str]]] = contextvars.ContextVar(
    "voicebox_remat_saved", default=None)


@torch.library.custom_op("voicebox_tpu_torch::checkpoint_name", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_tag.register_fake
def _(x, name):
    return torch.empty_like(x)


_tag.register_autograd(lambda ctx, grad: (grad, None))


def saves(name: str) -> bool:
    """True inside a rematerialised block whose policy saves `name`."""
    names = _SAVED.get()
    return names is not None and name in names


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag `x` as `name` for the policy (the identity unless it saves it)."""
    return _tag(x, name) if saves(name) else x


def parse_policy(policy: Optional[str]):
    """(matmul ops to save, tag names to save) of a policy string; unknown
    parts raise."""
    if policy is None:
        return frozenset(), frozenset()
    parts = policy.split("+")
    dots = [p for p in parts if p in _DOTS]
    names = [p for p in parts if p not in _DOTS]
    unknown = [n for n in names if n not in REMAT_TAGS]
    if unknown or not parts or "" in parts:
        raise ValueError(
            f"remat_policy {policy!r}: parts {unknown or parts} not in {sorted(_DOTS)} "
            f"or {REMAT_TAGS}"
        )
    return frozenset().union(*(_DOTS[d] for d in dots)), frozenset(names)


def _policy_fn(save_ops, ctx, op, *args, **kwargs):
    if op in save_ops or op in _RANDOM:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn: Callable, *args, policy: Optional[str] = None, draws: bool = False):
    """`fn(*args)` under non-reentrant `torch.utils.checkpoint` with the
    named policy. `draws`: `fn` draws random numbers from an explicit
    generator, which a full recompute must not draw again. Without a
    gradient to take, `fn` just runs."""
    if not torch.is_grad_enabled():
        return fn(*args)
    save_ops, names = parse_policy(policy)
    if names:
        save_ops = save_ops | {_tag_op()}
        if {"attn_out", "attn_lse"} <= names:
            save_ops = save_ops | {_k1_op()}

    def run(*a):
        token = _SAVED.set(names)
        try:
            return fn(*a)
        finally:
            _SAVED.reset(token)

    if not save_ops and not draws:
        return checkpoint(run, *args, use_reentrant=False)
    context = partial(create_selective_checkpoint_contexts, partial(_policy_fn, save_ops))
    return checkpoint(run, *args, use_reentrant=False, context_fn=context)


def _tag_op():
    return torch.ops.voicebox_tpu_torch.checkpoint_name.default


def _k1_op():
    from . import flash_attention  # noqa: F401  (registers the op)

    return torch.ops.voicebox_tpu_torch.flash_attention_fwd.default

