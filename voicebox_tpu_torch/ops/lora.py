"""LoRA adapters for cheap fine-tuning (voice and domain adaptation).

Counterpart of `voicebox_tpu/ops/lora.py`. A targeted matmul becomes
`y = W x + b + (alpha / r) (x A) B`, with A (in, r) drawn N(0, 1) / sqrt(r)
and B (r, out) zero, so training starts exactly at the base model and only
the adapters take gradients and optimizer state.

* `lora_init(module, rank, layer_names, generator)` finds the targets by
  place, as `ops/quant.py::quantized_layer_names` finds the w8a16 layers:
  in every block of a `Transformer` under the `transformer` scope (the JAX
  package's `_in_scope`), the attention's `to_qkv` and `to_out`, the
  feed-forward's projections (`ff.0` and `ff.3`, the JAX package's
  `proj_in` and `proj_out`) and the U-Net skip combiner where there is one.
  VoiceBox's own `proj_in`, `to_embed`, `to_pred`, the adaptive-norm
  projections and the time MLP are never targeted. It returns
  `{module name: {"lora_a": Parameter, "lora_b": Parameter}}`, fp32, on
  the module's device, drawn from `generator`.
* `merge_lora_params(module, lora)` attaches the adapters to their
  `Linear`s (a forward hook each; the adapters are not registered, so the
  module's state dict stays the base's) and freezes the module's own
  parameters, as the JAX loss closes over the base.
* `lora_dense(scale)`: inside the block every attached `Linear` adds
  `scale * ((x.float() @ A) @ B)`, cast to y's dtype, after its biased
  output; the adapter math runs in fp32 under bf16 compute, as the JAX
  interceptor does. Outside it the module computes the base. Under remat
  the backward recomputes the forward, so call `backward()` inside the
  block too.
* `fold_lora(module, lora, scale)` returns a plain copy with
  `W += scale * (A @ B)^T` (fp32, cast to W's dtype), sharing every other
  parameter. It composes with `quantize_voicebox(..., "w8a16")`,
  `cast_float_params` and `TTSEngine`. A `QuantLinear` is no `Linear`, so
  adapters never apply to a quantized copy: serve through `fold_lora`
  first, as the JAX package does.

    scale = lora_scale(alpha=16, rank=8)
    lora = lora_init(cfm.voicebox, rank=8, generator=g)
    merge_lora_params(cfm.voicebox, lora)
    opt = torch.optim.Adam(lora_parameters(lora), lr=1e-3)
    with lora_dense(scale):
        cfm.loss_fn(x1, generator=g).backward()
    opt.step()
    served = fold_lora(cfm.voicebox, lora, scale)

The JAX package matches layer names exactly (`key in names`), so it does
not adapt the unrolled `skip_combiner_{i}`; the port targets them by place.
VoiceBox builds no skips, so the two agree on every model that trains here.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
from torch import nn

from ..models.transformer import Transformer
from .masks import normal
from .quant import _BLOCK_PLACES, DEFAULT_QUANT_LAYERS, SCOPE, _share_parameters_copy

__all__ = [
    "DEFAULT_LORA_LAYERS",
    "fold_lora",
    "lora_dense",
    "lora_init",
    "lora_layer_names",
    "lora_parameters",
    "lora_scale",
    "merge_lora_params",
]

# the hot matmuls the quantized path targets, in the JAX package's names
DEFAULT_LORA_LAYERS = DEFAULT_QUANT_LAYERS

_SCALES: List[float] = []  # the scales of the open `lora_dense` blocks


def lora_layer_names(module: nn.Module,
                     layer_names: Sequence[str] = DEFAULT_LORA_LAYERS) -> List[str]:
    """Module names of the `Linear`s that `lora_init` adapts, by place in
    each block of every `Transformer` under the `transformer` scope."""
    unknown = set(layer_names) - set(_BLOCK_PLACES)
    if unknown:
        raise ValueError(f"unknown LoRA layers {sorted(unknown)} "
                         f"(the port places {sorted(_BLOCK_PLACES)})")
    names = []
    for name, m in module.named_modules():
        if not isinstance(m, Transformer) or not any(SCOPE in part for part in name.split(".")):
            continue
        for i, block in enumerate(m.layers):
            for layer in layer_names:
                place = _BLOCK_PLACES[layer]
                if block[int(place[0])] is not None:
                    names.append(f"{name}.layers.{i}.{place}")
    return names


def lora_init(module: nn.Module, rank: int = 8,
              layer_names: Sequence[str] = DEFAULT_LORA_LAYERS,
              generator: torch.Generator = None) -> Dict[str, Dict[str, nn.Parameter]]:
    """Adapters for every targeted `Linear`: `lora_a` (in, rank) drawn
    N(0, 1) * rank^-0.5 from `generator`, `lora_b` (rank, out) zero."""
    names = lora_layer_names(module, layer_names)
    if not names:
        raise ValueError("no Linear matched layer_names within the transformer scope")
    lora = {}
    for name in names:
        lin = module.get_submodule(name)
        dev = lin.weight.device
        a = normal((lin.in_features, rank), generator, dev) * rank ** -0.5
        b = torch.zeros(rank, lin.out_features, device=dev)
        lora[name] = {"lora_a": nn.Parameter(a), "lora_b": nn.Parameter(b)}
    return lora


def lora_parameters(lora: Dict[str, Dict[str, nn.Parameter]]) -> List[nn.Parameter]:
    """The adapters' tensors in a fixed order: the trainable set."""
    return [ab[k] for ab in lora.values() for k in ("lora_a", "lora_b")]


def lora_scale(alpha: float, rank: int) -> float:
    return alpha / rank


def _lora_delta(lin: nn.Linear, args, y: torch.Tensor):
    if not _SCALES:
        return None
    a, b = lin.__dict__["_lora"]
    (x,) = args
    delta = (x.to(a.dtype) @ a) @ b
    return y + (_SCALES[-1] * delta).to(y.dtype)


def merge_lora_params(module: nn.Module, lora: Dict[str, Dict[str, nn.Parameter]]) -> nn.Module:
    """Attach the adapters to their `Linear`s in `module` (in place) and
    freeze the module's own parameters; returns `module`."""
    module.requires_grad_(False)
    for name, ab in lora.items():
        lin = module.get_submodule(name)
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"{name} is a {type(lin).__name__}, not a Linear: adapters apply "
                            "to float matmuls only (fold them before quantizing)")
        lin.__dict__["_lora"] = (ab["lora_a"], ab["lora_b"])
        if "_lora_hook" not in lin.__dict__:
            lin.__dict__["_lora_hook"] = lin.register_forward_hook(_lora_delta)
    return module


@contextlib.contextmanager
def lora_dense(scale: float = 1.0):
    """Inside the block, every `Linear` with adapters attached adds
    `scale * (x A) B` to its output."""
    _SCALES.append(float(scale))
    try:
        yield
    finally:
        _SCALES.pop()


@torch.no_grad()
def fold_lora(module: nn.Module, lora: Dict[str, Dict[str, nn.Parameter]],
              scale: float = 1.0) -> nn.Module:
    """A copy of `module` whose adapted weights are `W + scale * (A @ B)^T`,
    summed in fp32 and cast to W's dtype, with no adapter attached; every
    other parameter and buffer is shared. Use the `scale` of `lora_dense`."""
    out = _share_parameters_copy(module)
    for name, ab in lora.items():
        lin = out.get_submodule(name)
        lin.__dict__.pop("_lora", None)
        handle = lin.__dict__.pop("_lora_hook", None)
        if handle is not None:
            lin._forward_hooks.pop(handle.id, None)
        w = lin.weight
        delta = scale * (ab["lora_a"].float() @ ab["lora_b"].float())
        lin.weight = nn.Parameter((w.float() + delta.t()).to(w.dtype),
                                  requires_grad=w.requires_grad)
    return out
