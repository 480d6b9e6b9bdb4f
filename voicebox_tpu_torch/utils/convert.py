"""JAX parameter trees -> the port's state dicts.

Takes the JAX package's parameters as nested dicts of numpy arrays (convert
a flax tree with `jax.tree.map(np.asarray, params)` first) and returns
`{key: torch.Tensor}` dicts that the port's modules load with
`load_state_dict(strict=True)`. Uses numpy and torch only.

* `voicebox_state_dict`: the reference layout, the same mapping as
  `voicebox_tpu/utils/port_weights.py::export_voicebox_torch`;
* `transformer_state_dict`, `attention_state_dict`: its parts;
* `duration_predictor_state_dict`: the same mapping as
  `export_duration_predictor_torch` (the net, without the aligner);
* `vocos_state_dict`: the upstream Vocos layout;
* `encodec_voco_state_dict`: RVQ codebooks + Vocos, for `EncodecVoco`.

The mappings are linear in the leaves (transposes and reshapes), so JAX
gradients, optimizer updates and trained parameters go through
`voicebox_state_dict` as the weights do and compare key by key with the
port's `.grad` and parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = [
    "attention_state_dict",
    "duration_predictor_state_dict",
    "transformer_state_dict",
    "voicebox_state_dict",
    "vocos_state_dict",
    "encodec_voco_state_dict",
]

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _dense(out: StateDict, key: str, leaf: Mapping, bias: bool = True) -> None:
    # flax Dense kernel (in, out) -> torch Linear weight (out, in)
    out[f"{key}.weight"] = _t(np.asarray(leaf["kernel"]).T)
    if bias and "bias" in leaf:
        out[f"{key}.bias"] = _t(leaf["bias"])


def _conv(out: StateDict, key: str, leaf: Mapping) -> None:
    # flax Conv kernel (k, in / groups, out) -> torch Conv1d weight (out, in / groups, k)
    out[f"{key}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"]), (2, 1, 0)))
    if "bias" in leaf:
        out[f"{key}.bias"] = _t(leaf["bias"])


def _layer_norm(out: StateDict, key: str, leaf: Mapping) -> None:
    if "shift" in leaf:  # AdaLayerNorm: per-bandwidth embedding tables
        out[f"{key}.scale.weight"] = _t(leaf["scale"])
        out[f"{key}.shift.weight"] = _t(leaf["shift"])
    else:
        out[f"{key}.weight"] = _t(leaf["scale"])
        out[f"{key}.bias"] = _t(leaf["bias"])


def rotary_inv_freq(dim_head: int, theta: float = 50000.0) -> np.ndarray:
    """The rotary `inv_freq` buffer, 1 / theta^(2i/d), as the exporter makes it."""
    return (
        1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float32) / dim_head))
    ).astype(np.float32)


def attention_state_dict(tree: Mapping, prefix: str = "") -> StateDict:
    """JAX `Attention` params -> the port's `Attention` keys."""
    out: StateDict = {}
    if "q_norm" in tree:
        out[f"{prefix}q_norm.gamma"] = _t(tree["q_norm"]["gamma"])
        out[f"{prefix}k_norm.gamma"] = _t(tree["k_norm"]["gamma"])
    _dense(out, f"{prefix}to_qkv", tree["to_qkv"], bias=False)
    _dense(out, f"{prefix}to_out", tree["to_out"], bias=False)
    return out


def transformer_state_dict(tree: Mapping, prefix: str = "",
                           dim_head: Optional[int] = None,
                           theta: float = 50000.0) -> StateDict:
    """JAX `Transformer` params (unrolled layout) -> reference keys.
    `dim_head` is read from a qk-norm gamma when there is one."""
    out: StateDict = {}

    def prenorm(key, leaf):
        if "gamma" in leaf:  # plain RMSNorm
            out[f"{key}.gamma"] = _t(leaf["gamma"])
        else:  # AdaptiveRMSNorm
            _dense(out, f"{key}.to_gamma", leaf["to_gamma"])
            _dense(out, f"{key}.to_beta", leaf["to_beta"])

    if "register_tokens" in tree:
        out[f"{prefix}register_tokens"] = _t(tree["register_tokens"])
    depth = sum(1 for k in tree if k.startswith("block_"))
    assert depth > 0, f"no block_i subtrees in transformer tree ({sorted(tree)})"
    for i in range(depth):
        lp = f"{prefix}layers.{i}"
        if f"skip_combiner_{i}" in tree:
            _dense(out, f"{lp}.0", tree[f"skip_combiner_{i}"])
        block = tree[f"block_{i}"]
        assert "gateloop" not in block, "gateloop layers are not ported yet"
        prenorm(f"{lp}.2", block["attn_prenorm"])
        if "q_norm" in block["attn"] and dim_head is None:
            dim_head = int(np.asarray(block["attn"]["q_norm"]["gamma"]).shape[-1])
        out.update(attention_state_dict(block["attn"], prefix=f"{lp}.3."))
        prenorm(f"{lp}.4", block["ff_prenorm"])
        _dense(out, f"{lp}.5.0", block["ff"]["proj_in"])
        _dense(out, f"{lp}.5.3", block["ff"]["proj_out"])
    assert dim_head is not None, "pass dim_head= (no qk-norm gamma to read it from)"
    out[f"{prefix}rotary_emb.inv_freq"] = _t(rotary_inv_freq(int(dim_head), theta))
    out[f"{prefix}final_norm.gamma"] = _t(tree["final_norm"]["gamma"])
    return out


def voicebox_state_dict(params: Mapping, dim_head: Optional[int] = None) -> StateDict:
    """JAX `VoiceBox` params -> the reference `VoiceBox.state_dict()` layout
    (`null_cond` is synthesised: the null condition is a constant zero)."""
    out: StateDict = {}
    in_features = np.asarray(params["to_embed"]["kernel"]).shape[0]
    dim_cond_emb = (
        np.asarray(params["to_cond_emb"]["embedding"]).shape[1]
        if "to_cond_emb" in params else 0
    )
    out["null_cond"] = torch.zeros((in_features - dim_cond_emb) // 2)
    if "proj_in" in params:
        _dense(out, "proj_in", params["proj_in"])
    out["sinu_pos_emb.0.weights"] = _t(params["sinu_pos_emb"]["weights"])
    _dense(out, "sinu_pos_emb.1", params["time_mlp"])
    if "to_cond_emb" in params:
        out["to_cond_emb.weight"] = _t(params["to_cond_emb"]["embedding"])
    _dense(out, "to_embed", params["to_embed"])
    _conv(out, "conv_embed.dw_conv1d.0", params["conv_embed"]["dw_conv1d"])
    out.update(transformer_state_dict(params["transformer"], prefix="transformer.",
                                      dim_head=dim_head))
    _dense(out, "to_pred", params["to_pred"], bias=False)
    return out


def duration_predictor_state_dict(params: Mapping, dim_head: Optional[int] = None) -> StateDict:
    """JAX `DurationPredictorNet` params -> the reference `DurationPredictor`
    layout, the same mapping as `export_duration_predictor_torch`: the
    aligner (training only) is left out, `null_cond` is synthesised zeros,
    and the head is `to_pred.0`."""
    out: StateDict = {}
    dim = np.asarray(params["to_embed"]["kernel"]).shape[1]
    out["null_cond"] = torch.zeros(dim)
    if "proj_in" in params:
        _dense(out, "proj_in", params["proj_in"])
    out["to_phoneme_emb.weight"] = _t(params["to_phoneme_emb"]["embedding"])
    _dense(out, "to_embed", params["to_embed"])
    _conv(out, "conv_embed.dw_conv1d.0", params["conv_embed"]["dw_conv1d"])
    out.update(transformer_state_dict(params["transformer"], prefix="transformer.",
                                      dim_head=dim_head))
    _dense(out, "to_pred.0", params["to_pred"])
    return out


def vocos_state_dict(params: Mapping) -> StateDict:
    """JAX `Vocos.params` ({'backbone', 'head'[, 'codebook']}) -> upstream
    Vocos keys."""
    out: StateDict = {}
    bb = params["backbone"]
    _conv(out, "backbone.embed", bb["embed"])
    _layer_norm(out, "backbone.norm", bb["norm_in"])
    i = 0
    while f"block_{i}" in bb:
        blk, key = bb[f"block_{i}"], f"backbone.convnext.{i}"
        _conv(out, f"{key}.dwconv", blk["dwconv"])
        _layer_norm(out, f"{key}.norm", blk["norm"])
        _dense(out, f"{key}.pwconv1", blk["pwconv1"])
        _dense(out, f"{key}.pwconv2", blk["pwconv2"])
        out[f"{key}.gamma"] = _t(blk["gamma"])
        i += 1
    _layer_norm(out, "backbone.final_layer_norm", bb["final_norm"])
    _dense(out, "head.out", params["head"]["out"])
    if "codebook" in params:
        q, size, c = np.asarray(params["codebook"]).shape
        out["feature_extractor.codebook_weights"] = _t(
            np.asarray(params["codebook"]).reshape(q * size, c)
        )
    return out


def encodec_voco_state_dict(quantizer_params: Mapping, vocos_params: Mapping) -> StateDict:
    """JAX `EncodecModel.params['quantizer']` and `Vocos.params` -> the
    port's `EncodecVoco` keys."""
    out: StateDict = {"quantizer.codebooks": _t(quantizer_params["codebooks"])}
    out.update({f"vocos.{k}": v for k, v in vocos_state_dict(vocos_params).items()})
    return out
