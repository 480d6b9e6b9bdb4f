"""JAX parameter trees -> the port's state dicts.

Takes the JAX package's parameters as nested dicts of numpy arrays (convert
a flax tree with `jax.tree.map(np.asarray, params)` first) and returns
`{key: torch.Tensor}` dicts that the port's modules load with
`load_state_dict(strict=True)`. Uses numpy and torch only.

* `voicebox_state_dict`: the reference layout, the same mapping as
  `voicebox_tpu/utils/port_weights.py::export_voicebox_torch`;
* `transformer_state_dict`, `attention_state_dict`: its parts. The
  transformer comes in either JAX layout: unrolled (`block_{i}`,
  `skip_combiner_{i}`) or `scan_layers=True` (`layers_front` /
  `layers_back`, each leaf stacked on a leading depth / 2 axis: front row j
  is layer j, back row j layer depth / 2 + j with its `skip_combiner`).
  The port has one layout, `layers.{i}`: the stacks bound XLA's compile
  time, a cost eager PyTorch does not have;
* `duration_predictor_state_dict`: the same mapping as
  `export_duration_predictor_torch` (the net, without the aligner);
* `aligner_state_dict`: the duration predictor's training-only aligner,
  under the JAX parameter names (`key_conv1`, ..., `query_conv3`);
* `hubert_state_dict`: `HubertWithKmeans` params -> `transformers`'
  `HubertModel` keys (the positional conv as the weight-norm
  parametrization's g and v), plus the k-means centres as
  `cluster_centers`; `load_hubert_state_dict` loads an upstream state dict
  (`transformers` with either weight-norm spelling, fairseq, under an
  optional `hubert.` / `wav2vec2.` prefix) into the port's
  `HubertWithKmeans`, the counterpart of `load_hubert_torch`;
* `text_to_semantic_state_dict`: `TextToSemantic` params -> the port's
  keys (`net.` + the encoder's reference keys and the decoder's JAX
  names);
* `lora_from_jax`: a JAX `lora_init` tree (`lora_a` (in, r), `lora_b`
  (r, out) under each adapted Dense's flax path) -> the port's adapters,
  keyed by module name (`ops/lora.py`); A and B keep their layout;
* `vocos_state_dict`: the upstream Vocos layout;
* `seanet_encoder_state_dict`, `seanet_decoder_state_dict`,
  `encodec_model_state_dict`: upstream facebook/encodec's layout, the
  inverse of `voicebox_tpu/utils/port_weights.py::load_encodec_torch`
  (flax `Conv` kernels are (k, in, out), `ConvTranspose` kernels (k, in,
  out) spatially flipped; each flax `OptimizedLSTMCell` keeps per-gate
  `i{g}` (no bias) and `h{g}` (bias) Denses, packed here into torch's
  [i, f, g, o] rows with the bias in `bias_hh` and a zero `bias_ih`);
* `encodec_voco_state_dict`: SEANet encoder + RVQ codebooks + Vocos, for
  `EncodecVoco`;
* `optimizer_state_by_name`, `export_optimizer_state`,
  `save_reference_checkpoint`: the torch halves of `load_optimizer_torch`,
  `export_optimizer_torch` and `save_reference_checkpoint` of the JAX
  package's `utils/port_weights.py`. The reference trainer's checkpoint is
  `torch.save({'model', 'optim', 'scheduler'})` (reference trainer.py:
  191-197), its optimizer state keyed by parameter index. The indices follow
  the reference's `get_optimizer` (reference optimizer.py:3-35) over the
  wrapper's `parameters()`: with wd > 0 the ndim >= 2 tensors, then the
  rest; buffers (`rotary_emb.inv_freq`, `bandwidth_id`) take no index, the
  frozen `null_cond` takes one and holds no state. So the map comes from the
  checkpoint's model keys in state-dict order, never from a module's
  `named_parameters()`.

The mappings are linear in the leaves (transposes and reshapes), so JAX
gradients, optimizer updates and trained parameters go through
`voicebox_state_dict` as the weights do and compare key by key with the
port's `.grad` and parameters.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TORCH_BUFFER_SUFFIXES",
    "aligner_state_dict",
    "encodec_model_state_dict",
    "seanet_decoder_state_dict",
    "seanet_encoder_state_dict",
    "TORCH_STATELESS_SUFFIXES",
    "attention_state_dict",
    "denoiser_state",
    "export_optimizer_state",
    "optimizer_param_groups",
    "optimizer_state_by_name",
    "save_reference_checkpoint",
    "duration_predictor_state_dict",
    "transformer_state_dict",
    "unrolled_layout",
    "voicebox_state_dict",
    "vocos_state_dict",
    "encodec_voco_state_dict",
    "hubert_state_dict",
    "load_hubert_state_dict",
    "text_to_semantic_state_dict",
    "lora_from_jax",
]

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


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


def unrolled_layout(tree: Mapping) -> Mapping:
    """A JAX `Transformer` tree in the `scan_layers=True` layout as the
    unrolled one: front row j -> `block_{j}`, back row j -> `block_{half +
    j}` and `skip_combiner_{half + j}`, the same math as the unrolled loop
    (the back stack pops the front's skips in reverse). Other trees are
    returned as they are."""
    if "layers_front" not in tree:
        return tree
    front, back = tree["layers_front"], tree["layers_back"]

    def row(sub, j):
        return {k: row(v, j) if isinstance(v, Mapping) else np.asarray(v)[j]
                for k, v in sub.items()}

    def leaf(sub):
        return leaf(next(iter(sub.values()))) if isinstance(sub, Mapping) else sub

    half = np.asarray(leaf(front)).shape[0]
    out = {k: v for k, v in tree.items() if k not in ("layers_front", "layers_back")}
    for j in range(half):
        out[f"block_{j}"] = row(front["block"], j)
        out[f"block_{half + j}"] = row(back["block"], j)
        if "skip_combiner" in back:
            out[f"skip_combiner_{half + j}"] = row(back["skip_combiner"], j)
    return out


def transformer_state_dict(tree: Mapping, prefix: str = "",
                           dim_head: Optional[int] = None,
                           theta: float = 50000.0) -> StateDict:
    """JAX `Transformer` params (unrolled or scan layout) -> reference keys.
    `dim_head` is read from a qk-norm gamma when there is one; `theta` is
    the module's `rotary_theta`."""
    tree = unrolled_layout(tree)
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
        if "gateloop" in block:
            gl = block["gateloop"]
            out[f"{lp}.1.norm.gamma"] = _t(gl["norm"]["gamma"])
            _dense(out, f"{lp}.1.to_qkva", gl["to_qkva"], bias=False)
            _layer_norm(out, f"{lp}.1.post_norm", gl["post_norm"])
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


def _lstm(out: StateDict, key: str, tree: Mapping) -> None:
    """flax `OptimizedLSTMCell_{l}` per-gate Denses -> `nn.LSTM` layer l."""
    gates = "ifgo"  # torch's row order
    layer = 0
    while f"OptimizedLSTMCell_{layer}" in tree:
        cell = tree[f"OptimizedLSTMCell_{layer}"]
        out[f"{key}.weight_ih_l{layer}"] = _t(np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates]))
        out[f"{key}.weight_hh_l{layer}"] = _t(np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates]))
        bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
        out[f"{key}.bias_ih_l{layer}"] = _t(np.zeros_like(bias))
        out[f"{key}.bias_hh_l{layer}"] = _t(bias)
        layer += 1


def _causal_conv(out: StateDict, key: str, leaf: Mapping) -> None:
    _conv(out, f"{key}.conv.conv", leaf["conv"])


def _residual_unit(out: StateDict, key: str, tree: Mapping) -> None:
    _causal_conv(out, f"{key}.block.1", tree["conv1"])
    _causal_conv(out, f"{key}.block.3", tree["conv2"])


def _n_blocks(tree: Mapping) -> int:
    n = 0
    while f"res_{n}" in tree:
        n += 1
    return n


def seanet_encoder_state_dict(tree: Mapping, prefix: str = "") -> StateDict:
    """JAX `SEANetEncoder` params -> upstream `encoder.model.{i}` keys (under
    `prefix`): 0 stem; per block i, 3i + 1 residual unit and 3i + 3 strided
    conv; 3n + 1 the LSTM; 3n + 3 the head."""
    out: StateDict = {}
    n = _n_blocks(tree)
    _causal_conv(out, f"{prefix}model.0", tree["stem"])
    for i in range(n):
        _residual_unit(out, f"{prefix}model.{3 * i + 1}", tree[f"res_{i}"])
        _causal_conv(out, f"{prefix}model.{3 * i + 3}", tree[f"down_{i}"])
    _lstm(out, f"{prefix}model.{3 * n + 1}.lstm", tree["lstm"])
    _causal_conv(out, f"{prefix}model.{3 * n + 3}", tree["head"])
    return out


def seanet_decoder_state_dict(tree: Mapping, prefix: str = "") -> StateDict:
    """JAX `SEANetDecoder` params -> upstream `decoder.model.{i}` keys: 0
    stem, 1 the LSTM; per block i, 3i + 3 transposed conv and 3i + 4
    residual unit; 3n + 3 the head."""
    out: StateDict = {}
    n = _n_blocks(tree)
    _causal_conv(out, f"{prefix}model.0", tree["stem"])
    _lstm(out, f"{prefix}model.1.lstm", tree["lstm"])
    for i in range(n):
        leaf = tree[f"up_{i}"]["convtr"]
        key = f"{prefix}model.{3 * i + 3}.convtr.convtr"
        # flax ConvTranspose (k, in, out), spatially flipped -> torch (in, out, k)
        out[f"{key}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"])[::-1], (1, 2, 0)))
        out[f"{key}.bias"] = _t(leaf["bias"])
        _residual_unit(out, f"{prefix}model.{3 * i + 4}", tree[f"res_{i}"])
    _causal_conv(out, f"{prefix}model.{3 * n + 3}", tree["head"])
    return out


def encodec_model_state_dict(params: Mapping) -> StateDict:
    """JAX `EncodecModel.params` ({'encoder', 'decoder', 'quantizer'}) -> the
    port's `EncodecModel` keys."""
    out = seanet_encoder_state_dict(params["encoder"], "encoder.")
    out.update(seanet_decoder_state_dict(params["decoder"], "decoder."))
    out["quantizer.codebooks"] = _t(params["quantizer"]["codebooks"])
    return out


def encodec_voco_state_dict(quantizer_params: Mapping, vocos_params: Mapping,
                            encoder_params: Optional[Mapping] = None) -> StateDict:
    """JAX `EncodecModel.params['quantizer']` and `Vocos.params`, and the
    SEANet encoder's `EncodecModel.params['encoder']` when given -> the
    port's `EncodecVoco` keys."""
    out: StateDict = {"quantizer.codebooks": _t(quantizer_params["codebooks"])}
    out.update({f"vocos.{k}": v for k, v in vocos_state_dict(vocos_params).items()})
    if encoder_params is not None:
        out.update(seanet_encoder_state_dict(encoder_params, "encoder."))
    return out


def aligner_state_dict(tree: Mapping) -> StateDict:
    """JAX `Aligner` params (`params['aligner']` of the duration predictor's
    net) -> the port's `Aligner` keys, which keep the JAX names."""
    out: StateDict = {}
    for name in ("key_conv1", "key_conv2", "query_conv1", "query_conv2", "query_conv3"):
        _conv(out, name, tree[name])
    return out


def hubert_state_dict(params: Mapping) -> StateDict:
    """JAX `HubertWithKmeans.params` -> `transformers` `HubertModel` keys and
    `cluster_centers`. The positional conv's fused kernel becomes
    `parametrizations.weight.original0` (g = ||w|| over the output and input
    axes, one per tap) and `original1` (v = w), so g v / ||v|| gives w back."""
    out: StateDict = {}
    fe = params["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        _conv(out, f"feature_extractor.conv_layers.{i}.conv", fe[f"conv_{i}"])
        if f"layer_norm_{i}" in fe:
            _layer_norm(out, f"feature_extractor.conv_layers.{i}.layer_norm",
                        fe[f"layer_norm_{i}"])
        i += 1
    if "group_norm" in fe:
        _layer_norm(out, "feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    if "proj_norm" in params:
        _layer_norm(out, "feature_projection.layer_norm", params["proj_norm"])
    _dense(out, "feature_projection.projection", params["proj"])
    enc = params["encoder"]
    w = np.transpose(np.asarray(enc["pos_conv"]["kernel"], np.float32), (2, 1, 0))
    pos = "encoder.pos_conv_embed.conv"
    out[f"{pos}.parametrizations.weight.original0"] = _t(
        np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)))
    out[f"{pos}.parametrizations.weight.original1"] = _t(w)
    out[f"{pos}.bias"] = _t(enc["pos_conv"]["bias"])
    if "pre_norm" in enc:
        _layer_norm(out, "encoder.layer_norm", enc["pre_norm"])
    i = 0
    while f"layer_{i}" in enc:
        blk, lp = enc[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{lp}.attention.{name}", blk[name])
        _layer_norm(out, f"{lp}.layer_norm", blk["attn_norm"])
        _dense(out, f"{lp}.feed_forward.intermediate_dense", blk["fc1"])
        _dense(out, f"{lp}.feed_forward.output_dense", blk["fc2"])
        _layer_norm(out, f"{lp}.final_layer_norm", blk["final_norm"])
        i += 1
    if "kmeans" in params:
        out["cluster_centers"] = _t(params["kmeans"])
    return out


# fairseq and older transformers names -> the port's (transformers') names
_HUBERT_RENAMES = (
    (r"^feature_extractor\.conv_layers\.(\d+)\.0\.", r"feature_extractor.conv_layers.\1.conv."),
    (r"^feature_extractor\.conv_layers\.0\.2\.", "feature_extractor.conv_layers.0.layer_norm."),
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (r"^layer_norm\.", "feature_projection.layer_norm."),
    (r"^post_extract_proj\.", "feature_projection.projection."),
    (r"^encoder\.pos_conv\.0\.", "encoder.pos_conv_embed.conv."),
    (r"\.self_attn\.", ".attention."),
    (r"\.self_attn_layer_norm\.", ".layer_norm."),
    (r"\.fc1\.", ".feed_forward.intermediate_dense."),
    (r"\.fc2\.", ".feed_forward.output_dense."),
    (r"\.weight_g$", ".parametrizations.weight.original0"),
    (r"\.weight_v$", ".parametrizations.weight.original1"),
)


def load_hubert_state_dict(sd: Mapping, model) -> None:
    """Load an upstream HuBERT / wav2vec2 state dict into the port's
    `HubertWithKmeans` (`models/hubert.py`), in place: `transformers`
    `HubertModel` / `Wav2Vec2Model` keys (old `weight_g` / `weight_v` or new
    `parametrizations` weight norm; a plain fused `weight` of the positional
    conv is split into g and v), fairseq's names, either under a `hubert.`
    or `wav2vec2.` prefix. Tensors the model does not hold (blocks past
    `output_layer`, the masked-frame embedding) are skipped, as are
    extractor and projection tensors the file lacks; an encoder block that
    finds no tensors raises, rather than leaving a partial port. A
    `cluster_centers` entry replaces the k-means centres."""
    import re

    norm = {}
    for key, value in sd.items():
        for prefix in ("hubert.", "wav2vec2."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        for pattern, repl in _HUBERT_RENAMES:
            key = re.sub(pattern, repl, key)
        norm[key] = torch.as_tensor(np.asarray(value, dtype=np.float32))
    pos = "encoder.pos_conv_embed.conv"
    if f"{pos}.weight" in norm:  # fused: split into g and v
        w = norm.pop(f"{pos}.weight")
        norm[f"{pos}.parametrizations.weight.original0"] = w.double().square().sum(
            dim=(0, 1), keepdim=True).sqrt().float()
        norm[f"{pos}.parametrizations.weight.original1"] = w
    own = model.state_dict()
    for i in range(len(model.encoder.layers)):
        lp = f"encoder.layers.{i}."
        missing = [k for k in own if k.startswith(lp) and k not in norm]
        if missing:
            raise KeyError(f"hubert port: no weights for encoder layer {i} ({missing[0]}, ...) "
                           f"of {len(model.encoder.layers)}: refusing a partial port")
    with torch.no_grad():
        for key, value in norm.items():
            if key not in own:
                continue
            if key == "cluster_centers":
                model.cluster_centers = value.to(own[key].device)
                model.num_clusters = model.codebook_size = int(value.shape[0])
                continue
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(f"hubert port: {key} is {tuple(value.shape)} in the file, "
                                 f"{tuple(own[key].shape)} in the model")
            own[key].copy_(value)


def text_to_semantic_state_dict(params: Mapping, dim_head: int = 64) -> StateDict:
    """JAX `TextToSemantic.params` -> the port's `TextToSemantic` keys: the
    encoder at the `Transformer`'s reference keys, the decoder blocks
    `dec_{i}` and the rest under the JAX names, and the decoder's rotary
    table (`rotary_emb.inv_freq`, as the exporter makes it)."""
    prefix = "net."
    out: StateDict = {f"{prefix}text_embed.weight": _t(params["text_embed"]["embedding"]),
                      f"{prefix}sem_embed.weight": _t(params["sem_embed"]["embedding"])}
    out.update(transformer_state_dict(params["encoder"], prefix=f"{prefix}encoder.",
                                      dim_head=dim_head))
    i = 0
    while f"dec_{i}" in params:
        blk, bp = params[f"dec_{i}"], f"{prefix}dec_{i}"
        for norm in ("self_norm", "cross_norm", "ff_norm"):
            out[f"{bp}.{norm}.gamma"] = _t(blk[norm]["gamma"])
        for name in ("to_qkv", "to_out"):
            _dense(out, f"{bp}.self_attn.{name}", blk["self_attn"][name], bias=False)
        for name in ("to_q", "to_kv", "to_out"):
            _dense(out, f"{bp}.cross_attn.{name}", blk["cross_attn"][name], bias=False)
        _dense(out, f"{bp}.ff.proj_in", blk["ff"]["proj_in"])
        _dense(out, f"{bp}.ff.proj_out", blk["ff"]["proj_out"])
        i += 1
    out[f"{prefix}final_norm.gamma"] = _t(params["final_norm"]["gamma"])
    _dense(out, f"{prefix}to_logits", params["to_logits"], bias=False)
    out[f"{prefix}rotary_emb.inv_freq"] = _t(rotary_inv_freq(dim_head))
    return out


# a transformer block's adapted Denses (flax path under `block_{i}`) -> their
# place in the port's block [skip_combiner, gateloop, attn_prenorm, attn,
# ff_prenorm, ff]
_LORA_PLACES = {("attn", "to_qkv"): "3.to_qkv", ("attn", "to_out"): "3.to_out",
                ("ff", "proj_in"): "5.0", ("ff", "proj_out"): "5.3", ("skip_combiner",): "0"}


def lora_from_jax(lora: Mapping, prefix: str = "") -> Dict[str, Dict[str, torch.nn.Parameter]]:
    """JAX `lora_init` adapters (nested dicts of numpy leaves) -> `{module
    name: {"lora_a": Parameter, "lora_b": Parameter}}` for the port's
    `merge_lora_params` and `fold_lora`. `prefix` is the transformer's owner
    in the port (`"net."` for a `DurationPredictor`'s adapters)."""
    out: Dict[str, Dict[str, torch.nn.Parameter]] = {}

    def walk(tree: Mapping, path: Tuple[str, ...]) -> None:
        if "lora_a" in tree:
            blocks = [i for i, k in enumerate(path) if k.startswith("block_")]
            if not blocks or tuple(path[blocks[-1] + 1:]) not in _LORA_PLACES:
                raise ValueError(f"no port place for the adapter at {'/'.join(path)}")
            b = blocks[-1]
            name = ".".join(path[:b]) + f".layers.{int(path[b][6:])}." + _LORA_PLACES[
                tuple(path[b + 1:])]
            out[prefix + name] = {k: torch.nn.Parameter(_t(tree[k])) for k in ("lora_a",
                                                                               "lora_b")}
            return
        for key, sub in tree.items():
            walk(sub, path + (key,))

    walk(lora, ())
    return out


# reference state-dict keys that are buffers: they take no optimizer index
TORCH_BUFFER_SUFFIXES = ("rotary_emb.inv_freq", "bandwidth_id")
# frozen reference parameters: they take an index and never hold state
TORCH_STATELESS_SUFFIXES = ("null_cond",)


def denoiser_state(model_sd: Mapping) -> dict:
    """The denoiser's entries of a checkpoint's model dict (a wrapper's
    state dict: the denoiser under `voicebox.`), without the prefix and
    without the frozen codec's `audio_enc_dec.*`."""
    if any(k.startswith("voicebox.") for k in model_sd):
        model_sd = {k[len("voicebox."):]: v for k, v in model_sd.items()
                    if k.startswith("voicebox.")}
    return {k: v for k, v in model_sd.items() if not k.startswith("audio_enc_dec.")}


def optimizer_param_groups(model_sd: Mapping, grouped: bool) -> List[List[str]]:
    """The parameter names of each reference optimizer group, in index
    order: [ndim >= 2, the rest] when `grouped` (wd > 0), else one group."""
    names = [k for k in model_sd if not k.endswith(TORCH_BUFFER_SUFFIXES)]
    if not grouped:
        return [names]
    return [[k for k in names if model_sd[k].ndim >= 2],
            [k for k in names if model_sd[k].ndim < 2]]


def optimizer_state_by_name(pkg: Mapping) -> Tuple[dict, dict, int]:
    """The Adam moments of a reference-layout checkpoint by model key:
    ({name: exp_avg}, {name: exp_avg_sq}, step count). Names without state
    (the frozen `null_cond`, parameters that never had a gradient) are left
    out. Raises when the indices cannot be aligned with the model's keys (a
    group layout other than the reference's, an index count or an exp_avg
    shape that does not match)."""
    if not (isinstance(pkg, Mapping) and "optim" in pkg and "model" in pkg):
        raise ValueError("expected a reference trainer checkpoint with 'model' and 'optim' "
                         "(reference trainer.py:191-197)")
    model_sd, optim_sd = pkg["model"], pkg["optim"]
    if not optim_sd:
        raise ValueError("the checkpoint holds no optimizer state (a weights-only file: load "
                         "it with ConditionalFlowMatcherWrapper.load_torch)")
    groups = optim_sd["param_groups"]
    if len(groups) == 2 and groups[1].get("weight_decay") == 0:
        order = [k for g in optimizer_param_groups(model_sd, True) for k in g]
    elif len(groups) == 1:
        order = optimizer_param_groups(model_sd, False)[0]
    else:
        raise ValueError(f"unrecognised param_groups layout ({len(groups)} groups): not a "
                         "reference get_optimizer checkpoint")
    flat = [i for g in groups for i in g["params"]]
    if flat != list(range(len(flat))) or len(flat) != len(order):
        raise ValueError(
            f"the optimizer indexes {len(flat)} parameters but the model holds {len(order)} "
            "non-buffer tensors: cannot align the optimizer state with names")
    state = optim_sd.get("state", {})
    mu, nu, steps = {}, {}, set()
    for pos, name in enumerate(order):
        st = state.get(pos, state.get(str(pos)))
        if st is None:
            continue
        shape = tuple(model_sd[name].shape)
        if tuple(st["exp_avg"].shape) != shape:
            raise ValueError(f"optimizer state {pos} has exp_avg {tuple(st['exp_avg'].shape)} "
                             f"but maps to {name!r} of shape {shape}")
        mu[name], nu[name] = torch.as_tensor(st["exp_avg"]), torch.as_tensor(st["exp_avg_sq"])
        steps.add(int(float(st["step"])))
    if not steps:
        raise ValueError("the optimizer state is empty")
    if len(steps) > 1:
        warnings.warn(f"per-parameter step counts differ {sorted(steps)}; using the largest")
    return mu, nu, max(steps)


def export_optimizer_state(model_sd: Mapping, mu_sd: Mapping, nu_sd: Mapping, count: int, *,
                           lr: float = 1e-4, wd: float = 1e-2, betas=(0.9, 0.99),
                           eps: float = 1e-8) -> dict:
    """A torch `AdamW.state_dict()` in the reference's index layout from
    moments by model key (fp32; a name missing from `mu_sd`, and every
    `null_cond`, gets no state). The groups carry every hyperparameter,
    because `Optimizer.load_state_dict` replaces the live groups' with
    them."""
    def hypers(weight_decay):
        return dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                    amsgrad=False, maximize=False, foreach=None, capturable=False,
                    differentiable=False, fused=None)

    state, param_groups, pos = {}, [], 0
    for gi, names in enumerate(optimizer_param_groups(model_sd, wd > 0)):
        idxs = []
        for name in names:
            if name in mu_sd and not name.endswith(TORCH_STATELESS_SUFFIXES):
                assert tuple(mu_sd[name].shape) == tuple(model_sd[name].shape), name
                state[pos] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": mu_sd[name].detach().to("cpu", torch.float32, copy=True),
                    "exp_avg_sq": nu_sd[name].detach().to("cpu", torch.float32, copy=True),
                }
            idxs.append(pos)
            pos += 1
        param_groups.append(dict(hypers(wd if (wd > 0 and gi == 0) else 0.0), params=idxs))
    return {"state": state, "param_groups": param_groups}


def save_reference_checkpoint(path, model_sd: Mapping, optim_sd: Optional[dict] = None,
                              scheduler_sd: Optional[dict] = None, **extra) -> dict:
    """`torch.save({'model', 'optim', 'scheduler', **extra}, path)`, the
    reference trainer's layout (extra keys are ignored there). Values become
    CPU tensors; an empty scheduler dict is a no-op on a torch scheduler's
    `load_state_dict` (both builds derive the learning rate from the
    step)."""
    pkg = {
        "model": {k: torch.as_tensor(v).detach().to("cpu", copy=True)
                  for k, v in model_sd.items()},
        "optim": optim_sd or {},
        "scheduler": scheduler_sd or {},
        **extra,
    }
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(pkg, path)
    return pkg
