"""The port's HubertWithKmeans against the JAX package's, on the CPU in
float32, at tiny widths (conv 16, dim 32, 3 blocks of 4 heads, ff 64, pos
conv 16 / 4 groups, 20 clusters): the weights carried by
`utils/convert.py::hubert_state_dict`, random on every leaf.

* features at atol 2e-4 and ids equal, except where the JAX side's best and
  second-best distances lie within a rounding bound, for the base
  (post-norm, group-norm extractor) and large (pre-norm, layer-norm
  extractor) layouts, whole and truncated by `output_layer`;
* `num_frames` and `seq_len_multiple_of`, and `fit_kmeans` from features;
* `load_hubert_state_dict` against the genuine `transformers` `HubertModel`
  (new weight-norm keys, old `weight_g` / `weight_v`, a `hubert.` prefix and
  fairseq's names), whose hidden state the port's features match; a missing
  encoder block raises; `kmeans_path` reads a joblib file.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.models.hubert import HubertWithKmeans as JaxHubert
from voicebox_tpu_torch.models.hubert import HubertWithKmeans
from voicebox_tpu_torch.utils.convert import hubert_state_dict, load_hubert_state_dict

ATOL = 2e-4
CFG = dict(num_clusters=20, conv_dim=16, dim=32, depth=3, heads=4, ff_dim=64,
           conv_pos_kernel=16, conv_pos_groups=4)
N_SAMPLES = 4000  # 12 frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(large, output_layer):
    return dict(CFG, layer_norm_first=large, extractor_norm_mode="layer" if large else "group",
                output_layer=output_layer)


def _random_params(jh, rs):
    """Random weights of `jh`'s geometry from shapes alone (`jax.eval_shape`
    compiles nothing): fan-in scaled normals for kernels, 1 + 0.1 x normals
    for norm scales, 0.1 x normals for biases, unit normals for the
    centroids."""
    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*sd.shape)).astype(np.float32)
        if len(sd.shape) == 1:
            return (0.1 * rs.randn(*sd.shape)).astype(np.float32)
        return (rs.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)

    key = jax.random.PRNGKey(0)
    shapes = {
        "feature_extractor": jax.eval_shape(jh.feature_extractor.init, key,
                                            jnp.zeros((1, 3200)))["params"],
        "proj_norm": {"scale": jax.ShapeDtypeStruct((CFG["conv_dim"],), jnp.float32),
                      "bias": jax.ShapeDtypeStruct((CFG["conv_dim"],), jnp.float32)},
        "proj": {"kernel": jax.ShapeDtypeStruct((CFG["conv_dim"], CFG["dim"]), jnp.float32),
                 "bias": jax.ShapeDtypeStruct((CFG["dim"],), jnp.float32)},
        "encoder": jax.eval_shape(jh.encoder.init, key, jnp.zeros((1, 10, CFG["dim"])))["params"],
    }
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    params["kmeans"] = rs.randn(CFG["num_clusters"], CFG["dim"]).astype(np.float32)
    return params


@functools.cache
def _models(large, output_layer):
    jh = JaxHubert(**_cfg(large, output_layer), params={})  # no init: weights come next
    params = _random_params(jh, np.random.RandomState(1))
    jh.params = jax.tree.map(jnp.asarray, params)
    th = HubertWithKmeans(**_cfg(large, output_layer))
    th.load_state_dict(hubert_state_dict(params), strict=True)
    return jh, th


def _wav(seed=3, b=2, n=N_SAMPLES):
    return np.random.RandomState(seed).randn(b, n).astype(np.float32)


@pytest.mark.parametrize("large", [False, True], ids=["base", "large"])
@pytest.mark.parametrize("output_layer", [None, 2], ids=["all", "layer2"])
def test_features_and_ids_match_jax(large, output_layer):
    jh, th = _models(large, output_layer)
    wav = _wav()
    ref = np.asarray(jh.features(jnp.asarray(wav)))
    feats = th.features(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(feats, ref, atol=ATOL, rtol=0)
    ref_ids = np.asarray(jh(jnp.asarray(wav)))
    ids = th(torch.from_numpy(wav)).numpy()
    c = np.asarray(jh.params["kmeans"], np.float64)
    d = ((ref.astype(np.float64)[..., None, :] - c) ** 2).sum(-1)
    gap = np.sort(d, axis=-1)
    near_tie = gap[..., 1] - gap[..., 0] < 1e-3 * gap[..., 1]
    assert ids.shape == ref_ids.shape == (2, jh.num_frames(N_SAMPLES))
    assert ((ids == ref_ids) | near_tie).all()
    assert (ids == ref_ids).mean() > 0.9


def test_frame_counts_and_curtailment():
    jh, th = _models(False, None)
    for n in (400, 3999, 4000, 16000, 160000):
        assert th.num_frames(n) == jh.num_frames(n)
    assert th.num_frames(160000) == 499
    th.seq_len_multiple_of = 640
    try:
        wav = _wav(n=4100)
        assert th(torch.from_numpy(wav)).shape[1] == th.num_frames(4100) == th.num_frames(3840)
        assert th(torch.from_numpy(wav[:, None])).shape[1] == th.num_frames(4100)  # (b, 1, n)
    finally:
        th.seq_len_multiple_of = None


def test_fit_kmeans_on_features():
    jh, th = _models(False, None)
    feats = th.features(torch.from_numpy(_wav(b=4))).reshape(-1, CFG["dim"])
    c, inertia = th.fit_kmeans(features=feats, iters=5,
                               generator=torch.Generator().manual_seed(0))
    assert c.shape == (CFG["num_clusters"], CFG["dim"]) and np.isfinite(float(inertia))
    assert torch.equal(th.cluster_centers, c)
    ids = th(torch.from_numpy(_wav()))
    assert int(ids.max()) < CFG["num_clusters"]
    th.load_state_dict(hubert_state_dict(jax.tree.map(np.asarray, jh.params)))


# --- the genuine upstream model --------------------------------------------

transformers = pytest.importorskip("transformers")


@functools.cache
def _upstream():
    cfg = transformers.HubertConfig(
        hidden_size=CFG["dim"], num_hidden_layers=CFG["depth"],
        num_attention_heads=CFG["heads"], intermediate_size=CFG["ff_dim"],
        conv_dim=[CFG["conv_dim"]] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
        conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=CFG["conv_pos_kernel"],
        num_conv_pos_embedding_groups=CFG["conv_pos_groups"], apply_spec_augment=False,
        layerdrop=0.0, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, hidden_act="gelu", feat_extract_norm="group",
        do_stable_layer_norm=False, feat_proj_layer_norm=True)
    torch.manual_seed(5)
    model = transformers.HubertModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _upstream_hidden(model, wav):
    with torch.no_grad():
        return model(torch.from_numpy(wav)).last_hidden_state.numpy()


def _fairseq(sd):
    """transformers names -> fairseq's (the map `load_hubert_torch` reads)."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"conv_layers\.(\d+)\.conv\.", r"conv_layers.\1.0.", k)
        k = k.replace("conv_layers.0.layer_norm.", "conv_layers.0.2.")
        k = k.replace("feature_projection.layer_norm.", "layer_norm.")
        k = k.replace("feature_projection.projection.", "post_extract_proj.")
        k = k.replace("encoder.pos_conv_embed.conv.", "encoder.pos_conv.0.")
        k = k.replace(".attention.", ".self_attn.")
        k = k.replace(".feed_forward.intermediate_dense.", ".fc1.")
        k = k.replace(".feed_forward.output_dense.", ".fc2.")
        k = re.sub(r"(encoder\.layers\.\d+)\.layer_norm\.", r"\1.self_attn_layer_norm.", k)
        k = k.replace("parametrizations.weight.original0", "weight_g").replace(
            "parametrizations.weight.original1", "weight_v")
        out[k] = v
    return out


def _old_weight_norm(sd):
    return {k.replace("parametrizations.weight.original0", "weight_g").replace(
        "parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}


def _fused_pos_conv(sd):
    pos = "encoder.pos_conv_embed.conv.parametrizations.weight"
    g, v = sd[f"{pos}.original0"], sd[f"{pos}.original1"]
    out = {k: t for k, t in sd.items() if ".parametrizations." not in k}
    out["encoder.pos_conv_embed.conv.weight"] = torch._weight_norm(v, g, 2)
    return out


@pytest.mark.parametrize("layout", ["transformers", "old_weight_norm", "prefixed", "fairseq",
                                    "fused_pos_conv"])
def test_load_upstream_state_dict(layout):
    model = _upstream()
    sd = model.state_dict()
    sd = {"transformers": lambda s: s, "old_weight_norm": _old_weight_norm,
          "prefixed": lambda s: {f"hubert.{k}": v for k, v in s.items()},
          "fairseq": _fairseq, "fused_pos_conv": _fused_pos_conv}[layout](sd)
    th = HubertWithKmeans(**_cfg(False, None))
    load_hubert_state_dict(sd, th)
    wav = _wav()
    np.testing.assert_allclose(th.features(torch.from_numpy(wav)).numpy(),
                               _upstream_hidden(model, wav), atol=ATOL, rtol=0)


def test_output_layer_matches_upstream_hidden_state():
    model = _upstream()
    th = HubertWithKmeans(**_cfg(False, 2))
    load_hubert_state_dict(model.state_dict(), th)  # blocks past 2 are skipped
    wav = _wav()
    with torch.no_grad():
        ref = model(torch.from_numpy(wav), output_hidden_states=True).hidden_states[2].numpy()
    np.testing.assert_allclose(th.features(torch.from_numpy(wav)).numpy(), ref, atol=ATOL,
                               rtol=0)


def test_missing_encoder_block_raises():
    sd = {k: v for k, v in _upstream().state_dict().items()
          if not k.startswith("encoder.layers.1.")}
    with pytest.raises(KeyError, match="encoder layer 1"):
        load_hubert_state_dict(sd, HubertWithKmeans(**_cfg(False, None)))


class _KMeans:  # what joblib holds: an object with sklearn's attribute
    def __init__(self, centers):
        self.cluster_centers_ = centers


def test_kmeans_path_and_checkpoint_path(tmp_path):
    joblib = pytest.importorskip("joblib")
    centers = np.random.RandomState(9).randn(7, CFG["dim"]).astype(np.float32)
    km_path, ckpt = tmp_path / "km.joblib", tmp_path / "hubert.pt"
    joblib.dump(_KMeans(centers), km_path)
    torch.save(_upstream().state_dict(), ckpt)
    th = HubertWithKmeans(**_cfg(False, None), checkpoint_path=str(ckpt),
                          kmeans_path=str(km_path))
    assert th.codebook_size == 7 and np.array_equal(th.cluster_centers.numpy(), centers)
    wav = _wav()
    feats = th.features(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(feats, _upstream_hidden(_upstream(), wav), atol=ATOL, rtol=0)
    d = ((feats[..., None, :] - centers) ** 2).sum(-1)
    assert (th(torch.from_numpy(wav)).numpy() == d.argmin(-1)).mean() > 0.9
    joblib.dump(_KMeans(centers[:, :5]), km_path)
    with pytest.raises(ValueError, match="don't match"):
        th.load_kmeans(km_path)
