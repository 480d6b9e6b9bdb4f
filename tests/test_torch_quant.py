"""The port's int8 quantization (`voicebox_tpu_torch/ops/quant.py`) against
the JAX package's (`voicebox_tpu/ops/quant.py`), on the CPU.

* `quantize_kernel`: codes and scales equal bit for bit (round half to even
  and an fp32 division on both sides), zero channels included, from fp32
  and from bf16-stored weights;
* `w8a16_matmul` on CPU tensors (its plain version) against JAX's
  `w8a16_matmul(interpret=True)` at ragged (m, k, n), x in fp32 and bf16,
  and at the seq2seq decode's fp32 shapes;
* `k4_tile`'s choice of K4's tile (bf16) and route (fp32) at the engine's
  and the decode's shapes, and against the tiles the C entry point takes;
* `int8_matmul` against JAX's;
* the quantized layer set against `quantize_dense_params`, key for key;
* the quantized VoiceBox forward under both modes against the JAX model
  under `quantized_dense`, and `sample(quantize="w8a16",
  param_store_dtype=...)` against the JAX sampler over its quantized
  (and bf16-stored) params, from the same y0.

fp32 tolerances are the done bar's atol 2e-4. bf16 outputs: both sides sum
exact products in fp32 in another order, then scale and round to bf16, so
they differ by at most one bf16 step (2^-8 relative) where the fp32 sums
straddle a rounding boundary, plus the fp32 order's ~1e-5 near zero.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.ops import quant as jq
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, VoiceBox
from voicebox_tpu_torch.ops import quant as tq
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

ATOL = 2e-4
B, N, DIM_IN, N_COND, STEPS, CFG = 2, 20, 16, 40, 3, 1.3
# the GEGLU's inner width is int(64 * 4 * 2 / 3) = 170: a ragged 64 -> 340,
# 170 -> 64 pair of feed-forward projections; heads 2 x 16
CONFIG = dict(num_cond_tokens=N_COND, dim_cond_emb=24, dim=64, depth=2, dim_head=16,
              heads=2, num_register_tokens=2, attn_qk_norm=True, dim_in=DIM_IN)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("stored", ["f32", "bf16"])
def test_quantize_kernel_matches_jax_bit_for_bit(stored):
    rs = np.random.RandomState(0)
    w = rs.randn(70, 45).astype(np.float32) * rs.rand(1, 45).astype(np.float32) * 3
    w[:, 7] = 0.0  # a zero output channel: scale 0, codes 0, nothing NaN
    w[:, 11] = 0.5  # a channel at exact halves of its step: ties round to even
    w[3, 11] = 127 * 0.5 / 40
    if stored == "bf16":
        w = _bf16_round(w)
    q_j, s_j = jq.quantize_kernel(jnp.asarray(w))  # flax kernel (in, out)
    # the port takes a torch weight (out, in), stored in the same dtype
    w_t = torch.from_numpy(w.T.copy())
    if stored == "bf16":
        w_t = w_t.to(torch.bfloat16)
    q, s = tq.quantize_kernel(w_t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().T, np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j)[0])
    assert s[7] == 0 and (q[7] == 0).all()


def _quant_linear_weights(rs, k, n):
    w = rs.randn(n, k).astype(np.float32) / np.sqrt(k)
    layer = torch.nn.Linear(k, n, bias=False)
    layer.weight.data = torch.from_numpy(w)
    ql = tq.QuantLinear(layer, "w8a16")
    return w, ql


# the flagship's four quantized (k, n) (to_qkv, to_out, the feed-forward's
# proj_in and proj_out) at small m, beside ragged shapes
FLAGSHIP_KN = [(512, 1536), (512, 512), (512, 2730), (1365, 512)]


# the seq2seq decode's fp32 K4 shapes: to_logits at a plain step, to_qkv at
# a draft step, proj_out (x at the pitch of 1376) at a verify chunk
DECODE_MKN = [(1, 512, 502), (4, 512, 1536), (24, 1365, 512)]


@pytest.mark.parametrize("m,k,n,dtype", [
    (m, k, n, dtype) for m, k, n in [(37, 200, 300), (16, 136, 273), (5, 1365, 40)]
    + [(m, k, n) for k, n in FLAGSHIP_KN for m in (3, 17)] for dtype in ("float32", "bfloat16")
] + [(m, k, n, "float32") for m, k, n in DECODE_MKN])
def test_w8a16_plain_matches_jax_interpret(m, k, n, dtype):
    rs = np.random.RandomState(m + k + n)
    w, ql = _quant_linear_weights(rs, k, n)
    # the padded layout the kernel takes: rows of k_pad, a multiple of 16
    assert ql.weight_q.shape == (-(-n // 8) * 8, -(-k // 16) * 16)
    x = rs.randn(m, k).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_round(x)
    q_j, s_j = jq.quantize_kernel(jnp.asarray(w.T))
    ref = jq.w8a16_matmul(jnp.asarray(x, getattr(jnp, dtype)), q_j, s_j, interpret=True)
    # x at the row pitch a w8a16 copy's GEGLU writes (16 elements), NaN in
    # the pitch: the product reads only x's k columns
    k_pad = ql.weight_q.shape[1]
    buf = torch.full((m, k_pad), float("nan"), dtype=getattr(torch, dtype))
    xt = buf[:, :k]
    xt.copy_(torch.from_numpy(x))
    got = tq.w8a16_matmul(xt, ql.weight_q, ql.weight_scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-4, rtol=2**-7)


H100_SMS = 132


# fp32 takes the GEMV route at m <= K4_GEMV_ROWS, the 64 x 64 tiled one above
F32_UNDER_ONE_TILE = {(37, 512): (8, 8), (1, 2730): (8, 16)}


@pytest.mark.parametrize("m,n,tile", [
    (544, 1536, (64, 64)), (544, 512, (64, 64)), (544, 2730, (64, 64)),  # the engine, batch 1
    (2112, 1536, (256, 128)), (2112, 512, (128, 64)), (2112, 2730, (256, 128)),  # batch 2
    (8320, 1536, (256, 128)), (8320, 512, (256, 128)), (8320, 2730, (256, 128)),  # batch 4
    (1532, 512, (128, 64)), (1532, 2730, (256, 128)),  # serving's batch 1 at 750 frames
    (37, 512, (64, 64)), (1, 2730, (64, 64)),  # m under one tile
])
def test_k4_tile_at_the_engines_shapes(m, n, tile):
    assert tq.k4_tile(m, 512, n, torch.bfloat16, H100_SMS) == tile
    assert tq.k4_tile(m, 512, n, torch.float32, H100_SMS) == F32_UNDER_ONE_TILE.get(
        (m, n), (64, 64))


@pytest.mark.parametrize("m,k,n,route", [
    (1, 512, 502, (8, 16)), (1, 512, 1536, (8, 16)), (4, 512, 2730, (8, 16)),  # steps
    (24, 512, 512, (8, 16)), (1, 1365, 512, (8, 4)), (24, 1365, 512, (8, 4)),  # verify
    (32, 512, 1024, (8, 8)), (128, 512, 1024, (8, 8)), (512, 512, 1024, (64, 64)),  # to_kv
])
def test_k4_fp32_route_at_the_decode_shapes(m, k, n, route):
    assert tq.k4_tile(m, k, n, torch.float32, H100_SMS) == route


def _entry_point_routes() -> dict:
    """The (rows, channels) tiles `vb_w8a16_matmul` takes, per dtype, read
    from its source."""
    src = (pathlib.Path(tq.__file__).parents[1] / "csrc" / "w8a16_matmul.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    body = src[src.index('extern "C" int vb_w8a16_matmul'):]
    bf16, f32 = body.split("dtype == 0")
    taken = {torch.bfloat16: {(int(r), int(c)) for r, c in re.findall(
        r"block_m == (\d+) && block_n == (\d+)", bf16)}}
    gemv = re.search(r"block_m == kGemvRows && \(([^)]*)\)", f32).group(1)
    taken[torch.float32] = {(int(const["kF32BM"]), int(const["kF32BN"]))} | {
        (int(const["kGemvRows"]), int(c)) for c in re.findall(r"block_n == (\d+)", gemv)}
    return taken


def test_k4_tile_rule():
    """Every choice is a tile that K4_TILES lists and the C entry point
    takes; the choice depends on (m, k, n, dtype, sms) alone. bf16: where a
    tile's grid covers half the SMs, the chosen one's does too. fp32: the
    tiled route above K4_GEMV_ROWS rows; below it the GEMV route with the
    most channels whose block holds at most 4 warps a row group and 12 in
    all (its grid is ceil(n / channels) whatever m, and on the H100 the
    widest block was the fastest at every decode shape, 32 blocks at n =
    512 included, so no SM-coverage rule holds for it)."""
    rs = np.random.RandomState(0)
    taken = _entry_point_routes()
    assert all(set(tq.K4_TILES[d]) == taken[d] for d in taken), taken
    shapes = [(int(m), int(k), int(n), int(sms)) for m, k, n, sms in zip(
        np.where(rs.rand(300) < 0.5, rs.randint(1, 200, 300), rs.randint(1, 20000, 300)),
        rs.randint(1, 4000, 300), rs.randint(1, 6000, 300), rs.choice([66, 114, 132], 300))]
    for m, k, n, sms in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            tile = tq.k4_tile(m, k, n, dtype, sms)
            assert tile in tq.K4_TILES[dtype]
            assert tq.k4_tile(m, k, n, dtype, sms) == tile

            def blocks(t):
                return -(-m // t[0]) * -(-n // t[1])

            if dtype == torch.bfloat16:
                if any(blocks(t) >= sms / 2 for t in tq.K4_TILES[dtype]):
                    assert blocks(tile) >= sms / 2, (m, n, sms, tile)
                continue
            if m > tq.K4_GEMV_ROWS:
                assert tile == (64, 64), (m, k, n, tile)
                continue

            def warps(t):  # a row group's, and the block's
                group = t[1] // 4 * min(-(-k // 512), 3)
                return group, group * min(-(-m // 8), 4)

            fits = [t for t in tq.K4_TILES[dtype][1:] if warps(t)[0] <= 4 and warps(t)[1] <= 12]
            assert tile == max(fits or [(8, 4)], key=lambda t: t[1]), (m, k, n, tile)


def test_w8a16_copy_feeds_proj_out_pitched_rows():
    """A w8a16 copy's GEGLUs write at a row pitch of 16 elements, so its
    feed-forward down projection gets x rows that TMA can address; the
    caller's module and an int8 copy keep contiguous rows."""
    _, params = _models()
    vb = _port_voicebox(params)
    seen = {}

    def record(tag):
        def hook(module, args):
            seen[tag] = (args[0].shape[-1], args[0].stride(-2))
        return hook

    x, cond, ids, times = _inputs()
    kw = dict(times=torch.from_numpy(times), cond=torch.from_numpy(cond),
              cond_token_ids=torch.from_numpy(ids).long())
    for tag, model in (("float", vb), ("w8a16", tq.quantize_voicebox(vb, "w8a16")),
                       ("int8", tq.quantize_voicebox(vb, "int8"))):
        handle = model.get_submodule("transformer.layers.0.5.3").register_forward_pre_hook(
            record(tag))
        with torch.no_grad():
            model(torch.from_numpy(x), **kw)
        handle.remove()
    inner = seen["float"][0]
    assert inner % 16 and seen["float"] == (inner, inner) == seen["int8"]
    assert seen["w8a16"] == (inner, -(-inner // 16) * 16)
    assert all(block[5][1].row_pitch == 1 for block in vb.transformer.layers)


@pytest.mark.parametrize("lead,k,n", [((3, 17), 96, 128), ((33,), 130, 257)])
def test_int8_matmul_matches_jax(lead, k, n):
    rs = np.random.RandomState(k + n)
    w = rs.randn(n, k).astype(np.float32)
    x = rs.randn(*lead, k).astype(np.float32)
    layer = torch.nn.Linear(k, n, bias=False)
    layer.weight.data = torch.from_numpy(w)
    ql = tq.QuantLinear(layer, "int8")
    q_j, s_j = jq.quantize_kernel(jnp.asarray(w.T))
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), q_j, s_j))
    got = tq.int8_matmul(torch.from_numpy(x), ql.weight_q, ql.weight_scale)
    # the s32 sums are exact on both sides: only the final fp32 products round
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@functools.cache
def _models():
    jvb = JaxVoiceBox(**CONFIG)
    params = jax.jit(functools.partial(jvb.init, cond_drop_prob=0.0))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, N, DIM_IN)), times=jnp.zeros((B,)),
        cond=jnp.zeros((B, N, DIM_IN)), cond_token_ids=jnp.zeros((B, N), jnp.int32),
    )["params"]
    params = _perturbed(params, np.random.RandomState(1))
    # qk gains near 0.25: four guided evaluations compound a peaked
    # softmax's rounding (tests/test_torch_sample.py)
    for i in range(CONFIG["depth"]):
        attn = params["transformer"][f"block_{i}"]["attn"]
        for key in ("q_norm", "k_norm"):
            attn[key]["gamma"] = 0.5 * attn[key]["gamma"]
    return jvb, params


def _port_voicebox(params, **kw):
    vb = VoiceBox(**CONFIG, **kw)
    state = _xla_inv_freq(voicebox_state_dict(params), "transformer.")
    vb.load_state_dict(state, strict=True)
    return vb.eval()


def _jax_quantized_names(qparams):
    """Port module names of the Dense layers JAX quantized."""
    names = []
    ff = {"proj_in": "5.0", "proj_out": "5.3"}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict) and "kernel_q" in val:
                assert path[0] == "transformer" and path[-1] in ("attn", "ff"), path + (key,)
                i = int(path[1].split("_")[1])
                leaf = f"3.{key}" if path[-1] == "attn" else ff[key]
                names.append(f"transformer.layers.{i}.{leaf}")
            elif isinstance(val, dict):
                walk(val, path + (key,))

    walk(qparams, ())
    return sorted(names)


def test_quantized_layer_set_matches_jax():
    _, params = _models()
    qparams = jq.quantize_dense_params(params)
    vb = _port_voicebox(params)
    names = tq.quantized_layer_names(vb)
    assert sorted(names) == _jax_quantized_names(qparams)
    qvb = tq.quantize_voicebox(vb, "w8a16")
    swapped = sorted(n for n, m in qvb.named_modules() if isinstance(m, tq.QuantLinear))
    assert swapped == sorted(names)
    # the caller's module is untouched, and the copy shares its float weights
    assert not any(isinstance(m, tq.QuantLinear) for m in vb.modules())
    assert qvb.to_embed.weight is vb.to_embed.weight
    assert qvb.proj_in is None and isinstance(qvb.to_pred, torch.nn.Linear)
    # the codes are JAX's, layer for layer
    block = qparams["transformer"]["block_1"]
    for port_name, leaf in (("transformer.layers.1.3.to_qkv", block["attn"]["to_qkv"]),
                            ("transformer.layers.1.5.3", block["ff"]["proj_out"])):
        ql = qvb.get_submodule(port_name)
        k, n = np.asarray(leaf["kernel_q"]).shape
        np.testing.assert_array_equal(ql.weight_q[:n, :k].numpy().T, np.asarray(leaf["kernel_q"]))
        np.testing.assert_array_equal(ql.weight_scale.numpy(), np.asarray(leaf["kernel_scale"])[0])


def test_bf16_store_codes_match_jax_cast_then_quantize():
    """The serving VoiceBox stores bf16 weights (`dtype=bfloat16`): its codes
    are JAX's codes of `cast_float_params(params, bf16)`, not of the fp32
    weights."""
    _, params = _models()
    vb = _port_voicebox(params, dtype=torch.bfloat16)
    qvb = tq.quantize_voicebox(vb, "w8a16")
    leaf = jq.quantize_dense_params(jq.cast_float_params(params, jnp.bfloat16))[
        "transformer"]["block_0"]["ff"]["proj_in"]
    ql = qvb.get_submodule("transformer.layers.0.5.0")
    k, n = np.asarray(leaf["kernel_q"]).shape
    np.testing.assert_array_equal(ql.weight_q[:n, :k].numpy().T, np.asarray(leaf["kernel_q"]))
    np.testing.assert_array_equal(ql.weight_scale.numpy(), np.asarray(leaf["kernel_scale"])[0])
    assert ql.bias.dtype == torch.bfloat16 and ql.compute_dtype == torch.bfloat16
    f32_codes = jq.quantize_dense_params(params)["transformer"]["block_0"]["ff"]["proj_in"]
    assert (np.asarray(f32_codes["kernel_q"]) != np.asarray(leaf["kernel_q"])).any()


def _inputs(seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, DIM_IN).astype(np.float32)
    cond = rs.randn(B, N, DIM_IN).astype(np.float32)
    ids = rs.randint(-1, N_COND, (B, N)).astype(np.int32)
    times = rs.rand(B).astype(np.float32)
    return x, cond, ids, times


# int8: the activations' codes are rounded per call, so an fp32-rounding
# difference of a layer's input can move one code by one step; the output
# then moves by up to row_scale * |w| ~ 1e-3, far above rounding
@pytest.mark.parametrize("mode,atol", [("w8a16", ATOL), ("int8", 2e-2)])
def test_quantized_voicebox_forward_matches_jax(mode, atol):
    jvb, params = _models()
    x, cond, ids, times = _inputs()
    qparams = jq.quantize_dense_params(params)
    drop = np.array([False, True])

    @jax.jit
    def run(p):
        with jq.quantized_dense(mode):
            return jvb.apply({"params": p}, jnp.asarray(x), times=jnp.asarray(times),
                             cond=jnp.asarray(cond), cond_token_ids=jnp.asarray(ids),
                             cond_drop_prob=0.0, cond_drop_mask=jnp.asarray(drop), train=False)

    ref = np.asarray(run(qparams))
    qvb = tq.quantize_voicebox(_port_voicebox(params), mode)
    with torch.no_grad():
        got = qvb(torch.from_numpy(x), times=torch.from_numpy(times),
                  cond=torch.from_numpy(cond), cond_token_ids=torch.from_numpy(ids).long(),
                  cond_drop_mask=torch.from_numpy(drop)).numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_jax_jitted_quantize_divides_by_a_rounded_reciprocal():
    """Under jit, XLA rewrites `absmax / 127.0` as `absmax * f32(1 / 127)`,
    so `_quantized_params` (which jits `quantize_dense_params`) gets scales
    one ulp off the eager `quantize_kernel` in some channels, and a code
    near a rounding tie can move by one step. The port divides, as the
    source and eager JAX do (ROADMAP Queue 3)."""
    rs = np.random.RandomState(6)
    w = rs.randn(64, 96).astype(np.float32)
    absmax = np.abs(w).max(axis=0)
    _, s_eager = jq.quantize_kernel(jnp.asarray(w))
    _, s_jit = jax.jit(jq.quantize_kernel)(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(s_eager)[0], absmax / np.float32(127.0))
    np.testing.assert_array_equal(np.asarray(s_jit)[0], absmax * np.float32(1 / 127.0))
    assert (np.asarray(s_jit) != np.asarray(s_eager)).any()
    _, s_port = tq.quantize_kernel(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(s_port.numpy(), np.asarray(s_eager)[0])


@pytest.mark.parametrize("store", [None, "bfloat16"])
def test_sample_quantized_matches_jax_sampler(store):
    jvb, params = _models()
    _, cond, ids, _ = _inputs(3)
    ids = np.abs(ids)
    y0 = np.random.RandomState(4).randn(B, N, DIM_IN).astype(np.float32)
    jcfm = JaxCFM(jvb)
    jparams = params if store is None else jcfm._stored_params(params, jnp.bfloat16)
    sampler = jcfm._build_sampler(STEPS, True, True, False, False, "midpoint",
                                  quantize="w8a16")
    # the params `_quantized_params` makes, quantized eagerly: its jit moves
    # some codes by one step (see the test above), the sampler is the same
    qparams = jq.quantize_dense_params(jparams)
    ref = np.asarray(sampler(qparams, jnp.asarray(y0), jnp.asarray(cond), jnp.asarray(ids),
                             None, None, jnp.float32(CFG)))
    cfm = ConditionalFlowMatcherWrapper(_port_voicebox(params), device="cpu")
    got = cfm.sample(cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids),
                     steps=STEPS, cond_scale=CFG, noise=torch.from_numpy(y0),
                     decode_to_audio=False, quantize="w8a16",
                     param_store_dtype=None if store is None else torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    served = cfm._serving_copy[1]
    assert all(p.dtype == (torch.float32 if store is None else torch.bfloat16)
               for p in served.parameters())
    assert all(p.dtype == torch.float32 for p in cfm.voicebox.parameters())


def test_serving_copy_is_cached_per_weights_version():
    _, params = _models()
    cfm = ConditionalFlowMatcherWrapper(_port_voicebox(params), device="cpu")
    _, cond, ids, _ = _inputs(5)
    kw = dict(cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(np.abs(ids)),
              steps=2, noise=torch.zeros(B, N, DIM_IN), decode_to_audio=False,
              quantize="w8a16")
    first = cfm.sample(**kw)
    copy = cfm._serving_copy[1]
    cfm.sample(**kw)
    assert cfm._serving_copy[1] is copy
    cfm.sample(**kw, param_store_dtype=torch.bfloat16)  # another key: a new copy
    assert cfm._serving_copy[1] is not copy
    cfm.sample(**kw)
    copy = cfm._serving_copy[1]
    # an in-place update of the weights (a load, an optimizer step) is served
    with torch.no_grad():
        cfm.voicebox.transformer.layers[0][3].to_qkv.weight.mul_(2.0)
    second = cfm.sample(**kw)
    assert cfm._serving_copy[1] is not copy
    assert not torch.equal(first, second)
    with pytest.raises(ValueError, match="quantize mode"):
        cfm.sample(**{**kw, "quantize": "int4"})


def test_cast_float_params_copies_the_module():
    _, params = _models()
    vb = _port_voicebox(params)
    cast = tq.cast_float_params(vb, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    assert all(p.dtype == torch.float32 for p in vb.parameters())
    assert {n for n, _ in cast.named_parameters()} == {n for n, _ in vb.named_parameters()}
    # buffers are not parameters: the rotary table stays fp32
    assert cast.transformer.rotary_emb.inv_freq.dtype == torch.float32
    # the fp32-computing pieces upcast bf16-stored weights at use, as flax does
    x, cond, ids, times = _inputs()
    with torch.no_grad():
        out = cast(torch.from_numpy(x), times=torch.from_numpy(times),
                   cond=torch.from_numpy(cond), cond_token_ids=torch.from_numpy(ids).long())
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_skip_combiners_are_quantized_where_jax_names_them_apart():
    """`DEFAULT_QUANT_LAYERS` names `skip_combiner`, and the port quantizes a
    block's skip combiner by its place. The JAX package's unrolled
    transformer names them `skip_combiner_{i}`, which its exact-name match
    misses (ROADMAP Queue 3); VoiceBox builds no skip connections, so the
    two sets agree on every VoiceBox."""
    from voicebox_tpu_torch.models.transformer import Transformer

    class _Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.transformer = Transformer(dim=32, depth=2, dim_head=16, heads=2,
                                           use_unet_skip_connection=True)

    names = tq.quantized_layer_names(_Holder())
    assert "transformer.layers.1.0" in names and "transformer.layers.0.0" not in names
    assert len(names) == 2 * 4 + 1
    tree = {"transformer": {"skip_combiner_1": {"kernel": jnp.ones((64, 32))},
                            "skip_combiner": {"kernel": jnp.ones((64, 32))}}}
    qtree = jq.quantize_dense_params(tree)["transformer"]
    assert "kernel" in qtree["skip_combiner_1"] and "kernel_q" in qtree["skip_combiner"]
