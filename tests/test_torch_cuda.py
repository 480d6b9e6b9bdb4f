"""K1, K2, K3, K4 and the port's attention and quantized denoiser on an
NVIDIA GPU, against the plain PyTorch versions. Marked `cuda`: every test
skips without a card. The file imports no jax, so on a GPU machine without
jax it runs with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
"""

import copy

import pytest
import torch

from voicebox_tpu_torch.models.attention import Attention
from voicebox_tpu_torch.models.voicebox import VoiceBox
from voicebox_tpu_torch.ops.flash_attention import (
    _launch_k1,
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    k23_f32_edges,
    reference_attention,
    reference_attention_backward,
)
from voicebox_tpu_torch.ops.quant import (
    K4_TILES,
    QuantLinear,
    _launch_k4,
    _x_rows,
    int8_matmul,
    quantize_voicebox,
    w8a16_matmul,
    w8a16_matmul_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1, K2, K3 and K4 run only on an NVIDIA GPU (sm_90a)")
    # fp32 comparisons: no TF32 in matmuls, nor in cuDNN's convolutions
    # (on by default; HuBERT's extractor is convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, b=2, h=4, n=257, kv=200, d=128, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, n, d, generator=gen, device=device)
    k, v = (torch.randn(b, h, kv, d, generator=gen, device=device) for _ in range(2))
    mask = torch.rand(b, kv, generator=gen, device=device) < 0.7
    if b > 1:
        mask[-1] = False  # the last batch element's rows are fully masked
    return q, k, v, mask


def _backward(q, k, v, mask, seed=1):
    do = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(seed),
                     device=q.device).to(q.dtype)
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    delta = attention_delta(do, out)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, q.shape[-1] ** -0.5)
    dk, dv = flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    return (dq, dk, dv), reference_attention_backward(q, k, v, mask, out, lse, do), do


# (b, h, n, kv): ragged n and kv; kv off K1's 128-key tile and off 8 (TMA's
# zero fill); n under one 64-row tile; a grid that takes two consumer
# warpgroups per block; a kv that wraps the 2-stage K/V ring many times
K1_SHAPES = [(2, 4, 257, 200), (2, 4, 257, 131), (1, 4, 40, 300), (8, 4, 600, 600),
             (1, 4, 4100, 4100)]


# bf16: P and out are each rounded to bf16 on both sides, in another order
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,n,kv", K1_SHAPES)
def test_k1_matches_plain(cuda_device, dtype, tol, d, b, h, n, kv):
    q, k, v, mask = _qkv(cuda_device, b, h, n, kv, d=d)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    if b > 1:
        mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(out[-1])
        torch.testing.assert_close(out[-1].float(), mean_v, atol=tol, rtol=tol)


# both bf16 query-tile heights, whichever the host would choose (fp32 takes
# one, 16 rows, and test_k1_matches_plain runs it)
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_k1_every_tile_height_matches_plain(cuda_device, rows, d):
    q, k, v, mask = (t.to(torch.bfloat16) if t.is_floating_point() else t
                     for t in _qkv(cuda_device, 3, 2, 150, 259, d=d))
    out, lse = _launch_k1(q, k, v, mask, d ** -0.5, rows)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)


def test_k1_rejects_what_it_does_not_take(cuda_device):
    q, k, v, _ = _qkv(cuda_device, d=128)
    # any head dim: 257 runs zero-padded to 320 (the chunked kernels), one
    # launch, against the plain version
    wide = [torch.cat([t, t, t[..., :1]], dim=-1) for t in (q, k, v)]  # 257
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        args = [t.to(dtype) for t in wide]
        before = flash_attention.launches
        out = flash_attention(*args)
        assert flash_attention.launches == before + 1 and out.shape == args[0].shape
        torch.testing.assert_close(out.float(), reference_attention(*args).float(), atol=tol,
                                   rtol=tol)
    strided_q = q.transpose(0, 1).contiguous().transpose(0, 1)  # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(strided_q, k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        _launch_k1(q, k, v, None, 1.0, block_q=48)  # no such tile height
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        _launch_k1(q.float(), k.float(), v.float(), None, 1.0, block_q=32)  # fp32 takes 16


def test_attention_module_card_matches_cpu(cuda_device):
    torch.manual_seed(0)
    attn = Attention(128, dim_head=64, heads=2, qk_norm=True)
    for p in (attn.q_norm.gamma, attn.k_norm.gamma):
        torch.nn.init.constant_(p, 0.25)  # logits up to 10 d gain^2 = 40
    x = torch.randn(2, 70, 128)
    mask = torch.rand(2, 70) < 0.8
    rotary = torch.randn(70, 64)
    with torch.no_grad():
        ref = attn(x, mask=mask, rotary_emb=rotary)
        out = copy.deepcopy(attn).to(cuda_device)(
            x.to(cuda_device), mask=mask.to(cuda_device), rotary_emb=rotary.to(cuda_device)
        )
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("policy,k1_per_layer", [(None, 2), ("dots", 2),
                                                 ("dots+attn_out+attn_lse", 1)])
def test_remat_on_the_card_keeps_gradients_and_counts_k1(cuda_device, policy, k1_per_layer):
    """Remat gives the gradients of the plain step to the bit (K2 and K3 are
    deterministic); K1 runs again in the backward unless the policy saves
    its outputs."""
    cfg = dict(num_cond_tokens=20, dim_cond_emb=32, dim=128, depth=2, dim_head=64, heads=2,
               num_register_tokens=4, dim_in=16, dtype=torch.bfloat16,
               param_dtype=torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(2, 60, 16, generator=gen, device=cuda_device)
    ids = torch.randint(0, 20, (2, 60), generator=gen, device=cuda_device)
    kw = dict(times=torch.rand(2, generator=gen, device=cuda_device), cond_token_ids=ids,
              target=x, cond_mask=torch.rand(2, 60, generator=gen, device=cuda_device) < 0.5,
              cond_drop_mask=torch.tensor([False, True], device=cuda_device), train=True)

    def grads(**remat):
        torch.manual_seed(0)
        vb = VoiceBox(**cfg, **remat).to(cuda_device)
        before = flash_attention.launches
        vb(x, **kw).backward()
        torch.cuda.synchronize()
        return flash_attention.launches - before, [p.grad for p in vb.parameters()]

    plain_k1, plain = grads()
    k1, ours = grads(remat=True, remat_policy=policy)
    assert plain_k1 == cfg["depth"] and k1 == k1_per_layer * cfg["depth"]
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def test_scores_dtype_changes_no_bit_on_the_kernel_path(cuda_device):
    """`attn_scores_dtype=torch.bfloat16` acts on the plain path only: K1
    holds no score matrix, so the loss and every gradient of a training
    step through K1/K2/K3 are the same bits with and without it."""
    cfg = dict(num_cond_tokens=20, dim_cond_emb=32, dim=128, depth=2, dim_head=64, heads=2,
               num_register_tokens=4, dim_in=16, dtype=torch.bfloat16,
               param_dtype=torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 60, 16, generator=gen, device=cuda_device)
    kw = dict(times=torch.rand(2, generator=gen, device=cuda_device),
              cond_token_ids=torch.randint(0, 20, (2, 60), generator=gen, device=cuda_device),
              target=x, cond_mask=torch.rand(2, 60, generator=gen, device=cuda_device) < 0.5,
              cond_drop_mask=torch.tensor([False, True], device=cuda_device), train=True)

    def step(scores):
        torch.manual_seed(0)
        vb = VoiceBox(**cfg, attn_scores_dtype=scores).to(cuda_device)
        before = flash_attention.launches
        loss = vb(x, **kw)
        loss.backward()
        torch.cuda.synchronize()
        return flash_attention.launches - before, loss, [p.grad for p in vb.parameters()]

    k1, loss, grads = step(None)
    k1_bf16, loss_bf16, grads_bf16 = step(torch.bfloat16)
    assert k1 == k1_bf16 == cfg["depth"]
    assert torch.equal(loss, loss_bf16)
    for a, b in zip(grads, grads_bf16):
        assert torch.equal(a, b)


# the new paths' shapes: the 100 s long-context step (n = kv = 7520: 117 x 64
# + 32 and 58 x 128 + 96 rows, a ragged last tile in both K1 heights and in
# K2/K3's 64-row tiles, the lse and the fp32 row sums over 118 streamed
# tiles) and the JAX package's default VoiceBox in training (8 x 16 heads of
# 64); bf16, qk-normed logits at scale 10 as the denoiser calls them
@pytest.mark.parametrize("b,h,n,d", [(1, 4, 7520, 128), (8, 16, 768, 64)])
def test_long_context_and_default_shapes_match_plain(cuda_device, b, h, n, d):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device=cuda_device)
                   for _ in range(4))
    q, k = (torch.nn.functional.normalize(t, dim=-1) * d ** 0.5 for t in (q, k))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    mask = torch.ones(b, n, dtype=torch.bool, device=cuda_device)
    mask[0, -100:] = False  # a padded tail on the first element
    out, lse = flash_attention(q, k, v, mask, 10.0, return_lse=True)
    ref, ref_lse = reference_attention(q, k, v, mask, 10.0, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    delta = attention_delta(do, out)
    got = (flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, 10.0),
           *flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, 10.0))
    plain = reference_attention_backward(q, k, v, mask, out, lse, do, 10.0)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), got, plain):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), r.float(), atol=2e-2 * r.float().abs().max().item(),
                                   rtol=2e-2, msg=name)


# bf16: P and dS are rounded to bf16 before their products, in another order
# than the plain version's sums; fp32: rounding only. The shapes are K1's
# edges: K2 streams 64-key tiles and K3 64-row query tiles through the same
# kind of TMA ring, with the same zero fill past n and kv
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,n,kv", K1_SHAPES)
def test_k2_k3_match_plain_backward(cuda_device, dtype, tol, d, b, h, n, kv):
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _qkv(cuda_device, b, h, n, kv, d=d))
    got, ref, _ = _backward(q, k, v, mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol * b.float().abs().max().item(),
                                   rtol=tol, msg=name)


# each block owns its output rows and sums in a fixed order: no atomics
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_are_deterministic(cuda_device, dtype):
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _qkv(cuda_device, 2, 4, 600, 600, d=128))
    first, _, _ = _backward(q, k, v, mask)
    second, _, _ = _backward(q, k, v, mask)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# fp32 K2/K3 at the edges of their tiling (`k23_f32_edges`, the shapes of
# tests/test_torch_flash_backward_tiles.py): rounding only, as above. Where
# kv = 1 a row's one key has p = 1 and ds = p (dO.v - delta) scale is 0 in
# exact arithmetic: the plain version's dq and dk are rounding noise there,
# and the kernels' are held to 16 ulps of |dO| |v|, times scale and |k|
# (dq) or |q| (dk). A second launch gives the same bits.
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n,kv", k23_f32_edges())
def test_k2_k3_f32_match_plain_at_tile_edges(cuda_device, n, kv, d):
    q, k, v, mask = _qkv(cuda_device, 2, 2, n, kv, d=d, seed=n + kv)
    got, ref, do = _backward(q, k, v, mask, seed=kv)
    floors = [0.0, 0.0, 0.0]
    if kv == 1:
        base = 2.0 ** -20 * d ** -0.5 * (do.norm(dim=-1).max() * v.norm(dim=-1).max()).item()
        floors[:2] = base * k.abs().max().item(), base * q.abs().max().item()
    for name, a, b, floor in zip(("dq", "dk", "dv"), got, ref, floors):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, atol=max(1e-5 * b.abs().max().item(), floor),
                                   rtol=1e-5, msg=name)
    again, _, _ = _backward(q, k, v, mask, seed=kv)
    for name, a, b in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, b), name


# head dims 192 (zero-padded to 256) and 256 at K1's edge shapes, in both
# dtypes (tolerances as above): K1 against the plain forward, a fully-masked
# element's rows at mean(V); K2/K3 against the plain backward, and a second
# launch of each kernel gives the same bits. Past 256, the chunked kernels
# (256 output columns a block): 512 and 1024 whole chunks, 320 and 576 a
# last chunk of 64 columns
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [192, 256, 320, 512, 576, 1024])
@pytest.mark.parametrize("b,h,n,kv", K1_SHAPES)
def test_wide_heads_match_plain(cuda_device, dtype, tol, d, b, h, n, kv):
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _qkv(cuda_device, b, h, n, kv, d=d, seed=d + n))
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    out2, lse2 = flash_attention(q, k, v, mask, return_lse=True)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if b > 1:
        mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(out[-1])
        torch.testing.assert_close(out[-1].float(), mean_v, atol=tol, rtol=tol)
    got, plain, _ = _backward(q, k, v, mask)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, plain):
        assert a.dtype == dtype and a.shape == b_.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b_.float(),
                                   atol=tol * b_.float().abs().max().item(), rtol=tol, msg=name)
    again, _, _ = _backward(q, k, v, mask)
    for name, a, b_ in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, b_), name


def _mask(kind, b, kv, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind is None:
        return None
    if kind == "prefix":  # padding at each row's end
        lengths = torch.randint(max(kv // 3, 1), kv + 1, (b,), generator=gen, device=device)
        lengths[0] = kv
        return torch.arange(kv, device=device)[None, :] < lengths[:, None]
    mask = torch.rand(b, kv, generator=gen, device=device) < 0.7
    if kind == "empty_row":
        mask[-1] = False  # every key of the last batch element masked
    return mask


# fp32 K1, K2 and K3 at the narrow head dims of small models (the quality
# canaries' 16 and 32), at the fp32 tiling's edges (`k23_f32_edges`: n and
# kv at 1 and around the tiles) and the canaries' own shapes, under each
# kind of mask: K1 to 1e-5 of the plain version, K2/K3 as in
# test_k2_k3_f32_match_plain_at_tile_edges (dq and dk at kv = 1 held to the
# rounding floor); a second launch of each gives the same bits
@pytest.mark.parametrize("mask_kind", [None, "prefix", "random", "empty_row"])
@pytest.mark.parametrize("n,kv", [*k23_f32_edges(), (7, 7), (9, 9), (123, 123)])
@pytest.mark.parametrize("d", [16, 32])
def test_f32_narrow_heads_match_plain(cuda_device, d, n, kv, mask_kind):
    q, k, v, _ = _qkv(cuda_device, 2, 4, n, kv, d=d, seed=n + kv + d)
    mask = _mask(mask_kind, 2, kv, cuda_device, n + kv)
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    out2, lse2 = flash_attention(q, k, v, mask, return_lse=True)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if mask_kind == "empty_row":
        mean_v = v[-1].mean(dim=1, keepdim=True).expand_as(out[-1])
        torch.testing.assert_close(out[-1], mean_v, atol=1e-5, rtol=1e-5)
    got, plain, do = _backward(q, k, v, mask, seed=kv)
    floors = [0.0, 0.0, 0.0]
    if kv == 1:
        base = 2.0 ** -20 * d ** -0.5 * (do.norm(dim=-1).max() * v.norm(dim=-1).max()).item()
        floors[:2] = base * k.abs().max().item(), base * q.abs().max().item()
    for name, a, b, floor in zip(("dq", "dk", "dv"), got, plain, floors):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, atol=max(1e-5 * b.abs().max().item(), floor),
                                   rtol=1e-5, msg=name)
    again, _, _ = _backward(q, k, v, mask, seed=kv)
    for name, a, b in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, b), name


# head dims the kernels are not built for, zero-padded to the next built
# width (bf16 64, fp32 16 or 32) and sliced back, against the plain version
# at the true d: masked, ragged, a fully-masked element
@pytest.mark.parametrize("d,dtype", [(16, torch.bfloat16), (32, torch.bfloat16),
                                     (48, torch.bfloat16), (8, torch.float32),
                                     (24, torch.float32)])
def test_padded_head_dims_match_plain(cuda_device, d, dtype):
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _qkv(cuda_device, 3, 4, 257, 131, d=d, seed=d))
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    (dq, dk, dv), plain, _ = _backward(q, k, v, mask)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * b.float().abs().max().item(), msg=name)


def test_k2_k3_fully_masked_rows_follow_the_plain_softmax(cuda_device):
    q, k, v, mask = _qkv(cuda_device, d=64)
    (dq, dk, dv), _, do = _backward(q, k, v, mask)
    assert torch.count_nonzero(dq[-1]) == 0 and torch.count_nonzero(dk[-1]) == 0
    want = (do[-1].sum(dim=1, keepdim=True) / k.shape[2]).expand_as(dv[-1])
    torch.testing.assert_close(dv[-1], want, atol=1e-5, rtol=1e-5)


def test_attention_backward_card_matches_cpu(cuda_device):
    torch.manual_seed(1)
    attn = Attention(128, dim_head=64, heads=2, qk_norm=True)
    for p in (attn.q_norm.gamma, attn.k_norm.gamma):
        torch.nn.init.constant_(p, 0.25)  # logits up to 10 d gain^2 = 40
    x = torch.randn(2, 70, 128)
    mask = torch.rand(2, 70) < 0.8
    rotary = torch.randn(70, 64)
    card = copy.deepcopy(attn).to(cuda_device)
    grads = []
    for module, dev in ((attn, "cpu"), (card, cuda_device)):
        xi = x.detach().to(dev).requires_grad_(True)
        loss = module(xi, mask=mask.to(dev), rotary_emb=rotary.to(dev)).square().mean()
        loss.backward()
        grads.append([xi.grad] + [p.grad for p in module.parameters()])
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def test_k2_k3_reject_what_they_do_not_take(cuda_device):
    q, k, v, mask = _qkv(cuda_device, d=128)
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    delta = attention_delta(q, out)
    with pytest.raises(ValueError, match="do like q"):
        flash_attention_bwd_dq(q, k, v, mask, q.bfloat16(), lse, delta, 1.0)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dkv(q, k, v, mask, q, lse[..., :-1].contiguous(), delta, 1.0)


def _k4_operands(device, m, k, n, dtype, seed=2, pitch=16):
    """A quantized (n, k) layer and x (m, k) at the row pitch a w8a16 copy's
    GEGLU writes (16 elements), at the front of a buffer that is NaN in the
    pitch and past x's end: a read past k or m shows as NaN in y."""
    gen = torch.Generator().manual_seed(seed)
    layer = torch.nn.Linear(k, n, bias=False)
    layer.weight.data = torch.randn(n, k, generator=gen) / k ** 0.5
    ql = QuantLinear(layer, "w8a16").to(device)
    ldx = -(-k // pitch) * pitch
    buf = torch.full((m * ldx + 4096,), float("nan"), dtype=dtype, device=device)
    x = buf[: m * ldx].view(m, ldx)[:, :k]
    x.copy_(torch.randn(m, k, generator=gen))
    return x, ql


# fp32: the sums' order only; bf16: also one bf16 step (2^-8 relative) of
# the output's rounding where the fp32 sums straddle a boundary
K4_TOLS = [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 2 ** -7, 1e-4)]


def _assert_k4_close(y, x, ql, rtol, atol):
    ref = w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale)
    scale = ref.float().abs().max().item()
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("dtype,rtol,atol", K4_TOLS)
@pytest.mark.parametrize("m,k,n", [(37, 200, 300), (1532, 1365, 512), (1, 512, 2730),
                                   (130, 64, 8), (1, 1365, 2730), (544, 1365, 2730),
                                   (40, 136, 273)])  # an odd n: y's rows take 2-byte stores
def test_k4_matches_plain(cuda_device, dtype, rtol, atol, m, k, n):
    x, ql = _k4_operands(cuda_device, m, k, n, dtype)
    before = w8a16_matmul.launches
    y = w8a16_matmul(x, ql.weight_q, ql.weight_scale)
    again = w8a16_matmul(x, ql.weight_q, ql.weight_scale)
    torch.cuda.synchronize()
    assert w8a16_matmul.launches == before + 2
    assert y.dtype == dtype and y.shape == (m, n)
    assert torch.equal(y, again)  # no atomics: the same bits every launch
    _assert_k4_close(y, x, ql, rtol, atol)


@pytest.mark.parametrize("tile", K4_TILES[torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(544, 512, 1536), (2112, 1365, 512), (37, 512, 2730)])
def test_k4_every_tile_matches_plain(cuda_device, tile, m, k, n):
    _, rtol, atol = K4_TOLS[1]
    x, ql = _k4_operands(cuda_device, m, k, n, torch.bfloat16)
    x2, ldx = _x_rows(x)
    y = _launch_k4(x2, ldx, ql.weight_q, ql.weight_scale, tile)
    torch.cuda.synchronize()
    _assert_k4_close(y, x, ql, rtol, atol)


# fp32 K4 at the seq2seq decode's (k, n): to_qkv, to_out and to_q, the
# feed-forward's projections, to_logits, the cross-attention's to_kv
K4_DECODE_KN = [(512, 1536), (512, 512), (512, 2730), (1365, 512), (512, 502), (512, 1024)]


@pytest.mark.parametrize("route", K4_TILES[torch.float32])
@pytest.mark.parametrize("k,n", K4_DECODE_KN)
def test_k4_fp32_routes_at_the_decode_shapes(cuda_device, route, k, n):
    """Every fp32 route at every decode (k, n): m from 1 to 33 at
    proj_out's k = 1365 (x at the pitch of 1376), the decode's m elsewhere;
    within the fp32 tolerance, NaN in x's pitch and past its last row never
    reaching y, the same bits on a second launch."""
    _, rtol, atol = K4_TOLS[0]
    for m in range(1, 34) if k == 1365 else (1, 4, 24, 32):
        x, ql = _k4_operands(cuda_device, m, k, n, torch.float32, seed=m)
        x2, ldx = _x_rows(x)
        y = _launch_k4(x2, ldx, ql.weight_q, ql.weight_scale, route)
        again = _launch_k4(x2, ldx, ql.weight_q, ql.weight_scale, route)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y).all()), (m, route)
        assert torch.equal(y, again), (m, route)
        _assert_k4_close(y, x, ql, rtol, atol)


@pytest.mark.parametrize("route", K4_TILES[torch.float32])
def test_k4_fp32_routes_take_x_at_any_pitch(cuda_device, route):
    """fp32 x whose rows are not 16-byte aligned (a contiguous (m, 1365) x:
    4-byte copies) or start off 16 bytes gives the same bits as the pitched
    x it equals."""
    x, ql = _k4_operands(cuda_device, 24, 1365, 512, torch.float32)
    dense = x.contiguous()
    shifted = torch.full((dense.numel() + 1,), float("nan"), device=cuda_device)[1:]
    shifted.copy_(dense.flatten())
    ys = [_launch_k4(*_x_rows(xi), ql.weight_q, ql.weight_scale, route)
          for xi in (x, dense, shifted.view(24, 1365))]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])


def test_k4_takes_one_contiguous_row_at_an_odd_k(cuda_device):
    """One row has no row stride to align: a contiguous (1, 1365) bf16 x,
    NaN past its end, goes through TMA."""
    _, rtol, atol = K4_TOLS[1]
    x, ql = _k4_operands(cuda_device, 1, 1365, 512, torch.bfloat16, pitch=1)
    _assert_k4_close(w8a16_matmul(x, ql.weight_q, ql.weight_scale), x, ql, rtol, atol)


def test_k4_rejects_what_it_does_not_take(cuda_device):
    x, ql = _k4_operands(cuda_device, 40, 96, 64, torch.bfloat16)
    before = w8a16_matmul.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        w8a16_matmul(x, ql.weight_q.cpu(), ql.weight_scale)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        w8a16_matmul(x.half(), ql.weight_q, ql.weight_scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a16_matmul(x[:, :90].contiguous(), ql.weight_q[:, :90].contiguous(), ql.weight_scale)
    with pytest.raises(ValueError, match="int8"):
        w8a16_matmul(x, ql.weight_q.float(), ql.weight_scale)
    # bf16 x is read through TMA: its rows must start on 16-byte boundaries
    x_odd, ql_odd = _k4_operands(cuda_device, 3, 1365, 64, torch.bfloat16, pitch=1)
    with pytest.raises(ValueError, match="16-byte"):
        w8a16_matmul(x_odd, ql_odd.weight_q, ql_odd.weight_scale)
    with pytest.raises(ValueError, match="16-byte"):
        w8a16_matmul(x.flatten()[1:3745].view(39, 96), ql.weight_q, ql.weight_scale)
    # x is never copied: rows that are not one stride apart, or not unit
    # stride along k, are refused
    wide = torch.zeros(2, 50, 96, dtype=x.dtype, device=x.device)
    with pytest.raises(ValueError, match="one stride apart"):
        w8a16_matmul(wide[:, :40], ql.weight_q, ql.weight_scale)
    with pytest.raises(ValueError, match="unit stride"):
        w8a16_matmul(x.t().contiguous().t(), ql.weight_q, ql.weight_scale)
    assert w8a16_matmul.launches == before  # no launch, and no plain fallback


def test_quantized_voicebox_card_matches_cpu(cuda_device):
    torch.manual_seed(3)
    vb = VoiceBox(num_cond_tokens=20, dim_in=24, dim_cond_emb=16, dim=64, depth=2,
                  dim_head=64, heads=1, num_register_tokens=2).eval()
    for name, p in vb.named_parameters():
        if name.endswith(("q_norm.gamma", "k_norm.gamma")):
            torch.nn.init.constant_(p, 0.25)  # logits up to 10 d gain^2 = 40
    qvb = quantize_voicebox(vb, "w8a16")
    x, cond = torch.randn(2, 50, 24), torch.randn(2, 50, 24)
    ids = torch.randint(0, 20, (2, 50))
    kw = dict(times=torch.tensor([0.2, 0.7]), cond_token_ids=ids,
              cond_drop_mask=torch.tensor([False, True]))
    with torch.no_grad():
        ref = qvb(x, cond=cond, **kw)
        card = copy.deepcopy(qvb).to(cuda_device)
        before = w8a16_matmul.launches
        out = card(x.to(cuda_device), cond=cond.to(cuda_device),
                   **{k: v.to(cuda_device) for k, v in kw.items()})
        torch.cuda.synchronize()
    assert w8a16_matmul.launches == before + 2 * 4  # depth x 4 quantized matmuls
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


# int8 mode runs `torch._int_mm` on the card (m > 16, k and n multiples of
# 8 there): x's codes are padded per call, the weight at quantization. The
# s32 sums are exact on both devices, so only the fp32 products round.
@pytest.mark.parametrize("m,k,n", [(5, 1365, 2730), (40, 512, 1536)])
def test_int8_matmul_card_matches_cpu(cuda_device, m, k, n):
    gen = torch.Generator().manual_seed(4)
    layer = torch.nn.Linear(k, n, bias=False)
    layer.weight.data = torch.randn(n, k, generator=gen)
    ql = QuantLinear(layer, "int8")
    x = torch.randn(m, k, generator=gen)
    ref = int8_matmul(x, ql.weight_q, ql.weight_scale)
    card = copy.deepcopy(ql).to(cuda_device)
    out = int8_matmul(x.to(cuda_device), card.weight_q, card.weight_scale)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)


def test_mas_on_the_card_equals_the_cpu(cuda_device):
    from voicebox_tpu_torch.ops.mas import maximum_path

    gen = torch.Generator().manual_seed(3)
    q, k = torch.randn(3, 300, 8, generator=gen) * 300, torch.randn(3, 50, 8, generator=gen) * 300
    value = torch.softmax(-5e-4 * torch.cdist(q, k).square(), dim=-1).transpose(1, 2)
    mask = ((torch.arange(50)[None, :, None] < torch.tensor([50, 33, 2])[:, None, None])
            & (torch.arange(300)[None, None, :] < torch.tensor([300, 210, 9])[:, None, None]))
    assert (value == 0).float().mean() > 0.5  # ties everywhere
    got = maximum_path(value.to(cuda_device), mask.to(cuda_device)).cpu()
    assert torch.equal(got, maximum_path(value, mask))


def test_forward_sum_loss_on_the_card_matches_the_cpu(cuda_device):
    from voicebox_tpu_torch.ops.forward_sum import forward_sum_loss

    gen = torch.Generator().manual_seed(4)
    lp = torch.randn(3, 1, 40, 12, generator=gen).log_softmax(-1)
    key_lens, query_lens = torch.tensor([12, 30, 5]), torch.tensor([40, 25, 9])  # row 1: no path
    grads = []
    for device in ("cpu", cuda_device):
        x = lp.detach().to(device).requires_grad_(True)
        loss = forward_sum_loss(x, key_lens.to(device), query_lens.to(device))
        loss.backward()
        grads.append((loss.item(), x.grad.cpu()))
    assert abs(grads[0][0] - grads[1][0]) <= 1e-5 * abs(grads[0][0])
    torch.testing.assert_close(grads[1][1], grads[0][1], atol=1e-5, rtol=1e-4)
    assert not grads[1][1][1].any()


def test_duration_training_loss_through_the_kernels_matches_the_cpu(cuda_device):
    """The predictor's training loss and gradients in fp32: K1/K2/K3 on the
    card, the plain attention on the CPU, from the same weights and span
    mask (qk gains 0.5, so rounding sets the error, not ties)."""
    from voicebox_tpu_torch.models.duration import DurationPredictor

    torch.manual_seed(5)
    dp = DurationPredictor(num_phoneme_tokens=40, dim_phoneme_emb=64, dim=64, depth=2,
                           dim_head=64, heads=2, aligner_dim_in=16, aligner_attn_channels=16)
    for name, p in dp.named_parameters():
        if name.endswith(("q_norm.gamma", "k_norm.gamma")):
            torch.nn.init.constant_(p, 0.5)
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 40, (2, 24), generator=gen)
    ids[1, 17:] = -1
    mel = torch.randn(2, 70, 16, generator=gen) * 15 - 40
    batch = dict(cond=torch.randn(2, 70, 64, generator=gen), phoneme_ids=ids, mel=mel,
                 phoneme_len=(ids >= 0).sum(-1), mel_len=torch.tensor([70, 51]),
                 phoneme_mask=ids >= 0, mel_mask=torch.arange(70)[None] < torch.tensor([[70], [51]]),
                 cond_mask=torch.rand(2, 70, generator=gen) < 0.6)
    out = {}
    for device in ("cpu", cuda_device):
        model = copy.deepcopy(dp).to(device)
        before = flash_attention_bwd_dq.launches
        loss, target = model.loss_fn(**{k: v.to(device) for k, v in batch.items()},
                                     return_aligned_phoneme_ids=True)
        loss.backward()
        launched = flash_attention_bwd_dq.launches - before
        out[str(device)] = (loss.item(), target.cpu(), {n: p.grad.cpu() for n, p in
                                                        model.named_parameters()}, launched)
    (lc, tc, gc, kc), (lg, tg, gg, kg) = out["cpu"], out[str(cuda_device)]
    assert kc == 0 and kg == 2  # K2 once a layer on the card
    assert torch.equal(tc, tg)
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    for name, g in gc.items():
        torch.testing.assert_close(gg[name], g, atol=2e-3, rtol=1e-3, msg=name)


# --- the semantic stack ----------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 512, 502), (24, 1365, 512), (512, 512, 1024),
                                   (4, 512, 2730)])
def test_k4_fp32_at_the_decode_shapes_matches_plain(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    lin = torch.nn.Linear(k, n, bias=False, device=cuda_device)
    ql = QuantLinear(lin, "w8a16")
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    before = w8a16_matmul.launches
    y = w8a16_matmul(x, ql.weight_q, ql.weight_scale)
    ref = w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale)
    torch.cuda.synchronize()
    assert w8a16_matmul.launches == before + 1
    assert torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def _t2s(device):
    from voicebox_tpu_torch.models.text_to_semantic import TextToSemantic

    torch.manual_seed(0)
    t2s = TextToSemantic(dim=128, num_semantic_token_ids=50, source_depth=2, target_depth=2,
                         heads=2, dim_head=64, device="cpu")
    with torch.no_grad():
        t2s.net.to_logits.weight[t2s.eos_id] *= 2.0
    return t2s.to(device).eval()


def test_text_to_semantic_card_matches_cpu(cuda_device):
    """Teacher-forced logits within 1e-3; greedy, speculative and w8a16
    decodes equal to the CPU's before the CPU's first top-2 logit gap under
    1e-3, with the encoder's attention through K1 and w8a16 through K4."""
    cpu, gpu = _t2s("cpu"), _t2s(cuda_device)
    text = torch.tensor(cpu.tokenizer.texts_to_tensor_ids(["hello there", "a longer line"]))
    sem = torch.randint(0, 50, (2, 30), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = flash_attention.launches
        lg = gpu.net(text.to(cuda_device), sem.to(cuda_device)).cpu()
        assert flash_attention.launches == before + 2
        ref = cpu.net(text, sem)
    assert (lg - ref).abs().max().item() <= 1e-3
    for kw in ({}, {"spec_decode": True}, {"quantize": "w8a16"}):
        r_tok, r_mask = cpu.generate(text, max_length=48, return_target_mask=True, **kw)
        net = cpu._serving_net(kw.get("quantize"), None)
        with torch.no_grad():
            logits = net(text, r_tok)[:, :48]
        logits[..., net.bos_id] = -1e9
        top2 = logits.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) < 1e-3
        first = [int(r.nonzero()[0]) if r.any() else 48 for r in tie]
        before = w8a16_matmul.launches
        tok, mask = gpu.generate(text.to(cuda_device), max_length=48, return_target_mask=True,
                                 **kw)
        assert (w8a16_matmul.launches > before) == ("quantize" in kw)
        for row, t in enumerate(first):
            assert torch.equal(tok[row, :t].cpu(), r_tok[row, :t]), (kw, row, t)
            assert torch.equal(mask[row, :t].cpu(), r_mask[row, :t]), (kw, row, t)


def test_hubert_card_matches_cpu(cuda_device):
    from voicebox_tpu_torch.models.hubert import HubertWithKmeans

    torch.manual_seed(0)
    cpu = HubertWithKmeans(num_clusters=50, conv_dim=64, dim=128, depth=2, heads=2, ff_dim=256,
                           conv_pos_kernel=16, conv_pos_groups=4)
    gpu = copy.deepcopy(cpu).to(cuda_device)
    wav = torch.randn(2, 8000, generator=torch.Generator().manual_seed(2))
    f_cpu, f_gpu = cpu.features(wav), gpu.features(wav.to(cuda_device)).cpu()
    assert (f_gpu - f_cpu).abs().max().item() <= 1e-3
    d = ((f_cpu.double()[..., None, :] - cpu.cluster_centers.double()) ** 2).sum(-1)
    d = d.sort(dim=-1).values
    tie = (d[..., 1] - d[..., 0]) < 1e-3 * d[..., 1]
    assert bool(((gpu(wav.to(cuda_device)).cpu() == cpu(wav)) | tie).all())


def test_native_reader_and_audio_dataset_feed_a_card_trainer(cuda_device, tmp_path):
    """WAV and FLAC clips read back bit for bit by the port's native reader
    on the card's machine, then `AudioDataset` of the FLAC folder feeding a
    raw-wave `VoiceBoxTrainer` on the card one step (prefetch on, the batch
    pinned and moved to the device)."""
    import importlib.util
    import pathlib
    import wave

    import numpy as np

    from voicebox_tpu_torch import (ConditionalFlowMatcherWrapper, MelVoco, VoiceBoxTrainer,
                                    native)
    from voicebox_tpu_torch.models.vocos import Vocos
    from voicebox_tpu_torch.training.data import AudioDataset

    encoder = pathlib.Path(__file__).with_name("flac_ref_encoder.py")
    spec = importlib.util.spec_from_file_location("flac_ref_encoder", encoder)
    flac = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flac)
    assert native.native_available() and native.flac_available()
    rs = np.random.RandomState(0)
    pcm = [(rs.randn(n) * 3000).astype(np.int16) for n in (4000, 4500, 5000, 3900)]
    for i, p in enumerate(pcm):
        flac.write_flac(tmp_path / f"c{i}.flac", p[None].astype(np.int64), 24000, block_size=1024)
        with wave.open(str(tmp_path / f"c{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(24000)
            w.writeframes(p.tobytes())
        for suffix, read in ((".flac", native.flac_read), (".wav", native.wav_read)):
            got, sr = read(tmp_path / f"c{i}{suffix}")
            assert sr == 24000 and np.array_equal(got, p.astype(np.float32) / 32768)

    vb = VoiceBox(audio_enc_dec=MelVoco(vocos=Vocos(input_channels=8, dim=16, intermediate_dim=24,
                                                    num_layers=1, n_fft=256, hop_length=64),
                                        n_mels=8, n_fft=256, win_length=160),
                  dim=64, depth=2, dim_head=64, heads=1, num_register_tokens=2,
                  condition_on_text=False, dtype=torch.bfloat16, param_dtype=torch.float32)
    cfm = ConditionalFlowMatcherWrapper(vb, device=cuda_device)
    trainer = VoiceBoxTrainer(cfm, batch_size=2, dataset=AudioDataset(tmp_path), valid_frac=0.0,
                              num_train_steps=1, log_every=1000, device=cuda_device)
    x, mask, _ = trainer._next_batch(trainer.dl_iter)
    assert x.device.type == mask.device.type == "cuda" and x.shape[0] == 2
    before = flash_attention.launches
    out = trainer.train_step()
    assert out["loss"].device.type == "cuda" and torch.isfinite(out["loss"]).item()
    assert flash_attention.launches > before
