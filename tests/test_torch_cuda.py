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
    reference_attention,
    reference_attention_backward,
)
from voicebox_tpu_torch.ops.quant import (
    QuantLinear,
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
    torch.backends.cuda.matmul.allow_tf32 = False
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
@pytest.mark.parametrize("d", [64, 128])
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
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
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


def _k4_operands(device, m, k, n, dtype, seed=2):
    gen = torch.Generator().manual_seed(seed)
    layer = torch.nn.Linear(k, n, bias=False)
    layer.weight.data = torch.randn(n, k, generator=gen) / k ** 0.5
    ql = QuantLinear(layer, "w8a16").to(device)
    x = torch.randn(m, k, generator=gen).to(device=device, dtype=dtype)
    return x, ql


# fp32: the sums' order only; bf16: also one bf16 step (2^-8 relative) of
# the output's rounding where the fp32 sums straddle a boundary
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 2 ** -7, 1e-4)])
@pytest.mark.parametrize("m,k,n", [(37, 200, 300), (1532, 1365, 512), (1, 512, 2730),
                                   (130, 64, 8)])
def test_k4_matches_plain(cuda_device, dtype, rtol, atol, m, k, n):
    x, ql = _k4_operands(cuda_device, m, k, n, dtype)
    before = w8a16_matmul.launches
    y = w8a16_matmul(x, ql.weight_q, ql.weight_scale)
    ref = w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale)
    torch.cuda.synchronize()
    assert w8a16_matmul.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    scale = ref.float().abs().max().item()
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol * scale)


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
