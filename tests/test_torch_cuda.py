"""K1, K2, K3 and the port's attention on an NVIDIA GPU, against the plain
PyTorch versions. Marked `cuda`: every test skips without a card. The file
imports no jax, so on a GPU machine without jax it runs with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
"""

import copy

import pytest
import torch

from voicebox_tpu_torch.models.attention import Attention
from voicebox_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    reference_attention,
    reference_attention_backward,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1, K2 and K3 run only on an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, b=2, h=4, n=257, kv=200, d=128, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, n, d, generator=gen, device=device)
    k, v = (torch.randn(b, h, kv, d, generator=gen, device=device) for _ in range(2))
    mask = torch.rand(b, kv, generator=gen, device=device) < 0.7
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


# bf16: P and out are each rounded to bf16 on both sides, in another order
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
def test_k1_matches_plain(cuda_device, dtype, tol, d):
    q, k, v, mask = _qkv(cuda_device, d=d)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(out[-1])
    torch.testing.assert_close(out[-1].float(), mean_v, atol=tol, rtol=tol)


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
# than the plain version's sums; fp32: rounding only
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
def test_k2_k3_match_plain_backward(cuda_device, dtype, tol, d):
    q, k, v, mask = (t.to(dtype) if t.is_floating_point() else t
                     for t in _qkv(cuda_device, d=d))
    got, ref, _ = _backward(q, k, v, mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol * b.float().abs().max().item(),
                                   rtol=tol, msg=name)


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
