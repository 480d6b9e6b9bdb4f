"""TextToSemantic: the seq2seq from text to semantic (HuBERT k-means) ids.

Counterpart of `voicebox_tpu/models/text_to_semantic.py` (the
`spear_tts_pytorch.TextToSemantic` contract the reference calls):
`generate(source, source_type="text", target_type="speech", max_length,
return_target_mask=True, ...) -> (ids, mask)`, and `wav2vec` (a
`HubertWithKmeans`) for the sampler's length algebra.

* `_Seq2Seq`: a text embedding and the bidirectional `Transformer` encoder
  (its attention is K1 on the card, K2 + K3 in its backward), then causal
  decoder blocks `dec_{i}` (RMSNorm, rotary self-attention over a KV cache,
  RMSNorm, cross-attention, RMSNorm, GEGLU feed-forward, each residual),
  `final_norm` and `to_logits` over the semantic ids + bos + eos. The
  decoder's attention is torch ops, as the JAX package's is XLA ops: its
  mask is per query row, outside K1's key-mask contract. Masked scores are
  -1e9 (not -inf), and bos's logit is set to -1e9 in every decode: bos is
  the denoiser's null-condition row.
* The KV cache is one preallocated (b, h, buf_len, d) pair per layer,
  written in place at a host-side position; a step attends to the cache up
  to its own position, so stale entries past it (rejected speculative
  writes are never rolled back) are never read. The cross-attention's k
  and v are projected once per request (`precompute_cross_kv`).
* `generate` routes: plain greedy or temperature decode; greedy
  self-speculative decode (the first `spec_decode_draft_layers` blocks as
  an early-exit draft proposes `gamma` tokens, one chunk of the full model
  verifies them; the batch advances by its smallest accepted prefix + 1,
  so every token equals plain greedy's); sampled speculative decode
  (accept with min(1, p/q), resample from norm(max(0, p - q)), Leviathan et
  al. 2022); `param_store_dtype` and `quantize` ("w8a16": K4 on every
  decoder and head matmul; "int8": `torch._int_mm`) serve a cached copy.
  The plain decode stops once every row has emitted eos (checked every 16
  steps) where the JAX package runs all `max_length` steps; the tokens and
  mask are the same over the whole buffer. The speculative loop reads the
  accepted count and the done flag from the device once per round.
  `decode_stats` keeps the last decode's positions, rounds (steps, or
  draft + verify rounds) and accepted draft tokens.

Randomness comes from `generator` (Gumbel-max draws; `torch.Generator` and
`jax.random` never agree, so sampled routes match the JAX package in
distribution only). Save and load use the port's own `.pt`
(`{"model": state_dict}`); `utils/convert.py::text_to_semantic_state_dict`
maps JAX parameters to its keys. The module moves to `device` (the card
unless the caller asks for the CPU), its `wav2vec` with it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QUANT_MODES, cast_float_params, quantize_seq2seq
from ..utils.tokenizer import Tokenizer
from .cfm import resolve_device
from .primitives import GEGLU, Linear, RMSNorm, RotaryEmbedding, rotate_half
from .transformer import Transformer

__all__ = ["TextToSemantic", "speculative_rejection"]

_NEG = -1e9
_DONE_CHECK_EVERY = 16  # plain decode: host reads of "all rows done"

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def _rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary in fp32 (`apply_rotary_pos_emb` with the table's cos and sin
    taken once per call of the decoder)."""
    t32 = t.float()
    out = t32 * cos + rotate_half(t32) * sin
    return out if out.dtype == t.dtype else out.to(t.dtype)


class _CachedSelfAttention(nn.Module):
    """Causal self-attention over the whole sequence (training) or a chunk of
    n >= 1 tokens at `position` against the KV cache (decode)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Linear(dim, heads * dim_head * 3, bias=False, dtype=dtype)
        self.to_out = Linear(heads * dim_head, dim, bias=False, dtype=dtype)

    def forward(self, x, cos, sin, position: Optional[int] = None, cache=None):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, n, 3, h, d)
        # q and k rotated together: (b, n, 2, h, d) against the (n, d) table
        qk = _rotate(qkv[:, :, :2], cos[:, None, None], sin[:, None, None])
        q, k = qk.unbind(dim=2)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
        if cache is None:
            sim = (q @ k.transpose(-1, -2)) * d ** -0.5
            causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            sim = sim.masked_fill(~causal, _NEG)
            out = sim.softmax(dim=-1) @ v
        else:
            k_buf, v_buf = cache
            end = position + n
            k_buf[:, :, position:end] = k
            v_buf[:, :, position:end] = v
            sim = (q @ k_buf[:, :, :end].transpose(-1, -2)) * d ** -0.5
            if n > 1:  # row i (at position + i) sees keys j <= position + i
                keys = torch.arange(end, device=x.device)
                rows = torch.arange(position, end, device=x.device)
                sim = sim.masked_fill(keys[None, :] > rows[:, None], _NEG)
            out = sim.softmax(dim=-1) @ v_buf[:, :, :end]
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class _CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, heads * dim_head, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, heads * dim_head * 2, bias=False, dtype=dtype)
        self.to_out = Linear(heads * dim_head, dim, bias=False, dtype=dtype)

    def kv(self, context):
        """(k, v), each (b, h, m, d): projected once per request, since the
        context does not change while decoding."""
        b, m, _ = context.shape
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return tuple(t.reshape(b, m, self.heads, self.dim_head).transpose(1, 2) for t in (k, v))

    def forward(self, x, context=None, context_mask=None, kv=None):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        k, v = self.kv(context) if kv is None else kv
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        sim = (q @ k.transpose(-1, -2)) * d ** -0.5
        if context_mask is not None:  # (b, m) True = attend, or its (b, 1, 1, m) inverse
            pad = context_mask if context_mask.dim() == 4 else ~context_mask[:, None, None, :]
            sim = sim.masked_fill(pad, _NEG)
        out = sim.softmax(dim=-1) @ v
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class _FeedForward(nn.Module):
    """GEGLU MLP under the JAX package's names (`proj_in`, `proj_out`)."""

    def __init__(self, dim: int, mult: float = 4.0, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.proj_in = Linear(dim, inner * 2, dtype=dtype)
        self.act = GEGLU()
        self.proj_out = Linear(inner, dim, dtype=dtype)

    def forward(self, x):
        return self.proj_out(self.act(self.proj_in(x)))


class _DecoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.self_norm = RMSNorm(dim)
        self.self_attn = _CachedSelfAttention(dim, heads, dim_head, dtype)
        self.cross_norm = RMSNorm(dim)
        self.cross_attn = _CrossAttention(dim, heads, dim_head, dtype)
        self.ff_norm = RMSNorm(dim)
        self.ff = _FeedForward(dim, ff_mult, dtype)

    def forward(self, x, cos, sin, context=None, context_mask=None, position=None, cache=None,
                cross_kv=None):
        x = x + self.self_attn(self.self_norm(x), cos, sin, position=position, cache=cache)
        x = x + self.cross_attn(self.cross_norm(x), context, context_mask, kv=cross_kv)
        return x + self.ff(self.ff_norm(x))


class _Seq2Seq(nn.Module):
    """`forward`: teacher-forced logits; `decode_step` / `decode_chunk`: the
    cached decode."""

    def __init__(self, num_text_tokens: int, num_semantic_tokens: int, dim: int = 512,
                 enc_depth: int = 6, dec_depth: int = 6, heads: int = 8, dim_head: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.num_semantic_tokens = num_semantic_tokens
        self.heads, self.dim_head, self.dec_depth = heads, dim_head, dec_depth
        self.text_embed = nn.Embedding(num_text_tokens, dim)
        self.encoder = Transformer(dim=dim, depth=enc_depth, dim_head=dim_head, heads=heads,
                                   dtype=dtype)
        self.sem_embed = nn.Embedding(num_semantic_tokens + 2, dim)  # + bos + eos
        for i in range(dec_depth):
            self.add_module(f"dec_{i}", _DecoderBlock(dim, heads, dim_head, dtype=dtype))
        self.final_norm = RMSNorm(dim)
        self.to_logits = Linear(dim, num_semantic_tokens + 2, bias=False)
        self.rotary_emb = RotaryEmbedding(dim_head)

    @property
    def bos_id(self) -> int:
        return self.num_semantic_tokens

    @property
    def eos_id(self) -> int:
        return self.num_semantic_tokens + 1

    @property
    def blocks(self) -> List[_DecoderBlock]:
        return [getattr(self, f"dec_{i}") for i in range(self.dec_depth)]

    def _rotary(self, start: int, n: int, device):
        pos = self.rotary_emb(torch.arange(start, start + n, device=device))
        return pos.cos(), pos.sin()

    def encode_text(self, text_ids, text_mask=None):
        if text_mask is None:
            text_mask = text_ids != -1
        x = self.text_embed(text_ids.clamp_min(0))
        return self.encoder(x, mask=text_mask), text_mask

    def forward(self, text_ids, semantic_ids, text_mask=None):
        """Teacher-forced logits (b, n_sem + 1, vocab): the input is [bos,
        sem...], the targets [sem..., eos]."""
        context, text_mask = self.encode_text(text_ids, text_mask)
        bos = semantic_ids.new_full((semantic_ids.shape[0], 1), self.bos_id)
        x = self.sem_embed(torch.cat([bos, semantic_ids.clamp_min(0)], dim=1))
        cos, sin = self._rotary(0, x.shape[1], x.device)
        for block in self.blocks:
            x = block(x, cos, sin, context, text_mask)
        return self.to_logits(self.final_norm(x))

    def precompute_cross_kv(self, context):
        return [block.cross_attn.kv(context) for block in self.blocks]

    def new_caches(self, batch: int, length: int, device, n_layers: Optional[int] = None) -> Cache:
        shape = (batch, self.heads, length, self.dim_head)
        return [(torch.zeros(shape, device=device), torch.zeros(shape, device=device))
                for _ in range(self.dec_depth if n_layers is None else n_layers)]

    def decode_chunk(self, tokens, position: int, caches: Cache, context, text_mask,
                     num_layers: Optional[int] = None, cross_kvs=None):
        """tokens (b, n) at positions [position, position + n) -> logits
        (b, n, vocab); the caches are written in place. `num_layers` runs the
        first blocks only (the early-exit draft, through the full model's
        norm and head)."""
        blocks = self.blocks[:num_layers]
        if cross_kvs is None:
            cross_kvs = [None] * len(blocks)
        x = self.sem_embed(tokens)
        cos, sin = self._rotary(position, tokens.shape[1], tokens.device)
        for block, cache, ckv in zip(blocks, caches, cross_kvs):
            x = block(x, cos, sin, context, text_mask, position=position, cache=cache,
                      cross_kv=ckv)
        logits = self.to_logits(self.final_norm(x))
        logits[..., self.bos_id] = _NEG  # bos is the denoiser's null-condition row
        return logits

    def decode_step(self, token, position: int, caches: Cache, context, text_mask,
                    cross_kvs=None):
        """One step: token (b,) -> logits (b, vocab)."""
        return self.decode_chunk(token[:, None], position, caches, context, text_mask,
                                 cross_kvs=cross_kvs)[:, 0]


def _gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))


def _categorical(logits, generator):
    """One draw per row from softmax(logits) (Gumbel-max)."""
    return (logits.float() + _gumbel(logits.shape, generator, logits.device)).argmax(dim=-1)


def speculative_rejection(logps, logqs, proposals, u_accept, u_resample):
    """The rejection step of sampled speculative decoding on one round.

    logps (b, gamma + 1, v) and logqs (b, gamma, v): the full model's and the
    draft's log-probabilities at temperature; proposals (b, gamma); u_accept
    (b, gamma) and u_resample (b,) uniforms. Draft token i is accepted while
    u < p(d_i) / q(d_i); the batch keeps the smallest accepted prefix k. At
    slot k a row that accepted more keeps its own draft, another samples the
    residual norm(max(0, p - q)) (p itself when k == gamma or the residual
    vanishes) by inverse CDF at u_resample. Returns (k (scalar tensor),
    per-row accepted counts (b,), the token at slot k (b,))."""
    b, gamma = proposals.shape
    lp_d = logps[:, :gamma].gather(-1, proposals[..., None])[..., 0]
    lq_d = logqs.gather(-1, proposals[..., None])[..., 0]
    accept = torch.log(u_accept.clamp_min(1e-20)) < (lp_d - lq_d)
    k_b = accept.long().cumprod(dim=1).sum(dim=1)
    k = k_b.min()
    rows = torch.arange(b, device=proposals.device)
    p_slot = logps[rows, k.expand(b)].exp()
    q_slot = logqs[rows, k.clamp_max(gamma - 1).expand(b)].exp()
    residual = (p_slot - q_slot).clamp_min(0.0)
    use_p = (k == gamma) | (residual.sum(dim=-1, keepdim=True) < 1e-9)
    residual = torch.where(use_p, p_slot, residual)
    cdf = residual.cumsum(dim=-1)
    res_tok = (cdf < u_resample[:, None] * cdf[:, -1:]).sum(dim=-1).clamp_max(cdf.shape[-1] - 1)
    padded = F.pad(proposals, (0, 1))
    own = padded[rows, k.clamp_max(gamma).expand(b)]
    return k, k_b, torch.where(k_b > k, own, res_tok)


class TextToSemantic(nn.Module):
    """The spear-tts usage surface over `net` (a `_Seq2Seq`)."""

    def __init__(
        self,
        *,
        dim: int = 512,
        num_text_token_ids: Optional[int] = None,
        num_semantic_token_ids: Optional[int] = None,
        source_depth: int = 6,
        target_depth: int = 6,
        heads: int = 8,
        dim_head: int = 64,
        wav2vec=None,
        tokenizer=None,
        device="cuda",
    ):
        super().__init__()
        self.__dict__["wav2vec"] = wav2vec  # frozen: not a registered submodule
        self.tokenizer = tokenizer if tokenizer is not None else Tokenizer()
        if num_text_token_ids is None:
            num_text_token_ids = self.tokenizer.vocab_size
        if num_semantic_token_ids is None:
            if wav2vec is None:
                raise ValueError("pass num_semantic_token_ids or a wav2vec with a codebook size")
            num_semantic_token_ids = wav2vec.codebook_size
        self.net = _Seq2Seq(num_text_token_ids, num_semantic_token_ids, dim=dim,
                            enc_depth=source_depth, dec_depth=target_depth, heads=heads,
                            dim_head=dim_head)
        self._serving_copy = None  # (weights key, cast and/or quantized net)
        self.to(resolve_device(device))

    def _apply(self, fn, recurse=True):
        if self.wav2vec is not None:  # the frozen front end moves with the model
            self.wav2vec._apply(fn, recurse)
        return super()._apply(fn, recurse)

    @property
    def eos_id(self) -> int:
        return self.net.eos_id

    @property
    def device(self) -> torch.device:
        return self.net.to_logits.weight.device

    # ------------------------------------------------------------------

    def loss_fn(self, text_ids, semantic_ids, text_mask=None, semantic_mask=None):
        """Teacher-forced cross-entropy, with eos taught at each row's true
        length (ids of -1 are padding)."""
        logits = self.net(text_ids, semantic_ids, text_mask)
        if semantic_mask is None:
            semantic_mask = semantic_ids != -1
        b, n = semantic_ids.shape
        lengths = semantic_mask.sum(dim=-1)
        pos = torch.arange(n + 1, device=logits.device)[None]
        base = F.pad(semantic_ids.clamp_min(0), (0, 1))
        targets = torch.where(pos == lengths[:, None], self.net.eos_id, base)
        tmask = pos <= lengths[:, None]
        logp = logits.float().log_softmax(dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        nll = torch.where(tmask, nll, torch.zeros_like(nll))
        return nll.sum() / tmask.sum().clamp_min(1)

    # ------------------------------------------------------------------

    def _serving_net(self, quantize: Optional[str], param_store_dtype) -> _Seq2Seq:
        """The net, or a copy with its parameters cast to `param_store_dtype`
        and then its decoder and head matmuls quantized, cached per weights
        version (each parameter's storage and version counter)."""
        if quantize is None and param_store_dtype is None:
            return self.net
        if quantize is not None and quantize not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r} (use one of {QUANT_MODES})")
        key = (quantize, param_store_dtype,
               tuple((p.data_ptr(), p._version) for p in self.net.parameters()))
        if self._serving_copy is not None and self._serving_copy[0] == key:
            return self._serving_copy[1]
        self._serving_copy = None
        served = self.net if param_store_dtype is None else cast_float_params(
            self.net, param_store_dtype)
        if quantize is not None:
            served = quantize_seq2seq(served, quantize)
        self._serving_copy = (key, served.eval())
        return served

    def _source_ids(self, source) -> torch.Tensor:
        if isinstance(source, (list, tuple)) and isinstance(source[0], str):
            source = self.tokenizer.texts_to_tensor_ids(list(source))
        if not torch.is_tensor(source):
            source = torch.from_numpy(np.asarray(source))
        return source.to(self.device).long()

    @staticmethod
    def _finish(tokens, eos_id):
        """Mask of the positions before each row's first eos; tokens there,
        0 elsewhere."""
        is_eos = tokens == eos_id
        mask = is_eos.long().cumsum(dim=1) == 0
        return torch.where(mask, tokens, torch.zeros_like(tokens)), mask

    @staticmethod
    def _prefill(net, ids):
        """The encoder's context, the cross-attention's padding (the text
        mask inverted once per request) and its k, v per decoder block."""
        context, text_mask = net.encode_text(ids)
        return context, ~text_mask[:, None, None, :], net.precompute_cross_kv(context)

    def _decode_plain(self, net, ids, max_length: int, temperature: float, generator):
        context, pad, cross = self._prefill(net, ids)
        b = ids.shape[0]
        caches = net.new_caches(b, max_length, ids.device)
        eos = net.eos_id
        tokens = torch.full((b, max_length), eos, dtype=torch.long, device=ids.device)
        token = torch.full((b,), net.bos_id, dtype=torch.long, device=ids.device)
        done = torch.zeros(b, dtype=torch.bool, device=ids.device)
        for i in range(max_length):
            logits = net.decode_step(token, i, caches, context, pad, cross)
            if temperature == 0.0:
                token = logits.argmax(dim=-1)
            else:
                token = _categorical(logits / temperature, generator)
            tokens[:, i] = torch.where(done, eos, token)
            done = done | (token == eos)
            if (i + 1) % _DONE_CHECK_EVERY == 0 and bool(done.all()):
                break  # every later token is eos, as the buffer already holds
        self.decode_stats = {"positions": i + 1, "rounds": i + 1, "accepted": 0}
        return self._finish(tokens, eos)

    def _decode_spec(self, net, ids, max_length: int, gamma: int, draft_layers: int,
                     temperature: float, generator):
        """Speculative decode: greedy when temperature == 0, else sampled."""
        context, pad, cross = self._prefill(net, ids)
        b, device = ids.shape[0], ids.device
        caches = net.new_caches(b, max_length + gamma + 1, device)
        eos = net.eos_id
        buf = torch.full((b, max_length + gamma + 1), eos, dtype=torch.long, device=device)
        last = torch.full((b,), net.bos_id, dtype=torch.long, device=device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        idx = torch.arange(gamma + 1, device=device)[None]
        rows = torch.arange(b, device=device)
        inv_t = 1.0 / max(temperature, 1e-6)
        p, stats = 0, {"positions": 0, "rounds": 0, "accepted": 0, "gamma": gamma}
        while p < max_length:
            tok, proposals, logqs = last, [], []
            for j in range(gamma):  # the draft writes the first layers' cache in place
                logits = net.decode_chunk(tok[:, None], p + j, caches[:draft_layers], context,
                                          pad, num_layers=draft_layers,
                                          cross_kvs=cross[:draft_layers])[:, 0]
                if temperature == 0.0:
                    tok = logits.argmax(dim=-1)
                else:
                    logq = (logits * inv_t).float().log_softmax(dim=-1)
                    tok = _categorical(logq, generator)
                    logqs.append(logq)
                proposals.append(tok)
            proposals = torch.stack(proposals, dim=1)
            chunk = torch.cat([last[:, None], proposals], dim=1)
            logits = net.decode_chunk(chunk, p, caches, context, pad, cross_kvs=cross)
            if temperature == 0.0:
                g = logits.argmax(dim=-1)
                k = (g[:, :gamma] == proposals).long().cumprod(dim=1).sum(dim=1).min()
                at_k = g[rows, k.expand(b)]
            else:
                u_accept = torch.rand((b, gamma), generator=generator, device=device)
                u_res = torch.rand((b,), generator=generator, device=device)
                k, _, at_k = speculative_rejection(
                    (logits * inv_t).float().log_softmax(dim=-1), torch.stack(logqs, dim=1),
                    proposals, u_accept, u_res)
            slab = torch.where(idx < k, F.pad(proposals, (0, 1)),
                               torch.where(idx == k, at_k[:, None], eos))
            # eos inside the emitted part (idx <= k) ends the row; the tail is padding
            hit = (((slab == eos) & (idx <= k)).long().cumsum(dim=1) > 0)
            prev_hit = F.pad(hit[:, :-1], (1, 0))
            slab = torch.where(done[:, None] | prev_hit, eos, slab)
            done = done | hit[:, -1]
            buf[:, p:p + gamma + 1] = slab
            last = torch.where(done, eos, slab[rows, k.expand(b)])
            k_host, all_done = torch.stack([k, done.all().long()]).tolist()
            p += k_host + 1
            stats["rounds"] += 1
            stats["accepted"] += k_host
            if all_done:
                break
        self.decode_stats = dict(stats, positions=min(p, max_length))
        return self._finish(buf[:, :max_length], eos)

    @torch.no_grad()
    def generate(
        self,
        source,
        *,
        source_type: str = "text",
        target_type: str = "speech",
        max_length: int = 2048,
        return_target_mask: bool = False,
        temperature: float = 0.0,
        spec_decode: bool = False,
        spec_decode_gamma: int = 5,
        spec_decode_draft_layers: Optional[int] = None,
        quantize: Optional[str] = None,
        param_store_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        """Semantic ids (b, max_length) from text (strings, or ids padded
        with -1), 0 after each row's first eos; with `return_target_mask`
        also the mask of the ids before it. `spec_decode_draft_layers`
        defaults to half the decoder."""
        if source_type != "text" or target_type != "speech":
            raise ValueError("only the text -> speech (semantic) direction is implemented, the "
                             "one the CFM wrapper uses")
        net = self._serving_net(quantize, param_store_dtype)
        ids = self._source_ids(source)
        if spec_decode:
            draft = spec_decode_draft_layers or max(1, net.dec_depth // 2)
            tokens, mask = self._decode_spec(net, ids, int(max_length), int(spec_decode_gamma),
                                             int(draft), float(temperature), generator)
        else:
            tokens, mask = self._decode_plain(net, ids, int(max_length), float(temperature),
                                              generator)
        return (tokens, mask) if return_target_mask else tokens

    # ------------------------------------------------------------------

    def save(self, path) -> dict:
        """`torch.save({"model": state_dict})` of the seq2seq (fp32 on the
        CPU)."""
        pkg = {"model": {k: v.detach().to("cpu", copy=True)
                         for k, v in self.state_dict().items()}}
        torch.save(pkg, str(path))
        return pkg

    def load(self, path, strict: bool = True) -> dict:
        """Restore weights written by `save`. There is no map from upstream
        spear-tts checkpoints, as in the JAX package."""
        pkg = torch.load(str(path), map_location="cpu", weights_only=True)
        self.load_state_dict(pkg["model"], strict=strict)
        return pkg
