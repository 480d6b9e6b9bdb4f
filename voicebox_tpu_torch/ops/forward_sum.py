"""The forward-sum alignment loss: CTC over the aligner's log-probabilities
with a blank.

Counterpart of `voicebox_tpu/ops/forward_sum.py` (NS2's `ForwardSumLoss`),
by `F.ctc_loss` where the JAX package runs `optax.ctc_loss`:

* a blank column at logit `blank_logprob` (-1) first, the keys at 1..K;
* keys beyond each row's `key_lens` at -1e9, then `log_softmax` over the
  t_ph + 1 columns, (T, B, C) into `F.ctc_loss` with targets 1..K;
* a row that cannot align (key_len > query_len) gives 0, by a select as the
  JAX package writes it, not by `zero_infinity`, which would also zero NaN.
  Its target length goes to 0 inside the CTC so that the row's (discarded)
  value and gradient stay finite;
* the per-row loss divided by its key length (at least 1), then the batch
  mean (CTCLoss's "mean").

CUDA's `ctc_loss` backward is not deterministic, so a training step through
it on the card is not bit-reproducible; on the CPU it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["forward_sum_loss"]

_NEG = -1e9


def forward_sum_loss(attn_logprob: torch.Tensor, key_lens: torch.Tensor,
                     query_lens: torch.Tensor, blank_logprob: float = -1.0) -> torch.Tensor:
    """attn_logprob (b, 1, t_mel, t_ph) or (b, t_mel, t_ph), key_lens (b,)
    phoneme lengths, query_lens (b,) mel lengths -> scalar fp32 loss."""
    if attn_logprob.dim() == 4:
        attn_logprob = attn_logprob[:, 0]
    b, t_mel, t_ph = attn_logprob.shape
    key_lens = key_lens.to(torch.int64)
    query_lens = query_lens.to(torch.int64)
    logits = F.pad(attn_logprob.float(), (1, 0), value=blank_logprob)
    key_idx = torch.arange(t_ph + 1, device=logits.device)
    logits = logits.masked_fill(key_idx[None, None, :] > key_lens[:, None, None], _NEG)
    log_probs = logits.log_softmax(dim=-1).transpose(0, 1)  # (t_mel, b, t_ph + 1)
    targets = torch.arange(1, t_ph + 1, device=logits.device).expand(b, t_ph)
    feasible = key_lens <= query_lens
    per_sample = F.ctc_loss(log_probs, targets, query_lens,
                            torch.where(feasible, key_lens, torch.zeros_like(key_lens)),
                            blank=0, reduction="none", zero_infinity=False)
    per_sample = torch.where(feasible, per_sample, torch.zeros_like(per_sample))
    return (per_sample / key_lens.float().clamp_min(1.0)).mean()
