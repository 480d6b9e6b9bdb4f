"""Pipeline parallelism for the Transformer backbone: the V-cycle over a
"pipe" process group.

Counterpart of `voicebox_tpu/parallel/pipeline.py`. The JAX package runs
the pipeline as one SPMD program (`shard_map` over a "pipe" mesh axis, a
`lax.scan` over the schedule, `ppermute` between stages); here each stage
is a process and the schedule is a Python loop whose traffic is one
`neighbour_exchange` a step.

The U-Net pipelines as a V-cycle. Activations go up the stages through the
first-half layers (stage 0 -> S-1), then back down through the
second-half layers (S-1 -> 0), the top stage turning its own front output
round. For depth / 2 = S k, stage i holds front rows [i k, (i+1) k) and
the mirrored back rows [(S-1-i) k, (S-i) k) of the second half
(`mirror_back_rows`), so every skip starts and ends on one stage: a stage
keeps its own skips until the microbatch comes back down, and no skip
crosses between ranks. With M microbatches the schedule takes T = M + 2S -
1 steps; at step t stage i runs front rows on microbatch t - i and back
rows on microbatch t - (2S-1-i). Its bubble is (2S-1) / (M+2S-1). Where a
stage's microbatch index is out of range it computes nothing (JAX computes
garbage there because SPMD must), so a stage launches exactly 2k M
attention forwards, and backward 2k M of each attention gradient kernel.

Rank 0 prepends the registers (rotary position -10000, never masked),
strips them after the last back row and applies `final_norm`. Each rank's
device holds only its own 2k layers, plus the registers and the final norm
on rank 0 (`make_pp_forward` moves them there; the other layers stay where
the caller built them). Each microbatch's result is the unpipelined
`transformer(x[m], mask[m], cond[m])`: the same layers
(`Transformer.layer_forward`, with remat and GateLoop per row) on the same
shapes.

Differentiable. The forward keeps each step's graph, its inputs cut off
(`detach`); the backward (`_VCycle.backward`) walks the steps in reverse,
passing the gradients of the activations down and up by the same
`neighbour_exchange`, so every rank makes the same collective calls in the
same order in both directions and nothing depends on the order in which
autograd visits the ranks. A stage that skipped a step sends nothing
there. The adaptive-norm condition's gradient is summed over the stages.

Usage, on every rank of the group (the same inputs everywhere; only rank
0's x is read)::

    tr = Transformer(dim=..., depth=..., ...)       # built on the CPU
    fn = make_pp_forward(tr, group, num_microbatches=M)
    y = fn(x, mask, cond)                           # x: (M, b, n, dim)
    loss = y.square().mean()                        # rank 0's is the model's
    loss.backward()                                 # on every rank

On ranks other than 0 the result is zeros of the same shape, so every rank
can run the same loss and backward.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import all_reduce, neighbour_exchange
from .sequence_parallel import current_shard

__all__ = ["make_pp_forward", "mirror_back_rows", "stage_layers"]


def mirror_back_rows(half: int, num_stages: int) -> List[int]:
    """The second half's rows in stage order: stage i's k = half / S rows
    are [(S-1-i) k, (S-i) k), the mirror of its front rows, so its own
    skips feed them (the order JAX's `mirror_back_rows` gives the
    `layers_back` stack)."""
    if half % num_stages:
        raise ValueError(f"depth/2 ({half}) must divide by the pipeline stages ({num_stages})")
    k = half // num_stages
    return [r for i in range(num_stages) for r in range((num_stages - 1 - i) * k,
                                                         (num_stages - i) * k)]


def stage_layers(depth: int, num_stages: int, stage: int) -> Tuple[List[int], List[int]]:
    """`layers.{i}` indices of a stage's front rows and back rows, each in
    the order the stage runs them."""
    half = depth // 2
    order = mirror_back_rows(half, num_stages)
    k = half // num_stages
    return (list(range(stage * k, (stage + 1) * k)),
            [half + r for r in order[stage * k:(stage + 1) * k]])


class _Stage:
    """One rank's part of the V-cycle: its rows, its group, the schedule."""

    def __init__(self, transformer, group, num_microbatches: int, device):
        self.tr, self.group, self.device = transformer, group, device
        self.S, self.i = dist.get_world_size(group), dist.get_rank(group)
        self.M = num_microbatches
        self.T = self.M + 2 * self.S - 1
        self.front, self.back = stage_layers(transformer.depth, self.S, self.i)
        self.skips = transformer.layers[self.back[0]][0] is not None
        self.front_params = [p for i in self.front for p in transformer.layers[i].parameters()]
        self.back_params = [p for i in self.back for p in transformer.layers[i].parameters()]

    def m_front(self, stage: int, t: int) -> Optional[int]:
        m = t - stage
        return m if 0 <= m < self.M else None

    def m_back(self, stage: int, t: int) -> Optional[int]:
        m = t - (2 * self.S - 1 - stage)
        return m if 0 <= m < self.M else None

    def sends_up(self, stage: int, t: int) -> bool:
        """Whether `stage` sends its front output of step t to the next."""
        return stage < self.S - 1 and self.m_front(stage, t) is not None

    def sends_down(self, stage: int, t: int) -> bool:
        return stage > 0 and self.m_back(stage, t) is not None

    def busy(self, t: int) -> bool:
        return any(self.sends_up(j, t) or self.sends_down(j, t) for j in range(self.S))

    def run_front(self, x, mask, rotary, cond):
        """The front rows; returns the output and the skips they push (each
        row's input). The input enters as a view, a node of its own, so that
        the backward seeds its skip's gradient there before the first row's
        join it: the order in which one process sums them (in bf16 the
        order moves the bits)."""
        x, pushed = x.view_as(x), []
        for i in self.front:
            pushed.append(x)
            x = self.tr.layer_forward(i, x, None, mask, rotary, cond)
        return x, pushed

    def run_back(self, x, skips, mask, rotary, cond):
        """The back rows, popping this stage's skips in reverse."""
        for j, i in enumerate(self.back):
            x = self.tr.layer_forward(i, x, skips[-1 - j] if self.skips else None, mask,
                                      rotary, cond)
        return x

    def exchange(self, t: int, up, down, like_up, like_down):
        """Step t's traffic: `up` to the next stage, `down` to the previous;
        returns (from the previous, from the next), each like its template
        where that neighbour sends at step t."""
        if self.S == 1 or not self.busy(t):
            return None, None
        i = self.i
        return neighbour_exchange(
            self.group, self.device, to_next=up if self.sends_up(i, t) else None,
            to_prev=down if self.sends_down(i, t) else None,
            from_prev=like_up if i > 0 and self.sends_up(i - 1, t) else None,
            from_next=like_down if i < self.S - 1 and self.sends_down(i + 1, t) else None)


def _pick(t: Optional[torch.Tensor], m: int):
    return None if t is None else t[m]


def _run(stage: _Stage, x, mask, cond, rotary, like, grad: bool):
    """The forward schedule. `x` (M, b, n, dim) is read on stage 0; `like`
    is a template of the activations, (b, n, dim) in the dtype of the front
    and of the back rows' outputs. Returns the outputs (M, b, n, dim) on
    stage 0 (zeros elsewhere, so that every rank runs the same loss) and,
    with `grad`, each step's record."""
    S, i = stage.S, stage.i
    like_f, like_b = like
    outs = [None] * stage.M if i == 0 else None
    kept, tape = {}, []
    x_f = x_b = y_f_last = None

    def leaf(t):
        return t.detach().requires_grad_(grad)

    for t in range(stage.T):
        m_f, m_b, rec = stage.m_front(i, t), stage.m_back(i, t), {}
        y_f = y_b = None
        if m_f is not None:
            inp = leaf(x[m_f] if i == 0 else x_f)
            c = None if cond is None else leaf(cond[m_f])
            y_f, pushed = stage.run_front(inp, _pick(mask, m_f), rotary, c)
            if stage.skips:
                kept[m_f] = pushed
            rec["f"] = (m_f, inp, c, y_f, pushed)
        if m_b is not None:
            inp = leaf(y_f_last if i == S - 1 else x_b)
            c = None if cond is None else leaf(cond[m_b])
            skips = [leaf(s) for s in kept.pop(m_b)] if stage.skips else []
            y_b = stage.run_back(inp, skips, _pick(mask, m_b), rotary, c)
            rec["b"] = (m_b, inp, c, y_b, skips)
            if i == 0:
                outs[m_b] = y_b.detach()
        for y, want in ((y_f, like_f), (y_b, like_b)):
            if y is not None and y.dtype != want.dtype:
                raise RuntimeError(f"a stage's output is {y.dtype}, the pipeline expected "
                                   f"{want.dtype}")
        if grad:
            tape.append(rec)
        x_f, x_b = stage.exchange(t, y_f, y_b, like_f, like_b)
        y_f_last = y_f
    if outs is None:
        return like_b.new_zeros((stage.M, *like_b.shape)), tape
    return torch.stack(outs), tape


class _VCycle(torch.autograd.Function):
    """The schedule as one autograd node; its backward runs the schedule's
    steps in reverse (see the module docstring)."""

    @staticmethod
    def forward(ctx, stage, like, x, mask, cond, rotary, *params):
        with torch.enable_grad():
            out, tape = _run(stage, x, mask, cond, rotary, like, grad=True)
        ctx.stage, ctx.tape, ctx.like, ctx.has_x = stage, tape, like, x is not None
        ctx.cond = None if cond is None else (cond.shape, cond.dtype)
        return out

    @staticmethod
    def backward(ctx, g_out):
        stage, tape = ctx.stage, ctx.tape
        S, i = stage.S, stage.i
        like_f, like_b = ctx.like
        params = stage.front_params + stage.back_params
        g_params = {p: None for p in params}
        g_x = [None] * stage.M if i == 0 and ctx.has_x else None
        g_cond = None if ctx.cond is None else g_out.new_zeros(ctx.cond[0],
                                                               dtype=torch.float32)
        g_skips = {}
        down = up = g_turn = None  # the last step's input gradients, to pass on

        def grads(outputs, grad_outputs, inp, c, skips, rows):
            rows = [p for p in rows if p.requires_grad]
            wrt = [inp, *skips, *rows] + ([] if c is None else [c])
            got = torch.autograd.grad(outputs, wrt, grad_outputs, allow_unused=True)
            for p, g in zip(rows, got[1 + len(skips):]):
                if g is not None:
                    g_params[p] = g if g_params[p] is None else g_params[p] + g
            return got[0], got[1:1 + len(skips)], (None if c is None else got[-1])

        for t in reversed(range(stage.T)):
            # the transpose of step t's traffic: the gradients of what this
            # stage received at t go back to their senders
            g_yf, g_yb = (None, None)
            if S > 1 and stage.busy(t):
                g_yb, g_yf = neighbour_exchange(
                    stage.group, stage.device,
                    to_next=up if i < S - 1 and stage.sends_down(i + 1, t) else None,
                    to_prev=down if i > 0 and stage.sends_up(i - 1, t) else None,
                    from_prev=like_b if stage.sends_down(i, t) else None,
                    from_next=like_f if stage.sends_up(i, t) else None)
            down = up = None
            rec = tape[t]
            if "f" in rec:
                m, inp, c, y, pushed = rec["f"]
                g_y = g_turn if i == S - 1 else g_yf
                g_in_skips = g_skips.pop(m) if stage.skips else []
                # each skip is a row's input: a view of the step's input,
                # then the outputs of the rows before
                outputs, gouts = [y, *pushed[:len(g_in_skips)]], [g_y, *g_in_skips]
                g_inp, _, g_c = grads(outputs, gouts, inp, c, [], stage.front_params)
                if i == 0:
                    if g_x is not None:
                        g_x[m] = g_inp
                else:
                    down = g_inp
                if g_c is not None:
                    g_cond[m] += g_c.float()
            g_turn = None
            if "b" in rec:
                m, inp, c, y, skips = rec["b"]
                g_y = g_out[m] if i == 0 else g_yb
                g_inp, g_sk, g_c = grads([y], [g_y], inp, c, skips, stage.back_params)
                if stage.skips:
                    g_skips[m] = list(g_sk)
                if i == S - 1:
                    g_turn = g_inp  # the gradient of this stage's front output one step back
                else:
                    up = g_inp
                if g_c is not None:
                    g_cond[m] += g_c.float()
        ctx.tape = None
        if g_cond is not None:
            all_reduce(g_cond, stage.group)  # every stage's share of the condition
        gx = None if g_x is None else torch.stack(g_x)
        gc = None if g_cond is None else g_cond.to(ctx.cond[1])
        return (None, None, gx, None, gc, None, *(g_params[p] for p in params))


def make_pp_forward(transformer, group=None, *, num_microbatches: int, device="cuda"):
    """The pipelined forward of `transformer` over `group` (the default
    group when None): `fn(x, mask=None, adaptive_rmsnorm_cond=None)` with x
    (M, b, n, dim) microbatches, mask (M, b, n) bool, the condition (M, b,
    cond_dim), the same on every rank (stage 0 reads x) -> (M, b, n, dim)
    on rank 0, each microbatch `transformer(x[m], mask[m], cond[m])`.
    Moves this rank's rows (and, on rank 0, the registers and the final
    norm) to `device`: "cuda" (this process's card under a process group;
    ranks that share one pass "cuda:0") unless the caller asks for "cpu".
    Attention dropout is not run: the pipeline is the deterministic
    forward, as JAX's is by default."""
    from ..models.cfm import resolve_device  # the models import this package

    if group is None:
        group = dist.group.WORLD
    device = resolve_device(device)
    stage = _Stage(transformer, group, num_microbatches, device)  # refuses an indivisible depth
    for i in stage.front + stage.back:
        transformer.layers[i].to(device)
    transformer.rotary_emb.to(device)
    if stage.i == 0:
        transformer.final_norm.to(device)
        if transformer.num_register_tokens > 0:
            transformer.register_tokens.data = transformer.register_tokens.data.to(device)
    M, num_reg = num_microbatches, transformer.num_register_tokens

    def fn(x, mask=None, adaptive_rmsnorm_cond=None):
        if current_shard() is not None:
            raise ValueError("the pipeline does not run under sequence parallelism "
                             "(seq_shard), as the JAX package's does not")
        if x.shape[0] != M:
            raise ValueError(f"expected {M} microbatches, got {x.shape[0]}")
        if transformer.adaptive and adaptive_rmsnorm_cond is None:
            raise ValueError("an adaptive-norm transformer needs adaptive_rmsnorm_cond")
        _, b, n, dim = x.shape
        cond = None if adaptive_rmsnorm_cond is None else adaptive_rmsnorm_cond.to(device)
        if mask is not None:
            mask = mask.to(device)
            if num_reg > 0:
                mask = torch.cat([mask.new_ones(M, b, num_reg), mask], dim=2)
        rotary = transformer.rotary_table(n, device)
        inp = None
        if stage.i == 0:
            inp = x.to(device)
            if num_reg > 0:  # per microbatch, as the module prepends them
                inp = torch.stack([torch.cat([transformer.register_tokens.to(x.dtype).expand(
                    b, -1, -1), inp[m]], dim=1) for m in range(M)])
        compute = transformer.compute_dtype
        flows = torch.promote_types(compute, x.dtype)
        like = (torch.empty((b, n + num_reg, dim), dtype=flows, device=device),
                torch.empty((b, n + num_reg, dim), dtype=compute if stage.skips else flows,
                            device=device))
        params = stage.front_params + stage.back_params
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            out = _VCycle.apply(stage, like, inp, mask, cond, rotary, *params)
        else:
            with torch.no_grad():
                out, _ = _run(stage, inp, mask, cond, rotary, like, grad=False)
        if stage.i != 0:
            return out[:, :, num_reg:]
        return torch.stack([transformer.finish(out[m]) for m in range(M)])

    return fn
