"""The training step's levers against the JAX package, on the CPU in
float32 compute:

* `AdamLowPrecisionMoments` + `ParamsEMA` against `get_optimizer(
  moment_dtype=bfloat16, ema_decay=...)` over 3 steps with a clip that
  fires: moments within one bf16 ulp, parameter updates and the EMA within
  0.25 lr (the bound of `test_trainer_steps_match_a_jax_loop`);
* `VoiceBoxTrainer(param_dtype=bfloat16)` against a JAX loop of the mixed
  step (bf16 live parameters read by the forward and backward, fp32
  accumulation when accumulating, the update on the fp32 master) at accum
  1 and 2, fp32 and bf16 moments: updates within 0.25 lr, which the bf16
  run's own distance from the port's fp32 run exceeds;
* remat: every policy's gradients equal those without remat to the bit,
  K1 (its plain version here) runs twice per layer under full remat and
  once under "dots+attn_out+attn_lse", an unknown part raises;
* attention dropout against `reference_attention(dropout=, dropout_rng=)`
  with JAX's keep mask handed over (atol 2e-4, gradients atol 2e-3);
* `PrefetchLoader`, the trackers, `metrics.jsonl` and the profiler window.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_train import (ACCUM, BATCH, CLIP, DROP, FRAMES, INITIAL_LR, LR, SIGMA, STEPS,
                              WD, _port, _t)
from test_torch_voicebox import N_COND_TOKENS, _models
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.ops.flash_attention import reference_attention as jax_reference_attention
from voicebox_tpu.ops.ode import cfm_interpolant as jax_cfm_interpolant
from voicebox_tpu.training.optimizer import adam_state_from_opt_state, ema_params_from_state
from voicebox_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from voicebox_tpu.training.optimizer import warmup_cosine_schedule as jax_schedule
from voicebox_tpu.training.trainer import VoiceBoxTrainer as JaxTrainer
from voicebox_tpu_torch import ArrayDataset, ConditionalFlowMatcherWrapper, VoiceBox
from voicebox_tpu_torch import VoiceBoxTrainer
from voicebox_tpu_torch.ops import flash_attention as fa
from voicebox_tpu_torch.ops.flash_attention import reference_attention
from voicebox_tpu_torch.training import PrefetchLoader, TrainConfig
from voicebox_tpu_torch.training.data import DataLoader
from voicebox_tpu_torch.training.optimizer import (ParamsEMA, adam_state,
                                                   clip_by_global_norm_f32, get_optimizer)
from voicebox_tpu_torch.utils.convert import voicebox_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _within_one_ulp(ours, ref, key):
    a = np.asarray(ours, np.float64)
    b = np.asarray(ref, np.float64)
    assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))), key


def test_bf16_moment_adam_and_ema_match_jax():
    rs = np.random.RandomState(30)
    params = {"w": rs.randn(8, 6).astype(np.float32) * 0.5,
              "g": rs.randn(2, 1, 4).astype(np.float32) * 0.5,
              "b": rs.randn(6).astype(np.float32) * 0.5}
    grads = [{k: (rs.randn(*v.shape) * (1 + 3 * s)).astype(np.float32)
              for k, v in params.items()} for s in range(3)]
    decay = 0.9
    opt = jax_get_optimizer(lr=LR, wd=WD, max_grad_norm=CLIP, moment_dtype=jnp.bfloat16,
                            ema_decay=decay)
    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    named = [(k, torch.nn.Parameter(_t(v))) for k, v in params.items()]
    ours = get_optimizer(named, lr=LR, wd=WD, moment_dtype=torch.bfloat16)
    ema = ParamsEMA([p for _, p in named], decay)
    for g in grads:
        norm = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())))
        assert norm > CLIP  # the clip fires
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = [_t(g[k]) for k, _ in named]
        clip_by_global_norm_f32(tg, CLIP)
        ours.step({p: g for (_, p), g in zip(named, tg)})
        ema.update()
    mu, nu, count = adam_state_from_opt_state(state)
    omu, onu, ocount = adam_state(ours, [p for _, p in named])
    assert ocount == int(count) == 3
    for (k, p), m, v, e in zip(named, omu, onu, ema.shadow):
        assert m.dtype == v.dtype == torch.bfloat16
        _within_one_ulp(m.float().numpy(), np.asarray(mu[k], np.float32), k)
        _within_one_ulp(v.float().numpy(), np.asarray(nu[k], np.float32), k)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   atol=0.25 * LR, rtol=0, err_msg=k)
        np.testing.assert_allclose(e.numpy(), np.asarray(ema_params_from_state(state)[k]),
                                   atol=0.25 * LR, rtol=0, err_msg=k)


def _items(d_in, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(n, d_in).astype(np.float32),
             rs.randint(0, N_COND_TOKENS, n).astype(np.int32)) for n in rs.randint(15, 21, 12)]


def _port_run(params, d_in, accum, draws_seed=31, **kw):
    """The port trainer's parameter updates after STEPS steps, its batches
    and draws."""
    port = _port(params)
    init = {k: v.detach().clone() for k, v in port.named_parameters()}
    cfm = ConditionalFlowMatcherWrapper(port, sigma=SIGMA, cond_drop_prob=DROP, device="cpu")
    trainer = VoiceBoxTrainer(
        cfm, batch_size=BATCH, dataset=ArrayDataset(_items(d_in, 24)), num_train_steps=STEPS,
        num_warmup_steps=1, lr=LR, initial_lr=INITIAL_LR, wd=WD, max_grad_norm=CLIP,
        grad_accum_every=accum, valid_frac=0.25, bucket_multiple=16, log_every=100,
        save_results_every=100, device="cpu", **kw)
    batches, step_draws = [], []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    trainer.dl_iter = recorded(trainer.dl_iter)
    rs = np.random.RandomState(draws_seed)
    for _ in range(STEPS):
        m = BATCH * accum
        draws = dict(noise=rs.randn(m, FRAMES, d_in).astype(np.float32),
                     times=rs.rand(m).astype(np.float32),
                     cond_mask=rs.rand(m, FRAMES) < 0.7, cond_drop_mask=rs.rand(m) < DROP)
        step_draws.append(draws)
        trainer.train_step(**{k: _t(v) for k, v in draws.items()})
    updates = {k: (p.detach() - init[k]).numpy() for k, p in port.named_parameters()}
    assert {p.dtype for p in port.parameters()} == {torch.float32}  # the master
    return updates, batches, step_draws, init


def _jax_mixed_run(jvb, params, batches, step_draws, accum, moment_dtype):
    """The JAX package's mixed step, unrolled: value_and_grad on the bf16
    live tree per micro-batch (fp32 sums when accumulating), the optimizer
    on the fp32 master, the live tree recast from it."""
    opt = jax_get_optimizer(lr=jax_schedule(LR, INITIAL_LR, 1, STEPS), wd=WD,
                            max_grad_norm=CLIP, moment_dtype=moment_dtype)

    def micro(p, x1, mask, ids, x0, t, cm, dm):
        w, flow = jax_cfm_interpolant(x1, x0, t, SIGMA)
        return jvb.apply({"params": p}, w, times=t, cond_token_ids=ids, self_attn_mask=mask,
                         cond_drop_mask=dm, target=flow, cond_mask=cm, train=True)

    grad_fn = jax.jit(jax.value_and_grad(micro))
    cast = jax.jit(lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16), t))

    @jax.jit
    def opt_step(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state
    master = jax.tree.map(jnp.asarray, params)
    state, live = opt.init(master), cast(master)
    for ((x, mask), (ids, _)), draws in zip(batches, step_draws):
        acc = None
        for i in range(accum):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            args = [x[sl], mask[sl], ids[sl]] + [draws[k][sl] for k in
                                                 ("noise", "times", "cond_mask",
                                                  "cond_drop_mask")]
            _, g = grad_fn(live, *(jnp.asarray(a) for a in args))
            assert jax.tree.leaves(g)[0].dtype == jnp.bfloat16
            if accum > 1:
                g = jax.tree.map(lambda a: a.astype(jnp.float32), g)
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        grads = jax.tree.map(lambda a: a / accum, acc)
        master, state = opt_step(grads, state, master)
        live = cast(master)
    return voicebox_state_dict(jax.tree.map(np.asarray, master))


@pytest.mark.parametrize("accum,moment_dtype", [(1, None), (ACCUM, "bfloat16")])
def test_bf16_live_parameters_match_a_jax_mixed_step_loop(accum, moment_dtype):
    jvb, _, params, d_in = _models()
    kw = dict(param_dtype=torch.bfloat16,
              moment_dtype=None if moment_dtype is None else torch.bfloat16)
    ours, batches, step_draws, init = _port_run(params, d_in, accum, **kw)
    ref_final = _jax_mixed_run(jvb, params, batches, step_draws, accum,
                               None if moment_dtype is None else jnp.bfloat16)
    ref = {k: ref_final[k].numpy() - init[k].numpy() for k in init}
    # the port's bf16 run against its own fp32 run on the same batches and
    # draws: what bf16 live parameters change. Measured at accum 1 / 2:
    # 8% / 20% of the weights move by more than 0.25 lr, by 0.09 / 0.16 lr
    # on average; the port against JAX: 4 / 2 of 241448 weights, 0.003 /
    # 0.001 lr on average. A weight whose gradient sits near zero carries
    # the two bf16 gradients' rounding amplified by Adam up to a flipped
    # update (2 lr a step: at most 6 lr over the 3 steps; measured 2.3 lr),
    # so the bounds are on how many weights move apart and by how much on
    # average, with the fp32 run as the yardstick they must stay far from.
    fp32, *_ = _port_run(params, d_in, accum, moment_dtype=kw["moment_dtype"])

    def distance(a, b):
        d = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in a]) / LR
        return int((d > 0.25).sum()) / d.size, float(d.mean()), float(d.max())

    off, mean, worst = distance(ours, ref)
    off_fp32, mean_fp32, _ = distance(ours, fp32)
    assert off <= 1e-4 and mean <= 0.01 and worst <= 6.0, (off, mean, worst)
    assert off_fp32 > 100 * max(off, 1e-5) and mean_fp32 > 5 * mean, (off_fp32, mean_fp32)
    # in direction: all weights together within cosine 0.999, each leaf
    # within 0.99 (one flipped weight of the 1632 in to_cond_emb reads 0.998)
    def cos(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))

    assert cos(np.concatenate([ours[k].ravel() for k in ours]),
               np.concatenate([ref[k].ravel() for k in ours])) > 0.999
    for key in ours:
        assert cos(ours[key], ref[key]) > 0.99, key


# ---------------------------------------------------------------------------
# remat

REMAT_CFG = dict(num_cond_tokens=20, dim_cond_emb=16, dim=64, depth=2, dim_head=64, heads=2,
                 num_register_tokens=2, dim_in=8, attn_dropout=0.0)


def _remat_grads(generator_seed=None, **kw):
    cfg = dict(REMAT_CFG, **{k: v for k, v in kw.items() if k == "attn_dropout"})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vb = VoiceBox(**cfg, **{k: v for k, v in kw.items() if k != "attn_dropout"})
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 10, 8, generator=g)
    t = torch.rand(2, generator=g)
    ids = torch.randint(0, 20, (2, 10), generator=g)
    cond_mask = torch.rand(2, 10, generator=g) < 0.5
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    loss = vb(x, times=t, cond_token_ids=ids, target=x, cond_mask=cond_mask, train=True,
              cond_drop_mask=torch.tensor([False, True]), generator=gen)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in vb.named_parameters()}


class _OpCount(TorchDispatchMode):
    """Counts executions of one op (a checkpoint policy's saved ops return
    their saved outputs without reaching this mode)."""

    def __init__(self, op):
        super().__init__()
        self.op, self.count = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is self.op
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch", "dots+attn_out+attn_lse",
                                    "norm_out+gelu_out+qk_rotary+attn_probs"])
def test_remat_gradients_equal_plain_to_the_bit(policy):
    loss, base = _remat_grads()
    loss_r, grads = _remat_grads(remat=True, remat_policy=policy)
    assert torch.equal(loss, loss_r)
    for name, g in base.items():
        assert torch.equal(grads[name], g), name


def test_remat_runs_attention_forward_twice_unless_its_outputs_are_saved(monkeypatch):
    depth = REMAT_CFG["depth"]
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return reference_attention(*args, **kwargs)

    monkeypatch.setattr(fa, "reference_attention", counted)
    for policy, want in ((None, 2 * depth), ("dots", 2 * depth), ("norm_out", 2 * depth)):
        calls.clear()
        _remat_grads(remat=True, remat_policy=policy)
        assert len(calls) == want, (policy, len(calls))
    # the saved K1 op runs once per layer: the recompute takes its outputs
    op = torch.ops.voicebox_tpu_torch.flash_attention_fwd.default
    with _OpCount(op) as mode:
        _remat_grads(remat=True, remat_policy="dots+attn_out+attn_lse")
    assert mode.count == depth


def test_remat_with_attention_dropout_replays_its_masks():
    loss, base = _remat_grads(generator_seed=5, attn_dropout=0.3)
    for policy in (None, "dots"):
        loss_r, grads = _remat_grads(generator_seed=5, attn_dropout=0.3, remat=True,
                                     remat_policy=policy)
        assert torch.equal(loss, loss_r)
        for name, g in base.items():
            assert torch.equal(grads[name], g), (policy, name)
    # and dropout changed the loss
    assert not torch.equal(loss, _remat_grads(generator_seed=5)[0])


def test_unknown_remat_policy_raises():
    for policy in ("dots+bogus", "attn_out+", "everything"):
        with pytest.raises(ValueError, match="remat_policy"):
            VoiceBox(**REMAT_CFG, remat=True, remat_policy=policy)


# ---------------------------------------------------------------------------
# attention dropout

def test_attention_dropout_matches_jax_with_its_keep_mask():
    rs = np.random.RandomState(32)
    b, h, n, d, p = 2, 3, 12, 16, 0.3
    q, k, v, do = (rs.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    mask = rs.rand(b, n) > 0.2
    key = jax.random.PRNGKey(11)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p, (b, h, n, n)))

    def jax_fn(q, k, v):
        return jax_reference_attention(q, k, v, mask=jnp.asarray(mask), scale=0.3, dropout=p,
                                       dropout_rng=key)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = reference_attention(qt, kt, vt, _t(mask), 0.3, dropout=p, keep=_t(keep))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    out.backward(_t(do))
    for ours, theirs in zip((qt, kt, vt), ref_grads):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs), atol=2e-3, rtol=0)
    # drawn from a generator: reproducible, and a fraction p dropped
    g = [reference_attention(_t(q), _t(k), _t(v), _t(mask), 0.3, dropout=p,
                             generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(g[0], g[1])


# ---------------------------------------------------------------------------
# prefetch, trackers, metrics, profiler

def _loader(n=10, seed=0):
    rs = np.random.RandomState(seed)
    items = [rs.randn(int(m), 4).astype(np.float32) for m in rs.randint(3, 9, n)]
    return DataLoader(ArrayDataset(items), 3, seed=seed, bucket_multiple=4, bucket_offset=0)


def test_prefetch_loader_keeps_order_reraises_and_stops():
    plain = list(_loader())
    fetched = list(PrefetchLoader(_loader(), prefetch=2))
    assert len(plain) == len(fetched) > 2
    for (x, m), (y, k) in zip(plain, fetched):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(m, k)
    cyc, ref = PrefetchLoader(_loader(), 1).cycle(), _loader().cycle()
    for _ in range(2 * len(plain) + 1):
        np.testing.assert_array_equal(next(cyc)[0], next(ref)[0])
    cyc.close()

    def broken():
        yield 1
        raise RuntimeError("decode failed")

    it = iter(PrefetchLoader(broken(), 2))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

    def endless():
        while True:
            yield np.zeros(3)

    before = {t for t in threading.enumerate() if t.name == "voicebox-prefetch"}
    it = iter(PrefetchLoader(endless(), 2))
    next(it)
    it.close()  # abandon mid-stream
    deadline = time.time() + 5
    while time.time() < deadline:
        alive = {t for t in threading.enumerate()
                 if t.name == "voicebox-prefetch" and t.is_alive()} - before
        if not alive:
            break
        time.sleep(0.05)
    assert not alive


class _Recorder:
    def __init__(self):
        self.inits, self.logs, self.finished = [], [], False

    def init_trackers(self, project, config):
        self.inits.append((project, dict(config)))

    def log(self, values, step):
        self.logs.append((dict(values), step))

    def finish(self):
        self.finished = True


def test_trackers_metrics_and_profiler_window_match_the_jax_trainer(tmp_path):
    jvb, _, params, d_in = _models()
    items = _items(d_in, 33)
    # the JAX trainer's records, from its own code: the init record at
    # construction and a flushed train loss (no step runs)
    jrec, jcalls = _Recorder(), []
    jtrainer = JaxTrainer(JaxCFM(jvb, params=params), batch_size=2,
                          dataset=items, num_train_steps=3, valid_frac=0.25,
                          results_folder=str(tmp_path / "jax"), use_mesh=False,
                          bucket_multiple=16, prefetch_batches=0,
                          trackers=(jrec, lambda r, s: jcalls.append((r, s))))
    jtrainer._loss_buffer.append((0, jnp.float32(1.5)))
    jtrainer._flush_losses()
    jax_lines = [json.loads(x) for x in (tmp_path / "jax" / "metrics.jsonl").read_text()
                 .splitlines()]

    rec, calls = _Recorder(), []
    cfm = ConditionalFlowMatcherWrapper(_port(params), device="cpu")
    trainer = TrainConfig(batch_size=2, num_train_steps=3, valid_frac=0.25, log_every=1,
                          save_results_every=2, bucket_multiple=16,
                          results_folder=str(tmp_path / "port")).build(
        cfm, ArrayDataset(items), device="cpu", profile_dir=str(tmp_path / "trace"),
        profile_steps=(1, 2), trackers=(rec, lambda r, s: calls.append((r, s))))
    trainer.train()
    lines = [json.loads(x) for x in (tmp_path / "port" / "metrics.jsonl").read_text()
             .splitlines()]
    assert [sorted(x) for x in lines[:2]] == [sorted(x) for x in jax_lines[:2]]
    assert lines[0]["event"] == "init_trackers"
    assert lines[0]["config"].keys() == jax_lines[0]["config"].keys()
    assert {tuple(sorted(x)) for x in lines} == {
        ("config", "event", "step", "time"), ("step", "time", "train_loss"),
        ("step", "time", "valid_loss")}
    assert sorted(x["step"] for x in lines if "valid_loss" in x) == [0, 2]
    assert rec.inits[0][0] == jrec.inits[0][0] == "voicebox"
    assert rec.inits[0][1] == lines[0]["config"]
    assert {s for v, s in rec.logs if "train_loss" in v} == {0, 1, 2} and rec.finished
    assert sorted(rec.logs[0][0]) == sorted(jrec.logs[0][0])
    assert [sorted(r) for r, _ in calls[:1]] == [sorted(r) for r, _ in jcalls[:1]]
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())

