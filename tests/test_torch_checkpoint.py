"""Checkpoints in the reference trainer's layout, on the CPU:

* the port's `save` -> `load` into a fresh trainer resumes to the bit: the
  next step's loss, every parameter, both moments and the EMA equal the
  uninterrupted run's (fp32 AdamW; bf16 live parameters, bf16 moments and
  a bf16 EMA);
* the JAX package's `VoiceBoxTrainer.save_torch` -> the port's `load`, and
  the port's `save` -> the JAX package's `load_torch`: parameters, both
  moments and the step equal exactly (fp32 and bf16 moments); the next
  step's loss agrees at the trainer test's atol 2e-4 and its updates within
  0.25 lr;
* the port's file loads into a genuine `torch.optim.AdamW` over the
  reference's parameter order (the frozen `null_cond` holds an index and
  no state) and that optimizer steps;
* `ConditionalFlowMatcherWrapper.save_torch` -> `load_torch` / `load` to
  the bit, and into the JAX wrapper's `load_torch`; `save_model_every`
  writes `voicebox.{step}.pt`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import (CLIP, DROP, FRAMES, INITIAL_LR, LR, SIGMA, WD,
                              _assert_leaves_close, _port, _t)
from test_torch_voicebox import CONFIG, DIM_IN, N_COND_TOKENS, _models
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.ops.ode import cfm_interpolant as jax_cfm_interpolant
from voicebox_tpu.training.optimizer import adam_state_from_opt_state, restore_adam_state
from voicebox_tpu.training.trainer import VoiceBoxTrainer as JaxTrainer
from voicebox_tpu_torch import ArrayDataset, ConditionalFlowMatcherWrapper, VoiceBox
from voicebox_tpu_torch import VoiceBoxTrainer
from voicebox_tpu_torch.training.optimizer import adam_state
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

BATCH, STEPS = 2, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(seed, d_in, m=BATCH, frames=FRAMES):
    rs = np.random.RandomState(seed)
    return {"noise": _t(rs.randn(m, frames, d_in).astype(np.float32)),
            "times": _t(rs.rand(m).astype(np.float32)),
            "cond_mask": _t(rs.rand(m, frames) < 0.7),
            "cond_drop_mask": _t(rs.rand(m) < DROP)}


def _same_items(d_in, n=8, frames=17):
    """Every item the same, so a fresh trainer's first batch is the batch
    the uninterrupted run takes next (a checkpoint holds no loader
    position, as the JAX package's does not)."""
    rs = np.random.RandomState(40)
    item = (rs.randn(frames, d_in).astype(np.float32),
            rs.randint(0, N_COND_TOKENS, frames).astype(np.int32))
    return [item] * n


def _trainer(vb, items, **kw):
    cfm = ConditionalFlowMatcherWrapper(vb, sigma=SIGMA, cond_drop_prob=DROP, device="cpu")
    return VoiceBoxTrainer(cfm, batch_size=BATCH, dataset=ArrayDataset(items),
                           num_train_steps=STEPS, num_warmup_steps=1, lr=LR,
                           initial_lr=INITIAL_LR, wd=WD, max_grad_norm=CLIP, valid_frac=0.0,
                           bucket_multiple=16, log_every=100, save_results_every=100,
                           device="cpu", **kw)


def _fresh_voicebox(seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return VoiceBox(dim_in=DIM_IN, **CONFIG)


LEVERS = {"fp32": {}, "bf16": dict(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
                                   ema_decay=0.9, ema_dtype=torch.bfloat16)}


@pytest.mark.parametrize("levers", list(LEVERS))
def test_save_then_load_resumes_to_the_bit(tmp_path, levers):
    _, _, params, d_in = _models()
    items = _same_items(d_in)
    a = _trainer(_port(params), items, **LEVERS[levers])
    for k in range(2):
        a.train_step(**_draws(k, d_in))
    path = tmp_path / "run.pt"
    a.save(path)
    loss_a = a.train_step(**_draws(2, d_in))["loss"]

    b = _trainer(_fresh_voicebox(7), items, **LEVERS[levers])
    b.load(path)
    assert b.steps == 2
    loss_b = b.train_step(**_draws(2, d_in))["loss"]
    assert torch.equal(loss_a, loss_b)
    assert [g["lr"] for g in a.optimizer.param_groups] == [g["lr"] for g in
                                                          b.optimizer.param_groups]
    for (name, p), q in zip(a.named_params, b.params):
        assert torch.equal(p, q), name
    for ta, tb in zip(adam_state(a.optimizer, a.params)[:2], adam_state(b.optimizer, b.params)[:2]):
        for x, y in zip(ta, tb):
            assert x.dtype == y.dtype and torch.equal(x, y)
    if a.ema is not None:
        assert a.ema.shadow[0].dtype == torch.bfloat16
        for x, y in zip(a.ema.shadow, b.ema.shadow):
            assert torch.equal(x, y)


def _jax_trainer(jvb, params, items, tmp_path, moment_dtype):
    return JaxTrainer(JaxCFM(jvb, params=params, sigma=SIGMA, cond_drop_prob=DROP),
                      batch_size=BATCH, dataset=items, num_train_steps=STEPS,
                      num_warmup_steps=1, lr=LR, initial_lr=INITIAL_LR, wd=WD,
                      max_grad_norm=CLIP, moment_dtype=moment_dtype, valid_frac=0.0,
                      use_mesh=False, prefetch_batches=0, bucket_multiple=16,
                      results_folder=str(tmp_path / "jax"))


def _jax_step(jt, batch, draws):
    """One step of the JAX trainer's optimizer on the given batch and draws
    (the loop of `test_trainer_steps_match_a_jax_loop`)."""
    jvb = jt.cfm_wrapper.voicebox
    (x, mask), (ids, _) = batch

    def micro(p):
        w, flow = jax_cfm_interpolant(jnp.asarray(x), jnp.asarray(draws["noise"]),
                                      jnp.asarray(draws["times"]), SIGMA)
        return jvb.apply({"params": p}, w, times=jnp.asarray(draws["times"]),
                         cond_token_ids=jnp.asarray(ids), self_attn_mask=jnp.asarray(mask),
                         cond_drop_mask=jnp.asarray(draws["cond_drop_mask"]), target=flow,
                         cond_mask=jnp.asarray(draws["cond_mask"]), train=True)

    @jax.jit
    def opt_step(grads, state, p):
        updates, state = jt.optimizer.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    loss, grads = jax.jit(jax.value_and_grad(micro))(jt.params)
    jt.params, jt.opt_state = opt_step(grads, jt.opt_state, jt.params)
    return float(loss)


def _np_sd(tree):
    return {k: v.numpy() for k, v in voicebox_state_dict(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("bf16_moments", [False, True])
def test_checkpoints_interchange_with_the_jax_trainer(tmp_path, bf16_moments):
    jvb, _, params, d_in = _models()
    items = _same_items(d_in)
    jt = _jax_trainer(jvb, params, items, tmp_path, jnp.bfloat16 if bf16_moments else None)
    rs = np.random.RandomState(41)
    mu = jax.tree.map(lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * 1e-2),
                      params)
    nu = jax.tree.map(lambda p: jnp.asarray(rs.rand(*p.shape).astype(np.float32) * 1e-4),
                      params)
    jt.opt_state = restore_adam_state(jt.opt_state, mu, nu, 3, params=jt.params)
    jmu, jnu, _ = adam_state_from_opt_state(jt.opt_state)  # in the moment dtype
    path = tmp_path / "from_jax.pt"
    jt.save_torch(str(path))

    # JAX -> port: exact parameters, moments and step
    pt = _trainer(_fresh_voicebox(8), items,
                  moment_dtype=torch.bfloat16 if bf16_moments else None)
    pt.load_torch(path)
    assert pt.steps == 3
    ref = _np_sd(params)
    for name, p in pt.named_params:
        np.testing.assert_array_equal(p.detach().numpy(), ref[name], err_msg=name)
    omu, onu, count = adam_state(pt.optimizer, pt.params)
    assert count == 3
    for (name, _), m, v in zip(pt.named_params, omu, onu):
        for ours, theirs in ((m, jmu), (v, jnu)):
            want = _np_sd(jax.tree.map(lambda a: np.asarray(a, np.float32), theirs))[name]
            np.testing.assert_array_equal(ours.float().numpy(), want, err_msg=name)

    # the next step on the same batch and draws
    batches = []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    pt.dl_iter = recorded(pt.dl_iter)
    draws = {k: v.numpy() for k, v in _draws(42, d_in).items()}
    init = {k: p.detach().clone() for k, p in pt.named_params}
    loss = pt.train_step(**{k: _t(v) for k, v in draws.items()})["loss"].item()
    jloss = _jax_step(jt, batches[0], draws)
    np.testing.assert_allclose(loss, jloss, atol=2e-4, rtol=0)
    ref_after = _np_sd(jt.params)
    _assert_leaves_close({k: (p.detach() - init[k]).numpy() for k, p in pt.named_params},
                         {k: ref_after[k] - init[k].numpy() for k in init}, atol=0.25 * LR)

    # port -> JAX: exact parameters, moments and step
    out = tmp_path / "from_port.pt"
    pt.save(out)
    jt2 = _jax_trainer(jvb, jax.tree.map(jnp.zeros_like, params), items, tmp_path,
                       jnp.bfloat16 if bf16_moments else None)
    jt2.load_torch(str(out))
    assert jt2.steps == pt.steps == 4
    got = _np_sd(jt2.params)
    mu2, nu2, count2 = adam_state_from_opt_state(jt2.opt_state)
    assert int(count2) == 4
    omu, onu, _ = adam_state(pt.optimizer, pt.params)
    mu2 = _np_sd(jax.tree.map(lambda a: np.asarray(a, np.float32), mu2))
    nu2 = _np_sd(jax.tree.map(lambda a: np.asarray(a, np.float32), nu2))
    for (name, p), m, v in zip(pt.named_params, omu, onu):
        np.testing.assert_array_equal(got[name], p.detach().numpy(), err_msg=name)
        np.testing.assert_array_equal(mu2[name], m.float().numpy(), err_msg=name)
        np.testing.assert_array_equal(nu2[name], v.float().numpy(), err_msg=name)


def test_port_checkpoint_loads_into_a_genuine_adamw(tmp_path):
    _, _, params, d_in = _models()
    pt = _trainer(_port(params), _same_items(d_in))
    for k in range(2):
        pt.train_step(**_draws(k, d_in))
    pkg = pt.save(tmp_path / "run.pt")
    assert set(pkg) == {"model", "optim", "scheduler", "steps"} and pkg["steps"] == 2
    model = torch.load(tmp_path / "run.pt", weights_only=False)["model"]
    # the reference's parameters: every model entry but the rotary buffer,
    # in state-dict order, grouped [ndim >= 2, the rest]
    names = [k for k in model if not k.endswith("rotary_emb.inv_freq")]
    groups = [[k for k in names if model[k].ndim >= 2], [k for k in names if model[k].ndim < 2]]
    tparams = {k: torch.nn.Parameter(model[k].clone()) for k in names}
    opt = torch.optim.AdamW([{"params": [tparams[k] for k in groups[0]], "weight_decay": WD},
                             {"params": [tparams[k] for k in groups[1]], "weight_decay": 0.0}],
                            lr=LR, betas=(0.9, 0.99), eps=1e-8)
    opt.load_state_dict(torch.load(tmp_path / "run.pt", weights_only=False)["optim"])
    assert tparams["voicebox.null_cond"] not in opt.state
    mus, nus, _ = adam_state(pt.optimizer, pt.params)
    for (name, _), m, v in zip(pt.named_params, mus, nus):
        st = opt.state[tparams["voicebox." + name]]
        assert torch.equal(st["exp_avg"], m) and torch.equal(st["exp_avg_sq"], v)
        assert float(st["step"]) == 2.0
    for p in tparams.values():
        p.grad = torch.zeros_like(p)
    opt.step()


def test_wrapper_checkpoints_round_trip_and_save_model_every(tmp_path):
    _, _, params, d_in = _models()
    cfm = ConditionalFlowMatcherWrapper(_port(params), device="cpu")
    path = tmp_path / "wrapper.pt"
    cfm.save_torch(path)
    with pytest.raises(ValueError, match="no optimizer state"):  # weights only
        _trainer(_fresh_voicebox(9), _same_items(d_in)).load(path)
    for load in ("load_torch", "load"):
        other = ConditionalFlowMatcherWrapper(_fresh_voicebox(9), device="cpu")
        getattr(other, load)(path)
        sd, ref = other.voicebox.state_dict(), cfm.voicebox.state_dict()
        assert list(sd) == list(ref)
        for k in ref:
            assert torch.equal(sd[k], ref[k]), k
    jvb = _models()[0]
    jcfm = JaxCFM(jvb, params=jax.tree.map(jnp.zeros_like, params))
    got = _np_sd(jcfm.load_torch(str(path)))
    for name, p in cfm.voicebox.named_parameters():
        np.testing.assert_array_equal(got[name], p.detach().numpy(), err_msg=name)

    results = tmp_path / "results"
    (results / "stale").mkdir(parents=True)
    pt = _trainer(_port(params), _same_items(d_in), results_folder=str(results),
                  save_model_every=2, force_clear_prev_results=True)
    assert not (results / "stale").exists()
    for k in range(3):
        pt.train_step(**_draws(k, d_in))
    saved = sorted(p.name for p in results.glob("voicebox.*.pt"))
    assert saved == ["voicebox.0.pt", "voicebox.2.pt"]
    assert torch.load(results / "voicebox.2.pt", weights_only=False)["steps"] == 3
