"""The port's training step against the JAX package, on the CPU in float32:

* the VoiceBox masked-MSE loss and its gradient per parameter against JAX
  `VoiceBox.apply(..., target=, cond_mask=, cond_drop_mask=)`, JAX's
  gradients carried through `voicebox_state_dict` (they transform like the
  weights): loss atol 2e-4, per-leaf cosine > 0.999 and atol 2e-3;
* `ConditionalFlowMatcherWrapper.loss_fn` against the JAX `loss_fn` with
  JAX's own random draws (noise, times, span and CFG masks), which the test
  recovers from the same key and hands to the port;
* three `VoiceBoxTrainer` steps (gradient accumulation, clip, AdamW,
  warmup -> cosine) against a JAX loop of `value_and_grad` and
  `get_optimizer` on the same batches and draws, compared per leaf, on
  latents with paired ids and on raw waves through a tiny MelVoco (the
  trainer's buckets in samples, the frozen codec's encode and frame masks
  as the JAX trainer prepares a batch).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from test_torch_transformer import _xla_inv_freq
from test_torch_voicebox import B, CONFIG, DIM_IN, N, N_COND_TOKENS, _inputs, _models
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.ops.ode import cfm_interpolant as jax_cfm_interpolant
from voicebox_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from voicebox_tpu.training.optimizer import warmup_cosine_schedule as jax_schedule
from voicebox_tpu_torch import ArrayDataset, ConditionalFlowMatcherWrapper, VoiceBox
from voicebox_tpu_torch import VoiceBoxTrainer
from voicebox_tpu_torch.ops.masks import mask_from_frac_lengths, prob_mask_like
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(params):
    vb = VoiceBox(dim_in=DIM_IN, **CONFIG)
    vb.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."), strict=True)
    return vb


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_leaves_close(ours: dict, ref: dict, atol=2e-3):
    """Per leaf: cosine > 0.999 and atol (the done bar for gradients)."""
    for key, a in ours.items():
        a, b = np.asarray(a, np.float64), np.asarray(ref[key], np.float64)
        assert a.shape == b.shape, key
        denom = max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)
        cos = float((a * b).sum() / denom)
        assert cos > 0.999, (key, cos)
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-2, err_msg=key)


@pytest.mark.parametrize("cond_given", [True, False])  # False: cond defaults to target
def test_voicebox_loss_and_gradients_match_jax(cond_given):
    jvb, _, params, d_in = _models()
    x, cond, times, ids, cond_mask = _inputs(d_in, seed=21)
    rs = np.random.RandomState(22)
    target = rs.randn(B, N, d_in).astype(np.float32)
    attn = rs.rand(B, N) > 0.2
    attn[:, :2] = True
    kw = dict(times=times, cond_token_ids=ids, self_attn_mask=attn, cond_mask=cond_mask,
              cond_drop_mask=np.array([False, True]), target=target)
    if cond_given:
        kw["cond"] = cond

    @jax.jit
    def loss_fn(p):
        return jvb.apply({"params": p}, jnp.asarray(x), train=True,
                         **{k: jnp.asarray(v) for k, v in kw.items()})

    jl, jg = jax.value_and_grad(loss_fn)(params)
    ref = voicebox_state_dict(jax.tree.map(np.asarray, jg))

    port = _port(params)
    loss = port(_t(x), train=True, **{k: _t(v) for k, v in kw.items()})
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL, rtol=0)
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(grads) == set(ref) - {"null_cond", "transformer.rotary_emb.inv_freq"}
    _assert_leaves_close(grads, ref)


class _Draws(nn.Module):
    """The draws JAX `VoiceBox` makes in training, in its order: the span
    fraction and the span start from the 'mask' stream, the CFG drop from
    'cfg' (a top-level module derives the same keys)."""

    lo: float
    hi: float

    @nn.compact
    def __call__(self, b):
        frac = jax.random.uniform(self.make_rng("mask"), (b,), minval=self.lo, maxval=self.hi)
        start = jax.random.uniform(self.make_rng("mask"), (b,))
        drop = jax.random.uniform(self.make_rng("cfg"), (b,))
        return frac, start, drop


def _jax_draws(rng, x1_shape, lo=0.7, hi=1.0):
    noise_rng, time_rng, mask_rng, cfg_rng, _ = jax.random.split(rng, 5)
    x0 = jax.random.normal(noise_rng, x1_shape)
    times = jax.random.uniform(time_rng, (x1_shape[0],))
    frac, start, drop = _Draws(lo, hi).apply({}, x1_shape[0],
                                             rngs={"mask": mask_rng, "cfg": cfg_rng})
    return x0, times, frac, start, drop


def test_loss_fn_matches_jax_with_its_own_draws():
    jvb, _, params, d_in = _models()
    jcfm = JaxCFM(jvb, sigma=0.1, cond_drop_prob=0.5)
    rs = np.random.RandomState(23)
    x1 = rs.randn(B, N, d_in).astype(np.float32)
    ids = rs.randint(0, N_COND_TOKENS, (B, N)).astype(np.int32)
    attn = rs.rand(B, N) > 0.1
    rng = jax.random.PRNGKey(5)
    ref = jax.jit(jcfm.loss_fn)(params, jnp.asarray(x1), rng, mask=jnp.asarray(attn),
                                cond_token_ids=jnp.asarray(ids))

    x0, times, frac, start, drop = (_t(a) for a in _jax_draws(rng, x1.shape))
    cfm = ConditionalFlowMatcherWrapper(_port(params), sigma=0.1, cond_drop_prob=0.5,
                                        device="cpu")
    draws = dict(noise=x0, times=times,
                 cond_mask=mask_from_frac_lengths(N, frac, uniform_draw=start),
                 cond_drop_mask=prob_mask_like((B,), 0.5, uniform_draw=drop))
    loss = cfm.loss_fn(_t(x1), mask=_t(attn), cond_token_ids=_t(ids), **draws)
    np.testing.assert_allclose(loss.item(), float(ref), atol=ATOL, rtol=0)
    # calling the wrapper is the same loss
    called = cfm(_t(x1), mask=_t(attn), semantic_token_ids=_t(ids), **draws)
    assert called.item() == loss.item()
    # with a generator the draws are the port's own and reproducible
    losses = [cfm(_t(x1), mask=_t(attn), semantic_token_ids=_t(ids),
                  generator=torch.Generator().manual_seed(9)).item() for _ in range(2)]
    assert losses[0] == losses[1] and np.isfinite(losses[0])


LR, INITIAL_LR, WD, CLIP, SIGMA, DROP = 1e-3, 1e-4, 1e-2, 0.5, 0.0, 0.2
STEPS, BATCH, ACCUM, FRAMES = 3, 2, 2, 30  # items of 15-20 frames bucket to 30


def test_trainer_steps_match_a_jax_loop():
    jvb, _, params, d_in = _models()
    rs = np.random.RandomState(24)
    items = []
    for n in rs.randint(15, 21, 12):
        items.append((rs.randn(n, d_in).astype(np.float32),
                      rs.randint(0, N_COND_TOKENS, n).astype(np.int32)))
    port = _port(params)
    init = {k: v.detach().clone() for k, v in port.named_parameters()}
    cfm = ConditionalFlowMatcherWrapper(port, sigma=SIGMA, cond_drop_prob=DROP, device="cpu")
    trainer = VoiceBoxTrainer(
        cfm, batch_size=BATCH, dataset=ArrayDataset(items), num_train_steps=STEPS,
        num_warmup_steps=1, lr=LR, initial_lr=INITIAL_LR, wd=WD, max_grad_norm=CLIP,
        grad_accum_every=ACCUM, valid_frac=0.25, bucket_multiple=16, log_every=1,
        save_results_every=2, device="cpu",
    )
    batches = []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    trainer.dl_iter = recorded(trainer.dl_iter)
    step_draws, losses = [], []
    for _ in range(STEPS):
        m = BATCH * ACCUM
        draws = dict(noise=rs.randn(m, FRAMES, d_in).astype(np.float32),
                     times=rs.rand(m).astype(np.float32),
                     cond_mask=rs.rand(m, FRAMES) < 0.7,
                     cond_drop_mask=rs.rand(m) < DROP)
        step_draws.append(draws)
        logs = trainer.train_step(**{k: _t(v) for k, v in draws.items()})
        losses.append(logs["loss"].item())
    assert trainer.steps == STEPS and [r["step"] for r in trainer.metrics
                                       if "valid_loss" in r] == [0, 2]

    # the JAX loop: value_and_grad per micro-batch, mean, clip + AdamW + schedule
    opt = jax_get_optimizer(lr=jax_schedule(LR, INITIAL_LR, 1, STEPS), wd=WD,
                            max_grad_norm=CLIP)

    @jax.jit
    def micro(p, x1, mask, ids, x0, t, cm, dm):
        w, flow = jax_cfm_interpolant(x1, x0, t, SIGMA)
        return jvb.apply({"params": p}, w, times=t, cond_token_ids=ids, self_attn_mask=mask,
                         cond_drop_mask=dm, target=flow, cond_mask=cm, train=True)

    grad_fn = jax.jit(jax.value_and_grad(micro))

    @jax.jit
    def opt_step(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state
    jparams, state = params, opt.init(params)
    for ((x, mask), (ids, _)), draws, loss in zip(batches, step_draws, losses):
        assert x.shape == (BATCH * ACCUM, FRAMES, d_in)
        total, grads = 0.0, None
        for i in range(ACCUM):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            args = [x[sl], mask[sl], ids[sl]] + [draws[k][sl] for k in
                                                 ("noise", "times", "cond_mask", "cond_drop_mask")]
            value, g = grad_fn(jparams, *(jnp.asarray(a) for a in args))
            total += float(value)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda a: a / ACCUM, grads)
        np.testing.assert_allclose(loss, total / ACCUM, atol=ATOL, rtol=0)
        jparams, state = opt_step(grads, state, jparams)

    ref_final = voicebox_state_dict(jax.tree.map(np.asarray, jparams))
    ref_updates = {k: ref_final[k].numpy() - init[k].numpy() for k in init}
    ours = {k: (p.detach() - init[k]).numpy() for k, p in port.named_parameters()}
    # Adam's first steps move each weight by about lr whatever its gradient's
    # size, so a weight whose gradient is near zero carries the gradients'
    # rounding amplified (measured: 2 of 16384 weights of one leaf differ by
    # 0.19 lr). A flipped or wrong update is off by ~2 lr: atol 0.25 lr.
    _assert_leaves_close(ours, ref_updates, atol=0.25 * LR)


# raw waves through a tiny MelVoco (8 mels, n_fft 256, win 160, hop 64): the
# trainer's buckets are in samples, (registers + frame_offset) x 64 below a
# multiple of 128 x 64, so every batch here pads to 8000 samples = 126 frames
# + 2 registers = 128 tokens
WAVE_MEL = dict(n_mels=8, n_fft=256, win_length=160)
WAVE_VOCOS = dict(input_channels=8, dim=16, intermediate_dim=24, num_layers=1, n_fft=256,
                  hop_length=64)
WAVE_FRAMES = 126


def test_trainer_steps_on_raw_waves_match_a_jax_loop():
    from voicebox_tpu import VoiceBox as JaxVoiceBox
    from voicebox_tpu.models.codec import MelVoco as JaxMelVoco
    from voicebox_tpu.models.vocos import Vocos as JaxVocos
    from test_torch_transformer import _perturbed
    from voicebox_tpu_torch import MelVoco
    from voicebox_tpu_torch.models.vocos import Vocos

    kw = {k: v for k, v in CONFIG.items() if k != "num_cond_tokens"}
    kw.update(condition_on_text=False)
    jcodec = JaxMelVoco(vocos=JaxVocos(**WAVE_VOCOS, params={}), **WAVE_MEL)  # encode only
    jvb = JaxVoiceBox(audio_enc_dec=jcodec, **kw)
    z = jnp.zeros((B, N, 8))
    params = jax.jit(lambda r: jvb.init({"params": r}, z, times=jnp.zeros((B,)), cond=z,
                                        cond_drop_prob=0.0))(jax.random.PRNGKey(3))["params"]
    params = _perturbed(params, np.random.RandomState(4))
    port = VoiceBox(audio_enc_dec=MelVoco(vocos=Vocos(**WAVE_VOCOS), **WAVE_MEL), **kw)
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."), strict=True)
    init = {k: v.detach().clone() for k, v in port.named_parameters()}

    rs = np.random.RandomState(25)
    waves = []
    for n in rs.randint(1500, 3000, 10):
        t = np.arange(n) / 24000.0
        waves.append((0.4 * np.sin(2 * np.pi * rs.uniform(200, 3000) * t)
                      + 0.05 * rs.randn(n)).astype(np.float32))
    cfm = ConditionalFlowMatcherWrapper(port, sigma=SIGMA, cond_drop_prob=DROP, device="cpu")
    trainer = VoiceBoxTrainer(
        cfm, batch_size=BATCH, dataset=ArrayDataset(waves), num_train_steps=STEPS,
        num_warmup_steps=1, lr=LR, initial_lr=INITIAL_LR, wd=WD, max_grad_norm=CLIP,
        grad_accum_every=ACCUM, valid_frac=0.2, log_every=1, save_results_every=2,
        device="cpu",
    )
    batches = []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    trainer.dl_iter = recorded(trainer.dl_iter)
    step_draws, losses = [], []
    for _ in range(STEPS):
        m = BATCH * ACCUM
        draws = dict(noise=rs.randn(m, WAVE_FRAMES, 8).astype(np.float32),
                     times=rs.rand(m).astype(np.float32),
                     cond_mask=rs.rand(m, WAVE_FRAMES) < 0.7,
                     cond_drop_mask=rs.rand(m) < DROP)
        step_draws.append(draws)
        losses.append(trainer.train_step(**{k: _t(v) for k, v in draws.items()})["loss"].item())

    opt = jax_get_optimizer(lr=jax_schedule(LR, INITIAL_LR, 1, STEPS), wd=WD,
                            max_grad_norm=CLIP)

    @jax.jit
    def micro(p, x1, mask, x0, t, cm, dm):
        w, flow = jax_cfm_interpolant(x1, x0, t, SIGMA)
        return jvb.apply({"params": p}, w, times=t, self_attn_mask=mask, cond_drop_mask=dm,
                         target=flow, cond_mask=cm, train=True)

    grad_fn = jax.jit(jax.value_and_grad(micro))

    @jax.jit
    def opt_step(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state
    jparams, state = params, opt.init(params)
    for (wave, wave_mask), draws, loss in zip(batches, step_draws, losses):
        assert wave.shape == (BATCH * ACCUM, 8000)
        # the JAX trainer's _prepare_batch: the frozen codec, frame masks by ceil
        x = np.asarray(jcodec.encode(jnp.asarray(wave)))
        ds = wave_mask.shape[-1] / x.shape[1]
        frame_len = np.ceil(wave_mask.sum(-1) / ds).astype(np.int64)
        mask = np.arange(x.shape[1])[None, :] < frame_len[:, None]
        assert x.shape[1] == WAVE_FRAMES
        total, grads = 0.0, None
        for i in range(ACCUM):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            args = [x[sl], mask[sl]] + [draws[k][sl] for k in
                                        ("noise", "times", "cond_mask", "cond_drop_mask")]
            value, g = grad_fn(jparams, *(jnp.asarray(a) for a in args))
            total += float(value)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda a: a / ACCUM, grads)
        np.testing.assert_allclose(loss, total / ACCUM, atol=ATOL, rtol=0)
        jparams, state = opt_step(grads, state, jparams)

    ref_final = voicebox_state_dict(jax.tree.map(np.asarray, jparams))
    ref_updates = {k: ref_final[k].numpy() - init[k].numpy() for k in init}
    ours = {k: (p.detach() - init[k]).numpy() for k, p in port.named_parameters()}
    _assert_leaves_close(ours, ref_updates, atol=0.25 * LR)


def test_raw_audio_loss_is_the_loss_of_its_encoded_latents():
    """`wrapper(x1=<wave>, cond=<wave>, input_sampling_rate=16000)`
    resamples to the codec's 24 kHz and encodes both without gradient; its
    loss is the loss of those latents, to the bit."""
    from voicebox_tpu_torch import MelVoco
    from voicebox_tpu_torch.models.vocos import Vocos
    from voicebox_tpu_torch.ops.stft import resample

    kw = {k: v for k, v in CONFIG.items() if k != "num_cond_tokens"}
    torch.manual_seed(0)
    codec = MelVoco(vocos=Vocos(**WAVE_VOCOS), **WAVE_MEL)
    cfm = ConditionalFlowMatcherWrapper(VoiceBox(audio_enc_dec=codec, condition_on_text=False,
                                                 **kw), device="cpu")
    rs = np.random.RandomState(26)
    wave = _t(rs.randn(2, 1 * 1600).astype(np.float32) * 0.3)  # 0.1 s at 16 kHz
    latents = codec.encode(resample(wave, 16000, 24000))
    frames = latents.shape[1]
    draws = dict(noise=_t(rs.randn(2, frames, 8).astype(np.float32)),
                 times=_t(rs.rand(2).astype(np.float32)),
                 cond_mask=_t(rs.rand(2, frames) < 0.5))
    raw = cfm(wave[:, None, :], cond=wave, input_sampling_rate=16000, **draws)
    ref = cfm(latents, cond=latents, **draws)
    assert raw.item() == ref.item() and np.isfinite(raw.item())
    raw.backward()
    assert all(p.grad is not None for p in cfm.voicebox.to_pred.parameters())
