"""The port's duration-predictor training against the JAX package, on the
CPU in float32, at tiny widths (dim 32, depth 2, 4 x 8 heads; aligner on
8-bin mels), the weights carried by `utils/convert.py` with noise on every
leaf:

* `Aligner` soft alignment and log-probabilities: atol 2e-4 on the real
  phonemes (the masked ones sit at -1e9);
* the predictor's training loss (span-masked L1 against the MAS durations
  plus the forward-sum loss) at atol 2e-4, its MAS durations equal, and its
  gradient per parameter at cosine > 0.999 and atol 2e-3, with the span
  mask injected; the JAX side runs its reference attention (its Pallas
  backward gives NaN on fully-masked rows, ROADMAP Queue 3);
* three `DurationPredictorTrainer` steps on (text, wave) items through a
  tiny MelVoco (its mels double as the aligner's), with gradient
  accumulation, clip and Adam under warmup -> cosine, against a JAX loop of
  `value_and_grad` of the JAX `loss_fn` and `get_optimizer` on the same
  batches and span masks, each loss at atol 2e-4 and each parameter's
  update at atol 0.25 lr (Adam's first steps move a weight by about lr
  whatever its gradient's size);
* a checkpoint written by `save` resumes the run exactly on the CPU.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import _assert_leaves_close
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu.models import duration as jd
from voicebox_tpu.models.codec import MelVoco as JaxMelVoco
from voicebox_tpu.models.vocos import Vocos as JaxVocos
from voicebox_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from voicebox_tpu.training.optimizer import warmup_cosine_schedule as jax_schedule
from voicebox_tpu.utils import tokenizer as jtok
from voicebox_tpu_torch import DurationPredictorTrainer, MelVoco
from voicebox_tpu_torch.models import duration as td
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.parallel.mesh import make_mesh
from voicebox_tpu_torch.training import PairedDataset
from voicebox_tpu_torch.utils import tokenizer as ttok
from voicebox_tpu_torch.utils.convert import aligner_state_dict, duration_predictor_state_dict

ATOL = 2e-4
N_MELS, HOP = 8, 64
MEL = dict(n_mels=N_MELS, n_fft=256, win_length=160)
VOCOS = dict(input_channels=N_MELS, dim=16, intermediate_dim=24, num_layers=1, n_fft=256,
             hop_length=HOP)
DP_CONFIG = dict(dim_phoneme_emb=32, dim=32, depth=2, dim_head=8, heads=4,
                 aligner_dim_in=N_MELS, aligner_attn_channels=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _models():
    jcodec = JaxMelVoco(vocos=JaxVocos(**VOCOS, params={}), **MEL)  # encode only: no weights
    jdp = jd.DurationPredictor(tokenizer=jtok.GraphemeTokenizer(), audio_enc_dec=jcodec,
                               **DP_CONFIG)
    # the net inits through its inference forward and the aligner alone, so
    # that no init compiles MAS and the CTC (the training forward's programs)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = jax.jit(functools.partial(jdp.net.init, train=False))(
        {"params": k1}, cond=jnp.zeros((2, 24, N_MELS)),
        phoneme_ids=jnp.zeros((2, 12), jnp.int32))["params"]
    aligner = jd.Aligner(dim_in=N_MELS, dim_hidden=32, attn_channels=8)
    params = dict(params, aligner=jax.jit(aligner.init)(
        k2, jnp.zeros((2, N_MELS, 24)), jnp.zeros((2, 12, 32)))["params"])
    params = _perturbed(params, np.random.RandomState(1))
    params["to_pred"]["bias"] = params["to_pred"]["bias"] + 3.0
    jdp.params = params
    return jdp, params


def _port(params):
    codec = MelVoco(vocos=Vocos(**VOCOS), **MEL)
    dp = td.DurationPredictor(tokenizer=ttok.GraphemeTokenizer(), audio_enc_dec=codec,
                              **DP_CONFIG)
    np_params = jax.tree.map(np.asarray, params)
    dp.net.load_state_dict(_xla_inv_freq(duration_predictor_state_dict(np_params),
                                         "transformer."), strict=True)
    dp.aligner.load_state_dict(aligner_state_dict(np_params["aligner"]), strict=True)
    return dp


def _grads_by_name(grads):
    np_grads = jax.tree.map(np.asarray, grads)
    out = {f"net.{k}": v.numpy() for k, v in duration_predictor_state_dict(np_grads).items()}
    out.update({f"aligner.{k}": v.numpy() for k, v in aligner_state_dict(
        np_grads["aligner"]).items()})
    return out


def _batch(seed, b=3, t_ph=12, t=30):
    """Ragged phonemes (pads -1), dB-like mels of the latent width (the
    MelVoco case: the mel doubles as the cond), ragged frames."""
    rs = np.random.RandomState(seed)
    ph_len = np.array([12, 7, 4][:b], np.int32)
    mel_len = np.array([30, 22, 15][:b], np.int32)
    ids = rs.randint(0, 40, (b, t_ph)).astype(np.int32)
    ids[np.arange(t_ph)[None, :] >= ph_len[:, None]] = -1
    mel = (rs.randn(b, t, N_MELS) * 15 - 40).astype(np.float32)
    mel_mask = np.arange(t)[None, :] < mel_len[:, None]
    mel[~mel_mask] = 0.0
    cond_mask = rs.rand(b, t) < 0.6
    return dict(cond=mel, phoneme_ids=ids, mel=mel, phoneme_len=ph_len, mel_len=mel_len,
                phoneme_mask=ids != -1, mel_mask=mel_mask, cond_mask=cond_mask)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_aligner_matches_jax():
    _, params = _models()
    al = jd.Aligner(dim_in=N_MELS, dim_hidden=32, attn_channels=8)
    batch = _batch(2)
    keys = np.random.RandomState(3).randn(3, 12, 32).astype(np.float32)
    soft_j, lp_j = al.apply({"params": params["aligner"]}, jnp.asarray(batch["mel"]).transpose(0, 2, 1),
                            jnp.asarray(keys), jnp.asarray(batch["phoneme_mask"]))
    port = _port(params).aligner
    with torch.no_grad():
        soft, lp = port(_t(batch["mel"]).transpose(1, 2), _t(keys), _t(batch["phoneme_mask"]))
    assert soft.shape == lp.shape == (3, 1, 30, 12)
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_j), atol=ATOL, rtol=0)
    real = np.broadcast_to(batch["phoneme_mask"][:, None, None, :], lp.shape)
    np.testing.assert_allclose(lp.numpy()[real], np.asarray(lp_j)[real], atol=ATOL, rtol=0)


def test_aligner_stays_fp32_under_a_bf16_net():
    """The reference builds its Aligner without a dtype, so a bf16 net's
    phoneme embeddings are aligned in fp32; the port's matches it (atol
    ATOL) on the same bf16 keys."""
    _, params = _models()
    dp = td.DurationPredictor(tokenizer=ttok.GraphemeTokenizer(), dtype=torch.bfloat16,
                              **DP_CONFIG)
    assert {p.dtype for p in dp.aligner.parameters()} == {torch.float32}
    dp.aligner.load_state_dict(aligner_state_dict(jax.tree.map(np.asarray, params["aligner"])))
    batch = _batch(2)
    keys = np.random.RandomState(3).randn(3, 12, 32).astype(np.float32)
    keys_bf16 = torch.from_numpy(keys).to(torch.bfloat16)
    al = jd.Aligner(dim_in=N_MELS, dim_hidden=32, attn_channels=8)
    soft_j, _ = al.apply({"params": params["aligner"]},
                         jnp.asarray(batch["mel"]).transpose(0, 2, 1),
                         jnp.asarray(keys_bf16.float().numpy(), jnp.bfloat16),
                         jnp.asarray(batch["phoneme_mask"]))
    with torch.no_grad():
        soft, lp = dp.aligner(_t(batch["mel"]).transpose(1, 2), keys_bf16,
                              _t(batch["phoneme_mask"]))
    assert soft_j.dtype == jnp.float32 and soft.dtype == lp.dtype == torch.float32
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_j), atol=ATOL, rtol=0)


def test_predictor_loss_and_gradients_match_jax():
    jdp, params = _models()
    batch = _batch(4)
    drop = np.array([False, True, False])

    def loss_fn(p):
        return jdp.loss_fn(p, jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in batch.items()},
                           cond_drop_mask=jnp.asarray(drop), return_aligned_phoneme_ids=True)

    (ref, ref_target), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    dp = _port(params)
    loss, target = dp.loss_fn(**{k: _t(v) for k, v in batch.items()},
                              cond_drop_mask=_t(drop), return_aligned_phoneme_ids=True)
    loss.backward()
    np.testing.assert_array_equal(target.numpy(), np.asarray(ref_target))
    assert (target.numpy().sum(-1) == batch["mel_len"]).all()
    np.testing.assert_allclose(loss.item(), float(ref), atol=ATOL, rtol=0)
    ref_g = _grads_by_name(ref_grads)
    ours = {n: p.grad.numpy() for n, p in dp.named_parameters()}
    assert set(ours) <= set(ref_g)
    _assert_leaves_close(ours, ref_g)
    # the facade's forward(train=True) is loss_fn
    again = dp(train=True, **{k: _t(v) for k, v in batch.items()}, cond_drop_mask=_t(drop))
    assert again.item() == loss.item()


LR, INITIAL_LR, CLIP = 1e-3, 1e-4, 0.5
STEPS, BATCH, ACCUM = 3, 2, 2
FRAMES = 2048 // HOP + 1  # every wave pads to 2048 samples (a bucket is 16 frames x 64 samples)
TEXTS = ["hello there", "a short one", "speech", "duration model", "mas path",
         "forward sum", "tiny test", "aligner", "ok", "zero shot"]


def _dataset():
    rs = np.random.RandomState(5)
    items = []
    for text in TEXTS:
        n = int(rs.randint(1100, 2000))  # 18-32 frames at hop 64: more than the phonemes
        t = np.arange(n) / 24000.0
        wave = 0.4 * np.sin(2 * np.pi * rs.uniform(200, 3000) * t) + 0.05 * rs.randn(n)
        items.append((text, wave.astype(np.float32)))
    return PairedDataset(items)


def _trainer(dp, **kw):
    return DurationPredictorTrainer(
        dp, batch_size=BATCH, dataset=_dataset(), num_train_steps=STEPS, num_warmup_steps=1,
        lr=LR, initial_lr=INITIAL_LR, max_grad_norm=CLIP, grad_accum_every=ACCUM,
        valid_frac=0.2, phoneme_bucket_multiple=16, frame_bucket_multiple=16, log_every=1,
        save_results_every=2, device="cpu", **kw)


def test_trainer_steps_match_a_jax_loop(tmp_path):
    jdp, params = _models()
    dp = _port(params)
    init = {k: v.detach().clone() for k, v in dp.named_parameters()}
    trainer = _trainer(dp, results_folder=str(tmp_path), save_model_every=2)
    batches = []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    trainer.dl_iter = recorded(trainer.dl_iter)
    rs = np.random.RandomState(6)
    span_masks, losses = [], []
    for _ in range(STEPS):
        span = rs.rand(BATCH * ACCUM, FRAMES) < 0.6
        span_masks.append(span)
        losses.append(trainer.train_step(cond_mask=_t(span))["loss"].item())
    assert trainer.steps == STEPS
    assert [r["step"] for r in trainer.metrics if "valid_loss" in r] == [0, 2]
    assert (tmp_path / "duration.0.pt").exists() and (tmp_path / "duration.2.pt").exists()

    # the JAX loop: the JAX codec encodes the same waves, value_and_grad per
    # micro-batch, mean, clip + Adam + schedule
    opt = jax_get_optimizer(lr=jax_schedule(LR, INITIAL_LR, 1, STEPS), wd=0.0,
                            max_grad_norm=CLIP)
    codec = jdp.audio_enc_dec

    @jax.jit
    def micro(p, ids, cond, ph_len, mel_len, ph_mask, mel_mask, span):
        return jdp.loss_fn(p, jax.random.PRNGKey(0), cond=cond, phoneme_ids=ids, mel=cond,
                           phoneme_len=ph_len, mel_len=mel_len, phoneme_mask=ph_mask,
                           mel_mask=mel_mask, cond_mask=span)

    grad_fn = jax.jit(jax.value_and_grad(micro))

    @jax.jit
    def opt_step(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state
    jparams, state = params, opt.init(params)
    for ((ids, ph_mask), (waves, wave_mask)), span, loss in zip(batches, span_masks, losses):
        cond = np.asarray(codec.encode(jnp.asarray(waves)))
        ds = wave_mask.shape[-1] / cond.shape[1]
        frame_len = np.ceil(wave_mask.sum(-1) / ds).astype(np.int64)
        mel_mask = np.arange(cond.shape[1])[None, :] < frame_len[:, None]
        total, grads = 0.0, None
        for i in range(ACCUM):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            args = (ids[sl], cond[sl], ph_mask[sl].sum(-1), mel_mask[sl].sum(-1), ph_mask[sl],
                    mel_mask[sl], span[sl])
            value, g = grad_fn(jparams, *(jnp.asarray(a) for a in args))
            total += float(value)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda a: a / ACCUM, grads)
        np.testing.assert_allclose(loss, total / ACCUM, atol=ATOL, rtol=0)
        jparams, state = opt_step(grads, state, jparams)

    ref_final = _grads_by_name(jparams)  # the same key map as the weights
    ref_updates = {k: ref_final[k] - init[k].numpy() for k in init}
    ours = {k: (p.detach() - init[k]).numpy() for k, p in dp.named_parameters()}
    _assert_leaves_close(ours, ref_updates, atol=0.25 * LR)


def test_checkpoint_resumes_exactly(tmp_path):
    _, params = _models()
    items = [("same text", np.sin(np.arange(2000) * 0.05).astype(np.float32))] * 4
    span = _t(np.random.RandomState(8).rand(BATCH * ACCUM, FRAMES) < 0.6)

    def run(dp):
        return DurationPredictorTrainer(
            dp, batch_size=BATCH, dataset=PairedDataset(items), num_train_steps=STEPS,
            lr=LR, grad_accum_every=ACCUM, valid_frac=0.0, phoneme_bucket_multiple=8,
            frame_bucket_multiple=16, save_results_every=100, prefetch_batches=0,
            device="cpu")

    full = run(_port(params))
    losses = [full.train_step(cond_mask=span)["loss"].item() for _ in range(STEPS)]
    first = run(_port(params))
    for _ in range(2):
        first.train_step(cond_mask=span)
    first.save(tmp_path / "mid.pt")
    resumed = run(td.DurationPredictor(tokenizer=ttok.GraphemeTokenizer(),
                                       audio_enc_dec=MelVoco(vocos=Vocos(**VOCOS), **MEL),
                                       **DP_CONFIG))
    resumed.load(tmp_path / "mid.pt")
    assert resumed.steps == 2
    assert resumed.train_step(cond_mask=span)["loss"].item() == losses[2]
    for (n, a), (_, b) in zip(full.module.named_parameters(), resumed.module.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_trainer_rejects_what_is_not_ported():
    _, params = _models()
    # a model-parallel mesh spans processes: one process has no group to build it on
    with pytest.raises(RuntimeError, match="process group"):
        _trainer(_port(params), mesh=make_mesh(model_parallel=2))
    with pytest.raises(TypeError, match="DeviceMesh"):
        _trainer(_port(params), mesh=object())
    with pytest.raises(ValueError, match="aligner_dim_in"):
        DurationPredictorTrainer(_port(params), batch_size=1, valid_frac=0.0, num_train_steps=1,
                                 dataset=PairedDataset([("a", np.zeros((5, 3), np.float32))]),
                                 device="cpu")


def test_paired_loader_and_tokenized_view_match_jax():
    from voicebox_tpu.training import data as jdata
    from voicebox_tpu_torch.training import data as tdata

    ds = _dataset()
    views = (jdata.TokenizedTextDataset(jdata.PairedDataset(ds.items), jtok.GraphemeTokenizer()),
             tdata.TokenizedTextDataset(ds, ttok.GraphemeTokenizer()))
    kw = dict(bucket_multiples=(8, 1024), pad_values=(-1, 0.0), max_lengths=(12, None), seed=3)
    loaders = (jdata.PairedDataLoader(views[0], 4, **kw), tdata.PairedDataLoader(views[1], 4, **kw))
    for _, (ref, out) in zip(range(4), zip(loaders[0].cycle(), loaders[1].cycle())):
        for (a, am), (b, bm) in zip(ref, out):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(am, bm)
    ids, _ = out[0]
    assert ids.shape[1] <= 12 and (ids[~out[0][1]] == -1).all()


def test_batches_of_each_item_layout():
    """(text, wave) through a codec whose latents are not the aligner's
    width: the aligner's mel is a log-mel at aligner_dim_in on the codec's
    hop grid, as the JAX trainer's `_mel_for_aligner` makes it (dB at atol
    1e-2, frame masks equal); (ids, latents) reuse the latents; (ids,
    latents, mel) take the explicit mel."""
    import types

    from voicebox_tpu.training.duration_trainer import DurationPredictorTrainer as JaxTrainer
    from voicebox_tpu_torch.models.codec import EncodecVoco
    from voicebox_tpu_torch.models.encodec import ResidualVQ

    codec = EncodecVoco(quantizer=ResidualVQ(2, 16, 16),
                        vocos=Vocos(input_channels=16, dim=16, intermediate_dim=24, num_layers=1,
                                    n_fft=256, hop_length=64, num_bandwidths=4, codebook_size=16,
                                    num_quantizers=2),
                        ratios=(4, 4, 2, 2), n_filters=2)
    dp = td.DurationPredictor(tokenizer=ttok.GraphemeTokenizer(), audio_enc_dec=codec,
                              **DP_CONFIG)
    waves = [w for _, w in _dataset().items[:4]]
    trainer = DurationPredictorTrainer(
        dp, batch_size=4, dataset=PairedDataset([("ab", w) for w in waves]), num_train_steps=1,
        valid_frac=0.0, frame_bucket_multiple=16, prefetch_batches=0, device="cpu")
    fields = next(trainer.dl_iter)
    batch = trainer._prepare_batch(fields)
    wave, wave_mask = fields[1]
    fake = types.SimpleNamespace(dp=types.SimpleNamespace(
        audio_enc_dec=types.SimpleNamespace(downsample_factor=64, sampling_rate=24000),
        net=types.SimpleNamespace(aligner_dim_in=N_MELS)))
    ref_mel, ref_mask = JaxTrainer._mel_for_aligner(fake, wave, wave_mask)
    assert batch["cond"].shape == (4, 2048 // 64, 16)  # SEANet latents
    assert batch["mel"].shape == (4, 2048 // 64 + 1, N_MELS)
    np.testing.assert_allclose(batch["mel"].numpy(), np.asarray(ref_mel), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(batch["mel_mask"].numpy(), ref_mask)
    assert (batch["mel_len"].numpy() == ref_mask.sum(-1)).all()

    lat = [np.random.RandomState(i).randn(20 + i, N_MELS).astype(np.float32) for i in range(4)]
    for items, want_mel in (([([1, 2, 3], x) for x in lat], "latents"),
                            ([([1, 2], x, x[:, :N_MELS] * 2) for x in lat], "explicit")):
        t = DurationPredictorTrainer(_port(_models()[1]), batch_size=4,
                                     dataset=PairedDataset(items), num_train_steps=1,
                                     valid_frac=0.0, prefetch_batches=0, device="cpu")
        b = t._prepare_batch(next(t.dl_iter))
        expected = b["cond"] if want_mel == "latents" else b["cond"] * 2
        torch.testing.assert_close(b["mel"], expected, rtol=0, atol=0)
        assert b["phoneme_ids"].shape[1] == 16 and (b["phoneme_ids"][:, 3:] == -1).all()


def test_epochs_metrics_and_trackers(tmp_path):
    """num_epochs counts passes over the training split; metrics.jsonl and
    the trackers get the JAX trainer's records."""
    records, finished = [], []

    class Tracker:
        def init_trackers(self, project, config):
            records.append(("init", project, config["num_train_steps"]))

        def log(self, values, step):
            records.append((step, sorted(values)))

        def finish(self):
            finished.append(True)

    t = DurationPredictorTrainer(
        _port(_models()[1]), batch_size=2, dataset=_dataset(), num_epochs=2, valid_frac=0.2,
        phoneme_bucket_multiple=16, frame_bucket_multiple=16, log_every=1, save_results_every=1,
        results_folder=str(tmp_path), trackers=(Tracker(), lambda r, s: records.append(s)),
        prefetch_batches=0, device="cpu")
    assert t.num_train_steps == 2 * (8 // 2)  # 8 training items, 2 a step, 2 epochs
    t.num_train_steps = 2
    t.train()
    assert records[0] == ("init", "duration_predictor", 8) and finished == [True]
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines if "train_loss" in r] == [0, 1]
    assert [r["step"] for r in lines if "valid_loss" in r] == [0, 1]
    assert ((1, ["train_loss"]) in records) and ((1, ["valid_loss"]) in records)
