"""The port's TextToSemanticTrainer against a JAX loop, on the CPU in
float32, with the tiny seq2seq of `test_torch_text_to_semantic.py`:

* three steps on (text, semantic ids) items, with gradient accumulation,
  the clip and Adam under warmup -> cosine, against `value_and_grad` of the
  JAX `loss_fn` and the JAX `get_optimizer` on the same batches: each loss
  at atol 2e-4, each parameter's update at atol 0.25 lr (Adam's first steps
  move a weight by about lr whatever its gradient's size);
* (text, wave) items: ids through a tiny HuBERT, -1 at every frame at or
  past a row's true frame count;
* the EMA and `generate(use_ema=)`, and a checkpoint that resumes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_hubert as th
import test_torch_text_to_semantic as tt
from test_torch_train import _assert_leaves_close
from voicebox_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from voicebox_tpu.training.optimizer import warmup_cosine_schedule as jax_schedule
from voicebox_tpu_torch import TextToSemanticTrainer
from voicebox_tpu_torch.training import PairedDataset
from voicebox_tpu_torch.utils.convert import text_to_semantic_state_dict

ATOL = 2e-4
BATCH, ACCUM, STEPS = 2, 2, 3
LR, INITIAL_LR, CLIP = 1e-3, 1e-4, 0.5
TEXTS = ["hello there", "a short one", "speech", "semantic ids", "seq to seq", "tiny test",
         "decoder", "ok", "zero shot", "encoder side"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id_items():
    rs = np.random.RandomState(5)
    return PairedDataset([(t, rs.randint(0, tt.CFG["num_semantic_token_ids"],
                                         rs.randint(3, 12)).astype(np.int64)) for t in TEXTS])


def _trainer(t2s, dataset, **kw):
    kw = {**dict(batch_size=BATCH, num_train_steps=STEPS, num_warmup_steps=1, lr=LR,
                 initial_lr=INITIAL_LR, max_grad_norm=CLIP, grad_accum_every=ACCUM,
                 valid_frac=0.2, text_bucket_multiple=8, semantic_bucket_multiple=8,
                 log_every=1, save_results_every=2, device="cpu"), **kw}
    return TextToSemanticTrainer(t2s, dataset=dataset, **kw)


def test_trainer_steps_match_a_jax_loop(tmp_path):
    jt, params = tt._models()
    t2s = tt._port()
    init = {k: v.detach().clone() for k, v in t2s.named_parameters()}
    trainer = _trainer(t2s, _id_items(), results_folder=str(tmp_path), save_model_every=2)
    batches = []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    trainer.dl_iter = recorded(trainer.dl_iter)
    losses = [trainer.train_step()["loss"].item() for _ in range(STEPS)]
    assert [r["step"] for r in trainer.metrics if "valid_loss" in r] == [0, 2]
    assert (tmp_path / "text_to_semantic.0.pt").exists()

    opt = jax_get_optimizer(lr=jax_schedule(LR, INITIAL_LR, 1, STEPS), wd=0.0,
                            max_grad_norm=CLIP)
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn))

    @jax.jit
    def opt_step(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    for ((ids, _), (sem, _)), loss in zip(batches, losses):
        total, grads = 0.0, None
        for i in range(ACCUM):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            value, g = grad_fn(jparams, jnp.asarray(ids[sl]), jnp.asarray(sem[sl]))
            total += float(value)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda a: a / ACCUM, grads)
        np.testing.assert_allclose(loss, total / ACCUM, atol=ATOL, rtol=0)
        jparams, state = opt_step(grads, state, jparams)
    final = {k: v.numpy() for k, v in text_to_semantic_state_dict(
        jax.tree.map(np.asarray, jparams), dim_head=tt.CFG["dim_head"]).items()}
    ref_updates = {k: final[k] - init[k].numpy() for k in init}
    ours = {k: (p.detach() - init[k]).numpy() for k, p in t2s.named_parameters()}
    _assert_leaves_close(ours, ref_updates, atol=0.25 * LR)


def test_wave_items_derive_masked_ids():
    hubert = th._models(False, None)[1]
    t2s = tt._port()
    t2s.__dict__["wav2vec"] = hubert
    rs = np.random.RandomState(8)
    lengths = [3000, 4400, 5200, 3700, 4000, 6000, 3300, 5000, 4700, 3900]
    items = PairedDataset([(t, rs.randn(n).astype(np.float32)) for t, n in zip(TEXTS, lengths)])
    trainer = _trainer(t2s, items, semantic_bucket_multiple=4)
    fields = next(trainer.dl_iter)
    batch = trainer._prepare_batch(fields)
    waves, mask = fields[1]
    waves = torch.as_tensor(waves)
    assert waves.shape[1] % (4 * 320) == 0
    ids = hubert(waves)
    true_frames = [hubert.num_frames(int(n)) for n in torch.as_tensor(mask).sum(-1)]
    for row, n in enumerate(true_frames):
        assert (batch["semantic_ids"][row, n:] == -1).all()
        assert torch.equal(batch["semantic_ids"][row, :n], ids[row, :n])
    assert batch["semantic_ids"].shape == ids.shape
    out = trainer.train_step()
    assert np.isfinite(out["loss"].item()) and np.isfinite(out["grad_norm"].item())


def test_ema_generate_and_resume(tmp_path):
    def run(**kw):
        return _trainer(tt._port(), PairedDataset([("hello there", np.arange(5))] * 10),
                        ema_decay=0.9, **kw)

    full = run()
    losses = [full.train_step()["loss"].item() for _ in range(STEPS)]
    first = run()
    for _ in range(2):
        first.train_step()
    first.save(tmp_path / "ckpt.pt")
    resumed = run()
    resumed.load(tmp_path / "ckpt.pt")
    assert resumed.steps == 2
    assert resumed.train_step()["loss"].item() == losses[2]
    for (k, a), (_, b) in zip(full.t2s.state_dict().items(), resumed.t2s.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(full.ema.shadow, resumed.ema.shadow):
        assert torch.equal(a, b)
    txt = [[8, 5, 12, 12, 15]]
    with_ema = full.generate(txt, max_length=8, use_ema=True)
    assert not torch.equal(full.params[0], full.ema.shadow[0])
    assert with_ema.shape == full.generate(txt, max_length=8).shape == (1, 8)
    with pytest.raises(ValueError):
        _trainer(tt._port(), _id_items()).generate(txt, max_length=2, use_ema=True)
