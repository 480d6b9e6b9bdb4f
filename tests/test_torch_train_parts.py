"""The parts of the port's training step against the JAX package, on the CPU:
the masks (fed JAX's own uniforms), the flow-matching interpolant, the
optimizer (decay mask per key, three AdamW steps with a clip that fires,
the schedule), the data pipeline, and the device default of the entry
points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_voicebox import CONFIG, DIM_IN, _models
from voicebox_tpu.ops import masks as jmasks
from voicebox_tpu.ops.ode import cfm_interpolant as jax_cfm_interpolant
from voicebox_tpu.training import data as jdata
from voicebox_tpu.training.optimizer import decay_mask as jax_decay_mask
from voicebox_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from voicebox_tpu.training.optimizer import warmup_cosine_schedule as jax_schedule
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, VoiceBox, VoiceBoxTrainer
from voicebox_tpu_torch.models.attention import Attention
from voicebox_tpu_torch.ops import masks
from voicebox_tpu_torch.ops.ode import cfm_interpolant
from voicebox_tpu_torch.training import data
from voicebox_tpu_torch.training.config import MeshConfig
from voicebox_tpu_torch.training.optimizer import (
    clip_by_global_norm_f32,
    decay_mask,
    get_optimizer,
    warmup_cosine_lr,
    warmup_cosine_schedule,
)
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


def _u(key, shape, dtype=jnp.float32):
    """JAX's uniforms for `key`, as the port takes them."""
    return torch.from_numpy(np.array(jax.random.uniform(key, shape, dtype=dtype)))


@pytest.mark.parametrize("prob", [0.0, 0.3, 0.8, 1.0])
def test_prob_mask_like_matches_jax(prob):
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jmasks.prob_mask_like(key, (5, 7), prob))
    out = masks.prob_mask_like((5, 7), prob, uniform_draw=_u(key, (5, 7)))
    np.testing.assert_array_equal(out.numpy(), ref)
    if prob in (0.0, 1.0):  # the fast paths draw nothing
        np.testing.assert_array_equal(masks.prob_mask_like((5, 7), prob).numpy(), ref)


@pytest.mark.parametrize("seq_len", [1, 37, 752])
def test_mask_from_frac_lengths_matches_jax(seq_len):
    key_f, key = jax.random.split(jax.random.PRNGKey(seq_len))
    frac = jax.random.uniform(key_f, (9,), minval=0.0, maxval=1.0)
    frac = frac.at[0].set(1.0).at[1].set(0.0)
    ref = np.asarray(jmasks.mask_from_frac_lengths(key, seq_len, frac))
    out = masks.mask_from_frac_lengths(seq_len, torch.from_numpy(np.array(frac)),
                                       uniform_draw=_u(key, (9,)))
    np.testing.assert_array_equal(out.numpy(), ref)
    # lengths truncate toward zero
    lengths = (np.asarray(frac) * seq_len).astype(np.int32)
    np.testing.assert_array_equal(out.sum(-1).numpy(), lengths)


def test_start_end_coin_flip_and_reduce_match_jax():
    start, end = np.array([0.0, 2.7, 5.0]), np.array([3.9, 2.7, 9.0])
    ref = jmasks.mask_from_start_end_indices(8, jnp.asarray(start), jnp.asarray(end))
    out = masks.mask_from_start_end_indices(8, torch.from_numpy(start), torch.from_numpy(end))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        assert bool(masks.coin_flip(uniform_draw=_u(key, ()))) == bool(jmasks.coin_flip(key))
    a, b = out, ~out
    np.testing.assert_array_equal(masks.reduce_masks_with_and(a, None, b).numpy(),
                                  np.asarray(jmasks.reduce_masks_with_and(
                                      jnp.asarray(a.numpy()), None, jnp.asarray(b.numpy()))))
    assert masks.reduce_masks_with_and(None, None) is None


def test_generator_draws_are_reproducible():
    draws = [masks.mask_from_frac_lengths(50, torch.full((4,), 0.5),
                                          generator=torch.Generator().manual_seed(3))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert draws[0].sum().item() == 4 * 25


@pytest.mark.parametrize("sigma", [0.0, 0.1])
def test_cfm_interpolant_matches_jax(sigma):
    rs = np.random.RandomState(2)
    x1, x0 = (rs.randn(3, 11, 5).astype(np.float32) for _ in range(2))
    t = rs.rand(3).astype(np.float32)
    ref = jax_cfm_interpolant(jnp.asarray(x1), jnp.asarray(x0), jnp.asarray(t), sigma)
    out = cfm_interpolant(*(torch.from_numpy(a) for a in (x1, x0, t)), sigma)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_decay_mask_per_key_matches_jax():
    """The ndim of every leaf is the same in both layouts: the JAX decay mask,
    carried through the weight converter as all-ones or all-zeros leaves,
    equals the port's per key."""
    _, _, params, _ = _models()
    flags = jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                         params, jax_decay_mask(params))
    ref = voicebox_state_dict(flags)
    port = VoiceBox(dim_in=DIM_IN, **CONFIG)
    ours = decay_mask(port.named_parameters())
    assert set(ours) == set(ref) - {"null_cond", "transformer.rotary_emb.inv_freq"}
    for key, decays in ours.items():
        assert float(ref[key].min()) == float(ref[key].max()) == float(decays), key
    assert ours["transformer.layers.0.3.q_norm.gamma"]  # (h, 1, d): decays in both
    assert not ours["to_embed.bias"] and not ours["sinu_pos_emb.0.weights"]


def _sched_args():
    return dict(lr=1e-3, initial_lr=1e-5, num_warmup_steps=2, num_train_steps=5)


def test_three_adamw_steps_with_a_firing_clip_match_optax():
    rs = np.random.RandomState(3)
    shapes = {"w": (4, 3), "b": (3,), "gamma": (2, 1, 3), "emb": (5, 2), "s": (6,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = get_optimizer(tparams.items(), lr=1e-3, wd=1e-2)
    sched = warmup_cosine_schedule(opt, 1e-3, 1e-5, 2, 5)
    a = _sched_args()
    jopt = jax_get_optimizer(
        lr=jax_schedule(a["lr"], a["initial_lr"], a["num_warmup_steps"], a["num_train_steps"]),
        wd=1e-2, max_grad_norm=0.5,
    )
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = jopt.init(jparams)
    for step in range(3):
        grads = {k: (3.0 * rs.randn(*s)).astype(np.float32) for k, s in shapes.items()}
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norm = clip_by_global_norm_f32([p.grad for p in tparams.values()], 0.5)
        ref_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        assert norm.item() > 0.5  # the clip fires
        np.testing.assert_allclose(norm.item(), ref_norm, rtol=1e-6)
        opt.step()
        sched.step()
        updates, state = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, state,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{k} after step {step}")


def test_clip_leaves_small_gradients_alone():
    g = [torch.full((3,), 0.1), torch.full((2, 2), -0.1)]
    norm = clip_by_global_norm_f32(g, 0.5)
    assert norm.item() < 0.5
    torch.testing.assert_close(g[0], torch.full((3,), 0.1), rtol=0, atol=0)


def test_adam_without_weight_decay():
    p = torch.nn.Parameter(torch.ones(2, 2))
    assert type(get_optimizer([("w", p)], wd=0.0)) is torch.optim.Adam
    assert type(get_optimizer([("w", p)], wd=1e-2)) is torch.optim.AdamW


@pytest.mark.parametrize("lr,initial_lr,warmup,total", [
    (1e-3, 1e-5, 3, 10), (3e-4, 1e-5, 0, 5), (1e-4, 0.0, 4, 4),
])
def test_schedule_matches_optax(lr, initial_lr, warmup, total):
    ref = jax_schedule(lr, initial_lr, warmup, total)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([p], lr=lr)
    sched = warmup_cosine_schedule(opt, lr, initial_lr, warmup, total)
    atol = 1e-6 * lr  # optax evaluates in fp32: a few ulp of lr
    for step in range(total + warmup + 3):
        want = float(ref(step))
        np.testing.assert_allclose(warmup_cosine_lr(step, lr, initial_lr, warmup, total), want,
                                   rtol=1e-6, atol=atol)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=1e-6, atol=atol)
        opt.step()
        sched.step()


def _items(seed, n_items=11, dim=3):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(5, 40, n_items)
    return [rs.randn(n, dim).astype(np.float32) for n in lengths], lengths


@pytest.mark.parametrize("offset", [0, 16])
def test_loaders_match_jax(offset):
    items, lengths = _items(4)
    kw = dict(batch_size=4, seed=7, bucket_multiple=16, bucket_offset=offset)
    ref = jdata.DataLoader(jdata.ArrayDataset(items), **kw)
    ours = data.DataLoader(data.ArrayDataset(items), **kw)
    for (x, m), (xr, mr) in zip(ours, ref):
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(m, mr)
    pairs = [(x, np.arange(len(x), dtype=np.int32)) for x in items]
    ref = jdata.AlignedPairedDataLoader(jdata.PairedDataset(pairs), **kw)
    ours = data.AlignedPairedDataLoader(data.ArrayDataset(pairs), **kw)
    for ((x, m), (ids, _)), ((xr, mr), (idsr, _)) in zip(ours, ref):
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(m, mr)
        np.testing.assert_array_equal(ids, idsr)
    for frac in (0.25, 0.5):
        split, split_ref = data.random_split(items, frac), jdata.random_split(items, frac)
        assert [len(s) for s in split] == [len(s) for s in split_ref]
        np.testing.assert_array_equal(split[1][0], split_ref[1][0])


def test_collate_bucket_grid_puts_752_frames_on_768_tokens():
    x, mask = data.collate_with_mask([np.zeros((752, 2)), np.zeros((700, 2))],
                                     bucket_offset=16)
    assert x.shape == (2, 752, 2) and mask.sum(-1).tolist() == [752, 700]
    ref = jdata.collate_with_mask([np.zeros((752, 2)), np.zeros((700, 2))], bucket_offset=16)
    np.testing.assert_array_equal(mask, ref[1])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default does not raise here")
    vb = VoiceBox(dim_in=DIM_IN, **CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConditionalFlowMatcherWrapper(vb)
    cfm = ConditionalFlowMatcherWrapper(vb, device="cpu")
    items = [(np.zeros((20, DIM_IN), np.float32), np.zeros(20, np.int32))] * 4
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoiceBoxTrainer(cfm, batch_size=2, dataset=data.ArrayDataset(items), num_train_steps=1)
    VoiceBoxTrainer(cfm, batch_size=2, dataset=data.ArrayDataset(items), num_train_steps=1,
                    valid_frac=0.0, device="cpu")


def test_what_is_not_ported_raises():
    vb = VoiceBox(dim_in=DIM_IN, **CONFIG)
    cfm = ConditionalFlowMatcherWrapper(vb, device="cpu")
    # raw audio is ported: without a codec to encode it the wrapper refuses it
    with pytest.raises(ValueError, match="raw audio"):
        cfm(torch.zeros(2, 320), semantic_token_ids=torch.zeros(2, 4, dtype=torch.long))
    ds = data.ArrayDataset([np.zeros((20, DIM_IN), np.float32)] * 4)
    # data, tensor and sequence parallelism are ported: in one process "tp"
    # has nothing to split, and the model-parallel meshes need a process group
    for mode in ("tp", "fsdp+tp"):
        trainer = VoiceBoxTrainer(cfm, batch_size=2, dataset=ds, num_train_steps=1,
                                  valid_frac=0.0, device="cpu", param_sharding=mode)
        assert trainer.data_parallel is None
    with pytest.raises(RuntimeError, match="process group"):
        VoiceBoxTrainer(cfm, batch_size=2, dataset=ds, num_train_steps=1, valid_frac=0.0,
                        device="cpu", seq_parallel=2)
    with pytest.raises(ValueError, match="replicated"):
        VoiceBoxTrainer(cfm, batch_size=2, dataset=ds, num_train_steps=1, valid_frac=0.0,
                        device="cpu", seq_parallel=2, param_sharding="fsdp")
    with pytest.raises(RuntimeError, match="process group"):
        MeshConfig(model_parallel=2).build()
    with pytest.raises(TypeError, match="DeviceMesh"):
        VoiceBoxTrainer(cfm, batch_size=2, dataset=ds, num_train_steps=1, valid_frac=0.0,
                        device="cpu", mesh=object())
    with pytest.raises(ValueError, match="results_folder"):
        VoiceBoxTrainer(cfm, batch_size=2, dataset=ds, num_train_steps=1, valid_frac=0.0,
                        device="cpu", checkpoint_backend="orbax")
    bf16 = ConditionalFlowMatcherWrapper(
        VoiceBox(dim_in=DIM_IN, dtype=torch.bfloat16, **CONFIG), device="cpu")
    with pytest.raises(ValueError, match="fp32 parameters"):
        VoiceBoxTrainer(bf16, batch_size=2, dataset=ds, num_train_steps=1, valid_frac=0.0,
                        device="cpu")
    # attention dropout is ported: on in training only
    attn = Attention(32, dim_head=16, heads=2, attn_dropout=0.1)
    x = torch.randn(1, 4, 32, generator=torch.Generator().manual_seed(0))
    plain = attn(x)
    dropped = attn(x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(dropped).all() and not torch.equal(dropped, plain)


def test_param_dtype_keeps_fp32_weights_and_computes_in_bf16():
    vb = VoiceBox(dim_in=DIM_IN, dtype=torch.bfloat16, param_dtype=torch.float32, **CONFIG)
    assert {p.dtype for p in vb.parameters()} == {torch.float32}
    serving = VoiceBox(dim_in=DIM_IN, dtype=torch.bfloat16, **CONFIG)
    assert serving.to_embed.weight.dtype == torch.bfloat16  # the serving default
    x = torch.randn(2, 12, DIM_IN)
    out = vb(x, times=torch.rand(2), cond=x, cond_token_ids=torch.zeros(2, 12, dtype=torch.long))
    assert out.dtype == torch.bfloat16
