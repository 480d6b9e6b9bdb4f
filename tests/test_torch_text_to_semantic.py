"""The port's TextToSemantic against the JAX package's, on the CPU in float32,
at tiny widths (dim 64, 2 + 2 layers, 2 x 32 heads, 30 semantic ids), the
weights carried by `utils/convert.py::text_to_semantic_state_dict` with
noise on every leaf and XLA's rotary table injected. The eos column of the
head is doubled so that rows end at different lengths.

* teacher-forced logits and the loss at atol 2e-4, gradients per parameter
  at cosine > 0.999 and atol 2e-3;
* greedy tokens and masks equal over the whole buffer: plain, speculative
  (gamma 1, 3, 5, drafts of 1 and 2 layers), w8a16 (the plain version of
  K4 on the CPU) and int8, each also speculative, and bf16 storage;
* sampled routes, which `torch.Generator` and `jax.random` never draw
  alike: a tiny temperature gives greedy; the first token's histogram
  matches softmax(logits / T) by chi-square, plain and speculative; the
  rejection step matches numpy under injected uniforms;
* bos is never emitted, the quantized copy's scope, save / load.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from test_torch_train import _assert_leaves_close
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu.models.text_to_semantic import TextToSemantic as JaxT2S
from voicebox_tpu_torch.models.text_to_semantic import TextToSemantic, speculative_rejection
from voicebox_tpu_torch.ops.quant import QuantLinear, seq2seq_quantized_layer_names
from voicebox_tpu_torch.utils.convert import text_to_semantic_state_dict

ATOL = 2e-4
CFG = dict(dim=64, num_text_token_ids=47, num_semantic_token_ids=30, source_depth=2,
           target_depth=2, heads=2, dim_head=32)
EOS = 31
MAX_LEN = 24


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
    jt = JaxT2S(**CFG)
    jt.init_params(jax.random.PRNGKey(0), n_text=8, n_sem=8, batch=2)
    params = _perturbed(jt.params, np.random.RandomState(1))
    params["to_logits"]["kernel"][:, EOS] *= 2.0  # rows end at different lengths
    jt.params = jax.tree.map(jnp.asarray, params)
    return jt, params


def port_state(params):
    sd = text_to_semantic_state_dict(params, dim_head=CFG["dim_head"])
    return _xla_inv_freq(_xla_inv_freq(sd, "net.encoder."), "net.")


def _port():
    _, params = _models()
    t2s = TextToSemantic(**CFG, device="cpu")
    t2s.load_state_dict(port_state(params), strict=True)
    return t2s


def _text(seed=2, b=4, n=9):
    rs = np.random.RandomState(seed)
    txt = rs.randint(0, CFG["num_text_token_ids"], (b, n)).astype(np.int32)
    if b > 2:
        txt[1, 6:] = -1
        txt[b - 1, 2:] = -1
    return txt


def _sem(seed=3, b=4, n=7):
    rs = np.random.RandomState(seed)
    sem = rs.randint(0, CFG["num_semantic_token_ids"], (b, n)).astype(np.int32)
    sem[0, 5:] = -1
    sem[2, 1:] = -1
    return sem


def _l(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_teacher_forced_logits_and_loss_match_jax():
    jt, params = _models()
    t2s = _port()
    txt, sem = _text(), _sem()
    ref = np.asarray(jax.jit(jt.net.apply)({"params": jt.params}, jnp.asarray(txt),
                                           jnp.asarray(sem)))
    with torch.no_grad():
        ours = t2s.net(_l(txt), _l(sem)).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    ref_loss = float(jax.jit(jt.loss_fn)(jt.params, jnp.asarray(txt), jnp.asarray(sem)))
    with torch.no_grad():
        loss = float(t2s.loss_fn(_l(txt), _l(sem)))
    np.testing.assert_allclose(loss, ref_loss, atol=ATOL, rtol=0)


def test_loss_gradients_match_jax():
    jt, params = _models()
    t2s = _port()
    txt, sem = _text(), _sem()
    grads = jax.jit(jax.grad(jt.loss_fn))(jt.params, jnp.asarray(txt), jnp.asarray(sem))
    ref = {k: v.numpy() for k, v in text_to_semantic_state_dict(
        jax.tree.map(np.asarray, grads), dim_head=CFG["dim_head"]).items()}
    t2s.loss_fn(_l(txt), _l(sem)).backward()
    ours = {k: p.grad.numpy() for k, p in t2s.named_parameters()}
    assert set(ours) == set(ref) - {"net.rotary_emb.inv_freq", "net.encoder.rotary_emb.inv_freq"}
    _assert_leaves_close(ours, ref)


def test_loss_invariant_to_pad_width():
    t2s = _port()
    txt = _l([[3, 4, 5, -1]])
    sem = _l([[1, 2, 3]])
    wide = torch.cat([sem, torch.full((1, 4), -1)], dim=1)
    with torch.no_grad():
        np.testing.assert_allclose(float(t2s.loss_fn(txt, sem)), float(t2s.loss_fn(txt, wide)),
                                   rtol=1e-6)


# the JAX package compiles one program per route: routes marked "jax" are
# held against it; the others against the port's own route of the same
# weights without speculation (equal to the JAX package's, held above, which
# the JAX package holds equal to its speculative route)
GREEDY_ROUTES = {
    "plain": ({}, "jax"),
    "spec5": ({"spec_decode": True}, "jax"),
    "spec1": ({"spec_decode": True, "spec_decode_gamma": 1}, "plain"),
    "spec3_draft2": ({"spec_decode": True, "spec_decode_gamma": 3,
                      "spec_decode_draft_layers": 2}, "plain"),
    "w8a16": ({"quantize": "w8a16"}, "jax"),
    "w8a16_spec3": ({"quantize": "w8a16", "spec_decode": True, "spec_decode_gamma": 3},
                    "quantized"),
    "int8": ({"quantize": "int8"}, "jax"),
    "int8_spec5": ({"quantize": "int8", "spec_decode": True}, "quantized"),
}


@pytest.mark.parametrize("route", list(GREEDY_ROUTES))
def test_greedy_tokens_and_masks_match_jax(route):
    kw, against = GREEDY_ROUTES[route]
    t2s = _port()
    txt = _text()
    if against == "jax":
        jt, _ = _models()
        ref = jt.generate(jnp.asarray(txt), max_length=MAX_LEN, return_target_mask=True, **kw)
    else:
        plain_kw = {"quantize": kw["quantize"]} if against == "quantized" else {}
        ref = t2s.generate(_l(txt), max_length=MAX_LEN, return_target_mask=True, **plain_kw)
    tok, mask = t2s.generate(_l(txt), max_length=MAX_LEN, return_target_mask=True, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[1]))
    lengths = mask.sum(dim=1).tolist()
    assert 0 < min(lengths) < MAX_LEN == max(lengths), lengths  # eos inside and not


def test_speculative_equals_plain_greedy_exactly():
    t2s = _port()
    txt = _l(_text(seed=7, b=3))
    plain = t2s.generate(txt, max_length=MAX_LEN, return_target_mask=True)
    for gamma in (1, 2, 5):
        spec = t2s.generate(txt, max_length=MAX_LEN, return_target_mask=True,
                            spec_decode=True, spec_decode_gamma=gamma)
        for a, b in zip(plain, spec):
            assert torch.equal(a, b)
    stats = t2s.decode_stats
    assert stats["rounds"] >= 1 and 0 <= stats["accepted"] <= stats["rounds"] * 5
    assert stats["positions"] == MAX_LEN  # one row runs to the end


def test_param_store_dtype_matches_jax():
    jt, _ = _models()
    t2s = _port()
    txt = _text()
    ref_tok, ref_mask = jt.generate(jnp.asarray(txt), max_length=MAX_LEN,
                                    return_target_mask=True, param_store_dtype=jnp.bfloat16)
    tok, mask = t2s.generate(_l(txt), max_length=MAX_LEN, return_target_mask=True,
                             param_store_dtype=torch.bfloat16)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    copy = t2s._serving_copy
    t2s.generate(_l(txt), max_length=4, param_store_dtype=torch.bfloat16)
    assert t2s._serving_copy is copy  # cached per weights version
    with torch.no_grad():
        t2s.net.final_norm.gamma.add_(0.0)  # an in-place update makes a new copy
    t2s.generate(_l(txt), max_length=4, param_store_dtype=torch.bfloat16)
    assert t2s._serving_copy is not copy


def test_quantized_copy_scope():
    t2s = _port()
    names = seq2seq_quantized_layer_names(t2s.net)
    assert len(names) == 7 * CFG["target_depth"] + 1 and names[-1] == "to_logits"
    assert all(n.startswith("dec_") for n in names[:-1])
    q = t2s._serving_net("w8a16", None)
    for name in names:
        assert isinstance(q.get_submodule(name), QuantLinear), name
    assert not any(isinstance(m, QuantLinear) for m in q.encoder.modules())
    assert q.text_embed.weight is t2s.net.text_embed.weight  # shared, not copied
    assert all(b.ff.act.row_pitch == 16 for b in q.blocks)
    assert not any(isinstance(m, QuantLinear) for m in t2s.net.modules())


def test_tiny_temperature_gives_greedy():
    t2s = _port()
    txt = _l(_text())
    greedy = t2s.generate(txt, max_length=MAX_LEN)
    gen = torch.Generator().manual_seed(0)
    for kw in ({}, {"spec_decode": True, "spec_decode_gamma": 3}):
        out = t2s.generate(txt, max_length=MAX_LEN, temperature=1e-4, generator=gen, **kw)
        assert torch.equal(out, greedy), kw


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_first_token_distribution_matches_softmax(spec):
    """The first token's histogram over 4000 rows against softmax(logits /
    T) of the full model at bos (chi-square, p > 1e-3; bins of expected
    count < 5 merged)."""
    t2s = _port()
    temperature, rows = 1.5, 4000
    txt = _l(_text(seed=4, b=1)).expand(rows, -1)
    gen = torch.Generator().manual_seed(11)
    tok, mask = t2s.generate(txt, max_length=1, temperature=temperature, generator=gen,
                             return_target_mask=True, spec_decode=spec, spec_decode_gamma=2)
    first = torch.where(mask[:, 0], tok[:, 0], EOS).numpy()
    with torch.no_grad():
        logits = t2s.net(txt[:1], torch.zeros((1, 0), dtype=torch.long))[0, 0]
    logits[CFG["num_semantic_token_ids"]] = -1e9  # bos, as every decode sets it
    p = torch.softmax(logits / temperature, dim=-1).double().numpy()
    expected = p * rows
    observed = np.bincount(first, minlength=p.shape[0]).astype(np.float64)
    big = expected >= 5
    obs = np.append(observed[big], observed[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    stat = float(((obs - exp) ** 2 / np.maximum(exp, 1e-12)).sum())
    assert stat < scipy.stats.chi2.ppf(0.999, len(obs) - 1), (stat, len(obs))


def _np_rejection(logps, logqs, proposals, u_accept, u_res):
    b, gamma = proposals.shape
    k_b = np.zeros(b, np.int64)
    for r in range(b):
        for i in range(gamma):
            d = proposals[r, i]
            if np.log(max(u_accept[r, i], 1e-20)) < logps[r, i, d] - logqs[r, i, d]:
                k_b[r] += 1
            else:
                break
    k = int(k_b.min())
    toks = np.zeros(b, np.int64)
    for r in range(b):
        if k_b[r] > k:
            toks[r] = proposals[r, k]
            continue
        p = np.exp(logps[r, k])
        res = np.maximum(p - np.exp(logqs[r, min(k, gamma - 1)]), 0.0)
        if k == gamma or res.sum() < 1e-9:
            res = p
        cdf = np.cumsum(res)
        toks[r] = min(int((cdf < u_res[r] * cdf[-1]).sum()), len(res) - 1)
    return k, k_b, toks


@pytest.mark.parametrize("case", range(4))
def test_rejection_step_matches_numpy(case):
    rs = np.random.RandomState(20 + case)
    b, gamma, v = 6, 4, 9
    sharp = 3.0 if case % 2 else 0.5  # p and q close (long prefixes) or far apart
    base = rs.randn(b, gamma + 1, v)
    logps = torch.log_softmax(torch.tensor(base * sharp), -1).float()
    logqs = torch.log_softmax(torch.tensor((base[:, :gamma] + 0.3 * rs.randn(b, gamma, v))
                                           * sharp), -1).float()
    proposals = torch.stack([torch.multinomial(logqs[:, i].exp(), 1,
                                               generator=torch.Generator().manual_seed(case))[:, 0]
                             for i in range(gamma)], dim=1)
    u_accept = torch.tensor(rs.rand(b, gamma), dtype=torch.float32)
    u_res = torch.tensor(rs.rand(b), dtype=torch.float32)
    if case == 3:
        u_accept[:] = 0.0  # every draft accepted: the bonus token from p at slot gamma
    k, k_b, toks = speculative_rejection(logps, logqs, proposals, u_accept, u_res)
    rk, rk_b, rtoks = _np_rejection(logps.double().numpy(), logqs.double().numpy(),
                                    proposals.numpy(), u_accept.numpy(), u_res.numpy())
    assert int(k) == rk and k_b.tolist() == rk_b.tolist() and toks.tolist() == rtoks.tolist()
    if case == 3:
        assert int(k) == gamma


def test_generate_never_emits_bos_and_stays_in_vocab():
    t2s = _port()
    gen = torch.Generator().manual_seed(3)
    for kw in ({}, {"spec_decode": True}):
        ids, mask = t2s.generate(["hello", "a second text"], max_length=16, temperature=1.0,
                                 return_target_mask=True, generator=gen, **kw)
        assert (ids != CFG["num_semantic_token_ids"]).all()
        assert (ids[mask] < CFG["num_semantic_token_ids"]).all()
        assert (ids[~mask] == 0).all()


def test_save_load_round_trip(tmp_path):
    t2s = _port()
    path = tmp_path / "t2s.pt"
    t2s.save(path)
    other = TextToSemantic(**CFG, device="cpu")
    other.load(path)
    for (k, a), (_, b) in zip(t2s.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k
    txt = _l(_text())
    assert torch.equal(other.generate(txt, max_length=8), t2s.generate(txt, max_length=8))


def test_rejects_other_directions_and_modes():
    t2s = _port()
    with pytest.raises(ValueError):
        t2s.generate(["x"], source_type="speech", max_length=2)
    with pytest.raises(ValueError):
        t2s.generate(["x"], max_length=2, quantize="int4")
