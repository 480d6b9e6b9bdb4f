"""The port's sequence parallelism (`voicebox_tpu_torch/ops/
ring_attention.py`, `voicebox_tpu_torch/parallel/sequence_parallel.py`,
`VoiceBoxTrainer(seq_parallel=)`) against the single process and the JAX
package, on the CPU.

Mirrors `tests/test_sequence_parallel.py` (ring attention with a replicated
prefix, the transformer with `scan_layers=False`, the halo exchange of
ConvPositionEmbed, the vector field, the loss and its gradients, data x
seq meshes, the trainer) and `tests/test_multiproc_sp.py` (a trainer whose
"seq" ranks are processes). One four-rank gloo run of this file as a
script (below `__main__`; torch and the port only, handed the inputs and
the JAX side's weights in an `.npz`; each rank writes its results):

* on ranks 0 and 1 (a 1 x 2 ("data", "seq") mesh): `ring_attention` and
  `ring_attention_prefixed`, unmasked, masked, ragged (a batch row whose
  keys on rank 1 are all padding) and empty (a row with no key outside
  the prefix), forward and backward, by the plain ring and by the card's
  route (`_RingAttention`, its kernels' plain versions on the CPU); the halo
  conv, the transformer (U-Net skips, registers, adaptive norm, a mask) and
  the VoiceBox field (ids stretched to the global length); the loss on
  explicit draws and its gradients; the span mask and CFG drop drawn from
  the generator at the full length; 3 `VoiceBoxTrainer(seq_parallel=2)`
  steps; GateLoop, attention dropout and a bucket that does not divide
  refused;
* on all four ranks (2 x 2): the loss and gradients over data x seq and 3
  trainer steps.

The JAX side: `ring_attention_prefixed` / `ring_attention` under
`shard_map` on the virtual CPU devices of conftest for the forward,
`reference_attention`'s vjp on the gathered sequence for the gradients,
and the single-device `loss_fn` (the done bar: atol 2e-4; per-leaf
gradient cosine > 0.999 at atol 2e-3).
"""

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(HERE))

from test_torch_parallel import (ACCUM, BATCH, LR, STEPS, TRAIN, VB, _by,  # noqa: E402
                                 _cosines_and_close, _state, _step_draws, _vb_items)

WORLD, SEQ = 4, 2
RING = dict(b=2, h=2, p=3, n=16, d=16)  # n frames a rank
RING_CASES = ("plain", "masked", "ragged", "empty")
# the plain ring (autograd through per-block plain attention), and the route
# the card takes (`_RingAttention`: delta once, K2 + K3 per block against the
# merged lse, the keys' gradients sent home), its kernels' plain versions here
RING_ROUTES = ("_plain_ring", "_kernel_ring")
TINY_T = dict(dim=48, depth=4, dim_head=12, heads=4, num_register_tokens=3,
              use_unet_skip_connection=True, adaptive_rmsnorm=True,
              adaptive_rmsnorm_cond_dim_in=24, attn_qk_norm=True)
N_LOCAL = 16  # frames a rank in the module tests (the conv's halo is 15)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_frames_are_drawn_at_full_length_and_cut():
    """`batch_frames` (with `batch_rows`): a rank's draw is its rows and
    frames of the draw one process makes, and draws without a frame axis
    are whole."""
    from voicebox_tpu_torch.ops.masks import batch_frames, batch_rows, normal, uniform

    whole = torch.Generator().manual_seed(3)
    full_noise, full_times = normal((4, 30, 5), whole), uniform((4,), whole)
    for data_rank in range(2):
        for seq_rank in range(2):
            g = torch.Generator().manual_seed(3)
            with batch_rows(2 * data_rank, 2, 4), batch_frames(15 * seq_rank, 15, 30):
                noise, times = normal((2, 15, 5), g), uniform((2,), g)
            rows, frames = slice(2 * data_rank, 2 * data_rank + 2), slice(15 * seq_rank,
                                                                            15 * seq_rank + 15)
            assert torch.equal(noise, full_noise[rows, frames])
            assert torch.equal(times, full_times[rows])


# ----------------------------------------------------------------------
# four ranks under gloo: this file run as a script (torch and the port only)


def _ring_inputs():
    rs = np.random.RandomState(11)
    b, h, p, n, d = (RING[k] for k in ("b", "h", "p", "n", "d"))
    total = p + SEQ * n
    out = {f"ring.{k}": rs.randn(b, h, total, d).astype(np.float32) for k in "qkv"}
    out["ring.do"] = rs.randn(b, h, total, d).astype(np.float32)  # the prefix's on rank 0
    masks = {"plain": np.ones((b, total), bool),
             "masked": rs.rand(b, total) < 0.7,
             "ragged": np.ones((b, total), bool)}
    masks["masked"][:, :p] = True
    masks["ragged"][1, p + n // 2:] = False  # row 1: rank 1's keys all padding
    masks["empty"] = masks["ragged"].copy()
    masks["empty"][1, p:] = False  # row 1: no key but the prefix's anywhere
    for case, m in masks.items():
        out[f"ring.mask.{case}"] = m
    return out


def _module_inputs():
    rs = np.random.RandomState(12)
    n = SEQ * N_LOCAL
    mask = rs.rand(2, n) < 0.85
    mask[:, :4] = True
    return {"mod.x": rs.randn(2, n, 48).astype(np.float32),
            "mod.cond": rs.randn(2, 24).astype(np.float32), "mod.mask": mask,
            "mod.g": rs.randn(2, n, 48).astype(np.float32)}


def _field_inputs():
    rs = np.random.RandomState(13)
    n, d = SEQ * N_LOCAL, VB["dim_in"]
    return {"field.x": rs.randn(2, n, d).astype(np.float32),
            "field.cond": rs.randn(2, n, d).astype(np.float32),
            "field.times": rs.rand(2).astype(np.float32),
            "field.cond_mask": rs.rand(2, n) < 0.5,
            "field.ids": rs.randint(0, VB["num_cond_tokens"], (2, 17)).astype(np.int64)}


def _worker(inp, out_dir, rank, world, init_file):
    """One rank; each rank writes r{rank}.npz, rank 0 also the single
    process's results."""
    import warnings

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from voicebox_tpu_torch import (ArrayDataset, ConditionalFlowMatcherWrapper, VoiceBox,
                                    VoiceBoxTrainer)
    from voicebox_tpu_torch.models.primitives import ConvPositionEmbed
    from voicebox_tpu_torch.models.transformer import Transformer
    from voicebox_tpu_torch.ops import ring_attention as ring_module
    from voicebox_tpu_torch.ops.ring_attention import ring_attention, ring_attention_prefixed
    from voicebox_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from voicebox_tpu_torch.parallel.sequence_parallel import (make_sp_loss_fn, seq_shard,
                                                               sp_forward)

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")  # the single-process references run beside the group
    assert maybe_initialize_distributed(f"file://{init_file}", world, rank, backend="gloo")
    data, res = dict(np.load(inp)), {}
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    names = ("data", "seq")
    pair = DeviceMesh("cpu", torch.tensor([[0, 1]]), mesh_dim_names=names)  # every rank builds
    square = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=names)
    state = _state(data, "vb.")

    def vb_model(cfg=VB):
        vb = VoiceBox(**cfg)
        vb.load_state_dict(state, strict=True)
        return vb

    def vb_trainer(single=False, items=None, **kw):
        cfm = ConditionalFlowMatcherWrapper(vb_model(), cond_drop_prob=0.2, device="cpu")
        return VoiceBoxTrainer(cfm, dataset=ArrayDataset(items or _vb_items()),
                               use_mesh=not single, **{**TRAIN, **kw})

    def run(trainer, tag):
        grads, dp, batches = [], trainer.data_parallel, []
        it = trainer.dl_iter
        trainer.dl_iter = (batches.append(b) or b for b in it)
        if dp is None:
            apply = trainer._apply_gradients

            def applied(loss, g):
                grads.append([x.clone() for x in g])
                return apply(loss, g)

            trainer._apply_gradients = applied
        else:
            reduce = dp.reduce

            def reduced(g, scalars):
                got = reduce(g, scalars)
                grads.append([x.clone() for x in got[0]])
                return got

            dp.reduce = reduced
        draws = {k: torch.from_numpy(v) for k, v in _step_draws().items()}
        logs = [trainer.train_step(**(draws if s == 0 else {})) for s in range(STEPS)]
        if rank == 0:
            res[f"{tag}.loss"] = np.array([float(g["loss"]) for g in logs])
            res[f"{tag}.norm"] = np.array([float(g["grad_norm"]) for g in logs])
            res[f"{tag}.valid"] = np.array([r["valid_loss"] for r in trainer.metrics
                                            if "valid_loss" in r])
            for (n, p), g in zip(trainer.named_params, grads[0]):
                res[f"{tag}.grad.{n}"] = g.numpy()
                res[f"{tag}.param.{n}"] = p.detach().numpy().copy()
            if dp is None:
                (bx, bmask), (bids, _) = batches[0]
                res.update({f"{tag}.batch.x": bx, f"{tag}.batch.mask": bmask,
                            f"{tag}.batch.ids": bids})

    if rank < SEQ:
        group = pair.get_group("seq")
        p, n = RING["p"], RING["n"]
        frames = slice(p + rank * n, p + (rank + 1) * n)
        for route in RING_ROUTES:  # the plain ring, then the kernels' route on the CPU
            ring_module._ROUTES["cpu"] = getattr(ring_module, route)
            for case in RING_CASES:
                qkv = [torch.cat([t[f"ring.{k}"][:, :, :p], t[f"ring.{k}"][:, :, frames]],
                                 dim=2).requires_grad_() for k in "qkv"]
                full_mask = t[f"ring.mask.{case}"]
                mask = torch.cat([full_mask[:, :p], full_mask[:, frames]], dim=1)
                out_p, out_l = ring_attention_prefixed(*qkv, p, mask, None, group)
                do_p = t["ring.do"][:, :, :p] * (1.0 if rank == 0 else 0.0)
                ((out_p * do_p).sum() + (out_l * t["ring.do"][:, :, frames]).sum()).backward()
                res[f"ring.{route}.{case}.out_p"], res[f"ring.{route}.{case}.out_l"] = (
                    out_p.detach().numpy(), out_l.detach().numpy())
                for k, x in zip("qkv", qkv):
                    res[f"ring.{route}.{case}.d{k}"] = x.grad.numpy()
                # without a prefix: the rank's rows only
                qkv = [t[f"ring.{k}"][:, :, frames].clone().requires_grad_() for k in "qkv"]
                out = ring_attention(*qkv, full_mask[:, frames], None, group)
                (out * t["ring.do"][:, :, frames]).sum().backward()
                res[f"ring0.{route}.{case}.out"] = out.detach().numpy()
                for k, x in zip("qkv", qkv):
                    res[f"ring0.{route}.{case}.d{k}"] = x.grad.numpy()
        ring_module._ROUTES["cpu"] = ring_module._plain_ring

        # the halo conv and the transformer, forward and backward
        fr = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
        torch.manual_seed(2)
        conv, tr = ConvPositionEmbed(48), Transformer(**TINY_T)
        with torch.no_grad():  # qk gains of 0.5, as the parity tests run them
            for name, q in tr.named_parameters():
                if name.endswith(("q_norm.gamma", "k_norm.gamma")):
                    q.fill_(0.5)
        for tag, module, call in (
                ("conv", conv, lambda m, x, msk: m(x, mask=msk)),
                ("transformer", tr, lambda m, x, msk: m(x, mask=msk,
                                                        adaptive_rmsnorm_cond=t["mod.cond"]))):
            x = t["mod.x"][:, fr].clone().requires_grad_()
            module.zero_grad()
            with seq_shard(group):
                y = call(module, x, t["mod.mask"][:, fr])
            (y * t["mod.g"][:, fr]).sum().backward()
            res[f"{tag}.out"], res[f"{tag}.dx"] = y.detach().numpy(), x.grad.numpy()
            for name, q in module.named_parameters():
                res[f"{tag}.dparam.{name}"] = q.grad.numpy()
            if rank == 0:
                x = t["mod.x"].clone().requires_grad_()
                module.zero_grad()
                y = call(module, x, t["mod.mask"])
                (y * t["mod.g"]).sum().backward()
                res[f"{tag}.single.out"], res[f"{tag}.single.dx"] = (y.detach().numpy(),
                                                                      x.grad.numpy())
                for name, q in module.named_parameters():
                    res[f"{tag}.single.dparam.{name}"] = q.grad.numpy()

        # the vector field: the rank's frames, the ids whole
        vb = vb_model().eval()
        field = sp_forward(vb, group)
        with torch.no_grad():
            res["field.out"] = field(t["field.x"][:, fr], t["field.times"],
                                     t["field.cond"][:, fr], t["field.cond_mask"][:, fr],
                                     cond_token_ids=t["field.ids"]).numpy()

        # the loss on explicit draws and its gradient (this rank's share)
        cfm = ConditionalFlowMatcherWrapper(vb_model(), cond_drop_prob=0.25, device="cpu")
        loss_fn = make_sp_loss_fn(cfm, group)
        d = _step_draws()
        rows = slice(0, BATCH)
        x1 = torch.from_numpy(np.asarray(data["batch.x"][rows]))
        n_frames = x1.shape[1] // SEQ
        lf = slice(rank * n_frames, (rank + 1) * n_frames)
        loss = loss_fn(x1[:, lf], mask=t["batch.mask"][rows, lf],
                       cond_token_ids=t["batch.ids"][rows],
                       noise=torch.from_numpy(d["noise"][rows, lf]),
                       times=torch.from_numpy(d["times"][rows]),
                       cond_mask=torch.from_numpy(d["cond_mask"][rows, lf]),
                       cond_drop_mask=torch.from_numpy(d["cond_drop_mask"][rows]))
        loss.backward()
        res["loss.value"] = np.array(float(loss))
        for name, q in cfm.voicebox.named_parameters():
            res[f"loss.grad.{name}"] = q.grad.numpy()
        # the span mask and the CFG drop from the generator, at full length
        gen = torch.Generator().manual_seed(21)
        res["drawn.loss"] = np.array(float(loss_fn(
            x1[:, lf], mask=t["batch.mask"][rows, lf], cond_token_ids=t["batch.ids"][rows],
            generator=gen)))
        if rank == 0:
            single = ConditionalFlowMatcherWrapper(vb_model(), cond_drop_prob=0.25,
                                                   device="cpu")
            res["drawn.single"] = np.array(float(single.loss_fn(
                x1, mask=t["batch.mask"][rows], cond_token_ids=t["batch.ids"][rows],
                generator=torch.Generator().manual_seed(21))))

        # what sequence parallelism refuses
        refused = []
        gl = Transformer(dim=16, depth=2, dim_head=8, heads=2, use_gateloop_layers=True)
        drop = vb_model(dict(VB, attn_dropout=0.1))
        for call in (lambda: gl(torch.zeros(1, 8, 16)),
                     lambda: drop(t["field.x"][:, fr], times=t["field.times"],
                                  cond=t["field.cond"][:, fr], cond_token_ids=t["field.ids"],
                                  train=True, generator=torch.Generator().manual_seed(0))):
            try:
                with seq_shard(group):
                    call()
                refused.append("")
            except ValueError as e:
                refused.append(str(e))
        rs = np.random.RandomState(9)  # 21 frames + 2 registers bucket to 27: 25 frames
        items = [(rs.randn(21, VB["dim_in"]).astype(np.float32),
                  rs.randint(0, 50, 21).astype(np.int32)) for _ in range(16)]
        odd = vb_trainer(mesh=pair, items=items, bucket_multiple=9)
        try:
            odd.train_step()
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
        res["refused"] = np.array(refused)
        del odd

        # three trainer steps at seq 2
        trainer = vb_trainer(mesh=pair)
        if rank == 0:
            res["sp.mesh"] = np.array([trainer.data_parallel.world, trainer.seq_parallel])
        run(trainer, "sp")
        del trainer

    # data x seq on all four ranks: the loss, its gradient, three steps
    run(vb_trainer(mesh=square), "dpsp")
    if rank == 0:
        run(vb_trainer(single=True), "single")
    dist.barrier()
    np.savez(f"{out_dir}/r{rank}.npz", **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs and the JAX side's weights to four ranks in an .npz, the
    ranks run under gloo with a clock of their own (150 s), every rank's
    results back."""
    import jax

    from test_torch_transformer import _xla_inv_freq
    from test_torch_voicebox import _models
    from voicebox_tpu_torch import ArrayDataset
    from voicebox_tpu_torch.training.data import AlignedPairedDataLoader
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    jvb, _, params, _ = _models()
    tmp = tmp_path_factory.mktemp("sp")
    arrays = {f"vb.{k}": v.numpy() for k, v in _xla_inv_freq(
        voicebox_state_dict(jax.tree.map(np.asarray, params)), "transformer.").items()}
    arrays.update(_ring_inputs())
    arrays.update(_module_inputs())
    arrays.update(_field_inputs())
    # the trainer's first global batch, as the single-process loader yields it
    loader = AlignedPairedDataLoader(ArrayDataset(_vb_items()), BATCH * ACCUM, seed=0,
                                     bucket_multiple=16, bucket_offset=VB["num_register_tokens"],
                                     align_multiple=128)
    (x, mask), (ids, _) = next(iter(loader))
    arrays.update({"batch.x": x, "batch.mask": mask, "batch.ids": ids.astype(np.int64)})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp / "in.npz"), str(tmp), str(r),
                               str(WORLD), str(tmp / "init")], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + 150
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                .decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
    ranks = [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)]
    return ranks, arrays, (jvb, params)


def _frames_of(ranks, key, axis):
    return np.concatenate([ranks[r][key] for r in range(SEQ)], axis=axis)


@functools.cache
def _jax_ring(case: str, prefixed: bool):
    """JAX's ring on the virtual devices, once per case for both routes:
    the forward under shard_map (with the prefix: (prefix rows, local rows))
    and `reference_attention`'s vjp on the gathered sequence (dq, dk, dv)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from voicebox_tpu.ops.flash_attention import reference_attention
    from voicebox_tpu.ops.ring_attention import ring_attention, ring_attention_prefixed

    inp, p = _ring_inputs(), RING["p"]
    rows = slice(None) if prefixed else slice(p, None)
    q, k, v, do = (inp[f"ring.{x}"][:, :, rows] for x in ("q", "k", "v", "do"))
    mask = inp[f"ring.mask.{case}"][:, rows]
    mesh = Mesh(np.array(jax.devices()[:SEQ]), ("seq",))
    spec, rep = P(None, None, "seq", None), P()
    if prefixed:
        def f(pq, pk, pv, ql, kl, vl, ml, pm):
            cat = lambda a, b_: jnp.concatenate([a, b_], axis=2)  # noqa: E731
            return ring_attention_prefixed(cat(pq, ql), cat(pk, kl), cat(pv, vl),
                                           num_prefix=p, mask=jnp.concatenate([pm, ml], axis=1),
                                           axis_name="seq")

        sharded = jax.shard_map(f, mesh=mesh, in_specs=(rep,) * 3 + (spec,) * 3
                                + (P(None, "seq"), rep), out_specs=(rep, spec))
        out = sharded(q[:, :, :p], k[:, :, :p], v[:, :, :p], q[:, :, p:], k[:, :, p:],
                      v[:, :, p:], mask[:, p:], mask[:, :p])
    else:
        out = (jax.shard_map(lambda a, b_, c, m: ring_attention(a, b_, c, mask=m,
                                                                axis_name="seq"),
                             mesh=mesh, in_specs=(spec,) * 3 + (P(None, "seq"),),
                             out_specs=spec)(q, k, v, mask),)
    _, vjp = jax.vjp(lambda a, b_, c: reference_attention(a, b_, c, mask=jnp.asarray(mask)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("route", RING_ROUTES)
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_attention_prefixed_matches_jax(spawned, case, route):
    """The ring with the registers as a replicated prefix against JAX's
    `ring_attention_prefixed` under shard_map (forward; the prefix rows
    averaged over "seq") and `reference_attention`'s vjp on the gathered
    sequence (the prefix's gradient summed over the ranks, each rank's
    rows' whole); "ragged": row 1's keys on rank 1 are all padding,
    "empty": row 1 has no key but the prefix's. Each route: the plain ring,
    and the card's (`_RingAttention`) with its kernels' plain versions."""
    ranks, _, _ = spawned
    p = RING["p"]
    (jp, jl), grads = _jax_ring(case, prefixed=True)
    for r in range(SEQ):
        np.testing.assert_allclose(ranks[r][f"ring.{route}.{case}.out_p"], jp, atol=2e-5,
                                   rtol=0)
    np.testing.assert_allclose(_frames_of(ranks, f"ring.{route}.{case}.out_l", 2), jl,
                               atol=2e-5, rtol=0)
    for name, g in zip("qkv", grads):
        prefix = sum(ranks[r][f"ring.{route}.{case}.d{name}"][:, :, :p] for r in range(SEQ))
        local = np.concatenate([ranks[r][f"ring.{route}.{case}.d{name}"][:, :, p:]
                                for r in range(SEQ)], axis=2)
        np.testing.assert_allclose(prefix, g[:, :, :p], atol=2e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(local, g[:, :, p:], atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("route", RING_ROUTES)
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_attention_matches_jax(spawned, case, route):
    """Without a prefix: JAX's `ring_attention` under shard_map (forward) and
    the reference vjp on the gathered sequence (gradients), by both routes;
    "empty": row 1 has no key on any rank (its output the mean of the
    values, its keys' gradient shared evenly)."""
    ranks, _, _ = spawned
    (jout,), grads = _jax_ring(case, prefixed=False)
    np.testing.assert_allclose(_frames_of(ranks, f"ring0.{route}.{case}.out", 2), jout,
                               atol=2e-5, rtol=0)
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(_frames_of(ranks, f"ring0.{route}.{case}.d{name}", 2), g,
                                   atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("tag", ["conv", "transformer"])
def test_halo_conv_and_transformer_match_the_single_process(spawned, tag):
    """ConvPositionEmbed (kernel 31: a halo of 15 frames, the whole of a
    16-frame shard but one) and the transformer (U-Net skips, 3 registers,
    adaptive norm, a key mask, rotary offsets) on two ranks' frames: outputs,
    the input's gradient (the halo's sent back) and the parameters'
    gradients summed over the ranks, against one process."""
    ranks, _, _ = spawned
    single = ranks[0]
    # the ring merges the blocks in another order: the forward's done bar
    atol = 1e-5 if tag == "conv" else 2e-4
    np.testing.assert_allclose(_frames_of(ranks, f"{tag}.out", 1), single[f"{tag}.single.out"],
                               atol=atol, rtol=0)
    np.testing.assert_allclose(_frames_of(ranks, f"{tag}.dx", 1), single[f"{tag}.single.dx"],
                               atol=atol, rtol=0)
    summed = {k: sum(ranks[r][f"{tag}.dparam.{k}"] for r in range(SEQ))
              for k in _by(single, f"{tag}.single.dparam.")}
    _cosines_and_close(summed, _by(single, f"{tag}.single.dparam."), 0.9999, 2e-3)


def test_vector_field_matches_jax(spawned):
    """The VoiceBox field on two ranks' frames (the 17 ids stretched to the
    global 32 frames and sliced) against JAX's single-device field."""
    import jax.numpy as jnp

    ranks, inp, (jvb, params) = spawned
    ref = jvb.apply({"params": params}, jnp.asarray(inp["field.x"]),
                    times=jnp.asarray(inp["field.times"]), cond=jnp.asarray(inp["field.cond"]),
                    cond_mask=jnp.asarray(inp["field.cond_mask"]),
                    cond_token_ids=jnp.asarray(inp["field.ids"], jnp.int32), cond_drop_prob=0.0)
    np.testing.assert_allclose(_frames_of(ranks, "field.out", 1), np.asarray(ref), atol=2e-4,
                               rtol=0)


def _jax_loss_and_grads(jvb, params, inp, rows):
    import jax
    import jax.numpy as jnp

    from voicebox_tpu.ops.ode import cfm_interpolant

    d = _step_draws()

    def loss(p):
        w, flow = cfm_interpolant(jnp.asarray(inp["batch.x"][rows]), jnp.asarray(d["noise"][rows]),
                                  jnp.asarray(d["times"][rows]), 0.0)
        return jvb.apply({"params": p}, w, times=jnp.asarray(d["times"][rows]),
                         cond_token_ids=jnp.asarray(inp["batch.ids"][rows], jnp.int32),
                         self_attn_mask=jnp.asarray(inp["batch.mask"][rows]),
                         cond_drop_mask=jnp.asarray(d["cond_drop_mask"][rows]), target=flow,
                         cond_mask=jnp.asarray(d["cond_mask"][rows]), train=True)

    return jax.jit(jax.value_and_grad(loss))(params)


def test_loss_and_gradients_match_jax(spawned):
    """The CFM loss on two ranks' frames with every draw explicit: every
    rank returns the whole sequence's loss, and the gradients summed over
    the ranks are the single-device gradients of JAX's loss (the done bar)."""
    from test_torch_train import _assert_leaves_close
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    ranks, inp, (jvb, params) = spawned
    value, grads = _jax_loss_and_grads(jvb, params, inp, slice(0, BATCH))
    for r in range(SEQ):
        np.testing.assert_allclose(ranks[r]["loss.value"], float(value), atol=2e-4, rtol=0)
    ref = voicebox_state_dict(grads)
    summed = {k: sum(ranks[r][f"loss.grad.{k}"] for r in range(SEQ))
              for k in _by(ranks[0], "loss.grad.")}
    summed = {k: v for k, v in summed.items() if k in ref}
    _assert_leaves_close(summed, {k: np.asarray(v) for k, v in ref.items()})


def test_span_mask_and_cfg_drop_are_drawn_at_full_length(spawned):
    """From the generator: each rank draws the noise at the global length
    and keeps its frames, and the span mask and CFG drop whole; the loss
    equals the single process's on the same seed."""
    ranks, _, _ = spawned
    for r in range(SEQ):
        np.testing.assert_allclose(ranks[r]["drawn.loss"], ranks[0]["drawn.single"], atol=1e-6,
                                   rtol=0)


def test_sequence_parallelism_refuses_gateloop_dropout_and_uneven_buckets(spawned):
    ranks, _, _ = spawned
    gateloop, dropout, bucket = ranks[0]["refused"].tolist()
    assert "GateLoop" in gateloop and "dropout" in dropout
    assert "does not divide by seq_parallel=2" in bucket


@pytest.mark.parametrize("tag", ["sp", "dpsp"])
def test_trainer_steps_match_the_single_process(spawned, tag):
    """`VoiceBoxTrainer` on a 1 x 2 and a 2 x 2 ("data", "seq") mesh: three
    steps (grad_accum_every=2, the first on explicit draws, then the
    generator's) against the single-process trainer on the same global
    batches: losses, the clip's norm, the validation loss, the first step's
    reduced gradients and the parameters after three steps (the
    `test_multiproc_sp.py` check with processes for the ranks)."""
    ranks, _, _ = spawned
    res = ranks[0]
    if tag == "sp":
        assert res["sp.mesh"].tolist() == [1, 2]
    # the numerator summed over "seq", the rows' losses over "data", in
    # another order than one process's: a few fp32 ulps of the loss
    np.testing.assert_allclose(res[f"{tag}.loss"], res["single.loss"], atol=2e-6, rtol=0)
    np.testing.assert_allclose(res[f"{tag}.valid"], res["single.valid"], atol=2e-6, rtol=0)
    # the clip's norm at the first step, as in tests/test_torch_tensor_parallel.py:
    # Adam then moves each weight whose gradient is near zero by ~lr at the
    # sign of its rounding, which moves later norms by ~1e-5
    np.testing.assert_allclose(res[f"{tag}.norm"][0], res["single.norm"][0], rtol=1e-5)
    _cosines_and_close(_by(res, f"{tag}.grad."), _by(res, "single.grad."), 0.9999, 1e-5)
    _cosines_and_close(_by(res, f"{tag}.param."), _by(res, "single.param."), 0.9999, 0.25 * LR)


def test_data_by_seq_step_matches_jax_loss_fn(spawned):
    """The first step's loss on the 2 x 2 mesh against JAX's single-device
    loss on the same global batch and draws (the two micro-batches)."""
    from test_torch_train import _assert_leaves_close
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    import jax

    ranks, _, (jvb, params) = spawned
    batch = {k[len("single."):]: v for k, v in ranks[0].items() if k.startswith("single.batch.")}
    total, grads = 0.0, None
    for i in range(ACCUM):
        value, g = _jax_loss_and_grads(jvb, params, batch, slice(i * BATCH, (i + 1) * BATCH))
        total += float(value) / ACCUM
        grads = g if grads is None else jax.tree.map(lambda a, b_: a + b_, grads, g)
    ref = voicebox_state_dict(jax.tree.map(lambda a: np.asarray(a) / ACCUM, grads))
    np.testing.assert_allclose(ranks[0]["dpsp.loss"][0], total, atol=2e-4, rtol=0)
    _assert_leaves_close(_by(ranks[0], "dpsp.grad."), {k: v.numpy() for k, v in ref.items()})


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
