"""The port's tensor parallelism (`voicebox_tpu_torch/parallel/
tensor_parallel.py`, `param_sharding="tp"` and `"fsdp+tp"`) against the
single process and the JAX package, on the CPU.

Mirrors `tests/test_sharding.py`: the rules' layouts (`TestRules`, the
feed-forward whose inner width does not divide), training under "tp" and
"fsdp+tp" (`TestShardedTraining`), sampling with CFG from split weights
(`TestShardedInference`) and the row-parallel partial sums' all-reduce
(`test_tp_partial_sums_all_reduce`). One four-rank gloo run of this file as
a script (below `__main__`; torch and the port only, handed the JAX side's
weights in an `.npz`):

* "tp" at model 2 on ranks 0 and 1 (a 1 x 2 mesh), the tiny VoiceBox of
  `tests/test_torch_voicebox.py` (heads and the feed-forward's inner width
  split, the Megatron pair): 3 `VoiceBoxTrainer` steps against the
  single-process trainer and the first against JAX's `loss_fn` on the same
  draws; the all-reduces over "model" a step; a "msgpack" checkpoint written
  under "tp" loaded into one process with `strict=True` and computing the
  ranks' forward, and resumed by ranks built from other weights; `sample`
  with CFG against the single process;
* "tp" on a second VoiceBox whose feed-forward inner width is odd (the
  flagship's case: `proj_in` split by the rule's chunk and its activation
  gathered, `proj_out` whole), whose cond-token table splits by rows, with
  GateLoop (`to_qkva` split and gathered) and attention dropout (the keep
  mask drawn for every head, each rank's cut): 2 steps against the single
  process;
* "fsdp+tp" on all four ranks (a 2 x 2 mesh): 3 steps against the single
  process and the first against JAX's `loss_fn`.
"""

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

from test_torch_parallel import (ACCUM, BATCH, LR, MIN_FSDP, STEPS, TRAIN, VB,  # noqa: E402
                                 _by, _cosines_and_close, _state, _step_draws, _vb_items)

WORLD = 4
# the second model: inner width int(64 * 4.03 * 2 / 3) = 171 (odd), 50 cond rows
ODD = dict(VB, num_cond_tokens=49, ff_mult=4.03, use_gateloop_layers=True, attn_dropout=0.25)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# the rules' layouts, without a process group


def test_flagship_feed_forward_follows_the_rule():
    """At the flagship's dim 512 the inner width is int(512 * 4 * 2 / 3) =
    1365: "tp" splits `proj_in` (2730 outputs) and leaves `proj_out` (1365
    rows) whole, as `test_sharding.py::test_tp_skips_indivisible` expects of
    the JAX rule; 501 cond rows stay whole; attention splits."""
    from voicebox_tpu_torch import VoiceBox
    from voicebox_tpu_torch.parallel.sharding_rules import module_partition_specs

    vb = VoiceBox(dim_in=128, num_cond_tokens=500, dim_cond_emb=512, dim=512, depth=2,
                  dim_head=128, heads=4, num_register_tokens=16)
    specs = module_partition_specs(vb, "tp", {"data": 1, "model": 2})
    ff = "transformer.layers.0.5"
    assert specs[f"{ff}.0.weight"] == ("model", None)
    assert specs[f"{ff}.3.weight"] == (None, None)
    assert specs["to_cond_emb.weight"] == (None, None)
    assert specs["transformer.layers.0.3.to_qkv.weight"] == ("model", None)
    assert specs["transformer.layers.0.3.to_out.weight"] == (None, "model")


def test_head_rows_gather_q_k_and_v_of_a_ranks_heads():
    """A rank's rows of the fused `to_qkv`: its heads in each of q, k and v,
    as many rows as the rule's contiguous chunk."""
    from voicebox_tpu_torch.parallel.tensor_parallel import _chunk, _heads

    rows = _heads(4, 128, 2, 3)  # the flagship: 4 heads of 128, model 2
    assert [len(r) for r in rows] == [768, 768] == [len(c) for c in _chunk(1536, 2)]
    assert rows[0][:256].tolist() == list(range(256))  # q heads 0-1
    assert rows[0][256:512].tolist() == list(range(512, 768))  # k heads 0-1
    assert rows[1][512:].tolist() == list(range(1280, 1536))  # v heads 2-3
    assert sorted(torch.cat(rows).tolist()) == list(range(1536))


# ----------------------------------------------------------------------
# four ranks under gloo: this file run as a script (torch and the port only)


def _field_inputs(seed=3):
    rs = np.random.RandomState(seed)
    n, d = 18, VB["dim_in"]
    return dict(x=rs.randn(2, n, d).astype(np.float32), cond=rs.randn(2, n, d).astype(np.float32),
                ids=rs.randint(0, 49, (2, n)).astype(np.int64),
                mask=np.arange(n)[None, :] < np.array([[n], [n - 5]]),
                times=np.array([0.3, 0.7], np.float32))


def _field(vb, inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        return vb(t["x"], times=t["times"], cond=t["cond"], cond_token_ids=t["ids"],
                  self_attn_mask=t["mask"],
                  cond_drop_mask=torch.zeros(2, dtype=torch.bool)).numpy()


def _worker(inp, out, rank, world, init_file):
    """One rank; rank 0 also runs the single-process references and writes
    out.npz."""
    import warnings

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from voicebox_tpu_torch import (ArrayDataset, ConditionalFlowMatcherWrapper, VoiceBox,
                                    VoiceBoxTrainer)
    from voicebox_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from voicebox_tpu_torch.utils.convert import denoiser_state

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")  # the single-process references run beside the group
    assert maybe_initialize_distributed(f"file://{init_file}", world, rank, backend="gloo")
    data, res = dict(np.load(inp)), {}
    state = _state(data, "vb.")
    names = ("data", "model")
    pair = DeviceMesh("cpu", torch.tensor([[0, 1]]), mesh_dim_names=names)  # every rank builds
    square = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=names)

    def vb_trainer(state, cfg=VB, single=False, steps=STEPS, items=None, **kw):
        vb = VoiceBox(**cfg)
        vb.load_state_dict(state, strict=True)
        cfm = ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device="cpu")
        return VoiceBoxTrainer(cfm, dataset=ArrayDataset(items or _vb_items()),
                               use_mesh=not single, **{**TRAIN, "num_train_steps": steps, **kw})

    def run(trainer, tag, steps=STEPS):
        """Steps on the explicit draws first; rank 0 records losses, norms,
        the first step's reduced gradients and the parameters after, whole."""
        grads, batches, dp = [], [], trainer.data_parallel
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
        it = trainer.dl_iter
        trainer.dl_iter = (batches.append(b) or b for b in it)
        draws = {k: torch.from_numpy(v) for k, v in _step_draws().items()}
        logs = [trainer.train_step(**(draws if s == 0 else {})) for s in range(steps)]
        first = dp.whole(grads[0]) if dp is not None else grads[0]
        params = ([p.detach() for _, p in trainer.named_params] if dp is None else
                  dp.whole([p.detach() for p in dp.params], sharded=False))
        if rank == 0:
            res[f"{tag}.loss"] = np.array([float(g["loss"]) for g in logs])
            res[f"{tag}.norm"] = np.array([float(g["grad_norm"]) for g in logs])
            res[f"{tag}.valid"] = np.array([r["valid_loss"] for r in trainer.metrics
                                            if "valid_loss" in r])
            for (n, _), g, p in zip(trainer.named_params, first, params):
                res[f"{tag}.grad.{n}"] = g.numpy()
                res[f"{tag}.param.{n}"] = p.numpy().copy()
        return batches

    cond = torch.from_numpy(np.random.RandomState(5).randn(2, 16, VB["dim_in"])
                            .astype(np.float32))
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, 50, (2, 16)))

    def sample(cfm):  # 2 midpoint steps, CFG as one 2b forward
        return cfm.eval().sample(cond=cond, semantic_token_ids=ids, steps=2, cond_scale=1.3,
                                 decode_to_audio=False,
                                 generator=torch.Generator().manual_seed(11)).numpy()

    # "tp" at model 2 on ranks 0 and 1
    if rank < 2:
        trainer = vb_trainer(state, mesh=pair, param_sharding="tp")
        dp = trainer.data_parallel
        vb = trainer.cfm_wrapper.voicebox
        held = sum(p.numel() for p in dp.params if p.dim() >= 2)
        res_rank = {"split": len(dp.splits), "held": held}
        tp_sample = sample(trainer.cfm_wrapper)  # the weights as loaded
        calls = []
        all_reduce = dist.all_reduce

        def counting(t, *args, group=None, **kw):
            calls.append(group is dp.tp_group)
            return all_reduce(t, *args, group=group, **kw)

        dist.all_reduce = counting
        try:
            run(trainer, "tp")
        finally:
            dist.all_reduce = all_reduce
        res_rank["model_all_reduces"] = sum(calls)
        trainer.save(f"{out}/tp.pt")  # rank 0 writes the whole state
        dist.barrier(group=pair.get_group("model"))
        field = _field(vb.eval(), _field_inputs())
        fresh = vb_trainer({k: v + 0.01 for k, v in state.items()}, mesh=pair,
                           param_sharding="tp")
        fresh.load(f"{out}/tp.pt")
        res_rank["resumed"] = all(torch.equal(a, b) for a, b in zip(trainer.params, fresh.params))
        if rank == 0:
            res["tp.field"], res["tp.sample"] = field, tp_sample
        for key, value in res_rank.items():
            got = [None, None]
            dist.all_gather_object(got, value, group=pair.get_group("model"))
            res[f"tp.{key}"] = np.array(got)
        del trainer, fresh

        # the odd feed-forward, the split cond table, GateLoop, attention dropout
        torch.manual_seed(5)
        odd = {k: v.detach().clone() for k, v in VoiceBox(**ODD).state_dict().items()}
        trainer = vb_trainer(odd, cfg=ODD, mesh=pair, param_sharding="tp", steps=2)
        res_rank = {"odd_splits": sorted(trainer.data_parallel.splits)}
        run(trainer, "odd", steps=2)
        got = [None, None]
        dist.all_gather_object(got, res_rank["odd_splits"], group=pair.get_group("model"))
        if rank == 0:
            res["odd.splits"] = np.array(got[0])
        del trainer

    # "fsdp+tp" on all four ranks
    trainer = vb_trainer(state, mesh=square, param_sharding="fsdp+tp", min_fsdp_size=MIN_FSDP)
    dp = trainer.data_parallel
    if rank == 0:
        res["fsdp_tp.both"] = np.array(sum(
            1 for n, a in zip(dp.names, dp.axes) if a is not None and n in dp.splits))
    run(trainer, "fsdp_tp")
    del trainer

    # "orbax" under "fsdp+tp": saved after 2 steps (the reference layout, whole),
    # resumed by ranks built from other weights
    draws = [{k: torch.from_numpy(v) for k, v in _step_draws(seed).items()} for seed in (1, 2, 3)]
    kw = dict(mesh=square, param_sharding="fsdp+tp", min_fsdp_size=MIN_FSDP,
              checkpoint_backend="orbax", ema_decay=0.9, items=_vb_items(same=True))
    full = vb_trainer(state, results_folder=f"{out}/orbax_full", **kw)
    full_logs = [full.train_step(**d) for d in draws]
    part = vb_trainer(state, results_folder=f"{out}/orbax_run", **kw)
    for d in draws[:2]:
        part.train_step(**d)
    part.save()
    fresh = vb_trainer({k: v + 0.01 for k, v in state.items()},
                       results_folder=f"{out}/orbax_run", **kw)
    fresh.load()
    resumed = fresh.train_step(**draws[2])
    same = all(torch.equal(a.detach(), b.detach()) for a, b in zip(full.params, fresh.params))
    same &= all(torch.equal(a, b) for a, b in zip(full.ema.shadow, fresh.ema.shadow))
    flags = [None] * world
    dist.all_gather_object(flags, bool(same and torch.equal(full_logs[2]["loss"],
                                                            resumed["loss"])))
    if rank == 0:
        res["orbax.same"] = np.array(flags)
    del full, part, fresh

    if rank == 0:
        batches = run(vb_trainer(state, single=True), "single")
        (bx, bmask), (bids, _) = batches[0]
        res.update({"batch.x": bx, "batch.mask": bmask, "batch.ids": bids})
        run(vb_trainer(odd, cfg=ODD, single=True, steps=2), "odd.single", steps=2)
        vb = VoiceBox(**VB)
        vb.load_state_dict(state, strict=True)
        res["single.sample"] = sample(ConditionalFlowMatcherWrapper(vb, device="cpu"))
        # the "tp" checkpoint in one process, strict
        pkg = torch.load(f"{out}/tp.pt", weights_only=False)
        loaded = VoiceBox(**VB)
        loaded.load_state_dict(denoiser_state(pkg["model"]), strict=True)
        res["tp.loaded_field"] = _field(loaded.eval(), _field_inputs())
        for n, p in loaded.named_parameters():
            res[f"tp.loaded.{n}"] = p.detach().numpy()
    dist.barrier()
    if rank == 0:
        np.savez(f"{out}/out.npz", **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX side's weights to four ranks in an .npz, the ranks run under
    gloo with a clock of their own (150 s), rank 0's results back."""
    import jax

    from test_torch_transformer import _xla_inv_freq
    from test_torch_voicebox import _models
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    jvb, _, params, _ = _models()
    tmp = tmp_path_factory.mktemp("tp")
    arrays = {f"vb.{k}": v.numpy() for k, v in _xla_inv_freq(
        voicebox_state_dict(jax.tree.map(np.asarray, params)), "transformer.").items()}
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
    return dict(np.load(tmp / "out.npz")), (jvb, params)


def _matches_single(res, tag, single, steps=STEPS, norm_steps=STEPS):
    np.testing.assert_allclose(res[f"{tag}.loss"], res[f"{single}.loss"][:steps], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(res[f"{tag}.valid"], res[f"{single}.valid"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res[f"{tag}.norm"][:norm_steps],
                               res[f"{single}.norm"][:norm_steps], rtol=1e-5)
    ours, ref = _by(res, f"{tag}.grad."), _by(res, f"{single}.grad.")
    zero = {k for k, v in ref.items() if not np.any(v)}  # the time MLP under zero-init norms
    for k in zero:
        np.testing.assert_array_equal(ours[k], 0.0, err_msg=k)
    _cosines_and_close({k: v for k, v in ours.items() if k not in zero}, ref, 0.9999, 1e-5)
    # Adam moves a weight by ~lr whatever its gradient's size, so a weight
    # whose gradient is near zero carries the gradients' rounding amplified
    _cosines_and_close(_by(res, f"{tag}.param."), _by(res, f"{single}.param."), 0.9999,
                       0.25 * LR)


@pytest.mark.parametrize("tag", ["tp", "fsdp_tp"])
def test_tp_steps_match_the_single_process(spawned, tag):
    """Three steps (grad_accum_every=2, the first on explicit draws, then
    the generator's) under "tp" (model 2) and "fsdp+tp" (2 x 2) against the
    single-process trainer on the same global batches: losses, the clip's
    norm over every piece, the validation loss, the first step's reduced
    gradients and the parameters after three steps, in the reference
    layout."""
    res, _ = spawned
    _matches_single(res, tag, "single")
    if tag == "fsdp_tp":  # some parameters are split over both axes
        assert int(res["fsdp_tp.both"]) >= 4


@pytest.mark.parametrize("tag", ["tp", "fsdp_tp"])
def test_tp_step_matches_jax_loss_fn(spawned, tag):
    """The first step's loss and reduced gradients against JAX's
    single-device loss on the same global batch and draws (the done bar:
    atol 2e-4; per-leaf cosine > 0.999 at atol 2e-3)."""
    import jax
    import jax.numpy as jnp

    from test_torch_train import _assert_leaves_close
    from voicebox_tpu.ops.ode import cfm_interpolant
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    res, (jvb, params) = spawned
    draws = _step_draws()

    @jax.jit
    def micro(p, x1, mask, ids, x0, t, cm, dm):
        w, flow = cfm_interpolant(x1, x0, t, 0.0)
        return jvb.apply({"params": p}, w, times=t, cond_token_ids=ids, self_attn_mask=mask,
                         cond_drop_mask=dm, target=flow, cond_mask=cm, train=True)

    total, grads = 0.0, None
    for i in range(ACCUM):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        args = [res["batch.x"][sl], res["batch.mask"][sl], res["batch.ids"][sl]] + [
            draws[k][sl] for k in ("noise", "times", "cond_mask", "cond_drop_mask")]
        value, g = jax.value_and_grad(micro)(params, *(jnp.asarray(a) for a in args))
        total += float(value) / ACCUM
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    ref = voicebox_state_dict(jax.tree.map(lambda a: np.asarray(a) / ACCUM, grads))
    np.testing.assert_allclose(res[f"{tag}.loss"][0], total, atol=2e-4, rtol=0)
    _assert_leaves_close(_by(res, f"{tag}.grad."), {k: v.numpy() for k, v in ref.items()})


def test_tp_ranks_hold_the_rules_share(spawned):
    """Each rank holds half of every matrix the rule splits (attention's
    q, k, v rows and out columns, the feed-forward's pair) and the rest
    whole: the same count on both ranks."""
    res, _ = spawned
    held, split = res["tp.held"], res["tp.split"]
    assert held[0] == held[1] and split[0] == split[1] == 4 * VB["depth"]
    from voicebox_tpu_torch import VoiceBox
    from voicebox_tpu_torch.parallel.sharding_rules import module_partition_specs

    vb = VoiceBox(**VB)
    specs = module_partition_specs(vb, "tp", {"data": 1, "model": 2})
    share = sum(p.numel() // (2 if "model" in specs[n] else 1)
                for n, p in vb.named_parameters() if p.dim() >= 2)
    assert held[0] == share


def test_tp_partial_sums_all_reduce(spawned):
    """The row-parallel products (attention's `to_out`, the feed-forward's
    `proj_out`) are all-reduced over "model" forward and the column-parallel
    inputs' gradients backward: 4 a layer a micro-batch; then once a step
    the qk-norm gains' and the whole biases' partial gradients and the
    clip's sum of squares; 3 steps of 2 micro-batches, and the validation
    forward (2 a layer)."""
    res, _ = spawned
    depth, micro = VB["depth"], STEPS * ACCUM
    expected = 4 * depth * micro + 2 * STEPS + 2 * depth
    assert res["tp.model_all_reduces"].tolist() == [expected, expected]


def test_tp_checkpoint_loads_in_one_process(spawned):
    """A "msgpack" checkpoint written under "tp" holds the reference layout:
    it loads into a single-process VoiceBox with strict=True, holds the
    ranks' parameters gathered whole, and computes the ranks' vector field;
    ranks built from other weights resume from it exactly."""
    res, _ = spawned
    for name, p in _by(res, "tp.loaded.").items():
        np.testing.assert_array_equal(p, res[f"tp.param.{name}"], err_msg=name)
    np.testing.assert_allclose(res["tp.loaded_field"], res["tp.field"], atol=1e-5, rtol=0)
    assert res["tp.resumed"].tolist() == [True, True]


def test_orbax_checkpoint_under_fsdp_tp_resumes_bit_for_bit(spawned):
    """"orbax" under "fsdp+tp" (the pieces gathered to the reference layout):
    saved after 2 steps, loaded by ranks built from other weights; the third
    step's loss, every parameter piece and the EMA equal the uninterrupted
    run's to the bit on every rank."""
    res, _ = spawned
    assert res["orbax.same"].tolist() == [True] * WORLD


def test_tp_sample_with_cfg_matches_the_single_process(spawned):
    """`sample` (2 midpoint steps, CFG 1.3 as one 2b forward, the same
    noise) from the split weights against the same weights in one process
    (`TestShardedInference::test_sample_cfg_sharded`)."""
    res, _ = spawned
    np.testing.assert_allclose(res["tp.sample"], res["single.sample"], atol=1e-5, rtol=1e-5)


def test_tp_with_odd_inner_width_split_rows_gateloop_and_dropout(spawned):
    """The flagship's layout on a small model: `proj_in` split by the rule's
    chunk and gathered, `proj_out` whole, the cond table split by rows,
    GateLoop's `to_qkva` split and gathered, attention dropout's keep masks
    drawn for every head: two steps equal the single process's. (The clip's
    norm is held at the first step: its gradients agree to 1e-5 relative,
    and Adam then moves each weight whose gradient is near zero by ~lr at
    the sign of its rounding, which moves the second norm by ~1e-4 on this
    model; the losses and the parameters after both steps are held.)"""
    res, _ = spawned
    splits = set(res["odd.splits"].tolist())
    assert "to_cond_emb.weight" in splits
    assert "transformer.layers.0.5.0.weight" in splits
    assert "transformer.layers.0.5.3.weight" not in splits
    assert "transformer.layers.0.1.to_qkva.weight" in splits
    _matches_single(res, "odd", "odd.single", steps=2, norm_steps=1)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
