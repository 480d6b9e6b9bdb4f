"""The port's data-parallel training (`voicebox_tpu_torch/parallel/`, the
sharded loaders of `training/data.py`, the trainers' `mesh`) against the
JAX package, on the CPU.

* `param_partition_spec` through `module_partition_specs` gives every
  parameter of the tiny VoiceBox, DurationPredictor (net and aligner) and
  TextToSemantic the placement JAX's rule gives the same leaf, in every
  mode, at meshes (2, 1), (4, 1) and (2, 2) and a small `min_fsdp_size`.
  Each JAX leaf is filled with its own index before conversion, so the
  port's tensor names its leaf and the permutation of its axes;
* the sharded loaders (`DataLoader`, `AlignedPairedDataLoader`,
  `PairedDataLoader` with `shard=(rank, world)` and `shard_group_size`)
  yield the rows and bucket targets of JAX's, and decode no other rank's
  row;
* one two-rank gloo run of this file as a script (below `__main__`; it
  imports torch and the port only, and is handed the JAX side's numbers
  in an `.npz`): `VoiceBoxTrainer` steps under "replicated" and "fsdp"
  with `grad_accum_every=2` against the single-process port and against
  JAX's `loss_fn` on the same draws, bf16 live parameters and bf16 moments
  under "fsdp", the clip's global norm over shards, a
  `TextToSemanticTrainer` step whose ranks hold unequal token counts
  against JAX's loss, and an "orbax" save and a bit-identical resume;
  the bytes a rank holds in weights and gradients (and their reduction's
  buffers) during a step, "fsdp" under "replicated".
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
# placement rules


def _marked(params):
    """A copy of a flax tree whose leaf i holds i * base + its flat index."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(params)
    base = 1 << int(max(np.size(x) for x in leaves) - 1).bit_length()
    assert base * len(leaves) < 2 ** 24  # exact in float32
    marked = [(i * base + np.arange(np.size(x), dtype=np.float64)).reshape(np.shape(x))
              for i, x in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, marked), base


def _jax_leaf_specs(params, mode, mesh_shape, min_fsdp_size):
    import jax
    from voicebox_tpu.parallel.sharding_rules import param_partition_spec

    specs = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(param_partition_spec(path, leaf, mode, mesh_shape, min_fsdp_size))
        specs.append(spec + (None,) * (np.ndim(leaf) - len(spec)))
    return specs


def _leaf_and_axes(t: np.ndarray, base: int, jax_shapes):
    """The JAX leaf a converted tensor came from and, per axis of the
    tensor, the JAX axis it is (by its stride in the leaf's flat index)."""
    leaf = int(t.flat[0]) // base
    assert np.all(t.astype(np.int64) // base == leaf), "a tensor of several leaves"
    shape = jax_shapes[leaf]
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    axes = []
    for j, n in enumerate(t.shape):
        if n == 1:
            axes.append(next(i for i, m in enumerate(shape) if m == 1 and i not in axes))
            continue
        step = int(np.take(t, 1, axis=j).flat[0] - np.take(t, 0, axis=j).flat[0])
        axes.append(strides.index(step))
    return leaf, axes


@functools.cache
def _rule_models():
    """(JAX params, port module, JAX params -> port state dict) of each model."""
    import jax

    from test_torch_duration import DP_CONFIG, _Codec
    from test_torch_voicebox import CONFIG, DIM_IN, _models
    from voicebox_tpu.models import duration as jd
    from voicebox_tpu.models.text_to_semantic import TextToSemantic as JaxT2S
    from voicebox_tpu.utils import tokenizer as jtok
    from voicebox_tpu_torch import DurationPredictor, TextToSemantic, VoiceBox
    from voicebox_tpu_torch.utils import convert
    from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

    vb_params = _models()[2]
    jdp = jd.DurationPredictor(tokenizer=jtok.GraphemeTokenizer(), audio_enc_dec=_Codec(),
                               **DP_CONFIG)
    dp_params = jdp.init_params(jax.random.PRNGKey(0), seq_len=24, n_phonemes=12, batch=2)
    t2s_cfg = dict(dim=32, num_text_token_ids=47, num_semantic_token_ids=30, source_depth=2,
                   target_depth=2, heads=2, dim_head=16)
    jt = JaxT2S(**t2s_cfg)
    jt.init_params(jax.random.PRNGKey(0), n_text=8, n_sem=8, batch=2)

    def dp_state(p):
        net = {k: v for k, v in p.items() if k != "aligner"}
        out = {f"net.{k}": v for k, v in convert.duration_predictor_state_dict(net).items()}
        out.update({f"aligner.{k}": v
                    for k, v in convert.aligner_state_dict(p["aligner"]).items()})
        return out

    return {
        "voicebox": (vb_params, VoiceBox(dim_in=DIM_IN, **CONFIG), convert.voicebox_state_dict),
        "duration": (dp_params, DurationPredictor(tokenizer=GraphemeTokenizer(),
                                                  audio_enc_dec=_Codec(), **DP_CONFIG),
                     dp_state),
        "text_to_semantic": (jt.params, TextToSemantic(**t2s_cfg, device="cpu"),
                             lambda p: convert.text_to_semantic_state_dict(p, dim_head=16)),
    }


@pytest.mark.parametrize("model", ["voicebox", "duration", "text_to_semantic"])
def test_param_partition_spec_matches_jax(model):
    import jax

    from voicebox_tpu_torch.parallel.sharding_rules import MODES, module_partition_specs

    params, port, to_port = _rule_models()[model]
    params = jax.tree.map(np.asarray, params)
    marked, base = _marked(params)
    state = {k: v.numpy() for k, v in to_port(marked).items()}
    jax_shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(params)]
    origin = {name: _leaf_and_axes(state[name], base, jax_shapes)
              for name, _ in port.named_parameters() if name in state}
    missing = {n for n, _ in port.named_parameters()} - set(origin)
    assert missing <= {"null_cond"}, missing  # the frozen null row has no JAX leaf
    checked = 0
    for mesh_shape in ({"data": 2, "model": 1}, {"data": 4, "model": 1},
                       {"data": 2, "model": 2}):
        for mode in MODES:
            for min_fsdp_size in (64, 2 ** 16):
                ref = _jax_leaf_specs(params, mode, mesh_shape, min_fsdp_size)
                ours = module_partition_specs(port, mode, mesh_shape, min_fsdp_size)
                for name, (leaf, axes) in origin.items():
                    want = tuple(ref[leaf][i] for i in axes)
                    assert ours[name] == want, (name, mode, mesh_shape, min_fsdp_size)
                    checked += any(a is not None for a in want)
    assert checked > 100  # the rules do split, on both axes


# ----------------------------------------------------------------------
# sharded loaders


class _Counting:
    """A dataset that records which items were decoded."""

    def __init__(self, items, item_length=True):
        self.items, self.decoded = items, []
        if item_length:
            self.item_length = lambda i: np.shape(items[i][0] if isinstance(items[i], tuple)
                                                  else items[i])[0]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        self.decoded.append(i)
        return self.items[i]


def _lengths(n, seed, lo=3, hi=40):
    return np.random.RandomState(seed).randint(lo, hi, n)


@pytest.mark.parametrize("world,group", [(2, None), (4, None), (2, 4)])
def test_data_loader_shards_match_jax(world, group):
    from voicebox_tpu.training import data as jdata
    from voicebox_tpu_torch.training import data as tdata

    rs = np.random.RandomState(0)
    items = [rs.randn(n, 3).astype(np.float32) for n in _lengths(19, 1)]
    kw = dict(batch_size=8, seed=3, bucket_multiple=16, bucket_offset=4, align_multiple=8)
    for rank in range(world):
        ours_ds = _Counting(items)
        ours = tdata.DataLoader(ours_ds, shard=(rank, world), shard_group_size=group, **kw)
        theirs = jdata.DataLoader(jdata.ArrayDataset(items), shard=(rank, world),
                                  shard_group_size=group, **kw)
        for (x, m), (jx, jm) in zip(ours, theirs):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(m, jm)
        # bucket targets from the lengths alone: only this rank's rows decoded
        assert len(ours_ds.decoded) == 3 * 8 // world

    pairs = [(x, rs.randint(0, 9, x.shape[0]).astype(np.int32)) for x in items]
    whole = list(tdata.AlignedPairedDataLoader(tdata.ArrayDataset(pairs), **kw))
    for rank in range(world):
        ds = _Counting(pairs)
        loader = tdata.AlignedPairedDataLoader(ds, shard=(rank, world),
                                               shard_group_size=group, **kw)
        for ((x, m), (ids, _)), ((wx, wm), (wids, _)) in zip(loader, whole):
            rows = tdata._rank_positions(8, (rank, world), group)
            np.testing.assert_array_equal(x, wx[rows])
            np.testing.assert_array_equal(m, wm[rows])
            np.testing.assert_array_equal(ids, wids[rows])
        assert len(ds.decoded) == 3 * 8 // world


@pytest.mark.parametrize("world,group", [(2, None), (2, 2)])
def test_paired_loader_shards_match_jax(world, group):
    from voicebox_tpu.training import data as jdata
    from voicebox_tpu_torch.training import data as tdata

    rs = np.random.RandomState(1)
    items = [(rs.randint(0, 30, a).astype(np.int32), rs.randn(b, 2).astype(np.float32))
             for a, b in zip(_lengths(13, 2), _lengths(13, 3, hi=70))]
    kw = dict(bucket_multiples=(8, 32), pad_values=(-1, 0.0), max_lengths=(None, 64), seed=5)
    for rank in range(world):
        ours = tdata.PairedDataLoader(tdata.PairedDataset(items), 4, shard=(rank, world),
                                      shard_group_size=group, **kw)
        theirs = jdata.PairedDataLoader(items, 4, shard=(rank, world), shard_group_size=group,
                                        **kw)
        n = 0
        for fields, jfields in zip(ours, theirs):
            for (a, m), (ja, jm) in zip(fields, jfields):
                np.testing.assert_array_equal(a, ja)
                np.testing.assert_array_equal(m, jm)
            n += 1
        assert n == 4


# ----------------------------------------------------------------------
# two ranks under gloo: this file run as a script (torch and the port only)

REPO = HERE.parent
WORLD = 2
# the tiny VoiceBox of tests/test_torch_voicebox.py and the TextToSemantic of
# tests/test_torch_text_to_semantic.py
VB = dict(num_cond_tokens=50, dim_cond_emb=32, dim=64, depth=2, dim_head=16, heads=2,
          num_register_tokens=2, attn_qk_norm=True, dim_in=24)
T2S = dict(dim=64, num_text_token_ids=47, num_semantic_token_ids=30, source_depth=2,
           target_depth=2, heads=2, dim_head=32)
LR, BATCH, ACCUM, STEPS, FRAMES = 1e-3, 4, 2, 3, 30  # items of 15-20 frames bucket to 30
TRAIN = dict(batch_size=BATCH, grad_accum_every=ACCUM, num_train_steps=STEPS,
             num_warmup_steps=1, lr=LR, initial_lr=1e-4, wd=1e-2, max_grad_norm=0.5,
             valid_frac=0.25, bucket_multiple=16, log_every=1, save_results_every=100,
             prefetch_batches=0, device="cpu")
MIN_FSDP = 512  # splits every weight matrix of the tiny model
CASES = {"replicated": {}, "fsdp": {}, "fsdp_bf16_params": {"param_dtype": torch.bfloat16},
         "fsdp_bf16_moments": {"moment_dtype": torch.bfloat16}}


def _vb_items(same=False):
    """16 (latents, ids) items of 15-20 frames; `same`: one item 16 times,
    so that every batch is the same whatever the loader's position (a
    checkpoint keeps none)."""
    rs = np.random.RandomState(24)
    items = [(rs.randn(n, VB["dim_in"]).astype(np.float32),
              rs.randint(0, VB["num_cond_tokens"], n).astype(np.int32))
             for n in rs.randint(15, 21, 16)]
    return items[:1] * 16 if same else items


def _step_draws(seed=7):
    """Explicit draws for a whole step's global batch (BATCH * ACCUM rows)."""
    rs, m = np.random.RandomState(seed), BATCH * ACCUM
    return dict(noise=rs.randn(m, FRAMES, VB["dim_in"]).astype(np.float32),
                times=rs.rand(m).astype(np.float32), cond_mask=rs.rand(m, FRAMES) < 0.7,
                cond_drop_mask=rs.rand(m) < 0.2)


def _t2s_items():
    rs = np.random.RandomState(6)
    return [(rs.randint(0, T2S["num_text_token_ids"], rs.randint(3, 10)).astype(np.int32),
             rs.randint(0, T2S["num_semantic_token_ids"], rs.randint(2, 15)).astype(np.int64))
            for _ in range(8)]


def _state(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in data.items() if k.startswith(prefix)}


def _worker(inp, out, rank, world, init_file):
    """One rank: every case's trainer under the mesh, and on rank 0 the
    single-process trainer on the same global batch; rank 0 writes out.npz."""
    import warnings

    import torch.distributed as dist

    from voicebox_tpu_torch import (ArrayDataset, ConditionalFlowMatcherWrapper, TextToSemantic,
                                    TextToSemanticTrainer, VoiceBox, VoiceBoxTrainer)
    from voicebox_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from voicebox_tpu_torch.parallel.mesh import shard_batch
    from voicebox_tpu_torch.training.data import PairedDataset

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")  # the single-process references run beside the group
    from voicebox_tpu_torch.parallel import data_parallel
    data_parallel.BUCKET = 4096  # buckets a fraction of the tiny model, as at full width
    assert maybe_initialize_distributed(f"file://{init_file}", world, rank, backend="gloo")
    data, res = dict(np.load(inp)), {}

    def vb_trainer(state, single=False, items=None, **kw):
        vb = VoiceBox(**VB)
        vb.load_state_dict(state, strict=True)
        cfm = ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device="cpu")
        return VoiceBoxTrainer(cfm, dataset=ArrayDataset(items or _vb_items()),
                               use_mesh=not single, **{**TRAIN, **kw})

    def capture(trainer, batches):
        """The step's reduced gradients (before the clip) and the batches."""
        grads, dp = [], trainer.data_parallel
        if dp is None:
            apply = trainer._apply_gradients

            def applied(loss, g):
                grads.append([x.clone() for x in g])
                return apply(loss, g)

            trainer._apply_gradients = applied
        else:
            reduce = dp.reduce

            def reduced(g, scalars):
                out = reduce(g, scalars)
                grads.append([x.clone() for x in out[0]])
                return out

            dp.reduce = reduced
        it = trainer.dl_iter
        trainer.dl_iter = (batches.append(b) or b for b in it)
        return grads

    def held(trainer, grads):
        """Bytes of the distinct storages of the module's weights, the
        tensors the optimizer steps and `grads`."""
        tensors = [p.detach() for p in trainer.params] + [p.detach() for p in trainer.opt_params]
        tensors += [g for g in grads if g is not None]
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
        return sum(storages.values())

    def run(trainer, tag):
        batches = []
        dp = trainer.data_parallel
        measure = dp is not None and tag in ("replicated", "fsdp")
        if measure:
            reduce_ = dp.reduce
            buffer_peak = [0]  # the largest buffer a reduction's collective took, in bytes

            def measured(g, scalars):  # the weights and gradients as the reduction starts
                res[f"{tag}.held_bytes"] = np.array(held(trainer, g))
                collectives = dist.all_reduce, dist.reduce_scatter_tensor

                def noted(fn):
                    def call(*tensors, **kw):
                        buffer_peak[0] = max(buffer_peak[0], sum(
                            t.numel() * t.element_size() for t in tensors))
                        return fn(*tensors, **kw)
                    return call

                dist.all_reduce, dist.reduce_scatter_tensor = map(noted, collectives)
                try:
                    return reduce_(g, scalars)
                finally:
                    dist.all_reduce, dist.reduce_scatter_tensor = collectives

            dp.reduce = measured
        grads = capture(trainer, batches)
        draws = {k: torch.from_numpy(v) for k, v in _step_draws().items()}
        logs = [trainer.train_step(**(draws if s == 0 else {})) for s in range(STEPS)]
        if measure:
            res[f"{tag}.buffer_peak"] = np.array(buffer_peak[0])
            res[f"{tag}.moment_bytes"] = np.array(sum(
                t.numel() * t.element_size() for p in trainer.opt_params
                for t in trainer.optimizer.state[p].values() if torch.is_tensor(t)))
        first = grads[0]
        if trainer.data_parallel is not None and trainer.data_parallel.mode == "fsdp":
            first = trainer.data_parallel.gather(first)
        if rank == 0:
            res[f"{tag}.loss"] = np.array([float(g["loss"]) for g in logs])
            res[f"{tag}.norm"] = np.array([float(g["grad_norm"]) for g in logs])
            res[f"{tag}.valid"] = np.array([r["valid_loss"] for r in trainer.metrics
                                            if "valid_loss" in r])
            for (n, _), g in zip(trainer.named_params, first):
                res[f"{tag}.grad.{n}"] = g.numpy()
            for n, p in trainer.named_params:
                res[f"{tag}.param.{n}"] = p.detach().numpy().copy()
        return batches

    state = _state(data, "vb.")
    for case, kw in CASES.items():
        mode = "replicated" if case == "replicated" else "fsdp"
        trainer = vb_trainer(state, param_sharding=mode, min_fsdp_size=MIN_FSDP, **kw)
        dp = trainer.data_parallel
        assert dp.world == world and trainer._shard == (rank, world)
        rows = shard_batch(trainer.mesh, {"x": torch.arange(BATCH)})["x"]
        assert rows.tolist() == list(range(rank * BATCH // world, (rank + 1) * BATCH // world))
        run(trainer, case)
        if case == "fsdp":  # "msgpack" under fsdp: rank 0 writes the gathered state
            path = trainer.save(f"{out}/fsdp.pt")
            dist.barrier()
            fresh = vb_trainer({k: v + 0.01 for k, v in state.items()}, param_sharding=mode,
                               min_fsdp_size=MIN_FSDP)
            fresh.load(f"{out}/fsdp.pt")
            same = all(torch.equal(a, b) for a, b in zip(trainer.opt_params, fresh.opt_params))
            same &= all(torch.equal(a, b) for a, b in zip(trainer.params, fresh.params))
            same &= all(torch.equal(trainer.optimizer.state[a][k], fresh.optimizer.state[b][k])
                        for a, b in zip(trainer.opt_params, fresh.opt_params)
                        for k in ("exp_avg", "exp_avg_sq"))
            flags = [None] * world
            dist.all_gather_object(flags, (same and fresh.steps == STEPS, path is not None))
            for r, (ok, written) in enumerate(flags):
                res[f"{case}.msgpack_same.{r}"] = np.array(ok)
                res[f"{case}.msgpack_written.{r}"] = np.array(written)
        if rank == 0 and mode == "fsdp":
            split = [i for i, a in enumerate(dp.axes) if a is not None]
            res[f"{case}.split"] = np.array(len(split))
            res[f"{case}.moment_shapes_ok"] = np.array(all(
                trainer.optimizer.state[dp.shards[i]]["exp_avg"].shape == dp.shards[i].shape
                and dp.shards[i].numel() * world == dp.params[i].numel() for i in split))
        if rank == 0:
            batches = run(vb_trainer(state, single=True, **kw), f"{case}.single")
            if case == "replicated":
                (x, mask), (ids, _) = batches[0]
                res.update({"batch.x": x, "batch.mask": mask, "batch.ids": ids})

    # the seq2seq: a token-mean loss, ranks holding unequal token counts
    t2s_kw = dict(batch_size=BATCH, num_train_steps=1, lr=LR, max_grad_norm=0.5, valid_frac=0,
                  text_bucket_multiple=8, semantic_bucket_multiple=8, save_results_every=100,
                  prefetch_batches=0, device="cpu")
    for tag, single in (("t2s", False), ("t2s.single", True)):
        if single and rank != 0:
            continue
        t2s = TextToSemantic(**T2S, device="cpu")
        t2s.load_state_dict(_state(data, "t2s."), strict=True)
        trainer = TextToSemanticTrainer(t2s, dataset=PairedDataset(_t2s_items()),
                                        use_mesh=not single, **t2s_kw)
        batches = []
        trainer.dl_iter = (batches.append(b) or b for b in trainer.dl_iter)
        loss = float(trainer.train_step()["loss"])
        (text, _), (sem, _) = batches[0]
        count = torch.tensor(int(((sem != -1).sum(-1) + 1).sum()))
        counts = [torch.zeros_like(count) for _ in range(world)]
        if not single:
            dist.all_gather(counts, count)
        if rank == 0:
            res[f"{tag}.loss"] = np.array(loss)
            res[f"{tag}.valid"] = np.array([r["valid_loss"] for r in trainer.metrics
                                            if "valid_loss" in r])
            if single:
                res.update({"t2s.batch.text": text, "t2s.batch.sem": sem})
            else:
                res["t2s.counts"] = torch.stack(counts).numpy()

    # "orbax": save after 2 steps, resume in trainers built from other weights
    draws = [{k: torch.from_numpy(v) for k, v in _step_draws(seed).items()} for seed in (1, 2, 3)]
    other = {k: v + 0.01 for k, v in state.items()}
    kw = dict(items=_vb_items(same=True), param_sharding="fsdp", min_fsdp_size=MIN_FSDP,
              checkpoint_backend="orbax", ema_decay=0.9)
    full = vb_trainer(state, results_folder=f"{out}/orbax_full", **kw)
    full_logs = [full.train_step(**d) for d in draws]
    part = vb_trainer(state, results_folder=f"{out}/orbax_run", **kw)
    for d in draws[:2]:
        part.train_step(**d)
    path = part.save()
    fresh = vb_trainer(other, results_folder=f"{out}/orbax_run", **kw)
    fresh.load()
    assert fresh.steps == 2
    resumed = fresh.train_step(**draws[2])
    ema_full, ema_fresh = full.ema_params, fresh.ema_params
    if rank == 0:
        res["orbax.files"] = np.array(sorted(p.name for p in path.iterdir()))
        res["orbax.loss"] = np.array([float(full_logs[2]["loss"]), float(resumed["loss"])])
        res["orbax.same"] = np.array(all(
            torch.equal(a.detach(), b.detach()) for a, b in zip(full.params, fresh.params)))
        res["orbax.same_ema"] = np.array(all(torch.equal(ema_full[n], ema_fresh[n])
                                             for n in ema_full))
    dist.barrier()
    if rank == 0:
        np.savez(f"{out}/out.npz", **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX side's weights to both ranks in an .npz, the two ranks run
    under gloo with a clock of their own (120 s), rank 0's results back."""
    import jax

    import test_torch_text_to_semantic as tt
    from test_torch_transformer import _xla_inv_freq
    from test_torch_voicebox import _models
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    jvb, _, params, _ = _models()
    jt, tparams = tt._models()
    tmp = tmp_path_factory.mktemp("dp")
    arrays = {f"vb.{k}": v.numpy() for k, v in _xla_inv_freq(
        voicebox_state_dict(jax.tree.map(np.asarray, params)), "transformer.").items()}
    arrays.update({f"t2s.{k}": v.numpy() for k, v in tt.port_state(tparams).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp / "in.npz"), str(tmp), str(r),
                               str(WORLD), str(tmp / "init")], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + 120
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                .decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
    return dict(np.load(tmp / "out.npz")), (jvb, params, jt, tparams)


def _cosines_and_close(ours: dict, ref: dict, cos_min: float, atol: float):
    for key, a in ours.items():
        a, b = np.asarray(a, np.float64), np.asarray(ref[key], np.float64)
        cos = float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
        assert cos > cos_min, (key, cos)
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-2, err_msg=key)


def _by(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_steps_match_the_single_process(spawned, case):
    """Three steps (grad_accum_every=2; the first on explicit draws, then
    the generator's, drawn at the global shape) under the mesh against the
    single-process trainer on the same global batches: losses, the clip's
    norm (over shards under "fsdp"), the validation loss, the first step's
    reduced gradients and the parameters after three steps."""
    res, _ = spawned
    ours, single = f"{case}.", f"{case}.single."
    if case.startswith("fsdp_bf16"):
        # bf16 rounds each micro-batch's gradients (live parameters) or each
        # update (moments) of values that differ in their last fp32 bits
        # between two ranks and one process, so the runs part by bf16
        # rounding: held to half the gap of the single process's bf16 run
        # to its fp32 run
        for key in ("loss", "valid"):
            floor = np.abs(res[single + key] - res[f"replicated.single.{key}"])
            assert np.all(np.abs(res[ours + key] - res[single + key]) <= 0.5 * floor + 1e-6), key
        _cosines_and_close(_by(res, ours + "grad."), _by(res, single + "grad."), 0.9999, 1e-3)
        ours_p, single_p = _by(res, ours + "param."), _by(res, single + "param.")
        fp32_p = _by(res, "replicated.single.param.")
        gap = sum(float(np.square(ours_p[k] - single_p[k]).sum()) for k in ours_p)
        gap_floor = sum(float(np.square(single_p[k] - fp32_p[k]).sum()) for k in ours_p)
        assert gap <= 0.25 * gap_floor, (gap, gap_floor)
        return
    np.testing.assert_allclose(res[ours + "loss"], res[single + "loss"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res[ours + "valid"], res[single + "valid"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res[ours + "norm"], res[single + "norm"], rtol=1e-5)
    _cosines_and_close(_by(res, ours + "grad."), _by(res, single + "grad."), 0.9999, 1e-5)
    # Adam moves a weight by ~lr whatever its gradient's size, so a weight
    # whose gradient is near zero carries the gradients' rounding amplified
    _cosines_and_close(_by(res, ours + "param."), _by(res, single + "param."), 0.9999,
                       0.25 * LR)


def test_fsdp_splits_parameters_and_their_moments(spawned):
    """Shards of the parameters and their moments; a "msgpack" checkpoint
    of an fsdp run written by rank 0 alone and read back by every rank."""
    res, _ = spawned
    for case in CASES:
        if case != "replicated":
            assert int(res[f"{case}.split"]) >= 10 and bool(res[f"{case}.moment_shapes_ok"])
    assert bool(res["fsdp.msgpack_written.0"]) and not bool(res["fsdp.msgpack_written.1"])
    assert bool(res["fsdp.msgpack_same.0"]) and bool(res["fsdp.msgpack_same.1"])


def test_fsdp_holds_fewer_bytes_than_replicated(spawned):
    """A rank's weights, optimizer masters and gradients as the reduction
    starts, plus the reduction's largest flat buffer: under "fsdp" the
    gradients go through reduce-scatter buckets (4096 elements here) into
    the shards, where "replicated" all-reduces one flat copy of them all;
    "fsdp" holds fewer bytes, with the moments and without."""
    res, _ = spawned
    step = {m: int(res[f"{m}.held_bytes"]) + int(res[f"{m}.buffer_peak"])
            for m in ("replicated", "fsdp")}
    assert int(res["fsdp.buffer_peak"]) < int(res["replicated.buffer_peak"])
    assert step["fsdp"] < step["replicated"], step
    with_moments = {m: step[m] + int(res[f"{m}.moment_bytes"]) for m in step}
    assert with_moments["fsdp"] < with_moments["replicated"], with_moments
    # the masters split: half the split weights' bytes, not more
    assert int(res["fsdp.moment_bytes"]) < int(res["replicated.moment_bytes"])


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_data_parallel_step_matches_jax_loss_fn(spawned, mode):
    """The first step's loss and reduced gradients against JAX's
    single-device loss on the same global batch and draws (the done bar)."""
    import jax
    import jax.numpy as jnp

    from test_torch_train import _assert_leaves_close
    from voicebox_tpu.ops.ode import cfm_interpolant
    from voicebox_tpu_torch.utils.convert import voicebox_state_dict

    res, (jvb, params, _, _) = spawned
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
    np.testing.assert_allclose(res[f"{mode}.loss"][0], total, atol=2e-4, rtol=0)
    _assert_leaves_close(_by(res, f"{mode}.grad."), {k: v.numpy() for k, v in ref.items()})


def test_seq2seq_ranks_are_weighted_by_their_token_counts(spawned):
    """The seq2seq loss is sum(nll) / sum(mask) over the global batch. The
    ranks hold unequal token counts, so a plain mean of their losses would
    miss it; weighted by each rank's share it equals the single process's
    and JAX's, in training and in validation."""
    import jax
    import jax.numpy as jnp

    res, (_, _, jt, tparams) = spawned
    counts = res["t2s.counts"]
    assert counts[0] != counts[1], counts
    text, sem = res["t2s.batch.text"], res["t2s.batch.sem"]
    loss_fn = jax.jit(jt.loss_fn)
    ref = float(loss_fn(tparams, jnp.asarray(text), jnp.asarray(sem)))
    np.testing.assert_allclose(res["t2s.loss"], ref, atol=2e-4, rtol=0)
    np.testing.assert_allclose(res["t2s.loss"], res["t2s.single.loss"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res["t2s.valid"], res["t2s.single.valid"], atol=1e-6, rtol=0)
    half = BATCH // WORLD
    plain = np.mean([float(loss_fn(tparams, jnp.asarray(text[r * half:(r + 1) * half]),
                                   jnp.asarray(sem[r * half:(r + 1) * half])))
                     for r in range(WORLD)])
    assert abs(plain - ref) > 1e-3, (plain, ref)


def test_orbax_checkpoint_resumes_bit_for_bit(spawned):
    """"orbax" under "fsdp": saved after 2 steps, loaded by ranks built from
    other weights; the third step's loss, every parameter and the EMA equal
    the uninterrupted run's to the bit; each rank wrote its own shards."""
    res, _ = spawned
    loss = res["orbax.loss"]
    assert loss[0] == loss[1], loss
    assert bool(res["orbax.same"]) and bool(res["orbax.same_ema"])
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(res["orbax.files"].tolist())


def test_sharded_checkpointer_keeps_the_newest_steps(tmp_path):
    from voicebox_tpu_torch.training.checkpoint import ShardedCheckpointer

    ckpt = ShardedCheckpointer(tmp_path / "orbax", max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, {"w": torch.full((3,), float(step))})
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    state = {"w": torch.zeros(3)}
    assert ckpt.load(None, state).name == "3" and state["w"].tolist() == [3.0] * 3
    ckpt.load(tmp_path / "orbax" / "2", state)
    assert state["w"].tolist() == [2.0] * 3
    with pytest.raises(ValueError, match="step directory"):
        ckpt.resolve(tmp_path / "orbax" / "latest.ckpt")


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
