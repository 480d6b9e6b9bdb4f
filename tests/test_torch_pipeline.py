"""The port's pipeline parallelism (`voicebox_tpu_torch/parallel/pipeline.py`)
against the JAX package's, on the CPU.

Mirrors `tests/test_pipeline.py`: the V-cycle at (stages, depth,
microbatches) = (4, 8, 5), (2, 8, 3) and (1, 4, 2) with U-Net skips,
registers, adaptive RMSNorm and qk-norm; a model with neither skips nor
registers; an indivisible depth refused; the gradients. One four-rank gloo
run of this file as a script (below `__main__`; torch and the port only,
handed the inputs and the converted JAX weights in an `.npz`; each rank
writes its results): a 4-stage group over ranks 0-3, a 2-stage group over
ranks 0-1 and a 1-stage group of rank 0.

The JAX side: `make_pp_forward` itself, jitted over 4 virtual CPU devices
(the 4-stage forward and the gradients, of the parameters, the input and
the condition), and `Transformer(scan_layers=True).apply` per microbatch
for the other cases. The done bar: atol 2e-4 on the forward; per-leaf
gradient cosine > 0.999 at atol 2e-3, at qk-norm gains 0.25-0.5.
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

WORLD = 4
MODEL = dict(dim=32, dim_head=8, heads=4, num_register_tokens=2, use_unet_skip_connection=True,
             adaptive_rmsnorm=True, adaptive_rmsnorm_cond_dim_in=16, attn_qk_norm=True)
BARE = dict(MODEL, use_unet_skip_connection=False, num_register_tokens=0,
            adaptive_rmsnorm=False, adaptive_rmsnorm_cond_dim_in=None)
# name: (stages, depth, microbatches, model)
CASES = {"s4": (4, 8, 5, MODEL), "s2": (2, 8, 3, MODEL), "s1": (1, 4, 2, MODEL),
         "bare": (4, 8, 4, BARE), "grad": (4, 8, 4, MODEL)}
B, N = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(case, seed):
    stages, depth, M, cfg = CASES[case]
    rs = np.random.RandomState(seed)
    x = rs.randn(M, B, N, 32).astype(np.float32)
    cond = rs.randn(M, B, 16).astype(np.float32)
    mask = rs.rand(M, B, N) < 0.8
    mask[:, :, :3] = True
    return x, (cond if cfg["adaptive_rmsnorm"] else None), (mask if case != "bare" else None)


def _worker(inp, out_dir, rank, world, init_file):
    """One rank; each writes r{rank}.npz."""
    import torch.distributed as dist

    from voicebox_tpu_torch.models.transformer import Transformer
    from voicebox_tpu_torch.parallel import make_pp_forward
    from voicebox_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from voicebox_tpu_torch.parallel.sequence_parallel import seq_shard

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(f"file://{init_file}", world, rank, backend="gloo")
    data, res = dict(np.load(inp)), {}
    groups = {4: dist.group.WORLD, 2: dist.new_group([0, 1]), 1: dist.new_group([0])}
    for case, (stages, depth, M, cfg) in CASES.items():
        if rank >= stages:
            continue
        tr = Transformer(depth=depth, **cfg)
        tr.load_state_dict({k[len(case) + 4:]: torch.from_numpy(v) for k, v in data.items()
                            if k.startswith(f"{case}.sd.")}, strict=True)
        fn = make_pp_forward(tr, groups[stages], num_microbatches=M, device="cpu")
        x = torch.from_numpy(data[f"{case}.x"])
        cond = torch.from_numpy(data[f"{case}.cond"]) if f"{case}.cond" in data else None
        mask = torch.from_numpy(data[f"{case}.mask"]) if f"{case}.mask" in data else None
        if case != "grad":
            with torch.no_grad():
                out = fn(x, mask, cond)
            if rank == 0:
                res[f"{case}.out"] = out.numpy()
            continue
        x.requires_grad_(True)
        cond.requires_grad_(True)
        out = fn(x, mask, cond)
        out.square().mean().backward()  # the same call on every rank
        if rank == 0:
            res[f"{case}.out"] = out.detach().numpy()
            res[f"{case}.dx"] = x.grad.numpy()
        res[f"{case}.dcond"] = cond.grad.numpy()  # summed over the stages: on every rank
        for name, p in tr.named_parameters():
            if p.grad is not None:
                res[f"{case}.grad.{name}"] = p.grad.numpy()
        res[f"{case}.device_params"] = np.array(sorted(
            n for n, p in tr.named_parameters() if p.grad is not None))
    # refusals: an indivisible depth, sequence parallelism
    for what, call in (
            ("indivisible", lambda: make_pp_forward(Transformer(depth=6, **MODEL), groups[4],
                                                    num_microbatches=2, device="cpu")),
            ("seq_shard", lambda: _under_shard(seq_shard, groups[4], make_pp_forward(
                Transformer(depth=8, **BARE), groups[4], num_microbatches=1, device="cpu")))):
        try:
            call()
            res[f"refused.{what}"] = np.array("")
        except ValueError as e:
            res[f"refused.{what}"] = np.array(str(e))
    dist.barrier()
    np.savez(f"{out_dir}/r{rank}.npz", **res)
    dist.destroy_process_group()


def _under_shard(seq_shard, group, fn):
    with seq_shard(group):
        fn(torch.zeros(1, 1, 4, 32))


def _jax_model(case):
    from voicebox_tpu.models.transformer import Transformer as JaxTransformer

    stages, depth, M, cfg = CASES[case]
    return JaxTransformer(depth=depth, scan_layers=True, **cfg)


@functools.cache
def _jax_case(case):
    """The JAX module and its perturbed scan-layout parameters."""
    import jax
    import jax.numpy as jnp

    from test_torch_transformer import _perturbed

    tr = _jax_model(case)
    x, cond, mask = _data(case, seed=len(case))
    kw = {} if cond is None else dict(adaptive_rmsnorm_cond=jnp.asarray(cond[0]))
    if mask is not None:
        kw["mask"] = jnp.asarray(mask[0])
    params = jax.jit(tr.init)(jax.random.PRNGKey(len(case)), jnp.asarray(x[0]), **kw)["params"]
    rs = np.random.RandomState(len(case))

    def gains(path, p):  # qk-norm gains in [0.25, 0.5]: logits up to 10 d / 4
        if any(getattr(k, "key", None) in ("q_norm", "k_norm") for k in path):
            return rs.uniform(0.25, 0.5, p.shape).astype(np.float32)
        return p

    return tr, jax.tree_util.tree_map_with_path(gains, _perturbed(params, rs))


def _jit_inv_freq(state):
    """The rotary inverse frequencies XLA folds under jit, into a converted
    state dict. Every JAX side here is jitted, and the folded pow is one ulp
    off its eager value (`_xla_inv_freq`'s) in places: at the registers'
    position -10000 that is ~6e-5 of the angle, which the qk-normed softmax
    amplifies over depth past the tolerance."""
    import jax
    import jax.numpy as jnp

    from voicebox_tpu.models.primitives import rotary_frequencies

    d = 2 * state["rotary_emb.inv_freq"].shape[0]
    table = np.asarray(jax.jit(lambda: rotary_frequencies(jnp.ones((1,), jnp.int32), d))())
    return {**state, "rotary_emb.inv_freq": torch.from_numpy(np.array(table[0, : d // 2]))}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs and the converted JAX weights of every case to four ranks
    in an .npz, the ranks run under gloo with a clock of their own (120 s),
    every rank's results back."""
    from voicebox_tpu_torch.utils.convert import transformer_state_dict

    tmp = tmp_path_factory.mktemp("pp")
    arrays = {}
    for case in CASES:
        _, params = _jax_case(case)
        sd = _jit_inv_freq(transformer_state_dict(params, dim_head=8))
        arrays.update({f"{case}.sd.{k}": v.numpy() for k, v in sd.items()})
        x, cond, mask = _data(case, seed=len(case))
        arrays[f"{case}.x"] = x
        if cond is not None:
            arrays[f"{case}.cond"] = cond
        if mask is not None:
            arrays[f"{case}.mask"] = mask
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
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)]


@functools.cache
def _jax_pipeline(case):
    """JAX's `make_pp_forward` over its stages of the virtual CPU devices,
    jitted: the output and, for "grad", the gradients of mean(out^2) in the
    parameters, the input and the condition."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from voicebox_tpu.parallel.pipeline import make_pp_forward

    stages, _, M, _ = CASES[case]
    tr, params = _jax_case(case)
    x, cond, mask = (None if a is None else jnp.asarray(a) for a in _data(case, seed=len(case)))
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pipe",))
    fn = make_pp_forward(tr, mesh, num_microbatches=M)
    if case != "grad":
        return np.asarray(jax.jit(fn)(params, x, mask, cond)), None

    def loss(p, xs, cs):
        out = fn(p, xs, mask, cs)
        return jnp.mean(jnp.square(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, x, cond)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _jax_per_microbatch(case):
    """`Transformer(scan_layers=True).apply` on each microbatch, jitted."""
    import jax
    import jax.numpy as jnp

    tr, params = _jax_case(case)
    x, cond, mask = _data(case, seed=len(case))
    apply = jax.jit(lambda p, xm, mm, cm: tr.apply({"params": p}, xm, mask=mm,
                                                   adaptive_rmsnorm_cond=cm))
    return np.stack([np.asarray(apply(params, jnp.asarray(x[m]),
                                      None if mask is None else jnp.asarray(mask[m]),
                                      None if cond is None else jnp.asarray(cond[m])))
                     for m in range(x.shape[0])])


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_mirror_back_rows_is_jax_order(stages):
    """Each stage's back rows in the order JAX's `mirror_back_rows` gives
    the `layers_back` stack, and their skips come from the stage's own
    front rows."""
    from voicebox_tpu.parallel.pipeline import mirror_back_rows as jax_mirror
    from voicebox_tpu_torch.parallel.pipeline import mirror_back_rows, stage_layers

    half = 4
    got = jax_mirror({"layers_back": {"w": np.arange(half)}}, stages)["layers_back"]["w"]
    assert mirror_back_rows(half, stages) == got.tolist()
    for s in range(stages):
        front, back = stage_layers(2 * half, stages, s)
        # layer half + r pops the skip of layer half - 1 - r
        assert sorted(2 * half - 1 - i for i in back) == front


def test_mirror_back_rows_refuses_an_indivisible_half():
    from voicebox_tpu_torch.parallel.pipeline import mirror_back_rows

    with pytest.raises(ValueError, match="divide"):
        mirror_back_rows(3, 4)


def test_four_stages_match_jax_make_pp_forward(spawned):
    np.testing.assert_allclose(spawned[0]["s4.out"], _jax_pipeline("s4")[0], atol=2e-4, rtol=0)


@pytest.mark.parametrize("case", ["s2", "s1", "bare"])
def test_stages_match_jax_per_microbatch(spawned, case):
    np.testing.assert_allclose(spawned[0][f"{case}.out"], _jax_per_microbatch(case),
                               atol=2e-4, rtol=0)


def test_gradients_match_jax_make_pp_forward(spawned):
    """mean(out^2) backward on every rank: each rank's row gradients, the
    registers' and the final norm's on rank 0, the input's on rank 0 and
    the condition's (summed over the stages) against JAX's; each rank holds
    gradients of its own rows only."""
    from test_torch_train import _assert_leaves_close
    from voicebox_tpu_torch.parallel.pipeline import stage_layers
    from voicebox_tpu_torch.utils.convert import transformer_state_dict

    out, (g_params, g_x, g_cond) = _jax_pipeline("grad")
    np.testing.assert_allclose(spawned[0]["grad.out"], out, atol=2e-4, rtol=0)
    ref = {k: v.numpy() for k, v in transformer_state_dict(g_params, dim_head=8).items()
           if not k.startswith("rotary_emb")}
    ours = {}
    stages, depth = CASES["grad"][:2]
    for r, res in enumerate(spawned):
        rows = set(sum(stage_layers(depth, stages, r), []))
        names = [k[len("grad.grad."):] for k in res if k.startswith("grad.grad.")]
        extra = {"register_tokens", "final_norm.gamma"} if r == 0 else set()
        assert {n for n in names if not n.startswith("layers.")} == extra, (r, names)
        assert {int(n.split(".")[1]) for n in names if n.startswith("layers.")} == rows, r
        ours.update({n: res[f"grad.grad.{n}"] for n in names})
        np.testing.assert_allclose(res["grad.dcond"], spawned[0]["grad.dcond"], atol=0, rtol=0)
    assert set(ours) == set(ref)
    _assert_leaves_close(ours, ref)
    _assert_leaves_close({"x": spawned[0]["grad.dx"], "cond": spawned[0]["grad.dcond"]},
                         {"x": np.asarray(g_x), "cond": np.asarray(g_cond)})


def test_indivisible_depth_and_sequence_parallelism_are_refused(spawned):
    for res in spawned:
        assert "divide" in str(res["refused.indivisible"])
        assert "sequence parallelism" in str(res["refused.seq_shard"])


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
