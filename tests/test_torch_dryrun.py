"""The port's multi-chip dry run (`voicebox_tpu_torch/dryrun.py`, the
counterpart of `__graft_entry__.py::dryrun_multichip`) over four gloo ranks
on the CPU: one "fsdp+tp" step at a 2 x 2 mesh, one data-parallel step of
each stage trainer, the sequence-parallel loss and gradients at 8 frames a
shard, the pipeline's loss and gradients over four stages; every loss and
gradient finite (the ranks check the gradients; a rank that fails fails the
run)."""

import math

import pytest
import torch

from voicebox_tpu_torch.dryrun import dryrun_multichip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dryrun_multichip_over_four_cpu_ranks():
    res = dryrun_multichip(4, device="cpu", timeout=150)
    assert res["placement"] == "cpu" and res["rank"] == 0
    assert res["fsdp_tp"]["mesh"] == [2, 2]
    assert res["sp"]["frames"] == 32
    assert (res["pp"]["stages"], res["pp"]["microbatches"]) == (4, 4)
    losses = [res["fsdp_tp"]["loss"], *res["stages"].values(), res["sp"]["loss"],
              res["pp"]["loss"], res["sp"]["grad_norm"]]
    assert all(math.isfinite(v) for v in losses), res
    # rank 0 holds stage 0's rows, the registers and the final norm
    assert res["pp"]["grads_held"] > 0


def test_dryrun_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
