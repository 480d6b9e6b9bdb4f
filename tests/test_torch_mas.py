"""The port's monotonic alignment search (`ops/mas.py`) against the JAX
package's `maximum_path`, on the CPU: the paths must be equal, cell for
cell, on random scores, on tie-heavy scores (small integers, all zeros, and
the aligner's soft alignment at temperature 5e-4 where most cells underflow
to exactly 0), with ragged phoneme and frame lengths, rows longer than
their frames (no path) and one phoneme."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.ops.mas import maximum_path as jax_maximum_path
from voicebox_tpu_torch.ops.mas import maximum_path

_jax_mas = jax.jit(jax_maximum_path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _masks(x_lens, y_lens, t_x, t_y):
    px = np.arange(t_x)[None, :] < np.asarray(x_lens)[:, None]
    py = np.arange(t_y)[None, :] < np.asarray(y_lens)[:, None]
    return px[:, :, None] & py[:, None, :]


def _check(value, mask):
    ref = np.asarray(_jax_mas(jnp.asarray(value), jnp.asarray(mask)))
    out = maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    return out


def _soft(rs, b, t_x, t_y, scale):
    """exp(log_softmax(-5e-4 * squared distance)) over phonemes, as the
    aligner makes it: at large distances most cells are exactly 0."""
    q = rs.randn(b, t_y, 4) * scale
    k = rs.randn(b, t_x, 4) * scale
    dist = ((q[:, :, None, :] - k[:, None, :, :]) ** 2).sum(-1)
    e = (-5e-4 * dist).astype(np.float32)
    e = e - e.max(-1, keepdims=True)
    soft = np.exp(e) / np.exp(e).sum(-1, keepdims=True)
    return soft.transpose(0, 2, 1).astype(np.float32)  # (b, t_x, t_y)


CASES = {
    "random": lambda rs, b, t_x, t_y: rs.randn(b, t_x, t_y).astype(np.float32),
    "small_ints": lambda rs, b, t_x, t_y: rs.randint(0, 3, (b, t_x, t_y)).astype(np.float32),
    "zeros": lambda rs, b, t_x, t_y: np.zeros((b, t_x, t_y), np.float32),
    "soft_underflow": lambda rs, b, t_x, t_y: _soft(rs, b, t_x, t_y, 300.0),
    "soft_near_uniform": lambda rs, b, t_x, t_y: _soft(rs, b, t_x, t_y, 3.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paths_equal_jax(case):
    rs = np.random.RandomState(sorted(CASES).index(case))
    b, t_x, t_y = 4, 12, 40
    value = CASES[case](rs, b, t_x, t_y)
    x_lens, y_lens = [12, 7, 1, 10], [40, 23, 5, 31]
    path = _check(value, _masks(x_lens, y_lens, t_x, t_y))
    durations = path.sum(-1)
    # one phoneme per frame inside the lengths, every real phoneme speaks
    np.testing.assert_array_equal(durations.sum(-1), y_lens)
    for row, n in enumerate(x_lens):
        assert (durations[row, :n] >= 1).all() and (durations[row, n:] == 0).all()


def test_more_phonemes_than_frames_matches_jax():
    rs = np.random.RandomState(7)
    value = rs.randn(2, 9, 6).astype(np.float32)
    _check(value, _masks([9, 4], [6, 6], 9, 6))
