"""The port's `utils/metrics.py` against the JAX package's, on the CPU in
float32, on seeded noise-plus-tone waves:

* `log_mel` of a 1-D and of a batched wave, at two lengths, at atol 1e-2
  dB (the tolerance tests/test_torch_stft.py holds `amplitude_to_db` to);
* `mel_spectral_distance` of batched waves, of 1-D waves and of waves of
  unequal lengths (truncated to the shorter) at rtol 1e-4: a mean over
  frames of L2 norms of 100 dB differences, each within the dB tolerance,
  so the mean moves by far less than 1e-4 of itself;
* the distance of a wave to itself is exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.utils import metrics as jmetrics
from voicebox_tpu_torch.utils import metrics as tmetrics

DB_ATOL = 1e-2
MSD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wave(n, b=None, seed=0):
    rs = np.random.RandomState(seed)
    shape = (n,) if b is None else (b, n)
    t = np.arange(n) / 24000.0
    tone = np.sin(2 * np.pi * rs.uniform(100, 4000, shape[:-1] + (1,)) * t)
    return (0.5 * tone + 0.1 * rs.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("n", [4800, 7001])
@pytest.mark.parametrize("b", [None, 3], ids=["1d", "batched"])
def test_log_mel_matches_jax(b, n):
    wave = _wave(n, b, seed=n)
    ref = np.asarray(jmetrics.log_mel(jnp.asarray(wave)))
    out = tmetrics.log_mel(torch.from_numpy(wave)).numpy()
    assert out.shape == ref.shape == (b or 1, 100, n // 160 + 1)
    np.testing.assert_allclose(out, ref, atol=DB_ATOL, rtol=0)


@pytest.mark.parametrize("na,nb,b", [(4800, 4800, 2), (4800, 6400, 2), (7001, 5000, None)],
                         ids=["batched", "unequal", "1d_unequal"])
def test_mel_spectral_distance_matches_jax(na, nb, b):
    wa, wb = _wave(na, b, seed=1), _wave(nb, b, seed=2)
    ref = float(jmetrics.mel_spectral_distance(jnp.asarray(wa), jnp.asarray(wb)))
    out = tmetrics.mel_spectral_distance(torch.from_numpy(wa), torch.from_numpy(wb))
    assert out.dim() == 0 and ref > 1.0
    assert abs(float(out) - ref) <= MSD_RTOL * ref, (float(out), ref)


def test_distance_to_itself_is_zero():
    wave = torch.from_numpy(_wave(4800, 2, seed=3))
    assert float(tmetrics.mel_spectral_distance(wave, wave)) == 0.0
    assert float(tmetrics.mel_spectral_distance(wave[0], wave[0])) == 0.0
