"""The port's k-means (`voicebox_tpu_torch/utils/kmeans.py`) against the JAX
package's on the CPU: assignments equal, Lloyd's iterations from the JAX
package's own k-means++ seeding at atol 2e-4 (centroids and inertia), an
empty cluster keeping its centre, and the port's own seeding and fit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.utils import kmeans as jk
from voicebox_tpu_torch.utils.kmeans import (fit_kmeans, kmeans_assign, kmeanspp_init, lloyd,
                                             sq_dists)

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(seed=0, k=5, per=40, d=6, spread=0.3):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d).astype(np.float32) * 3
    x = np.concatenate([c + spread * rs.randn(per, d).astype(np.float32) for c in centers])
    return x[rs.permutation(len(x))], centers


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_matches_jax(seed):
    x, _ = _blobs(seed)
    c = np.random.RandomState(seed + 10).randn(7, x.shape[1]).astype(np.float32)
    ref = np.asarray(jk.kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    ours = kmeans_assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
                               np.asarray(jk._sq_dists(jnp.asarray(x), jnp.asarray(c))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,iters", [(5, 10), (8, 25)])
def test_lloyd_from_jax_init_matches_jax(k, iters):
    x, _ = _blobs(3)
    rng = jax.random.PRNGKey(7)
    init = np.array(jk._kmeanspp_init(rng, jnp.asarray(x), k))
    ref_c, ref_inertia = jk.fit_kmeans(rng, jnp.asarray(x), k, iters=iters)
    c, inertia = lloyd(torch.from_numpy(x), torch.from_numpy(init), iters)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(inertia), float(ref_inertia), atol=ATOL, rtol=1e-5)


def test_empty_cluster_keeps_its_centre():
    x, _ = _blobs(4, k=2)
    far = np.full((1, x.shape[1]), 1e3, np.float32)  # nearest to no point
    init = np.concatenate([x[:2], far])
    c, _ = lloyd(torch.from_numpy(x), torch.from_numpy(init), 5)
    np.testing.assert_array_equal(c[2].numpy(), far[0])
    assert np.isfinite(c.numpy()).all()


def test_seeding_and_fit_recover_blobs():
    x, centers = _blobs(5, k=4, per=60, spread=0.1)
    gen = torch.Generator().manual_seed(0)
    init = kmeanspp_init(torch.from_numpy(x), 4, gen)
    assert init.shape == (4, x.shape[1])
    assert len({tuple(r) for r in init.numpy().round(4)}) == 4  # distinct points of x
    c, inertia = fit_kmeans(torch.from_numpy(x), 4, iters=20,
                            generator=torch.Generator().manual_seed(1))
    err = np.abs(c.numpy()[:, None] - centers[None]).sum(-1).min(axis=0)
    assert (err < 0.2 * x.shape[1]).all(), err
    assert float(inertia) < 0.1
    again, _ = fit_kmeans(torch.from_numpy(x), 4, iters=20,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(c, again)  # deterministic given the generator
