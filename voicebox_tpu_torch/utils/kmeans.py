"""k-means for building the semantic-token vocabulary.

Counterpart of `voicebox_tpu/utils/kmeans.py`: nearest-centroid assignment
(`kmeans_assign`), k-means++ seeding (`kmeanspp_init`) and Lloyd's
iterations (`lloyd`), which `fit_kmeans` chains. The seeding is separate so
that Lloyd's can start from any initial centres (the tests start it from
the JAX package's).

Kept from the JAX package, because each moves an argmin on a near tie:
squared distances in the expanded form `|x|^2 + |c|^2 - 2 x c^T` (one
matmul), argmin taking the first of equal distances, and the centroid
update as a one-hot (k, n) @ (n, d) product. An empty cluster keeps its
centre. Everything runs in fp32 on x's device; draws come from `generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["fit_kmeans", "kmeans_assign", "kmeanspp_init", "lloyd", "sq_dists"]


def sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) squared euclidean distances, expanded form."""
    xx = (x * x).sum(dim=-1, keepdim=True)
    cc = (c * c).sum(dim=-1)[None, :]
    return xx + cc - 2.0 * (x @ c.t())


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids (n,), the quantiser used at inference."""
    return sq_dists(x, centroids).argmin(dim=-1)


def kmeanspp_init(x: torch.Tensor, k: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """k-means++ seeding (Arthur and Vassilvitskii 2007): the first centre
    uniformly, each next one with probability proportional to its squared
    distance from the chosen set. (k, d)."""
    x = x.float()
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=generator, device=x.device))
    centres = [x[first]]
    d2 = ((x - x[first]) ** 2).sum(dim=-1)
    for _ in range(k - 1):
        p = d2 / d2.sum().clamp_min(1e-12)
        idx = torch.multinomial(p, 1, generator=generator)[0]
        centres.append(x[idx])
        d2 = torch.minimum(d2, ((x - x[idx]) ** 2).sum(dim=-1))
    return torch.stack(centres)


def lloyd(x: torch.Tensor, init: torch.Tensor, iters: int = 50) -> Tuple[torch.Tensor,
                                                                       torch.Tensor]:
    """`iters` Lloyd's iterations from `init`: (centroids (k, d), inertia),
    the inertia being the mean squared distance of the last assignment."""
    x = x.float()
    c = init.float()
    k = c.shape[0]
    inertia = torch.zeros((), device=x.device)
    for _ in range(iters):
        d2 = sq_dists(x, c)
        onehot = F.one_hot(d2.argmin(dim=-1), k).float()
        counts = onehot.sum(dim=0)[:, None]
        sums = onehot.t() @ x
        c = torch.where(counts > 0, sums / counts.clamp_min(1.0), c)
        inertia = d2.min(dim=-1).values.sum()
    return c, inertia / x.shape[0]


def fit_kmeans(x: torch.Tensor, k: int, iters: int = 50,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor,
                                                                     torch.Tensor]:
    """k-means++ seeding, then Lloyd's: (centroids (k, d) fp32, inertia)."""
    return lloyd(x, kmeanspp_init(x, k, generator), iters)
