"""Natural-neighbour (Sibson) interpolation on scattered 3-D fields.

Port of ``genie_tpu/ops/interp.py``. The reference's ``NNInterp``
(process_utils.py:1543-1629) estimates, for each query point, the Voronoi
volume the query would steal from each reference node if inserted: it
samples a local cube grid around the query, keeps the sample points nearer
to the query than to any reference node, and weights each reference node by
how many of those stolen points it owns. That reduces to the mean of
``vals[nearest node]`` over the stolen sample points, computed here with one
nearest-node search per chunk of queries. Distances take the
``|a|²+|b|²-2ab`` form of ``ops.knn.pairwise_sq_dist``, as in the JAX
package, so coordinates should be centred near the origin: in float32 that
form cannot order nodes at 1e7 m.
"""

from __future__ import annotations

import numpy as np
import torch

from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.ops.knn import pairwise_sq_dist


def _nearest(ref_pos, pts):
    """Nearest reference node per point: (idx (n,), dist (n,))."""
    d2 = pairwise_sq_dist(pts, ref_pos)
    idx = torch.argmin(d2, dim=1)                   # the first of equal minima
    return idx, torch.sqrt(torch.gather(d2, 1, idx[:, None])[:, 0])


def make_offset_cube(n_res: int, dx: float):
    """(n_res³, 3) cube of sample offsets centred on the query."""
    x1 = np.linspace(0.0, n_res * dx, n_res) - n_res * dx / 2.0
    a, b, c = np.meshgrid(x1, x1, x1, indexing="ij")
    return np.stack((a.reshape(-1), b.reshape(-1), c.reshape(-1)), axis=1)


def default_dx(ref_pos, n_res: int = 11, sample: int = 1000, seed: int = 0):
    """The reference's heuristic sample spacing (process_utils.py:1566-1568):
    80th percentile of the mean 4-NN distance over a random node subset
    (drawn from ``np.random.default_rng(seed)``), divided by ``n_res``.
    Runs on the CPU in float32."""
    ref = ref_pos.cpu().numpy() if torch.is_tensor(ref_pos) else np.asarray(ref_pos)
    rng = np.random.default_rng(seed)
    q = ref[rng.integers(0, len(ref), min(sample, len(ref)))]
    d2 = pairwise_sq_dist(torch.as_tensor(q, dtype=torch.float32),
                          torch.as_tensor(ref, dtype=torch.float32)).numpy()
    k = min(5, d2.shape[1])
    d = np.sqrt(np.sort(d2, axis=1)[:, 1:k])  # drop self/zero column
    if d.shape[1] == 0:
        d = np.sqrt(np.sort(d2, axis=1)[:, :1])
    return float(np.quantile(d.mean(1), 0.8) / n_res)


def natural_neighbor_interp(ref_pos, vals, x_query, n_res: int = 11,
                            dx: float | None = None, query_chunk: int = 512,
                            device=None):
    """Sibson-weighted interpolation of ``vals`` (n_ref,) or (n_ref, C)
    defined on ``ref_pos`` (n_ref, 3), evaluated at ``x_query`` (n_q, 3) on
    ``device`` (default ``cuda``). Returns (n_q,) or (n_q, C) there.

    A query whose sampled cell steals no point (far outside the node cloud at
    this ``dx``) takes its nearest node's value. Queries go in chunks of
    ``query_chunk``, so the (chunk·n_res³, n_ref) distance matrix stays
    bounded."""
    dev = resolve_device(device)
    if dx is None:
        dx = default_dx(ref_pos, n_res)
    ref_pos = torch.as_tensor(ref_pos, dtype=torch.float32, device=dev)
    vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[:, None]
    x_query = torch.as_tensor(x_query, dtype=torch.float32, device=dev)
    xx = torch.as_tensor(make_offset_cube(n_res, dx), dtype=torch.float32, device=dev)
    g = xx.shape[0]
    d_center = torch.linalg.norm(xx, dim=1)[None]    # distance to the query centre

    def chunk(xq):
        nq = xq.shape[0]
        pts = (xq[:, None, :] + xx[None]).reshape(nq * g, 3)
        nearest, d_ref = _nearest(ref_pos, pts)       # nearest reference node
        nearest = nearest.reshape(nq, g)
        stolen = d_center <= d_ref.reshape(nq, g)     # would-be cell of the query
        v = vals[nearest]                             # (nq, G, C)
        w = stolen[..., None].to(v.dtype)
        est = (v * w).sum(1) / torch.clamp_min(w.sum(1), 1e-12)
        nn_q, _ = _nearest(ref_pos, xq)
        return torch.where(stolen.any(1)[:, None], est, vals[nn_q])

    out = torch.cat([chunk(x_query[s:s + query_chunk])
                     for s in range(0, x_query.shape[0], query_chunk)])
    return out[:, 0] if squeeze else out
