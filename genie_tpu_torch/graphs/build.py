"""Graph construction: k-means-packed source grids, kNN tables, time
pointers, pick pairs, edge features.

Port of ``genie_tpu/graphs/build.py``. Tables are torch tensors on the
device of their inputs. ``torch.topk`` may order equal keys differently
from ``jax.lax.top_k``, so tables agree with the JAX package as sets; every
consumer is invariant to the order within a row.

The k-means packing family (:54-226) draws from a ``torch.Generator``, so
its nodes differ from the JAX package's (which draws from a JAX key) but
not in distribution. Each variant is a draw (``*_draws``: the initial
nodes and every Lloyd batch, ``(n_steps, n_batch, 3)``, in one go on the
generator's device) followed by the deterministic
:func:`kmeans_from_draws`, so a test can feed JAX's draws to the steps.
"""

from __future__ import annotations

import numpy as np
import torch

from genie_tpu_torch.ops.knn import knn, knn_graph
from genie_tpu_torch.ops.segment import segment_mean


def kmeans_step(v, x, to_cart, weight, lr: float):
    """One stochastic Lloyd step: every node moves ``lr`` of the way to the
    mean of the samples ``x`` nearest to it (in ``weight``-scaled Cartesian
    coordinates); nodes without samples stay."""
    idx, _ = knn(to_cart(v) * weight, to_cart(x) * weight, 1)
    ip = idx[:, 0].long()
    return v + lr * segment_mean(x - v[ip], ip, v.shape[0])


def kmeans_packing(generator, scale_x, offset_x, n_clusters: int, to_cart,
                   weight=None, n_batch: int = 3000, n_steps: int = 1000,
                   lr: float = 0.01):
    """Pack ``n_clusters`` nodes quasi-uniformly over the box ``offset_x +
    [0, scale_x]`` by stochastic Lloyd iterations on the generator's device;
    ``weight`` re-weights the Cartesian axes (depth importance)."""
    dev = generator.device
    scale_x = torch.as_tensor(np.asarray(scale_x, np.float32), device=dev).reshape(1, -1)
    offset_x = torch.as_tensor(np.asarray(offset_x, np.float32), device=dev).reshape(1, -1)
    w = (torch.ones((1, 3), device=dev) if weight is None else
         torch.as_tensor(np.asarray(weight, np.float32), device=dev).reshape(1, -1))

    def uniform(n):
        return torch.rand((n, 3), generator=generator, device=dev) * scale_x + offset_x

    v = uniform(n_clusters)
    for _ in range(n_steps):
        v = kmeans_step(v, uniform(n_batch), to_cart, w, lr)
    return v


def kmeans_from_draws(v, xs, to_cart, weight, lr: float = 0.01):
    """The Lloyd iterations of a packing: one :func:`kmeans_step` per batch
    of ``xs`` (``(n_steps, n_batch, 3)``), from the nodes ``v``."""
    for x in xs:
        v = kmeans_step(v, x, to_cart, weight, lr)
    return v


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _uniform(generator, lead, scale_x, offset_x):
    return (torch.rand((*lead, 3), generator=generator, device=generator.device)
            * scale_x + offset_x)


def kmeans_packing_fit_sources_draws(generator, ref_sources_cart, scale_x, offset_x,
                                     n_clusters: int, to_cart, blur: float = 15e3,
                                     frac_reference: float = 0.5, n_batch: int = 3000,
                                     n_steps: int = 1000):
    """Draws of :func:`kmeans_packing_fit_sources`: each set mixes
    ``frac_reference`` Gaussian-blurred (σ ``blur``) reference sources with
    uniform box draws projected by ``to_cart``. Returns (v0, xs), Cartesian."""
    dev = generator.device
    ref = _f32(ref_sources_cart, dev)
    scale_x, offset_x = _f32(scale_x, dev), _f32(offset_x, dev)

    def sample(lead, n):
        n_ref = int(frac_reference * n)
        idx = torch.randint(0, ref.shape[0], (*lead, n_ref), generator=generator,
                            device=dev)
        pts_ref = ref[idx] + blur * torch.randn((*lead, n_ref, 3), generator=generator,
                                                device=dev)
        pts_uni = _uniform(generator, (*lead, n - n_ref), scale_x, offset_x)
        return torch.cat((pts_ref, to_cart(pts_uni)), dim=-2)

    return sample((), n_clusters), sample((n_steps,), n_batch)


def kmeans_packing_fit_sources(generator, ref_sources_cart, scale_x, offset_x,
                               n_clusters: int, to_cart, blur: float = 15e3,
                               frac_reference: float = 0.5, n_batch: int = 3000,
                               n_steps: int = 1000, lr: float = 0.01):
    """Pack nodes around a reference catalog: Lloyd iterations in Cartesian
    space over a mixture of Gaussian-blurred reference source positions and
    uniform background draws. Returns (n_clusters, 3) Cartesian nodes."""
    v, xs = kmeans_packing_fit_sources_draws(generator, ref_sources_cart, scale_x,
                                             offset_x, n_clusters, to_cart, blur,
                                             frac_reference, n_batch, n_steps)
    return kmeans_from_draws(v, xs, lambda a: a, 1.0, lr)


def gaussian_kde_sampler(points, bandwidth: float):
    """``sample(generator, n)`` from a Gaussian KDE over ``points`` (n, d):
    a random support point plus N(0, bandwidth), on the generator's
    device (sklearn ``KernelDensity.sample``)."""
    pts = torch.as_tensor(np.asarray(points, np.float32))

    def sample(generator, n: int):
        dev = generator.device
        idx = torch.randint(0, pts.shape[0], (n,), generator=generator, device=dev)
        return pts.to(dev)[idx] + bandwidth * torch.randn(
            (n, pts.shape[1]), generator=generator, device=dev)

    return sample


def kmeans_packing_with_density_draws(generator, density_sample, scale_x, offset_x,
                                      n_clusters: int, frac: float = 0.75,
                                      n_batch: int = 3000, n_steps: int = 1000):
    """Draws of :func:`kmeans_packing_with_density`: the first ``frac`` of
    each set are ``density_sample(generator, n) -> (n, 2)`` lat/lon draws
    with uniform depths, the rest uniform over the box; a density draw
    outside the box falls back to its uniform draw. Returns (v0, xs)."""
    dev = generator.device
    scale_x, offset_x = _f32(scale_x, dev), _f32(offset_x, dev)
    lo, hi = offset_x[:2], offset_x[:2] + scale_x[:2]

    def mixture(lead, n, n_d):
        m = int(np.prod(lead))
        xy = density_sample(generator, m * n_d).reshape(*lead, n_d, 2)
        z = (torch.rand((*lead, n_d, 1), generator=generator, device=dev)
             * scale_x[2] + offset_x[2])
        dense = torch.cat((xy, z), dim=-1)
        uni = _uniform(generator, (*lead, n), scale_x, offset_x)
        ok = ((dense[..., :2] >= lo) & (dense[..., :2] <= hi)).all(-1, keepdim=True)
        return torch.cat((torch.where(ok, dense, uni[..., :n_d, :]), uni[..., n_d:, :]),
                         dim=-2)

    return (mixture((), n_clusters, int(frac * n_clusters)),
            mixture((n_steps,), n_batch, int(frac * n_batch)))


def kmeans_packing_with_density(generator, density_sample, scale_x, offset_x,
                                n_clusters: int, to_cart, weight=None,
                                frac: float = 0.75, n_batch: int = 3000,
                                n_steps: int = 1000, lr: float = 0.01):
    """Density-weighted node packing (the reference's
    ``kmeans_packing_weight_vector_with_density``): Lloyd batches mix
    ``density_sample`` draws with uniform box draws
    (:func:`kmeans_packing_with_density_draws`); ``weight`` re-weights the
    Cartesian axes. Returns (n_clusters, 3) lat/lon/depth nodes."""
    v, xs = kmeans_packing_with_density_draws(generator, density_sample, scale_x,
                                              offset_x, n_clusters, frac, n_batch,
                                              n_steps)
    w = torch.ones(3, device=v.device) if weight is None else _f32(weight, v.device)
    return kmeans_from_draws(v, xs, to_cart, w, lr)


def _fibonacci_lattice(n: int):
    """(n, 3) unit-sphere Fibonacci lattice, float32 numpy."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    golden = 2 * np.pi / ((1 + 5**0.5) / 2)
    th = golden * (np.arange(n) + 0.5)
    return np.stack((np.cos(th) * np.sin(phi), np.sin(th) * np.sin(phi), np.cos(phi)),
                    axis=1).astype(np.float32)


def kmeans_packing_spherical_draws(generator, scale_x, offset_x, n_clusters: int,
                                   n_batch: int = 3000, n_steps: int = 1000,
                                   izero: float = 0.65):
    """Draws of :func:`kmeans_packing_spherical`: each set is a randomly
    rotated Fibonacci lattice mapped to (lat, lon), with depths uniform over
    the range and then, twice, replaced with probability ``izero`` by a
    shallow-biased ``(1 − Beta(1, b))``-scaled depth, b = 3 then 12 (drawn
    as ``U^(1/b)``, which has that law). Returns (v0, xs)."""
    from genie_tpu_torch.geometry import ecef2lla

    dev = generator.device
    scale_z, offset_z = float(np.asarray(scale_x)[2]), float(np.asarray(offset_x)[2])

    def nodes(lead, n):
        base = torch.as_tensor(_fibonacci_lattice(n), device=dev)
        ang = torch.rand((*lead, 3), generator=generator, device=dev) * 2 * np.pi
        c, s = torch.cos(ang), torch.sin(ang)
        one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

        def mat(rows):
            return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

        rx = mat(((one, zero, zero), (zero, c[..., 0], -s[..., 0]),
                  (zero, s[..., 0], c[..., 0])))
        ry = mat(((c[..., 1], zero, s[..., 1]), (zero, one, zero),
                  (-s[..., 1], zero, c[..., 1])))
        rz = mat(((c[..., 2], -s[..., 2], zero), (s[..., 2], c[..., 2], zero),
                  (zero, zero, one)))
        xyz = base @ (rx @ ry @ rz).transpose(-1, -2)
        lla = ecef2lla(xyz, a=1.0, e=0.0)
        z = torch.rand((*lead, n), generator=generator, device=dev) * scale_z + offset_z
        for b in (3.0, 12.0):
            u = torch.rand((*lead, n), generator=generator, device=dev)
            pick = torch.rand((*lead, n), generator=generator, device=dev) < izero
            z = torch.where(pick, u ** (1.0 / b) * scale_z + offset_z, z)
        return torch.cat((lla[..., :2], z[..., None]), dim=-1)

    return nodes((), n_clusters), nodes((n_steps,), n_batch)


def kmeans_packing_spherical(generator, scale_x, offset_x, n_clusters: int,
                             to_cart, weight=(1.0, 1.0, 2.0),
                             n_batch: int = 3000, n_steps: int = 1000,
                             lr: float = 0.01, izero: float = 0.65):
    """Spherical node packing (the reference's ``kmeans_packing_spherical``):
    Lloyd batches are randomly rotated Fibonacci lattices on the unit sphere
    mapped to lat/lon, with depths biased toward the surface
    (:func:`kmeans_packing_spherical_draws`). Returns (n_clusters, 3)."""
    v, xs = kmeans_packing_spherical_draws(generator, scale_x, offset_x, n_clusters,
                                           n_batch, n_steps, izero)
    return kmeans_from_draws(v, xs, to_cart, _f32(weight, v.device), lr)


def fibonacci_sphere_packing(n: int, radius: float = 6371e3):
    """Fibonacci-lattice points on a sphere (the reference's spherical
    packing initialization), float64 numpy."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    golden = np.pi * (1 + 5**0.5)
    theta = golden * i
    return np.stack((radius * np.sin(phi) * np.cos(theta),
                     radius * np.sin(phi) * np.sin(theta),
                     radius * np.cos(phi)), axis=1)


def build_station_graph(sta_cart, k: int, sta_mask=None):
    """Station kNN graph (k=8) on km-scaled coordinates."""
    return knn_graph(torch.as_tensor(sta_cart) / 1000.0, k, mask=sta_mask)


def build_source_graph(src_cart, k: int):
    """Source-grid kNN graph (k=15)."""
    nbr, _ = knn_graph(torch.as_tensor(src_cart) / 1000.0, k)
    return nbr


def build_query_attachment(src_cart, x_query_cart, k: int = 10):
    """kNN of query points into the source grid for SpatialAttention.
    ``x_query_cart`` may carry leading batch dimensions."""
    idx, _ = knn(torch.as_tensor(src_cart) / 1000.0,
                 torch.as_tensor(x_query_cart) / 1000.0, k)
    return idx


def _time_ptr_one_phase(trv_phase, dt_partition, k: int):
    d = (trv_phase.T[:, None, :] - dt_partition[None, :, None]).abs()
    return torch.topk(-d, k, dim=-1).indices.to(torch.int32)


def build_time_pointers(trv, dt: float = 1.0, k: int = 10, win: float = 10.0,
                        max_t: float | None = None):
    """Per-(station, time-bin) tables of the k source nodes whose travel time
    is nearest the bin. Returns ``(ptr_p, ptr_s, dt0, dt, n_dt)`` with ptr_*
    of shape (n_sta, n_dt, k) holding source indices."""
    trv = torch.as_tensor(trv)
    if max_t is None:
        max_t = float(trv.max())
    dt_partition = np.arange(-win, win + max_t + dt, dt, dtype=np.float32)
    part = torch.as_tensor(dt_partition, device=trv.device)
    ptr_p = _time_ptr_one_phase(trv[:, :, 0], part, k)
    ptr_s = _time_ptr_one_phase(trv[:, :, 1], part, k)
    return ptr_p, ptr_s, float(dt_partition[0]), float(dt), len(dt_partition)


def build_pair_table(tpick, ipick, pick_mask, k_pair: int = 16):
    """For every pick the ``k_pair`` nearest-in-time picks at the same
    station (self first), plus a trailing null slot. Arrays may carry a
    leading window axis. Returns ``(pair_idx (..., n_pick, k_pair+1),
    pair_valid)``; index n_pick is the null arrival."""
    n_pick = tpick.shape[-1]
    same_sta = ipick[..., :, None] == ipick[..., None, :]
    both = pick_mask[..., :, None] & pick_mask[..., None, :]
    d = (tpick[..., :, None] - tpick[..., None, :]).abs()
    d = torch.where(same_sta & both, d, torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, min(k_pair, n_pick), dim=-1)
    valid = torch.isfinite(neg)
    idx = torch.where(valid, idx, torch.full_like(idx, n_pick))
    null_col = torch.full((*idx.shape[:-1], 1), n_pick, dtype=idx.dtype,
                          device=idx.device)
    pair_idx = torch.cat((idx, null_col), dim=-1).to(torch.int32)
    pair_valid = torch.cat((valid, pick_mask[..., None]), dim=-1)
    return pair_idx, pair_valid


def build_edge_feat(src_lla, sta_lla, scale_x_extend):
    """Bipartite read-in/out edge features: (src − sta)/scale in lat/lon/depth
    units, (n_src, n_sta, 3)."""
    src_lla = torch.as_tensor(src_lla)
    sta_lla = torch.as_tensor(sta_lla, device=src_lla.device)
    scale = torch.as_tensor(scale_x_extend, dtype=torch.float32,
                            device=src_lla.device).reshape(1, 1, 3)
    return (src_lla[:, None, :] - sta_lla[None, :, :]) / scale
