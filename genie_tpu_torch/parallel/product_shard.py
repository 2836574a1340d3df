"""Source-partitioned product-graph parallelism.

Port of ``genie_tpu/parallel/product_shard.py``. At about 1,000 stations ×
100k-1M source nodes the dense ``(n_src, n_sta, C)`` product tensor no
longer fits one device, so the source axis is partitioned over the ranks of
a :class:`~genie_tpu_torch.parallel.mesh.Mesh`:

* the station-axis aggregation is local (each rank holds complete station
  rows for its sources), and runs inside the fused-round kernel;
* the source-axis aggregation needs neighbour source rows that may live on
  other ranks. The source kNN graph is static per grid, so the halo is
  planned on the host: for every ordered rank pair (i → j) the exact rows i
  sends to j. At run time the halos are exchanged, then the aggregation is
  a local fixed-k gather over ``[local ‖ halo]`` rows.

Sources are ordered along a Morton (z-curve) code of their positions, so
kNN neighbours are mostly on the same rank and the halo is a thin boundary
layer concentrated at adjacent ranks. The exchange runs one round of
``batch_isend_irecv`` per active circular rank offset d (rank i sends to
``(i + d) % n`` and receives from ``(i - d) % n``), each padded only to that
offset's largest pair, as the JAX package runs one ``ppermute`` per offset.

The host plans (:func:`build_partition`, :func:`build_station_subselection`)
are numpy copies of the JAX package's and return the same integers and
flags as CPU torch tensors (``int32`` and ``bool``). The aggregations take
this rank's rows ``(…, n_local, n_sta, C)`` with any leading axes (the
port's window axis ``B``), the source axis third from last.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genie_tpu_torch.parallel.mesh import Mesh, all_gather_cat, exchange


class SrcPartition(NamedTuple):
    n_shards: int
    n_local: int
    halo_total: int          # Σ_d H_d: halo rows per rank
    offsets: tuple           # circular rank offsets d with traffic
    halo_base: tuple         # halo block base per offset (same order)
    perm: torch.Tensor       # (n_src,) int32: sorted row → original row
    inv_perm: torch.Tensor   # (n_src,) int32
    off_send_idx: tuple      # per offset: (n_shards, H_d) int32 sender-local
                             #   rows rank i sends to (i + d) % n_shards
    off_send_valid: tuple    # per offset: (n_shards, H_d) bool (statistics)
    local_nbr: torch.Tensor  # (n_shards, n_local, k) int32 neighbours in the
                             #   local frame: [0, n_local) local rows,
                             #   n_local + halo_base[di] + h = halo row h of
                             #   offset block di
    nbr_valid: torch.Tensor  # (n_shards, n_local, k) bool

    @property
    def halo_rows_valid(self) -> int:
        """Halo rows exchanged (all ranks, no padding)."""
        return int(sum(int(v.sum()) for v in self.off_send_valid))

    @property
    def halo_rows_moved(self) -> int:
        """Halo rows moved, padding included (all ranks)."""
        return self.n_shards * self.halo_total

    def local_rows(self, rank: int) -> torch.Tensor:
        """Original-frame rows of ``rank``'s sources, in sorted order."""
        return self.perm[rank * self.n_local:(rank + 1) * self.n_local]

    def to(self, device) -> "SrcPartition":
        """The plan with its tensors on ``device``."""
        return self._replace(
            perm=self.perm.to(device), inv_perm=self.inv_perm.to(device),
            off_send_idx=tuple(t.to(device) for t in self.off_send_idx),
            off_send_valid=tuple(t.to(device) for t in self.off_send_valid),
            local_nbr=self.local_nbr.to(device), nbr_valid=self.nbr_valid.to(device))


def _morton_order(pos):
    """Sort positions along a z-curve for spatial locality."""
    p = np.asarray(pos, np.float64)
    # isotropic quantization: one metre-per-level scale for all axes. Per-axis
    # normalization would stretch a thin axis (seismicity depth: tens of km vs
    # hundreds horizontally) to full resolution, interleaving its bits at fine
    # granularity and destroying horizontal locality.
    q = ((p - p.min(0)) / max(float(np.ptp(p, 0).max()), 1e-9) * 1023).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_partition(src_pos, src_nbr, n_shards: int) -> SrcPartition:
    """Host-side construction of the static halo-exchange plan (numpy or
    tensor inputs; the plan's tensors are on the CPU, see
    :meth:`SrcPartition.to`)."""
    src_nbr = _np(src_nbr)
    n_src, k = src_nbr.shape
    if n_src % n_shards:
        raise ValueError(f"build_partition: {n_src} sources do not divide into "
                         f"{n_shards} shards; pad the grid (pad_to_shards)")
    n_local = n_src // n_shards
    perm = _morton_order(_np(src_pos))
    inv_perm = np.argsort(perm)

    # neighbours in sorted frame
    nbr_sorted = inv_perm[src_nbr[perm]]                 # (n_src, k)
    owner = np.arange(n_src) // n_local                  # shard of each sorted row

    send: dict[tuple[int, int], list[int]] = {}
    for j in range(n_shards):
        rows = nbr_sorted[j * n_local:(j + 1) * n_local]
        for i in np.unique(owner[rows.reshape(-1)]):
            if i == j:
                continue
            need = np.unique(rows.reshape(-1)[owner[rows.reshape(-1)] == i])
            send[(int(i), int(j))] = sorted(need.tolist())

    # group pairs by circular shard offset d = (j - i) mod n: Morton locality
    # makes small offsets carry nearly all rows, so padding each offset to
    # its own max pair size moves far fewer bytes than one global pad
    offsets = sorted({(j - i) % n_shards for (i, j) in send})
    H_d = {d: max((len(rows) for (i, j), rows in send.items()
                   if (j - i) % n_shards == d), default=1)
           for d in offsets}
    halo_base, acc = {}, 0
    for d in offsets:
        halo_base[d] = acc
        acc += H_d[d]
    halo_total = acc

    off_send_idx = {d: np.zeros((n_shards, H_d[d]), np.int32) for d in offsets}
    off_send_valid = {d: np.zeros((n_shards, H_d[d]), bool) for d in offsets}
    recv_pos: dict[tuple[int, int], dict[int, int]] = {}
    for (i, j), rows in send.items():
        d = (j - i) % n_shards
        off_send_idx[d][i, :len(rows)] = np.asarray(rows) - i * n_local
        off_send_valid[d][i, :len(rows)] = True
        recv_pos[(i, j)] = {r: h for h, r in enumerate(rows)}

    # local-frame neighbour table per shard: halo row for sorted-global id g
    # owned by shard p, received by j via offset d = (j-p) mod n, sits at
    # n_local + halo_base[d] + h (the receiver's halo concatenates the
    # per-offset blocks in `offsets` order)
    local_nbr = np.zeros((n_shards, n_local, k), np.int32)
    nbr_valid = np.ones((n_shards, n_local, k), bool)
    for j in range(n_shards):
        rows = nbr_sorted[j * n_local:(j + 1) * n_local]
        out = np.zeros_like(rows)
        for a in range(n_local):
            for b in range(k):
                g = rows[a, b]
                p = owner[g]
                if p == j:
                    out[a, b] = g - j * n_local
                else:
                    d = (j - p) % n_shards
                    h = recv_pos[(int(p), j)][int(g)]
                    out[a, b] = n_local + halo_base[d] + h
        local_nbr[j] = out

    return SrcPartition(
        n_shards=n_shards, n_local=n_local, halo_total=halo_total,
        offsets=tuple(offsets),
        halo_base=tuple(halo_base[d] for d in offsets),
        perm=torch.from_numpy(perm.astype(np.int32)),
        inv_perm=torch.from_numpy(inv_perm.astype(np.int32)),
        off_send_idx=tuple(torch.from_numpy(off_send_idx[d]) for d in offsets),
        off_send_valid=tuple(torch.from_numpy(off_send_valid[d]) for d in offsets),
        local_nbr=torch.from_numpy(local_nbr), nbr_valid=torch.from_numpy(nbr_valid),
    )


def halo_exchange(x_local, part: SrcPartition, mesh: Mesh, remap_block=None,
                  wire_dtype=None):
    """Exchange halo rows: one round of ``batch_isend_irecv`` per active
    circular offset, each padded only to that offset's largest pair.

    x_local: (…, n_local, n_sta, C) this rank's rows (sorted frame).
    remap_block: optional ``(block, offset_index) -> block`` applied to each
    received offset block (the station-frame remap of the distributed
    subgraph) before concatenation.
    wire_dtype: rows cross the wire in this dtype (``torch.bfloat16`` halves
    the bytes) and are cast back to ``x_local.dtype`` on arrival; the halo
    rows only feed fixed-k means, so the rounding is bounded at about three
    decimal digits per contribution.
    Returns (…, halo_total, n_sta, C): the per-offset blocks in
    ``part.offsets`` order (the ``local_nbr`` halo layout)."""
    n, rank = part.n_shards, mesh.rank
    if mesh.size != n:
        raise ValueError(f"halo_exchange: plan for {n} shards, group of {mesh.size}")
    blocks = []
    for di, (d, si) in enumerate(zip(part.offsets, part.off_send_idx)):
        send = x_local.index_select(-3, si[rank].to(x_local.device, torch.long))
        if wire_dtype is not None:
            send = send.to(wire_dtype)
        recv = exchange(send, mesh, dst=(rank + d) % n, src=(rank - d) % n)
        if wire_dtype is not None:
            recv = recv.to(x_local.dtype)
        if remap_block is not None:
            recv = remap_block(recv, di)
        blocks.append(recv)
    if not blocks:
        return x_local.new_zeros((*x_local.shape[:-3], 0, *x_local.shape[-2:]))
    return torch.cat(blocks, dim=-3)


def _gather_mean(x_ext, nbr):
    """``mean_k x_ext[…, nbr[:, k], :, :]`` over the k slots, one
    (…, n_local, n_sta, C) gather at a time (the k-wide gather at once would
    hold k product tensors)."""
    nbr = nbr.to(x_ext.device, torch.long)
    acc = x_ext.index_select(-3, nbr[:, 0])
    for j in range(1, nbr.shape[1]):
        acc += x_ext.index_select(-3, nbr[:, j])
    return acc / nbr.shape[1]


def sharded_gather_mean_src_axis(x_local, part: SrcPartition, mesh: Mesh,
                                 wire_dtype=None):
    """Source-axis fixed-k mean under source partitioning: this rank's rows
    (…, n_local, n_sta, C) → their means, equal to ``gather_mean_src_axis``
    on the unsharded sorted tensor (to rounding of the k-term sum; to bf16
    rounding of the halo contributions with ``wire_dtype=torch.bfloat16``)."""
    halo = halo_exchange(x_local, part, mesh, wire_dtype=wire_dtype)
    x_ext = torch.cat((x_local, halo), dim=-3)
    return _gather_mean(x_ext, part.local_nbr[mesh.rank])


class StaSubsel(NamedTuple):
    """Per-shard station sub-selection (the distributed subgraph; the
    reference's ``use_subgraph``): each source shard only materializes the
    stations its local sources pair with, so the product tensor is
    (n_local, n_sel+1, C) instead of (n_local, n_sta, C). Row ``n_sel`` of
    every per-shard station axis is a reserved all-zero sentinel; out-of-subset
    station references point at it.

    ``col_map`` remaps halo source rows between shard station frames: the
    receiver's column r (global station sta_sel[recv, r]) reads the sender's
    column ``col_map[recv, send, r]`` (the sentinel when the sender does not
    carry that station).

    Under sub-selection, station-axis means run over the carried valid
    neighbours only (``sta_nbr_valid`` drops out-of-union neighbours from
    numerator and denominator); source-axis means keep the fixed k
    denominator with zero contribution for stations a sender shard does not
    carry (the caller zeroes the sentinel column). With an all-True pair mask
    both reduce exactly to the dense computation."""

    n_sel: int                   # station budget per shard (largest subset)
    sta_sel: torch.Tensor        # (n_shards, n_sel) int32 global station ids
    sel_valid: torch.Tensor      # (n_shards, n_sel) bool (False = padding)
    sta_nbr: torch.Tensor        # (n_shards, n_sel+1, k) int32 local-frame neighbours
    sta_nbr_valid: torch.Tensor  # (n_shards, n_sel+1, k) bool
    col_map: torch.Tensor        # (n_shards_recv, n_shards_send, n_sel+1) int32


def build_station_subselection(a_src_in_sta, part: SrcPartition,
                               sta_nbr, sta_nbr_valid) -> StaSubsel:
    """Host-side plan: per-shard station subsets from the ε+kNN pair mask
    (``graphs.subgraph.pair_mask``, (n_src, n_sta) in the original frame),
    the remapped neighbour tables and the inter-shard column maps."""
    mask = _np(a_src_in_sta)[_np(part.perm)]              # sorted frame
    n_shards, n_local = part.n_shards, part.n_local
    n_sta = mask.shape[1]
    blocks = mask.reshape(n_shards, n_local, n_sta)
    subsets = [np.where(b.any(axis=0))[0] for b in blocks]
    n_sel = max(max((len(s) for s in subsets), default=1), 1)

    sta_sel = np.zeros((n_shards, n_sel), np.int32)
    sel_valid = np.zeros((n_shards, n_sel), bool)
    g2l = np.full((n_shards, n_sta), n_sel, np.int32)     # sentinel default
    for j, s in enumerate(subsets):
        sta_sel[j, :len(s)] = s
        sel_valid[j, :len(s)] = True
        g2l[j, s] = np.arange(len(s))

    nbr = _np(sta_nbr)
    nv = _np(sta_nbr_valid)
    k = nbr.shape[1]
    # local neighbour tables: out-of-union neighbours are dropped from both
    # numerator and denominator; with an all-True pair mask this is exactly
    # the original table
    sta_nbr_l = np.full((n_shards, n_sel + 1, k), n_sel, np.int32)
    sta_nbr_valid_l = np.zeros((n_shards, n_sel + 1, k), bool)
    for j in range(n_shards):
        loc = g2l[j][nbr[sta_sel[j]]]
        sta_nbr_l[j, :n_sel] = loc
        sta_nbr_valid_l[j, :n_sel] = (nv[sta_sel[j]] & sel_valid[j][:, None]
                                      & (loc < n_sel))
    # padded rows keep all-False validity: their outputs are never gathered
    # and are masked downstream

    col_map = np.full((n_shards, n_shards, n_sel + 1), n_sel, np.int32)
    for r in range(n_shards):
        for s in range(n_shards):
            col_map[r, s, :n_sel] = g2l[s][sta_sel[r]]
            col_map[r, s, :n_sel][~sel_valid[r]] = n_sel

    return StaSubsel(
        n_sel=n_sel, sta_sel=torch.from_numpy(sta_sel),
        sel_valid=torch.from_numpy(sel_valid),
        sta_nbr=torch.from_numpy(sta_nbr_l),
        sta_nbr_valid=torch.from_numpy(sta_nbr_valid_l),
        col_map=torch.from_numpy(col_map),
    )


def sharded_gather_mean_src_axis_subsel(x_local, part: SrcPartition,
                                        col_map_local, mesh: Mesh):
    """Source-axis mean under source partitioning and per-shard station
    sub-selection: halo rows arrive in their sender's station frame and are
    remapped to this rank's through ``col_map_local`` (n_shards_send,
    n_sel+1); the sentinel zero column absorbs stations the sender does not
    carry. x_local (…, n_local, n_sel+1, C)."""
    n = part.n_shards
    col_map_local = col_map_local.to(x_local.device, torch.long)

    def remap(block, di):
        # the offset-d block comes from (rank - d) mod n; take its station
        # columns in this rank's frame
        sender = (mesh.rank - part.offsets[di]) % n
        return block.index_select(-2, col_map_local[sender])

    halo = halo_exchange(x_local, part, mesh, remap_block=remap)
    x_ext = torch.cat((x_local, halo), dim=-3)
    return _gather_mean(x_ext, part.local_nbr[mesh.rank])


def sharded_src_aggregation(x_local, part: SrcPartition, mesh: Mesh,
                            wire_dtype=None):
    """The sharded source-axis aggregation of this rank's rows (…, n_local,
    n_sta, C), all-gathered: every rank returns the whole (…, n_src, n_sta,
    C) result in the sorted frame, as the JAX ``sharded_src_aggregation``
    returns its global array."""
    out = sharded_gather_mean_src_axis(x_local, part, mesh, wire_dtype=wire_dtype)
    return all_gather_cat(out, mesh, dim=-3)
