"""Measure the sharded trunk's communication share, the twin of
``scripts/measure_scaling.py`` and the companion to ``scaling_model``'s
analytic efficiency.

``--ranks`` processes form one ``torch.distributed`` group (``--backend``)
and time, with CUDA events (the host clock on the CPU), the median of
``--reps`` runs of three programs over one clustered source cloud:
  * the sharded source-axis mean with the halo exchange
    (``product_shard.sharded_gather_mean_src_axis``);
  * the same gathers with the exchange elided (a zero halo): the
    compute-only bound;
  * the dense one-device ``ops.segment.gather_mean_src_axis`` (rank 0).

A sharded program takes as long as its slowest rank, so each sharded time
is the largest of the ranks' medians. The halo rows the static plan
exchanges are exact. With ``gloo`` every rank shares one device (the CPU,
or one card whose halo crosses pinned host memory), so the comm fraction
is a structural overhead (dispatch, staging copies, reshuffle), not a link
measurement; with ``nccl`` each rank has a card of its own and the halo
crosses the links between cards.

    python -m genie_tpu_torch.scripts.measure_scaling [--ranks 8] \\
        [--backend gloo|nccl] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from genie_tpu_torch.scripts import add_device_argument
from genie_tpu_torch.scripts.scaling_model import make_cloud

RANK_TIMEOUT_S = 600

_WORKER = ("import sys; from genie_tpu_torch.scripts.measure_scaling import rank_worker; "
           "rank_worker(*sys.argv[1:])")


def source_graph(n_src: int, k_src: int, device="cpu"):
    """The clustered cloud of ``n_src`` sources drawn from
    ``np.random.default_rng(0)`` (``scaling_model.make_cloud``), its k =
    ``k_src`` source graph built on ``device`` (returned on the CPU)."""
    from genie_tpu_torch.graphs.build import build_source_graph

    rng = np.random.default_rng(0)
    src_pos = make_cloud(n_src, rng)
    src_nbr = build_source_graph(torch.as_tensor(src_pos, device=device), k_src).cpu()
    return src_pos, src_nbr


def partition_stats(n_src: int, k_src: int, n_shards: int, device="cpu") -> dict:
    """The halo rows the static plan exchanges over ``n_shards`` shards (all
    ranks; valid and moved with the per-offset padding), the padding
    overhead and the halo row fraction, for the graph built on ``device``."""
    from genie_tpu_torch.parallel.product_shard import build_partition

    src_pos, src_nbr = source_graph(n_src, k_src, device)
    return _stats(build_partition(src_pos, src_nbr, n_shards), n_src)


def _stats(part, n_src: int) -> dict:
    valid, moved = part.halo_rows_valid, part.halo_rows_moved
    return {"halo_rows_exchanged": valid, "halo_rows_moved_padded": moved,
            "halo_padding_overhead": round(moved / max(valid, 1), 3),
            "halo_row_fraction": round(valid / n_src, 4)}


def _timer(dev):
    """``time(fn) -> ms``: CUDA events on a card, the host clock on the CPU."""
    if dev.type == "cuda":
        def time_ms(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end)
    else:
        def time_ms(fn):
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
    return time_ms


def rank_worker(d, rank, world, port):
    """One rank: join the group, time the three programs (median of
    ``reps`` after one warm-up, a barrier before each run) and write
    ``out_<rank>.pt`` with this rank's sharded output and medians (rank 0
    also the dense output, in the original frame)."""
    import torch.distributed as dist

    from genie_tpu_torch.ops.segment import gather_mean_src_axis
    from genie_tpu_torch.parallel.mesh import make_mesh
    from genie_tpu_torch.parallel.product_shard import (SrcPartition, _gather_mean,
                                                        sharded_gather_mean_src_axis)

    d, rank, world, port = Path(d), int(rank), int(world), int(port)
    a = json.loads((d / "args.json").read_text())
    dev = torch.device(a["device"])
    if a["backend"] == "nccl":
        dev = torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(a["backend"], init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device=dev)
        plan = torch.load(d / "plan.pt")
        part = SrcPartition(**plan["part"]).to(dev)
        rng = np.random.default_rng(0)
        make_cloud(a["n_src"], rng)          # the cloud's draws come first
        feat = torch.as_tensor(rng.normal(size=(a["n_src"], a["n_sta"], a["channels"]))
                               .astype(np.float32))
        x_sorted = feat[part.perm.long().cpu()]
        x_local = x_sorted[rank * part.n_local:(rank + 1) * part.n_local].to(dev)
        nbr = part.local_nbr[rank]
        halo0 = x_local.new_zeros((part.halo_total, *x_local.shape[1:]))
        progs = {
            "halo": lambda: sharded_gather_mean_src_axis(x_local, part, mesh),
            "local": lambda: _gather_mean(torch.cat((x_local, halo0)), nbr)}
        if rank == 0:
            x_full, src_nbr = feat.to(dev), plan["src_nbr"].to(dev)
            progs["dense"] = lambda: gather_mean_src_axis(x_full, src_nbr)
        time_ms = _timer(dev)
        out = {"mesh": mesh.describe()}
        for name in ("halo", "local", "dense"):
            mine = name in progs
            res = progs[name]() if mine else None         # warm-up
            ts = []
            for _ in range(a["reps"]):
                dist.barrier()
                if mine:
                    ts.append(time_ms(progs[name]))
            if mine:
                out[f"t_{name}_ms"] = float(np.median(ts))
                if name != "local":
                    out[name] = res.cpu()
        dist.barrier()
        torch.save(out, d / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def measure(n_src: int = 8192, n_sta: int = 128, channels: int = 30, k_src: int = 15,
            reps: int = 20, ranks: int = 8, backend: str = "gloo", device=None) -> dict:
    """Build the plan (source graph on the CPU), run ``ranks`` ranks of
    :func:`rank_worker` and return the JAX script's JSON dict plus the
    backend, the devices and ``max_abs_diff_vs_dense`` (the sharded output
    against the dense one, in the same frame). With ``nccl`` rank r runs on
    ``cuda:r``; with ``gloo`` every rank runs on ``device``."""
    import genie_tpu_torch
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.parallel.launch import run_ranks
    from genie_tpu_torch.parallel.product_shard import build_partition

    dev = resolve_device(device)
    if backend == "nccl" and ranks > torch.cuda.device_count():
        raise ValueError(f"measure: nccl puts one rank on each card; {ranks} ranks, "
                         f"{torch.cuda.device_count()} cards")
    src_pos, src_nbr = source_graph(n_src, k_src)
    part = build_partition(src_pos, src_nbr, ranks)
    d = Path(tempfile.mkdtemp(prefix="genie-measure-scaling-"))
    try:
        (d / "args.json").write_text(json.dumps(dict(
            n_src=n_src, n_sta=n_sta, channels=channels, reps=reps, backend=backend,
            device=str(dev))))
        torch.save({"part": part._asdict(), "src_nbr": src_nbr}, d / "plan.pt")
        run_ranks(lambda r, port: ["-c", _WORKER, d, r, ranks, port], ranks, d,
                  RANK_TIMEOUT_S, cwd=Path(genie_tpu_torch.__file__).resolve().parent.parent)
        outs = [torch.load(d / f"out_{r}.pt") for r in range(ranks)]
    finally:
        shutil.rmtree(d, ignore_errors=True)

    sharded = torch.cat([o["halo"] for o in outs])
    diff = float((sharded - outs[0]["dense"][part.perm.long()]).abs().max())
    t_halo = max(o["t_halo_ms"] for o in outs)
    t_local = max(o["t_local_ms"] for o in outs)
    t_dense = outs[0]["t_dense_ms"]
    stats = _stats(part, n_src)
    if backend == "nccl":
        note = (f"{ranks} nccl ranks, one card each: the halo crosses the links "
                f"between cards")
    elif dev.type == "cuda":
        note = (f"{ranks} gloo ranks on one card: the halo is staged through pinned "
                f"host memory, so the comm fraction is a structural overhead "
                f"(dispatch, staging copies, reshuffle), not a link measurement; the "
                f"link projection is scaling_model's")
    else:
        note = (f"{ranks} gloo ranks on the CPU: comm = host memcpy, so this is a "
                f"structural overhead bound; the link projection is scaling_model's")
    return {
        "n_src": n_src, "n_sta": n_sta, "channels": channels, "k_src": k_src,
        "n_shards": ranks, **stats,
        "t_sharded_with_halo_ms": round(t_halo, 3),
        "t_sharded_local_only_ms": round(t_local, 3),
        "t_dense_single_ms": round(t_dense, 3),
        "measured_comm_fraction": round(max(0.0, (t_halo - t_local) / t_halo), 4),
        "measured_structural_efficiency": round(t_local / t_halo, 4),
        "note": note, "backend": backend, "mesh": outs[0]["mesh"],
        "max_abs_diff_vs_dense": diff,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-src", type=int, default=8192)
    ap.add_argument("--n-sta", type=int, default=128)
    ap.add_argument("--channels", type=int, default=30)
    ap.add_argument("--k-src", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    out = measure(args.n_src, args.n_sta, args.channels, args.k_src, args.reps,
                  args.ranks, args.backend, dev)
    print(json.dumps(out, indent=1))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
