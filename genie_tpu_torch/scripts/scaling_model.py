"""Multi-device scaling model for the source-partitioned product trunk, the
twin of ``scripts/scaling_model.py``, with the constants of one H100 in
place of the TPU v5e's.

Model (per dual-aggregation round, per shard), from the static halo plan
``parallel.product_shard.build_partition`` emits for a clustered source
cloud:
  * link traffic = halo rows moved per shard × n_sta × C × wire bytes, sent
    plus received;
  * memory traffic ≈ read + write of the local product tensor (+ the k-gather
    reads); operations from the matmul formulation's FLOPs;
  * efficiency = t_compute / (t_compute + t_comm), with no overlap credit.

The defaults of :func:`efficiency` are the H100 SXM data sheet's: 67 TFLOP/s
in float32 outside the tensor cores (the port's round runs f32 with TF32
off), 3.35 TB/s of HBM3, and 900 GB/s of NVLink 4 per GPU, send plus
receive (the accounting of the JAX model's two ICI links). The model has
one link per shard: a 16-shard pod spans two 8-GPU nodes, whose traffic
between nodes crosses the slower network between them, which this model
does not capture.

    python -m genie_tpu_torch.scripts.scaling_model [--n-src 131072] \\
        [--n-shards 16] [--halo-sweep] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from genie_tpu_torch.scripts import add_device_argument

F32_FLOP_PER_S = 67e12        # H100 SXM data sheet: FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet: HBM3
NVLINK_BYTES_PER_S = 900e9    # H100 SXM data sheet: NVLink 4 per GPU, send + receive


def make_cloud(n_src, rng):
    """Clustered source cloud (realistic seismicity, not uniform): 60 % in
    12 Gaussian clusters, 40 % background over a 600x600x40 km region."""
    n_bg = int(0.4 * n_src)
    centers = rng.uniform(-250e3, 250e3, (12, 3)) * np.array([1, 1, 0.05])
    cl = (centers[rng.integers(0, 12, n_src - n_bg)]
          + rng.normal(0, 15e3, (n_src - n_bg, 3)) * np.array([1, 1, 0.3]))
    bg = rng.uniform(-300e3, 300e3, (n_bg, 3)) * np.array([1, 1, 0.066])
    return np.concatenate([cl, bg]).astype(np.float32)


def cloud_partition(n_src: int, k_src: int, n_shards: int, rng, device):
    """A clustered cloud of ``n_src`` sources drawn from ``rng``, its kNN
    graph (``knn_tiled``) on ``device`` and the halo plan of ``n_shards``
    shards. The tiles are 1024 wide: ``knn_tiled`` sorts whole (n_src, tile)
    blocks, and at the sweep's 262,144 sources its default 8192-wide tile
    needs more than an H100's 80 GB."""
    from genie_tpu_torch.ops.knn import knn_tiled
    from genie_tpu_torch.parallel.product_shard import build_partition

    src = make_cloud(n_src, rng)
    x = torch.as_tensor(src, device=device)
    nbr = knn_tiled(x, x, k_src, tile=1024)[0].cpu()
    return build_partition(src, nbr, n_shards)


def round_costs(sent, n_local, args, wire_bytes=4, *, flops=F32_FLOP_PER_S,
                bw_mem=HBM_BYTES_PER_S, bw_link=NVLINK_BYTES_PER_S) -> dict:
    """Bytes over the link and to memory, operations, and their times, of
    one round on one shard that moves ``sent`` halo rows."""
    C, n_sta = args.channels, args.n_sta
    bytes_link = 2 * sent * n_sta * C * wire_bytes                    # send + recv
    bytes_mem = (2 + args.k_src + args.k_sta) * n_local * n_sta * C * 4
    n_ops = 2 * n_local * n_sta * C * (n_sta + args.k_src)            # matmul form
    return {"bytes_link": bytes_link, "bytes_mem": bytes_mem, "ops": n_ops,
            "t_comm": bytes_link / bw_link, "t_mem": bytes_mem / bw_mem,
            "t_ops": n_ops / flops}


def efficiency(sent, n_local, args, wire_bytes=4, *, flops=F32_FLOP_PER_S,
               bw_mem=HBM_BYTES_PER_S, bw_link=NVLINK_BYTES_PER_S):
    r = round_costs(sent, n_local, args, wire_bytes, flops=flops, bw_mem=bw_mem,
                    bw_link=bw_link)
    t_compute = max(r["t_mem"], r["t_ops"])
    return t_compute / (t_compute + r["t_comm"])


def halo_sweep(args, device) -> dict:
    """Measure halo rows per shard against shard size on the real plan
    builder and project to the pod config (``--pod-n-src`` sources over
    ``--n-shards`` shards). The halo is a 2-D boundary shell of a 3-D block,
    so halo/n_local falls like n_local^(-1/3); the fitted slope makes that
    measured, not assumed. Returns the points, the slope, the projected
    ratio and the efficiency with f32 and bf16 wires."""
    rng = np.random.default_rng(0)
    pts = []
    for n_src in args.sweep_sizes:
        part = cloud_partition(n_src, args.k_src, args.n_shards, rng, device)
        n_local = n_src // args.n_shards
        ratio = part.halo_total / n_local
        pts.append((n_local, part.halo_total, ratio))
        print(f"n_local {n_local:>6}: halo/shard {part.halo_total:>5} "
              f"(ratio {ratio:.3f}, exact "
              f"{part.halo_rows_valid // args.n_shards})", flush=True)
    x = np.log([p[0] for p in pts])
    y = np.log([p[2] for p in pts])
    slope = float(np.polyfit(x, y, 1)[0])
    n_pod = args.pod_n_src // args.n_shards
    ratio_pod = pts[-1][2] * (n_pod / pts[-1][0]) ** slope
    print(f"fitted slope {slope:.3f} (surface/volume predicts -0.333)")
    print(f"projected halo ratio at pod n_local={n_pod}: {ratio_pod:.3f}")
    eff = efficiency(int(ratio_pod * n_pod), n_pod, args)
    eff16 = efficiency(int(ratio_pod * n_pod), n_pod, args, wire_bytes=2)
    print(f"projected pod-scale efficiency: f32 wire {eff:.3f}, bf16 wire "
          f"{eff16:.3f} (target >= 0.8; bf16-wire is the mixed-precision "
          f"exchange, product_shard.halo_exchange(wire_dtype=torch.bfloat16))")
    return {"points": pts, "slope": slope, "ratio_pod": ratio_pod,
            "efficiency_f32_wire": eff, "efficiency_bf16_wire": eff16}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-src", type=int, default=131072)
    ap.add_argument("--n-sta", type=int, default=1000)
    ap.add_argument("--n-shards", type=int, default=16)
    ap.add_argument("--channels", type=int, default=30)
    ap.add_argument("--k-src", type=int, default=15)
    ap.add_argument("--k-sta", type=int, default=8)
    ap.add_argument("--halo-sweep", action="store_true",
                    help="measure halo/n_local scaling + pod projection")
    ap.add_argument("--sweep-sizes", type=int, nargs="+",
                    default=[32768, 65536, 131072, 262144])
    ap.add_argument("--pod-n-src", type=int, default=1048576)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.halo_sweep:
        return halo_sweep(args, dev)

    part = cloud_partition(args.n_src, args.k_src, args.n_shards,
                           np.random.default_rng(0), dev)
    n_local = args.n_src // args.n_shards
    # the per-offset exchange plan moves halo_total rows per shard (incl.
    # per-offset padding); the exact requirement is halo_rows_valid
    sent = part.halo_total
    exact = part.halo_rows_valid // args.n_shards
    print(f"partition: {args.n_shards} shards x {n_local} local rows, "
          f"halo rows moved/shard {sent} (exact {exact}, offsets "
          f"{part.offsets}) — {100.0 * sent / n_local:.1f}% of local)")
    r = round_costs(sent, n_local, args)
    eff = efficiency(sent, n_local, args)
    print(f"per round/shard: NVLink {r['bytes_link'] / 1e6:.1f} MB "
          f"({r['t_comm'] * 1e3:.2f} ms), HBM {r['bytes_mem'] / 1e9:.2f} GB "
          f"({r['t_mem'] * 1e3:.2f} ms), f32 {r['ops'] / 1e12:.2f} TFLOP "
          f"({r['t_ops'] * 1e3:.2f} ms)")
    print(f"scaling efficiency (no-overlap bound): {eff:.3f} "
          f"{'>= 0.8 target' if eff >= 0.8 else '< 0.8 target'}")
    return eff


if __name__ == "__main__":
    main()
