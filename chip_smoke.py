#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``genie_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):

  1. build every CUDA source under ``genie_tpu_torch/csrc`` with nvcc, one
     compiler process per source, all started together;
  2. hold the fused-round kernel against its plain PyTorch version on the
     card for the three round forms at the NC run6 widths (16 windows × 500
     sources = 8000 rows, 374 stations): round 1 (C = H = 30, M = 4), round 2
     (input 60, H = 15), association (M = 5); max |kernel − plain| ≤ 1e-4 in
     float32 with TF32 off; and time kernel, plain version and the dense
     ``torch.matmul`` formulation, with the kernel's share of its bound and
     its achieved GB/s and TFLOP/s;
  3. build an NC-scale domain: the run6 grids (5 × 500 sources), 374
     stations drawn from ``--seed`` inside the grid box, homogeneous travel
     times from the mean run6 velocities, the 10,000-node detection query
     grid and the run6 weights;
  4. run ``InferencePipeline.process`` twice on ten minutes of synthetic
     picks (planted events plus false picks), with the kernel launch count
     set to 0 just before each call, and check the catalog; one sweep window
     is also checked against the plain CPU path; a third request runs
     under ``torch.profiler`` for device time by kernel.

It prints per-stage times, event counts, launches, peak memory, the card's
name and power limit, a JSON line describing every kernel, and as its last
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RUN6 = ROOT / "projects" / "NC_EHZ" / "run6"
GRIDS = ROOT / "projects" / "NC_EHZ" / "Grids"

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and f32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TOL = 1e-4


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run6_config():
    """The inference settings of ``projects/NC_EHZ/run6/config.yaml``, set
    in code (no YAML package needed): the region and the station pad
    differ from the ``Config`` defaults; every graph, model and process
    value of that file equals its default."""
    from genie_tpu_torch.config import Config

    cfg = Config()
    cfg.region.name = "NC_EHZ"
    cfg.region.lat_range = (35.8055, 39.775097)
    cfg.region.lon_range = (-123.70883, -120.338257)
    cfg.region.depth_range = (-40000.0, 2000.0)
    cfg.region.degree_padding = 0.25
    cfg.graph.max_sta = 374
    cfg.graph.n_spatial_nodes = 500
    cfg.graph.n_grids = 5
    cfg.graph.max_picks = 512
    cfg.graph.k_sta_edges = 8
    cfg.graph.k_spc_edges = 15
    cfg.graph.k_time_edges = 10
    cfg.graph.k_spatial_attn = 10
    cfg.graph.k_pick_pairs = 16
    cfg.process.n_query_grid = 10000
    return cfg


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1 ---------------------------------------------------------------
def build_kernels():
    from genie_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} CUDA source(s) built in {time.time() - t0:.1f} s",
          flush=True)


# -- phase 2 ---------------------------------------------------------------
def round_bound(rows, n_sta, cx, cz, m, h, k, z_is_x):
    """Least bytes and operations of one launch (each input read once, the
    output written once; every neighbour slot of the table is valid)."""
    d = cx + cz + m
    elems_in = rows * n_sta * (cx + (0 if z_is_x else cz) + cz + m)
    elems_out = rows * n_sta * 2 * h
    small = n_sta * k * 2 + 2 * d * h + 2 * h + 2
    nbytes = 4 * (elems_in + elems_out + small)
    flops = rows * n_sta * (2 * k * cz + 2 * 2 * h * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return nbytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(sta_nbr, sta_w, seed: int):
    """Kernel vs plain version for the three round forms at run6 widths.
    Returns the per-form records (launches here are comparison launches)."""
    import torch
    import torch.nn.functional as F

    from genie_tpu_torch.ops.fused_round import (fused_dual_round, fused_round,
                                                 fused_round_plain)
    from genie_tpu_torch.ops.segment import aggregation_matrix, dense_to_neighbours

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows, n_sta = 16 * 500, int(sta_nbr.shape[0])
    k = int(sta_nbr.shape[1])
    a_dense = aggregation_matrix(sta_nbr, n_sta)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    forms = [("round1", 30, 30, 4, 30, True), ("round2", 60, 30, 4, 15, False),
             ("assoc", 30, 30, 5, 30, False)]
    records = []
    for name, cx, cz, m, h, z_is_x in forms:
        d = cx + cz + m
        x = randn(rows, n_sta, cx)
        z = x if z_is_x else randn(rows, n_sta, cz)
        agg_src = randn(rows, n_sta, cz)
        mask = (torch.rand((rows, n_sta, m), generator=gen, device=dev) > 0.5).float()
        w1, w2 = randn(h, d, scale=0.2), randn(h, d, scale=0.2)
        b1, b2 = randn(h), randn(h)
        slopes = torch.tensor([0.25, 0.1], device=dev)
        args = (x, z, agg_src, mask, sta_nbr, sta_w, w1, b1, w2, b2, slopes)
        got = fused_round(*args)
        torch.cuda.synchronize()
        want = fused_round_plain(*args)
        err = float((got - want).abs().max())
        if not np.isfinite(err) or err > TOL:
            fail(f"fused_round {name}: max |kernel - plain| = {err} > {TOL}")
        del got, want

        def library():
            zp = torch.clamp_min(z, 0) + slopes[0] * torch.clamp_max(z, 0)
            agg = torch.matmul(a_dense, zp)
            h1 = F.linear(torch.cat((x, agg, mask), -1), w1, b1)
            h2 = F.linear(torch.cat((x, agg_src, mask), -1), w2, b2)
            hh = torch.cat((h1, h2), -1)
            return torch.clamp_min(hh, 0) + slopes[1] * torch.clamp_max(hh, 0)

        ms = cuda_time_ms(lambda: fused_round(*args))
        plain_ms = cuda_time_ms(lambda: fused_round_plain(*args), reps=3, warmup=1)
        library_ms = cuda_time_ms(library, reps=3, warmup=1)
        nbytes, flops, bound_ms, bound_by = round_bound(rows, n_sta, cx, cz, m, h,
                                                        k, z_is_x)
        rec = dict(form=name, rows=rows, n_sta=n_sta, cx=cx, cz=cz, m=m, h=h,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                   share_of_bound=bound_ms / ms, gb_per_s=nbytes / ms / 1e6,
                   tflop_per_s=flops / ms / 1e9)
        print(f"[kernel] {json.dumps(rec)}", flush=True)
        records.append(rec)
        del x, z, agg_src, mask, args
        torch.cuda.empty_cache()

    # the JAX-signature entry (dense A_sta → padded neighbour list)
    xs = randn(64, 16, 8)
    a = torch.rand((16, 16), generator=gen, device=dev)
    a = a / a.sum(1, keepdim=True)
    ws = [randn(20, 8, scale=0.3), randn(8), randn(20, 8, scale=0.3), randn(8)]
    ms_ = (torch.rand((64, 16, 4), generator=gen, device=dev) > 0.5).float()
    sl = torch.tensor([0.25, 0.25, 0.25], device=dev)
    agg_src = randn(64, 16, 8)
    got = fused_dual_round(xs, agg_src, ms_, a, *ws, sl)
    want = fused_round_plain(xs, xs, agg_src, ms_, *dense_to_neighbours(a),
                             ws[0].t(), ws[1], ws[2].t(), ws[3], sl[[0, 2]])
    err = float((got - want).abs().max())
    if err > TOL:
        fail(f"fused_dual_round (dense A): max |kernel - plain| = {err}")
    print(f"[kernel] dense-A entry max |kernel - plain| = {err:.3e}", flush=True)
    return records


# -- phase 3 ---------------------------------------------------------------
def build_domain(cfg, seed: int, dev="cuda"):
    import torch

    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
    from genie_tpu_torch.train.trainer import build_domain_context

    dev = torch.device(dev)
    z = np.load(GRIDS / "grids_500.npz")
    grids_lla = z["grids_lla"].astype(np.float32)
    grids_cart = z["grids_cart"].astype(np.float32)
    proj = Projection.from_center(cfg.region.center)
    rng = np.random.default_rng(seed)
    lo = grids_lla.reshape(-1, 3).min(0)
    hi = grids_lla.reshape(-1, 3).max(0)
    n_sta = cfg.graph.max_sta
    sta_lla = np.stack((rng.uniform(lo[0], hi[0], n_sta),
                        rng.uniform(lo[1], hi[1], n_sta),
                        rng.uniform(-500.0, 1500.0, n_sta)), axis=1)
    sta_cart = proj.to_cart_np(sta_lla).astype(np.float32)
    trv = HomogeneousTravelTime(proj, float(np.mean(cfg.velocity.vp)),
                                float(np.mean(cfg.velocity.vs)))
    sta_t = torch.as_tensor(sta_cart, device=dev)
    trv_grids = torch.stack([trv.from_cart(sta_t, torch.as_tensor(g, device=dev))
                             for g in grids_cart])
    ctx = build_domain_context(cfg, sta_lla.astype(np.float32), sta_cart,
                               grids_lla, grids_cart, trv_grids, dev)
    return ctx, trv


def load_model(cfg):
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.params import load_flax_params, load_into

    model = Detector(scale_rel=cfg.model.scale_rel,
                     kernel_sig_t=cfg.model.kernel_sig_t,
                     use_phase_types=cfg.model.use_phase_types,
                     use_absolute_pos=cfg.model.use_absolute_pos)
    return load_into(model, load_flax_params(RUN6 / "params.pkl"))


def make_picks(ctx, trv, seed: int, span: float = 600.0, n_events: int = 6,
               false_rate: float = 1.0, max_dist: float = 150e3):
    """Planted events (P and S at stations within ``max_dist``, Gaussian
    pick noise) plus uniform false picks at ``false_rate`` per second."""
    import torch

    rng = np.random.default_rng(seed + 1)
    sta = ctx.sta_cart.cpu().numpy()
    lo = ctx.offset_cart.cpu().numpy()
    hi = lo + ctx.scale_cart.cpu().numpy()
    ev_pos = rng.uniform(lo + 0.25 * (hi - lo), hi - 0.25 * (hi - lo), (n_events, 3))
    ev_pos[:, 2] = rng.uniform(-20e3, -3e3, n_events)
    ev_t = np.sort(rng.uniform(30.0, span - 60.0, n_events))
    tt = trv.from_cart(ctx.sta_cart, torch.as_tensor(ev_pos, dtype=torch.float32,
                                                     device=ctx.sta_cart.device))
    tt = tt.cpu().numpy()
    t, s, p = [], [], []
    for e in range(n_events):
        near = np.where(np.linalg.norm(sta[:, :2] - ev_pos[e, None, :2], axis=1)
                        < max_dist)[0]
        for ph, sig in ((0, 0.1), (1, 0.15)):
            t.append(ev_t[e] + tt[e, near, ph] + rng.normal(0, sig, len(near)))
            s.append(near)
            p.append(np.full(len(near), ph))
    n_false = int(false_rate * span)
    t.append(rng.uniform(0, span, n_false))
    s.append(rng.integers(0, len(sta), n_false))
    p.append(rng.integers(0, 2, n_false))
    t, s, p = map(np.concatenate, (t, s, p))
    order = np.argsort(t)
    return (t[order].astype(np.float32), s[order].astype(np.int64),
            p[order].astype(np.float32), ev_pos, ev_t)


# -- phase 4 ---------------------------------------------------------------
def check_sweep_window(pipe, model_cpu, cfg, ctx, trv, picks, x_query):
    """One sweep window through the kernel path on the card and through
    the plain path on the CPU: same query scores within TOL."""
    import torch

    from genie_tpu_torch.infer.pipeline import InferencePipeline

    pick_t, pick_sta, pick_ph = picks[:3]
    ctx_cpu = type(ctx)(*[v.cpu() if isinstance(v, torch.Tensor) else v for v in ctx])
    pipe_cpu = InferencePipeline(model_cpu, cfg, ctx_cpu, trv.from_cart,
                                 x_query_grid=x_query, device="cpu")
    t0 = float(picks[4][0]) - 3.0
    tp, ip, ph, pm, _ = pipe._window_picks(pick_t, pick_sta, pick_ph, t0)
    got = pipe._sweep_batch(*pipe._to_device([(tp, ip, ph, pm)]), 0).cpu()
    want = pipe_cpu._sweep_batch(*pipe_cpu._to_device([(tp, ip, ph, pm)]), 0)
    err = float((got - want).abs().max())
    print(f"[check] sweep window, kernel path (cuda) vs plain path (cpu): "
          f"max |diff| = {err:.3e}, max score {float(want.max()):.4f}", flush=True)
    if not np.isfinite(err) or err > TOL:
        fail(f"sweep window differs from the CPU plain path by {err}")


def profile_request(pipe, picks):
    """One more request under ``torch.profiler``: device time by kernel
    name and the device busy share (Σ kernel time / host wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0)
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(ev.name, [0.0, 0])
            rec[0] += ev.time_range.elapsed_us() / 1e3
            rec[1] += 1
    total = sum(v[0] for v in by_name.values())
    if total == 0.0:
        print("[profile] the profiler recorded no device time: not measured")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    fused = sum(v[0] for k, v in by_name.items() if "fused_round" in k)
    print("[profile] " + json.dumps({
        "wall_s": wall, "device_ms": total, "busy_share": total / 1e3 / wall,
        "fused_round_ms": fused, "fused_round_share_of_device": fused / total,
        "top": [{"kernel": k[:90], "ms": v[0], "n": v[1]} for k, v in top]}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "genie_tpu_torch" / "csrc").is_dir() or not RUN6.is_dir():
        fail(f"the genie_tpu_torch package and projects/ are not next to {__file__}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.ops.segment import aggregation_weights

    build_kernels()

    cfg = run6_config()
    t0 = time.time()
    ctx, trv = build_domain(cfg, args.seed)
    model = load_model(cfg)
    x_query = np.load(GRIDS / "x_query_10000.npy").astype(np.float32)
    pipe = InferencePipeline(model, cfg, ctx, trv.from_cart, x_query_grid=x_query)
    torch.cuda.synchronize()
    print(f"[domain] {ctx.grids_cart.shape[0]} grids x {ctx.grids_cart.shape[1]} "
          f"sources x {ctx.sta_cart.shape[0]} stations, {x_query.shape[0]} query "
          f"nodes, set up in {time.time() - t0:.1f} s", flush=True)

    records = check_kernel(pipe.sta_nbr, aggregation_weights(
        pipe.sta_nbr, pipe.sta_nbr_valid), args.seed)

    picks = make_picks(ctx, trv, args.seed)
    print(f"[picks] {len(picks[0])} picks over 600 s, {len(picks[3])} planted "
          f"events", flush=True)
    check_sweep_window(pipe, load_model(cfg), cfg, ctx, trv, picks, x_query)

    results = []
    for call in range(2):
        torch.cuda.reset_peak_memory_stats()
        fused_round.launches = 0
        t0 = time.time()
        events = pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fused_round.launches
        results.append((events, launches, wall, dict(pipe.stage_seconds),
                        torch.cuda.max_memory_allocated()))
        print(f"[process] call {call + 1}: {len(events)} events, {launches} "
              f"fused_round launches, {wall:.2f} s", flush=True)

    events, launches, wall, stages, peak = results[-1]
    if launches <= 0:
        fail("the main path launched the fused_round kernel 0 times")
    if len(results[0][0]) != len(events):
        fail(f"two identical requests gave {len(results[0][0])} and "
             f"{len(events)} events")
    for ev in events:
        ok = (np.isfinite(ev.pos_cart).all() and np.isfinite(ev.time)
              and len(ev.picks) >= cfg.process.min_required_picks)
        if not ok:
            fail(f"malformed catalog event {ev}")
    ev_pos, ev_t = picks[3], picks[4]
    for ev in events:
        j = int(np.argmin(np.abs(ev_t - ev.time)))
        print(f"[event] t={ev.time:.2f} s pos=({ev.pos_cart[0] / 1e3:.1f}, "
              f"{ev.pos_cart[1] / 1e3:.1f}, {ev.pos_cart[2] / 1e3:.1f}) km, "
              f"{len(ev.picks)} picks; nearest planted event t={ev_t[j]:.2f} s, "
              f"{np.linalg.norm(ev_pos[j] - ev.pos_cart) / 1e3:.1f} km away")
    print("[stages] second call, host seconds: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    print(f"[process] events {len(events)}, fused_round launches {launches}, "
          f"wall {wall:.3f} s, max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")

    profile_request(pipe, picks)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    print(f"[total] {time.time() - t_all:.1f} s")

    r1 = records[0]
    kernels = [{
        "name": "fused_dual_round", "route": "cuda",
        "source": "genie_tpu_torch/csrc/fused_round.cu",
        "replaces": "genie_tpu/ops/pallas_fused.py:63",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "max_abs_diff": max(r["max_abs_err"] for r in records),
        "ms": r1["ms"], "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
        "bound_by": r1["bound_by"], "library_ms": r1["library_ms"],
        "forms": records,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
