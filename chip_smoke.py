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
     under ``torch.profiler`` for device time by kernel;
  5. ``[pinn]``: the travel-time PINN of ``Grids/pinn_nc.pkl`` on the card
     against the same module on the CPU, 4096 sources in the grid box × the
     374 stations, max |Δt| ≤ 1e-3 s, and its time per call;
  6. ``[production]``: run6's serving configuration, as
     ``scripts/nc_process.py --mag-model --corrections`` builds it: grid
     tables from the PINN shifted by the calibrated corrections of
     ``run6/corrections_nc.npz``, the corrected PINN for association and
     location, the magnitude model of ``run6/mag_model_nc.pkl`` with its
     magnitude → distance QC; one more pipeline without a query grid packs
     its 10,000 nodes by k-means on the card. Six planted events (picks
     timed by the corrected PINN, magnitudes U[2.2, 3.5], amplitudes from
     the magnitude model plus noise) go through ``process(pick_amp=…)``
     twice, then once more under the profiler; every planted event must be
     located within 5 km and 0.5 s with |ΔM| ≤ 0.25;
  7. ``[locate]``: one ``locate_sources_batched`` call through the
     corrected PINN at the pipeline's limits, 256 events × 48 picks,
     popsize 128, 150 iterations: its time and peak memory.

It prints per-stage times, event counts, launches, peak memory, the card's
name and power limit, a JSON line describing every kernel, and as its last
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX and needs
no h5py.
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
PINN = GRIDS / "pinn_nc.pkl"
CORRECTIONS = RUN6 / "corrections_nc.npz"
MAGNITUDES = RUN6 / "mag_model_nc.pkl"

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
               false_rate: float = 1.0, max_dist: float = 150e3, mag=None):
    """Planted events (P and S at stations within ``max_dist``, Gaussian
    pick noise) plus uniform false picks at ``false_rate`` per second.

    With ``mag`` (the pipeline's magnitude-model dict) the events also get
    magnitudes U[2.2, 3.5] and every pick an amplitude: a planted pick
    ``10**(log-amplitude of the model + N(0, 0.1))``, a false pick
    ``10**U(-1, 1)``; these draws come from their own generator, so the
    picks are those of the call without ``mag``. Returns (t, sta, phase,
    ev_pos, ev_t) and, with ``mag``, also (amp, ev_mag)."""
    import torch

    rng = np.random.default_rng(seed + 1)
    sta = ctx.sta_cart.cpu().numpy()
    lo = ctx.offset_cart.cpu().numpy()
    hi = lo + ctx.scale_cart.cpu().numpy()
    ev_pos = rng.uniform(lo + 0.25 * (hi - lo), hi - 0.25 * (hi - lo), (n_events, 3))
    ev_pos[:, 2] = rng.uniform(-20e3, -3e3, n_events)
    ev_t = np.sort(rng.uniform(30.0, span - 60.0, n_events))
    dev = ctx.sta_cart.device
    with torch.no_grad():
        tt = trv.from_cart(ctx.sta_cart, torch.as_tensor(ev_pos, dtype=torch.float32,
                                                         device=dev)).cpu().numpy()
    rng_amp = np.random.default_rng(seed + 2)
    ev_mag = rng_amp.uniform(2.2, 3.5, n_events)
    t, s, p, amp = [], [], [], []
    for e in range(n_events):
        near = np.where(np.linalg.norm(sta[:, :2] - ev_pos[e, None, :2], axis=1)
                        < max_dist)[0]
        for ph, sig in ((0, 0.1), (1, 0.15)):
            t.append(ev_t[e] + tt[e, near, ph] + rng.normal(0, sig, len(near)))
            s.append(near)
            p.append(np.full(len(near), ph))
            if mag is not None:
                with torch.no_grad():
                    log_amp = mag["model"](
                        torch.as_tensor(np.repeat(ev_pos[e:e + 1], len(near), 0),
                                        dtype=torch.float32, device=dev),
                        ctx.sta_cart, torch.as_tensor(mag["grid_cart"], device=dev),
                        torch.as_tensor(near, device=dev),
                        torch.full((len(near),), ph, device=dev),
                        mag=torch.full((len(near),), float(ev_mag[e]), device=dev))
                amp.append(10 ** (log_amp.cpu().numpy()
                                  + rng_amp.normal(0, 0.1, len(near))))
    n_false = int(false_rate * span)
    t.append(rng.uniform(0, span, n_false))
    s.append(rng.integers(0, len(sta), n_false))
    p.append(rng.integers(0, 2, n_false))
    amp.append(10 ** rng_amp.uniform(-1, 1, n_false))
    t, s, p = map(np.concatenate, (t, s, p))
    order = np.argsort(t)
    out = (t[order].astype(np.float32), s[order].astype(np.int64),
           p[order].astype(np.float32), ev_pos, ev_t)
    if mag is None:
        return out
    return out + (np.concatenate(amp)[order], ev_mag)


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


def profile_request(pipe, picks, pick_amp=None, tag="profile", ranges=()):
    """One more request under ``torch.profiler``: device time by kernel
    name, the device busy share (Σ kernel time / host wall time), and the
    device time of the kernels launched inside each ``record_function``
    range named in ``ranges`` (a range nested in another counts in both)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0, pick_amp=pick_amp)
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name: dict[str, list] = {}
    in_range = dict.fromkeys(ranges, 0.0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and ev.name in in_range:
            continue    # the range's own span on the device timeline, not a kernel
        if ev.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(ev.name, [0.0, 0])
            rec[0] += ev.time_range.elapsed_us() / 1e3
            rec[1] += 1
        elif ev.name in in_range:
            in_range[ev.name] += ev.device_time_total / 1e3
    total = sum(v[0] for v in by_name.values())
    if total == 0.0:
        print(f"[{tag}] the profiler recorded no device time: not measured")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    fused = sum(v[0] for k, v in by_name.items() if "fused_round" in k)
    print(f"[{tag}] " + json.dumps({
        "wall_s": wall, "device_ms": total, "busy_share": total / 1e3 / wall,
        "fused_round_ms": fused, "fused_round_share_of_device": fused / total,
        "ranges_ms": in_range,
        "ranges_share_of_device": {k: v / total for k, v in in_range.items()},
        "top": [{"kernel": k[:90], "ms": v[0], "n": v[1]} for k, v in top]}),
        flush=True)


def labelled(fn, name):
    """``fn`` inside a ``record_function`` range, so the profiler can sum
    the device time of what it launches."""
    from torch.profiler import record_function

    def call(*args):
        with record_function(name):
            return fn(*args)

    return call


# -- phase 5 ---------------------------------------------------------------
def check_pinn(ctx, seed: int, n_src: int = 4096, dev="cuda"):
    """The PINN on the card against the same weights on the CPU, for
    ``n_src`` sources drawn in the grid box × every station. Returns the
    card's PINN."""
    import torch

    from genie_tpu_torch.params import load_pinn

    pinn = load_pinn(PINN, device=dev)
    pinn_cpu = load_pinn(PINN, device="cpu")
    rng = np.random.default_rng(seed + 3)
    flat = ctx.grids_cart.reshape(-1, 3).cpu().numpy()
    src = rng.uniform(flat.min(0), flat.max(0), (n_src, 3)).astype(np.float32)
    src_d = torch.as_tensor(src, device=dev)
    with torch.no_grad():
        got = pinn.from_cart(ctx.sta_cart, src_d).cpu()
        want = pinn_cpu.from_cart(ctx.sta_cart.cpu(), torch.as_tensor(src))
        ms = cuda_time_ms(lambda: pinn.from_cart(ctx.sta_cart, src_d), reps=5)
    err = float((got - want).abs().max())
    n_pairs = n_src * ctx.sta_cart.shape[0]
    print("[pinn] " + json.dumps({
        "sources": n_src, "stations": int(ctx.sta_cart.shape[0]), "max_abs_dt_s": err,
        "max_t_s": float(want.max()), "ms": ms, "pairs_per_s": n_pairs / ms * 1e3}),
        flush=True)
    if not np.isfinite(err) or err > 1e-3:
        fail(f"PINN on the card differs from the CPU by {err} s > 1e-3 s")
    return pinn


# -- phase 6 ---------------------------------------------------------------
def build_production(cfg, ctx, pinn, model, x_query, dev="cuda"):
    """run6's serving configuration on the card: grid tables from the PINN
    shifted by the corrections at every grid node (as
    ``scripts/nc_process.py`` does), the corrected PINN as the pipeline's
    travel time, and the magnitude model. The per-station artifacts hold
    the 374 NC stations; a rehearsal with fewer stations takes the first
    ones. Returns (pipeline, ctx, trv, mag)."""
    import torch

    from genie_tpu_torch.calibration.corrections import (TravelTimeCorrection,
                                                         interp_weighted)
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.params import load_magnitude_model
    from genie_tpu_torch.train.trainer import build_domain_context
    from genie_tpu_torch.utils import compute_travel_times_chunked

    t0 = time.time()
    n_sta = ctx.sta_cart.shape[0]
    z = np.load(CORRECTIONS)
    trv = TravelTimeCorrection(labelled(pinn.from_cart, "pinn"), z["grid_cart"],
                               z["coefs"][:, :n_sta]).to(dev)
    with torch.no_grad():
        pinn_grids = torch.stack([
            compute_travel_times_chunked(pinn.from_cart, ctx.sta_cart, g)
            for g in ctx.grids_cart])
        corr = torch.stack([interp_weighted(trv.grid_cart, trv.coefs, g)
                            for g in ctx.grids_cart])
    trv_grids = pinn_grids + corr
    ctx_p = build_domain_context(cfg, ctx.sta_lla, ctx.sta_cart, ctx.grids_lla,
                                 ctx.grids_cart, trv_grids, dev)
    mag = load_magnitude_model(MAGNITUDES, device=dev)
    mag["model"].bias = torch.nn.Parameter(mag["model"].bias[:, :n_sta],
                                           requires_grad=False)
    pipe = InferencePipeline(model, cfg, ctx_p, labelled(trv.from_cart, "trv"),
                             x_query_grid=x_query, mag_model=mag, device=dev)
    torch.cuda.synchronize()
    print(f"[production] domain: PINN grid tables (mean |PINN - homogeneous| "
          f"{float((pinn_grids - ctx.trv_grids).abs().mean()):.3f} s) + corrections "
          f"(mean |corr| {float(corr.abs().mean()):.4f} s, max "
          f"{float(corr.abs().max()):.4f} s); magnitude model ({mag['n_sta']} "
          f"stations, {len(mag['grid_cart'])} nodes, dist_model "
          f"{mag['dist_model']['kind']}); set up in {time.time() - t0:.1f} s",
          flush=True)
    if not torch.isfinite(trv_grids).all():
        fail("the production grid tables are not finite")

    t0 = time.time()
    pipe_q = InferencePipeline(model, cfg, ctx_p, trv.from_cart, mag_model=mag,
                               device=dev)
    torch.cuda.synchronize()
    xq = pipe_q.x_query
    lo, hi = ctx_p.offset_cart, ctx_p.offset_cart + ctx_p.scale_cart
    inside = float(((xq >= lo - 0.05 * (hi - lo)) & (xq <= hi + 0.05 * (hi - lo)))
                   .all(dim=1).float().mean())
    print(f"[production] build_query_grid on the card: {xq.shape[0]} nodes in "
          f"{time.time() - t0:.2f} s (pipeline set-up included), {inside:.4f} "
          f"inside the box", flush=True)
    if xq.shape[0] != cfg.process.n_query_grid or not torch.isfinite(xq).all() \
            or inside < 1.0:
        fail("the k-means query grid is malformed")
    del pipe_q
    return pipe, ctx_p, trv, mag


def production_request(pipe, cfg, ctx, trv, mag, seed: int):
    """Two timed requests with amplitudes and a profiled third; every
    planted event must come back located and with its magnitude. Returns
    the fused-round launches of the second request."""
    import torch

    from genie_tpu_torch.ops.fused_round import fused_round

    picks = make_picks(ctx, trv, seed, mag=mag)
    amp, ev_mag = picks[5], picks[6]
    print(f"[production] {len(picks[0])} picks over 600 s, {len(picks[3])} planted "
          f"events, M {np.round(ev_mag, 2).tolist()}", flush=True)
    results = []
    for call in range(2):
        torch.cuda.reset_peak_memory_stats()
        fused_round.launches = 0
        t0 = time.time()
        events = pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0, pick_amp=amp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fused_round.launches
        results.append((events, launches, wall, dict(pipe.stage_seconds),
                        torch.cuda.max_memory_allocated()))
        print(f"[production] call {call + 1}: {len(events)} events, {launches} "
              f"fused_round launches, {wall:.2f} s", flush=True)
    events, launches, wall, stages, peak = results[-1]
    if launches <= 0:
        fail("the production path launched the fused_round kernel 0 times")
    for ev in events:
        if not (np.isfinite(ev.pos_cart).all() and np.isfinite(ev.time)
                and ev.mag is not None and np.isfinite(ev.mag)):
            fail(f"malformed production event {ev}")
    ev_pos, ev_t = picks[3], picks[4]
    for j in range(len(ev_t)):
        near = [ev for ev in events if abs(ev.time - ev_t[j]) < 0.5
                and np.linalg.norm(ev.pos_cart - ev_pos[j]) < 5e3]
        best = min(events, key=lambda ev: abs(ev.time - ev_t[j])) if events else None
        if best is not None:
            print(f"[production] planted t={ev_t[j]:.2f} s M {ev_mag[j]:.2f}: nearest "
                  f"event dt {best.time - ev_t[j]:+.3f} s, "
                  f"{np.linalg.norm(best.pos_cart - ev_pos[j]) / 1e3:.2f} km, M "
                  f"{best.mag:.2f}, {len(best.picks)} picks")
        if not near:
            fail(f"planted event {j} (t={ev_t[j]:.2f} s) not located within 5 km and 0.5 s")
        if min(abs(ev.mag - ev_mag[j]) for ev in near) > 0.25:
            fail(f"planted event {j}: magnitude off by more than 0.25")
    print("[stages] production, second call, host seconds: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    print(f"[production] events {len(events)}, fused_round launches {launches}, "
          f"wall {wall:.3f} s, max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    profile_request(pipe, picks, pick_amp=amp, tag="profile production",
                    ranges=("trv", "pinn"))
    return launches


# -- phase 7 ---------------------------------------------------------------
def locate_at_limits(ctx, trv, pinn, seed: int, n_ev: int = 256, n_pick: int = 48,
                     popsize: int = 128, n_iter: int = 150, dev="cuda"):
    """One DE location call through the corrected PINN at the pipeline's
    batch limit: ``n_ev`` planted sources, each picked at its ``n_pick / 2``
    nearest stations (P and S, 0.1 s noise)."""
    import torch

    from genie_tpu_torch.infer.locate import locate_sources_batched

    rng = np.random.default_rng(seed + 4)
    lo = ctx.offset_cart.cpu().numpy()
    hi = lo + ctx.scale_cart.cpu().numpy()
    pos = rng.uniform(lo + 0.2 * (hi - lo), hi - 0.2 * (hi - lo), (n_ev, 3))
    pos[:, 2] = rng.uniform(-20e3, -3e3, n_ev)
    pos_d = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    sta = ctx.sta_cart
    with torch.no_grad():
        tt = trv.from_cart(sta, pos_d)                               # (n_ev, n_sta, 2)
    d = torch.linalg.norm(sta[None, :, :2] - pos_d[:, None, :2], dim=-1)
    near = torch.topk(-d, n_pick // 2, dim=1).indices                # (n_ev, n_pick/2)
    ip = torch.cat((near, near), dim=1).to(torch.int32)
    ph = torch.cat((torch.zeros_like(near), torch.ones_like(near)), dim=1)
    tp = torch.gather(tt, 1, ip.long()[..., None].expand(-1, -1, 2))
    tp = torch.gather(tp, 2, ph[..., None])[..., 0]
    tp = tp + torch.as_tensor(rng.normal(0, 0.1, tp.shape), dtype=torch.float32,
                              device=dev)
    mk = torch.ones_like(tp, dtype=torch.bool)
    lo_b = torch.cat((ctx.offset_cart, torch.tensor([-30.0], device=dev)))
    hi_b = torch.cat((ctx.offset_cart + ctx.scale_cart, torch.tensor([30.0], device=dev)))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run():
        with torch.no_grad():
            return locate_sources_batched(gen, trv.from_cart, sta, tp, ip,
                                          ph[..., None].float(), mk, lo_b, hi_b,
                                          popsize=popsize, n_iter=n_iter)

    run()                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loc, t_org, _ = run()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    err = torch.linalg.norm(loc - pos_d, dim=1).cpu().numpy()
    cand = torch.as_tensor(rng.uniform(lo, hi, (n_ev, popsize, 3)), dtype=torch.float32,
                           device=dev)
    with torch.no_grad():
        pinn_ms = cuda_time_ms(lambda: pinn.from_cart(sta, cand), reps=3, warmup=1)
        trv_ms = cuda_time_ms(lambda: trv.from_cart(sta, cand), reps=3, warmup=1)
    n_pairs = n_ev * popsize * sta.shape[0]
    print("[locate] " + json.dumps({
        "events": n_ev, "picks": n_pick, "popsize": popsize, "n_iter": n_iter,
        "stations": int(sta.shape[0]), "pairs_per_objective": n_pairs, "ms": ms,
        "max_memory_allocated_bytes": peak, "peak_gib": peak / 2**30,
        "objective_pinn_ms": pinn_ms, "objective_corrected_ms": trv_ms,
        "correction_share_of_objective_trv": (trv_ms - pinn_ms) / trv_ms,
        "error_m_median": float(np.median(err)), "error_m_p90": float(np.quantile(err, 0.9)),
        "abs_t0_s_median": float(t_org.abs().median())}), flush=True)
    if not np.isfinite(err).all():
        fail("the DE location at the pipeline's limits gave non-finite positions")


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

    pinn = check_pinn(ctx, args.seed)
    del pipe
    torch.cuda.empty_cache()
    pipe_p, ctx_p, trv_p, mag = build_production(cfg, ctx, pinn, model, x_query)
    launches_p = production_request(pipe_p, cfg, ctx_p, trv_p, mag, args.seed)
    locate_at_limits(ctx_p, trv_p, pinn, args.seed)

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
        "launches": launches_p,
        "launches_by_path": {"homogeneous": launches, "production": launches_p},
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
