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
     its achieved GB/s and TFLOP/s; each form again in its edge form (E = 4,
     the updated model definition's per-station and per-source tables),
     held and timed the same way; then all six forms again at 1,000 and
     2,048 stations (drawn from ``--seed`` in the run6 grid box, k = 8;
     4 windows × 512 sources = 2048 rows), where the kernel keeps its
     per-row Y buffer in device memory (past about 900 stations), held and
     timed the same way;
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
     374 stations, max |Δt| ≤ 1e-3 s, and its time per call; then
     ``[kernel]`` records of the PINN kernel against the plain forward on
     the card at the DE's shapes (1, 12 and 256 events × 128 candidates ×
     374 stations), max |Δt| ≤ 2e-4 s, with kernel, bound and plain times
     (``--pinn-kernel`` builds and runs only this);
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
     located within 5 km and 0.5 s with |ΔM| ≤ 0.25, and every PINN call
     but the covariance's ``jacfwd`` (one a location pass) must take the
     PINN kernel. Each path that locates counts its ``pinn_trv`` launches
     from 0 (the ``kernels`` line's ``launches_by_path``): the PINN's paths
     ([production], [locate], [extras]' trace, [workflow]'s process) fail
     with none, the homogeneous ones ([process], [evaluate]) with any;
  7. ``[locate]``: one ``locate_sources_batched`` call through the
     corrected PINN at the pipeline's limits, 256 events × 48 picks,
     popsize 128, 150 iterations: its time and peak memory;
  8. ``[train]``: detector training at run6 width, as ``scripts/nc_train.py
     --trv pinn --restart`` runs it with run6's ``synth:`` and ``train:``
     blocks (8 windows of a 3600 s timeline of up to 96 events and 2048
     false picks, 2000 detection and 96 association queries, 512 picks,
     sequential windows, positive boost 100) on grid tables from the PINN
     without corrections and no observed subnetworks. First the checks:
     the ``FusedRound`` backward against autograd through the plain round
     for the three round forms of phase 2 (max |Δgrad| per input ≤ 1e-4 ×
     its max |grad|), and one window's loss and parameter gradients on the
     card against the plain CPU path (loss within 1e-4 relative, each
     gradient within 1e-3 × its max |g|). Then ``workflow.train`` resumes
     ``run6/params.pkl`` with its Adam state at step 20000 and takes three
     steps (the kernel launch count set to 0 just before, 32 forward
     launches per step expected), and one more step runs under the
     profiler: seconds per stage, peak memory, the four loss parts,
     trgts/preds, the Adam count (20004), device time by kernel with the
     fused round's forward and backward shares. Every loss must be finite
     and the weights must move;
  9. ``[calibrate]``: the calibration fits at run6's sizes on the phase-3
     stations. ``fit_corrections`` on 56 synthetic reference events picked
     P and S at their 15 nearest stations (PINN times + a per-(station,
     phase) bias of σ 0.3 s + 0.05 s noise), the 500 nodes of
     ``run6/corrections_nc.npz``, 1500 steps: the mean |residual| must
     fall under half, and 20 steps on the card must match 20 on the CPU
     within 1e-4 s. ``fit_magnitude_model`` on 6000 amplitudes of 300
     events (a 25 % event holdout, 8 Lloyd nodes, 3000 steps, bias
     regularization 3.0): holdout median |ΔM| < 0.25, and 20 steps card vs
     CPU within 1e-5. ``relocation_benchmark`` of the 56 events from starts
     perturbed by N(0, 5 km) and N(0, 1 s) through the PINN plus the
     corrections just fitted (popsize 96, 120 iterations): the mean
     horizontal error must fall under half. Seconds and peak memory of
     each;
 10. ``[relocate]``: GraphDD at the sizes of run6's relocation artifact:
     336 events in a 40 km cluster, PINN picks at the stations within
     150 km (85 % present), starts perturbed by N(0, 2 km) per axis, 68
     events anchored to their true positions (``attach_reference``), 12
     graphs of 24 sources × 64 stations, ``GNNLocation()`` at full width.
     One graph's loss and gradients at flax-default weights card vs CPU
     (loss 1e-4 relative, each gradient leaf within 1e-3 × its own max
     |g| + 1e-5 × the largest |g| of all leaves, a floor for the PReLU
     slopes' cancelling sums), through homogeneous travel times and through
     the PINN, where both sides take the card's PINN times (the CPU's PINN,
     which differs from the card's by up to ~5e-5 s, is compared too and
     printed as the witness of that difference); then ``train_graphdd``
     for 3000 steps (a 50-step probe cuts them to the largest multiple of
     250, at least ``RELOCATE_MIN_STEPS``, that fits ``RELOCATE_BUDGET_S``,
     and prints the cut),
     ``relocate`` of every graph averaged per source: the median 3-D error
     of the relocated sources must fall under 0.7 × their initial median.
     Seconds per step, peak memory and one profiled step;
 11. ``[project]``: a project built from its files, as a user's first
     commands for a region do (``init_project.py``, the FMM build,
     ``nc_pinn.py``), at run6 width in a temporary directory: a
     stations.txt of 374 stations drawn from ``--seed`` (run6's lat/lon
     range, elevations U[0, 1500] m), ``read_stations_txt`` and
     ``init_project`` (5 grids × 500 nodes, 800 Lloyd steps each, on the
     card; every node finite and inside the padded region); ``fmm_grid_box``
     of run6's config must be the box of ``pinn_nc.pkl`` (x_scale 504,000 m,
     centre within 1 m, shape 239 × 336 × 34); ``build_fmm_tables`` for 8
     of the 374 stations over a spawn pool of up to 8 workers; the
     production PINN against those fresh tables on 4096 importance samples
     per station (median |Δt| ≤ 0.15 s; the pickle's own cross-validation
     median is 0.033 s); the PINN loss card vs CPU at flax-default weights
     on 4096 bank samples (loss and parts within 1e-4 relative, the eikonal
     gradient within 1e-4 × its max, each gradient leaf within 1e-3 × its
     own max |g| + 1e-5 × the largest); ``nc_pinn.py``'s loop from scratch
     (batch 16,384, 30,000 + 2,048 samples per station, one held-out
     station per 20, lr 1e-3 cosine over 40,000 steps to 0.02, clip 1.0),
     cut by a 50-step probe to the largest multiple of 500 steps (at least
     ``PINN_MIN_STEPS``) that fits ``PINN_BUDGET_S``: every loss finite and
     the data term of the last 100 steps under half its first value; val / cross-val |Δt|, velocity
     R², ms per step, peak memory and a profiled step; the artifact saved
     to the project's ``Grids/``, read back by ``make_trv`` (times within
     1e-6 s of the trained model's) and ``domain_from_project`` (5 × 500 ×
     374 × 2 finite grid tables).
 12. ``[options]`` (run after phase 8; ``options_phase``): the detector and
     pipeline options that run6's config leaves off, on the phase-3 domain:
     the edge form's ``FusedRound`` backward against autograd (as phase
     8); ``workflow.train`` from flax-default weights with
     ``use_updated_model_definition``, ``use_absolute_pos`` and
     ``normalize_readin`` on run6's training blocks (one window card vs
     CPU at phase 8's tolerances, 3 steps with 32 launches each, one
     profiled step; the weights and ``read_in.sum_gain`` must move); those
     weights served with subgraph pair masks at the config defaults (one
     request, one sweep window card vs CPU; no quality gate, the weights
     are four steps old); the bf16-weight sweep with run6's weights against
     the f32 sweep (≤ 0.05), card vs CPU (≤ 1e-3), and a request with it
     that must locate the six planted events within 5 km and 0.5 s.
 13. ``[extras]`` (run after phase 7; ``extras_phase``): what the JAX
     pipeline never calls, on the production domain with its corrected
     PINN and request. ``locate_source_pso`` (popsize 128, 120
     iterations, 64 depths, the stations' hull) and ``locate_source`` (DE,
     popsize 128, 150 iterations) on each planted event's picks at its 24
     nearest stations: within 5 km and 0.5 s; ``location_uncertainty`` at
     each DE solution card vs CPU (1e-3 of the largest entry, symmetric);
     ``LegacyTravelTimes`` at flax-default weights on 4096 sources × the
     stations, full and relative, card vs CPU (times 1e-4 × max |t|, mask
     1e-5); ``knn_tiled`` of the 10,000 query nodes against themselves (k
     10, tile 8192) equal to ``knn`` wherever the exact distances order
     clearly (gaps over the f32 rounding bound of the distance form, about
     1e-3 of a neighbour's d² at 2e5 m) and within that bound everywhere;
     ``spmm`` over one product graph's 1.50 M
     station edges (C 30, weighted; sum, mean, max) card vs CPU within
     1e-5 relative, forward and backward; ``natural_neighbor_interp`` of a
     smooth field on the 500 correction nodes to 4096 queries, card vs CPU
     on 512 (at most 1 % differ by more than 1e-4 × the range); the
     production request replayed through ``process_from_sweep(trace=…)``
     (every planted event covered at all seven stages, the events of the
     call without ``trace``, launches > 0); and ``nc_optimize_data.py``'s
     loop at its defaults (``--t-synth`` 10,800 s, 40 calls, 15 random
     starts) against the statistics of two timelines at run6's ``synth:``
     values, a stand-in for the BSSA pick days (not in the repo): every
     residual finite.
 14. ``[shard]`` (run after phase 4; ``shard_phase``): the multi-device
     package on one card. This process builds the inputs and their
     references on the card, then starts a gloo group of 4 processes of
     this script (``--shard-worker``), all on ``cuda:0`` (NCCL refuses two
     ranks on one GPU), and holds their results: (a)
     ``make_sharded_detection_forward`` on the run6 grid (grid 0: 500
     sources × the 374 stations, 125 per rank, 2 windows) against the
     dense one-process forward, y and x_q within 1e-4; (b) the same at pod
     width cut to one card: 1,000 stations and 8,192 sources (2,048 per
     rank) drawn from ``--seed`` in the run6 box; (c)
     ``make_subgraph_sharded_detection_forward`` at (b)'s size with an
     all-True pair mask (within 1e-4 of dense), then with run6's pair mask
     (``max_deg_offset`` 1.5, ``k_nearest_pairs`` 30): finite, the same on
     every rank, stations carried per rank against dense; (d) (b) with the
     bf16 wire, within 2e-2 of the f32 wire; (e) ranks 0 and 1 (a
     sub-group) take one data-parallel step of run6's training
     configuration resumed from ``run6/params.pkl`` on one 8-window batch
     (4 windows per rank) against one process taking the same step: each
     gradient leaf within 1e-3 × its max |g|, the weights after Adam within
     1e-5. Each path's kernel launches per rank (set to 0 just before it,
     read just after) must be positive. Prints halo rows valid / moved and
     exchange ms per rank, peak memory and seconds; one card shows
     correctness, not scaling.
 15. ``[workflow]`` (run last; ``workflow_phase``): the README's commands
     (``genie_tpu_torch.scripts``) as a user runs them, handing over through
     a project directory under ``chip_scratch/``, with run6's
     ``config.yaml`` and the phase-3 stations. A stations.txt and a
     picks.txt of six planted events (timed by the production PINN, with
     amplitudes) plus 1 false pick/s; ``init_project`` as a process of its
     own (``--grid-steps 200``; the files exist; the converted picks equal
     the written ones);
     ``calculate_travel_times build`` as a job array of 8 processes
     (``--job j --n-jobs 374`` for every 47th station, the stations
     ``--job 0 --n-jobs 47`` builds), one table bit-equal to
     ``build_fmm_tables`` in this process; ``calculate_travel_times train
     --steps 100`` (the loss falls; ``load_pinn`` reads the pickle); the
     production PINN then replaces that 100-step one in the project (the
     picks were timed by it); ``train_model --restart --steps 20002`` from
     run6's pickle as ``ckpt.pkl`` (two finite losses, step and Adam count
     20002). Then in this process, on the catalog in memory (no h5py here):
     ``process_continuous_days``' device function ``workflow.process_picks``
     on the project's domain, PINN and checkpoint over 600 s (every planted
     event within 5 km and 0.5 s; the events and the kernel launches those
     of ``InferencePipeline.process`` on the same inputs); ``calibrate``'s
     statistics against the planted events (all matched) and its
     correction fit on homogeneous times (the residual falls);
     ``relocate``'s graphs (20 of up to 32) and 100 GraphDD steps (the
     arrays of the JAX command's shapes, finite). One line per command with its wall seconds
     and peak device memory.
 16. ``[evaluate]`` (run after phase 12; ``evaluate_phase``):
     ``scripts/eval_synthetic.py``'s protocol at its defaults through
     ``genie_tpu_torch.scripts.eval_synthetic`` (32 stations, 2 grids × 200
     sources, batch 8, threshold 0.3, an 1800 s evaluation timeline). First
     the kernel's three round forms and their edge forms at the shapes the
     path launches (32 stations, k = 8; 1 window × 200 sources per training
     forward, 16 × 200 per sweep batch) against the plain version (≤ 1e-4)
     and the ``FusedRound`` backward at the training shape against autograd
     (≤ 1e-4 × max |grad|); then ``evaluate`` trains
     ``Detector(src_chunk=16)`` from flax-default weights for 500 steps cut
     at ``EVAL_BUDGET_S`` (the cut printed), processes the timeline and
     scores it with the bipartite matcher. Gates: at least
     ``EVAL_MIN_STEPS`` steps; the first 10 training batches, replayed from
     the training generator (batch 0 at the initial weights gives step 0's
     loss within 1e-5 relative), have a lower mean loss under the trained
     weights than when they were trained on (the mean of the last 10 steps
     against the first 10 is printed: a step's loss grows with its batch's
     planted events); 5 held-out batches from another generator have a
     lower loss under the trained weights than under the initial ones;
     every loss finite, kernel launches in training and in processing (each
     count set to 0 just before), the JSON keys of the JAX script, and
     ``save_params``' pickle with run6's flax tree names and shapes. The
     trained detector finds nothing at 0.3 after so few steps, so run6's
     weights (the same architecture) then process the same timeline: a
     non-empty, finite catalog and kernel launches after the sweep
     (refinement, association). Last, the port's 3000-step detector
     (``projects/eval_synthetic/params.pkl``, the recipe at the default
     seeds) processes JAX's evaluation timeline
     (``projects/eval_synthetic/timeline_1234.npz``, with JAX's detection
     query grid) at threshold 0.2 under ``held_process_config`` (no
     refinement offsets drawn): the catalog must hold JAX's CPU catalog at
     those weights (``catalog_jax.json``) by ``match_catalog``: the same
     count and matched-catalog counts, each pair in time order within 1 km
     and 0.2 s or, holding the same picks, at the same DE objective (the
     two locators' draws differ; see ``EVAL_COST``), with kernel launches
     in the sweep and after it. ``--score-eval PARAMS:SEED ...`` scores
     saved detectors at 0.2 and 0.3 on that timeline and on their own, and
     stops;
 17. ``[scaling]`` (run after phase 14; ``scaling_phase``):
     ``measure_scaling`` at its defaults (8192 clustered sources × 128
     stations × 30 channels, k 15) with 8 gloo ranks on the card: the
     sharded source mean with and without the halo exchange and the dense
     one, timed with CUDA events; the plan's halo rows (graph built on the
     CPU) must be the JAX run's 2673 valid and 5032 moved
     (``projects/NC_EHZ/measured_scaling_virtual8.json``; the numbers from
     the graph built on the card printed beside) and the sharded mean
     within 1e-5 of the dense; then ``scaling_model --halo-sweep`` at its
     defaults with the card's constants (the fitted slope, the projected
     efficiency with f32 and bf16 wires). ``--shard-nccl`` runs the
     measurement again over NCCL, one rank per card.

It prints per-stage times, event counts, launches, peak memory, the card's
name and power limit, a JSON line describing every kernel, and as its last
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX and needs
no h5py.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
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
    in code (no YAML package needed): the region, the station pad and the
    FMM spacing differ from the ``Config`` defaults; every graph, model and
    process value of that file equals its default."""
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
    cfg.travel_time.dx = 1500.0
    return cfg


def nvidia_smi() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()


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
def round_bound(rows, n_sta, cx, cz, m, h, k, z_is_x, e=0, n_src=0):
    """Least bytes and operations of one launch (each input read once, the
    output written once; every neighbour slot of the table is valid); the
    edge form (e = 4) reads its (n_sta, e) and (n_src, e) tables once."""
    d = cx + cz + e + m
    elems_in = rows * n_sta * (cx + (0 if z_is_x else cz) + cz + m)
    elems_out = rows * n_sta * 2 * h
    small = n_sta * k * 2 + 2 * d * h + 2 * h + 2 + (n_sta + n_src) * e
    nbytes = 4 * (elems_in + elems_out + small)
    flops = rows * n_sta * (2 * k * cz + 2 * 2 * h * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return nbytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(sta_nbr, sta_w, seed: int, n_win: int = 16, n_src: int = 500,
                 dense_entry: bool = True):
    """Kernel vs plain version for the three round forms at run6 widths,
    each also in its edge form (E = 4, the updated model definition, random
    tables in [-1, 1], the range of ``mean_rel_pos_embed``), over ``n_win``
    windows × ``n_src`` sources (16 × 500 = 8000 rows at run6). Returns the
    per-form records of the run6 forms and of the edge forms (launches here
    are comparison launches); each record names the kernel's plan (where Y
    and the neighbour table live)."""
    import torch
    import torch.nn.functional as F

    from genie_tpu_torch.ops.fused_round import (fused_dual_round, fused_round,
                                                 fused_round_plain, kernel_plan)
    from genie_tpu_torch.ops.segment import aggregation_matrix, dense_to_neighbours

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_sta = int(sta_nbr.shape[0])
    rows = n_win * n_src
    k = int(sta_nbr.shape[1])
    a_dense = aggregation_matrix(sta_nbr, n_sta)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    forms = [("round1", 30, 30, 4, 30, True), ("round2", 60, 30, 4, 15, False),
             ("assoc", 30, 30, 5, 30, False)]
    records, edge_records = [], []
    for name, cx, cz, m, h, z_is_x in forms:
        x = randn(rows, n_sta, cx)
        z = x if z_is_x else randn(rows, n_sta, cz)
        agg_src = randn(rows, n_sta, cz)
        mask = (torch.rand((rows, n_sta, m), generator=gen, device=dev) > 0.5).float()
        slopes = torch.tensor([0.25, 0.1], device=dev)
        for e in (0, 4):
            d = cx + cz + e + m
            w1, w2 = randn(h, d, scale=0.2), randn(h, d, scale=0.2)
            b1, b2 = randn(h), randn(h)
            if e:   # the edge form: rows as (windows, sources), per-source table
                shp = (n_win, n_src, n_sta)
                ins = tuple(t.view(*shp, t.shape[-1]) for t in (x, z, agg_src, mask))
                tabs = (torch.rand((n_sta, e), generator=gen, device=dev) * 2 - 1,
                        torch.rand((n_src, e), generator=gen, device=dev) * 2 - 1)
            else:
                ins, tabs = (x, z, agg_src, mask), ()
            args = (*ins, sta_nbr, sta_w, w1, b1, w2, b2, slopes, *tabs)
            label = name if not e else f"{name}+e{e}"
            got = fused_round(*args)
            torch.cuda.synchronize()
            want = fused_round_plain(*args)
            err = float((got - want).abs().max())
            if not np.isfinite(err) or err > TOL:
                fail(f"fused_round {label}: max |kernel - plain| = {err} > {TOL}")
            del got, want

            def library():
                xi, zi, si, mi = ins
                zp = torch.clamp_min(zi, 0) + slopes[0] * torch.clamp_max(zi, 0)
                agg = torch.matmul(a_dense, zp)
                ext1 = ext2 = ()
                if e:
                    ext1 = (tabs[0].expand(*xi.shape[:-1], e),)
                    ext2 = (tabs[1][:, None, :].expand(*xi.shape[:-1], e),)
                h1 = F.linear(torch.cat((xi, agg, *ext1, mi), -1), w1, b1)
                h2 = F.linear(torch.cat((xi, si, *ext2, mi), -1), w2, b2)
                hh = torch.cat((h1, h2), -1)
                return torch.clamp_min(hh, 0) + slopes[1] * torch.clamp_max(hh, 0)

            ms = cuda_time_ms(lambda: fused_round(*args))
            plain_ms = cuda_time_ms(lambda: fused_round_plain(*args), reps=3, warmup=1)
            library_ms = cuda_time_ms(library, reps=3, warmup=1)
            nbytes, flops, bound_ms, bound_by = round_bound(rows, n_sta, cx, cz, m, h,
                                                            k, z_is_x, e, n_src)
            rec = dict(form=label, rows=rows, n_sta=n_sta, cx=cx, cz=cz, m=m, h=h, e=e,
                       k=k, plan=kernel_plan(n_sta, cx, cz, e, m, k, h), max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                       share_of_bound=bound_ms / ms, gb_per_s=nbytes / ms / 1e6,
                       tflop_per_s=flops / ms / 1e9)
            print(f"[kernel] {json.dumps(rec)}", flush=True)
            (edge_records if e else records).append(rec)
            del args, ins
        del x, z, agg_src, mask
        torch.cuda.empty_cache()
    for r0, r4 in zip(records, edge_records):
        print(f"[kernel] {r4['form']} at {n_sta} stations: {r4['ms']:.4f} ms against "
              f"{r0['ms']:.4f} ms (+{100 * (r4['ms'] / r0['ms'] - 1):.1f} %)", flush=True)
    if not dense_entry:
        return records, edge_records

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
    return records, edge_records


# -- phase 3 ---------------------------------------------------------------
def grid_box():
    """The run6 grids (lat/lon/depth and Cartesian) and their lat/lon/depth
    box."""
    z = np.load(GRIDS / "grids_500.npz")
    grids_lla = z["grids_lla"].astype(np.float32)
    lo = grids_lla.reshape(-1, 3).min(0)
    hi = grids_lla.reshape(-1, 3).max(0)
    return grids_lla, z["grids_cart"].astype(np.float32), lo, hi


def draw_stations(cfg, rng, n_sta: int):
    """``n_sta`` stations uniform in the run6 grid box (elevations U[-500,
    1500] m): (lat/lon/elevation f32, Cartesian f32)."""
    from genie_tpu_torch.geometry import Projection

    _, _, lo, hi = grid_box()
    sta_lla = np.stack((rng.uniform(lo[0], hi[0], n_sta),
                        rng.uniform(lo[1], hi[1], n_sta),
                        rng.uniform(-500.0, 1500.0, n_sta)), axis=1)
    proj = Projection.from_center(cfg.region.center)
    return sta_lla.astype(np.float32), proj.to_cart_np(sta_lla).astype(np.float32)


def homogeneous_trv(cfg):
    """Homogeneous travel times at the mean run6 vp/vs."""
    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.models.travel_time import HomogeneousTravelTime

    return HomogeneousTravelTime(Projection.from_center(cfg.region.center),
                                 float(np.mean(cfg.velocity.vp)),
                                 float(np.mean(cfg.velocity.vs)))


def build_domain(cfg, seed: int, dev="cuda"):
    import torch

    from genie_tpu_torch.train.trainer import build_domain_context

    dev = torch.device(dev)
    grids_lla, grids_cart, _, _ = grid_box()
    sta_lla, sta_cart = draw_stations(cfg, np.random.default_rng(seed), cfg.graph.max_sta)
    trv = homogeneous_trv(cfg)
    sta_t = torch.as_tensor(sta_cart, device=dev)
    trv_grids = torch.stack([trv.from_cart(sta_t, torch.as_tensor(g, device=dev))
                             for g in grids_cart])
    ctx = build_domain_context(cfg, sta_lla, sta_cart, grids_lla, grids_cart,
                               trv_grids, dev)
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


def planted_matches(tag, events, picks):
    """Every planted event of ``picks`` must be located within 5 km and
    0.5 s by some catalog event; returns those events per planted event."""
    ev_pos, ev_t = picks[3], picks[4]
    matches = []
    for j in range(len(ev_t)):
        near = [ev for ev in events if abs(ev.time - ev_t[j]) < 0.5
                and np.linalg.norm(ev.pos_cart - ev_pos[j]) < 5e3]
        if not near:
            fail(f"[{tag}] planted event {j} (t={ev_t[j]:.2f} s) not located within "
                 f"5 km and 0.5 s")
        best = min(near, key=lambda ev: np.linalg.norm(ev.pos_cart - ev_pos[j]))
        print(f"[{tag}] planted t={ev_t[j]:.2f} s: event dt {best.time - ev_t[j]:+.3f} s, "
              f"{np.linalg.norm(best.pos_cart - ev_pos[j]) / 1e3:.2f} km, "
              f"{len(best.picks)} picks")
        matches.append(near)
    return matches


# -- phase 4 ---------------------------------------------------------------
def check_sweep_window(pipe, model_cpu, cfg, ctx, trv, picks, x_query, tol=TOL,
                       tag="check", **pipe_kw):
    """One sweep window through the kernel path on the card and through
    the plain path on the CPU (a pipeline of the same ``cfg`` and
    ``pipe_kw``): same query scores within ``tol``."""
    import torch

    from genie_tpu_torch.infer.pipeline import InferencePipeline

    pick_t, pick_sta, pick_ph = picks[:3]
    ctx_cpu = type(ctx)(*[v.cpu() if isinstance(v, torch.Tensor) else v for v in ctx])
    pipe_cpu = InferencePipeline(model_cpu, cfg, ctx_cpu, trv.from_cart,
                                 x_query_grid=x_query, device="cpu", **pipe_kw)
    t0 = float(picks[4][0]) - 3.0
    tp, ip, ph, pm, _ = pipe._window_picks(pick_t, pick_sta, pick_ph, t0)
    got = pipe._sweep_batch(*pipe._to_device([(tp, ip, ph, pm)]), 0).cpu().float()
    want = pipe_cpu._sweep_batch(*pipe_cpu._to_device([(tp, ip, ph, pm)]), 0).float()
    err = float((got - want).abs().max())
    print(f"[{tag}] sweep window, kernel path (cuda) vs plain path (cpu): "
          f"max |diff| = {err:.3e}, max score {float(want.max()):.4f}", flush=True)
    if not np.isfinite(err) or err > tol:
        fail(f"[{tag}] sweep window differs from the CPU plain path by {err}")
    return err


def profile_request(pipe, picks, pick_amp=None, tag="profile", ranges=()):
    """One more request under ``torch.profiler``: device time by kernel
    name, the device busy share (Σ kernel time / host wall time), and the
    device time of the kernels launched inside each ``record_function``
    range named in ``ranges`` (a range nested in another counts in both)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0, pick_amp=pick_amp)
        torch.cuda.synchronize()
        wall = time.time() - t0
    summarize_profile(prof, wall, tag, ranges)


def summarize_profile(prof, wall, tag, ranges=()):
    """Print device time by kernel name, the device busy share and the
    device time inside each named range of a finished profiler run."""
    from torch.autograd import DeviceType

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
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    fused = sum(v[0] for k, v in by_name.items() if "fused_round" in k)
    print(f"[{tag}] " + json.dumps({
        "wall_s": wall, "device_ms": total, "busy_share": total / 1e3 / wall,
        "kernels": sum(v[1] for v in by_name.values()),
        "fused_round_ms": fused, "fused_round_share_of_device": fused / total,
        "ranges_ms": in_range,
        "ranges_share_of_device": {k: v / total for k, v in in_range.items()},
        "top": [{"kernel": k[:90], "ms": v[0], "n": v[1]} for k, v in top]}),
        flush=True)
    return {"device_ms": total, "fused_round_ms": fused, "ranges_ms": in_range}


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


# DE location's shapes: events per call × the population; 1 and 12 events
# are a background and a swarm request's passes, 256 the pipeline's limit
PINN_DE_SHAPES = ((1, 128), (12, 128), (256, 128))


def check_pinn_kernel(cfg, seed: int, n_sta: int = 374, dev="cuda"):
    """The PINN kernel (``ops/pinn_trv.py``) against the plain forward on
    the card at the DE's shapes (:data:`PINN_DE_SHAPES` × ``n_sta``
    stations drawn in the grid box, candidates uniform in the grid box),
    with ``Grids/pinn_nc.pkl``'s weights: the largest |Δt| and the count
    of outputs that differ, the kernel's time, ``from_cart``'s (both
    launches and the wrapper), its bound (operations,
    ``pinn_trv.pair_flops`` at 67 TFLOP/s) and the plain forward's time.
    Returns the records."""
    import torch

    from genie_tpu_torch.ops import pinn_trv
    from genie_tpu_torch.params import load_pinn

    pinn = load_pinn(PINN, device=dev)
    rng = np.random.default_rng(seed + 19)
    _, sta_cart = draw_stations(cfg, rng, n_sta)
    sta = torch.as_tensor(sta_cart, device=dev)
    flat = grid_box()[1].reshape(-1, 3)
    nb = pinn_trv.n_base(pinn.model)
    packed = pinn_trv.pack_weights(pinn.model, pinn.scales)
    records = []
    for n_ev, pop in PINN_DE_SHAPES:
        cand = np.concatenate((rng.uniform(flat.min(0), flat.max(0), (n_ev, pop, 3)),
                               rng.uniform(-30, 30, (n_ev, pop, 1))), -1)
        src = torch.as_tensor(cand, dtype=torch.float32, device=dev)[..., :3]
        with torch.no_grad():
            before = pinn_trv.pinn_trv.launches
            got = pinn.from_cart(sta, src)
            torch.cuda.synchronize()
            launched = pinn_trv.pinn_trv.launches - before
            want = pinn.plain_from_cart(sta, src)
            err = float((got - want).abs().max())
            unequal = int((got != want).sum())
            ms = cuda_time_ms(lambda: pinn_trv.pinn_trv(sta, src, packed, nb))
            from_cart_ms = cuda_time_ms(lambda: pinn.from_cart(sta, src))
            plain_ms = cuda_time_ms(lambda: pinn.plain_from_cart(sta, src), reps=3,
                                    warmup=1)
        del got, want
        n_pairs = n_ev * pop * n_sta
        bound_ms = n_pairs * pinn_trv.pair_flops(nb) / F32_FLOP_PER_S * 1e3
        rec = dict(form="pinn_trv", n_ev=n_ev, sources=n_ev * pop, stations=n_sta,
                   pairs=n_pairs, launches_per_call=launched, max_abs_err_s=err,
                   unequal_to_plain=unequal, ms=ms, from_cart_ms=from_cart_ms,
                   bound_ms=bound_ms,
                   bound_by="operations", share_of_bound=bound_ms / ms,
                   plain_ms=plain_ms, pairs_per_s=n_pairs / ms * 1e3,
                   tflop_per_s=n_pairs * pinn_trv.pair_flops(nb) / ms / 1e9)
        print(f"[kernel] {json.dumps(rec)}", flush=True)
        records.append(rec)
        if launched != 2:
            fail(f"pinn_trv: from_cart launched {launched} kernels, not 2")
        if not np.isfinite(err) or err > 2e-4:
            fail(f"pinn_trv at {n_ev} x {pop} x {n_sta}: max |kernel - plain| = "
                 f"{err} s > 2e-4 s")
        torch.cuda.empty_cache()
    return records


# pinn_trv launches of each path's request, the counter set to 0 just before it
PINN_LAUNCHES = {}


def record_pinn_launches(path: str, launches: int, events: int, pinn: bool):
    """Keep ``path``'s PINN kernel launches for the ``kernels`` line. Fails
    if a path whose travel times are the PINN located events without a
    launch, or a path on homogeneous times launched the kernel."""
    PINN_LAUNCHES[path] = launches
    if pinn and events and launches <= 0:
        fail(f"[{path}] located {events} events through the PINN with no pinn_trv launch")
    if not pinn and launches:
        fail(f"[{path}] homogeneous travel times, yet {launches} pinn_trv launches")


def summed_counts() -> dict:
    """The tracer's counters summed over its requests."""
    from genie_tpu_torch import tracing

    out = {}
    for counts in tracing.export()["counts"].values():
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


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
    planted event must come back located and with its magnitude, and every
    PINN call but the covariance's ``jacfwd`` (one a location pass) must
    take the kernel. Returns the fused-round launches of the second request
    and the picks."""
    import torch

    from genie_tpu_torch import tracing
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.ops.pinn_trv import pinn_trv

    picks = make_picks(ctx, trv, seed, mag=mag)
    amp, ev_mag = picks[5], picks[6]
    print(f"[production] {len(picks[0])} picks over 600 s, {len(picks[3])} planted "
          f"events, M {np.round(ev_mag, 2).tolist()}", flush=True)
    results = []
    for call in range(2):
        torch.cuda.reset_peak_memory_stats()
        fused_round.launches = 0
        pinn_trv.launches = 0
        tracing.reset()
        tracing.enable()
        try:
            t0 = time.time()
            events = pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0, pick_amp=amp)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            tracing.record_with_profiler()
        launches = fused_round.launches
        counts = summed_counts()
        tracing.reset()
        results.append((events, launches, wall, dict(pipe.stage_seconds),
                        torch.cuda.max_memory_allocated()))
        print(f"[production] call {call + 1}: {len(events)} events, {launches} "
              f"fused_round launches, {pinn_trv.launches} pinn_trv launches, "
              f"{counts.get('trv.plain_calls', 0)} plain PINN calls in "
              f"{counts.get('locate.passes', 0)} location passes, {wall:.2f} s", flush=True)
    events, launches, wall, stages, peak = results[-1]
    if launches <= 0:
        fail("the production path launched the fused_round kernel 0 times")
    record_pinn_launches("production", pinn_trv.launches, len(events), pinn=True)
    if counts.get("trv.plain_calls", 0) != counts.get("locate.passes", 0):
        fail(f"[production] {counts.get('trv.plain_calls', 0)} PINN calls took the plain "
             f"forward in {counts.get('locate.passes', 0)} location passes: only the "
             f"covariance's jacfwd, one a pass, should")
    for ev in events:
        if not (np.isfinite(ev.pos_cart).all() and np.isfinite(ev.time)
                and ev.mag is not None and np.isfinite(ev.mag)):
            fail(f"malformed production event {ev}")
    for j, near in enumerate(planted_matches("production", events, picks)):
        print(f"[production] planted event {j}: M {ev_mag[j]:.2f}, located "
              f"M {[round(ev.mag, 2) for ev in near]}")
        if min(abs(ev.mag - ev_mag[j]) for ev in near) > 0.25:
            fail(f"planted event {j}: magnitude off by more than 0.25")
    print("[stages] production, second call, host seconds: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    print(f"[production] events {len(events)}, fused_round launches {launches}, "
          f"pinn_trv launches {pinn_trv.launches}, "
          f"wall {wall:.3f} s, max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    profile_request(pipe, picks, pick_amp=amp, tag="profile production",
                    ranges=("trv", "pinn"))
    return launches, picks


# -- phase 7 ---------------------------------------------------------------
def locate_at_limits(ctx, trv, pinn, seed: int, n_ev: int = 256, n_pick: int = 48,
                     popsize: int = 128, n_iter: int = 150, dev="cuda"):
    """One DE location call through the corrected PINN at the pipeline's
    batch limit: ``n_ev`` planted sources, each picked at its ``n_pick / 2``
    nearest stations (P and S, 0.1 s noise)."""
    import torch

    from genie_tpu_torch.infer.locate import locate_sources_batched
    from genie_tpu_torch.ops.pinn_trv import pinn_trv

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
    pinn_trv.launches = 0
    t0 = time.time()
    loc, t_org, _ = run()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    record_pinn_launches("locate_at_limits", pinn_trv.launches, n_ev, pinn=True)
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


# -- phase 8 ---------------------------------------------------------------
def run6_train_config():
    """run6's ``synth:`` and ``train:`` blocks on top of its inference
    settings; every other value of those two blocks equals its default."""
    cfg = run6_config()
    s, t = cfg.synth, cfg.train
    s.T, s.max_rate_events, s.dist_range = 3600.0, 40.0, (15000.0, 350000.0)
    s.max_events, s.n_false_max = 96, 2048
    t.n_batch, t.n_spc_query, t.n_src_query, t.lr = 8, 2000, 96, 0.0005
    t.loss_weights = (0.3, 0.5, 0.1, 0.1)
    t.sequential_windows, t.positive_boost = True, 100.0
    return cfg


def check_backward(sta_nbr, sta_w, seed: int, dev="cuda", e: int = 0,
                   lead=(16, 500), tag="train-check"):
    """(i) ``FusedRound``'s backward on the card against autograd through
    ``fused_round_plain`` on the card, for the three round forms of
    ``check_kernel`` at ``lead`` windows × sources (16 × 500 = 8000 rows at
    run6) × the stations of ``sta_nbr``, or their edge forms with ``e = 4``
    (W1's and W2's edge columns take gradients, the tables none): max
    |Δgrad| of each input ≤ TOL × its max |grad|. Returns per-form records
    with both backward times."""
    import torch

    from genie_tpu_torch.ops.fused_round import FusedRound, fused_round_plain

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 5 + e)
    n_sta = int(sta_nbr.shape[0])

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    names = ("x", "z", "agg_src", "w1", "b1", "w2", "b2", "slopes")
    tabs = ((torch.rand((n_sta, e), generator=gen, device=dev) * 2 - 1,
             torch.rand((lead[1], e), generator=gen, device=dev) * 2 - 1) if e else ())
    records = []
    for form, cx, cz, m, h, z_is_x in (("round1", 30, 30, 4, 30, True),
                                       ("round2", 60, 30, 4, 15, False),
                                       ("assoc", 30, 30, 5, 30, False)):
        d = cx + cz + e + m
        x = randn(*lead, n_sta, cx).requires_grad_()
        z = x if z_is_x else randn(*lead, n_sta, cz).requires_grad_()
        agg_src = randn(*lead, n_sta, cz).requires_grad_()
        mask = (torch.rand((*lead, n_sta, m), generator=gen, device=dev) > 0.5).float()
        params = [randn(h, d, scale=0.2), randn(h), randn(h, d, scale=0.2), randn(h)]
        params = [p.requires_grad_() for p in params]
        slopes = torch.tensor([0.25, 0.1], device=dev, requires_grad=True)
        args = (x, z, agg_src, mask, sta_nbr, sta_w, *params, slopes, *tabs)
        leaves = [x] + ([] if z_is_x else [z]) + [agg_src, *params, slopes]
        leaf_names = [n for n in names if not (z_is_x and n == "z")]
        g_out = randn(*lead, n_sta, 2 * h)
        form = form if not e else f"{form}+e{e}"

        def grads(fn):
            return torch.autograd.grad(fn(*args), leaves, g_out)

        got = grads(FusedRound.apply)
        want = grads(fused_round_plain)
        rel = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for n, a, b in zip(leaf_names, got, want)}
        worst = max(rel.values())
        if not np.isfinite(worst) or worst > TOL:
            fail(f"FusedRound backward {form}: max |Δgrad|/max|grad| {rel} > {TOL}")
        del got, want
        out_k = FusedRound.apply(*args)
        out_p = fused_round_plain(*args)
        bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(out_k, leaves, g_out,
                                                          retain_graph=True), reps=3)
        bwd_plain_ms = cuda_time_ms(lambda: torch.autograd.grad(
            out_p, leaves, g_out, retain_graph=True), reps=3, warmup=1)
        rec = dict(form=form, rows=lead[0] * lead[1], n_sta=n_sta, max_rel_grad_err=worst,
                   rel_grad_err=rel, backward_ms=bwd_ms, plain_backward_ms=bwd_plain_ms)
        print(f"[{tag}] backward {json.dumps(rec)}", flush=True)
        records.append(rec)
        del out_k, out_p, x, z, agg_src, mask, args, leaves, g_out
        torch.cuda.empty_cache()
    return records


def check_train_window(cfg, ctx, seed: int, dev="cuda", make_model=None,
                       trv_pair=None, tag="train-check"):
    """(ii) one window's total loss and parameter gradients through the
    kernel path on the card against the plain path on the CPU, run6
    weights (or ``make_model()``, called once per side), PINN travel times
    (or ``trv_pair``, card and CPU): loss within TOL relative, each
    gradient tensor within 1e-3 × its max |g|."""
    import torch

    from genie_tpu_torch.params import load_pinn
    from genie_tpu_torch.train.trainer import generate_batch, loss_fn

    cfg1 = copy.deepcopy(cfg)
    cfg1.train.n_batch = 1
    make_model = make_model or (lambda: load_model(cfg))
    pinn, pinn_cpu = trv_pair or (load_pinn(PINN, device=dev), load_pinn(PINN, device="cpu"))
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    wb = generate_batch(gen, cfg1, ctx, pinn.from_cart)
    ctx_cpu = type(ctx)(*[v.cpu() if isinstance(v, torch.Tensor) else v for v in ctx])
    wb_cpu = type(wb)(*[v.cpu() for v in wb])
    out = {}
    for side, model, c, w, trv in (("cuda", make_model().to(dev), ctx, wb, pinn),
                                   ("cpu", make_model(), ctx_cpu, wb_cpu, pinn_cpu)):
        t0 = time.time()
        total, (parts, trgts, preds) = loss_fn(model, c, cfg1, w, trv.from_cart,
                                               backward=True)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        out[side] = (float(total), parts.cpu().numpy(), grads, time.time() - t0)
    (l_k, parts_k, g_k, s_k), (l_p, parts_p, g_p, s_p) = out["cuda"], out["cpu"]
    loss_rel = abs(l_k - l_p) / max(abs(l_p), 1e-30)
    grad_rel = {n: float((g_k[n] - g_p[n]).abs().max() / g_p[n].abs().max().clamp_min(1e-30))
                for n in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[{tag}] window " + json.dumps({
        "loss_cuda": l_k, "loss_cpu": l_p, "loss_rel": loss_rel,
        "parts_cuda": parts_k.tolist(), "parts_cpu": parts_p.tolist(),
        "picks": int(wb.pick_mask.sum()), "max_rel_grad_err": grad_rel[worst],
        "worst_param": worst, "n_params": len(grad_rel),
        "cuda_s": s_k, "cpu_s": s_p}), flush=True)
    if not (np.isfinite(l_k) and np.isfinite(l_p)) or loss_rel > TOL:
        fail(f"[{tag}] training loss on the card {l_k} vs the CPU plain path {l_p}")
    if not np.isfinite(grad_rel[worst]) or grad_rel[worst] > 1e-3:
        fail(f"[{tag}] gradient of {worst} differs from the CPU plain path by "
             f"{grad_rel[worst]} of its max |g|")


def train_phase(cfg, ctx, pinn, seed: int, card: str, dev="cuda"):
    """Phase 8: checks (ii), then three resumed steps of ``workflow.train``
    (the main path, launch counts set to 0 just before), then one profiled
    step. Returns the forward launches of the three steps."""
    import torch

    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.params import load_flax_params, load_into
    from genie_tpu_torch.train.trainer import (adam_state, build_domain_context,
                                               make_train_step, step_seed)
    from genie_tpu_torch.utils import compute_travel_times_chunked
    from genie_tpu_torch.workflow import train

    t0 = time.time()
    with torch.no_grad():
        pinn_grids = torch.stack([compute_travel_times_chunked(pinn.from_cart, ctx.sta_cart, g)
                                  for g in ctx.grids_cart])
    ctx_t = build_domain_context(cfg, ctx.sta_lla, ctx.sta_cart, ctx.grids_lla,
                                 ctx.grids_cart, pinn_grids, dev)
    torch.cuda.synchronize()
    print(f"[train] domain: PINN grid tables, no corrections, no subnetworks; "
          f"set up in {time.time() - t0:.1f} s", flush=True)
    check_train_window(cfg, ctx_t, seed, dev)

    start, n_steps = 20000, 3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_round.launches = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out:
        model, state, history = train(cfg, ctx_t, pinn, out, n_steps=start + n_steps,
                                      log_every=1, seed=seed,
                                      restart=RUN6 / "params.pkl")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused_round.launches
    peak = torch.cuda.max_memory_allocated()
    per_step = 4 * cfg.train.n_batch
    if launches != per_step * n_steps:
        fail(f"[train] {launches} fused_round launches in {n_steps} steps, "
             f"expected {per_step * n_steps}")
    for i, (m, st) in enumerate(history):
        print(f"[train] step {start + i}: " + json.dumps({
            "loss": m["loss"], "parts": [m["loss_grid"], m["loss_query"], m["loss_p"],
                                         m["loss_s"]],
            "trgts": m["trgts"].tolist(), "preds": m["preds"].tolist(),
            "stage_s": st, "step_s": sum(st.values())}), flush=True)
        if not np.isfinite(m["loss"]):
            fail(f"[train] step {start + i}: loss is not finite")
    if state.step != start + n_steps:
        fail(f"[train] resumed run ended at step {state.step}")

    # one more step under the profiler, its launches counted on their own
    step_fn = make_train_step(cfg, ctx_t, pinn.from_cart)
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, state.step))
    from torch.profiler import ProfilerActivity, profile

    fused_round.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        state, metrics = step_fn(state, gen)
        torch.cuda.synchronize()
        wall_p = time.time() - t1
    launches_p = fused_round.launches
    prof_sum = summarize_profile(prof, wall_p, "profile train", ranges=(
        "generate", "forward_backward", "optimizer", "FusedRound", "FusedRoundBackward"))
    count = adam_state(state.optimizer, model)["count"]
    ref = load_into(load_model(cfg), load_flax_params(RUN6 / "params.pkl")).to(dev)
    moved = max(float((p - q).abs().max()) for p, q in zip(
        model.state_dict().values(), ref.state_dict().values()))
    steady = [sum(st.values()) for _, st in history[1:]]
    summary = {
        "card": card, "steps": n_steps + 1, "windows_per_step": cfg.train.n_batch,
        "wall_s_3_steps": wall, "s_per_step": float(np.mean(steady)),
        "stage_s_mean": {k: float(np.mean([st[k] for _, st in history[1:]]))
                         for k in history[0][1]},
        "fused_round_launches_per_step": launches / n_steps,
        "profiled_step_launches": launches_p, "profiled_step_wall_s": wall_p,
        "max_memory_allocated_bytes": peak, "peak_gib": peak / 2**30,
        "adam_count": count, "max_abs_weight_change": moved,
        "profiled_loss": float(metrics["loss"])}
    if prof_sum is not None:
        r = prof_sum["ranges_ms"]
        summary.update({
            "device_ms_profiled_step": prof_sum["device_ms"],
            "fused_round_forward_share_of_device": prof_sum["fused_round_ms"]
            / prof_sum["device_ms"],
            "fused_round_backward_share_of_device": r["FusedRoundBackward"]
            / prof_sum["device_ms"]})
    print("[train] " + json.dumps(summary), flush=True)
    if count != start + n_steps + 1:
        fail(f"[train] Adam count {count}, expected {start + n_steps + 1}")
    if not np.isfinite(float(metrics["loss"])) or not moved > 0.0:
        fail("[train] the profiled step's loss is not finite or the weights did not move")
    if launches_p != per_step:
        fail(f"[train] the profiled step launched the kernel {launches_p} times")
    return launches


# -- phase 12 (after phase 8) ------------------------------------------------
MODEL_OPTIONS = ("use_updated_model_definition", "use_absolute_pos", "normalize_readin")


def options_model(cfg, seed: int, dev="cpu"):
    """The detector with the three model options that run6 leaves off, on
    ``dev`` at flax-default weights from a generator there seeded with
    ``seed``, as ``workflow.train`` initialises it (the same weights at
    every call)."""
    import torch

    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.models.init import init_detector

    model = Detector(scale_rel=cfg.model.scale_rel, kernel_sig_t=cfg.model.kernel_sig_t,
                     use_phase_types=cfg.model.use_phase_types,
                     **{o: True for o in MODEL_OPTIONS}).to(dev)
    return init_detector(model, torch.Generator(device=dev).manual_seed(seed))


def timed_request(pipe, picks):
    """One ``process`` with the kernel launch count set to 0 just before:
    (events, launches, wall seconds)."""
    import torch

    from genie_tpu_torch.ops.fused_round import fused_round

    torch.cuda.synchronize()
    fused_round.launches = 0
    t0 = time.time()
    events = pipe.process(picks[0], picks[1], picks[2], 0.0, 600.0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    for ev in events:
        if not (np.isfinite(ev.pos_cart).all() and np.isfinite(ev.time)):
            fail(f"malformed catalog event {ev}")
    return events, fused_round.launches, wall


def options_phase(cfg_inf, ctx, trv, x_query, picks, sta_nbr, sta_w, seed: int,
                  card: str, dev="cuda"):
    """Phase 12, ``[options]``: the detector and pipeline options that
    run6's config leaves off, on the phase-3 domain (homogeneous travel
    times). (a) The edge form's backward (``check_backward`` with E = 4).
    (b) Training with ``use_updated_model_definition``, ``use_absolute_pos``
    and ``normalize_readin`` on run6's ``synth:``/``train:`` blocks: one
    window's loss and gradients card vs CPU at flax-default weights, then
    ``workflow.train`` from flax-default weights for 3 steps (launch count
    set to 0 before; 32 forward launches per step) and one profiled step;
    every loss finite, the weights and ``read_in.sum_gain`` must move.
    (c) Serving those weights with ``cfg.graph.use_subgraph`` at the config
    defaults (1.5°, k 30): the kept share of the pairs, one ``process`` of
    the phase-4 picks with launches counted and one sweep window card vs CPU
    within TOL. The weights are four steps old, so no detection quality is
    asked of them. (d) The bf16-weight sweep with run6's weights:
    ``detection_sweep`` with ``sweep_half`` against the f32 sweep (max |Δ| ≤
    0.05), one window card vs CPU within 1e-3 (f16 spacing near 1 is
    4.9e-4), and a ``process`` with ``sweep_half`` that locates the six
    planted events within 5 km and 0.5 s. Returns (the edge-form backward
    records, the launches of each driven path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.train.trainer import (build_domain_context, make_train_step,
                                               step_seed)
    from genie_tpu_torch.workflow import train

    t_phase = time.time()
    launches = {}
    bwd = check_backward(sta_nbr, sta_w, seed, dev, e=4)

    # (b) training with the three model options
    cfg = run6_train_config()
    for o in MODEL_OPTIONS:
        setattr(cfg.model, o, True)
    ctx_t = build_domain_context(cfg, ctx.sta_lla, ctx.sta_cart, ctx.grids_lla,
                                 ctx.grids_cart, ctx.trv_grids, dev)
    check_train_window(cfg, ctx_t, seed, dev, make_model=lambda: options_model(cfg, seed),
                       trv_pair=(trv, trv), tag="options-check")
    n_steps = 3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_round.launches = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out:
        model, state, history = train(cfg, ctx_t, trv, out, n_steps=n_steps,
                                      log_every=1, seed=seed)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches["train"] = fused_round.launches
    peak = torch.cuda.max_memory_allocated()
    per_step = 4 * cfg.train.n_batch
    if launches["train"] != per_step * n_steps:
        fail(f"[options] {launches['train']} fused_round launches in {n_steps} steps, "
             f"expected {per_step * n_steps}")
    for i, (m, st) in enumerate(history):
        print(f"[options] train step {i}: " + json.dumps({
            "loss": m["loss"], "parts": [m["loss_grid"], m["loss_query"], m["loss_p"],
                                         m["loss_s"]],
            "stage_s": st, "step_s": sum(st.values())}), flush=True)
        if not np.isfinite(m["loss"]):
            fail(f"[options] train step {i}: loss is not finite")
    step_fn = make_train_step(cfg, ctx_t, trv.from_cart)
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, state.step))
    fused_round.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        state, metrics = step_fn(state, gen)
        torch.cuda.synchronize()
        wall_p = time.time() - t1
    launches_p = fused_round.launches
    prof_sum = summarize_profile(prof, wall_p, "profile options train", ranges=(
        "generate", "forward_backward", "optimizer", "FusedRound", "FusedRoundBackward"))
    ref = options_model(cfg, seed, dev)     # train()'s own initial weights
    moved = max(float((p - q).abs().max()) for p, q in zip(
        model.state_dict().values(), ref.state_dict().values()))
    gain = float(model.read_in.sum_gain.detach())
    steady = [sum(st.values()) for _, st in history[1:]]
    summary = {
        "card": card, "options": list(MODEL_OPTIONS), "steps": n_steps + 1,
        "wall_s_3_steps": wall, "s_per_step": float(np.mean(steady)),
        "fused_round_launches_per_step": launches["train"] / n_steps,
        "profiled_step_launches": launches_p, "profiled_step_wall_s": wall_p,
        "max_memory_allocated_bytes": peak, "peak_gib": peak / 2**30,
        "max_abs_weight_change": moved, "sum_gain": gain,
        "profiled_loss": float(metrics["loss"])}
    if prof_sum is not None:
        summary.update({
            "device_ms_profiled_step": prof_sum["device_ms"],
            "fused_round_forward_share_of_device": prof_sum["fused_round_ms"]
            / prof_sum["device_ms"],
            "fused_round_backward_share_of_device":
                prof_sum["ranges_ms"]["FusedRoundBackward"] / prof_sum["device_ms"]})
    print("[options] train " + json.dumps(summary), flush=True)
    if not np.isfinite(float(metrics["loss"])) or not moved > 0.0 or gain == 8.0:
        fail("[options] the profiled step's loss is not finite, or the weights or "
             "read_in.sum_gain did not move")
    if launches_p != per_step:
        fail(f"[options] the profiled step launched the kernel {launches_p} times")

    # (c) those weights served with subgraph pair masks
    model = model.eval().requires_grad_(False)
    cfg_s = copy.deepcopy(cfg_inf)
    cfg_s.graph.use_subgraph = True
    pipe = InferencePipeline(model, cfg_s, ctx, trv.from_cart, x_query_grid=x_query,
                             device=dev)
    kept = [float(m.float().mean()) for m in pipe._pair_masks]
    events, launches["subgraph"], wall_s = timed_request(pipe, picks)
    if launches["subgraph"] <= 0:
        fail("[options] the subgraph request launched the fused_round kernel 0 times")
    model_cpu = options_model(cfg, seed)
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    err_s = check_sweep_window(pipe, model_cpu, cfg_s, ctx, trv, picks, x_query,
                               tag="options-check subgraph")
    print("[options] subgraph " + json.dumps({
        "max_deg_offset": cfg_s.graph.max_deg_offset,
        "k_nearest_pairs": cfg_s.graph.k_nearest_pairs, "kept_share_by_grid": kept,
        "events": len(events), "fused_round_launches": launches["subgraph"],
        "wall_s": wall_s, "stage_s": dict(pipe.stage_seconds),
        "sweep_window_max_abs_diff": err_s}), flush=True)
    del pipe, model, model_cpu

    # (d) the bf16-weight sweep with run6's weights
    pipe_f = InferencePipeline(load_model(cfg_inf), cfg_inf, ctx, trv.from_cart,
                               x_query_grid=x_query, device=dev)
    pipe_h = InferencePipeline(load_model(cfg_inf), cfg_inf, ctx, trv.from_cart,
                               x_query_grid=x_query, sweep_half=True, device=dev)
    _, s32 = pipe_f.detection_sweep(picks[0], picks[1], picks[2], 0.0, 600.0)
    torch.cuda.synchronize()
    fused_round.launches = 0
    t0 = time.time()
    _, s16 = pipe_h.detection_sweep(picks[0], picks[1], picks[2], 0.0, 600.0)
    torch.cuda.synchronize()
    wall_sweep = time.time() - t0
    launches["sweep_half"] = fused_round.launches
    d_sweep = float(np.abs(s32 - s16).max())
    err_h = check_sweep_window(pipe_h, load_model(cfg_inf), cfg_inf, ctx, trv, picks,
                               x_query, tol=1e-3, tag="options-check bf16",
                               sweep_half=True)
    events, launches["process_sweep_half"], wall_h = timed_request(pipe_h, picks)
    planted_matches("options bf16", events, picks)
    print("[options] bf16 sweep " + json.dumps({
        "max_abs_diff_vs_f32_sweep": d_sweep, "series_max": float(s32.max()),
        "sweep_launches": launches["sweep_half"], "sweep_wall_s": wall_sweep,
        "sweep_window_max_abs_diff": err_h, "events": len(events),
        "process_launches": launches["process_sweep_half"], "process_wall_s": wall_h}),
        flush=True)
    if not np.isfinite(d_sweep) or d_sweep > 0.05:
        fail(f"[options] the bf16-weight sweep differs from the f32 sweep by {d_sweep}")
    if launches["sweep_half"] <= 0 or launches["process_sweep_half"] <= 0:
        fail("[options] the bf16-weight sweep launched the fused_round kernel 0 times")
    del pipe_f, pipe_h
    torch.cuda.empty_cache()
    print(f"[options] phase {time.time() - t_phase:.1f} s", flush=True)
    return bwd, launches


# -- phase 9 ---------------------------------------------------------------
def _timed(fn):
    """(result, host seconds with a device sync, peak bytes allocated)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated()


def calibrate_phase(ctx, pinn, seed: int, dev="cuda"):
    """Phase 9, ``[calibrate]``: the calibration fits at run6's sizes and
    the DE relocation benchmark, each also on the CPU for 20 steps to hold
    the card to it. Returns the per-stage records."""
    import torch

    from genie_tpu_torch.calibration.corrections import (TravelTimeCorrection,
                                                         fit_corrections,
                                                         interp_weighted,
                                                         relocation_benchmark)
    from genie_tpu_torch.models.magnitude import fit_magnitude_model
    from genie_tpu_torch.params import load_pinn

    rng = np.random.default_rng(seed + 7)
    pinn_cpu = load_pinn(PINN, device="cpu")
    sta = ctx.sta_cart.cpu().numpy()
    n_sta = len(sta)
    lo = ctx.offset_cart.cpu().numpy()
    hi = lo + ctx.scale_cart.cpu().numpy()
    grid = np.load(CORRECTIONS)["grid_cart"].astype(np.float32)
    rec = {}

    # fit_corrections: 56 reference events, P and S at their 15 nearest
    # stations, PINN times + a per-(station, phase) bias + noise
    n_ev = 56
    src = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n_ev, 3))
    src[:, 2] = rng.uniform(-20e3, -3e3, n_ev)
    src = src.astype(np.float32)
    with torch.no_grad():
        tt = pinn.from_cart(ctx.sta_cart, torch.as_tensor(src, device=dev)).cpu().numpy()
    bias = rng.normal(0, 0.3, (n_sta, 2))
    near = np.argsort(np.linalg.norm(sta[None, :, :2] - src[:, None, :2], axis=-1),
                      axis=1)[:, :15]
    obs = np.zeros((n_ev, n_sta, 2), np.float32)
    mask = np.zeros_like(obs)
    for e in range(n_ev):
        s = near[e]
        obs[e, s] = tt[e, s] + bias[s] + rng.normal(0, 0.05, (len(s), 2))
        mask[e, s] = 1.0
    m = mask > 0

    def mean_resid(coefs=None):
        pred = tt if coefs is None else tt + interp_weighted(
            torch.as_tensor(grid), coefs.cpu(), torch.as_tensor(src)).numpy()
        return float(np.abs(obs - pred)[m].mean())

    n_steps = 1500
    (coefs, loss), secs, peak = _timed(lambda: fit_corrections(
        pinn.from_cart, ctx.sta_cart, grid, src, obs, mask, n_steps=n_steps, device=dev))
    before, after = mean_resid(), mean_resid(coefs)
    c20, _ = fit_corrections(pinn.from_cart, ctx.sta_cart, grid, src, obs, mask,
                             n_steps=20, device=dev)
    c20_cpu, _ = fit_corrections(pinn_cpu.from_cart, sta, grid, src, obs, mask,
                                 n_steps=20, device="cpu")
    err20 = float((c20.cpu() - c20_cpu).abs().max())
    rec["fit_corrections"] = {
        "events": n_ev, "picks": int(mask.sum()), "grid_nodes": len(grid),
        "stations": n_sta, "steps": n_steps, "seconds": secs, "s_per_step": secs / n_steps,
        "peak_bytes": peak, "fit_loss": loss, "mean_abs_resid_before_s": before,
        "mean_abs_resid_after_s": after, "card_vs_cpu_20_steps_max_abs_s": err20}
    print("[calibrate] fit_corrections " + json.dumps(rec["fit_corrections"]), flush=True)
    if not (np.isfinite(after) and after < 0.5 * before):
        fail(f"[calibrate] fit_corrections: mean |residual| {after} s, not under half "
             f"of {before} s")
    if not err20 <= 1e-4:
        fail(f"[calibrate] fit_corrections after 20 steps: card vs CPU {err20} s > 1e-4")

    # fit_magnitude_model: about 6000 amplitudes of 300 events, 25 % holdout
    n_mev = 300
    mev = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n_mev, 3))
    mev[:, 2] = rng.uniform(-20e3, -3e3, n_mev)
    mev = mev.astype(np.float32)
    mags = rng.uniform(0.5, 4.0, n_mev)
    sta_bias = rng.normal(0, 0.2, (n_sta, 2))
    o_src, o_sta, o_ph, o_amp, o_mag, o_ev = [], [], [], [], [], []
    for e in range(n_mev):
        d = np.linalg.norm(sta[:, :2] - mev[e, :2], axis=1)
        cand = np.where(d < 150e3)[0]
        cand = cand if len(cand) >= 10 else np.argsort(d)[:10]
        for s in rng.choice(cand, 10, replace=False):
            for ph in (0, 1):
                d_epi = np.linalg.norm(mev[e, :2] - sta[s, :2])
                d_dep = abs(mev[e, 2] - sta[s, 2])
                o_src.append(mev[e])
                o_sta.append(s)
                o_ph.append(ph)
                o_amp.append(mags[e] - 1.4 * np.log10(d_epi + 1.0)
                             + 0.3 * np.log10(d_dep + 1.0) + sta_bias[s, ph]
                             + rng.normal(0, 0.1))
                o_mag.append(mags[e])
                o_ev.append(e)
    o_src = np.asarray(o_src, np.float32)
    o_sta, o_ph, o_ev = (np.asarray(v, np.int64) for v in (o_sta, o_ph, o_ev))
    o_amp, o_mag = np.asarray(o_amp, np.float32), np.asarray(o_mag, np.float32)
    vald = rng.choice(n_mev, n_mev // 4, replace=False)
    vm = np.isin(o_ev, vald)
    tm = ~vm
    # bias support: 8 nodes from 10 Lloyd iterations, as nc_magnitude.py does
    uniq = np.unique(o_src, axis=0)
    mgrid = uniq[rng.choice(len(uniq), 8, replace=False)].copy()
    for _ in range(10):
        lab = np.linalg.norm(uniq[:, None] - mgrid[None], axis=2).argmin(1)
        for g in range(8):
            if (lab == g).any():
                mgrid[g] = uniq[lab == g].mean(0)
    fit_args = (sta, mgrid, o_src[tm], o_sta[tm], o_ph[tm], o_amp[tm], o_mag[tm])
    n_steps = 3000
    model, secs, peak = _timed(lambda: fit_magnitude_model(
        *fit_args, n_steps=n_steps, w_bias_reg=3.0, device=dev))
    with torch.no_grad():
        inv = model(torch.as_tensor(o_src[vm], device=dev), ctx.sta_cart,
                    torch.as_tensor(mgrid, device=dev),
                    torch.as_tensor(o_sta[vm], device=dev),
                    torch.as_tensor(o_ph[vm], device=dev),
                    log_amp=torch.as_tensor(o_amp[vm], device=dev)).cpu().numpy()
    ev_err = [abs(np.median(inv[o_ev[vm] == e]) - mags[e]) for e in np.unique(o_ev[vm])]
    m20 = fit_magnitude_model(*fit_args, n_steps=20, w_bias_reg=3.0, device=dev)
    m20_cpu = fit_magnitude_model(*fit_args, n_steps=20, w_bias_reg=3.0, device="cpu")
    merr = max(float((p.detach().cpu() - q.detach()).abs().max())
               for p, q in zip(m20.parameters(), m20_cpu.parameters()))
    rec["fit_magnitude_model"] = {
        "events": n_mev, "observations": len(o_amp), "train_observations": int(tm.sum()),
        "holdout_events": len(ev_err), "grid_nodes": 8, "steps": n_steps,
        "seconds": secs, "s_per_step": secs / n_steps, "peak_bytes": peak,
        "holdout_median_abs_dM": float(np.median(ev_err)),
        "holdout_p90_abs_dM": float(np.quantile(ev_err, 0.9)),
        "card_vs_cpu_20_steps_max_abs": merr}
    print("[calibrate] fit_magnitude_model " + json.dumps(rec["fit_magnitude_model"]),
          flush=True)
    if not np.median(ev_err) < 0.25:
        fail(f"[calibrate] holdout median |dM| {np.median(ev_err)} >= 0.25")
    if not merr <= 1e-5:
        fail(f"[calibrate] fit_magnitude_model after 20 steps: card vs CPU {merr} > 1e-5")

    # relocation_benchmark: the 56 events from perturbed starts through the
    # PINN wrapped in the corrections just fitted
    t0 = rng.uniform(0.0, 600.0, n_ev).astype(np.float32)
    target = np.concatenate((src, t0[:, None]), axis=1)
    init = (target + np.concatenate((rng.normal(0, 5e3, (n_ev, 3)),
                                     rng.normal(0, 1.0, (n_ev, 1))), axis=1)
            ).astype(np.float32)
    ev_idx, sta_idx = np.nonzero(m.any(axis=2))
    pick_ev = np.repeat(ev_idx, 2)
    pick_sta = np.repeat(sta_idx, 2)
    pick_ph = np.tile([0.0, 1.0], len(ev_idx)).astype(np.float32)
    pick_t = (t0[pick_ev] + obs[pick_ev, pick_sta, pick_ph.astype(int)]).astype(np.float32)
    trv = TravelTimeCorrection(pinn.from_cart, grid, coefs).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bounds_lo = np.concatenate((lo, [-30.0]))
    bounds_hi = np.concatenate((hi, [630.0]))
    out, secs, peak = _timed(lambda: relocation_benchmark(
        gen, trv.from_cart, sta, init, target, pick_t, pick_sta, pick_ph, pick_ev,
        bounds_lo, bounds_hi, grid_cart=grid, max_picks=64, popsize=96, n_iter=120,
        device=dev))
    rec["relocation_benchmark"] = {
        "events": n_ev, "picks": len(pick_t), "popsize": 96, "n_iter": 120,
        "pairs_per_objective": n_ev * 96 * n_sta, "seconds": secs, "peak_bytes": peak,
        "initial": out["initial"], "relocated": out["relocated"],
        "bias_initial": out.get("bias_initial"),
        "bias_relocated": out.get("bias_relocated")}
    print("[calibrate] relocation_benchmark " + json.dumps(rec["relocation_benchmark"]),
          flush=True)
    if not np.isfinite(out["srcs_relocated"]).all():
        fail("[calibrate] relocation_benchmark gave non-finite sources")
    if not out["relocated"]["horizontal_m"] < 0.5 * out["initial"]["horizontal_m"]:
        fail(f"[calibrate] relocated horizontal {out['relocated']['horizontal_m']} m, not "
             f"under half of {out['initial']['horizontal_m']} m")
    print("[calibrate] " + json.dumps({k: {"seconds": v["seconds"],
                                           "peak_gib": v["peak_bytes"] / 2**30}
                                       for k, v in rec.items()}), flush=True)
    return rec


# -- phase 10 --------------------------------------------------------------
# train_graphdd's 3000 steps are cut to fit this budget, down to this floor
RELOCATE_BUDGET_S = 50.0
RELOCATE_MIN_STEPS = 750


def relocate_phase(ctx, trv_h, pinn, seed: int, dev="cuda", full_steps: int = 3000):
    """Phase 10, ``[relocate]``: GraphDD at the sizes of run6's relocation
    artifact: the loss and gradients of one graph card vs CPU at
    flax-default weights, ``train_graphdd`` (cut to the largest multiple of
    250 steps, at least ``RELOCATE_MIN_STEPS``, that fits
    ``RELOCATE_BUDGET_S`` when 3000 do not), ``relocate`` of every graph
    averaged per source, one profiled step."""
    import torch

    from genie_tpu_torch.models.init import init_graphdd
    from genie_tpu_torch.params import flatten_tree, load_pinn, to_flax
    from genie_tpu_torch.relocation.graphdd import (GNNLocation, attach_reference,
                                                    build_catalog_data, graph_to,
                                                    make_dd_loss, make_relocation_graphs,
                                                    relocate, train_graphdd)
    from genie_tpu_torch.train.optim import clip_by_global_norm_

    rng = np.random.default_rng(seed + 8)
    sta = ctx.sta_cart.cpu().numpy()
    n_sta = len(sta)
    # 336 events in a 40 km cluster at the middle of the station network
    n_ev = 336
    center = np.median(sta, axis=0)
    true_pos = np.stack((center[0] + rng.uniform(-20e3, 20e3, n_ev),
                         center[1] + rng.uniform(-20e3, 20e3, n_ev),
                         rng.uniform(-15e3, -3e3, n_ev)), axis=1).astype(np.float32)
    true_t = np.sort(rng.uniform(0.0, 86400.0, n_ev)).astype(np.float32)
    with torch.no_grad():
        tt = pinn.from_cart(ctx.sta_cart,
                            torch.as_tensor(true_pos, device=dev)).cpu().numpy()
    d = np.linalg.norm(sta[None, :, :2] - true_pos[:, None, :2], axis=-1)
    obs_mask = (((d < 150e3)[..., None]) & (rng.random((n_ev, n_sta, 2)) < 0.85)
                ).astype(np.float32)
    obs_time = ((true_t[:, None, None] + tt) * obs_mask).astype(np.float32)
    init_pos = (true_pos + rng.normal(0, 2e3, (n_ev, 3))).astype(np.float32)
    t_set = time.time()
    graphs = make_relocation_graphs(seed, init_pos, true_t, obs_time, obs_mask, sta,
                                    n_graphs=12, graph_size=24, sta_budget=64, device=dev)
    anchors = rng.choice(n_ev, 68, replace=False)
    graphs = [attach_reference(g, anchors, true_pos[anchors], true_t[anchors])
              for g in graphs]
    set_s = time.time() - t_set
    print(f"[relocate] {n_ev} events, {int(obs_mask.sum())} picks at {n_sta} stations; "
          f"12 graphs of 24 sources x 64 stations built in {set_s:.2f} s; "
          f"{int(sum(int(g.ref_mask.sum()) for g in graphs))} anchored graph rows",
          flush=True)

    # check: one graph's loss and gradients at flax-default weights, card vs
    # CPU, each leaf within 1e-3 × its own max |g| + 1e-5 × the largest |g|
    # of all leaves. A PReLU slope's gradient is one sum over every cell
    # that cancels to a small value, and f32 sums in another order leave it
    # off by more than 1e-3 of itself through the PINN (1.6e-3 with the
    # card's times on both sides); the floor, 10× the largest reading over
    # all leaves, holds it. Through the PINN both sides take the card's PINN
    # times (the CPU side moves its inputs to the card and the times back),
    # so the check holds GraphDD's arithmetic; the CPU's own PINN differs
    # from the card's by up to ~5e-5 s ([pinn]), and that case is printed,
    # ungated, as the witness of what the difference adds.
    pinn_cpu = load_pinn(PINN, device="cpu")

    def pinn_on_card(s, x):
        return pinn.from_cart(s.to(dev), x.to(dev)).cpu()

    model_cpu = init_graphdd(GNNLocation(), torch.Generator().manual_seed(seed))
    failures = []
    for name, trv_d, trv_c, gated in (
            ("homogeneous", trv_h.from_cart, trv_h.from_cart, True),
            ("pinn", pinn.from_cart, pinn_on_card, True),
            ("pinn, the CPU's own PINN", pinn.from_cart, pinn_cpu.from_cart, False)):
        res = {}
        for tag, model, trv, g, s in (
                ("cuda", copy.deepcopy(model_cpu).to(dev), trv_d, graphs[0], ctx.sta_cart),
                ("cpu", copy.deepcopy(model_cpu), trv_c, graph_to(graphs[0], "cpu"),
                 torch.as_tensor(sta))):
            total, _ = make_dd_loss(model, trv, s)(g)
            total.backward()
            res[tag] = (float(total.detach()), flatten_tree(to_flax(
                {n: p.grad for n, p in model.named_parameters()})))
        (l_d, g_d), (l_c, g_c) = res["cuda"], res["cpu"]
        loss_rel = abs(l_d - l_c) / max(abs(l_c), 1e-30)
        err = {k: float(np.abs(g_d[k] - g_c[k]).max()) for k in g_c}
        own = {k: err[k] / max(float(np.abs(g_c[k]).max()), 1e-30) for k in g_c}
        largest = max(float(np.abs(v).max()) for v in g_c.values())
        worst = max(own, key=own.get)
        over = sorted(k for k in g_c if err[k] > 1e-3 * float(np.abs(g_c[k]).max())
                      + 1e-5 * largest)
        print(f"[relocate-check] {name} " + json.dumps({
            "loss_cuda": l_d, "loss_cpu": l_c, "loss_rel": loss_rel, "leaves": len(own),
            "max_rel_grad_err_own_max": own[worst], "worst_leaf": worst,
            "leaves_over_1e-3_own_max": sorted(k for k, v in own.items() if v > 1e-3),
            "max_grad_err_over_largest_g": max(err.values()) / largest,
            "leaves_over_gate": over, "gated": gated}), flush=True)
        if gated and not (np.isfinite(l_d) and loss_rel <= 1e-4):
            failures.append(f"{name}: loss on the card {l_d} vs the CPU {l_c}")
        if gated and over:
            failures.append(f"{name}: gradients of {over} off by more than 1e-3 of "
                            f"their own max |g| + 1e-5 of the largest")

    # steps: the first step from a 1-step call (set-up included), the
    # steady step from a 50-step probe, which decides the cut
    def train(n, seed_):
        return train_graphdd(torch.Generator(device=dev).manual_seed(seed_), GNNLocation(),
                             pinn.from_cart, ctx.sta_cart, graphs, n_steps=n, device=dev)

    _, first_s, _ = _timed(lambda: train(1, seed + 1))
    _, probe_s, _ = _timed(lambda: train(50, seed + 1))
    per_step = (probe_s - first_s) / 49
    n_steps = full_steps
    if per_step * full_steps > RELOCATE_BUDGET_S:
        n_steps = max(RELOCATE_MIN_STEPS, int(RELOCATE_BUDGET_S / per_step) // 250 * 250)
        print(f"[relocate] reduced: steps {full_steps} -> {n_steps} "
              f"(probe {per_step * 1e3:.1f} ms/step)", flush=True)
    (model, loss), secs, peak = _timed(lambda: train(n_steps, seed))
    if not np.isfinite(loss):
        fail(f"[relocate] training loss {loss} is not finite")

    # relocate every graph; average each source over the graphs that hold it
    acc = np.zeros((n_ev, 4))
    cnt = np.zeros(n_ev)
    for g in graphs:
        new_pos, new_t, sta_corr = relocate(model, pinn.from_cart, ctx.sta_cart, g)
        if not (torch.isfinite(new_pos).all() and torch.isfinite(sta_corr).all()):
            fail("[relocate] relocate gave non-finite values")
        ids = g.node_ids.cpu().numpy()
        sm = g.src_mask.cpu().numpy()
        acc[ids[sm], :3] += new_pos.cpu().numpy()[sm]
        acc[ids[sm], 3] += new_t.cpu().numpy()[sm]
        cnt[ids[sm]] += 1
    got = cnt > 0
    reloc = init_pos.astype(np.float64).copy()
    reloc[got] = acc[got, :3] / cnt[got, None]
    err0 = np.linalg.norm(init_pos[got] - true_pos[got], axis=1)
    err1 = np.linalg.norm(reloc[got] - true_pos[got], axis=1)

    # one profiled step: the ops of a train_graphdd step on graph 0
    from torch.profiler import ProfilerActivity, profile

    loss_fn = make_dd_loss(model, pinn.from_cart, ctx.sta_cart)
    cat0 = build_catalog_data(pinn.from_cart, ctx.sta_cart[graphs[0].sta_sel.long()],
                              graphs[0].src_pos, graphs[0].src_time, graphs[0].obs_time,
                              graphs[0].obs_mask)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        opt.zero_grad(set_to_none=True)
        total, _ = loss_fn(graphs[0], None, cat0)
        total.backward()
        clip_by_global_norm_(model.parameters(), 1.0)
        opt.step()
        torch.cuda.synchronize()
        wall_p = time.time() - t1
    prof_sum = summarize_profile(prof, wall_p, "profile relocate", ranges=(
        "Optimizer.step#Adam.step", "Optimizer.zero_grad#Adam.zero_grad"))
    summary = {
        "events": n_ev, "graphs": 12, "graph_size": 24, "sta_budget": 64, "anchors": 68,
        "steps": n_steps, "first_call_1_step_s": first_s,
        "probe_s_per_step": per_step,
        "steady_s_per_step": (secs - first_s) / (n_steps - 1), "train_seconds": secs,
        "max_memory_allocated_bytes": peak, "peak_gib": peak / 2**30,
        "final_loss": loss, "relocated_sources": int(got.sum()),
        "median_err_initial_m": float(np.median(err0)),
        "median_err_relocated_m": float(np.median(err1)),
        "ratio": float(np.median(err1) / np.median(err0)),
        "profiled_step_wall_s": wall_p,
        "profiled_step_device_ms": None if prof_sum is None else prof_sum["device_ms"],
        "profiled_step_busy_share": (None if prof_sum is None
                                     else prof_sum["device_ms"] / 1e3 / wall_p)}
    print("[relocate] " + json.dumps(summary), flush=True)
    if failures:
        fail(f"[relocate] card vs CPU before training: {failures}")
    if not np.median(err1) < 0.7 * np.median(err0):
        fail(f"[relocate] median 3-D error {np.median(err1)} m, not under 0.7 x the "
             f"initial {np.median(err0)} m")
    return summary


# -- phase 11 --------------------------------------------------------------
PINN_CENTER = (761.53, 2802.07, -24632.12)   # Grids/pinn_nc.pkl's box
PINN_X_SCALE = 504000.0
PINN_SHAPE = (239, 336, 34)
# nc_pinn.py's 40,000 steps are cut to fit this budget, down to this floor
PINN_BUDGET_S = 30.0
PINN_MIN_STEPS = 1000


def _fmm_shard(args):
    """One worker of the FMM pool: ``build_fmm_tables`` for its stations."""
    from genie_tpu_torch.workflow import build_fmm_tables

    cfg, proj, sta_lla, out_dir, idxs = args
    t0 = time.time()
    build_fmm_tables(cfg, proj, sta_lla, out_dir, station_indices=idxs, verbose=False)
    return time.time() - t0


def project_phase(pinn, seed: int, dev="cuda", n_sta: int = 374, n_fmm: int = 8,
                  n_steps_grids: int = 800, batch: int = 16384, per_sta: int = 30000,
                  full_steps: int = 40000, n_check: int = 4096, workers: int = 8):
    """Phase 11, ``[project]``: a project built from its files at run6
    width: ``init_project`` from a stations.txt, the FMM box against
    ``pinn_nc.pkl``'s scales, ``build_fmm_tables`` over a process pool,
    the production PINN against the fresh tables, the PINN loss card vs
    CPU, ``nc_pinn.py``'s training loop cut to ``PINN_BUDGET_S``, the artifact
    read back by ``make_trv`` and ``domain_from_project``."""
    import multiprocessing

    import torch

    from genie_tpu_torch.io import save_pinn
    from genie_tpu_torch.models.init import init_pinn
    from genie_tpu_torch.models.travel_time_pinn import (
        TravelTimePN, TravelTimesPN, eikonal_gradient, importance_sample_volume,
        make_pinn_loss, train_pinn)
    from genie_tpu_torch.native import fmm
    from genie_tpu_torch.params import _load_pickle, flatten_tree, to_flax
    from genie_tpu_torch.setup.project import init_project, read_stations_txt
    from genie_tpu_torch.train.optim import cosine_decay_schedule
    from genie_tpu_torch.workflow import (domain_from_project, fmm_grid_box, make_trv,
                                          pinn_bank_sampler, pinn_error_stats,
                                          pinn_sample_bank, pinn_velocity_prior,
                                          pinn_velocity_r2)

    cfg = run6_config()
    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name) / cfg.region.name
    root.mkdir()

    # 1. the project from a stations.txt of stations drawn from the seed
    rng = np.random.default_rng(seed + 11)
    lat = rng.uniform(*cfg.region.lat_range, n_sta)
    lon = rng.uniform(*cfg.region.lon_range, n_sta)
    elev = rng.uniform(0.0, 1500.0, n_sta)
    (root / "stations.txt").write_text("".join(
        f"S{i:03d} {lat[i]:.6f} {lon[i]:.6f} {elev[i]:.1f}\n" for i in range(n_sta)))
    t0 = time.time()
    sta_lla, names = read_stations_txt(root / "stations.txt")
    dirs, proj, grids = init_project(root, cfg, sta_lla=sta_lla, sta_names=names,
                                     n_steps_grids=n_steps_grids, seed=seed, device=dev)
    init_s = time.time() - t0
    lo_r = np.array([cfg.region.lat_range_extend[0], cfg.region.lon_range_extend[0],
                     cfg.region.depth_range[0]])
    hi_r = np.array([cfg.region.lat_range_extend[1], cfg.region.lon_range_extend[1],
                     cfg.region.depth_range[1]])
    tol = np.array([1e-4, 1e-4, 1.0])    # degrees, degrees, metres
    inside = bool(np.isfinite(grids).all() and (grids >= lo_r - tol).all()
                  and (grids <= hi_r + tol).all())
    print("[project] init " + json.dumps({
        "stations": len(sta_lla), "grids": list(grids.shape), "lloyd_steps": n_steps_grids,
        "seconds": init_s, "nodes_inside_padded_region": inside}), flush=True)
    if not inside:
        fail("[project] init_project gave nodes that are not finite or lie outside "
             "the padded region")

    # 2. the FMM box of run6's config is the box of pinn_nc.pkl
    lo, shape, h = fmm_grid_box(cfg, proj)
    extent = np.asarray(shape) * h
    center = lo + extent / 2
    box = {"shape": list(shape), "cells": int(np.prod(shape)), "h": h,
           "x_scale": float(extent.max()), "center": center.tolist(),
           "center_err_m": float(np.abs(center - np.asarray(PINN_CENTER)).max())}
    print("[project] box " + json.dumps(box), flush=True)
    if not (tuple(shape) == PINN_SHAPE and box["x_scale"] == PINN_X_SCALE
            and box["center_err_m"] <= 1.0):
        fail(f"[project] fmm_grid_box {box} is not the box of {PINN.name}")

    # 3. FMM tables of the first n_fmm stations over a spawn pool (the
    #    solver is built once, before the workers start)
    fmm.build()
    tt_dir = dirs["travel_times"]
    n_workers = max(1, min(workers, n_fmm, len(os.sched_getaffinity(0))))
    shards = [(cfg, proj, sta_lla, tt_dir, list(range(j, n_fmm, n_workers)))
              for j in range(n_workers)]
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
        shard_s = pool.map(_fmm_shard, shards)
    fmm_s = time.time() - t0
    tables = [tt_dir / f"travel_time_grid_station_{j}.npz" for j in range(n_fmm)]
    if not all(f.exists() for f in tables):
        fail("[project] build_fmm_tables left stations without a table")
    print("[project] fmm " + json.dumps({
        "stations": n_fmm, "of": n_sta, "workers": n_workers, "wall_s": fmm_s,
        "worker_s": shard_s, "worker_s_per_station": sum(shard_s) / n_fmm,
        "cells_per_volume": box["cells"]}), flush=True)

    # 4. the production PINN against the fresh tables
    sta_cart = proj.to_cart_np(sta_lla).astype(np.float32)
    rng4 = np.random.default_rng(seed + 12)
    chk = ([], [], [])
    for j, f in enumerate(tables):
        z = np.load(f)
        src, t = importance_sample_volume(rng4, z["Tp"], z["Ts"], z["origin"],
                                          float(z["h"]), sta_cart[j], n_check)
        for acc, a in zip(chk, (np.broadcast_to(sta_cart[j], (n_check, 3)), src, t)):
            acc.append(a)
    prod = pinn_error_stats(pinn, *(np.concatenate(a) for a in chk))
    prod_ref = _load_pickle(PINN)["metrics"]["cross_val"]["median_s"]
    print("[project] production PINN vs fresh FMM " + json.dumps({
        "samples": n_fmm * n_check, **prod, "pickle_cross_val_median_s": prod_ref}),
        flush=True)
    if not prod["median_s"] <= 0.15:
        fail(f"[project] production PINN vs fresh FMM median |dt| {prod['median_s']} s "
             f"> 0.15 s")

    # 5. the bank, and the loss card vs CPU at flax-default weights
    t0 = time.time()
    bank = pinn_sample_bank(cfg, sta_cart[:n_fmm], tables, np.random.default_rng(seed),
                            per_sta=per_sta)
    bank_s = time.time() - t0
    scales = bank.scales
    prior = pinn_velocity_prior(cfg, scales)
    model_cpu = init_pinn(TravelTimesPN(), torch.Generator().manual_seed(seed))
    rows = np.random.default_rng(seed + 13).integers(0, len(bank.t), n_check)
    res = {}
    for tag, d in (("cuda", dev), ("cpu", "cpu")):
        model = copy.deepcopy(model_cpu).to(d)
        sta_n, src_n, t_n = (torch.as_tensor(a[rows], device=d)
                             for a in (bank.sta, bank.src, bank.t))
        sc = scales.to(d)
        total, parts = make_pinn_loss(model, sc, v_init_fn=prior)(sta_n, src_n, t_n)
        total.backward()
        eik, _ = eikonal_gradient(model, sta_n, src_n, sc.conversion_factor, sc.v_mean,
                                  create_graph=False)
        res[tag] = ({"total": float(total.detach()),
                     **{k: float(v.detach()) for k, v in parts.items()}},
                    eik.cpu().numpy(),
                    flatten_tree(to_flax({n: p.grad for n, p in model.named_parameters()})))
    (l_d, e_d, g_d), (l_c, e_c, g_c) = res["cuda"], res["cpu"]
    loss_rel = {k: abs(l_d[k] - l_c[k]) / max(abs(l_c[k]), 1e-30) for k in l_c}
    eik_err = float(np.abs(e_d - e_c).max() / np.abs(e_c).max())
    err = {k: float(np.abs(g_d[k] - g_c[k]).max()) for k in g_c}
    own = {k: err[k] / max(float(np.abs(g_c[k]).max()), 1e-30) for k in g_c}
    largest = max(float(np.abs(v).max()) for v in g_c.values())
    over = sorted(k for k in g_c if err[k] > 1e-3 * float(np.abs(g_c[k]).max())
                  + 1e-5 * largest)
    worst = max(own, key=own.get)
    print("[project-check] " + json.dumps({
        "bank_samples": len(bank.t), "bank_stations": n_fmm - len(range(0, n_fmm, 20)),
        "bank_s": bank_s, "batch": n_check, "loss_cuda": l_d, "loss_cpu": l_c,
        "max_loss_rel": max(loss_rel.values()), "eikonal_err_over_max": eik_err,
        "leaves": len(own), "max_rel_grad_err_own_max": own[worst], "worst_leaf": worst,
        "max_grad_err_over_largest_g": max(err.values()) / largest,
        "leaves_over_gate": over}), flush=True)
    if not (all(np.isfinite(v) for v in l_d.values())
            and max(loss_rel.values()) <= 1e-4):
        fail(f"[project] PINN loss on the card {l_d} vs the CPU {l_c}")
    if not eik_err <= 1e-4:
        fail(f"[project] eikonal gradient card vs CPU {eik_err} of its max > 1e-4")
    if over:
        fail(f"[project] PINN gradients of {over} off by more than 1e-3 of their own "
             f"max |g| + 1e-5 of the largest")

    # 6. nc_pinn.py's loop: cosine over full_steps, cut by a 50-step probe
    sample_fn = pinn_bank_sampler(bank, dev)
    sched = cosine_decay_schedule(1e-3, full_steps, alpha=0.02)

    def train(n, seed_):
        return train_pinn(torch.Generator(device=dev).manual_seed(seed_), TravelTimesPN(),
                          scales, sample_fn, n_steps=n, batch=batch, lr=sched,
                          v_init_fn=prior, device=dev)

    _, first_s, _ = _timed(lambda: train(1, seed + 1))
    _, probe_s, _ = _timed(lambda: train(50, seed + 1))
    per_step = (probe_s - first_s) / 49
    n_steps = full_steps
    if per_step * full_steps > PINN_BUDGET_S:
        n_steps = max(PINN_MIN_STEPS, int(PINN_BUDGET_S / per_step) // 500 * 500)
        print(f"[project] reduced: PINN steps {full_steps} -> {n_steps} "
              f"(probe {per_step * 1e3:.2f} ms/step, budget {PINN_BUDGET_S:.0f} s)",
              flush=True)
    (model, hist), train_s, peak = _timed(lambda: train(n_steps, seed))
    hist = {k: v.cpu().numpy() for k, v in hist.items()}
    finite = bool(all(np.isfinite(v).all() for v in hist.values()))
    data0, data_end = float(hist["data"][0]), float(hist["data"][-100:].mean())
    trv = TravelTimePN(model.requires_grad_(False), scales.to(dev), projection=proj)
    metrics = {"val": pinn_error_stats(trv, *bank.val),
               "cross_val": pinn_error_stats(trv, *bank.cross_val),
               "velocity_r2": np.asarray(pinn_velocity_r2(
                   model, cfg, bank, np.random.default_rng(seed + 14))).tolist()}

    # one more step under the profiler, on a copy of the trained weights
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        train_pinn(None, copy.deepcopy(model).requires_grad_(True), scales, sample_fn,
                   n_steps=1, batch=batch, lr=sched, v_init_fn=prior, keep_weights=True,
                   device=dev)
        torch.cuda.synchronize()
        wall_p = time.time() - t1
    prof_sum = summarize_profile(prof, wall_p, "profile pinn", ranges=(
        "Optimizer.step#Adam.step", "Optimizer.zero_grad#Adam.zero_grad"))
    summary = {
        "bank_samples": len(bank.t), "batch": batch, "steps": n_steps,
        "first_call_1_step_s": first_s, "probe_s_per_step": per_step,
        "steady_ms_per_step": (train_s - first_s) / (n_steps - 1) * 1e3,
        "train_seconds": train_s, "max_memory_allocated_bytes": peak,
        "peak_gib": peak / 2**30, "losses_finite": finite,
        "data_first": data0, "data_last100_mean": data_end,
        "loss_last": float(hist["total"][-1]), **metrics,
        "profiled_step_wall_s": wall_p,
        "profiled_step_device_ms": None if prof_sum is None else prof_sum["device_ms"],
        "profiled_step_busy_share": (None if prof_sum is None
                                     else prof_sum["device_ms"] / 1e3 / wall_p)}
    print("[project] pinn " + json.dumps(summary), flush=True)
    if not finite:
        fail("[project] a PINN training loss is not finite")
    if not data_end < 0.5 * data0:
        fail(f"[project] PINN data term {data_end} over its last 100 steps is not under "
             f"half its first value {data0}")

    # 7. the artifact, read back, and the project's domain context
    t0 = time.time()
    path = save_pinn(dirs["grids"] / "pinn_nc.pkl", model, scales, metrics)
    trv_file = make_trv(cfg, proj, path, device=dev)
    grid_t = torch.as_tensor(proj.to_cart_np(grids[0]).astype(np.float32), device=dev)
    sta_t = torch.as_tensor(sta_cart, device=dev)
    with torch.no_grad():
        dt = float((trv_file.from_cart(sta_t, grid_t) - trv.from_cart(sta_t, grid_t))
                   .abs().max())
    ctx, _, _ = domain_from_project(root, cfg, trv=trv_file, device=dev)
    torch.cuda.synchronize()
    dom_s = time.time() - t0
    shape_ok = tuple(ctx.trv_grids.shape) == (cfg.graph.n_grids,
                                              cfg.graph.n_spatial_nodes, n_sta, 2)
    finite_ok = bool(torch.isfinite(ctx.trv_grids).all())
    print("[project] artifact " + json.dumps({
        "path": str(path.relative_to(root)), "bytes": path.stat().st_size,
        "make_trv_vs_model_max_abs_dt_s": dt, "trv_grids": list(ctx.trv_grids.shape),
        "trv_grids_finite": finite_ok, "max_t_s": float(ctx.trv_grids.max()),
        "seconds": dom_s}), flush=True)
    if not dt <= 1e-6:
        fail(f"[project] the artifact read by make_trv differs from the trained model "
             f"by {dt} s")
    if not (shape_ok and finite_ok):
        fail(f"[project] domain_from_project gave trv_grids {tuple(ctx.trv_grids.shape)}, "
             f"finite {finite_ok}")
    tmp.cleanup()
    print(f"[project] phase {time.time() - t_phase:.1f} s", flush=True)
    return summary


# -- phase 13 --------------------------------------------------------------
def event_picks(picks, trv, ctx, j: int, n_sta: int = 24, max_dist: float = 150e3):
    """The request's picks of planted event ``j`` at its ``n_sta`` nearest
    stations within ``max_dist`` (P and S; at most ``2 · n_sta``): at each
    (station, phase) the pick nearest the event's predicted arrival, if
    within 1 s. Returns (tpick, ipick, phase (L, 1), mask) as numpy."""
    import torch

    pick_t, pick_sta, pick_ph, ev_pos, ev_t = picks[:5]
    sta = ctx.sta_cart.cpu().numpy()
    with torch.no_grad():
        tt = trv.from_cart(ctx.sta_cart, torch.as_tensor(
            ev_pos[j:j + 1], dtype=torch.float32, device=ctx.sta_cart.device))[0]
    tt = tt.cpu().numpy()
    d = np.linalg.norm(sta[:, :2] - ev_pos[j, None, :2], axis=1)
    near = [i for i in np.argsort(d)[:n_sta] if d[i] < max_dist]
    tp, ip, ph = [], [], []
    for i in near:
        for p in (0, 1):
            cand = np.where((pick_sta == i) & (pick_ph == p))[0]
            if len(cand) == 0:
                continue
            k = cand[np.argmin(np.abs(pick_t[cand] - ev_t[j] - tt[i, p]))]
            if abs(pick_t[k] - ev_t[j] - tt[i, p]) < 1.0:
                tp.append(pick_t[k]), ip.append(i), ph.append(p)
    return (np.asarray(tp, np.float32), np.asarray(ip, np.int32),
            np.asarray(ph, np.float32)[:, None], np.ones(len(tp), bool))


def extras_phase(pipe, cfg, ctx, trv, picks, seed: int, card: str, dev="cuda",
                 n_calls: int = 40, n_random_starts: int = 15, t_synth: float = 10800.0,
                 n_legacy: int = 4096, chunk: int = 512, n_check: int = 512):
    """Phase 13, ``[extras]``: what the JAX pipeline never calls, on the
    production domain (``pipe``, ``ctx``, the corrected PINN ``trv`` and
    the request ``picks`` of phase 6). Returns the fused-round launches of
    the audited request."""
    import torch

    from genie_tpu_torch.calibration.corrections import TravelTimeCorrection
    from genie_tpu_torch.infer.locate import (locate_source, locate_source_pso,
                                              location_uncertainty)
    from genie_tpu_torch.models.init import init_legacy_travel_times
    from genie_tpu_torch.models.travel_time import LegacyTravelTimes
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.ops.interp import natural_neighbor_interp
    from genie_tpu_torch.ops.pinn_trv import pinn_trv
    from genie_tpu_torch.ops.knn import knn, knn_tiled
    from genie_tpu_torch.ops.segment import spmm
    from genie_tpu_torch.params import load_pinn
    from genie_tpu_torch.train.bayes_opt import PARAM_SPACE, gp_minimize
    from genie_tpu_torch.workflow import optimize_data_objective, synthetic_pick_statistics

    t_phase = time.time()
    rng = np.random.default_rng(seed + 13)
    print(f"[extras] card: {card}", flush=True)
    ev_pos, ev_t = picks[3], picks[4]
    n_sta = ctx.sta_cart.shape[0]
    lo = torch.cat((ctx.offset_cart, torch.tensor([-30.0], device=dev)))
    hi = torch.cat((ctx.offset_cart + ctx.scale_cart, torch.tensor([30.0], device=dev)))

    def located(tag, j, pos, t0, t_ref, secs):
        err = float(np.linalg.norm(pos.cpu().numpy() - ev_pos[j]))
        dt = float(t0) + t_ref - ev_t[j]
        print(f"[extras] {tag} event {j}: {err / 1e3:.3f} km, dt {dt:+.3f} s, "
              f"{secs:.3f} s", flush=True)
        if not (err < 5e3 and abs(dt) < 0.5):
            fail(f"[extras] {tag}: planted event {j} located {err / 1e3:.2f} km and "
                 f"{dt:+.3f} s off (gates 5 km, 0.5 s)")

    # pso and locate: each planted event from its own picks, times relative to
    # a reference within ±3 s of the origin, as a detection would give
    events = []
    for j in range(len(ev_t)):
        tp, ip, ph, mk = event_picks(picks, trv, ctx, j)
        t_ref = float(ev_t[j] + rng.uniform(-3.0, 3.0))
        events.append((tp - t_ref, ip, ph, mk, t_ref))
    hull = ctx.sta_cart.cpu().numpy()
    for tag in ("pso", "locate"):
        secs = []
        sols = []
        for j, (tp, ip, ph, mk, t_ref) in enumerate(events):
            gen = torch.Generator(device=dev).manual_seed(seed + 100 + j)
            if tag == "pso":
                run = lambda: locate_source_pso(gen, trv.from_cart, ctx.sta_cart, tp, ip,
                                                ph, mk, lo, hi, hull_points=hull,
                                                device=dev)
            else:
                run = lambda: locate_source(gen, trv.from_cart, ctx.sta_cart, tp, ip, ph,
                                            mk, lo, hi, device=dev)
            with torch.no_grad():
                (pos, t0, cost), sec, _ = _timed(run)
            located(tag, j, pos, t0, t_ref, sec)
            secs.append(sec)
            sols.append((pos, t0))
        print(f"[extras] {tag}: {len(events)} events, picks per event "
              f"{[len(e[0]) for e in events]}, s per event {np.round(secs, 3).tolist()}",
              flush=True)

    # uncertainty: the covariance at each DE solution (``sols`` of the last
    # loop), card vs CPU
    z = np.load(CORRECTIONS)
    trv_cpu = TravelTimeCorrection(load_pinn(PINN, device="cpu").from_cart, z["grid_cart"],
                                   z["coefs"][:, :n_sta])
    sta_cpu = ctx.sta_cart.cpu()
    worst = 0.0
    for j, ((tp, ip, ph, mk, _), (pos, t0)) in enumerate(zip(events, sols)):
        cov, sec, _ = _timed(lambda: location_uncertainty(
            trv.from_cart, ctx.sta_cart, pos, t0, tp, ip, ph, mk, device=dev))
        cov = cov.cpu().numpy()
        want = location_uncertainty(trv_cpu.from_cart, sta_cpu, pos.cpu(), t0.cpu(), tp,
                                    ip, ph, mk, device="cpu").numpy()
        rel = float(np.abs(cov - want).max() / np.abs(want).max())
        worst = max(worst, rel)
        sym = float(np.abs(cov - cov.T).max() / np.abs(cov).max())
        print(f"[extras] uncertainty event {j}: sigma xyz/t "
              f"{np.sqrt(np.maximum(np.diag(cov), 0)).round(3).tolist()}, card vs CPU "
              f"{rel:.2e} of the largest entry, asymmetry {sym:.1e}, {sec * 1e3:.1f} ms",
              flush=True)
        if not (np.isfinite(cov).all() and rel <= 1e-3 and sym <= 1e-5):
            fail(f"[extras] uncertainty of event {j}: card vs CPU {rel} (gate 1e-3), "
                 f"asymmetry {sym}")

    # legacy_tt: LegacyTravelTimes at its width, flax-default init
    model_cpu = init_legacy_travel_times(LegacyTravelTimes(device="cpu"),
                                         torch.Generator().manual_seed(seed))
    model = copy.deepcopy(model_cpu).to(dev)
    flat = ctx.grids_cart.reshape(-1, 3).cpu().numpy()
    src = torch.as_tensor(rng.uniform(flat.min(0), flat.max(0), (n_legacy, 3)),
                          dtype=torch.float32)
    src_d = src.to(dev)
    for relative in (False, True):
        with torch.no_grad():
            t_d, m_d = model(ctx.sta_cart, src_d, relative=relative)
            t_c, m_c = model_cpu(sta_cpu, src, relative=relative)
            ms = cuda_time_ms(lambda: model(ctx.sta_cart, src_d, relative=relative),
                              reps=5, warmup=1)
        et = float((t_d.cpu() - t_c).abs().max() / t_c.abs().max())
        em = float((m_d.cpu() - m_c).abs().max())
        print(f"[extras] legacy_tt relative={relative}: {n_legacy} x {n_sta} pairs, "
              f"max |dt| {et:.2e} x max |t|, max |dmask| {em:.2e}, {ms:.3f} ms per call",
              flush=True)
        if not (et <= 1e-4 and em <= 1e-5):
            fail(f"[extras] legacy_tt relative={relative}: card vs CPU {et} / {em}")
        del t_d, m_d, t_c, m_c

    # knn_tiled: the query grid against itself, one full tile and a ragged one
    xq = pipe.x_query
    k = 10
    ti, tv = knn_tiled(xq, xq, k, tile=8192)
    ki, kv = knn(xq, xq, k)
    ms_t = cuda_time_ms(lambda: knn_tiled(xq, xq, k, tile=8192), reps=5, warmup=1)
    ms_k = cuda_time_ms(lambda: knn(xq, xq, k), reps=5, warmup=1)
    # exact distances (float64) decide which rows have a clear order: a gap
    # must exceed what the rounding of the f32 |a|²+|b|²-2ab form both
    # searches use can move two distances apart, 8·eps·(|q|² + max |c|²),
    # ~1e-3 of a neighbour's d² at 2e5 m
    x64 = xq.double()
    d_all = torch.cdist(x64, x64).square()
    d_sorted = torch.topk(d_all, k + 1, dim=1, largest=False).values
    tol = 8 * torch.finfo(torch.float32).eps * (
        (x64 ** 2).sum(1) + (x64 ** 2).sum(1).max())[:, None]
    gaps = d_sorted[:, 1:] - d_sorted[:, :-1]
    clear = (gaps > tol).all(dim=1)              # every order in the row is clear
    clear_k = gaps[:, k - 1] > tol[:, 0]         # the k-th and (k+1)-th differ
    pos_eq = (ti == ki).all(dim=1)
    set_eq = (torch.sort(ti, dim=1).values == torch.sort(ki, dim=1).values).all(dim=1)
    d_gap = (torch.gather(d_all, 1, ti.long()) - torch.gather(d_all, 1, ki.long())).abs()
    del d_all
    bad = (int((clear & ~pos_eq).sum()) + int((clear_k & ~set_eq).sum())
           + int((d_gap > tol).any(dim=1).sum()))
    print(f"[extras] knn_tiled: {xq.shape[0]} x {xq.shape[0]}, k {k}, tile 8192: "
          f"{int(pos_eq.sum())} rows equal to knn, {int(clear.sum())} with a clear order, "
          f"{int(clear_k.sum())} with a clear k-th gap; max |d² tiled - d² knn| "
          f"{float((d_gap / tol).max()):.2f} x the rounding bound; {ms_t:.3f} ms "
          f"(knn {ms_k:.3f} ms)", flush=True)
    if bad or not bool(tv.all()) or not torch.equal(tv, kv):
        fail(f"[extras] knn_tiled differs from knn on {bad} rows with clear distances")

    # spmm: the station edges of one product graph, 500 sources x the stations
    sta_nbr = pipe.sta_nbr.long()
    n_src, kk, c = ctx.grids_cart.shape[1], sta_nbr.shape[1], 30
    node = torch.arange(n_src * n_sta, device=dev).view(n_src, n_sta)
    e_dst = node[:, :, None].expand(n_src, n_sta, kk).reshape(-1)
    e_src = (node[:, :1, None] + sta_nbr[None]).reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    x = torch.randn((n_src * n_sta, c), generator=gen, device=dev)
    w = torch.rand(e_src.shape, generator=gen, device=dev)
    r = torch.randn((n_src * n_sta, c), generator=gen, device=dev)
    for aggr in ("sum", "mean", "max"):
        res = {}
        for tag, args in (("cuda", (e_src, e_dst, x, w, r)),
                          ("cpu", tuple(a.cpu() for a in (e_src, e_dst, x, w, r)))):
            xs = args[2].clone().requires_grad_(True)
            out = spmm(args[0], args[1], xs, n_src * n_sta, edge_weight=args[3], aggr=aggr)
            (out * args[4]).sum().backward()
            res[tag] = (out.detach().cpu(), xs.grad.cpu())

        def fwd_bwd():
            xs = x.clone().requires_grad_(True)
            out = spmm(e_src, e_dst, xs, n_src * n_sta, edge_weight=w, aggr=aggr)
            (out * r).sum().backward()

        ms = cuda_time_ms(fwd_bwd, reps=5, warmup=1)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(res["cuda"], res["cpu"])]
        print(f"[extras] spmm {aggr}: {e_src.shape[0]} edges, C {c}, weighted; card vs CPU "
              f"out {errs[0]:.2e}, grad {errs[1]:.2e} (relative to max); forward+backward "
              f"{ms:.3f} ms, {e_src.shape[0] / ms * 1e3:.4g} edges/s", flush=True)
        if not max(errs) <= 1e-5:
            fail(f"[extras] spmm {aggr}: card vs CPU {errs} > 1e-5")

    # interp: a smooth field on the correction grid's 500 nodes
    nodes = z["grid_cart"].astype(np.float32)
    field = (np.sin(nodes[:, 0] / 50e3) + np.cos(nodes[:, 1] / 70e3)
             + nodes[:, 2] / 20e3).astype(np.float32)
    xqi = rng.uniform(nodes.min(0), nodes.max(0), (4096, 3)).astype(np.float32)
    (got, sec, peak) = _timed(lambda: natural_neighbor_interp(
        nodes, field, xqi, n_res=11, query_chunk=chunk, device=dev))
    want = natural_neighbor_interp(nodes, field, xqi[:n_check], n_res=11, query_chunk=chunk,
                                   device="cpu")
    diff = (got[:n_check].cpu() - want).abs()
    off = diff > 1e-4 * float(field.max() - field.min())
    print(f"[extras] interp: {len(nodes)} nodes -> {len(xqi)} queries (n_res 11, chunk "
          f"{chunk}) {sec * 1e3:.1f} ms, peak {peak / 2**30:.2f} GiB; card vs CPU on "
          f"{n_check}: {int(off.sum())} differ by more than 1e-4 x the range (max "
          f"{float(diff.max()):.2e})", flush=True)
    if not (torch.isfinite(got).all() and float(off.float().mean()) <= 0.01):
        fail(f"[extras] interp: {int(off.sum())} of {n_check} queries differ card vs CPU")

    # trace: the production request replayed through the audit
    pick_t, pick_sta, pick_ph = picks[:3]
    amp = picks[5]
    times_s, series = pipe.detection_sweep(pick_t, pick_sta, pick_ph, 0.0, 600.0)
    plain = pipe.process_from_sweep(times_s, series, pick_t, pick_sta, pick_ph, pick_amp=amp)
    planted = np.concatenate((ev_pos, ev_t[:, None]), axis=1)
    fused_round.launches = 0
    pinn_trv.launches = 0
    (audited, sec, _) = _timed(lambda: pipe.process_from_sweep(
        times_s, series, pick_t, pick_sta, pick_ph, pick_amp=amp, trace=planted))
    launches = fused_round.launches
    record_pinn_launches("extras_trace", pinn_trv.launches, len(audited), pinn=True)
    stages = ["peaks", "cluster", "refine", "associate", "eligible", "locate+qc", "dedup"]
    missed = {k: v for k, v in pipe.ledger.items() if v}
    same = len(plain) == len(audited) and all(
        np.array_equal(a.picks, b.picks) and np.array_equal(a.pos_cart, b.pos_cart)
        and a.time == b.time for a, b in zip(plain, audited))
    print(f"[extras] trace: {len(audited)} events, {sec:.2f} s, {launches} fused_round "
          f"launches; stages audited {list(pipe.ledger)}; missing {missed}; events equal to "
          f"the call without trace: {same}", flush=True)
    if list(pipe.ledger) != stages or missed or not same or launches <= 0:
        fail("[extras] trace: the audit lost a planted event, changed the events or "
             "launched no kernel")

    # optimize: nc_optimize_data.py's loop; targets from run6's synth values
    cfg_o = run6_train_config()
    cfg_o.synth.T = t_synth
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    targets = [synthetic_pick_statistics(cfg_o, ctx, trv.from_cart, gen) for _ in range(2)]
    objective = optimize_data_objective(cfg_o, ctx, trv.from_cart, targets, gen)
    cut = ("no cut" if (n_calls, n_random_starts) == (40, 15) else
           f"reduced: n_calls 40 -> {n_calls}, n_random_starts 15 -> {n_random_starts}")
    print(f"[extras] optimize: {n_calls} calls, {n_random_starts} random starts ({cut}); "
          f"--t-synth {t_synth:.0f} s; targets: two timelines at run6's synth values",
          flush=True)
    walls = []

    def cb(i, x_, y_):
        walls.append(time.time())
        print(f"[extras] optimize call {i + 1}/{n_calls}: resid {y_:.4f}", flush=True)

    t0 = time.time()
    x_best, y_best, X, Y = gp_minimize(objective, [(p[1], p[2]) for p in PARAM_SPACE],
                                       n_calls=n_calls, n_random_starts=n_random_starts,
                                       callback=cb)
    per_call = np.diff([t0] + walls)
    print("[extras] optimize " + json.dumps({
        "residual": y_best, "best_random_start": float(min(Y[:n_random_starts])),
        "s_per_call": per_call.round(3).tolist(),
        "params": {p[0]: float(v) for p, v in zip(PARAM_SPACE, x_best)}}), flush=True)
    if not (np.isfinite(Y).all() and y_best <= min(Y[:n_random_starts])):
        fail(f"[extras] optimize: residuals {Y.tolist()}")
    print(f"[extras] phase {time.time() - t_phase:.1f} s", flush=True)
    return launches


# -- phase 2b: the kernel past the old station limit -------------------------
def check_kernel_large(cfg, seed: int, sizes=(1000, 2048), n_win: int = 4,
                       n_src: int = 512):
    """The kernel against its plain version for all six forms at network
    sizes whose Y buffer does not fit in shared memory beside the ring (over
    about 900 stations at H = 30): stations drawn from ``seed`` in the run6
    grid box, their k = 8 station graph, 4 windows × 512 sources = 2048 rows.
    Returns the records of both sizes."""
    import torch

    from genie_tpu_torch.graphs.build import build_station_graph
    from genie_tpu_torch.ops.segment import aggregation_weights

    records = []
    for n_sta in sizes:
        _, sta_cart = draw_stations(cfg, np.random.default_rng(seed + n_sta), n_sta)
        nbr, valid = build_station_graph(torch.as_tensor(sta_cart, device="cuda"),
                                         cfg.graph.k_sta_edges)
        r0, r4 = check_kernel(nbr.to(torch.int32).contiguous(),
                              aggregation_weights(nbr, valid).contiguous(), seed,
                              n_win=n_win, n_src=n_src, dense_entry=False)
        records += r0 + r4
        torch.cuda.empty_cache()
    return records


# -- phase 14: [shard] -----------------------------------------------------------
SHARD_RANKS = 4
SHARD_TIMEOUT_S = 300


def _graph_dict(graph):
    return {f: getattr(graph, f).detach().cpu() for f in graph._fields}


def _scene(graph, sta_pos, x_query, cfg, seed: int, n_win: int, dev):
    """A product scene on ``graph``: ``n_win`` windows of features U[0, 0.5)
    with picks where they exceed 0.2 (the tiny scene of
    ``tests/test_detector.py`` at full width), the query nodes attached to
    the grid, the pipeline's 9 time offsets."""
    import torch

    from genie_tpu_torch.graphs.build import build_query_attachment

    gen = torch.Generator(device=dev).manual_seed(seed)
    n_src, n_sta = graph.edge_feat.shape[:2]
    feat = torch.rand((n_win, n_src, n_sta, 4), generator=gen, device=dev) * 0.5
    xq = torch.as_tensor(x_query, device=dev)
    return dict(graph=graph, sta_pos=sta_pos, feat=feat, mask=(feat > 0.2).float(),
                x_query=xq, x_query_idx=build_query_attachment(
                    graph.src_pos, xq, k=cfg.graph.k_spatial_attn),
                t_query=torch.linspace(-cfg.model.t_win / 2, cfg.model.t_win / 2, 9,
                                       device=dev)[:, None])


def shard_scenes(cfg, ctx, x_query, seed: int, dev, n_sta_b: int = 1000,
                 n_src_b: int = 8192, n_q: int = 2000):
    """(a) the run6 grid: grid 0 of the phase-3 domain (500 sources, its 374
    stations, 2 windows); (b) pod width cut to one card: ``n_sta_b``
    stations and ``n_src_b`` sources drawn from ``seed`` in the run6 box
    (depths in the grids' range), k = 8 / 15 graphs, 1 window; the first
    ``n_q`` detection query nodes. Returns (a, b, the (n_src_b, n_sta_b)
    pair mask at run6's ``max_deg_offset`` 1.5 and ``k_nearest_pairs`` 30)."""
    import torch

    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.graphs.build import (build_edge_feat, build_source_graph,
                                              build_station_graph)
    from genie_tpu_torch.graphs.subgraph import pair_mask
    from genie_tpu_torch.models.detector import GraphBundle

    k_sta, k_src = cfg.graph.k_sta_edges, cfg.graph.k_spc_edges
    nbr, valid = build_station_graph(ctx.sta_cart, k_sta)
    n_sta = ctx.sta_cart.shape[0]
    graph_a = GraphBundle(nbr, valid, ctx.src_nbr[0], torch.ones(n_sta, dtype=torch.bool,
                                                                 device=dev),
                          ctx.edge_feat[0], ctx.grids_cart[0], ctx.time_ptr_p[0],
                          ctx.time_ptr_s[0], torch.tensor(ctx.dt0, device=dev),
                          torch.tensor(ctx.dt, device=dev), ctx.trv_grids[0])
    scene_a = _scene(graph_a, ctx.sta_cart, x_query[:n_q], cfg, seed + 140, 2, dev)

    rng = np.random.default_rng(seed + 141)
    sta_lla, sta_cart = draw_stations(cfg, rng, n_sta_b)
    _, _, lo, hi = grid_box()
    src_lla = np.stack([rng.uniform(lo[i], hi[i], n_src_b) for i in range(3)], axis=1)
    proj = Projection.from_center(cfg.region.center)
    src_cart = torch.as_tensor(proj.to_cart_np(src_lla).astype(np.float32), device=dev)
    src_lla = torch.as_tensor(src_lla.astype(np.float32), device=dev)
    sta_lla = torch.as_tensor(sta_lla, device=dev)
    sta_cart = torch.as_tensor(sta_cart, device=dev)
    nbr, valid = build_station_graph(sta_cart, k_sta)
    scale, _ = cfg.region.scale_offset(extend=True)
    zi = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
    graph_b = GraphBundle(nbr, valid, build_source_graph(src_cart, k_src),
                          torch.ones(n_sta_b, dtype=torch.bool, device=dev),
                          build_edge_feat(src_lla, sta_lla, scale), src_cart, zi, zi,
                          torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev),
                          torch.zeros((1, 1, 2), device=dev))
    scene_b = _scene(graph_b, sta_cart, x_query[:n_q], cfg, seed + 142, 1, dev)
    return scene_a, scene_b, pair_mask(src_lla, sta_lla, 1.5, 30)


def _forward_scene(fwd, sc):
    return fwd(sc["feat"], sc["mask"], sc["x_query"], sc["x_query_idx"], sc["t_query"])


def _scene_to(sc, dev):
    from genie_tpu_torch.models.detector import GraphBundle

    out = {k: v.to(dev) for k, v in sc.items() if k != "graph"}
    out["graph"] = GraphBundle(**{f: v.to(dev) for f, v in sc["graph"].items()})
    return out


def _train_ref_state(cfg_t, dev):
    """run6's weights and Adam state at step 20000, as ``--restart`` reads
    them."""
    from genie_tpu_torch.train.trainer import TrainState, make_optimizer
    from genie_tpu_torch.workflow import restart_from

    model = load_model(cfg_t).to(dev)
    return restart_from(RUN6 / "params.pkl",
                        TrainState(model, make_optimizer(model, cfg_t), 0))


def shard_worker(d, rank: int, world: int, port: int):
    """One rank of ``[shard]``'s group: gloo with every rank on ``cuda:0``,
    or NCCL with rank r on ``cuda:r``. Runs the sharded forwards (a)-(d) on
    this rank's sources, then, on ranks 0 and 1 (a sub-group), the
    data-parallel step (e). Writes ``out_RANK.pt``."""
    import torch
    import torch.distributed as dist

    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.parallel.mesh import make_mesh
    from genie_tpu_torch.parallel.product_shard import halo_exchange
    from genie_tpu_torch.parallel.sharded_detector import (
        make_sharded_detection_forward, make_subgraph_sharded_detection_forward)
    from genie_tpu_torch.synth.generator import WindowBatch
    from genie_tpu_torch.train.trainer import DomainContext, make_train_step_from_batch

    d = Path(d)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = (d / "backend").read_text()
    dev = torch.device((d / "device").read_text())
    if backend == "nccl":
        dev = torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device=dev)
        inp = torch.load(d / "inputs.pt", map_location=dev)
        cfg = run6_config()
        model = load_model(cfg).to(dev).eval()
        out = {"mesh": mesh.describe()}

        def drive(tag, fwd, sc):
            """The path under test: launch count set to 0 just before, read
            just after."""
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            fused_round.launches = 0
            t0 = time.perf_counter()
            y, x = _forward_scene(fwd, sc)
            torch.cuda.synchronize()
            out[tag] = dict(y=y.cpu(), x=x.cpu(), launches=fused_round.launches,
                            s=time.perf_counter() - t0,
                            peak=torch.cuda.max_memory_allocated())

        scenes = {t: _scene_to(inp[t], dev) for t in ("a", "b")}
        for tag, sc in scenes.items():
            fwd, part = make_sharded_detection_forward(model, sc["graph"], sc["sta_pos"],
                                                       mesh)
            drive(tag, fwd, sc)
            n = part.n_shards
            valid = sum(int(v[(rank - dd) % n].sum())
                        for dd, v in zip(part.offsets, part.off_send_valid))
            x_l = torch.randn((sc["feat"].shape[0], part.n_local,
                               sc["feat"].shape[2], 30), device=dev)
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                halo_exchange(x_l, part, mesh)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            out[tag].update(n_local=part.n_local, halo_rows_valid=valid,
                            halo_rows_moved=part.halo_total, offsets=list(part.offsets),
                            exchange_ms=ms)
        sc = scenes["b"]
        fwd, _ = make_sharded_detection_forward(model, sc["graph"], sc["sta_pos"], mesh,
                                                wire_dtype=torch.bfloat16)
        drive("d", fwd, sc)
        n_sta = sc["feat"].shape[2]
        for tag, a in (("c_all", torch.ones_like(inp["pair_mask"])),
                       ("c_pair", inp["pair_mask"])):
            fwd, part, sub = make_subgraph_sharded_detection_forward(
                model, sc["graph"], sc["sta_pos"], mesh, a)
            drive(tag, fwd, sc)
            carried = int(sub.sel_valid[rank].sum())
            out[tag].update(n_sel=sub.n_sel, carried=carried,
                            product_bytes=part.n_local * (sub.n_sel + 1) * 30 * 4,
                            dense_product_bytes=part.n_local * n_sta * 30 * 4)
        del scenes, sc, fwd
        torch.cuda.empty_cache()

        group2 = dist.new_group([0, 1])
        if rank < 2:
            cfg_t = run6_train_config()
            mesh2 = make_mesh(group2, device=dev)
            ctx = DomainContext(**inp["ctx"])
            wb = WindowBatch(**inp["wb"])
            state = _train_ref_state(cfg_t, dev)
            step = make_train_step_from_batch(cfg_t, ctx, homogeneous_trv(cfg_t).from_cart,
                                              mesh=mesh2)
            torch.cuda.synchronize()
            dist.barrier(group=group2)
            torch.cuda.reset_peak_memory_stats()
            fused_round.launches = 0
            t0 = time.perf_counter()
            state, metrics = step(state, wb)
            torch.cuda.synchronize()
            out["e"] = dict(
                s=time.perf_counter() - t0, launches=fused_round.launches,
                peak=torch.cuda.max_memory_allocated(), mesh=mesh2.describe(),
                windows=int(wb.feat.shape[0]) // mesh2.size,
                grads={n: p.grad.cpu() for n, p in state.model.named_parameters()},
                params={n: p.detach().cpu() for n, p in state.model.named_parameters()},
                loss=float(metrics["loss"]))
        dist.barrier()
        torch.save(out, d / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_shard_group(d: Path, world: int):
    """Start ``world`` ranks of this script as ``--shard-worker`` processes
    (``parallel.launch.run_ranks``: killed at the time limit) and fail
    unless every one exits 0. Returns every rank's outputs."""
    import torch

    from genie_tpu_torch.parallel.launch import RankFailed, run_ranks

    try:
        run_ranks(lambda r, port: [Path(__file__).resolve(), "--shard-worker", d, r,
                                   world, port], world, d, SHARD_TIMEOUT_S, cwd=ROOT)
    except RankFailed as e:
        fail(f"[shard] {e}")
    return [torch.load(d / f"out_{r}.pt") for r in range(world)]


def shard_phase(cfg, ctx, trv, x_query, seed: int, card: str, dev="cuda",
                backend: str = "gloo", ranks: int = SHARD_RANKS):
    """Phase 14: the multi-device package. A gloo group of ``ranks``
    processes, all on ``cuda:0`` (NCCL refuses two ranks on one GPU), or,
    with ``backend="nccl"`` on a machine with several cards, an NCCL group
    of one process per card, runs (a) ``make_sharded_detection_forward`` on the run6 grid,
    (b) the same at pod width cut to one card, (c)
    ``make_subgraph_sharded_detection_forward`` at (b)'s size with an
    all-True pair mask and with run6's, (d) (b) with the bf16 wire; ranks 0
    and 1 then take (e) one data-parallel training step. This process holds
    every result against its reference on the card. Returns the kernel
    launches per rank of each path."""
    import shutil

    import torch

    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.train.trainer import generate_batch, make_train_step_from_batch

    t_all = time.time()
    dev = torch.device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    d = Path(tempfile.mkdtemp(prefix="genie-shard-"))
    (d / "device").write_text(str(dev))
    (d / "backend").write_text(backend)
    try:
        scene_a, scene_b, pmask = shard_scenes(cfg, ctx, x_query, seed, dev)
        model = load_model(cfg).to(dev).eval()
        ref = {}
        for tag, sc in (("a", scene_a), ("b", scene_b)):
            fused_round.launches = 0
            with torch.no_grad():
                ref[tag] = model.forward_detection_only(
                    sc["feat"], sc["mask"], sc["graph"], sc["sta_pos"], sc["x_query"],
                    sc["x_query_idx"], sc["t_query"])
            if fused_round.launches <= 0:
                fail(f"[shard] the dense reference ({tag}) did not launch the kernel")
        cfg_t = run6_train_config()
        wb = generate_batch(torch.Generator(device=dev).manual_seed(seed + 143), cfg_t,
                            ctx, trv.from_cart)
        state = _train_ref_state(cfg_t, dev)
        state, metrics = make_train_step_from_batch(cfg_t, ctx, trv.from_cart)(state, wb)
        ref_grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        ref_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        ref_loss = float(metrics["loss"])
        del state
        torch.save({"a": {k: (_graph_dict(v) if k == "graph" else v.cpu())
                          for k, v in scene_a.items()},
                    "b": {k: (_graph_dict(v) if k == "graph" else v.cpu())
                          for k, v in scene_b.items()},
                    "pair_mask": pmask.cpu(),
                    "ctx": {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                            for k, v in ctx._asdict().items()},
                    "wb": {k: v.cpu() for k, v in wb._asdict().items()}}, d / "inputs.pt")
        n_sta_b = scene_b["feat"].shape[2]
        del scene_a, scene_b, wb
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t_setup = time.time() - t_all
        t0 = time.time()
        outs = run_shard_group(d, ranks)
        t_group = time.time() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)

    if backend == "gloo":
        print(f"[shard] {ranks} ranks of one gloo group on one card ({card}): "
              f"{outs[0]['mesh']}. One card shows correctness, not scaling: the "
              f"ranks share its SMs and memory, and the halo crosses host memory.",
              flush=True)
    else:
        print(f"[shard] {ranks} ranks of one {backend} group, one card each "
              f"({card}): {outs[0]['mesh']}.", flush=True)
    launches = {}
    for tag, want, gate, what in (("a", ref["a"], TOL, "dense (run6 grid)"),
                                  ("b", ref["b"], TOL, "dense (pod width)"),
                                  ("c_all", ref["b"], TOL, "dense (all-True mask)"),
                                  ("d", ref["b"], 2e-2, "dense (bf16 wire)")):
        for r, o in enumerate(outs):
            res = o[tag]
            err = max(float((res["y"] - want[0].cpu()).abs().max()),
                      float((res["x"] - want[1].cpu()).abs().max()))
            rec = {k: v for k, v in res.items() if k not in ("y", "x")}
            rec.update(rank=r, max_abs_err_vs=what, max_abs_err=err,
                       peak_gib=res["peak"] / 2**30)
            print(f"[shard] ({tag}) " + json.dumps(rec), flush=True)
            if not np.isfinite(err) or err > gate:
                fail(f"[shard] ({tag}) rank {r}: max |sharded - {what}| = {err} > {gate}")
            if res["launches"] <= 0:
                fail(f"[shard] ({tag}) rank {r} launched the fused_round kernel 0 times")
        launches[tag] = [o[tag]["launches"] for o in outs]
    for r, o in enumerate(outs):
        d16 = float((o["d"]["y"] - o["b"]["y"]).abs().max())
        if not 0.0 < d16 <= 2e-2:
            fail(f"[shard] (d) rank {r}: bf16 wire vs f32 wire {d16} (want (0, 2e-2])")
        pr = o["c_pair"]
        rec = {k: v for k, v in pr.items() if k not in ("y", "x")}
        rec.update(rank=r, n_sta=n_sta_b, product_share_of_dense=pr["product_bytes"]
                   / pr["dense_product_bytes"], peak_gib=pr["peak"] / 2**30,
                   max_abs_diff_vs_rank0=float((pr["y"] - outs[0]["c_pair"]["y"]).abs().max()),
                   max_abs_diff_vs_dense=float((pr["y"] - ref["b"][0].cpu()).abs().max()),
                   bf16_vs_f32_wire=d16)
        print("[shard] (c_pair) " + json.dumps(rec), flush=True)
        if not (torch.isfinite(pr["y"]).all() and torch.isfinite(pr["x"]).all()):
            fail(f"[shard] (c) rank {r}: the pair-masked forward is not finite")
        if not rec["max_abs_diff_vs_rank0"] <= TOL:
            fail(f"[shard] (c) ranks 0 and {r} returned different outputs")
        if pr["launches"] <= 0:
            fail(f"[shard] (c) rank {r} launched the fused_round kernel 0 times")
    launches["c_pair"] = [o["c_pair"]["launches"] for o in outs]

    grad_rel, param_err = {}, 0.0
    for r, o in enumerate(outs[:2]):
        e = o["e"]
        for n, g in ref_grads.items():
            g = g.cpu()
            rel = float((e["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
            grad_rel[n] = max(grad_rel.get(n, 0.0), rel)
            param_err = max(param_err, float((e["params"][n] - ref_params[n].cpu())
                                             .abs().max()))
        print("[shard] (e) " + json.dumps({
            "rank": r, "mesh": e["mesh"], "windows": e["windows"], "s": e["s"],
            "launches": e["launches"], "peak_gib": e["peak"] / 2**30, "loss": e["loss"],
            "loss_one_process": ref_loss}), flush=True)
        if e["launches"] != 4 * e["windows"]:
            fail(f"[shard] (e) rank {r}: {e['launches']} launches for {e['windows']} "
                 f"windows")
    worst = max(grad_rel, key=grad_rel.get)
    print("[shard] (e) " + json.dumps({
        "max_rel_grad_err": grad_rel[worst], "worst_param": worst,
        "max_abs_param_err_after_adam": param_err, "n_params": len(grad_rel)}), flush=True)
    if not grad_rel[worst] <= 1e-3:
        fail(f"[shard] (e) gradient of {worst} off by {grad_rel[worst]} of its max |g|")
    if not param_err <= 1e-5:
        fail(f"[shard] (e) weights after Adam off by {param_err}")
    launches["e"] = [o["e"]["launches"] for o in outs[:2]]
    print(f"[shard] set-up {t_setup:.1f} s, group {t_group:.1f} s, phase "
          f"{time.time() - t_all:.1f} s", flush=True)
    return launches


# -- phase 16: [evaluate] ----------------------------------------------------------
# the JSON keys of scripts/eval_synthetic.py
EVAL_KEYS = ("steps", "train_s_per_step", "infer_time_s", "n_true", "n_detected",
             "n_matched", "precision", "recall", "f1", "median_epi_err_m",
             "median_t_err_s")


# evaluate's 500 training steps are cut to this budget; the gates need at
# least EVAL_MIN_STEPS of them
EVAL_BUDGET_S = 18.0
EVAL_MIN_STEPS = 20


# the port's 3000-step detector, JAX's evaluation timeline (PRNGKey(1234),
# with JAX's detection query grid) and JAX's CPU catalog of it at those
# weights, threshold 0.2 (tests/test_torch_port_eval_trained.py holds each
# file to a live JAX draw or run)
EVAL_DIR = ROOT / "projects" / "eval_synthetic"
# a pair of catalog events (in time order) matches within EVAL_KM metres and
# EVAL_SEC seconds; farther apart, it must hold the same picks, the port's DE
# objective (trimmed mean |residual|, s) at JAX's location must equal JAX's
# own value there within EVAL_COST, and the port's locator, run again on
# those picks with EVAL_RERUNS more draws, must reach a minimum no more than
# EVAL_COST above it. The two packages' locators draw different numbers,
# and each lands, for some draws, in a shallower local minimum kilometres
# from the deepest (JAX against itself under other keys does too; see
# tests/test_torch_port_eval_files.py::test_locators_agree_in_distribution).
EVAL_KM, EVAL_SEC, EVAL_COST, EVAL_RERUNS = 1e3, 0.2, 1e-3, 8


def held_process_config(cfg):
    """The held catalog's settings: one refinement offset, the candidate
    itself (``n_rand_query = refine_chunk = 1``), so the refinement draws
    no random offsets in either package, as in
    ``tests/test_torch_port_pipeline.py``."""
    cfg.process.n_rand_query = 1
    cfg.process.refine_chunk = 1
    return cfg


def eval_timeline_scores(params_path, threshs, dev="cuda", timeline_seed=None,
                         held=False):
    """The detector saved at ``params_path`` (``eval_synthetic
    --save-params``) on ``eval_synthetic.build``'s domain processes an 1800 s
    evaluation timeline: one sweep, then the stages after it once per
    threshold in ``threshs`` (``thresh`` and ``thresh_assoc`` both, as the
    script's ``--thresh`` sets them; ``held``: with
    :func:`held_process_config`). The timeline is JAX's committed draw, with
    JAX's query grid, when ``timeline_seed`` is None, else the port's draw as
    ``eval_synthetic.evaluate`` makes it (its own query grid). Returns
    ``(records, pipeline, picks)``, one record per threshold:
    ``eval_synthetic.score``'s dict, the fused-round launches of the sweep
    and after it (each count set to 0 just before), their seconds, and the
    catalog under ``"events"`` (dicts of :func:`catalog_event`)."""
    import torch

    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.params import load_flax_params, load_into
    from genie_tpu_torch.scripts import eval_synthetic

    cfg, ctx, tt = eval_synthetic.build(32, 200, 8, threshs[0], dev)
    if held:
        held_process_config(cfg)
    model = load_into(Detector(src_chunk=16), load_flax_params(params_path))
    if timeline_seed is None:
        z = np.load(EVAL_DIR / "timeline_1234.npz")
        picks = (z["pick_t"], z["pick_sta"], z["pick_phase"])
        true_srcs, x_query = z["true_srcs"], z["x_query_grid"]
    else:
        picks, true_srcs = eval_synthetic.eval_timeline(cfg, ctx, tt, dev, timeline_seed)
        x_query = None
    pipe = InferencePipeline(model, cfg, ctx, tt.from_cart, device=dev,
                             x_query_grid=x_query)
    t0 = time.time()
    fused_round.launches = 0
    times_s, series = pipe.detection_sweep(*picks, 0.0, 1800.0)
    torch.cuda.synchronize()
    launches_sweep, sweep_s = fused_round.launches, time.time() - t0
    out = []
    for th in threshs:
        cfg.process.thresh = cfg.process.thresh_assoc = th
        t0 = time.time()
        fused_round.launches = 0
        events = pipe.process_from_sweep(times_s, series, *picks)
        torch.cuda.synchronize()
        out.append({"thresh": th, "timeline": "jax" if timeline_seed is None else
                    timeline_seed, "held": held, "sweep_s": sweep_s,
                    "after_s": time.time() - t0, "launches_sweep": launches_sweep,
                    "launches_after_sweep": fused_round.launches,
                    **eval_synthetic.score(events, true_srcs),
                    "events": [catalog_event(e) for e in events]})
    return out, pipe, picks


def catalog_event(ev) -> dict:
    return {"pos_cart": [float(v) for v in ev.pos_cart], "time": float(ev.time),
            "picks": [int(i) for i in ev.picks],
            "pick_phases": [int(p) for p in ev.pick_phases]}


def _event_arrays(pipe, picks, ev, rows: int = 1):
    """``ev``'s picks as the locator's (rows, L) arrays, times relative to
    the event's."""
    import torch

    pick_t, pick_sta, _ = picks
    idx = np.asarray(ev["picks"], np.int64)
    dev = pipe.device
    tp = torch.as_tensor(pick_t[idx] - float(ev["time"]), dtype=torch.float32,
                         device=dev).repeat(rows, 1)
    ip = torch.as_tensor(pick_sta[idx], dtype=torch.int32, device=dev).repeat(rows, 1)
    ph = torch.as_tensor(np.asarray(ev["pick_phases"], np.float32),
                         device=dev).repeat(rows, 1)[..., None]
    return tp, ip, ph, torch.ones_like(tp, dtype=torch.bool)


def location_cost(pipe, picks, ev, x4) -> float:
    """The DE objective of ``pipe``'s locator (trimmed mean |residual|, s)
    for ``ev``'s picks and phases at ``x4`` = (x, y, z, t)."""
    import torch

    from genie_tpu_torch.infer.locate import make_location_objective

    fn = make_location_objective(pipe.trv, pipe.ctx.sta_cart,
                                 *_event_arrays(pipe, picks, ev),
                                 pipe.cfg.process.trim_fraction)
    cand = torch.tensor([[[*x4[:3], x4[3] - float(ev["time"])]]], dtype=torch.float32,
                        device=pipe.device)
    with torch.no_grad():
        return float(fn(cand)[0, 0])


def relocated_cost(pipe, picks, ev, rows: int = EVAL_RERUNS) -> float:
    """The lowest DE objective of ``rows`` more runs of ``pipe``'s locator on
    ``ev``'s picks (one batch, a generator seeded 1)."""
    import torch

    from genie_tpu_torch.infer.locate import locate_sources_batched

    ctx, dev = pipe.ctx, pipe.device
    lo = torch.cat((ctx.offset_cart, torch.tensor([-30.0], device=dev)))
    hi = torch.cat((ctx.offset_cart + ctx.scale_cart, torch.tensor([30.0], device=dev)))
    with torch.no_grad():
        _, _, cost = locate_sources_batched(
            torch.Generator(device=dev).manual_seed(1), pipe.trv, ctx.sta_cart,
            *_event_arrays(pipe, picks, ev, rows), lo, hi,
            trim_fraction=pipe.cfg.process.trim_fraction)
    return float(cost.min())


def match_catalog(got, want, pipe, picks) -> dict:
    """The port's catalog ``got`` (dicts of :func:`catalog_event`) against
    JAX's ``want`` (the same, with JAX's objective at each location under
    ``"cost"``), pairs in time order: the counts; the pairs within
    ``EVAL_KM`` and ``EVAL_SEC`` (``close``); the others that hold the same
    picks, where the port's objective at JAX's location equals JAX's cost
    and the port's locator reaches that depth (``equal_cost``; see
    ``EVAL_COST``); the largest distance and time difference, the largest
    objective difference at JAX's locations over the pairs with the same
    picks, and the largest excess of the port's deepest minimum over JAX's
    cost; ``ok`` when every pair is close or of equal cost."""
    got = sorted(got, key=lambda e: e["time"])
    want = sorted(want, key=lambda e: e["time"])
    out = {"n": len(got), "n_jax": len(want), "close": 0, "equal_cost": 0,
           "max_m": 0.0, "max_s": 0.0, "max_objective_diff": 0.0,
           "max_depth_excess": 0.0, "ok": False}
    if len(got) != len(want) or not got:
        return out
    for a, b in zip(got, want):
        xa = np.array([*a["pos_cart"], a["time"]], np.float64)
        xb = np.array([*b["pos_cart"], b["time"]], np.float64)
        d, dt = float(np.linalg.norm(xa[:3] - xb[:3])), float(abs(xa[3] - xb[3]))
        out["max_m"], out["max_s"] = max(out["max_m"], d), max(out["max_s"], dt)
        same = sorted(a["picks"]) == sorted(b["picks"])
        agree = True
        if same:
            diff = abs(location_cost(pipe, picks, a, xb) - b["cost"])
            out["max_objective_diff"] = max(out["max_objective_diff"], diff)
            agree = diff <= EVAL_COST
        if d < EVAL_KM and dt < EVAL_SEC:
            out["close"] += agree
        elif same and agree:
            deepest = min(location_cost(pipe, picks, a, xa),
                          relocated_cost(pipe, picks, a))
            out["max_depth_excess"] = max(out["max_depth_excess"], deepest - b["cost"])
            out["equal_cost"] += deepest <= b["cost"] + EVAL_COST
    out["ok"] = out["close"] + out["equal_cost"] == len(got)
    return out


def score_eval(specs, card):
    """``--score-eval PARAMS:SEED ...``: each detector at thresholds 0.2 and
    0.3 on JAX's committed timeline and on its own (the port's draw seeded
    SEED), one JSON line per detector, timeline and threshold."""
    for spec in specs:
        path, seed = spec.rsplit(":", 1)
        for tl in (None, int(seed)):
            recs, _, _ = eval_timeline_scores(path, (0.2, 0.3), timeline_seed=tl)
            for rec in recs:
                rec["events"] = [[*e["pos_cart"], e["time"], len(e["picks"])]
                                 for e in rec["events"]]
                print(f"[score-eval] {json.dumps({'params': path, 'card': card, **rec})}",
                      flush=True)


def _mean_loss(model, cfg, ctx, tt, batches) -> float:
    import torch

    from genie_tpu_torch.train.trainer import loss_fn

    with torch.no_grad():
        return float(np.mean([float(loss_fn(model, ctx, cfg, wb, tt.from_cart)[0])
                              for wb in batches]))


def evaluate_phase(seed: int, card: str, dev="cuda"):
    """Phase 16: ``scripts/eval_synthetic.py``'s protocol at its defaults
    through ``genie_tpu_torch.scripts.eval_synthetic``: first the kernel's
    three round forms (and edge forms) at the shapes this path launches (32
    stations, k = 8; a training forward takes 1 window × 200 sources, a
    sweep batch 16 × 200) and the ``FusedRound`` backward at the training
    shape, then ``evaluate`` trains from flax-default weights (cut at
    ``EVAL_BUDGET_S``), processes an 1800 s timeline and scores it. Gates:
    at least ``EVAL_MIN_STEPS`` steps; the first 10 training batches
    (replayed from the training generator: batch 0 at the initial weights
    must give step 0's loss) have a lower mean loss under the trained
    weights than the first 10 steps recorded; 5 held-out batches from
    another generator have a lower loss under the trained weights than
    under the initial ones; every loss finite; both paths launch the
    kernel; the JSON has the JAX script's keys; ``save_params``' pickle
    has run6's flax tree names and shapes. A step's loss grows with the
    planted events in its batch, so the mean of the last 10 steps against
    the first 10 (printed) measures the batches as much as the weights.
    The briefly trained detector finds nothing at the script's threshold,
    so run6's trained weights (the same architecture) then process the same
    timeline: the catalog must be non-empty and finite, and the stages after
    the sweep (refinement, association) must launch the kernel. Last, the
    committed 3000-step detector processes JAX's committed timeline and its
    catalog must hold JAX's CPU catalog (``match_catalog``), with launches
    in the sweep and after it. Returns the launches per path and the check
    records."""
    import torch

    from genie_tpu_torch.graphs.build import build_station_graph
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.ops.pinn_trv import pinn_trv
    from genie_tpu_torch.ops.segment import aggregation_weights
    from genie_tpu_torch.params import flatten_tree, load_flax_params
    from genie_tpu_torch.scripts import eval_synthetic
    from genie_tpu_torch.train.trainer import generate_batch, init_train_state

    t_phase = time.time()
    cfg, ctx, tt = eval_synthetic.build(32, 200, 8, 0.3, dev)
    nbr, valid = build_station_graph(ctx.sta_cart, cfg.graph.k_sta_edges)
    sta_nbr = nbr.to(torch.int32).contiguous()
    sta_w = aggregation_weights(nbr, valid).contiguous()
    records = []
    for n_win in (1, 16):
        r0, r4 = check_kernel(sta_nbr, sta_w, seed + 150, n_win=n_win, n_src=200,
                              dense_entry=False)
        records += r0 + r4
    bwd = check_backward(sta_nbr, sta_w, seed + 150, dev, lead=(1, 200), tag="evaluate")
    torch.cuda.empty_cache()
    checks_s = time.time() - t_phase

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    steps = 500         # the JAX script's default
    out, info = eval_synthetic.evaluate(cfg, ctx, tt, steps, dev, budget_s=EVAL_BUDGET_S)
    torch.cuda.synchronize()
    evaluate_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    n, losses = out["steps"], np.asarray(info["losses"])
    print(f"[evaluate] reduced: steps {steps} -> {n} (training cut at "
          f"{EVAL_BUDGET_S:.0f} s)", flush=True)
    print(f"[evaluate] {json.dumps(out)}", flush=True)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    # the first 10 batches again: the training generator replayed
    gen = torch.Generator(device=dev).manual_seed(0)
    model0 = init_train_state(Detector(src_chunk=16).to(dev), cfg, gen).model
    batches = [generate_batch(gen, cfg, ctx, tt.from_cart) for _ in range(10)]
    replay0 = _mean_loss(model0, cfg, ctx, tt, batches[:1])
    trained = _mean_loss(info["model"], cfg, ctx, tt, batches)
    # 5 batches that training never saw
    gen = torch.Generator(device=dev).manual_seed(seed + 152)
    held = [generate_batch(gen, cfg, ctx, tt.from_cart) for _ in range(5)]
    held_init = _mean_loss(model0, cfg, ctx, tt, held)
    held_trained = _mean_loss(info["model"], cfg, ctx, tt, held)
    del model0, batches, held
    rec = {"card": card, "checks_s": checks_s, "evaluate_s": evaluate_s,
           "steps": n, "s_per_step": out["train_s_per_step"],
           "loss_first10": first, "loss_last10": last,
           "loss_first10_batches_trained": trained, "loss_step0_replayed": replay0,
           "loss_heldout_initial": held_init, "loss_heldout_trained": held_trained,
           "launches_train": info["launches_train"],
           "launches_per_step": info["launches_train"] / max(n, 1),
           "launches_process": info["launches_process"], "events": len(info["events"]),
           "infer_time_s": out["infer_time_s"], "peak_gib": peak / 2**30}
    print(f"[evaluate] {json.dumps(rec)}", flush=True)
    if not np.isfinite(losses).all():
        fail(f"[evaluate] a training loss is not finite: {losses.tolist()}")
    if n < EVAL_MIN_STEPS:
        fail(f"[evaluate] {n} training steps in {EVAL_BUDGET_S} s, under {EVAL_MIN_STEPS}")
    if not abs(replay0 - losses[0]) <= 1e-5 * abs(losses[0]):
        fail(f"[evaluate] the replayed batch 0 gives {replay0}, step 0 gave {losses[0]}")
    if not trained < first:
        fail(f"[evaluate] the first 10 batches' loss under the trained weights "
             f"{trained} is not under their loss in training {first} ({n} steps)")
    if not held_trained < held_init:
        fail(f"[evaluate] the held-out batches' loss under the trained weights "
             f"{held_trained} is not under their loss at the initial weights {held_init}")
    if info["launches_train"] <= 0 or info["launches_process"] <= 0:
        fail(f"[evaluate] kernel launches: training {info['launches_train']}, "
             f"processing {info['launches_process']}")
    if tuple(out) != EVAL_KEYS:
        fail(f"[evaluate] JSON keys {list(out)} are not the JAX script's {EVAL_KEYS}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "params.pkl"
        eval_synthetic.save_params(info["model"], path)
        saved = {k: v.shape for k, v in flatten_tree(load_flax_params(path)).items()}
    run6 = {k: v.shape for k, v in flatten_tree(load_flax_params(RUN6 / "params.pkl"))
            .items()}
    if saved != run6:
        fail(f"[evaluate] saved params differ from run6's tree: "
             f"{sorted(set(saved) ^ set(run6))}")
    print(f"[evaluate] save_params: {len(saved)} leaves, run6's flax names and shapes",
          flush=True)

    # the stages after the sweep at 32 stations: the briefly trained detector
    # finds nothing, so run6's trained weights (the same architecture) process
    # the same timeline at the script's threshold
    pick_t, pick_sta, pick_ph = info["picks"]
    pipe = InferencePipeline(load_model(cfg), cfg, ctx, tt.from_cart, device=dev)
    t1 = time.time()
    fused_round.launches = 0
    times_s, series = pipe.detection_sweep(pick_t, pick_sta, pick_ph, 0.0, 1800.0)
    launches_sweep = fused_round.launches
    fused_round.launches = 0
    pinn_trv.launches = 0
    events = pipe.process_from_sweep(times_s, series, pick_t, pick_sta, pick_ph)
    launches_after = fused_round.launches
    record_pinn_launches("evaluate_run6_process", pinn_trv.launches, len(events),
                         pinn=False)
    ev4 = np.array([[*ev.pos_cart, ev.time] for ev in events]).reshape(-1, 4)
    post = {"seconds": time.time() - t1, "series_max": float(np.max(series)),
            "launches_sweep": launches_sweep, "launches_after_sweep": launches_after,
            "stage_seconds": pipe.stage_seconds,
            **eval_synthetic.score(events, info["true_srcs"])}
    print(f"[evaluate] run6 weights {json.dumps(post)}", flush=True)
    if not events or not np.isfinite(ev4).all() or launches_after <= 0:
        fail(f"[evaluate] run6's weights gave {len(events)} events (finite: "
             f"{bool(np.isfinite(ev4).all())}) with {launches_after} launches after "
             f"the sweep")
    del pipe, series

    # the port's 3000-step detector on JAX's evaluation timeline at threshold
    # 0.2, held to JAX's catalog of it at those weights
    recs, pipe_t, picks_t = eval_timeline_scores(EVAL_DIR / "params.pkl", (0.2,), dev,
                                                 held=True)
    rec_t = recs[0]
    want = json.loads((EVAL_DIR / "catalog_jax.json").read_text())
    match = match_catalog(rec_t["events"], want["events"], pipe_t, picks_t)
    del pipe_t
    shown = {k: v for k, v in rec_t.items() if k != "events"}
    print(f"[evaluate] 3000-step weights on JAX's timeline (held settings) "
          f"{json.dumps({**shown, 'vs_jax': match, 'jax_score': want['score']})}",
          flush=True)
    counts = [(k, rec_t[k], want["score"][k]) for k in ("n_true", "n_detected", "n_matched")]
    if not match["ok"] or any(a != b for _, a, b in counts):
        fail(f"[evaluate] the 3000-step catalog differs from JAX's: {match}, score "
             f"counts (port, JAX) {counts} (see EVAL_KM, EVAL_SEC, EVAL_COST)")
    if rec_t["launches_sweep"] <= 0 or rec_t["launches_after_sweep"] <= 0:
        fail(f"[evaluate] 3000-step weights: {rec_t['launches_sweep']} launches in the "
             f"sweep, {rec_t['launches_after_sweep']} after it")

    # one more training step of the trained weights under the profiler
    from torch.profiler import ProfilerActivity, profile

    from genie_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step

    model = info["model"].train()
    state = TrainState(model, make_optimizer(model, cfg), 0)
    step_fn = make_train_step(cfg, ctx, tt.from_cart)
    gen = torch.Generator(device=dev).manual_seed(seed + 151)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        step_fn(state, gen)
        torch.cuda.synchronize()
        wall_p = time.time() - t1
    summarize_profile(prof, wall_p, "profile evaluate train", ranges=(
        "generate", "forward_backward", "optimizer", "FusedRound", "FusedRoundBackward"))
    print(f"[evaluate] phase {time.time() - t_phase:.1f} s", flush=True)
    return ({"evaluate_train": info["launches_train"],
             "evaluate_process": info["launches_process"],
             "evaluate_run6_process": launches_sweep + launches_after,
             "evaluate_trained_sweep": rec_t["launches_sweep"],
             "evaluate_trained_after_sweep": rec_t["launches_after_sweep"]}, records, bwd)


# -- phase 17: [scaling] -----------------------------------------------------------
MEASURED_SCALING = ROOT / "projects" / "NC_EHZ" / "measured_scaling_virtual8.json"


def scaling_phase(card: str, dev="cuda", backend: str = "gloo", ranks: int = 8,
                  sweep: bool = True):
    """Phase 17: ``measure_scaling`` at its defaults (8192 sources × 128
    stations × 30 channels, k 15) with ``ranks`` ranks (gloo: all on the
    card; nccl: one per card): with 8 ranks the halo rows of the plan (graph
    on the CPU) must be the JAX run's 2673 valid and 5032 moved
    (``projects/NC_EHZ/measured_scaling_virtual8.json``); the plan from the
    graph built on the card is printed beside; the sharded mean must equal
    the dense one within 1e-5. Then (``sweep``) ``scaling_model
    --halo-sweep`` at its defaults with the card's constants."""
    import torch

    from genie_tpu_torch.scripts import measure_scaling, scaling_model

    t_phase = time.time()
    try:
        res = measure_scaling.measure(ranks=ranks, backend=backend, device=dev)
    except RuntimeError as e:
        fail(f"[scaling] {e}")
    print(f"[scaling] measure_scaling {json.dumps({**res, 'card': card})}", flush=True)
    on_card = measure_scaling.partition_stats(res["n_src"], res["k_src"], ranks, dev)
    print(f"[scaling] plan from the graph built on the card: {json.dumps(on_card)}",
          flush=True)
    if ranks == 8:
        want = json.loads(MEASURED_SCALING.read_text())
        for k in ("halo_rows_exchanged", "halo_rows_moved_padded"):
            if res[k] != want[k]:
                fail(f"[scaling] {k} {res[k]}, the JAX run's {want[k]}")
    if not res["max_abs_diff_vs_dense"] <= 1e-5:
        fail(f"[scaling] sharded vs dense {res['max_abs_diff_vs_dense']} > 1e-5")
    out = {"measure": res}
    if sweep:
        torch.cuda.empty_cache()
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        sw = scaling_model.main(["--halo-sweep"])
        rec = {k: v for k, v in sw.items() if k != "points"}
        rec.update(points=[list(p) for p in sw["points"]], seconds=time.time() - t0,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
        print(f"[scaling] scaling_model --halo-sweep {json.dumps(rec)}", flush=True)
        out["sweep"] = rec
    print(f"[scaling] phase {time.time() - t_phase:.1f} s", flush=True)
    return out


# -- phase 15 --------------------------------------------------------------
# Runs one command module as ``python -m`` does (runpy, as __main__), then
# prints the process's peak device memory.
_RUN_AS_MAIN = ("import json, runpy, sys, torch; sys.argv = sys.argv[1:]; "
                "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True); "
                "print('[peak] ' + json.dumps(torch.cuda.max_memory_allocated()))")


def start_command(module: str, *args):
    """``python -m genie_tpu_torch.scripts.<module> <args>`` in a process of
    its own, from the repo root."""
    cmd = [sys.executable, "-c", _RUN_AS_MAIN, f"genie_tpu_torch.scripts.{module}",
           *map(str, args)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_command(proc, label: str, timeout: float = 600.0):
    """Wait for a command; fail with its exit code and the end of its
    stderr. Returns (stdout, peak device bytes of its process)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"[workflow] {label} did not end within {timeout:.0f} s")
    if proc.returncode != 0:
        fail(f"[workflow] {label} exited {proc.returncode}:\n{err[-4000:]}")
    return out, json.loads(out.rsplit("[peak] ", 1)[1])


def workflow_phase(ctx, pinn, seed: int, dev="cuda", config=None, grid_steps: int = 200,
                   fmm_every: int = 47, pinn_steps: int = 100, reloc_steps: int = 100):
    """Phase 15, ``[workflow]``: the README's commands
    (``genie_tpu_torch.scripts``) in a project directory under
    ``chip_scratch/``, handing over through its files: ``init_project``,
    ``calculate_travel_times build`` and ``train``, ``train_model`` as
    processes of their own; then the device functions of
    ``process_continuous_days``, ``calibrate`` and ``relocate`` in this
    process on the catalog in memory (the machine has no h5py). Returns
    the kernel launches of the process step."""
    import shutil

    import torch

    from genie_tpu_torch.calibration.corrections import (fit_corrections,
                                                         interp_weighted,
                                                         matched_catalog_stats)
    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.io import load_picks
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.ops.pinn_trv import pinn_trv
    from genie_tpu_torch.params import _load_pickle, load_magnitude_model, load_pinn
    from genie_tpu_torch.scripts import CHECKPOINT_FILE, PINN_FILE
    from genie_tpu_torch.scripts.calibrate import correction_observations
    from genie_tpu_torch.scripts.process_continuous_days import load_inputs
    from genie_tpu_torch.scripts.relocate import (build_graphs, catalog_observations,
                                                  run_relocate)
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.workflow import (build_fmm_tables, domain_from_project,
                                          make_trv, process_picks)

    config = RUN6 / "config.yaml" if config is None else config
    cfg = load_config(config)
    dev_args = () if dev == "cuda" else ("--device", dev)
    t_phase = time.time()
    (ROOT / "chip_scratch").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "chip_scratch")
    root = Path(tmp.name) / cfg.region.name
    root.mkdir()
    rec = {}

    def record(name, wall, peak, **extra):
        rec[name] = {"wall_s": wall, "peak_bytes": peak, "peak_gib": peak / 2**30, **extra}
        print(f"[workflow] command {name} " + json.dumps(rec[name]), flush=True)

    # 1. stations.txt and picks.txt → init_project
    sta_lla = ctx.sta_lla.cpu().numpy().astype(np.float64)
    n_sta = len(sta_lla)
    names = [f"W{i:03d}" for i in range(n_sta)]
    (root / "stations.txt").write_text("".join(
        f"{nm} {a:.6f} {b:.6f} {c:.1f}\n" for nm, (a, b, c) in zip(names, sta_lla)))
    mag = load_magnitude_model(MAGNITUDES, device=dev)
    t_p, s_p, ph_p, ev_pos, ev_t, amp_p, ev_mag = make_picks(ctx, pinn, seed + 20, mag=mag)
    lines = [f"2017-9-10 {t:.4f} {names[s]} {'P' if ph == 0 else 'S'} {a:.9g}\n"
             for t, s, ph, a in zip(t_p, s_p, ph_p, amp_p)]
    (root / "picks.txt").write_text("".join(lines))
    t0 = time.time()
    out, peak = finish_command(start_command(
        "init_project", root, "--config", config, "--stations", root / "stations.txt",
        "--picks", root / "picks.txt", "--grid-steps", grid_steps, *dev_args),
        "init_project")
    record("init_project", time.time() - t0, peak)
    pj = load_project(root, cfg.region.name)
    proj = pj["projection"]
    grids = pj["grids_lla"]
    pick_file = root / "Picks" / "2017" / f"{cfg.region.name}_2017_9_10_ver_1.npz"
    t, sta, ph, amp = load_picks(pick_file)
    want_t = np.array([float(ln.split()[1]) for ln in lines])
    files_ok = all((root / f).exists() for f in (
        f"{cfg.region.name}_stations.npz", f"{cfg.region.name}_region.npz",
        "1d_velocity_model.npz"))
    picks_ok = (np.array_equal(t, want_t) and np.array_equal(sta, s_p)
                and np.array_equal(ph, ph_p))
    print("[workflow] init " + json.dumps({
        "files": files_ok, "grids": list(grids.shape),
        "grids_finite": bool(np.isfinite(grids).all()), "picks": len(t),
        "picks_equal_written": bool(picks_ok), "stdout": out.splitlines()[:4]}), flush=True)
    if not (files_ok and grids.shape == (cfg.graph.n_grids, cfg.graph.n_spatial_nodes, 3)
            and np.isfinite(grids).all()):
        fail("[workflow] init_project did not write the project's files")
    if not picks_ok:
        fail("[workflow] the converted pick file differs from picks.txt")

    # 2. the FMM build: --job j --n-jobs n_sta for every fmm_every-th station,
    #    started together as a job array, beside one station built in-process
    idx = list(range(0, n_sta, fmm_every))
    t0 = time.time()
    procs = [start_command("calculate_travel_times", root, "build", "--config", config,
                           "--job", j, "--n-jobs", n_sta, *dev_args) for j in idx]
    try:
        ref_dir = Path(tmp.name) / "fmm_in_process"
        build_fmm_tables(cfg, proj, np.asarray(pj["sta_lla"], float), ref_dir,
                         station_indices=[idx[-1]], verbose=False)
        peaks = [finish_command(pr, f"build --job {j}")[1] for pr, j in zip(procs, idx)]
    finally:    # a failed job ends the script: stop the others first
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    record("calculate_travel_times build", time.time() - t0, max(peaks), jobs=len(idx))
    name = f"travel_time_grid_station_{idx[-1]}.npz"
    za, zb = np.load(root / "TravelTimeData" / name), np.load(ref_dir / name)
    same = sorted(za.files) == sorted(zb.files) and all(
        np.array_equal(za[k], zb[k]) for k in za.files)
    built = sorted(int(f.stem.split("_")[-1])
                   for f in (root / "TravelTimeData").glob("travel_time_grid_station_*.npz"))
    print("[workflow] fmm " + json.dumps({"stations": built, "of": n_sta,
                                          "table_equals_in_process": bool(same),
                                          "shape": list(za["Tp"].shape)}), flush=True)
    if built != idx or not same:
        fail(f"[workflow] the FMM build gave stations {built} (want {idx}); table of "
             f"station {idx[-1]} equal to the in-process build: {same}")

    # 3. the PINN on those tables
    t0 = time.time()
    out, peak = finish_command(start_command(
        "calculate_travel_times", root, "train", "--config", config, "--steps", pinn_steps,
        *dev_args), "train")
    m = _load_pickle(root / PINN_FILE)["metrics"]
    record("calculate_travel_times train", time.time() - t0, peak, **m)
    trained = load_pinn(root / PINN_FILE, projection=proj, device=dev)
    with torch.no_grad():
        tt = trained.from_cart(ctx.sta_cart[:8], ctx.sta_cart[:4] + 1e4)
    if not (m["loss_last"] < m["loss_first"] and bool(torch.isfinite(tt).all())):
        fail(f"[workflow] PINN loss {m['loss_first']} -> {m['loss_last']}, times finite "
             f"{bool(torch.isfinite(tt).all())}")
    # a PINN of a few hundred steps is not one to serve: the project takes the
    # production PINN (Grids/pinn_nc.pkl, 40,000 steps on this region's FMM
    # box), as a project would after a full `train`; the picks were timed by it
    shutil.copy(PINN, root / PINN_FILE)

    # 4. train_model: two steps past run6's step 20000
    shutil.copy(RUN6 / "params.pkl", root / CHECKPOINT_FILE)
    t0 = time.time()
    out, peak = finish_command(start_command(
        "train_model", root, "--config", config, "--restart", "--steps", 20002, *dev_args),
        "train_model")
    logged = [ln for ln in out.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split()[3]) for ln in logged]
    blob = _load_pickle(root / CHECKPOINT_FILE)
    record("train_model", time.time() - t0, peak, steps=[int(ln.split()[1]) for ln in logged],
           losses=losses, ckpt_step=int(blob["step"]),
           adam_count=int(np.asarray(blob["opt_state"]["count"])))
    if not (len(losses) == 2 and np.isfinite(losses).all() and int(blob["step"]) == 20002
            and int(np.asarray(blob["opt_state"]["count"])) == 20002):
        fail(f"[workflow] train_model: {rec['train_model']}")

    # 5. process_continuous_days' device function, against the pipeline's API
    (ctx_w, trv_w, model), load_s, _ = _timed(lambda: load_inputs(root, cfg, dev))
    fused_round.launches = 0
    pinn_trv.launches = 0
    events, proc_s, peak = _timed(lambda: process_picks(
        cfg, ctx_w, trv_w, model, t, sta, ph, amp, 0.0, 600.0, device=dev))
    launches = fused_round.launches
    record_pinn_launches("workflow_process", pinn_trv.launches, len(events), pinn=True)
    pipe = InferencePipeline(model, cfg, ctx_w, trv_w.from_cart, device=dev)
    fused_round.launches = 0
    events_api = pipe.process(t.astype(np.float32), sta, ph.astype(np.float32), 0.0, 600.0,
                              pick_amp=amp)
    launches_api = fused_round.launches
    del pipe
    d_pos = max((float(np.linalg.norm(a.pos_cart - b.pos_cart))
                 for a, b in zip(events, events_api)), default=0.0)
    d_t = max((abs(a.time - b.time) for a, b in zip(events, events_api)), default=0.0)
    same = len(events) == len(events_api) and all(
        np.array_equal(a.picks, b.picks) for a, b in zip(events, events_api))
    record("process_continuous_days (process_picks)", proc_s, peak, load_inputs_s=load_s,
           events=len(events), launches=launches, api_launches=launches_api,
           api_events=len(events_api), max_pos_diff_m=d_pos, max_time_diff_s=d_t)
    print(f"[workflow] process: fused_round launches {launches} (the API request "
          f"{launches_api})", flush=True)
    if not (same and d_pos <= 1.0 and d_t <= 1e-3):
        fail(f"[workflow] process_picks gave {len(events)} events, the API "
             f"{len(events_api)} (picks equal {same}, {d_pos} m, {d_t} s)")
    if not (launches > 0 and launches == launches_api):
        fail(f"[workflow] process launched the kernel {launches} times, the API "
             f"request {launches_api}")
    planted_matches("workflow", events, (t, sta, ph, ev_pos, ev_t))
    import importlib.util

    h5py_here = "present" if importlib.util.find_spec("h5py") else "absent"
    print(f"[workflow] HDF5: the smoke writes and reads no catalog file (h5py is "
          f"{h5py_here} here; the H100 machine it was written for has none): "
          f"process_continuous_days' output, calibrate's and relocate's input and "
          f"init_project --catalog are tested on the CPU only "
          f"(tests/test_torch_port_scripts*.py)", flush=True)

    # 6. calibrate's device work: statistics and corrections against the
    #    planted events, on homogeneous times as the command takes them
    trv_h = make_trv(cfg, proj, device=dev)
    ctx_h, _, _ = domain_from_project(root, cfg, trv=trv_h, device=dev)
    srcs_det = np.array([[*ev.pos_cart, ev.time] for ev in events]).reshape(-1, 4)
    srcs_ref = np.concatenate((ev_pos, ev_t[:, None]), axis=1)
    stats = matched_catalog_stats(srcs_det, srcs_ref, mags_ref=ev_mag)
    src, obs, msk = correction_observations(events, t, sta, srcs_det, srcs_ref,
                                            ctx_h.sta_cart.shape[0])
    (coefs, loss), fit_s, peak = _timed(lambda: fit_corrections(
        trv_h.from_cart, ctx_h.sta_cart, ctx_h.grids_cart[0], src, obs, msk, device=dev))
    with torch.no_grad():
        src_t = torch.as_tensor(src, device=dev)
        base = trv_h.from_cart(ctx_h.sta_cart, src_t).cpu().numpy()
        corr = interp_weighted(ctx_h.grids_cart[0], coefs, src_t).cpu().numpy()
    n_obs = max(float(msk.sum()), 1.0)
    before = float((np.abs(base - obs) * msk).sum() / n_obs)
    after = float((np.abs(base + corr - obs) * msk).sum() / n_obs)
    record("calibrate --fit-corrections", fit_s, peak, **stats, fit_loss=loss,
           mean_abs_residual_before_s=before, mean_abs_residual_after_s=after)
    if not (stats["n_matched"] == len(ev_t) and stats["residual_xy_mean"] < 5e3
            and stats["residual_t_mean"] < 0.5):
        fail(f"[workflow] calibrate's statistics against the planted events: {stats}")
    if not after < before:
        fail(f"[workflow] the corrections did not lower the residual: {before} -> {after}")

    # 7. relocate's device work at the command's defaults (20 graphs of up to 32)
    graphs = build_graphs(ctx_h, *catalog_observations(events, t, sta,
                                                       ctx_h.sta_cart.shape[0]),
                          n_graphs=20, graph_size=32)
    (new_pos, new_t, sta_corr, loss), reloc_s, peak = _timed(
        lambda: run_relocate(ctx_h, trv_h, graphs, reloc_steps))
    S = min(32, len(events))
    n_sta_g = int(graphs[0].sta_sel.shape[0])
    shapes = {"src_pos": list(new_pos.shape), "src_time": list(new_t.shape),
              "sta_corr": list(sta_corr.shape)}
    record("relocate", reloc_s, peak, steps=reloc_steps, graphs=len(graphs),
           final_loss=loss, shapes=shapes)
    finite = all(bool(torch.isfinite(a).all()) for a in (new_pos, new_t, sta_corr))
    if not (shapes == {"src_pos": [S, 3], "src_time": [S], "sta_corr": [n_sta_g, 2]}
            and finite and np.isfinite(loss)):
        fail(f"[workflow] relocate gave {shapes} (want {S} sources, {n_sta_g} stations), "
             f"finite {finite}")
    tmp.cleanup()
    print(f"[workflow] phase {time.time() - t_phase:.1f} s", flush=True)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-worker", nargs=4, metavar=("DIR", "RANK", "WORLD", "PORT"),
                    help="run one rank of the [shard] phase's group (started by "
                         "this script itself)")
    ap.add_argument("--shard-nccl", action="store_true",
                    help="on a machine with several cards: build the kernel and "
                         "run only [shard] and [scaling]'s measure_scaling, over "
                         "NCCL with one rank per card")
    ap.add_argument("--pinn-kernel", action="store_true",
                    help="build the kernels, hold the PINN kernel against the plain "
                         "forward at the DE's shapes and time both, then stop")
    ap.add_argument("--score-eval", nargs="+", metavar="PARAMS:SEED",
                    help="score eval_synthetic --save-params detectors at thresholds "
                         "0.2 and 0.3 on JAX's committed timeline and on the port's "
                         "timeline seeded SEED, then stop")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "genie_tpu_torch" / "csrc").is_dir() or not RUN6.is_dir():
        fail(f"the genie_tpu_torch package and projects/ are not next to {__file__}")
    sys.path.insert(0, str(ROOT))
    if args.shard_worker:
        d, rank, world, port = args.shard_worker
        shard_worker(d, int(rank), int(world), int(port))
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.ops.pinn_trv import pinn_trv
    from genie_tpu_torch.ops.segment import aggregation_weights

    build_kernels()
    if args.pinn_kernel:
        check_pinn_kernel(run6_config(), args.seed)
        print(f"[card] {nvidia_smi()[0]}")
        return
    if args.score_eval:
        score_eval(args.score_eval, nvidia_smi()[0])
        return
    t_mark = [time.time()]

    def mark(name):
        """Print the seconds since the previous mark, for the time budget."""
        now = time.time()
        print(f"[time] {name} {now - t_mark[0]:.1f} s (script {now - t_all:.1f} s)",
              flush=True)
        t_mark[0] = now

    mark("build")
    cfg = run6_config()
    t0 = time.time()
    ctx, trv = build_domain(cfg, args.seed)
    if args.shard_nccl:
        n = torch.cuda.device_count()
        if n < 2:
            fail(f"--shard-nccl needs several cards, found {n}")
        x_query = np.load(GRIDS / "x_query_10000.npy").astype(np.float32)
        cards = "; ".join(nvidia_smi())
        launches_s = shard_phase(cfg, ctx, trv, x_query, args.seed, cards,
                                 backend="nccl", ranks=n)
        scaling_phase(cards, backend="nccl", ranks=n, sweep=False)
        print(json.dumps({"shard_launches_per_rank": launches_s}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
        return
    model = load_model(cfg)
    x_query = np.load(GRIDS / "x_query_10000.npy").astype(np.float32)
    pipe = InferencePipeline(model, cfg, ctx, trv.from_cart, x_query_grid=x_query)
    torch.cuda.synchronize()
    print(f"[domain] {ctx.grids_cart.shape[0]} grids x {ctx.grids_cart.shape[1]} "
          f"sources x {ctx.sta_cart.shape[0]} stations, {x_query.shape[0]} query "
          f"nodes, set up in {time.time() - t0:.1f} s", flush=True)

    sta_nbr = pipe.sta_nbr
    sta_w = aggregation_weights(pipe.sta_nbr, pipe.sta_nbr_valid)
    records, edge_records = check_kernel(sta_nbr, sta_w, args.seed)
    large_records = check_kernel_large(cfg, args.seed)
    mark("kernel")

    picks = make_picks(ctx, trv, args.seed)
    print(f"[picks] {len(picks[0])} picks over 600 s, {len(picks[3])} planted "
          f"events", flush=True)
    check_sweep_window(pipe, load_model(cfg), cfg, ctx, trv, picks, x_query)

    results = []
    for call in range(2):
        torch.cuda.reset_peak_memory_stats()
        fused_round.launches = 0
        pinn_trv.launches = 0
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
    record_pinn_launches("homogeneous", pinn_trv.launches, len(events), pinn=False)
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
    del pipe
    torch.cuda.empty_cache()
    mark("homogeneous requests")
    card = nvidia_smi()[0]
    launches_s = shard_phase(cfg, ctx, trv, x_query, args.seed, card)
    torch.cuda.empty_cache()
    mark("shard")
    scaling_phase(card)
    torch.cuda.empty_cache()
    mark("scaling")

    pinn = check_pinn(ctx, args.seed)
    pinn_records = check_pinn_kernel(cfg, args.seed)
    pipe_p, ctx_p, trv_p, mag = build_production(cfg, ctx, pinn, model, x_query)
    launches_p, picks_p = production_request(pipe_p, cfg, ctx_p, trv_p, mag, args.seed)
    locate_at_limits(ctx_p, trv_p, pinn, args.seed)
    launches_x = extras_phase(pipe_p, cfg, ctx_p, trv_p, picks_p, args.seed, card)
    del pipe_p, ctx_p, trv_p, mag
    torch.cuda.empty_cache()
    mark("pinn, production, locate, extras")

    bwd_records = check_backward(sta_nbr, sta_w, args.seed)
    launches_t = train_phase(run6_train_config(), ctx, pinn, args.seed, card)
    torch.cuda.empty_cache()
    mark("train")
    bwd_edge, launches_o = options_phase(cfg, ctx, trv, x_query, picks, sta_nbr, sta_w,
                                         args.seed, card)
    torch.cuda.empty_cache()
    mark("options")
    launches_e, eval_records, bwd_eval = evaluate_phase(args.seed, card)
    torch.cuda.empty_cache()
    mark("evaluate")
    # neither phase runs the detector: its kernel must stay unlaunched
    fused_round.launches = 0
    calibrate_phase(ctx, pinn, args.seed)
    mark("calibrate")
    relocate_phase(ctx, trv, pinn, args.seed)
    launches_cr = fused_round.launches
    torch.cuda.empty_cache()
    mark("relocate")
    fused_round.launches = 0
    project_phase(pinn, args.seed)
    print(f"[project] fused_round launches {fused_round.launches} (the path runs no "
          f"detector)", flush=True)
    mark("project")
    launches_w = workflow_phase(ctx, pinn, args.seed)
    mark("workflow")
    print(f"[card] {card}")
    print(f"[total] {time.time() - t_all:.1f} s")

    r1 = records[0]
    kernels = [{
        "name": "fused_dual_round", "route": "cuda",
        "source": "genie_tpu_torch/csrc/fused_round.cu",
        "replaces": "genie_tpu/ops/pallas_fused.py:63",
        "launches": launches_t,
        "launches_by_path": {"homogeneous": launches, "production": launches_p,
                             "train": launches_t, "calibrate_and_relocate": launches_cr,
                             "options": launches_o, "extras_trace": launches_x,
                             "shard_per_rank": launches_s, "workflow_process": launches_w,
                             **launches_e},
        "max_abs_err": max(r["max_abs_err"] for r in records + edge_records
                           + large_records + eval_records),
        "max_abs_diff": max(r["max_abs_err"] for r in records + edge_records
                            + large_records + eval_records),
        "ms": r1["ms"], "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
        "bound_by": r1["bound_by"], "library_ms": r1["library_ms"],
        "forms": records,
        "edge_forms": edge_records,
        "large_network_forms": large_records,
        "eval_forms": eval_records,
        "backward_check": {"route": "pytorch ops (FusedRound.backward)",
                           "max_rel_grad_err": max(r["max_rel_grad_err"] for r in
                                                   bwd_records + bwd_edge + bwd_eval),
                           "forms": bwd_records, "edge_forms": bwd_edge,
                           "eval_forms": bwd_eval},
    }, {
        "name": "pinn_trv", "route": "cuda",
        "source": "genie_tpu_torch/csrc/pinn_trv.cu",
        "replaces": None,
        "launches": PINN_LAUNCHES["production"],
        "launches_by_path": dict(PINN_LAUNCHES),
        "max_abs_err_s": max(r["max_abs_err_s"] for r in pinn_records),
        "forms": pinn_records,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
