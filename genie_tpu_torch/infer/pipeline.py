"""Continuous-window inference pipeline: picks in, located catalog out.

Port of ``genie_tpu/infer/pipeline.py``. Stages, as in the JAX package:

  1. DETECTION SWEEP — sliding windows, batched ``window_batch`` at a time
     on the device: rasterized featurizer, ``Detector.forward_detection_only``
     on the detection query grid, ensemble-averaged over the grids and
     stacked into one ``(n_q, n_bins)`` day series (accumulated on the host
     as ``(n_bins, n_q)``), with per-batch retries and a resumable
     checkpoint.
  2. PEAKS, then 3. time groups + LocalMarching clustering (host numpy).
  4. REFINEMENT — per candidate: trunk once, then random re-queries around
     it in chunks with a running argmax (offsets from a seeded
     ``torch.Generator``; row 0 of every chunk is the candidate itself).
  5. ASSOCIATION — per source, in its own window (``per_source``, the
     default) or shared span windows (``span``): the full forward gives
     per-pick P/S weights; 6. competitive assignment over the weight-graph
     components.
  7. LOCATION + QC — batched DE location, residual pick deletion with one
     re-location, Gauss-Newton covariance and outlier removal; then dedup.
  8. MAGNITUDES — with a ``mag_model`` and pick amplitudes: per-event
     median inverted magnitude, then the magnitude → distance pick QC.

Every device stage goes through ``Detector``, whose four dual-relation
rounds run the fused-round CUDA kernel on the GPU. Without ``x_query_grid``
the detection queries are k-means packed on the device
(:func:`build_query_grid`). ``cfg.graph.use_subgraph`` zeroes the product
features outside each grid's ε+kNN pair mask (``graphs/subgraph.py``) in
every stage that featurizes a window. ``sweep_half`` is the JAX package's
bf16 sweep: the JAX forward there casts the weights and features to bf16,
but the f32 pick mask promotes every activation back to f32, so what it
computes is the f32 forward on bf16-rounded weights and features, cast to
f16 at the end; the port computes exactly that (the f32 kernel launches),
for the sweep only. ``process_from_sweep(trace=…)`` audits target events
through stages 2-7 as the JAX package's ``_ledger`` does. The HDF5 catalog
is written by ``genie_tpu_torch.io.save_catalog`` (``workflow.process_day``).
"""

from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from genie_tpu_torch import tracing
from genie_tpu_torch.config import Config
from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.calibration.magnitude_scale import (
    apply_magnitudes,
    eval_magnitude_distance,
)
from genie_tpu_torch.graphs.build import (
    build_pair_table,
    build_query_attachment,
    build_station_graph,
    kmeans_packing,
)
from genie_tpu_torch.graphs.subgraph import apply_pair_mask, pair_mask
from genie_tpu_torch.infer.assign import competitive_assignment
from genie_tpu_torch.infer.cluster import (
    connected_components,
    find_peaks_1d,
    local_marching,
    split_time_groups,
)
from genie_tpu_torch.infer.split import split_component
from genie_tpu_torch.models.detector import Detector, GraphBundle, PickSet, QuerySet
from genie_tpu_torch.synth.generator import (
    featurize_window,
    featurize_window_rasterized,
)
from genie_tpu_torch.train.trainer import DomainContext

ASSOC_MODES = ("per_source", "span")
FEATURIZERS = ("rasterized", "searchsorted")
# sweep accumulator layout code stored in checkpoint fingerprints: 1 means
# (n_bins, n_q) rows per time bin
ACC_LAYOUT = 1.0


@dataclass
class CatalogEvent:
    pos_cart: np.ndarray       # (3,)
    time: float                # absolute seconds
    picks: np.ndarray          # indices into the day pick arrays
    pick_phases: np.ndarray    # 0/1 per assigned pick
    cov: np.ndarray | None = None
    mag: float | None = None
    score: float | None = None


def build_query_grid(generator, ctx: DomainContext, n: int, n_steps: int = 100):
    """k-means pack ``n`` detection query nodes over the Cartesian domain
    box, depth weighted 2.5×, on the generator's device → (n, 3) float32."""
    return kmeans_packing(generator, ctx.scale_cart.cpu().numpy(),
                          ctx.offset_cart.cpu().numpy(), n, lambda x: x,
                          weight=np.array([1.0, 1.0, 2.5]), n_steps=n_steps)


def _check_assoc_mode(mode: str):
    if mode not in ASSOC_MODES:
        raise NotImplementedError(f"assoc_mode {mode!r} is not one of {ASSOC_MODES}")


def _bf16_rounded(model):
    """A copy of ``model`` whose floating parameters are rounded through
    bf16 and kept in their own dtype."""
    half = copy.deepcopy(model)
    with torch.no_grad():
        for p in half.parameters():
            if p.is_floating_point():
                p.copy_(p.to(torch.bfloat16).to(p.dtype))
    return half


class InferencePipeline:
    """Holds the model, domain tables and station subnetwork on one device.

    ``model`` is a :class:`Detector` with its weights loaded; it is moved to
    ``device`` (default ``cuda``; ``device="cpu"`` must be asked for).
    ``mag_model`` is the dict ``{model, grid_cart, dist_model}`` of
    ``params.load_magnitude_model`` (``dist_model`` may be None); its
    :class:`MagnitudeModel` is moved to ``device`` too. Without
    ``x_query_grid`` and with ``cfg.process.n_query_grid > 0`` the detection
    queries are k-means packed from a generator seeded with 11.
    ``sweep_half`` keeps a copy of the model whose floating parameters are
    rounded through bf16, for the detection sweep only (refinement and
    association keep the model's own weights), and returns the sweep's
    series as f16."""

    def __init__(self, model: Detector, cfg: Config, ctx: DomainContext,
                 trv_from_cart, x_query_grid=None, n_t: int = 9,
                 sta_ind_use=None, mag_model=None, verbose: bool = False,
                 sweep_half: bool = False, featurizer: str = "rasterized",
                 device=None):
        self.device = resolve_device(device)
        if featurizer not in FEATURIZERS:
            raise ValueError(f"unknown featurizer {featurizer!r}")
        _check_assoc_mode(cfg.process.assoc_mode)
        if ctx.sta_cart.device != self.device:
            raise ValueError(f"domain tables on {ctx.sta_cart.device}, "
                             f"pipeline on {self.device}")
        self.model = model.to(self.device).eval()
        self.sweep_half = sweep_half
        self._model_half = _bf16_rounded(self.model) if sweep_half else None
        self.featurizer = featurizer
        self.cfg = cfg
        self.ctx = ctx
        self.trv = trv_from_cart
        self.n_t = n_t
        self.mag = (None if mag_model is None else
                    {**mag_model, "model": mag_model["model"].to(self.device)})
        self.verbose = verbose
        self.n_grids = int(ctx.grids_cart.shape[0])
        self._overflow = 0
        # latest arrival lag relative to a window start
        self._max_t = float(ctx.trv_grids.max())
        # subgraph mode: one (n_src, n_sta) pair mask per grid
        self._pair_masks = None
        if cfg.graph.use_subgraph:
            self._pair_masks = [
                pair_mask(ctx.grids_lla[g], ctx.sta_lla, cfg.graph.max_deg_offset,
                          cfg.graph.k_nearest_pairs)
                for g in range(self.n_grids)]
        self.set_station_mask(sta_ind_use)
        if x_query_grid is None and cfg.process.n_query_grid:
            x_query_grid = build_query_grid(
                torch.Generator(device=self.device).manual_seed(11), ctx,
                cfg.process.n_query_grid)
        self.x_query = (torch.as_tensor(x_query_grid, dtype=torch.float32,
                                        device=self.device)
                        if x_query_grid is not None else ctx.grids_cart[0])
        self.t_query = torch.linspace(-cfg.model.t_win / 2, cfg.model.t_win / 2,
                                      n_t, device=self.device)[:, None]
        self._xq_idx = [build_query_attachment(ctx.grids_cart[g], self.x_query,
                                               k=cfg.graph.k_spatial_attn)
                        for g in range(self.n_grids)]

    # -- station subsets ----------------------------------------------------
    def set_station_mask(self, sta_ind_use=None):
        """Restrict to a day's operating subnetwork (``sta_ind_use``)."""
        n_sta = self.ctx.sta_cart.shape[0]
        if sta_ind_use is None:
            mask = np.ones(n_sta, bool)
        else:
            sta_ind_use = np.asarray(sta_ind_use)
            if sta_ind_use.dtype == bool:
                mask = sta_ind_use.copy()
            else:
                mask = np.zeros(n_sta, bool)
                mask[sta_ind_use] = True
        self._active_sta = mask
        self.sta_mask = torch.as_tensor(mask, device=self.device)
        self.sta_nbr, self.sta_nbr_valid = build_station_graph(
            self.ctx.sta_cart, self.cfg.graph.k_sta_edges, self.sta_mask)
        self._graphs = [self._build_graph(g) for g in range(self.n_grids)]

    def _build_graph(self, g: int) -> GraphBundle:
        ctx = self.ctx
        dev = self.device
        return GraphBundle(
            sta_nbr=self.sta_nbr, sta_nbr_valid=self.sta_nbr_valid,
            src_nbr=ctx.src_nbr[g], sta_mask=self.sta_mask,
            edge_feat=ctx.edge_feat[g], src_pos=ctx.grids_cart[g],
            time_ptr_p=ctx.time_ptr_p[g], time_ptr_s=ctx.time_ptr_s[g],
            dt0=torch.tensor(ctx.dt0, dtype=torch.float32, device=dev),
            dt=torch.tensor(ctx.dt, dtype=torch.float32, device=dev),
            trv=ctx.trv_grids[g])

    def _featurize(self, tpick, ipick, phase, pick_mask, grid: int):
        """Window features, zeroed outside the grid's pair mask in subgraph
        mode (as every JAX stage applies ``_apply_subgraph``)."""
        if self.featurizer == "rasterized":
            feat, fmask = featurize_window_rasterized(
                tpick, ipick, phase, pick_mask, self.ctx.trv_grids[grid],
                float(self.cfg.train.src_t_kernel), self.sta_mask,
                t_lo=-10.0, t_hi=float(self.cfg.model.t_win + self._max_t + 10.0))
        else:
            feat, fmask = featurize_window(tpick, ipick, phase, pick_mask,
                                           self.ctx.trv_grids[grid],
                                           self.cfg.train.src_t_kernel, self.sta_mask)
        if self._pair_masks is not None:
            feat, fmask = apply_pair_mask(feat, fmask, self._pair_masks[grid])
        return feat, fmask

    def _to_device(self, wins):
        """Stack host window tuples (tp, ip, ph, pm) into device tensors."""
        dev = self.device
        return tuple(torch.as_tensor(np.stack([w[i] for w in wins]), device=dev)
                     for i in range(4))

    # -- stage 1: detection sweep -----------------------------------------
    @torch.no_grad()
    def _sweep_batch(self, tp, ip, ph, pm, grid: int):
        """(B, n_q, n_t) query detection scores of one window batch; with
        ``sweep_half`` the bf16-rounded model on bf16-rounded features,
        scores in f16."""
        feat, fmask = self._featurize(tp, ip, ph, pm, grid)
        model = self.model
        if self.sweep_half:
            model = self._model_half
            feat = feat.to(torch.bfloat16).to(feat.dtype)
        _, x = model.forward_detection_only(
            feat, fmask, self._graphs[grid], self.ctx.sta_cart, self.x_query,
            self._xq_idx[grid], self.t_query)
        return x[..., 0].to(torch.float16 if self.sweep_half else x.dtype)

    def _window_picks(self, pick_t, pick_sta, pick_phase, t0):
        """Pad/slice the day pick arrays to one window (host side), keeping
        center-priority picks on overflow."""
        cfg = self.cfg
        n_pick = cfg.graph.max_picks
        rel = pick_t - t0
        ok = ((rel > -10.0) & (rel < cfg.model.t_win + self._max_t + 10.0)
              & self._active_sta[pick_sta])
        sel = np.where(ok)[0]
        if len(sel) > n_pick:
            self._overflow += 1
            prio = -np.abs(rel[sel] - cfg.model.t_win / 2)
            sel = sel[np.argsort(-prio)[:n_pick]]
        order = np.lexsort((rel[sel], pick_sta[sel]))   # (station, time)
        sel = sel[order]
        tp = np.zeros(n_pick, np.float32)
        ip = np.zeros(n_pick, np.int32)
        ph = np.zeros((n_pick, 1), np.float32)
        pm = np.zeros(n_pick, bool)
        tp[:len(sel)] = rel[sel]
        ip[:len(sel)] = pick_sta[sel]
        ph[:len(sel), 0] = pick_phase[sel]
        pm[:len(sel)] = True
        return tp, ip, ph, pm, sel

    @tracing.as_request("pipeline.detection_sweep")
    def detection_sweep(self, pick_t, pick_sta, pick_phase, t_start, t_end,
                        grids=None, window_batch: int = 16,
                        checkpoint_path=None, checkpoint_every: int = 150,
                        max_retries: int = 4, retry_wait: float = 5.0):
        """Slide over [t_start, t_end); ensemble-average over ``grids``
        (default: all, unless use_only_one_grid) and overlap-stack into one
        series. Returns (times_s (n_bins,), series (n_q, n_bins)).

        Each window batch is retried up to ``max_retries`` times on the same
        device; with ``checkpoint_path`` the partial series is saved every
        ``checkpoint_every`` batches and a restarted sweep resumes from it
        (a fingerprint of the sweep geometry rejects a mismatched file)."""
        cfg = self.cfg
        if grids is None:
            grids = [0] if cfg.process.use_only_one_grid else list(range(self.n_grids))
        step = cfg.model.t_win / cfg.process.step_size
        t0s = np.arange(t_start, t_end, step)
        t_rel = np.linspace(-cfg.model.t_win / 2, cfg.model.t_win / 2, self.n_t)
        dt_axis = t_rel[1] - t_rel[0] if self.n_t > 1 else 1.0
        t_min = t_start - cfg.model.t_win / 2
        n_bins = int(np.round((t_end + cfg.model.t_win / 2 - t_min) / dt_axis)) + 1
        n_q = self.x_query.shape[0]
        acc = np.zeros((n_bins, n_q), np.float32)
        cnt = np.zeros(n_bins, np.float32)

        self._overflow = 0
        batch_idx, batch_data = [], []
        with tracing.span("sweep.window_picks"):
            for w, t0 in enumerate(t0s):
                tp, ip, ph, pm, _ = self._window_picks(pick_t, pick_sta, pick_phase, t0)
                if pm.sum() == 0:
                    continue  # quiescent window
                batch_idx.append(w)
                batch_data.append((tp, ip, ph, pm))
        tracing.count("sweep.windows", len(t0s))
        tracing.count("sweep.windows_nonempty", len(batch_idx))
        tracing.count("sweep.overflow_windows", self._overflow)
        if self._overflow:
            print(f"[pipeline] pick overflow in {self._overflow}/{len(t0s)} "
                  f"windows (max_picks={cfg.graph.max_picks}); kept "
                  f"center-priority picks", flush=True)

        def dispatch(s):
            """Enqueue one window batch (grid ensemble averaged on the
            device); returns the device tensor without waiting for it."""
            with tracing.span("sweep.dispatch"):
                tp, ip, ph, pm = self._to_device(batch_data[s:s + window_batch])
                out = None
                for g in grids:
                    o = self._sweep_batch(tp, ip, ph, pm, g)
                    out = o if out is None else out + o
                return out / len(grids)

        starts = list(range(0, len(batch_idx), window_batch))
        fingerprint = np.array([t_start, t_end, step, n_q, n_bins,
                                len(batch_idx), window_batch,
                                float(np.sum(grids)), len(grids),
                                FEATURIZERS.index(self.featurizer), ACC_LAYOUT],
                               np.float64)
        n_resume = 0
        if checkpoint_path is not None:
            try:
                z = np.load(checkpoint_path)
                if np.array_equal(z["fingerprint"], fingerprint):
                    acc[...] = z["acc"]
                    cnt[...] = z["cnt"]
                    n_resume = int(z["n_done"])
                    print(f"[pipeline] resuming sweep from checkpoint "
                          f"({n_resume}/{len(starts)} batches done)", flush=True)
                else:
                    print("[pipeline] sweep checkpoint fingerprint mismatch; "
                          "restarting from scratch", flush=True)
            except (OSError, KeyError, ValueError):
                pass

        def save_checkpoint(n_done):
            p = str(checkpoint_path)
            tmp = p + f".tmp{os.getpid()}.npz"
            np.savez(tmp, acc=acc, cnt=cnt, n_done=n_done, fingerprint=fingerprint)
            os.replace(tmp, p)

        inflight: list[tuple[int, object]] = []
        depth = 4
        t_sw, n_done = time.perf_counter(), n_resume
        tracing.count("sweep.batches", len(starts) - n_resume)

        def drain(s0, dev):
            nonlocal n_done
            with tracing.span("sweep.wait"):
                for attempt in range(max_retries + 1):
                    try:
                        if dev is None:
                            dev = dispatch(s0)  # re-dispatch this exact batch
                        out = dev.cpu().numpy()
                        break
                    except Exception as e:  # transient failure: same device again
                        dev = None
                        if attempt == max_retries:
                            raise
                        print(f"[pipeline] sweep batch at {s0} failed "
                              f"({type(e).__name__}: {e}); retry "
                              f"{attempt + 1}/{max_retries} in "
                              f"{retry_wait * (attempt + 1):.0f}s", flush=True)
                        time.sleep(retry_wait * (attempt + 1))
            with tracing.span("sweep.accumulate"):
                for j, w in enumerate(batch_idx[s0:s0 + window_batch]):
                    bins = np.round((t0s[w] + t_rel - t_min) / dt_axis).astype(np.int64)
                    acc[bins] += out[j].T
                    cnt[bins] += 1.0
            n_done += 1
            if checkpoint_path is not None and n_done % checkpoint_every == 0:
                save_checkpoint(n_done)
            if self.verbose and n_done % 50 == 0:
                dt_b = (time.perf_counter() - t_sw) / max(n_done - n_resume, 1)
                print(f"[pipeline] sweep {n_done}/{len(starts)} batches "
                      f"({dt_b:.2f}s/batch, eta "
                      f"{dt_b * (len(starts) - n_done):.0f}s)", flush=True)

        def try_dispatch(s):
            try:
                return dispatch(s)
            except Exception:  # drain() re-dispatches with retries
                return None

        for s in starts[n_resume:]:
            inflight.append((s, try_dispatch(s)))
            if len(inflight) < depth and s != starts[-1]:
                continue
            drain(*inflight.pop(0))
        for s0, dev in inflight:
            drain(s0, dev)
        if checkpoint_path is not None:
            try:  # complete: the partial checkpoint is no longer needed
                os.remove(checkpoint_path)
            except OSError:
                pass
        series = (acc / np.maximum(cnt, 1.0)[:, None]).T
        times_s = t_min + dt_axis * np.arange(n_bins)
        return times_s, series

    # -- stages 2-3: candidates -------------------------------------------
    def extract_candidates(self, times_s, series, thresh=None):
        """Peak-find the stacked day series per query node."""
        cfg = self.cfg
        thresh = cfg.process.thresh if thresh is None else thresh
        dt_axis = times_s[1] - times_s[0] if len(times_s) > 1 else 1.0
        spacing = max(1, int(1.5 * cfg.train.src_t_kernel / max(dt_axis, 1e-6)))
        xq = self.x_query.cpu().numpy()
        cands = []
        for q in range(series.shape[0]):
            for i in find_peaks_1d(series[q], thresh, min_spacing=spacing):
                cands.append((xq[q, 0], xq[q, 1], xq[q, 2], times_s[i],
                              series[q, i]))
        if not cands:
            return np.zeros((0, 4)), np.zeros(0)
        cands = np.array(cands)
        return cands[:, :4], cands[:, 4]

    def cluster_candidates(self, cands, vals):
        cfg = self.cfg
        if len(cands) == 0:
            return np.zeros((0, 4)), np.zeros(0)
        kept_pos, kept_val = [], []
        for g in split_time_groups(cands[:, 3], cfg.process.break_win):
            keep = local_marching(cands[g], vals[g], tc_win=cfg.process.tc_win,
                                  sp_win=cfg.process.sp_win)
            kept_pos.append(cands[g][keep])
            kept_val.append(vals[g][keep])
        return np.concatenate(kept_pos), np.concatenate(kept_val)

    # -- stage 4: refinement ------------------------------------------------
    @torch.no_grad()
    def _refine_batch(self, tp, ip, ph, pm, pos0, val0, generator, grid: int,
                      n_rand: int, chunk: int):
        """Trunk once per candidate, then ``ceil(n_rand/chunk)`` chunks of
        random offsets with a running argmax. Returns (best_pos (B, 3),
        best_ti (B,), best_val (B,))."""
        cfg = self.cfg
        graph = self._graphs[grid]
        feat, fmask = self._featurize(tp, ip, ph, pm, grid)
        x_spatial, _ = self.model.forward_trunk(feat, fmask, graph, self.ctx.sta_cart)
        sig = torch.tensor([cfg.process.sp_win, cfg.process.sp_win,
                            0.5 * cfg.process.sp_win], device=self.device)
        B = pos0.shape[0]
        rows = torch.arange(B, device=self.device)
        best_pos = pos0.clone()
        best_ti = torch.full((B,), self.n_t // 2, dtype=torch.int64, device=self.device)
        best_val = val0.clone()
        for _ in range(-(-n_rand // chunk)):
            offs = torch.randn((B, chunk, 3), generator=generator,
                               device=self.device) * sig
            offs[:, 0] = 0.0  # row 0 = the candidate itself
            xq = pos0[:, None] + offs
            xq_idx = build_query_attachment(self.ctx.grids_cart[grid], xq,
                                            k=cfg.graph.k_spatial_attn)
            x = self.model.forward_query_head(x_spatial, graph, xq, xq_idx,
                                              self.t_query)[..., 0]
            flat = torch.argmax(x.reshape(B, -1), dim=1)
            qi, ti = flat // x.shape[2], flat % x.shape[2]
            v = x[rows, qi, ti]
            better = v > best_val
            best_pos = torch.where(better[:, None], xq[rows, qi], best_pos)
            best_ti = torch.where(better, ti, best_ti)
            best_val = torch.where(better, v, best_val)
        return best_pos, best_ti, best_val

    def refine_sources(self, pick_t, pick_sta, pick_phase, srcs, vals,
                       grid: int = 0, n_rand: int | None = None,
                       seed: int = 0, chunk: int | None = None, batch: int = 8):
        """Batched local relocation by dense random re-querying around each
        candidate (``n_rand`` offsets → argmax), ``batch`` candidates per
        device pass."""
        if len(srcs) == 0:
            return srcs, vals
        cfg = self.cfg
        n_rand = n_rand if n_rand is not None else cfg.process.n_rand_query
        chunk = chunk if chunk is not None else cfg.process.refine_chunk
        out = srcs.copy()
        vals = vals.copy()
        t_rel_ax = np.linspace(-cfg.model.t_win / 2, cfg.model.t_win / 2, self.n_t)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        win, idx_live = [], []
        for i in range(len(srcs)):
            tp, ip, ph, pm, _ = self._window_picks(pick_t, pick_sta,
                                                   pick_phase, srcs[i, 3])
            if pm.sum() == 0:
                continue
            win.append((tp, ip, ph, pm))
            idx_live.append(i)
        tracing.count("refine.sources", len(idx_live))

        for s in range(0, len(idx_live), batch):
            with tracing.span("refine.batch"):
                sel = idx_live[s:s + batch]
                tp, ip, ph, pm = self._to_device(win[s:s + batch])
                pos0 = torch.as_tensor(srcs[sel, :3].astype(np.float32),
                                       device=self.device)
                val0 = torch.as_tensor(vals[sel].astype(np.float32), device=self.device)
                bp, bt, bv = self._refine_batch(tp, ip, ph, pm, pos0, val0, gen,
                                                grid, n_rand, chunk)
                bp, bt, bv = bp.cpu().numpy(), bt.cpu().numpy(), bv.cpu().numpy()
            for j, i in enumerate(sel):
                if bv[j] > vals[i]:
                    out[i, :3] = bp[j]
                    out[i, 3] = srcs[i, 3] + t_rel_ax[bt[j]]
                    vals[i] = bv[j]
        return out, vals

    # -- stage 5: association ---------------------------------------------
    @torch.no_grad()
    def _assoc_window(self, tp, ip, ph, pm, x_qsrc, tq_sample, grid: int):
        """Full forward over a window batch: tp/ip/pm (B, n_pick), ph (B,
        n_pick, 1), x_qsrc (B, n_qsrc, 3), tq_sample (B, n_qsrc). Returns
        per-pick weights (arv_p, arv_s), each (B, n_qsrc, n_pick)."""
        cfg = self.cfg
        graph = self._graphs[grid]
        feat, fmask = self._featurize(tp, ip, ph, pm, grid)
        pair_idx, pair_valid = build_pair_table(tp, ip, pm, k_pair=cfg.graph.k_pick_pairs)
        picks = PickSet(tp, ip, ph, pm, pair_idx, pair_valid)
        xqs_idx = build_query_attachment(self.ctx.grids_cart[grid], x_qsrc,
                                         k=cfg.graph.k_spatial_attn)
        queries = QuerySet(
            x_query=x_qsrc, x_query_idx=xqs_idx, t_query=self.t_query,
            x_qsrc=x_qsrc, x_qsrc_idx=xqs_idx, tq_sample=tq_sample,
            trv_qsrc=self.trv(self.ctx.sta_cart, x_qsrc))
        _, _, arv_p, arv_s = self.model(feat, fmask, graph, self.ctx.sta_cart,
                                        picks, queries)
        return arv_p[..., 0], arv_s[..., 0]

    @staticmethod
    def _pad_level(n, levels=(8, 16, 32, 64, 128)):
        for lv in levels:
            if n <= lv:
                return lv
        return int(np.ceil(n / levels[-1]) * levels[-1])

    def _assign(self, W, ip_pick, src_pos, src_time, make_event):
        """Connected components of the source-pick weight graph, oversized
        ones spectrally split, each part solved by competitive assignment.
        W (n_src, n_pick, 2); make_event(q, pick_rows, phases) → event."""
        cfg = self.cfg
        n_src, n_pick = W.shape[:2]
        has_w = W.sum(-1) > 0
        edges = [(q, n_src + p) for q in range(n_src) for p in np.where(has_w[q])[0]]
        labels = connected_components(n_src + n_pick, edges)
        results = []
        for lab in np.unique(labels[:n_src]):
            qs = np.where(labels[:n_src] == lab)[0]
            ps = np.where(labels[n_src:] == lab)[0]
            if len(ps) == 0:
                continue
            if len(qs) > cfg.process.max_sources_per_component:
                parts = split_component(
                    W[np.ix_(qs, ps)], ip_pick[ps], src_pos[qs], src_time[qs],
                    cfg.process.max_sources_per_component,
                    max_splits=cfg.process.max_splits)
                parts = [(qs[q_l], ps[p_l]) for q_l, p_l in parts]
            else:
                parts = [(qs, ps)]
            for qs_p, ps_p in parts:
                if len(ps_p) == 0 or len(qs_p) == 0:
                    continue
                sub_w = W[np.ix_(qs_p, ps_p)].transpose(1, 0, 2)
                assign, _ = competitive_assignment(
                    sub_w, ip_pick[ps_p], cost=cfg.process.cost_assignment)
                for qi, q in enumerate(qs_p):
                    rows = np.where(assign[:, 0] == qi)[0]
                    if len(rows):
                        results.append(make_event(q, ps_p[rows], assign[rows, 1].copy()))
        return results

    def associate(self, pick_t, pick_sta, pick_phase, srcs, grid: int = 0,
                  n_qsrc_pad: int | None = None, vals=None):
        """Span mode: one shared window for a group of sources ``srcs`` (n,
        4) of (x, y, z, t_abs); per-source pick assignment."""
        cfg = self.cfg
        if len(srcs) == 0:
            return []
        t0 = srcs[:, 3].min() - cfg.model.t_win / 4
        with tracing.span("associate.windows"):
            tp, ip, ph, pm, sel = self._window_picks(pick_t, pick_sta, pick_phase, t0)
        tracing.count("associate.sources", len(srcs))
        n_pad = n_qsrc_pad or self._pad_level(len(srcs))
        xq = np.zeros((n_pad, 3), np.float32)
        tq = np.zeros(n_pad, np.float32)
        xq[:len(srcs)] = srcs[:, :3]
        tq[:len(srcs)] = srcs[:, 3] - t0
        dev = self.device
        with tracing.span("associate.forward"):
            tpd, ipd, phd, pmd = self._to_device([(tp, ip, ph, pm)])
            arv_p, arv_s = self._assoc_window(
                tpd, ipd, phd, pmd, torch.as_tensor(xq, device=dev)[None],
                torch.as_tensor(tq, device=dev)[None], grid)
            w = np.stack((arv_p[0].cpu().numpy(), arv_s[0].cpu().numpy()),
                         axis=-1)[:len(srcs)]
        w = np.where(w > cfg.process.thresh_assoc, w, 0.0)
        w = w * pm[None, :, None]

        def make_event(q, pick_rows, phases):
            return CatalogEvent(
                pos_cart=srcs[q, :3].copy(), time=float(srcs[q, 3]),
                picks=sel[pick_rows], pick_phases=phases,
                score=float(vals[q]) if vals is not None else None)

        with tracing.span("associate.assign"):
            events = self._assign(w, ip, srcs[:, :3], srcs[:, 3], make_event)
        tracing.count("associate.events", len(events))
        return events

    def associate_per_source(self, pick_t, pick_sta, pick_phase, srcs,
                             grid: int = 0, vals=None, batch: int = 16):
        """Every candidate source is queried in its own pick window anchored
        at the source time (tq = 0, the trained operating point), ``batch``
        windows per device pass; the pick↔source weights are then assembled
        in day-global pick indices and assigned competitively."""
        cfg = self.cfg
        if len(srcs) == 0:
            return []
        tq_anchor = 0.0
        wins, sels, live = [], [], []
        with tracing.span("associate.windows"):
            for i in range(len(srcs)):
                tp, ip, ph, pm, sel = self._window_picks(
                    pick_t, pick_sta, pick_phase, srcs[i, 3] - tq_anchor)
                if pm.sum() == 0:
                    continue
                wins.append((tp, ip, ph, pm))
                sels.append(sel)
                live.append(i)
        tracing.count("associate.sources", len(live))
        if not live:
            return []

        n_pick_w = cfg.graph.max_picks
        w_p = np.zeros((len(live), n_pick_w), np.float32)
        w_s = np.zeros((len(live), n_pick_w), np.float32)
        for s in range(0, len(live), batch):
            with tracing.span("associate.forward"):
                idx = live[s:s + batch]
                tp, ip, ph, pm = self._to_device(wins[s:s + batch])
                xq = torch.as_tensor(srcs[idx, :3].astype(np.float32),
                                     device=self.device)[:, None, :]
                tq = torch.full((len(idx), 1), tq_anchor, device=self.device)
                arv_p, arv_s = self._assoc_window(tp, ip, ph, pm, xq, tq, grid)
                w_p[s:s + len(idx)] = arv_p[:, 0].cpu().numpy()
                w_s[s:s + len(idx)] = arv_s[:, 0].cpu().numpy()

        with tracing.span("associate.assign"):
            # day-global weight matrix over the union of windowed picks
            thr = cfg.process.thresh_assoc
            gids = sorted(set(int(g) for s_i in sels for g in s_i))
            gpos = {g: j for j, g in enumerate(gids)}
            W = np.zeros((len(live), len(gids), 2), np.float32)
            for r, sel in enumerate(sels):
                nv = len(sel)
                wp = np.where(w_p[r, :nv] > thr, w_p[r, :nv], 0.0)
                ws = np.where(w_s[r, :nv] > thr, w_s[r, :nv], 0.0)
                cols = [gpos[int(g)] for g in sel]
                W[r, cols, 0] = np.maximum(W[r, cols, 0], wp)
                W[r, cols, 1] = np.maximum(W[r, cols, 1], ws)

            gid_arr = np.asarray(gids, np.int64)
            src_rows = np.asarray(live)

            def make_event(q, pick_rows, phases):
                i_src = live[q]
                return CatalogEvent(
                    pos_cart=srcs[i_src, :3].copy(), time=float(srcs[i_src, 3]),
                    picks=gid_arr[pick_rows], pick_phases=phases,
                    score=float(vals[i_src]) if vals is not None else None)

            events = self._assign(W, pick_sta[gid_arr], srcs[src_rows, :3],
                                  srcs[src_rows, 3], make_event)
        tracing.count("associate.events", len(events))
        return events

    # -- stage 7: location + QC ---------------------------------------------
    @torch.no_grad()
    def _residuals(self, ev, pick_t, pick_sta):
        pos = torch.as_tensor(ev.pos_cart[None], dtype=torch.float32, device=self.device)
        tt = self.trv(self.ctx.sta_cart, pos)[0].cpu().numpy()
        pred = tt[pick_sta[ev.picks], ev.pick_phases.astype(np.int64)]
        return (pick_t[ev.picks] - ev.time) - pred

    @torch.no_grad()
    def _locate_batch(self, evs, pick_t, pick_sta, generator, max_batch=256):
        """DE location + GN covariance of ``evs`` in place, ``max_batch``
        events (padded to their largest pick count) per device pass."""
        from genie_tpu_torch.infer.locate import (locate_sources_batched,
                                                  location_uncertainty_batched)
        if not evs:
            return
        dev = self.device
        ctx = self.ctx
        lo = torch.cat((ctx.offset_cart, torch.tensor([-30.0], device=dev)))
        hi = torch.cat((ctx.offset_cart + ctx.scale_cart,
                        torch.tensor([30.0], device=dev)))
        with tracing.span("locate.pass"):
            tracing.count("locate.passes")
            for s in range(0, len(evs), max_batch):
                chunk = evs[s:s + max_batch]
                L = max(len(ev.picks) for ev in chunk)
                tp = np.zeros((len(chunk), L), np.float32)
                ip = np.zeros((len(chunk), L), np.int32)
                ph = np.zeros((len(chunk), L, 1), np.float32)
                mk = np.zeros((len(chunk), L), bool)
                for r, ev in enumerate(chunk):
                    n = len(ev.picks)
                    tp[r, :n] = pick_t[ev.picks] - ev.time
                    ip[r, :n] = pick_sta[ev.picks]
                    ph[r, :n, 0] = ev.pick_phases
                    mk[r, :n] = True
                tp, ip, ph, mk = (torch.as_tensor(a, device=dev) for a in (tp, ip, ph, mk))
                with tracing.span("locate.de"):
                    pos, t0, _ = locate_sources_batched(
                        generator, self.trv, ctx.sta_cart, tp, ip, ph, mk, lo, hi,
                        trim_fraction=self.cfg.process.trim_fraction)
                with tracing.span("locate.covariance"):
                    cov = location_uncertainty_batched(self.trv, ctx.sta_cart, pos, t0,
                                                       tp, ip, ph, mk)
                with tracing.span("locate.wait"):
                    pos, t0, cov = pos.cpu().numpy(), t0.cpu().numpy(), cov.cpu().numpy()
                for r, ev in enumerate(chunk):
                    ev.pos_cart = pos[r].copy()
                    ev.time = ev.time + float(t0[r])
                    ev.cov = cov[r]

    def locate(self, events, pick_t, pick_sta, seed: int = 0,
               qc_resid_mult: float = 3.0, qc_resid_min: float = 1.5,
               max_sigma_xy: float = 60e3, max_sigma_t: float = 15.0):
        """Trimmed-DE location, then residual QC: delete picks with
        |residual| > max(qc_resid_mult·MAD-σ, qc_resid_min), re-locate once if
        any were deleted, then drop events whose covariance exceeds
        (max_sigma_xy, max_sigma_t)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def eligible(ev):
            return (len(ev.picks) >= cfg.process.min_required_picks and
                    len(np.unique(pick_sta[ev.picks])) >= cfg.process.min_required_sta)

        evs = [ev for ev in events if eligible(ev)]
        tracing.count("locate.events", len(evs))
        self._locate_batch(evs, pick_t, pick_sta, gen)

        survivors, redo = [], []
        with tracing.span("locate.residual_qc"):
            for ev in evs:
                res = self._residuals(ev, pick_t, pick_sta)
                sigma = 1.4826 * np.median(np.abs(res - np.median(res))) + 1e-6
                keep = np.abs(res) <= max(qc_resid_mult * sigma, qc_resid_min)
                if keep.sum() < len(keep):
                    ev.picks = ev.picks[keep]
                    ev.pick_phases = ev.pick_phases[keep]
                    if not eligible(ev):
                        continue
                    redo.append(ev)
                survivors.append(ev)
        tracing.count("locate.relocated", len(redo))
        self._locate_batch(redo, pick_t, pick_sta, gen)

        out = []
        for ev in survivors:
            if ev.cov is not None and np.all(np.isfinite(ev.cov)):
                sig = np.sqrt(np.maximum(np.diag(ev.cov), 0.0))
                if (sig[:2].max() > max_sigma_xy) or (sig[3] > max_sigma_t):
                    continue
            out.append(ev)
        tracing.count("locate.dropped_qc", len(evs) - len(out))
        tracing.count("locate.out", len(out))
        return out

    # -- stage 8: magnitudes ------------------------------------------------
    def assign_magnitudes(self, events, pick_sta, pick_amp):
        """Per-event magnitudes from the calibrated magnitude model, then
        :meth:`magnitude_distance_qc`; a no-op without ``mag_model`` or
        amplitudes."""
        if self.mag is None or pick_amp is None:
            return events
        events = apply_magnitudes(events, self.mag["model"], self.ctx.sta_cart,
                                  self.mag["grid_cart"], pick_sta, pick_amp)
        return self.magnitude_distance_qc(events, pick_sta)

    def magnitude_distance_qc(self, events, pick_sta, margin: float = 1.5):
        """Drop picks whose epicentral distance exceeds ``margin``× the
        plausible association distance for the event's magnitude (the
        ``dist_model`` of the magnitude model), then re-apply the min
        picks/stations filter. A no-op without ``dist_model``."""
        dm = (self.mag or {}).get("dist_model")
        if dm is None:
            return events
        sta = self.ctx.sta_cart.cpu().numpy()
        out = []
        for ev in events:
            if ev.mag is None or not np.isfinite(ev.mag):
                out.append(ev)
                continue
            d_max = margin * float(eval_magnitude_distance(dm, ev.mag))
            d = np.linalg.norm(sta[pick_sta[ev.picks], :2]
                               - ev.pos_cart[None, :2], axis=1)
            keep = d <= d_max
            if not keep.all():
                ev.picks = ev.picks[keep]
                ev.pick_phases = ev.pick_phases[keep]
                if (len(ev.picks) < self.cfg.process.min_required_picks or
                        len(np.unique(pick_sta[ev.picks]))
                        < self.cfg.process.min_required_sta):
                    continue
            out.append(ev)
        return out

    # -- full day ----------------------------------------------------------
    @tracing.as_request("pipeline.process")
    def process(self, pick_t, pick_sta, pick_phase, t_start, t_end,
                pick_amp=None, grids=None):
        """The whole day: sweep, then :meth:`process_from_sweep`. Host
        seconds per stage (monotonic clock; the ``pipeline.<stage>`` spans of
        ``genie_tpu_torch.tracing``) land in ``self.stage_seconds``."""
        swept = {}
        with tracing.stage("pipeline.sweep", swept, "sweep"):
            times_s, series = self.detection_sweep(pick_t, pick_sta, pick_phase,
                                                   t_start, t_end, grids=grids)
        events = self.process_from_sweep(times_s, series, pick_t, pick_sta,
                                         pick_phase, pick_amp=pick_amp)
        self.stage_seconds = {**swept, **self.stage_seconds}
        return events

    def _ledger(self, stage, arr4, trace, sig_x=25e3, sig_t=15.0):
        """Stage-by-stage audit of target events: for each (x, y, z, t)
        target, whether any candidate of this stage lies within the
        matcher's (sig_x, sig_t) ball, so a lost detection names the stage
        that dropped it. Prints one ``[ledger]`` line and keeps the missing
        targets' indices in ``self.ledger[stage]``."""
        if trace is None:
            return
        arr4 = np.asarray(arr4).reshape(-1, 4)
        miss = []
        for j, tg in enumerate(trace):
            if len(arr4):
                d = np.linalg.norm(arr4[:, :2] - tg[None, :2], axis=1)
                dt = np.abs(arr4[:, 3] - tg[3])
                hit = bool(np.any((d < sig_x) & (dt < sig_t)))
            else:
                hit = False
            if not hit:
                miss.append(j)
        self.ledger[stage] = miss
        print(f"[ledger] {stage:10s}: {len(trace) - len(miss)}/{len(trace)} "
              f"targets covered; missing {miss}", flush=True)

    @tracing.as_request("pipeline.process_from_sweep")
    def process_from_sweep(self, times_s, series, pick_t, pick_sta, pick_phase,
                           pick_amp=None, thresh=None, trace=None):
        """Stages 2-8 given a (possibly cached) sweep series. ``trace``: an
        optional (n, 4) array of Cartesian + time target events (e.g. the
        day's USGS catalog) audited through every stage by :meth:`_ledger`;
        it changes nothing else."""
        cfg = self.cfg
        _check_assoc_mode(cfg.process.assoc_mode)
        sec = self.stage_seconds = {}
        self.ledger = {}
        if trace is not None:
            trace = np.asarray(trace).reshape(-1, 4)
        with tracing.stage("pipeline.candidates", sec, "candidates"):
            with tracing.span("candidates.peaks"):
                cands, vals = self.extract_candidates(times_s, series, thresh=thresh)
            self._ledger("peaks", cands, trace)
            with tracing.span("candidates.cluster"):
                srcs, svals = self.cluster_candidates(cands, vals)
            self._ledger("cluster", srcs, trace)
        tracing.count("candidates.peaks", len(cands))
        tracing.count("candidates.clustered", len(srcs))
        if self.verbose:
            print(f"[pipeline] {len(cands)} peaks -> {len(srcs)} clustered",
                  flush=True)
        if len(srcs) == 0:
            return []
        with tracing.stage("pipeline.refine", sec, "refine"):
            srcs, svals = self.refine_sources(pick_t, pick_sta, pick_phase, srcs, svals)
            self._ledger("refine", srcs, trace)
        with tracing.stage("pipeline.associate", sec, "associate"):
            events = []
            for g in split_time_groups(srcs[:, 3], cfg.process.break_win):
                g = g[np.argsort(srcs[g, 3])]
                if cfg.process.assoc_mode == "per_source":
                    events.extend(self.associate_per_source(
                        pick_t, pick_sta, pick_phase,
                        np.concatenate((srcs[g, :3], srcs[g, 3:4]), axis=1),
                        vals=svals[g]))
                    continue
                start = 0
                while start < len(g):
                    span_end = srcs[g[start], 3] + cfg.model.t_win
                    sub = g[(srcs[g, 3] >= srcs[g[start], 3]) & (srcs[g, 3] <= span_end)]
                    events.extend(self.associate(
                        pick_t, pick_sta, pick_phase,
                        np.concatenate((srcs[sub, :3], srcs[sub, 3:4]), axis=1),
                        vals=svals[sub]))
                    start += len(sub)
        if trace is not None:
            ev4 = np.array([[*ev.pos_cart, ev.time] for ev in events])
            self._ledger("associate", ev4, trace)
            npick = np.array([len(ev.picks) for ev in events], int)
            nsta = np.array([len(np.unique(pick_sta[ev.picks])) for ev in events], int)
            elig = ((npick >= cfg.process.min_required_picks)
                    & (nsta >= cfg.process.min_required_sta))
            self._ledger("eligible", ev4[elig] if elig.any() else ev4[:0], trace)
        with tracing.stage("pipeline.locate", sec, "locate"):
            located = self.locate(events, pick_t, pick_sta)
            if trace is not None:
                self._ledger("locate+qc", np.array([[*ev.pos_cart, ev.time]
                                                    for ev in located]), trace)
            with tracing.span("locate.dedup"):
                deduped = self.dedup(located)
            if trace is not None:
                self._ledger("dedup", np.array([[*ev.pos_cart, ev.time]
                                                for ev in deduped]), trace)
        tracing.count("dedup.out", len(deduped))
        with tracing.stage("pipeline.magnitudes", sec, "magnitudes"):
            out = self.assign_magnitudes(deduped, pick_sta, pick_amp)
        tracing.count("magnitudes.events", len(out))
        return out

    def dedup(self, events):
        """Final duplicate merge: among located events close in space-time
        keep local maxima of associated-pick count."""
        if len(events) <= 1:
            return events
        cands = np.array([[*ev.pos_cart, ev.time] for ev in events])
        vals = np.array([len(ev.picks) for ev in events], float)
        keep = local_marching(cands, vals, tc_win=2 * self.cfg.process.tc_win,
                              sp_win=self.cfg.process.sp_win)
        out, seen = [], set()
        for i in keep:
            k = (round(float(cands[i, 0]) / 1e3), round(float(cands[i, 1]) / 1e3),
                 round(float(cands[i, 3]) / self.cfg.process.tc_win))
            if k in seen:
                continue
            seen.add(k)
            out.append(events[i])
        return out


def self_check_featurization(ctx: DomainContext, kernel_sig_t, grid: int = 0,
                             n_test: int = 5, seed: int = 0):
    """The reference's embedded featurization check: picks fabricated from
    known grid sources must score > 0.9 at the true (source, station) cells
    and < 0.5 on average at a far source. Returns (ok_hit, ok_miss)."""
    rng = np.random.default_rng(seed)
    n_src, n_sta = ctx.trv_grids.shape[1:3]
    trv_t = ctx.trv_grids[grid]
    trv = trv_t.cpu().numpy()
    dev = trv_t.device
    ok_hit, ok_miss = True, True
    for s in rng.choice(n_src, n_test, replace=False):
        tp = np.concatenate((trv[s, :, 0], trv[s, :, 1])).astype(np.float32)
        ip = np.concatenate((np.arange(n_sta), np.arange(n_sta))).astype(np.int32)
        ph = np.concatenate((np.zeros(n_sta), np.ones(n_sta))).astype(np.float32)[:, None]
        pm = np.ones(2 * n_sta, bool)
        feat, _ = featurize_window(
            *(torch.as_tensor(a, device=dev)[None] for a in (tp, ip, ph, pm)),
            trv_t, kernel_sig_t, torch.ones(n_sta, dtype=torch.bool, device=dev))
        f = feat[0].cpu().numpy()
        ok_hit &= bool((f[s, :, 0] > 0.9).all() and (f[s, :, 1] > 0.9).all())
        far = (s + n_src // 2) % n_src
        if np.abs(trv[far] - trv[s]).min() > 4 * kernel_sig_t:
            ok_miss &= bool(f[far, :, 2].mean() < 0.5)
    return ok_hit, ok_miss
