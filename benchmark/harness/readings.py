"""Arithmetic shared by the metric readers (``benchmark/metrics/*.py``).

A reader takes the run's data (``run.py``'s ``RunData``) and returns a
number or ``None`` where the run holds nothing for it to read. Readings
from the trace cover the traced requests, which are all the requests of a
``--trace 1`` run.
"""

from __future__ import annotations

POST_SWEEP = ("candidates", "refine", "associate", "locate", "magnitudes")


def completed(run):
    return [r for r in run.records if r.error is None]


def picks_hours(run) -> float:
    return len(completed(run)) * run.chunk_s / 3600.0


def rate(run):
    """Seconds of picks of every completed request over the wall time from
    the window's start to the last completion."""
    done = completed(run)
    if not done:
        return None
    return len(done) * run.chunk_s / (max(r.t_done for r in done) - run.window[0])


def stage_s_per_h(run, stages):
    """Host seconds of the stages, per hour of picks."""
    hours = picks_hours(run)
    if run.summary is None or not hours:
        return None
    return sum(r.stage_seconds.get(s, 0.0) for r in completed(run)
               for s in stages) / hours


def sweep_windows(run) -> list:
    """Non-empty sweep windows of each completed request."""
    p, m = run.spec["process"], run.spec["model"]
    return [run.counts.non_empty_windows(run.chunks[r.chunk].pick_t, 0.0, run.chunk_s,
                                         m["t_win"], p["step_size"], run.max_t)
            for r in completed(run)]


def n_sweep_grids(run) -> int:
    return 1 if run.spec["process"]["use_only_one_grid"] else run.n_grids


def detector_mfu(run):
    """Model FLOPs of the sweep's detection forwards over the sweep's host
    wall time, as a share of the float32 peak (%)."""
    done = completed(run)
    if run.summary is None or not done:
        return None
    g, m = run.spec["graph"], run.spec["model"]
    per = run.counts.detection_forward_flops(
        run.n_src, run.n_sta, run.n_query, 9, g["k_sta_edges"], g["k_spc_edges"],
        g["k_spatial_attn"], m["use_absolute_pos"], run.edge_width)
    flops = per * n_sweep_grids(run) * sum(sweep_windows(run))
    wall = sum(r.stage_seconds["sweep"] for r in done)
    return 100.0 * flops / wall / run.counts.F32_FLOP_PER_S


def round_roofline(run):
    """The least time of the sweep's fused-round launches over the device
    time of the kernels named ``fused_round`` launched inside the ``sweep``
    ranges (%)."""
    if run.summary is None:
        return None
    kern = run.summary["range_kernels"].get("sweep", [])
    device_s = sum(us for name, us in kern if "fused_round" in name) / 1e6
    if device_s <= 0.0:
        return None
    g = run.spec["graph"]
    least = sum(run.counts.sweep_round_least_seconds(
        n, 16, n_sweep_grids(run), run.n_src, run.n_sta, g["k_sta_edges"],
        run.edge_width) for n in sweep_windows(run))
    return 100.0 * least / device_s


def range_device_ms_per_h(run, name: str):
    hours = picks_hours(run)
    if run.summary is None or not hours or name not in run.summary["range_device_s"]:
        return None
    return 1e3 * run.summary["range_device_s"][name] / hours


def idle_pct(run):
    if run.summary is None:
        return None
    window = run.window[1] - run.window[0]
    return 100.0 * (1.0 - run.summary["busy_s"] / window)


def steps_per_s(run):
    """Requests completed in the window over the wall time from the
    window's start to the last completion (optimizer steps of a training
    cell)."""
    done = completed(run)
    if not done:
        return None
    return len(done) / (max(r.t_done for r in done) - run.window[0])


def stage_s_per_request(run, stage: str):
    """Host seconds of one of the program's ``stage_seconds`` per completed
    request, in a traced run."""
    done = completed(run)
    if run.summary is None or not done:
        return None
    return sum(r.stage_seconds.get(stage, 0.0) for r in done) / len(done)


def train_mfu(run):
    """Model FLOPs of the completed training steps (``counts.train_step_flops``
    at the cell's shapes) over their wall time, as a share of the float32
    peak (%), in a traced run."""
    done = completed(run)
    if run.summary is None or not done:
        return None
    per = run.counts.train_step_flops(
        run.n_batch, run.n_src, run.n_sta, run.n_spc_query, run.n_src_query,
        run.max_picks, run.graph, run.model["use_absolute_pos"],
        4 if run.model["use_updated_model_definition"] else 0)
    wall = sum(r.t_done - r.t_start for r in done)
    return 100.0 * per * len(done) / wall / run.counts.F32_FLOP_PER_S
