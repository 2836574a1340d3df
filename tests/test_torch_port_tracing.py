"""The pipeline's tracer (``genie_tpu_torch/tracing.py``) on the CPU, with
run6's weights on the 16-station domain of tests/test_trainer.py and the
two planted events of tests/test_pipeline.py, built here without JAX.

One ``process`` request gives a span tree whose root holds the six stage
spans in order, ``stage_seconds`` equal to those spans, counters that agree
with the catalog, and the same catalog bit for bit with the tracer on and
off; off, it keeps nothing; under ``torch.profiler`` it adds no profiler
event and its unix clock lies within a millisecond of the profiler's; the
fused-round records carry the shapes the benchmark's counts predict."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import counts
from genie_tpu_torch import tracing
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.infer.pipeline import InferencePipeline
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.params import load_flax_params, load_into
from genie_tpu_torch.train.trainer import build_domain_context

ROOT = Path(__file__).resolve().parent.parent
STAGES = ["pipeline.sweep", "pipeline.candidates", "pipeline.refine", "pipeline.associate",
          "pipeline.locate", "pipeline.magnitudes"]
T_END = 180.0


def _pipeline():
    """tests/test_trainer.py's tiny_config and tiny_domain (16 stations,
    two 50-node grids) with the settings of tests/test_torch_port_pipeline.py."""
    cfg = Config()
    g, p = cfg.graph, cfg.process
    g.max_sta, g.n_spatial_nodes, g.n_grids, g.max_picks = 16, 50, 2, 64
    g.k_sta_edges, g.k_spc_edges, g.k_time_edges = 4, 6, 5
    g.k_spatial_attn, g.k_pick_pairs = 5, 6
    p.n_rand_query, p.refine_chunk, p.n_query_grid = 1, 1, 0
    p.thresh, p.thresh_assoc, p.min_required_picks, p.min_required_sta = 0.05, 0.1, 5, 3
    rng = np.random.default_rng(0)
    sta = rng.uniform(-60e3, 60e3, (16, 3)).astype(np.float32)
    sta[:, 2] = rng.uniform(-1e3, 1e3, 16)
    proj = Projection.from_center(cfg.region.center)
    grids = rng.uniform(-80e3, 80e3, (2, 50, 3)).astype(np.float32)
    grids[:, :, 2] = rng.uniform(-40e3, 2e3, (2, 50))
    tt = HomogeneousTravelTime(proj)
    trv = np.stack([tt.from_cart(torch.from_numpy(sta), torch.from_numpy(x)).numpy()
                    for x in grids])
    ctx = build_domain_context(
        cfg, np.asarray(proj.to_lla_np(sta), np.float32), sta,
        np.stack([np.asarray(proj.to_lla_np(x), np.float32) for x in grids]), grids, trv,
        "cpu")
    model = load_into(Detector(), load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl"))
    pipe = InferencePipeline(model, cfg, ctx, tt.from_cart, device="cpu")

    rng = np.random.default_rng(0)
    t, s, ph = [], [], []
    for node, t_ev in ((3, 40.0), (17, 120.0)):
        for st in range(16):
            for phase, sig in ((0, 0.1), (1, 0.15)):
                t.append(t_ev + trv[0][node, st, phase] + rng.normal(0, sig))
                s.append(st)
                ph.append(phase)
    for _ in range(30):
        t.append(rng.uniform(0, T_END))
        s.append(rng.integers(0, 16))
        ph.append(rng.integers(0, 2))
    o = np.argsort(t)
    picks = (np.array(t, np.float32)[o], np.array(s, np.int64)[o],
             np.array(ph, np.float32)[o])
    return pipe, picks


@pytest.fixture(autouse=True)
def default_mode():
    yield
    tracing.record_with_profiler()
    tracing.reset()


@pytest.fixture(scope="module")
def setup():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _pipeline()
    finally:
        torch.set_num_threads(n_threads)


def _request(setup, on: bool):
    pipe, picks = setup
    tracing.reset()
    tracing.enable() if on else tracing.disable()
    try:
        events = pipe.process(*picks, 0.0, T_END)
        return dict(events=events, export=tracing.export(),
                    seconds=dict(pipe.stage_seconds))
    finally:
        tracing.record_with_profiler()
        tracing.reset()


@pytest.fixture(scope="module")
def traced(setup):
    return _request(setup, True)


@pytest.fixture(scope="module")
def untraced(setup):
    return _request(setup, False)


def _by_id(ex):
    return {s["id"]: s for s in ex["spans"]}


def test_span_tree_of_one_request(traced):
    ex = traced["export"]
    roots = [s for s in ex["spans"] if s["parent"] is None]
    assert [r["name"] for r in roots] == ["pipeline.process"]
    root = roots[0]
    children = [s["name"] for s in ex["spans"] if s["parent"] == root["id"]]
    assert children == STAGES
    spans = _by_id(ex)
    for s in ex["spans"]:
        assert s["request"] == root["request"]
        assert s["end_ns"] >= s["start_ns"]
        assert s["unix_end_ns"] - s["unix_start_ns"] == s["end_ns"] - s["start_ns"]
        if s["parent"] is not None:
            up = spans[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] and s["end_ns"] <= up["end_ns"], s
    names = {s["name"] for s in ex["spans"]}
    assert {"sweep.window_picks", "sweep.dispatch", "sweep.wait", "sweep.accumulate",
            "candidates.peaks", "candidates.cluster", "refine.batch", "associate.windows",
            "associate.forward", "associate.assign", "locate.pass", "locate.de",
            "locate.covariance", "locate.residual_qc", "locate.dedup"} <= names
    parent = {s["name"]: spans[s["parent"]]["name"] for s in ex["spans"]
              if s["parent"] is not None}
    assert parent["locate.de"] == parent["locate.covariance"] == "locate.pass"
    assert parent["locate.pass"] == parent["locate.residual_qc"] == "pipeline.locate"
    assert parent["sweep.dispatch"] == parent["sweep.wait"] == "pipeline.sweep"


def test_stage_seconds_are_the_stage_spans(traced, untraced):
    ex = traced["export"]
    want = {s["name"].split(".")[1]: (s["end_ns"] - s["start_ns"]) * 1e-9
            for s in ex["spans"] if s["name"] in STAGES}
    assert traced["seconds"] == want
    assert list(traced["seconds"]) == [s.split(".")[1] for s in STAGES]
    assert list(untraced["seconds"]) == list(traced["seconds"])
    assert all(v > 0 for v in untraced["seconds"].values())


def test_counters_agree_with_the_catalog(setup, traced):
    cfg = setup[0].cfg
    ex, events = traced["export"], traced["events"]
    (c,) = ex["counts"].values()
    n_spans = {}
    for s in ex["spans"]:
        n_spans[s["name"]] = n_spans.get(s["name"], 0) + 1
    assert len(events) >= 1
    assert c["magnitudes.events"] == c["dedup.out"] == len(events)
    assert c["locate.passes"] in (0, 1, 2)
    assert c["locate.passes"] == n_spans["locate.pass"] == 1 + (c["locate.relocated"] > 0)
    assert c["locate.out"] + c["locate.dropped_qc"] == c["locate.events"]
    assert c["dedup.out"] <= c["locate.out"]
    assert c["sweep.windows"] == len(np.arange(0.0, T_END,
                                               cfg.model.t_win / cfg.process.step_size))
    assert c["sweep.batches"] == n_spans["sweep.wait"] == n_spans["sweep.dispatch"]
    assert c["sweep.windows_nonempty"] <= c["sweep.windows"]
    assert c["candidates.clustered"] <= c["candidates.peaks"]
    assert c["refine.sources"] <= c["candidates.clustered"]
    assert n_spans["refine.batch"] == -(-c["refine.sources"] // 8)
    assert c["associate.events"] >= c["locate.events"]


def test_catalog_identical_with_tracing_on_and_off(traced, untraced):
    a, b = traced["events"], untraced["events"]
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        assert np.array_equal(x.pos_cart, y.pos_cart) and x.time == y.time
        assert np.array_equal(x.picks, y.picks)
        assert np.array_equal(x.pick_phases, y.pick_phases)
        assert np.array_equal(x.cov, y.cov, equal_nan=True)


def test_disabled_keeps_nothing(untraced):
    assert untraced["export"] == {"spans": [], "counts": {}, "launches": []}
    tracing.disable()
    assert not tracing.recording()
    assert tracing.span("a") is tracing.span("b") is tracing.NOOP
    assert tracing.request("pipeline.process") is tracing.NOOP
    tracing.count("x")
    tracing.launch((1,) * 10, "plain")
    seconds = {}
    with tracing.stage("pipeline.sweep", seconds, "sweep"):
        pass
    assert seconds["sweep"] >= 0.0
    assert tracing.export() == {"spans": [], "counts": {}, "launches": []}
    tracing.record_with_profiler()      # the default, with no profiler running
    assert not tracing.recording()
    assert tracing.span("a") is tracing.NOOP


def _event_names(setup, mode):
    pipe, picks = setup
    mode()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.process(*picks, 0.0, T_END)
    return {e.name for e in prof.events()}, tracing.export()


def test_profiler_events_same_with_tracer_on_and_off(setup, untraced):
    off, ex_off = _event_names(setup, tracing.disable)
    on, ex_on = _event_names(setup, tracing.enable)
    followed, ex_followed = _event_names(setup, tracing.record_with_profiler)
    assert on == off == followed
    assert not ex_off["spans"]
    assert [s["name"] for s in ex_on["spans"]] == [s["name"] for s in ex_followed["spans"]]
    assert not any(n.startswith(("pipeline.", "sweep.", "locate.")) for n in on)


def test_root_span_on_the_profiler_clock(setup):
    """A record_function around a traced call holds the root span, on the
    unix clock, to 1 ms at each end."""
    pipe, picks = setup
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("around"):
            pipe.detection_sweep(*picks, 0.0, T_END)
    base = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "around"]
    lo, hi = base + ev.time_range.start * 1e3, base + ev.time_range.end * 1e3
    (root,) = [s for s in tracing.export()["spans"] if s["parent"] is None]
    assert root["name"] == "pipeline.detection_sweep"
    assert lo <= root["unix_start_ns"] <= lo + 1e6
    assert hi - 1e6 <= root["unix_end_ns"] <= hi


def test_fused_round_records_of_the_sweep(traced):
    """On CPU tensors every record takes the plain path; the sweep's carry
    the (rows, cx, cz, m, h, z_is_x) of ``counts.sweep_rounds``."""
    ex = traced["export"]
    spans = _by_id(ex)
    launches = ex["launches"]
    assert launches and all(x["path"] == "plain" for x in launches)
    sweep = [x["shape"] for x in launches if spans[x["span"]]["name"] == "sweep.dispatch"]
    (c,) = ex["counts"].values()
    want = counts.sweep_rounds(c["sweep.windows_nonempty"], 16, 2, 50, 16, 4, 0)
    assert [(s["rows"], s["cx"], s["cz"], s["m"], s["h"], s["z_is_x"]) for s in sweep] == want
    assert all((s["n_sta"], s["n_src"], s["k"], s["e"]) == (16, 50, 4, 0) for s in sweep)
    others = {spans[x["span"]]["name"] for x in launches} - {"sweep.dispatch"}
    assert others == {"refine.batch", "associate.forward"}


def test_chrome_trace_of_the_spans(tmp_path):
    tracing.enable()
    with tracing.request("pipeline.process"):
        with tracing.span("pipeline.sweep"):
            tracing.count("sweep.windows", 3)
        with tracing.request("pipeline.detection_sweep"):   # inside a request: nothing
            tracing.count("sweep.windows")
    tracing.count("outside")
    ex = tracing.export()
    assert [s["name"] for s in ex["spans"]] == ["pipeline.process", "pipeline.sweep"]
    assert ex["counts"] == {ex["spans"][0]["request"]: {"sweep.windows": 4},
                            None: {"outside": 1}}
    base = ex["spans"][0]["unix_start_ns"] - 5_000
    assert tracing.write_chrome_trace(tmp_path / "spans.json", base_ns=base) == 2
    doc = json.loads((tmp_path / "spans.json").read_text())
    assert doc["baseTimeNanoseconds"] == base
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert evs["pipeline.process"]["ts"] == pytest.approx(5.0)
    assert evs["pipeline.process"]["args"]["counts"] == {"sweep.windows": 4}
    assert evs["pipeline.sweep"]["args"]["parent"] == ex["spans"][0]["id"]
    s = ex["spans"][1]
    assert evs["pipeline.sweep"]["dur"] == (s["end_ns"] - s["start_ns"]) / 1e3
