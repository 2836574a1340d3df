"""The readers of the program's spans (``benchmark/harness/spans.py`` and
the five metrics built on it): finite on a ``--trace 1`` run of the swarm
cell on the CPU where the run has work, ``None`` where a counter is 0 or
the program has no tracer; the idle seconds by innermost span on made-up
intervals."""

import sys
import types

import pytest

from benchmark import run as bench_run
from benchmark.harness import counts, spans
from benchmark.tests.cpu_cell import run_small

NEW = ("locate.s_per_event.process", "locate.idle_pct.process",
       "associate.s_per_source.process", "sweep.idle_pct.process",
       "fused_round.roofline_pct.all.process")


@pytest.fixture
def tracer():
    from genie_tpu_torch import tracing

    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.record_with_profiler()
    tracing.reset()


def _run_data(t0, t1, by_name=None, range_device_s=None):
    return bench_run.RunData(window=(t0, t1), counts=counts,
                             summary={"by_name": by_name or {},
                                      "range_device_s": range_device_s or {}})


def test_readers_on_a_traced_cpu_run():
    res = run_small("nc_run6.swarm", trace=1)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW[:4]:
        assert name in got and 0.0 < got[name] < float("inf"), (name, got)
    assert got["locate.idle_pct.process"] <= 100.0
    assert "fused_round.roofline_pct.all.process" not in got   # no kernel on the CPU


def test_readers_where_a_counter_is_zero(tracer):
    import time

    t0 = time.perf_counter()
    with tracer.request("pipeline.process"):
        with tracer.span("pipeline.locate"):
            tracer.count("locate.events", 0)
        with tracer.span("pipeline.associate"):
            pass
        tracer.launch((32, 16, 2, 30, 30, 0, 4, 4, 30, True), "plain")
    run = _run_data(t0, time.perf_counter(), by_name={"fused_round_kernel": 1e-3},
                    range_device_s={"locate": 0.0})
    read = {n: bench_run.load_reader(n)(run) for n in NEW}
    assert read["locate.s_per_event.process"] is None
    assert read["associate.s_per_source.process"] is None
    assert read["locate.idle_pct.process"] == 100.0
    assert read["sweep.idle_pct.process"] is None            # no pipeline.sweep span
    assert read["fused_round.roofline_pct.all.process"] is None   # plain records only


def test_roofline_of_every_kernel_launch(tracer):
    import time

    t0 = time.perf_counter()
    shape = (8000, 374, 500, 30, 30, 0, 4, 8, 30, True)
    with tracer.request("pipeline.process"):
        tracer.launch(shape, "kernel")
        tracer.launch(shape, "kernel")
    least = counts.round_bound(8000, 374, 30, 30, 4, 30, 8, True, 0, 500)[2]
    run = _run_data(t0, time.perf_counter(), by_name={"void fused_round_kernel<32>": 4 * least,
                                                      "gemm": 1.0})
    assert spans.round_roofline_all(run) == pytest.approx(50.0)
    run.window = (run.window[1], run.window[1] + 1.0)      # records outside the window
    assert spans.round_roofline_all(run) is None


def test_no_tracer_in_the_program(monkeypatch):
    import genie_tpu_torch

    monkeypatch.delattr(genie_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "genie_tpu_torch.tracing", None)
    run = _run_data(0.0, 1e9)
    assert spans.program_trace(run) is None
    assert all(bench_run.load_reader(n)(run) is None for n in NEW)
    assert spans.program_trace(types.SimpleNamespace(summary=None)) is None


def test_idle_by_innermost_span():
    def sp(i, name, parent, a, b):
        return {"id": i, "name": name, "parent": parent, "unix_start_ns": a,
                "unix_end_ns": b}

    tree = [sp(0, "pipeline.process", None, 0, 100), sp(1, "pipeline.locate", 0, 10, 90),
            sp(2, "locate.de", 1, 20, 60)]
    merged = [[0, 5], [30, 40], [85, 95]]
    host, idle = spans.idle_by_span(merged, tree)
    assert host == pytest.approx({"pipeline.process": 20e-9, "pipeline.locate": 40e-9,
                                  "locate.de": 40e-9})
    assert idle == pytest.approx({"pipeline.process": 10e-9, "pipeline.locate": 35e-9,
                                  "locate.de": 30e-9})
    assert spans.idle_share(merged, tree, "pipeline.locate") == pytest.approx(
        100.0 * (1 - 15 / 80))
    assert spans.idle_share(merged, tree, "pipeline.sweep") is None
