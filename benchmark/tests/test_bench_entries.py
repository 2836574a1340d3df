"""The contract of ``benchmark/run.py`` with an entry of its own file: a
cell whose traffic mix names an entry that only this test supplies runs
through ``run.run_cell`` with no edit to ``run.py``. The test writes a
checkout of its own (``BENCHMARK.json`` and, under ``benchmark/``, the
configuration, the mix, the limits, the entry and two metric readers) and
points ``run.py`` at it."""

import argparse
import json
import textwrap

import pytest

from benchmark import run

ENTRY = '''
import math


class Record:
    def __init__(self, i):
        self.i, self.error, self.stage_seconds = i, None, {}
        self.t_start = self.t_done = 0.0


class Entry:
    ranges = labels = ()

    def __init__(self, setting):
        setting.mark("toy set-up")
        self.n = setting.mix["terms"]
        self.plant = setting.options.get("plant")
        self.values = []

    def warm_up(self):
        self.value(0)

    def value(self, i):
        v = sum(1.0 / (k + i + 1) ** 2 for k in range(self.n))
        return self.plant(v) if self.plant else v

    def begin(self, i):
        return Record(i)

    def request(self, rec):
        self.values.append((rec.i, self.value(rec.i)))

    def end(self, rec):
        return f"toy {rec.i}"

    def release(self):
        pass

    def check(self, records):
        want = [sum(1.0 / (k + i + 1) ** 2 for k in range(self.n)) for i, _ in self.values]
        return {"toy_gap": max(abs(v - w) for (_, v), w in zip(self.values, want))}

    def fields(self):
        return {"toy_requests": len(self.values)}
'''

RATE = '''
def read(run):
    done = [r for r in run.records if r.error is None]
    return run.toy_requests / (max(r.t_done for r in done) - run.window[0])
'''


@pytest.fixture
def toy_checkout(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "entries", "metrics"):
        (bench / d).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "toy.sums", "config": "toy", "traffic": "sums", "chips": 1,
                       "why": "a test's own entry"}],
        "end_to_end": [
            {"name": "toy_rate", "unit": "1/s", "better": "higher", "bound": 0.25,
             "source": "host_clock", "workloads": ["toy.sums"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": []}))
    (bench / "configs" / "toy.json").write_text(json.dumps({"entry": "process"}))
    (bench / "traffic" / "sums.json").write_text(json.dumps({"entry": "toy_entry",
                                                             "terms": 50,
                                                             "trace_requests": 4}))
    (bench / "limits" / "toy.sums.json").write_text(json.dumps({"toy_gap": 1e-12}))
    (bench / "entries" / "toy_entry.py").write_text(textwrap.dedent(ENTRY))
    (bench / "metrics" / "toy_rate.py").write_text(textwrap.dedent(RATE))
    (bench / "metrics" / "setup_s.py").write_text(
        (run.BENCH / "metrics" / "setup_s.py").read_text())
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "BENCH", bench)
    return tmp_path


def _run(**options):
    args = argparse.Namespace(workload="toy.sums", seed=3, seconds=0.2, trace=0,
                              precision="f32")
    return run.run_cell(args, dev="cpu", **options)


def test_an_entry_of_its_own_file_runs_through_run_cell(toy_checkout):
    res = _run()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"toy_rate", "setup_s"}
    assert res["metrics"]["toy_rate"]["value"] > 0
    assert res["checked"] == {"toy_gap": {"value": 0.0, "limit": 1e-12}}


def test_the_entrys_check_decides_correct(toy_checkout):
    res = _run(plant=lambda v: v * (1 + 1e-9))
    assert res["correct"] is False
    assert res["checked"]["toy_gap"]["value"] > 1e-12


def test_run_py_names_no_other_entry():
    """``run.py`` names the two inference entries and no other."""
    src = (run.BENCH / "run.py").read_text()
    entries = [p.stem for p in (run.BENCH / "entries").glob("*.py")]
    assert entries and all(f'"{e}"' not in src and f"'{e}'" not in src for e in entries)
