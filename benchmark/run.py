#!/usr/bin/env python3
"""Run one cell of the benchmark of ``genie_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``); each metric is read by
``benchmark/metrics/<name>.py``; the limits of the check are
``benchmark/limits/<cell>.json``. Set-up makes the inputs from the seed,
builds the program and warms it up; the window then sends requests in a
closed loop with one client for ``--seconds`` (with ``--trace 1`` under
``torch.profiler``, for at most the mix's ``trace_requests`` requests);
after it the plain reference checks what the program produced. The last
line of standard output is one JSON object. ``--precision tf32`` runs the
program with TF32 matrix products: the check's control, which must come
out not correct.

Entries. A cell's entry is its traffic mix's ``entry``, or else its
configuration's. ``process`` and ``detection_sweep`` are the program's
``InferencePipeline`` methods, run by :class:`Inference` below. Any other
entry ``<e>`` is the file ``benchmark/entries/<e>.py``, loaded by path as
the metric readers are, whose class ``Entry`` does for its cells what
:class:`Inference` does for these, so that a new entry needs a new file
and entries in ``BENCHMARK.json``, and no edit here:

* ``Entry(setting)``: the set-up. ``setting`` holds ``root`` (the
  checkout), ``cell``, ``spec`` (the configuration), ``mix``, ``limits``
  (the cell's limits file), ``seed``, ``seconds``, ``trace``,
  ``precision``, ``device``, ``mark(name)`` (prints the seconds since the
  last mark: call it after each phase of set-up), ``make_inputs``
  (:func:`make_inputs`) and ``options`` (what a test passes to
  :func:`run_cell`: ``plant``, a function called with the program before
  the benchmark wraps it, and sizes of its own). It makes its inputs from
  the seed and builds the
  program;
* ``warm_up()``: the rest of set-up, from the first request that reaches
  every stage the window reaches; the device is synchronized after it;
* ``ranges`` and ``labels``: the ``record_function`` ranges whose device
  time and kernels a traced run sums (``trace.summarize``), and those of
  them that name the idle gaps in ``breakdown``;
* ``begin(i)``: the record of timed request ``i``: an object with
  ``t_start``, ``t_done``, ``error`` (``None``) and ``stage_seconds``
  (a dict), which :func:`run_cell` keeps in ``RunData.records``;
  ``request(rec)``: that request, the device synchronized at its end (an
  exception fails it, and the window goes on); ``end(rec)``: after its
  ``t_done``, its line for standard error;
* ``release()``: frees the program's state once the window has closed and
  the memory peak has been read;
* ``check(records)``: the check's numbers, after the release and with TF32
  off; each is compared with its limit, and the run is correct where every
  one is finite and within it and no request failed;
* ``fields()``: the entry's own attributes of ``RunData``, which its
  metric readers read.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "genie_tpu")
INFERENCE = ("process", "detection_sweep")


class Inputs(NamedTuple):
    root: Path
    sta_lla: object
    sta_cart: object
    grids_lla: object
    grids_cart: object
    x_query: object


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return _load_module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}").read


def load_entry(name: str):
    """The ``Entry`` class of ``benchmark/entries/<name>.py``."""
    path = BENCH / "entries" / f"{name}.py"
    if not path.is_file():
        fail(f"no entry {name!r}: {path.relative_to(ROOT)} is not there")
    return _load_module(path, f"bench_entry_{name}").Entry


def make_inputs(spec: dict, n_sta: int | None = None, n_query: int | None = None):
    """The configuration's stations, drawn from its stations' seed inside the
    grids' lat/lon box (elevation U[-500, 1500] m), and the grid nodes and
    query nodes from their files."""
    import numpy as np

    from benchmark.reference.domain import region_center, to_cart_np

    z = np.load(ROOT / spec["grids"])
    grids_lla = z["grids_lla"].astype(np.float32)
    grids_cart = z["grids_cart"].astype(np.float32)
    lo, hi = grids_lla.reshape(-1, 3).min(0), grids_lla.reshape(-1, 3).max(0)
    n = n_sta or spec["stations"]["count"]
    rng = np.random.default_rng([spec["stations"]["seed"], 0])
    sta_lla = np.stack((rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n),
                        rng.uniform(-500.0, 1500.0, n)), axis=1).astype(np.float32)
    sta_cart = to_cart_np(sta_lla, region_center(spec["region"])).astype(np.float32)
    x_query = np.load(ROOT / spec["query_grid"]).astype(np.float32)
    if n_query:
        x_query = x_query[:n_query]
    return Inputs(ROOT, sta_lla, sta_cart, grids_lla, grids_cart, x_query)


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class RunData:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Inference:
    """The entries ``process`` and ``detection_sweep``: the program's
    ``InferencePipeline`` over chunks of picks. Options: ``n_sta``
    stations, the first ``n_query`` query nodes, ``plant`` called with the
    pipeline before the benchmark wraps its stages."""

    def __init__(self, setting):
        from benchmark.harness import check, system, traffic
        from benchmark.harness.weights import seeded_state_dict
        from benchmark.reference.pipeline import make_detector

        self.system, self.check_mod = system, check
        spec, mix, opt = setting.spec, setting.mix, setting.options
        self.spec, self.mix, self.seed = spec, mix, setting.seed
        self.entry = setting.entry
        self.chunk_s = float(spec["chunk_s"])
        self.device = setting.device
        self.inputs = make_inputs(spec, opt.get("n_sta"), opt.get("n_query"))
        self.tools = check.ReferenceTools(spec, self.inputs, self.device)
        tools = self.tools
        self.chunks = traffic.make_chunks(mix, setting.seed,
                                          traffic.n_chunks(mix, setting.seconds),
                                          tools.sta, tools.box_lo, tools.box_hi,
                                          tools.trv.from_cart, tools.mag, self.chunk_s)
        setting.mark("inputs and traffic")
        self.weights_sd = None
        if spec["weights"] == "seed":
            self.weights_sd = seeded_state_dict(make_detector(spec), setting.seed,
                                                self.device)
        self.pipe = system.build_system(spec, self.inputs, self.device, self.weights_sd)
        setting.mark("program set-up")
        if opt.get("plant") is not None:
            opt["plant"](self.pipe)
        self.cap = system.Capture()
        system.instrument(self.pipe, self.cap)
        self.with_mag = bool(spec.get("magnitudes"))
        self.ranges = system.STAGES + ("trv",)
        self.labels = system.STAGES
        self.max_t = None

    def _call(self, ch):
        if self.entry == "process":
            return self.pipe.process(ch.pick_t, ch.pick_sta, ch.pick_phase, 0.0,
                                     self.chunk_s, pick_amp=ch.pick_amp)
        return self.pipe.detection_sweep(ch.pick_t, ch.pick_sta, ch.pick_phase, 0.0,
                                         self.chunk_s)

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm_up(self):
        # one request of this cell's traffic that reaches every stage
        self._call(next((ch for ch in self.chunks if len(ch.ev_t)), self.chunks[0]))

    def begin(self, i: int):
        rec = self.cap.begin(i % len(self.chunks))
        rec.n0 = self.system.launches()
        return rec

    def request(self, rec):
        import numpy as np

        out = self._call(self.chunks[rec.chunk])
        self._sync()
        if self.entry == "process":
            if not self.system.well_formed(out, self.with_mag):
                rec.error = "malformed catalog"
            rec.events = [self.system.event_tuple(ev) for ev in out]
            rec.stage_seconds = dict(self.pipe.stage_seconds)
        else:
            times, series = out
            if not (np.isfinite(series).all() and series.shape[1] == len(times)):
                rec.error = "malformed series"

    def end(self, rec) -> str:
        if self.entry != "process":
            rec.stage_seconds = {"sweep": rec.t_done - rec.t_start}
        rec.launches = self.system.launches() - rec.n0
        return (f"chunk {rec.chunk}: {rec.t_done - rec.t_start:.4f} s, "
                f"{rec.launches} launches, stages "
                f"{ {k: round(v, 4) for k, v in rec.stage_seconds.items()} }, "
                f"{'' if rec.events is None else len(rec.events)} events"
                f"{'' if rec.error is None else ', ' + rec.error}")

    def release(self):
        import torch

        self.cap.current = None
        del self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, records) -> dict:
        check, mix = self.check_mod, self.mix
        ref = self.tools.pipeline(self.weights_sd)
        self.max_t = ref.max_t
        numbers = {}
        for rec in check.sample(records, mix["check_requests"], self.seed):
            for k, v in check.compare_request(ref, rec, self.chunks[rec.chunk],
                                              self.chunk_s, self.entry).items():
                numbers[k] = max(numbers.get(k, 0.0), v)
        if self.entry == "process":
            numbers.update(check.location_numbers(ref, records, self.chunks,
                                                  mix["check_location_requests"],
                                                  self.seed))
        return numbers

    def fields(self) -> dict:
        inputs, m = self.inputs, self.spec["model"]
        return dict(chunk_s=self.chunk_s, chunks=self.chunks, max_t=self.max_t,
                    n_sta=int(inputs.sta_cart.shape[0]),
                    n_src=int(inputs.grids_cart.shape[1]),
                    n_grids=int(inputs.grids_cart.shape[0]),
                    n_query=int(inputs.x_query.shape[0]),
                    edge_width=4 if m["use_updated_model_definition"] else 0)


def _overlay(base: dict, overrides: dict | None) -> dict:
    """``base`` with each group of ``overrides`` ({group: {key: value}} or
    {key: value}) laid over it."""
    for group, vals in (overrides or {}).items():
        base[group] = {**base[group], **vals} if isinstance(vals, dict) else vals
    return base


def run_cell(args, dev: str = "cuda", overrides=None, mix_overrides=None,
             **options) -> dict:
    """One run of a cell; returns the result line's object. The tests run
    it on the CPU at a small size: ``overrides`` and ``mix_overrides``
    ({group: {key: value}}) over the configuration's settings and the
    traffic mix's, and ``options`` handed to the entry (``n_sta``,
    ``n_query``, ``plant``, …)."""
    import torch

    from benchmark.harness import check, counts, trace

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    spec = _overlay(load_json(BENCH / "configs" / f"{cell['config']}.json"), overrides)
    mix = _overlay(load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
                   mix_overrides)
    limits = load_json(BENCH / "limits" / f"{cell['name']}.json")
    entry = mix.get("entry", spec["entry"])
    device = torch.device(dev)
    tf32 = args.precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    last = [T_PROCESS]

    def mark(name):
        now = time.time()
        print(f"setup {name}: {now - last[0]:.3f} s", file=sys.stderr)
        last[0] = now

    mark("start and imports")
    setting = SimpleNamespace(root=ROOT, cell=cell, spec=spec, mix=mix, limits=limits,
                              entry=entry, seed=args.seed, seconds=args.seconds, trace=args.trace,
                              precision=args.precision, device=device, mark=mark,
                              make_inputs=make_inputs, options=options)
    ent = Inference(setting) if entry in INFERENCE else load_entry(entry)(setting)
    ent.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize()
    mark("warm-up")
    setup_s = time.time() - T_PROCESS

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    records = []
    t_win = time.perf_counter()
    deadline = t_win + args.seconds
    i = 0
    while time.perf_counter() < deadline and not (
            args.trace and i >= mix["trace_requests"]):
        rec = ent.begin(i)
        records.append(rec)
        rec.t_start = time.perf_counter()
        try:
            ent.request(rec)
        except Exception as e:  # a failed request is counted, the loop goes on
            rec.error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        rec.t_done = time.perf_counter()
        print(f"request {i} {ent.end(rec)}", file=sys.stderr)
        i += 1
    t_end = time.perf_counter()
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.summarize(prof, ent.ranges, ent.labels)
        del prof
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    ent.release()

    # -- the check, with TF32 off whatever the program ran with ------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.time()
    numbers = ent.check(records)
    print(f"check: {time.time() - t_check:.3f} s", file=sys.stderr)
    failed = sum(r.error is not None for r in records)
    correct = failed == 0 and check.verdict(numbers, limits)

    run = RunData(cell=cell, spec=spec, mix=mix, entry=entry, setup_s=setup_s,
                  records=records, window=(t_win, t_end), summary=summary,
                  counts=counts, **ent.fields())
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for met in bench[kind]:
        if "workloads" in met and cell["name"] not in met["workloads"]:
            continue
        value = load_reader(met["name"])(run)
        if value is not None:
            metrics[met["name"]] = {"value": value, "unit": met["unit"]}
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = t_end - t_win
        result["breakdown"] = trace.breakdown(summary)
    result["checked"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", choices=("f32", "tf32"), default="f32")
    args = ap.parse_args(argv)
    if not (ROOT / "genie_tpu_torch").is_dir():
        fail("the program (genie_tpu_torch) is not in this checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    result = run_cell(args)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        fail(f"modules of the JAX package or of JAX were loaded: {loaded}", 4)
    print(f"card: {card_name_and_limit()}", file=sys.stderr)
    for k, v in result["checked"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


def _finite(obj):
    """``obj`` with every non-finite float written as a string."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


if __name__ == "__main__":
    # one host compute thread: over four runs of the background cell on an
    # H100 machine the rate spread 7 % with the default thread pools, 2.9 %
    # with one thread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
