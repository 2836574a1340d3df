"""The program's own spans, counters and fused-round launch records in a
traced run, and the device's idle time by the program span open on the host.

The program's tracer (``genie_tpu_torch.tracing``) records while
``torch.profiler`` records, so the window of a ``--trace 1`` run carries the
program's spans with no call from the benchmark. Where the program has no
tracer (a checkout before it), :func:`program_trace` gives ``None`` and so
does every reader built on it.

The readers (``benchmark/metrics/locate.*``, ``associate.*``,
``sweep.idle_pct.process``, ``fused_round.roofline_pct.all.process``) take
their time from the program's stage spans and their counts from its
counters. The idle shares take the device time of the kernels launched
inside the benchmark's range around the same call (``trace.summarize``'s
``range_device_s``): kernels of one stream do not overlap, and each stage
ends in a copy to the host, so that is the busy part of the span.

Run as a command, this module runs one traced cell as ``benchmark/run.py
--trace 1`` does, keeps the trace's kernel intervals on the unix clock, and
prints (stderr) the device idle seconds inside each innermost program span,
with the exact idle share of each stage span and the program's kernel
launch records per request (to set beside the ``launches`` of each
``request`` line); the result line follows on stdout:

    python3 -m benchmark.harness.spans --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def program_trace(run):
    """The tracer's spans, counts and launch records inside the run's
    window, or ``None`` (no trace, or no tracer in the program)."""
    if run.summary is None:
        return None
    try:
        from genie_tpu_torch import tracing
    except ImportError:
        return None
    ex = tracing.export()
    lo, hi = run.window[0] * 1e9, run.window[1] * 1e9
    spans = [s for s in ex["spans"] if lo <= s["start_ns"] and s["end_ns"] <= hi]
    reqs = {s["request"] for s in spans}
    return {"spans": spans,
            "counts": {r: c for r, c in ex["counts"].items() if r in reqs},
            "launches": [x for x in ex["launches"] if lo <= x["t_ns"] <= hi]}


def span_seconds(tr, name: str) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in tr["spans"] if s["name"] == name) * 1e-9


def counter(tr, name: str) -> int:
    return sum(c.get(name, 0) for c in tr["counts"].values())


def seconds_per(run, span: str, count: str):
    """Seconds of the program's ``span`` spans per unit of its counter
    ``count``; ``None`` where the counter is 0."""
    tr = program_trace(run)
    if tr is None:
        return None
    n = counter(tr, count)
    return span_seconds(tr, span) / n if n else None


def idle_pct_in(run, span: str, range_name: str):
    """Share (%) of the program's ``span`` spans' time in which no kernel
    runs: one less the device time of the kernels launched inside the
    benchmark's ``range_name`` ranges (which hold those spans) over the
    spans' time."""
    tr = program_trace(run)
    if tr is None:
        return None
    t = span_seconds(tr, span)
    if t <= 0.0:
        return None
    return 100.0 * (1.0 - run.summary["range_device_s"].get(range_name, 0.0) / t)


def round_roofline_all(run):
    """The least time of every kernel-path fused-round launch the program
    recorded (sweep, refinement, association; ``counts.round_bound``) over
    the device time of every kernel named ``fused_round`` in the trace (%)."""
    tr = program_trace(run)
    if tr is None:
        return None
    device_s = sum(v for k, v in run.summary["by_name"].items() if "fused_round" in k)
    least = 0.0
    for x in tr["launches"]:
        if x["path"] == "kernel":
            s = x["shape"]
            least += run.counts.round_bound(s["rows"], s["n_sta"], s["cx"], s["cz"], s["m"],
                                            s["h"], s["k"], s["z_is_x"], s["e"],
                                            s["n_src"])[2]
    if device_s <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / device_s


# -- the command: idle by innermost program span ------------------------------

def kernel_intervals(prof, range_names) -> list:
    """Merged [start, end) unix-ns intervals of the device events of a
    stopped profiler, the benchmark's own range annotations left out (as
    ``trace.summarize`` leaves them out)."""
    from torch.autograd import DeviceType

    from benchmark.harness.trace import _union

    base = prof.profiler.kineto_results.trace_start_ns()
    ranges = set(range_names)
    ivs = [(base + ev.time_range.start * 1e3, base + ev.time_range.end * 1e3)
           for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and ev.name not in ranges]
    return _union(ivs)


class _Busy:
    """Device-busy time of merged intervals between two instants."""

    def __init__(self, merged):
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def before(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.cum[i] + max(0.0, min(t, self.ends[i]) - self.starts[i])

    def between(self, a: float, b: float) -> float:
        return self.before(b) - self.before(a)


def idle_by_span(merged, spans) -> tuple[dict, dict]:
    """Host seconds and device idle seconds by innermost open program span
    (unix clock; ``outside_spans`` between them), over the time from the
    first span's start to the last one's end. Spans nest, one thread."""
    busy = _Busy(merged)
    events = sorted([(s["unix_start_ns"], 1, s["id"], s["name"]) for s in spans]
                    + [(s["unix_end_ns"], 0, s["id"], s["name"]) for s in spans])
    host, idle = defaultdict(float), defaultdict(float)
    stack = []
    prev = None
    for t, opening, sid, name in events:
        if prev is not None and t > prev:
            label = stack[-1][1] if stack else "outside_spans"
            host[label] += (t - prev) * 1e-9
            idle[label] += (t - prev - busy.between(prev, t)) * 1e-9
        if opening:
            stack.append((sid, name))
        else:
            stack = [x for x in stack if x[0] != sid]
        prev = t
    return dict(host), dict(idle)


def idle_share(merged, spans, name: str):
    """Exact share (%) of the ``name`` spans' time with no device event."""
    busy = _Busy(merged)
    total = on = 0.0
    for s in spans:
        if s["name"] == name:
            total += s["unix_end_ns"] - s["unix_start_ns"]
            on += busy.between(s["unix_start_ns"], s["unix_end_ns"])
    return None if total <= 0 else 100.0 * (1.0 - on / total)


def main(argv=None):
    import argparse
    import json
    import sys

    from benchmark import run
    from benchmark.harness import trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    args.trace, args.precision = 1, "f32"
    from genie_tpu_torch import tracing

    kept = {}
    summarize = trace.summarize

    def keeping(prof, range_names, label_names):
        kept["merged"] = kernel_intervals(prof, range_names)
        return summarize(prof, range_names, label_names)

    tracing.reset()
    trace.summarize = keeping
    try:
        result = run.run_cell(args)
    finally:
        trace.summarize = summarize
    ex = tracing.export()
    merged = kept.get("merged", [])
    host, idle = idle_by_span(merged, ex["spans"])
    for name in sorted(idle, key=lambda k: -idle[k]):
        print(f"idle by program span: {name} {idle[name]:.6f} s of {host[name]:.6f} s",
              file=sys.stderr)
    for name in ("pipeline.sweep", "pipeline.detection_sweep", "pipeline.refine",
                 "pipeline.associate", "pipeline.locate"):
        share = idle_share(merged, ex["spans"], name)
        if share is not None:
            print(f"idle share (exact) of {name}: {share:.4f} %", file=sys.stderr)
    per_req = defaultdict(int)
    for x in ex["launches"]:
        if x["path"] == "kernel":
            per_req[x["request"]] += 1
    print(f"kernel launch records per request: {[per_req[r] for r in sorted(per_req)]}",
          file=sys.stderr)
    counts = defaultdict(int)
    for c in ex["counts"].values():
        for k, v in c.items():
            counts[k] += v
    print(f"counts: {dict(counts)}", file=sys.stderr)
    print(json.dumps(run._finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    import os

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    raise SystemExit(main())
