"""Reading a ``torch.profiler`` trace of the measured requests.

Device time is read from the kernels (and memory copies and sets) the
profiler recorded on the card. The busy time is the union of their
intervals, so kernels that overlap count once. A ``record_function`` range
that the benchmark puts around a call into the program shows twice: as a
host event, whose kernels are those launched below it, and as an
annotation on the device timeline, which is not a kernel and is left out.
"""

from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType


def _device_us(ev) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def _kernels_below(ev):
    """(name, µs) of every kernel launched by ``ev`` or below it."""
    out = [(k.name, float(k.duration)) for k in getattr(ev, "kernels", [])]
    for child in ev.cpu_children:
        out.extend(_kernels_below(child))
    return out


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, range_names, label_names) -> dict:
    """Kernel time by name, the busy union, device time and kernels below
    each named range, and the idle gaps labelled by the innermost range of
    ``label_names`` open on the host at the gap's middle."""
    ranges = set(range_names)
    by_name = defaultdict(float)
    intervals = []
    range_events = defaultdict(list)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            if ev.name in ranges:
                continue
            s, e = ev.time_range.start, ev.time_range.end
            by_name[ev.name] += (e - s) / 1e6
            intervals.append((s, e))
        elif ev.name in ranges:
            range_events[ev.name].append(ev)
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged) / 1e6
    spans = []
    for name, evs in range_events.items():
        if name not in label_names:
            continue
        for ev in evs:
            spans.append((ev.time_range.start, ev.time_range.end, name))
    idle = defaultdict(float)
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [sp for sp in spans if sp[0] <= mid < sp[1]]
        label = max(inner, key=lambda sp: sp[0])[2] if inner else "between_ranges"
        idle[label] += (s1 - e0) / 1e6
    return {
        "busy_s": busy,
        "device_s": sum(by_name.values()),
        "by_name": dict(by_name),
        "range_device_s": {n: sum(_device_us(ev) for ev in evs) / 1e6
                           for n, evs in range_events.items()},
        "range_host_s": {n: sum(ev.time_range.elapsed_us() for ev in evs) / 1e6
                         for n, evs in range_events.items()},
        "range_kernels": {n: [kv for ev in evs for kv in _kernels_below(ev)]
                          for n, evs in range_events.items()},
        "idle_by_range": dict(idle),
    }


def breakdown(summary: dict, n: int = 10) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary["idle_by_range"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
