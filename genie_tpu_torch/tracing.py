"""Spans and counters of the inference pipeline, on the profiler's clock.

A span is a named interval of host time with its parent span and the
request id of its root span; a counter is a named count of work, kept per
request; a launch record is one call of the fused-round wrapper, its shape
and its path ("kernel" on the card, "plain" on CPU tensors), under the
innermost open span. All of it is kept in memory and handed out by
:func:`export`; nothing is written during a request.

Start and end are ``time.perf_counter_ns()``. Each root span also takes one
anchor pair ``(time.time_ns(), perf_counter_ns())``, so :func:`export` gives
every span on the unix clock too, the timebase of ``torch.profiler``'s
events (``kineto_results.trace_start_ns()`` plus an event's
``time_range``): the program's spans line up with the kernels of a
profiler trace of the same run. One pair a request keeps the slew of the
two clocks from building up over a long run.

When to record: :func:`enable` records every request, :func:`disable`
none; by default the tracer records while a ``torch.profiler`` session
records, so a profiled run carries its spans without any call here. When
it records nothing, :func:`span` returns one shared no-op object after a
flag test, and :func:`count` and :func:`launch` return at once: nothing is
allocated, synchronised or read from the device. :func:`stage` always times
(the pipeline's ``stage_seconds``) and keeps a span only when recording.
The tracer adds no ``record_function`` range or other profiler event, so a
profiler trace reads the same with it on or off.

One thread: the open spans are one stack per process.
"""

from __future__ import annotations

import functools
import itertools
import json
import time

import torch.autograd.profiler as _autograd_profiler

_always = False          # enable(): record every request
_with_profiler = True    # the default: record while torch's profiler records
_stack: list = []        # open spans, innermost last
_spans: list = []        # every span opened since reset(), in start order
_counts: dict = {}       # {request id: {name: n}}
_launches: list = []     # fused-round calls
_ids = itertools.count()
_requests = itertools.count()


def recording() -> bool:
    """Whether spans, counts and launches are kept now."""
    return _always or (_with_profiler and _autograd_profiler._is_profiler_enabled)


def enable():
    """Record every request until :func:`disable`."""
    global _always, _with_profiler
    _always, _with_profiler = True, True


def disable():
    """Record nothing, not even under a profiler."""
    global _always, _with_profiler
    _always, _with_profiler = False, False


def record_with_profiler():
    """The default: record while a ``torch.profiler`` session records."""
    global _always, _with_profiler
    _always, _with_profiler = False, True


def reset():
    """Forget every span, count and launch record kept so far."""
    _stack.clear()
    _spans.clear()
    _counts.clear()
    _launches.clear()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "anchor", "start", "end")

    def __init__(self, name: str):
        self.name = name
        self.end = None

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        self.id = next(_ids)
        if parent is None:
            self.parent = None
            self.request = next(_requests)
            self.anchor = (time.time_ns(), time.perf_counter_ns())
        else:
            self.parent = parent.id
            self.request = parent.request
            self.anchor = parent.anchor
        _stack.append(self)
        _spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if _stack and _stack[-1] is self:   # not after a reset() inside the span
            _stack.pop()
        return False


def span(name: str):
    """A context manager that records ``name`` from enter to exit."""
    if not recording():
        return NOOP
    return _Span(name)


def request(name: str):
    """A root span: one request. Inside an open span it records nothing,
    since the caller's span already holds the work."""
    if _stack or not recording():
        return NOOP
    return _Span(name)


def as_request(name: str):
    """Decorate a method so that a call is one :func:`request`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with request(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Stage:
    __slots__ = ("name", "into", "key", "span", "start")

    def __init__(self, name: str, into: dict, key: str):
        self.name, self.into, self.key = name, into, key

    def __enter__(self):
        self.span = _Span(self.name).__enter__() if recording() else None
        self.start = time.perf_counter_ns() if self.span is None else self.span.start
        return self

    def __exit__(self, *exc):
        if self.span is None:
            end = time.perf_counter_ns()
        else:
            self.span.__exit__(*exc)
            end = self.span.end
        self.into[self.key] = (end - self.start) * 1e-9
        return False


def stage(name: str, into: dict, key: str):
    """A span that always times: on exit ``into[key]`` holds its seconds
    (monotonic clock), and it is kept as the span ``name`` when recording."""
    return _Stage(name, into, key)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the current request (``None``
    outside any span)."""
    if not recording():
        return
    req = _stack[-1].request if _stack else None
    per = _counts.setdefault(req, {})
    per[name] = per.get(name, 0) + int(n)


def launch(shape: tuple, path: str):
    """Keep one fused-round call: ``shape`` is (rows, n_sta, n_src, cx, cz,
    e, m, k, h, z_is_x), ``path`` "kernel" or "plain"."""
    if not recording():
        return
    top = _stack[-1] if _stack else None
    _launches.append((time.perf_counter_ns(), None if top is None else top.id,
                      None if top is None else top.request, shape, path))


def _unix(sp, t_ns: int) -> int:
    return sp.anchor[0] + (t_ns - sp.anchor[1])


def export() -> dict:
    """What was kept since :func:`reset`: ``spans`` (closed ones, in start
    order: name, id, parent, request, start_ns and end_ns on
    ``perf_counter_ns``, unix_start_ns and unix_end_ns on the unix clock),
    ``counts`` ({request: {name: n}}) and ``launches`` (t_ns, span,
    request, shape as a dict, path)."""
    spans = [{"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
              "start_ns": s.start, "end_ns": s.end,
              "unix_start_ns": _unix(s, s.start), "unix_end_ns": _unix(s, s.end)}
             for s in _spans if s.end is not None]
    keys = ("rows", "n_sta", "n_src", "cx", "cz", "e", "m", "k", "h", "z_is_x")
    launches = [{"t_ns": t, "span": sid, "request": req,
                 "shape": dict(zip(keys, shape)), "path": path}
                for t, sid, req, shape, path in _launches]
    return {"spans": spans, "counts": {k: dict(v) for k, v in _counts.items()},
            "launches": launches}


def write_chrome_trace(path, base_ns: int = 0) -> int:
    """Write the exported spans as Chrome-trace JSON: complete events, one
    row per request, each request's counts on its root span. ``ts`` is in
    µs since ``base_ns`` on the unix clock (0: the epoch); a
    ``torch.profiler`` export of the same run counts its ``ts`` from its
    ``baseTimeNanoseconds``, and with that as ``base_ns`` the two files'
    events share one timeline. Returns the number of spans written."""
    ex = export()
    events = [{"name": "process_name", "ph": "M", "pid": 0,
               "args": {"name": "genie_tpu_torch spans"}}]
    for s in ex["spans"]:
        ev = {"name": s["name"], "ph": "X", "cat": "genie_tpu_torch", "pid": 0,
              "tid": s["request"], "ts": (s["unix_start_ns"] - base_ns) / 1e3,
              "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
              "args": {"id": s["id"], "parent": s["parent"]}}
        if s["parent"] is None:
            ev["args"]["counts"] = ex["counts"].get(s["request"], {})
        events.append(ev)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns}, f)
    return len(events) - 1
