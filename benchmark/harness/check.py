"""Whether what the timed path produced is correct.

After the window, for a sample of the completed requests drawn from the
seed, the plain reference (``benchmark/reference``) works out again, from
the raw inputs, the domain tables, the travel-time tables and the graphs,
and compares the program's outputs stage by stage:

* ``sweep_gap``: the largest |difference| of the detection sweep's series
  (every query node, every time bin) and time axis, the reference sweeping
  the chunk's raw picks itself;
* ``cand_gap``: the largest |difference| of the clustered candidates'
  positions, times and values, the reference finding and clustering the
  peaks of the program's series (held by ``sweep_gap``) on its own time
  axis; a different number of candidates reads as infinite. Exact: 0;
* ``refine_gap``: the largest |difference| of the refined candidates'
  values, the reference refining its own candidates with the same random
  offsets;
* ``assoc_gap``: the largest |difference| of the per-pick P and S
  association weights of every source the program associated, the
  reference computing them at the program's refined sources;
* ``assign_gap``: how many of the reference's events differ from the
  program's in source, picks or phases, the reference grouping the
  program's refined sources and assigning picks from the program's
  weights (held by ``assoc_gap``); a different number of groups or events
  reads as infinite. Exact: 0;
* ``locate_cost_gap_s`` and ``mag_gap``, over the events of their own
  sample of requests (``compare_location``): the reference locates the
  events of the program's association in float64 (the same DE draws,
  widened), with the same QC and duplicate merge, then computes their
  magnitudes in float64 with the magnitude → distance QC. For each event
  whose picks came out the same, the excess of the location objective
  (trimmed mean |residual|, float64) at the program's location and origin
  time over the objective at the reference's; for each final event, the
  |difference| of the magnitudes. Each number is the median over the
  events, and a different number of events reads as infinite. Not the
  largest, nor the distance between the locations: the objective has
  near-equal minima hundreds of metres apart, and from the same draws a
  sound float32 run and the float64 one end now and then in different
  ones (one event in 16 read 0.033 s worse on the H100), where TF32
  products move every event.
"""

from __future__ import annotations

import copy
import math
import sys

import numpy as np
import torch

from benchmark.reference import domain as rdom
from benchmark.reference import pipeline as rpipe

NUMBERS = ("sweep_gap", "cand_gap", "refine_gap", "assoc_gap", "assign_gap",
           "locate_cost_gap_s", "mag_gap")


class ReferenceTools:
    """The reference's travel times and magnitudes, which the traffic
    generator also uses; built in set-up."""

    def __init__(self, spec: dict, inputs, dev):
        self.spec = spec
        self.inputs = inputs
        self.dev = dev
        n_sta = inputs.sta_cart.shape[0]
        self.sta = torch.as_tensor(inputs.sta_cart, device=dev)
        self.pinn = rdom.PINNTravelTimes(inputs.root / spec["pinn"], dev)
        self.trv = rdom.CorrectedTravelTimes(self.pinn, inputs.root / spec["corrections"],
                                             n_sta, dev)
        self.mag = (rdom.load_magnitudes(inputs.root / spec["magnitudes"], n_sta, dev)
                    if spec.get("magnitudes") else None)
        g = np.asarray(inputs.grids_cart, np.float32).reshape(-1, 3)
        self.box_lo, self.box_hi = g.min(0), g.max(0)

    def pipeline(self, weights_sd=None) -> rpipe.Pipeline:
        """The reference pipeline: domain tables and detector."""
        inp = self.inputs
        grids = torch.as_tensor(np.asarray(inp.grids_cart, np.float32), device=self.dev)
        trv_grids = rdom.grid_travel_times(self.trv, self.sta, grids)
        dom = rdom.build_domain(self.spec, inp.sta_lla, inp.sta_cart, inp.grids_lla,
                                inp.grids_cart, trv_grids, self.dev)
        model = rpipe.make_detector(self.spec)
        if weights_sd is None:
            rdom.load_weights(model, rdom.load_pickle(inp.root / self.spec["weights"])["params"])
        else:
            model.load_state_dict(weights_sd)
        model = model.to(self.dev).requires_grad_(False)
        mag = None
        if self.mag is not None:
            mag = {**self.mag, "model": copy.deepcopy(self.mag["model"]).double(),
                   "grid_cart": self.mag["grid_cart"].double()}
        return rpipe.Pipeline(self.spec, dom, model, self.trv.from_cart, inp.x_query,
                              mag=mag, trv_loc=self.trv.double().from_cart)


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    if a.size == 0:
        return 0.0
    d = np.abs(a - b)
    return float(np.nanmax(np.where(np.isnan(a) != np.isnan(b), np.inf, d)))


def _same_event(got, want) -> bool:
    return (np.array_equal(got[0], want[0]) and got[1] == want[1]
            and np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3]))


def compare_request(ref: rpipe.Pipeline, rec, chunk, chunk_s: float, entry: str) -> dict:
    """The check's numbers for one request (a number whose stage had no
    work in the request is left out; the stages after one whose output
    differs in size are not compared)."""
    out = {}
    t, s, p = chunk.pick_t, chunk.pick_sta, chunk.pick_phase
    times, series = ref.detection_sweep(t, s, p, 0.0, chunk_s)
    out["sweep_gap"] = max(_gap(rec.sweep[0], times), _gap(rec.sweep[1], series))
    if entry != "process":
        return out
    srcs, vals = ref.candidates(times, rec.sweep[1])
    if rec.candidates is None:
        out["cand_gap"] = math.inf
        return out
    got = np.column_stack(rec.candidates)
    out["cand_gap"] = _gap(got, np.column_stack((srcs, vals)))
    if not math.isfinite(out["cand_gap"]) or not len(srcs):
        return out
    if rec.refine is None:
        out["refine_gap"] = math.inf
        return out
    _, ref_vals = ref.refine_sources(t, s, p, srcs, vals)
    out["refine_gap"] = _gap(rec.refine[3], ref_vals)
    refined = rec.refine[2]
    groups = ref.association_groups(refined)
    if len(groups) != len(rec.associate):
        out["assign_gap"] = math.inf
        return out
    gaps, differ = [], 0
    for g, (srcs_g, windows, events) in zip(groups, rec.associate):
        if not np.array_equal(srcs_g, refined[g]):
            out["assign_gap"] = math.inf
            return out
        w_p, w_s, live, counts = ref.association_weights(t, s, p, srcs_g)
        if windows:
            got_p = torch.cat([w[0][:, 0] for w in windows]).cpu().numpy()
            got_s = torch.cat([w[1][:, 0] for w in windows]).cpu().numpy()
        else:
            got_p = got_s = np.zeros((0, w_p.shape[1]), np.float32)
        if got_p.shape != w_p.shape:
            gaps.append(math.inf)
            continue
        valid = np.arange(w_p.shape[1])[None, :] < counts[:, None]
        gaps.append(_gap(np.where(valid, got_p, 0), np.where(valid, w_p, 0)))
        gaps.append(_gap(np.where(valid, got_s, 0), np.where(valid, w_s, 0)))
        want = ref.assign_picks(t, s, p, srcs_g, got_p, got_s)
        events = events or []
        if len(events) != len(want):
            differ = math.inf
        else:
            differ += sum(not _same_event(a, b) for a, b in zip(events, want))
    if gaps:
        out["assoc_gap"] = max(gaps)
    out["assign_gap"] = float(differ)
    return out


def compare_location(ref: rpipe.Pipeline, rec, chunk):
    """One request's events for the location numbers: (location cost gaps,
    magnitude gaps), one per event, or ``None`` where the two sides hold a
    different number of events. The reference locates the events of the
    program's association (in the requests that ``compare_request``
    checks, its own association is held to them exactly)."""
    t, s = chunk.pick_t, chunk.pick_sta
    events_in = [ev for _, _, events in rec.associate for ev in (events or [])]
    if not events_in:
        return [], []
    evs = [rpipe.Event(pos, tm, pk, ph) for pos, tm, pk, ph in events_in]
    want = sorted(ref.dedup(ref.locate(evs, t, s)), key=lambda e: e.time)
    got = sorted(rec.located or [], key=lambda e: e[1])
    if len(got) != len(want):
        return None
    costs = [ref.location_cost(g[0], g[1], w.picks, w.pick_phases, t, s)
             - ref.location_cost(w.pos_cart, w.time, w.picks, w.pick_phases, t, s)
             for g, w in zip(got, want) if np.array_equal(g[2], w.picks)]
    want = sorted(ref.magnitudes(want, s, chunk.pick_amp), key=lambda e: e.time)
    got = sorted(rec.events or [], key=lambda e: e[1])
    if len(got) != len(want):
        return None
    mags = [abs(g[4] - w.mag) if (g[4] is not None and w.mag is not None)
            else (0.0 if g[4] is None and w.mag is None else math.inf)
            for g, w in zip(got, want)]
    print(f"check location: {len(want)} events; cost gaps "
          f"{[float('%.3g' % c) for c in sorted(costs)]}; magnitude gaps "
          f"{[float('%.3g' % m) for m in sorted(mags)]}", file=sys.stderr)
    return costs, mags


def location_numbers(ref: rpipe.Pipeline, records, chunks, k: int, seed: int) -> dict:
    """``locate_cost_gap_s`` and ``mag_gap``: the medians over the events of
    ``k`` requests drawn from the seed among those whose association gave
    events."""
    costs, mags = [], []
    with_events = [r for r in records if any(ev for _, _, ev in r.associate)]
    for rec in sample(with_events, k, seed, stream=4):
        got = compare_location(ref, rec, chunks[rec.chunk])
        if got is None:
            return {"locate_cost_gap_s": math.inf, "mag_gap": math.inf}
        costs += got[0]
        mags += got[1]
    out = {}
    if costs:
        out["locate_cost_gap_s"] = float(np.median(costs))
    if mags:
        out["mag_gap"] = float(np.median(mags))
    return out


def sample(records, k: int, seed: int, stream: int = 3) -> list:
    """``k`` of the completed requests, drawn from the seed."""
    done = [r for r in records if r.error is None and r.sweep is not None]
    rng = np.random.default_rng([seed, stream])
    idx = rng.permutation(len(done))[:k]
    return [done[i] for i in sorted(idx)]


def verdict(numbers: dict, limits: dict) -> bool:
    if not numbers:
        return False
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
