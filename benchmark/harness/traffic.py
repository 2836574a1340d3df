"""The benchmark's pick traffic: chunks of synthetic picks from ``--seed``.

One general generator reads a traffic mix's parameters (a JSON file under
``benchmark/traffic/``). Each chunk is ``chunk_s`` seconds of picks of the
configuration's stations: planted events, whose P and S picks are timed by
the corrected travel-time PINN plus Gaussian noise and whose amplitudes come
from the local-magnitude model plus log-normal noise, at every station
within a radius that grows with magnitude; and false picks, uniform over
the chunk, the stations and the two phases, with amplitudes ``10**U(lo,
hi)``. This is the request of ``chip_smoke.py``'s production phase with its
rates, magnitudes and placement made parameters.

Every chunk's contents are drawn from ``--seed``: its events' epicentres,
depths, origin times, the order of their magnitudes and their picks'
noise, and its false picks with every amplitude. What the seed does not
change is the amount of work: a run makes ``requests_per_s`` × the window's
seconds chunks, so that no chunk is sent twice in a window; chunk ``i``
holds ``floor((i + 1)·r + ½) − floor(i·r + ½)`` events (``r`` the events
per chunk); and the magnitudes are one set for every seed, the
Gutenberg-Richter quantiles at ``(j + ½) / n`` of the run's ``n`` events,
which the seed deals out. A request's cost follows its events (0.4-1.0 s
of DE location for one event on the H100), so with the number of events
and their magnitudes drawn too, the background cell's rate spread by 10 %
from seed to seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Chunk(NamedTuple):
    """One request: picks sorted by time and the planted events."""

    pick_t: np.ndarray      # (n,) float32 seconds from the chunk start
    pick_sta: np.ndarray    # (n,) int64
    pick_phase: np.ndarray  # (n,) float32, 0 = P, 1 = S
    pick_amp: np.ndarray    # (n,) float64
    ev_pos: np.ndarray      # (n_ev, 3) Cartesian m
    ev_t: np.ndarray        # (n_ev,)
    ev_mag: np.ndarray      # (n_ev,)


def event_counts(rate_per_chunk: float, n: int) -> np.ndarray:
    i = np.arange(n)
    return (np.floor((i + 1) * rate_per_chunk + 0.5)
            - np.floor(i * rate_per_chunk + 0.5)).astype(np.int64)


def gr_magnitudes(n: int, m_lo: float, m_hi: float, b: float) -> np.ndarray:
    """The ``n`` Gutenberg-Richter quantiles at ``(j + ½) / n`` on [m_lo, m_hi]."""
    q = (np.arange(n) + 0.5) / max(n, 1)
    span = 1.0 - 10.0 ** (-b * (m_hi - m_lo))
    return m_lo - np.log10(1.0 - q * span) / b


def event_positions(rng, mix: dict, n: int, lo: np.ndarray, hi: np.ndarray):
    """Epicentres uniform in the box (``placement`` "box"), or uniform in a
    disc of ``cluster_radius_km`` about a centre drawn in the box's middle
    half ("cluster"); depths uniform over ``depth_km`` below sea level."""
    pos = np.zeros((n, 3))
    if mix["placement"] == "box":
        pos[:, :2] = rng.uniform(lo[:2], hi[:2], (n, 2))
    elif mix["placement"] == "cluster":
        c = rng.uniform(lo[:2] + 0.25 * (hi[:2] - lo[:2]),
                        hi[:2] - 0.25 * (hi[:2] - lo[:2]))
        r = mix["cluster_radius_km"] * 1e3 * np.sqrt(rng.uniform(size=n))
        th = rng.uniform(0.0, 2 * np.pi, n)
        pos[:, 0] = c[0] + r * np.cos(th)
        pos[:, 1] = c[1] + r * np.sin(th)
    else:
        raise ValueError(f"unknown placement {mix['placement']!r}")
    d_lo, d_hi = mix["depth_km"]
    pos[:, 2] = -rng.uniform(d_lo * 1e3, d_hi * 1e3, n)
    return pos


def n_chunks(mix: dict, seconds: float) -> int:
    """Chunks for a window of ``seconds``: more than it can complete."""
    return int(np.ceil(seconds * mix["requests_per_s"])) + 1


@torch.no_grad()
def make_chunks(mix: dict, seed: int, n: int, sta_cart: torch.Tensor, box_lo, box_hi,
                trv_from_cart, mag: dict | None, chunk_s: float) -> list:
    """``n`` requests of the mix drawn from ``seed``. ``trv_from_cart``
    times the picks; ``mag`` (``{model, grid_cart}``) gives their
    amplitudes."""
    rng = np.random.default_rng([seed, 1])
    rng_amp = np.random.default_rng([seed, 2])
    sta = sta_cart.cpu().numpy()
    n_sta = len(sta)
    dev = sta_cart.device
    counts = event_counts(mix["events_per_hour"] * chunk_s / 3600.0, n)
    n_ev = int(counts.sum())
    m_lo, m_hi = mix["mag_range"]
    ev_mag = gr_magnitudes(n_ev, m_lo, m_hi, mix["b_value"])[rng.permutation(n_ev)]
    ev_pos = event_positions(rng, mix, n_ev, np.asarray(box_lo), np.asarray(box_hi))
    t_lo, t_hi = mix["event_time_s"]
    ev_t = rng.uniform(t_lo, t_hi, n_ev)
    r_lo, r_hi = mix["radius_km"]
    radius = 1e3 * (r_lo + (r_hi - r_lo) * (ev_mag - m_lo) / (m_hi - m_lo))
    pos_t = torch.as_tensor(ev_pos, dtype=torch.float32, device=dev)
    tt = (trv_from_cart(sta_cart, pos_t).cpu().numpy() if n_ev else
          np.zeros((0, n_sta, 2), np.float32))
    near = np.linalg.norm(sta[None, :, :2] - ev_pos[:, None, :2], axis=2) < radius[:, None]
    log_amp = None
    if mag is not None and n_ev:
        e_idx, s_idx = np.nonzero(near)
        e_idx = np.repeat(e_idx, 2)
        s_idx = np.repeat(s_idx, 2)
        ph = np.tile([0, 1], len(e_idx) // 2)
        pred = mag["model"](
            torch.as_tensor(ev_pos[e_idx], dtype=torch.float32, device=dev), sta_cart,
            mag["grid_cart"], torch.as_tensor(s_idx, device=dev),
            torch.as_tensor(ph, device=dev),
            mag=torch.as_tensor(ev_mag[e_idx], dtype=torch.float32, device=dev))
        log_amp = np.zeros((n_ev, n_sta, 2))
        log_amp[e_idx, s_idx, ph] = pred.cpu().numpy()
    sig = (mix["sigma_p_s"], mix["sigma_s_s"])
    a_lo, a_hi = mix["false_log_amp"]
    n_false = int(round(mix["false_picks_per_s"] * chunk_s))
    chunks, start = [], 0
    for c in range(n):
        evs = range(start, start + counts[c])
        start += counts[c]
        t, s, p, amp = [], [], [], []
        for e in evs:
            idx = np.where(near[e])[0]
            for ph in (0, 1):
                t.append(ev_t[e] + tt[e, idx, ph] + rng.normal(0, sig[ph], len(idx)))
                s.append(idx)
                p.append(np.full(len(idx), ph))
                la = (log_amp[e, idx, ph] if log_amp is not None
                      else np.zeros(len(idx)))
                amp.append(10 ** (la + rng_amp.normal(0, mix["log_amp_noise"], len(idx))))
        t.append(rng.uniform(0, chunk_s, n_false))
        s.append(rng.integers(0, n_sta, n_false))
        p.append(rng.integers(0, 2, n_false))
        amp.append(10 ** rng_amp.uniform(a_lo, a_hi, n_false))
        t, s, p, amp = map(np.concatenate, (t, s, p, amp))
        order = np.argsort(t, kind="stable")
        sl = slice(evs.start, evs.stop)
        chunks.append(Chunk(t[order].astype(np.float32), s[order].astype(np.int64),
                            p[order].astype(np.float32), amp[order], ev_pos[sl],
                            ev_t[sl], ev_mag[sl]))
    return chunks
