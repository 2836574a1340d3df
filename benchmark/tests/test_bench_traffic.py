"""The traffic generator: the same seed gives the same chunks, and the
chunks meet their mix's rates, radii and noise."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import traffic
from benchmark.harness.check import ReferenceTools

BENCH = Path(__file__).resolve().parents[1]


def _setup(cell_config="nc_run6", n_sta=60):
    spec = json.loads((BENCH / "configs" / f"{cell_config}.json").read_text())
    inputs = run.make_inputs(spec, n_sta=n_sta, n_query=10)
    return spec, ReferenceTools(spec, inputs, torch.device("cpu"))


def _chunks(mix_name, seed, tools, seconds=4.0):
    mix = json.loads((BENCH / "traffic" / f"{mix_name}.json").read_text())
    n = traffic.n_chunks(mix, seconds)
    return mix, traffic.make_chunks(mix, seed, n, tools.sta, tools.box_lo, tools.box_hi,
                                    tools.trv.from_cart, tools.mag, 600.0)


@pytest.fixture(scope="module")
def tools():
    return _setup()[1]


@pytest.mark.parametrize("mix_name", ["background", "swarm"])
def test_same_seed_same_chunks(tools, mix_name):
    """The same seed gives the same chunks; another seed other chunks with
    as many events in each and the same set of magnitudes; a window gets
    more chunks than it can complete."""
    mix, a = _chunks(mix_name, 2**31 + 5, tools)
    _, b = _chunks(mix_name, 2**31 + 5, tools)
    _, c = _chunks(mix_name, 2**31 + 6, tools)
    assert len(a) == len(c) == int(np.ceil(4.0 * mix["requests_per_s"])) + 1
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert [len(x.ev_t) for x in a] == [len(x.ev_t) for x in c]
    mags = [np.sort(np.concatenate([x.ev_mag for x in run])) for run in (a, c)]
    np.testing.assert_array_equal(*mags)
    assert not any(np.array_equal(x.pick_t, y.pick_t) for x, y in zip(a, c))


@pytest.mark.parametrize("mix_name", ["background", "swarm"])
def test_rates_radii_and_noise(tools, mix_name):
    mix, chunks = _chunks(mix_name, 123, tools)
    per_chunk = mix["events_per_hour"] * 600.0 / 3600.0
    counts = np.array([len(c.ev_t) for c in chunks])
    # each chunk holds the rate's share rounded down or up, the run in all
    # within one event of it
    assert set(counts) <= {int(np.floor(per_chunk)), int(np.ceil(per_chunk))}
    assert abs(counts.sum() - len(counts) * per_chunk) <= 1.0
    sta = tools.sta.numpy()
    m_lo, m_hi = mix["mag_range"]
    r_lo, r_hi = mix["radius_km"]
    tt_all = []
    for c in chunks:
        n_false = int(mix["false_picks_per_s"] * 600)
        n_planted = len(c.pick_t) - n_false
        assert n_planted >= 0
        assert np.all((c.ev_mag >= m_lo) & (c.ev_mag <= m_hi))
        assert np.all((-c.ev_pos[:, 2] >= mix["depth_km"][0] * 1e3)
                      & (-c.ev_pos[:, 2] <= mix["depth_km"][1] * 1e3))
        radius = 1e3 * (r_lo + (r_hi - r_lo) * (c.ev_mag - m_lo) / (m_hi - m_lo))
        d = np.linalg.norm(sta[None, :, :2] - c.ev_pos[:, None, :2], axis=2)
        assert n_planted == 2 * int((d < radius[:, None]).sum())
        if len(c.ev_t):
            tt = tools.trv.from_cart(tools.sta, torch.as_tensor(
                c.ev_pos, dtype=torch.float32)).numpy()
            for e in range(len(c.ev_t)):
                for s in np.where(d[e] < radius[e])[0]:
                    for ph in (0, 1):
                        t_want = c.ev_t[e] + tt[e, s, ph]
                        hit = np.abs(c.pick_t[(c.pick_sta == s) & (c.pick_phase == ph)]
                                     - t_want)
                        tt_all.append((ph, hit.min()))
    if mix["placement"] == "cluster":
        pos = np.concatenate([c.ev_pos for c in chunks])
        assert np.ptp(pos[:, 0]) <= 2e3 * mix["cluster_radius_km"] + 1.0
    err = np.array(tt_all)
    # the nearest pick to each planted arrival lies within 5 sigma of it
    for ph, sig in ((0, mix["sigma_p_s"]), (1, mix["sigma_s_s"])):
        assert np.all(err[err[:, 0] == ph, 1] < 5 * sig)


def test_gutenberg_richter_quantiles():
    m = traffic.gr_magnitudes(8000, 1.5, 3.5, 1.0)
    assert np.all(np.diff(m) > 0) and 1.5 < m[0] and m[-1] < 3.5
    # b = 1: the share above M is 10^-(M - 1.5), truncated at 3.5
    for mag in (2.0, 2.5, 3.0):
        want = (10 ** -(mag - 1.5) - 10 ** -2.0) / (1 - 10 ** -2.0)
        assert abs(np.mean(m > mag) - want) < 1e-3
