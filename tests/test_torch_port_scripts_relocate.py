"""The port's ``relocate`` command against the JAX ``scripts/relocate.py``,
and the two example twins (``genie_tpu_torch.examples``), on the CPU.

* ``relocate``: on a catalog of a 24-event cluster with exact picks and
  starts displaced by N(0, 4 km), both commands build the same graphs
  (the port seeds numpy with the integer that JAX's ``PRNGKey(0)`` draws),
  write the same keys, shapes and dtypes, and the port's relocation cuts
  graph 0's median 3-D error under 0.8 of the initial;
* ``quickstart_detection`` at ``--steps 1`` (its smallest) on a 500-node
  query grid in place of 10,000: the example's sweep at the default takes
  ~160 s on the CPU;
* ``quickstart_relocation`` at 300 steps: its own criterion (median error
  under 0.8 of the initial) holds.
"""

import contextlib
import io
import re
from types import SimpleNamespace

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tpu.relocation.graphdd import make_relocation_graphs as jax_graphs
from genie_tpu.setup.project import init_project as jax_init_project
from genie_tpu_torch import io as tio
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.infer.pipeline import CatalogEvent
from genie_tpu_torch.scripts.relocate import (GRAPH_SEED, build_graphs,
                                              catalog_observations)
from genie_tpu_torch.workflow import make_trv

from tests.test_torch_port_scripts import process_cfg, run_jax, run_port, write_config
from tests.test_trainer import tiny_domain


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A project of tests/test_trainer.py's tiny domain (16 stations) and a
    catalog of 24 events in a 2 km cluster under it: picks exact at the
    project's homogeneous times (85 % present), the events displaced by
    N(0, 4 km), which relocation should undo."""
    tmp = tmp_path_factory.mktemp("scripts_relocate")
    root = tmp / "proj"
    cfg = process_cfg()
    cfg_path = write_config(tmp / "cfg.yaml", cfg)
    base, _ = tiny_domain(cfg)
    jax_init_project(root, cfg, sta_lla=np.asarray(base.sta_lla), n_steps_grids=1)
    proj = Projection.from_center(cfg.region.center)
    sta = proj.to_cart_np(np.asarray(base.sta_lla)).astype(np.float32)
    rng = np.random.default_rng(0)
    n_ev, n_sta = 24, len(sta)
    true_pos = (np.array([5e3, -8e3, -10e3]) + rng.normal(0, 2e3, (n_ev, 3))
                ).astype(np.float32)
    true_t = np.sort(rng.uniform(0, 1000, n_ev)).astype(np.float32)
    trv = make_trv(Config.from_dict(cfg.to_dict()), proj, device="cpu")
    tt = trv.from_cart(torch.as_tensor(sta), torch.as_tensor(true_pos)).numpy()
    init_pos = (true_pos + rng.normal(0, 4e3, (n_ev, 3))).astype(np.float32)
    pick_t, pick_sta, events = [], [], []
    for e in range(n_ev):
        idx, ph = np.nonzero(rng.random((n_sta, 2)) < 0.85)
        first = len(pick_t)
        pick_t.extend(true_t[e] + tt[e, idx, ph])
        pick_sta.extend(idx)
        events.append(CatalogEvent(pos_cart=init_pos[e], time=float(true_t[e]),
                                   picks=np.arange(first, first + len(idx)),
                                   pick_phases=ph, cov=None, mag=None, score=1.0))
    path = tmp / "cluster.hdf5"
    tio.save_catalog(path, events, pick_t=np.asarray(pick_t), pick_sta=np.asarray(pick_sta))
    return dict(root=root, cfg_path=cfg_path, path=path, sta=sta, true_pos=true_pos,
                init_pos=init_pos)


def test_relocate_builds_the_jax_graphs(cluster):
    assert GRAPH_SEED == int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 2**31 - 1))
    events = tio.load_catalog(cluster["path"])
    with h5py.File(cluster["path"], "r") as f:
        obs = catalog_observations(events, np.asarray(f["pick_t"]),
                                   np.asarray(f["pick_sta"]), len(cluster["sta"]))
    got = build_graphs(SimpleNamespace(sta_cart=torch.as_tensor(cluster["sta"])), *obs,
                       n_graphs=2, graph_size=32)
    want = jax_graphs(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in obs),
                      jnp.asarray(cluster["sta"]), n_graphs=2, graph_size=24)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("src_pos", "src_time", "sta_sel", "obs_time", "obs_mask", "src_mask"):
            np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(w, k)),
                                          err_msg=k)


def test_relocate_writes_the_jax_arrays_and_cuts_the_error(cluster):
    root, path = cluster["root"], cluster["path"]
    true_pos, init_pos = cluster["true_pos"], cluster["init_pos"]
    out = root / "DoubleDifferenceModels/relocated_ver_1.npz"
    args = (root, path, "--config", cluster["cfg_path"], "--graphs", 2)
    run_jax("relocate", *args, "--steps", 1)
    zj = np.load(out)
    zj = {k: zj[k] for k in zj.files}
    text = run_port("relocate", *args, "--steps", 100)
    assert re.search(r"graphdd trained, final loss [\d.]+", text)
    zt = np.load(out)
    assert sorted(zt.files) == sorted(zj) == ["src_pos", "src_time", "sta_corr"]
    for k in zj:
        assert zt[k].shape == zj[k].shape and zt[k].dtype == zj[k].dtype, k
    assert zt["src_pos"].shape == (24, 3) and zt["sta_corr"].shape[1] == 2
    # graph 0 holds every event; find each of its sources by its start
    events = tio.load_catalog(path)
    with h5py.File(path, "r") as f:
        obs = catalog_observations(events, np.asarray(f["pick_t"]),
                                   np.asarray(f["pick_sta"]), len(cluster["sta"]))
    g0 = build_graphs(SimpleNamespace(sta_cart=torch.as_tensor(cluster["sta"])), *obs,
                      n_graphs=2, graph_size=32)[0].src_pos.numpy()
    idx = np.array([np.argmin(np.linalg.norm(init_pos - q, axis=1)) for q in g0])
    np.testing.assert_array_equal(init_pos[idx], g0)
    before = np.linalg.norm(g0 - true_pos[idx], axis=1)
    after = np.linalg.norm(zt["src_pos"] - true_pos[idx], axis=1)
    assert np.median(after) < 0.8 * np.median(before)


def test_quickstart_detection_runs_on_the_cpu(monkeypatch):
    from genie_tpu_torch.examples import quickstart_detection

    build = quickstart_detection.build

    def small_query_grid(*a, **kw):
        cfg, ctx, tt = build(*a, **kw)
        cfg.process.n_query_grid = 500
        return cfg, ctx, tt

    monkeypatch.setattr(quickstart_detection, "build", small_query_grid)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        events, stats = quickstart_detection.main(["--steps", "1", "--device", "cpu"])
    text = out.getvalue()
    assert "domain: 16 stations, 2x120 source grids" in text
    assert re.search(r"step 0 loss [\d.]+", text)
    m = re.search(r"timeline: (\d+) picks, (\d+) events", text)
    assert m and int(m.group(1)) > 0 and int(m.group(2)) == stats["n_reference"] > 0
    assert stats["n_detected"] == len(events)
    assert f"pipeline detected {len(events)} events" in text


def test_quickstart_relocation_cuts_the_error_on_the_cpu():
    from genie_tpu_torch.examples import quickstart_relocation

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        before, after = quickstart_relocation.main(["--steps", "300", "--device", "cpu"])
    assert np.median(after) < 0.8 * np.median(before)
    assert "median location error" in out.getvalue()
