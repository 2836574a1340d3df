"""The port's FDSN acquisition (``genie_tpu_torch.setup.fdsn``,
``init_project(fdsn=…)``) and ``workflow.train(use_wandb=…)`` against the
JAX package's, without network or either package: a stubbed obspy (the
one of tests/test_workflow.py::test_fdsn_acquisition_with_stubbed_obspy)
and a stubbed wandb that records its calls.

* downloads: equal arrays, names and event types, exactly;
* ``init_project(fdsn=…)``: equal station files;
* without obspy both raise ``ImportError`` with the same hint;
* ``train(use_wandb=True)``: the same ``wandb.init`` project and
  ``wandb.log`` keys at the same steps (the values differ with the random
  streams), and log lines of one format; without wandb the port trains on.
"""

import re
import sys
import types

import numpy as np
import pytest
import torch

from genie_tpu.setup import fdsn as jfdsn
from genie_tpu.setup import project as jproj
from genie_tpu_torch.config import Config
from genie_tpu_torch.setup import fdsn as tfdsn
from genie_tpu_torch.setup import project as tproj

from tests.test_torch_port_scripts import LOG_LINE
from tests.test_workflow import small_cfg


class _Sta:
    def __init__(self, code, lat, lon, elev):
        self.code, self.latitude = code, lat
        self.longitude, self.elevation = lon, elev


class _UTC(float):
    def __new__(cls, *a):
        return super().__new__(cls, a[0] if len(a) == 1 else 0.0)

    def __sub__(self, other):
        return float(self) - float(other)


class _Origin:
    def __init__(self, lat, lon, dep, t):
        self.latitude, self.longitude = lat, lon
        self.depth, self.time = dep, _UTC(t)


class _Mag:
    def __init__(self, m):
        self.mag = m


class _Ev:
    def __init__(self, lat, lon, dep, t, m, kind="earthquake"):
        self.origins = [_Origin(lat, lon, dep, t)]
        self.magnitudes = [_Mag(m)] if m is not None else []
        self.event_type = kind


class _Client:
    calls = []

    def __init__(self, name):
        self.name = name

    def get_stations(self, **kw):
        self.calls.append(("get_stations", self.name, kw))
        return [[_Sta("B", 40.5, -124.2, 100.0), _Sta("A", 40.1, -124.0, 50.0)],
                [_Sta("C", 39.9, -123.5, 900.0)]]

    def get_events(self, **kw):
        self.calls.append(("get_events", self.name, kw))
        return [_Ev(40.3, -124.1, 5000.0, 100.0, 2.1),
                _Ev(40.4, -124.3, 8000.0, 200.0, None, "quarry blast")]


@pytest.fixture
def obspy(monkeypatch):
    mod = types.ModuleType("obspy")
    core = types.ModuleType("obspy.core")
    core.UTCDateTime = _UTC
    clients = types.ModuleType("obspy.clients")
    fdsn_mod = types.ModuleType("obspy.clients.fdsn")
    fdsn_mod.Client = _Client
    for name, m in [("obspy", mod), ("obspy.core", core),
                    ("obspy.clients", clients), ("obspy.clients.fdsn", fdsn_mod)]:
        monkeypatch.setitem(sys.modules, name, m)
    _Client.calls = []
    return _Client


def test_download_stations_matches_jax(obspy):
    args = ((39, 42), (-126, -122), 0.0, 1.0)
    lla, names = tfdsn.download_stations(*args, network="NC", client="SCEDC")
    want_lla, want_names = jfdsn.download_stations(*args, network="NC", client="SCEDC")
    assert list(names) == list(want_names) == ["C", "A", "B"]     # latitude-sorted
    assert lla.dtype == want_lla.dtype
    np.testing.assert_array_equal(lla, want_lla)
    assert obspy.calls[0] == obspy.calls[1]      # the same query, argument for argument


def test_download_catalog_matches_jax(obspy):
    args = ((39, 42), (-126, -122), 1.0, 0.0, 1.0)
    cat, evs, kinds = tfdsn.download_catalog(*args, t0=_UTC(0.0))
    want, want_evs, want_kinds = jfdsn.download_catalog(*args, t0=_UTC(0.0))
    assert cat.shape == want.shape == (2, 5)
    np.testing.assert_array_equal(cat, want)        # NaN magnitude in both
    assert cat[0].tolist() == [40.3, -124.1, -5000.0, 100.0, 2.1] and np.isnan(cat[1, 4])
    assert list(kinds) == list(want_kinds) == ["earthquake", "quarry blast"]
    assert len(evs) == len(want_evs) == 2
    assert obspy.calls[0] == obspy.calls[1]


def test_empty_inventory_matches_jax(obspy, monkeypatch):
    monkeypatch.setattr(obspy, "get_stations", lambda self, **kw: [])
    lla, names = tfdsn.download_stations((39, 42), (-126, -122), 0.0, 1.0)
    want_lla, want_names = jfdsn.download_stations((39, 42), (-126, -122), 0.0, 1.0)
    assert lla.shape == want_lla.shape == (0, 3) and len(names) == len(want_names) == 0


def test_init_project_from_fdsn_matches_jax(obspy, tmp_path):
    jcfg = small_cfg()
    tcfg = Config.from_dict(jcfg.to_dict())
    q = dict(starttime=0.0, endtime=1.0, network="NC")
    jproj.init_project(tmp_path / "jax", jcfg, fdsn=q, n_steps_grids=5)
    tproj.init_project(tmp_path / "port", tcfg, fdsn=q, n_steps_grids=5, device="cpu")
    for f in ("TestProj_stations.npz", "TestProj_region.npz"):
        za, zb = (np.load(tmp_path / d / f, allow_pickle=True) for d in ("port", "jax"))
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    z = np.load(tmp_path / "port/TestProj_stations.npz", allow_pickle=True)
    assert list(z["stas"]) == ["C", "A", "B"]
    # the query covers the config's region
    kw = obspy.calls[-1][2]
    assert (kw["minlatitude"], kw["maxlatitude"]) == tuple(tcfg.region.lat_range)


def test_without_obspy_both_raise_the_same_hint(monkeypatch):
    monkeypatch.setitem(sys.modules, "obspy", None)
    monkeypatch.setitem(sys.modules, "obspy.clients", None)
    monkeypatch.setitem(sys.modules, "obspy.clients.fdsn", None)
    msgs = []
    for mod in (tfdsn, jfdsn):
        with pytest.raises(ImportError, match="requires obspy") as e:
            mod.download_stations((39, 42), (-126, -122), 0.0, 1.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1].replace("genie_tpu.setup", "genie_tpu_torch.setup")


class _Wandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logs = [], []

    def init(self, **kw):
        self.inits.append(kw)

    def log(self, data, step=None):
        self.logs.append((step, dict(data)))


def _normalized(line):
    """A log line with its numbers replaced: its format."""
    s = re.sub(r"-?\d+(\.\d*)?(e[-+]?\d+)?", "N", line)
    return re.sub(r"\[\s*", "[", re.sub(r"\s*\]", "]", re.sub(r"N(\s+N)+", "N N", s)))


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    from genie_tpu.workflow import domain_from_project as jdomain

    from genie_tpu_torch.workflow import domain_from_project

    tmp = tmp_path_factory.mktemp("fdsn_train")
    jcfg = small_cfg()
    rng = np.random.default_rng(0)
    n = jcfg.graph.max_sta
    sta = np.stack((rng.uniform(*jcfg.region.lat_range, n),
                    rng.uniform(*jcfg.region.lon_range, n),
                    rng.uniform(0, 1200, n)), axis=1)
    jproj.init_project(tmp, jcfg, sta_lla=sta, n_steps_grids=20)
    tcfg = Config.from_dict(jcfg.to_dict())
    return dict(tmp=tmp, jcfg=jcfg, tcfg=tcfg, jax=jdomain(tmp, jcfg),
                port=domain_from_project(tmp, tcfg, device="cpu"))


def test_wandb_hook_logs_what_jax_logs(project, monkeypatch):
    """Two steps at ``log_every=1`` in both packages, each with its own
    recording stub."""
    from genie_tpu.workflow import train as jax_train

    from genie_tpu_torch.workflow import train

    tmp = project["tmp"]
    stubs, lines = {}, {}
    for pkg in ("jax", "port"):
        stubs[pkg] = _Wandb()
        monkeypatch.setitem(sys.modules, "wandb", stubs[pkg])
        ctx, _, trv = project[pkg]
        out = tmp / f"train_{pkg}"
        if pkg == "jax":
            jax_train(project["jcfg"], ctx, trv, out, n_steps=2, log_every=1, use_wandb=True)
        else:
            n = torch.get_num_threads()
            torch.set_num_threads(2)
            try:
                train(project["tcfg"], ctx, trv, out, n_steps=2, log_every=1,
                      use_wandb=True)
            finally:
                torch.set_num_threads(n)
        lines[pkg] = (out / "TestProj_output_ver_1.txt").read_text().splitlines()
    assert stubs["port"].inits == stubs["jax"].inits == [{"project": "genie_tpu_TestProj"}]
    got = [(s, sorted(d)) for s, d in stubs["port"].logs]
    want = [(s, sorted(d)) for s, d in stubs["jax"].logs]
    assert got == want == [(i, ["loss", "loss_grid", "loss_p", "loss_query", "loss_s"])
                           for i in range(2)]
    for _, d in stubs["port"].logs:
        assert all(isinstance(v, float) and np.isfinite(v) for v in d.values())
    assert len(lines["port"]) == len(lines["jax"]) == 2
    for a, b in zip(lines["port"], lines["jax"]):
        assert LOG_LINE.match(a) and LOG_LINE.match(b)
        assert _normalized(a) == _normalized(b)


def test_port_trains_on_without_wandb(project, monkeypatch):
    from genie_tpu_torch.workflow import train

    monkeypatch.setitem(sys.modules, "wandb", None)      # import wandb raises
    ctx, _, trv = project["port"]
    _, state, history = train(project["tcfg"], ctx, trv, project["tmp"] / "no_wandb",
                              n_steps=1, log_every=1, use_wandb=True)
    assert state.step == 1 and np.isfinite(history[0][0]["loss"])
