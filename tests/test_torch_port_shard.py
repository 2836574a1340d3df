"""The port's multi-device package (``genie_tpu_torch/parallel``) against the
JAX package's ``genie_tpu/parallel``, on the CPU.

* The host plans (``build_partition``, ``build_station_subselection``) are
  bit-identical to JAX's: every integer and flag, on the clouds of
  ``tests/test_product_shard.py`` and its thin clustered cloud.
* Gloo groups of 4 and 2 processes on the CPU (``torch_port_shard_worker.py``,
  one spawn per group for the whole module) run the halo-exchange
  aggregation (against JAX's on a 4-device virtual mesh, atol 1e-5; the bf16
  wire within 2e-2, JAX's bound), the sub-selected aggregation (against
  JAX's under ``shard_map``, atol 1e-5), the sharded and subgraph-sharded
  detection forwards on ``make_tiny_scene(n_src=64)`` (run6's weights for
  the run6 model, flax-default weights for the updated model definition)
  (against JAX's dense ``forward_detection_only`` and, with a thin pair
  mask, JAX's subgraph-sharded forward; atol 2e-4 / rtol 1e-4, the detector
  tolerance of ``tests/test_torch_port_detector.py``) and the data-parallel
  training step (2 ranks against one process on the same batch, every
  gradient leaf within 1e-6 × the largest |g|, weights after Adam within
  1e-5; and against JAX's ``loss_fn`` gradients within 1e-4 × the largest
  |g|, as ``tests/test_torch_port_train_step.py`` holds them).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.graphs.build import build_source_graph, build_station_graph
from genie_tpu.graphs.subgraph import pair_mask
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.ops.knn import knn_graph
from genie_tpu.parallel import product_shard as jps
from genie_tpu.parallel.mesh import make_mesh as jax_make_mesh
from genie_tpu.parallel.sharded_detector import (
    make_subgraph_sharded_detection_forward as jax_subgraph_forward)
from genie_tpu.train.trainer import generate_batch as jax_generate_batch
from genie_tpu.train.trainer import loss_fn as jax_loss_fn
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.models.init import init_detector
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.params import flatten_tree, load_flax_params, load_into, to_flax
from genie_tpu_torch.parallel import product_shard as tps
from genie_tpu_torch.synth.generator import WindowBatch
from genie_tpu_torch.train.trainer import (TrainState, build_domain_context, loss_fn,
                                           make_optimizer, make_train_step_from_batch)

from tests.test_detector import make_tiny_scene
from tests.test_trainer import tiny_config, tiny_domain

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_port_shard_worker.py"
RUN6 = ROOT / "projects/NC_EHZ/run6/params.pkl"
ATOL, RTOL = 2e-4, 1e-4
GROUP_TIMEOUT = 120


# -- inputs, made with numpy and the JAX package's graph functions ------------

def _agg_inputs():
    """``tests/test_product_shard.py``'s dense-equality cloud."""
    rng = np.random.default_rng(0)
    n_src, n_sta, c = 128, 6, 5
    src_pos = rng.uniform(-50e3, 50e3, (n_src, 3)).astype(np.float32)
    feat = rng.normal(size=(n_src, n_sta, c)).astype(np.float32)
    src_nbr = np.asarray(build_source_graph(src_pos, 7))
    return src_pos, src_nbr, feat


def _subsel_inputs(n_shards):
    """``tests/test_product_shard.py:173``'s inputs: a thin pair mask."""
    rng = np.random.default_rng(2)
    n_src, n_sta, c, k = 64, 24, 3, 6
    src_pos = rng.uniform(-80e3, 80e3, (n_src, 3)).astype(np.float32)
    sta_posd = rng.uniform(-80e3, 80e3, (n_sta, 3)).astype(np.float32)
    src_nbr = np.asarray(build_source_graph(src_pos, k))
    sta_nbr, sta_valid = (np.asarray(a) for a in build_station_graph(sta_posd, 4))
    a = np.asarray(pair_mask(jnp.asarray(src_pos / 111e3), jnp.asarray(sta_posd / 111e3),
                             max_deg_offset=0.35, k_nearest_pairs=4))
    part = jps.build_partition(src_pos, src_nbr, n_shards)
    sub = jps.build_station_subselection(a, part, jnp.asarray(sta_nbr),
                                         jnp.asarray(sta_valid))
    n_local, n_sel = n_src // n_shards, sub.n_sel
    x = rng.normal(size=(n_src, n_sel + 1, c)).astype(np.float32)
    x[:, -1] = 0.0
    sel_valid = np.asarray(sub.sel_valid)
    for row in range(n_src):
        x[row, :n_sel][~sel_valid[row // n_local]] = 0.0
    return src_pos, src_nbr, a, sta_nbr, sta_valid, x, part, sub


def _thin_cloud():
    """``tests/test_product_shard.py:109``'s thin clustered seismicity cloud."""
    rng = np.random.default_rng(0)
    n_src = 4096
    centers = rng.uniform(-250e3, 250e3, (8, 3)) * np.array([1, 1, 0.05])
    cl = (centers[rng.integers(0, 8, n_src - 1024)]
          + rng.normal(0, 15e3, (n_src - 1024, 3)) * np.array([1, 1, 0.3]))
    bg = rng.uniform(-300e3, 300e3, (1024, 3)) * np.array([1, 1, 0.066])
    src = np.concatenate([cl, bg]).astype(np.float32)
    return src, np.asarray(knn_graph(jnp.asarray(src), 15)[0])


def _scene():
    feat, mask, graph, sta_pos, picks, queries = make_tiny_scene(seed=3, n_src=64)
    a_thin = np.asarray(pair_mask(graph.src_pos / 111e3, sta_pos / 111e3,
                                  max_deg_offset=0.3, k_nearest_pairs=4))
    return feat, mask, graph, sta_pos, picks, queries, a_thin


def _weights(updated):
    """(torch detector, its flax tree): run6's trained weights for the run6
    model, flax-default weights (``init_detector``, seed 0) for the updated
    model definition, whose linears are wider."""
    model = Detector(src_chunk=4, use_updated_model_definition=updated)
    if updated:
        model = init_detector(model, torch.Generator().manual_seed(0))
    else:
        model = load_into(model, load_flax_params(RUN6))
    return model.eval(), {"params": jax.tree.map(jnp.asarray, to_flax(model))}


def _train_setup():
    """``tests/test_torch_port_train_step.py``'s batch: JAX key 9 on the
    tiny domain, positive boost 100, the sensitivity term on."""
    jcfg = tiny_config()
    jcfg.train.positive_boost = 100.0
    jcfg.train.sensitivity_weight = 2e-6
    jctx, jtt = tiny_domain(jcfg)
    jwb = jax.jit(lambda k: jax_generate_batch(k, jcfg, jctx, jtt.from_cart))(
        jax.random.PRNGKey(9))
    return jcfg, jctx, jtt, jwb


# -- the gloo groups --------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_group(d: Path, world: int):
    """Spawn ``world`` worker processes on a fresh port; every rank's
    outputs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(d), str(r), str(world),
                               str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log}"
    return [dict(np.load(d / f"out_{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def group4(tmp_path_factory, scene):
    """One 4-rank group: aggregation, sub-selected aggregation, forwards."""
    d = tmp_path_factory.mktemp("group4")
    src_pos, src_nbr, feat = _agg_inputs()
    ss = _subsel_inputs(4)
    sfeat, smask, graph, sta_pos, _, queries, a_thin = scene
    inp = dict(agg_src_pos=src_pos, agg_src_nbr=src_nbr, agg_feat=feat,
               ss_src_pos=ss[0], ss_src_nbr=ss[1], ss_a=ss[2], ss_sta_nbr=ss[3],
               ss_sta_valid=ss[4], ss_x=ss[5], sc_sta_pos=np.asarray(sta_pos),
               sc_feat=np.asarray(sfeat), sc_mask=np.asarray(smask),
               sc_x_query=np.asarray(queries.x_query),
               sc_x_query_idx=np.asarray(queries.x_query_idx),
               sc_t_query=np.asarray(queries.t_query), sc_thin=a_thin)
    for f, v in zip(graph._fields, graph):
        inp[f"sc_{f}"] = np.asarray(v)
    for v in (0, 1):
        torch.save(_weights(bool(v))[0].state_dict(), d / f"detector_{v}.pt")
    np.savez(d / "inputs.npz", **inp)
    (d / "plan.json").write_text(json.dumps({"cases": ["agg", "subsel", "forward"]}))
    return _run_group(d, 4)


@pytest.fixture(scope="module")
def train_data():
    return _train_setup()


@pytest.fixture(scope="module")
def group2(tmp_path_factory, train_data):
    """One 2-rank group: aggregation and the data-parallel step."""
    d = tmp_path_factory.mktemp("group2")
    src_pos, src_nbr, feat = _agg_inputs()
    jcfg, jctx, _, jwb = train_data
    inp = dict(agg_src_pos=src_pos, agg_src_nbr=src_nbr, agg_feat=feat,
               tr_sta_lla=np.asarray(jctx.sta_lla), tr_sta_cart=np.asarray(jctx.sta_cart),
               tr_grids_lla=np.asarray(jctx.grids_lla),
               tr_grids_cart=np.asarray(jctx.grids_cart),
               tr_trv_grids=np.asarray(jctx.trv_grids))
    for f, v in zip(WindowBatch._fields, jwb):
        inp[f"wb_{f}"] = np.asarray(v)
    np.savez(d / "inputs.npz", **inp)
    (d / "cfg.json").write_text(json.dumps(jcfg.to_dict()))
    (d / "plan.json").write_text(json.dumps({"cases": ["agg", "train"]}))
    return _run_group(d, 2)


# -- host plans, bit for bit ------------------------------------------------------

def _plan_clouds():
    rng0 = np.random.default_rng(1)
    src512 = rng0.uniform(0, 100e3, (512, 3)).astype(np.float32)
    src_pos, src_nbr, _ = _agg_inputs()
    rng2 = np.random.default_rng(2)
    src2 = rng2.uniform(-50e3, 50e3, (128, 3)).astype(np.float32)
    return {"dense128": (src_pos, src_nbr, 8),
            "bf16_128": (src2, np.asarray(build_source_graph(src2, 7)), 8),
            "halo512": (src512, np.asarray(build_source_graph(src512, 15)), 8),
            "dense128_4": (src_pos, src_nbr, 4)}


def _same(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), what


def _same_partition(tp, jp):
    for f in ("n_shards", "n_local", "halo_total", "offsets", "halo_base"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("perm", "inv_perm", "local_nbr", "nbr_valid"):
        _same(getattr(tp, f), getattr(jp, f), f)
    for f in ("off_send_idx", "off_send_valid"):
        assert len(getattr(tp, f)) == len(getattr(jp, f))
        for a, b in zip(getattr(tp, f), getattr(jp, f)):
            _same(a, b, f)
    assert tp.halo_rows_valid == jp.halo_rows_valid
    assert tp.halo_rows_moved == jp.halo_rows_moved


@pytest.mark.parametrize("cloud", ["dense128", "bf16_128", "halo512", "dense128_4"])
def test_partition_plan_is_jax_bit_for_bit(cloud):
    src_pos, src_nbr, n = _plan_clouds()[cloud]
    _same(tps._morton_order(src_pos).astype(np.int64),
          jps._morton_order(src_pos).astype(np.int64), "morton")
    _same_partition(tps.build_partition(src_pos, src_nbr, n),
                    jps.build_partition(src_pos, src_nbr, n))


def test_partition_plan_on_thin_clustered_cloud_is_jax_bit_for_bit():
    src, nbr = _thin_cloud()
    tp = tps.build_partition(torch.from_numpy(src), torch.from_numpy(nbr), 8)
    _same_partition(tp, jps.build_partition(src, nbr, 8))
    assert tp.halo_rows_valid / 8 < 0.5 * tp.n_local     # the halo stays thin


@pytest.mark.parametrize("n_shards", [4, 8])
def test_station_subselection_plan_is_jax_bit_for_bit(n_shards):
    src_pos, src_nbr, a, sta_nbr, sta_valid, _, jpart, jsub = _subsel_inputs(n_shards)
    tpart = tps.build_partition(src_pos, src_nbr, n_shards)
    tsub = tps.build_station_subselection(a, tpart, sta_nbr, sta_valid)
    assert tsub.n_sel == jsub.n_sel and tsub.n_sel < a.shape[1]
    for f in ("sta_sel", "sel_valid", "sta_nbr", "sta_nbr_valid", "col_map"):
        _same(getattr(tsub, f), getattr(jsub, f), f)


def test_partition_refuses_uneven_shards():
    src_pos, src_nbr, _ = _agg_inputs()
    with pytest.raises(ValueError, match="pad the grid"):
        tps.build_partition(src_pos[:127], src_nbr[:127] % 127, 4)


# -- aggregations over the groups ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_agg():
    src_pos, src_nbr, feat = _agg_inputs()
    part = jps.build_partition(src_pos, src_nbr, 4)
    mesh = jax_make_mesh(4, axis_names=("src",))
    perm, inv = np.asarray(part.perm), np.asarray(part.inv_perm)
    got = np.asarray(jps.sharded_src_aggregation(jnp.asarray(feat[perm]), part, mesh))
    return got[inv]


@pytest.mark.parametrize("world", [4, 2])
def test_sharded_src_aggregation_matches_jax(world, group4, group2, jax_agg):
    outs = group4 if world == 4 else group2
    for out in outs:                       # every rank holds the whole result
        assert str(out["wire"]) == "host"
        np.testing.assert_allclose(out["agg"], jax_agg, atol=1e-5)
    assert int(outs[0]["agg_halo_rows_valid"]) > 0


@pytest.mark.parametrize("world", [4, 2])
def test_bf16_wire_within_bf16_rounding(world, group4, group2, jax_agg):
    out = (group4 if world == 4 else group2)[0]
    assert out["agg_bf16"].dtype == np.float32
    err = float(np.abs(out["agg_bf16"] - jax_agg).max())
    assert 0.0 < err < 2e-2, err               # bf16 rounding of the halo rows only


def test_subsel_aggregation_matches_jax_shard_map(group4):
    _, _, _, _, _, x, part, sub = _subsel_inputs(4)
    mesh = jax_make_mesh(4, axis_names=("src",))

    def f(x_local, colmap_l):
        sid = jax.lax.axis_index("src")
        return jps.sharded_gather_mean_src_axis_subsel(x_local, part, colmap_l[0],
                                                       sid, "src")

    want = np.asarray(shard_map(f, mesh=mesh, in_specs=(jax.sharding.PartitionSpec("src"),
                                                        jax.sharding.PartitionSpec("src")),
                                out_specs=jax.sharding.PartitionSpec("src"))(
        jnp.asarray(x), sub.col_map))
    for out in group4:
        np.testing.assert_allclose(out["subsel"], want, atol=1e-5)


# -- the sharded detection forwards --------------------------------------------------

@pytest.fixture(scope="module")
def jax_dense(scene):
    feat, mask, graph, sta_pos, _, queries, _ = scene
    out = {}
    for v in (0, 1):
        jm = JaxDetector(src_chunk=4, use_updated_model_definition=bool(v))
        out[v] = jm.apply(_weights(bool(v))[1], feat, mask, graph, sta_pos, queries.x_query,
                          queries.x_query_idx, queries.t_query,
                          method=JaxDetector.forward_detection_only)
    return out


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("updated", [False, True], ids=["run6", "updated"])
def test_sharded_forward_matches_jax_dense(updated, group4, jax_dense):
    v = int(updated)
    want_y, want_x = jax_dense[v]
    assert float(jnp.abs(want_y).max()) > 1e-3
    for out in group4:                     # every rank returns the same (y, x_q)
        _close(out[f"fwd{v}_y"], want_y)
        _close(out[f"fwd{v}_x"], want_x)


@pytest.mark.parametrize("updated", [False, True], ids=["run6", "updated"])
def test_subgraph_sharded_forward_all_true_matches_jax_dense(updated, group4, jax_dense,
                                                             scene):
    v = int(updated)
    want_y, want_x = jax_dense[v]
    for out in group4:
        assert int(out[f"sub{v}_all_n_sel"]) == scene[3].shape[0]
        _close(out[f"sub{v}_all_y"], want_y)
        _close(out[f"sub{v}_all_x"], want_x)


@pytest.mark.parametrize("updated", [False, True], ids=["run6", "updated"])
def test_subgraph_sharded_forward_thin_mask_matches_jax(updated, group4, jax_dense, scene):
    """With a real pair mask each rank carries fewer stations, and the
    result is JAX's subgraph-sharded forward on a 4-device mesh (not the
    dense one: absent pairs contribute nothing)."""
    feat, mask, graph, sta_pos, _, queries, a_thin = scene
    v = int(updated)
    jm = JaxDetector(src_chunk=4, use_updated_model_definition=updated)
    params = _weights(updated)[1]
    fwd, _, sub = jax_subgraph_forward(jm, graph, sta_pos,
                                       jax_make_mesh(4, axis_names=("src",)), a_thin)
    want_y, want_x = jax.jit(fwd)(params, feat, mask, queries.x_query,
                                  queries.x_query_idx, queries.t_query)
    assert sub.n_sel < sta_pos.shape[0]
    assert float(np.abs(np.asarray(want_y) - np.asarray(jax_dense[v][0])).max()) > 1e-4
    for out in group4:
        assert int(out[f"sub{v}_thin_n_sel"]) == sub.n_sel
        _close(out[f"sub{v}_thin_y"], want_y)
        _close(out[f"sub{v}_thin_x"], want_x)


# -- data-parallel training ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_step(train_data):
    """The same step in one process: gradients, weights after Adam, metrics."""
    jcfg, jctx, _, jwb = train_data
    cfg = Config.from_dict(jcfg.to_dict())
    ctx = build_domain_context(cfg, np.asarray(jctx.sta_lla), np.asarray(jctx.sta_cart),
                               np.asarray(jctx.grids_lla), np.asarray(jctx.grids_cart),
                               np.asarray(jctx.trv_grids), "cpu")
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    wb = WindowBatch(*[torch.as_tensor(np.asarray(a)) for a in jwb])
    model = load_into(Detector(src_chunk=5), load_flax_params(RUN6))
    state = TrainState(model, make_optimizer(model, cfg), 0)
    _, metrics = make_train_step_from_batch(cfg, ctx, tt.from_cart)(state, wb)
    return ({n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            {k: v.numpy() for k, v in metrics.items()})


def test_data_parallel_step_matches_one_process(group2, one_process_step):
    grads, params, metrics = one_process_step
    scale = max(float(np.abs(g).max()) for g in grads.values())
    assert scale > 0
    for out in group2:
        for n, g in grads.items():
            err = float(np.abs(out[f"grad/{n}"] - g).max())
            assert err <= 1e-6 * scale, (n, err, scale)
            np.testing.assert_allclose(out[f"param/{n}"], params[n], atol=1e-5, err_msg=n)
        for k, v in metrics.items():
            np.testing.assert_allclose(out[f"metric/{k}"], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for n in grads:                        # Adam stepped identically on both ranks
        np.testing.assert_array_equal(group2[0][f"param/{n}"], group2[1][f"param/{n}"])


def test_data_parallel_gradients_match_jax_loss_fn(group2, train_data):
    jcfg, jctx, jtt, jwb = train_data
    params = {"params": jax.tree.map(jnp.asarray, load_flax_params(RUN6))}

    def loss(p):
        return jax_loss_fn(JaxDetector(src_chunk=5), p, jctx, jcfg, jwb, jtt.from_cart)

    (total_j, _), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = flatten_tree(jax.tree.map(np.asarray, grads_j["params"]))
    scale = max(float(np.abs(v).max()) for v in want.values())
    for out in group2:
        np.testing.assert_allclose(float(out["metric/loss"]), float(total_j), rtol=1e-4)
        got = flatten_tree(to_flax({k[len("grad/"):]: torch.from_numpy(v)
                                    for k, v in out.items() if k.startswith("grad/")}))
        assert set(got) == set(want)
        for k in want:
            err = float(np.abs(np.asarray(got[k]) - want[k]).max())
            assert err <= 1e-4 * scale, (k, err, scale)


def test_workflow_train_with_mesh_keeps_ranks_equal(group2):
    a, b = (out["train_loss"] for out in group2)
    assert a.shape == (2,) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_loss_fn_is_mean_over_local_windows(train_data):
    """What the all-reduce relies on: the one-process loss over B windows is
    the mean of the per-window losses (each window's loss_fn with B = 1)."""
    jcfg, jctx, _, jwb = train_data
    cfg = Config.from_dict(jcfg.to_dict())
    ctx = build_domain_context(cfg, np.asarray(jctx.sta_lla), np.asarray(jctx.sta_cart),
                               np.asarray(jctx.grids_lla), np.asarray(jctx.grids_cart),
                               np.asarray(jctx.trv_grids), "cpu")
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    wb = WindowBatch(*[torch.as_tensor(np.asarray(a)) for a in jwb])
    model = load_into(Detector(src_chunk=5), load_flax_params(RUN6))
    with torch.no_grad():
        total, (parts, trgts, _) = loss_fn(model, ctx, cfg, wb, tt.from_cart)
        per = [loss_fn(model, ctx, cfg, WindowBatch(*[t[i:i + 1] for t in wb]),
                       tt.from_cart) for i in range(wb.feat.shape[0])]
    np.testing.assert_allclose(float(total), np.mean([float(p[0]) for p in per]),
                               rtol=1e-6)
    np.testing.assert_allclose(trgts.numpy(), sum(p[1][1] for p in per).numpy(), rtol=1e-6)


# -- the mesh -----------------------------------------------------------------------------

def test_shard_leading_axis_takes_jax_shards():
    """Rank r's block of every leading axis that divides by the group size,
    the whole of anything else: the shard JAX's ``shard_leading_axis``
    places on device r of a 4-device mesh."""
    from genie_tpu.parallel.mesh import shard_leading_axis as jax_shard
    from genie_tpu_torch.parallel.mesh import Mesh, shard_leading_axis

    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(8, 3)).astype(np.float32),
            "odd": rng.normal(size=(6, 2)).astype(np.float32),
            "s": np.float32(2.5), "t": (np.arange(12, dtype=np.int32),)}
    jmesh = jax_make_mesh(4)
    placed = jax_shard(tree, jmesh)
    for r in range(4):
        mesh = Mesh(group=None, rank=r, size=4, ranks=(0, 1, 2, 3),
                    device=torch.device("cpu"), backend="gloo", wire="host")
        got = shard_leading_axis(tree, mesh)
        dev = jmesh.devices.reshape(-1)[r]
        for key, g, j in (("w", got["w"], placed["w"]), ("odd", got["odd"], placed["odd"]),
                          ("s", got["s"], placed["s"]), ("t", got["t"][0], placed["t"][0])):
            want = next(np.asarray(s.data) for s in j.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(g.numpy(), want, err_msg=key)


def test_make_mesh_defaults_to_the_card_and_names_its_wire(tmp_path, monkeypatch):
    import torch.distributed as dist
    from genie_tpu_torch.parallel.mesh import make_mesh, replicate

    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.wire, mesh.backend) == (0, 1, "host", "gloo")
        assert "wire host" in mesh.describe()
        tree = {"a": torch.arange(4.0)}
        assert torch.equal(replicate(tree, mesh)["a"], tree["a"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
    finally:
        dist.destroy_process_group()
