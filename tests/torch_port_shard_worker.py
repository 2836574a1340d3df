"""One rank of the gloo groups that ``tests/test_torch_port_shard.py`` spawns
on the CPU. It imports torch and the port only, never JAX.

    python tests/torch_port_shard_worker.py DIR RANK WORLD PORT

reads ``DIR/plan.json`` (the cases to run) and ``DIR/inputs.npz``, runs each
case on a ``Mesh`` of the group and writes ``DIR/out_RANK.npz``."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from genie_tpu_torch.models.detector import Detector, GraphBundle  # noqa: E402
from genie_tpu_torch.parallel.mesh import all_gather_cat, make_mesh  # noqa: E402
from genie_tpu_torch.parallel.product_shard import (  # noqa: E402
    build_partition, build_station_subselection, sharded_gather_mean_src_axis_subsel,
    sharded_src_aggregation)
from genie_tpu_torch.parallel.sharded_detector import (  # noqa: E402
    make_sharded_detection_forward, make_subgraph_sharded_detection_forward)

GRAPH_FIELDS = GraphBundle._fields


def case_agg(inp, mesh, out):
    """``sharded_src_aggregation`` of the original-frame tensor, f32 and bf16
    wire, back in the original frame."""
    part = build_partition(inp["agg_src_pos"], inp["agg_src_nbr"], mesh.size)
    x = torch.from_numpy(inp["agg_feat"])[part.perm.long()]
    x_local = x[mesh.rank * part.n_local:(mesh.rank + 1) * part.n_local]
    inv = part.inv_perm.long()
    out["agg"] = sharded_src_aggregation(x_local, part, mesh)[inv].numpy()
    out["agg_bf16"] = sharded_src_aggregation(x_local, part, mesh,
                                              wire_dtype=torch.bfloat16)[inv].numpy()
    out["agg_halo_rows_valid"] = np.asarray(part.halo_rows_valid)


def case_subsel(inp, mesh, out):
    """``sharded_gather_mean_src_axis_subsel`` of sorted-frame rows,
    all-gathered."""
    part = build_partition(inp["ss_src_pos"], inp["ss_src_nbr"], mesh.size)
    sub = build_station_subselection(inp["ss_a"], part, inp["ss_sta_nbr"],
                                     inp["ss_sta_valid"])
    x = torch.from_numpy(inp["ss_x"])
    x_local = x[mesh.rank * part.n_local:(mesh.rank + 1) * part.n_local]
    got = sharded_gather_mean_src_axis_subsel(x_local, part, sub.col_map[mesh.rank],
                                              mesh)
    out["subsel"] = all_gather_cat(got, mesh, dim=0).numpy()


def _scene(inp):
    graph = GraphBundle(*[torch.from_numpy(np.asarray(inp[f"sc_{f}"]))
                          for f in GRAPH_FIELDS])
    return (graph, torch.from_numpy(inp["sc_sta_pos"]),
            torch.from_numpy(inp["sc_feat"])[None], torch.from_numpy(inp["sc_mask"])[None],
            torch.from_numpy(inp["sc_x_query"]), torch.from_numpy(inp["sc_x_query_idx"]),
            torch.from_numpy(inp["sc_t_query"]))


def case_forward(inp, mesh, out, d: Path):
    """Both sharded forwards, both model variants, on the tiny scene with
    weights the test wrote; the subgraph form with an all-True and with a
    thin pair mask."""
    graph, sta_pos, feat, mask, xq, xq_idx, tq = _scene(inp)
    for v in (0, 1):
        model = Detector(src_chunk=4, use_updated_model_definition=bool(v))
        model.load_state_dict(torch.load(d / f"detector_{v}.pt"))
        model.eval()
        fwd, _ = make_sharded_detection_forward(model, graph, sta_pos, mesh)
        out[f"fwd{v}_y"], out[f"fwd{v}_x"] = (t[0].numpy() for t in
                                              fwd(feat, mask, xq, xq_idx, tq))
        for tag, a in (("all", np.ones(inp["sc_thin"].shape, bool)),
                       ("thin", inp["sc_thin"])):
            fwd, _, sub = make_subgraph_sharded_detection_forward(
                model, graph, sta_pos, mesh, a)
            out[f"sub{v}_{tag}_y"], out[f"sub{v}_{tag}_x"] = (
                t[0].numpy() for t in fwd(feat, mask, xq, xq_idx, tq))
            out[f"sub{v}_{tag}_n_sel"] = np.asarray(sub.n_sel)


def case_train(inp, mesh, out, d: Path):
    """One data-parallel step of ``make_train_step_from_batch`` from run6's
    weights on the test's batch, then two steps of ``workflow.train``."""
    from genie_tpu_torch.config import Config
    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
    from genie_tpu_torch.params import load_flax_params, load_into
    from genie_tpu_torch.synth.generator import WindowBatch
    from genie_tpu_torch.train.trainer import (TrainState, build_domain_context,
                                               make_optimizer, make_train_step_from_batch)
    from genie_tpu_torch.workflow import train

    cfg = Config.from_dict(json.loads((d / "cfg.json").read_text()))
    ctx = build_domain_context(cfg, inp["tr_sta_lla"], inp["tr_sta_cart"],
                               inp["tr_grids_lla"], inp["tr_grids_cart"],
                               inp["tr_trv_grids"], "cpu")
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    wb = WindowBatch(*[torch.from_numpy(inp[f"wb_{f}"]) for f in WindowBatch._fields])
    tree = load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl")
    model = load_into(Detector(src_chunk=5), tree)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    step = make_train_step_from_batch(cfg, ctx, tt.from_cart, mesh=mesh)
    state, metrics = step(state, wb)
    for name, p in model.named_parameters():
        out[f"grad/{name}"] = p.grad.numpy()
        out[f"param/{name}"] = p.detach().numpy()
    for k, v in metrics.items():
        out[f"metric/{k}"] = v.numpy()
    _, _, hist = train(cfg, ctx, tt, d / "train", n_steps=2, log_every=1, mesh=mesh)
    out["train_loss"] = np.asarray([m["loss"] for m, _ in hist])


def main():
    d, rank, world, port = Path(sys.argv[1]), *map(int, sys.argv[2:5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device="cpu")
        inp = dict(np.load(d / "inputs.npz"))
        out = {"wire": np.asarray(mesh.wire)}
        for case in json.loads((d / "plan.json").read_text())["cases"]:
            if case == "agg":
                case_agg(inp, mesh, out)
            elif case == "subsel":
                case_subsel(inp, mesh, out)
            elif case == "forward":
                case_forward(inp, mesh, out, d)
            elif case == "train":
                case_train(inp, mesh, out, d)
            else:
                raise ValueError(f"unknown case {case!r}")
        np.savez(d / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
