"""The frozen plain reference against the program's plain CPU path, on a
small domain at this commit. This file alone imports both: it guards the
yardstick against a wrong reference."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import run
from benchmark.harness import check, system
from benchmark.tests.cpu_cell import run_small, run_small_train

BENCH = Path(__file__).resolve().parents[1]


def test_tables_equal_the_programs():
    """Grid travel times, station graph, time pointers, source graph and
    edge features: the reference's equal the program's set-up."""
    spec = json.loads((BENCH / "configs" / "nc_run6.json").read_text())
    inputs = run.make_inputs(spec, n_sta=40, n_query=200)
    dev = torch.device("cpu")
    pipe = system.build_system(spec, inputs, dev)
    ref = check.ReferenceTools(spec, inputs, dev).pipeline()
    ctx = pipe.ctx
    np.testing.assert_array_equal(ref.dom.trv_grids.numpy(), ctx.trv_grids.numpy())
    np.testing.assert_array_equal(ref.dom.time_ptr_p.numpy(), ctx.time_ptr_p.numpy())
    np.testing.assert_array_equal(ref.dom.time_ptr_s.numpy(), ctx.time_ptr_s.numpy())
    np.testing.assert_array_equal(ref.dom.src_nbr.numpy(), ctx.src_nbr.numpy())
    np.testing.assert_array_equal(ref.dom.edge_feat.numpy(), ctx.edge_feat.numpy())
    np.testing.assert_array_equal(ref.graphs[0].sta_nbr.numpy(), pipe.sta_nbr.numpy())
    np.testing.assert_array_equal(ref.xq_idx[2].numpy(), pipe._xq_idx[2].numpy())
    assert ref.dom.dt0 == ctx.dt0 and ref.max_t == pipe._max_t


def test_every_stage_equals_the_programs_plain_path():
    """A run of the swarm cell on the CPU, where the program runs its plain
    round: the detector's outputs agree to float32 rounding (the CPU's
    threaded reductions need not sum in one order), the candidates and the
    pick assignment exactly, and the program's float32 location and
    magnitudes are near the float64 reference's, with every stage at work.
    At 40 stations the location objective's minimum is shallower than at
    374, and one event's float32 DE stops 3.2e-5 s above the float64 one's,
    over the cell's limit, so location is held here to 1e-4 s."""
    res = run_small("nc_run6.swarm")
    got = {k: v["value"] for k, v in res["checked"].items()}
    assert set(got) == set(check.NUMBERS)
    assert res["failed"] == 0
    assert max(got["sweep_gap"], got["refine_gap"], got["assoc_gap"]) <= 1e-6, got
    assert got["cand_gap"] == got["assign_gap"] == 0.0, got
    assert abs(got["locate_cost_gap_s"]) <= 1e-4 and got["mag_gap"] <= 1e-5, got


def test_updated_definition_sweep_equals_the_programs():
    """The updated definition's scores reach ~10 under the benchmark's
    weights, so float32 rounding of a different reduction order is ~1e-6."""
    res = run_small("nc_run6_updated.sweep")
    assert res["correct"] and res["checked"]["sweep_gap"]["value"] <= 1e-5


def test_training_steps_equal_the_programs_plain_path():
    """A run of the training cell on the CPU: the reference cuts the same
    windows bit for bit, and its losses, first gradient and change over
    three Adam steps agree with the program's plain path to float32
    rounding."""
    res = run_small_train()
    got = {k: v["value"] for k, v in res["checked"].items()}
    assert set(got) == {"batch_gap", "loss_gap", "grad_gap", "update_gap"}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert got["batch_gap"] == 0.0, got
    assert got["loss_gap"] <= 1e-6 and got["grad_gap"] <= 1e-5, got
    assert got["update_gap"] <= 1e-4, got


def test_training_gradient_equals_the_programs_leaf_by_leaf():
    """One step at run6's weights: every leaf of the reference's gradient
    against the program's plain CPU gradient, by the norm of their
    difference (the check compares norms only), and the loss."""
    import copy
    import types

    from benchmark.reference import train as rtrain
    from benchmark.reference.domain import PINNTravelTimes
    from benchmark.reference.pipeline import make_detector
    from benchmark.tests.cpu_cell import TRAIN_SMALL, TRAIN_SEED

    torch.set_num_threads(4)
    spec = run._overlay(json.loads((BENCH / "configs" / "nc_run6.json").read_text()),
                        TRAIN_SMALL["overrides"])
    mix = run._overlay(json.loads((BENCH / "traffic" / "train.json").read_text()),
                       copy.deepcopy(TRAIN_SMALL["mix_overrides"]))
    mix["check_steps"] = 1
    dev = torch.device("cpu")
    limits = json.loads((BENCH / "limits" / "nc_run6.train.json").read_text())
    setting = types.SimpleNamespace(root=run.ROOT, spec=spec, mix=mix, limits=limits,
                                    seed=TRAIN_SEED, device=dev, mark=lambda name: None,
                                    make_inputs=run.make_inputs, options={"n_sta": 40})
    ent = run.load_entry("train")(setting)
    ent.warm_up()
    got = {n: p.grad.detach().clone() for n, p in ent.state.model.named_parameters()}
    inp = ent.inputs
    ref = rtrain.make_trainer(ent.spec, run.ROOT, inp.sta_lla, inp.sta_cart, inp.grids_lla,
                              inp.grids_cart, PINNTravelTimes(run.ROOT / spec["pinn"], dev),
                              make_detector(spec), dev)
    wb, tl = ent.kept[0]["batch"], ent.kept[0]["timeline"]
    draws = {k: getattr(wb, k) for k in ("t_sample", "grid_idx", "sta_mask", "x_query",
                                         "x_qsrc", "tq_sample")}
    win = rtrain.windows(ent.spec, tl._asdict(), draws, ref.dom.sta_cart,
                         ref.dom.grids_cart, ref.dom.trv_grids)
    loss, want = ref.gradient(win)
    ent.release()
    assert abs(ent.losses[0] - loss) <= 1e-6 * abs(loss)
    assert set(got) == set(want) and len(want) == 151
    norms = {n: float(want[n].norm()) for n in want}
    med = float(np.median(list(norms.values())))
    for n in want:
        assert float((got[n] - want[n]).norm()) <= 1e-5 * max(norms[n], med), n
