"""The frozen plain reference against the program's plain CPU path, on a
small domain at this commit. This file alone imports both: it guards the
yardstick against a wrong reference."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import run
from benchmark.harness import check, system
from benchmark.tests.cpu_cell import run_small

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
