"""A run of a cell on the CPU at a small size, for the tests: 40 stations,
400 query nodes, 120 s chunks, 2,048 refinement offsets and thresholds low
enough that untrained-for geometry still yields candidates, events and
magnitudes (at 40 stations run6's detector scores below its own 0.35)."""

import argparse

import torch

SMALL = dict(n_sta=40, n_query=400,
             overrides={"process": {"n_rand_query": 2048, "refine_chunk": 1024,
                                    "thresh": 0.05, "thresh_assoc": 0.02,
                                    "min_required_picks": 4, "min_required_sta": 2},
                        "chunk_s": 120.0})
SEED = 2  # a draw in which every stage has work at this size: 2 events associated, 1 located


def run_small(workload: str, seed: int = SEED, plant=None, precision: str = "f32",
              seconds: float = 0.5, trace: int = 0) -> dict:
    from benchmark import run

    torch.set_num_threads(4)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                              precision=precision)
    return run.run_cell(args, dev="cpu", plant=plant, **SMALL)


# the training cell: 40 stations, 2 windows of 128 picks, 200 + 16 queries,
# a 600 s timeline of at most 16 events and 256 false picks, and a band of
# batch counts for that size (the limits file's is the cell's)
TRAIN_SMALL = dict(n_sta=40, overrides={"graph": {"max_picks": 128}},
                   batch_band={"real_picks": [1, 256], "labelled_events": [1, 32]},
                   mix_overrides={"synth": {"T": 600.0, "max_events": 16,
                                            "n_false_max": 256},
                                  "train": {"n_batch": 2, "n_spc_query": 200,
                                            "n_src_query": 16}})
TRAIN_SEED = 7


def run_small_train(seed: int = TRAIN_SEED, plant=None, precision: str = "f32",
                    seconds: float = 0.5, trace: int = 0) -> dict:
    from benchmark import run

    torch.set_num_threads(4)
    args = argparse.Namespace(workload="nc_run6.train", seed=seed, seconds=seconds,
                              trace=trace, precision=precision)
    return run.run_cell(args, dev="cpu", plant=plant, **TRAIN_SMALL)
