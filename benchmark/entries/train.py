"""The entry ``train``: one optimizer step of the program's detector
training per request, as ``scripts/nc_train.py --trv pinn --restart`` trains
run6, through ``genie_tpu_torch.train.trainer.make_train_step``.

Set-up: the configuration's stations (``run.make_inputs``), the program's
``Config`` from the configuration with the mix's ``synth`` and ``train``
groups laid over it, grid travel-time tables from the uncorrected PINN
(``compute_travel_times_chunked``), ``build_domain_context``, the
``Detector`` restarted from the configuration's weights file with the Adam
state in it (``workflow.restart_from``), and ``make_train_step``, which
generates each batch on the card. Step ``i`` draws its batch from a
generator on the device seeded ``step_seed(seed, i)``. Set-up takes the
first ``check_steps`` steps (the first is the warm-up); the window's
requests are the next steps of the same state, one a request, back to
back.

The check follows those first steps. While set-up takes them, the
benchmark keeps each step's timeline (wrapping the trainer's
``synthesize_timeline``) and batch (wrapping its ``generate_batch``), the
loss the step returns, the Adam first moments before and after the first
step, and the parameters before the first step and after the last. After
the window the plain reference (``benchmark/reference/train.py``) cuts the
windows again from each timeline and the batch's own draws (window times,
grids, station subsets, query points), loads the weights and the Adam
state from the file itself, and takes the same steps:

* ``batch_gap``: the largest |difference| between the program's windows
  and the reference's (features, their mask, pick times and phases, the
  three label sets); infinite where an integer field (picks, stations,
  station graphs) differs, where a pad differs from the configuration's,
  where a label is not finite or outside [0, 1], or where the checked
  batches' mean count of real picks (picks of an event) or of labelled
  events lies outside the limits file's ``batch_band``. The reference cuts
  its windows from the program's timelines, so the band is what checks
  the timelines themselves: it catches a generator that makes no events or
  no picks of them, or floods the windows, and no subtler fault;
* ``loss_gap``: the largest relative difference of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it,
  ``(m1 − β1·m0)/(1 − β1)`` from the program's Adam state, against the
  reference's gradient, worst leaf: |‖g‖ − ‖g_ref‖| over the larger of
  ‖g_ref‖ and the median leaf's;
* ``update_gap``: the parameters' change over the steps, worst leaf, the
  same measure, leaving out leaves whose reference gradient (largest over
  the steps) is under a thousandth of the median leaf's, which Adam moves
  by round-off.
"""

from __future__ import annotations

import math
import sys
from types import SimpleNamespace

import numpy as np
import torch

STAGES = ("generate", "forward_backward", "optimizer")
FLOAT_FIELDS = ("feat", "mask", "tpick", "phase", "lbl_grid", "lbl_query", "lbl_assoc")
EXACT_FIELDS = ("ipick", "pick_mask", "sta_nbr", "sta_nbr_valid")


class Record:
    """One timed step."""

    def __init__(self, step: int):
        self.step = step
        self.loss = None
        self.stage_seconds = {}
        self.t_start = self.t_done = 0.0
        self.error = None


def _clone(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


class Entry:
    ranges = STAGES
    labels = STAGES

    def __init__(self, setting):
        from benchmark.harness.system import program_config
        from genie_tpu_torch.models.detector import Detector
        from genie_tpu_torch.params import load_pinn
        from genie_tpu_torch.train import trainer
        from genie_tpu_torch.utils import compute_travel_times_chunked
        from genie_tpu_torch.workflow import restart_from

        spec, mix, opt = setting.spec, setting.mix, setting.options
        dev = self.device = setting.device
        self.root, self.seed, self.mix = setting.root, setting.seed, mix
        self.spec = {**spec, "synth": dict(mix["synth"]),
                     "train": {**spec["train"], **mix["train"]}}
        self.inputs = setting.make_inputs(spec, opt.get("n_sta"))
        cfg = program_config(spec)
        for group in ("synth", "train"):
            sect = getattr(cfg, group)
            for k, v in mix[group].items():
                if not hasattr(sect, k):
                    raise KeyError(f"{group}.{k} is not a setting of the program")
                setattr(sect, k, tuple(v) if isinstance(v, list) else v)
        self.cfg = cfg
        setting.mark("inputs")
        inp = self.inputs
        self.pinn = load_pinn(inp.root / spec["pinn"], device=dev)
        sta = torch.as_tensor(inp.sta_cart, device=dev)
        with torch.no_grad():
            trv_grids = torch.stack([
                compute_travel_times_chunked(self.pinn.from_cart, sta, g)
                for g in torch.as_tensor(inp.grids_cart, device=dev)])
        ctx = trainer.build_domain_context(cfg, inp.sta_lla, inp.sta_cart, inp.grids_lla,
                                           inp.grids_cart, trv_grids, dev)
        m = cfg.model
        model = Detector(scale_rel=m.scale_rel, kernel_sig_t=m.kernel_sig_t,
                         use_phase_types=m.use_phase_types,
                         use_absolute_pos=m.use_absolute_pos,
                         use_updated_model_definition=m.use_updated_model_definition,
                         normalize_readin=m.normalize_readin).to(dev)
        state = trainer.TrainState(model, trainer.make_optimizer(model, cfg), 0)
        self.state = restart_from(inp.root / spec["weights"], state)
        self.start_step = self.state.step
        self._patched = []
        self.program = SimpleNamespace(trainer=trainer, cfg=cfg, ctx=ctx,
                                       state=self.state, patch=self._patch)
        if opt.get("plant") is not None:
            opt["plant"](self.program)
        self.trainer = trainer
        self.train_step = trainer.make_train_step(cfg, ctx, self.pinn.from_cart)
        self.gen = torch.Generator(device=dev)
        self.n_check = int(mix["check_steps"])
        self.band = opt.get("batch_band", setting.limits["batch_band"])
        setting.mark("program set-up")

    def _patch(self, obj, name: str, value):
        """Set ``obj.name`` until the release."""
        self._patched.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def _unpatch(self, down_to: int = 0):
        while len(self._patched) > down_to:
            obj, name, old = self._patched.pop()
            setattr(obj, name, old)

    def _step(self, i: int):
        from genie_tpu_torch.train.trainer import step_seed

        self.gen.manual_seed(step_seed(self.seed, i))
        self.state, metrics = self.train_step(self.state, self.gen)
        return float(metrics["loss"])

    def _moments(self) -> dict:
        opt = self.state.optimizer
        return {n: opt.state[p]["exp_avg"].detach().clone()
                for n, p in self.state.model.named_parameters()}

    def warm_up(self):
        """The checked steps, the program's timelines and batches kept."""
        tr = self.trainer
        timeline, generate = tr.synthesize_timeline, tr.generate_batch
        kept = self.kept = []

        def synthesize_timeline(*a, **k):
            tl = timeline(*a, **k)
            kept.append({"timeline": tl})
            return tl

        def generate_batch(*a, **k):
            wb = generate(*a, **k)
            kept[-1]["batch"] = wb
            return wb

        mark = len(self._patched)
        self._patch(tr, "synthesize_timeline", synthesize_timeline)
        self._patch(tr, "generate_batch", generate_batch)
        model = self.state.model
        self.theta0 = _clone(dict(model.named_parameters()))
        self.m0 = self._moments()
        self.losses = []
        try:
            for i in range(self.n_check):
                self.losses.append(self._step(self.start_step + i))
                if i == 0:
                    self.m1 = self._moments()
        finally:
            self._unpatch(mark)
        self.theta_n = _clone(dict(model.named_parameters()))

    def begin(self, i: int) -> Record:
        return Record(self.start_step + self.n_check + i)

    def request(self, rec: Record):
        rec.loss = self._step(rec.step)
        rec.stage_seconds = dict(self.train_step.stage_seconds)
        if not math.isfinite(rec.loss):
            rec.error = "loss not finite"

    def end(self, rec: Record) -> str:
        return (f"step {rec.step}: {rec.t_done - rec.t_start:.4f} s, loss {rec.loss}, "
                f"stages { {k: round(v, 4) for k, v in rec.stage_seconds.items()} }"
                f"{'' if rec.error is None else ', ' + rec.error}")

    def release(self):
        self._unpatch()
        del self.state, self.train_step, self.program
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def _batch_gap(self, wb, tl, win: dict) -> float:
        tr, graph = self.spec["train"], self.spec["graph"]
        n_sta = self.inputs.sta_cart.shape[0]
        pads = {"feat": (tr["n_batch"], self.inputs.grids_cart.shape[1], n_sta, 4),
                "tpick": (tr["n_batch"], graph["max_picks"]),
                "x_query": (tr["n_batch"], tr["n_spc_query"], 3),
                "x_qsrc": (tr["n_batch"], tr["n_src_query"], 3)}
        if any(tuple(getattr(wb, k).shape) != v for k, v in pads.items()) or \
                tl.ev_pos_cart.shape[0] != self.spec["synth"]["max_events"]:
            return math.inf
        for k in ("lbl_grid", "lbl_query", "lbl_assoc"):
            lbl = getattr(wb, k)
            if not (torch.isfinite(lbl).all() and lbl.min() >= 0 and lbl.max() <= 1):
                return math.inf
        for k in EXACT_FIELDS:
            got, want = getattr(wb, k), win[k]
            if got.shape != want.shape or not torch.equal(got.to(want.dtype), want):
                return math.inf
        gap = 0.0
        for k in FLOAT_FIELDS:
            got, want = getattr(wb, k), win[k]
            if got.shape != want.shape:
                return math.inf
            gap = max(gap, float((got.double() - want.double()).abs().max()))
        return gap

    def check(self, records) -> dict:
        from benchmark.reference import train as rtrain
        from benchmark.reference.domain import PINNTravelTimes
        from benchmark.reference.pipeline import make_detector

        inp, dev = self.inputs, self.device
        pinn = PINNTravelTimes(inp.root / self.spec["pinn"], dev)
        ref = rtrain.make_trainer(self.spec, self.root, inp.sta_lla, inp.sta_cart,
                                  inp.grids_lla, inp.grids_cart, pinn,
                                  make_detector(self.spec), dev)
        sta = ref.dom.sta_cart
        grads, batch_gap, ref_losses, counts = [], 0.0, [], []
        for kept in self.kept:
            wb, tl = kept["batch"], kept["timeline"]
            draws = {k: getattr(wb, k) for k in ("t_sample", "grid_idx", "sta_mask",
                                                 "x_query", "x_qsrc", "tq_sample")}
            win = rtrain.windows(self.spec, tl._asdict(), draws, sta, ref.dom.grids_cart,
                                 ref.dom.trv_grids)
            batch_gap = max(batch_gap, self._batch_gap(wb, tl, win))
            counts.append((win["real_picks"], win["active"]))
            loss, g = ref.gradient(win)
            ref.adam(g)
            ref_losses.append(loss)
            grads.append(g)
        for i, what in enumerate(("real_picks", "labelled_events")):
            lo, hi = self.band[what]
            if not lo <= float(np.mean([c[i] for c in counts])) <= hi:
                batch_gap = math.inf
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.losses, ref_losses))
        g_prog = {n: (self.m1[n] - 0.9 * self.m0[n]) / 0.1 for n in self.m0}
        grad_gap, grad_leaf = rtrain.leaf_gap(g_prog, grads[0])
        g_max = {n: max(float(torch.linalg.vector_norm(g[n])) for g in grads)
                 for n in grads[0]}
        floor = 1e-3 * float(np.median(list(g_max.values())))
        moved = {n for n, v in g_max.items() if v >= floor}
        d_prog = {n: self.theta_n[n] - self.theta0[n] for n in self.theta0}
        d_ref = {n: ref.params[n].detach() - ref.theta0[n] for n in ref.theta0}
        update_gap, update_leaf = rtrain.leaf_gap(d_prog, d_ref, moved)
        print(f"check train: losses {self.losses} vs {ref_losses}; worst gradient leaf "
              f"{grad_leaf}, worst change leaf {update_leaf}; {len(moved)} of "
              f"{len(g_max)} leaves moved by their gradient; real picks and labelled "
              f"events per batch {counts}", file=sys.stderr)
        return {"batch_gap": batch_gap, "loss_gap": loss_gap, "grad_gap": grad_gap,
                "update_gap": update_gap}

    def fields(self) -> dict:
        tr, g, m = self.spec["train"], self.spec["graph"], self.spec["model"]
        return dict(n_batch=tr["n_batch"], n_sta=int(self.inputs.sta_cart.shape[0]),
                    n_src=int(self.inputs.grids_cart.shape[1]),
                    n_spc_query=tr["n_spc_query"], n_src_query=tr["n_src_query"],
                    max_picks=g["max_picks"], graph=g, model=m)
