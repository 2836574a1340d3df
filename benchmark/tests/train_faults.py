"""Faults planted in the program's training step, below the benchmark's
wrappers, each called with the entry's program (``patch`` sets a module
or object attribute until the run's release):

* ``optimizer_skipped``: the step returns its state unchanged;
* ``half_the_batch``: the loss takes the first half of the windows, the
  mean over them;
* ``one_backward_skipped``: the first window of each step adds no
  gradient (its loss is counted);
* ``half_the_picks``: the generator's batch loses every other real pick;
* ``events_dropped``: the generator's timeline loses every pick of an
  event, so its windows hold false picks only and label nothing (the
  reference cuts the same windows from it: only the band of batch counts
  sees this).
"""

import torch


def optimizer_skipped(prog):
    prog.patch(prog.state.optimizer, "step", lambda *a, **k: None)


def half_the_batch(prog):
    tr = prog.trainer
    loss_fn = tr.loss_fn

    def half(model, ctx, cfg, wb, *a, **k):
        n = wb.feat.shape[0] // 2
        return loss_fn(model, ctx, cfg, type(wb)(*[t[:n] for t in wb]), *a, **k)
    prog.patch(tr, "loss_fn", half)


def one_backward_skipped(prog):
    tr = prog.trainer
    window_loss = tr._window_loss
    seen = {"n": 0}

    def skipped(model, ctx, cfg, wb_i, *a, **k):
        losses, trgts, preds, l_sens = window_loss(model, ctx, cfg, wb_i, *a, **k)
        if seen["n"] % cfg.train.n_batch == 0:
            losses = losses.detach() + 0.0 * losses
        seen["n"] += 1
        return losses, trgts, preds, l_sens
    prog.patch(tr, "_window_loss", skipped)


def half_the_picks(prog):
    tr = prog.trainer
    generate = tr.generate_batch

    def dropped(*a, **k):
        wb = generate(*a, **k)
        keep = torch.arange(wb.pick_mask.shape[1], device=wb.pick_mask.device) % 2 == 0
        return wb._replace(pick_mask=wb.pick_mask & keep)
    prog.patch(tr, "generate_batch", dropped)


def events_dropped(prog):
    tr = prog.trainer
    synthesize = tr.synthesize_timeline

    def no_events(*a, **k):
        tl = synthesize(*a, **k)
        return tl._replace(pick_mask=tl.pick_mask & (tl.pick_event < 0))
    prog.patch(tr, "synthesize_timeline", no_events)


FAULTS = {"optimizer_skipped": optimizer_skipped, "half_the_batch": half_the_batch,
          "one_backward_skipped": one_backward_skipped, "half_the_picks": half_the_picks,
          "events_dropped": events_dropped}
