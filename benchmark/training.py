"""The training drivers' shared loop and check.

Set-up builds the trainer (the program's, with its model, optimizer and
state), loads the benchmark's weights into it, and drives it from the
seed through its first ``follow`` steps by the window's own call, on
batches whose rows all differ: the losses of those steps, the first
gradient as the optimizer holds it after one step (AdamW's first moment
over ``1 - beta1``) and each trained parameter after the last of them
are kept on the host.  They are the warm-up too.  The same trainer then
steps through the window on the host batches, cycled, with no reads of
the device in between; the window ends with the last step's completion
on the device.

The check, once the window has closed and the trainer is freed: the
fp32 reference follows the same steps from the same weights, batches,
draws and dropout seed (``benchmark/reference/train.py``).  Compared,
each against its limit:

* ``loss_gap``: the largest of ``|loss - ref| / |ref|`` over the steps;
* ``grad_gap`` and ``change_gap``: by the worst leaf, ``| |a| - |r| | /
  max(|r|, median leaf's |r|)`` of the first gradient and of the change
  of each trained parameter over the steps; both leave out the leaves
  whose reference gradient is under a thousandth of the median leaf's
  (nought to rounding: the program's reading there is its round-off, and
  Adam moves them by round-off alone).
"""

from __future__ import annotations

import time
from argparse import Namespace
from typing import Dict, List

import numpy as np
import torch

from benchmark import arith, common, generate
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

BETA1 = 0.9


class Job:
    """What differs between the two trainers: how to build the trainer,
    the batches and draws, and one step's call."""

    def __init__(self, cell, trainer_cls, views: int, labels: bool):
        self.cell = cell
        self.trainer_cls = trainer_cls
        self.views = views                # forwards per step (crops each)
        t = cell.traffic
        self.batch = int(t["batch"])
        self.hp = cell.hparams()
        self.hp["seed"] = cell.sub_seed("dropout") & 0x7FFFFFFF
        self.roi = tuple(self.hp["roi_size"])
        self.batches = generate.training_batches(
            cell.sub_seed("batches"), int(t["pool"]), self.batch, self.roi,
            common.DEVICE, labels)
        self.draw_gen = torch.Generator().manual_seed(cell.sub_seed("views"))
        patch = tuple(self.hp.get("masking_shape", (1, 1, 1)))
        self.n_patches = int(np.prod([r // p for r, p in
                                      zip(self.roi, patch)]))
        self.follow = int(t["follow"])
        self.draws: List = []      # the draws of the first steps

    def draw(self):
        if self.views == 1:
            return None
        d = generate.view_draws(self.draw_gen, self.batch, self.n_patches)
        if len(self.draws) < self.follow:
            self.draws.append(d)
        return d

    def program_step(self, trainer, step: int):
        """One ``train_step`` call; returns its loss tensor."""
        batch = self.batches[step % len(self.batches)]
        d = self.draw()
        if d is None:
            return trainer.train_step(batch)[0]
        from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
            import multi_view
        return trainer.train_step(batch, multi_view.ViewDraws(
            d["rot_i"], d["rot_j"], d["rank_i"], d["rank_j"], 0))["tot"]


def first_moment(optimizer, p) -> torch.Tensor:
    """AdamW's first moment of ``p`` (zeros where it never stepped)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return torch.zeros(p.shape) if m is None else \
        m.detach().float().cpu().clone()


def _names(trainer) -> Dict[int, str]:
    return {id(p): n for n, p in trainer.model.named_parameters()}


def build(job: Job, wseed: int):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    trainer = job.trainer_cls(Namespace(**job.hp), SwinUnetR, None, None,
                              device=common.DEVICE)
    trainer.model.load_state_dict(generate.weights(
        ref_model.SwinUnetR(ref_model.model_keys(job.hp)), wseed,
        common.DEVICE))
    trainer.prepare_fit()
    return trainer


def run(job: Job) -> common.Outcome:
    cell = job.cell
    t = cell.traffic
    follow = job.follow
    if len(job.batches) < follow:
        raise ValueError("the first steps need distinct batches")
    wseed = cell.sub_seed("weights")
    trainer = build(job, wseed)
    names = _names(trainer)
    trained = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    seen = {"loss": [], "grad": None, "after": None}
    for step in range(follow):
        seen["loss"].append(float(job.program_step(trainer, step)))
        if step == 0:
            seen["grad"] = {names[id(p)]: first_moment(trainer.optimizer, p)
                            / (1 - BETA1) for p in trained}
    seen["after"] = {names[id(p)]: p.detach().float().cpu().clone()
                     for p in trained}
    common.sync()
    setup_end = time.perf_counter()
    step, ctx, metrics = follow, None, {}
    crops = job.batch
    if cell.trace:
        def units(n, _events):
            nonlocal step
            for _ in range(n):
                if _events is not None:
                    _events.mark("step")
                job.program_step(trainer, step)
                step += 1

        events = common.ForwardEvents(trainer.model, trainer.optimizer)
        ctx = common.traced(units, int(t["trace_units"]),
                            int(t["label_units"]), events)
        steps = events.units("step")
        ctx["forward_ms"] = [common.ForwardEvents.forward_ms(u)
                             for u in steps]
        ctx["backward_ms"] = [common.ForwardEvents.backward_ms(u)
                              for u in steps]
        ctx["per_unit"] = "step"
        batch = crops * job.views
        ctx["model_flops_per_unit"] = arith.step_flops(job.hp, batch, job.roi)
        ctx["b1_work_per_unit"] = arith.b1_work(job.hp, batch, job.roi)
        ctx["b4_work_per_unit"] = arith.b4_work(job.hp, batch, job.roi)
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < cell.seconds:
            job.program_step(trainer, step)
            step += 1
        common.sync()
        span = time.perf_counter() - t_start
        metrics["train_samples_per_s"] = (step - follow) * crops / span
    peak = common.memory_peak()
    del trainer, trained, names
    common.free_memory()
    checks, detail = check(job, wseed, seen)
    limits = t["limits"]
    return common.Outcome(
        metrics, {k: (v, limits[k]) for k, v in checks.items()},
        step - follow, 0, peak, setup_end, ctx, detail)


def follow_reference(job: Job, wseed: int, arith_mode: str) -> dict:
    cell = job.cell
    follow = job.follow
    state = generate.weights(ref_model.SwinUnetR(ref_model.model_keys(
        job.hp)), wseed, common.DEVICE)
    with ref_model.strict_fp32():
        return ref_train.follow_steps(
            job.hp, state, job.batches[:follow],
            job.draws[:follow] if job.draws else [None] * follow,
            common.DEVICE, ref_model.Arith(arith_mode), job.hp["seed"])


def leaf_gaps(seen: dict, ref: dict, start: Dict[str, torch.Tensor]):
    """Per trained leaf that the reference moves: ``(grad gap, change
    gap, |r| of the first gradient)``.  Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out: their
    gradient is nought to rounding (a conv bias before a batch-statistics
    BatchNorm or an instance norm), and Adam moves them by round-off
    alone."""
    rg = {n: float(g.norm()) for n, g in ref["grad"].items()}
    rc = {n: float(c.norm()) for n, c in ref["change"].items()}
    med_g = float(np.median(list(rg.values())))
    moving = [n for n in rg if rg[n] >= 1e-3 * med_g]
    med_c = float(np.median([rc[n] for n in moving]))
    out = {}
    for n in moving:
        a = float(seen["grad"][n].norm()) if n in seen["grad"] else np.inf
        g = abs(a - rg[n]) / max(rg[n], med_g, 1e-30)
        after = seen["after"].get(n)
        a = float((after - start[n]).norm()) if after is not None else np.inf
        out[n] = (g, abs(a - rc[n]) / max(rc[n], med_c, 1e-30), rg[n])
    return out


def gaps(seen: dict, ref: dict, start: Dict[str, torch.Tensor]) -> dict:
    """The three compared numbers of a run's readings ``seen`` (``loss``,
    ``grad``, ``after``) against the reference's."""
    loss = max(abs(a - r) / max(abs(r), 1e-12)
               for a, r in zip(seen["loss"], ref["loss"]))
    if len(seen["loss"]) != len(ref["loss"]) or not np.all(
            np.isfinite(seen["loss"])):
        loss = float("inf")
    leaves = leaf_gaps(seen, ref, start)
    return {"loss_gap": loss,
            "grad_gap": max(g for g, _, _ in leaves.values()),
            "change_gap": max(c for _, c, _ in leaves.values())}


def worst_leaves(seen: dict, ref: dict, start, k: int = 4) -> dict:
    """The ``k`` leaves with the widest gaps, for the look at a reading."""
    leaves = leaf_gaps(seen, ref, start)
    top = lambda i: [[n, v[i], v[2]] for n, v in sorted(  # noqa: E731
        leaves.items(), key=lambda kv: -kv[1][i])[:k]]
    return {"grad": top(0), "change": top(1)}


def start_state(job: Job, wseed: int) -> Dict[str, torch.Tensor]:
    state = generate.weights(ref_model.SwinUnetR(ref_model.model_keys(
        job.hp)), wseed, common.DEVICE)
    return {n: t.float().cpu() for n, t in state.items()}


def check(job: Job, wseed: int, seen: dict):
    """(compared numbers, worst leaves) of ``seen``."""
    ref = follow_reference(job, wseed, "fp32")
    start = start_state(job, wseed)
    return gaps(seen, ref, start), worst_leaves(seen, ref, start)


def control(job: Job) -> dict:
    """The compared numbers of the reference in fp8 put in the program's
    place."""
    for _ in range(job.follow):
        job.draw()
    wseed = job.cell.sub_seed("weights")
    low = follow_reference(job, wseed, "fp8")
    start = start_state(job, wseed)
    seen = {"loss": low["loss"], "grad": low["grad"],
            "after": {n: start[n] + c for n, c in low["change"].items()}}
    return check(job, wseed, seen)[0]
