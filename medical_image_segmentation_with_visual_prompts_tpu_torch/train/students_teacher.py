"""Phase-2 students-teacher trainer: clustered-prototype distillation.

Counterpart of the JAX package's ``train/students_teacher.py``
(``StudentsTeacherTrainer``), for the modes
``{self_,}supervised_learning_{decoder,all}``:

* a student and a teacher ``SwinUnetR``; the teacher has its own
  initialization and dropout seeds (the JAX trainer's second init key)
  and no gradient;
* each training step first moves the teacher's parameters toward the
  student's, ``tau * teacher + (1 - tau) * student`` (not its BatchNorm
  statistics; ``train/common.py::ema_update``), then runs the students
  (one forward per ``crop_size_students`` crop, in order, each updating
  the student's BatchNorm statistics) and the teacher (train mode,
  without grad: dropout on, its own statistics updated);
* losses: ``prt``, the clustered-prototype loss on the decoder outputs
  and coordinate grids with the teacher's detached, each student's
  jitter drawn from :attr:`jitter_generator`; ``seg``, in the supervised
  modes with ``use_real_label``, the Dice loss of student 0's
  ``seg_pred`` on its mask remapped to ``active_labels_pretrain``;
  ``tot``, their sum.  MeanIoU over ``output_channels_pretrain``;
* AdamW in two groups, ``base`` (``lr_students_teacher``,
  ``weight_decay_students_teacher``) and ``prompt`` (the prompt tokens
  and their positional-bias parameters: ``lr_prompt_tokens``,
  ``weight_decay_prompt_tokens``), over the mode's trainable set
  (``models/partition.py::trainable_labels``: the decoder, or
  everything); each group's lr follows a warmup-cosine schedule of the
  step count (``warmup_steps_students_teacher``,
  ``t_total_students_teacher``), 0 at the first step as in optax;
* validation in eval mode (running statistics, no dropout);
* ``save_ckpt_backbone``: every 10 epochs (file ``epoch + 1``) the
  student's and the teacher's variables, the optimizer state as the JAX
  trainer's optax leaves and ``{"step": n}``; ``load_ckpt_backbone``: a
  checkpoint with a teacher resumes everything (epoch, student, teacher,
  optimizer, step), any other msgpack checkpoint is merged into the
  student by the tolerant rule and then copied into the teacher;
* ``view: true`` (with ``use_prototype_assignment``): every 5th step,
  the teacher's and each student's image over the argmax of its latent
  map, batch element 0
  (``utils/visualization.py::view_prototype_students_teacher``).

The model runs its kernels on the card (B1 forwards, B4 backwards of the
students' trainable blocks; B2 in the eval-mode decoders; with
``set_fused_block(False)``, B6/B8 forwards and their recompute
backward).

``mesh_data`` (``train/common.py::DeviceCtx``): data parallel, one
process per device, each rank on its rows of the global batch (wrap-
padded to a multiple of the world size).  The students' forwards run in
one ``DistributedDataParallel`` call (gradients summed); student and
teacher take the global batch's BatchNorm moments and dropout masks
(``SwinUnetR.set_data_group``), the teacher's EMA is the same on every
rank, the jitters come from the one seeded generator, and each loss is
the rank's share of the global batch's.  As in the JAX step, no
``_valid`` weighs the losses: the wrap-pad duplicates count.  Rank 0
alone writes.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from ..config import SUPERVISED_MODES, ModelConfig
from ..losses import clustered_prototype_loss, dice_loss, draw_jitters
from ..models.partition import label_of, set_trainable, trainable_labels
from ..ops.augment import map_label_indices
from ..parallel.train_parallel import Forwards, data_parallel
from ..utils import init_weights, trace
from ..utils.checkpoint import (load_checkpoint, merge_state, restore_like,
                                save_checkpoint)
from ..utils.device import resolve_device
from ..utils.metrics import MeanIoU, seg_stats
from ..utils.schedules import warmup_cosine
from ..utils.summary import model_summary
from ..utils.torch_import import load_flax_variables, to_flax_variables
from ..utils.visualization import view_prototype_students_teacher
from .common import (AvgLosses, DeviceCtx, StepProfiler, count_params,
                     ema_update, fill_missing_grads, grouped_adamw,
                     grouped_adamw_leaves,
                     load_grouped_adamw_leaves, set_scheduled_lr)

SAVE_EVERY = 10        # epochs between backbone checkpoints


class StudentsTeacherTrainer:
    """``backbone(conf, dropout_seed=...)`` builds each model (the port's
    ``SwinUnetR``); ``device`` defaults to the CUDA card."""

    def __init__(self, hparams, backbone, train_loader, val_loader,
                 logger=None, writer=None, device=None):
        self.hparams = hparams
        # view (with the prototype loss): the teacher's and the students'
        # latent maps of every 5th step (utils/visualization.py).
        self.view = bool(getattr(hparams, "view", False)
                         and hparams.use_prototype_assignment)
        self.view_data = None
        self.logger = logger or logging.getLogger(__name__)
        self.writer = writer
        self.device = resolve_device(device)
        self.model_conf = ModelConfig.from_mapping(hparams)
        seed = int(getattr(hparams, "seed", 0) or 0)
        self.model = backbone(self.model_conf, dropout_seed=seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        self.teacher = backbone(self.model_conf, dropout_seed=seed + 1)
        init_weights(self.teacher, torch.Generator().manual_seed(seed + 1))
        self.teacher.requires_grad_(False)
        self.model.to(self.device)
        self.teacher.to(self.device)
        self.dctx = DeviceCtx(hparams, self.device, self.logger)
        self.dp = self.dctx.group
        self.model.set_data_group(self.dp)
        self.teacher.set_data_group(self.dp)
        # The students' forwards in one call; DDP-wrapped by prepare_fit.
        self.forwards = self.students = Forwards(self.model)
        # Each step's students' jitters for the prototype loss.
        self.jitter_generator = torch.Generator().manual_seed(seed + 2)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.n_students = len(hparams.crop_size_students)
        self.supervised = (hparams.training_mode in SUPERVISED_MODES
                           and hparams.use_real_label)
        self.num_classes = getattr(hparams, "output_channels_pretrain", 2)
        self.loss_names = []
        if hparams.use_prototype_assignment:
            self.loss_names.append("prt")
        if self.supervised:
            self.loss_names.append("seg")
        if not self.loss_names:
            raise ValueError("No loss defined!")
        self.loss_names.append("tot")
        self.save_ckpt_path = Path(hparams.save_ckpt_backbone_path) \
            if getattr(hparams, "save_ckpt_backbone", False) else None
        self.optimizer = None
        self.schedule = None
        self.start_epoch = None      # set by prepare_fit()
        self.step_count = 0          # optimizer steps taken
        # Step times (perf/step_ms) and the profile_dir trace.
        self.profiler = StepProfiler(
            self.logger, getattr(hparams, "profile_dir", None),
            device=self.device,
            rank=None if self.dp is None else self.dp.rank)
        self.losses: list = []       # {name: value} of every training step
        self.val_losses: list = []   # {name: value} of every validation step

    # ------------------------------------------------------------- setup
    @property
    def step_ms(self) -> list:
        """Host time of every training step so far, in ms."""
        return [1e3 * d for d in self.profiler.durations]

    def configure_optimizers(self):
        """Freeze all but the mode's trainable set; AdamW in the base and
        prompt groups, each with its warmup-cosine schedule."""
        conf = self.hparams
        trainable = set_trainable(self.model,
                                  trainable_labels(self.model_conf))

        def schedule(lr):
            return warmup_cosine(float(lr),
                                 conf.warmup_steps_students_teacher,
                                 conf.t_total_students_teacher)

        groups = {
            "base": ([], schedule(conf.lr_students_teacher),
                     float(conf.weight_decay_students_teacher)),
            "prompt": ([], schedule(conf.lr_prompt_tokens),
                       float(conf.weight_decay_prompt_tokens))}
        for name, p in trainable:
            prompt = label_of(name) in ("encoder_prompt", "decoder_prompt")
            groups["prompt" if prompt else "base"][0].append(p)
        self.optimizer = grouped_adamw(groups)
        self.schedule = groups["base"][1]
        n = count_params(p for _, p in trainable)
        self.logger.info(f"{n} parameters trainable.")
        for name, loader in (("training", self.train_loader),
                             ("validation", self.val_loader)):
            if loader is not None:
                self.logger.info(
                    f"Size {name} set: {len(loader.dataset)}.")
        return self.optimizer, self.schedule

    def prepare_fit(self) -> int:
        """The optimizer, then ``load_ckpt_backbone`` if asked for.
        ``train()`` calls it unless it ran before.  Returns the first
        epoch to train."""
        self.configure_optimizers()
        self.start_epoch, self.step_count = 0, 0
        conf = self.hparams
        if getattr(conf, "load_ckpt_backbone", False) is not True:
            return self._distribute()
        path = conf.load_ckpt_backbone_path
        ckpt = load_checkpoint(path)
        if "teacher_state_dict" in ckpt:
            self.start_epoch = int(ckpt["current_epoch"])
            for model, key in ((self.model, "model_state_dict"),
                               (self.teacher, "teacher_state_dict")):
                load_flax_variables(model, restore_like(
                    to_flax_variables(model), ckpt[key]))
            load_grouped_adamw_leaves(self.optimizer, self.model,
                                      ckpt["optimizer_state_dict"])
            self.step_count = int(ckpt["scheduler_state_dict"]["step"])
            self.logger.info(f"Resumed from checkpoint {path}.")
        else:
            # A backbone-only checkpoint: merged into the student, which
            # the teacher then copies (BatchNorm statistics included).
            load_flax_variables(self.model, merge_state(
                to_flax_variables(self.model), ckpt["model_state_dict"]))
            self.teacher.load_state_dict(self.model.state_dict())
            self.logger.info(f"Loaded backbone checkpoint {path} into the "
                             "student and the teacher.")
        return self._distribute()

    def _distribute(self) -> int:
        if self.dp is not None:
            self.students = data_parallel(self.forwards, self.dp)
        return self.start_epoch

    # ------------------------------------------------------------- steps
    def _forwards(self, batch, students):
        """The students' outputs (``students``: the model's forwards, or
        their DDP wrapper) and the teacher's (without grad), on a staged
        batch."""
        outs = students(*(batch[f"image_st_{i}"]
                          for i in range(self.n_students)))
        with torch.no_grad(), trace.span("train.forward"):
            teacher = self.teacher(batch["image"])
        return outs, teacher

    def _losses(self, outs, teacher, batch, jitters):
        """({name: loss tensor}, seg stats or None)."""
        conf = self.hparams
        parts = {}
        total = outs[0]["latent_outputs"].new_zeros(())
        if conf.use_prototype_assignment:
            rf = float(conf.reduction_factor)
            if jitters is None:
                jitters = draw_jitters(self.n_students, rf,
                                       self.jitter_generator)
            parts["prt"] = clustered_prototype_loss(
                [o["latent_outputs"] for o in outs],
                teacher["latent_outputs"].detach(),
                [batch[f"coord_st_{i}"] for i in range(self.n_students)],
                batch["coord"], jitters, reduction_factor=rf,
                k_means_iterations=int(conf.k_means_iterations),
                fwhm=float(conf.fwhm), group=self.dp)
            total = total + parts["prt"]
        stats = None
        if self.supervised:
            active = tuple(getattr(conf, "active_labels_pretrain", ()) or ())
            seg_true = map_label_indices(batch["mask_st_0"], active)
            pred = outs[0]["seg_pred"]
            parts["seg"] = dice_loss(
                pred, seg_true, include_background=conf.include_background,
                group=self.dp)
            total = total + parts["seg"]
            stats = tuple(self.dctx.sum(t) for t in seg_stats(
                pred.detach(), seg_true, self.num_classes))
        parts["tot"] = total
        return parts, stats

    def train_step(self, batch, jitters=None):
        """One step on a host batch (the EMA, the forwards, the losses,
        the backward and the update); returns ({name: loss}, stats) on
        the device.  ``jitters``: the students' loss jitters, else drawn
        from :attr:`jitter_generator`.  One unit of the tracer
        (``train.step``)."""
        with trace.unit("train.step", self.device):
            ema_update(self.teacher, self.model, float(self.hparams.tau))
            staged = self.dctx.stage(batch)
            outs, teacher = self._forwards(staged, self.students)
            with trace.span("train.loss"):
                parts, stats = self._losses(outs, teacher, staged, jitters)
            if self.view:
                self.view_data = (
                    teacher["latent_outputs"], batch["image"],
                    [o["latent_outputs"].detach() for o in outs],
                    [batch[f"image_st_{i}"] for i in range(self.n_students)])
            with trace.span("train.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                parts["tot"].backward()
            with trace.span("train.optimizer"):
                fill_missing_grads(self.optimizer)
                set_scheduled_lr(self.optimizer, self.step_count)
                self.optimizer.step()
            self.step_count += 1
            return {k: self.dctx.sum(v.detach())
                    for k, v in parts.items()}, stats

    @torch.no_grad()
    def eval_step(self, batch, jitters=None):
        staged = self.dctx.stage(batch)
        parts, stats = self._losses(
            *self._forwards(staged, self.forwards), staged, jitters)
        return {k: self.dctx.sum(v) for k, v in parts.items()}, stats

    # ------------------------------------------------------------- train
    def _scalar(self, name, value, epoch) -> None:
        if self.writer is not None:
            self.writer.add_scalar(name, value, epoch)

    def _save(self, epoch: int) -> None:
        save_checkpoint(
            self.save_ckpt_path, epoch + 1, to_flax_variables(self.model),
            grouped_adamw_leaves(self.optimizer, self.model,
                                 self.step_count),
            {"step": self.step_count},
            teacher_state=to_flax_variables(self.teacher))
        self.logger.info(f"Saved checkpoint for epoch {epoch:04d}.")

    def train(self):
        conf = self.hparams
        start_epoch = self.prepare_fit() if self.start_epoch is None \
            else self.start_epoch
        metrics = MeanIoU(self.num_classes) if self.supervised else None
        avg, avg_val = AvgLosses(self.loss_names), AvgLosses(self.loss_names)
        best_val = {n: float("inf") for n in self.loss_names}
        self.logger.info(model_summary(self.model))
        self.logger.info(
            f"Scalar summaries: {getattr(conf, 'summary_dir', None)}")
        self.logger.info(f"Using device: {self.device}.")
        self.logger.info(f"Start training from epoch {start_epoch:04d}.")
        global_step = 0
        for epoch in range(start_epoch, conf.max_epochs_students_teacher + 1):
            self.model.train()
            self.teacher.train()
            for step, batch in enumerate(self.train_loader):
                self.profiler.step_begin(global_step)
                parts, stats = self.train_step(batch)
                parts = {k: float(v) for k, v in parts.items()}  # waits
                self.profiler.step_end(global_step)
                global_step += 1
                self.losses.append(parts)
                for name, val in parts.items():
                    avg.append(name, val)
                if stats is not None:
                    metrics.update_stats(*(t.cpu().numpy() for t in stats))
                if self.view and step % 5 == 0 and self.dctx.is_main:
                    tch, img, sts, imgs = self.view_data
                    view_prototype_students_teacher(
                        name=batch["name"], n_slices=4,
                        chs=conf.hidden_channels[0], prt_tch=tch,
                        img_tch=img, prt_sts=sts, img_sts=imgs,
                        epoch=epoch, step=step)
                if step % 5 == 0:
                    self.logger.info(
                        f"Learning rate in step {step} epoch {epoch}: "
                        f"{self.schedule(self.step_count):.5f}.")
                    if "prt" in parts:
                        self.logger.info(
                            f"Contrastive training loss in step {step} "
                            f"epoch {epoch}: {parts['prt']:.4f}.")
                    if "seg" in parts:
                        self.logger.info(
                            f"Segmentation training loss in step {step} "
                            f"epoch {epoch}: {parts['seg']:.4f}.")
            mean_ms = self.profiler.mean_ms()
            self.logger.info(f"Mean train step time epoch {epoch}: "
                             f"{mean_ms:.1f} ms.")
            self._scalar("perf/step_ms", mean_ms, epoch)
            for name, val in avg.mean_and_clear().items():
                self._scalar(f"train_loss/{name}", val, epoch)
            if metrics is not None:
                self._scalar("train_metric/seg", metrics.compute(), epoch)
                metrics.reset()
            if self.save_ckpt_path is not None and epoch % SAVE_EVERY == 0 \
                    and self.dctx.is_main:
                self._save(epoch)
            if self.val_loader is None:
                continue
            self.model.eval()
            self.teacher.eval()
            for batch in self.val_loader:
                parts, stats = self.eval_step(batch)
                parts = {k: float(v) for k, v in parts.items()}
                self.val_losses.append(parts)
                for name, val in parts.items():
                    avg_val.append(name, val)
                if stats is not None:
                    metrics.update_stats(*(t.cpu().numpy() for t in stats))
            for name, val in avg_val.mean_and_clear().items():
                if val < best_val[name]:
                    best_val[name] = val
                    self.logger.info(
                        f"Best {name}_loss_val improved in epoch {epoch}.")
                self._scalar(f"val_loss/{name}", val, epoch)
            if metrics is not None:
                self._scalar("val_metric/seg", metrics.compute(), epoch)
                metrics.reset()
        self.profiler.close()
        self.final_state = self.model.state_dict()
        self.final_teacher = self.teacher.state_dict()
        return self.final_state
