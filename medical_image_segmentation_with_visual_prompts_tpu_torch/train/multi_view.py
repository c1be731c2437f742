"""Phase-1 multi-view self-supervised encoder pretraining.

Counterpart of the JAX package's ``train/multi_view.py``
(``MultiViewTrainer``), the ``self_supervised_learning_encoder`` mode:

* two views of each batch: each rotated per sample by a class drawn in
  0-3 (H-W plane), then masked patchwise (``masking_shape``, exact count
  at ``masking_ratio``, one mask per view shared by the batch); with
  ``use_mutual_learning`` a third, view i under one of three spatial
  axis swaps.  The draws (:class:`ViewDraws`) come from
  :attr:`MultiViewTrainer.view_generator` unless the caller passes them;
* the views run through the model in order (i, j, then k), each forward
  in train mode updating the BatchNorm statistics the next one reads;
* losses: ``rec``, the MSE of both views' reconstructions against the
  masked views, over the kept voxels' share (``/ (1 - ratio)``); ``rot``,
  the cross-entropy of the rotation classes; ``con``, the NT-Xent pair
  loss of the contrastive codes; ``mut``, the MSE between view i's
  reconstruction and view k's, swapped back, on view i's kept voxels;
  ``tot`` = ``weight_rec * rec + weight_rot * rot + weight_con * con +
  mut``.  A swap whose reconstruction does not come back at the roi's
  shape (a roi that is not cubic enough for the encoder's merges) makes
  the step raise ``ValueError`` before it runs anything, as the JAX step
  fails on it;
* AdamW in two groups (``train/common.py::grouped_adamw``): ``body``, the
  encoder and its heads (``lr_multi_view``, ``weight_decay_multi_view``),
  and with encoder prompting ``prompt``, the encoder prompt tokens and
  their positional-bias parameters (``lr_prompt_tokens``,
  ``weight_decay_prompt_tokens``); each lr follows a warmup-cosine
  schedule of the step count (``warmup_steps_multi_view``,
  ``t_total_multi_view``), 0 at the first step as in optax;
* validation in eval mode (running statistics, no dropout) on fresh
  draws; scalars ``train_loss/*``, ``val_loss/*`` and ``perf/step_ms``
  per epoch, the best validation losses logged;
* ``save_ckpt_backbone``: every 10 epochs (file ``epoch + 1``) the
  model's variables, the optimizer state as the JAX trainer's optax
  ``multi_transform`` leaves and ``{"step": n}``; ``load_ckpt_backbone``
  resumes all of it (epoch, model, optimizer, step);
* ``view: true`` (with ``use_reconstruction``): every 5th step, view i
  and its reconstruction on the kept voxels, batch element 0
  (``utils/visualization.py::view_reconstruction``).

The model runs its kernels on the card: B1 forwards and B4 backwards of
the 6 encoder blocks per view (with ``set_fused_block(False)``, B6/B8
forwards and their recompute backward).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..losses import contrastive_pair_loss
from ..models.partition import label_of, set_trainable, trainable_labels
from ..ops.augment import (draw_mask_rank, draw_rotations, mask_by,
                           mask_shape, permute_inverse, permuted_shape,
                           random_permute, rotate_by)
from ..utils import init_weights
from ..utils.checkpoint import load_checkpoint, restore_like, save_checkpoint
from ..utils.device import resolve_device
from ..utils.schedules import warmup_cosine
from ..utils.summary import model_summary
from ..utils.torch_import import load_flax_variables, to_flax_variables
from ..utils.visualization import view_reconstruction
from .common import (AvgLosses, fill_missing_grads, grouped_adamw,
                     grouped_adamw_leaves, load_grouped_adamw_leaves,
                     set_scheduled_lr)

SAVE_EVERY = 10        # epochs between backbone checkpoints
_LABELS = (("rec", "Reconstruction"), ("rot", "Rotation prediction"),
           ("con", "Contrastive"), ("mut", "Mutual learning"))


class ViewDraws(NamedTuple):
    """One step's random draws: each view's rotation classes ``[B]`` and
    mask rank (a permutation of the patch indices), and the mutual
    learning's axis swap (0-2)."""
    rot_i: torch.Tensor
    rot_j: torch.Tensor
    rank_i: torch.Tensor
    rank_j: torch.Tensor
    permute: int = 0


class MultiViewTrainer:
    """``backbone(conf, dropout_seed=...)`` builds the model (the port's
    ``SwinUnetR``); ``device`` defaults to the CUDA card."""

    def __init__(self, hparams, backbone, train_loader, val_loader,
                 logger=None, writer=None, device=None):
        self.hparams = hparams
        # view (with the reconstruction head): view i and its
        # reconstruction, masked, of every 5th step
        # (utils/visualization.py).
        self.view = bool(getattr(hparams, "view", False)
                         and hparams.use_reconstruction)
        self.view_data = None
        self.logger = logger or logging.getLogger(__name__)
        self.writer = writer
        self.device = resolve_device(device)
        self.model_conf = ModelConfig.from_mapping(hparams)
        seed = int(getattr(hparams, "seed", 0) or 0)
        self.model = backbone(self.model_conf, dropout_seed=seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        # Each step's view draws (rotations, masks, the axis swap).
        self.view_generator = torch.Generator().manual_seed(seed + 1)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.roi = tuple(int(s) for s in hparams.roi_size)
        self.patch = tuple(int(s) for s in hparams.masking_shape)
        self.ratio = float(hparams.masking_ratio)
        self.n_patches = int(np.prod(mask_shape(self.roi, self.patch)))
        self.loss_names = [n for n, used in (
            ("rec", hparams.use_reconstruction),
            ("rot", hparams.use_rotation_prediction),
            ("con", hparams.use_contrastive_learning),
            ("mut", hparams.use_mutual_learning)) if used] + ["tot"]
        if self.loss_names == ["tot"]:
            raise ValueError("No loss defined!")
        self.save_ckpt_path = Path(hparams.save_ckpt_backbone_path) \
            if getattr(hparams, "save_ckpt_backbone", False) else None
        self.optimizer = None
        self.schedule = None
        self.start_epoch = None      # set by prepare_fit()
        self.step_count = 0          # optimizer steps taken
        self.step_ms: list = []      # host time of every training step
        self.losses: list = []       # {name: value} of every training step
        self.val_losses: list = []   # {name: value} of every validation step

    # ------------------------------------------------------------- setup
    def configure_optimizers(self):
        """Freeze all but the encoder, its heads and the encoder prompts;
        AdamW in the body and (with encoder prompting) prompt groups,
        each with its warmup-cosine schedule."""
        conf = self.hparams
        trainable = set_trainable(self.model,
                                  trainable_labels(self.model_conf))

        def schedule(lr):
            return warmup_cosine(float(lr), conf.warmup_steps_multi_view,
                                 conf.t_total_multi_view)

        groups = {"body": ([], schedule(conf.lr_multi_view),
                           float(conf.weight_decay_multi_view))}
        if conf.use_encoder_prompting:
            groups["prompt"] = ([], schedule(conf.lr_prompt_tokens),
                                float(conf.weight_decay_prompt_tokens))
        for name, p in trainable:
            prompt = label_of(name) == "encoder_prompt"
            groups["prompt" if prompt else "body"][0].append(p)
        self.optimizer = grouped_adamw(groups)
        self.schedule = groups["body"][1]
        n = sum(p.numel() for _, p in trainable)
        self.logger.info(f"{n} parameters trainable.")
        for name, loader in (("training", self.train_loader),
                             ("validation", self.val_loader)):
            if loader is not None:
                self.logger.info(
                    f"Size {name} set: {len(loader.dataset)}.")
        return self.optimizer, self.schedule

    def prepare_fit(self) -> int:
        """The optimizer, then ``load_ckpt_backbone`` (a full resume) if
        asked for.  ``train()`` calls it unless it ran before.  Returns
        the first epoch to train."""
        self.configure_optimizers()
        self.start_epoch, self.step_count = 0, 0
        conf = self.hparams
        if getattr(conf, "load_ckpt_backbone", False) is not True:
            return self.start_epoch
        path = conf.load_ckpt_backbone_path
        ckpt = load_checkpoint(path)
        self.start_epoch = int(ckpt["current_epoch"])
        load_flax_variables(self.model, restore_like(
            to_flax_variables(self.model), ckpt["model_state_dict"]))
        load_grouped_adamw_leaves(self.optimizer, self.model,
                                  ckpt["optimizer_state_dict"])
        self.step_count = int(ckpt["scheduler_state_dict"]["step"])
        self.logger.info(f"Resumed from checkpoint {path}.")
        return self.start_epoch

    # ------------------------------------------------------------- views
    def draw_views(self, b: int) -> ViewDraws:
        """A step's draws for a batch of ``b`` from
        :attr:`view_generator`."""
        g = self.view_generator
        permute = int(torch.randint(0, 3, (), generator=g)) \
            if self.hparams.use_mutual_learning else 0
        return ViewDraws(draw_rotations(g, b), draw_rotations(g, b),
                         draw_mask_rank(g, self.n_patches),
                         draw_mask_rank(g, self.n_patches), permute)

    def check_views(self, draws: ViewDraws) -> None:
        """Raise ``ValueError`` where a view's reconstruction would not
        come back at the roi's shape (nothing runs before it)."""
        conf = self.hparams
        if not (conf.use_reconstruction or conf.use_mutual_learning):
            return
        rec = self.model.reconstruction_shape(self.roi)
        if rec != self.roi:
            raise ValueError(f"the reconstruction of a {self.roi} view is "
                             f"{rec}, not the roi's shape {self.roi}")
        if conf.use_mutual_learning:
            c = int(draws.permute)
            seen = permuted_shape(self.roi, c)
            rec = self.model.reconstruction_shape(seen)
            back = permuted_shape(rec, c)
            if back != self.roi:
                raise ValueError(
                    f"mutual learning, permutation {c}: the reconstruction "
                    f"of the {seen} view is {rec}, {back} swapped back, not "
                    f"the roi's shape {self.roi}")

    def _image(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["image"], device=self.device)

    def _losses(self, image: torch.Tensor, draws: ViewDraws) -> dict:
        """{name: loss tensor} of the views of ``image`` (the model runs
        in its current mode)."""
        conf = self.hparams
        x_i, keep_i = mask_by(rotate_by(image, draws.rot_i), draws.rank_i,
                              self.roi, self.patch, self.ratio)
        x_j, keep_j = mask_by(rotate_by(image, draws.rot_j), draws.rank_j,
                              self.roi, self.patch, self.ratio)
        out_i, out_j = self.model(x_i), self.model(x_j)
        mi = keep_i[None, ..., None].float()
        mj = keep_j[None, ..., None].float()
        parts = {}
        total = image.new_zeros((), dtype=torch.float32)
        if conf.use_reconstruction:
            img = torch.cat([x_i * mi, x_j * mj])
            rec = torch.cat([out_i["reconstruction"] * mi,
                             out_j["reconstruction"] * mj])
            parts["rec"] = torch.mean((rec - img) ** 2) / (1 - self.ratio)
            total = total + float(conf.weight_rec) * parts["rec"]
            if self.view:
                self.view_data = ((x_i * mi).detach(),
                                  (out_i["reconstruction"] * mi).detach())
        if conf.use_rotation_prediction:
            logits = torch.cat([out_i["rotation_prediction"],
                                out_j["rotation_prediction"]])
            labels = torch.cat([draws.rot_i, draws.rot_j]).to(
                logits.device, torch.int64)
            parts["rot"] = F.cross_entropy(logits, labels)
            total = total + float(conf.weight_rot) * parts["rot"]
        if conf.use_contrastive_learning:
            parts["con"] = contrastive_pair_loss(
                out_i["contrastive_coding"], out_j["contrastive_coding"])
            total = total + float(conf.weight_con) * parts["con"]
        if conf.use_mutual_learning:
            c = int(draws.permute)
            out_k = self.model(random_permute(x_i, c).contiguous())
            rec_perm = permute_inverse(out_k["reconstruction"], c)
            parts["mut"] = torch.mean(
                ((rec_perm - out_i["reconstruction"]) * mi) ** 2
            ) / (1 - self.ratio)
            total = total + parts["mut"]
        parts["tot"] = total
        return parts

    # ------------------------------------------------------------- steps
    def train_step(self, batch, draws: Optional[ViewDraws] = None) -> dict:
        """One step on a batch (its ``image``, host or device): the views,
        the forwards, the losses, the backward and the update; returns
        {name: loss} on the device.  ``draws``: the step's
        :class:`ViewDraws`, else drawn from :attr:`view_generator`."""
        image = self._image(batch)
        draws = draws or self.draw_views(image.shape[0])
        self.check_views(draws)
        parts = self._losses(image, draws)
        self.optimizer.zero_grad(set_to_none=True)
        parts["tot"].backward()
        fill_missing_grads(self.optimizer)
        set_scheduled_lr(self.optimizer, self.step_count)
        self.optimizer.step()
        self.step_count += 1
        return {k: v.detach() for k, v in parts.items()}

    @torch.no_grad()
    def eval_step(self, batch, draws: Optional[ViewDraws] = None) -> dict:
        image = self._image(batch)
        draws = draws or self.draw_views(image.shape[0])
        self.check_views(draws)
        return self._losses(image, draws)

    # ------------------------------------------------------------- train
    def _scalar(self, name, value, epoch) -> None:
        if self.writer is not None:
            self.writer.add_scalar(name, value, epoch)

    def _save(self, epoch: int) -> None:
        save_checkpoint(
            self.save_ckpt_path, epoch + 1, to_flax_variables(self.model),
            grouped_adamw_leaves(self.optimizer, self.model,
                                 self.step_count),
            {"step": self.step_count})
        self.logger.info(f"Saved checkpoint for epoch {epoch:04d}.")

    def train(self):
        self.self_supervised_learning()
        return self.final_state

    def self_supervised_learning(self):
        conf = self.hparams
        start_epoch = self.prepare_fit() if self.start_epoch is None \
            else self.start_epoch
        avg, avg_val = AvgLosses(self.loss_names), AvgLosses(self.loss_names)
        best_val = {n: float("inf") for n in self.loss_names}
        self.logger.info(model_summary(self.model))
        self.logger.info(
            f"Scalar summaries: {getattr(conf, 'summary_dir', None)}")
        self.logger.info(f"Using device: {self.device}.")
        self.logger.info(f"Start training from epoch {start_epoch:04d}.")
        for epoch in range(start_epoch, conf.max_epochs_multi_view + 1):
            self.model.train()
            for step, batch in enumerate(self.train_loader):
                t0 = time.perf_counter()
                parts = self.train_step(batch)
                parts = {k: float(v) for k, v in parts.items()}  # waits
                self.step_ms.append(1e3 * (time.perf_counter() - t0))
                self.losses.append(parts)
                for name, val in parts.items():
                    avg.append(name, val)
                if self.view and step % 5 == 0:
                    view_reconstruction(
                        name=batch["name"], n_slices=4,
                        ori_img=self.view_data[0],
                        rec_img=self.view_data[1], epoch=epoch, step=step)
                if step % 5 == 0:
                    self.logger.info(
                        f"Learning rate in step {step} epoch {epoch}: "
                        f"{self.schedule(self.step_count):.5f}.")
                    for name, label in _LABELS:
                        if name in parts:
                            self.logger.info(
                                f"{label} training loss in step {step} "
                                f"epoch {epoch}: {parts[name]:.5f}.")
            recent = self.step_ms[-50:]
            mean_ms = float(np.mean(recent)) if recent else 0.0
            self.logger.info(f"Mean train step time epoch {epoch}: "
                             f"{mean_ms:.1f} ms.")
            self._scalar("perf/step_ms", mean_ms, epoch)
            for name, val in avg.mean_and_clear().items():
                self._scalar(f"train_loss/{name}", val, epoch)
            if self.save_ckpt_path is not None and epoch % SAVE_EVERY == 0:
                self._save(epoch)
            if self.val_loader is None:
                continue
            self.model.eval()
            for batch in self.val_loader:
                parts = {k: float(v) for k, v in
                         self.eval_step(batch).items()}
                self.val_losses.append(parts)
                for name, val in parts.items():
                    avg_val.append(name, val)
            for name, val in avg_val.mean_and_clear().items():
                if val < best_val[name]:
                    best_val[name] = val
                    self.logger.info(
                        f"Best {name}_loss_val improved in epoch {epoch}.")
                self._scalar(f"val_loss/{name}", val, epoch)
        self.final_state = self.model.state_dict()
