"""Downstream prompt-tuning trainer.

Counterpart of the JAX package's ``train/segmentation.py``
(``SegmentationTrainer.train`` and its ``train_step``): the backbone is
frozen and AdamW (lr ``lr_downstream``, weight decay
``weight_decay_downstream``) updates the prompt tokens, their
positional-bias parameters and the downstream head
(``models/partition.py``); the learning rate follows StepLR(100, 0.8),
set once per epoch; the loss is DiceFocal (gamma 4, softmax, one-hot
target) on the labels remapped to ``active_labels_downstream``; MeanIoU
accumulates per epoch; validation runs in eval mode when a loader is
given.  The model runs in train mode: BatchNorm on batch statistics and
counter-based dropout at the config's rates, through the fused block's
forward and backward kernels on the card.

The prompt-checkpoint save and resume and ``test()`` are not ported yet:
a config that asks for a prompt checkpoint raises NotImplementedError.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..losses import dice_focal_loss
from ..models.partition import downstream_labels, set_trainable
from ..ops.augment import map_label_indices
from ..utils import init_weights, load_reference_checkpoint
from ..utils.device import resolve_device
from ..utils.metrics import MeanIoU, seg_stats
from ..utils.schedules import step_decay
from .common import AvgLosses, adamw


class SegmentationTrainer:
    """``backbone(conf, dropout_seed=...)`` builds the model (the port's
    ``SwinUnetR``); ``device`` defaults to the CUDA card."""

    def __init__(self, hparams, backbone, train_loader, val_loader,
                 logger=None, writer=None, device=None):
        for key in ("save_ckpt_prompt_tokens", "load_ckpt_prompt_tokens"):
            if getattr(hparams, key, False):
                raise NotImplementedError(
                    f"SegmentationTrainer: {key} (prompt checkpoints) is not "
                    "ported to the PyTorch trainer yet")
        self.hparams = hparams
        self.logger = logger or logging.getLogger(__name__)
        self.device = resolve_device(device)
        self.model_conf = ModelConfig.from_mapping(hparams)
        seed = int(getattr(hparams, "seed", 0) or 0)
        self.model = backbone(self.model_conf, dropout_seed=seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        if getattr(hparams, "load_ckpt_backbone", False) is True:
            self._merge_backbone(hparams.load_ckpt_backbone_path)
        self.model.to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.writer = writer
        self.num_classes = hparams.output_channels_downstream
        self.optimizer = None
        self.step_ms: list = []      # host time of every training step
        self.losses: list = []       # loss of every training step

    def _merge_backbone(self, path) -> None:
        """Tolerant merge of a reference-schema checkpoint: every entry
        whose name and shape match a model tensor is loaded."""
        own = self.model.state_dict()
        sd = {k: v for k, v in load_reference_checkpoint(path).items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.model.load_state_dict(sd, strict=False)
        self.logger.info(f"Loaded {len(sd)} tensors of the backbone "
                         f"checkpoint {path}.")

    def configure_optimizers(self):
        """Freeze all but the downstream set; AdamW and its schedule."""
        trainable = set_trainable(self.model,
                                  downstream_labels(self.model_conf))
        n = sum(p.numel() for _, p in trainable)
        self.logger.info(f"{n} parameters trainable.")
        lr = float(self.hparams.lr_downstream)
        self.optimizer = adamw([p for _, p in trainable], lr,
                               float(self.hparams.weight_decay_downstream))
        self.schedule = step_decay(lr, step_size=100, gamma=0.8)
        return self.optimizer, self.schedule

    def _batch(self, batch):
        image = torch.from_numpy(np.asarray(batch["image"])).to(self.device)
        mask = torch.from_numpy(np.asarray(batch["mask"])).to(self.device)
        return image, map_label_indices(
            mask, tuple(self.hparams.active_labels_downstream))

    def train_step(self, batch):
        """One optimizer step on a host batch; returns (loss, stats)
        tensors on the device."""
        image, seg_true = self._batch(batch)
        logits = self.model(image)
        loss = dice_focal_loss(logits, seg_true, gamma=4.0,
                               include_background=self.hparams.include_background)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), seg_stats(logits.detach(), seg_true,
                                        self.num_classes)

    @torch.no_grad()
    def eval_step(self, batch):
        image, seg_true = self._batch(batch)
        logits = self.model(image)
        loss = dice_focal_loss(logits, seg_true, gamma=4.0,
                               include_background=self.hparams.include_background)
        return loss, seg_stats(logits, seg_true, self.num_classes)

    def _scalar(self, name, value, epoch) -> None:
        if self.writer is not None:
            self.writer.add_scalar(name, value, epoch)

    def train(self):
        conf = self.hparams
        self.configure_optimizers()
        metrics = MeanIoU(self.num_classes)
        avg, avg_val = AvgLosses(["seg", "tot"]), AvgLosses(["seg", "tot"])
        best_val = {"seg": float("inf"), "tot": float("inf")}
        self.logger.info(f"Using device: {self.device}.")
        for epoch in range(conf.max_epochs_downstream + 1):
            lr = self.schedule(epoch)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.model.train()
            for step, batch in enumerate(self.train_loader):
                t0 = time.perf_counter()
                loss, stats = self.train_step(batch)
                loss = float(loss)      # waits for the step
                self.step_ms.append(1e3 * (time.perf_counter() - t0))
                self.losses.append(loss)
                avg.append("seg", loss)
                avg.append("tot", loss)
                metrics.update_stats(*(t.cpu().numpy() for t in stats))
                if step % 5 == 0:
                    self.logger.info(
                        f"Learning rate in step {step} epoch {epoch}: "
                        f"{lr:.5f}.")
                    self.logger.info(
                        f"Segmentation training loss in step {step} epoch "
                        f"{epoch}: {loss:.5f}.")
                    self.logger.info(
                        f"Segmentation training score in step {step} epoch "
                        f"{epoch}: {metrics.compute():.5f}.")
            self.logger.info(f"Median train step time epoch {epoch}: "
                             f"{float(np.median(self.step_ms)):.1f} ms.")
            for name, val in avg.mean_and_clear().items():
                self._scalar(f"train_loss/{name}", val, epoch)
            self._scalar("train_metric/seg", metrics.compute(), epoch)
            metrics.reset()
            if self.val_loader is None:
                continue
            self.model.eval()
            for step, batch in enumerate(self.val_loader):
                loss, stats = self.eval_step(batch)
                avg_val.append("seg", loss)
                avg_val.append("tot", loss)
                metrics.update_stats(*(t.cpu().numpy() for t in stats))
                if step % 5 == 0:
                    self.logger.info(
                        f"Segmentation validation loss in step {step} epoch "
                        f"{epoch}: {avg_val.last('seg'):.5f}.")
            for name, val in avg_val.mean_and_clear().items():
                if val < best_val[name]:
                    best_val[name] = val
                    self.logger.info(
                        f"Best {name}_loss_val improved in epoch {epoch}.")
                self._scalar(f"val_loss/{name}", val, epoch)
            self._scalar("val_metric/seg", metrics.compute(), epoch)
            metrics.reset()
        self.final_state = self.model.state_dict()
        return self.final_state
