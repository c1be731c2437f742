"""Downstream prompt-tuning trainer and its sliding-window test.

Counterpart of the JAX package's ``train/segmentation.py``
(``SegmentationTrainer``):

* ``train()``: the backbone is frozen and AdamW (lr ``lr_downstream``,
  weight decay ``weight_decay_downstream``) updates the prompt tokens,
  their positional-bias parameters and the downstream head
  (``models/partition.py``); the learning rate follows StepLR(100, 0.8),
  set once per epoch; the loss is DiceFocal (gamma 4, softmax, one-hot
  target) on the labels remapped to ``active_labels_downstream``; MeanIoU
  accumulates per epoch; validation runs in eval mode when a loader is
  given.  The model runs in train mode: BatchNorm on batch statistics and
  counter-based dropout at the config's rates, through the fused block's
  forward and backward kernels on the card (with
  ``set_fused_block(False)``, the unfused block's B6/B8 forwards and
  their recompute backward, or the JAX XLA attention with attention
  dropout on).
* Checkpoints are the JAX package's msgpack family
  (``utils/checkpoint.py``), so either package resumes or tests the
  other's.  ``load_ckpt_backbone`` merges a backbone checkpoint (a
  reference-schema ``.pt`` by its suffix, else msgpack) by the JAX
  tolerant-merge rule; ``save_ckpt_prompt_tokens`` saves the full model
  state, the optimizer state and the epoch every 20 epochs (file
  ``epoch + 1``); ``load_ckpt_prompt_tokens`` resumes from such a file
  at its epoch with its optimizer state.
* ``test()``: with ``test_blending: none`` (the reference's protocol) the
  stride-aligned centre crop of each test volume is cut into windows at
  stride roi/2, run in fixed chunks of 10 (the last one padded, the
  padding left out of the statistics), and MeanIoU and Dice are taken
  over each volume's windows; with ``gaussian`` the volume is stitched by
  ``parallel.BucketedInference`` (``test_stride_factor``,
  ``test_coverage``) and scored whole.  Both log ``"{run_name}: {name}:
  {mean} +/- {std}."`` over the volumes and return the per-volume values.
  ``_test_windows`` and ``_test_gaussian`` yield each volume's name,
  statistics and labels.
* ``view: true``: ``utils/visualization.py::view_segmentation`` panels
  of every 5th training step (its logits and labels) and of the first
  chunk of each test volume under the per-window protocol (logits,
  labels, image), batch element 0, as the JAX trainer draws them.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig
from ..losses import dice_focal_loss
from ..models.partition import downstream_labels, set_trainable
from ..ops.augment import map_label_indices
from ..parallel import BucketedInference, window_starts
from ..utils import init_weights, load_reference_checkpoint
from ..utils.checkpoint import (load_checkpoint, merge_state, restore_like,
                                save_checkpoint)
from ..utils.device import resolve_device
from ..utils.metrics import DiceCoefficient, MeanIoU, seg_stats
from ..utils.schedules import step_decay
from ..utils.summary import model_summary
from ..utils.torch_import import load_flax_variables, to_flax_variables
from ..utils.visualization import view_segmentation
from .common import (AvgLosses, adamw, adamw_leaves, fill_missing_grads,
                     load_adamw_leaves)

TEST_CHUNK = 10        # windows per forward of the per-window test
SAVE_EVERY = 20        # epochs between prompt-token checkpoints


class SegmentationTrainer:
    """``backbone(conf, dropout_seed=...)`` builds the model (the port's
    ``SwinUnetR``); ``device`` defaults to the CUDA card."""

    def __init__(self, hparams, backbone, train_loader, val_loader,
                 logger=None, writer=None, device=None):
        self.hparams = hparams
        # view: PNG panels of every 5th step and of each test volume's
        # first chunk (utils/visualization.py).
        self.view = bool(getattr(hparams, "view", False))
        self.view_data = None        # the last train step's (logits, labels)
        self.logger = logger or logging.getLogger(__name__)
        self.device = resolve_device(device)
        self.model_conf = ModelConfig.from_mapping(hparams)
        seed = int(getattr(hparams, "seed", 0) or 0)
        self.model = backbone(self.model_conf, dropout_seed=seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        if getattr(hparams, "load_ckpt_backbone", False) is True:
            self._merge_backbone(hparams.load_ckpt_backbone_path)
        self.model.to(self.device)
        # Resolved by ``config.get_full_configs``.
        self.save_ckpt_path = Path(hparams.save_ckpt_prompt_tokens_path) \
            if getattr(hparams, "save_ckpt_prompt_tokens", False) else None
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.writer = writer
        self.num_classes = hparams.output_channels_downstream
        self.optimizer = None
        self.start_epoch = None      # set by prepare_fit()
        self.step_ms: list = []      # host time of every training step
        self.losses: list = []       # loss of every training step
        self.metric_vals = None      # test(): per-volume IoU and Dice

    def _merge_backbone(self, path) -> None:
        """Merge a backbone checkpoint.  A ``.pt`` (reference schema):
        every entry whose name and shape match a model tensor.  Otherwise
        a msgpack checkpoint (either package's): every flax path present
        in the model and in the file takes the file's value
        (``merge_state``); the rest keeps its initialization."""
        if Path(path).suffix == ".pt":
            own = self.model.state_dict()
            sd = {k: v for k, v in load_reference_checkpoint(path).items()
                  if k in own and tuple(v.shape) == tuple(own[k].shape)}
            self.model.load_state_dict(sd, strict=False)
            self.logger.info(f"Loaded {len(sd)} tensors of the backbone "
                             f"checkpoint {path}.")
            return
        ckpt = load_checkpoint(path)
        load_flax_variables(self.model, merge_state(
            to_flax_variables(self.model), ckpt["model_state_dict"]))
        self.logger.info(f"Loaded backbone checkpoint {path}.")

    def _restore_model(self, ckpt) -> None:
        """The full model state of a prompt-token checkpoint."""
        load_flax_variables(self.model, restore_like(
            to_flax_variables(self.model), ckpt["model_state_dict"]))

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
        if self.train_loader is not None:
            self.logger.info(
                f"Size training set: {len(self.train_loader.dataset)}.")
        if self.val_loader is not None:
            self.logger.info(
                f"Size validation set: {len(self.val_loader.dataset)}.")
        return self.optimizer, self.schedule

    def prepare_fit(self) -> int:
        """The optimizer, then the prompt-token resume if asked for (model
        state, optimizer state, epoch).  ``train()`` calls it unless it
        ran before.  Returns the first epoch to train."""
        self.configure_optimizers()
        self.start_epoch = 0
        conf = self.hparams
        if getattr(conf, "load_ckpt_prompt_tokens", False) is True:
            ckpt = load_checkpoint(conf.load_ckpt_prompt_tokens_path)
            self.start_epoch = int(ckpt["current_epoch"])
            self._restore_model(ckpt)
            load_adamw_leaves(self.optimizer, self.model,
                              ckpt["optimizer_state_dict"])
            self.logger.info(f"Resumed from checkpoint "
                             f"{conf.load_ckpt_prompt_tokens_path}.")
        return self.start_epoch

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
        fill_missing_grads(self.optimizer)
        self.optimizer.step()
        if self.view:
            self.view_data = (logits.detach(), seg_true)
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
        start_epoch = self.prepare_fit() if self.start_epoch is None \
            else self.start_epoch
        metrics = MeanIoU(self.num_classes)
        avg, avg_val = AvgLosses(["seg", "tot"]), AvgLosses(["seg", "tot"])
        best_val = {"seg": float("inf"), "tot": float("inf")}
        self.logger.info(model_summary(self.model))
        self.logger.info(
            f"Scalar summaries: {getattr(conf, 'summary_dir', None)}")
        self.logger.info(f"Using device: {self.device}.")
        self.logger.info(f"Start training from epoch {start_epoch:04d}.")
        for epoch in range(start_epoch, conf.max_epochs_downstream + 1):
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
                if self.view and step % 5 == 0:
                    view_segmentation(
                        name=batch["name"], n_slices=4,
                        seg_pred=self.view_data[0],
                        seg_target=self.view_data[1],
                        n_classes=self.num_classes, epoch=epoch, step=step)
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
            recent = self.step_ms[-50:]
            mean_ms = float(np.mean(recent)) if recent else 0.0
            self.logger.info(f"Mean train step time epoch {epoch}: "
                             f"{mean_ms:.1f} ms.")
            self._scalar("perf/step_ms", mean_ms, epoch)
            for name, val in avg.mean_and_clear().items():
                self._scalar(f"train_loss/{name}", val, epoch)
            self._scalar("train_metric/seg", metrics.compute(), epoch)
            metrics.reset()
            if self.save_ckpt_path is not None and epoch % SAVE_EVERY == 0:
                # Full model state, optimizer state, epoch: file epoch + 1.
                save_checkpoint(
                    self.save_ckpt_path, epoch + 1,
                    to_flax_variables(self.model),
                    adamw_leaves(self.optimizer, self.model),
                    {"epoch": epoch + 1})
                self.logger.info(f"Saved checkpoint for epoch {epoch:04d}.")
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
                    self.logger.info(
                        f"Segmentation validation score in step {step} "
                        f"epoch {epoch}: {metrics.compute():.5f}.")
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

    # ---------------------------------------------------------------- test
    def _volume_stats(self, pred: torch.Tensor, mask: torch.Tensor):
        """Per-class (intersection, pred sum, target sum) of a label
        volume, as float64 numpy vectors."""
        seg_true = map_label_indices(
            mask, tuple(self.hparams.active_labels_downstream))
        seg_true = seg_true.reshape(pred.shape).long()
        classes = torch.arange(self.num_classes, device=pred.device)
        p1 = pred[..., None] == classes
        t1 = seg_true[..., None] == classes
        axes = tuple(range(pred.dim()))
        return tuple(v.sum(axes).cpu().numpy().astype(np.float64)
                     for v in (p1 & t1, p1, t1))

    @torch.inference_mode()
    def test(self):
        conf = self.hparams
        if getattr(conf, "load_ckpt_prompt_tokens", False) is True:
            self._restore_model(
                load_checkpoint(conf.load_ckpt_prompt_tokens_path))
            self.logger.info(
                f"Loaded checkpoint {conf.load_ckpt_prompt_tokens_path}.")
        self.model.eval()
        metrics = {"iou": MeanIoU(self.num_classes),
                   "dcc": DiceCoefficient(self.num_classes)}
        metric_vals = {"iou": [], "dcc": []}
        gaussian = getattr(conf, "test_blending", "none") == "gaussian"
        score = self._test_gaussian() if gaussian else self._test_windows()
        for _, stats, _ in score:
            for metric in metrics.values():
                metric.update_stats(*stats)
            for key, metric in metrics.items():
                metric_vals[key].append(metric.compute())
                metric.reset()
        run_name = getattr(conf, "run_name", "test")
        for key, values in metric_vals.items():
            mean = sum(values) / len(values)
            std = (sum((v - mean) ** 2 for v in values) / len(values)) ** 0.5
            self.logger.info(f"{run_name}: {key}: {mean:.4f} +/- {std:.4f}.")
        self.metric_vals = metric_vals
        return metric_vals

    def _volumes(self):
        for batch in self.train_loader:
            yield (batch["name"][0], np.asarray(batch["image"])[0],
                   np.asarray(batch["mask"])[0])

    @torch.inference_mode()
    def _test_windows(self):
        """Per volume: the windows of the stride-aligned centre crop in
        fixed chunks of :data:`TEST_CHUNK`; yields (name, stats over its
        windows, uint8 labels of its windows ``[n, *roi]`` on the
        device)."""
        wh, ww, wd = roi = tuple(self.hparams.roi_size)
        for step, (name, x, m) in enumerate(self._volumes()):
            slc, grid, _ = window_starts(x.shape[:3], roi)   # stride roi / 2
            x = torch.from_numpy(np.ascontiguousarray(x[slc])).to(
                self.device)
            m = torch.from_numpy(np.ascontiguousarray(m[slc])).to(
                self.device)
            totals, preds = None, []
            for lo in range(0, len(grid), TEST_CHUNK):
                part = grid[lo:lo + TEST_CHUNK]
                xs = torch.stack([x[a:a + wh, b:b + ww, c:c + wd]
                                  for a, b, c in part])
                ms = torch.stack([m[a:a + wh, b:b + ww, c:c + wd]
                                  for a, b, c in part])
                pad = TEST_CHUNK - len(part)     # one program shape
                if pad:
                    xs = torch.cat([xs, xs.new_zeros((pad, *xs.shape[1:]))])
                logits = self.model(xs)
                if self.view and lo == 0:
                    view_segmentation(
                        name=name, n_slices=4, seg_pred=logits,
                        seg_target=map_label_indices(ms, tuple(
                            self.hparams.active_labels_downstream)),
                        img=xs, n_classes=self.num_classes, epoch=0,
                        step=step)
                pred = logits[:len(part)].argmax(-1)
                stats = self._volume_stats(pred, ms)
                totals = stats if totals is None else \
                    tuple(a + b for a, b in zip(totals, stats))
                preds.append(pred.to(torch.uint8))
            yield name, totals, torch.cat(preds)

    @torch.inference_mode()
    def _test_gaussian(self):
        """Per volume: the Gaussian-stitched prediction of the centre crop
        (``test_coverage: crop``) or of the whole volume (``pad``); yields
        (name, stats, uint8 labels on the device)."""
        conf = self.hparams
        roi = tuple(conf.roi_size)
        coverage = getattr(conf, "test_coverage", "crop")
        runner = BucketedInference(
            self.model, roi, None, self.num_classes,
            stride=getattr(conf, "test_stride_factor", None),
            coverage=coverage, device=self.device)
        for name, x, m in self._volumes():
            if coverage != "pad":
                slc = window_starts(x.shape[:3], roi, runner.stride)[0]
                x, m = x[slc], m[slc]
            pred = runner(np.ascontiguousarray(x)).argmax(-1)
            yield name, self._volume_stats(
                pred, torch.from_numpy(np.ascontiguousarray(m)).to(
                    self.device)), pred.to(torch.uint8)
