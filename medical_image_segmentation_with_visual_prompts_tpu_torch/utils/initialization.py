"""Wiring of the training CLI: training mode -> trainer and loaders.

Counterpart of the JAX package's ``utils/initialization.py``, including
its quirk that test mode passes the downstream test loader in the train
loader's slot.  The port trains all six modes: ``downstream``
(``SegmentationTrainer``), phase 1 (``MultiViewTrainer``) and the four
phase-2 modes (``StudentsTeacherTrainer``), the pretraining modes on the
pretrain loaders.
"""

from __future__ import annotations

from ..config import PHASE1_MODE, PHASE2_MODES, TRAINING_MODES
from ..data import (get_fit_loader_downstream,
                    get_fit_loader_self_supervised_learning,
                    get_fit_loader_supervised_learning,
                    get_test_loader_downstream)
from ..models import SwinUnetR
from ..train import (MultiViewTrainer, SegmentationTrainer,
                     StudentsTeacherTrainer)
from .loggers import SummaryWriter, get_logger


def _check_mode(hparams) -> None:
    mode = hparams.training_mode
    if mode not in TRAINING_MODES:
        raise NotImplementedError(f"Training mode {mode} not available!")


def setup_fitting(hparams, device=None):
    backbone = select_backbone(hparams)
    train_loader, val_loader = select_fitting_loader(hparams)
    return select_trainer(hparams, backbone, train_loader, val_loader,
                          get_logger(hparams.log_dir),
                          SummaryWriter(hparams.summary_dir), device)


def setup_testing(hparams, device=None):
    backbone = select_backbone(hparams)
    loader = select_testing_loader(hparams)
    return select_trainer(hparams, backbone, loader, None,
                          get_logger(hparams.log_dir),
                          SummaryWriter(hparams.summary_dir), device)


def select_backbone(hparams):
    if hparams.backbone == "swin_unetr":
        return SwinUnetR
    raise NotImplementedError(f"backbone {hparams.backbone}")


def select_trainer(hparams, backbone, train_loader, val_loader, logger,
                   writer, device=None):
    _check_mode(hparams)
    mode = hparams.training_mode
    trainer = MultiViewTrainer if mode == PHASE1_MODE else \
        StudentsTeacherTrainer if mode in PHASE2_MODES else \
        SegmentationTrainer
    return trainer(hparams, backbone, train_loader, val_loader, logger,
                   writer, device=device)


def select_fitting_loader(hparams):
    _check_mode(hparams)
    mode = hparams.training_mode
    if mode == "downstream":
        return get_fit_loader_downstream(hparams)
    if mode.startswith("self_supervised"):
        return get_fit_loader_self_supervised_learning(hparams)
    return get_fit_loader_supervised_learning(hparams)


def select_testing_loader(hparams):
    return get_test_loader_downstream(hparams)
