"""Wiring of the training CLI: training mode -> trainer and loaders.

Counterpart of the JAX package's ``utils/initialization.py``, including
its quirk that test mode passes the downstream test loader in the train
loader's slot.  The port trains the downstream mode
(``SegmentationTrainer``) and the four phase-2 modes
(``StudentsTeacherTrainer`` on the pretrain loaders); the phase-1 mode
raises NotImplementedError naming the ROADMAP queue A item that ports
it.
"""

from __future__ import annotations

from ..config import PHASE2_MODES
from ..data import (get_fit_loader_downstream,
                    get_fit_loader_self_supervised_learning,
                    get_fit_loader_supervised_learning,
                    get_test_loader_downstream)
from ..models import SwinUnetR
from ..train import SegmentationTrainer, StudentsTeacherTrainer
from .loggers import SummaryWriter, get_logger

# Training mode -> the ROADMAP queue A item that ports its trainer.
NOT_PORTED = {
    "self_supervised_learning_encoder": "item 8 (phase-1 trainer)",
}


def _check_mode(hparams) -> None:
    mode = hparams.training_mode
    if mode in NOT_PORTED:
        raise NotImplementedError(
            f"training mode {mode} is not ported to the PyTorch package yet "
            f"(ROADMAP queue A {NOT_PORTED[mode]})")
    if mode != "downstream" and mode not in PHASE2_MODES:
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
    trainer = StudentsTeacherTrainer if hparams.training_mode in \
        PHASE2_MODES else SegmentationTrainer
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
