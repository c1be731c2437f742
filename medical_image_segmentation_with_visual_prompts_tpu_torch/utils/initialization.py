"""Wiring of the training CLI: training mode -> trainer and loaders.

Counterpart of the JAX package's ``utils/initialization.py``, including
its quirk that test mode passes the downstream test loader in the train
loader's slot.  The port trains the downstream mode; the other training
modes raise NotImplementedError naming the ROADMAP queue A item that
ports them.
"""

from __future__ import annotations

from ..data import get_fit_loader_downstream, get_test_loader_downstream
from ..models import SwinUnetR
from ..train import SegmentationTrainer
from .loggers import SummaryWriter, get_logger

# Training mode -> the ROADMAP queue A item that ports its trainer.
NOT_PORTED = {
    "self_supervised_learning_encoder": "item 8 (phase-1 trainer)",
    "self_supervised_learning_decoder": "item 7 (phase-2 trainer)",
    "self_supervised_learning_all": "item 7 (phase-2 trainer)",
    "supervised_learning_decoder": "item 7 (phase-2 trainer)",
    "supervised_learning_all": "item 7 (phase-2 trainer)",
}


def _check_mode(hparams) -> None:
    mode = hparams.training_mode
    if mode in NOT_PORTED:
        raise NotImplementedError(
            f"training mode {mode} is not ported to the PyTorch package yet "
            f"(ROADMAP queue A {NOT_PORTED[mode]})")
    if mode != "downstream":
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
    return SegmentationTrainer(hparams, backbone, train_loader, val_loader,
                               logger, writer, device=device)


def select_fitting_loader(hparams):
    _check_mode(hparams)
    return get_fit_loader_downstream(hparams)


def select_testing_loader(hparams):
    return get_test_loader_downstream(hparams)
