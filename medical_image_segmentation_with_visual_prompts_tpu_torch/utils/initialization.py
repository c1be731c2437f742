"""Wiring of the training CLI: training mode -> trainer and loaders.

Counterpart of the JAX package's ``utils/initialization.py``, including
its quirk that test mode passes the downstream test loader in the train
loader's slot.  :func:`prepare_process` comes first: it starts the
process group that ``distributed`` or ``mesh_data`` asks for
(``parallel/distributed.py``) and checks ``mesh_data`` against the world
before anything is read or written; only rank 0 then writes the log
file and the summaries.  The port trains all six modes: ``downstream``
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
from ..parallel import maybe_initialize_distributed
from ..parallel.mesh import mesh_of, world
from ..train import (MultiViewTrainer, SegmentationTrainer,
                     StudentsTeacherTrainer)
from .loggers import get_logger, get_summary_writer


def _check_mode(hparams) -> None:
    mode = hparams.training_mode
    if mode not in TRAINING_MODES:
        raise NotImplementedError(f"Training mode {mode} not available!")


def prepare_process(hparams, device="cpu") -> bool:
    """Start the process group the config asks for and check
    ``mesh_data`` against the world size (raises naming both); returns
    whether this process is rank 0, the one that writes."""
    maybe_initialize_distributed(hparams, device)
    mesh_of(hparams)
    return world()[1] == 0


def _sinks(hparams, device):
    main = prepare_process(hparams, device)
    return (get_logger(hparams.log_dir, to_file=main),
            get_summary_writer(hparams.summary_dir) if main else None)


def setup_fitting(hparams, device=None):
    logger, writer = _sinks(hparams, device)
    backbone = select_backbone(hparams)
    train_loader, val_loader = select_fitting_loader(hparams)
    return select_trainer(hparams, backbone, train_loader, val_loader,
                          logger, writer, device)


def setup_testing(hparams, device=None):
    logger, writer = _sinks(hparams, device)
    backbone = select_backbone(hparams)
    loader = select_testing_loader(hparams)
    return select_trainer(hparams, backbone, loader, None, logger, writer,
                          device)


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
