"""Logging of the training CLI: a file and console logger, and a scalar
summary writer.

Counterpart of the JAX package's ``utils/loggers.py``: ``log.txt`` in the
run's log directory plus the console, and ``scalars.jsonl`` plus a
TensorBoard event file (``utils/tb_events.py``; off with
``MIVP_TENSORBOARD=0``) in its summary directory.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

LOG_FORMAT = ("Time: %(asctime)s | Logger: %(name)s | "
              "Level: %(levelname)s | Message: %(message)s")


def get_logger(log_dir, name: str = "Root", to_file: bool = True
               ) -> logging.Logger:
    """``log_dir/log.txt`` (appended) and console logger; a second call
    with the same name replaces the first one's handlers.  ``to_file``
    False (a data-parallel rank other than 0): a silent logger, and
    nothing is written."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if not to_file:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger
    logger.propagate = True
    log_dir = Path(log_dir)
    log_dir.mkdir(exist_ok=True, parents=True)
    for handler in (logging.FileHandler(log_dir / "log.txt", mode="a"),
                    logging.StreamHandler()):
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        logger.addHandler(handler)
    return logger


class SummaryWriter:
    """``add_scalar`` to ``scalars.jsonl`` and, unless
    ``MIVP_TENSORBOARD=0``, a TensorBoard event file."""

    def __init__(self, summary_dir):
        self.summary_dir = Path(summary_dir)
        self.summary_dir.mkdir(exist_ok=True, parents=True)
        self._file = open(self.summary_dir / "scalars.jsonl", "a")
        self._tb = None
        if os.environ.get("MIVP_TENSORBOARD", "1") != "0":
            from .tb_events import EventWriter
            self._tb = EventWriter(self.summary_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(step),
                                     "wall_time": time.time()}) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()



def get_summary_writer(summary_dir) -> SummaryWriter:
    """The run's scalar summary writer (the JAX package's factory)."""
    return SummaryWriter(summary_dir)
