"""Training CLI of the PyTorch port: ``--mode fit|test``.

Counterpart of the JAX package's ``main.py``, flag for flag, plus
``--device`` (default ``cuda``; it raises without a card unless given
``--device cpu``).  The YAML file of ``--configs`` carries the rest and
wins over the command line (``config.get_full_configs``).  Checkpoints
are the JAX package's msgpack family, so either CLI resumes, tests or
serves the other's.  ``distributed`` and ``mesh_data`` in the YAML run
it data parallel, one process per device (``torchrun --nproc-per-node
N``, or the ``distributed`` keys): the process group starts and
``mesh_data`` is checked against the world before anything is read or
written, and only rank 0 writes.

Run as ``python -m medical_image_segmentation_with_visual_prompts_tpu_torch.main``.
"""

from __future__ import annotations

from argparse import ArgumentParser, Namespace

from .config import get_full_configs
from .utils.device import resolve_device
from .utils.initialization import setup_fitting, setup_testing


def main(mode: str, hparams: Namespace, device=None):
    """Fit or test with ``hparams`` (from :func:`get_full_configs`) on
    ``device`` (the card unless ``"cpu"``: without one it raises before
    anything is read or written); returns the trainer."""
    device = resolve_device(device)
    if mode == "fit":
        trainer = setup_fitting(hparams, device)
        trainer.train()
    elif mode == "test":
        trainer = setup_testing(hparams, device)
        trainer.test()
    else:
        raise ValueError("The mode is not available.")
    return trainer


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--mode", default="fit", type=str)
    parser.add_argument("--training-mode",
                        default="self_supervised_learning_all", type=str)
    parser.add_argument("--configs", default="example_configs.yml", type=str)
    for family in ("backbone", "prompt-tokens"):
        for op in ("load", "save"):
            parser.add_argument(f"--{op}-ckpt-{family}", action="store_true",
                                default=False)
            parser.add_argument(f"--{op}-ckpt-{family}-path", default="",
                                type=str)
    parser.add_argument("--use-encoder-prompting", action="store_true",
                        default=False)
    parser.add_argument("--use-decoder-prompting", action="store_true",
                        default=False)
    parser.add_argument("--backbone", default="swin_unetr", type=str)
    parser.add_argument("--run-name", default="", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device (default: cuda; fails without a "
                             "card unless --device cpu)")
    return parser


def cli(argv=None) -> None:
    """Console entry point (``mivp-train-torch``)."""
    args = build_parser().parse_args(argv)
    main(args.mode, get_full_configs(args), args.device)


if __name__ == "__main__":
    cli()
