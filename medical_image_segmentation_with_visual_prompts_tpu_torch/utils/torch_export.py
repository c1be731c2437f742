"""Checkpoint converter: a msgpack checkpoint -> a reference-named ``.pt``.

Counterpart of the JAX package's ``utils/torch_export.py`` CLI.  The
checkpoint (either package's msgpack family) is restored into the port's
``SwinUnetR`` through the name map (``utils/torch_import.py``), whose
attributes carry the reference's torch key names, and its state dict is
written as ``{"model_state_dict": ...}``: float32 tensors in the
reference layouts, the BatchNorm ``num_batches_tracked`` counters as
int64 zeros, and no ``pe.relative_dist_*`` (derived buffers that the
reference's constructor rebuilds), as the JAX exporter writes them.  It
works in every decoder layout, where the JAX exporter's rules table
raises on the ``full`` and ``unetr`` ones.  A block's positional token
bias with its side's prompting off has no flax leaf; the port's tensor
is written, so that the file loads strictly into the port's model.

CLI::

    python -m medical_image_segmentation_with_visual_prompts_tpu_torch.utils.torch_export \\
        <src.ckpt> <dst.pt> --configs <yml> [--training-mode MODE]
"""

from __future__ import annotations

from typing import Dict

import torch

from .torch_import import build_key_rules


def export_state_dict(model) -> Dict[str, torch.Tensor]:
    """The reference-named state dict of the port's ``model`` (its
    configuration's rules table, in the table's order), on the CPU."""
    own = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, rule in build_key_rules(model.conf).items():
        if rule is None and key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.int64)
        elif ".pe.relative_dist_" not in key:
            out[key] = own[key].detach().to("cpu", torch.float32).clone()
    return out


def main(argv=None) -> None:
    import argparse

    from ..config import ModelConfig, load_conf
    from ..models import SwinUnetR
    from . import init_weights
    from .checkpoint import load_checkpoint, restore_like
    from .torch_import import load_flax_variables, to_flax_variables

    ap = argparse.ArgumentParser(
        description="Convert a msgpack checkpoint (either package's) to a "
                    "reference-named torch state_dict (.pt).")
    ap.add_argument("src", help="msgpack .ckpt (file or directory)")
    ap.add_argument("dst", help="output .pt path")
    ap.add_argument("--configs", required=True, help="model config YAML")
    ap.add_argument("--training-mode", default=None)
    args = ap.parse_args(argv)

    conf = load_conf(args.configs)
    if args.training_mode:
        conf["training_mode"] = args.training_mode
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    init_weights(model, torch.Generator().manual_seed(0))
    state = load_checkpoint(args.src)["model_state_dict"]
    load_flax_variables(model, restore_like(to_flax_variables(model), state))
    sd = export_state_dict(model)
    torch.save({"model_state_dict": sd}, args.dst)
    print(f"wrote {args.dst}: {len(sd)} tensors; load into the reference "
          "model with model.load_state_dict(sd, strict=False) — the "
          "pe.relative_dist_* buffers are rebuilt by its constructor.")


if __name__ == "__main__":
    main()
