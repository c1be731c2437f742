"""The name map between the port's state dict and the flax variables tree.

The port's module attributes carry the reference's torch key names, which
are the torch side of the JAX package's ``utils/torch_import.py::
build_key_rules``.  This module keeps its own copy of that rules table
(torch key -> collection, flax path, layout transform) and derives the
two directions from it:

* :func:`to_flax_variables`: the port's state dict as the flax variables
  tree (``{'params', 'batch_stats'}``), numpy float32 in the flax
  layouts (conv HWDIO, linear (in, out), per-prompt ``enc_token`` stacked);
* :func:`load_flax_variables`: the inverse, into a model in place.

Both are exact (transposes, flips and stacks of float32).  Checkpoints of
the JAX package's msgpack family (``utils/checkpoint.py``) cross with
them; the optimizer state maps through :func:`flax_paths`.

:func:`main` is the JAX package's ``torch_import`` CLI (a reference
``.pt`` -> a msgpack checkpoint, through the port's model): ``python -m
medical_image_segmentation_with_visual_prompts_tpu_torch.utils.torch_import
<src.pt> <dst.ckpt> --configs <yml> [--training-mode MODE] [--strict]``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _conv_w(a):        # [Cout, Cin, kh, kw, kd] -> [kh, kw, kd, Cin, Cout]
    return np.transpose(a, (2, 3, 4, 1, 0))


def _convT_w(a):
    """[Cin, Cout, kh, kw, kd] -> flax ConvTranspose HWDIO, spatially
    mirrored (flax applies the kernel mirrored relative to torch)."""
    return np.transpose(a, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]


def _lin_w(a):         # [out, in] -> [in, out]
    return np.transpose(a, (1, 0))


def _ident(a):
    return a


_INVERSE = {
    _ident: _ident,
    _lin_w: _lin_w,
    _conv_w: lambda a: np.transpose(a, (4, 3, 0, 1, 2)),
    _convT_w: lambda a: np.transpose(a[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)),
}


def _swin_block_rules(prefix: str, ours: str, max_prompts: int,
                      tokens: bool):
    """One Swin block's rules.  Without ``tokens`` (its side's prompting
    off) the flax block builds no positional token bias, so the port's
    ``pe.weights_token`` / ``pe.enc_token.*`` map to no leaf (None)."""
    rules = {
        f"{prefix}.attn_norm.weight": ("params", f"{ours}/attn_norm/scale",
                                       _ident),
        f"{prefix}.attn_norm.bias": ("params", f"{ours}/attn_norm/bias",
                                     _ident),
        f"{prefix}.attn.to_q.weight": ("params", f"{ours}/attn/to_q_kernel",
                                       _lin_w),
        f"{prefix}.attn.to_k.weight": ("params", f"{ours}/attn/to_k_kernel",
                                       _lin_w),
        f"{prefix}.attn.to_v.weight": ("params", f"{ours}/attn/to_v_kernel",
                                       _lin_w),
        f"{prefix}.attn.proj.weight": ("params", f"{ours}/attn/proj/kernel",
                                       _lin_w),
        f"{prefix}.attn.proj.bias": ("params", f"{ours}/attn/proj/bias",
                                     _ident),
        f"{prefix}.mlp_norm.weight": ("params", f"{ours}/mlp_norm/scale",
                                      _ident),
        f"{prefix}.mlp_norm.bias": ("params", f"{ours}/mlp_norm/bias",
                                    _ident),
        f"{prefix}.mlp.weight": ("params", f"{ours}/mlp/kernel", _lin_w),
        f"{prefix}.mlp.bias": ("params", f"{ours}/mlp/bias", _ident),
    }
    for axis in "hwd":
        rules[f"{prefix}.pe.enc_content_{axis}"] = (
            "params", f"{ours}/pe/enc_content_{axis}", _ident)
        rules[f"{prefix}.pe.weights_content_{axis}"] = (
            "params", f"{ours}/pe/weights_content_{axis}", _ident)
        rules[f"{prefix}.pe.relative_dist_{axis}"] = None   # derived buffer
    rules[f"{prefix}.pe.weights_token"] = (
        "params", f"{ours}/pe/weights_token", _ident) if tokens else None
    for k in range(max_prompts):
        rules[f"{prefix}.pe.enc_token.{k}"] = (
            "params", f"{ours}/pe/enc_token", ("stack", k)) \
            if tokens else None
    return rules


def _batchnorm_rules(prefix: str, ours: str):
    return {
        f"{prefix}.weight": ("params", f"{ours}/scale", _ident),
        f"{prefix}.bias": ("params", f"{ours}/bias", _ident),
        f"{prefix}.running_mean": ("batch_stats", f"{ours}/mean", _ident),
        f"{prefix}.running_var": ("batch_stats", f"{ours}/var", _ident),
        f"{prefix}.num_batches_tracked": None,
    }


def _conv_rules(prefix: str, ours: str):
    return {
        f"{prefix}.weight": ("params", f"{ours}/Conv_0/kernel", _conv_w),
        f"{prefix}.bias": ("params", f"{ours}/Conv_0/bias", _ident),
    }


def _basic_block_rules(prefix: str, ours: str, res_block: bool,
                       project: bool, layer: str = "layer"):
    """The convs of a UNETR conv block: ``conv1``, ``conv2`` and, in a
    residual block whose input and output channel counts differ, the 1x1
    projection ``conv3``.  ``layer`` is the wrapper level of a
    ``UnetrBasicBlock`` (``""`` for an up block's ``conv_block``, which
    has none).  The instance norms have no parameters."""
    convs = ("conv1", "conv2", "conv3") if res_block and project \
        else ("conv1", "conv2")
    tp, op = (f"{prefix}.{layer}", f"{ours}/{layer}") if layer \
        else (prefix, ours)
    rules = {}
    for c in convs:
        rules.update({
            f"{tp}.{c}.conv.weight": (
                "params", f"{op}/{c}/Conv_0/kernel", _conv_w),
            f"{tp}.{c}.conv.bias": (
                "params", f"{op}/{c}/Conv_0/bias", _ident),
        })
    return rules


def build_key_rules(conf) -> Dict[str, Tuple]:
    """torch state-dict key -> (collection, 'a/b/c' flax path, transform
    or ``("stack", k)``), or None for a tensor with no flax leaf (a derived
    buffer; the positional token bias of a block whose side has prompting
    off, which the flax model does not build); every training mode and
    decoder layout of the JAX package.

    The UNETR blocks' rules follow the flax tree the JAX model builds,
    where the JAX package's own table does not: an up block's
    ``conv_block`` has no ``layer`` level, and ``conv3`` exists only where
    a residual block changes the channel count."""
    depth = conf.depth_unet
    mode = conf.training_mode
    needs_decoder = mode != "self_supervised_learning_encoder"
    mp = conf.max_prompts
    rules: Dict[str, Tuple] = {}

    rules.update(_conv_rules("input_layer.0", "input_layer_conv"))
    rules.update(_batchnorm_rules("input_layer.1", "input_layer_norm"))
    for i in range(depth):
        for j in range(2):
            rules.update(_swin_block_rules(
                f"encoder_blocks.{i}.swin_blocks.{j}",
                f"encoder_blocks_{i}/swin_blocks_{j}", mp,
                conf.use_encoder_prompting))
        rules.update({
            f"encoder_blocks.{i}.merge.norm.weight": (
                "params", f"encoder_blocks_{i}/merge/norm/scale", _ident),
            f"encoder_blocks.{i}.merge.norm.bias": (
                "params", f"encoder_blocks_{i}/merge/norm/bias", _ident),
            f"encoder_blocks.{i}.merge.reduction.weight": (
                "params", f"encoder_blocks_{i}/merge/reduction/kernel",
                _lin_w),
        })

    if conf.use_encoder_prompting:
        for i in range(2 * depth):
            rules[f"prompt_tokens.enc.{i}"] = (
                "params", f"prompt_tokens_enc_{i}", _ident)
    if needs_decoder and conf.use_decoder_prompting:
        for i in range(2 * depth):
            rules[f"prompt_tokens.dec.{i}"] = (
                "params", f"prompt_tokens_dec_{i}", _ident)
        if conf.unetr_res_block != "none" and conf.unetr_up_block == "swin":
            for i in range(2):
                rules[f"prompt_tokens.out.{i}"] = (
                    "params", f"prompt_tokens_out_{i}", _ident)

    if mode == "self_supervised_learning_encoder":
        if conf.use_reconstruction or conf.use_mutual_learning:
            for i in range(depth + 1):
                rules.update(_conv_rules(
                    f"extra_heads.reconstruction.{4 * i}",
                    f"head_reconstruction/conv_{i}"))
            rules.update(_conv_rules(
                f"extra_heads.reconstruction.{4 * (depth + 1)}",
                "head_reconstruction/conv_out"))
        if conf.use_rotation_prediction:
            rules["extra_heads.rotation_prediction.weight"] = (
                "params", "head_rotation/kernel", _lin_w)
            rules["extra_heads.rotation_prediction.bias"] = (
                "params", "head_rotation/bias", _ident)
        if conf.use_contrastive_learning:
            rules["extra_heads.contrastive_coding.weight"] = (
                "params", "head_contrastive/kernel", _lin_w)
            rules["extra_heads.contrastive_coding.bias"] = (
                "params", "head_contrastive/bias", _ident)

    if needs_decoder:
        if conf.unetr_res_block == "full":
            rules.update(_basic_block_rules("bottleneck", "bottleneck",
                                            conf.basic_block_res, False))
        else:
            rules.update(_conv_rules("bottleneck", "bottleneck"))
        for i in range(depth + 1):
            if conf.unetr_res_block == "full":
                # Only the last one (the raw input) may change channels.
                rules.update(_basic_block_rules(
                    f"residual_blocks.{i}", f"residual_blocks_{i}",
                    conf.basic_block_res,
                    i == depth and conf.input_channels !=
                    conf.hidden_channels[0]))
            elif conf.unetr_res_block == "simple":
                rules.update(_conv_rules(f"residual_blocks.{i}",
                                         f"residual_blocks_{i}"))
        ups = [(f"decoder_blocks.{i}", f"decoder_blocks_{i}")
               for i in range(depth)]
        if conf.unetr_res_block != "none":
            ups.append(("output_layer", "output_layer"))
        for tprefix, oprefix in ups:
            if conf.unetr_up_block == "swin":
                rules.update(_batchnorm_rules(f"{tprefix}.norm_concat",
                                              f"{oprefix}/norm_concat"))
                rules.update({
                    f"{tprefix}.conv_concat.conv.weight": (
                        "params", f"{oprefix}/conv_concat/Conv_0/kernel",
                        _conv_w),
                    f"{tprefix}.conv_concat.conv.bias": (
                        "params", f"{oprefix}/conv_concat/Conv_0/bias",
                        _ident),
                })
                for j in range(2):
                    rules.update(_swin_block_rules(
                        f"{tprefix}.swin_layer.swin_blocks.{j}",
                        f"{oprefix}/swin_layer/swin_blocks_{j}", mp,
                        conf.use_decoder_prompting))
            else:
                rules.update({
                    f"{tprefix}.transp_conv.conv.weight": (
                        "params",
                        f"{oprefix}/transp_conv/ConvTranspose_0/kernel",
                        _convT_w),
                    f"{tprefix}.transp_conv.conv.bias": (
                        "params",
                        f"{oprefix}/transp_conv/ConvTranspose_0/bias",
                        _ident),
                })
                # conv_block: 2C (upsampled, skip) -> C, no wrapper level.
                rules.update(_basic_block_rules(
                    f"{tprefix}.conv_block", f"{oprefix}/conv_block",
                    conf.res_block, True, layer=""))
        heads = []
        if mode in ("supervised_learning_decoder", "supervised_learning_all"):
            heads.append(("extra_heads.segmentation", "head_segmentation"))
        if mode == "downstream":
            heads.append(("extra_heads.downstream", "head_downstream"))
        for tprefix, oprefix in heads:
            rules.update(_batchnorm_rules(f"{tprefix}.0", f"{oprefix}/norm"))
            rules.update({
                f"{tprefix}.1.weight": (
                    "params", f"{oprefix}/conv_kernel", _conv_w),
                f"{tprefix}.1.bias": (
                    "params", f"{oprefix}/conv_bias", _ident),
            })
    return rules


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path in sorted(flat, key=lambda p: tuple(p.split("/"))):
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[path]
    return tree


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def flax_paths(model, names) -> List[Tuple[str, List[Tuple[str, object]]]]:
    """The flax parameter leaves that the torch parameters ``names``
    make up, in the flax tree's leaf order (paths sorted component-wise):
    ``[(path, [(torch name, transform or ("stack", k)), ...]), ...]``."""
    rules = build_key_rules(model.conf)
    by_path: Dict[str, list] = {}
    for name in names:
        rule = rules.get(name)
        if rule is None or rule[0] != "params":
            raise KeyError(f"{name} has no flax parameter leaf")
        by_path.setdefault(rule[1], []).append((name, rule[2]))
    return sorted(by_path.items(), key=lambda kv: tuple(kv[0].split("/")))


def to_flax(parts, arrays) -> np.ndarray:
    """One flax leaf from its torch tensors' arrays (``parts`` as
    :func:`flax_paths` gives them, ``arrays`` by torch name)."""
    if isinstance(parts[0][1], tuple):       # per-prompt tensors, stacked
        return np.stack([arrays[n] for n, _ in
                         sorted(parts, key=lambda p: p[1][1])])
    (name, tf), = parts
    return tf(arrays[name])


def from_flax(tf, value: np.ndarray) -> np.ndarray:
    """The torch tensor of one rule (transform or ``("stack", k)``) from
    its flax leaf."""
    if isinstance(tf, tuple):
        return value[tf[1]]
    return _INVERSE[tf](value)


def to_flax_variables(model) -> dict:
    """The model's state as the flax variables tree: numpy float32 leaves
    in the flax layouts, dicts in sorted key order."""
    rules = build_key_rules(model.conf)
    arrays = {k: v.detach().to("cpu", torch.float32).numpy()
              for k, v in model.state_dict().items() if rules.get(k)}
    missing = [k for k, r in rules.items() if r and k not in arrays]
    if missing:
        raise KeyError(f"the model has no tensors for {missing[:5]}")
    groups: Dict[Tuple[str, str], list] = {}
    for key, (coll, path, tf) in ((k, r) for k, r in rules.items() if r):
        groups.setdefault((coll, path), []).append((key, tf))
    flat: Dict[str, Dict[str, np.ndarray]] = {}
    for (coll, path), parts in groups.items():
        flat.setdefault(coll, {})[path] = np.ascontiguousarray(
            to_flax(parts, arrays), np.float32)
    return {c: _unflatten(flat[c]) for c in sorted(flat)}


@torch.no_grad()
def load_flax_variables(model, variables: dict) -> None:
    """Copy a flax variables tree into the model in place (every rule's
    leaf must be there, with the model's shapes).  BatchNorm
    ``num_batches_tracked`` counters, which flax does not keep, and the
    tensors whose rule is None stay."""
    rules = build_key_rules(model.conf)
    flat = {c: _flatten(variables.get(c, {}))
            for c in ("params", "batch_stats")}
    own = model.state_dict()
    extra = [k for k in own if k not in rules
             and not k.endswith("num_batches_tracked")]
    if extra:
        raise KeyError(f"no flax leaf maps to {extra[:5]}")
    for key, rule in rules.items():
        if rule is None:
            continue
        coll, path, tf = rule
        if key not in own:
            raise KeyError(f"the model has no tensor {key}")
        if path not in flat[coll]:
            raise KeyError(f"{key} <- {coll}/{path}: not in the variables")
        value = from_flax(tf, np.asarray(flat[coll][path]))
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{key} <- {coll}/{path}: shape "
                             f"{tuple(value.shape)} != "
                             f"{tuple(own[key].shape)}")
        own[key].copy_(torch.from_numpy(np.array(value, np.float32)))


def main(argv=None) -> None:
    """CLI: a reference ``.pt`` -> a msgpack checkpoint (the port's codec,
    the JAX package's format): ``src dst --configs <yml>
    [--training-mode MODE] [--strict]``.  The tensors that have a flax
    leaf load into the seeded port model, whose :func:`to_flax_variables`
    is written; the report counts as the JAX package's CLI does."""
    import argparse

    from ..config import ModelConfig, load_conf
    from ..models import SwinUnetR
    from .checkpoint import save_checkpoint
    from .weights import init_weights, load_reference_checkpoint

    ap = argparse.ArgumentParser(
        description="Convert a reference PyTorch checkpoint to the msgpack "
                    "checkpoint format.")
    ap.add_argument("src", help="reference .pt/.pth checkpoint")
    ap.add_argument("dst", help="output checkpoint directory/file")
    ap.add_argument("--configs", required=True, help="model config YAML")
    ap.add_argument("--training-mode", default=None)
    ap.add_argument("--strict", action="store_true",
                    help="fail when torch keys are unmatched")
    args = ap.parse_args(argv)

    conf = load_conf(args.configs)
    if args.training_mode:
        conf["training_mode"] = args.training_mode
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    init_weights(model, torch.Generator().manual_seed(0))
    rules = build_key_rules(model.conf)
    sd = load_reference_checkpoint(args.src, derived=True)
    imported = {k: v for k, v in sd.items() if rules.get(k)}
    skipped = [k for k in sd if k in rules and rules[k] is None]
    unmatched = [k for k in sd if k not in rules]
    leaves = lambda keys: {rules[k][:2] for k in keys if rules[k]}  # noqa
    unfilled = leaves(rules) - leaves(imported)
    print(f"imported {len(imported)} tensors; skipped {len(skipped)} "
          f"buffers; {len(unmatched)} unmatched torch keys; "
          f"{len(unfilled)} params left at init")
    for k in unmatched:
        print("  unmatched:", k)
    if args.strict and unmatched:
        raise SystemExit(1)
    model.load_state_dict(imported, strict=False)
    save_checkpoint(args.dst, 0, to_flax_variables(model), None,
                    {"epoch": 0})
    print(f"wrote {args.dst}")

if __name__ == "__main__":
    main()
