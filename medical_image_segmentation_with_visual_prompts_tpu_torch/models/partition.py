"""Name-based parameter partitioning: which parameters a trainer updates.

Counterpart of the JAX package's ``models/partition.py``, over the port's
parameter names (the reference's torch keys).  Labels:

* ``encoder_body`` / ``decoder_body``: input layer, Swin block bodies,
  merges / bottleneck, skip blocks, up-block and output-layer bodies;
* ``encoder_bias_content`` / ``decoder_bias_content``: the RelativePE
  content embeddings and weights;
* ``encoder_prompt`` / ``decoder_prompt``: the prompt tokens (the
  output layer's ``prompt_tokens.out`` are decoder ones) and the
  RelativePE token bias (``enc_token``, ``weights_token``);
* ``head_downstream``: the downstream segmentation head.

Downstream training updates the prompts of the active prompt sets and
the downstream head (:func:`downstream_labels`); :func:`set_trainable`
freezes everything else with ``requires_grad_(False)``.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from torch import nn

_ENCODER_PREFIXES = ("input_layer", "encoder_blocks")
_DECODER_PREFIXES = ("bottleneck", "residual_blocks", "decoder_blocks",
                     "output_layer")
_PE_TOKEN = ("enc_token", "weights_token")


def label_of(name: str) -> str:
    """Partition label of one parameter name."""
    if name.startswith("prompt_tokens.enc"):
        return "encoder_prompt"
    if name.startswith(("prompt_tokens.dec", "prompt_tokens.out")):
        return "decoder_prompt"
    if name.startswith("extra_heads.downstream"):
        return "head_downstream"
    if name.startswith(_ENCODER_PREFIXES):
        side = "encoder"
    elif name.startswith(_DECODER_PREFIXES):
        side = "decoder"
    else:
        raise ValueError(f"Unrecognized parameter name: {name}")
    parts = name.split(".")
    if "pe" in parts:
        leaf = parts[parts.index("pe") + 1]
        return f"{side}_prompt" if leaf in _PE_TOKEN \
            else f"{side}_bias_content"
    return f"{side}_body"


def downstream_labels(conf) -> Set[str]:
    """Labels the downstream trainer updates."""
    labels = {"head_downstream"}
    if conf.use_encoder_prompting:
        labels.add("encoder_prompt")
    if conf.use_decoder_prompting:
        labels.add("decoder_prompt")
    return labels


def set_trainable(model: nn.Module, labels: Set[str]
                  ) -> List[Tuple[str, nn.Parameter]]:
    """Freeze every parameter whose label is not in ``labels``; return
    the trainable ``(name, parameter)`` pairs."""
    trainable = []
    for name, p in model.named_parameters():
        keep = label_of(name) in labels
        p.requires_grad_(keep)
        if keep:
            trainable.append((name, p))
    return trainable
