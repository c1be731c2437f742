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
* ``head_ssl``: the phase-1 reconstruction, rotation and contrastive
  heads;
* ``head_segmentation``: the supervised phase-2 segmentation head;
* ``head_downstream``: the downstream segmentation head.

Downstream training updates the prompts of the active prompt sets and
the downstream head (:func:`downstream_labels`); phase 1 updates the
encoder, its heads and, with encoder prompting, the encoder prompts;
phase 2 updates the decoder (``_decoder`` modes) or everything (``_all``
modes) with the active prompt sets (:func:`trainable_labels`, the JAX
group builders, including their edge case: the encoder prompts stay
frozen in the ``_decoder`` modes).  :func:`set_trainable` freezes everything else with
``requires_grad_(False)``.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from torch import nn

from ..config import PHASE1_MODE, SUPERVISED_MODES

_ENCODER_PREFIXES = ("input_layer", "encoder_blocks")
_DECODER_PREFIXES = ("bottleneck", "residual_blocks", "decoder_blocks",
                     "output_layer")
_PE_TOKEN = ("enc_token", "weights_token")
_SSL_HEADS = tuple(f"extra_heads.{h}." for h in (
    "reconstruction", "rotation_prediction", "contrastive_coding"))


def label_of(name: str) -> str:
    """Partition label of one parameter name."""
    if name.startswith("prompt_tokens.enc"):
        return "encoder_prompt"
    if name.startswith(("prompt_tokens.dec", "prompt_tokens.out")):
        return "decoder_prompt"
    if name.startswith("extra_heads.downstream"):
        return "head_downstream"
    if name.startswith("extra_heads.segmentation"):
        return "head_segmentation"
    if name.startswith(_SSL_HEADS):
        return "head_ssl"
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


def encoder_labels(conf, include_prompt_tokens: bool = False) -> Set[str]:
    """The encoder's labels (the reference's ``named_parameters_encoder``),
    with the proxy heads in the phase-1 mode."""
    labels = {"encoder_body", "encoder_bias_content"}
    if include_prompt_tokens and conf.use_encoder_prompting:
        labels.add("encoder_prompt")
    if conf.training_mode == PHASE1_MODE:
        labels.add("head_ssl")
    return labels


def decoder_labels(conf, include_prompt_tokens: bool = False) -> Set[str]:
    """The decoder's labels (``named_parameters_decoder``), with the
    segmentation head in the supervised modes."""
    labels = {"decoder_body", "decoder_bias_content"}
    if include_prompt_tokens and conf.use_decoder_prompting:
        labels.add("decoder_prompt")
    if conf.training_mode in SUPERVISED_MODES:
        labels.add("head_segmentation")
    return labels


def trainable_labels(conf) -> Set[str]:
    """Labels updated in each training mode the port trains."""
    mode = conf.training_mode
    if mode == PHASE1_MODE:
        return encoder_labels(conf, include_prompt_tokens=True)
    if mode in ("self_supervised_learning_decoder",
                "supervised_learning_decoder"):
        return decoder_labels(conf, include_prompt_tokens=True)
    if mode in ("self_supervised_learning_all", "supervised_learning_all"):
        return (encoder_labels(conf, include_prompt_tokens=True)
                | decoder_labels(conf, include_prompt_tokens=True))
    if mode == "downstream":
        return downstream_labels(conf)
    raise ValueError(f"Training mode {mode} not available!")


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
