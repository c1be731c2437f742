"""Frozen work arithmetic of MedSAM (SAM ViT-B, one box per slice): the
model FLOPs of a served study and the work of each call of the image
encoder's attention core, from the configuration's sizes alone.

Products only, two FLOPs per multiply-add.  The study count is the model
count of the program's ``utils/flops.py::medsam_forward_flops`` at the
time this benchmark was defined: the three-channel patch embed; per
encoder block the qkv and projection linears over every row of the
windows (the 64x64 grid zero-padded to 70x70 in the windowed blocks),
the MLP over the grid, the two attention products and the two ``q . R``
products of the decomposed relative bias (a materialised bias is an
implementation's choice and not counted); the neck; the box's and the
grid's Fourier features; per prompt the two-way transformer, the
upscaling (a transposed conv at its true multiply-adds), the
hypernetwork MLPs, the masks' product and the IoU head.

An attention core call (after the qkv projection, before ``proj``):
FLOPs of ``q k^T``, ``p v`` and the two ``q . R`` products over the
call's windows and heads; bytes: q, k, v read and the output written in
the compute dtype over the call's rows (padding rows included), and the
two tables read.  The same work whatever implements it.
"""

from __future__ import annotations

from typing import List

_SIZES = ("image_size", "patch_size", "in_chans", "encoder_embed_dim",
          "encoder_depth", "encoder_num_heads", "encoder_global_attn_indexes",
          "window_size", "mlp_ratio", "prompt_embed_dim", "decoder_depth",
          "decoder_mlp_dim", "num_multimask_outputs", "iou_head_depth",
          "iou_head_hidden_dim", "attention_downsample_rate")


def _blocks(conf: dict):
    """(side, windows per image) of each encoder block."""
    g = conf["image_size"] // conf["patch_size"]
    ws = conf["window_size"]
    gp = -(-g // ws) * ws
    glob = set(conf["encoder_global_attn_indexes"])
    return [(g, 1) if i in glob else (ws, (gp // ws) ** 2)
            for i in range(conf["encoder_depth"])]


def study_flops(conf: dict, slices: int) -> int:
    """Model FLOPs of one study of ``slices`` slices, one box each."""
    missing = [k for k in _SIZES if k not in conf]
    if missing:
        raise KeyError(f"configuration lacks {missing}")
    n = int(slices)
    dim = conf["encoder_embed_dim"]
    g = conf["image_size"] // conf["patch_size"]
    heads = conf["encoder_num_heads"]
    hd = dim // heads
    tokens = g * g
    mlp = int(dim * conf["mlp_ratio"])
    total = 2 * n * tokens * conf["in_chans"] * conf["patch_size"] ** 2 * dim
    for side, windows in _blocks(conf):
        rows = windows * side * side
        total += 2 * n * (rows * dim * 4 * dim + tokens * dim * mlp * 2)
        total += n * windows * heads * 4 * hd * (side ** 4 + side ** 3)
    out = conf["prompt_embed_dim"]
    total += 2 * n * tokens * (dim * out + 9 * out * out)
    total += 2 * (2 * n + tokens) * 2 * (out // 2)
    t = 4 + conf["num_multimask_outputs"]
    inner = out // conf["attention_downsample_rate"]

    def cross(nq, nk):
        return 2 * (nq * out * inner + 2 * nk * out * inner
                    + 2 * nq * nk * inner + nq * inner * out)

    dec = 0
    for _ in range(conf["decoder_depth"]):
        dec += 2 * (4 * t * out * out + 2 * t * t * out)
        dec += cross(t, tokens) + cross(tokens, t)
        dec += 4 * t * out * conf["decoder_mlp_dim"]
    dec += cross(t, tokens)
    masks = conf["num_multimask_outputs"] + 1
    dec += 2 * tokens * out * (out // 4) * 4
    dec += 2 * 4 * tokens * (out // 4) * (out // 8) * 4
    dec += masks * 2 * out * (2 * out + out // 8)
    dec += 2 * masks * (out // 8) * 16 * tokens
    hid = conf["iou_head_hidden_dim"]
    dec += 2 * (out * hid + (conf["iou_head_depth"] - 2) * hid * hid
                + hid * masks)
    return total + n * dec


def attention_work(conf: dict, slices: int, batch: int) -> List[tuple]:
    """(flops, bytes) of each attention core call of one study of
    ``slices`` slices, the encoder run ``batch`` slices at a time."""
    dim = conf["encoder_embed_dim"]
    heads = conf["encoder_num_heads"]
    hd = dim // heads
    item = 2 if conf["compute_dtype"] == "bfloat16" else 4
    out = []
    for s in range(0, int(slices), int(batch)):
        b = min(int(batch), int(slices) - s)
        for side, windows in _blocks(conf):
            flops = b * windows * heads * 4 * hd * (side ** 4 + side ** 3)
            nbytes = 4 * b * windows * side * side * dim * item \
                + 2 * (2 * side - 1) * hd * item
            out.append((flops, nbytes))
    return out
