"""Frozen work arithmetic: the model FLOPs of a forward and of a training
step, and the model-level work of the block kernels, all from the
configuration's shapes; and the card's published peaks.

Products only, two FLOPs per multiply-add.  The forward count is the
model count of the program's ``utils/flops.py::forward_flops`` at the
time this benchmark was defined (windows padded as ``pad_mode`` pads
them, prompt K/V once per block call, no bias tables or interpolation
matrices), extended by the phase-1 heads.  It does not move when an
implementation folds a padding away or caches an operand.

A training step is the forward plus, layer by layer in forward order,
the input gradient of every layer that has a trainable tensor at or
before it (two products for an attention product of two activations,
one for a layer with weights) and the weight gradient of every layer
whose weights are trained.  Recompute (remat) is not counted.

A block kernel's model-level work: B1, one Swin block forward (q, k, v,
projection and MLP over the padded windows' rows, the prompt K/V rows,
the two attention products); its bytes the bf16 input read and output
written, the bf16 weights read.  B4, one block backward as the algorithm
needs it from its saved inputs: the forward again, the input gradient
(the linears once, the attention products twice) and, where the block's
weights are trained, their gradient; bytes the bf16 input and output
gradient read, the input gradient written, the weights read and (if
trained) their fp32 gradient written.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

# Dense bf16 tensor-core TFLOP/s (no sparsity) and memory TB/s, NVIDIA
# H100 data sheet, by torch.cuda.get_device_name().
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4, "NVIDIA H100 NVL": 835.0,
               "NVIDIA H100 PCIe": 756.0}
PEAK_TBYTES = {"NVIDIA H100 80GB HBM3": 3.35, "NVIDIA H100 NVL": 3.9,
               "NVIDIA H100 PCIe": 2.0}
BF16 = 2
PHASE1 = "self_supervised_learning_encoder"


@dataclasses.dataclass
class Layer:
    name: str
    flops: int
    kind: str       # "weight": activation x weight; "act": two activations
    label: str      # encoder_body | encoder_prompt | decoder_body |
    #                 decoder_prompt | head_downstream | head_ssl


@dataclasses.dataclass
class BlockCall:
    """One Swin block call: its model-level forward parts and bytes."""
    lin: int        # q, k, v, projection, MLP over the padded rows
    kv: int         # prompt K/V rows
    att: int        # the two attention products
    act_bytes: int  # bf16 input + output
    w_bytes: int    # bf16 weights
    label: str      # encoder_body | decoder_body


def _vol(d) -> int:
    return int(math.prod(d))


def paddings(dims, ws, mode: str):
    if mode == "reference" and not any(d % w for d, w in zip(dims, ws)):
        return (0,) * 6
    out = []
    for d, w in zip(dims, ws):
        t = (w - d % w) if mode == "reference" else (w - d % w) % w
        out += [t - t // 2, t // 2] if mode == "reference" else \
            [t // 2, t - t // 2]
    return tuple(out)


def block_call(b: int, dims, c: int, conf: dict, tokens: int,
               label: str) -> BlockCall:
    ws = tuple(conf["attn_window_size"])
    pads = paddings(dims, ws, conf["pad_mode"])
    padded = [d + pads[2 * i] + pads[2 * i + 1] for i, d in enumerate(dims)]
    m = _vol(ws)
    rows = b * (_vol(padded) // m) * m
    return BlockCall(10 * rows * c * c, 4 * tokens * c * c,
                     4 * rows * (m + tokens) * c,
                     2 * BF16 * b * _vol(dims) * c, 5 * BF16 * c * c, label)


def _conv(b, dims, k, cin, cout) -> int:
    return 2 * b * _vol(dims) * k ** 3 * cin * cout


def layers(conf: dict, batch: int, roi: Sequence[int]):
    """(layers in forward order, block calls) of one forward of ``batch``
    crops at ``roi``."""
    mode = conf["training_mode"]
    depth, hc = conf["depth_unet"], list(conf["hidden_channels"])
    b = int(batch)
    enc_tok = conf["tokens_per_prompt_encoder"] \
        if conf["use_encoder_prompting"] else 0
    dec_tok = conf["tokens_per_prompt_decoder"] \
        if conf["use_decoder_prompting"] and mode != PHASE1 else 0
    out: List[Layer] = []
    calls: List[BlockCall] = []
    dims = tuple(int(s) // p for s, p in zip(roi, conf["input_patch_size"]))
    out.append(Layer("patch_embed", 2 * b * _vol(dims)
                     * _vol(conf["input_patch_size"])
                     * conf["input_channels"] * hc[0], "weight",
                     "encoder_body"))

    def pair(part, dims, c, heads, tokens, side):
        for i in range(2):
            bc = block_call(b, dims, c, conf, tokens, f"{side}_body")
            calls.append(bc)
            # q, k, v (6 of the 10 row products), then projection and
            # MLP (4), which take the attention's gradient.
            out.append(Layer(f"{part}.block{i}.qkv", 6 * bc.lin // 10,
                             "weight", f"{side}_body"))
            out.append(Layer(f"{part}.block{i}.prompt_kv", bc.kv, "weight",
                             f"{side}_prompt"))
            out.append(Layer(f"{part}.block{i}.attention", bc.att, "act",
                             f"{side}_body"))
            out.append(Layer(f"{part}.block{i}.out", 4 * bc.lin // 10,
                             "weight", f"{side}_body"))

    feats = [dims]
    for i in range(depth):
        pair(f"encoder{i}", dims, hc[i], conf["num_heads_encoder"] * 2 ** i,
             enc_tok, "encoder")
        even = [d + d % 2 for d in dims]
        merged = (even[0] // 2, even[1] // 2,
                  even[2] // 2 if i < 1 else even[2])
        out.append(Layer(f"encoder{i}.merge", 2 * b * _vol(merged)
                         * (8 if i < 1 else 4) * hc[i] * 2 * hc[i], "weight",
                         "encoder_body"))
        dims = merged
        feats.insert(0, dims)
    if mode == PHASE1:
        top = hc[depth]
        chs = [top // 2 ** i for i in range(depth + 1)] + [top // 2 ** depth]
        for i in range(depth + 1):
            out.append(Layer(f"reconstruction{i}",
                             _conv(b, dims, 3, chs[i], chs[i + 1]),
                             "weight", "head_ssl"))
            dims = (dims[0] * 2, dims[1] * 2,
                    dims[2] * (1 if i < depth - 1 else 2))
        out.append(Layer("reconstruction_out",
                         _conv(b, dims, 1, chs[-1], conf["input_channels"]),
                         "weight", "head_ssl"))
        out.append(Layer("rotation", 2 * b * top * 4, "weight", "head_ssl"))
        out.append(Layer("contrastive", 2 * b * top
                         * conf["contrastive_coding_dim"], "weight",
                         "head_ssl"))
        return out, calls
    c = hc[depth]
    out.append(Layer("bottleneck", _conv(b, dims, 3, c, c), "weight",
                     "decoder_body"))
    in_chs = hc[:depth][::-1]
    for j in range(depth):
        skip = feats[j + 1]
        out.append(Layer(f"decoder{j}.conv",
                         _conv(b, skip, 3, c + in_chs[j], in_chs[j]),
                         "weight", "decoder_body"))
        pair(f"decoder{j}", skip, in_chs[j], conf["num_heads_decoder"],
             dec_tok, "decoder")
        dims, c = skip, in_chs[j]
    dims = tuple(2 * d for d in dims)
    out.append(Layer("head", _conv(b, dims, 3, c,
                                   conf["output_channels_downstream"]),
                     "weight", "head_downstream"))
    return out, calls


def forward_flops(conf: dict, batch: int, roi) -> int:
    return sum(layer.flops for layer in layers(conf, batch, roi)[0])


def trained_labels(conf: dict) -> set:
    if conf["training_mode"] == PHASE1:
        return {"encoder_body", "encoder_prompt", "head_ssl"}
    return {"head_downstream", "encoder_prompt", "decoder_prompt"}


def step_flops(conf: dict, batch: int, roi) -> int:
    """Forward plus the backward products that the trained set needs."""
    trained = trained_labels(conf)
    total, upstream = 0, False
    for layer in layers(conf, batch, roi)[0]:
        total += layer.flops
        own = layer.label in trained
        if layer.kind == "act":
            total += 2 * layer.flops if upstream else 0
        else:
            total += layer.flops if upstream else 0      # input gradient
            total += layer.flops if own else 0           # weight gradient
        upstream = upstream or own
    return total


def b1_work(conf: dict, batch: int, roi) -> List[tuple]:
    """(flops, bytes) of each B1 call of one forward."""
    return [(c.lin + c.kv + c.att, c.act_bytes + c.w_bytes)
            for c in layers(conf, batch, roi)[1]]


def b4_work(conf: dict, batch: int, roi) -> List[tuple]:
    """(flops, bytes) of each B4 call of one training step."""
    trained = trained_labels(conf)
    out = []
    for c in layers(conf, batch, roi)[1]:
        own = c.label in trained
        flops = (c.lin + c.att) + (c.lin + 2 * c.att) + (c.lin if own else 0)
        nbytes = 3 * c.act_bytes // 2 + c.w_bytes + \
            (2 * c.w_bytes if own else 0)
        out.append((flops, nbytes))
    return out


def bound_seconds(work, peak_tflops: float, peak_tbytes: float) -> float:
    """The least time of the calls ``work`` [(flops, bytes)]: per call
    the larger of FLOPs over the peak and bytes over the memory rate."""
    return sum(max(f / (peak_tflops * 1e12), n / (peak_tbytes * 1e12))
               for f, n in work)
