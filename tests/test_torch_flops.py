"""PyTorch port: FLOP accounting (``utils/flops.py``).

``forward_flops`` counts one forward from the config alone, three ways
(the module docstring says what each holds).  Each is held to an
independent counter at every geometry of
``tests/test_torch_swin_unetr.py::VARIANTS`` (batch 2), every decoder
layout and the two phase-2 heads (batch 1), to the FLOP:

* ``port`` to ``counted_flops`` (``FlopCounterMode``) of the port's fp32
  plain forward on a fresh model;
* ``jax`` to the JAX forward's jaxpr: 2 x output elements x contraction
  size, summed over its ``dot_general`` and ``conv_general_dilated``
  equations, at the variants and in the ``full``/``unetr`` layout (the
  transposed conv, the UNETR skip blocks and bottleneck); XLA's cost
  analysis (the JAX ``lowered_flops``: in-bounds conv taps only, plus
  elementwise work) is printed beside it at the two aligned variants;
* ``model`` to the sum of its parts.

The flagship's counts per 128x128x8 window are pinned (beside the JAX
package's 24.43 GFLOP cost analysis), and the card's peaks come from
its name, an unknown card raising.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    ModelConfig as JaxModelConfig
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinUnetR as JaxSwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu.utils.flops import \
    lowered_flops
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import (
    PHASE1_MODE, ModelConfig, flagship_conf)
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    flops
from test_torch_swin_unetr import LAYOUTS, VARIANTS, tiny_conf


def jaxpr_products(jaxpr, mult: int = 1) -> int:
    """2 x output elements x contraction size over the dot_general and
    conv_general_dilated equations, sub-jaxprs included (a scan's body
    times its length)."""
    total = 0
    for eq in jaxpr.eqns:
        out = int(np.prod(eq.outvars[0].aval.shape)) if eq.outvars else 0
        if eq.primitive.name == "dot_general":
            (contract, _), _ = eq.params["dimension_numbers"]
            lhs = eq.invars[0].aval.shape
            total += 2 * out * int(np.prod([lhs[i] for i in contract])) \
                * mult
        elif eq.primitive.name == "conv_general_dilated":
            rhs = eq.invars[1].aval.shape
            spec = eq.params["dimension_numbers"].rhs_spec
            total += 2 * out * int(np.prod([rhs[i] for i in spec[1:]])) \
                * mult
        inner = mult * (eq.params.get("length", 1)
                        if eq.primitive.name == "scan" else 1)
        for param in eq.params.values():
            for sub in param if isinstance(param, (list, tuple)) \
                    else (param,):
                if isinstance(sub, core.ClosedJaxpr):
                    total += jaxpr_products(sub.jaxpr, inner)
                elif isinstance(sub, core.Jaxpr):
                    total += jaxpr_products(sub, inner)
    return total


def jax_counts(conf: dict, batch: int, xla: bool = False):
    """(jaxpr products, XLA cost analysis or None) of the JAX forward,
    from shapes only."""
    model = JaxSwinUnetR(JaxModelConfig.from_namespace(Namespace(**conf)))
    x = jax.ShapeDtypeStruct((batch, *conf["roi_size"], 1), jnp.float32)
    variables = jax.eval_shape(lambda x: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, deterministic=True), x)

    def fn(v, x):
        out = model.apply(v, x, deterministic=True)
        return out["downstream"] if "downstream" in out else out

    products = jaxpr_products(jax.make_jaxpr(fn)(variables, x).jaxpr)
    return products, lowered_flops(fn, variables, x) if xla else None


def port_count(conf: dict, batch: int) -> int:
    model = SwinUnetR(ModelConfig.from_mapping(conf)).eval()
    return flops.counted_flops(model, torch.zeros(batch, *conf["roi_size"],
                                                  1))


def check(conf: dict, batch: int, jax_too: bool = True, xla: bool = False):
    got = flops.forward_flops(conf, batch)
    assert got.port == port_count(conf, batch)
    assert got.model == sum(got.parts.values())
    if not jax_too:
        return got, None
    products, xla_flops = jax_counts(conf, batch, xla)
    assert got.jax == products
    assert got.model < got.jax
    return got, xla_flops


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_counts_match_both_counters_at_the_variants(name):
    conf = tiny_conf(**VARIANTS[name])
    aligned = conf["pad_mode"] == "aligned"
    got, xla_flops = check(conf, 2, xla=aligned)
    print(f"{name}: model {got.model}, port {got.port}, jax {got.jax}" + (
        f", XLA cost analysis {xla_flops:.0f} (port / XLA "
        f"{got.port / xla_flops:.3f})" if aligned else ""))
    # The port folds the depth-padded stage that the JAX forward pads.
    assert (got.port < got.model) == (name == "fold_aligned")


@pytest.mark.parametrize("layout", LAYOUTS[1:], ids="/".join)
def test_counts_match_both_counters_in_every_layout(layout):
    res, up = layout
    check(tiny_conf(unetr_res_block=res, unetr_up_block=up), 1,
          jax_too=layout == ("full", "unetr"))


@pytest.mark.parametrize("mode", ["supervised_learning_all",
                                  "self_supervised_learning_decoder"])
def test_port_count_of_the_phase2_forwards(mode):
    conf = tiny_conf(training_mode=mode, output_channels_pretrain=3)
    got = flops.forward_flops(conf, 1)
    assert got.port == port_count(conf, 1)
    assert ("head" in got.parts) == mode.startswith("supervised")
    with pytest.raises(ValueError, match=PHASE1_MODE):
        flops.forward_flops(tiny_conf(training_mode=PHASE1_MODE), 1)


def test_flagship_window_counts():
    got = flops.forward_flops(flagship_conf(), 1, roi=(128, 128, 8))
    print(f"flagship per 128x128x8 window: model {got.model / 1e9:.3f} "
          f"GFLOP, port {got.port / 1e9:.3f}, jax {got.jax / 1e9:.3f}; the "
          "JAX package's XLA cost analysis 24.43 (bench.py)")
    assert (got.model, got.port, got.jax) == (
        25_869_680_640, 23_013_081_088, 27_261_435_904)
    assert flops.model_flops(flagship_conf(), 2, roi=(128, 128, 8)) == \
        2 * got.model - sum(v for k, v in got.parts.items()
                            if k.endswith("prompt_kv"))


def test_peaks_follow_the_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.chip_peak_tflops() == 989.4
    assert flops.chip_peak_tbytes() == 3.35
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 PCIe")
    assert (flops.chip_peak_tflops(), flops.chip_peak_tbytes()) == (756.0,
                                                                    2.0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100"):
        flops.chip_peak_tflops()
