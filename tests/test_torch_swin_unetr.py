"""PyTorch port: the downstream SwinUnetR against the JAX model.

The JAX model runs its fp32 XLA path (``attn_impl: xla``, fp32 matmul
precision pinned by conftest.py): materially padded windows, no kernel.
Its variables go through ``utils/torch_export.py::export_state_dict``
into the port with a strict ``load_state_dict``; the port runs its
plain versions at fp32 (pad-folded blocks where the geometry allows, so
the fold algebra is checked against the padded computation).  Logits
agree to float reassociation: 1e-4 absolute on O(1) logits.

Every decoder layout (``unetr_res_block`` none/simple/full x
``unetr_up_block`` swin/unetr) is held to the JAX model at the tiny
config, its variables carried by the port's name map
(``utils/torch_import.py::load_flax_variables``); so are the four
phase-2 modes' outputs (``latent_outputs``, and ``seg_pred`` in the
supervised ones) on a student's 12x12x8 crop, whose 6x6x4 stage pads
H/W materially.

Geometries: ``configurations/tiny_cpu.yml`` (every stage window-aligned,
so both pad modes coincide there); a variant with window 4x4x4 on a
32x32x8 roi whose stage 1 (8x8x2) folds its depth axis under the plain
and the shifted block (FOLD_KEY, FOLD_COUNT) with ``pad_mode: aligned``
and pads every axis materially with ``pad_mode: reference``; and an
odd-size roi under ``reference`` (asymmetric pads, the relabel quirk).
"""

from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    ModelConfig as JaxModelConfig
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinUnetR as JaxSwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    init_weights, load_reference_checkpoint)
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils.torch_import \
    import load_flax_variables

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-4

# (unetr_res_block, unetr_up_block): every decoder layout of the JAX model.
LAYOUTS = [(r, u) for r in ("none", "simple", "full")
           for u in ("swin", "unetr")]

VARIANTS = {
    "tiny_aligned": dict(pad_mode="aligned"),
    "fold_aligned": dict(attn_window_size=[4, 4, 4], roi_size=[32, 32, 8],
                         pad_mode="aligned"),
    "fold_reference": dict(attn_window_size=[4, 4, 4],
                           roi_size=[32, 32, 8], pad_mode="reference"),
    "odd_reference": dict(roi_size=[20, 18, 6], pad_mode="reference"),
}


def tiny_conf(**overrides) -> dict:
    """tiny_cpu.yml as a downstream config with both prompt sets on."""
    with open(ROOT / "configurations" / "tiny_cpu.yml") as f:
        conf = yaml.safe_load(f)
    conf.update(training_mode="downstream", use_encoder_prompting=True,
                use_decoder_prompting=True, attn_impl="xla")
    conf.update(overrides)
    return conf


def jax_model(conf: dict, seed: int = 0):
    """JAX SwinUnetR + variables with non-trivial BatchNorm statistics
    and LayerNorm/BatchNorm affines (so the BN folds and the pad-fold
    row are exercised)."""
    jconf = JaxModelConfig.from_namespace(Namespace(**conf))
    model = JaxSwinUnetR(jconf)
    x = jnp.zeros((1, *conf["roi_size"], conf["input_channels"]))
    variables = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, x,
        deterministic=True))(x)
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, variables))
    for k, v in flat.items():
        if k[0] == "batch_stats":
            flat[k] = (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
                       else rng.normal(0, 0.1, v.shape)).astype(np.float32)
        elif k[-1] in ("scale", "bias") and "Conv_0" not in k:
            flat[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return model, jconf, traverse_util.unflatten_dict(flat)


def port_model(conf: dict, state_dict) -> SwinUnetR:
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    result = model.load_state_dict(state_dict, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return model.eval()


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    conf = tiny_conf(**VARIANTS[request.param])
    jm, jconf, variables = jax_model(conf)
    x = np.random.default_rng(3).standard_normal(
        (2, *conf["roi_size"], 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=True)["downstream"])(variables, jnp.asarray(x)))
    sd = export_state_dict(variables, jconf)
    return request.param, conf, sd, x, want


def test_logits_match_jax_fp32(pair):
    name, conf, sd, x, want = pair
    model = port_model(conf, sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *conf["roi_size"], 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fold_path_is_taken_where_expected(pair):
    name, conf, sd, x, _ = pair
    model = port_model(conf, sd)
    with torch.inference_mode():
        model(torch.from_numpy(x[:1]))
    kinds = {key[0] for m in model.modules() if hasattr(m, "_cache")
             for key in m._cache}
    # Under pad_mode reference the misaligned depth pads every axis, and
    # material pads on other axes rule folding out.
    assert ("fold" in kinds) == (name == "fold_aligned")


def test_bf16_trunk_tracks_fp32(pair):
    """The serving dtype: bf16 trunk, fp32 statistics and softmax."""
    name, conf, sd, x, want = pair
    model = port_model({**conf, "compute_dtype": "bfloat16"}, sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 0.1 * scale


def test_operand_cache_follows_parameter_updates():
    conf = tiny_conf()
    model = SwinUnetR(ModelConfig.from_mapping(conf)).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.rand((1, *conf["roi_size"], 1),
                   generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        before = model(x)
    with torch.no_grad():
        model.encoder_blocks[0].swin_blocks[0].attn.to_v.weight.mul_(2.0)
        model.prompt_tokens.dec[3].add_(0.5)
    fresh = SwinUnetR(ModelConfig.from_mapping(conf)).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        after, want = model(x), fresh(x)
    assert (after - before).abs().max() > 1e-3
    torch.testing.assert_close(after, want, atol=0, rtol=0)


def test_init_weights_is_seeded_with_live_batchnorm_stats():
    conf = tiny_conf()
    a = init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                     torch.Generator().manual_seed(7))
    b = init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                     torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, msg=k)
    bn = a.decoder_blocks[0].norm_concat
    assert bn.running_mean.abs().max() > 0
    assert (bn.running_var - 1).abs().max() > 0
    assert a.encoder_blocks[0].swin_blocks[0].attn_norm.bias.abs().max() > 0


def test_init_weights_seeds_every_layout():
    """The UNETR blocks' convs and transposed convs, the output layer and
    its prompt tokens are drawn like the rest: seeded, finite, weights
    non-zero, biases small."""
    for layout in LAYOUTS:
        conf = tiny_conf(unetr_res_block=layout[0], unetr_up_block=layout[1])
        a, b = (init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                             torch.Generator().manual_seed(3))
                for _ in range(2))
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q) and torch.isfinite(p).all(), name
            assert p.abs().max() > 0, name
        for name, m in a.named_modules():
            if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                assert m.bias.abs().max() < 0.2, name
        if layout[1] == "unetr":
            w = a.decoder_blocks[0].transp_conv.conv.weight
            fan = (w.shape[0] + w.shape[1]) * w[0, 0].numel()
            assert w.abs().max() <= (6.0 / fan) ** 0.5
        if layout[0] != "none" and layout[1] == "swin":
            assert a.prompt_tokens.out[1].abs().max() > 0


def test_reference_checkpoint_roundtrip(tmp_path):
    conf = tiny_conf()
    model = init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                         torch.Generator().manual_seed(0))
    sd = dict(model.state_dict())
    # Reference checkpoints also carry the derived PE index buffers.
    sd["encoder_blocks.0.swin_blocks.0.pe.relative_dist_h"] = \
        torch.zeros(4, 4, dtype=torch.long)
    torch.save({"model_state_dict": sd}, tmp_path / "ref.pt")
    loaded = load_reference_checkpoint(tmp_path / "ref.pt")
    other = SwinUnetR(ModelConfig.from_mapping(conf))
    other.load_state_dict(loaded, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, msg=k)


@pytest.mark.parametrize("layout", LAYOUTS, ids="-".join)
def test_layout_logits_match_jax_fp32(layout):
    """Each decoder layout at the tiny config, both prompt sets on, fp32,
    within the tolerance of ``test_logits_match_jax_fp32``."""
    conf = tiny_conf(unetr_res_block=layout[0], unetr_up_block=layout[1],
                     pad_mode="aligned")
    jm, jconf, variables = jax_model(conf, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (2, *conf["roi_size"], 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=True)["downstream"])(variables, jnp.asarray(x)))
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    load_flax_variables(model, variables)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *conf["roi_size"], 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    has_out = layout[0] != "none" and layout[1] == "swin"
    assert hasattr(model.prompt_tokens, "out") == has_out
    # The decoder tokens exist under the unetr up path too (unused).
    assert len(model.prompt_tokens.dec) == 2 * conf["depth_unet"]


def test_unported_layouts_raise():
    """Every decoder layout builds, and so do the four phase-2 modes
    (with the segmentation head in the supervised ones, no head in the
    others) and the phase-1 mode (its three proxy heads, no decoder and
    no decoder prompts, in any layout).  An unknown layout value is
    refused."""
    for layout in LAYOUTS:
        SwinUnetR(ModelConfig.from_mapping(tiny_conf(
            unetr_res_block=layout[0], unetr_up_block=layout[1])))
    for mode in PHASE2_MODES:
        model = SwinUnetR(ModelConfig.from_mapping(tiny_conf(
            training_mode=mode)))
        assert list(model.extra_heads) == (
            ["segmentation"] if mode.startswith("supervised") else [])
    for layout in (("none", "swin"), ("full", "unetr")):
        model = SwinUnetR(ModelConfig.from_mapping(tiny_conf(
            training_mode="self_supervised_learning_encoder",
            unetr_res_block=layout[0], unetr_up_block=layout[1])))
        assert sorted(model.extra_heads) == [
            "contrastive_coding", "reconstruction", "rotation_prediction"]
        assert not any(n.startswith(("bottleneck", "residual_blocks",
                                     "decoder_blocks", "output_layer",
                                     "prompt_tokens.dec", "prompt_tokens.out"))
                       for n, _ in model.named_parameters())
    with pytest.raises(ValueError, match="unetr_res_block"):
        ModelConfig.from_mapping(tiny_conf(unetr_res_block="partial"))


PHASE2_MODES = ("self_supervised_learning_decoder",
                "self_supervised_learning_all",
                "supervised_learning_decoder", "supervised_learning_all")


@pytest.mark.parametrize("mode", PHASE2_MODES)
def test_phase2_outputs_match_jax_fp32(mode):
    conf = tiny_conf(training_mode=mode, pad_mode="aligned")
    jm, _, variables = jax_model(conf, seed=8)
    x = np.random.default_rng(9).standard_normal(
        (2, 12, 12, 8, 1)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(
        variables, jnp.asarray(x))
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    load_flax_variables(model, variables)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == (
        ["latent_outputs", "seg_pred"] if mode.startswith("supervised")
        else ["latent_outputs"])
    assert got["latent_outputs"].shape == (2, 12, 12, 8, 8)
    for key, value in got.items():
        assert value.dtype == torch.float32
        np.testing.assert_allclose(value.numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
