"""PyTorch port: the UNETR decoder blocks against the JAX flax modules.

``ConvTranspose3d``, ``UnetBasicBlock``, ``UnetResBlock`` (with and
without the 1x1 projection), ``UnetrBasicBlock`` and ``UnetrUpBlock`` of
``models/unet_blocks.py`` run the JAX modules' seeded weights, carried
into torch by the port's name map (``utils/torch_import.py``: the rules
of the tiny model's block at the same shapes, prefixes stripped), on
seeded numpy inputs.  fp32; outputs agree to 1e-5 absolute plus 1e-5
relative (the same convs summed in another order).

Dtypes: under a bf16 trunk the JAX UNETR blocks build their convs
without a dtype, so flax computes them in fp32; ``SwinUpBlock`` writes
its conv in the block's dtype whatever the upsampled trunk's dtype.  The
port's output dtypes are held to ``jax.eval_shape`` of the JAX modules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    unet_blocks as jax_blocks
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    unet_blocks
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    init_weights, torch_import)
from test_torch_swin_unetr import tiny_conf

TOL = dict(atol=1e-5, rtol=1e-5)

# Tiny model (hidden 8/16/32, depth 2, one input channel): its decoder
# block 0 is 32 -> 16, its bottleneck 32 -> 32, its last skip block 1 -> 8.
# (name, layout overrides, torch prefix, flax prefix)
SITES = {
    "transp_conv": (dict(unetr_res_block="full", unetr_up_block="unetr"),
                    "decoder_blocks.0.transp_conv.",
                    "decoder_blocks_0/transp_conv/"),
    "conv_block_basic": (dict(unetr_res_block="full",
                              unetr_up_block="unetr", res_block=False),
                         "decoder_blocks.0.conv_block.",
                         "decoder_blocks_0/conv_block/"),
    "conv_block_res": (dict(unetr_res_block="full", unetr_up_block="unetr",
                            res_block=True),
                       "decoder_blocks.0.conv_block.",
                       "decoder_blocks_0/conv_block/"),
    "bottleneck_res": (dict(unetr_res_block="full", basic_block_res=True),
                       "bottleneck.layer.", "bottleneck/layer/"),
    "skip_res": (dict(unetr_res_block="full", basic_block_res=True),
                 "residual_blocks.2.", "residual_blocks_2/"),
    "skip_basic": (dict(unetr_res_block="full", basic_block_res=False),
                   "residual_blocks.2.", "residual_blocks_2/"),
    "up_basic": (dict(unetr_res_block="full", unetr_up_block="unetr",
                      res_block=False),
                 "decoder_blocks.0.", "decoder_blocks_0/"),
    "up_res": (dict(unetr_res_block="full", unetr_up_block="unetr",
                    res_block=True),
               "decoder_blocks.0.", "decoder_blocks_0/"),
}


def site_rules(site: str) -> dict:
    """The port's rules of one block of the tiny model, as rules of the
    block alone: torch key -> (collection, flax path, transform)."""
    over, tp, fp = SITES[site]
    rules = torch_import.build_key_rules(
        ModelConfig.from_mapping(tiny_conf(**over)))
    out = {}
    for key, rule in rules.items():
        if rule and key.startswith(tp):
            assert rule[1].startswith(fp), (key, rule)
            out[key[len(tp):]] = (rule[0], rule[1][len(fp):], rule[2])
    assert out, site
    return out


def carry(module: torch.nn.Module, params: dict, site: str) -> None:
    """Load a flax module's params into ``module`` through the rules."""
    rules = site_rules(site)
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(params).items()}
    assert set(flat) == {path for _, path, _ in rules.values()}
    sd = {key: torch.from_numpy(np.array(
        torch_import.from_flax(tf, flat[path]), np.float32))
        for key, (_, path, tf) in rules.items()}
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd, strict=True)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _init(fmod, *xs, seed=0):
    return fmod.init(jax.random.PRNGKey(seed),
                     *[jnp.asarray(x) for x in xs])["params"]


def _close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_conv_transpose_matches_flax():
    """kernel = stride = 2, VALID: the flax kernel is the torch weight's
    spatial mirror (the name map flips it)."""
    x = _x((2, 2, 2, 2, 32), 1)
    fmod = jax_blocks.ConvTranspose3d(16)
    params = _init(fmod, x)
    mod = unet_blocks.ConvTranspose3d(32, 16)
    carry(mod, params, "transp_conv")
    want = fmod.apply({"params": params}, jnp.asarray(x))
    got = mod(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 4, 4, 4, 16)
    _close(got, want)


@pytest.mark.parametrize("site,cin,cout", [
    ("conv_block_basic", 32, 16), ("conv_block_res", 32, 16),
    ("bottleneck_res", 32, 32)])
def test_unet_block_matches_flax(site, cin, cout):
    """UnetBasicBlock; UnetResBlock with the projection (32 -> 16) and
    without it (32 -> 32)."""
    res = site != "conv_block_basic"
    x = _x((2, 4, 4, 2, cin), 2)
    fmod = (jax_blocks.UnetResBlock if res else
            jax_blocks.UnetBasicBlock)(cout)
    params = _init(fmod, x)
    mod = (unet_blocks.UnetResBlock if res else
           unet_blocks.UnetBasicBlock)(cin, cout)
    assert hasattr(mod, "conv3") == (res and cin != cout)
    carry(mod, params, site)
    _close(mod(torch.from_numpy(x)), fmod.apply({"params": params},
                                                jnp.asarray(x)))


@pytest.mark.parametrize("site", ["skip_res", "skip_basic",
                                  "bottleneck_res"])
def test_unetr_basic_block_matches_flax(site):
    """The ``layer`` wrapper: the raw-input skip block (1 -> 8, projected
    when residual) and the bottleneck (32 -> 32)."""
    res = site != "skip_basic"
    cin, cout = (32, 32) if site == "bottleneck_res" else (1, 8)
    x = _x((2, 8, 8, 4, cin), 3)
    fmod = jax_blocks.UnetrBasicBlock(cout, res_block=res)
    params = _init(fmod, x)
    mod = unet_blocks.UnetrBasicBlock(cin, cout, res_block=res)
    if site == "bottleneck_res":
        carry(mod.layer, params["layer"], site)
    else:
        carry(mod, params, site)
    _close(mod(torch.from_numpy(x)), fmod.apply({"params": params},
                                                jnp.asarray(x)))


@pytest.mark.parametrize("site", ["up_basic", "up_res"])
def test_unetr_up_block_matches_flax(site):
    """Transposed conv to 4x4x4, cropped to the skip's 4x4x2 (the crop
    the decoder needs where the encoder kept the depth), concat, conv
    block (2C -> C, projected when residual)."""
    res = site == "up_res"
    x, skip = _x((2, 2, 2, 2, 32), 4), _x((2, 4, 4, 2, 16), 5)
    fmod = jax_blocks.UnetrUpBlock(16, res_block=res)
    params = _init(fmod, x, skip)
    mod = unet_blocks.UnetrUpBlock(32, 16, res_block=res)
    carry(mod, params, site)
    got = mod(torch.from_numpy(x), torch.from_numpy(skip))
    assert tuple(got.shape) == (2, 4, 4, 2, 16)
    _close(got, fmod.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(skip)))


def _jax_dtype(fmod, *xs):
    params = jax.eval_shape(lambda *a: fmod.init(jax.random.PRNGKey(0),
                                                 *a), *xs)
    return jax.eval_shape(lambda v, *a: fmod.apply(v, *a), params,
                          *xs).dtype


def test_bf16_trunk_dtypes_follow_jax():
    """bf16 inputs: the UNETR blocks compute and return fp32, as flax's
    promotion of a bf16 input with an fp32 kernel gives; SwinUpBlock's
    conv writes the block's dtype (bf16) from an fp32 upsampled trunk
    (after a ``full`` bottleneck), in serving and in training."""
    bf = jax.ShapeDtypeStruct
    cases = [
        (jax_blocks.ConvTranspose3d(16), unet_blocks.ConvTranspose3d(32, 16),
         [(2, 2, 2, 2, 32)]),
        (jax_blocks.UnetrBasicBlock(8, res_block=True),
         unet_blocks.UnetrBasicBlock(1, 8, res_block=True),
         [(1, 8, 8, 4, 1)]),
        (jax_blocks.UnetrUpBlock(16, res_block=True),
         unet_blocks.UnetrUpBlock(32, 16, res_block=True),
         [(1, 2, 2, 2, 32), (1, 4, 4, 2, 16)]),
    ]
    for fmod, mod, shapes in cases:
        want = _jax_dtype(fmod, *[bf(s, jnp.bfloat16) for s in shapes])
        got = mod(*[torch.zeros(s, dtype=torch.bfloat16) for s in shapes])
        assert want == jnp.float32 and got.dtype == torch.float32, fmod

    args = dict(in_channels=16, out_channels=8, strides=(2, 2, 2),
                kernel_size=(3, 3, 3), pos_bias_embed_dim=8, num_heads=2,
                window_size=(4, 4, 2), max_prompts=1, tokens_per_prompt=4)
    fmod = jax_blocks.SwinUpBlock(**args, attn_impl="xla",
                                  pad_mode="aligned", dtype=jnp.bfloat16)
    x, c = (1, 4, 4, 2, 16), (1, 8, 8, 4, 8)
    v = jax.eval_shape(lambda a, b: fmod.init(jax.random.PRNGKey(0), a, b),
                       bf(x, jnp.float32), bf(c, jnp.float32))
    mod = unet_blocks.SwinUpBlock(
        16, 8, (2, 2, 2), (3, 3, 3), 8, 2, (4, 4, 2), 1, 4,
        pad_mode="aligned", dtype=torch.bfloat16)
    init_weights(mod, torch.Generator().manual_seed(0))
    xt, ct = torch.rand(x), torch.rand(c)
    for deterministic in (True, False):
        want = jax.eval_shape(
            lambda v, a, b: fmod.apply(v, a, b, deterministic=deterministic,
                                       mutable=["batch_stats"])[0],
            v, bf(x, jnp.float32), bf(c, jnp.float32)).dtype
        mod.train(not deterministic)
        with torch.no_grad():
            got = mod(xt, ct)
        assert want == jnp.bfloat16 and got.dtype == torch.bfloat16, \
            (deterministic, want, got.dtype)
