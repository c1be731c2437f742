"""The frozen work arithmetic: hand counts at a tiny size, and the
forward count equal to the program's model count at both
configurations."""

import json

import pytest

from benchmark import arith, common

TINY = dict(training_mode="downstream", input_channels=1, depth_unet=1,
            hidden_channels=[4, 8], input_patch_size=[2, 2, 2],
            num_heads_encoder=2, num_heads_decoder=2,
            attn_window_size=[2, 2, 2], pos_bias_embed_dim=4,
            tokens_per_prompt_encoder=3, tokens_per_prompt_decoder=3,
            use_encoder_prompting=True, use_decoder_prompting=True,
            contrastive_coding_dim=5, output_channels_downstream=2,
            pad_mode="aligned")


def _config(name):
    return json.loads((common.BENCH / "configs" / f"{name}.json")
                      .read_text())["hparams"]


def test_hand_count_downstream():
    # roi 4x4x4 -> 2x2x2 tokens (one 2x2x2 window), C 4, 3 prompt tokens.
    b = 1
    patch = 2 * 8 * 8 * 1 * 4                       # 8 voxels x 2^3 x 4
    block = 10 * 8 * 16 + 4 * 3 * 16 + 4 * 8 * (8 + 3) * 4
    merge = 2 * 1 * 8 * 4 * 8                       # 1 voxel, 8C -> 2C
    bottleneck = 2 * 1 * 27 * 8 * 8
    up_conv = 2 * 8 * 27 * (8 + 4) * 4
    head = 2 * 64 * 27 * 4 * 2
    want = patch + 4 * block + merge + bottleneck + up_conv + head
    assert arith.forward_flops(TINY, b, (4, 4, 4)) == want
    calls = arith.b1_work(TINY, b, (4, 4, 4))
    assert len(calls) == 4 and all(f == block for f, _ in calls)
    # bf16 input and output of 8 tokens x 4 channels; 5 C x C weights.
    assert all(n == 2 * 2 * 8 * 4 + 5 * 2 * 16 for _, n in calls)


def test_hand_count_step():
    """Downstream at the tiny size: the prompts and the head trained.
    Per block: q/k/v 768, prompt K/V 192, attention 1408, projection and
    MLP 512.  The backward starts at the first prompt K/V (its weight
    gradient, the tokens'); every later layer takes its input gradient
    (twice for the attention products), the later prompt K/V and the head
    their weight gradient too."""
    fwd = arith.forward_flops(TINY, 1, (4, 4, 4))
    enc_block0 = 192 + 2 * 1408 + 512
    block = 768 + 2 * 192 + 2 * 1408 + 512
    merge, bottleneck, up_conv, head = 512, 3456, 20736, 27648
    back = enc_block0 + block + merge + bottleneck + up_conv + 2 * block \
        + 2 * head
    assert arith.step_flops(TINY, 1, (4, 4, 4)) == fwd + back == 161344


def test_bound_seconds():
    assert arith.bound_seconds([(989.4e12, 0)], 989.4, 3.35) == \
        pytest.approx(1.0)
    assert arith.bound_seconds([(0, 3.35e12), (989.4e12, 1)], 989.4,
                               3.35) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["swin_unetr_prompt_bf16",
                                  "swin_unetr_ssl_phase1_bf16"])
def test_forward_count_equals_programs(name):
    """The frozen copy equals the program's ``forward_flops`` model
    count: whole at the downstream configuration; at the phase-1 one
    (which that function refuses) the patch embed and encoder parts of
    the same backbone in downstream mode, plus the heads by hand."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import flops
    hp = _config(name)
    roi = tuple(hp["roi_size"])
    if hp["training_mode"] == "downstream":
        assert arith.forward_flops(hp, 3, roi) == \
            flops.forward_flops(hp, 3, roi).model
        return
    twin = dict(hp, training_mode="downstream")
    parts = flops.forward_flops(twin, 2, roi).parts
    want = sum(v for k, v in parts.items()
               if k == "patch_embed" or k.startswith("encoder"))
    layers, _ = arith.layers(hp, 2, roi)
    got = sum(x.flops for x in layers if x.label != "head_ssl")
    assert got == want
    heads = sum(x.flops for x in layers if x.label == "head_ssl")
    # 8x8x2 x 384->192, 16x16x2 x 192->96, 32x32x2 x 96->48,
    # 64x64x4 x 48->48 (3x3x3), 128x128x8 x 48->1, two linears.
    want_heads = 2 * 2 * 27 * (128 * 384 * 192 + 512 * 192 * 96
                               + 2048 * 96 * 48 + 16384 * 48 * 48) \
        + 2 * 2 * 131072 * 48 + 2 * 2 * 384 * (4 + 512)
    assert heads == want_heads
