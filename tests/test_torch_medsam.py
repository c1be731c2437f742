"""PyTorch port: MedSAM (``models/sam.py``) and its slice-wise serving
path (``parallel/sam_slices.py``, ``infer.py``) against the plain float32
reference ``reference/medsam.py``, on the CPU at a tiny size.

The tiny SAM: width 32, 4 blocks of which 1 and 3 are global, a 64^2
image with patch 16 and window 3 (the 4x4 grid padded to 6x6, so the
windowed blocks attend over padded tokens), decoder width 32.  Seeded
weights with rel-pos tables as large as the scores they are added to.

Tolerances: both sides compute in float32 and differ only in the order
of their sums (``scaled_dot_product_attention`` against the explicit
softmax, the patch embed's channel fold against three equal channels,
``F.layer_norm`` against the written-out one), which moves a value by a
few float32 ulps per layer: :data:`ATOL` / :data:`RTOL` hold it with a
hundredfold room, and the rel-pos fault lies orders of magnitude above.

Two ``cuda`` tests (skipped here) hold the published-width model on the
card to the reference: in float32, and as ``configurations/medsam_vit_b.yml``
ships it (bfloat16) through the serving path, by the benchmark's check.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    SamConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models.sam \
    import Sam
from medical_image_segmentation_with_visual_prompts_tpu_torch.reference \
    import medsam as ref
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    flops, trace)
from tools import torch_trace_pass

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(ref.VIT_B, image_size=64, encoder_embed_dim=32, encoder_depth=4,
            encoder_num_heads=2, encoder_global_attn_indexes=[1, 3],
            window_size=3, prompt_embed_dim=32, mask_in_chans=4,
            decoder_num_heads=2, decoder_mlp_dim=64, iou_head_hidden_dim=32,
            slice_batch=1, compute_dtype="float32", model_family="medsam")
ATOL, RTOL = 1e-5, 1e-4
# segment_anything's names, a few of each module (build_sam_vit_b).
SAM_KEYS = [
    "image_encoder.pos_embed", "image_encoder.patch_embed.proj.weight",
    "image_encoder.blocks.0.attn.rel_pos_h",
    "image_encoder.blocks.3.mlp.lin2.bias",
    "image_encoder.neck.0.weight", "image_encoder.neck.3.bias",
    "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "prompt_encoder.point_embeddings.3.weight",
    "prompt_encoder.not_a_point_embed.weight",
    "prompt_encoder.mask_downscaling.6.bias",
    "prompt_encoder.no_mask_embed.weight",
    "mask_decoder.transformer.layers.1.cross_attn_image_to_token.k_proj"
    ".weight",
    "mask_decoder.transformer.final_attn_token_to_image.out_proj.bias",
    "mask_decoder.transformer.norm_final_attn.weight",
    "mask_decoder.iou_token.weight", "mask_decoder.mask_tokens.weight",
    "mask_decoder.output_upscaling.3.weight",
    "mask_decoder.output_hypernetworks_mlps.3.layers.2.weight",
    "mask_decoder.iou_prediction_head.layers.2.bias"]


def seeded_state(template: torch.nn.Module, seed: int) -> dict:
    """Norm scales 1 + 0.1 N and shifts 0.1 N; the rel-pos tables N(0,
    0.5^2) (their ``q . R`` terms as large as the scaled scores); the
    Fourier matrix N(0, 1); other tensors N(0, 1 / fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in template.state_dict().items():
        z = torch.randn(t.shape, generator=gen)
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in name or ("neck" in name and t.dim() == 1) or \
                name.startswith("mask_decoder.output_upscaling.1"):
            out[name] = (1.0 if leaf == "weight" else 0.0) + 0.1 * z
        elif leaf.startswith("rel_pos"):
            out[name] = 0.5 * z
        elif leaf == "positional_encoding_gaussian_matrix" or t.dim() == 1:
            out[name] = z if t.dim() == 2 else 0.1 * z
        else:
            out[name] = z / math.sqrt(t[0].numel() if t.dim() > 1 else 1)
    return out


@pytest.fixture(scope="module")
def pair():
    reference = ref.MedSAM(TINY)
    reference.load_state_dict(seeded_state(reference, 7))
    port = Sam(SamConfig.from_mapping(TINY))
    port.load_state_dict(reference.state_dict(), strict=True)
    return port.eval(), reference


def _close(got, want, scale=1.0):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= scale * (ATOL + RTOL * want.abs().max().item()), err
    return err


def _images(n=2, seed=3):
    return torch.rand(n, 1, 64, 64, generator=torch.Generator().manual_seed(
        seed))


BOXES = torch.tensor([[5.0, 9.0, 40.0, 51.0], [20.0, 3.0, 63.0, 30.0]])


def test_state_dict_loads_strictly_under_sam_names(pair):
    port, reference = pair
    keys = set(port.state_dict())
    assert keys == set(reference.state_dict())
    assert set(SAM_KEYS) <= keys
    fresh = Sam(SamConfig.from_mapping(TINY))
    fresh.load_state_dict(reference.state_dict(), strict=True)
    with pytest.raises(RuntimeError):
        fresh.load_state_dict({k: v for k, v in reference.state_dict().items()
                               if "mask_downscaling" not in k}, strict=True)


def test_encoder_matches_reference(pair):
    port, reference = pair
    x = _images()
    with torch.no_grad():
        got = port.image_encoder(x)
        want = reference.encode(x.expand(-1, 3, -1, -1))
    _close(got, want)


def test_prompt_encoder_and_decoder_match_reference(pair):
    port, reference = pair
    emb = torch.randn(2, 32, 4, 4, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        sparse, dense = port.prompt_encoder(BOXES)
        r_sparse, r_dense = reference.prompt(BOXES)
        _close(sparse, r_sparse)
        assert torch.equal(dense, r_dense)
        _close(port.prompt_encoder.get_dense_pe(), reference.dense_pe())
        got, iou = port.mask_decoder(emb, port.prompt_encoder.get_dense_pe(),
                                     sparse, dense)
        want, r_iou = ref.mask_decoder(reference.arith,
                                       reference.mask_decoder, emb,
                                       reference.dense_pe(), r_sparse,
                                       r_dense)
    assert got.shape == (2, 1, 16, 16)
    _close(got, want)
    _close(iou, r_iou)


def test_relpos_fault_exceeds_the_tolerance(pair):
    port, reference = pair
    x = _images()
    zeroed = Sam(SamConfig.from_mapping(TINY))
    state = dict(reference.state_dict())
    for k in state:
        if ".rel_pos_" in k:
            state[k] = torch.zeros_like(state[k])
    zeroed.load_state_dict(state)
    with torch.no_grad():
        want = reference.encode(x.expand(-1, 3, -1, -1))
        good = _close(port.image_encoder(x), want)
        bad = (zeroed.image_encoder(x) - want).abs().max().item()
    assert bad > 100 * max(good, ATOL + RTOL * want.abs().max().item())


def _study(seed=11):
    gen = np.random.default_rng(seed)
    vol = gen.normal(40.0, 150.0, (24, 20, 6)).astype(np.int16)
    return vol[..., None], (3, 2, 17, 21, 2, 4)


def test_study_matches_reference_protocol(pair):
    port, reference = pair
    vol, box = _study()
    runner = infer.make_runner(TINY, port)
    labels, slices = infer.predict_device(runner, None, vol, box=box)
    assert labels.dtype == torch.uint8 and labels.shape == (24, 20, 6)
    assert slices == (slice(0, 24), slice(0, 20), slice(0, 6))
    probs = ref.study_probs(reference, vol, box, "cpu")
    assert probs.shape == (24, 20, 2)
    sure = (probs - 0.5).abs() > 1e-3
    assert sure.float().mean() > 0.9
    assert 0.05 < (probs > 0.5).float().mean() < 0.95     # not degenerate
    want = (probs > 0.5).to(torch.uint8)
    assert torch.equal(labels[:, :, 2:4][sure], want[sure])
    outside = torch.cat([labels[:, :, :2], labels[:, :, 4:]], dim=-1)
    assert int(outside.sum()) == 0


def test_box_and_family_checks(pair):
    port, _ = pair
    vol, _ = _study()
    runner = infer.make_runner(TINY, port)
    with pytest.raises(ValueError, match="inside"):
        runner(vol, (3, 2, 17, 25, 2, 4))
    with pytest.raises(TypeError):
        infer.predict_device(runner, None, vol)
    with pytest.raises(ValueError, match="mesh_data"):
        infer.build_model(dict(TINY, mesh_data=2), device="cpu")


MEDSAM_CLI = ["--configs", str(ROOT / "configurations" / "medsam_vit_b.yml"),
              "--ckpt", "medsam_vit_b.pth", "--input", "case.nii.gz",
              "--output", "case_seg.nii.gz"]


@pytest.mark.parametrize("extra", [
    [], ["--box", "1", "2", "3", "4", "5", "6", "--chunk", "8"],
    ["--box", "1", "2", "3", "4", "5", "6", "--stride-factor", "0.25"],
    ["--box", "1", "2", "3", "4", "5", "6", "--coverage", "crop"],
    ["--box", "1", "2", "3", "4", "5", "6", "--host-windowing"],
    ["--box", "1", "2", "3", "4", "5", "6", "--use-encoder-prompting"]],
    ids=["no-box", "chunk", "stride", "coverage", "host-windowing",
         "prompting"])
def test_cli_refuses_a_medsam_config_without_a_box_or_with_swin_flags(extra):
    with pytest.raises(SystemExit, match="MedSAM"):
        infer.main(MEDSAM_CLI + extra)


def test_spans_and_counters_of_a_study(pair):
    port, _ = pair
    vol, box = _study()
    runner = infer.make_runner(TINY, port)
    trace.enable()
    try:
        infer.predict_device(runner, None, vol, box=box)
        snap = trace.collect()
    finally:
        trace.disable()
    assert snap["counters"] == {"serve.sam.slices": 2,
                                "serve.sam.encoder_batches": 2,
                                "serve.sam.prompts": 2}
    names = [s["name"] for s in snap["spans"]]
    assert names.count("serve.volume") == 1
    assert names.count("serve.sam.encoder") == 2
    for n in ("serve.upload", "serve.preprocess", "serve.sam.prompt",
              "serve.sam.decoder", "serve.sam.postprocess"):
        assert names.count(n) == 1, n
    unit = {s["unit"] for s in snap["spans"]}
    assert len(unit) == 1
    got = torch_trace_pass.unit_metrics(snap["spans"])
    assert {"encoder_ms.sam", "decoder_ms.sam", "around_ms.sam"} <= set(got)
    assert "stitch_ms.serve" not in got          # no Swin-UNETR volume


def test_flops_match_the_counter_and_the_benchmark():
    reference = ref.MedSAM(TINY)
    counted = flops.counted_flops(reference, _images(3).expand(-1, 3, -1, -1),
                                  torch.cat([BOXES, BOXES[:1]]))
    assert flops.medsam_forward_flops(TINY, 3) == counted
    from benchmark import arith_medsam
    conf = dict(ref.VIT_B)
    assert flops.medsam_forward_flops(conf, 32) == \
        arith_medsam.study_flops(conf, 32)


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "medical_image_segmentation_with_visual_prompts_"
                      "tpu_torch" / "reference" / "medsam.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops


@pytest.mark.cuda
def test_published_widths_on_the_card_match_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the published-width model runs on "
                    "the chip only")
    dev = torch.device("cuda")
    reference = ref.MedSAM().to(dev)
    reference.load_state_dict({k: v.to(dev) for k, v in seeded_state(
        reference, 5).items()})
    conf = dict(ref.VIT_B, compute_dtype="float32")
    port = Sam(SamConfig.from_mapping(conf)).to(dev).eval()
    port.load_state_dict(reference.state_dict(), strict=True)
    x = torch.rand(2, 1, 1024, 1024, device=dev,
                   generator=torch.Generator(dev).manual_seed(1))
    boxes = torch.tensor([[100.0, 200.0, 600.0, 700.0],
                          [300.0, 50.0, 900.0, 500.0]], device=dev)
    with torch.no_grad(), ref.strict_fp32():
        got = port(x, boxes)
        want = reference(x.expand(-1, 3, -1, -1), boxes)
    # float32 on both sides (TF32 off): 24 attention layers' sums in
    # another order, relative 1e-3 of the logits' range holds it.
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item(), err


@pytest.mark.cuda
def test_shipped_bf16_config_on_the_card_matches_the_reference():
    """``configurations/medsam_vit_b.yml`` (bfloat16, the benchmark's
    configuration) served through ``infer``'s path on a seed's inputs and
    weights of the cell ``medsam_ct512x64_box32``, held to the fp32
    reference by that cell's check (``prob_gap``) and limit: the widened
    q and k with bf16 rel-pos terms and the bf16 channel-summed patch
    embed are held where the float32 test does not reach."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the published-width model runs on "
                    "the chip only")
    from benchmark import common
    from benchmark.drivers import serve_medsam
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import load_conf
    cell = common.load_cell(common.load_manifest(ROOT),
                            "medsam_ct512x64_box32", 3141592653, 1.0, False,
                            ROOT)
    conf = load_conf(str(ROOT / "configurations" / "medsam_vit_b.yml"))
    assert SamConfig.from_mapping(conf) == \
        SamConfig.from_mapping(cell.hparams())
    assert SamConfig.from_mapping(conf).compute_dtype == "bfloat16"
    wseed, volumes, reqs = serve_medsam.inputs(cell)
    model = infer.build_model(conf)
    model.load_state_dict(serve_medsam.weights(conf, wseed, "cuda"))
    runner = infer.make_runner(conf, model)
    served = []
    for k in range(serve_medsam.SPARE * int(cell.traffic["sample"])):
        v, box = reqs[k]
        labels, _ = infer.predict_device(runner, None, volumes[v], box=box)
        served.append((k, labels.cpu().numpy()))
    del runner, model
    gap, detail = serve_medsam.check(cell, wseed, volumes, reqs, served)
    assert detail["checked"] == int(cell.traffic["sample"]), detail
    assert gap <= cell.traffic["limits"]["prob_gap"], (gap, detail)
