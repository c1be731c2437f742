"""The MedSAM cell (``medsam_ct512x64_box32``) at a tiny CPU size: the
benchmark's reference is the repository's to the byte, a sound run (and
a traced one) comes out correct, an untraced run leaves the program's
tracer off, the fp8 control fails its limit, and each fault of
``faults_medsam.py`` is caught.

The tiny SAM: width 32, 4 blocks of which 1 and 3 are global, a 64^2
image with patch 16 and window 3 (the 4x4 grid padded to 6x6), decoder
width 32; 40x36x10 volumes with 3-slice boxes.
"""

import copy

import pytest

from benchmark import common, faults_medsam
from benchmark import run as bench_run

CELL = "medsam_ct512x64_box32"
TINY_SAM = dict(image_size=64, encoder_embed_dim=32, encoder_depth=4,
                encoder_num_heads=2, encoder_global_attn_indexes=[1, 3],
                window_size=3, prompt_embed_dim=32, mask_in_chans=4,
                decoder_num_heads=2, decoder_mlp_dim=64,
                iou_head_hidden_dim=32, slice_batch=2,
                compute_dtype="float32")
TINY_TRAFFIC = dict(volume_shape=[40, 36, 10], pool=2, boxes_per_volume=2,
                    box_slices=3, box_side=[12, 30], in_flight=2,
                    warmup_s=0.0, trace_units=2, label_units=1, sample=2)


def tiny(seed: int = 123456789012, trace: bool = True, **traffic
         ) -> common.Cell:
    """The tiny cell; traced by default, whose passes finish a fixed
    number of studies (5) however slow the CPU, where a plain run's
    window may finish one."""
    cell = common.load_cell(common.load_manifest(), CELL, seed, 0.3, trace)
    cell.config = copy.deepcopy(cell.config)
    cell.config["hparams"].update(TINY_SAM)
    cell.traffic = dict(cell.traffic, **dict(TINY_TRAFFIC, **traffic))
    return cell


def test_reference_is_the_repositorys():
    port = common.ROOT / ("medical_image_segmentation_with_visual_prompts_"
                          "tpu_torch/reference/medsam.py")
    assert (common.BENCH / "reference" / "medsam.py").read_bytes() == \
        port.read_bytes()


@pytest.mark.parametrize("seed", [123456789012, 2 ** 31 + 7])
def test_sound_run_is_correct(seed):
    cell = tiny(seed)
    out = common.driver(cell).run(cell)
    assert out.correct, (out.checks, out.detail)
    assert out.checks["prob_gap"][0] < 1e-3
    assert out.detail["checked"] == cell.traffic["sample"]


def test_plain_run_reports_its_metrics_with_the_tracer_off():
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import trace
    cell = tiny(trace=False, sample=1)     # a window finishes one at least
    out = common.driver(cell).run(cell)
    assert out.correct, (out.checks, out.detail)
    assert set(out.metrics) == {"volumes_per_s", "volume_latency_p95_ms"}
    assert not trace.enabled()
    assert trace.collect() == {"spans": [], "counters": {}}


def test_traced_run_builds_its_line():
    cell = tiny()
    out = common.driver(cell).run(cell)
    assert out.correct, (out.checks, out.detail)
    assert out.ctx["units"] == 2
    assert out.ctx["model_flops_per_unit"] > 0
    assert len(out.ctx["attn_work_per_unit"]) == 2 * 4   # 2 batches
    line = bench_run.result(cell, common.load_manifest(), out, 1.0)
    assert list(line)[-1] == "checks"
    allowed = {m["name"] for m in common.load_manifest()["per_layer"]
               if CELL in m["workloads"]}
    assert set(line["metrics"]) <= allowed


def test_control_fails():
    cell = tiny()
    got = common.driver(cell).control(cell)
    assert got > cell.traffic["limits"]["prob_gap"], got


@pytest.fixture
def planted():
    undo = []
    yield lambda name: undo.append(faults_medsam.plant(name))
    for u in undo:
        u()


@pytest.mark.parametrize("fault", faults_medsam.FAULTS)
def test_fault_is_caught(planted, fault):
    planted(fault)
    cell = tiny()
    out = common.driver(cell).run(cell)
    assert not out.correct, (out.checks, out.detail)
    assert out.detail["checked"] == cell.traffic["sample"]   # a real gap
