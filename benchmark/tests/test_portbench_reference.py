"""The plain reference against the program's plain path on the CPU, at a
tiny size, on the same seeded weights: forwards in both modes, in eval
and in train mode (dropout masks included), the stitched volume, and the
first training steps of both trainers.  The test imports both; the
reference itself imports nothing of the program."""

import numpy as np
import pytest
import torch

from benchmark import common, generate
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from portbench_tiny import tiny_cell


def _pair(mode: str, seed: int = 5):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    hp = tiny_cell("tune_downstream_b16").hparams()
    hp["training_mode"] = mode
    keys = ref_model.model_keys(hp)
    ref = ref_model.SwinUnetR(keys, ref_model.Arith(), dropout_seed=seed)
    state = generate.weights(ref, 17, "cpu")
    ref.load_state_dict(state)
    prog = SwinUnetR(ModelConfig.from_mapping(hp), dropout_seed=seed)
    prog.load_state_dict(state, strict=True)
    return hp, prog, ref


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["downstream",
                                  "self_supervised_learning_encoder"])
def test_forward_matches_program(mode, train):
    hp, prog, ref = _pair(mode)
    prog.train(train)
    ref.train(train)
    x = torch.rand(2, *hp["roi_size"], 1,
                   generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a, b = prog(x), ref(x)
    if isinstance(a, dict):
        pairs = [(a[k], b[k]) for k in ("reconstruction",
                                        "rotation_prediction",
                                        "contrastive_coding")]
    else:
        pairs = [(a, b)]
    for got, want in pairs:
        assert got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


def test_stitch_matches_program():
    from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
    cell = tiny_cell("serve_ct320x24_s075")
    hp = cell.hparams()
    ref = ref_model.SwinUnetR(ref_model.model_keys(hp))
    state = generate.weights(ref, 3, "cpu")
    ref.load_state_dict(state)
    ref.eval()
    model = infer.build_model(hp, device="cpu")
    model.load_state_dict(state)
    vol = generate.ct_volumes(9, 1, (40, 36, 10), "cpu")[0]
    for stride, coverage in ((0.75, "crop"), (0.5, "pad")):
        runner = infer.make_runner(hp, model, stride=stride,
                                   device_windowing=True, coverage=coverage)
        crop, slices = infer.predict_device(runner, tuple(hp["roi_size"]),
                                            vol)
        with torch.inference_mode():
            probs = runner(np.ascontiguousarray(vol[slices]))
        want, want_slices = ref_serve.stitched_probs(
            ref, vol, tuple(hp["roi_size"]), stride, coverage, "cpu")
        assert want_slices == slices
        assert float((probs - want).abs().max()) < 1e-5
        assert torch.equal(crop.long(), want.argmax(-1))


@pytest.mark.parametrize("workload", ["tune_downstream_b16",
                                      "pretrain_mv_b14"])
def test_reference_follows_training_steps(workload):
    cell = tiny_cell(workload)
    out = common.driver(cell).run(cell)
    assert out.correct
    for name, (value, _) in out.checks.items():
        assert value < 1e-3, (name, value)
