"""PyTorch port: the pretraining trainers data parallel on two gloo ranks
against the JAX package's ``mesh_data: 2``, on the CPU (the harness of
``tests/test_torch_dp.py``: two ``tests/torch_dp_worker.py`` processes,
the JAX references in this process, the same initial checkpoint).

* Phase 2, ``self_supervised_learning_decoder`` (``reduction_factor: 1``,
  so that both packages' jitters are 0; no ``_valid``: the wrap-pad
  duplicates count in both), and phase 1 (the views drawn from the JAX
  step's keys for the global batch of 2, then cut to each rank's row):
  every per-epoch training loss equals the JAX fit's to 2e-4 relative
  (the JAX DP test's tolerance; they agree to ~1e-6), and both ranks
  report the same losses.
* The validation losses, taken after the steps, to 1e-2: the biases that
  a batch-statistics BatchNorm or an instance norm cancels have a true
  gradient of 0, every summation order computes other float noise there,
  and Adam turns it into full steps of either sign
  (``tests/test_torch_phase2.py`` holds those tensors to Adam's bound).
  On these fits the JAX package's own ``mesh_data: 2`` and one-device
  validation losses differ by up to 4.5e-3 (phase 1's rotation loss).
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.augment \
    import mask_shape
from test_dp_trainers import dataset  # noqa: F401
from test_torch_dp import (LOSS_RTOL, RUNS, SEED, _fit_run, _init_checkpoint,
                           _jax_fit, _port_hparams, _scalars, _start_ranks)
from test_torch_phase1 import _jax_draws

# Validation losses, after the steps: the normalization-cancelled biases'
# noise steps (module docstring).
VAL_RTOL = 1e-2
TAGS = {"phase2": ("prt",), "phase1": ("rec", "rot", "con", "tot")}
MODES = {"phase2": "self_supervised_learning_decoder",
         "phase1": "self_supervised_learning_encoder"}


def _phase1_draws(n: int = 8) -> list:
    """The views the JAX phase-1 trainer draws at its first ``n`` steps
    (training, then validation; the global batch): its key chain from
    ``seed``, after the initialization's split."""
    hp = _port_hparams(MODES["phase1"], **RUNS["phase1"][1])
    n_patches = int(np.prod(mask_shape(tuple(hp.roi_size),
                                       tuple(hp.masking_shape))))
    rng = jax.random.PRNGKey(SEED)
    rng, _, _ = jax.random.split(rng, 3)
    out = []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        d = _jax_draws(k, hp.batch_size_multi_view, n_patches, 0)
        out.append({key: getattr(d, key).tolist()
                    for key in ("rot_i", "rot_j", "rank_i", "rank_j")})
    return out


@pytest.fixture(scope="module")
def pretrain(dataset, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("dp_torch_pretrain")
    inits = {name: _init_checkpoint(root / f"init_{name}.ckpt", mode,
                                    dataset)
             for name, mode in MODES.items()}
    runs = [_fit_run(name, dataset, root, inits[name]) for name in MODES]
    runs[-1]["draws"] = _phase1_draws()
    wait = _start_ranks(root, runs, units=False)
    mp = pytest.MonkeyPatch()
    jax_out = {name: _jax_fit(name, dataset, root, inits[name], mp,
                              TAGS[name]) for name in MODES}
    mp.undo()
    return {"root": root, "ranks": wait(), "jax": jax_out}


@pytest.mark.parametrize("name", list(MODES))
def test_pretraining_fits_match_jax_mesh_data_2(pretrain, name):
    r0, r1 = (r[name] for r in pretrain["ranks"])
    assert r0["losses"] == r1["losses"] and r0["losses"]
    assert r0["val_losses"] == r1["val_losses"] and r0["val_losses"]
    summary = Path(pretrain["root"]) / name / "summary"
    assert not (summary / "rank1").exists()
    for split, rtol in (("train_loss", LOSS_RTOL), ("val_loss", VAL_RTOL)):
        for t in TAGS[name]:
            tag = f"{split}/{t}"
            got = _scalars(summary / "rank0", tag)
            want = pretrain["jax"][name][tag]
            assert len(got) == len(want) >= 1, tag
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=tag)
