"""PyTorch port: the checkpoint converter CLIs against the JAX package's.

* ``utils/torch_export.py`` (a msgpack checkpoint -> a reference-named
  ``.pt``) on a JAX trainer-format checkpoint of the tiny downstream
  model: the same keys, in the same order, and the same arrays, bit for
  bit, as the JAX ``export_state_dict`` (the ``num_batches_tracked``
  int64 zeros included, no ``pe.relative_dist_*``); the file loads
  through ``load_reference_checkpoint`` into the port's model strictly.
* Export then import (``utils/torch_import.py::main``) gives the model's
  variables back bit for bit in the ``full``/``swin`` and
  ``simple``/``unetr`` layouts, where the JAX exporter's table raises.
* The import CLI on the JAX tests' synthetic reference state dict
  (``tests/test_torch_import.py::_synthetic_state_dict``) writes the
  leaves of the JAX ``import_state_dict``, bit for bit, and prints the
  same report counts.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    checkpoint as jax_ckpt
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict as jax_export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_import \
    import import_state_dict as jax_import_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    checkpoint, init_weights, load_reference_checkpoint, torch_export,
    torch_import)
from test_torch_checkpoint import assert_trees_equal
from test_torch_import import _synthetic_state_dict
from test_torch_swin_unetr import jax_model, tiny_conf


def _yaml(path, conf: dict) -> str:
    path.write_text(yaml.safe_dump(
        {k: list(v) if isinstance(v, tuple) else v for k, v in conf.items()}))
    return str(path)


@pytest.fixture(scope="module")
def tiny_jax():
    """The tiny downstream config and the JAX model's variables."""
    conf = tiny_conf()
    _, jconf, variables = jax_model(conf)
    return conf, jconf, variables


def test_export_cli_writes_the_jax_exporters_state_dict(tmp_path, capsys,
                                                        tiny_jax):
    conf, jconf, variables = tiny_jax
    src, dst = tmp_path / "jax.ckpt", tmp_path / "out.pt"
    jax_ckpt.save_checkpoint(src, 3, variables)
    torch_export.main([str(src), str(dst), "--configs",
                       _yaml(tmp_path / "tiny.yml", conf)])
    assert f"wrote {dst}:" in capsys.readouterr().out
    got = torch.load(dst, weights_only=True)["model_state_dict"]
    want = jax_export_state_dict(variables, jconf)
    assert list(got) == list(want)
    assert not any(".pe.relative_dist_" in k for k in got)
    for key, value in want.items():
        assert got[key].numpy().dtype == value.dtype, key
        assert np.array_equal(got[key].numpy(), value), key
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    model.load_state_dict(load_reference_checkpoint(dst), strict=True)


@pytest.mark.parametrize("res,up", [("full", "swin"), ("simple", "unetr")])
def test_export_then_import_round_trips(tmp_path, capsys, res, up):
    conf = tiny_conf(unetr_res_block=res, unetr_up_block=up)
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    init_weights(model, torch.Generator().manual_seed(5))
    want = torch_import.to_flax_variables(model)
    yml = _yaml(tmp_path / "layout.yml", conf)
    checkpoint.save_checkpoint(tmp_path / "a.ckpt", 0, want)
    torch_export.main([str(tmp_path / "a.ckpt"), str(tmp_path / "b.pt"),
                       "--configs", yml])
    torch_import.main([str(tmp_path / "b.pt"), str(tmp_path / "c.ckpt"),
                       "--configs", yml, "--strict"])
    out = capsys.readouterr().out
    assert "0 unmatched torch keys; 0 params left at init" in out
    back = checkpoint.load_checkpoint(tmp_path / "c.ckpt")
    assert_trees_equal(back["model_state_dict"], want)
    assert int(back["scheduler_state_dict"]["epoch"]) == 0


def test_import_cli_matches_the_jax_importer(tmp_path, capsys, tiny_jax):
    conf, jconf, variables = tiny_jax
    sd = _synthetic_state_dict(jconf, variables, np.random.default_rng(3))
    torch.save({"model_state_dict": {k: torch.from_numpy(np.asarray(v))
                                     for k, v in sd.items()},
                "current_epoch": 7}, tmp_path / "ref.pt")
    want, report = jax_import_state_dict(sd, variables, jconf)
    torch_import.main([str(tmp_path / "ref.pt"), str(tmp_path / "out.ckpt"),
                       "--configs", _yaml(tmp_path / "tiny.yml", conf)])
    out = capsys.readouterr().out
    assert (f"imported {len(report['imported'])} tensors; skipped "
            f"{len(report['skipped_buffers'])} buffers; "
            f"{len(report['unmatched_torch_keys'])} unmatched torch keys; "
            f"{len(report['unfilled_ours'])} params left at init") in out
    got = checkpoint.load_checkpoint(tmp_path / "out.ckpt")
    assert_trees_equal(got["model_state_dict"], jax.tree_util.tree_map(
        np.asarray, {c: want[c] for c in ("params", "batch_stats")}))
    assert got["optimizer_state_dict"] == {"__flat_leaves__": []}
