"""PyTorch port: training through the unfused Swin block, against the JAX
package (the attention Functions' gradients and the dropout branch are
in ``tests/test_torch_attention_grads.py``).

* Three train steps of ``configurations/tiny_cpu.yml`` through the
  unfused block (dropout 0) against the JAX ``_build_steps`` step, to the
  tolerances ``tests/test_torch_train.py`` holds the fused path to:
  losses 1e-4 relative, the first step's gradients 1e-3 of their largest
  magnitude, BatchNorm statistics 1e-5 and the trained tensors 1e-4.
* ``use_checkpoint`` with dropout on: the gradients bit-identical to
  those without it (the recompute draws the same masks).
* A phase-2 and a phase-1 fit through ``main`` with
  ``MIVP_NO_FUSED_BLOCK=1`` (dropout 0): each step's losses within 1e-4
  relative of the fused fit's on the same data.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from medical_image_segmentation_with_visual_prompts_tpu.losses import \
    dice_focal_loss as jax_dice_focal
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinUnetR as JaxSwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    partition as jax_partition
from medical_image_segmentation_with_visual_prompts_tpu.ops.augment import \
    map_label_indices as jax_map_labels
from medical_image_segmentation_with_visual_prompts_tpu.train.common import \
    adamw as jax_adamw
from medical_image_segmentation_with_visual_prompts_tpu.train.segmentation \
    import SegmentationTrainer as JaxTrainer
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch import (
    config, main)
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    SegmentationTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
from test_torch_cli import _volumes, argv, cli_args
from test_torch_swin_unetr import jax_model, tiny_conf



class _Null:
    def info(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass


def test_unfused_train_steps_match_jax():
    conf = tiny_conf(weight_decay_downstream=0.1, lr_downstream=1e-3,
                     active_labels_downstream=[0, 2], seed=0)
    hp = Namespace(**conf)
    jm, jconf, variables = jax_model(conf, seed=3)
    jtr = JaxTrainer(hp, JaxSwinUnetR, None, None, _Null(), _Null())
    labels = jax_partition.trainable_labels(jtr.model_conf)
    trainable, frozen = jax_partition.split_params(variables["params"],
                                                   labels)
    bs = variables["batch_stats"]
    tx = optax.inject_hyperparams(jax_adamw)(lr=1e-3, weight_decay=0.1)
    opt_state = tx.init(trainable)
    step, _ = jtr._build_steps(frozen, tx)

    ptr = SegmentationTrainer(hp, SwinUnetR, None, None, _Null(), _Null(),
                              device="cpu")
    ptr.model.load_state_dict(export_state_dict(variables, jconf),
                              strict=True)
    ptr.model.set_fused_block(False).train()
    ptr.configure_optimizers()
    rng = np.random.default_rng(11)
    batches = [{"image": rng.normal(0.4, 0.2, (2, 16, 16, 8, 1)).astype(
        np.float32), "mask": rng.integers(0, 3, (2, 16, 16, 8, 1)).astype(
        np.float32)} for _ in range(3)]

    def loss_fn(tr, image, mask):
        params = jax_partition.merge_params(tr, frozen)
        out, _ = jm.apply({"params": params, "batch_stats": bs}, image,
                          deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
        return jax_dice_focal(out["downstream"],
                              jax_map_labels(mask, (0, 2)), gamma=4.0,
                              include_background=True)

    jgrads = jax.jit(jax.grad(loss_fn))(
        trainable, jnp.asarray(batches[0]["image"]),
        jnp.asarray(batches[0]["mask"]))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, frozen)
    want_grads = export_state_dict(
        {"params": jax_partition.merge_params(jgrads, zeros),
         "batch_stats": jax.tree_util.tree_map(jnp.zeros_like, bs)}, jconf)
    jlosses, plosses = [], []
    valid = jnp.ones((2,), jnp.float32)
    for i, batch in enumerate(batches):
        trainable, bs, opt_state, loss, _, _ = step(
            trainable, bs, opt_state, jnp.asarray(batch["image"]),
            jnp.asarray(batch["mask"]), jax.random.PRNGKey(1), valid)
        jlosses.append(float(loss))
        plosses.append(float(ptr.train_step(batch)[0]))
        if i == 0:
            n_checked = 0
            for name, p in ptr.model.named_parameters():
                if not p.requires_grad:
                    continue
                want = np.asarray(want_grads[name], np.float32)
                scale = np.abs(want).max()
                assert scale > 0 and np.isfinite(p.grad.numpy()).all()
                err = np.abs(p.grad.numpy() - want).max()
                assert err <= 1e-3 * scale, (name, err, scale)
                n_checked += 1
            assert n_checked > 0
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    want_sd = export_state_dict({"params": jax_partition.merge_params(
        trainable, frozen), "batch_stats": bs}, jconf)
    for name, t in ptr.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(t) == 3, name
        elif name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), np.asarray(want_sd[name]),
                                       atol=1e-5, err_msg=name)
        elif "prompt_tokens" in name or "extra_heads" in name:
            np.testing.assert_allclose(t.numpy(), np.asarray(want_sd[name]),
                                       atol=1e-4, err_msg=name)


def test_checkpointed_unfused_gradients_are_bit_identical():
    base = tiny_conf(attn_drop=0.1, proj_drop=0.1)
    grads = []
    for use_checkpoint in (False, True):
        model = SwinUnetR(ModelConfig.from_mapping(
            dict(base, use_checkpoint=use_checkpoint)), dropout_seed=3)
        init_weights(model, torch.Generator().manual_seed(0))
        model.set_fused_block(False).train()
        assert {b.use_checkpoint for b in model.modules()
                if hasattr(b, "fused_block")} == {use_checkpoint}
        x = torch.randn(2, 16, 16, 8, 1,
                        generator=torch.Generator().manual_seed(1))
        (model(x) ** 2).mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert len(grads[0]) == len(grads[1]) > 0
    for name, g in grads[0].items():
        assert g is not None and torch.isfinite(g).all(), name
        assert torch.equal(g, grads[1][name]), name


@pytest.mark.parametrize("mode", ["supervised_learning_all",
                                  "self_supervised_learning_encoder"])
def test_pretraining_fits_through_the_unfused_block(mode, tmp_path,
                                                    monkeypatch):
    for attr in ("DEFAULT_CKPT_DIR", "DEFAULT_ROOT_LOG_DIR"):
        monkeypatch.setattr(config, attr, tmp_path / attr)
    _volumes(tmp_path, "pre", [(20 + k, 18, 9) for k in range(3)], 6)
    conf = tiny_conf(image_dir_pretrain=str(tmp_path / "pre_img"),
                     image_dir_supervised=str(tmp_path / "pre_img"),
                     mask_dir_supervised=str(tmp_path / "pre_msk"))
    for key in ("training_mode", "use_encoder_prompting",
                "use_decoder_prompting"):
        conf.pop(key)
    (tmp_path / "p.yml").write_text(yaml.safe_dump(conf))
    losses = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MIVP_NO_FUSED_BLOCK", flag)
        args = main.build_parser().parse_args(argv(cli_args(
            training_mode=mode, configs=str(tmp_path / "p.yml"),
            use_decoder_prompting=mode != "self_supervised_learning_encoder")))
        tr = main.main(args.mode, config.get_full_configs(args), args.device)
        assert {b.fused_block for b in tr.model.modules()
                if hasattr(b, "fused_block")} == {flag == "0"}
        losses[flag] = tr.losses
    assert len(losses["1"]) == len(losses["0"]) == 2
    for got, want in zip(losses["1"], losses["0"]):
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.isfinite(got[name])
            assert abs(got[name] - want[name]) <= 1e-4 * abs(want[name]), \
                (name, got[name], want[name])
