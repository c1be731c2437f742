"""PyTorch port: the downstream prompt-tuning trainer against the JAX one.

* ``dice_focal_loss`` and ``seg_stats`` against the JAX functions: 1e-5
  relative (fp32, the same formulas); the stats are counts, exact.
* ``get_fit_loader_downstream``: the same batches (names, crops) as the
  JAX loader at the same seed, bit for bit (both window intensities in
  the native C++ loop of ``native/miseg_native.cpp``).
* Three train steps on ``configurations/tiny_cpu.yml`` (downstream, both
  prompt sets, dropout 0, weight decay 0.1) from the same weights and
  batches: the port's ``SegmentationTrainer.train_step`` against the JAX
  ``_build_steps`` train step.  Losses agree to 1e-4 relative, the first
  step's gradient of every trainable tensor to 1e-3 of its largest
  magnitude, and the BatchNorm running statistics after three steps to
  1e-5 (fp32 throughout; the port pad-folds nothing here, the JAX model
  runs its XLA path: float reassociation only).
* The same three steps in two other decoder layouts, the variables
  carried by the port's name map: ``full``/``swin`` (the Swin output
  layer's prompt tokens train) and ``none``/``unetr`` (the decoder prompt
  tokens get no gradient, yet optax decays them and counts their
  moments: the port steps them with a zero gradient).  Losses to 1e-4
  relative, every trainable tensor after three steps to 1e-4 absolute,
  the optimizer's optax leaves (counts exact, moments to 1e-4 of their
  largest magnitude).
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from medical_image_segmentation_with_visual_prompts_tpu.data import \
    datasets as jax_datasets
from medical_image_segmentation_with_visual_prompts_tpu.data.nifti import \
    save_nifti
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
from medical_image_segmentation_with_visual_prompts_tpu.utils.metrics import \
    seg_stats as jax_seg_stats
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.data import \
    get_fit_loader_downstream
from medical_image_segmentation_with_visual_prompts_tpu_torch.losses import \
    dice_focal_loss
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    partition
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    SegmentationTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import adamw_leaves
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils.torch_import \
    import flax_paths, load_flax_variables, to_flax_variables
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils.metrics \
    import DiceCoefficient, MeanIoU, seg_stats
from test_torch_swin_unetr import jax_model, tiny_conf


class _Null:
    def info(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass


@pytest.mark.parametrize("include_background", [True, False])
def test_loss_and_metrics_match_jax(include_background):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 6, 5, 4, 3)).astype(np.float32)
    target = rng.integers(0, 3, (3, 6, 5, 4, 1)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    for sw in (None, w):
        want = jax_dice_focal(jnp.asarray(logits), jnp.asarray(target),
                              gamma=4.0,
                              include_background=include_background,
                              sample_weights=None if sw is None
                              else jnp.asarray(sw))
        got = dice_focal_loss(torch.from_numpy(logits),
                              torch.from_numpy(target), gamma=4.0,
                              include_background=include_background,
                              sample_weights=None if sw is None
                              else torch.from_numpy(sw))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        js = jax_seg_stats(jnp.asarray(logits), jnp.asarray(target), 3,
                           sample_weights=None if sw is None
                           else jnp.asarray(sw))
        ps = seg_stats(torch.from_numpy(logits), torch.from_numpy(target), 3,
                       sample_weights=None if sw is None
                       else torch.from_numpy(sw))
        for a, b in zip(ps, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    iou, dice = MeanIoU(3), DiceCoefficient(3)
    for m in (iou, dice):
        m.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert 0.0 < iou.compute() < dice.compute() < 1.0


def _dataset(tmp_path, n=5, seed=0):
    rng = np.random.default_rng(seed)
    (tmp_path / "img").mkdir()
    (tmp_path / "msk").mkdir()
    for k in range(n):
        shape = (18 + k, 16 + 2 * k, 8 + k % 3)
        img = rng.normal(0, 500, shape).astype(np.int16)
        msk = rng.integers(0, 3, shape).astype(np.int16)
        save_nifti(str(tmp_path / "img" / f"case{k}.nii.gz"), img)
        save_nifti(str(tmp_path / "msk" / f"case{k}.nii.gz"), msk)
    return tmp_path


def _loader_conf(root, **kw):
    conf = dict(training_mode="downstream", image_dir_downstream=str(
        root / "img"), mask_dir_downstream=str(root / "msk"),
        image_dict_key="image", mask_dict_key="mask",
        num_selected_data_downstream=-1, split_ratio=0.8,
        batch_size_downstream=2, num_samples_downstream=2,
        seg_input_size=[16, 16, 8], num_workers=2, seed=7,
        random_orientation=True, resize_content=False)
    conf.update(kw)
    return Namespace(**conf)


def test_fit_loader_gives_the_jax_batches(tmp_path):
    conf = _loader_conf(_dataset(tmp_path))
    for ours, theirs in zip(get_fit_loader_downstream(conf),
                            jax_datasets.get_fit_loader_downstream(conf)):
        assert len(ours) == len(theirs)
        for epoch in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) > 0, epoch
            for a, b in zip(got, want):
                assert a["name"] == b["name"]
                np.testing.assert_array_equal(a["image"], b["image"])
                np.testing.assert_array_equal(a["mask"], b["mask"])


def _train_conf():
    conf = tiny_conf(weight_decay_downstream=0.1, lr_downstream=1e-3,
                     active_labels_downstream=[0, 2], seed=0)
    return conf


def test_train_steps_match_jax():
    conf = _train_conf()
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
    ptr.configure_optimizers()
    ptr.model.train()

    # First-step gradients of the JAX loss (the train step's loss_fn).
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

    jgrads = jax.jit(jax.grad(loss_fn))(trainable, jnp.asarray(batches[0]["image"]),
                               jnp.asarray(batches[0]["mask"]))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, frozen)
    gtree = {"params": jax_partition.merge_params(jgrads, zeros),
             "batch_stats": jax.tree_util.tree_map(jnp.zeros_like, bs)}
    want_grads = export_state_dict(gtree, jconf)

    jlosses, plosses = [], []
    k = jax.random.PRNGKey(1)
    valid = jnp.ones((2,), jnp.float32)
    for i, batch in enumerate(batches):
        trainable, bs, opt_state, loss, _, _ = step(
            trainable, bs, opt_state, jnp.asarray(batch["image"]),
            jnp.asarray(batch["mask"]), k, valid)
        jlosses.append(float(loss))
        ploss, _ = ptr.train_step(batch)
        plosses.append(float(ploss))
        if i == 0:
            named = dict(ptr.model.named_parameters())
            n_checked = 0
            for name, p in named.items():
                if not p.requires_grad:
                    assert p.grad is None, name
                    continue
                want = np.asarray(want_grads[name], np.float32)
                got = p.grad.numpy()
                scale = np.abs(want).max()
                assert scale > 0 and np.isfinite(got).all(), name
                assert np.abs(got - want).max() <= 1e-3 * scale, \
                    (name, np.abs(got - want).max(), scale)
                n_checked += 1
            assert n_checked == len(partition.set_trainable(
                ptr.model, partition.downstream_labels(ptr.model_conf)))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    # Running statistics after three steps (biased-variance update).
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


@pytest.mark.parametrize("layout", [("full", "swin"), ("none", "unetr")],
                         ids="-".join)
def test_train_steps_match_jax_in_other_layouts(layout):
    conf = {**_train_conf(), "unetr_res_block": layout[0],
            "unetr_up_block": layout[1]}
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
    load_flax_variables(ptr.model, variables)
    ptr.configure_optimizers()
    ptr.model.train()
    named = dict(ptr.model.named_parameters())
    unused = {n for n in named if n.startswith("prompt_tokens.dec")} \
        if layout[1] == "unetr" else set()
    before = {n: named[n].detach().clone() for n in unused}

    rng = np.random.default_rng(12)
    k = jax.random.PRNGKey(1)
    valid = jnp.ones((2,), jnp.float32)
    jlosses, plosses = [], []
    for i in range(3):
        batch = {"image": rng.normal(0.4, 0.2, (2, 16, 16, 8, 1)).astype(
            np.float32), "mask": rng.integers(0, 3, (2, 16, 16, 8, 1)).astype(
            np.float32)}
        trainable, bs, opt_state, loss, _, _ = step(
            trainable, bs, opt_state, jnp.asarray(batch["image"]),
            jnp.asarray(batch["mask"]), k, valid)
        jlosses.append(float(loss))
        ploss, _ = ptr.train_step(batch)
        plosses.append(float(ploss))
        if i == 0:
            for name, p in named.items():
                if not p.requires_grad:
                    continue
                assert p.grad is not None and torch.isfinite(p.grad).all()
                assert (p.grad.abs().max() > 0) == (name not in unused), \
                    name
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    if layout[0] == "full":
        assert "prompt_tokens.out.0" in named and \
            named["prompt_tokens.out.0"].requires_grad
    # Every trainable tensor after three steps; unused tokens decayed.
    want = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(trainable).items()}
    got = {"/".join(k): v for k, v in traverse_util.flatten_dict(
        to_flax_variables(ptr.model)["params"]).items()}
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, atol=1e-4, err_msg=path)
    for n in unused:
        np.testing.assert_allclose(
            named[n].detach().numpy(),
            before[n].numpy() * (1 - 1e-3 * 0.1) ** 3, rtol=1e-6)
    # The optimizer state as optax leaves: counts, hyperparameters, moments.
    jleaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(opt_state)]
    pleaves = adamw_leaves(ptr.optimizer, ptr.model)
    assert len(pleaves) == len(jleaves)
    assert int(pleaves[0]) == int(pleaves[3]) == int(jleaves[0]) == 3
    for a, b in zip(pleaves[4:], jleaves[4:]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-4 * max(
            float(np.abs(b).max()), 1e-30))
    paths = [p for p, _ in flax_paths(ptr.model, [
        n for n, p in named.items() if p.requires_grad])]
    n = len(paths)
    for path, mu, nu in zip(paths, pleaves[4:4 + n], pleaves[4 + n:]):
        if path.startswith("prompt_tokens_dec") and unused:
            assert not mu.any() and not nu.any(), path


def test_trainer_runs_with_dropout_and_updates_only_the_prompts(tmp_path):
    """``train()`` end to end on the CPU: tiny model, dropout 0.1/0.1,
    synthetic volumes, a validation pass.  Only the downstream set moves;
    the BatchNorm running statistics move in training and stay in
    validation."""
    root = _dataset(tmp_path, n=4)
    conf = tiny_conf(attn_drop=0.1, proj_drop=0.1,
                     **vars(_loader_conf(root, random_orientation=False,
                                         seed=3)))
    hp = Namespace(**conf)
    train_loader, val_loader = get_fit_loader_downstream(hp)
    tr = SegmentationTrainer(hp, SwinUnetR, train_loader, val_loader,
                             _Null(), _Null(), device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train()
    assert len(tr.losses) == len(train_loader) == len(tr.step_ms) == 3
    assert all(np.isfinite(tr.losses))
    after = tr.model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    labels = partition.downstream_labels(tr.model_conf)
    for name, p in tr.model.named_parameters():
        trainable = partition.label_of(name) in labels
        assert (name in moved) == trainable, name
        if trainable:
            assert p.grad is not None and p.grad.abs().sum() > 0, name
    assert any(k.endswith("running_var") for k in moved)
    # The same seeds give the same run; another dropout seed another one.
    again = SegmentationTrainer(hp, SwinUnetR, *get_fit_loader_downstream(hp),
                                _Null(), _Null(), device="cpu")
    again.train()
    assert again.losses == tr.losses
    other = SegmentationTrainer(Namespace(**{**conf, "attn_drop": 0.0,
                                             "proj_drop": 0.0}), SwinUnetR,
                                get_fit_loader_downstream(hp)[0], None,
                                _Null(), _Null(), device="cpu")
    other.train()
    assert other.losses[0] != tr.losses[0]


def test_trainer_merges_a_backbone_checkpoint(tmp_path):
    """``load_ckpt_backbone``: every entry of a reference-schema ``.pt``
    whose name and shape match a model tensor is loaded (the JAX
    trainer's tolerant merge); other entries are skipped."""
    conf = tiny_conf()
    src = SwinUnetR(ModelConfig.from_mapping(conf))
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          if v.is_floating_point() else v
          for i, (k, v) in enumerate(src.state_dict().items())}
    head = "extra_heads.downstream.1.weight"
    sd[head] = torch.zeros(3, 3)              # shape mismatch: skipped
    sd["no.such.tensor"] = torch.zeros(1)     # unknown name: skipped
    ckpt = tmp_path / "backbone.pt"
    torch.save({"model_state_dict": sd}, ckpt)
    tr = SegmentationTrainer(Namespace(**tiny_conf(
        load_ckpt_backbone=True, load_ckpt_backbone_path=str(ckpt))),
        SwinUnetR, None, None, _Null(), _Null(), device="cpu")
    got = tr.model.state_dict()
    merged = [k for k in sd if k in got and sd[k].shape == got[k].shape]
    assert len(merged) == len(sd) - 2
    for k in merged:
        assert torch.equal(got[k], sd[k]), k
    assert got[head].shape != sd[head].shape and got[head].abs().sum() > 0
