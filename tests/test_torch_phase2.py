"""PyTorch port: the phase-2 students-teacher trainer against the JAX one.

On ``configurations/tiny_cpu.yml`` (fp32, dropout 0, both prompt sets):

* Three steps of the port's ``StudentsTeacherTrainer.train_step`` against
  the JAX ``_build_step(frozen, tx, train=True)`` from the same student
  and teacher variables and batches, the students' jitters those the
  JAX step draws from its key, in ``self_supervised_learning_decoder``
  and ``supervised_learning_all``: each step's losses to 1e-4 relative;
  after three steps every trainable tensor to 1e-4 absolute, every frozen
  tensor bit for bit unchanged, the teacher's parameters and both
  models' BatchNorm statistics to 1e-5, and the optimizer's optax leaves
  (the ``multi_transform`` of two ``adamw``s: counts exact, moments to
  1e-4 of their largest magnitude).  Some biases feed only a BatchNorm on
  batch statistics (the patch embedding's and the bottleneck conv's, the
  last decoder-0 block's MLP and LN2 biases), which removes them: their true gradient is 0 and
  both packages compute float noise (under 1e-5 of the largest first-step
  gradient), which Adam scales to a full step of either sign.  Those
  tensors are held to that: both first-step gradients under the noise
  floor, the moments to 1e-6 absolute, the values within Adam's bound
  (twice the summed learning rates) of each other, and the running mean
  of the BatchNorm that such a bias feeds within 0.1 (the momentum) of
  that bound more than 1e-5 (the variance is shift-free: 1e-5).
* The teacher's operand cache: a teacher forward after an EMA step
  equals a forward of a freshly built model holding the blended weights.
* The first step moves nothing (lr 0), as in optax; the grouped
  optimizer's leaves round-trip.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinUnetR as JaxSwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    partition as jax_partition
from medical_image_segmentation_with_visual_prompts_tpu.train \
    .students_teacher import StudentsTeacherTrainer as JaxTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR, partition
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    StudentsTeacherTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import (ema_update, grouped_adamw_leaves, load_grouped_adamw_leaves)
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .schedules import warmup_cosine
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .torch_import import load_flax_variables, to_flax_variables
from test_torch_swin_unetr import jax_model, tiny_conf

STUDENTS = ((12, 12, 8), (8, 8, 8))


class _Null:
    dataset = ()

    def info(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass


def phase2_conf(mode: str, **kw) -> dict:
    return tiny_conf(training_mode=mode, seed=0, **kw)


def _grid(shape):
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"),
                 -1).astype(np.float32)
    return g - (np.asarray(shape, np.float32) - 1) / 2


def make_batch(rng: np.random.Generator, b: int = 2) -> dict:
    """A phase-2 batch as the pretrain loader gives it: a 16x16x8 teacher
    crop with its centred grid, and each student a crop of both."""
    grid = _grid((16, 16, 8))
    batch = {"image": rng.normal(0.4, 0.2, (b, 16, 16, 8, 1)).astype(
        np.float32), "coord": np.stack([grid] * b)}
    for i, (h, w, d) in enumerate(STUDENTS):
        starts = rng.integers(0, 16 - h + 1, (b, 2))
        batch[f"image_st_{i}"] = rng.normal(0.4, 0.2, (b, h, w, d, 1)).astype(
            np.float32)
        batch[f"coord_st_{i}"] = np.stack([grid[a:a + h, c:c + w]
                                           for a, c in starts])
        batch[f"mask_st_{i}"] = rng.integers(0, 3, (b, h, w, d, 1)).astype(
            np.float32)
    return batch


def _flat(tree) -> dict:
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()
            if hasattr(v, "shape")}


def _jax_first_moments(opt_state) -> dict:
    """{flax path: mu} over both optax groups (MaskedNodes left out)."""
    out = {}
    for group in opt_state.inner_states.values():
        out.update(_flat(group.inner_state[0].mu))
    return out


@pytest.mark.parametrize("mode", ["self_supervised_learning_decoder",
                                  "supervised_learning_all"])
def test_train_steps_match_jax(mode):
    conf = phase2_conf(mode)
    hp = Namespace(**conf)
    jm, _, student = jax_model(conf, seed=3)
    _, _, teacher = jax_model(conf, seed=4)
    jtr = JaxTrainer(hp, JaxSwinUnetR, _Null(), _Null(), _Null(), _Null())
    labels = jax_partition.trainable_labels(jtr.model_conf)
    trainable, frozen = jax_partition.split_params(student["params"], labels)
    sbs = student["batch_stats"]
    tparams, tbs = teacher["params"], teacher["batch_stats"]
    tx, _ = jtr.configure_optimizers(trainable)
    opt_state = tx.init(trainable)
    step = jtr._build_step(frozen, tx, train=True)

    ptr = StudentsTeacherTrainer(hp, SwinUnetR, None, None, _Null(), _Null(),
                                 device="cpu")
    load_flax_variables(ptr.model, student)
    load_flax_variables(ptr.teacher, teacher)
    ptr.prepare_fit()
    ptr.model.train()
    ptr.teacher.train()
    frozen_before = {n: p.detach().clone()
                     for n, p in ptr.model.named_parameters()
                     if not p.requires_grad}
    assert frozen_before if mode.endswith("decoder") else not frozen_before

    rng = np.random.default_rng(21)
    noise = set()
    n = len(STUDENTS)
    high = max(int(np.ceil(float(conf["reduction_factor"]))), 1)
    for i in range(3):
        batch = make_batch(rng)
        key = jax.random.PRNGKey(100 + i)
        loss_key = jax.random.split(key, n + 2)[n + 1]
        jitters = [np.asarray(jax.random.randint(
            jax.random.fold_in(loss_key, s), (6,), 0, high)).tolist()
            for s in range(n)]
        keys = ["image", "coord"] + [f"{k}_st_{s}" for k in ("image", "coord")
                                     for s in range(n)]
        if ptr.supervised:
            keys.append("mask_st_0")
        (trainable, sbs, tparams, tbs, opt_state, jparts, _, _) = step(
            trainable, sbs, tparams, tbs, opt_state,
            {k: jnp.asarray(batch[k]) for k in keys}, key)
        pparts, _ = ptr.train_step(batch, jitters)
        assert sorted(pparts) == sorted(jparts) == sorted(ptr.loss_names)
        for name in pparts:
            np.testing.assert_allclose(float(pparts[name]),
                                       float(jparts[name]), rtol=1e-4,
                                       err_msg=f"step {i} {name}")
        if i == 0:
            for name, p in ptr.model.named_parameters():
                if p.requires_grad:
                    assert p.grad is not None and torch.isfinite(
                        p.grad).all(), name
            # First-step gradients are 10x the first moments.
            jg = {k: 10 * np.abs(v).max()
                  for k, v in _jax_first_moments(opt_state).items()}
            floor = 1e-5 * max(jg.values())
            noise = {k for k, v in jg.items() if v < floor}
            pm = _moments_by_path(ptr)
            for k in noise:
                assert 10 * np.abs(pm[k]).max() < floor, k
            assert len(noise) < len(jg) // 10, sorted(noise)

    got = _flat(to_flax_variables(ptr.model)["params"])
    lr_sum = sum(ptr.schedule(k) for k in range(3))
    for path, v in _flat(trainable).items():
        np.testing.assert_allclose(got[path], v, atol=2 * lr_sum * 1.01
                                   if path in noise else 1e-4, err_msg=path)
    for name, p in ptr.model.named_parameters():
        if name in frozen_before:
            assert torch.equal(p, frozen_before[name]), name
    drifted = _fed_by(noise, conf["depth_unet"])
    for tree, model in (({"params": tparams, "batch_stats": tbs},
                         ptr.teacher),
                        ({"batch_stats": sbs}, ptr.model)):
        mine = to_flax_variables(model)
        for coll in tree:
            for path, v in _flat(tree[coll]).items():
                wide = model is ptr.model and path.endswith("mean") and \
                    path.rsplit("/", 1)[0] in drifted
                np.testing.assert_allclose(
                    _flat(mine[coll])[path], v, err_msg=path,
                    atol=1e-5 + (0.1 * 2 * lr_sum * 1.01 if wide else 0))
    jleaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(opt_state)]
    pleaves = grouped_adamw_leaves(ptr.optimizer, ptr.model, ptr.step_count)
    assert len(pleaves) == len(jleaves)
    for a, b in zip(pleaves, jleaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.dtype == np.float32 or int(a) == int(b) == 3
    pm, jm_ = _moments_by_path(ptr), _jax_first_moments(opt_state)
    assert sorted(pm) == sorted(jm_)
    for path, b in jm_.items():
        np.testing.assert_allclose(pm[path], b, atol=1e-6 if path in noise
                                   else 1e-4 * float(np.abs(b).max()),
                                   err_msg=path)


def _fed_by(noise: set, depth: int) -> set:
    """The BatchNorms (flax paths) whose input a tensor in ``noise``
    shifts: the patch embedding's norm takes its conv, each up block's
    input norm the block before it (the first, the bottleneck), the
    segmentation head's the last up block."""
    feeds = {"input_layer_norm": "input_layer_conv/",
             "decoder_blocks_0/norm_concat": "bottleneck/",
             "head_segmentation/norm": f"decoder_blocks_{depth - 1}/"}
    feeds.update({f"decoder_blocks_{j}/norm_concat": f"decoder_blocks_{j - 1}/"
                  for j in range(1, depth)})
    return {bn for bn, up in feeds.items()
            if any(p.startswith(up) for p in noise)}


def _moments_by_path(trainer) -> dict:
    """{flax path: first moment} of the port's optimizer."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        .common import _group_layout
    leaves = grouped_adamw_leaves(trainer.optimizer, trainer.model,
                                  trainer.step_count)
    out, i = {}, 0
    for _, paths in _group_layout(trainer.optimizer, trainer.model):
        for j, (path, _) in enumerate(paths):
            out[path] = leaves[i + 1 + j]
        i += 2 + 2 * len(paths)
    return out


def test_teacher_forward_after_ema_equals_a_fresh_model():
    """The teacher's blocks cache their operands without grad; the EMA
    writes its parameters in place, which must drop those caches."""
    conf = phase2_conf("self_supervised_learning_all")
    mc = ModelConfig.from_mapping(conf)
    student, teacher = SwinUnetR(mc), SwinUnetR(mc)
    g = torch.Generator().manual_seed(0)
    for m in (student, teacher):
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.2
    teacher.requires_grad_(False).eval()
    x = torch.randn((2, 16, 16, 8, 1), generator=g)
    t0 = {n: p.detach().clone() for n, p in teacher.named_parameters()}
    with torch.no_grad():
        before = teacher(x)["latent_outputs"]
        ema_update(teacher, student, 0.9)
        after = teacher(x)["latent_outputs"]
        fresh = SwinUnetR(mc).eval()
        fresh.load_state_dict(teacher.state_dict())
        want = fresh(x)["latent_outputs"]
    assert not torch.allclose(before, after)
    assert torch.equal(after, want)
    for (name, p), s in zip(teacher.named_parameters(), student.parameters()):
        torch.testing.assert_close(p, 0.9 * t0[name] + 0.1 * s,
                                   rtol=1e-6, atol=1e-7)


def test_first_step_moves_nothing_and_leaves_round_trip():
    conf = phase2_conf("supervised_learning_decoder",
                       weight_decay_students_teacher=0.5)
    tr = StudentsTeacherTrainer(Namespace(**conf), SwinUnetR, None, None,
                                _Null(), _Null(), device="cpu")
    tr.prepare_fit()
    tr.model.train()
    tr.teacher.train()
    names = [n for g in tr.optimizer.param_groups for n in
             [g["name"]] * len(g["params"])]
    assert sorted(set(names)) == ["base", "prompt"]
    labels = partition.trainable_labels(tr.model_conf)
    assert "encoder_prompt" not in labels and "head_segmentation" in labels
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    rng = np.random.default_rng(3)
    tr.train_step(make_batch(rng))
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, before[n]), n
    tr.train_step(make_batch(rng))
    moved = [n for n, p in tr.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert moved and all(partition.label_of(n) in labels for n in moved)
    sched = warmup_cosine(float(conf["lr_students_teacher"]), 2, 20)
    assert sched(0) == 0.0 and sched(2) == float(conf["lr_students_teacher"])
    assert tr.optimizer.param_groups[0]["lr"] == sched(1)
    leaves = grouped_adamw_leaves(tr.optimizer, tr.model, 2)
    other = StudentsTeacherTrainer(Namespace(**conf), SwinUnetR, None, None,
                                   _Null(), _Null(), device="cpu")
    other.prepare_fit()
    assert load_grouped_adamw_leaves(other.optimizer, other.model,
                                     leaves) == 2
    for a, b in zip(grouped_adamw_leaves(other.optimizer, other.model, 2),
                    leaves):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        grouped_adamw_leaves(tr.optimizer, tr.model, 3)
