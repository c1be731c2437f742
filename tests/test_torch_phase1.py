"""PyTorch port: phase-1 multi-view pretraining against the JAX package.

On ``configurations/tiny_cpu.yml`` (fp32, dropout 0):

* The view ops, given the draws the JAX ops make from their keys
  (``jax.random.randint`` rotation classes, ``jax.random.permutation``
  mask ranks): ``rotate_by``, ``align_rotation``, ``mask_by`` (masked
  view and keep-mask) and the three axis swaps equal the JAX outputs
  exactly (they move and zero values, no arithmetic).
* The NT-Xent pair loss to 1e-6 relative and its gradient to 1e-5 of
  its largest magnitude; ``similarity_aggregation`` (softmax and mean),
  ``generate_pseudo_mask_from_multi_view`` (with a swap and rotations)
  and ``sinkhorn_knopp`` to 1e-5.
* The phase-1 forward's four outputs (reconstruction, rotation logits,
  contrastive codes, every ``out_vit`` entry) on the JAX variables, in
  eval mode, to 1e-4 absolute.
* Three ``MultiViewTrainer.train_step``s against the JAX
  ``_build_step(frozen, tx, True, choice)`` from the same variables and
  batches, the draws those the JAX step makes from its
  ``jax.random.split(rng, 5)`` keys: with encoder prompting and the rec,
  rot and con losses; and with mutual learning added, its three steps at
  swaps 0, 1, 2.  Each step's losses to 1e-4 relative; after three steps
  the trainables to 1e-4 absolute, the BatchNorm statistics to 1e-5, the
  optax leaves (counts exact, moments to 1e-4 of their largest
  magnitude).  (Phase 1 without prompts, whose frozen positional token
  bias has no flax leaf, crosses in ``tests/test_torch_checkpoint.py``.)  Biases a normalization on batch statistics
  cancels (the patch embedding's conv bias before its BatchNorm; each
  reconstruction conv's bias before its instance norm) have a true
  gradient of 0; both packages compute float noise there, which Adam
  turns into full steps of either sign: they are held to Adam's bound as
  in ``tests/test_torch_phase2.py``, and the running mean of the
  BatchNorm the patch embedding's bias feeds within 0.1 (the momentum)
  of that bound per forward since the first update, more than 1e-5.
* Mutual learning at the flagship roi, window and depth (128x128x8,
  8x8x4, depth 3; widths 8/16/32/64, batch 1): the reconstruction shape
  of each swapped input agrees between the packages (JAX
  ``jax.eval_shape`` of its forward, the port's forward), and the port's
  step raises ``ValueError`` for exactly the swaps whose reconstruction
  does not come back at the roi's shape, before it runs anything.
"""

from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu.losses import \
    contrastive_pair_loss as jax_contrastive
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    ModelConfig as JaxModelConfig
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinUnetR as JaxSwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    partition as jax_partition
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    augment as jax_aug
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    similarity as jax_sim
from medical_image_segmentation_with_visual_prompts_tpu.train.multi_view \
    import MultiViewTrainer as JaxTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.losses import \
    contrastive_pair_loss
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR, partition
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    augment, similarity
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    MultiViewTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
    .multi_view import ViewDraws
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import grouped_adamw_leaves
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .torch_import import load_flax_variables, to_flax_variables
from test_torch_phase2 import _flat, _jax_first_moments, _moments_by_path
from test_torch_swin_unetr import jax_model, tiny_conf

PHASE1 = "self_supervised_learning_encoder"


class _Null:
    dataset = ()

    def info(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass


def phase1_conf(**kw) -> dict:
    return tiny_conf(training_mode=PHASE1, seed=0, **kw)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def prompted():
    """The JAX model and variables of the prompted phase-1 config (one
    init compile for the forward and the train-step tests)."""
    conf = phase1_conf()
    jm, _, variables = jax_model(conf, seed=3)
    return conf, jm, variables


# ------------------------------------------------------------- view ops

@pytest.mark.parametrize("op", ["rotate", "align", "mask", "permute"])
def test_view_ops_match_jax_exactly(op):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 16, 8, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    if op == "rotate":
        want, ks = jax_aug.random_rotate(jnp.asarray(x), key)
        assert np.array_equal(
            np.asarray(ks), np.asarray(jax.random.randint(key, (3,), 0, 4)))
        got = augment.rotate_by(_t(x), _t(ks))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif op == "align":
        src, dst = np.array([1, 3, 2]), np.array([0, 2, 3])
        for s, d in ((src, None), (None, dst), (src, dst)):
            want = jax_aug.align_rotation(
                jnp.asarray(x), None if s is None else jnp.asarray(s),
                None if d is None else jnp.asarray(d))
            got = augment.align_rotation(_t(x), s, d)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # Rotating then aligning back is the identity.
        back = augment.align_rotation(augment.rotate_by(_t(x), src), src)
        np.testing.assert_array_equal(back.numpy(), x)
        with pytest.raises(ValueError):
            augment.align_rotation(_t(x))
    elif op == "mask":
        for ratio, patch in ((0.2, (2, 2, 2)), (0.5, (4, 4, 2)),
                             (0.75, (8, 4, 4))):
            want, keep = jax_aug.random_mask(jnp.asarray(x), key,
                                             (16, 16, 8), patch, ratio)
            n = int(np.prod([16 // patch[0], 16 // patch[1],
                             8 // patch[2]]))
            rank = np.asarray(jax.random.permutation(key, n))
            got, got_keep = augment.mask_by(_t(x), _t(rank), (16, 16, 8),
                                            patch, ratio)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got_keep.numpy(),
                                          np.asarray(keep))
            # An exact count of kept patches: round(n * (1 - ratio)).
            kept = got_keep.numpy()[::patch[0], ::patch[1], ::patch[2]]
            assert kept.sum() == round(n * (1 - ratio))
        with pytest.raises(ValueError, match="not compatible"):
            augment.mask_by(_t(x), _t(rank), (16, 16, 8), (3, 2, 2), 0.2)
    else:
        for choice in range(3):
            want = jax_aug.random_permute(jnp.asarray(x), choice)
            got = augment.random_permute(_t(x), choice)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert tuple(got.shape[1:4]) == augment.permuted_shape(
                (16, 16, 8), choice)
            np.testing.assert_array_equal(
                augment.permute_inverse(got, choice).numpy(), x)


def test_draws_are_the_jax_draws_kind():
    """The port's draws are the JAX draws' kind: classes in 0-3 and a
    permutation of the patch indices, from a torch generator."""
    g = torch.Generator().manual_seed(0)
    ks = augment.draw_rotations(g, 64)
    assert ks.dtype == torch.int64 and set(ks.tolist()) == {0, 1, 2, 3}
    rank = augment.draw_mask_rank(g, 64)
    assert sorted(rank.tolist()) == list(range(64))
    x = torch.randn(2, 16, 16, 8, 1)
    classes = augment.draw_rotations(g, 2)
    y = augment.rotate_by(x, classes)
    np.testing.assert_array_equal(
        augment.align_rotation(y, classes).numpy(), x.numpy())
    m, keep = augment.mask_by(x, augment.draw_mask_rank(g, 256),
                              (16, 16, 8), (2, 2, 2), 0.2)
    assert int(keep[::2, ::2, ::2].sum()) == round(256 * 0.8)
    assert torch.equal(m, x * keep[None, ..., None])
    with pytest.raises(ValueError, match="H == W"):
        augment.rotate_by(torch.zeros(1, 8, 4, 2, 1), [1])


# --------------------------------------------------------- loss, similarity

def test_contrastive_pair_loss_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    want, (ga, gb) = jax.value_and_grad(jax_contrastive, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = contrastive_pair_loss(ta, tb)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for g, w in ((ta.grad, ga), (tb.grad, gb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
    # A zero code: the norm's clip keeps the loss finite (the gradient at
    # a zero norm is NaN in JAX and 0 in torch, so only the value).
    b[3] = 0.0
    np.testing.assert_allclose(
        float(contrastive_pair_loss(_t(a), _t(b))),
        float(jax_contrastive(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


@pytest.mark.parametrize("fn", ["aggregation", "aggregation_mean",
                                "pseudo_mask", "sinkhorn"])
def test_similarity_matches_jax(fn):
    rng = np.random.default_rng(3)
    if fn.startswith("aggregation"):
        lat = rng.normal(size=(2, 10, 6)).astype(np.float32)
        prm = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
        mean = fn.endswith("mean")
        want = jax_sim.similarity_aggregation(
            jnp.asarray(lat), jnp.asarray(prm), mean_aggregation=mean)
        got = similarity.similarity_aggregation(_t(lat), _t(prm),
                                                mean_aggregation=mean)
    elif fn == "pseudo_mask":
        lat = rng.normal(size=(2, 4, 4, 6, 6)).astype(np.float32)
        prm = rng.normal(size=(2, 8, 6)).astype(np.float32)
        rot = np.array([1, 3])
        want = jax_sim.generate_pseudo_mask_from_multi_view(
            jnp.asarray(lat), jnp.asarray(prm), 4, src_rot=jnp.asarray(rot),
            permutation_choice=0)
        got = similarity.generate_pseudo_mask_from_multi_view(
            _t(lat), _t(prm), 4, src_rot=rot, permutation_choice=0)
        assert got.shape == (2, 4, 4, 6, 2)
    else:
        q = rng.random((2, 4, 4, 2, 3)).astype(np.float32)
        want = jax_sim.sinkhorn_knopp(jnp.asarray(q))
        got = similarity.sinkhorn_knopp(_t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------- model

def test_phase1_forward_matches_jax(prompted):
    conf, jm, variables = prompted
    x = np.random.default_rng(6).standard_normal(
        (2, 16, 16, 8, 1)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(
        variables, jnp.asarray(x))
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    load_flax_variables(model, variables)
    assert sorted(model.extra_heads) == ["contrastive_coding",
                                         "reconstruction",
                                         "rotation_prediction"]
    assert not hasattr(model, "decoder_blocks")
    assert not hasattr(model.prompt_tokens, "dec")
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    assert got["reconstruction"].shape == (2, 16, 16, 8, 1)
    assert got["contrastive_coding"].shape == (2, 16)
    for key in ("reconstruction", "rotation_prediction",
                "contrastive_coding"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    assert len(got["out_vit"]) == len(want["out_vit"]) == 4
    for i, (a, b) in enumerate(zip(got["out_vit"], want["out_vit"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0, err_msg=f"out_vit {i}")
    # The name map both ways on a built phase-1 model.
    back = to_flax_variables(model)
    for coll in variables:
        flat = _flat(variables[coll])
        assert sorted(_flat(back[coll])) == sorted(flat)
        for path, v in flat.items():
            np.testing.assert_array_equal(_flat(back[coll])[path], v)


def test_phase1_heads_follow_their_flags():
    for flags, heads in (
            (dict(use_reconstruction=False, use_mutual_learning=True),
             ["contrastive_coding", "reconstruction",
              "rotation_prediction"]),
            (dict(use_reconstruction=False, use_rotation_prediction=False),
             ["contrastive_coding"]),
            (dict(use_contrastive_learning=False),
             ["reconstruction", "rotation_prediction"])):
        model = SwinUnetR(ModelConfig.from_mapping(phase1_conf(**flags)))
        assert sorted(model.extra_heads) == heads
        labels = {partition.label_of(n) for n, _ in model.named_parameters()}
        assert "head_ssl" in labels and not any(
            lbl.startswith("decoder") for lbl in labels)
    with pytest.raises(ValueError, match="No loss"):
        MultiViewTrainer(Namespace(**phase1_conf(
            use_reconstruction=False, use_rotation_prediction=False,
            use_contrastive_learning=False)), SwinUnetR, None, None,
            _Null(), _Null(), device="cpu")


# ---------------------------------------------------------- train steps

def _fed_by_phase1(noise: set) -> set:
    """The BatchNorm a noise-gradient tensor shifts: the patch
    embedding's (the reconstruction convs feed instance norms, which keep
    no statistics)."""
    return {"input_layer_norm"} if any(
        p.startswith("input_layer_conv/") for p in noise) else set()


def _jax_draws(key, b: int, n_patches: int, choice: int) -> ViewDraws:
    kr1, kr2, km1, km2, _ = jax.random.split(key, 5)
    rot = [_t(jax.random.randint(k, (b,), 0, 4)) for k in (kr1, kr2)]
    rank = [_t(jax.random.permutation(k, n_patches)) for k in (km1, km2)]
    return ViewDraws(rot[0], rot[1], rank[0], rank[1], choice)


@pytest.mark.parametrize("case", ["prompted", "mutual"])
def test_train_steps_match_jax(case, prompted):
    conf, _, variables = prompted
    choices = (0, 0, 0)
    if case == "mutual":        # the same variables: no head changes
        conf = {**conf, "use_mutual_learning": True}
        choices = (0, 1, 2)
    hp = Namespace(**conf)
    jtr = JaxTrainer(hp, JaxSwinUnetR, _Null(), _Null(), _Null(), _Null())
    labels = jax_partition.trainable_labels(jtr.model_conf)
    trainable, frozen = jax_partition.split_params(variables["params"],
                                                   labels)
    bs = variables["batch_stats"]
    tx, _ = jtr.configure_optimizers(trainable)
    opt_state = tx.init(trainable)
    # Each swap is its own JAX program: compile them side by side.
    args = (trainable, bs, opt_state, jnp.zeros((2, 16, 16, 8, 1)),
            jax.random.PRNGKey(0))
    with ThreadPoolExecutor(3) as pool:
        steps = dict(zip(sorted(set(choices)), pool.map(
            lambda c: jtr._build_step(frozen, tx, True, c).lower(
                *args).compile(), sorted(set(choices)))))

    ptr = MultiViewTrainer(hp, SwinUnetR, None, None, _Null(), _Null(),
                           device="cpu")
    load_flax_variables(ptr.model, variables)
    ptr.prepare_fit()
    ptr.model.train()
    groups = sorted(g["name"] for g in ptr.optimizer.param_groups)
    assert groups == ["body", "prompt"]
    assert all(p.requires_grad for p in ptr.model.parameters())

    rng = np.random.default_rng(21)
    noise = set()
    for i, choice in enumerate(choices):
        image = rng.normal(0.4, 0.2, (2, 16, 16, 8, 1)).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        trainable, bs, opt_state, jparts, _ = steps[choice](
            trainable, bs, opt_state, jnp.asarray(image), key)
        draws = _jax_draws(key, 2, ptr.n_patches, choice)
        pparts = ptr.train_step({"image": image}, draws)
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
            jg = {k: 10 * np.abs(v).max()
                  for k, v in _jax_first_moments(opt_state).items()}
            floor = 1e-5 * max(jg.values())
            noise = {k for k, v in jg.items() if v < floor}
            pm = _moments_by_path(ptr)
            for k in noise:
                assert 10 * np.abs(pm[k]).max() < floor, k
            assert "input_layer_conv/Conv_0/bias" in noise
            assert noise <= {"input_layer_conv/Conv_0/bias"} | {
                f"head_reconstruction/conv_{j}/Conv_0/bias"
                for j in range(conf["depth_unet"] + 1)}, sorted(noise)

    got = _flat(to_flax_variables(ptr.model)["params"])
    lr_sum = sum(ptr.schedule(k) for k in range(3))
    for path, v in _flat(trainable).items():
        np.testing.assert_allclose(got[path], v, atol=2 * lr_sum * 1.01
                                   if path in noise else 1e-4, err_msg=path)
    # Each forward after the first update (steps 1 and 2: 2 views, 3 with
    # mutual learning) moves the running mean by 0.1 of the biases' gap.
    drifted = _fed_by_phase1(noise)
    forwards = (3 if case == "mutual" else 2) * (len(choices) - 1)
    mine = _flat(to_flax_variables(ptr.model)["batch_stats"])
    for path, v in _flat(bs).items():
        wide = path.endswith("mean") and path.rsplit("/", 1)[0] in drifted
        np.testing.assert_allclose(
            mine[path], v, err_msg=path,
            atol=1e-5 + (0.1 * 2 * lr_sum * 1.01 * forwards if wide else 0))
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


def test_first_step_moves_nothing_and_validation_is_deterministic():
    conf = phase1_conf(weight_decay_multi_view=0.5)
    tr = MultiViewTrainer(Namespace(**conf), SwinUnetR, None, None,
                          _Null(), _Null(), device="cpu")
    tr.prepare_fit()
    tr.model.train()
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(2, 16, 16, 8, 1)).astype(np.float32)}
    tr.train_step(batch)
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, before[n]), n
    tr.train_step(batch)
    assert all(not torch.equal(p, before[n])
               for n, p in tr.model.named_parameters()
               if not n.endswith(".bias"))
    tr.model.eval()
    draws = tr.draw_views(2)
    a, b = tr.eval_step(batch, draws), tr.eval_step(batch, draws)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(a) == ["con", "rec", "rot", "tot"]


# ------------------------------------------- mutual learning, flagship roi

def test_mutual_learning_refuses_what_jax_cannot_broadcast():
    conf = phase1_conf(depth_unet=3, hidden_channels=[8, 16, 32, 64],
                       attn_window_size=[8, 8, 4], roi_size=[128, 128, 8],
                       use_mutual_learning=True)
    jconf = JaxModelConfig.from_namespace(Namespace(**conf))
    jm = JaxSwinUnetR(jconf)
    x0 = jax.ShapeDtypeStruct((1, 128, 128, 8, 1), jnp.float32)
    variables = jax.eval_shape(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, deterministic=True), x0)
    tr = MultiViewTrainer(Namespace(**conf), SwinUnetR, None, None, _Null(),
                          _Null(), device="cpu")
    tr.prepare_fit()
    model = tr.model
    roi, refused = (128, 128, 8), []
    for choice in range(3):
        seen = augment.permuted_shape(roi, choice)
        x = jax.ShapeDtypeStruct((1, *seen, 1), jnp.float32)
        want = jax.eval_shape(lambda v, x: jm.apply(v, x, deterministic=True),
                              variables, x)["reconstruction"].shape
        with torch.inference_mode():
            got = model.eval()(torch.zeros((1, *seen, 1)))["reconstruction"]
        assert tuple(got.shape) == tuple(want) == (
            1, *model.reconstruction_shape(seen), 1), choice
        if augment.permuted_shape(tuple(got.shape[1:4]), choice) != roi:
            refused.append(choice)
    # The swapped views' reconstructions: 8x128x128 -> 16x128x128 and
    # 128x8x128 -> 128x16x128.
    assert refused == [1, 2]
    assert model.reconstruction_shape((8, 128, 128)) == (16, 128, 128)
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    image = {"image": np.random.default_rng(0).normal(
        size=(1, 128, 128, 8, 1)).astype(np.float32)}
    draws = tr.draw_views(1)
    for choice in (1, 2, 0):
        d = draws._replace(permute=choice)
        if choice in refused:
            with pytest.raises(ValueError, match=r"\(128, 128, 8\)") as err:
                tr.train_step(image, d)
            assert "(16, 128, 128)" in str(err.value) or \
                "(128, 16, 128)" in str(err.value)
            assert tr.step_count == 0
            for k, v in model.state_dict().items():
                assert torch.equal(v, before[k]), k
        else:
            parts = tr.train_step(image, d)
            assert sorted(parts) == ["con", "mut", "rec", "rot", "tot"]
            assert all(torch.isfinite(v) for v in parts.values())
    assert tr.step_count == 1
