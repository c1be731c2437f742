"""PyTorch port: checkpoints of the JAX package's msgpack family.

* The standard-library codec (``utils/checkpoint.py``) against flax: the
  same bytes as ``flax.serialization.msgpack_serialize`` for the same
  tree, and each side restores the other's bytes with every leaf equal
  and of the same dtype (fixed trees and a hypothesis property over
  nested dicts of arrays and scalars); what it does not know, it refuses.
* Checkpoint files cross: a port-written file restores with the JAX
  ``load_checkpoint``/``restore_like`` and a JAX-written one with the
  port's, leaf for leaf, exactly.
* The name map (``utils/torch_import.py``) against the JAX
  ``export_state_dict``/``import_state_dict`` rules: the same rules table
  in every training mode and decoder layout, and ``to_flax_variables``/
  ``load_flax_variables`` exact on the tiny config in every layout and on
  the example config's widths at depth 1.  The JAX table names flax
  leaves that the JAX model does not build in the UNETR layouts (an up
  block's ``conv_block/layer/...``, and ``conv3`` where a residual block
  keeps its channel count), so its exporter raises there; the port's
  table follows the flax tree, and the tests hold both tables to it.
* Partition labels in every layout against the JAX ``label_of``.
* The optimizer leaves (``train/common.py``) against ``tx.init`` of the
  JAX trainer's optax state: the same structure, order and dtypes, exact
  values both ways.
* Fault C4: a backbone checkpoint written by the JAX ``save_checkpoint``
  merges into the port's trainer; the merged tensors equal the JAX
  exporter's view of the file bit for bit, the others keep their values.
* Phase 2: the trainable labels of each phase-2 mode are the JAX ones;
  the phase-2 trainers' checkpoints (student, ``teacher_state_dict``, the
  grouped optimizer's optax leaves, ``{"step": n}``) cross both ways: the
  port's file restores into the JAX trainer's own templates (its model
  variables and ``tx.init`` state) leaf for leaf, and the JAX trainer's
  file resumes the port's trainer bit for bit (epoch, step, both models,
  optimizer); a checkpoint without a teacher merges into the student,
  which the teacher then copies.
* Phase 1: the trainable labels are the JAX ones; the multi-view
  trainer's checkpoints (model, the ``body``/``prompt`` optax leaves,
  ``{"step": n}``) cross both ways: the port's file resumes the JAX
  ``MultiViewTrainer`` (its ``self_supervised_learning()`` restores the
  model leaf for leaf) and restores into its ``tx.init`` state, and the
  JAX trainer's file resumes the port's trainer bit for bit; a phase-1
  checkpoint from either package enters both packages' phase-2 trainers
  through the backbone-only merge with equal students (encoder and
  encoder prompts from the file, the proxy heads ignored), the teacher a
  copy of the student.
* With a side's prompting off the flax model builds no positional token
  bias there; the port keeps those tensors (frozen, unread) and its name
  map gives them no leaf, so the port's tree is the JAX model's
  (``jax.eval_shape``) in every mode.
"""

from argparse import Namespace

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization, traverse_util
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    partition as jax_partition
from medical_image_segmentation_with_visual_prompts_tpu.train.common import \
    adamw as jax_adamw
from medical_image_segmentation_with_visual_prompts_tpu.train \
    .multi_view import MultiViewTrainer as JaxMultiView
from medical_image_segmentation_with_visual_prompts_tpu.train \
    .students_teacher import StudentsTeacherTrainer as JaxStudentsTeacher
from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    checkpoint as jax_ckpt
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    ModelConfig as JaxModelConfig
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinUnetR as JaxSwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    torch_export as jax_export
from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    torch_import as jax_import
from medical_image_segmentation_with_visual_prompts_tpu.utils.summary import \
    model_summary as jax_model_summary
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    partition
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    MultiViewTrainer, SegmentationTrainer, StudentsTeacherTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import adamw_leaves, grouped_adamw_leaves, load_adamw_leaves
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    checkpoint as ckpt
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    torch_import
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils.summary \
    import model_summary
from test_torch_swin_unetr import jax_model, tiny_conf


class _Null:
    dataset = ()

    def info(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass


def assert_trees_equal(a, b, path="") -> None:
    """Same structure, every leaf equal (NaN-aware) with the same type
    and dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, (path, a, b)
        assert np.shape(a) == np.shape(b), path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), \
            (path, a, b)


def _crossed(tree) -> None:
    """Port bytes == flax bytes; each side restores the other's."""
    ours = ckpt.msgpack_serialize(tree)
    theirs = serialization.msgpack_serialize(tree)
    assert ours == theirs
    assert_trees_equal(serialization.msgpack_restore(ours),
                       ckpt.msgpack_restore(theirs))
    assert_trees_equal(ckpt.msgpack_restore(ours), tree)


def test_codec_matches_flax_on_every_type_it_takes():
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63 - 1, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
            -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    tree = {
        "ints": ints, "floats": [0.0, -1.5, 1e300, float("inf")],
        "flags": [True, False], "none": None, "empty": {}, "list": [],
        "strings": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
        "bytes": [b"", b"\x00" * 300, b"\x01" * 70000],
        "arrays": {dt: np.arange(6).astype(dt).reshape(2, 3)
                   for dt in ("float32", "float64", "float16", "int8",
                              "int32", "int64", "uint8", "uint64", "bool",
                              "complex64")},
        "shapes": [np.zeros((0,), np.float32), np.array(5, np.int32),
                   np.ones((1, 1, 1, 1, 2), np.float32),
                   np.zeros((3,) * 5, np.float32)],
        "scalars": [np.float32(2.5), np.int64(-7), np.bool_(True),
                    np.uint16(9)],
        "b": {"z": 1, "a": {"y": np.float32(1), "x": [np.ones(3)]}},
    }
    _crossed(tree)
    # Sizes that take each fixed and 8/16/32-bit header of maps and ext.
    _crossed({f"k{i:03d}": i for i in range(20)})
    _crossed([np.zeros((n,), np.uint8) for n in (1, 2, 4, 8, 16, 300)])


_keys = st.text(alphabet="abcxyz_0123456789", min_size=1, max_size=6)
_arrays = hnp.arrays(
    dtype=st.sampled_from([np.float32, np.float64, np.int32, np.int64,
                           np.uint8, np.bool_, np.float16]),
    shape=hnp.array_shapes(min_dims=0, max_dims=4, min_side=0, max_side=5))
_scalars = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False),
    st.booleans(), st.none(), st.text(max_size=40), st.binary(max_size=40),
    _arrays.map(lambda a: a[()] if a.ndim == 0 else a))
_trees = st.recursive(
    _scalars, lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(_keys, inner, max_size=5)), max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(_keys, _trees, max_size=5))
def test_codec_round_trips_against_flax_property(tree):
    _crossed(tree)


@pytest.mark.parametrize("case", ["tuple", "int_key", "object_array",
                                  "too_big", "ext_2", "bfloat16",
                                  "chunked", "trailing"])
def test_codec_refuses_what_it_does_not_know(case):
    import msgpack
    flax_bytes = {
        "ext_2": serialization.msgpack_serialize({"c": 1 + 2j}),
        "bfloat16": serialization.msgpack_serialize(
            {"a": np.asarray(jax.numpy.ones((2,), jax.numpy.bfloat16))}),
        "chunked": msgpack.packb({"__msgpack_chunked_array__": True}),
        "trailing": msgpack.packb(1) + b"\x01",
    }
    if case in flax_bytes:
        with pytest.raises(ValueError):
            ckpt.msgpack_restore(flax_bytes[case])
        return
    bad = {"tuple": {"t": (1, 2)}, "int_key": {1: 2},
           "object_array": {"o": np.array([object()])},
           "too_big": {"a": np.broadcast_to(np.zeros(1, np.uint8),
                                            (2 ** 30 + 1,))}}
    with pytest.raises((TypeError, ValueError)):
        ckpt.msgpack_serialize(bad[case])


@pytest.fixture(scope="module")
def tiny():
    conf = tiny_conf()
    jm, jconf, variables = jax_model(conf, seed=2)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    model.load_state_dict(export_state_dict(variables, jconf))
    return conf, jm, jconf, variables, model


def test_checkpoint_files_cross_both_ways(tmp_path, tiny):
    conf, _, _, variables, model = tiny
    opt = [np.asarray(3, np.int32), np.asarray(1e-3, np.float32),
           np.arange(5, dtype=np.float32)]
    ours = ckpt.save_checkpoint(tmp_path / "port", 4,
                                torch_import.to_flax_variables(model), opt,
                                {"epoch": 4})
    theirs = jax_ckpt.save_checkpoint(tmp_path / "jax", 4, variables, opt,
                                      {"epoch": 4})
    assert ours.name == theirs.name == "0004.ckpt"
    assert ours.read_bytes() == theirs.read_bytes()
    for loader in (ckpt.load_checkpoint, jax_ckpt.load_checkpoint):
        for path in (ours.parent, theirs):      # a directory: its last file
            got = loader(path)
            assert got["current_epoch"] == 4
            assert_trees_equal(got["model_state_dict"], variables)
            assert_trees_equal(got["optimizer_state_dict"],
                               {"__flat_leaves__": opt})
            assert_trees_equal(got["scheduler_state_dict"],
                               {"epoch": np.asarray(4)})
    loaded = ckpt.load_checkpoint(theirs)
    assert_trees_equal(ckpt.restore_like(variables,
                                         loaded["model_state_dict"]),
                       jax_ckpt.restore_like(variables,
                                             loaded["model_state_dict"]))
    assert_trees_equal(ckpt.merge_state(variables, {"params": {}}),
                       jax_ckpt.merge_state(variables, {"params": {}}))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_like(variables, {"params": {}})
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path)          # no *.ckpt directly in it


LAYOUTS = [(r, u) for r in ("none", "simple", "full")
           for u in ("swin", "unetr")]


def flax_leaves(conf: dict) -> set:
    """``collection/a/b`` of every leaf of the JAX model's variables
    (shapes only, ``jax.eval_shape``)."""
    jconf = JaxModelConfig.from_namespace(Namespace(**conf))
    x = jax.ShapeDtypeStruct((1, *conf["roi_size"], conf["input_channels"]),
                             np.float32)
    v = jax.eval_shape(lambda x: JaxSwinUnetR(jconf).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, deterministic=True), x)
    return {"/".join(k) for k in traverse_util.flatten_dict(v)}


def jax_table_faulty(layout) -> bool:
    """Layouts where the JAX rules table names leaves that do not exist:
    a ``full`` bottleneck's ``conv3``, the unetr up blocks' ``layer``."""
    return layout[0] == "full" or layout[1] == "unetr"


@pytest.mark.parametrize("mode", ["downstream", "supervised_learning_all",
                                  "self_supervised_learning_encoder"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rules_table_is_the_jax_one(mode, layout):
    """The port's table names every leaf of the JAX model's tree and no
    other; it is the JAX table wherever that one names real leaves, and
    elsewhere the JAX table with its two UNETR faults repaired."""
    raw = tiny_conf(training_mode=mode, unetr_res_block=layout[0],
                    unetr_up_block=layout[1])
    conf = ModelConfig.from_mapping(raw)
    ours = torch_import.build_key_rules(conf)
    theirs = jax_import.build_key_rules(conf)
    leaves = flax_leaves(raw)
    assert {f"{r[0]}/{r[1]}" for r in ours.values() if r} == leaves
    repaired, n_faults = {}, 0
    for key, rule in theirs.items():
        if rule and f"{rule[0]}/{rule[1]}" not in leaves:
            n_faults += 1
            key = key.replace(".conv_block.layer.", ".conv_block.")
            rule = (rule[0], rule[1].replace("/conv_block/layer/",
                                             "/conv_block/"), rule[2])
            if f"{rule[0]}/{rule[1]}" not in leaves:
                assert ".conv3." in key, key    # a projection not built
                continue
        repaired[key] = rule
    assert (n_faults > 0) == (jax_table_faulty(layout)
                              and mode != "self_supervised_learning_encoder")
    assert list(ours) == list(repaired)
    for key, rule in repaired.items():
        if rule is None:
            assert ours[key] is None, key
        else:
            tf = rule[2] if isinstance(rule[2], tuple) else rule[2].__name__
            otf = ours[key][2] if isinstance(ours[key][2], tuple) \
                else ours[key][2].__name__
            assert ours[key][:2] == rule[:2] and otf == tf, key


@pytest.mark.parametrize("layout", LAYOUTS)
def test_partition_labels_are_the_jax_ones(layout):
    """Every port parameter's label is the JAX ``label_of`` of the flax
    leaf it maps to, in every layout (the output layer's prompt tokens
    are decoder prompts, skip blocks and output layer decoder bodies)."""
    conf = ModelConfig.from_mapping(tiny_conf(
        unetr_res_block=layout[0], unetr_up_block=layout[1]))
    rules = torch_import.build_key_rules(conf)
    model = SwinUnetR(conf)
    labels = {}
    for name, _ in model.named_parameters():
        path = tuple(rules[name][1].split("/"))
        labels[name] = partition.label_of(name)
        assert labels[name] == jax_partition.label_of(path), name
    if layout[0] != "none" and layout[1] == "swin":
        assert labels["prompt_tokens.out.1"] == "decoder_prompt"
    if layout[0] != "none":
        assert {labels[n] for n in labels
                if n.startswith(("residual_blocks", "output_layer"))} <= \
            {"decoder_body", "decoder_bias_content", "decoder_prompt"}


def _example_depth1():
    conf = tiny_conf(depth_unet=1, hidden_channels=[48, 96],
                     num_heads_encoder=4, num_heads_decoder=4,
                     attn_window_size=[8, 8, 4], pos_bias_embed_dim=64,
                     tokens_per_prompt_encoder=64,
                     tokens_per_prompt_decoder=64, pad_mode="reference",
                     roi_size=[16, 16, 8], compute_dtype="float32")
    return conf


@pytest.mark.parametrize("which", ["tiny", "example_depth1"] + [
    f"tiny_{r}_{u}" for r, u in LAYOUTS if (r, u) != ("none", "swin")])
def test_name_map_is_the_exporter_exactly(which, tiny, monkeypatch):
    """Where the JAX table is faulty (``jax_table_faulty``) its exporter
    raises, and the comparison runs the JAX exporter and importer on the
    port's table."""
    layout = ("none", "swin")
    if which == "tiny":
        conf, _, jconf, variables, _ = tiny
    else:
        if which == "example_depth1":
            conf = _example_depth1()
        else:
            layout = tuple(which.split("_")[1:])
            conf = tiny_conf(unetr_res_block=layout[0],
                             unetr_up_block=layout[1])
        _, jconf, variables = jax_model(conf, seed=4)
        variables = jax.tree_util.tree_map(np.asarray, variables)
    if jax_table_faulty(layout):
        with pytest.raises(KeyError, match="does not exist"):
            export_state_dict(variables, jconf)
        monkeypatch.setattr(jax_export, "build_key_rules",
                            torch_import.build_key_rules)
        monkeypatch.setattr(jax_import, "build_key_rules",
                            torch_import.build_key_rules)
    sd = export_state_dict(variables, jconf)
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    torch_import.load_flax_variables(model, variables)
    own = model.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert own[k].dtype == torch.float32
            assert np.array_equal(own[k].numpy(), v), k
    back = torch_import.to_flax_variables(model)
    assert_trees_equal(back, variables)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    # And the JAX importer takes the port's view back exactly.
    imported, report = jax_import.import_state_dict(
        {k: v.numpy() for k, v in own.items()}, variables, jconf)
    assert not report["unmatched_torch_keys"] and not report["unfilled_ours"]
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, imported),
                       variables)
    with pytest.raises(KeyError):
        torch_import.load_flax_variables(model, {"params": {}})


def test_model_summary_matches_jax(tiny):
    _, _, _, variables, model = tiny
    assert model_summary(model) == jax_model_summary(variables["params"])


def _jax_opt_state(conf, jconf, variables):
    """The JAX trainer's optax state (``train/segmentation.py:80-82,161``)
    over the trainable subtree, and that subtree."""
    labels = jax_partition.trainable_labels(jconf)
    trainable, _ = jax_partition.split_params(variables["params"], labels)
    tx = optax.inject_hyperparams(jax_adamw)(
        lr=float(conf["lr_downstream"]),
        weight_decay=float(conf["weight_decay_downstream"]))
    return tx, trainable, tx.init(trainable)


def test_optimizer_leaves_are_the_optax_state(tiny):
    conf, _, jconf, variables, _ = tiny
    conf = {**conf, "weight_decay_downstream": 0.1}
    tx, trainable, state = _jax_opt_state(conf, jconf, variables)
    tr = SegmentationTrainer(Namespace(**conf), SwinUnetR, None, None,
                             _Null(), _Null(), device="cpu")
    torch_import.load_flax_variables(tr.model, variables)
    tr.configure_optimizers()
    want = jax.tree_util.tree_leaves(state)
    got = adamw_leaves(tr.optimizer, tr.model)     # before any step
    assert [(g.shape, g.dtype) for g in got] == \
        [(np.shape(w), np.asarray(w).dtype) for w in want]
    assert_trees_equal(got, [np.asarray(w) for w in want])
    # Moments with the parameters' own values: the order is the tree's.
    for p in (q for g in tr.optimizer.param_groups for q in g["params"]):
        tr.optimizer.state[p] = {"step": torch.tensor(3.0),
                                 "exp_avg": p.detach().clone(),
                                 "exp_avg_sq": p.detach() * p.detach()}
    restored = jax_ckpt.restore_like(
        state, {"__flat_leaves__": adamw_leaves(tr.optimizer, tr.model)})
    adam = restored.inner_state[0]
    assert int(restored.count) == int(adam.count) == 3
    assert float(restored.hyperparams["weight_decay"]) == np.float32(0.1)
    sq = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.asarray(a),
                                trainable)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, adam.mu),
                       jax.tree_util.tree_map(np.asarray, trainable))
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, adam.nu), sq)
    # The JAX state after one update, into a fresh port optimizer.
    grads = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.5), trainable)
    _, new_state = tx.update(grads, state, trainable)
    leaves = jax.tree_util.tree_leaves(new_state)
    fresh = SegmentationTrainer(Namespace(**conf), SwinUnetR, None, None,
                                _Null(), _Null(), device="cpu")
    torch_import.load_flax_variables(fresh.model, variables)
    fresh.configure_optimizers()
    load_adamw_leaves(fresh.optimizer, fresh.model, {"__flat_leaves__": [
        np.asarray(x) for x in leaves]})
    assert_trees_equal(adamw_leaves(fresh.optimizer, fresh.model),
                       [np.asarray(x) for x in leaves])
    for p in fresh.optimizer.state:
        assert float(fresh.optimizer.state[p]["step"]) == 1.0


def test_trainer_merges_a_jax_backbone_checkpoint(tmp_path, tiny):
    """Fault C4: the phase-2 backbone checkpoint of the JAX package (its
    msgpack family, no prompt tokens) merges into the downstream trainer
    as the JAX trainer merges it (``merge_state``); the ``.pt`` read is
    ``test_torch_train.py::test_trainer_merges_a_backbone_checkpoint``."""
    conf, _, jconf, dvars, _ = tiny
    bconf = tiny_conf(training_mode="supervised_learning_all",
                      use_encoder_prompting=False,
                      use_decoder_prompting=False)
    _, _, bvars = jax_model(bconf, seed=6)
    path = jax_ckpt.save_checkpoint(tmp_path / "backbone", 10, bvars, None,
                                    {"epoch": 10})
    fresh = SegmentationTrainer(Namespace(**conf), SwinUnetR, None, None,
                                _Null(), _Null(), device="cpu")
    merged = SegmentationTrainer(
        Namespace(**conf, load_ckpt_backbone=True,
                  load_ckpt_backbone_path=str(path)),
        SwinUnetR, None, None, _Null(), _Null(), device="cpu")
    # The JAX exporter's view of the JAX merge of the file into a
    # downstream model: the tensors whose flax leaf the file holds.
    loaded = jax_ckpt.load_checkpoint(path)["model_state_dict"]
    want = export_state_dict(jax_ckpt.merge_state(dvars, loaded), jconf)
    in_file = {f"{c}/{'/'.join(k)}" for c in loaded for k in
               traverse_util.flatten_dict(loaded[c])}
    rules = jax_import.build_key_rules(jconf)
    common = [k for k, r in rules.items() if r and f"{r[0]}/{r[1]}" in in_file]
    assert any(k.startswith("encoder_blocks") for k in common)
    assert any(k.startswith("decoder_blocks") for k in common)
    assert any(k.endswith("running_var") for k in common)
    before, after = fresh.model.state_dict(), merged.model.state_dict()
    for k in common:
        assert np.array_equal(after[k].numpy(), want[k]), k
    kept = [k for k in after if k not in common]
    assert any(k.startswith("prompt_tokens") for k in kept)
    assert any(k.startswith("extra_heads.downstream") for k in kept)
    assert any(k.endswith("pe.weights_token") for k in kept)
    for k in kept:
        assert torch.equal(after[k], before[k]), k


PHASE2 = ("self_supervised_learning_decoder", "self_supervised_learning_all",
          "supervised_learning_decoder", "supervised_learning_all")


@pytest.mark.parametrize("mode", PHASE2)
@pytest.mark.parametrize("prompting", [(True, True), (True, False),
                                       (False, False)])
def test_trainable_labels_are_the_jax_ones(mode, prompting):
    raw = tiny_conf(training_mode=mode, use_encoder_prompting=prompting[0],
                    use_decoder_prompting=prompting[1])
    assert partition.trainable_labels(ModelConfig.from_mapping(raw)) == \
        jax_partition.trainable_labels(
            JaxModelConfig.from_namespace(Namespace(**raw)))


def _phase2_jax_state(conf, seed=7):
    """The JAX phase-2 trainer's templates: student and teacher
    variables, its optimizer and the optimizer's initial state."""
    hp = Namespace(**conf)
    _, _, student = jax_model(conf, seed=seed)
    _, _, teacher = jax_model(conf, seed=seed + 1)
    student = jax.tree_util.tree_map(np.asarray, student)
    teacher = jax.tree_util.tree_map(np.asarray, teacher)
    jtr = JaxStudentsTeacher(hp, JaxSwinUnetR, _Null(), _Null(), _Null(),
                             _Null())
    labels = jax_partition.trainable_labels(jtr.model_conf)
    trainable, frozen = jax_partition.split_params(student["params"], labels)
    tx, _ = jtr.configure_optimizers(trainable)
    return student, teacher, trainable, frozen, tx


def _phase2_trainer(conf, **kw):
    return StudentsTeacherTrainer(Namespace(**conf, **kw), SwinUnetR, None,
                                  None, _Null(), _Null(), device="cpu")


@pytest.mark.parametrize("mode", ["supervised_learning_decoder",
                                  "self_supervised_learning_all"])
def test_phase2_checkpoints_cross_both_ways(tmp_path, mode):
    from test_torch_phase2 import make_batch
    conf = tiny_conf(training_mode=mode, seed=0)
    student, teacher, trainable, frozen, tx = _phase2_jax_state(conf)
    # The port writes after two steps; the JAX trainer's templates take it.
    ours = _phase2_trainer(conf, save_ckpt_backbone=True,
                           save_ckpt_backbone_path=str(tmp_path / "port"))
    ours.prepare_fit()
    ours.model.train()
    ours.teacher.train()
    rng = np.random.default_rng(0)
    for _ in range(2):
        ours.train_step(make_batch(rng))
    ours._save(0)
    got = jax_ckpt.load_checkpoint(tmp_path / "port" / "0001.ckpt")
    assert got["current_epoch"] == 1 and int(
        got["scheduler_state_dict"]["step"]) == 2
    for key, model in (("model_state_dict", ours.model),
                       ("teacher_state_dict", ours.teacher)):
        state = jax_ckpt.restore_like(
            {"params": student["params"],
             "batch_stats": student["batch_stats"]}, got[key])
        assert_trees_equal(jax.tree_util.tree_map(np.asarray, state),
                           torch_import.to_flax_variables(model))
    opt = jax_ckpt.restore_like(tx.init(trainable),
                                got["optimizer_state_dict"])
    assert_trees_equal([np.asarray(x) for x in jax.tree_util.tree_leaves(
        opt)], grouped_adamw_leaves(ours.optimizer, ours.model, 2))
    assert all(int(opt.inner_states[g].inner_state[0].count) == 2
               for g in ("base", "prompt"))

    # The JAX trainer writes (its state after one update); the port
    # resumes it bit for bit.
    grads = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25),
                                   trainable)
    _, state = tx.update(grads, tx.init(trainable), trainable)
    path = jax_ckpt.save_checkpoint(
        tmp_path / "jax", 11, student, state, {"step": 1},
        teacher_state=teacher)
    resumed = _phase2_trainer(conf, load_ckpt_backbone=True,
                              load_ckpt_backbone_path=str(path))
    assert resumed.prepare_fit() == 11 and resumed.step_count == 1
    assert_trees_equal(torch_import.to_flax_variables(resumed.model), student)
    assert_trees_equal(torch_import.to_flax_variables(resumed.teacher),
                       teacher)
    assert_trees_equal(
        grouped_adamw_leaves(resumed.optimizer, resumed.model, 1),
        [np.asarray(x) for x in jax.tree_util.tree_leaves(state)])


def test_phase2_backbone_checkpoint_merges_into_student_and_teacher(
        tmp_path):
    """A checkpoint without a teacher (here a downstream model's, with
    its prompt tokens and head): the student takes every leaf the file
    and the model share, keeps the rest, and the teacher copies it."""
    conf = tiny_conf(training_mode="supervised_learning_all", seed=0)
    _, _, dvars = jax_model(tiny_conf(), seed=9)
    path = jax_ckpt.save_checkpoint(tmp_path / "b", 3, dvars, None,
                                    {"epoch": 3})
    fresh = _phase2_trainer(conf)
    tr = _phase2_trainer(conf, load_ckpt_backbone=True,
                         load_ckpt_backbone_path=str(path))
    assert tr.prepare_fit() == 0 and tr.step_count == 0
    want = ckpt.merge_state(torch_import.to_flax_variables(fresh.model),
                            jax.tree_util.tree_map(np.asarray, dvars))
    assert_trees_equal(torch_import.to_flax_variables(tr.model), want)
    head = "extra_heads.segmentation.1.weight"
    assert torch.equal(tr.model.state_dict()[head],
                       fresh.model.state_dict()[head])
    assert not torch.equal(tr.model.state_dict()["bottleneck.weight"],
                           fresh.model.state_dict()["bottleneck.weight"])
    sd = tr.model.state_dict()
    for k, v in tr.teacher.state_dict().items():
        assert torch.equal(v, sd[k]), k


# --------------------------------------------------------------- phase 1

PHASE1 = "self_supervised_learning_encoder"


@pytest.mark.parametrize("prompting", [True, False])
def test_phase1_trainable_labels_are_the_jax_ones(prompting):
    raw = tiny_conf(training_mode=PHASE1, use_encoder_prompting=prompting)
    labels = partition.trainable_labels(ModelConfig.from_mapping(raw))
    assert labels == jax_partition.trainable_labels(
        JaxModelConfig.from_namespace(Namespace(**raw)))
    assert "head_ssl" in labels and ("encoder_prompt" in labels) == prompting


@pytest.mark.parametrize("mode", ["downstream", PHASE1,
                                  "supervised_learning_all"])
def test_name_map_follows_the_flax_tree_without_prompts(mode):
    """Fault C8: with prompting off the JAX blocks build no ``enc_token``
    / ``weights_token``; the port's map gives them no leaf (they stay in
    the model, frozen), so its tree is the JAX model's leaf for leaf and
    loads back."""
    raw = tiny_conf(training_mode=mode, use_encoder_prompting=False,
                    use_decoder_prompting=False)
    model = SwinUnetR(ModelConfig.from_mapping(raw))
    tree = torch_import.to_flax_variables(model)
    leaves = {f"{c}/{'/'.join(k)}" for c in tree
              for k in traverse_util.flatten_dict(tree[c])}
    assert leaves == flax_leaves(raw)
    assert not any("token" in leaf for leaf in leaves)
    other = SwinUnetR(ModelConfig.from_mapping(raw))
    torch_import.load_flax_variables(other, tree)
    assert_trees_equal(torch_import.to_flax_variables(other), tree)
    frozen = {n for n, _ in set_trainable_all(other)}
    assert not any(n.endswith(("weights_token", "enc_token.0"))
                   for n in frozen)


def set_trainable_all(model):
    return partition.set_trainable(
        model, partition.trainable_labels(model.conf))


def _phase1_trainer(conf, **kw):
    return MultiViewTrainer(Namespace(**conf, **kw), SwinUnetR, None, None,
                            _Null(), _Null(), device="cpu")


def _phase1_jax_state(conf):
    """The JAX phase-1 trainer, zero templates of its variables (shapes
    from ``jax.eval_shape``), its trainable subtree and optimizer."""
    jtr = JaxMultiView(Namespace(**conf), JaxSwinUnetR, _Null(), _Null(),
                       _Null(), _Null())
    x = jax.ShapeDtypeStruct((1, *conf["roi_size"], 1), np.float32)
    shapes = jax.eval_shape(lambda x: jtr.model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, deterministic=True), x)
    variables = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)
    labels = jax_partition.trainable_labels(jtr.model_conf)
    trainable, _ = jax_partition.split_params(variables["params"], labels)
    tx, _ = jtr.configure_optimizers(trainable)
    return jtr, variables, trainable, tx


def _port_phase1_file(tmp_path, conf) -> "Path":
    """The port's trainer after two steps, saved as ``0001.ckpt``."""
    ours = _phase1_trainer(conf, save_ckpt_backbone=True,
                           save_ckpt_backbone_path=str(tmp_path / "port"))
    ours.prepare_fit()
    ours.model.train()
    rng = np.random.default_rng(0)
    for _ in range(2):
        ours.train_step({"image": rng.normal(
            0.4, 0.2, (2, 16, 16, 8, 1)).astype(np.float32)})
    ours._save(0)
    return ours, tmp_path / "port" / "0001.ckpt"


@pytest.mark.parametrize("prompting", [True, False])
def test_phase1_checkpoints_cross_both_ways(tmp_path, prompting):
    conf = tiny_conf(training_mode=PHASE1, seed=0,
                     use_encoder_prompting=prompting)
    jtr, variables, trainable, tx = _phase1_jax_state(conf)
    ours, path = _port_phase1_file(tmp_path, conf)
    got = jax_ckpt.load_checkpoint(path)
    assert got["current_epoch"] == 1 and int(
        got["scheduler_state_dict"]["step"]) == 2
    state = jax_ckpt.restore_like(variables, got["model_state_dict"])
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, state),
                       torch_import.to_flax_variables(ours.model))
    opt = jax_ckpt.restore_like(tx.init(trainable),
                                got["optimizer_state_dict"])
    assert_trees_equal([np.asarray(x) for x in jax.tree_util.tree_leaves(
        opt)], grouped_adamw_leaves(ours.optimizer, ours.model, 2))
    assert sorted(opt.inner_states) == (["body", "prompt"] if prompting
                                        else ["body"])
    assert all(int(g.inner_state[0].count) == 2
               for g in opt.inner_states.values())
    # The JAX trainer resumes the port's file: it restores the epoch
    # (1, past max_epochs_multi_view 0: nothing trains) and the model.
    jres = JaxMultiView(Namespace(**conf, load_ckpt_backbone=True,
                                  load_ckpt_backbone_path=str(path),
                                  summary_dir=str(tmp_path)),
                        JaxSwinUnetR, _Null(), _Null(), _Null(), _Null())
    jres.self_supervised_learning()
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jres.final_state),
                       torch_import.to_flax_variables(ours.model))

    # The JAX trainer writes (its state after one update); the port
    # resumes it bit for bit.
    jvars = torch_import.to_flax_variables(_phase1_trainer(conf).model)
    jtrain, _ = jax_partition.split_params(
        jvars["params"], jax_partition.trainable_labels(jtr.model_conf))
    grads = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25), jtrain)
    _, jstate = jax.jit(tx.update)(grads, tx.init(jtrain), jtrain)
    jpath = jax_ckpt.save_checkpoint(tmp_path / "jax", 11, jvars, jstate,
                                     {"step": 1})
    resumed = _phase1_trainer(conf, load_ckpt_backbone=True,
                              load_ckpt_backbone_path=str(jpath))
    assert resumed.prepare_fit() == 11 and resumed.step_count == 1
    assert_trees_equal(torch_import.to_flax_variables(resumed.model), jvars)
    assert_trees_equal(
        grouped_adamw_leaves(resumed.optimizer, resumed.model, 1),
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)])


@pytest.mark.parametrize("src", ["jax", "port"])
def test_phase1_checkpoint_enters_both_phase2_trainers(tmp_path, src):
    """The pipeline hand-off: a phase-1 file merges into a phase-2
    student by the backbone-only branch of each package (the JAX one's
    ``merge_state`` and partition round trip, on the same template), and
    the port's teacher copies its student."""
    p1 = tiny_conf(training_mode=PHASE1, seed=0)
    if src == "port":
        _, path = _port_phase1_file(tmp_path, p1)
    else:
        _, _, jvars = jax_model(p1, seed=4)
        path = jax_ckpt.save_checkpoint(tmp_path / "jax", 1, jvars, None,
                                        {"step": 0})
    saved = jax_ckpt.load_checkpoint(path)["model_state_dict"]
    conf = tiny_conf(training_mode="self_supervised_learning_all", seed=0)
    fresh = _phase2_trainer(conf)
    tr = _phase2_trainer(conf, load_ckpt_backbone=True,
                         load_ckpt_backbone_path=str(path))
    assert tr.prepare_fit() == 0 and tr.step_count == 0
    template = torch_import.to_flax_variables(fresh.model)
    labels = jax_partition.trainable_labels(
        JaxModelConfig.from_namespace(Namespace(**conf)))
    merged = jax_ckpt.merge_state(template, saved)
    trainable, frozen = jax_partition.split_params(merged["params"], labels)
    jax_student = {"params": jax_partition.merge_params(trainable, frozen),
                   "batch_stats": merged["batch_stats"]}
    student = torch_import.to_flax_variables(tr.model)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jax_student),
                       student)
    flat_saved = {"/".join(k): v for k, v in
                  traverse_util.flatten_dict(saved["params"]).items()}
    flat_student = {"/".join(k): v for k, v in
                    traverse_util.flatten_dict(student["params"]).items()}
    taken = [k for k in flat_student if k in flat_saved]
    assert any(k.startswith("encoder_blocks_1") for k in taken)
    assert any(k.startswith("prompt_tokens_enc") for k in taken)
    assert not any(k.startswith(("head_", "decoder", "bottleneck"))
                   for k in taken)
    for k in taken:
        assert np.array_equal(flat_student[k], flat_saved[k]), k
    assert any(k.startswith("head_reconstruction") for k in flat_saved)
    sd = tr.model.state_dict()
    for k, v in tr.teacher.state_dict().items():
        assert torch.equal(v, sd[k]), k
