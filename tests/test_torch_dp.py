"""PyTorch port: data parallel (``mesh_data``, ``distributed``) against the
JAX package's ``mesh_data: 2``, on the CPU.

The pytest process never starts a process group (it would leak into the
other tests of its worker): two subprocesses run ``tests/
torch_dp_worker.py`` as the ranks of one gloo group on a free localhost
port, started by the first ``main.main`` call from the config's
``distributed`` keys, and each writes its results as JSON.  The JAX
references run here at ``mesh_data: 2`` on the 8-device CPU platform of
``tests/conftest.py``, with ``configurations/tiny_cpu.yml`` and the
synthetic volumes and helpers of ``tests/test_dp_trainers.py``.  Both
packages start from the same weights: a checkpoint of the port's seeded
initialization, which each trainer loads (downstream and phase 2: the
backbone merge; phase 1: the full resume at epoch 0).

* Staging (one process): ``DeviceCtx.round_batch`` and ``stage`` give
  the JAX ``DeviceCtx.stage``'s padded batch and ``_valid``; each rank's
  rows are its slice.
* Dropout counters (one process): ``attn_keep``/``proj_keep`` at
  ``win_base = k`` are rows ``[k:]`` of the base-0 masks and the JAX
  ``keep_mask`` at the global index; the plain block and pair with
  dropout on windows ``[k:]`` equal rows ``[k:]`` of the whole call
  (exactly: every window's arithmetic is its own).
* Two ranks, downstream ``main.main`` fits: the per-epoch train and
  validation losses equal the JAX ``mesh_data: 2`` fit's to 2e-4
  relative (the JAX DP test's tolerance) and the final prompt tokens to
  1e-4, for a full global batch (4) and a partial one (3, padded to 4);
  with attention and projection dropout 0.1, every step's loss and the
  final prompt tokens equal the port's one-process fit of the same global
  batches to 1e-5 (the counter-hash masks at the global window index;
  float reassociation of the moments and loss sums only).  Only rank 0
  writes its log and summaries.
* Two ranks, ``test()``: both protocols give the JAX ``mesh_data: 2``
  per-volume IoU and Dice to 1e-3 (argmax ties at reassociation noise,
  as ``tests/test_torch_cli.py`` allows).
* Two ranks, pretraining: the phase-2 ``self_supervised_learning_decoder``
  fit (``reduction_factor: 1``, so that both packages' jitters are 0) and
  the phase-1 fit (the views drawn from the JAX step's keys for the global
  batch) give the JAX ``mesh_data: 2`` per-epoch losses to 2e-4.
* Two ranks, units: the global BatchNorm's output, input, weight and bias
  gradients and running statistics against the one-process BatchNorm of
  the concatenated batch (1e-5 of the gradient scale); NT-Xent of the
  gathered codes against the one-process loss and its gradient (1e-12,
  fp64); ``replicate`` and ``shard_batch``; ``stage_global_batch`` and
  ``masked_mean`` (the JAX multi-process test's mean over the real rows,
  1e-6); the library train
  step (dropout 0.1) against its one-process version (losses 1e-6,
  parameters 1e-6), the serving step's gathered logits, and
  ``infer.make_runner`` at ``mesh_data: 2`` (the chunk split over the
  ranks, the logits gathered) against the one-process runner: the same
  labels, probabilities to 1e-6 (the windows' batches differ, so their
  BLAS sums may too).
* ``mesh_data`` other than the world size raises, naming both, before
  anything is read or written.
"""

import json
import os
import socket
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu import main as jax_cli
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    prng as jax_prng
from medical_image_segmentation_with_visual_prompts_tpu.train.common import \
    DeviceCtx as JaxDeviceCtx
from medical_image_segmentation_with_visual_prompts_tpu_torch import (
    config, main)
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    ConsecutiveSwinBlocks, SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.fused_pair \
    import pair_reference
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    MultiViewTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import DeviceCtx, grouped_adamw_leaves
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .checkpoint import save_checkpoint
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .torch_import import to_flax_variables
from test_dp_trainers import TINY_YML, _conf, _losses, dataset  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
SEED = 11
LOSS_RTOL = 2e-4
TOKEN_ATOL = 1e-4
DROPOUT_TOL = 1e-5
METRIC_ATOL = 1e-3
FLAGS = ("load_ckpt_backbone", "save_ckpt_backbone",
         "load_ckpt_prompt_tokens", "save_ckpt_prompt_tokens")

# name -> (training mode, config overrides); each runs in both packages
# at mesh_data: 2 but "dropout", which the port runs on two ranks and on
# one process.
DOWNSTREAM = dict(max_epochs_downstream=0, seed=SEED)
RUNS = {
    "full": ("downstream", dict(DOWNSTREAM, batch_size_downstream=4,
                                num_samples_downstream=4)),
    "partial": ("downstream", dict(DOWNSTREAM, batch_size_downstream=3,
                                   num_samples_downstream=3)),
    "dropout": ("downstream", dict(DOWNSTREAM, batch_size_downstream=4,
                                   num_samples_downstream=4, attn_drop=0.1,
                                   proj_drop=0.1, max_epochs_downstream=1)),
    "phase2": ("self_supervised_learning_decoder",
               dict(batch_size_students_teacher=2,
                    num_samples_students_teacher=2,
                    max_epochs_students_teacher=0, reduction_factor=1,
                    seed=SEED)),
    "phase1": ("self_supervised_learning_encoder",
               dict(batch_size_multi_view=2, num_samples_multi_view=2,
                    max_epochs_multi_view=0, seed=SEED)),
}
TESTS = ("none", "gaussian")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _args(mode: str, training_mode: str) -> dict:
    args = {f: False for f in FLAGS}
    args.update({f + "_path": "" for f in FLAGS})
    args.update(mode=mode, training_mode=training_mode, configs=str(TINY_YML),
                use_encoder_prompting=True, use_decoder_prompting=True,
                backbone="swin_unetr", run_name="dp")
    return args


def _data(root: Path) -> dict:
    img, msk = str(root / "img"), str(root / "msk")
    return dict(image_dir_pretrain=img, image_dir_supervised=img,
                mask_dir_supervised=msk, image_dir_downstream=img,
                mask_dir_downstream=msk, image_dir_test=img,
                mask_dir_test=msk)


def _port_hparams(training_mode: str, **over) -> Namespace:
    hp = config.get_full_configs(Namespace(**_args("fit", training_mode)))
    hp.training_mode = training_mode
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


def _init_checkpoint(path: Path, training_mode: str, root: Path) -> str:
    """The port's seeded initial model (phase 1: with its optimizer state
    at step 0, the trainer's full resume) as a msgpack checkpoint."""
    hp = _port_hparams(training_mode, seed=SEED, **_data(root))
    if training_mode == "self_supervised_learning_encoder":
        tr = MultiViewTrainer(hp, SwinUnetR, None, None, device="cpu")
        tr.prepare_fit()
        return str(save_checkpoint(
            path, 0, to_flax_variables(tr.model),
            grouped_adamw_leaves(tr.optimizer, tr.model, 0), {"step": 0}))
    model = SwinUnetR(config.ModelConfig.from_mapping(hp), dropout_seed=SEED)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return str(save_checkpoint(path, 0, to_flax_variables(model)))


def _scalars(summary_dir: Path, tag: str) -> list:
    path = summary_dir / "scalars.jsonl"
    return [json.loads(line)["value"] for line in
            path.read_text().splitlines() if json.loads(line)["tag"] == tag]


def _start_ranks(root: Path, runs: list, units: bool):
    """Start the two ranks on ``runs`` (and the unit checks); returns a
    function that waits for them and returns their results."""
    out = root / "out"
    out.mkdir()
    spec = root / "spec.json"
    spec.write_text(json.dumps({
        "root": str(ROOT), "address": f"localhost:{_free_port()}",
        "out": str(out), "runs": runs, "seed": 3, "units": units}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(MIVP_TENSORBOARD="0", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec),
                               str(r)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]

    def wait() -> list:
        ranks = []
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
            ranks.append(json.loads((out / f"rank{r}.json").read_text()))
        return ranks

    return wait


def _fit_run(name: str, dataset: Path, root: Path, init: str) -> dict:
    mode, over = RUNS[name]
    return {"name": name, "mode": "fit", "args": _args("fit", mode),
            "set": dict(over, training_mode=mode, mesh_data=2,
                        **_data(dataset), load_ckpt_backbone=True,
                        load_ckpt_backbone_path=init,
                        log_dir=str(root / name / "log"),
                        summary_dir=str(root / name / "summary"))}


def _jax_fit(name: str, dataset: Path, root: Path, init: str,
             mp: pytest.MonkeyPatch, tags) -> dict:
    """The JAX trainer's fit at mesh_data: 2: per-epoch losses of
    ``tags`` and, downstream, the final prompt tokens."""
    mode, over = RUNS[name]
    conf = _conf(dataset, root / "jax", mp, mode, f"j{name}", mesh_data=2,
                 load_ckpt_backbone=True, load_ckpt_backbone_path=init,
                 **over)
    tr = jax_cli.setup_fitting(conf)
    tr.train()
    out = {f"{split}/{t}": _losses(conf, f"{split}/{t}")
           for split in ("train_loss", "val_loss") for t in tags}
    if mode == "downstream":
        out["tokens"] = {k: np.asarray(v)
                         for k, v in tr.final_state["params"].items()
                         if k.startswith("prompt_tokens")}
    return out


@pytest.fixture(scope="module")
def dp(dataset, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("dp_torch")
    init = _init_checkpoint(root / "init.ckpt", "downstream", dataset)
    runs = [_fit_run(name, dataset, root, init)
            for name in ("full", "partial", "dropout")]
    for blend in TESTS:
        runs.append({
            "name": f"test_{blend}", "mode": "test",
            "args": _args("test", "downstream"),
            "set": dict(mesh_data=2, seed=SEED, test_blending=blend,
                        load_ckpt_prompt_tokens=True,
                        load_ckpt_prompt_tokens_path=init,
                        **_data(dataset),
                        log_dir=str(root / f"test_{blend}" / "log"),
                        summary_dir=str(root / f"test_{blend}" / "summary"))})
    wait = _start_ranks(root, runs, units=True)

    # Meanwhile: the JAX references at mesh_data: 2, and the port's
    # one-process dropout fit.
    mp = pytest.MonkeyPatch()
    jax_out = {name: _jax_fit(name, dataset, root, init, mp, ("seg",))
               for name in ("full", "partial")}
    for blend in TESTS:
        conf = _conf(dataset, root / "jax", mp, "downstream", f"jt{blend}",
                     mesh_data=2, seed=SEED, test_blending=blend,
                     load_ckpt_prompt_tokens=True,
                     load_ckpt_prompt_tokens_path=init)
        conf.mode = "test"
        jax_out[f"test_{blend}"] = jax_cli.setup_testing(conf).test()
    mp.undo()
    mode, over = RUNS["dropout"]
    hp = _port_hparams(mode, **over, **_data(dataset),
                       load_ckpt_backbone=True, load_ckpt_backbone_path=init,
                       log_dir=str(root / "single" / "log"),
                       summary_dir=str(root / "single" / "summary"))
    os.environ["MIVP_TENSORBOARD"] = "0"
    try:
        single = main.main("fit", hp, "cpu")
    finally:
        os.environ.pop("MIVP_TENSORBOARD")
    return {"root": root, "ranks": wait(), "jax": jax_out, "single": single}


# ------------------------------------------------------- one process

def test_round_batch_and_stage_match_jax():
    """The padded global batch and ``_valid`` of the JAX mesh_data: 2
    stage; each rank's rows are its half (world of one here: the rows of
    a two-rank group are taken by slicing as ``DataGroup.rows`` does)."""
    jctx = JaxDeviceCtx(Namespace(mesh_data=2))
    ctx = DeviceCtx(Namespace(mesh_data=-1), torch.device("cpu"))
    assert ctx.n_devices == 1 and ctx.round_batch(3) == 3
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import DataGroup
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(3, 4, 4, 2, 1)).astype(np.float32),
             "mask": rng.integers(0, 3, (3, 4, 4, 2, 1)).astype(np.float32),
             "name": ["a", "b", "c"]}
    want = jctx.stage(batch)
    assert jctx.round_batch(3) == 4
    for rank in range(2):
        ctx.group = DataGroup(2, rank, group=object())   # rows only
        got = ctx.stage(batch)
        assert ctx.round_batch(3) == 4 and got["name"] == batch["name"]
        rows = slice(2 * rank, 2 * rank + 2)
        for key in ("image", "mask", "_valid"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key])[rows], key)
    ctx.group = None
    one = ctx.stage(batch)
    assert "_valid" not in one and one["image"].shape[0] == 3


@pytest.mark.parametrize("base", [0, 5, 2 ** 32 - 3])
def test_keep_masks_at_a_window_base(base):
    """attn_keep/proj_keep at win_base = k are rows [k:] of the masks from
    0 and the JAX keep_mask at the global (uint32-wrapped) index."""
    h, m, n, c, cols, bp = 2, 8, 11, 8, 16, 4
    drop = fb.Dropout((123, 456), 0.3, 0.2)
    at = drop.at(base)
    whole = fb.attn_keep(drop, bp + base, h, m, n, cols, "cpu") \
        if base < 64 else None
    a = fb.attn_keep(at, bp, h, m, n, cols, "cpu")
    p = fb.proj_keep(at, bp, m, c, "cpu")
    if whole is not None:
        torch.testing.assert_close(a, whole[base:], rtol=0, atol=0)
        torch.testing.assert_close(
            p, fb.proj_keep(drop, bp + base, m, c, "cpu")[base:], rtol=0,
            atol=0)
    w = (np.arange(bp, dtype=np.int64)[:, None, None, None] + base)
    hh = np.arange(h)[None, :, None, None]
    rr = np.arange(m)[None, None, :, None]
    jj = fb.key_columns(n, m, cols, "cpu").numpy()[None, None, None, :]
    idx = ((((w * h + hh) * m + rr) * cols + jj) % 2 ** 32).astype(np.uint32)
    # The JAX mask divides by (1 - rate), the port multiplies by the fp32
    # reciprocal (the kernels' scale): the same drops, values within an ulp.
    ja = np.asarray(jax_prng.keep_mask(np.uint32(123), idx, 0.3))
    np.testing.assert_array_equal(a.numpy() > 0, ja > 0)
    np.testing.assert_allclose(a.numpy(), ja, rtol=1e-6)
    pidx = (((w[:, :, 0] * m + np.arange(m)[None, :, None]) * c
             + np.arange(c)[None, None, :]) % 2 ** 32).astype(np.uint32)
    jp = np.asarray(jax_prng.keep_mask(np.uint32(456), pidx, 0.2))
    np.testing.assert_array_equal(p.numpy() > 0, jp > 0)
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-6)


@torch.no_grad()
def test_plain_block_and_pair_on_a_slice_of_windows():
    """The plain block and pair with dropout on windows [k:] at base k
    (rows k*P of a batch) equal rows [k:] of the whole call."""
    torch.manual_seed(0)
    pair = ConsecutiveSwinBlocks(8, 2, 8, 1, 3, (4, 4, 4), down=False,
                                 pad_mode="aligned", attn_drop=0.1,
                                 proj_drop=0.1)
    init_weights(pair, torch.Generator().manual_seed(0))
    pair.pair_kernel = True
    x = torch.randn(2, 16, 16, 4, 8)
    tokens = (torch.randn(3, 8), torch.randn(3, 8))
    x_win, ops0, ops1, labels, plan, _ = pair.pair_windows(x, tokens)
    b, pw = x_win.shape[:2]
    assert b == 2 and labels is not None
    d0, d1 = fb.Dropout((7, 8), 0.1, 0.1), fb.Dropout((9, 10), 0.1, 0.1)
    whole = fb.block_reference(x_win, ops1, labels, d1)
    part = fb.block_reference(x_win[1:], ops1, labels, d1.at(pw))
    torch.testing.assert_close(part, whole[1:], rtol=0, atol=0)
    assert not torch.equal(
        fb.block_reference(x_win[1:], ops1, labels, d1), whole[1:])
    whole = pair_reference(x_win, ops0, ops1, labels, plan, d0, d1)
    part = pair_reference(x_win[1:], ops0, ops1, labels, plan, d0.at(pw),
                          d1.at(pw))
    torch.testing.assert_close(part, whole[1:], rtol=0, atol=0)


def test_mesh_data_other_than_the_world_raises_first(dataset, tmp_path):  # noqa: F811,E501
    hp = _port_hparams("downstream", mesh_data=2, **_data(dataset),
                       log_dir=str(tmp_path / "log"),
                       summary_dir=str(tmp_path / "summary"))
    with pytest.raises(ValueError, match=r"mesh_data: 2.*world has 1"):
        main.main("fit", hp, "cpu")
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------ two ranks

def _tokens(tokens: dict) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in tokens.items()}


@pytest.mark.parametrize("name", ["full", "partial"])
def test_downstream_fit_matches_jax_mesh_data_2(dp, name):
    r0, r1 = (r[name] for r in dp["ranks"])
    assert r0["losses"] == r1["losses"] and r0["tokens"] == r1["tokens"]
    summary = dp["root"] / name / "summary"
    assert not (summary / "rank1").exists()
    assert not (dp["root"] / name / "log" / "rank1").exists()
    for tag in ("train_loss/seg", "val_loss/seg"):
        got, want = _scalars(summary / "rank0", tag), dp["jax"][name][tag]
        assert len(got) == len(want) >= 1, tag
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=tag)
    got, want = _tokens(r0["tokens"]), dp["jax"][name]["tokens"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOKEN_ATOL,
                                   err_msg=k)


def test_dropout_fit_matches_one_process(dp):
    """Dropout 0.1/0.1: the two ranks' steps are the one-process steps of
    the same global batches, masks included."""
    r0 = dp["ranks"][0]["dropout"]
    single = dp["single"]
    assert len(r0["losses"]) == len(single.losses) >= 4
    np.testing.assert_allclose(r0["losses"], single.losses, rtol=DROPOUT_TOL)
    got = _tokens(r0["tokens"])
    want = {k: np.asarray(v) for k, v in
            to_flax_variables(single.model)["params"].items()
            if k.startswith("prompt_tokens")}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=DROPOUT_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("blend", TESTS)
def test_test_protocols_match_jax_mesh_data_2(dp, blend):
    r0, r1 = (r[f"test_{blend}"]["metrics"] for r in dp["ranks"])
    assert r0 == r1
    want = dp["jax"][f"test_{blend}"]
    for key in ("iou", "dcc"):
        assert len(r0[key]) == len(want[key]) == 3
        np.testing.assert_allclose(r0[key], want[key], atol=METRIC_ATOL,
                                   err_msg=key)


def test_units_on_two_ranks(dp):
    for rank, res in enumerate(dp["ranks"]):
        assert res["backend"] == "gloo" and res["world"] == 2
        u = res["units"]
        bn = u["bn"]
        for key in ("y", "running_mean", "running_var"):
            assert bn[key] < 1e-5, (rank, key, bn[key])
        for key in ("dx", "dweight", "dbias"):
            assert bn[key] < 1e-5 * max(1.0, bn["scale"]), (rank, key, bn)
        nt = u["ntxent"]
        assert nt["loss"] < 1e-12 and nt["dx_i"] < 1e-12 \
            and nt["dx_j"] < 1e-12, nt
        assert u["replicate"] == {"tensor": [1.0, 1.0, 1.0], "weight": 1.0,
                                  "rows": [2 * rank, 2 * rank + 1]}
        st = u["stage"]
        assert st["rows"] == 3
        assert st["valid"] == [1.0, 1.0, 1.0 if rank == 0 else 0.0]
        assert abs(st["mean"] - 1.4) < 1e-6
        ts = u["train_step"]
        for one, two in ts["losses"]:
            assert abs(one - two) < 1e-6 * abs(one), ts["losses"]
        assert ts["params"] < 1e-6 and ts["moved"] > 1e-4, ts
        assert u["serve"]["shape"] == [4, 16, 16, 8, 2]
        assert u["serve"]["err"] == 0.0
        run = u["runner"]
        assert run["grouped"] == [False, True] and run["chunks"] == [27, 28]
        assert run["labels_equal"] and run["probs_err"] < 1e-6, run


def test_worker_imports_no_jax():
    code = (f"import runpy, sys; sys.modules['jax'] = None; "
            f"sys.modules['medical_image_segmentation_with_visual_prompts_tpu']"
            f" = None; sys.argv = ['w']; "
            f"runpy.run_path({str(WORKER)!r}, run_name='not_main'); "
            f"import {'medical_image_segmentation_with_visual_prompts_tpu_torch'}"
            f".parallel.train_parallel; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
    names = {n.split(".")[0] for n in _imports(WORKER)}
    assert names <= {"copy", "json", "sys", "argparse", "pathlib", "numpy",
                     "torch", "importlib"}, names


def _imports(path: Path) -> set:
    import ast
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            found.add(node.module)
        elif isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
    return found
