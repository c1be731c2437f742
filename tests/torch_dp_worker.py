"""One rank of the PyTorch port's data-parallel CPU checks
(``tests/test_torch_dp.py``): a gloo process group of two processes on
the CPU, started by the first ``main.main`` call from the config's
``distributed`` keys.

Run as ``python torch_dp_worker.py SPEC RANK``.  ``SPEC`` (JSON) names
the repository root, the group's address, an output directory, the
``main.main`` runs (mode, command-line arguments, config overrides, and
for phase 1 the views' draws of every step) and the seed of the unit
checks.  The rank writes ``rank<RANK>.json`` to the output directory:
per run the per-step losses or the test metrics and the final prompt
tokens, and the unit checks' errors (global BatchNorm, NT-Xent over the
gathered codes, the multi-process staging, the library DP steps).

Imports torch, numpy and the port only: never JAX.
"""

import copy
import json
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

PKG = "medical_image_segmentation_with_visual_prompts_tpu_torch"


def _max_err(a, b) -> float:
    return float((torch.as_tensor(a).detach().double()
                  - torch.as_tensor(b).detach().double()).abs().max())


def _patch_draws(trainer_cls, draws):
    """Every ``draw_views`` call returns the next of ``draws`` (global
    batch draws made by the parent)."""
    from importlib import import_module
    ViewDraws = import_module(f"{PKG}.train.multi_view").ViewDraws
    todo = iter(draws)

    def draw_views(self, b):
        d = next(todo)
        assert len(d["rot_i"]) == b, (len(d["rot_i"]), b)
        return ViewDraws(*(torch.tensor(d[k]) for k in
                           ("rot_i", "rot_j", "rank_i", "rank_j")), 0)

    trainer_cls.draw_views = draw_views


def run_main(spec: dict, run: dict, rank: int) -> dict:
    from importlib import import_module
    config = import_module(f"{PKG}.config")
    cli = import_module(f"{PKG}.main")
    torch_import = import_module(f"{PKG}.utils.torch_import")
    hp = config.get_full_configs(Namespace(**run["args"]))
    for key, value in run["set"].items():
        setattr(hp, key, value)
    hp.log_dir = str(Path(run["set"]["log_dir"]) / f"rank{rank}")
    hp.summary_dir = str(Path(run["set"]["summary_dir"]) / f"rank{rank}")
    hp.distributed = True
    hp.coordinator_address = spec["address"]
    hp.num_processes, hp.process_id = 2, rank
    if run.get("draws"):
        _patch_draws(import_module(f"{PKG}.train").MultiViewTrainer,
                     run["draws"])
    tr = cli.main(run["mode"], hp, "cpu")
    if run["mode"] == "test":
        return {"metrics": tr.metric_vals}
    params = torch_import.to_flax_variables(tr.model)["params"]
    return {"losses": tr.losses,
            "val_losses": getattr(tr, "val_losses", None),
            "tokens": {k: np.asarray(v).tolist() for k, v in params.items()
                       if k.startswith("prompt_tokens")}}


def unit_checks(rank: int, seed: int) -> dict:
    """Errors of the data-parallel pieces against their one-process
    versions, on seeded inputs (every rank draws the same)."""
    from importlib import import_module
    mesh = import_module(f"{PKG}.parallel.mesh")
    dist_mod = import_module(f"{PKG}.parallel.distributed")
    tp = import_module(f"{PKG}.parallel.train_parallel")
    batch_norm = import_module(f"{PKG}.models.unet_blocks").batch_norm
    pair_loss = import_module(
        f"{PKG}.losses.contrastive_pair").contrastive_pair_loss
    group = mesh.make_mesh(-1)
    rows = group.rows(4)
    rng = np.random.default_rng(seed)
    out = {}

    # Global BatchNorm: outputs, input and affine gradients, running stats.
    x = torch.tensor(rng.normal(0.5, 2.0, (4, 3, 3, 2, 5)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)
    norm = torch.nn.BatchNorm3d(5, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        norm.weight.copy_(torch.tensor(rng.normal(1, 0.2, 5)))
        norm.bias.copy_(torch.tensor(rng.normal(0, 0.2, 5)))
    ref = copy.deepcopy(norm)
    xr = x.clone().requires_grad_(True)
    yr = batch_norm(xr, ref)
    (yr * w).sum().backward()
    norm.data_group = group
    xl = x[rows].clone().requires_grad_(True)
    y = batch_norm(xl, norm)
    (y * w[rows]).sum().backward()
    out["bn"] = {
        "y": _max_err(y, yr[rows]), "dx": _max_err(xl.grad, xr.grad[rows]),
        "dweight": _max_err(group.sum(norm.weight.grad), ref.weight.grad),
        "dbias": _max_err(group.sum(norm.bias.grad), ref.bias.grad),
        "running_mean": _max_err(norm.running_mean, ref.running_mean),
        "running_var": _max_err(norm.running_var, ref.running_var),
        "scale": float(xr.grad.abs().max())}

    # NT-Xent over the gathered codes: the ranks' losses add up to the
    # one-process loss, and each rank's code gradients are its rows'.
    ci = torch.tensor(rng.normal(size=(4, 16)), dtype=torch.float64)
    cj = torch.tensor(rng.normal(size=(4, 16)), dtype=torch.float64)
    ri, rj = ci.clone().requires_grad_(True), cj.clone().requires_grad_(True)
    lref = pair_loss(ri, rj)
    lref.backward()
    li = ci[rows].clone().requires_grad_(True)
    lj = cj[rows].clone().requires_grad_(True)
    share = pair_loss(li, lj, group=group)
    share.backward()
    out["ntxent"] = {"loss": _max_err(group.sum(share.detach()), lref),
                     "dx_i": _max_err(li.grad, ri.grad[rows]),
                     "dx_j": _max_err(lj.grad, rj.grad[rows]),
                     "value": float(lref)}

    # replicate (rank 0's values everywhere) and shard_batch (the rows).
    t = torch.full((3,), float(rank + 1))
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1)
    mesh.replicate(group, [t])
    mesh.replicate(group, lin)
    out["replicate"] = {"tensor": t.tolist(), "weight": float(lin.weight.mean()),
                        "rows": mesh.shard_batch(group, {
                            "x": np.arange(4), "name": ["a"]})["x"].tolist()}

    # Multi-process staging: rank 0 holds 3 rows of 1, rank 1 2 rows of 2;
    # the mean over the real rows is (3 + 4) / 5.
    local = np.full((3 - rank, 2, 2, 2, 1), rank + 1, np.float32)
    staged = dist_mod.stage_global_batch(group, {"image": local,
                                                 "name": ["x"]})
    out["stage"] = {"rows": int(staged["image"].shape[0]),
                    "valid": staged["_valid"].tolist(),
                    "mean": float(dist_mod.masked_mean(
                        group, staged["image"], staged["_valid"]))}

    # The library steps (JAX tests/test_parallel.py): the DP train step
    # equals the one-process step on the global batch; the serving step
    # gathers every rank's logits.
    config = import_module(f"{PKG}.config")
    models = import_module(f"{PKG}.models")
    common = import_module(f"{PKG}.train.common")
    partition = import_module(f"{PKG}.models.partition")
    init_weights = import_module(f"{PKG}.utils").init_weights
    conf = config.ModelConfig.from_mapping(dict(
        training_mode="downstream", input_channels=1, depth_unet=2,
        hidden_channels=(8, 16, 32), input_patch_size=(2, 2, 2),
        num_heads_encoder=2, num_heads_decoder=2, attn_window_size=(4, 4, 2),
        pos_bias_embed_dim=8, tokens_per_prompt_encoder=4,
        tokens_per_prompt_decoder=4, use_encoder_prompting=True,
        use_decoder_prompting=True, output_channels_downstream=2,
        attn_drop=0.1, proj_drop=0.1))

    def build():
        model = models.SwinUnetR(conf, dropout_seed=seed)
        init_weights(model, torch.Generator().manual_seed(seed))
        trainable = partition.set_trainable(
            model, partition.downstream_labels(conf))
        return model, common.adamw([p for _, p in trainable], 1e-3, 0.0)

    image = rng.normal(size=(4, 16, 16, 8, 1)).astype(np.float32)
    mask = rng.integers(0, 2, (4, 16, 16, 8, 1)).astype(np.float32)
    m1, o1 = build()
    one = tp.make_dp_train_step(m1, o1, mesh.DataGroup(), (0, 1))
    m2, o2 = build()
    dp = tp.make_dp_train_step(m2, o2, group, (0, 1))
    losses = [(float(one(image, mask)), float(dp(image, mask)))
              for _ in range(2)]
    trained = {n: p for n, p in m1.named_parameters() if p.requires_grad}
    out["train_step"] = {
        "losses": losses,
        "params": max(_max_err(p, trained[n])
                      for n, p in m2.named_parameters() if p.requires_grad),
        "moved": max(_max_err(p, q) for (n, p), (_, q) in zip(
            m1.named_parameters(), build()[0].named_parameters())
            if p.requires_grad)}
    serve = tp.make_dp_serving_step(m2, group)
    windows = torch.tensor(image)
    got = serve(windows)
    with torch.no_grad():
        m2.eval()
        want = m2(windows)
    out["serve"] = {"shape": list(got.shape), "err": _max_err(got, want)}

    # infer.make_runner with mesh_data: 2: each chunk split over the
    # ranks, the stitched volume the one-process runner's.
    infer = import_module(f"{PKG}.infer")
    vol = rng.normal(0.0, 400.0, (40, 36, 14, 1)).astype(np.float32)
    conf = {"roi_size": [16, 16, 8]}
    served = {}
    for mesh in (False, True):
        runner = infer.make_runner({**conf, "mesh_data": 2} if mesh else conf,
                                   m2, stride=0.5, coverage="pad")
        served[mesh] = (runner.group is not None, runner.resolve_chunk(27),
                        infer.predict_device(runner, conf["roi_size"], vol)[0],
                        torch.inference_mode()(runner)(vol))
    out["runner"] = {"grouped": [served[False][0], served[True][0]],
                     "chunks": [served[False][1], served[True][1]],
                     "labels_equal": bool(torch.equal(served[True][2],
                                                      served[False][2])),
                     "probs_err": _max_err(served[True][3], served[False][3])}
    return out


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    sys.path.insert(0, spec["root"])
    torch.set_num_threads(1)
    import torch.distributed as dist
    results = {run["name"]: run_main(spec, run, rank) for run in spec["runs"]}
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{spec['address']}",
                                world_size=2, rank=rank)
    if spec["units"]:
        results["units"] = unit_checks(rank, spec["seed"])
    results["backend"] = dist.get_backend()
    results["world"] = dist.get_world_size()
    dist.destroy_process_group()
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(results))


if __name__ == "__main__":
    main()
