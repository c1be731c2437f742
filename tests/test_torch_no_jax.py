"""PyTorch port: imports neither JAX, flax, msgpack, optax, PIL nor the
JAX package (also while it builds and runs its native data library,
counts FLOPs and runs its TensorBoard converter command), and its chip
check refuses to run on a machine without a CUDA card."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "medical_image_segmentation_with_visual_prompts_tpu_torch"
JAX_PKG = "medical_image_segmentation_with_visual_prompts_tpu"


def test_every_port_module_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None      # any `import jax` now raises
        sys.modules["flax"] = None
        sys.modules["{JAX_PKG}"] = None
        sys.modules["msgpack"] = None
        sys.modules["optax"] = None
        sys.modules["PIL"] = None
        import {PKG} as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        for mod in ("infer", "ops.kernels", "ops.prng", "ops.fused_block",
                    "ops.fused_block_bwd", "ops.fused_pair",
                    "ops.window_attention",
                    "ops.conv_fused", "models.window_attention",
                    "ops.augment", "ops.similarity", "losses.dice",
                    "losses.contrastive_pair", "train.multi_view",
                    "losses.clustered_prototype", "train.students_teacher",
                    "utils.metrics", "utils.schedules", "utils.device",
                    "models.partition", "data.datasets", "train.common",
                    "train.segmentation", "main", "utils.checkpoint",
                    "utils.torch_import", "utils.loggers", "utils.tb_events",
                    "utils.initialization", "utils.summary",
                    "utils.visualization", "utils.torch_export",
                    "parallel.mesh", "parallel.distributed",
                    "parallel.train_parallel", "data.native",
                    "utils.flops"):
            assert "{PKG}." + mod in names, mod
        import pathlib, tempfile
        import numpy as np
        from {PKG}.utils import checkpoint
        path = checkpoint.save_checkpoint(
            pathlib.Path(tempfile.mkdtemp()) / "a.ckpt", 1,
            {{"params": {{"w": np.ones(2, np.float32)}}}},
            [np.asarray(0, np.int32)], {{"epoch": 1}})
        assert checkpoint.load_checkpoint(path)["current_epoch"] == 1
        import gzip, runpy
        from {PKG}.config import flagship_conf
        from {PKG}.data import native
        from {PKG}.utils.flops import model_flops
        assert native.gunzip(gzip.compress(b"abc" * 9)).tobytes() == \
            b"abc" * 9
        assert model_flops(flagship_conf(), roi=(128, 128, 8)) > 0
        summary = pathlib.Path(tempfile.mkdtemp())
        (summary / "scalars.jsonl").write_text(
            '{{"tag": "a", "value": 1.0, "step": 0}}\\n')
        sys.argv = ["tb_events", str(summary)]
        runpy.run_module("{PKG}.utils.tb_events", run_name="__main__")
        assert len(list(summary.glob("events.out.tfevents.*"))) == 1
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                      "optax", "PIL")
               and sys.modules[m] is not None]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports lazily inside its phases: every module it
    names is the port, torch, numpy or the standard library."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.add(node.module)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    roots = {n.split(".")[0] for n in names}
    assert PKG in roots
    assert roots <= {PKG, "torch", "numpy", "__future__", "argparse",
                     "dataclasses", "json", "os", "socket", "struct",
                     "subprocess", "sys", "tempfile", "time", "pathlib",
                     "zlib"}, roots


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No CUDA here: non-zero exit and no result line, in the repository
    and in a directory holding chip_smoke.py alone."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
