"""Model hyperparameters and config files of the PyTorch port.

Counterpart of ``models/swin_unetr.py::ModelConfig`` in the JAX package:
the same field names and defaults, so a YAML config or a JAX
``ModelConfig`` maps onto it field by field.  The TPU-only inference
switches of the JAX config (``fold_head_depth``, ``fold_head_hw``) and
``attn_impl`` are accepted and ignored: the port runs plain torch convs
and its own kernels.  The decoder layout (``unetr_res_block``,
``unetr_up_block``) and the UNETR blocks' ``basic_block_res`` /
``res_block`` switches are checked here; the JAX config takes any value
and builds a ``none``-like skip path from an unknown one.

:func:`load_conf` is the config lookup and merge of the JAX package's
``utils/configs.py::get_full_configs``: the YAML file is found as an
absolute path, then with ``~`` expanded (or from the working directory),
then under the repository's ``configurations/``, and its values win over
the command line's.  :func:`get_full_configs` is the rest of it, for the
training CLI (``main.py``): checkpoint paths, the run name and the log
directories.
"""

from __future__ import annotations

import dataclasses
import os
from argparse import Namespace
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import torch

_REPO_ROOT = Path(__file__).resolve().parent.parent
DEFAULT_CONFIG_DIR = _REPO_ROOT / "configurations"
# Write roots of the training CLI; MIVP_CKPT_DIR / MIVP_LOG_DIR move them.
DEFAULT_CKPT_DIR = Path(os.environ.get("MIVP_CKPT_DIR",
                                       _REPO_ROOT / "checkpoints"))
DEFAULT_ROOT_LOG_DIR = Path(os.environ.get("MIVP_LOG_DIR",
                                           _REPO_ROOT / "logs"))

TRAINING_MODES = (
    "self_supervised_learning_encoder",
    "self_supervised_learning_decoder",
    "self_supervised_learning_all",
    "supervised_learning_decoder",
    "supervised_learning_all",
    "downstream",
)
# The multi-view (phase-1) mode, the students-teacher (phase-2) modes,
# and those with a segmentation head.
PHASE1_MODE = TRAINING_MODES[0]
PHASE2_MODES = TRAINING_MODES[1:5]
SUPERVISED_MODES = ("supervised_learning_decoder", "supervised_learning_all")


def _from_mapping(cls, conf):
    """``cls`` (a config dataclass) from the keys of a dict or the
    attributes of a namespace that name its fields."""
    get = conf.get if isinstance(conf, dict) else \
        (lambda k, d=None: getattr(conf, k, d))
    missing = object()
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = get(f.name, missing)
        if v is not missing:
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    training_mode: str = "downstream"
    input_channels: int = 1
    depth_unet: int = 3
    hidden_channels: Tuple[int, ...] = (48, 96, 192, 384)
    input_patch_size: Tuple[int, ...] = (2, 2, 2)
    unetr_res_block: str = "none"      # none | simple | full
    unetr_up_block: str = "swin"       # swin | unetr
    basic_block_res: bool = True
    res_block: bool = False
    num_heads_encoder: int = 4
    num_heads_decoder: int = 4
    attn_window_size: Tuple[int, ...] = (8, 8, 4)
    pos_bias_embed_dim: int = 64
    use_checkpoint: bool = False
    attn_drop: float = 0.0
    proj_drop: float = 0.0
    max_prompts: int = 1
    tokens_per_prompt_encoder: int = 64
    tokens_per_prompt_decoder: int = 64
    use_encoder_prompting: bool = False
    use_decoder_prompting: bool = False
    use_reconstruction: bool = True
    use_mutual_learning: bool = False
    use_rotation_prediction: bool = True
    use_contrastive_learning: bool = True
    contrastive_coding_dim: int = 512
    output_channels_pretrain: int = 5
    output_channels_downstream: int = 2
    attn_impl: str = "auto"
    # "reference": pad every axis when any is misaligned (the reference's
    # quirk, needed for its checkpoints); "aligned": pad misaligned axes
    # only.  See ops/windows.py::compute_paddings.
    pad_mode: str = "reference"
    compute_dtype: str = "float32"     # float32 | bfloat16 trunk
    fold_head_depth: bool = True       # JAX/TPU-only; ignored here
    fold_head_hw: bool = False         # JAX/TPU-only; ignored here

    def __post_init__(self):
        for name in ("hidden_channels", "input_patch_size",
                     "attn_window_size"):
            object.__setattr__(self, name,
                               tuple(int(v) for v in getattr(self, name)))
        if self.training_mode not in TRAINING_MODES:
            raise ValueError(
                f"Training mode {self.training_mode} not available!")
        for name, allowed in (("unetr_res_block", ("none", "simple", "full")),
                              ("unetr_up_block", ("swin", "unetr"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        for name in ("basic_block_res", "res_block"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be true or false, got "
                                 f"{getattr(self, name)!r}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    @classmethod
    def from_mapping(cls, conf) -> "ModelConfig":
        """Build from a dict or an attribute namespace (YAML, argparse),
        keeping only the model's fields."""
        return _from_mapping(cls, conf)


MODEL_FAMILIES = ("swin_unetr", "medsam")


def model_family(conf) -> str:
    """The ``model_family`` of a config mapping or namespace: the
    promptable Swin-UNETR (``swin_unetr``, the default, so every config
    without the key keeps its meaning) or MedSAM (``medsam``)."""
    get = conf.get if isinstance(conf, dict) else \
        (lambda k, d=None: getattr(conf, k, d))
    family = get("model_family", None) or "swin_unetr"
    if family not in MODEL_FAMILIES:
        raise ValueError(f"model_family must be one of {MODEL_FAMILIES}, "
                         f"got {family!r}")
    return family


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """MedSAM's model (SAM ViT-B, ``segment_anything/build_sam.py``'s
    ``build_sam_vit_b``: the argument names are that function's) and its
    serving keys: the CT window in HU (``hu_window``), the encoder's
    batch of slices (``slice_batch``) and the encoder's and mask
    decoder's ``compute_dtype`` (the prompt encoder's Fourier features
    stay in float32).  Apart from :class:`ModelConfig`, which the
    Swin-UNETR path and its checkpoint maps read."""

    image_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    encoder_embed_dim: int = 768
    encoder_depth: int = 12
    encoder_num_heads: int = 12
    encoder_global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    attention_downsample_rate: int = 2
    hu_window: Tuple[float, ...] = (-160.0, 240.0)
    slice_batch: int = 16
    compute_dtype: str = "float32"     # float32 | bfloat16

    def __post_init__(self):
        object.__setattr__(self, "encoder_global_attn_indexes", tuple(
            int(v) for v in self.encoder_global_attn_indexes))
        object.__setattr__(self, "hu_window",
                           tuple(float(v) for v in self.hu_window))
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is not a "
                             f"multiple of patch_size {self.patch_size}")
        if self.slice_batch < 1:
            raise ValueError(f"slice_batch must be positive, got "
                             f"{self.slice_batch}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    @property
    def embedding_size(self) -> int:
        """Side of the image embedding's grid (64 at ViT-B's 1024 / 16)."""
        return self.image_size // self.patch_size

    @classmethod
    def from_mapping(cls, conf) -> "SamConfig":
        """Build from a dict or an attribute namespace, keeping only the
        fields above."""
        return _from_mapping(cls, conf)


def flagship_conf(**overrides) -> ModelConfig:
    """The serving flagship (the JAX package's ``__graft_entry__``
    ``_flagship_conf``): depth 3, hidden 48/96/192/384, window 8x8x4,
    patch 2x2x2, 64+64 prompt tokens, aligned padding, bf16 trunk."""
    base = dict(
        training_mode="downstream",
        input_channels=1,
        depth_unet=3,
        hidden_channels=(48, 96, 192, 384),
        input_patch_size=(2, 2, 2),
        unetr_res_block="none",
        unetr_up_block="swin",
        num_heads_encoder=4,
        num_heads_decoder=4,
        attn_window_size=(8, 8, 4),
        pos_bias_embed_dim=64,
        use_checkpoint=False,
        attn_drop=0.0,
        proj_drop=0.0,
        max_prompts=1,
        tokens_per_prompt_encoder=64,
        tokens_per_prompt_decoder=64,
        use_encoder_prompting=True,
        use_decoder_prompting=True,
        output_channels_downstream=2,
        pad_mode="aligned",
        compute_dtype="bfloat16",
    )
    base.update(overrides)
    return ModelConfig(**base)


def _existing(path_str, default_dir: Path, error: str) -> Path:
    """An existing absolute path, then the path with ``~`` expanded
    (relative paths from the working directory), then the path under
    ``default_dir``; else ``FileNotFoundError(error)``."""
    pth = Path(path_str)
    if pth.is_absolute() and pth.exists():
        return pth
    if pth.expanduser().exists():
        return pth.expanduser()
    if (default_dir / pth).exists():
        return default_dir / pth
    raise FileNotFoundError(error)


def config_path(configs) -> Path:
    """The YAML file ``configs`` names, looked up as the JAX CLI does
    (:func:`_existing` under :data:`DEFAULT_CONFIG_DIR`)."""
    return _existing(configs, DEFAULT_CONFIG_DIR,
                     "The configuration file does not exist!")


def load_conf(configs, /, **cli) -> dict:
    """The command line's values ``cli`` merged with the YAML file of
    :func:`config_path`; the YAML wins on duplicate keys (PyYAML is
    imported only here)."""
    import yaml
    with open(config_path(configs)) as f:
        more = yaml.safe_load(f) or {}
    return {**cli, **more}


def resolve_save(path_str: str, default_dir: Path) -> Path:
    """A save path (it need not exist): absolute, then ``~`` expanded, else
    under ``default_dir``."""
    pth = Path(path_str)
    if pth.is_absolute():
        return pth
    if "~" in str(pth):
        return pth.expanduser()
    return default_dir / pth


def get_full_configs(args: Namespace,
                     now: Optional[datetime] = None) -> Namespace:
    """The training CLI's config: ``args`` merged with the YAML file of
    ``args.configs`` (:func:`load_conf`, the YAML wins), load checkpoint
    paths resolved (they must exist), ``run_name =
    {mode}_{backbone}_{MMDDHHMMSS}_{run_name}``, save paths defaulting to
    ``<DEFAULT_CKPT_DIR>/<family>/<run_name>``, and ``log_dir`` /
    ``summary_dir`` under :data:`DEFAULT_ROOT_LOG_DIR`."""
    full = load_conf(args.configs, **vars(args))
    for family, key in (("backbone", "backbone"),
                        ("prompt_tokens", "prompt tokens")):
        if getattr(args, f"load_ckpt_{family}", False) is True:
            path = getattr(args, f"load_ckpt_{family}_path")
            if path == "":
                raise ValueError(f"The {key} checkpoint path is empty!")
            full[f"load_ckpt_{family}_path"] = _existing(
                path, DEFAULT_CKPT_DIR / family,
                f"The checkpoint path {path!r} does not exist!")
    timestamp = (now or datetime.now()).strftime("%m%d%H%M%S")
    run_name = (f"{full['mode']}_{full['backbone']}_{timestamp}_"
                f"{args.run_name}")
    full["run_name"] = run_name
    for family in ("backbone", "prompt_tokens"):
        if getattr(args, f"save_ckpt_{family}", False) is True:
            path = getattr(args, f"save_ckpt_{family}_path")
            full[f"save_ckpt_{family}_path"] = \
                resolve_save(path, DEFAULT_CKPT_DIR / family) if path != "" \
                else DEFAULT_CKPT_DIR / family / run_name
    full["log_dir"] = DEFAULT_ROOT_LOG_DIR / run_name
    full["summary_dir"] = full["log_dir"] / "summary"
    return Namespace(**full)
