#!/bin/bash
# Batch segmentation serving with the PyTorch port on the CUDA card:
# NIfTI volumes in, label volumes out.  Worker processes decode and
# encode the volumes while the card runs the current one; the checkpoint
# is a reference-schema .pt (utils/torch_export.py writes one from a
# msgpack checkpoint) or a trainer's msgpack checkpoint.
# DEVICE (default cuda) is the torch device.

PY=python3
ckpt="SET_PROMPT_CKPT_DIR/0300.ckpt"   # full-state prompt-token ckpt
scans_dir="/path/to/scans"             # .nii / .nii.gz files
output_dir="/path/to/segmentations"
device=${DEVICE:-cuda}

# One card.
$PY -m medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
  --configs example_configs.yml \
  --ckpt "$ckpt" \
  --use-encoder-prompting --use-decoder-prompting \
  --input "$scans_dir" --output "$output_dir" \
  --device $device

# Production watch mode: poll the scans directory and segment new
# volumes as they arrive — the model, the runner and the IO workers stay
# warm across polls; restarts are idempotent (existing *_seg outputs are
# skipped) and half-written uploads are left alone.
$PY -m medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
  --configs example_configs.yml \
  --ckpt "$ckpt" \
  --use-encoder-prompting --use-decoder-prompting \
  --input "$scans_dir" --output "$output_dir" \
  --watch --watch-interval 5 \
  --device $device

# Data-parallel serving is not in the port yet (ROADMAP queue A item 10).
