#!/bin/bash
# Phase-2 student-teacher decoder distillation, loading the phase-1
# backbone, with both encoder and decoder prompting.
# $1 python command, $2 config file, $3 run name, $4 backbone ckpt path.
# DEVICE (default cuda) is the torch device.
# (The PyTorch port's CLI; workflow parity with reference
# example_scripts/phase2_example.sh.)

$1 -m medical_image_segmentation_with_visual_prompts_tpu_torch.main \
--device ${DEVICE:-cuda} \
--training-mode self_supervised_learning_decoder \
--configs $2 \
--load-ckpt-backbone \
--load-ckpt-backbone-path $4 \
--save-ckpt-backbone \
--use-encoder-prompting \
--use-decoder-prompting \
--backbone swin_unetr \
--run-name "ssl_dec_use_ep_use_dp_$3"
