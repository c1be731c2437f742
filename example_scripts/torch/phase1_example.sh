#!/bin/bash
# Phase-1 self-supervised encoder pretraining with encoder prompting.
# $1 is the python command, $2 is the config file name, $3 is the run name.
# DEVICE (default cuda) is the torch device.
# (The PyTorch port's CLI; workflow parity with reference
# example_scripts/phase1_example.sh.)

$1 -m medical_image_segmentation_with_visual_prompts_tpu_torch.main \
--device ${DEVICE:-cuda} \
--training-mode self_supervised_learning_encoder \
--configs $2 \
--save-ckpt-backbone \
--backbone swin_unetr \
--use-encoder-prompting \
--run-name "ssl_enc_use_ep_$3"
