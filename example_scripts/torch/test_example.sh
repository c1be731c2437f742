#!/bin/bash
# Test-only sweep over the 9 prompting combinations against existing
# prompt-token checkpoints; metric lines are scraped from log.txt.
# (The PyTorch port's CLI on the CUDA card; workflow parity with the
# reference example_scripts/test_example.sh.)

# Every knob is env-overridable so CI can execute ONE sweep cell at a
# tiny config (tests/test_torch_example_scripts.py, DEVICE=cpu) —
# defaults are the documented manual workflow.
PY=${PY:-python3}
device=${DEVICE:-cuda}                        # torch device of every run
logs_base_dir=${LOGS_BASE_DIR:-"the/dir/for/log"}
result_file=${RESULT_FILE:-"/set/a/file/path/to/save/the/result"}

use_ep_flag_list=(
  "" "--use-encoder-prompting" "" "--use-encoder-prompting"
  "" "--use-encoder-prompting" "--use-encoder-prompting"
  "--use-encoder-prompting" "--use-encoder-prompting"
)
use_dp_flag_list=(
  "" "" "--use-decoder-prompting" "--use-decoder-prompting"
  "--use-decoder-prompting" "--use-decoder-prompting" ""
  "--use-decoder-prompting" "--use-decoder-prompting"
)
configs=${CONFIGS:-example_configs.yml}
run_name=${RUN_NAME:-test_sweep}
ckpt=${CKPT:-0300.ckpt}

test_list=(
  "test_ssl_dec_no_ep_no_dp"
  "test_ssl_dec_no_ep_no_dp_test_ep"
  "test_ssl_dec_no_ep_no_dp_test_dp"
  "test_ssl_dec_no_ep_no_dp_test_ap"
  "test_ssl_dec_no_ep_use_dp"
  "test_ssl_dec_no_ep_use_dp_test_ep"
  "test_ssl_dec_use_ep_no_dp"
  "test_ssl_dec_use_ep_no_dp_test_dp"
  "test_ssl_dec_use_ep_use_dp"
)
ckpt_list=(
  "SET_PROMPT_CKPT_DIR_1/$ckpt"
  "SET_PROMPT_CKPT_DIR_2/$ckpt"
  "SET_PROMPT_CKPT_DIR_3/$ckpt"
  "SET_PROMPT_CKPT_DIR_4/$ckpt"
  "SET_PROMPT_CKPT_DIR_5/$ckpt"
  "SET_PROMPT_CKPT_DIR_6/$ckpt"
  "SET_PROMPT_CKPT_DIR_7/$ckpt"
  "SET_PROMPT_CKPT_DIR_8/$ckpt"
  "SET_PROMPT_CKPT_DIR_9/$ckpt"
)
# PROMPT_CKPT overrides every ckpt_list entry (single-cell CI runs).
if [ -n "${PROMPT_CKPT:-}" ]; then
  for ((i=0; i<${#ckpt_list[@]}; i++)); do ckpt_list[i]="$PROMPT_CKPT"; done
fi
CELL_START=${CELL_START:-0}
CELL_END=${CELL_END:-$((${#test_list[@]}-1))}

for ((i=CELL_START; i<=CELL_END; i++)); do
  $PY -m medical_image_segmentation_with_visual_prompts_tpu_torch.main \
  --mode test \
  --device $device \
  --training-mode downstream \
  --configs $configs \
  --load-ckpt-prompt-tokens \
  --load-ckpt-prompt-tokens-path ${ckpt_list[i]} \
  ${use_ep_flag_list[i]} \
  ${use_dp_flag_list[i]} \
  --run-name "${test_list[i]}_$run_name"
  log_file="$(ls -t "$logs_base_dir" | head -1)/log.txt"
  cat $logs_base_dir/$log_file >> $result_file
done
