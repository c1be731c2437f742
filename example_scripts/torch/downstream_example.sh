#!/bin/bash
# Downstream prompting-ablation sweep: train prompt tokens + head for each
# of the 9 encoder/decoder prompting combinations (incl. the test-time-only
# prompting variants), then run 5 repeated test evaluations per config and
# scrape the per-volume metric lines into a result file.
# (The PyTorch port's CLI on the CUDA card; workflow parity with the
# reference example_scripts/downstream_example.sh.)

# Every knob is env-overridable so CI can execute ONE sweep cell at a
# tiny config (tests/test_torch_example_scripts.py, DEVICE=cpu) —
# defaults are the documented manual workflow.
PY=${PY:-python3}
device=${DEVICE:-cuda}                        # torch device of every run
prompt_tokens_base_dir=${PROMPT_TOKENS_BASE_DIR:-"/set/your/path/here"}  # prompt-token ckpt dir from the configuration
logs_base_dir=${LOGS_BASE_DIR:-"/set/your/path/here"}                    # log dir from the configuration
result_file=${RESULT_FILE:-"/set/a/file/path/to/save/the/result"}

run_list=(
  "downstream_ssl_dec_no_ep_no_dp"
  "downstream_ssl_dec_no_ep_no_dp_test_ep"
  "downstream_ssl_dec_no_ep_no_dp_test_dp"
  "downstream_ssl_dec_no_ep_no_dp_test_ap"
  "downstream_ssl_dec_no_ep_use_dp"
  "downstream_ssl_dec_no_ep_use_dp_test_ep"
  "downstream_ssl_dec_use_ep_no_dp"
  "downstream_ssl_dec_use_ep_no_dp_test_dp"
  "downstream_ssl_dec_use_ep_use_dp"
)
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
# Phase-2 backbone checkpoints to adapt from (one per combination).
ckpt_list=(
  "SET_BACKBONE_CKPT_no_ep_no_dp"
  "SET_BACKBONE_CKPT_no_ep_no_dp"
  "SET_BACKBONE_CKPT_no_ep_no_dp"
  "SET_BACKBONE_CKPT_no_ep_no_dp"
  "SET_BACKBONE_CKPT_no_ep_use_dp"
  "SET_BACKBONE_CKPT_no_ep_use_dp"
  "SET_BACKBONE_CKPT_use_ep_no_dp"
  "SET_BACKBONE_CKPT_use_ep_no_dp"
  "SET_BACKBONE_CKPT_use_ep_use_dp"
)
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
run_name=${RUN_NAME:-downstream_sweep}
ckpt=${CKPT:-0300.ckpt}
# BACKBONE_CKPT overrides every ckpt_list entry (single-cell CI runs).
if [ -n "${BACKBONE_CKPT:-}" ]; then
  for ((i=0; i<${#ckpt_list[@]}; i++)); do ckpt_list[i]="$BACKBONE_CKPT"; done
fi
CELL_START=${CELL_START:-0}
CELL_END=${CELL_END:-$((${#run_list[@]}-1))}
N_TEST_REPEATS=${N_TEST_REPEATS:-5}

for ((i=CELL_START; i<=CELL_END; i++)); do
  $PY -m medical_image_segmentation_with_visual_prompts_tpu_torch.main \
  --training-mode downstream \
  --device $device \
  --configs $configs \
  --load-ckpt-backbone \
  --load-ckpt-backbone-path ${ckpt_list[i]} \
  --save-ckpt-prompt-tokens \
  ${use_ep_flag_list[i]} \
  ${use_dp_flag_list[i]} \
  --run-name "${run_list[i]}_$run_name"

  prompt_token_ckpt="$(ls -t "$prompt_tokens_base_dir" | head -1)/$ckpt"
  for ((j=1; j<=N_TEST_REPEATS; j++)); do
    $PY -m medical_image_segmentation_with_visual_prompts_tpu_torch.main \
    --mode test \
    --device $device \
    --training-mode downstream \
    --configs $configs \
    --load-ckpt-prompt-tokens \
    --load-ckpt-prompt-tokens-path $prompt_token_ckpt \
    ${use_ep_flag_list[i]} \
    ${use_dp_flag_list[i]} \
    --run-name "${test_list[i]}_$run_name"
    log_file="$(ls -t "$logs_base_dir" | head -1)/log.txt"
    cat $logs_base_dir/$log_file >> $result_file
  done
done
