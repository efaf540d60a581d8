#!/bin/bash
# Full single-subject pipeline on the PyTorch port: 840-image generation ->
# 10k-iteration avatar fit.
set -e

SUBJECT=${1:?usage: generate_subject.sh <subject_dir> <output_dir> [gen_config] [groups_per_device]}
OUT=${2:?usage: generate_subject.sh <subject_dir> <output_dir> [gen_config] [groups_per_device]}
GEN_CONFIG=${3:-configs/generation/single_ref.yaml}
GROUPS=${4:-1}

python -m cap4d_torch.inference.generate_images \
    --config_path "$GEN_CONFIG" \
    --reference_data_path "$SUBJECT" \
    --output_path "$OUT" \
    --groups_per_device "$GROUPS"

python -m cap4d_torch.avatar.train \
    --source_paths "$OUT/reference_images" "$OUT/generated_images" \
    --model_path "$OUT/avatar" \
    --config_path configs/avatar/default.yaml \
    --interval 2000
