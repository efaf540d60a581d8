#!/bin/bash
# End-to-end smoke test of the PyTorch port on one NVIDIA GPU:
# stage 1 debug generation -> stage 2 debug avatar fit -> stage 3 animation.
# Requires the user-downloaded assets: data/assets/flame/flame2023_no_jaw.pkl
# and data/weights/mmdm/{checkpoints/*.ckpt, config_dump.yaml}.
set -e

SUBJECT=${1:-examples/input/tesla}
OUT=${2:-examples/debug_output/tesla}

python -m cap4d_torch.inference.generate_images \
    --config_path configs/generation/debug.yaml \
    --reference_data_path "$SUBJECT" \
    --output_path "$OUT"

python -m cap4d_torch.avatar.train \
    --source_paths "$OUT/reference_images" "$OUT/generated_images" \
    --model_path "$OUT/avatar" \
    --config_path configs/avatar/debug.yaml \
    --interval 1000

python -m cap4d_torch.avatar.animate \
    --model_path "$OUT/avatar" \
    --animation_path examples/input/animation/sequence_00/fit.npz \
    --output_path "$OUT/sequence_00"
