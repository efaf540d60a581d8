#!/bin/bash
# Full-body SMPL pipeline on the PyTorch port: fit -> wave animation -> render.
set -e

DATA=${1:?usage: generate_fullbody.sh <smpl_data_dir> <output_dir>}
OUT=${2:?usage: generate_fullbody.sh <smpl_data_dir> <output_dir>}

python -m cap4d_torch.avatar.train_fullbody \
    --source_paths "$DATA" \
    --model_path "$OUT/avatar" \
    --config_path configs/avatar/default.yaml \
    --interval 2000

python -m cap4d_torch.tools.generate_animation --output "$OUT/wave.npz"

python -m cap4d_torch.avatar.animate_smpl \
    --model_path "$OUT/avatar" \
    --animation_path "$OUT/wave.npz" \
    --output_path "$OUT/animation"
