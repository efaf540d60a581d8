#!/bin/bash
# Animate the refined SMPL full-body avatar with the combined animation
# sequence on the PyTorch port (render + PLY export).
set -e
python -m cap4d_torch.avatar.animate_smpl \
    --model_path examples/output/full_body/avatar_refine/ \
    --output_path examples/output/full_body/animated_render/ \
    --animation_path combined_animation.npz
