#!/bin/bash
# Animate an existing fitted avatar (render + PLY export) on the PyTorch port.
set -e
python -m cap4d_torch.avatar.animate \
    --model_path examples/output/migu/avatar/ \
    --animation_path examples/input/animation/sequence_01/fit.npz \
    --cam_trajectory_path examples/input/animation/sequence_01/orbit.npz \
    --output_path examples/output/migu/animation_01/
