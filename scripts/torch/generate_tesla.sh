#!/bin/bash
# The tesla example on the PyTorch port: single-ref generation -> avatar fit ->
# animated render + PLY export.
set -e
mkdir -p examples/output

python -m cap4d_torch.inference.generate_images \
    --config_path configs/generation/single_ref.yaml \
    --reference_data_path examples/input/tesla/ \
    --output_path examples/output/tesla/

python -m cap4d_torch.avatar.train \
    --config_path configs/avatar/default.yaml \
    --source_paths examples/output/tesla/reference_images/ examples/output/tesla/generated_images/ \
    --model_path examples/output/tesla/avatar/

python -m cap4d_torch.avatar.animate \
    --model_path examples/output/tesla/avatar/ \
    --animation_path examples/input/animation/sequence_00/fit.npz \
    --cam_trajectory_path examples/input/animation/sequence_00/orbit.npz \
    --output_path examples/output/tesla/animation_00/
