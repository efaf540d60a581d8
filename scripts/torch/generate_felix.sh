#!/bin/bash
# The felix example on the PyTorch port: multi-ref generation -> avatar fit ->
# animated render + PLY export.
set -e
mkdir -p examples/output

python -m cap4d_torch.inference.generate_images \
    --config_path configs/generation/multi_ref.yaml \
    --reference_data_path examples/input/felix/ \
    --output_path examples/output/felix/

python -m cap4d_torch.avatar.train \
    --config_path configs/avatar/default.yaml \
    --source_paths examples/output/felix/reference_images/ examples/output/felix/generated_images/ \
    --model_path examples/output/felix/avatar/

python -m cap4d_torch.avatar.animate \
    --model_path examples/output/felix/avatar/ \
    --animation_path examples/input/animation/sequence_01/fit.npz \
    --cam_trajectory_path examples/input/animation/sequence_01/orbit.npz \
    --output_path examples/output/felix/animation_01/
