#!/bin/bash
# Single-ref image generation for the lincoln example on the PyTorch port.
set -e
python -m cap4d_torch.inference.generate_images \
    --config_path configs/generation/single_ref.yaml \
    --reference_data_path examples/input/lincoln/ \
    --output_path examples/output/lincoln/
