#!/bin/bash
# SMPL full-body avatar refinement fit on the PyTorch port.
set -e
python -m cap4d_torch.avatar.train_fullbody \
    --config_path configs/avatar/default.yaml \
    --source_paths examples/output/yidong/ \
    --model_path examples/output/yidong/avatar_refine/
