"""Full-body SMPL avatar fitting CLI (counterpart of
``cap4d_tpu/avatar/train_fullbody.py``).

Reference: train_fullbody.py (SMPLGaussianModel + SMPLScene): the head
avatar's training loop with the FLAME-specific regularizers disabled
(train_fullbody.py:275-285). Run it with
``python -m cap4d_torch.avatar.train_fullbody``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from cap4d_torch.avatar.train import training
from cap4d_torch.utils.config import load_yaml
from cap4d_torch.utils.device import resolve_device

SMPL_DISABLED_REGULARIZERS = dict(
    lambda_laplacian=0.0, lambda_relative_deform=0.0,
    lambda_relative_rot=0.0, lambda_neck=0.0,
)


def train_fullbody(source_paths, model_path, config_path, interval: int = 2000,
                   load_existing_checkpoint: bool = False,
                   smpl_asset_dir: str = "data/assets/smpl", lpips_weights=None, device=None,
                   chunked=None, dispatch_len=None):
    """Fit an SMPL avatar with a config's model_params and opt_params, the
    FLAME regularizers off; runs on the card unless ``device="cpu"``.
    ``chunked`` and ``dispatch_len`` as ``training`` takes them."""
    device = resolve_device(device)
    config = load_yaml(config_path)
    opt_params = dict(config["opt_params"], **SMPL_DISABLED_REGULARIZERS)
    n_iter = opt_params["iterations"]
    testing = list(range(interval, n_iter + 1, interval))
    return training(
        source_paths=source_paths, model_path=Path(model_path),
        model_params=config["model_params"], opt_params=opt_params,
        testing_iterations=testing, checkpoint_iterations=testing + [n_iter],
        load_existing_checkpoint=load_existing_checkpoint, lpips_weights=lpips_weights,
        variant="smpl", smpl_asset_dir=smpl_asset_dir, device=device,
        chunked=chunked, dispatch_len=dispatch_len,
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_paths", type=str, nargs="+", required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--interval", type=int, default=2000)
    parser.add_argument("--load_existing_checkpoint", action="store_true")
    parser.add_argument("--smpl_asset_dir", type=str, default="data/assets/smpl")
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args()
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    train_fullbody(args.source_paths, args.model_path, args.config_path, args.interval,
                   args.load_existing_checkpoint, args.smpl_asset_dir, args.lpips_weights,
                   device=args.device)


if __name__ == "__main__":
    main()
