"""Image-grid dumps and a profiler scope (counterpart of
``cap4d_tpu/utils/logging.py``). The grid is written with the port's own PNG
writer, since the card machine has no cv2."""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np

from cap4d_torch.utils.png import write_png


def save_image_grid(images: np.ndarray, path: str | Path, pad: int = 2) -> None:
    """(B, T, H, W, 3) in [-1, 1] → one PNG grid (rows B, columns T) on a
    white background, as the reference's ImageLogger lays it out."""
    b, t, h, w, c = images.shape
    grid = np.ones((b * (h + pad) - pad, t * (w + pad) - pad, c), np.float32)
    for i in range(b):
        for j in range(t):
            grid[i * (h + pad) : i * (h + pad) + h,
                 j * (w + pad) : j * (w + pad) + w] = images[i, j]
    grid = ((np.clip(grid, -1, 1) + 1.0) / 2.0 * 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, grid)


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None):
    """``torch.profiler`` trace of the enclosed block, written as a Chrome
    trace under ``log_dir``; no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
