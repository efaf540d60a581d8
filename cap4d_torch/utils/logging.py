"""Profiler scope for the sampling loop (counterpart of
``cap4d_tpu/utils/logging.py:profile_trace``)."""

from __future__ import annotations

import contextlib
from pathlib import Path


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
