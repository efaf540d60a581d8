"""What a CUDA graph capture needs of the port, read on the CPU: a dispatch
mode that records the operators a capture refuses (shared by the tests of
the fit's and of training's captured steps), and the launch accounting of
``cuda_build.capture_graph`` / ``replay_graph`` with stand-in graphs.
"""

import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cap4d_torch.ops import flash_attention, norms
from cap4d_torch.ops.cuda_build import CudaKernel, capture_graph, replay_graph
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


class HostReads(TorchDispatchMode):
    """Records the operators that read the device on the host or copy an
    array from it (a capture fails on them): scalar reads, data-dependent
    sizes, and tensors made from host arrays."""
    SYNCS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero", "masked_select", "bincount",
             "_unique2", "unique_dim", "unique_consecutive", "equal", "allclose"}

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        bool_index = name.startswith("index") and len(args) > 1 and isinstance(args[1], (list, tuple)) \
            and any(isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in args[1])
        # a Python number written into a tensor is lifted to a 0-d tensor here;
        # on the card it is a fill
        lifted = name == "lift_fresh" and args[0].dim() > 0
        unsized = name == "repeat_interleave" and (kwargs or {}).get("output_size") is None
        if name in self.SYNCS or bool_index or lifted or unsized:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def test_host_reads_finds_syncs_and_uploads():
    """The scan names a scalar read, a boolean index and an uploaded list,
    and passes plain tensor arithmetic."""
    x = torch.arange(6.0)
    with HostReads() as scan:
        _ = (x * 2 + 1).sum()
    assert scan.found == []
    with HostReads() as scan:
        float(x.sum())
        _ = x[x > 2]
        _ = torch.tensor([1.0, 2.0]) + x[:2]
    assert any("_local_scalar_dense" in f for f in scan.found), scan.found
    assert any("index" in f for f in scan.found), scan.found
    assert any("lift_fresh" in f for f in scan.found), scan.found


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_capture_takes_back_launches_and_replays_add_them(monkeypatch):
    """A capture launches nothing: what ``call`` counted while capturing is
    taken back and returned per kernel, and every replay adds it again (a
    stand-in graph; the card's capture is chip_smoke.py's)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    k, other = flash_attention.KERNEL_BWD, norms.KERNEL
    before, before_other = k.launches, other.launches

    def fn():   # what a captured body's launches do to the counts
        k.launches += 3

    graph, per_replay = capture_graph(fn)
    assert k.launches == before and other.launches == before_other
    assert per_replay[k.name] == 3 and per_replay[other.name] == 0
    assert set(per_replay) == {kk.name for kk in CudaKernel.registry}
    for _ in range(4):
        replay_graph(graph, per_replay)
    assert graph.replays == 4
    assert k.launches == before + 12 and other.launches == before_other
    k.launches = before


def test_capture_restores_counts_when_it_raises(monkeypatch):
    """A failed capture raises, and leaves the counts as they were."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    k = flash_attention.KERNEL
    before = k.launches

    def fn():
        k.launches += 2
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        capture_graph(fn)
    assert k.launches == before
