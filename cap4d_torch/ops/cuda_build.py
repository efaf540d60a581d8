"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled on first use
with ``nvcc`` for ``sm_90a`` into a shared library under ``cap4d_torch/_build``
(ignored by git), named by a hash of its source, the ``csrc`` headers it
includes and its flags, so that an edited source or header is rebuilt, and
loaded with ``ctypes``. ``build_all`` starts one
``nvcc`` per source at once. Every C entry point returns
``cudaGetLastError()``; the wrapper raises when it is not 0, so a refused
launch never passes silently.

Nothing here is imported or built on a machine without CUDA until a kernel
is launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), str(Path(cuda_home) / "bin" / "nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One ``csrc`` source: its build, its ctypes binding and its launch count.

    ``launches`` counts successful launches through ``call``; callers reset
    it to 0 to count the launches of one run."""

    def __init__(self, source: str, signatures: Dict[str, Sequence], extra_flags: Iterable[str] = ()):
        self.source = CSRC / source
        self.signatures = dict(signatures)
        self.extra_flags = list(extra_flags)
        self.launches = 0
        self._lib = None
        self.build_log = ""

    @property
    def name(self) -> str:
        return self.source.stem

    def flags(self) -> List[str]:
        return ARCH_FLAGS + BASE_FLAGS + self.extra_flags

    def sources(self) -> List[Path]:
        """The source and every ``csrc`` header it includes, directly or not."""
        out, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in out:
                continue
            out.append(path)
            for name in _INCLUDE.findall(path.read_text()):
                if (CSRC / name).is_file():
                    todo.append(CSRC / name)
        return out

    def so_path(self) -> Path:
        h = hashlib.sha256()
        for path in self.sources():
            h.update(path.read_bytes())
        h.update(" ".join(self.flags()).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def build_command(self, out: Path) -> List[str]:
        return [nvcc_path(), *self.flags(), "-Xptxas", "-v", "-o", str(out), str(self.source)]

    def start_build(self):
        """Start nvcc when the library is missing; returns (process, temp
        path) or None."""
        so = self.so_path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(self.build_command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, build) -> None:
        proc, tmp = build
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, self.so_path())

    def lib(self):
        if self._lib is None:
            build = self.start_build()
            if build is not None:
                self.finish_build(build)
            lib = ctypes.CDLL(str(self.so_path()))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.c4d_error_string.argtypes = [ctypes.c_int]
            lib.c4d_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Launch through C entry point ``fn``; raise on a CUDA error."""
        lib = self.lib()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = lib.c4d_error_string(rc).decode()
            raise RuntimeError(f"{self.source.name}:{fn} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Compile every missing library in parallel (one nvcc each), then load."""
    kernels = list(kernels)
    builds = [(k, k.start_build()) for k in kernels]
    errors = []
    for k, build in builds:
        if build is not None:
            try:
                k.finish_build(build)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()
