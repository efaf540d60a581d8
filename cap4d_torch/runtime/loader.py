"""ctypes bindings and build of the port's native runtime (``cap4d_runtime.cpp``).

Counterpart of ``cap4d_tpu/runtime/loader.py``, with its own copy of the
C++ source. The library carries its own PNG and JPEG codecs (the card's
machine has neither libpng nor libjpeg), so it needs only g++ and pthreads.
It is compiled at first use, never at import, with
``g++ -O3 -march=native -fPIC -shared`` into ``cap4d_torch/_build/``, named by
a hash of the source, the flags and the host CPU's features. There is no fallback: if the build fails,
the error carries g++'s output, and a frame that cannot be decoded raises
with the file's name and the reason (the JAX package's loader switches to
cv2 instead, which changes pixels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cap4d_runtime.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

# the C4D_* status codes of cap4d_runtime.cpp
STATUS = {
    -1: "cannot be opened or read",
    -2: "does not fit the output buffer",
    -3: "is neither a PNG nor a JPEG file",
    -4: "is a malformed or truncated PNG",
    -5: "is a malformed or truncated JPEG",
    -6: ("is a JPEG the port's decoder does not take (it reads Huffman-coded JPEGs "
         "of 8-bit samples with 1 or 3 components, not arithmetic-coded, lossless, "
         "12-bit or CMYK ones, nor progressive ones left unrefined, as a cut file is)"),
    -7: "cannot be written",
    -8: "was given invalid arguments",
}

_lock = threading.Lock()
_lib = None

_INT_P = ctypes.POINTER(ctypes.c_int)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_U8_P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "c4d_load_frame": ([ctypes.c_char_p, _INT_P, ctypes.c_int, ctypes.c_int, _FLOAT_P],
                       ctypes.c_int),
    "c4d_decode_image": ([ctypes.c_char_p, _U8_P, ctypes.c_long, _INT_P, _INT_P], ctypes.c_int),
    "c4d_encode_jpeg": ([ctypes.c_char_p, _U8_P, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                        ctypes.c_int),
    "c4d_pool_create": ([ctypes.c_int], ctypes.c_void_p),
    "c4d_pool_destroy": ([ctypes.c_void_p], None),
    "c4d_pool_submit": ([ctypes.c_void_p, ctypes.c_char_p, _INT_P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int], ctypes.c_int),
    "c4d_pool_wait": ([ctypes.c_void_p, ctypes.c_int, _FLOAT_P, ctypes.c_int], ctypes.c_int),
}


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them."""
    try:
        with open("/proc/cpuinfo") as fh:
            return next((line for line in fh if line.startswith("flags")), platform.processor())
    except OSError:
        return platform.processor()


def so_path() -> Path:
    """The library's path, named by the source, the flags and the host CPU."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_flags().encode())
    return BUILD_DIR / f"cap4d_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raise with g++'s output on failure."""
    so = so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {SOURCE.name}: g++ not found") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def _check(status: int, path) -> None:
    if status != 0:
        raise IOError(f"{path} {STATUS.get(status, f'failed with status {status}')}")


def _box(crop_box) -> Optional[ctypes.Array]:
    if crop_box is None:
        return None
    return (ctypes.c_int * 4)(*[int(v) for v in crop_box[:4]])


def load_frame_native(path: str | Path, crop_box, target_res: int, bg_value: int = 255) -> np.ndarray:
    """Fused decode → pad-crop (outside at ``bg_value``) → resize → [-1, 1]
    float32 (target_res, target_res, 3)."""
    out = np.empty((target_res, target_res, 3), np.float32)
    status = lib().c4d_load_frame(str(path).encode(), _box(crop_box), int(target_res),
                                  int(bg_value), out.ctypes.data_as(_FLOAT_P))
    _check(status, path)
    return out


def decode_image(path: str | Path) -> np.ndarray:
    """A PNG or JPEG file → RGB uint8 (H, W, 3)."""
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    fn = lib().c4d_decode_image
    status = fn(str(path).encode(), None, 0, ctypes.byref(w), ctypes.byref(h))
    if status != -2:   # the size query fails with -2 once the image decoded
        _check(status, path)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(fn(str(path).encode(), out.ctypes.data_as(_U8_P), out.nbytes,
              ctypes.byref(w), ctypes.byref(h)), path)
    return out


def encode_jpeg(path: str | Path, rgb: np.ndarray, quality: int = 95) -> None:
    """Write RGB uint8 (H, W, 3) as a baseline 4:2:0 JPEG with libjpeg's
    default tables at ``quality`` (what ``cv2.imwrite`` writes by default)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3), got {rgb.dtype} {rgb.shape}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"JPEG quality must be in 1..100, got {quality}")
    rgb = np.ascontiguousarray(rgb)
    status = lib().c4d_encode_jpeg(str(path).encode(), rgb.ctypes.data_as(_U8_P),
                                   rgb.shape[1], rgb.shape[0], int(quality))
    _check(status, path)


class NativePrefetcher:
    """Submit many frames, collect them in order; the pool's threads decode
    off the GIL while the caller works."""

    def __init__(self, n_threads: int = 8):
        self._lib = lib()
        self._pool = self._lib.c4d_pool_create(int(n_threads))
        self._next_ticket = 0
        self._jobs: Dict[int, tuple] = {}   # ticket -> (path, target_res)

    def submit(self, path: str | Path, crop_box, target_res: int, bg_value: int = 255) -> int:
        ticket = self._next_ticket
        self._next_ticket += 1
        self._jobs[ticket] = (str(path), int(target_res))
        # the pool copies the path and the box into its job before returning
        self._lib.c4d_pool_submit(self._pool, str(path).encode(), _box(crop_box),
                                  int(target_res), int(bg_value), ticket)
        return ticket

    def wait(self, ticket: int, target_res: int) -> np.ndarray:
        path, res = self._jobs.pop(ticket)
        if int(target_res) != res:   # the pool copies res² pixels into ``out``
            raise ValueError(f"ticket {ticket} was submitted at {res}, not {target_res}")
        out = np.empty((res, res, 3), np.float32)
        _check(self._lib.c4d_pool_wait(self._pool, ticket, out.ctypes.data_as(_FLOAT_P), res),
               path)
        return out

    def close(self) -> None:
        if self._pool:
            self._lib.c4d_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self) -> "NativePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def load_frames(paths: Sequence[str | Path], crop_boxes, target_res: int,
                n_threads: int = 8) -> np.ndarray:
    """Load many frames through one pool; (N, target_res, target_res, 3)."""
    with NativePrefetcher(n_threads) as pool:
        tickets = [pool.submit(p, b, target_res) for p, b in zip(paths, crop_boxes)]
        return np.stack([pool.wait(t, target_res) for t in tickets])
