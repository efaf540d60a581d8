"""ctypes bindings and build of the port's native runtime (``cap4d_runtime.cpp``,
the H.264 decoder ``h264.cpp``, the MPEG-4 Part 2 decoder ``mpeg4.cpp``, the
VP9 decoder ``vp9.cpp``, the VP8 decoder ``vp8.cpp`` and the HEVC decoder
``hevc.cpp``).

Counterpart of ``cap4d_tpu/runtime/loader.py``, with its own copy of the
C++ source. The library carries its own PNG and JPEG codecs (the card's
machine has neither libpng nor libjpeg), so it needs only g++ and pthreads.
Its sources are compiled at first use, never at import, with
``g++ -O3 -march=native -fPIC`` (one process a source, all at once) and
linked into one library under
``cap4d_torch/_build/``, named by a hash of the sources, the flags and the
host CPU's features. There is no fallback: if the build fails,
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = [_HERE / "cap4d_runtime.cpp", _HERE / "h264.cpp", _HERE / "mpeg4.cpp", _HERE / "vp9.cpp",
           _HERE / "vp8.cpp", _HERE / "hevc.cpp"]
BUILD_DIR = _HERE.parent / "_build"
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
    "c4d_decode_buffer": ([ctypes.c_char_p, ctypes.c_long, _U8_P, ctypes.c_long, _INT_P, _INT_P],
                          ctypes.c_int),
    "c4d_decode_jpeg_planes": ([ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(_U8_P),
                                ctypes.POINTER(ctypes.c_long), _INT_P], ctypes.c_int),
    "c4d_encode_jpeg": ([ctypes.c_char_p, _U8_P, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                        ctypes.c_int),
    "c4d_pool_create": ([ctypes.c_int], ctypes.c_void_p),
    "c4d_pool_destroy": ([ctypes.c_void_p], None),
    "c4d_pool_submit": ([ctypes.c_void_p, ctypes.c_char_p, _INT_P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int], ctypes.c_int),
    "c4d_pool_wait": ([ctypes.c_void_p, ctypes.c_int, _FLOAT_P, ctypes.c_int], ctypes.c_int),
    "c4d_h264_open": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p, ctypes.c_int],
                      ctypes.c_void_p),
    "c4d_h264_size": ([ctypes.c_void_p, _INT_P, _INT_P], ctypes.c_int),
    "c4d_h264_colour": ([ctypes.c_void_p, _INT_P, _INT_P], ctypes.c_int),
    "c4d_h264_buffering": ([ctypes.c_void_p, _INT_P], ctypes.c_int),
    "c4d_h264_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _U8_P, _U8_P, _U8_P,
                         ctypes.c_int, ctypes.c_int, _INT_P, ctypes.c_char_p, ctypes.c_int],
                        ctypes.c_int),
    "c4d_h264_scan": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p,
                       ctypes.c_int], ctypes.c_int),
    "c4d_h264_reset": ([ctypes.c_void_p], None),
    "c4d_h264_close": ([ctypes.c_void_p], None),
    "c4d_mpeg4_open": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int],
                       ctypes.c_void_p),
    "c4d_mpeg4_info": ([ctypes.c_void_p, _INT_P, _INT_P, _INT_P, _INT_P], ctypes.c_int),
    "c4d_mpeg4_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _U8_P, _U8_P, _U8_P,
                          ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "c4d_mpeg4_scan": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _INT_P, _INT_P,
                        ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "c4d_mpeg4_reset": ([ctypes.c_void_p], None),
    "c4d_mpeg4_close": ([ctypes.c_void_p], None),
    "c4d_vp9_open": ([ctypes.c_char_p, ctypes.c_int], ctypes.c_void_p),
    "c4d_vp9_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p,
                        ctypes.c_int], ctypes.c_int),
    "c4d_vp9_output": ([ctypes.c_void_p, _U8_P, _U8_P, _U8_P], ctypes.c_int),
    "c4d_vp9_scan": ([ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p, ctypes.c_int],
                     ctypes.c_int),
    "c4d_vp9_tools": ([ctypes.c_void_p], ctypes.c_ulonglong),
    "c4d_vp9_reset": ([ctypes.c_void_p], None),
    "c4d_vp9_close": ([ctypes.c_void_p], None),
    "c4d_vp8_open": ([ctypes.c_char_p, ctypes.c_int], ctypes.c_void_p),
    "c4d_vp8_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p,
                        ctypes.c_int], ctypes.c_int),
    "c4d_vp8_output": ([ctypes.c_void_p, _U8_P, _U8_P, _U8_P], ctypes.c_int),
    "c4d_vp8_scan": ([ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p, ctypes.c_int],
                     ctypes.c_int),
    "c4d_vp8_tools": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)], None),
    "c4d_vp8_reset": ([ctypes.c_void_p], None),
    "c4d_vp8_close": ([ctypes.c_void_p], None),
    "c4d_hevc_open": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p, ctypes.c_int],
                      ctypes.c_void_p),
    "c4d_hevc_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p,
                         ctypes.c_int], ctypes.c_int),
    "c4d_hevc_output": ([ctypes.c_void_p, _U8_P, _U8_P, _U8_P], ctypes.c_int),
    "c4d_hevc_scan": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, _INT_P, ctypes.c_char_p,
                       ctypes.c_int], ctypes.c_int),
    "c4d_hevc_buffering": ([ctypes.c_void_p, _INT_P, _INT_P], None),
    "c4d_hevc_tools": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)], None),
    "c4d_hevc_discarded": ([ctypes.c_void_p, _INT_P, ctypes.c_int], ctypes.c_int),
    "c4d_hevc_reset": ([ctypes.c_void_p], None),
    "c4d_hevc_close": ([ctypes.c_void_p], None),
}


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them."""
    try:
        with open("/proc/cpuinfo") as fh:
            return next((line for line in fh if line.startswith("flags")), platform.processor())
    except OSError:
        return platform.processor()


def so_path() -> Path:
    """The library's path, named by the sources, the flags and the host CPU."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_flags().encode())
    return BUILD_DIR / f"cap4d_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists: one g++ per source, all at once,
    then one link; raise with g++'s output on failure."""
    so = so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    compile_flags = [f for f in FLAGS if f != "-shared"]
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in SOURCES]

    def run(cmd, what):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("cannot build the runtime: g++ not found") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {what}:\n{proc.stderr}")

    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(lambda so_src: run(["g++", *compile_flags, "-c", str(so_src[1]), "-o",
                                              str(so_src[0])], so_src[1].name),
                          zip(objects, SOURCES)))
        run(["g++", "-shared", *map(str, objects), "-o", str(tmp), "-lpthread"],
            ", ".join(src.name for src in SOURCES))
    finally:
        for o in objects:
            o.unlink(missing_ok=True)
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


def _decode(fn, args: tuple, name, shape=None) -> np.ndarray:
    """Decode through ``fn(*args, out, cap, &w, &h)``: once into a buffer of
    the expected ``shape`` (h, w) when one is given and the image has it,
    else twice, once for the size and once into a buffer of that size."""
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if shape is not None:
        out = np.empty((*shape, 3), np.uint8)
        status = fn(*args, out.ctypes.data_as(_U8_P), out.nbytes, ctypes.byref(w),
                    ctypes.byref(h))
        if status == 0 and (h.value, w.value) == tuple(shape):
            return out
        if status not in (0, -2):
            _check(status, name)
    status = fn(*args, None, 0, ctypes.byref(w), ctypes.byref(h))
    if status != -2:   # the size query fails with -2 once the image decoded
        _check(status, name)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(fn(*args, out.ctypes.data_as(_U8_P), out.nbytes, ctypes.byref(w), ctypes.byref(h)),
           name)
    return out


def decode_image(path: str | Path) -> np.ndarray:
    """A PNG or JPEG file → RGB uint8 (H, W, 3)."""
    return _decode(lib().c4d_decode_image, (str(path).encode(),), path)


def decode_bytes(data: bytes, name: str = "image", shape=None) -> np.ndarray:
    """A PNG or JPEG image in memory (a Motion-JPEG or PNG video sample) →
    RGB uint8 (H, W, 3); decoded once when its (H, W) is ``shape`` (a video
    track's size), twice otherwise; errors name ``name``."""
    return _decode(lib().c4d_decode_buffer, (data, len(data)), name, shape)


class JpegPlanes(NamedTuple):
    """A JPEG's components as ffmpeg's ``mjpeg`` decoder gives them
    (:func:`decode_jpeg_planes`): each (dh, dw) uint8 plane, its (h, v)
    sampling factors, and whether the frame is progressive or its
    components are RGB (an Adobe marker's transform 0, or ids R, G, B)."""

    planes: Tuple[np.ndarray, ...]
    factors: Tuple[Tuple[int, int], ...]
    progressive: bool
    rgb: bool


def decode_jpeg_planes(data: bytes, name: str = "image") -> JpegPlanes:
    """A JPEG video sample's component planes at their own sizes, as
    ffmpeg's ``mjpeg`` decoder makes them (libavcodec's simple IDCT, no
    upsampling; not libjpeg's islow IDCT, which :func:`decode_bytes` keeps
    for still images, as ``cv2.imread`` does); errors name ``name``."""
    fn = lib().c4d_decode_jpeg_planes
    info = (ctypes.c_int * 21)()
    caps = (ctypes.c_long * 4)()
    ptrs = (_U8_P * 4)()
    status = fn(data, len(data), ptrs, caps, info)
    if status not in (0, -2):
        _check(status, name)
    n = info[2]
    planes = tuple(np.empty((info[8 + 4 * i], info[7 + 4 * i]), np.uint8) for i in range(n))
    for i, p in enumerate(planes):
        ptrs[i], caps[i] = p.ctypes.data_as(_U8_P), p.nbytes
    _check(fn(data, len(data), ptrs, caps, info), name)
    return JpegPlanes(planes, tuple((info[5 + 4 * i], info[6 + 4 * i]) for i in range(n)),
                      bool(info[3]), bool(info[4]))


# (luma factors, chroma factors) -> (horizontal, vertical) chroma subsampling
# shift of the layouts ffmpeg's mjpeg decoder outputs as yuvj420p, yuvj422p,
# yuvj444p, yuvj440p and yuvj411p
JPEG_LAYOUTS = {((2, 2), (1, 1)): (1, 1), ((2, 1), (1, 1)): (1, 0), ((1, 1), (1, 1)): (0, 0),
                ((1, 2), (1, 1)): (0, 1), ((4, 1), (1, 1)): (2, 0)}


class MjpegDecoder:
    """Motion-JPEG samples -> (Y, U, V) planes as ffmpeg's ``mjpeg``
    decoder outputs them (:func:`decode_jpeg_planes`), for the reader's
    planes path: full-range BT.601 (swscale converts ffmpeg's ``yuvj``
    formats so), U and V None for a greyscale JPEG. Layouts ffmpeg gives
    another format (RGB components, other sampling factors) and progressive
    frames raise ``ValueError`` naming them. :attr:`chroma_location` is
    centre, what ffmpeg's ``mjpeg`` decoder sets on every picture."""

    matrix, full_range, chroma_location = "bt601", True, "center"

    def __init__(self, name: str = "Motion-JPEG stream"):
        self.name = name

    def decode(self, sample: bytes, what: str = ""):
        where = f"{self.name} {what}".strip()
        try:
            jp = decode_jpeg_planes(sample, where)
        except IOError as e:
            raise ValueError(str(e)) from None
        if jp.progressive:
            raise ValueError(f"{where}: a progressive JPEG sample (ffmpeg's progressive "
                             "Motion-JPEG decode is not copied)")
        if len(jp.planes) == 1:
            return jp.planes[0], None, None
        factors = (jp.factors[0], jp.factors[1])
        if jp.rgb or len(jp.planes) != 3 or jp.factors[1] != jp.factors[2]:
            raise ValueError(f"{where}: a JPEG sample of {len(jp.planes)} components"
                             f"{' coded as RGB' if jp.rgb else ''} (factors {jp.factors}): "
                             "only greyscale and YCbCr Motion-JPEG are read")
        hf, vf = factors[0][0] // factors[1][0], factors[0][1] // factors[1][1]
        if (hf * factors[1][0], vf * factors[1][1]) != factors[0] or \
                ((hf, vf), (1, 1)) not in JPEG_LAYOUTS:
            raise ValueError(f"{where}: JPEG sampling factors {jp.factors}: only 4:2:0, 4:2:2, "
                             "4:4:4, 4:4:0 and 4:1:1 Motion-JPEG are read")
        return jp.planes

    def reset(self) -> None:
        """Nothing to drop: every sample stands alone."""

    def close(self) -> None:
        pass


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
