"""8-bit PNG writer and reader on the standard library's ``zlib``.

The card machine has neither ``cv2`` nor PIL, so the port writes its output
images and reads its reference frames with this module. It covers 8-bit,
non-interlaced images: gray, gray+alpha, RGB, RGBA and palette on read; gray
and RGB on write. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str | Path, image: np.ndarray, level: int = 6) -> None:
    """Write (H, W) gray or (H, W, 3) RGB uint8 as a PNG."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        line = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur_l = list(line.tobytes())
            up = list(prev.tobytes())
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur_l[i] = (cur_l[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur_l[i] = (cur_l[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def png_size(path: str | Path):
    """(width, height) from a PNG's header, without decoding it."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])


def read_png(path: str | Path) -> np.ndarray:
    """Read an 8-bit PNG as (H, W, 3) RGB uint8 (alpha dropped, gray
    replicated), the same array ``cv2.imread(path)[..., ::-1]`` gives."""
    blob = Path(path).read_bytes()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are supported "
                         f"(depth {depth}, color type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
