"""Which demuxer reads a video file: by its first bytes, as ffmpeg probes
a file (not by its extension).

- ISO-BMFF (``.mp4``/``.mov``: a first box of a known top-level type) →
  ``data/mp4.py``;
- ``RIFF....AVI `` → ``data/avi.py``;
- the EBML magic ``1A 45 DF A3`` → ``data/mkv.py`` (DocType ``matroska`` or
  ``webm``, else it raises).

Each demuxer routes its codecs through a table of its own onto the codec
names of ``mp4.CODECS`` and returns the same :class:`VideoTrack`. Anything
else raises ``ValueError`` naming the path and the file's first bytes.
"""

from __future__ import annotations

from cap4d_torch.data import avi, mkv, mp4
from cap4d_torch.data.mp4 import VideoTrack

# the box types that start an ISO-BMFF file (ffmpeg's mov probe takes these)
ISO_BMFF_FIRST_BOXES = {b"ftyp", b"styp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot",
                        b"uuid", b"junk", b"sidx", b"moof", b"meta", b"pdin", b"PICT"}


def read_track(path) -> VideoTrack:
    """The sample table of the first video track of the mp4/mov, AVI or
    Matroska/WebM file ``path``."""
    with open(path, "rb") as fh:
        head = fh.read(16)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return avi.read_track(path)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return mkv.read_track(path)
    if head[4:8] in ISO_BMFF_FIRST_BOXES:
        return mp4.read_track(path)
    raise ValueError(f"{path}: not a video file the port reads (ISO-BMFF mp4/mov, RIFF AVI, "
                     f"Matroska/WebM); its first bytes are {head.hex(' ') or 'none (empty)'}")
