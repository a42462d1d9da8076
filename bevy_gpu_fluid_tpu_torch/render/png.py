"""PNG encoding of uint8 RGB frames from the standard library alone
(``zlib``, ``struct``, ``binascii.crc32``): the interactive server's frame
format, with no imaging package needed on the card's host.

``encode_png`` writes 8-bit truecolour (colour type 2), no interlace, every
scanline with filter type 0 (None) and all of them in one IDAT chunk.
``decode_png`` reads exactly that form back, checking every chunk's CRC;
it is the check of the server's output, not a general PNG reader.
"""

from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# zlib level 1: an interactive frame is encoded once and sent once, so the
# fastest level pays; the field frames compress well at any level.
LEVEL = 1


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb8) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] array (row 0 = top)."""
    a = np.ascontiguousarray(rgb8)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_png: want uint8 [H, W, 3], got {a.dtype} "
                         f"{a.shape}")
    h, w, _ = a.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)   # filter byte 0 per row
    rows[:, 1:] = a.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), LEVEL))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 [H, W, 3] array of ``encode_png``'s output.  Raises
    ValueError on a bad signature or CRC, or on any form ``encode_png``
    does not write."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if binascii.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        chunks.append((kind, body))
        pos += 12 + n
    if [k for k, _ in chunks][0] != b"IHDR" or chunks[-1][0] != b"IEND":
        raise ValueError("chunks out of order")
    w, h, depth, ctype, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                         chunks[0][1])
    if (depth, ctype, comp, filt, lace) != (8, 2, 0, 0, 0):
        raise ValueError("only 8-bit RGB, not interlaced")
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only filter type 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
