"""The port's standard-library PNG encoder (render/png.py), read back two
ways: by an independent chunk walk in this file (signature, IHDR fields,
every chunk's CRC, zlib, the per-row filter byte) and by ``decode_png``.
Both must give the exact array: PNG is lossless."""

import binascii
import struct
import zlib

import numpy as np
import pytest

from bevy_gpu_fluid_tpu_torch.render.png import decode_png, encode_png


def _walk(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == binascii.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + n
    assert pos == len(data)
    return chunks


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (32, 64), (5, 1001)])
def test_png_decodes_to_the_exact_array(h, w):
    a = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)
    data = encode_png(a)
    chunks = _walk(data)
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (w, h, 8, 2, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()                  # filter type 0 per row
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 3), a)
    np.testing.assert_array_equal(decode_png(data), a)


def test_png_refuses_bad_input_and_bad_crc():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))
    data = bytearray(encode_png(np.full((3, 5, 3), 9, np.uint8)))
    data[45] ^= 0xFF                             # inside IDAT's body
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
