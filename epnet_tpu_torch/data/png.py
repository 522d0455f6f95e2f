"""PNG files in numpy and the standard library's ``zlib``.

The JAX package reads and writes the KITTI images with PIL
(``epnet_tpu/data/kitti_dataset.py``, ``epnet_tpu/utils/testing.py``),
which the port may not count on finding. This module reads non-interlaced
8-bit gray, RGB and RGBA PNGs with any of the five row filters, and writes
RGB PNGs with filter 0 (none). ``tests/test_torch_data.py`` holds it to
PIL, pixel for pixel.

Sub and Up are vectorized; Average and Paeth predict each byte from the one
reconstructed just before it, so they loop over the row in Python and cost
the most per row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel: gray, RGB, RGBA


def _chunks(data: bytes, path):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
    at = 8
    while at + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[at:at + 8])
        payload = data[at + 8:at + 8 + length]
        crc = data[at + 8 + length:at + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f'{path}: truncated {kind!r} chunk')
        if struct.unpack('>I', crc)[0] != zlib.crc32(kind + payload):
            raise ValueError(f'{path}: bad CRC in {kind!r} chunk')
        yield kind, payload
        if kind == b'IEND':
            return
        at += 12 + length
    raise ValueError(f'{path}: no IEND chunk')


def _header(payload: bytes, path):
    """(height, width, channels) of an IHDR this module decodes; raises on
    any other."""
    width, height, depth, colour, compression, filtering, interlace = struct.unpack(
        '>IIBBBBB', payload)
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(f'{path}: unsupported PNG (bit depth {depth}, colour type {colour}, '
                         f'interlace {interlace}); 8-bit gray, RGB or RGBA, not interlaced')
    return height, width, _CHANNELS[colour]


def read_header(path) -> tuple:
    """(height, width, channels) of the PNG at ``path``, from its IHDR."""
    with open(path, 'rb') as f:
        head = f.read(33)  # signature + the IHDR chunk, which comes first
    kind, payload = next(_chunks(head, path))
    if kind != b'IHDR':
        raise ValueError(f'{path}: the first chunk is {kind!r}, not IHDR')
    return _header(payload, path)


def _average(line: list, prev: list, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (line[i] + ((left + prev[i]) >> 1)) & 255
    return cur


def _paeth(line: list, prev: list, bpp: int) -> bytearray:
    cur = bytearray(len(line))
    for i in range(len(line)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        cur[i] = (line[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    return cur


def _unfilter(raw: bytes, height: int, width: int, bpp: int, path) -> np.ndarray:
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f'{path}: {len(raw)} bytes of image data, expected '
                         f'{height * (stride + 1)}')
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            out[r] = line
        elif kind == 1:  # Sub: a running sum along the row, per channel, mod 256
            out[r] = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[r] = line + prev
        elif kind == 3:
            out[r] = np.frombuffer(_average(line.tolist(), prev.tolist(), bpp), np.uint8)
        elif kind == 4:
            out[r] = np.frombuffer(_paeth(line.tolist(), prev.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f'{path}: row {r} has filter type {kind}')
        prev = out[r]
    return out


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit gray (C 1), RGB (3) or RGBA (4)
    PNG without interlacing."""
    with open(path, 'rb') as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b'IHDR':
            header = _header(payload, path)
        elif kind == b'IDAT':
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f'{path}: no IHDR or no IDAT chunk')
    height, width, channels = header
    pixels = _unfilter(zlib.decompress(b''.join(idat)), height, width, channels, path)
    return pixels.reshape(height, width, channels)


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's ``convert('RGB')`` gives it: gray is
    repeated in the three channels, alpha dropped."""
    img = read_png(path)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 pixels as an RGB PNG, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_png: needs (H, W, 3) uint8, got {img.dtype} {img.shape}')
    height, width = img.shape[:2]
    raw = np.concatenate([np.zeros((height, 1), np.uint8), img.reshape(height, width * 3)],
                         axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack('>I', len(payload)) + kind + payload
                + struct.pack('>I', zlib.crc32(kind + payload)))

    with open(path, 'wb') as f:
        f.write(_SIGNATURE
                + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw.tobytes()))
                + chunk(b'IEND', b''))
