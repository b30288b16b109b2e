"""PNG output with the reference's exact quantization, in the standard library.

`write_png` (raytrace_lib/src/raytrace.rs:1460-1478) emits 8-bit RGB with NO
gamma correction and quantizes with Rust's `(c * 255.) as u8` cast, which
truncates toward zero, saturates to [0, 255], and maps NaN to 0.  Golden-image
comparisons depend on reproducing that exact mapping.

The codec is zlib + struct (PNG specification, ISO/IEC 15948): the writer
emits one IDAT of unfiltered 8-bit RGB rows; the reader takes 8-bit
greyscale, RGB, palette, grey+alpha and RGBA images, non-interlaced, with
any of the five row filters, and returns RGB.
"""

import struct
import zlib

import numpy as np

__all__ = ["quantize_u8", "write_png", "read_png", "rmse"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples per pixel for each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def quantize_u8(img: np.ndarray) -> np.ndarray:
    """f32 [0,1] colors -> u8 via Rust `as u8` semantics (trunc/saturate/NaN->0).

    u8 input passes through unchanged (already quantized, e.g. on device)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    x = img.astype(np.float32) * np.float32(255.0)
    x = np.nan_to_num(x, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(np.trunc(x), 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float colors to an 8-bit RGB PNG (raytrace.rs:1460-1478)."""
    rgb = quantize_u8(img)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),       # filter 0
                           rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of an
    8-bit image with bpp bytes per pixel; returns [h, w, bpp] u8."""
    data = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)
    out = np.zeros((h, w, bpp), np.uint8)
    prev = np.zeros((w, bpp), np.int32)
    for y in range(h):
        kind = data[y, 0]
        line = data[y, 1:].astype(np.int32).reshape(w, bpp)
        if kind == 0:
            cur = line
        elif kind == 1:                     # Sub: running sum along the row
            cur = np.cumsum(line, axis=0) & 0xFF
        elif kind == 2:                     # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):                # Average, Paeth: left to right
            cur = np.zeros((w, bpp), np.int32)
            left = upleft = np.zeros(bpp, np.int32)
            for x in range(w):
                up = prev[x]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                cur[x] = (line[x] + pred) & 0xFF
                left, upleft = cur[x], up
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG as u8 [H, W, 3] (dropping alpha if present)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(_SIGNATURE), None, None, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return palette[px[..., 0]]
    if ch <= 2:                                   # greyscale (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE between two images in [0,1] color space (u8 inputs are scaled)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype == np.uint8:
        a = a.astype(np.float64) / 255.0
    if b.dtype == np.uint8:
        b = b.astype(np.float64) / 255.0
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))
