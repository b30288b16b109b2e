"""PNG tests: quantization (raytrace.rs:1460-1478 `(c*255.) as u8`
semantics) and the zlib + struct codec."""

import hashlib
import os
import struct
import zlib

import numpy as np
import pytest

from rust_raytrace_tpu.utils.png import quantize_u8, read_png, rmse, write_png


def test_quantize_truncates():
    img = np.asarray([[[0.0, 0.5, 1.0]]], dtype=np.float32)
    q = quantize_u8(img)
    # 0.5*255 = 127.5 -> truncates to 127 (Rust `as u8` rounds toward zero)
    assert list(q[0, 0]) == [0, 127, 255]


def test_quantize_saturates_and_nan():
    img = np.asarray([[[-0.5, 2.0, np.nan]]], dtype=np.float32)
    q = quantize_u8(img)
    assert list(q[0, 0]) == [0, 255, 0]


def test_quantize_matches_rust_cast_grid():
    # Rust `as u8`: trunc toward zero with saturation, across the whole range
    vals = np.linspace(-0.1, 1.1, 1000).astype(np.float32)
    q = quantize_u8(vals.reshape(-1, 1, 1))
    expect = np.clip(np.trunc(vals.astype(np.float64) * 255), 0, 255)
    np.testing.assert_array_equal(q.reshape(-1), expect.astype(np.uint8))


def test_write_read_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((7, 5, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(back, quantize_u8(img))


def test_rmse():
    a = np.zeros((4, 4, 3), dtype=np.float32)
    b = np.full((4, 4, 3), 0.1, dtype=np.float32)
    assert abs(rmse(a, b) - 0.1) < 1e-7
    assert rmse(a, a) == 0.0
    # u8 inputs are scaled to [0,1]
    au8 = np.zeros((2, 2, 3), dtype=np.uint8)
    bu8 = np.full((2, 2, 3), 255, dtype=np.uint8)
    assert abs(rmse(au8, bu8) - 1.0) < 1e-9


#: sha256 of the decoded RGB bytes of each committed golden (cross-checked
#: against an independent PNG decoder when the goldens were committed)
GOLDEN_SHA256 = {
    "circles_96x54.png":
        "8ac975e41f08cb2262b58dce062649ca341527c447cfa0e52f81106a94e6fc8e",
    "multi_64x36.png":
        "6559b8350eda671596e597f0de41d78e67019009fdf5e37b3fa50a484a178475",
    "teapot_96x54.png":
        "1ef386cef94aa6867f87ab9173169ceace4015187bb01f0ec26f1109747af75f",
}


@pytest.mark.parametrize("name", sorted(GOLDEN_SHA256))
def test_golden_decodes_byte_for_byte(name):
    path = os.path.join(os.path.dirname(__file__), "goldens", name)
    img = read_png(path)
    w, h = (int(v) for v in name[:-4].split("_")[-1].split("x"))
    assert img.shape == (h, w, 3) and img.dtype == np.uint8
    assert hashlib.sha256(img.tobytes()).hexdigest() == GOLDEN_SHA256[name]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(path, px, ctype, filters, palette=None):
    """Reference encoder: [h, w, ch] u8 with row filter filters[y % n],
    written byte by byte from the PNG specification's definitions."""
    h, w, ch = px.shape
    raw = bytearray()
    prev = [0] * (w * ch)
    for y in range(h):
        line = px[y].reshape(-1).astype(int).tolist()
        kind = filters[y % len(filters)]
        out = []
        for x, v in enumerate(line):
            a = line[x - ch] if x >= ch else 0
            b = prev[x]
            c = prev[x - ch] if x >= ch else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][kind]
            out.append((v - pred) & 0xFF)
        raw += bytes([kind] + out)
        prev = line

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    comp = zlib.compress(bytes(raw))
    half = len(comp) // 2                      # two IDAT chunks
    body += chunk(b"IDAT", comp[:half]) + chunk(b"IDAT", comp[half:])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_read_every_filter_and_colour_type(tmp_path, ctype):
    rng = np.random.default_rng(ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = rng.integers(0, 256, (9, 7, ch), dtype=np.uint8)
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    p = str(tmp_path / "f.png")
    _encode(p, px, ctype, filters=[0, 1, 2, 3, 4], palette=palette)
    got = read_png(p)
    if ctype == 3:
        want = palette[px[..., 0]]
    elif ch <= 2:
        want = np.repeat(px[..., :1], 3, axis=2)
    else:
        want = px[..., :3]
    np.testing.assert_array_equal(got, want)


def test_writer_output_is_standard_png(tmp_path):
    """The writer's file parses by the specification: signature, IHDR for
    8-bit RGB, filter-0 rows that inflate to the quantized pixels."""
    img = np.random.default_rng(1).random((4, 6, 3)).astype(np.float32)
    p = tmp_path / "w.png"
    write_png(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    n, kind = struct.unpack(">I4s", data[8:16])
    assert kind == b"IHDR" and n == 13
    assert struct.unpack(">IIBBBBB", data[16:29]) == (6, 4, 8, 2, 0, 0, 0)
    pos = 8 + 12 + 13
    n, kind = struct.unpack(">I4s", data[pos:pos + 8])
    assert kind == b"IDAT"
    rows = np.frombuffer(zlib.decompress(data[pos + 8:pos + 8 + n]),
                         np.uint8).reshape(4, 1 + 18)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(4, 6, 3),
                                  quantize_u8(img))


def test_read_rejects_corrupt_files(tmp_path):
    p = tmp_path / "bad.png"
    write_png(str(p), np.zeros((2, 2, 3), np.float32))
    data = bytearray(p.read_bytes())
    data[20] ^= 1                               # inside IHDR: CRC breaks
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(p))
    p.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(p))
