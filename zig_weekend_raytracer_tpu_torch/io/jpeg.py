"""Baseline JPEG output with numpy alone, at PIL's defaults: JFIF, quality
75 (the IJG scaling of the Annex K quantization tables), 4:2:0 chroma, the
Annex K Huffman tables.  The port needs no imaging package.

The encoder follows libjpeg's pipeline: RGB -> YCbCr (JFIF, rounded to
8-bit samples), the image edge-replicated to whole 16 x 16 MCUs, chroma
2 x 2 averaged with libjpeg's alternating rounding bias, a level shift of
128, the 8 x 8 DCT (orthonormal, in float64, where libjpeg's default is
an integer approximation, so the bytes differ from libjpeg's while the
image agrees to a level or two), quantization rounded half away from zero,
then DC differences and AC run lengths in zigzag order, Huffman coded with
0xFF bytes stuffed.
"""

from __future__ import annotations

import struct

import numpy as np

QUALITY = 75

# Annex K.1 quantization tables, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
])

# Annex K.3 Huffman tables: code counts per length 1..16, then the symbols
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _zigzag() -> np.ndarray:
    """Natural index of each zigzag position of an 8 x 8 block."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return np.array([r * 8 + c for r, c in order])


_ZIGZAG = _zigzag()


def quant_table(base: np.ndarray) -> np.ndarray:
    """The IJG scaling of an Annex K table to ``QUALITY`` (jcparam.c's
    200 - 2 q percent above q = 50): natural order."""
    return np.clip((base * (200 - 2 * QUALITY) + 50) // 100, 1, 255)


def _codes(table) -> dict:
    """{symbol: (code, length)} of a Huffman table (Annex C)."""
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return m


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) plane, H and W multiples of 8 -> (H/8, W/8, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _quantized(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level-shifted DCT of every 8 x 8 block of a sample plane, quantized
    by ``q`` and in zigzag order: (H/8, W/8, 64) int64."""
    coef = _DCT @ (_blocks(plane.astype(np.float64)) - 128.0) @ _DCT.T
    coef = coef.reshape(*coef.shape[:2], 64) / q
    return (np.sign(coef) * np.floor(np.abs(coef) + 0.5)).astype(np.int64)[..., _ZIGZAG]


def _magnitude(v: int):
    """(category, bits) of a coefficient: its bit length and its low bits
    in one's-complement form for negative values."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _entropy(mcus, dc_codes, ac_codes):
    """(values, lengths) of the scan's bit fields, block by block."""
    vals, lens = [], []
    pred = [0, 0, 0]
    for comp, block in mcus:
        dc, ac = dc_codes[comp], ac_codes[comp]
        s, bits = _magnitude(int(block[0]) - pred[comp])
        pred[comp] = int(block[0])
        vals += [dc[s][0], bits]
        lens += [dc[s][1], s]
        nz = np.flatnonzero(block[1:]) + 1
        last = 0
        for i in nz.tolist():
            run = i - last - 1
            while run > 15:
                vals.append(ac[0xF0][0])
                lens.append(ac[0xF0][1])
                run -= 16
            s, bits = _magnitude(int(block[i]))
            code, length = ac[(run << 4) | s]
            vals += [code, bits]
            lens += [length, s]
            last = i
        if last < 63:
            vals.append(ac[0x00][0])
            lens.append(ac[0x00][1])
    return np.array(vals, np.int64), np.array(lens, np.int64)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """The bit fields MSB first, padded with 1 bits to a byte, with a 0x00
    stuffed after every 0xFF."""
    total = int(lens.sum())
    owner = np.repeat(np.arange(lens.size), lens)
    pos = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = (vals[owner] >> (lens[owner] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _ycbcr(px: np.ndarray):
    """Rounded 8-bit JFIF Y, Cb, Cr planes of RGB pixels."""
    r, g, b = (px[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return [np.clip(np.floor(c + 0.5), 0, 255).astype(np.int64) for c in (y, cb, cr)]


def _downsample(plane: np.ndarray) -> np.ndarray:
    """2 x 2 average with libjpeg's bias, 1 and 2 in alternate columns."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias[None, :]) >> 2


def encode_jpeg(pixels_u8: np.ndarray) -> bytes:
    """The baseline JFIF file of (H, W, 3) RGB uint8 pixels."""
    px = np.asarray(pixels_u8)
    if px.dtype != np.uint8 or px.ndim != 3 or px.shape[2] != 3:
        raise ValueError(f"JPEG pixels must be (H, W, 3) uint8, got {px.shape} {px.dtype}")
    h, w, _ = px.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG dimensions must be 1..65535, got {w}x{h}")
    padded = np.pad(px, ((0, -h % 16), (0, -w % 16), (0, 0)), mode="edge")
    y, cb, cr = _ycbcr(padded)
    q = [quant_table(_Q_LUMA), quant_table(_Q_CHROMA)]
    qy = _quantized(y, q[0])                 # (H/8, W/8, 64)
    qcb = _quantized(_downsample(cb), q[1])  # (H/16, W/16, 64)
    qcr = _quantized(_downsample(cr), q[1])
    mh, mw = qcb.shape[:2]
    mcus = []
    for i in range(mh):
        for j in range(mw):
            mcus += [(0, qy[2 * i, 2 * j]), (0, qy[2 * i, 2 * j + 1]),
                     (0, qy[2 * i + 1, 2 * j]), (0, qy[2 * i + 1, 2 * j + 1]),
                     (1, qcb[i, j]), (2, qcr[i, j])]
    dc = [_codes(_DC_LUMA), _codes(_DC_CHROMA), _codes(_DC_CHROMA)]
    ac = [_codes(_AC_LUMA), _codes(_AC_CHROMA), _codes(_AC_CHROMA)]
    scan = _pack(*_entropy(mcus, dc, ac))

    dqt = b"".join(bytes([t]) + bytes(q[t][_ZIGZAG].astype(np.uint8)) for t in (0, 1))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([cls_id]) + bytes(counts) + bytes(symbols)
                   for cls_id, (counts, symbols) in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                                                     (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xFFE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
            + _segment(0xFFDB, dqt) + _segment(0xFFC0, sof) + _segment(0xFFC4, dht)
            + _segment(0xFFDA, sos) + scan + b"\xff\xd9")


def write_jpeg(path: str, pixels_u8: np.ndarray) -> None:
    """Write (H, W, 3) RGB uint8 pixels to ``path`` as a baseline JPEG."""
    data = encode_jpeg(pixels_u8)
    with open(path, "wb") as f:
        f.write(data)
