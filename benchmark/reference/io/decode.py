"""The reference's own image decoder: numpy and ``zlib``, written from the
standards, so that the benchmark checks a scene with image textures without
the program's native library.

``decode_image(path)`` gives (H, W, 3) uint8 texels for:

  * baseline JPEG (ITU-T T.81): SOF0 or SOF1, 8-bit, Huffman coded, one or
    three components, luma sampled 1x1, 2x1 or 2x2 with chroma at 1x1,
    restart intervals (DRI, RSTn); APPn and COM segments are skipped, and
    an EXIF orientation is ignored;
  * PNG: 8-bit grey, RGB or RGBA, not interlaced, every filter type
    (alpha is dropped);
  * binary PPM (P6) with maxval 255.

Anything else, a missing file included, raises ``ValueError`` naming the
file and what it lacks.

The JPEG texels equal stb_image v2.28's (the decoder the program and the
JAX package use), bit for bit, because the three stages that round follow
its fixed-point arithmetic: dequantisation into 16-bit coefficients and
the integer IDCT of ``stbi__idct_block`` (jidctint's ISLOW with stb's
rounding), the YCbCr -> RGB conversion of ``stbi__YCbCr_to_RGB_row``
(12-bit constants shifted by 8, Cb's green term masked to its high half),
and the chroma upsampling of ``stbi__resample_row_hv_2`` (the 3:1 triangle
filter in both axes) and ``stbi__resample_row_h_2`` (its 2x1 sibling,
last pair included).  The Huffman stage runs block by block in Python over
a table of every 16-bit window of the bit stream; the IDCT, the colour
conversion and the upsampling run over all blocks and rows at once.
"""

from __future__ import annotations

import array
import struct
import zlib

import numpy as np

# natural (row-major) index of each zigzag position; the 15 entries past
# 63 take a run that overshoots the block, as stb_image's table does
_DEZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 15

_SOF_BASELINE = (0xC0, 0xC1)
_SOF_NAMES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless", 0xCC: "arithmetic-coded (DAC)",
}
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}     # colour type -> samples a pixel


def decode_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 texels of the image file at ``path``; ``ValueError``
    names the file when it is missing or not a format decoded here."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ValueError(f"{path}: cannot read the image ({e.strerror})") from None
    if data[:2] == b"\xff\xd8":
        return _Jpeg(data, path).decode()
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(data, path)
    if data[:2] == b"P6":
        return _decode_ppm(data, path)
    raise ValueError(f"{path}: not a JPEG, PNG or binary PPM (P6) file")


# -- JPEG ---------------------------------------------------------------------


def _f2f(x: float) -> int:
    """stb_image's ``stbi__f2f``: a float constant as 12-bit fixed point."""
    return int(float(np.float32(x)) * 4096 + 0.5)


def _float2fixed(x: float) -> int:
    """``stbi__float2fixed``: the colour conversion's constants, rounded in
    float32, then shifted by 8."""
    f = np.float32(np.float32(x) * np.float32(4096.0)) + np.float32(0.5)
    return int(np.float32(f)) << 8


_C = {name: _f2f(x) for name, x in (
    ("c0541", 0.5411961), ("cm1847", -1.847759065), ("c0765", 0.765366865),
    ("c1175", 1.175875602), ("c0298", 0.298631336), ("c2053", 2.053119869),
    ("c3072", 3.072711026), ("c1501", 1.501321110), ("cm0899", -0.899976223),
    ("cm2562", -2.562915447), ("cm1961", -1.961570560), ("cm0390", -0.390180644),
)}
_CR_R, _CR_G = _float2fixed(1.40200), -_float2fixed(0.71414)
_CB_G, _CB_B = -_float2fixed(0.34414), _float2fixed(1.77200)


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7):
    """``STBI__IDCT_1D`` on int32 arrays: (x0, x1, x2, x3, t0, t1, t2, t3)."""
    c = _C
    p1 = (s2 + s6) * c["c0541"]
    t2 = p1 + s6 * c["cm1847"]
    t3 = p1 + s2 * c["c0765"]
    t0 = (s0 + s4) * 4096
    t1 = (s0 - s4) * 4096
    x0, x3, x1, x2 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    p3, p4, p1, p2 = s7 + s3, s5 + s1, s7 + s1, s5 + s3
    p5 = (p3 + p4) * c["c1175"]
    t0, t1, t2, t3 = s7 * c["c0298"], s5 * c["c2053"], s3 * c["c3072"], s1 * c["c1501"]
    p1 = p5 + p1 * c["cm0899"]
    p2 = p5 + p2 * c["cm2562"]
    p3 = p3 * c["cm1961"]
    p4 = p4 * c["cm0390"]
    return x0, x1, x2, x3, t0 + p1 + p3, t1 + p2 + p4, t2 + p2 + p3, t3 + p1 + p4


def _idct(coef: np.ndarray) -> np.ndarray:
    """``stbi__idct_block`` over (N, 8, 8) int32 dequantised coefficients
    (row-major): (N, 8, 8) uint8 samples.  Its shortcut for a column of
    zero AC terms gives what the full pass gives, so there is none here."""
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d(*(coef[:, k, :] for k in range(8)))
    x0, x1, x2, x3 = x0 + 512, x1 + 512, x2 + 512, x3 + 512
    cols = np.stack([x0 + t3, x1 + t2, x2 + t1, x3 + t0,
                     x3 - t0, x2 - t1, x1 - t2, x0 - t3], axis=1) >> 10
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d(*(cols[:, :, k] for k in range(8)))
    bias = 65536 + (128 << 17)
    x0, x1, x2, x3 = x0 + bias, x1 + bias, x2 + bias, x3 + bias
    rows = np.stack([x0 + t3, x1 + t2, x2 + t1, x3 + t0,
                     x3 - t0, x2 - t1, x1 - t2, x0 - t3], axis=2) >> 17
    return np.clip(rows, 0, 255).astype(np.uint8)


def _huffman(counts, symbols, what: str):
    """(code length, symbol) of every 16-bit window of the stream whose top
    bits are a code of this table, from its code counts by length (T.81
    Annex C); length 0 where no code matches."""
    length = np.zeros(1 << 16, np.int32)
    symbol = np.zeros(1 << 16, np.int32)
    code = k = 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi], symbol[lo:hi] = n, symbols[k]
            code, k = code + 1, k + 1
        if counts[n - 1] and code - 1 >= 1 << n:
            raise ValueError(f"{what}: bad Huffman code lengths")
        code <<= 1
    return length, symbol


def _dc_table(counts, symbols, what: str) -> list:
    """Per 16-bit window: (bits, DC difference) where the code and its
    magnitude bits fit in the window; (-code bits, magnitude size) where
    they do not; (0, 0) where no code matches."""
    length, t = _huffman(counts, symbols, what)
    w = np.arange(1 << 16, dtype=np.int64)
    tot = length + t
    fits = (length > 0) & (tot <= 16)
    tt = np.clip(t, 1, 16)
    m = (w >> np.clip(16 - tot, 0, 16)) & ((1 << tt) - 1)
    diff = np.where(t > 0, np.where(m < (1 << (tt - 1)), m - (1 << tt) + 1, m), 0)
    n = np.where(fits, tot, -length)
    v = np.where(fits, diff, t)
    return list(zip(n.tolist(), v.tolist()))


def _ac_table(counts, symbols, what: str) -> list:
    """Per 16-bit window: (bits, zero run, coefficient) where the code and
    its magnitude bits fit in the window; (-code bits, -1, 0) for an end of
    block (any symbol of size 0 but ZRL, as stb_image reads it), (-code
    bits, 16, 0) for a run of 16 zeros (ZRL), (-code bits, zero run,
    magnitude size) where the coefficient does not fit; (0, 0, 0) where no
    code matches."""
    length, rs = _huffman(counts, symbols, what)
    w = np.arange(1 << 16, dtype=np.int64)
    r, s = rs >> 4, rs & 15
    tot = length + s
    fits = (length > 0) & (s > 0) & (tot <= 16)
    ss = np.maximum(s, 1)
    m = (w >> np.clip(16 - tot, 0, 16)) & ((1 << ss) - 1)
    coef = np.where(m < (1 << (ss - 1)), m - (1 << ss) + 1, m)
    eob = (length > 0) & (s == 0) & (rs != 0xF0)
    zrl = (length > 0) & (rs == 0xF0)
    n = np.where(fits, tot, -length)
    run = np.where(fits, r, np.where(eob, -1, np.where(zrl, 16, r)))
    v = np.where(fits, coef, np.where(eob | zrl, 0, s))
    return list(zip(n.tolist(), run.tolist(), v.tolist()))


def _windows(segments: list):
    """The scan's entropy-coded segments (stuffing removed), each followed
    by zero bytes as stb_image reads past a marker: (every 16-bit window
    of the joined bit stream as an ``array('H')``, each segment's first
    bit)."""
    starts, parts, at = [], [], 0
    for seg in segments:
        starts.append(at * 8)
        parts.append(seg + b"\0\0\0\0")
        at += len(seg) + 4
    buf = b"".join(parts)
    b = np.frombuffer(buf + b"\0\0", np.uint8).astype(np.uint32)
    x = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    win = np.empty((len(buf), 8), np.uint16)
    for s in range(8):
        win[:, s] = (x >> (8 - s)) & 0xFFFF
    out = array.array("H")
    out.frombytes(win.tobytes())
    return out, starts


def _decode_block(win, pos, pred, dc, ac, base, idx, val):
    """One block's DC difference and AC terms (undequantised) into ``idx``
    (flat coefficient indices) and ``val``; returns (pos, DC predictor)."""
    n, v = dc[win[pos]]
    if n > 0:
        pos += n
    elif n < 0:
        pos -= n
        if v > 15:
            raise ValueError("bad DC magnitude")
        m = win[pos] >> (16 - v)
        pos += v
        v = m - (1 << v) + 1 if m < (1 << (v - 1)) else m
    else:
        raise ValueError("bad Huffman code")
    pred += v
    idx.append(base)
    val.append(pred)
    zz = _DEZIGZAG
    k = 1
    while k < 64:
        n, r, v = ac[win[pos]]
        if n > 0:
            pos += n
            k += r
            idx.append(base + zz[k])
            val.append(v)
            k += 1
        elif n < 0:
            pos -= n
            if r < 0:
                break
            if v == 0:
                k += 16
                continue
            k += r
            m = win[pos] >> (16 - v)
            pos += v
            idx.append(base + zz[k])
            val.append(m - (1 << v) + 1 if m < (1 << (v - 1)) else m)
            k += 1
        else:
            raise ValueError("bad Huffman code")
    return pos, pred


class _Jpeg:
    """One baseline JPEG file, decoded as stb_image decodes it."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        self.quant = {}
        self.dc, self.ac = {}, {}
        self.restart = 0
        self.jfif = False
        self.adobe_transform = -1
        self.frame = None

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def decode(self) -> np.ndarray:
        data, pos, scans = self.data, 2, 0
        while pos < len(data):
            if data[pos] != 0xFF:
                if scans:
                    break
                self.fail("expected a marker")
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                break
            m = data[pos]
            pos += 1
            if m == 0xD9:
                break
            if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
                continue
            if pos + 2 > len(data):
                self.fail("truncated segment")
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            body = data[pos + 2:pos + length]
            pos += length
            if m == 0xDA:
                pos = self.scan(body, pos)
                scans += 1
            elif m in _SOF_BASELINE:
                self.read_frame(body)
            elif m in _SOF_NAMES:
                self.fail(f"{_SOF_NAMES[m]} JPEG (marker 0x{m:02X}) is not decoded, only "
                          "baseline Huffman")
            elif m == 0xDB:
                self.read_quant(body)
            elif m == 0xC4:
                self.read_huffman(body)
            elif m == 0xDD:
                if len(body) != 2:
                    self.fail("bad DRI length")
                (self.restart,) = struct.unpack(">H", body)
            elif 0xE0 <= m <= 0xEF or m == 0xFE:
                if m == 0xE0 and body[:5] == b"JFIF\0":
                    self.jfif = True
                if m == 0xEE and len(body) >= 12 and body[:6] == b"Adobe\0":
                    self.adobe_transform = body[11]
            elif m != 0xDC:
                self.fail(f"unknown marker 0x{m:02X}")
        if not scans:
            self.fail("no scan")
        return self.assemble()

    def read_quant(self, body: bytes):
        at = 0
        while at < len(body):
            pq, tq = body[at] >> 4, body[at] & 15
            if pq > 1 or tq > 3:
                self.fail("bad DQT table")
            n = 128 if pq else 64
            raw = np.frombuffer(body[at + 1:at + 1 + n], ">u2" if pq else np.uint8)
            if raw.size != 64:
                self.fail("truncated DQT")
            table = np.zeros(64, np.int32)
            table[list(_DEZIGZAG[:64])] = raw
            self.quant[tq] = table
            at += 1 + n

    def read_huffman(self, body: bytes):
        at = 0
        while at < len(body):
            tc, th = body[at] >> 4, body[at] & 15
            if tc > 1 or th > 3:
                self.fail("bad DHT header")
            counts = body[at + 1:at + 17]
            n = sum(counts)
            if len(counts) != 16 or n > 256:
                self.fail("bad DHT header")
            symbols = body[at + 17:at + 17 + n]
            if tc == 0:
                self.dc[th] = _dc_table(counts, symbols, self.path)
            else:
                self.ac[th] = _ac_table(counts, symbols, self.path)
            at += 17 + n

    def read_frame(self, body: bytes):
        if self.frame is not None:
            self.fail("two frames")
        p, height, width, nc = struct.unpack(">BHHB", body[:6])
        if p != 8:
            self.fail(f"{p}-bit JPEG is not decoded, only 8-bit")
        if height == 0 or width == 0:
            self.fail("no header height or width")
        if nc == 4:
            self.fail("4-component (CMYK or YCCK) JPEG is not decoded")
        if nc not in (1, 3) or len(body) != 6 + 3 * nc:
            self.fail(f"bad component count {nc}")
        comps = []
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        h_max = max(c["h"] for c in comps)
        v_max = max(c["v"] for c in comps)
        for i, c in enumerate(comps):
            hs, vs = h_max // c["h"], v_max // c["v"]
            if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4) or (hs, vs) not in (
                    (1, 1), (2, 1), (2, 2)) or h_max % c["h"] or v_max % c["v"]:
                self.fail(f"sampling {c['h']}x{c['v']} of component {i} against "
                          f"{h_max}x{v_max} is not decoded (luma 1x1, 2x1 or 2x2, chroma 1x1)")
            c["hs"], c["vs"] = hs, vs
        mcu_x = -(-width // (8 * h_max))
        mcu_y = -(-height // (8 * v_max))
        for c in comps:
            c["x"] = -(-width * c["h"] // h_max)
            c["y"] = -(-height * c["v"] // v_max)
            c["bw"], c["bh"] = mcu_x * c["h"], mcu_y * c["v"]
            c["idx"], c["val"] = [], []
        self.frame = {"width": width, "height": height, "mcu_x": mcu_x, "mcu_y": mcu_y,
                      "comps": comps, "rgb": nc == 3 and [c["id"] for c in comps] == [82, 71, 66]}

    def segments(self, pos: int):
        """The entropy-coded data from ``pos``: (its segments between RSTn
        markers, fill bytes and stuffing removed; where the next marker
        starts)."""
        data = self.data
        segs, start, i = [], pos, pos
        while True:
            j = data.find(b"\xff", i)
            if j < 0 or j + 1 >= len(data):
                segs.append(data[start:])
                return [s.rstrip(b"\xff").replace(b"\xff\x00", b"\xff") for s in segs], len(data)
            nxt = data[j + 1]
            if nxt == 0x00 or nxt == 0xFF:
                i = j + 1 + (nxt == 0)
                continue
            segs.append(data[start:j])
            if 0xD0 <= nxt <= 0xD7:
                start = i = j + 2
                continue
            return [s.rstrip(b"\xff").replace(b"\xff\x00", b"\xff") for s in segs], j

    def scan(self, body: bytes, pos: int) -> int:
        if self.frame is None:
            self.fail("scan before the frame header")
        comps = self.frame["comps"]
        ns = body[0] if body else 0
        if not 1 <= ns <= len(comps) or len(body) != 4 + 2 * ns:
            self.fail("bad SOS")
        in_scan = []
        for i in range(ns):
            cid, tables = body[1 + 2 * i], body[2 + 2 * i]
            which = next((c for c in comps if c["id"] == cid), None)
            if which is None:
                self.fail(f"scan names no component {cid}")
            try:
                dc, ac, q = self.dc[tables >> 4], self.ac[tables & 15], self.quant[which["tq"]]
            except KeyError as e:
                self.fail(f"scan uses an undefined table {e}")
            which["q"] = q
            in_scan.append((which, dc, ac))
        ss, _, ahal = body[1 + 2 * ns:4 + 2 * ns]
        if ss != 0 or ahal != 0:
            self.fail("bad SOS spectral selection for a baseline scan")
        segs, end = self.segments(pos)
        win, starts = _windows(segs)
        # a unit is an MCU, or in a scan of one component one block; each
        # block is (component in the scan, tables, its coefficient lists,
        # its index in the component's grid)
        if ns == 1:
            c, dc, ac = in_scan[0]
            units = [[(0, dc, ac, c["idx"], c["val"], r * c["bw"] + col)]
                     for r in range(-(-c["y"] // 8)) for col in range(-(-c["x"] // 8))]
        else:
            units = []
            for my in range(self.frame["mcu_y"]):
                for mx in range(self.frame["mcu_x"]):
                    units.append([(k, dc, ac, c["idx"], c["val"],
                                   (my * c["v"] + by) * c["bw"] + mx * c["h"] + bx)
                                  for k, (c, dc, ac) in enumerate(in_scan)
                                  for by in range(c["v"]) for bx in range(c["h"])])
        every = self.restart or len(units)
        if (len(units) - 1) // every >= len(starts):
            self.fail(f"{len(starts) - 1} restart markers where {(len(units) - 1) // every} "
                      "are due")
        bit, seg, preds = starts[0], 0, [0] * ns
        try:
            for u, blocks in enumerate(units):
                if u and u % every == 0:
                    seg += 1
                    bit, preds = starts[seg], [0] * ns
                for k, dc, ac, idx, val, b in blocks:
                    bit, preds[k] = _decode_block(win, bit, preds[k], dc, ac, b * 64, idx, val)
        except (ValueError, IndexError) as e:
            self.fail(f"corrupt entropy-coded data ({e})")
        return end

    def plane(self, c) -> np.ndarray:
        """A component's samples, (bh * 8, bw * 8) uint8."""
        n = c["bh"] * c["bw"]
        coef = np.zeros(n * 64, np.int32)
        if c["idx"]:
            coef[np.asarray(c["idx"], np.int64)] = np.asarray(c["val"], np.int64).astype(np.int32)
        q = c.get("q", np.ones(64, np.int32))
        coef = (coef.reshape(n, 64) * q).astype(np.int16).astype(np.int32)
        blocks = _idct(coef.reshape(n, 8, 8))
        return blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)

    def upsampled(self, c) -> np.ndarray:
        """A component at the image's size, as stb_image's row resamplers
        give it: (height, width) int32."""
        width, height = self.frame["width"], self.frame["height"]
        p = self.plane(c).astype(np.int32)
        hs, vs = c["hs"], c["vs"]
        w = -(-width // hs)
        j = np.arange(height)
        if vs == 1:
            near = p[np.minimum(j, c["y"] - 1), :w]
        else:
            m = j // 2
            far = np.clip(np.where(j % 2 == 0, m - 1, m + 1), 0, c["y"] - 1)
            near = 3 * p[m, :w] + p[far, :w]          # t of resample_row_hv_2
        if hs == 1:
            return near[:, :width]
        out = np.empty((height, 2 * w), np.int32)
        if vs == 2:
            t = near
            if w == 1:
                out[:, 0] = out[:, 1] = (t[:, 0] + 2) >> 2
            else:
                out[:, 0] = (t[:, 0] + 2) >> 2
                out[:, 1:2 * w - 1:2] = (3 * t[:, :-1] + t[:, 1:] + 8) >> 4
                out[:, 2:2 * w - 1:2] = (3 * t[:, 1:] + t[:, :-1] + 8) >> 4
                out[:, 2 * w - 1] = (t[:, w - 1] + 2) >> 2
        else:
            x = near
            if w == 1:
                out[:, 0] = out[:, 1] = x[:, 0]
            else:
                out[:, 0] = x[:, 0]
                out[:, 1] = (3 * x[:, 0] + x[:, 1] + 2) >> 2
                n = 3 * x[:, 1:w - 1] + 2
                out[:, 2:2 * w - 2:2] = (n + x[:, :w - 2]) >> 2
                out[:, 3:2 * w - 2:2] = (n + x[:, 2:w]) >> 2
                # stb_image weights the last pair's first sample towards
                # the left neighbour
                out[:, 2 * w - 2] = (3 * x[:, w - 2] + x[:, w - 1] + 2) >> 2
                out[:, 2 * w - 1] = x[:, w - 1]
        return out[:, :width]

    def assemble(self) -> np.ndarray:
        comps = self.frame["comps"]
        chans = [self.upsampled(c) for c in comps]
        if len(chans) == 1:
            return np.repeat(chans[0].astype(np.uint8)[:, :, None], 3, axis=2)
        if self.frame["rgb"] or (self.adobe_transform == 0 and not self.jfif):
            return np.stack(chans, axis=2).astype(np.uint8)
        y, cb, cr = chans
        y_fixed = (y << 20) + (1 << 19)
        cr, cb = cr - 128, cb - 128
        r = (y_fixed + cr * _CR_R) >> 20
        g = (y_fixed + cr * _CR_G + ((cb * _CB_G) & -65536)) >> 20
        b = (y_fixed + cb * _CB_B) >> 20
        return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


# -- PNG ----------------------------------------------------------------------


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9): (height, width, bpp)
    uint8.  A sample depends on its left, upper and upper-left neighbours,
    so the pixels of each anti-diagonal are reconstructed together."""
    rows = raw.reshape(height, 1 + width * bpp)
    ftype = rows[:, 0].astype(np.int32)
    if int(ftype.max()) > 4:
        raise ValueError(f"{path}: PNG filter type {int(ftype.max())} is not defined")
    filt = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    # one row and one column of zeros above and left of the image
    out = np.zeros((height + 1, width + 1, bpp), np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height, d + 1))
        x = d - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _decode_png(data: bytes, path: str) -> np.ndarray:
    at, header, idat = 8, None, []
    while at + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + length]
        at += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not decoded, only 8-bit")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not decoded")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not decoded, only grey, RGB "
                         "or RGBA")
    bpp = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from None
    need = height * (1 + width * bpp)
    if len(raw) < need:
        raise ValueError(f"{path}: PNG data short of its {width}x{height} pixels")
    px = _unfilter(np.frombuffer(raw[:need], np.uint8), height, width, bpp, path)
    if bpp == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


# -- PPM ----------------------------------------------------------------------


def _decode_ppm(data: bytes, path: str) -> np.ndarray:
    at, fields = 2, []
    while len(fields) < 3:
        while at < len(data) and (data[at:at + 1].isspace() or data[at] == ord("#")):
            if data[at] == ord("#"):
                while at < len(data) and data[at] not in b"\r\n":
                    at += 1
            else:
                at += 1
        start = at
        while at < len(data) and data[at:at + 1].isdigit():
            at += 1
        if start == at:
            raise ValueError(f"{path}: bad PPM header")
        fields.append(int(data[start:at]))
    width, height, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval} is not decoded, only 255")
    at += 1                      # the one whitespace byte before the pixels
    n = width * height * 3
    if len(data) - at < n:
        raise ValueError(f"{path}: PPM data short of its {width}x{height} pixels")
    return np.frombuffer(data[at:at + n], np.uint8).reshape(height, width, 3).copy()
