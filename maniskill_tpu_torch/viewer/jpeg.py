"""Baseline JPEG encoder in numpy (the viewer's stand-in for Pillow, which
the card's machine lacks).

Sequential DCT, 8-bit, Huffman-coded, no chroma subsampling (4:4:4), as
ITU-T T.81 describes: JFIF YCbCr, the Annex K quantization tables scaled by
``quality`` as libjpeg scales them, and the Annex K Huffman tables. Every
stage but the header is vectorized over the blocks; the entropy coder packs
one item per coefficient (its run of zeros, Huffman code and extra bits
merged into one uint64) and writes the bits with numpy.
"""
from __future__ import annotations

import struct

import numpy as np

# Annex K.1, natural (row-major) order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA_QUANT = np.full(64, 99, np.int64).reshape(8, 8)
CHROMA_QUANT[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
CHROMA_QUANT = CHROMA_QUANT.reshape(64)

# Annex K.3: code counts per length 1..16, then the symbols in code order
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])

# ZIGZAG[k]: the natural index of the k-th coefficient in zigzag order
ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))

_x = np.arange(8)
DCT = np.sqrt(np.where(_x[:, None] == 0, 1 / 8, 2 / 8)) * np.cos((2 * _x[None, :] + 1) * _x[:, None] * np.pi / 16)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """An Annex K table scaled by ``quality`` (1-100) as libjpeg scales it."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def huffman_codes(table):
    """(code, length) per symbol (256 entries) of an Annex C canonical table."""
    bits, vals = table
    code_of = np.zeros(256, np.uint64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_CODES = {name: huffman_codes(t) for name, t in
          (("dc0", DC_LUMA), ("dc1", DC_CHROMA), ("ac0", AC_LUMA), ("ac1", AC_CHROMA))}


def _size(v: np.ndarray) -> np.ndarray:
    """Magnitude category: the bit length of |v|."""
    a = np.abs(v)
    return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1)


def _extra(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The category's extra bits: v, or v - 1 in ``size`` bits when negative."""
    return np.where(v < 0, v + (np.int64(1) << size) - 1, v).astype(np.uint64)


def _blocks(rgb: np.ndarray):
    """(3, nblocks, 64) zigzag DCT input blocks, Y, Cb, Cr, level-shifted."""
    H, W = rgb.shape[:2]
    Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
    img = np.pad(rgb.astype(np.float64), ((0, Hp - H), (0, Wp - W), (0, 0)), mode="edge")
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    ycc = np.stack([
        0.299 * r + 0.587 * g + 0.114 * b - 128.0,
        -0.168736 * r - 0.331264 * g + 0.5 * b,
        0.5 * r - 0.418688 * g - 0.081312 * b,
    ])
    blocks = ycc.reshape(3, Hp // 8, 8, Wp // 8, 8).transpose(0, 1, 3, 2, 4).reshape(3, -1, 8, 8)
    return np.einsum("ux,cnxy,vy->cnuv", DCT, blocks, DCT).reshape(3, -1, 64)


def _entropy_items(q: np.ndarray, comp: int):
    """Items (value uint64, bit length, block, order) of one component's
    quantized zigzag blocks q (N, 64): the DC difference, each nonzero AC
    coefficient with its ZRL codes before it, and EOB where the block ends
    in zeros."""
    ch = "0" if comp == 0 else "1"
    dc_code, dc_len = _CODES["dc" + ch]
    ac_code, ac_len = _CODES["ac" + ch]
    N = q.shape[0]
    diff = np.diff(q[:, 0], prepend=0)
    s = _size(diff)
    dc_val = (dc_code[s] << s.astype(np.uint64)) | (_extra(diff, s) & ((np.uint64(1) << s.astype(np.uint64)) - 1))
    items = [(dc_val, dc_len[s] + s, np.arange(N), np.zeros(N, np.int64))]

    blk, k = np.nonzero(q[:, 1:] != 0)
    k = k + 1
    if len(k):
        first = np.r_[True, blk[1:] != blk[:-1]]
        prev = np.where(first, 0, np.r_[0, k[:-1]])
        run = k - prev - 1
        zrl, r = run // 16, run % 16
        v = q[blk, k]
        s = _size(v)
        sym = (r << 4) | s
        zc, zl = ac_code[0xF0], ac_len[0xF0]
        val = np.zeros(len(k), np.uint64)
        length = np.zeros(len(k), np.int64)
        for i in range(3):  # at most 62 // 16 = 3 ZRL codes before a coefficient
            has = zrl > i
            val = np.where(has, (val << np.uint64(zl)) | zc, val)
            length = length + np.where(has, zl, 0)
        su = s.astype(np.uint64)
        val = (((val << ac_len[sym].astype(np.uint64)) | ac_code[sym]) << su) | (_extra(v, s) & ((np.uint64(1) << su) - 1))
        items.append((val, length + ac_len[sym] + s, blk, k))
    last = np.zeros(N, np.int64)
    if len(k):
        np.maximum.at(last, blk, k)
    eob = np.nonzero(last < 63)[0]
    items.append((np.full(len(eob), ac_code[0x00], np.uint64), np.full(len(eob), ac_len[0x00]), eob,
                  np.full(len(eob), 64)))
    return items


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The items' bits, most significant first, padded with 1 bits to a byte,
    with a 0x00 stuffed after every 0xFF."""
    total = int(lengths.sum())
    nbytes = -(-total // 8)
    bits = np.ones(nbytes * 8, np.uint8)
    start = np.cumsum(lengths) - lengths
    for j in range(int(lengths.max(initial=0))):
        m = lengths > j
        shift = (lengths[m] - 1 - j).astype(np.uint64)
        bits[start[m] + j] = ((values[m] >> shift) & np.uint64(1)).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    """An (H, W, 3) uint8 image as baseline JFIF JPEG bytes."""
    rgb = np.asarray(rgb, np.uint8)
    H, W = rgb.shape[:2]
    tables = [quant_table(LUMA_QUANT, quality), quant_table(CHROMA_QUANT, quality)]
    coef = _blocks(rgb)
    values, lengths, order = [], [], []
    for c in range(3):
        qt = tables[0 if c == 0 else 1].astype(np.float64)
        q = np.round(coef[c] / qt[None]).astype(np.int64)[:, ZIGZAG]
        for val, length, blk, pos in _entropy_items(q, c):
            values.append(val)
            lengths.append(length)
            # blocks interleave Y, Cb, Cr per MCU; inside a block by position
            order.append((blk * 3 + c) * 128 + pos)
    order = np.argsort(np.concatenate(order), kind="stable")
    data = _pack(np.concatenate(values)[order], np.concatenate(lengths)[order])

    out = [b"\xff\xd8", _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(tables):
        out.append(_segment(0xFFDB, bytes([i]) + t[ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 3) + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, (bits, vals) in ((0x00, DC_LUMA), (0x10, AC_LUMA), (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        out.append(_segment(0xFFC4, bytes([cls_id]) + bytes(bits) + bytes(vals)))
    out.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)
