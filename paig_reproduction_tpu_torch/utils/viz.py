"""Image files of the run artifacts, written with numpy alone.

Counterpart of ``paig_reproduction_tpu/utils/viz.py``, which writes GIFs
through PIL and leaves JPEGs to matplotlib; neither is needed here:

* ``gallery`` tiles frames exactly as the JAX package's does.
* ``gif`` writes an animated GIF89a: a fixed 6x6x6 colour cube as the
  palette (levels 0, 51, ..., 255, so each channel lands within 25.5 of
  its value) and LZW-coded frames, with the JAX package's ``fps`` and
  ``scale`` semantics.
* ``write_jpeg`` writes a baseline JPEG: YCbCr at 4:4:4 (or one grey
  component), the 8x8 DCT as a matrix product, the Annex K quantisation
  tables scaled to quality ``JPEG_QUALITY`` = 90 as the IJG library scales
  them, zig-zag order, the Annex K Huffman tables and byte stuffing.
* ``save_image`` writes a composite in [0, 1] as the JAX package's figures
  show it (values clipped to [0, 1], grey kept grey), upscaled by
  nearest neighbour at the integer factor ``IMAGE_SCALE`` = 3.
"""
from __future__ import annotations

import os
import struct

import numpy as np

# Nearest-neighbour upscale of a saved composite: a 32-px frame becomes
# 96 px, about the size at which the JAX package's figures draw it.
IMAGE_SCALE = 3
JPEG_QUALITY = 90


def gallery(array, ncols=3):
    """Tile an image sequence [N, H, W, C] row-major into an
    (N//ncols)-row grid, each tile framed by a 1-px 0.5-gray border."""
    array = np.asarray(array)
    n = array.shape[0]
    if n % ncols:
        raise ValueError(f"{n} images do not fill rows of {ncols}")
    framed = np.pad(array, ((0, 0), (1, 1), (1, 1), (0, 0)),
                    constant_values=0.5)
    _, th, tw, c = framed.shape
    grid = framed.reshape(n // ncols, ncols, th, tw, c)
    return grid.transpose(0, 2, 1, 3, 4).reshape(
        (n // ncols) * th, ncols * tw, c)


def _resize_nearest(img, out_h, out_w):
    """PIL's NEAREST resize: output pixel i reads input floor((i + 0.5) *
    in / out)."""
    h, w = img.shape[:2]
    rows = np.minimum(((np.arange(out_h) + 0.5) * h / out_h).astype(int),
                      h - 1)
    cols = np.minimum(((np.arange(out_w) + 0.5) * w / out_w).astype(int),
                      w - 1)
    return img[rows][:, cols]


# ----- GIF ---------------------------------------------------------------------
_CUBE = 6
_STEP = 255 // (_CUBE - 1)


def _palette() -> bytes:
    levels = np.arange(_CUBE) * _STEP
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    table = np.zeros((256, 3), np.uint8)
    table[:_CUBE ** 3] = np.stack([r, g, b], -1).reshape(-1, 3)
    return table.tobytes()


# Bits of a palette index, the LZW code's minimum code size.
_MIN_CODE_SIZE = 8


def _lzw(indices: bytes) -> bytes:
    """GIF's variable-width LZW code of a frame's palette indices, packed
    least significant bit first."""
    clear = 1 << _MIN_CODE_SIZE
    end = clear + 1
    out = bytearray()
    acc = nbits = 0
    width = _MIN_CODE_SIZE + 1
    table = {}
    next_code = end + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # The decoder adds this entry only when it reads the next
            # code, so it widens one code later than the table grows.
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table.clear()
            next_code = end + 1
            width = _MIN_CODE_SIZE + 1
        prefix = k
    emit(prefix)
    # The decoder adds an entry after the last code too, before it reads
    # the end code.
    if next_code < 4096 and next_code + 1 > (1 << width) and width < 12:
        width += 1
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def gif(filename, array, fps=10, scale=1.0):
    """Write an animated gif from [T, H, W, (C)] frames in 0..255 (clipped,
    then truncated to integers); ``scale`` resizes by nearest neighbour and
    each frame shows for ``int(1000 / fps)`` ms, looping forever. Returns
    the path written (its extension made ``.gif``)."""
    filename = os.path.splitext(filename)[0] + ".gif"
    array = np.asarray(array)
    if array.ndim == 3:
        array = array[..., np.newaxis] * np.ones(3)
    array = np.clip(array, 0, 255).astype(np.uint8)
    _, h, w, _ = array.shape
    if scale != 1.0:
        h, w = int(h * scale), int(w * scale)
    delay_cs = max(1, int(1000 / fps)) // 10
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _palette(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
             + b"\x00"]
    for frame in array:
        if frame.shape[:2] != (h, w):
            frame = _resize_nearest(frame, h, w)
        q = (frame[..., :3].astype(np.int32) + _STEP // 2) // _STEP
        idx = (q[..., 0] * _CUBE + q[..., 1]) * _CUBE + q[..., 2]
        parts += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs)
                  + b"\x00\x00",
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                  bytes([_MIN_CODE_SIZE])
                  + _sub_blocks(_lzw(idx.astype(np.uint8).tobytes()))]
    parts.append(b"\x3b")
    with open(filename, "wb") as f:
        f.write(b"".join(parts))
    return filename


# ----- JPEG --------------------------------------------------------------------
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                   [24, 26, 56, 99], [47, 66, 99, 99]]

# Natural (row-major) index of each zig-zag position: anti-diagonals in
# turn, even ones read upwards, odd ones downwards.
_ZIGZAG = np.array(sorted(
    range(64), key=lambda i: (i // 8 + i % 8,
                              i % 8 if (i // 8 + i % 8) % 2 == 0
                              else i // 8)))

# Annex K.3 Huffman tables: code counts by length 1..16, then symbols.
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
              tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    d[0] /= np.sqrt(2)
    return d


_DCT = _dct_matrix()


def _quant_table(base):
    """IJG scaling of an Annex K table to ``JPEG_QUALITY``."""
    q = JPEG_QUALITY
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table):
    """(code, length) by symbol of a table given as (counts, symbols)."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _bit_length(v):
    """JPEG's size category of each |v|: its number of bits."""
    return np.frexp(np.abs(v))[1].astype(np.int64)


def _amplitude(v, size):
    """The size-bit pattern of v: v itself, or v - 1 in ones' complement
    for a negative v."""
    return np.where(v >= 0, v, v + (1 << size) - 1).astype(np.int64)


def _entropy_code(coefs, comp, tables):
    """Huffman-code zig-zag blocks [n, 64] of int in scan order; ``comp``
    is each block's component, and component 0 codes with ``tables[0]``,
    the others with ``tables[1]``. Returns the byte-stuffed scan data."""
    n = coefs.shape[0]
    classes = np.minimum(comp, 1)
    dc_codes = [_huffman_codes(t[0]) for t in tables]
    ac_codes = [_huffman_codes(t[1]) for t in tables]
    values, lengths, keys = [], [], []

    def add(block, slot, cls, symbol, extra, extra_len, codes):
        code = np.choose(cls, [c[0][symbol] for c in codes])
        length = np.choose(cls, [c[1][symbol] for c in codes])
        values.append((code << extra_len) | extra)
        lengths.append(length + extra_len)
        keys.append(block * 128 + slot)

    # DC: the difference to the previous block of the same component.
    dc = coefs[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = comp == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    size = _bit_length(diff)
    blocks = np.arange(n)
    add(blocks, 0, classes, size, _amplitude(diff, size), size, dc_codes)

    # AC: (run, size) symbols, a ZRL for every 16 zeros of a longer run,
    # and an EOB after the last non-zero coefficient unless it is the 63rd.
    ac = coefs[:, 1:].astype(np.int64)
    b, k = np.nonzero(ac)
    k = k + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    v = ac[b, k - 1]
    size = _bit_length(v)
    add(b, 2 * k, classes[b], (run % 16) * 16 + size, _amplitude(v, size),
        size, ac_codes)
    zrl = np.repeat(np.arange(len(b)), run // 16)
    zero = np.zeros(len(zrl), np.int64)
    add(b[zrl], 2 * k[zrl] - 1, classes[b[zrl]], zero + 0xF0, zero, zero,
        ac_codes)
    last = np.zeros(n, np.int64)
    last[b] = k
    eob = np.nonzero(last < 63)[0]
    zero = np.zeros(len(eob), np.int64)
    add(eob, 127, classes[eob], zero, zero, zero, ac_codes)

    order = np.argsort(np.concatenate(keys), kind="stable")
    values = np.concatenate(values)[order]
    lengths = np.concatenate(lengths)[order]
    # Pack MSB first: each code (at most 27 bits) is aligned in a 40-bit
    # window at its byte and added there byte by byte; codes never share a
    # bit, so adding is OR-ing. The tail is padded with 1 bits.
    start = np.cumsum(lengths) - lengths
    total = int(start[-1] + lengths[-1])
    window = values << (40 - start % 8 - lengths)
    first = start // 8
    nbytes = -(-total // 8)
    data = np.zeros(nbytes + 5, np.int64)
    for j in range(5):
        data += np.bincount(first + j, weights=(window >> (32 - 8 * j)) & 0xFF,
                            minlength=nbytes + 5).astype(np.int64)
    data = data[:nbytes]
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    data = data.astype(np.uint8)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker, payload):
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def write_jpeg(path, image):
    """Write ``image`` [H, W, 3] or [H, W] / [H, W, 1] uint8 as a baseline
    JPEG (three components at 4:4:4, or one grey component)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_jpeg takes uint8, got {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    h, w = image.shape[:2]
    x = image.astype(np.float64)
    if x.ndim == 3:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    else:
        planes = [x]
    qtables = [_quant_table(_LUMA_Q), _quant_table(_CHROMA_Q)]
    nc = len(planes)
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    comps = []
    for i, plane in enumerate(planes):
        plane = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge") - 128
        blocks = plane.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = _DCT @ blocks.reshape(-1, 8, 8) @ _DCT.T
        q = qtables[min(i, 1)].reshape(8, 8)
        comps.append(np.round(coef / q).astype(np.int64).reshape(-1, 64)
                     [:, _ZIGZAG])
    # 4:4:4 interleaving: one block of each component per MCU.
    coefs = np.stack(comps, axis=1).reshape(-1, 64)
    comp = np.tile(np.arange(nc), len(comps[0]))
    tables = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)][:min(nc, 2)]

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i in range(min(nc, 2)):
        out.append(_segment(0xDB, bytes([i]) + bytes(
            qtables[i][_ZIGZAG].astype(np.uint8).tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, 0x11, min(i, 1)]) for i in range(nc))))
    for i, (dc, ac) in enumerate(tables):
        for cls, (counts, symbols) in ((0, dc), (1, ac)):
            out.append(_segment(0xC4, bytes([cls << 4 | i]) + bytes(counts)
                                + bytes(symbols)))
    out.append(_segment(0xDA, bytes([nc]) + b"".join(
        bytes([i + 1, min(i, 1) * 0x11]) for i in range(nc))
        + b"\x00\x3f\x00"))
    out.append(_entropy_code(coefs, comp, tables))
    out.append(b"\xff\xd9")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def save_image(path, composite):
    """Write a composite [H, W, C] of values in [0, 1] (C = 1 or 3) as a
    JPEG, clipped to [0, 1] and upscaled ``IMAGE_SCALE`` times."""
    img = np.round(np.clip(composite, 0.0, 1.0) * 255).astype(np.uint8)
    img = np.repeat(np.repeat(img, IMAGE_SCALE, axis=0), IMAGE_SCALE, axis=1)
    write_jpeg(path, img)
