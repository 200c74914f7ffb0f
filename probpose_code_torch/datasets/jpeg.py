"""JPEG header probe and plain decoder in NumPy (no OpenCV, no PIL).

The counterpart of ``cv2.imread(path, cv2.IMREAD_COLOR)`` for JPEG files,
which the JAX package's ``LoadImage`` calls (``probpose_code_tpu/datasets/
transforms/loading.py:114-122``), and of its header probe
(``datasets/native_decode.py:99 probe``, ``csrc/image_pipeline.cpp:
jpeg_exif_orientation``). It is the plain twin that the CPU runs and that
the card's decode (``ops/kernels/jpeg.py``) is held against; the card's
decode (``csrc/jpeg_exact.cuh``) is the same algorithm in C++ and CUDA.

What it decodes: 8-bit Huffman-coded frames, sequential (SOF0, SOF1) or
progressive (SOF2), with 1 component (replicated into three, as
``IMREAD_COLOR`` does) or 3 (YCbCr, or RGB where the Adobe or component-id
convention says so), chroma sampled 4:4:4, 4:2:2, 4:2:0 or 4:4:0, with or
without restart intervals, and the EXIF orientations 1-8 applied as
``cv2.imread`` applies them. Anything else (arithmetic coding, lossless or
hierarchical frames, 12-bit samples, CMYK / YCCK, other sampling, a
truncated stream or one that does not decode) raises ``ValueError`` naming
the file and what it lacks.

Its arithmetic is libjpeg-turbo's defaults, which OpenCV uses: the integer
"islow" IDCT (``jidctint.c``) with its range limit, the fancy (triangle)
chroma upsampling (``jdsample.c``: h2v1, h2v2, h1v2; a box copy where the
chroma is 2 samples wide or less) with the image's last row and column
repeated past its edge, and the integer YCbCr -> BGR tables of
``jdcolor.c``. The result equals ``cv2.imread`` bit for bit on the
repository's fixtures (``tests/test_torch_jpeg.py``).

Speed: the entropy decode is a Python loop (about a microsecond a
coefficient); the IDCT, upsampling and colour conversion are whole-array
NumPy.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# zigzag position -> natural (row-major) position; 16 guard entries, as
# libjpeg's ``jpeg_natural_order``, so that a corrupt run cannot index out
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

# SOF markers: the frame types that are refused, by name
_SOF_REFUSED = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical (SOF7)", 0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCD: "arithmetic coding (SOF13)", 0xCE: "arithmetic coding (SOF14)",
    0xCF: "arithmetic coding (SOF15)",
}
# chroma sampling (luma h, v over chroma 1 x 1) -> name
SAMPLING = {(1, 1): "444", (2, 1): "422", (2, 2): "420", (1, 2): "440"}


class JpegInfo(NamedTuple):
    """What the header says: the stored ``width`` and ``height`` (before
    the EXIF ``orientation`` is applied; 0 when no tag), ``components``
    (1 or 3), ``progressive`` and the chroma ``sampling`` ("444", "422",
    "420", "440", or "gray")."""

    width: int
    height: int
    orientation: int
    components: int
    progressive: bool
    sampling: str

    @property
    def transposed(self) -> bool:
        """Orientations 5-8 swap the stored width and height."""
        return self.orientation in (5, 6, 7, 8)

    @property
    def shape(self) -> Tuple[int, int]:
        """(h, w) of the image as ``cv2.imread`` returns it (oriented)."""
        return (self.width, self.height) if self.transposed else (self.height, self.width)


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def _exif_orientation(seg: bytes) -> int:
    """The orientation tag of IFD0 in an APP1 ``Exif`` payload, 0 when
    there is none (``image_pipeline.cpp:parse_exif_orientation``)."""
    if len(seg) < 14 or seg[:6] != b"Exif\0\0":
        return 0
    t = seg[6:]
    if t[:2] == b"II":
        order = "little"
    elif t[:2] == b"MM":
        order = "big"
    else:
        return 0

    def rd(off: int, n: int) -> int:
        return int.from_bytes(t[off:off + n], order) if off + n <= len(t) else 0

    if rd(2, 2) != 42:
        return 0
    ifd = rd(4, 4)
    if ifd + 2 > len(t):
        return 0
    for i in range(rd(ifd, 2)):
        e = ifd + 2 + 12 * i
        if e + 12 > len(t):
            return 0
        if rd(e, 2) == 0x0112:
            return rd(e + 8, 2)
    return 0


class _Segment(NamedTuple):
    marker: int
    body: bytes  # the payload after the length field
    scan: Optional[List[bytes]]  # for SOS: the entropy-coded data, split at RST markers, unstuffed


def _entropy_data(data: bytes, pos: int, name: str, keep: bool) -> Tuple[List[bytes], int]:
    """The entropy-coded data of a scan from ``pos``: with ``keep`` its
    restart intervals with the byte stuffing undone, else nothing; and the
    offset of the marker that ends it."""
    chunks, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            raise ValueError(f"{name}: truncated JPEG stream (the scan runs to the end of the data)")
        nxt = data[i + 1]
        if nxt == 0:
            i += 2
        elif nxt == 0xFF:  # a fill byte
            i += 1
        else:
            if keep:
                chunk = data[start:i].rstrip(b"\xff")  # fill bytes before the marker
                chunks.append(chunk.replace(b"\xff\x00", b"\xff"))
            if 0xD0 <= nxt <= 0xD7:
                i += 2
                start = i
            else:
                return chunks, i


def _segments(data: bytes, name: str, scans: bool) -> List[_Segment]:
    """The stream's marker segments from SOI to EOI. With ``scans`` the
    entropy-coded data is kept, else only walked over. A stream that ends
    before its EOI marker raises."""
    if not is_jpeg(data):
        raise ValueError(f"{name}: not a JPEG stream (no SOI marker)")
    out, pos = [], 2
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: truncated JPEG stream (no EOI marker)")
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG stream (no marker at byte {pos})")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= len(data):
            raise ValueError(f"{name}: truncated JPEG stream (no EOI marker)")
        marker = data[pos + 1]
        if marker == 0xD9:
            return out
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        if pos + 4 > len(data):
            raise ValueError(f"{name}: truncated JPEG stream (in a marker segment)")
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        end = pos + 2 + length
        if length < 2 or end > len(data):
            raise ValueError(f"{name}: truncated JPEG stream (in a marker segment)")
        body = data[pos + 4:end]
        scan = None
        if marker == 0xDA:
            scan, pos = _entropy_data(data, end, name, keep=scans)
        else:
            pos = end
        out.append(_Segment(marker, body, scan))


class _Frame(NamedTuple):
    sof: int
    width: int
    height: int
    # per component: (id, h, v, quant table id)
    comps: List[Tuple[int, int, int, int]]
    orientation: int
    rgb: bool  # three components stored as RGB, not YCbCr


def _frame(segs: List[_Segment], name: str) -> _Frame:
    sof, orientation, adobe, jfif = None, 0, None, False
    for seg in segs:
        m, b = seg.marker, seg.body
        if m == 0xE1 and not orientation:
            orientation = _exif_orientation(b)
        elif m == 0xE0 and b[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and b[:5] == b"Adobe" and len(b) >= 12:
            adobe = b[11]
        elif m == 0xCC:
            raise ValueError(f"{name}: unsupported JPEG: arithmetic coding (DAC marker)")
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if m in _SOF_REFUSED:
                raise ValueError(f"{name}: unsupported JPEG: {_SOF_REFUSED[m]}")
            if sof is not None:
                raise ValueError(f"{name}: corrupt JPEG stream (two frame headers)")
            if len(b) < 6:
                raise ValueError(f"{name}: corrupt JPEG stream (short frame header)")
            precision, h, w, n = b[0], int.from_bytes(b[1:3], "big"), int.from_bytes(b[3:5], "big"), b[5]
            if precision != 8:
                raise ValueError(f"{name}: unsupported JPEG: {precision}-bit samples (8-bit only)")
            if n not in (1, 3):
                raise ValueError(f"{name}: unsupported JPEG: {n} components (CMYK / YCCK or other; 1 or 3 only)")
            if len(b) < 6 + 3 * n:
                raise ValueError(f"{name}: corrupt JPEG stream (short frame header)")
            if h == 0 or w == 0:
                raise ValueError(f"{name}: unsupported JPEG: a zero dimension (DNL marker)")
            comps = [(b[6 + 3 * i], b[7 + 3 * i] >> 4, b[7 + 3 * i] & 15, b[8 + 3 * i]) for i in range(n)]
            sof = (m, w, h, comps)
    if sof is None:
        raise ValueError(f"{name}: corrupt JPEG stream (no frame header)")
    m, w, h, comps = sof
    if any(not (1 <= c[1] <= 4 and 1 <= c[2] <= 4) for c in comps):
        raise ValueError(f"{name}: corrupt JPEG stream (a sampling factor out of 1-4)")
    if len(comps) == 3 and (comps[1][1:3] != (1, 1) or comps[2][1:3] != (1, 1) or comps[0][1:3] not in SAMPLING):
        raise ValueError(f"{name}: unsupported JPEG: chroma sampling "
                         f"{'x'.join(f'{c[1]}{c[2]}' for c in comps)} (4:4:4, 4:2:2, 4:2:0, 4:4:0 only)")
    # libjpeg's guess of the colour space (jdapimin.c: default_decompress_parms)
    ids = tuple(c[0] for c in comps)
    rgb = len(comps) == 3 and not jfif and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    return _Frame(m, w, h, comps, orientation if 1 <= orientation <= 8 else 0, rgb)


def probe(data: bytes, name: str = "<bytes>") -> JpegInfo:
    """The header of a JPEG stream, after walking its marker segments to
    EOI; raises ``ValueError`` (naming ``name``) on what ``decode`` refuses."""
    f = _frame(_segments(data, name, scans=False), name)
    sampling = SAMPLING[f.comps[0][1:3]] if len(f.comps) == 3 else "gray"
    return JpegInfo(f.width, f.height, f.orientation, len(f.comps), f.sof == 0xC2, sampling)


# -- entropy decoding ---------------------------------------------------------


def _huffman_lut(body: bytes, pos: int, name: str) -> Tuple[int, int, List[int], int]:
    """One table of a DHT segment at ``pos``: (class, id, lookup, next pos).
    The lookup maps the next 16 bits of the stream to ``length << 8 |
    symbol``; 0 marks a code that is not in the table."""
    if pos + 17 > len(body):
        raise ValueError(f"{name}: corrupt JPEG stream (short Huffman table)")
    tc, th = body[pos] >> 4, body[pos] & 15
    counts = body[pos + 1:pos + 17]
    total = sum(counts)
    symbols = body[pos + 17:pos + 17 + total]
    if len(symbols) != total or tc > 1 or th > 3:
        raise ValueError(f"{name}: corrupt JPEG stream (bad Huffman table)")
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError(f"{name}: corrupt JPEG stream (bad Huffman table)")
            lut[code << (16 - length):(code + 1) << (16 - length)] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return tc, th, lut.tolist(), pos + 17 + total


def _windows(chunk: bytes) -> List[int]:
    """32-bit big-endian windows at every byte of ``chunk`` (zeros past its
    end): the bits from bit p are ``win[p >> 3]`` shifted by ``p & 7``."""
    b = np.frombuffer(chunk + b"\0\0\0\0", np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


class _Corrupt(Exception):
    pass


class _Component:
    """One component's coefficients, flat: block (r, c) holds natural-order
    coefficients at ``64 * (r * bw + c)``."""

    def __init__(self, cid, h, v, tq, W, H, hmax, vmax):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.width = -(-W * h // hmax)  # libjpeg's downsampled_width
        self.height = -(-H * v // vmax)
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
        self.bw, self.bh = mcux * h, mcuy * v  # allocated to whole MCUs
        self.coded_bw, self.coded_bh = -(-self.width // 8), -(-self.height // 8)  # a lone scan's blocks
        self.coef = [0] * (64 * self.bw * self.bh)
        self.quant = None  # latched at the component's first scan


class _Decoder:
    def __init__(self, data: bytes, name: str):
        self.name = name
        segs = _segments(data, name, scans=True)
        self.frame = _frame(segs, name)
        f = self.frame
        hmax = max(c[1] for c in f.comps)
        vmax = max(c[2] for c in f.comps)
        self.hmax, self.vmax = hmax, vmax
        self.mcux, self.mcuy = -(-f.width // (8 * hmax)), -(-f.height // (8 * vmax))
        self.comps = [_Component(cid, h, v, tq, f.width, f.height, hmax, vmax) for cid, h, v, tq in f.comps]
        self.progressive = f.sof == 0xC2
        qt: Dict[int, np.ndarray] = {}
        dc: Dict[int, list] = {}
        ac: Dict[int, list] = {}
        restart = 0
        scans = 0
        for seg in segs:
            m, b = seg.marker, seg.body
            if m == 0xDB:
                self._quant_tables(b, qt)
            elif m == 0xC4:
                pos = 0
                while pos < len(b):
                    tc, th, lut, pos = _huffman_lut(b, pos, name)
                    (ac if tc else dc)[th] = lut
            elif m == 0xDD:
                if len(b) < 2:
                    raise ValueError(f"{name}: corrupt JPEG stream (short DRI segment)")
                restart = int.from_bytes(b[:2], "big")
            elif m == 0xDA:
                self._scan(b, seg.scan, qt, dc, ac, restart)
                scans += 1
        if not scans:
            raise ValueError(f"{name}: corrupt JPEG stream (no scan)")
        for c in self.comps:
            if c.quant is None:
                raise ValueError(f"{name}: corrupt JPEG stream (a component no scan codes)")

    def _quant_tables(self, b: bytes, qt: Dict[int, np.ndarray]) -> None:
        pos = 0
        while pos < len(b):
            pq, tq = b[pos] >> 4, b[pos] & 15
            n = 128 if pq else 64
            vals = b[pos + 1:pos + 1 + n]
            if len(vals) != n or tq > 3:
                raise ValueError(f"{self.name}: corrupt JPEG stream (bad quantization table)")
            zz = np.frombuffer(vals, ">u2" if pq else np.uint8).astype(np.int64)
            table = np.zeros(64, np.int64)
            table[ZIGZAG[:64]] = zz
            qt[tq] = table
            pos += 1 + n

    def _scan(self, b: bytes, chunks: List[bytes], qt, dc, ac, restart: int) -> None:
        name = self.name
        ns = b[0] if b else 0
        if ns < 1 or len(b) < 1 + 2 * ns + 3:
            raise ValueError(f"{name}: corrupt JPEG stream (bad scan header)")
        by_id = {c.id: c for c in self.comps}
        members = []
        for i in range(ns):
            c = by_id.get(b[1 + 2 * i])
            if c is None:
                raise ValueError(f"{name}: corrupt JPEG stream (a scan names an unknown component)")
            members.append((c, b[2 + 2 * i] >> 4, b[2 + 2 * i] & 15))
        ss, se, ah, al = b[1 + 2 * ns], b[2 + 2 * ns], b[3 + 2 * ns] >> 4, b[3 + 2 * ns] & 15
        for c, _, _ in members:
            if c.quant is None:
                if c.tq not in qt:
                    raise ValueError(f"{name}: corrupt JPEG stream (a missing quantization table)")
                c.quant = qt[c.tq]
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        elif ss > se or se > 63 or (ss > 0 and ns != 1) or (ss == 0 and se != 0) or al > 13:
            raise ValueError(f"{name}: corrupt JPEG stream (bad progressive scan parameters)")

        # the scan's blocks, MCU by MCU: (component slot, coefficient list, offset)
        if ns == 1:
            c = members[0][0]
            mcus = [[(0, c.coef, 64 * (r * c.bw + q))] for r in range(c.coded_bh) for q in range(c.coded_bw)]
        else:
            mcus = []
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    blocks = []
                    for slot, (c, _, _) in enumerate(members):
                        for v in range(c.v):
                            for h in range(c.h):
                                blocks.append((slot, c.coef, 64 * ((my * c.v + v) * c.bw + mx * c.h + h)))
                    mcus.append(blocks)
        per = restart if restart else len(mcus)
        intervals = -(-len(mcus) // per)
        if len(chunks) < intervals:
            raise ValueError(f"{name}: truncated JPEG stream ({len(chunks)} of {intervals} restart intervals)")

        try:
            dcl = [dc[t] if (ss == 0 and ah == 0) else None for _, t, _ in members]
            acl = [ac[t] if se > 0 else None for _, _, t in members]
        except KeyError:
            raise ValueError(f"{name}: corrupt JPEG stream (a missing Huffman table)") from None
        for i in range(intervals):
            chunk = chunks[i]
            win = _windows(chunk)
            group = mcus[i * per:(i + 1) * per]
            try:
                if not self.progressive:
                    p = _decode_sequential(win, group, dcl, acl, len(members))
                elif ss == 0:
                    p = _decode_dc(win, group, dcl, len(members), ah, al)
                elif ah == 0:
                    p = _decode_ac_first(win, group, acl[0], ss, se, al)
                else:
                    p = _decode_ac_refine(win, group, acl[0], ss, se, al)
            except (_Corrupt, IndexError):
                p = None
            if p is None or p > 8 * len(chunk):
                raise ValueError(f"{name}: truncated or corrupt JPEG stream (entropy-coded data ends early)")

    def components(self) -> List[np.ndarray]:
        """Each component's samples, (height, width) uint8, after the IDCT."""
        out = []
        for c in self.comps:
            coef = np.asarray(c.coef, np.int64).reshape(c.bh * c.bw, 8, 8) * c.quant.reshape(1, 8, 8)
            pix = idct_islow(coef)  # (N, 8, 8)
            plane = pix.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
            out.append(plane[:c.height, :c.width])
        return out


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_sequential(win, mcus, dcl, acl, ns) -> int:
    """Baseline / extended sequential blocks (``jdhuff.c:decode_mcu``)."""
    zz = ZIGZAG
    p = 0
    pred = [0] * ns
    for blocks in mcus:
        for slot, coef, base in blocks:
            e = dcl[slot][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if e < 256:
                raise _Corrupt
            p += e >> 8
            s = e & 255
            if s:
                if s > 16:
                    raise _Corrupt
                v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if v < (1 << (s - 1)):
                    v += 1 - (1 << s)
                pred[slot] += v
            coef[base] = pred[slot]
            lut = acl[slot]
            k = 1
            while k < 64:
                e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if e < 256:
                    raise _Corrupt
                p += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if v < (1 << (s - 1)):
                        v += 1 - (1 << s)
                    coef[base + zz[k]] = v
                    k += 1
                elif (e & 255) == 0xF0:
                    k += 16
                else:
                    break
    return p


def _decode_dc(win, mcus, dcl, ns, ah, al) -> int:
    """Progressive DC scans, first and refining (``jdphuff.c``)."""
    p = 0
    pred = [0] * ns
    bit = 1 << al
    for blocks in mcus:
        for slot, coef, base in blocks:
            if ah == 0:
                e = dcl[slot][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if e < 256:
                    raise _Corrupt
                p += e >> 8
                s = e & 255
                if s:
                    if s > 16:
                        raise _Corrupt
                    v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    pred[slot] += _extend(v, s)
                coef[base] = pred[slot] << al
            else:
                if (win[p >> 3] >> (31 - (p & 7))) & 1:
                    coef[base] |= bit
                p += 1
    return p


def _decode_ac_first(win, mcus, lut, ss, se, al) -> int:
    """Progressive AC first scans (``decode_mcu_AC_first``)."""
    zz = ZIGZAG
    p = 0
    eobrun = 0
    for blocks in mcus:
        _, coef, base = blocks[0]
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if e < 256:
                raise _Corrupt
            p += e >> 8
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                coef[base + zz[k]] = _extend(v, s) << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                    p += r
                eobrun -= 1
                break
            k += 1
    return p


def _decode_ac_refine(win, mcus, lut, ss, se, al) -> int:
    """Progressive AC refining scans (``decode_mcu_AC_refine``)."""
    zz = ZIGZAG
    p1, m1 = 1 << al, -1 << al
    p = 0
    eobrun = 0
    for blocks in mcus:
        _, coef, base = blocks[0]
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if e < 256:
                    raise _Corrupt
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                        p += r
                    break
                while k <= se:
                    i = base + zz[k]
                    c = coef[i]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not (c & p1):
                            coef[i] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[base + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + zz[k]
                c = coef[i]
                if c:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not (c & p1):
                        coef[i] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1
    return p


# -- IDCT, upsampling, colour ---------------------------------------------------

# jidctint.c's constants (CONST_BITS 13)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633, f1501=12299, f1847=15137,
          f1961=16069, f2053=16819, f2562=20995, f3072=25172)
# the post-IDCT range limit (jdmaster.c: prepare_range_limit_table), indexed by x & 1023
_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(128)]).astype(np.uint8)


def _idct_pass(d, shift: int):
    """One 1-D pass of ``jpeg_idct_islow`` over the 8 inputs ``d`` (arrays
    of int64), descaled by ``shift`` (pass 1) or left undescaled (None)."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F["f0541"]
    tmp2 = z1 - z3 * _F["f1847"]
    tmp3 = z1 + z2 * _F["f0765"]
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["f1175"]
    t0 = t0 * _F["f0298"]
    t1 = t1 * _F["f2053"]
    t2 = t2 * _F["f3072"]
    t3 = t3 * _F["f1501"]
    z1 = z1 * -_F["f0899"]
    z2 = z2 * -_F["f2562"]
    z3 = z3 * -_F["f1961"] + z5
    z4 = z4 * -_F["f0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    half = 1 << (shift - 1)
    return [(o + half) >> shift for o in out]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT of dequantized (N, 8, 8) int64 blocks (row =
    vertical frequency) to (N, 8, 8) uint8 samples, range-limited."""
    cols = _idct_pass([coef[:, k, :] for k in range(8)], 11)  # pass 1: down each column
    ws = np.stack(cols, axis=1)  # (N, 8 rows, 8 cols)
    rows = _idct_pass([ws[:, :, k] for k in range(8)], 18)  # pass 2: along each row
    return _RANGE[np.stack(rows, axis=2) & 1023]


def _pad_edges(x: np.ndarray, axis: int) -> np.ndarray:
    """``x`` with its first and last entry along ``axis`` repeated once."""
    first = np.take(x, [0], axis=axis)
    last = np.take(x, [-1], axis=axis)
    return np.concatenate([first, x, last], axis=axis)


def upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg-turbo's fancy upsampling of one chroma plane by (h, v) in
    {1, 2}: h2v1 and h2v2 triangles where the plane is more than 2 samples
    wide (else a box copy), h1v2 always a triangle."""
    x = plane.astype(np.int32)
    W = x.shape[1]
    if (h, v) == (1, 1):
        return plane
    if h == 2 and W <= 2:  # jdsample.c: h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(plane, 2, axis=1), v, axis=0)
    if (h, v) == (1, 2):
        p = _pad_edges(x, 0)
        up = (3 * x + p[:-2] + 1) >> 2
        down = (3 * x + p[2:] + 2) >> 2
        return np.stack([up, down], axis=1).reshape(-1, W).astype(np.uint8)
    if (h, v) == (2, 1):
        p = _pad_edges(x, 1)
        left = (3 * x + p[:, :-2] + 1) >> 2
        right = (3 * x + p[:, 2:] + 2) >> 2
        return np.stack([left, right], axis=2).reshape(x.shape[0], 2 * W).astype(np.uint8)
    # h2v2: column sums with the nearer row weighted 3, then the same along rows
    p = _pad_edges(x, 0)
    sums = np.stack([3 * x + p[:-2], 3 * x + p[2:]], axis=1).reshape(-1, W)
    q = _pad_edges(sums, 1)
    left = (3 * sums + q[:, :-2] + 8) >> 4
    right = (3 * sums + q[:, 2:] + 7) >> 4
    return np.stack([left, right], axis=2).reshape(sums.shape[0], 2 * W).astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's ``build_ycc_rgb_table`` (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda f: int(f * (1 << 16) + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation applied as ``cv2.imread`` applies it
    (``ApplyExifOrientation``): 2 flip left-right, 3 rotate 180, 4 flip
    up-down, 5 transpose, 6 transpose then flip left-right (90 degrees
    clockwise), 7 transpose then rotate 180, 8 transpose then flip up-down."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation)
    if flip:
        img = np.flip(img, axis=flip)
    return np.ascontiguousarray(img)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG stream as ``cv2.imread(path, IMREAD_COLOR)`` returns it: an
    (H, W, 3) uint8 BGR array, EXIF orientation applied. Raises
    ``ValueError`` naming ``name`` on what it does not decode."""
    dec = _Decoder(bytes(data), name)
    f = dec.frame
    planes = dec.components()
    if len(planes) == 1:
        img = np.repeat(planes[0][:, :, None], 3, axis=2)
    else:
        full = [planes[0]] + [upsample(p, dec.hmax // c.h, dec.vmax // c.v)[:f.height, :f.width]
                              for p, c in zip(planes[1:], dec.comps[1:])]
        if f.rgb:
            img = np.stack([full[2], full[1], full[0]], axis=-1)
        else:
            img = ycc_to_bgr(*full)
    return orient(img, f.orientation)
