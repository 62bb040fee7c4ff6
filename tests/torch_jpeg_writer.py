"""A JPEG writer for the decoder tests: files Pillow cannot write, from
quantized DCT coefficients given directly (no forward DCT).

``write_jpeg(comps, w, h, scans, ...)`` encodes each component's blocks
(``Component.coef``: ``[bh, bw, 64]`` int, natural order, the whole MCU grid)
with Huffman coding, sequential (``progressive=False``) or progressive
(jcphuff.c's four scan kinds, EOB runs and correction-bit buffering
included), under any sampling factors, scan script, restart interval and
colour markers (JFIF, Adobe with a transform, or none). The Huffman tables
are fixed: 5-bit codes for the 16 DC symbols, 9-bit codes for the 256 AC
symbols, so every scan can code anything.

``seeded_components`` draws coefficient blocks from a generator: smooth DC
fields with noise and AC coefficients that decay with frequency, zero more
often the higher they are, so the files hold long EOB runs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# libjpeg's jpeg_simple_progression for three YCbCr components (Pillow's
# progressive script): (components, Ss, Se, Ah, Al)
SIMPLE_PROGRESSION_3 = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


@dataclass
class Component:
    h: int
    v: int
    coef: np.ndarray          # [bh, bw, 64] int, natural order
    quant: np.ndarray         # [64] natural order, 1..255
    ident: int = 0


@dataclass
class _Bits:
    out: bytearray = field(default_factory=bytearray)
    acc: int = 0
    n: int = 0

    def put(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:  # pad with ones
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _nbits(v: int) -> int:
    return int(abs(v)).bit_length()


def _coded(v: int, s: int) -> int:  # the s low bits JPEG sends for v
    return v if v >= 0 else v + (1 << s) - 1


class _Huff:
    """The fixed tables: DC symbol s -> 5-bit code s, AC symbol s < 255 ->
    9-bit code s, AC symbol 255 -> the 10-bit code 510."""

    @staticmethod
    def dht() -> bytes:
        dc = bytes([0x00]) + bytes(4) + bytes([16]) + bytes(11) + bytes(range(16))
        counts = bytearray(16)  # a count is a byte: 255 codes of 9 bits, 1 of 10
        counts[8], counts[9] = 255, 1
        ac = bytes([0x10]) + bytes(counts) + bytes(range(256))
        return _segment(0xC4, dc + ac)

    @staticmethod
    def dc(bits: _Bits, sym: int) -> None:
        bits.put(sym, 5)

    @staticmethod
    def ac(bits: _Bits, sym: int) -> None:
        if sym < 255:
            bits.put(sym, 9)
        else:
            bits.put(255 << 1, 10)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _units(comps, idx, mcux, mcuy):
    """The blocks of a scan in coding order, one list per MCU."""
    if len(idx) == 1:
        c = comps[idx[0]]
        wb, hb = c.wblocks, c.hblocks
        return [[(idx[0], y, x)] for y in range(hb) for x in range(wb)]
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcu = []
            for i in idx:
                c = comps[i]
                for by in range(c.v):
                    for bx in range(c.h):
                        mcu.append((i, my * c.v + by, mx * c.h + bx))
            mcus.append(mcu)
    return mcus


class _Scan:
    """One scan's entropy encoder state (jcphuff.c)."""

    def __init__(self, ss, se, al):
        self.bits = _Bits()
        self.ss, self.se, self.al = ss, se, al
        self.eobrun = 0
        self.be: list[int] = []  # buffered correction bits

    def emit_eobrun(self):
        if self.eobrun > 0:
            nb = self.eobrun.bit_length() - 1
            _Huff.ac(self.bits, nb << 4)
            if nb:
                self.bits.put(self.eobrun, nb)
            self.eobrun = 0
            for b in self.be:
                self.bits.put(b, 1)
            self.be = []

    def sequential(self, blk, pred):
        dc = int(blk[0])
        diff = dc - pred
        s = _nbits(diff)
        _Huff.dc(self.bits, s)
        if s:
            self.bits.put(_coded(diff, s), s)
        r = 0
        for k in range(1, 64):
            v = int(blk[NATURAL[k]])
            if v == 0:
                r += 1
                continue
            while r > 15:
                _Huff.ac(self.bits, 0xF0)
                r -= 16
            s = _nbits(v)
            _Huff.ac(self.bits, (r << 4) | s)
            self.bits.put(_coded(v, s), s)
            r = 0
        if r:
            _Huff.ac(self.bits, 0)
        return dc

    def dc_first(self, blk, pred):
        dc = int(blk[0]) >> self.al  # arithmetic shift, as IRIGHT_SHIFT
        diff = dc - pred
        s = _nbits(diff)
        _Huff.dc(self.bits, s)
        if s:
            self.bits.put(_coded(diff, s), s)
        return dc

    def dc_refine(self, blk):
        self.bits.put((int(blk[0]) >> self.al) & 1, 1)

    def ac_first(self, blk):
        r = 0
        for k in range(self.ss, self.se + 1):
            v = int(blk[NATURAL[k]])
            v = v >> self.al if v >= 0 else -((-v) >> self.al)
            if v == 0:
                r += 1
                continue
            self.emit_eobrun()
            while r > 15:
                _Huff.ac(self.bits, 0xF0)
                r -= 16
            s = _nbits(v)
            _Huff.ac(self.bits, (r << 4) | s)
            self.bits.put(_coded(v, s), s)
            r = 0
        if r > 0:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun()

    def ac_refine(self, blk):
        absv = {}
        eob = 0
        for k in range(self.ss, self.se + 1):
            a = abs(int(blk[NATURAL[k]])) >> self.al
            absv[k] = a
            if a == 1:
                eob = k
        r = 0
        br: list[int] = []
        for k in range(self.ss, self.se + 1):
            a = absv[k]
            if a == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun()
                _Huff.ac(self.bits, 0xF0)
                r -= 16
                for b in br:
                    self.bits.put(b, 1)
                br = []
            if a > 1:
                br.append(a & 1)
                continue
            self.emit_eobrun()
            _Huff.ac(self.bits, (r << 4) + 1)
            self.bits.put(0 if blk[NATURAL[k]] < 0 else 1, 1)
            for b in br:
                self.bits.put(b, 1)
            br = []
            r = 0
        if r > 0 or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.emit_eobrun()


def write_jpeg(comps: list[Component], w: int, h: int, scans=None, progressive=False,
               restart: int = 0, jfif: bool = False, adobe: int | None = None,
               frame_marker: int | None = None, arithmetic: bool = False,
               dac: tuple | None = None) -> bytes:
    """The file's bytes. ``scans``: ``(component indices, Ss, Se, Ah, Al)``
    each (default: one interleaved sequential scan of every component);
    ``adobe``: the Adobe marker's transform, or None for no marker;
    ``arithmetic``: QM coding (SOF9 / SOF10) instead of Huffman, with ``dac``
    = (L, U, Kx) for table 0 in a DAC segment (else the defaults 0, 1, 5)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    for c in comps:
        c.wblocks = -(-(-(-w * c.h // hmax)) // 8)
        c.hblocks = -(-(-(-h * c.v // vmax)) // 8)
        assert c.coef.shape[:2] == (mcuy * c.v, mcux * c.h), c.coef.shape
    if scans is None:
        scans = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    for i, c in enumerate(comps):
        out += _segment(0xDB, bytes([i]) + bytes(int(c.quant[NATURAL[k]]) for k in range(64)))
    marker = (0xCA if progressive else 0xC9) if arithmetic else (0xC2 if progressive else 0xC0)
    marker = frame_marker if frame_marker is not None else marker
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for i, c in enumerate(comps):
        sof += bytes([c.ident or i + 1, (c.h << 4) | c.v, i])
    out += _segment(marker, sof)
    L, U, K = dac or (0, 1, 5)
    if not arithmetic:
        out += _Huff.dht()
    elif dac:
        out += _segment(0xCC, bytes([0x00, U << 4 | L, 0x10, K]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for idx, ss, se, ah, al in scans:
        sos = bytes([len(idx)])
        for i in idx:
            sos += bytes([comps[i].ident or i + 1, 0x00])
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        if arithmetic:
            out += _arith_scan(comps, idx, mcux, mcuy, (ss, se, ah, al), progressive,
                               restart, (L, U, K))
            continue
        st = _Scan(ss, se, al)
        pred = [0] * len(comps)
        for m, mcu in enumerate(_units(comps, idx, mcux, mcuy)):
            if restart and m and m % restart == 0:
                st.emit_eobrun()
                st.bits.flush()
                st.bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                pred = [0] * len(comps)
            for ci, by, bx in mcu:
                blk = comps[ci].coef[by, bx]
                if not progressive:
                    pred[ci] = st.sequential(blk, pred[ci])
                elif ss == 0 and ah == 0:
                    pred[ci] = st.dc_first(blk, pred[ci])
                elif ss == 0:
                    st.dc_refine(blk)
                elif ah == 0:
                    st.ac_first(blk)
                else:
                    st.ac_refine(blk)
        st.emit_eobrun()
        st.bits.flush()
        out += st.bits.out
    return bytes(out + b"\xff\xd9")


def seeded_components(rng, w: int, h: int, factors, quality: float = 1.0,
                      dc_scale: float = 40.0) -> list[Component]:
    """Coefficient blocks for ``factors`` (``[(h, v), ...]``) over the whole
    MCU grid of a ``w`` x ``h`` frame: a smooth DC field plus noise, AC
    coefficients ~ Laplace with a scale falling with the zigzag index and
    most high ones zero; quantizers 1-24 growing with frequency, times
    ``quality``."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = []
    for ch, cv in factors:
        bh, bw = mcuy * cv, mcux * ch
        yy, xx = np.mgrid[0:bh, 0:bw]
        a, b, ph = rng.uniform(0.1, 0.6, 3)
        dc = dc_scale * np.sin(a * xx + b * yy + 6 * ph) + rng.normal(0, 4, (bh, bw))
        coef = np.zeros((bh, bw, 64), np.int64)
        coef[..., 0] = np.round(dc)
        for k in range(1, 64):
            scale = 12.0 / (1 + k / 3)
            keep = rng.random((bh, bw)) < max(0.05, 0.9 - k / 50)
            vals = np.round(rng.laplace(0, scale, (bh, bw))).astype(np.int64)
            coef[..., NATURAL[k]] = vals * keep
        quant = np.clip(np.round((1 + np.add.outer(np.arange(8), np.arange(8)) * 1.6)
                                 * quality), 1, 255).astype(np.int64).ravel()
        comps.append(Component(ch, cv, coef, quant))
    return comps


# ---- arithmetic coding (jcarith.c) ------------------------------------------------

def _qm(qe, nlps, nmps, switch):
    return qe << 16 | nmps << 8 | switch << 7 | nlps


# jaricom.c's jpeg_aritab (Table D.2), and the fixed 0.5 state 113
ARITAB = [_qm(*r) for r in (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))]


class _QM:
    """jcarith.c's arith_encode and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, stats, i, val):
        sv = stats[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


class _ArithScan:
    """One arithmetic-coded scan (jcarith.c's encode_mcu*): every component
    on conditioning table 0 (DC: L, U; AC: Kx)."""

    def __init__(self, ss, se, ah, al, n, progressive, L=0, U=1, K=5):
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive, self.L, self.U, self.K = progressive, L, U, K
        self.n = n
        self.restart()

    def restart(self):
        self.qm = _QM()
        self.dc = bytearray(64)
        self.ac = bytearray(256)
        self.fixed = bytearray([113, 0, 0, 0])
        self.last = [0] * self.n
        self.ctx = [0] * self.n

    def _dc(self, i, m):
        e, st0 = self.qm, self.ctx[i]
        v = m - self.last[i]
        if v == 0:
            e.encode(self.dc, st0, 0)
            self.ctx[i] = 0
            return
        self.last[i] = m
        e.encode(self.dc, st0, 1)
        if v > 0:
            e.encode(self.dc, st0 + 1, 0)
            st = st0 + 2
            self.ctx[i] = 4
        else:
            v = -v
            e.encode(self.dc, st0 + 1, 1)
            st = st0 + 3
            self.ctx[i] = 8
        m = 0
        v -= 1
        if v:
            e.encode(self.dc, st, 1)
            m, v2, st = 1, v >> 1, 20
            while v2:
                e.encode(self.dc, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        e.encode(self.dc, st, 0)
        if m < (1 << self.L) >> 1:
            self.ctx[i] = 0
        elif m > (1 << self.U) >> 1:
            self.ctx[i] += 8
        st += 14
        m >>= 1
        while m:
            e.encode(self.dc, st, 1 if m & v else 0)
            m >>= 1

    def _ac_value(self, st, k, v):
        e = self.qm
        st += 2
        m = 0
        v -= 1
        if v:
            e.encode(self.ac, st, 1)
            m, v2 = 1, v >> 1
            if v2:
                e.encode(self.ac, st, 1)
                m <<= 1
                st = 189 if k <= self.K else 217
                v2 >>= 1
                while v2:
                    e.encode(self.ac, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
        e.encode(self.ac, st, 0)
        st += 14
        m >>= 1
        while m:
            e.encode(self.ac, st, 1 if m & v else 0)
            m >>= 1

    def _shifted(self, blk, k, al):
        v = int(blk[NATURAL[k]])
        return v >> al if v >= 0 else -((-v) >> al)

    def _ac_first(self, blk, ss, se, al):
        e = self.qm
        ke = se
        while ke > 0 and self._shifted(blk, ke, al) == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            e.encode(self.ac, st, 0)
            while self._shifted(blk, k, al) == 0:
                e.encode(self.ac, st + 1, 0)
                st += 3
                k += 1
            v = self._shifted(blk, k, al)
            e.encode(self.ac, st + 1, 1)
            e.encode(self.fixed, 0, 0 if v > 0 else 1)
            self._ac_value(st, k, abs(v))
            k += 1
        if k <= se:
            e.encode(self.ac, 3 * (k - 1), 1)

    def block(self, i, blk):
        e = self.qm
        if not self.progressive:
            self._dc(i, int(blk[0]))
            self._ac_first(blk, 1, 63, 0)
        elif self.ss == 0 and self.ah == 0:
            self._dc(i, int(blk[0]) >> self.al)
        elif self.ss == 0:
            e.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)
        elif self.ah == 0:
            self._ac_first(blk, self.ss, self.se, self.al)
        else:
            ke = self.se
            while ke > 0 and self._shifted(blk, ke, self.al) == 0:
                ke -= 1
            kex = ke
            while kex > 0 and self._shifted(blk, kex, self.ah) == 0:
                kex -= 1
            k = self.ss
            while k <= ke:
                st = 3 * (k - 1)
                if k > kex:
                    e.encode(self.ac, st, 0)
                while True:
                    v = abs(self._shifted(blk, k, self.al))
                    if v:
                        if v >> 1:
                            e.encode(self.ac, st + 2, v & 1)
                        else:
                            e.encode(self.ac, st + 1, 1)
                            e.encode(self.fixed, 0, 0 if blk[NATURAL[k]] > 0 else 1)
                        break
                    e.encode(self.ac, st + 1, 0)
                    st += 3
                    k += 1
                k += 1
            if k <= self.se:
                e.encode(self.ac, 3 * (k - 1), 1)


def _arith_scan(comps, idx, mcux, mcuy, params, progressive, restart, conditioning) -> bytes:
    ss, se, ah, al = params
    st = _ArithScan(ss, se, ah, al, len(idx), progressive, *conditioning)
    out = bytearray()
    for m, mcu in enumerate(_units(comps, idx, mcux, mcuy)):
        if restart and m and m % restart == 0:
            out += st.qm.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            st.restart()
        for ci, by, bx in mcu:
            st.block(idx.index(ci), comps[ci].coef[by, bx])
    return bytes(out + st.qm.finish())


# ---- lossless (SOF3) ----------------------------------------------------------------

def _predict(ps, ra, rb, rc):
    return [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
            (ra + rb) >> 1][ps]


def _lossless_diffs(x, ps, pt, first_rows, precision=8):
    """The sample differences of one component's point-transformed samples
    ``x`` ([rows, cols] of its true extent), mod 2^16 and signed: each row in
    ``first_rows`` predicted from its left neighbour (its first sample from
    2^(P - Pt - 1)), every other row's first sample from the one above."""
    rows, cols = x.shape
    d = np.zeros_like(x)
    for r in range(rows):
        for c in range(cols):
            if r in first_rows:
                p = (1 << (precision - pt - 1)) if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, c]
            else:
                p = _predict(ps, int(x[r, c - 1]), int(x[r - 1, c]), int(x[r - 1, c - 1]))
            diff = (int(x[r, c]) - p) & 0xFFFF
            d[r, c] = diff - 0x10000 if diff >= 0x8000 else diff
    return d


def write_lossless_jpeg(planes, factors, w, h, predictor=1, pt=0, restart=0,
                        interleaved=True, frame_marker=0xC3, jfif=False,
                        adobe: int | None = None) -> bytes:
    """A lossless JPEG (SOF3, Huffman) of ``planes`` (each component's 8-bit
    samples over its true extent, ``ceil(w * h_i / hmax)`` wide) under
    ``factors``, predictor 1-7 and point transform ``pt``, in one interleaved
    scan or a scan a component, with a restart every ``restart`` MCUs. The
    predictor restarts as libjpeg-turbo's decoder restarts it: at the first
    row of each iMCU row in which a restart interval begins (``v`` sample
    rows of a component alone in its scan)."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    n = len(factors)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    sof = struct.pack(">BHHB", 8, h, w, n)
    for i, (fh, fv) in enumerate(factors):
        sof += bytes([i + 1, (fh << 4) | fv, 0])
    out += _segment(frame_marker, sof)
    counts = bytearray(16)
    counts[4] = 17  # 17 difference categories, 5-bit codes 0..16
    out += _segment(0xC4, bytes([0x00]) + bytes(counts) + bytes(range(17)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = [tuple(range(n))] if interleaved else [(i,) for i in range(n)]
    for idx in scans:
        sos = bytes([len(idx)]) + b"".join(bytes([i + 1, 0x00]) for i in idx)
        out += _segment(0xDA, sos + bytes([predictor, 0, pt]))
        if len(idx) == 1:
            ph, pw = planes[idx[0]].shape
            mcus = [[(idx[0], y, x)] for y in range(ph) for x in range(pw)]
            per_row, mcu_rows = pw, ph
        else:
            mcus = [[(i, my * factors[i][1] + by, mx * factors[i][0] + bx) for i in idx
                     for by in range(factors[i][1]) for bx in range(factors[i][0])]
                    for my in range(mcuy) for mx in range(mcux)]
            per_row, mcu_rows = mcux, mcuy
        diffs = {}
        for i in idx:
            v = factors[i][1]
            starts = {q for q in range(mcu_rows)
                      if q == 0 or (restart and (q * per_row) % restart == 0)}
            # the MCU rows -> the sample rows whose prediction restarts
            if len(idx) == 1:
                first = {q - q % v for q in starts}
            else:
                first = {q * v for q in starts}
            x = np.asarray(planes[i]).astype(np.int64) >> pt
            d = _lossless_diffs(x, predictor, pt, first)
            full = np.zeros((mcuy * factors[i][1], mcux * factors[i][0]), np.int64)
            full[:d.shape[0], :d.shape[1]] = d
            diffs[i] = full
        bits = _Bits()
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            for ci, y, x in mcu:
                dv = int(diffs[ci][y, x])
                s = 16 if dv == -32768 else _nbits(dv)
                bits.put(s, 5)
                if 0 < s < 16:
                    bits.put(_coded(dv, s), s)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")
