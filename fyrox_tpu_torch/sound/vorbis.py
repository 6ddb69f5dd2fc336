"""Pure-Python/NumPy Vorbis I DSP decoder (the port's copy of
``fyrox_tpu.sound.vorbis``, host only).

The reference plays .ogg assets through symphonia (ref:
fyrox-sound/Cargo.toml:26); the engine depends on no Vorbis library, so
the DSP layer is implemented here from the public Vorbis I specification
(Xiph.Org, rev 2020) — setup parsing (codebooks/floors/residues/mappings/
modes), canonical Huffman decode, floor-1 curve synthesis, residue 0/1/2
VQ accumulation, square-polar channel de-coupling, IMDCT (precomputed
cosine basis, NumPy matmul), Vorbis windowing and center-to-center
overlap-add.

Scope/fidelity notes:
- floor type 0 (legacy LSP floors, unused by libvorbis encoders) parses
  but raises UnsupportedCodec at decode time.
- output is float32 PCM in [-1, 1], shape [channels, samples]; the
  stream's final Ogg granule position trims encoder padding.
- tests/test_torch_assets.py holds it equal to the JAX package's decoder
  part by part and on a whole stream written by the spec. Bit-exactness
  against libvorbis is not asserted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["decode_ogg_vorbis", "VorbisDecoder", "EndOfPacket"]


class EndOfPacket(Exception):
    """Reading past the end of an audio packet truncates decode (spec
    §1.3.2: end-of-packet is a normal decode-stop condition)."""


class BitReader:
    """LSB-first bit reader over one packet (Vorbis bitpacking, §2)."""

    __slots__ = ("data", "byte", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.byte = 0
        self.acc = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.byte >= len(self.data):
                raise EndOfPacket
            self.acc |= self.data[self.byte] << self.nbits
            self.byte += 1
            self.nbits += 8
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return v

    def peek_pad(self, n: int) -> Tuple[int, int]:
        """Next n bits (zero-padded past the end) + count actually real."""
        real = self.nbits + 8 * (len(self.data) - self.byte)
        while self.nbits < n and self.byte < len(self.data):
            self.acc |= self.data[self.byte] << self.nbits
            self.byte += 1
            self.nbits += 8
        return self.acc & ((1 << n) - 1), min(real, n)

    def skip(self, n: int):
        if self.nbits < n:
            raise EndOfPacket
        self.acc >>= n
        self.nbits -= n


def _ilog(x: int) -> int:
    n = 0
    while x > 0:
        n += 1
        x >>= 1
    return n


def _float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    exponent = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exponent - 788))


def _lookup1_values(entries: int, dim: int) -> int:
    v = 1
    while (v + 1) ** dim <= entries:
        v += 1
    return v


_FAST_BITS = 10


class Codebook:
    """One codebook: canonical Huffman (first-fit, entry order — §3.2.1)
    + optional VQ lookup table."""

    def __init__(self, br: BitReader):
        if br.read(24) != 0x564342:
            raise ValueError("codebook sync lost")
        self.dim = br.read(16)
        entries = br.read(24)
        self.entries = entries
        lengths = [0] * entries
        if br.read(1):                                   # ordered
            cur_len = br.read(5) + 1
            cur = 0
            while cur < entries:
                num = br.read(_ilog(entries - cur))
                for i in range(cur, cur + num):
                    lengths[i] = cur_len
                cur += num
                cur_len += 1
        else:
            sparse = br.read(1)
            for i in range(entries):
                if sparse and not br.read(1):
                    lengths[i] = 0                       # unused entry
                else:
                    lengths[i] = br.read(5) + 1
        self.lengths = lengths
        self._assign_codewords()

        self.lookup_type = br.read(4)
        self.vq: Optional[np.ndarray] = None
        if self.lookup_type in (1, 2):
            minv = _float32_unpack(br.read(32))
            delta = _float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read(1)
            if self.lookup_type == 1:
                lv = _lookup1_values(entries, self.dim)
            else:
                lv = entries * self.dim
            mult = np.array([br.read(value_bits) for _ in range(lv)],
                            np.float64)
            vq = np.zeros((entries, self.dim), np.float64)
            if self.lookup_type == 1:
                for d in range(self.dim):
                    idx = (np.arange(entries) // (lv ** d)) % lv
                    vq[:, d] = mult[idx] * delta + minv
            else:
                vq = mult.reshape(entries, self.dim) * delta + minv
            if sequence_p:
                vq = np.cumsum(vq, axis=1)
            self.vq = vq.astype(np.float32)
        elif self.lookup_type != 0:
            raise ValueError(f"bad lookup type {self.lookup_type}")

    def _assign_codewords(self):
        """First-fit canonical assignment in entry order (§3.2.1)."""
        lengths = self.lengths
        available = [0] * 33
        self.max_len = max(lengths) if any(lengths) else 0
        rev_codes: Dict[int, List[Tuple[int, int]]] = {}
        fast = np.full(1 << _FAST_BITS, -1, np.int32)
        fast_len = np.zeros(1 << _FAST_BITS, np.int8)
        self.long_entries: List[Tuple[int, int, int]] = []  # (rev, len, ent)
        first = True
        for i, l in enumerate(lengths):
            if l <= 0:
                continue
            if first:
                # codeword 0 of length l; available[j] holds the len-j
                # sibling 0..01 (MSB-aligned), INCLUDING j == l
                res = 0
                first = False
                for j in range(1, l + 1):
                    available[j] = 1 << (32 - j)
            else:
                z = l
                while z > 0 and available[z] == 0:
                    z -= 1
                if z == 0:
                    raise ValueError("over-specified Huffman tree")
                res = available[z]
                available[z] = 0
                for y in range(z + 1, l + 1):
                    available[y] = res | (1 << (32 - y))
            code = res >> (32 - l)                       # MSB-first code
            rev = int(f"{code:0{l}b}"[::-1], 2)          # LSB-first match
            if l <= _FAST_BITS:
                step = 1 << l
                idx = np.arange(rev, 1 << _FAST_BITS, step)
                fast[idx] = i
                fast_len[idx] = l
            else:
                self.long_entries.append((rev, l, i))
        self.fast = fast
        self.fast_len = fast_len

    def decode(self, br: BitReader) -> int:
        window, real = br.peek_pad(max(self.max_len, _FAST_BITS))
        e = self.fast[window & ((1 << _FAST_BITS) - 1)]
        if e >= 0:
            l = int(self.fast_len[window & ((1 << _FAST_BITS) - 1)])
            if l > real:
                raise EndOfPacket
            br.skip(l)
            return int(e)
        for rev, l, ent in self.long_entries:
            if l <= real and (window & ((1 << l) - 1)) == rev:
                br.skip(l)
                return ent
        raise EndOfPacket

    def decode_vq(self, br: BitReader) -> np.ndarray:
        return self.vq[self.decode(br)]


# --------------------------------------------------------------------------
# floor type 1 (§7.2)
# --------------------------------------------------------------------------

_FLOOR1_RANGES = (256, 128, 86, 64)

# floor1_inverse_dB_table (§10.1): 256 entries spanning -140 dB .. ~-1.6
# dB on an exact exponential lattice; generated rather than listed.
_INV_DB = (1.0649863e-07 * np.exp(
    np.arange(256, dtype=np.float64) * (np.log(0.82788260 / 1.0649863e-07)
                                        / 255.0))).astype(np.float32)


@dataclass
class Floor1:
    partitions: int = 0
    partition_class_list: List[int] = field(default_factory=list)
    class_dims: List[int] = field(default_factory=list)
    class_subclasses: List[int] = field(default_factory=list)
    class_masterbooks: List[int] = field(default_factory=list)
    subclass_books: List[List[int]] = field(default_factory=list)
    multiplier: int = 1
    x_list: List[int] = field(default_factory=list)

    @classmethod
    def parse(cls, br: BitReader) -> "Floor1":
        f = cls()
        f.partitions = br.read(5)
        f.partition_class_list = [br.read(4) for _ in range(f.partitions)]
        n_classes = max(f.partition_class_list, default=-1) + 1
        for _ in range(n_classes):
            f.class_dims.append(br.read(3) + 1)
            sub = br.read(2)
            f.class_subclasses.append(sub)
            f.class_masterbooks.append(br.read(8) if sub else -1)
            f.subclass_books.append(
                [br.read(8) - 1 for _ in range(1 << sub)])
        f.multiplier = br.read(2) + 1
        rangebits = br.read(4)
        f.x_list = [0, 1 << rangebits]
        for j in range(f.partitions):
            c = f.partition_class_list[j]
            for _ in range(f.class_dims[c]):
                f.x_list.append(br.read(rangebits))
        if len(f.x_list) > 65:
            raise ValueError("floor1 x_list too long")
        # neighbor indices + sort order are static per-floor
        f._order = sorted(range(len(f.x_list)), key=lambda i: f.x_list[i])
        f._lo_nb, f._hi_nb = [], []
        for i in range(2, len(f.x_list)):
            lo = max((j for j in range(i) if f.x_list[j] < f.x_list[i]),
                     key=lambda j: f.x_list[j])
            hi = min((j for j in range(i) if f.x_list[j] > f.x_list[i]),
                     key=lambda j: f.x_list[j])
            f._lo_nb.append(lo)
            f._hi_nb.append(hi)
        return f

    def decode(self, br: BitReader, books: List[Codebook]
               ) -> Optional[List[int]]:
        """Packet-side decode → final_Y posts, or None (channel unused)."""
        if not br.read(1):
            return None
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        ybits = _ilog(rng - 1)
        y = [br.read(ybits), br.read(ybits)]
        for j in range(self.partitions):
            c = self.partition_class_list[j]
            cdim = self.class_dims[c]
            cbits = self.class_subclasses[c]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.class_masterbooks[c]].decode(br)
            for _ in range(cdim):
                book = self.subclass_books[c][cval & csub]
                cval >>= cbits
                y.append(books[book].decode(br) if book >= 0 else 0)
        # amplitude synthesis (§7.2.4 step 1)
        n_pts = len(self.x_list)
        final_y = [0] * n_pts
        step2 = [False] * n_pts
        final_y[0], final_y[1] = y[0], y[1]
        step2[0] = step2[1] = True
        for i in range(2, n_pts):
            lo, hi = self._lo_nb[i - 2], self._hi_nb[i - 2]
            pred = _render_point(self.x_list[lo], final_y[lo],
                                 self.x_list[hi], final_y[hi],
                                 self.x_list[i])
            val = y[i] if i < len(y) else 0
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final_y[i] = val - lowroom + pred
                    else:
                        final_y[i] = pred - val + highroom - 1
                else:
                    final_y[i] = (pred - ((val + 1) >> 1) if val & 1
                                  else pred + (val >> 1))
            else:
                step2[i] = False
                final_y[i] = pred
        self._last_step2 = step2
        return final_y

    def curve(self, final_y: List[int], n2: int) -> np.ndarray:
        """§7.2.4 step 2: render the piecewise-linear dB curve over n2
        spectral bins (rendered in the 0..255 multiplied domain, the
        validated stb/libvorbis formulation)."""
        step2 = self._last_step2
        mult = self.multiplier
        v = np.zeros(n2, np.int32)
        order = self._order
        pts = [(self.x_list[i], final_y[i]) for i in order if step2[i]]
        if not pts:
            return np.zeros(n2, np.float32)
        lx, ly = 0, pts[0][1] * mult
        for px, py in pts[1:]:
            hy = py * mult
            if px >= n2:
                _render_line(lx, ly, px, hy, v, n2)
                lx, ly = px, hy
                break
            _render_line(lx, ly, px, hy, v, n2)
            lx, ly = px, hy
        if lx < n2:
            v[lx:] = min(max(ly, 0), 255)
        return _INV_DB[np.clip(v, 0, 255)]


def _render_point(x0, y0, x1, y1, x):
    dy = y1 - y0
    adx = x1 - x0
    off = abs(dy) * (x - x0) // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, v, n):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    base = int(dy / adx) if adx else 0                 # trunc toward zero
    sy = base - 1 if dy < 0 else base + 1
    ady -= abs(base) * adx
    x = x0
    y = y0
    err = 0
    if 0 <= x < n:
        v[x] = min(max(y, 0), 255)
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = min(max(y, 0), 255)


# --------------------------------------------------------------------------
# residues (§8.6)
# --------------------------------------------------------------------------

@dataclass
class Residue:
    rtype: int = 0
    begin: int = 0
    end: int = 0
    partition_size: int = 0
    classifications: int = 0
    classbook: int = 0
    cascade: List[int] = field(default_factory=list)
    books: List[List[int]] = field(default_factory=list)

    @classmethod
    def parse(cls, br: BitReader, rtype: int) -> "Residue":
        r = cls(rtype=rtype)
        r.begin = br.read(24)
        r.end = br.read(24)
        r.partition_size = br.read(24) + 1
        r.classifications = br.read(6) + 1
        r.classbook = br.read(8)
        for _ in range(r.classifications):
            low = br.read(3)
            high = br.read(5) if br.read(1) else 0
            r.cascade.append(high * 8 + low)
        for c in range(r.classifications):
            row = []
            for p in range(8):
                row.append(br.read(8) if (r.cascade[c] & (1 << p)) else -1)
            r.books.append(row)
        return r

    def decode(self, br: BitReader, books: List[Codebook],
               do_decode: List[bool], n2: int) -> np.ndarray:
        """→ residue vectors [ch, n2] (type 2 de-interleaved here)."""
        ch = len(do_decode)
        if self.rtype == 2:
            out = np.zeros(ch * n2, np.float32)
            if any(do_decode):
                self._decode_core(br, books, [out], [True], ch * n2)
            return out.reshape(-1, ch).T.copy()
        vecs = [np.zeros(n2, np.float32) for _ in range(ch)]
        self._decode_core(br, books, vecs, do_decode, n2)
        return np.stack(vecs)

    def _decode_core(self, br, books, vecs, do_decode, n):
        begin = min(self.begin, n)
        end = min(self.end, n)
        if end <= begin:
            return
        psize = self.partition_size
        classbook = books[self.classbook]
        cw = classbook.dim                               # classwords/group
        n_part = (end - begin) // psize
        n_ch = len(vecs)
        cls = np.zeros((n_ch, n_part + cw), np.int32)
        try:
            for p in range(8):
                pi = 0
                while pi < n_part:
                    if p == 0:
                        for j in range(n_ch):
                            if not do_decode[j]:
                                continue
                            temp = classbook.decode(br)
                            for k in range(cw - 1, -1, -1):
                                cls[j, pi + k] = temp % self.classifications
                                temp //= self.classifications
                    for k in range(cw):
                        if pi >= n_part:
                            break
                        for j in range(n_ch):
                            if not do_decode[j]:
                                continue
                            book = self.books[cls[j, pi]][p]
                            if book < 0:
                                continue
                            self._vq_add(br, books[book], vecs[j],
                                         begin + pi * psize, psize)
                        pi += 1
        except EndOfPacket:
            return                                       # truncated packet

    def _vq_add(self, br, book: Codebook, v, offset, psize):
        dim = book.dim
        if self.rtype == 0:
            step = psize // dim
            rows = [book.decode_vq(br) for _ in range(step)]
            block = np.stack(rows)                       # [step, dim]
            v[offset:offset + psize] += block.T.reshape(-1)
        else:                                            # types 1 and 2
            i = 0
            while i < psize:
                v[offset + i:offset + i + dim] += book.decode_vq(br)
                i += dim


# --------------------------------------------------------------------------
# mappings + modes (§4.2.4)
# --------------------------------------------------------------------------

@dataclass
class Mapping:
    submaps: int = 1
    coupling: List[Tuple[int, int]] = field(default_factory=list)
    mux: List[int] = field(default_factory=list)
    submap_floor: List[int] = field(default_factory=list)
    submap_residue: List[int] = field(default_factory=list)


@dataclass
class Mode:
    blockflag: int = 0
    mapping: int = 0


class VorbisDecoder:
    """Stateful packet decoder for one Vorbis stream."""

    def __init__(self, ident_packet: bytes, setup_packet: bytes):
        import struct as _s
        if ident_packet[:7] != b"\x01vorbis":
            raise ValueError("bad identification packet")
        (_ver, self.channels, self.sample_rate, _bmax, _bnom,
         _bmin) = _s.unpack_from("<IBIiii", ident_packet, 7)
        bs = ident_packet[28]
        self.blocksize0 = 1 << (bs & 0xF)
        self.blocksize1 = 1 << (bs >> 4)
        if setup_packet[:7] != b"\x05vorbis":
            raise ValueError("bad setup packet")
        self._parse_setup(BitReader(setup_packet[7:]))
        self._window_cache: Dict[tuple, np.ndarray] = {}
        self._imdct_cache: Dict[int, np.ndarray] = {}
        self._prev: Optional[np.ndarray] = None          # [ch, n] windowed
        self._prev_n = 0
        self._prev_right_start = 0

    # ---- setup ----
    def _parse_setup(self, br: BitReader):
        self.codebooks = [Codebook(br) for _ in range(br.read(8) + 1)]
        for _ in range(br.read(6) + 1):                  # time transforms
            if br.read(16) != 0:
                raise ValueError("nonzero time transform")
        self.floors: List[Tuple[int, object]] = []
        for _ in range(br.read(6) + 1):
            ft = br.read(16)
            if ft == 1:
                self.floors.append((1, Floor1.parse(br)))
            elif ft == 0:
                # legacy LSP floor: parse to stay in sync, decode raises
                order = br.read(8)
                br.read(16)                              # rate
                br.read(16)                              # bark_map_size
                br.read(6)                               # amplitude bits
                br.read(8)                               # amplitude offset
                nbooks = br.read(4) + 1
                for _ in range(nbooks):
                    br.read(8)
                del order
                self.floors.append((0, None))
            else:
                raise ValueError(f"bad floor type {ft}")
        self.residues = []
        for _ in range(br.read(6) + 1):
            rt = br.read(16)
            if rt not in (0, 1, 2):
                raise ValueError(f"bad residue type {rt}")
            self.residues.append(Residue.parse(br, rt))
        self.mappings: List[Mapping] = []
        ch = self.channels
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise ValueError("bad mapping type")
            m = Mapping()
            m.submaps = br.read(4) + 1 if br.read(1) else 1
            if br.read(1):
                steps = br.read(8) + 1
                bits = _ilog(ch - 1)
                for _ in range(steps):
                    m.coupling.append((br.read(bits), br.read(bits)))
            if br.read(2) != 0:
                raise ValueError("mapping reserved bits set")
            if m.submaps > 1:
                m.mux = [br.read(4) for _ in range(ch)]
            else:
                m.mux = [0] * ch
            for _ in range(m.submaps):
                br.read(8)                               # unused time cfg
                m.submap_floor.append(br.read(8))
                m.submap_residue.append(br.read(8))
            self.mappings.append(m)
        self.modes = []
        for _ in range(br.read(6) + 1):
            bf = br.read(1)
            if br.read(16) != 0 or br.read(16) != 0:
                raise ValueError("bad mode transform")
            self.modes.append(Mode(bf, br.read(8)))
        if not br.read(1):
            raise ValueError("setup framing bit missing")

    # ---- DSP pieces ----
    def _window(self, n, left_start, left_n, right_start, right_n):
        key = (n, left_start, left_n, right_start, right_n)
        w = self._window_cache.get(key)
        if w is None:
            w = np.zeros(n, np.float64)
            i = np.arange(left_n)
            w[left_start:left_start + left_n] = np.sin(
                0.5 * np.pi * np.sin((i + 0.5) / left_n * 0.5 * np.pi) ** 2)
            w[left_start + left_n:right_start] = 1.0
            i = np.arange(right_n)
            w[right_start:right_start + right_n] = np.sin(
                0.5 * np.pi
                * np.sin((i + 0.5) / right_n * 0.5 * np.pi + 0.5 * np.pi) ** 2)
            self._window_cache[key] = w
        return w

    def _imdct(self, spec: np.ndarray, n: int) -> np.ndarray:
        basis = self._imdct_cache.get(n)
        if basis is None:
            k = np.arange(n // 2, dtype=np.float64)
            t = np.arange(n, dtype=np.float64)
            basis = np.cos(np.pi / n * np.outer(t + 0.5 + n / 4,
                                                k + 0.5))
            self._imdct_cache[n] = basis
        return basis @ spec.astype(np.float64).T        # [n, ch]

    # ---- audio packet ----
    def decode_packet(self, packet: bytes) -> Optional[np.ndarray]:
        """One audio packet → finished PCM [ch, out] (None while priming)."""
        br = BitReader(packet)
        try:
            if br.read(1) != 0:
                return None                              # not audio
            bits = _ilog(len(self.modes) - 1)
            mode = self.modes[br.read(bits) if bits else 0]
        except EndOfPacket:
            return None
        mapping = self.mappings[mode.mapping]
        n = self.blocksize1 if mode.blockflag else self.blocksize0
        n0 = self.blocksize0
        prev_flag = next_flag = 1
        if mode.blockflag:
            try:
                prev_flag = br.read(1)
                next_flag = br.read(1)
            except EndOfPacket:
                return None
        # window geometry (§4.3.1)
        if mode.blockflag and not prev_flag:
            left_start = n // 4 - n0 // 4
            left_n = n0 // 2
        else:
            left_start = 0
            left_n = n // 2
        if mode.blockflag and not next_flag:
            right_start = 3 * n // 4 - n0 // 4
            right_n = n0 // 2
        else:
            right_start = n // 2
            right_n = n // 2

        ch = self.channels
        n2 = n // 2
        floor_posts: List[Optional[list]] = [None] * ch
        curves = np.zeros((ch, n2), np.float32)
        no_residue = [True] * ch
        try:
            for c in range(ch):
                ftype, fl = self.floors[
                    mapping.submap_floor[mapping.mux[c]]]
                if ftype == 0:
                    from fyrox_tpu_torch.sound.ogg import UnsupportedCodec
                    raise UnsupportedCodec("floor type 0 (LSP) streams "
                                           "are not supported")
                posts = fl.decode(br, self.codebooks)
                if posts is not None:
                    floor_posts[c] = posts
                    curves[c] = fl.curve(posts, n2)
                    no_residue[c] = False
        except EndOfPacket:
            pass
        # §4.3.2: a coupled pair decodes residue if either side is live
        for (mag, ang) in mapping.coupling:
            if not (no_residue[mag] and no_residue[ang]):
                no_residue[mag] = no_residue[ang] = False

        residue_out = np.zeros((ch, n2), np.float32)
        try:
            for s in range(mapping.submaps):
                sub_ch = [c for c in range(ch) if mapping.mux[c] == s]
                do = [not no_residue[c] for c in sub_ch]
                res = self.residues[mapping.submap_residue[s]]
                out = res.decode(br, self.codebooks, do, n2)
                for k, c in enumerate(sub_ch):
                    residue_out[c] = out[k]
        except EndOfPacket:
            pass

        # inverse coupling (§4.3.5, square polar)
        for (mi, ai) in reversed(mapping.coupling):
            m = residue_out[mi].copy()
            a = residue_out[ai].copy()
            pos_m = m > 0
            pos_a = a > 0
            new_m = np.where(pos_m, np.where(pos_a, m, m + a),
                             np.where(pos_a, m, m - a))
            new_a = np.where(pos_m, np.where(pos_a, m - a, m),
                             np.where(pos_a, m + a, m))
            residue_out[mi] = new_m
            residue_out[ai] = new_a

        # floor * residue; dead channels stay zero
        spec = residue_out * curves
        for c in range(ch):
            if floor_posts[c] is None:
                spec[c] = 0.0

        pcm = self._imdct(spec, n)                       # [n, ch] float64
        w = self._window(n, left_start, left_n, right_start, right_n)
        block = (pcm * w[:, None]).T                     # [ch, n]

        # center-to-center overlap-add (§4.3.9). Timeline: block k+1 sits
        # at O' = O + right_start_prev - left_start_cur (TDAC slope
        # alignment); emitted samples span [prev center, cur center) —
        # count = prev_n/4 + n/4. In local coords: prev contributes
        # indices prev_n/2.., cur contributes start_local.. where
        # start_local = prev_n/2 - right_start_prev + left_start_cur
        # (negative == prev-only lead-in; both reads zero-pad, since the
        # windows are zero outside their support).
        out = None
        if self._prev is not None:
            pn = self._prev_n
            count = pn // 4 + n // 4
            start_local = pn // 2 - self._prev_right_start + left_start
            acc = np.zeros((ch, count), np.float64)
            p0 = pn // 2
            p1 = min(pn, p0 + count)
            acc[:, :p1 - p0] += self._prev[:, p0:p1]
            c0 = max(start_local, 0)
            c1 = min(start_local + count, n)
            if c1 > c0:
                acc[:, c0 - start_local:c1 - start_local] += block[:, c0:c1]
            out = acc.astype(np.float32)
        self._prev = block
        self._prev_n = n
        self._prev_right_start = right_start
        return out


def decode_ogg_vorbis(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a whole Ogg Vorbis stream → (pcm [ch, samples] f32, rate).

    Output length is trimmed to the stream's terminal granule position
    (encoder padding removal, Vorbis-over-Ogg §A.2)."""
    from fyrox_tpu_torch.sound.ogg import read_packets, read_pages
    pages = read_pages(data)
    packets = read_packets(pages)
    if len(packets) < 3:
        raise ValueError("truncated Vorbis stream")
    dec = VorbisDecoder(packets[0], packets[2])
    chunks = []
    for p in packets[3:]:
        out = dec.decode_packet(p)
        if out is not None and out.size:
            chunks.append(out)
    if not chunks:
        return np.zeros((dec.channels, 0), np.float32), dec.sample_rate
    pcm = np.concatenate(chunks, axis=1)
    granule = max((pg.granule for pg in pages if pg.granule >= 0),
                  default=-1)
    if 0 <= granule < pcm.shape[1]:
        pcm = pcm[:, :granule]
    return np.clip(pcm, -1.0, 1.0), dec.sample_rate
