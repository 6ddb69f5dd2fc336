"""Ogg/Vorbis container support (the port's copy of
``fyrox_tpu.sound.ogg``, host only).

The reference decodes Vorbis through symphonia's all-codecs feature
(fyrox-sound/Cargo.toml:26). This module provides the Ogg page/packet
demuxer (RFC 3533 framing) and the Vorbis identification + comment
header parsers; `decode()` runs the full from-spec Vorbis I DSP in
fyrox_tpu_torch.sound.vorbis (floor1 + residue 0/1/2 + square-polar coupling
+ IMDCT) and returns float32 PCM. Streams this build cannot decode
(floor-0/LSP legacy encodings) raise UnsupportedCodec.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["OggPage", "VorbisInfo", "UnsupportedCodec", "read_pages",
           "read_packets", "vorbis_info", "decode"]

_CAPTURE = b"OggS"


class UnsupportedCodec(NotImplementedError):
    pass


@dataclass
class OggPage:
    version: int
    header_type: int          # bit0 continued, bit1 BOS, bit2 EOS
    granule: int
    serial: int
    seq: int
    segments: List[bytes]

    @property
    def is_bos(self):
        return bool(self.header_type & 0x02)

    @property
    def is_eos(self):
        return bool(self.header_type & 0x04)


def read_pages(data: bytes) -> List[OggPage]:
    """Parse all Ogg pages (RFC 3533 framing)."""
    pages = []
    i = 0
    while i < len(data):
        j = data.find(_CAPTURE, i)
        if j < 0:
            break
        if j + 27 > len(data):
            break
        (ver, htype, granule, serial, seq, _crc,
         nsegs) = struct.unpack_from("<BBqIIIB", data, j + 4)
        lacing = data[j + 27:j + 27 + nsegs]
        body = j + 27 + nsegs
        segs = []
        for L in lacing:
            segs.append(data[body:body + L])
            body += L
        pages.append(OggPage(ver, htype, granule, serial, seq, segs))
        i = body
    return pages


def read_packets(pages: List[OggPage]) -> List[bytes]:
    """Reassemble logical packets from page segments (255-lacing rule)."""
    packets = []
    cur = b""
    for p in pages:
        # lacing values were consumed into segments; a segment shorter
        # than 255 ends a packet
        idx = 0
        for seg in p.segments:
            cur += seg
            if len(seg) < 255:
                packets.append(cur)
                cur = b""
            idx += 1
    if cur:
        packets.append(cur)
    return packets


@dataclass
class VorbisInfo:
    channels: int
    sample_rate: int
    bitrate_nominal: int
    vendor: str = ""
    comments: Dict[str, str] = field(default_factory=dict)


def vorbis_info(data: bytes) -> VorbisInfo:
    """Parse the Vorbis identification (+comment) headers from an Ogg
    stream (Vorbis I spec §4.2.2/.3)."""
    packets = read_packets(read_pages(data))
    if not packets or packets[0][:7] != b"\x01vorbis":
        raise ValueError("not an Ogg Vorbis stream")
    ident = packets[0]
    (version, channels, rate, _br_max, br_nom,
     _br_min) = struct.unpack_from("<IBIiii", ident, 7)
    if version != 0:
        raise ValueError(f"unsupported vorbis version {version}")
    info = VorbisInfo(channels=channels, sample_rate=rate,
                      bitrate_nominal=br_nom)
    if len(packets) > 1 and packets[1][:7] == b"\x03vorbis":
        c = packets[1]
        off = 7
        vlen = struct.unpack_from("<I", c, off)[0]
        off += 4
        info.vendor = c[off:off + vlen].decode("utf-8", "replace")
        off += vlen
        n = struct.unpack_from("<I", c, off)[0]
        off += 4
        for _ in range(n):
            clen = struct.unpack_from("<I", c, off)[0]
            off += 4
            entry = c[off:off + clen].decode("utf-8", "replace")
            off += clen
            if "=" in entry:
                k, v = entry.split("=", 1)
                info.comments[k.upper()] = v
    return info


def decode(data: bytes):
    """Full Vorbis DSP decode → (pcm [channels, samples] float32, rate).

    Raises UnsupportedCodec for floor-0 (legacy LSP) streams and
    ValueError for malformed/truncated containers."""
    vorbis_info(data)                  # validates the stream up front
    from fyrox_tpu_torch.sound.vorbis import decode_ogg_vorbis
    return decode_ogg_vorbis(data)


def load_ogg(path: str):
    """Decode an .ogg file to mono float32 (resource-pipeline loader,
    mixing to mono like sound/engine.load_wav)."""
    import numpy as _np
    with open(path, "rb") as f:
        pcm, _rate = decode(f.read())
    return pcm.mean(axis=0).astype(_np.float32)
