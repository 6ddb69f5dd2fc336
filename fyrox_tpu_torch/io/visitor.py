"""Fyrox Visitor-format (de)serialization — .rgs files (the port's copy of
``fyrox_tpu.io.visitor``; host only).

Binary-compatible reader/writer for the reference's node-based serializer
(fyrox-core/src/visitor/): magic "FBAF" + u32 version header
(visitor/mod.rs:482, 277 of writer/binary.rs), then a stack-order stream of
nodes — each node is (name: u32-len + bytes, field count: u32, fields,
child count: u32); the writer pushes children and pops the stack, so records
arrive in reversed-child DFS order (writer/binary.rs:275-285) and the reader
mirrors that stack discipline exactly.

Field tag table copied from writer/binary.rs:49-255 (ids 1..50). Vectors
and matrices little-endian; Matrix3/4 in nalgebra's column-major iteration
order.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["VisitorNode", "Field", "read_rgs", "write_rgs", "MAGIC_BINARY",
           "CURRENT_VERSION"]

MAGIC_BINARY = b"FBAF"
MAGIC_BINARY_LEGACY = b"RG3D"   # pre-2.0 scenes (no version word)
MAGIC_ASCII = b"FTAX"
CURRENT_VERSION = 1

# tag → (struct format, count) for scalar/vector types
_SCALARS = {
    1: ("<B", "u8"), 2: ("<b", "i8"), 3: ("<H", "u16"), 4: ("<h", "i16"),
    5: ("<I", "u32"), 6: ("<i", "i32"), 7: ("<Q", "u64"), 8: ("<q", "i64"),
    9: ("<f", "f32"), 10: ("<d", "f64"),
}
# vector tags: tag → (element struct char, n, kind-name)
_VECTORS = {
    11: ("f", 3, "vec3f32"), 17: ("f", 2, "vec2f32"), 18: ("f", 4, "vec4f32"),
    23: ("d", 2, "vec2f64"), 24: ("d", 3, "vec3f64"), 25: ("d", 4, "vec4f64"),
    26: ("b", 2, "vec2i8"), 27: ("b", 3, "vec3i8"), 28: ("b", 4, "vec4i8"),
    29: ("B", 2, "vec2u8"), 30: ("B", 3, "vec3u8"), 31: ("B", 4, "vec4u8"),
    32: ("h", 2, "vec2i16"), 33: ("h", 3, "vec3i16"), 34: ("h", 4, "vec4i16"),
    35: ("H", 2, "vec2u16"), 36: ("H", 3, "vec3u16"), 37: ("H", 4, "vec4u16"),
    38: ("i", 2, "vec2i32"), 39: ("i", 3, "vec3i32"), 40: ("i", 4, "vec4i32"),
    41: ("I", 2, "vec2u32"), 42: ("I", 3, "vec3u32"), 43: ("I", 4, "vec4u32"),
    44: ("q", 2, "vec2i64"), 45: ("q", 3, "vec3i64"), 46: ("q", 4, "vec4i64"),
    47: ("Q", 2, "vec2u64"), 48: ("Q", 3, "vec3u64"), 49: ("Q", 4, "vec4u64"),
}
_KIND_TO_TAG = {name: tag for tag, (_, _, name) in _VECTORS.items()}


@dataclass
class Field:
    name: str
    kind: str       # 'u8'..'f64', 'bool', 'quat', 'mat4', 'mat3', 'mat2',
                    # 'blob', 'uuid', 'complex', 'pod', 'string', 'vec*'
    value: Any


@dataclass
class VisitorNode:
    name: str
    fields: List[Field] = field(default_factory=list)
    children: List["VisitorNode"] = field(default_factory=list)

    def child(self, name: str) -> Optional["VisitorNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def field_value(self, name: str, default=None):
        for f in self.fields:
            if f.name == name:
                return f.value
        return default

    def add(self, name: str, kind: str, value) -> "VisitorNode":
        self.fields.append(Field(name, kind, value))
        return self


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def take(self, n):
        v = self.d[self.o:self.o + n]
        if len(v) != n:
            raise EOFError("truncated visitor stream")
        self.o += n
        return v

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def scalar(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def name(self):
        n = self.u32()
        return self.take(n).decode("utf-8", errors="replace")

    def read_field(self) -> Field:
        fname = self.name()
        tag = self.take(1)[0]
        if tag in _SCALARS:
            fmt, kind = _SCALARS[tag]
            return Field(fname, kind, self.scalar(fmt))
        if tag in _VECTORS:
            ch, n, kind = _VECTORS[tag]
            fmt = "<" + ch * n
            vals = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
            return Field(fname, kind, np.asarray(vals))
        if tag == 12:   # UnitQuaternion (i,j,k,w) == our xyzw
            vals = struct.unpack("<4f", self.take(16))
            return Field(fname, "quat", np.asarray(vals, np.float32))
        if tag == 13:   # Matrix4 column-major
            vals = struct.unpack("<16f", self.take(64))
            return Field(fname, "mat4", np.asarray(vals, np.float32)
                         .reshape(4, 4).T)
        if tag == 16:   # Matrix3
            vals = struct.unpack("<9f", self.take(36))
            return Field(fname, "mat3", np.asarray(vals, np.float32)
                         .reshape(3, 3).T)
        if tag == 22:   # Matrix2
            vals = struct.unpack("<4f", self.take(16))
            return Field(fname, "mat2", np.asarray(vals, np.float32)
                         .reshape(2, 2).T)
        if tag == 14:   # BinaryBlob
            n = self.u32()
            return Field(fname, "blob", self.take(n))
        if tag == 15:
            return Field(fname, "bool", bool(self.take(1)[0]))
        if tag == 19:
            return Field(fname, "uuid", self.take(16))
        if tag == 20:
            vals = struct.unpack("<2f", self.take(8))
            return Field(fname, "complex", np.asarray(vals, np.float32))
        if tag == 21:   # PodArray
            type_id = self.take(1)[0]
            elem_size = self.u32()
            nbytes = struct.unpack("<Q", self.take(8))[0]
            return Field(fname, "pod", (type_id, elem_size, self.take(nbytes)))
        if tag == 50:   # String
            n = self.u32()
            return Field(fname, "string", self.take(n).decode("utf-8",
                                                              errors="replace"))
        raise ValueError(f"unknown visitor field tag {tag} for '{fname}'")


def read_rgs(data: bytes) -> Tuple[VisitorNode, int]:
    """Parse a binary .rgs blob → (root node, version)."""
    r = _Reader(data)
    magic = r.take(4)
    if data[:5] == MAGIC_ASCII + b":":
        return _read_ascii(data)
    if magic == MAGIC_ASCII:
        raise ValueError("FTAX magic without ':' separator — truncated or "
                         "corrupt ASCII visitor stream")
    if magic == MAGIC_BINARY_LEGACY:
        version = 0
    elif magic == MAGIC_BINARY:
        version = r.u32()
    else:
        raise ValueError(f"not a Fyrox visitor stream (magic {magic!r})")

    def read_record():
        name = r.name()
        node = VisitorNode(name)
        nfields = r.u32()
        for _ in range(nfields):
            node.fields.append(r.read_field())
        nchildren = r.u32()
        return node, nchildren

    root, n = read_record()
    # mirror the writer's stack: children arrive last-pushed-first
    stack = [(root, n)]
    while stack:
        parent, remaining = stack.pop()
        if remaining == 0:
            continue
        stack.append((parent, remaining - 1))
        node, n = read_record()
        # writer pops the LAST child first → prepend to restore order
        parent.children.insert(0, node)
        stack.append((node, n))
    return root, version


def _write_field(out: bytearray, f: Field):
    name = f.name.encode("utf-8")
    out += struct.pack("<I", len(name)) + name
    k, v = f.kind, f.value
    for tag, (fmt, kind) in _SCALARS.items():
        if kind == k:
            out.append(tag)
            out += struct.pack(fmt, v)
            return
    if k in _KIND_TO_TAG:
        tag = _KIND_TO_TAG[k]
        ch, n, _ = _VECTORS[tag]
        out.append(tag)
        out += struct.pack("<" + ch * n, *np.asarray(v).reshape(n).tolist())
        return
    if k == "quat":
        out.append(12)
        out += struct.pack("<4f", *np.asarray(v, np.float32).tolist())
        return
    if k == "mat4":
        out.append(13)
        out += struct.pack("<16f", *np.asarray(v, np.float32).T.reshape(16).tolist())
        return
    if k == "mat3":
        out.append(16)
        out += struct.pack("<9f", *np.asarray(v, np.float32).T.reshape(9).tolist())
        return
    if k == "mat2":
        out.append(22)
        out += struct.pack("<4f", *np.asarray(v, np.float32).T.reshape(4).tolist())
        return
    if k == "blob":
        out.append(14)
        out += struct.pack("<I", len(v)) + bytes(v)
        return
    if k == "bool":
        out.append(15)
        out.append(1 if v else 0)
        return
    if k == "uuid":
        out.append(19)
        out += bytes(v)
        return
    if k == "complex":
        out.append(20)
        out += struct.pack("<2f", *np.asarray(v, np.float32).tolist())
        return
    if k == "pod":
        type_id, elem_size, data = v
        out.append(21)
        out.append(type_id)
        out += struct.pack("<I", elem_size) + struct.pack("<Q", len(data)) + bytes(data)
        return
    if k == "string":
        b = v.encode("utf-8")
        out.append(50)
        out += struct.pack("<I", len(b)) + b
        return
    raise ValueError(f"unknown field kind {k}")


_ASCII_VEC_KINDS = set(_KIND_TO_TAG)


def _parse_ascii_value(kind: str, text: str):
    import base64
    if kind == "bool":
        return text.strip() == "true"
    if kind in ("u8", "i8", "u16", "i16", "u32", "i32", "u64", "i64"):
        return int(text)
    if kind in ("f32", "f64"):
        return float(text)
    if kind in _ASCII_VEC_KINDS or kind in ("quat", "complex"):
        return np.asarray([float(x) for x in text.split(";")])
    if kind in ("mat2", "mat3", "mat4"):
        n = {"mat2": 2, "mat3": 3, "mat4": 4}[kind]
        vals = np.asarray([float(x) for x in text.split(";")], np.float32)
        return vals.reshape(n, n).T   # column-major stream
    if kind == "uuid":
        import uuid as uuid_mod
        return uuid_mod.UUID(text.strip()).bytes
    if kind == "data":
        return base64.b64decode(text.strip())
    if kind == "podarray":
        parts = text.split(";")
        return (int(parts[0]), int(parts[1]),
                base64.b64decode(parts[2].strip()) if len(parts) > 2 and parts[2].strip() else b"")
    if kind == "str":
        return text  # already unescaped by the tokenizer
    raise ValueError(f"unknown ascii field kind {kind}")


def _read_ascii(data: bytes):
    """Parse the FTAX ASCII visitor format (writer/ascii.rs)."""
    text = data.decode("utf-8", errors="replace")
    assert text.startswith("FTAX:")
    semi = text.index(";")
    version = int(text[5:semi])
    i = semi + 1
    n = len(text)

    def skip_ws(j):
        while j < n and text[j] in " \t\r\n":
            j += 1
        return j

    def parse_node(j):
        j = skip_ws(j)
        # node name up to '['
        k = text.index("[", j)
        node = VisitorNode(text[j:k].strip())
        j = k + 1
        # fields until matching ']'
        while True:
            j = skip_ws(j)
            if text[j] == "]":
                j += 1
                break
            lt = text.index("<", j)
            fname = text[j:lt].strip()
            colon = text.index(":", lt)
            kind = text[lt + 1:colon]
            j = colon + 1
            if kind == "str":
                # quoted, with \" and \n escapes
                assert text[j] == '"'
                j += 1
                buf = []
                while True:
                    c = text[j]
                    if c == "\\" and j + 1 < n and text[j + 1] in '"n':
                        buf.append('"' if text[j + 1] == '"' else "\n")
                        j += 2
                    elif c == '"':
                        j += 1
                        break
                    else:
                        buf.append(c)
                        j += 1
                assert text[j] == ">"
                j += 1
                node.fields.append(Field(fname, "string", "".join(buf)))
            else:
                gt = text.index(">", j)
                raw = text[j:gt]
                j = gt + 1
                kk = {"data": "blob", "podarray": "pod"}.get(kind, kind)
                node.fields.append(Field(fname, kk, _parse_ascii_value(kind, raw)))
        j = skip_ws(j)
        if j < n and text[j] == "{":
            j += 1
            while True:
                j = skip_ws(j)
                if text[j] == "}":
                    j += 1
                    break
                child, j = parse_node(j)
                node.children.append(child)
        return node, j

    root, _ = parse_node(i)
    return root, version


def write_rgs(root: VisitorNode, version: int = CURRENT_VERSION) -> bytes:
    """Serialize a node tree to the binary visitor format (round-trips with
    read_rgs and with the reference reader)."""
    out = bytearray()
    out += MAGIC_BINARY
    out += struct.pack("<I", version)
    stack = [root]
    while stack:
        node = stack.pop()
        name = node.name.encode("utf-8")
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<I", len(node.fields))
        for f in node.fields:
            _write_field(out, f)
        out += struct.pack("<I", len(node.children))
        stack.extend(node.children)
    return bytes(out)
