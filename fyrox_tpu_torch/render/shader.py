"""Shader definition resources (the port of
``fyrox_tpu.render.shader``).

Equivalent of the reference's fyrox-material shader system
(fyrox-material/src/shader/mod.rs:594 ShaderDefinition, parsed from
RON-format `.shader` files with named render passes and resource
definitions; the standard definitions under shader/standard/). The port
keeps the resource contract: named passes, texture bindings and typed
property groups with defaults. In place of GLSL source, a pass's
`shade_fn` names a function registered with ``register_shade_fn``, and a
property group's defaults become a dict of tensors that feeds it. The
parser reads the reference's `.shader` files (the RON subset they use);
`vertex_shader` / `fragment_shader` are kept verbatim and not compiled.
The definitions are host objects; ``default_group`` and
``default_properties`` put their tensors on the card unless asked for
another device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fyrox_tpu_torch._util import resolve_device

__all__ = ["ShaderProperty", "ShaderResourceDefinition",
           "RenderPassDefinition", "ShaderDefinition", "parse_ron",
           "standard_shader", "register_shade_fn", "get_shade_fn"]


# --------------------------------------------------------------------------
# mini-RON reader (the subset .shader files use: structs `Name(..)` and
# anonymous `(..)`, lists, strings, numbers, bools, enum variants)
# --------------------------------------------------------------------------

class _Ron:
    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def error(self, msg):
        line = self.s.count("\n", 0, self.i) + 1
        raise ValueError(f"RON parse error at line {line}: {msg}")

    def ws(self):
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in " \t\r\n,":
                self.i += 1
            elif self.s.startswith("//", self.i):
                j = self.s.find("\n", self.i)
                self.i = len(self.s) if j < 0 else j + 1
            elif self.s.startswith("/*", self.i):
                j = self.s.find("*/", self.i)
                if j < 0:
                    self.error("unterminated block comment")
                self.i = j + 2
            else:
                return

    def peek(self):
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def ident(self):
        self.ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] == "_"):
            j += 1
        out, self.i = self.s[self.i:j], j
        return out

    def expect(self, ch):
        self.ws()
        if not self.s.startswith(ch, self.i):
            self.error(f"expected {ch!r}")
        self.i += len(ch)

    def string(self):
        # plain "..." or raw r"..." / r#"..."# (shader sources)
        self.ws()
        hashes = 0
        if self.s[self.i] == "r":
            self.i += 1
            while self.s[self.i] == "#":
                hashes += 1
                self.i += 1
        self.expect('"')
        if hashes:
            end = '"' + "#" * hashes
            j = self.s.find(end, self.i)
            if j < 0:
                self.error("unterminated raw string")
            out, self.i = self.s[self.i:j], j + len(end)
            return out
        out = []
        while True:
            c = self.s[self.i]
            self.i += 1
            if c == "\\":
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}
                           .get(self.s[self.i], self.s[self.i]))
                self.i += 1
            elif c == '"':
                return "".join(out)
            else:
                out.append(c)

    def value(self) -> Any:
        c = self.peek()
        if c == '"' or (c == "r" and self.s[self.i + 1:self.i + 2] in ('"', "#")):
            return self.string()
        if c == "[":
            self.i += 1
            items = []
            while self.peek() != "]":
                items.append(self.value())
            self.i += 1
            return items
        if c == "(":
            return self._struct_body(None)
        if c.isdigit() or c in "+-.":
            j = self.i
            while j < len(self.s) and (self.s[j].isdigit()
                                       or self.s[j] in "+-.eE"):
                j += 1
            tok, self.i = self.s[self.i:j], j
            return float(tok) if any(ch in tok for ch in ".eE") else int(tok)
        name = self.ident()
        if not name:
            self.error(f"unexpected char {c!r}")
        if name == "true":
            return True
        if name == "false":
            return False
        if self.peek() == "(":
            return self._struct_body(name)
        return name                      # bare enum variant (e.g. White)

    def _struct_body(self, name: Optional[str]):
        """`Name( ... )` → dict with "__variant__" = Name; positional
        tuples → list under "__fields__" (or a plain tuple if anonymous)."""
        self.expect("(")
        fields: Dict[str, Any] = {}
        pos: List[Any] = []
        while self.peek() != ")":
            save = self.i
            key = self.ident()
            if key and self.peek() == ":":
                self.i += 1
                fields[key] = self.value()
            else:
                self.i = save
                pos.append(self.value())
        self.i += 1
        if name is None and not fields:
            return tuple(pos)
        if pos:
            fields["__fields__"] = pos
        if name is not None:
            fields["__variant__"] = name
        return fields


def parse_ron(text: str) -> Any:
    """Parse the RON subset used by `.shader` files."""
    p = _Ron(text)
    out = p.value()
    p.ws()
    if p.i != len(p.s):
        p.error("trailing content")
    return out


# --------------------------------------------------------------------------
# definition model (shader/mod.rs:520-620)
# --------------------------------------------------------------------------

# property kind -> (default value builder, shape checker)
_SCALARS = {"Float": 0.0, "Int": 0, "UInt": 0, "Bool": False}
_VECTORS = {"Vector2": 2, "Vector3": 3, "Vector4": 4, "Color": 4}
_MATRICES = {"Matrix2": (2, 2), "Matrix3": (3, 3), "Matrix4": (4, 4)}


@dataclass
class ShaderProperty:
    name: str
    kind: str                       # Float/Int/UInt/Bool/VectorN/MatrixN/...Array
    value: Any = None

    def default_array(self, device="cuda"):
        """The default as a tensor (a leaf of the property group's dict):
        float32, int32 for Int / UInt, bool for Bool."""
        dev = resolve_device(device)
        k, v = self.kind, self.value
        if k in _SCALARS:
            v = _SCALARS[k] if v is None else v
            dt = torch.float32 if k == "Float" else (
                torch.bool if k == "Bool" else torch.int32)
            return torch.tensor(v, dtype=dt, device=dev)
        if k in _VECTORS:
            n = _VECTORS[k]
            if v is None:
                v = (1.0,) * n if k == "Color" else (0.0,) * n
            if k == "Color" and isinstance(v, dict):   # Color(r:..,g:..,..)
                v = tuple(float(v.get(c, 255)) / 255.0 for c in "rgba")
            return torch.tensor(np.asarray(v, np.float32).reshape(n),
                                device=dev)
        if k in _MATRICES:
            shape = _MATRICES[k]
            if v is None:
                return torch.eye(shape[0], dtype=torch.float32, device=dev)
            return torch.tensor(np.asarray(v, np.float32).reshape(shape),
                                device=dev)
        if k.endswith("Array"):
            base = k[:-len("Array")]
            max_len = 0
            vals = v
            if isinstance(v, dict):
                max_len = int(v.get("max_len", 0))
                vals = v.get("value", [])
            vals = [] if vals is None else list(vals)
            n = _VECTORS.get(base, 1)
            arr = np.zeros((max(max_len, len(vals)),) +
                           ((n,) if base in _VECTORS else ()), np.float32)
            for i, item in enumerate(vals):
                arr[i] = np.asarray(item, np.float32)
            return torch.tensor(arr, device=dev)
        raise ValueError(f"unknown shader property kind {k!r}")


@dataclass
class ShaderResourceDefinition:
    name: str
    kind: str                       # "Texture" | "PropertyGroup"
    binding: int = 0
    # Texture:
    texture_kind: str = "Sampler2D"
    fallback: str = "White"
    # PropertyGroup:
    properties: List[ShaderProperty] = field(default_factory=list)

    def default_group(self, device="cuda") -> Dict[str, torch.Tensor]:
        if self.kind != "PropertyGroup":
            raise ValueError(f"{self.name!r} is a {self.kind} resource, "
                             "not a property group")
        return {p.name: p.default_array(device) for p in self.properties}


@dataclass
class RenderPassDefinition:
    name: str
    draw_parameters: Dict[str, Any] = field(default_factory=dict)
    vertex_shader: str = ""         # retained verbatim; not compiled
    fragment_shader: str = ""
    shade_fn: str = ""              # a function of register_shade_fn


@dataclass
class ShaderDefinition:
    """A parsed `.shader` resource (ShaderDefinition, shader/mod.rs:594)."""
    name: str = ""
    passes: List[RenderPassDefinition] = field(default_factory=list)
    resources: List[ShaderResourceDefinition] = field(default_factory=list)
    disabled_passes: List[str] = field(default_factory=list)

    # -- queries (shader/mod.rs:798-818) --
    def find_texture_resource(self, name):
        return next((r for r in self.resources
                     if r.kind == "Texture" and r.name == name), None)

    def find_property_group_resource(self, name):
        return next((r for r in self.resources
                     if r.kind == "PropertyGroup" and r.name == name), None)

    def has_texture_resource(self, name):
        return self.find_texture_resource(name) is not None

    def has_property_group_resource(self, name):
        return self.find_property_group_resource(name) is not None

    def default_properties(self, device="cuda"
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every property group's defaults (a dict of dicts of tensors):
        the starting point of a material's bound state."""
        return {r.name: r.default_group(device) for r in self.resources
                if r.kind == "PropertyGroup"}

    @classmethod
    def from_string(cls, text: str) -> "ShaderDefinition":
        raw = parse_ron(text)
        if not isinstance(raw, dict):
            raise ValueError(".shader root must be a struct")
        passes = []
        for p in raw.get("passes", []):
            passes.append(RenderPassDefinition(
                name=p.get("name", ""),
                draw_parameters=p.get("draw_parameters", {}) or {},
                vertex_shader=p.get("vertex_shader", ""),
                fragment_shader=p.get("fragment_shader", ""),
                shade_fn=p.get("shade_fn", "")))
        resources = []
        for r in raw.get("resources", []):
            kind = r.get("kind", {})
            variant = (kind.get("__variant__", "")
                       if isinstance(kind, dict) else str(kind))
            if variant == "Texture":
                resources.append(ShaderResourceDefinition(
                    name=r.get("name", ""), kind="Texture",
                    binding=int(r.get("binding", 0)),
                    texture_kind=str(kind.get("kind", "Sampler2D")),
                    fallback=str(kind.get("fallback", "White"))))
            elif variant == "PropertyGroup":
                plist = kind.get("__fields__", [None])[0] or []
                props = []
                for p in plist:
                    pk = p.get("kind")
                    if isinstance(pk, dict):
                        kname = pk.get("__variant__", "")
                        # array kinds carry (value, max_len): keep both
                        val = pk if kname.endswith("Array") \
                            else pk.get("value")
                    else:
                        kname, val = str(pk), None
                    props.append(ShaderProperty(name=p.get("name", ""),
                                                kind=kname, value=val))
                resources.append(ShaderResourceDefinition(
                    name=r.get("name", ""), kind="PropertyGroup",
                    binding=int(r.get("binding", 0)), properties=props))
            else:
                raise ValueError(f"unknown resource kind {variant!r}")
        return cls(name=raw.get("name", ""), passes=passes,
                   resources=resources,
                   disabled_passes=list(raw.get("disabled_passes", [])))

    @classmethod
    def from_file(cls, path) -> "ShaderDefinition":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_string(f.read())


# --------------------------------------------------------------------------
# shade-function registry: the stand-in for compiled GLSL passes
# --------------------------------------------------------------------------

_SHADE_FNS: Dict[str, Any] = {}


def register_shade_fn(name: str, fn=None):
    """Register (or decorate) a shade function for pass bindings."""
    if fn is None:
        def deco(f):
            _SHADE_FNS[name] = f
            return f
        return deco
    _SHADE_FNS[name] = fn
    return fn


def get_shade_fn(name: str):
    return _SHADE_FNS.get(name)


def standard_shader() -> ShaderDefinition:
    """The built-in standard PBR definition: same texture bindings and
    property group as shader/standard/standard.shader, with passes bound
    to the deferred pipeline's shade path."""
    props = [
        ShaderProperty("texCoordScale", "Vector2", (1.0, 1.0)),
        ShaderProperty("layerIndex", "UInt", 0),
        ShaderProperty("emissionStrength", "Vector3", (2.0, 2.0, 2.0)),
        ShaderProperty("diffuseColor", "Color", (1.0, 1.0, 1.0, 1.0)),
        ShaderProperty("parallaxCenter", "Float", 0.25),
        ShaderProperty("parallaxScale", "Float", 0.08),
    ]
    textures = ["diffuseTexture", "normalTexture", "metallicTexture",
                "roughnessTexture", "heightTexture", "emissionTexture",
                "lightmapTexture", "aoTexture"]
    resources = [ShaderResourceDefinition(name=t, kind="Texture", binding=i)
                 for i, t in enumerate(textures)]
    resources.append(ShaderResourceDefinition(
        name="properties", kind="PropertyGroup", binding=len(textures),
        properties=props))
    return ShaderDefinition(
        name="StandardShader",
        passes=[RenderPassDefinition(name="GBuffer", shade_fn="deferred"),
                RenderPassDefinition(name="Forward", shade_fn="forward")],
        resources=resources)
