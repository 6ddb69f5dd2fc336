"""Textures and materials (the port's copy of ``fyrox_tpu.render.texture``).

Equivalent of fyrox-texture (image decode into GPU-agnostic `Texture`
resources, lib.rs:44, mip generation included) and fyrox-material
(`Material` = shader + property bindings, fyrox-material/src/lib.rs:41-83).
Textures are host numpy arrays with a mip chain; sampling is a batched
bilinear gather on the device of the tensors it is given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["Texture", "load_texture", "Material", "sample_bilinear",
           "sample_array_bilinear", "resize_bilinear"]


@dataclass
class Texture:
    """[H, W, 4] float32 base level + box-filtered mip chain."""
    mips: List[np.ndarray]

    @property
    def base(self):
        return self.mips[0]

    @property
    def size(self):
        return self.mips[0].shape[1], self.mips[0].shape[0]

    @staticmethod
    def from_array(rgba: np.ndarray, build_mips: bool = True) -> "Texture":
        rgba = np.asarray(rgba, np.float32)
        if rgba.ndim == 2:
            rgba = np.repeat(rgba[..., None], 4, -1)
        if rgba.shape[-1] == 3:
            rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], -1)
        mips = [rgba]
        if build_mips:
            cur = rgba
            while min(cur.shape[0], cur.shape[1]) > 1:
                h2, w2 = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
                cur = cur[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2, 4).mean(
                    (1, 3))
                mips.append(cur)
        return Texture(mips)


def load_texture(path: str) -> Texture:
    """Decode an image file: binary PPM (P6) natively; any other format
    through PIL, which is imported only then and whose absence raises."""
    if path.lower().endswith(".ppm"):
        with open(path, "rb") as f:
            if f.readline().strip() != b"P6":
                raise ValueError(f"{path}: not a binary (P6) PPM file")
            dims = f.readline().split()
            w, h = int(dims[0]), int(dims[1])
            f.readline()
            data = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)
        return Texture.from_array(data.astype(np.float32) / 255.0)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only PPM files decode without PIL, and "
                          "PIL is not installed") from e
    img = Image.open(path).convert("RGBA")
    return Texture.from_array(np.asarray(img, np.float32) / 255.0)


def _bilinear(fetch, size, uv):
    """Bilinear filter of fetch(y, x) over a wrapping size x size grid
    (``texture.py:72-92``)."""
    h, w = size
    u = torch.remainder(uv[..., 0], 1.0) * w - 0.5
    v = torch.remainder(uv[..., 1], 1.0) * h - 0.5
    x0 = torch.floor(u).to(torch.int32)
    y0 = torch.floor(v).to(torch.int32)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    c00 = fetch(y0, x0)
    c10 = fetch(y0, x0 + 1)
    c01 = fetch(y0 + 1, x0)
    c11 = fetch(y0 + 1, x0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_bilinear(tex, uv):
    """Bilinear sample: tex [H, W, C] tensor, uv [..., 2] in [0, 1]
    (wrapping) → [..., C]."""
    h, w = tex.shape[0], tex.shape[1]

    def at(y, x):
        return tex[torch.remainder(y, h).long(), torch.remainder(x, w).long()]

    return _bilinear(at, (h, w), uv)


def sample_array_bilinear(tex_array, tid, uv):
    """Bilinear sample from a texture array: tex_array [NT, R, R, C], tid
    [...] int layer, uv [..., 2] in [0, 1] (wrapping) → [..., C]. One flat
    gather over (layer, y, x): the deferred pass's per-pixel material
    fetch (``texture.py:95``)."""
    nt, r = tex_array.shape[0], tex_array.shape[1]
    flat = tex_array.reshape(nt * r * r, tex_array.shape[-1])
    tid = tid.long()

    def at(y, x):
        return flat[(tid * r + torch.remainder(y, r)) * r
                    + torch.remainder(x, r)]

    return _bilinear(at, (r, r), uv)


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Host-side bilinear resize of [H, W, C] to [size, size, C] (texture
    array packing normalises every scene texture to one resolution)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    c00 = img[y0][:, x0]
    c10 = img[y0][:, x1]
    c01 = img[y1][:, x0]
    c11 = img[y1][:, x1]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


@dataclass
class Material:
    """Shader properties + texture bindings (fyrox-material lib.rs:41-83).
    The 'standard' material maps straight onto the G-buffer channels."""
    name: str = "standard"
    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    metallic: float = 0.0
    roughness: float = 0.8
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    textures: Dict[str, Texture] = field(default_factory=dict)
    properties: Dict[str, float] = field(default_factory=dict)

    def bind(self, name: str, tex: Texture):
        self.textures[name] = tex
        return self

    def set_property(self, name: str, value: float):
        self.properties[name] = value
        return self
