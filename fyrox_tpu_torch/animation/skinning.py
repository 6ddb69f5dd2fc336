"""Skeletal skinning batched over worlds (mesh/mod.rs:781-792, 509-519),
and blend shapes (morph targets, mesh/mod.rs:357-360).

``skin_positions_gather`` is the per-vertex form: each vertex gathers its
4 bone matrices. ``skin_positions_dense`` turns the sparse [V,4] bone weights into a
static dense [V,B] matrix, so skinning is one product [V,B] @ [W,B,12]
followed by an elementwise apply. That product is a plain large matrix
multiply and stays ``torch.matmul`` (the JAX package has no kernel for it
either); TF32 must be off on the card (``fyrox_tpu_torch.disable_tf32``).
``apply_blend_shapes`` is one product over the shape axis, also a plain
``torch.matmul``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fyrox_tpu_torch._util import const

__all__ = ["SkinTemplate", "apply_blend_shapes", "bone_matrices",
           "skin_positions_gather", "skin_positions_dense"]


@dataclass
class SkinTemplate:
    bones: np.ndarray         # [B] scene node index of each bone
    inv_bind: np.ndarray      # [B,4,4] f32 inverse bind poses
    vertices: np.ndarray      # [V,3] f32 bind-pose positions
    bone_indices: np.ndarray  # [V,4] int32
    bone_weights: np.ndarray  # [V,4] f32 (normalized)

    _dense_weights: np.ndarray = None

    @property
    def num_bones(self):
        return int(self.bones.shape[0])

    @property
    def num_vertices(self):
        return int(self.vertices.shape[0])

    def dense_weights(self) -> np.ndarray:
        if self._dense_weights is None:
            v, b = self.num_vertices, self.num_bones
            dw = np.zeros((v, b), np.float32)
            rows = np.repeat(np.arange(v), 4)
            np.add.at(dw, (rows, self.bone_indices.reshape(-1)),
                      self.bone_weights.reshape(-1))
            self._dense_weights = dw
        return self._dense_weights


def _on(x, device):
    """A host constant (numpy) as a cached device tensor; a tensor as is."""
    return x if isinstance(x, torch.Tensor) else const(x, device)


def apply_blend_shapes(vertices, shape_deltas, weights):
    """Morph targets mixed into base vertices before skinning: vertices
    [V,3], shape_deltas [S,V,3] (numpy constants or tensors), weights
    [W,S] in percent ([0, 100], as the reference's). Returns [W,V,3]."""
    dev = weights.device
    deltas = _on(shape_deltas, dev)
    w = weights / 100.0
    morphed = w @ deltas.reshape(deltas.shape[0], -1)
    return _on(vertices, dev)[None] + morphed.reshape(w.shape[0], -1, 3)


def bone_matrices(globals_, skin: SkinTemplate):
    """[W,B,4,4] skinning matrices = bone_global @ inv_bind."""
    dev = globals_.device
    bg = globals_[:, const(skin.bones, dev).long()]
    ib = const(skin.inv_bind, dev)[None]
    return torch.sum(bg[..., :, :, None] * ib[..., None, :, :], -2)


def skin_positions_gather(bone_mats, skin: SkinTemplate):
    """[W,V,3] skinned positions, per vertex: v' = Σ_k w_k (M[i_k] @ v)."""
    dev = bone_mats.device
    idx = const(skin.bone_indices, dev).long()           # [V,4]
    wts = const(skin.bone_weights, dev)                  # [V,4]
    verts = const(skin.vertices, dev)                    # [V,3]
    m = bone_mats[:, idx]                                # [W,V,4,4,4]
    blended = torch.sum(m * wts[None, :, :, None, None], dim=2)
    return (torch.sum(blended[..., :3, :3] * verts[None, :, None, :], -1)
            + blended[..., :3, 3])


def skin_positions_dense(bone_mats, skin: SkinTemplate):
    """[W,V,3] skinned positions via the dense-weight product."""
    w, b = bone_mats.shape[:2]
    dev = bone_mats.device
    # one [V,B] @ [B, W*12] product (the weights are shared by all worlds)
    affine = bone_mats[:, :, :3, :].reshape(w, b, 12).transpose(0, 1)
    dw = const(skin.dense_weights(), dev)                     # [V,B]
    blended = (dw @ affine.reshape(b, w * 12)).reshape(
        -1, w, 3, 4).transpose(0, 1)                          # [W,V,3,4]
    verts = const(skin.vertices, dev)
    return torch.sum(blended[..., :3] * verts[None, :, None, :], -1) \
        + blended[..., 3]
