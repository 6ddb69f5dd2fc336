"""Skeletal skinning batched over worlds (mesh/mod.rs:781-792, 509-519).

``skin_positions_dense`` turns the sparse [V,4] bone weights into a
static dense [V,B] matrix, so skinning is one product [V,B] @ [W,B,12]
followed by an elementwise apply. That product is a plain large matrix
multiply and stays ``torch.matmul`` (the JAX package has no kernel for it
either); TF32 must be off on the card (``fyrox_tpu_torch.disable_tf32``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fyrox_tpu_torch._util import const

__all__ = ["SkinTemplate", "bone_matrices", "skin_positions_dense"]


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


def bone_matrices(globals_, skin: SkinTemplate):
    """[W,B,4,4] skinning matrices = bone_global @ inv_bind."""
    dev = globals_.device
    bg = globals_[:, const(skin.bones, dev).long()]
    ib = const(skin.inv_bind, dev)[None]
    return torch.sum(bg[..., :, :, None] * ib[..., None, :, :], -2)


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
