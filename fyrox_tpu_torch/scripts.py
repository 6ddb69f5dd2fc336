"""Stock scripts: the fyrox-scripts crate, batched (the port's
``fyrox_tpu.scripts``).

``FlyingCameraController`` is fyrox-scripts/src/camera.rs:47 (mouse-look
yaw / pitch with pitch limits and keyboard translation, writing the camera
node's local transform every tick); ``OrbitCameraController`` is the
editor's orbit camera (yaw / pitch / radius around a target). Each keeps
its yaw, pitch (and radius) as [W] tensors, takes per-world inputs, and
writes the camera node's column of the scene's local position and rotation
into new tensors: the state it was given is not written.
"""
from __future__ import annotations

import numpy as np
import torch

from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.script import Script, ScriptContext

__all__ = ["FlyingCameraController", "OrbitCameraController"]


def _yaw_pitch_quat(yaw, pitch):
    """World yaw (local Y) then local pitch (rotated X): the composition of
    camera.rs:288-294."""
    zero = torch.zeros_like(yaw)
    half_y = yaw * 0.5
    qy = torch.stack([zero, torch.sin(half_y), zero, torch.cos(half_y)], -1)
    half_p = pitch * 0.5
    qp = torch.stack([torch.sin(half_p), zero, zero, torch.cos(half_p)], -1)
    return quat.mul(qy, qp)


def _input(x, like):
    """A per-world input as float32 on `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def _with_column(x, node, value):
    """x [W, N, D] with column `node` replaced by value [W, D], as a new
    tensor."""
    out = x.clone()
    out[:, node] = value
    return out


class FlyingCameraController(Script):
    """Batched camera.rs:47 FlyingCameraController.

    node: camera node index; speed: translation m/s; sensitivity: radians
    per mouse unit; pitch_limit: (lo, hi) radians (camera.rs:146, ±89.9°
    by default). Feed inputs with ``set_input(mouse_delta [W,2],
    move_axes [W,2])`` (move_axes = (strafe, forward) in [-1, 1], the WASD
    axes); on_update integrates yaw / pitch and writes the node's local
    rotation and position. State on `device`, the card unless asked
    otherwise."""

    def __init__(self, node, num_worlds, speed=5.0, sensitivity=3e-3,
                 pitch_limit=(-np.deg2rad(89.9), np.deg2rad(89.9)),
                 device="cuda"):
        self.node = int(node)
        self.speed = float(speed)
        self.sensitivity = float(sensitivity)
        self.pitch_limit = (float(pitch_limit[0]), float(pitch_limit[1]))
        z = torch.zeros(num_worlds, device=device)
        self.yaw, self.pitch = z, z.clone()
        self._mouse = torch.zeros((num_worlds, 2), device=device)
        self._move = torch.zeros((num_worlds, 2), device=device)

    def set_input(self, mouse_delta=None, move_axes=None):
        if mouse_delta is not None:
            self._mouse = _input(mouse_delta, self.yaw)
        if move_axes is not None:
            self._move = _input(move_axes, self.yaw)

    def on_update(self, ctx: ScriptContext):
        sc = ctx.state.scene
        # camera.rs:228-231: yaw -= dx·s; pitch clamped
        self.yaw = self.yaw - self._mouse[:, 0] * self.sensitivity
        self.pitch = torch.clamp(
            self.pitch + self._mouse[:, 1] * self.sensitivity,
            self.pitch_limit[0], self.pitch_limit[1])
        q = _yaw_pitch_quat(self.yaw, self.pitch)           # [W,4]
        # translation in the camera's yaw frame (forward / side from the
        # look vector, its vertical part ignored)
        zero = torch.zeros_like(self.yaw)
        sy, cy = torch.sin(self.yaw), torch.cos(self.yaw)
        fwd = torch.stack([sy, zero, cy], -1)
        right = torch.stack([cy, zero, -sy], -1)
        vel = (right * self._move[:, :1] + fwd * self._move[:, 1:2]) \
            * (self.speed * ctx.dt)
        pos = _with_column(sc.position, self.node,
                           sc.position[:, self.node] + vel)
        rot = _with_column(sc.rotation, self.node, q)
        ctx.state = ctx.state._replace(scene=sc._replace(position=pos,
                                                         rotation=rot))


class OrbitCameraController(Script):
    """Batched orbit camera (the editor's scene view): yaw / pitch / radius
    around a per-world target; the mouse orbits, the wheel zooms. Writes
    the camera node's local transform (position on the orbit sphere,
    rotation looking at the target). State on `device`, the card unless
    asked otherwise."""

    def __init__(self, node, num_worlds, target=(0.0, 0.0, 0.0),
                 radius=5.0, sensitivity=3e-3,
                 pitch_limit=(-np.deg2rad(89.0), np.deg2rad(89.0)),
                 device="cuda"):
        self.node = int(node)
        self.sensitivity = float(sensitivity)
        self.pitch_limit = (float(pitch_limit[0]), float(pitch_limit[1]))
        z = torch.zeros(num_worlds, device=device)
        self.yaw, self.pitch = z, z.clone()
        self.radius = torch.full((num_worlds,), float(radius), device=device)
        self.target = _input(target, z).expand(num_worlds, 3)
        self._mouse = torch.zeros((num_worlds, 2), device=device)
        self._zoom = torch.zeros(num_worlds, device=device)

    def set_input(self, mouse_delta=None, zoom=None, target=None):
        if mouse_delta is not None:
            self._mouse = _input(mouse_delta, self.yaw)
        if zoom is not None:
            self._zoom = _input(zoom, self.yaw)
        if target is not None:
            self.target = _input(target, self.yaw)

    def on_update(self, ctx: ScriptContext):
        sc = ctx.state.scene
        self.yaw = self.yaw - self._mouse[:, 0] * self.sensitivity
        self.pitch = torch.clamp(
            self.pitch + self._mouse[:, 1] * self.sensitivity,
            self.pitch_limit[0], self.pitch_limit[1])
        self.radius = torch.clamp(self.radius * (1.0 - self._zoom * 0.1),
                                  min=0.05)
        q = _yaw_pitch_quat(self.yaw, self.pitch)
        # the camera at target - look · radius; cameras look along their
        # +Z basis (scene/camera.py view_matrix, camera.rs:454-460)
        z_axis = torch.zeros_like(q[:, :3])
        z_axis[:, 2] = 1.0
        look = quat.rotate(q, z_axis)
        pos_v = self.target - look * self.radius[:, None]
        pos = _with_column(sc.position, self.node, pos_v)
        rot = _with_column(sc.rotation, self.node, q)
        ctx.state = ctx.state._replace(scene=sc._replace(position=pos,
                                                         rotation=rot))
