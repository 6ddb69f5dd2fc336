"""PyTorch + CUDA port of the fyrox_tpu batched engine.

The package mirrors ``fyrox_tpu``'s tree: ``fyrox_tpu/scene/graph.py``
lives here as ``fyrox_tpu_torch/scene/graph.py``. It imports ``torch`` and
numpy only — never ``jax`` and never ``fyrox_tpu`` — so it runs on a machine
that has no JAX installed.

Host-side templates (scene topology, physics layout, animation curves) are
numpy, built by the port's own builders; per-world state is ``torch``
tensors with a leading world axis ``W`` on an explicit device. The
hand-written CUDA kernels (the physics step's, and the renderer's tile
raster) live under ``csrc/`` and are built at first use by
``kernels.py``; a CPU tensor always takes the kernel's plain PyTorch
version instead.

Entry points: ``models.build_flagship`` → ``Engine.init_state`` →
``Engine.step``, then ``animation.skinning``; for rendering,
``render.build_render_template`` → ``render.render_frame``.
"""
import torch


def disable_tf32():
    """Keep float32 matrix products and convolutions in full float32 on
    the card. TF32 would move the skinning product by ~1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


__all__ = ["disable_tf32"]
