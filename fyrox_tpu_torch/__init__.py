"""PyTorch + CUDA port of the fyrox_tpu batched engine.

The package mirrors ``fyrox_tpu``'s tree: ``fyrox_tpu/scene/graph.py``
lives here as ``fyrox_tpu_torch/scene/graph.py``. It imports ``torch`` and
numpy only — never ``jax`` and never ``fyrox_tpu`` — so it runs on a machine
that has no JAX installed.

The package also carries the engine's audio (``sound/``: the mixer,
Sound and Listener nodes, the bus graph and the binaural path;
``Engine.render_audio``). Host-side templates (scene topology, physics
layout, animation curves) are
numpy, built by the port's own builders; per-world state is ``torch``
tensors with a leading world axis ``W`` on an explicit device. The
hand-written CUDA kernels (the physics step's, and the renderer's tile
raster) live under ``csrc/`` and are built at first use by
``kernels.py``; a CPU tensor always takes the kernel's plain PyTorch
version instead.

Entry points: ``models.build_flagship`` → ``Engine.init_state`` →
``Engine.step``, then ``animation.skinning``; for rendering,
``render.build_render_template`` → ``render.render_frame`` (or
``render.CapturedFrame``, one CUDA graph a frame). The game-logic layer on
top: ``script.Executor`` runs ``script.Script`` s (``scripts``: the stock
camera controllers) between fixed-timestep ticks; ``utils`` holds
pathfinding (``astar``, ``navmesh``, the batched ``navagent``), behavior
trees, the lightmap bake and ``stats``; ``ui.UserInterface`` lays out a
widget tree fed by OS events (``input.InputState`` accumulates the same
events), ``ui.render_ui`` paints its draw list on the host (TrueType text
through ``ui.font``) and ``ui.Hud`` draws per-world overlays, both laid
over frames by ``ui.compose_over``; ``io.checkpoint``
saves and resumes states; ``engine.debug_step`` is the checked tick.
The content path runs on the host: ``io.load_scene`` (.rgs),
``io.gltf.load_gltf``, ``sound.ogg.load_ogg``, ``scene.tilemap`` and the
``resource.ResourceManager`` that loads them by extension; on top of them
``editor.EditorSession``, ``plugin.PluginHost`` and the ``tools`` CLI.
"""
import torch


def disable_tf32():
    """Keep float32 matrix products and convolutions in full float32 on
    the card. TF32 would move the skinning product by ~1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


__all__ = ["disable_tf32"]
