"""Scene tooling CLI: scaffold projects, inspect and diff .rgs scenes (the
port's copy of ``fyrox_tpu.tools``).

The editor-equivalent tooling surface for a headless workflow (the
reference ships FyroxEd + a `fyrox-template` CLI; this engine's authoring
path is builders + .rgs/glTF/FBX import, so the tooling operates on
those):

    python -m fyrox_tpu_torch.tools new my_game [--2d|--3d] [--dir PATH]
                                                    # scaffold a project
    python -m fyrox_tpu_torch.tools inspect scene.rgs    # node tree + payloads
    python -m fyrox_tpu_torch.tools diff a.rgs b.rgs     # changed nodes/fields

`new` mirrors the reference template generator
(template/src/main.rs:22-40: init --name --style 2d|3d, starter scenes
template-core/src/{2d,3d}.rgs): it emits a runnable Python package on
``fyrox_tpu_torch`` with a Plugin, a starter scene built through
SceneBuilder + PhysicsBuilder, an Executor game loop (on the card unless
the caller passes another device), and a headless smoke test on the CPU.
"""
from __future__ import annotations

import os
import re
import sys

import numpy as np

from fyrox_tpu_torch.io.inheritance import TRACKED_FIELDS
from fyrox_tpu_torch.io.rgs_scene import load_scene
from fyrox_tpu_torch.scene.template import NodeType

__all__ = ["inspect_scene", "diff_scenes", "new_project", "main"]


def _fmt_vec(v):
    return "(" + ", ".join(f"{float(x):.3g}" for x in np.asarray(v)) + ")"


def inspect_scene(template, out=None):
    """Print the node hierarchy with types, transforms and payload info."""
    out = out or sys.stdout
    n = template.num_nodes
    children = {}
    roots = []
    for i in range(n):
        p = int(template.parent[i])
        if p < 0:
            roots.append(i)
        else:
            children.setdefault(p, []).append(i)

    def walk(i, depth):
        t = NodeType(int(template.node_type[i])).name
        name = template.names[i] if i < len(template.names) else f"node{i}"
        pos = _fmt_vec(template.init_position[i])
        extra = ""
        if not template.init_visibility[i]:
            extra += " [hidden]"
        if not template.init_enabled[i]:
            extra += " [disabled]"
        out.write(f"{'  ' * depth}#{i} {name} <{t}> pos={pos}{extra}\n")
        for c in children.get(i, []):
            walk(c, depth + 1)

    out.write(f"scene: {n} nodes, {len(template.meshes or [])} meshes, "
              f"{len((template.lights or {}).get('node', []))} lights, "
              f"{len((template.cameras or {}).get('node', []))} cameras\n")
    for r in roots:
        walk(r, 0)


def diff_scenes(a, b, out=None):
    """Field-level diff of two SceneTemplates (by node index); returns the
    number of differences (useful as an exit code)."""
    out = out or sys.stdout
    n_diff = 0
    if a.num_nodes != b.num_nodes:
        out.write(f"node count: {a.num_nodes} -> {b.num_nodes}\n")
        n_diff += 1
    n = min(a.num_nodes, b.num_nodes)
    for i in range(n):
        name = a.names[i] if i < len(a.names) else f"node{i}"
        if int(a.node_type[i]) != int(b.node_type[i]):
            out.write(f"#{i} {name}: node_type {int(a.node_type[i])} -> "
                      f"{int(b.node_type[i])}\n")
            n_diff += 1
        if int(a.parent[i]) != int(b.parent[i]):
            out.write(f"#{i} {name}: parent {int(a.parent[i])} -> "
                      f"{int(b.parent[i])}\n")
            n_diff += 1
        for f in TRACKED_FIELDS:
            va = np.asarray(getattr(a, f)[i])
            vb = np.asarray(getattr(b, f)[i])
            if not np.allclose(va, vb, atol=1e-7):
                out.write(f"#{i} {name}: {f} {_fmt_vec(np.atleast_1d(va))} -> "
                          f"{_fmt_vec(np.atleast_1d(vb))}\n")
                n_diff += 1
    if n_diff == 0:
        out.write("scenes identical (tracked fields)\n")
    return n_diff


def _load(path):
    return load_scene(path)


_GAME_3D = '''"""{name} — generated by `python -m fyrox_tpu_torch.tools new`.

Starter 3D scene (template-core/src/3d.rgs equivalent): camera, ground
plane, a lit dynamic cube, and a Plugin whose update hook you own.
"""
import numpy as np

from fyrox_tpu_torch.engine import Engine
from fyrox_tpu_torch.physics import world as physics
from fyrox_tpu_torch.physics import shapes
from fyrox_tpu_torch.plugin import Plugin
from fyrox_tpu_torch.render import make_cube, make_plane
from fyrox_tpu_torch.scene import SceneBuilder
from fyrox_tpu_torch.scene.template import NodeType


def build_game(num_worlds: int = 1, device: str = "cuda"):
    """Construct the starter scene -> (Engine, EngineState), the state on
    `device` (the card unless told otherwise)."""
    sb = SceneBuilder()
    sb.add_mesh(make_plane(20.0, albedo=(0.4, 0.5, 0.4)), name="ground")
    cube_node = sb.add_node("cube", node_type=NodeType.RIGID_BODY,
                            position=(0.0, 3.0, 0.0),
                            bbox=(np.full(3, -0.5), np.full(3, 0.5)))
    sb.add_mesh(make_cube(1.0, albedo=(0.8, 0.3, 0.2)), name="cube_mesh",
                parent=cube_node)
    tilt = (np.sin(np.pi / 5), 0.0, 0.0, np.cos(np.pi / 5))
    sb.add_light("directional", rotation=tilt, intensity=1.5)
    sb.add_camera("camera", position=(0.0, 3.0, -8.0))

    pb = physics.PhysicsBuilder()
    ground = pb.add_body(body_type=physics.BodyType.STATIC)
    pb.add_collider(ground, shapes.HALFSPACE, [0, 0, 0])
    body = pb.add_body(node=cube_node, position=(0.0, 3.0, 0.0))
    pb.add_collider(body, shapes.CUBOID, [0.5, 0.5, 0.5], friction=0.6)

    engine = Engine(template=sb.build(), physics=pb.build())
    return engine, engine.init_state(num_worlds, device=device)


class GamePlugin(Plugin):
    """Your per-tick game logic (Plugin::update equivalent)."""

    def update(self, context, dt: float) -> None:
        pass  # drive input/AI/gameplay here
'''

_GAME_2D = '''"""{name} — generated by `python -m fyrox_tpu_torch.tools new`.

Starter 2D scene (template-core/src/2d.rgs equivalent): ortho-style
camera, a dynamic z-locked body (rapier2d twin), and a Plugin stub.
"""
import numpy as np

from fyrox_tpu_torch.engine import Engine
from fyrox_tpu_torch.physics import world as physics
from fyrox_tpu_torch.physics.dim2 import Physics2DBuilder
from fyrox_tpu_torch.plugin import Plugin
from fyrox_tpu_torch.scene import SceneBuilder
from fyrox_tpu_torch.scene.template import NodeType


def build_game(num_worlds: int = 1, device: str = "cuda"):
    """Construct the starter scene -> (Engine, EngineState), the state on
    `device` (the card unless told otherwise)."""
    sb = SceneBuilder()
    player = sb.add_node("player", node_type=NodeType.RIGID_BODY_2D,
                         position=(0.0, 3.0, 0.0),
                         bbox=(np.full(3, -0.5), np.full(3, 0.5)))
    sb.add_sprite("player_sprite", parent=player, size=0.5,
                  color=(0.9, 0.7, 0.2))
    sb.add_camera("camera", position=(0.0, 2.0, -10.0))

    pb = Physics2DBuilder()
    ground = pb.add_body(body_type=physics.BodyType.STATIC)
    pb.add_halfspace(ground)
    body = pb.add_body(node=player, position=(0.0, 3.0))
    pb.add_circle(body, 0.5)

    engine = Engine(template=sb.build(), physics=pb.build())
    return engine, engine.init_state(num_worlds, device=device)


class GamePlugin(Plugin):
    """Your per-tick game logic (Plugin::update equivalent)."""

    def update(self, context, dt: float) -> None:
        pass  # drive input/AI/gameplay here
'''

_MAIN_PY = '''"""Run {name} headless for a few seconds of simulated time on the card
(`python -m {name}.main [SECONDS] [DEVICE]`)."""
import sys

from fyrox_tpu_torch.script import Executor

from {name}.game import build_game


def main(duration_s: float = 3.0, device: str = "cuda"):
    engine, state = build_game(num_worlds=1, device=device)
    ex = Executor(engine, state)
    state = ex.run(duration_s)
    print(f"{name}: ran {{round(duration_s / ex.dt)}} ticks on {{device}}")
    return 0


if __name__ == "__main__":
    sys.exit(main(float(sys.argv[1]) if len(sys.argv) > 1 else 3.0,
                  sys.argv[2] if len(sys.argv) > 2 else "cuda"))
'''

_TEST_PY = '''"""Smoke test: the generated game runs 60 headless ticks green on the
CPU."""
import torch

from fyrox_tpu_torch.script import Executor

from {name}.game import build_game


def _leaves(tree):
    """The state's tensors, depth first (engine.world_health's walk)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for field in tree for leaf in _leaves(field)]
    return []


def test_sixty_ticks():
    engine, state = build_game(num_worlds=1, device="cpu")
    ex = Executor(engine, state)
    state = ex.run(1.0)                      # 60 ticks at 60 Hz
    # NaN only: +inf is a legitimate sentinel (node lifetimes)
    assert not any(torch.isnan(x).any() for x in _leaves(state)
                   if x.is_floating_point())
'''

_README = '''# {name}

Generated by `python -m fyrox_tpu_torch.tools new {name} --{style}`.

- `{name}/game.py` — scene construction + your `GamePlugin`
- `{name}/main.py` — headless Executor loop (`python -m {name}.main`)
- `tests/` — smoke test (`python -m pytest tests/ -q`)
'''


def new_project(name: str, style: str = "3d", directory: str = ".") -> str:
    """Scaffold a runnable game package; returns the project root path.

    Mirrors the reference template generator (template/src/main.rs:22-40;
    starter content template-core/src/{2d,3d}.rgs)."""
    if not re.fullmatch(r"[a-zA-Z_][a-zA-Z0-9_]*", name):
        raise ValueError(f"project name must be a valid Python package "
                         f"identifier, got {name!r}")
    if style not in ("2d", "3d"):
        raise ValueError(f"style must be '2d' or '3d', got {style!r}")
    root = os.path.join(os.path.abspath(directory), name)
    if os.path.exists(root):
        raise FileExistsError(f"{root} already exists")
    pkg = os.path.join(root, name)
    os.makedirs(pkg)
    os.makedirs(os.path.join(root, "tests"))
    game_src = (_GAME_3D if style == "3d" else _GAME_2D).format(name=name)
    with open(os.path.join(pkg, "__init__.py"), "w") as f:
        f.write(f'"""The {name} game package."""\n')
    with open(os.path.join(pkg, "game.py"), "w") as f:
        f.write(game_src)
    with open(os.path.join(pkg, "main.py"), "w") as f:
        f.write(_MAIN_PY.format(name=name))
    with open(os.path.join(root, "tests", "test_smoke.py"), "w") as f:
        f.write(_TEST_PY.format(name=name))
    with open(os.path.join(root, "README.md"), "w") as f:
        f.write(_README.format(name=name, style=style))
    return root


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("inspect", "diff", "new"):
        sys.stderr.write(__doc__)
        return 2
    if argv[0] == "new":
        rest = argv[1:]
        style = "3d"
        directory = "."
        args = []
        i = 0
        while i < len(rest):
            a = rest[i]
            if a in ("--2d", "--3d"):
                style = a[2:]
            elif a == "--dir":
                i += 1
                directory = rest[i]
            else:
                args.append(a)
            i += 1
        if len(args) != 1:
            sys.stderr.write("usage: new NAME [--2d|--3d] [--dir PATH]\n")
            return 2
        root = new_project(args[0], style=style, directory=directory)
        print(f"created {root} ({style})")
        return 0
    if argv[0] == "inspect":
        inspect_scene(_load(argv[1]))
        return 0
    n = diff_scenes(_load(argv[1]), _load(argv[2]))
    return 1 if n else 0


if __name__ == "__main__":
    raise SystemExit(main())
