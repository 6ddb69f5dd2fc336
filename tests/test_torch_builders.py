"""Port parity: the port's host builders produce the JAX package's
templates array for array; the port imports without JAX; its kernel
loader fails loudly where the CUDA toolkit is absent."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu_torch import kernels
from fyrox_tpu_torch.models import build_flagship as torch_build_flagship
from fyrox_tpu_torch.physics import (BALL, CUBOID, HALFSPACE, PhysicsBuilder,
                                     init_physics_state, step_physics)
from fyrox_tpu_torch.physics import fused_step, plane_ops, tgs_kernel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(n_bones=10, n_verts=300, n_bodies=192)
# a pile too large for one shared-memory block of K1 (tgs_kernel.smem_bytes)
BIG_FLAGSHIP = dict(n_bones=10, n_verts=300, n_bodies=2000)


@pytest.fixture(scope="module")
def flagships():
    return (jax_build_flagship(**FLAGSHIP), torch_build_flagship(**FLAGSHIP))


@pytest.fixture(scope="module")
def big_flagships():
    return (jax_build_flagship(**BIG_FLAGSHIP),
            torch_build_flagship(**BIG_FLAGSHIP))


def _same(a, b, what):
    if isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, (str, int, float, bool)):
        assert a == b, what
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (what, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=what)


SCENE_FIELDS = ("parent", "node_type", "names", "levels", "depth", "payload",
                "init_position", "init_rotation", "init_scale",
                "init_visibility", "init_enabled", "init_lifetime",
                "init_pre_rotation", "init_post_rotation",
                "init_rotation_offset", "init_rotation_pivot",
                "init_scaling_offset", "init_scaling_pivot",
                "local_bbox_min", "local_bbox_max")
PHYS_FIELDS = ("body_node", "body_type", "inv_mass", "inv_inertia_local",
               "com_local", "lin_damping", "ang_damping", "gravity_scale",
               "col_body", "col_shape", "col_params", "col_pos", "col_rot",
               "col_friction", "col_restitution", "col_node", "lin_lock",
               "ang_lock", "init_body_pos", "init_body_rot", "erp",
               "allowed_linear_error", "max_corrective_velocity",
               "restitution_threshold", "n_substeps", "n_pgs",
               "n_stabilization", "warmstart_coefficient", "mass_split_pow",
               "gravity", "broadphase_period")
# the JAX config's one-hot incidence matrices (inc_gc, inc_gb) feed MXU
# gathers on the TPU; the port indexes instead and does not carry them
SLAB_FIELDS = ("grid_cols", "big_cols", "cell", "s_class", "kinds", "cls_tab",
               "present", "sweep_cap", "num_colliders", "num_bodies", "s_walk",
               "s_active")
ANIM_FIELDS = ("length", "speed", "looping", "names", "pos_curves",
               "pos_node", "pos_anim", "rot_curves", "rot_node", "rot_anim",
               "scl_curves", "scl_node", "scl_anim")
MACHINE_FIELDS = ("state_anim", "state_names", "entry_state", "t_from",
                  "t_to", "t_param", "t_invert", "t_duration", "param_names",
                  "state_clips", "state_weights")


PARTS = [("template", SCENE_FIELDS), ("physics", PHYS_FIELDS),
         ("slab", SLAB_FIELDS), ("animations", ANIM_FIELDS),
         ("machine", MACHINE_FIELDS)]


@pytest.mark.parametrize("part,fields,pair", [
    pytest.param(p, f, "flagships", id=f"{p}-fields{i}")
    for i, (p, f) in enumerate(PARTS)] + [
    pytest.param(p, f, "big_flagships", id=f"{p}-2000-bodies")
    for p, f in PARTS])
def test_flagship_templates_equal(request, part, fields, pair):
    (je, _), (te, _) = request.getfixturevalue(pair)

    def get(e):
        return e.physics.grid if part == "slab" else getattr(e, part)

    for f in fields:
        _same(getattr(get(je), f), getattr(get(te), f), f"{part}.{f}")
    if part == "template":
        _same(je.template.cameras, te.template.cameras, "cameras")


@pytest.mark.parametrize("part,fields", [("physics", PHYS_FIELDS),
                                         ("slab", SLAB_FIELDS)])
def test_reuse_flagship_templates_equal(monkeypatch, part, fields):
    """build_flagship(broadphase_period=4) against the JAX package's
    flagship under FYROX_SLAB_BP_PERIOD=4: the period, windows (16, 8, 12)
    and walk 64."""
    monkeypatch.setenv("FYROX_SLAB_BP_PERIOD", "4")
    for k in ("FYROX_SLAB_WINDOW", "FYROX_SLAB_WALK", "FYROX_SLAB_ACTIVE"):
        monkeypatch.delenv(k, raising=False)
    je, _ = jax_build_flagship(**FLAGSHIP)
    te, _ = torch_build_flagship(**FLAGSHIP, broadphase_period=4)
    get = (lambda e: e.physics.grid) if part == "slab" else \
        (lambda e: e.physics)
    for f in fields:
        _same(getattr(get(je), f), getattr(get(te), f), f"{part}.{f}")
    assert te.physics.broadphase_period == 4
    assert (te.physics.grid.s_class, te.physics.grid.s_walk) == ((16, 0, 12),
                                                                 64)


def test_big_flagship_steps_on_the_fused_route(big_flagships):
    """The 2,000-body flagship (past one shared-memory block of K1 on the
    card) takes the fused route and steps: 2 ticks at W = 1 on the CPU,
    finite, with its dynamic bodies moving."""
    _, (te, _) = big_flagships
    t = te.physics
    assert fused_step.supports_fused_bp(t) and t.num_bodies == 2001
    assert tgs_kernel._layout(t.num_bodies, int(t.grid.grid_cols.size),
                              int(t.grid.s_active), False, 0)[0]
    st = te.init_state(1, device="cpu")
    p0 = st.physics.position.clone()
    for _ in range(2):
        st = te.step(st)
    pos = st.physics.position
    dyn = torch.as_tensor(t.body_type == 0)
    assert torch.isfinite(pos).all() and torch.isfinite(st.physics.linvel).all()
    assert (pos - p0)[0, dyn].norm(dim=-1).min() > 0


def test_flagship_skin_equal(flagships):
    (_, jskin), (_, tskin) = flagships
    for f in ("bones", "vertices", "bone_indices", "bone_weights"):
        _same(getattr(jskin, f), getattr(tskin, f), f"skin.{f}")
    _same(jskin.dense_weights(), tskin.dense_weights(), "dense_weights")
    # the inverse bind poses come from each package's own hierarchy pass
    # and a float64 inverse: float32 rounding of the bind globals only
    np.testing.assert_allclose(jskin.inv_bind, tskin.inv_bind, rtol=0,
                               atol=1e-6)


def test_port_imports_and_builds_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["fyrox_tpu"] = None
        import fyrox_tpu_torch
        from fyrox_tpu_torch import convert, engine, kernels
        from fyrox_tpu_torch.models import build_flagship
        from fyrox_tpu_torch.physics import fused_step
        e, skin = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
        st = e.init_state(2, device="cpu")
        assert fused_step.supports_fused_bp(e.physics)
        st = e.step(st)
        st = e.step(st, fused=False)
        from fyrox_tpu_torch.physics import plane_ops, slab2
        r, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192,
                              broadphase_period=4)
        rs = r.init_state(2, device="cpu")
        rs = r.step(r.step(rs, bp_rank="count"), fused=False, bp_rank="count")
        assert rs.physics.bp_age.tolist() == [1, 1]
        assert plane_ops.launches("plane_scatter") == 0
        assert slab2.bp_demand_stats(r.physics, rs.physics, period=4)
        assert slab2.overflow_stats(r.physics, rs.physics)
        from fyrox_tpu_torch import render
        from fyrox_tpu_torch.core import aabb, frustum
        from fyrox_tpu_torch.render import tile_raster
        from fyrox_tpu_torch.scene import SceneBuilder, camera, graph
        from fyrox_tpu_torch.scene import init_state
        sb = SceneBuilder()
        sb.add_mesh(render.make_plane(20.0))
        sb.add_mesh(render.make_sphere(0.5), position=(0.0, 0.5, 0.0))
        sb.add_light("directional", rotation=(0.5, 0.0, 0.0, 0.866))
        sb.add_camera("cam", position=(0, 4.0, -8.0),
                      rotation=(0.2, 0.0, 0.0, 0.98))
        t = sb.build()
        ws = graph.update_hierarchical_data(init_state(t, 2, device="cpu"),
                                            t)
        color, _ = render.render_frame(
            ws, t, render.build_render_template(t),
            render.RenderConfig(width=32, height=32,
                                csm=render.CsmConfig(map_size=32)))
        assert color.shape == (2, 32, 32, 3) and color.abs().sum() > 0
        assert tile_raster.launches("full") == 0
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax",
               "jaxlib", "fyrox_tpu")]
        assert all(sys.modules[m] is None for m in bad), bad
        print("ok", st.physics.position.shape)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok torch.Size([2, 193, 3])" in out.stdout


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.library()


def _plain_tick_launches(fused):
    plane_ops.reset_launches()
    tgs_kernel.reset_launches()
    fused_step.reset_launches()
    e, _ = torch_build_flagship(**FLAGSHIP)
    st = e.step(e.init_state(1, device="cpu"), fused=fused)
    assert torch.isfinite(st.physics.position).all()
    return (plane_ops.launches("plane_gather"), tgs_kernel.launches(),
            fused_step.launches("fused_bp"),
            fused_step.launches("narrow_compact"))


def test_cpu_tensors_take_the_plain_versions():
    assert _plain_tick_launches(fused=True) == (0, 0, 0, 0)


def test_cpu_staged_route_takes_the_plain_versions():
    assert _plain_tick_launches(fused=False) == (0, 0, 0, 0)


@pytest.mark.parametrize("case", ["joint", "dense", "com", "shape"])
def test_out_of_scope_features_raise(case):
    """What the port does not run raises. Joints and centre-of-mass
    offsets run on the staged route; still out of scope are more joints
    than the TGS kernel holds (the JAX package's XLA joint passes) and
    COM offsets on the fused kernels' own entry point."""
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=1)
    pb.add_collider(g, HALFSPACE, [])
    for i in range(3):
        b = pb.add_body(position=(i, 1.0, 0.0))
        pb.add_collider(b, BALL if i % 2 else CUBOID, [0.2, 0.2, 0.2],
                        offset=(0.1, 0, 0) if case == "com" else (0, 0, 0))
    with pytest.raises(NotImplementedError):
        if case == "joint":
            for _ in range(tgs_kernel.MAX_KERNEL_JOINTS + 1):
                pb.add_joint(0, 1, 2)
            t = pb.build()
            step_physics(init_physics_state(pb.initial_pose(), t, 1,
                                            device="cpu"), t, 1 / 60)
        elif case == "com":
            t = pb.build()
            st = init_physics_state(pb.initial_pose(), t, 1, device="cpu")
            zero = torch.zeros_like(st.linvel)
            fused_step.fused_full_step(st, t, 1 / 60, zero, zero)
        elif case == "dense":
            pb.build(broadphase="dense")
        elif case == "shape":
            pb.add_collider(g, 6, [])       # CONVEX
        else:
            pb.build()
