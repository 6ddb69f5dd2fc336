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
from fyrox_tpu.physics import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu_torch import kernels
from fyrox_tpu_torch.models import build_flagship as torch_build_flagship
from fyrox_tpu_torch.physics import (BALL, CUBOID, HALFSPACE, PhysicsBuilder,
                                     init_physics_state, step_physics)
from fyrox_tpu_torch.physics import fused_step, plane_ops, tgs_kernel
from fyrox_tpu_torch.physics import shapes as sh

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


@pytest.mark.parametrize("nb,nj,s,want", [
    (1001, 0, 16, (False, False)),       # the flagship
    (1097, 76, 16, (False, False)),      # the jointed flagship
    (2001, 0, 16, (True, False)),        # 2,000 bodies
    (1281, 1024, 16, (False, True)),     # the chain forest
    (2001, 1024, 16, (True, False)),     # both: the tables fit alone
    (2001, 2000, 16, (True, True)),
    (1001, 0, 10_000, None)])            # one collider's slots do not fit
def test_k1_layout_moves_joint_tables_out_before_body_planes(nb, nj, s, want):
    """K1's layout from the shapes alone (Cg = nb - 1, COM offsets where
    there are joints): everything in shared memory where it fits, else the
    joint tables out first, then the body planes, then both; a slot buffer
    too short for one collider raises."""
    cg, com = nb - 1, nj > 0
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            tgs_kernel._layout(nb, cg, s, com, nj)
        return
    big, jglobal, tile = tgs_kernel._layout(nb, cg, s, com, nj)
    assert (big, jglobal) == want and tile >= max(s, 128)
    used = (0 if big else tgs_kernel._world_smem_floats(nb, cg, com)) + (
        0 if jglobal else (tgs_kernel.JTAB_ROWS + 14) * nj)
    assert 4 * (used + 6 * tile) <= tgs_kernel.SMEM_LIMIT
    assert (big or jglobal) == (tgs_kernel.smem_bytes(nb, cg, com, nj, s)
                                > tgs_kernel.SMEM_LIMIT)


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
        import torch
        torch.set_num_threads(2)           # as the test files run torch
        # no quiet fallback: a loader that fails to import fails the
        # resource manager's import
        sys.modules["fyrox_tpu_torch.io.gltf"] = None
        try:
            import fyrox_tpu_torch.resource
            raise SystemExit("resource imported without its glTF loader")
        except ImportError:
            del sys.modules["fyrox_tpu_torch.io.gltf"]
        import fyrox_tpu_torch
        from fyrox_tpu_torch import convert, engine, kernels
        from fyrox_tpu_torch.models import build_flagship
        from fyrox_tpu_torch.physics import fused_step
        e, skin = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
        st = e.init_state(2, device="cpu")
        assert fused_step.supports_fused_bp(e.physics)
        st = e.step(st)
        st = e.step(st, fused=False)
        st = e.rollout(st, 2)
        assert engine.world_health(st).all()
        import bench_torch, chip_smoke      # the card's scripts
        from fyrox_tpu_torch.physics import plane_ops, slab2
        r, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192,
                              broadphase_period=4)
        rs = r.init_state(2, device="cpu")
        rs = r.step(r.step(rs, bp_rank="count"), fused=False, bp_rank="count")
        assert rs.physics.bp_age.tolist() == [1, 1]
        assert plane_ops.launches("plane_scatter") == 0
        assert slab2.bp_demand_stats(r.physics, rs.physics, period=4)
        assert slab2.overflow_stats(r.physics, rs.physics)
        from fyrox_tpu_torch.animation import (blendspace, player,
                                               rootmotion, skinning,
                                               spritesheet)
        from fyrox_tpu_torch.core import threefry
        from fyrox_tpu_torch.io import fbx
        from fyrox_tpu_torch.models import make_character_fbx
        from fyrox_tpu_torch.scene import particles
        fe, fskin = build_flagship(n_bodies=24, real_asset=make_character_fbx(
            n_bones=6, n_verts=160))
        fe.particles = particles.ParticleTemplate(max_particles=16)
        fs = fe.rollout(fe.init_state(2, device="cpu"), 2)
        assert fe.machine is None and int(fs.particles.step) == 2
        assert skinning.skin_positions_gather(skinning.bone_matrices(
            fs.scene.globals_, fskin), fskin).shape == (2, 160, 3)
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
        from fyrox_tpu_torch.render import (occlusion, skybox, texture,
                                            transparent, volumetric)
        lib = chip_smoke.render_lib()
        ft = chip_smoke.features_scene(lib, n_obj=4, tex_size=16,
                                       n_sprites=2)
        fs = graph.update_hierarchical_data(init_state(ft, 2, device="cpu"),
                                            ft)
        frt = render.build_render_template(ft)
        for mode in ("homogeneous", "clipped"):
            kw = chip_smoke.features_config(lib, size=32)
            kw.update(raster_mode=mode, spot_shadow_size=32,
                      point_shadow_size=16, occlusion_size=16)
            fcfg = render.RenderConfig(csm=render.CsmConfig(map_size=32),
                                       **kw)
            fc, _, caps = render.render_frame_demand(fs, ft, frt, fcfg)
            assert fc.shape == (2, 32, 32, 3) and len(caps) == 12
        cc, _ = render.render_frames_chunked(fs, ft, frt, fcfg, world_chunk=1)
        assert cc.shape == fc.shape and tile_raster.launches("depth") == 0
        import numpy as np
        from fyrox_tpu_torch.core import color
        from fyrox_tpu_torch.physics import (PhysicsBuilder, broadphase,
                                             init_physics_state,
                                             step_physics)
        from fyrox_tpu_torch.scene import brush, terrain
        from fyrox_tpu_torch.sound import binaural, bus
        ae, _ = build_flagship(n_bones=4, n_verts=40, n_bodies=4,
                               with_audio=True)
        aus = ae.rollout(ae.init_state(2, device="cpu"), 2)
        block, aus = ae.render_audio(aus, block_len=64)
        assert block.shape == (2, 64, 2) and bool(aus.audio.playing.all())
        gpb = PhysicsBuilder()
        gpb.add_collider(gpb.add_body(body_type=1), 5, [])
        for i in range(6):
            gpb.add_collider(gpb.add_body(position=(0.3 * i, 1.0, 0.0)), 0,
                             [0.2])
        gt = gpb.build(broadphase="grid")
        gs = init_physics_state(gpb, gt, 2, device="cpu")
        gs = step_physics(step_physics(gs, gt, 1 / 60), gt, 1 / 60)
        assert broadphase.broadphase_stats(gt, gs)[0]["cap"] > 0
        g = bus.BusGraph.build([dict(parent=-1), dict(
            parent=0, effects=[("reverb", 0.5)])])
        out, _ = bus.process(g, torch.zeros(2, 8, 2),
                             bus.init_state(g, device="cpu"))
        assert out.shape == (8, 2)
        assert binaural.render_block_binaural(
            torch.ones(1, 32), torch.zeros(1), torch.ones(1),
            block_len=32).shape == (32, 2)
        assert color.to_rgba8(torch.ones(4)).tolist() == [255] * 4
        assert brush.apply_stroke(torch.zeros(8, 8), brush.Brush(),
                                  [(4.0, 4.0)]).max() > 0
        assert len(terrain.add_chunked_terrain(
            SceneBuilder(), terrain.Terrain(np.zeros((9, 9), np.float32)),
            chunks=(2, 1))) == 2
        from fyrox_tpu_torch.render import (CapturedFrame, post, probe,
                                            raster, shader, ssao)
        frame = CapturedFrame(t, render.build_render_template(t),
                              render.RenderConfig(width=16, height=16,
                                  csm=render.CsmConfig(map_size=16)))
        assert frame(ws)[0].shape == (2, 16, 16, 3) and not frame.graphs
        g = raster.rasterize(torch.zeros(1, 3, 4), {k: torch.zeros(1, 3, 3)
            for k in ("albedo", "normal", "position", "emission")} | {
            "material": torch.zeros(1, 3, 2)}, 8, 8)
        assert not g.mask.any()
        faces = probe.capture_probe(torch.zeros(1, 3, 3), {
            k: torch.zeros(1, 3, 3) for k in ("albedo", "normal",
                                              "position", "emission")} | {
            "material": torch.zeros(1, 3, 2)}, torch.zeros(3), face_size=4)
        assert probe.prefilter_specular(faces, out_size=2).shape == (
            4, 6, 2, 2, 3)
        assert post.post_process(torch.ones(1, 8, 8, 3)).shape == (1, 8, 8,
                                                                    3)
        assert ssao.compute_ssao(g, torch.eye(4), torch.zeros(3)).shape == (
            8, 8)
        assert shader.standard_shader().default_properties(device="cpu")
        from fyrox_tpu_torch.core import aabb, frustum, quat, transform
        from fyrox_tpu_torch.io import fbx
        assert aabb.volume(*aabb.unit(device="cpu")) == 1.0
        assert quat.identity(device="cpu")[3] == 1.0
        assert transform.mat4_identity(device="cpu").trace() == 4.0
        assert camera.view_projection(ws.globals_[:, 0], 1.0, 1.0, 0.1,
                                      10.0).shape == (2, 4, 4)
        assert graph.world_bounding_boxes(ws, t)[0].shape == (
            2, t.num_nodes, 3)
        assert frustum.contains_point(camera.camera_frustums(torch.eye(4)),
                                      torch.zeros(3))
        sb2, names = fbx.load_fbx_scene(make_character_fbx(n_bones=3,
                                                           n_verts=40))
        assert names and sb2.build().num_nodes
        import bench_render_torch
        for bb in ("slab", "grid"):
            hpb = PhysicsBuilder()
            hpb.add_collider(hpb.add_body(body_type=1), 5, [])
            hpb.add_body(position=(0.0, 1.0, 0.0))
            ht = hpb.build(broadphase=bb)
            assert ht.grid is None and len(ht.pair_a) == 0
            hs = step_physics(init_physics_state(hpb, ht, 2, device="cpu"),
                              ht, 1 / 60)
            assert float(hs.position[0, 1, 1]) < 1.0
        import tempfile
        from fyrox_tpu_torch import script, scripts, ui, utils
        from fyrox_tpu_torch.core import mathutil
        from fyrox_tpu_torch.io import checkpoint, visitor
        from fyrox_tpu_torch.ui import core, hud, renderer
        from fyrox_tpu_torch.utils import (astar, behavior, lightmap,
                                           navagent, navmesh, stats)
        err, dst = engine.debug_step(e)(st)
        assert err.get() is None
        ex = script.Executor(e, st)
        cam = scripts.FlyingCameraController(e.template.names.index(
            "main_camera"), 2, device="cpu")
        ex.scripts.add(cam)
        gs2 = ex.run(2 / 60)
        with tempfile.TemporaryDirectory() as tmp:
            checkpoint.save_state(gs2, tmp + "/s.npz")
            back = checkpoint.load_state(st, tmp + "/s.npz")
        assert torch.equal(back.physics.position, gs2.physics.position)
        assert visitor.read_rgs(checkpoint.state_to_visitor(gs2, e.template)
                                )[0].child("Scene") is not None
        v, nb = astar.build_grid_graph(4, 4)
        ai, aw = astar.pack_adjacency(v, nb, device="cpu")
        assert astar.distance_field(ai, aw, torch.tensor([0]))[0, 15] == 6
        nsb = SceneBuilder()
        nsb.add_navmesh(np.asarray([[0, 0, 0], [1, 0, 0], [0, 0, 1]],
                                   np.float32), np.asarray([[0, 1, 2]]))
        nm = navagent.template_navmesh(nsb.build())
        ag = navagent.BatchedNavAgents()
        nst = ag.plan(nm, [[0.1, 0, 0.1]], [[0.5, 0, 0.2]], device="cpu")
        assert ag.steer(nst, torch.zeros(1, 3), 1.0, 1 / 60)[0].shape == (
            1, 3)
        bt = behavior.BehaviorTreeBuilder()
        bt.leaf(bt.sequence())
        assert bt.build().tick(torch.zeros(2, 1)).tolist() == [0, 0]
        assert lightmap.bake_vertex_ao(torch.zeros(1, 3), torch.tensor(
            [[0.0, 1.0, 0.0]]), torch.zeros(0, 3, 3), n_rays=4,
            device="cpu").tolist() == [1.0]
        ps = stats.PerformanceStatistics()
        with ps.measure("x", block_on=gs2):
            pass
        h = ui.Hud(8, 16).add_bar("hp", 0, 0, 8, 2)
        assert ui.compose_over(torch.zeros(2, 8, 16, 3), h.render(
            {"hp": torch.ones(2)})).shape == (2, 8, 16, 3)
        assert mathutil.wrap_angle(-1.0) > 0
        from fyrox_tpu_torch import editor, plugin, resource, tools
        from fyrox_tpu_torch.core import log, task
        from fyrox_tpu_torch.io import gltf, inheritance, rgs_scene
        from fyrox_tpu_torch.scene import tilemap
        from fyrox_tpu_torch.sound import ogg, vorbis
        from fyrox_tpu_torch.utils import autotile, commands, watcher
        with tempfile.TemporaryDirectory() as tmp:
            with open(tmp + "/s.rgs", "wb") as f:
                f.write(visitor.write_rgs(chip_smoke.fyrox_scene(n_nodes=12)))
            with open(tmp + "/c.glb", "wb") as f:
                f.write(chip_smoke.character_glb(n_bones=4, n_verts=30))
            rm = resource.ResourceManager()
            rs, rg = (rm.request(tmp + p).wait(30) for p in ("/s.rgs",
                                                             "/c.glb"))
            rm.shutdown()
        assert rs.is_ok() and rs.data.num_nodes == 12 and rg.is_ok()
        assert rg.data.skins[0].num_vertices == 30
        from fyrox_tpu_torch import input as input_mod
        from fyrox_tpu_torch.core import pool
        from fyrox_tpu_torch.ui import curve_editor, font, text
        tree, th = chip_smoke.hud_ui(core)
        keys = input_mod.InputState()
        seen = [m for k in range(12)
                for m in chip_smoke.hud_tick(tree, th, keys, k)]
        assert seen and tree.nodes.borrow(th["name"]).text != "hero"
        assert isinstance(th["name"], pool.Handle)
        cmds = tree.draw()
        img = ui.render_ui(cmds, 128, 128, font=chip_smoke.write_ttf())
        assert chip_smoke.uninked_text(cmds, img) == []
        assert ui.compose_over(torch.zeros(1, 128, 128, 3), img).shape == (
            1, 128, 128, 3)
        atlas = font.FontAtlas(font.TtfFont(chip_smoke.write_ttf()), 10)
        assert text.FormattedText("AVATar To", 10.0, font=atlas).size[0] > 0
        z = ui.UserInterface((64, 64))
        ce = curve_editor.add_curve_editor(z, keys=[(0.0, 0.0, 0.0)])
        z.add(ui.Widget(kind="text", text="x"))
        z.update_layout()
        assert len(z.draw()) > 3 and z.nodes.borrow(ce).kind == "curve_editor"
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


@pytest.mark.parametrize("case", ["joint", "grid", "com", "shape"])
def test_out_of_scope_features_raise(case):
    """What the port does not run raises. Joints and centre-of-mass
    offsets run on the staged route, any number of joints (the "joint"
    case: 129 joints, past the TPU kernel's 128, step); still out of scope
    are COM offsets on the fused kernels' own entry point. The JAX
    package's grid broadphase is ported (the "grid" case: the template
    builds and steps). Every collider kind is in scope (the "shape" case:
    a hull builds, and one without its points raises the JAX package's
    ValueError). The slab cases ask for the slab broadphase: this
    four-collider scene would take the dense one by default."""
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=1)
    pb.add_collider(g, HALFSPACE, [])
    for i in range(3):
        b = pb.add_body(position=(i, 1.0, 0.0))
        pb.add_collider(b, BALL if i % 2 else CUBOID, [0.2, 0.2, 0.2],
                        offset=(0.1, 0, 0) if case == "com" else (0, 0, 0))
    if case == "joint":
        for _ in range(129):
            pb.add_joint(0, 1, 2)
        t = pb.build(broadphase="slab")
        st = step_physics(init_physics_state(pb.initial_pose(), t, 1,
                                             device="cpu"), t, 1 / 60)
        assert t.joints.num_joints == 129
        assert torch.isfinite(st.position).all()
        return
    if case == "grid":
        from fyrox_tpu_torch.physics.broadphase import GridConfig
        t = pb.build(broadphase="grid")
        st = init_physics_state(pb.initial_pose(), t, 2, device="cpu")
        for _ in range(3):
            st = step_physics(st, t, 1 / 60)
        assert isinstance(t.grid, GridConfig)
        assert st.warm_pair.shape == (2, sum(t.grid.caps))
        assert torch.isfinite(st.position).all()
        assert (st.position[:, 1:, 1] < 1.0).all()      # the bodies fall
        return
    if case == "shape":
        pb.add_collider(g, 6, points=np.eye(3).tolist() + [[0, 0, 0]])
        with pytest.raises(ValueError):
            pb.add_collider(g, 6, [])       # CONVEX without points
        assert pb.build().hulls.count == 1
        return
    with pytest.raises(NotImplementedError):
        if case == "com":
            t = pb.build(broadphase="slab")
            st = init_physics_state(pb.initial_pose(), t, 1, device="cpu")
            zero = torch.zeros_like(st.linvel)
            fused_step.fused_full_step(st, t, 1 / 60, zero, zero)
        else:
            pb.build(broadphase="slab")


def _unbinned_scene(lib, n_free, ground=True):
    """A halfspace ground (or nothing) under n_free bodies with no
    collider: no collider can enter a slab or grid broadphase."""
    pb = lib()
    if ground:
        pb.add_collider(pb.add_body(body_type=1), sh.HALFSPACE, [])
    for i in range(n_free):
        pb.add_body(position=(0.5 * i, 1.0 + 0.2 * i, 0.0))
    return pb


@pytest.mark.parametrize("broadphase", ["slab", "grid"])
@pytest.mark.parametrize("ground", [True, False],
                         ids=["halfspace", "no-collider"])
def test_unbinned_scenes_take_the_dense_pairs(broadphase, ground):
    """A slab or grid build whose scene has no grid-eligible collider
    (a halfspace under bodies with no collider, or no collider at all)
    takes the dense all-pairs list, as the JAX builder does, and steps
    like the JAX package's template."""
    from fyrox_tpu.physics import (init_physics_state as jinit_physics,
                                   step_physics as jstep_physics)
    import jax.numpy as jnp
    tb, jb = (_unbinned_scene(PhysicsBuilder, 3, ground),
              _unbinned_scene(JPhysicsBuilder, 3, ground))
    tt, jt = tb.build(broadphase=broadphase), jb.build(broadphase=broadphase)
    assert tt.grid is None and jt.grid is None
    np.testing.assert_array_equal(tt.pair_a, jt.pair_a)
    np.testing.assert_array_equal(tt.pair_b, jt.pair_b)
    assert list(tt.pair_kind_ranges) == list(jt.pair_kind_ranges) == []
    ts = init_physics_state(tb, tt, 2, device="cpu")
    js = jinit_physics(jb, jt, 2)
    for _ in range(4):
        ts = step_physics(ts, tt, 1 / 60)
        js = jstep_physics(js, jt, 1 / 60)
    for f in ("position", "rotation", "linvel", "angvel"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert float(ts.position[0, -1, 1]) < 1.4       # the bodies fall
    assert float(jnp.abs(js.linvel).sum()) > 0


def test_default_arguments_pick_the_same_broadphase():
    """PhysicsBuilder.build() and build_flagship() with default arguments
    choose what the JAX package's choose: dense under 192 colliders (with
    the same pair list), slab from 192 on; the flagship's default pile is
    64 bodies."""
    for n, want in ((9, None), (191, None), (192, "slab")):
        tb, jb = PhysicsBuilder(), JPhysicsBuilder()
        for pb in (tb, jb):
            g = pb.add_body(body_type=1)
            pb.add_collider(g, sh.HALFSPACE, [])
            for i in range(n - 1):
                b = pb.add_body(position=(i % 7, 1.0 + i // 7, 0.0))
                pb.add_collider(b, sh.BALL, [0.2])
        tt, jt = tb.build(), jb.build()
        assert (tt.grid is None) == (jt.grid is None) == (want is None)
        np.testing.assert_array_equal(tt.pair_a, jt.pair_a)
        np.testing.assert_array_equal(tt.pair_b, jt.pair_b)
    je, _ = jax_build_flagship(n_bones=4, n_verts=40)
    te, _ = torch_build_flagship(n_bones=4, n_verts=40)
    assert je.physics.grid is None and te.physics.grid is None
    assert te.physics.num_bodies == je.physics.num_bodies == 65
    np.testing.assert_array_equal(te.physics.pair_a, je.physics.pair_a)
    np.testing.assert_array_equal(te.physics.pair_b, je.physics.pair_b)
