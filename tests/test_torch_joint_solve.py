"""Port parity of K1's joint and centre-of-mass planes on one solve:
the port's plain solve (``tgs_kernel.solve_tgs_plain``, what the CUDA
kernel is held to) against the TPU kernel's body
(``pallas_solver.solve_planes`` run as plain jnp) and the JAX package's
XLA joint path, on the same packed inputs of a settled step."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu.physics import pallas_solver as jps
from fyrox_tpu.physics import slab2 as jslab2
from fyrox_tpu_torch.physics import slab2, tgs_kernel
from fyrox_tpu_torch.physics import world as tworld
from test_torch_joints import DT, JAX, PORT, _jointed_scene

torch.set_num_threads(2)


# ---- one solve ------------------------------------------------------------

def _kernel_body_solve(jcx, jt, jcon, args, warm):
    """slab2._solve_tgs_planes on its solver-kernel path, with the kernel
    swapped for its body (pallas_solver.solve_planes) run as plain jnp per
    world. Returns the packed inputs it built, the kernel's flags and the
    solve's outputs."""
    seen, flags = {}, {}

    def body(con_planes, hi, lo, body_planes, self_body, params, s, cg, bp,
             n_sub, n_pgs, n_stab, msp=0.5, interpret=False, has_com=False,
             joint_tables=None):
        seen.update(con=con_planes, hi=hi, lo=lo, body=body_planes,
                    params=params, joints=joint_tables)
        flags.update(has_com=has_com)

        def one(c, b, h, l):
            return jps.solve_planes(
                params, {n: c[i] for i, n in enumerate(jps._C_NAMES)},
                {n: b[i] for i, n in enumerate(jps._B_NAMES)}, h, l,
                self_body, s=s, cg=cg, bp=bp, n_sub=n_sub, n_pgs=n_pgs,
                n_stab=n_stab, msp=msp, has_com=has_com,
                joints=joint_tables)

        return jax.vmap(one)(con_planes, body_planes, hi, lo)

    def run(c, a, w):
        out = jslab2._solve_tgs_planes(jcx, jt, c, *a, DT, warm=w)
        return out, dict(seen)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "solve_tgs_pallas", body)
        mp.setenv("FYROX_PALLAS_INTERPRET", "1")
        out, packed = jax.jit(run)(jcon, args, warm)
    return (jax.tree_util.tree_map(np.asarray, packed), flags,
            jax.tree_util.tree_map(np.asarray, out))


# the one-solve scenes: tests/test_pallas_solver.py's jointed chain with COM
# offsets, and the joint zoo (all four joint kinds)
SOLVE_SCENES = {"chain": lambda lib: _jointed_scene(lib, True),
                "zoo": chip_smoke.joint_zoo}


@pytest.fixture(scope="module", params=sorted(SOLVE_SCENES))
def one_step(request):
    """A jointed scene after 20 port steps in 2 jittered worlds; its
    compacted contacts (the port's, which equal the JAX package's:
    test_torch_physics.py) carried into the JAX package, and the JAX
    kernel body's solve of that step."""
    build = SOLVE_SCENES[request.param]
    _, jt = build(JAX)
    pb, tt = build(PORT)
    st = chip_smoke.jitter(tworld.init_physics_state(
        pb.initial_pose(), tt, 2, device="cpu"), tt, "cpu", 4)
    for _ in range(20):
        st = tworld.step_physics(st, tt, DT)
    accel, angvel = tworld.external_accelerations(st, tt, DT)
    con = slab2.contacts(st, tt, DT)
    jcon = jslab2._Contacts(*(
        tuple(jnp.asarray(x.numpy()) for x in f) if isinstance(f, tuple)
        else jnp.asarray(f.numpy()) for f in con))
    jcx = jslab2._ctx(jt)

    def planes(x):
        return tuple(jnp.asarray(p.numpy()) for p in x.unbind(-1))

    args = (planes(st.position), planes(st.rotation), planes(st.linvel),
            planes(angvel), planes(accel), jnp.asarray(jt.inv_mass)[None])
    warm = tuple(jnp.asarray(x.numpy()) for x in (
        st.warm_n, st.warm_t1, st.warm_t2, st.warm_pair))
    return (request.param, jt, tt, jcx, jcon, args, warm,
            (st, accel, angvel),
            _kernel_body_solve(jcx, jt, jcon, args, warm))


def test_plain_solve_matches_the_kernel_body(one_step):
    """solve_tgs_plain on the JAX package's own packed inputs (joint
    tables, COM planes) against the TPU kernel's body."""
    scene, jt, tt, jcx, *_, (seen, flags, out) = one_step
    pos, q, lv, av, lams = out
    assert flags["has_com"] and seen["joints"] is not None
    b, cg, nj = jcx.b, jcx.cg, jt.joints.num_joints
    p = tgs_kernel.solver_params(tt, DT)
    np.testing.assert_array_equal(np.asarray(p[:9], np.float32),
                                  seen["params"])
    jtab, oh_a, oh_b = seen["joints"]
    joints = tgs_kernel.JointTables(
        body_a=torch.as_tensor(oh_a[:nj].argmax(1).astype(np.int32)),
        body_b=torch.as_tensor(oh_b[:nj].argmax(1).astype(np.int32)),
        jtab=torch.as_tensor(jtab[:, :nj]).contiguous())
    cx = slab2._ctx(tt)
    ref_tab = slab2.joint_tables(cx, "cpu")
    for a, r in zip(joints, ref_tab):
        assert torch.equal(a, r)
    con = torch.as_tensor(seen["con"][..., :cg]).contiguous()
    body_j = torch.as_tensor((seen["hi"] * 128 + seen["lo"])[..., :cg]
                             ).contiguous()
    body = torch.as_tensor(seen["body"][..., :b]).contiguous()
    assert con[:, 9].sum() > 0
    got_b, got_l = tgs_kernel.solve_tgs_plain(
        con, body_j, body, torch.as_tensor(cx.grid_body), p, has_com=True,
        joints=joints)
    # one step of the kernel's own algorithm in two op orders (one-hot
    # dots vs index sums; XLA fuses multiply-adds): the JAX package's
    # one-step bounds between two implementations (pos 1e-6, vel 1e-5).
    # The zoo's velocities get 1e-4: float32 rounding of its stiff ball
    # chain grows 1e-7 after the first substep to 4e-5 after the fourth,
    # and both float32 solves lie 4e-5 from the same solve in float64
    # (solve_tgs_plain on float64 inputs; the chain stays at 5e-6).
    dv_max = 1e-4 if scene == "zoo" else 1e-5
    np.testing.assert_allclose(np.stack(pos, 1), got_b[:, 6:9].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(q, 1), got_b[:, 9:13].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(lv + av, 1), got_b[:, 0:6].numpy(),
                               rtol=0, atol=dv_max)
    got_lam = got_l.transpose(2, 3).reshape(2, 3, cg * cx.s_active).numpy()
    np.testing.assert_allclose(np.stack(lams, 1), got_lam, rtol=1e-4,
                               atol=1e-5)


def test_port_packs_as_the_jax_package(one_step):
    """The port's packed K1 inputs of the same step equal the JAX
    package's (body layout of 29 rows with the COM planes)."""
    _, jt, tt, jcx, jcon, _, _, (st, accel, angvel), (seen, _, _) = one_step
    cx = slab2._ctx(tt)
    (con, body_j, body, _), _ = slab2.solver_inputs(st, tt, DT, accel,
                                                    angvel)
    np.testing.assert_array_equal(body_j.numpy(), (
        seen["hi"] * 128 + seen["lo"])[..., :cx.cg])
    np.testing.assert_allclose(con.numpy(), seen["con"][..., :cx.cg],
                               rtol=0, atol=1e-6)
    jb = seen["body"][..., :cx.b]
    rows = np.r_[0:17, 26:29]
    np.testing.assert_allclose(body.numpy()[:, rows], jb[:, rows], rtol=0,
                               atol=1e-6)
    # the world inverse inertia R I⁻¹ Rᵀ (rows 17-25, up to 1.3e4 on the
    # zoo's light links) in another op order (XLA fuses multiply-adds):
    # within a few float32 ulps of its largest entry
    ii = jb[:, 17:26]
    np.testing.assert_allclose(body.numpy()[:, 17:26], ii, rtol=0,
                               atol=1e-6 * np.abs(ii).max())


def test_plain_solve_near_the_xla_joint_path(one_step):
    """The same step against the JAX package's CPU path (XLA plane solver
    with joints.solve_joints_velocity: jnp.linalg.solve where the kernel
    takes the adjugate). Bound: 1e-5 position and 1e-4 velocity, the
    package's own kernel-vs-XLA one-step bounds (test_pallas_step.py:102
    -105, 1e-6 / 1e-5) widened tenfold for the two 3x3 solvers, whose
    results differ by ~1e-6 relative on the zoo's stiff chains (measured
    here: 5.4e-7 m and 4.3e-5 m/s)."""
    _, jt, tt, jcx, jcon, args, warm, (st, accel, angvel), _ = one_step
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda c, a, w: jslab2._solve_tgs_planes(jcx, jt, c, *a, DT, warm=w))(
            jcon, args, warm))
    packed, _ = slab2.solver_inputs(st, tt, DT, accel, angvel)
    cx = slab2._ctx(tt)
    got_b, _ = tgs_kernel.solve_tgs(*packed, tgs_kernel.solver_params(tt, DT),
                                    has_com=True,
                                    joints=slab2.joint_tables(cx, "cpu"))
    dp = np.abs(np.stack(ref[0], 1) - got_b[:, 6:9].numpy()).max()
    dv = np.abs(np.stack(ref[2] + ref[3], 1) - got_b[:, 0:6].numpy()).max()
    assert dp < 1e-5, dp
    assert dv < 1e-4, dv
