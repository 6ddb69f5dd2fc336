"""CUDA kernels of fyrox_tpu_torch against their plain PyTorch versions.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
This file imports no JAX, so on a machine without JAX run it without the
suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.physics import plane_ops, slab2, tgs_kernel
from fyrox_tpu_torch.physics import world as phys_mod

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    from fyrox_tpu_torch import disable_tf32
    disable_tf32()
    return torch.device("cuda")


@pytest.mark.parametrize("w,a,n,k", [(4, 19, 1001, 13000), (2, 10, 1000, 48000),
                                     (3, 1, 7, 5)])
def test_plane_gather_kernel_is_bit_exact(cuda, w, a, n, k):
    rng = np.random.default_rng(k)
    planes = torch.as_tensor(rng.standard_normal((w, a, n)).astype(
        np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(-n // 4, n + n // 4, (w, k)).astype(
        np.int32), device=cuda)
    before = plane_ops.launches()
    got = plane_ops.plane_gather(planes, idx)
    assert plane_ops.launches() == before + 1
    assert torch.equal(got, plane_ops.plane_gather_plain(planes, idx))


def test_plane_gather_kernel_rejects_bad_inputs(cuda):
    planes = torch.zeros((2, 3, 10), device=cuda)
    with pytest.raises(TypeError):
        plane_ops.plane_gather(planes, torch.zeros((2, 4), dtype=torch.int64,
                                                   device=cuda))
    with pytest.raises(ValueError):
        plane_ops.plane_gather(planes.transpose(1, 2),
                               torch.zeros((2, 4), dtype=torch.int32,
                                           device=cuda))


def _all_differ(x):
    return torch.unique(x.flatten(1), dim=0).shape[0] == x.shape[0]


@pytest.fixture
def settled(cuda):
    """Packed solver inputs of a small flagship after 30 ticks, in 8
    worlds made to differ by seeded jitter of the dynamic bodies' poses
    and velocities, so a kernel that reads another world's slice fails."""
    engine, _ = build_flagship(n_bones=10, n_verts=300, n_bodies=192)
    st = engine.init_state(8, device=cuda)
    rng = np.random.default_rng(3)
    dyn = torch.as_tensor(engine.physics.body_type == phys_mod.DYNAMIC,
                          device=cuda)[None, :, None].float()

    def noise(scale):
        return torch.as_tensor(rng.uniform(-scale, scale, (8, dyn.shape[1], 3))
                               .astype(np.float32), device=cuda) * dyn

    st = st._replace(physics=st.physics._replace(
        position=st.physics.position + noise(0.05),
        linvel=st.physics.linvel + noise(0.5)))
    for _ in range(30):
        st = engine.step(st)
    t = engine.physics
    accel, angvel = phys_mod.external_accelerations(st.physics, t,
                                                    engine.dt)
    packed, _ = slab2.solver_inputs(st.physics, t, engine.dt, accel, angvel)
    assert _all_differ(packed[0]) and _all_differ(packed[2])
    return packed, tgs_kernel.solver_params(t, engine.dt)


def test_tgs_kernel_matches_plain(settled):
    packed, params = settled
    assert packed[0][:, 9].sum() > 0
    body, lam = tgs_kernel.solve_tgs(*packed, params)
    ref_b, ref_l = tgs_kernel.solve_tgs_plain(*packed, params)
    # one step of the same solve in another summation order: ten times
    # the JAX package's one-step bounds between its two implementations
    assert (body[:, 6:13] - ref_b[:, 6:13]).abs().max() < 1e-5
    assert (body[:, 0:6] - ref_b[:, 0:6]).abs().max() < 1e-4
    assert ((lam - ref_l).abs() <= 1e-3 * ref_l.abs() + 1e-5).all()


def test_tgs_kernel_repeats_bit_for_bit(settled):
    packed, params = settled
    a = tgs_kernel.solve_tgs(*packed, params)
    b = tgs_kernel.solve_tgs(*packed, params)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_tgs_kernel_refuses_oversized_worlds(settled):
    packed, params = settled
    con, body_j, body, col_body = packed
    big = torch.zeros((body.shape[0], body.shape[1], 8000),
                      device=body.device)
    with pytest.raises(ValueError, match="shared memory"):
        tgs_kernel.solve_tgs(con, body_j, big, col_body, params)
