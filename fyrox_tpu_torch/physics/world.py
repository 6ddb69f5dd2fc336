"""Batched rigid-body world: template, state, builder and the step head
(PhysicsWorld::update, fyrox-impl scene/graph/physics/mod.rs:1151).

Three broadphases, chosen at build time as the JAX package chooses them
(``broadphase="auto"``: slab at 192 colliders or more, dense below;
``broadphase="grid"`` on request):

- slab (``slab2.step_slab2``): hash-grid broadphase → plane narrowphase →
  per-collider compaction → TGS-soft solve, on the fused route
  (physics/fused_step.py) where the scene allows it, else on the staged
  path. Joints (solved inside the TGS kernel) and centre-of-mass offsets
  take the staged path; temporal broadphase reuse (``broadphase_period`` >
  1) caches the candidate windows between rebuilds;
- dense (``step_physics``'s own branch): a static all-pairs candidate list
  sorted by shape kind, fat-AABB overlap, the kind-grouped narrowphase
  (physics/narrowphase.py) into the compact contact layout, or with
  ``max_active_pairs`` > 0 a top-k compaction of the overlapping pairs,
  then the Jacobi TGS solver with its joint passes (physics/solver.py),
  whose gathers and scatters run on K4a / K4b;
- grid (``_step_grid``): the hash-grid walk with a global per-class
  stream compaction (``broadphase.grid_candidates``) into directed pair
  lists, the per-class narrowphase (``generate_contacts_class``) and the
  directed TGS solve (``solver.solve_tgs_directed``), whose gathers run on
  K4a and whose windowed segment sums run on K4b.

Every collider kind of the JAX package's builder steps on the slab and
dense paths: balls, cuboids, capsules, cylinders, cones, halfspaces,
convex hulls, heightfields and trimeshes (segments and triangles lower at
build time). On the grid path, as in the JAX package, hulls and scenery
are static "big" colliders that get no contact (a dynamic hull raises).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from fyrox_tpu_torch._util import const, const_rows, resolve_device
from fyrox_tpu_torch.core import quat
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.joints import JointBuilder

__all__ = ["BodyType", "PhysicsTemplate", "PhysicsBuilder", "PhysicsState",
           "init_physics_state", "step_physics", "dense_contacts",
           "grid_aabbs", "grid_contacts", "SPECULATIVE_MARGIN",
           "PREDICTION_DISTANCE"]

DYNAMIC, STATIC, KINEMATIC = 0, 1, 2

# speculative contact activation / fat-AABB margin (wider than rapier's
# prediction distance by design: the TGS sep/h bias makes every activated
# contact an approach limiter)
SPECULATIVE_MARGIN = 0.05
# rapier's IntegrationParameters::prediction_distance (physics/mod.rs:900)
PREDICTION_DISTANCE = 0.002


class BodyType:
    DYNAMIC, STATIC, KINEMATIC = DYNAMIC, STATIC, KINEMATIC


@dataclass
class PhysicsTemplate:
    body_node: np.ndarray          # [B] scene node (-1 standalone)
    body_type: np.ndarray          # [B]
    inv_mass: np.ndarray           # [B] f32 (0 for non-dynamic)
    inv_inertia_local: np.ndarray  # [B,3,3]
    com_local: np.ndarray          # [B,3]
    lin_damping: np.ndarray        # [B]
    ang_damping: np.ndarray        # [B]
    gravity_scale: np.ndarray      # [B]
    col_body: np.ndarray           # [C]
    col_shape: np.ndarray          # [C]
    col_params: np.ndarray         # [C,6]
    col_pos: np.ndarray            # [C,3]
    col_rot: np.ndarray            # [C,4]
    col_friction: np.ndarray       # [C]
    col_restitution: np.ndarray    # [C]
    col_node: np.ndarray           # [C]
    # dense broadphase: the static candidate pairs, canonical (smaller
    # effective shape kind first) and sorted by kind; empty under slab
    pair_a: np.ndarray = None      # [P] collider index
    pair_b: np.ndarray = None      # [P]
    pair_kind_ranges: list = None  # [((kind_a, kind_b), start, end)]
    lin_lock: np.ndarray = None    # [B,3] 1 = free, 0 = locked
    ang_lock: np.ndarray = None    # [B,3]
    max_active_pairs: int = 0      # dense compaction width (0 = all P)
    # broadphase.SlabConfig or GridConfig (None: dense)
    grid: object = None
    joints: object = None          # joints.JointSet (joint.rs:775)
    init_body_pos: np.ndarray = None
    init_body_rot: np.ndarray = None
    # convex hulls (convex.ConvexSet): CONVEX colliders', and the 12-gon
    # hulls of cylinders and cones (the dense path's SAT routines)
    hulls: object = None
    col_hull: np.ndarray = None    # [C] hull index (-1 none)
    # static scenery: heightfields share one resolution
    hf_heights: np.ndarray = None  # [Nhf, Rz, Rx]
    hf_size: np.ndarray = None     # [Nhf, 2] (size_x, size_z)
    col_hf: np.ndarray = None      # [C] heightfield index (-1)
    tm_tris: np.ndarray = None     # [Ntm, MAX_TRIS, 3, 3] local
    tm_mask: np.ndarray = None     # [Ntm, MAX_TRIS]
    col_tm: np.ndarray = None      # [C] trimesh index (-1)
    # solver config (reference defaults physics/mod.rs:892-908)
    erp: float = 0.2
    allowed_linear_error: float = 0.002
    max_corrective_velocity: float = 10.0
    restitution_threshold: float = 1.0
    n_substeps: int = 4
    n_pgs: int = 1
    n_stabilization: int = 4
    warmstart_coefficient: float = 1.0
    mass_split_pow: float = 0.5
    gravity: tuple = (0.0, -9.81, 0.0)
    broadphase_period: int = 1

    @property
    def num_bodies(self):
        return int(self.body_node.shape[0])

    @property
    def num_colliders(self):
        return int(self.col_body.shape[0])

    @property
    def num_pairs(self):
        return 0 if self.pair_a is None else int(self.pair_a.shape[0])

    def flat_layout(self):
        """(pair_idx [K], K): the compact per-kind contact-slot layout
        (narrowphase.KIND_POINTS slots a pair) of dense mode."""
        if getattr(self, "_flat_layout", None) is None:
            from fyrox_tpu_torch.physics.narrowphase import \
                flat_contact_layout
            self._flat_layout = flat_contact_layout(
                self.pair_kind_ranges or [])
        return self._flat_layout

    def contact_tables(self):
        """Static host tables of the compact dense layout, built once:
        pair_idx [K]; index [2K], the body of each slot's A side, then of
        each slot's B side; per-slot friction and restitution; own_pts,
        the manifold size of each slot's pair. They take the place of the
        JAX package's one-hot incidence()."""
        if getattr(self, "_contact_tables", None) is None:
            pair_idx, _ = self.flat_layout()
            pa = self.pair_a[pair_idx]
            pb = self.pair_b[pair_idx]
            fric_p = np.sqrt(self.col_friction[self.pair_a]
                             * self.col_friction[self.pair_b])
            rest_p = np.maximum(self.col_restitution[self.pair_a],
                                self.col_restitution[self.pair_b])
            self._contact_tables = dict(
                pair_idx=pair_idx.astype(np.int64),
                index=np.concatenate([self.col_body[pa], self.col_body[pb]]
                                     ).astype(np.int32),
                friction=fric_p[pair_idx].astype(np.float32),
                restitution=rest_p[pair_idx].astype(np.float32),
                own_pts=np.bincount(pair_idx)[pair_idx].astype(np.float32))
        return self._contact_tables


class PhysicsState(NamedTuple):
    """[W,B,...] rigid-body state plus the per-contact-slot warm-start
    carries (accumulated impulses and the point identity that held each
    slot), the layout of ``fyrox_tpu.physics.world.PhysicsState``."""
    position: torch.Tensor     # [W,B,3]
    rotation: torch.Tensor     # [W,B,4]
    linvel: torch.Tensor       # [W,B,3]
    angvel: torch.Tensor       # [W,B,3]
    force: torch.Tensor        # [W,B,3]
    torque: torch.Tensor       # [W,B,3]
    # slab: [W,Cg*s_active] point slots; dense: [W,K] compact-layout
    # slots (or [W,cap*4] compacted); grid: [W,Σ caps[c]·npts[c]], the
    # classes' pair slots in turn
    warm_n: Optional[torch.Tensor] = None
    warm_t1: Optional[torch.Tensor] = None
    warm_t2: Optional[torch.Tensor] = None
    # slab: [W,Cg*s_active] point identity; dense: [W,P] pair id of each
    # pair slot (or [W,cap]); grid: [W,Σ caps] pair ids; int32
    warm_pair: Optional[torch.Tensor] = None
    # temporal broadphase reuse (broadphase_period > 1): (per-class
    # SlabCandidates, positions at the rebuild [W,B,3], coverage budgets
    # [W,B,3]) and the steps since the rebuild [W] int32
    bp_cache: Optional[tuple] = None
    bp_age: Optional[torch.Tensor] = None


def _np_quat_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
        np.float64)


class PhysicsBuilder:
    """Host-side construction of bodies + colliders → packed template."""

    def __init__(self):
        self._bodies = []
        self._colliders = []
        self._joints = None
        self._hulls = None       # convex.ConvexBuilder, at the first hull
        self._hfs = []           # (heights, size_x, size_z)
        self._tms = []           # [T,3,3] triangle soups

    def add_body(self, node=-1, body_type=DYNAMIC, position=(0, 0, 0),
                 rotation=(0, 0, 0, 1), lin_damping=0.0, ang_damping=0.0,
                 gravity_scale=1.0, dim2=False,
                 lock_translation=(1, 1, 1), lock_rotation=(1, 1, 1)) -> int:
        if dim2:
            lock_translation = (1, 1, 0)
            lock_rotation = (0, 0, 1)
        self._bodies.append(dict(
            node=node, body_type=body_type,
            position=np.asarray(position, np.float32),
            rotation=np.asarray(rotation, np.float32),
            lin_damping=lin_damping, ang_damping=ang_damping,
            gravity_scale=gravity_scale,
            lin_lock=np.asarray(lock_translation, np.float32),
            ang_lock=np.asarray(lock_rotation, np.float32)))
        return len(self._bodies) - 1

    def add_joint(self, kind, body_a, body_b, anchor_a=(0, 0, 0),
                  anchor_b=(0, 0, 0), axis=(0, 0, 1), ref_rot=None) -> int:
        """Impulse joint; kind from physics.joints.JointKind. ref_rot: the
        relative orientation (xyzw) the joint holds; by default the
        bodies' creation-time qa0^-1 * qb0, computed in float64 (rapier
        local_frame semantics)."""
        if self._joints is None:
            self._joints = JointBuilder()
        if ref_rot is None:
            qa = np.asarray(self._bodies[body_a]["rotation"], np.float64)
            qb = np.asarray(self._bodies[body_b]["rotation"], np.float64)
            ax, ay, az, aw = -qa[0], -qa[1], -qa[2], qa[3]      # qa^-1
            bx, by, bz, bw = qb
            ref_rot = np.asarray([
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw,
                aw * bw - ax * bx - ay * by - az * bz], np.float32)
        return self._joints.add(kind, body_a, body_b, anchor_a, anchor_b,
                                axis, ref_rot)

    def add_collider(self, body, shape, params=(), density=1.0,
                     friction=0.5, restitution=0.0, offset=(0, 0, 0),
                     offset_rot=(0, 0, 0, 1), node=-1, points=None,
                     heights=None, size=None, triangles=None) -> int:
        """CONVEX takes `points` (a local point cloud, hulled here);
        HEIGHTFIELD `heights` [Rz,Rx] and `size=(sx, sz)` (a centred local
        rectangle); TRIMESH `triangles` ((verts, faces) or a [T,3,3] soup);
        both scenery kinds are static-only. Cylinders and cones register a
        12-gon prism / pyramid hull. SEGMENT (`points=(a, b)`, or
        `params=[half_height]` along local Y) lowers to a zero-radius
        capsule, TRIANGLE (`points=(a, b, c)` or one-cell `triangles`) to a
        one-cell trimesh (fyrox_tpu/physics/world.py:240-380)."""
        from fyrox_tpu_torch.physics import convex as cx
        from fyrox_tpu_torch.physics.scenery import MAX_TRIS
        if int(shape) == sh.SEGMENT:
            if points is not None:
                a, b = (np.asarray(p, np.float32) for p in points)
                d = b - a
                ln = float(np.linalg.norm(d))
                if ln > 1e-12:
                    # the rotation taking local +Y onto the segment
                    y = np.array([0.0, 1.0, 0.0])
                    dn = d / ln
                    v = np.cross(y, dn)
                    c = float(np.dot(y, dn))
                    sn = float(np.linalg.norm(v))
                    if sn > 1e-8:
                        half = np.arctan2(sn, c) * 0.5
                        offset_rot = np.concatenate(
                            [v / sn * np.sin(half), [np.cos(half)]])
                    elif c < 0.0:                      # antiparallel
                        offset_rot = np.array([0.0, 0.0, 1.0, 0.0])
                    offset = np.asarray(offset, np.float32) + 0.5 * (a + b)
                params = [0.5 * ln, 0.0]
            else:
                params = [float(params[0]) if len(params) else 0.5, 0.0]
            shape = sh.CAPSULE
        elif int(shape) == sh.TRIANGLE:
            if triangles is None:
                if points is None or len(points) != 3:
                    raise ValueError("TRIANGLE collider needs points=(a,b,c)"
                                     " or triangles= one cell")
                triangles = np.asarray(points, np.float32)[None]
            shape = sh.TRIMESH
        shape = int(shape)
        p6 = np.zeros(6, np.float32)
        hull = hf = tm = -1
        if shape == sh.CONVEX:
            if points is None:
                raise ValueError("CONVEX collider needs points=")
            verts, normals = cx.hull_from_points(points)
            hull = self._hulls_add(verts, normals)
            p6[0] = float(np.linalg.norm(verts, axis=1).max())
        elif shape == sh.HEIGHTFIELD:
            if heights is None or size is None:
                raise ValueError("HEIGHTFIELD collider needs heights= and "
                                 "size=(size_x, size_z)")
            h = np.asarray(heights, np.float32)
            sx, sz = float(size[0]), float(size[1])
            hf = len(self._hfs)
            self._hfs.append((h, sx, sz))
            p6[:3] = [sx, sz, float(np.linalg.norm(
                [sx * 0.5, np.abs(h).max() + 1e-3, sz * 0.5]))]
        elif shape == sh.TRIMESH:
            if triangles is None:
                raise ValueError("TRIMESH collider needs triangles= "
                                 "((verts, tris) or [T,3,3] soup)")
            if isinstance(triangles, tuple):
                v, f = triangles
                soup = np.asarray(v, np.float32)[np.asarray(f, np.int64)]
            else:
                soup = np.asarray(triangles, np.float32)
            if soup.shape[0] > MAX_TRIS:
                raise ValueError(f"trimesh has {soup.shape[0]} tris > "
                                 f"{MAX_TRIS}; decimate or split")
            tm = len(self._tms)
            self._tms.append(soup)
            p6[0] = float(np.linalg.norm(soup.reshape(-1, 3), axis=1).max())
        else:
            p6[:len(params)] = params
            if shape == sh.CYLINDER:
                hull = self._hulls_add(*cx.prism_hull(p6[0], p6[1], n=12))
            elif shape == sh.CONE:
                hull = self._hulls_add(*cx.cone_hull(p6[0], p6[1], n=12))
        if shape in (sh.HEIGHTFIELD, sh.TRIMESH) \
                and self._bodies[body]["body_type"] == DYNAMIC:
            raise ValueError("heightfield/trimesh colliders are static-only")
        self._colliders.append(dict(
            body=body, shape=shape, params=p6, density=density,
            friction=friction, restitution=restitution,
            offset=np.asarray(offset, np.float32),
            offset_rot=np.asarray(offset_rot, np.float32), node=node,
            hull=hull, hf=hf, tm=tm))
        return len(self._colliders) - 1

    def _hulls_add(self, verts, normals):
        from fyrox_tpu_torch.physics.convex import ConvexBuilder
        if self._hulls is None:
            self._hulls = ConvexBuilder()
        return self._hulls.add(verts, normals)

    def _scenery_fields(self):
        """The template's heightfield and trimesh tables (None where the
        scene has none)."""
        from fyrox_tpu_torch.physics.scenery import MAX_TRIS
        out = dict(hf_heights=None, hf_size=None, col_hf=None,
                   tm_tris=None, tm_mask=None, col_tm=None)
        if self._hfs:
            if len({h.shape for h, _, _ in self._hfs}) > 1:
                raise ValueError("all heightfields in a scene must share one "
                                 "resolution (pad on the host)")
            out["hf_heights"] = np.stack([h for h, _, _ in self._hfs])
            out["hf_size"] = np.asarray([(sx, sz) for _, sx, sz in self._hfs],
                                        np.float32)
            out["col_hf"] = np.asarray([c["hf"] for c in self._colliders],
                                       np.int32)
        if self._tms:
            n = len(self._tms)
            tris = np.zeros((n, MAX_TRIS, 3, 3), np.float32)
            mask = np.zeros((n, MAX_TRIS), bool)
            for i, soup in enumerate(self._tms):
                tris[i, :len(soup)] = soup
                mask[i, :len(soup)] = True
            out["tm_tris"] = tris
            out["tm_mask"] = mask
            out["col_tm"] = np.asarray([c["tm"] for c in self._colliders],
                                       np.int32)
        return out

    def build(self, max_active_pairs=0, broadphase="auto",
              grid_window=48, grid_caps=None, grid_windows_body=None,
              slab_window=(12, 8, 10), slab_active=16, slab_walk=48,
              broadphase_period=1, **solver_kw) -> PhysicsTemplate:
        """broadphase: "dense" = the static all-pairs candidate list
        (small scenes; max_active_pairs > 0 compacts the overlapping pairs
        into that many slots a step), "slab" = hash-grid into static
        per-collider candidate windows (large collider counts), "grid" =
        hash-grid + global per-class stream compaction (grid_window walk
        slots a collider, grid_caps pairs a class, grid_windows_body pairs
        a body's sum takes; broadphase.build_grid_config's defaults where
        None), "auto" picks slab at >= 192 colliders, as the JAX package
        does."""
        nb = len(self._bodies)
        nc = len(self._colliders)
        if broadphase == "auto":
            broadphase = "slab" if nc >= 192 else "dense"
        if broadphase not in ("slab", "dense", "grid"):
            raise ValueError(f"broadphase={broadphase!r}: want auto, "
                             "dense, slab or grid")
        inv_mass = np.zeros(nb, np.float32)
        inv_inertia = np.zeros((nb, 3, 3), np.float32)
        com = np.zeros((nb, 3), np.float32)
        by_body = {}
        for c in self._colliders:
            by_body.setdefault(c["body"], []).append(c)
        def collider_mass(c):
            """(mass, inertia about the shape's COM in its local axes, COM
            in collider-local space)."""
            if c["shape"] == sh.CONVEX:
                from fyrox_tpu_torch.physics.convex import hull_mass
                return hull_mass(self._hulls.verts[c["hull"]],
                                 self._hulls.normals[c["hull"]],
                                 c["density"])
            m, i_local = sh.mass_properties(c["shape"], c["params"],
                                            c["density"])
            return m, np.zeros(3), i_local

        for bi, body in enumerate(self._bodies):
            if body["body_type"] != DYNAMIC:
                continue
            props = [(collider_mass(c), c) for c in by_body.get(bi, [])]
            mass = sum(m for (m, _cm, _i), _c in props)
            if mass <= 0.0:
                inv_mass[bi] = 1.0
                continue
            centers = [c["offset"] + _np_quat_mat(c["offset_rot"]) @ cm
                       for (_m, cm, _i), c in props]
            com[bi] = sum(m * ctr for ((m, _cm, _i), _c), ctr
                          in zip(props, centers)) / mass
            inertia = np.zeros((3, 3))
            for ((m, _cm, i_local), c), ctr in zip(props, centers):
                r = _np_quat_mat(c["offset_rot"])
                d = ctr - com[bi]
                inertia += (r @ i_local @ r.T
                            + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d)))
            inv_mass[bi] = 1.0 / mass
            inv_inertia[bi] = np.linalg.inv(inertia)

        body_type = np.asarray([b["body_type"] for b in self._bodies],
                               np.int32)
        col_body = np.asarray([c["body"] for c in self._colliders], np.int32)
        col_shape = np.asarray([c["shape"] for c in self._colliders],
                               np.int32)
        col_params = (np.stack([c["params"] for c in self._colliders])
                      if nc else np.zeros((0, 6), np.float32))
        grid_cfg = None
        pa = pb = np.zeros(0, np.int32)
        kind_ranges = None
        col_hull = np.asarray([c["hull"] for c in self._colliders],
                              np.int32)
        if broadphase == "grid" and nc:
            from fyrox_tpu_torch.physics.broadphase import build_grid_config
            margin = solver_kw.get("allowed_linear_error", 0.002) + 0.05
            grid_cfg = build_grid_config(
                col_shape, col_params, col_body, body_type, margin=margin,
                window=grid_window, caps=grid_caps,
                windows_body=grid_windows_body)
        elif broadphase == "slab" and nc:
            from fyrox_tpu_torch.physics.broadphase import build_slab_config
            margin = solver_kw.get("allowed_linear_error", 0.002) + 0.05
            extent = 0.0
            if self._bodies:
                extent = float(np.abs(np.stack(
                    [b["position"] for b in self._bodies])).max())
            grid_cfg = build_slab_config(
                col_shape, col_params, col_body, body_type, margin=margin,
                window=slab_window, active_window=slab_active,
                walk=slab_walk, extent_hint=extent * 2.0)
        if grid_cfg is None:
            # the dense all-pairs list, also where no collider can enter a
            # slab or grid broadphase (or there is none), as the JAX
            # builder takes it
            pa, pb, kind_ranges = _dense_pairs(col_shape, col_body,
                                               body_type, col_hull)

        def stack(key, width, default):
            return (np.stack([r[key] for r in self._colliders]) if nc
                    else np.zeros((0, width), default))

        return PhysicsTemplate(
            body_node=np.asarray([b["node"] for b in self._bodies], np.int32),
            body_type=body_type,
            inv_mass=inv_mass,
            inv_inertia_local=inv_inertia.astype(np.float32),
            com_local=com.astype(np.float32),
            lin_damping=np.asarray([b["lin_damping"] for b in self._bodies],
                                   np.float32),
            ang_damping=np.asarray([b["ang_damping"] for b in self._bodies],
                                   np.float32),
            gravity_scale=np.asarray([b["gravity_scale"]
                                      for b in self._bodies], np.float32),
            lin_lock=(np.stack([b["lin_lock"] for b in self._bodies])
                      if nb else np.ones((0, 3), np.float32)),
            ang_lock=(np.stack([b["ang_lock"] for b in self._bodies])
                      if nb else np.ones((0, 3), np.float32)),
            col_body=col_body,
            col_shape=col_shape,
            col_params=col_params,
            col_pos=stack("offset", 3, np.float32),
            col_rot=stack("offset_rot", 4, np.float32),
            col_friction=np.asarray([c["friction"] for c in self._colliders],
                                    np.float32),
            col_restitution=np.asarray(
                [c["restitution"] for c in self._colliders], np.float32),
            col_node=np.asarray([c["node"] for c in self._colliders],
                                np.int32),
            pair_a=np.asarray(pa, np.int32),
            pair_b=np.asarray(pb, np.int32),
            pair_kind_ranges=kind_ranges,
            max_active_pairs=max_active_pairs,
            init_body_pos=(np.stack([b["position"] for b in self._bodies])
                           if nb else np.zeros((0, 3), np.float32)),
            init_body_rot=(np.stack([b["rotation"] for b in self._bodies])
                           if nb else np.zeros((0, 4), np.float32)),
            grid=grid_cfg,
            joints=(self._joints.build(com_local=com)
                    if self._joints is not None else None),
            broadphase_period=int(broadphase_period),
            hulls=None if self._hulls is None else self._hulls.build(),
            col_hull=col_hull,
            **self._scenery_fields(),
            **solver_kw)

    def initial_pose(self):
        if not self._bodies:
            return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32)
        return (np.stack([b["position"] for b in self._bodies]),
                np.stack([b["rotation"] for b in self._bodies]))


def _dense_pairs(col_shape, col_body, body_type, col_hull):
    """The dense broadphase's static candidate list: every collider pair
    on two different bodies of which one is dynamic, canonical (smaller
    effective shape kind first; cylinders and cones with a registered hull
    count as CONVEX) and sorted by (kind_a, kind_b), as
    ``fyrox_tpu.physics.world.PhysicsBuilder.build`` lays it out. Returns
    (pair_a [P], pair_b [P], [((kind_a, kind_b), start, end)])."""
    from fyrox_tpu_torch.physics.narrowphase import effective_kind
    nc = len(col_shape)
    kinds = np.asarray(
        [sh.CONVEX if (k == sh.CONVEX or (k in (sh.CYLINDER, sh.CONE)
                                          and h >= 0))
         else effective_kind(int(k)) for k, h in zip(col_shape, col_hull)],
        np.int32)
    ii, jj = np.triu_indices(nc, k=1)
    keep = (col_body[ii] != col_body[jj]) & (
        (body_type[col_body[ii]] == DYNAMIC)
        | (body_type[col_body[jj]] == DYNAMIC))
    ii, jj = ii[keep], jj[keep]
    swap = kinds[ii] > kinds[jj]
    pa = np.where(swap, jj, ii).astype(np.int64)
    pb = np.where(swap, ii, jj).astype(np.int64)
    order = np.lexsort((kinds[pb], kinds[pa]))
    pa, pb = pa[order], pb[order]
    ka, kb = kinds[pa], kinds[pb]
    kind_ranges = []
    if len(pa):
        combo = ka.astype(np.int64) * 1000 + kb
        bounds = np.flatnonzero(np.diff(combo)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(combo)]])
        kind_ranges = [((int(ka[s0]), int(kb[s0])), int(s0), int(e0))
                       for s0, e0 in zip(starts, ends)]
    return pa, pb, kind_ranges


def init_physics_state(builder_or_pose, template: PhysicsTemplate,
                       num_worlds: int, device="cuda") -> PhysicsState:
    """Bodies at rest at the given poses; empty warm-start carries (sized
    for the slab's point slots, the dense compact layout or its compacted
    slots) and, on the slab at broadphase_period > 1, an empty candidate
    cache whose age 0 and zero coverage make the first step rebuild. On
    the card unless `device` says otherwise."""
    device = resolve_device(device)
    if isinstance(builder_or_pose, PhysicsBuilder):
        pos, rot = builder_or_pose.initial_pose()
    else:
        pos, rot = builder_or_pose
    w, b = num_worlds, template.num_bodies
    f32 = torch.float32
    if _is_grid(template):
        from fyrox_tpu_torch.physics.broadphase import CLASS_NPTS
        caps = template.grid.caps
        kk = sum(c * n for c, n in zip(caps, CLASS_NPTS))
        cap = sum(caps)
    elif template.grid is not None:
        kk = cap = int(template.grid.grid_cols.size) * int(
            template.grid.s_active)
    else:
        # dense: the compact layout's slots, or 4 a compacted pair slot
        p = template.num_pairs
        cap = min(template.max_active_pairs or p, p)
        if cap >= p and template.pair_kind_ranges is not None:
            _, kk = template.flat_layout()
        else:
            kk = cap * 4

    def z(*shape, dtype=f32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    bp = {}
    if (template.grid is not None and not _is_grid(template)
            and int(getattr(template, "broadphase_period", 1) or 1) > 1):
        from fyrox_tpu_torch.physics.broadphase import SlabCandidates
        sc = template.grid
        cands = []
        for cls in range(3):
            k = int(sc.grid_cols.size) * sc.nslot(cls)
            cands.append(SlabCandidates(
                j_real=z(w, k, dtype=torch.int32),
                body_j=z(w, k, dtype=torch.int32),
                valid=z(w, k, dtype=torch.bool),
                swap=z(w, k, dtype=torch.bool),
                pid=z(w, k, dtype=torch.int32, fill=-1)))
        bp = dict(bp_cache=(tuple(cands), z(w, b, 3), z(w, b, 3)),
                  bp_age=z(w, dtype=torch.int32))
    return PhysicsState(
        position=torch.as_tensor(np.asarray(pos, np.float32), device=device
                                 ).expand(w, b, 3).contiguous(),
        rotation=torch.as_tensor(np.asarray(rot, np.float32), device=device
                                 ).expand(w, b, 4).contiguous(),
        linvel=z(w, b, 3), angvel=z(w, b, 3), force=z(w, b, 3),
        torque=z(w, b, 3),
        warm_n=z(w, kk), warm_t1=z(w, kk), warm_t2=z(w, kk),
        warm_pair=z(w, cap, dtype=torch.int32, fill=-1), **bp)


def step_physics(state: PhysicsState, t: PhysicsTemplate, dt,
                 fused=True, bp_rank="sort") -> PhysicsState:
    """One physics step: external accelerations, then the template's
    broadphase: the slab pipeline (the fused route where the scene allows
    it; fused=False keeps the staged path; bp_rank "sort" or "count" is
    how the slab broadphase orders its keys where it runs in PyTorch, the
    JAX package's FYROX_BP_RANK) or the dense path, which takes neither
    option; so does the grid path."""
    accel, angvel = external_accelerations(state, t, dt)
    if t.grid is None:
        return _step_dense(state, t, dt, accel, angvel)
    if _is_grid(t):
        return _step_grid(state, t, dt, accel, angvel)
    from fyrox_tpu_torch.physics import slab2
    return slab2.step_slab2(state, t, dt, accel, angvel, fused=fused,
                            bp_rank=bp_rank)


def _is_grid(t: PhysicsTemplate) -> bool:
    """Whether the template takes the grid broadphase."""
    from fyrox_tpu_torch.physics.broadphase import GridConfig
    return isinstance(t.grid, GridConfig)


def _collider_world(state: PhysicsState, t: PhysicsTemplate):
    """World pose of every collider, body pose ∘ local offset: (pos
    [W,C,3], rot_mat [W,C,3,3])."""
    dev = state.position.device
    cb = const(t.col_body, dev, torch.int64)
    bq = state.rotation[:, cb]
    bp = state.position[:, cb]
    wq = quat.mul(bq, const(t.col_rot, dev)[None].expand(bq.shape))
    wp = bp + quat.rotate(bq, const(t.col_pos, dev)[None].expand(bp.shape))
    return wp, quat.to_mat3(wq)


def dense_contacts(state: PhysicsState, t: PhysicsTemplate, dt):
    """The dense step's broadphase and narrowphase
    (fyrox_tpu/physics/world.py:680-804): fat AABBs swept along the step's
    motion (CCD), the all-pairs overlap test, then the kind-grouped
    narrowphase into the compact layout or, with max_active_pairs below
    P, the top-k compaction of the overlapping pairs and the
    select-by-kind narrowphase. Returns (solver.ContactBatch, the pair id
    of each pair slot [W,cap], the slots still holding last step's pair
    [W,K]), or three Nones without pairs."""
    from fyrox_tpu_torch.physics import narrowphase as np_mod
    from fyrox_tpu_torch.physics import solver as solver_mod
    w = state.position.shape[0]
    dev = state.position.device
    contacts = sel = same_k = None
    p = t.num_pairs
    if p > 0:
        cpos, crot = _collider_world(state, t)
        ctype = const(t.col_shape, dev)
        cparams = const(t.col_params, dev)
        # fat AABBs; the margin is also the speculative activation distance
        margin = t.allowed_linear_error + SPECULATIVE_MARGIN
        he = sh.shape_aabb_half_extents(ctype[None], cparams[None],
                                        crot) + margin
        amin, amax = cpos - he, cpos + he
        # CCD: sweep the fat AABB along the body's motion this step
        cb = const(t.col_body, dev, torch.int64)
        v_sweep = state.linvel[:, cb] * dt
        amin = amin + torch.clamp(v_sweep, max=0.0)
        amax = amax + torch.clamp(v_sweep, min=0.0)
        # a halfspace's box is its half-volume
        is_hs = (ctype == sh.HALFSPACE)[None, :, None]
        n_hs = crot[..., :, 1]
        amax = torch.where(is_hs, cpos + sh._HUGE * (1.0 - n_hs) + margin,
                           amax)
        amin = torch.where(is_hs, cpos - sh._HUGE * (1.0 + n_hs) - margin,
                           amin)
        pa = const(t.pair_a, dev, torch.int64)
        pb = const(t.pair_b, dev, torch.int64)
        overlap = torch.all((amin[:, pa] <= amax[:, pb])
                            & (amax[:, pa] >= amin[:, pb]), -1)    # [W,P]
        cap = min(t.max_active_pairs or p, p)
        dense_mode = cap >= p and t.pair_kind_ranges is not None
        if cap < p:
            # distinct scores, so that the selection and its order are
            # XLA top_k's (ties lowest index first) on any device: the
            # overlapping pairs by descending index, then the others by
            # ascending index
            ar = const(_arange(t), dev)
            score = torch.where(overlap, ar, -1 - ar)
            top, sel = torch.topk(score, cap, dim=1)
            sel_valid = top >= 0
            sel = sel.to(torch.int32)
        else:
            sel = const(_arange(t), dev)[None].expand(w, p)
            sel_valid = overlap
        if dense_mode:
            tab = t.contact_tables()
            pred_p = margin + torch.sqrt(torch.sum(
                (v_sweep[:, pa] - v_sweep[:, pb]) ** 2, -1))
            hull_ctx = (None if t.hulls is None else
                        (t.hulls, t.col_hull, t.pair_a, t.pair_b))
            scenery_ctx = None
            if t.col_hf is not None or t.col_tm is not None:
                scenery_ctx = (t.hf_heights, t.hf_size, t.col_hf, t.tm_tris,
                               t.tm_mask, t.col_tm, t.pair_a, t.pair_b)
            flat = np_mod.generate_contacts_flat(
                t.pair_kind_ranges, cparams[pa][None], cpos[:, pa],
                crot[:, pa], cparams[pb][None], cpos[:, pb], crot[:, pb],
                pred=pred_p, hull_ctx=hull_ctx, scenery_ctx=scenery_ctx)
            pair_idx = const(tab["pair_idx"], dev)
            contacts = solver_mod.ContactBatch(
                index=const_rows(tab["index"], dev, w),
                normal=flat["normal"], point=flat["point"],
                depth=flat["depth"],
                friction=const(tab["friction"], dev),
                restitution=const(tab["restitution"], dev),
                active=flat["active"] & sel_valid[:, pair_idx],
                own_pts=tab["own_pts"])
            same_k = (state.warm_pair == sel)[:, pair_idx]
        else:
            rows = torch.arange(w, device=dev)[:, None]
            ia_c, ib_c = pa[sel.long()], pb[sel.long()]
            pred_p = margin + torch.sqrt(torch.sum(
                (v_sweep[rows, ia_c] - v_sweep[rows, ib_c]) ** 2, -1))
            man = np_mod.generate_contacts(
                ctype[ia_c], cparams[ia_c], cpos[rows, ia_c],
                crot[rows, ia_c], ctype[ib_c], cparams[ib_c],
                cpos[rows, ib_c], crot[rows, ib_c], pred=pred_p)
            kk = cap * 4
            fric = const(t.col_friction, dev)
            rest = const(t.col_restitution, dev)

            def rep(x):
                return np_mod.repeat_slots(x, 4)

            contacts = solver_mod.ContactBatch(
                index=torch.cat([rep(cb[ia_c]), rep(cb[ib_c])], 1).to(
                    torch.int32),
                normal=rep(man.normal), point=man.points.reshape(w, kk, 3),
                depth=man.depth.reshape(w, kk),
                friction=rep(torch.sqrt(fric[ia_c] * fric[ib_c])),
                restitution=rep(torch.maximum(rest[ia_c], rest[ib_c])),
                active=man.active.reshape(w, kk) & rep(sel_valid))
            same_k = rep(state.warm_pair == sel)
    return contacts, sel, same_k


def _step_dense(state: PhysicsState, t: PhysicsTemplate, dt, accel,
                angvel) -> PhysicsState:
    """The dense broadphase step (fyrox_tpu/physics/world.py:680-860):
    dense_contacts, slot-matched warm start, the TGS solve, axis locks and
    damping. Holds no host read, so a CUDA graph captures it."""
    from fyrox_tpu_torch.physics import solver as solver_mod
    w, b = state.position.shape[:2]
    dev = state.position.device
    inv_mass = const(t.inv_mass, dev)[None].expand(w, b)
    contacts, sel, same_k = dense_contacts(state, t, dt)
    sp = solver_mod.SolverParams(
        dt=dt, erp=t.erp, allowed_linear_error=t.allowed_linear_error,
        max_corrective_velocity=t.max_corrective_velocity,
        restitution_threshold=t.restitution_threshold,
        n_substeps=t.n_substeps, n_pgs=t.n_pgs,
        n_stabilization=t.n_stabilization,
        warmstart_coefficient=t.warmstart_coefficient,
        mass_split_pow=t.mass_split_pow)
    warm = None
    if contacts is not None:
        # slot-matched warm start: only slots still holding the same pair
        warm = (state.warm_n * same_k, state.warm_t1 * same_k,
                state.warm_t2 * same_k)
    position, rotation, linvel, angvel, lam_out = solver_mod.solve_tgs(
        state.position, state.rotation, state.linvel, angvel, t.com_local,
        inv_mass, t.inv_inertia_local, accel, contacts, sp, warm=warm,
        joints=t.joints)
    position, rotation, linvel, angvel = _apply_locks_damping(
        state, t, dt, position, rotation, linvel, angvel)
    if lam_out is not None:
        warm_n, warm_t1, warm_t2 = lam_out
        warm_pair = sel
    else:
        warm_n, warm_t1, warm_t2 = state.warm_n, state.warm_t1, state.warm_t2
        warm_pair = state.warm_pair
    return PhysicsState(position=position, rotation=rotation,
                        linvel=linvel, angvel=angvel,
                        force=torch.zeros_like(state.force),
                        torque=torch.zeros_like(state.torque),
                        warm_n=warm_n, warm_t1=warm_t1, warm_t2=warm_t2,
                        warm_pair=warm_pair)


def grid_aabbs(state: PhysicsState, t: PhysicsTemplate):
    """The grid step's fat AABBs [W,C,3] (amin, amax) and collider poses:
    shape bounds plus the speculative margin (no CCD sweep, as the JAX
    package's grid step), a halfspace's box its half-volume. Returns
    (amin, amax, cpos, crot)."""
    dev = state.position.device
    cpos, crot = _collider_world(state, t)
    ctype = const(t.col_shape, dev)
    cparams = const(t.col_params, dev)
    margin = t.allowed_linear_error + SPECULATIVE_MARGIN
    he = sh.shape_aabb_half_extents(ctype[None], cparams[None], crot) + margin
    amin, amax = cpos - he, cpos + he
    is_hs = (ctype == sh.HALFSPACE)[None, :, None]
    n_hs = crot[..., :, 1]
    amax = torch.where(is_hs, cpos + sh._HUGE * (1.0 - n_hs) + margin, amax)
    amin = torch.where(is_hs, cpos - sh._HUGE * (1.0 + n_hs) - margin, amin)
    return amin, amax, cpos, crot


def grid_contacts(state: PhysicsState, t: PhysicsTemplate):
    """The grid step's broadphase and narrowphase
    (fyrox_tpu/physics/world.py:1111-1192): directed candidate sets per
    manifold class → each class's narrowphase on canonically ordered pairs
    (twin slots compute the same manifold) → one solver.DirectedSeg a
    class with a nonzero cap, and its warm start: the stored impulses of
    the slots still holding the same pair id, from the class's slice of
    the flat warm arrays. Returns (segs, warm per seg, pair ids per
    seg)."""
    from fyrox_tpu_torch._util import sqrt_rn, value_const
    from fyrox_tpu_torch.physics import broadphase as bp_mod
    from fyrox_tpu_torch.physics import narrowphase as np_mod
    from fyrox_tpu_torch.physics import solver as solver_mod
    w, b = state.position.shape[:2]
    dev = state.position.device
    dtype = state.position.dtype
    gb = t.grid
    amin, amax, cpos, crot = grid_aabbs(state, t)
    col_body_np = np.asarray(t.col_body)
    dyn_col = np.asarray(t.body_type)[col_body_np] == DYNAMIC
    sets = bp_mod.grid_candidates(gb, col_body_np, dyn_col, amin, amax)
    ctype = const(t.col_shape, dev)
    cparams = const(t.col_params, dev)
    kinds = const(gb._kinds, dev)
    cb = const(t.col_body, dev)
    fric = const(t.col_friction, dev)
    rest = const(t.col_restitution, dev)
    pred = value_const(t.allowed_linear_error + SPECULATIVE_MARGIN, dev)
    rows = torch.arange(w, device=dev)[:, None]
    segs, warm_in, pids = [], [], []
    koff = poff = 0
    for cls, cs in enumerate(sets):
        cap = cs.ia.shape[1]
        if cap == 0:
            continue
        npts = bp_mod.CLASS_NPTS[cls]
        ia, ib, valid = cs.ia.long(), cs.ib.long(), cs.valid
        ek_a, ek_b = kinds[ia], kinds[ib]
        swap = (ek_a > ek_b) | ((ek_a == ek_b) & (ia > ib))
        i_a = torch.where(swap, ib, ia)
        i_b = torch.where(swap, ia, ib)
        m = np_mod.generate_contacts_class(
            cls, ctype[i_a], cparams[i_a], cpos[rows, i_a], crot[rows, i_a],
            ctype[i_b], cparams[i_b], cpos[rows, i_b], crot[rows, i_b],
            pred)
        body_self = cb[ia]
        segs.append(solver_mod.DirectedSeg(
            body_a=cb[i_a], body_b=cb[i_b],
            sigma=torch.where(swap, -1.0, 1.0).to(dtype),
            body_self=body_self,
            bounds=solver_mod.segment_bounds(body_self, b),
            normal=m.normal, point=m.points, depth=m.depth,
            active=m.active & valid[..., None],
            friction=sqrt_rn(fric[ia] * fric[ib]),
            restitution=torch.maximum(rest[ia], rest[ib]),
            window=gb.windows_body[cls]))
        same = (state.warm_pair[:, poff:poff + cap] == cs.pid) & valid
        same_k = np_mod.repeat_slots(same, npts)
        kk = cap * npts
        warm_in.append(tuple(
            (arr[:, koff:koff + kk] * same_k).reshape(w, cap, npts)
            for arr in (state.warm_n, state.warm_t1, state.warm_t2)))
        pids.append(cs.pid)
        koff += kk
        poff += cap
    return segs, warm_in, pids


def _step_grid(state: PhysicsState, t: PhysicsTemplate, dt, accel,
               angvel) -> PhysicsState:
    """The grid broadphase step (fyrox_tpu/physics/world.py:1111-1231):
    grid_contacts, solve_tgs_directed, axis locks and damping, and the
    flat warm bookkeeping. Holds no host read, so a CUDA graph captures
    it."""
    from fyrox_tpu_torch.physics import solver as solver_mod
    w, b = state.position.shape[:2]
    inv_mass = const(t.inv_mass, state.position.device)[None].expand(w, b)
    segs, warm_in, pids = grid_contacts(state, t)
    sp = solver_mod.SolverParams(
        dt=dt, erp=t.erp, allowed_linear_error=t.allowed_linear_error,
        max_corrective_velocity=t.max_corrective_velocity,
        restitution_threshold=t.restitution_threshold,
        n_substeps=t.n_substeps, n_pgs=t.n_pgs,
        n_stabilization=t.n_stabilization,
        warmstart_coefficient=t.warmstart_coefficient,
        mass_split_pow=t.mass_split_pow)
    position, rotation, linvel, angvel, lam_out = \
        solver_mod.solve_tgs_directed(
            state.position, state.rotation, state.linvel, angvel,
            t.com_local, inv_mass, t.inv_inertia_local, accel, segs, sp,
            warm=warm_in or None, joints=t.joints)
    position, rotation, linvel, angvel = _apply_locks_damping(
        state, t, dt, position, rotation, linvel, angvel)
    if lam_out:
        warm_n, warm_t1, warm_t2 = (
            torch.cat([lam[i].reshape(w, -1) for lam in lam_out], 1)
            for i in range(3))
        warm_pair = torch.cat(pids, 1)
    else:
        warm_n, warm_t1, warm_t2 = state.warm_n, state.warm_t1, state.warm_t2
        warm_pair = state.warm_pair
    return PhysicsState(position=position, rotation=rotation,
                        linvel=linvel, angvel=angvel,
                        force=torch.zeros_like(state.force),
                        torque=torch.zeros_like(state.torque),
                        warm_n=warm_n, warm_t1=warm_t1, warm_t2=warm_t2,
                        warm_pair=warm_pair, bp_cache=state.bp_cache,
                        bp_age=state.bp_age)


def _arange(t: PhysicsTemplate) -> np.ndarray:
    """[P] int32 0..P-1, one host array per template (so ``const`` copies
    it to a device once)."""
    if getattr(t, "_pair_ids", None) is None:
        t._pair_ids = np.arange(t.num_pairs, dtype=np.int32)
    return t._pair_ids


def external_accelerations(state: PhysicsState, t: PhysicsTemplate, dt):
    """Gravity + user forces as accelerations, user torques applied to the
    angular velocity once per step. Returns (accel [W,B,3], angvel
    [W,B,3])."""
    dev = state.position.device
    dyn = (const(t.body_type, dev) == DYNAMIC)[None, :, None]
    inv_mass = const(t.inv_mass, dev)[None].expand(state.position.shape[:2])
    if getattr(t, "_gravity_f32", None) is None:
        t._gravity_f32 = np.asarray(t.gravity, np.float32)
    g = const(t._gravity_f32, dev)          # no host→device copy per tick
    gscale = const(t.gravity_scale, dev)[None, :, None]
    accel = torch.where(dyn, g * gscale + state.force * inv_mass[..., None],
                        torch.zeros_like(state.force))
    rmat = quat.to_mat3(state.rotation)
    ii_world = quat.sandwich_inv_inertia(rmat,
                                         const(t.inv_inertia_local, dev))
    angvel = state.angvel + dt * torch.where(
        dyn, quat.mv(ii_world, state.torque), torch.zeros_like(state.torque))
    return accel, angvel


def _apply_locks_damping(state, t, dt, position, rotation, linvel, angvel):
    """Axis locks (2D mode / locked DOFs), then rapier damping
    v *= 1/(1 + dt*d)."""
    dev = position.device
    if t.lin_lock is not None:
        keep = const(t.lin_lock, dev)[None]
        linvel = linvel * keep
        angvel = angvel * const(t.ang_lock, dev)[None]
        position = position * keep + state.position * (1.0 - keep)
    ld = const(t.lin_damping, dev)[None, :, None]
    ad = const(t.ang_damping, dev)[None, :, None]
    return (position, rotation, linvel / (1.0 + dt * ld),
            angvel / (1.0 + dt * ad))
