// Plane-form narrowphase pair functions as device functions: the port of
// fyrox_tpu/physics/np_planes.py:74-375 (the 9 combos of CLASS_COMBOS_P
// :344-349), one contact pair per call instead of one [W,K] plane per op.
//
// Each function mirrors the port's own fyrox_tpu_torch/physics/np_planes.py
// and planes.py operation for operation, and every product, sum and
// quotient is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: never contracted into an FMA), in the order the
// plain PyTorch version evaluates it. PyTorch rounds after every elementwise
// op, so the kernels that include this header give the plain version's
// values bit for bit; a one-ulp change in a depth would flip an activation
// and change the compacted contact set. Build without --use_fast_math.
#pragma once
#include <cuda_runtime.h>

namespace fyrox {

enum Kind { kBall = 0, kCuboid = 1, kCapsule = 2, kHalfspace = 5 };

constexpr float kEps = 1e-9f;        // np_planes._EPS
constexpr float kNpHuge = 1e9f;      // the empty manifold's depth magnitude

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.minimum / maximum / clamp on finite values
__device__ __forceinline__ float mn(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return mn(mx(x, lo), hi);
}
__device__ __forceinline__ float m01(bool c) { return c ? 1.0f : 0.0f; }
// torch.sign, then sign == 0 → 1 (np_planes' tie rule)
__device__ __forceinline__ float sign1(float x) {
  const float s = m01(x > 0.0f) - m01(x < 0.0f);
  return s == 0.0f ? 1.0f : s;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add3(V3 a, V3 b) {
  return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}
__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale3(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ float norm3(V3 a) { return __fsqrt_rn(dot3(a, a)); }
__device__ __forceinline__ V3 where3(bool c, V3 a, V3 b) { return c ? a : b; }

// normalize3(a, eps, fallback): (a * (1 / max(|a|, eps)) or fallback, |a|)
__device__ __forceinline__ V3 normalize3(V3 a, float eps, V3 fallback,
                                         float* n_out) {
  const float n = norm3(a);
  const float inv = dvd(1.0f, mx(n, eps));
  *n_out = n;
  return n > eps ? scale3(a, inv) : fallback;
}

// 3x3 rotation, row-major (planes.q_to_rot9)
struct R9 {
  float m[9];
};

__device__ __forceinline__ R9 q_to_rot9(float x, float y, float z, float w) {
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  R9 r;
  r.m[0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  r.m[1] = mul(2.0f, sub(xy, wz));
  r.m[2] = mul(2.0f, add(xz, wy));
  r.m[3] = mul(2.0f, add(xy, wz));
  r.m[4] = sub(1.0f, mul(2.0f, add(xx, zz)));
  r.m[5] = mul(2.0f, sub(yz, wx));
  r.m[6] = mul(2.0f, sub(xz, wy));
  r.m[7] = mul(2.0f, add(yz, wx));
  r.m[8] = sub(1.0f, mul(2.0f, add(xx, yy)));
  return r;
}

__device__ __forceinline__ V3 rot_apply(const R9& r, V3 v) {   // R v
  return {add(add(mul(r.m[0], v.x), mul(r.m[1], v.y)), mul(r.m[2], v.z)),
          add(add(mul(r.m[3], v.x), mul(r.m[4], v.y)), mul(r.m[5], v.z)),
          add(add(mul(r.m[6], v.x), mul(r.m[7], v.y)), mul(r.m[8], v.z))};
}
__device__ __forceinline__ V3 rot_apply_t(const R9& r, V3 v) { // Rᵀ v
  return {add(add(mul(r.m[0], v.x), mul(r.m[3], v.y)), mul(r.m[6], v.z)),
          add(add(mul(r.m[1], v.x), mul(r.m[4], v.y)), mul(r.m[7], v.z)),
          add(add(mul(r.m[2], v.x), mul(r.m[5], v.y)), mul(r.m[8], v.z))};
}
__device__ __forceinline__ V3 rot_col(const R9& r, int j) {
  return {r.m[j], r.m[3 + j], r.m[6 + j]};
}

// A manifold of up to 4 points; normal A → B.
struct Manifold {
  V3 normal;
  V3 pts[4];
  float depth[4];
  float active[4];
};

__device__ __forceinline__ void set_empty(Manifold& m) {
  m.normal = v3(0.0f, 0.0f, 0.0f);
  for (int p = 0; p < 4; ++p) {
    m.pts[p] = v3(0.0f, 0.0f, 0.0f);
    m.depth[p] = -kNpHuge;
    m.active[p] = 0.0f;
  }
}

__device__ __forceinline__ void set_one(Manifold& m, V3 normal, V3 point,
                                        float depth, float pred) {
  m.normal = normal;
  m.pts[0] = point;
  m.depth[0] = depth;
  m.active[0] = m01(depth > -pred);
}

// ---- sphere family --------------------------------------------------------

__device__ __forceinline__ void ball_ball(V3 pa, float ra, V3 pb, float rb,
                                          float pred, Manifold& m) {
  float dist;
  const V3 n = normalize3(sub3(pb, pa), kEps, v3(0.0f, 1.0f, 0.0f), &dist);
  const float depth = sub(add(ra, rb), dist);
  const V3 point = add3(pa, scale3(n, sub(ra, mul(0.5f, depth))));
  set_one(m, n, point, depth, pred);
}

// sphere A vs box B (np_planes.ball_cuboid_p)
__device__ inline void ball_cuboid(V3 pa, float ra, V3 pb, const R9& rot_b, V3 half,
                            float pred, Manifold& m) {
  const V3 rel = rot_apply_t(rot_b, sub3(pa, pb));
  const V3 clamped = {mn(mx(rel.x, -half.x), half.x),
                      mn(mx(rel.y, -half.y), half.y),
                      mn(mx(rel.z, -half.z), half.z)};
  const V3 delta = sub3(rel, clamped);
  const float dist = norm3(delta);
  const bool outside = dist > kEps;
  const float inv = dvd(1.0f, mx(dist, kEps));
  const V3 n_out = scale3(delta, inv);
  const float px = sub(half.x, fabsf(rel.x));
  const float py = sub(half.y, fabsf(rel.y));
  const float pz = sub(half.z, fabsf(rel.z));
  const float axf = mul(m01(px <= py), m01(px <= pz));
  const float ayf = mul(sub(1.0f, axf), m01(py <= pz));
  const float azf = sub(sub(1.0f, axf), ayf);
  const float sgn =
      sign1(add(add(mul(axf, rel.x), mul(ayf, rel.y)), mul(azf, rel.z)));
  const V3 n_in = {mul(axf, sgn), mul(ayf, sgn), mul(azf, sgn)};
  const float depth_out = sub(ra, dist);
  const float depth_in = add(ra, mn(px, mn(py, pz)));
  const V3 n_local = where3(outside, n_out, n_in);
  const float depth = outside ? depth_out : depth_in;
  const V3 surf_in = {
      add(mul(clamped.x, sub(1.0f, axf)), mul(mul(half.x, axf), sgn)),
      add(mul(clamped.y, sub(1.0f, ayf)), mul(mul(half.y, ayf), sgn)),
      add(mul(clamped.z, sub(1.0f, azf)), mul(mul(half.z, azf), sgn))};
  const V3 surf = where3(outside, clamped, surf_in);
  const V3 n_world = rot_apply(rot_b, n_local);
  const V3 p_world = add3(pb, rot_apply(rot_b, surf));
  set_one(m, neg3(n_world), p_world, depth, pred);
}

__device__ __forceinline__ void segment_endpoints(V3 p, const R9& rot, float hh,
                                                  V3* s0, V3* s1) {
  const V3 axis = rot_col(rot, 1);
  *s0 = sub3(p, scale3(axis, hh));
  *s1 = add3(p, scale3(axis, hh));
}

__device__ __forceinline__ V3 closest_on_segment(V3 a, V3 b, V3 p) {
  const V3 ab = sub3(b, a);
  const float t = dvd(dot3(sub3(p, a), ab), mx(dot3(ab, ab), kEps));
  return add3(a, scale3(ab, clampf(t, 0.0f, 1.0f)));
}

__device__ __forceinline__ void ball_capsule(V3 pa, float ra, V3 pb,
                                             const R9& rot_b, float hh,
                                             float rb, float pred,
                                             Manifold& m) {
  V3 s0, s1;
  segment_endpoints(pb, rot_b, hh, &s0, &s1);
  ball_ball(pa, ra, closest_on_segment(s0, s1, pa), rb, pred, m);
}

__device__ inline void closest_segment_segment(V3 a0, V3 a1, V3 b0, V3 b1, V3* ca,
                                        V3* cb) {
  const V3 d1 = sub3(a1, a0);
  const V3 d2 = sub3(b1, b0);
  const V3 r = sub3(a0, b0);
  const float a = dot3(d1, d1);
  const float e = dot3(d2, d2);
  const float f = dot3(d2, r);
  const float c = dot3(d1, r);
  const float b = dot3(d1, d2);
  const float denom = sub(mul(a, e), mul(b, b));
  float s = denom > kEps
                ? clampf(dvd(sub(mul(b, f), mul(c, e)), mx(denom, kEps)), 0.0f,
                         1.0f)
                : 0.0f;
  const float t = dvd(add(mul(b, s), f), mx(e, kEps));
  const float t_cl = clampf(t, 0.0f, 1.0f);
  s = clampf(dvd(sub(mul(b, t_cl), c), mx(a, kEps)), 0.0f, 1.0f);
  const float t2 = clampf(dvd(add(mul(b, s), f), mx(e, kEps)), 0.0f, 1.0f);
  *ca = add3(a0, scale3(d1, s));
  *cb = add3(b0, scale3(d2, t2));
}

__device__ inline void capsule_capsule(V3 pa, const R9& rot_a, float hha, float ra,
                                V3 pb, const R9& rot_b, float hhb, float rb,
                                float pred, Manifold& m) {
  V3 a0, a1, b0, b1, ca, cb;
  segment_endpoints(pa, rot_a, hha, &a0, &a1);
  segment_endpoints(pb, rot_b, hhb, &b0, &b1);
  closest_segment_segment(a0, a1, b0, b1, &ca, &cb);
  ball_ball(ca, ra, cb, rb, pred, m);
}

// cuboid A vs capsule B: sphere-box queries at both segment ends
__device__ inline void cuboid_capsule(V3 pa, const R9& rot_a, V3 half, V3 pb,
                               const R9& rot_b, float hh, float rb,
                               float pred, Manifold& m) {
  V3 b0, b1;
  segment_endpoints(pb, rot_b, hh, &b0, &b1);
  Manifold m0, m1;
  ball_cuboid(b0, rb, pa, rot_a, half, pred, m0);
  ball_cuboid(b1, rb, pa, rot_a, half, pred, m1);
  const bool deeper0 = m0.depth[0] >= m1.depth[0];
  m.normal = neg3(where3(deeper0, m0.normal, m1.normal));
  m.pts[0] = m0.pts[0];
  m.pts[1] = m1.pts[0];
  m.depth[0] = m0.depth[0];
  m.depth[1] = m1.depth[0];
  m.active[0] = m0.active[0];
  m.active[1] = m1.active[0];
}

// ---- halfspace family (plane normal = collider local +Y) ------------------

__device__ __forceinline__ void ball_halfspace(V3 pa, float ra, V3 pp,
                                               const R9& rot_p, float pred,
                                               Manifold& m) {
  const V3 n = rot_col(rot_p, 1);
  const float d = dot3(n, pp);
  const float dist = sub(dot3(n, pa), d);
  set_one(m, neg3(n), sub3(pa, scale3(n, dist)), sub(ra, dist), pred);
}

__device__ inline void capsule_halfspace(V3 pa, const R9& rot_a, float hh, float ra,
                                  V3 pp, const R9& rot_p, float pred,
                                  Manifold& m) {
  const V3 n = rot_col(rot_p, 1);
  const float d = dot3(n, pp);
  V3 e[2];
  segment_endpoints(pa, rot_a, hh, &e[0], &e[1]);
  for (int i = 0; i < 2; ++i) {
    const float dist = sub(dot3(n, e[i]), d);
    const float depth = sub(ra, dist);
    m.pts[i] = sub3(e[i], scale3(n, dist));
    m.depth[i] = depth;
    m.active[i] = m01(depth > -pred);
  }
  m.normal = neg3(n);
}

// box vs plane: the 4 deepest of the 8 corners (rank selection, ties by
// index), each point the masked sum over corners the plain version forms
__device__ inline void cuboid_halfspace(V3 pa, const R9& rot_a, V3 half, V3 pp,
                                 const R9& rot_p, float pred, Manifold& m) {
  const V3 n = rot_col(rot_p, 1);
  const float d = dot3(n, pp);
  V3 corners[8];
  float depths[8];
  int i = 0;
  for (int sx = -1; sx <= 1; sx += 2)
    for (int sy = -1; sy <= 1; sy += 2)
      for (int sz = -1; sz <= 1; sz += 2) {
        const V3 local = {mul(half.x, (float)sx), mul(half.y, (float)sy),
                          mul(half.z, (float)sz)};
        corners[i] = add3(pa, rot_apply(rot_a, local));
        depths[i] = sub(d, dot3(n, corners[i]));
        ++i;
      }
  int ranks[8];
  for (int a = 0; a < 8; ++a) {
    int r = 0;
    for (int b = 0; b < 8; ++b) {
      if (b == a) continue;
      r += (b < a) ? (depths[b] >= depths[a]) : (depths[b] > depths[a]);
    }
    ranks[a] = r;
  }
  for (int k = 0; k < 4; ++k) {
    float px = 0.0f, py = 0.0f, pz = 0.0f, dk = 0.0f;
    for (int a = 0; a < 8; ++a) {
      const float w = m01(ranks[a] == k);
      if (a == 0) {
        px = mul(corners[a].x, w);
        py = mul(corners[a].y, w);
        pz = mul(corners[a].z, w);
        dk = mul(depths[a], w);
      } else {
        px = add(px, mul(corners[a].x, w));
        py = add(py, mul(corners[a].y, w));
        pz = add(pz, mul(corners[a].z, w));
        dk = add(dk, mul(depths[a], w));
      }
    }
    m.pts[k] = v3(px, py, pz);
    m.depth[k] = dk;
    m.active[k] = m01(dk > -pred);
  }
  m.normal = neg3(n);
}

// ---- cuboid-cuboid: SAT over 15 axes + reference-face clipping -----------

__device__ __forceinline__ float face_pen(const V3* axes_a, V3 half_a,
                                          const V3* axes_b, V3 half_b, V3 d,
                                          V3 axis) {
  const float ra = add(add(mul(half_a.x, fabsf(dot3(axes_a[0], axis))),
                           mul(half_a.y, fabsf(dot3(axes_a[1], axis)))),
                       mul(half_a.z, fabsf(dot3(axes_a[2], axis))));
  const float rb = add(add(mul(half_b.x, fabsf(dot3(axes_b[0], axis))),
                           mul(half_b.y, fabsf(dot3(axes_b[1], axis)))),
                       mul(half_b.z, fabsf(dot3(axes_b[2], axis))));
  return sub(add(ra, rb), fabsf(dot3(d, axis)));
}

struct Face {
  V3 corners[4], center, t1, t2;
  float h1, h2;
};

__device__ inline void face_vertices(V3 p, const R9& rot, V3 half, V3 axis_dir,
                              Face& f) {
  const V3 axes[3] = {rot_col(rot, 0), rot_col(rot, 1), rot_col(rot, 2)};
  const float dots[3] = {dot3(axes[0], axis_dir), dot3(axes[1], axis_dir),
                         dot3(axes[2], axis_dir)};
  const float a0 = fabsf(dots[0]), a1 = fabsf(dots[1]), a2 = fabsf(dots[2]);
  const float fxf = mul(m01(a0 >= a1), m01(a0 >= a2));
  const float fyf = mul(sub(1.0f, fxf), m01(a1 >= a2));
  const float fzf = sub(sub(1.0f, fxf), fyf);
  const V3 fa = {fxf, fyf, fzf};
  const V3 ta = {fzf, fxf, fyf};   // (face + 1) % 3 one-hot
  const V3 tb = {fyf, fzf, fxf};   // (face + 2) % 3 one-hot
  const float sgn = sign1(
      add(add(mul(dots[0], fxf), mul(dots[1], fyf)), mul(dots[2], fzf)));
  const float hn = dot3(half, fa);
  const float ht1 = dot3(half, ta);
  const float ht2 = dot3(half, tb);
  const V3 n_l = scale3(fa, sgn);
  int i = 0;
  for (int s1 = -1; s1 <= 1; s1 += 2)
    for (int s2 = -1; s2 <= 1; s2 += 2) {
      const V3 c_local =
          add3(scale3(n_l, hn), add3(scale3(ta, mul(ht1, (float)s1)),
                                     scale3(tb, mul(ht2, (float)s2))));
      f.corners[i++] = add3(p, rot_apply(rot, c_local));
    }
  f.t1 = rot_apply(rot, ta);
  f.t2 = rot_apply(rot, tb);
  f.center = add3(p, rot_apply(rot, scale3(n_l, hn)));
  f.h1 = ht1;
  f.h2 = ht2;
}

__device__ inline void cuboid_cuboid(V3 pa, const R9& rot_a, V3 half_a, V3 pb,
                              const R9& rot_b, V3 half_b, float pred,
                              Manifold& m) {
  const V3 d = sub3(pb, pa);
  const V3 axes_a[3] = {rot_col(rot_a, 0), rot_col(rot_a, 1), rot_col(rot_a, 2)};
  const V3 axes_b[3] = {rot_col(rot_b, 0), rot_col(rot_b, 1), rot_col(rot_b, 2)};
  float best_pen = kNpHuge;
  V3 best_axis = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 6; ++k) {
    const V3 axis = k < 3 ? axes_a[k] : axes_b[k - 3];
    const float pen = face_pen(axes_a, half_a, axes_b, half_b, d, axis);
    if (pen < best_pen) {
      best_pen = pen;
      best_axis = axis;
    }
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float ln;
      V3 axis = normalize3(cross3(axes_a[i], axes_b[j]), kEps,
                           v3(0.0f, 0.0f, 0.0f), &ln);
      axis = where3(ln > 1e-6f, axis, best_axis);
      const float pen = face_pen(axes_a, half_a, axes_b, half_b, d, axis);
      if (ln > 1e-6f && pen < sub(best_pen, 1e-6f)) {
        best_pen = pen;
        best_axis = axis;
      }
    }
  const bool flip = dot3(best_axis, d) < 0.0f;
  const V3 normal = where3(flip, neg3(best_axis), best_axis);
  Face ref, inc;
  face_vertices(pa, rot_a, half_a, normal, ref);
  face_vertices(pb, rot_b, half_b, neg3(normal), inc);
  const float plane_d = dot3(normal, ref.center);
  const bool pen_ok = best_pen > -pred;
  for (int k = 0; k < 4; ++k) {
    const V3 ip = inc.corners[k];
    const V3 rel = sub3(ip, ref.center);
    const float u = mn(mx(dot3(rel, ref.t1), -ref.h1), ref.h1);
    const float v = mn(mx(dot3(rel, ref.t2), -ref.h2), ref.h2);
    m.pts[k] = add3(ref.center, add3(scale3(ref.t1, u), scale3(ref.t2, v)));
    const float depth = sub(plane_d, dot3(normal, ip));
    m.depth[k] = depth;
    m.active[k] = mul(m01(depth > -pred), m01(pen_ok));
  }
  m.normal = normal;
}

// ---- dispatcher (np_planes.generate_class_planes for one pair) -----------
// Canonically ordered kinds (ka <= kb); p6 = params (radius | half extents |
// half height, radius). A pair outside its class's combos gets the empty
// manifold.
__device__ inline void class_manifold(int cls, int ka, int kb, V3 pos_a,
                               const R9& rot_a, const float* p6a, V3 pos_b,
                               const R9& rot_b, const float* p6b, float pred,
                               Manifold& m) {
  set_empty(m);
  if (cls == 0) {
    if (ka == kBall && kb == kBall)
      ball_ball(pos_a, p6a[0], pos_b, p6b[0], pred, m);
    else if (ka == kBall && kb == kCuboid)
      ball_cuboid(pos_a, p6a[0], pos_b, rot_b, v3(p6b[0], p6b[1], p6b[2]),
                  pred, m);
    else if (ka == kBall && kb == kCapsule)
      ball_capsule(pos_a, p6a[0], pos_b, rot_b, p6b[0], p6b[1], pred, m);
    else if (ka == kBall && kb == kHalfspace)
      ball_halfspace(pos_a, p6a[0], pos_b, rot_b, pred, m);
    else if (ka == kCapsule && kb == kCapsule)
      capsule_capsule(pos_a, rot_a, p6a[0], p6a[1], pos_b, rot_b, p6b[0],
                      p6b[1], pred, m);
  } else if (cls == 1) {
    if (ka == kCuboid && kb == kCapsule)
      cuboid_capsule(pos_a, rot_a, v3(p6a[0], p6a[1], p6a[2]), pos_b, rot_b,
                     p6b[0], p6b[1], pred, m);
    else if (ka == kCapsule && kb == kHalfspace)
      capsule_halfspace(pos_a, rot_a, p6a[0], p6a[1], pos_b, rot_b, pred, m);
  } else {
    if (ka == kCuboid && kb == kCuboid)
      cuboid_cuboid(pos_a, rot_a, v3(p6a[0], p6a[1], p6a[2]), pos_b, rot_b,
                    v3(p6b[0], p6b[1], p6b[2]), pred, m);
    else if (ka == kCuboid && kb == kHalfspace)
      cuboid_halfspace(pos_a, rot_a, v3(p6a[0], p6a[1], p6a[2]), pos_b,
                       rot_b, pred, m);
  }
}

}  // namespace fyrox
