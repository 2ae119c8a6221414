// Per-observation projection, analytic Jacobians and IRLS weight.
//
// One __device__ function per camera model, shared by every kernel that
// linearizes the reprojection error: the fused residual/Jacobian kernel in
// proj.cu, and the normal-equation (K_E) and cost (K_C) kernels of the pcg
// route in eqs.cu.  The math is that of
// pysfm_tpu/solver/kernels/pallas_proj.py (_proj_rows and _kernel) and
// pysfm_tpu/geometry/projection.py (project_with_jac):
//
//   q = R X, p = q + t, (x, y, z) = p
//   A = d uv / d p                                  [2 x 3]
//   J_cam row i = [A_i (-hat(q)), A_i, d uv_i / d intr]
//   J_pt  row i = A_i R
//
// Camera models: POSE (fixed K, CP = 6), POSE_K (fx, fy, cx, cy optimized,
// CP = 10), BAL (-p/z flip, f, k1, k2 optimized, CP = 9).  Everything is
// f32 with IEEE division and square root: build without --use_fast_math.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace pysfm {

enum Model : int { MODEL_POSE = 0, MODEL_POSE_K = 1, MODEL_BAL = 2 };
enum Robust : int { ROBUST_GAUSSIAN = 0, ROBUST_HUBER = 1, ROBUST_CAUCHY = 2 };

template <int MODEL> struct ModelTraits;
template <> struct ModelTraits<MODEL_POSE> {
  static constexpr int CP = 6;
  static constexpr int INTR = 4;
};
template <> struct ModelTraits<MODEL_POSE_K> {
  static constexpr int CP = 10;
  static constexpr int INTR = 4;
};
template <> struct ModelTraits<MODEL_BAL> {
  static constexpr int CP = 9;
  static constexpr int INTR = 3;
};

template <int MODEL>
struct ProjJac {
  static constexpr int CP = ModelTraits<MODEL>::CP;
  float r[2];       // residual: projection - observed uv
  float Jc[2][CP];  // d r / d camera tangent [dw, dt, dintr] (not gauge-masked)
  float Jp[2][3];   // d r / d world point
};

// R: 9 entries row-major; intr: ModelTraits<MODEL>::INTR entries.
template <int MODEL>
__device__ __forceinline__ void project_jac(const float* R, const float* t,
                                            const float* intr, const float* X,
                                            float u_obs, float v_obs,
                                            ProjJac<MODEL>& o) {
  const float q0 = R[0] * X[0] + R[1] * X[1] + R[2] * X[2];
  const float q1 = R[3] * X[0] + R[4] * X[1] + R[5] * X[2];
  const float q2 = R[6] * X[0] + R[7] * X[1] + R[8] * X[2];
  const float x = q0 + t[0], y = q1 + t[1], z = q2 + t[2];
  const float iz = 1.0f / z;
  const float iz2 = iz * iz;

  float A[2][3];
  if constexpr (MODEL == MODEL_BAL) {
    const float f = intr[0], k1 = intr[1], k2 = intr[2];
    const float pn0 = -x * iz, pn1 = -y * iz;
    const float r2 = pn0 * pn0 + pn1 * pn1;
    const float rho = 1.0f + r2 * (k1 + r2 * k2);
    o.r[0] = f * rho * pn0 - u_obs;
    o.r[1] = f * rho * pn1 - v_obs;
    // d uv / d pn = f (rho I + pn drho^T), drho = (2 k1 + 4 k2 r2) pn;
    // d pn / d p = [[-iz, 0, x iz2], [0, -iz, y iz2]].
    const float g = 2.0f * k1 + 4.0f * k2 * r2;
    const float B00 = f * (rho + pn0 * g * pn0);
    const float B01 = f * (pn0 * g * pn1);
    const float B11 = f * (rho + pn1 * g * pn1);
    A[0][0] = -B00 * iz;
    A[0][1] = -B01 * iz;
    A[0][2] = (B00 * x + B01 * y) * iz2;
    A[1][0] = -B01 * iz;
    A[1][1] = -B11 * iz;
    A[1][2] = (B01 * x + B11 * y) * iz2;
    const float pn[2] = {pn0, pn1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o.Jc[i][6] = rho * pn[i];
      o.Jc[i][7] = f * r2 * pn[i];
      o.Jc[i][8] = f * r2 * r2 * pn[i];
    }
  } else {
    const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
    const float pn0 = x * iz, pn1 = y * iz;
    o.r[0] = fx * pn0 + cx - u_obs;
    o.r[1] = fy * pn1 + cy - v_obs;
    A[0][0] = fx * iz;
    A[0][1] = 0.0f;
    A[0][2] = -fx * x * iz2;
    A[1][0] = 0.0f;
    A[1][1] = fy * iz;
    A[1][2] = -fy * y * iz2;
    if constexpr (MODEL == MODEL_POSE_K) {
      o.Jc[0][6] = pn0;  o.Jc[0][7] = 0.0f;  o.Jc[0][8] = 1.0f;  o.Jc[0][9] = 0.0f;
      o.Jc[1][6] = 0.0f; o.Jc[1][7] = pn1;   o.Jc[1][8] = 0.0f;  o.Jc[1][9] = 1.0f;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float Ax = A[i][0], Ay = A[i][1], Az = A[i][2];
    // A (-hat(q)): columns (-Ay qz + Az qy, Ax qz - Az qx, -Ax qy + Ay qx)
    o.Jc[i][0] = -Ay * q2 + Az * q1;
    o.Jc[i][1] = Ax * q2 - Az * q0;
    o.Jc[i][2] = -Ax * q1 + Ay * q0;
    o.Jc[i][3] = Ax;
    o.Jc[i][4] = Ay;
    o.Jc[i][5] = Az;
    o.Jp[i][0] = Ax * R[0] + Ay * R[3] + Az * R[6];
    o.Jp[i][1] = Ax * R[1] + Ay * R[4] + Az * R[7];
    o.Jp[i][2] = Ax * R[2] + Ay * R[5] + Az * R[8];
  }
}

// IRLS weight rho'(s) of the squared residual norm s, knee c
// (pysfm_tpu/problem/robust.py: weight).
template <int ROBUST>
__device__ __forceinline__ float robust_weight(float s, float c) {
  if constexpr (ROBUST == ROBUST_GAUSSIAN) {
    return 1.0f;
  } else if constexpr (ROBUST == ROBUST_HUBER) {
    const float c2 = c * c;
    return s <= c2 ? 1.0f : c / sqrtf(fmaxf(s, c2));
  } else {
    const float c2 = c * c;
    return 1.0f / (1.0f + s / c2);
  }
}

// Robust loss rho(s) of the squared residual norm s, knee c; the cost is
// 0.5 * rho (pysfm_tpu/problem/robust.py: rho).
template <int ROBUST>
__device__ __forceinline__ float robust_rho(float s, float c) {
  if constexpr (ROBUST == ROBUST_GAUSSIAN) {
    return s;
  } else if constexpr (ROBUST == ROBUST_HUBER) {
    const float c2 = c * c;
    return s <= c2 ? s : 2.0f * c * sqrtf(fmaxf(s, c2)) - c2;
  } else {
    const float c2 = c * c;
    return c2 * log1pf(s / c2);
  }
}

// One camera's parameters, read from the packed camera table of the pcg
// route, ctab [Dc, C] with Dc = 13 + INTR (pysfm_tpu_torch/problem/cm.py:
// cam_table): rows 0..8 R row-major, 9..11 t, 12.. intr, last row the free
// flag (0 for a gauge-fixed camera).
template <int MODEL>
struct CamParams {
  float R[9];
  float t[3];
  float intr[ModelTraits<MODEL>::INTR];
  float free;
};

template <int MODEL>
__device__ __forceinline__ void load_cam(const float* __restrict__ ctab, int C,
                                         int c, CamParams<MODEL>& k) {
  constexpr int NI = ModelTraits<MODEL>::INTR;
#pragma unroll
  for (int i = 0; i < 9; ++i) k.R[i] = __ldg(ctab + i * C + c);
#pragma unroll
  for (int i = 0; i < 3; ++i) k.t[i] = __ldg(ctab + (9 + i) * C + c);
#pragma unroll
  for (int i = 0; i < NI; ++i) k.intr[i] = __ldg(ctab + (12 + i) * C + c);
  k.free = __ldg(ctab + (12 + NI) * C + c);
}

// Residual, analytic Jacobians (the camera part multiplied by the free
// flag) and IRLS weight w_conf * rho'(|r|^2) of one observation of camera c
// and point p, X3 [3, P] component-major.
template <int MODEL, int ROBUST>
__device__ __forceinline__ float linearize(const float* __restrict__ ctab, int C,
                                           const float* __restrict__ X3, int P,
                                           int c, int p, float u_obs, float v_obs,
                                           float w_conf, float scale,
                                           ProjJac<MODEL>& o) {
  constexpr int CP = ModelTraits<MODEL>::CP;
  CamParams<MODEL> k;
  load_cam<MODEL>(ctab, C, c, k);
  const size_t Ps = static_cast<size_t>(P);
  const float X[3] = {__ldg(X3 + p), __ldg(X3 + Ps + p), __ldg(X3 + 2 * Ps + p)};
  project_jac<MODEL>(k.R, k.t, k.intr, X, u_obs, v_obs, o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 0; d < CP; ++d) o.Jc[i][d] *= k.free;
  }
  const float s = o.r[0] * o.r[0] + o.r[1] * o.r[1];
  return w_conf * robust_weight<ROBUST>(s, scale);
}

}  // namespace pysfm
