/*
 * Physics step kernels of the PyTorch port, written by hand for Hopper
 * (sm_90a). Built with nvcc into a shared library with a plain C interface
 * and bound with ctypes by omniisaacgymenvs_torch/ops/fused_step.py.
 *
 * Which TPU kernel each entry replaces
 *   oige_step -> omniisaacgymenvs_tpu/ops/fused_substep.py, batched_step /
 *                _step_kernel(n_steps) (K1): n_steps whole substeps (forward
 *                kinematics, ground contacts, PD and passive drives, the
 *                articulated-body algorithm with a 6x6 Cholesky solve at the
 *                floating root, semi-implicit integration with limits and
 *                velocity caps) followed by the report FK epilogue.
 *   oige_fk   -> the same file, batched_fk / fk_kernel (K2): report FK only,
 *                (q, qd) -> world pos, quat, angular and linear velocity of
 *                every body.
 *   Scope of this slice: one FREE root at body 0, revolute joints, the flat
 *   ground plane z = 0 with per-point gains, force sensors. The wrapper
 *   refuses models with anything else (pair contacts, tendons, gravity
 *   compensation, FIXED roots, prismatic joints, terrain planes,
 *   randomization overlays).
 *
 * What bounds it on this card
 *   Per env, K1 moves about 2.4 KB (250 input and 353 output floats for the
 *   Humanoid) and does of order 10^5 FP32 operations over 4 substeps, so by
 *   the roofline it is bound by FP32 issue, not by device-memory bytes
 *   (ops/fused_step.py op_count counts what the function needs: it skips
 *   X's zero block and uses the symmetry of X^T Ia X, which this kernel
 *   does not; layouts of the inward pass that skip them measured slower on
 *   the H100, as they cost registers and spill). The real limit of
 *   this first design is thread-local memory: the per-body articulated
 *   inertias (36 floats per body) and the other per-body arrays of one env
 *   (about 13.8 KB for the Humanoid) do not fit in registers and live in
 *   the thread's stack frame in local memory, served by L1/L2.
 *
 * What the design does about it
 *   One thread per env with the tail masked; the substep loop runs inside
 *   the thread, so the state never returns to device memory between
 *   substeps, and every input is read once and every output written once
 *   per launch. Model constants sit in one packed device table built once
 *   per engine and read with __ldg: all threads of a warp read the same
 *   address, so each read is a broadcast. Bodies are walked in index order
 *   (parent < child): forward for kinematics and the outward pass, backward
 *   for the inward pass. Local-memory scratch is accepted in this first
 *   version.
 *
 * Precision: built without fast math. sqrtf, divisions, sincosf and tanhf
 * are the precise functions, and the floors are those of the JAX kernel:
 * 1e-12 in the Cholesky, in Shepperd's quaternion and in the friction
 * norm, 1e-6 in the friction divisor, 1e-24 in the quaternion exponential.
 * min, max and clamp propagate NaN like jnp.minimum/maximum, so a state
 * that blows up stays non-finite and the task's finite guard sees it.
 */

#include <cuda_runtime.h>
#include <math.h>

#define OIGE_NB_MAX 32                  // bodies per model
#define OIGE_NCP_MAX 64                 // ground contact points
#define OIGE_NS_MAX 8                   // force sensors
#define OIGE_NQ_MAX (6 + OIGE_NB_MAX)   // FREE root (7) + one q per joint
#define OIGE_NV_MAX (5 + OIGE_NB_MAX)   // FREE root (6) + one qd per joint

// ---- packed model table (must match ops/fused_step.py pack_tables) ----
// float table: [0..2] gravity, [3] substep h, [4] Hunt-Crossley chi,
// [5..7] unused, then one 64-float record per body, then one 8-float
// record per contact point. int table: parent of each body, then the body
// of each contact point, then the body of each sensor.
#define F_BODY 8
#define BODY_STRIDE 64
#define CP_STRIDE 8
enum {
  B_AXIS = 0, B_ET = 3, B_JPOS = 12, B_I6 = 15, B_ARM = 51, B_DAMP = 52,
  B_FRIC = 53, B_KP = 54, B_KD = 55, B_EMAX = 56, B_VMAX = 57, B_LO = 58,
  B_HI = 59, B_DIMPL = 60
};
enum { C_POS = 0, C_RAD = 3, C_MU = 4, C_KN = 5, C_KT = 6, C_FNM = 7 };

namespace {

struct Tables {
  const float* __restrict__ f;
  const int* __restrict__ it;
  int nb, ncp, ns;
};

__device__ __forceinline__ float tf(const Tables& t, int i) { return __ldg(t.f + i); }
__device__ __forceinline__ int ti(const Tables& t, int i) { return __ldg(t.it + i); }

// NaN-propagating min / max / clamp (jnp.minimum, jnp.maximum, jnp.clip)
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// y = A x and y = A^T x for a row-major 3x3 A (y must not alias x)
__device__ __forceinline__ void mv3(const float* A, const float* x, float* y) {
  y[0] = A[0] * x[0] + A[1] * x[1] + A[2] * x[2];
  y[1] = A[3] * x[0] + A[4] * x[1] + A[5] * x[2];
  y[2] = A[6] * x[0] + A[7] * x[1] + A[8] * x[2];
}
__device__ __forceinline__ void mtv3(const float* A, const float* x, float* y) {
  y[0] = A[0] * x[0] + A[3] * x[1] + A[6] * x[2];
  y[1] = A[1] * x[0] + A[4] * x[1] + A[7] * x[2];
  y[2] = A[2] * x[0] + A[5] * x[1] + A[8] * x[2];
}
// c = a x b (c must not alias a or b)
__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// world rotation matrix of a wxyz quaternion (not renormalized, as in JAX)
__device__ __forceinline__ void quat_mat(float w, float x, float y, float z, float* R) {
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - w * z);
  R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y);
  R[7] = 2.f * (y * z + w * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
}

// branch-free Shepperd rotation matrix -> wxyz quaternion
__device__ __forceinline__ void mat_quat(const float* R, float* out) {
  const float tr = R[0] + R[4] + R[8];
  float qw = 0.5f * sqrtf(jmax(1.f + tr, 1e-12f));
  float qx = 0.5f * sqrtf(jmax(1.f + R[0] - R[4] - R[8], 1e-12f));
  float qy = 0.5f * sqrtf(jmax(1.f - R[0] + R[4] - R[8], 1e-12f));
  float qz = 0.5f * sqrtf(jmax(1.f - R[0] - R[4] + R[8], 1e-12f));
  qx = copysignf(qx, R[7] - R[5]);
  qy = copysignf(qy, R[2] - R[6]);
  qz = copysignf(qz, R[3] - R[1]);
  const float n = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz + 1e-12f);
  out[0] = qw / n;
  out[1] = qx / n;
  out[2] = qy / n;
  out[3] = qz / n;
}

// Cholesky solve of the 6x6 SPD system A x = b (row-major A)
__device__ __forceinline__ void chol_solve6(const float* A, const float* b, float* x) {
  float L[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[6 * i + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = (i == j) ? sqrtf(jmax(s, 1e-12f)) : s / L[6 * j + j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[6 * i + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[6 * i + i];
  }
}

// per-body kinematics of one env
struct Frames {
  float Rw[OIGE_NB_MAX][9];  // world rotation (x_world = Rw x_body)
  float pw[OIGE_NB_MAX][3];  // world position of the body origin
  float E[OIGE_NB_MAX][9];   // parent -> body rotation (joints)
  float w[OIGE_NB_MAX][3];   // body-frame angular velocity
  float l[OIGE_NB_MAX][3];   // body-frame linear velocity of the origin
  float cw[OIGE_NB_MAX][3];  // velocity-product bias v x vJ, angular part
  float cl[OIGE_NB_MAX][3];  // velocity-product bias, linear part
  float wv[OIGE_NB_MAX][3];  // world angular velocity
  float lv[OIGE_NB_MAX][3];  // world linear velocity of the origin
};

// forward kinematics: q index of joint body i is 6 + i, qd index 5 + i
__device__ __forceinline__ void fk_full(const Tables& t, const float* q,
                                        const float* qd, Frames& k) {
  quat_mat(q[3], q[4], q[5], q[6], k.Rw[0]);
  for (int c = 0; c < 3; ++c) {
    k.pw[0][c] = q[c];
    k.w[0][c] = qd[c];
    k.l[0][c] = qd[3 + c];
    k.cw[0][c] = 0.f;
    k.cl[0][c] = 0.f;
  }
  for (int i = 1; i < t.nb; ++i) {
    const int p = ti(t, i);
    const int B = F_BODY + BODY_STRIDE * i;
    float a[3], r[3], Et[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = tf(t, B + B_AXIS + c);
      r[c] = tf(t, B + B_JPOS + c);
    }
#pragma unroll
    for (int c = 0; c < 9; ++c) Et[c] = tf(t, B + B_ET + c);
    const float th = q[6 + i], thd = qd[5 + i];
    float s, co;
    sincosf(th, &s, &co);
    const float oc = 1.f - co;
    // Rodrigues rotation about the joint axis; E = R^T Et
    const float R[9] = {
        co + a[0] * a[0] * oc, a[0] * a[1] * oc - a[2] * s, a[0] * a[2] * oc + a[1] * s,
        a[1] * a[0] * oc + a[2] * s, co + a[1] * a[1] * oc, a[1] * a[2] * oc - a[0] * s,
        a[2] * a[0] * oc - a[1] * s, a[2] * a[1] * oc + a[0] * s, co + a[2] * a[2] * oc};
    float* E = k.E[i];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        E[3 * rr + cc] = R[rr] * Et[cc] + R[3 + rr] * Et[3 + cc] + R[6 + rr] * Et[6 + cc];
    // v_i = X_i v_p + S thd, with S = [axis; 0]
    float crs[3], tmp[3];
    cross3(r, k.w[p], crs);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmp[c] = k.l[p][c] - crs[c];
    mv3(E, k.w[p], k.w[i]);
    mv3(E, tmp, k.l[i]);
    float vJ[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vJ[c] = a[c] * thd;
      k.w[i][c] += vJ[c];
    }
    cross3(k.w[i], vJ, k.cw[i]);
    cross3(k.l[i], vJ, k.cl[i]);
    // Rw_i = Rw_p E^T, pw_i = pw_p + Rw_p r
#pragma unroll
    for (int rr = 0; rr < 3; ++rr)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        k.Rw[i][3 * rr + cc] = k.Rw[p][3 * rr] * E[3 * cc] +
                               k.Rw[p][3 * rr + 1] * E[3 * cc + 1] +
                               k.Rw[p][3 * rr + 2] * E[3 * cc + 2];
    mv3(k.Rw[p], r, tmp);
#pragma unroll
    for (int c = 0; c < 3; ++c) k.pw[i][c] = k.pw[p][c] + tmp[c];
  }
  for (int i = 0; i < t.nb; ++i) {
    mv3(k.Rw[i], k.w[i], k.wv[i]);
    mv3(k.Rw[i], k.l[i], k.lv[i]);
  }
}

// per-env scratch of the dynamics
struct Work {
  Frames k;
  float fx[OIGE_NB_MAX][3];   // world contact force per body
  float tx[OIGE_NB_MAX][3];   // world contact torque about the body origin
  float IA[OIGE_NB_MAX][36];  // articulated inertia, row-major 6x6
  float pA[OIGE_NB_MAX][6];   // articulated bias force
  float U[OIGE_NB_MAX][6];
  float acc[OIGE_NB_MAX][6];  // spatial acceleration
  float D[OIGE_NB_MAX];
  float uu[OIGE_NB_MAX];
  float tau[OIGE_NB_MAX];     // joint torque of joint body i
  float qdd[OIGE_NV_MAX];
  float qn[OIGE_NQ_MAX];
  float qdn[OIGE_NV_MAX];
};

// one substep of one env: (q, qd) -> (q, qd) in place; leaves this
// substep's contact wrenches in w.fx / w.tx
__device__ __forceinline__ void substep(const Tables& t, float* q, float* qd,
                                        const float* eff, const float* ptg,
                                        const float* vtg, const float* fapp,
                                        Work& w) {
  const int nb = t.nb;
  const float h = tf(t, 3);
  const float chi = tf(t, 4);
  Frames& k = w.k;
  fk_full(t, q, qd, k);

  // ---- ground contacts against z = 0 ----
  for (int i = 0; i < nb; ++i)
    for (int c = 0; c < 3; ++c) w.fx[i][c] = w.tx[i][c] = 0.f;
  const int CP0 = F_BODY + BODY_STRIDE * nb;
  for (int c_ = 0; c_ < t.ncp; ++c_) {
    const int b = ti(t, nb + c_);
    const int C = CP0 + CP_STRIDE * c_;
    float lp[3], rel[3], crs[3], vpt[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) lp[c] = tf(t, C + C_POS + c);
    mv3(k.Rw[b], lp, rel);
    cross3(k.wv[b], rel, crs);
#pragma unroll
    for (int c = 0; c < 3; ++c) vpt[c] = k.lv[b][c] + crs[c];
    const float pen = tf(t, C + C_RAD) - (k.pw[b][2] + rel[2]);
    const float vn = vpt[2];
    const float fn = jmin(tf(t, C + C_KN) * jmax(pen, 0.f) *
                              jclip(1.f - chi * vn, 0.f, 5.f),
                          tf(t, C + C_FNM));
    const float vt0 = vpt[0], vt1 = vpt[1];
    const float vt_norm = sqrtf(vt0 * vt0 + vt1 * vt1 + 1e-12f);
    const float ft_mag = jmin(tf(t, C + C_MU) * fn, tf(t, C + C_KT) * vt_norm);
    const float sc = ft_mag / (vt_norm + 1e-6f);
    const float f[3] = {-sc * vt0, -sc * vt1, fn};
    float n[3];
    cross3(rel, f, n);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w.fx[b][c] += f[c];
      w.tx[b][c] += n[c];
    }
  }

  // ---- drives: clamped Stable-PD + effort + passive damping/friction ----
  for (int i = 1; i < nb; ++i) {
    const int B = F_BODY + BODY_STRIDE * i;
    const int d = i - 1;
    const float qj = q[6 + i], qjd = qd[5 + i];
    const float emax = tf(t, B + B_EMAX);
    const float drive = jclip(tf(t, B + B_KP) * (ptg[d] - qj - h * qjd) +
                                  tf(t, B + B_KD) * (vtg[d] - qjd),
                              -emax, emax);
    const float passive = -tf(t, B + B_DAMP) * qjd - tf(t, B + B_FRIC) * tanhf(qjd * 10.f);
    w.tau[i] = drive + eff[d] + passive;
  }

  // ---- ABA: bias forces with the external wrench in body coordinates ----
  for (int i = 0; i < nb; ++i) {
    const int B = F_BODY + BODY_STRIDE * i;
    float* IA = w.IA[i];
#pragma unroll
    for (int c = 0; c < 36; ++c) IA[c] = tf(t, B + B_I6 + c);
    // I v with I = [[Io, m cx], [m cx^T, m 1]]: the skew blocks have a zero
    // diagonal and the mass block is diagonal, so those terms are skipped
    const float* wi = k.w[i];
    const float* li = k.l[i];
    float Iv[6];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int r1 = (r + 1) % 3, r2 = (r + 2) % 3;
      Iv[r] = IA[6 * r] * wi[0] + IA[6 * r + 1] * wi[1] + IA[6 * r + 2] * wi[2] +
              IA[6 * r + 3 + r1] * li[r1] + IA[6 * r + 3 + r2] * li[r2];
      Iv[3 + r] = IA[6 * (3 + r) + r1] * wi[r1] + IA[6 * (3 + r) + r2] * wi[r2] +
                  IA[6 * (3 + r) + 3 + r] * li[r];
    }
    float n1[3], n2[3], f6[3];
    cross3(k.w[i], Iv, n1);
    cross3(k.l[i], Iv + 3, n2);
    cross3(k.w[i], Iv + 3, f6);
    float tw[3], fw[3], tb[3], fb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tw[c] = w.tx[i][c] + fapp[6 * i + c];
      fw[c] = w.fx[i][c] + fapp[6 * i + 3 + c];
    }
    mtv3(k.Rw[i], tw, tb);
    mtv3(k.Rw[i], fw, fb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w.pA[i][c] = n1[c] + n2[c] - tb[c];
      w.pA[i][3 + c] = f6[c] - fb[c];
    }
  }

  // ---- ABA inward pass, deepest body first ----
  for (int i = nb - 1; i >= 1; --i) {
    const int p = ti(t, i);
    const int B = F_BODY + BODY_STRIDE * i;
    const float a[3] = {tf(t, B + B_AXIS), tf(t, B + B_AXIS + 1), tf(t, B + B_AXIS + 2)};
    const float* IA = w.IA[i];
    float* U = w.U[i];
#pragma unroll
    for (int r = 0; r < 6; ++r)
      U[r] = IA[6 * r] * a[0] + IA[6 * r + 1] * a[1] + IA[6 * r + 2] * a[2];
    const float D = a[0] * U[0] + a[1] * U[1] + a[2] * U[2] + tf(t, B + B_ARM) +
                    tf(t, B + B_DIMPL);
    const float uu = w.tau[i] - (a[0] * w.pA[i][0] + a[1] * w.pA[i][1] + a[2] * w.pA[i][2]);
    w.D[i] = D;
    w.uu[i] = uu;
    const float invD = 1.f / D;
    float Ia[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) Ia[6 * r + c] = IA[6 * r + c] - U[r] * U[c] * invD;
    const float c6[6] = {k.cw[i][0], k.cw[i][1], k.cw[i][2], k.cl[i][0], k.cl[i][1], k.cl[i][2]};
    float pa[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s += Ia[6 * r + c] * c6[c];
      pa[r] = w.pA[i][r] + s + U[r] * (uu * invD);
    }
    // X = [[E, 0], [-E rtil, E]], rtil = skew(r)
    const float* E = k.E[i];
    const float r0 = tf(t, B + B_JPOS), r1 = tf(t, B + B_JPOS + 1), r2 = tf(t, B + B_JPOS + 2);
    const float rt[9] = {0.f, -r2, r1, r2, 0.f, -r0, -r1, r0, 0.f};
    float X[36];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float Q = E[3 * rr] * rt[cc] + E[3 * rr + 1] * rt[3 + cc] + E[3 * rr + 2] * rt[6 + cc];
        X[6 * rr + cc] = E[3 * rr + cc];
        X[6 * rr + 3 + cc] = 0.f;
        X[6 * (3 + rr) + cc] = -Q;
        X[6 * (3 + rr) + 3 + cc] = E[3 * rr + cc];
      }
    // IA_p += X^T Ia X, pA_p += X^T pa
    float T[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < 6; ++m) s += Ia[6 * r + m] * X[6 * m + c];
        T[6 * r + c] = s;
      }
    float* IAp = w.IA[p];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < 6; ++m) s += X[6 * m + r] * T[6 * m + c];
        IAp[6 * r + c] += s;
      }
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < 6; ++m) s += X[6 * m + r] * pa[m];
      w.pA[p][r] += s;
    }
  }

  // ---- root: a0 = X_root [0; -g], solve IA_0 qdd_0 = -(pA_0 + IA_0 a0) ----
  {
    const float mg[3] = {-tf(t, 0), -tf(t, 1), -tf(t, 2)};
    float al[3];
    mtv3(k.Rw[0], mg, al);
    const float a0[6] = {0.f, 0.f, 0.f, al[0], al[1], al[2]};
    float rhs[6], x[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s += w.IA[0][6 * r + c] * a0[c];
      rhs[r] = -(w.pA[0][r] + s);
    }
    chol_solve6(w.IA[0], rhs, x);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      w.qdd[c] = x[c];
      w.acc[0][c] = a0[c] + x[c];
    }
  }

  // ---- ABA outward pass ----
  for (int i = 1; i < nb; ++i) {
    const int p = ti(t, i);
    const int B = F_BODY + BODY_STRIDE * i;
    const float a[3] = {tf(t, B + B_AXIS), tf(t, B + B_AXIS + 1), tf(t, B + B_AXIS + 2)};
    const float r[3] = {tf(t, B + B_JPOS), tf(t, B + B_JPOS + 1), tf(t, B + B_JPOS + 2)};
    const float* E = k.E[i];
    const float* ap = w.acc[p];
    float crs[3], tmp[3], apw[3], apl[3];
    cross3(r, ap, crs);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmp[c] = ap[3 + c] - crs[c];
    mv3(E, ap, apw);
    mv3(E, tmp, apl);
    float a_p[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a_p[c] = apw[c] + k.cw[i][c];
      a_p[3 + c] = apl[c] + k.cl[i][c];
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) s += w.U[i][c] * a_p[c];
    const float qdd_i = (w.uu[i] - s) / w.D[i];
    w.qdd[5 + i] = qdd_i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w.acc[i][c] = a_p[c] + a[c] * qdd_i;
      w.acc[i][3 + c] = a_p[3 + c];
    }
  }

  // ---- semi-implicit Euler: caps, joint velocity clamp, limits ----
  const int nq = 6 + nb, nv = 5 + nb;
  // the velocity and joint-position updates round the product and the sum
  // separately (no fused multiply-add), as the plain version does: a joint
  // that lands on its limit then takes the same branch in both
  for (int c = 0; c < nv; ++c) w.qdn[c] = __fadd_rn(qd[c], __fmul_rn(h, w.qdd[c]));
  for (int c = 0; c < nq; ++c) w.qn[c] = q[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w.qdn[c] = jclip(w.qdn[c], -64.f, 64.f);
    w.qdn[3 + c] = jclip(w.qdn[3 + c], -1000.f, 1000.f);
  }
  for (int i = 1; i < nb; ++i) {
    const int B = F_BODY + BODY_STRIDE * i;
    const float vmax = tf(t, B + B_VMAX);
    const float lo = tf(t, B + B_LO), hi = tf(t, B + B_HI);
    float qjd = jclip(w.qdn[5 + i], -vmax, vmax);
    float qj = __fadd_rn(q[6 + i], __fmul_rn(h, qjd));
    const bool hit_lb = qj < lo;
    const bool hit_ub = qj > hi;
    qj = jclip(qj, lo, hi);
    if (hit_ub) qjd = jmin(qjd, 0.f);
    if (hit_lb) qjd = jmax(qjd, 0.f);
    w.qn[6 + i] = qj;
    w.qdn[5 + i] = qjd;
  }
  {
    float dp[3];
    mv3(k.Rw[0], &w.qdn[3], dp);
#pragma unroll
    for (int c = 0; c < 3; ++c) w.qn[c] = q[c] + h * dp[c];
    // q' = q * exp(omega h / 2)
    const float hx = w.qdn[0] * (h / 2.f), hy = w.qdn[1] * (h / 2.f), hz = w.qdn[2] * (h / 2.f);
    const float ang = sqrtf(hx * hx + hy * hy + hz * hz + 1e-24f);
    const float sa = sinf(ang) / ang;
    const float ew = cosf(ang), ex = sa * hx, ey = sa * hy, ez = sa * hz;
    const float qw = q[3], qx = q[4], qy = q[5], qz = q[6];
    const float nw = qw * ew - qx * ex - qy * ey - qz * ez;
    const float nx = qw * ex + qx * ew + qy * ez - qz * ey;
    const float ny = qw * ey - qx * ez + qy * ew + qz * ex;
    const float nz = qw * ez + qx * ey - qy * ex + qz * ew;
    const float norm = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz + 1e-12f);
    w.qn[3] = nw / norm;
    w.qn[4] = nx / norm;
    w.qn[5] = ny / norm;
    w.qn[6] = nz / norm;
  }
  for (int c = 0; c < nq; ++c) q[c] = w.qn[c];
  for (int c = 0; c < nv; ++c) qd[c] = w.qdn[c];
}

// report FK fields of one env: pos (nb,3), quat (nb,4), avel, lvel (nb,3)
__device__ __forceinline__ void write_report(const Tables& t, const Frames& k, long e,
                                             float* pos, float* quat, float* avel,
                                             float* lvel) {
  const int nb = t.nb;
  for (int i = 0; i < nb; ++i) {
    const long o3 = (e * nb + i) * 3, o4 = (e * nb + i) * 4;
    float qt[4];
    mat_quat(k.Rw[i], qt);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pos[o3 + c] = k.pw[i][c];
      avel[o3 + c] = k.wv[i][c];
      lvel[o3 + c] = k.lv[i][c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) quat[o4 + c] = qt[c];
  }
}

__device__ __forceinline__ void step_env(const Tables t, long e, const float* q_in,
                                         const float* qd_in, const float* eff,
                                         const float* ptg, const float* vtg,
                                         const float* fapp, float* q_out,
                                         float* qd_out, float* sf_out, float* pos,
                                         float* quat, float* avel, float* lvel,
                                         int n_steps) {
  const int nb = t.nb, nq = 6 + nb, nv = 5 + nb, njd = nb - 1;
  float q[OIGE_NQ_MAX], qd[OIGE_NV_MAX];
  Work w;
  for (int c = 0; c < nq; ++c) q[c] = q_in[e * nq + c];
  for (int c = 0; c < nv; ++c) qd[c] = qd_in[e * nv + c];
  const float* eff_e = eff + e * njd;
  const float* ptg_e = ptg + e * njd;
  const float* vtg_e = vtg + e * njd;
  const float* fapp_e = fapp + e * 6 * nb;
  for (int s = 0; s < n_steps; ++s)
    substep(t, q, qd, eff_e, ptg_e, vtg_e, fapp_e, w);
  for (int c = 0; c < nq; ++c) q_out[e * nq + c] = q[c];
  for (int c = 0; c < nv; ++c) qd_out[e * nv + c] = qd[c];
  // sensors read the last substep's contact wrench [force, torque]
  for (int s = 0; s < t.ns; ++s) {
    const int b = ti(t, nb + t.ncp + s);
    const long o = (e * t.ns + s) * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sf_out[o + c] = w.fx[b][c];
      sf_out[o + 3 + c] = w.tx[b][c];
    }
  }
  fk_full(t, q, qd, w.k);
  write_report(t, w.k, e, pos, quat, avel, lvel);
}

__device__ __forceinline__ void fk_env(const Tables t, long e, const float* q_in,
                                       const float* qd_in, float* pos, float* quat,
                                       float* avel, float* lvel) {
  const int nb = t.nb, nq = 6 + nb, nv = 5 + nb;
  float q[OIGE_NQ_MAX], qd[OIGE_NV_MAX];
  Frames k;
  for (int c = 0; c < nq; ++c) q[c] = q_in[e * nq + c];
  for (int c = 0; c < nv; ++c) qd[c] = qd_in[e * nv + c];
  fk_full(t, q, qd, k);
  write_report(t, k, e, pos, quat, avel, lvel);
}

__global__ void __launch_bounds__(128) step_kernel(
    const Tables t, const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ eff, const float* __restrict__ ptg,
    const float* __restrict__ vtg, const float* __restrict__ fapp,
    float* __restrict__ q_out, float* __restrict__ qd_out, float* __restrict__ sf_out,
    float* __restrict__ pos, float* __restrict__ quat, float* __restrict__ avel,
    float* __restrict__ lvel, int n_env, int n_steps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_env) return;
  step_env(t, e, q_in, qd_in, eff, ptg, vtg, fapp, q_out, qd_out, sf_out, pos, quat,
           avel, lvel, n_steps);
}

__global__ void __launch_bounds__(128) fk_kernel(
    const Tables t, const float* __restrict__ q_in, const float* __restrict__ qd_in,
    float* __restrict__ pos, float* __restrict__ quat, float* __restrict__ avel,
    float* __restrict__ lvel, int n_env) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_env) return;
  fk_env(t, e, q_in, qd_in, pos, quat, avel, lvel);
}

}  // namespace

// ---- C entry points: launch on the caller's stream, return cudaError_t ----
#define OIGE_THREADS 128

extern "C" int oige_limits(int* out) {
  out[0] = OIGE_NB_MAX;
  out[1] = OIGE_NCP_MAX;
  out[2] = OIGE_NS_MAX;
  return 0;
}

extern "C" int oige_step(const float* ftab, const int* itab, int nb, int ncp, int ns,
                         const float* q, const float* qd, const float* eff,
                         const float* ptg, const float* vtg, const float* fapp,
                         float* q_out, float* qd_out, float* sf_out, float* pos,
                         float* quat, float* avel, float* lvel, int n_env, int n_steps,
                         void* stream) {
  const Tables t{ftab, itab, nb, ncp, ns};
  const int blocks = (n_env + OIGE_THREADS - 1) / OIGE_THREADS;
  step_kernel<<<blocks, OIGE_THREADS, 0, (cudaStream_t)stream>>>(
      t, q, qd, eff, ptg, vtg, fapp, q_out, qd_out, sf_out, pos, quat, avel, lvel,
      n_env, n_steps);
  return (int)cudaGetLastError();
}

extern "C" int oige_fk(const float* ftab, const int* itab, int nb, int ncp, int ns,
                       const float* q, const float* qd, float* pos, float* quat,
                       float* avel, float* lvel, int n_env, void* stream) {
  const Tables t{ftab, itab, nb, ncp, ns};
  const int blocks = (n_env + OIGE_THREADS - 1) / OIGE_THREADS;
  fk_kernel<<<blocks, OIGE_THREADS, 0, (cudaStream_t)stream>>>(t, q, qd, pos, quat, avel,
                                                               lvel, n_env);
  return (int)cudaGetLastError();
}
