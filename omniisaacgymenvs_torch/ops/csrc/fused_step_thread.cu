/*
 * The one-thread-per-env form of K1 (and K3, its launch mode), written by
 * hand for Hopper (sm_90a), the port's first design of the step kernel,
 * kept beside the group-per-env form of fused_step.cu for the batches that
 * fill the card.
 * Built with nvcc into a shared library of its own with a plain C
 * interface and bound with ctypes by omniisaacgymenvs_torch/ops/fused_step.py,
 * whose launch_config picks the form.
 *
 * Which TPU kernel each entry replaces
 *   oige_step_thread -> omniisaacgymenvs_tpu/ops/fused_substep.py,
 *                batched_step / _step_kernel(n_steps) (K1): n_steps whole
 *                substeps (forward kinematics, ground contacts on z = 0 or
 *                on per-point terrain planes, pair contacts, PD and passive
 *                drives, the articulated-body algorithm with a 6x6 Cholesky
 *                solve at the floating root, semi-implicit integration with
 *                limits and velocity caps) followed by the report FK
 *                epilogue.
 *   oige_substep_thread -> the same file, batched / kernel (K3): one
 *                substep, no report FK (step_kernel with n_steps = 1).
 *   Scope and inputs as in fused_step.cu: forests of FREE and FIXED roots,
 *   revolute and prismatic joints, the ground plane or per-point terrain
 *   planes, pair contacts, gravity compensation, fixed tendons, force
 *   sensors, and the ten overlay keys read from one packed (n_env, n_dr)
 *   input in a fixed order (absent keys neutral: x * 1 and x + 0 are exact).
 *
 * When this form wins on this card
 *   One thread per env runs every operation of its env one after the
 *   other: a warp instruction does useful work in all 32 lanes, so per env
 *   this form issues several times fewer instructions than the group form.
 *   Its cost is latency: the per-body arrays of one env (some 14 KB, sized
 *   to OIGE_NB_MAX) live in the thread's stack frame in local memory and
 *   go through L1/L2. With the card full (the Humanoid's 32768 envs: 256
 *   blocks of 128, two per SM) the latency is hidden well enough that it
 *   is 1.8x faster than the group form on the H100 (PERF.md); with
 *   few envs (the hands' 8192, AnymalTerrain's 2048) most SMs hold one
 *   block or none and the group form is faster.
 *
 * How it runs
 *   One thread per env with the tail masked; the substep loop runs inside
 *   the thread, so the state never returns to device memory between
 *   substeps, and every input is read once and every output written once
 *   per launch. Model constants sit in one packed device table read with
 *   __ldg: all threads of a warp read the same address, so each read is a
 *   broadcast, and every branch on a joint, root or surface type is taken
 *   by the whole warp alike. Bodies are walked in index order (parent <
 *   child): forward for kinematics and the outward pass, backward for the
 *   inward pass.
 *
 * Precision: built without fast math. sqrtf, divisions, sincosf and tanhf
 * are the precise functions, and the floors are those of the JAX kernel:
 * 1e-12 in the Cholesky, in Shepperd's quaternion and in the friction
 * norm, 1e-6 in the friction divisor, 1e-24 in the quaternion exponential,
 * 1e-18 under the pair distances' square root and 1e-9 in their divisor. A
 * box takes a point for outside on the squared distance (d2 > 1e-14).
 * min, max and clamp propagate NaN like jnp.minimum/maximum, so a state
 * that blows up stays non-finite and the task's finite guard sees it.
 *
 * The device functions also build as host C++ with a prelude that maps
 * __device__, __forceinline__, __ldg and __fmul_rn/__fadd_rn
 * (tests/test_torch_kernel_host.py); the kernel and the launches stand
 * under __CUDACC__.
 */

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

#define OIGE_NB_MAX 32                  // bodies per model
#define OIGE_NCP_MAX 128                // ground contact points
#define OIGE_NS_MAX 8                   // force sensors
#define OIGE_NPAIR_MAX 1024             // point-vs-surface candidate pairs
#define OIGE_NSURF_MAX 32               // receiver surfaces
#define OIGE_NT_MAX 8                   // fixed tendons
#define OIGE_NFREE_MAX 4                // FREE roots
#define OIGE_NQ_MAX (7 * OIGE_NFREE_MAX + OIGE_NB_MAX)
#define OIGE_NV_MAX (6 * OIGE_NFREE_MAX + OIGE_NB_MAX)

// ---- packed model table (must match ops/fused_step.py pack_tables) ----
// float table: [0..2] gravity, [3] substep h, [4] Hunt-Crossley chi,
// [5..7] unused, then one 64-float record per body, one 8-float record per
// contact point, one 4-float gravity-compensation record per body, one
// 4-float gain record per pair, one 16-float record per surface and one
// 8-float record per tendon. int table: 5 ints per body (parent, joint
// type, q address, qd address, joint-dof index), the body of each contact
// point, the body of each sensor, (point, surface) of each pair, (type,
// body) of each surface, the two joint bodies of each tendon.
#define F_BODY 8
#define BODY_STRIDE 64
#define CP_STRIDE 8
#define GC_STRIDE 4
#define PAIR_STRIDE 4
#define SURF_STRIDE 16
#define TEND_STRIDE 8
#define IB_STRIDE 5
enum {
  B_AXIS = 0, B_ET = 3, B_JPOS = 12, B_I6 = 15, B_ARM = 51, B_DAMP = 52,
  B_FRIC = 53, B_KP = 54, B_KD = 55, B_EMAX = 56, B_VMAX = 57, B_LO = 58,
  B_HI = 59, B_DIMPL = 60,
  B_DIMPL0 = 61  // the implicit diagonal without the tendons' share
};
enum { C_POS = 0, C_RAD = 3, C_MU = 4, C_KN = 5, C_KT = 6, C_FNM = 7 };
enum { G_MASS = 0, G_COM = 1 };              // gravity_comp * mass, CoM
enum { P_KN = 0, P_KT = 1, P_FNM = 2 };
// surface params: sphere centre(3) radius; capsule p0(3) p1(3) radius;
// box centre(3) half extents(3) rotation box -> body, row-major (9)
enum { T_C0 = 0, T_C1 = 1, T_REST = 2, T_K = 3, T_C = 4, T_LO = 5, T_HI = 6, T_KLIM = 7 };
enum { IB_PARENT = 0, IB_JTYPE = 1, IB_QADR = 2, IB_VADR = 3, IB_JDOF = 4 };
enum { JT_FREE = 0, JT_REVOLUTE = 1, JT_PRISMATIC = 2, JT_FIXED = 3 };
enum { ST_SPHERE = 0, ST_CAPSULE = 1, ST_BOX = 2 };

namespace {

struct Tables {
  const float* __restrict__ f;
  const int* __restrict__ it;
  int nb, ncp, ns, npair, nsurf, nt, nq, nv, njd;
  // section offsets into the float and the int table
  int f_cp, f_gc, f_pair, f_surf, f_tend;
  int i_cp, i_sens, i_pair, i_surf, i_tend;
};

// offsets of the keys in one env's packed overlay (must match
// ops/fused_step.py OVERLAY_KEYS): damping_scale (njd) at 0, then
// friction_scale (nb), geom_scale (nb), gravity_delta (3),
// limit_lower_delta (njd), limit_upper_delta (njd), mass_scale (nb),
// stiffness_scale (njd), tendon_damping_scale (nt),
// tendon_stiffness_scale (nt); n_dr floats in all. Computed in the kernel:
// as ten more ints of the Tables struct, which the kernels take by value,
// they cost the variants without an overlay 17% of their K1 time on the
// H100 (2.5% when nothing read them), with an unchanged ptxas report.
struct DrOffsets {
  int o_fric, o_geom, o_grav, o_lo, o_hi, o_mass, o_stiff, o_tdamp, o_tstiff, n_dr;
  __device__ __forceinline__ explicit DrOffsets(const Tables& t) {
    o_fric = t.njd;
    o_geom = o_fric + t.nb;
    o_grav = o_geom + t.nb;
    o_lo = o_grav + 3;
    o_hi = o_lo + t.njd;
    o_mass = o_hi + t.njd;
    o_stiff = o_mass + t.nb;
    o_tdamp = o_stiff + t.njd;
    o_tstiff = o_tdamp + t.nt;
    n_dr = o_tstiff + t.nt;
  }
};

__device__ __forceinline__ float tf(const Tables& t, int i) { return __ldg(t.f + i); }
__device__ __forceinline__ int ti(const Tables& t, int i) { return __ldg(t.it + i); }
__device__ __forceinline__ int tb(const Tables& t, int body, int field) {
  return __ldg(t.it + IB_STRIDE * body + field);
}

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

// origin of joint body i in its parent's frame: the joint frame's origin,
// moved along the axis by th for a prismatic joint (r = jpos + Et^T a th)
__device__ __forceinline__ void joint_r(const Tables& t, int B, bool prismatic, float th,
                                        float* r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = tf(t, B + B_JPOS + c);
  if (prismatic) {
    const float s0 = tf(t, B + B_AXIS) * th, s1 = tf(t, B + B_AXIS + 1) * th,
                s2 = tf(t, B + B_AXIS + 2) * th;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r[c] += tf(t, B + B_ET + c) * s0 + tf(t, B + B_ET + 3 + c) * s1 +
              tf(t, B + B_ET + 6 + c) * s2;
  }
}

// forward kinematics of a forest: FREE roots read their pose and velocity
// from q / qd, FIXED roots sit at the table's constant pose, joint bodies
// follow their parent through a revolute or prismatic joint
__device__ __forceinline__ void fk_full(const Tables& t, const float* q,
                                        const float* qd, Frames& k) {
  for (int i = 0; i < t.nb; ++i) {
    const int p = tb(t, i, IB_PARENT);
    const int jt = tb(t, i, IB_JTYPE);
    const int qa = tb(t, i, IB_QADR), va = tb(t, i, IB_VADR);
    const int B = F_BODY + BODY_STRIDE * i;
    if (p < 0) {
      if (jt == JT_FREE) {
        quat_mat(q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6], k.Rw[i]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          k.pw[i][c] = q[qa + c];
          k.w[i][c] = qd[va + c];
          k.l[i][c] = qd[va + 3 + c];
        }
      } else {  // FIXED: Rw = Et^T, at the joint frame's origin, at rest
#pragma unroll
        for (int rr = 0; rr < 3; ++rr)
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) k.Rw[i][3 * rr + cc] = tf(t, B + B_ET + 3 * cc + rr);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          k.pw[i][c] = tf(t, B + B_JPOS + c);
          k.w[i][c] = 0.f;
          k.l[i][c] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) k.cw[i][c] = k.cl[i][c] = 0.f;
      continue;
    }
    const bool prismatic = jt == JT_PRISMATIC;
    float a[3], r[3], Et[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = tf(t, B + B_AXIS + c);
#pragma unroll
    for (int c = 0; c < 9; ++c) Et[c] = tf(t, B + B_ET + c);
    const float th = q[qa], thd = qd[va];
    joint_r(t, B, prismatic, th, r);
    float* E = k.E[i];
    if (prismatic) {
#pragma unroll
      for (int c = 0; c < 9; ++c) E[c] = Et[c];
    } else {
      float s, co;
      sincosf(th, &s, &co);
      const float oc = 1.f - co;
      // Rodrigues rotation about the joint axis; E = R^T Et
      const float R[9] = {
          co + a[0] * a[0] * oc, a[0] * a[1] * oc - a[2] * s, a[0] * a[2] * oc + a[1] * s,
          a[1] * a[0] * oc + a[2] * s, co + a[1] * a[1] * oc, a[1] * a[2] * oc - a[0] * s,
          a[2] * a[0] * oc - a[1] * s, a[2] * a[1] * oc + a[0] * s, co + a[2] * a[2] * oc};
#pragma unroll
      for (int rr = 0; rr < 3; ++rr)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          E[3 * rr + cc] = R[rr] * Et[cc] + R[3 + rr] * Et[3 + cc] + R[6 + rr] * Et[6 + cc];
    }
    // v_i = X_i v_p + S thd, with S = [axis; 0] (revolute) or [0; axis]
    float crs[3], tmp[3];
    cross3(r, k.w[p], crs);
#pragma unroll
    for (int c = 0; c < 3; ++c) tmp[c] = k.l[p][c] - crs[c];
    mv3(E, k.w[p], k.w[i]);
    mv3(E, tmp, k.l[i]);
    float vJ[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) vJ[c] = a[c] * thd;
    if (prismatic) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        k.l[i][c] += vJ[c];
        k.cw[i][c] = 0.f;
      }
      cross3(k.w[i], vJ, k.cl[i]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) k.w[i][c] += vJ[c];
      cross3(k.w[i], vJ, k.cw[i]);
      cross3(k.l[i], vJ, k.cl[i]);
    }
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

// compliant contact along a general unit normal n: Hunt-Crossley normal
// force capped at fnm, plus stiction-capped viscous friction; the force on
// the point's body
__device__ __forceinline__ void contact_force(float pen, const float* n, const float* vrel,
                                              float mu, float kn, float kt, float fnm,
                                              float chi, float* f) {
  const float vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2];
  const float vt[3] = {vrel[0] - vn * n[0], vrel[1] - vn * n[1], vrel[2] - vn * n[2]};
  const float fn = jmin(kn * jmax(pen, 0.f) * jclip(1.f - chi * vn, 0.f, 5.f), fnm);
  const float vt_norm = sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2] + 1e-12f);
  const float sc = jmin(mu * fn, kt * vt_norm) / (vt_norm + 1e-6f);
#pragma unroll
  for (int c = 0; c < 3; ++c) f[c] = fn * n[c] - sc * vt[c];
}

// unit vector and length of d, floored as the pair contacts define them
__device__ __forceinline__ float unit3(const float* d, float* n) {
  const float dist = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-18f);
  const float inv = 1.f / (dist + 1e-9f);
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = d[c] * inv;
  return dist;
}

__device__ __forceinline__ float sign0(float x) {
  return x != x ? x : (float)((x > 0.f) - (x < 0.f));
}

// one substep of one env: (q, qd) -> (q, qd) in place; leaves this
// substep's contact wrenches in w.fx / w.tx. PLANES: the ground contacts
// read this env's terrain planes `pl` (a compile-time variant, like the JAX
// kernel's has_height: a run-time test of the pointer in the contact loop
// cost the flat-ground Humanoid 17% of its K1 time on the H100). DR: `dr`
// is this env's packed randomization overlay (DrOffsets), a compile-time
// variant for the same reason.
template <bool PLANES, bool DR>
__device__ __forceinline__ void substep(const Tables& t, float* q, float* qd,
                                        const float* eff, const float* ptg,
                                        const float* vtg, const float* fapp,
                                        const float* pl, const float* dr, Work& w) {
  const int nb = t.nb;
  const float h = tf(t, 3);
  const float chi = tf(t, 4);
  const DrOffsets o_(t);
  // gravity, per env under gravity_delta, read where it is used
  auto grav = [&](int c) {
    float x = tf(t, c);
    if constexpr (DR) x += __ldg(dr + (o_.o_grav + c));
    return x;
  };
  // the tendons' share of each joint body's implicit diagonal, per env
  // under the tendon scales (without an overlay it is part of B_DIMPL)
  float dtend[DR ? OIGE_NB_MAX : 1];
  if constexpr (DR)
    for (int i = 0; i < nb; ++i) dtend[i] = 0.f;
  Frames& k = w.k;
  fk_full(t, q, qd, k);

  // ---- ground contacts: with PLANES against this env's terrain planes
  // [n, d] (pen = radius - (n.pt - d), force along the general normal; n
  // arrives as a unit vector and is not renormalized), else against z = 0.
  // The planes stay as given for the whole launch. ----
  for (int i = 0; i < nb; ++i)
    for (int c = 0; c < 3; ++c) w.fx[i][c] = w.tx[i][c] = 0.f;
  for (int c_ = 0; c_ < t.ncp; ++c_) {
    const int b = ti(t, t.i_cp + c_);
    const int C = t.f_cp + CP_STRIDE * c_;
    float lp[3], rel[3], crs[3], vpt[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) lp[c] = tf(t, C + C_POS + c);
    // geom_scale and friction_scale of the point's body
    float gs = 1.f;
    if constexpr (DR) {
      gs = __ldg(dr + (o_.o_geom + b));
#pragma unroll
      for (int c = 0; c < 3; ++c) lp[c] *= gs;
    }
    auto rad = [&] {
      float r = tf(t, C + C_RAD);
      if constexpr (DR) r *= gs;
      return r;
    };
    auto mu = [&] {
      float m = tf(t, C + C_MU);
      if constexpr (DR) m *= __ldg(dr + (o_.o_fric + b));
      return m;
    };
    mv3(k.Rw[b], lp, rel);
    cross3(k.wv[b], rel, crs);
#pragma unroll
    for (int c = 0; c < 3; ++c) vpt[c] = k.lv[b][c] + crs[c];
    float f[3];
    if constexpr (PLANES) {
      const float4 P = __ldg(reinterpret_cast<const float4*>(pl) + c_);
      const float pn[3] = {P.x, P.y, P.z};
      const float dist = pn[0] * (k.pw[b][0] + rel[0]) + pn[1] * (k.pw[b][1] + rel[1]) +
                         pn[2] * (k.pw[b][2] + rel[2]) - P.w;
      contact_force(rad() - dist, pn, vpt, mu(), tf(t, C + C_KN), tf(t, C + C_KT),
                    tf(t, C + C_FNM), chi, f);
    } else {
      const float pen = rad() - (k.pw[b][2] + rel[2]);
      const float vn = vpt[2];
      const float fn = jmin(tf(t, C + C_KN) * jmax(pen, 0.f) *
                                jclip(1.f - chi * vn, 0.f, 5.f),
                            tf(t, C + C_FNM));
      const float vt0 = vpt[0], vt1 = vpt[1];
      const float vt_norm = sqrtf(vt0 * vt0 + vt1 * vt1 + 1e-12f);
      const float ft_mag = jmin(mu() * fn, tf(t, C + C_KT) * vt_norm);
      const float sc = ft_mag / (vt_norm + 1e-6f);
      f[0] = -sc * vt0;
      f[1] = -sc * vt1;
      f[2] = fn;
    }
    float n[3];
    cross3(rel, f, n);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w.fx[b][c] += f[c];
      w.tx[b][c] += n[c];
    }
  }

  // ---- pair contacts: a contact point against a surface of another body;
  // equal and opposite forces, torques about each body's origin ----
  for (int pk = 0; pk < t.npair; ++pk) {
    const int pi = ti(t, t.i_pair + 2 * pk), si = ti(t, t.i_pair + 2 * pk + 1);
    const int pb = ti(t, t.i_cp + pi);
    const int st = ti(t, t.i_surf + 2 * si), sb = ti(t, t.i_surf + 2 * si + 1);
    const int C = t.f_cp + CP_STRIDE * pi;
    const int S = t.f_surf + SURF_STRIDE * si;
    const int G = t.f_pair + PAIR_STRIDE * pk;
    const float* Rs = k.Rw[sb];
    float lp[3], relp[3], rels[3], n[3], tmp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) lp[c] = tf(t, C + C_POS + c);
    // geom_scale: the point by its body, the surface's lengths by the
    // surface's body (a box's rotation is not scaled); friction_scale by
    // the point's body
    float gp = 1.f, sgs = 1.f;
    if constexpr (DR) {
      gp = __ldg(dr + (o_.o_geom + pb));
#pragma unroll
      for (int c = 0; c < 3; ++c) lp[c] *= gp;
      sgs = __ldg(dr + (o_.o_geom + sb));
    }
    mv3(k.Rw[pb], lp, relp);
    // the point relative to the surface body's origin
#pragma unroll
    for (int c = 0; c < 3; ++c) rels[c] = (k.pw[pb][c] + relp[c]) - k.pw[sb][c];
    float rad = tf(t, C + C_RAD);
    if constexpr (DR) rad *= gp;
    float pen;
    float at[3] = {rels[0], rels[1], rels[2]};  // where the surface's velocity is taken
    if (st == ST_BOX) {
      float cl[3], hf[3], Rq[9], dl[3], pl[3], d_out[3], nl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cl[c] = tf(t, S + c);
        hf[c] = tf(t, S + 3 + c);
        if constexpr (DR) {
          cl[c] *= sgs;
          hf[c] *= sgs;
        }
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) Rq[c] = tf(t, S + 6 + c);
      mv3(Rs, cl, tmp);
#pragma unroll
      for (int c = 0; c < 3; ++c) dl[c] = rels[c] - tmp[c];
      mtv3(Rs, dl, tmp);
      mtv3(Rq, tmp, pl);  // the point in the box's frame
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d_out[c] = pl[c] - jclip(pl[c], -hf[c], hf[c]);
        d2 += d_out[c] * d_out[c];
      }
      const float dist_out = sqrtf(d2 + 1e-18f);
      const bool outside = d2 > 1e-14f;
      // inside: out through the nearest face
      const float f0 = hf[0] - fabsf(pl[0]), f1 = hf[1] - fabsf(pl[1]),
                  f2 = hf[2] - fabsf(pl[2]);
      const bool is0 = f0 <= jmin(f1, f2);
      const bool is1 = !is0 && f1 <= f2;
      const float min_d = jmin(f0, jmin(f1, f2));
      if (outside) {
        const float inv = 1.f / (dist_out + 1e-9f);
#pragma unroll
        for (int c = 0; c < 3; ++c) nl[c] = d_out[c] * inv;
        pen = rad - dist_out;
      } else {
        nl[0] = is0 ? sign0(pl[0]) : 0.f;
        nl[1] = is1 ? sign0(pl[1]) : 0.f;
        nl[2] = (is0 || is1) ? 0.f : sign0(pl[2]);
        pen = rad + min_d;
      }
      mv3(Rq, nl, tmp);
      mv3(Rs, tmp, n);
    } else if (st == ST_CAPSULE) {
      float e0[3], e1[3], p0[3], seg[3], d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e0[c] = tf(t, S + c);
        e1[c] = tf(t, S + 3 + c);
        if constexpr (DR) {
          e0[c] *= sgs;
          e1[c] *= sgs;
        }
      }
      mv3(Rs, e0, p0);
      mv3(Rs, e1, tmp);
      float num = 0.f, den = 1e-9f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        seg[c] = tmp[c] - p0[c];
        num += (rels[c] - p0[c]) * seg[c];
        den += seg[c] * seg[c];
      }
      const float tt = jclip(num / den, 0.f, 1.f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        at[c] = p0[c] + tt * seg[c];  // nearest point of the axis
        d[c] = rels[c] - at[c];
      }
      float srad = tf(t, S + 6);
      if constexpr (DR) srad *= sgs;
      pen = srad + rad - unit3(d, n);
    } else {  // sphere
      float cs[3], d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c] = tf(t, S + c);
      float srad = tf(t, S + 3);
      if constexpr (DR) {
#pragma unroll
        for (int c = 0; c < 3; ++c) cs[c] *= sgs;
        srad *= sgs;
      }
      mv3(Rs, cs, tmp);
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = rels[c] - tmp[c];
      pen = srad + rad - unit3(d, n);
    }
    float c1[3], c2[3], vrel[3], f[3];
    cross3(k.wv[pb], relp, c1);
    cross3(k.wv[sb], at, c2);
#pragma unroll
    for (int c = 0; c < 3; ++c) vrel[c] = (k.lv[pb][c] + c1[c]) - (k.lv[sb][c] + c2[c]);
    float mu = tf(t, C + C_MU);
    if constexpr (DR) mu *= __ldg(dr + (o_.o_fric + pb));
    contact_force(pen, n, vrel, mu, tf(t, G + P_KN), tf(t, G + P_KT),
                  tf(t, G + P_FNM), chi, f);
    cross3(relp, f, c1);
    cross3(rels, f, c2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w.fx[pb][c] += f[c];
      w.tx[pb][c] += c1[c];
      w.fx[sb][c] -= f[c];
      w.tx[sb][c] -= c2[c];
    }
  }

  // ---- drives: clamped Stable-PD + effort + passive damping/friction ----
  for (int i = 0; i < nb; ++i) {
    if (tb(t, i, IB_PARENT) < 0) continue;
    const int B = F_BODY + BODY_STRIDE * i;
    const int d = tb(t, i, IB_JDOF);
    const float qj = q[tb(t, i, IB_QADR)], qjd = qd[tb(t, i, IB_VADR)];
    const float emax = tf(t, B + B_EMAX);
    // stiffness_scale and damping_scale reach the drive's gains only: the
    // implicit diagonal stays unscaled
    auto kp = [&] {
      float x = tf(t, B + B_KP);
      if constexpr (DR) x *= __ldg(dr + (o_.o_stiff + d));
      return x;
    };
    auto kd = [&] {
      float x = tf(t, B + B_KD);
      if constexpr (DR) x *= __ldg(dr + (d));
      return x;
    };
    const float drive = jclip(kp() * (ptg[d] - qj - h * qjd) + kd() * (vtg[d] - qjd),
                              -emax, emax);
    const float passive = -tf(t, B + B_DAMP) * qjd - tf(t, B + B_FRIC) * tanhf(qjd * 10.f);
    w.tau[i] = drive + eff[d] + passive;
  }

  // ---- fixed tendons: Stable-PD coupling force on two joints (their
  // implicit diagonal is part of the table's B_DIMPL; under the tendon
  // scales it is summed here per env: stiffness and limit stiffness times
  // the first, damping times the second) ----
  for (int tn = 0; tn < t.nt; ++tn) {
    const int b0 = ti(t, t.i_tend + 2 * tn), b1 = ti(t, t.i_tend + 2 * tn + 1);
    const int T = t.f_tend + TEND_STRIDE * tn;
    const float c0 = tf(t, T + T_C0), c1 = tf(t, T + T_C1);
    const float q0 = q[tb(t, b0, IB_QADR)], q1 = q[tb(t, b1, IB_QADR)];
    const float qd0 = qd[tb(t, b0, IB_VADR)], qd1 = qd[tb(t, b1, IB_VADR)];
    const float L = c0 * (q0 + h * qd0) + c1 * (q1 + h * qd1);
    const float Ldot = c0 * qd0 + c1 * qd1;
    const float excess = L - jclip(L, tf(t, T + T_LO), tf(t, T + T_HI));
    float klim = tf(t, T + T_KLIM), tk = tf(t, T + T_K);
    const float rest = tf(t, T + T_REST);
    float tc = tf(t, T + T_C);
    if constexpr (DR) {
      const float ts = __ldg(dr + (o_.o_tstiff + tn));
      tk *= ts;
      klim *= ts;
      tc *= __ldg(dr + (o_.o_tdamp + tn));
      const float per_t = h * (tc + h * (tk + klim));
      dtend[b0] += per_t * c0 * c0;
      dtend[b1] += per_t * c1 * c1;
    }
    const float F = klim * excess + tk * (L - rest) + tc * Ldot;
    w.tau[b0] -= c0 * F;
    w.tau[b1] -= c1 * F;
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
    float ms = 1.f;
    if constexpr (DR) {
      // mass_scale: the body's spatial inertia here, its bias force below,
      // after the cross products (it is linear in I v)
      ms = __ldg(dr + (o_.o_mass + i));
#pragma unroll
      for (int c = 0; c < 36; ++c) IA[c] *= ms;
    }
    float tw[3], fw[3], tbd[3], fb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tw[c] = w.tx[i][c] + fapp[6 * i + c];
      fw[c] = w.fx[i][c] + fapp[6 * i + 3 + c];
    }
    // gravity compensation: counter-gravity at the body's CoM; it enters
    // the dynamics, not the sensors' contact wrench
    const int G = t.f_gc + GC_STRIDE * i;
    const float gcm = tf(t, G + G_MASS);
    if (gcm != 0.f) {
      const float com[3] = {tf(t, G + G_COM), tf(t, G + G_COM + 1), tf(t, G + G_COM + 2)};
      float fg[3] = {-gcm * grav(0), -gcm * grav(1), -gcm * grav(2)};
      if constexpr (DR) {
#pragma unroll
        for (int c = 0; c < 3; ++c) fg[c] *= ms;
      }
      float cr[3], ng[3];
      mv3(k.Rw[i], com, cr);
      cross3(cr, fg, ng);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tw[c] += ng[c];
        fw[c] += fg[c];
      }
    }
    mtv3(k.Rw[i], tw, tbd);
    mtv3(k.Rw[i], fw, fb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (DR) {
        w.pA[i][c] = (n1[c] + n2[c]) * ms - tbd[c];
        w.pA[i][3 + c] = f6[c] * ms - fb[c];
      } else {
        w.pA[i][c] = n1[c] + n2[c] - tbd[c];
        w.pA[i][3 + c] = f6[c] - fb[c];
      }
    }
  }

  // ---- ABA inward pass, deepest body first ----
  for (int i = nb - 1; i >= 0; --i) {
    const int p = tb(t, i, IB_PARENT);
    if (p < 0) continue;
    const int B = F_BODY + BODY_STRIDE * i;
    const bool prismatic = tb(t, i, IB_JTYPE) == JT_PRISMATIC;
    const int o = prismatic ? 3 : 0;  // S = [axis; 0] or [0; axis]
    const float a[3] = {tf(t, B + B_AXIS), tf(t, B + B_AXIS + 1), tf(t, B + B_AXIS + 2)};
    const float* IA = w.IA[i];
    float* U = w.U[i];
#pragma unroll
    for (int r = 0; r < 6; ++r)
      U[r] = IA[6 * r + o] * a[0] + IA[6 * r + o + 1] * a[1] + IA[6 * r + o + 2] * a[2];
    auto dimpl = [&] {
      if constexpr (DR)
        return tf(t, B + B_DIMPL0) + dtend[i];
      else
        return tf(t, B + B_DIMPL);
    };
    const float D = a[0] * U[o] + a[1] * U[o + 1] + a[2] * U[o + 2] + tf(t, B + B_ARM) +
                    dimpl();
    const float uu = w.tau[i] - (a[0] * w.pA[i][o] + a[1] * w.pA[i][o + 1] +
                                 a[2] * w.pA[i][o + 2]);
    w.D[i] = D;
    w.uu[i] = uu;
    // a FIXED root solves nothing, so its articulated inertia is not needed
    if (tb(t, p, IB_PARENT) < 0 && tb(t, p, IB_JTYPE) == JT_FIXED) continue;
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
    float rj[3];
    joint_r(t, B, prismatic, q[tb(t, i, IB_QADR)], rj);
    const float r0 = rj[0], r1 = rj[1], r2 = rj[2];
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

  // ---- roots: a0 = X_root [0; -g]; a FREE root solves
  // IA qdd = -(pA + IA a0), a FIXED root only hands gravity on ----
  for (int i = 0; i < nb; ++i) {
    if (tb(t, i, IB_PARENT) >= 0) continue;
    const float mg[3] = {-grav(0), -grav(1), -grav(2)};
    float al[3];
    mtv3(k.Rw[i], mg, al);
    const float a0[6] = {0.f, 0.f, 0.f, al[0], al[1], al[2]};
    if (tb(t, i, IB_JTYPE) == JT_FREE) {
      const int va = tb(t, i, IB_VADR);
      float rhs[6], x[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) s += w.IA[i][6 * r + c] * a0[c];
        rhs[r] = -(w.pA[i][r] + s);
      }
      chol_solve6(w.IA[i], rhs, x);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        w.qdd[va + c] = x[c];
        w.acc[i][c] = a0[c] + x[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 6; ++c) w.acc[i][c] = a0[c];
    }
  }

  // ---- ABA outward pass ----
  for (int i = 0; i < nb; ++i) {
    const int p = tb(t, i, IB_PARENT);
    if (p < 0) continue;
    const int B = F_BODY + BODY_STRIDE * i;
    const bool prismatic = tb(t, i, IB_JTYPE) == JT_PRISMATIC;
    const int o = prismatic ? 3 : 0;
    const float a[3] = {tf(t, B + B_AXIS), tf(t, B + B_AXIS + 1), tf(t, B + B_AXIS + 2)};
    float r[3];
    joint_r(t, B, prismatic, q[tb(t, i, IB_QADR)], r);
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
    w.qdd[tb(t, i, IB_VADR)] = qdd_i;
#pragma unroll
    for (int c = 0; c < 6; ++c) w.acc[i][c] = a_p[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) w.acc[i][o + c] += a[c] * qdd_i;
  }

  // ---- semi-implicit Euler: caps, joint velocity clamp, limits ----
  const int nq = t.nq, nv = t.nv;
  // the velocity and joint-position updates round the product and the sum
  // separately (no fused multiply-add), as the plain version does: a joint
  // that lands on its limit then takes the same branch in both
  for (int c = 0; c < nv; ++c) w.qdn[c] = __fadd_rn(qd[c], __fmul_rn(h, w.qdd[c]));
  for (int c = 0; c < nq; ++c) w.qn[c] = q[c];
  for (int i = 0; i < nb; ++i) {
    const int qa = tb(t, i, IB_QADR), va = tb(t, i, IB_VADR);
    if (tb(t, i, IB_PARENT) >= 0) {
      const int B = F_BODY + BODY_STRIDE * i;
      const float vmax = tf(t, B + B_VMAX);
      // limit + delta, rounded once before the comparison, as the plain
      // version's tensor sum is
      auto limit = [&](int field, int off) {
        float x = tf(t, B + field);
        if constexpr (DR) x = __fadd_rn(x, __ldg(dr + (off + tb(t, i, IB_JDOF))));
        return x;
      };
      const float lo = limit(B_LO, o_.o_lo), hi = limit(B_HI, o_.o_hi);
      float qjd = jclip(w.qdn[va], -vmax, vmax);
      float qj = __fadd_rn(q[qa], __fmul_rn(h, qjd));
      const bool hit_lb = qj < lo;
      const bool hit_ub = qj > hi;
      qj = jclip(qj, lo, hi);
      if (hit_ub) qjd = jmin(qjd, 0.f);
      if (hit_lb) qjd = jmax(qjd, 0.f);
      w.qn[qa] = qj;
      w.qdn[va] = qjd;
    } else if (tb(t, i, IB_JTYPE) == JT_FREE) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w.qdn[va + c] = jclip(w.qdn[va + c], -64.f, 64.f);
        w.qdn[va + 3 + c] = jclip(w.qdn[va + 3 + c], -1000.f, 1000.f);
      }
      float dp[3];
      mv3(k.Rw[i], &w.qdn[va + 3], dp);
#pragma unroll
      for (int c = 0; c < 3; ++c) w.qn[qa + c] = q[qa + c] + h * dp[c];
      // q' = q * exp(omega h / 2)
      const float hx = w.qdn[va] * (h / 2.f), hy = w.qdn[va + 1] * (h / 2.f),
                  hz = w.qdn[va + 2] * (h / 2.f);
      const float ang = sqrtf(hx * hx + hy * hy + hz * hz + 1e-24f);
      const float sa = sinf(ang) / ang;
      const float ew = cosf(ang), ex = sa * hx, ey = sa * hy, ez = sa * hz;
      const float qw = q[qa + 3], qx = q[qa + 4], qy = q[qa + 5], qz = q[qa + 6];
      const float nw = qw * ew - qx * ex - qy * ey - qz * ez;
      const float nx = qw * ex + qx * ew + qy * ez - qz * ey;
      const float ny = qw * ey - qx * ez + qy * ew + qz * ex;
      const float nz = qw * ez + qx * ey - qy * ex + qz * ew;
      const float norm = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz + 1e-12f);
      w.qn[qa + 3] = nw / norm;
      w.qn[qa + 4] = nx / norm;
      w.qn[qa + 5] = ny / norm;
      w.qn[qa + 6] = nz / norm;
    }
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

// n_steps substeps of one env, then the report FK unless `pos` is null
// (the single-substep launch mode writes no report); with PLANES, `planes`
// is (n_env, ncp, 4); with DR, `dr` is (n_env, n_dr): every substep reads
// the env's overlay from device memory through the read-only path (a copy
// in the thread's stack, 1,104 B more of it, measured 13% slower on the
// H100 at the hand's 12 substeps)
template <bool PLANES, bool DR>
__device__ __forceinline__ void step_env(const Tables t, long e, const float* q_in,
                                         const float* qd_in, const float* eff,
                                         const float* ptg, const float* vtg,
                                         const float* fapp, const float* planes,
                                         const float* dr, float* q_out,
                                         float* qd_out, float* sf_out, float* pos,
                                         float* quat, float* avel, float* lvel,
                                         int n_steps) {
  const int nb = t.nb, nq = t.nq, nv = t.nv, njd = t.njd;
  float q[OIGE_NQ_MAX], qd[OIGE_NV_MAX];
  Work w;
  for (int c = 0; c < nq; ++c) q[c] = q_in[e * nq + c];
  for (int c = 0; c < nv; ++c) qd[c] = qd_in[e * nv + c];
  const float* eff_e = eff + e * njd;
  const float* ptg_e = ptg + e * njd;
  const float* vtg_e = vtg + e * njd;
  const float* fapp_e = fapp + e * 6 * nb;
  const float* pl_e = PLANES ? planes + e * 4 * t.ncp : nullptr;
  const float* dr_e = DR ? dr + e * DrOffsets(t).n_dr : nullptr;
  for (int s = 0; s < n_steps; ++s)
    substep<PLANES, DR>(t, q, qd, eff_e, ptg_e, vtg_e, fapp_e, pl_e, dr_e, w);
  for (int c = 0; c < nq; ++c) q_out[e * nq + c] = q[c];
  for (int c = 0; c < nv; ++c) qd_out[e * nv + c] = qd[c];
  // sensors read the last substep's contact wrench [force, torque]: ground
  // and pair contacts, without applied forces and gravity compensation
  for (int s = 0; s < t.ns; ++s) {
    const int b = ti(t, t.i_sens + s);
    const long o = (e * t.ns + s) * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sf_out[o + c] = w.fx[b][c];
      sf_out[o + 3 + c] = w.tx[b][c];
    }
  }
  if (pos == nullptr) return;
  fk_full(t, q, qd, w.k);
  write_report(t, w.k, e, pos, quat, avel, lvel);
}

#ifdef __CUDACC__
template <bool PLANES, bool DR>
__global__ void __launch_bounds__(128) step_kernel(
    const Tables t, const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ eff, const float* __restrict__ ptg,
    const float* __restrict__ vtg, const float* __restrict__ fapp,
    const float* __restrict__ planes, const float* __restrict__ dr,
    float* __restrict__ q_out,
    float* __restrict__ qd_out, float* __restrict__ sf_out,
    float* __restrict__ pos, float* __restrict__ quat, float* __restrict__ avel,
    float* __restrict__ lvel, int n_env, int n_steps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_env) return;
  step_env<PLANES, DR>(t, e, q_in, qd_in, eff, ptg, vtg, fapp, planes, dr, q_out, qd_out,
                       sf_out, pos, quat, avel, lvel, n_steps);
}
#endif  // __CUDACC__

}  // namespace

// ---- C entry points: launch on the caller's stream, return cudaError_t ----
#define OIGE_THREADS 128

// dims: nb, ncp, ns, npair, nsurf, nt, nq, nv, njd (host memory)
static Tables make_tables(const float* ftab, const int* itab, const int* dims) {
  Tables t;
  t.f = ftab;
  t.it = itab;
  t.nb = dims[0];
  t.ncp = dims[1];
  t.ns = dims[2];
  t.npair = dims[3];
  t.nsurf = dims[4];
  t.nt = dims[5];
  t.nq = dims[6];
  t.nv = dims[7];
  t.njd = dims[8];
  t.f_cp = F_BODY + BODY_STRIDE * t.nb;
  t.f_gc = t.f_cp + CP_STRIDE * t.ncp;
  t.f_pair = t.f_gc + GC_STRIDE * t.nb;
  t.f_surf = t.f_pair + PAIR_STRIDE * t.npair;
  t.f_tend = t.f_surf + SURF_STRIDE * t.nsurf;
  t.i_cp = IB_STRIDE * t.nb;
  t.i_sens = t.i_cp + t.ncp;
  t.i_pair = t.i_sens + t.ns;
  t.i_surf = t.i_pair + 2 * t.npair;
  t.i_tend = t.i_surf + 2 * t.nsurf;
  return t;
}

// this form's compile-time maxima, the sizes of its stack arrays
// (ops/fused_step.py THREAD_LIMITS, thread_scope_errors): bodies, ground
// contact points, sensors, pairs, surfaces, tendons, FREE roots
extern "C" int oige_limits(int* out) {
  out[0] = OIGE_NB_MAX;
  out[1] = OIGE_NCP_MAX;
  out[2] = OIGE_NS_MAX;
  out[3] = OIGE_NPAIR_MAX;
  out[4] = OIGE_NSURF_MAX;
  out[5] = OIGE_NT_MAX;
  out[6] = OIGE_NFREE_MAX;
  return 0;
}

#ifdef __CUDACC__
template <bool PLANES, bool DR>
static void launch_step(const Tables& t, const float* q, const float* qd, const float* eff,
                        const float* ptg, const float* vtg, const float* fapp,
                        const float* planes, const float* dr, float* q_out, float* qd_out,
                        float* sf_out, float* pos, float* quat, float* avel, float* lvel,
                        int n_env, int n_steps, void* stream) {
  const int blocks = (n_env + OIGE_THREADS - 1) / OIGE_THREADS;
  step_kernel<PLANES, DR><<<blocks, OIGE_THREADS, 0, (cudaStream_t)stream>>>(
      t, q, qd, eff, ptg, vtg, fapp, planes, dr, q_out, qd_out, sf_out, pos, quat, avel,
      lvel, n_env, n_steps);
}

// planes: (n_env, ncp, 4) contiguous terrain planes, or null for flat
// ground; dr: (n_env, n_dr) contiguous packed overlays, or null for none.
// Which of the two are given picks one of the kernel's four variants.
extern "C" int oige_step_thread(const float* ftab, const int* itab, const int* dims,
                                const float* q, const float* qd, const float* eff,
                                const float* ptg, const float* vtg, const float* fapp,
                                const float* planes, const float* dr, float* q_out,
                                float* qd_out, float* sf_out, float* pos,
                                float* quat, float* avel, float* lvel, int n_env, int n_steps,
                                void* stream) {
  const Tables t = make_tables(ftab, itab, dims);
#define OIGE_STEP_ARGS                                                                  \
  t, q, qd, eff, ptg, vtg, fapp, planes, dr, q_out, qd_out, sf_out, pos, quat, avel, lvel, \
      n_env, n_steps, stream
  if (planes != nullptr && dr != nullptr)
    launch_step<true, true>(OIGE_STEP_ARGS);
  else if (planes != nullptr)
    launch_step<true, false>(OIGE_STEP_ARGS);
  else if (dr != nullptr)
    launch_step<false, true>(OIGE_STEP_ARGS);
  else
    launch_step<false, false>(OIGE_STEP_ARGS);
#undef OIGE_STEP_ARGS
  return (int)cudaGetLastError();
}

// K3: one substep, no report FK
extern "C" int oige_substep_thread(const float* ftab, const int* itab, const int* dims,
                                   const float* q, const float* qd, const float* eff,
                                   const float* ptg, const float* vtg, const float* fapp,
                                   const float* planes, const float* dr, float* q_out,
                                   float* qd_out, float* sf_out, int n_env, void* stream) {
  return oige_step_thread(ftab, itab, dims, q, qd, eff, ptg, vtg, fapp, planes, dr, q_out,
                          qd_out, sf_out, nullptr, nullptr, nullptr, nullptr, n_env, 1, stream);
}

#endif  // __CUDACC__
