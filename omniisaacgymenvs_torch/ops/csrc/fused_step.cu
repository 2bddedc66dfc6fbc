/*
 * Physics step kernels of the PyTorch port, written by hand for Hopper
 * (sm_90a). Built with nvcc into a shared library with a plain C interface
 * and bound with ctypes by omniisaacgymenvs_torch/ops/fused_step.py.
 *
 * Which TPU kernel each entry replaces
 *   oige_step -> omniisaacgymenvs_tpu/ops/fused_substep.py, batched_step /
 *                _step_kernel(n_steps) (K1): n_steps whole substeps (forward
 *                kinematics, ground contacts on z = 0 or on per-point terrain
 *                planes, pair contacts, PD and passive drives, the
 *                articulated-body algorithm with a 6x6 Cholesky solve at the
 *                floating root, semi-implicit integration with limits and
 *                velocity caps) followed by the report FK epilogue.
 *   oige_fk   -> the same file, batched_fk / fk_kernel (K2): report FK only,
 *                (q, qd) -> world pos, quat, angular and linear velocity of
 *                every body.
 *   oige_substep -> the same file, batched / kernel (K3): one substep,
 *                (q, qd, controls) -> (q', qd', sensor wrenches), no report
 *                FK. It launches step_kernel with n_steps = 1 and the report
 *                switched off, so there is one substep body for K1 and K3.
 *   Scope: forests of FREE and FIXED roots, revolute and prismatic joints,
 *   the flat ground plane z = 0 or one terrain contact plane per contact
 *   point and env (the `planes` input, has_height in the JAX kernel), both
 *   with per-point gains, point-vs-surface pair contacts (sphere, capsule,
 *   box), gravity compensation, fixed tendons, force sensors, and the ten
 *   per-env domain-randomization overlay keys (the `dr` input, dr_keys in
 *   the JAX kernel), read from one packed (n_env, n_dr) input in a fixed
 *   order, absent keys filled with their neutral value by the wrapper
 *   (x * 1 and x + 0 are exact). Any number of bodies, contact points,
 *   sensors, pairs, surfaces, tendons and FREE roots: every size is read
 *   from the schedule's header at run time.
 *
 * What bounds it on this card
 *   Per env, K1 moves about 2.4 KB (250 input and 353 output floats for the
 *   Humanoid) and does of order 10^5 FP32 operations over 4 substeps, so by
 *   the roofline it is bound by FP32 issue (ops/fused_step.py op_count);
 *   AnymalTerrain's one substep on planes and K2 are bound by bytes. The
 *   first design ran one thread per env with its per-body arrays in a
 *   14 KB local-memory stack frame: at 32768 envs some 467 MB of stack went
 *   through the 50 MB L2 every substep, and at the hands' 8192 and
 *   AnymalTerrain's 2048 envs half or more of the 132 SMs had no block.
 *
 * What the design does about it
 *   A group of G lanes (a compile-time parameter, G = 32 on the card: one
 *   warp; the host-C++ test builds G = 1) works on one env at a time. The env's working set lives in
 *   dynamic shared memory, sized to the model by the wrapper (the layout's
 *   offsets sit in the schedule table), and the model tables are staged
 *   into shared memory once per block. The grid is persistent: each group
 *   walks over envs with the stride of all groups, so every SM holds work
 *   at any env count. The work of an env is written as phases; a phase is
 *   a strided list of items (`for (j = lane; j < n; j += G)`) read from and
 *   written to shared memory, and __syncwarp over the group's lanes
 *   separates phases. Items: per body, per level of the tree (FK outward
 *   and the ABA inward pass, deepest level first, with the 36 entries of
 *   X^T Ia X and the 36 of Ia X as items), per contact point,
 *   per pair, per dof. A FREE root's 6x6 Cholesky runs on one lane. Inputs
 *   and outputs are copied between device memory and shared memory by
 *   consecutive lanes over an env's contiguous rows, so the accesses are
 *   coalesced. Sums are deterministic: no atomics; a body's contact
 *   wrench, a parent's articulated inertia and bias force and a sensor's
 *   wrench are summed by one lane in a fixed order of points, pairs and
 *   children from per-item staging, so results do not depend on G and two
 *   launches on the same inputs are bitwise equal. No tensor cores, on
 *   purpose: the physics runs in full float32 (bf16 made qd errors 100x
 *   worse, TF32 stays off), and the 6x6 products of one env are far below
 *   wgmma's 64-row tiles. The kernels take the schedule's header (sizes,
 *   section and layout offsets) by value and read it with constant
 *   indices; its sections (levels, slots, children, contact lists) are
 *   staged in shared memory with the model's int table.
 *   A model whose one env and tables do not fit a block's shared memory
 *   (several hundred bodies) takes the device-memory placement, a
 *   compile-time flag (GMEM) of both kernels: each group's working set is
 *   a slot of a scratch buffer in device memory, and the tables stay
 *   staged in shared memory where they fit, else are read from a device
 *   copy in the staged layout. The phases and their arithmetic are the
 *   same; launch_config picks the placement, never for a model that fits.
 *
 * Where it loses
 *   Per env the group issues several times the instructions of one thread
 *   per env (a phase with few items leaves most lanes idle), so once a
 *   batch fills the card (the Humanoid's 32768 envs) the one-thread-per-env
 *   form of fused_step_thread.cu is faster on the H100; launch_config in
 *   ops/fused_step.py picks the form by the envs per SM, and this form at
 *   every width for a model past the thread form's compile-time maxima.
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
 * __device__, __forceinline__, __syncwarp, __ldg and __fmul_rn/__fadd_rn
 * (tests/test_torch_kernel_host.py, G = 1: lane 0, stride 1); the kernels
 * and the C entry points stand under __CUDACC__.
 */

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

// No size of the model is fixed at compile time: every size and offset
// comes from the schedule's header at run time (the one-thread-per-env form
// of fused_step_thread.cu keeps compile-time maxima for its stack arrays).
#define OIGE_MAX_THREADS 512            // envs per block x lanes per env
#define OIGE_G 32                       // lanes per env on the card

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
// In shared memory every record takes one float more than in the packed
// table: an odd stride, so that the lanes of a phase that read one field
// of different bodies, points or pairs hit different banks (at 64 floats a
// body, 22 bodies read the same bank one after the other).
#define S_BODY (BODY_STRIDE + 1)
#define S_CP (CP_STRIDE + 1)
#define S_GC (GC_STRIDE + 1)
#define S_PAIR (PAIR_STRIDE + 1)
#define S_SURF (SURF_STRIDE + 1)
#define S_TEND (TEND_STRIDE + 1)
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

// ---- schedule table (must match ops/fused_step.py SCHEDULE_HEADER) ----
// The kernels take the schedule's header by value and stage the int table
// [schedule sections | model int table]; the header's section offsets
// count from the start of that table. The schedule's header holds the model's sizes, the sections of the packed
// float table (H_P*) and of its copy in shared memory (H_F*), those of the
// model int table,
// the tree's levels and the offsets of one env's working set (floats from
// the env's base; L_STAGE aliases L_IA). Its sections: level starts
// (nlev + 1) and the bodies by level (nb); each body's slot within its
// level, plus SLOT_UNDER_FIXED where its parent is a FIXED root; children per body (nb + 1 starts, then children by descending
// index); contact contributions per body (nb + 1 starts, then codes: a
// ground point c as c, pair k as ncp + 2k on the point's body and
// ncp + 2k + 1 on the surface's body).
enum {
  H_NB, H_NCP, H_NS, H_NPAIR, H_NSURF, H_NT, H_NQ, H_NV, H_NJD,
  H_PCP, H_PGC, H_PPAIR, H_PSURF, H_PTEND, H_PEND,
  H_FCP, H_FGC, H_FPAIR, H_FSURF, H_FTEND, H_FEND,
  H_ICP, H_ISENS, H_IPAIR, H_ISURF, H_ITEND,
  H_IMODEL, H_NLEV, H_LEV, H_LBODY, H_SLOT, H_CH, H_CHL, H_CC, H_CCL,
  L_Q, L_QD, L_RW, L_PW, L_E, L_RJ, L_W, L_L, L_CW, L_CL, L_WV, L_LV, L_QUAT,
  L_QDD, L_EFF, L_PTG, L_VTG, L_FAPP, L_FX, L_TX, L_TAU, L_DT,
  L_IA, L_PA, L_U, L_D, L_UU, L_IDV, L_ACC, L_TMP, L_PLANES,
  H_LEN
};
#define L_STAGE L_IA
// per-slot scratch of the inward pass: Q = E rtil (9), pa (6), T = Ia X
// (36); an odd stride
enum { TM_Q = 0, TM_PA = 9, TM_T = 15, TM_STRIDE = 51 };

namespace {

// one env's view of the staged tables and its working set
struct Ctx {
  const float* F;  // model float table
  const int* S;    // schedule table, header first
  const int* I;    // model int table
  float* s;        // this env's working set
  int lane;        // lane within the group
  unsigned mask;   // the group's lanes within the warp
  // the schedule's header, handed to the kernel by value: read with
  // constant indices only, so it stays in the constant bank and registers
  // (a read from shared memory would be repeated after every __syncwarp)
  int h[H_LEN];
};

// phases are separated by a barrier over the group's lanes (one over the
// whole block measured no faster on the H100)
template <int G>
__device__ __forceinline__ void gsync(const Ctx& c) {
  __syncwarp(c.mask);
}

// the items of a phase whose values depend on nothing the phase writes,
// two per lane and round: both are computed before either is stored, so
// their shared-memory reads overlap. item(j, dst) returns item j's value
// and sets dst to where it goes (null: nothing to store).
template <int G, class Item>
__device__ __forceinline__ void two_per_round(const Ctx& c, int n, Item item) {
  for (int j = c.lane; j < n; j += 2 * G) {
    float* d0 = nullptr;
    float* d1 = nullptr;
    const float v0 = item(j, d0);
    const float v1 = j + G < n ? item(j + G, d1) : 0.f;
    if (d0 != nullptr) *d0 = v0;
    if (d1 != nullptr) *d1 = v1;
  }
}

// Built with -DOIGE_PROFILE (scripts/profile_kernel.py), lane 0 of each
// group adds the clock cycles since its previous mark to the phase's
// counter; otherwise a mark is nothing.
enum {
  PF_LOAD, PF_FK_LOCAL, PF_FK_CHAIN, PF_FK_WORLD, PF_CONTACT, PF_SUM_DRIVE, PF_BIAS,
  PF_ACC, PF_HEAD, PF_T, PF_ROOT, PF_OUTWARD, PF_INTEGRATE, PF_STORE, PF_REPORT,
  PF_N
};
#if defined(OIGE_PROFILE) && defined(__CUDACC__)
// counters spread over PF_SLOTS copies (by block and group), so that the
// groups' atomics seldom meet at one address
#define PF_SLOTS 1024
__device__ unsigned long long g_prof[PF_SLOTS * 2 * PF_N];
struct Prof {
  long long t = 0;
  bool on = true;
  __device__ __forceinline__ void start() {
#ifdef __CUDA_ARCH__
    t = clock64();
#endif
  }
  __device__ __forceinline__ void mark(const Ctx& c, int k) {
#ifdef __CUDA_ARCH__
    if (on && c.lane == 0) {
      const long long now = clock64();
      unsigned long long* slot =
          g_prof + ((blockIdx.x * 64 + threadIdx.x / 8) % PF_SLOTS) * 2 * PF_N;
      atomicAdd(slot + 2 * k, (unsigned long long)(now - t));
      atomicAdd(slot + 2 * k + 1, 1ull);
      t = now;
    }
#endif
  }
};
#else
struct Prof {
  bool on = true;
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(const Ctx&, int) {}
};
#endif

__device__ __forceinline__ float* at(const Ctx& c, int field) { return c.s + c.h[field]; }
__device__ __forceinline__ int bi(const Ctx& c, int body, int field) {
  return c.I[IB_STRIDE * body + field];
}
__device__ __forceinline__ const float* brec(const Ctx& c, int body) {
  return c.F + F_BODY + S_BODY * body;
}
// where entry j of the packed float table sits in its shared-memory copy
// (h: the schedule's header)
__device__ __forceinline__ int staged_index(const int* h, int j) {
  int p0 = h[H_PTEND], s0 = h[H_FTEND], sp = TEND_STRIDE;
  if (j < F_BODY) return j;
  if (j < h[H_PCP]) {
    p0 = F_BODY, s0 = F_BODY, sp = BODY_STRIDE;
  } else if (j < h[H_PGC]) {
    p0 = h[H_PCP], s0 = h[H_FCP], sp = CP_STRIDE;
  } else if (j < h[H_PPAIR]) {
    p0 = h[H_PGC], s0 = h[H_FGC], sp = GC_STRIDE;
  } else if (j < h[H_PSURF]) {
    p0 = h[H_PPAIR], s0 = h[H_FPAIR], sp = PAIR_STRIDE;
  } else if (j < h[H_PTEND]) {
    p0 = h[H_PSURF], s0 = h[H_FSURF], sp = SURF_STRIDE;
  }
  const int r = (j - p0) / sp;
  return s0 + r * (sp + 1) + (j - p0 - r * sp);
}

// a body's slot entry in the schedule: its slot within its level, plus
// SLOT_UNDER_FIXED for a joint body whose parent is a FIXED root (its
// articulated inertia is not needed: a FIXED root solves nothing)
#define SLOT_UNDER_FIXED 0x40000000
__device__ __forceinline__ int slot_entry(const Ctx& c, int i) {
  return c.S[c.h[H_SLOT] + i];
}

// offsets of the keys in one env's packed overlay (must match
// ops/fused_step.py OVERLAY_KEYS): damping_scale (njd) at 0, then
// friction_scale (nb), geom_scale (nb), gravity_delta (3),
// limit_lower_delta (njd), limit_upper_delta (njd), mass_scale (nb),
// stiffness_scale (njd), tendon_damping_scale (nt),
// tendon_stiffness_scale (nt); n_dr floats in all
struct DrOffsets {
  int o_fric, o_geom, o_grav, o_lo, o_hi, o_mass, o_stiff, o_tdamp, o_tstiff, n_dr;
  __device__ __forceinline__ explicit DrOffsets(const int* h) {
    const int nb = h[H_NB], njd = h[H_NJD], nt = h[H_NT];
    o_fric = njd;
    o_geom = o_fric + nb;
    o_grav = o_geom + nb;
    o_lo = o_grav + 3;
    o_hi = o_lo + njd;
    o_mass = o_hi + njd;
    o_stiff = o_mass + nb;
    o_tdamp = o_stiff + njd;
    o_tstiff = o_tdamp + nt;
    n_dr = o_tstiff + nt;
  }
};

// this env's staged overlay: after the planes, where there are planes
template <bool PLANES>
__device__ __forceinline__ const float* overlay(const Ctx& c) {
  return c.s + c.h[L_PLANES] + (PLANES ? 4 * c.h[H_NCP] : 0);
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
// row k of A x
__device__ __forceinline__ float rowdot(const float* A, int k, const float* x) {
  return A[3 * k] * x[0] + A[3 * k + 1] * x[1] + A[3 * k + 2] * x[2];
}
// c = a x b (c must not alias a or b)
__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}
// component k of a x b, as cross3 computes it
__device__ __forceinline__ float crossk(const float* a, const float* b, int k) {
  const int k1 = k == 2 ? 0 : k + 1, k2 = k == 0 ? 2 : k - 1;
  return a[k1] * b[k2] - a[k2] * b[k1];
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

// Cholesky solve of the 6x6 SPD system A x = b (row-major A, its lower
// triangle read)
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

// origin of joint body i in its parent's frame: the joint frame's origin,
// moved along the axis by th for a prismatic joint (r = jpos + Et^T a th)
__device__ __forceinline__ void joint_r(const float* Bf, bool prismatic, float th, float* r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = Bf[B_JPOS + c];
  if (prismatic) {
    const float s0 = Bf[B_AXIS] * th, s1 = Bf[B_AXIS + 1] * th, s2 = Bf[B_AXIS + 2] * th;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r[c] += Bf[B_ET + c] * s0 + Bf[B_ET + 3 + c] * s1 + Bf[B_ET + 6 + c] * s2;
  }
}

// ---- forward kinematics of a forest: FREE roots read their pose and
// velocity from q / qd, FIXED roots sit at the table's constant pose, joint
// bodies follow their parent through a revolute or prismatic joint ----

// what body i needs of no other body: a root's frame, a joint's rotation
// E (parent -> body; E = R^T Et) and origin r in the parent's frame
__device__ __forceinline__ void fk_local(const Ctx& c, int i) {
  const int p = bi(c, i, IB_PARENT), jt = bi(c, i, IB_JTYPE);
  const int qa = bi(c, i, IB_QADR), va = bi(c, i, IB_VADR);
  const float* Bf = brec(c, i);
  const float* q = at(c, L_Q);
  const float* qd = at(c, L_QD);
  if (p < 0) {
    float* Rw = at(c, L_RW) + 9 * i;
    float* pw = at(c, L_PW) + 3 * i;
    float* w = at(c, L_W) + 3 * i;
    float* l = at(c, L_L) + 3 * i;
    if (jt == JT_FREE) {
      quat_mat(q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6], Rw);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pw[k] = q[qa + k];
        w[k] = qd[va + k];
        l[k] = qd[va + 3 + k];
      }
    } else {  // FIXED: Rw = Et^T, at the joint frame's origin, at rest
#pragma unroll
      for (int rr = 0; rr < 3; ++rr)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) Rw[3 * rr + cc] = Bf[B_ET + 3 * cc + rr];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pw[k] = Bf[B_JPOS + k];
        w[k] = 0.f;
        l[k] = 0.f;
      }
    }
    return;
  }
  const bool prismatic = jt == JT_PRISMATIC;
  const float th = q[qa];
  joint_r(Bf, prismatic, th, at(c, L_RJ) + 3 * i);
  float* E = at(c, L_E) + 9 * i;
  if (prismatic) {
#pragma unroll
    for (int k = 0; k < 9; ++k) E[k] = Bf[B_ET + k];
    return;
  }
  float a[3], Et[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] = Bf[B_AXIS + k];
#pragma unroll
  for (int k = 0; k < 9; ++k) Et[k] = Bf[B_ET + k];
  float s, co;
  sincosf(th, &s, &co);
  const float oc = 1.f - co;
  // Rodrigues rotation about the joint axis
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

// item k of joint body i, its parent done: k < 9 entry k of Rw_i = Rw_p
// E^T; k = 9 + j row j of v_i = X_i v_p + S thd (S = [axis; 0] revolute,
// [0; axis] prismatic) and of pw_i = pw_p + Rw_p r
__device__ __forceinline__ void fk_chain(const Ctx& c, int i, int k) {
  const int p = bi(c, i, IB_PARENT);
  const float* E = at(c, L_E) + 9 * i;
  const float* Rp = at(c, L_RW) + 9 * p;
  if (k < 9) {
    const int rr = k / 3, cc = k - 3 * rr;
    at(c, L_RW)[9 * i + k] =
        Rp[3 * rr] * E[3 * cc] + Rp[3 * rr + 1] * E[3 * cc + 1] + Rp[3 * rr + 2] * E[3 * cc + 2];
    return;
  }
  const int j = k - 9;
  const bool prismatic = bi(c, i, IB_JTYPE) == JT_PRISMATIC;
  const float vj = brec(c, i)[B_AXIS + j] * at(c, L_QD)[bi(c, i, IB_VADR)];
  const float* r = at(c, L_RJ) + 3 * i;
  const float* wp = at(c, L_W) + 3 * p;
  const float* lp = at(c, L_L) + 3 * p;
  float crs[3], tmp[3];
  cross3(r, wp, crs);
#pragma unroll
  for (int m = 0; m < 3; ++m) tmp[m] = lp[m] - crs[m];
  float w = rowdot(E, j, wp), l = rowdot(E, j, tmp);
  if (prismatic)
    l += vj;
  else
    w += vj;
  at(c, L_W)[3 * i + j] = w;
  at(c, L_L)[3 * i + j] = l;
  at(c, L_PW)[3 * i + j] = at(c, L_PW)[3 * p + j] + rowdot(Rp, j, r);
}

// row j of body i's world velocities and of its velocity-product bias
// v x vJ (zero at a root)
__device__ __forceinline__ void fk_world(const Ctx& c, int i, int j) {
  const float* Rw = at(c, L_RW) + 9 * i;
  const float* w = at(c, L_W) + 3 * i;
  const float* l = at(c, L_L) + 3 * i;
  at(c, L_WV)[3 * i + j] = rowdot(Rw, j, w);
  at(c, L_LV)[3 * i + j] = rowdot(Rw, j, l);
  float cw = 0.f, cl = 0.f;
  if (bi(c, i, IB_PARENT) >= 0) {
    const float thd = at(c, L_QD)[bi(c, i, IB_VADR)];
    const float* Bf = brec(c, i);
    const float vJ[3] = {Bf[B_AXIS] * thd, Bf[B_AXIS + 1] * thd, Bf[B_AXIS + 2] * thd};
    if (bi(c, i, IB_JTYPE) == JT_PRISMATIC) {
      cl = crossk(w, vJ, j);
    } else {
      cw = crossk(w, vJ, j);
      cl = crossk(l, vJ, j);
    }
  }
  at(c, L_CW)[3 * i + j] = cw;
  at(c, L_CL)[3 * i + j] = cl;
}

template <int G>
__device__ __forceinline__ void fk(const Ctx& c, Prof& pf) {
  const int nb = c.h[H_NB], nlev = c.h[H_NLEV];
  const int* lev = c.S + c.h[H_LEV];
  const int* lb = c.S + c.h[H_LBODY];
  for (int j = c.lane; j < nb; j += G) fk_local(c, j);
  gsync<G>(c);
  pf.mark(c, PF_FK_LOCAL);
  for (int L = 1; L < nlev; ++L) {
    const int b0 = lev[L], n = 12 * (lev[L + 1] - b0);
    for (int j = c.lane; j < n; j += G) fk_chain(c, lb[b0 + j / 12], j % 12);
    gsync<G>(c);
  }
  pf.mark(c, PF_FK_CHAIN);
  for (int j = c.lane; j < 3 * nb; j += G) fk_world(c, j / 3, j % 3);
  gsync<G>(c);
  pf.mark(c, PF_FK_WORLD);
}

// ---- contacts: one item per ground point and per pair, each writing its
// wrench to the staging area; the per-body sums follow in contact_sum ----

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
  for (int k = 0; k < 3; ++k) f[k] = fn * n[k] - sc * vt[k];
}

// unit vector and length of d, floored as the pair contacts define them
__device__ __forceinline__ float unit3(const float* d, float* n) {
  const float dist = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-18f);
  const float inv = 1.f / (dist + 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = d[k] * inv;
  return dist;
}

__device__ __forceinline__ float sign0(float x) {
  return x != x ? x : (float)((x > 0.f) - (x < 0.f));
}

// ground point c_: with PLANES against this env's terrain plane [n, d]
// (pen = radius - (n.pt - d), force along the general normal; n arrives as
// a unit vector and is not renormalized), else against z = 0. Stages the
// force and its torque about the body origin (6 floats). DR: geom_scale
// and friction_scale of the point's body.
template <bool PLANES, bool DR>
__device__ __forceinline__ void ground_contact(const Ctx& c, int c_) {
  const int b = c.I[c.h[H_ICP] + c_];
  const float* Cf = c.F + c.h[H_FCP] + S_CP * c_;
  const float* Rw = at(c, L_RW) + 9 * b;
  const float* pw = at(c, L_PW) + 3 * b;
  const float* wv = at(c, L_WV) + 3 * b;
  const float* lv = at(c, L_LV) + 3 * b;
  const float chi = c.F[4];
  float lp[3], rel[3], crs[3], vpt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) lp[k] = Cf[C_POS + k];
  float rad = Cf[C_RAD], mu = Cf[C_MU];
  if constexpr (DR) {
    const DrOffsets o(c.h);
    const float* dr = overlay<PLANES>(c);
    const float gs = dr[o.o_geom + b];
#pragma unroll
    for (int k = 0; k < 3; ++k) lp[k] *= gs;
    rad *= gs;
    mu *= dr[o.o_fric + b];
  }
  mv3(Rw, lp, rel);
  cross3(wv, rel, crs);
#pragma unroll
  for (int k = 0; k < 3; ++k) vpt[k] = lv[k] + crs[k];
  float f[3];
  if constexpr (PLANES) {
    const float* P = at(c, L_PLANES) + 4 * c_;
    const float pn[3] = {P[0], P[1], P[2]};
    const float dist = pn[0] * (pw[0] + rel[0]) + pn[1] * (pw[1] + rel[1]) +
                       pn[2] * (pw[2] + rel[2]) - P[3];
    contact_force(rad - dist, pn, vpt, mu, Cf[C_KN], Cf[C_KT], Cf[C_FNM], chi, f);
  } else {
    const float pen = rad - (pw[2] + rel[2]);
    const float vn = vpt[2];
    const float fn = jmin(Cf[C_KN] * jmax(pen, 0.f) * jclip(1.f - chi * vn, 0.f, 5.f),
                          Cf[C_FNM]);
    const float vt0 = vpt[0], vt1 = vpt[1];
    const float vt_norm = sqrtf(vt0 * vt0 + vt1 * vt1 + 1e-12f);
    const float ft_mag = jmin(mu * fn, Cf[C_KT] * vt_norm);
    const float sc = ft_mag / (vt_norm + 1e-6f);
    f[0] = -sc * vt0;
    f[1] = -sc * vt1;
    f[2] = fn;
  }
  float* out = at(c, L_STAGE) + 6 * c_;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = f[k];
  cross3(rel, f, out + 3);
}

// pair pk: a contact point against a surface of another body; stages the
// force on the point's body and its torques about the point's body origin
// and about the surface body's origin (9 floats; the surface's body takes
// the opposite force). DR: geom_scale of the point by its body and of the
// surface's lengths by the surface's body (a box's rotation is not
// scaled), friction_scale by the point's body.
template <bool PLANES, bool DR>
__device__ __forceinline__ void pair_contact(const Ctx& c, int pk) {
  const int pi = c.I[c.h[H_IPAIR] + 2 * pk], si = c.I[c.h[H_IPAIR] + 2 * pk + 1];
  const int pb = c.I[c.h[H_ICP] + pi];
  const int st = c.I[c.h[H_ISURF] + 2 * si], sb = c.I[c.h[H_ISURF] + 2 * si + 1];
  const float* Cf = c.F + c.h[H_FCP] + S_CP * pi;
  const float* S = c.F + c.h[H_FSURF] + S_SURF * si;
  const float* Gp = c.F + c.h[H_FPAIR] + S_PAIR * pk;
  const float* Rs = at(c, L_RW) + 9 * sb;
  const float* pwp = at(c, L_PW) + 3 * pb;
  const float* pws = at(c, L_PW) + 3 * sb;
  float lp[3], relp[3], rels[3], n[3], tmp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) lp[k] = Cf[C_POS + k];
  float rad = Cf[C_RAD], mu = Cf[C_MU], sgs = 1.f;
  if constexpr (DR) {
    const DrOffsets o(c.h);
    const float* dr = overlay<PLANES>(c);
    const float gp = dr[o.o_geom + pb];
#pragma unroll
    for (int k = 0; k < 3; ++k) lp[k] *= gp;
    rad *= gp;
    sgs = dr[o.o_geom + sb];
    mu *= dr[o.o_fric + pb];
  }
  mv3(at(c, L_RW) + 9 * pb, lp, relp);
  // the point relative to the surface body's origin
#pragma unroll
  for (int k = 0; k < 3; ++k) rels[k] = (pwp[k] + relp[k]) - pws[k];
  float pen;
  float at_[3] = {rels[0], rels[1], rels[2]};  // where the surface's velocity is taken
  if (st == ST_BOX) {
    float cl[3], hf[3], Rq[9], dl[3], pl[3], d_out[3], nl[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cl[k] = S[k];
      hf[k] = S[3 + k];
      if constexpr (DR) {
        cl[k] *= sgs;
        hf[k] *= sgs;
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) Rq[k] = S[6 + k];
    mv3(Rs, cl, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) dl[k] = rels[k] - tmp[k];
    mtv3(Rs, dl, tmp);
    mtv3(Rq, tmp, pl);  // the point in the box's frame
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_out[k] = pl[k] - jclip(pl[k], -hf[k], hf[k]);
      d2 += d_out[k] * d_out[k];
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
      for (int k = 0; k < 3; ++k) nl[k] = d_out[k] * inv;
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
    for (int k = 0; k < 3; ++k) {
      e0[k] = S[k];
      e1[k] = S[3 + k];
      if constexpr (DR) {
        e0[k] *= sgs;
        e1[k] *= sgs;
      }
    }
    mv3(Rs, e0, p0);
    mv3(Rs, e1, tmp);
    float num = 0.f, den = 1e-9f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      seg[k] = tmp[k] - p0[k];
      num += (rels[k] - p0[k]) * seg[k];
      den += seg[k] * seg[k];
    }
    const float tt = jclip(num / den, 0.f, 1.f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      at_[k] = p0[k] + tt * seg[k];  // nearest point of the axis
      d[k] = rels[k] - at_[k];
    }
    float srad = S[6];
    if constexpr (DR) srad *= sgs;
    pen = srad + rad - unit3(d, n);
  } else {  // sphere
    float cs[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) cs[k] = S[k];
    float srad = S[3];
    if constexpr (DR) {
#pragma unroll
      for (int k = 0; k < 3; ++k) cs[k] *= sgs;
      srad *= sgs;
    }
    mv3(Rs, cs, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = rels[k] - tmp[k];
    pen = srad + rad - unit3(d, n);
  }
  float c1[3], c2[3], vrel[3], f[3];
  cross3(at(c, L_WV) + 3 * pb, relp, c1);
  cross3(at(c, L_WV) + 3 * sb, at_, c2);
  const float* lvp = at(c, L_LV) + 3 * pb;
  const float* lvs = at(c, L_LV) + 3 * sb;
#pragma unroll
  for (int k = 0; k < 3; ++k) vrel[k] = (lvp[k] + c1[k]) - (lvs[k] + c2[k]);
  contact_force(pen, n, vrel, mu, Gp[P_KN], Gp[P_KT], Gp[P_FNM], c.F[4], f);
  float* out = at(c, L_STAGE) + 6 * c.h[H_NCP] + 9 * pk;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = f[k];
  cross3(relp, f, out + 3);
  cross3(rels, f, out + 6);
}

// component k of body b's contact wrench (k < 3 world force, else world
// torque about the body origin), summed by one lane over the body's ground
// points and pairs in the order of their indices; returns it and where it
// goes
__device__ __forceinline__ float contact_sum(const Ctx& c, int b, int k, float*& dst) {
  const int* start = c.S + c.h[H_CC];
  const int* code = c.S + c.h[H_CCL];
  const int ncp = c.h[H_NCP];
  const float* g = at(c, L_STAGE);
  const float* P = g + 6 * ncp;
  float s = 0.f;
  for (int t = start[b]; t < start[b + 1]; ++t) {
    const int x = code[t];
    if (x < ncp) {
      s += g[6 * x + k];
    } else {
      const int pk = (x - ncp) >> 1;
      if ((x - ncp) & 1)  // the surface's body: the opposite force
        s -= P[9 * pk + (k < 3 ? k : k + 3)];
      else
        s += P[9 * pk + k];
    }
  }
  dst = k < 3 ? at(c, L_FX) + 3 * b + k : at(c, L_TX) + 3 * b + k - 3;
  return s;
}

// ---- drives and tendons of joint body i: clamped Stable-PD + effort +
// passive damping/friction, then the fixed tendons that couple the joint,
// in tendon order (their implicit diagonal is part of the table's B_DIMPL;
// under the tendon scales its share `dtend` is summed here per env:
// stiffness and limit stiffness times the first scale, damping times the
// second). stiffness_scale and damping_scale reach the drive's gains only:
// the implicit diagonal stays unscaled. ----
template <bool PLANES, bool DR>
__device__ __forceinline__ void drive(const Ctx& c, int i) {
  if (bi(c, i, IB_PARENT) < 0) return;
  const float* Bf = brec(c, i);
  const float* q = at(c, L_Q);
  const float* qd = at(c, L_QD);
  const float h = c.F[3];
  const int d = bi(c, i, IB_JDOF);
  const float qj = q[bi(c, i, IB_QADR)], qjd = qd[bi(c, i, IB_VADR)];
  const float emax = Bf[B_EMAX];
  float kp = Bf[B_KP], kd = Bf[B_KD];
  const float* dr = overlay<PLANES>(c);
  const DrOffsets o(c.h);
  if constexpr (DR) {
    kp *= dr[o.o_stiff + d];
    kd *= dr[d];
  }
  const float drv = jclip(kp * (at(c, L_PTG)[d] - qj - h * qjd) + kd * (at(c, L_VTG)[d] - qjd),
                          -emax, emax);
  const float passive = -Bf[B_DAMP] * qjd - Bf[B_FRIC] * tanhf(qjd * 10.f);
  float tau = drv + at(c, L_EFF)[d] + passive;
  float dtend = 0.f;
  const int nt = c.h[H_NT];
  const int* tb = c.I + c.h[H_ITEND];
  for (int tn = 0; tn < nt; ++tn) {
    const int b0 = tb[2 * tn], b1 = tb[2 * tn + 1];
    if (b0 != i && b1 != i) continue;
    const float* T = c.F + c.h[H_FTEND] + S_TEND * tn;
    const float c0 = T[T_C0], c1 = T[T_C1];
    const float q0 = q[bi(c, b0, IB_QADR)], q1 = q[bi(c, b1, IB_QADR)];
    const float qd0 = qd[bi(c, b0, IB_VADR)], qd1 = qd[bi(c, b1, IB_VADR)];
    const float L = c0 * (q0 + h * qd0) + c1 * (q1 + h * qd1);
    const float Ldot = c0 * qd0 + c1 * qd1;
    const float excess = L - jclip(L, T[T_LO], T[T_HI]);
    float klim = T[T_KLIM], tk = T[T_K], tc = T[T_C];
    float per_t = 0.f;
    if constexpr (DR) {
      const float ts = dr[o.o_tstiff + tn];
      tk *= ts;
      klim *= ts;
      tc *= dr[o.o_tdamp + tn];
      per_t = h * (tc + h * (tk + klim));
    }
    const float F = klim * excess + tk * (L - T[T_REST]) + tc * Ldot;
    if (b0 == i) {
      tau -= c0 * F;
      if constexpr (DR) dtend += per_t * c0 * c0;
    }
    if (b1 == i) {
      tau -= c1 * F;
      if constexpr (DR) dtend += per_t * c1 * c1;
    }
  }
  at(c, L_TAU)[i] = tau;
  at(c, L_DT)[i] = dtend;
}

// gravity, per env under gravity_delta
template <bool PLANES, bool DR>
__device__ __forceinline__ float grav(const Ctx& c, int k) {
  float x = c.F[k];
  if constexpr (DR) x += overlay<PLANES>(c)[DrOffsets(c.h).o_grav + k];
  return x;
}

// ---- ABA: bias force of body i with the external wrench in body
// coordinates ----
template <bool PLANES, bool DR>
__device__ __forceinline__ void bias(const Ctx& c, int i) {
  const float* I6 = brec(c, i) + B_I6;
  const float* wi = at(c, L_W) + 3 * i;
  const float* li = at(c, L_L) + 3 * i;
  const float* Rw = at(c, L_RW) + 9 * i;
  const float* fapp = at(c, L_FAPP) + 6 * i;
  // I v with I = [[Io, m cx], [m cx^T, m 1]]: the skew blocks have a zero
  // diagonal and the mass block is diagonal, so those terms are skipped
  float Iv[6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int r1 = (r + 1) % 3, r2 = (r + 2) % 3;
    Iv[r] = I6[6 * r] * wi[0] + I6[6 * r + 1] * wi[1] + I6[6 * r + 2] * wi[2] +
            I6[6 * r + 3 + r1] * li[r1] + I6[6 * r + 3 + r2] * li[r2];
    Iv[3 + r] = I6[6 * (3 + r) + r1] * wi[r1] + I6[6 * (3 + r) + r2] * wi[r2] +
                I6[6 * (3 + r) + 3 + r] * li[r];
  }
  float n1[3], n2[3], f6[3];
  cross3(wi, Iv, n1);
  cross3(li, Iv + 3, n2);
  cross3(wi, Iv + 3, f6);
  // mass_scale: the body's bias force, after the cross products (it is
  // linear in I v), and its compensation force
  float ms = 1.f;
  if constexpr (DR) ms = overlay<PLANES>(c)[DrOffsets(c.h).o_mass + i];
  float tw[3], fw[3], tbd[3], fb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tw[k] = at(c, L_TX)[3 * i + k] + fapp[k];
    fw[k] = at(c, L_FX)[3 * i + k] + fapp[3 + k];
  }
  // gravity compensation: counter-gravity at the body's CoM; it enters
  // the dynamics, not the sensors' contact wrench
  const float* Gc = c.F + c.h[H_FGC] + S_GC * i;
  const float gcm = Gc[G_MASS];
  if (gcm != 0.f) {
    const float com[3] = {Gc[G_COM], Gc[G_COM + 1], Gc[G_COM + 2]};
    float fg[3] = {-gcm * grav<PLANES, DR>(c, 0), -gcm * grav<PLANES, DR>(c, 1),
                   -gcm * grav<PLANES, DR>(c, 2)};
    if constexpr (DR) {
#pragma unroll
      for (int k = 0; k < 3; ++k) fg[k] *= ms;
    }
    float cr[3], ng[3];
    mv3(Rw, com, cr);
    cross3(cr, fg, ng);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tw[k] += ng[k];
      fw[k] += fg[k];
    }
  }
  mtv3(Rw, tw, tbd);
  mtv3(Rw, fw, fb);
  float* pA = at(c, L_PA) + 6 * i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if constexpr (DR) {
      pA[k] = (n1[k] + n2[k]) * ms - tbd[k];
      pA[3 + k] = f6[k] * ms - fb[k];
    } else {
      pA[k] = n1[k] + n2[k] - tbd[k];
      pA[3 + k] = f6[k] - fb[k];
    }
  }
}

// ---- ABA inward pass, one level at a time, deepest first. For a joint
// body i, S = [axis; 0] (revolute) or [0; axis] (prismatic); X = [[E, 0],
// [-E rtil, E]] with rtil = skew(r); Q = E rtil. ----

// U = IA S, D = S^T U + armature + implicit diagonal (and 1 / D), u = tau
// - S^T pA
template <bool DR>
__device__ __forceinline__ void inward_head(const Ctx& c, int i) {
  const float* Bf = brec(c, i);
  const int o = bi(c, i, IB_JTYPE) == JT_PRISMATIC ? 3 : 0;
  const float a[3] = {Bf[B_AXIS], Bf[B_AXIS + 1], Bf[B_AXIS + 2]};
  const float* IA = at(c, L_IA) + 36 * i;
  const float* pA = at(c, L_PA) + 6 * i;
  float* U = at(c, L_U) + 6 * i;
  float Uo[3];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float x = IA[6 * r + o] * a[0] + IA[6 * r + o + 1] * a[1] + IA[6 * r + o + 2] * a[2];
    U[r] = x;
    if (r == o) Uo[0] = x;
    if (r == o + 1) Uo[1] = x;
    if (r == o + 2) Uo[2] = x;
  }
  float dimpl;
  if constexpr (DR)
    dimpl = Bf[B_DIMPL0] + at(c, L_DT)[i];
  else
    dimpl = Bf[B_DIMPL];
  const float D = a[0] * Uo[0] + a[1] * Uo[1] + a[2] * Uo[2] + Bf[B_ARM] + dimpl;
  at(c, L_D)[i] = D;
  at(c, L_IDV)[i] = 1.f / D;
  at(c, L_UU)[i] = at(c, L_TAU)[i] - (a[0] * pA[o] + a[1] * pA[o + 1] + a[2] * pA[o + 2]);
}

__device__ __forceinline__ float* slot(const Ctx& c, int i) {
  return at(c, L_TMP) + TM_STRIDE * (slot_entry(c, i) & (SLOT_UNDER_FIXED - 1));
}

// entry k of Q = E rtil
__device__ __forceinline__ void inward_q(const Ctx& c, int i, int k) {
  const int rr = k / 3, cc = k - 3 * rr;
  const float* E = at(c, L_E) + 9 * i;
  const float* r = at(c, L_RJ) + 3 * i;
  // column cc of rtil = {0, -r2, r1; r2, 0, -r0; -r1, r0, 0}
  const float t0 = cc == 0 ? 0.f : cc == 1 ? -r[2] : r[1];
  const float t1 = cc == 0 ? r[2] : cc == 1 ? 0.f : -r[0];
  const float t2 = cc == 0 ? -r[1] : cc == 1 ? r[0] : 0.f;
  slot(c, i)[TM_Q + k] = E[3 * rr] * t0 + E[3 * rr + 1] * t1 + E[3 * rr + 2] * t2;
}

// row r of Ia = IA - U U^T / D, entry m
__device__ __forceinline__ float ia_entry(const float* IA, const float* U, float invD, int r,
                                          int m) {
  return IA[6 * r + m] - U[r] * U[m] * invD;
}

// k < 36: entry k of T = Ia X; k >= 36: row k - 36 of pa = pA + Ia c +
// U u / D, c the velocity-product bias; returns it and where it goes
__device__ __forceinline__ float inward_t(const Ctx& c, int i, int k, float*& dst) {
  const float* IA = at(c, L_IA) + 36 * i;
  const float* U = at(c, L_U) + 6 * i;
  const float invD = at(c, L_IDV)[i];
  float* sl = slot(c, i);
  if (k >= 36) {
    const int r = k - 36;
    const float* cw = at(c, L_CW) + 3 * i;
    const float* cl = at(c, L_CL) + 3 * i;
    const float c6[6] = {cw[0], cw[1], cw[2], cl[0], cl[1], cl[2]};
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < 6; ++m) s += ia_entry(IA, U, invD, r, m) * c6[m];
    dst = sl + TM_PA + r;
    return at(c, L_PA)[6 * i + r] + s + U[r] * (at(c, L_UU)[i] * invD);
  }
  const int r = k / 6, cc = k - 6 * r;
  const float* Q = sl + TM_Q;
  const float* E = at(c, L_E) + 9 * i;
  float s = 0.f;
  if (cc < 3) {
#pragma unroll
    for (int m = 0; m < 3; ++m) s += ia_entry(IA, U, invD, r, m) * E[3 * m + cc];
#pragma unroll
    for (int m = 0; m < 3; ++m) s += ia_entry(IA, U, invD, r, 3 + m) * -Q[3 * m + cc];
  } else {
#pragma unroll
    for (int m = 0; m < 3; ++m) s += ia_entry(IA, U, invD, r, 3 + m) * E[3 * m + cc - 3];
  }
  dst = sl + TM_T + k;
  return s;
}

// entry k of body p's articulated inertia IA (k < 36, row-major; its
// spatial inertia, under mass_scale) or bias force pA (k >= 36), plus X^T
// Ia X and X^T pa of each of its children, by descending child index;
// returns it and where it goes. The whole 6x6 is summed, not its upper
// triangle: a chattering env of the randomized hand amplifies the
// difference of the two roundings past the limits of ops/parity.py.
template <bool PLANES, bool DR>
__device__ __forceinline__ float inward_acc(const Ctx& c, int p, int k, float*& dst) {
  const int* start = c.S + c.h[H_CH];
  const int* child = c.S + c.h[H_CHL];
  float acc;
  int r, cc = 0;
  if (k < 36) {
    r = k / 6;
    cc = k - 6 * r;
    dst = at(c, L_IA) + 36 * p + k;
    acc = brec(c, p)[B_I6 + k];
    if constexpr (DR) acc *= overlay<PLANES>(c)[DrOffsets(c.h).o_mass + p];
  } else {
    r = k - 36;
    dst = at(c, L_PA) + 6 * p + r;
    acc = *dst;
  }
  for (int t = start[p]; t < start[p + 1]; ++t) {
    const int j = child[t];
    const float* sl = slot(c, j);
    const float* E = at(c, L_E) + 9 * j;
    const float* Q = sl + TM_Q;
    // column r of X: rows m < 3 E[m][r] and rows 3 + m -Q[m][r] (r < 3),
    // rows 3 + m E[m][r - 3] (r >= 3)
    const float* v = k < 36 ? sl + TM_T + cc : sl + TM_PA;
    const int st = k < 36 ? 6 : 1;
    float s = 0.f;
    if (r < 3) {
#pragma unroll
      for (int m = 0; m < 3; ++m) s += E[3 * m + r] * v[st * m];
#pragma unroll
      for (int m = 0; m < 3; ++m) s += -Q[3 * m + r] * v[st * (3 + m)];
    } else {
#pragma unroll
      for (int m = 0; m < 3; ++m) s += E[3 * m + r - 3] * v[st * (3 + m)];
    }
    acc += s;
  }
  return acc;
}

// ---- roots: a0 = X_root [0; -g]; a FREE root solves IA qdd = -(pA + IA
// a0), a FIXED root only hands gravity on ----
template <bool PLANES, bool DR>
__device__ __forceinline__ void root_solve(const Ctx& c, int i) {
  const float mg[3] = {-grav<PLANES, DR>(c, 0), -grav<PLANES, DR>(c, 1),
                       -grav<PLANES, DR>(c, 2)};
  float al[3];
  mtv3(at(c, L_RW) + 9 * i, mg, al);
  const float a0[6] = {0.f, 0.f, 0.f, al[0], al[1], al[2]};
  float* acc = at(c, L_ACC) + 6 * i;
  if (bi(c, i, IB_JTYPE) == JT_FREE) {
    const int va = bi(c, i, IB_VADR);
    const float* IA = at(c, L_IA) + 36 * i;
    float A[36], rhs[6], x[6];
#pragma unroll
    for (int k = 0; k < 36; ++k) A[k] = IA[k];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.f;
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) s += A[6 * r + cc] * a0[cc];
      rhs[r] = -(at(c, L_PA)[6 * i + r] + s);
    }
    chol_solve6(A, rhs, x);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      at(c, L_QDD)[va + k] = x[k];
      acc[k] = a0[k] + x[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k] = a0[k];
  }
}

// ---- ABA outward pass: joint body i, its parent's acceleration done ----
__device__ __forceinline__ void outward(const Ctx& c, int i) {
  const int p = bi(c, i, IB_PARENT);
  const float* Bf = brec(c, i);
  const int o = bi(c, i, IB_JTYPE) == JT_PRISMATIC ? 3 : 0;
  const float* E = at(c, L_E) + 9 * i;
  const float* r = at(c, L_RJ) + 3 * i;
  const float* ap = at(c, L_ACC) + 6 * p;
  const float* U = at(c, L_U) + 6 * i;
  float crs[3], tmp[3], apw[3], apl[3];
  cross3(r, ap, crs);
#pragma unroll
  for (int k = 0; k < 3; ++k) tmp[k] = ap[3 + k] - crs[k];
  mv3(E, ap, apw);
  mv3(E, tmp, apl);
  float a_p[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a_p[k] = apw[k] + at(c, L_CW)[3 * i + k];
    a_p[3 + k] = apl[k] + at(c, L_CL)[3 * i + k];
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) s += U[k] * a_p[k];
  const float qdd_i = (at(c, L_UU)[i] - s) / at(c, L_D)[i];
  at(c, L_QDD)[bi(c, i, IB_VADR)] = qdd_i;
  float* acc = at(c, L_ACC) + 6 * i;
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[k] = a_p[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[o + k] += Bf[B_AXIS + k] * qdd_i;
}

// ---- semi-implicit Euler of body i's coordinates, in place: caps, joint
// velocity clamp, limits. The velocity and joint-position updates round
// the product and the sum separately (no fused multiply-add), as the plain
// version does: a joint that lands on its limit then takes the same branch
// in both. ----
template <bool PLANES, bool DR>
__device__ __forceinline__ void integrate(const Ctx& c, int i) {
  const int qa = bi(c, i, IB_QADR), va = bi(c, i, IB_VADR);
  float* q = at(c, L_Q);
  float* qd = at(c, L_QD);
  const float* qdd = at(c, L_QDD);
  const float h = c.F[3];
  if (bi(c, i, IB_PARENT) >= 0) {
    const float* Bf = brec(c, i);
    const float vmax = Bf[B_VMAX];
    // limit + delta, rounded once before the comparison, as the plain
    // version's tensor sum is
    float lo = Bf[B_LO], hi = Bf[B_HI];
    if constexpr (DR) {
      const DrOffsets o(c.h);
      const float* dr = overlay<PLANES>(c);
      const int d = bi(c, i, IB_JDOF);
      lo = __fadd_rn(lo, dr[o.o_lo + d]);
      hi = __fadd_rn(hi, dr[o.o_hi + d]);
    }
    float qjd = jclip(__fadd_rn(qd[va], __fmul_rn(h, qdd[va])), -vmax, vmax);
    float qj = __fadd_rn(q[qa], __fmul_rn(h, qjd));
    const bool hit_lb = qj < lo;
    const bool hit_ub = qj > hi;
    qj = jclip(qj, lo, hi);
    if (hit_ub) qjd = jmin(qjd, 0.f);
    if (hit_lb) qjd = jmax(qjd, 0.f);
    q[qa] = qj;
    qd[va] = qjd;
  } else if (bi(c, i, IB_JTYPE) == JT_FREE) {
    float v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = __fadd_rn(qd[va + k], __fmul_rn(h, qdd[va + k]));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = jclip(v[k], -64.f, 64.f);
      v[3 + k] = jclip(v[3 + k], -1000.f, 1000.f);
    }
    float dp[3];
    mv3(at(c, L_RW) + 9 * i, v + 3, dp);
    // q' = q * exp(omega h / 2)
    const float hx = v[0] * (h / 2.f), hy = v[1] * (h / 2.f), hz = v[2] * (h / 2.f);
    const float ang = sqrtf(hx * hx + hy * hy + hz * hz + 1e-24f);
    const float sa = sinf(ang) / ang;
    const float ew = cosf(ang), ex = sa * hx, ey = sa * hy, ez = sa * hz;
    const float qw = q[qa + 3], qx = q[qa + 4], qy = q[qa + 5], qz = q[qa + 6];
    const float nw = qw * ew - qx * ex - qy * ey - qz * ez;
    const float nx = qw * ex + qx * ew + qy * ez - qz * ey;
    const float ny = qw * ey - qx * ez + qy * ew + qz * ex;
    const float nz = qw * ez + qx * ey - qy * ex + qz * ew;
    const float norm = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz + 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) q[qa + k] = q[qa + k] + h * dp[k];
    q[qa + 3] = nw / norm;
    q[qa + 4] = nx / norm;
    q[qa + 5] = ny / norm;
    q[qa + 6] = nz / norm;
#pragma unroll
    for (int k = 0; k < 6; ++k) qd[va + k] = v[k];
  }
}

// ---- one env: copies between device memory and the working set, the
// substep, the report ----

// row e (n floats) of an (n_env, n) input into the working set, and back
// to an output, by consecutive lanes
template <int G>
__device__ __forceinline__ void load(const Ctx& c, float* dst, const float* src, long e, int n) {
  for (int j = c.lane; j < n; j += G) dst[j] = __ldg(src + e * n + j);
}
template <int G>
__device__ __forceinline__ void store(const Ctx& c, float* dst, long e, const float* src, int n) {
  for (int j = c.lane; j < n; j += G) dst[e * n + j] = src[j];
}

// one substep of the env in the working set: (q, qd) in place; leaves this
// substep's contact wrenches in L_FX / L_TX
template <bool PLANES, bool DR, int G>
__device__ __forceinline__ void substep(const Ctx& c, Prof& pf) {
  const int nb = c.h[H_NB], nlev = c.h[H_NLEV];
  const int ncp = c.h[H_NCP], npair = c.h[H_NPAIR];
  const int* lev = c.S + c.h[H_LEV];
  const int* lb = c.S + c.h[H_LBODY];
  fk<G>(c, pf);
  for (int j = c.lane; j < ncp; j += G) ground_contact<PLANES, DR>(c, j);
  for (int j = c.lane; j < npair; j += G) pair_contact<PLANES, DR>(c, j);
  gsync<G>(c);
  pf.mark(c, PF_CONTACT);
  two_per_round<G>(c, 6 * nb, [&](int j, float*& dst) {
    return contact_sum(c, j / 6, j % 6, dst);
  });
  for (int j = c.lane; j < nb; j += G) drive<PLANES, DR>(c, j);
  gsync<G>(c);
  pf.mark(c, PF_SUM_DRIVE);
  for (int j = c.lane; j < nb; j += G) bias<PLANES, DR>(c, j);
  gsync<G>(c);
  pf.mark(c, PF_BIAS);
  // inward, deepest level first: a level's bodies take their own inertia
  // and their children's X^T Ia X and X^T pa, then compute their own
  for (int L = nlev - 1; L >= 1; --L) {
    const int b0 = lev[L], n = lev[L + 1] - b0;
    two_per_round<G>(c, 42 * n, [&](int j, float*& dst) {
      return inward_acc<PLANES, DR>(c, lb[b0 + j / 42], j % 42, dst);
    });
    gsync<G>(c);
    pf.mark(c, PF_ACC);
    for (int j = c.lane; j < n; j += G) inward_head<DR>(c, lb[b0 + j]);
    for (int j = c.lane; j < 9 * n; j += G) {
      const int i = lb[b0 + j / 9];
      if (!(slot_entry(c, i) & SLOT_UNDER_FIXED)) inward_q(c, i, j % 9);
    }
    gsync<G>(c);
    pf.mark(c, PF_HEAD);
    two_per_round<G>(c, 42 * n, [&](int j, float*& dst) {
      const int i = lb[b0 + j / 42];
      return slot_entry(c, i) & SLOT_UNDER_FIXED ? 0.f : inward_t(c, i, j % 42, dst);
    });
    gsync<G>(c);
    pf.mark(c, PF_T);
  }
  const int n0 = lev[1] - lev[0];
  two_per_round<G>(c, 42 * n0, [&](int j, float*& dst) {
    const int i = lb[j / 42];
    return bi(c, i, IB_JTYPE) == JT_FREE ? inward_acc<PLANES, DR>(c, i, j % 42, dst) : 0.f;
  });
  gsync<G>(c);
  for (int j = c.lane; j < n0; j += G) root_solve<PLANES, DR>(c, lb[j]);
  gsync<G>(c);
  pf.mark(c, PF_ROOT);
  for (int L = 1; L < nlev; ++L) {
    const int b0 = lev[L], n = lev[L + 1] - b0;
    for (int j = c.lane; j < n; j += G) outward(c, lb[b0 + j]);
    gsync<G>(c);
  }
  pf.mark(c, PF_OUTWARD);
  for (int j = c.lane; j < nb; j += G) integrate<PLANES, DR>(c, j);
  gsync<G>(c);
  pf.mark(c, PF_INTEGRATE);
}

// report FK fields of the env, from its frames: pos (nb,3), quat (nb,4),
// avel, lvel (nb,3), each row of the env written by consecutive lanes
template <int G>
__device__ __forceinline__ void write_report(const Ctx& c, long e, float* pos, float* quat,
                                             float* avel, float* lvel) {
  const int nb = c.h[H_NB];
  for (int j = c.lane; j < nb; j += G) mat_quat(at(c, L_RW) + 9 * j, at(c, L_QUAT) + 4 * j);
  gsync<G>(c);
  store<G>(c, pos, e, at(c, L_PW), 3 * nb);
  store<G>(c, quat, e, at(c, L_QUAT), 4 * nb);
  store<G>(c, avel, e, at(c, L_WV), 3 * nb);
  store<G>(c, lvel, e, at(c, L_LV), 3 * nb);
}

// n_steps substeps of env e, then the report FK unless `pos` is null (the
// single-substep launch mode writes no report); with PLANES, `planes` is
// (n_env, ncp, 4); with DR, `dr` is (n_env, n_dr). Every input is read
// once and every output written once per launch.
template <bool PLANES, bool DR, int G>
__device__ __forceinline__ void step_env(const Ctx& c, long e, const float* q_in,
                                         const float* qd_in, const float* eff,
                                         const float* ptg, const float* vtg,
                                         const float* fapp, const float* planes,
                                         const float* dr, float* q_out, float* qd_out,
                                         float* sf_out, float* pos, float* quat,
                                         float* avel, float* lvel, int n_steps) {
  const int nb = c.h[H_NB], nq = c.h[H_NQ], nv = c.h[H_NV], njd = c.h[H_NJD];
  const int ncp = c.h[H_NCP], ns = c.h[H_NS];
  Prof pf;
  pf.start();
  load<G>(c, at(c, L_Q), q_in, e, nq);
  load<G>(c, at(c, L_QD), qd_in, e, nv);
  load<G>(c, at(c, L_EFF), eff, e, njd);
  load<G>(c, at(c, L_PTG), ptg, e, njd);
  load<G>(c, at(c, L_VTG), vtg, e, njd);
  load<G>(c, at(c, L_FAPP), fapp, e, 6 * nb);
  if constexpr (PLANES) load<G>(c, at(c, L_PLANES), planes, e, 4 * ncp);
  if constexpr (DR)
    load<G>(c, c.s + c.h[L_PLANES] + (PLANES ? 4 * ncp : 0), dr, e, DrOffsets(c.h).n_dr);
  gsync<G>(c);
  pf.mark(c, PF_LOAD);
  for (int s = 0; s < n_steps; ++s) substep<PLANES, DR, G>(c, pf);
  store<G>(c, q_out, e, at(c, L_Q), nq);
  store<G>(c, qd_out, e, at(c, L_QD), nv);
  // sensors read the last substep's contact wrench [force, torque]: ground
  // and pair contacts, without applied forces and gravity compensation
  for (int j = c.lane; j < 6 * ns; j += G) {
    const int b = c.I[c.h[H_ISENS] + j / 6], k = j % 6;
    sf_out[e * 6 * ns + j] = k < 3 ? at(c, L_FX)[3 * b + k] : at(c, L_TX)[3 * b + k - 3];
  }
  gsync<G>(c);
  pf.mark(c, PF_STORE);
  if (pos != nullptr) {
    Prof quiet;  // the report's FK counts as the report
    quiet.on = false;
    fk<G>(c, quiet);
    write_report<G>(c, e, pos, quat, avel, lvel);
    gsync<G>(c);
    pf.mark(c, PF_REPORT);
  }
}

template <int G>
__device__ __forceinline__ void fk_env(const Ctx& c, long e, const float* q_in,
                                       const float* qd_in, float* pos, float* quat,
                                       float* avel, float* lvel) {
  const int nq = c.h[H_NQ], nv = c.h[H_NV];
  load<G>(c, at(c, L_Q), q_in, e, nq);
  load<G>(c, at(c, L_QD), qd_in, e, nv);
  gsync<G>(c);
  Prof pf;
  fk<G>(c, pf);
  write_report<G>(c, e, pos, quat, avel, lvel);
  gsync<G>(c);
}

}  // namespace

#ifdef __CUDACC__

namespace {

// the schedule's header as a kernel parameter
struct Hdr {
  int v[H_LEN];
};

// stage the tables into the block's shared memory, [float table at the
// shared strides | int table], then the working sets of its envs, env_floats each; the group of
// this thread and its view
template <int G>
__device__ __forceinline__ Ctx block_ctx(const Hdr& hdr, const float* __restrict__ ftab,
                                         const int* __restrict__ itab, int nf, int ni,
                                         int env_floats) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  Ctx c;
  const int nfs = hdr.v[H_FEND];  // floats of the copy
  float* sm = reinterpret_cast<float*>(smem4);
  int* si = reinterpret_cast<int*>(sm + nfs);
  for (int j = threadIdx.x; j < nf; j += blockDim.x) sm[staged_index(hdr.v, j)] = __ldg(ftab + j);
  for (int j = threadIdx.x; j < ni; j += blockDim.x) si[j] = __ldg(itab + j);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < H_LEN; ++k) c.h[k] = hdr.v[k];
  c.F = sm;
  c.S = si;
  c.I = si + c.h[H_IMODEL];
  c.s = sm + ((nfs + ni + 3) & ~3) + (threadIdx.x / G) * env_floats;
  c.lane = threadIdx.x % G;
  c.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  return c;
}

// The device-memory placement, for a model whose one env and tables do not
// fit a block's shared memory: each group's working set is its own slot of
// `gws`, a scratch buffer of blocks x envs per block slots of env_floats
// floats (the wrapper allocates it once per launch configuration). The
// tables are staged in shared memory as above when nf > 0; with nf = 0 they
// stay in device memory, `ftab` then being the float table in its staged
// layout (packed once by the wrapper, ops/fused_step.py staged_table). The
// phases are those of the shared placement: __syncwarp orders the group's
// accesses to device memory as it does those to shared memory. Written
// out rather than built on block_ctx: a view that block_ctx built and this
// function then pointed elsewhere made the GMEM instantiations of
// step_kernel spill 128-160 B and run 12-16% slower on the H100.
template <int G>
__device__ __forceinline__ Ctx block_ctx_global(const Hdr& hdr, const float* __restrict__ ftab,
                                                const int* __restrict__ itab, int nf, int ni,
                                                int env_floats, float* __restrict__ gws) {
  extern __shared__ float4 smem4[];
  Ctx c;
#pragma unroll
  for (int k = 0; k < H_LEN; ++k) c.h[k] = hdr.v[k];
  if (nf > 0) {
    float* sm = reinterpret_cast<float*>(smem4);
    int* si = reinterpret_cast<int*>(sm + hdr.v[H_FEND]);
    for (int j = threadIdx.x; j < nf; j += blockDim.x) sm[staged_index(hdr.v, j)] = __ldg(ftab + j);
    for (int j = threadIdx.x; j < ni; j += blockDim.x) si[j] = __ldg(itab + j);
    __syncthreads();
    c.F = sm;
    c.S = si;
  } else {
    c.F = ftab;
    c.S = itab;
  }
  c.I = c.S + c.h[H_IMODEL];
  c.s = gws + ((long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G) * env_floats;
  c.lane = threadIdx.x % G;
  c.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  return c;
}

// the group's view in the placement GMEM picks
template <bool GMEM, int G>
__device__ __forceinline__ Ctx group_ctx(const Hdr& hdr, const float* __restrict__ ftab,
                                         const int* __restrict__ itab, int nf, int ni,
                                         int env_floats, float* __restrict__ gws) {
  if constexpr (GMEM)
    return block_ctx_global<G>(hdr, ftab, itab, nf, ni, env_floats, gws);
  else
    return block_ctx<G>(hdr, ftab, itab, nf, ni, env_floats);
}

template <bool PLANES, bool DR, bool GMEM, int G>
__global__ void __launch_bounds__(OIGE_MAX_THREADS, 1) step_kernel(
    const Hdr hdr, const float* __restrict__ ftab, const int* __restrict__ itab, int nf, int ni,
    int env_floats, const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ eff, const float* __restrict__ ptg,
    const float* __restrict__ vtg, const float* __restrict__ fapp,
    const float* __restrict__ planes, const float* __restrict__ dr,
    float* __restrict__ q_out, float* __restrict__ qd_out, float* __restrict__ sf_out,
    float* __restrict__ pos, float* __restrict__ quat, float* __restrict__ avel,
    float* __restrict__ lvel, int n_env, int n_steps, float* __restrict__ gws) {
  const Ctx c = group_ctx<GMEM, G>(hdr, ftab, itab, nf, ni, env_floats, gws);
  const int epb = blockDim.x / G;
  const long stride = (long)gridDim.x * epb;
  for (long e = (long)blockIdx.x * epb + threadIdx.x / G; e < n_env; e += stride)
    step_env<PLANES, DR, G>(c, e, q_in, qd_in, eff, ptg, vtg, fapp, planes, dr, q_out,
                            qd_out, sf_out, pos, quat, avel, lvel, n_steps);
}

template <bool GMEM, int G>
__global__ void __launch_bounds__(OIGE_MAX_THREADS, 1) fk_kernel(
    const Hdr hdr, const float* __restrict__ ftab, const int* __restrict__ itab, int nf, int ni,
    int env_floats, const float* __restrict__ q_in, const float* __restrict__ qd_in,
    float* __restrict__ pos, float* __restrict__ quat, float* __restrict__ avel,
    float* __restrict__ lvel, int n_env, float* __restrict__ gws) {
  const Ctx c = group_ctx<GMEM, G>(hdr, ftab, itab, nf, ni, env_floats, gws);
  const int epb = blockDim.x / G;
  const long stride = (long)gridDim.x * epb;
  for (long e = (long)blockIdx.x * epb + threadIdx.x / G; e < n_env; e += stride)
    fk_env<G>(c, e, q_in, qd_in, pos, quat, avel, lvel);
}

// the launch configuration (host memory, from ops/fused_step.py
// launch_config): envs per block, blocks, shared bytes per block, floats
// per env's working set, float and int table lengths, then the schedule's
// header (H_LEN ints)
enum { CFG_EPB, CFG_BLOCKS, CFG_SMEM, CFG_ENV, CFG_NF, CFG_NI, CFG_LEN };

Hdr header(const int* cfg) {
  Hdr h;
  for (int k = 0; k < H_LEN; ++k) h.v[k] = cfg[CFG_LEN + k];
  return h;
}

// the configuration fits these tables (dims: nb, ncp, ns, npair, nsurf,
// nt, nq, nv, njd) and a block's threads
bool cfg_ok(const int* dims, const int* cfg) {
  const int nf = F_BODY + (BODY_STRIDE + GC_STRIDE) * dims[0] + CP_STRIDE * dims[1] +
                 PAIR_STRIDE * dims[3] + SURF_STRIDE * dims[4] + TEND_STRIDE * dims[5];
  return cfg[CFG_NF] == nf && OIGE_G * cfg[CFG_EPB] <= OIGE_MAX_THREADS;
}

// whether a launch stages the tables: always, but in the device-memory
// placement without shared memory (the tables stay in device memory and
// the kernel is handed nf = ni = 0, block_ctx_global)
template <bool GMEM>
bool stages_tables(const int* cfg) {
  return !GMEM || cfg[CFG_SMEM] > 0;
}

// lets `kernel` take up to the device's largest dynamic shared memory per
// block; each launcher calls it once per process (a static of its own), not
// at every launch
template <class K>
int allow_max_smem(K kernel) {
  int dev = 0, most = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return err;
}

template <bool PLANES, bool DR, bool GMEM>
int launch_step(const int* cfg, const float* ftab, const int* itab, const float* q,
                const float* qd, const float* eff, const float* ptg, const float* vtg,
                const float* fapp, const float* planes, const float* dr, float* gws,
                float* q_out, float* qd_out, float* sf_out, float* pos, float* quat,
                float* avel, float* lvel, int n_env, int n_steps, void* stream) {
  static const int err = allow_max_smem(step_kernel<PLANES, DR, GMEM, OIGE_G>);
  if (err) return err;
  step_kernel<PLANES, DR, GMEM, OIGE_G><<<cfg[CFG_BLOCKS], OIGE_G * cfg[CFG_EPB],
                                          cfg[CFG_SMEM], (cudaStream_t)stream>>>(
      header(cfg), ftab, itab, stages_tables<GMEM>(cfg) ? cfg[CFG_NF] : 0,
      stages_tables<GMEM>(cfg) ? cfg[CFG_NI] : 0, cfg[CFG_ENV], q, qd, eff, ptg, vtg, fapp,
      planes, dr, q_out, qd_out, sf_out, pos, quat, avel, lvel, n_env, n_steps, gws);
  return (int)cudaGetLastError();
}

template <bool GMEM>
int launch_fk(const int* cfg, const float* ftab, const int* itab, const float* q,
              const float* qd, float* gws, float* pos, float* quat, float* avel, float* lvel,
              int n_env, void* stream) {
  static const int err = allow_max_smem(fk_kernel<GMEM, OIGE_G>);
  if (err) return err;
  fk_kernel<GMEM, OIGE_G><<<cfg[CFG_BLOCKS], OIGE_G * cfg[CFG_EPB], cfg[CFG_SMEM],
                            (cudaStream_t)stream>>>(
      header(cfg), ftab, itab, stages_tables<GMEM>(cfg) ? cfg[CFG_NF] : 0,
      stages_tables<GMEM>(cfg) ? cfg[CFG_NI] : 0, cfg[CFG_ENV], q, qd, pos, quat, avel, lvel,
      n_env, gws);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- C entry points: launch on the caller's stream, return cudaError_t ----

// itab: [schedule | model int table]; planes: (n_env, ncp, 4) contiguous
// terrain planes, or null for flat ground; dr: (n_env, n_dr) contiguous
// packed overlays, or null for none; gws: the scratch buffer of the
// device-memory placement, or null for the shared-memory placement (ftab
// then the float table as the kernel stages it when cfg gives no shared
// memory). Which of the three are given picks one of the kernel's eight
// instantiations.
extern "C" int oige_step(const float* ftab, const int* itab, const int* dims,
                         const float* q, const float* qd, const float* eff,
                         const float* ptg, const float* vtg, const float* fapp,
                         const float* planes, const float* dr, float* gws, float* q_out,
                         float* qd_out, float* sf_out, float* pos,
                         float* quat, float* avel, float* lvel, int n_env, int n_steps,
                         void* stream, const int* cfg) {
  if (!cfg_ok(dims, cfg)) return (int)cudaErrorInvalidValue;
#define OIGE_STEP_ARGS                                                                   \
  cfg, ftab, itab, q, qd, eff, ptg, vtg, fapp, planes, dr, gws, q_out, qd_out, sf_out, pos, \
      quat, avel, lvel, n_env, n_steps, stream
  if (gws != nullptr) {
    if (planes != nullptr && dr != nullptr) return launch_step<true, true, true>(OIGE_STEP_ARGS);
    if (planes != nullptr) return launch_step<true, false, true>(OIGE_STEP_ARGS);
    if (dr != nullptr) return launch_step<false, true, true>(OIGE_STEP_ARGS);
    return launch_step<false, false, true>(OIGE_STEP_ARGS);
  }
  if (planes != nullptr && dr != nullptr) return launch_step<true, true, false>(OIGE_STEP_ARGS);
  if (planes != nullptr) return launch_step<true, false, false>(OIGE_STEP_ARGS);
  if (dr != nullptr) return launch_step<false, true, false>(OIGE_STEP_ARGS);
  return launch_step<false, false, false>(OIGE_STEP_ARGS);
#undef OIGE_STEP_ARGS
}

// K3: one substep, no report FK
extern "C" int oige_substep(const float* ftab, const int* itab, const int* dims,
                            const float* q, const float* qd, const float* eff,
                            const float* ptg, const float* vtg, const float* fapp,
                            const float* planes, const float* dr, float* gws, float* q_out,
                            float* qd_out, float* sf_out, int n_env, void* stream,
                            const int* cfg) {
  return oige_step(ftab, itab, dims, q, qd, eff, ptg, vtg, fapp, planes, dr, gws, q_out,
                   qd_out, sf_out, nullptr, nullptr, nullptr, nullptr, n_env, 1, stream, cfg);
}

// the phase counters of a build with -DOIGE_PROFILE: cycles and marks of
// each phase (2 * PF_N values, summed over the slots), read and then
// zeroed; -1 in other builds
extern "C" int oige_profile(unsigned long long* out) {
#ifdef OIGE_PROFILE
  static unsigned long long buf[PF_SLOTS * 2 * PF_N];
  cudaError_t err = cudaMemcpyFromSymbol(buf, g_prof, sizeof(g_prof));
  if (err) return (int)err;
  for (int k = 0; k < 2 * PF_N; ++k) {
    out[k] = 0;
    for (int sl = 0; sl < PF_SLOTS; ++sl) out[k] += buf[sl * 2 * PF_N + k];
  }
  for (auto& x : buf) x = 0;
  return (int)cudaMemcpyToSymbol(g_prof, buf, sizeof(g_prof));
#else
  (void)out;
  return -1;
#endif
}

// gws as in oige_step
extern "C" int oige_fk(const float* ftab, const int* itab, const int* dims,
                       const float* q, const float* qd, float* gws, float* pos, float* quat,
                       float* avel, float* lvel, int n_env, void* stream, const int* cfg) {
  if (!cfg_ok(dims, cfg)) return (int)cudaErrorInvalidValue;
  if (gws != nullptr)
    return launch_fk<true>(cfg, ftab, itab, q, qd, gws, pos, quat, avel, lvel, n_env, stream);
  return launch_fk<false>(cfg, ftab, itab, q, qd, gws, pos, quat, avel, lvel, n_env, stream);
}

#endif  // __CUDACC__
