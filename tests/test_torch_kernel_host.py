"""The kernel sources `ops/csrc/fused_step.cu` (the group form of K1 and
K3, and K2) and `ops/csrc/fused_step_thread.cu` (the one-thread-per-env
form of K1 and K3) built as host C++ and held against the plain versions
on the CPU.

The device functions of the kernels (`step_env`, `fk_env` and the phases
under them) build with g++ from a prelude that maps `__device__`,
`__forceinline__`, `__shared__`, `__syncwarp`, `__ldg` and
`__fmul_rn`/`__fadd_rn` to host C++; the kernels and the C entry points
stand under `__CUDACC__` and are left out. In the group form a group of
one lane (lane 0, stride 1) walks the envs one by one through the same
working-set layout, schedule table and shared-memory copy of the float
table (`staged_index`) the card uses; the thread form runs its env
function per env as a thread does. The results go through `ops/parity.py`
`compare` with the card's tolerances: the Humanoid, the synthetic pair
scene, AnymalTerrain on its terrain planes, the ShadowHand under a
randomization overlay, FrankaCabinet (four FREE props, finger pads on the
handle bar) and the Quadcopter (forces on its rotors, whose centres of
mass are off their origins), each in both forms. Past the thread form's
maxima the group form alone: FrankaCabinet with 16 props, chip_smoke.py's
40-body MJCF robot of 160 contact points, and `parity.build_wide_tree`,
whose working set does not fit a block's shared memory, in the
device-memory placement (each env's working set a slot of a scratch
buffer, the tables staged as a block stages them or, as the wrapper packs
them, `fused_step.staged_table`); the thread form's build reports the
maxima (`oige_limits`) that `fused_step.THREAD_LIMITS` mirrors. Skips where
there is no g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.models import build_humanoid
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
from omniisaacgymenvs_torch.tasks import get_task

COMMON = r"""
#include <math.h>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __shared__
#define __syncwarp(mask) ((void)(mask))
template <class T> static inline T __ldg(const T* p) { return *p; }
// a product and a sum rounded on their own, as on the card
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
#include "SOURCE"
"""

# the one-thread-per-env form: `dims` and the model int table alone, as
# its C entry takes them
THREAD_PRELUDE = r"""
struct float4 { float x, y, z, w; };
""" + COMMON + r"""
template <bool P, bool D>
static void run(const Tables& t, long n, int n_steps, const float* const* in, float* const* out) {
  for (long e = 0; e < n; ++e)
    step_env<P, D>(t, e, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                   out[0], out[1], out[2], out[3], out[4], out[5], out[6], n_steps);
}

extern "C" void host_step(const float* ftab, const int* itab, const int* dims,
                          const float* const* in, float* const* out, long n,
                          int n_steps) {
  const Tables t = make_tables(ftab, itab, dims);
  if (in[6] && in[7]) run<true, true>(t, n, n_steps, in, out);
  else if (in[6]) run<true, false>(t, n, n_steps, in, out);
  else if (in[7]) run<false, true>(t, n, n_steps, in, out);
  else run<false, false>(t, n, n_steps, in, out);
}
"""

GROUP_PRELUDE = COMMON + r"""

template <bool P, bool D>
static void run(const Ctx& c, long n, int n_steps, const float* const* in, float* const* out) {
  for (long e = 0; e < n; ++e)
    step_env<P, D, 1>(c, e, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                      out[0], out[1], out[2], out[3], out[4], out[5], out[6], n_steps);
}

// the float table staged as a block stages it
static std::vector<float> staged(const float* ftab, const int* hdr) {
  std::vector<float> out(hdr[H_FEND]);
  for (int j = 0; j < hdr[H_PEND]; ++j) out[staged_index(hdr, j)] = ftab[j];
  return out;
}

// hdr: the schedule's header; itab: [schedule sections | model int table]
static Ctx host_ctx(const float* ftab, const int* hdr, const int* itab, float* ws) {
  Ctx c;
  c.F = ftab;
  for (int k = 0; k < H_LEN; ++k) c.h[k] = hdr[k];
  c.S = itab;
  c.I = itab + hdr[H_IMODEL];
  c.s = ws;
  c.lane = 0;
  c.mask = 0;
  return c;
}

// in: q, qd, eff, ptg, vtg, fapp, planes, dr; out: q, qd, sensors, pos,
// quat, avel, lvel
extern "C" void host_step(const float* ftab, const int* sched, int env_floats,
                          const float* const* in, float* const* out, long n,
                          int n_steps) {
  std::vector<float> ws(env_floats), tab = staged(ftab, sched);
  const Ctx c = host_ctx(tab.data(), sched, sched + H_LEN, ws.data());
  if (in[6] && in[7]) run<true, true>(c, n, n_steps, in, out);
  else if (in[6]) run<true, false>(c, n, n_steps, in, out);
  else if (in[7]) run<false, true>(c, n, n_steps, in, out);
  else run<false, false>(c, n, n_steps, in, out);
}

extern "C" void host_fk(const float* ftab, const int* sched, int env_floats,
                        const float* q, const float* qd, float* const* out, long n) {
  std::vector<float> ws(env_floats), tab = staged(ftab, sched);
  const Ctx c = host_ctx(tab.data(), sched, sched + H_LEN, ws.data());
  for (long e = 0; e < n; ++e) fk_env<1>(c, e, q, qd, out[0], out[1], out[2], out[3]);
}

// the device-memory placement: env e's working set is slot e % slots of
// the scratch buffer `gws` (as the groups of a persistent grid take their
// envs), the float table `ftab` already in its staged layout (the wrapper's
// copy where the tables stay in device memory, or the block's); flat
// ground, no overlay
extern "C" void host_step_global(const float* ftab, const int* sched, int env_floats,
                                 float* gws, int slots, const float* const* in,
                                 float* const* out, long n, int n_steps) {
  for (long e = 0; e < n; ++e) {
    const Ctx c = host_ctx(ftab, sched, sched + H_LEN, gws + (e % slots) * (long)env_floats);
    step_env<false, false, 1>(c, e, in[0], in[1], in[2], in[3], in[4], in[5], nullptr, nullptr,
                              out[0], out[1], out[2], out[3], out[4], out[5], out[6], n_steps);
  }
}

extern "C" void host_fk_global(const float* ftab, const int* sched, int env_floats,
                               float* gws, int slots, const float* q, const float* qd,
                               float* const* out, long n) {
  for (long e = 0; e < n; ++e) {
    const Ctx c = host_ctx(ftab, sched, sched + H_LEN, gws + (e % slots) * (long)env_floats);
    fk_env<1>(c, e, q, qd, out[0], out[1], out[2], out[3]);
  }
}

extern "C" void host_staged(const float* ftab, const int* sched, float* out) {
  const std::vector<float> tab = staged(ftab, sched);
  for (int j = 0; j < sched[H_FEND]; ++j) out[j] = tab[j];
}
"""


class HostLib:
    """One kernel source built as host C++: `form` "group" or "thread"."""

    def __init__(self, form, lib):
        self.form, self.lib = form, lib


@pytest.fixture(scope="module", params=fs.DESIGNS)
def host_lib(request, tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source as host C++")
    form = request.param
    thread = form == "thread"
    d = tmp_path_factory.mktemp(f"kernel_host_{form}")
    src = d / "host.cpp"
    src.write_text((THREAD_PRELUDE if thread else GROUP_PRELUDE).replace(
        "SOURCE", str(fs.THREAD_SOURCE if thread else fs.SOURCE)))
    so = d / "host.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-mfma", "-ffp-contract=fast", "-shared",
         "-fPIC", "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.host_step.argtypes = [vp, vp, vp if thread else ctypes.c_int, pp, pp,
                              ctypes.c_long, ctypes.c_int]
    if not thread:
        ci = ctypes.c_int
        lib.host_fk.argtypes = [vp, vp, ci, vp, vp, pp, ctypes.c_long]
        lib.host_step_global.argtypes = [vp, vp, ci, vp, ci, pp, pp, ctypes.c_long, ci]
        lib.host_fk_global.argtypes = [vp, vp, ci, vp, ci, vp, vp, pp, ctypes.c_long]
        lib.host_staged.argtypes = [vp, vp, vp]
    return HostLib(form, lib)


def _tables(eng, form="group"):
    """The packed tables as the form's C entry takes them: the thread form
    the model int table alone, the group form [schedule | model ints]."""
    m = eng.model
    gains = np.stack([g.cpu().numpy() for g in eng.contact_gains])
    ftab, itab = fs.pack_tables(m, eng.h, eng.params.gravity,
                                eng.contact_params, gains, eng.pair_gains)
    if form == "thread":
        return ftab, itab
    return ftab, np.concatenate([fs.pack_schedule(m), itab])


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(
        *[None if a is None else a.ctypes.data for a in arrays])


def host_step(host, eng, q, qd, eff, ptg, vtg, fa, n_steps, planes=None,
              overlay=None):
    """K1's device code on the host: (q, qd, sensors, pos, quat, avel,
    lvel) as torch tensors."""
    m = eng.model
    n = q.shape[0]
    ftab, itab = _tables(eng, host.form)
    dr = None if overlay is None else fs.pack_overlay(m, overlay, n, "cpu")
    npf = lambda x: None if x is None else np.ascontiguousarray(  # noqa: E731
        x.detach().numpy(), np.float32)
    ins = [npf(x) for x in (q, qd, eff, ptg, vtg, fa, planes, dr)]
    outs = [np.zeros(s, np.float32) for s in (
        (n, m.nq), (n, m.nv), (n, m.num_sensors, 6), (n, m.nb, 3),
        (n, m.nb, 4), (n, m.nb, 3), (n, m.nb, 3))]
    if host.form == "thread":
        dims = np.asarray(fs.table_dims(m), np.int32)
        third = dims.ctypes.data
    else:
        third = fs.env_floats(m, planes is not None, overlay is not None)
    host.lib.host_step(ftab.ctypes.data, itab.ctypes.data, third,
                       _ptrs(ins), _ptrs(outs), n, n_steps)
    return tuple(torch.from_numpy(o) for o in outs)


def host_fk(host, eng, q, qd):
    m = eng.model
    n = q.shape[0]
    ftab, itab = _tables(eng)
    qn, qdn = (np.ascontiguousarray(x.numpy(), np.float32) for x in (q, qd))
    outs = [np.zeros((n, m.nb, k), np.float32) for k in (3, 4, 3, 3)]
    host.lib.host_fk(ftab.ctypes.data, itab.ctypes.data, fs.env_floats(m, fk=True),
                qn.ctypes.data, qdn.ctypes.data, _ptrs(outs), n)
    return tuple(torch.from_numpy(o) for o in outs)


def _check(lib, eng, n, seed, n_steps, planes=None, overlay=None, q=None,
           qd=None, eff=None, fa=None):
    m = eng.model
    if q is None:
        q, qd, eff = parity.check_inputs(m, n, seed=seed, device="cpu")
    q = parity.clear_box_ties(eng, q, qd, overlay)
    ptg = parity.check_targets(m, q, seed)
    z = torch.zeros((n, m.njd))
    if fa is None:
        fa = 0.05 * torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (n, m.nb, 6)).astype(np.float32))
    args = (q, qd, eff, ptg, z, fa)
    out = host_step(lib, eng, *args, n_steps, planes, overlay)
    ref = fs.step_plain(eng, *args, n_steps, planes=planes, overlay=overlay)
    tol = parity.step_tol(m)
    keep = None
    if overlay is not None:
        keep = parity.well_conditioned(
            lambda q_, qd_: fs.step_plain(eng, q_, qd_, *args[2:], n_steps,
                                          planes=planes, overlay=overlay),
            q, qd, ref, parity.STEP_NAMES, tol)
    parity.assert_within(f"{m.name} host K1 ({lib.form}) x{n_steps}",
                         parity.compare(out, ref, parity.STEP_NAMES, tol, keep), tol)
    if lib.form == "thread":  # K2 is the group form's
        return
    parity.assert_within(f"{m.name} host K2", parity.compare(
        host_fk(lib, eng, q, qd), fs.fk_plain(m, q, qd), parity.FK_NAMES,
        parity.FK_TOL), parity.FK_TOL)


def test_host_kernel_humanoid(host_lib):
    eng = PhysicsEngine(build_humanoid(), SimParams(dt=1.0 / 120.0, substeps=2))
    _check(host_lib, eng, 48, seed=0, n_steps=4)


def test_host_kernel_pair_scene(host_lib):
    eng = PhysicsEngine(parity.build_pair_scene(),
                        SimParams(dt=1.0 / 120.0, substeps=2))
    _check(host_lib, eng, 40, seed=1, n_steps=4)


def test_host_kernel_terrain_planes(host_lib):
    task = get_task("AnymalTerrain",
                    {"env": {"terrain": {"numLevels": 3, "numTerrains": 5}}},
                    device="cpu")
    eng = task.engine
    q, qd, eff = parity.terrain_check_inputs(task, 50, 2, "cpu")
    planes = eng._contact_planes(eng.init_state(q, qd))
    for n_steps in (1, 4):
        _check(host_lib, eng, 50, seed=2, n_steps=n_steps, planes=planes,
               q=q, qd=qd, eff=eff)


def test_host_kernel_shadow_hand_overlay(host_lib):
    eng = get_task("ShadowHand", device="cpu").engine
    ov = parity.overlay_inputs(eng.model, 64, seed=3, device="cpu")
    _check(host_lib, eng, 64, seed=3, n_steps=4, overlay=ov)


def test_host_kernel_franka_cabinet(host_lib):
    """Four FREE roots in one env (NFREE_MAX), the pads on the handle bar
    in every other env, the props on the drawer's tray."""
    eng = get_task("FrankaCabinet", {"env": {"numProps": 4}}, device="cpu").engine
    assert fs.n_free_roots(eng.model) == fs.NFREE_MAX
    q, qd, eff = parity.check_inputs(eng.model, 32, seed=4, device="cpu")
    active = parity.active_contacts(eng, q, qd)
    assert active["capsule"] > 0 and active["box"] > 0, active
    _check(host_lib, eng, 32, seed=4, n_steps=4, q=q, qd=qd, eff=eff)


def test_host_kernel_quadcopter_rotor_forces(host_lib):
    """1 N on each rotor, applied at the rotor's origin, 8 cm from its
    centre of mass."""
    eng = get_task("Quadcopter", device="cpu").engine
    m = eng.model
    n = 32
    rotors = [m.body_index(f"rotor_{i}") for i in range(4)]
    f = np.random.default_rng(5).standard_normal((n, 4, 3)).astype(np.float32)
    fa = torch.zeros((n, m.nb, 6))
    fa[:, rotors, 3:6] = torch.from_numpy(f / np.linalg.norm(f, axis=-1, keepdims=True))
    _check(host_lib, eng, n, seed=5, n_steps=1, fa=fa)


# past the thread form's maxima: the group form alone, the thread form's
# scope refusing the model
def _group_only(host, m):
    """True for the group form's build; for the thread form's, the model
    is past its maxima and `launch_config` refuses that form."""
    assert fs.thread_scope_errors(m) and fs.scope_errors(m) == []
    if host.form == "group":
        return True
    with pytest.raises(ValueError, match="thread form maximum"):
        fs.launch_config(m, 64, design="thread")
    return False


def test_host_kernel_franka_cabinet_sixteen_props(host_lib):
    """16 FREE props (152 contact points, 402 pairs), the pads on the handle
    bar in every other env, the props dropped onto the drawer's tray."""
    eng = get_task("FrankaCabinet", {"env": {"numProps": 16}}, device="cpu").engine
    if not _group_only(host_lib, eng.model):
        return
    q, qd, eff = parity.check_inputs(eng.model, 24, seed=7, device="cpu")
    active = parity.active_contacts(eng, q, qd)
    assert active["capsule"] > 0 and active["box"] > 0, active
    _check(host_lib, eng, 24, seed=7, n_steps=4, q=q, qd=qd, eff=eff)


def test_host_kernel_many_legged_robot(host_lib, tmp_path):
    """chip_smoke.py's MJCF robot: 40 bodies, 160 contact points, its feet
    in the ground."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import mjcf_legs

    (tmp_path / "legs.xml").write_text(mjcf_legs())
    task = get_task("Custom", {"env": {"robot": str(tmp_path / "legs.xml")}},
                    device="cpu")
    eng = task.engine
    assert (eng.model.nb, eng.model.ncp) == (40, 160)
    if not _group_only(host_lib, eng.model):
        return
    q, qd, eff = parity.check_inputs(eng.model, 16, seed=8, device="cpu")
    assert parity.active_contacts(eng, q, qd)["ground"] > 0
    _check(host_lib, eng, 16, seed=8, n_steps=4, q=q, qd=qd, eff=eff)


@pytest.mark.parametrize("tables", ["shared", "global"])
def test_host_kernel_device_memory_placement(host_lib, tables):
    """The wide tree's working set takes the device-memory placement: K1
    and K2 with each env's working set in a slot of a scratch buffer (three
    slots, taken in turn), the tables as a block stages them (`shared`) or
    as the wrapper packs them for device memory (`global`,
    `fused_step.staged_table`, which must equal the block's staging)."""
    eng = PhysicsEngine(parity.build_wide_tree(), SimParams(dt=1.0 / 120.0, substeps=2))
    m = eng.model
    if not _group_only(host_lib, m):
        return
    lc = fs.launch_config(m, 4096)
    assert lc["working_set"] == "global" and lc["tables"] == "shared", lc
    ftab, itab = _tables(eng)
    block = np.zeros(fs.staged_offsets(m)["f_end"], np.float32)
    host_lib.lib.host_staged(ftab.ctypes.data, itab.ctypes.data, block.ctypes.data)
    packed = fs.staged_table(m, ftab)
    np.testing.assert_array_equal(packed, block)
    staged = packed if tables == "global" else block
    n, slots = 8, 3
    env = fs.env_floats(m)
    q, qd, eff = parity.check_inputs(m, n, seed=9, device="cpu")
    assert parity.active_contacts(eng, q, qd)["ground"] > 0
    ptg = parity.check_targets(m, q, 9)
    z = torch.zeros((n, m.njd))
    fa = 0.05 * torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n, m.nb, 6)).astype(np.float32))
    args = (q, qd, eff, ptg, z, fa)
    ins = [np.ascontiguousarray(x.numpy(), np.float32) for x in args]
    outs = [np.zeros(sh, np.float32) for sh in (
        (n, m.nq), (n, m.nv), (n, m.num_sensors, 6), (n, m.nb, 3),
        (n, m.nb, 4), (n, m.nb, 3), (n, m.nb, 3))]
    gws = np.full(slots * env, np.nan, np.float32)
    host_lib.lib.host_step_global(staged.ctypes.data, itab.ctypes.data, env,
                                  gws.ctypes.data, slots, _ptrs(ins), _ptrs(outs), n, 4)
    tol = parity.step_tol(m)
    parity.assert_within("WideTree host K1 (device-memory placement)", parity.compare(
        tuple(torch.from_numpy(o) for o in outs), fs.step_plain(eng, *args, 4),
        parity.STEP_NAMES, tol), tol)
    fk_env = fs.env_floats(m, fk=True)
    fk_outs = [np.zeros((n, m.nb, k), np.float32) for k in (3, 4, 3, 3)]
    host_lib.lib.host_fk_global(staged.ctypes.data, itab.ctypes.data, fk_env,
                                gws.ctypes.data, slots, ins[0].ctypes.data,
                                ins[1].ctypes.data, _ptrs(fk_outs), n)
    parity.assert_within("WideTree host K2 (device-memory placement)", parity.compare(
        tuple(torch.from_numpy(o) for o in fk_outs), fs.fk_plain(m, q, qd),
        parity.FK_NAMES, parity.FK_TOL), parity.FK_TOL)


def test_host_maxima_live_in_the_thread_form_alone(host_lib):
    """The thread form's build reports its compile-time maxima, which
    `fused_step.THREAD_LIMITS` mirrors; the group form's source has none."""
    if host_lib.form == "group":
        src = fs.SOURCE.read_text()
        assert "_MAX " not in src.replace("OIGE_MAX_THREADS ", ""), "a maximum in the group form"
        assert not hasattr(host_lib.lib, "oige_limits")
        return
    lim = (ctypes.c_int * len(fs.THREAD_LIMITS))()
    host_lib.lib.oige_limits(lim)
    assert tuple(lim) == fs.THREAD_LIMITS
