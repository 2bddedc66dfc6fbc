"""The kernels' launch configuration (`fused_step.launch_config`: the form
of K1 / K3 and the size of the launch), their schedule table and
working-set layout, and the shared-memory budget of `scope_errors`, on the
CPU for every ported model."""

import numpy as np
import pytest

from omniisaacgymenvs_torch.models import (build_ant, build_balance_bot,
                                           build_cartpole, build_humanoid,
                                           build_shadow_hand)
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics.engine import check_scope
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder
from omniisaacgymenvs_torch.tasks import get_task


def _model(name):
    if name in ("Anymal", "AnymalTerrain"):
        return get_task(name, device="cpu").model
    return {"Humanoid": build_humanoid, "Ant": build_ant,
            "Cartpole": build_cartpole, "BallBalance": build_balance_bot,
            "ShadowHand": build_shadow_hand,
            "PairScene": parity.build_pair_scene}[name]()


# (model, env count of its main path or checks, planes, overlay)
CASES = [("Humanoid", 32768, False, False), ("Ant", 4096, False, False),
         ("Cartpole", 512, False, False), ("BallBalance", 4096, False, True),
         ("ShadowHand", 8192, False, False), ("ShadowHand", 8192, False, True),
         ("PairScene", 4096, False, True), ("Anymal", 4096, False, False),
         ("AnymalTerrain", 2048, True, False), ("AnymalTerrain", 2048, True, True)]


def _covered(lc, n):
    """How often the launch visits each env: in the group form's
    persistent grid a block's groups take envs e0 + g for e0 = block *
    envs_per_block, stepping by all groups; in the thread form block b's
    threads take envs b * envs_per_block + t, once."""
    epb, stride = lc["envs_per_block"], lc["blocks"] * lc["envs_per_block"]
    seen = np.zeros(n, np.int64)
    for b in range(lc["blocks"]):
        for e0 in range(b * epb, n, stride):
            e = np.arange(e0, min(e0 + epb, n))
            seen[e] += 1
    return seen


@pytest.mark.parametrize("name, n, planes, overlay", CASES)
@pytest.mark.parametrize("design", fs.DESIGNS)
def test_launch_config_fits_the_card_and_covers_every_env(name, n, planes,
                                                          overlay, design):
    m = _model(name)
    assert fs.scope_errors(m) == []
    for fk in (False, True) if design == "group" else (False,):
        for width in (n, n + parity_pad(), 37):
            lc = fs.launch_config(m, width, planes, overlay, fk, design)
            assert lc["design"] == design and lc["envs_per_block"] >= 1
            if design == "thread":
                assert lc["threads"] == lc["envs_per_block"] == fs.THREAD_BLOCK
                assert lc["smem_bytes"] == 0
                assert (lc["blocks"] - 1) * fs.THREAD_BLOCK < width
                assert lc["blocks"] * fs.THREAD_BLOCK >= width
                continue
            assert lc["group"] == fs.GROUP
            assert lc["threads"] == fs.GROUP * lc["envs_per_block"] <= fs.MAX_THREADS
            # the footprint fits with the tables
            assert lc["smem_bytes"] == lc["table_bytes"] + lc["envs_per_block"] * lc["env_bytes"]
            assert lc["smem_bytes"] <= fs.SMEM_BLOCK_MAX
            assert lc["env_bytes"] == 4 * fs.env_floats(m, planes, overlay, fk)
            assert lc["resident"] >= lc["envs_per_block"]
            # a persistent grid: no more blocks than the SMs hold at once
            assert lc["blocks"] * lc["envs_per_block"] <= lc["n_sm"] * lc["resident"]
            # the ragged tail too: every env exactly once
            assert (_covered(lc, width) == 1).all()


def parity_pad():
    return 37  # chip_smoke.py's checks: not a multiple of any block


def test_launch_config_spreads_small_batches_over_every_sm():
    m = _model("AnymalTerrain")
    lc = fs.launch_config(m, 2048, planes=True)
    assert lc["design"] == "group" and lc["blocks"] >= lc["n_sm"] - 4
    lc = fs.launch_config(m, 37, planes=True, n_sm=132)
    assert lc["blocks"] == 37 and lc["envs_per_block"] == 1
    with pytest.raises(ValueError, match="design"):
        fs.launch_config(m, 64, design="warp")
    with pytest.raises(ValueError, match="K2"):
        fs.launch_config(m, 64, fk=True, design="thread")


@pytest.mark.parametrize("name, n, planes, overlay, form", [
    ("Humanoid", 32768, False, False, "thread"),
    ("Humanoid", 8192, False, False, "group"),
    ("ShadowHand", 8192, False, False, "group"),
    ("ShadowHand", 16384, False, True, "thread"),
    ("ShadowHand", 8192, False, True, "group"),
    ("AnymalTerrain", 2048, True, False, "group"),
    ("AnymalTerrain", 32768, True, False, "thread")])
def test_launch_config_picks_the_form_by_envs_per_sm(name, n, planes, overlay,
                                                     form):
    """K1 / K3 take one thread per env once every SM gets
    THREAD_ENVS_PER_SM envs, the group form below; K2 the group form at
    any width; the rule reads the card's SMs."""
    m = _model(name)
    assert fs.launch_config(m, n, planes, overlay)["design"] == form
    assert fs.launch_config(m, n, planes, overlay, fk=True)["design"] == "group"
    edge = fs.THREAD_ENVS_PER_SM * 66
    assert fs.launch_config(m, edge, planes, overlay, n_sm=66)["design"] == "thread"
    assert fs.launch_config(m, edge - 1, planes, overlay, n_sm=66)["design"] == "group"


@pytest.mark.parametrize("name", ["Humanoid", "ShadowHand", "PairScene",
                                  "AnymalTerrain"])
def test_schedule_table_describes_the_tree_and_the_contacts(name):
    m = _model(name)
    full = fs.pack_schedule(m)
    nh = len(fs.SCHEDULE_HEADER)
    # the header, and the sections at its offsets from the header's end
    h, sched = dict(zip(fs.SCHEDULE_HEADER, full[:nh].tolist())), full[nh:]
    assert h["i_model"] == len(sched)
    lev = sched[h["lev"]:h["lev"] + h["nlev"] + 1]
    lbody = sched[h["lbody"]:h["lbody"] + m.nb]
    assert sorted(lbody.tolist()) == list(range(m.nb)) and lev[-1] == m.nb
    depth = np.zeros(m.nb, np.int64)
    for L in range(h["nlev"]):
        depth[lbody[lev[L]:lev[L + 1]]] = L
    for i in range(m.nb):
        p = int(m.parents[i])
        assert depth[i] == (0 if p < 0 else depth[p] + 1)
    ch = sched[h["ch"]:h["ch"] + m.nb + 1]
    kids = sched[h["chl"]:h["chl"] + ch[-1]]
    for i in range(m.nb):
        got = kids[ch[i]:ch[i + 1]].tolist()
        assert got == sorted([j for j in range(m.nb) if m.parents[j] == i],
                             reverse=True)
    cc = sched[h["cc"]:h["cc"] + m.nb + 1]
    assert cc[-1] == m.ncp + 2 * len(m.pair_surf)
    # the working set: increasing offsets, the contact staging inside the
    # articulated-body arrays it overlays
    lay = fs.env_layout(m, planes=True, overlay=True)
    offs = [lay[k] for k in lay]
    assert offs == sorted(offs)
    assert lay["tmp"] - lay["IA"] >= 6 * m.ncp + 9 * len(m.pair_surf)
    assert h["L_tmp"] == lay["tmp"] and h["L_planes"] == lay["planes"]
    # the float table's shared-memory copy: one float more per record
    st = fs.staged_offsets(m)
    assert st["f_end"] - fs.table_offsets(m)["f_end"] == (
        2 * m.nb + m.ncp + len(m.pair_surf) + len(m.surf_type) + m.nt)


def test_scope_refuses_a_model_past_the_shared_memory_budget():
    """A scene whose one env and tables exceed a block's shared memory is
    refused on CUDA (and steps on the CPU): here 4,200 candidate pairs,
    whose contact staging alone takes 151 KB."""
    b = ModelBuilder("crowd")
    root = b.add_body("base", parent=-1, joint_type=JointType.FREE)
    b.add_body("arm", parent=root)
    for _ in range(30):
        b.add_sphere_collider(root, (0, 0, 0), 0.1, receive=True)
    ball = b.add_body("ball", parent=-1, joint_type=JointType.FREE)
    for _ in range(140):
        b.add_sphere_collider(ball, (0, 0, 0), 0.05)
    m = b.finalize()
    assert len(m.pair_surf) > 4000
    errs = fs.scope_errors(m)
    assert any("shared memory" in e for e in errs), errs
    with pytest.raises(NotImplementedError, match="shared memory"):
        check_scope(m, cuda=True)
    check_scope(m, cuda=False)
    with pytest.raises(ValueError, match="exceed"):
        fs.launch_config(m, 64)
