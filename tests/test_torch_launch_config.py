"""The kernels' launch configuration (`fused_step.launch_config`: the form
of K1 / K3, the placement of the group form's working set and the size of
the launch), their schedule table and working-set layout, on the CPU for
every ported model: the configuration of every model that ran before the
group form took models past the thread form's maxima, pinned; the routing
of such models to the group form; and the device-memory placement of a
model whose one env and tables exceed a block's shared memory."""

import os

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
    """A scene whose one env and tables exceed a block's shared memory:
    here 4,200 candidate pairs, whose contact staging alone takes 151 KB.
    The shared placement cannot hold it, so the group form takes the
    device-memory placement (the tables still staged in shared memory),
    the engine accepts it on CUDA and the thread form refuses its
    pairs."""
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
    assert 4 * (fs.table_floats(m) + fs.env_floats(m)) > fs.SMEM_BLOCK_MAX
    assert fs.scope_errors(m) == []
    check_scope(m, cuda=True)
    check_scope(m, cuda=False)
    lc = fs.launch_config(m, 64)
    assert (lc["working_set"], lc["tables"]) == ("global", "shared"), lc
    assert lc["smem_bytes"] == 4 * fs.table_floats(m)
    assert (_covered(lc, 64) == 1).all()
    with pytest.raises(ValueError, match="contact pairs"):
        fs.launch_config(m, 64, design="thread")


# -- the configurations of every model that ran before the group form took
# models past the thread form's maxima: the same dict, key for key, and the
# same arithmetic. (model, envs, planes, overlay, fk) -> (design, envs per
# block, blocks, shared bytes, table bytes, env bytes, envs per SM) at the
# yamls' numEnvs, numEnvs + 37 (chip_smoke.py's checks) and 32768, the
# demos' 1 and 4 envs, ShadowHand_DR's 16384, phase 15's 1024 and the
# overlay checks; PINNED_GROUP: the group form forced where the thread form
# is picked. Read from the launch_config of the tree before the change
PINNED = {
    ('Humanoid', 4096, 0, 0, 0): ('group', 16, 132, 191872, 8064, 11488, 16),
    ('Humanoid', 4096, 0, 0, 1): ('group', 16, 132, 76416, 8064, 4272, 16),
    ('Humanoid', 4133, 0, 0, 0): ('group', 16, 132, 191872, 8064, 11488, 16),
    ('Humanoid', 4133, 0, 0, 1): ('group', 16, 132, 76416, 8064, 4272, 16),
    ('Humanoid', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Humanoid', 32768, 0, 0, 1): ('group', 16, 132, 76416, 8064, 4272, 16),
    ('Ant', 4096, 0, 0, 0): ('group', 16, 132, 88256, 3520, 5296, 16),
    ('Ant', 4096, 0, 0, 1): ('group', 16, 132, 31936, 3520, 1776, 16),
    ('Ant', 4133, 0, 0, 0): ('group', 16, 132, 88256, 3520, 5296, 16),
    ('Ant', 4133, 0, 0, 1): ('group', 16, 132, 31936, 3520, 1776, 16),
    ('Ant', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Ant', 32768, 0, 0, 1): ('group', 16, 132, 31936, 3520, 1776, 16),
    ('Cartpole', 512, 0, 0, 0): ('group', 4, 128, 7680, 1024, 1664, 16),
    ('Cartpole', 512, 0, 0, 1): ('group', 4, 128, 3328, 1024, 576, 16),
    ('Cartpole', 549, 0, 0, 0): ('group', 5, 110, 9344, 1024, 1664, 15),
    ('Cartpole', 549, 0, 0, 1): ('group', 5, 110, 3904, 1024, 576, 15),
    ('Cartpole', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Cartpole', 32768, 0, 0, 1): ('group', 16, 132, 10240, 1024, 576, 16),
    ('BallBalance', 4096, 0, 0, 0): ('group', 16, 132, 45568, 2304, 2704, 16),
    ('BallBalance', 4096, 0, 0, 1): ('group', 16, 132, 18432, 2304, 1008, 16),
    ('BallBalance', 4133, 0, 0, 0): ('group', 16, 132, 45568, 2304, 2704, 16),
    ('BallBalance', 4133, 0, 0, 1): ('group', 16, 132, 18432, 2304, 1008, 16),
    ('BallBalance', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('BallBalance', 32768, 0, 0, 1): ('group', 16, 132, 18432, 2304, 1008, 16),
    ('ShadowHand', 8192, 0, 0, 0): ('group', 13, 132, 194176, 14256, 13840, 13),
    ('ShadowHand', 8192, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHand', 8229, 0, 0, 0): ('group', 13, 132, 194176, 14256, 13840, 13),
    ('ShadowHand', 8229, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHand', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('ShadowHand', 32768, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('Anymal', 4096, 0, 0, 0): ('group', 16, 132, 121168, 4944, 7264, 16),
    ('Anymal', 4096, 0, 0, 1): ('group', 16, 132, 45648, 4944, 2544, 16),
    ('Anymal', 4133, 0, 0, 0): ('group', 16, 132, 121168, 4944, 7264, 16),
    ('Anymal', 4133, 0, 0, 1): ('group', 16, 132, 45648, 4944, 2544, 16),
    ('Anymal', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Anymal', 32768, 0, 0, 1): ('group', 16, 132, 45648, 4944, 2544, 16),
    ('AnymalTerrain', 2048, 1, 0, 0): ('group', 16, 128, 126464, 5120, 7584, 16),
    ('AnymalTerrain', 2048, 0, 0, 1): ('group', 16, 128, 45824, 5120, 2544, 16),
    ('AnymalTerrain', 2085, 1, 0, 0): ('group', 16, 131, 126464, 5120, 7584, 16),
    ('AnymalTerrain', 2085, 0, 0, 1): ('group', 16, 131, 45824, 5120, 2544, 16),
    ('AnymalTerrain', 32768, 1, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('AnymalTerrain', 32768, 0, 0, 1): ('group', 16, 132, 45824, 5120, 2544, 16),
    ('ShadowHandOpenAI_FF', 8192, 0, 1, 0): ('group', 13, 132, 203952, 14256, 14592, 13),
    ('ShadowHandOpenAI_FF', 8192, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHandOpenAI_FF', 8229, 0, 1, 0): ('group', 13, 132, 203952, 14256, 14592, 13),
    ('ShadowHandOpenAI_FF', 8229, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHandOpenAI_FF', 32768, 0, 1, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('ShadowHandOpenAI_FF', 32768, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHandOpenAI_LSTM', 8192, 0, 1, 0): ('group', 13, 132, 203952, 14256, 14592, 13),
    ('ShadowHandOpenAI_LSTM', 8192, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHandOpenAI_LSTM', 8229, 0, 1, 0): ('group', 13, 132, 203952, 14256, 14592, 13),
    ('ShadowHandOpenAI_LSTM', 8229, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('ShadowHandOpenAI_LSTM', 32768, 0, 1, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('ShadowHandOpenAI_LSTM', 32768, 0, 0, 1): ('group', 16, 132, 94896, 14256, 5040, 16),
    ('FrankaCabinet', 4096, 0, 0, 0): ('group', 16, 132, 199312, 12944, 11648, 16),
    ('FrankaCabinet', 4096, 0, 0, 1): ('group', 16, 132, 73872, 12944, 3808, 16),
    ('FrankaCabinet', 4133, 0, 0, 0): ('group', 16, 132, 199312, 12944, 11648, 16),
    ('FrankaCabinet', 4133, 0, 0, 1): ('group', 16, 132, 73872, 12944, 3808, 16),
    ('FrankaCabinet', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('FrankaCabinet', 32768, 0, 0, 1): ('group', 16, 132, 73872, 12944, 3808, 16),
    ('AllegroHand', 8192, 0, 0, 0): ('group', 16, 132, 166320, 10928, 9712, 16),
    ('AllegroHand', 8192, 0, 0, 1): ('group', 16, 132, 66992, 10928, 3504, 16),
    ('AllegroHand', 8229, 0, 0, 0): ('group', 16, 132, 166320, 10928, 9712, 16),
    ('AllegroHand', 8229, 0, 0, 1): ('group', 16, 132, 66992, 10928, 3504, 16),
    ('AllegroHand', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('AllegroHand', 32768, 0, 0, 1): ('group', 16, 132, 66992, 10928, 3504, 16),
    ('Ingenuity', 4096, 0, 0, 0): ('group', 16, 132, 31984, 1008, 1936, 16),
    ('Ingenuity', 4096, 0, 0, 1): ('group', 16, 132, 10992, 1008, 624, 16),
    ('Ingenuity', 4133, 0, 0, 0): ('group', 16, 132, 31984, 1008, 1936, 16),
    ('Ingenuity', 4133, 0, 0, 1): ('group', 16, 132, 10992, 1008, 624, 16),
    ('Ingenuity', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Ingenuity', 32768, 0, 0, 1): ('group', 16, 132, 10992, 1008, 624, 16),
    ('Quadcopter', 4096, 0, 0, 0): ('group', 16, 132, 87680, 2944, 5296, 16),
    ('Quadcopter', 4096, 0, 0, 1): ('group', 16, 132, 31360, 2944, 1776, 16),
    ('Quadcopter', 4133, 0, 0, 0): ('group', 16, 132, 87680, 2944, 5296, 16),
    ('Quadcopter', 4133, 0, 0, 1): ('group', 16, 132, 31360, 2944, 1776, 16),
    ('Quadcopter', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Quadcopter', 32768, 0, 0, 1): ('group', 16, 132, 31360, 2944, 1776, 16),
    ('Crazyflie', 4096, 0, 0, 0): ('group', 16, 132, 54896, 1648, 3328, 16),
    ('Crazyflie', 4096, 0, 0, 1): ('group', 16, 132, 17776, 1648, 1008, 16),
    ('Crazyflie', 4133, 0, 0, 0): ('group', 16, 132, 54896, 1648, 3328, 16),
    ('Crazyflie', 4133, 0, 0, 1): ('group', 16, 132, 17776, 1648, 1008, 16),
    ('Crazyflie', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Crazyflie', 32768, 0, 0, 1): ('group', 16, 132, 17776, 1648, 1008, 16),
    ('Custom/fixed', 512, 0, 0, 0): ('group', 4, 128, 8384, 1728, 1664, 16),
    ('Custom/fixed', 512, 0, 0, 1): ('group', 4, 128, 4032, 1728, 576, 16),
    ('Custom/fixed', 549, 0, 0, 0): ('group', 5, 110, 10048, 1728, 1664, 15),
    ('Custom/fixed', 549, 0, 0, 1): ('group', 5, 110, 4608, 1728, 576, 15),
    ('Custom/fixed', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Custom/fixed', 32768, 0, 0, 1): ('group', 16, 132, 10944, 1728, 576, 16),
    ('Custom/floating', 512, 0, 0, 0): ('group', 4, 128, 8704, 1728, 1744, 16),
    ('Custom/floating', 512, 0, 0, 1): ('group', 4, 128, 4224, 1728, 624, 16),
    ('Custom/floating', 549, 0, 0, 0): ('group', 5, 110, 10448, 1728, 1744, 15),
    ('Custom/floating', 549, 0, 0, 1): ('group', 5, 110, 4848, 1728, 624, 15),
    ('Custom/floating', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Custom/floating', 32768, 0, 0, 1): ('group', 16, 132, 11712, 1728, 624, 16),
    ('Custom/mjcf', 512, 0, 0, 0): ('group', 4, 128, 13152, 2592, 2640, 16),
    ('Custom/mjcf', 512, 0, 0, 1): ('group', 4, 128, 6432, 2592, 960, 16),
    ('Custom/mjcf', 549, 0, 0, 0): ('group', 5, 110, 15792, 2592, 2640, 15),
    ('Custom/mjcf', 549, 0, 0, 1): ('group', 5, 110, 7392, 2592, 960, 15),
    ('Custom/mjcf', 32768, 0, 0, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('Custom/mjcf', 32768, 0, 0, 1): ('group', 16, 132, 17952, 2592, 960, 16),
    ('PairScene', 4096, 0, 1, 0): ('group', 16, 132, 112112, 7664, 6528, 16),
    ('PairScene', 4096, 0, 0, 1): ('group', 16, 132, 23792, 7664, 1008, 16),
    ('PairScene', 4133, 0, 1, 0): ('group', 16, 132, 112112, 7664, 6528, 16),
    ('PairScene', 4133, 0, 0, 1): ('group', 16, 132, 23792, 7664, 1008, 16),
    ('PairScene', 32768, 0, 1, 0): ('thread', 128, 256, 0, 0, 0, None),
    ('PairScene', 32768, 0, 0, 1): ('group', 16, 132, 23792, 7664, 1008, 16),
    ('Anymal', 1, 0, 0, 0): ('group', 1, 1, 12208, 4944, 7264, 16),
    ('Anymal', 1, 0, 0, 1): ('group', 1, 1, 7488, 4944, 2544, 16),
    ('AnymalTerrain', 1, 1, 0, 0): ('group', 1, 1, 12704, 5120, 7584, 16),
    ('AnymalTerrain', 4, 1, 0, 0): ('group', 1, 4, 12704, 5120, 7584, 16),
    ('AnymalTerrain', 1, 0, 0, 1): ('group', 1, 1, 7664, 5120, 2544, 16),
    ('AnymalTerrain', 4, 0, 0, 1): ('group', 1, 4, 7664, 5120, 2544, 16),
    ('ShadowHand', 16384, 0, 1, 0): ('thread', 128, 128, 0, 0, 0, None),
    ('ShadowHand', 1024, 0, 0, 0): ('group', 8, 128, 124976, 14256, 13840, 8),
    ('AnymalTerrain', 2048, 1, 1, 0): ('group', 16, 128, 132352, 5120, 7952, 16),
    ('BallBalance', 4096, 0, 1, 0): ('group', 16, 132, 47360, 2304, 2816, 16),
}
PINNED_GROUP = {
    ('Humanoid', 32768, 0, 0, 0): ('group', 16, 132, 191872, 8064, 11488, 16),
    ('Ant', 32768, 0, 0, 0): ('group', 16, 132, 88256, 3520, 5296, 16),
    ('Cartpole', 32768, 0, 0, 0): ('group', 16, 132, 27648, 1024, 1664, 16),
    ('BallBalance', 32768, 0, 0, 0): ('group', 16, 132, 45568, 2304, 2704, 16),
    ('ShadowHand', 32768, 0, 0, 0): ('group', 15, 132, 221856, 14256, 13840, 15),
    ('Anymal', 32768, 0, 0, 0): ('group', 16, 132, 121168, 4944, 7264, 16),
    ('AnymalTerrain', 32768, 1, 0, 0): ('group', 16, 132, 126464, 5120, 7584, 16),
    ('ShadowHandOpenAI_FF', 32768, 0, 1, 0): ('group', 14, 132, 218544, 14256, 14592, 14),
    ('ShadowHandOpenAI_LSTM', 32768, 0, 1, 0): ('group', 14, 132, 218544, 14256, 14592, 14),
    ('FrankaCabinet', 32768, 0, 0, 0): ('group', 16, 132, 199312, 12944, 11648, 16),
    ('AllegroHand', 32768, 0, 0, 0): ('group', 16, 132, 166320, 10928, 9712, 16),
    ('Ingenuity', 32768, 0, 0, 0): ('group', 16, 132, 31984, 1008, 1936, 16),
    ('Quadcopter', 32768, 0, 0, 0): ('group', 16, 132, 87680, 2944, 5296, 16),
    ('Crazyflie', 32768, 0, 0, 0): ('group', 16, 132, 54896, 1648, 3328, 16),
    ('Custom/fixed', 32768, 0, 0, 0): ('group', 16, 132, 28352, 1728, 1664, 16),
    ('Custom/floating', 32768, 0, 0, 0): ('group', 16, 132, 29632, 1728, 1744, 16),
    ('Custom/mjcf', 32768, 0, 0, 0): ('group', 16, 132, 44832, 2592, 2640, 16),
    ('PairScene', 32768, 0, 1, 0): ('group', 16, 132, 112112, 7664, 6528, 16),
    ('ShadowHand', 16384, 0, 1, 0): ('group', 14, 132, 218544, 14256, 14592, 14),
}


REGISTRY = ("Humanoid", "Ant", "Cartpole", "BallBalance", "ShadowHand", "Anymal",
            "AnymalTerrain", "ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM",
            "FrankaCabinet", "AllegroHand", "Ingenuity", "Quadcopter", "Crazyflie")


def _pinned_model(name, tmp):
    """The model of a registry task under its yaml (AnymalTerrain on a
    small grid: the model does not depend on it), of Custom on phase 11's
    robots, or the pair scene."""
    from omniisaacgymenvs_torch.utils.config import load_config, parse_cli

    if name == "PairScene":
        return parity.build_pair_scene()
    if name.startswith("Custom"):
        import sys
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, root)
        from chip_smoke import MJCF_CHAIN, URDF_EXAMPLE

        chain = os.path.join(tmp, "chain.xml")
        with open(chain, "w") as f:
            f.write(MJCF_CHAIN)
        urdf = os.path.join(root, URDF_EXAMPLE)
        extra = {"Custom/fixed": [f"task.env.robot={urdf}"],
                 "Custom/floating": [f"task.env.robot={urdf}",
                                     "task.env.floatingBase=True"],
                 "Custom/mjcf": [f"task.env.robot={chain}"]}[name]
        cfg = load_config({"task": "Custom", **parse_cli(extra)})["task"]
        return get_task("Custom", cfg, device="cpu").model
    cfg = load_config({"task": name})["task"]
    if name == "AnymalTerrain":
        cfg = {**cfg, "env": {**cfg["env"], "terrain": {
            **cfg["env"]["terrain"], "numLevels": 3, "numTerrains": 5}}}
    return get_task(name, cfg, device="cpu").model


def _pinned_tuple(lc):
    return (lc["design"], lc["envs_per_block"], lc["blocks"], lc["smem_bytes"],
            lc["table_bytes"], lc["env_bytes"], lc["resident"])


@pytest.mark.parametrize("name", REGISTRY + ("Custom/fixed", "Custom/floating",
                                             "Custom/mjcf", "PairScene"))
def test_launch_config_pins_the_dicts_of_the_models_that_ran(name, tmp_path):
    m = _pinned_model(name, str(tmp_path))
    cases = [c for c in PINNED if c[0] == name]
    assert len(cases) >= 6
    off = fs.table_offsets(m)
    for case in cases:
        _, n, planes, overlay, fk = case
        lc = fs.launch_config(m, n, bool(planes), bool(overlay), bool(fk))
        assert _pinned_tuple(lc) == PINNED[case], case
        group = lc["design"] == "group"
        # the rest of the dict as it was, and the placement it names
        assert set(lc) == {"design", "n_sm", "n_env", "nf", "ni", "group",
                           "envs_per_block", "blocks", "threads", "smem_bytes",
                           "table_bytes", "env_bytes", "env_floats", "resident",
                           "working_set"}, case
        assert lc["working_set"] == ("shared" if group else "local")
        assert (lc["n_sm"], lc["n_env"], lc["nf"]) == (fs.N_SM_H100, n, off["f_end"])
        assert lc["group"] == (fs.GROUP if group else 1)
        assert lc["threads"] == lc["group"] * lc["envs_per_block"]
        assert lc["env_floats"] == lc["env_bytes"] // 4
        if case in PINNED_GROUP:
            forced = fs.launch_config(m, n, bool(planes), bool(overlay), design="group")
            assert _pinned_tuple(forced) == PINNED_GROUP[case], case


def _chain(n_bodies):
    """A FREE base, two joint bodies and a chain of n_bodies - 3 more
    (tests/test_torch_scenes.py one_feature_scene)."""
    from test_torch_scenes import one_feature_scene

    return one_feature_scene("plain", n_chain=n_bodies - 3)


def _past_thread_maxima(name):
    from omniisaacgymenvs_torch.models import build_franka_cabinet

    if name.startswith("FrankaCabinet"):
        return build_franka_cabinet(int(name.split("/")[1]))[0]
    if name == "chain35":
        return _chain(fs.NB_MAX + 3)
    return parity.build_wide_tree()


@pytest.mark.parametrize("name", ["FrankaCabinet/9", "FrankaCabinet/16",
                                  "FrankaCabinet/64", "chain35", "WideTree"])
def test_launch_config_routes_models_past_the_thread_maxima(name):
    """A model past the thread form's maxima takes the group form at every
    width, K1 and K2 alike, and `design="thread"` raises naming the
    maximum; the group form's scope holds it."""
    m = _past_thread_maxima(name)
    errs = fs.thread_scope_errors(m)
    assert errs and fs.scope_errors(m) == []
    with pytest.raises(ValueError, match="thread form maximum"):
        fs.launch_config(m, 4096, design="thread")
    for n in (1, 37, 4096, fs.THREAD_ENVS_PER_SM * fs.N_SM_H100, 10 ** 6):
        for fk in (False, True):
            lc = fs.launch_config(m, n, fk=fk)
            assert lc["design"] == "group" and lc["group"] == fs.GROUP
            assert (_covered(lc, n) == 1).all() if n < 10 ** 5 else True
    # FrankaCabinet's 16 props at the yaml's 4096 envs: 7 envs an SM
    if name == "FrankaCabinet/16":
        lc = fs.launch_config(m, 4096)
        assert (lc["working_set"], lc["envs_per_block"], lc["resident"],
                lc["smem_bytes"]) == ("shared", 7, 7, 228112), lc


def test_launch_config_takes_device_memory_only_past_shared_memory():
    """The placement switch: a FREE chain of 274 bodies still fits one env
    and the tables in a block in its largest variant (planes and an
    overlay: 231,824 B of 232,448), so every variant stays in shared
    memory; one of 275 bodies does not, and K1 / K3 take the device-memory
    placement with their tables in shared memory, as do those of 301
    (254,608 B); the wide tree of 751 bodies takes it for K2 too, its
    tables in device memory. Each launch covers every env once with at
    most what the SMs hold, and the scratch holds one working set per
    group."""
    fits, edge, over = _chain(274), _chain(275), _chain(301)
    need = {m.nb: 4 * (fs.table_floats(m) + fs.env_floats(m, True, True))
            for m in (fits, edge, over)}
    assert need == {274: 231824, 275: 232656, 301: 254608}, need
    for planes, overlay, fk in ((False, False, False), (True, True, False),
                                (False, False, True)):
        assert fs.launch_config(fits, 4096, planes, overlay, fk)["working_set"] == "shared"
    assert fs.launch_config(edge, 4096, True, True)["working_set"] == "global"
    big = parity.build_wide_tree(375)
    for m, fk, tables in ((over, False, "shared"), (over, True, None),
                          (big, False, "global"), (big, True, "global")):
        for n in (1, 549, 4096):
            lc = fs.launch_config(m, n, fk=fk)
            if tables is None:  # the chain's K2 fits in shared memory
                assert lc["working_set"] == "shared"
                continue
            assert (lc["working_set"], lc["tables"]) == ("global", tables), lc
            assert lc["smem_bytes"] == (4 * fs.table_floats(m) if tables == "shared" else 0)
            assert lc["smem_bytes"] <= fs.SMEM_BLOCK_MAX
            assert lc["scratch_floats"] == (lc["blocks"] * lc["envs_per_block"]
                                            * fs.env_floats(m, fk=fk))
            assert lc["blocks"] * lc["envs_per_block"] <= lc["n_sm"] * lc["resident"]
            assert (_covered(lc, n) == 1).all()
            assert "device memory" in fs.describe_config(lc)
