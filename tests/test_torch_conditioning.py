"""The conditioning test of the overlay checks (`parity.well_conditioned`)
on a constructed chattering env: one whose result does not move when every
coordinate grows by the same share of its size but jumps when two of them
part, as a light cube in stick-slip contact does. The one direction the test
took before keeps such an env; the six directions of `parity.COND_DIRECTIONS`
leave it out (where one of the four random sign patterns parts the two
coordinates: each does so with probability 1/2), and the cap of 1% left out
still holds. `parity.check_keep` applies the test to the AllegroHand's
unrandomized checks (a cap of 2%), and judges every env of other models."""

import torch

import pytest

from omniisaacgymenvs_torch.ops import parity

N = 200
NAMES = ("q", "qd")
TOL = {k: parity.STEP_TOL[k] for k in NAMES}


def _states(chattering):
    g = torch.Generator().manual_seed(0)
    q = torch.rand((N, 4), generator=g) + 0.5
    qd = torch.randn((N, 3), generator=g)
    # a chattering env starts with two coordinates equal: every change by the
    # same share of their size leaves their difference at zero
    q[chattering, 1] = q[chattering, 0]
    return q, qd


def _chattering_plain(chattering):
    """A plain step that amplifies the difference of q's first two
    coordinates by 1e8 in the chattering envs (the contact switching there),
    and is smooth elsewhere."""
    mask = torch.zeros(N, dtype=torch.bool)
    mask[chattering] = True

    def run(q_, qd_):
        jump = 1e8 * (q_[:, 0] - q_[:, 1]) * mask
        return q_ * 1.5, qd_ + jump[:, None]
    return run


def test_random_sign_directions_catch_a_chattering_env():
    q, qd = _states([7])
    run = _chattering_plain([7])
    ref = run(q, qd)
    # the one direction taken before (every coordinate up) sees nothing
    plus = run(parity.cond_nudge(q, "+"), parity.cond_nudge(qd, "+"))
    assert parity.env_tolerance_use(plus[1], ref[1], *TOL["qd"])[7] < 0.01
    keep = parity.well_conditioned(run, q, qd, ref, NAMES, TOL)
    assert keep.tolist() == [i != 7 for i in range(N)]
    # a kernel result that parts from the plain one in the chattering env
    # alone is judged on the others
    out = (ref[0].clone(), ref[1].clone())
    out[1][7] += 1.0
    assert parity.compare(out, ref, NAMES, TOL)["qd"][1] > 1.0
    assert parity.compare(out, ref, NAMES, TOL, keep)["qd"][1] == 0.0


def test_nudges_are_two_ulps_and_fixed():
    x = torch.tensor([[0.5, -3.0, 1e-3, 0.0]])
    for d in parity.COND_DIRECTIONS:
        dx = parity.cond_nudge(x, d) - x
        # 2^-22 of the size, as float32 rounds it
        torch.testing.assert_close(dx.abs(), parity.COND_EPS * x.clamp(-1, 1).abs(),
                                   rtol=0.5, atol=0.0)
        assert torch.equal(parity.cond_nudge(x, d), parity.cond_nudge(x, d))
    signs = {d: tuple(torch.sign(parity.cond_nudge(x, d) - x)[0, :3].tolist())
             for d in parity.COND_DIRECTIONS}
    assert signs["+"] == (1.0, -1.0, 1.0) and signs["-"] == (-1.0, 1.0, -1.0)
    assert len(set(signs.values())) > 2


def test_cap_of_one_percent_still_holds():
    chattering = [3, 7, 120]           # 1.5% of the envs
    q, qd = _states(chattering)
    run = _chattering_plain(chattering)
    ref = run(q, qd)
    with pytest.raises(AssertionError, match="ill conditioned"):
        parity.well_conditioned(run, q, qd, ref, NAMES, TOL)
    keep = parity.well_conditioned(run, q, qd, ref, NAMES, TOL, max_excluded=1.0)
    assert (~keep).nonzero().flatten().tolist() == chattering


def test_check_keep_by_model():
    """A model outside COND_MAX_EXCLUDED_BY_MODEL: every env is judged. The
    AllegroHand's checks take its own 2% cap; FrankaCabinet with 16 props
    (31 bodies) the overlay checks' 1%, with four (19 bodies) none."""
    from types import SimpleNamespace

    chattering = [3, 7, 120]           # 1.5% of the envs
    q, qd = _states(chattering)
    run = _chattering_plain(chattering)
    ref = run(q, qd)
    hand = SimpleNamespace(name="ShadowHand")
    allegro = SimpleNamespace(name="AllegroHand")
    assert parity.check_keep(hand, run, q, qd, ref, NAMES, TOL) is None
    keep = parity.check_keep(allegro, run, q, qd, ref, NAMES, TOL)
    assert (~keep).nonzero().flatten().tolist() == chattering
    assert parity.COND_MAX_EXCLUDED_BY_MODEL["AllegroHand"] == 0.02
    franka4 = SimpleNamespace(name="FrankaCabinet", nb=19)
    franka16 = SimpleNamespace(name="FrankaCabinet", nb=31)
    assert parity.check_keep(franka4, run, q, qd, ref, NAMES, TOL) is None
    with pytest.raises(AssertionError, match="ill conditioned"):
        parity.check_keep(franka16, run, q, qd, ref, NAMES, TOL)
    more = list(range(0, 10))        # 5%: over the AllegroHand's cap too
    q, qd = _states(more)
    run = _chattering_plain(more)
    with pytest.raises(AssertionError, match="ill conditioned"):
        parity.check_keep(allegro, run, q, qd, run(q, qd), NAMES, TOL)


def test_conditioning_probe_dry_run_on_cpu(tmp_path, capsys):
    """tools/conditioning_probe.py at a tiny size with device=cpu (the
    plain version on both sides, so every gap reads 0): the criteria lines
    and the summary file."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "conditioning_probe.py"
    spec = importlib.util.spec_from_file_location("conditioning_probe", path)
    conditioning_probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conditioning_probe)

    out = tmp_path / "probe.json"
    assert conditioning_probe.main(["device=cpu", "num_envs=12", "seeds=1",
                                    "top=1", f"out={out}"]) == 0
    text = capsys.readouterr().out
    assert "criterion all six (well_conditioned)" in text
    summary = json.loads(out.read_text())
    rows = summary["seeds"]["1"]["criteria"]
    assert rows["all six (well_conditioned)"]["worst_gap"] == 0.0
    assert (rows["all six (well_conditioned)"]["left_out"]
            >= rows["+ (current)"]["left_out"])
    assert len(summary["seeds"]["1"]["growth"]) == 12


def test_conditioning_probe_dry_run_without_overlay(tmp_path, capsys):
    """The probe on a task that does not randomize (the AllegroHand): no
    overlay on either side."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "conditioning_probe.py"
    spec = importlib.util.spec_from_file_location("conditioning_probe", path)
    conditioning_probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conditioning_probe)

    out = tmp_path / "probe.json"
    assert conditioning_probe.main(["task=AllegroHand", "device=cpu", "num_envs=8",
                                    "seeds=0", "top=1", f"out={out}"]) == 0
    assert "cube:" not in capsys.readouterr().out
    summary = json.loads(out.read_text())
    assert summary["seeds"]["0"]["top"][0]["overlay"] == {}
    assert len(summary["seeds"]["0"]["growth"]) == 16
