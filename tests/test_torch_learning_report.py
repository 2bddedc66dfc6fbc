"""tests/torch_learning_report.py: the curves at given epochs, their
ratios and the side-by-side windows; the CLI, its summary named after the
history's directory."""

import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import torch_learning_report as learning_report  # noqa: E402


def _hist(n, scale=1.0, hand=True):
    rows = []
    for e in range(n):
        r = dict(epoch=e, env_steps=(e + 1) * 1000, steps_per_sec=1000.0 + e,
                 mean_ep_reward=scale * (e + math.sin(e)), mean_ep_length=10.0 + e % 7,
                 lr=1e-3 / (1 + e), kl=0.01 + 0.001 * (e % 3))
        if hand:
            r["Episode/consecutive_successes"] = 0.01 * e
            r["Episode/successes"] = 0.005 * e
        rows.append(r)
    return rows


def test_report_at_epochs_ratios_and_windows():
    port, a, b = _hist(1000), _hist(1000, 2.0), _hist(500, 0.5)
    out = learning_report.report(port, dict(a=a, b=b), row=dict(final_ep_reward=100.0),
                                 at=(99, 999), window=100, every=500)
    assert out["ratio_to_row"] == dict(final_ep_reward=round(
        out["port"]["final_ep_reward"] / 100.0, 3))
    at = out["at"]["999"]
    assert at["port"] == port[999]["mean_ep_reward"] and at["b"] is None
    assert at["ratio_a"] == 0.5 and at["ratio_b"] is None
    assert out["at"]["99"]["ratio_b"] == 2.0
    assert [w["epochs"] for w in out["windows"]] == ["0-99", "500-599"]
    w = out["windows"][1]
    assert w["b.lr"] is None and w["a.kl"] == pytest.approx(
        sum(r["kl"] for r in a[500:600]) / 100, rel=1e-5)


def test_cli_prints_one_json_object(tmp_path, capsys):
    (tmp_path / "p.json").write_text(json.dumps(_hist(120)))
    (tmp_path / "r.json").write_text(json.dumps(_hist(120, 2.0)))
    (tmp_path / "L.json").write_text(json.dumps(dict(T=dict(final_ep_reward=50.0))))
    assert learning_report.main([str(tmp_path / "p.json"), f"ref={tmp_path / 'r.json'}",
                                 f"row={tmp_path / 'L.json'}:T", "at=99", "every=50",
                                 "window=50"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["at"]["99"]["ratio_ref"] == 0.5
    assert out["port"]["task"] == tmp_path.name and out["port"]["epochs"] == 120
    assert len(out["windows"]) == 3 and out["row"] == dict(final_ep_reward=50.0)
    assert learning_report.main([]) == 2


def test_windows_from_a_start_and_a_late_history():
    """A history resumed at epoch 300 lines up with a reference by epoch;
    the windows start at `start` and hold the `keys` asked for."""
    ref, late = _hist(600), _hist(600, 3.0)[300:]
    out = learning_report.report(late, dict(ref=ref), at=(299, 399), window=50,
                                 every=100, start=350,
                                 keys=("mean_ep_reward", "Episode/consecutive_successes"))
    assert out["at"]["299"]["port"] is None
    assert out["at"]["399"]["ratio_ref"] == 3.0
    assert [w["epochs"] for w in out["windows"]] == ["350-399", "450-499", "550-599"]
    w = out["windows"][0]
    assert sorted(w) == sorted(["epochs", "port.mean_ep_reward", "ref.mean_ep_reward",
                                "port.Episode/consecutive_successes",
                                "ref.Episode/consecutive_successes"])
    assert w["ref.Episode/consecutive_successes"] == pytest.approx(
        sum(r["Episode/consecutive_successes"] for r in ref[350:400]) / 50, rel=1e-5)


def test_matched_reward_bins():
    """Each run's epochs from MATCH_START on, binned by reward; a bin of
    fewer than MATCH_MIN_EPOCHS epochs is None; the CLI's `bins=`."""
    h = _hist(400)
    out = learning_report.matched(dict(a=h), bins=(150, 250, 390, 1000))
    rows = [r for r in h if r["epoch"] >= 200 and 150 <= r["mean_ep_reward"] < 250]
    cell = out["a"]["150-250"]
    assert cell["epochs"] == len(rows) >= 20
    assert cell["mean_ep_length"] == pytest.approx(
        sum(r["mean_ep_length"] for r in rows) / len(rows), rel=1e-5)
    assert "episodes" not in cell   # not a key of these rows
    assert out["a"]["390-1000"] is None   # ten epochs
    rep = learning_report.report(h, dict(b=h), at=(), bins=(150, 250))
    assert rep["matched"]["port"] == rep["matched"]["b"] == {"150-250": cell}


def test_allegrohand_f32_drops_the_cube_at_matched_reward():
    """Fault C4's evidence in the tracked histories: at the same reward
    (bins of 1000-1700 after epoch 200), the f32 AllegroHand run at seed
    42 (results_torch/AllegroHand_f32) ends its episodes 25 or more steps
    sooner than either JAX seed's; AllegroHand's yaml has no fall penalty and no success limit, so
    an episode shorter than 600 steps ended in a fall."""
    hist = {name: json.loads((ROOT / path).read_text()) for name, path in (
        ("f32", "results_torch/AllegroHand_f32/history.json"),
        ("jax123", "results/AllegroHand/history.json"),
        ("jax42", "results/AllegroHand_seed42/history.json"))}
    out = learning_report.matched(hist, bins=(800, 1000, 1200, 1400, 1700))
    for b in ("1000-1200", "1200-1400", "1400-1700"):
        f32 = out["f32"][b]["mean_ep_length"]
        for jax_run in ("jax123", "jax42"):
            assert out[jax_run][b]["mean_ep_length"] - f32 >= 25, (b, jax_run, out)
    # and it reaches goals faster at that reward
    assert (out["f32"]["1400-1700"]["Episode/consecutive_successes"]
            > out["jax123"]["1400-1700"]["Episode/consecutive_successes"])


def _sigma_hist(n, n_actions, log_sigma):
    """A history whose every epoch's entropy is that of `n_actions` dims
    at log sigma log_sigma(epoch) (epoch 0 at sigma 1)."""
    c = learning_report.ENTROPY_C
    rows = _hist(n, hand=False)
    for r in rows:
        r["entropy"] = n_actions * (c + (log_sigma(r["epoch"]) if r["epoch"] else 0.0))
    return rows


def test_log_sigma_reads_entropy_per_action_dim():
    hist = _sigma_hist(300, 9, lambda e: -e / 300.0)
    assert learning_report.n_actions(hist) == 9
    assert learning_report.log_sigma(hist, 150, 75) == pytest.approx(-187.0 / 300.0)
    assert learning_report.log_sigma(hist, 250, 75) is None
    assert learning_report.n_actions(hist[1:]) is None
    assert learning_report.log_sigma(hist[1:], 150, 75) is None


def test_report_sigma_windows_and_gaps():
    port = _sigma_hist(300, 4, lambda e: -e / 300.0)
    ref = _sigma_hist(300, 4, lambda e: -2.0 * e / 300.0)
    out = learning_report.report(port, dict(jax=ref), at=(), window=75, every=75,
                                 start=150, keys=("sigma", "kl"))
    assert [w["epochs"] for w in out["windows"]] == ["150-224", "225-299"]
    w = out["windows"][0]
    assert w["port.sigma"] == pytest.approx(-187.0 / 300.0, rel=1e-5)
    assert w["jax.sigma"] == pytest.approx(-374.0 / 300.0, rel=1e-5)
    assert w["gap_jax.sigma"] == pytest.approx(187.0 / 300.0, rel=1e-5)
    assert w["port.kl"] == pytest.approx(sum(r["kl"] for r in port[150:225]) / 75)


def test_report_critic_loss_windows_and_ratios():
    """`keys=critic_loss`: each window's mean critic loss and each
    reference's ratio, the port's over the reference's; None where a
    history lacks the window."""
    port, ref, short = _hist(300), _hist(300), _hist(230)
    for e, (p, r) in enumerate(zip(port, ref)):
        p["critic_loss"], r["critic_loss"] = 0.03 + 1e-4 * e, 0.001 + 1e-6 * e
    for r in short:
        r["critic_loss"] = 0.02
    out = learning_report.report(port, dict(jax=ref, short=short), at=(), window=75,
                                 every=75, start=150, keys=("critic_loss",))
    w0, w1 = out["windows"]
    assert w0["port.critic_loss"] == pytest.approx(0.03 + 1e-4 * 187.0, rel=1e-5)
    assert w0["jax.critic_loss"] == pytest.approx(0.001 + 1e-6 * 187.0, rel=1e-5)
    assert w0["ratio_jax.critic_loss"] == pytest.approx(
        (0.03 + 1e-4 * 187.0) / (0.001 + 1e-6 * 187.0), rel=1e-5)
    assert w0["ratio_short.critic_loss"] == pytest.approx((0.03 + 1e-4 * 187.0) / 0.02,
                                                          rel=1e-5)
    assert w1["short.critic_loss"] is None and w1["ratio_short.critic_loss"] is None


def test_cli_reads_the_waves(tmp_path, capsys):
    """`keys=wave rest=` on the CLI."""
    rows = _hist(70)
    for r in rows:
        r["episodes"] = 2100 if r["epoch"] == 31 else 3
        r["critic_loss"] = 0.5 if r["epoch"] == 31 else 0.01 * (r["epoch"] >= 40)
    (tmp_path / "p.json").write_text(json.dumps(rows))
    assert learning_report.main([str(tmp_path / "p.json"), "keys=wave", "rest=32-69",
                                 "at=9"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["waves"]["port"] == {"waves": {"31": 0.5},
                                    "rest": pytest.approx(0.3 / 38, rel=1e-5)}
    assert out["windows"][0] == {"epochs": "0-99"}


def test_waves_and_the_rest():
    """`waves`: the epochs whose episodes exceed half of WAVE_ENVS, each with
    its critic loss, and the mean of the others (within `rest`); the report's
    `keys=wave` beside the windows of the other keys."""
    rows = _hist(100)
    for r in rows:
        wave = r["epoch"] % 31 == 30
        r["episodes"] = 4096 if wave else (2048 if r["epoch"] == 5 else 10)
        r["critic_loss"] = 1.0 + r["epoch"] if wave else 0.01
    w = learning_report.waves(rows)
    assert w["waves"] == {30: 31.0, 61: 62.0, 92: 93.0}
    assert w["rest"] == pytest.approx(0.01)
    assert learning_report.waves(rows, rest=(31, 60))["rest"] == pytest.approx(0.01)
    assert 5 not in w["waves"]
    assert learning_report.waves(rows[:30])["waves"] == {}
    out = learning_report.report(rows, dict(ref=rows[:62]), at=(), window=50, every=50,
                                 keys=("wave", "kl"))
    assert out["waves"]["ref"]["waves"] == {30: 31.0, 61: 62.0}
    assert sorted(out["windows"][0]) == ["epochs", "port.kl", "ref.kl"]


WAVE_EPOCHS = (31, 62, 93, 124, 155)
# The port's FrankaCabinet card runs that reach epoch 259: the rule at seeds
# 42, 0 and 1, and four other arithmetics at seeds 42 and 0 (C6's arms).
WAVE_RUNS = ("FrankaCabinet", "FrankaCabinet_seed0", "FrankaCabinet_c6_rule_seed1",
             *(f"FrankaCabinet_c6_{arm}{seed}" for arm in ("f32", "3x", "fwd", "f32value")
               for seed in ("", "_seed0")))


def _g3(x):
    return float(f"{x:.3g}")


def test_franka_cabinet_waves_from_the_tracked_histories():
    """Fault C6's wave table (PERF.md, Findings), three digits: FrankaCabinet's
    critic loss at its first five wave epochs and over the other epochs
    32-259, the JAX TPU record against the port's card runs (the range
    over the runs); the c6_state and c6_check runs are the seed-42 rule run's
    first epochs."""
    def read(path):
        return learning_report.waves(json.loads((ROOT / path).read_text()),
                                     rest=(32, 259))

    jax = read("results/FrankaCabinet/history.json")
    assert tuple(jax["waves"])[:5] == WAVE_EPOCHS
    assert [_g3(jax["waves"][e]) for e in WAVE_EPOCHS] == [0.12, 0.128, 0.111, 0.0648, 0.0318]
    assert _g3(jax["rest"]) == 0.00664
    port = [read(f"results_torch/{run}/history.json") for run in WAVE_RUNS]
    for w in port:
        assert tuple(w["waves"])[:5] == WAVE_EPOCHS
    ranges = {e: (_g3(min(w["waves"][e] for w in port)), _g3(max(w["waves"][e] for w in port)))
              for e in WAVE_EPOCHS}
    assert ranges == {31: (0.69, 1.29), 62: (1.18, 1.69), 93: (1.04, 1.42),
                      124: (1.03, 1.54), 155: (1.05, 1.71)}
    assert (_g3(min(w["rest"] for w in port)), _g3(max(w["rest"] for w in port))) == (
        0.00379, 0.0166)
    for prefix in ("FrankaCabinet_c6_state", "FrankaCabinet_c6_check"):
        w = read(f"results_torch/{prefix}/history.json")["waves"]
        assert w == {e: port[0]["waves"][e] for e in w}


# Rule B of fault C6 (PERF.md, Findings), stated before the race: a run reads as
# the record when W31 < W31_CUT and W62 < W62_CUT (its first two waves' critic
# loss), as the port's when over both; each cut the geometric mean of the
# record's wave and the lowest port card run's.
W31_CUT, W62_CUT = 0.288, 0.387


def reads(hist):
    """'record', 'port' or 'neither' under rule B, from the first two waves
    (the first alone where the history holds one)."""
    w = list(learning_report.waves(hist)["waves"].values())[:2]
    cuts = (W31_CUT, W62_CUT)[:len(w)]
    if all(x < c for x, c in zip(w, cuts)):
        return "record"
    if all(x > c for x, c in zip(w, cuts)):
        return "port"
    return "neither"


def _load_hist(path):
    return json.loads((ROOT / path).read_text())


def test_rule_b_cuts_from_the_tracked_histories():
    """The cuts: the record's W31 and W62 against the lowest of the port's
    card runs (WAVE_RUNS)."""
    rec = learning_report.waves(_load_hist("results/FrankaCabinet/history.json"))["waves"]
    port = [learning_report.waves(_load_hist(f"results_torch/{r}/history.json"))["waves"]
            for r in WAVE_RUNS]
    for e, cut in ((31, W31_CUT), (62, W62_CUT)):
        assert round(math.sqrt(rec[e] * min(w[e] for w in port)), 3) == cut
    assert all(reads(_load_hist(f"results_torch/{r}/history.json")) == "port"
               for r in WAVE_RUNS)
    assert reads(_load_hist("results/FrankaCabinet/history.json")) == "record"


RACE = {"jax42": (1.23, 1.87), "jax0": (1.08, 1.73), "port42": (0.968, 1.48)}


def test_franka_cabinet_race_reads_branch_b():
    """The race (tools/c6_race.sh TASK=FrankaCabinet EPOCHS=63, CPU, 4096
    envs): both JAX seeds read as the port's, and the port's run too;
    rule B's branch (b). Each run's first two waves at epochs 31 and 62."""
    for run, w3 in RACE.items():
        hist = _load_hist(f"results_torch/FrankaCabinet_c6_race_{run}/history.json")
        assert hist[-1]["epoch"] == 62
        w = learning_report.waves(hist)["waves"]
        assert tuple(w) == (31, 62)
        assert (_g3(w[31]), _g3(w[62])) == w3
        assert reads(hist) == "port", (run, w)


def test_records_setting_reads_as_the_record():
    """Under the setting the JAX TPU records were trained with
    (value_bootstrap=True): the JAX package on the CPU at the record's seed
    (FrankaCabinet to epoch 31) and the port on the card (seeds 42 and 0,
    750 epochs) read as the record; the JAX CPU run's wave epoch carries the
    record's step reward, the bootstrapped value, within 1%."""
    rec = _load_hist("results/FrankaCabinet/history.json")
    cpu = _load_hist("results_torch/FrankaCabinet_c6_race_jax42_vb/history.json")
    assert reads(cpu) == "record"
    assert cpu[31]["mean_step_reward"] == pytest.approx(rec[31]["mean_step_reward"], rel=0.01)
    for run in ("FrankaCabinet_c6_vb", "FrankaCabinet_c6_vb_seed0"):
        assert reads(_load_hist(f"results_torch/{run}/history.json")) == "record", run


def test_ballbalance_records_settings_reads_as_the_record():
    """BallBalance's critic loss over epochs 40-119 (the first race's readout):
    the JAX package on the CPU at seed 42 under the record's two settings
    (value_bootstrap=True, learning_rate 5e-4) within 1.5 times the TPU
    record's, where under today's yaml it stands over 3 times; the port on
    the card with value_bootstrap=True (seed 42, 1500 epochs) under 3 times
    the record's over every 75-epoch window from 150 (C6's claim was the
    port's 4-70 times over it; at 300-374 the port's stands 0.268 of it)."""
    rec = _load_hist("results/BallBalance/history.json")

    def ratio(path, start, width):
        h = _load_hist(path)
        return (learning_report.window_mean(h, start, width, "critic_loss")
                / learning_report.window_mean(rec, start, width, "critic_loss"))

    assert ratio("results_torch/BallBalance_c6_race_jax42_record/history.json", 40, 80) < 1.5
    assert ratio("results_torch/BallBalance_c6_race_jax42/history.json", 40, 80) > 3
    for start in range(150, 1500, 75):
        r = ratio("results_torch/BallBalance_c6_vb/history.json", start, 75)
        assert r < 3, (start, r)
