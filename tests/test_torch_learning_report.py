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
