"""The policy's sigma record and the critic record of the port's learning
rows against the JAX package's histories (ROADMAP §C: C6 closed, C8 open).
Reads JSON only.

The policy's log-std is a state-independent parameter in both packages, so
an epoch's logged `entropy` is sum(log sigma_i) + 1.419 n: a readout of
the learner's sigma updates far less noisy than the reward
(tests/torch_learning_report.py `log_sigma`). For every row of
LEARNING_TORCH.json trained under the learner's default rule for f32
feed-forward networks (`PPOConfig.net_matmul`, as its records' device lines
name it), the port's log sigma per action dim over 75-epoch windows from
epoch 150 to min(750, the row's budget) is held against
results/<row>/history.json's, n from epoch 0's entropy (equal in both).

BAND: twice the largest gap per dim between FrankaCabinet's two seeds under
the rule over those windows (results_torch/FrankaCabinet and
FrankaCabinet_seed0: 0.0275 at window 225), the band stated before the
C6 arms ran and held since. A row whose every window lies within BAND of
JAX's matches it; each row outside is named in OUTSIDE with its reason and
its largest gap, as measured. SEED_SPREAD: the same over three seeds
(with FrankaCabinet_c6_rule_seed1, 0.0859 per dim, seed 1 against seed 0 at
window 225), measured after the band was stated; the rows of OUTSIDE within
it are named in WITHIN_SEED_SPREAD, and stay in OUTSIDE. The lists are the
record: a change to the learner's arithmetic reads them first, and a row
leaves OUTSIDE only when a rerun brings it within BAND.

The critic record: the same rows' mean `critic_loss` (the value loss in
normalized-value space) over the same windows against JAX's. CRITIC_FACTOR,
3, was stated before the record was computed: a row whose window mean stands
more than 3 times above or below JAX's in any window is named in
CRITIC_OUTSIDE with its reason and its largest factor (max of port / JAX and
JAX / port over the windows, as measured). A row leaves CRITIC_OUTSIDE only
when a rerun brings it inside.
"""

import json
from pathlib import Path

import pytest

from omniisaacgymenvs_torch.learn import PPOConfig
from test_torch_learning_record import LEARNING, named_rules, record
from torch_learning_report import log_sigma, n_actions, window_mean

ROOT = Path(__file__).resolve().parents[1]
START, END, WIDTH = 150, 750, 75
BAND = 0.055
BAND_SEEDS = ("FrankaCabinet", "FrankaCabinet_seed0")
SEED_SPREAD = 0.172
SPREAD_SEEDS = (*BAND_SEEDS, "FrankaCabinet_c6_rule_seed1")
# The reasons. RECORDS_SETTING: the JAX record was trained with
# value_bootstrap: True (BallBalance also at lr 5e-4), which today's yamls
# drop (C6, closed). C8: open, not located (ROADMAP §C8).
RECORDS_SETTING = "records' value_bootstrap"
# row: (reason, the largest |port - JAX| of log sigma per dim over the
# windows, to 3 decimals)
OUTSIDE = {
    "BallBalance": (RECORDS_SETTING, 0.566),
    "Crazyflie": ("C8", 3.265),
    "FrankaCabinet": (RECORDS_SETTING, 0.328),
    "Ingenuity": ("C8", 0.133),
    "ShadowHand_DR": ("C8", 0.064),
}
WITHIN_SEED_SPREAD = {"Ingenuity", "ShadowHand_DR"}
CRITIC_FACTOR = 3.0
# row: (reason, the largest factor between the port's and JAX's window
# means, to 3 decimals)
CRITIC_OUTSIDE = {
    "BallBalance": (RECORDS_SETTING, 86.952),
    "Crazyflie": ("C8", 13.045),
    "FrankaCabinet": (RECORDS_SETTING, 25.833),
}
RULE_ROWS = sorted(r for r in LEARNING if named_rules(record(r)) == {PPOConfig().net_matmul})
WINDOWED = [r for r in RULE_ROWS if min(END, LEARNING[r]["epochs"]) >= START + WIDTH]


def history(path: Path) -> list:
    return json.loads(path.read_text())


def sigma_windows(hist: list, end=END) -> list:
    return [log_sigma(hist, s, WIDTH) for s in range(START, end - WIDTH + 1, WIDTH)]


def sigma_gaps(row: str) -> list:
    """The port's log sigma per dim less JAX's, window by window."""
    port = history(ROOT / "results_torch" / row / "history.json")
    ref = history(ROOT / "results" / row / "history.json")
    assert n_actions(port) == n_actions(ref), row
    end = min(END, LEARNING[row]["epochs"])
    got, want = sigma_windows(port, end), sigma_windows(ref, end)
    assert got and None not in got and None not in want, row
    return [a - b for a, b in zip(got, want)]


@pytest.mark.parametrize("seeds,width", [(BAND_SEEDS, BAND), (SPREAD_SEEDS, SEED_SPREAD)],
                         ids=["band", "seed_spread"])
def test_band_is_twice_the_rule_seeds_spread(seeds, width):
    sig = []
    for run in seeds:
        assert named_rules(record(run)) == {"bf16_operands"}, run
        sig.append(sigma_windows(history(ROOT / "results_torch" / run / "history.json")))
    spread = max(abs(a - b) for i, x in enumerate(sig) for y in sig[i + 1:]
                 for a, b in zip(x, y))
    assert round(2.0 * spread, 3) == width, spread


def test_outside_rows_are_rule_rows_with_a_window():
    assert set(OUTSIDE) <= set(WINDOWED)
    assert set(CRITIC_OUTSIDE) <= set(WINDOWED)
    assert "FrankaCabinet" in WINDOWED
    assert WITHIN_SEED_SPREAD <= set(OUTSIDE)


def test_rows_without_a_window_are_short():
    """Cartpole's 100 epochs end before the first window."""
    for row in sorted(set(RULE_ROWS) - set(WINDOWED)):
        assert LEARNING[row]["epochs"] < START + WIDTH, row


@pytest.mark.parametrize("row", WINDOWED)
def test_sigma_within_band_of_jax_or_named(row):
    worst = max(abs(g) for g in sigma_gaps(row))
    if row in OUTSIDE:
        fault, gap = OUTSIDE[row]
        assert worst > BAND and round(worst, 3) == gap, (row, fault, worst)
        assert (worst <= SEED_SPREAD) == (row in WITHIN_SEED_SPREAD), (row, worst)
    else:
        assert worst <= BAND, (row, worst)


def critic_factors(row: str) -> list:
    """The port's mean critic loss over JAX's, window by window."""
    port = history(ROOT / "results_torch" / row / "history.json")
    ref = history(ROOT / "results" / row / "history.json")
    end = min(END, LEARNING[row]["epochs"])
    starts = range(START, end - WIDTH + 1, WIDTH)
    got = [window_mean(port, s, WIDTH, "critic_loss") for s in starts]
    want = [window_mean(ref, s, WIDTH, "critic_loss") for s in starts]
    assert got and None not in got and None not in want, row
    return [a / b for a, b in zip(got, want)]


@pytest.mark.parametrize("row", WINDOWED)
def test_critic_within_factor_of_jax_or_named(row):
    worst = max(max(f, 1.0 / f) for f in critic_factors(row))
    if row in CRITIC_OUTSIDE:
        fault, factor = CRITIC_OUTSIDE[row]
        assert worst > CRITIC_FACTOR and round(worst, 3) == factor, (row, fault, worst)
    else:
        assert worst <= CRITIC_FACTOR, (row, worst)
