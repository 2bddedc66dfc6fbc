"""AllegroHand's resets by cause under one held policy, the JAX package's
env against the port's on the CPU (tests/torch_fall_rates.py).

Both envs step the same actions: +1 or -1 in every dimension, drawn with
numpy from one seed and held 4 control steps (`policy=hold:4`), from
resets each package draws itself, 64 envs for 40 steps. Episodes are
cut to 24 steps (`task.env.episodeLength=24`, in both packages) so that a
short run ends episodes by time as well as by falls. Each cause's count
(fell, timeout, non-finite, other) must agree within 4 standard
deviations of the difference of the two Poisson rates, and the run must
count falls and timeouts in both. The scale: at 256 envs x 150 steps under the yaml's
600-step episodes the two packages count 1020 and 1022 falls (0.04 sd
apart); a scratch check of the same kind counted 693 against 671 (Poisson
noise some 26). At this size (some 45 falls and 45 timeouts each) a
package whose cube fell twice as often as the other's would stand past
4 sd; the file's time (some 30 s alone, a third of it the JAX
step's compile) bounds the size.
"""

import functools
import math

import pytest
import torch

import numpy as np

from torch_fall_rates import (CAUSES, EJECT_ANG, PER_ENV, PER_ENV_TOP, HoldPolicy, Tally,
                              compare, diff_sd, poisson_interval, rate, run_jax, run_port)

N, STEPS, HOLD, SEED = 64, 40, 4, 0
OVERRIDES = ("task.env.episodeLength=24",)
SD_MAX = 4.0
MIN_COUNT = 25   # falls and timeouts each package must count


@functools.lru_cache(maxsize=None)
def runs():
    """(JAX result, port result) of the held policy; the port on two
    threads at most."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        jax_res = run_jax(N, STEPS, HoldPolicy(N, 16, HOLD, SEED), SEED, OVERRIDES)
        port_res = run_port(N, STEPS, HoldPolicy(N, 16, HOLD, SEED), SEED, "cpu",
                            None, OVERRIDES)
    finally:
        torch.set_num_threads(threads)
    return jax_res, port_res


def test_by_env_differences_are_reported():
    """`compare` holds each per-env count's difference of the means over
    envs in standard errors beside its Poisson difference."""
    sd = compare(*runs())
    for key in PER_ENV:
        assert isinstance(sd[f"{key}_by_env"], float) and key in sd


@pytest.mark.parametrize("cause", CAUSES)
def test_reset_causes_agree(cause):
    jax_res, port_res = runs()
    sd = compare(jax_res, port_res)[cause]
    counts = [r["rates"][cause]["count"] for r in (jax_res, port_res)]
    assert abs(sd) <= SD_MAX, (cause, counts, sd)


def test_runs_count_falls_and_timeouts():
    """Neither cause is vacuous, and every done has a cause: AllegroHand's
    yaml ends no episode on successes, and no state turned non-finite."""
    for res in runs():
        r = res["rates"]
        assert res["env_steps"] == N * STEPS
        assert r["fell"]["count"] >= MIN_COUNT and r["timeout"]["count"] >= MIN_COUNT, r
        assert r["other"]["count"] == 0 and r["nonfinite"]["count"] == 0, r
        ends = sum(r[c]["count"] for c in CAUSES)
        assert res["episode_length"]["n"] == res["episode_reward"]["n"] == ends
        assert res["episode_length"]["mean"] <= 24


@pytest.mark.parametrize("key", PER_ENV)
def test_per_env_counts_add_up(key):
    """Each run's per-env spread of goal hits and ejections: its total is
    the run's count, its top envs in descending order with the step of
    their first one, the shares of the total they carry."""
    for res in runs():
        spread, count = res["per_env"][key], res["rates"][key]["count"]
        assert spread["total"] == count
        top = spread["top"]
        assert len(top) == min(PER_ENV_TOP, spread["envs"]) and spread["envs"] <= N
        counts = [t["count"] for t in top]
        assert counts == sorted(counts, reverse=True) and all(c > 0 for c in counts)
        assert all(0 <= t["env"] < N and 0 <= t["first_step"] < STEPS for t in top)
        assert spread["mean"] == pytest.approx(count / N)
        if count:
            assert spread["top1_share"] == counts[0] / count
            assert spread["top_share"] == sum(counts) / count
        else:
            assert spread["top1_share"] == spread["top_share"] == 0.0


def test_per_env_spread_shows_clustering():
    """Three steps of four envs: env 2 spins past EJECT_ANG in all three,
    env 1 once, in the last: the spread names env 2 first, from step 0,
    with three quarters of the total."""
    tally = Tally(4, fall_dist=0.24)
    for t in range(3):
        ang = np.zeros(4)
        ang[2] = 2 * EJECT_ANG
        if t == 2:
            ang[1] = 2 * EJECT_ANG
        rows = np.zeros((8, 4))
        rows[2] = 1.0   # finite
        rows[7] = ang
        tally.add(rows)
    spread = tally.result()["per_env"]["ejections_ang"]
    assert spread == dict(total=4, envs=2, mean=1.0, sd=float(np.std([0, 1, 3, 0], ddof=1)),
                          top=[dict(env=2, count=3, first_step=0),
                               dict(env=1, count=1, first_step=2)],
                          top1_share=0.75, top_share=1.0)
    assert tally.result()["per_env"]["goal_hits"]["total"] == 0


@pytest.mark.parametrize("k", [0, 1, 5, 30, 1000])
def test_poisson_interval_is_exact(k):
    """Each end of the interval leaves 2.5% of the Poisson mass beyond k."""
    from scipy.stats import poisson

    lo, hi = poisson_interval(k)
    if k == 0:
        assert lo == 0.0
    else:
        assert poisson.sf(k - 1, lo) == pytest.approx(0.025, rel=1e-6)
    assert poisson.cdf(k, hi) == pytest.approx(0.025, rel=1e-6)
    r = rate(k, 4000)
    assert r["per_1000"] == k / 4 and r["lo"] <= r["per_1000"] <= r["hi"]


def test_difference_in_standard_deviations():
    assert diff_sd(0, 100, 0, 200) == 0.0
    # equal rates over unequal exposures
    assert diff_sd(100, 1000, 200, 2000) == 0.0
    assert diff_sd(130, 1000, 100, 1000) == pytest.approx(30 / math.sqrt(230))
    assert diff_sd(100, 1000, 130, 1000) == -diff_sd(130, 1000, 100, 1000)


@functools.lru_cache(maxsize=None)
def _port_run(route):
    """A 2-step run of 4 envs through `route` (None: the product path)."""
    res = run_port(4, 2, HoldPolicy(4, 16, HOLD, SEED), SEED, "cpu", route)
    res.pop("seconds")
    return res


@pytest.mark.parametrize("route", ["plain", "group"])
def test_routes_step_as_the_product_path_on_the_cpu(route):
    """The script's own physics routes (the card's `plain` and `design=`
    runs) give, on CPU tensors, the product path's results bit for bit:
    both reach the same plain substeps from the same resets and actions."""
    assert _port_run(route) == _port_run(None)
