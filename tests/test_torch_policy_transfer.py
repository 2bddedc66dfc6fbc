"""tests/torch_policy_transfer.py at a tiny size: the JAX package's trained
ShadowHand policy (results/ShadowHand/nn-best) loads into both packages'
trainers, the port's networks and norms through convert.py, and each
package's evaluate runs it."""

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import torch_policy_transfer  # noqa: E402


def test_the_jax_policy_runs_in_both_envs(capsys):
    # 8 envs: the suite's JAX package shards the env axis over 8 CPU devices
    assert torch_policy_transfer.main(["num_envs=8", "steps=3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checkpoint"] == "results/ShadowHand/nn-best"
    for pkg in ("jax", "port"):
        assert math.isfinite(out[pkg]["mean_episode_reward"]), out
        assert out[pkg]["episodes"] == 0 and "consecutive_successes" in out[pkg], out
        assert out[pkg]["episodes_ended"] == 0 and out[pkg]["their_successes"] == 0, out
