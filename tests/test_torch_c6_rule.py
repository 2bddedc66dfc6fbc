"""Fault C6's trajectory rule (ROADMAP §C6, PERF.md's rule C), on the
CPU: a trajectory from a trained state judged against JAX's own spread, not
against a fixed tolerance (JAX's own rollout, nudged by 2^-22, parts from
itself past `TRAJ` at its first step on these states).

For a state S (a port `model.pt`, carried into the JAX trainer as
tests/test_torch_c6_value.py's `pair` does), the epoch's rollout as that
file's `epoch()` builds it: N = 64 envs, a JAX reset, WARMUP horizons under
the held policy, every env SHORT steps short of the time limit, networks in
exact f32, the port's own rollout with JAX's noise and JAX's reset draws.
- G_P(t, k): the largest gap over the envs between the port's rollout and
  JAX's, in units of `TRAJ` (rtol 1e-4, atol 1e-5 at JAX's value), for each
  step t and each quantity k of `ROLLOUT_KEYS`;
- G_J(d, t, k): the same gap of JAX's own rollout from S with q and qd
  nudged by `ops/parity.py` `cond_nudge` in direction d against JAX's
  un-nudged rollout, for each of the six `COND_DIRECTIONS`, in the same run.
A rollout's first part is its first step with some quantity past 1 (None:
it never parts). **The rule holds for S when** the port's first part comes
no earlier than the earliest of JAX's six, and at every (t, k) where
G_P > 1, G_P <= max over d of G_J(d, t, k).

The states that judge are JAX's own CPU states,
`results_torch/<task>_c6_jaxstate/model.pt`: FrankaCabinet's is the last
state of `tools/c6_race.sh TASK=FrankaCabinet EPOCHS=63`'s `jax:42` run
(epoch 63), BallBalance's that of `tools/c6_race.sh RUNS="jax:42"` (epoch
120), each carried by `python tests/torch_jax_checkpoint.py task=<task>
checkpoint=<run>/runs/<task>/nn/last out=results_torch/<task>_c6_jaxstate`.
The port's card-trained states (`<task>_c6_state`, those of
tests/test_torch_c6_value.py) are reported beside them and judge
nothing. Each verdict is recorded as the run found it (`VERDICTS`); a test
fails if a verdict or a first part moves.

    python -m pytest tests/test_torch_c6_rule.py -q             # tier 1
    python -m pytest tests/test_torch_c6_rule.py -q -m slow     # the rest
    PYTHONPATH=.:tests python tests/test_torch_c6_rule.py        # the figures, JSON
"""

import functools

import numpy as np
import pytest

from test_torch_c6_value import (COND_DIRECTIONS, ROLLOUT_KEYS, _np, _use, jax_roll,
                                 nudged, rollouts)

JUDGE = "c6_jaxstate"
EARLIER = "c6_state"
# Each state's verdict as its run found it: (holds, the port's first part,
# the earliest of JAX's six first parts).
VERDICTS = {
    ("BallBalance", JUDGE): (True, 1, 1),
    ("FrankaCabinet", JUDGE): (True, None, None),
    # reported, judging nothing: at step 12 the port's mu parts by 1.407
    # of TRAJ where JAX's six nudges reach 1.164
    ("BallBalance", EARLIER): (True, 1, 1),
    ("FrankaCabinet", EARLIER): (False, 3, 1),
}


def gap_table(port, ref) -> np.ndarray:
    """(T, len(ROLLOUT_KEYS)): the largest gap over the envs at each step,
    in units of TRAJ, of rollout `port` against rollout `ref`."""
    return np.array([[float(_use(port[k][t], ref[k][t]).max()) for k in ROLLOUT_KEYS]
                     for t in range(len(ref["obs"]))])


def first_part(g: np.ndarray):
    """The first step with a quantity past 1, or None."""
    rows = np.nonzero((g > 1).any(1))[0]
    return int(rows[0]) if len(rows) else None


def verdict(gp: np.ndarray, gj: dict) -> dict:
    """Rule C on G_P and {direction: G_J}: whether it holds, both first
    parts, and every (step, quantity) where G_P > 1 lies past JAX's spread,
    with G_P and the spread there."""
    first_p = first_part(gp)
    firsts = [f for f in (first_part(g) for g in gj.values()) if f is not None]
    first_j = min(firsts) if firsts else None
    spread = np.max(np.stack(list(gj.values())), axis=0)
    over = {(int(t), ROLLOUT_KEYS[k]): (round(float(gp[t, k]), 4), round(float(spread[t, k]), 4))
            for t, k in np.argwhere((gp > 1) & (gp > spread))}
    early = first_p is not None and (first_j is None or first_p < first_j)
    return dict(holds=not early and not over, first_port=first_p, first_jax=first_j,
                over_spread=over)


@functools.lru_cache(maxsize=None)
def gaps(task, state):
    """(G_P, {d: G_J}) on `state`, from one run of both packages."""
    ro = rollouts(task, state)
    jtraj = {k: _np(v) for k, v in ro["jax"][1].items()}
    js = ro["js"]
    gj = {}
    for d in COND_DIRECTIONS:
        traj = jax_roll(task, state)(js.replace(es=nudged(js.es, d)))[1]
        gj[d] = gap_table({k: _np(v) for k, v in traj.items()}, jtraj)
    return gap_table(ro["rollout"], jtraj), gj


def judge(task, state) -> dict:
    return verdict(*gaps(task, state))


# -- the rule itself, on tables made up for it -------------------------------

def _table(rows):
    """A (T, len(ROLLOUT_KEYS)) table: {step: {quantity: gap}}, 0 elsewhere."""
    g = np.zeros((4, len(ROLLOUT_KEYS)))
    for t, row in rows.items():
        for k, v in row.items():
            g[t, ROLLOUT_KEYS.index(k)] = v
    return g


RULE_CASES = {
    "inside": ({}, {"+": {1: {"obs": 3.0}}}, True),
    "same step, inside the spread": ({1: {"obs": 2.0}}, {"+": {1: {"obs": 3.0}},
                                                           "-": {2: {"mu": 9.0}}}, True),
    "later, inside another direction's spread": (
        {2: {"mu": 5.0}}, {"+": {1: {"obs": 3.0}}, "-": {2: {"mu": 9.0}}}, True),
    "equal to the spread": ({1: {"obs": 3.0}}, {"+": {1: {"obs": 3.0}}}, True),
    "earlier than every direction": ({0: {"obs": 1.5}}, {"+": {1: {"obs": 3.0}},
                                                         "-": {0: {"obs": 0.5}}}, False),
    "past the spread in another quantity": ({1: {"obs": 2.0, "value": 1.2}},
                                            {"+": {1: {"obs": 3.0, "value": 1.1}}}, False),
    "JAX never parts": ({3: {"reward": 1.01}}, {"+": {3: {"reward": 0.9}}}, False),
    "neither parts": ({2: {"logp": 0.9}}, {"+": {}}, True),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_on_made_up_tables(case):
    port, jax_dirs, holds = RULE_CASES[case]
    v = verdict(_table(port), {d: _table(rows) for d, rows in jax_dirs.items()})
    assert v["holds"] is holds, v


def test_rule_names_what_lies_past_the_spread():
    v = verdict(_table({1: {"obs": 2.0, "value": 1.2}, 3: {"done": 0.5}}),
                {"+": _table({1: {"obs": 3.0, "value": 1.1}}),
                 "-": _table({0: {"action": 4.0}})})
    assert v == dict(holds=False, first_port=1, first_jax=0,
                     over_spread={(1, "value"): (1.2, 1.1)})


# -- the verdicts ------------------------------------------------------------

def _state_case(task, state, slow):
    return pytest.param(task, state, id=f"{task}-{state}",
                        marks=[pytest.mark.slow] if slow else [])


STATES = [_state_case("BallBalance", JUDGE, False), _state_case("FrankaCabinet", JUDGE, True),
          _state_case("BallBalance", EARLIER, True), _state_case("FrankaCabinet", EARLIER, True)]


@pytest.mark.parametrize("task,state", STATES)
def test_rule_verdict(task, state):
    """Rule C on a state, as recorded: the verdict and both first parts."""
    v = judge(task, state)
    assert (v["holds"], v["first_port"], v["first_jax"]) == VERDICTS[(task, state)], v


def report() -> dict:
    """Per task and state: the verdict, each first part, what lies past
    JAX's spread, and the largest G_P and spread over the rollout."""
    out = {}
    for task in ("FrankaCabinet", "BallBalance"):
        for state in (JUDGE, EARLIER):
            gp, gj = gaps(task, state)
            v = verdict(gp, gj)
            spread = np.max(np.stack(list(gj.values())), axis=0)
            out[f"{task}_{state}"] = dict(
                holds=v["holds"], first_port=v["first_port"], first_jax=v["first_jax"],
                first_jax_by_direction={d: first_part(g) for d, g in gj.items()},
                over_spread={str(c): u for c, u in v["over_spread"].items()},
                max_port={k: round(float(gp[:, i].max()), 4)
                          for i, k in enumerate(ROLLOUT_KEYS)},
                max_spread={k: round(float(spread[:, i].max()), 4)
                            for i, k in enumerate(ROLLOUT_KEYS)},
                port_by_step=[round(float(x), 4) for x in gp.max(1)],
                spread_by_step=[round(float(x), 4) for x in spread.max(1)])
    return out


if __name__ == "__main__":
    import json

    import conftest  # noqa: F401  (the suite's JAX settings: CPU, 8 devices)

    print(json.dumps(report()))
