"""A port's learning curve against its references: the summary
`scripts/make_learning_json.py` makes (its `summarize`: the last 5% of the
epochs), the curves at given epochs with their ratios, and the curves side
by side in windows, with the learning rate and KL beside the reward, to
say where two curves part.

    python tests/torch_learning_report.py \
        results_torch/AllegroHand_f32/history.json \
        seed123=results/AllegroHand/history.json \
        seed42=results/AllegroHand_seed42/history.json \
        [row=LEARNING.json:AllegroHand] [at=999,1999,4999,9999] [window=100] [every=500] \
        [start=0] [keys=mean_ep_reward,lr,kl] [bins=800,1000,1200,1400,1700]

    python tests/torch_learning_report.py results_torch/FrankaCabinet/history.json \
        jax=results/FrankaCabinet/history.json keys=wave [rest=32-259]

    python tests/torch_learning_report.py results_torch/FrankaCabinet/history.json \
        jax=results/FrankaCabinet/history.json \
        start=150 every=75 window=75 keys=sigma,critic_loss,kl,lr,mean_ep_reward

A reference is name=path to a history.json (a list of per-epoch rows with
`epoch`, `mean_ep_reward`, `lr`, `kl`). Rows are found by their `epoch`,
so a history that starts late (a run resumed from another's checkpoint)
lines up with the references. The windows start at `start` and every
`every` epochs after it, and hold the means of `keys`. The key `sigma` is
the policy's log sigma per action dim (`log_sigma`): the log-std is a
state-independent parameter, so an epoch's `entropy` is
sum(log sigma_i) + n ENTROPY_C, a readout of the learner's sigma updates
far less noisy than the reward; beside it each reference's `gap_<name>`,
the port's less the reference's. The key `critic_loss` (the epoch's mean
value loss, in normalized-value space) adds beside each window's means
each reference's `ratio_<name>.critic_loss`, the port's over the
reference's. The key `wave` adds the wave readout (`waves`, fault C6):
a wave epoch is one whose `episodes` exceed half of WAVE_ENVS, the 4096
envs of every tracked history (every env reaching the time limit in one
epoch, as FrankaCabinet's envs do together at epochs 31, 62, 93, ...);
for the port and each reference, each wave epoch's critic loss and the
mean critic loss of the other epochs (of epochs `rest=FIRST-LAST` where
given, both included).
`row=FILE:KEY` names a record row
(`LEARNING.json`) held against the port's summary. The summary is named
after the history's directory.

`bins=B0,B1,...` adds the matched-reward table (`matched`): for the port
and each reference, the epochs after MATCH_START binned by their
`mean_ep_reward` into [B0, B1), [B1, B2), ..., and each bin's mean episode
length, consecutive successes and episodes an epoch, where the bin holds
at least MATCH_MIN_EPOCHS epochs. Two runs at the same reward that end
their episodes at different lengths drop the cube at different rates (an
in-hand task whose yaml has no fall penalty and no success limit ends an
episode early by a fall only). Prints one JSON object.
"""

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.join(ROOT, "scripts"))

from make_learning_json import summarize  # noqa: E402


def at_epoch(hist: list, epoch: int, key: str = "mean_ep_reward"):
    """The value of `key` at `epoch`, or None where the history has no
    such row."""
    rows = [r for r in hist if r["epoch"] == epoch]
    return rows[0][key] if rows else None


def window_mean(hist: list, start: int, width: int, key: str):
    """The mean of `key` over epochs start .. start + width - 1, or None
    unless the history holds every one of them."""
    rows = [r for r in hist if start <= r["epoch"] < start + width]
    return sum(r[key] for r in rows) / len(rows) if len(rows) == width else None


ENTROPY_C = 0.5 * math.log(2.0 * math.pi * math.e)


def n_actions(hist: list) -> int:
    """The action count: epoch 0's entropy over ENTROPY_C, rounded (sigma
    starts at 1); None where the history has no epoch 0."""
    e0 = at_epoch(hist, 0, "entropy")
    return None if e0 is None else round(e0 / ENTROPY_C)


def log_sigma(hist: list, start: int, width: int):
    """The policy's log sigma per action dim over epochs start ..
    start + width - 1, from the window's mean `entropy`, or None unless
    the history holds every one of them and epoch 0."""
    n = n_actions(hist)
    m = window_mean(hist, start, width, "entropy")
    return None if m is None or n is None else (m - n * ENTROPY_C) / n


WAVE_SHARE = 0.5
WAVE_ENVS = 4096


def waves(hist: list, rest=None) -> dict:
    """The wave readout of one history: {"waves": {epoch: critic_loss},
    "rest": mean} over the wave epochs (`episodes` over WAVE_SHARE of
    WAVE_ENVS) and the mean critic loss over the other epochs, those of
    rest=(first, last) where given, both included; None where there are
    none."""
    wave = {r["epoch"]: r["critic_loss"] for r in hist
            if r["episodes"] > WAVE_SHARE * WAVE_ENVS}
    lo, hi = rest if rest else (-math.inf, math.inf)
    others = [r["critic_loss"] for r in hist
              if r["epoch"] not in wave and lo <= r["epoch"] <= hi]
    return dict(waves=wave, rest=sum(others) / len(others) if others else None)


MATCH_START = 200
MATCH_MIN_EPOCHS = 20
MATCH_KEYS = ("mean_ep_length", "Episode/consecutive_successes", "episodes")


def matched(hists: dict, bins=(800, 1000, 1200, 1400, 1700), start=MATCH_START,
            min_epochs=MATCH_MIN_EPOCHS, keys=MATCH_KEYS) -> dict:
    """{run: {"lo-hi": {"epochs": n, key: mean, ...} or None}}: each
    history's epochs from `start` on, binned by mean_ep_reward; a bin of
    fewer than `min_epochs` epochs is None."""
    out = {}
    for name, h in hists.items():
        rows = [r for r in h if r["epoch"] >= start]
        out[name] = {}
        for lo, hi in zip(bins[:-1], bins[1:]):
            sel = [r for r in rows if lo <= r["mean_ep_reward"] < hi]
            cell = None
            if len(sel) >= min_epochs:
                cell = dict(epochs=len(sel))
                for k in keys:
                    if all(k in r for r in sel):
                        cell[k] = float(f"{sum(r[k] for r in sel) / len(sel):.6g}")
            out[name][f"{lo}-{hi}"] = cell
    return out


def report(port: list, refs: dict, row=None, at=(999, 1999, 4999, 9999), window=100,
           every=500, task="port", start=0,
           keys=("mean_ep_reward", "lr", "kl"), bins=None, rest=None) -> dict:
    out = dict(port=summarize(task, port))
    if row is not None:
        out["row"] = row
        out["ratio_to_row"] = {k: round(out["port"][k] / row[k], 3)
                               for k in ("final_ep_reward", "consecutive_successes",
                                         "mean_successes", "terrain_level")
                               if k in row and k in out["port"] and row[k]}
    out["at"] = {}
    for e in at:
        p = at_epoch(port, e)
        entry = dict(port=p)
        for name, h in refs.items():
            r = at_epoch(h, e)
            entry[name] = r
            entry[f"ratio_{name}"] = round(p / r, 3) if p is not None and r else None
        out["at"][str(e)] = entry
    if "wave" in keys:
        out["waves"] = {}
        for name, h in [("port", port), *refs.items()]:
            w = waves(h, rest=rest)
            out["waves"][name] = dict(
                waves={e: float(f"{v:.6g}") for e, v in w["waves"].items()},
                rest=None if w["rest"] is None else float(f"{w['rest']:.6g}"))
        keys = tuple(k for k in keys if k != "wave")
    out["windows"] = []
    for first in range(start, port[-1]["epoch"] + 1, every):
        w = dict(epochs=f"{first}-{first + window - 1}")
        for name, h in [("port", port), *refs.items()]:
            for key in keys:
                v = (log_sigma(h, first, window) if key == "sigma"
                     else window_mean(h, first, window, key))
                w[f"{name}.{key}"] = None if v is None else float(f"{v:.6g}")
        if "sigma" in keys:
            p = log_sigma(port, first, window)
            for name, h in refs.items():
                r = log_sigma(h, first, window)
                w[f"gap_{name}.sigma"] = (None if p is None or r is None
                                          else float(f"{p - r:.6g}"))
        if "critic_loss" in keys:
            p = window_mean(port, first, window, "critic_loss")
            for name, h in refs.items():
                r = window_mean(h, first, window, "critic_loss")
                w[f"ratio_{name}.critic_loss"] = (None if p is None or not r
                                                  else float(f"{p / r:.6g}"))
        out["windows"].append(w)
    if bins:
        out["matched"] = matched(dict(port=port, **refs), bins)
    return out


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "=" in argv[0]:
        print(__doc__, file=sys.stderr)
        return 2
    port, refs = _load(argv[0]), {}
    kw = dict(task=os.path.basename(os.path.dirname(os.path.abspath(argv[0]))))
    for a in argv[1:]:
        k, v = a.split("=", 1)
        if k == "row":
            path, key = v.rsplit(":", 1)
            kw["row"] = _load(path)[key]
        elif k == "at":
            kw["at"] = tuple(int(x) for x in v.split(","))
        elif k in ("window", "every", "start"):
            kw[k] = int(v)
        elif k == "rest":
            kw["rest"] = tuple(int(x) for x in v.split("-"))
        elif k == "keys":
            kw["keys"] = tuple(v.split(","))
        elif k == "bins":
            kw["bins"] = tuple(float(x) if "." in x else int(x) for x in v.split(","))
        else:
            refs[k] = _load(v)
    print(json.dumps(report(port, refs, **kw), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
