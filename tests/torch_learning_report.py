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

A reference is name=path to a history.json (a list of per-epoch rows with
`epoch`, `mean_ep_reward`, `lr`, `kl`). Rows are found by their `epoch`,
so a history that starts late (a run resumed from another's checkpoint)
lines up with the references. The windows start at `start` and every
`every` epochs after it, and hold the means of `keys`. `row=FILE:KEY` names a record row
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
           keys=("mean_ep_reward", "lr", "kl"), bins=None) -> dict:
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
    out["windows"] = []
    for first in range(start, port[-1]["epoch"] + 1, every):
        w = dict(epochs=f"{first}-{first + window - 1}")
        for name, h in [("port", port), *refs.items()]:
            for key in keys:
                v = window_mean(h, first, window, key)
                w[f"{name}.{key}"] = None if v is None else float(f"{v:.6g}")
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
