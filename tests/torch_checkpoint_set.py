"""Copy a port checkpoint directory with some scalar leaves of its main
file set (arm F of fault C3, ROADMAP §C3: the carried JAX policy trained on
with its learning rate at 0).

    python tests/torch_checkpoint_set.py SRC DST lr=0

Copies SRC's `model.pt` (and its `env.pt` sidecar where there is one) to
DST, each `key=value` setting the scalar leaf `key` of `model.pt` (a 0-dim
tensor keeps its dtype, a number its type), e.g. `lr=0` for a
run that goes on from a checkpoint with its policy frozen: the adaptive
schedule only scales the learning rate, so it stays 0. A key that is not
a scalar leaf of the file is refused before anything is written.
"""

from __future__ import annotations

import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from omniisaacgymenvs_torch.learn import ppo  # noqa: E402


def set_leaves(src: str, dst: str, values: dict) -> dict:
    """Write DST as SRC with `values` ({leaf: number}) set in model.pt;
    returns the leaves set, as written."""
    flat = torch.load(os.path.join(src, ppo.MAIN_FILE), map_location="cpu",
                      weights_only=True)
    for k, v in values.items():
        old = flat.get(k)
        if isinstance(old, torch.Tensor) and old.ndim == 0:
            flat[k] = torch.tensor(float(v), dtype=old.dtype)
        elif isinstance(old, (int, float)) and not isinstance(old, bool):
            flat[k] = type(old)(float(v))
        else:
            raise KeyError(f"{k}: not a scalar leaf of {src}/{ppo.MAIN_FILE}")
    os.makedirs(dst, exist_ok=True)
    side = os.path.join(src, ppo.ENV_FILE)
    if os.path.exists(side):
        shutil.copyfile(side, os.path.join(dst, ppo.ENV_FILE))
    ppo._save_atomic(flat, os.path.join(dst, ppo.MAIN_FILE))
    return {k: flat[k] for k in values}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or any("=" not in a for a in argv[2:]):
        print(__doc__)
        return 2
    values = dict(a.split("=", 1) for a in argv[2:])
    done = set_leaves(argv[0], argv[1], values)
    print(f"wrote {argv[1]}: " + ", ".join(f"{k}={float(v)}" for k, v in done.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
