"""Multi-GPU training on several cards: one process per GPU under NCCL,
against one card (`chip_smoke.py` holds the same on one card, with two gloo
ranks sharing it).

    python tools/multi_gpu_check.py [cards=4]

1. `torchrun --standalone --nproc_per_node=<cards> -m
   omniisaacgymenvs_torch.scripts.train task=Humanoid distributed=True
   num_envs=4096 max_iterations=2`: exit 0, finite metrics (rank 0 builds
   the kernels while the others wait at a barrier).
2. One f32 learner epoch of <cards> NCCL ranks (cuda:0 .. cuda:<cards-1>)
   on a stored rollout against the 1-rank epoch on cuda:0 with the ranks'
   permutations composed: every parameter within `chip_smoke.LEARNER_ATOL`,
   the ranks bitwise equal; the epoch's time per rank and at one rank.
3. 2 epochs through `PPOTrainer.train` on every rank (K1 once per control
   step on each card) and a checkpoint resumed at world size <cards> bit for
   bit.

Prints every card's name and power limit; exits non-zero on any failure
and without the cards.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    cards = int(args.get("cards", 4))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"multi_gpu_check: needs {cards} CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split("\n")
    card = "; ".join(x.strip() for x in lines[:cards])
    chip_smoke.log(f"cards: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    chip_smoke.distributed_phase(card, nccl_ranks=cards, ranks=cards, backend=None,
                                 device="cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
