"""The port's learning record holds together: for every row of
LEARNING_TORCH.json, its campaign record (results_torch/<row>/campaign.json)
covers the row's epochs in contiguous chunks from epoch 0, all on one card
at one world size, through K1 and K2 on CUDA, and under one networks'
matmul rule: the one the port's learner now takes for the task's train yaml
("bf16 (autocast)" for a `mixed_precision` yaml, the `PPOConfig.net_matmul`
default for the rest, as scripts/train.py's device line names it). Reads
JSON and the yamls only: no training, no JAX."""

import json
import re
from pathlib import Path

import pytest

from omniisaacgymenvs_torch.learn import PPOConfig
from omniisaacgymenvs_torch.utils.config import load_config, ppo_config_kwargs

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results_torch"
LEARNING = json.loads((ROOT / "LEARNING_TORCH.json").read_text())
ROWS = sorted(LEARNING)
# Rows trained under an earlier default of the networks' rule, with the rule
# they ran under (their device lines predate the `networks:` field).
# ROADMAP.md §D queues each for a rerun under today's default; a row leaves
# this list when that rerun replaces it.
EARLIER_DEFAULT = {"AnymalTerrain": "f32", "ShadowHandOpenAI_FF": "f32"}
RULE = re.compile(r"networks: (.+)$")
RANKS = re.compile(r"\branks=(\d+)")


def record(row: str) -> dict:
    return json.loads((RESULTS / row / "campaign.json").read_text())


def default_rule(task: str) -> str:
    """The rule scripts/train.py names for `task` under its train yaml."""
    ppo = PPOConfig(**ppo_config_kwargs(load_config(dict(task=task))["train"]))
    return "bf16 (autocast)" if ppo.mixed_precision else ppo.net_matmul


def named_rules(rec: dict) -> set:
    return {m.group(1) for c in rec["chunks"] if (m := RULE.search(c["device_line"]))}


def test_earlier_default_rows_are_rows():
    assert set(EARLIER_DEFAULT) <= set(ROWS)


@pytest.mark.parametrize("row", ROWS)
def test_chunks_are_contiguous_from_epoch_0(row):
    chunks = record(row)["chunks"]
    assert chunks and chunks[0]["start"] == 0
    for a, b in zip(chunks, chunks[1:]):
        assert b["start"] == a["end"], (row, a["end"], b["start"])
    assert chunks[-1]["end"] == LEARNING[row]["epochs"]
    assert all(c["rc"] == 0 and c["end"] > c["start"] for c in chunks), row


@pytest.mark.parametrize("row", ROWS)
def test_chunks_name_one_card_and_one_world_size(row):
    rec = record(row)
    cards = {c.get("card") for c in rec["chunks"]}
    assert len(cards) == 1 and next(iter(cards)), (row, cards)
    world = rec["world_size"]
    assert isinstance(world, int) and world >= 1
    for c in rec["chunks"]:
        m = RANKS.search(c["device_line"])
        assert (int(m.group(1)) if m else 1) == world, (row, c["device_line"])


@pytest.mark.parametrize("row", ROWS)
def test_chunks_ran_k1_and_k2_on_cuda(row):
    rec = record(row)
    assert rec["device"] == "cuda"
    for c in rec["chunks"]:
        assert "device=cuda" in c["device_line"], (row, c["device_line"])
        assert c["launches"]["step"] > 0 and c["launches"]["fk"] > 0, (row, c["start"])


@pytest.mark.parametrize("row", ROWS)
def test_chunks_name_one_rule(row):
    assert len(named_rules(record(row))) <= 1, row


@pytest.mark.parametrize("row", ROWS)
def test_rule_is_the_learners_default_for_the_yaml(row):
    rec = record(row)
    now = default_rule(rec["task"])
    if row in EARLIER_DEFAULT:
        assert named_rules(rec) <= {EARLIER_DEFAULT[row]}, row
        assert EARLIER_DEFAULT[row] != now, f"{row} runs under today's default: drop it"
    else:
        assert named_rules(rec) == {now}, (row, named_rules(rec), now)
