"""The training campaign runner (omniisaacgymenvs_torch/scripts/campaign.py)
on the CPU: a campaign in two chunks, its run directory deleted between
them and restored from `out=`, equals the uninterrupted run (Cartpole, 64
envs); a chunk end off the save boundary, a device type or a world size
other than the campaign's are refused before any child starts; the
watchdog kills a child gone silent, with its process group, and the
campaign resumes from nn/last; a child past its timeout (exit 124) is not
retried; the suite's order and defaults; LEARNING_TORCH.json is what
scripts/make_learning_json.py makes of results_torch/; the carry of
several experiments' state between machines, and SIGTERM held while the
runner copies it. Every child has a timeout of
its own (the Cartpole children 120 s, phase 14's 300 s); chip_smoke.py's
phase 14 runs at a small size, both of its cases."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from omniisaacgymenvs_torch.scripts import campaign

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = "timeout_s=120"
# the limit of each chip_smoke.py phase-14 child: 7.4-10.5 s each with
# their start beside five other port test files under six workers, and up to
# 83 s before `light_children`; far from the suite's 1470 s
PHASE_TIMEOUT_S = 300
CARTPOLE = ["device=cpu", "num_envs=64", "seed=3", "max_iterations=4",
            "train.params.config.save_frequency=2", "train.params.config.save_best_after=1",
            CHILD_TIMEOUT]

# a stand-in for scripts/train.py: writes nn/last at the epoch it reaches and
# a history row per epoch; STUB_MODE "silent_once" goes silent on its first
# run after a checkpoint at epoch 2 (a grandchild in its process group),
# "slow" prints and never ends; every run appends its arguments to
# calls.jsonl and writes its pid to child.pid first, before it imports torch, so that a kill at timeout_s
# cannot come before the record. It prints while it imports torch, so that
# its silence starts where the mode says
STUB = '''
import json, os, subprocess, sys, threading, time
args = dict(a.split("=", 1) for a in sys.argv[1:])
mode = os.environ.get("STUB_MODE", "ok")
with open("calls.jsonl", "a") as f:
    f.write(json.dumps(args) + "\\n")
with open("child.pid", "w") as f:
    f.write(str(os.getpid()))
started = threading.Event()
def beat():
    while not started.wait(0.2):
        print("importing", flush=True)
threading.Thread(target=beat, daemon=True).start()
import torch
started.set()
run = os.path.join("runs", args["experiment"])
start = 0
if "checkpoint" in args:
    start = int(torch.load(os.path.join(args["checkpoint"], "model.pt"))["epoch"])
print(f"task={args['task']} num_envs=4 device=cpu seed=0", flush=True)
def save(epoch):
    os.makedirs(os.path.join(run, "nn", "last"), exist_ok=True)
    torch.save({"epoch": epoch}, os.path.join(run, "nn", "last", "model.pt"))
    with open(os.path.join(run, "history.json"), "w") as f:
        json.dump([{"epoch": e} for e in range(epoch)], f)
if mode == "silent_once" and start == 0:
    save(2)
    p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(300)"])
    with open("grandchild.pid", "w") as f:
        f.write(str(p.pid))
    time.sleep(300)
while mode == "slow":
    print("epoch", flush=True)
    time.sleep(0.2)
save(int(args["max_iterations"]))
print("trained 1 epochs (0 to 1), 1 env-steps in 1.0 s: 1,234.5 train-steps/s")
'''


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The runner's children are the stub, run in tmp_path; returns the
    list of each run's arguments."""
    (tmp_path / "stub_train.py").write_text(STUB)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(campaign, "TRAIN_MODULE", "stub_train")

    def calls():
        p = tmp_path / "calls.jsonl"
        return [json.loads(x) for x in p.read_text().splitlines()] if p.exists() else []
    return calls


@pytest.fixture
def light_children(tmp_path_factory, monkeypatch):
    """Children that train start light: they import torch.utils.tensorboard
    without TensorFlow (where TensorFlow is installed, TensorBoard imports
    it: some 11 s of a child's 17 s start-up on the CPU), through a
    `tensorflow` that raises ImportError at the head of PYTHONPATH, so that
    TensorBoard writes through its own stub; and they run torch on one
    thread (OMP_NUM_THREADS=1), where the test's worker shares the CPU
    with others."""
    d = tmp_path_factory.mktemp("light_children")
    (d / "tensorflow").mkdir()
    (d / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('TensorFlow is left out of this process')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(d)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _alive(pid: int, wait_s: float = 5.0) -> bool:
    """Whether pid is a live process (a zombie is not) after up to wait_s."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
        except FileNotFoundError:
            return False
        if state == "Z" or time.monotonic() > deadline:
            return state != "Z"
        time.sleep(0.1)


def _record(exp):
    return json.loads(Path("runs", exp, campaign.RECORD).read_text())


def test_chunked_campaign_equals_uninterrupted_run(tmp_path, monkeypatch, light_children):
    monkeypatch.chdir(tmp_path)
    run = campaign.main
    assert run(["whole", "Cartpole", *CARTPOLE]) == 0
    chunked = ["chunked", "Cartpole", *CARTPOLE, "chunk=2", "out=carried"]
    assert run(chunked) == 0
    assert campaign.checkpoint_epoch("runs/chunked/nn/last") == 2
    assert sorted(os.listdir("carried/chunked")) == sorted(
        ["campaign.json", "config.json", "history.json", "nn"])
    assert sorted(os.listdir("carried/chunked/nn")) == ["best", "best_meta.json", "last"]
    shutil.rmtree("runs/chunked")          # what a new machine sees
    assert run(chunked) == 0
    assert campaign.unequal_runs("runs/whole", "runs/chunked") == []
    hist = json.loads(Path("runs/chunked/history.json").read_text())
    assert [m["epoch"] for m in hist] == [0, 1, 2, 3]
    rec = _record("chunked")
    assert [(c["start"], c["end"], c["rc"]) for c in rec["chunks"]] == [(0, 2, 0), (2, 4, 0)]
    assert rec["device"] == "cpu" and rec["world_size"] == 1
    assert all(c["device_line"].startswith("task=Cartpole") for c in rec["chunks"])
    # the budget is reached: a further invocation runs no child
    assert run(chunked) == 0
    assert len(_record("chunked")["chunks"]) == 2


def test_unequal_runs_names_what_differs(tmp_path, monkeypatch):
    """The comparison the chunked run is held to sees a changed history
    value and a leaf one bit off."""
    monkeypatch.chdir(tmp_path)
    for d, bit in (("a", 0), ("b", 1)):
        os.makedirs(f"{d}/nn/last")
        x = torch.tensor([1.0, 2.0])
        x.view(torch.int32)[1] += bit
        torch.save({"epoch": 2, "w": x}, f"{d}/nn/last/model.pt")
        torch.save({"epoch": 2}, f"{d}/nn/last/env.pt")
        Path(f"{d}/history.json").write_text(json.dumps(
            [{"epoch": 0, "kl": 0.1 + bit, "steps_per_sec": 5.0 + bit}]))
    assert campaign.unequal_runs("a", "a") == []
    assert campaign.unequal_runs("a", "b") == ["history.json epoch 0: ['kl']",
                                               "nn/last/model.pt: w"]


@pytest.mark.parametrize("args, end, freq", [
    (["max_iterations=4", "chunk=3"], 3, 2),
    (["max_iterations=5", "chunk=2"], 5, 2),
    (["chunk=40"], 40, 25),             # CartpolePPO.yaml: 100 epochs, every 25
])
def test_chunk_end_off_the_save_boundary_is_refused(stub, args, end, freq, capsys):
    cli = ["ex", "Cartpole", "device=cpu", *args]
    if freq == 2:
        cli.append("train.params.config.save_frequency=2")
    assert campaign.main(cli) == 2
    err = capsys.readouterr().err
    assert f"chunk end {end} " in err and f"save_frequency is {freq}" in err
    assert stub() == [] and not os.path.exists("runs/ex")


@pytest.mark.parametrize("recorded, cli", [
    (dict(device="cuda", world_size=1), []),
    (dict(device="cpu", world_size=2), []),
    (dict(device="cpu", world_size=1), ["nproc=2"]),
])
@pytest.mark.parametrize("where", ["runs", "out"])
def test_another_device_or_world_size_is_refused(stub, recorded, cli, where, capsys):
    """campaign.json in the run directory, or restored from out= with
    nn/last, fixes the device type and world size."""
    d = Path("runs/ex") if where == "runs" else Path("carried/ex")
    (d / "nn" / "last").mkdir(parents=True)
    torch.save({"epoch": 2}, d / "nn" / "last" / "model.pt")
    (d / campaign.RECORD).write_text(json.dumps(dict(
        experiment="ex", task="Cartpole", chunks=[], **recorded)))
    code = campaign.main(["ex", "Cartpole", "device=cpu", "max_iterations=4", "chunk=2",
                          "train.params.config.save_frequency=2", "out=carried", *cli])
    assert code == 2
    err = capsys.readouterr().err
    assert f"on {recorded['device']} at world size {recorded['world_size']}" in err
    assert stub() == []


def test_the_runner_sets_its_own_root_keys(stub, capsys):
    assert campaign.main(["ex", "Cartpole", "checkpoint=runs/x/nn/last"]) == 2
    assert "sets checkpoint= itself" in capsys.readouterr().err
    assert stub() == []


def test_watchdog_kills_a_silent_child_and_resumes_from_last(stub, monkeypatch):
    monkeypatch.setenv("STUB_MODE", "silent_once")
    code = campaign.main(["ex", "Cartpole", "device=cpu", "max_iterations=4",
                          "watchdog_s=5", "retries=1", CHILD_TIMEOUT])
    assert code == 0
    calls = stub()
    assert len(calls) == 2 and "checkpoint" not in calls[0]
    assert calls[1]["checkpoint"] == os.path.join("runs", "ex", "nn", "last")
    assert calls[1]["max_iterations"] == "4"
    assert "--- watchdog: silent" in Path("runs/logs/ex.try1.log").read_text()
    assert "trained" in Path("runs/logs/ex.log").read_text()
    # the silent child's grandchild went with its process group
    assert not _alive(int(Path("grandchild.pid").read_text()))
    (chunk,) = _record("ex")["chunks"]
    assert (chunk["start"], chunk["end"], chunk["rc"], chunk["retries"]) == (0, 4, 0, 1)
    assert chunk["train_steps_per_sec"] == 1234.5


def test_timeout_is_not_retried(stub, monkeypatch):
    monkeypatch.setenv("STUB_MODE", "slow")
    code = campaign.main(["ex", "Cartpole", "device=cpu", "max_iterations=4",
                          "timeout_s=3", "watchdog_s=30", "retries=3"])
    assert code == campaign.TIMEOUT_RC == 124
    assert len(stub()) == 1
    (chunk,) = _record("ex")["chunks"]
    assert (chunk["rc"], chunk["retries"]) == (124, 0)
    assert "--- timeout: past 3 s" in Path("runs/logs/ex.log").read_text()


def test_until_s_runs_the_chunks_that_fit(stub):
    """One chunk an invocation, or with until_s every chunk that fits."""
    cli = ["ex", "Cartpole", "device=cpu", "max_iterations=6", "chunk=2",
           "train.params.config.save_frequency=2", CHILD_TIMEOUT]
    assert campaign.main(cli) == 0
    assert [c["max_iterations"] for c in stub()] == ["2"]
    assert campaign.main(cli + ["until_s=600"]) == 0
    assert [c["max_iterations"] for c in stub()] == ["2", "4", "6"]
    assert [c.get("checkpoint") for c in stub()][1:] == ["runs/ex/nn/last"] * 2
    assert [(c["start"], c["end"]) for c in _record("ex")["chunks"]] == [
        (0, 2), (2, 4), (4, 6)]


def test_suite_order_and_defaults(monkeypatch):
    seen = []

    def run(exp, task, overrides, opts):
        seen.append((exp, task, list(overrides), opts))
        return 0 if task != "Ant" else 1

    monkeypatch.setattr(campaign, "run_experiment", run)
    assert campaign.main(["all", "device=cpu"]) == 1
    assert [s[1] for s in seen] == list(campaign.SUITE)
    assert campaign.SUITE[:3] == ("Cartpole", "Ant", "Humanoid")
    assert all(e == t and o == ["device=cpu"] for e, t, o, _ in seen)
    assert seen[0][3] == dict(campaign.DEFAULTS, retries=1, timeout_s=5400.0)
    seen.clear()
    assert campaign.main(["all", "Cartpole", "AnymalTerrain", "retries=2", "chunk=50"]) == 0
    assert [s[1] for s in seen] == ["Cartpole", "AnymalTerrain"]
    assert seen[1][3]["retries"] == 2 and seen[1][3]["chunk"] == 50


def test_learning_torch_json_is_made_from_results_torch():
    out = subprocess.run(
        [sys.executable, "scripts/make_learning_json.py", "results_torch"],
        cwd=ROOT, capture_output=True, text=True, timeout=60, check=True).stdout
    assert json.loads((ROOT / "LEARNING_TORCH.json").read_text()) == json.loads(out)
    rows = json.loads(out)
    for task, row in rows.items():
        assert (ROOT / "results_torch" / task / "card.txt").read_text().strip(), task
        assert row["epochs"] == len(json.loads(
            (ROOT / "results_torch" / task / "history.json").read_text())), task


@pytest.mark.parametrize("case", ["terrain", "dr"])
def test_chip_smoke_campaign_phase_on_the_cpu(tmp_path, monkeypatch, light_children, case):
    """chip_smoke.py's phase 14 at a small size on the CPU, each case in
    one chunk and in two, runs/ deleted between them: histories equal but
    steps_per_sec, nn/last bitwise (the launch counts are checked on the
    card only). AnymalTerrain: 64 envs, a 3 x 5 terrain grid, 4 epochs of
    8 steps; ShadowHand_DR: the hand under its randomization block, 64
    envs, 2 epochs of 8 steps."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    assert [c["exp"] for c in chip_smoke.CAMPAIGNS] == ["terrain", "dr"]
    small = ("num_envs=64", "train.params.config.horizon_length=8",
             "train.params.config.minibatch_size=256")
    chip_smoke.campaign_phase(str(tmp_path), "cpu", device="cpu", timeout_s=PHASE_TIMEOUT_S,
                              cases=[case],
                              extra=dict(terrain=(*small, "task.env.terrain.numLevels=3",
                                                  "task.env.terrain.numTerrains=5"),
                                         dr=small))
    (c,) = [c for c in chip_smoke.CAMPAIGNS if c["exp"] == case]
    whole, chunked = (tmp_path / "runs" / f"{case}_{k}" for k in ("whole", "chunked"))
    assert campaign.unequal_runs(str(whole), str(chunked)) == []
    rec = json.loads((chunked / campaign.RECORD).read_text())
    ends = list(range(c["chunk"], c["epochs"] + 1, c["chunk"]))
    assert [(ch["start"], ch["end"]) for ch in rec["chunks"]] == list(
        zip([0, *ends[:-1]], ends))
    assert f"task={c['task']} num_envs=64" in rec["chunks"][0]["device_line"]
    assert campaign.finished(rec) and rec["budget"] == c["epochs"]


def _fake_run(out, exp, epoch, budget, end):
    """A carried run directory: nn/last and nn/best at `epoch`, its
    record's last chunk ending at `end` of `budget`."""
    d = out / exp
    for which in ("last", "best"):
        (d / "nn" / which).mkdir(parents=True)
        torch.save({"epoch": epoch, "w": torch.arange(4.0) + epoch},
                   d / "nn" / which / "model.pt")
        torch.save({"epoch": epoch}, d / "nn" / which / "env.pt")
    (d / "nn" / "best_meta.json").write_text(json.dumps({"epoch": epoch}))
    (d / "history.json").write_text(json.dumps([{"epoch": e} for e in range(epoch)]))
    (d / campaign.RECORD).write_text(json.dumps(dict(
        experiment=exp, task="Cartpole", device="cuda", world_size=1, budget=budget,
        chunks=[dict(start=0, end=end, rc=0)])))


def _unpack(out, into):
    import tarfile

    for a in sorted(Path(out).glob("*.tar.gz")):
        with tarfile.open(a) as tar:
            tar.extractall(into, filter="data")
    return sorted(str(p.relative_to(into)) for p in Path(into).rglob("*") if p.is_file())


def test_carry_trims_and_packs_the_state(tmp_path, monkeypatch, capsys):
    """carry: every nn/best goes, so does a finished run's nn/last; each
    experiment is packed into DIR/<exp>.tar.gz and unpacks to the files
    left."""
    monkeypatch.chdir(tmp_path)
    _fake_run(Path("out"), "done", 4, 4, 4)
    _fake_run(Path("out"), "going", 2, 4, 2)
    before = (Path("out/going/nn/last/model.pt")).read_bytes()
    assert campaign.main(["carry", "out"]) == 0
    assert sorted(os.listdir("out")) == ["done.tar.gz", "going.tar.gz"]
    assert _unpack("out", "back") == [
        "done/campaign.json", "done/history.json", "done/nn/best_meta.json",
        "going/campaign.json", "going/history.json", "going/nn/best_meta.json",
        "going/nn/last/env.pt", "going/nn/last/model.pt"]
    assert Path("back/going/nn/last/model.pt").read_bytes() == before
    out = capsys.readouterr().out
    assert "=== carry done: done at epoch 4, nn/last deleted" in out
    size = campaign.du("back/going/nn/last")
    assert f"=== carry going: nn/last of epoch 2, {size} B (du -sb)" in out
    assert f"out/going.tar.gz {campaign.du('out/going.tar.gz')} B" in out


def test_carry_over_the_limit_drops_the_largest_last(tmp_path, monkeypatch, capsys):
    """The archives get the tool's cap less what the rest of DIR's parent
    holds; over it the largest nn/last is dropped, and the records and the
    other nn/last travel."""
    monkeypatch.chdir(tmp_path)
    _fake_run(Path("out"), "small", 2, 4, 2)
    _fake_run(Path("out"), "large", 2, 4, 2)
    torch.save({"epoch": 2, "w": torch.randn(100_000)}, "out/large/nn/last/model.pt")
    room = 100_000
    with open("other.log", "wb") as f:  # sparse: du -sb counts its length
        f.truncate(campaign.CARRY_CAP - room)
    assert campaign.main(["carry", "out"]) == 1
    files = _unpack("out", "back")
    assert "small/nn/last/model.pt" in files and "large/history.json" in files
    assert not any(f.startswith("large/nn/last") for f in files)
    out = capsys.readouterr().out
    assert f"=== carry: room {room} B" in out
    assert f"=== carry large: over {room} B, nn/last dropped (the largest)" in out
    assert campaign.du("out") <= room
    assert campaign.main(["carry", "out", "limit_mb=1"]) == 2
    assert campaign.main(["carry", "out", "now"]) == 2


def test_sigterm_waits_for_copy_state(tmp_path, monkeypatch):
    """SIGTERM to the runner between the removal of the carried nn/last
    and the rename of its new copy waits for the copy to end: the runner
    exits 143 with every carried file in place."""
    monkeypatch.chdir(tmp_path)
    _fake_run(Path("runs"), "ex", 4, 8, 4)
    _fake_run(Path("out"), "ex", 2, 8, 2)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    code = ("import os, signal; from omniisaacgymenvs_torch.scripts import campaign as c\n"
            "signal.signal(signal.SIGTERM, c.on_sigterm)\n"
            "remove = c._remove\n"
            "def _remove(path):\n"
            "    remove(path)\n"
            "    if path == os.path.join('out', 'ex', 'nn', 'last'):\n"
            "        os.kill(os.getpid(), signal.SIGTERM)\n"
            "c._remove = _remove\n"
            "c.copy_state(os.path.join('runs', 'ex'), os.path.join('out', 'ex'))\n"
            "print('not stopped')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 143 and "not stopped" not in p.stdout, p.stderr
    for rel in ("history.json", campaign.RECORD, "nn/best_meta.json", "nn/last/model.pt",
                "nn/last/env.pt", "nn/best/model.pt"):
        assert (Path("out/ex") / rel).read_bytes() == (Path("runs/ex") / rel).read_bytes(), rel
    assert not list(Path("out").rglob("*.tmp"))


def test_a_terminated_runner_takes_its_child(stub, tmp_path, monkeypatch):
    """SIGTERM to the runner kills the training child's process group and
    records no chunk."""
    import signal

    monkeypatch.setenv("STUB_MODE", "slow")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), str(ROOT)]))
    code = ("import signal, sys; from omniisaacgymenvs_torch.scripts import campaign as c; "
            "c.TRAIN_MODULE = 'stub_train'; signal.signal(signal.SIGTERM, c.on_sigterm); "
            "sys.exit(c.main(sys.argv[1:]))")
    p = subprocess.Popen([sys.executable, "-c", code, "ex", "Cartpole", "device=cpu",
                          "max_iterations=4", CHILD_TIMEOUT], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    for line in p.stdout:
        if line.startswith("epoch"):
            break
    pid = int(Path("child.pid").read_text())
    assert _alive(pid, 0)
    p.send_signal(signal.SIGTERM)
    p.communicate(timeout=120)
    assert p.returncode == 143
    assert not _alive(pid)
    assert len(stub()) == 1 and not Path("runs/ex", campaign.RECORD).exists()
