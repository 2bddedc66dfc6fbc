"""Training campaigns: one experiment through `scripts/train.py` in a child
process, watched, resumed and cut into chunks, or the suite at its train
yamls' budgets (the port's counterpart of the JAX package's
scripts/run_task.sh and scripts/train_all.sh).

    python -m omniisaacgymenvs_torch.scripts.campaign <experiment> <task> \
        [override ...] [chunk=N] [until_s=S] [out=DIR] [watchdog_s=600] \
        [retries=3] [timeout_s=7000] [nproc=1]
    python -m omniisaacgymenvs_torch.scripts.campaign all [task ...] [option ...]
    python -m omniisaacgymenvs_torch.scripts.campaign carry DIR

One experiment runs `python -u -m omniisaacgymenvs_torch.scripts.train
task=<task> experiment=<experiment> <override ...>` in a session of its
own, its output echoed and kept in runs/logs/<experiment>.log; it starts
from runs/<experiment>/nn/last where there is one. The watchdog kills the
child's process group after `watchdog_s` seconds without a line of output.
Its clock runs from the child's start, so the default of 600 s covers the
first epoch of a fresh tree: the nvcc build of both kernel sources (a
minute at most) and AnymalTerrain's terrain build (some 3 s). A child that
fails (a watchdog kill counts as a failure, exit 99) is resumed from
runs/<experiment>/nn/last up to `retries` times, each earlier log renamed
to .tryK; one that outlives `timeout_s` is killed and exits 124, which is
not retried. `nproc=N` runs the child under torch.distributed.run with N
ranks (`distributed=True`). SIGTERM to the runner kills the child's process
group and exits 143, but waits while the runner writes campaign.json and
copies the state to `out=`: a run stopped there is never left without its
nn/last.

Chunks: with chunk=N a child stops after epoch k*N (it is passed
max_iterations=k*N, an absolute epoch); the last chunk ends at the budget,
the train yaml's max_epochs or `max_iterations=`. scripts/train.py saves
nn/last only after epochs that are multiples of the yaml's save_frequency,
so a chunk end off that boundary is refused before any child starts. An
invocation runs the next chunk from the checkpoint's epoch; with until_s=S
it goes on to the one after while a chunk as long as the last one still
fits in S seconds from the runner's start (the last, not the longest: a
chunk that shared the card with other runs says little of the next).

State across machines: with out=DIR the runner copies history.json,
config.json, campaign.json, nn/last, nn/best and nn/best_meta.json from
runs/<experiment>/ to DIR/<experiment>/ after every chunk, and back before
a chunk where runs/<experiment>/nn/last is missing: a resumed run keeps its
earlier history rows and its best so far from these files. campaign.json
records the device type and world size of the first chunk, and a later
chunk on another is refused (a checkpoint restores its random generators
only on its own device type, and its env state only at its world size);
it also records every chunk: its epochs, exit code, retries, wall, the
child's start-up (to its first epoch line), train-steps/s, kernel launches
and device line, and the card.

Carrying several experiments between machines whose outputs are capped
(`carry DIR`, run after the campaigns of a machine have ended): every
nn/best under DIR/<experiment>/ is deleted (nn/best_meta.json keeps the
watermark), so is the nn/last of each experiment whose record reached its
budget; the `du -sb` of each nn/last left is printed, and each
DIR/<experiment>/ is packed into DIR/<experiment>.tar.gz (gzip: the float
state packs to some 80-93%) and removed. DIR lies in the directory the
chip tool brings back, whose cap is `CARRY_CAP` (64 MiB) in all; the
archives may take the cap less what the rest of DIR's parent holds. A call
can pass it: ShadowHand_DR's archive (56 MB at 16384 envs) beside a
ShadowHand nn/last (26 MB) does, and past the cap the tool brings back
nothing. So while the archives are over, the largest nn/last is dropped and
its experiment packed again (exit code 1): the records always travel. The
next machine unpacks them (`tar xzf DIR/<experiment>.tar.gz -C DIR`)
before the campaigns resume from out=DIR.

The suite runs each task (default: every reference task, in train_all.sh's
order) as an experiment of its own name at its budget, with retries=1 and
timeout_s=5400 unless given.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

from omniisaacgymenvs_torch.utils.config import load_config, parse_cli

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SUITE = ("Cartpole", "Ant", "Humanoid", "Anymal", "AnymalTerrain", "BallBalance",
         "FrankaCabinet", "Ingenuity", "Quadcopter", "Crazyflie", "AllegroHand",
         "ShadowHand", "ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM")
# the runner's own options and run_task.sh's defaults; the suite's differ
DEFAULTS = dict(chunk=0, until_s=0.0, out="", watchdog_s=600.0, retries=3,
                timeout_s=7000.0, nproc=1)
SUITE_DEFAULTS = dict(retries=1, timeout_s=5400.0)
# root keys the runner sets itself
MANAGED = ("task", "experiment", "checkpoint", "test", "distributed")
RECORD = "campaign.json"
CARRIED = ("history.json", "config.json", RECORD, "nn/last", "nn/best",
           "nn/best_meta.json")
WATCHDOG_RC, TIMEOUT_RC = 99, 124
# what the chip tool brings back of a call's output directory
CARRY_CAP = 64 * 2 ** 20
TRAIN_MODULE = "omniisaacgymenvs_torch.scripts.train"
TRAINED = re.compile(r"^trained .*: ([\d,.]+) train-steps/s")
LAUNCHES = "kernel launches over the training "


class Refused(ValueError):
    """A campaign the runner will not start: no child was run."""


def log(msg: str):
    print(msg, flush=True)


def split_args(argv):
    """(the runner's options given, the train overrides) of key=value
    arguments."""
    given, overrides = {}, []
    for a in argv:
        if "=" not in a:
            raise Refused(f"arguments must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        if k in DEFAULTS:
            given[k] = type(DEFAULTS[k])(v)
        else:
            overrides.append(a)
    return given, overrides


def budget_of(task: str, overrides) -> tuple:
    """(last epoch, save_frequency, device type) of `task` under the
    overrides, as scripts/train.py reads them."""
    cfg = load_config(dict(parse_cli(overrides), task=task))
    c = cfg["train"].get("params", {}).get("config", {})
    budget = int(cfg["max_iterations"] or c.get("max_epochs", 100))
    return budget, int(c.get("save_frequency", 50)), str(cfg["device"]).split(":")[0]


def chunk_ends(budget: int, chunk: int, save_frequency: int) -> list:
    """The epochs the chunks end at; refused where one is off the save
    boundary."""
    ends = list(range(chunk, budget, chunk)) + [budget]
    for e in ends:
        if e % save_frequency:
            raise Refused(
                f"chunk end {e} is off the save boundary: save_frequency is "
                f"{save_frequency}, and scripts/train.py saves nn/last only after "
                f"epochs that are multiples of it")
    return ends


def checkpoint_epoch(path: str) -> int:
    """The epoch a checkpoint directory resumes at."""
    import torch

    return int(torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                          weights_only=True)["epoch"])


def _remove(path: str):
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


_TERM = dict(held=0, pending=False)


def on_sigterm(*_):
    """A runner terminated takes its child's process group with it
    (run_child's finally) and records no chunk; inside `sigterm_held` it
    exits when the block ends."""
    if _TERM["held"]:
        _TERM["pending"] = True
    else:
        sys.exit(143)


@contextlib.contextmanager
def sigterm_held():
    """SIGTERM (on_sigterm) waits for the end of the block, so that what
    the block writes is never left half done."""
    _TERM["held"] += 1
    try:
        yield
    finally:
        _TERM["held"] -= 1
        if not _TERM["held"] and _TERM["pending"]:
            sys.exit(143)


def copy_state(src: str, dst: str):
    """Copy the carried files of a run directory, each put in place by a
    rename, SIGTERM held until all are."""
    with sigterm_held():
        for rel in CARRIED:
            s, d = os.path.join(src, rel), os.path.join(dst, rel)
            if not os.path.exists(s):
                continue
            os.makedirs(os.path.dirname(d), exist_ok=True)
            tmp = d + ".tmp"
            _remove(tmp)
            if os.path.isdir(s):
                shutil.copytree(s, tmp)
            else:
                shutil.copy2(s, tmp)
            _remove(d)
            os.replace(tmp, d)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _kill_group(p: subprocess.Popen):
    """SIGTERM to the child's process group, SIGKILL after 5 s."""
    for sig, wait in ((signal.SIGTERM, 5), (signal.SIGKILL, 30)):
        try:
            os.killpg(p.pid, sig)
        except ProcessLookupError:
            break
        try:
            p.wait(timeout=wait)
        except subprocess.TimeoutExpired:
            pass


def run_child(cmd, log_path: str, watchdog_s: float, timeout_s: float, echo=None):
    """Run cmd in a session of its own, its output written to log_path and
    echoed; (exit code, what it reported). Killed with its process group
    after watchdog_s without output (exit WATCHDOG_RC) or past timeout_s
    (exit TIMEOUT_RC)."""
    echo = echo or sys.stdout
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [PKG_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    info = {}
    start = time.monotonic()
    with open(log_path, "w") as logf:
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, errors="replace", start_new_session=True,
                             env=env)
        last = [start]

        def pump():
            for line in p.stdout:
                last[0] = time.monotonic()
                logf.write(line)
                logf.flush()
                echo.write(line)
                echo.flush()
                if line.startswith("epoch ") and "startup_s" not in info:
                    info["startup_s"] = round(last[0] - start, 1)
                m = TRAINED.match(line)
                if m:
                    info["train_steps_per_sec"] = float(m.group(1).replace(",", ""))
                elif line.startswith(LAUNCHES):
                    info["launches"] = json.loads(line[len(LAUNCHES):])
                elif line.startswith("task=") and "device=" in line:
                    info["device_line"] = line.strip()

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        note = None
        poll = min(1.0, watchdog_s / 4)
        try:
            while True:
                try:
                    rc = p.wait(timeout=poll)
                    break
                except subprocess.TimeoutExpired:
                    pass
                now = time.monotonic()
                if now - start > timeout_s:
                    note, rc = f"timeout: past {timeout_s:g} s", TIMEOUT_RC
                elif now - last[0] > watchdog_s:
                    note = f"watchdog: silent {now - last[0]:.0f} s"
                    rc = WATCHDOG_RC
                else:
                    continue
                break
        finally:
            _kill_group(p)
            reader.join(timeout=30)
        if note:
            logf.write(f"--- {note}, killed the process group {p.pid}\n")
            echo.write(f"--- {note}, killed the process group {p.pid}\n")
    return rc, info


def run_experiment(exp: str, task: str, overrides, opts: dict) -> int:
    """Run the next chunk of `exp` (or, with until_s, the chunks that fit);
    the exit code of the last child, 0 when the budget is reached."""
    for a in overrides:
        if a.split("=", 1)[0] in MANAGED:
            raise Refused(f"{a!r}: the runner sets {a.split('=', 1)[0]}= itself")
    budget, save_frequency, device = budget_of(task, overrides)
    ends = (chunk_ends(budget, opts["chunk"], save_frequency) if opts["chunk"]
            else [budget])
    run_dir = os.path.join("runs", exp)
    last = os.path.join(run_dir, "nn", "last")
    out = os.path.join(opts["out"], exp) if opts["out"] else None
    if out and not os.path.isdir(last) and os.path.isdir(os.path.join(out, "nn", "last")):
        copy_state(out, run_dir)
        log(f"=== {exp}: restored {', '.join(CARRIED)} from {out}")
    record_path = os.path.join(run_dir, RECORD)
    world = int(opts["nproc"])
    try:
        with open(record_path) as f:
            record = json.load(f)
    except FileNotFoundError:
        record = dict(experiment=exp, task=task, device=device, world_size=world,
                      chunks=[])
    record["budget"] = budget
    if (record["task"], record["device"], record["world_size"]) != (task, device, world):
        raise Refused(
            f"{exp} was trained as task {record['task']} on {record['device']} at "
            f"world size {record['world_size']}; this chunk is task {task} on "
            f"{device} at world size {world}")
    train = ["-m", TRAIN_MODULE, f"task={task}",
             f"experiment={exp}",
             *[a for a in overrides if a.split("=", 1)[0] != "max_iterations"]]
    if world > 1:
        train = ["-m", "torch.distributed.run", "--standalone",
                 f"--nproc_per_node={world}", *train, "distributed=True"]
    card = card_line() if device == "cuda" else None
    os.makedirs(os.path.join("runs", "logs"), exist_ok=True)
    log_path = os.path.join("runs", "logs", f"{exp}.log")
    t_start, last_wall, rc = time.monotonic(), 0.0, 0
    while True:
        start = checkpoint_epoch(last) if os.path.isdir(last) else 0
        if start >= budget:
            log(f"=== {exp}: done, {budget} epochs")
            break
        if last_wall and not (opts["until_s"] and
                              time.monotonic() - t_start + last_wall <= opts["until_s"]):
            break
        end = next(e for e in ends if e > start)
        t0, tries = time.monotonic(), 0
        while True:
            resume = [f"checkpoint={last}"] if os.path.isdir(last) else []
            begin = checkpoint_epoch(last) if resume else 0
            log(f"=== {exp} (task={task}): epochs {begin} to {end} of {budget}"
                + (f" on {card}" if card else ""))
            rc, info = run_child([sys.executable, "-u", *train, f"max_iterations={end}",
                                  *resume], log_path, opts["watchdog_s"],
                                 opts["timeout_s"])
            if rc == 0 and opts["chunk"] and checkpoint_epoch(last) != end:
                log(f"=== {exp}: the child exited 0 but nn/last is of epoch "
                    f"{checkpoint_epoch(last)}, not {end}")
                rc = 1
            if rc in (0, TIMEOUT_RC) or tries >= opts["retries"]:
                break
            tries += 1
            log(f"=== {exp} rc={rc}; retry {tries}/{opts['retries']}")
            os.replace(log_path, os.path.join("runs", "logs", f"{exp}.try{tries}.log"))
        wall = last_wall = time.monotonic() - t0
        record["chunks"].append(dict(start=start, end=end, rc=rc, retries=tries,
                                     wall_s=round(wall, 1), card=card, **info))
        os.makedirs(run_dir, exist_ok=True)
        with sigterm_held():
            with open(record_path, "w") as f:
                json.dump(record, f, indent=1)
            if out:
                copy_state(run_dir, out)
        log(f"=== {exp}: epochs {start} to {end} rc={rc} in {wall:.1f} s")
        if rc:
            break
    return rc


def run_suite(tasks, given: dict, overrides) -> int:
    opts = {**DEFAULTS, **SUITE_DEFAULTS, **given}
    rcs = {}
    for t in tasks or SUITE:
        try:
            rcs[t] = run_experiment(t, t, overrides, opts)
        except Refused as e:
            log(f"=== {t}: refused: {e}")
            rcs[t] = 2
    log("=== suite: " + ", ".join(f"{t} rc={rc}" for t, rc in rcs.items()))
    return 0 if not any(rcs.values()) else 1


def finished(record: dict) -> bool:
    """Whether a campaign record's last chunk reached its budget."""
    chunks = record.get("chunks") or []
    return bool(chunks) and "budget" in record and (
        chunks[-1]["rc"] == 0 and chunks[-1]["end"] >= record["budget"])


def du(path: str) -> int:
    """Bytes of the files under path, as `du -sb` counts them."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _pack(out: str, exp: str) -> str:
    """out/<exp>/ packed into out/<exp>.tar.gz; the archive's path."""
    import tarfile

    archive = os.path.join(out, exp + ".tar.gz")
    with tarfile.open(archive + ".tmp", "w:gz", compresslevel=6) as tar:
        tar.add(os.path.join(out, exp), arcname=exp)
    os.replace(archive + ".tmp", archive)
    return archive


def carry(out: str) -> int:
    """Trim out/ and pack each experiment into out/<exp>.tar.gz (module
    docstring); 0, or 1 when the archives were over their room and a
    checkpoint was dropped to fit."""
    parent = os.path.dirname(os.path.abspath(out))
    room = CARRY_CAP - sum(du(os.path.join(parent, e)) for e in os.listdir(parent)
                           if os.path.join(parent, e) != os.path.abspath(out))
    log(f"=== carry: room {room} B ({CARRY_CAP} B less the rest of {parent})")
    exps = sorted(e for e in os.listdir(out) if os.path.isdir(os.path.join(out, e)))
    lasts = {}
    for exp in exps:
        d = os.path.join(out, exp)
        _remove(os.path.join(d, "nn", "best"))
        try:
            with open(os.path.join(d, RECORD)) as f:
                record = json.load(f)
        except FileNotFoundError:
            record = {}
        last = os.path.join(d, "nn", "last")
        if finished(record) and os.path.isdir(last):
            _remove(last)
            log(f"=== carry {exp}: done at epoch {record['budget']}, nn/last deleted")
        elif os.path.isdir(last):
            lasts[exp] = du(last)
            log(f"=== carry {exp}: nn/last of epoch {checkpoint_epoch(last)}, "
                f"{lasts[exp]} B (du -sb)")
    sizes = {exp: du(_pack(out, exp)) for exp in exps}
    rc = 0
    while sum(sizes.values()) > room and lasts:
        exp = max(lasts, key=lasts.get)
        del lasts[exp]
        _remove(os.path.join(out, exp, "nn", "last"))
        sizes[exp] = du(_pack(out, exp))
        rc = 1
        log(f"=== carry {exp}: over {room} B, nn/last dropped (the largest)")
    for exp in exps:
        _remove(os.path.join(out, exp))
        log(f"=== carry: {os.path.join(out, exp)}.tar.gz {sizes[exp]} B (du -sb)")
    log(f"=== carry: {sum(sizes.values())} B in {len(exps)} archives")
    return rc


def _equal(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def unequal_runs(a: str, b: str) -> list:
    """Where two run directories differ: history.json rows in any key but
    steps_per_sec (wall clock), and nn/last leaves not bitwise equal."""
    import torch

    diffs = []
    hist = []
    for d in (a, b):
        with open(os.path.join(d, "history.json")) as f:
            hist.append(json.load(f))
    if len(hist[0]) != len(hist[1]):
        diffs.append(f"history.json: {len(hist[0])} rows against {len(hist[1])}")
    for ra, rb in zip(*hist):
        bad = sorted(k for k in set(ra) | set(rb)
                     if k != "steps_per_sec" and not _equal(ra.get(k), rb.get(k)))
        if bad:
            diffs.append(f"history.json epoch {ra.get('epoch')}: {bad}")
    for name in ("model.pt", "env.pt"):
        la, lb = (torch.load(os.path.join(d, "nn", "last", name), map_location="cpu",
                             weights_only=True) for d in (a, b))
        if sorted(la) != sorted(lb):
            diffs.append(f"nn/last/{name}: leaves {sorted(set(la) ^ set(lb))}")
            continue
        for k, va in la.items():
            vb = lb[k]
            if isinstance(va, torch.Tensor):
                same = (isinstance(vb, torch.Tensor) and va.dtype == vb.dtype
                        and va.shape == vb.shape
                        and torch.equal(va.reshape(-1).view(torch.uint8),
                                        vb.reshape(-1).view(torch.uint8)))
            else:
                same = _equal(va, vb)
            if not same:
                diffs.append(f"nn/last/{name}: {k}")
    return diffs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        if argv[:1] == ["carry"] and len(argv) >= 2:
            if len(argv) > 2:
                raise Refused(f"carry takes a directory only, got {argv[2:]}")
            return carry(argv[1])
        if argv[:1] == ["all"]:
            given, overrides = split_args([a for a in argv[1:] if "=" in a])
            return run_suite([a for a in argv[1:] if "=" not in a], given, overrides)
        if len(argv) < 2 or "=" in argv[0] or "=" in argv[1]:
            print(__doc__, file=sys.stderr)
            return 2
        given, overrides = split_args(argv[2:])
        return run_experiment(argv[0], argv[1], overrides, {**DEFAULTS, **given})
    except Refused as e:
        print(f"campaign: refused: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, on_sigterm)
    sys.exit(main())
