"""The port imports neither JAX nor Flax nor anything of the JAX package,
nor the JAX package's root scripts/: an ast scan of every file of
omniisaacgymenvs_torch/, of chip_smoke.py, of bench_torch.py, of
tools/conditioning_probe.py and of tests/torch_checkpoint_set.py (it runs
on the GPU machine, which has no JAX), and a fresh interpreter that
imports the whole port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "omniisaacgymenvs_tpu", "scripts")
PORT_FILES = sorted((ROOT / "omniisaacgymenvs_torch").rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                          ROOT / "tools" / "conditioning_probe.py",
                          ROOT / "tests" / "torch_checkpoint_set.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_checkpoint_modules():
    """The port's own copy of utils/paths.py and its play script are
    scanned like every other module (the JAX package's utils/paths.py
    imports no JAX, but the port keeps its own)."""
    for rel in ("utils/paths.py", "scripts/play.py", "scripts/train.py",
                "learn/ppo.py", "learn/networks.py"):
        assert ROOT / "omniisaacgymenvs_torch" / rel in PORT_FILES, rel


def test_scan_covers_the_task_modules():
    """FrankaCabinet, AllegroHand and the flyers, their models and the view
    API are scanned like every other module."""
    for rel in ("envs/views.py", "models/flyers.py", "models/franka_cabinet.py",
                "models/allegro_hand.py", "tasks/ingenuity.py",
                "tasks/quadcopter.py", "tasks/crazyflie.py",
                "tasks/franka_cabinet.py", "tasks/allegro_hand.py"):
        assert ROOT / "omniisaacgymenvs_torch" / rel in PORT_FILES, rel


def test_scan_covers_the_importer_and_parallel_modules():
    """The importers, the Custom task and the multi-GPU modules are scanned
    like every other module."""
    for rel in ("models/importers.py", "models/pendulum.py", "tasks/custom.py",
                "parallel/__init__.py", "parallel/mesh.py"):
        assert ROOT / "omniisaacgymenvs_torch" / rel in PORT_FILES, rel


def test_scan_covers_the_demo_and_harness_modules():
    """The demos, the viewer (the port's own copy: the JAX package's
    imports no JAX) and the GPU regression harness are scanned like every
    other module."""
    for rel in ("demos/__init__.py", "demos/interactive.py",
                "demos/anymal_terrain.py", "scripts/viewer.py",
                "scripts/gpu_regression.py"):
        assert ROOT / "omniisaacgymenvs_torch" / rel in PORT_FILES, rel


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT_FILES
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_scan_covers_the_campaign_runner():
    """The training campaign runner is scanned like every other module: it
    runs scripts/train.py of the port, never the JAX package's root
    scripts/ (run_task.sh, train_all.sh, make_learning_json.py)."""
    assert ROOT / "omniisaacgymenvs_torch" / "scripts" / "campaign.py" in PORT_FILES
    assert "scripts" in FORBIDDEN
    assert list(_imports(ROOT / "omniisaacgymenvs_torch" / "scripts" / "campaign.py"))
