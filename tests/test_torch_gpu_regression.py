"""The GPU regression harness on the CPU
(omniisaacgymenvs_torch/scripts/gpu_regression.py): its rest scene against
the JAX package's (tools/debug_pair_tpu.build_scene), the plain 32-substep
rest against the JAX engine's XLA path, and the harness's JSON line, exit
code and device rule. On the CPU the kernel wrappers run their plain
versions, so the card's readings come from chip runs."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics.model import Model
from omniisaacgymenvs_torch.scripts import gpu_regression as gr
from tools.debug_pair_tpu import build_scene
from torch_parity import assert_step_close, jax_fields, jax_step, np_


@pytest.mark.parametrize("surface", parity.REST_SURFACES)
def test_rest_scene_equals_the_jax_scene(surface):
    m, eng = parity.build_rest_scene(surface)
    jm, jeng = build_scene(surface)
    jf = jax_fields(jm)
    assert {f.name for f in dataclasses.fields(Model)} == set(jf)
    for f in dataclasses.fields(Model):
        a, b = getattr(m, f.name), jf[f.name]
        if isinstance(a, (torch.Tensor, np.ndarray)):
            # both cast the same float64 build values to float32: exact
            np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name
    assert (eng.params.dt, eng.params.substeps) == (jeng.params.dt,
                                                    jeng.params.substeps)
    assert eng.h == jeng.params.dt / jeng.params.substeps


def test_rest_scene_refuses_an_unknown_surface():
    with pytest.raises(ValueError):
        parity.build_rest_scene("plane")


@pytest.mark.parametrize("z0", [gr.REST_Z0, gr.INTERIOR_Z0])
def test_plain_rest_matches_the_jax_engine(z0):
    """The harness's plain path over 32 substeps against the JAX engine's
    XLA path at the pair-scene parity tests' tolerance
    (torch_parity.STEP_N_TOL); the ball stays above the box's top."""
    m, eng = parity.build_rest_scene("box")
    _, jeng = build_scene("box")
    ins = gr._rest_inputs(m, 2, z0, "cpu")
    out = fs.step_plain(eng, *ins, gr.REST_SUBSTEPS)
    q, qd, eff, ptg, _, fa = (np_(x) for x in ins)
    assert_step_close(out, jax_step(jeng, q, qd, eff, ptg, fa, gr.REST_SUBSTEPS))
    zi = m.q_adr[m.body_index("ball")] + 2
    assert float(out[0][:, zi].min()) > gr.REST_MIN_Z
    assert float(ins[0][0, zi]) == pytest.approx(z0)


def small(monkeypatch):
    monkeypatch.setattr(gr, "REST_ENVS", 4)
    monkeypatch.setattr(gr, "ROLLOUT_ENVS", 8)
    monkeypatch.setattr(gr, "ROLLOUT_STEPS", 3)


def test_main_prints_one_json_line(monkeypatch, capsys):
    small(monkeypatch)
    assert gr.main(["device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok"] is True and list(res["checks"]) == list(gr.CHECKS)
    for name, c in res["checks"].items():
        assert c["ok"] is True, (name, c)
    sq = res["checks"]["sqrt_branch"]
    assert sq["nvcc_fast_math"] == [] and not sq["interior_misclassified"]
    assert sq["interior_force_z_plain"] > gr.MIN_INTERIOR_FORCE
    for name in ("pair_rest", "pair_rest_interior"):
        assert res["checks"][name]["z_kernel"] > gr.REST_MIN_Z
    assert res["checks"]["shadowhand"]["k1_expected"] == 3


def test_a_check_that_raises_fails_the_run(monkeypatch, capsys):
    small(monkeypatch)

    def broken(device):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(gr, "check_ballbalance", broken)
    assert gr.main(["sqrt_branch", "ballbalance", "device=cpu"]) == 1
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["ok"] is False and list(res["checks"]) == ["sqrt_branch", "ballbalance"]
    assert res["checks"]["sqrt_branch"]["ok"] is True
    assert res["checks"]["ballbalance"] == {"ok": False,
                                            "error": "RuntimeError('launch failed')"}


def test_fast_math_flags_fail_the_sqrt_check(monkeypatch):
    monkeypatch.setattr(fs, "NVCC_FLAGS", fs.NVCC_FLAGS + ("--use_fast_math",))
    res = gr.check_sqrt_branch(torch.device("cpu"))
    assert res["nvcc_fast_math"] == ["--use_fast_math"] and res["ok"] is False


def test_unknown_check_is_refused():
    with pytest.raises(SystemExit):
        gr.main(["nothing", "device=cpu"])


def test_without_cuda_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gr.main(["sqrt_branch"])
