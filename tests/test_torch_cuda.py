"""Card tests of the PyTorch port: each kernel against its plain version on
the card, and the engine's refusal of scenes outside the kernels' scope.
They skip without a CUDA device. This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from omniisaacgymenvs_torch.models import build_humanoid
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder
from torch_parity import cuda_device  # noqa: F401

N_STEPS = 4


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    """K1 and K2 on the card against their plain versions on the card, at
    an env count that is not a multiple of the block size (masked tail),
    with the tolerances of ops/parity.py."""
    eng = PhysicsEngine(build_humanoid(device=cuda_device),
                        SimParams(dt=1.0 / 120.0, substeps=2))
    m = eng.model
    n = 515
    q, qd, eff = parity.check_inputs(m, n, seed=2, device=cuda_device)
    z = torch.zeros((n, m.njd), device=cuda_device)
    fa = torch.zeros((n, m.nb, 6), device=cuda_device)
    out = fs.step(eng, q, qd, eff, z, z, fa, N_STEPS)
    ref = fs.step_plain(eng, q, qd, eff, z, z, fa, N_STEPS)
    torch.cuda.synchronize()
    assert eng.kernels.launches["step"] == 1
    parity.assert_within("K1", parity.compare(out, ref, parity.STEP_NAMES,
                                              parity.STEP_TOL), parity.STEP_TOL)
    out = fs.fk(eng, q, qd)
    ref = fs.fk_plain(m, q, qd)
    parity.assert_within("K2", parity.compare(out, ref, parity.FK_NAMES,
                                              parity.FK_TOL), parity.FK_TOL)
    assert eng.kernels.launches["fk"] == 1


@pytest.mark.cuda
def test_engine_refuses_out_of_scope_scene_on_card(cuda_device):
    b = ModelBuilder("fixed")
    root = b.add_body("base", parent=-1, joint_type=JointType.FIXED)
    b.add_body("j1", parent=root)
    b.add_sphere_collider(root, (0, 0, 0), 0.1)
    with pytest.raises(NotImplementedError):
        PhysicsEngine(b.finalize(cuda_device), SimParams())


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs_on_card(cuda_device):
    eng = PhysicsEngine(build_humanoid(device=cuda_device), SimParams())
    m = eng.model
    q = m.default_q.expand(4, -1).contiguous()
    qd = torch.zeros((4, m.nv), device=cuda_device)
    with pytest.raises(TypeError):
        fs.fk(eng, q.double(), qd)
    with pytest.raises(ValueError):
        fs.fk(eng, q[:, :-1], qd)
    with pytest.raises(ValueError):
        fs.fk(eng, q.t().contiguous().t(), qd)
    assert eng.kernels.launches["fk"] == 0
