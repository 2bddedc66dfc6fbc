"""Robot model specifications of the PyTorch port."""

from omniisaacgymenvs_torch.models.ant import build_ant
from omniisaacgymenvs_torch.models.humanoid import build_humanoid
