"""Robot model specifications of the PyTorch port."""

from omniisaacgymenvs_torch.models.ant import build_ant
from omniisaacgymenvs_torch.models.anymal import build_anymal
from omniisaacgymenvs_torch.models.balance_bot import build_balance_bot
from omniisaacgymenvs_torch.models.cartpole import build_cartpole
from omniisaacgymenvs_torch.models.humanoid import build_humanoid
from omniisaacgymenvs_torch.models.shadow_hand import build_shadow_hand
