"""Robot model specifications of the PyTorch port."""

from omniisaacgymenvs_torch.models.allegro_hand import build_allegro_hand
from omniisaacgymenvs_torch.models.ant import build_ant
from omniisaacgymenvs_torch.models.anymal import build_anymal
from omniisaacgymenvs_torch.models.balance_bot import build_balance_bot
from omniisaacgymenvs_torch.models.cartpole import build_cartpole
from omniisaacgymenvs_torch.models.franka_cabinet import build_franka_cabinet
from omniisaacgymenvs_torch.models.flyers import (build_crazyflie,
                                                  build_ingenuity,
                                                  build_quadcopter)
from omniisaacgymenvs_torch.models.humanoid import build_humanoid
from omniisaacgymenvs_torch.models.pendulum import (build_double_pendulum,
                                                    build_pendulum)
from omniisaacgymenvs_torch.models.shadow_hand import build_shadow_hand
