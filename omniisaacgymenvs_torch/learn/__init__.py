"""The PPO learner: running norms, the actor-critic networks, the trainer."""

from omniisaacgymenvs_torch.learn.ppo import PPOConfig, PPOTrainer
