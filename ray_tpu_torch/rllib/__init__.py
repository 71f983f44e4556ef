"""ray_tpu_torch.rllib — reinforcement learning, online and offline.
Port of ray_tpu/rllib (reference: rllib/ new API stack).

PPO (flat and pixel observations), IMPALA, APPO, DQN and SAC, and
multi-agent PPO over a MultiRLModule (one policy a module id); offline,
BC and CQL over logged transitions (``offline.py``). RLModules
applied to weights with torch.func, learners stepping torch.optim.Adam
behind optax's global-norm clip, env runners stepping vectorized host envs
with one batched forward a timestep. Runners and learners live in this
process (the reference's are actors of its runtime, which the port does
not import). Entry points run on the card unless ``build(device=...)``
names another device.
"""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig, APPOLearner
from ray_tpu_torch.rllib.bc import BC, BCConfig, BCLearnerConfig
from ray_tpu_torch.rllib.cql import CQL, CQLConfig, CQLLearnerConfig
from ray_tpu_torch.rllib.dqn import (
    DQN,
    DQNConfig,
    DQNLearner,
    DQNLearnerConfig,
    DQNModule,
    ReplayBuffer,
)
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, SingleAgentEnvRunner
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.learner import (
    LearnerGroup,
    PPOLearner,
    PPOLearnerConfig,
    compute_gae,
)
from ray_tpu_torch.rllib.multi_agent import (
    AgentToModuleConnector,
    ModuleToAgentConnector,
    MultiAgentEnvRunner,
    MultiAgentEpisode,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiRLModule,
)
from ray_tpu_torch.rllib.offline import OfflineData, record_episodes
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.rl_module import ConvActorCriticNet, RLModule
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACLearner, SACModule
from ray_tpu_torch.rllib.vector import SyncVectorEnv, as_batch_env

__all__ = [
    "AgentToModuleConnector",
    "ModuleToAgentConnector",
    "MultiAgentEnvRunner",
    "MultiAgentEpisode",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiRLModule",
    "APPO",
    "APPOConfig",
    "APPOLearner",
    "BC",
    "BCConfig",
    "BCLearnerConfig",
    "CQL",
    "CQLConfig",
    "CQLLearnerConfig",
    "OfflineData",
    "record_episodes",
    "ConvActorCriticNet",
    "SAC",
    "SACConfig",
    "SACLearner",
    "SACModule",
    "SyncVectorEnv",
    "as_batch_env",
    "DQN",
    "DQNConfig",
    "DQNLearner",
    "DQNLearnerConfig",
    "DQNModule",
    "EnvRunnerGroup",
    "IMPALA",
    "IMPALAConfig",
    "IMPALALearner",
    "ReplayBuffer",
    "LearnerGroup",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PPOLearnerConfig",
    "RLModule",
    "SingleAgentEnvRunner",
    "compute_gae",
]
