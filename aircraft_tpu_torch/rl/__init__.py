from aircraft_tpu_torch.rl.ddpg import (
    CurriculumLearning,
    CurriculumStage,
    DDPGAgent,
    OUNoise,
    ReplayBuffer,
    Transition,
)

__all__ = [
    "DDPGAgent",
    "ReplayBuffer",
    "OUNoise",
    "Transition",
    "CurriculumLearning",
    "CurriculumStage",
]
