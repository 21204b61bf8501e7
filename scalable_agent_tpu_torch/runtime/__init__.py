from scalable_agent_tpu_torch.runtime.actor import VectorActor
from scalable_agent_tpu_torch.runtime.learner import (
    Learner,
    LearnerHyperparams,
    TrainState,
    Trajectory,
)
