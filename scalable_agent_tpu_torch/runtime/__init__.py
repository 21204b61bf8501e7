from scalable_agent_tpu_torch.runtime.actor import ActorPool, VectorActor
from scalable_agent_tpu_torch.runtime.checkpoint import (
    CheckpointIntegrityError,
    CheckpointManager,
)
from scalable_agent_tpu_torch.runtime.learner import (
    Learner,
    LearnerHyperparams,
    TrainState,
    Trajectory,
)
