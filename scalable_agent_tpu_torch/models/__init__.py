from scalable_agent_tpu_torch.models.agent import (
    CORE_SIZE,
    ImpalaAgent,
    actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.models.instruction import InstructionEncoder
from scalable_agent_tpu_torch.models.networks import (
    ResNetTorso,
    ShallowConvTorso,
)
