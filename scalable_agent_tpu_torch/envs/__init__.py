from scalable_agent_tpu_torch.envs.core import (
    BenchmarkStream,
    Environment,
    ImpalaStream,
    StreamAdapter,
)
from scalable_agent_tpu_torch.envs.fake import FakeEnv
from scalable_agent_tpu_torch.envs.registry import FAKE_LEVELS, create_env
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.envs.vector import MultiEnv


def make_impala_stream(env_name: str, seed: int = 0,
                       benchmark_mode: bool = False,
                       num_action_repeats: int = 1, **kwargs):
    """Name -> seeded ImpalaStream (the counterpart of
    ``scalable_agent_tpu.envs.make_impala_stream``).  The fake family
    applies action repeats natively.  ``benchmark_mode`` steps the env
    with a ``BenchmarkStream``'s random actions, seeded with ``seed``."""
    env = create_env(env_name, num_action_repeats=num_action_repeats,
                     **kwargs)
    env.seed(seed)
    stream = StreamAdapter(env)
    if benchmark_mode:
        stream = BenchmarkStream(stream, seed=seed)
    return ImpalaStream(stream)
