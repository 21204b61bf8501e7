from scalable_agent_tpu_torch.envs.core import (
    BenchmarkStream,
    Environment,
    ImpalaStream,
    StreamAdapter,
    Wrapper,
)
from scalable_agent_tpu_torch.envs.fake import FakeEnv
from scalable_agent_tpu_torch.envs.registry import (
    FAKE_LEVELS,
    create_env,
    family_consumes_repeats,
    register_family,
)
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.envs.vector import MultiEnv


def make_impala_stream(env_name: str, seed: int = 0,
                       benchmark_mode: bool = False,
                       num_action_repeats: int = 1,
                       record_to: str = "", **kwargs):
    """Name -> seeded ImpalaStream (the counterpart of
    ``scalable_agent_tpu.envs.make_impala_stream``).  A family that
    consumes ``num_action_repeats`` (fake, Doom, DMLab, Atari) applies
    them natively;
    any other env gets a ``SkipFramesWrapper``, unless it already repeats
    natively.  ``record_to`` wraps the env in a ``RecordingWrapper``
    (episodes as ``<record_to>/episode_NNNNN/``).  ``benchmark_mode`` steps
    the env with a ``BenchmarkStream``'s random actions, seeded with
    ``seed``."""
    if family_consumes_repeats(env_name):
        kwargs["num_action_repeats"] = num_action_repeats
    env = create_env(env_name, **kwargs)
    env.seed(seed)
    native = getattr(env, "native_action_repeats", 1)
    if num_action_repeats > 1 and num_action_repeats != native:
        if native != 1:
            raise ValueError(
                f"{env_name!r} applies {native} native action repeats; "
                f"cannot also request {num_action_repeats}")
        from scalable_agent_tpu_torch.envs.wrappers import SkipFramesWrapper
        env = SkipFramesWrapper(env, num_action_repeats)
    if record_to:
        from scalable_agent_tpu_torch.envs.wrappers import RecordingWrapper
        env = RecordingWrapper(env, record_to)
    stream = StreamAdapter(env)
    if benchmark_mode:
        stream = BenchmarkStream(stream, seed=seed)
    return ImpalaStream(stream)
