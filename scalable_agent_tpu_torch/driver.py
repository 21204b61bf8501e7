"""Experiment driver of the port: a lean ``train`` and the CLI.

The counterpart of ``scalable_agent_tpu/driver.py``'s host backend
(``train``, reference: experiment.py:479-672), cut to the main path: probe
the env, build the agent and the learner, make ``num_actors // batch_size``
env groups, then alternate one actor unroll of the next group with one
learner update until the frame budget is spent.  Actor threads, prefetch,
the packed transport, the in-flight window, checkpoints and the obs planes
are not ported yet (ROADMAP.md, queue 1).

Run:
    python -m scalable_agent_tpu_torch.driver --mode=train \\
        --level_name=fake_benchmark --total_environment_frames=38400

The run happens on ``--device=cuda`` (the default) and fails when there is
no card; ``--device=cpu`` runs every kernel's plain PyTorch version.
"""

import functools
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    create_env,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import float32_precision
from scalable_agent_tpu_torch.runtime import (
    Learner,
    LearnerHyperparams,
    Trajectory,
    VectorActor,
)
from scalable_agent_tpu_torch.runtime.actor import to_device

log = logging.getLogger("scalable_agent_tpu_torch")


def resolve_device(device: str) -> torch.device:
    """``cuda``/``cuda:N`` must exist; there is no fallback to the CPU."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch.cuda.is_available() "
            f"is false; pass --device=cpu to run on the CPU")
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return resolved


def env_kwargs(config: Config) -> dict:
    return {"height": config.height, "width": config.width}


def probe_env(config: Config):
    """Open one env to read (observation_spec, action_space)."""
    env = create_env(config.level_name, **env_kwargs(config))
    try:
        return env.observation_spec, env.action_space
    finally:
        env.close()


def build_agent(config: Config, observation_spec, action_space,
                device: torch.device) -> ImpalaAgent:
    """The agent with weights drawn from a generator seeded by
    ``config.seed``, placed on ``device``."""
    generator = torch.Generator().manual_seed(config.seed)
    return ImpalaAgent(action_space.n, observation_spec.frame.shape,
                       generator=generator).to(device)


def build_learner(config: Config, agent: ImpalaAgent) -> Learner:
    hp = LearnerHyperparams(
        entropy_cost=config.entropy_cost,
        baseline_cost=config.baseline_cost,
        discounting=config.discounting,
        reward_clipping=config.reward_clipping,
        learning_rate=config.learning_rate,
        total_environment_frames=config.total_environment_frames,
        rmsprop_decay=config.rmsprop_decay,
        rmsprop_epsilon=config.rmsprop_epsilon)
    return Learner(agent, hp, config.frames_per_update())


def make_env_groups(config: Config, frame_spec) -> List[MultiEnv]:
    """num_actors envs as groups of batch_size (each group is one learner
    batch), seeded as the JAX driver seeds them."""
    num_groups = max(1, config.num_actors // config.batch_size)
    return [
        MultiEnv([
            functools.partial(
                make_impala_stream, config.level_name,
                seed=config.seed * 100000 + g * 1000 + i,
                num_action_repeats=config.num_action_repeats,
                **env_kwargs(config))
            for i in range(config.batch_size)
        ], frame_spec)
        for g in range(num_groups)
    ]


def to_trajectory(actor_output, device) -> Trajectory:
    return Trajectory(
        agent_state=to_device(actor_output.agent_state, device),
        env_outputs=to_device(actor_output.env_outputs, device),
        agent_outputs=to_device(actor_output.agent_outputs, device))


def train(config: Config) -> Dict[str, float]:
    """Train until ``total_environment_frames``; returns the newest
    update's metrics as host floats."""
    device = resolve_device(config.device)
    observation_spec, action_space = probe_env(config)
    agent = build_agent(config, observation_spec, action_space, device)
    learner = build_learner(config, agent)
    groups = make_env_groups(config, observation_spec.frame)
    actors = [VectorActor(agent, envs, config.unroll_length,
                          level_name=config.level_name,
                          seed=config.seed * 1000 + g)
              for g, envs in enumerate(groups)]
    metrics: Dict[str, torch.Tensor] = {}
    updates = 0
    last_log = time.monotonic()
    try:
        # Convolutions and matmuls in full float32, as the JAX package's
        # compute_dtype=float32 configuration runs them.
        with float32_precision():
            while learner.state.env_frames < config.total_environment_frames:
                actor = actors[updates % len(actors)]
                trajectory = to_trajectory(actor.run_unroll(), device)
                metrics = learner.update(trajectory)
                updates += 1
                now = time.monotonic()
                if now - last_log >= config.log_interval_s or (
                        learner.state.env_frames
                        >= config.total_environment_frames):
                    last_log = now
                    log.info(
                        "update %d env_frames %.0f total_loss %.6g "
                        "pg_loss %.6g baseline_loss %.6g entropy_loss %.6g",
                        updates, learner.state.env_frames,
                        *(float(metrics[k]) for k in (
                            "total_loss", "policy_gradient_loss",
                            "baseline_loss", "entropy_loss")))
    finally:
        for actor in actors:
            actor.close()
    result = {name: float(value) for name, value in metrics.items()}
    returns = [r for envs in groups for r, _ in envs.episode_stats]
    if returns:
        result["episode_return"] = float(np.mean(returns))
    return result


def main(argv: Optional[Sequence[str]] = None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    config = Config.from_argv(argv, description=__doc__)
    return train(config)


if __name__ == "__main__":
    main()
