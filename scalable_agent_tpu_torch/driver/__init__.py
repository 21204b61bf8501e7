"""Experiment driver of the port: ``train``, ``test`` and the CLI.

The counterpart of ``scalable_agent_tpu/driver.py``'s host backend
(``train``, reference: experiment.py:479-672) and eval (``test``,
experiment.py:675-708):

- ``train``: save ``<logdir>/config.json``; build the agent and the
  learner; restore the newest verified checkpoint; start the ``ActorPool``
  (one thread per env group of ``batch_size`` envs, each group stepped by
  ``num_env_workers_per_group`` worker processes) and the prefetch thread,
  which uploads trajectories on its own stream and stages them one deep
  (the reference's StagingArea +1-step policy lag, experiment.py:587-597).
  Then, until the frame budget is spent: take the staged batch, update,
  publish the new weights to the actors, write a metrics row at the log
  interval and a checkpoint at the checkpoint cadence; a final checkpoint
  is forced.  Threads and worker processes are joined in a ``finally``,
  and an actor's terminal exception ends the run with that exception.
- ``test``: restore the newest verified checkpoint of ``--logdir`` and run
  ``test_num_episodes`` episodes of ``--level_name`` on a batched eval
  fleet.

Run:
    python -m scalable_agent_tpu_torch.driver --mode=train \\
        --scan_impl=pallas --logdir=/tmp/run --level_name=fake_benchmark
    python -m scalable_agent_tpu_torch.driver --mode=test --logdir=/tmp/run

The run happens on ``--device=cuda`` (the default) and fails when there is
no card; ``--device=cpu`` runs every kernel's plain PyTorch version.  The
packed transport, the in-flight window, replay, multi-task training,
DMLab-30 suite scoring, the obs planes and the fleet layers are not ported
yet (ROADMAP.md, queue 1).
"""

import contextlib
import dataclasses
import functools
import logging
import os
import queue as queue_lib
import threading
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
from scalable_agent_tpu_torch.models import (
    ImpalaAgent,
    actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.ops import float32_precision
from scalable_agent_tpu_torch.runtime import (
    ActorPool,
    CheckpointManager,
    Learner,
    LearnerHyperparams,
    Trajectory,
)
from scalable_agent_tpu_torch.runtime.actor import to_device
from scalable_agent_tpu_torch.types import map_structure
from scalable_agent_tpu_torch.utils.metrics import MetricsWriter
from scalable_agent_tpu_torch.utils.timing import Timing

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
    return Learner(agent, hp, config.frames_per_update(),
                   scan_impl=config.scan_impl)


def worker_processes(requested: int, num_envs: int) -> int:
    """Env worker processes for a fleet of ``num_envs`` envs, as the JAX
    MultiEnv reads its ``num_workers``: 0 means one per env, and there is
    never more than one per env."""
    return min(requested or num_envs, num_envs)


def make_env_groups(config: Config, frame_spec) -> List[MultiEnv]:
    """num_actors envs as groups of batch_size (each group is one learner
    batch), seeded as the JAX driver seeds them, each group stepped by
    ``num_env_workers_per_group`` worker processes (0: one per env)."""
    num_groups = max(1, config.num_actors // config.batch_size)
    groups = []
    try:
        for g in range(num_groups):
            groups.append(MultiEnv([
                functools.partial(
                    make_impala_stream, config.level_name,
                    seed=config.seed * 100000 + g * 1000 + i,
                    num_action_repeats=config.num_action_repeats,
                    **env_kwargs(config))
                for i in range(config.batch_size)
            ], frame_spec, num_workers=worker_processes(
                config.num_env_workers_per_group, config.batch_size)))
    except BaseException:
        for envs in groups:
            envs.close()
        raise
    return groups


def to_trajectory(actor_output, device) -> Trajectory:
    return Trajectory(
        agent_state=to_device(actor_output.agent_state, device),
        env_outputs=to_device(actor_output.env_outputs, device),
        agent_outputs=to_device(actor_output.agent_outputs, device))


def _leaves(tree):
    out = []
    map_structure(lambda t: out.append(t) if t is not None else None, tree)
    return out


def start_prefetch(pool: ActorPool, device: torch.device,
                   staged: queue_lib.Queue,
                   stop: threading.Event) -> threading.Thread:
    """Start the prefetch stage: take the pool's trajectories, upload
    them on this thread's own stream and stage them one deep as
    ``(trajectory, event)``.  An exception is staged in place of a
    batch."""

    def put(item) -> None:
        while not stop.is_set():
            try:
                staged.put(item, timeout=0.5)
                return
            except queue_lib.Full:
                continue

    def prefetch_loop():
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        context = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
        try:
            with context:
                while not stop.is_set():
                    try:
                        out = pool.get_trajectory(timeout=0.5)
                    except queue_lib.Empty:
                        continue
                    trajectory = to_trajectory(out, device)
                    event = None
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                    put((trajectory, event))
        except Exception as exc:  # surfaces in the training loop
            put(exc)

    thread = threading.Thread(target=prefetch_loop, daemon=True,
                              name="prefetch")
    thread.start()
    return thread


def _adopt(staged_item, device: torch.device) -> Trajectory:
    """A staged ``(trajectory, event)`` made safe for the current stream:
    wait for its upload, and keep its memory from being reused by the
    prefetch stream while this stream's work on it is pending."""
    if isinstance(staged_item, Exception):
        raise staged_item
    trajectory, event = staged_item
    if event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        for tensor in _leaves(trajectory):
            tensor.record_stream(stream)
    return trajectory


def train(config: Config) -> Dict[str, float]:
    """Train until ``total_environment_frames``; returns the newest
    update's metrics as host floats (plus ``episode_return``, the mean of
    the pool's recent finished episodes, when there are any)."""
    device = resolve_device(config.device)
    config.save()
    observation_spec, action_space = probe_env(config)
    groups = pool = prefetch_thread = writer = None
    prefetch_stop = threading.Event()
    metrics: Dict[str, torch.Tensor] = {}
    # Convolutions and matmuls in full float32, as the JAX package's
    # compute_dtype=float32 configuration runs them.  The flags are
    # process-wide: set once, before any thread starts.
    with float32_precision():
        try:
            agent = build_agent(config, observation_spec, action_space,
                                device)
            learner = build_learner(config, agent)
            ckpt = CheckpointManager(config.logdir,
                                     config.checkpoint_interval_s,
                                     config.checkpoint_keep)
            restored = ckpt.restore()
            start_updates = 0
            if restored is not None:
                start_updates, saved = restored
                learner.load_state_dict(saved)
                log.info("restored checkpoint at update %d (%.0f frames)",
                         start_updates, learner.state.env_frames)
            groups = make_env_groups(config, observation_spec.frame)
            pool = ActorPool(
                agent, groups, config.unroll_length,
                level_name=config.level_name, seed=config.seed,
                max_restarts=config.actor_max_restarts)
            pool.set_params(agent, version=start_updates)
            pool.start()
            staged: queue_lib.Queue = queue_lib.Queue(maxsize=1)
            prefetch_thread = start_prefetch(pool, device, staged,
                                             prefetch_stop)
            writer = MetricsWriter(config.logdir)
            timing = Timing()
            updates = start_updates
            frames = learner.state.env_frames
            last_log = time.monotonic()
            frames_at_last_log = frames
            steps_at_last_log = pool.agent_steps
            while frames < config.total_environment_frames:
                with timing.time_avg("wait_batch"):
                    item = staged.get()
                trajectory = _adopt(item, device)
                with timing.time_avg("update"):
                    metrics = learner.update(trajectory)
                del trajectory, item
                pool.set_params(agent, version=updates)
                updates += 1
                frames = learner.state.env_frames
                now = time.monotonic()
                if now - last_log >= config.log_interval_s:
                    row = {k: float(v) for k, v in metrics.items()}
                    elapsed = max(now - last_log, 1e-9)
                    row["fps"] = (frames - frames_at_last_log) / elapsed
                    steps = pool.agent_steps
                    row["actor_fps"] = ((steps - steps_at_last_log)
                                        * config.num_action_repeats
                                        / elapsed)
                    stats = pool.episode_stats()
                    if stats:
                        row["episode_return"] = float(
                            np.mean([r for r, _ in stats]))
                        row["episode_frames"] = float(
                            np.mean([n for _, n in stats])
                            * config.num_action_repeats)
                    row.update({f"timing/{k}": v
                                for k, v in timing.summary().items()})
                    writer.write(updates, row)
                    log.info(
                        "update %d frames %.3g fps %.0f (actors %.0f) "
                        "loss %.3f return %.2f | %s", updates, frames,
                        row["fps"], row["actor_fps"], row["total_loss"],
                        row.get("episode_return", float("nan")), timing)
                    last_log, frames_at_last_log = now, frames
                    steps_at_last_log = steps
                ckpt.maybe_save(updates, learner.state_dict())
            ckpt.maybe_save(updates, learner.state_dict(), force=True)
        finally:
            prefetch_stop.set()
            if pool is not None:
                pool.stop()
            elif groups is not None:
                for envs in groups:
                    envs.close()
            if prefetch_thread is not None:
                prefetch_thread.join(timeout=10)
            if writer is not None:
                writer.close()
    result = {name: float(value) for name, value in metrics.items()}
    returns = [r for r, _ in pool.episode_stats()]
    if returns:
        result["episode_return"] = float(np.mean(returns))
    return result


def _eval_loop(envs: MultiEnv, config: Config, agent: ImpalaAgent,
               num_episodes: int) -> List[float]:
    """Drive an eval fleet under batched inference until ``num_episodes``
    episodes complete.  Each env slot contributes at most
    ceil(num_episodes / B) episodes: taking the first N completions
    overall would over-represent short episodes."""
    device = next(agent.parameters()).device
    batch = envs.num_envs
    quota = -(-num_episodes // batch)
    counts = np.zeros((batch,), np.int64)
    returns: List[float] = []
    generator = torch.Generator(device=device).manual_seed(config.seed)
    try:
        output = envs.initial()
        core_state = initial_state(batch, agent.core_size, device)
        action = np.zeros((batch,), np.int64)
        while len(returns) < num_episodes:
            agent_out, core_state = actor_step(
                agent, generator, torch.as_tensor(action, device=device),
                to_device(output, device), core_state)
            action = agent_out.action.cpu().numpy()
            output = envs.step(action)
            for i in np.nonzero(output.done)[0]:
                if output.info.episode_step[i] > 0 and counts[i] < quota:
                    counts[i] += 1
                    returns.append(float(output.info.episode_return[i]))
    finally:
        envs.close()
    return returns[:num_episodes]


def _eval_level(config: Config, agent: ImpalaAgent, level_name: str,
                frame_spec, num_episodes: int) -> List[float]:
    """``num_episodes`` returns from a fleet of ``test_batch_size`` envs
    (seeded ``seed * 977 + 131 * i``, apart from every training seed)
    stepped under one batched inference call."""
    batch = max(1, min(num_episodes, config.test_batch_size))
    fns = [functools.partial(make_impala_stream, level_name,
                             seed=config.seed * 977 + 131 * i,
                             num_action_repeats=config.num_action_repeats,
                             **env_kwargs(config))
           for i in range(batch)]
    envs = MultiEnv(fns, frame_spec,
                    num_workers=worker_processes(config.test_num_workers,
                                                 batch))
    return _eval_loop(envs, config, agent, num_episodes)


def test(config: Config) -> Dict[str, List[float]]:
    """Evaluate the newest verified checkpoint of ``config.logdir``:
    ``test_num_episodes`` returns of ``level_name``."""
    device = resolve_device(config.device)
    # The architecture belongs to the checkpoint, not to the eval flags.
    saved_path = os.path.join(config.logdir, "config.json")
    if os.path.exists(saved_path):
        saved = Config.load(saved_path)
        config = dataclasses.replace(config, torso_type=saved.torso_type)
    observation_spec, action_space = probe_env(config)
    restored = CheckpointManager(config.logdir).restore()
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint under {config.logdir}/checkpoints")
    step, saved_state = restored
    with float32_precision():
        agent = build_agent(config, observation_spec, action_space, device)
        agent.load_state_dict(saved_state["params"])
        returns = _eval_level(config, agent, config.level_name,
                              observation_spec.frame,
                              config.test_num_episodes)
    log.info("level %s: mean return %.2f over %d episodes (checkpoint "
             "step %d)", config.level_name, float(np.mean(returns)),
             len(returns), step)
    return {config.level_name: returns}


def main(argv: Optional[Sequence[str]] = None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    config = Config.from_argv(argv, description=__doc__)
    if config.mode == "test":
        return test(config)
    return train(config)
