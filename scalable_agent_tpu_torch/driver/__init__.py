"""Experiment driver of the port: ``train``, ``test`` and the CLI.

The counterpart of ``scalable_agent_tpu/driver.py``'s host backend
(``train``, reference: experiment.py:479-672) and eval (``test``,
experiment.py:675-708):

- ``train``: save ``<logdir>/config.json``; arm the ``--chaos_spec`` fault
  points and the SIGTERM preemption grace; build the agent and the
  learner; restore the newest verified checkpoint; start the
  ``ActorPool`` (one thread per env group of ``batch_size`` envs, each
  group stepped by ``num_env_workers_per_group`` worker processes), or
  under ``--actor=service`` the continuous-batching ``ActorService``
  (``runtime/service.py``: one inference thread batching the workers'
  slices as they arrive, up to ``--service_max_batch`` rows), and the
  prefetch thread, which puts trajectories on the card through the
  ``--transport`` on its own stream and stages them one deep (the
  reference's StagingArea +1-step policy lag, experiment.py:587-597).
  Then, until the frame budget is spent: take the staged batch, issue the
  update and push it into the in-flight window (waiting for the oldest
  update only when ``--inflight_updates`` are in flight), publish the new
  weights to the actors, publish at the log interval (below), then
  decide: a SIGTERM
  breaks into the shutdown tail, an exhausted non-finite tolerance rolls
  back to the newest verified checkpoint (``_rollback_or_exit``: exit 71
  under ``--no_rollback`` or with nothing to restore), else a checkpoint
  at the checkpoint cadence.  The tail drains the window and forces one
  final checkpoint.  Threads and worker processes are joined in a
  ``finally``, and an actor's terminal exception ends the run with that
  exception.
- The obs producers (``obs/``), armed before anything else as the JAX
  driver arms them (``_setup_observability``): the metrics registry with
  its device-memory gauge, ``<logdir>/metrics.prom``, the flight recorder
  and its crash handlers (the preemption handler is installed over them,
  so a second SIGTERM dumps and exits 143), the watchdog
  (``--watchdog_timeout_s``, exit 70 under ``--watchdog_abort``), the
  tracer under ``--trace`` (``<logdir>/trace.p0.<pid>.json``), the
  pipeline ledger with its live MFU gauge (``configure_live_mfu``), the
  stall attributor, and the learner's device telemetry
  (``--learn_telemetry``), and under ``--metrics_http_port`` the scrape
  endpoint (``MetricsHTTPServer``: ``/metrics``, ``/anomalies``,
  ``/health``) for the length of the run.  At each log interval, in the
  JAX order: the device telemetry's one fetch, ``ledger.publish()``, the
  learner's heartbeat, ``stall.attribute`` over the interval's
  ``wait_batch``, ``update`` and ``retire`` sums, the metrics row (where
  ``NonFiniteTracker`` reads the skip counters) and the registry row,
  then ``metrics.prom``.  ``--profile_dir`` records updates from
  ``profile_start_update`` on with ``torch.profiler`` (``record_shapes``)
  and writes its Chrome trace there: one warm-up update
  (``PROFILE_WARMUP_UPDATES``), then the ``profile_num_updates`` updates
  its kernel table counts (``obs/kernels.py``: the learner's kernels
  joined to ``update_flops`` and the hand-written kernels' costs), which
  goes to ``<logdir>/kernels.json`` and the ``kernel/*`` gauges.  The
  ``throughput_sag`` fault point sleeps inside the update's timing.
- The run-health plane (``--health``, on by default as in the JAX
  package; ``_HealthPlane``): after the stall attribution of each log
  interval, the detectors of ``obs/health.py`` read the registry snapshot
  and the interval's metrics.  A trip appends ``<logdir>/anomalies.jsonl``,
  pins and dumps the flight recorder, and may open a profile window of
  ``--health_window_updates`` updates into
  ``<logdir>/health_profile.<id>/`` (only while no scheduled window
  records, and the scheduled window waits for it: ``torch.profiler``
  records one window at a time), whose table becomes
  ``<logdir>/kernels.<id>.json`` and the anomaly record's final state.
- Multi-task training (``--level_name=dmlab30``): env slot ``e`` (over all
  groups) runs DMLab-30 train level ``e % 30`` (``training_level_names``,
  ``make_env_groups``); the metrics rows carry each level's
  ``<level>/episode_return`` and ``<level>/episode_frames`` over the
  interval, and once every train level has reported, the human-normalized
  ``dmlab30/training_no_cap`` and ``dmlab30/training_cap_100`` scores
  (``envs/dmlab30.py``), after which the per-level returns start over.
- ``test``: restore the newest verified checkpoint of ``--logdir`` and run
  ``test_num_episodes`` episodes of ``--level_name`` on a batched eval
  fleet (self-play over lockstep matches on a multi-agent level),
  recorded under ``--record_to`` when it is set.  ``--level_name=dmlab30``
  evaluates every DMLab-30 test level and writes the suite's
  human-normalized scores to ``<logdir>/eval_scores.json``; a single
  DMLab-30 level logs its own normalized score.
- A multi-agent level (``doom_duel``: ``probe_env``'s ``num_agents`` > 1)
  trains on groups of ``batch_size / num_agents`` lockstep matches, each
  agent one batch slot (``make_env_groups``).  A level family's defaults
  (Doom's 72x128 frames) apply where the flags leave Config's
  (``config.apply_env_overrides``).

Run:
    python -m scalable_agent_tpu_torch.driver --mode=train \\
        --scan_impl=pallas --logdir=/tmp/run --level_name=fake_benchmark
    python -m scalable_agent_tpu_torch.driver --mode=test --logdir=/tmp/run

The run happens on ``--device=cuda`` (the default) and fails when there is
no card; ``--device=cpu`` runs every kernel's plain PyTorch version.  Exit
codes (``runtime/exit_codes.py``): 0 for a finished or a drained
preempted run, 70 for the watchdog under ``--watchdog_abort``, 71 for the
non-finite guard, 72 for an expired preemption grace, 143 for a second
SIGTERM.  The obs CLIs read a run's logdir (``python -m
scalable_agent_tpu_torch.obs.report <logdir>``; ``obs/__init__.py``).
The level families are those of the JAX package but for ``device_``:
``fake_``, ``doom_``, ``dmlab_``, ``atari_`` and ``gym_``
(``envs/registry.py``).  Off-policy training runs as in the JAX host
backend: ``--loss=impact`` trains on the IMPACT surrogate with its
target network, and ``--replay_ratio=R`` (packed transport only;
``build_replay``) runs R updates on batches sampled from the replay slab
on the card behind every fresh update, through the same in-flight
window, holding ``env_frames``; a rollback flushes the slab.  The
in-graph backend and the multi-process fleet are not ported yet
(ROADMAP.md, queue 1).
"""

import contextlib
import dataclasses
import functools
import json
import logging
import os
import queue as queue_lib
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from scalable_agent_tpu_torch.config import (
    Config,
    apply_env_overrides,
    resolve_conv_backend,
    resolve_core_impl,
    resolve_core_matmul_dtype,
)
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    create_env,
    dmlab30,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import (
    ImpalaAgent,
    actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.obs import (
    MetricsHTTPServer,
    MetricsRegistry,
    MetricsWriter,
    PrometheusExporter,
    StallAttributor,
    configure_flight_recorder,
    configure_ledger,
    configure_tracer,
    configure_watchdog,
    get_flight_recorder,
    get_ledger,
    get_registry,
    get_tracer,
    get_watchdog,
    install_crash_handlers,
)
from scalable_agent_tpu_torch.obs import kernels as kernels_lib
from scalable_agent_tpu_torch.obs.health import (
    HealthMonitor,
    default_detectors,
)
from scalable_agent_tpu_torch.obs.ledger import PipelineLedger, peak_flops
from scalable_agent_tpu_torch.ops import distributions, float32_precision
from scalable_agent_tpu_torch.runtime import (
    ActorPool,
    CheckpointIntegrityError,
    CheckpointManager,
    Learner,
    LearnerHyperparams,
    Trajectory,
)
from scalable_agent_tpu_torch.runtime.actor import to_device
from scalable_agent_tpu_torch.runtime.exit_codes import NONFINITE_EXIT_CODE
from scalable_agent_tpu_torch.runtime.faults import (
    armed_points,
    configure_faults,
    get_fault_injector,
    throughput_sag_s,
)
from scalable_agent_tpu_torch.runtime.fleet import PreemptionMonitor
from scalable_agent_tpu_torch.runtime.learner import (
    NonFiniteTracker,
    update_flops,
)
from scalable_agent_tpu_torch.runtime.replay import DeviceReplayBuffer
from scalable_agent_tpu_torch.runtime.service import ActorService
from scalable_agent_tpu_torch.runtime.transport import (
    InflightWindow,
    PackedTransport,
    host_trajectory,
    make_transport,
)
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


def env_kwargs(config: Config, name: Optional[str] = None) -> dict:
    """The level family's constructor kwargs for level ``name`` (default
    ``config.level_name``), as ``scalable_agent_tpu/driver.py:160-175``
    passes them: the frame size; for the fake and DMLab families the
    instruction stream, and for DMLab ``dataset_path`` and ``renderer``."""
    name = name or config.level_name
    if name.startswith(("fake_", "dmlab_")):
        kwargs = {"height": config.height, "width": config.width,
                  "with_instruction": config.use_instruction}
        if name.startswith("dmlab_"):
            kwargs.update(dataset_path=config.dataset_path,
                          renderer=config.renderer)
        return kwargs
    if name.startswith(("atari_", "gym_", "doom_")):
        return {"height": config.height, "width": config.width}
    return {}


def training_level_names(config: Config) -> List[str]:
    """The levels training spreads its env slots over
    (``scalable_agent_tpu/driver.py:289-299``): ``--level_name=dmlab30``
    trains on every DMLab-30 train level (slot ``e`` runs level ``e % 30``,
    as the reference assigns actor ``i`` level ``level_names[i % len]``,
    experiment.py:552-555); any other name is one level."""
    if config.level_name == "dmlab30":
        return [f"dmlab_{name}" for name in dmlab30.TRAIN_LEVELS]
    return [config.level_name]


def probe_env(config: Config):
    """Open one env to read (observation_spec, action_space, num_agents),
    then tear it down.  num_agents > 1 marks a lockstep multi-agent level
    (``create_env`` returns a ``MultiAgentEnv`` there)."""
    env = create_env(config.level_name, **env_kwargs(config))
    try:
        return (env.observation_spec, env.action_space,
                getattr(env, "num_agents", 1))
    finally:
        env.close()


def resolve_remat_torso(config: Config) -> bool:
    """``--remat_torso`` as ``scalable_agent_tpu/driver.py:248-257``
    resolves it: ``auto`` is on only on a TPU, so off here; a bad value
    raises the JAX driver's error."""
    if config.remat_torso not in ("auto", "on", "off"):
        raise ValueError(
            f"remat_torso must be auto, on, or off, got "
            f"{config.remat_torso!r}")
    return config.remat_torso == "on"


def build_agent(config: Config, observation_spec, action_space,
                device: torch.device) -> ImpalaAgent:
    """The agent with its policy over the probed ``action_space`` (one
    Discrete head or a composite tuple-categorical one) and weights drawn
    from a generator seeded by ``config.seed``, placed on ``device``,
    under the configuration's routes (``core_impl``, ``conv_backend``),
    dtype policy (``compute_dtype``, and ``core_matmul_dtype``), all
    resolved as the JAX driver resolves them, and ``remat_torso``.  A
    ``core_matmul_dtype`` other than float32 on the ``xla`` core warns as
    the JAX driver warns (``scalable_agent_tpu/driver.py:259-270``): that
    core trains at float32."""
    core_impl = resolve_core_impl(config)
    core_matmul_dtype = resolve_core_matmul_dtype(config, core_impl)
    if core_matmul_dtype != "float32" and core_impl != "pallas":
        import warnings

        warnings.warn(
            f"core_matmul_dtype={core_matmul_dtype!r} only "
            f"affects the pallas core; this run resolves to "
            f"core_impl={core_impl!r} and trains at float32",
            stacklevel=2)
    generator = torch.Generator().manual_seed(config.seed)
    return ImpalaAgent(frame_shape=observation_spec.frame.shape,
                       action_space=action_space,
                       generator=generator,
                       compute_dtype=getattr(torch, config.compute_dtype),
                       core_matmul_dtype=core_matmul_dtype,
                       remat_torso=resolve_remat_torso(config),
                       torso_type=config.torso_type,
                       use_instruction=config.use_instruction,
                       core_impl=core_impl,
                       conv_backend=resolve_conv_backend(config)
                       ).to(device)


def build_learner(config: Config, agent: ImpalaAgent) -> Learner:
    """The learner, after the host loop's flags are checked as the JAX
    driver checks them (``build_training_learner``)."""
    if config.transport not in ("packed", "per_leaf"):
        raise ValueError(
            f"unknown transport {config.transport!r} (packed | per_leaf)")
    if config.inflight_updates < 1:
        raise ValueError(
            f"inflight_updates must be >= 1, got "
            f"{config.inflight_updates}")
    # The JAX driver also checks updates_per_dispatch against
    # train_backend (driver.py:1989); neither flag is ported (ROADMAP.md,
    # queue 1, item 8), so there is nothing to check yet.
    if config.loss not in ("vtrace", "impact"):
        raise ValueError(
            f"unknown loss {config.loss!r} (vtrace | impact)")
    if config.replay_ratio < 0:
        raise ValueError(
            f"replay_ratio must be >= 0, got {config.replay_ratio}")
    if config.replay_ratio > 0 and config.replay_capacity < 1:
        raise ValueError(
            f"replay_capacity must be >= 1 with replay enabled, got "
            f"{config.replay_capacity}")
    if config.replay_ratio > 0 and config.transport != "packed":
        # The replay insert is the packed upload landing in the slab; the
        # per-leaf path has no single device buffer to tap.
        raise ValueError(
            "replay_ratio > 0 requires --transport=packed on the host "
            "backend (the replay slab is fed by the packed upload)")
    hp = LearnerHyperparams(
        entropy_cost=config.entropy_cost,
        baseline_cost=config.baseline_cost,
        discounting=config.discounting,
        reward_clipping=config.reward_clipping,
        learning_rate=config.learning_rate,
        total_environment_frames=config.total_environment_frames,
        rmsprop_decay=config.rmsprop_decay,
        rmsprop_momentum=config.rmsprop_momentum,
        rmsprop_epsilon=config.rmsprop_epsilon)
    return Learner(agent, hp, config.frames_per_update(),
                   scan_impl=config.scan_impl,
                   fused_forward=config.fused_forward,
                   learn_telemetry=config.learn_telemetry,
                   loss=config.loss,
                   target_update_interval=config.target_update_interval,
                   impact_clip_epsilon=config.impact_clip_epsilon)


def build_replay(config: Config, transport) -> Optional[DeviceReplayBuffer]:
    """The replay slab of a training run, or None (nothing allocated) at
    ``replay_ratio`` 0.  It stores the packed transport's uploaded
    buffers, tapped by ``set_upload_sink`` with the current ledger
    record's birth stamp (so ``ledger/staleness_replayed_s`` reads the
    frames' true age), and its samples unpack through the transport's
    ``unpack``."""
    if config.replay_ratio <= 0:
        return None
    if not isinstance(transport, PackedTransport):
        raise ValueError(
            "replay requires the packed transport on the host backend")
    replay = DeviceReplayBuffer(config.replay_capacity, seed=config.seed,
                                postprocess=transport.unpack)

    def sink(device_buf):
        ledger = get_ledger()
        tid = ledger.current()
        birth = ledger.birth_us(tid) if tid is not None else None
        replay.insert(device_buf, birth_us=birth)

    transport.set_upload_sink(sink)
    return replay


def worker_processes(requested: int, num_envs: int) -> int:
    """Env worker processes for a fleet of ``num_envs`` envs, as the JAX
    MultiEnv reads its ``num_workers``: 0 means one per env, and there is
    never more than one per env."""
    return min(requested or num_envs, num_envs)


def match_port_scheme(total_matches: int) -> int:
    """The UDP port scheme of every set of concurrent matches (training
    groups and eval fleets), as ``scalable_agent_tpu/driver.py:351-371``:
    match ``i`` probes from ``DEFAULT_UDP_PORT + stride * i`` in steps of
    ``stride * total_matches``, so no two matches race for a port, with
    at least 2 probes each under 65536.  Returns ``stride``; raises when
    ``total_matches`` do not fit."""
    from scalable_agent_tpu_torch.envs.doom.multiplayer import (
        DEFAULT_UDP_PORT,
    )

    stride = max(1, min(1000, 25000 // max(1, 8 * total_matches)))
    retries = (65536 - DEFAULT_UDP_PORT - stride * total_matches) // (
        stride * total_matches)
    if retries < 2:
        raise ValueError(
            f"{total_matches} concurrent matches do not fit the UDP "
            f"port space above {DEFAULT_UDP_PORT} with retry headroom; "
            f"reduce the fleet or lower DOOM_DEFAULT_UDP_PORT")
    return stride


def _multi_agent_groups(config: Config, num_groups: int,
                        num_agents: int) -> List:
    """The multi-agent branch of ``make_env_groups``
    (``scalable_agent_tpu/driver.py:392-442``): each group is a
    ``MultiAgentVectorEnv`` of batch_size / num_agents lockstep matches,
    each agent one batch slot; match ``i`` (over all groups) is seeded
    ``seed * total + i`` and probes its own port residue class.  This
    package runs one process: the JAX ``process_index()`` is 0 and
    ``process_count()`` 1."""
    if config.benchmark_mode:
        raise ValueError(
            "benchmark_mode is not supported for multi-agent levels")
    if config.batch_size % num_agents:
        raise ValueError(
            f"batch_size {config.batch_size} must be a multiple of the "
            f"level's num_agents ({num_agents})")
    from scalable_agent_tpu_torch.envs.doom.multiplayer import (
        DEFAULT_UDP_PORT,
        MultiAgentVectorEnv,
    )

    matches = config.batch_size // num_agents
    total = num_groups * matches
    stride = match_port_scheme(total)
    groups = []
    try:
        for g in range(num_groups):
            groups.append(MultiAgentVectorEnv([
                functools.partial(
                    create_env, config.level_name,
                    num_action_repeats=config.num_action_repeats,
                    seed=config.seed * total + g * matches + m,
                    port_base=DEFAULT_UDP_PORT + stride * (
                        g * matches + m),
                    port_increment=stride * total,
                    **env_kwargs(config))
                for m in range(matches)]))
    except BaseException:
        for envs in groups:
            envs.close()
        raise
    return groups


def make_env_groups(config: Config, frame_spec, num_agents: int = 1,
                    level_names: Optional[Sequence[str]] = None
                    ) -> List[MultiEnv]:
    """num_actors envs as groups of batch_size (each group is one learner
    batch), seeded as the JAX driver seeds them, each group stepped by
    ``num_env_workers_per_group`` worker processes (0: one per env); under
    ``benchmark_mode`` each env takes its ``BenchmarkStream``'s random
    actions, drawn from the env's own seed.  ``level_names`` (default:
    ``config.level_name``) are dealt round-robin over the global env slots
    (slot ``g * batch_size + i`` runs ``level_names[slot % len]``, as
    ``scalable_agent_tpu/driver.py:440-460``), and each group's
    ``MultiEnv`` labels its slots with their levels.  A multi-agent level
    (``num_agents > 1``, from ``probe_env``) takes groups of lockstep
    matches instead (``_multi_agent_groups``), and only one level."""
    num_groups = max(1, config.num_actors // config.batch_size)
    level_names = list(level_names or [config.level_name])
    if num_agents > 1:
        if len(level_names) > 1:
            raise ValueError(
                "multi-task training is not supported for multi-agent "
                "levels")
        return _multi_agent_groups(config, num_groups, num_agents)
    groups = []
    try:
        for g in range(num_groups):
            labels = [level_names[(g * config.batch_size + i)
                                  % len(level_names)]
                      for i in range(config.batch_size)]
            groups.append(MultiEnv([
                functools.partial(
                    make_impala_stream, labels[i],
                    seed=config.seed * 100000 + g * 1000 + i,
                    benchmark_mode=config.benchmark_mode,
                    num_action_repeats=config.num_action_repeats,
                    **env_kwargs(config, labels[i]))
                for i in range(config.batch_size)
            ], frame_spec, num_workers=worker_processes(
                config.num_env_workers_per_group, config.batch_size),
                env_labels=labels))
    except BaseException:
        for envs in groups:
            envs.close()
        raise
    return groups


def arm_faults(config: Config) -> None:
    """Arm ``--chaos_spec`` for this run.  A point that cannot fire in
    this configuration raises: ``preempt_sigterm`` lives in the
    preemption monitor, which runs only with ``preemption_grace_s > 0``."""
    if ("preempt_sigterm" in armed_points(config.chaos_spec)
            and config.preemption_grace_s <= 0):
        raise ValueError(
            "chaos_spec arms preempt_sigterm, which fires from the "
            "preemption monitor: it needs --preemption_grace_s > 0")
    configure_faults(config.chaos_spec, seed=config.seed)


def start_prefetch(pool: ActorPool, transport, device: torch.device,
                   staged: queue_lib.Queue,
                   stop: threading.Event) -> threading.Thread:
    """Start the prefetch stage: take the pool's trajectories, put them on
    ``device`` through ``transport`` on this thread's own stream and stage
    them one deep as ``(trajectory, owners, event)``: ``owners`` are the
    device tensors holding the trajectory's memory, ``event`` the upload's
    CUDA event.  The placement is the ``learner/put_trajectory`` span and
    histogram and the ledger's ``put_done`` stamp; the staged item carries
    the trajectory's ledger record (``bind``).  The thread touches its
    heartbeat at every bounded wait.  An exception is staged in place of
    a batch, after the flight recorder's dump."""
    put_hist = get_registry().histogram(
        "learner/put_trajectory_s",
        "host->device trajectory placement seconds")

    def put(item) -> None:
        watchdog = get_watchdog()
        while not stop.is_set():
            watchdog.touch()
            try:
                staged.put(item, timeout=0.5)
                return
            except queue_lib.Full:
                continue

    def prefetch_loop():
        watchdog = get_watchdog()
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        context = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
        try:
            with context:
                while not stop.is_set():
                    watchdog.touch()
                    try:
                        out = pool.get_trajectory(timeout=0.5)
                    except queue_lib.Empty:
                        continue
                    with get_tracer().span("learner/put_trajectory",
                                           cat="h2d"), put_hist.time():
                        trajectory, owners = transport.put(
                            host_trajectory(out))
                        event = None
                        if stream is not None:
                            event = torch.cuda.Event()
                            event.record(stream)
                    ledger = get_ledger()
                    ledger.stamp_current("put_done")
                    get_flight_recorder().record("queue", "put_trajectory")
                    item = (trajectory, owners, event)
                    tid = ledger.current()
                    if tid is not None:
                        ledger.bind(id(item), tid)
                    put(item)
        except Exception as exc:  # surfaces in the training loop
            recorder = get_flight_recorder()
            recorder.record("exception", type(exc).__name__,
                            {"where": "prefetch"})
            recorder.dump_all(f"exception:{type(exc).__name__}:prefetch")
            put(exc)
        finally:
            watchdog.suspend()

    thread = threading.Thread(target=prefetch_loop, daemon=True,
                              name="prefetch")
    thread.start()
    return thread


def _adopt(staged_item, device: torch.device) -> Trajectory:
    """A staged ``(trajectory, owners, event)`` made safe for the current
    stream: wait for its upload, and keep its memory (every owner: the
    leaves, or the packed buffer they are views of) from being reused by
    the prefetch stream while this stream's work on it is pending."""
    if isinstance(staged_item, Exception):
        raise staged_item
    trajectory, owners, event = staged_item
    if event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        for tensor in owners:
            tensor.record_stream(stream)
    return trajectory


def _rollback_or_exit(config: Config, ckpt: CheckpointManager,
                      learner: Learner, tracker: NonFiniteTracker) -> int:
    """The non-finite tolerance is exhausted: restore the newest VERIFIED
    checkpoint into ``learner`` (its streak zeroed, so the restored
    timeline gets the full tolerance again; the learner's heartbeat
    suspended across the read) and return its step, or raise
    ``SystemExit(71)`` under ``--no_rollback`` or when nothing restores
    (``scalable_agent_tpu/driver.py:887``), after the flight recorder's
    dump."""
    guard = "non-finite guard"
    recorder = get_flight_recorder()
    if config.no_rollback:
        log.error("%s: rollback wanted and --no_rollback is set — exiting "
                  "%d", guard, NONFINITE_EXIT_CODE)
        recorder.record("rollback", "disabled",
                        {"streak": tracker.tolerance, "reason": "nonfinite"})
        recorder.dump_all("nonfinite:no_rollback")
        raise SystemExit(NONFINITE_EXIT_CODE)
    watchdog = get_watchdog()
    try:
        restored = ckpt.restore(heartbeat="learner")
    except CheckpointIntegrityError as exc:
        log.error("%s: %s", guard, exc)
        restored = None
    if restored is None:
        log.error("%s: rollback wanted and no restorable checkpoint under "
                  "%s — exiting %d", guard, config.logdir,
                  NONFINITE_EXIT_CODE)
        recorder.record("rollback", "no_checkpoint", {"reason": "nonfinite"})
        recorder.dump_all("nonfinite:no_checkpoint")
        raise SystemExit(NONFINITE_EXIT_CODE)
    step, saved = restored
    saved["nonfinite_streak"] = torch.zeros_like(
        torch.as_tensor(saved["nonfinite_streak"]))
    # Issued on the learner's stream, so after the abandoned in-flight
    # updates, which it overwrites.
    learner.load_state_dict(saved)
    get_registry().counter(
        "learner/rollbacks_total",
        "rollbacks to the last good checkpoint after a guard's "
        "tolerance was exhausted (non-finite streak or sentinel "
        "breach)").inc()
    recorder.record("rollback", "restored",
                    {"step": step, "env_frames": learner.state.env_frames,
                     "reason": "nonfinite"})
    tracker.rebase(float(saved["nonfinite_skips"]))
    watchdog.touch("learner")
    log.warning("%s: rolled back to checkpoint step %d (%.0f frames)",
                guard, step, learner.state.env_frames)
    return step


@dataclasses.dataclass
class _ObsHandles:
    """What ``_setup_observability`` wires and its teardown unwinds."""

    registry: MetricsRegistry
    prom: PrometheusExporter
    uninstall_handlers: Callable[[], None]
    http: Optional[MetricsHTTPServer] = None


def _setup_observability(config: Config) -> _ObsHandles:
    """Arm the obs producers for one run (``driver.py:665-713``): the
    tracer under ``--trace`` (``<logdir>/trace.p0.<pid>.json``), the
    registry's device-memory gauge, ``<logdir>/metrics.prom``, the flight
    recorder and its crash handlers, the watchdog, and the scrape
    endpoint under ``--metrics_http_port`` (at that port plus the process
    index, 0 here; a port that is taken logs an error and the run goes
    on)."""
    if config.trace:
        configure_tracer(os.path.join(
            config.logdir, f"trace.p0.{os.getpid()}.json"))
    registry = get_registry().install_torch_hooks()
    prom = PrometheusExporter(
        registry, os.path.join(config.logdir, "metrics.prom"))
    recorder = configure_flight_recorder(config.logdir, registry=registry)
    recorder.exporter = prom
    uninstall = install_crash_handlers(recorder)
    configure_watchdog(config.watchdog_timeout_s, registry=registry,
                       abort=config.watchdog_abort,
                       flight_recorder=recorder)
    http = None
    if config.metrics_http_port:
        try:
            http = MetricsHTTPServer(registry, config.metrics_http_port,
                                     logdir=config.logdir)
            log.info("serving Prometheus metrics on :%d/metrics "
                     "(+ /anomalies, /health)", http.port)
        except OSError as exc:  # a taken port must not kill training
            log.error("metrics HTTP endpoint unavailable on port %d: %s",
                      config.metrics_http_port, exc)
    return _ObsHandles(registry=registry, prom=prom, http=http,
                       uninstall_handlers=uninstall)


def _teardown_observability(config: Config, handles: _ObsHandles):
    """Dump the flight recorder when an exception is unwinding (or when a
    signal handler's dump is pending), then flush the trace and the final
    metrics snapshot and remove the crash handlers."""
    recorder = get_flight_recorder()
    exc = sys.exc_info()[1]
    if exc is not None and not isinstance(exc, (SystemExit,
                                                KeyboardInterrupt)):
        recorder.dump_all(f"exception:{type(exc).__name__}")
    elif recorder.pending_dump_reason:
        recorder.dump_all(recorder.pending_dump_reason)
    configure_watchdog(None)
    if handles.http is not None:
        handles.http.close()
    if config.trace:
        configure_tracer(None)  # closes and flushes the file
    handles.prom.dump()
    handles.uninstall_handlers()


def _resolve_roofline_peak(device_kind: str,
                           compute_dtype: str) -> Optional[float]:
    """The card's peak for ``compute_dtype`` (``obs/ledger.py``
    ``PEAK_FLOPS``), overridden by ``$SCALABLE_AGENT_LEDGER_MFU_PEAK`` (as
    the JAX driver's ``_resolve_roofline_peak``), which lets the MFU and
    kernel-table path run on the CPU.  None when neither knows one."""
    peak = peak_flops(device_kind, compute_dtype)
    override = os.environ.get("SCALABLE_AGENT_LEDGER_MFU_PEAK")
    if override:
        try:
            peak = float(override)
        except ValueError:
            pass
    return peak


@dataclasses.dataclass
class KernelCosts:
    """What a profile window's kernel table is joined against: the
    update's FLOPs (``update_flops``, the ``ledger/mfu`` numerator), the
    hand-written kernels' per-call costs at the run's shapes, the peak."""

    device: torch.device
    flops: float
    handwritten: dict
    peak: Optional[float]
    device_kind: str


def kernel_costs(config: Config, device: torch.device, observation_spec,
                 action_space) -> KernelCosts:
    """``KernelCosts`` at the run's shapes and dtype policy (the policy's
    logit count from ``action_space``)."""
    shapes = (observation_spec.frame.shape,
              distributions.spec_for_space(action_space).num_logits,
              config.unroll_length, config.batch_size)
    model = dict(torso_type=config.torso_type,
                 use_instruction=config.use_instruction, loss=config.loss)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    sm_count = (torch.cuda.get_device_properties(device).multi_processor_count
                if device.type == "cuda" else 1)
    return KernelCosts(
        device=device, flops=update_flops(*shapes, **model),
        handwritten=kernels_lib.handwritten_costs(
            *shapes, compute_dtype=config.compute_dtype,
            matmul_dtype=resolve_core_matmul_dtype(config),
            sm_count=sm_count, core_impl=resolve_core_impl(config),
            conv_backend=resolve_conv_backend(config), **model),
        peak=_resolve_roofline_peak(kind, config.compute_dtype),
        device_kind=kind)


def configure_live_mfu(config: Config, ledger: PipelineLedger,
                       costs: KernelCosts) -> None:
    """Arm ``ledger/mfu``: ``update_flops`` at the run's shapes against
    the card's peak for ``compute_dtype`` (``_resolve_roofline_peak``).
    Without a peak the gauge stays at 0, with one log line."""
    if costs.peak is None:
        log.info("live MFU gauge off: no peak FLOP/s known for %s at %s "
                 "(%.4g FLOPs per update)", costs.device_kind,
                 config.compute_dtype, costs.flops)
        return
    ledger.configure_mfu(costs.flops, costs.peak)
    log.info("live MFU gauge armed: %.4g FLOPs per update against %.4g "
             "peak FLOP/s (%s, %s)", costs.flops, costs.peak,
             costs.device_kind, config.compute_dtype)


# Updates a profile window records before the ones its kernel table
# counts: on the card, launches made just after torch.profiler starts have
# gone missing from the trace (the first update's stem convolution, or
# its whole torso forward, in 2 of 5 anomaly windows).
PROFILE_WARMUP_UPDATES = 1


def _start_profile(device: torch.device):
    """A ``torch.profiler`` window over the host and, on the card, its
    kernels, with the ops' input shapes (the kernel table's costs: the
    Chrome trace carries no FLOP counts, so ``with_flops`` would add
    nothing to it); the tracer's spans open ``record_function`` ranges in
    it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities,
                                      record_shapes=True)
    profiler.start()
    get_tracer().set_annotate(True)
    return profiler


def _stop_profile(profiler, device: torch.device, trace_dir: str) -> str:
    """End the window once the card has run what it launched, and write
    its Chrome trace into ``trace_dir``; returns the path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    get_tracer().set_annotate(False)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"torch_profile.{os.getpid()}.json")
    profiler.export_chrome_trace(path)
    return path


def _harvest_kernel_ledger(config: Config, costs: KernelCosts,
                           executions: int,
                           profile_dir: Optional[str] = None,
                           out_name: Optional[str] = None
                           ) -> Optional[dict]:
    """The kernel table of a finished window (``obs/kernels.py``):
    ``<logdir>/<out_name>`` and the ``kernel/*`` gauges (the worst kernel
    also feeds the stall line).  Defaults serve the scheduled
    ``--profile_dir`` window (``kernels.json``); the health plane passes
    its window's directory and ``kernels.<anomaly_id>.json``.  Never
    raises: the table is forensics, not the training path.  Returns the
    table (None on any failure)."""
    profile_dir = profile_dir or config.profile_dir
    out_name = out_name or kernels_lib.KERNELS_JSON_NAME
    try:
        table = kernels_lib.harvest(
            profile_dir, costs.device.type, costs.flops, costs.peak,
            config.logdir, registry=get_registry(), executions=executions,
            handwritten=costs.handwritten,
            extra={"device_kind": costs.device_kind,
                   "logdir": config.logdir},
            out_name=out_name)
    except Exception:
        log.exception("kernel table harvest failed")
        return None
    if table is None:
        log.warning("kernel table: no learner kernels in a trace under %s",
                    profile_dir)
        return None
    log.info(
        "kernel table: %d kernels costed (%.0f%% of the learner's kernel "
        "time), dominant %s (%.0f%% of it), worst %s (mfu %s) — %s/%s",
        len(table["kernels"]), 100 * table["matched_time_frac"],
        table.get("dominant_kernel"),
        100 * (table.get("dominant_time_share") or 0.0),
        table.get("worst_kernel"),
        (f"{table['worst_kernel_mfu']:.3g}"
         if table.get("worst_kernel_mfu") is not None else "n/a"),
        config.logdir, out_name)
    return table


class _HealthPlane:
    """The driver's side of the run-health plane (``obs/health.py``): the
    ``HealthMonitor`` and the one anomaly-triggered profile window in
    flight (the JAX driver's ``_HealthPlane`` with ``torch.profiler`` in
    place of ``jax.profiler``).  The monitor arbitrates (budget, cooldown,
    one window at a time); this class opens and closes the window and
    harvests it into ``kernels.<anomaly_id>.json``.  Every method is a
    no-op under ``--health=false``."""

    def __init__(self, config: Config, device: torch.device):
        self.monitor = None
        self.window_id: Optional[str] = None
        self.window_dir: Optional[str] = None
        self.window_stop_at: Optional[int] = None
        self._profiler = None
        self._config = config
        self._device = device
        if not config.health:
            return
        self.monitor = HealthMonitor(
            default_detectors(
                backend="host",
                warmup=config.health_warmup_intervals,
                alpha=config.health_ewma_alpha,
                z_threshold=config.health_z_threshold,
                rel_threshold=config.health_rel_threshold),
            logdir=config.logdir,
            registry=get_registry(),
            cooldown_s=config.health_cooldown_s,
            max_windows=config.health_max_windows)

    @property
    def active(self) -> bool:
        return self.monitor is not None

    @property
    def window_open(self) -> bool:
        return self.window_stop_at is not None

    def step(self, metrics, update: int, verdict=None, evidence=None):
        """One detector pass at log cadence.  Never raises."""
        if self.monitor is None:
            return
        try:
            self.monitor.step(metrics=metrics, update=update,
                              verdict=verdict, evidence=evidence)
        except Exception:
            log.exception("health detector step failed")

    def maybe_open_window(self, updates: int) -> bool:
        """Open the pending anomaly's window, if any: its own trace
        directory under the logdir, closing ``health_window_updates``
        updates from now."""
        if self.monitor is None or self.window_open:
            return False
        anomaly_id = self.monitor.poll_window()
        if anomaly_id is None:
            return False
        trace_dir = os.path.join(self._config.logdir,
                                 f"health_profile.{anomaly_id}")
        try:
            os.makedirs(trace_dir, exist_ok=True)
            self._profiler = _start_profile(self._device)
        except Exception:
            log.exception("health profile window failed to start")
            return False
        self.window_id = anomaly_id
        self.window_dir = trace_dir
        self.window_stop_at = (updates + PROFILE_WARMUP_UPDATES
                               + self._config.health_window_updates)
        self.monitor.note_window_open(anomaly_id, trace_dir)
        log.info("health: profile window %s open through update %d (%s)",
                 anomaly_id, self.window_stop_at, trace_dir)
        return True

    def close_window(self, costs: KernelCosts,
                     executions: Optional[int] = None):
        """Stop the window and harvest its kernel table into
        ``kernels.<anomaly_id>.json``, finalizing the anomaly record with
        the worst kernel's delta against the run's scheduled window."""
        if self.monitor is None or not self.window_open:
            return
        anomaly_id, trace_dir = self.window_id, self.window_dir
        self.window_id = self.window_dir = self.window_stop_at = None
        profiler, self._profiler = self._profiler, None
        try:
            _stop_profile(profiler, self._device, trace_dir)
        except Exception:
            log.exception("health profile window failed to stop")
            get_tracer().set_annotate(False)
        out_name = f"kernels.{anomaly_id}.json"
        table = _harvest_kernel_ledger(
            self._config, costs,
            executions=(executions if executions is not None
                        else self._config.health_window_updates),
            profile_dir=trace_dir, out_name=out_name)
        self.monitor.note_window_result(
            anomaly_id, table,
            kernels_json=(os.path.join(self._config.logdir, out_name)
                          if table else None))

    def note_baseline(self, table: Optional[dict]):
        """The scheduled ``--profile_dir`` window's table: the reference
        of the anomaly windows' deltas."""
        if self.monitor is not None and table:
            self.monitor.note_baseline_kernels(table)

    def finalize(self):
        """Teardown: stop a still-open window (no harvest: the run is
        ending) and flush the open anomaly records."""
        if self.monitor is None:
            return
        if self.window_open:
            self.window_id = self.window_dir = None
            self.window_stop_at = None
            profiler, self._profiler = self._profiler, None
            try:
                profiler.stop()
            except Exception:
                pass
            get_tracer().set_annotate(False)
        try:
            self.monitor.flush()
        except Exception:
            log.exception("health flush failed")


def _bare_level(name: str) -> str:
    """A registry name without its ``dmlab_`` prefix: the score tables of
    ``envs/dmlab30.py`` hold bare level names."""
    return name[len("dmlab_"):] if name.startswith("dmlab_") else name


def _level_metrics(row: Dict[str, float], by_level,
                   num_action_repeats: int,
                   suite_returns: Dict[str, List[float]]) -> None:
    """Add the interval's per-level means to ``row`` (``by_level``, from
    ``ActorPool.drain_level_stats``: ``<level>/episode_return`` and
    ``<level>/episode_frames``, the reference's per-episode scalars,
    experiment.py:634-650, as interval means); in multi-task training
    (``suite_returns`` holds a list per DMLab-30 train level) collect the
    returns, and once every level has one, add the human-normalized
    ``dmlab30/training_no_cap`` and ``dmlab30/training_cap_100`` scores
    and start the lists over (``scalable_agent_tpu/driver.py:1513-1543``).
    """
    for level, entries in by_level.items():
        row[f"{level}/episode_return"] = float(
            np.mean([r for r, _ in entries]))
        row[f"{level}/episode_frames"] = float(
            np.mean([n for _, n in entries]) * num_action_repeats)
        bare = _bare_level(level)
        if bare in suite_returns:
            suite_returns[bare].extend(r for r, _ in entries)
    if suite_returns and min(len(v) for v in suite_returns.values()) >= 1:
        row["dmlab30/training_no_cap"] = (
            dmlab30.compute_human_normalized_score(
                suite_returns, per_level_cap=None))
        row["dmlab30/training_cap_100"] = (
            dmlab30.compute_human_normalized_score(
                suite_returns, per_level_cap=100.0))
        log.info("dmlab30 training score — no cap: %.2f cap 100: %.2f",
                 row["dmlab30/training_no_cap"],
                 row["dmlab30/training_cap_100"])
        for returns in suite_returns.values():
            returns.clear()


def train(config: Config, clock=time) -> Dict[str, float]:
    """Train until ``total_environment_frames``, or until a SIGTERM drains
    the run; returns the newest update's metrics as host floats (plus
    ``episode_return``, the mean of the pool's recent finished episodes,
    when there are any).  Raises ``SystemExit(71)`` when the non-finite
    guard cannot roll back.  ``clock`` (the ``time`` module) times the
    log intervals (``clock.monotonic``: the metrics rows' fps and actor
    fps, and so the health plane's throughput detectors) and takes the
    ``throughput_sag`` pause (``clock.sleep``); a test passes a fake
    one."""
    device = resolve_device(config.device)
    config = apply_env_overrides(config)
    config.save()
    # Multi-task (dmlab30): the first level's env stands for them all.
    level_names = training_level_names(config)
    multi_task = len(level_names) > 1
    observation_spec, action_space, num_agents = probe_env(
        dataclasses.replace(config, level_name=level_names[0])
        if multi_task else config)
    if config.actor == "service" and num_agents > 1:
        raise ValueError(
            f"--actor=service steps each env worker process on its own "
            f"(MultiEnv's per-worker API); {config.level_name}'s lockstep "
            f"multi-agent matches have none: run it with --actor=grouped")
    groups = pool = prefetch_thread = writer = learner = None
    prefetch_stop = threading.Event()
    monitor = PreemptionMonitor(config.preemption_grace_s)
    metrics: Dict[str, torch.Tensor] = {}
    profiler = None
    # The obs producers come up first, so that every thread is born with
    # the live tracer and watchdog, and the preemption handler goes over
    # the crash handlers (a second SIGTERM reaches the flight recorder).
    arm_faults(config)
    obs_handles = _setup_observability(config)
    registry, prom = obs_handles.registry, obs_handles.prom
    ledger = configure_ledger(
        registry=registry, frames_per_trajectory=config.frames_per_update(),
        logdir=config.logdir)
    # The run-health plane; built before the try, so that the finally's
    # flush always sees it.
    health = _HealthPlane(config, device)
    # Float32 convolutions and matmuls in full float32, and bf16 ones
    # summed in float32, as the JAX package runs them.  The flags are
    # process-wide: set once, before any thread starts.
    with float32_precision():
        try:
            monitor.start()
            agent = build_agent(config, observation_spec, action_space,
                                device)
            learner = build_learner(config, agent)
            costs = kernel_costs(config, device, observation_spec,
                                 action_space)
            configure_live_mfu(config, ledger, costs)
            transport = make_transport(config.transport, device)
            # Every fresh batch's upload also lands in the replay slab;
            # None at replay_ratio 0.
            replay = build_replay(config, transport)
            window = InflightWindow(config.inflight_updates,
                                    registry=registry)
            tracker = NonFiniteTracker(config.nonfinite_tolerance,
                                       registry=registry)
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
            # A resumed run must not count the checkpoint's skips again.
            tracker.rebase(float(learner.state.nonfinite_skips))
            groups = make_env_groups(config, observation_spec.frame,
                                     num_agents, level_names)
            if config.actor == "service":
                # The continuous-batching actor service: the pool's queue
                # and surface, so the prefetch stage and all after it are
                # unchanged.
                pool = ActorService(
                    agent, groups, config.unroll_length,
                    level_name=config.level_name, seed=config.seed,
                    max_batch=config.service_max_batch,
                    max_restarts=config.actor_max_restarts)
            else:
                pool = ActorPool(
                    agent, groups, config.unroll_length,
                    level_name=config.level_name, seed=config.seed,
                    max_restarts=config.actor_max_restarts)
            pool.set_params(agent, version=start_updates)
            pool.start()
            staged: queue_lib.Queue = queue_lib.Queue(maxsize=1)
            prefetch_thread = start_prefetch(pool, transport, device,
                                             staged, prefetch_stop)
            stall = StallAttributor(registry)
            actor_fps_gauge = registry.gauge(
                "actor/fps", "env frames/s generated by this host's actors")
            learner_fps_gauge = registry.gauge(
                "learner/fps", "env frames/s consumed by the learner")
            writer = MetricsWriter(config.logdir, registry=registry)
            timing = Timing()
            # This interval's sums, for the stall attributor.
            interval = Timing()
            watchdog = get_watchdog()
            injector = get_fault_injector()
            updates = start_updates
            frames = learner.state.env_frames
            last_log = clock.monotonic()
            frames_at_last_log = frames
            steps_at_last_log = pool.agent_steps
            # Multi-task: each train level's returns since the last
            # training score (reference: experiment.py:652-667).
            suite_returns: Dict[str, List[float]] = (
                {name: [] for name in dmlab30.TRAIN_LEVELS}
                if multi_task else {})
            rollback_wanted = False
            # The first update may build the kernels: it runs with the
            # learner's heartbeat suspended, as the JAX loop suspends it
            # across its first compile.
            first_dispatch = True
            while frames < config.total_environment_frames:
                if (config.profile_dir and profiler is None
                        and not health.window_open
                        and updates - start_updates
                        == config.profile_start_update):
                    profiler = _start_profile(device)
                    profile_stop_at = (updates + PROFILE_WARMUP_UPDATES
                                       + config.profile_num_updates)
                # Waiting for a batch is the stall attributor's business,
                # not a wedge: a wedged producer's own heartbeat names it.
                watchdog.suspend("learner")
                with timing.time_avg("wait_batch"), \
                        interval.add_time("wait_batch"), \
                        get_tracer().span("learner/wait_batch",
                                          cat="learner"):
                    item = staged.get()
                watchdog.touch("learner")
                trajectory = _adopt(item, device)
                ledger_tid = ledger.lookup(id(item))
                if first_dispatch:
                    watchdog.suspend("learner")
                    first_dispatch = False
                with timing.time_avg("update"), \
                        interval.add_time("update"):
                    dispatched = learner.update(trajectory)
                    # Chaos: a mid-run slowdown, inside the update's
                    # timing, so the stall attributor reads a slow device.
                    if injector.active and injector.should_fire(
                            "throughput_sag"):
                        clock.sleep(throughput_sag_s())
                if ledger_tid is not None:
                    ledger.stamp(ledger_tid, "dispatch")
                window.push(dispatched, ledger_id=ledger_tid)
                watchdog.touch("learner")
                del trajectory, item
                # The off-policy dial: replay_ratio updates on sampled
                # batches behind each fresh one, through the same window
                # with no ledger record (their frames were counted fresh;
                # their age goes to ledger/staleness_replayed_s).  After a
                # rollback's flush they wait for the slab to refill.
                if replay is not None and replay.size >= 1:
                    for _ in range(config.replay_ratio):
                        with timing.time_avg("update"), \
                                interval.add_time("update"), \
                                get_tracer().span("learner/replay_update",
                                                  cat="learner"):
                            dispatched = learner.update(replay.sample(),
                                                        fresh=False)
                        window.push(dispatched, ledger_id=None)
                        updates += 1
                        if window.full:
                            with timing.time_avg("retire"), \
                                    interval.add_time("retire"):
                                metrics = window.retire()
                        watchdog.touch("learner")
                # The snapshot's copies are queued after this update on
                # the same stream: they hold its weights, not the next's.
                pool.set_params(agent, version=updates)
                updates += 1
                frames = learner.state.env_frames
                if window.full:
                    # The loop's only wait on the card: the OLDEST update
                    # in flight, so its metrics belong to a known update.
                    with timing.time_avg("retire"), \
                            interval.add_time("retire"):
                        metrics = window.retire()
                watchdog.touch("learner")
                if profiler is not None and updates >= profile_stop_at:
                    path = _stop_profile(profiler, device,
                                         config.profile_dir)
                    profiler = None
                    log.info("profiler trace written to %s", path)
                    # The harvest reads the trace on this thread: a
                    # healthy pause.
                    watchdog.suspend("learner")
                    table = _harvest_kernel_ledger(
                        config, costs, config.profile_num_updates)
                    # The scheduled window is the health plane's
                    # baseline for the anomaly windows' deltas.
                    health.note_baseline(table)
                if health.window_open and updates >= health.window_stop_at:
                    # An anomaly window is complete: the same stop and
                    # harvest, into kernels.<anomaly_id>.json.
                    watchdog.suspend("learner")
                    health.close_window(costs)
                now = clock.monotonic()
                if now - last_log >= config.log_interval_s:
                    if not metrics:
                        # Nothing has left the window yet: log the newest
                        # update (its fetch waits for it).
                        metrics = dispatched
                    # The fetches below wait for the card: not a wedge.
                    watchdog.suspend("learner")
                    row = {k: float(v) for k, v in metrics.items()}
                    # Only record the verdict here; the rollback happens
                    # at the decision point below.
                    if tracker.observe(row):
                        rollback_wanted = True
                    elapsed = max(now - last_log, 1e-9)
                    row["fps"] = (frames - frames_at_last_log) / elapsed
                    steps = pool.agent_steps
                    row["actor_fps"] = ((steps - steps_at_last_log)
                                        * config.num_action_repeats
                                        / elapsed)
                    actor_fps_gauge.set(row["actor_fps"])
                    learner_fps_gauge.set(row["fps"])
                    stats = pool.episode_stats()
                    if stats:
                        row["episode_return"] = float(
                            np.mean([r for r, _ in stats]))
                        row["episode_frames"] = float(
                            np.mean([n for _, n in stats])
                            * config.num_action_repeats)
                    _level_metrics(row, pool.drain_level_stats(),
                                   config.num_action_repeats,
                                   suite_returns)
                    row.update({f"timing/{k}": v
                                for k, v in timing.summary().items()})
                    # The obs publication, in the JAX driver's order.
                    learner.publish_device_telemetry()
                    ledger.publish()
                    watchdog.touch("learner")
                    interval_sums = interval.summary()
                    interval.clear()
                    category, evidence = stall.attribute(
                        interval_sums.get("wait_batch", 0.0),
                        interval_sums.get("update", 0.0),
                        retire_s=interval_sums.get("retire", 0.0))
                    # The detectors over the registry stream and this
                    # interval's metrics; a trip may arm a window, opened
                    # here unless the scheduled one records.
                    if health.active:
                        health.step({**registry.snapshot(), **row},
                                    update=updates, verdict=category,
                                    evidence=evidence)
                        if profiler is None:
                            health.maybe_open_window(updates)
                    writer.write(updates, row)
                    writer.write_registry(updates)
                    prom.dump()
                    log.info(
                        "update %d frames %.3g fps %.0f (actors %.0f) "
                        "loss %.3f return %.2f | %s | %s", updates, frames,
                        row["fps"], row["actor_fps"], row["total_loss"],
                        row.get("episode_return", float("nan")), timing,
                        StallAttributor.describe(category, evidence))
                    last_log, frames_at_last_log = now, frames
                    steps_at_last_log = steps
                # The decisions, at a fixed point of every iteration.
                if monitor.preemption_requested():
                    monitor.note_preempt_decision(updates)
                    log.warning("preemption drain: stopping at update %d "
                                "(%.3g frames) for the final checkpoint",
                                updates, frames)
                    break
                if rollback_wanted:
                    rollback_wanted = False
                    updates = _rollback_or_exit(config, ckpt, learner,
                                                tracker)
                    frames = learner.state.env_frames
                    # Nothing of the abandoned timeline leaks forward: its
                    # in-flight metrics are dropped unread (their ledger
                    # records discarded), the replay slab's batches go
                    # (the dial refills from fresh ones), and the actors
                    # get the restored weights.
                    window.discard()
                    metrics = {}
                    if replay is not None:
                        replay.flush()
                    pool.set_params(agent, version=updates)
                    last_log = clock.monotonic()
                    frames_at_last_log = frames
                    steps_at_last_log = pool.agent_steps
                    interval.clear()
                    continue
                ckpt.maybe_save(updates, learner.state_dict(),
                                heartbeat="learner")
            # A slow but healthy shutdown tail is not a wedge.
            watchdog.suspend("learner")
            # The returned metrics are the newest update's.
            drained = window.drain()
            if drained is not None:
                metrics = drained
            ckpt.maybe_save(updates, learner.state_dict(), force=True,
                            heartbeat="learner")
        finally:
            # No heartbeat is watched in the teardown: it must never be
            # cut short by exit 70.
            configure_watchdog(None)
            configure_faults("")  # a spec must not outlive its run
            if profiler is not None:
                profiler.stop()
                get_tracer().set_annotate(False)
            # Before the obs teardown's final snapshot, so the health/*
            # counters land in it.
            health.finalize()
            prefetch_stop.set()
            if pool is not None:
                pool.stop()
            elif groups is not None:
                for envs in groups:
                    envs.close()
            if prefetch_thread is not None:
                prefetch_thread.join(timeout=10)
            # After the pipeline's threads (no new stamps), before the
            # final snapshot: records still in the pipeline close as
            # abandoned, and ledger.p0.json is written.
            try:
                get_ledger().finalize()
            except Exception:
                log.exception("ledger finalize failed")
            # A run shorter than the log interval still publishes its
            # device telemetry into the final snapshot.
            if learner is not None:
                try:
                    learner.publish_device_telemetry()
                except Exception:
                    log.exception("final device-telemetry publish failed")
            if writer is not None:
                writer.close()
            # The grace deadline covers the shutdown tail above; the
            # preemption handler goes before the crash handlers it was
            # installed over.
            monitor.stop()
            _teardown_observability(config, obs_handles)
    result = {name: float(value) for name, value in metrics.items()}
    returns = [r for r, _ in pool.episode_stats()]
    if returns:
        result["episode_return"] = float(np.mean(returns))
    return result


def _eval_loop(envs, config: Config, agent: ImpalaAgent,
               num_episodes: int) -> List[float]:
    """Drive an eval fleet (a ``MultiEnv`` or a ``MultiAgentVectorEnv``)
    under batched inference until ``num_episodes`` episodes complete.
    Each env slot contributes at most
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
        action = agent.zero_actions(batch).numpy()
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
    stepped under one batched inference call; under ``record_to`` env
    ``i`` records into ``<record_to>/<level>/env_NN``."""
    batch = max(1, min(num_episodes, config.test_batch_size))
    fns = [functools.partial(
               make_impala_stream, level_name,
               seed=config.seed * 977 + 131 * i,
               num_action_repeats=config.num_action_repeats,
               # One directory per (level, env slot): recorders never
               # interleave episode numbers.
               record_to=(os.path.join(config.record_to, level_name,
                                       f"env_{i:02d}")
                          if config.record_to else ""),
               **env_kwargs(config, level_name))
           for i in range(batch)]
    envs = MultiEnv(fns, frame_spec,
                    num_workers=worker_processes(config.test_num_workers,
                                                 batch))
    return _eval_loop(envs, config, agent, num_episodes)


def _eval_multi_agent(config: Config, agent: ImpalaAgent, num_agents: int,
                      num_episodes: int) -> List[float]:
    """Self-play eval of a lockstep multi-agent level
    (``scalable_agent_tpu/driver.py:2568-2616``): test_batch_size /
    num_agents matches (rounded down, with a log line, when it is not a
    multiple), every slot driven by the same policy under one batched
    call, each slot's episode returns pooled.  Match ``m`` is seeded
    ``seed * 977 + 131 * m`` and probes its own port residue class; under
    ``record_to`` it records into ``<record_to>/<level>/match_NN``, one
    ``player_NN`` directory per agent."""
    from scalable_agent_tpu_torch.envs.doom.multiplayer import (
        DEFAULT_UDP_PORT,
        MultiAgentVectorEnv,
    )

    matches = max(1, config.test_batch_size // num_agents)
    if matches * num_agents != config.test_batch_size:
        log.info(
            "test_batch_size %d is not a multiple of num_agents %d; "
            "evaluating %d matches (%d agent slots)",
            config.test_batch_size, num_agents, matches,
            matches * num_agents)
    stride = match_port_scheme(matches)
    envs = MultiAgentVectorEnv([
        functools.partial(
            create_env, config.level_name,
            num_action_repeats=config.num_action_repeats,
            seed=config.seed * 977 + 131 * m,
            port_base=DEFAULT_UDP_PORT + stride * m,
            port_increment=stride * matches,
            record_to=(os.path.join(config.record_to, config.level_name,
                                    f"match_{m:02d}")
                       if config.record_to else None),
            **env_kwargs(config))
        for m in range(matches)
    ])
    return _eval_loop(envs, config, agent, num_episodes)


def _write_suite_scores(config: Config,
                       level_returns: Dict[str, List[float]]) -> dict:
    """The DMLab-30 suite scores of an eval over every test level
    (``level_returns`` by registry name), logged and written to
    ``<logdir>/eval_scores.json`` under the JAX keys
    (``scalable_agent_tpu/driver.py:2691-2716``); returns them."""
    by_level = {_bare_level(name): r for name, r in level_returns.items()}
    scores = {
        "human_normalized_no_cap": dmlab30.compute_human_normalized_score(
            by_level, per_level_cap=None),
        "human_normalized_cap_100": dmlab30.compute_human_normalized_score(
            by_level, per_level_cap=100.0),
        "episodes_per_level": config.test_num_episodes,
        "mean_returns": {k: float(np.mean(v)) for k, v in by_level.items()},
    }
    log.info("suite score — no cap: %.2f  cap 100: %.2f",
             scores["human_normalized_no_cap"],
             scores["human_normalized_cap_100"])
    path = os.path.join(config.logdir, "eval_scores.json")
    os.makedirs(config.logdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(scores, f, indent=2)
    log.info("suite scores written to %s", path)
    return scores


def test(config: Config) -> Dict[str, List[float]]:
    """Evaluate the newest verified checkpoint of ``config.logdir``:
    ``test_num_episodes`` returns of ``level_name`` (self-play over
    lockstep matches on a multi-agent level), recorded under
    ``record_to`` when it is set.  ``--level_name=dmlab30`` evaluates every
    DMLab-30 test level (the first one's env probed for them all) and
    writes the suite scores (``_write_suite_scores``); a single DMLab-30
    level logs its human-normalized score.  The checkpoint's
    ``torso_type`` and ``use_instruction`` win over the flags and the
    family's defaults, so a checkpoint without an instruction evaluates
    under ``dmlab30`` too."""
    device = resolve_device(config.device)
    config = apply_env_overrides(config)
    # The architecture belongs to the checkpoint, not to the eval flags:
    # the fields that shape the parameter tree are the trained run's.
    saved_path = os.path.join(config.logdir, "config.json")
    if os.path.exists(saved_path):
        saved = Config.load(saved_path)
        config = dataclasses.replace(
            config, torso_type=saved.torso_type,
            use_instruction=saved.use_instruction)
    suite = config.level_name == "dmlab30"
    level_names = ([f"dmlab_{name}" for name in dmlab30.TEST_LEVELS]
                   if suite else [config.level_name])
    observation_spec, action_space, num_agents = probe_env(
        dataclasses.replace(config, level_name=level_names[0])
        if suite else config)
    restored = CheckpointManager(config.logdir).restore()
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint under {config.logdir}/checkpoints")
    step, saved_state = restored
    level_returns: Dict[str, List[float]] = {}
    with float32_precision():
        agent = build_agent(config, observation_spec, action_space, device)
        agent.load_state_dict(saved_state["params"])
        if num_agents > 1:
            level_returns[config.level_name] = _eval_multi_agent(
                config, agent, num_agents, config.test_num_episodes)
        else:
            for level_name in level_names:
                level_returns[level_name] = _eval_level(
                    config, agent, level_name, observation_spec.frame,
                    config.test_num_episodes)
    for level_name, returns in level_returns.items():
        log.info("level %s: mean return %.2f over %d episodes (checkpoint "
                 "step %d)", level_name, float(np.mean(returns)),
                 len(returns), step)
    if suite:
        _write_suite_scores(config, level_returns)
    else:
        bare = _bare_level(config.level_name)
        record = dmlab30.LEVELS.get(bare, dmlab30._BY_TEST_NAME.get(bare))
        if record is not None:
            returns = level_returns[config.level_name]
            log.info("human-normalized: %.2f%%",
                     (np.mean(returns) - record.random)
                     / (record.human - record.random) * 100.0)
    return level_returns


def main(argv: Optional[Sequence[str]] = None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    config = Config.from_argv(argv, description=__doc__)
    if config.mode == "test":
        return test(config)
    return train(config)
