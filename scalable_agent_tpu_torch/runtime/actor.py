"""Actors: batched inference over env groups, packed into [T+1, B]
trajectories, on threads that feed the learner.

The counterpart of ``scalable_agent_tpu/runtime/actor.py``:

- ``VectorActor`` drives one env group.  Each unroll starts with the
  previous unroll's last entry (the T+1 overlap, reference:
  experiment.py:311-321), and the first-ever unroll bootstraps from a zero
  action (``ImpalaAgent.zero_actions``: [B], or [B, K] for a composite
  policy) and a zero agent output (experiment.py:243-251).  Inference runs
  ``actor_step`` under ``torch.no_grad()``, so the LSTM core takes its
  lean kernel.  The agent's dtype policy holds here as in the learner:
  at ``compute_dtype=bfloat16`` the torso and heads cast their float32
  parameters at each step, as the JAX actor's jitted step does, and the
  lean kernel reads the float32 Wi/Wh and rounds them to bf16 in
  registers, so no bf16 copy of them is kept per ``load_params``.
- ``ActorPool`` (``inference_mode="structural"``, the default) runs one
  thread per group, each on its own CUDA stream, with a private copy of
  the agent.  Trajectories (numpy) go through a bounded queue of one slot
  per group.  The pool's other inference modes are the JAX pool's:
  ``service`` (the groups' requests co-batched by the native batcher,
  ``runtime/native_batcher.py``), ``accum`` and ``accum_fused``
  (trajectories accumulated on the device, ``runtime/accum_actor.py``;
  the fused mode's shard count from the link probe,
  ``runtime/linktune.py``).
  The learner publishes weights with ``set_params``: a clone of its
  parameters made on its own stream, with a CUDA event recorded after it
  (``snapshot_params_for_inference``).  An actor picks up the newest
  snapshot at the start of each unroll, makes its stream wait on the
  event, and copies the snapshot into its private agent, so it never
  reads weights the learner is updating in place.
- ``ActorPool.drain_level_stats`` (``drain_level_stats``) hands over the
  episodes its groups' ``MultiEnv``s attributed to their slots' levels
  since the last drain: multi-task training's per-level metrics and
  DMLab-30 training scores (``driver._level_metrics``).
- ``run_with_retry`` gives a failing actor thread a bounded, windowed
  number of respawns with capped exponential backoff; the terminal
  exception goes through the queue and is raised by ``get_trajectory``.
- Two fault points (``runtime/faults.py``) sit at the top of each unroll:
  ``actor_raise`` raises into that retry, ``worker_kill`` SIGKILLs one of
  the group's env worker processes for ``MultiEnv`` to respawn.
- Observability (``obs/``), as in the JAX actor: each step's
  ``actor/inference`` and ``actor/env_step`` spans and the
  ``actor/inference_s`` and ``actor/env_step_s`` histograms (the stall
  attributor's input), a watchdog touch per step (the actor's first
  unroll, a first-use kernel build among it, runs with the heartbeat
  suspended until its second step), the ``actor/unroll`` span, the queue
  hand-off's ``batcher/queue_put``/``batcher/queue_get`` spans, the
  pool's queue gauges and actor counters, and the pipeline ledger's
  record of each trajectory from its birth (the unroll's start) through
  ``unroll_done``, ``queue_put`` and ``queue_get``.

The continuous-batching actor service (``--actor=service``) is
``runtime/service.py``.
"""

import contextlib
import copy
import functools
import logging
import queue as queue_lib
import threading
import time
import weakref
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.vector import MultiEnv
from scalable_agent_tpu_torch.models.agent import (
    ImpalaAgent,
    actor_step,
    grouped_actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.obs import (
    get_flight_recorder,
    get_ledger,
    get_registry,
    get_tracer,
    get_watchdog,
)
from scalable_agent_tpu_torch.obs.ledger import now_us as ledger_now_us
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector
from scalable_agent_tpu_torch.types import (
    ActorOutput,
    AgentOutput,
    AgentState,
    map_structure,
)

log = logging.getLogger("scalable_agent_tpu_torch")

# The JAX ActorPool's inference modes (ActorPool's docstring).
INFERENCE_MODES = ("structural", "service", "accum", "accum_fused")
# --inference_mode=service: how long the batcher waits for the other
# groups' requests before it runs a partial batch (the JAX pool's default).
SERVICE_TIMEOUT_MS = 5.0

# run_with_retry: the longest backoff between restarts, and the window
# after which a restart no longer counts against the budget.
RESTART_BACKOFF_CAP_S = 30.0
RESTART_WINDOW_S = 600.0


def actor_stage_histograms(registry=None):
    """The per-step histograms every actor feeds and the stall attributor
    reads: (env_step_s, inference_s)."""
    registry = registry or get_registry()
    return (
        registry.histogram(
            "actor/env_step_s",
            "seconds per vectorized env step (send+recv)"),
        registry.histogram(
            "actor/inference_s",
            "seconds per batched inference step (dispatch+fetch)"),
    )


def pool_instruments(owner, queue, registry=None):
    """The registry instruments every actor front end (``ActorPool``, the
    actor service) publishes: the queue's depth and bound and the newest
    weight version (``owner._params_version``) as gauges, sampled by
    callback through weak references (the process-global registry must
    not keep a finished front end alive), and the agent-steps,
    trajectories and restarts counters, returned in that order."""
    registry = registry or get_registry()
    queue_ref = weakref.ref(queue)
    registry.gauge(
        "actor_pool/queue_depth",
        "trajectories staged for the learner",
        fn=lambda: (q.qsize() if (q := queue_ref()) is not None else 0.0))
    registry.gauge(
        "actor_pool/queue_capacity",
        "trajectory queue bound").set(queue.maxsize)
    owner_ref = weakref.ref(owner)
    registry.gauge(
        "actor_pool/params_version",
        "newest published weight snapshot",
        fn=lambda: (o._params_version if (o := owner_ref()) is not None
                    else 0.0))
    return (
        registry.counter(
            "actor/agent_steps_total",
            "agent steps generated across all groups (x action repeats "
            "= env frames)"),
        registry.counter(
            "actor/trajectories_total", "unrolls handed to the queue"),
        registry.counter(
            "actor/restarts_total",
            "actor-thread respawns after a transient failure (the "
            "per-actor detail rides the flight recorder's "
            "actor_restart events)"),
    )


def kill_first_worker(envs: MultiEnv) -> None:
    """``worker_kill``: SIGKILL the group's first live env worker process
    (an accum-fused actor's first group's); MultiEnv's respawn must absorb
    it."""
    for proc in envs._procs:
        if proc is not None and proc.is_alive():
            log.warning("chaos: killing env worker pid %d", proc.pid)
            proc.kill()
            return


def to_numpy(tree):
    """Tensors -> numpy arrays (arrays stay as they are, None stays
    None)."""
    return map_structure(
        lambda t: (None if t is None
                   else t.detach().cpu().numpy()
                   if isinstance(t, torch.Tensor) else np.asarray(t)),
        tree)


def to_device(tree, device):
    """Host arrays -> tensors on ``device`` (None stays None)."""
    return map_structure(
        lambda a: None if a is None else torch.as_tensor(a, device=device),
        tree)


def _stack_time(entries):
    """List of [B, ...] tuples -> one [T, B, ...] tuple."""
    return map_structure(
        lambda *xs: None if xs[0] is None else np.stack(xs), *entries)


class ParamsSnapshot(NamedTuple):
    """One published weight version: detached copies of the agent's
    parameters (in ``parameters()`` order), on the card the event
    recorded after the copies on the publishing stream, and the
    publishing agent's ``dtype_policy`` (None: leave the loader's)."""

    version: int
    tensors: Tuple[torch.Tensor, ...]
    event: Optional[torch.cuda.Event]
    policy: Optional[Tuple[torch.dtype, str]] = None


@torch.no_grad()
def snapshot_params_for_inference(agent: ImpalaAgent,
                                  version: int) -> ParamsSnapshot:
    """Clone ``agent``'s parameters on the current stream; the copies
    belong to the snapshot alone, so in-place learner updates cannot reach
    them."""
    tensors = tuple(p.detach().clone() for p in agent.parameters())
    event = None
    if tensors and tensors[0].is_cuda:
        event = torch.cuda.Event()
        event.record()
    return ParamsSnapshot(version, tensors, event, agent.dtype_policy)


@torch.no_grad()
def load_snapshot(agent: ImpalaAgent, snapshot: ParamsSnapshot) -> None:
    """Copy a published snapshot into ``agent`` on the current stream,
    after the stream has waited for the snapshot's copies, and take its
    dtype policy (changed only by the numerics sentinel's demotion)."""
    if snapshot.policy is not None and snapshot.policy != agent.dtype_policy:
        agent.set_dtype_policy(*snapshot.policy)
    stream = None
    if snapshot.event is not None:
        stream = torch.cuda.current_stream(next(agent.parameters()).device)
        stream.wait_event(snapshot.event)
    for param, value in zip(agent.parameters(), snapshot.tensors):
        param.copy_(value)
        if stream is not None:
            # Keep the snapshot's memory from being reused by the
            # publishing stream before this copy has run.
            value.record_stream(stream)


def publish_trajectory(queue, trajectory, stop: threading.Event, *,
                       actor_name: str, level_name: str = "",
                       birth_us: Optional[int] = None) -> bool:
    """Hand one trajectory to the learner queue with its provenance: the
    ledger record opened at the unroll's birth (its frames the ledger's
    ``frames_per_trajectory``, env frames) and bound to the trajectory
    object, re-touching the watchdog while the bounded queue is full
    (backpressure is not a wedge).  A hand-off that shutdown catches
    closes the record as ``abandoned``.  True when delivered."""
    ledger = get_ledger()
    watchdog = get_watchdog()
    tid = ledger.open(actor_name, level_name or "actor", birth_us=birth_us)
    ledger.stamp(tid, "unroll_done")
    ledger.bind(id(trajectory), tid)
    delivered = False
    with get_tracer().span("batcher/queue_put", cat="queue"):
        while not stop.is_set():
            watchdog.touch()
            try:
                queue.put(trajectory, timeout=0.1)
                delivered = True
                break
            except queue_lib.Full:
                continue
    if delivered:
        ledger.stamp(tid, "queue_put")
        get_flight_recorder().record("queue", "put")
    else:
        ledger.lookup(id(trajectory))  # drop the binding
        ledger.close(tid, retired=False, fate="abandoned")
    return delivered


def deliver_error(queue, exc: Exception, stop: threading.Event) -> None:
    """Hand a producer's terminal exception to the queue's consumer."""
    while not stop.is_set():
        try:
            queue.put(exc, timeout=0.1)
            return
        except queue_lib.Full:
            continue


def consume_trajectory(queue, timeout: Optional[float] = None):
    """The learner-side half of the hand-off: pop one item, re-raise a
    marshalled producer exception, and make the item's ledger record the
    calling thread's current one (the transport stamps it)."""
    with get_tracer().span("batcher/queue_get", cat="queue"):
        item = queue.get(timeout=timeout)
    get_flight_recorder().record("queue", "get")
    if isinstance(item, Exception):
        raise item
    ledger = get_ledger()
    tid = ledger.lookup(id(item))
    if tid is not None:
        ledger.stamp(tid, "queue_get")
    ledger.set_current(tid)
    return item


def merged_episode_stats(envs_iter):
    """Completed-episode (return, length) ring buffers merged across a
    fleet of MultiEnvs."""
    stats = []
    for envs in envs_iter:
        stats.extend(envs.episode_stats)
    return stats


def drain_level_stats(envs_iter):
    """Pop every level-attributed episode finished since the last drain:
    {level_name: [(episode_return, episode_length), ...]}, from each
    ``MultiEnv``'s ``level_episode_stats`` (fed when it has
    ``env_labels``).  It feeds multi-task training's per-level metrics
    and the DMLab-30 training score (reference: experiment.py:634-667,
    which clears its per-level lists after each score: draining counts
    each episode once).  ``popleft`` is atomic, so actor threads may go on
    appending during the drain."""
    by_level = {}
    for envs in envs_iter:
        queue = getattr(envs, "level_episode_stats", None)
        if not queue:
            continue
        while True:
            try:
                level, ret, length = queue.popleft()
            except IndexError:
                break
            by_level.setdefault(level, []).append((ret, length))
    return by_level


def run_with_retry(loop_fn: Callable[[], None], *, stop: threading.Event,
                   deliver: Callable[[Exception], None],
                   reset: Optional[Callable[[], None]] = None,
                   max_restarts: int = 3, backoff_s: float = 0.5,
                   on_restart: Optional[Callable[[], None]] = None) -> None:
    """Bounded-respawn shell around a producer thread's loop.

    ``loop_fn`` runs until a clean stop or an exception.  A failure gets
    ``max_restarts`` respawns within a sliding ``RESTART_WINDOW_S``
    (isolated faults far apart age out) with exponential backoff capped at
    ``RESTART_BACKOFF_CAP_S``, ``reset()`` called before each retry; the
    terminal exception goes to ``deliver(exc)``."""
    recorder = get_flight_recorder()
    thread_name = threading.current_thread().name
    restart_times = deque()
    try:
        while not stop.is_set():
            try:
                loop_fn()
                return  # clean stop
            except Exception as exc:
                if stop.is_set():
                    return  # shutdown cascade
                recorder.record("exception", type(exc).__name__,
                                {"where": thread_name})
                now = time.monotonic()
                while (restart_times
                       and now - restart_times[0] > RESTART_WINDOW_S):
                    restart_times.popleft()
                if len(restart_times) >= max_restarts:
                    # The dump keeps this thread's last moments even if
                    # the driver never takes the exception.
                    recorder.dump_all(
                        f"exception:{type(exc).__name__}:{thread_name}")
                    deliver(exc)
                    return
                restart_times.append(now)
                backoff = min(RESTART_BACKOFF_CAP_S,
                              backoff_s * 2 ** (len(restart_times) - 1))
                if on_restart is not None:
                    on_restart()
                recorder.record(
                    "actor_restart", thread_name,
                    {"restart": len(restart_times), "max": max_restarts,
                     "backoff_s": round(backoff, 3),
                     "error": type(exc).__name__})
                log.error("actor %s failed (%s: %s); restart %d/%d in the "
                          "%.0fs window, retrying in %.2fs", thread_name,
                          type(exc).__name__, exc, len(restart_times),
                          max_restarts, RESTART_WINDOW_S, backoff)
                # The backoff is not a wedge; the next touch re-arms.
                get_watchdog().suspend()
                if reset is not None:
                    try:
                        reset()
                    except Exception:
                        log.exception("actor %s reset failed before retry",
                                      thread_name)
                stop.wait(backoff)
    finally:
        get_watchdog().suspend()


class VectorActor:
    """One env group: batched inference + trajectory accumulation.

    ``step_fn`` (``ActorPool``'s service mode) replaces the actor's own
    inference: ``step_fn(last_action, env_output, core_state)`` on host
    arrays returns ``(AgentOutput, AgentState)`` as host arrays; the actor
    then neither runs nor loads its agent, whose shapes alone it reads."""

    def __init__(self, agent: ImpalaAgent, envs: MultiEnv,
                 unroll_length: int, level_name: str = "", seed: int = 0,
                 step_fn: Optional[Callable] = None):
        self._agent = agent
        self._envs = envs
        self._unroll_length = unroll_length
        self.level_name = level_name
        self._step_fn = step_fn
        self._device = next(agent.parameters()).device
        self._generator = None
        if step_fn is None:
            self._generator = torch.Generator(device=self._device)
            self._generator.manual_seed(seed)
        self._loaded = None  # the ParamsSnapshot copied into the agent
        self._last_env_output = None
        self._last_agent_output = None
        self._core_state = None
        self._stepped = False
        # When the newest unroll began (the ledger's clock): its
        # trajectory's birth.
        self.unroll_birth_us = None
        self._h_env, self._h_infer = actor_stage_histograms()

    @property
    def envs(self) -> MultiEnv:
        return self._envs

    def load_params(self, snapshot: ParamsSnapshot) -> None:
        """Copy a published snapshot into this actor's agent
        (``load_snapshot``), unless it is the one loaded last.  Under a
        ``step_fn`` the batcher's consumer loads the snapshots instead."""
        if self._step_fn is None and snapshot is not self._loaded:
            load_snapshot(self._agent, snapshot)
            self._loaded = snapshot

    def _bootstrap(self):
        batch = self._envs.num_envs
        self._last_env_output = self._envs.initial()
        self._core_state = initial_state(
            batch, self._agent.core_size,
            "cpu" if self._step_fn is not None else self._device)
        self._last_agent_output = AgentOutput(
            action=self._agent.zero_actions(batch).numpy(),
            policy_logits=np.zeros((batch, self._agent.num_logits),
                                   np.float32),
            baseline=np.zeros((batch,), np.float32))

    def run_unroll(self, params: Optional[ParamsSnapshot] = None
                   ) -> ActorOutput:
        """Generate one [T+1, B] trajectory batch (numpy), under
        ``params`` when given, else under the agent's weights as they
        are."""
        self.unroll_birth_us = ledger_now_us()
        tracer = get_tracer()
        watchdog = get_watchdog()
        if not self._stepped:
            # Set-up, not progress: the envs' first reset and the first
            # step, which may build the kernels.
            watchdog.suspend()
        if params is not None:
            self.load_params(params)
        if self._last_env_output is None:
            self._bootstrap()
        env_entries = [self._last_env_output]
        agent_entries = [self._last_agent_output]
        first_state = to_numpy(self._core_state)
        env_output = self._last_env_output
        agent_output = self._last_agent_output
        core_state = self._core_state
        for _ in range(self._unroll_length):
            if self._stepped:
                watchdog.touch()  # per-step heartbeat: one dict store
            t0 = time.perf_counter()
            with tracer.span("actor/inference", cat="actor"):
                agent_output, core_state = self._infer(
                    agent_output, env_output, core_state)
            t1 = time.perf_counter()
            # Wait on the env pipes; other groups' inference runs
            # meanwhile.
            with tracer.span("actor/env_step", cat="actor"):
                self._envs.step_send(agent_output.action)
                env_output = self._envs.step_recv()
            self._h_infer.observe(t1 - t0)
            self._h_env.observe(time.perf_counter() - t1)
            self._stepped = True
            env_entries.append(env_output)
            agent_entries.append(agent_output)
        self._last_env_output = env_output
        self._last_agent_output = agent_output
        self._core_state = core_state
        return ActorOutput(
            level_name=self.level_name,
            agent_state=AgentState(*first_state),
            env_outputs=_stack_time(env_entries),
            agent_outputs=_stack_time(agent_entries))

    def _infer(self, agent_output: AgentOutput, env_output,
               core_state: AgentState):
        """One inference step: host agent output and the new state."""
        if self._step_fn is not None:
            return self._step_fn(agent_output.action, env_output,
                                 core_state)
        out, core_state = actor_step(
            self._agent, self._generator,
            torch.as_tensor(agent_output.action, device=self._device),
            to_device(env_output, self._device), core_state)
        return to_numpy(out), core_state

    def reset(self):
        """Drop the carried unroll state after a mid-unroll failure:
        re-align the env pipes and force a fresh bootstrap."""
        self._envs.resync()
        self._last_env_output = None
        self._last_agent_output = None
        self._core_state = None

    def close(self):
        self._envs.close()


class ActorPool:
    """N env groups on threads, feeding a bounded queue.

    Group ``i`` samples from a generator seeded ``seed + 1000 * i``, as in
    the JAX pool, in every inference mode; the queue holds one trajectory
    per group.  ``set_params`` must run before ``start``.  The modes (the
    JAX ``ActorPool``'s):

    - ``structural`` (default): one ``VectorActor`` thread per group, each
      with a private copy of the agent on its own stream, one
      ``actor_step`` on its group's [B] rows a step.
    - ``service``: the groups' ``VectorActor`` threads submit each step's
      request to a ``NativeBatcher`` (the C++ dynamic-batching core),
      whose consumer thread co-batches the k groups that arrived within
      ``SERVICE_TIMEOUT_MS`` (padded up ``bucket_ladder(groups)``) into ONE
      ``grouped_actor_step`` over their [k*B] rows, on its own stream with
      its own copy of the agent; each group's rows are sampled from that
      group's generator, so the actions are the structural pool's
      (reference: dynamic_batching.py:65-102 + batcher.cc).
    - ``accum``: one ``AccumVectorActor`` thread per group: the
      trajectory accumulates on the device, frames go up once and only
      the actions come down (``runtime/accum_actor.py``).
    - ``accum_fused``: ``fused_shards`` lockstep ``GroupedAccumActor``
      threads over a balanced split of the groups, each one step on its
      groups' [k*B] rows and one action fetch; 0 probes the link and picks
      the count (``runtime/linktune.py``).

    The accum modes read the frame shape from ``MultiEnv.frame_slab()`` and
    the optional observation streams' shapes from ``observation_spec``.
    """

    def __init__(self, agent: ImpalaAgent, env_groups: Sequence[MultiEnv],
                 unroll_length: int, level_name: str = "", seed: int = 0,
                 inference_mode: str = "structural", max_restarts: int = 3,
                 restart_backoff_s: float = 0.5, observation_spec=None,
                 fused_shards: int = 0):
        if inference_mode not in INFERENCE_MODES:
            raise ValueError(f"unknown inference_mode {inference_mode!r}")
        if inference_mode != "structural":
            sizes = {envs.num_envs for envs in env_groups}
            if len(sizes) > 1:
                raise ValueError(
                    f"{inference_mode.split('_')[0]} inference needs "
                    f"uniform group sizes, got {sorted(sizes)}")
        self._device = next(agent.parameters()).device
        self._inference_mode = inference_mode
        self.fused_shards = 0
        self.link = None  # the probed LinkProfile (accum_fused_shards=0)
        self._batcher = None
        self._batcher_lock = threading.Lock()
        private = lambda: copy.deepcopy(agent).requires_grad_(False)
        seeds = [seed + 1000 * i for i in range(len(env_groups))]
        if inference_mode == "structural":
            self._actors = [
                VectorActor(private(), envs, unroll_length,
                            level_name=level_name, seed=seeds[i])
                for i, envs in enumerate(env_groups)]
        elif inference_mode == "service":
            self._service_max = len(env_groups)
            # The consumer thread's: its agent, the groups' generators, its
            # stream (made on that thread) and the snapshot it loaded.
            self._service_agent = private()
            self._service_generators = []
            for group_seed in seeds:
                generator = torch.Generator(device=self._device)
                generator.manual_seed(group_seed)
                self._service_generators.append(generator)
            self._service_stream = None
            self._service_loaded = None
            self._actors = [
                VectorActor(agent, envs, unroll_length,
                            level_name=level_name,
                            step_fn=functools.partial(
                                self._service_request, i))
                for i, envs in enumerate(env_groups)]
        else:
            self._actors = self._accum_actors(
                agent, env_groups, unroll_length, level_name, seeds,
                observation_spec, fused_shards, private)
        self.queue = queue_lib.Queue(maxsize=len(env_groups))
        self._params = None
        self._params_version = 0
        self._params_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._max_restarts = max(0, int(max_restarts))
        self._restart_backoff_s = float(restart_backoff_s)
        self._counts_lock = threading.Lock()
        # Agent steps handed to the queue (x action repeats = env frames)
        # and actor-thread respawns.
        self.agent_steps = 0
        self.restarts = 0
        self._steps_per_trajectory = unroll_length * (
            env_groups[0].num_envs if env_groups else 0)
        (self._steps_counter, self._trajectories_counter,
         self._restarts_counter) = pool_instruments(self, self.queue)

    def _accum_actors(self, agent, env_groups, unroll_length, level_name,
                      seeds, observation_spec, fused_shards, private):
        """The accum modes' actors over one ``AccumPrograms``."""
        from scalable_agent_tpu_torch.runtime.accum_actor import (
            AccumPrograms,
            AccumVectorActor,
            GroupedAccumActor,
        )
        from scalable_agent_tpu_torch.runtime.linktune import (
            resolve_fused_shards,
        )

        instruction = getattr(observation_spec, "instruction", None)
        measurements = getattr(observation_spec, "measurements", None)
        frame_shape = env_groups[0].frame_slab().shape[1:]
        batch = env_groups[0].num_envs
        programs = AccumPrograms(
            agent, unroll_length, batch, frame_shape,
            instruction_shape=(None if instruction is None
                               else instruction.shape),
            measurements_shape=(None if measurements is None
                                else measurements.shape))
        if self._inference_mode == "accum":
            return [AccumVectorActor(programs, envs, level_name=level_name,
                                     seed=seeds[i], agent=private())
                    for i, envs in enumerate(env_groups)]
        shards, self.link = resolve_fused_shards(
            fused_shards, len(env_groups), batch,
            int(np.prod(frame_shape)), device=self._device)
        if self.link is not None:
            log.info("auto accum_fused_shards=%d (probed rtt %.3f ms, h2d "
                     "%.0f MB/s, %d groups x %d envs)", shards,
                     self.link.rtt_s * 1e3,
                     self.link.h2d_bytes_per_s / 1e6, len(env_groups),
                     batch)
        self.fused_shards = shards
        # A balanced split into exactly ``shards`` lockstep drivers (4
        # groups over 3 shards: [2, 1, 1]).
        base, extra = divmod(len(env_groups), shards)
        bounds = [0]
        for s in range(shards):
            bounds.append(bounds[-1] + base + (1 if s < extra else 0))
        return [GroupedAccumActor(programs, env_groups[lo:hi],
                                  level_name=level_name,
                                  seeds=seeds[lo:hi], agent=private())
                for lo, hi in zip(bounds, bounds[1:])]

    # -- service mode ------------------------------------------------------

    def _service_request(self, group: int, last_action, env_output,
                         core_state: AgentState):
        """``VectorActor``'s ``step_fn`` under ``service``: one group's
        request to the shared batcher; the consumer computes it under the
        newest snapshot at batch time."""
        sample = (np.int32(group), np.asarray(last_action),
                  to_numpy(env_output), *to_numpy(core_state))
        out, c, h = self._ensure_batcher(sample).compute(sample)
        return out, AgentState(c=c, h=h)

    def _ensure_batcher(self, example_sample):
        from scalable_agent_tpu_torch.runtime.batcher import bucket_ladder
        from scalable_agent_tpu_torch.runtime.native_batcher import (
            NativeBatcher,
        )

        with self._batcher_lock:
            if self._batcher is None:
                _, action, _, c, _ = example_sample
                batch = action.shape[0]
                # Built from shapes: a computed example would draw from a
                # group's generator.
                example_result = (
                    AgentOutput(action=np.zeros_like(action),
                                policy_logits=np.zeros(
                                    (batch, self._service_agent.num_logits),
                                    np.float32),
                                baseline=np.zeros((batch,), np.float32)),
                    np.zeros_like(c), np.zeros_like(c))
                self._batcher = NativeBatcher(
                    self._service_compute, example_sample=example_sample,
                    example_result=example_result, minimum_batch_size=1,
                    maximum_batch_size=self._service_max,
                    timeout_ms=SERVICE_TIMEOUT_MS,
                    pad_to_sizes=bucket_ladder(self._service_max))
            return self._batcher

    def _service_compute(self, batched, k: int):
        """The batcher's consumer: k co-batched group requests (padded to
        [padded, B, ...]) -> one ``grouped_actor_step`` over their rows,
        group ``gid`` sampled from its own generator; the k valid groups'
        outputs."""
        group, action, env_output, c, h = batched
        batch = action.shape[1]
        rows = action.shape[0] * batch
        flat = lambda a: None if a is None else torch.as_tensor(
            a.reshape((rows,) + a.shape[2:]), device=self._device)
        if self._device.type == "cuda" and self._service_stream is None:
            self._service_stream = torch.cuda.Stream(self._device)
        context = (torch.cuda.stream(self._service_stream)
                   if self._service_stream is not None
                   else contextlib.nullcontext())
        with context:
            snapshot = self._get_params()
            if snapshot is not self._service_loaded:
                load_snapshot(self._service_agent, snapshot)
                self._service_loaded = snapshot
            out, state = grouped_actor_step(
                self._service_agent,
                [self._service_generators[int(g)] for g in group[:k]],
                batch, flat(action), map_structure(flat, env_output),
                AgentState(c=flat(c), h=flat(h)))
            host = to_numpy((out, state))
        valid = k * batch
        out, state = map_structure(
            lambda a: a[:valid].reshape((k, batch) + a.shape[1:]), host)
        return out, state.c, state.h

    @property
    def inference_mode(self) -> str:
        return self._inference_mode

    @property
    def actors(self) -> Sequence[VectorActor]:
        return tuple(self._actors)

    def set_params(self, agent: ImpalaAgent, version: Optional[int] = None):
        """Publish a snapshot of ``agent``'s weights for subsequent
        unrolls."""
        if version is None:
            version = self._params_version + 1
        snapshot = snapshot_params_for_inference(agent, version)
        with self._params_lock:
            self._params = snapshot
            self._params_version = version

    def _get_params(self) -> ParamsSnapshot:
        with self._params_lock:
            return self._params

    def _count(self, name: str, amount: int) -> None:
        with self._counts_lock:
            setattr(self, name, getattr(self, name) + amount)

    def _note_restart(self) -> None:
        self._count("restarts", 1)
        self._restarts_counter.inc()

    def _unroll_loop(self, actor: VectorActor):
        recorder = get_flight_recorder()
        thread_name = threading.current_thread().name
        while not self._stop.is_set():
            # Read each unroll: the driver may install a tracer or a
            # watchdog after this thread started.
            tracer = get_tracer()
            get_watchdog().touch()
            injector = get_fault_injector()
            if injector.active:
                injector.maybe_raise("actor_raise")
                if injector.should_fire("worker_kill"):
                    kill_first_worker(actor.envs)
            with tracer.span("actor/unroll", cat="actor"):
                result = actor.run_unroll(self._get_params())
            # An accum-fused actor's lockstep unroll gives one trajectory
            # per group, all born at its start.
            items = result if isinstance(result, list) else [result]
            recorder.record("unroll", actor.level_name or "actor",
                            {"trajectories": len(items)})
            for trajectory in items:
                if publish_trajectory(
                        self.queue, trajectory, self._stop,
                        actor_name=thread_name,
                        level_name=actor.level_name,
                        birth_us=actor.unroll_birth_us):
                    self._count("agent_steps", self._steps_per_trajectory)
                    self._steps_counter.inc(self._steps_per_trajectory)
                    self._trajectories_counter.inc()

    def _actor_loop(self, actor: VectorActor, stream):
        def deliver(exc):
            deliver_error(self.queue, exc, self._stop)

        context = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
        with context:
            run_with_retry(
                lambda: self._unroll_loop(actor), stop=self._stop,
                deliver=deliver, reset=actor.reset,
                max_restarts=self._max_restarts,
                backoff_s=self._restart_backoff_s,
                on_restart=self._note_restart)

    def start(self) -> "ActorPool":
        if self._params is None:
            raise RuntimeError("set_params before start")
        for i, actor in enumerate(self._actors):
            stream = (torch.cuda.Stream(device=self._device)
                      if self._device.type == "cuda" else None)
            thread = threading.Thread(
                target=self._actor_loop, args=(actor, stream), daemon=True,
                name=f"actor-{i}")
            thread.start()
            self._threads.append(thread)
        return self

    def get_trajectory(self, timeout: Optional[float] = None) -> ActorOutput:
        return consume_trajectory(self.queue, timeout=timeout)

    def stop(self):
        """Stop and join every actor thread, then close every group's
        envs (their worker processes included).  Under ``service`` the
        batcher closes first: every actor thread blocked on a request gets
        ``BatcherClosedError`` (reference: batcher.cc:393-431)."""
        self._stop.set()
        with self._batcher_lock:
            if self._batcher is not None:
                self._batcher.close()
        for thread in self._threads:
            thread.join(timeout=10)
            if thread.is_alive():
                log.error("actor thread %s did not stop within 10 s",
                          thread.name)
        for actor in self._actors:
            actor.close()

    @property
    def threads(self) -> Sequence[threading.Thread]:
        return tuple(self._threads)

    def _all_envs(self) -> List[MultiEnv]:
        """Every group's envs (an accum-fused actor drives several)."""
        envs = []
        for actor in self._actors:
            envs.extend(getattr(actor, "envs_list", None) or [actor.envs])
        return envs

    def episode_stats(self):
        """Merged completed-episode (return, length) ring buffers."""
        return merged_episode_stats(self._all_envs())

    def drain_level_stats(self):
        """Level-attributed episodes finished since the last drain
        (``drain_level_stats``)."""
        return drain_level_stats(self._all_envs())
