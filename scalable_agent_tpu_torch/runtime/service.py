"""Continuous-batching actor service: no per-step group barrier
(``--actor=service``).

The counterpart of ``scalable_agent_tpu/runtime/service.py``.  The
grouped ``ActorPool`` steps each group in lockstep: ``MultiEnv.step_recv``
waits for the whole group, and one thread alternates env steps and
inference.  Here:

- **Per-worker completion** (``MultiEnv.worker_send``/``worker_recv``):
  one env thread per group streams each worker's observations out the
  moment its reply lands; a slow worker delays only its own slice.
- **A request ring**: each finished slice pushes a ``_Request``
  (generation stamps, group, worker, observations) onto a deque (atomic
  append and pop; a condition only wakes the idle consumer).
- **One inference thread**, on its own CUDA stream with a private copy of
  the agent, takes whatever is pending, no minimum, no timeout, up to
  ``--service_max_batch`` rows, pads it up the power-of-two ladder
  (``runtime/batcher.py``) and runs ONE ``actor_step`` at T=1: one launch
  of the lean LSTM step kernel a batch.  The per-env LSTM state lives on
  the card in a ``[num_envs + 1, core]`` float32 slab (``c`` and ``h``),
  gathered by env id on the way in and scattered back on the way out
  (``service_actor_step``; the extra row takes the padding rows).  Per
  step only observations go up and actions come down.  It loads each
  published ``ParamsSnapshot`` as ``VectorActor`` does
  (``actor.load_snapshot``), and samples from one ``torch.Generator``
  seeded ``--seed``, so its actions are not the JAX service's (as the
  grouped pool's are not the JAX pool's).
- **Per-lane packing** (``TrajectoryPacker``): each lane (a worker's env
  slice) accumulates the reference's T+1 overlap layout on its own; a
  group's [T+1, B] ``ActorOutput`` goes into the pool-compatible queue as
  soon as every lane of the group has an unroll.  The LSTM state rows at
  an unroll boundary leave the inference stream as a host copy and the
  event recorded after it (``_StagedRows``): the env thread that pops the
  trajectory waits for that event before it reads them.

Observability, as in the JAX service: the ledger's ``service_wait``
(Little's-law L of the parked requests) and ``service_batch`` (the
inference thread's utilization) stages through ``note_service``, the
``service/*`` histograms (``ledger.TIMING_STAGE_MAP``), the pool's
``actor_pool/*`` gauges and ``actor/*`` counters, and the watchdog: the
inference thread touches its heartbeat every batch, so a wedged service
dumps forensics (fault point ``service_stall``, ``runtime/faults.py``).
"""

import contextlib
import copy
import logging
import os
import queue as queue_lib
import threading
import time
import weakref
from collections import deque
from multiprocessing import connection as mp_connection
from typing import List, Optional, Sequence

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.vector import MultiEnv
from scalable_agent_tpu_torch.models.agent import ImpalaAgent, actor_step
from scalable_agent_tpu_torch.obs import (
    get_flight_recorder,
    get_ledger,
    get_registry,
    get_tracer,
    get_watchdog,
)
from scalable_agent_tpu_torch.obs.ledger import now_us as ledger_now_us
from scalable_agent_tpu_torch.runtime.actor import (
    _stack_time,
    actor_stage_histograms,
    consume_trajectory,
    deliver_error,
    drain_level_stats,
    kill_first_worker,
    load_snapshot,
    merged_episode_stats,
    pool_instruments,
    publish_trajectory,
    run_with_retry,
    snapshot_params_for_inference,
    to_device,
    to_numpy,
)
from scalable_agent_tpu_torch.runtime.batcher import (
    bucket_ladder,
    pad_to_bucket,
)
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector
from scalable_agent_tpu_torch.types import (
    ActorOutput,
    AgentOutput,
    AgentState,
    map_structure,
)

__all__ = ["ActorService", "TrajectoryPacker", "SERVICE_STALL_S",
           "service_actor_step"]

log = logging.getLogger("scalable_agent_tpu_torch")

# How long the ``service_stall`` fault point wedges the inference thread:
# long enough to trip a test-sized watchdog deadline, short enough that
# the run recovers.  $SCALABLE_AGENT_SERVICE_STALL_S, read when the point
# fires, overrides it.
SERVICE_STALL_S = 2.0


def _stall_seconds() -> float:
    try:
        return float(os.environ.get("SCALABLE_AGENT_SERVICE_STALL_S",
                                    SERVICE_STALL_S))
    except ValueError:
        return SERVICE_STALL_S


@torch.no_grad()
def service_actor_step(agent: ImpalaAgent, generator: torch.Generator,
                       ids: torch.Tensor, n: int, last_actions, env_outputs,
                       slab_c: torch.Tensor, slab_h: torch.Tensor):
    """One continuous batch: gather the LSTM states by env id from the
    slabs, run ``actor_step`` over the padded batch, and write the new
    states of the ``n`` valid rows back in place.  ``ids`` [padded] int64
    on the slabs' device: the batch's env ids, then the dummy row for
    every padding row.  Returns ``(AgentOutput, new state)`` over every
    row, padding included (the JAX ``_service_actor_step``)."""
    state = AgentState(c=slab_c.index_select(0, ids),
                       h=slab_h.index_select(0, ids))
    out, new_state = actor_step(agent, generator, last_actions, env_outputs,
                                state)
    # Only the valid rows go back: their ids are unique, while the padding
    # rows all name the dummy row, and a scatter with repeated indices is
    # nondeterministic on CUDA.  The dummy row is junk in JAX too.
    valid = ids[:n]
    slab_c.index_copy_(0, valid, new_state.c[:n])
    slab_h.index_copy_(0, valid, new_state.h[:n])
    return out, new_state


class _StagedRows:
    """LSTM state rows on their way from the inference stream to the env
    thread that pops their trajectory: a host copy issued on the
    inference stream and the event recorded after it (None on the CPU).
    ``TrajectoryPacker.pop`` reads them through ``np.asarray``, which
    waits for the event first."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        array = self.host.numpy()
        return array if dtype is None else array.astype(dtype, copy=False)


def _host_copy(state: AgentState, n: int):
    """Start copying the first ``n`` rows of ``state`` to the host on the
    current stream: ``(c, h, event)``.  On the card the copies go into
    pinned memory without blocking, and ``event`` is recorded after them;
    on the CPU they are plain copies and ``event`` is None."""
    c, h = state.c[:n], state.h[:n]
    if not c.is_cuda:
        return c.clone(), h.clone(), None
    host_c = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
    host_h = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
    host_c.copy_(c, non_blocking=True)
    host_h.copy_(h, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host_c, host_h, event


class TrajectoryPacker:
    """Per-lane T+1 overlap trajectory assembly for one env group (a copy
    of the JAX packer; numpy only).

    A *lane* is a contiguous slice of the group's batch whose envs always
    step together (the service uses one lane per env worker).  Each lane
    accumulates (env_output, agent_output) entry pairs; crossing T steps
    completes an unroll, which waits until EVERY lane has one; then
    ``pop`` concatenates the lanes into one [T+1, B] batch.

    Layout (bit-identical to ``VectorActor``'s): entry 0 of unroll k+1 is
    entry T of unroll k; ``agent_state`` is the LSTM state after the
    inference that produced entry T's agent half (``stage_state``: the
    caller stages it before dispatching the env step, so the reply can
    never outrun it).

    Threads: per lane, ``stage_inference``/``stage_state`` (the inference
    thread) and ``add_env`` (the lane's env thread) alternate, since at
    most one step is outstanding per lane.
    """

    def __init__(self, lane_widths: Sequence[int], unroll_length: int):
        if unroll_length < 1:
            raise ValueError("unroll_length must be >= 1")
        self._T = int(unroll_length)
        self._widths = [int(w) for w in lane_widths]
        n = len(self._widths)
        self._env_entries: List[list] = [[] for _ in range(n)]
        self._agent_entries: List[list] = [[] for _ in range(n)]
        self._state = [None] * n          # the current unroll's state
        self._staged_agent = [None] * n   # the next entry's agent half
        self._staged_state = [None] * n   # the next unroll's state
        self._unroll_start_us = [0] * n
        self._completed = [deque() for _ in range(n)]

    @property
    def num_lanes(self) -> int:
        return len(self._widths)

    def lane_width(self, lane: int) -> int:
        return self._widths[lane]

    def entry_count(self, lane: int) -> int:
        """Entries in the lane's current (partial) unroll."""
        return len(self._env_entries[lane])

    def completed_depth(self, lane: int) -> int:
        """Finished unrolls the lane holds (its siblings lag)."""
        return len(self._completed[lane])

    def bootstrap(self, lane: int, env_tree, agent_tree, c_rows,
                  h_rows) -> None:
        """Entry 0 of the lane's first unroll: the initial env outputs, a
        zero agent output and the zero LSTM state (reference:
        experiment.py:243-251)."""
        self._env_entries[lane] = [env_tree]
        self._agent_entries[lane] = [agent_tree]
        self._state[lane] = (c_rows, h_rows)
        self._staged_agent[lane] = None
        self._staged_state[lane] = None
        self._unroll_start_us[lane] = ledger_now_us()

    def has_staged(self, lane: int) -> bool:
        """True while the lane has an inference staged and its env step in
        flight: a reply is expected.  A reply with nothing staged means
        the worker died idle and was respawned."""
        return self._staged_agent[lane] is not None

    def stage_inference(self, lane: int, agent_tree) -> bool:
        """Record the agent half of the lane's next entry.  True when that
        entry completes an unroll: the caller must ``stage_state`` before
        dispatching the env step."""
        if self._staged_agent[lane] is not None:
            raise RuntimeError(
                f"lane {lane}: staging a second inference with one "
                f"already outstanding (protocol violation)")
        self._staged_agent[lane] = agent_tree
        return len(self._env_entries[lane]) == self._T

    def stage_state(self, lane: int, c_rows, h_rows) -> None:
        """The post-inference LSTM state rows that become the next
        unroll's ``agent_state`` (anything ``np.asarray`` reads; ``pop``
        materializes them)."""
        self._staged_state[lane] = (c_rows, h_rows)

    def add_env(self, lane: int, env_tree) -> bool:
        """Pair the env reply with the staged agent half into one entry.
        True when the lane completed an unroll."""
        agent_tree = self._staged_agent[lane]
        if agent_tree is None:
            raise RuntimeError(
                f"lane {lane}: env reply with no staged inference "
                f"(protocol violation)")
        self._staged_agent[lane] = None
        self._env_entries[lane].append(env_tree)
        self._agent_entries[lane].append(agent_tree)
        if len(self._env_entries[lane]) <= self._T:
            return False
        staged = self._staged_state[lane]
        if staged is None:
            raise RuntimeError(
                f"lane {lane}: unroll completed without a staged "
                f"boundary state")
        self._completed[lane].append(
            (self._unroll_start_us[lane], self._state[lane],
             self._env_entries[lane], self._agent_entries[lane]))
        # T+1 overlap: the completed unroll's last entry seeds the next.
        self._env_entries[lane] = [env_tree]
        self._agent_entries[lane] = [agent_tree]
        self._state[lane] = staged
        self._staged_state[lane] = None
        self._unroll_start_us[lane] = ledger_now_us()
        return True

    def ready(self) -> bool:
        return all(self._completed)

    def pop(self):
        """One [T+1, B] batch: every lane's oldest completed unroll,
        concatenated in lane (= batch) order.  Returns ``(birth_us,
        agent_state, env_outputs, agent_outputs)``, ``birth_us`` the
        oldest lane's unroll start."""
        births, cs, hs, env_trees, agent_trees = [], [], [], [], []
        for lane in range(self.num_lanes):
            birth, (c, h), env_rows, agent_rows = (
                self._completed[lane].popleft())
            births.append(birth)
            cs.append(np.asarray(c))
            hs.append(np.asarray(h))
            env_trees.append(_stack_time(env_rows))
            agent_trees.append(_stack_time(agent_rows))

        def join(*xs):
            return None if xs[0] is None else np.concatenate(xs, axis=1)

        return (
            min(births),
            AgentState(c=np.concatenate(cs), h=np.concatenate(hs)),
            map_structure(join, *env_trees),
            map_structure(join, *agent_trees),
        )

    def reset(self) -> None:
        """Drop every lane's state (partial entries, staged halves,
        finished unrolls) after a failure: the retry re-bootstraps, as
        ``VectorActor.reset`` does."""
        n = self.num_lanes
        self._env_entries = [[] for _ in range(n)]
        self._agent_entries = [[] for _ in range(n)]
        self._state = [None] * n
        self._staged_agent = [None] * n
        self._staged_state = [None] * n
        self._completed = [deque() for _ in range(n)]


class _Request:
    """One worker slice's pending inference request.  Three staleness
    stamps, checked under the worker lock before dispatch: ``gen`` the
    group generation (a group reset bumps it), ``lane_gen`` the lane's
    (a lane re-bootstrap after an idle worker's death bumps it) and
    ``env_gen`` the worker's respawn generation (a respawn's _INITIAL
    prime already has a reply in flight, so a request from before the
    respawn is dropped, not dispatched on top of it)."""

    __slots__ = ("gen", "lane_gen", "env_gen", "group", "worker",
                 "env_tree", "submitted_us")

    def __init__(self, gen, lane_gen, env_gen, group, worker, env_tree,
                 submitted_us):
        self.gen = gen
        self.lane_gen = lane_gen
        self.env_gen = env_gen
        self.group = group
        self.worker = worker
        self.env_tree = env_tree
        self.submitted_us = submitted_us


class _Group:
    """One group's bookkeeping: envs, packer, global env offset, and the
    generations that invalidate in-flight requests."""

    __slots__ = ("envs", "packer", "offset", "slices", "gen",
                 "lane_gen", "sent_at", "poisoned")

    def __init__(self, envs: MultiEnv, packer: TrajectoryPacker,
                 offset: int):
        self.envs = envs
        self.packer = packer
        self.offset = offset
        self.slices = envs.worker_slices()
        self.gen = 0
        self.lane_gen = [0] * envs.num_workers
        self.sent_at = [0.0] * envs.num_workers
        # An exception the inference thread hit dispatching to this group
        # (a worker's respawn budget raising in worker_send): the group's
        # own env thread raises it into its retry shell, which resets and
        # re-bootstraps the group.
        self.poisoned: Optional[BaseException] = None


class ActorService:
    """The continuous-batching actor service (``--actor=service``).

    The driver's side is ``ActorPool``'s: ``set_params``, ``start``,
    ``get_trajectory``, ``stop``, ``agent_steps``, ``restarts``,
    ``episode_stats`` and ``drain_level_stats``, and the same [T+1, B]
    trajectories.  Inside, there is no group lockstep (module docstring).
    Every group must be a ``MultiEnv`` with worker processes.
    """

    def __init__(self, agent: ImpalaAgent, env_groups: Sequence[MultiEnv],
                 unroll_length: int, level_name: str = "", seed: int = 0,
                 max_batch: int = 0, max_restarts: int = 3,
                 restart_backoff_s: float = 0.5):
        if not env_groups:
            raise ValueError("ActorService needs at least one env group")
        for envs in env_groups:
            if not isinstance(envs, MultiEnv) or envs.num_workers == 0:
                raise ValueError(
                    f"--actor=service steps each env worker process on its "
                    f"own (MultiEnv's per-worker API), which "
                    f"{type(envs).__name__} does not have (a lockstep "
                    f"multi-agent group, or MultiEnv(num_workers=0)); run "
                    f"it with --actor=grouped")
        self._device = next(agent.parameters()).device
        self._agent = copy.deepcopy(agent).requires_grad_(False)
        self.level_name = level_name
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._loaded = None  # the ParamsSnapshot copied into the agent

        offset = 0
        self._groups: List[_Group] = []
        widest = 1
        for envs in env_groups:
            widths = [sl.stop - sl.start for sl in envs.worker_slices()]
            widest = max(widest, *widths)
            self._groups.append(_Group(
                envs, TrajectoryPacker(widths, unroll_length), offset))
            offset += envs.num_envs
        self._num_envs = offset
        # The slab row every padding row gathers from.
        self._dummy_slot = self._num_envs
        if max_batch and max_batch < widest:
            raise ValueError(
                f"service_max_batch {max_batch} is smaller than the "
                f"widest worker slice ({widest} envs): requests are "
                f"slice-granular")
        self._max_batch = int(max_batch) or self._num_envs
        self._buckets = bucket_ladder(self._max_batch)

        # The per-env LSTM state on the card, [N + 1, core] (the extra row
        # takes the padding rows), written in place by every batch.
        self._slab_c = self._slab_h = None
        self._new_slabs()
        # Set while a batch writes the slabs back (service_actor_step's
        # two index copies): a failure there leaves rows whose c and h no
        # longer belong together.
        self._writing_slabs = False
        # The last sampled action per env: the next inference's input.
        self._last_actions = agent.zero_actions(self._num_envs).numpy().copy()

        # The request ring (deque append/popleft are atomic); the
        # condition only wakes the idle inference thread.
        self._ring: deque = deque()
        self._ring_cond = threading.Condition()

        # One trajectory per group, as the pool's queue.
        self.queue = queue_lib.Queue(maxsize=len(env_groups))
        self._params = None
        self._params_version = 0
        self._params_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._max_restarts = max(0, int(max_restarts))
        self._restart_backoff_s = float(restart_backoff_s)
        self._counts_lock = threading.Lock()
        # Agent steps inferred (x action repeats = env frames), counted
        # per valid batch row, and thread respawns.
        self.agent_steps = 0
        self.restarts = 0

        # The pool's gauges and counters, and the service's own
        # instruments (weak references only, as the pool's).
        registry = get_registry()
        (self._steps_counter, self._trajectories_counter,
         self._restarts_counter) = pool_instruments(self, self.queue,
                                                    registry)
        ring_ref = weakref.ref(self._ring)
        registry.gauge(
            "service/pending_requests",
            "worker slices parked in the request ring",
            fn=lambda: (len(r) if (r := ring_ref()) is not None else 0.0))
        self._h_env, self._h_infer = actor_stage_histograms(registry)
        self._h_wait = registry.histogram(
            "service/wait_s",
            "request submission -> batch formation seconds (the "
            "ledger's service_wait stage)")
        self._h_batch = registry.histogram(
            "service/batch_s",
            "batched inference execution seconds per service batch "
            "(the ledger's service_batch stage)")
        self._h_latency = registry.histogram(
            "service/request_latency_s",
            "request submission -> action dispatched seconds")
        self._h_batch_size = registry.histogram(
            "service/batch_size", "valid rows per service batch")
        self._h_occupancy = registry.histogram(
            "service/occupancy",
            "valid rows / service_max_batch per service batch")
        self._batches_counter = registry.counter(
            "service/batches_total", "service batches executed")

    # -- weight publication ------------------------------------------------

    def set_params(self, agent: ImpalaAgent, version: Optional[int] = None):
        """Publish a snapshot of ``agent``'s weights for the next batches
        (``snapshot_params_for_inference``, as ``ActorPool.set_params``)."""
        if version is None:
            version = self._params_version + 1
        snapshot = snapshot_params_for_inference(agent, version)
        with self._params_lock:
            self._params = snapshot
            self._params_version = version

    def _get_params(self):
        with self._params_lock:
            return self._params

    def _count(self, name: str, amount: int) -> None:
        with self._counts_lock:
            setattr(self, name, getattr(self, name) + amount)

    def _note_restart(self) -> None:
        self._count("restarts", 1)
        self._restarts_counter.inc()

    # -- env side ----------------------------------------------------------

    def _submit(self, request: _Request) -> None:
        self._ring.append(request)
        with self._ring_cond:
            self._ring_cond.notify()

    def _bootstrap_lane(self, gi: int, w: int, out) -> None:
        """Entry 0 of ONE lane from its (initial) slice outputs, a zero
        agent output and the zero LSTM state (``VectorActor._bootstrap``'s
        layout), and the lane's first request."""
        group = self._groups[gi]
        sl = group.slices[w]
        k = sl.stop - sl.start
        zero_agent = AgentOutput(
            action=self._agent.zero_actions(k).numpy(),
            policy_logits=np.zeros((k, self._agent.num_logits),
                                   np.float32),
            baseline=np.zeros((k,), np.float32))
        zeros = np.zeros((k, self._agent.core_size), np.float32)
        group.packer.bootstrap(w, out, zero_agent, zeros, zeros.copy())
        self._last_actions[group.offset + sl.start:
                           group.offset + sl.stop] = zero_agent.action
        self._submit(_Request(group.gen, group.lane_gen[w],
                              group.envs.worker_generation(w), gi, w,
                              out, ledger_now_us()))

    def _bootstrap_group(self, gi: int) -> None:
        """(Re)start one group: fresh initial outputs and entry 0 per
        worker slice."""
        group = self._groups[gi]
        group.packer.reset()
        for w in range(group.envs.num_workers):
            self._bootstrap_lane(gi, w, group.envs.worker_initial(w))

    def _reset_group(self, gi: int) -> None:
        """The group's retry reset: invalidate its in-flight requests
        (generation bump), wait out a send that straddles it (a lock
        cycle), drain stale replies and drop partial trajectories.  The
        next pass re-bootstraps."""
        group = self._groups[gi]
        group.gen += 1
        for w in range(group.envs.num_workers):
            # A send under the old generation must finish before the
            # drain, or its reply lands after it and desyncs the pipe.
            with group.envs.worker_lock(w):
                pass
        group.envs.resync()
        group.packer.reset()

    def _group_loop(self, gi: int) -> None:
        """One group's env side: bootstrap, then stream each worker's
        replies into the ring as they land."""
        group = self._groups[gi]
        envs = group.envs
        self._bootstrap_group(gi)
        while not self._stop.is_set():
            # The bounded wait below re-touches, so the heartbeat goes
            # stale only when this thread wedges.
            get_watchdog().touch()
            if group.poisoned is not None:
                # The inference thread failed dispatching to this group:
                # raise it here, where the retry shell resets the group.
                exc, group.poisoned = group.poisoned, None
                raise exc
            injector = get_fault_injector()
            if injector.active:
                injector.maybe_raise("actor_raise")
                if injector.should_fire("worker_kill"):
                    kill_first_worker(envs)
            # Re-read the connections each pass: a respawn replaces them.
            conns = [envs.worker_connection(w)
                     for w in range(envs.num_workers)]
            try:
                ready = mp_connection.wait(conns, timeout=0.1)
            except (OSError, ValueError):
                # A respawn (the inference thread's worker_send found the
                # dead pipe first) closed a connection mid-wait: a routine
                # worker death, not a group failure.
                continue
            for conn in ready:
                if self._stop.is_set():
                    return
                w = conns.index(conn)
                out = envs.worker_recv(w)
                sent_at = group.sent_at[w]
                if sent_at:
                    self._h_env.observe(time.monotonic() - sent_at)
                self._handle_reply(gi, w, out)

    def _handle_reply(self, gi: int, w: int, out) -> None:
        group = self._groups[gi]
        # Under the worker lock, which the inference thread stages and
        # dispatches under, so "nothing staged" is judged on a settled
        # lane.
        with group.envs.worker_lock(w):
            if not group.packer.has_staged(w):
                # A reply with no inference staged: the worker died idle
                # (its request parked in the ring) and worker_recv
                # respawned it; ``out`` is its fresh initial slice.
                # Recover the lane alone: the lane generation bump drops
                # the parked request, and the siblings and the group's
                # restart budget are untouched.
                group.lane_gen[w] += 1
                self._bootstrap_lane(gi, w, out)
                return
            completed = group.packer.add_env(w, out)
            # The reply is entry t of the trajectory and the inference
            # input of entry t+1.
            self._submit(_Request(group.gen, group.lane_gen[w],
                                  group.envs.worker_generation(w),
                                  gi, w, out, ledger_now_us()))
        if completed:
            self._maybe_emit(gi)

    def _maybe_emit(self, gi: int) -> None:
        group = self._groups[gi]
        thread_name = threading.current_thread().name
        while group.packer.ready():
            birth_us, agent_state, env_outputs, agent_outputs = (
                group.packer.pop())
            trajectory = ActorOutput(
                level_name=self.level_name, agent_state=agent_state,
                env_outputs=env_outputs, agent_outputs=agent_outputs)
            get_flight_recorder().record(
                "unroll", self.level_name or "actor",
                {"trajectories": 1, "service": True})
            if publish_trajectory(
                    self.queue, trajectory, self._stop,
                    actor_name=thread_name, level_name=self.level_name,
                    birth_us=birth_us):
                self._trajectories_counter.inc()

    # -- inference side ----------------------------------------------------

    def _take_requests(self) -> Optional[List[_Request]]:
        """Continuous batch formation: wait for one request, then take
        whatever else is pending up to ``max_batch`` rows; no minimum, no
        flush timeout.  None at stop."""
        while not self._stop.is_set():
            try:
                first = self._ring.popleft()
            except IndexError:
                # Idle is not a wedge; the batch below re-arms.
                get_watchdog().suspend()
                with self._ring_cond:
                    self._ring_cond.wait(0.2)
                get_watchdog().touch()
                continue
            requests = [first]
            total = self._request_rows(first)
            while total < self._max_batch:
                try:
                    nxt = self._ring.popleft()
                except IndexError:
                    break
                rows = self._request_rows(nxt)
                if total + rows > self._max_batch:
                    self._ring.appendleft(nxt)
                    break
                requests.append(nxt)
                total += rows
            return requests
        return None

    def _request_rows(self, request: _Request) -> int:
        return self._groups[request.group].packer.lane_width(
            request.worker)

    def _inference_loop(self) -> None:
        """The inference thread: drain, pad, one ``actor_step``, then the
        actions back per worker slice."""
        while not self._stop.is_set():
            requests = self._take_requests()
            if requests is None:
                return
            get_watchdog().touch()
            injector = get_fault_injector()
            if injector.active and injector.should_fire("service_stall"):
                stall = _stall_seconds()
                log.warning("chaos: service inference thread stalling "
                            "%.1fs", stall)
                time.sleep(stall)
            self._run_batch(requests)

    def _new_slabs(self) -> None:
        shape = (self._num_envs + 1, self._agent.core_size)
        self._slab_c = torch.zeros(shape, dtype=torch.float32,
                                   device=self._device)
        self._slab_h = torch.zeros(shape, dtype=torch.float32,
                                   device=self._device)

    def _reset_inference(self) -> None:
        """The inference thread's retry reset.  PyTorch donates nothing, so
        a failed batch leaves the slabs as they were (its requests go back
        to the ring and run again), except when it failed inside the
        write-back, between the c and the h copies: its rows then pair a
        new c with an old h.  Only then are the slabs rebuilt as zeros
        (each env's episode boundary restores its state, as in JAX)."""
        if self._writing_slabs:
            self._new_slabs()
            self._writing_slabs = False

    def _step(self, ids: np.ndarray, n: int, actions, env_batch):
        """Load the newest snapshot and run ``service_actor_step`` on this
        thread's stream."""
        snapshot = self._get_params()
        if snapshot is not self._loaded:
            load_snapshot(self._agent, snapshot)
            self._loaded = snapshot
        device = self._device
        self._writing_slabs = True
        out, new_state = service_actor_step(
            self._agent, self._generator,
            torch.as_tensor(ids, device=device), n,
            torch.as_tensor(actions, device=device),
            to_device(env_batch, device), self._slab_c, self._slab_h)
        self._writing_slabs = False
        return out, new_state

    def _run_batch(self, requests: List[_Request]) -> None:
        start_us = ledger_now_us()
        t0 = time.monotonic()
        # Drop the requests a group reset or lane re-bootstrap invalidated
        # (staging them would pollute the freshly bootstrapped packer).
        # A fast unlocked filter; the dispatch pass checks again under the
        # worker lock.
        live = [r for r in requests
                if (r.gen == self._groups[r.group].gen
                    and r.lane_gen
                    == self._groups[r.group].lane_gen[r.worker]
                    and r.env_gen
                    == self._groups[r.group].envs.worker_generation(
                        r.worker))]
        if not live:
            return
        wait_sum = 0.0
        for request in live:
            wait = max(0.0, (start_us - request.submitted_us) / 1e6)
            wait_sum += wait
            self._h_wait.observe(wait)

        n = sum(self._request_rows(r) for r in live)
        padded = pad_to_bucket(n, self._buckets)
        ids = np.full((padded,), self._dummy_slot, np.int64)
        action_rows = []
        row = 0
        for request in live:
            group = self._groups[request.group]
            sl = group.slices[request.worker]
            lo, hi = group.offset + sl.start, group.offset + sl.stop
            ids[row:row + hi - lo] = np.arange(lo, hi)
            action_rows.append(self._last_actions[lo:hi])
            row += hi - lo

        def join(*leaves):
            if leaves[0] is None:
                return None
            arr = np.concatenate([np.asarray(x) for x in leaves])
            if padded > n:
                arr = np.pad(arr, [(0, padded - n)]
                             + [(0, 0)] * (arr.ndim - 1))
            return arr

        env_batch = map_structure(join, *[r.env_tree for r in live])
        actions = join(*action_rows)
        try:
            with get_tracer().span("service/batch", cat="actor",
                                   args={"n": n, "padded": padded}):
                out, new_state = self._step(ids, n, actions, env_batch)
                out_np = to_numpy(out)
        except BaseException:
            # The batch died before any action went out: its envs have no
            # step in flight, so park its requests for the retried loop
            # (front of the ring, oldest first).  A failure past this point
            # dispatched some slices already; the env threads' retry
            # resets recover those groups.
            for request in reversed(requests):
                self._ring.appendleft(request)
            raise
        exec_s = time.monotonic() - t0
        self._h_batch.observe(exec_s)
        self._h_infer.observe(exec_s)
        self._h_batch_size.observe(n)
        self._h_occupancy.observe(n / self._max_batch)
        self._batches_counter.inc()
        self._steps_counter.inc(n)
        self._count("agent_steps", n)
        ledger = get_ledger()
        ledger.note_service("service_batch", n, exec_s)
        ledger.note_service("service_wait", n, wait_sum)

        # Stage each slice's agent half (and, at an unroll boundary, its
        # post-inference state rows), THEN dispatch its env step, all
        # under the worker lock and generation-checked: a reply can never
        # outrun its staged state, and a group reset can never interleave
        # a stale send.
        done_us = ledger_now_us()
        staged_rows = None
        row = 0
        for request in live:
            group = self._groups[request.group]
            sl = group.slices[request.worker]
            k = sl.stop - sl.start
            rows = slice(row, row + k)
            row += k
            agent_tree = AgentOutput(
                action=out_np.action[rows],
                policy_logits=out_np.policy_logits[rows],
                baseline=out_np.baseline[rows])
            try:
                with group.envs.worker_lock(request.worker):
                    if (group.gen != request.gen
                            or group.lane_gen[request.worker]
                            != request.lane_gen
                            or group.envs.worker_generation(
                                request.worker) != request.env_gen):
                        # Stale: a group reset, a lane re-bootstrap, or a
                        # respawn whose _INITIAL prime already has a reply
                        # in flight.  Dispatching would double-book the
                        # request/reply protocol.
                        continue
                    if group.packer.stage_inference(request.worker,
                                                    agent_tree):
                        if staged_rows is None:
                            # One host copy of the batch's state rows, on
                            # this thread's stream, read after its event.
                            staged_rows = _host_copy(new_state, n)
                        host_c, host_h, event = staged_rows
                        group.packer.stage_state(
                            request.worker,
                            _StagedRows(host_c[rows], event),
                            _StagedRows(host_h[rows], event))
                    lo = group.offset + sl.start
                    self._last_actions[lo:lo + k] = agent_tree.action
                    group.sent_at[request.worker] = time.monotonic()
                    group.envs.worker_send(request.worker,
                                           agent_tree.action)
            except Exception as exc:
                # One slice's dispatch failure (its worker's respawn budget
                # raising in worker_send) must not starve the other lanes
                # of the batch: poison its group, whose retry shell owns
                # the reset and the budget, and dispatch the rest.
                get_flight_recorder().record(
                    "exception", type(exc).__name__,
                    {"where": f"service-dispatch:g{request.group}"
                              f"w{request.worker}"})
                group.poisoned = exc
                continue
            self._h_latency.observe(
                max(0.0, (done_us - request.submitted_us) / 1e6))

    # -- run ---------------------------------------------------------------

    def start(self) -> "ActorService":
        if self._params is None:
            raise RuntimeError("set_params before start")

        def deliver(exc):
            deliver_error(self.queue, exc, self._stop)

        for gi in range(len(self._groups)):
            thread = threading.Thread(
                target=run_with_retry, daemon=True,
                name=f"service-env-{gi}",
                args=(lambda gi=gi: self._group_loop(gi),),
                kwargs=dict(stop=self._stop, deliver=deliver,
                            reset=lambda gi=gi: self._reset_group(gi),
                            max_restarts=self._max_restarts,
                            backoff_s=self._restart_backoff_s,
                            on_restart=self._note_restart))
            thread.start()
            self._threads.append(thread)
        thread = threading.Thread(target=self._inference_main, daemon=True,
                                  args=(deliver,), name="service-inference")
        thread.start()
        self._threads.append(thread)
        return self

    def _inference_main(self, deliver) -> None:
        stream = (torch.cuda.Stream(device=self._device)
                  if self._device.type == "cuda" else None)
        context = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
        with context:
            run_with_retry(
                self._inference_loop, stop=self._stop, deliver=deliver,
                reset=self._reset_inference,
                max_restarts=self._max_restarts,
                backoff_s=self._restart_backoff_s,
                on_restart=self._note_restart)

    def get_trajectory(self, timeout: Optional[float] = None
                       ) -> ActorOutput:
        return consume_trajectory(self.queue, timeout=timeout)

    def stop(self) -> None:
        """Stop and join every thread, then close every group's envs."""
        self._stop.set()
        with self._ring_cond:
            self._ring_cond.notify_all()
        for thread in self._threads:
            thread.join(timeout=10)
            if thread.is_alive():
                log.error("service thread %s did not stop within 10 s",
                          thread.name)
        for group in self._groups:
            group.envs.close()

    # -- stats (the ActorPool surface the driver reads) --------------------

    @property
    def threads(self) -> Sequence[threading.Thread]:
        return tuple(self._threads)

    def episode_stats(self):
        """Merged completed-episode (return, length) ring buffers."""
        return merged_episode_stats(g.envs for g in self._groups)

    def drain_level_stats(self):
        """Level-attributed episodes finished since the last drain."""
        return drain_level_stats(g.envs for g in self._groups)
