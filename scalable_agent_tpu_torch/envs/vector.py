"""Vectorized environments: N streams sharded over W worker processes.

The counterpart of ``scalable_agent_tpu/envs/vector.py::MultiEnv``
(reference: algorithms/utils/multi_env.py:42-225):

- Each worker process hosts about ``N / W`` ImpalaStream envs (an even
  split) and steps them one after the other; the parent scatters actions
  and gathers batched ``StepOutput``s.
- All frames land in ONE shared-memory slab laid out [N, H, W, C]; only
  the small fields cross the pipes, the instructions and measurements
  among them (int32 [k, L] and float32 [k, M] per worker when the envs'
  observations carry them).
- ``step_send``/``step_recv`` let an actor thread wait on the pipes while
  other threads run inference.
- The per-worker API (``worker_slices``, ``worker_connection``,
  ``worker_lock``, ``worker_generation``, ``worker_send``,
  ``worker_recv``, ``worker_initial``) steps one worker's slice alone, for
  the continuous-batching actor service (``runtime/service.py``): one
  thread may send while another drains replies, and each worker's send
  ``RLock`` is held around every send and every respawn handshake, so a
  respawn never interleaves with a concurrent send.
- A worker that dies is respawned with generation-shifted seeds
  (``_reseeded``); its slice restarts from fresh episodes (done=True).
  More than ``max_respawns`` deaths of one worker within
  ``RESPAWN_WINDOW_S`` raise ``RemoteEnvError``; each respawn counts in
  ``env/worker_respawns_total`` and the flight recorder.
- Episode stats of the last ``STATS_EPISODES`` finished episodes go to a
  ring buffer (``episode_stats``).  With ``env_labels`` (one level name
  per env slot: multi-task training) every finished episode is also
  queued as ``(label, return, length)`` in ``level_episode_stats``, which
  its consumer drains (``runtime/actor.drain_level_stats``); the label is
  the slot's, whichever worker process hosts it.

Workers start with ``spawn``: the parent holds a CUDA context and threads.
The constructor's default ``num_workers=0`` steps the streams in the
calling process instead (the JAX MultiEnv reads 0 as one worker per env;
the driver's flags keep that meaning, ``driver.worker_processes``).  The
observation's frame, instruction and measurements are carried
(``FakeEnv`` has an instruction stream with ``with_instruction``, the Doom
levels with ``DoomAdditionalInput`` a measurement vector, which the agent
does not read).  This module imports no torch (the obs package,
which does, only when a worker is respawned, in the parent).
"""

import functools
import logging
import multiprocessing as mp
import pickle
import threading
import time
from collections import deque
from multiprocessing import shared_memory
from typing import Callable, List, Optional, Sequence

import numpy as np

from scalable_agent_tpu_torch.envs.worker import (
    _CLOSE,
    _INITIAL,
    _STEP,
    RemoteEnvError,
    _dumps_exception,
)
from scalable_agent_tpu_torch.types import (
    Observation,
    StepOutput,
    StepOutputInfo,
)

log = logging.getLogger("scalable_agent_tpu_torch")

# A respawned worker's streams take seed + this * generation, so they do
# not replay the episodes the dead worker already played.
RESEED_STRIDE = 90001
# Worker deaths older than this no longer count against max_respawns.
RESPAWN_WINDOW_S = 600.0
# Finished episodes kept in MultiEnv.episode_stats.
STATS_EPISODES = 100
# Level-attributed episodes held until drained.
LEVEL_STATS_EPISODES = 1000


def _reseeded(make_stream_fns, generation: int):
    """Shift the seed of ``functools.partial(..., seed=...)`` factories by
    generation; opaque factories pass through unchanged."""
    if generation <= 0:
        return list(make_stream_fns)
    out = []
    for make in make_stream_fns:
        if (isinstance(make, functools.partial)
                and "seed" in (make.keywords or {})):
            kwargs = dict(make.keywords)
            kwargs["seed"] = kwargs["seed"] + RESEED_STRIDE * generation
            make = functools.partial(make.func, *make.args, **kwargs)
        out.append(make)
    return out


def _maybe_stack(items):
    if not items or items[0] is None:
        return None
    return np.stack(items)


def _run_all(streams, slab, first_index: int, step_of_stream):
    """Apply ``step_of_stream(i, stream)`` to each stream; frames go to
    ``slab[first_index + i]``, the small fields (the instructions [k, L]
    and the measurements [k, M], each or None, among them) come back as
    arrays."""
    k = len(streams)
    rewards = np.zeros((k,), np.float32)
    dones = np.zeros((k,), bool)
    returns = np.zeros((k,), np.float32)
    steps = np.zeros((k,), np.int32)
    instructions = []
    measurements = []
    for i, stream in enumerate(streams):
        out = step_of_stream(i, stream)
        rewards[i] = out.reward
        dones[i] = out.done
        returns[i] = out.info.episode_return
        steps[i] = out.info.episode_step
        slab[first_index + i] = out.observation.frame
        instructions.append(out.observation.instruction)
        measurements.append(out.observation.measurements)
    return (rewards, dones, returns, steps, _maybe_stack(instructions),
            _maybe_stack(measurements))


def _vec_worker_main(conn, make_streams_pickled: bytes, shm_name: str,
                     slab_shape, slab_dtype, first_index: int,
                     generation: int = 0):
    """Hosts a contiguous slice of the env batch.  One process, k envs."""
    streams = []
    shm = None
    try:
        try:
            make_streams = _reseeded(
                pickle.loads(make_streams_pickled), generation)
            streams = [make() for make in make_streams]
            shm = shared_memory.SharedMemory(name=shm_name)
            slab = np.ndarray(slab_shape, slab_dtype, buffer=shm.buf)
            conn.send((True, None))
        except Exception as exc:
            conn.send((False, _dumps_exception(exc)))
            return
        # A freshly (re)spawned worker has not started its episodes: its
        # first _STEP returns initial outputs (done=True, episode_step=0,
        # the visible episode boundary), so the parent never has to reset
        # a respawned worker eagerly.
        initialized = False
        while True:
            request = conn.recv()
            kind = request[0]
            try:
                if kind == _INITIAL or (kind == _STEP and not initialized):
                    payload = _run_all(streams, slab, first_index,
                                       lambda i, stream: stream.initial())
                    initialized = True
                    conn.send((True, payload))
                elif kind == _STEP:
                    actions = request[1]
                    conn.send((True, _run_all(
                        streams, slab, first_index,
                        lambda i, stream: stream.step(actions[i]))))
                elif kind == _CLOSE:
                    break
                else:
                    raise ValueError(f"unknown request kind {kind}")
            except Exception as exc:
                conn.send((False, _dumps_exception(exc)))
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        for stream in streams:
            try:
                stream.close()
            except Exception:
                pass
        if shm is not None:
            shm.close()
        conn.close()


class MultiEnv:
    """N ImpalaStream envs across W processes with a shared frame slab.

    ``make_stream_fns``: one picklable zero-arg factory per env.
    ``frame_spec`` declares the per-env frame shape and dtype.
    """

    def __init__(self, make_stream_fns: Sequence[Callable], frame_spec,
                 num_workers: int = 0, max_respawns: int = 16,
                 env_labels: Optional[Sequence[str]] = None):
        self.num_envs = len(make_stream_fns)
        if env_labels is not None and len(env_labels) != self.num_envs:
            raise ValueError(
                f"{len(env_labels)} env_labels for {self.num_envs} envs")
        self.env_labels = list(env_labels) if env_labels else None
        # (label, episode_return, episode_length), fed only with
        # env_labels; drained by the consumer, so every finished episode
        # is attributed once.
        self.level_episode_stats = deque(maxlen=LEVEL_STATS_EPISODES)
        self._frame_spec = frame_spec
        self._slab_shape = (self.num_envs,) + tuple(frame_spec.shape)
        self.max_respawns = max_respawns
        self.total_respawns = 0  # lifetime stat, never limits recovery
        # (episode_return, episode_length) of finished episodes.
        self.episode_stats = deque(maxlen=STATS_EPISODES)
        self._pending = None
        self._streams = []
        self._shm = None
        self._slices, self._fns_pickled, self._generations = [], [], []
        self._respawn_times, self._procs, self._conns = [], [], []
        self._send_locks = []
        num_workers = min(num_workers, self.num_envs)
        if num_workers <= 0:
            self._slab = np.zeros(self._slab_shape, frame_spec.dtype)
            self._streams = [fn() for fn in make_stream_fns]
            return
        self._ctx = mp.get_context("spawn")
        nbytes = int(np.prod(self._slab_shape)
                     * np.dtype(frame_spec.dtype).itemsize)
        self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._slab = np.ndarray(self._slab_shape, frame_spec.dtype,
                                buffer=self._shm.buf)
        base, extra = divmod(self.num_envs, num_workers)
        start = 0
        for w in range(num_workers):
            size = base + (1 if w < extra else 0)
            sl = slice(start, start + size)
            self._slices.append(sl)
            self._fns_pickled.append(pickle.dumps(list(make_stream_fns[sl])))
            self._generations.append(0)
            self._respawn_times.append(deque())
            self._procs.append(None)
            self._conns.append(None)
            # An RLock, so a caller can hold it around its own
            # check-then-send (the actor service's generation gate).
            self._send_locks.append(threading.RLock())
            self._spawn_worker(w)
            start += size
        failures = []
        for conn in self._conns:
            try:
                ok, payload = conn.recv()
            except EOFError:
                failures.append(RemoteEnvError(
                    "env worker died during construction (no handshake)"))
                continue
            if not ok:
                failures.append(pickle.loads(payload))
        if failures:
            self.close()
            raise failures[0]

    @property
    def num_workers(self) -> int:
        return len(self._slices)

    def frame_slab(self) -> np.ndarray:
        """The shared [N, H, W, C] frame slab itself, no copy (valid until
        the next step)."""
        return self._slab

    # -- workers -------------------------------------------------------------

    def _spawn_worker(self, w: int) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_vec_worker_main,
            args=(child_conn, self._fns_pickled[w], self._shm.name,
                  self._slab_shape, np.dtype(self._frame_spec.dtype),
                  self._slices[w].start, self._generations[w]),
            daemon=True)
        proc.start()
        child_conn.close()
        self._procs[w] = proc
        self._conns[w] = parent_conn

    def _respawn_worker(self, w: int) -> None:
        """Replace a dead worker: fresh process, shifted seeds, blocking
        handshake.  Raises RemoteEnvError when worker ``w`` died more
        than ``max_respawns`` times within ``RESPAWN_WINDOW_S``."""
        now = time.monotonic()
        times = self._respawn_times[w]
        while times and now - times[0] > RESPAWN_WINDOW_S:
            times.popleft()
        times.append(now)
        self.total_respawns += 1
        if len(times) > self.max_respawns:
            raise RemoteEnvError(
                f"env worker {w} crash-looping: {len(times)} deaths in "
                f"{RESPAWN_WINDOW_S:.0f}s (budget {self.max_respawns})")
        log.warning("env worker %d (envs %d:%d) died; respawning (%d in "
                    "window, %d lifetime)", w, self._slices[w].start,
                    self._slices[w].stop, len(times), self.total_respawns)
        # Imported here: the obs package imports torch, and the env
        # worker processes import this package without it.
        from scalable_agent_tpu_torch.obs import (
            get_flight_recorder,
            get_registry,
        )

        get_registry().counter(
            "env/worker_respawns_total",
            "env worker processes respawned after dying").inc()
        get_flight_recorder().record(
            "worker_respawn", f"worker-{w}",
            {"deaths_in_window": len(times),
             "lifetime": self.total_respawns})
        try:
            self._conns[w].close()
        except OSError:
            pass
        proc = self._procs[w]
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=5)
        self._generations[w] += 1
        self._spawn_worker(w)
        try:
            ok, payload = self._conns[w].recv()
        except EOFError:
            raise RemoteEnvError(
                f"env worker {w} died again during respawn handshake")
        if not ok:
            raise pickle.loads(payload)

    def _send(self, w: int, request) -> None:
        """Send to worker ``w`` under its send lock; a dead worker is
        respawned and primed with its initial outputs instead (same reply
        layout)."""
        with self._send_locks[w]:
            try:
                self._conns[w].send(request)
            except (BrokenPipeError, OSError):
                self._respawn_worker(w)
                self._conns[w].send((_INITIAL,))

    def _recv(self, w: int):
        """One worker's reply as ``(payload, None)`` or ``(None, error)``.
        A worker dead mid-step is respawned and its slice's fresh initial
        outputs are substituted."""
        conn = self._conns[w]
        try:
            ok, payload = conn.recv()
        except (EOFError, OSError):
            with self._send_locks[w]:
                if self._conns[w] is conn:
                    self._respawn_worker(w)
                    self._conns[w].send((_INITIAL,))
                # Else a concurrent sender found the death first and
                # respawned and primed the worker under this lock: a
                # second respawn would kill the healthy replacement and
                # charge the budget twice for one death.  Either way the
                # primed initial reply is pending.
            ok, payload = self._conns[w].recv()
        if not ok:
            return None, pickle.loads(payload)
        return payload, None

    # -- protocol ------------------------------------------------------------

    def _record_done_stats(self, offset: int, dones, steps, returns):
        """Finished episodes of a slice whose global env indices start at
        ``offset`` (initial() marks done without an episode: skipped)."""
        for i in np.nonzero(dones)[0]:
            if steps[i] > 0:
                self.episode_stats.append((float(returns[i]), int(steps[i])))
                if self.env_labels is not None:
                    self.level_episode_stats.append(
                        (self.env_labels[offset + i], float(returns[i]),
                         int(steps[i])))

    def _output(self, rewards, dones, returns, steps, instructions,
                measurements) -> StepOutput:
        self._record_done_stats(0, dones, steps, returns)
        return StepOutput(
            reward=rewards,
            info=StepOutputInfo(episode_return=returns, episode_step=steps),
            done=dones,
            observation=Observation(frame=self._slab.copy(),
                                    instruction=instructions,
                                    measurements=measurements))

    def _gather(self) -> StepOutput:
        fields = [np.zeros((self.num_envs,), np.float32),
                  np.zeros((self.num_envs,), bool),
                  np.zeros((self.num_envs,), np.float32),
                  np.zeros((self.num_envs,), np.int32), None, None]
        errors = []
        for w, sl in enumerate(self._slices):
            payload, error = self._recv(w)
            if error is not None:
                # Keep draining the other workers so the pipes stay
                # aligned; the first error surfaces after the sweep.
                errors.append(error)
                continue
            for i, part in enumerate(payload):
                if i < 4:
                    fields[i][sl] = part
                elif part is not None:
                    # the instructions [k, L], the measurements [k, M]
                    if fields[i] is None:
                        fields[i] = np.zeros(
                            (self.num_envs,) + part.shape[1:], part.dtype)
                    fields[i][sl] = part
        if errors:
            raise errors[0]
        return self._output(*fields)

    def initial(self) -> StepOutput:
        if self._streams:
            return self._output(*_run_all(
                self._streams, self._slab, 0,
                lambda i, stream: stream.initial()))
        for w in range(self.num_workers):
            self._send(w, (_INITIAL,))
        return self._gather()

    def step_send(self, actions) -> None:
        actions = np.asarray(actions)
        if actions.shape[0] != self.num_envs:
            raise ValueError(
                f"got {actions.shape[0]} actions for {self.num_envs} envs")
        for w, sl in enumerate(self._slices):
            self._send(w, (_STEP, actions[sl]))
        self._pending = actions

    def step_recv(self) -> StepOutput:
        if self._pending is None:
            raise RuntimeError("step_recv without step_send")
        actions, self._pending = self._pending, None
        if self._streams:
            return self._output(*_run_all(
                self._streams, self._slab, 0,
                lambda i, stream: stream.step(actions[i])))
        return self._gather()

    def step(self, actions) -> StepOutput:
        self.step_send(actions)
        return self.step_recv()

    # -- the per-worker protocol ---------------------------------------------
    # The actor service (runtime/service.py) steps each worker's slice on
    # its own: a worker's observations flow out the moment its reply
    # lands, without the group barrier of ``step_recv``.  One thread may
    # send (worker_send) while another drains replies (worker_recv):
    # opposite directions of the duplex pipe, serialised per worker by the
    # send lock where a respawn handshake needs it.  Worker processes
    # only: ``MultiEnv(num_workers=0)`` has no workers.

    def worker_slices(self) -> List[slice]:
        """Per-worker env index ranges, in batch order."""
        return list(self._slices)

    def worker_connection(self, w: int):
        """The worker's parent-side pipe end, for
        ``multiprocessing.connection.wait``."""
        return self._conns[w]

    def worker_lock(self, w: int):
        """The worker's send RLock: a caller wraps its check-then-send
        (the service's stale-generation gate) around ``worker_send``."""
        return self._send_locks[w]

    def worker_generation(self, w: int) -> int:
        """The worker's respawn generation (bumped by every respawn, under
        the send lock on concurrent paths).  The service stamps requests
        with it, so that a step computed for a worker before its respawn
        is dropped: the respawn's _INITIAL prime already has a reply in
        flight."""
        return self._generations[w]

    def _slice_output(self, w: int, payload) -> StepOutput:
        sl = self._slices[w]
        rewards, dones, returns, steps, instructions, measurements = payload
        self._record_done_stats(sl.start, dones, steps, returns)
        return StepOutput(
            reward=rewards,
            info=StepOutputInfo(episode_return=returns, episode_step=steps),
            done=dones,
            observation=Observation(frame=self._slab[sl].copy(),
                                    instruction=instructions,
                                    measurements=measurements))

    def worker_send(self, w: int, actions) -> None:
        """Dispatch one step to worker ``w``'s slice ([k] actions, or
        [k, K] for a composite policy).  A dead worker is respawned and
        primed with its initial outputs instead (same reply layout)."""
        actions = np.asarray(actions)
        sl = self._slices[w]
        if actions.shape[0] != sl.stop - sl.start:
            raise ValueError(
                f"got {actions.shape[0]} actions for worker {w}'s "
                f"{sl.stop - sl.start} envs")
        self._send(w, (_STEP, actions))

    def worker_recv(self, w: int) -> StepOutput:
        """Worker ``w``'s outstanding reply as a [k, ...] StepOutput (the
        frames copied from its slab slice; episode stats recorded under
        the global env indices)."""
        payload, error = self._recv(w)
        if error is not None:
            raise error
        return self._slice_output(w, payload)

    def worker_initial(self, w: int) -> StepOutput:
        """(Re)start worker ``w``'s episodes and return its slice's
        initial outputs."""
        self._send(w, (_INITIAL,))
        return self.worker_recv(w)

    def resync(self) -> None:
        """Best-effort pipe re-alignment after an exception of unknown
        provenance (the actor retry path): drain stale worker replies,
        each pipe until it stays quiet for a second, so the next
        ``initial()``/``step_send`` does not read one as its own."""
        self._pending = None
        for conn in self._conns:
            if conn is None:
                continue
            try:
                while conn.poll(1.0):
                    conn.recv()
            except (EOFError, OSError):
                continue

    def close(self):
        for stream in self._streams:
            stream.close()
        self._streams = []
        for conn in self._conns:
            if conn is None:
                continue
            try:
                conn.send((_CLOSE,))
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        for conn in self._conns:
            if conn is not None:
                conn.close()
        self._conns, self._procs = [], []
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None
