"""Process-isolated environment execution.

A copy of ``scalable_agent_tpu/envs/worker.py`` (reference:
py_process.py:62-222): ``EnvProcess`` hosts one stream env
(initial/step/close, auto-reset) in a child process.  Child-side
exceptions come back over the pipe as ``RemoteEnvError`` and are re-raised
in the parent; ``close()`` runs on the child env at shutdown even after
errors; construction errors surface in ``start()``.  Frames travel through
a ``multiprocessing.shared_memory`` block, the pipe carries only the small
fields, and at most one step is outstanding, so the one frame slot stays
coherent.

The pipe protocol constants and ``_dumps_exception`` are shared with the
batched worker of ``envs/vector.py``.  This package stays free of torch:
a spawned worker imports it, and must never touch the card.
"""

import multiprocessing as mp
import pickle
import traceback
from multiprocessing import shared_memory
from typing import Any, Callable, Optional

import numpy as np

_STEP = 0
_INITIAL = 1
_CLOSE = 2
_SPECS = 3


class RemoteEnvError(RuntimeError):
    """An exception raised inside the env worker process."""


def _dumps_exception(exc: BaseException) -> bytes:
    return pickle.dumps(
        RemoteEnvError(
            f"{type(exc).__name__}: {exc}\n"
            f"--- worker traceback ---\n{traceback.format_exc()}"))


def _worker_main(conn, make_stream_pickled: bytes, shm_name: Optional[str],
                 frame_spec=None):
    """Child process server loop.  (reference: py_process.py:142-177)"""
    stream = None
    shm = None
    try:
        try:
            make_stream = pickle.loads(make_stream_pickled)
            stream = make_stream()
            if shm_name is not None:
                shm = shared_memory.SharedMemory(name=shm_name)
            conn.send((True, None))
        except Exception as exc:  # constructor failure -> parent start()
            conn.send((False, _dumps_exception(exc)))
            return

        frame_view = (
            None if shm is None else np.ndarray(
                frame_spec.shape, frame_spec.dtype, buffer=shm.buf))

        def strip_frame(step_output):
            """Move the frame to shared memory (if enabled)."""
            if shm is None:
                return step_output
            frame_view[...] = frame_spec.validate(
                step_output.observation.frame)
            return step_output._replace(
                observation=step_output.observation._replace(frame=None))

        while True:
            request = conn.recv()
            kind = request[0]
            try:
                if kind == _INITIAL:
                    conn.send((True, strip_frame(stream.initial())))
                elif kind == _STEP:
                    conn.send((True, strip_frame(stream.step(request[1]))))
                elif kind == _SPECS:
                    conn.send((True, (stream.observation_spec,
                                      stream.action_space)))
                elif kind == _CLOSE:
                    break
                else:
                    raise ValueError(f"unknown request kind {kind}")
            except Exception as exc:
                conn.send((False, _dumps_exception(exc)))
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        # close() must run even on error paths (reference:
        # py_process.py:155-159).
        if stream is not None:
            try:
                stream.close()
            except Exception:
                pass
        if shm is not None:
            shm.close()
        conn.close()


class EnvProcess:
    """A stream env running in a child process.

    ``make_stream`` must be a picklable zero-arg callable returning an
    object with ``initial()/step(action)/close()`` plus
    ``observation_spec``/``action_space``.  If ``frame_spec`` is given,
    frames move via shared memory; otherwise they are pickled through the
    pipe.
    """

    def __init__(self, make_stream: Callable[[], Any], frame_spec=None):
        self._make_stream = make_stream
        self._frame_spec = frame_spec
        # spawn, not fork: the parent holds a CUDA context and threads.
        self._ctx = mp.get_context("spawn")
        self._process = None
        self._conn = None
        self._shm = None
        self._frame_view = None
        self._pending = False

    def start(self) -> "EnvProcess":
        if self._process is not None:
            raise RuntimeError("already started")
        if self._frame_spec is not None:
            nbytes = int(np.prod(self._frame_spec.shape)
                         * np.dtype(self._frame_spec.dtype).itemsize)
            self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
            self._frame_view = np.ndarray(
                self._frame_spec.shape, self._frame_spec.dtype,
                buffer=self._shm.buf)
        parent_conn, child_conn = self._ctx.Pipe()
        self._process = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, pickle.dumps(self._make_stream),
                  self._shm.name if self._shm else None, self._frame_spec),
            daemon=True,
        )
        self._process.start()
        child_conn.close()
        self._conn = parent_conn
        try:
            ok, payload = self._conn.recv()
        except EOFError:
            # Child died before the handshake: still release pipe,
            # process and shared memory.
            self._teardown()
            raise RemoteEnvError(
                "env worker died during construction (no handshake)")
        if not ok:
            self._teardown()
            raise pickle.loads(payload)
        return self

    def _roundtrip(self, request):
        self._conn.send(request)
        ok, payload = self._conn.recv()
        if not ok:
            raise pickle.loads(payload)
        return payload

    def _restore_frame(self, step_output):
        if self._shm is not None:
            return step_output._replace(
                observation=step_output.observation._replace(
                    frame=self._frame_view.copy()))
        return step_output

    def specs(self):
        return self._roundtrip((_SPECS,))

    def initial(self):
        return self._restore_frame(self._roundtrip((_INITIAL,)))

    def step(self, action):
        return self._restore_frame(self._roundtrip((_STEP, action)))

    def step_send(self, action) -> None:
        """Async half: dispatch a step without waiting for the result.
        At most one step may be outstanding (one frame slot)."""
        if self._pending:
            raise RuntimeError("step_send while a step is outstanding")
        self._pending = True
        self._conn.send((_STEP, action))

    def step_recv(self):
        """Async half: collect a previously dispatched step."""
        if not self._pending:
            raise RuntimeError("step_recv without step_send")
        self._pending = False
        ok, payload = self._conn.recv()
        if not ok:
            raise pickle.loads(payload)
        return self._restore_frame(payload)

    def _teardown(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        if self._process is not None:
            self._process.join(timeout=5)
            if self._process.is_alive():
                self._process.kill()
                self._process.join(timeout=5)
            self._process = None
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None
            self._frame_view = None

    def close(self):
        if self._conn is not None:
            try:
                self._conn.send((_CLOSE,))
            except (BrokenPipeError, OSError):
                pass
        self._teardown()

    @property
    def alive(self) -> bool:
        return self._process is not None and self._process.is_alive()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.close()
