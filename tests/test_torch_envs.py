"""The port's env worker processes (envs/worker.py, envs/vector.py) against
the JAX package's.

- ``MultiEnv(num_workers=2)`` and the JAX ``MultiEnv(num_workers=2)``,
  fed the same seeded factories and the same actions, give identical
  StepOutputs over 50 steps; so does the in-process ``num_workers=0``.
- A killed worker is respawned with generation-shifted seeds: its slice
  restarts with done=True from the streams of seed + 90001.
- Importing the worker modules leaves torch out of the process, so a
  spawned worker never loads it.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from scalable_agent_tpu.envs import make_impala_stream as jax_stream
from scalable_agent_tpu.envs.spec import TensorSpec as JaxTensorSpec
from scalable_agent_tpu.envs.vector import MultiEnv as JaxMultiEnv
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.envs.vector import RESEED_STRIDE
from scalable_agent_tpu_torch.envs.worker import EnvProcess, RemoteEnvError

ROOT = Path(__file__).resolve().parents[1]
N = 5
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")


def _fns(make, seed0=0, level="fake_small"):
    return [functools.partial(make, level, seed=seed0 + i,
                              num_action_repeats=2) for i in range(N)]


def _assert_same(got, want):
    np.testing.assert_array_equal(got.reward, want.reward)
    np.testing.assert_array_equal(got.done, want.done)
    np.testing.assert_array_equal(got.info.episode_return,
                                  want.info.episode_return)
    np.testing.assert_array_equal(got.info.episode_step,
                                  want.info.episode_step)
    np.testing.assert_array_equal(got.observation.frame,
                                  want.observation.frame)


@pytest.mark.parametrize("num_workers", [2, 0])
def test_multienv_matches_the_jax_multienv(num_workers):
    ours = MultiEnv(_fns(make_impala_stream), FRAME,
                    num_workers=num_workers)
    ref = JaxMultiEnv(_fns(jax_stream), JaxTensorSpec(
        FRAME.shape, FRAME.dtype, "frame"), num_workers=2)
    try:
        assert ours.num_workers == num_workers
        _assert_same(ours.initial(), ref.initial())
        rng = np.random.default_rng(3)
        for actions in rng.integers(0, 9, (50, N)):
            ours.step_send(actions)
            ref.step_send(actions)
            _assert_same(ours.step_recv(), ref.step_recv())
        assert list(ours.episode_stats) == list(ref.episode_stats)
        assert len(ours.episode_stats) > 0
    finally:
        ours.close()
        ref.close()


def test_killed_worker_respawns_with_shifted_seeds():
    envs = MultiEnv(_fns(make_impala_stream, seed0=10), FRAME,
                    num_workers=2)
    try:
        envs.initial()
        envs.step(np.zeros(N, np.int64))
        dead = envs._procs[1]
        dead.kill()
        dead.join(timeout=10)
        out = envs.step(np.ones(N, np.int64))
        assert envs.total_respawns == 1
        assert envs._procs[1].is_alive() and envs._procs[1] is not dead
        # Worker 1 holds envs 3 and 4: they restart from the initial
        # outputs of the generation-1 streams.
        assert out.done[3:].all() and (out.info.episode_step[3:] == 0).all()
        for i in (3, 4):
            fresh = make_impala_stream(
                "fake_small", seed=10 + i + RESEED_STRIDE,
                num_action_repeats=2).initial()
            np.testing.assert_array_equal(out.observation.frame[i],
                                          fresh.observation.frame)
        # Worker 0 stepped on undisturbed.
        assert (out.info.episode_step[:3] == 2).all()
    finally:
        envs.close()
    assert envs._procs == []


def test_respawn_budget_raises():
    envs = MultiEnv(_fns(make_impala_stream), FRAME, num_workers=1,
                    max_respawns=0)
    try:
        envs.initial()
        envs._procs[0].kill()
        envs._procs[0].join(timeout=10)
        with pytest.raises(RemoteEnvError, match="crash-looping"):
            envs.step(np.zeros(N, np.int64))
    finally:
        envs.close()


def test_env_process_round_trip_and_remote_errors():
    fn = functools.partial(make_impala_stream, "fake_small", seed=4)
    ref = fn()
    with EnvProcess(fn, frame_spec=FRAME) as proc:
        _assert_same(proc.initial(), ref.initial())
        proc.step_send(3)
        _assert_same(proc.step_recv(), ref.step(3))
        with pytest.raises(RemoteEnvError, match="outside"):
            proc.step(99)
    assert not proc.alive


def test_worker_modules_import_no_torch():
    code = ("import sys\n"
            "import scalable_agent_tpu_torch.envs.worker\n"
            "import scalable_agent_tpu_torch.envs.vector\n"
            "import scalable_agent_tpu_torch.envs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)
