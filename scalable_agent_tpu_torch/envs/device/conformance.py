"""Conformance harness: the DeviceEnv protocol, checked mechanically.

The counterpart of ``scalable_agent_tpu/envs/device/conformance.py``.
Every level in ``DEVICE_LEVELS`` passes every check
(``tests/test_torch_device_conformance.py`` runs the whole matrix on the
CPU, ``chip_smoke.py`` on the card).  The checks are plain functions over
an ``env_factory`` (a callable returning a new env instance) and a device:

    from scalable_agent_tpu_torch.envs.device import conformance
    conformance.run_conformance(lambda: MyWorld(), device="cuda")

What they pin (the protocol, ``envs/device/protocol.py``), in torch terms:

- ``spec``: ``initial``/``step`` outputs match the declared shapes and
  dtypes for any seeds.
- ``determinism``: the trajectory is a bit-exact function of (seeds,
  actions): a per-step loop, a whole-rollout function and a new instance
  give the same outputs.
- ``autoreset``: emitted against carried accounting: the emitted info
  includes the final step (``episode_step >= 1`` after ``initial``, the
  return sums the whole episode), the carried accounting restarts after
  done, and ``done & episode_step > 0`` counts finished episodes.
- ``zero_host_sync``: a rollout reads nothing back to the host: on a card
  under ``torch.cuda.set_sync_debug_mode("error")``, on the CPU under a
  spy on ``Tensor.item``, ``tolist``, ``__array__``, ``__bool__`` and
  ``numpy``.
- ``donation``: no two tensors of the ``(state, output)`` carry share
  storage, after ``initial`` and after two steps, so a caller may update
  any of them in place (the JAX check donates the carry; torch has no
  donation, and this is the property donation needs).
"""

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "CHECKS",
    "check_autoreset",
    "check_determinism",
    "check_donation",
    "check_spec",
    "check_zero_host_sync",
    "conformance_seeds",
    "host_read_spy",
    "leaves",
    "rollout",
    "run_conformance",
]


def conformance_seeds(env, batch: int, salt: int = 0) -> np.ndarray:
    """A spread of valid seeds including the env's ``max_seed`` bound (the
    jittered ``DeviceFakeEnv``'s bound edge must stay exact, not only small
    seeds); ``salt`` selects a different multiset, so the spec check's two
    legs see distinct seed values."""
    max_seed = int(getattr(env, "max_seed", 2**31 - 1))
    seeds = (np.arange(batch, dtype=np.int64) * (91757 + 2 * salt)
             + 7 + 104729 * salt) % (max_seed + 1)
    seeds[-1] = max_seed
    return seeds.astype(np.int32)


def _actions(env, batch: int, steps: int, device, seed: int = 0
             ) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, env.num_actions,
                                        size=(steps, batch)),
                           dtype=torch.int64, device=device)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested tuple, depth first (None leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in leaves(part)]
    return []


def rollout(env, state, actions):
    """The whole-rollout function: ``(state, actions [T, B]) ->
    (final_state, outputs stacked [T, B, ...])``."""
    outs = []
    for action in actions:
        state, out = env.step(state, action)
        outs.append(out)
    return state, _stack(outs)


def _stack(outs):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if first is None:
        return None
    return type(first)(*(_stack(list(parts)) for parts in zip(*outs)))


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if tree is None:
        return None
    return type(tree)(*(_to_host(part) for part in tree))


# -- checks ------------------------------------------------------------------


def check_spec(env_factory: Callable[[], object], device="cpu",
               batch: int = 5, steps: int = 3) -> None:
    """Shapes and dtypes match ``spec`` and do not depend on the seeds."""
    from scalable_agent_tpu_torch.envs.device.world import torch_dtype

    env = env_factory()
    spec = env.spec
    assert spec.action_space.n == spec.num_actions, (
        "spec.action_space must agree with spec.num_actions")
    frame_spec = spec.observation_spec.frame
    frame_dtype = torch_dtype(frame_spec.dtype)

    def assert_output(out, where):
        frame = out.observation.frame
        assert tuple(frame.shape) == (batch,) + tuple(frame_spec.shape), (
            f"{where}: frame {tuple(frame.shape)} != spec "
            f"[B]+{tuple(frame_spec.shape)}")
        assert frame.dtype == frame_dtype, (
            f"{where}: frame dtype {frame.dtype} != {frame_dtype}")
        assert out.reward.shape == (batch,), where
        assert out.reward.dtype == torch.float32, where
        assert out.done.shape == (batch,), where
        assert out.done.dtype == torch.bool, where
        assert out.info.episode_return.dtype == torch.float32, where
        assert out.info.episode_step.dtype == torch.int32, where
        assert frame.device.type == torch.device(device).type, where

    for tag, salt in (("seeds_a", 0), ("seeds_b", 1)):
        seeds = conformance_seeds(env, batch, salt=salt)
        state, out = env.initial(seeds, device=device)
        assert_output(out, f"{tag} initial")
        assert bool(out.done.all()), (
            f"{tag}: initial must emit done=True (start-of-episode)")
        assert not bool(out.info.episode_step.any()), (
            f"{tag}: initial must emit episode_step 0")
        assert not bool(out.reward.any()), (
            f"{tag}: initial must emit reward 0")
        actions = _actions(env, batch, steps, device)
        for t in range(steps):
            state, out = env.step(state, actions[t])
            assert_output(out, f"{tag} step {t}")


def check_determinism(env_factory: Callable[[], object], device="cpu",
                      batch: int = 4, steps: int = 33) -> None:
    """Bit-exact across a per-step loop, the whole-rollout function and a
    new env instance."""
    env = env_factory()
    seeds = conformance_seeds(env, batch)
    actions = _actions(env, batch, steps, device)

    # Path A: a per-step loop, each output fetched as it comes.
    state, _ = env.initial(seeds, device=device)
    loop_outs = []
    for t in range(steps):
        state, out = env.step(state, actions[t])
        loop_outs.append(_to_host(out))
    # Path B: the whole-rollout function.
    state_b, _ = env.initial(seeds, device=device)
    _, outs_b = rollout(env, state_b, actions)
    outs_b = _to_host(outs_b)
    # Path C: a new instance.
    env_c = env_factory()
    state_c, _ = env_c.initial(seeds, device=device)
    _, outs_c = rollout(env_c, state_c, actions)
    outs_c = _to_host(outs_c)

    for t in range(steps):
        for name, a, b, c in (
                ("frame", loop_outs[t].observation.frame,
                 outs_b.observation.frame[t], outs_c.observation.frame[t]),
                ("reward", loop_outs[t].reward, outs_b.reward[t],
                 outs_c.reward[t]),
                ("done", loop_outs[t].done, outs_b.done[t], outs_c.done[t]),
                ("episode_return", loop_outs[t].info.episode_return,
                 outs_b.info.episode_return[t],
                 outs_c.info.episode_return[t]),
                ("episode_step", loop_outs[t].info.episode_step,
                 outs_b.info.episode_step[t],
                 outs_c.info.episode_step[t])):
            np.testing.assert_array_equal(
                a, b, err_msg=f"step loop vs rollout: {name} diverges at "
                              f"t={t}")
            np.testing.assert_array_equal(
                b, c, err_msg=f"rollout vs new-instance rollout: {name} "
                              f"diverges at t={t}")


def check_autoreset(env_factory: Callable[[], object], device="cpu",
                    batch: int = 4, steps: Optional[int] = None) -> None:
    """Emitted against carried accounting and the reset's invariants.  The
    window sizes itself to the level's horizon, so every level crosses at
    least one episode boundary."""
    env = env_factory()
    if steps is None:
        horizon = (int(getattr(env, "episode_length", 32))
                   + int(getattr(env, "length_jitter", 0)))
        repeats = int(getattr(env, "num_action_repeats", 1))
        steps = max(16, -(-horizon // repeats) + 4)
    seeds = conformance_seeds(env, batch)
    actions = _actions(env, batch, steps, device, seed=1)
    state, _ = env.initial(seeds, device=device)
    _, outs = rollout(env, state, actions)
    outs = _to_host(outs)
    reward, done = outs.reward, outs.done
    ep_return = outs.info.episode_return
    ep_step = outs.info.episode_step

    assert (ep_step >= 1).all(), (
        "emitted episode_step must include the step just taken (>= 1 "
        "after initial): `done & episode_step > 0` is the finished-"
        "episode detector and a 0 here breaks episode accounting")
    finished = 0
    for b in range(batch):
        expect_return, expect_step = 0.0, 0
        for t in range(steps):
            expect_return = np.float32(expect_return + reward[t, b])
            expect_step += 1
            np.testing.assert_allclose(
                ep_return[t, b], expect_return, rtol=1e-6,
                err_msg=f"emitted episode_return env {b} t={t} (must "
                        f"include the final step's reward)")
            assert ep_step[t, b] == expect_step, (
                f"emitted episode_step env {b} t={t}: {ep_step[t, b]} "
                f"!= {expect_step}")
            if done[t, b]:
                expect_return, expect_step = 0.0, 0
                finished += 1
    assert finished > 0, (
        f"no episode finished in {steps} steps: the autoreset check has "
        f"no power; lower the level's episode_length or raise `steps`")


_HOST_READS = ("item", "tolist", "__array__", "__bool__", "numpy")


@contextlib.contextmanager
def host_read_spy():
    """Record every call of the ``Tensor`` methods that read a value back
    to the host (``_HOST_READS``), yielding the list of the names called:
    the CPU's stand-in for the card's sync debug mode."""
    calls: List[str] = []
    originals = {name: getattr(torch.Tensor, name) for name in _HOST_READS}

    def spy(name, original):
        def wrapper(self, *args, **kwargs):
            calls.append(name)
            return original(self, *args, **kwargs)

        return wrapper

    for name, original in originals.items():
        setattr(torch.Tensor, name, spy(name, original))
    try:
        yield calls
    finally:
        for name, original in originals.items():
            setattr(torch.Tensor, name, original)


@contextlib.contextmanager
def no_host_reads(device):
    """Fail on any read of a device value by the host inside the block: on
    a card ``torch.cuda.set_sync_debug_mode("error")`` raises at the
    synchronizing call; on the CPU the spy records, and the block fails at
    its end if anything was read."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return
    with host_read_spy() as calls:
        yield
    assert calls == [], (
        f"the rollout read device values on the host: {calls}; a "
        f"data-dependent branch is hiding in the step path")


def check_zero_host_sync(env_factory: Callable[[], object], device="cpu",
                         batch: int = 4, steps: int = 16) -> None:
    """A rollout reads nothing back to the host (``no_host_reads``)."""
    env = env_factory()
    seeds = conformance_seeds(env, batch)
    state, _ = env.initial(seeds, device=device)
    actions = _actions(env, batch, steps, device)
    state, _ = rollout(env, state, actions)  # the first call's set-up
    with no_host_reads(device):
        state, outs = rollout(env, state, actions)
    # The harness itself reads the results, after the check.
    assert np.isfinite(outs.reward.cpu().numpy()).all()


def _storage_overlaps(carry) -> List[str]:
    """Pairs of the carry's tensors (by leaf index) whose memory
    overlaps."""
    spans = []
    for i, leaf in enumerate(leaves(carry)):
        if leaf.numel() == 0:
            continue
        start = leaf.data_ptr()
        spans.append((start, start + leaf.numel() * leaf.element_size(),
                      i))
    spans.sort()
    overlaps = []
    for (s0, e0, i), (s1, e1, j) in zip(spans, spans[1:]):
        if s1 < e0:
            overlaps.append(f"leaves {i} and {j}")
    return overlaps


def check_donation(env_factory: Callable[[], object], device="cpu",
                   batch: int = 4, steps: int = 2) -> None:
    """No two tensors of the ``(state, output)`` carry share storage, after
    ``initial`` and after ``steps`` steps: a caller may then update any leaf
    in place (the property the JAX package's donation needs)."""
    env = env_factory()
    seeds = conformance_seeds(env, batch)
    carry = env.initial(seeds, device=device)
    overlaps = _storage_overlaps(carry)
    assert not overlaps, (
        f"initial() returned tensors sharing storage ({overlaps}): a "
        f"carry updated in place would donate the same buffer twice")
    actions = _actions(env, batch, steps, device)
    for t in range(steps):
        carry = env.step(carry[0], actions[t])
        overlaps = _storage_overlaps(carry)
        assert not overlaps, (
            f"step {t} returned tensors sharing storage ({overlaps}): a "
            f"carry updated in place would donate the same buffer twice")
    assert int(carry[1].info.episode_step.min()) >= 1


CHECKS: Dict[str, Callable[..., None]] = {
    "spec": check_spec,
    "determinism": check_determinism,
    "autoreset": check_autoreset,
    "zero_host_sync": check_zero_host_sync,
    "donation": check_donation,
}


def run_conformance(env_factory: Callable[[], object], device="cpu",
                    checks: Optional[Sequence[str]] = None) -> List[str]:
    """Run ``checks`` (default: all) against a new-env factory on
    ``device``; raises AssertionError at the first violation, returns the
    names of the checks run."""
    names = list(checks) if checks is not None else sorted(CHECKS)
    for name in names:
        CHECKS[name](env_factory, device=device)
    return names
