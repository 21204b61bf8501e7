"""Time the actor flavours of the ActorPool's inference modes alone (no
learner) on the main path's groups, on one card.

    python3 -m scalable_agent_tpu_torch.tools.actor_modes_ab [--unrolls=2]

Arms: the structural ``VectorActor``, the ``AccumVectorActor`` (one each
on one thread, then one a group on two threads at once) and the
``GroupedAccumActor`` over both groups on one thread; ``fake_benchmark``
at full width (2 groups of 32 envs, 8 env worker processes a group, unroll
100, bf16).  Each arm runs one unroll to warm up, then ``--unrolls``
timed, and prints ms per step split into the parts the actor thread waits
on: the uploads (structural: ``to_device`` of the env outputs and the last
action; accum: ``_Staging.upload``), the step's dispatch (``actor_step``;
accum: ``AccumPrograms.step``), the fetch (structural: ``to_numpy`` of the
agent output; accum: ``_fetch_actions``), the env step (send and receive),
and the rest.  Then, for each single-thread arm, one more unroll under
``torch.profiler``: CUDA kernels and copies and their device ms per step.
Then the card's name and power limit.
"""

import argparse
import contextlib
import subprocess
import threading
import time
from collections import defaultdict

PARTS = ("upload", "step", "fetch", "env")


@contextlib.contextmanager
def _timing(module, name, samples, part):
    """Wrap ``module.name`` so each call adds its seconds to ``part`` of
    the calling thread's samples."""
    real = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            samples[threading.current_thread().name][part] += (
                time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, real)


def _groups(config):
    from scalable_agent_tpu_torch import driver

    spec, _, _ = driver.probe_env(config)
    return spec, driver.make_env_groups(config, spec.frame)


def _actors(arm, agent, groups, config, spec):
    from scalable_agent_tpu_torch.runtime import VectorActor
    from scalable_agent_tpu_torch.runtime.accum_actor import (
        AccumPrograms,
        AccumVectorActor,
        GroupedAccumActor,
    )

    T = config.unroll_length
    if arm.startswith("structural"):
        return [VectorActor(agent, envs, T, seed=1000 * i)
                for i, envs in enumerate(groups)]
    programs = AccumPrograms(agent, T, config.batch_size, spec.frame.shape)
    if arm.startswith("accum"):
        return [AccumVectorActor(programs, envs, seed=1000 * i)
                for i, envs in enumerate(groups)]
    return [GroupedAccumActor(programs, groups,
                              seeds=[1000 * i for i in range(len(groups))])]


def run_arm(torch, arm, agent, groups, config, spec, unrolls):
    from scalable_agent_tpu_torch.runtime import accum_actor, actor

    threads = 2 if arm.endswith("x2") else 1
    actors = _actors(arm, agent, groups[:threads] if "fused" not in arm
                     else groups, config, spec)
    samples = defaultdict(lambda: defaultdict(float))
    streams = [torch.cuda.Stream() for _ in actors]

    def work(a, stream, n):
        with torch.cuda.stream(stream):
            for _ in range(n):
                a.run_unroll()
            torch.cuda.current_stream().synchronize()

    def run(n):
        workers = [threading.Thread(target=work, args=(a, s, n),
                                    name=f"actor-{i}")
                   for i, (a, s) in enumerate(zip(actors, streams))]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        return time.perf_counter() - t0

    run(1)
    patches = [
        (actor, "to_device", "upload"), (actor, "actor_step", "step"),
        (actor, "to_numpy", "fetch"),
        (accum_actor._Staging, "upload", "upload"),
        (accum_actor.AccumPrograms, "step", "step"),
        (accum_actor, "_fetch_actions", "fetch")]
    with contextlib.ExitStack() as stack:
        for module, name, part in patches:
            stack.enter_context(_timing(module, name, samples, part))
        for envs in groups:
            for method in ("step_send", "step_recv"):
                stack.enter_context(_timing(envs, method, samples, "env"))
        wall = run(unrolls)
    steps = unrolls * config.unroll_length
    for name in sorted(samples):
        parts = samples[name]
        rest = wall - sum(parts[p] for p in PARTS)
        print(f"  {arm} {name}: {wall / steps * 1e3:.3f} ms per step = "
              + ", ".join(f"{p} {parts[p] / steps * 1e3:.3f}" for p in PARTS)
              + f", rest {rest / steps * 1e3:.3f}", flush=True)
    if threads == 1:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(1)
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0.0)
                        for e in kernels)
        per = config.unroll_length
        print(f"  {arm} under torch.profiler: "
              f"{sum(e.count for e in kernels) / per:.1f} CUDA kernels and "
              f"copies, {device_us / per / 1e3:.4f} device ms per step",
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--unrolls", type=int, default=2)
    args = parser.parse_args(argv)
    import torch

    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.driver import build_agent

    config = Config(level_name="fake_benchmark", device="cuda")
    spec, groups = _groups(config)
    try:
        from scalable_agent_tpu_torch import driver

        _, space, _ = driver.probe_env(config)
        agent = build_agent(config, spec, space,
                            torch.device("cuda")).requires_grad_(False)
        for arm in ("structural", "accum", "fused", "structural x2",
                    "accum x2"):
            run_arm(torch, arm, agent, groups, config, spec, args.unrolls)
    finally:
        for envs in groups:
            envs.close()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
