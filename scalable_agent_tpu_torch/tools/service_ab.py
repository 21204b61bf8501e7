"""Time the continuous-batching actor service (``--actor=service``) against
the grouped pool on the main path, on the same card, in turns: grouped,
service, service, grouped, ``--rounds`` times.

    python3 -m scalable_agent_tpu_torch.tools.service_ab [--rounds=2]

Each run is chip_smoke.py phase 3p's configuration: ``fake_benchmark`` at
full width (64 actors in 2 groups of 32, 8 env worker processes a group,
unroll 100, 4 action repeats, bf16, ``--scan_impl=pallas``), ``UPDATES``
updates with a metrics row every update.  It prints s per update over
updates 3..UPDATES and the mean actor fps of their rows, and for a service
run the p50 and p95 ms of its batches (``_run_batch``: forming the batch,
the step, the actions out) and of their step alone (the snapshot load,
the uploads and ``service_actor_step``), over the run's last two thirds,
with the batches by padded size, and on the env threads the p50 ms of a
worker's reply (``MultiEnv.worker_recv``) and the mean ms of assembling a
trajectory (``TrajectoryPacker.pop``); then the card's name and power
limit.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np

UPDATES = 6


def _timed(samples, name, fn):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            samples[name].append(time.perf_counter() - t0)
    return wrapper


def _timed_service(service_mod, samples):
    """An ActorService whose batches and steps record their seconds, with
    packers whose ``pop`` does."""

    class TimedPacker(service_mod.TrajectoryPacker):
        pop = _timed(samples, "pop", service_mod.TrajectoryPacker.pop)

    class Timed(service_mod.ActorService):
        packer_cls = TimedPacker

        def _run_batch(self, requests):
            t0 = time.perf_counter()
            try:
                return super()._run_batch(requests)
            finally:
                samples["batch"].append(time.perf_counter() - t0)

        def _step(self, ids, n, actions, env_batch):
            t0 = time.perf_counter()
            try:
                return super()._step(ids, n, actions, env_batch)
            finally:
                samples["step"].append(time.perf_counter() - t0)
                samples["padded"].append(len(ids))

    return Timed


def _run(driver, config, actor: str, service_cls, samples) -> dict:
    from scalable_agent_tpu_torch.envs.vector import MultiEnv
    from scalable_agent_tpu_torch.runtime import service as service_mod

    for values in samples.values():
        values.clear()
    saved = (driver.ActorService, service_mod.TrajectoryPacker,
             MultiEnv.worker_recv)
    with tempfile.TemporaryDirectory() as logdir:
        run = dataclasses.replace(config, logdir=logdir, actor=actor)
        driver.ActorService = service_cls
        service_mod.TrajectoryPacker = service_cls.packer_cls
        MultiEnv.worker_recv = _timed(samples, "recv", saved[2])
        try:
            driver.train(run)
        finally:
            (driver.ActorService, service_mod.TrajectoryPacker,
             MultiEnv.worker_recv) = saved
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = {r["step"]: r for r in map(json.loads, f)
                    if not any(k.startswith("obs/") for k in r)}
    tail = [rows[k] for k in range(3, UPDATES + 1)]
    out = {"actor": actor,
           "s_per_update": (rows[UPDATES]["time"] - rows[2]["time"])
           / (UPDATES - 2),
           "actor_fps": sum(r["actor_fps"] for r in tail) / len(tail)}
    for part in ("batch", "step", "recv"):
        values = samples[part]
        if values:
            late = np.asarray(values[len(values) // 3:]) * 1e3
            out[f"{part}_ms_p50"] = float(np.percentile(late, 50))
            out[f"{part}_ms_p95"] = float(np.percentile(late, 95))
    if samples["pop"]:
        out["pop_ms_mean"] = 1e3 * float(np.mean(samples["pop"]))
    if samples["padded"]:
        sizes, counts = np.unique(samples["padded"], return_counts=True)
        out["batches_by_padded_size"] = dict(
            zip(map(int, sizes), map(int, counts)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)

    from scalable_agent_tpu_torch import driver
    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.ops import _build
    from scalable_agent_tpu_torch.runtime import service as service_mod

    _build.library()
    samples = {"batch": [], "step": [], "padded": [], "recv": [],
               "pop": []}
    service_cls = _timed_service(service_mod, samples)
    config = Config(level_name="fake_benchmark", device="cuda",
                    scan_impl="pallas", log_interval_s=0.0,
                    total_environment_frames=float(
                        UPDATES * Config().frames_per_update()))
    for _ in range(args.rounds):
        for actor in ("grouped", "service", "service", "grouped"):
            print(json.dumps(_run(driver, config, actor, service_cls,
                                  samples)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
