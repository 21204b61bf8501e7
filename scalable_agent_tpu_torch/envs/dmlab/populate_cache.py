"""Level-cache warmer: repeatedly reset DMLab envs across worker
processes so the compiled-level cache fills before a training run.

A copy of ``scalable_agent_tpu/envs/dmlab/populate_cache.py`` (reference:
envs/dmlab/dmlab_populate_cache.py:8-30 — 64 envs x 16 workers resetting
in a loop).  The cache lives in ``$DMLAB_LEVEL_CACHE`` (default
``/tmp/dmlab_level_cache``; ``envs/dmlab/__init__.py`` ``LevelCache``).

Run: python -m scalable_agent_tpu_torch.envs.dmlab.populate_cache \
        --level_name=dmlab_watermaze --num_envs=64 --num_workers=16
"""

import argparse
import logging
import multiprocessing as mp

log = logging.getLogger("scalable_agent_tpu_torch")


def _worker(level_name: str, width: int, height: int, seed: int,
            num_resets: int, counter) -> None:
    from scalable_agent_tpu_torch.envs.dmlab import make_dmlab_env

    env = make_dmlab_env(level_name, width=width, height=height, seed=seed)
    try:
        for _ in range(num_resets):
            env.reset()
            with counter.get_lock():
                counter.value += 1
    finally:
        env.close()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--level_name", default="dmlab_watermaze")
    parser.add_argument("--num_envs", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=16)
    parser.add_argument("--width", type=int, default=96)
    parser.add_argument("--height", type=int, default=72)
    args = parser.parse_args(argv)

    resets_per_worker = max(1, args.num_envs // args.num_workers)
    ctx = mp.get_context("spawn")
    counter = ctx.Value("i", 0)
    procs = [
        ctx.Process(target=_worker,
                    args=(args.level_name, args.width, args.height,
                          1000 + i, resets_per_worker, counter),
                    daemon=True)
        for i in range(args.num_workers)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    log.info("generated %d environments into the level cache",
             counter.value)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
