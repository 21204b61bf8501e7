"""Time chip_smoke.py phase 3c's fake_bandit run at another checkout of
this repository and at this one, on the same card, each run in its own
process: other, this, this, other, then this checkout twice with the obs
planes off (``--learn_telemetry=false --watchdog_timeout_s=0``).

    python3 -m scalable_agent_tpu_torch.tools.bandit_ab --other=<dir>

The run is 3c's: fake_bandit at 16x16, 32 actors in 2 groups of 16,
unroll 16, one action repeat, lr 0.002, entropy 0.003, 2 env worker
processes per group, a metrics row every update, ``--scan_impl=pallas``,
seed 1, 200 updates.  Each process prints the seconds ``driver.train``
took, set-up included; this prints them with the card's name and power
limit.  A checkout builds its kernels in its first process.
"""

import argparse
import os
import subprocess
import sys

UPDATES = 200
_TRAIN = r'''
import sys, tempfile, time
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.ops import _build
if __name__ == "__main__":
    _build.library()
    planes_off = sys.argv[1] == "off"
    with tempfile.TemporaryDirectory() as logdir:
        config = Config(level_name="fake_bandit", device="cuda", height=16,
                        width=16, num_actors=32, batch_size=16,
                        unroll_length=16, num_action_repeats=1,
                        total_environment_frames=float(%d * 16 * 16),
                        learning_rate=0.002, entropy_cost=0.003,
                        num_env_workers_per_group=2, log_interval_s=0.0,
                        checkpoint_interval_s=3600.0, scan_impl="pallas",
                        seed=1, logdir=logdir)
        if planes_off:
            config.learn_telemetry = False
            config.watchdog_timeout_s = 0.0
        t0 = time.monotonic()
        driver.train(config)
        print("TRAIN_S", time.monotonic() - t0, flush=True)
''' % UPDATES


def _run(root: str, planes: str) -> float:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _TRAIN, planes], env=env,
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    times = [float(line.split()[1]) for line in proc.stdout.splitlines()
             if line.startswith("TRAIN_S")]
    if proc.returncode or not times:
        raise RuntimeError(f"the run at {root} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return times[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the other checkout")
    args = parser.parse_args(argv)
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    runs = [("other", os.path.abspath(args.other), "on"),
            ("this", this, "on"), ("this", this, "on"),
            ("other", os.path.abspath(args.other), "on"),
            ("this", this, "off"), ("this", this, "off")]
    for name, root, planes in runs:
        seconds = _run(root, planes)
        print(f"{name} checkout, obs planes {planes}: {UPDATES} updates in "
              f"{seconds:.2f} s", flush=True)


if __name__ == "__main__":
    main()
