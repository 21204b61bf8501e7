"""The numerics sentinel's clean envelope on the card: the main path
trained with every update audited and no fault, the ladder held at a rung
(``--sentinel_rtol`` far above any reading, so nothing demotes), and every
audit's per-leaf deviation (both arms) recorded.

    python3 -m scalable_agent_tpu_torch.tools.sentinel_envelope \
        [--updates=120] [--rungs=0,1]

Each run is chip_smoke.py phase 3's configuration (``fake_benchmark`` at
full width, bf16, ``--scan_impl=pallas``) with ``--sentinel_interval=1``,
at rung 0 (the hot route: the hand-written kernels) or rung 1
(``--conv_backend=xla``: cuDNN's wgrad for the stem).  It prints, per run,
every audit whose deviation passes 0.3 with its five worst leaves, the
deviation's quantiles over the audits, the largest per leaf and how many
audits passed the JAX default rtol (0.6); then the card's name and power
limit.  Run it on the card: it refuses a machine without one.
"""

import argparse
import dataclasses
import os
import subprocess
import tempfile

import numpy as np

# Far above any reading: the envelope is taken at a fixed rung.
NO_DEMOTION_RTOL = 1e9
JAX_DEFAULT_RTOL = 0.6


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _run(config, audits):
    """``driver.train`` with every audit's deviations appended to
    ``audits`` (read off the card after the audit)."""
    from scalable_agent_tpu_torch import driver
    from scalable_agent_tpu_torch.runtime import sentinel as sentinel_lib

    real_audit = sentinel_lib.NumericsSentinel.audit

    def recorded(self, snap, trajectory, updates):
        real_audit(self, snap, trajectory, updates)
        grad, delta = self.last_deviations
        audits.append((updates + 1, self.leaf_names, grad.tolist(),
                       delta.tolist()))

    sentinel_lib.NumericsSentinel.audit = recorded
    try:
        driver.train(config)
    finally:
        sentinel_lib.NumericsSentinel.audit = real_audit


def _report(label, audits):
    worst = []
    by_leaf = {}
    for update, leaves, grad, delta in audits:
        rows = ([(d, leaf, "grad") for d, leaf in zip(grad, leaves)]
                + [(d, leaf, "delta") for d, leaf in zip(delta, leaves)])
        rows.sort(reverse=True)
        worst.append(rows[0][0])
        for d, leaf, arm in rows:
            key = (leaf, arm)
            by_leaf[key] = max(by_leaf.get(key, 0.0), d)
        if rows[0][0] > 0.3:
            print(f"  {label} update {update}: " + "; ".join(
                f"{leaf} ({arm}) {d:.4g}" for d, leaf, arm in rows[:5]),
                flush=True)
    worst = np.asarray(worst)
    q = np.quantile(worst, [0.5, 0.9, 0.99, 1.0])
    print(f"{label}: {len(worst)} audits; max deviation per audit p50 "
          f"{q[0]:.4g}, p90 {q[1]:.4g}, p99 {q[2]:.4g}, max {q[3]:.4g}; "
          f"{int((worst > JAX_DEFAULT_RTOL).sum())} over "
          f"{JAX_DEFAULT_RTOL}", flush=True)
    top = sorted(by_leaf.items(), key=lambda item: -item[1])[:8]
    print(f"{label}: largest per leaf: " + "; ".join(
        f"{leaf} ({arm}) {d:.4g}" for (leaf, arm), d in top), flush=True)


def main():
    import torch

    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.ops import _build

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--updates", type=int, default=120)
    parser.add_argument("--rungs", type=str, default="0,1")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sentinel_envelope measures the card: "
                         "torch.cuda.is_available() is false")
    card = _card()
    _build.library()
    base = Config(level_name="fake_benchmark", device="cuda",
                  scan_impl="pallas", sentinel_interval=1,
                  sentinel_rtol=NO_DEMOTION_RTOL, log_interval_s=0.0,
                  total_environment_frames=float(
                      args.updates * Config().frames_per_update()))
    for rung in (int(r) for r in args.rungs.split(",")):
        config = (base if rung == 0 else
                  dataclasses.replace(base, conv_backend="xla"))
        audits = []
        with tempfile.TemporaryDirectory() as scratch:
            _run(dataclasses.replace(
                config, logdir=os.path.join(scratch, f"rung{rung}")),
                audits)
        _report(f"rung {rung}", audits)
    print(card, flush=True)


if __name__ == "__main__":
    main()
