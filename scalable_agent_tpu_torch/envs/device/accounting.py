"""Episode accounting on the card, shared by every device env.

The counterpart of ``scalable_agent_tpu/envs/device/accounting.py``.  The
host backend's episodes surface through the env workers; a device env's
would surface only through the in-graph trainer's metrics.  These
instruments ride ``obs/device_telemetry.py``'s buffers instead, updated in
place on the card with the learner's own: counters of finished episodes
and agent steps, and bucketed return and length histograms whose exact sum
and count give exact means, fetched once a log interval and published as
``devtel/env/*``.
"""

from typing import Dict

from scalable_agent_tpu_torch.obs.device_telemetry import DeviceTelemetry
from scalable_agent_tpu_torch.types import StepOutput

__all__ = ["env_telemetry_spec", "record_episode_telemetry"]


def env_telemetry_spec() -> DeviceTelemetry:
    """The one ``devtel/env/*`` instrument set (module docstring)."""
    return (
        DeviceTelemetry("env")
        .counter("episodes", "episodes finished on device")
        .counter("steps", "agent steps executed on device")
        .histogram(
            "episode_return",
            (-10.0, -1.0, 0.0, 1.0, 2.0, 5.0, 10.0, 30.0, 100.0),
            "per-episode return at episode end (emitted accounting)")
        .histogram(
            "episode_length",
            (5.0, 10.0, 30.0, 100.0, 300.0, 1000.0, 3000.0),
            "per-episode agent steps at episode end")
    )


def record_episode_telemetry(spec: DeviceTelemetry, tel: Dict,
                             env_outputs: StepOutput) -> Dict:
    """Fold a ``[T, B]`` (or ``[B]``) StepOutput sequence into the env
    telemetry, in place and without a host sync.  A finished episode is
    ``done & episode_step > 0``, the in-graph trainer's own count:
    ``initial``'s done rows carry step 0 and are not episodes."""
    done = env_outputs.done
    steps = env_outputs.info.episode_step
    finished = done & (steps > 0)
    spec.inc(tel, "episodes", finished.sum().float())
    spec.inc(tel, "steps", float(done.numel()))
    spec.observe(tel, "episode_return", env_outputs.info.episode_return,
                 where=finished)
    spec.observe(tel, "episode_length", steps.float(), where=finished)
    return tel
