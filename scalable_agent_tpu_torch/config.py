"""The run configuration of the port: the subset of
``scalable_agent_tpu/config.py``'s ``Config`` this package runs, under the
same flag names and defaults, plus ``device``.

Two deliberate differences from the JAX defaults: ``compute_dtype`` is
``float32`` (the only policy ported so far), and ``device`` picks where the
run happens — ``cuda`` unless the caller asks for ``cpu``, and never the
CPU silently when a card was asked for.

A JAX flag this package does not port yet, or a value of a ported flag it
does not support, raises a ``ValueError`` that points at ROADMAP.md; it is
never ignored.
"""

import argparse
import dataclasses
import json
import os
from typing import Optional

# Every field of scalable_agent_tpu.config.Config this package does not
# port yet (ROADMAP.md, queue 1).  tests/test_torch_hygiene.py holds this
# list against the JAX Config so the two cannot drift apart.
UNPORTED_FLAGS = (
    "benchmark_mode", "dataset_path", "renderer", "record_to",
    "fused_forward", "remat_torso", "use_instruction",
    "mesh_data", "mesh_seq", "mesh_model", "distributed_coordinator",
    "distributed_num_processes", "distributed_process_id", "inference_mode",
    "accum_fused_shards", "actor", "service_max_batch", "train_backend",
    "updates_per_dispatch", "transport", "inflight_updates", "loss",
    "replay_ratio", "replay_capacity", "target_update_interval",
    "impact_clip_epsilon", "profile_dir", "profile_start_update",
    "profile_num_updates", "trace",
    "watchdog_timeout_s", "watchdog_abort", "metrics_http_port",
    "learn_telemetry", "health", "health_warmup_intervals",
    "health_ewma_alpha", "health_z_threshold", "health_rel_threshold",
    "health_cooldown_s", "health_max_windows", "health_window_updates",
    "health_baseline_dir", "nonfinite_tolerance", "sentinel_interval",
    "sentinel_rtol", "no_rollback", "chaos_spec",
    "chaos_channel", "compile_cache_dir", "peer_timeout_s",
    "preemption_grace_s", "collective_timeout_s",
    "coordinator_init_timeout_s", "elastic", "fleet_epoch",
    "elastic_restart_budget", "elastic_stable_s", "elastic_rejoin_delay_s",
)

# Ported flags that take only some of the JAX package's values here.
SUPPORTED_VALUES = {
    "mode": ("train", "test"),
    "torso_type": ("shallow",),
    "compute_dtype": ("float32",),
    # "pallas" names the fused done-reset core; its counterpart here is
    # the hand-written CUDA kernel, which "auto" also resolves to.
    "core_impl": ("auto", "pallas"),
    "core_matmul_dtype": ("auto", "float32"),
    "conv_backend": ("auto", "pallas"),
    # associative/sequential run the recurrence as a plain reverse loop,
    # pallas as the fused CUDA kernel; auto resolves to associative
    # (runtime/learner.py).  time_sharded needs a seq mesh axis.
    "scan_impl": ("auto", "associative", "sequential", "pallas"),
    "rmsprop_momentum": (0.0,),
    "reward_clipping": ("abs_one", "soft_asymmetric", "none"),
}


def _not_ported(what: str) -> ValueError:
    return ValueError(
        f"{what} is not ported to scalable_agent_tpu_torch yet; ROADMAP.md "
        f"(queues 1 and 2) lists what the port runs and what comes next")


@dataclasses.dataclass
class Config:
    # -- run control (reference: experiment.py:49-60)
    mode: str = "train"  # train | test
    logdir: str = "/tmp/agent"
    level_name: str = "fake_benchmark"
    seed: int = 1

    # -- training sizes (reference: experiment.py:61-72)
    num_actors: int = 64  # total env count across groups
    batch_size: int = 32
    unroll_length: int = 100
    num_action_repeats: int = 4
    total_environment_frames: float = 1e9

    # -- loss (reference: experiment.py:73-81)
    entropy_cost: float = 0.00025
    baseline_cost: float = 0.5
    discounting: float = 0.99
    reward_clipping: str = "abs_one"

    # -- optimizer (reference: experiment.py:89-95)
    learning_rate: float = 0.00048
    rmsprop_decay: float = 0.99
    rmsprop_momentum: float = 0.0
    rmsprop_epsilon: float = 0.1

    # -- env (reference: experiment.py:82-88)
    width: int = 96
    height: int = 72
    # Env worker processes per actor group; 0 means one per env, as in
    # the JAX package (driver.worker_processes).
    num_env_workers_per_group: int = 8

    # -- eval (reference: experiment.py:57-58)
    test_num_episodes: int = 10
    test_batch_size: int = 8  # parallel eval envs
    # Env worker processes of the eval fleet; 0 means one per env.
    test_num_workers: int = 2

    # -- model and kernels
    torso_type: str = "shallow"
    compute_dtype: str = "float32"
    core_impl: str = "auto"
    core_matmul_dtype: str = "auto"
    conv_backend: str = "auto"
    scan_impl: str = "auto"
    checkpoint_interval_s: float = 600.0  # reference: experiment.py:611-612
    checkpoint_keep: int = 5
    log_interval_s: float = 10.0
    # Respawns of a failing actor thread (capped exponential backoff)
    # before its exception ends the run; 0 fails fast.
    actor_max_restarts: int = 3

    # -- the port's own: "cuda" (default), "cuda:N" or "cpu".
    device: str = "cuda"

    def __post_init__(self):
        for name, allowed in SUPPORTED_VALUES.items():
            if getattr(self, name) not in allowed:
                raise _not_ported(f"--{name}={getattr(self, name)}")
        if self.num_actors < self.batch_size:
            raise ValueError(
                f"num_actors {self.num_actors} < batch_size "
                f"{self.batch_size}: each actor group is one learner batch")

    def frames_per_update(self) -> int:
        """(reference: experiment.py:417-420)"""
        return (self.batch_size * self.unroll_length
                * self.num_action_repeats)

    def save(self, path: Optional[str] = None) -> str:
        """Write the config as JSON, by default to
        ``<logdir>/config.json``."""
        path = path or os.path.join(self.logdir, "config.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "Config":
        """Read a saved config; keys this package does not know are
        dropped."""
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    @classmethod
    def from_argv(cls, argv=None, description=None) -> "Config":
        """Parse ``--<field>=value`` flags (the JAX driver's flag names).
        A JAX flag that is not ported raises instead of being ignored."""
        parser = argparse.ArgumentParser(description=description)
        for field in dataclasses.fields(cls):
            arg_type = type(field.default)
            if arg_type is bool:
                parser.add_argument(
                    f"--{field.name}", type=lambda v: v.lower() in
                    ("1", "true", "yes"), default=field.default)
            else:
                parser.add_argument(f"--{field.name}", type=arg_type,
                                    default=field.default)
        args, rest = parser.parse_known_args(argv)
        for arg in rest:
            name = arg[2:].split("=", 1)[0] if arg.startswith("--") else ""
            if name in UNPORTED_FLAGS:
                raise _not_ported(f"the flag --{name}")
        if rest:
            parser.error(f"unrecognized arguments: {' '.join(rest)}")
        return cls(**vars(args))
