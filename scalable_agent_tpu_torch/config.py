"""The run configuration of the port: the subset of
``scalable_agent_tpu/config.py``'s ``Config`` this package runs, under the
same flag names and defaults, plus ``device``.

The defaults are the JAX package's, ``compute_dtype="bfloat16"`` included
(``float32`` is the other policy both packages run).  The one addition is
``device``: where the run happens -- ``cuda`` unless the caller asks for
``cpu``, and never the CPU silently when a card was asked for.

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
    "mesh_data", "mesh_seq", "mesh_model", "distributed_coordinator",
    "distributed_num_processes", "distributed_process_id", "inference_mode",
    "accum_fused_shards", "train_backend",
    "updates_per_dispatch", "sentinel_interval", "sentinel_rtol",
    "chaos_channel", "compile_cache_dir", "peer_timeout_s",
    "collective_timeout_s",
    "coordinator_init_timeout_s", "elastic", "fleet_epoch",
    "elastic_restart_budget", "elastic_stable_s", "elastic_rejoin_delay_s",
)

# Ported flags that take only some of the JAX package's values here.
SUPPORTED_VALUES = {
    "mode": ("train", "test"),
    # The host actor runtime (a value outside these raises the JAX
    # driver's "unknown actor" error).
    "actor": ("grouped", "service"),
    "torso_type": ("shallow", "resnet"),
    "compute_dtype": ("bfloat16", "float32"),
    # "pallas" names the hand-written CUDA kernels (the fused done-reset
    # core, the stem's grad-W), which "auto" also resolves to; "xla" the
    # library routes (resolve_core_impl, resolve_conv_backend).
    # (core_matmul_dtype is checked as the JAX driver checks it:
    # resolve_core_matmul_dtype.)
    "core_impl": ("auto", "pallas", "xla"),
    "conv_backend": ("auto", "pallas", "xla"),
    # associative is the JAX log-depth reverse scan over compose_affine,
    # sequential the plain reverse loop, pallas the fused CUDA kernel;
    # auto resolves to associative (runtime/learner.py).  time_sharded
    # needs a seq mesh axis.
    "scan_impl": ("auto", "associative", "sequential", "pallas"),
    "reward_clipping": ("abs_one", "soft_asymmetric", "none"),
    # "auto" primes the health detectors from the committed BENCH_r*.json,
    # which are TPU rounds, and a directory needs the JAX package's
    # obs/rounds.py: both wait for the port's own rounds.
    "health_baseline_dir": ("",),
}


def resolve_core_impl(config: "Config") -> str:
    """The LSTM core's route, as ``scalable_agent_tpu/driver.py:208-217``
    resolves it: ``pallas`` is the fused done-reset core, here the
    hand-written kernels of ``ops/lstm_cuda.py``; ``xla`` the per-step
    LSTM in torch ops under autograd (``models/agent.LSTMCore``).  ``auto``
    is the kernels, as the JAX driver's is on its accelerator: on the card
    they launch, on the CPU their plain versions run.  Only the flag
    selects ``xla``."""
    return "pallas" if config.core_impl == "auto" else config.core_impl


def resolve_conv_backend(config: "Config") -> str:
    """The stem conv's weight-gradient route, as
    ``scalable_agent_tpu/driver.py:220-231`` resolves it: ``pallas`` is the
    hand-written grad-W kernel (``ops/conv_cuda.stem_conv``), ``xla`` the
    library convolution under autograd (cuDNN's wgrad on the card).
    ``auto`` is the kernel, as the JAX driver's is on its accelerator; only
    the flag selects ``xla``."""
    return "pallas" if config.conv_backend == "auto" else config.conv_backend


def resolve_core_matmul_dtype(config: "Config",
                              core_impl: Optional[str] = None) -> str:
    """The operand type of the core's products, as
    ``scalable_agent_tpu/driver.py:234-246`` resolves it and ``:264-268``
    checks it: ``auto`` follows ``compute_dtype`` for the fused core and
    is ``float32`` for the ``xla`` core, which trains at the float32
    params' precision (``core_impl`` defaults to the configuration's,
    ``resolve_core_impl``); ``float32`` and ``bfloat16`` are taken as
    given; anything else raises the JAX driver's error."""
    dtype = config.core_matmul_dtype
    if dtype == "auto":
        core_impl = core_impl or resolve_core_impl(config)
        dtype = ("bfloat16" if config.compute_dtype == "bfloat16"
                 and core_impl == "pallas" else "float32")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"core_matmul_dtype must be auto, float32, or bfloat16, "
            f"got {dtype!r}")
    return dtype


# Family defaults a run takes unless its flags set them
# (scalable_agent_tpu/config.py:491-500).
_ENV_OVERRIDES = {
    "doom_": {"width": 128, "height": 72, "num_action_repeats": 4},
    "atari_": {"width": 84, "height": 84, "num_action_repeats": 4},
    "dmlab_": {"width": 96, "height": 72, "num_action_repeats": 4},
    # The full suite: DMLab defaults + instruction observations (the
    # language levels need them; the reference's dmlab30 agent always
    # consumes INSTR, experiment.py:179-189).
    "dmlab30": {"width": 96, "height": 72, "num_action_repeats": 4,
                "use_instruction": True},
}


def apply_env_overrides(config: "Config") -> "Config":
    """The level family's defaults over the fields the caller left at
    ``Config``'s defaults (``scalable_agent_tpu/config.py:503-513``):
    Doom's 72x128 frames, Atari's 84x84, and ``dmlab30``'s instruction
    stream."""
    for prefix, overrides in _ENV_OVERRIDES.items():
        if config.level_name.startswith(prefix):
            defaults = Config()
            fields = {
                k: v for k, v in overrides.items()
                # Values set on the command line win over the family's.
                if getattr(config, k) == getattr(defaults, k)
            }
            return dataclasses.replace(config, **fields)
    return config


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
    # Step every env with a random action of its own in place of the
    # agent's (envs/core.py BenchmarkStream): fps free of the policy.
    benchmark_mode: bool = False
    # DMLab-only: psychlab dataset location and renderer backend
    # (reference: experiment.py:77-87 dataset_path/renderer flags;
    # software is the run-anywhere default, hardware needs EGL).
    dataset_path: str = ""
    renderer: str = "software"

    # -- eval (reference: experiment.py:57-58)
    test_num_episodes: int = 10
    test_batch_size: int = 8  # parallel eval envs
    # Env worker processes of the eval fleet; 0 means one per env.
    test_num_workers: int = 2
    # Record the eval episodes (frames.npy and episode.json per episode)
    # under <record_to>/<level>/env_NN, or per match and player
    # (<level>/match_NN/player_NN) on a multi-agent level; "" records
    # nothing.  Test mode only.
    record_to: str = ""

    # -- model and kernels
    torso_type: str = "shallow"  # shallow | resnet
    # The language LSTM over the observation's instruction (the envs
    # carry one: FakeEnv's with_instruction).
    use_instruction: bool = False
    # The one dtype policy (models/agent.py): torso, concat and heads at
    # compute_dtype; params, loss, V-trace and optimizer in float32.
    compute_dtype: str = "bfloat16"
    core_impl: str = "auto"
    core_matmul_dtype: str = "auto"
    conv_backend: str = "auto"
    scan_impl: str = "auto"
    # False runs the learner's two-pass reference (a separate unroll
    # without gradients for V-trace's comparison quantities); an A/B arm,
    # not a production setting.
    fused_forward: bool = True
    # Recompute the torso in the backward pass: auto | on | off; "auto"
    # is on only on a TPU, so off on the card (driver.resolve_remat_torso).
    remat_torso: str = "auto"

    # -- the host loop (runtime/transport.py, runtime/fleet.py)
    # "packed": one pinned staging buffer and one copy per batch,
    # unpacked on the card as views; "per_leaf": one upload per leaf.
    transport: str = "packed"
    # Updates in flight before the loop waits for the oldest one.
    inflight_updates: int = 2
    # This many consecutive non-finite skips roll back to the newest
    # verified checkpoint (or exit 71 under no_rollback); 0 disables it.
    nonfinite_tolerance: int = 10
    no_rollback: bool = False
    # SIGTERM drains to one verified final checkpoint and exits 0 within
    # this many seconds (exit 72 past it); 0 keeps SIGTERM's default.
    preemption_grace_s: float = 30.0
    # Fault injection (runtime/faults.py): 'point@i[:j...]',
    # 'point@t=30s' or 'point@p=0.01' entries joined by ';'.
    chaos_spec: str = ""

    # -- off-policy training (runtime/replay.py, ops/impact.py)
    # "vtrace" (the reference's objective) or "impact" (the clipped-target
    # surrogate anchored on a target network; it tolerates staler data).
    loss: str = "vtrace"
    # Replayed updates behind every fresh one: each fresh batch's packed
    # upload also lands in the replay slab on the card.  Replayed updates
    # do not advance env_frames.  0 allocates no slab.
    replay_ratio: int = 0
    # The slab's capacity in whole batches (capacity x packed-batch bytes
    # on the card); its contents are not checkpointed.
    replay_capacity: int = 64
    # IMPACT: copy the parameters into the target network every this many
    # FRESH updates.
    target_update_interval: int = 100
    # IMPACT: the ratio pi_theta/pi_target is clipped to [1-eps, 1+eps].
    impact_clip_epsilon: float = 0.3

    checkpoint_interval_s: float = 600.0  # reference: experiment.py:611-612
    checkpoint_keep: int = 5
    log_interval_s: float = 10.0
    # -- observability (obs/): the registry, metrics.prom, the flight
    # recorder, the stall attributor and the pipeline ledger are always
    # on.  torch.profiler capture from update profile_start_update, written
    # as a Chrome trace into profile_dir: one warm-up update, then the
    # profile_num_updates that <logdir>/kernels.json tables.
    profile_dir: str = ""  # empty = disabled
    profile_start_update: int = 10
    profile_num_updates: int = 5
    # Host pipeline spans to <logdir>/trace.p0.<pid>.json (Chrome trace
    # events, loadable in Perfetto), at most 2M events.
    trace: bool = False
    # A pipeline thread (actor, prefetch, learner) silent this long trips
    # the stalled_thread verdict and the flight recorder's dump
    # (flightrec.<pid>.json, stacks.<pid>.txt); 0 disables.  Above any
    # healthy pause: a checkpoint, not a step.
    watchdog_timeout_s: float = 300.0
    # Exit 70 after the watchdog's dump instead of hanging.
    watchdog_abort: bool = False
    # Serve the registry's live Prometheus text at this port (0: off):
    # /metrics, plus /anomalies and /health (obs.watch's payload) over
    # the logdir (obs/exporters.py MetricsHTTPServer).
    metrics_http_port: int = 0
    # The learning-dynamics telemetry (devtel/learn/*) in the update.
    learn_telemetry: bool = True
    # Respawns of a failing actor thread (capped exponential backoff)
    # before its exception ends the run; 0 fails fast.
    actor_max_restarts: int = 3
    # The host actor runtime: "grouped" (ActorPool, one thread per env
    # group stepping its envs in lockstep) or "service" (the
    # continuous-batching ActorService, runtime/service.py: env workers
    # stream their observations out one worker at a time, and one
    # inference thread batches whatever has arrived).
    actor: str = "grouped"
    # service only: the largest batch the inference thread forms (rows =
    # envs), padded up a power-of-two ladder; 0 = every env of the run.
    service_max_batch: int = 0

    # -- the run-health plane (obs/health.py): detectors at log cadence
    # over the registry stream and the interval's metrics.  A trip appends
    # <logdir>/anomalies.jsonl, pins and dumps the flight recorder, and
    # may open a profile window of health_window_updates updates into
    # <logdir>/health_profile.<id>/, harvested into
    # <logdir>/kernels.<id>.json.
    health: bool = True
    # Log intervals before a detector arms.
    health_warmup_intervals: int = 8
    # EWMA smoothing of the detector baselines (mean and variance).
    health_ewma_alpha: float = 0.35
    # The z-score a deviation needs (with a material relative one); a
    # relative drop or rise past health_rel_threshold trips on its own.
    health_z_threshold: float = 4.0
    health_rel_threshold: float = 0.6
    # Per-detector re-trip cooldown, and the least gap between windows.
    health_cooldown_s: float = 120.0
    # Profile windows for the whole run (0: records and dumps only).
    health_max_windows: int = 2
    # Updates one anomaly window tables (after one warm-up update).
    health_window_updates: int = 5
    # Detector priming from committed rounds: only "" (off) here.
    health_baseline_dir: str = ""

    # -- the port's own: "cuda" (default), "cuda:N" or "cpu".
    device: str = "cuda"

    def __post_init__(self):
        if self.actor not in SUPPORTED_VALUES["actor"]:
            raise ValueError(
                f"unknown actor {self.actor!r} (grouped | service)")
        for name, allowed in SUPPORTED_VALUES.items():
            if getattr(self, name) not in allowed:
                raise _not_ported(f"--{name}={getattr(self, name)}")
        resolve_core_matmul_dtype(self)
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
        # No abbreviations: an unported JAX flag that is a prefix of a
        # ported one (--actor of --actor_max_restarts) must raise, not
        # set the other flag.
        parser = argparse.ArgumentParser(description=description,
                                         allow_abbrev=False)
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
