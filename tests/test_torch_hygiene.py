"""The port's boundaries: it imports neither JAX nor the JAX package, it
never runs on the CPU when the card was asked for, and what it does not
port yet fails loudly instead of being ignored."""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from scalable_agent_tpu import config as jax_config
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import (
    SUPPORTED_VALUES,
    UNPORTED_FLAGS,
    Config,
)
from scalable_agent_tpu_torch.ops import _build, conv_cuda, vtrace_cuda

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "scalable_agent_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scalable_agent_tpu")


def _port_files():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [root for root in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_leaves_jax_out():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PACKAGE.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


OBS_CLIS = ("aggregate", "report", "diagnose", "watch")


def test_importing_obs_and_its_clis_leaves_torch_and_jax_out():
    """The obs package and its four CLIs run on a laptop against logdirs
    copied off the card: importing them loads neither torch nor jax."""
    modules = ["scalable_agent_tpu_torch.obs"] + [
        f"scalable_agent_tpu_torch.obs.{name}" for name in OBS_CLIS]
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


# The modules an env worker process imports to host a Doom, DMLab, Atari
# or gym stream.
ENV_WORKER_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in [*(PACKAGE / "envs" / "doom").glob("*.py"),
              *(PACKAGE / "envs" / "dmlab").glob("*.py"),
              *(PACKAGE / "envs" / "atari").glob("*.py"),
              PACKAGE / "envs" / "dmlab30.py",
              PACKAGE / "envs" / "gym_adapter.py",
              PACKAGE / "envs" / "wrappers.py", PACKAGE / "utils" / "net.py"])


def _doom_scenarios(tmp_path):
    """Scenario .cfg files for the fake VizDoom (``tests/fakes``)."""
    for name in ("battle.cfg", "ssl2.cfg"):
        (tmp_path / name).write_text(
            "available_game_variables = { HEALTH ARMOR FRAGCOUNT "
            "DEATHCOUNT PLAYER_NUM PLAYER_COUNT PLAYER1_FRAGCOUNT "
            "PLAYER2_FRAGCOUNT }\n")
    return dict(os.environ, DOOM_SCENARIOS_DIR=str(tmp_path),
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT), str(ROOT / "tests" / "fakes")]))


def test_env_worker_modules_leave_torch_and_jax_out(tmp_path):
    """What an env worker imports for the Doom family (``envs/doom/*``,
    ``envs/wrappers.py``, ``utils/net.py``), the DMLab family
    (``envs/dmlab/*``, ``envs/dmlab30.py``) and the Atari and gym families
    (``envs/atari/*``, ``envs/gym_adapter.py``), and a Doom stream with
    recording, a lockstep match, a DMLab stream (the fake DeepMind Lab),
    an Atari and a gym stream (``chip_smoke.py``'s stand-in gymnasium)
    built and stepped in that process, load neither torch nor jax."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    standin = chip_smoke.write_gymnasium_standin(str(tmp_path))
    code = ("import importlib, sys\n"
            f"for name in {ENV_WORKER_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "from scalable_agent_tpu_torch.envs import create_env, "
            "make_impala_stream\n"
            "s = make_impala_stream('doom_benchmark', num_action_repeats=4, "
            f"record_to={str(tmp_path / 'rec')!r})\n"
            "s.initial(); s.step(1); s.close()\n"
            "m = create_env('doom_duel', num_action_repeats=4)\n"
            "m.reset(); m.step([(0,) * 7] * 2); m.close()\n"
            "for name, kwargs in (('dmlab_rooms_watermaze', dict(width=16, "
            "height=16)), ('atari_breakout', {}), ('gym_CartPole-v1', "
            "dict(width=16, height=16))):\n"
            "    s = make_impala_stream(name, num_action_repeats=4, "
            "**kwargs)\n"
            "    s.initial(); s.step(1); s.close()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'scalable_agent_tpu'))\n"
            "assert not bad, bad\n")
    assert len(ENV_WORKER_MODULES) == 14
    env = _doom_scenarios(tmp_path)
    env["PYTHONPATH"] = os.pathsep.join([standin, env["PYTHONPATH"]])
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_doom_cli_env_workers_never_import_torch(tmp_path):
    """``python -m scalable_agent_tpu_torch.driver
    --level_name=doom_benchmark`` with 2 env worker processes: torch is
    imported once, by the driver's own process (as
    ``tests/test_torch_driver.py::test_cli_env_workers_never_import_torch``
    counts it for the fake family)."""
    env = dict(_doom_scenarios(tmp_path), PYTHONPROFILEIMPORTTIME="1")
    proc = subprocess.run([
        sys.executable, "-m", "scalable_agent_tpu_torch.driver",
        "--device=cpu", "--level_name=doom_benchmark", "--num_actors=2",
        "--batch_size=2", "--unroll_length=2",
        "--total_environment_frames=16", f"--logdir={tmp_path / 'run'}",
        "--num_env_workers_per_group=2", "--compute_dtype=float32"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert imported.count("numpy") >= 3  # the driver and its 2 workers
    assert imported.count("torch") == 1
    assert imported.count(
        "scalable_agent_tpu_torch.envs.doom.core") >= 3


def test_record_to_is_ported():
    """``--record_to`` parses and is no longer in ``UNPORTED_FLAGS``."""
    assert "record_to" not in UNPORTED_FLAGS
    assert Config.from_argv(["--record_to=/x"]).record_to == "/x"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        driver.train(Config(device="cuda", level_name="fake_small"))


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, 8, 3, device="meta")
    g = torch.zeros(2, 2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        conv_cuda.conv_gradw(x, g, 8, 4)
    t = torch.zeros(5, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        vtrace_cuda.vtrace_fused(t, t, t, t, torch.zeros(2))


def test_every_c_entry_point_has_a_signature():
    """Each extern "C" function of csrc/*.cu (vtrace.cu's sat_vtrace
    included) is declared in _build._SIGNATURES, and nothing else is."""
    defined = set()
    for source in sorted((PACKAGE / "csrc").glob("*.cu")):
        text = source.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"',
                                text, re.S):
            defined |= set(re.findall(r"^\S.*?\b(sat_\w+)\(", block,
                                      re.M))
    assert "sat_vtrace" in defined
    assert defined == set(_build._SIGNATURES)


def test_flag_lists_cover_the_jax_config():
    jax_fields = {f.name for f in dataclasses.fields(jax_config.Config)}
    ours = {f.name for f in dataclasses.fields(Config)} - {"device"}
    assert ours.isdisjoint(UNPORTED_FLAGS)
    assert ours | set(UNPORTED_FLAGS) == jax_fields
    for f in dataclasses.fields(Config):
        if f.name in jax_fields:
            assert f.default == getattr(jax_config.Config(), f.name), f.name


@pytest.mark.parametrize("argv", [["--mesh_data=2"],
                                  ["--health_baseline_dir", "auto"],
                                  ["--chaos_channel=true"],
                                  ["--train_backend=ingraph"],
                                  ["--compute_dtype=float16"],
                                  ["--scan_impl=time_sharded"],
                                  ["--inference_mode=service"],
                                  ["--sentinel_interval=5"]])
def test_unported_flags_and_values_raise(argv):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        Config.from_argv(argv)


def test_actor_flags_are_ported_and_a_bad_actor_raises():
    """``--actor`` and ``--service_max_batch`` left the unported flags; an
    ``--actor`` outside grouped | service raises the JAX driver's error,
    from the flag and from ``Config``."""
    assert {"actor", "service_max_batch"}.isdisjoint(UNPORTED_FLAGS)
    assert SUPPORTED_VALUES["actor"] == ("grouped", "service")
    for make in (lambda: Config.from_argv(["--actor=batched"]),
                 lambda: Config(actor="batched")):
        with pytest.raises(ValueError,
                           match=r"unknown actor 'batched' \(grouped \| "
                                 r"service\)"):
            make()


def test_dataset_path_and_renderer_are_ported():
    """The DMLab flags parse, with the JAX defaults, and are no longer in
    ``UNPORTED_FLAGS``."""
    assert {"dataset_path", "renderer"}.isdisjoint(UNPORTED_FLAGS)
    config = Config.from_argv(["--dataset_path=/data/brady",
                               "--renderer=hardware"])
    assert (config.dataset_path, config.renderer) == ("/data/brady",
                                                      "hardware")
    assert (Config().dataset_path, Config().renderer) == (
        jax_config.Config().dataset_path, jax_config.Config().renderer)


def test_benchmark_mode_and_rmsprop_momentum_parse():
    """Both are ported: they parse, and every flag still unported raises
    with its pointer to ROADMAP.md."""
    assert Config.from_argv(["--benchmark_mode=true"]).benchmark_mode
    assert Config.from_argv(
        ["--rmsprop_momentum=0.9"]).rmsprop_momentum == 0.9
    assert "benchmark_mode" not in UNPORTED_FLAGS
    assert "rmsprop_momentum" not in SUPPORTED_VALUES
    for flag in UNPORTED_FLAGS:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            Config.from_argv([f"--{flag}=1"])


def test_obs_ports_the_jax_producers_only():
    """obs/ holds copies of the JAX producers, of the run-health plane
    with the two modules it stands on, and of the four CLIs that read a
    logdir (each checked above for imports); --metrics_http_port is
    ported with them.  The sentinel and the rounds CLI, and the
    sentinel's flags, stay unported and raise."""
    ported = {p.stem for p in (PACKAGE / "obs").glob("*.py")}
    assert ported == {"__init__", "registry", "exporters", "flightrec",
                      "trace", "stall", "watchdog", "ledger",
                      "device_telemetry", "learning", "kernels", "health",
                      *OBS_CLIS}
    jax_obs = ROOT / "scalable_agent_tpu" / "obs"
    assert ported <= {p.stem for p in jax_obs.glob("*.py")}
    health_flags = {f.name for f in dataclasses.fields(Config)
                    if f.name.startswith("health")}
    assert len(health_flags) == 9 and health_flags.isdisjoint(
        UNPORTED_FLAGS)
    assert "metrics_http_port" not in UNPORTED_FLAGS
    assert Config.from_argv(["--metrics_http_port=1"]).metrics_http_port \
        == 1
    for flag in ("sentinel_interval", "sentinel_rtol"):
        assert flag in UNPORTED_FLAGS
        with pytest.raises(ValueError, match="ROADMAP.md"):
            Config.from_argv([f"--{flag}=1"])


def test_unknown_flags_still_fail():
    with pytest.raises(SystemExit):
        Config.from_argv(["--no_such_flag=1"])


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    source = tmp_path / "k.cu"
    source.write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    source.write_text("// two\n")
    assert _build.library_path() != first


@pytest.mark.parametrize("argv,field,value", [
    (["--scan_impl=pallas"], "scan_impl", "pallas"),
    (["--mode=test"], "mode", "test"),
    (["--logdir=/x"], "logdir", "/x"),
    (["--num_env_workers_per_group=2"], "num_env_workers_per_group", 2),
    (["--checkpoint_keep=2"], "checkpoint_keep", 2),
    (["--actor_max_restarts=0"], "actor_max_restarts", 0),
    (["--transport=per_leaf"], "transport", "per_leaf"),
    (["--inflight_updates=1"], "inflight_updates", 1),
    (["--nonfinite_tolerance=3"], "nonfinite_tolerance", 3),
    (["--no_rollback=true"], "no_rollback", True),
    (["--preemption_grace_s=0"], "preemption_grace_s", 0.0),
    (["--chaos_spec=nan_grad@3:4"], "chaos_spec", "nan_grad@3:4"),
    (["--remat_torso=on"], "remat_torso", "on"),
    (["--fused_forward=false"], "fused_forward", False),
    (["--trace=true"], "trace", True),
    (["--profile_dir=/p"], "profile_dir", "/p"),
    (["--profile_start_update=2"], "profile_start_update", 2),
    (["--profile_num_updates=3"], "profile_num_updates", 3),
    (["--watchdog_timeout_s=0.5"], "watchdog_timeout_s", 0.5),
    (["--watchdog_abort=true"], "watchdog_abort", True),
    (["--metrics_http_port=9417"], "metrics_http_port", 9417),
    (["--learn_telemetry=false"], "learn_telemetry", False),
    (["--health=false"], "health", False),
    (["--health_warmup_intervals=3"], "health_warmup_intervals", 3),
    (["--health_ewma_alpha=0.5"], "health_ewma_alpha", 0.5),
    (["--health_z_threshold=6"], "health_z_threshold", 6.0),
    (["--health_rel_threshold=0.4"], "health_rel_threshold", 0.4),
    (["--health_cooldown_s=30"], "health_cooldown_s", 30.0),
    (["--health_max_windows=0"], "health_max_windows", 0),
    (["--health_window_updates=2"], "health_window_updates", 2),
    (["--health_baseline_dir="], "health_baseline_dir", ""),
    (["--actor=service"], "actor", "service"),
    (["--actor=grouped"], "actor", "grouped"),
    (["--service_max_batch=16"], "service_max_batch", 16)])
def test_flags_ported_for_the_pool_path(argv, field, value):
    assert getattr(Config.from_argv(argv), field) == value


def test_config_save_load_round_trip(tmp_path):
    config = Config(logdir=str(tmp_path), scan_impl="pallas", seed=7)
    path = config.save()
    assert path == str(tmp_path / "config.json")
    assert Config.load(path) == config
