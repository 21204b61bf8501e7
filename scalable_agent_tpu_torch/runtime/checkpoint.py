"""Checkpoint/resume with integrity verification and walk-back.

The counterpart of ``scalable_agent_tpu/runtime/checkpoint.py``'s
``CheckpointManager`` (reference: experiment.py:608-616), in the port's own
format instead of Orbax's:

- ``checkpoints/<step>.pt``: one ``torch.save`` of the learner's
  ``state_dict`` (params, RMSProp ``nu`` and, at ``rmsprop_momentum !=
  0``, the momentum trace, and under ``--loss=impact`` (or carried
  through from a restored impact step) the target network, each by
  parameter name; ``env_frames``, the non-finite counters), copied to the
  CPU first and
  read back with ``torch.load(..., weights_only=True)``.  It is written to
  a temporary name and renamed, so a crash mid-save leaves no half step.
- ``checkpoints/manifests/<step>.json``: the per-leaf integrity manifest
  with the JAX package's fields (``schema_version``, ``step``,
  ``topology``, ``leaves`` of ``{shape, dtype, crc32}``).
- Saves on a wall-clock cadence (``interval_s``, the first call saves) with
  keep-last-N rotation; a non-forced save that fails is logged and
  retried a cadence later, a forced one raises.
- ``restore()`` walks back from the newest step until one loads AND
  matches its manifest, deleting the newer bad steps once a good one is
  found; when steps exist but none verifies it raises
  ``CheckpointIntegrityError`` instead of letting the run retrain from
  scratch into the same directory.

Two fault points (``runtime/faults.py``) sit in ``maybe_save``:
``ckpt_save_fail`` raises inside the save's ``try`` (the degrade path
above), and ``ckpt_torn`` corrupts the step's file after a successful save
(a crash mid-save, for the walk-back).

Observability, as in the JAX manager: a save is the ``checkpoint/save``
span and the ``checkpoint/save_s`` histogram, counted in
``checkpoint/saves_total`` (failures in ``checkpoint/save_failures_total``,
rejected steps in ``checkpoint/restore_fallbacks_total``, the restored
step in the ``checkpoint/restored_step`` gauge), with flight-recorder
events for failures and fallbacks.  A save or a restore suspends the
calling thread's watchdog heartbeat (``heartbeat``, default the thread's
name): a slow disk is not a wedge, and the caller's next touch re-arms
it.

A step with or without the target network restores into either loss:
the manifest covers the step as saved, and ``Learner.load_state_dict``
migrates after the check (an impact run starts its target from the
restored parameters; a vtrace run carries a restored target through).

Checkpoints of the two packages are not interchangeable (ROADMAP.md,
queue 1); ``convert.state_dict_to_flax`` turns a restored ``params`` (or
``target_params``) into the JAX agent's param tree.
"""

import json
import logging
import os
import re
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch.obs import (
    get_flight_recorder,
    get_registry,
    get_tracer,
    get_watchdog,
)
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector

log = logging.getLogger("scalable_agent_tpu_torch")

_MANIFEST_SCHEMA = 1
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointIntegrityError(RuntimeError):
    """Retained checkpoint steps exist but NONE restored and verified."""


def _groups(state: Dict) -> Tuple[str, ...]:
    """The state's groups of tensors by parameter name, in a fixed order:
    the momentum trace and the IMPACT target network only where the run
    keeps them."""
    return ("params", "opt_state") + tuple(
        group for group in ("momentum", "target_params") if group in state)


def _to_host(state: Dict) -> Dict:
    """A learner ``state_dict`` as CPU copies and host floats."""
    copy = lambda t: t.detach().to("cpu", copy=True)
    host = {group: {k: copy(t) for k, t in state[group].items()}
            for group in _groups(state)}
    host.update(
        env_frames=float(state["env_frames"]),
        nonfinite_skips=copy(torch.as_tensor(state["nonfinite_skips"])),
        nonfinite_streak=copy(torch.as_tensor(state["nonfinite_streak"])))
    return host


def _leaves(host_state: Dict) -> List[np.ndarray]:
    """The state's leaves as numpy arrays, in a fixed order."""
    out = [t.numpy() for group in _groups(host_state)
           for t in host_state[group].values()]
    out.append(np.asarray(host_state["env_frames"], np.float64))
    out += [torch.as_tensor(host_state[key]).numpy()
            for key in ("nonfinite_skips", "nonfinite_streak")]
    return out


def _leaf_checksums(host_state: Dict) -> List[dict]:
    """Per-leaf (shape, dtype, crc32): the integrity manifest's body."""
    entries = []
    for leaf in _leaves(host_state):
        arr = np.ascontiguousarray(leaf)
        entries.append({"shape": list(arr.shape), "dtype": str(arr.dtype),
                        "crc32": zlib.crc32(arr.tobytes())})
    return entries


class CheckpointManager:
    """Cadenced save and verified restore under ``<logdir>/checkpoints``."""

    def __init__(self, logdir: str, interval_s: float = 600.0,
                 keep: int = 5):
        if keep < 1:
            raise ValueError(f"checkpoint_keep must be >= 1, got {keep}")
        self._dir = os.path.join(os.path.abspath(logdir), "checkpoints")
        self._manifest_dir = os.path.join(self._dir, "manifests")
        os.makedirs(self._manifest_dir, exist_ok=True)
        self._interval_s = interval_s
        self._keep = keep
        self._last_save = None  # the first maybe_save is always due
        self.save_failures = 0
        self.restore_fallbacks = 0
        registry = get_registry()
        self._saves_counter = registry.counter(
            "checkpoint/saves_total", "checkpoints written")
        self._save_hist = registry.histogram(
            "checkpoint/save_s", "state fetch + write seconds")
        self._save_failures_counter = registry.counter(
            "checkpoint/save_failures_total",
            "non-forced checkpoint saves that failed and were degraded "
            "to a logged retry-next-cadence")
        self._restore_fallbacks_counter = registry.counter(
            "checkpoint/restore_fallbacks_total",
            "retained checkpoint steps rejected during restore (torn/"
            "corrupt/unreadable) before an older step verified")
        self._restored_step_gauge = registry.gauge(
            "checkpoint/restored_step",
            "step of the last successfully verified restore (-1 = none)")
        self._restored_step_gauge.set(-1.0)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"{step}.json")

    def all_steps(self) -> List[int]:
        """Retained steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self._dir)) if m)

    def _delete(self, step: int) -> None:
        for path in (self._path(step), self._manifest_path(step)):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    def _tear_step(self, step: int) -> None:
        """Chaos (``ckpt_torn``): invert up to 256 bytes in the middle of
        the step's file, a stand-in for a crash mid-save, so that either
        ``torch.load`` raises or the manifest's crc32 catches it."""
        path = self._path(step)
        size = os.path.getsize(path)
        offset = size // 2
        span = min(256, size - offset)
        with open(path, "r+b") as f:
            f.seek(offset)
            chunk = f.read(span)
            f.seek(offset)
            f.write(bytes(b ^ 0xFF for b in chunk))
        log.warning("chaos: tore checkpoint step %d (%d bytes inverted)",
                    step, span)

    @staticmethod
    def _write_atomic(path: str, write) -> None:
        tmp = path + ".tmp"
        write(tmp)
        os.replace(tmp, path)

    # -- save ----------------------------------------------------------------

    def maybe_save(self, step: int, state: Dict, force: bool = False,
                   heartbeat: Optional[str] = None) -> bool:
        """Save ``state`` (a learner ``state_dict``) as ``step`` if the
        cadence interval elapsed or ``force``; True when it saved."""
        now = time.monotonic()
        if not (force or self._last_save is None
                or now - self._last_save >= self._interval_s):
            return False
        get_watchdog().suspend(heartbeat)
        with get_tracer().span("checkpoint/save", cat="checkpoint"), \
                self._save_hist.time():
            saved = self._save(step, state, force, now)
        if saved:
            self._saves_counter.inc()
        return saved

    def _save(self, step: int, state: Dict, force: bool,
              now: float) -> bool:
        injector = get_fault_injector()
        try:
            if injector.active:
                injector.maybe_raise("ckpt_save_fail")
            host_state = _to_host(state)
            self._write_atomic(self._path(step),
                               lambda tmp: torch.save(host_state, tmp))
            manifest = {"schema_version": _MANIFEST_SCHEMA, "step": step,
                        "topology": {"num_processes": 1, "num_devices": 1},
                        "leaves": _leaf_checksums(host_state)}

            def write_manifest(tmp):
                with open(tmp, "w") as f:
                    json.dump(manifest, f)

            self._write_atomic(self._manifest_path(step), write_manifest)
        except Exception as exc:
            if force:
                # The final save is the run's durable result.
                raise
            self.save_failures += 1
            self._save_failures_counter.inc()
            get_flight_recorder().record(
                "ckpt_save_failure", type(exc).__name__, {"step": step})
            log.error("checkpoint save at step %d failed (%s: %s); "
                      "training continues, retry next cadence", step,
                      type(exc).__name__, exc)
            self._last_save = now
            return False
        if injector.active and injector.should_fire("ckpt_torn"):
            self._tear_step(step)
        for old in self.all_steps()[:-self._keep]:
            self._delete(old)
        self._last_save = now
        return True

    # -- restore -------------------------------------------------------------

    def verify(self, step: int, host_state: Dict) -> Tuple[bool, str]:
        """Check a loaded state against the step's manifest (compared as a
        multiset of leaves, as the JAX package does)."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            return False, f"unreadable manifest: {exc}"
        key = lambda e: (tuple(e["shape"]), e["dtype"], e["crc32"])
        expected = sorted(map(key, manifest.get("leaves", [])))
        found = sorted(map(key, _leaf_checksums(host_state)))
        if len(expected) != len(found):
            return False, (f"leaf count {len(found)} != manifest "
                           f"{len(expected)}")
        if expected != found:
            bad = next((a, b) for a, b in zip(expected, found) if a != b)
            return False, (f"leaf checksum mismatch: manifest {bad[0]!r} "
                           f"vs restored {bad[1]!r}")
        return True, ""

    def _load(self, step: int) -> Dict:
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, heartbeat: Optional[str] = None
                ) -> Optional[Tuple[int, Dict]]:
        """Newest VERIFIED ``(step, state_dict on the CPU)``, or None when
        no step is retained."""
        get_watchdog().suspend(heartbeat)
        steps = self.all_steps()
        if not steps:
            return None
        rejected = []
        for step in reversed(steps):
            try:
                host_state = self._load(step)
                ok, why = self.verify(step, host_state)
            except Exception as exc:  # a torn file makes torch.load raise
                ok, why = False, f"{type(exc).__name__}: {exc}"
            if not ok:
                self.restore_fallbacks += 1
                self._restore_fallbacks_counter.inc()
                get_flight_recorder().record(
                    "ckpt_fallback", str(step), {"why": why[:200]})
                log.error("checkpoint step %d failed integrity/restore "
                          "(%s); falling back to the next older step",
                          step, why)
                rejected.append(step)
                continue
            # A proven-bad newer step would shadow every save at a step
            # <= it after the resume: drop it now that a good one exists.
            for bad in rejected:
                log.warning("deleting corrupt checkpoint step %d (newer "
                            "than the verified step %d)", bad, step)
                self._delete(bad)
            self._restored_step_gauge.set(float(step))
            return step, host_state
        raise CheckpointIntegrityError(
            f"checkpoints exist under {self._dir} but none restored and "
            f"verified; refusing to silently retrain from scratch (move or "
            f"delete the directory to start fresh)")
