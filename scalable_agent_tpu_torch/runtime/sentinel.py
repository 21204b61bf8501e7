"""The numerics sentinel: a defense against silent corruption of the hot
route, the counterpart of ``scalable_agent_tpu/runtime/sentinel.py``.

The hot route is hand-written kernels at bf16 (the residual LSTM forward,
the BPTT and the stem's grad-W on ``mma.sync``) and the fused
single-forward loss.  The non-finite guard (``runtime/learner.py``) catches
loud wrongness; nothing else would catch a kernel that is silently off by
2x, bf16 drift past its envelope, or a flipped bit in the parameters.
The sentinel's three arms, as in the JAX package:

1. **Shadow audits.**  Every ``--sentinel_interval`` updates the driver
   snapshots the learner before the update (``snapshot``), runs the hot
   update, then hands the snapshot and the batch to ``audit``.  The audit
   takes the batch's gradients at the snapshot's parameters through the
   hot learner and through the *reference* learner (every ``LADDER`` rung
   applied: the library stem, whose weight gradient is cuDNN's, the
   float32 kernels, the two-pass loss), each through
   ``torch.func.functional_call`` so the live module is left as it is,
   and the reference RMSProp step from the snapshot's optimizer state.
   It compares them leaf by leaf, over the flax leaves of the JAX package
   (``convert.flax_leaf_views``), by the L2-relative deviation
   ``||hot - ref|| / (||ref|| + 1e-6)`` in float32 (a non-finite one reads
   0: NaN batches are the non-finite guard's), against
   ``--sentinel_rtol``.  The delta arm counts only when the hot update
   was applied (a skipped update moves nothing).  Everything stays on the
   card but one host read of a bool per audit (and of the deviation on a
   breach); the counts and the last deviation go to ``devtel/sentinel/*``.
2. **Param fingerprints.**  A uint32 wrap-around sum of the float32 bits
   of every parameter (the int32 views summed in int64, then masked),
   published as ``sentinel/param_fingerprint`` every 8 updates.
   ``check_fingerprints`` compares processes' fingerprints; the driver
   has one process until the multi-process fleet is ported.
3. **The degradation ladder.**  On a breach the sentinel demotes the hot
   route one rung (``conv_backend`` to ``xla``, then the float32 policy,
   then the two-pass loss), rebuilding the agent and the learner through
   the driver's factories, loading the hot learner's state into them and
   handing its device telemetry on;
   the driver adopts them (``consume_swap``), republishes the weights to
   the actors (whose private agents take the new dtype policy with them)
   and flushes the replay slab.  A breach past the last rung asks for a
   rollback to the newest verified checkpoint; a breach after that
   rollback exits ``SENTINEL_EXIT_CODE`` (73).

With ``--sentinel_interval=0`` (the default) the driver builds none of
this and the update is unchanged.

Chaos points (``runtime/faults.py``): ``param_bitflip`` flips bit 20 of
the largest-magnitude parameter right after an audited update (the delta
arm reads it; whether past rtol depends on the leaf's size, below),
``kernel_miscompute`` scales the audited hot
gradients by 2 at rung 0 (the gradient arm reads exactly 1.0; rung 1
clears it), ``replica_diverge`` XORs a constant into the fingerprint.
"""

import dataclasses
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch.convert import flax_leaf_views
from scalable_agent_tpu_torch.obs import get_flight_recorder, get_registry
from scalable_agent_tpu_torch.obs.device_telemetry import (
    DeviceTelemetry,
    TelemetryPublisher,
    fetch_merged,
    merge_init,
)
from scalable_agent_tpu_torch.runtime.exit_codes import SENTINEL_EXIT_CODE
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector
from scalable_agent_tpu_torch.runtime.learner import rmsprop_step

log = logging.getLogger("scalable_agent_tpu_torch")

# The degradation ladder, least drastic first, as in the JAX package.
# Rung r applies the union of the first r entries; the reference route
# is the union of all three.
LADDER = (
    {"conv_backend": "xla"},
    {"compute_dtype": "float32", "core_matmul_dtype": "float32"},
    {"fused_forward": False},
)

# XOR'd into the fingerprint by the ``replica_diverge`` point.
_DIVERGE_MASK = 0xDEADBEEF
# The float32 mantissa bit ``param_bitflip`` flips (2**-3 relative).
FLIP_BIT = 20
# Updates between fingerprints (the JAX decision-broadcast cadence).
FINGERPRINT_EVERY = 8


def sentinel_telemetry_spec() -> DeviceTelemetry:
    """Device-side sentinel telemetry: audits, breaches and the last
    audit's max relative deviation (watch it approach ``--sentinel_rtol``
    before a trip)."""
    return (
        DeviceTelemetry("sentinel")
        .counter("audits", "shadow audits run on device")
        .counter("breaches", "audits whose max deviation exceeded rtol")
        .gauge("max_deviation",
               "last audit's max relative grad/delta deviation")
    )


def _reference_config(config):
    """The run configuration with every ladder rung applied: the library
    stem, float32 compute, the two-pass loss."""
    overrides = {}
    for rung in LADDER:
        overrides.update(rung)
    return dataclasses.replace(config, **overrides)


def check_fingerprints(fingerprints) -> bool:
    """True when the processes' fingerprints disagree (silent corruption
    or a divergent replica)."""
    return len({int(f) for f in np.asarray(fingerprints).ravel()}) > 1


def param_fingerprint(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The uint32 wrap-around sum of the float32 bits of ``params``, as a
    0-d int64 tensor on their device (the JAX checksum: the sum is the
    same in any leaf order and layout)."""
    total = torch.stack([
        p.detach().float().reshape(-1).view(torch.int32).sum(
            dtype=torch.int64) for p in params.values()]).sum()
    return total & 0xFFFFFFFF


@torch.no_grad()
def flip_largest_bit(params: Dict[str, torch.Tensor]) -> None:
    """Flip ``FLIP_BIT`` of the largest-magnitude element of ``params``,
    in place: the first one in the JAX package's leaf order (nonzero, so
    never a zero bias turned denormal; far inside overflow).  No host
    read."""
    views = [view for _, view in flax_leaf_views(params)]
    flat = torch.cat([v.reshape(-1).float() for v in views])
    index = torch.argmax(flat.abs()).reshape(1)
    bits = flat.view(torch.int32)
    bits.index_put_((index,), bits[index] ^ (1 << FLIP_BIT))
    offset = 0
    for view in views:
        view.copy_(flat[offset:offset + view.numel()].reshape(view.shape))
        offset += view.numel()


def leaf_deviations(hot: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[flax leaves] L2-relative deviation of ``hot`` from ``ref`` (trees
    by parameter name) per flax leaf, float32; a non-finite one reads 0.

    The norm, not the largest element: one near-cancelled element can be
    far off in clean bf16 while its leaf agrees; the faults this arm is
    for move the whole leaf (a 2x-scaled kernel reads exactly 1.0) or one
    large element.  A flipped element reads against its leaf's step norm:
    an RMSProp step is at most 10 lr an element, so a flip of c reads at
    least c / (10 lr sqrt(n)) less the clean reading, which a 256x256 gate
    kernel's step can keep under rtol (PERF.md, section 6)."""
    h = [v.float() for _, v in flax_leaf_views(hot)]
    r = [v.float() for _, v in flax_leaf_views(ref)]
    num = torch.stack(torch._foreach_norm(torch._foreach_sub(h, r)))
    dev = num / (torch.stack(torch._foreach_norm(r)) + 1e-6)
    return torch.where(torch.isfinite(dev), dev, torch.zeros_like(dev))


class Snapshot(NamedTuple):
    """The learner before an audited update: copies of its parameters,
    RMSProp ``nu``, momentum trace and IMPACT target network (each by
    parameter name, None where the run keeps none) and its frame count."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, torch.Tensor]
    momentum: Optional[Dict[str, torch.Tensor]]
    target_params: Optional[Dict[str, torch.Tensor]]
    env_frames: float


class _LossCall(torch.nn.Module):
    """A learner's loss as a module over the learner's agent, so that
    ``torch.func.functional_call`` runs it at other parameters."""

    def __init__(self, learner):
        super().__init__()
        self.agent = learner._agent
        self.learner = learner

    def forward(self, trajectory, target_params):
        return self.learner.loss(trajectory, target_params)


def _gradients(learner, snap: Snapshot, trajectory
               ) -> Dict[str, torch.Tensor]:
    """``learner``'s gradients of ``trajectory``'s loss at the snapshot's
    parameters (and target network), the live module untouched."""
    leaves = {name: p.detach().requires_grad_()
              for name, p in snap.params.items()}
    total, _ = torch.func.functional_call(
        _LossCall(learner),
        {"agent." + name: p for name, p in leaves.items()},
        (trajectory, snap.target_params))
    grads = torch.autograd.grad(total, list(leaves.values()))
    return dict(zip(leaves, grads))


class NumericsSentinel:
    """Shadow audits, fingerprints and the degradation ladder.

    ``rebuild(config) -> (agent, learner)`` is the driver's factory; the
    sentinel calls it once (at the first audit) for the reference learner
    and once per demotion for the new hot pair, into which it loads the
    hot learner's state.  The driver polls ``consume_swap`` after each
    audit and, when it is True, adopts ``learner`` and ``agent``,
    republishes the weights and flushes the replay slab.
    """

    def __init__(self, config, agent, learner,
                 rebuild: Callable[[Any], Tuple[Any, Any]],
                 registry=None):
        if config.sentinel_interval <= 0:
            raise ValueError(
                "NumericsSentinel requires --sentinel_interval > 0; "
                "the driver must not construct it for sentinel-off runs")
        registry = registry or get_registry()
        self._base_config = config
        self._rebuild = rebuild
        self._hot_agent = agent
        self._hot = learner
        self._interval = int(config.sentinel_interval)
        self._rtol = float(config.sentinel_rtol)
        self._ref = None  # built at the first audit
        self._rung = 0
        self._swapped = False  # one-shot: the driver consumes it
        self._rolled_back = False  # a sentinel rollback already spent
        self.rollback_pending = False
        # The last audit's per-leaf deviations on the card (grad, delta),
        # flax leaf paths in ``leaf_names``: read only by diagnostics.
        self.last_deviations: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
        self.leaf_names: List[str] = []

        self._spec = sentinel_telemetry_spec()
        device = next(agent.parameters()).device
        self._devtel = merge_init([self._spec], device)
        self._publisher = TelemetryPublisher([self._spec],
                                             registry=registry)
        self._c_trips = registry.counter(
            "sentinel/trips_total",
            "sentinel breaches (audit or fingerprint mismatch)")
        self._c_demotions = registry.counter(
            "sentinel/demotions_total",
            "degradation-ladder rungs taken (rebuilds of the hot route)")
        self._c_fp_mismatch = registry.counter(
            "sentinel/fingerprint_mismatch_total",
            "cross-process param-fingerprint disagreements")
        self._g_rung = registry.gauge(
            "sentinel/rung",
            "current degradation-ladder rung (0 = full hot route)")
        self._g_fingerprint = registry.gauge(
            "sentinel/param_fingerprint",
            "this process's uint32 param-tree checksum")
        self._g_rung.set(0)

    # -- what the driver wires against -------------------------------------

    @property
    def learner(self):
        """The current hot learner (another one after a demotion)."""
        return self._hot

    @property
    def agent(self):
        """The agent of ``learner``."""
        return self._hot_agent

    @property
    def rung(self) -> int:
        return self._rung

    def audit_due(self, updates: int) -> bool:
        """True when the update about to run (0-based count) is audited:
        the driver snapshots the learner before it."""
        return (updates + 1) % self._interval == 0

    def consume_swap(self) -> bool:
        """True exactly once after a demotion."""
        swapped, self._swapped = self._swapped, False
        return swapped

    def note_rollback(self):
        """The driver finished a sentinel rollback: the next breach that
        survives the ladder exits 73 instead of rolling back again."""
        self.rollback_pending = False
        self._rolled_back = True

    # -- the shadow audit --------------------------------------------------

    def snapshot(self) -> Snapshot:
        """Copies of the hot learner's state, queued on the current stream
        before the update that changes it."""
        saved = self._hot.state_dict()
        copy = lambda group: None if group is None else {
            name: t.detach().clone() for name, t in group.items()}
        return Snapshot(params=copy(saved["params"]),
                        opt_state=copy(saved["opt_state"]),
                        momentum=copy(saved.get("momentum")),
                        target_params=copy(saved.get("target_params")),
                        env_frames=float(saved["env_frames"]))

    def _ensure_ref(self):
        if self._ref is None:
            _, self._ref = self._rebuild(
                _reference_config(self._base_config))
        return self._ref

    def _deviations(self, snap: Snapshot, trajectory, miscompute: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gradient arm, delta arm) per flax leaf."""
        hot_grads = _gradients(self._hot, snap, trajectory)
        if miscompute:
            hot_grads = {name: g * 2.0 for name, g in hot_grads.items()}
        ref = self._ensure_ref()
        ref_grads = _gradients(ref, snap, trajectory)
        grad_dev = leaf_deviations(hot_grads, ref_grads)
        with torch.no_grad():
            # The reference step from the snapshot's optimizer state, at
            # the snapshot's decayed lr.
            hp = ref._hp
            lr = hp.learning_rate * max(
                0.0, 1.0 - snap.env_frames / hp.total_environment_frames)
            live = self._hot.state_dict()["params"]
            hot_delta, ref_delta = {}, {}
            for name, before in snap.params.items():
                trace = (None if snap.momentum is None
                         else snap.momentum[name])
                step, _, _ = rmsprop_step(ref_grads[name],
                                          snap.opt_state[name], trace, lr,
                                          hp)
                hot_delta[name] = live[name].float() - before
                ref_delta[name] = (before + step) - before
            # A skipped hot update (the non-finite guard) moved nothing:
            # a zero delta against the reference's is the guard at work.
            applied = torch.stack([d.ne(0).any()
                                   for d in hot_delta.values()]).any()
            delta_dev = leaf_deviations(hot_delta, ref_delta) * applied
        return grad_dev, delta_dev

    def audit(self, snap: Snapshot, trajectory, updates: int) -> None:
        """One shadow audit of the update just issued from ``snap``.  The
        chaos points may corrupt the live parameters first; a breach may
        demote the ladder, set ``rollback_pending`` or exit 73."""
        injector = get_fault_injector()
        miscompute = False
        if injector.active:
            # The miscomputing-kernel stand-in exists only while the
            # suspect kernels are on the hot route (rung 0): the first
            # demotion replaces them, so later audits run clean.
            if self._rung == 0 and injector.should_fire(
                    "kernel_miscompute"):
                miscompute = True
            if injector.should_fire("param_bitflip"):
                flip_largest_bit(self._hot.state_dict()["params"])
        grad_dev, delta_dev = self._deviations(snap, trajectory, miscompute)
        if not self.leaf_names:
            self.leaf_names = [path for path, _ in
                               flax_leaf_views(snap.params)]
        self.last_deviations = (grad_dev, delta_dev)
        max_dev = torch.maximum(grad_dev.max(), delta_dev.max())
        breach = max_dev > self._rtol
        spec, tel = self._spec, self._devtel
        spec.inc(tel, "audits")
        spec.inc(tel, "breaches", breach.float())
        spec.set(tel, "max_deviation", max_dev)
        # The audit's one host read: a bool (and, on a breach, one more:
        # the deviation with its arm and leaf).
        if bool(breach):
            grad_max, delta_max, grad_at, delta_at = torch.stack([
                grad_dev.max(), delta_dev.max(),
                grad_dev.argmax().float(),
                delta_dev.argmax().float()]).tolist()
            arm, dev, at = (("grad", grad_max, grad_at)
                            if grad_max >= delta_max
                            else ("delta", delta_max, delta_at))
            self._on_breach(dev, updates,
                            f"{arm} arm, {self.leaf_names[int(at)]}")

    def _on_breach(self, max_dev: float, updates: int, where: str = ""):
        recorder = get_flight_recorder()
        self._c_trips.inc()
        recorder.record("sentinel_trip", "audit", {
            "rung": self._rung, "max_deviation": max_dev,
            "update": updates, "where": where})
        if recorder.reason_pin is None:
            recorder.reason_pin = "sentinel_trip:audit"
        if self._rung < len(LADDER):
            self._demote(max_dev, updates, where)
        elif not self._rolled_back:
            log.error(
                "sentinel: breach (max_dev=%.3g) survived the full "
                "degradation ladder at update %d — rolling back to the "
                "newest verified checkpoint", max_dev, updates)
            self.rollback_pending = True
        else:
            recorder.record("sentinel_trip", "exhausted", {
                "max_deviation": max_dev, "update": updates})
            recorder.dump_all("sentinel:exhausted")
            log.error(
                "sentinel: breach persists after full demotion AND a "
                "rollback — the reference route cannot be reproduced on "
                "this hardware; exiting %d", SENTINEL_EXIT_CODE)
            raise SystemExit(SENTINEL_EXIT_CODE)

    def _demote(self, max_dev: float, updates: int, where: str = ""):
        self._rung += 1
        overrides = {}
        for rung_overrides in LADDER[:self._rung]:
            overrides.update(rung_overrides)
        demoted = dataclasses.replace(self._base_config, **overrides)
        agent, learner = self._rebuild(demoted)
        learner.load_state_dict(self._hot.state_dict())
        learner.adopt_device_telemetry(self._hot)
        self._hot_agent, self._hot = agent, learner
        self._swapped = True
        self._c_demotions.inc()
        self._g_rung.set(self._rung)
        get_flight_recorder().record("sentinel_trip", "demote", {
            "rung": self._rung, "overrides": dict(overrides)})
        log.warning(
            "sentinel: audit breach (max_dev=%.3g > rtol=%.3g; %s) at "
            "update %d — demoting to rung %d (%s)",
            max_dev, self._rtol, where, updates, self._rung,
            ", ".join(f"{k}={v}" for k, v in overrides.items()))

    # -- fingerprints ------------------------------------------------------

    def local_fingerprint(self, params: Dict[str, torch.Tensor]) -> int:
        """This process's fingerprint of ``params`` (one small host read),
        published as ``sentinel/param_fingerprint``."""
        fp = int(param_fingerprint(params))
        injector = get_fault_injector()
        if injector.active and injector.should_fire("replica_diverge"):
            fp ^= _DIVERGE_MASK
        self._g_fingerprint.set(fp)
        return fp

    def check_fingerprints(self, fingerprints) -> bool:
        """``check_fingerprints`` over the gathered fingerprints, counted
        and recorded on a mismatch, as in the JAX package."""
        if not check_fingerprints(fingerprints):
            return False
        distinct = sorted({int(f) for f in np.asarray(fingerprints).ravel()})
        self._c_fp_mismatch.inc()
        self._c_trips.inc()
        recorder = get_flight_recorder()
        recorder.record("sentinel_trip", "fingerprint",
                        {"fingerprints": distinct})
        if recorder.reason_pin is None:
            recorder.reason_pin = "sentinel_trip:fingerprint"
        log.error("sentinel: param fingerprints disagree across processes "
                  "(%s) — a replica diverged; rolling back", distinct)
        return True

    # -- telemetry ---------------------------------------------------------

    def publish(self):
        """Fetch and publish the device telemetry (the driver's log
        cadence and the end of the run)."""
        fetched = fetch_merged([self._spec], self._devtel)
        self._publisher.publish(fetched)
        return fetched
