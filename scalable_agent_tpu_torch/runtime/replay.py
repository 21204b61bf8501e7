"""Trajectory replay on the card: the off-policy dial.

The counterpart of ``scalable_agent_tpu/runtime/replay.py``'s
``DeviceReplayBuffer`` on one card.  ``--replay_ratio=R`` runs R updates on
replayed batches behind every fresh one; the IMPACT surrogate
(``ops/impact.py``) tolerates their age.

- **The slabs**: one ``[capacity, *leaf_shape]`` tensor per leaf of the
  stored tree, made at the first insert.  The driver stores the packed
  transport's uploaded buffer (``PackedTransport.set_upload_sink``): one
  ``[1, shard_nbytes]`` uint8 leaf, so the slab is ``capacity`` rows of
  that buffer's bytes and a slot write is a copy on the card of bytes
  that already crossed the link.  ``postprocess`` (the transport's
  ``unpack``) turns a sampled buffer into the Trajectory the learner
  takes.  ``replay_ratio=0`` builds no buffer at all (``driver.
  build_replay``).
- **The ring**: its cursor, fill and sample counter are int64 tensors on
  the slabs' device, advanced by in-place ops.  Host mirrors advance with
  the same +1 arithmetic; they fund the ``replay/occupancy`` gauge, the
  ``size`` the driver gates sampling on, and the staleness mirror.
  Neither ``insert`` nor ``sample`` reads a device value on the host.
- **The slot draw** is the JAX package's, bit for bit: ``randint(
  fold_in(key(seed), counter), (), 0, max(filled, 1))`` under the default
  threefry2x32 key and ``jax_threefry_partitionable`` (``slot_index``),
  written as integer ops over int64 tensors masked to 32 bits.  On the
  card it runs on the device's counter and fill; on the CPU the same
  function over the host mirrors gives the same slot, whose birth stamp
  feeds ``ledger/staleness_replayed_s``.
- **Two streams**: inserts run on the prefetch thread's stream (the one
  that uploaded the buffer), samples on the update's.  One lock
  serialises their dispatch.  A sample waits on the event after the last
  insert, and an insert waits on the event after the last sample, so a
  gather still in flight is never overwritten.  ``sample`` returns a copy
  (``index_select`` at the device slot), never a view of the slab; the
  unpacked leaves are views of that copy.  Every tensor one stream
  dispatched and the other uses gets ``record_stream``.
- **flush** empties the ring (the rollback: a restored timeline must not
  train on the abandoned one's batches) and keeps the counter running.

Metrics, as in the JAX buffer: ``replay/insert_total``,
``replay/sampled_total``, ``replay/rollback_flushes_total``,
``replay/occupancy``, the ``replay/insert_s`` and ``replay/sample_s``
dispatch histograms, the ledger's ``replay_insert`` and ``replay_sample``
service stages and ``ledger/staleness_replayed_s``.  The
``replay_corrupt`` fault point makes a sampled batch's rewards NaN.
Buffer contents are not checkpointed: a restored run refills the ring
from its first fresh batches.
"""

import threading
import time
import weakref
from typing import Any, Callable, List, Optional

import torch

from scalable_agent_tpu_torch.obs import get_ledger, get_registry
from scalable_agent_tpu_torch.obs.ledger import now_us
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector
from scalable_agent_tpu_torch.runtime.transport import (
    tree_leaves,
    tree_unflatten,
)
from scalable_agent_tpu_torch.types import map_structure

__all__ = ["DeviceReplayBuffer", "slot_index"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, JAX's ``threefry2x32_p``, over
    int64 tensors holding uint32 values."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def slot_index(seed: int, counter: torch.Tensor,
               filled: torch.Tensor) -> torch.Tensor:
    """The replay slot draw of the JAX package (``replay._slot_index``):
    uniform over ``[0, max(filled, 1))`` keyed on ``fold_in(key(seed),
    counter)``, with ``counter`` and ``filled`` int64 tensors (0-d, on any
    device); returns an int64 0-d tensor on their device.  The key is
    ``(0, seed & 0xffffffff)`` (a 32-bit seed), ``fold_in`` hashes the
    count ``(0, counter)`` under it, ``randint`` splits the folded key
    into two by hashing the counts ``(0, 0)`` and ``(0, 1)``, draws 32
    bits from each (the two words of the hash of ``(0, 0)`` xor'ed, the
    partitionable layout) and reduces the pair modulo the span as JAX
    does: ``(hi % span * (2**32 % span) + lo % span) % span``."""
    zero = torch.zeros_like(counter)
    k0, k1 = _threefry2x32(zero, zero + (int(seed) & _MASK), zero,
                           counter & _MASK)
    # The split's two keys, then one 32-bit draw under each: two lanes.
    lanes = torch.arange(2, dtype=torch.int64, device=counter.device)
    k0, k1 = _threefry2x32(k0, k1, lanes * 0, lanes)
    bits0, bits1 = _threefry2x32(k0, k1, lanes * 0, lanes * 0)
    higher, lower = bits0 ^ bits1
    span = torch.clamp(filled, min=1)
    multiplier = 65536 % span
    multiplier = (multiplier * multiplier & _MASK) % span
    offset = ((higher % span) * multiplier + lower % span) & _MASK
    return offset % span


class DeviceReplayBuffer:
    """A ring of ``capacity`` stored trees on the card (one learner batch
    each).  ``postprocess`` maps a sampled tree to what the learner takes
    (the packed transport's ``unpack``; None returns the tree)."""

    def __init__(self, capacity: int, seed: int = 0,
                 postprocess: Optional[Callable[[Any], Any]] = None,
                 registry=None):
        if capacity < 1:
            raise ValueError(
                f"replay capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._seed = int(seed)
        self._postprocess = postprocess
        self._lock = threading.Lock()
        # Built from the first inserted tree.
        self._slabs: Optional[List[Optional[torch.Tensor]]] = None
        self._template = None
        self._cursor = self._filled = self._counter = None
        # The CUDA events after the last insert and the last sample.
        self._inserted: Optional[torch.cuda.Event] = None
        self._sampled: Optional[torch.cuda.Event] = None
        # Host mirrors of the ring state, advanced as the device's is.
        self._host_filled = 0
        self._host_cursor = 0
        self._host_counter = 0
        self._slot_birth_us: List[int] = [0] * self.capacity
        registry = registry or get_registry()
        self._c_inserts = registry.counter(
            "replay/insert_total",
            "trajectory batches inserted into the device replay slab")
        self._c_samples = registry.counter(
            "replay/sampled_total",
            "trajectory batches sampled from the device replay slab")
        self._c_flushes = registry.counter(
            "replay/rollback_flushes_total",
            "slab flushes dropping an abandoned timeline's trajectories "
            "(rollback or sentinel demotion)")
        self_ref = weakref.ref(self)
        registry.gauge(
            "replay/occupancy",
            "filled fraction of the device replay slab",
            fn=lambda: ((buf._host_filled / buf.capacity)
                        if (buf := self_ref()) is not None else 0.0))
        self._h_insert = registry.histogram(
            "replay/insert_s",
            "host dispatch seconds of the jitted slab insert")
        self._h_sample = registry.histogram(
            "replay/sample_s",
            "host dispatch seconds of the jitted slab sample (+unpack)")

    # -- introspection -----------------------------------------------------

    @property
    def size(self) -> int:
        """Valid slots (the host mirror: exact, inserts are dispatched by
        the host)."""
        return self._host_filled

    @property
    def nbytes(self) -> int:
        """The slabs' bytes on the card (0 before the first insert)."""
        return sum(slab.numel() * slab.element_size()
                   for slab in self._slabs or () if slab is not None)

    def flush(self) -> None:
        """Empty the ring without freeing the slabs: every stored batch
        becomes unreachable.  The sample counter keeps running, so the
        draws after a flush are new ones."""
        with self._lock:
            if self._slabs is not None:
                stream = self._wait(self._inserted, self._sampled)
                self._cursor.zero_()
                self._filled.zero_()
                event = self._record(stream)
                self._inserted = self._sampled = event
            self._host_cursor = 0
            self._host_filled = 0
            self._slot_birth_us = [0] * self.capacity
        self._c_flushes.inc()

    # -- streams -----------------------------------------------------------

    def _device(self) -> torch.device:
        return self._cursor.device

    def _wait(self, *events) -> Optional[torch.cuda.Stream]:
        """The current stream of the slabs' device, made to wait on
        ``events``, and every tensor of the ring marked as used on it; None
        off the card."""
        if self._device().type != "cuda":
            return None
        stream = torch.cuda.current_stream(self._device())
        for event in events:
            if event is not None:
                stream.wait_event(event)
        for tensor in self._ring_tensors():
            tensor.record_stream(stream)
        return stream

    @staticmethod
    def _record(stream) -> Optional[torch.cuda.Event]:
        if stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def _ring_tensors(self):
        return [t for t in self._slabs if t is not None] + [
            self._cursor, self._filled, self._counter]

    def _ensure(self, tree) -> None:
        if self._slabs is not None:
            return
        leaves = tree_leaves(tree)
        present = [leaf for leaf in leaves if leaf is not None]
        if not present:
            raise ValueError("a replay tree needs at least one tensor")
        device = present[0].device
        self._slabs = [
            None if leaf is None else torch.zeros(
                (self.capacity,) + tuple(leaf.shape), dtype=leaf.dtype,
                device=device)
            for leaf in leaves]
        self._template = map_structure(
            lambda leaf: None if leaf is None else 0, tree)
        zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
        self._cursor, self._filled, self._counter = zero(), zero(), zero()

    # -- the two operations ------------------------------------------------

    def insert(self, tree, birth_us: Optional[int] = None) -> None:
        """Store one tree of tensors on the card (a packed upload buffer,
        or a Trajectory) in the next ring slot, on the current stream.
        ``birth_us`` is the batch's unroll-birth stamp (ledger clock), for
        its age when sampled; now by default."""
        t0 = time.perf_counter()
        with self._lock:
            self._ensure(tree)
            if map_structure(lambda leaf: None if leaf is None else 0,
                             tree) != self._template:
                raise ValueError(
                    "inserted tree structure does not match the replay "
                    "slab layout")
            stream = self._wait(self._sampled)
            index = self._cursor.reshape(1)
            for slab, leaf in zip(self._slabs, tree_leaves(tree)):
                if slab is not None:
                    slab.index_copy_(0, index, leaf.unsqueeze(0))
            self._cursor.add_(1).remainder_(self.capacity)
            self._filled.add_(1).clamp_(max=self.capacity)
            self._inserted = self._record(stream)
            self._slot_birth_us[self._host_cursor] = (
                int(birth_us) if birth_us is not None else now_us())
            self._host_cursor = (self._host_cursor + 1) % self.capacity
            self._host_filled = min(self._host_filled + 1, self.capacity)
        dt = time.perf_counter() - t0
        self._c_inserts.inc()
        self._h_insert.observe(dt)
        get_ledger().note_service("replay_insert", 1, dt)

    def sample(self):
        """One uniformly drawn stored tree, as a copy on the current
        stream, postprocessed: dispatch only, no host sync.  Raises on an
        empty ring (the driver inserts before it samples)."""
        t0 = time.perf_counter()
        with self._lock:
            if self._host_filled < 1:
                raise RuntimeError(
                    "replay sample from an empty buffer (insert at "
                    "least one batch first)")
            stream = self._wait(self._inserted)
            slot = slot_index(self._seed, self._counter,
                              self._filled).reshape(1)
            leaves = [None if slab is None
                      else slab.index_select(0, slot)[0]
                      for slab in self._slabs]
            self._counter.add_(1)
            self._sampled = self._record(stream)
            counter, filled = self._host_counter, self._host_filled
            self._host_counter += 1
            # The stamps as of this dispatch: an insert after the lock is
            # released must not relabel the sampled slot's age.
            births = tuple(self._slot_birth_us)
        tree = tree_unflatten(self._template, leaves)
        if self._postprocess is not None:
            tree = self._postprocess(tree)
        injector = get_fault_injector()
        if injector.active and injector.should_fire("replay_corrupt"):
            # Chaos: NaN rewards; the learner's guard must take the
            # replayed update as a skip.
            env = tree.env_outputs
            tree = tree._replace(env_outputs=env._replace(
                reward=env.reward * float("nan")))
        dt = time.perf_counter() - t0
        self._c_samples.inc()
        self._h_sample.observe(dt)
        ledger = get_ledger()
        ledger.note_service("replay_sample", 1, dt)
        slot = self.mirror_slot(counter, filled)
        ledger.observe_replay_staleness(
            max(0.0, (now_us() - births[slot]) / 1e6))
        return tree

    def mirror_slot(self, counter: int, filled: int) -> int:
        """The slot the device drew at ``counter`` with ``filled`` valid
        slots, recomputed on the CPU from the host mirrors."""
        as_cpu = lambda v: torch.tensor(int(v), dtype=torch.int64)
        return int(slot_index(self._seed, as_cpu(counter), as_cpu(filled)))
