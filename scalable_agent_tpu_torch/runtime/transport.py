"""Trajectory transport, host to card, and the bounded in-flight window.

The counterpart of ``scalable_agent_tpu/runtime/transport.py`` on one
card:

- ``PerLeafTransport`` (``--transport=per_leaf``) uploads every leaf of a
  host trajectory with its own ``torch.as_tensor(leaf, device=...)``.
- ``PackedTransport`` (``--transport=packed``, the default) packs every
  leaf into ONE staging buffer laid out by ``PackedSpec`` (the JAX
  layout: leaves sorted by ``(dtype.str, index)``, each at a 128-byte
  aligned offset, the buffer ``[num_shards, shard_nbytes]`` uint8 with
  ``num_shards=1`` on one card), uploads it with one ``non_blocking``
  copy into a fresh device buffer, and unpacks it on the card as views:
  slices of that buffer seen through ``Tensor.view(dtype)`` and
  ``reshape``, no copy.  The staging buffers are two pinned host buffers
  used in turn, each rewritten only after the CUDA event of the copy that
  last read it has completed.  There is no fallback: on the card the
  staging buffers are pinned or the transport raises.
- A trajectory whose leaves are already tensors (the accum actors',
  ``runtime/accum_actor.py``) passes through either transport as it is:
  no pack, no host copy, no second upload (``adopt_device_trajectory``).
  The putting stream waits on the event the actor recorded after its last
  write and ``record_stream``s every leaf.
- ``PackedTransport.set_upload_sink`` taps each uploaded buffer right
  after its copy is issued: the replay slab's insert
  (``runtime/replay.py``), whose samples ``unpack`` turns back into
  trajectories.
- ``InflightWindow`` keeps up to W updates in flight: the driver pushes
  each update's metrics with a CUDA event recorded after it, and blocks
  (``retire``) on the oldest one only when the window is full, so the
  metrics come back in update order with exact ``env_frames``.

Observability, as in the JAX transport: the packed path's
``transport/pack``, ``transport/upload`` (its byte count in ``args`` and
``transport/h2d_bytes_total``) and ``transport/unpack`` spans and
``_s`` histograms on the prefetch thread, each stamping the thread's
current ledger record; the window's ``learner/retire`` span and
``learner/retire_s`` histogram, the ``learner/inflight_depth`` gauge, and
the end of each trajectory's ledger record: ``retire`` closes it
retired, ``discard`` (the rollback) closes it discarded, its frames
counted in ``ledger/frames_discarded_total``.

A placed trajectory is returned with the device tensors that hold its
memory (the leaves, or the one packed buffer that the leaves alias): a
consumer on another stream must ``record_stream`` those, so the caching
allocator cannot hand the memory to a later upload while the consumer's
work on it is pending.
"""

import weakref
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch.obs import get_ledger, get_registry, get_tracer
from scalable_agent_tpu_torch.runtime.actor import to_device
from scalable_agent_tpu_torch.runtime.learner import Trajectory
from scalable_agent_tpu_torch.types import map_structure

# Leaf offsets inside a packed shard segment are rounded up to this many
# bytes: enough for any dtype's alignment (so every leaf can be viewed in
# place), and the padding stays negligible next to the frame leaf.
_ALIGN = 128

# The batch axis of each Trajectory field: agent_state is [B, H], the
# env and agent outputs are [T+1, B, ...].
TRAJ_BATCH_AXES = Trajectory(agent_state=0, env_outputs=1, agent_outputs=1)

Placed = Tuple[Trajectory, Tuple[torch.Tensor, ...]]


def tree_leaves(tree) -> List[Any]:
    """Every leaf of ``tree`` in ``map_structure`` order, None included
    (an absent optional observation is a None leaf)."""
    leaves = []
    map_structure(leaves.append, tree)
    return leaves


def tree_unflatten(template, leaves: Sequence[Any]):
    """``template``'s structure with ``leaves`` in its leaves' places."""
    it = iter(leaves)
    return map_structure(lambda _: next(it), template)


def broadcast_prefix(prefix, full) -> List[Any]:
    """A per-field prefix tree (one entry per top-level field of ``full``)
    as a flat list aligned with ``full``'s leaves."""
    out = []
    for entry, subtree in zip(prefix, full):
        out.extend([entry] * len(tree_leaves(subtree)))
    return out


def host_trajectory(actor_output) -> Trajectory:
    """An ActorPool ``ActorOutput`` (numpy) as a host ``Trajectory``."""
    return Trajectory(agent_state=actor_output.agent_state,
                      env_outputs=actor_output.env_outputs,
                      agent_outputs=actor_output.agent_outputs)


def h2d_bytes_counter(registry=None):
    """The shared upload-byte counter: the packed trajectory staging here
    and the accum actors' per-step uploads both feed it, so
    ``transport/h2d_bytes_total`` is the host->device byte count of the
    whole pipeline."""
    return (registry or get_registry()).counter(
        "transport/h2d_bytes_total",
        "host->device bytes staged by the transport layer (packed "
        "trajectory batches + accum per-step uploads)")


def is_device_trajectory(trajectory) -> bool:
    """True when the trajectory's leaves are already tensors (an accum
    actor's, written in place on the device)."""
    return any(isinstance(leaf, torch.Tensor)
               for leaf in tree_leaves(trajectory))


def adopt_device_trajectory(trajectory, ready=None) -> Placed:
    """Pass a trajectory whose leaves are tensors through, on the current
    stream: it waits on ``ready``, the event the producing actor recorded
    on its own stream after the trajectory's last write, and
    ``record_stream``s every leaf, so the caching allocator cannot hand
    their memory to the actor's next unroll while this stream's work on
    them is pending.  On the CPU the work is done when it is issued; an
    event there (a test's stand-in) is waited on the host."""
    leaves = tuple(t for t in tree_leaves(trajectory) if t is not None)
    if ready is not None:
        if leaves and leaves[0].is_cuda:
            stream = torch.cuda.current_stream(leaves[0].device)
            stream.wait_event(ready)
            for tensor in leaves:
                tensor.record_stream(stream)
        else:
            ready.synchronize()
    return trajectory, leaves


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class PerLeafTransport:
    """One upload per leaf, ``torch.as_tensor(leaf, device=device)``."""

    def __init__(self, device):
        self._device = torch.device(device)

    def put(self, trajectory: Trajectory, ready=None) -> Placed:
        if is_device_trajectory(trajectory):
            return adopt_device_trajectory(trajectory, ready)
        placed = to_device(trajectory, self._device)
        return placed, tuple(t for t in tree_leaves(placed)
                             if t is not None)


class _LeafSpec(NamedTuple):
    """One leaf's slot inside a packed shard segment."""

    offset: int  # byte offset within a shard segment (128-aligned)
    nbytes: int  # bytes of ONE shard's chunk of this leaf
    shape: Tuple[int, ...]  # the leaf's shape (what unpack gives)
    chunk_shape: Tuple[int, ...]  # shape with the batch axis / num_shards
    dtype: np.dtype
    batch_axis: int


def _round_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


class PackedSpec:
    """The byte layout of one packed trajectory batch, as the JAX
    package lays it out.

    Leaves are ordered dtype-segmented (stable within a dtype) and each
    gets a 128-byte-aligned offset inside the per-shard segment; the
    buffer is ``[num_shards, shard_nbytes]`` uint8, shard d holding batch
    slice ``[d*b:(d+1)*b]`` of every leaf.
    """

    def __init__(self, example, batch_axes_prefix=TRAJ_BATCH_AXES,
                 num_shards: int = 1):
        leaves = tree_leaves(example)
        # The structure alone: the example's arrays are not kept.
        self.template = map_structure(
            lambda a: None if a is None else 0, example)
        batch_axes = broadcast_prefix(batch_axes_prefix, example)
        self.num_shards = int(num_shards)
        self.specs: List[Optional[_LeafSpec]] = [None] * len(leaves)
        # dtype-segmented: the padding between leaves of one dtype is the
        # 128-byte rounding alone.
        order = sorted(
            (i for i, leaf in enumerate(leaves) if leaf is not None),
            key=lambda i: (np.asarray(leaves[i]).dtype.str, i))
        offset = 0
        for i in order:
            arr = np.asarray(leaves[i])
            axis = batch_axes[i]
            batch = arr.shape[axis]
            if batch % self.num_shards:
                raise ValueError(
                    f"batch axis {axis} of leaf shape {arr.shape} "
                    f"({batch}) not divisible by {self.num_shards} data "
                    f"shards")
            chunk_shape = (arr.shape[:axis] + (batch // self.num_shards,)
                           + arr.shape[axis + 1:])
            nbytes = int(np.prod(chunk_shape)) * arr.dtype.itemsize
            offset = _round_up(offset, _ALIGN)
            # unpack views each segment as its dtype in place, which
            # needs the offset to be a multiple of the item size.
            if offset % arr.dtype.itemsize:
                raise AssertionError(
                    f"offset {offset} is not aligned to {arr.dtype}")
            self.specs[i] = _LeafSpec(
                offset=offset, nbytes=nbytes, shape=arr.shape,
                chunk_shape=chunk_shape, dtype=arr.dtype, batch_axis=axis)
            offset += nbytes
        self.shard_nbytes = _round_up(offset, _ALIGN)

    def pack_into(self, buf: np.ndarray, trajectory) -> None:
        """Write the trajectory's leaves into ``buf`` ([num_shards,
        shard_nbytes] uint8): row d holds batch chunk d of every leaf,
        each leaf's bytes at its aligned offset."""
        leaves = tree_leaves(trajectory)
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"trajectory has {len(leaves)} leaves, layout declares "
                f"{len(self.specs)}")
        for spec, leaf in zip(self.specs, leaves):
            if spec is None:
                if leaf is not None:
                    raise ValueError(
                        "trajectory leaf present where the layout "
                        "declares None")
                continue
            arr = np.asarray(leaf)
            if arr.dtype != spec.dtype:
                raise ValueError(
                    f"leaf dtype {arr.dtype} != declared {spec.dtype}")
            if arr.shape != spec.shape:
                raise ValueError(
                    f"leaf shape {arr.shape} != declared {spec.shape}")
            axis = spec.batch_axis
            pre, post = arr.shape[:axis], arr.shape[axis + 1:]
            b = arr.shape[axis] // self.num_shards
            split = arr.reshape(pre + (self.num_shards, b) + post)
            moved = np.moveaxis(split, axis, 0)  # [shards, *pre, b, *post]
            dest = buf[:, spec.offset:spec.offset + spec.nbytes]
            dest = dest.view(spec.dtype).reshape(moved.shape)
            np.copyto(dest, moved)

    def unpack(self, device_buf: torch.Tensor):
        """The trajectory as views of ``device_buf`` (one shard: no copy;
        across shards the batch chunks are merged back)."""
        d = self.num_shards
        leaves = []
        for spec in self.specs:
            if spec is None:
                leaves.append(None)
                continue
            seg = device_buf[:, spec.offset:spec.offset + spec.nbytes]
            arr = seg.view(_torch_dtype(spec.dtype)).reshape(
                (d,) + spec.chunk_shape)
            # Undo the host-side moveaxis, then merge (shards, b) back
            # into the batch axis.
            arr = arr.movedim(0, spec.batch_axis).reshape(spec.shape)
            leaves.append(arr)
        return tree_unflatten(self.template, leaves)


class PackedTransport:
    """Single-copy upload through two staging buffers used in turn.

    ``put(trajectory)`` gives the same trajectory on ``device`` as
    ``PerLeafTransport`` does, bit for bit, for one upload.  The layout
    and the two staging buffers are made at the first batch.  The
    transport serves one caller at a time (the driver's prefetch thread);
    its copies run on that caller's current stream.
    """

    def __init__(self, device):
        self._device = torch.device(device)
        self.spec: Optional[PackedSpec] = None
        self._staging: List[Optional[torch.Tensor]] = [None, None]
        # The CUDA event after the last upload out of each staging
        # buffer: a non_blocking copy from pinned memory reads the buffer
        # until it completes, so a pack into the buffer waits on it.
        self._upload_done: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0
        self._upload_sink = None
        registry = get_registry()
        self._h_pack = registry.histogram(
            "transport/pack_s", "host pack into the staging buffer")
        self._h_upload = registry.histogram(
            "transport/upload_s", "single-copy H2D dispatch seconds")
        self._h_unpack = registry.histogram(
            "transport/unpack_s", "on-device unpack dispatch seconds")
        self._bytes_counter = h2d_bytes_counter(registry)

    def _ensure_spec(self, trajectory) -> PackedSpec:
        if self.spec is None:
            spec = PackedSpec(trajectory, TRAJ_BATCH_AXES, num_shards=1)
            pin = self._device.type == "cuda"
            self._staging = [
                torch.empty((1, spec.shard_nbytes),
                            dtype=torch.uint8, pin_memory=pin)
                for _ in range(2)]
            if pin and not all(b.is_pinned() for b in self._staging):
                raise RuntimeError("packed transport: the staging buffers "
                                   "could not be pinned")
            self.spec = spec
        return self.spec

    def pack(self, trajectory) -> torch.Tensor:
        """Host trajectory -> the next staging buffer, after the upload
        that last read that buffer has completed."""
        spec = self._ensure_spec(trajectory)
        slot = self._slot
        self._slot = 1 - slot
        if self._upload_done[slot] is not None:
            self._upload_done[slot].synchronize()
        buf = self._staging[slot]
        spec.pack_into(buf.numpy(), trajectory)
        return buf

    def upload(self, buf: torch.Tensor) -> torch.Tensor:
        """ONE copy of a staging buffer into a fresh device buffer, on the
        current stream (asynchronous on the card)."""
        device_buf = torch.empty(buf.shape, dtype=torch.uint8,
                                 device=self._device)
        device_buf.copy_(buf, non_blocking=True)
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            for slot, staged in enumerate(self._staging):
                if staged is buf:
                    self._upload_done[slot] = event
        return device_buf

    def unpack(self, device_buf: torch.Tensor) -> Trajectory:
        """The trajectory as views of the device buffer (also the replay
        slab's postprocess of a sampled buffer)."""
        return self.spec.unpack(device_buf)

    def set_upload_sink(self, sink) -> None:
        """Tap every uploaded device buffer (the replay insert):
        ``sink(device_buf)`` runs on the putting thread and its stream
        right after the upload is issued; None disconnects."""
        self._upload_sink = sink

    def put(self, trajectory: Trajectory, ready=None) -> Placed:
        """Pack, upload and unpack a host trajectory; a trajectory already
        on the device passes through (``adopt_device_trajectory``: nothing
        crosses the link, and the upload sink sees nothing)."""
        if is_device_trajectory(trajectory):
            return adopt_device_trajectory(trajectory, ready)
        tracer = get_tracer()
        ledger = get_ledger()
        with tracer.span("transport/pack", cat="h2d"), \
                self._h_pack.time():
            buf = self.pack(trajectory)
        ledger.stamp_current("transport_pack")
        with tracer.span("transport/upload", cat="h2d",
                         args={"bytes": int(buf.nbytes)}), \
                self._h_upload.time():
            device_buf = self.upload(buf)
        self._bytes_counter.inc(buf.nbytes)
        ledger.stamp_current("transport_upload")
        if self._upload_sink is not None:
            # The batch's bytes are on the card: the replay insert copies
            # this buffer there, and nothing crosses the link twice.
            self._upload_sink(device_buf)
        with tracer.span("transport/unpack", cat="h2d"), \
                self._h_unpack.time():
            result = self.unpack(device_buf)
        ledger.stamp_current("transport_unpack")
        return result, (device_buf,)


def make_transport(name: str, device):
    """Config string -> transport: ``per_leaf`` or ``packed``."""
    if name == "per_leaf":
        return PerLeafTransport(device)
    if name == "packed":
        return PackedTransport(device)
    raise ValueError(f"unknown transport {name!r} (per_leaf | packed)")


class InflightWindow:
    """At most W dispatched updates whose metrics are not yet waited for.

    ``push`` takes an update's metrics right after it was issued and
    records a CUDA event after it on the current stream; once ``depth``
    reaches the window the driver calls ``retire``, which waits for the
    OLDEST update's event and returns its metrics (FIFO: every retired
    metrics dict belongs to a known update, so ``env_frames`` accounting
    stays exact).  W=1 is lock-step.  On the CPU the work is done when the
    update returns, and ``retire`` returns at once.
    """

    def __init__(self, window: int, registry=None):
        if window < 1:
            raise ValueError(f"inflight window must be >= 1, got {window}")
        self.window = int(window)
        self._pending = deque()
        registry = registry or get_registry()
        pending_ref = weakref.ref(self._pending)
        registry.gauge(
            "learner/inflight_depth",
            "dispatched updates whose outputs are not yet materialized",
            fn=lambda: (len(p) if (p := pending_ref()) is not None
                        else 0.0))
        self._h_retire = registry.histogram(
            "learner/retire_s",
            "seconds blocked materializing the oldest in-flight update")

    @property
    def depth(self) -> int:
        return len(self._pending)

    @property
    def full(self) -> bool:
        return len(self._pending) >= self.window

    def push(self, metrics: Dict[str, torch.Tensor],
             ledger_id: Optional[int] = None) -> None:
        """Take an issued update's metrics and its trajectory's ledger
        record (None: no record)."""
        event = None
        device = next((t.device for t in metrics.values() if t.is_cuda),
                      None)
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self._pending.append((metrics, event, ledger_id))

    def retire(self) -> Dict[str, torch.Tensor]:
        """Wait for the oldest in-flight update and return its metrics
        (ready to read without a further wait); its ledger record closes
        retired."""
        metrics, event, tid = self._pending.popleft()
        with get_tracer().span("learner/retire", cat="learner"), \
                self._h_retire.time():
            if event is not None:
                event.synchronize()
        if tid is not None:
            ledger = get_ledger()
            ledger.stamp(tid, "retire")
            ledger.close(tid, retired=True)
        return metrics

    def drain(self) -> Optional[Dict[str, torch.Tensor]]:
        """Retire everything; the NEWEST metrics, or None when nothing
        was in flight."""
        metrics = None
        while self._pending:
            metrics = self.retire()
        return metrics

    def discard(self) -> int:
        """Drop every in-flight metrics dict without waiting for it (the
        rollback path: the pending updates belong to the abandoned
        timeline); their ledger records close discarded.  Returns how
        many were dropped."""
        dropped = len(self._pending)
        ledger = get_ledger()
        for _, _, tid in self._pending:
            if tid is not None:
                ledger.close(tid, retired=False, fate="discarded")
        self._pending.clear()
        return dropped
