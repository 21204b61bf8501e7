"""Device telemetry: instruments that live on the card and are updated
inside the learner's update, with no host sync.

A copy of ``scalable_agent_tpu/obs/device_telemetry.py`` on torch
tensors:

- ``DeviceTelemetry`` is a spec: counters, gauges and bucketed
  histograms declared once; ``init(device)`` makes their buffers, one
  float32 tensor per leaf in a flat dict (``c:``/``g:``/``h:`` key
  prefixes, the JAX keys).
- ``inc``/``set``/``observe`` (and ``set_many``, many gauges in one
  multi-tensor copy) update those tensors IN PLACE on the
  current stream and return the dict (the JAX ops return a new pytree,
  which the jitted update donates; here the update runs eagerly, so the
  buffers are simply mutated).  Nothing reads a value back to the host:
  a histogram observe is ``torch.bucketize`` against the declared edges
  and a sum of a fixed-width one-hot comparison, and a masked value is
  selected out with ``torch.where`` (``NaN * 0`` is NaN).
- ``fetch``/``fetch_merged`` are the one device-to-host copy: every leaf
  flattened into one vector on the card, copied once, split on the host.
- ``TelemetryPublisher`` folds a fetched snapshot into the metrics
  registry under ``devtel/<namespace>/...`` names.

Counts are float32, exact to 2**24.

``torch`` is imported inside the methods that touch a tensor: this module
rides the ``obs`` package's init, which the report, aggregate, diagnose
and watch CLIs import, and they run without torch against logdirs copied
off the card.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "DeviceTelemetry",
    "TelemetryPublisher",
    "fetch_merged",
    "merge_init",
]

_COUNTER = "c:"
_GAUGE = "g:"
_HIST = "h:"


def _edge_label(edge: float) -> str:
    """Bucket edge -> metric-name fragment: 10.0 -> "10", 2.5 -> "2_5",
    -10.0 -> "m10"."""
    if edge == int(edge):
        text = str(int(edge))
    else:
        text = repr(float(edge)).replace(".", "_")
    return text.replace("-", "m")


class DeviceTelemetry:
    """Declarative spec of a set of device-resident instruments, published
    as ``devtel/<namespace>/<name>``."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._counters: Dict[str, str] = {}
        self._gauges: Dict[str, str] = {}
        self._hists: Dict[str, Tuple[Tuple[float, ...], str]] = {}
        self._edge_tensors: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    # -- declaration (host, construction time) -----------------------------

    def _check_new(self, name: str):
        if (name in self._counters or name in self._gauges
                or name in self._hists):
            raise ValueError(
                f"telemetry instrument {name!r} already declared in "
                f"namespace {self.namespace!r}")

    def counter(self, name: str, help: str = "") -> "DeviceTelemetry":
        """A float32 scalar accumulated by ``inc``."""
        self._check_new(name)
        self._counters[name] = help
        return self

    def gauge(self, name: str, help: str = "") -> "DeviceTelemetry":
        """A float32 scalar holding the last ``set``."""
        self._check_new(name)
        self._gauges[name] = help
        return self

    def histogram(self, name: str, edges: Sequence[float],
                  help: str = "") -> "DeviceTelemetry":
        """``len(edges) + 1`` bucket counts (the last is ``> edges[-1]``)
        with an exact running sum and count."""
        self._check_new(name)
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(
                f"histogram {name!r} edges must be strictly increasing")
        if not edges:
            raise ValueError(f"histogram {name!r} needs >= 1 edge")
        self._hists[name] = (edges, help)
        return self

    @property
    def empty(self) -> bool:
        return not (self._counters or self._gauges or self._hists)

    def full_name(self, name: str) -> str:
        return f"devtel/{self.namespace}/{name}"

    def _key(self, prefix: str, name: str) -> str:
        return f"{prefix}{self.namespace}/{name}"

    # -- buffers -----------------------------------------------------------

    def init(self, device=None) -> Dict[str, torch.Tensor]:
        """Fresh zeroed buffers on ``device``, one tensor per leaf."""
        import torch

        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=device)
        tel: Dict[str, torch.Tensor] = {}
        for name in self._counters:
            tel[self._key(_COUNTER, name)] = zeros()
        for name in self._gauges:
            tel[self._key(_GAUGE, name)] = zeros()
        for name, (edges, _) in self._hists.items():
            base = self._key(_HIST, name)
            tel[base + ":buckets"] = zeros(len(edges) + 1)
            tel[base + ":sum"] = zeros()
            tel[base + ":count"] = zeros()
        return tel

    # -- in-update ops (in place, no host sync) ----------------------------

    def inc(self, tel: Dict, name: str, amount=1.0) -> Dict:
        """Counter ``name`` += ``amount`` (a number or a 0-d tensor)."""
        if name not in self._counters:
            raise KeyError(f"unknown telemetry counter {name!r}")
        tel[self._key(_COUNTER, name)].add_(amount)
        return tel

    def set(self, tel: Dict, name: str, value) -> Dict:
        """Gauge ``name`` = ``value``."""
        if name not in self._gauges:
            raise KeyError(f"unknown telemetry gauge {name!r}")
        import torch

        buf = tel[self._key(_GAUGE, name)]
        if isinstance(value, torch.Tensor):
            buf.copy_(value.reshape(()))
        else:  # a host number: a fill, not a host-to-device copy
            buf.fill_(float(value))
        return tel

    def set_many(self, tel: Dict, values: Dict[str, torch.Tensor]) -> Dict:
        """Gauge ``name`` = ``values[name]`` for every name, the values
        tensors on the buffers' device, in one multi-tensor copy (one
        launch where ``set`` takes one per gauge)."""
        import torch

        for name in values:
            if name not in self._gauges:
                raise KeyError(f"unknown telemetry gauge {name!r}")
        torch._foreach_copy_(
            [tel[self._key(_GAUGE, name)] for name in values],
            [value.reshape(()) for value in values.values()])
        return tel

    def _edges(self, name: str, device) -> torch.Tensor:
        """The declared edges of ``name`` as a tensor on ``device``, made
        once (a host-to-device copy per update would be a new transfer)."""
        import torch

        key = (name, torch.device(device))
        edges = self._edge_tensors.get(key)
        if edges is None:
            edges = torch.tensor(self._hists[name][0], dtype=torch.float32,
                                 device=device)
            self._edge_tensors[key] = edges
        return edges

    def observe(self, tel: Dict, name: str, values,
                where=None) -> Dict:
        """Histogram ``name`` fed every element of ``values`` for which
        ``where`` (broadcast against ``values``; None: all) is true."""
        if name not in self._hists:
            raise KeyError(f"unknown telemetry histogram {name!r}")
        import torch

        base = self._key(_HIST, name)
        buckets = tel[base + ":buckets"]
        raw = torch.as_tensor(values, dtype=torch.float32,
                              device=buckets.device)
        if where is None:
            weights = torch.ones(raw.numel(), dtype=torch.float32,
                                 device=buckets.device)
        else:
            weights = torch.broadcast_to(
                torch.as_tensor(where, device=buckets.device),
                raw.shape).to(torch.float32).reshape(-1)
        values = torch.where(weights > 0, raw.reshape(-1),
                             torch.zeros((), device=buckets.device))
        edges = self._edges(name, buckets.device)
        # right=False: a value equal to an edge lands in that edge's
        # bucket, the published ``le_<edge>`` (<=) label.
        idx = torch.bucketize(values, edges, right=False)
        slots = torch.arange(buckets.numel(), device=buckets.device)
        onehot = (idx[:, None] == slots).to(torch.float32)
        buckets.add_((onehot * weights[:, None]).sum(0))
        tel[base + ":sum"].add_((values * weights).sum())
        tel[base + ":count"].add_(weights.sum())
        return tel

    # -- host side ---------------------------------------------------------

    def owns_key(self, key: str) -> bool:
        prefix = self.namespace + "/"
        return key.startswith((_COUNTER + prefix, _GAUGE + prefix,
                               _HIST + prefix))

    def fetch(self, tel: Dict) -> Dict[str, np.ndarray]:
        """This spec's leaves of ``tel`` on the host, in one copy."""
        return _materialize_leaves(
            {key: value for key, value in tel.items()
             if self.owns_key(key)})

    def counters(self) -> List[str]:
        return sorted(self._counters)

    def gauges(self) -> List[str]:
        return sorted(self._gauges)

    def histograms(self) -> Dict[str, Tuple[float, ...]]:
        return {name: edges
                for name, (edges, _) in sorted(self._hists.items())}

    def value(self, fetched: Dict[str, np.ndarray], name: str):
        """One instrument out of a ``fetch()``: a float for a counter or
        gauge; for a histogram a dict of ``buckets``, ``sum``, ``count``
        and the exact ``mean``."""
        if name in self._counters:
            return float(fetched[self._key(_COUNTER, name)])
        if name in self._gauges:
            return float(fetched[self._key(_GAUGE, name)])
        if name in self._hists:
            base = self._key(_HIST, name)
            count = float(fetched[base + ":count"])
            total = float(fetched[base + ":sum"])
            return {
                "buckets": np.asarray(fetched[base + ":buckets"]),
                "sum": total,
                "count": count,
                "mean": total / count if count else 0.0,
            }
        raise KeyError(f"unknown telemetry instrument {name!r}")


def _materialize_leaves(mine: Dict) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, as ONE device-to-host copy: the leaves
    are concatenated on their device, copied, and split on the host."""
    if not mine:
        return {}
    import torch

    flat = torch.cat([v.detach().reshape(-1) for v in mine.values()]
                     ).cpu().numpy()
    out = {}
    offset = 0
    for key, value in mine.items():
        n = value.numel()
        out[key] = flat[offset:offset + n].reshape(tuple(value.shape))
        offset += n
    return out


def fetch_merged(specs: Iterable[DeviceTelemetry],
                 tel: Dict) -> Dict[str, np.ndarray]:
    """Every spec's leaves of a merged dict, in one copy."""
    specs = list(specs)
    return _materialize_leaves(
        {key: value for key, value in tel.items()
         if any(spec.owns_key(key) for spec in specs)})


def merge_init(specs: Iterable[DeviceTelemetry], device=None) -> Dict:
    """One dict holding every spec's buffers; namespaces keep the keys
    disjoint, and a collision raises."""
    tel: Dict = {}
    for spec in specs:
        part = spec.init(device)
        overlap = set(part) & set(tel)
        if overlap:
            raise ValueError(
                f"telemetry namespace collision on {sorted(overlap)}")
        tel.update(part)
    return tel


class TelemetryPublisher:
    """Folds fetched snapshots into a MetricsRegistry.

    - counter ``name`` -> the registry Counter ``devtel/<ns>/<name>_total``
      (increased by the delta, so it stays monotonic across runs) and the
      Gauge ``devtel/<ns>/<name>`` (this run's cumulative value);
    - gauge ``name`` -> Gauge ``devtel/<ns>/<name>``;
    - histogram ``name`` -> Gauges ``devtel/<ns>/<name>/count|sum|mean``
      and one Counter per bucket,
      ``devtel/<ns>/<name>/bucket/le_<edge>_total`` (the last
      ``gt_<edge>_total``), delta-increased.

    One publisher per run: its delta tracking starts at 0 with the run's
    fresh buffers.
    """

    def __init__(self, specs: Union[DeviceTelemetry,
                                    Sequence[DeviceTelemetry]],
                 registry=None):
        from scalable_agent_tpu_torch.obs.registry import get_registry

        if isinstance(specs, DeviceTelemetry):
            specs = [specs]
        self._specs = list(specs)
        self._registry = registry or get_registry()
        self._instruments: Dict[str, object] = {}
        reg = self._registry
        for spec in self._specs:
            for name in spec.counters():
                full = spec.full_name(name)
                self._instruments[full + "_total"] = reg.counter(
                    full + "_total",
                    f"device-accumulated {full} (fetched at log "
                    f"cadence)")
                self._instruments[full] = reg.gauge(
                    full, f"this run's device-cumulative {full}")
            for name in spec.gauges():
                full = spec.full_name(name)
                self._instruments[full] = reg.gauge(
                    full, f"device-resident gauge {full}")
            for name, edges in spec.histograms().items():
                full = spec.full_name(name)
                for label in self._bucket_labels(edges):
                    key = f"{full}/bucket/{label}_total"
                    self._instruments[key] = reg.counter(
                        key, f"device-bucketed {full} observations")
                for suffix in ("count", "sum", "mean"):
                    key = f"{full}/{suffix}"
                    self._instruments[key] = reg.gauge(
                        key, f"device histogram {full} {suffix} "
                             f"(exact, cumulative this run)")
        self._last: Dict[str, float] = {}

    @staticmethod
    def _bucket_labels(edges: Tuple[float, ...]) -> List[str]:
        labels = [f"le_{_edge_label(e)}" for e in edges]
        labels.append(f"gt_{_edge_label(edges[-1])}")
        return labels

    def _delta_inc(self, key: str, cumulative: float):
        last = self._last.get(key, 0.0)
        if cumulative > last:
            self._instruments[key].inc(cumulative - last)
            self._last[key] = cumulative

    def publish(self, fetched: Dict[str, np.ndarray]):
        """Fold one fetch (or a merged one) into the registry; keys a
        partial fetch lacks are skipped."""
        for spec in self._specs:
            for name in spec.counters():
                key = spec._key(_COUNTER, name)
                if key not in fetched:
                    continue
                value = float(fetched[key])
                full = spec.full_name(name)
                self._delta_inc(full + "_total", value)
                self._instruments[full].set(value)
            for name in spec.gauges():
                key = spec._key(_GAUGE, name)
                if key not in fetched:
                    continue
                self._instruments[spec.full_name(name)].set(
                    float(fetched[key]))
            for name, edges in spec.histograms().items():
                base = spec._key(_HIST, name)
                if base + ":count" not in fetched:
                    continue
                full = spec.full_name(name)
                buckets = np.asarray(fetched[base + ":buckets"])
                for label, value in zip(self._bucket_labels(edges),
                                        buckets):
                    self._delta_inc(f"{full}/bucket/{label}_total",
                                    float(value))
                count = float(fetched[base + ":count"])
                total = float(fetched[base + ":sum"])
                self._instruments[full + "/count"].set(count)
                self._instruments[full + "/sum"].set(total)
                self._instruments[full + "/mean"].set(
                    total / count if count else 0.0)
