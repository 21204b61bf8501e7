"""Per-kernel roofline table of a ``torch.profiler`` window -> kernels.json.

The counterpart of ``scalable_agent_tpu/obs/kernels.py``.  The table and
its consumers are copies (``build_kernel_table``, ``write_kernels_json``,
``publish_kernel_metrics`` and its ``kernel/*`` gauges, ``last_worst``,
``last_dominant``; schema 2, the same field names).  What the JAX module
reads from the compiled update's HLO, this one reads from the window's
Chrome trace (``torch_profile.<pid>.json``, written with
``record_shapes=True``):

- **Rows.**  On ``cuda``, the ``cat == "kernel"`` events whose launch ran
  on the learner: a kernel's ``args.correlation`` names its
  ``cuda_runtime``/``cuda_driver`` launch event, and that event's thread
  must be one that hosts the tracer's ``learner/update`` range, or an
  autograd engine thread (the backward of CUDA tensors runs there; the
  actors run under ``no_grad``), or the kernel's ``External id`` must
  name an op of such a thread (the actors' ops are not recorded: their
  threads predate the window).  So the actors' ``lstm_step_kernel`` is
  not a row, as the JAX table keeps only the update's HLO module.  Scope
  is ``learner`` for a kernel launched inside a ``learner/update`` range,
  else ``unattributed``.  On ``cpu`` the rows are the learner thread's
  top-level ``cpu_op`` events inside the update.  A ``cuda`` window with
  no kernel event yields no table: it never falls back to CPU ops.
- **Names.**  ``kernel_name`` drops the return type, the anonymous
  namespace and the parameter list of a demangled name and keeps the
  template arguments, so ``sgemm_kernel<true, __nv_bfloat16>`` and
  ``sgemm_kernel<true, float>`` stay apart.
- **Costs.**  The hand-written kernels get explicit per-call entries at
  the update's shapes (``handwritten_costs``, from the shapes
  ``runtime/learner.update_flops`` counts), as the JAX module prices its
  Pallas custom calls.  A library kernel is costed from the aten op that
  launched it (the kernel's ``External id`` names the innermost op; the
  nearest enclosing op with a formula wins): products and convolutions
  by ``torch.utils.flop_counter``'s formulas over the recorded input
  shapes, any other aten op (elementwise, reductions) at 0 FLOPs, as
  ``update_flops`` counts; the op's FLOPs and input bytes are split over
  its kernels by their time.  A kernel with neither stays uncosted: it
  lands in ``unmatched_events`` and lowers ``matched_time_frac``.  The
  estimates are normalized so the rows sum to ``update_flops`` per
  execution, as the JAX table normalizes to XLA's count.

A window's table counts its last ``executions`` updates: the driver
records one warm-up update before them, because launches made just after
``torch.profiler`` starts can be missing from the trace.  ``harvest``
builds, writes and publishes one window's table and never raises on a
missing or unreadable trace.
"""

import glob
import json
import logging
import math
import os
import re
import threading
from typing import Dict, List, Mapping, Optional, Tuple

__all__ = [
    "KERNELS_JSON_NAME",
    "LIBRARY_ROUTES",
    "UPDATE_RANGE",
    "build_kernel_table",
    "find_profiler_trace",
    "handwritten_costs",
    "harvest",
    "join_trace",
    "kernel_name",
    "last_dominant",
    "last_worst",
    "op_cost",
    "publish_kernel_metrics",
    "write_kernels_json",
]

log = logging.getLogger("scalable_agent_tpu_torch")

_SCHEMA_VERSION = 2  # 2: + per-row "scope" and table "scope_time_shares"
KERNELS_JSON_NAME = "kernels.json"
# The tracer's span around Learner.update: a torch.profiler range while a
# window records (obs/trace.py set_annotate).
UPDATE_RANGE = "learner/update"
_AUTOGRAD_OP = "autograd::engine::evaluate_function"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# Kernels below this share of matched device time are excluded from the
# "worst kernel" verdict: a 0.1%-of-time kernel at 0.01 MFU is noise,
# not the roofline target.
WORST_MIN_TIME_SHARE = 0.02

# How many kernels get per-kernel registry gauges (the full table lives
# in kernels.json; the registry carries the actionable head).
PUBLISH_TOP_N = 8


# -- names -------------------------------------------------------------------


def kernel_name(raw: str) -> str:
    """A demangled kernel name without its return type, the anonymous
    namespace and its parameter list (the last parenthesized group that
    ends the name), template arguments kept."""
    name = raw.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            if name[i] == ")":
                depth += 1
            elif name[i] == "(":
                depth -= 1
                if depth == 0:
                    name = name[:i]
                    break
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[len("void "):].strip()
    return name or raw


# -- the hand-written kernels' costs -----------------------------------------


# The hand-written kernels each library route leaves out (by name prefix):
# core_impl=xla the LSTM kernels (csrc/lstm.cu), conv_backend=xla the
# stems' grad-W kernels and their reduce (csrc/conv.cu).
LIBRARY_ROUTES = {
    "core_impl": ("sgemm_kernel", "lstm_", "bptt_"),
    "conv_backend": ("conv_gradw_band_kernel", "resnet_stem_gradw_kernel",
                     "reduce_partials_kernel"),
}


def handwritten_costs(frame_shape, num_logits: int, unroll_length: int,
                      batch_size: int, core_size: Optional[int] = None,
                      compute_dtype: str = "bfloat16",
                      matmul_dtype: Optional[str] = None,
                      sm_count: int = 132, torso_type: str = "shallow",
                      use_instruction: bool = False,
                      core_impl: str = "pallas",
                      conv_backend: str = "pallas") -> Dict[str, dict]:
    """Per-call ``{"flops_est", "bytes", "op", "calls"}`` of each
    hand-written kernel one update launches (``calls`` per update), keyed
    by the start of its ``kernel_name``.  FLOPs count the products at 2
    per multiply-add and nothing elementwise, as ``update_flops`` does;
    bytes count each input read once and each output written once at the
    width the kernel reads (the LSTM kernels read float32 in both
    variants; the bf16 variant's dgates, grad-W x and g are bf16).
    ``matmul_dtype`` is the LSTM products' operand type (default: as
    ``compute_dtype``); ``sm_count`` sizes grad-W's partial sums, and the
    frame's channel count (3, or Atari's stack of 4) its taps and plan;
    ``torso_type`` picks the stem's grad-W kernel and ``use_instruction``
    widens the core's input by the instruction encoding; ``num_logits``,
    the policy's logit count, is the one-hot last action's width.
    ``core_impl="xla"`` leaves the LSTM kernels out and
    ``conv_backend="xla"`` the grad-W kernels (``LIBRARY_ROUTES``): the
    library kernels those routes launch in their place are costed from
    their aten ops like every other library kernel, so a library arm's
    table names them and the two arms' tables compare row by row."""
    from scalable_agent_tpu_torch.models.agent import CORE_SIZE
    from scalable_agent_tpu_torch.models.instruction import LSTM_SIZE
    from scalable_agent_tpu_torch.models.networks import (
        TORSO_SIZE,
        conv_shapes,
    )
    from scalable_agent_tpu_torch.ops import conv_cuda, lstm_cuda

    hidden = core_size or CORE_SIZE
    matmul_dtype = matmul_dtype or compute_dtype
    s = unroll_length + 1
    b = batch_size
    m = s * b
    d = TORSO_SIZE + 1 + num_logits + (LSTM_SIZE if use_instruction else 0)
    h = hidden
    g = 4 * h
    op_bytes = 2 if matmul_dtype == "bfloat16" else 4
    x_bytes = 2 if compute_dtype == "bfloat16" else 4
    stem = conv_shapes(torso_type, frame_shape)[0][0]
    taps = stem.kernel * stem.kernel * stem.in_channels * stem.out_channels
    built = True
    if torso_type == "resnet":
        gradw = "resnet_stem_gradw_kernel"
        blocks = conv_cuda.resnet_gradw_plan(
            m, stem.in_height, stem.in_width, x_bytes, sm_count).blocks
    else:
        gradw = "conv_gradw_band_kernel"
        # A channel count the kernel is not built for has no cost entry:
        # on the card its grad-W raises.
        built = stem.in_channels in conv_cuda.GRADW_GROUPS
        blocks = (conv_cuda.gradw_plan(m, stem.out_height, stem.out_width,
                                       False, False, sm_count,
                                       stem.in_channels).blocks
                  if built else 0)

    def entry(source, calls, flops, nbytes):
        return {"flops_est": float(flops) / calls,
                "bytes": float(nbytes) / calls, "op": source,
                "calls": calls}

    lstm, conv = "csrc/lstm.cu", "csrc/conv.cu"
    costs = {
        "sgemm_kernel<true": entry(
            lstm, 1, 2 * m * d * g, 4 * (m * d + d * g + g + m * g)),
        "lstm_resid_kernel": entry(
            lstm, 1, 2 * m * h * g,
            4 * (m * g + m + 2 * b * h + h * g + m * h + m * g + 3 * m * h
                 + 2 * b * h)),
        "bptt_chain_kernel": entry(
            lstm, 1, 2 * m * g * h,
            4 * (m * h + m + m * g + 2 * m * h + h * g + 2 * b * h
                 + b * g + 2 * b * h) + op_bytes * m * g),
        gradw: entry(
            conv, 1, 2 * m * stem.out_height * stem.out_width * taps,
            x_bytes * m * (stem.in_height * stem.in_width * stem.in_channels
                           + stem.out_height * stem.out_width
                           * stem.out_channels) + 4 * blocks * taps),
        "reduce_partials_kernel": entry(conv, 1, 0, 4 * (blocks + 1) * taps),
        "vtrace_chunked_kernel": entry(
            "csrc/vtrace.cu", 1, 0, 4 * (6 * unroll_length * b + b)),
    }
    if matmul_dtype == "bfloat16":
        splits = lstm_cuda.wgrad_splits(m, d, h)
        costs["bptt_dx_kernel"] = entry(
            lstm, 1, 2 * m * d * g, 2 * m * g + 4 * (d * g + m * d))
        costs["bptt_dw_kernel"] = entry(
            lstm, 1, 2 * m * (d + h) * g,
            4 * (m * d + m * h + splits * (d + h) * g) + 2 * m * g)
        costs["bptt_reduce_kernel"] = entry(
            lstm, 1, 0,
            4 * (b * g + g + splits * (d + h) * g + (d + h) * g))
    else:
        costs["sgemm_kernel<false"] = entry(
            lstm, 3, 2 * m * g * (d + d + h),
            4 * (3 * m * g + 2 * (d * g + m * d) + m * h + h * g))
        costs["bptt_reduce_kernel"] = entry(lstm, 1, 0, 4 * (b * g + g))
    if not built:
        del costs[gradw], costs["reduce_partials_kernel"]
    for route, value in (("core_impl", core_impl),
                         ("conv_backend", conv_backend)):
        if value == "xla":
            for key in [k for k in costs
                        if k.startswith(LIBRARY_ROUTES[route])]:
                del costs[key]
    return costs


def _handwritten_entry(name: str, costs: Mapping[str, dict]
                       ) -> Optional[dict]:
    """The entry whose key starts ``name`` at a name boundary; the
    longest such key."""
    best = None
    for key, entry in costs.items():
        if name.startswith(key) and (len(name) == len(key)
                                     or name[len(key)] in "<, >"):
            if best is None or len(key) > len(best[0]):
                best = (key, entry)
    return best[1] if best else None


# -- library ops' costs from the recorded shapes -----------------------------

_TYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
    "long int": 8, "int": 4, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
}


def _input_bytes(args: Mapping) -> float:
    total = 0.0
    for dims, dtype in zip(args.get("Input Dims") or (),
                           args.get("Input type") or ()):
        if isinstance(dims, list) and dims and all(
                isinstance(v, int) for v in dims):
            total += _TYPE_BYTES.get(dtype, 0) * math.prod(dims)
    return total


def _int_list(text) -> Optional[List[int]]:
    try:
        value = json.loads(text)
    except (TypeError, ValueError):
        return None
    if isinstance(value, int):
        return [value]
    return value if isinstance(value, list) else None


def _conv_flops(x, w, out_spatial) -> float:
    return 2.0 * x[0] * math.prod(w) * math.prod(out_spatial)


def _convolution_flops(dims, concrete) -> Optional[float]:
    """aten::convolution(input, weight, bias, stride, padding, dilation,
    transposed, output_padding, groups)."""
    x, w = dims[0], dims[1]
    stride, padding, dilation = (_int_list(concrete[i]) for i in (3, 4, 5))
    if not (stride and padding and dilation) or len(x) != len(w):
        return None
    if concrete[6] == "True":
        return _conv_flops(x, w, x[2:])
    spatial = len(x) - 2
    pick = lambda v, i: v[i] if len(v) == spatial else v[0]
    out = [(x[2 + i] + 2 * pick(padding, i)
            - pick(dilation, i) * (w[2 + i] - 1) - 1) // pick(stride, i) + 1
           for i in range(spatial)]
    return _conv_flops(x, w, out)


def _convolution_backward_flops(dims, concrete) -> Optional[float]:
    """aten::convolution_backward(grad_output, input, weight, bias_sizes,
    stride, padding, dilation, transposed, output_padding, groups,
    output_mask): grad_input and grad_weight each cost the forward's
    products (torch.utils.flop_counter's conv_backward_flop)."""
    grad_out, x, w = dims[0], dims[1], dims[2]
    mask = concrete[10].strip("[]").split(", ")
    if len(mask) < 2:
        return None
    transposed = concrete[7] == "True"
    one = _conv_flops(grad_out if transposed else x, w,
                      (x if transposed else grad_out)[2:])
    return one * ((mask[0] == "True") + (mask[1] == "True"))


def _mm_flops(dims, concrete) -> Optional[float]:
    (m, k), (_, n) = dims[0], dims[1]
    return 2.0 * m * n * k


def _addmm_flops(dims, concrete) -> Optional[float]:
    return _mm_flops(dims[1:], concrete)


def _bmm_flops(dims, concrete) -> Optional[float]:
    (b, m, k), (_, _, n) = dims[0], dims[1]
    return 2.0 * b * m * n * k


def _baddbmm_flops(dims, concrete) -> Optional[float]:
    return _bmm_flops(dims[1:], concrete)


_OP_FLOPS = {
    "aten::convolution": _convolution_flops,
    "aten::convolution_backward": _convolution_backward_flops,
    "aten::mm": _mm_flops,
    "aten::addmm": _addmm_flops,
    "aten::bmm": _bmm_flops,
    "aten::baddbmm": _baddbmm_flops,
}


def op_cost(name: str, args: Optional[Mapping]) -> Optional[Tuple[float,
                                                                  float]]:
    """(FLOPs, input bytes) of one profiled op from its recorded shapes,
    for the products and convolutions ``update_flops`` counts; None for
    any other op, or when the shapes were not recorded."""
    formula = _OP_FLOPS.get(name)
    if formula is None or not args or "Input Dims" not in args:
        return None
    try:
        flops = formula(args["Input Dims"], args.get("Concrete Inputs")
                        or [""] * 16)
    except (IndexError, TypeError, ValueError):
        return None
    if flops is None:
        return None
    return float(flops), _input_bytes(args)


# -- trace ingestion ---------------------------------------------------------


def find_profiler_trace(profile_dir: str) -> Optional[str]:
    """The newest ``torch_profile.*.json`` under ``profile_dir``."""
    paths = glob.glob(os.path.join(profile_dir, "torch_profile.*.json"))
    return max(paths, key=os.path.getmtime) if paths else None


def _load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


class _Op:
    """One cpu_op with its place in its thread's nesting."""

    __slots__ = ("event", "start", "end", "parent", "children")

    def __init__(self, event: dict):
        self.event = event
        self.start = float(event.get("ts", 0.0))
        self.end = self.start + float(event.get("dur", 0.0))
        self.parent: Optional["_Op"] = None
        self.children: List["_Op"] = []

    @property
    def name(self) -> str:
        return self.event.get("name", "")

    @property
    def args(self) -> Mapping:
        return self.event.get("args") or {}


def _nest(ops: List[_Op]) -> None:
    """Parent/child links of one thread's ops, by interval containment."""
    stack: List[_Op] = []
    for op in sorted(ops, key=lambda o: (o.start, -o.end)):
        while stack and stack[-1].end < op.start:
            stack.pop()
        if stack and op.end <= stack[-1].end:
            op.parent = stack[-1]
            stack[-1].children.append(op)
        stack.append(op)


def _within(ts: float, spans: List[Tuple[float, float]]) -> bool:
    return any(start <= ts <= end for start, end in spans)


def _subtree_cost(op: _Op) -> Optional[Tuple[float, float]]:
    """A CPU row's cost: its own formula, else the sum over its children
    (an aten op without one at 0 FLOPs and its input bytes); None when
    nothing in the subtree is an aten op."""
    own = op_cost(op.name, op.args)
    if own is not None:
        return own
    flops = nbytes = 0.0
    costed = op.name.startswith("aten::")
    for child in op.children:
        cost = _subtree_cost(child)
        if cost is not None:
            costed = True
            flops += cost[0]
            nbytes += cost[1]
    if not costed:
        return None
    if op.name.startswith("aten::"):
        nbytes = _input_bytes(op.args) or nbytes
    return flops, nbytes


def _library_cost(op: Optional[_Op]) -> Optional[Tuple[_Op, float, float]]:
    """(the costed op, FLOPs, bytes) for a kernel whose innermost op is
    ``op``: the nearest enclosing op with a formula, else the innermost
    aten op at 0 FLOPs; None without an aten op."""
    walk = op
    while walk is not None:
        cost = op_cost(walk.name, walk.args)
        if cost is not None:
            return walk, cost[0], cost[1]
        walk = walk.parent
    if op is not None and op.name.startswith("aten::"):
        return op, 0.0, _input_bytes(op.args)
    return None


def join_trace(events: List[dict], device: str,
               handwritten: Optional[Mapping[str, dict]] = None,
               executions: Optional[int] = None
               ) -> Tuple[Dict[str, Dict[str, float]],
                          Dict[str, Dict[str, object]]]:
    """One window's complete events -> ``(rows, costs)`` for
    ``build_kernel_table``: ``{name: {"time_us", "calls"}}`` for every
    top-level learner op inside the update (``device`` ``cpu``) or every
    learner kernel (any other device), and ``{name: {"flops_est",
    "bytes", "op", "scope"}}`` (per call) for the costed ones.  With
    ``executions``, only what starts from the last ``executions`` update
    ranges on counts (the window's earlier updates warm it up)."""
    handwritten = handwritten or {}
    updates = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == UPDATE_RANGE]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in updates)
    counted_from = (spans[-executions][0]
                    if executions and len(spans) > executions
                    else float("-inf"))
    ops_by_tid: Dict[object, List[_Op]] = {}
    for event in events:
        if event.get("cat") == "cpu_op":
            ops_by_tid.setdefault(event.get("tid"), []).append(_Op(event))
    learner_tids = {e.get("tid") for e in updates} | {
        tid for tid, ops in ops_by_tid.items()
        if any(op.name.startswith(_AUTOGRAD_OP) for op in ops)}
    for tid in learner_tids:
        _nest(ops_by_tid.get(tid, []))

    # (name, time_us, scope, cost): cost is (the library op it is shared
    # with, or None; FLOPs, bytes, op name, input dims) or None.
    calls: List[Tuple[str, float, str, Optional[tuple]]] = []
    if device == "cpu":
        for tid in learner_tids:
            for op in ops_by_tid.get(tid, []):
                if (op.parent is not None or op.start < counted_from
                        or not _within(op.start, spans)):
                    continue
                cost = _subtree_cost(op)
                calls.append((op.name, op.end - op.start, "learner",
                              None if cost is None else
                              (None, cost[0], cost[1], op.name,
                               op.args.get("Input Dims"))))
    else:
        launches = {}
        for event in events:
            if event.get("cat") in _LAUNCH_CATS:
                corr = (event.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = event
        ops_by_id = {op.args["External id"]: op
                     for tid in learner_tids
                     for op in ops_by_tid.get(tid, [])
                     if op.args.get("External id")}
        for event in events:
            if event.get("cat") != "kernel":
                continue
            args = event.get("args") or {}
            launch = launches.get(args.get("correlation"))
            if launch is None or float(launch.get("ts", 0.0)) < counted_from:
                continue
            # The launch's thread, or the learner op the kernel's External
            # id names: a launch's thread id is the CUDA tracer's, which
            # need not be the one its thread's ops carry (on the card the
            # actors' launches read as ids no op thread has).
            innermost = ops_by_id.get(args.get("External id"))
            if launch.get("tid") not in learner_tids and innermost is None:
                continue
            name = kernel_name(event.get("name", ""))
            scope = ("learner" if _within(float(launch.get("ts", 0.0)),
                                          spans) else "unattributed")
            dur = float(event.get("dur", 0.0))
            entry = _handwritten_entry(name, handwritten)
            if entry is not None:
                cost = (None, entry["flops_est"], entry["bytes"],
                        entry["op"], None)
            else:
                found = _library_cost(innermost)
                cost = None if found is None else (
                    id(found[0]), found[1], found[2], found[0].name,
                    found[0].args.get("Input Dims"))
            calls.append((name, dur, scope, cost))

    # A library op's FLOPs and bytes split over its kernels by time.
    group_time: Dict[int, float] = {}
    for _, dur, _, cost in calls:
        if cost is not None and cost[0] is not None:
            group_time[cost[0]] = group_time.get(cost[0], 0.0) + dur
    rows: Dict[str, Dict[str, float]] = {}
    acc: Dict[str, dict] = {}
    for name, dur, scope, cost in calls:
        row = rows.setdefault(name, {"time_us": 0.0, "calls": 0.0})
        row["time_us"] += dur
        row["calls"] += 1.0
        if cost is None:
            continue
        group, flops, nbytes, op_name, dims = cost
        share = 1.0
        if group is not None:
            total = group_time[group]
            share = dur / total if total > 0 else 0.0
        slot = acc.setdefault(name, {"flops": 0.0, "bytes": 0.0, "op": op_name,
                                     "input_dims": dims, "scopes": {}})
        slot["flops"] += flops * share
        slot["bytes"] += nbytes * share
        slot["scopes"][scope] = slot["scopes"].get(scope, 0.0) + dur
    costs: Dict[str, Dict[str, object]] = {}
    for name, slot in acc.items():
        n = rows[name]["calls"]
        costs[name] = {
            "flops_est": slot["flops"] / n, "bytes": slot["bytes"] / n,
            "op": slot["op"],
            "scope": max(sorted(slot["scopes"]),
                         key=lambda key: slot["scopes"][key]),
        }
        if slot["input_dims"]:
            costs[name]["input_dims"] = slot["input_dims"]
    return rows, costs


# -- the join ----------------------------------------------------------------


def build_kernel_table(events: Dict[str, Dict[str, float]],
                       costs: Dict[str, Dict[str, float]],
                       flops_total: float = 0.0,
                       peak_flops: Optional[float] = None,
                       executions: int = 1) -> dict:
    """Join trace events with costs by kernel name.

    ``flops_total`` is ``update_flops`` for ONE execution of the profiled
    update (the ledger-MFU numerator); ``executions`` is how many updates
    ran inside the trace window.  Per-kernel ``flops`` (per execution) are
    the estimates normalized so they sum exactly to ``flops_total``.  A
    cost's ``input_dims`` (the shapes of the op a library kernel was
    costed from) rides along on its row.  Rows sort by total time
    descending."""
    rows = []
    matched_time = 0.0
    est_total = 0.0
    for name, event in events.items():
        cost = costs.get(name)
        if cost is None:
            continue
        matched_time += event["time_us"]
        per_exec = event["calls"] / max(1, executions)
        est_total += cost["flops_est"] * per_exec
        rows.append({
            "name": name,
            "time_us": round(event["time_us"], 3),
            "calls": int(event["calls"]),
            "flops_est": cost["flops_est"] * per_exec,
            "flops_est_per_call": cost["flops_est"],
            "bytes": cost["bytes"],
            "op": cost["op"],
            "scope": cost.get("scope"),
            **({"input_dims": cost["input_dims"]}
               if cost.get("input_dims") else {}),
        })
    scale = (flops_total / est_total
             if flops_total > 0 and est_total > 0 else 1.0)
    window_time_us = sum(e["time_us"] for e in events.values())
    for row in rows:
        row["flops"] = row["flops_est"] * scale
        row["time_share"] = (row["time_us"] / matched_time
                             if matched_time else 0.0)
        # Intensity is a PER-CALL property (flops/byte of one kernel
        # launch): a kernel called T times per execution has T-times the
        # aggregate flops but the same per-call bytes.
        row["intensity"] = (row["flops_est_per_call"] / row["bytes"]
                            if row["bytes"] else 0.0)
        seconds = row["time_us"] / 1e6
        achieved = (row["flops"] * executions / seconds
                    if seconds > 0 else 0.0)
        row["mfu"] = (achieved / peak_flops if peak_flops else 0.0)
    rows.sort(key=lambda r: -r["time_us"])

    unmatched = sorted(
        ({"name": name, "time_us": round(e["time_us"], 3),
          "calls": int(e["calls"])}
         for name, e in events.items() if name not in costs),
        key=lambda r: -r["time_us"])

    worst = None
    for row in rows:
        if row["mfu"] <= 0 or row["time_share"] < WORST_MIN_TIME_SHARE:
            continue
        if worst is None or row["mfu"] < worst["mfu"]:
            worst = row
    dominant = rows[0] if rows else None
    # Matched device time by scope (learner, or unattributed).
    scope_time: Dict[str, float] = {}
    for row in rows:
        key = row["scope"] or "unattributed"
        scope_time[key] = scope_time.get(key, 0.0) + row["time_us"]
    scope_time_shares = {
        key: value / matched_time
        for key, value in sorted(scope_time.items())
    } if matched_time else {}
    return {
        "schema_version": _SCHEMA_VERSION,
        "executions": executions,
        "flops_total": flops_total,
        "flops_est_total": est_total,
        "flops_scale": scale,
        "peak_flops": peak_flops,
        "matched_time_us": round(matched_time, 3),
        "matched_time_frac": (matched_time / window_time_us
                              if window_time_us else 0.0),
        "kernels": rows,
        "unmatched_events": unmatched[:16],
        "worst_kernel": worst["name"] if worst else None,
        "worst_kernel_mfu": worst["mfu"] if worst else None,
        "dominant_kernel": dominant["name"] if dominant else None,
        "dominant_time_share": (dominant["time_share"] if dominant
                                else None),
        "scope_time_shares": scope_time_shares,
    }


def write_kernels_json(logdir: str, table: dict,
                       extra: Optional[dict] = None,
                       name: str = KERNELS_JSON_NAME) -> str:
    """Atomically persist the kernel table as ``<logdir>/<name>``
    (default ``kernels.json``; the health plane writes anomaly windows
    as ``kernels.<anomaly_id>.json``)."""
    payload = dict(table)
    if extra:
        payload.update(extra)
    path = os.path.join(logdir, name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path


# -- registry export + verdict hand-off --------------------------------------

# Last published verdict, gated on registry identity like the ledger's
# stall hand-off: the stall attributor (obs/stall.py) reads it to name
# the worst kernel inside a device_bound verdict, and a table published
# against a private registry must not leak into another run's verdict.
_last_lock = threading.Lock()
_last: Dict[str, object] = {}
_GAUGE_UNSAFE = re.compile(r"[^\w.\-]")


def publish_kernel_metrics(table: dict, registry=None) -> None:
    """Fold the table head into the metrics registry: per-kernel
    ``kernel/<name>/mfu`` + ``kernel/<name>/time_share`` gauges for the
    top ``PUBLISH_TOP_N`` kernels by time, plus the verdict gauges
    ``kernel/worst_mfu`` / ``kernel/dominant_time_share`` and the
    match-coverage gauge.  A gauge's ``<name>`` is the row's with every
    character outside ``[A-Za-z0-9_.-]`` as ``_`` (a demangled template
    or an aten op name is no metric name)."""
    from scalable_agent_tpu_torch.obs.registry import get_registry

    registry = registry or get_registry()
    for row in table["kernels"][:PUBLISH_TOP_N]:
        label = _GAUGE_UNSAFE.sub("_", row["name"])
        registry.gauge(
            f"kernel/{label}/mfu",
            "roofline MFU of this kernel in the last profile window"
        ).set(row["mfu"])
        registry.gauge(
            f"kernel/{label}/time_share",
            "share of matched device time in the last profile window"
        ).set(row["time_share"])
    if table.get("worst_kernel") is not None:
        registry.gauge(
            "kernel/worst_mfu",
            "lowest roofline MFU among kernels above the time-share "
            "floor (the roofline target)").set(
                table["worst_kernel_mfu"] or 0.0)
    if table.get("dominant_kernel") is not None:
        registry.gauge(
            "kernel/dominant_time_share",
            "time share of the single largest kernel").set(
                table["dominant_time_share"] or 0.0)
    registry.gauge(
        "kernel/matched_time_frac",
        "fraction of the window's learner kernel time with a cost").set(
            table.get("matched_time_frac", 0.0))
    with _last_lock:
        _last["registry"] = registry
        _last["worst"] = ((table["worst_kernel"],
                           table["worst_kernel_mfu"])
                          if table.get("worst_kernel") else None)
        _last["dominant"] = ((table["dominant_kernel"],
                              table["dominant_time_share"])
                             if table.get("dominant_kernel") else None)


def last_worst(registry) -> Optional[Tuple[str, float]]:
    """(name, mfu) of the worst kernel from the last table published
    against ``registry``; None when none was, or it was another
    registry's."""
    with _last_lock:
        if _last.get("registry") is not registry:
            return None
        return _last.get("worst")


def last_dominant(registry) -> Optional[Tuple[str, float]]:
    with _last_lock:
        if _last.get("registry") is not registry:
            return None
        return _last.get("dominant")


# -- the driver entry point --------------------------------------------------


def harvest(profile_dir: str, device: str, flops_total: float,
            peak_flops: Optional[float], logdir: Optional[str],
            registry=None, executions: int = 1,
            handwritten: Optional[Mapping[str, dict]] = None,
            extra: Optional[dict] = None,
            out_name: str = KERNELS_JSON_NAME) -> Optional[dict]:
    """Build, persist and publish the kernel table of the newest trace
    under ``profile_dir`` (``device``: ``cuda`` or ``cpu``) over its last
    ``executions`` updates (``join_trace``).  Returns the
    table, or None when there is no readable trace or it holds no row
    (a ``cuda`` window without a learner kernel is logged, never read
    from its CPU ops); never raises on a missing or unreadable trace."""
    path = find_profiler_trace(profile_dir)
    if path is None:
        return None
    try:
        events = _load_events(path)
    except (OSError, ValueError):
        log.warning("kernel table: cannot read %s", path)
        return None
    rows, costs = join_trace(events, device, handwritten, executions)
    if not rows:
        if device != "cpu":
            log.warning("kernel table: %s holds no kernel event launched "
                        "by the learner", path)
        return None
    table = build_kernel_table(rows, costs, flops_total=flops_total,
                               peak_flops=peak_flops,
                               executions=executions)
    if logdir:
        write_kernels_json(logdir, table, extra=extra, name=out_name)
    publish_kernel_metrics(table, registry=registry)
    return table
