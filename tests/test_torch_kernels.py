"""The port's kernel table (``obs/kernels.py``) held against the live JAX
module, and its own pieces.

- The table and its consumers are the JAX ones: the same rows and costs
  give the same table, ``kernels.json`` and ``kernel/*`` gauges, exactly;
  the stall attributor names the worst kernel of a device-bound interval
  as the JAX one does.
- Twins of ``tests/test_kernel_ledger.py``'s trace-join tests: a real
  ``torch.profiler`` window over a learner update on the CPU, written by
  the test, harvests into a table whose FLOPs sum to ``update_flops``
  (and whose costs, before normalization, already do); a directory
  without a trace gives None; the thread filter (the counterpart of the
  HLO-module filter) keeps the learner's kernels and drops an actor's, on
  a synthetic CUDA trace.
- The port's own pieces: ``kernel_name`` on real demangled names of every
  hand-written kernel in both variants; the correlation and thread join,
  the scopes, the library ops' costs split over their kernels; the
  hand-written costs at the main path's shapes plus the library ops'
  FLOPs equal ``update_flops``; ``op_cost`` equals
  ``FlopCounterMode``'s count; a ``cuda`` window without kernel events
  gives None and never falls back to the CPU ops.
- A ``--profile_dir`` driver run on the CPU writes ``kernels.json`` and
  the gauges (``test_traced_driver_run_writes_kernel_ledger``'s twin,
  without the report CLI).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from scalable_agent_tpu.obs import kernels as jax_kernels
from scalable_agent_tpu.obs import stall as jax_stall
from scalable_agent_tpu.obs.registry import MetricsRegistry as JaxRegistry
from scalable_agent_tpu_torch import driver, obs
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.models.networks import (
    CONV_STACK,
    TORSO_SIZE,
    same_pads,
)
from scalable_agent_tpu_torch.obs import kernels, stall
from scalable_agent_tpu_torch.obs import registry as registry_lib
from scalable_agent_tpu_torch.obs.registry import MetricsRegistry
from scalable_agent_tpu_torch.runtime import (
    Learner,
    LearnerHyperparams,
    Trajectory,
)
from scalable_agent_tpu_torch.runtime.learner import update_flops
from scalable_agent_tpu_torch.types import (
    AgentOutput,
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)

A = 5

# Demangled names as the profiler prints the hand-written kernels (each in
# an anonymous namespace), by the key of their cost entry.
DEMANGLED = {
    "sgemm_kernel<true": [
        "void (anonymous namespace)::sgemm_kernel<true, float>(float "
        "const*, long long, long long, float const*, long long, long long,"
        " float*, float const*, int, int, int)",
        "void (anonymous namespace)::sgemm_kernel<true, __nv_bfloat16>("
        "float const*, long long, long long, float const*, long long, "
        "long long, float*, float const*, int, int, int)"],
    "sgemm_kernel<false": [
        "void (anonymous namespace)::sgemm_kernel<false, float>(float "
        "const*, long long, long long, float const*, long long, long long,"
        " float*, float const*, int, int, int)"],
    "lstm_resid_kernel": [
        "void (anonymous namespace)::lstm_resid_kernel<4, float>(float "
        "const*, float const*, float const*, float const*, float const*, "
        "float*, float*, float*, float*, float*, float*, float*, int, int, "
        "int, int)",
        "void (anonymous namespace)::lstm_resid_kernel<4, __nv_bfloat16>("
        "float const*, float const*, float const*, float const*, float "
        "const*, float*, float*, float*, float*, float*, float*, float*, "
        "int, int, int, int)"],
    "lstm_lean_unroll_kernel": [
        "void (anonymous namespace)::lstm_lean_unroll_kernel<4, float>("
        "float const*, float const*, float const*, float const*, float "
        "const*, float*, float*, float*, float*, float*, float*, float*, "
        "int, int, int, int)",
        "void (anonymous namespace)::lstm_lean_unroll_kernel<4, "
        "__nv_bfloat16>(float const*, float const*, float const*, float "
        "const*, float const*, float*, float*, float*, float*, float*, "
        "float*, float*, int, int, int, int)"],
    "bptt_chain_kernel": [
        "void (anonymous namespace)::bptt_chain_kernel<4, float>(float "
        "const*, float const*, float const*, float const*, float const*, "
        "float const*, float const*, float const*, float*, float*, float*, "
        "float*, int, int, int, int)",
        "void (anonymous namespace)::bptt_chain_kernel<4, __nv_bfloat16>("
        "float const*, float const*, float const*, float const*, float "
        "const*, float const*, float const*, float const*, __nv_bfloat16*,"
        " float*, float*, float*, int, int, int, int)"],
    "bptt_dx_kernel": [
        "(anonymous namespace)::bptt_dx_kernel(__nv_bfloat16 const*, float "
        "const*, float*, int, int, int)"],
    "bptt_dw_kernel": [
        "(anonymous namespace)::bptt_dw_kernel(float const*, float const*, "
        "__nv_bfloat16 const*, float*, int, int, int, int)"],
    "bptt_reduce_kernel": [
        "(anonymous namespace)::bptt_reduce_kernel(float const*, float*, "
        "float const*, float*, float*, int, int, int, int)"],
    "conv_gradw_band_kernel": [
        "void (anonymous namespace)::conv_gradw_band_kernel<3, 3, false, "
        "true>(float const*, float const*, float*, (anonymous namespace)::"
        "Geometry, long long)",
        "void (anonymous namespace)::conv_gradw_band_kernel<1, 1, true, "
        "true>(float const*, float const*, float*, (anonymous namespace)::"
        "Geometry, long long)"],
    "conv_gradw_mma_kernel": [
        "void (anonymous namespace)::conv_gradw_mma_kernel<3, false, false>"
        "(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, (anonymous "
        "namespace)::MmaGeometry, long long)"],
    "reduce_partials_kernel": [
        "(anonymous namespace)::reduce_partials_kernel(float const*, "
        "float*, int, int)"],
    "vtrace_chunked_kernel": [
        "void (anonymous namespace)::vtrace_chunked_kernel<8>(float const*,"
        " float const*, float const*, float const*, float const*, float*, "
        "float*, int, int, int, float, float, float)"],
}


@pytest.mark.parametrize("key", sorted(DEMANGLED))
def test_kernel_name_keeps_templates_and_drops_parameters(key):
    names = [kernels.kernel_name(raw) for raw in DEMANGLED[key]]
    assert len(set(names)) == len(names)  # the variants stay apart
    for name in names:
        assert name.startswith(key) and "(" not in name
        assert not name.startswith("void")
    costs = {**kernels.handwritten_costs((72, 96, 3), 9, 100, 32,
                                         loss="impact"),
             **kernels.handwritten_costs((72, 96, 3), 9, 100, 32,
                                         compute_dtype="float32")}
    for name in names:
        assert kernels._handwritten_entry(name, costs) is costs[key]


def test_kernel_name_on_library_names():
    assert kernels.kernel_name(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
        "at::native::FillFunctor<float>, std::array<char*, 1ul>)") == (
        "at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>, std::array<char*, 1ul> >")
    lam = ("void at::native::elementwise_kernel<128, 2, at::native::"
           "gpu_kernel_impl<at::native::AddFunctor<float> >(at::"
           "TensorIteratorBase&, at::native::AddFunctor<float> const&)::"
           "{lambda(int)#1}>(int, at::native::gpu_kernel_impl<at::native::"
           "AddFunctor<float> >(at::TensorIteratorBase&, at::native::"
           "AddFunctor<float> const&)::{lambda(int)#1})")
    assert kernels.kernel_name(lam).endswith("{lambda(int)#1}>")
    assert kernels.kernel_name("sm90_xmma_gemm_bf16bf16_bf16f32") == (
        "sm90_xmma_gemm_bf16bf16_bf16f32")
    assert kernels.kernel_name("Memcpy DtoD (Device -> Device)") == (
        "Memcpy DtoD")


def _library_ops(frame, num_actions, t, b, hidden):
    """(name, args) of the library products and convolutions of one
    update at these shapes, as the profiler records them: the torso's
    convolutions (the stem's forward only: its weight gradient is
    hand-written, its input takes none), fc and the heads, forward and
    backward."""
    n = (t + 1) * b
    height, width, channels = frame
    ops = []
    for i, (out_channels, kernel, stride) in enumerate(CONV_STACK):
        out_h, (top, bottom) = same_pads(height, kernel, stride)
        out_w, (left, right) = same_pads(width, kernel, stride)
        pad_h = height + top + bottom - 2 * top
        pad_w = width + left + right - 2 * left
        x = [n, channels, pad_h, pad_w]
        w = [out_channels, channels, kernel, kernel]
        ops.append(("aten::convolution", {
            "Input Dims": [x, w, [], [], [], [], [], [], []],
            "Concrete Inputs": ["", "", "", f"[{stride}, {stride}]",
                                f"[{top}, {left}]", "[1, 1]", "False",
                                "[0, 0]", "1"]}))
        if i:
            ops.append(("aten::convolution_backward", {
                "Input Dims": [[n, out_channels, out_h, out_w], x, w] + [[]]
                * 8,
                "Concrete Inputs": [""] * 10 + ["[True, True, False]"]}))
        height, width, channels = out_h, out_w, out_channels
    flat = height * width * channels
    for rows, inner, cols in ((n, flat, TORSO_SIZE),
                              (n, hidden, num_actions),
                              (n, hidden, 1)):
        ops.append(("aten::mm", {"Input Dims": [[rows, inner],
                                                [inner, cols]]}))
        ops.append(("aten::mm", {"Input Dims": [[inner, rows],
                                                [rows, cols]]}))
        ops.append(("aten::mm", {"Input Dims": [[rows, cols],
                                                [cols, inner]]}))
    return ops


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("frame,num_actions,t,b,hidden", [
    ((72, 96, 3), 9, 100, 32, 256),   # the main path
    ((16, 16, 3), 4, 16, 16, 256),    # the bandit
    ((16, 16, 3), 8, 100, 32, 256)])  # fake_tuple: 3 + 5 logits, D=265
def test_costs_at_the_path_shapes_sum_to_update_flops(
        compute_dtype, frame, num_actions, t, b, hidden):
    costs = kernels.handwritten_costs(frame, num_actions, t, b,
                                      core_size=hidden,
                                      compute_dtype=compute_dtype)
    handwritten = sum(c["flops_est"] * c["calls"] for c in costs.values())
    library = sum(kernels.op_cost(name, args)[0]
                  for name, args in _library_ops(frame, num_actions, t, b,
                                                 hidden))
    want = update_flops(frame, num_actions, t, b, core_size=hidden)
    assert handwritten + library == pytest.approx(want, rel=1e-12)
    bf16 = compute_dtype == "bfloat16"
    assert set(costs) == {
        "sgemm_kernel<true", "lstm_resid_kernel", "bptt_chain_kernel",
        "bptt_reduce_kernel", "reduce_partials_kernel",
        "vtrace_chunked_kernel"} | (
        {"bptt_dx_kernel", "bptt_dw_kernel", "conv_gradw_mma_kernel"}
        if bf16 else {"sgemm_kernel<false", "conv_gradw_band_kernel"})
    assert all(c["bytes"] > 0 for c in costs.values())
    # x.Wi reads x [3232, 266] and Wi, writes pre [3232, 1024]: float32.
    if frame == (72, 96, 3):
        assert costs["sgemm_kernel<true"]["bytes"] == 4 * (
            3232 * 266 + 266 * 1024 + 1024 + 3232 * 1024)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_impact_costs_add_the_target_unroll(compute_dtype):
    """``loss="impact"`` adds the target network's core over the T+1 steps:
    the input-projection GEMM a second time and the lean recurrence
    (``lstm_lean_unroll_kernel``, no residuals written), whose products
    are exactly the target core's 2 * m * (D+H) * 4H FLOPs."""
    shapes = ((72, 96, 3), 9, 100, 32)
    vtrace = kernels.handwritten_costs(*shapes, compute_dtype=compute_dtype)
    impact = kernels.handwritten_costs(*shapes, compute_dtype=compute_dtype,
                                       loss="impact")
    assert set(impact) == set(vtrace) | {"lstm_lean_unroll_kernel"}
    total = lambda costs: sum(c["flops_est"] * c["calls"]
                              for c in costs.values())
    m, d, g = 101 * 32, 256 + 1 + 9, 4 * 256
    assert total(impact) - total(vtrace) == 2 * m * (d + 256) * g
    gemm, lean = impact["sgemm_kernel<true"], impact["lstm_lean_unroll_kernel"]
    assert gemm["calls"] == 2 and lean["calls"] == 1
    assert gemm["flops_est"] == vtrace["sgemm_kernel<true"]["flops_est"]
    assert gemm["bytes"] == vtrace["sgemm_kernel<true"]["bytes"]
    # The lean recurrence reads pre, done, the carries and Wh and writes
    # ys and the final carry: the residual recurrence less its residuals.
    resid = vtrace["lstm_resid_kernel"]
    assert resid["bytes"] - lean["bytes"] == 4 * m * (4 * 256 + 3 * 256)


def test_op_cost_equals_the_flop_counter():
    """The same forward and backward, once under the counter and once
    under the profiler (the counter's dispatch mode would be recorded as
    ops of its own)."""
    gen = torch.Generator().manual_seed(0)

    def work():
        x = torch.randn(3, 4, 11, 13, generator=gen, requires_grad=True)
        w = torch.randn(6, 4, 3, 3, generator=gen, requires_grad=True)
        m = torch.randn(5, 7, generator=gen, requires_grad=True)
        v = torch.randn(7, 2, generator=gen, requires_grad=True)
        y = F.conv2d(x, w, None, 2, (1, 1))
        z = torch.addmm(torch.zeros(2), m, v) @ torch.randn(2, 3)
        e = torch.bmm(torch.randn(2, 3, 4), torch.randn(2, 4, 5))
        (y.sum() + z.sum() + e.sum()).backward()

    with FlopCounterMode(display=False) as counter:
        work()
    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as prof:
        work()
    total = 0.0
    for event in prof.events():
        args = {"Input Dims": event.input_shapes,
                "Concrete Inputs": [str(c) if c is not None else ""
                                    for c in event.concrete_inputs]}
        cost = kernels.op_cost(event.name, args)
        total += cost[0] if cost else 0.0
    assert total == counter.get_total_flops() > 0


def _trajectory(frame, t, b, hidden, seed=1):
    rng = np.random.default_rng(seed)
    zeros = torch.zeros((t + 1, b))
    return Trajectory(
        agent_state=AgentState(c=torch.zeros(b, hidden),
                               h=torch.zeros(b, hidden)),
        env_outputs=StepOutput(
            reward=torch.tensor(rng.standard_normal((t + 1, b)),
                                dtype=torch.float32),
            info=StepOutputInfo(zeros, zeros),
            done=torch.tensor(rng.random((t + 1, b)) < 0.2),
            observation=Observation(frame=torch.tensor(rng.integers(
                0, 256, (t + 1, b) + frame, dtype=np.uint8)))),
        agent_outputs=AgentOutput(
            action=torch.tensor(rng.integers(0, A, (t + 1, b))),
            policy_logits=torch.zeros((t + 1, b, A)),
            baseline=torch.zeros((t + 1, b))))


@pytest.fixture
def registry(monkeypatch):
    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    return registry


class TestTraceJoin:
    @pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
    def test_harvest_roundtrip(self, tmp_path, registry, compute_dtype):
        """A real window over ``executions`` CPU updates (the tracer
        annotating, as the driver's window does): the rows are the
        learner's top-level ops, their costs sum to ``update_flops`` before
        the normalization too, and the table persists and publishes."""
        frame, t, b, hidden = (16, 16, 3), 3, 2, 16
        agent = ImpalaAgent(A, frame, core_size=hidden,
                            generator=torch.Generator().manual_seed(0),
                            compute_dtype=getattr(torch, compute_dtype))
        learner = Learner(agent, LearnerHyperparams(), t * b)
        traj = _trajectory(frame, t, b, hidden)
        learner.update(traj)  # warm
        executions = 2
        profiler = driver._start_profile(torch.device("cpu"))
        for _ in range(executions):
            learner.update(traj)
        driver._stop_profile(profiler, torch.device("cpu"),
                             str(tmp_path / "prof"))
        flops = update_flops(frame, A, t, b, core_size=hidden)
        table = kernels.harvest(
            str(tmp_path / "prof"), "cpu", flops, 1e12,
            str(tmp_path / "run"), registry=registry,
            executions=executions)
        assert table is not None and table["kernels"], table
        assert sum(row["flops"] for row in table["kernels"]) \
            == pytest.approx(flops, rel=1e-9)
        assert table["flops_est_total"] == pytest.approx(flops, rel=1e-9)
        assert table["flops_total"] == flops
        assert table["scope_time_shares"] == {
            "learner": pytest.approx(1.0)}
        assert all(row["calls"] % executions == 0
                   for row in table["kernels"])
        persisted = json.loads((tmp_path / "run" / "kernels.json")
                               .read_text())
        assert persisted["dominant_kernel"] == table["dominant_kernel"]
        snap = registry.snapshot()
        assert "kernel/matched_time_frac" in snap
        assert kernels.last_dominant(registry)[0] == table["dominant_kernel"]
        assert kernels.last_dominant(MetricsRegistry()) is None

    def test_harvest_without_traces_returns_none(self, tmp_path):
        assert kernels.harvest(str(tmp_path / "nothing"), "cuda", 0.0,
                               None, None) is None
        (tmp_path / "torn").mkdir()
        (tmp_path / "torn" / "torch_profile.1.json").write_text('{"tra')
        assert kernels.harvest(str(tmp_path / "torn"), "cpu", 0.0, None,
                               None) is None

    def test_trace_events_filter_by_learner_thread(self):
        """The counterpart of the JAX HLO-module filter: a kernel launched
        by another thread (an actor's step kernel) is not a row; the
        learner's and the autograd thread's are, joined through their
        launches' correlation ids."""
        rows, costs = kernels.join_trace(_synthetic_trace(), "cuda",
                                         HANDWRITTEN)
        assert not any("lstm_step" in name for name in rows)
        assert "never_launched" not in rows
        assert rows["sgemm_kernel<true, __nv_bfloat16>"] == {
            "time_us": 140.0, "calls": 1.0}
        assert rows["cudnn_wgrad"] == {"time_us": 40.0, "calls": 1.0}


HANDWRITTEN = kernels.handwritten_costs((16, 16, 3), A, 3, 2,
                                        core_size=16)
CONV = {"Input Dims": [[8, 3, 16, 16], [32, 3, 8, 8], [], [], [], [], [],
                       [], []],
        "Concrete Inputs": ["", "", "", "[4, 4]", "[2, 2]", "[1, 1]",
                            "False", "[0, 0]", "1"],
        "Input type": ["c10::BFloat16", "c10::BFloat16"]}
CONV_BWD = {"Input Dims": [[8, 64, 2, 2], [8, 32, 4, 4], [64, 32, 4, 4]]
            + [[]] * 8,
            "Concrete Inputs": [""] * 10 + ["[True, True, False]"],
            "Input type": ["float", "float", "float"]}


def _x(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "tid": tid, "pid": 1,
            "ts": ts, "dur": dur, "args": args}


def _synthetic_trace():
    """A window as torch.profiler writes it on the card: the learner
    thread (1) with the update range, the autograd thread (2) with the
    backward, an actor thread (3), and the device's kernels."""
    ext = "External id"
    return [
        {"ph": "M", "name": "thread_name", "tid": 1, "pid": 1},
        _x("learner/update", "user_annotation", 1, 100, 1000),
        _x("aten::conv2d", "cpu_op", 1, 110, 100, **{ext: 10}),
        _x("aten::convolution", "cpu_op", 1, 111, 98, **{ext: 11}, **CONV),
        _x("aten::cudnn_convolution", "cpu_op", 1, 112, 90, **{ext: 12}),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 115, 5,
           correlation=1000, **{ext: 12}),
        _x("void cudnn::engine<bf16>(Params)", "kernel", 0, 2000, 50,
           correlation=1000, **{ext: 12}),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 300, 5,
           correlation=1001, **{ext: 0}),
        _x(DEMANGLED["sgemm_kernel<true"][1], "kernel", 0, 2100, 140,
           correlation=1001, **{ext: 0}),
        _x("autograd::engine::evaluate_function: ConvolutionBackward0",
           "cpu_op", 2, 500, 200, **{ext: 20}),
        _x("aten::convolution_backward", "cpu_op", 2, 505, 190,
           **{ext: 21}, **CONV_BWD),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 510, 5,
           correlation=1002, **{ext: 21}),
        _x("cudnn_dgrad", "kernel", 0, 2300, 60, correlation=1002,
           **{ext: 21}),
        _x("cudaLaunchKernelExC", "cuda_driver", 2, 520, 5,
           correlation=1003, **{ext: 21}),
        _x("cudnn_wgrad", "kernel", 0, 2400, 40, correlation=1003,
           **{ext: 21}),
        _x("aten::add_", "cpu_op", 1, 700, 10, **{ext: 30},
           **{"Input Dims": [[8, 32], [8, 32], []],
              "Input type": ["float", "float", "Scalar"]}),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 702, 5,
           correlation=1004, **{ext: 30}),
        _x("void at::native::add_kernel<float>(int, float)", "kernel", 0,
           2500, 5, correlation=1004, **{ext: 30}),
        _x("aten::relu", "cpu_op", 1, 750, 10, **{ext: 35},
           **{"Input Dims": [[8, 32]], "Input type": ["float"]}),
        # A launch under another id for the learner's thread: its kernel
        # still names the learner's op.
        _x("cudaLaunchKernel", "cuda_runtime", 140277, 752, 5,
           correlation=1009),
        _x("relu_kernel", "kernel", 0, 2550, 4, correlation=1009,
           **{ext: 35}),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 800, 5,
           correlation=1005, **{ext: 0}),
        _x("mystery_kernel", "kernel", 0, 2600, 7, correlation=1005),
        _x("aten::copy_", "cpu_op", 1, 1495, 20, **{ext: 40}),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 1500, 5,
           correlation=1006, **{ext: 40}),
        _x("copy_kernel", "kernel", 0, 2700, 9, correlation=1006,
           **{ext: 40}),
        _x("cudaLaunchKernelExC", "cuda_runtime", 3, 400, 5,
           correlation=1007, **{ext: 0}),
        _x("void (anonymous namespace)::lstm_step_mma_kernel<8, 16>(float "
           "const*)", "kernel", 0, 2800, 12, correlation=1007),
        _x("never_launched", "kernel", 0, 2900, 3, correlation=9999),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 3000, 30,
           correlation=1008),
    ]


def test_join_costs_scopes_and_unmatched():
    rows, costs = kernels.join_trace(_synthetic_trace(), "cuda",
                                     HANDWRITTEN)
    assert set(rows) == {
        "cudnn::engine<bf16>", "sgemm_kernel<true, __nv_bfloat16>",
        "cudnn_dgrad", "cudnn_wgrad", "at::native::add_kernel<float>",
        "relu_kernel", "mystery_kernel", "copy_kernel"}
    assert costs["relu_kernel"]["op"] == "aten::relu"
    # The stem's forward, costed by aten::convolution from the innermost
    # op's External id up: 2 * 8 * 32 * 3 * 8 * 8 * 4 * 4 FLOPs.
    conv = costs["cudnn::engine<bf16>"]
    assert conv["flops_est"] == 2 * 8 * 32 * 3 * 8 * 8 * 4 * 4
    assert conv["op"] == "aten::convolution"
    assert conv["input_dims"] == CONV["Input Dims"]
    assert conv["bytes"] == 2 * (8 * 3 * 16 * 16 + 32 * 3 * 8 * 8)
    assert conv["scope"] == "learner"
    # The backward's two kernels split its FLOPs 60:40 by their time.
    both = 2 * (2 * 8 * 64 * 32 * 4 * 4 * 2 * 2)
    assert costs["cudnn_dgrad"]["flops_est"] == pytest.approx(0.6 * both)
    assert costs["cudnn_wgrad"]["flops_est"] == pytest.approx(0.4 * both)
    assert costs["cudnn_wgrad"]["op"] == "aten::convolution_backward"
    # A hand-written kernel is costed from its entry, not from an op.
    entry = HANDWRITTEN["sgemm_kernel<true"]
    assert costs["sgemm_kernel<true, __nv_bfloat16>"] == {
        "flops_est": entry["flops_est"], "bytes": entry["bytes"],
        "op": "csrc/lstm.cu", "scope": "learner"}
    # Elementwise: 0 FLOPs, the op's input bytes.
    add = costs["at::native::add_kernel<float>"]
    assert (add["flops_est"], add["bytes"], add["op"]) == (
        0.0, 2 * 4 * 8 * 32, "aten::add_")
    # Launched by the learner after its update: unattributed.
    assert costs["copy_kernel"]["scope"] == "unattributed"
    # No op, no entry: uncosted.
    assert "mystery_kernel" not in costs
    table = kernels.build_kernel_table(rows, costs, flops_total=1e9,
                                       peak_flops=1e12)
    assert table["unmatched_events"] == [
        {"name": "mystery_kernel", "time_us": 7.0, "calls": 1}]
    assert table["matched_time_frac"] == pytest.approx(308.0 / 315.0)
    assert table["dominant_kernel"] == "sgemm_kernel<true, __nv_bfloat16>"
    assert set(table["scope_time_shares"]) == {"learner", "unattributed"}


def test_only_the_last_executions_updates_count():
    """A window's warm-up update stays out of its table: with
    ``executions`` the join starts at the last ``executions`` update
    ranges, on both devices."""
    later = [_x("learner/update", "user_annotation", 1, 5000, 500),
             _x("aten::mm", "cpu_op", 1, 5010, 50, **{"External id": 50},
                **{"Input Dims": [[4, 8], [8, 2]],
                   "Input type": ["float", "float"]}),
             _x("cudaLaunchKernel", "cuda_runtime", 1, 5020, 5,
                correlation=2000),
             _x("gemm_kernel", "kernel", 0, 6000, 30, correlation=2000,
                **{"External id": 50})]
    events = _synthetic_trace() + later
    rows, costs = kernels.join_trace(events, "cuda", HANDWRITTEN,
                                     executions=1)
    assert rows == {"gemm_kernel": {"time_us": 30.0, "calls": 1.0}}
    assert costs["gemm_kernel"]["flops_est"] == 2 * 4 * 8 * 2
    assert len(kernels.join_trace(events, "cuda", HANDWRITTEN,
                                  executions=2)[0]) == 9
    cpu_rows, _ = kernels.join_trace(events, "cpu", executions=1)
    assert cpu_rows == {"aten::mm": {"time_us": 50.0, "calls": 1.0}}
    assert "aten::conv2d" in kernels.join_trace(events, "cpu")[0]


def test_cuda_window_without_kernels_never_reads_cpu_ops(tmp_path,
                                                        caplog):
    events = [e for e in _synthetic_trace() if e.get("cat") != "kernel"]
    (tmp_path / "torch_profile.7.json").write_text(
        json.dumps({"traceEvents": events}))
    assert kernels.join_trace(events, "cuda", HANDWRITTEN) == ({}, {})
    with caplog.at_level("WARNING", logger="scalable_agent_tpu_torch"):
        assert kernels.harvest(str(tmp_path), "cuda", 1e9, 1e12,
                               None) is None
    assert "no kernel event" in caplog.text
    # The same window read as a CPU one has rows: its ops.
    assert kernels.harvest(str(tmp_path), "cpu", 1e9, 1e12, None)


def _jax_costs(costs):
    return {name: {k: v for k, v in cost.items() if k != "input_dims"}
            for name, cost in costs.items()}


@pytest.mark.parametrize("executions,peak", [(1, 1e12), (3, None)])
def test_table_gauges_and_file_are_the_jax_ones(tmp_path, executions,
                                                peak):
    rows, costs = kernels.join_trace(_synthetic_trace(), "cuda",
                                     HANDWRITTEN)
    rows = {name: {"time_us": row["time_us"] * executions,
                   "calls": row["calls"] * executions}
            for name, row in rows.items()}
    costs = _jax_costs(costs)
    ours = kernels.build_kernel_table(rows, costs, 5e8, peak, executions)
    theirs = jax_kernels.build_kernel_table(rows, costs, 5e8, peak,
                                            executions)
    assert ours == theirs
    kernels.write_kernels_json(str(tmp_path / "a"), ours, extra={"x": 1},
                               name="kernels.a001-x.json")
    jax_kernels.write_kernels_json(str(tmp_path / "b"), theirs,
                                   extra={"x": 1},
                                   name="kernels.a001-x.json")
    assert ((tmp_path / "a" / "kernels.a001-x.json").read_text()
            == (tmp_path / "b" / "kernels.a001-x.json").read_text())
    ours_reg, theirs_reg = MetricsRegistry(), JaxRegistry()
    kernels.publish_kernel_metrics(ours, registry=ours_reg)
    jax_kernels.publish_kernel_metrics(theirs, registry=theirs_reg)
    unsafe = kernels._GAUGE_UNSAFE
    assert ours_reg.snapshot() == {
        f"kernel/{unsafe.sub('_', k[7:-4])}/mfu" if k.endswith("/mfu")
        and k[7:-4] in rows else
        f"kernel/{unsafe.sub('_', k[7:-11])}/time_share"
        if k.endswith("/time_share") and k[7:-11] in rows else k: v
        for k, v in theirs_reg.snapshot().items()}
    assert kernels.last_worst(ours_reg) == jax_kernels.last_worst(
        theirs_reg)
    assert kernels.last_worst(theirs_reg) is None


def test_device_bound_verdict_names_the_worst_kernel():
    """The stall hand-off: a device-bound interval's evidence carries the
    worst kernel of the table published against the same registry, as
    the JAX attributor's does; a private registry's verdict does not."""
    rows, costs = kernels.join_trace(_synthetic_trace(), "cuda",
                                     HANDWRITTEN)
    out = []
    for kernels_mod, stall_mod, registry in (
            (kernels, stall, MetricsRegistry()),
            (jax_kernels, jax_stall, JaxRegistry())):
        attributor = stall_mod.StallAttributor(registry)
        before = attributor.attribute(0.0, 1.0)
        kernels_mod.publish_kernel_metrics(kernels_mod.build_kernel_table(
            rows, _jax_costs(costs), 5e8, 1e12), registry=registry)
        category, evidence = attributor.attribute(0.0, 1.0)
        line = stall_mod.StallAttributor.describe(category, evidence)
        out.append((before, category, evidence, line))
    assert out[0] == out[1]
    (before, category, evidence, line) = out[0]
    assert "kernel_worst" not in before[1]
    assert category == "device_bound"
    assert evidence["kernel_worst"] and "worst kernel" in line
    starved = stall.StallAttributor(MetricsRegistry()).attribute(0.9, 0.1)
    assert "kernel_worst" not in starved[1]


def test_traced_driver_run_writes_kernel_ledger(tmp_path, monkeypatch,
                                                registry):
    monkeypatch.setenv("SCALABLE_AGENT_LEDGER_MFU_PEAK", "1e12")
    config = Config(
        device="cpu", mode="train", logdir=str(tmp_path / "run"),
        level_name="fake_small", num_actors=4, batch_size=2,
        unroll_length=4, num_action_repeats=1,
        total_environment_frames=24,  # 3 updates of 8 frames
        height=16, width=16, num_env_workers_per_group=2,
        compute_dtype="float32", checkpoint_interval_s=1e9,
        log_interval_s=0.0, profile_dir=str(tmp_path / "profile"),
        profile_start_update=1, profile_num_updates=1, seed=5)
    metrics = driver.train(config)
    assert metrics["env_frames"] == 24
    table = json.loads((tmp_path / "run" / "kernels.json").read_text())
    assert table["kernels"], table
    assert table["dominant_kernel"]
    assert table["flops_total"] == update_flops((16, 16, 3), 9, 4, 2)
    assert sum(row["flops"] for row in table["kernels"]) \
        == pytest.approx(table["flops_total"], rel=1e-6)
    assert table["peak_flops"] == 1e12 and table["device_kind"] == "cpu"
    assert list((tmp_path / "profile").glob("torch_profile.*.json"))
    prom = (tmp_path / "run" / "metrics.prom").read_text()
    assert "impala_kernel_matched_time_frac" in prom
    assert "impala_kernel_dominant_time_share" in prom
    # The override arms the live MFU gauge too, as in the JAX driver.
    assert registry.snapshot()["ledger/mfu"] > 0.0
    assert not os.path.exists(os.path.join(config.logdir,
                                           obs.ANOMALIES_JSONL))
