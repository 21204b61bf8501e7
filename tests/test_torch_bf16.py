"""The JAX package's default dtype policy, ``compute_dtype=bfloat16``, in
the port, held against the live JAX package on the CPU (Pallas in
interpret mode, as the JAX package's own tests run it).

- The LSTM's plain versions at ``matmul_dtype="bfloat16"`` against
  ``lstm_pallas`` at the same: forward outputs, every residual (``hpost``
  the float32 h), and the VJP (db from the float32 dgates).
- The stem grad-W's plain version at bf16 against ``conv_pallas.conv_gradw``
  at bf16, and the stem's dW rounded to the weight's dtype.
- The whole agent at bf16 against a JAX ``ImpalaAgent(compute_dtype=
  bfloat16, core_impl="pallas", core_matmul_dtype="bfloat16")``, and one
  learner update against a JAX ``Learner`` over that agent.
- ``core_matmul_dtype``'s resolution and errors against the JAX driver, the
  default ``Config``, the JAX params in a bf16-policy agent, and the CUDA
  routes (with a stand-in library) taking the bf16 entry points.

Tolerances, from measurements on these inputs.  Both sides round the same
operands to bf16 and sum the exact products in float32, so they differ in
summation order only -- until a last-bit difference in a float32 h flips
the bf16 rounding of that h at the next step.  LSTM: rtol/atol 2e-4 (the
worst measured is 5.7e-5, a flip at done_rate 0; the float32 policy is
2e-3 to 6e-3 away).  Grad-W: rtol 1e-5 / atol 1e-5 (float32 sums of exact
products).  Whole agent and learner: one band, rtol/atol 2e-2 on every
output and gradient (outputs and weight gradients agree to 1e-7; bias
gradients are sums of bf16 cotangents that each framework rounds to bf16
its own way, worst measured 4 bf16 ulps, 0.0078 on a 0.32 leaf), beside a
check that the port is at least 10x closer to the bf16 reference than to
the float32 one.  The loosest band allowed is tests/test_agent.py's rtol
0.1 / atol 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import driver as jax_driver
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs.spaces import Discrete as JaxDiscrete
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.ops import conv_pallas, lstm_pallas
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import (
    Config,
    resolve_core_matmul_dtype,
)
from scalable_agent_tpu_torch.envs import TensorSpec
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import conv_cuda, lstm_cuda
from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams

import test_torch_agent as agent_case
import test_torch_learner as learner_case
import test_torch_lstm as lstm_case

BF16 = "bfloat16"
LSTM_TOL = dict(rtol=2e-4, atol=2e-4)
GRADW_TOL = dict(rtol=1e-5, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)
ORDER = lstm_case.ORDER


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def _pallas_forward(arrays, matmul_dtype):
    """(ys, ifgo, cpost, hpost, cnew, cT, hT) of the Pallas residual
    forward (the VJP's primal) in interpret mode."""
    return lstm_pallas._fwd_call(
        *(jnp.asarray(arrays[k]) for k in ORDER), interpret=True,
        with_residuals=True, matmul_dtype=jnp.dtype(matmul_dtype))


# -- LSTM ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,done_rate", [(0, 0.3), (1, 0.0), (2, 1.0)])
def test_lstm_forward_and_residuals_match_pallas_bf16(seed, done_rate):
    arrays = lstm_case._inputs(seed, done_rate)
    want = _pallas_forward(arrays, BF16)
    t = lstm_case._torch(arrays)
    out = lstm_cuda.lstm_forward_plain(*(t[k] for k in ORDER),
                                       residuals=True, matmul_dtype=BF16)
    got = (out.ys, *out.residuals, out.c, out.h)
    names = ("ys", "ifgo", "cpost", "hpost", "cnew", "cT", "hT")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **LSTM_TOL)
    # The lean route (the wrapper, no gradient) gives the same ys and carry.
    ys, (c, h) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER), BF16)
    for name, g, w in (("ys", ys, want[0]), ("cT", c, want[5]),
                       ("hT", h, want[6])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **LSTM_TOL)
    # The rounding is real: the float32 policy is far further away.
    f32 = _pallas_forward(arrays, "float32")
    assert 10 * _max_err(out.ys, want[0]) < _max_err(out.ys, f32[0])


@pytest.mark.parametrize("seed,done_rate", [(3, 0.3), (4, 0.0)])
def test_lstm_vjp_matches_pallas_bf16(seed, done_rate):
    """Every gradient (x, c0, h0, Wi, Wh, b) for random cotangents against
    jax.vjp through the Pallas custom VJP at bf16: dgates, x and hpost are
    rounded for dx, dh_prev, dWi and dWh, and db sums the float32
    dgates."""
    arrays = lstm_case._inputs(seed, done_rate)
    rng = np.random.default_rng(seed + 10)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    T, B, H = lstm_case.T, lstm_case.B, lstm_case.H
    cot = (f32(T, B, H), f32(B, H), f32(B, H))
    keys = ("x", "c0", "h0", "wi", "wh", "b")

    def jax_grads(matmul_dtype):
        def f(x, c0, h0, wi, wh, b):
            return lstm_pallas.lstm_unroll(
                x, jnp.asarray(arrays["done"]), c0, h0, wi, wh, b, True,
                matmul_dtype)

        _, vjp = jax.vjp(f, *(jnp.asarray(arrays[k]) for k in keys))
        return vjp((jnp.asarray(cot[0]),
                    (jnp.asarray(cot[1]), jnp.asarray(cot[2]))))

    t = lstm_case._torch(arrays, requires_grad=True)
    ys, (c, h) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER), BF16)
    grads = torch.autograd.grad((ys, c, h), [t[k] for k in keys],
                                tuple(torch.tensor(a) for a in cot))
    want = jax_grads(BF16)
    for key, got, w in zip(keys, grads, want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=key,
                                   **LSTM_TOL)
    f32_wi = jax_grads("float32")[3]
    assert 10 * _max_err(grads[3], want[3]) < _max_err(grads[3], f32_wi)


@pytest.mark.parametrize("batch", [1, 33])
def test_lean_step_at_full_width_matches_pallas_bf16(batch):
    """The actor's T=1 step at the agent's width (D=266, H=256)."""
    rng = np.random.default_rng(batch)
    d, h = 266, 256
    f32 = lambda *shape, scale=1.0: (
        rng.standard_normal(shape) * scale).astype(np.float32)
    arrays = dict(x=f32(1, batch, d),
                  done=(rng.random((1, batch)) < 0.3).astype(np.float32),
                  c0=f32(batch, h, scale=0.5), h0=np.tanh(f32(batch, h)),
                  wi=f32(d, 4 * h, scale=d ** -0.5),
                  wh=f32(h, 4 * h, scale=h ** -0.5), b=f32(4 * h, scale=0.1))
    ys_j, (c_j, h_j) = lstm_pallas.lstm_unroll(
        *(jnp.asarray(arrays[k]) for k in ORDER), True, BF16)
    t = lstm_case._torch(arrays)
    with torch.no_grad():
        ys, (c, hh) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER), BF16)
    for got, want in ((ys, ys_j), (c, c_j), (hh, h_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LSTM_TOL)


def test_lstm_refuses_other_matmul_dtypes():
    t = lstm_case._torch(lstm_case._inputs(5))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lstm_cuda.lstm_unroll(*(t[k] for k in ORDER), "float16")


# -- stem grad-W --------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(16, 16), (17, 23), (72, 96)])
def test_gradw_plain_matches_pallas_bf16(h, w):
    """bf16 x and g through the wrapper (its plain version on the CPU)
    against the Pallas kernel at matmul_dtype="bfloat16", given the float32
    values (which it rounds) and given the bf16 ones."""
    rng = np.random.default_rng(h * w)
    n = 2 if h == 72 else 3
    x = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    g = rng.standard_normal((n, -(-h // 4), -(-w // 4), 32)).astype(
        np.float32)
    got = conv_cuda.conv_gradw(torch.tensor(x).bfloat16(),
                               torch.tensor(g).bfloat16(), 8, 4)
    assert got.dtype == torch.float32
    for dtype in (jnp.float32, jnp.bfloat16):
        want = conv_pallas.conv_gradw(
            jnp.asarray(x, dtype), jnp.asarray(g, dtype), 8, 4,
            interpret=True, matmul_dtype=BF16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRADW_TOL)
    f32 = conv_pallas.conv_gradw(jnp.asarray(x), jnp.asarray(g), 8, 4,
                                 interpret=True)
    assert 10 * _max_err(got, want) < _max_err(got, f32)


def test_stem_conv_bf16_value_and_dw_match_pallas():
    """The stem at bf16: its output, and dW summed in float32 then rounded
    to the bf16 weight (conv_pallas.py's VJP), within one bf16 ulp
    (rtol 2**-7) of the Pallas op's."""
    rng = np.random.default_rng(11)
    x = rng.random((3, 20, 24, 3)).astype(np.float32)
    k_hwio = (rng.standard_normal((8, 8, 3, 32)) * 0.05).astype(np.float32)
    ct = rng.standard_normal((3, 5, 6, 32)).astype(np.float32)
    xj, kj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k_hwio, jnp.bfloat16)
    out_j, vjp = jax.vjp(
        lambda ww: conv_pallas.stem_conv(xj, ww, 4, True, BF16), kj)
    dw_j, = vjp(jnp.asarray(ct, jnp.bfloat16))
    xt = torch.tensor(x).bfloat16().permute(0, 3, 1, 2)
    wt = torch.tensor(k_hwio).bfloat16().permute(3, 2, 0, 1).detach()
    wt.requires_grad_(True)
    out = conv_cuda.stem_conv(xt, wt, 4)
    dw, = torch.autograd.grad(
        out, wt, torch.tensor(ct).bfloat16().permute(0, 3, 1, 2))
    assert out.dtype == dw.dtype == torch.bfloat16
    ulp = dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(
        out.detach().permute(0, 2, 3, 1).float().numpy(),
        np.asarray(out_j, np.float32), **ulp)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).float().numpy(),
                               np.asarray(dw_j, np.float32), **ulp)


def test_gradw_refuses_mixed_and_other_dtypes():
    x = torch.zeros((1, 16, 16, 3))
    g = torch.zeros((1, 4, 4, 32))
    for xx, gg in ((x.bfloat16(), g), (x.half(), g.half())):
        with pytest.raises(ValueError, match="both float32 or both"):
            conv_cuda.conv_gradw(xx, gg, 8, 4)


# -- the whole agent and the learner ------------------------------------------


def _jax_agent(compute_dtype):
    bf16 = compute_dtype == BF16
    return JaxAgent(num_actions=agent_case.A, core_size=agent_case.H,
                    core_impl="pallas", conv_backend="pallas",
                    compute_dtype=jnp.dtype(compute_dtype),
                    core_matmul_dtype=BF16 if bf16 else "float32")


def _bf16_agent(frame_hw, params):
    agent = ImpalaAgent(agent_case.A, frame_hw + (3,),
                        core_size=agent_case.H,
                        compute_dtype=torch.bfloat16,
                        core_matmul_dtype=BF16)
    agent.load_state_dict(convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return agent


@pytest.mark.parametrize("frame_hw,T,B", [((16, 16), 5, 4),
                                          ((72, 96), 1, 2)])
def test_agent_bf16_matches_jax(frame_hw, T, B):
    """Logits, baseline, final carry and every parameter gradient."""
    d0 = agent_case._inputs(0, 2, 1, frame_hw)
    params = _jax_agent(BF16).init(jax.random.key(0),
                                   *agent_case._jax_args(d0))
    agent = _bf16_agent(frame_hw, params)
    d = agent_case._inputs(1, T, B, frame_hw)
    jargs = agent_case._jax_args(d)

    def reference(compute_dtype):
        jax_agent = _jax_agent(compute_dtype)

        def loss_j(p):
            (logits, baseline), state = jax_agent.apply(p, *jargs)
            loss = (jnp.sum(logits ** 2) + jnp.sum(baseline)
                    + jnp.sum(state.c) + jnp.sum(state.h ** 2))
            return loss, (logits, baseline, state.c, state.h)

        (_, outs), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
        return outs, convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, grads))

    (logits, baseline), state = agent(*agent_case._torch_args(d))
    loss = (logits.square().sum() + baseline.sum() + state.c.sum()
            + state.h.square().sum())
    names = [name for name, _ in agent.named_parameters()]
    grads = torch.autograd.grad(loss, list(agent.parameters()))
    outs = (logits, baseline, state.c, state.h)
    want_outs, want_grads = reference(BF16)
    for got, want in zip(outs, want_outs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **BAND)
    for name, got in zip(names, grads):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **BAND)
    f32_outs, _ = reference("float32")
    assert 10 * _max_err(logits.detach(), want_outs[0]) < _max_err(
        logits.detach(), f32_outs[0])


def test_jax_params_load_into_a_bf16_policy_agent():
    """convert.py's trees do not change with the policy: the JAX params
    load as they are, and every parameter stays float32."""
    d0 = agent_case._inputs(0, 2, 1, (16, 16))
    params = _jax_agent(BF16).init(jax.random.key(3),
                                   *agent_case._jax_args(d0))
    agent = _bf16_agent((16, 16), params)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             params))
    for name, value in agent.state_dict().items():
        assert value.dtype == torch.float32, name
        assert torch.equal(value, want[name]), name


def test_learner_update_bf16_matches_jax():
    """One update of a bf16-policy learner against the JAX learner over
    the JAX bf16 agent: the losses, and the parameter change in the band;
    parameters and RMSProp state stay float32."""
    d = learner_case._trajectory(0)
    jax_agent = _jax_agent(BF16)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    frames = learner_case.FRAMES_PER_UPDATE
    jax_learner = JaxLearner(
        jax_agent, JaxHp(total_environment_frames=1e3), mesh, frames,
        device_telemetry=False, learn_telemetry=False)
    state = jax_learner.init(jax.random.key(0), learner_case._jax_traj(d))
    start = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    state, metrics = jax_learner.update(state, learner_case._jax_traj(d))
    jax_end = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))

    agent = ImpalaAgent(learner_case.A, (16, 16, 3),
                        core_size=learner_case.H,
                        compute_dtype=torch.bfloat16,
                        core_matmul_dtype=BF16)
    agent.load_state_dict(start)
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=1e3), frames)
    got = learner.update(learner_case._torch_traj(d))
    for key in ("total_loss", "policy_gradient_loss", "baseline_loss",
                "entropy_loss"):
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(float(got[key]), float(metrics[key]),
                                   err_msg=key, **BAND)
    for name, param in agent.named_parameters():
        assert param.dtype == torch.float32, name
        assert learner.state.opt_state[name].dtype == torch.float32, name
        want = (jax_end[name] - start[name]).numpy()
        change = (param.detach() - start[name]).numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(change, want, rtol=0,
                                   atol=BAND["atol"] * scale, err_msg=name)


# -- configuration ------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("core_matmul_dtype", ["auto", "float32",
                                               "bfloat16"])
def test_core_matmul_dtype_resolves_as_the_jax_driver(compute_dtype,
                                                      core_matmul_dtype):
    """driver.py:234-246 for the fused ("pallas") core, the port's only
    core."""
    ours = Config(compute_dtype=compute_dtype,
                  core_matmul_dtype=core_matmul_dtype)
    theirs = JaxConfig(compute_dtype=compute_dtype,
                       core_matmul_dtype=core_matmul_dtype)
    assert resolve_core_matmul_dtype(ours) == (
        jax_driver.resolve_core_matmul_dtype(theirs, "pallas"))


@pytest.mark.parametrize("value", ["float16", "bf16"])
def test_core_matmul_dtype_rejects_as_the_jax_driver(value):
    """driver.py:264-268: the same ValueError, word for word."""
    with pytest.raises(ValueError) as theirs:
        jax_driver.build_agent(JaxConfig(core_matmul_dtype=value,
                                         core_impl="pallas"),
                               JaxDiscrete(4))
    with pytest.raises(ValueError) as ours:
        Config(core_matmul_dtype=value)
    assert str(ours.value) == str(theirs.value)


def test_default_config_runs_the_jax_default_policy():
    """Config() is bfloat16 as the JAX Config is, and build_agent turns it
    into a bf16 torso and heads over a bf16-operand core;
    --compute_dtype=float32 gives float32 and float32."""
    assert Config().compute_dtype == JaxConfig().compute_dtype == BF16
    spec = dataclasses.make_dataclass("Spec", ["frame"])(
        TensorSpec((16, 16, 3), np.uint8, "frame"))
    for argv, want in (([], (torch.bfloat16, BF16)),
                       (["--compute_dtype=float32"],
                        (torch.float32, "float32"))):
        config = Config.from_argv(["--device=cpu", *argv])
        agent = driver.build_agent(config, spec, Discrete(4),
                                   torch.device("cpu"))
        assert (agent.compute_dtype, agent.core_matmul_dtype) == want
        assert agent.convnet.dtype == want[0]


# -- the CUDA routes, with a stand-in library ---------------------------------


class _FakeLibrary:
    """Records which C entry point each launch took; every launch
    succeeds."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        if not name.startswith("sat_"):
            raise AttributeError(name)
        return lambda *args: self._calls.append(name) or 0


@pytest.fixture()
def fake_card(monkeypatch):
    calls = []
    library = _FakeLibrary(calls)
    forbidden = lambda *a, **k: pytest.fail("the CUDA route ran PyTorch math")
    for module in (lstm_cuda, conv_cuda):
        monkeypatch.setattr(module._build, "on_cpu", lambda *a: False)
        monkeypatch.setattr(module._build, "library", lambda: library)
    monkeypatch.setattr(lstm_cuda, "_stream", lambda: 7)
    monkeypatch.setattr(conv_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(conv_cuda.torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(lstm_cuda, "lstm_forward_plain", forbidden)
    monkeypatch.setattr(lstm_cuda, "lstm_backward_plain", forbidden)
    monkeypatch.setattr(conv_cuda, "conv_gradw_plain", forbidden)
    return calls


@pytest.mark.parametrize("matmul_dtype,suffix", [("float32", ""),
                                                 (BF16, "_bf16")])
def test_cuda_routes_take_the_variant_of_the_operand_type(
        fake_card, matmul_dtype, suffix):
    """Each wrapper launches the variant of its operand type and counts
    it there; the lean forward at T>1 is one call (the input GEMM and the
    lean recurrence), as is BPTT (chain, products and the db reduction,
    which sums the float32 dgates in both)."""
    t = lstm_case._torch(lstm_case._inputs(12))
    hidden = 32
    t.update(c0=torch.zeros(4, hidden), h0=torch.zeros(4, hidden),
             wi=torch.zeros(12, 4 * hidden),
             wh=torch.zeros(hidden, 4 * hidden), b=torch.zeros(4 * hidden))
    args = [t[k] for k in ORDER]
    before = dict(lstm_cuda.LAUNCHES, **conv_cuda.LAUNCHES)
    lstm_cuda.lstm_forward(*args, residuals=False, matmul_dtype=matmul_dtype)
    out = lstm_cuda.lstm_forward(*args, residuals=True,
                                 matmul_dtype=matmul_dtype)
    zeros = torch.zeros_like(out.ys)
    lstm_cuda.lstm_backward(zeros, out.c, out.h, t["x"], t["done"], t["wi"],
                            t["wh"], out.residuals, matmul_dtype)
    dtype = torch.bfloat16 if suffix else torch.float32
    conv_cuda.conv_gradw(torch.zeros((2, 16, 16, 3), dtype=dtype),
                         torch.zeros((2, 4, 4, 32), dtype=dtype), 8, 4)
    assert lstm_case.T > 1
    assert fake_card == [
        "sat_lstm_forward_lean" + suffix, "sat_lstm_forward_resid" + suffix,
        "sat_lstm_backward" + suffix, "sat_conv_gradw" + suffix]
    after = dict(lstm_cuda.LAUNCHES, **conv_cuda.LAUNCHES)
    grown = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert grown == {"lstm_fwd_lean_unroll" + suffix: 1,
                     "lstm_fwd_resid" + suffix: 1, "lstm_bptt" + suffix: 1,
                     "stem_gradw" + suffix: 1}


def test_cuda_lstm_route_refuses_bf16_tensors(fake_card):
    """The LSTM kernels read float32 tensors (the core's input is cast to
    float32, as in the JAX agent): a bf16 tensor raises, it is not
    converted."""
    t = lstm_case._torch(lstm_case._inputs(13))
    hidden = 32
    t.update(c0=torch.zeros(4, hidden), h0=torch.zeros(4, hidden),
             wi=torch.zeros(12, 4 * hidden),
             wh=torch.zeros(hidden, 4 * hidden), b=torch.zeros(4 * hidden))
    t["x"] = t["x"].bfloat16()
    with pytest.raises(TypeError, match="x must be torch.float32"):
        lstm_cuda.lstm_forward(*(t[k] for k in ORDER), residuals=True,
                               matmul_dtype=BF16)
    assert fake_card == []
