"""The IMPALA agent: conv torso + optional language LSTM + LSTM core +
policy/baseline heads.

The counterpart of ``scalable_agent_tpu/models/agent.py`` (reference:
experiment.py:109-237): the torso (``torso_type``: ``shallow`` or
``resnet``) runs over the merged [T*B] batch, the clipped reward, the
one-hot last action and, with ``use_instruction``, the instruction
encoder's output are concatenated to its output, the done-reset LSTM core
runs over T, and the heads run over the merged batch again.  ``forward``
is the whole trajectory unroll, shared by actor inference (T=1) and the
learner (T=unroll_length+1).

Two routes, chosen only by their flags (``config.resolve_core_impl``,
``resolve_conv_backend``): ``core_impl="pallas"`` (the default) is the
hand-written core (``ops/lstm_cuda.lstm_unroll``), ``"xla"`` a per-step
done-reset LSTM in torch ops under autograd, flax ``OptimizedLSTMCell``'s
math over the same ``wi``/``wh``/``b`` (the JAX ``nn.scan(_CoreStep)``,
``scalable_agent_tpu/models/agent.py:49-66,263-272``), its products at the
float32 params' precision; ``conv_backend`` picks the stem's weight
gradient (``models/networks.py``).  Both routes share one parameter tree,
so checkpoints and ``convert.py`` serve either.

The one compute-dtype policy is the JAX agent's
(``scalable_agent_tpu/models/agent.py``), by explicit casts: parameters
stay float32; the torso runs at ``compute_dtype``; its output, the clipped
reward, the one-hot action and the instruction encoding (float32 under
both policies, as flax's undtyped ``Embed`` and cell compute it) are
concatenated in float32 and cast to ``compute_dtype``; the core takes
that as float32 (``jnp.asarray(x, float32)``) with its float32 weights
and rounds its products' operands to
``core_matmul_dtype``, its carries, outputs and residuals float32; the
heads run at ``compute_dtype`` and their outputs are cast to float32, so
the loss, V-trace and the optimizer see float32 only.  The defaults,
float32 and float32, are the JAX module's; ``driver.build_agent`` passes
the configuration's (``compute_dtype=bfloat16`` resolves the core to
bfloat16 operands).

``remat_torso`` is the JAX module's ``nn.remat`` of the torso: where a
gradient is taken, the torso's activations are not kept for the backward
pass but recomputed there (``torch.utils.checkpoint``, non-reentrant, so
the recomputation runs the same casts and kernels and the gradients are
the same bit for bit).
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from scalable_agent_tpu_torch.envs.spaces import Space
from scalable_agent_tpu_torch.models.instruction import (
    LSTM_SIZE,
    InstructionEncoder,
)
from scalable_agent_tpu_torch.models.networks import (
    TORSO_SIZE,
    TORSOS,
    dense,
    dense_apply,
    init_lstm_,
)
from scalable_agent_tpu_torch.ops import distributions
from scalable_agent_tpu_torch.ops.lstm_cuda import lstm_unroll
from scalable_agent_tpu_torch.types import (
    AgentOutput,
    AgentState,
    StepOutput,
    map_structure,
)

CORE_SIZE = 256  # reference: experiment.py:118


def initial_state(batch_size: int, core_size: int = CORE_SIZE,
                  device=None) -> AgentState:
    """Zero LSTM carry."""
    zeros = lambda: torch.zeros((batch_size, core_size), dtype=torch.float32,
                                device=device)
    return AgentState(c=zeros(), h=zeros())


CORE_IMPLS = ("xla", "pallas")


def xla_core(x, done, carry: AgentState, wi, wh, b):
    """The ``xla`` core: x [T,B,D] float32, done [T,B] -> (ys [T,B,H],
    final carry), one step at a time under autograd.  Each step resets the
    carry where ``done`` (before the cell, as ``_CoreStep``), then runs
    flax ``OptimizedLSTMCell``: gates (h·Wh + b) + x·Wi in (i, f, g, o),
    c' = sigmoid(f)·c + sigmoid(i)·tanh(g), h' = sigmoid(o)·tanh(c').  The
    input products of every step are one product over [T·B, D]."""
    steps, batch = x.shape[:2]
    xw = (x.reshape(steps * batch, -1) @ wi).reshape(steps, batch, -1)
    keep = (1.0 - done)[..., None]
    c, h = carry.c, carry.h
    ys = []
    for t in range(steps):
        c, h = keep[t] * c, keep[t] * h
        i, f, g, o = ((h @ wh + b) + xw[t]).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), AgentState(c=c, h=h)


class LSTMCore(nn.Module):
    """The done-reset LSTM's parameters in the kernel's layout: ``wi
    [D,4H]``, ``wh [H,4H]``, ``b [4H]``, gates (i, f, g, o).  Initialized
    like flax's OptimizedLSTMCell gate by gate: lecun_normal input
    kernels, orthogonal recurrent kernels, zero bias (only the recurrent
    side has one).  ``core_impl`` is the route: the hand-written kernels
    (``pallas``) or ``xla_core``."""

    def __init__(self, in_features: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 core_impl: str = "pallas"):
        super().__init__()
        if core_impl not in CORE_IMPLS:
            raise ValueError(f"unknown core_impl: {core_impl!r} "
                             f"(choices: {CORE_IMPLS})")
        self.core_impl = core_impl
        self.wi = nn.Parameter(torch.empty(in_features, 4 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(4 * hidden))
        init_lstm_(self.wi, self.wh, generator)

    def forward(self, x, done, carry: AgentState,
                matmul_dtype: str = "float32", residuals: bool = False):
        if self.core_impl == "xla":
            return xla_core(x, done, carry, self.wi, self.wh, self.b)
        ys, (c, h) = lstm_unroll(x, done, carry.c, carry.h, self.wi,
                                 self.wh, self.b, matmul_dtype, residuals)
        return ys, AgentState(c=c, h=h)


class ImpalaAgent(nn.Module):
    """Torso + optional instruction encoder + LSTM(core_size) core +
    policy/baseline heads.

    ``forward(actions [T,B] int, env_outputs, core_state)`` with
    env_outputs.reward [T,B], done [T,B], observation.frame [T,B,H,W,C]
    uint8 and, with ``use_instruction``, observation.instruction [T,B,L]
    int token ids, returns ``((policy_logits [T,B,A], baseline [T,B]),
    new_state)``.  The policy is one Discrete(``num_actions``) head, or,
    given ``action_space``, the tuple-categorical policy over it
    (``ops/distributions.spec_for_space``): A is its ``num_logits``, and
    a composite space's actions carry a component axis, [T,B,K].
    Weights are drawn from ``generator``.
    ``compute_dtype`` and ``core_matmul_dtype`` are the dtype policy's,
    ``remat_torso`` the torso's recomputation, ``core_impl`` and
    ``conv_backend`` the routes (module docstring; both default to the
    kernels).
    ``residual_core=True`` makes the core run its residual forward even
    where no gradient flows (the learner's two-pass comparison unroll).
    """

    def __init__(self, num_actions: int = 0,
                 frame_shape: Sequence[int] = (72, 96, 3),
                 core_size: int = CORE_SIZE,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 core_matmul_dtype: str = "float32",
                 remat_torso: bool = False,
                 torso_type: str = "shallow",
                 use_instruction: bool = False,
                 action_space: Optional[Space] = None,
                 core_impl: str = "pallas",
                 conv_backend: str = "pallas"):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {compute_dtype}")
        if torso_type not in TORSOS:
            raise ValueError(f"unknown torso_type {torso_type!r} "
                             f"(choices: {sorted(TORSOS)})")
        self.dist_spec = (
            distributions.spec_for_space(action_space)
            if action_space is not None
            else distributions.DistributionSpec(sizes=(num_actions,)))
        if self.num_logits <= 0:
            raise ValueError("ImpalaAgent needs num_actions > 0 or an "
                             "action_space")
        self.core_size = core_size
        self.compute_dtype = compute_dtype
        self.core_matmul_dtype = core_matmul_dtype
        self.remat_torso = remat_torso
        self.use_instruction = use_instruction
        self.convnet = TORSOS[torso_type](frame_shape, generator,
                                          compute_dtype, conv_backend)
        in_features = TORSO_SIZE + 1 + self.num_logits
        if use_instruction:
            self.instruction = InstructionEncoder(generator=generator)
            in_features += LSTM_SIZE
        self.core = LSTMCore(in_features, core_size, generator, core_impl)
        self.policy_logits = dense(core_size, self.num_logits, generator)
        self.baseline = dense(core_size, 1, generator)

    @property
    def num_logits(self) -> int:
        return self.dist_spec.num_logits

    @property
    def dtype_policy(self) -> Tuple[torch.dtype, str]:
        """(``compute_dtype``, ``core_matmul_dtype``)."""
        return self.compute_dtype, self.core_matmul_dtype

    def set_dtype_policy(self, compute_dtype: torch.dtype,
                         core_matmul_dtype: str) -> None:
        """Run under another dtype policy from the next call on (the
        parameters stay float32, so nothing is converted): the numerics
        sentinel's float32 rung reaches the actors' private agents this
        way."""
        self.compute_dtype = compute_dtype
        self.convnet.dtype = compute_dtype
        self.core_matmul_dtype = core_matmul_dtype

    @property
    def num_action_components(self) -> int:
        return self.dist_spec.num_components

    def zero_actions(self, batch: int) -> torch.Tensor:
        """All-zeros last-action input at the agent's action layout: [B]
        for one Discrete head, [B, K] for a composite policy."""
        k = self.num_action_components
        shape = (batch,) if k == 1 else (batch, k)
        return torch.zeros(shape, dtype=torch.int64)

    def forward(self, actions, env_outputs: StepOutput,
                core_state: AgentState, residual_core: bool = False
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], AgentState]:
        unroll_len, batch = actions.shape[:2]
        reward, _, done, observation = env_outputs
        flat = lambda t: t.reshape((unroll_len * batch,) + t.shape[2:])
        dtype = self.compute_dtype
        frames = flat(observation.frame)
        if self.remat_torso and torch.is_grad_enabled():
            # The torso draws no random numbers: no RNG state to replay.
            conv_out = torch.utils.checkpoint.checkpoint(
                self.convnet, frames, use_reentrant=False,
                preserve_rng_state=False)
        else:
            conv_out = self.convnet(frames)
        clipped_reward = torch.clamp(flat(reward).float(), -1.0, 1.0)[:, None]
        one_hot_last_action = distributions.one_hot_actions(
            flat(actions), self.dist_spec)
        parts = [conv_out.float(), clipped_reward, one_hot_last_action]
        if self.use_instruction:
            parts.append(self.instruction(flat(observation.instruction)))
        # Concatenated in float32, then the policy's cast (identities under
        # float32); the core takes the compute-dtype values as float32.
        torso_out = torch.cat(parts, dim=-1).to(dtype)
        core_outputs, new_state = self.core(
            torso_out.float().reshape(unroll_len, batch, -1),
            done.float().contiguous(), core_state, self.core_matmul_dtype,
            residual_core)
        core_flat = core_outputs.reshape(unroll_len * batch, -1)
        policy_logits = dense_apply(self.policy_logits, core_flat,
                                    dtype).float().reshape(
            unroll_len, batch, self.num_logits)
        baseline = dense_apply(self.baseline, core_flat, dtype).float(
        ).reshape(unroll_len, batch)
        return (policy_logits, baseline), new_state


def actor_step(agent: ImpalaAgent, generator: torch.Generator, last_action,
               env_output: StepOutput, core_state: AgentState
               ) -> Tuple[AgentOutput, AgentState]:
    """One batched inference step: unroll T=1 (under ``no_grad``, so the
    core runs its lean kernel) and sample an action from ``generator``.
    last_action [B] ([B, K] for a composite policy, and so is the sampled
    action), env_output [B, ...] tensors on the agent's device."""
    return grouped_actor_step(agent, [generator], last_action.shape[0],
                              last_action, env_output, core_state)


@torch.no_grad()
def grouped_actor_step(agent: ImpalaAgent,
                       generators: Sequence[torch.Generator],
                       group_rows: int, last_action,
                       env_output: StepOutput, core_state: AgentState
                       ) -> Tuple[AgentOutput, AgentState]:
    """One batched inference step over the rows of several env groups at
    once: one T=1 unroll over every row, then group i's ``group_rows`` rows
    sampled from ``generators[i]`` alone, so each group draws what its own
    ``actor_step`` would (the JAX package vmaps its step over groups, each
    with its own key).  Rows past ``len(generators) * group_rows`` are
    padding: their action is 0 and they draw nothing."""
    expand = lambda t: None if t is None else t[None]
    (policy_logits, baseline), new_state = agent(
        last_action[None], map_structure(expand, env_output), core_state)
    policy_logits = policy_logits[0]
    actions = [distributions.sample(
        generator, policy_logits[i * group_rows:(i + 1) * group_rows],
        agent.dist_spec) for i, generator in enumerate(generators)]
    valid = len(generators) * group_rows
    if valid < policy_logits.shape[0]:
        actions.append(torch.zeros(
            (policy_logits.shape[0] - valid,) + actions[0].shape[1:],
            dtype=actions[0].dtype, device=actions[0].device))
    action = actions[0] if len(actions) == 1 else torch.cat(actions)
    return (AgentOutput(action=action, policy_logits=policy_logits,
                        baseline=baseline[0]),
            new_state)
