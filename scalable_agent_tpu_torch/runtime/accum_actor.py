"""On-device trajectory accumulation for the actor runtime
(``--inference_mode=accum`` and ``accum_fused``).

The counterpart of ``scalable_agent_tpu/runtime/accum_actor.py``.  The
structural ``VectorActor`` fetches the whole agent output to the host every
step, stacks each unroll on the host, and the transport packs and uploads
it again: every frame crosses the link twice.  Here the data flow is
inverted:

- Per step the host uploads the frame batch and one packed ``[4, rows]``
  float32 array of (reward, done, episode_return, episode_step)
  (``_pack_env_fields``), plus the instruction or the measurements where
  the level has them (``_upload_fields``): each written into the actor's
  pinned staging buffer, then one non-blocking copy a field straight into
  its slot of the unroll's device buffers.  One ``actor_step`` runs on the
  device; the last action is read back from the agent slot ``slot-1`` of
  the buffers on the device; and exactly one device-to-host fetch, the
  sampled actions, gives the simulators their input.  Every env output is
  uploaded once: the initial one by the bootstrap, the rest by the next
  step or by the unroll's end.
- The buffers are freshly allocated for each unroll, ``[T+1, rows, ...]``
  (rows: the groups' envs side by side), and written in place
  (``buf[slot].copy_(...)``).  At the unroll's end (``_seal``) they become
  the learner's trajectories: the small fields unpacked to the structural
  dtypes, and, for more than one group, each group's rows made contiguous.
  No host stacking, no re-upload.  The next unroll's buffers are new ones,
  seeded with the T+1 overlap entry (the reference's first-entry-is-
  last-entry layout, experiment.py:311-321); a buffer handed to the queue
  is never written again.
- The trajectory crosses streams: the actor thread writes it on its own
  stream and records an event after the last write (``_record_ready``);
  the transport's consumer waits on that event and ``record_stream``s the
  tensors (``transport.adopt_device_trajectory``).
- ``GroupedAccumActor`` (``accum_fused``) advances k groups in lockstep
  through ONE ``grouped_actor_step`` on ``[k*B]`` rows a step and ONE
  action fetch for all of them; each group's rows are sampled from its own
  generator, seeded as the threaded ``AccumVectorActor``'s, so both give
  the same trajectories.

The trajectory layout, dtypes, random streams and math are the structural
path's (``tests/test_torch_accum_actor.py``).  Torch has no donation, so
nothing is consumed by a step; ``reset`` still drops the buffers and the
carry after a failure mid-unroll, so a half-written buffer never becomes a
trajectory.
"""

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.vector import MultiEnv
from scalable_agent_tpu_torch.models.agent import (
    ImpalaAgent,
    grouped_actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.obs import get_tracer, get_watchdog
from scalable_agent_tpu_torch.obs.ledger import now_us as ledger_now_us
from scalable_agent_tpu_torch.runtime.actor import (
    ParamsSnapshot,
    actor_stage_histograms,
    load_snapshot,
)
from scalable_agent_tpu_torch.runtime.transport import h2d_bytes_counter
from scalable_agent_tpu_torch.types import (
    ActorOutput,
    AgentOutput,
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
    map_structure,
)

class DeviceActorOutput(ActorOutput):
    """An ``ActorOutput`` whose leaves are device tensors written on an
    actor's stream; ``ready`` is the CUDA event recorded there after the
    last write (None on the CPU), which the consumer waits on."""

    ready = None


class _Buffers(NamedTuple):
    """One unroll's device buffers, ``[T+1, rows, ...]``; ``packed`` is
    ``[T+1, 4, rows]`` float32 (reward, done, episode_return,
    episode_step)."""

    frame: torch.Tensor
    packed: torch.Tensor
    instruction: Optional[torch.Tensor]
    measurements: Optional[torch.Tensor]
    action: torch.Tensor
    policy_logits: torch.Tensor
    baseline: torch.Tensor


# The upload's fields, in ``_upload_fields`` order, by their buffers.
_UPLOADED = ("frame", "packed", "instruction", "measurements")


def _pack_env_fields(env_output: StepOutput) -> np.ndarray:
    """The small per-step env fields as ONE [4, B] float32 array (one
    upload instead of four; episode_step is exact in float32 below
    2^24)."""
    return np.stack([
        np.asarray(env_output.reward, np.float32),
        np.asarray(env_output.done, np.float32),
        np.asarray(env_output.info.episode_return, np.float32),
        np.asarray(env_output.info.episode_step, np.float32),
    ])


def _upload_fields(programs: "AccumPrograms", env_output: StepOutput):
    """One env group's per-step host->device payload: (frames [B, ...],
    packed [4, B] float32, instruction or None, measurements or None).  An
    env whose optional observation streams do not match the programs'
    buffers is a pointed error."""
    obs = env_output.observation
    if (obs.instruction is not None) != (
            programs.instruction_shape is not None):
        raise ValueError(
            "instruction observation/programs mismatch: the env "
            f"{'emits' if obs.instruction is not None else 'lacks'} "
            "instructions but AccumPrograms was built "
            f"{'without' if programs.instruction_shape is None else 'with'} "
            "instruction_shape (pass the observation_spec through "
            "ActorPool)")
    if (obs.measurements is not None) != (
            programs.measurements_shape is not None):
        raise ValueError(
            "measurements observation/programs mismatch: the env "
            f"{'emits' if obs.measurements is not None else 'lacks'} "
            "measurements but AccumPrograms was built "
            f"{'without' if programs.measurements_shape is None else 'with'} "
            "measurements_shape (pass the observation_spec through "
            "ActorPool)")
    return (
        obs.frame,
        _pack_env_fields(env_output),
        None if obs.instruction is None
        else np.asarray(obs.instruction, np.int32),
        None if obs.measurements is None
        else np.asarray(obs.measurements, np.float32),
    )


def _seal(programs: "AccumPrograms", bufs: _Buffers, groups: int):
    """The unroll's last writes: its buffers as each group's trajectory,
    ``(StepOutput, AgentOutput)`` of [T+1, B, ...] tensors, the small
    fields in the structural path's dtypes."""
    env = StepOutput(
        reward=bufs.packed[:, 0],
        info=StepOutputInfo(episode_return=bufs.packed[:, 2],
                            episode_step=bufs.packed[:, 3].to(torch.int32)),
        done=bufs.packed[:, 1] > 0.5,
        observation=Observation(frame=bufs.frame,
                                instruction=bufs.instruction,
                                measurements=bufs.measurements))
    agent = AgentOutput(action=bufs.action,
                        policy_logits=bufs.policy_logits,
                        baseline=bufs.baseline)
    batch = programs.batch
    out = []
    for i in range(groups):
        rows = slice(i * batch, (i + 1) * batch)
        # One group's rows of a one-group buffer are the buffer itself.
        take = lambda x: (None if x is None
                          else x[:, rows].contiguous())
        out.append((map_structure(take, env), map_structure(take, agent)))
    return out


def _record_ready(device: torch.device):
    """The event after a trajectory's last write, on the actor's current
    stream (None on the CPU, where the writes are done when issued)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _fetch_actions(actions: torch.Tensor) -> np.ndarray:
    """The step's one device-to-host fetch; on the card it waits for the
    actor's stream, so every copy issued before it has completed."""
    return actions.cpu().numpy()


class _Staging:
    """An actor's host side of the upload: one host buffer a field (pinned
    on the card), laid out as one slot of the device buffers with the
    groups' rows side by side, its numpy view made once.  ``upload`` fills
    it from each group's ``_upload_fields`` and issues one non-blocking
    copy a field into the slot.  A buffer is rewritten only after the
    copies that last read it have completed: within an unroll the action
    fetch of the same step is that sync; after the bootstrap's and the
    unroll end's uploads, which no fetch follows, the event recorded after
    the copies is waited on instead."""

    def __init__(self, programs: "AccumPrograms", groups: int):
        device = programs.device
        pin = device.type == "cuda"
        rows = groups * programs.batch
        shapes = {
            "frame": ((rows,) + programs.frame_shape, torch.uint8),
            "packed": ((4, rows), torch.float32),
            "instruction": (None if programs.instruction_shape is None
                            else ((rows,) + programs.instruction_shape,
                                  torch.int32)),
            "measurements": (None if programs.measurements_shape is None
                             else ((rows,) + programs.measurements_shape,
                                   torch.float32))}
        self._device = device
        self._batch = programs.batch
        self._host = {}
        for name, spec in shapes.items():
            if spec is None:
                continue
            tensor = torch.empty(spec[0], dtype=spec[1], pin_memory=pin)
            if pin and not tensor.is_pinned():
                raise RuntimeError("accum actor: the staging buffers could "
                                   "not be pinned")
            self._host[name] = (tensor, tensor.numpy())
        self.nbytes = sum(t.nbytes for t, _ in self._host.values())
        self._done = None

    def upload(self, groups: Sequence[tuple], bufs: _Buffers,
               slot: int, synced_after: bool) -> None:
        """Each group's ``_upload_fields`` -> slot ``slot`` of ``bufs``.
        ``synced_after``: the caller waits for the stream before the next
        upload (the step's action fetch), so no event is needed."""
        if self._done is not None:
            self._done.synchronize()
            self._done = None
        batch = self._batch
        for name, fields in zip(_UPLOADED, zip(*groups)):
            if name not in self._host:
                continue
            tensor, host = self._host[name]
            for i, arr in enumerate(fields):
                rows = slice(i * batch, (i + 1) * batch)
                if name == "packed":
                    host[:, rows] = arr
                else:
                    host[rows] = arr
            getattr(bufs, name)[slot].copy_(tensor, non_blocking=True)
        if not synced_after and self._device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self._device))


class AccumPrograms:
    """The buffers and per-step programs of one (agent, T, B, frame shape)
    signature, shared by every actor of a pool.  ``agent`` is the template
    whose shapes and device the buffers take; each actor runs its own
    copy."""

    def __init__(self, agent: ImpalaAgent, unroll_length: int, batch: int,
                 frame_shape: Sequence[int],
                 instruction_shape: Optional[Sequence[int]] = None,
                 measurements_shape: Optional[Sequence[int]] = None):
        self.agent = agent
        self.device = next(agent.parameters()).device
        self.unroll_length = unroll_length
        self.batch = batch
        self.frame_shape = tuple(frame_shape)
        # Instruction token ids (int32) and measurement vectors (float32)
        # ride the per-step upload into buffers of their own when set.
        self.instruction_shape = (tuple(instruction_shape)
                                  if instruction_shape is not None else None)
        self.measurements_shape = (tuple(measurements_shape)
                                   if measurements_shape is not None
                                   else None)
        k = agent.num_action_components
        self._action_tail = () if k == 1 else (k,)

    def new_buffers(self, groups: int) -> _Buffers:
        """Fresh device buffers for one unroll of ``groups`` groups."""
        lead = (self.unroll_length + 1, groups * self.batch)
        empty = lambda tail, dtype: torch.empty(lead + tuple(tail),
                                                dtype=dtype,
                                                device=self.device)
        return _Buffers(
            frame=empty(self.frame_shape, torch.uint8),
            packed=torch.empty((lead[0], 4, lead[1]), dtype=torch.float32,
                               device=self.device),
            instruction=(None if self.instruction_shape is None
                         else empty(self.instruction_shape, torch.int32)),
            measurements=(None if self.measurements_shape is None
                          else empty(self.measurements_shape,
                                     torch.float32)),
            action=empty(self._action_tail, torch.int64),
            policy_logits=empty((self.agent.num_logits,), torch.float32),
            baseline=empty((), torch.float32))

    @staticmethod
    def entry(bufs: _Buffers, slot: int) -> StepOutput:
        """The env outputs of time index ``slot``, as the step reads them
        (the agent reads no episode info)."""
        packed = bufs.packed[slot]
        select = lambda buf: None if buf is None else buf[slot]
        return StepOutput(
            reward=packed[0], info=None, done=packed[1] > 0.5,
            observation=Observation(frame=bufs.frame[slot],
                                    instruction=select(bufs.instruction),
                                    measurements=select(bufs.measurements)))

    @staticmethod
    def write_agent(bufs: _Buffers, slot: int, out: AgentOutput) -> None:
        bufs.action[slot].copy_(out.action)
        bufs.policy_logits[slot].copy_(out.policy_logits)
        bufs.baseline[slot].copy_(out.baseline)

    def zero_agent_entry(self, bufs: _Buffers) -> None:
        """Agent slot 0 of the first-ever unroll: zeros (reference:
        experiment.py:243-251)."""
        for buf in (bufs.action, bufs.policy_logits, bufs.baseline):
            buf[0].zero_()

    def step(self, agent: ImpalaAgent,
             generators: Sequence[torch.Generator], slot: int,
             bufs: _Buffers, core_state: AgentState):
        """Iteration ``slot`` (1-based), its env outputs already in slot
        ``slot-1``: the step on them and the last action (agent slot
        ``slot-1``, read on the device), its outputs written to slot
        ``slot``.  Returns (the sampled actions on the device, the new core
        state)."""
        out, new_core = grouped_actor_step(
            agent, generators, self.batch, bufs.action[slot - 1],
            self.entry(bufs, slot - 1), core_state)
        self.write_agent(bufs, slot, out)
        return out.action, new_core

    def next_buffers(self, bufs: _Buffers) -> _Buffers:
        """The next unroll's buffers, slot 0 the overlap entry (slot T of
        ``bufs``)."""
        t = self.unroll_length
        groups = bufs.baseline.shape[1] // self.batch
        fresh = self.new_buffers(groups)
        for new, old in zip(fresh, bufs):
            if new is not None:
                new[0].copy_(old[t])
        return fresh


class GroupedAccumActor:
    """Cross-group co-dispatch (``accum_fused``): k accum groups advance in
    lockstep through ONE ``grouped_actor_step`` on ``[k*B]`` rows a step,
    and all k groups' actions come back in ONE fetch, so the per-step link
    cost is one round trip whatever k is.  The trade: the slowest group's
    env step gates the batch.  Group i samples from a generator seeded
    ``seeds[i]``, as the threaded ``AccumVectorActor`` of that seed does:
    the trajectories are the same.

    ``run_unroll(params)`` returns one ``DeviceActorOutput`` per group.
    ``agent`` (default: the programs' template) is the copy this actor
    runs and loads published snapshots into."""

    def __init__(self, programs: AccumPrograms,
                 env_groups: Sequence[MultiEnv], level_name: str = "",
                 seeds: Optional[Sequence[int]] = None,
                 agent: Optional[ImpalaAgent] = None):
        sizes = {envs.num_envs for envs in env_groups}
        if sizes != {programs.batch}:
            raise ValueError(
                f"group sizes {sorted(sizes)} != programs batch "
                f"{programs.batch}")
        k = len(env_groups)
        if seeds is None:
            seeds = [1000 * i for i in range(k)]
        if len(seeds) != k:
            raise ValueError(f"{len(seeds)} seeds for {k} groups")
        self._p = programs
        self.envs_list = list(env_groups)
        self.level_name = level_name
        self._agent = agent if agent is not None else programs.agent
        self._device = programs.device
        self._generators = []
        for seed in seeds:
            generator = torch.Generator(device=self._device)
            generator.manual_seed(int(seed))
            self._generators.append(generator)
        self._loaded = None
        self._bufs = None
        self._core = None
        self._last_outs = None
        self._stepped = False
        self._staging = _Staging(programs, k)
        self.unroll_birth_us = None
        self._h_env, self._h_infer = actor_stage_histograms()
        self._h2d_bytes = h2d_bytes_counter()

    @property
    def envs(self) -> MultiEnv:
        """The first group's envs (the ``worker_kill`` fault's target)."""
        return self.envs_list[0]

    def load_params(self, snapshot: ParamsSnapshot) -> None:
        if snapshot is not self._loaded:
            load_snapshot(self._agent, snapshot)
            self._loaded = snapshot

    def _upload(self, bufs: _Buffers, slot: int,
                synced_after: bool) -> None:
        """The groups' newest env outputs into slot ``slot`` of ``bufs``,
        their bytes counted in ``transport/h2d_bytes_total``."""
        self._staging.upload([_upload_fields(self._p, out)
                              for out in self._last_outs],
                             bufs, slot, synced_after)
        self._h2d_bytes.inc(self._staging.nbytes)

    def run_unroll(self, params: Optional[ParamsSnapshot] = None
                   ) -> List[DeviceActorOutput]:
        """One lockstep unroll: a [T+1, B] trajectory on the device per
        group, under ``params`` when given."""
        self.unroll_birth_us = ledger_now_us()
        tracer = get_tracer()
        watchdog = get_watchdog()
        if not self._stepped:
            # Set-up, not progress: the envs' first reset and the first
            # step, which may build the kernels.
            watchdog.suspend()
        if params is not None:
            self.load_params(params)
        p = self._p
        k = len(self.envs_list)
        if self._bufs is None:
            self._last_outs = [envs.initial() for envs in self.envs_list]
            self._bufs = p.new_buffers(k)
            self._upload(self._bufs, 0, synced_after=False)
            p.zero_agent_entry(self._bufs)
            self._core = initial_state(k * p.batch, self._agent.core_size,
                                       self._device)
        # This unroll owns its buffers: if it fails half-way, the next one
        # re-bootstraps instead of touching a half-written buffer.
        bufs, self._bufs = self._bufs, None
        first_core = core = self._core
        for slot in range(1, p.unroll_length + 1):
            if self._stepped:
                watchdog.touch()  # per-step heartbeat: one dict store
            t0 = time.perf_counter()
            # Inference: the upload, the step, the one action fetch.
            with tracer.span("actor/inference", cat="actor",
                             args={"groups": k}):
                if slot > 1:  # slot 0 holds the overlap entry already
                    self._upload(bufs, slot - 1, synced_after=True)
                actions_dev, core = p.step(self._agent, self._generators,
                                           slot, bufs, core)
                actions = _fetch_actions(actions_dev)
            t1 = time.perf_counter()
            with tracer.span("actor/env_step", cat="actor"):
                for i, envs in enumerate(self.envs_list):
                    envs.step_send(actions[i * p.batch:(i + 1) * p.batch])
                self._last_outs = [envs.step_recv()
                                   for envs in self.envs_list]
            self._h_infer.observe(t1 - t0)
            self._h_env.observe(time.perf_counter() - t1)
            self._stepped = True
        self._upload(bufs, p.unroll_length, synced_after=False)
        self._bufs = p.next_buffers(bufs)
        trajectories = _seal(p, bufs, k)
        self._core = core
        ready = _record_ready(self._device)
        outputs = []
        for i, (env, agent) in enumerate(trajectories):
            rows = slice(i * p.batch, (i + 1) * p.batch)
            out = DeviceActorOutput(
                level_name=self.level_name,
                agent_state=AgentState(c=first_core.c[rows],
                                       h=first_core.h[rows]),
                env_outputs=env, agent_outputs=agent)
            out.ready = ready
            outputs.append(out)
        return outputs

    def reset(self) -> None:
        """Drop the device buffers and the carry after a failure
        mid-unroll, then re-align every group's env pipes: the next unroll
        re-bootstraps."""
        self._bufs = None
        self._core = None
        self._last_outs = None
        for envs in self.envs_list:
            envs.resync()

    def close(self) -> None:
        for envs in self.envs_list:
            envs.close()


class AccumVectorActor(GroupedAccumActor):
    """One env group through the accumulation programs: ``VectorActor``'s
    surface, ``run_unroll(params) -> ActorOutput`` with device leaves."""

    def __init__(self, programs: AccumPrograms, envs: MultiEnv,
                 level_name: str = "", seed: int = 0,
                 agent: Optional[ImpalaAgent] = None):
        if envs.num_envs != programs.batch:
            raise ValueError(
                f"group size {envs.num_envs} != programs batch "
                f"{programs.batch}")
        super().__init__(programs, [envs], level_name=level_name,
                         seeds=[seed], agent=agent)

    def run_unroll(self, params: Optional[ParamsSnapshot] = None
                   ) -> DeviceActorOutput:
        return super().run_unroll(params)[0]
