"""``DeviceGridWorld``: a procedurally generated key-door gridworld in
tensor operations.

The counterpart of ``scalable_agent_tpu/envs/device/gridworld.py``, the
same world bit for bit (``tests/test_torch_device_worlds.py``):

- A ``grid_size x grid_size`` room split by a vertical wall whose column,
  door row, agent start, key and goal are hashed from (seed, episode):
  every episode a new layout, each solvable by construction (agent and
  key on the near side, the goal behind the wall, the door in the wall).
- 4 actions (up, down, left, right).  Moving into the border or the wall
  is a no-op; the door cell admits only an agent carrying the key.
- Sparse rewards: +0.5 for the key, +0.5 for the first pass through the
  door, +1.0 for the goal (which terminates).  Episodes also end at
  ``episode_length`` simulator steps.
- Observation: a ``view x view`` window centred on the agent (cells
  outside the room render as wall), ``cell_px`` pixels a cell, uint8:
  R = walls and door (closed 160, open 64, wall 255), G = key (255) and
  the agent's marker at the centre (128, 192 carrying the key), B = goal
  (255).  The registered levels' frames are 15x15x3.

Every branch of the dynamics is a masked tensor operation over the batch.
"""

from typing import NamedTuple

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.device.world import (
    DeviceWorld,
    _rand_below,
)
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import Observation

__all__ = ["DeviceGridState", "DeviceGridWorld"]


class DeviceGridState(NamedTuple):
    """Per-env state, all [B]."""

    seed: torch.Tensor  # int32, fixed per env
    episode: torch.Tensor  # int32
    step: torch.Tensor  # int32, simulator step within the episode
    episode_return: torch.Tensor  # float32, carried accumulator
    episode_step: torch.Tensor  # int32, agent steps within the episode
    row: torch.Tensor  # int32 agent position
    col: torch.Tensor  # int32
    has_key: torch.Tensor  # int32 0/1
    door_open: torch.Tensor  # int32 0/1


def _delta(action, minus: int, plus: int):
    """-1 for action ``minus``, +1 for ``plus``, else 0 (int32)."""
    return ((action == plus).to(torch.int32)
            - (action == minus).to(torch.int32))


class DeviceGridWorld(DeviceWorld):
    """See the module docstring; ``initial``/``step`` follow the protocol
    (``envs/device/protocol.py``)."""

    num_channels = 3

    def __init__(self, grid_size: int = 7, view: int = 5, cell_px: int = 3,
                 episode_length: int = 48, num_action_repeats: int = 1):
        if grid_size < 5:
            raise ValueError("grid_size must be >= 5 (2 cells per side "
                             "of the wall)")
        if view % 2 != 1:
            raise ValueError("view must be odd (agent-centered window)")
        self.grid_size = int(grid_size)
        self.view = int(view)
        self.cell_px = int(cell_px)
        self.episode_length = int(episode_length)
        self.num_action_repeats = max(1, int(num_action_repeats))
        self.num_actions = 4
        self.max_seed = 2**31 - 1
        self.action_space = Discrete(self.num_actions)
        side = self.view * self.cell_px
        self.observation_spec = Observation(
            frame=TensorSpec((side, side, self.num_channels), np.uint8,
                             "frame"))

    # -- the layout, a function of (seed, episode) --------------------------

    def _layout(self, seed, episode):
        """(wall_col, door_row, agent_r, agent_c, key_r, key_c, goal_r,
        goal_c), int32 [B] each."""
        g = self.grid_size
        wall = 2 + _rand_below(max(1, g - 4), seed, episode, 1)
        door = _rand_below(g, seed, episode, 2)
        # Near side: columns [0, wall): agent and key on distinct cells.
        near = wall * g
        agent_idx = _rand_below(near, seed, episode, 3)
        key_idx = _rand_below(near - 1, seed, episode, 4)
        key_idx = torch.where(key_idx >= agent_idx, key_idx + 1, key_idx)
        agent_r, agent_c = agent_idx // wall, agent_idx % wall
        key_r, key_c = key_idx // wall, key_idx % wall
        # Far side: columns (wall, g).
        far_w = g - wall - 1
        goal_idx = _rand_below(far_w * g, seed, episode, 5)
        goal_r = goal_idx // far_w
        goal_c = wall + 1 + goal_idx % far_w
        return wall, door, agent_r, agent_c, key_r, key_c, goal_r, goal_c

    # -- rendering ---------------------------------------------------------

    def _frame(self, state: DeviceGridState) -> torch.Tensor:
        """uint8 [B, view*px, view*px, 3]: the window centred on the
        agent."""
        g, v = self.grid_size, self.view
        wall, door, _, _, key_r, key_c, goal_r, goal_c = (
            t[:, None, None] for t in self._layout(state.seed,
                                                   state.episode))
        half = v // 2
        offsets = torch.arange(v, dtype=torch.int32,
                               device=state.row.device) - half
        rr = (state.row[:, None] + offsets)[:, :, None]  # [B, v, 1]
        cc = (state.col[:, None] + offsets)[:, None, :]  # [B, 1, v]
        outside = (rr < 0) | (rr >= g) | (cc < 0) | (cc >= g)
        on_wall_col = cc == wall
        is_door = on_wall_col & (rr == door)
        is_wall = outside | (on_wall_col & ~is_door)
        has_key = state.has_key[:, None, None]
        is_key = (rr == key_r) & (cc == key_c) & (has_key == 0) & ~outside
        is_goal = (rr == goal_r) & (cc == goal_c) & ~outside
        door_shade = torch.where(state.door_open[:, None, None] > 0, 64, 160)
        red = torch.where(is_wall, 255,
                          torch.where(is_door & ~outside, door_shade, 0))
        green = torch.where(is_key, 255, 0)
        # The agent's marker at the centre; carrying the key brightens it
        # so the inventory bit is observable.
        centre = offsets == 0
        at_centre = centre[:, None] & centre[None, :]
        green = torch.where(at_centre, torch.where(has_key > 0, 192, 128),
                            green)
        blue = torch.where(is_goal, 255, 0)
        cells = torch.stack(torch.broadcast_tensors(red, green, blue),
                            dim=-1).to(torch.uint8)
        px = self.cell_px
        return cells.repeat_interleave(px, dim=1).repeat_interleave(px,
                                                                    dim=2)

    # -- transitions -------------------------------------------------------

    def _reset(self, seed, episode) -> DeviceGridState:
        _, _, agent_r, agent_c, _, _, _, _ = self._layout(seed, episode)
        zero = torch.zeros_like(seed)
        return DeviceGridState(
            seed=seed, episode=episode, step=zero,
            episode_return=torch.zeros_like(seed, dtype=torch.float32),
            episode_step=zero, row=agent_r, col=agent_c, has_key=zero,
            door_open=zero)

    def _substep(self, state: DeviceGridState, action):
        """One simulator sub-step: (new_state, reward, terminated)."""
        g = self.grid_size
        wall, door, _, _, key_r, key_c, goal_r, goal_c = self._layout(
            state.seed, state.episode)
        nr = torch.clamp(state.row + _delta(action, 0, 1), 0, g - 1)
        nc = torch.clamp(state.col + _delta(action, 2, 3), 0, g - 1)
        into_door = (nc == wall) & (nr == door)
        blocked = (((nc == wall) & ~into_door)
                   | (into_door & (state.has_key == 0)))
        nr = torch.where(blocked, state.row, nr)
        nc = torch.where(blocked, state.col, nc)
        picked = ((nr == key_r) & (nc == key_c) & (state.has_key == 0)
                  & (nc < wall))
        opened = into_door & ~blocked & (state.door_open == 0)
        reached = (nr == goal_r) & (nc == goal_c)
        reward = (0.5 * picked.to(torch.float32)
                  + 0.5 * opened.to(torch.float32)
                  + 1.0 * reached.to(torch.float32))
        step = state.step + 1
        terminated = reached | (step >= self.episode_length)
        new_state = state._replace(
            row=nr, col=nc, step=step,
            has_key=torch.maximum(state.has_key, picked.to(torch.int32)),
            door_open=torch.maximum(state.door_open,
                                    opened.to(torch.int32)))
        return new_state, reward, terminated
