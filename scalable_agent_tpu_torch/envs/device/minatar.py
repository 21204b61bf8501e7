"""MinAtar-style Atari-lite worlds as tensor transition functions.

The counterpart of ``scalable_agent_tpu/envs/device/minatar.py``, the same
games bit for bit (``tests/test_torch_device_worlds.py``): object-channel
10x10 frames, dynamics in masked tensor operations over the batch (no
branch reads a device value), optional sticky actions.  They are style
reimplementations of MinAtar's games, not mirrors of the MinAtar package:
a real, branchy, stateful workload on the card.

Randomness is the hashed counter stream of ``envs/device/world.py``, each
draw a function of (seed, episode, step, tag).  ``sticky_prob > 0``
repeats the previous action with that probability (Machado et al.),
drawn from the same stream.

- ``device_minatar_breakout``: 3 brick rows, a one-row paddle, a ball
  bouncing diagonally; +1 a brick; losing the ball ends the episode; a
  cleared wall respawns.  3 actions; channels paddle, ball, trail, bricks.
- ``device_minatar_asterix``: 8 entity lanes spawn left and right movers
  (1 in 3 gold); touching gold is +1, touching an enemy ends the episode.
  5 actions; channels player, enemies, gold.
"""

from typing import NamedTuple

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.device.world import (
    DeviceWorld,
    _rand_below,
    _uniform,
)
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import Observation

__all__ = ["DeviceAsterix", "DeviceBreakout"]

_GRID = 10


def _grid(device):
    """Row and column indices [1, 10, 1] and [1, 1, 10]."""
    index = torch.arange(_GRID, dtype=torch.int32, device=device)
    return index[None, :, None], index[None, None, :]


def _at(rows, cols, r, c):
    """uint8 [B, 10, 10]: 255 at each env's (r, c) cell, else 0."""
    hit = (rows == r[:, None, None]) & (cols == c[:, None, None])
    return hit.to(torch.uint8) * 255


class _MinAtarBase(DeviceWorld):
    """The constructor the two games share (``num_actions`` and
    ``num_channels`` are per-game class attributes)."""

    def __init__(self, episode_length: int = 128, sticky_prob: float = 0.0,
                 num_action_repeats: int = 1):
        self.episode_length = int(episode_length)
        self.sticky_prob = float(sticky_prob)
        if not 0.0 <= self.sticky_prob < 1.0:
            raise ValueError(
                f"sticky_prob must be in [0, 1), got {sticky_prob}")
        self.num_action_repeats = max(1, int(num_action_repeats))
        self.max_seed = 2**31 - 1
        self.action_space = Discrete(self.num_actions)
        self.observation_spec = Observation(
            frame=TensorSpec((_GRID, _GRID, self.num_channels), np.uint8,
                             "frame"))

    def _effective_action(self, state, action):
        """Sticky actions: ``last_action`` with probability
        ``sticky_prob`` (nothing is drawn at the 0.0 default)."""
        if self.sticky_prob <= 0.0:
            return action
        u = _uniform(state.seed, state.episode, state.step, 101)
        return torch.where(u < self.sticky_prob, state.last_action, action)


class DeviceBreakoutState(NamedTuple):
    seed: torch.Tensor  # int32 [B]
    episode: torch.Tensor  # int32 [B]
    step: torch.Tensor  # int32 [B], simulator step within the episode
    episode_return: torch.Tensor  # float32 [B], carried accumulator
    episode_step: torch.Tensor  # int32 [B], agent steps in the episode
    ball_r: torch.Tensor  # int32 [B]
    ball_c: torch.Tensor  # int32 [B]
    dir_r: torch.Tensor  # int32 [B], +-1
    dir_c: torch.Tensor  # int32 [B], +-1
    paddle_c: torch.Tensor  # int32 [B]
    trail_r: torch.Tensor  # int32 [B], the ball's previous cell
    trail_c: torch.Tensor  # int32 [B]
    bricks: torch.Tensor  # int32 [B, 3, 10]
    last_action: torch.Tensor  # int32 [B], for sticky actions


class DeviceBreakout(_MinAtarBase):
    """Breakout on a 10x10 grid: actions {noop, left, right}."""

    num_actions = 3
    num_channels = 4

    def _reset(self, seed, episode) -> DeviceBreakoutState:
        zero = torch.zeros_like(seed)
        full = lambda value: torch.full_like(seed, value)
        ball_c = _rand_below(_GRID, seed, episode, 11)
        dir_c = 1 - 2 * _rand_below(2, seed, episode, 12)
        return DeviceBreakoutState(
            seed=seed, episode=episode, step=zero,
            episode_return=torch.zeros_like(seed, dtype=torch.float32),
            episode_step=zero, ball_r=full(3), ball_c=ball_c,
            dir_r=full(1), dir_c=dir_c, paddle_c=full(_GRID // 2),
            trail_r=full(3), trail_c=ball_c,
            bricks=torch.ones((seed.shape[0], 3, _GRID), dtype=torch.int32,
                              device=seed.device),
            last_action=zero)

    def _substep(self, state: DeviceBreakoutState, action):
        # The paddle: left or right on the bottom row.
        paddle = torch.clamp(
            state.paddle_c - (action == 1).to(torch.int32)
            + (action == 2).to(torch.int32), 0, _GRID - 1)
        # The side walls first: flip dir_c where the move would leave.
        cand_c = state.ball_c + state.dir_c
        dir_c = torch.where((cand_c < 0) | (cand_c >= _GRID),
                            -state.dir_c, state.dir_c)
        new_c = state.ball_c + dir_c
        cand_r = state.ball_r + state.dir_r
        dir_r = torch.where(cand_r < 0, -state.dir_r, state.dir_r)
        new_r = state.ball_r + dir_r
        # A brick hit (rows 1..3): remove it, score, bounce back in r.
        in_bricks = (new_r >= 1) & (new_r <= 3)
        brick_row = torch.clamp(new_r - 1, 0, 2)
        cell = (brick_row * _GRID + new_c).to(torch.int64)
        flat = state.bricks.reshape(-1, 3 * _GRID)
        brick = flat.gather(1, cell[:, None])[:, 0]
        hit = in_bricks & (brick > 0)
        slot = (torch.arange(3 * _GRID, device=cell.device)[None, :]
                == cell[:, None])
        bricks = torch.where(slot & hit[:, None], 0, flat).reshape(
            state.bricks.shape)
        reward = hit.to(torch.float32)
        dir_r = torch.where(hit, -dir_r, dir_r)
        new_r = torch.where(hit, state.ball_r, new_r)
        # The bottom row: the paddle saves (bounce), else the ball is lost.
        at_bottom = new_r >= _GRID - 1
        saved = at_bottom & (new_c == paddle)
        dir_r = torch.where(saved, -dir_r, dir_r)
        new_r = torch.where(saved, state.ball_r, new_r)
        lost = at_bottom & ~saved
        # A cleared wall respawns (the next wave).
        cleared = bricks.sum(dim=(1, 2)) == 0
        bricks = torch.where(cleared[:, None, None], 1, bricks)
        step = state.step + 1
        terminated = lost | (step >= self.episode_length)
        new_state = state._replace(
            step=step, ball_r=new_r, ball_c=new_c, dir_r=dir_r,
            dir_c=dir_c, paddle_c=paddle, trail_r=state.ball_r,
            trail_c=state.ball_c, bricks=bricks, last_action=action)
        return new_state, reward, terminated

    def _frame(self, state: DeviceBreakoutState) -> torch.Tensor:
        rows, cols = _grid(state.ball_r.device)
        paddle = _at(rows, cols, torch.full_like(state.paddle_c, _GRID - 1),
                     state.paddle_c)
        ball = _at(rows, cols, state.ball_r, state.ball_c)
        trail = _at(rows, cols, state.trail_r, state.trail_c)
        bricks = torch.zeros((state.bricks.shape[0], _GRID, _GRID),
                             dtype=torch.int32, device=state.bricks.device)
        bricks[:, 1:4, :] = state.bricks
        bricks = (bricks * 255).to(torch.uint8)
        return torch.stack([paddle, ball, trail, bricks], dim=-1)


_SLOTS = 8  # concurrent entity lanes in asterix
_SPAWN_EVERY = 3  # simulator steps between spawn attempts


class DeviceAsterixState(NamedTuple):
    seed: torch.Tensor  # int32 [B]
    episode: torch.Tensor  # int32 [B]
    step: torch.Tensor  # int32 [B]
    episode_return: torch.Tensor  # float32 [B]
    episode_step: torch.Tensor  # int32 [B]
    player_r: torch.Tensor  # int32 [B]
    player_c: torch.Tensor  # int32 [B]
    ent_active: torch.Tensor  # int32 [B, _SLOTS]
    ent_r: torch.Tensor  # int32 [B, _SLOTS]
    ent_c: torch.Tensor  # int32 [B, _SLOTS]
    ent_dir: torch.Tensor  # int32 [B, _SLOTS], +-1
    ent_gold: torch.Tensor  # int32 [B, _SLOTS]
    last_action: torch.Tensor  # int32 [B]


class DeviceAsterix(_MinAtarBase):
    """Asterix on a 10x10 grid: actions {noop, up, down, left, right};
    dodge the horizontally streaming enemies, collect gold."""

    num_actions = 5
    num_channels = 3

    def _reset(self, seed, episode) -> DeviceAsterixState:
        zero = torch.zeros_like(seed)
        slots = lambda value: torch.full((seed.shape[0], _SLOTS), value,
                                         dtype=torch.int32,
                                         device=seed.device)
        return DeviceAsterixState(
            seed=seed, episode=episode, step=zero,
            episode_return=torch.zeros_like(seed, dtype=torch.float32),
            episode_step=zero,
            player_r=torch.full_like(seed, _GRID // 2),
            player_c=torch.full_like(seed, _GRID // 2),
            ent_active=slots(0), ent_r=slots(0), ent_c=slots(0),
            ent_dir=slots(1), ent_gold=slots(0), last_action=zero)

    def _substep(self, state: DeviceAsterixState, action):
        as_int = lambda cond: cond.to(torch.int32)
        # The player: a clamped 4-way move inside the lane rows [1, 8].
        drow = as_int(action == 2) - as_int(action == 1)
        dcol = as_int(action == 4) - as_int(action == 3)
        pr = torch.clamp(state.player_r + drow, 1, _GRID - 2)
        pc = torch.clamp(state.player_c + dcol, 0, _GRID - 1)
        # Collision check 1 of 2 (MinAtar's order: the player moves,
        # check, the entities move, check again), against the entities'
        # cells before their move, so a player and an entity exchanging
        # cells collide instead of passing through each other.
        pre_colliding = ((state.ent_active > 0)
                         & (state.ent_r == pr[:, None])
                         & (state.ent_c == pc[:, None]))
        # The entities stream one cell in their direction; leaving the
        # grid frees the slot.
        ec = state.ent_c + state.ent_dir * state.ent_active
        off = (ec < 0) | (ec >= _GRID)
        active = state.ent_active * (1 - as_int(off))
        # A spawn attempt every _SPAWN_EVERY steps into a rotating slot,
        # eligible by the slot's occupancy before the move: a slot freed
        # in this very sub-step waits for its next turn.
        step = state.step + 1
        slot = (step // _SPAWN_EVERY) % _SLOTS
        onehot_slot = (torch.arange(_SLOTS, dtype=torch.int32,
                                    device=step.device)[None, :]
                       == slot[:, None])
        slot_active = (state.ent_active * as_int(onehot_slot)).sum(dim=1)
        want_spawn = (step % _SPAWN_EVERY == 0) & (slot_active == 0)
        s_row = 1 + _rand_below(_GRID - 2, state.seed, state.episode, step,
                                21)
        s_dir = 1 - 2 * _rand_below(2, state.seed, state.episode, step, 22)
        s_gold = as_int(_rand_below(3, state.seed, state.episode, step, 23)
                        == 0)
        s_col = torch.where(s_dir > 0, 0, _GRID - 1).to(torch.int32)
        onehot = as_int(onehot_slot) * as_int(want_spawn)[:, None]
        active = active * (1 - onehot) + onehot
        er = state.ent_r * (1 - onehot) + s_row[:, None] * onehot
        ec = ec * (1 - onehot) + s_col[:, None] * onehot
        edir = state.ent_dir * (1 - onehot) + s_dir[:, None] * onehot
        egold = state.ent_gold * (1 - onehot) + s_gold[:, None] * onehot
        # Collision check 2 of 2, at the positions after the move (the
        # spawned slot cannot have collided before it: see above).
        colliding = pre_colliding | ((active > 0) & (er == pr[:, None])
                                     & (ec == pc[:, None]))
        gold_hit = colliding & (egold > 0)
        enemy_hit = colliding & (egold == 0)
        # One reward per collected gold (two converging golds pay 2).
        reward = gold_hit.sum(dim=1).to(torch.float32)
        active = active * (1 - as_int(gold_hit))
        terminated = enemy_hit.any(dim=1) | (step >= self.episode_length)
        new_state = state._replace(
            step=step, player_r=pr, player_c=pc, ent_active=active,
            ent_r=er, ent_c=ec, ent_dir=edir, ent_gold=egold,
            last_action=action)
        return new_state, reward, terminated

    def _frame(self, state: DeviceAsterixState) -> torch.Tensor:
        rows, cols = _grid(state.player_r.device)
        player = _at(rows, cols, state.player_r, state.player_c)
        ent = ((rows[..., None] == state.ent_r[:, None, None, :])
               & (cols[..., None] == state.ent_c[:, None, None, :])
               & (state.ent_active[:, None, None, :] > 0))
        gold = state.ent_gold[:, None, None, :] > 0
        enemies = (ent & ~gold).any(dim=-1)
        golds = (ent & gold).any(dim=-1)
        return torch.stack([player, enemies.to(torch.uint8) * 255,
                            golds.to(torch.uint8) * 255], dim=-1)
