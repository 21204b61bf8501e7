"""Doom tooling: throughput sampling, observation grids, demo replay and
human play.  A copy of ``scalable_agent_tpu/envs/doom/tools.py`` over this
package's ``envs/doom`` (reference: envs/doom/sample_env.py:8-18, the
random-policy FPS sampler; doom_render.py:5-34, the observation grid;
doom_play_demo.py:14-51, the demo replayer; play_doom.py:8-18, human
play).  Run e.g.:

    python -m scalable_agent_tpu_torch.envs.doom.tools sample doom_benchmark
"""

import math
import os
import sys
import time
from typing import List, Optional

import numpy as np

from scalable_agent_tpu_torch.envs.doom.factory import make_doom_env
from scalable_agent_tpu_torch.utils import log


def sample_env(env_name: str = "doom_benchmark", num_steps: int = 1000,
               num_action_repeats: int = 4, seed: int = 0) -> float:
    """Random-policy throughput probe; returns env frames/s (reference:
    sample_env.py:8-18)."""
    env = make_doom_env(env_name, num_action_repeats=num_action_repeats)
    rng = np.random.default_rng(seed)
    try:
        env.reset()
        t0 = time.perf_counter()
        for _ in range(num_steps):
            _, _, done, _ = env.step(env.action_space.sample(rng))
            if done:
                env.reset()
        dt = time.perf_counter() - t0
        fps = num_steps * num_action_repeats / dt
        log.info("%s: %.1f env frames/s (%.1f agent steps/s)",
                 env_name, fps, num_steps / dt)
        return fps
    finally:
        env.close()


def concat_grid(frames: List[np.ndarray]) -> np.ndarray:
    """Tile per-agent frames into one image, row-major on a
    ceil(sqrt(n))-wide grid, empty cells zero (reference:
    doom_render.py:5-34)."""
    if not frames:
        raise ValueError("no frames")
    n = len(frames)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    h, w, c = frames[0].shape
    grid = np.zeros((rows * h, cols * w, c), frames[0].dtype)
    for i, frame in enumerate(frames):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = frame
    return grid


def _reinit_game(env_name: str, mode, visible: bool = False,
                 num_action_repeats: int = 4):
    """(env, game) with the env's DoomGame re-initialized in ``mode``:
    build the env pipeline, then close, reconfigure and re-init the raw
    game (the preamble of replay and human play)."""
    env = make_doom_env(env_name, num_action_repeats=num_action_repeats)
    base = env.unwrapped
    base._ensure_game()
    game = base.game
    game.close()
    if visible:
        game.set_window_visible(True)
    game.set_mode(mode)
    game.init()
    return env, game


def replay_demo(env_name: str, demo_path: str,
                out_dir: Optional[str] = None,
                num_action_repeats: int = 4) -> int:
    """Replay a recorded .lmp demo, saving each frame as a .npy file
    under ``out_dir`` (default ``<demo>_frames``); returns the frame count
    (reference: doom_play_demo.py:14-51, PNG via cv2 there)."""
    import vizdoom

    env, game = _reinit_game(env_name, vizdoom.Mode.PLAYER,
                             num_action_repeats=num_action_repeats)
    game.replay_episode(demo_path)
    frames = 0
    out_dir = out_dir or os.path.splitext(demo_path)[0] + "_frames"
    os.makedirs(out_dir, exist_ok=True)
    try:
        while not game.is_episode_finished():
            state = game.get_state()
            if state is not None and state.screen_buffer is not None:
                frame = np.transpose(state.screen_buffer, (1, 2, 0))
                np.save(os.path.join(out_dir, f"{frames:05d}.npy"), frame)
                frames += 1
            game.advance_action()
        return frames
    finally:
        env.close()


def play_human(env_name: str = "doom_basic", episodes: int = 1) -> None:
    """Interactive human play in VizDoom's ASYNC_SPECTATOR mode: it needs
    a display, the engine runs in real time at 35 tics/s and the human
    drives the VizDoom window (reference: play_doom.py:8-18)."""
    import vizdoom

    env, game = _reinit_game(env_name, vizdoom.Mode.ASYNC_SPECTATOR,
                             visible=True)
    try:
        for episode in range(episodes):
            game.new_episode()
            while not game.is_episode_finished():
                game.advance_action()
            log.info("episode %d reward: %.1f",
                     episode, game.get_total_reward())
    finally:
        env.close()


def main(argv=None):
    """``sample <env_name> [num_steps] [num_action_repeats] [seed]``,
    ``replay <env_name> <demo_path> [out_dir] [num_action_repeats]`` or
    ``play [env_name] [episodes]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return
    command, args = argv[0], argv[1:]
    if command == "sample":
        sample_env(args[0] if args else "doom_benchmark",
                   *map(int, args[1:4]))
    elif command == "replay":
        if len(args) < 2:
            raise SystemExit(
                "usage: replay <env_name> <demo_path> [out_dir] "
                "[num_action_repeats]")
        replay_demo(args[0], args[1], args[2] if len(args) > 2 else None,
                    *map(int, args[3:4]))
    elif command == "play":
        play_human(args[0] if args else "doom_basic", *map(int, args[1:2]))
    else:
        raise SystemExit(f"unknown command {command!r}")


if __name__ == "__main__":
    main()
