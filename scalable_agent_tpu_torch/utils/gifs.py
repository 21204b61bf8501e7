"""GIF encoding by piping raw frames through ffmpeg: a copy of
``scalable_agent_tpu/utils/gifs.py`` (reference: utils/gifs.py:4-29).
Without the ``ffmpeg`` binary on ``PATH`` it raises, as the JAX one does.
"""

import shutil
import subprocess
from typing import Sequence

import numpy as np


def encode_gif(frames: Sequence[np.ndarray], fps: int = 30) -> bytes:
    """RGB uint8 [H, W, 3] frames -> animated GIF bytes."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames to encode")
    h, w, c = frames[0].shape
    if c != 3:
        raise ValueError(f"need RGB frames, got {c} channels")
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("encode_gif needs the ffmpeg binary on PATH")
    cmd = [
        "ffmpeg", "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
        "-r", f"{fps:.02f}", "-s", f"{w}x{h}", "-pix_fmt", "rgb24",
        "-i", "-", "-filter_complex",
        "[0:v]split[x][z];[z]palettegen[y];[x]paletteuse",
        "-r", f"{fps:.02f}", "-f", "gif", "-",
    ]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    data, err = proc.communicate(
        input=b"".join(np.ascontiguousarray(f, np.uint8).tobytes()
                       for f in frames))
    if proc.returncode:
        raise RuntimeError(f"ffmpeg failed: {err.decode()[-500:]}")
    return data
