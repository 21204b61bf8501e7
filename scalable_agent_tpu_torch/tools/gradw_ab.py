"""Time the ResNet stem's grad-W kernels (``conv_cuda.conv_gradw`` at
(K, S, C, F) = (3, 1, 3, 16)) at another checkout of this repository and
at this one, on the same card, each in its own process: other, this,
this, other.

    python3 -m scalable_agent_tpu_torch.tools.gradw_ab --other=<dir>

Each process builds its checkout's kernels, then reads the device ms per
call of the kernels a ``conv_gradw`` launches at the learner's N = 3232
frames of 72x96 (torch.profiler over 10 calls after one, each kernel's ms
per recorded launch times its launches per call, as chip_smoke.py's
``_kernel_ms``: the profiler can drop records): float32 and bf16 x and g,
each with both tensors contiguous NHWC and both NHWC views of NCHW
memory, and cuDNN's ``conv2d_weight`` on the same NHWC inputs (float32
with TF32 off).  This prints them with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

_TIME = r'''
import json
import torch
from scalable_agent_tpu_torch.ops import _build, conv_cuda

def device_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.count:
            us = getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0.0)
            per_call = max(1, round(evt.count / iters))
            total += us / 1e3 / evt.count * per_call
    return total

if __name__ == "__main__":
    _build.library()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(8765)
    n, h, w = 3232, 72, 96
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bf16", torch.bfloat16)):
        x = (torch.randint(0, 256, (n, h, w, 3), generator=gen,
                           dtype=torch.uint8).cuda().to(dtype) / 255.0)
        g = torch.randn((n, h, w, 16), generator=gen).cuda().to(dtype)
        for layout, xx, gg in (("nhwc", x, g),
                               ("planar", planar(x), planar(g))):
            out[f"{name} {layout}"] = device_ms(
                lambda: conv_cuda.conv_gradw(xx, gg, 3, 1))
            del xx, gg
        out[f"{name} cudnn"] = device_ms(
            lambda: torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (16, 3, 3, 3), g.permute(0, 3, 1, 2),
                1, 1))
        del x, g
        torch.cuda.empty_cache()
    print("DEVICE_MS", json.dumps(out), flush=True)
'''


def _run(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _TIME], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("DEVICE_MS")]
    if proc.returncode or not lines:
        raise RuntimeError(f"the run at {root} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[0].split(" ", 1)[1])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the other checkout")
    args = parser.parse_args(argv)
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    other = os.path.abspath(args.other)
    for name, root in (("other", other), ("this", this), ("this", this),
                       ("other", other)):
        ms = _run(root)
        print(f"{name} checkout: " + ", ".join(
            f"{key} {value:.4f} ms" for key, value in ms.items()),
            flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
