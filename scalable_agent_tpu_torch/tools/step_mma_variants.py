"""How the bf16 lean step kernel's time depends on its geometry.

    python3 -m scalable_agent_tpu_torch.tools.step_mma_variants

Builds ``csrc/lstm.cu`` once per variant of ``lstm_step_mma_kernel``'s
``kMmaStepUnits`` (hidden units a CTA: its gate columns are four times
as many), ``kMmaStepRows`` (batch rows a CTA: 16 or 32) and
``kMmaStepDepth`` (k16 steps a warp loads into registers before it uses
any), the kernel's own geometry first.  Each variant is held against the
plain bf16 step (``lstm_step_plain``) at the paths' shapes, x [1, B, D],
H=256, then timed at B=32 and D in (266, 265, 330), twice in turns,
beside bf16 ``torch.lstm_cell`` after the done-reset on the same inputs
(device ms per call from torch.profiler, each kernel's time divided by
its recorded launches, as ``chip_smoke.py``'s ``_kernel_ms``).  Needs one
card and ``nvcc``; builds in a temporary directory under
``scalable_agent_tpu_torch/_build/`` and removes it.
"""

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from scalable_agent_tpu_torch.ops import _build, lstm_cuda

CONSTANTS = ("kMmaStepUnits", "kMmaStepRows", "kMmaStepDepth")
# (units, rows, depth) of each variant; the kernel's own is first.
VARIANTS = {"8 units, 16 rows (the kernel)": (8, 16, 5),
            "4 units, 16 rows": (4, 16, 5), "2 units, 16 rows": (2, 16, 5),
            "8 units, 32 rows": (8, 32, 5), "4 units, 32 rows": (4, 32, 5),
            "8 units, 16 rows, 3 steps a round": (8, 16, 3)}
HIDDEN = 256
CHECKS = ((266, 32), (265, 32), (330, 32), (266, 1), (266, 64), (259, 8),
          (261, 33))
TOL = 1e-4  # chip_smoke.LSTM_TOL


def build_variants(workdir):
    """One shared library per variant, compiled in parallel; returns each
    one's bound ``sat_lstm_step_bf16``."""
    source = (_build.SOURCE_DIR / "lstm.cu").read_text()
    kernel = VARIANTS["8 units, 16 rows (the kernel)"]
    jobs = []
    for i, (name, values) in enumerate(VARIANTS.items()):
        text = source
        for constant, old, new in zip(CONSTANTS, kernel, values):
            line = f"constexpr int {constant} = {old};"
            if text.count(line) != 1:
                raise RuntimeError(f"the kernel no longer has {line!r}")
            text = text.replace(line, f"constexpr int {constant} = {new};")
        src, lib = workdir / f"variant{i}.cu", workdir / f"variant{i}.so"
        src.write_text(text)
        jobs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, lib, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        fn = ctypes.CDLL(str(lib)).sat_lstm_step_bf16
        fn.argtypes, fn.restype = _build._SIGNATURES["sat_lstm_step_bf16"]
        built[name] = fn
    return built


def _case(gen, device, in_dim, batch):
    """Step inputs (x [1, B, D], done, c0, h0, Wi, Wh, b) on the card."""
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    done = (torch.rand((1, batch), generator=gen) < 0.3).float().to(device)
    return (rand(1, batch, in_dim), done, rand(batch, HIDDEN, scale=0.5),
            torch.tanh(rand(batch, HIDDEN)),
            rand(in_dim, 4 * HIDDEN, scale=in_dim ** -0.5),
            rand(HIDDEN, 4 * HIDDEN, scale=HIDDEN ** -0.5),
            rand(4 * HIDDEN, scale=0.1))


def _call(fn, args):
    x, _, c0 = args[:3]
    batch, in_dim = x.shape[1:]
    y = torch.empty((1, batch, HIDDEN), device=x.device)
    c = torch.empty_like(c0)
    code = fn(*(t.data_ptr() for t in (*args, y, c)), batch, in_dim, HIDDEN,
              torch.cuda.current_stream().cuda_stream)
    _build.check(code, "lstm step variant")
    return y, c


def device_ms(fn, iters=200):
    """Device ms per call of everything ``fn`` launches (torch.profiler):
    each kernel's time over its recorded launches, times its launches per
    call (the profiler can drop records on the card)."""
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
            total += us / 1e3 / evt.count * max(1, round(evt.count / iters))
    return total


def main():
    device = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(266)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="step_mma_variants_",
                               dir=_build.BUILD_DIR)
    try:
        built = build_variants(Path(workdir))
        for in_dim, batch in CHECKS:
            args = _case(gen, device, in_dim, batch)
            h, c = lstm_cuda.lstm_step_plain(args[0][0], args[1][0],
                                             *args[2:], "bfloat16")
            for name, fn in built.items():
                y, c_new = _call(fn, args)
                err = max(float((y[0] - h).abs().max()),
                          float((c_new - c).abs().max()))
                scale = max(float(h.abs().max()), float(c.abs().max()), 1.0)
                if not err / scale <= TOL:
                    raise AssertionError(f"{name} at D={in_dim}, B={batch}: "
                                         f"error {err:.3e}")
        print(f"every variant within {TOL:.0e} of the plain step at "
              f"(D, B) in {CHECKS}", flush=True)
        for in_dim in (266, 265, 330):
            args = _case(gen, device, in_dim, 32)
            keep = (1.0 - args[1][0])[:, None]
            x, _, c0, h0, wi, wh, b = args
            cell_args = tuple(t.bfloat16() for t in (
                x[0], h0 * keep, c0 * keep, wi.t(), wh.t(), b,
                torch.zeros_like(b)))
            cell = lambda: torch.lstm_cell(cell_args[0], cell_args[1:3],
                                           *cell_args[3:])
            times = {name: [] for name in built}
            cells = []
            for turn in (list(built), list(built)[::-1]):
                cells.append(device_ms(cell))
                for name in turn:
                    times[name].append(device_ms(
                        lambda: _call(built[name], args)))
            print(f"D={in_dim}, B=32: bf16 torch.lstm_cell after the reset "
                  f"{' / '.join(f'{t:.4f}' for t in cells)} ms", flush=True)
            for name, ms in times.items():
                print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ms)} ms",
                      flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
