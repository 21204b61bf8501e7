"""How the fused V-trace kernel's time depends on its schedule.

    python3 -m scalable_agent_tpu_torch.tools.vtrace_schedule

Builds ``csrc/vtrace.cu`` once per variant, each copy with another number
of time chunks a CTA splits T into (``kChunks``) or another register
window (the steps a thread loads at once), and times each at T=1, [3, 33],
the learner's [100, 32], [101, 32] and [100, 8192] with torch.profiler,
twice in turns, beside its error against the plain version run at the
same chunk count.  The first variant is the kernel as it is.  Needs one
card and ``nvcc``; builds in a temporary directory under
``scalable_agent_tpu_torch/_build/`` and removes it.
"""

import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from scalable_agent_tpu_torch.ops import _build, vtrace_cuda

SHAPES = ((1, 32), (3, 33), (100, 32), (101, 32), (100, 8192))
CHUNKS = "constexpr int kChunks = 16;"
WINDOW = "constexpr int kMaxWindow = 8;"
DISPATCH = ("  auto* run = longest <= 1 ? launch<1> : longest <= 2 ? launch<2>\n"
            "              : longest <= 4 ? launch<4> : launch<kMaxWindow>;")


def _chunks(n):
    return [(CHUNKS, f"constexpr int kChunks = {n};")]


def _window(k):
    return [(WINDOW, f"constexpr int kMaxWindow = {k};")]


# (chunks, source edits) of each variant.
VARIANTS = {
    "16 chunks, window fit to the chunk (the kernel)": (16, []),
    "16 chunks, a window of 16 at every T": (16, [
        (DISPATCH, "  auto* run = launch<16>;")]),
    "8 chunks, window fit to the chunk (up to 16)": (
        8, _chunks(8) + _window(16)),
    "32 chunks (1024 threads), window fit (up to 4)": (
        32, _chunks(32) + _window(4)),
}


def variant_sources():
    """The source text of each variant; raises if an edit no longer
    applies to the kernel."""
    source = (_build.SOURCE_DIR / "vtrace.cu").read_text()
    texts = {}
    for name, (_, edits) in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build_variants(workdir):
    """One shared library per variant, compiled in parallel; returns each
    one's bound ``sat_vtrace`` and its ptxas register lines."""
    jobs = []
    for i, (name, text) in enumerate(variant_sources().items()):
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
        fn = ctypes.CDLL(str(lib)).sat_vtrace
        fn.argtypes, fn.restype = _build._SIGNATURES["sat_vtrace"]
        registers = re.findall(r"Used (\d+) registers", out)
        built[name] = (fn, registers)
    return built


def _inputs(steps, cols, gen, device):
    uniform = lambda: torch.rand((steps, cols), generator=gen)
    return [(uniform() * 6.0 - 3.0).to(device),
            ((uniform() >= 0.05).float() * 0.99).to(device),
            torch.randn((steps, cols), generator=gen).to(device),
            torch.randn((steps, cols), generator=gen).to(device),
            torch.randn((cols,), generator=gen).to(device)]


def _call(fn, args):
    vs, pg = torch.empty_like(args[3]), torch.empty_like(args[3])
    code = fn(*(t.data_ptr() for t in args), vs.data_ptr(), pg.data_ptr(),
              args[0].shape[0], args[0].shape[1], 1.0, 1, 1.0, 1,
              torch.cuda.current_stream().cuda_stream)
    _build.check(code, "vtrace variant")
    return vs, pg


def device_us(fn, iters=50):
    """Mean device microseconds per call of the kernel (torch.profiler)."""
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
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and "vtrace_chunked_kernel" in evt.key):
            total += getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0.0)
    return total / iters


def main():
    device = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(5)
    data = {shape: _inputs(*shape, gen, device) for shape in SHAPES}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="vtrace_schedule_",
                               dir=_build.BUILD_DIR)
    try:
        built = build_variants(Path(workdir))
        for name, (_, registers) in built.items():
            print(f"{name}: registers {registers}", flush=True)
        for turn in (1, 2):
            for name, (fn, _) in built.items():
                chunks = VARIANTS[name][0]
                cells = []
                for shape, args in data.items():
                    got = _call(fn, args)
                    want = vtrace_cuda.vtrace_fused_plain(*args,
                                                          chunks=chunks)
                    torch.cuda.synchronize()
                    err = max(float((g - w).abs().max())
                              / max(float(w.abs().max()), 1.0)
                              for g, w in zip(got, want))
                    us = device_us(lambda: _call(fn, args))
                    cells.append(f"[{shape[0]},{shape[1]}] {us:.2f} us "
                                 f"(err {err:.1e})")
                print(f"turn {turn}, {name}: " + "; ".join(cells),
                      flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
