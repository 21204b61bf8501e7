"""How the 8x8 stem grad-W kernel's 4-channel instantiation depends on the
channels one thread's tile holds.

    python3 -m scalable_agent_tpu_torch.tools.gradw_c4_tile

Builds ``csrc/conv.cu`` once per variant of ``TileChannels<4>::kCT``: 2
channels a thread (the kernel: 8 x 8 accumulators, three row groups of
128 threads) and 4 (16 x 8 accumulators, six row groups of 64 threads,
as the 3-channel kernel's whole-channel tile), prints each variant's
ptxas registers and spills for its C = 4 band kernels, then times each at
the Atari learner's x [3232, 84, 84, 4] and g [3232, 21, 21, 32], float32
(the band kernel is float32 only: bf16 x and g take
``conv_gradw_mma_kernel``), contiguous NHWC and NHWC views of NCHW
memory, twice in turns
(device ms per call from torch.profiler, each kernel's time divided by its
recorded launches, as ``chip_smoke.py``'s ``_kernel_ms``), beside its
error against ``conv_gradw_plain`` and cuDNN's ``conv2d_weight`` on the
same inputs.  Needs one card and ``nvcc``; builds in a temporary directory
under ``scalable_agent_tpu_torch/_build/`` and removes it.
"""

import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from scalable_agent_tpu_torch.ops import _build, conv_cuda

TILE = ("template <>\nstruct TileChannels<4> {\n"
        "  static constexpr int kCT = 2;\n};")
# (channels a thread, row groups, source edits) of each variant.
VARIANTS = {
    "2 channels a thread (the kernel)": (2, 3, []),
    "4 channels a thread": (4, 6, [(TILE, TILE.replace("kCT = 2",
                                                       "kCT = 4"))]),
}
N, H, W, C, F = 3232, 84, 84, 4, 32


def build_variants(workdir):
    """One shared library per variant, compiled in parallel; returns each
    one's bound float32 C = 4 entry point and its ptxas lines for the
    C = 4 band kernels."""
    source = (_build.SOURCE_DIR / "conv.cu").read_text()
    jobs = []
    for i, (name, (_, _, edits)) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        src, lib = workdir / f"variant{i}.cu", workdir / f"variant{i}.so"
        src.write_text(text)
        jobs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SOURCE_DIR),
             "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, lib, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        entry = conv_cuda._VARIANTS[conv_cuda.STEM_C4][torch.float32][0]
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = _build._SIGNATURES[entry]
        # Each kernel's "Function properties" line is followed by its
        # stack/spill line and its "Used N registers" line.
        lines = out.splitlines()
        report = [f"{lines[i + 1].strip()}; {lines[i + 2].strip()}"
                  for i, line in enumerate(lines[:-2])
                  if "Function properties" in line
                  and re.search(r"conv_gradw_band_kernel\w*Li4E", line)]
        built[name] = (fn, report)
    return built


def _call(fn, groups, x, g):
    """One launch of a variant's kernel through conv_cuda's plan, its
    reduce sized for the variant's row groups."""
    x_chw = conv_cuda.tensor_layout(x) == "chw"
    g_chw = conv_cuda.tensor_layout(g) == "chw"
    kept = conv_cuda.GRADW_GROUPS[C]
    conv_cuda.GRADW_GROUPS[C] = groups
    try:
        plan = conv_cuda.gradw_plan(
            N, 21, 21, x_chw, g_chw,
            torch.cuda.get_device_properties(0).multi_processor_count, C)
    finally:
        conv_cuda.GRADW_GROUPS[C] = kept
    dw = torch.empty((8, 8, C, F), dtype=torch.float32, device=x.device)
    partial = torch.empty((plan.blocks, 8 * 8 * C * F), dtype=torch.float32,
                          device=x.device)
    code = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
              H, W, 21, 21, 2, 2, plan.band_rows, plan.bands, plan.xrs,
              plan.x_floats, plan.gps, plan.stage_floats, plan.smem_bytes,
              int(x_chw), int(g_chw), plan.units, plan.blocks,
              torch.cuda.current_stream().cuda_stream)
    _build.check(code, "grad-W variant")
    return dw


def device_ms(fn, iters=10):
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
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(8484)
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    x32 = (torch.randint(0, 256, (N, H, W, C), generator=gen,
                         dtype=torch.uint8).to(device).float() / 255.0)
    g32 = torch.randn((N, 21, 21, F), generator=gen).to(device)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="gradw_c4_tile_",
                               dir=_build.BUILD_DIR)
    try:
        built = build_variants(Path(workdir))
        for name, (_, report) in built.items():
            print(f"{name}: " + " | ".join(report), flush=True)
        x, g = x32, g32
        want = conv_cuda.conv_gradw_plain(x, g, 8, 4)
        cudnn = lambda: torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (F, C, 8, 8), g.permute(0, 3, 1, 2), 4, 2)
        print(f"cuDNN conv2d_weight device {device_ms(cudnn):.4f} ms",
              flush=True)
        for turn in (1, 2):
            for name, (fn, _) in built.items():
                groups = VARIANTS[name][1]
                cells = []
                for layout, xx, gg in (("NHWC", x, g),
                                       ("planar", planar(x), planar(g))):
                    call = lambda: _call(fn, groups, xx, gg)
                    got = call()
                    err = float((got - want).abs().max() / want.abs().max())
                    cells.append(f"{layout} {device_ms(call):.4f} ms "
                                 f"(err {err:.1e})")
                print(f"turn {turn}, {name}: " + "; ".join(cells),
                      flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
