"""Where one step of BPTT's reverse-chain kernel spends its time.

    python3 -m scalable_agent_tpu_torch.tools.bptt_step_split

Builds ``csrc/lstm.cu`` six times, each copy with parts of
``bptt_chain_kernel``'s step taken out (the depth reduction's FMAs, the
remote dgates stores, the cluster barrier), and times the chain of each at
the main path's shapes (T=101, B=32, D=266, H=256) in both operand
variants with torch.profiler.  Only the first copy computes the right
gradients; the others exist to be timed, and the differences between
their times say what each part costs a step.  Needs one card and
``nvcc``; builds under ``scalable_agent_tpu_torch/_build/`` and removes
what it built.
"""

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from scalable_agent_tpu_torch.ops import _build, lstm_cuda

STEPS, BATCH, IN_DIM, HIDDEN = 101, 32, 266, 256
FMAS = [("for (int j = jb; j < jm; j += 4) {",
         "for (int j = jb; j < jb; j += 4) {"),
        ("for (int j = jm; j < je; j += 4) {",
         "for (int j = jm; j < jm; j += 4) {")]
REMOTE = [("*cluster.map_shared_rank(dgb + s * H + fj, q) = v;",
           "dgb[s * H + fj] = v;")]
BARRIER = [("    cluster.sync();\n    float4 acc[R];",
            "    __syncthreads();\n    float4 acc[R];")]
VARIANTS = {
    "full step": [],
    "no reduction FMAs": FMAS,
    "no remote stores (one local store)": REMOTE,
    "cluster barrier -> __syncthreads": BARRIER,
    "no FMAs, no remote stores": FMAS + REMOTE,
    "no FMAs, no remote stores, no cluster barrier": FMAS + REMOTE + BARRIER,
}


def build_variants(workdir):
    """One shared library per variant, compiled in parallel."""
    source = (_build.SOURCE_DIR / "lstm.cu").read_text()
    jobs = []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        src, lib = workdir / f"variant{i}.cu", workdir / f"variant{i}.so"
        src.write_text(text)
        flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
        jobs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *flags, "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libraries = {}
    for name, lib, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for entry, (argtypes, restype) in _build._SIGNATURES.items():
            if entry.startswith(("sat_lstm", "sat_error")):
                fn = getattr(handle, entry)
                fn.argtypes, fn.restype = argtypes, restype
        libraries[name] = handle
    return libraries


def chain_ms(fn, iters=20):
    """Mean device ms per call of the chain kernel (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "bptt_chain_kernel" in e.key)
    return us / 1e3 / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(1234)
    device = torch.device("cuda")
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    x = rand(STEPS, BATCH, IN_DIM)
    done = (torch.rand((STEPS, BATCH), generator=gen) < 0.05).float().to(
        device)
    c0, h0 = rand(BATCH, HIDDEN, scale=0.5), torch.tanh(rand(BATCH, HIDDEN))
    wi = rand(IN_DIM, 4 * HIDDEN, scale=IN_DIM ** -0.5)
    wh = rand(HIDDEN, 4 * HIDDEN, scale=HIDDEN ** -0.5)
    b = rand(4 * HIDDEN, scale=0.1)
    res = lstm_cuda.lstm_forward(x, done, c0, h0, wi, wh, b, True,
                                 "bfloat16").residuals
    dys, dct, dht = (rand(STEPS, BATCH, HIDDEN), rand(BATCH, HIDDEN),
                     rand(BATCH, HIDDEN))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="step_split_", dir=_build.BUILD_DIR)
    try:
        libraries = build_variants(Path(workdir))
        for matmul_dtype in ("bfloat16", "float32"):
            for name, library in libraries.items():
                _build._library = library
                ms = chain_ms(lambda: lstm_cuda.lstm_backward(
                    dys, dct, dht, x, done, wi, wh, res, matmul_dtype))
                print(f"  {matmul_dtype} chain, {name}: {ms:.4f} ms, "
                      f"{1e3 * ms / STEPS:.3f} us a step", flush=True)
    finally:
        _build._library = None
        shutil.rmtree(workdir, ignore_errors=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
