#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``scalable_agent_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without printing
a result:

1. The card (``nvidia-smi`` name and power limit, torch's device name),
   then the build of every hand-written kernel from ``csrc/*.cu``.
2. Each kernel against its plain PyTorch version at the main path's
   shapes (T=101, B=32, D=266, H=256 for the LSTM; N=3232 frames of
   72x96x3 for the stem grad-W), float32 with TF32 off, random inputs from
   a seeded generator with ~5% done=1: max abs and scale-floored relative
   error against the stated tolerance, and times from CUDA events (kernel,
   plain version, and ``torch.nn.grad.conv2d_weight`` as the grad-W
   yardstick).  Then the whole agent, forward and every parameter
   gradient, on the card against the same weights on the CPU.
3. Train: ``driver.train`` on ``fake_benchmark`` at full width (64
   actors, batch 32, unroll 100, 4 action repeats, LSTM 256) for 4
   updates, with every launch counter set to 0 just before and read just
   after: losses finite, env_frames exact, and every kernel of the path
   launched (lean forward >= 100 per update, residual forward, BPTT and
   grad-W once per update).
4. A ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

import json
import math
import subprocess
import sys
import time

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
F32_FLOP_PER_S = 67e12      # H100 SXM float32 without tensor cores
LSTM_TOL = 1e-4             # scale-relative; f32 sums in another order
GRADW_TOL = 1e-4            # scale-relative over 1.4 M summed rows
AGENT_TOL = 1e-3            # whole model: cuDNN convs vs CPU convs
UPDATES = 4


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters):
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _errors(pairs):
    """(max abs error, max scale-floored relative error) over
    (kernel, plain) output pairs; each scale is max(max|plain|, 1)."""
    worst_abs = worst_rel = 0.0
    for kernel, plain in pairs:
        diff = float((kernel - plain).abs().max())
        scale = max(float(plain.abs().max()), 1.0)
        worst_abs = max(worst_abs, diff)
        worst_rel = max(worst_rel, diff / scale)
    return worst_abs, worst_rel


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check(name, err_abs, err_rel, tol):
    print(f"  {name}: max_abs_err {err_abs:.3e} max_rel_err {err_rel:.3e} "
          f"(tolerance {tol:.0e})", flush=True)
    if not err_rel <= tol:
        raise AssertionError(f"{name} disagrees with its plain version")


def compare_lstm(torch, lstm_cuda, device):
    """Lean forward (T=1), residual forward and BPTT (T=101) vs plain."""
    gen = torch.Generator().manual_seed(1234)
    T, B, D, H = 101, 32, 266, 256
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    x = rand(T, B, D)
    done = (torch.rand((T, B), generator=gen) < 0.05).float().to(device)
    c0, h0 = rand(B, H, scale=0.5), torch.tanh(rand(B, H))
    wi, wh = rand(D, 4 * H, scale=D ** -0.5), rand(H, 4 * H, scale=H ** -0.5)
    b = rand(4 * H, scale=0.1)
    rows = []
    f4 = 4  # bytes per float32

    # Lean forward at the actor's T=1.
    args1 = (x[:1].contiguous(), done[:1].contiguous(), c0, h0, wi, wh, b)
    kern = lstm_cuda.lstm_forward(*args1, residuals=False)
    plain = lstm_cuda.lstm_forward_plain(*args1, residuals=False)
    torch.cuda.synchronize()
    err = _errors(zip(kern[:3], plain[:3]))
    _check("lstm_fwd_lean", *err, LSTM_TOL)
    nbytes = f4 * (B * D + B + 2 * B * H + (D + H + 1) * 4 * H
                   + B * H + 2 * B * H)
    flops = 2 * B * (D + H) * 4 * H + 12 * B * H
    rows.append(("lstm_fwd_lean", "lstm.cu", "lstm_pallas.py:89", err,
                 lambda: lstm_cuda.lstm_forward(*args1, residuals=False),
                 lambda: lstm_cuda.lstm_forward_plain(*args1,
                                                      residuals=False),
                 None, nbytes, flops))

    # Residual forward over the learner's T+1 = 101 steps.
    args = (x, done, c0, h0, wi, wh, b)
    kern = lstm_cuda.lstm_forward(*args, residuals=True)
    plain = lstm_cuda.lstm_forward_plain(*args, residuals=True)
    torch.cuda.synchronize()
    err = _errors(zip(kern[:3] + tuple(kern.residuals),
                      plain[:3] + tuple(plain.residuals)))
    _check("lstm_fwd_resid", *err, LSTM_TOL)
    nbytes = f4 * (T * B * D + T * B + 2 * B * H + (D + H + 1) * 4 * H
                   + T * B * H * 8 + 2 * B * H)
    flops = T * (2 * B * (D + H) * 4 * H + 12 * B * H)
    rows.append(("lstm_fwd_resid", "lstm.cu", "lstm_pallas.py:105", err,
                 lambda: lstm_cuda.lstm_forward(*args, residuals=True),
                 lambda: lstm_cuda.lstm_forward_plain(*args, residuals=True),
                 None, nbytes, flops))

    # BPTT on the plain residuals, so only the backward differs.
    res = plain.residuals
    dys, dct, dht = rand(T, B, H), rand(B, H), rand(B, H)
    bargs = (dys, dct, dht, x, done, wi, wh, res)
    kern = lstm_cuda.lstm_backward(*bargs)
    plain = lstm_cuda.lstm_backward_plain(*bargs)
    torch.cuda.synchronize()
    err = _errors(zip(kern, plain))
    _check("lstm_bptt", *err, LSTM_TOL)
    nbytes = f4 * (T * B * H + 2 * B * H + T * B * D + T * B
                   + T * B * 4 * H + 3 * T * B * H + (D + H) * 4 * H
                   + T * B * D + (D + H + 1) * 4 * H + 2 * B * H)
    flops = (2 * T * B * 4 * H * (H + D + D + H) + T * B * 4 * H
             + 20 * T * B * H)
    rows.append(("lstm_bptt", "lstm.cu", "lstm_pallas.py:123", err,
                 lambda: lstm_cuda.lstm_backward(*bargs),
                 lambda: lstm_cuda.lstm_backward_plain(*bargs),
                 None, nbytes, flops))
    return rows


def compare_gradw(torch, conv_cuda, device):
    """The stem grad-W at the learner's merged batch N = 101 * 32."""
    gen = torch.Generator().manual_seed(4321)
    N, Hh, W, C, K, S, Fo = 101 * 32, 72, 96, 3, 8, 4, 32
    OH, OW = -(-Hh // S), -(-W // S)
    x = (torch.randint(0, 256, (N, Hh, W, C), generator=gen,
                       dtype=torch.uint8).to(device).float() / 255.0)
    g = torch.randn((N, OH, OW, Fo), generator=gen).to(device)
    kern = conv_cuda.conv_gradw(x, g, K, S)
    plain = conv_cuda.conv_gradw_plain(x, g, K, S)
    _, (pad, _) = conv_cuda.same_pads(Hh, K, S)
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    library = lambda: torch.nn.grad.conv2d_weight(
        x_nchw, (Fo, C, K, K), g_nchw, S, pad)
    lib_dw = library().permute(2, 3, 1, 0)
    torch.cuda.synchronize()
    err = _errors([(kern, plain)])
    _check("stem_gradw", *err, GRADW_TOL)
    lib_err = _errors([(lib_dw, plain)])
    print(f"  (cuDNN's conv2d_weight against the same plain version: "
          f"max_rel_err {lib_err[1]:.3e})", flush=True)
    nbytes = 4 * (N * Hh * W * C + N * OH * OW * Fo + K * K * C * Fo)
    flops = 2 * N * OH * OW * K * K * C * Fo
    return [("stem_gradw", "conv.cu", "conv_pallas.py:86", err,
             lambda: conv_cuda.conv_gradw(x, g, K, S),
             lambda: conv_cuda.conv_gradw_plain(x, g, K, S),
             library, nbytes, flops)]


def compare_agent(torch, device):
    """Forward and every parameter gradient of the whole agent on the card
    against the same weights on the CPU (plain versions, CPU convs), at
    full width and a short unroll."""
    import copy

    from scalable_agent_tpu_torch.models import ImpalaAgent
    from scalable_agent_tpu_torch.types import (
        AgentState,
        Observation,
        StepOutput,
        StepOutputInfo,
    )

    gen = torch.Generator().manual_seed(99)
    T, B = 5, 4
    agent_cpu = ImpalaAgent(9, (72, 96, 3), generator=gen)
    agent_gpu = copy.deepcopy(agent_cpu).to(device)

    def inputs(dev):
        g = torch.Generator().manual_seed(7)
        frame = torch.randint(0, 256, (T, B, 72, 96, 3), generator=g,
                              dtype=torch.uint8).to(dev)
        reward = torch.randn((T, B), generator=g).to(dev)
        done = (torch.rand((T, B), generator=g) < 0.25).to(dev)
        actions = torch.randint(0, 9, (T, B), generator=g).to(dev)
        state = AgentState(
            c=(torch.randn((B, 256), generator=g) * 0.5).to(dev),
            h=torch.tanh(torch.randn((B, 256), generator=g)).to(dev))
        zeros = torch.zeros((T, B), device=dev)
        env = StepOutput(reward, StepOutputInfo(zeros, zeros), done,
                         Observation(frame=frame))
        return actions, env, state

    results = []
    for agent, dev in ((agent_gpu, device), (agent_cpu, torch.device("cpu"))):
        (logits, baseline), state = agent(*inputs(dev))
        loss = (logits.square().sum() + baseline.sum()
                + state.c.sum() + state.h.square().sum())
        grads = torch.autograd.grad(loss, list(agent.parameters()))
        results.append([t.detach().cpu() for t in
                        (logits, baseline, state.c, state.h, *grads)])
    err = _errors(zip(*results))
    _check("agent forward + parameter gradients", *err, AGENT_TOL)


def breakdown(torch, driver, config):
    """Where one iteration of the main path spends its time: one actor
    unroll (its inference steps alone, then the rest: env steps and
    host packing), the trajectory's upload, and one learner update, with
    the update's device time by kernel from torch.profiler."""
    from scalable_agent_tpu_torch.models import actor_step, initial_state
    from scalable_agent_tpu_torch.runtime import VectorActor
    from scalable_agent_tpu_torch.runtime.actor import to_device, to_numpy
    from scalable_agent_tpu_torch.types import map_structure

    device = torch.device(config.device)
    obs_spec, action_space = driver.probe_env(config)
    agent = driver.build_agent(config, obs_spec, action_space, device)
    learner = driver.build_learner(config, agent)
    groups = driver.make_env_groups(config, obs_spec.frame)
    actor = VectorActor(agent, groups[0], config.unroll_length)
    try:
        out = actor.run_unroll()  # bootstrap + warm-up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = actor.run_unroll()
        torch.cuda.synchronize()
        unroll_s = time.monotonic() - t0
        last = lambda a: None if a is None else a[-1]
        step_in = (torch.as_tensor(out.agent_outputs.action[-1],
                                   device=device),
                   to_device(map_structure(last, out.env_outputs), device))
        state = initial_state(config.batch_size, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.monotonic()
        for _ in range(config.unroll_length):
            agent_out, state = actor_step(agent, gen, *step_in, state)
            to_numpy(agent_out)
        infer_s = time.monotonic() - t0
        t0 = time.monotonic()
        traj = driver.to_trajectory(out, device)
        torch.cuda.synchronize()
        upload_ms = 1e3 * (time.monotonic() - t0)
        update_ms = _time_ms(torch, lambda: learner.update(traj), 3)
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            learner.update(traj)
            torch.cuda.synchronize()
    finally:
        for envs in groups:
            envs.close()
    device_us = {}
    for evt in prof.key_averages():
        # Kernels only: an operator's row repeats its kernels' time.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            device_us[evt.key] = us
    busy_ms = sum(device_us.values()) / 1e3
    print(f"  actor unroll ({config.unroll_length} steps x "
          f"{config.batch_size} envs): {unroll_s:.3f} s, of which "
          f"inference {infer_s:.3f} s (per step "
          f"{1e3 * infer_s / config.unroll_length:.3f} ms) and env steps "
          f"+ packing {unroll_s - infer_s:.3f} s", flush=True)
    print(f"  trajectory upload {upload_ms:.2f} ms; learner update "
          f"{update_ms:.2f} ms (CUDA events), device busy {busy_ms:.2f} ms "
          f"in the profiled update", flush=True)
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms  {name[:90]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a machine with an NVIDIA card", file=sys.stderr)
        return 2
    try:
        from scalable_agent_tpu_torch import driver
        from scalable_agent_tpu_torch.config import Config
        from scalable_agent_tpu_torch.ops import (
            _build,
            conv_cuda,
            float32_precision,
            lstm_cuda,
        )
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run this from "
              f"the root of a checkout of the repository", file=sys.stderr)
        return 3

    # -- phase 1: the card and the build
    card = _nvidia_smi()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    device = torch.device("cuda")
    t0 = time.monotonic()
    _build.library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    with float32_precision():
        # -- phase 2: every kernel against its plain version
        print("phase 2: kernels vs plain versions (float32, TF32 off)",
              flush=True)
        rows = compare_lstm(torch, lstm_cuda, device)
        rows += compare_gradw(torch, conv_cuda, device)
        timed = {}
        for (name, src, replaces, err, kern_fn, plain_fn, lib_fn, nbytes,
             flops) in rows:
            iters = 50 if name == "lstm_fwd_lean" else 10
            ms = _time_ms(torch, kern_fn, iters)
            plain_ms = _time_ms(torch, plain_fn, max(3, iters // 5))
            lib_ms = _time_ms(torch, lib_fn, iters) if lib_fn else None
            bound_ms, bound_by = _bound_ms(nbytes, flops)
            timed[name] = dict(
                name=name, route="cuda",
                source=f"scalable_agent_tpu_torch/csrc/{src}",
                replaces=f"scalable_agent_tpu/ops/{replaces}",
                max_abs_err=err[0], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                  f" ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        del rows
        compare_agent(torch, device)
        torch.cuda.empty_cache()

    # -- phase 3: the main path, counted
    config = Config(level_name="fake_benchmark", device="cuda",
                    total_environment_frames=float(
                        UPDATES * Config().frames_per_update()),
                    log_interval_s=0.0)
    for counters in (lstm_cuda.LAUNCHES, conv_cuda.LAUNCHES):
        for key in counters:
            counters[key] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    metrics = driver.train(config)
    torch.cuda.synchronize()
    train_s = time.monotonic() - t0
    launches = dict(lstm_cuda.LAUNCHES, **conv_cuda.LAUNCHES)
    print(f"phase 3: {UPDATES} updates in {train_s:.2f} s "
          f"({train_s / UPDATES:.3f} s per update, set-up included); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    print(f"  final metrics: {json.dumps(metrics, sort_keys=True)}",
          flush=True)
    for key in ("total_loss", "policy_gradient_loss", "baseline_loss",
                "entropy_loss", "grad_norm"):
        if not math.isfinite(metrics[key]):
            raise AssertionError(f"{key} is not finite: {metrics[key]}")
    if metrics["env_frames"] != UPDATES * config.frames_per_update():
        raise AssertionError(f"env_frames {metrics['env_frames']} != "
                             f"{UPDATES} x {config.frames_per_update()}")
    expected = {"lstm_fwd_lean": UPDATES * config.unroll_length,
                "lstm_fwd_resid": UPDATES, "lstm_bptt": UPDATES,
                "stem_gradw": UPDATES}
    for name, want in expected.items():
        ok = (launches[name] >= want if name == "lstm_fwd_lean"
              else launches[name] == want)
        if not ok:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the main path, expected {want}")

    print("phase 3b: where one iteration of the main path spends its time",
          flush=True)
    with float32_precision():
        breakdown(torch, driver, config)

    # -- phase 4: the report
    kernels = [dict(timed[name], launches=launches[name])
               for name in ("lstm_fwd_lean", "lstm_fwd_resid", "lstm_bptt",
                            "stem_gradw")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
