#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``scalable_agent_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without printing
a result:

1. The card (``nvidia-smi`` name and power limit, torch's device name),
   then the build of every hand-written kernel from ``csrc/*.cu``.
2. Each kernel against its plain PyTorch version at the main path's
   shapes (T=101, B=32, D=266, H=256 for the LSTM; N=3232 frames of
   72x96x3 for the stem grad-W; [100, 32] for V-trace, which is also held
   at [100, 8192], T=1, T=101, [3, 33], NaN and +inf rhos and an all-done
   column, with bitwise-equal calls and its device time at [100, 32]
   below ``VTRACE_MAX_MS``), float32 with TF32 off, random inputs from a
   seeded generator with ~5% done=1: max abs and scale-floored relative
   error against the stated tolerance, and times from CUDA events (kernel,
   plain version, and a library call for the same function where there is
   one: ``torch.nn.grad.conv2d_weight`` for grad-W, ``torch.lstm_cell``
   after the done-reset for the lean forward; V-trace also against the
   ``scan_impl=auto`` recurrence).  Every LSTM and grad-W check below runs
   twice: for the float32 kernels, then for their bf16-operand variants
   (``matmul_dtype="bfloat16"``; grad-W on bf16 x and g, the library calls
   in bf16 too), at the float32 tolerances but for bf16 unrolls longer
   than ``LSTM_BF16_SHORT_T`` steps (``LSTM_BF16_LONG_TOL``, and the
   residual forward must be clearly closer to its plain version than to
   the float32 one).  The lean step kernel (float32: the FFMA cluster
   kernel; bf16: the tensor-core kernel) is also held at T=1 for B in {1,
   8, 32, 64} and from two threads on two streams at once, two calls must
   be bitwise equal, and its device time (torch.profiler) must not exceed
   ``torch.lstm_cell``'s in either type; at the actor service's padded
   batch sizes, B in ``SERVICE_BUCKETS`` (4, 8, 16, 64; phase 3p), and at
   an accum_fused shard's of 3 and 4 groups, B in ``FUSED_BUCKETS`` (96,
   128; phase 3q), it is
   held at LSTM_TOL with two calls bitwise equal in both types, and its
   wrapper ms, device ms, plain ms, byte bound and ``torch.lstm_cell``'s
   wrapper and device ms at the same B are printed (not gated).  The lean
   forward at T>1 (one
   call: the input GEMM and the lean recurrence) is held at T=5, its ys,
   cT and hT bitwise the residual forward's; and again over the IMPACT
   target network's unroll, x [101, 32, 266] (bf16 as the long unrolls
   below), two calls bitwise equal, with its device time beside the
   one-launch-a-step loop's (PERF.md) and 101 ``torch.lstm_cell`` calls
   after the resets.  The residual
   forward (input-projection GEMM + recurrence kernel) is also held, on
   all seven outputs, at B in
   {1, 33, 64}, at T=1, with done=1 at t=0 and on a whole column, and at
   [8, 4] with H=512 (Wh partly streamed from L2); two calls must be
   bitwise equal, the BPTT must agree fed by its residuals and at T=5,
   and the forward's device
   time (torch.profiler, both kernels) must be below ``RESID_MAX_MS``;
   the occupancy query's count of co-resident clusters is printed.  The
   BPTT (reverse-chain kernel, products, reduction) is held the same way
   (B in {1, 33, 64}, T=1, the forced resets, H=32, and [8, 4] at H=512),
   two calls must be bitwise equal, and its device time (every kernel it
   launches, split into chain, products and reduction) must be below
   ``BPTT_MAX_MS``; cuBLAS's time for its three products is printed as
   the products' yardstick.
   Grad-W is also held at N=1, N=3233,
   17x23 frames (asymmetric SAME pads) and in both input layouts the torso
   can hand over (contiguous NHWC, an NHWC view of NCHW memory), two calls
   must give bitwise-equal dW, and its float32 time must be below
   cuDNN's.
   Then the whole agent, forward and every parameter gradient, on the card
   against the same weights on the CPU, under each dtype policy.  Then the
   composite policies' geometry: the lean, residual and BPTT LSTM kernels
   at D=265 (``fake_tuple``: 256 + 1 + 3 + 5, odd) and D=296 (Doom's full
   discretized space) in both types, as at D=330 below (a lean unroll of
   T > 1 bitwise the residual forward's; a bf16 one held step by step
   from the unroll's own carry, the T=1 step kernel fed the same carries,
   and free-running at LSTM_TOL unless flips of the bf16 rounding of h
   are counted), and the stem grad-W at 3232 frames of 16x16 in both types,
   with two calls bitwise equal, against cuDNN's.  The same at
   ``doom_duel``'s D=298 (256 + 1 + 41) and for the stem grad-W at Doom's
   72x128 frames (18x32 outputs).  The same at CartPole's D=259 (256 + 1
   + 2) and the Atari stand-in's D=261 (Breakout's 4 actions), and the
   stem grad-W's C=4 instantiation (``stem_gradw_c4``, Atari's grayscale
   stack of 4) at N=3232 frames of 84x84x4 as the 72x96x3 one above: both
   types, every layout, N=1, N=3233 and 17x23, two calls bitwise equal,
   device time beside cuDNN's, timed into the kernels line (no gate
   against cuDNN).  The same for the last two geometries: the 8x8 stem at
   one channel (``stem_gradw_c1``, 72x96x1) and the ResNet stem on
   Atari's stack (``resnet_stem_gradw_c4``, 84x84x4).  Every bf16 8x8 row
   (72x96, 72x128, 16x16, 84x84x4, 72x96x1) is the mma.sync kernel, held
   in both layouts with two calls bitwise equal in each.  Last, the
   device worlds' shapes (phase 3t), timed into the kernels line as rows
   of their own: the stem grad-W at N=3232 frames of 15x15x3 (the
   gridworlds: SAME pads 2/3, the first asymmetric pair a level reaches;
   cuDNN's yardstick pads the frames first, as no single call takes an
   asymmetric pair), 10x10x3 (asterix) and 10x10x4 (breakout, the C=4
   kernels; pads 3/3) as the 72x96x3 one above, and the three LSTM
   kernels at D=260 (breakout: 256 + 1 + 3) and D=262 (asterix) as at
   D=330, both types.
3. Train: ``driver.train`` on ``fake_benchmark`` at full width (64 actors
   in two groups of 32 on ActorPool threads, 8 env worker processes per
   group, unroll 100, 4 action repeats, LSTM 256, ``--scan_impl=pallas``,
   the default ``compute_dtype=bfloat16``, the JAX host loop's
   defaults: ``transport=packed``, ``inflight_updates=2``,
   ``nonfinite_tolerance=10``, ``preemption_grace_s=30``, and the obs
   planes at their defaults plus ``--trace``) for 4 updates
   into a temporary ``--logdir``, with every launch counter set to 0 just
   before and read just after: losses finite, env_frames exact, the bf16
   variants of the residual forward, BPTT and grad-W and V-trace launched
   once per update, the bf16 lean forward at least 100 times per update,
   no float32 LSTM or grad-W kernel launched, one metric row per update
   in update order with exact env_frames (each row the update retired
   from the in-flight window), and a checkpoint whose manifest verifies.  Then ``driver.test`` (``--mode=test``) on that
   logdir for 8 episodes, a 1-update ``scan_impl=auto`` train that must
   launch no V-trace kernel, and the float32 policy's path
   (``--compute_dtype=float32``) for 2 updates, counted the same way for
   the float32 kernels.
3h. (Run after 3.) The deep agent, ``--torso_type=resnet
   --use_instruction=true``: the ResNet stem's grad-W kernel (3x3, stride
   1, 3 channels into 16 features) against its plain version at N=3232
   frames of 72x96, float32 and with bf16 x and g, in both layouts, at
   N=3233, N=1 and 64 frames of 17x23 in both layouts, two calls bitwise
   equal, its device time in both layouts as a multiple of its bound,
   beside cuDNN's ``conv2d_weight``; the lean,
   residual and BPTT LSTM kernels at the deep core's D=330, each variant
   against its plain version with two calls bitwise equal, its device
   time, its wrapper's and plain version's time and its bound, and
   ``torch.lstm_cell`` after the reset beside the lean step; the deep
   agent's forward and every parameter gradient on the card against the
   CPU under both policies (float32 at ``AGENT_TOL``; bf16: every leaf
   outside the convnet at ``AGENT_BF16_TOL``, the convnet's within
   ``DEEP_BF16_FRACTION`` of the bf16 policy's own distance from float32,
   the card's bf16 within ``DEEP_BF16_WITNESS`` of that distance, the
   stem's gradient from the card's own cotangent within one bf16 rounding
   of the plain version's, and the relu and max-pool decisions on which
   card and CPU part ways, counted); then the command itself on the
   main path's configuration (``scan_impl`` at its default) for 2 bf16
   updates counted as in phase 3 (the ResNet stem's bf16 grad-W once an
   update, every LSTM kernel, the shallow stem's never) with the layouts
   of the x and g its backward hands ``conv_gradw`` printed, the second
   update's s and ``ledger/mfu``, ``--mode=test`` on its checkpoint
   (adopting the architecture from ``config.json``), 2 float32 updates
   counted, and one iteration taken apart as in 3b; then the bf16 ResNet
   stem grad-W's ms per call (CUDA events) at N=3232 in the layouts the
   deep path handed over, which must be within ``RESNET_BF16_MAX_MS``
   (twice its byte bound), beside its bound, its device time, cuDNN's
   and the card's line.
3i. (Run after 3h.) Composite policies: ``--level_name=fake_tuple``
   (Tuple(Discrete(3), Discretized(5, -1, 1)), 16x16 frames) at the main
   path's layout, bf16, ``--scan_impl=pallas`` and
   ``--rmsprop_momentum=0.9`` for 4 updates counted as in phase 3, the
   checkpoint's momentum trace verified, ``--mode=test`` for 8 episodes,
   a resume for 2 more updates whose env frames and checkpoint step are
   exact and whose restored trace equals the saved one bit for bit, 2
   float32 updates counted; then one pool trajectory: its [T+1, B, 2]
   actions inside their components' ranges, the env's frames encoding
   component 0, and the composite agent's logits, joint log-probs and
   parameter gradients on it on the card against the CPU under both
   policies (AGENT_TOL, AGENT_BF16_TOL); s per update and env frames/s
   printed, not gated.
3b. Where the time goes: one actor unroll, the upload (per_leaf, and
   packed as pack, upload with its GB/s, and unpack) and one update taken
   apart (with torch.profiler for the update's kernels), at bf16 and at
   float32, then the pool loop's steady state at bf16 over
   ``POOL_UPDATES`` (8) updates at ``inflight_updates`` 2 and over
   ``POOL_UPDATES_WINDOW1`` (4) at 1 (s per update after the first 2,
   actor against learner fps, ``wait_batch``, ``update`` and
   ``retire``).
3p. (Run after 3b.) The continuous-batching actor service: the main path
   with ``--actor=service`` (one inference thread batching the 16 worker
   slices of 4 envs as they arrive, up to every env; bf16,
   ``--scan_impl=pallas``) for ``SERVICE_UPDATES`` (4) updates counted as
   in phase 3, every trajectory the learner takes [101, 32]; the bf16
   lean step kernel launched exactly once per service batch
   (``service/batches_total``), ``ledger/rho/service_batch`` and
   ``service_wait`` in ``metrics.prom`` and no ledger record open, each
   failing the run; s per update after the first 2 beside 3b's pool loop,
   actor fps, ``service/batch_s`` p50 and p95 and the batches by valid
   rows and by padded size printed, not gated; then 2 float32 updates,
   the float32 step kernel once per batch.
3q. (Run after 3p.) The ActorPool's other inference modes on the main
   path (bf16, ``--scan_impl=pallas``), each for ``MODE_UPDATES`` (4)
   updates counted as in phase 3: ``--inference_mode=service`` (the groups'
   requests co-batched by the native batcher, built by ``g++``; the bf16
   lean step launched exactly once per batch, ``native_batcher/
   batches_total``), ``accum`` (once per actor step of 32 rows: groups x T
   a round) and ``accum_fused`` at ``--accum_fused_shards=0`` (the link
   probe's RTT, H2D bandwidth and shard choice printed; once per step of a
   shard's k x 32 rows: shards x T a round), then ``SHARD_UPDATES`` (2)
   updates at the shard count the probe did not pick.  Under the accum
   modes every trajectory reaches the learner as the actor's own CUDA
   tensors, passed through by the transport, and ``transport/pack_s``
   does not move; under ``service`` every one is packed: each failing the
   run.  s per update after the first 2 beside 3b's pool loop,
   ``actor/inference`` ms per step and ``transport/h2d_bytes_total`` per
   update printed, not gated.  Then, at float32 with identically seeded
   env groups, ``ACCUM_CHECK_UNROLLS`` (2) unrolls of each group's
   ``AccumVectorActor`` and of one ``GroupedAccumActor`` over both, run at
   once on their own threads and streams and taken on another stream
   through ``adopt_device_trajectory``, against each group's structural
   ``VectorActor``: frames, actions and dones equal, logits, baselines and
   the first core state within rtol 1e-5, atol 1e-6, else the run fails.
3j. (Run after 3b.) ``--benchmark_mode=true`` on the main path, 4 bf16
   updates counted, its s per update and env frames/s beside 3b's (not
   gated); then one pool trajectory whose env outputs, frames included,
   equal bit for bit those of host ``BenchmarkStream``s seeded as the
   driver seeds the envs, while the agent's recorded actions differ from
   the env's.
3k. (Run after 3j.) The library routes: ``--core_impl=xla`` (the
   per-step LSTM in torch ops) and ``--conv_backend=xla`` (cuDNN's wgrad
   for the stem) each on the main path's configuration for 2 bf16
   updates, counted: no launch of a kernel the route replaces (every
   LSTM counter at 0 under the xla core, the actors' steps included;
   every grad-W counter at 0 under the xla stem), the others as in
   phase 3; s per update (not gated); the update alone on one
   trajectory for the kernels arm and both library arms in turns (CUDA
   events) with each arm's kernel table (torch.profiler), where no
   replaced kernel may appear.  Then ``fake_tuple`` with
   ``--conv_backend=xla`` for 2 bf16 updates counted the same way, and
   its update alone against the kernels' on one of its trajectories.
3l. (Run after 3k.) The ``doom_`` family under the fake VizDoom of
   ``tests/fakes/vizdoom.py`` with generated scenario files (the fake's
   step cost, not VizDoom's): the resize path the env workers take
   printed; ``doom_benchmark`` at the main path's layout and Doom's
   72x128 frames, bf16, ``--scan_impl=pallas``, 2 updates counted as in
   phase 3, s per update and env frames/s (not gated); ``doom_duel`` at
   batch 32 (16 matches x 2 agents a group, 2 groups), 2 bf16 updates
   counted (the LSTM kernels at D=298), the second update's s;
   ``--mode=test --record_to`` on its
   checkpoint for 8 episodes over 4 matches, each match's
   ``player_00``/``player_01`` holding episode directories with
   ``frames.npy`` and ``episode.json``.
3m. (Run after 3l.) The ``dmlab_`` family under the fake DeepMind Lab of
   ``tests/fakes/deepmind_lab.py`` (its step cost, not DMLab's):
   ``--level_name=dmlab30`` multi-task training at the main path's layout
   (64 actors over the 30 train levels, the instruction stream on: D=330),
   bf16, 2 updates counted as in phase 3, every train level's
   ``<level>/episode_return`` and the ``dmlab30/training_no_cap`` and
   ``training_cap_100`` scores in the metrics rows, s per update; then
   ``--mode=test --level_name=dmlab30 --test_num_episodes=1``: 30 levels
   through the bf16 lean kernel into ``eval_scores.json``.
3n. (Run after 3m.) The ``atari_`` and ``gym_`` families under a stand-in
   ``gymnasium`` written into the scratch directory (``GYMNASIUM_STANDIN``:
   its step cost, not ALE's): ``atari_breakout`` at [84, 84, 4] frames for
   2 bf16 updates counted (the C=4 bf16 grad-W once an update, no C=3
   grad-W), s per update, 2 float32 updates counted for the float32 C=4
   kernel; ``gym_CartPole-v1`` (rendered frames resized to 72x96) for 2
   bf16 updates counted as in phase 3; then the last two grad-W
   geometries on their paths, NEW_PATH_UPDATES bf16 and 2 float32
   updates each counted with its kernels once an update and every other
   stem's never: ``gym_BreakoutGray-v0`` (the stand-in's one-channel
   Breakout resized to [72, 96, 1]) and ``--torso_type=resnet`` on
   ``atari_breakout`` ([84, 84, 4]), then ``--mode=test`` on the deep
   Atari checkpoint (2 episodes through the bf16 lean kernel, no grad-W
   launched).
3o. (Run after 3n.) Off-policy training: ``fake_benchmark`` at the main
   path's layout, bf16, ``--loss=impact --replay_ratio=1
   --replay_capacity=64 --target_update_interval=2 --scan_impl=pallas``,
   resumed from phase 3's vtrace checkpoint (the target network starts
   from the restored parameters: the first update's IMPACT ratio is 1),
   3 fresh updates and 3 replayed ones counted: one lean unroll an
   update (the target network's, T+1 = 101 steps in one call) and the
   actors' lean steps, one residual forward, BPTT, grad-W and V-trace an
   update; ``env_frames`` counts the
   fresh frames only, the replayed updates and samples are 3, the slab
   occupied, the IMPACT histograms and ``ledger/staleness_replayed_s``
   published, s per update printed; the impact update alone on one
   trajectory makes exactly one lean unroll call and no step launch (its
   ms and device time beside the vtrace update's); the 64-slot slab's
   bytes, an insert on a side stream and a sample on the default stream under
   ``torch.cuda.set_sync_debug_mode("error")``, each sample bitwise the
   batch in the slot the host mirror names; ``--mode=test`` on the run's
   checkpoint, which holds the target network.
3r. (Run after 3o.) The numerics sentinel on the main path, bf16, every
   update audited (``--sentinel_interval=1``), three runs counted as in
   phase 3: a clean one of 3 updates (no breach at the default rtol 0.6;
   the bf16 residual forward, BPTT and grad-W launched by the updates and
   again by the audits' hot gradients, the float32 residual forward twice
   and BPTT once an audit by the reference learner, the float32 grad-W
   never: cuDNN's wgrad is the reference's; each audit's deviation per
   flax leaf, both arms, printed, and the audit's host ms and one audit's
   kernels' device ms beside the card's line), and a
   ``kernel_miscompute@2;param_bitflip@3`` one (a breach near 1.0 at the
   second audit, rung 1, the bf16 grad-W counter still after the swap,
   exact frames; at the third audit the flipped leaf's delta arm at least
   the flip over the step bound, above its reading without the flip on
   the same update; a breach printed, not required: a 256x256 gate
   kernel's RMSProp step can hide a flip of 1/8 of one element).
3s. (Run after 3r.) One single-process chaos soak through the CLI's
   ``run`` (``python -m scalable_agent_tpu_torch.runtime.soak run``): the
   main path as a driver subprocess with ``--sentinel_interval=2`` at the
   card's calibration ``--sentinel_rtol=2.0`` (1.5x the largest clean
   reading of 200 audits; the JAX default 0.6 trips in 2% of clean
   audits on the card), a metrics row every 1 s and no health profile
   window (``--health_max_windows=0``), 4 faults of seed 5 over
   ``nan_grad``, ``throughput_sag``, ``param_bitflip`` and
   ``actor_raise`` through the runtime channel, a 20 s budget from the
   run's first update, recovery windows of 4-8 s; every fault landed, a
   drained exit 0, and ``soak_report.json`` passing every invariant but
   the throughput floor, which is printed (the actor-bound loop's rows
   are too noisy to grade at 0.8 in a short soak: ``soak_path``).
   Each phase prints its seconds, and phase 4 the script's total.
3t. (Run after 3s.) The in-graph backend (``--train_backend=ingraph``,
   ``runtime/ingraph.py``) on the card, bf16: the main path's
   configuration on ``fake_benchmark`` (the ``DeviceFakeEnv`` twin,
   72x96x3, Discrete(9); batch 32, unroll 100, 4 repeats,
   ``--scan_impl=pallas``: 12,800 env frames an update) through
   ``driver.train`` for 4 updates at ``--updates_per_dispatch=1`` and 4
   at 2, counted as phase 3 (the lean step 100 times an update, the
   residual forward, BPTT, grad-W and V-trace once each), one metric row
   a dispatch; then the dispatch alone (``dispatch_alone``) from the K=1
   run's checkpoint: 2 updates at K=2 bitwise equal to 2 at K=1
   (parameters, optimizer state, the last loss), s per update over 4
   updates after the first at each K, one update's device ms by
   ``record_function`` range (``actor_inference``, ``env_step``,
   ``learner_update``; torch.profiler), and one K=2 dispatch under
   ``torch.cuda.set_sync_debug_mode("error")``, which must raise nothing.
   Each ``device_`` level (``device_grid_small``, ``device_grid_large``,
   ``device_minatar_breakout``, ``device_minatar_asterix``) trains 2 bf16
   updates in-graph, and one float32 update each of the three geometries,
   counted at their shapes (15x15x3, 10x10x4 and D=260, 10x10x3 and
   D=262).  ``device_minatar_breakout`` through the host backend's pool
   with 2 env workers for 2 updates: every worker's streams report torch
   loaded, CUDA never initialized, no jax (``_ProbedStream`` at close),
   and a spawned worker's 100-step stream (the host twin on the CPU)
   equals the card's world on the same seed and actions, bitwise.  Last,
   the conformance harness on ``cuda`` for all eight levels (its
   ``zero_host_sync`` check under the sync debug mode).
3d. (Run after 3b, before 3c.) The default loop's machinery, each part
   failing the run: packed
   bitwise equal to per_leaf for one full-width trajectory from the pool,
   then over 30 back-to-back packed uploads on a prefetch stream, each
   handed over by the driver's ``_adopt`` and read on the main stream
   under a dummy update that the uploads outrun (the allocator's reuse
   race); 4 updates at ``inflight_updates`` 2 and 1 on the same fixed
   trajectories (the pool replaced) with bitwise-equal losses, published
   weight snapshots and final state; the rollback drill (``nan_grad@3:4:5``,
   tolerance 3, a checkpoint every update, 8 updates: one rollback to a
   verified step, 3 skips) and the same run as a CLI subprocess under
   ``--no_rollback`` exiting 71; the preemption drill (a CLI subprocess
   with ``--chaos_spec=preempt_sigterm@12``: exit 0, a verified final
   checkpoint at update count x frames per update, and the same command
   resuming from exactly that step); ``actor_raise@1;worker_kill@2;
   ckpt_save_fail@1`` in one 4-update run (one restart, one respawn, one
   failed save) and ``ckpt_torn@1`` on a newer step on top of it (the
   restore walks back); one update under ``remat_torso=on`` and under
   ``fused_forward=false`` from the default update's weights and batch,
   with the same kernels launched (the residual forward twice for the
   two-pass update) and bitwise-equal results (the two-pass update is
   otherwise held at rtol 1e-4 on its losses, and the difference
   printed).
3e. (Run after 3d.) The obs planes on the card, each part failing the
   run: phase 3's logdir holds ``metrics.prom`` with ``devtel/learner``,
   ``devtel/learn``, ``ledger`` and ``stall`` families and a trace with
   the actor, transport, ``learner/update`` and ``checkpoint/save``
   spans; one warm update with both telemetry specs under
   ``torch.cuda.set_sync_debug_mode("error")`` raises nothing and its
   telemetry equals a twin learner's same update under the default mode;
   the update alone with ``learn_telemetry`` on and off (host ms per call
   and device ms from torch.profiler, interleaved); the pool loop's s per
   update with the planes at their defaults plus ``--trace`` against all
   of them off (``learn_telemetry=false``, ``watchdog_timeout_s=0``, no
   trace), one run each, with the stall verdicts, the ledger's
   dominant segment, ``ledger/mfu`` and ``update_flops`` of the planes-on
   runs; the watchdog drill (a CLI subprocess with
   ``--chaos_spec=throughput_sag@3``, the sag ``OBS_SAG_S`` past
   ``--watchdog_timeout_s`` ``OBS_WATCHDOG_S`` and ``--watchdog_abort``:
   exit 70, ``flightrec.<pid>.json`` with reason ``watchdog:learner`` and a
   non-empty ``stacks.<pid>.txt``); and a second SIGTERM to a CLI
   subprocess as soon as it has logged the first (exit 143 and the
   flight recorder's dump, reason ``signal:SIGTERM``).
3f. (Run after 3e.) The run-health plane (``--health``, on in every
   phase as it is by default; phase 3 and each 3c run print their anomaly
   records): the main path's configuration for ``HEALTH_UPDATES`` updates
   with a ``--profile_dir`` window tabling updates 1-2 (the baseline), a
   warm-up of 3 intervals, one window of 2 updates, the detectors' z path
   off and their relative threshold at ``HEALTH_REL``, and a
   ``HEALTH_SAG_S`` ``throughput_sag`` at update ``HEALTH_SAG_AT``: a
   ``throughput`` record of that interval whose window finished, one
   trip's pinned flight-recorder dump, exactly one ``health_profile.*``
   directory, and ``kernels.json`` and ``kernels.<id>.json`` each naming
   every hand-written kernel of the bf16 update (``TABLE_KERNELS``) with
   a finite time, printed per call beside PERF.md section 6's, with the
   tables' ``matched_time_frac``, dominant and worst kernels and the
   largest ``aten::convolution`` kernel's input shapes; then
   ``health.step``'s host ms per call and the registry snapshot's, per
   interval against the JAX budget (0.5% of a 10 s interval), and the
   harvests' seconds.
3g. (Run after 3f.) The obs consumers, each part failing the run: the
   four CLIs (``python -m scalable_agent_tpu_torch.obs.<cli>``) as
   subprocesses on phase 3's logdir (``--trace``) and on phase 3f's (its
   kernel tables and anomaly records): ``report --json`` (its stage table,
   dominant stage, stall verdict, MFU and worst kernels printed),
   ``diagnose --json``, ``watch --once --json`` and ``aggregate``, none
   exiting 2, the report's dominant stage the largest
   ``ledger/latency_share/*`` of ``metrics.prom``, its kernels section
   naming every hand-written kernel of ``kernels.json``, and the
   one-process fold of ``metrics.fleet.prom`` equal to every series of
   ``metrics.prom``; each CLI's wall seconds printed.  Then the main path
   for ``LIVE_UPDATES`` (6) updates as a driver subprocess with
   ``--metrics_http_port``, scraped every ``SCRAPE_EVERY_S``: every
   scrape answered 200 (``/health`` 503 only before the first snapshot),
   the last ``/metrics`` carrying every family prefix of the final
   ``metrics.prom``, the last ``/health`` equal to ``watch --once
   --json`` on the same files, exit 0 and the port closed; the scrapes'
   round-trip ms and the run's s per update (beside 3b's) printed, not
   gated.
3c. Learning: ``fake_bandit`` through the pool on the card at the default
   bf16 policy (16x16 frames,
   32 actors, batch 16, unroll 16, lr 0.002, entropy 0.003, 200 updates,
   ``--scan_impl=pallas``) must lift the mean episode return from the
   random floor (~4) to at least 8, by at least 4.  A run either learns
   all four cues or stalls at ~7.9 (two of them), in both packages and
   for any seed, and which one it does is not fixed by the seed (thread
   timing changes the data); on the card between a third and a half of
   the runs stall (PERF.md has the sweeps).  So seeds 1 to 8 all run,
   every curve and the counts are printed, and the phase fails unless
   EVERY run rose at least 2.5 above its early rows (no sound run has
   risen less than 3.4: a stall has learned two cues) and at least 2 runs
   met the full curve (a sound learner misses that about 4% of the time
   at a one-in-two stall rate, 0.6% at one in three).  The runs keep the
   health plane's records but open no profile window.  Each seed is a
   driver CLI subprocess, all at once (one after another they took 464 s
   of a slow host's 1404 s on the card; 4 at a time 198 s of 1176).
4. A ``{"kernels": [...]}`` line (the float32 kernels with their launches
   on the float32 path, the bf16 variants and V-trace with theirs on the
   main path; the ResNet stem's from 3h's float32 and bf16 runs, the C=4
   stem's from 3n's Atari runs, the C=1 and ResNet C=4 kernels' from 3n's
   one-channel gym and deep Atari runs, the lean unroll (the target
   network's) with 3o's launches; the lean step's two entries also carry
   ``service_launches``, 3p's, and the bf16 one ``mode_launches``,
   3q's by mode; the device worlds' shapes with 3t's launches at them),
   the card's line, then as the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
F32_FLOP_PER_S = 67e12      # H100 SXM float32 without tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
LSTM_TOL = 1e-4             # scale-relative; f32 sums in another order
# bf16 operands: the same exact products summed in another order, so
# LSTM_TOL holds while the unroll is short; over a long one a last-bit
# difference in a float32 h or dgate flips its bf16 rounding (2**-8 of
# that operand) and the flips accumulate.  Two correct orders of the plain
# version differ by 3e-4 at T=101 on the CPU; the float32 policy is 6.5e-3
# away.
LSTM_BF16_SHORT_T = 10
LSTM_BF16_LONG_TOL = 3e-3
AGENT_BF16_TOL = 2e-2       # the CPU tests' band for the bf16 policy
# The deep agent at bf16 on the card against the CPU: every leaf outside
# the convnet within AGENT_BF16_TOL; the convnet's gradients within this
# fraction of the bf16 policy's own distance from float32 (the same
# weights and inputs on the CPU, in the same run), the card's bf16 no
# further from float32 than DEEP_BF16_WITNESS times the CPU's bf16, and
# the stem's gradient from the card's own cotangent within one bf16
# rounding of the plain version's.  Through 15 bf16 convs and 3 max-pools
# two bf16 implementations of the same math take different relu and pool
# decisions; the run prints how many (PERF.md, section 6).
DEEP_BF16_FRACTION = 0.5
DEEP_BF16_WITNESS = 1.1
BF16_ROUNDING_TOL = 2.0 ** -7  # one bf16 ulp of the element, at most
RESID_MAX_MS = 5.9          # residual forward device time: half of the
                            # one-block-per-row loop's 11.94 ms (PERF.md)
BPTT_MAX_MS = 2.27          # BPTT device time, every kernel: half of the
                            # one-block-per-row chain's bf16 4.540 ms
GRADW_TOL = 1e-4            # scale-relative over 1.4 M summed rows
AGENT_TOL = 1e-3            # whole model: cuDNN convs vs CPU convs
VTRACE_TOL = 1e-5           # scale-relative; FMA contraction on the card
VTRACE_MAX_MS = 0.0078      # V-trace device time at [100, 32]: half of the
                            # one-thread-per-column walk's 0.0156 ms
RESNET_BF16_MAX_MS = 0.507  # the bf16 ResNet stem grad-W's ms per call at
                            # N=3232: twice its 0.2534 ms byte bound
UPDATES = 4
F32_UPDATES = 2             # the float32 policy's shorter path
POOL_UPDATES = 8             # 2 to fill the window, 6 measured
POOL_UPDATES_WINDOW1 = 4     # phase 3b's window-1 arm: 2 measured
SERVICE_UPDATES = 4          # phase 3p's bf16 run: 2 to fill, 2 measured
# The actor service's padded batch sizes at the reference layout (slices
# of 4 envs, at most 64 rows) beside the B=32 of the grouped pool.
SERVICE_BUCKETS = (4, 8, 16, 64)
# The lean step's B at accum_fused's 3 and 4 groups of 32 a shard (phase
# 2; phase 3q's 2 groups reach 32 and 64).
FUSED_BUCKETS = (96, 128)
MODE_UPDATES = 4             # phase 3q's runs: 2 to fill, 2 measured
SHARD_UPDATES = 2            # its run at the shard count auto did not pick
ACCUM_CHECK_UNROLLS = 2      # phase 3q's accum-against-structural check
UPLOAD_REPS = 5             # uploads timed per transport (phase 3b)
PACKED_UPLOADS = 30         # back-to-back packed uploads held (phase 3d)
DUMMY_MATMULS = 12          # 4096^2 float32 products per upload read:
                            # longer than a pack, so uploads run ahead
ROLLBACK_UPDATES = 8
PREEMPT_CYCLE = 12          # the monitor cycle (~1 s each) that SIGTERMs
CLI_TIMEOUT_S = 300         # each driver subprocess of phases 3d and 3e
OBS_WATCHDOG_S = 2.0        # the watchdog drill's heartbeat deadline and
OBS_SAG_S = 6.0             # its throughput sag, past deadline + poll
TELEMETRY_UPDATES = 10      # updates timed per arm of the telemetry cost
OBS_POOL_UPDATES = 4        # each planes on/off pool run (2 measured)
BANDIT_UPDATES = 200
BANDIT_RANDOM = 4.0         # fake_bandit: 16 steps, 4 actions
BANDIT_SEEDS = tuple(range(1, 9))
BANDIT_RISE = 2.5           # every run rises at least this above early
BANDIT_FULL = 2             # runs that must meet the full curve
BANDIT_PARALLEL = 8         # seeds run at once, each a CLI subprocess
HEALTH_UPDATES = 10         # phase 3f's sag drill: the window closes
                            # after update HEALTH_SAG_AT + 3
HEALTH_SAG_AT = 6           # the sagging update: after the 3 warm-up
                            # intervals, before the detectors that arm at
                            # twice the warm-up
HEALTH_SAG_S = 10.0         # ~30x an update's share of the loop
# The drill's detectors trip on a relative drop past 90% (or a 3x rise)
# only: logged every update, an actor-bound loop's learner fps is bimodal
# (the next batch staged or not) and drops by 60-70% without a sag.
HEALTH_REL = 0.9
HEALTH_Z_OFF = 1e9
LIVE_UPDATES = 6            # phase 3g's run beside the live endpoint
SCRAPE_EVERY_S = 1.0        # its scrape cadence
HEALTH_BUDGET_FRAC = 0.005  # the JAX bench's budget for the plane (of the
HEALTH_LOG_INTERVAL_S = 10.0  # update stage, at the default log interval)
# The hand-written kernels of the bf16 update, as the kernel table names
# them (a prefix and a part of the name), and the device ms per call of
# each group in PERF.md section 6's table.
TABLE_KERNELS = (
    ("residual forward GEMM", "sgemm_kernel<true", "__nv_bfloat16"),
    ("residual recurrence", "lstm_resid_kernel<", "__nv_bfloat16"),
    ("BPTT chain", "bptt_chain_kernel<", "__nv_bfloat16"),
    ("BPTT products", "bptt_dx_kernel", ""),
    ("BPTT products", "bptt_dw_kernel", ""),
    ("BPTT reduction", "bptt_reduce_kernel", ""),
    ("grad-W", "conv_gradw_mma_kernel<", ""),
    ("grad-W", "reduce_partials_kernel", ""),
    ("V-trace", "vtrace_chunked_kernel<", ""),
)
# The lean forward's kernels: the T=1 step (float32, bf16 operands) and
# the unroll at T>1 (the input GEMM, the same instance as the residual
# forward's, then the lean recurrence).
LEAN_STEP = ("lstm_step_kernel", "lstm_step_mma_kernel")
LEAN_UNROLL = ("sgemm_kernel<true", "lstm_lean_unroll_kernel")
# The target unroll's device ms as 101 launches of the step kernel, by
# operand type, before the one-call unroll (PERF.md section 6; H100 80GB
# HBM3 at 700 W).
STEP_LOOP_TARGET_MS = {"float32": 1.2177, "bfloat16": 1.2233}
SECTION6_MS = {"residual forward GEMM": 0.1415,
               "residual recurrence": 0.2452, "BPTT chain": 0.324,
               "BPTT products": 0.078, "BPTT reduction": 0.005,
               "grad-W": 0.1747, "V-trace": 0.0034}


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


def _kernel_ms(torch, fn, iters):
    """Mean device milliseconds per call of each kernel ``fn`` launches,
    by kernel name, from torch.profiler over ``iters`` calls (after one to
    warm up): the kernels' own time, without the host's launch overhead
    that a loop of small launches is bound by.  The profiler can drop a
    kernel's records (8 of 10 launches recorded on the card; PERF.md,
    section 6), so a kernel's ms per recorded launch is multiplied by its
    launches per call, the recorded count over ``iters`` rounded; a count
    that is not a multiple of ``iters`` is printed."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.count:
            us = getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0.0)
            if evt.count % iters:
                print(f"  (torch.profiler recorded {evt.count} launches of "
                      f"{_kernel_name(evt.key)} in {iters} calls)",
                      flush=True)
            per_call = max(1, round(evt.count / iters))
            ms[evt.key] = ms.get(evt.key, 0.0) + (
                us / 1e3 / evt.count * per_call)
    return ms


def _matching(ms, kernel):
    """The sum of ``ms`` over the kernels whose name holds one of
    ``kernel`` (a string or a tuple of them; None for every kernel)."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    return sum(t for key, t in ms.items()
               if names is None or any(n in key for n in names))


def _kernel_name(key):
    """A profiler key without its namespace, return type and argument
    list."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    head, bracket, args = name.partition("<")
    head = head.split("::")[-1]
    head = head[len("void "):] if head.startswith("void ") else head
    return head + bracket + args


def _device_ms(torch, fn, kernel, iters):
    """Mean device milliseconds per call of the kernels of ``fn`` whose
    name holds one of ``kernel`` (see ``_matching``)."""
    return _matching(_kernel_ms(torch, fn, iters), kernel)


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


def _bound_ms(nbytes, flops, bf16=False):
    """The least time for the work: bytes over the memory rate against
    operations over the peak of their type (bf16 tensor cores for a bf16
    variant, float32 FMA otherwise)."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _taps(size, K, S):
    """The (output, tap) pairs along one axis of a SAME-padded K-tap,
    stride-S convolution whose input lies inside the frame: a grad-W's
    operations are 2 * N * C * F * _taps(H) * _taps(W), the taps over the
    padding multiplying zeros the function need not read."""
    out = -(-size // S)
    before = max((out - 1) * S + K - size, 0) // 2
    return sum(0 <= o * S + k - before < size
               for o in range(out) for k in range(K))


def _check(name, err_abs, err_rel, tol):
    print(f"  {name}: max_abs_err {err_abs:.3e} max_rel_err {err_rel:.3e} "
          f"(tolerance {tol:.0e})", flush=True)
    if not err_rel <= tol:
        raise AssertionError(f"{name} disagrees with its plain version")


def _bitwise(torch, name, first, second):
    """Two calls' outputs must be bitwise equal; else the largest
    difference is printed and the run fails."""
    diff = max(float((p - q).abs().max()) for p, q in zip(first, second))
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name}: two calls gave different outputs "
                             f"(max abs difference {diff:.3e})")
    print(f"  {name}: two calls bitwise equal", flush=True)


def _variant(name, matmul_dtype):
    """A kernel's row name: the bf16-operand variant ends in _bf16."""
    return name + ("_bf16" if matmul_dtype == "bfloat16" else "")


def _lstm_tol(matmul_dtype, steps):
    """LSTM_TOL, but LSTM_BF16_LONG_TOL for bf16 operands over more than
    LSTM_BF16_SHORT_T steps."""
    if matmul_dtype == "bfloat16" and steps > LSTM_BF16_SHORT_T:
        return LSTM_BF16_LONG_TOL
    return LSTM_TOL


def _lstm_costs(T, B, D, H):
    """(bytes, operations) of the lean step at T=1, the lean forward over
    T steps (``unroll``: Wi, Wh and b read once, x, done and ys once a
    step, the carries once), the residual forward and the BPTT at T
    steps: each input read once, each output written once (float32: the
    kernels read float32 in both variants)."""
    f4 = 4
    lean = (f4 * (B * D + B + 2 * B * H + (D + H + 1) * 4 * H + 2 * B * H),
            2 * B * (D + H) * 4 * H + 12 * B * H)
    unroll = (f4 * (T * B * D + T * B + 2 * B * H + (D + H + 1) * 4 * H
                    + T * B * H + 2 * B * H),
              T * (2 * B * (D + H) * 4 * H + 12 * B * H))
    resid = (f4 * (T * B * D + T * B + 2 * B * H + (D + H + 1) * 4 * H
                   + T * B * H * 8 + 2 * B * H),
             T * (2 * B * (D + H) * 4 * H + 12 * B * H))
    bptt = (f4 * (T * B * H + 2 * B * H + T * B * D + T * B
                  + T * B * 4 * H + 3 * T * B * H + (D + H) * 4 * H
                  + T * B * D + (D + H + 1) * 4 * H + 2 * B * H),
            (2 * T * B * 4 * H * (H + D + D + H) + T * B * 4 * H
             + 20 * T * B * H))
    return {"lean": lean, "unroll": unroll, "resid": resid, "bptt": bptt}


def _cell_after_reset(torch, args, bf16):
    """The library yardstick of the lean step on ``args`` (x [1, B, D],
    done, c0, h0, wi, wh, b): ``torch.lstm_cell`` after the done-reset
    computes the same function (gate order i, f, g, o; its CUDA path needs
    both biases, so the second is zero), in bf16 for the bf16 variant."""
    x, done, c0, h0, wi, wh, b = args
    keep = (1.0 - done[0])[:, None]
    cast = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
    cell_args = tuple(cast(t) for t in (
        x[0], h0 * keep, c0 * keep, wi.t(), wh.t(), b, torch.zeros_like(b)))
    return lambda: torch.lstm_cell(cell_args[0], cell_args[1:3],
                                   *cell_args[3:])


def compare_lean_buckets(torch, lstm_cuda, device, matmul_dtype="float32",
                         batches=SERVICE_BUCKETS, what="a service bucket"):
    """The lean step kernel at the actor service's padded batch sizes
    (``SERVICE_BUCKETS``, phase 3p; ``FUSED_BUCKETS``, an accum_fused
    shard's, phase 3q), D=266, H=256: against its plain
    version at LSTM_TOL, two calls bitwise equal, then the wrapper's ms
    (CUDA events), the kernel's device ms (torch.profiler), the plain
    version's ms, the byte bound, and ``torch.lstm_cell`` after the reset
    at the same B (wrapper and device ms).  No time is gated."""
    bf16 = matmul_dtype == "bfloat16"
    tag = " bf16" if bf16 else ""
    gen = torch.Generator().manual_seed(4321)
    D, H = 266, 256
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    wi, wh = rand(D, 4 * H, scale=D ** -0.5), rand(H, 4 * H, scale=H ** -0.5)
    b = rand(4 * H, scale=0.1)
    md = dict(matmul_dtype=matmul_dtype)
    readings = {}
    for batch in batches:
        done = (torch.rand((1, batch), generator=gen) < 0.3).float()
        args = (rand(1, batch, D), done.to(device),
                rand(batch, H, scale=0.5), torch.tanh(rand(batch, H)),
                wi, wh, b)
        lean = lambda args=args: lstm_cuda.lstm_forward(
            *args, residuals=False, **md)
        plain = lambda args=args: lstm_cuda.lstm_forward_plain(
            *args, residuals=False, **md)
        name = f"lstm_fwd_lean{tag} T=1 B={batch} ({what})"
        kern, want, again = lean(), plain(), lean()
        torch.cuda.synchronize()
        err = _errors(zip(kern[:3], want[:3]))
        _check(name, *err, LSTM_TOL)
        _bitwise(torch, name, kern[:3], again[:3])
        cell = _cell_after_reset(torch, args, bf16)
        nbytes, flops = _lstm_costs(1, batch, D, H)["lean"]
        bound_ms, bound_by = _bound_ms(nbytes, flops, bf16)
        reading = dict(
            max_abs_err=err[0], ms=_time_ms(torch, lean, 50),
            device_ms=_device_ms(torch, lean, LEAN_STEP, 50),
            plain_ms=_time_ms(torch, plain, 10), bound_ms=bound_ms,
            cell_ms=_time_ms(torch, cell, 50),
            cell_device_ms=_device_ms(torch, cell, None, 50))
        readings[batch] = reading
        print(f"  lstm_fwd_lean{tag} [1,{batch},{D}] H={H}: kernel "
              f"{reading['ms']:.4f} ms, device {reading['device_ms']:.4f} "
              f"ms, plain {reading['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); torch.lstm_cell{tag} "
              f"after the reset {reading['cell_ms']:.4f} ms, device "
              f"{reading['cell_device_ms']:.4f} ms", flush=True)
    return readings


def compare_lstm(torch, lstm_cuda, device, matmul_dtype="float32"):
    """Lean forward (T=1), residual forward and BPTT (T=101) vs plain, at
    the products' operand type ``matmul_dtype``."""
    bf16 = matmul_dtype == "bfloat16"
    tag = " bf16" if bf16 else ""
    gen = torch.Generator().manual_seed(1234)
    T, B, D, H = 101, 32, 266, 256
    tol, short_tol = _lstm_tol(matmul_dtype, T), LSTM_TOL
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    x = rand(T, B, D)
    done = (torch.rand((T, B), generator=gen) < 0.05).float().to(device)
    c0, h0 = rand(B, H, scale=0.5), torch.tanh(rand(B, H))
    wi, wh = rand(D, 4 * H, scale=D ** -0.5), rand(H, 4 * H, scale=H ** -0.5)
    b = rand(4 * H, scale=0.1)
    rows = []
    costs = _lstm_costs(T, B, D, H)
    md = dict(matmul_dtype=matmul_dtype)

    # Lean forward: the step kernel at the actor's T=1 for several batch
    # sizes, and a T=5 forward (one call of the lean unroll) against the
    # plain loop and bitwise against the residual forward.
    lean = lambda *a: lstm_cuda.lstm_forward(*a, residuals=False, **md)
    lean_plain = lambda *a: lstm_cuda.lstm_forward_plain(
        *a, residuals=False, **md)
    for batch in (1, 8, 32, 64):
        xb = rand(1, batch, D)
        db = (torch.rand((1, batch), generator=gen) < 0.3).float().to(device)
        cb, hb = rand(batch, H, scale=0.5), torch.tanh(rand(batch, H))
        argsb = (xb, db, cb, hb, wi, wh, b)
        err = _errors(zip(lean(*argsb)[:3], lean_plain(*argsb)[:3]))
        _check(f"lstm_fwd_lean{tag} T=1 B={batch}", *err, short_tol)
    args5 = (x[:5].contiguous(), done[:5].contiguous(), c0, h0, wi, wh, b)
    err = _errors(zip(lean(*args5)[:3], lean_plain(*args5)[:3]))
    _check(f"lstm_fwd_lean{tag} T=5 (the lean unroll, one call)", *err,
           short_tol)
    _lean_matches_resid(torch, lstm_cuda, f"lstm_fwd_lean{tag} T=5", args5,
                        matmul_dtype)
    compare_lean_streams(torch, lstm_cuda, device, wi, wh, b, matmul_dtype)

    args1 = (x[:1].contiguous(), done[:1].contiguous(), c0, h0, wi, wh, b)
    kern = lean(*args1)
    plain = lean_plain(*args1)
    again = lean(*args1)
    torch.cuda.synchronize()
    err = _errors(zip(kern[:3], plain[:3]))
    _check(f"lstm_fwd_lean{tag}", *err, short_tol)
    _bitwise(torch, f"lstm_fwd_lean{tag}", kern[:3], again[:3])
    cell = _cell_after_reset(torch, args1, bf16)
    cell_h, cell_c = cell()
    cell_err = _errors([(cell_h.float(), plain.h), (cell_c.float(), plain.c)])
    print(f"  (torch.lstm_cell{tag} after the reset against the same plain "
          f"version: max_rel_err {cell_err[1]:.3e})", flush=True)
    nbytes, flops = costs["lean"]
    device_ms = _device_ms(torch, lambda: lean(*args1), LEAN_STEP, 50)
    cell_device_ms = _device_ms(torch, cell, None, 50)
    print(f"  lstm_fwd_lean{tag} [1,32,266] H=256: step kernel device time "
          f"{device_ms:.4f} ms, torch.lstm_cell{tag} after the reset (all "
          f"its kernels) {cell_device_ms:.4f} ms (torch.profiler)",
          flush=True)
    if not device_ms <= cell_device_ms:
        raise AssertionError(f"the lean step kernel{tag}'s device time "
                             f"exceeds torch.lstm_cell{tag}'s")
    rows.append((_variant("lstm_fwd_lean", matmul_dtype), "lstm.cu",
                 "lstm_pallas.py:89", err, lambda: lean(*args1),
                 lambda: lean_plain(*args1), cell, nbytes, flops, bf16,
                 device_ms))

    # Residual forward over the learner's T+1 = 101 steps.
    args = (x, done, c0, h0, wi, wh, b)
    resid = lambda: lstm_cuda.lstm_forward(*args, residuals=True, **md)
    resid_plain = lambda: lstm_cuda.lstm_forward_plain(
        *args, residuals=True, **md)
    kern, plain, again = resid(), resid_plain(), resid()
    torch.cuda.synchronize()
    err = _errors(zip(_resid_outputs(kern), _resid_outputs(plain)))
    _check(f"lstm_fwd_resid{tag}", *err, tol)
    if bf16:
        # The operands are rounded: the float32 plain version is further.
        f32_err = _errors(zip(_resid_outputs(kern), _resid_outputs(
            lstm_cuda.lstm_forward_plain(*args, residuals=True))))
        print(f"  (lstm_fwd_resid bf16 against the float32 plain version: "
              f"max_rel_err {f32_err[1]:.3e})", flush=True)
        if not 2 * err[1] < f32_err[1]:
            raise AssertionError("lstm_fwd_resid bf16 is not clearly closer "
                                 "to its plain version than to float32's")
    if not all(torch.equal(p, q) for p, q in zip(_resid_outputs(kern),
                                                   _resid_outputs(again))):
        raise AssertionError(f"lstm_fwd_resid{tag}: two calls gave "
                             f"different outputs")
    print(f"  lstm_fwd_resid{tag}: two calls bitwise equal", flush=True)
    compare_resid_shapes(torch, lstm_cuda, device, gen, wi, b, matmul_dtype)
    fwd_ms = resid_device_ms(torch, lstm_cuda, args, matmul_dtype)
    nbytes, flops = costs["resid"]
    if not fwd_ms < RESID_MAX_MS:
        raise AssertionError(f"the residual forward's device time "
                             f"{fwd_ms:.4f} ms is not below {RESID_MAX_MS} "
                             f"ms")
    rows.append((_variant("lstm_fwd_resid", matmul_dtype), "lstm.cu",
                 "lstm_pallas.py:105", err, resid, resid_plain, None,
                 nbytes, flops, bf16, fwd_ms))

    # BPTT on the plain residuals, so only the backward differs; then on
    # the kernels' own.
    fwd, res = kern, plain.residuals
    dys, dct, dht = rand(T, B, H), rand(B, H), rand(B, H)
    bargs = (dys, dct, dht, x, done, wi, wh, res, matmul_dtype)
    kern = lstm_cuda.lstm_backward(*bargs)
    plain = lstm_cuda.lstm_backward_plain(*bargs)
    again = lstm_cuda.lstm_backward(*bargs)
    torch.cuda.synchronize()
    err = _errors(zip(kern, plain))
    _check(f"lstm_bptt{tag}", *err, tol)
    if not all(torch.equal(p, q) for p, q in zip(kern, again)):
        raise AssertionError(f"lstm_bptt{tag}: two calls gave different "
                             f"gradients")
    print(f"  lstm_bptt{tag}: two calls bitwise equal", flush=True)
    chained = lstm_cuda.lstm_backward(*bargs[:7], fwd.residuals,
                                      matmul_dtype)
    _check(f"lstm_bptt{tag} on the residual forward kernels' residuals",
           *_errors(zip(chained, plain)), tol)
    # A short unroll, where every rounding must agree at LSTM_TOL.
    short = lambda t: t[:5].contiguous()
    res5 = type(res)(*(short(r) for r in res))
    bargs5 = (short(dys), dct, dht, short(x), short(done), wi, wh, res5,
              matmul_dtype)
    _check(f"lstm_bptt{tag} T=5", *_errors(zip(
        lstm_cuda.lstm_backward(*bargs5),
        lstm_cuda.lstm_backward_plain(*bargs5))), short_tol)
    compare_bptt_shapes(torch, lstm_cuda, device, gen, wi, b, matmul_dtype)
    bptt_ms = bptt_device_ms(torch, lstm_cuda, bargs)
    if not bptt_ms < BPTT_MAX_MS:
        raise AssertionError(f"the BPTT's device time {bptt_ms:.4f} ms is "
                             f"not below {BPTT_MAX_MS} ms")
    nbytes, flops = costs["bptt"]
    rows.append((_variant("lstm_bptt", matmul_dtype), "lstm.cu",
                 "lstm_pallas.py:123", err,
                 lambda: lstm_cuda.lstm_backward(*bargs),
                 lambda: lstm_cuda.lstm_backward_plain(*bargs),
                 None, nbytes, flops, bf16, bptt_ms))
    return rows


def _resid_outputs(out):
    """The residual forward's seven outputs: ys, c, h and the residuals."""
    return out[:3] + tuple(out.residuals)


def _shape_case(torch, gen, device, wi, b, steps, batch, hidden,
                done=None):
    """Forward inputs (x, done, c0, h0, Wi, Wh, b) of another shape, drawn
    from ``gen``: the main path's Wi and b where H is theirs."""
    D, H = wi.shape[0], wi.shape[1] // 4
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    x = rand(steps, batch, D)
    if done is None:
        done = (torch.rand((steps, batch), generator=gen) < 0.05).float()
    c0 = rand(batch, hidden, scale=0.5)
    h0 = torch.tanh(rand(batch, hidden))
    if hidden == H:
        wi_, b_ = wi, b
    else:
        wi_ = rand(D, 4 * hidden, scale=D ** -0.5)
        b_ = rand(4 * hidden, scale=0.1)
    wh_ = rand(hidden, 4 * hidden, scale=hidden ** -0.5)
    return x, done.to(device), c0, h0, wi_, wh_, b_


def _forced_resets(torch, gen):
    """A [101, 32] done with ~5% ones, all ones at t=0 and in column 5."""
    done = (torch.rand((101, 32), generator=gen) < 0.05).float()
    done[0] = 1.0
    done[:, 5] = 1.0
    return done


def compare_resid_shapes(torch, lstm_cuda, device, gen, wi, b,
                         matmul_dtype="float32"):
    """The residual forward at batch sizes that fill the clusters unevenly
    or leave one cluster (B=1, 33, 64), at T=1, with a done of 1 at t=0
    and on a whole column, and at H=512, where a CTA's slice of Wh does
    not fit its shared memory and the rest is read from L2."""
    tag = " bf16" if matmul_dtype == "bfloat16" else ""
    D = wi.shape[0]

    def check(name, steps, batch, hidden, done=None):
        args = _shape_case(torch, gen, device, wi, b, steps, batch, hidden,
                           done)
        kern = lstm_cuda.lstm_forward(*args, residuals=True,
                                      matmul_dtype=matmul_dtype)
        plain = lstm_cuda.lstm_forward_plain(*args, residuals=True,
                                             matmul_dtype=matmul_dtype)
        torch.cuda.synchronize()
        plan = lstm_cuda.resid_plan(batch, hidden)
        _check(f"lstm_fwd_resid{tag} {name}[{steps},{batch},{D}] "
               f"H={hidden} (R={plan.rows}, {plan.clusters} clusters, Wh "
               f"rows resident {plan.resident} of {hidden})",
               *_errors(zip(_resid_outputs(kern), _resid_outputs(plain))),
               _lstm_tol(matmul_dtype, steps))

    H = wi.shape[1] // 4
    for batch in (1, 33, 64):
        check("", 101, batch, H)
    check("", 1, 32, H)
    check("done=1 at t=0 and in column 5, ", 101, 32, H,
          _forced_resets(torch, gen))
    check("streamed Wh tail ", 8, 4, 512)


def compare_bptt_shapes(torch, lstm_cuda, device, gen, wi, b,
                        matmul_dtype="float32"):
    """BPTT, on the plain forward's residuals, at batch sizes that fill
    the clusters unevenly or leave one cluster (B=1, 33, 64), at T=1, with
    a done of 1 at t=0 and on a whole column, at H=32 (4 units a CTA), and
    at H=512, where a CTA's rows of Wh do not fit its shared memory and
    the rest is read from L2."""
    tag = " bf16" if matmul_dtype == "bfloat16" else ""
    D = wi.shape[0]

    def check(name, steps, batch, hidden, done=None):
        args = _shape_case(torch, gen, device, wi, b, steps, batch, hidden,
                           done)
        res = lstm_cuda.lstm_forward_plain(
            *args, residuals=True, matmul_dtype=matmul_dtype).residuals
        cot = lambda *shape: torch.randn(shape, generator=gen).to(device)
        bargs = (cot(steps, batch, hidden), cot(batch, hidden),
                 cot(batch, hidden), args[0], args[1], args[4], args[5], res,
                 matmul_dtype)
        kern = lstm_cuda.lstm_backward(*bargs)
        plain = lstm_cuda.lstm_backward_plain(*bargs)
        torch.cuda.synchronize()
        plan = lstm_cuda.bptt_plan(batch, hidden)
        _check(f"lstm_bptt{tag} {name}[{steps},{batch},{D}] H={hidden} "
               f"(R={plan.rows}, {plan.clusters} clusters, Wh depth "
               f"resident {plan.resident} of {hidden})",
               *_errors(zip(kern, plain)), _lstm_tol(matmul_dtype, steps))

    H = wi.shape[1] // 4
    for batch in (1, 33, 64):
        check("", 101, batch, H)
    check("", 1, 32, H)
    check("done=1 at t=0 and in column 5, ", 101, 32, H,
          _forced_resets(torch, gen))
    check("", 101, 32, 32)
    check("streamed Wh tail ", 8, 4, 512)


BPTT_CHAIN = "bptt_chain_kernel"
BPTT_GEMMS = ("bptt_dx_kernel", "bptt_dw_kernel", "sgemm_kernel<false")
BPTT_REDUCE = "bptt_reduce_kernel"


def bptt_device_ms(torch, lstm_cuda, bargs):
    """The BPTT's device time at the main path's shapes, every kernel it
    launches (torch.profiler): the chain, the products and the reduction;
    the co-resident cluster count; and, as the products' yardstick only,
    cuBLAS's time for the same three products at the operand type
    (torch.matmul, which the port never calls)."""
    dys, _, _, x, _, wi, _, res, matmul_dtype = bargs
    steps, batch, in_dim = x.shape
    hidden = dys.shape[-1]
    plan = lstm_cuda.bptt_plan(batch, hidden)
    active = lstm_cuda.bptt_active_clusters(plan, hidden)
    ms = _kernel_ms(torch, lambda: lstm_cuda.lstm_backward(*bargs), 10)
    chain, gemms = _matching(ms, BPTT_CHAIN), _matching(ms, BPTT_GEMMS)
    reduce = _matching(ms, BPTT_REDUCE)
    total = _matching(ms, (BPTT_CHAIN, BPTT_REDUCE) + BPTT_GEMMS)
    kernels = ", ".join(f"{_kernel_name(k)} {v:.4f}" for k, v in ms.items())
    print(f"  lstm_bptt {matmul_dtype} [{steps},{batch},{in_dim}] "
          f"H={hidden}: device time {total:.4f} ms = chain {chain:.4f} + "
          f"products {gemms:.4f} + reduction (db, dW slices) {reduce:.4f} "
          f"(torch.profiler: {kernels}); "
          f"plan {plan.clusters} clusters of 8 CTAs, R={plan.rows}, "
          f"{plan.smem_bytes} bytes of shared memory a CTA; the card holds "
          f"{active} such clusters at once", flush=True)
    if active < plan.clusters:
        print(f"  (the plan's {plan.clusters} clusters run in waves)",
              flush=True)
    if abs(total - sum(ms.values())) > 1e-9:
        raise AssertionError(f"the BPTT launched kernels the profiler "
                             f"filter does not count: {sorted(ms)}")
    dtype = torch.bfloat16 if matmul_dtype == "bfloat16" else torch.float32
    rows = steps * batch
    dg = torch.randn((rows, 4 * hidden), device=x.device).to(dtype)
    src = torch.cat([x.reshape(rows, in_dim),
                     res.hpost.reshape(rows, hidden)], dim=1).to(dtype)
    wi_t = wi.to(dtype)
    cublas = _device_ms(torch, lambda: (dg @ wi_t.t(), src.t() @ dg), None,
                        10)
    print(f"  (cuBLAS {dtype} torch.matmul for the same products, dx = "
          f"dgates.Wi^T and [dWi; dWh] = [x | hpost]^T.dgates: "
          f"{cublas:.4f} ms device time; the products' yardstick, not "
          f"the BPTT's)", flush=True)
    return total


def resid_device_ms(torch, lstm_cuda, args, matmul_dtype="float32"):
    """The residual forward's device time at the main path's shapes, both
    of its kernels (torch.profiler), and how many clusters of the
    recurrence the card holds at once."""
    batch, hidden = args[0].shape[1], args[2].shape[1]
    plan = lstm_cuda.resid_plan(batch, hidden)
    active = lstm_cuda.resid_active_clusters(plan, hidden)
    fn = lambda: lstm_cuda.lstm_forward(*args, residuals=True,
                                        matmul_dtype=matmul_dtype)
    gemm_ms = _device_ms(torch, fn, "sgemm_kernel<true", 10)
    rec_ms = _device_ms(torch, fn, "lstm_resid_kernel", 10)
    print(f"  lstm_fwd_resid {matmul_dtype} {list(args[0].shape)} "
          f"H={hidden}: device time "
          f"{gemm_ms + rec_ms:.4f} ms = input projection (sgemm_kernel<true>)"
          f" {gemm_ms:.4f} + recurrence (lstm_resid_kernel<{plan.rows}>) "
          f"{rec_ms:.4f} (torch.profiler); plan {plan.clusters} clusters of 8"
          f" CTAs, R={plan.rows}, {plan.smem_bytes} bytes of shared memory a "
          f"CTA; the card holds {active} such clusters at once", flush=True)
    if active < plan.clusters:
        print(f"  (the plan's {plan.clusters} clusters run in waves)",
              flush=True)
    return gemm_ms + rec_ms


def compare_lean_streams(torch, lstm_cuda, device, wi, wh, b,
                         matmul_dtype="float32"):
    """Two threads, each on its own stream (as the two actor groups run),
    launch the T=1 step kernel concurrently; each result must match the
    plain version."""
    tag = " bf16" if matmul_dtype == "bfloat16" else ""
    import threading

    gen = torch.Generator().manual_seed(55)
    cases = []
    for _ in range(2):
        x = torch.randn((1, 32, wi.shape[0]), generator=gen).to(device)
        done = (torch.rand((1, 32), generator=gen) < 0.3).float().to(device)
        c = (torch.randn((32, wh.shape[0]), generator=gen) * 0.5).to(device)
        h = torch.tanh(torch.randn((32, wh.shape[0]), generator=gen)).to(
            device)
        cases.append((x, done, c, h, wi, wh, b))
    outs = [None, None]
    barrier = threading.Barrier(2)

    def run(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            barrier.wait()
            for _ in range(200):
                outs[i] = lstm_cuda.lstm_forward(
                    *cases[i], residuals=False, matmul_dtype=matmul_dtype)
            stream.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for i in range(2):
        plain = lstm_cuda.lstm_forward_plain(*cases[i], residuals=False,
                                             matmul_dtype=matmul_dtype)
        err = _errors(zip(outs[i][:3], plain[:3]))
        _check(f"lstm_fwd_lean{tag}, stream {i + 1} of 2 concurrent", *err,
               LSTM_TOL)


def _device_generator(torch, device, seed):
    """A generator on ``device`` seeded with ``seed``: the grad-W checks
    draw their frames and cotangents (up to 365 M values) where they are
    used."""
    return torch.Generator(device=device).manual_seed(seed)


def _library_gradw(torch, conv_cuda, x_nchw, g_nchw, C, K, S, Fo):
    """cuDNN's weight gradient of the SAME-padded stem conv on NCHW views:
    ``conv2d_weight`` with the pads when they are symmetric; an asymmetric
    pair (a 15x15 frame's 2/3) has no single call, so the frames are padded
    first and the pad is timed with it."""
    _, (top, bottom) = conv_cuda.same_pads(x_nchw.shape[2], K, S)
    _, (left, right) = conv_cuda.same_pads(x_nchw.shape[3], K, S)
    if (top, left) == (bottom, right):
        return lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (Fo, C, K, K), g_nchw, S, (top, left))
    return lambda: torch.nn.grad.conv2d_weight(
        torch.nn.functional.pad(x_nchw, (left, right, top, bottom)),
        (Fo, C, K, K), g_nchw, S, 0)


# The kernels one grad-W call launches: the float32 band kernel or the
# bf16 mma.sync kernel of the shallow stem, the ResNet stem's, and the
# fixed-order reduce.
GRADW_KERNELS = ("conv_gradw_band_kernel", "conv_gradw_mma_kernel",
                 "reduce_partials_kernel")
RESNET_KERNELS = ("resnet_stem_gradw_kernel", "reduce_partials_kernel")


def compare_gradw(torch, conv_cuda, device, N=101 * 32, dtype=None,
                  frame=(72, 96, 3)):
    """The stem grad-W at the learner's merged batch N = 101 * 32 of
    ``frame`` frames (DMLab's 72x96x3; Atari's 84x84x4, the C=4 kernels
    ``stem_gradw_c4``; a one-channel gym level's 72x96x1, the C=1 kernels
    ``stem_gradw_c1``), then at other image counts, frame sizes and
    layouts, with x and g of ``dtype`` (float32, the band kernel, or
    bfloat16, the mma.sync kernel); two calls bitwise equal in every
    layout."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    Hh, W, C = frame
    K, S, Fo = 8, 4, 32
    stem = "stem_gradw" if C == 3 else f"stem_gradw_c{C}"
    tag = (f"_c{C}" if C != 3 else "") + (" bf16" if bf16 else "")
    gen = _device_generator(torch, device, 4321 if C == 3 else 4321 + C)
    OH, OW = -(-Hh // S), -(-W // S)
    # x as the torso makes it (uint8 / 255 in dtype), g a cotangent.
    frames = lambda *shape: (torch.randint(
        0, 256, shape, generator=gen, dtype=torch.uint8,
        device=device).to(dtype) / 255.0)
    cotangent = lambda *shape: torch.randn(
        shape, generator=gen, device=device).to(dtype)
    x = frames(N, Hh, W, C)
    g = cotangent(N, OH, OW, Fo)
    kern = conv_cuda.conv_gradw(x, g, K, S)
    plain = conv_cuda.conv_gradw_plain(x, g, K, S)
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    library = _library_gradw(torch, conv_cuda, x_nchw, g_nchw, C, K, S, Fo)
    lib_dw = library().permute(2, 3, 1, 0).float()
    again = conv_cuda.conv_gradw(x, g, K, S)
    torch.cuda.synchronize()
    err = _errors([(kern, plain)])
    _check(f"stem_gradw{tag}", *err, GRADW_TOL)
    if not torch.equal(kern, again):
        raise AssertionError(f"stem_gradw{tag}: two calls gave different "
                             f"dW")
    print(f"  stem_gradw{tag}: two calls bitwise equal", flush=True)
    lib_err = _errors([(lib_dw, plain)])
    print(f"  (cuDNN's conv2d_weight{' bf16' if bf16 else ''} against the "
          f"same plain version at C={C}: "
          f"max_rel_err {lib_err[1]:.3e})", flush=True)

    # Both layouts the torso can hand over, for each of x and g: contiguous
    # NHWC, and an NHWC view of contiguous NCHW memory.
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    for name, xx, gg in (("x NCHW-planar, g NHWC", planar(x), g),
                         ("x NHWC, g NCHW-planar", x, planar(g)),
                         ("x and g NCHW-planar", planar(x), planar(g))):
        got = conv_cuda.conv_gradw(xx, gg, K, S)
        _check(f"stem_gradw{tag}, {name}", *_errors([(got, plain)]),
               GRADW_TOL)
        _bitwise(torch, f"stem_gradw{tag}, {name}", [got],
                 [conv_cuda.conv_gradw(xx, gg, K, S)])
        del xx, gg
    # Image counts that split unevenly or not at all, and an odd frame size
    # (asymmetric SAME pads) in both layouts.
    for n, hh, ww in ((1, Hh, W), (N + 1, Hh, W), (64, 17, 23)):
        xs = frames(n, hh, ww, C)
        gs = cotangent(n, -(-hh // S), -(-ww // S), Fo)
        want = conv_cuda.conv_gradw_plain(xs, gs, K, S)
        layouts = (((xs, gs, "NHWC"), (planar(xs), planar(gs), "NCHW-planar"))
                   if n == 64 else ((xs, gs, "NHWC"),))
        for xx, gg, name in layouts:
            got = conv_cuda.conv_gradw(xx, gg, K, S)
            _check(f"stem_gradw{tag} N={n} {hh}x{ww} {name}",
                   *_errors([(got, want)]), GRADW_TOL)
        del xs, gs
    device_ms = _device_ms(
        torch, lambda: conv_cuda.conv_gradw(x, g, K, S), GRADW_KERNELS, 10)
    lib_device_ms = _device_ms(torch, library, None, 10)
    print(f"  stem_gradw{tag}: kernels' device time {device_ms:.4f} ms, "
          f"cuDNN conv2d_weight {lib_device_ms:.4f} ms "
          f"(torch.profiler)", flush=True)
    width = x.element_size()
    nbytes = width * (N * Hh * W * C + N * OH * OW * Fo) + 4 * K * K * C * Fo
    flops = 2 * N * C * Fo * _taps(Hh, K, S) * _taps(W, K, S)
    return [(stem + ("_bf16" if bf16 else ""),
             "conv_mma.cu" if bf16 else "conv.cu",
             "conv_pallas.py:86", err,
             lambda: conv_cuda.conv_gradw(x, g, K, S),
             lambda: conv_cuda.conv_gradw_plain(x, g, K, S),
             library, nbytes, flops, bf16, device_ms)]


def compare_gradw_frame(torch, conv_cuda, device, hh, ww, N=101 * 32,
                        dtype=None):
    """The shallow stem's grad-W at another frame size, N frames of
    ``hh`` x ``ww`` (``fake_tuple``'s and the small fake levels' 16x16
    take 4x4 outputs, Doom's 72x128 18x32: the learner's merged batch
    N = 101 * 32; ``gradw_plan`` sizes the bands from the output width),
    with x and g of ``dtype``: against its plain version, two calls bitwise
    equal, its device time and wrapper time against its bound, its plain
    version's and cuDNN's."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    name = f"stem_gradw{'_bf16' if bf16 else ''} [{N},{hh},{ww},3]"
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    gen = _device_generator(torch, device, hh * 1000 + ww)
    C, K, S, Fo = 3, 8, 4, 32
    OH, OW = -(-hh // S), -(-ww // S)
    x = (torch.randint(0, 256, (N, hh, ww, C), generator=gen,
                       dtype=torch.uint8, device=device).to(dtype) / 255.0)
    g = torch.randn((N, OH, OW, Fo), generator=gen, device=device).to(dtype)
    kern = lambda: conv_cuda.conv_gradw(x, g, K, S)
    plain = lambda: conv_cuda.conv_gradw_plain(x, g, K, S)
    library = _library_gradw(torch, conv_cuda, x.permute(0, 3, 1, 2),
                             g.permute(0, 3, 1, 2), C, K, S, Fo)
    first, want, again = kern(), plain(), kern()
    torch.cuda.synchronize()
    err = _errors([(first, want)])
    _check(name, *err, GRADW_TOL)
    _bitwise(torch, name, [first], [again])
    xx, gg = planar(x), planar(g)
    first = conv_cuda.conv_gradw(xx, gg, K, S)
    _check(f"{name}, x and g NCHW-planar", *_errors([(first, want)]),
           GRADW_TOL)
    _bitwise(torch, f"{name}, x and g NCHW-planar", [first],
             [conv_cuda.conv_gradw(xx, gg, K, S)])
    del xx, gg
    nbytes = (x.element_size() * (N * hh * ww * C + N * OH * OW * Fo)
              + 4 * K * K * C * Fo)
    bound, bound_by = _bound_ms(
        nbytes, 2 * N * C * Fo * _taps(hh, K, S) * _taps(ww, K, S), bf16)
    device_ms = _device_ms(torch, kern, GRADW_KERNELS, 10)
    print(f"  {name}: ms {_time_ms(torch, kern, 10):.4f}, device ms "
          f"{device_ms:.4f}, bound {bound:.4f} ms ({bound_by}), plain ms "
          f"{_time_ms(torch, plain, 3):.4f}, cuDNN conv2d_weight ms "
          f"{_time_ms(torch, library, 10):.4f}, device "
          f"{_device_ms(torch, library, None, 10):.4f}", flush=True)


def compare_resnet_gradw(torch, conv_cuda, device, N=101 * 32, dtype=None,
                         frame=(72, 96, 3)):
    """The ResNet stem's grad-W (3x3, stride 1, C channels into 16
    features) at the learner's merged batch N = 101 * 32 of ``frame``
    frames (72x96x3, or Atari's 84x84x4: the C=4 kernels
    ``resnet_stem_gradw_c4``), in both layouts, then at an uneven N, one
    image and an odd frame, with x and g of ``dtype`` (float32, or
    bfloat16 for the bf16-operand variant); two calls bitwise equal in
    every layout; device ms in both layouts against its bound and
    cuDNN's."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag = " bf16" if bf16 else ""
    Hh, W, C = frame
    K, Fo = 3, 16
    name = ("resnet_stem_gradw" + (f"_c{C}" if C != 3 else "")
            + ("_bf16" if bf16 else ""))
    gen = _device_generator(torch, device, 8765 + C - 3)
    frames = lambda *shape: (torch.randint(
        0, 256, shape, generator=gen, dtype=torch.uint8,
        device=device).to(dtype) / 255.0)
    cotangent = lambda *shape: torch.randn(
        shape, generator=gen, device=device).to(dtype)
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    x = frames(N, Hh, W, C)
    g = cotangent(N, Hh, W, Fo)
    kern = conv_cuda.conv_gradw(x, g, K, 1)
    plain = conv_cuda.conv_gradw_plain(x, g, K, 1)
    again = conv_cuda.conv_gradw(x, g, K, 1)
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    library = lambda: torch.nn.grad.conv2d_weight(
        x_nchw, (Fo, C, K, K), g_nchw, 1, 1)
    lib_dw = library().permute(2, 3, 1, 0).float()
    torch.cuda.synchronize()
    err = _errors([(kern, plain)])
    _check(name, *err, GRADW_TOL)
    if not torch.equal(kern, again):
        raise AssertionError(f"{name}: two calls gave different dW")
    print(f"  {name}: two calls bitwise equal", flush=True)
    print(f"  (cuDNN's conv2d_weight{tag} against the same plain version: "
          f"max_rel_err {_errors([(lib_dw, plain)])[1]:.3e})", flush=True)
    for layout, xx, gg in (("x NCHW-planar, g NHWC", planar(x), g),
                           ("x NHWC, g NCHW-planar", x, planar(g)),
                           ("x and g NCHW-planar", planar(x), planar(g))):
        got = conv_cuda.conv_gradw(xx, gg, K, 1)
        _check(f"{name}, {layout}", *_errors([(got, plain)]), GRADW_TOL)
        _bitwise(torch, f"{name}, {layout}", [got],
                 [conv_cuda.conv_gradw(xx, gg, K, 1)])
        del xx, gg
    for n, hh, ww in ((N + 1, Hh, W), (1, Hh, W), (64, 17, 23)):
        xs, gs = frames(n, hh, ww, C), cotangent(n, hh, ww, Fo)
        want = conv_cuda.conv_gradw_plain(xs, gs, K, 1)
        for xx, gg, layout in ((xs, gs, "NHWC"),
                               (planar(xs), planar(gs), "NCHW-planar")):
            _check(f"{name} N={n} {hh}x{ww} {layout}",
                   *_errors([(conv_cuda.conv_gradw(xx, gg, K, 1), want)]),
                   GRADW_TOL)
        del xs, gs
    width = x.element_size()
    nbytes = width * (N * Hh * W * C + N * Hh * W * Fo) + 4 * K * K * C * Fo
    flops = 2 * N * C * Fo * _taps(Hh, K, 1) * _taps(W, K, 1)
    bound, bound_by = _bound_ms(nbytes, flops, bf16)
    lib_device_ms = _device_ms(torch, library, None, 10)
    device_ms = {}
    for layout, xx, gg in (("x and g NHWC", x, g),
                           ("x and g NCHW-planar", planar(x), planar(g))):
        device_ms[layout] = _resnet_device_ms(torch, conv_cuda, xx, gg)
        plan = conv_cuda.resnet_gradw_plan(
            N, Hh, W, width, conv_cuda._sm_count(0),
            conv_cuda.tensor_layout(xx) == "chw",
            conv_cuda.tensor_layout(gg) == "chw", C)
        print(f"  {name}, {layout}: kernels' device time "
              f"{device_ms[layout]:.4f} ms, {device_ms[layout] / bound:.2f}x "
              f"its bound {bound:.4f} ms "
              f"({bound_by}); cuDNN conv2d_weight{tag} {lib_device_ms:.4f} "
              f"ms (torch.profiler); plan {plan.units} units over "
              f"{plan.blocks} blocks, {plan.stages} stages, "
              f"{plan.smem_bytes} bytes of shared memory a block",
              flush=True)
        del xx, gg
    return [(name, "conv_resnet.cu", "conv_pallas.py:86", err,
             lambda: conv_cuda.conv_gradw(x, g, K, 1),
             lambda: conv_cuda.conv_gradw_plain(x, g, K, 1),
             library, nbytes, flops, bf16, device_ms["x and g NHWC"])]


def _resnet_device_ms(torch, conv_cuda, x, g):
    """The ResNet stem grad-W's device ms per call (its kernel and the
    fixed-order reduce), torch.profiler over 10 calls."""
    return _device_ms(
        torch, lambda: conv_cuda.conv_gradw(x, g, 3, 1), RESNET_KERNELS, 10)


def resnet_gradw_in_layout(torch, conv_cuda, device, layouts, card,
                           N=101 * 32):
    """The bf16 ResNet stem grad-W's time at the learner's N=3232 frames of
    72x96 in each (x, g) layout the deep path's backward handed to
    ``conv_gradw`` (``tensor_layout`` names), against its byte bound and
    cuDNN's bf16 ``conv2d_weight``: its ms per call over 20 back-to-back
    calls from CUDA events (the card, not the host, sets their pace; both
    kernels and the gaps between them) must be within 2x its bound
    (``RESNET_BF16_MAX_MS``), and its device time from torch.profiler is
    printed beside it (the profiler can drop or shorten records late in a
    long process: PERF.md, section 6)."""
    gen = _device_generator(torch, device, 8766)
    Hh, W, C, Fo = 72, 96, 3, 16
    x = (torch.randint(0, 256, (N, Hh, W, C), generator=gen,
                       dtype=torch.uint8, device=device).bfloat16() / 255.0)
    g = torch.randn((N, Hh, W, Fo), generator=gen, device=device).bfloat16()
    planar = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    bound, bound_by = _bound_ms(2 * N * Hh * W * (C + Fo) + 4 * 27 * Fo,
                                2 * N * C * Fo * _taps(Hh, 3, 1)
                                * _taps(W, 3, 1), True)
    lib_ms = _device_ms(torch, lambda: torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2), (Fo, C, 3, 3), g.permute(0, 3, 1, 2), 1, 1),
        None, 10)
    for x_layout, g_layout in sorted(layouts):
        xx = planar(x) if x_layout == "chw" else x
        gg = planar(g) if g_layout == "chw" else g
        call_ms = _time_ms(torch, lambda: conv_cuda.conv_gradw(xx, gg, 3, 1),
                           20)
        device_ms = _resnet_device_ms(torch, conv_cuda, xx, gg)
        print(f"  resnet_stem_gradw_bf16 in the deep path's layout (x "
              f"{x_layout}, g {g_layout}): {call_ms:.4f} ms per call (CUDA "
              f"events), {call_ms / bound:.2f}x its bound {bound:.4f} ms "
              f"({bound_by}); device time {device_ms:.4f} ms "
              f"(torch.profiler); cuDNN bf16 conv2d_weight {lib_ms:.4f} ms; "
              f"{card}", flush=True)
        if not call_ms <= RESNET_BF16_MAX_MS:
            raise AssertionError(
                f"the bf16 ResNet stem grad-W's {call_ms:.4f} ms per call "
                f"exceeds {RESNET_BF16_MAX_MS} ms")
        del xx, gg


def _lean_matches_resid(torch, lstm_cuda, name, args, matmul_dtype):
    """The lean forward at T>1 is the residual forward's two launches
    without the residual stores: ys, cT and hT must be bitwise equal.
    Returns the residual forward's output."""
    md = dict(matmul_dtype=matmul_dtype)
    lean = lstm_cuda.lstm_forward(*args, residuals=False, **md)
    resid = lstm_cuda.lstm_forward(*args, residuals=True, **md)
    if not all(torch.equal(p, q) for p, q in zip(lean[:3], resid[:3])):
        diff = max(float((p - q).abs().max())
                   for p, q in zip(lean[:3], resid[:3]))
        raise AssertionError(f"{name}: ys, cT and hT differ from the "
                             f"residual forward's (max abs difference "
                             f"{diff:.3e})")
    print(f"  {name}: ys, cT and hT bitwise equal to the residual "
          f"forward's", flush=True)
    return resid


def _lean_unroll_check(torch, lstm_cuda, name, args, matmul_dtype):
    """The lean forward over ``args`` against its plain version at
    LSTM_TOL: the step kernel at T=1, past it the lean unroll, whose ys,
    cT and hT must also be bitwise the residual forward's
    (``_lean_matches_resid``).  With bf16 operands each step rounds the
    float32 carry h of the step before to bf16, and where the kernel's h
    and the plain version's differ in the last float32 bits (their sums
    run in other orders) that rounding can flip, 2**-8 of the operand,
    and the flip travels down its batch row and seeds more.  So a bf16
    unroll is also held step by step: each step of the unroll against the
    plain step fed the unroll's own carry (its ys and the residual
    forward's cnew of the step before), and the T=1 step kernel fed the
    same carry, both at LSTM_TOL; the flips of h's rounding between the
    two free-running unrolls are counted by batch row; every row without
    one is held free-running at LSTM_TOL, and the whole unroll at LSTM_TOL
    where no row flipped, at LSTM_BF16_LONG_TOL where one did, as the
    residual forward is (the lean unroll is its arithmetic bit for bit).
    Over T=5 at B=32, H=256 the card counted 6 flips in 4 rows at D=330
    and 24 in 2 rows at D=259 (PERF.md, section 6)."""
    md = dict(matmul_dtype=matmul_dtype)
    kern = lstm_cuda.lstm_forward(*args, residuals=False, **md)
    plain = lstm_cuda.lstm_forward_plain(*args, residuals=False, **md)
    err = _errors(zip(kern[:3], plain[:3]))
    x, done, c, h, wi, wh, b = args
    steps = x.shape[0]
    if steps > 1:
        resid = _lean_matches_resid(torch, lstm_cuda, name, args,
                                    matmul_dtype)
    if matmul_dtype != "bfloat16" or steps == 1:
        _check(name, *err, LSTM_TOL)
        return
    worst_unroll = worst_step = (0.0, 0.0)
    larger = lambda a, e: max(a, e, key=lambda v: v[1])
    for t in range(steps):
        step = (x[t:t + 1], done[t:t + 1], c, h, wi, wh, b)
        p = lstm_cuda.lstm_forward_plain(*step, residuals=False, **md)
        k = lstm_cuda.lstm_forward(*step, residuals=False, **md)
        c, h = resid.residuals.cnew[t], kern.ys[t]
        worst_unroll = larger(worst_unroll, _errors([(h, p.h), (c, p.c)]))
        worst_step = larger(worst_step, _errors(zip(k[:3], p[:3])))
    _check(f"{name} step by step from the unroll's own carry",
           *worst_unroll, LSTM_TOL)
    _check(f"{name}: the T=1 step kernel fed the unroll's carries",
           *worst_step, LSTM_TOL)
    keep = (1.0 - done[1:])[..., None]
    flipped = ((keep * kern.ys[:-1]).bfloat16()
               != (keep * plain.ys[:-1]).bfloat16())
    flips = int(flipped.sum())
    clean = ~flipped.any(dim=2).any(dim=0)
    print(f"  ({name}: {flips} flips of the bf16 rounding of h between the "
          f"kernel's and the plain version's free-running unrolls, in "
          f"{int((~clean).sum())} of {clean.numel()} batch rows)", flush=True)
    if bool(clean.any()):
        _check(f"{name} free-running, the {int(clean.sum())} rows without "
               f"a flip", *_errors(zip(
                   (kern.ys[:, clean], kern.c[clean], kern.h[clean]),
                   (plain.ys[:, clean], plain.c[clean], plain.h[clean]))),
               LSTM_TOL)
    _check(f"{name} free-running", *err,
           LSTM_BF16_LONG_TOL if flips else LSTM_TOL)


def compare_lstm_wide(torch, lstm_cuda, device, matmul_dtype="float32",
                      D=330):
    """The three LSTM kernels at a core input width D other than the main
    path's 266, T=101 and B=32, H=256, against their plain versions: the
    lean forward at T=1 (the step kernel) and T=5 (the lean unroll), the
    residual forward and the BPTT with two
    calls bitwise equal; each one's device time (torch.profiler), its
    wrapper's and its plain version's time (CUDA events), its bound, and
    the library's time (``torch.lstm_cell`` after the reset beside the
    lean step, cuBLAS's for the BPTT's products); these by part.  The
    widths: the deep agent's D = 256 + 1 + 9 + 64 = 330 (the
    instruction's 64 features), ``fake_tuple``'s D = 256 + 1 + (3 + 5) =
    265 (odd: the x rows lose their 8-byte alignment), Doom's full
    discretized space's D = 256 + 1 + 39 = 296."""
    bf16 = matmul_dtype == "bfloat16"
    tag = " bf16" if bf16 else ""
    gen = torch.Generator().manual_seed(10 * D)
    T, B, H = 101, 32, 256
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    x = rand(T, B, D)
    done = (torch.rand((T, B), generator=gen) < 0.05).float().to(device)
    c0, h0 = rand(B, H, scale=0.5), torch.tanh(rand(B, H))
    wi, wh = rand(D, 4 * H, scale=D ** -0.5), rand(H, 4 * H, scale=H ** -0.5)
    b = rand(4 * H, scale=0.1)
    md = dict(matmul_dtype=matmul_dtype)
    ms = {}
    for steps in (1, 5):
        args = (x[:steps].contiguous(), done[:steps].contiguous(), c0, h0,
                wi, wh, b)
        _lean_unroll_check(torch, lstm_cuda, f"lstm_fwd_lean{tag} "
                           f"[{steps},{B},{D}]", args, matmul_dtype)
    args1 = (x[:1].contiguous(), done[:1].contiguous(), c0, h0, wi, wh, b)
    lean = lambda: lstm_cuda.lstm_forward(*args1, residuals=False, **md)
    _bitwise(torch, f"lstm_fwd_lean{tag} D={D}", lean()[:3], lean()[:3])
    errs = {"lean": _errors(zip(lean()[:3], lstm_cuda.lstm_forward_plain(
        *args1, residuals=False, **md)[:3]))}
    ms["lean"] = _device_ms(torch, lean, LEAN_STEP, 50)
    # The library yardstick, as compare_lstm's: torch.lstm_cell after the
    # done-reset (a zero second bias), in bf16 for the bf16 variant.
    keep = (1.0 - args1[1][0])[:, None]
    cast = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
    cell_args = tuple(cast(t) for t in (
        args1[0][0], h0 * keep, c0 * keep, wi.t(), wh.t(), b,
        torch.zeros_like(b)))
    cell = lambda: torch.lstm_cell(cell_args[0], cell_args[1:3],
                                   *cell_args[3:])
    library = dict(ms=_time_ms(torch, cell, 50),
                   device_ms=_device_ms(torch, cell, None, 50))
    print(f"  torch.lstm_cell{tag} after the reset at D={D}: "
          f"{library['ms']:.4f} ms, device {library['device_ms']:.4f} ms",
          flush=True)
    args = (x, done, c0, h0, wi, wh, b)
    kern = lstm_cuda.lstm_forward(*args, residuals=True, **md)
    plain = lstm_cuda.lstm_forward_plain(*args, residuals=True, **md)
    again = lstm_cuda.lstm_forward(*args, residuals=True, **md)
    torch.cuda.synchronize()
    tol = _lstm_tol(matmul_dtype, T)
    errs["resid"] = _errors(zip(_resid_outputs(kern), _resid_outputs(plain)))
    _check(f"lstm_fwd_resid{tag} [{T},{B},{D}]", *errs["resid"], tol)
    if not all(torch.equal(p, q) for p, q in zip(_resid_outputs(kern),
                                                   _resid_outputs(again))):
        raise AssertionError(f"lstm_fwd_resid{tag} D={D}: two calls gave "
                             f"different outputs")
    ms["resid"] = resid_device_ms(torch, lstm_cuda, args, matmul_dtype)
    bargs = (rand(T, B, H), rand(B, H), rand(B, H), x, done, wi, wh,
             plain.residuals, matmul_dtype)
    kern = lstm_cuda.lstm_backward(*bargs)
    again = lstm_cuda.lstm_backward(*bargs)
    errs["bptt"] = _errors(zip(kern, lstm_cuda.lstm_backward_plain(*bargs)))
    _check(f"lstm_bptt{tag} [{T},{B},{D}]", *errs["bptt"], tol)
    if not all(torch.equal(p, q) for p, q in zip(kern, again)):
        raise AssertionError(f"lstm_bptt{tag} D={D}: two calls gave "
                             f"different gradients")
    ms["bptt"] = bptt_device_ms(torch, lstm_cuda, bargs)
    calls = {
        "lean": (lambda: lstm_cuda.lstm_forward(*args1, residuals=False,
                                                **md),
                 lambda: lstm_cuda.lstm_forward_plain(
                     *args1, residuals=False, **md), 50),
        "resid": (lambda: lstm_cuda.lstm_forward(*args, residuals=True,
                                                 **md),
                  lambda: lstm_cuda.lstm_forward_plain(
                      *args, residuals=True, **md), 10),
        "bptt": (lambda: lstm_cuda.lstm_backward(*bargs),
                 lambda: lstm_cuda.lstm_backward_plain(*bargs), 10)}
    costs = _lstm_costs(T, B, D, H)
    print(f"  LSTM kernels{tag} at D={D}: two calls bitwise equal", flush=True)
    ms["lean_library"] = library
    for part, (kern_fn, plain_fn, iters) in calls.items():
        bound, bound_by = _bound_ms(*costs[part], bf16)
        times = dict(device_ms=ms[part], max_abs_err=errs[part][0],
                     ms=_time_ms(torch, kern_fn, iters),
                     plain_ms=_time_ms(torch, plain_fn, max(3, iters // 5)),
                     bound_ms=bound, bound_by=bound_by)
        ms[part] = times
        print(f"    {part}: ms {times['ms']:.4f}, device ms "
              f"{times['device_ms']:.4f}, bound {bound:.4f} ms "
              f"({bound_by}), plain ms {times['plain_ms']:.4f}", flush=True)
    return ms


def compare_lean_target(torch, lstm_cuda, device, matmul_dtype="float32"):
    """The lean unroll over the IMPACT target network's unroll (phase 3o):
    x [101, 32, 266], H=256, one call (the input GEMM and the lean
    recurrence), against its plain version (``_lean_unroll_check``: ys,
    cT and hT bitwise the residual forward's, the bf16 unroll at
    LSTM_BF16_LONG_TOL where rows flip, as the residual forward's 101
    steps), two calls bitwise equal, and its device time (torch.profiler,
    both kernels; the call must launch no other) beside the
    one-launch-a-step loop's ``STEP_LOOP_TARGET_MS``.  Returns its phase-2
    row: the bound is the whole unroll's (``_lstm_costs``' ``unroll``: the
    weights read once, as the TPU kernel's constant-index blocks fetch
    them once over its grid of T); the library call is 101
    ``torch.lstm_cell`` calls, each after the done-reset of its carry (two
    multiplies), in bf16 for the bf16 variant."""
    bf16 = matmul_dtype == "bfloat16"
    tag = " bf16" if bf16 else ""
    gen = torch.Generator().manual_seed(4321)
    T, B, D, H = 101, 32, 266, 256
    rand = lambda *shape, scale=1.0: (
        torch.randn(shape, generator=gen) * scale).to(device)
    x = rand(T, B, D)
    done = (torch.rand((T, B), generator=gen) < 0.05).float().to(device)
    c0, h0 = rand(B, H, scale=0.5), torch.tanh(rand(B, H))
    wi, wh = rand(D, 4 * H, scale=D ** -0.5), rand(H, 4 * H, scale=H ** -0.5)
    b = rand(4 * H, scale=0.1)
    args = (x, done, c0, h0, wi, wh, b)
    md = dict(matmul_dtype=matmul_dtype)
    name = f"lstm_fwd_lean{tag} [{T},{B},{D}] (the target unroll)"
    _lean_unroll_check(torch, lstm_cuda, name, args, matmul_dtype)
    lean = lambda: lstm_cuda.lstm_forward(*args, residuals=False, **md)
    plain = lambda: lstm_cuda.lstm_forward_plain(*args, residuals=False,
                                                 **md)
    _bitwise(torch, name, lean()[:3], lean()[:3])
    err = _errors(zip(lean()[:3], plain()[:3]))
    cast = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
    xs = [cast(x[t]) for t in range(T)]
    keeps = [cast((1.0 - done[t])[:, None]) for t in range(T)]
    wi_t, wh_t, bias, zero_b = (cast(t) for t in (
        wi.t().contiguous(), wh.t().contiguous(), b, torch.zeros_like(b)))

    def cells():
        h, c = cast(h0), cast(c0)
        for t in range(T):
            h, c = torch.lstm_cell(xs[t], (h * keeps[t], c * keeps[t]),
                                   wi_t, wh_t, bias, zero_b)
        return h, c

    cell_h, cell_c = cells()
    final = plain()
    cell_err = _errors([(cell_h.float(), final.h), (cell_c.float(),
                                                    final.c)])
    print(f"  (101 torch.lstm_cell{tag} calls after the resets against the "
          f"same plain version: max_rel_err {cell_err[1]:.3e})", flush=True)
    by_kernel = _kernel_ms(torch, lean, 10)
    device_ms = _matching(by_kernel, LEAN_UNROLL)
    if abs(device_ms - sum(by_kernel.values())) > 1e-9:
        raise AssertionError(f"the lean unroll launched kernels the profiler "
                             f"filter does not count: {sorted(by_kernel)}")
    cell_device_ms = _device_ms(torch, cells, None, 10)
    host_ms = _host_ms(torch, lean, 20)
    parts = ", ".join(f"{_kernel_name(k)} {v:.4f}"
                      for k, v in by_kernel.items())
    print(f"  lstm_fwd_lean{tag} [{T},{B},{D}]: the lean unroll in one "
          f"call, host {host_ms:.4f} ms a call (the wrapper's own time), "
          f"device time {device_ms:.4f} ms ({parts}) against "
          f"{STEP_LOOP_TARGET_MS[matmul_dtype]:.4f} ms as {T} step "
          f"launches (PERF.md, section 6); 101 torch.lstm_cell{tag} after the "
          f"resets (all their kernels) {cell_device_ms:.4f} ms "
          f"(torch.profiler)", flush=True)
    nbytes, flops = _lstm_costs(T, B, D, H)["unroll"]
    return [(_variant("lstm_fwd_lean_unroll", matmul_dtype), "lstm.cu",
             "lstm_pallas.py:89", err, lean, plain, cells, nbytes, flops,
             bf16, device_ms)]


def time_rows(torch, rows):
    """Each phase-2 row timed on the card: the kernel's wrapper, its plain
    version and the library call (CUDA events), beside its bound; the
    kernels line's fields by kernel name."""
    timed = {}
    for (name, src, replaces, err, kern_fn, plain_fn, lib_fn, nbytes,
         flops, bf16, device_ms) in rows:
        iters = 50 if name.startswith(("lstm_fwd_lean",
                                       "vtrace_fused")) else 10
        if name.startswith("lstm_fwd_lean_unroll"):
            iters = 10
        ms = _time_ms(torch, kern_fn, iters)
        plain_ms = _time_ms(torch, plain_fn, max(3, iters // 5))
        lib_ms = _time_ms(torch, lib_fn, iters) if lib_fn else None
        bound_ms, bound_by = _bound_ms(nbytes, flops, bf16)
        timed[name] = dict(
            name=name, route="cuda",
            source=f"scalable_agent_tpu_torch/csrc/{src}",
            replaces=f"scalable_agent_tpu/ops/{replaces}",
            max_abs_err=err[0], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            device_ms=device_ms)
        print(f"  {name}: kernel {ms:.4f} ms, device {device_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return timed


def _vtrace_errors(torch, pairs):
    """``_errors`` over the entries finite in the plain version; a NaN, +inf
    or -inf must sit at the same places in the kernel's output."""
    finite = []
    for kernel, plain in pairs:
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(kernel), test(plain)):
                raise AssertionError(f"vtrace_fused: {test.__name__} differs "
                                     f"from the plain version")
        mask = torch.isfinite(plain)
        finite.append((kernel[mask], plain[mask]))
    return _errors(finite)


def _bits(torch, tensors):
    return [t.view(torch.int32) for t in tensors]


def _host_ms(torch, fn, iters):
    """Mean host milliseconds per call: the wrapper's own time on the CPU,
    with the card kept ahead of it (no synchronise inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host_ms


def compare_vtrace(torch, vtrace_cuda, vtrace, device):
    """Fused V-trace at the learner's [T, B] = [100, 32], with ~5% done
    (discount 0) and log-rho spread over about +-3 so both clips engage;
    also at [100, 8192], T=1, T=101, [3, 33] (T below the kernel's 16
    chunks, a ragged column tile), NaN log-rhos on a chunk boundary and
    inside a chunk, a +inf rho (clipped, and with clips of None), and a
    column that is done at every step.  Two calls must be bitwise equal,
    and the device time at [100, 32] below ``VTRACE_MAX_MS``.  Also times
    the scan_impl=auto recurrence at [100, 32]."""
    gen = torch.Generator().manual_seed(777)

    def inputs(steps, cols):
        uniform = lambda: torch.rand((steps, cols), generator=gen)
        log_rhos = uniform() * 6.0 - 3.0
        discounts = (uniform() >= 0.05).float() * 0.99
        rewards = torch.randn((steps, cols), generator=gen)
        values = torch.randn((steps, cols), generator=gen)
        boot = torch.randn((cols,), generator=gen)
        return log_rhos, discounts, rewards, values, boot

    def check(name, args, clips=(1.0, 1.0)):
        args = [t.to(device) for t in args]
        kern = vtrace_cuda.vtrace_fused(*args, *clips)
        again = vtrace_cuda.vtrace_fused(*args, *clips)
        plain = vtrace_cuda.vtrace_fused_plain(*args, *clips)
        torch.cuda.synchronize()
        err = _vtrace_errors(torch, zip(kern, plain))
        _check(f"vtrace_fused {name}", *err, VTRACE_TOL)
        if not all(torch.equal(a, b) for a, b in zip(_bits(torch, kern),
                                                     _bits(torch, again))):
            raise AssertionError(f"vtrace_fused {name}: two calls gave "
                                 f"different bits")
        return args, kern, err

    rows = []
    for steps, cols in ((100, 32), (100, 8192), (1, 32)):
        args, _, err = check(f"[{steps},{cols}]", inputs(steps, cols))
        nbytes = 4 * (6 * steps * cols + cols)
        flops = 16 * steps * cols
        kernel_fn = lambda args=args: vtrace_cuda.vtrace_fused(*args)
        ms = _time_ms(torch, kernel_fn, 50)
        host_ms = _host_ms(torch, kernel_fn, 200)
        device_ms = _device_ms(torch, kernel_fn, "vtrace_chunked_kernel", 50)
        bound_ms, bound_by = _bound_ms(nbytes, flops)
        print(f"  vtrace_fused [{steps},{cols}]: {ms:.4f} ms per wrapper "
              f"call (CUDA events), host {host_ms:.4f} ms per call, kernel "
              f"device time {device_ms:.4f} ms (torch.profiler), bound "
              f"{bound_ms:.5f} ms ({bound_by}); two calls bitwise equal",
              flush=True)
        if (steps, cols) == (100, 32):
            if not device_ms < VTRACE_MAX_MS:
                raise AssertionError(
                    f"vtrace_fused [100,32]: device time {device_ms:.4f} ms "
                    f"is not below {VTRACE_MAX_MS} ms")
            auto_ms = _time_ms(torch, lambda: vtrace.from_importance_weights(
                *args, scan_impl="associative"), 20)
            pallas_ms = _time_ms(torch, lambda: vtrace.from_importance_weights(
                *args, scan_impl="pallas"), 20)
            print(f"  from_importance_weights [100,32]: scan_impl=auto "
                  f"(associative, the log-depth scan) {auto_ms:.4f} ms, "
                  f"scan_impl=pallas {pallas_ms:.4f} ms", flush=True)
            rows.append(("vtrace_fused", "vtrace.cu", "vtrace_pallas.py:44",
                         err, kernel_fn,
                         lambda args=args: vtrace_cuda.vtrace_fused_plain(
                             *args),
                         None, nbytes, flops, False, device_ms))

    check("[101,32]", inputs(101, 32))
    check("[3,33]", inputs(3, 33))
    # A NaN at the first step of the kernel's chunk 4, and two steps into it.
    base, extra = divmod(100, vtrace_cuda.KERNEL_CHUNKS)
    edge = 4 * base + min(4, extra)
    args = inputs(100, 32)
    for t, col in ((edge, 3), (edge + 2, 7)):
        args[0][t, col] = float("nan")
    _, (vs, pg), _ = check(f"NaN log-rhos at t={edge} and t={edge + 2}",
                           args)
    nan = torch.isnan(vs)
    want = torch.zeros_like(nan)
    want[:edge + 1, 3] = want[:edge + 3, 7] = True
    if not torch.equal(nan, want) or not torch.equal(torch.isnan(pg), want):
        raise AssertionError("vtrace_fused: a NaN log-rho did not reach "
                             "exactly its step and the earlier ones of its "
                             "column")
    args = inputs(100, 32)
    args[0][40, 5] = float("inf")
    check("+inf rho", args)
    check("+inf rho, clips None", args, (None, None))
    args = inputs(100, 32)
    args[1][:, 9] = 0.0
    check("a column done at every step", args)
    return rows


def compare_agent(torch, device, compute_dtype=None, torso_type="shallow",
                  use_instruction=False):
    """Forward and every parameter gradient of the whole agent on the card
    against the same weights on the CPU (plain versions, CPU convs), at
    full width and a short unroll, under the dtype policy of
    ``compute_dtype`` (the core's operands follow it, as ``auto``
    resolves); ``torso_type`` and ``use_instruction`` pick the agent (the
    deep one's instructions hold full, partial and all-padding rows)."""
    compute_dtype = compute_dtype or torch.float32
    bf16 = compute_dtype == torch.bfloat16
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
    agent_cpu = ImpalaAgent(
        9, (72, 96, 3), generator=gen, compute_dtype=compute_dtype,
        core_matmul_dtype="bfloat16" if bf16 else "float32",
        torso_type=torso_type, use_instruction=use_instruction)
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
        instruction = None
        if use_instruction:
            ids = torch.randint(1, 1001, (T, B, 16), generator=g)
            length = torch.randint(0, 17, (T, B, 1), generator=g)
            instruction = torch.where(torch.arange(16) < length, ids,
                                      0).int().to(dev)
        env = StepOutput(reward, StepOutputInfo(zeros, zeros), done,
                         Observation(frame=frame, instruction=instruction))
        return actions, env, state

    def run(agent, dev, record=None):
        with record or contextlib.nullcontext():
            (logits, baseline), state = agent(*inputs(dev))
        loss = (logits.square().sum() + baseline.sum()
                + state.c.sum() + state.h.square().sum())
        grads = torch.autograd.grad(loss, list(agent.parameters()))
        return [t.detach().float().cpu() for t in
                (logits, baseline, state.c, state.h, *grads)]

    deep = torso_type == "resnet"
    what = "deep agent" if deep else "agent"
    name = f"{what} forward + parameter gradients{' (bf16 policy)' * bf16}"
    cpu = torch.device("cpu")
    if not (deep and bf16):
        card, plain = run(agent_gpu, device), run(agent_cpu, cpu)
        _check(name, *_errors(zip(card, plain)),
               AGENT_BF16_TOL if bf16 else AGENT_TOL)
        return
    # The deep agent at bf16 (see DEEP_BF16_FRACTION): each side's relu
    # and max-pool inputs and the stem's own cotangent are recorded.
    records = {side: _recorder(torch) for side in ("card", "cpu", "f32")}
    card = run(agent_gpu, device, records["card"])
    plain = run(agent_cpu, cpu, records["cpu"])
    agent_f32 = ImpalaAgent(9, (72, 96, 3), torso_type=torso_type,
                            use_instruction=use_instruction)
    agent_f32.load_state_dict(agent_cpu.state_dict())
    f32 = run(agent_f32, cpu, records["f32"])
    leaves = ["logits", "baseline", "state.c", "state.h"] + [
        n for n, _ in agent_cpu.named_parameters()]

    def worst(pairs):
        """The leaf furthest apart, and its scale-relative distance."""
        return max(((_errors([pair])[1], leaf) for leaf, pair in pairs),
                   default=(0.0, "none"))

    convnet = [i for i, leaf in enumerate(leaves)
               if leaf.startswith("convnet.")]
    rest = [i for i in range(len(leaves)) if i not in convnet]
    pick = lambda idx, a, b: [(leaves[i], (a[i], b[i])) for i in idx]
    rest_err = worst(pick(rest, card, plain))
    print(f"  ({name}, outside the convnet: furthest leaf {rest_err[1]} "
          f"at {rest_err[0]:.3e})", flush=True)
    _check(f"{name}, outside the convnet",
           *_errors(pair for _, pair in pick(rest, card, plain)),
           AGENT_BF16_TOL)
    # The stem's gradient from the card's own input and cotangent, by the
    # plain version: only the summation order and one bf16 rounding apart.
    x = (inputs(cpu)[1].observation.frame.reshape(T * B, 72, 96, 3)
         .bfloat16() / 255.0)
    g = records["card"].stem_g[0].permute(0, 2, 3, 1).cpu()
    from scalable_agent_tpu_torch.ops.conv_cuda import conv_gradw_plain
    stem = conv_gradw_plain(x, g, 3, 1).permute(3, 2, 0, 1)
    _check(f"{name}, the stem's weight gradient against the plain version "
           f"on the card's own cotangent",
           *_errors([(card[leaves.index("convnet.downscale_0.weight")],
                      stem)]), BF16_ROUNDING_TOL)
    net_err = worst(pick(convnet, card, plain))
    policy = worst(pick(range(len(leaves)), plain, f32))
    witness = worst(pick(range(len(leaves)), card, f32))
    flips = _flips(torch, records["card"], records["cpu"])
    policy_flips = _flips(torch, records["cpu"], records["f32"])
    print(f"  ({name}, the convnet: furthest leaf {net_err[1]} at "
          f"{net_err[0]:.3e}; the bf16 policy against float32 on the CPU "
          f"{policy[0]:.3e} ({policy[1]}), the card's bf16 against it "
          f"{witness[0]:.3e} ({witness[1]}); relu sign and max-pool argmax "
          f"flips, card against CPU: {flips}, bf16 against float32 on the "
          f"CPU: {policy_flips})", flush=True)
    _check(f"{name}, the convnet", *_errors(
        pair for _, pair in pick(convnet, card, plain)),
        DEEP_BF16_FRACTION * policy[0])
    if not witness[0] <= DEEP_BF16_WITNESS * policy[0]:
        raise AssertionError(
            f"{name}: the card's bf16 is {witness[0]:.3e} from float32, "
            f"more than {DEEP_BF16_WITNESS} x the CPU's bf16 "
            f"({policy[0]:.3e})")


def _recorder(torch):
    """A torch function mode that records, in call order, the input of
    every relu and max-pool and the cotangent at the ResNet stem's output
    (the first pad's input: the stem conv plus its bias, before the
    pool)."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class Record(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.relu, self.pool, self.stem_g = [], [], []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.relu:
                self.relu.append(args[0].detach().cpu())
            elif func is F.max_pool2d:
                self.pool.append(args[0].detach().cpu())
            elif (func is F.pad and not self.pool
                  and args[0].requires_grad):
                args[0].register_hook(self.stem_g.append)
            return func(*args, **kwargs)

    return Record()


def _flips(torch, a, b):
    """Where two recorded runs of one model part ways: relu inputs of
    opposite sign, and max-pool windows whose argmax differs (each taken
    on the CPU from the recorded inputs), as "n of total" counts."""
    import torch.nn.functional as F

    relu = sum(int(((p > 0) != (q > 0)).sum()) for p, q in zip(a.relu, b.relu))
    relu_all = sum(p.numel() for p in a.relu)
    index = lambda t: F.max_pool2d(t.float(), 3, 2, return_indices=True)[1]
    pool = sum(int((index(p) != index(q)).sum())
               for p, q in zip(a.pool, b.pool))
    pool_all = sum(index(p).numel() for p in a.pool)
    return f"relu {relu} of {relu_all}, max-pool {pool} of {pool_all}"


def upload_parts(torch, device, out, reps=UPLOAD_REPS):
    """One trajectory's upload under each transport, host clock around
    work that ends in a synchronize, the mean over ``reps`` after a
    warm-up: per_leaf whole; packed as pack (host), upload (the one copy)
    and unpack (views on the card).  Returns (per_leaf ms, (pack, upload,
    unpack) ms, upload GB/s, the per_leaf trajectory)."""
    from scalable_agent_tpu_torch.runtime.transport import (
        PackedTransport,
        PerLeafTransport,
        host_trajectory,
    )

    host = host_trajectory(out)
    per_leaf, packed = PerLeafTransport(device), PackedTransport(device)
    traj, _ = per_leaf.put(host)
    packed.put(host)  # the pinned staging buffers are made here
    torch.cuda.synchronize()
    per_leaf_s, parts = 0.0, [0.0, 0.0, 0.0]
    for _ in range(reps):
        t0 = time.monotonic()
        per_leaf.put(host)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        buf = packed.pack(host)
        t2 = time.monotonic()
        device_buf = packed.upload(buf)
        torch.cuda.synchronize()
        t3 = time.monotonic()
        packed.unpack(device_buf)
        torch.cuda.synchronize()
        t4 = time.monotonic()
        per_leaf_s += t1 - t0
        for i, dt in enumerate((t2 - t1, t3 - t2, t4 - t3)):
            parts[i] += dt
    parts_ms = tuple(1e3 * t / reps for t in parts)
    gbps = buf.numel() / (parts_ms[1] / 1e3) / 1e9
    return 1e3 * per_leaf_s / reps, parts_ms, gbps, traj


def breakdown(torch, driver, config):
    """Where one iteration of the main path spends its time: one actor
    unroll (its inference steps alone, then the rest: env steps and
    host packing), the trajectory's upload under each transport, and one
    learner update, with the update's device time by kernel from
    torch.profiler."""
    from scalable_agent_tpu_torch.models import actor_step, initial_state
    from scalable_agent_tpu_torch.runtime import VectorActor
    from scalable_agent_tpu_torch.runtime.actor import to_device, to_numpy
    from scalable_agent_tpu_torch.types import map_structure

    device = torch.device(config.device)
    obs_spec, action_space, _ = driver.probe_env(config)
    agent = driver.build_agent(config, obs_spec, action_space, device)
    learner = driver.build_learner(config, agent)
    groups = driver.make_env_groups(
        dataclasses.replace(config, num_actors=config.batch_size),
        obs_spec.frame)
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
        per_leaf_ms, (pack_ms, copy_ms, unpack_ms), gbps, traj = (
            upload_parts(torch, device, out))
        update_ms = _time_ms(torch, lambda: learner.update(traj), 3)
        # Kernels only: an operator's row repeats its kernels' time.
        device_us = {key: 1e3 * ms for key, ms in _kernel_ms(
            torch, lambda: learner.update(traj), 1).items() if ms > 0}
    finally:
        for envs in groups:
            envs.close()
    busy_ms = sum(device_us.values()) / 1e3
    print(f"  actor unroll ({config.unroll_length} steps x "
          f"{config.batch_size} envs): {unroll_s:.3f} s, of which "
          f"inference {infer_s:.3f} s (per step "
          f"{1e3 * infer_s / config.unroll_length:.3f} ms) and env steps "
          f"+ packing {unroll_s - infer_s:.3f} s", flush=True)
    print(f"  trajectory upload ({UPLOAD_REPS} reps): per_leaf "
          f"{per_leaf_ms:.3f} ms; packed {pack_ms + copy_ms + unpack_ms:.3f}"
          f" ms = pack {pack_ms:.3f} + upload {copy_ms:.3f} ({gbps:.2f} "
          f"GB/s) + unpack {unpack_ms:.3f}", flush=True)
    print(f"  learner update {update_ms:.2f} ms (CUDA events), device busy "
          f"{busy_ms:.2f} ms in the profiled update", flush=True)
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms  {name[:90]}", flush=True)
    for what, names in (
            ("residual LSTM forward", ("sgemm_kernel<true",
                                       "lstm_resid_kernel")),
            ("LSTM BPTT", (BPTT_CHAIN, BPTT_REDUCE) + BPTT_GEMMS),
            ("stem grad-W", GRADW_KERNELS + RESNET_KERNELS)):
        parts = [(_kernel_name(name), us / 1e3)
                 for name, us in device_us.items()
                 if any(n in name for n in names)]
        print(f"  {what} in the update: {sum(ms for _, ms in parts):.3f} ms "
              f"({', '.join(f'{n} {ms:.3f}' for n, ms in parts)})",
              flush=True)


def deep_path(torch, driver, config, scratch, train_counted, reset_counts,
              read_counts):
    """``--torso_type=resnet --use_instruction=true`` on the main path's
    configuration (``scan_impl`` at its default, as the command a user
    types): DEEP_UPDATES bf16 updates counted (the ResNet stem's bf16
    grad-W once an update, every LSTM kernel at D=330), the second
    update's s and ``ledger/mfu``; ``--mode=test`` on its checkpoint
    with the default architecture's flags (the checkpoint's wins); 2
    float32 updates counted; then the bf16 path's iteration taken apart
    (``breakdown``: the update's device ms by kernel).  Returns the bf16
    and float32 runs' launch counts and the (x, g) layouts (``tensor_layout``
    names) that the bf16 run's backward handed ``conv_gradw``."""
    from scalable_agent_tpu_torch.ops import conv_cuda

    deep = dataclasses.replace(
        config, torso_type="resnet", use_instruction=True, scan_impl="auto",
        trace=False, logdir=os.path.join(scratch, "deep"),
        total_environment_frames=float(
            DEEP_UPDATES * config.frames_per_update()))
    layouts = set()
    conv_gradw = conv_cuda.conv_gradw

    def recording(x, g, kernel_size, stride):
        layouts.add((conv_cuda.tensor_layout(x), conv_cuda.tensor_layout(g)))
        return conv_gradw(x, g, kernel_size, stride)

    with _patched(conv_cuda, conv_gradw=recording):
        launches = train_counted(deep, DEEP_UPDATES, "_bf16",
                                 "resnet_stem_gradw")
    print(f"  the deep path's backward handed conv_gradw (x, g) in the "
          f"layouts {sorted(layouts)} (tensor_layout: hwc contiguous NHWC, "
          f"chw an NHWC view of NCHW)", flush=True)
    _loop_rate(deep, "deep path", DEEP_UPDATES)
    registry = [r for r in _all_rows(deep.logdir) if _is_registry_row(r)]
    print(f"  deep path: ledger/mfu {registry[-1]['obs/ledger/mfu']:.6g}",
          flush=True)
    reset_counts()
    t0 = time.monotonic()
    returns = driver.test(dataclasses.replace(
        deep, mode="test", torso_type="shallow", use_instruction=False,
        test_num_episodes=8))[deep.level_name]
    test_launches = read_counts()
    print(f"  deep --mode=test: {len(returns)} returns in "
          f"{time.monotonic() - t0:.1f} s; launches {test_launches}",
          flush=True)
    if len(returns) != 8 or test_launches["lstm_fwd_lean_bf16"] == 0:
        raise AssertionError("the deep path's --mode=test did not run 8 "
                             "episodes through the bf16 lean LSTM kernel")
    f32 = dataclasses.replace(
        deep, logdir=os.path.join(scratch, "deep_f32"),
        compute_dtype="float32", total_environment_frames=float(
            F32_UPDATES * deep.frames_per_update()))
    f32_launches = train_counted(f32, F32_UPDATES, "", "resnet_stem_gradw")
    from scalable_agent_tpu_torch.ops import float32_precision

    with float32_precision():
        breakdown(torch, driver, deep)
    return launches, f32_launches, layouts


def _loop_rate(config, label, updates=UPDATES):
    """Print s per update over updates 3..``updates`` of a run logged every
    update, and its env frames/s (not gated).  A 2-update run has one
    interval, update 2's, and prints it as that, not as a loop rate."""
    rows = {r["step"]: r for r in _rows(config.logdir)}
    first = min(2, updates - 1)
    s_per_update = ((rows[updates]["time"] - rows[first]["time"])
                    / (updates - first))
    what = (f"updates {first + 1}..{updates}: {s_per_update:.4f} s per "
            f"update" if updates - first > 1 else
            f"update {updates}'s interval alone (one interval, not a loop "
            f"rate): {s_per_update:.4f} s")
    print(f"  {label}, {what} ({config.frames_per_update() / s_per_update:.0f}"
          f" env frames/s)", flush=True)


def composite_agent_on_one_trajectory(torch, driver, config, out):
    """The composite agent's logits, baseline, joint log-probs of the
    recorded actions, final carry and every parameter gradient on the card
    against the same weights on the CPU (plain versions), on one
    full-width trajectory of the pool, under each dtype policy (float32 at
    AGENT_TOL, bf16 at AGENT_BF16_TOL, as ``compare_agent``)."""
    import copy

    from scalable_agent_tpu_torch.ops import distributions
    from scalable_agent_tpu_torch.runtime.actor import to_device
    from scalable_agent_tpu_torch.runtime.transport import host_trajectory

    traj = host_trajectory(out)
    obs_spec, space, _ = driver.probe_env(config)

    def run(agent, device):
        t = to_device(traj, device)
        actions = t.agent_outputs.action
        (logits, baseline), state = agent(actions, t.env_outputs,
                                          t.agent_state)
        log_probs = distributions.log_prob(logits, actions, agent.dist_spec)
        loss = (logits.square().sum() + baseline.sum() + log_probs.sum()
                + state.c.sum() + state.h.square().sum())
        grads = torch.autograd.grad(loss, list(agent.parameters()))
        return [x.detach().float().cpu() for x in
                (logits, baseline, log_probs, state.c, state.h, *grads)]

    for compute_dtype, tol in (("float32", AGENT_TOL),
                               ("bfloat16", AGENT_BF16_TOL)):
        policy = dataclasses.replace(config, compute_dtype=compute_dtype)
        card = driver.build_agent(policy, obs_spec, space,
                                  torch.device(config.device))
        cpu = copy.deepcopy(card).cpu()
        _check(f"composite agent ({space}) logits, joint log-probs and "
               f"parameter gradients at {compute_dtype}, one trajectory "
               f"{list(out.agent_outputs.action.shape)}",
               *_errors(zip(run(card, torch.device(config.device)),
                            run(cpu, torch.device("cpu")))), tol)


def composite_path(torch, driver, CheckpointManager, config, scratch,
                   train_counted, reset_counts, read_counts):
    """Phase 3i: ``--level_name=fake_tuple`` (Tuple(Discrete(3),
    Discretized(5)), 16x16 frames, core input D=265) at the main path's
    layout, bf16, ``--scan_impl=pallas`` and ``--rmsprop_momentum=0.9``:
    UPDATES updates counted; the checkpoint holds the momentum trace and
    verifies; ``--mode=test``; a resume for 2 more updates that is
    frame-exact and restores the trace bit for bit; F32_UPDATES float32
    updates counted; every recorded action inside its component's range
    and the env's frames encoding the first component; the composite
    agent against the CPU on one trajectory."""
    import numpy as np

    from scalable_agent_tpu_torch.runtime import Learner

    tup = dataclasses.replace(
        config, level_name="fake_tuple", height=16, width=16,
        rmsprop_momentum=0.9, logdir=os.path.join(scratch, "tuple"))
    fpu = tup.frames_per_update()
    tup = dataclasses.replace(tup, total_environment_frames=float(
        UPDATES * fpu))
    train_counted(tup, UPDATES, "_bf16")
    _loop_rate(tup, "fake_tuple, bf16, rmsprop_momentum=0.9")
    ckpt = CheckpointManager(tup.logdir)
    step, saved = ckpt.restore()
    ok, why = ckpt.verify(step, saved)
    if step != UPDATES or not ok or sorted(saved.get("momentum", ())) != (
            sorted(saved["params"])):
        raise AssertionError(f"fake_tuple checkpoint step {step} verified "
                             f"{ok} ({why}), groups {sorted(saved)}")
    reset_counts()
    returns = driver.test(dataclasses.replace(
        tup, mode="test", test_num_episodes=8))["fake_tuple"]
    test_launches = read_counts()
    print(f"  fake_tuple --mode=test: {len(returns)} returns {returns}; "
          f"lean bf16 launches {test_launches['lstm_fwd_lean_bf16']}",
          flush=True)
    if len(returns) != 8 or test_launches["lstm_fwd_lean_bf16"] == 0:
        raise AssertionError("fake_tuple --mode=test did not run 8 "
                             "episodes through the bf16 lean LSTM kernel")

    restored = []
    load = Learner.load_state_dict

    def recording(self, state):
        load(self, state)
        restored.append({k: v.detach().cpu().clone()
                         for k, v in self.state.momentum.items()})

    resumed = dataclasses.replace(
        tup, total_environment_frames=float((UPDATES + 2) * fpu))
    reset_counts()
    with _patched(Learner, load_state_dict=recording):
        metrics = driver.train(resumed)
    resume_launches = read_counts()
    step, again = ckpt.restore()
    if (metrics["env_frames"] != (UPDATES + 2) * fpu or step != UPDATES + 2
            or again["env_frames"] != (UPDATES + 2) * fpu
            or resume_launches["lstm_fwd_resid_bf16"] != 2):
        raise AssertionError(
            f"the fake_tuple resume is not frame-exact: env_frames "
            f"{metrics['env_frames']}, checkpoint step {step} at "
            f"{again['env_frames']}, launches {resume_launches}")
    if len(restored) != 1 or not all(
            torch.equal(restored[0][k], v)
            for k, v in saved["momentum"].items()):
        raise AssertionError("the restored momentum trace is not the saved "
                             "one bit for bit")
    print(f"  fake_tuple resume: 2 more updates, env_frames "
          f"{metrics['env_frames']:.0f} = {UPDATES + 2} x {fpu}, checkpoint "
          f"step {step}; the restored momentum trace ({len(restored[0])} "
          f"tensors) equals the saved one bit for bit", flush=True)
    f32 = dataclasses.replace(
        tup, logdir=os.path.join(scratch, "tuple_f32"),
        compute_dtype="float32",
        total_environment_frames=float(F32_UPDATES * fpu))
    train_counted(f32, F32_UPDATES, "")

    out = pool_trajectories(torch, driver, tup, 1)[0]
    action = out.agent_outputs.action
    if action.shape != (tup.unroll_length + 1, tup.batch_size, 2):
        raise AssertionError(f"fake_tuple actions of shape {action.shape}")
    for i, n in enumerate((3, 5)):
        if not (0 <= action[..., i].min() and action[..., i].max() < n):
            raise AssertionError(f"fake_tuple action component {i} leaves "
                                 f"[0, {n}): {action[..., i].min()}.."
                                 f"{action[..., i].max()}")
    live = ~out.env_outputs.done[1:]
    frames = out.env_outputs.observation.frame[1:, :, 0, 2, 0]
    if not (frames[live] == action[1:, :, 0][live]).all():
        raise AssertionError("fake_tuple frames do not encode the agent's "
                             "first action component")
    counts = [np.bincount(action[..., i].ravel(), minlength=n).tolist()
              for i, n in enumerate((3, 5))]
    print(f"  fake_tuple trajectory: actions {list(action.shape)}, every "
          f"component in range (counts {counts}), the env's frames encode "
          f"component 0", flush=True)
    composite_agent_on_one_trajectory(torch, driver, tup, out)


def benchmark_path(torch, driver, config, scratch, train_counted, pool_s):
    """Phase 3j: ``--benchmark_mode=true`` on the main path (bf16, UPDATES
    updates counted): s per update and env frames/s beside 3b's pool
    loop (not gated); then one pool trajectory whose env outputs, frames
    included, equal bit for bit those of host streams seeded as the
    driver seeds group 0's envs, stepped with zero actions (the envs took
    their BenchmarkStream's own draws), while the agent's recorded
    actions differ from the env's."""
    import numpy as np

    from scalable_agent_tpu_torch.envs import make_impala_stream

    bench = dataclasses.replace(
        config, benchmark_mode=True, logdir=os.path.join(scratch, "bench"),
        total_environment_frames=float(UPDATES * config.frames_per_update()))
    train_counted(bench, UPDATES, "_bf16")
    _loop_rate(bench, "--benchmark_mode=true")
    print(f"  beside phase 3b's pool loop at the same layout: "
          f"{pool_s:.4f} s per update "
          f"({config.frames_per_update() / pool_s:.0f} env frames/s)",
          flush=True)
    out = pool_trajectories(torch, driver, bench, 1)[0]
    env = out.env_outputs
    differ = 0
    for i in range(bench.batch_size):
        stream = make_impala_stream(
            bench.level_name, seed=bench.seed * 100000 + i,
            benchmark_mode=True, num_action_repeats=bench.num_action_repeats,
            **driver.env_kwargs(bench))
        host = [stream.initial()] + [stream.step(0) for _ in range(
            bench.unroll_length)]
        for t, want in enumerate(host):
            if not (np.array_equal(env.observation.frame[t, i],
                                   want.observation.frame)
                    and env.reward[t, i] == want.reward
                    and env.done[t, i] == want.done):
                raise AssertionError(
                    f"benchmark_mode: env {i} step {t} differs from a host "
                    f"BenchmarkStream seeded the same way")
        live = ~env.done[1:, i]
        differ += int((env.observation.frame[1:, i, 0, 2, 0][live]
                       != out.agent_outputs.action[1:, i][live]).sum())
    if differ == 0:
        raise AssertionError("benchmark_mode: the env's actions are the "
                             "agent's")
    print(f"  benchmark_mode: {bench.batch_size} envs x "
          f"{bench.unroll_length} steps equal host BenchmarkStreams seeded "
          f"the same way bit for bit; the env's action differs from the "
          f"agent's at {differ} of them", flush=True)


# The launch counters of the kernels each library route replaces.
LSTM_COUNTERS = tuple(f"lstm_{part}{suffix}" for part in (
    "fwd_lean", "fwd_lean_unroll", "fwd_resid", "bptt")
    for suffix in ("", "_bf16"))
# The stems' grad-W launch counters without their dtype suffix.
STEMS = ("stem_gradw", "stem_gradw_c4", "stem_gradw_c1",
         "resnet_stem_gradw", "resnet_stem_gradw_c4")
GRADW_COUNTERS = tuple(f"{stem}{suffix}" for stem in STEMS
                       for suffix in ("", "_bf16"))
ROUTE_UPDATES = 2            # phase 3k's runs, 3l's doom_benchmark and
                             # doom_duel runs
DEEP_UPDATES = 2             # phase 3h's bf16 run
DUEL_BATCH = 32              # 16 matches x 2 agents a group


def _expect_launches(label, launches, expected):
    """Fail unless every counter of ``expected`` reads its count (a
    ``(least, None)`` pair: at least that many)."""
    for name, want in expected.items():
        least = want[0] if isinstance(want, tuple) else want
        ok = (launches[name] >= least if isinstance(want, tuple)
              else launches[name] == want)
        if not ok:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times on the path, "
                                 f"expected {want}")


def route_tables(torch, driver, arms, out, rounds=2):
    """The update alone on one trajectory (``out``, a numpy ActorOutput)
    for each ``(label, config)`` arm, in turns (A, B, ..., B, A): ms per
    update from CUDA events (mean of its turns), and the device ms by
    kernel of one profiled update; the tables printed side by side, top
    rows first.  Returns {label: (update ms, {kernel: device ms})}."""
    from scalable_agent_tpu_torch.runtime.actor import to_device
    from scalable_agent_tpu_torch.runtime.transport import host_trajectory

    device = torch.device(arms[0][1].device)
    traj = to_device(host_trajectory(out), device)
    obs_spec, space, _ = driver.probe_env(arms[0][1])
    learners = {}
    for label, config in arms:
        agent = driver.build_agent(config, obs_spec, space, device)
        learners[label] = driver.build_learner(config, agent)
    order = [label for label, _ in arms]
    order = (order + order[::-1]) * (rounds // 2)
    times = {label: [] for label in learners}
    for label in order:
        learner = learners[label]
        times[label].append(_time_ms(torch, lambda: learner.update(traj), 3))
    result = {}
    for label, learner in learners.items():
        table = {_kernel_name(k): v for k, v in _kernel_ms(
            torch, lambda: learner.update(traj), 1).items() if v > 0}
        result[label] = (sum(times[label]) / len(times[label]), table)
    for label, (ms, table) in result.items():
        print(f"  {label}: update {ms:.2f} ms (CUDA events, turns "
              f"{', '.join(f'{t:.2f}' for t in times[label])}), device "
              f"busy {sum(table.values()):.2f} ms; by kernel:", flush=True)
        for name, t in sorted(table.items(), key=lambda kv: -kv[1])[:10]:
            print(f"    {t:9.3f} ms  {name[:90]}", flush=True)
    return result


def library_routes(torch, driver, config, scratch, train_counted):
    """Phase 3k: the library routes.  ``--core_impl=xla`` and
    ``--conv_backend=xla`` each on the main path's configuration for
    ROUTE_UPDATES bf16 updates: no launch of a kernel the route replaces (the
    LSTM counters at 0 under the xla core, the actors' steps included; the
    grad-W counters at 0 under the xla stem), the other kernels as in
    phase 3 (``train_counted``); s per update; then the update alone on
    one main-path trajectory for the kernels arm and both library arms in
    turns, with
    each arm's kernel table, where no replaced kernel may appear.  Then
    ``fake_tuple`` with ``--conv_backend=xla`` for ROUTE_UPDATES bf16
    updates counted the same way, and its update alone against the
    kernels' on one ``fake_tuple`` trajectory of the pool: what
    cuDNN's faster bf16 wgrad at 16x16 frames is worth in a whole
    update."""
    fpu = config.frames_per_update()
    main = dataclasses.replace(config, trace=False, total_environment_frames=
                               float(ROUTE_UPDATES * fpu))
    core = dataclasses.replace(main, core_impl="xla",
                               logdir=os.path.join(scratch, "core_xla"))
    conv = dataclasses.replace(main, conv_backend="xla",
                               logdir=os.path.join(scratch, "conv_xla"))
    common = {"vtrace_fused": ROUTE_UPDATES, "stem_gradw": 0,
              "resnet_stem_gradw": 0, "resnet_stem_gradw_bf16": 0}
    train_counted(core, ROUTE_UPDATES, "_bf16", expected=dict(
        common, stem_gradw_bf16=ROUTE_UPDATES,
        **{c: 0 for c in LSTM_COUNTERS}))
    _loop_rate(core, "--core_impl=xla, bf16", ROUTE_UPDATES)
    train_counted(conv, ROUTE_UPDATES, "_bf16", expected=dict(
        common, lstm_fwd_lean=0, lstm_fwd_resid=0, lstm_bptt=0,
        lstm_fwd_lean_bf16=(ROUTE_UPDATES * config.unroll_length, None),
        lstm_fwd_resid_bf16=ROUTE_UPDATES, lstm_bptt_bf16=ROUTE_UPDATES,
        **{c: 0 for c in GRADW_COUNTERS}))
    _loop_rate(conv, "--conv_backend=xla, bf16", ROUTE_UPDATES)
    out = pool_trajectories(torch, driver, main, 1)[0]
    tables = route_tables(torch, driver, [
        ("kernels (auto)", main), ("--core_impl=xla", core),
        ("--conv_backend=xla", conv)], out)
    from scalable_agent_tpu_torch.obs.kernels import LIBRARY_ROUTES

    for label, route in (("--core_impl=xla", "core_impl"),
                         ("--conv_backend=xla", "conv_backend")):
        bad = [k for k in tables[label][1]
               if k.startswith(LIBRARY_ROUTES[route])]
        if bad:
            raise AssertionError(f"{label} launched {bad} in the update")

    tup = dataclasses.replace(
        main, level_name="fake_tuple", height=16, width=16,
        conv_backend="xla", logdir=os.path.join(scratch, "tuple_conv_xla"),
        total_environment_frames=float(ROUTE_UPDATES * fpu))
    train_counted(tup, ROUTE_UPDATES, "_bf16", expected=dict(
        common, lstm_fwd_lean=0,
        lstm_fwd_resid=0, lstm_bptt=0,
        lstm_fwd_lean_bf16=(ROUTE_UPDATES * config.unroll_length, None),
        lstm_fwd_resid_bf16=ROUTE_UPDATES, lstm_bptt_bf16=ROUTE_UPDATES,
        **{c: 0 for c in GRADW_COUNTERS}))
    kernels = dataclasses.replace(tup, conv_backend="auto")
    tables = route_tables(torch, driver, [
        ("fake_tuple, kernels", kernels),
        ("fake_tuple, --conv_backend=xla", tup)],
        pool_trajectories(torch, driver, kernels, 1)[0])
    (kern_ms, kern), (xla_ms, xla) = tables.values()
    busy = [sum(table.values()) for table in (kern, xla)]
    print(f"  fake_tuple's update alone: the stem grad-W kernel "
          f"{kern_ms:.2f} ms, cuDNN's wgrad {xla_ms:.2f} ms "
          f"({xla_ms - kern_ms:+.2f} ms); device busy {busy[0]:.3f} against "
          f"{busy[1]:.3f} ms ({busy[1] - busy[0]:+.3f} ms)", flush=True)


def doom_scenarios(root, scratch):
    """The fake VizDoom (``tests/fakes/vizdoom.py``) on ``sys.path`` and
    generated scenario ``.cfg`` files under ``$DOOM_SCENARIOS_DIR``, as
    ``tests/test_doom.py``'s fixture sets them up (the env worker
    processes inherit both).  No simulator, ``.wad`` or scenario asset
    is used."""
    scenarios = os.path.join(scratch, "doom_scenarios")
    os.makedirs(scenarios, exist_ok=True)
    single = ("HEALTH ARMOR SELECTED_WEAPON SELECTED_WEAPON_AMMO "
              "FRAGCOUNT DEATHCOUNT HITCOUNT DAMAGECOUNT DEAD "
              "POSITION_X POSITION_Y")
    multi = (single + " PLAYER_NUM PLAYER_COUNT PLAYER1_FRAGCOUNT "
             "PLAYER2_FRAGCOUNT")
    for name, variables in (("battle.cfg", single), ("ssl2.cfg", multi)):
        with open(os.path.join(scenarios, name), "w") as f:
            f.write(f"doom_scenario_path = {name.replace('.cfg', '.wad')}\n"
                    f"available_game_variables = {{ {variables} }}\n")
    fakes = os.path.join(root, "tests", "fakes")
    if fakes not in sys.path:
        sys.path.insert(0, fakes)
    os.environ["DOOM_SCENARIOS_DIR"] = scenarios
    import vizdoom

    if os.path.dirname(os.path.abspath(vizdoom.__file__)) != fakes:
        raise AssertionError(f"vizdoom imports from {vizdoom.__file__}, "
                             f"not the fake")


def doom_path(torch, driver, config, scratch, root, train_counted,
              reset_counts, read_counts):
    """Phase 3l: the ``doom_`` family under the fake VizDoom
    (``doom_scenarios``): it measures the fake simulator's step cost, not
    VizDoom's.  ``doom_benchmark`` (Discrete(9), D=266) at the main path's
    layout and Doom's 72x128 frames (the family's defaults), bf16,
    ``--scan_impl=pallas``, ROUTE_UPDATES updates counted as in phase 3,
    with s per update and env frames/s; then ``doom_duel`` (two agents a match,
    the full discretized space with use: 41 logits, D=298, 23
    measurements) at batch DUEL_BATCH (16 matches x 2 agents a group, 2
    groups), ROUTE_UPDATES bf16 updates counted, the second's s; ``--mode=test
    --record_to`` on its checkpoint, which must write
    ``match_*/player_*/episode_*`` files (frames and episode.json) for
    every match and both players.  Returns the duel run's launches."""
    from scalable_agent_tpu_torch.envs.wrappers import resize_backend

    doom_scenarios(root, scratch)
    print(f"  frames resized by {resize_backend()} (envs/wrappers.py "
          f"_resize_frame: cv2 INTER_AREA where cv2 imports, else the "
          f"nearest-neighbour numpy path)", flush=True)
    bench = dataclasses.replace(
        config, level_name="doom_benchmark", trace=False,
        logdir=os.path.join(scratch, "doom_benchmark"))
    frame = driver.probe_env(driver.apply_env_overrides(bench))[0].frame
    if tuple(frame.shape) != (72, 128, 3):
        raise AssertionError(f"doom_benchmark frames {frame.shape}")
    bench = dataclasses.replace(bench, total_environment_frames=float(
        ROUTE_UPDATES * bench.frames_per_update()))
    train_counted(bench, ROUTE_UPDATES, "_bf16")
    _loop_rate(bench, "doom_benchmark (fake VizDoom), bf16, 72x128",
               ROUTE_UPDATES)

    duel = dataclasses.replace(
        config, level_name="doom_duel", trace=False, batch_size=DUEL_BATCH,
        num_actors=2 * DUEL_BATCH, logdir=os.path.join(scratch, "doom_duel"))
    duel = dataclasses.replace(duel, total_environment_frames=float(
        ROUTE_UPDATES * duel.frames_per_update()))
    launches = train_counted(duel, ROUTE_UPDATES, "_bf16")
    _loop_rate(duel, "doom_duel (fake VizDoom), bf16, 32 agent slots a "
               "group", ROUTE_UPDATES)
    record = os.path.join(scratch, "doom_records")
    reset_counts()
    t0 = time.monotonic()
    returns = driver.test(dataclasses.replace(
        duel, mode="test", test_num_episodes=8, test_batch_size=8,
        record_to=record))["doom_duel"]
    test_launches = read_counts()
    matches = sorted(os.listdir(os.path.join(record, "doom_duel")))
    files = 0
    for match in matches:
        players = sorted(os.listdir(os.path.join(record, "doom_duel",
                                                 match)))
        if players != ["player_00", "player_01"]:
            raise AssertionError(f"{match} recorded players {players}")
        for player in players:
            where = os.path.join(record, "doom_duel", match, player)
            episodes = [e for e in sorted(os.listdir(where))
                        if e.startswith("episode_")]
            for episode in episodes:
                for name in ("frames.npy", "episode.json"):
                    if not os.path.isfile(os.path.join(where, episode,
                                                       name)):
                        raise AssertionError(f"{where}/{episode} lacks "
                                             f"{name}")
                files += 2
            if not episodes:
                raise AssertionError(f"no episode recorded in {where}")
    print(f"  doom_duel --mode=test --record_to: {len(returns)} returns "
          f"{returns} in {time.monotonic() - t0:.1f} s; {len(matches)} "
          f"matches x 2 players, {files} episode files; lean bf16 launches "
          f"{test_launches['lstm_fwd_lean_bf16']}", flush=True)
    if (len(returns) != 8 or matches != [f"match_{m:02d}" for m in range(4)]
            or test_launches["lstm_fwd_lean_bf16"] == 0):
        raise AssertionError("doom_duel --mode=test did not run 8 episodes "
                             "over 4 recorded matches through the bf16 "
                             "lean LSTM kernel")
    return launches


DMLAB_UPDATES = 2           # phase 3m's dmlab30 run
ATARI_UPDATES = 2           # phase 3n's atari_breakout run (bf16)
NEW_PATH_UPDATES = 2        # phase 3n's one-channel gym and deep Atari
                            # runs (bf16; and F32_UPDATES float32)
# A stand-in for the gymnasium package, which the card's machine lacks: a
# NoFrameskip ALE game (210x160x3 uint8 frames, Breakout's 4 actions), the
# same game observed as one luminance channel (210x160x1) and a
# vector-observation game whose render() gives RGB frames, behind
# gymnasium.make; with spaces.Box, spaces.Discrete and error.Error, the
# part of gymnasium the port's atari_ and gym_ families use.  Its steps
# cost what drawing a frame costs, not what ALE's emulation costs.
GYMNASIUM_STANDIN = '''"""A stand-in for gymnasium, written by chip_smoke.py.

BreakoutNoFrameskip-v4: 210x160x3 uint8 frames of a paddle and a ball, 4
actions (NOOP, FIRE, RIGHT, LEFT), a reward when the ball reaches the
paddle's row over the paddle, an episode of 400 raw frames.
BreakoutGray-v0: the same game observed as one luminance channel,
210x160x1 uint8 frames.
CartPole-v1: a 4-float state, 2 actions, render() of a 400x600x3 frame
with the cart, an episode of at most 60 steps.
"""
import types

import numpy as np


class Error(Exception):
    pass


error = types.SimpleNamespace(Error=Error)


class Box:
    def __init__(self, low, high, shape, dtype):
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)


class Discrete:
    def __init__(self, n):
        self.n = int(n)


spaces = types.SimpleNamespace(Box=Box, Discrete=Discrete)


class Breakout:
    FRAMES = 400

    def __init__(self):
        self.observation_space = Box(0, 255, (210, 160, 3), np.uint8)
        self.action_space = Discrete(4)
        self._rng = np.random.default_rng(0)
        self._reset_state()

    def _reset_state(self):
        self._t = 0
        self._paddle = int(self._rng.integers(8, 144))
        self._ball = [int(self._rng.integers(40, 120)), 30, 3, 2]

    def _frame(self):
        frame = np.zeros((210, 160, 3), np.uint8)
        frame[:8] = 142
        frame[190:194, self._paddle:self._paddle + 16] = (200, 72, 72)
        x, y = self._ball[:2]
        frame[y:y + 4, x:x + 2] = 236
        return frame

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_state()
        return self._frame(), {}

    def step(self, action):
        self._t += 1
        move = {2: 4, 3: -4}.get(int(action), 0)
        self._paddle = min(144, max(0, self._paddle + move))
        x, y, dx, dy = self._ball
        x, y = x + dx, y + dy
        if not 0 <= x <= 158:
            dx, x = -dx, min(158, max(0, x))
        reward = 0.0
        if y >= 186:
            reward = float(self._paddle <= x < self._paddle + 16)
            dy, y = -dy, 186
        elif y <= 8:
            dy, y = -dy, 8
        self._ball = [x, y, dx, dy]
        return (self._frame(), reward, self._t >= self.FRAMES, False,
                {"lives": 5})

    def render(self):
        return self._frame()

    def close(self):
        pass


class BreakoutGray(Breakout):
    def __init__(self):
        super().__init__()
        self.observation_space = Box(0, 255, (210, 160, 1), np.uint8)

    def _frame(self):
        rgb = super()._frame().astype(np.uint16)
        gray = (77 * rgb[..., 0] + 150 * rgb[..., 1] + 29 * rgb[..., 2]) >> 8
        return gray.astype(np.uint8)[..., None]


class CartPole:
    STEPS = 60

    def __init__(self):
        self.observation_space = Box(-np.inf, np.inf, (4,), np.float32)
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(4)
        self._t = 0

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        self._t += 1
        x, v, a, w = self._state
        force = 10.0 if int(action) == 1 else -10.0
        w = w + 0.02 * (9.8 * np.sin(a) - 0.1 * force * np.cos(a))
        v = v + 0.02 * force / 1.1
        self._state = np.array([x + 0.02 * v, v, a + 0.02 * w, w])
        terminated = bool(abs(self._state[0]) > 2.4
                          or abs(self._state[2]) > 0.21
                          or self._t >= self.STEPS)
        return self._state.astype(np.float32), 1.0, terminated, False, {}

    def render(self):
        frame = np.full((400, 600, 3), 255, np.uint8)
        cart = min(575, max(25, int(300 + 100 * self._state[0])))
        frame[300:330, cart - 25:cart + 25] = 0
        tip = min(599, max(0, int(cart + 100 * np.sin(self._state[2]))))
        lo, hi = sorted((cart, tip))
        frame[200:300, lo:hi + 4] = (202, 152, 101)
        return frame

    def close(self):
        pass


_GAMES = {"BreakoutNoFrameskip-v4": Breakout,
          "BreakoutGray-v0": BreakoutGray, "CartPole-v1": CartPole}


def make(env_id, **kwargs):
    if env_id not in _GAMES:
        raise Error(f"no stand-in for {env_id!r}")
    return _GAMES[env_id]()
'''


def write_gymnasium_standin(scratch):
    """Write ``GYMNASIUM_STANDIN`` as ``<scratch>/gym_standin/gymnasium.py``;
    returns the directory."""
    where = os.path.join(scratch, "gym_standin")
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, "gymnasium.py"), "w") as f:
        f.write(GYMNASIUM_STANDIN)
    return where


def gymnasium_standin(scratch):
    """``write_gymnasium_standin`` and its directory first on ``sys.path``
    (the env worker processes, started by spawn, inherit it); fail unless
    ``gymnasium`` then imports from there."""
    where = write_gymnasium_standin(scratch)
    if where not in sys.path:
        sys.path.insert(0, where)
    sys.modules.pop("gymnasium", None)
    import gymnasium

    if os.path.dirname(os.path.abspath(gymnasium.__file__)) != where:
        raise AssertionError(f"gymnasium imports from {gymnasium.__file__}, "
                             f"not the stand-in")
    return where


def dmlab_path(driver, config, scratch, root, train_counted, reset_counts,
               read_counts):
    """Phase 3m: the ``dmlab_`` family under the fake DeepMind Lab of
    ``tests/fakes/deepmind_lab.py`` (its step cost, not DMLab's):
    ``--level_name=dmlab30`` multi-task training at the main path's layout
    (64 actors over the 30 train levels, slot e on level e mod 30; the
    instruction stream on, so the core's D=330), bf16,
    ``--scan_impl=pallas``, DMLAB_UPDATES updates counted as in phase 3,
    the ``dmlab30/training_*`` scores in the metrics rows and every train
    level's ``<level>/episode_return`` among them; s per update; then
    ``--mode=test --level_name=dmlab30 --test_num_episodes=1`` on its
    checkpoint: one return for each of the 30 test levels through the bf16
    lean LSTM kernel, and ``eval_scores.json`` with the 30 levels and
    finite scores."""
    fakes = os.path.join(root, "tests", "fakes")
    if fakes not in sys.path:
        sys.path.insert(0, fakes)
    import deepmind_lab

    if os.path.dirname(os.path.abspath(deepmind_lab.__file__)) != fakes:
        raise AssertionError(f"deepmind_lab imports from "
                             f"{deepmind_lab.__file__}, not the fake")
    from scalable_agent_tpu_torch.envs import dmlab30

    suite = dataclasses.replace(
        config, level_name="dmlab30", trace=False,
        logdir=os.path.join(scratch, "dmlab30"),
        total_environment_frames=float(DMLAB_UPDATES
                                       * config.frames_per_update()))
    launches = train_counted(suite, DMLAB_UPDATES, "_bf16")
    _loop_rate(suite, f"dmlab30 (fake DMLab), bf16, {suite.num_actors} "
               f"actors over 30 levels", DMLAB_UPDATES)
    rows = _rows(suite.logdir)
    levels = {k.split("/")[0] for r in rows for k in r
              if k.endswith("/episode_return")}
    want = {f"dmlab_{name}" for name in dmlab30.TRAIN_LEVELS}
    keys = ("dmlab30/training_no_cap", "dmlab30/training_cap_100")
    scored = [r for r in rows if all(k in r for k in keys)]
    print(f"  dmlab30: {len(levels & want)} of 30 train levels reported "
          f"returns over {len(rows)} rows; training scores in "
          f"{len(scored)} rows, the last "
          f"{[scored[-1][k] for k in keys] if scored else None}",
          flush=True)
    if levels != want or not scored or not all(
            math.isfinite(r[k]) for r in scored for k in keys):
        raise AssertionError("dmlab30 training did not report every train "
                             "level and finite training scores")
    reset_counts()
    t0 = time.monotonic()
    returns = driver.test(dataclasses.replace(
        suite, mode="test", test_num_episodes=1))
    test_launches = read_counts()
    with open(os.path.join(suite.logdir, "eval_scores.json")) as f:
        scores = json.load(f)
    print(f"  dmlab30 --mode=test: {len(returns)} levels in "
          f"{time.monotonic() - t0:.1f} s; human-normalized no_cap "
          f"{scores['human_normalized_no_cap']:.4f} cap_100 "
          f"{scores['human_normalized_cap_100']:.4f}; lean bf16 launches "
          f"{test_launches['lstm_fwd_lean_bf16']}", flush=True)
    if (sorted(returns) != sorted(f"dmlab_{n}" for n in dmlab30.TEST_LEVELS)
            or any(len(r) != 1 for r in returns.values())
            or len(scores["mean_returns"]) != 30
            or scores["episodes_per_level"] != 1
            or not all(math.isfinite(scores[k]) for k in (
                "human_normalized_no_cap", "human_normalized_cap_100"))
            or test_launches["lstm_fwd_lean_bf16"] == 0):
        raise AssertionError("dmlab30 --mode=test did not evaluate the 30 "
                             "test levels into eval_scores.json through "
                             "the bf16 lean LSTM kernel")
    return launches


def atari_gym_path(driver, config, scratch, train_counted):
    """Phase 3n: the ``atari_`` and ``gym_`` families under the stand-in
    ``gymnasium`` (``gymnasium_standin``: the stand-in's step cost, not
    ALE's).  ``atari_breakout`` at the main path's layout and the family's
    [84, 84, 4] grayscale stack (4 actions, D=261), bf16,
    ``--scan_impl=pallas``, ATARI_UPDATES updates counted as in phase 3
    but with the stem grad-W's C=4 bf16 kernel once an update and no C=3
    grad-W, s per update; F32_UPDATES float32 updates counted the same way
    for the float32 C=4 kernel; then ``gym_CartPole-v1`` (rendered 72x96
    RGB frames, 2 actions, D=259) for ROUTE_UPDATES bf16 updates counted
    as in phase 3.  Returns the Atari runs' launches (bf16, float32)."""
    where = gymnasium_standin(scratch)
    print(f"  gymnasium: the stand-in at {where}", flush=True)
    atari = dataclasses.replace(
        config, level_name="atari_breakout", trace=False,
        logdir=os.path.join(scratch, "atari"))
    frame = driver.probe_env(driver.apply_env_overrides(atari))[0].frame
    if tuple(frame.shape) != (84, 84, 4):
        raise AssertionError(f"atari_breakout frames {frame.shape}")
    atari = dataclasses.replace(atari, total_environment_frames=float(
        ATARI_UPDATES * atari.frames_per_update()))

    def expected(updates, suffix):
        other = "" if suffix else "_bf16"
        counts = {c: 0 for c in GRADW_COUNTERS}
        counts.update({f"lstm_{part}{other}": 0
                       for part in ("fwd_lean", "fwd_resid", "bptt")})
        counts.update({
            "lstm_fwd_lean" + suffix: (updates * config.unroll_length,
                                       None),
            "lstm_fwd_resid" + suffix: updates,
            "lstm_bptt" + suffix: updates, "vtrace_fused": updates,
            "stem_gradw_c4" + suffix: updates, "stem_gradw_c4" + other: 0})
        return counts

    launches = train_counted(atari, ATARI_UPDATES, "_bf16",
                             expected=expected(ATARI_UPDATES, "_bf16"))
    _loop_rate(atari, "atari_breakout (stand-in ALE), bf16, 84x84x4",
               ATARI_UPDATES)
    f32 = dataclasses.replace(
        atari, compute_dtype="float32",
        logdir=os.path.join(scratch, "atari_f32"),
        total_environment_frames=float(F32_UPDATES
                                       * atari.frames_per_update()))
    f32_launches = train_counted(f32, F32_UPDATES, "",
                                 expected=expected(F32_UPDATES, ""))

    gym = dataclasses.replace(
        config, level_name="gym_CartPole-v1", trace=False,
        logdir=os.path.join(scratch, "gym"),
        total_environment_frames=float(ROUTE_UPDATES
                                       * config.frames_per_update()))
    frame = driver.probe_env(driver.apply_env_overrides(gym))[0].frame
    if tuple(frame.shape) != (72, 96, 3):
        raise AssertionError(f"gym_CartPole-v1 frames {frame.shape}")
    train_counted(gym, ROUTE_UPDATES, "_bf16")
    _loop_rate(gym, "gym_CartPole-v1 (stand-in), bf16, 72x96",
               ROUTE_UPDATES)
    return launches, f32_launches


def one_channel_and_deep_atari_paths(driver, config, scratch, train_counted,
                                     reset_counts, read_counts):
    """Phase 3n, the last two grad-W geometries: ``gym_BreakoutGray-v0``
    (the stand-in's one-channel Breakout resized to the main path's 72x96:
    [72, 96, 1] frames through the shallow stem, the C=1 kernels) and
    ``--torso_type=resnet --level_name=atari_breakout`` (the ResNet stem on
    Atari's [84, 84, 4]: the ResNet C=4 kernels), each NEW_PATH_UPDATES
    bf16 and F32_UPDATES float32 updates counted as in phase 3 (its stem's
    kernel once an update, every other stem's never), at the main path's
    layout, with s per update; then ``--mode=test`` on the deep Atari run's
    checkpoint through the bf16 lean LSTM kernel.  Returns the launches
    by run."""
    launches = {}
    for label, fields, frame, stem in (
            ("gym_BreakoutGray-v0", dict(level_name="gym_BreakoutGray-v0"),
             (72, 96, 1), "stem_gradw_c1"),
            ("atari_breakout resnet", dict(level_name="atari_breakout",
                                           torso_type="resnet"),
             (84, 84, 4), "resnet_stem_gradw_c4")):
        run = dataclasses.replace(config, trace=False, logdir=os.path.join(
            scratch, label.replace(" ", "_")), **fields)
        got = tuple(driver.probe_env(
            driver.apply_env_overrides(run))[0].frame.shape)
        if got != frame:
            raise AssertionError(f"{label} frames {got}, expected {frame}")
        run = dataclasses.replace(run, total_environment_frames=float(
            NEW_PATH_UPDATES * run.frames_per_update()))
        launches[label] = train_counted(run, NEW_PATH_UPDATES, "_bf16",
                                        stem=stem)
        _loop_rate(run, f"{label} (stand-in), bf16, {frame}",
                   NEW_PATH_UPDATES)
        f32 = dataclasses.replace(
            run, compute_dtype="float32", logdir=run.logdir + "_f32",
            total_environment_frames=float(F32_UPDATES
                                           * run.frames_per_update()))
        launches[label + " float32"] = train_counted(f32, F32_UPDATES, "",
                                                     stem=stem)
    reset_counts()
    t0 = time.monotonic()
    returns = driver.test(dataclasses.replace(
        run, mode="test", test_num_episodes=2))["atari_breakout"]
    test_launches = read_counts()
    print(f"  atari_breakout resnet --mode=test: {len(returns)} returns "
          f"{returns} in {time.monotonic() - t0:.1f} s; launches "
          f"{test_launches}", flush=True)
    if (len(returns) != 2 or test_launches["lstm_fwd_lean_bf16"] == 0
            or any(test_launches[c] for c in GRADW_COUNTERS)):
        raise AssertionError("the deep atari_breakout --mode=test did not "
                             "run 2 episodes through the bf16 lean LSTM "
                             "kernel alone")
    return launches


OFF_POLICY_FRESH = 3         # phase 3o's fresh updates (and replayed ones)
OFF_POLICY_CAPACITY = 64     # its slab, the JAX default --replay_capacity


def _host_trajectory(config, num_actions, seed):
    """A full-width host trajectory (numpy, the pool's dtypes) made from
    ``seed``: the packed transport's and the learner's input at the main
    path's shapes, without a pool."""
    import numpy as np

    from scalable_agent_tpu_torch.runtime.learner import Trajectory
    from scalable_agent_tpu_torch.types import (
        AgentOutput,
        AgentState,
        Observation,
        StepOutput,
        StepOutputInfo,
    )

    rng = np.random.default_rng(seed)
    t1, b = config.unroll_length + 1, config.batch_size
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return Trajectory(
        agent_state=AgentState(c=f32(b, 256), h=np.tanh(f32(b, 256))),
        env_outputs=StepOutput(
            reward=f32(t1, b),
            info=StepOutputInfo(
                episode_return=f32(t1, b),
                episode_step=rng.integers(0, 99, (t1, b)).astype(np.int32)),
            done=rng.random((t1, b)) < 0.02,
            observation=Observation(
                frame=rng.integers(0, 256, (t1, b, config.height,
                                            config.width, 3), dtype=np.uint8),
                instruction=None)),
        agent_outputs=AgentOutput(
            action=rng.integers(0, num_actions, (t1, b)),
            policy_logits=f32(t1, b, num_actions),
            baseline=f32(t1, b)))


def _slab_under_sync_debug(torch, device, config, num_actions):
    """The replay slab at OFF_POLICY_CAPACITY, fed as the driver feeds it:
    a packed buffer uploaded on a side stream (the prefetch thread's),
    inserted there, and sampled on the default stream (the update's).  A
    warm insert and sample first (they build the slabs); then an insert
    and a sample under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises at any synchronizing call; each sample bitwise equal to the
    batch in the slot the host mirror names; the slab's bytes printed."""
    import numpy as np

    from scalable_agent_tpu_torch.runtime.replay import DeviceReplayBuffer
    from scalable_agent_tpu_torch.runtime.transport import (
        PackedTransport,
        tree_leaves,
    )

    transport = PackedTransport(device)
    replay = DeviceReplayBuffer(OFF_POLICY_CAPACITY, seed=config.seed,
                                postprocess=transport.unpack)
    hosts = [_host_trajectory(config, num_actions, seed) for seed in (1, 2)]
    side = torch.cuda.Stream(device)

    def upload(host):
        with torch.cuda.stream(side):
            return transport.upload(transport.pack(host))

    def check(sampled, counter):
        torch.cuda.synchronize()
        host = hosts[replay.mirror_slot(counter, replay.size)]
        for got, want in zip(tree_leaves(sampled), tree_leaves(host)):
            if want is None:
                continue
            if not np.array_equal(got.cpu().numpy(), np.asarray(want)):
                raise AssertionError("a replay sample is not the inserted "
                                     "batch of its slot bit for bit")

    first = upload(hosts[0])
    with torch.cuda.stream(side):
        replay.insert(first)
    check(replay.sample(), 0)
    second = upload(hosts[1])
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            replay.insert(second)
        t1 = time.perf_counter()
        sampled = replay.sample()
        t2 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(sampled, 1)
    shard = transport.spec.shard_nbytes
    print(f"  replay slab: {OFF_POLICY_CAPACITY} slots x {shard} bytes = "
          f"{replay.nbytes / 2**30:.3f} GiB on the card; an insert "
          f"(side stream) and a sample (default stream) under "
          f"set_sync_debug_mode('error'): {1e3 * (t1 - t0):.3f} and "
          f"{1e3 * (t2 - t1):.3f} ms of host dispatch, no synchronizing "
          f"call; each sample the inserted batch of its slot bit for bit",
          flush=True)


def off_policy_path(torch, driver, CheckpointManager, config, scratch,
                    train_counted, reset_counts, read_counts):
    """Phase 3o: off-policy training on the main path.  ``fake_benchmark``
    at the reference layout and the bf16 policy with ``--loss=impact
    --replay_ratio=1 --replay_capacity=64 --target_update_interval=2
    --scan_impl=pallas``, resumed from phase 3's vtrace checkpoint (the
    migration: the target network starts from the restored parameters,
    so the first update's IMPACT ratio is 1), for OFF_POLICY_FRESH fresh
    updates and as many replayed ones, counted as in phase 3: 101 lean
    launches an update (the target's unroll) beside the actors', one
    residual forward, BPTT, grad-W and V-trace an update.  The rows:
    ``env_frames`` counts fresh frames only, replayed updates and samples
    equal OFF_POLICY_FRESH, the slab is occupied, the IMPACT histograms
    and ``ledger/staleness_replayed_s`` are published; s per update.
    Then the update alone on one trajectory (launches, ms against the
    vtrace update's), the slab under the sync debug mode, and
    ``--mode=test`` on the run's checkpoint, which holds the target.
    Returns the run's launches of the lean unroll (the target's unroll,
    one call an update; the actors' T=1 steps count apart)."""
    import shutil

    from scalable_agent_tpu_torch.obs import get_registry
    from scalable_agent_tpu_torch.ops.distributions import spec_for_space

    fpu = config.frames_per_update()
    updates = 2 * OFF_POLICY_FRESH
    logdir = os.path.join(scratch, "impact")
    shutil.copytree(os.path.join(config.logdir, "checkpoints"),
                    os.path.join(logdir, "checkpoints"))
    step, saved = CheckpointManager(logdir).restore()
    if step != UPDATES or "target_params" in saved:
        raise AssertionError(f"phase 3's checkpoint step {step} is not the "
                             f"vtrace step {UPDATES} the resume needs")
    impact = dataclasses.replace(
        config, logdir=logdir, trace=False, loss="impact", replay_ratio=1,
        replay_capacity=OFF_POLICY_CAPACITY, target_update_interval=2,
        scan_impl="pallas", total_environment_frames=float(
            (UPDATES + OFF_POLICY_FRESH) * fpu))
    before = get_registry().snapshot()
    expected = {c: 0 for c in LSTM_COUNTERS + GRADW_COUNTERS}
    expected.update(
        lstm_fwd_lean_bf16=(OFF_POLICY_FRESH * config.unroll_length, None),
        lstm_fwd_lean_unroll_bf16=updates,
        lstm_fwd_resid_bf16=updates, lstm_bptt_bf16=updates,
        stem_gradw_bf16=updates, vtrace_fused=updates)
    launches = train_counted(impact, UPDATES + OFF_POLICY_FRESH, "_bf16",
                             expected=expected)
    rows = {r["step"]: r for r in _rows(logdir)}
    registry = [r for r in _all_rows(logdir) if _is_registry_row(r)][-1]
    delta = lambda key: registry[f"obs/{key}"] - before.get(key, 0.0)
    first, last = min(rows), max(rows)
    per_iteration = ((rows[last]["time"] - rows[last - 2]["time"])
                     if last - 2 in rows else float("nan"))
    print(f"  impact + replay: steps {sorted(rows)}; the last fresh "
          f"iteration (one fresh and one replayed update) "
          f"{per_iteration:.4f} s, {per_iteration / 2:.4f} s per update; "
          f"env_frames {rows[last]['env_frames']:.0f} at the last row; "
          f"the first update's impact_ratio_mean "
          f"{rows[first]['impact_ratio_mean']:.6f}", flush=True)
    readings = {key: delta(key) for key in (
        "learner/replayed_updates_total", "replay/sampled_total",
        "replay/insert_total", "ledger/staleness_replayed_s/count",
        "learner/env_frames_total")}
    readings.update({key: registry[f"obs/{key}"] for key in (
        "replay/occupancy", "devtel/learn/impact_ratio/count",
        "devtel/learn/impact_ratio/mean",
        "devtel/learn/impact_clip_fraction/mean",
        "devtel/learn/impact_ess_frac", "ledger/staleness_replayed_s/p50",
        "ledger/staleness_s/p50", "replay/insert_s/mean",
        "replay/sample_s/mean", "replay/target_update_interval")})
    print(f"  registry: {json.dumps(readings, sort_keys=True)}", flush=True)
    if (readings["learner/replayed_updates_total"] != OFF_POLICY_FRESH
            or readings["replay/sampled_total"] != OFF_POLICY_FRESH
            or readings["ledger/staleness_replayed_s/count"]
            != OFF_POLICY_FRESH
            or readings["learner/env_frames_total"] != OFF_POLICY_FRESH * fpu
            or not readings["replay/occupancy"] > 0
            or not readings["devtel/learn/impact_ratio/count"] > 0
            or abs(rows[first]["impact_ratio_mean"] - 1.0) > 1e-2):
        raise AssertionError("phase 3o's counts are not the off-policy "
                             "dial's")

    obs_spec, action_space, _ = driver.probe_env(impact)
    num_actions = spec_for_space(action_space).num_logits
    device = torch.device(impact.device)
    host = _host_trajectory(impact, num_actions, seed=0)
    traj = driver.make_transport("per_leaf", device).put(host)[0]
    for loss in ("impact", "vtrace"):
        run = dataclasses.replace(impact, loss=loss, replay_ratio=0)
        agent = driver.build_agent(run, obs_spec, action_space, device)
        learner = driver.build_learner(run, agent)
        learner.update(traj)
        torch.cuda.synchronize()
        reset_counts()
        learner.update(traj)
        torch.cuda.synchronize()
        alone = read_counts()
        want = {c: 0 for c in LSTM_COUNTERS}
        want.update(lstm_fwd_lean_unroll_bf16=int(loss == "impact"),
                    lstm_fwd_resid_bf16=1, lstm_bptt_bf16=1,
                    stem_gradw_bf16=1, vtrace_fused=1)
        _expect_launches(f"the {loss} update alone", alone, want)
        ms = _time_ms(torch, lambda: learner.update(traj), 3)
        by_kernel = _kernel_ms(torch, lambda: learner.update(traj), 1)
        busy = sum(by_kernel.values())
        lean = _matching(by_kernel, LEAN_UNROLL[1])
        print(f"  the {loss} update alone on one trajectory: "
              f"{ms:.2f} ms (CUDA events), device busy {busy:.3f} ms, of "
              f"which the lean recurrence {lean:.3f} ms (its input GEMM "
              f"shares the residual forward's kernel); launches "
              f"{ {k: v for k, v in alone.items() if v} }", flush=True)
        del learner, agent
    torch.cuda.empty_cache()
    _slab_under_sync_debug(torch, device, impact, num_actions)

    ckpt = CheckpointManager(logdir)
    step, saved = ckpt.restore()
    ok, why = ckpt.verify(step, saved)
    if (step != UPDATES + updates or not ok or "target_params" not in saved
            or saved["env_frames"] != (UPDATES + OFF_POLICY_FRESH) * fpu):
        raise AssertionError(f"phase 3o's checkpoint step {step} verified "
                             f"{ok} ({why}), env_frames "
                             f"{saved['env_frames']}")
    reset_counts()
    t0 = time.monotonic()
    returns = driver.test(dataclasses.replace(
        impact, mode="test", test_num_episodes=4))[impact.level_name]
    test_launches = read_counts()
    print(f"  impact --mode=test on checkpoint step {step} (target network "
          f"saved, manifest verified): {len(returns)} returns in "
          f"{time.monotonic() - t0:.1f} s; lean bf16 launches "
          f"{test_launches['lstm_fwd_lean_bf16']}", flush=True)
    if len(returns) != 4 or test_launches["lstm_fwd_lean_bf16"] == 0:
        raise AssertionError("the impact run's --mode=test did not run 4 "
                             "episodes through the bf16 lean LSTM kernel")
    print(f"  the target's unroll in the run: "
          f"{launches['lstm_fwd_lean_unroll_bf16']} lean unroll calls "
          f"({updates} updates), beside the actors' "
          f"{launches['lstm_fwd_lean_bf16']} T=1 step launches", flush=True)
    return launches["lstm_fwd_lean_unroll_bf16"]


def _all_rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _is_registry_row(row):
    return any(key.startswith("obs/") for key in row)


def _rows(logdir):
    """metrics.jsonl's training rows (each log interval also writes the
    registry's row, every name prefixed ``obs/``)."""
    return [r for r in _all_rows(logdir) if not _is_registry_row(r)]


def pool_steady_state(torch, driver, config, logdir,
                      updates=POOL_UPDATES, label="pool loop"):
    """The loop's own figures over ``updates`` updates logged every
    update: s per update after the first 2, actor against learner fps,
    and Timing's wait_batch, update and retire over the same updates."""
    config = dataclasses.replace(
        config, logdir=logdir, log_interval_s=0.0,
        total_environment_frames=float(
            updates * config.frames_per_update()))
    driver.train(config)
    rows = {r["step"]: r for r in _rows(logdir)}
    first, last = rows[2], rows[updates]
    n = updates - 2
    s_per_update = (last["time"] - first["time"]) / n
    # Timing keeps a moving average over the last 50 values, one value
    # per update (retire: none while the window fills): differencing two
    # rows gives the mean of updates 3..N.
    lag = config.inflight_updates - 1
    steady = lambda key, lag=0: ((last[key] * (updates - lag)
                                  - first[key] * (2 - lag)) / n)
    tail = [rows[k] for k in range(3, updates + 1)]
    fps = sum(r["fps"] for r in tail) / len(tail)
    actor_fps = sum(r["actor_fps"] for r in tail) / len(tail)
    print(f"  {label} at inflight_updates={config.inflight_updates}, "
          f"updates 3..{updates}: {s_per_update:.4f} s per "
          f"update ({config.frames_per_update() / s_per_update:.0f} env "
          f"frames/s); mean of per-update rows: learner fps {fps:.0f}, "
          f"actor fps {actor_fps:.0f}; wait_batch "
          f"{steady('timing/wait_batch'):.4f} s, update "
          f"{steady('timing/update'):.4f} s, retire "
          f"{steady('timing/retire', lag):.4f} s per update", flush=True)
    return s_per_update


def service_path(torch, driver, config, scratch, train_counted, pool_s):
    """Phase 3p: ``--actor=service`` on the main path (64 envs in 2 groups
    of 32, 8 worker processes a group: slices of 4 envs; the default
    ``--service_max_batch``, every env; bf16, ``--scan_impl=pallas``) for
    SERVICE_UPDATES updates counted as in phase 3, every trajectory the
    learner takes held at [T+1, B] = [101, 32]: the bf16 lean step kernel
    launched exactly once per service batch (``service/batches_total``),
    ``ledger/rho/service_batch`` and ``service_wait`` in ``metrics.prom``,
    no ledger record left open; s per update after the first 2 beside
    phase 3b's pool loop, actor fps, ``service/batch_s`` p50 and p95, the
    batches by valid rows and by padded size (the kernel's B).  Then
    F32_UPDATES float32 updates, the float32 step kernel once per batch.
    Returns the runs' step launches by kernel name."""
    from scalable_agent_tpu_torch.obs import get_registry
    from scalable_agent_tpu_torch.runtime import service as service_mod

    batches = []
    shapes = []
    real_step = service_mod.service_actor_step

    def recording_step(agent, generator, ids, n, *rest):
        batches.append((n, int(ids.shape[0])))
        return real_step(agent, generator, ids, n, *rest)

    class Checked(service_mod.ActorService):
        def get_trajectory(self, timeout=None):
            out = super().get_trajectory(timeout)
            shapes.append((out.env_outputs.observation.frame.shape[:2],
                           out.agent_outputs.policy_logits.shape[:2],
                           out.agent_state.c.shape[0]))
            return out

    batches_total = get_registry().counter("service/batches_total")
    launches = {}
    for compute_dtype, updates, suffix in (
            ("bfloat16", SERVICE_UPDATES, "_bf16"),
            ("float32", F32_UPDATES, "")):
        logdir = os.path.join(scratch, f"service_{compute_dtype}")
        run = dataclasses.replace(
            config, logdir=logdir, actor="service",
            compute_dtype=compute_dtype, log_interval_s=0.0,
            total_environment_frames=float(
                updates * config.frames_per_update()))
        other = "" if suffix else "_bf16"
        expected = {
            "lstm_fwd_lean" + suffix: (1, None),
            "lstm_fwd_resid" + suffix: updates, "lstm_bptt" + suffix: updates,
            "stem_gradw" + suffix: updates, "vtrace_fused": updates,
            "lstm_fwd_lean" + other: 0, "lstm_fwd_resid" + other: 0,
            "lstm_bptt" + other: 0, "stem_gradw" + other: 0}
        del batches[:], shapes[:]
        before = batches_total.value
        with _patched(service_mod, service_actor_step=recording_step), \
                _patched(driver, ActorService=Checked):
            counts = train_counted(run, updates, suffix, expected=expected)
        ran = batches_total.value - before
        name = "lstm_fwd_lean" + suffix
        launches[name] = counts[name]
        print(f"  --actor=service at {compute_dtype}: {int(ran)} service "
              f"batches, {counts[name]} {name} launches, "
              f"{len(shapes)} trajectories taken", flush=True)
        if not (counts[name] == ran == len(batches) > 0):
            raise AssertionError(
                f"phase 3p: {name} launched {counts[name]} times in "
                f"{ran} service batches ({len(batches)} recorded)")
        want = ((config.unroll_length + 1, config.batch_size),
                (config.unroll_length + 1, config.batch_size),
                config.batch_size)
        if len(shapes) < updates or any(s != want for s in shapes):
            raise AssertionError(f"phase 3p: trajectories {set(shapes)} "
                                 f"are not [T+1, B] = {want[0]}")
        prom = open(os.path.join(logdir, "metrics.prom")).read()
        for family in ("impala_ledger_rho_service_batch",
                       "impala_ledger_rho_service_wait"):
            if family not in prom:
                raise AssertionError(f"phase 3p: metrics.prom lacks "
                                     f"{family}")
        with open(os.path.join(logdir, "ledger.p0.json")) as f:
            open_records = json.load(f)["open_records"]
        if open_records:
            raise AssertionError(f"phase 3p: {len(open_records)} ledger "
                                 f"records left open")
        if compute_dtype != "bfloat16":
            continue
        rows = {r["step"]: r for r in _rows(logdir)}
        s_per_update = (rows[updates]["time"] - rows[2]["time"]) / (
            updates - 2)
        actor_fps = sum(rows[k]["actor_fps"]
                        for k in range(3, updates + 1)) / (updates - 2)
        batch_s = get_registry().histogram("service/batch_s").quantiles()
        by_rows, by_padded = {}, {}
        for n, padded in batches:
            by_rows[n] = by_rows.get(n, 0) + 1
            by_padded[padded] = by_padded.get(padded, 0) + 1
        print(f"  service loop, updates 3..{updates}: {s_per_update:.4f} "
              f"s per update ({config.frames_per_update() / s_per_update:.0f}"
              f" env frames/s) against phase 3b's pool loop {pool_s:.4f} "
              f"on the same machine; actor fps {actor_fps:.0f}; "
              f"service/batch_s p50 {batch_s[0.5] * 1e3:.3f} ms, p95 "
              f"{batch_s[0.95] * 1e3:.3f} ms", flush=True)
        print(f"  service batches by valid rows "
              f"{dict(sorted(by_rows.items()))}; by padded size (the step "
              f"kernel's B) {dict(sorted(by_padded.items()))}", flush=True)
    return launches


def inference_modes_path(torch, driver, config, scratch, train_counted,
                         pool_s):
    """Phase 3q: the ActorPool's other inference modes on the main path
    (64 envs in 2 groups of 32, 8 worker processes a group; bf16,
    ``--scan_impl=pallas``), each for MODE_UPDATES updates counted as in
    phase 3: ``--inference_mode=service`` (the bf16 lean step kernel
    launched once per native-batcher batch, ``native_batcher/
    batches_total``), ``accum`` (once per ``grouped_actor_step`` of B=32
    rows: groups x T an unroll round) and ``accum_fused`` at
    ``--accum_fused_shards=0`` (the probe's RTT, H2D bandwidth and shard
    count printed; once per step of a shard's k*B rows: shards x T a
    round), then SHARD_UPDATES updates at the shard count the probe did
    not pick.  Under the accum modes every trajectory reaches the learner
    as the actor's own CUDA tensors (the transport passes it through) and
    ``transport/pack_s`` does not move; under ``service`` every one is
    packed.  Each failing the run.  Printed, not gated: s per update after
    the first 2 beside phase 3b's pool loop, ``actor/inference`` ms per
    step, ``transport/h2d_bytes_total`` per update.  Then the accum actors
    against the structural one on the card
    (``accum_matches_structural_on_card``).  Returns each mode's bf16 lean
    step launches."""
    from scalable_agent_tpu_torch.obs import get_registry
    from scalable_agent_tpu_torch.runtime import accum_actor
    from scalable_agent_tpu_torch.runtime.transport import tree_leaves

    registry = get_registry()
    calls = []  # (thread, rows) of each accum actor step
    placed = []  # (every leaf on the card, passed through) of each put
    pools = []
    real_step = accum_actor.grouped_actor_step
    real_make = driver.make_transport

    def recording_step(agent, generators, group_rows, *rest):
        calls.append((threading.current_thread().name,
                      len(generators) * group_rows))
        return real_step(agent, generators, group_rows, *rest)

    def recording_transport(name, device):
        transport = real_make(name, device)
        real_put = transport.put

        def put(trajectory, ready=None):
            leaves = [t for t in tree_leaves(trajectory) if t is not None]
            out = real_put(trajectory, ready=ready)
            placed.append((
                all(isinstance(t, torch.Tensor) and t.device.type == kind
                    for t in leaves),
                out[0].env_outputs.observation.frame
                is trajectory.env_outputs.observation.frame))
            return out

        transport.put = put
        return transport

    class Recorded(driver.ActorPool):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pools.append(self)

    def reading():
        infer = registry.histogram("actor/inference_s")
        return dict(
            batches=registry.counter("native_batcher/batches_total").value,
            packs=registry.histogram("transport/pack_s").count,
            h2d=registry.counter("transport/h2d_bytes_total").value,
            infer_n=infer.count, infer_s=infer.sum)

    kind = torch.device(config.device).type
    fpu = config.frames_per_update()
    runs = [("service", 0, MODE_UPDATES), ("accum", 0, MODE_UPDATES),
            ("accum_fused", 0, MODE_UPDATES)]
    launches = {}
    for mode, shards, updates in runs:
        label = f"{mode}" + (f" shards={shards}" if mode == "accum_fused"
                             else "")
        run = dataclasses.replace(
            config, logdir=os.path.join(scratch, f"mode_{mode}_{shards}"),
            inference_mode=mode, accum_fused_shards=shards,
            log_interval_s=0.0,
            total_environment_frames=float(updates * fpu))
        expected = {
            "lstm_fwd_lean_bf16": (1, None),
            "lstm_fwd_resid_bf16": updates, "lstm_bptt_bf16": updates,
            "stem_gradw_bf16": updates, "vtrace_fused": updates,
            "lstm_fwd_lean": 0, "lstm_fwd_resid": 0, "lstm_bptt": 0,
            "stem_gradw": 0}
        del calls[:], placed[:], pools[:]
        before = reading()
        with _patched(accum_actor, grouped_actor_step=recording_step), \
                _patched(driver, make_transport=recording_transport,
                         ActorPool=Recorded):
            counts = train_counted(run, updates, "_bf16", expected=expected)
        after = reading()
        delta = {key: after[key] - before[key] for key in after}
        (pool,) = pools
        step = counts["lstm_fwd_lean_bf16"]
        launches[label] = step
        T, B = config.unroll_length, config.batch_size
        if mode == "service":
            if not step == delta["batches"] > 0:
                raise AssertionError(
                    f"phase 3q {label}: {step} lean step launches in "
                    f"{delta['batches']} native batcher batches")
            how = f"{int(delta['batches'])} native batcher batches"
        else:
            rows = {}
            for thread, n in calls:
                rows.setdefault(thread, set()).add(n)
            by_thread = {thread: sum(1 for t, _ in calls if t == thread)
                         for thread in rows}
            want_rows = sorted(len(actor.envs_list) * B
                               for actor in pool.actors)
            if (step != len(calls) or len(rows) != len(pool.actors)
                    or sorted(sorted(n) for n in rows.values())
                    != [[n] for n in want_rows]
                    or min(by_thread.values()) < T):
                raise AssertionError(
                    f"phase 3q {label}: {step} lean step launches, "
                    f"{len(calls)} actor steps by thread {by_thread} with "
                    f"rows {rows}; {len(pool.actors)} actors of rows "
                    f"{want_rows}")
            rounds = {thread: divmod(n, T)
                      for thread, n in sorted(by_thread.items())}
            how = (f"{len(calls)} actor steps of {want_rows} rows on "
                   f"{len(pool.actors)} threads (unroll rounds of T={T} and "
                   f"steps of an unfinished one, by thread: {rounds})")
        on_card = {p for p, _ in placed}
        through = {t for _, t in placed}
        device_path = mode != "service"
        if (len(placed) < updates or on_card != {device_path}
                or through != {device_path}
                or (delta["packs"] == 0) != device_path):
            raise AssertionError(
                f"phase 3q {label}: {len(placed)} trajectories placed, on "
                f"the card as the actor's own tensors {on_card}/{through}, "
                f"{delta['packs']} packs")
        print(f"  --inference_mode={label}: {step} lean step launches = "
              f"{how}; {len(placed)} trajectories placed, "
              f"{'passed through as CUDA tensors, no pack' if device_path else 'packed and uploaded'}",
              flush=True)
        if mode == "accum_fused" and shards == 0:
            link = pool.link
            print(f"  link probe: rtt {link.rtt_s * 1e3:.4f} ms, h2d "
                  f"{link.h2d_bytes_per_s / 1e9:.3f} GB/s; "
                  f"accum_fused_shards=0 chose {pool.fused_shards} "
                  f"shard(s) for {config.num_actors // B} groups of {B}",
                  flush=True)
            other = 2 if pool.fused_shards == 1 else 1
            runs.append(("accum_fused", other, SHARD_UPDATES))
        infer_ms = (delta["infer_s"] / max(delta["infer_n"], 1)) * 1e3
        parts = [f"actor/inference {infer_ms:.3f} ms per step "
                 f"({int(delta['infer_n'])} steps)",
                 f"transport/h2d_bytes_total {delta['h2d'] / updates / 1e6:.2f}"
                 f" MB per update"]
        if updates > 2:
            rows = {r["step"]: r for r in _rows(run.logdir)}
            s_per_update = (rows[updates]["time"] - rows[2]["time"]) / (
                updates - 2)
            parts.insert(0, f"updates 3..{updates}: {s_per_update:.4f} s "
                            f"per update ({fpu / s_per_update:.0f} env "
                            f"frames/s) against phase 3b's pool loop "
                            f"{pool_s:.4f}")
        print(f"  {label}: " + "; ".join(parts), flush=True)
    accum_matches_structural_on_card(torch, driver, config)
    return launches


def accum_matches_structural_on_card(torch, driver, config):
    """Phase 3q's hold of the accum device path against the structural
    path on the card: the same weights at float32 and identically seeded
    env groups (the main path's 2 groups of 32), ACCUM_CHECK_UNROLLS
    unrolls each of a structural ``VectorActor`` a group (the reference),
    an ``AccumVectorActor`` a group and one ``GroupedAccumActor`` over both
    groups.  The three accum actors run at once, each on its own thread and
    CUDA stream as in the pool, and go on with their next unroll while a
    consumer on another stream takes each trajectory through
    ``adopt_device_trajectory``, as the prefetch does: the pinned staging's
    non-blocking copies, the staging and ready events, ``record_stream``
    and the in-place slot writes all run as on the main path.  Frames,
    actions and dones must equal the structural ones exactly, rewards
    within 1e-6, logits, baselines and the first core state within the CPU
    test's rtol 1e-5, atol 1e-6; a mismatch fails the run."""
    import copy
    import queue as queue_lib

    import numpy as np

    from scalable_agent_tpu_torch.ops import float32_precision
    from scalable_agent_tpu_torch.runtime import VectorActor
    from scalable_agent_tpu_torch.runtime.accum_actor import (
        AccumPrograms,
        AccumVectorActor,
        GroupedAccumActor,
    )
    from scalable_agent_tpu_torch.runtime.actor import to_numpy
    from scalable_agent_tpu_torch.runtime.transport import (
        adopt_device_trajectory,
        host_trajectory,
    )

    run = dataclasses.replace(config, compute_dtype="float32")
    device = torch.device(run.device)
    spec, space, _ = driver.probe_env(run)
    agent = driver.build_agent(run, spec, space, device).requires_grad_(
        False)
    T, B = run.unroll_length, run.batch_size
    groups = run.num_actors // B
    seeds = [run.seed + 1000 * g for g in range(groups)]
    unrolls = ACCUM_CHECK_UNROLLS
    # cuDNN's default TF32 would make the fused actor's B=64 convolutions
    # differ from the B=32 ones by more than float32's rounding.
    with float32_precision():
        fleets, threads, stop = [], [], threading.Event()
        try:
            fleets.append(driver.make_env_groups(run, spec.frame))
            want = []
            for g, envs in enumerate(fleets[0]):
                actor = VectorActor(agent, envs, T, seed=seeds[g])
                want.append([actor.run_unroll() for _ in range(unrolls)])
            fleets.append(driver.make_env_groups(run, spec.frame))
            fleets.append(driver.make_env_groups(run, spec.frame))
            programs = AccumPrograms(agent, T, B,
                                     fleets[1][0].frame_slab().shape[1:])
            producers = [(f"accum-{g}", AccumVectorActor(
                programs, envs, seed=seeds[g],
                agent=copy.deepcopy(agent)))
                for g, envs in enumerate(fleets[1])]
            producers.append(("fused", GroupedAccumActor(
                programs, fleets[2], seeds=seeds,
                agent=copy.deepcopy(agent))))
            handoff = queue_lib.Queue()

            def produce(name, actor):
                try:
                    with torch.cuda.stream(torch.cuda.Stream(device)):
                        for unroll in range(unrolls):
                            if stop.is_set():
                                return
                            out = actor.run_unroll()
                            handoff.put((name, unroll,
                                         out if isinstance(out, list)
                                         else [out]))
                except BaseException as exc:
                    handoff.put((name, None, exc))

            threads.extend(threading.Thread(target=produce, args=producer,
                                            daemon=True)
                           for producer in producers)
            for thread in threads:
                thread.start()
            got = {}
            with torch.cuda.stream(torch.cuda.Stream(device)):
                for _ in range(len(producers) * unrolls):
                    name, unroll, outs = handoff.get(timeout=300)
                    if unroll is None:
                        raise outs
                    for i, out in enumerate(outs):
                        group = i if name == "fused" else int(name[-1])
                        trajectory, _ = adopt_device_trajectory(
                            host_trajectory(out), out.ready)
                        got[(name, group, unroll)] = to_numpy(trajectory)
        finally:
            # The producers leave their envs before they are closed.
            stop.set()
            for thread in threads:
                thread.join(timeout=60)
            for fleet in fleets:
                for envs in fleet:
                    envs.close()
    worst = {}
    for (name, group, unroll), a in sorted(got.items()):
        s = want[group][unroll]
        msg = f"phase 3q: {name} group {group} unroll {unroll}"
        for field, x, y in (
                ("frame", s.env_outputs.observation.frame,
                 a.env_outputs.observation.frame),
                ("action", s.agent_outputs.action, a.agent_outputs.action),
                ("done", s.env_outputs.done, a.env_outputs.done)):
            if x.shape != y.shape or not np.array_equal(x, y):
                raise AssertionError(
                    f"{msg}: {field} differs from the structural path "
                    f"({x.shape} against {y.shape}, first at "
                    f"{np.argwhere(x != y)[:3].tolist()})")
        np.testing.assert_allclose(a.env_outputs.reward,
                                   s.env_outputs.reward, rtol=1e-6,
                                   err_msg=f"{msg}: reward")
        for field, x, y in (
                ("logits", s.agent_outputs.policy_logits,
                 a.agent_outputs.policy_logits),
                ("baseline", s.agent_outputs.baseline,
                 a.agent_outputs.baseline),
                ("c", s.agent_state.c, a.agent_state.c),
                ("h", s.agent_state.h, a.agent_state.h)):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{msg}: {field}")
            kind = worst.setdefault(name.split("-")[0], {})
            kind[field] = max(kind.get(field, 0.0),
                              float(np.max(np.abs(y - x))))
    print(f"  accum on the card against structural (float32, {groups} "
          f"groups of {B}, {unrolls} unrolls of T={T}; {len(got)} "
          f"trajectories taken on another stream): frames, actions and "
          f"dones equal; max abs differences: " + "; ".join(
              f"{kind} " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              for kind, d in worst.items()), flush=True)


SENTINEL_UPDATES = 3         # phase 3r's clean run and its chaos run
SOAK_BUDGET_S = 20.0         # phase 3s: seconds from the run's first update
SOAK_SEED = 5                # the first seed whose 4 faults span the 4 points
SOAK_POINTS = ("nan_grad", "throughput_sag", "param_bitflip", "actor_raise")
# The card's in-process recoveries take seconds (a skipped update, a 0.45 s
# sleep, a rebuild and its first update, an actor respawn after 0.5 s),
# not the JAX defaults' TPU re-jit windows of 15-30 s, which would cover
# every row of a 20 s budget.  A window opens when the line is appended;
# an actor's point lands at its next unroll (3.7 s later in one card run),
# so those windows are 8 s.
SOAK_RECOVERY = "nan_grad=4,throughput_sag=4,param_bitflip=8,actor_raise=8"
SOAK_TIMEOUT_S = 300
# The soak's sentinel runs at the card's own calibration, not the JAX
# default 0.6 (a TPU's): over 100 clean audits a rung on the main path
# the card read a largest deviation of 1.332 at rung 0 and 1.149 at rung
# 1 (a conv bias, a near-cancelled sum of bf16 cotangents), 2% of the
# audits over 0.6 (PERF.md: tools/sentinel_envelope.py), which the
# soak's quiet invariant would count as spontaneous trips.  1.5x the
# largest reading.  Phase 3r holds the default.
SOAK_SENTINEL_RTOL = 2.0


def _device_time_ms(torch, profiler):
    """The CUDA kernels' own milliseconds in a finished profiler window."""
    total = 0.0
    for evt in profiler.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0.0)
    return total / 1e3


def _flip_target(torch, sentinel_lib, sentinel, snap):
    """Before a ``param_bitflip`` audit: the flax leaf and value of the
    element the flip will take, the change the flip makes, the leaf's size
    and the audit's lr."""
    import numpy as np

    views = sentinel_lib.flax_leaf_views(
        sentinel.learner.state_dict()["params"])
    flat = torch.cat([v.detach().reshape(-1) for _, v in views])
    index = int(flat.abs().argmax())
    for path, view in views:
        if index < view.numel():
            break
        index -= view.numel()
    value = np.float32(view.reshape(-1)[index].item())
    flipped = (value.view(np.int32) ^ np.int32(1 << sentinel_lib.FLIP_BIT)
               ).view(np.float32)
    hp = sentinel.learner._hp
    return dict(leaf=path, numel=view.numel(), value=float(value),
                change=abs(float(flipped) - float(value)),
                lr=hp.learning_rate * max(
                    0.0, 1.0 - snap.env_frames / hp.total_environment_frames))


def _audit_recorder(torch, sentinel_lib, read_counts, audits,
                    profile_index=None, flip_index=None, write_counts=None):
    """A ``NumericsSentinel.audit`` that appends, after each audit, its
    rung before and after, its per-leaf deviations (both arms, read off
    the card after the audit's own single read), the launch counts, its
    host ms (from a synchronized start to its end, synchronized) and, for
    audit ``profile_index``, the kernels' device ms (torch.profiler).  For
    audit ``flip_index`` it first records ``_flip_target`` and the same
    update's deviations without the flip, whose launches it takes back
    off the counts (``write_counts``): they are not the path's."""
    real_audit = sentinel_lib.NumericsSentinel.audit

    def recorded(self, snap, trajectory, updates):
        rung = self.rung
        flip = None
        if len(audits) == flip_index:
            flip = _flip_target(torch, sentinel_lib, self, snap)
            counts = read_counts()
            grad, delta = self._deviations(snap, trajectory, False)
            flip.update(clean_grad=grad.tolist(), clean_delta=delta.tolist())
            write_counts(counts)
        torch.cuda.synchronize()
        profiler = None
        if len(audits) == profile_index:
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
            profiler.start()
        t0 = time.perf_counter()
        real_audit(self, snap, trajectory, updates)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        device_ms = None
        if profiler is not None:
            profiler.stop()
            device_ms = _device_time_ms(torch, profiler)
        grad, delta = self.last_deviations
        audits.append(dict(update=updates, rung=rung, rung_after=self.rung,
                           grad=grad.tolist(), delta=delta.tolist(),
                           leaves=list(self.leaf_names), counts=read_counts(),
                           host_ms=host_ms, device_ms=device_ms, flip=flip))

    return recorded


def _print_audit(audit, rtol, all_leaves=False):
    """Print one recorded audit; returns (max deviation, its arm)."""
    rows = ([(d, leaf, "grad") for d, leaf in
             zip(audit["grad"], audit["leaves"])]
            + [(d, leaf, "delta") for d, leaf in
               zip(audit["delta"], audit["leaves"])])
    dev, leaf, arm = max(rows)
    print(f"  audit of update {audit['update'] + 1} (rung {audit['rung']} -> "
          f"{audit['rung_after']}): max_deviation {dev:.6g} ({arm} arm, "
          f"{leaf}) against rtol {rtol}; {audit['host_ms']:.2f} host ms"
          + (f", {audit['device_ms']:.3f} device ms"
             if audit["device_ms"] is not None else ""), flush=True)
    if all_leaves:
        print("    per leaf, grad / delta: " + "; ".join(
            f"{leaf} {g:.3g} / {d:.3g}" for leaf, g, d in zip(
                audit["leaves"], audit["grad"], audit["delta"])),
              flush=True)
    return dev, arm


def sentinel_path(torch, driver, config, scratch, train_counted, read_counts,
                  write_counts, card):
    """Phase 3r: the numerics sentinel on the main path (bf16,
    ``--scan_impl=pallas``, every update audited: ``--sentinel_interval=1``)
    in three runs counted as in phase 3.  The audit takes each batch's
    gradients at the pre-update parameters through the hot route (the bf16
    kernels, the stem's grad-W) and the reference learner (the float32
    LSTM kernels, cuDNN's wgrad, the two-pass loss), both on the card.
    (1) Clean, SENTINEL_UPDATES updates: every update audited, no breach
    at the default rtol, the bf16 residual forward, BPTT and grad-W
    launched by the updates and again by the audits, the float32 residual
    forward twice and the float32 BPTT once an audit, the float32 grad-W
    never; each audit's deviation per flax leaf printed, its host ms and
    (the second audit) its kernels' device ms beside the card's name and
    power limit.  (2) ``kernel_miscompute@2;param_bitflip@3``: the second
    audit breaches near 1.0 and demotes to rung 1 (``conv_backend=xla``);
    the bf16 grad-W counter does not move after the swap; the third
    audit's flipped leaf reads the flip on its delta arm (below); the run
    finishes with exact frames.  Returns the clean run's launch counts."""
    from scalable_agent_tpu_torch.obs import get_registry
    from scalable_agent_tpu_torch.runtime import sentinel as sentinel_lib

    registry = get_registry()
    fpu, steps = config.frames_per_update(), config.unroll_length
    rtol = config.sentinel_rtol

    def audited_run(name, updates, expected, chaos_spec="",
                    profile_index=None, flip_index=None):
        audits = []
        run = dataclasses.replace(
            config, logdir=os.path.join(scratch, f"sentinel_{name}"),
            sentinel_interval=1, chaos_spec=chaos_spec, log_interval_s=0.0,
            total_environment_frames=float(updates * fpu))
        before = registry.snapshot()
        t0 = time.monotonic()
        with _patched(sentinel_lib.NumericsSentinel,
                      audit=_audit_recorder(torch, sentinel_lib, read_counts,
                                            audits, profile_index,
                                            flip_index, write_counts)):
            counts = train_counted(run, updates, "_bf16", expected=expected)
        after = registry.snapshot()
        delta = lambda key: after.get(key, 0.0) - before.get(key, 0.0)
        print(f"  {name} run: {updates} updates, {len(audits)} audits, "
              f"{delta('devtel/sentinel/breaches_total'):.0f} breaches, rung "
              f"{after.get('sentinel/rung')}, in {time.monotonic() - t0:.1f} "
              f"s", flush=True)
        if (len(audits) != updates
                or delta("devtel/sentinel/audits_total") != updates):
            raise AssertionError(f"phase 3r ({name}): {len(audits)} audits "
                                 f"recorded, devtel "
                                 f"{delta('devtel/sentinel/audits_total')}, "
                                 f"for {updates} updates")
        return counts, audits, delta, after

    # (1) The clean run.
    u = SENTINEL_UPDATES
    counts, audits, delta, _ = audited_run(
        "clean", u, {"lstm_fwd_lean_bf16": (u * steps, None),
                     "lstm_fwd_resid_bf16": 2 * u, "lstm_bptt_bf16": 2 * u,
                     "stem_gradw_bf16": 2 * u, "vtrace_fused": 3 * u,
                     "lstm_fwd_resid": 2 * u, "lstm_bptt": u,
                     "stem_gradw": 0, "lstm_fwd_lean": 0},
        profile_index=1)
    worst = [_print_audit(a, rtol, all_leaves=True)[0] for a in audits]
    if delta("devtel/sentinel/breaches_total") or max(worst) > rtol:
        raise AssertionError(f"phase 3r: the clean run breached: max "
                             f"deviations {worst} against rtol {rtol}")
    host = [a["host_ms"] for a in audits[1:]]
    print(f"  the audit's added time per audited update (audits 2..{u}; "
          f"the first builds the reference learner, "
          f"{audits[0]['host_ms']:.1f} ms): host {sum(host) / len(host):.2f} "
          f"ms, the second audit's kernels {audits[1]['device_ms']:.3f} "
          f"device ms; {card}", flush=True)

    # (2) One chaos run: kernel_miscompute at the second audit (a breach
    # near 1.0, rung 1, the bf16 grad-W still after the swap), then
    # param_bitflip at the third, on the rung-1 learner.  The flip moves
    # one element by `change`; an RMSProp step is at most 10 lr an element
    # (nu >= 0.01 g^2), so the flipped leaf's delta arm, flipped plus
    # clean, reads at least change / (10 lr sqrt(n)).  Whether that passes
    # rtol depends on the leaf's size: a breach is printed, not required
    # (PERF.md, section 6).
    _, audits, delta, after = audited_run(
        "chaos", u, {"stem_gradw_bf16": 4, "stem_gradw": 0,
                     "lstm_bptt_bf16": 2 * u, "lstm_bptt": u},
        chaos_spec="kernel_miscompute@2;param_bitflip@3", flip_index=2)
    devs = [_print_audit(a, rtol) for a in audits]
    breach = devs[1][0]
    if not (abs(breach - 1.0) < 0.25 and audits[0]["rung_after"] == 0
            and audits[1]["rung_after"] == 1 and audits[2]["rung"] == 1):
        raise AssertionError(f"phase 3r: kernel_miscompute read {devs}")
    swapped = audits[1]["counts"]["stem_gradw_bf16"]
    if audits[2]["counts"]["stem_gradw_bf16"] != swapped:
        raise AssertionError("phase 3r: the stem's grad-W kernel launched "
                             "after the demotion to conv_backend=xla")
    print(f"  kernel_miscompute: breach {breach:.6g} at the second audit, "
          f"rung 1; stem_gradw_bf16 {swapped} at the swap and at the end",
          flush=True)
    audit = audits[2]
    flip = audit["flip"]
    k = audit["leaves"].index(flip["leaf"])
    floor = flip["change"] / (10.0 * flip["lr"] * math.sqrt(flip["numel"]))
    read = audit["delta"][k]
    print(f"  param_bitflip: {flip['leaf']} ({flip['numel']} elements) "
          f"{flip['value']:.6g} flipped by {flip['change']:.6g}; its delta "
          f"arm {read:.6g} against {flip['clean_delta'][k]:.6g} without "
          f"the flip on the same update (grad arm {audit['grad'][k]:.6g}"
          f" / {flip['clean_grad'][k]:.6g}), the step bound's floor "
          f"{floor:.6g}; rung {audit['rung']} -> {audit['rung_after']} "
          f"at rtol {rtol}", flush=True)
    if not (read + flip["clean_delta"][k] >= floor and read > flip[
            "clean_delta"][k] and abs(audit["grad"][k]
                                      - flip["clean_grad"][k]) < 1e-3):
        raise AssertionError("phase 3r: the delta arm did not read the "
                             "param_bitflip on its leaf")
    return counts


def soak_path(root, scratch, card):
    """Phase 3s: one single-process chaos soak on the card through the
    CLI's ``run``: the main path (bf16, ``--scan_impl=pallas``, every
    other update audited at SOAK_SENTINEL_RTOL, a row every 1 s) as a
    driver subprocess fed SOAK_POINTS through the runtime channel (4
    faults of seed SOAK_SEED, all four points, ``param_bitflip`` the
    sentinel's), SOAK_BUDGET_S from its first update, then SIGTERMed and
    drained.  Every fault must land (``faults/injected_total``), the run
    drain with exit 0, and ``soak_report.json`` pass every invariant but
    ``throughput_floor``, which is printed: on the card the main path's
    loop is actor-bound, a metrics row of a few updates reads +-15-25%
    and the loop ramps for ~20 s, so the floor (0.8 of the median of the
    graded rows) read 0.63-0.98 over nine soaks on the card at 20-60 s
    budgets and 1-4 s rows (PERF.md, section 6).  The health plane's
    detectors run and are graded, but open no profile window: starting
    ``torch.profiler`` stalls the loop for ~6 s on the card, which the
    graded rows and detectors would take for the run's own."""
    from scalable_agent_tpu_torch.runtime import soak

    logdir = os.path.join(scratch, "soak")
    cmd = [sys.executable, "-m", "scalable_agent_tpu_torch.runtime.soak",
           "run", f"--soak_seed={SOAK_SEED}", "--soak_faults=4",
           f"--soak_budget_s={SOAK_BUDGET_S}",
           f"--soak_points={','.join(SOAK_POINTS)}",
           f"--soak_recovery_s={SOAK_RECOVERY}", f"--logdir={logdir}",
           "--level_name=fake_benchmark", "--scan_impl=pallas",
           "--sentinel_interval=2",
           f"--sentinel_rtol={SOAK_SENTINEL_RTOL}", "--log_interval_s=1",
           "--checkpoint_interval_s=5", "--health_max_windows=0"]
    proc, elapsed = _run_cli(root, cmd, SOAK_TIMEOUT_S)
    report = soak.read_soak_report(logdir)
    print(proc.stdout.strip(), flush=True)
    if report is None:
        raise AssertionError(f"phase 3s: no soak report (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    counters = soak._read_prom_counters(logdir)
    print(f"  soak: exit {proc.returncode} in {elapsed:.1f} s; the run's "
          f"first update "
          f"{report['started_unix'] - report['launched_unix']:.1f} s after "
          f"launch; faults landed {report['land_wait_s']} s after "
          f"the budget; {counters.get('learner_updates_total', 0):.0f} "
          f"updates, {counters.get('devtel_sentinel_audits_total', 0):.0f} "
          f"audits, sentinel trips "
          f"{counters.get('sentinel_trips_total', 0):.0f}, rung "
          f"{counters.get('sentinel_rung')}; {card}", flush=True)
    points = set(report["points"])
    gated = {name: verdict for name, verdict in report["invariants"].items()
             if name != "throughput_floor"}
    throughput = report["invariants"]["throughput_floor"]
    print(f"  throughput_floor (printed, not gated): ok {throughput['ok']}, "
          f"{json.dumps(throughput, sort_keys=True)}", flush=True)
    landed = counters.get("faults_injected_total", 0) == len(
        report["injected"])
    if not (all(v["ok"] for v in gated.values()) and landed
            and len(points) >= 3 and "param_bitflip" in points
            and report["worker_rc"] == 0 and report["drained"]):
        raise AssertionError(f"phase 3s: the soak did not land its faults "
                             f"over >= 3 points, param_bitflip among them, "
                             f"and drain, and pass every invariant but the "
                             f"throughput floor:\n"
                             f"{json.dumps(report['invariants'])}"
                             f"\n{proc.stderr[-3000:]}")


INGRAPH_UPDATES = 4          # phase 3t's main-path runs, at K=1 and at K=2
INGRAPH_LEVEL_UPDATES = 2    # each device_ level's bf16 in-graph run
INGRAPH_TIMED = 4            # updates timed per K on the dispatch alone
DEVICE_WORLDS = ("device_grid_small", "device_grid_large",
                 "device_minatar_breakout", "device_minatar_asterix")
# The levels whose float32 run (1 update) launches the float32 kernels at
# the worlds' new shapes: 15x15x3, 10x10x4 and D=260, 10x10x3 and D=262.
WORLD_F32_LEVELS = ("device_grid_small", "device_minatar_breakout",
                    "device_minatar_asterix")
# The stem's frames and the core's widths the worlds take (phase 2).
WORLD_FRAMES = ((15, 15, 3), (10, 10, 3), (10, 10, 4))
WORLD_WIDTHS = (260, 262)
HOST_STREAM_STEPS = 100      # the host twin's stream held against the card's
INGRAPH_RANGES = ("actor_inference", "env_step", "learner_update")


def _frame_tag(frame):
    return "x".join(str(n) for n in frame)


def _world_stem(frame):
    """The stem grad-W's launch counter at a world's frame."""
    return "stem_gradw_c4" if frame[-1] == 4 else "stem_gradw"


def _shape_rows(rows, frame):
    """Phase-2 rows renamed with the frame they were taken at."""
    return [(f"{row[0]} {_frame_tag(frame)}",) + tuple(row[1:])
            for row in rows]


def _wide_rows(ms, width, matmul_dtype):
    """``compare_lstm_wide``'s readings at core width ``width`` as the
    kernels line's fields, one row per kernel."""
    rows = {}
    for part, counter, replaces in (
            ("lean", "lstm_fwd_lean", "lstm_pallas.py:89"),
            ("resid", "lstm_fwd_resid", "lstm_pallas.py:105"),
            ("bptt", "lstm_bptt", "lstm_pallas.py:123")):
        times = ms[part]
        name = f"{_variant(counter, matmul_dtype)} D={width}"
        rows[name] = dict(
            name=name, route="cuda",
            source="scalable_agent_tpu_torch/csrc/lstm.cu",
            replaces=f"scalable_agent_tpu/ops/{replaces}",
            max_abs_err=times["max_abs_err"], ms=times["ms"],
            plain_ms=times["plain_ms"], bound_ms=times["bound_ms"],
            bound_by=times["bound_by"],
            library_ms=(ms["lean_library"]["ms"] if part == "lean"
                        else None),
            device_ms=times["device_ms"])
    return rows


def _ingraph_config(config, scratch, name, level="fake_benchmark",
                    updates=INGRAPH_UPDATES, **overrides):
    """The main path's configuration under ``--train_backend=ingraph``
    for ``updates`` updates of ``level``."""
    return dataclasses.replace(
        config, level_name=level, train_backend="ingraph", trace=False,
        logdir=os.path.join(scratch, name),
        total_environment_frames=float(updates
                                       * config.frames_per_update()),
        **overrides)


def _ingraph_trainer(torch, driver, config):
    """(learner, InGraphTrainer) of ``config``, through the driver's own
    ``build_*`` functions in ``train_ingraph``'s order."""
    device = torch.device(config.device)
    obs_spec, space, _ = driver.probe_env(config)
    env = driver.build_ingraph_env(config, obs_spec, space)
    agent = driver.build_agent(config, obs_spec, space, device)
    learner = driver.build_learner(config, agent)
    return learner, driver.build_ingraph_trainer(config, agent, learner, env)


def _range_device_ms(torch, fn, trace_path):
    """Device ms of ``fn``'s kernels by the in-graph ranges that launched
    them (``INGRAPH_RANGES``, else ``other``), from a torch.profiler trace:
    a kernel belongs to the innermost range around its launch on the
    launching thread, and a kernel launched by the autograd engine's
    thread (the backward) inside a ``learner_update`` range's time to
    that range.  Returns (ms by range, kernels recorded)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in INGRAPH_RANGES]
    launches = {(e.get("args") or {}).get("correlation"): e
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    inside = lambda r, ts: r["ts"] <= ts <= r["ts"] + r.get("dur", 0.0)
    ms = dict.fromkeys(INGRAPH_RANGES + ("other",), 0.0)
    kernels = 0
    for event in events:
        if event.get("cat") != "kernel":
            continue
        kernels += 1
        launch = launches.get((event.get("args") or {}).get("correlation"))
        name = "other"
        if launch is not None:
            ts = float(launch["ts"])
            around = [r for r in ranges if r.get("tid") == launch.get("tid")
                      and inside(r, ts)] or [
                r for r in ranges if r["name"] == "learner_update"
                and inside(r, ts)]
            if around:
                name = min(around, key=lambda r: r.get("dur", 0.0))["name"]
        ms[name] += float(event.get("dur", 0.0)) / 1e3
    return ms, kernels


def _state_equal(torch, a, b):
    """The learners' parameters and optimizer state bitwise equal."""
    sa, sb = a.state_dict(), b.state_dict()
    return all(torch.equal(sa[group][name], sb[group][name])
               for group in ("params", "opt_state")
               for name in sa[group])


def dispatch_alone(torch, driver, CheckpointManager, main, scratch, card):
    """The in-graph dispatch without the driver's loop, from phase 3t's
    K=1 checkpoint: 2 updates at K=2 against 2 at K=1 (params, optimizer
    state and the last loss bitwise equal), s per update at each K, one
    update's device time by range, and one K=2 dispatch under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    step, saved = CheckpointManager(main.logdir).restore()
    pairs = {}
    for k in (1, 2):
        learner, trainer = _ingraph_trainer(
            torch, driver, dataclasses.replace(main,
                                               updates_per_dispatch=k))
        learner.load_state_dict(saved)
        pairs[k] = [learner, trainer, trainer.init()]
    got = {}
    for k, pair in pairs.items():
        pair[2], metrics = pair[1].run(pair[2], 2, counter_start=step)
        got[k] = metrics
    torch.cuda.synchronize()
    same = _state_equal(torch, pairs[1][0], pairs[2][0])
    loss_same = torch.equal(got[1]["total_loss"], got[2]["total_loss"])
    print(f"  2 updates at K=2 from checkpoint step {step} against 2 at "
          f"K=1: parameters and optimizer state bitwise equal {same}, "
          f"last total_loss bitwise equal {loss_same} "
          f"({float(got[1]['total_loss']):.6f})", flush=True)
    if not (same and loss_same):
        raise AssertionError("the K=2 megaloop is not bitwise the K=1 "
                             "dispatches")
    counter = step + 2
    for k, (learner, trainer, carry) in pairs.items():
        t0 = time.monotonic()
        carry, _ = trainer.run(carry, INGRAPH_TIMED, counter_start=counter)
        torch.cuda.synchronize()
        per = (time.monotonic() - t0) / INGRAPH_TIMED
        pairs[k][2] = carry
        print(f"  in-graph K={k}: {per:.4f} s per update over "
              f"{INGRAPH_TIMED} updates after the first ({card})",
              flush=True)
    counter += INGRAPH_TIMED
    learner, trainer, carry = pairs[1]
    holder = [carry]

    def one_update():
        holder[0], _ = trainer.run(holder[0], 1, counter_start=counter)

    ms, kernels = _range_device_ms(
        torch, one_update, os.path.join(scratch, "ingraph_ranges.json"))
    print(f"  one in-graph update's device ms by range ({kernels} kernels "
          f"recorded): " + ", ".join(f"{name} {value:.4f}"
                                     for name, value in ms.items()),
          flush=True)
    learner, trainer, carry = pairs[2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, metrics = trainer.train_step(carry, counter)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    loss = float(metrics["total_loss"])
    print(f"  one K=2 dispatch under set_sync_debug_mode('error') raised "
          f"nothing (total_loss {loss:.6f})", flush=True)
    if not math.isfinite(loss):
        raise AssertionError("the dispatch under sync debug mode gave a "
                             "non-finite loss")


class _ProbedStream:
    """An env stream that records, when its worker closes it, whether its
    process had loaded torch, jax or the JAX package and had initialized
    CUDA (a json file per stream in ``marker_dir``)."""

    def __init__(self, stream, marker_dir):
        self._stream = stream
        self._marker_dir = marker_dir

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def close(self):
        torch = sys.modules.get("torch")
        record = {
            "pid": os.getpid(),
            "torch": torch is not None,
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "jax": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib",
                                                 "scalable_agent_tpu"))}
        path = os.path.join(self._marker_dir,
                            f"{os.getpid()}.{id(self)}.json")
        with open(path, "w") as f:
            json.dump(record, f)
        self._stream.close()


def probed_stream(marker_dir, *args, **kwargs):
    """``make_impala_stream`` wrapped in ``_ProbedStream`` (built in an env
    worker)."""
    from scalable_agent_tpu_torch.envs import make_impala_stream

    return _ProbedStream(make_impala_stream(*args, **kwargs), marker_dir)


def host_twin_stream(level, seed, actions, repeats, out_path):
    """An env worker's stream of ``level`` (its host twin, on the CPU) over
    ``actions``, saved to ``out_path`` with whether this process loaded
    torch and initialized CUDA (run in a spawned process)."""
    from scalable_agent_tpu_torch.envs import make_impala_stream

    stream = make_impala_stream(level, seed=seed,
                                num_action_repeats=repeats)
    outs = [stream.initial()] + [stream.step(int(a)) for a in actions]
    stream.close()
    import torch

    np_ = sys.modules["numpy"]
    np_.savez(out_path,
              frame=np_.stack([o.observation.frame for o in outs]),
              reward=np_.asarray([o.reward for o in outs], np_.float32),
              done=np_.asarray([o.done for o in outs]),
              episode_return=np_.asarray(
                  [o.info.episode_return for o in outs], np_.float32),
              episode_step=np_.asarray(
                  [o.info.episode_step for o in outs], np_.int32),
              torch="torch" in sys.modules,
              cuda=torch.cuda.is_initialized())


def host_backend_world(torch, driver, config, scratch, train_counted):
    """``device_minatar_breakout`` through the host backend's pool with 2
    env workers for 2 updates: every worker loaded torch, never jax, never
    initialized CUDA; then a spawned worker's 100-step stream of the same
    level against the card's world on the same seed and actions,
    bitwise."""
    import multiprocessing

    import numpy as np
    from scalable_agent_tpu_torch.envs.device import make_device_env

    level = "device_minatar_breakout"
    seed, repeats = 17, config.num_action_repeats
    env = make_device_env(level, num_action_repeats=repeats)
    actions = np.random.default_rng(seed).integers(
        0, env.num_actions, size=HOST_STREAM_STEPS)
    out_path = os.path.join(scratch, "host_twin_stream.npz")
    # The worker stream's process starts first and runs beside the pool.
    proc = multiprocessing.get_context("spawn").Process(
        target=host_twin_stream,
        args=(level, seed, actions, repeats, out_path))
    proc.start()
    markers = os.path.join(scratch, "worker_markers")
    os.makedirs(markers, exist_ok=True)
    cfg = dataclasses.replace(
        config, level_name=level, logdir=os.path.join(scratch, "host_world"),
        num_actors=config.batch_size, num_env_workers_per_group=2,
        total_environment_frames=float(2 * config.frames_per_update()),
        health_max_windows=0)
    try:
        with _patched(driver, make_impala_stream=functools.partial(
                probed_stream, markers)):
            launches = train_counted(cfg, 2, "_bf16", stem="stem_gradw_c4")
    except BaseException:
        proc.terminate()
        proc.join()
        raise
    records = []
    for name in sorted(os.listdir(markers)):
        with open(os.path.join(markers, name)) as f:
            records.append(json.load(f))
    pids = {r["pid"] for r in records}
    print(f"  host backend, {level}, 2 env workers: {len(records)} "
          f"streams closed in {len(pids)} worker processes; torch loaded "
          f"in {sum(r['torch'] for r in records)}, CUDA initialized in "
          f"{sum(r['cuda_initialized'] for r in records)}, jax or the JAX "
          f"package loaded in {sum(bool(r['jax']) for r in records)}",
          flush=True)
    if (len(pids) != 2 or len(records) != config.batch_size
            or not all(r["torch"] for r in records)
            or any(r["cuda_initialized"] or r["jax"] for r in records)):
        raise AssertionError("a device_ env worker initialized CUDA, "
                             "loaded jax, or did not run the host twin")
    proc.join(timeout=CLI_TIMEOUT_S)
    if proc.exitcode != 0:
        raise AssertionError(f"the host twin's stream process exited "
                             f"{proc.exitcode}")
    host = np.load(out_path)
    device = torch.device(config.device)
    state, out = env.initial([seed], device=device)
    card = [out]
    for a in actions:
        state, out = env.step(state, torch.tensor([int(a)], device=device))
        card.append(out)
    fields = {
        "frame": lambda o: o.observation.frame[0],
        "reward": lambda o: o.reward[0], "done": lambda o: o.done[0],
        "episode_return": lambda o: o.info.episode_return[0],
        "episode_step": lambda o: o.info.episode_step[0]}
    equal = {name: np.array_equal(
        host[name], torch.stack([get(o) for o in card]).cpu().numpy())
        for name, get in fields.items()}
    print(f"  the host twin's {HOST_STREAM_STEPS}-step stream in a spawned "
          f"worker (torch loaded {bool(host['torch'])}, CUDA initialized "
          f"{bool(host['cuda'])}) against the card's world, seed {seed}: "
          f"bitwise equal {equal}; {int(host['done'].sum())} dones",
          flush=True)
    if not all(equal.values()) or not host["torch"] or host["cuda"]:
        raise AssertionError("the host twin's stream differs from the "
                             "card's world, or its process touched CUDA")
    return launches


def ingraph_path(torch, driver, CheckpointManager, config, scratch,
                 train_counted, card):
    """Phase 3t: the in-graph backend on the card (module docstring).
    Returns the launch counts of its runs by label."""
    from scalable_agent_tpu_torch.envs.device import (
        DEVICE_LEVELS,
        conformance,
        make_device_env,
    )
    from scalable_agent_tpu_torch.ops import float32_precision

    launches = {}
    main = _ingraph_config(config, scratch, "ingraph_k1")
    for k in (1, 2):
        cfg = (main if k == 1 else _ingraph_config(
            config, scratch, "ingraph_k2", updates_per_dispatch=k))
        launches[f"K={k}"] = train_counted(cfg, INGRAPH_UPDATES, "_bf16")
        rows = _rows(cfg.logdir)
        if len(rows) != INGRAPH_UPDATES // k:
            raise AssertionError(f"K={k}: {len(rows)} metric rows, expected "
                                 f"one a dispatch")
        print(f"  K={k}: {len(rows)} metric rows (one a dispatch), the "
              f"last at update {rows[-1]['step']}", flush=True)
    with float32_precision():
        # As train_ingraph runs its dispatches.
        dispatch_alone(torch, driver, CheckpointManager, main, scratch,
                       card)
    for level in DEVICE_WORLDS:
        stem = _world_stem(make_device_env(level).observation_spec.frame.shape)
        launches[level] = train_counted(
            _ingraph_config(config, scratch, f"ingraph_{level}", level=level,
                            updates=INGRAPH_LEVEL_UPDATES),
            INGRAPH_LEVEL_UPDATES, "_bf16", stem=stem)
        if level in WORLD_F32_LEVELS:
            launches[level + " float32"] = train_counted(
                _ingraph_config(config, scratch, f"ingraph_{level}_f32",
                                level=level, updates=1,
                                compute_dtype="float32"),
                1, "", stem=stem)
    launches["host"] = host_backend_world(torch, driver, config, scratch,
                                          train_counted)
    t0 = time.monotonic()
    for level in sorted(DEVICE_LEVELS):
        ran = conformance.run_conformance(lambda: make_device_env(level),
                                          device=config.device)
        print(f"  conformance on {config.device}, {level}: "
              f"{', '.join(ran)} passed", flush=True)
    print(f"  the conformance matrix took {time.monotonic() - t0:.1f} s",
          flush=True)
    return launches


def world_launches(ingraph_launches):
    """The launches of phase 3t's runs at each new shape's kernels-line row:
    the grad-W at each frame of ``WORLD_FRAMES`` by the worlds of that
    frame, the LSTM at each width of ``WORLD_WIDTHS`` (D = 256 + 1 +
    actions) by its world; each world's frame and width read from its
    device env."""
    from scalable_agent_tpu_torch.envs.device import make_device_env

    counts = {}
    for level in DEVICE_WORLDS:
        env = make_device_env(level)
        frame = tuple(env.observation_spec.frame.shape)
        width = 256 + 1 + env.num_actions
        stem = _world_stem(frame)
        for run, suffix in ((level, "_bf16"), (level + " float32", "")):
            got = ingraph_launches.get(run)
            if got is None:
                continue
            if frame in WORLD_FRAMES:
                name = f"{stem}{suffix} {_frame_tag(frame)}"
                counts[name] = counts.get(name, 0) + got[stem + suffix]
            if width in WORLD_WIDTHS:
                for counter in ("lstm_fwd_lean", "lstm_fwd_resid",
                                "lstm_bptt"):
                    counts[f"{counter}{suffix} D={width}"] = got[
                        counter + suffix]
    return counts


def _early_late(returns, random_return):
    """The means of the first 3 and the last 5 episode_return rows."""
    if len(returns) < 8:
        raise AssertionError(f"too few episode_return rows: {returns}")
    early = sum(returns[:3]) / 3
    late = sum(returns[-5:]) / 5
    print(f"  episode_return: early {early:.3f}, late {late:.3f} "
          f"(random {random_return}, {len(returns)} rows; every 20th: "
          f"{[round(r, 2) for r in returns[::20]]})", flush=True)
    return early, late


def _learned(early, late, random_return):
    """tests/test_learning.py's curve: early rows near the random floor,
    late rows at least 2x it and at least one floor above early.  Returns
    the failed condition, or None."""
    if not early < 1.6 * random_return:
        return (f"early return {early:.2f} is not near the random floor "
                f"{random_return}")
    if not late >= 2.0 * random_return:
        return f"final return {late:.2f} did not reach 2x the random floor"
    if not late - early >= random_return:
        return f"return did not improve: early {early:.2f} late {late:.2f}"
    return None


def learn_bandit(Config, scratch, root):
    """fake_bandit through the pool on the card (tests/test_learning.py's
    settings), logged every update, once per seed of BANDIT_SEEDS, each a
    driver CLI subprocess, BANDIT_PARALLEL of them at a time (in one
    process the eight took 288-464 s of the script's 1200): every run must
    rise BANDIT_RISE above its early
    rows, and BANDIT_FULL runs must meet the full curve.  The health plane
    keeps its records and dumps but opens no profile window (3f drills
    those): a window's profiler and harvest are seconds of host time in a
    200-update run."""
    t, b = 16, 16
    full, stalled, flat = [], [], []
    runs = {}
    for seed in BANDIT_SEEDS:
        runs[seed] = Config(
            level_name="fake_bandit", device="cuda",
            logdir=os.path.join(scratch, f"bandit_seed{seed}"),
            height=16, width=16, num_actors=32, batch_size=b,
            unroll_length=t, num_action_repeats=1,
            total_environment_frames=float(BANDIT_UPDATES * t * b),
            learning_rate=0.002, entropy_cost=0.003,
            num_env_workers_per_group=2, log_interval_s=0.0,
            checkpoint_interval_s=3600.0, scan_impl="pallas", seed=seed,
            health_max_windows=0)
    env = dict(os.environ, PYTHONPATH=root)
    pending, running = list(runs), {}
    while pending or running:
        while pending and len(running) < BANDIT_PARALLEL:
            seed = pending.pop(0)
            log_file = open(os.path.join(scratch, f"bandit_{seed}.log"), "w")
            running[seed] = (subprocess.Popen(
                _cli(runs[seed]), cwd=root, env=env, stdout=log_file,
                stderr=subprocess.STDOUT), log_file, time.monotonic())
        time.sleep(1.0)
        for seed, (proc, log_file, t0) in list(running.items()):
            if proc.poll() is None:
                if time.monotonic() - t0 > CLI_TIMEOUT_S:
                    proc.kill()
                    proc.wait()
                else:
                    continue
            log_file.close()
            del running[seed]
            print(f"  seed {seed}: {BANDIT_UPDATES} updates, exit "
                  f"{proc.returncode} in {time.monotonic() - t0:.1f} s "
                  f"(start included)", flush=True)
            if proc.returncode != 0:
                with open(log_file.name) as f:
                    raise AssertionError(f"fake_bandit seed {seed} exited "
                                         f"{proc.returncode}:\n"
                                         f"{f.read()[-3000:]}")
    for seed, config in runs.items():
        _print_anomalies(config.logdir, f"seed {seed}")
        early, late = _early_late([r["episode_return"]
                                   for r in _rows(config.logdir)
                                   if "episode_return" in r], BANDIT_RANDOM)
        failure = _learned(early, late, BANDIT_RANDOM)
        if failure is None:
            full.append(seed)
            print(f"  seed {seed} met the full curve", flush=True)
        elif early < 1.6 * BANDIT_RANDOM and late - early >= BANDIT_RISE:
            stalled.append(seed)
            print(f"  seed {seed} rose {late - early:.2f} but stalled: "
                  f"{failure}", flush=True)
        else:
            flat.append(seed)
            print(f"  seed {seed} did not learn: {failure}", flush=True)
    print(f"  fake_bandit over seeds {list(BANDIT_SEEDS)}: full curve "
          f"{full}, stalled after rising {stalled}, did not rise {flat}",
          flush=True)
    if flat or len(full) < BANDIT_FULL:
        raise AssertionError(
            f"fake_bandit: seeds {flat} did not rise {BANDIT_RISE} (none "
            f"may), and {len(full)} met the full curve ({BANDIT_FULL} "
            f"needed)")


def _check_rows(rows, fpu, window, updates):
    """metrics.jsonl of a run logged every update, without rollback: one
    row per update in update order, row k carrying the update it retired
    from the in-flight window (k - window + 1), or update 1 while none
    has left it, with exact env_frames."""
    steps = [r["step"] for r in rows]
    frames = [r["env_frames"] for r in rows]
    want = [float(max(1, k - window + 1) * fpu) for k in range(1, updates + 1)]
    if steps != list(range(1, updates + 1)) or frames != want:
        raise AssertionError(f"metrics.jsonl steps {steps} env_frames "
                             f"{frames}, expected env_frames {want}")


@contextlib.contextmanager
def _patched(module, **attrs):
    """Replace attributes of ``module`` for the duration of a block."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _log_messages():
    """A handler on the port's logger that keeps its WARNING and ERROR
    messages (the rollback, retry and respawn lines)."""
    handler = logging.Handler(logging.WARNING)
    handler.messages = []
    handler.emit = lambda record: handler.messages.append(
        record.getMessage())
    return handler


def pool_trajectories(torch, driver, config, count):
    """``count`` full-width trajectories (numpy ActorOutputs) from one
    actor group of the main path, each a fresh unroll."""
    from scalable_agent_tpu_torch.runtime import VectorActor

    obs_spec, action_space, _ = driver.probe_env(config)
    agent = driver.build_agent(config, obs_spec, action_space,
                               torch.device(config.device))
    groups = driver.make_env_groups(
        dataclasses.replace(config, num_actors=config.batch_size),
        obs_spec.frame)
    actor = VectorActor(agent, groups[0], config.unroll_length,
                        seed=config.seed)
    try:
        return [actor.run_unroll() for _ in range(count)]
    finally:
        for envs in groups:
            envs.close()


def _leaves_equal(torch, got, want):
    from scalable_agent_tpu_torch.runtime.transport import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or a.shape != b.shape
                or not torch.equal(a, b))):
            return False
    return True


def compare_transports(torch, driver, device, outs):
    """Packed against per_leaf on the card: one trajectory bitwise, then
    PACKED_UPLOADS back-to-back packed uploads on a prefetch stream, each
    handed to the main stream by the driver's ``_adopt`` and read there
    by a dummy update long enough that the uploads run ahead of it (so
    the caching allocator is tempted to hand a buffer the main stream has
    not read yet to a later upload), each compared on the card with the
    per_leaf copy of the same batch."""
    from scalable_agent_tpu_torch.runtime.transport import (
        PackedTransport,
        PerLeafTransport,
        host_trajectory,
        tree_leaves,
    )

    hosts = [host_trajectory(out) for out in outs]
    refs = [PerLeafTransport(device).put(h)[0] for h in hosts]
    packed = PackedTransport(device)
    got, _ = packed.put(hosts[0])
    torch.cuda.synchronize()
    if not _leaves_equal(torch, got, refs[0]):
        raise AssertionError("packed trajectory differs from per_leaf")
    del got
    stream = torch.cuda.Stream(device)
    work = torch.randn(4096, 4096, device=device) / 64
    mismatches = torch.zeros((), dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(PACKED_UPLOADS):
        with torch.cuda.stream(stream):
            trajectory, owners = packed.put(hosts[i % len(hosts)])
            event = torch.cuda.Event()
            event.record(stream)
        trajectory = driver._adopt((trajectory, owners, event), device)
        for _ in range(DUMMY_MATMULS):
            work = torch.tanh(work @ work)
        for a, b in zip(tree_leaves(trajectory),
                        tree_leaves(refs[i % len(refs)])):
            if a is not None:
                mismatches += (a != b).sum()
        del trajectory, owners
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    if int(mismatches):
        raise AssertionError(f"{int(mismatches)} elements of the packed "
                             f"uploads differ from per_leaf")
    print(f"  packed == per_leaf bitwise: 1 trajectory, then "
          f"{PACKED_UPLOADS} back-to-back uploads read under a dummy update "
          f"({elapsed:.2f} s); staging buffer {packed.spec.shard_nbytes} "
          f"bytes", flush=True)


class _FixedPool:
    """Stands in for ``driver.ActorPool``: serves ``outs`` in order, the
    same data for every run, and keeps every snapshot it is given to
    publish."""

    def __init__(self, outs):
        self._outs = outs
        self._next = 0
        self.snapshots = []
        self.agent_steps = 0

    def __call__(self, agent, groups, unroll_length, **kwargs):
        return self

    def set_params(self, agent, version=None):
        from scalable_agent_tpu_torch.runtime.actor import (
            snapshot_params_for_inference,
        )

        self.snapshots.append(snapshot_params_for_inference(agent, version))

    def start(self):
        return self

    def get_trajectory(self, timeout=None):
        out = self._outs[self._next % len(self._outs)]
        self._next += 1
        return out

    def stop(self):
        pass

    def episode_stats(self):
        return []

    def drain_level_stats(self):
        return {}


def compare_windows(torch, driver, CheckpointManager, config, outs,
                    scratch):
    """Two runs of UPDATES updates at full width from one seed on the
    same trajectories, at inflight_updates 2 and 1: every update's loss,
    every published weight snapshot and the final parameters and RMSProp
    state must be bitwise equal."""
    fpu = config.frames_per_update()
    runs = {}
    for window in (2, 1):
        logdir = os.path.join(scratch, f"window{window}")
        pool = _FixedPool(outs)
        with _patched(driver, ActorPool=pool,
                      make_env_groups=lambda config, spec, *rest: []):
            metrics = driver.train(dataclasses.replace(
                config, logdir=logdir, inflight_updates=window,
                total_environment_frames=float(UPDATES * fpu)))
        rows = _rows(logdir)
        _check_rows(rows, fpu, window, UPDATES)
        losses = {r["env_frames"]: r["total_loss"] for r in rows}
        losses[metrics["env_frames"]] = metrics["total_loss"]
        step, saved = CheckpointManager(logdir).restore()
        runs[window] = (losses, pool.snapshots, step, saved)
    (loss2, snaps2, step2, saved2), (loss1, snaps1, step1, saved1) = (
        runs[2], runs[1])
    if loss2 != loss1 or sorted(loss1) != [
            float(k * fpu) for k in range(1, UPDATES + 1)]:
        raise AssertionError(f"losses by env_frames differ: window 2 "
                             f"{loss2}, window 1 {loss1}")
    if len(snaps2) != len(snaps1) or not all(
            torch.equal(a, b) for s2, s1 in zip(snaps2, snaps1)
            for a, b in zip(s2.tensors, s1.tensors)):
        raise AssertionError("published weight snapshots differ between "
                             "windows 2 and 1")
    if step2 != step1 or not all(
            torch.equal(saved2[group][name], saved1[group][name])
            for group in ("params", "opt_state") for name in saved1[group]):
        raise AssertionError("final parameters or RMSProp state differ "
                             "between windows 2 and 1")
    print(f"  inflight_updates 2 == 1 bitwise over {UPDATES} updates: "
          f"losses {[loss1[k] for k in sorted(loss1)]}, "
          f"{len(snaps1)} weight snapshots, final params and nu", flush=True)


def _cli(config):
    """The driver's CLI for ``config``: a flag for every field that
    differs from its default."""
    return ([sys.executable, "-m", "scalable_agent_tpu_torch.driver"]
            + config.to_argv())


def _run_cli(root, cmd, timeout, env=None):
    env = dict(os.environ, PYTHONPATH=root, **(env or {}))
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc, time.monotonic() - t0


def rollback_drill(driver, config, scratch, root):
    """Full width: NaN gradients on updates 3-5 with a tolerance of 3 and
    a checkpoint every update; the run rolls back once to a verified step
    and completes, counting 3 skips.  The same run under --no_rollback,
    as a CLI subprocess, exits 71."""
    fpu = config.frames_per_update()
    spec, frames = "nan_grad@3:4:5", float(ROLLBACK_UPDATES * fpu)
    drill = dataclasses.replace(
        config, logdir=os.path.join(scratch, "rollback"), chaos_spec=spec,
        nonfinite_tolerance=3, checkpoint_interval_s=0.0,
        total_environment_frames=frames)
    # The --no_rollback CLI runs beside the in-process drill (its start is
    # most of its time on the card).
    t0 = time.monotonic()
    stderr_path = os.path.join(scratch, "no_rollback.log")
    with open(stderr_path, "w") as stderr_file:
        no_rollback = subprocess.Popen(
            _cli(dataclasses.replace(
                drill, logdir=os.path.join(scratch, "no_rollback"),
                no_rollback=True)), cwd=root,
            env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.DEVNULL, stderr=stderr_file)
    handler = _log_messages()
    logger = logging.getLogger("scalable_agent_tpu_torch")
    logger.addHandler(handler)
    try:
        metrics = driver.train(drill)
    finally:
        logger.removeHandler(handler)
    rollbacks = [m for m in handler.messages if "rolled back" in m]
    print(f"  rollback drill ({spec}, tolerance 3, {ROLLBACK_UPDATES} "
          f"updates): {rollbacks}; final env_frames "
          f"{metrics['env_frames']}, nonfinite_skips "
          f"{metrics['nonfinite_skips']}, total_loss "
          f"{metrics['total_loss']}", flush=True)
    if (len(rollbacks) != 1 or metrics["env_frames"] != frames
            or metrics["nonfinite_skips"] != 3.0
            or not math.isfinite(metrics["total_loss"])):
        raise AssertionError("the rollback drill did not roll back once "
                             "and complete with 3 skips")
    try:
        no_rollback.wait(timeout=CLI_TIMEOUT_S)
    finally:
        if no_rollback.poll() is None:
            no_rollback.kill()
            no_rollback.wait()
    print(f"  --no_rollback: exit {no_rollback.returncode} in "
          f"{time.monotonic() - t0:.1f} s (beside the drill)", flush=True)
    if no_rollback.returncode != 71:
        with open(stderr_path) as f:
            raise AssertionError(f"--no_rollback exited "
                                 f"{no_rollback.returncode}, not 71:\n"
                                 f"{f.read()[-3000:]}")


def preemption_drill(CheckpointManager, config, scratch, root):
    """A CLI subprocess SIGTERMs itself (preempt_sigterm) with a 30 s
    grace: exit 0 and a final checkpoint that verifies, its env_frames
    the update count times frames per update; the same command then
    resumes from exactly that step."""
    fpu = config.frames_per_update()
    logdir = os.path.join(scratch, "preempt")
    proc, elapsed = _run_cli(root, _cli(dataclasses.replace(
        config, logdir=logdir, chaos_spec=f"preempt_sigterm@{PREEMPT_CYCLE}",
        preemption_grace_s=30.0, total_environment_frames=1e9)),
        CLI_TIMEOUT_S)
    ckpt = CheckpointManager(logdir)
    restored = ckpt.restore() if proc.returncode == 0 else None
    if restored is None:
        raise AssertionError(f"the preempted run exited {proc.returncode} "
                             f"without a checkpoint:\n{proc.stderr[-3000:]}")
    step, saved = restored
    ok, why = ckpt.verify(step, saved)
    print(f"  preemption drill: exit 0 in {elapsed:.1f} s, final checkpoint "
          f"step {step} verified {ok}, env_frames {saved['env_frames']}",
          flush=True)
    if not ok or step < 1 or saved["env_frames"] != step * fpu:
        raise AssertionError(f"the preempted run's final checkpoint: step "
                             f"{step}, verified {ok} ({why}), env_frames "
                             f"{saved['env_frames']}")
    target = (step + 2) * fpu
    proc, elapsed = _run_cli(root, _cli(dataclasses.replace(
        config, logdir=logdir, total_environment_frames=float(target))),
        CLI_TIMEOUT_S)
    resumed = re.search(r"restored checkpoint at update (\d+)", proc.stderr)
    final_step, final = CheckpointManager(logdir).restore()
    print(f"  resume: exit {proc.returncode} in {elapsed:.1f} s, restored "
          f"update {resumed and resumed.group(1)}, final step {final_step} "
          f"env_frames {final['env_frames']}", flush=True)
    if (proc.returncode != 0 or not resumed or int(resumed.group(1)) != step
            or final_step != step + 2 or final["env_frames"] != target):
        raise AssertionError(f"the resume did not continue from step "
                             f"{step}:\n{proc.stderr[-3000:]}")


def fault_points(driver, faults, CheckpointManager, config, scratch):
    """actor_raise@1, worker_kill@2 and ckpt_save_fail@1 in one run of
    UPDATES updates: it completes, and the pool's restart count, the env
    workers' respawn count and the checkpoint manager's save failures
    read one each.  Then ckpt_torn@1 tears a newer step on top of that
    run's final checkpoint, and the restore walks back to it."""
    pools, managers = [], []

    class Pool(driver.ActorPool):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pools.append(self)

    class Manager(driver.CheckpointManager):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            managers.append(self)

    fpu = config.frames_per_update()
    logdir = os.path.join(scratch, "faults")
    spec = "actor_raise@1;worker_kill@2;ckpt_save_fail@1"
    with _patched(driver, ActorPool=Pool, CheckpointManager=Manager):
        metrics = driver.train(dataclasses.replace(
            config, logdir=logdir, chaos_spec=spec,
            total_environment_frames=float(UPDATES * fpu)))
    restarts = pools[0].restarts
    respawns = sum(actor.envs.total_respawns for actor in pools[0].actors)
    failures = managers[0].save_failures
    print(f"  fault points ({spec}): env_frames {metrics['env_frames']}, "
          f"actor restarts {restarts}, env worker respawns {respawns}, "
          f"checkpoint save failures {failures}", flush=True)
    if (metrics["env_frames"] != UPDATES * fpu
            or not math.isfinite(metrics["total_loss"])
            or (restarts, respawns, failures) != (1, 1, 1)):
        raise AssertionError("the fault points were not each recovered "
                             "once")
    ckpt = CheckpointManager(logdir)
    step, saved = ckpt.restore()
    faults.configure_faults("ckpt_torn@1")
    try:
        ckpt.maybe_save(step + 1, saved, force=True)
    finally:
        faults.configure_faults("")
    walked = CheckpointManager(logdir)
    got, _ = walked.restore()
    print(f"  ckpt_torn@1 on step {step + 1}: restore walked back to step "
          f"{got} ({walked.restore_fallbacks} fallback)", flush=True)
    if got != step or walked.restore_fallbacks != 1:
        raise AssertionError("the restore did not walk back past the torn "
                             "step")


def remat_and_two_pass(torch, driver, config, out, reset_counts,
                       read_counts):
    """One update from the same weights and batch under the default,
    ``remat_torso=on`` and ``fused_forward=false``, launch counters read
    around each: the same kernels (the two-pass update's residual forward
    twice); remat bitwise equal to the default; the two-pass update
    bitwise too, or within the learner tests' rtol 1e-4 on the losses
    (printed)."""
    from scalable_agent_tpu_torch.runtime.transport import (
        PerLeafTransport,
        host_trajectory,
    )

    device = torch.device(config.device)
    obs_spec, action_space, _ = driver.probe_env(config)
    traj, _ = PerLeafTransport(device).put(host_trajectory(out))
    results = {}
    for name, variant in (
            ("default", config),
            ("remat_torso=on", dataclasses.replace(config, remat_torso="on")),
            ("fused_forward=false",
             dataclasses.replace(config, fused_forward=False))):
        agent = driver.build_agent(variant, obs_spec, action_space, device)
        learner = driver.build_learner(variant, agent)
        reset_counts()
        metrics = learner.update(traj)
        torch.cuda.synchronize()
        launches = read_counts()
        results[name] = ({k: float(v) for k, v in metrics.items()},
                         [p.detach().clone() for p in agent.parameters()])
        want = {"lstm_fwd_resid_bf16": 2 if name.startswith("fused") else 1,
                "lstm_bptt_bf16": 1, "stem_gradw_bf16": 1, "vtrace_fused": 1,
                "lstm_fwd_lean_bf16": 0}
        print(f"  {name}: 1 update, total_loss {metrics['total_loss']}, "
              f"launches {launches}", flush=True)
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{name} launched {launches}, expected "
                                 f"{want}")
    base_losses, base_params = results["default"]
    for name in ("remat_torso=on", "fused_forward=false"):
        losses, params = results[name]
        bitwise = losses == base_losses and all(
            torch.equal(a, b) for a, b in zip(params, base_params))
        print(f"  {name} against the default update: bitwise {bitwise}",
              flush=True)
        if bitwise:
            continue
        worst = max(abs(losses[k] - base_losses[k]) / max(
            abs(base_losses[k]), 1e-6) for k in (
                "total_loss", "policy_gradient_loss", "baseline_loss",
                "entropy_loss"))
        print(f"  {name}: largest relative loss difference {worst:.3e}",
              flush=True)
        if name.startswith("remat") or not worst <= 1e-4:
            raise AssertionError(f"{name} does not hold against the "
                                 f"default update")


def obs_artifacts(logdir):
    """Phase 3's logdir under the planes' defaults plus --trace: the
    metrics families and the trace's spans."""
    from scalable_agent_tpu_torch.obs import load_trace_events

    with open(os.path.join(logdir, "metrics.prom")) as f:
        families = {line.split()[2] for line in f
                    if line.startswith("# TYPE")}
    counts = {prefix: sum(f.startswith(prefix) for f in families)
              for prefix in ("impala_devtel_learner_", "impala_devtel_learn_",
                             "impala_ledger_", "impala_stall_")}
    traces = [n for n in os.listdir(logdir) if n.startswith("trace.p0.")]
    names = {}
    for event in load_trace_events(os.path.join(logdir, traces[0])):
        names[event["name"]] = names.get(event["name"], 0) + 1
    want = ("actor/inference", "actor/env_step", "transport/pack",
            "transport/upload", "transport/unpack", "learner/update",
            "checkpoint/save")
    tensorboard = os.path.isdir(os.path.join(logdir, "summaries"))
    print(f"  phase 3's metrics.prom: {len(families)} families, by prefix "
          f"{counts}; {traces[0]}: spans "
          f"{ {n: names.get(n, 0) for n in want} }; TensorBoard summaries "
          f"written (tensorboardX imports): {tensorboard}", flush=True)
    if not all(counts.values()) or not all(names.get(n) for n in want):
        raise AssertionError("phase 3's logdir lacks an obs family or "
                             "span")


def _devtel_diff(got, want):
    """The largest scale-floored relative difference over two fetches."""
    if got.keys() != want.keys():
        raise AssertionError(f"telemetry keys differ: "
                             f"{sorted(set(got) ^ set(want))}")
    worst = 0.0
    for key in want:
        a, b = got[key].astype("float64"), want[key].astype("float64")
        scale = max(float(abs(b).max()), 1e-3)
        worst = max(worst, float(abs(a - b).max()) / scale)
    return worst


def telemetry_in_the_update(torch, driver, config, out):
    """The update with both telemetry specs: a warm update under
    set_sync_debug_mode("error") raises nothing, and its telemetry equals
    a twin learner's same update under the default mode; then the cost
    of the learning telemetry, the update alone with learn_telemetry on
    and off (interleaved): host ms per call, device ms from
    torch.profiler."""
    from scalable_agent_tpu_torch.runtime.transport import (
        PerLeafTransport,
        host_trajectory,
    )

    device = torch.device(config.device)
    obs_spec, action_space, _ = driver.probe_env(config)
    traj, _ = PerLeafTransport(device).put(host_trajectory(out))

    def learner_for(learn):
        variant = dataclasses.replace(config, learn_telemetry=learn)
        agent = driver.build_agent(variant, obs_spec, action_space, device)
        return driver.build_learner(variant, agent)

    learners = {True: learner_for(True), False: learner_for(False)}
    twin = learner_for(True)
    for learner in (learners[True], twin):
        learner.update(traj)  # warm: every kernel built and planned
    twin.update(traj)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        learners[True].update(traj)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = learners[True].fetch_device_telemetry()
    want = twin.fetch_device_telemetry()
    diff = _devtel_diff(got, want)
    bitwise = all((got[k] == want[k]).all() for k in want)
    print(f"  sync debug mode \"error\": the warm update with both specs "
          f"raised nothing; its {len(got)} telemetry leaves against the "
          f"default mode's: bitwise {bitwise}, largest relative "
          f"difference {diff:.3e}", flush=True)
    if not diff <= 1e-6:
        raise AssertionError("the telemetry under sync debug mode differs "
                             "from the default mode's")
    runs = {True: [], False: []}
    for learn in (True, False, True, False):
        learner = learners[learn]
        learner.update(traj)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TELEMETRY_UPDATES):
            learner.update(traj)
        host_ms = 1e3 * (time.perf_counter() - t0) / TELEMETRY_UPDATES
        torch.cuda.synchronize()
        busy_ms = sum(_kernel_ms(torch, lambda: learner.update(traj),
                                 3).values())
        runs[learn].append((host_ms, busy_ms))
    mean = lambda xs: sum(xs) / len(xs)
    on_host, off_host = (mean([h for h, _ in runs[k]]) for k in (True,
                                                                 False))
    on_dev, off_dev = (mean([d for _, d in runs[k]]) for k in (True, False))
    print(f"  the update alone, learn_telemetry on against off ("
          f"{TELEMETRY_UPDATES} calls per arm, on/off/on/off): host "
          f"{on_host:.3f} against {off_host:.3f} ms per call (+"
          f"{on_host - off_host:.3f}), device {on_dev:.4f} against "
          f"{off_dev:.4f} ms per update (+{on_dev - off_dev:.4f}); runs "
          f"{runs}", flush=True)


def obs_cost_in_the_loop(torch, driver, config, scratch):
    """The pool loop's s per update with the planes at their defaults plus
    --trace against all of them off, one run each; then the planes-on
    run's stall verdicts, dominant ledger segment and live MFU from its
    registry rows."""
    on = dataclasses.replace(config, trace=True)
    off = dataclasses.replace(config, learn_telemetry=False,
                              watchdog_timeout_s=0.0)
    s_per_update = {"on": [], "off": []}
    readings = []
    for name in ("on", "off"):
        logdir = os.path.join(scratch, f"obs_{name}{len(s_per_update[name])}")
        print(f"  planes {name}:", flush=True)
        s_per_update[name].append(pool_steady_state(
            torch, driver, on if name == "on" else off, logdir,
            updates=OBS_POOL_UPDATES))
        if name == "on":
            readings.append(_registry_readings(logdir))
    mean = lambda xs: sum(xs) / len(xs)
    on_s, off_s = mean(s_per_update["on"]), mean(s_per_update["off"])
    print(f"  pool loop s per update, planes on + trace against off (one "
          f"run each, on then off: drift between them is not balanced): "
          f"{on_s:.4f} against {off_s:.4f} ({100 * (on_s / off_s - 1):+.2f}"
          f"%); runs {s_per_update}", flush=True)
    return readings


def _registry_readings(logdir):
    """From a planes-on pool run's registry rows: the stall verdicts of
    updates 3..N, the last interval's verdict, ledger segment shares and
    ``ledger/mfu``."""
    rows = [r for r in _all_rows(logdir) if _is_registry_row(r)]
    first, last = rows[1], rows[-1]
    verdicts = {}
    for category in ("device_bound", "env_bound", "learner_starved",
                     "stalled_thread"):
        key = f"obs/stall/intervals_{category}_total"
        verdicts[category] = last[key] - first[key]
    latest = next(c for c in verdicts
                  if last[f"obs/stall/is_{c}"] == 1.0)
    shares = {k.rsplit("/", 1)[1]: v for k, v in last.items()
              if k.startswith("obs/ledger/latency_share/")}
    dominant = max(shares, key=shares.get)
    return {"verdicts_of_updates_3_on": verdicts, "last_verdict": latest,
            "wait_frac": last["obs/stall/frac_wait_batch"],
            "dominant_segment": dominant, "shares": shares,
            "rho": {k.rsplit("/", 1)[1]: v for k, v in last.items()
                    if k.startswith("obs/ledger/rho/")},
            "mfu": last["obs/ledger/mfu"],
            "staleness_p50_s": last["obs/ledger/staleness_s/p50"]}


def _print_anomalies(logdir, label):
    """Each anomaly record of a run's anomalies.jsonl, one line each."""
    from scalable_agent_tpu_torch.obs import read_anomalies

    records = read_anomalies(logdir)
    print(f"  {label}: {len(records)} anomaly records", flush=True)
    for r in records:
        window = r.get("window") or {}
        print(f"    {r['id']} update {r.get('update')} observed "
              f"{r.get('observed')} baseline {r.get('baseline')} rel "
              f"{r.get('rel')} verdict {r.get('verdict')} pinned "
              f"{(r.get('flightrec') or {}).get('pinned')} window "
              f"{window.get('status')}", flush=True)
    return records


def _check_table(path, executions):
    """A kernel table of the bf16 update: every row's time is finite and
    every hand-written kernel of TABLE_KERNELS is a row; prints each
    one's ms per call beside PERF.md section 6's, and the table's verdicts
    and its dominant cuDNN convolution."""
    table = json.load(open(path))
    rows = table["kernels"]
    bad = [r["name"] for r in rows + table["unmatched_events"]
           if not math.isfinite(r["time_us"])]
    if bad:
        raise AssertionError(f"{os.path.basename(path)}: time_us not "
                             f"finite for {bad}")
    print(f"  {os.path.basename(path)}: {len(rows)} costed rows, "
          f"matched_time_frac {table['matched_time_frac']:.4f}, "
          f"executions {table['executions']}, flops_scale "
          f"{table['flops_scale']:.6g}; dominant {table['dominant_kernel']}"
          f" ({table['dominant_time_share']:.3f} of matched time); worst "
          f"{table['worst_kernel']} (mfu {table['worst_kernel_mfu']}); "
          f"scopes {table['scope_time_shares']}", flush=True)
    groups = {}
    for label, prefix, part in TABLE_KERNELS:
        found = [r for r in rows
                 if r["name"].startswith(prefix) and part in r["name"]]
        if not found:
            raise AssertionError(f"{os.path.basename(path)} has no row "
                                 f"{prefix}...{part}")
        for row in found:
            ms = row["time_us"] / row["calls"] / 1e3
            groups[label] = groups.get(label, 0.0) + ms
            print(f"    {row['name']}: {row['calls']} calls, {ms:.4f} ms "
                  f"per call, mfu {row['mfu']:.4g}, {row['op']}",
                  flush=True)
            if row["calls"] != executions:
                print(f"    ({row['calls']} calls in {executions} "
                      f"updates)", flush=True)
    for label, ms in groups.items():
        print(f"    {label}: {ms:.4f} ms per update here, "
              f"{SECTION6_MS[label]:.4f} in PERF.md section 6", flush=True)
    convs = [r for r in rows if r["op"] == "aten::convolution"]
    if convs:
        top = convs[0]
        print(f"    largest aten::convolution kernel: {top['name'][:100]}"
              f" {top['time_us'] / top['calls'] / 1e3:.4f} ms per call "
              f"({top['calls']} calls), input dims {top.get('input_dims')}",
              flush=True)
    for row in rows[:6]:
        print(f"    top: {row['time_us'] / 1e3 / executions:.4f} ms per "
              f"update, {row['op']}, {row['name'][:90]}", flush=True)
    print(f"    unmatched: {table['unmatched_events'][:4]}", flush=True)
    return table


def health_drill(torch, driver, config, scratch):
    """Phase 3f: the run-health plane on the main path.  A profile
    window tabling updates 1-2 (the baseline), a warm-up of 3 intervals, one
    sag at HEALTH_SAG_AT: a throughput record whose window finished, a
    pinned flight-recorder dump, one health_profile.* directory, and
    kernels.json and kernels.<id>.json naming every hand-written kernel
    of the bf16 update.  Prints the plane's host cost."""
    logdir = os.path.join(scratch, "health")
    sag = dataclasses.replace(
        config, logdir=logdir,
        total_environment_frames=float(
            HEALTH_UPDATES * config.frames_per_update()),
        chaos_spec=f"throughput_sag@{HEALTH_SAG_AT}",
        # The z path off and the relative threshold at HEALTH_REL: only
        # the sag may claim the one window.
        health_z_threshold=HEALTH_Z_OFF, health_rel_threshold=HEALTH_REL,
        health_warmup_intervals=3, health_max_windows=1,
        health_window_updates=2,
        profile_dir=os.path.join(logdir, "profile"),
        profile_start_update=0, profile_num_updates=2)
    step_ms, snapshot_ms, harvest_s = [], [], []
    plane_step = driver._HealthPlane.step
    harvest = driver._harvest_kernel_ledger

    def timed_step(self, metrics, *args, **kwargs):
        t0 = time.perf_counter()
        plane_step(self, metrics, *args, **kwargs)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        driver.get_registry().snapshot()
        snapshot_ms.append(1e3 * (time.perf_counter() - t0))

    def timed_harvest(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return harvest(*args, **kwargs)
        finally:
            harvest_s.append(time.perf_counter() - t0)

    os.environ["SCALABLE_AGENT_THROUGHPUT_SAG_S"] = str(HEALTH_SAG_S)
    t0 = time.monotonic()
    try:
        with _patched(driver._HealthPlane, step=timed_step), \
                _patched(driver, _harvest_kernel_ledger=timed_harvest):
            metrics = driver.train(sag)
    finally:
        del os.environ["SCALABLE_AGENT_THROUGHPUT_SAG_S"]
    print(f"  {HEALTH_UPDATES} updates with a {HEALTH_SAG_S} s sag at "
          f"update {HEALTH_SAG_AT} in {time.monotonic() - t0:.1f} s; "
          f"env_frames {metrics['env_frames']}", flush=True)
    records = _print_anomalies(logdir, "sag drill")
    throughput = [r for r in records if r["detector"] == "throughput"]
    if (len(throughput) != 1 or throughput[0]["update"] != HEALTH_SAG_AT
            or throughput[0]["window"]["status"] != "done"):
        raise AssertionError(f"no throughput record of the sag's interval "
                             f"with a finished window: {records}")
    record = throughput[0]
    # The first trip pins the flight recorder; every later dump keeps it.
    pinned = [r for r in records if r["flightrec"]["pinned"]]
    dumps = [n for n in os.listdir(logdir) if n.startswith("flightrec.")]
    reason = json.load(open(os.path.join(logdir, dumps[0])))["reason"] if (
        dumps) else None
    windows = [n for n in os.listdir(logdir)
               if n.startswith("health_profile.")]
    print(f"  window {record['window']}; flight recorder {dumps} reason "
          f"{reason}, pinned by {[r['id'] for r in pinned]}; profile "
          f"windows {windows}", flush=True)
    if not (len(pinned) == 1 and reason == f"health:{pinned[0]['id']}"
            and len(windows) == 1):
        raise AssertionError("no trip pinned the flight recorder's dump, "
                             "or not exactly one window opened")
    for name, executions in (("kernels.json", sag.profile_num_updates),
                             (f"kernels.{record['id']}.json",
                              sag.health_window_updates)):
        _check_table(os.path.join(logdir, name), executions)
    update_s = [r["timing/update"] for r in _rows(logdir)
                if r["step"] < HEALTH_SAG_AT][-1]
    per_interval_ms = (sum(step_ms) + sum(snapshot_ms)) / len(step_ms)
    print(f"  health.step: {len(step_ms)} calls, "
          f"{sum(step_ms) / len(step_ms):.3f} ms per call (median "
          f"{sorted(step_ms)[len(step_ms) // 2]:.3f}, max "
          f"{max(step_ms):.3f}: the trips' dumps included), "
          f"registry snapshot {sum(snapshot_ms) / len(snapshot_ms):.3f} ms; "
          f"per interval {per_interval_ms:.3f} ms = "
          f"{per_interval_ms / 1e3 / HEALTH_LOG_INTERVAL_S:.5%} of a "
          f"{HEALTH_LOG_INTERVAL_S:.0f} s log interval (the JAX budget: "
          f"{HEALTH_BUDGET_FRAC:.1%}), {per_interval_ms / 1e3 / update_s:.4%}"
          f" of the update stage ({update_s:.4f} s, the mean of updates "
          f"1-{HEALTH_SAG_AT - 1}) at one interval per update; harvests "
          f"{[round(h, 3) for h in harvest_s]} s",
          flush=True)
    return logdir


def _same_value(a, b):
    return a == b or (a != a and b != b)


def read_logdir(root, logdir, label):
    """Phase 3g: the four obs CLIs as subprocesses on a logdir the card
    wrote (report, diagnose and watch before aggregate, whose
    metrics.fleet.prom the others would read instead).  None may exit 2
    (diagnose exits 1 when a verdict fired); the report's dominant stage
    is the largest ledger/latency_share/* of metrics.prom; its kernels
    section names every hand-written kernel of kernels.json; the
    one-process fold of metrics.fleet.prom equals every series of
    metrics.prom.  Returns each CLI's wall seconds."""
    from scalable_agent_tpu_torch.obs.aggregate import (
        FLEET_PROM_NAME,
        MERGED_TRACE_NAME,
        parse_prometheus,
    )
    from scalable_agent_tpu_torch.obs.ledger import SEGMENTS

    outs, seconds = {}, {}
    for name, args in (("report", ["--json", logdir]),
                       ("diagnose", ["--json", logdir]),
                       ("watch", [logdir, "--once", "--json"]),
                       ("aggregate", [logdir])):
        proc, seconds[name] = _run_cli(root, [
            sys.executable, "-m", f"scalable_agent_tpu_torch.obs.{name}",
            *args], CLI_TIMEOUT_S)
        if proc.returncode not in ((0, 1) if name == "diagnose" else (0,)):
            raise AssertionError(f"obs.{name} on {label}'s logdir exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        outs[name] = proc
    print(f"  {label}: CLI wall seconds "
          f"{ {k: round(v, 3) for k, v in seconds.items()} }", flush=True)

    report = json.loads(outs["report"].stdout)
    for name, _, _ in SEGMENTS:
        stage = report["stages"][name]
        print(f"    {name:<13} rate/s {stage['rate_per_s']} rho "
              f"{stage['rho']} mean_s {stage['mean_s']} p95_s "
              f"{stage['p95_s']} share {stage['latency_share']}",
              flush=True)
    kernels = report["kernels"] or {}
    print(f"    report: dominant_stage {report['dominant_stage']}, "
          f"stall_verdict {report['stall_verdict']}, mfu {report['mfu']}; "
          f"kernels dominant {kernels.get('dominant')}, worst "
          f"{kernels.get('worst')} (mfu {kernels.get('worst_mfu')})",
          flush=True)
    with open(os.path.join(logdir, "metrics.prom")) as f:
        families = parse_prometheus(f.read())
    shares = {}
    for name, _, _ in SEGMENTS:
        family = f"impala_ledger_latency_share_{name}"
        if family in families:
            shares[name] = families[family]["series"][(family, ())]
    largest = max(shares, key=shares.get) if shares else None
    if (report["dominant_stage"] or {}).get("name") != largest:
        raise AssertionError(f"the report's dominant stage "
                             f"{report['dominant_stage']} is not the largest "
                             f"latency share of metrics.prom {shares}")
    path = os.path.join(logdir, "kernels.json")
    if os.path.exists(path):
        with open(path) as f:
            handwritten = {r["name"] for r in json.load(f)["kernels"]
                           if str(r.get("op", "")).startswith("csrc/")}
        missing = handwritten - {r["name"] for r in kernels["rows"]}
        print(f"    kernels.json: {len(handwritten)} hand-written kernels, "
              f"all in the report's kernels section: {not missing}",
              flush=True)
        if not handwritten or missing:
            raise AssertionError(f"the report's kernels section lacks "
                                 f"{sorted(missing)} (of {handwritten})")

    diagnosis = json.loads(outs["diagnose"].stdout)
    print(f"    diagnose: exit {outs['diagnose'].returncode}, verdicts "
          f"{[v['name'] for v in diagnosis['verdicts']]}", flush=True)
    payload = json.loads(outs["watch"].stdout)
    print(f"    watch: verdict {payload['verdict']['category']}, dominant "
          f"segment {payload['verdict']['dominant_segment']}, anomalies "
          f"{payload['health']['anomalies']}", flush=True)

    with open(os.path.join(logdir, FLEET_PROM_NAME)) as f:
        fleet = parse_prometheus(f.read())
    bad = []
    for family, data in families.items():
        series = fleet.get(family, {"series": {}})["series"]
        for (metric, labels), value in data["series"].items():
            folded = [v for (m, ls), v in series.items()
                      if m == metric and dict(ls).get("process", "0") == "0"
                      and tuple(kv for kv in ls
                                if kv[0] not in ("process", "fold"))
                      == labels]
            if len(folded) != 2 or not all(_same_value(v, value)
                                           for v in folded):
                bad.append((metric, labels, value, folded))
    merged = os.path.join(logdir, MERGED_TRACE_NAME)
    if os.path.exists(merged):
        with open(merged) as f:
            events = len(json.load(f))
        trace = (f"{MERGED_TRACE_NAME} {events} events, aligned "
                 f"{'UNALIGNED' not in outs['aggregate'].stdout}")
    else:
        trace = "no trace"
    print(f"    aggregate: {trace}; {FLEET_PROM_NAME}: the one-process fold "
          f"of {sum(len(d['series']) for d in families.values())} series "
          f"in {len(families)} families equals metrics.prom: {not bad}",
          flush=True)
    if bad:
        raise AssertionError(f"metrics.fleet.prom differs from metrics.prom "
                             f"for {bad[:5]}")
    return seconds


def _scrape(port, route):
    """(status, round-trip ms, body) of one GET; (None, None, None) when
    nothing listens."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as reply:
            status, body = reply.status, reply.read()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, b""
    except OSError:
        return None, None, None
    return status, 1e3 * (time.perf_counter() - t0), body


# What obs.watch reads of a logdir.
WATCHED = ("metrics.prom", "anomalies.jsonl", "fleet_epochs.jsonl")


def _watched_stat(logdir):
    stats = []
    for name in WATCHED:
        try:
            st = os.stat(os.path.join(logdir, name))
        except FileNotFoundError:
            continue
        stats.append((name, st.st_ino, st.st_mtime_ns, st.st_size))
    return stats


def live_endpoint(root, config, scratch, pool_s):
    """Phase 3g: the main path for LIVE_UPDATES updates as a driver
    subprocess with --metrics_http_port, scraped every SCRAPE_EVERY_S:
    /metrics from the start, /health and /anomalies once metrics.prom
    exists.  Every answer is 200 (nothing listens before the server starts
    or after it closes, and no scrape in between goes unanswered); the
    last /metrics parses and carries every family prefix of the final
    metrics.prom; the last /health whose files stayed unchanged across it
    equals obs.watch --once --json on a copy of those files, but for
    logdir and generated_unix; the run exits 0 and its port is closed."""
    import shutil
    import socket

    from scalable_agent_tpu_torch.obs.aggregate import parse_prometheus

    logdir = os.path.join(scratch, "live")
    kept = os.path.join(scratch, "live_health_files")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = _cli(dataclasses.replace(
        config, logdir=logdir, metrics_http_port=port,
        total_environment_frames=float(
            LIVE_UPDATES * config.frames_per_update())))
    answers = {"/metrics": [], "/health": [], "/anomalies": []}
    answered, kept_body = [], None
    os.makedirs(logdir)
    err_path = os.path.join(scratch, "live_stderr.txt")
    t0 = time.monotonic()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=root,
                                env=dict(os.environ, PYTHONPATH=root),
                                stdout=subprocess.DEVNULL, stderr=err)
        try:
            while proc.poll() is None:
                if time.monotonic() - t0 > CLI_TIMEOUT_S:
                    raise AssertionError("the live run timed out")
                cycle = time.monotonic()
                routes = ["/metrics"]
                if os.path.exists(os.path.join(logdir, "metrics.prom")):
                    routes += ["/health", "/anomalies"]
                for route in routes:
                    before = _watched_stat(logdir)
                    status, ms, body = _scrape(port, route)
                    answered.append(status is not None)
                    if status is None:
                        continue
                    answers[route].append((status, ms, body))
                    if route == "/health" and status == 200:
                        copy = kept + ".new"
                        os.makedirs(copy)
                        for name, *_ in before:
                            shutil.copy2(os.path.join(logdir, name), copy)
                        if _watched_stat(logdir) == before:
                            shutil.rmtree(kept, ignore_errors=True)
                            os.rename(copy, kept)
                            kept_body = body
                        else:
                            shutil.rmtree(copy)
                time.sleep(max(0.0, SCRAPE_EVERY_S
                               - (time.monotonic() - cycle)))
            code = proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    elapsed = time.monotonic() - t0
    closed = _scrape(port, "/metrics")[0] is None
    while answered and not answered[-1]:
        answered.pop()
    while answered and not answered[0]:
        answered.pop(0)
    statuses = {route: sorted({a[0] for a in got})
                for route, got in answers.items()}
    print(f"  live run: exit {code} in {elapsed:.1f} s, port closed after "
          f"it {closed}; scrapes answered "
          f"{ {r: len(a) for r, a in answers.items()} }, statuses "
          f"{statuses}, unanswered between answers "
          f"{answered.count(False)}", flush=True)
    if code != 0:
        with open(err_path) as f:
            raise AssertionError(f"the live run exited {code}:\n"
                                 f"{f.read()[-3000:]}")
    # /health may answer 503 until the first snapshot, and 200 after it.
    health = [a[0] for a in answers["/health"]]
    first = health.index(200) if 200 in health else len(health)
    if (not closed or False in answered or not answers["/metrics"]
            or first == len(health) or set(health[:first]) - {503}
            or set(health[first:]) != {200}
            or {a[0] for a in answers["/metrics"] + answers["/anomalies"]}
            != {200}):
        raise AssertionError(f"the endpoint did not answer every scrape: "
                             f"{statuses}, answered {answered}")
    for route in ("/metrics", "/health"):
        ms = sorted(a[1] for a in answers[route] if a[0] == 200)
        print(f"    {route}: {len(ms)} answers at 200, round trip median "
              f"{ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms "
              f"({len(answers[route][-1][2])} bytes last)", flush=True)
    anomaly_lines = answers["/anomalies"][-1][2].decode().splitlines() if (
        answers["/anomalies"]) else []
    print(f"    /anomalies: {len(anomaly_lines)} lines in the last answer",
          flush=True)

    with open(os.path.join(logdir, "metrics.prom")) as f:
        final = parse_prometheus(f.read())
    scraped = parse_prometheus(answers["/metrics"][-1][2].decode())
    prefix = lambda names: {n.split("_")[1] for n in names}
    missing = prefix(final) - prefix(scraped)
    print(f"    the last /metrics: {len(scraped)} families, prefixes "
          f"{sorted(prefix(scraped))}; missing of the final metrics.prom's: "
          f"{sorted(missing)}", flush=True)
    if missing:
        raise AssertionError(f"the last /metrics lacks {sorted(missing)}")

    if kept_body is None:
        raise AssertionError("no /health answer had its files unchanged "
                             "across it")
    proc, _ = _run_cli(root, [
        sys.executable, "-m", "scalable_agent_tpu_torch.obs.watch", kept,
        "--once", "--json"], CLI_TIMEOUT_S)
    moving = ("logdir", "generated_unix")
    served = {k: v for k, v in json.loads(kept_body).items()
              if k not in moving}
    watched = {k: v for k, v in json.loads(proc.stdout).items()
               if k not in moving}
    print(f"    the last stable /health equals watch --once --json on its "
          f"files (but for {moving}): {served == watched}; verdict "
          f"{served['verdict']}", flush=True)
    if proc.returncode != 0 or served != watched:
        raise AssertionError(f"/health {served} != watch {watched}\n"
                             f"{proc.stderr[-2000:]}")

    rows = {r["step"]: r for r in _rows(logdir)}
    s_per_update = ((rows[LIVE_UPDATES]["time"] - rows[2]["time"])
                    / (LIVE_UPDATES - 2))
    print(f"    the live run's s per update, updates 3..{LIVE_UPDATES}: "
          f"{s_per_update:.4f} (phase 3b's pool loop at the same window: "
          f"{pool_s:.4f}; single runs spread, nothing is gated on it)",
          flush=True)


def watchdog_drill(config, scratch, root):
    """A CLI subprocess whose third update sags OBS_SAG_S, past
    --watchdog_timeout_s, under --watchdog_abort: exit 70, the flight
    recorder's dump with reason watchdog:learner and every thread's
    stack."""
    logdir = os.path.join(scratch, "watchdog")
    cmd = _cli(dataclasses.replace(
        config, logdir=logdir, chaos_spec="throughput_sag@3",
        watchdog_timeout_s=OBS_WATCHDOG_S, watchdog_abort=True,
        total_environment_frames=1e9))
    proc, elapsed = _run_cli(root, cmd, CLI_TIMEOUT_S, env={
        "SCALABLE_AGENT_THROUGHPUT_SAG_S": str(OBS_SAG_S)})
    dumps = [n for n in os.listdir(logdir) if n.startswith("flightrec.")]
    reason = (json.load(open(os.path.join(logdir, dumps[0])))["reason"]
              if len(dumps) == 1 else None)
    stacks = (os.path.getsize(os.path.join(logdir, dumps[0].replace(
        "flightrec.", "stacks.").replace(".json", ".txt")))
        if reason else 0)
    print(f"  watchdog drill (throughput_sag@3 of {OBS_SAG_S} s, deadline "
          f"{OBS_WATCHDOG_S} s, --watchdog_abort): exit {proc.returncode} "
          f"in {elapsed:.1f} s, {dumps}, reason {reason!r}, stacks "
          f"{stacks} bytes", flush=True)
    if proc.returncode != 70 or reason != "watchdog:learner" or not stacks:
        raise AssertionError(f"the watchdog drill:\n{proc.stderr[-3000:]}")


def double_sigterm_drill(config, scratch, root):
    """Two SIGTERMs to a CLI subprocess once it has logged: the first
    starts the preemption drain, the second, sent as soon as the run has
    logged the first (two signals that land while the main thread is in
    one native call reach Python as one), reaches the flight recorder
    (dump, then exit 143)."""
    import signal

    logdir = os.path.join(scratch, "sigterm")
    os.makedirs(logdir)
    env = dict(os.environ, PYTHONPATH=root)
    cmd = _cli(dataclasses.replace(config, logdir=logdir,
                                   total_environment_frames=1e9))
    err_path = os.path.join(logdir, "stderr.txt")

    def wait_for(done, what):
        while not done():
            if (proc.poll() is not None
                    or time.monotonic() - t0 > CLI_TIMEOUT_S):
                raise AssertionError(f"the SIGTERM drill's run ended or "
                                     f"timed out before {what}")
            time.sleep(0.01)

    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=root, env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        try:
            t0 = time.monotonic()
            wait_for(lambda: os.path.exists(
                os.path.join(logdir, "metrics.prom")), "its first log")
            proc.send_signal(signal.SIGTERM)
            wait_for(lambda: "preemption" in open(err_path).read(),
                     "it logged the first SIGTERM")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    path = os.path.join(logdir, f"flightrec.{proc.pid}.json")
    reason = (json.load(open(path))["reason"] if os.path.exists(path)
              else None)
    stacks = os.path.join(logdir, f"stacks.{proc.pid}.txt")
    stacks = os.path.getsize(stacks) if os.path.exists(stacks) else 0
    print(f"  two SIGTERMs: exit {code} after {time.monotonic() - t0:.1f} "
          f"s, flight recorder reason {reason!r}, stacks {stacks} bytes",
          flush=True)
    if code != 143 or reason != "signal:SIGTERM" or not stacks:
        with open(err_path) as f:
            raise AssertionError(f"the double-SIGTERM drill:\n"
                                 f"{f.read()[-3000:]}")


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
            vtrace,
            vtrace_cuda,
        )
        from scalable_agent_tpu_torch.runtime import (
            CheckpointManager,
            faults,
        )
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run this from "
              f"the root of a checkout of the repository", file=sys.stderr)
        return 3
    counters = (lstm_cuda.LAUNCHES, conv_cuda.LAUNCHES, vtrace_cuda.LAUNCHES)

    def reset_counts():
        for launches in counters:
            for key in launches:
                launches[key] = 0

    def read_counts():
        return {k: v for launches in counters for k, v in launches.items()}

    def write_counts(saved):
        for launches in counters:
            for key in launches:
                launches[key] = saved[key]

    # -- phase 1: the card and the build
    started = time.monotonic()

    def phase(title):
        print(f"{title} [{time.monotonic() - started:.0f} s in]",
              flush=True)

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
        phase("phase 2: kernels vs plain versions (float32 with TF32 off, "
              "then the bf16-operand variants; sums in float32)")
        rows = []
        for matmul_dtype, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
            rows += compare_lstm(torch, lstm_cuda, device, matmul_dtype)
            compare_lean_buckets(torch, lstm_cuda, device, matmul_dtype)
            compare_lean_buckets(torch, lstm_cuda, device, matmul_dtype,
                                 FUSED_BUCKETS, "an accum_fused shard")
            rows += compare_lean_target(torch, lstm_cuda, device,
                                        matmul_dtype)
            rows += compare_gradw(torch, conv_cuda, device, dtype=dtype)
        rows += compare_vtrace(torch, vtrace_cuda, vtrace, device)
        timed = time_rows(torch, rows)
        if not timed["stem_gradw"]["ms"] < timed["stem_gradw"]["library_ms"]:
            raise AssertionError("stem_gradw is not faster than cuDNN's "
                                 "conv2d_weight")
        del rows
        compare_agent(torch, device)
        compare_agent(torch, device, torch.bfloat16)
        torch.cuda.empty_cache()
        # The core widths of the other levels (CartPole's D=259, the Atari
        # stand-in's D=261, fake_tuple's D=265, odd, Doom's full
        # discretized space's D=296 and doom_duel's D=298, the same space
        # with use), fake_tuple's 16x16 frames and Doom's 72x128 at the
        # learner's merged batch (phases 3i, 3l and 3n).
        for width in (259, 261, 265, 296, 298):
            for matmul_dtype in ("float32", "bfloat16"):
                compare_lstm_wide(torch, lstm_cuda, device, matmul_dtype,
                                  D=width)
        for hh, ww in ((16, 16), (72, 128)):
            for dtype in (torch.float32, torch.bfloat16):
                compare_gradw_frame(torch, conv_cuda, device, hh, ww,
                                    dtype=dtype)
        torch.cuda.empty_cache()
        # Atari's grayscale stack of 4 at 84x84 (phase 3n): the stem
        # grad-W's C=4 instantiation, held as the C=3 one above.
        rows = []
        for dtype in (torch.float32, torch.bfloat16):
            rows += compare_gradw(torch, conv_cuda, device, dtype=dtype,
                                  frame=(84, 84, 4))
        timed.update(time_rows(torch, rows))
        del rows
        torch.cuda.empty_cache()
        # A one-channel gym level's 72x96x1 frames through the shallow stem
        # and Atari's 84x84x4 through the ResNet stem (phase 3n's
        # gym_BreakoutGray-v0 and deep atari_breakout runs): the C=1 and
        # the ResNet C=4 kernels.
        rows = []
        for dtype in (torch.float32, torch.bfloat16):
            rows += compare_gradw(torch, conv_cuda, device, dtype=dtype,
                                  frame=(72, 96, 1))
            rows += compare_resnet_gradw(torch, conv_cuda, device,
                                         dtype=dtype, frame=(84, 84, 4))
        timed.update(time_rows(torch, rows))
        del rows
        torch.cuda.empty_cache()
        # The device worlds' shapes (phase 3t): the stem grad-W at
        # 15x15x3 (SAME pads 2/3, the first asymmetric pair of the main
        # paths) and 10x10x3/x4 (pads 3/3), the core at D=260 and 262.
        rows = []
        for frame in WORLD_FRAMES:
            for dtype in (torch.float32, torch.bfloat16):
                rows += _shape_rows(compare_gradw(
                    torch, conv_cuda, device, dtype=dtype, frame=frame),
                    frame)
        timed.update(time_rows(torch, rows))
        del rows
        for width in WORLD_WIDTHS:
            for matmul_dtype in ("float32", "bfloat16"):
                timed.update(_wide_rows(compare_lstm_wide(
                    torch, lstm_cuda, device, matmul_dtype, D=width), width,
                    matmul_dtype))
        torch.cuda.empty_cache()

    def train_counted(config, updates, suffix, stem="stem_gradw",
                      expected=None):
        """driver.train with every count set to 0 just before and read just
        after; the kernels of the variant ``suffix`` launched as the path
        runs them (the torso's ``stem`` grad-W, V-trace's kernel under
        ``scan_impl=pallas``), the other variant's and the other stem's
        never; or, given ``expected``, the counts it names
        (``_expect_launches``)."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        metrics = driver.train(config)
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = read_counts()
        print(f"  {updates} updates at compute_dtype={config.compute_dtype} "
              f"in {train_s:.2f} s ({train_s / updates:.3f} s per update, "
              f"set-up included); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {launches}", flush=True)
        print(f"  final metrics: {json.dumps(metrics, sort_keys=True)}",
              flush=True)
        for key in ("total_loss", "policy_gradient_loss", "baseline_loss",
                    "entropy_loss", "grad_norm"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"{key} is not finite: {metrics[key]}")
        if metrics["env_frames"] != updates * config.frames_per_update():
            raise AssertionError(f"env_frames {metrics['env_frames']} != "
                                 f"{updates} x {config.frames_per_update()}")
        if expected is None:
            other = "" if suffix else "_bf16"
            expected = {
                "lstm_fwd_lean" + suffix: (updates * config.unroll_length,
                                           None),
                "lstm_fwd_resid" + suffix: updates,
                "lstm_bptt" + suffix: updates,
                "vtrace_fused": (updates if config.scan_impl == "pallas"
                                 else 0),
                "lstm_fwd_lean" + other: 0, "lstm_fwd_resid" + other: 0,
                "lstm_bptt" + other: 0}
            for name in STEMS:
                expected[name + suffix] = updates if name == stem else 0
                expected[name + other] = 0
        _expect_launches(config.level_name, launches, expected)
        return launches

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        # -- phase 3: the main path (the default policy, bf16), counted
        logdir = os.path.join(scratch, "train")
        config = Config(level_name="fake_benchmark", device="cuda",
                        logdir=logdir, scan_impl="pallas",
                        total_environment_frames=float(
                            UPDATES * Config().frames_per_update()),
                        log_interval_s=0.0)
        phase("phase 3: the main path, fake_benchmark at full width")
        # The obs planes at their defaults, plus the tracer.
        launches = train_counted(dataclasses.replace(config, trace=True),
                                 UPDATES, "_bf16")
        _print_anomalies(logdir, "phase 3 (health at its default, on)")
        metric_rows = _rows(logdir)
        _check_rows(metric_rows, config.frames_per_update(),
                    config.inflight_updates, UPDATES)
        ckpt = CheckpointManager(logdir)
        step, saved = ckpt.restore()
        ok, why = ckpt.verify(step, saved)
        if step != UPDATES or not ok or saved["env_frames"] != (
                UPDATES * config.frames_per_update()):
            raise AssertionError(f"checkpoint step {step} verified {ok} "
                                 f"({why}), env_frames "
                                 f"{saved['env_frames']}")
        print(f"  {len(metric_rows)} metric rows; checkpoint steps "
              f"{ckpt.all_steps()}, step {step} verified against its "
              f"manifest", flush=True)

        reset_counts()
        t0 = time.monotonic()
        returns = driver.test(dataclasses.replace(
            config, mode="test", test_num_episodes=8))[config.level_name]
        test_launches = read_counts()
        print(f"  --mode=test: {len(returns)} returns {returns} in "
              f"{time.monotonic() - t0:.1f} s; launches {test_launches}",
              flush=True)
        if len(returns) != 8 or test_launches["lstm_fwd_lean_bf16"] == 0:
            raise AssertionError("--mode=test did not run 8 episodes "
                                 "through the bf16 lean LSTM kernel")

        reset_counts()
        auto = dataclasses.replace(
            config, logdir=os.path.join(scratch, "auto"), scan_impl="auto",
            total_environment_frames=float(config.frames_per_update()))
        driver.train(auto)
        auto_launches = read_counts()
        print(f"  scan_impl=auto, 1 update: launches {auto_launches}",
              flush=True)
        if auto_launches["vtrace_fused"] != 0 or (
                auto_launches["lstm_fwd_resid_bf16"] != 1):
            raise AssertionError("scan_impl=auto must update through the "
                                 "associative recurrence, not the kernel")

        # The float32 policy's path, shorter: its kernels' launch counts.
        f32 = dataclasses.replace(
            config, logdir=os.path.join(scratch, "f32"),
            compute_dtype="float32",
            total_environment_frames=float(
                F32_UPDATES * config.frames_per_update()))
        f32_launches = train_counted(f32, F32_UPDATES, "")

        phase("phase 3h: the deep agent (ResNet torso and instruction "
              "encoder)")
        with float32_precision():
            deep_rows = []
            for dtype in (torch.float32, torch.bfloat16):
                deep_rows += compare_resnet_gradw(torch, conv_cuda, device,
                                                  dtype=dtype)
            timed.update(time_rows(torch, deep_rows))
            del deep_rows
            torch.cuda.empty_cache()
            for matmul_dtype in ("float32", "bfloat16"):
                compare_lstm_wide(torch, lstm_cuda, device, matmul_dtype)
            for dtype in (torch.float32, torch.bfloat16):
                compare_agent(torch, device, dtype, "resnet", True)
            torch.cuda.empty_cache()
        deep_launches, deep_f32_launches, deep_layouts = deep_path(
            torch, driver, config, scratch, train_counted, reset_counts,
            read_counts)
        resnet_gradw_in_layout(torch, conv_cuda, device, deep_layouts, card)
        torch.cuda.empty_cache()

        phase("phase 3i: composite policies, fake_tuple with "
              "--rmsprop_momentum=0.9")
        with float32_precision():
            composite_path(torch, driver, CheckpointManager, config, scratch,
                           train_counted, reset_counts, read_counts)
        torch.cuda.empty_cache()

        phase("phase 3b: where one iteration of the main path spends its "
              "time")
        with float32_precision():
            breakdown(torch, driver, config)
            print("  the same at compute_dtype=float32:", flush=True)
            breakdown(torch, driver, f32)
        # Window 1, a reading only, over fewer updates (the script's time
        # limit pays for phase 3p).
        pool_s = {window: pool_steady_state(
            torch, driver, dataclasses.replace(config,
                                               inflight_updates=window),
            os.path.join(scratch, f"pool{window}"), updates=updates)
            for window, updates in ((2, POOL_UPDATES),
                                    (1, POOL_UPDATES_WINDOW1))}

        phase("phase 3p: the continuous-batching actor service, "
              "--actor=service")
        t0 = time.monotonic()
        service_launches = service_path(
            torch, driver, config, scratch, train_counted,
            pool_s[config.inflight_updates])
        print(f"  phase 3p took {time.monotonic() - t0:.1f} s", flush=True)

        phase("phase 3q: the ActorPool's other inference modes, "
              "--inference_mode=service, accum and accum_fused")
        t0 = time.monotonic()
        mode_launches = inference_modes_path(
            torch, driver, config, scratch, train_counted,
            pool_s[config.inflight_updates])
        print(f"  phase 3q took {time.monotonic() - t0:.1f} s", flush=True)

        phase("phase 3j: --benchmark_mode=true on the main path")
        benchmark_path(torch, driver, config, scratch, train_counted,
                       pool_s[config.inflight_updates])

        phase("phase 3k: the library routes, --core_impl=xla and "
              "--conv_backend=xla")
        with float32_precision():
            library_routes(torch, driver, config, scratch, train_counted)
        torch.cuda.empty_cache()

        phase("phase 3l: the doom_ family under the fake VizDoom")
        root = os.path.dirname(os.path.abspath(__file__))
        doom_path(torch, driver, config, scratch, root, train_counted,
                  reset_counts, read_counts)
        torch.cuda.empty_cache()

        phase("phase 3m: the dmlab_ family, DMLab-30 multi-task training "
              "and suite eval, under the fake DeepMind Lab")
        dmlab_path(driver, config, scratch, root, train_counted,
                   reset_counts, read_counts)
        torch.cuda.empty_cache()

        phase("phase 3n: the atari_ and gym_ families under a stand-in "
              "gymnasium")
        atari_launches, atari_f32_launches = atari_gym_path(
            driver, config, scratch, train_counted)
        torch.cuda.empty_cache()
        new_launches = one_channel_and_deep_atari_paths(
            driver, config, scratch, train_counted, reset_counts,
            read_counts)
        torch.cuda.empty_cache()

        phase("phase 3o: off-policy training, --loss=impact with the "
              "replay slab")
        t0 = time.monotonic()
        with float32_precision():
            unroll_launches = off_policy_path(
                torch, driver, CheckpointManager, config, scratch,
                train_counted, reset_counts, read_counts)
        torch.cuda.empty_cache()
        print(f"  phase 3o took {time.monotonic() - t0:.1f} s", flush=True)

        phase("phase 3r: the numerics sentinel, every update audited")
        t0 = time.monotonic()
        sentinel_path(torch, driver, config, scratch, train_counted,
                      read_counts, write_counts, card)
        torch.cuda.empty_cache()
        print(f"  phase 3r took {time.monotonic() - t0:.1f} s", flush=True)

        phase("phase 3s: a chaos soak through the runtime channel")
        t0 = time.monotonic()
        soak_path(root, scratch, card)
        print(f"  phase 3s took {time.monotonic() - t0:.1f} s", flush=True)

        phase("phase 3t: the in-graph backend, --train_backend=ingraph, "
              "and the device_ worlds")
        t0 = time.monotonic()
        ingraph_launches = ingraph_path(
            torch, driver, CheckpointManager, config, scratch,
            train_counted, card)
        torch.cuda.empty_cache()
        print(f"  phase 3t took {time.monotonic() - t0:.1f} s", flush=True)

        phase("phase 3d: the default loop's machinery on the card")
        outs = pool_trajectories(torch, driver, config, 4)
        with float32_precision():
            compare_transports(torch, driver, device, outs)
            compare_windows(torch, driver, CheckpointManager, config, outs,
                            scratch)
            rollback_drill(driver, config, scratch, root)
            preemption_drill(CheckpointManager, config, scratch, root)
            fault_points(driver, faults, CheckpointManager, config, scratch)
            remat_and_two_pass(torch, driver, config, outs[0], reset_counts,
                               read_counts)

        phase("phase 3e: the obs planes on the card")
        obs_artifacts(logdir)
        with float32_precision():
            telemetry_in_the_update(torch, driver, config, outs[0])
        del outs
        torch.cuda.empty_cache()
        with float32_precision():
            readings = obs_cost_in_the_loop(torch, driver, config, scratch)
        watchdog_drill(config, scratch, root)
        double_sigterm_drill(config, scratch, root)
        from scalable_agent_tpu_torch.ops.distributions import (
            spec_for_space)
        from scalable_agent_tpu_torch.runtime.learner import update_flops

        obs_spec, action_space, _ = driver.probe_env(config)
        flops = update_flops(obs_spec.frame.shape,
                             spec_for_space(action_space).num_logits,
                             config.unroll_length, config.batch_size)
        print(f"  update_flops at the main path: {flops:.6g} FLOPs per "
              f"update (2 per multiply-add), peak 989.4e12 FLOP/s at "
              f"bfloat16", flush=True)
        for i, reading in enumerate(readings):
            print(f"  planes-on pool run {i}: stall verdicts of updates "
                  f"3..{OBS_POOL_UPDATES} "
                  f"{reading['verdicts_of_updates_3_on']}, "
                  f"last {reading['last_verdict']} (wait_batch "
                  f"{reading['wait_frac']:.3f} of the learner interval); "
                  f"dominant ledger segment {reading['dominant_segment']} "
                  f"(shares {reading['shares']}; rho {reading['rho']}); "
                  f"ledger/mfu {reading['mfu']:.6g}; staleness p50 "
                  f"{reading['staleness_p50_s']:.3f} s", flush=True)

        phase("phase 3f: the run-health plane")
        with float32_precision():
            health_logdir = health_drill(torch, driver, config, scratch)

        phase("phase 3g: the obs consumers on the card's logdirs")
        read_logdir(root, logdir, "phase 3 (--trace)")
        read_logdir(root, health_logdir, "phase 3f (kernel tables)")
        live_endpoint(root, config, scratch,
                      pool_s[config.inflight_updates])

        phase("phase 3c: fake_bandit learns through the pool on the card "
              "(bf16 policy)")
        learn_bandit(Config, scratch, root)
        phase("phase 4: the report")

    # -- phase 4: the report.  Launches: the bf16 variants' (and V-trace's)
    # from the main path, the float32 variants' from the float32 path.
    counts = dict(f32_launches)
    counts.update({k: v for k, v in launches.items() if k.endswith("_bf16")})
    counts.update(vtrace_fused=launches["vtrace_fused"],
                  resnet_stem_gradw=deep_f32_launches["resnet_stem_gradw"],
                  resnet_stem_gradw_bf16=deep_launches[
                      "resnet_stem_gradw_bf16"],
                  stem_gradw_c4=atari_f32_launches["stem_gradw_c4"],
                  stem_gradw_c4_bf16=atari_launches["stem_gradw_c4_bf16"])
    gym, deep = "gym_BreakoutGray-v0", "atari_breakout resnet"
    counts.update(
        stem_gradw_c1=new_launches[gym + " float32"]["stem_gradw_c1"],
        stem_gradw_c1_bf16=new_launches[gym]["stem_gradw_c1_bf16"],
        resnet_stem_gradw_c4=new_launches[deep + " float32"][
            "resnet_stem_gradw_c4"],
        resnet_stem_gradw_c4_bf16=new_launches[deep][
            "resnet_stem_gradw_c4_bf16"])
    counts["lstm_fwd_lean_unroll_bf16"] = unroll_launches
    for name, launches in service_launches.items():
        timed[name]["service_launches"] = launches
    timed["lstm_fwd_lean_bf16"]["mode_launches"] = mode_launches
    kernels = [dict(timed[name], launches=counts[name])
               for name in ("lstm_fwd_lean", "lstm_fwd_resid", "lstm_bptt",
                            "stem_gradw", "lstm_fwd_lean_bf16",
                            "lstm_fwd_resid_bf16", "lstm_bptt_bf16",
                            "stem_gradw_bf16", "vtrace_fused",
                            "resnet_stem_gradw", "resnet_stem_gradw_bf16",
                            "stem_gradw_c4", "stem_gradw_c4_bf16",
                            "stem_gradw_c1", "stem_gradw_c1_bf16",
                            "resnet_stem_gradw_c4",
                            "resnet_stem_gradw_c4_bf16",
                            "lstm_fwd_lean_unroll_bf16")]
    # The device worlds' shapes, with phase 3t's launches at them.
    kernels += [dict(timed[name], launches=count)
                for name, count in world_launches(
                    ingraph_launches).items()]
    print(f"chip_smoke.py total: {time.monotonic() - started:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
