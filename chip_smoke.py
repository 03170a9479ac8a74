#!/usr/bin/env python3
"""Bring-up check of apex_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (set-up
time, one ``nvcc`` per source, all started together) and then runs
twenty-nine phases; any failure raises and the exit code is non-zero.  Without
a CUDA device it exits non-zero at once and prints no result.

1. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it and at ragged shapes,
   within a stated tolerance: K1 (LayerNorm forward), K2 (its backward,
   with rms and memory_efficient), K3 (flash forward), K4 (flash
   backward: Sq != Sk both ways, fully-masked rows, non-causal, dlse)
   and K6 (paged decode).  K3 and K4 again with their bias and dropout
   operands: BERT's shape with its key-padding bias over ragged lengths
   and a fully masked row, with and without dropout 0.1, every other
   bias layout at smaller shapes, and biases whose S_k is not a multiple
   of 4 at D = 32 and 64; the dropout keep masks of K3 and of both K4
   passes read back bit for bit against the twin's; and K3 and K4 run
   twice at the GPT and triangle shapes, where both runs must give the
   same bits.  K5
   (the bias gradient) at the evoformer's two biased shapes and in every
   (G, RS) layout, causal and not, Sq != Sk both ways, ragged, with
   dropout, D = 32 and 64 (no model launches it: the phase-1 count is
   its check), and at every G = BH, RS = Sq case the fused call
   (``flash_bwd_dbias``: K4 writing K5's dbias from its dQ pass, the
   route of every trainable bias of the models), also at S_k odd, causal
   Sq > Sk (exact zeros at the masked pairs), D = 128 and 256, its
   triangle output run twice for the same bits and a halved tile
   rejected; K3 and K4 at D = 32, the triangle shape
   with its G = BH bias included.  K3, K4 and K5 at D = 128, 256 and 384
   (the wide instance) in every bias mode and with dropout, at D = 48,
   96, 160 and 320 (padded by the wrappers to 64, 128, 256 and 384), and
   their f32 instances at D 32, 64, 96, 128, 192, 320, 384 and the
   evoformer's triangle, MSA row and MSA column shapes, each beside a
   TF32 control that must fail the f32 limit by more than 10x; K6 at D
   34, 60, 80, 96, 128, 160, 192, 256 and 320 (int8, f32 and bf16 pages,
   RoPE, every copy width) and at lengths that straddle its splits (0, 1, a
   split, a split + 1, NP x page), the decode batch run twice for the
   same bits; K1 and K2
   also at widths 1001 (rows off 16-byte boundaries), 130 f32, 12288
   (streamed), 64 and 33 (several rows a warp).
2. The serving slice: ``GptConfig()`` at full width (bf16, seeded random
   weights) behind ``InferenceEngine`` + ``ContinuousBatchingScheduler``
   answers 8 greedy requests (prompts of 17..1900 tokens, 32 new tokens
   each).  The launch counters are zeroed just before and read just
   after: K1, K3 and K6 must each have launched, exactly as often as the
   prefill and decode calls require, and every op must have taken the
   kernel path (the decode step is a CUDA graph: its launches count once
   a replay).  The page pool must end empty.  The same requests are
   then served again: the second run's rates pay no first-call costs.
3. Serving cross-check: at full width with 2 layers, one 256-token
   prefill and 4 decode steps through the card engine (bf16) against the
   CPU engine (f32, the same weights), fed the same tokens; again on the
   int8 KV wire and on the int8 weight wire, each beside a planted fault
   (the codec's scales halved) that must fail its limit; and two
   128-token chunks of the chunked prefill against the monolithic
   prefill on the card.
4. Timing at the main-path shapes (training, BERT, the evoformer's
   triangle, MSA row and MSA column attention, and serving), and K1/K2
   at the evoformer's f32 rows, K3/K4 at the reference's long-context
   shape (BH 8, S 16384, D 128, causal) and at D = 256 (BH 32, S 2048,
   causal), K3, K4 and K5 at D = 384 (BH 32, S 2048; K3/K4 causal), K6
   at phase 1's short lengths and on int8 pages at the decode batch,
   the fused K4 + K5 call at the triangle
   and MSA row shapes beside K4 alone and K5 alone, and the f32
   instances of K3-K5 at the
   triangle, MSA row and MSA column shapes: each kernel,
   its plain version and one PyTorch library call computing the same
   function (the yardstick, never used by the port), with the least time
   the card could take.
5. Decode at batch 8, full width, through the captured CUDA graph and
   eagerly on the card, on bf16 and on int8 KV pages: host time per
   iteration unprofiled and the counted launches, then a
   ``torch.profiler`` trace of 4 iterations — the device time of
   their kernels (the device's busy share), K6's share of it and its
   launches per step, the kernels that took most,
   and the host side split into the time inside PyTorch ops and runtime
   calls (by op) and the Python time outside them; and one replay's
   device time between CUDA events.
6. The training slice: ``python -m apex_tpu_torch.examples.train_gpt``'s
   ``train`` at ``GptConfig(remat=True)``, seq 2048, batch 8, 8 steps on
   a synthetic zipf corpus, with the launch counters zeroed before and
   read after: K1, K2, K3 and K4 must have launched exactly their
   per-step counts times 8.  Losses must be finite and falling; it
   reports step time, tokens/s, 6NT MFU, peak memory and the top device
   ops of one profiled step.
7. Training cross-check: 2 layers at full width, B=2, S=256 — the loss,
   every parameter's gradient and the weights after one FusedAdam step,
   card (bf16) against CPU (f32), from the same weights and batch.
8. BERT-Large pretraining: ``python -m
   apex_tpu_torch.examples.pretrain_bert``'s ``train`` at
   ``BertConfig(remat=True)``, batch 128, seq 128, 20 masked predictions
   per sequence, FusedLAMB, 8 steps, then 2 steps with dropout through
   the same ``train_step``; exact K1-K4 counts for each run, losses
   finite and falling; step time, sequences/s, tokens/s, 6NT MFU, peak
   memory and one profiled step by layer.
9. BERT cross-check: 2 layers at full width, B=4, S=128, attention_mask
   lengths 128/100/37/0, attention dropout 0.1 with the same seeds on
   both sides — the loss, every gradient and the weights after one
   FusedLAMB step, card (bf16) against CPU (f32).
10. Evoformer training: 4 ``EvoformerBlock``s at AlphaFold2's widths
    (OpenFold's c_m 256, c_z 128, 4 heads) on N_seq 128 x N_res 256,
    MSE to seeded targets, FusedAdam, 8 steps; exact K1-K4 counts and
    the fused K4 + K5 call's (3 of 4 attention backwards a block-step),
    losses finite and falling; step time, analytic MFU, peak memory and
    one profiled step by layer.  Then the same 4 blocks with f32
    attention (the JAX module's precision) for 8 steps: exact counts of
    K1, K2 and the f32 instances of K3-K5, losses falling, step time and
    one profiled step by layer, with K5 f32's share of its kernel time.
11. Evoformer cross-check: one full-width block at N_res 64, N_seq 32 —
    the loss, every gradient and the weights after one FusedAdam step,
    card (bf16 attention) against CPU (f32), and a planted fault (K5's
    twin halved) that must fail the same limits.

12. The engine's full surface: ``GptConfig()`` (phase 2's seeded
    weights) on the int8 KV and weight wires with top-k 50 sampling
    behind a scheduler with the prefix cache and 512-token chunks; 8
    requests (six share a 1024-token system prompt; four sample at
    temperature 0.8 with stream seeds), 32 new tokens each, served twice.
    K1 and K6 launch exactly what the chunk calls and decode replays
    require, K3 never; the pool holds only the cache's pages after each
    run; every prompt of the second run hits and every stream equals the
    first run's; each sampled token lies in its row's top 50; 4 full
    decode steps of the graph equal the eager step bit for bit; other
    stream seeds draw other streams.  It reports the int8 pool's and the
    packed weights' bytes.
13. Speculative decoding: ``GptConfig()`` (phase 2's seeded weights),
    ``SpecConfig(k=4)`` with the target's first 2 layers as the draft
    (``draft_from_params``), phase 2's 8 greedy requests: every stream
    equals phase 2's plain decode bit for bit, with exact K1, K3 and K6
    launches (K3 only in the target's and the draft's prefills; each
    spec round is one replay of a captured CUDA graph whose launches
    count per replay); again with a self-draft (every live slot accepts
    all 4 proposals every round), on the int8 KV wire against plain
    decode on int8 pages, and at k = 0 with four seeded requests at
    temperature 0.8 against plain decode's sampled streams; at k = 4 the
    four sampled requests served twice behind the prefix cache (hits,
    copy-on-write forks of the spec span): every emitted token in its
    position's top 50, the streams repeating, no draft page in the
    cache.  It reports the draft's acceptance rate, tokens a slot a
    round, host and device ms and launches per round and decode tokens/s
    beside phase 2's.

14. Checkpoints, preemption and resume: BERT-Large's width at 6 of its
    24 layers (``RES_LAYERS``), otherwise phase 8's configuration.  Two
    uninterrupted 8-step runs of the example agree
    bit for bit; ``--steps 4 --ckpt-dir D --save-every 2`` leaves steps
    2 and 4, and ``--resume --steps 8`` resumes at 4 with exact K1-K4
    counts, its losses, params and LAMB state equal to the uninterrupted
    run's bit for bit.  ``run_resilient`` with dropout (seeds from the
    RNG tracker), a ``ResumableStream`` and the async engine saving every
    2 steps, under a save fault at 2, partial debris at 4 and a SIGTERM
    at 5: preempted at 5, resumed at 5 to 8, equal to an uninterrupted
    dropout run bit for bit (weights, LAMB state, generator state), the
    events the schedule's.  Then the costs: checkpoint bytes, the step
    path's ms per save, the write's and the restore's ms, the engine's
    stall fraction, and the median step saving every 2 steps beside none.
    It needs 8 GB of free disk under the temporary directory.
15. Serving robustness: ``GptConfig()``'s width at 6 of its 12 layers
    (``CHAOS_LAYERS``: the depth cut that keeps the whole script near its
    earlier time with phase 24 added; phase 2's seed) behind ``ServeConfig(page_size=16, max_batch=8, max_pages_per_seq=
    128)`` with a 256-page pool, through the ported chaos drill
    (``apex_tpu_torch.tools.serve_chaos_drill``): 100 Poisson arrivals
    (seed 0, the reference drill's draws) of 64/256/1024-token prompts
    and 16/32/64 new tokens on the virtual clock, fault-free and under
    ``DEFAULT_CHAOS_SPEC``, then the overload probe and a drain of 12
    requests, on bf16 and on int8 KV pages.  The drill's four guarantees
    hold (no exception escapes; leak checks after every shed and free,
    the pool empty; every request one terminal and every span chain
    closed; the storm's p99 TTFT within 2x), the ledger equals
    ``DEFAULT_EXPECTED`` exactly and every retry's cause is an injected
    fault, the clamp rung and page pressure are reached, the probe sheds
    exactly the excess as ``queue_full`` and clamps to 4 tokens, the
    drain sheds its queue as ``draining``; a request that completed in
    both runs streams the same tokens; K1, K3 and K6 launch exactly as
    the calls require (the counters zeroed before the drill and read
    after), all on the kernel paths.  Then a self-draft ``SpecConfig(k=
    4)`` under two ``serve.draft`` raises and one ``serve.decode`` raise
    (the streams equal plain decode's, both graphs re-captured, exact
    launches); three ``rebuild()`` re-captures in the middle of a run
    (the replay bit for bit equal to itself and the eager step before
    and after each, ``memory_reserved`` not growing, the run's streams
    an uninterrupted run's), a crashed decode step that every request
    survives by retrying with its pages and prefix kept; a decode-only
    scheduler step's host ms with a registry and a span recorder
    attached beside one with neither (the same launches); and a metric
    registry on the card read back as one on the host.
16. Data and tensor parallelism (``phase16``), in worker processes on
    the one card (``torch.multiprocessing``, spawn; a ``file://`` store,
    a timeout on every process group and on every join; the kernels
    built by this process first).  16a: ``examples.train_gpt`` at phase
    6's configuration for 4 steps in a world of 1 over NCCL
    (``DistributedDataParallel``, ``parallel_state`` at tp = 1) equals
    the same run without a process group, and phase 6's first 4 steps,
    bit for bit: losses, every parameter's bytes, K1-K4 launches.  16b:
    GptConfig()'s width at 2 layers, tp = 2 with sequence parallelism
    on two ranks over gloo, weights cut from tp = 1's seeded full
    weights: one step's gradients gathered over tp within
    ``P16_TP_GRAD_TOL`` of tp = 1's (each over the tensor's max), a
    planted fault (one RowParallelLinear that skips its reduction) past
    10x that; then 4 steps of ``examples.train_gpt --tp 2
    --sequence-parallel`` with losses within ``P16_TP_LOSS_TOL`` of the
    same steps at tp = 1, and each rank's K1-K4 counts exactly tp = 1's
    (K1/K2 at S * B / 2 rows, K3/K4 at B * H / 2 heads; phase 1 holds
    the kernels to their plain versions at these shapes).  16c: dp = 2
    over gloo: GPT with ``DistributedFusedAdam`` (``train_gpt --zero``)
    on the f32 and int8 wires against FusedAdam at dp = 1 on the same
    global batch, the reduced shard within the int8 codec's bound of
    the exact one, each beside a planted fault (the reduce-scatter
    skipped) that must fail both; BERT-Large through
    ``examples.pretrain_bert`` under DDP and FusedLAMB at 128 x 128
    against dp = 1 (the mean of the two halves' losses); each first
    step's collective call log against ``zero_plan`` / ``sync_plan``.
    16d: ``SyncBatchNorm`` over the two ranks on a (32, 64, 56, 56) bf16
    batch whose halves differ in mean and scale, against the unsplit
    cuDNN BatchNorm (output, gradients, running statistics), beside a
    planted fault (statistics over one rank's rows) that must fail.  The
    two-rank times are of two processes sharing one card, staged
    through the host by gloo: not a rank's speed.
17. The evoformer under dynamic axial parallelism (``phase17``): 2 of
    phase 10's blocks at its widths and crop, bf16 attention, 3
    FusedAdam steps, the MSA's and the pair's rows sharded over dap = 2
    worker processes on the card (gloo; the transitions are all-to-alls
    of CUDA tensors), the parameter gradients all-reduced over the DAP
    group: step 0's outputs and every gradient, and the losses, against
    the same blocks at dap = 1 in this process, beside a planted fault
    (``gather``'s backward slicing instead of reduce-scattering) past
    10x the gradient limit; rank 0's K1-K5 launches exactly
    ``EVO_BLOCK_LAUNCHES`` x blocks x steps (the fused K4 + K5 call at a
    rank's half shapes, which phases 1 and 4 hold and time).
18. The trainer (``phase18``).  18a: ``Trainer.build(verify="error")``
    over ``GptConfig(remat=True)`` through ``module_loss`` at phase 6's
    batch for 8 steps, dp = 1: phase 6's losses, K1-K4 launches a step
    equal to phase 6's, no host synchronization a step
    (``set_sync_debug_mode``), the step time, tokens/s and MFU from
    ``StepMeter``; each check beside a planted fault it must fail.  18b-d on two worker processes over gloo
    at GptConfig()'s width with 2 layers: both update modes (ZeRO and
    DDP) against dp = 1 within 16c's limit, each build's call log within
    its plan, a planted bogus plan refused, the demo's tp arm with one
    all-reduce over tp a step; ``build_guarded`` under ``grads:nan@3``
    (step 3 skipped on both ranks, params unchanged, the scale halved,
    the other steps against dp = 1 under the same fault); ``fit`` in
    ZeRO mode on the async engine, 6 steps, preempted at step 3 and
    resumed, equal to the whole run bit for bit (params and each rank's
    master shard).
19. Context parallelism (``phase19``): GPT at ``GptConfig()``'s width,
    2 layers, global sequence 2048 and batch 8, cp = 2 worker processes
    over gloo (1024 rows a rank), 3 FusedAdam steps through
    ``gpt_lm_loss_cp`` with the gradients mean-reduced over cp, in ring,
    ring_zigzag and Ulysses: step 0's hidden states, the losses and every
    gradient against cp = 1 in this process, beside two planted faults
    (the hops' backward fed no lse cotangent; the shard-edge targets from
    the rank's own rows); rank 0's launches exact (the ring's hops on the
    f32 K3/K4, Ulysses' on bf16).  Phase 1 holds the f32 K3/K4 at the
    hop shapes with dlse != 0 and phase 4 times them.
20. Experts (``phase20``).  20a: ``train_gpt --num-experts 8`` at
    ``GptConfig()``'s full size (12 layers, remat), batch 8 x 2048, 8
    steps: exact K1-K4 launches, the step time, tokens/s, peak memory,
    MFU over the active parameters.  20b: 2 layers, 8 experts at ep = dp
    = 2 on two workers over gloo, top-1 and top-2, 3 steps, against ep
    = 1 on the same two half batches: losses (aux included) and every
    gradient, beside a planted fault (sync_moe_gradients averaging the
    expert_ leaves over dp).
21. Pipeline parallelism (``phase21``): BertEncoderCore stages at
    BertConfig()'s widths, 4 layers over pp = 2 workers over gloo, S
    128, 4 microbatches of 8 with the key-padding bias, the loss through
    the tied head: the five schedules (1f1b in both stash modes, the
    interleaved two at vpp = 2) against forward_backward_no_pipelining
    over the same layers in this process, beside a planted fault (a
    cotangent routed to another microbatch's stash); then
    ``train_gpt_pp --pp 2`` and ``--pp 2 --vpp 2``, whose loss falls.

22. Amp (``phase22``): O1, O2, the amp state through a checkpoint,
    DCGAN (see ``--amp`` below).
23. The serving engine's build checks and the kernels' launch plans
    (``phase23``).  23a: ``GptConfig()`` (phase 2's seeded weights)
    built without and with ``ServeConfig(verify=True)`` (both build
    times logged): zero ERROR findings on every program (each prefill
    bucket and the decode step, each linted from the warm-up the build
    runs anyway), each program's memory estimate beside
    ``torch.cuda.max_memory_allocated`` over the same run, phase 2's
    requests served with exact K1/K3/K6 counts and the unverified
    engine's streams, the allocator's live peak against the estimates
    (``memstats.crosscheck``, no drift), and a budget 10% under the
    largest estimate failing the build with ``memory-budget`` while one
    10% over builds.  23b: planted faults on a 2-layer engine, each
    caught by its rule beside a clean sound build: a ``.item()`` in the
    prefill body (``transfer-hlo-host``), the pool copied instead of
    written in place (``donation-dropped``), and an f32 bias widening a
    bf16 layer (``promotion-widen``; the sound layer is clean).  23c
    (after phase 5): every distinct launch of the run (phase 4's timing
    aside), its plan from the op modules' ``kernel_specs`` against the
    card's own figures (``csrc/launch_query.cuh``: dynamic shared
    memory, CTAs per SM, grid, threads) and its registers against
    ptxas's, all equal.  23d: a tuning cache naming K3/K4 variants for
    one shape launches them there (held to the plain twins) and the
    default elsewhere; a variant that cannot build raises.  23e:
    ``examples/serve_gpt.py`` end to end, its JSONL checked.
24. Observation and the fleet (``phase24``).  24a, in a process of its
    own (``--trace-window``): phase 18a's trainer
    (``GptConfig(remat=True)``, batch 8 x 2048) for 8 steps with a
    profiler window armed by ``APEX_TPU_TRACE_STEPS="2+2"``: the trace's
    K1-K4 kernel events equal the launch counters over the window's two
    steps (a K4 launch is two kernels), the attribution's compute time
    lies within 5% of the trace's summed kernel durations, the fractions
    and ``trace_step_period`` beside a step outside the window (the
    difference is the profiler's cost a step), and
    ``Watchdog(default_rules())`` over the run's meter and goodput fires
    ``mfu_floor`` with the floor at twice the measured MFU and not at
    half of it.  24b: ``examples/train_resilient.py`` as a subprocess
    under ``APEX_TPU_CHAOS`` (NaN steps, a healed save fault, a
    preemption at step 21 of 30) with a profiler window, then again: it
    resumes, and both final ``train/goodput`` records carry the exact
    counts.  24c: the fleet drill (``apex_tpu_torch.tools.fleet_drill``)
    at ``GptConfig()``'s width and 6 of its layers (``P24_DRILL_LAYERS``;
    phase 2's seed, bf16 KV pages, 2 replicas, at most 3): its five guarantees, exact K1/K3/K6 launches
    over every engine of both fleets, its per-request ledgers beside a
    CPU run's; then three decode graph replays under the profiler (what
    kineto records of a replay, logged).  24d: the canary drill at
    ``GptConfig()``: a sound deploy
    passes and rolls to every replica, NaN weights fail within the
    canary fraction and roll back with the incumbent's digest bit for
    bit, exact launches; a planted redeploy that copies the new weights
    into the replicas' shared tensors in place fails the drill with the
    incumbents' fingerprints moved (6 layers too).
25. ROADMAP item 11's first part (``phase25``).  25a:
    ``examples/imagenet/main_amp.py`` (ResNet-50, 1000 classes, 224 x
    224 synthetic images, global batch 128) for 8 steps at O1 and again
    at O2: the median step of steps 2-7, img/s, MFU (3 x the forward's
    convolution and fc FLOPs over 989 TFLOP/s), peak memory, the losses
    finite, no K1-K6 launch (convolutions and batch norm run outside
    Pallas in the reference too).  25b: one training step of ResNet at
    stage sizes (1, 1, 1, 1), full widths, 64 x 64, bf16 on the card
    against f32 on the CPU from the same weights in both norm branches
    (logits, loss, every norm's running statistics), beside symmetric
    padding planted in the strided conv2.  25c: ``main_amp --sync-bn`` at
    dp = 2 (two worker processes on the card over gloo, global batch 32,
    3 steps) against one process at the merged batch (the losses and the
    running statistics), beside statistics planted over each rank's own
    rows.  25d: ``SelfMultiheadAttn`` (with and without
    ``include_norm_add``) and ``EncdecMultiheadAttn`` (Sq 64, Sk 80) at
    E 1024, H 16, S 64, B 120, dropout 0.1: exact K1-K4 launches, card
    bf16 against CPU f32, the padding mask dropped as the planted fault,
    forward + backward timed beside ``torch.nn.MultiheadAttention``.
    25e: ``fmha`` at B 32, S 512, H 16 against its plain twin on the
    rows inside each sequence, and ``FusedLayerNorm``/``FusedRMSNorm`` at
    (16384, 1024) bf16, ``memory_efficient`` both ways, against the CPU
    twins, launches exact.  25f: ``fused_sgd`` (and nesterov), ``larc``
    in front of it, ``fused_adagrad``, ``fused_novograd``,
    ``fused_mixed_precision_lamb`` and ``clip_grad_norm_`` one step on
    ResNet-50's parameters, card against CPU.  Phase 4 times K3/K4 at
    25d's and 25e's shapes too.
26. ROADMAP item 11 steps 1-5 (``phase26``).  26a: ``MLP([480, 1024,
    1024, 512, 256, 1])`` at batch 1024 (relu, sigmoid),
    ``FusedDense(1024, 4096)`` and ``FusedDenseGeluDense(1024, 4096,
    1024)`` over 16384 tokens, bf16 on the card against f32 on the CPU
    beside the activation planted after the last MLP layer, and
    ``FusedDenseGeluDense`` in f32 beside the planted exact GELU; forward
    + backward ms beside ``torch.nn.Linear`` chains.  26b: ``mLSTM(64,
    4096)`` over T 256 at batch 128 (bf16; ms, peak memory; its first 32
    steps against the CPU) and ``LSTM``/``GRU``/``RNNTanh``/``RNNReLU``
    at hidden 1024 (f32) against cuDNN's modules, each LSTM beside the
    i and f gates swapped.  26c: ``WeightNorm(FusedDense(1024, 4096))``
    against the CPU, ``remove(apply(p))`` within one ulp.  26d: the native
    host ops built from the checkout, bit for bit against their numpy
    replay at phase 8's batch and over BERT-Large's parameters, phase 8's
    batches drawn through them.  26e: ``step_profile --target gpt`` in a
    process of its own at ``GptConfig()`` (its fractions, the MFU pin,
    the trace's K1-K4 events equal to the launch counters),
    ``trace_summary`` over its window, ``timeline --json`` over phase
    24's span and flight dumps (exit 0, and 1 with a terminal event
    deleted).  26f: the standalone GPT and BERT providers (f32) against
    the CPU with exact f32 K1-K4 launches.
27. The last of ROADMAP item 11, the remaining contrib packages
    (``phase27``).  27a: ``Bottleneck`` at ResNet-50's layer 3 stride-1
    block and layer 2's first block (batch 128), ``ConvBias``/
    ``ConvBiasReLU``/``ConvBiasMaskReLU`` at a 3x3 256-channel conv (56 x
    56, batch 32; no layout copy around cuDNN's channels-last
    convolution), ``GroupNorm(32, C, act="silu")`` at Stable Diffusion
    v1.5's UNet shapes and ``BatchNorm2d_NHWC(fuse_relu=True)`` with
    ``z`` at (128, 14, 14, 1024): f32 on the card against f32 on the CPU
    beside a planted fault each (the residual dropped, one group, the
    ReLU dropped), bf16 forward + backward ms beside ``BottleneckBlock``,
    ``F.conv2d``, ``torch.nn.GroupNorm`` + SiLU and ``torch.nn.
    BatchNorm2d``.  27b: ``focal_loss`` at RetinaNet's OpenImages head
    (8 x 120087 anchors x 264 classes, bf16), ``index_mul_2d`` (65536 x
    128, 2^20 rows gathered) and the RNN-T joint + projection + loss (B
    8, T 256, U 96, H 512, V 1024), forward + backward, one sample each
    against the CPU (the transducer's in f64) beside a planted fault each
    (alpha not flipped, an index_copy scatter, the terminal at y_len -
    1); the transducer's ms and peak memory.  27c: two workers over
    gloo: the halo exchanges exact (beside zero halos),
    ``SpatialBottleneck`` at layer 1 (56 x 56 split 28 / 28) against the
    unsplit block, ``BatchNorm2d_NHWC(bn_group=2)`` against one process
    (beside local statistics), the N/A stubs.  27d: ASP on
    ``GptConfig(remat=True)`` at 8 x 2048: 2 dense FusedAdam steps, the
    masks, 8 masked steps (exactly 2:4 along each pruned weight's input
    axis, losses falling, K1-K4 launches a step the dense step's) beside
    the masks not re-applied after a step; ``resnet50()``'s masks on the
    card and the CPU bit for bit, the permutation search on one
    ``fc2.weight`` on both.
28. ROADMAP item 12, the root tools that drive the system
    (``phase28``).  28a: ``tools/serve_bench.py``'s port at
    ``GptConfig()``'s width in the tool's f32 (batch 8, 16-token pages,
    64 a sequence, 48 Poisson requests of 64-768 prompt and 32-128 new
    tokens), twice through its ``main``: f32 pages with the prefix
    cache, 512-token chunks, the ops endpoint, a TTFT SLO and span
    chains (then ``timeline --json`` over them), and both int8 wires
    with a 2-layer draft at k = 4; each exits 0 under the tool's gates,
    with K1, K3 f32 and K6 launches exactly those of its engine calls.
    28b: ``goodput_drill`` at its defaults (PASS, the reference drill's
    ledger).  28c: ``flight_view`` over 24b's flight dump (its summary's
    counts the dump's) and ``concurrency_lint`` over the package (exit 0,
    no finding).  28d: ``int8wire_sensitivity`` at the small scale and
    block 256 on 8 DP workers, ``pipeline_cost``'s pp = 2 lockstep rows
    (remat on and off) on 2 workers, their tables printed.
29. The last root tools (``phase29``).  29a: ``ln_tune`` at hidden 1024
    (GPT's) and 4096, bf16, 16384 rows: every block_rows candidate of K1
    and K2 held to the plain versions, then timed; its winners go to a
    tuning cache, which a fresh process reads: K1/K2's launch plan takes
    the cached rows and the outputs still match.  29b: ``comm_structure``
    at world 2 (two workers on the card over gloo): the h 1024 tp + SP
    block's collectives equal ``tp_sp_block_plan``, ResNet-50 DDP's
    gradient sync equals ``sync_plan`` (f32 wire).  29c:
    ``shard_report --target train`` at dp 2 x tp 2 (four workers): no
    ERROR finding, every row's verdict ok.  29d: the ``repo_lint`` CLI
    over the package (exit 0).  The DDP config, 29c and 29d reach no
    kernel and run beside the build, which waits for them at its end;
    29a times alone.

Phase 1 also holds ``fmha_qkvpacked`` (K3 forward, K4 backward) at
BERT's shape against the same function on a CPU copy; phase 6 also
trains 3 steps each under ``remat_policy="dots"`` and ``"sums"``; phases
7 and 9 also run the card under the remat policies, whose losses and
gradients must be equal bit for bit.

The phases run in the order 1, 2, 3, 12, 13, 15, 6, 7, 8, 9, 14, 10,
11, 16, 17, 18, 19, 20, 21, 22, 23 (but 23c), 24, 25, 26, 27, 28, 4,
5, 23c.  The bounds
of the main paths' rows come from the op modules' launch plans
(:func:`apex_tpu_torch.analysis.kernels.roofline`), the others' from
:func:`apex_tpu_torch.analysis.kernels.bound`.
The line before the last is a JSON object of the kernels (every C entry
point, the f32 instances included); the last line is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --f32-attention

times only the f32 instances of K3-K5 (phase 4's rows at the evoformer's
three shapes) and runs phase 10's f32 training, and prints them as one
JSON line: copied beside another tree's ``apex_tpu_torch`` it times that
tree's kernels with this script's timing code, for a comparison of two
commits.

    python3 chip_smoke.py --timing

runs phase 4 alone (no launch counts, no phase-1 errors) and prints its
rows as one JSON line, for the same kind of comparison; the D = 384 rows
of a tree whose kernels refuse that head dim (an older one) are logged
as refused and left out.

    python3 chip_smoke.py --phase1

runs phase 1 alone (every kernel against its plain version) and prints
the errors as one JSON line: the quick check of a kernel's first build.

    python3 chip_smoke.py --resilience

runs phase 14 alone (with the kernels' build) and prints it as one JSON
line.  ``--seed N`` seeds phase 1's generator (default 0): phase 1 on
other seeds shows the margins of its limits, K5 f32's dbias limit (C7)
among them.

    python3 chip_smoke.py --serving

runs the serving phases alone (2, 3, 12, 13, 15 and 5, checked as in
the full run) and prints them as one JSON line.

    python3 chip_smoke.py --chaos

runs phase 15 alone (with the kernels' build) and prints it as one JSON
line.

    python3 chip_smoke.py --context
    python3 chip_smoke.py --experts
    python3 chip_smoke.py --pipeline

run phase 19, 20 or 21 alone (any of them together, with the kernels'
build) and print them as one JSON line.

    python3 chip_smoke.py --parallel

runs phase 16 alone (with the kernels' build; 16a then compares with
its own no-group run only) and prints it as one JSON line.

    python3 chip_smoke.py --dap
    python3 chip_smoke.py --trainer

run phase 17 or phase 18 alone (with the kernels' build; 18a then runs
phase 6's loop itself for the losses it holds) and print it as one JSON
line.

    python3 chip_smoke.py --analysis [--phase1]

runs phase 23 alone (23c over phase 23's own launches; with
``--phase1``, phase 1 first and 23c over both) and prints it as one JSON
line.

    python3 chip_smoke.py --observe

runs phase 24 alone and prints it as one JSON line.

    python3 chip_smoke.py --modules

runs phase 25 alone and prints it as one JSON line.

    python3 chip_smoke.py --tail

runs phase 26 alone (24b and 24c first, for 26e's dumps) and prints it
as one JSON line.

    python3 chip_smoke.py --contrib [--seed N]

runs phase 27 alone and prints it as one JSON line (``--seed`` offsets
its inputs' and weights' seeds, for the margins of its limits).

    python3 chip_smoke.py --tools

runs phase 28 alone (24b first, for 28c's flight dump), then phase 4's
K3 f32 row at 28a's prefill, and prints them as one JSON line.

    python3 chip_smoke.py --evoformer

runs phase 10's bf16 evoformer training alone (its launches logged, not
checked, so that the script can time an older tree's kernels too) and
prints it as one JSON line: the step times and the profiled step's
kernel time by layer.
"""

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet, dense): the bound_ms basis
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
F32_FLOPS = 67e12

#: bf16 output tolerance of a kernel against its plain version: the two
#: round f32 results to bf16 at different points (one to two bf16 steps)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
#: K6 output: both sides softmax in f32 and round once to the output
#: dtype, so they differ by at most one bf16 step (2^-8 at |o| < 1).  K6
#: has no lse check behind its output, so this is tight enough that a
#: kernel dropping one 16-token page of a 2048-token row (|o| ~ 0.04, an
#: error ~7e-3) fails at every length, not only at the short ones
K6_TOL = dict(atol=4e-3, rtol=8e-3)
#: f32 statistics (LayerNorm mean/rstd, attention lse): summation order
F32_TOL = dict(atol=1e-3, rtol=1e-4)
#: the f32 instances of K3, K4 and K5 (csrc/flash_f32.cu) against their
#: f32 twins, on inputs drawn in full f32: FFMA products, and sums in
#: another order than cuBLAS's.  The control that must fail is the same
#: twin with q, k and v rounded to TF32 and its products on TF32 (what a
#: kernel on bf16 or TF32 tensor cores would compute): phase 1 checks that
#: each f32 case's control fails this limit.  The limit sits between the
#: two, about a factor of 20 from each on an H100: phase 1 logs both
#: readings as "worst err/allowance" (PERF.md).  K5's dbias adds a term
#: that grows with the sums it cancels (``K5_F32_SUMS_C``, ROADMAP C7).
F32_ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
#: K2's dw/db: f32 sums over up to 65536 rows (|sum| up to ~1000) taken
#: in another order (per-CTA partials, then torch.sum)
SUM_TOL = dict(atol=1e-2, rtol=1e-3)
#: K4's dq, dk, dv, scaled to the reference, row by row: at S = 2048 an
#: early row's gradient is tens of times a late row's (|dq_i| falls as
#: 1/sqrt(i)), so one absolute tolerance would be loose for late rows.
#: Each element may be off by ``rtol`` of itself (one bf16 step: both
#: sides round to bf16) plus ``row`` times the RMS of its reference row
#: (the kernel's bf16 p and ds) plus ``floor`` times the RMS of the
#: whole tensor (only so that a row whose reference is exactly 0 does
#: not demand exact zeros); and the tensor's relative Frobenius error
#: must stay under ``norm``.  On an H100 the sound kernel reads at most
#: 0.21 of its allowance and a relative error of 2.2e-3 to 2.7e-3; a K4
#: that drops one 64-key tile for the later half of the rows reads ~22
#: times its allowance and 0.07 to 0.08: phase 1 builds that output
#: from the twin's at the training shape and checks that it fails.
K4_TOL = dict(rtol=2 ** -7, row=1 / 8, floor=2 ** -10, norm=1e-2)
#: phase 3: bf16 card engine vs f32 CPU engine on 2-layer logits (logit
#: std ~0.64; a CPU bf16-vs-f32 run of the same check gives ~0.02)
LOGITS_TOL = 0.06
#: phase 3 on the int8 KV wire and on the int8 weight wire: both engines
#: quantize, from bf16 and from f32 values, so a code can move by one
#: step where the two sit on either side of a rounding edge; each limit
#: sits between the sound reading and its planted fault's (WIRE_FAULTS)
LOGITS_TOL_KV_INT8 = 0.1
LOGITS_TOL_WEIGHTS_INT8 = 0.1

#: BERT-Large phase-1 pretraining (``bench.py::bench_bert_lamb``): batch
#: 128, seq 128
BERT_BATCH = 128
BERT_SEQ = 128

REPLACES = {
    "layer_norm_fwd": "apex_tpu/ops/pallas/layer_norm.py:237",
    "layer_norm_bwd": "apex_tpu/ops/pallas/layer_norm.py:258",
    "flash_fwd": "apex_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd": "apex_tpu/ops/pallas/flash_attention.py:873",
    "flash_dbias": "apex_tpu/ops/pallas/flash_attention.py:1108",
    # K5's function (flash_dbias, its pallas_call at :1197) as the
    # epilogue of K4's dQ pass (csrc/flash_bwd.cu), with K4's outputs
    "flash_bwd_dbias": "apex_tpu/ops/pallas/flash_attention.py:1108",
    "paged_decode": "apex_tpu/ops/pallas/decode_attention.py:263",
    # the f32 instances of K3, K4 and K5 (csrc/flash_f32.cu): the same
    # Pallas kernels on f32 inputs, at Precision.HIGHEST
    "flash_fwd_f32": "apex_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd_f32": "apex_tpu/ops/pallas/flash_attention.py:873",
    "flash_dbias_f32": "apex_tpu/ops/pallas/flash_attention.py:1108",
}
#: every kernel's C entry point, as the launch counters name them
KERNEL_ENTRIES = tuple(REPLACES)
#: entries that no main path launches, each held to its twin in phase 1
#: instead: the standalone bf16 K5, because every trainable bias of the
#: ported models is G = BH, RS = Sq, whose gradient leaves K4's dQ pass
#: (flash_bwd_dbias); K5 serves the other layouts and the wide head dims
PHASE1_ONLY_ENTRIES = ("flash_dbias",)


def log(*args):
    print(*args, flush=True)


#: the whole run's seconds by phase (:func:`timed`)
PHASE_SECONDS = {}


def timed(name, fn, *args):
    """``fn(*args)``, its seconds kept under ``name`` in PHASE_SECONDS."""
    t = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t, 1)
    log(f"  (phase {name}: {PHASE_SECONDS[name]} s)")
    return out


def compare(name, out, ref, tol):
    """max |out - ref| after checking ``allclose`` under ``tol``; the
    relative error is reported over elements with |ref| >= 0.1."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    finite = bool(torch.isfinite(out).all())
    ok = finite and bool(torch.allclose(out, ref, **tol))
    max_abs = float(err.max()) if err.numel() else 0.0
    big = ref.abs() >= 0.1
    max_rel = float((err[big] / ref.abs()[big]).max()) if big.any() else 0.0
    allowed = tol["atol"] + tol["rtol"] * ref.abs()
    ratio = float((err / allowed).max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"worst err/allowance={ratio:.3e} tol={tol} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


#: time_ms's spin kernel: the card's clock (cycles a second, ~2 GHz) and
#: the spin's floor and ceiling in seconds
SPIN_HZ = 2e9
SPIN_MIN_S, SPIN_MAX_S = 0.02, 0.2
#: the seconds every time_ms call of the run spun, and the calls
SPIN_TOTAL = {"s": 0.0, "calls": 0}


def time_ms(fn, *, iters=25, warmup=3, flush=None):
    """Median milliseconds of ``fn()`` over ``iters`` runs, each between
    its own CUDA events.  All runs are queued behind a spin kernel
    (``torch.cuda._sleep``: little power, so the clocks stay up) that
    outlasts the host's queueing of them all — twice the host seconds of
    the last warm-up, which is one whole timed run (the flush, the two
    events and ``fn``), within [SPIN_MIN_S, SPIN_MAX_S] — so the card
    runs them back to back and each pair of events measures device
    time, not the host's launch overhead (a small kernel takes less time
    than its Python wrapper).  ``flush`` (a large tensor) is rewritten
    before each run so the inputs come from device memory, not the L2
    cache."""
    import torch

    def run():
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    host_s = SPIN_MAX_S / (2 * iters)
    for _ in range(warmup):
        t = time.perf_counter()
        run()
        host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin_s = min(SPIN_MAX_S, max(SPIN_MIN_S, 2 * iters * host_s))
    SPIN_TOTAL["s"] += spin_s
    SPIN_TOTAL["calls"] += 1
    torch.cuda._sleep(int(spin_s * SPIN_HZ))
    events = [run() for _ in range(iters)]
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


#: the peak each bound is taken against, as apex_tpu_torch.analysis.kernels
#: names it
PEAK_UNITS = {BF16_TENSOR_FLOPS: "bf16_tensor", TF32_TENSOR_FLOPS: "tf32_tensor",
              F32_FLOPS: "f32"}


def bound(bytes_moved, ops, peak_ops):
    """(bound_ms, "bytes" | "operations") of a row whose work has no
    launch plan of its own: :func:`apex_tpu_torch.analysis.kernels.bound`
    (the main paths' rows take :func:`roofline_bound` of their plans)."""
    from apex_tpu_torch.analysis import kernels

    return kernels.bound(bytes_moved, ops, PEAK_UNITS[peak_ops])


def roofline_bound(specs):
    """(bound_ms, bound_by) of a call from its launch plans
    (``kernel_specs``): :func:`apex_tpu_torch.analysis.kernels.roofline`,
    the one formula behind PERF.md's bound column."""
    from apex_tpu_torch.analysis import kernels

    r = kernels.roofline(specs[0])
    return r["bound_ms"], r["bound_by"]


# ---------------------------------------------------------------------------
# inputs at the main-path shapes
# ---------------------------------------------------------------------------


def ln_inputs(rows, hidden, gen):
    import torch

    x = torch.randn(rows, hidden, generator=gen, device="cuda") * 2 + 0.5
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    b = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    return x.to(torch.bfloat16), w, b


def attn_inputs(bh, sq, sk, d, gen):
    import torch

    def r(s):
        return torch.randn(bh, s, d, generator=gen, device="cuda").to(
            torch.bfloat16
        )

    return r(sq), r(sk), r(sk)


def paged_inputs(b, h, d, page, np_, pool, lengths, gen, kv="bf16"):
    import torch

    from apex_tpu_torch.models import rope_cos_sin

    dev = "cuda"
    q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
    if kv == "int8":
        k_pages = torch.randint(-127, 128, (pool, h, page, d), generator=gen,
                                device=dev, dtype=torch.int8)
        v_pages = torch.randint(-127, 128, (pool, h, page, d), generator=gen,
                                device=dev, dtype=torch.int8)
        k_scale = torch.rand(pool, h, page, generator=gen, device=dev) / 64
        v_scale = torch.rand(pool, h, page, generator=gen, device=dev) / 64
    else:
        dtype = torch.bfloat16 if kv == "bf16" else torch.float32
        k_pages = torch.randn(pool, h, page, d, generator=gen,
                              device=dev).to(dtype)
        v_pages = torch.randn(pool, h, page, d, generator=gen,
                              device=dev).to(dtype)
        k_scale = v_scale = None
        if kv == "f32":
            q = q.float()
    perm = torch.randperm(pool - 1, generator=gen, device=dev)[: b * np_] + 1
    table = perm.reshape(b, np_).to(torch.int32).contiguous()
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos_t, sin_t = rope_cos_sin(np_ * page, d, device=dev)
    pos = (lengths.long() - 1).clamp_min(0)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, page_table=table,
                lengths=lengths, k_scale=k_scale, v_scale=v_scale,
                rope_cos=cos_t[pos], rope_sin=sin_t[pos])


MAIN_LENGTHS = [0, 1, 17, 2048, 100, 555, 1024, 2047]


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def phase1(gen):
    """Each kernel against its plain version on the card; returns the
    errors that go into the kernels line."""
    log("phase 1: kernels against their plain versions")
    errs = {"layer_norm_fwd": phase1_ln_fwd(gen),
            "flash_fwd": phase1_flash_fwd(gen)}
    errs["layer_norm_bwd"] = phase1_ln_bwd(gen)
    errs["flash_bwd"] = phase1_flash_bwd(gen)
    phase1_flash_operands(gen)
    errs["fmha_qkvpacked"] = phase1_fmha_qkvpacked()
    phase1_dropout_mask(gen)
    errs.update(phase1_head_dims(gen))
    errs.update(phase1_ring_hops(gen))
    errs["paged_decode"] = phase1_paged(gen)
    return errs


#: K1/K2's rows wider than 1024 values (the wide-row instance): 16384
#: rows (ln_tune's) at GPT-3 XL's 1536 and the 6.7B/Llama class's 4096
#: and 8192, in bf16, and 4096 in f32 (that width's rows under amp O1)
LN_WIDE_SHAPES = ((16384, 1536, "bf16"), (16384, 4096, "bf16"),
                  (16384, 8192, "bf16"), (16384, 4096, "f32"))
#: a row wider than the wide-row instance holds (8192,
#: ``ops/layer_norm.py`` ``WIDE_MAX_HIDDEN``): it streams; timed by
#: ``--timing`` and ``--norms``
LN_STREAM_SHAPE = (16384, 12288, "bf16")


#: K1's wide-row cases (rows, hidden, rms, dtype, eps): LN_WIDE_SHAPES,
#: RMS, fewer rows than the grid (37), the one-element loads of odd
#: widths (2049 bf16 on 8 warps x 16 values, 5001 f32 on 8 x 32), f32 on
#: 8 warps x 32 values
LN_WIDE_FWD_CASES = (
    *((rows, hidden, False, dt, 1e-5) for rows, hidden, dt in LN_WIDE_SHAPES),
    (2048, 4096, True, "bf16", 1e-5), (37, 4096, False, "bf16", 1e-5),
    (1000, 2049, False, "bf16", 1e-5), (300, 5001, True, "f32", 1e-6),
    (64, 8192, False, "f32", 1e-6))


def phase1_ln_fwd(gen):
    """K1 against its twin: y under BF16_TOL (bf16) or F32_TOL (f32), mu
    and rstd under F32_TOL.  Returns max |y - y_ref| at the training
    shape."""
    from apex_tpu_torch.ops import layer_norm as ln

    main_err = None
    # the training shape first (its error goes into the kernels line),
    # then the prefill shape, the decode batch, RMS, a ragged row, the
    # evoformer's f32 rows (MSA 128 x 256 rows of 256, pair 256 x 256
    # rows of 128, eps 1e-6), an odd bf16 width (1001: every row but
    # every eighth starts off a 16-byte boundary, so one element per
    # load), an f32 width of 130 (520 bytes, also one element per load),
    # a wide row that streams (12288 > 8 warps x 32 lanes x 32 values)
    # and narrow rows that share a warp (64 bf16: 8 lanes a row; 33 f32:
    # 16); the second case is phase 16's sharded shape (tp = 2 with
    # sequence parallelism: S x B / 2 rows).  Then the wide-row instance
    # (hidden 1025 to 8192: 4 or 8 warps a row): 1536, 4096 and 8192 in
    # bf16, 4096 and 8192 in f32, RMS, fewer rows than its grid, and odd
    # widths (one element per load) in bf16 and f32
    for rows, hidden, rms, dt, eps in (
            (TRAIN_BATCH * TRAIN_SEQ, 1024, False, "bf16", 1e-5),
            (TRAIN_BATCH * TRAIN_SEQ // 2, 1024, False, "bf16", 1e-5),
            (2048, 1024, False, "bf16", 1e-5), (8, 1024, False, "bf16", 1e-5),
            (2048, 1024, True, "bf16", 1e-5), (37, 1000, False, "bf16", 1e-5),
            (EVO_SEQ * EVO_RES, 256, False, "f32", 1e-6),
            (EVO_RES * EVO_RES, 128, False, "f32", 1e-6),
            # phase 17's DAP rank (half the rows)
            (EVO_SEQ * EVO_RES // DAP, 256, False, "f32", 1e-6),
            (EVO_RES * EVO_RES // DAP, 128, False, "f32", 1e-6),
            (1000, 1001, False, "bf16", 1e-5), (999, 130, True, "f32", 1e-6),
            (64, 12288, False, "bf16", 1e-5), (300, 64, False, "bf16", 1e-5),
            (301, 33, False, "f32", 1e-6),
            *LN_WIDE_FWD_CASES):
        x, w, b = ln_inputs(rows, hidden, gen)
        if dt == "f32":
            x = x.float()
        y, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=eps, rms=rms)
        y_r, mu_r, rstd_r = ln.layer_norm_reference(x, w, b, eps, rms)
        tag = (f"K1 layer_norm_fwd rows={rows} hidden={hidden} {dt} "
               f"rms={rms}")
        e = compare(tag + " y", y, y_r,
                    BF16_TOL if dt == "bf16" else F32_TOL)
        compare(tag + " mu", mu, mu_r, F32_TOL)
        compare(tag + " rstd", rstd, rstd_r, F32_TOL)
        if main_err is None:
            main_err = e
    return main_err


def phase1_flash_fwd(gen):
    """K3 against its twin at D = 64, causal: the training shape (BH =
    batch x heads, run twice for the same bits) first, then phase 16's
    (tp = 2: half the heads), the prefill shapes and ragged and Sq != Sk
    cases.  Returns the training shape's error."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    main_err = None
    for bh, sq, sk in ((TRAIN_BATCH * 16, TRAIN_SEQ, TRAIN_SEQ),
                       (TRAIN_BATCH * 16 // 2, TRAIN_SEQ, TRAIN_SEQ),
                       (16, 16, 16), (16, 1024, 1024), (16, 2048, 2048),
                       (4, 200, 200), (4, 64, 192), (2, 96, 40)):
        q, k, v = attn_inputs(bh, sq, sk, 64, gen)
        out = attn.flash_fwd(q, k, v, scale=0.125, causal=True)
        ref = attn.flash_fwd_reference(q, k, v, scale=0.125, causal=True)
        tag = f"K3 flash_fwd BH={bh} Sq={sq} Sk={sk} D=64 causal"
        e = check_k3(tag, out, ref)
        if main_err is None:
            main_err = e
            check_repeat(tag, out, attn.flash_fwd(q, k, v, scale=0.125,
                                                  causal=True))
        del out, ref
        torch.cuda.empty_cache()
    return main_err


def phase1_paged(gen):
    """K6 against its twin under K6_TOL, idle slots exactly zero.
    Returns the decode batch's error."""
    from apex_tpu_torch.ops import paged_attention as pa

    main_err = None
    b28, h28, d28, page28, np28 = P28_DECODE
    p28 = dict(b=b28, h=h28, d=d28, page=page28, np_=np28,
               pool=b28 * np28 + 1)
    # the decode batch (32 splits a row, run twice for the same bits),
    # int8 pages, f32 pages (one split a row), then head dims past the
    # main path's 64, all with the fused RoPE: 96 and 128 with int8 pages
    # and bf16 pages, 80 and 48, which are no multiple of 32, and 256,
    # 192 and 160, past 128; then lengths that straddle the splits
    cases = (
        ("bf16", dict(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("f32", dict(b=3, h=4, d=32, page=8, np_=3, pool=12,
                     lengths=[17, 9, 0])),
        ("int8", dict(b=8, h=8, d=96, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=8, h=8, d=128, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("bf16", dict(b=8, h=8, d=128, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("bf16", dict(b=4, h=4, d=80, page=16, np_=8, pool=33,
                      lengths=[0, 1, 100, 128])),
        ("f32", dict(b=3, h=4, d=48, page=8, np_=3, pool=12,
                     lengths=[17, 9, 0])),
        # above 128: q and the accumulators in shared memory
        ("int8", dict(b=8, h=8, d=256, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS)),
        ("int8", dict(b=4, h=4, d=192, page=16, np_=8, pool=33,
                      lengths=[0, 1, 100, 128])),
        ("bf16", dict(b=4, h=4, d=160, page=16, np_=8, pool=33,
                      lengths=[0, 1, 100, 128])),
        # lengths across the split edges (NP 12, page 16: 4-page splits,
        # 3 a row): 0, 1, one split, a split + 1, NP x page
        ("bf16", dict(b=6, h=4, d=64, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        ("int8", dict(b=6, h=4, d=128, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        ("f32", dict(b=6, h=2, d=256, page=16, np_=12, pool=80,
                     lengths=[0, 1, 64, 65, 192, 100])),
        ("bf16", dict(b=6, h=2, d=320, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        # rows no multiple of 16 bytes (4-byte copies) or of 4 (element
        # copies), across splits
        ("bf16", dict(b=6, h=2, d=60, page=16, np_=12, pool=80,
                      lengths=[0, 1, 64, 65, 192, 100])),
        ("int8", dict(b=6, h=2, d=34, page=8, np_=20, pool=130,
                      lengths=[0, 1, 64, 65, 160, 100])),
        # phase 28a's decode batch on the tool's f32 pages (64 pages a
        # sequence, several splits a row merged) at phase 4's lengths,
        # then with idle slots, a split edge and a full row
        ("f32", dict(p28, lengths=list(P28_LENGTHS))),
        ("f32", dict(p28, lengths=[0, 1, 64, 65, 513, 1024, 896, 0])),
    )
    for kv, shape in cases:
        args = paged_inputs(**shape, gen=gen, kv=kv)
        kw = {k: args[k] for k in ("k_scale", "v_scale", "rope_cos",
                                   "rope_sin")}
        pos = [args[k] for k in ("q", "k_pages", "v_pages", "page_table",
                                 "lengths")]
        scale = shape["d"] ** -0.5
        out = pa.paged_decode_fwd(*pos, scale=scale, **kw)
        ref = pa.paged_decode_attention_reference(*pos, scale=scale, **kw)
        tag = (f"K6 paged_decode {kv} B={shape['b']} H={shape['h']} "
               f"D={shape['d']} page={shape['page']} NP={shape['np_']}")
        e = compare(tag, out, ref, K6_TOL)
        idle = [i for i, n in enumerate(shape["lengths"]) if n == 0]
        if idle and float(out[idle].float().abs().max()) != 0.0:
            raise AssertionError(tag + ": an idle slot is not exactly zero")
        if main_err is None:
            main_err = e
            # the splits merge in a fixed order: the same bits again
            check_repeat(tag, (out,), (pa.paged_decode_fwd(*pos, scale=scale,
                                                           **kw),))
    return main_err


#: (rows, hidden, dtype, rms, memory_efficient): the training shape, the
#: other modes, ragged rows, f32, one hidden size for each of K2's
#: register variants (a lane holds 4, 8, 16 or 32 values, from 16-byte
#: loads or one element per load), rows wider than that (streamed), the
#: evoformer's f32 rows (MSA 128 x 256 rows of 256, pair 256 x 256 rows
#: of 128), an odd bf16 width whose rows start off 16-byte boundaries
#: (1001), an f32 width of 130, a wide row (12288) and narrow rows that
#: share a warp (64, 33)
LN_BWD_CASES = (
    (16384, 1024, "bf16", False, False),
    (16384, 1024, "bf16", False, True),
    (8192, 1024, "bf16", False, False),  # phase 16: tp = 2 with SP
    (8192, 1024, "bf16", False, True),
    (1000, 1024, "bf16", True, False),
    (37, 768, "f32", False, True),
    (37, 768, "f32", True, True),
    (64, 200, "f32", False, False),
    (64, 500, "bf16", True, True),
    (64, 2000, "bf16", False, False),
    (64, 4096, "f32", False, True),
    (64, 5000, "f32", False, False),
    (128 * 256, 256, "f32", False, False),
    (256 * 256, 128, "f32", False, False),
    (64 * 256, 256, "f32", False, False),   # phase 17: a DAP rank's rows
    (128 * 256, 128, "f32", False, False),
    (1000, 1001, "bf16", False, False),
    (999, 130, "f32", False, True),
    (64, 12288, "bf16", False, True),
    (300, 64, "bf16", True, False),
    (301, 33, "f32", False, False),
    # the wide-row instance: LN_WIDE_SHAPES, x_is_output at 4096 and
    # 8192, RMS, fewer rows than the grid, odd widths (one element per
    # load) in both modes, and f32 x_is_output on 8 warps x 32 values
    *((rows, hidden, dt, False, False) for rows, hidden, dt in LN_WIDE_SHAPES),
    (16384, 4096, "bf16", False, True),
    (16384, 8192, "bf16", True, True),
    (2048, 4096, "bf16", True, False),
    (37, 4096, "bf16", False, False),
    (1000, 2049, "bf16", False, True),
    (300, 5001, "f32", True, False),
    (64, 8192, "f32", False, True),
    # x_is_output reads b: a bias one float into a flat buffer (off a
    # 16-byte boundary) takes one element per load, at 4096 and at 1024
    (2048, 4096, "bf16", False, True, "b_off"),
    (2048, 1024, "bf16", False, True, "b_off"),
)
#: the wide K2's planted fault: the sums with one CTA's partial row of dw
#: and db dropped must read at least this many times SUM_TOL
LN_WIDE_FAULT_FACTOR = 10.0


def phase1_ln_bwd(gen):
    """K2 against its twin on the same saved inputs (the twin's forward
    statistics).  dx: BF16_TOL in bf16, F32_TOL in f32; dw and db:
    SUM_TOL (f32 sums over the rows, taken in another order).  A case
    marked ``b_off`` passes b as a view one float into a flat buffer."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln

    main_err = None
    for rows, hidden, dt, rms, me, *marks in LN_BWD_CASES:
        x, w, b = ln_inputs(rows, hidden, gen)
        if dt == "f32":
            x = x.float()
        if "b_off" in marks:
            b = torch.cat([b.new_zeros(1), b])[1:]
        if me:
            w[::7] = 0.0  # the w == 0 guard of the recovered xhat
        y, mu, rstd = ln.layer_norm_reference(x, w, b, 1e-5, rms)
        g = torch.randn(rows, hidden, generator=gen, device="cuda").to(x.dtype)
        saved = y if me else x
        out = ln.layer_norm_bwd(saved, w, b, mu, rstd, g, rms=rms,
                                x_is_output=me)
        ref = ln.layer_norm_bwd_reference(saved, w, b, mu, rstd, g, rms, me)
        tag = (f"K2 layer_norm_bwd rows={rows} hidden={hidden} {dt} rms={rms} "
               f"memory_efficient={me}" + "".join(f" {m}" for m in marks))
        e = compare(tag + " dx", out[0], ref[0],
                    BF16_TOL if dt == "bf16" else F32_TOL)
        compare(tag + " dw", out[1], ref[1], SUM_TOL)
        compare(tag + " db", out[2], ref[2], SUM_TOL)
        if main_err is None:
            main_err = e
    phase1_ln_wide_sums(gen)
    return main_err


def phase1_ln_wide_sums(gen):
    """The wide K2's dw and db at (16384, 4096) bf16: from its partial
    rows (one a CTA) against the twin under SUM_TOL, the same sums with
    CTA 0's partial row dropped (a planted fault that must read at least
    LN_WIDE_FAULT_FACTOR times SUM_TOL), and two runs equal bit for
    bit."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln

    x, w, b = ln_inputs(16384, 4096, gen)
    _, mu, rstd = ln.layer_norm_reference(x, w, b, 1e-5, False)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    _, part = ln._bwd_parts(x, w, b, mu, rstd, g, rms=False,
                            x_is_output=False)
    _, dw_r, db_r = ln.layer_norm_bwd_reference(x, w, b, mu, rstd, g, False,
                                                False)
    sound = max(_tol_ratio(s, r, SUM_TOL)
                for s, r in zip(part.sum(dim=0), (dw_r, db_r)))
    fault = max(_tol_ratio(s, r, SUM_TOL)
                for s, r in zip(part[1:].sum(dim=0), (dw_r, db_r)))
    runs = [ln.layer_norm_bwd(x, w, b, mu, rstd, g, rms=False,
                              x_is_output=False)[1:] for _ in range(2)]
    same = all(torch.equal(a, c) for a, c in zip(*runs))
    log(f"  K2 wide (16384, 4096) bf16: {part.shape[0]} partial rows; dw/db "
        f"worst err/allowance under SUM_TOL sound {sound:.4f}, CTA 0's "
        f"partial row dropped {fault:.4f} (must be >= "
        f"{LN_WIDE_FAULT_FACTOR}); two runs bit-identical: {same}")
    if not (sound < 1.0 and fault >= LN_WIDE_FAULT_FACTOR and same):
        raise AssertionError(
            f"K2 wide sums: sound {sound}, dropped partial row {fault}, "
            f"bit-identical {same}")


#: (BH, Sq, Sk, causal, with dlse): the training shape, phase 16's (tp =
#: 2: half the heads), ragged lengths, Sq < Sk, Sq > Sk with fully-masked
#: rows, non-causal, and an lse cotangent folded into delta
FLASH_BWD_CASES = (
    (128, 2048, 2048, True, False),
    (64, 2048, 2048, True, False),
    (4, 1000, 1000, True, False),
    (4, 17, 17, True, False),
    (4, 64, 192, True, False),
    (4, 200, 72, True, False),
    (4, 200, 130, False, False),
    (4, 300, 300, True, True),
)


def k4_check(out, ref):
    """(ok, max |out - ref|, relative Frobenius error, worst ratio of an
    element's error to its allowance) under ``K4_TOL``."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    row_rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    allowed = (K4_TOL["rtol"] * ref.abs() + K4_TOL["row"] * row_rms
               + K4_TOL["floor"] * ref.pow(2).mean().sqrt())
    rel = float(err.norm() / ref.norm().clamp_min(1e-30))
    ratio = float((err / allowed.clamp_min(1e-30)).max())
    ok = (bool(torch.isfinite(out).all()) and bool((err <= allowed).all())
          and rel <= K4_TOL["norm"])
    return ok, float(err.max()), rel, ratio


def k4_dropped_tile(q, k, v, do, m, l, delta, ref, scale):
    """The twin's (dq, dk, dv) less what the 64-key tile at S/4 gives the
    later half of the query rows, in bf16: what a K4 that skipped that
    tile for those rows would return (causal, Sq = Sk = S >= 256, so the
    tile lies below the diagonal for every one of those rows)."""
    import torch

    s = q.shape[1]
    rows, keys = slice(s // 2, None), slice(s // 4, s // 4 + 64)
    qr, dor = q[:, rows].float(), do[:, rows].float()
    kt, vt = k[:, keys].float(), v[:, keys].float()
    p = (torch.exp(qr @ kt.transpose(1, 2) * scale - m[:, rows, None])
         / l[:, rows, None])
    ds = p * (dor @ vt.transpose(1, 2) - delta[:, rows, None])
    dq, dk, dv = (t.float() for t in ref)
    dq[:, rows] -= scale * ds @ kt
    dk[:, keys] -= scale * ds.transpose(1, 2) @ qr
    dv[:, keys] -= p.transpose(1, 2) @ dor
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def check_k3(tag, out, ref):
    """K3's (o, lse, m, l) against its twin's: o within BF16_TOL, the f32
    row statistics within F32_TOL.  Returns max |o - o_ref|."""
    e = compare(tag + " o", out[0], ref[0], BF16_TOL)
    for name, a, r in zip(("lse", "m", "l"), out[1:], ref[1:]):
        compare(f"{tag} {name}", a, r, F32_TOL)
    return e


def check_k4(tag, out, ref):
    """K4's (dq, dk, dv) against its twin's under ``K4_TOL``; returns
    each max |out - ref|."""
    errs = []
    for n, a, r in zip(("dq", "dk", "dv"), out, ref):
        ok, max_abs, rel, ratio = k4_check(a, r)
        log(f"  {tag} {n}: max_abs_err={max_abs:.3e} rel_fro_err="
            f"{rel:.3e} worst err/allowance={ratio:.3e} tol={K4_TOL} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {n} disagrees with its twin")
        errs.append(max_abs)
    return errs


def check_repeat(tag, first, again):
    """A kernel run twice on the same inputs must give the same bits: K3
    and K4 use no atomics, so no sum depends on the order in which the
    blocks finish."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"  {tag}: a second run on the same inputs is "
        f"{'bit-identical' if same else 'DIFFERENT: FAIL'}")
    if not same:
        raise AssertionError(f"{tag} differs from run to run")


def phase1_flash_bwd(gen):
    """K4 against its twin on the same bf16 q, k, v, dO and the same f32
    lse and delta (from the f32 reference forward), under ``K4_TOL``:
    the kernel rounds p and ds to bf16 for its products, as the TPU's
    bf16 passes do, and both round the result to bf16.  At the training
    shape (the first case), an output with one tile dropped must fail
    the same check."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    main_err = None
    for bh, sq, sk, causal, with_dlse in FLASH_BWD_CASES:
        q, k, v = attn_inputs(bh, sq, sk, 64, gen)
        do = torch.randn(bh, sq, 64, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, _, m, l = attn.flash_fwd_reference(q, k, v, causal=causal,
                                              scale=0.125)
        delta = (do.float() * o.float()).sum(-1)
        if with_dlse:
            delta = delta - torch.randn(bh, sq, generator=gen, device="cuda")
        del o
        out = attn.flash_bwd(q, k, v, do, m, l, delta, scale=0.125,
                             causal=causal)
        ref = attn.flash_bwd_reference(q, k, v, do, m, l, delta, scale=0.125,
                                       causal=causal)
        tag = (f"K4 flash_bwd BH={bh} Sq={sq} Sk={sk} D=64 causal={causal} "
               f"dlse={with_dlse}")
        errs = check_k4(tag, out, ref)
        if main_err is None:
            main_err = max(errs)
            check_repeat(tag, out, attn.flash_bwd(q, k, v, do, m, l, delta,
                                                  scale=0.125, causal=True))
            bad = k4_dropped_tile(q, k, v, do, m, l, delta, ref, 0.125)
            for n, a, r in zip(("dq", "dk", "dv"), bad, ref):
                ok, max_abs, rel, ratio = k4_check(a, r)
                log(f"  {tag} {n} with one 64-key tile dropped for the "
                    f"later half of the rows: max_abs_err={max_abs:.3e} "
                    f"rel_fro_err={rel:.3e} worst err/allowance="
                    f"{ratio:.3e} {'passes: FAIL' if ok else 'fails: ok'}")
                if ok:
                    raise AssertionError(
                        f"K4_TOL cannot tell a dropped tile in {n}")
            del bad
        del out, ref
        torch.cuda.empty_cache()
    return main_err


def padding_bias(lengths, s):
    """BERT's key-padding mask in the kernels' layout: (B, 1, S) f32, 0 on
    the first ``lengths[b]`` keys and MASK_VALUE after (G = B, RS = 1)."""
    import torch

    keep = torch.arange(s, device="cuda")[None] < lengths[:, None]
    return torch.where(keep, 0.0, -1e9)[:, None, :].contiguous()


def bert_lengths(gen, batch=BERT_BATCH, s=BERT_SEQ):
    """Ragged key lengths in [1, S] with row 0 full and row 1 empty (a
    sequence with no real token: every key masked by the bias)."""
    import torch

    lengths = torch.randint(1, s + 1, (batch,), generator=gen, device="cuda")
    lengths[0], lengths[1] = s, 0
    return lengths


def phase1_flash_operands(gen):
    """K3 and K4 with the bias and dropout operands against their twins
    (K3: BF16_TOL and F32_TOL; K4: K4_TOL), on the same inputs and seed:
    BERT's shape (BH = 128·16, S = 128, non-causal) with its (B, 1, S)
    key-padding bias over ragged lengths and one fully masked row, with
    and without dropout 0.1, and dropout alone; then every other bias
    layout (G = BH / B / 1, RS = S_q / 1) at smaller ragged shapes, causal
    and not, with and without dropout; and biases whose S_k is not a
    multiple of 4 (rows TMA cannot map, read from global memory instead),
    at D = 32 and 64."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K3/K4 bias and dropout operands against their twins")
    heads = 16
    bert_bias = padding_bias(bert_lengths(gen), BERT_SEQ)

    def rand_bias(g, rs, sk):
        return torch.randn(g, rs, sk, generator=gen, device="cuda")

    # (tag, BH, Sq, Sk, causal, bias, dropout_p, D)
    bh = BERT_BATCH * heads
    cases = [
        ("BERT padding bias G=B RS=1", bh, BERT_SEQ, BERT_SEQ, False,
         bert_bias, 0.0, 64),
        ("BERT padding bias G=B RS=1 + dropout 0.1", bh, BERT_SEQ, BERT_SEQ,
         False, bert_bias, 0.1, 64),
        ("dropout 0.1 alone", bh, BERT_SEQ, BERT_SEQ, False, None, 0.1, 64),
        ("G=BH RS=Sq", 8, 200, 200, True, rand_bias(8, 200, 200), 0.0, 64),
        ("G=BH RS=Sq", 8, 200, 136, False, rand_bias(8, 200, 136), 0.0, 64),
        ("G=B RS=Sq + dropout 0.1", 8, 136, 200, True,
         rand_bias(2, 136, 200), 0.1, 64),
        ("G=1 RS=1", 8, 200, 200, True, rand_bias(1, 1, 200), 0.0, 64),
        ("G=1 RS=Sq + dropout 0.1", 8, 96, 200, False,
         rand_bias(1, 96, 200), 0.1, 64),
        ("G=BH RS=1 + dropout 0.5", 8, 72, 72, True, rand_bias(8, 1, 72),
         0.5, 64),
    ]
    for d in (32, 64):
        cases += [
            ("G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, True,
             rand_bias(2, 130, 37), 0.0, d),
            ("G=BH RS=1, Sk % 4 != 0", 8, 100, 101, False,
             rand_bias(8, 1, 101), 0.0, d),
        ]
    for tag, bh, sq, sk, causal, bias, p, d in cases:
        q, k, v = attn_inputs(bh, sq, sk, d, gen)
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                             device="cuda", dtype=torch.int32)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p, seed=seed)
        tag = f"{tag} BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}"
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        check_k3("K3 " + tag, attn.flash_fwd(q, k, v, bias, **kw), ref)
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, _, m, l = ref
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, m, l, delta, bias)
        check_k4("K4 " + tag, attn.flash_bwd(*args, **kw),
                 attn.flash_bwd_reference(*args, **kw))
        del ref, o, args
        torch.cuda.empty_cache()


def phase1_fmha_qkvpacked():
    """``fmha_qkvpacked`` (packed (B, S, 3, H, D) input) at BERT's shape
    with its key-padding bias, on the card (K3 forward, K4 backward)
    against the plain twins on the same unpacked operands: the output
    under BF16_TOL and F32-close row statistics, then each of dq, dk, dv
    of the packed gradient under K4_TOL against ``flash_bwd_reference``
    fed the card's own forward output for delta (as every K4 check feeds
    both sides one delta: a bf16 step of o moves delta, which a row over
    a few keys cannot absorb).  Its inputs come from a generator of its
    own, so the other phase-1 checks draw the inputs they drew before it
    existed.  Returns max |o - o_ref|."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(11)
    b, s, h, d = BERT_BATCH, BERT_SEQ, 16, 64
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    bias = padding_bias(bert_lengths(gen), s)  # (B, 1, S): G = B, RS = 1
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    before = _dispatch.launches()
    o = attn.fmha_qkvpacked(qkv, bias[:, None])  # bias (B, 1, 1, S)
    o.backward(do)
    after = _dispatch.launches()
    ran = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    if ran.get("flash_fwd") != 1 or ran.get("flash_bwd") != 1:
        raise AssertionError(f"fmha_qkvpacked launched {ran}, not K3 and K4 "
                             f"once each")

    def flat(x):  # (B, S, H, D) -> (B·H, S, D)
        return x.detach().transpose(1, 2).reshape(b * h, s, d)

    q, k, v = (flat(qkv[:, :, i]) for i in range(3))
    kw = dict(scale=d ** -0.5, causal=False)
    ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
    tag = f"fmha_qkvpacked B={b} S={s} H={h} D={d}, BERT padding bias"
    err = compare(tag + " o", flat(o), ref[0], BF16_TOL)
    m, l = ref[2], ref[3]
    delta = (flat(do).float() * flat(o).float()).sum(-1)
    want = attn.flash_bwd_reference(q, k, v, flat(do), m, l, delta, bias,
                                    **kw)
    check_k4(tag, [flat(qkv.grad[:, :, i]) for i in range(3)], want)
    return err


#: K5's dbias against its twin, element by element: both recompute p and
#: ds in f32 from the same bf16 inputs (the kernel's products on the
#: tensor cores with f32 sums, ``__expf``), so they differ by the f32
#: rounding of the sums and of exp; an element may be off by ``rtol`` of
#: itself plus ``floor`` times the RMS of the whole tensor (an element of
#: dbias is a difference p·(dp - delta) that cancels to near 0), and the
#: relative Frobenius error must stay under ``norm``.  Phase 1 shows that
#: an output with one 64-key tile's dbias halved for the later half of
#: the rows fails the same check.
K5_TOL = dict(rtol=2 ** -10, floor=2 ** -10, norm=1e-3)


def k5_check(out, ref):
    """(ok, max |out - ref|, relative Frobenius error, worst ratio of an
    element's error to its allowance) under ``K5_TOL``."""
    import torch

    err = (out - ref).abs()
    allowed = K5_TOL["rtol"] * ref.abs() + K5_TOL["floor"] * ref.pow(2).mean().sqrt()
    rel = float(err.norm() / ref.norm().clamp_min(1e-30))
    ratio = float((err / allowed.clamp_min(1e-30)).max())
    ok = (bool(torch.isfinite(out).all()) and bool((err <= allowed).all())
          and rel <= K5_TOL["norm"])
    return ok, float(err.max()), rel, ratio


def check_k5(tag, out, ref):
    ok, max_abs, rel, ratio = k5_check(out, ref)
    log(f"  {tag} dbias: max_abs_err={max_abs:.3e} rel_fro_err={rel:.3e} "
        f"worst err/allowance={ratio:.3e} tol={K5_TOL} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} dbias disagrees with its twin")
    return max_abs


#: the evoformer's attention calls at AlphaFold2's initial-training crop
#: (N_res 256, N_seq 128, 4 heads): (BH, S, D, bias) per call
EVO_RES, EVO_SEQ, EVO_HEADS = 256, 128, 4
TRIANGLE_SHAPE = (EVO_RES * EVO_HEADS, EVO_RES, 32)   # start and end node
MSA_ROW_SHAPE = (EVO_SEQ * EVO_HEADS, EVO_RES, 64)    # with the pair bias
MSA_COL_SHAPE = (EVO_RES * EVO_HEADS, EVO_SEQ, 64)    # no bias
#: phase 28a's serving path in the tool's f32 (phases 1 and 4): K6 on
#: f32 pages at its decode batch (B, H, D, page, pages a sequence) over
#: lengths across the load's range, and K3 f32 at its longest causal
#: prefill (BH = 16 heads, S 768, D)
P28_DECODE = (8, 16, 64, 16, 64)
P28_LENGTHS = (896, 800, 640, 513, 320, 192, 96, 65)
P28_PREFILL = (16, 768, 64)
#: phase 17's DAP rank (dap = 2): each attention call on half the rows
DAP = 2
DAP_SHAPES = {"triangle": (TRIANGLE_SHAPE[0] // DAP,) + TRIANGLE_SHAPE[1:],
              "msa_row": (MSA_ROW_SHAPE[0] // DAP,) + MSA_ROW_SHAPE[1:],
              "msa_col": (MSA_COL_SHAPE[0] // DAP,) + MSA_COL_SHAPE[1:]}


def check_fused(tag, out, ref4, ref5, causal):
    """The fused call's (dq, dk, dv, dbias) against the twins': dq, dk,
    dv under K4_TOL, dbias under K5_TOL, and under a causal mask dbias
    exactly 0 at every pair the mask takes away, as the twin's (the key
    tiles the dQ pass skips there are written as zeros).  Returns max
    |dbias - ref|."""
    from apex_tpu_torch.ops import attention as attn

    check_k4(tag, out[:3], ref4)
    e = check_k5(tag, out[3], ref5)
    if causal:
        sq, sk = ref5.shape[1:]
        masked = ~attn._causal_mask(sq, sk, ref5.device)
        got, want = out[3][:, masked], ref5[:, masked]
        ok = bool((got == 0).all()) and bool((want == 0).all())
        log(f"  {tag} dbias: {'exactly 0' if ok else 'NOT 0: FAIL'} at the "
            f"{got.numel()} masked pairs (twin: "
            f"{int((want == 0).sum())} zeros, kernel: "
            f"{int((got == 0).sum())})")
        if not ok:
            raise AssertionError(f"{tag}: dbias is not 0 where the mask is")
    return e


def phase1_flash_dbias(gen):
    """K5 against its twin (``K5_TOL``), and K3/K4 at head dim 32 against
    theirs (BF16_TOL, F32_TOL, K4_TOL), on the same inputs and seed, with
    m, l from the f32 reference forward: the evoformer's three shapes
    first (triangle attention, D = 32, and MSA row attention, D = 64,
    each with its (BH, S, S) bias at G = BH, and K3/K4 at MSA column
    attention's, D = 64, no bias; all non-causal), then every (G, RS)
    layout at smaller ragged shapes, causal and not, Sq != Sk both ways,
    with and without dropout 0.1, D = 32 and 64.  Every G = BH, RS = Sq
    case also runs the fused call (``flash_bwd_dbias``: K4 with the dbias
    as its dQ pass's epilogue, the route of every trainable bias of the
    ported models) against both twins (:func:`check_fused`), with cases
    of its own for S_k % 4 != 0 (the bias read from global memory), a
    causal Sq > Sk (fully masked rows and skipped key tiles: dbias
    exactly 0 at every masked pair), D = 128 and D = 256 (two CTAs a q
    tile).  At the
    triangle shape K5's and the fused call's outputs run twice for the
    same bits, and an output with one tile halved must fail K5_TOL.
    Returns max |dbias - ref| of K5 and of the fused call at the triangle
    shape, K3's and K4's errors there, and the number of cases in which
    the standalone K5 passed K5_TOL (``k5_checks``)."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K5 flash_dbias, the fused flash_bwd_dbias, and K3/K4 at "
        "head dim 32, against their twins")

    def rand_bias(g, rs, sk):
        return torch.randn(g, rs, sk, generator=gen, device="cuda")

    tri_bh, tri_s, _ = TRIANGLE_SHAPE
    row_bh, row_s, _ = MSA_ROW_SHAPE
    col_bh, col_s, _ = MSA_COL_SHAPE
    # (tag, BH, Sq, Sk, D, causal, bias (G, RS) or None (no bias, no K5),
    # dropout_p, with K3/K4)
    cases = [
        ("triangle G=BH RS=Sq", tri_bh, tri_s, tri_s, 32, False,
         (tri_bh, tri_s), 0.0, True),
        ("MSA row G=BH RS=Sq", row_bh, row_s, row_s, 64, False,
         (row_bh, row_s), 0.0, True),
        ("MSA column no bias", col_bh, col_s, col_s, 64, False, None, 0.0,
         True),
        # phase 17's DAP rank: the same calls on half the rows
        ("DAP triangle G=BH RS=Sq", DAP_SHAPES["triangle"][0], tri_s,
         tri_s, 32, False, (DAP_SHAPES["triangle"][0], tri_s), 0.0, True),
        ("DAP MSA row G=BH RS=Sq", DAP_SHAPES["msa_row"][0], row_s, row_s,
         64, False, (DAP_SHAPES["msa_row"][0], row_s), 0.0, True),
        ("DAP MSA column no bias", DAP_SHAPES["msa_col"][0], col_s, col_s,
         64, False, None, 0.0, True),
        ("G=1 RS=Sq", 8, 200, 200, 32, True, (1, 200), 0.0, True),
        ("G=B RS=Sq + dropout 0.1", 8, 136, 200, 64, True, (2, 136), 0.1,
         False),
        ("G=BH RS=1 + dropout 0.1", 8, 200, 136, 32, False, (8, 1), 0.1,
         True),
        ("G=B RS=1", 8, 200, 200, 64, True, (2, 1), 0.0, False),
        ("G=1 RS=1 + dropout 0.1", 8, 72, 200, 32, True, (1, 1), 0.1, True),
        ("G=BH RS=Sq", 8, 200, 72, 64, True, (8, 200), 0.0, False),
        ("G=BH RS=Sq + dropout 0.1", 8, 256, 256, 32, False, (8, 256), 0.1,
         True),
        # the fused call's own cases: S_k odd (no TMA map, one float per
        # store), causal Sq > Sk (rows 0..202 fully masked, key tiles past
        # each warpgroup's limit skipped), D = 128 and D = 256
        ("G=BH RS=Sq, Sk % 4 != 0", 8, 130, 37, 64, True, (8, 130), 0.0,
         False),
        ("G=BH RS=Sq causal Sq > Sk", 8, 333, 130, 32, True, (8, 333), 0.0,
         False),
        ("D=128 G=BH RS=Sq", 8, 256, 256, 128, False, (8, 256), 0.0, False),
        ("D=256 G=BH RS=Sq + dropout 0.1", 8, 200, 200, 256, True, (8, 200),
         0.1, False),
    ]
    main = {}
    k5_checks = 0
    for tag, bh, sq, sk, d, causal, layout, p, with_k34 in cases:
        q, k, v = attn_inputs(bh, sq, sk, d, gen)
        bias = None if layout is None else rand_bias(*layout, sk)
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                             device="cuda", dtype=torch.int32)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p, seed=seed)
        tag = f"{tag} BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}"
        triangle = bh == tri_bh and d == 32
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        if with_k34:
            out = attn.flash_fwd(q, k, v, bias, **kw)
            e3 = check_k3("K3 " + tag, out, ref)
            if triangle:
                check_repeat("K3 " + tag, out,
                             attn.flash_fwd(q, k, v, bias, **kw))
            del out
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, _, m, l = ref
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, m, l, delta, bias)
        del ref, o
        ref4 = None
        if with_k34:
            out = attn.flash_bwd(*args, **kw)
            ref4 = attn.flash_bwd_reference(*args, **kw)
            e4 = check_k4("K4 " + tag, out, ref4)
            if triangle:
                check_repeat("K4 " + tag, out, attn.flash_bwd(*args, **kw))
            del out
        if bias is None:
            del args, q, k, v, do, m, l, delta, ref4
            torch.cuda.empty_cache()
            continue
        ref = attn.flash_dbias_reference(*args, **kw)
        e5 = check_k5("K5 " + tag, attn.flash_dbias(*args, **kw), ref)
        k5_checks += 1
        e45 = None
        if attn._fused_dbias(bias, bh, sq, q.dtype, d):
            if ref4 is None:
                ref4 = attn.flash_bwd_reference(*args, **kw)
            fused = attn.flash_bwd_dbias(*args, **kw)
            e45 = check_fused("K4+K5 flash_bwd_dbias " + tag, fused, ref4,
                              ref, causal)
            if triangle:
                check_repeat("K4+K5 flash_bwd_dbias " + tag, fused,
                             attn.flash_bwd_dbias(*args, **kw))
        if not main:
            main = {"flash_dbias": e5, "flash_fwd_d32": e3,
                    "flash_bwd_d32": max(e4), "flash_bwd_dbias": e45}
            for who, out in (("K5", ref), ("K4+K5 flash_bwd_dbias",
                                           fused[3])):
                bad = out.clone()
                bad[:, sq // 2:, 64:128] *= 0.5
                ok, max_abs, rel, ratio = k5_check(bad, ref)
                log(f"  {who} {tag} with one 64-key tile halved for the "
                    f"later half of the rows: max_abs_err={max_abs:.3e} "
                    f"rel_fro_err={rel:.3e} worst err/allowance="
                    f"{ratio:.3e} {'passes: FAIL' if ok else 'fails: ok'}")
                if ok:
                    raise AssertionError(
                        f"K5_TOL cannot tell a halved tile in {who}")
                del bad
        del ref, ref4, args, q, k, v, do, m, l, delta, bias
        if e45 is not None:
            del fused
        torch.cuda.empty_cache()
    main["k5_checks"] = k5_checks
    return main


#: (tag, BH, Sq, Sk, D, causal, bias (G, RS) or None, dropout_p) of
#: phase 1's head-dim and f32 cases
HEAD_DIM_CASES = (
    ("D=128 causal (the long-context bench's head dim)", 16, 1024, 1024,
     128, True, None, 0.0),
    ("D=128 G=BH RS=Sq", 8, 256, 256, 128, False, (8, 256), 0.0),
    ("D=128 G=B RS=1 + dropout 0.1", 8, 200, 136, 128, True, (2, 1), 0.1),
    ("D=128 G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, 128, True, (2, 130), 0.0),
    ("D=48 (padded to 64)", 8, 200, 200, 48, True, None, 0.0),
    ("D=96 (padded to 128) G=BH RS=Sq + dropout 0.1", 8, 136, 200, 96,
     False, (8, 136), 0.1),
    ("D=96 (padded to 128)", 4, 1000, 1000, 96, True, None, 0.0),
    ("D=256 causal", 8, 512, 512, 256, True, None, 0.0),
    ("D=256 G=BH RS=Sq + dropout 0.1", 8, 256, 256, 256, False, (8, 256),
     0.1),
    ("D=256 G=B RS=1 + dropout 0.1", 8, 200, 136, 256, True, (2, 1), 0.1),
    ("D=256 G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, 256, True, (2, 130), 0.0),
    ("D=160 (padded to 256) G=BH RS=Sq", 8, 200, 200, 160, True, (8, 200),
     0.0),
    # above 256: the wide instance (64-column blocks streamed)
    ("D=320 (padded to 384) causal", 8, 256, 256, 320, True, None, 0.0),
    ("D=384 G=BH RS=Sq + dropout 0.1", 8, 200, 200, 384, False, (8, 200),
     0.1),
    ("D=384 G=B RS=1 + dropout 0.1", 8, 200, 136, 384, True, (2, 1), 0.1),
    ("D=320 (padded to 384) G=BH RS=Sq, Sk % 4 != 0", 8, 130, 37, 320, True,
     (8, 130), 0.0),
)
F32_CASES = (
    ("f32 D=64", 8, 256, 256, 64, True, None, 0.0),
    ("f32 D=64 G=B RS=1 + dropout 0.1", 8, 136, 200, 64, True, (2, 1), 0.1),
    ("f32 D=64 G=BH RS=Sq", 8, 200, 136, 64, False, (8, 200), 0.0),
    ("f32 D=96 (padded to 128)", 8, 200, 200, 96, True, None, 0.0),
    ("f32 D=96 G=BH RS=Sq + dropout 0.1", 8, 200, 72, 96, True, (8, 200),
     0.1),
    ("f32 D=96 G=1 RS=1", 8, 72, 200, 96, False, (1, 1), 0.0),
    ("f32 D=32 + dropout 0.1", 8, 200, 200, 32, True, None, 0.1),
    ("f32 D=64 G=B RS=Sq, Sk % 4 != 0", 8, 130, 37, 64, True, (2, 130), 0.0),
    ("f32 D=192 (padded to 256) G=BH RS=Sq", 4, 136, 200, 192, False,
     (4, 136), 0.0),
    ("f32 D=192 (padded to 256) G=B RS=1 + dropout 0.1", 4, 200, 136, 192,
     True, (2, 1), 0.1),
    ("f32 triangle D=32 G=BH RS=Sq", TRIANGLE_SHAPE[0], TRIANGLE_SHAPE[1],
     TRIANGLE_SHAPE[1], 32, False, (TRIANGLE_SHAPE[0], TRIANGLE_SHAPE[1]),
     0.0),
    ("f32 MSA row D=64 G=BH RS=Sq", MSA_ROW_SHAPE[0], MSA_ROW_SHAPE[1],
     MSA_ROW_SHAPE[1], 64, False, (MSA_ROW_SHAPE[0], MSA_ROW_SHAPE[1]), 0.0),
    ("f32 MSA column D=64 no bias", MSA_COL_SHAPE[0], MSA_COL_SHAPE[1],
     MSA_COL_SHAPE[1], 64, False, None, 0.0),
    # phase 28a's longest causal prefill in the tool's f32
    ("f32 serve_bench prefill D=64 causal", P28_PREFILL[0], P28_PREFILL[1],
     P28_PREFILL[1], P28_PREFILL[2], True, None, 0.0),
    # K5 at D = 128 with two members (64-column blocks, Q and dO streamed)
    ("f32 D=128 G=B RS=Sq", 4, 136, 136, 128, False, (2, 136), 0.0),
    # above 256: the wide instances
    ("f32 D=384 causal", 4, 256, 256, 384, True, None, 0.0),
    ("f32 D=384 G=BH RS=Sq + dropout 0.1", 4, 200, 136, 384, False,
     (4, 200), 0.1),
    ("f32 D=320 (padded to 384) G=B RS=1", 4, 136, 200, 320, True, (2, 1),
     0.0),
    ("f32 D=320 (padded to 384) G=B RS=Sq, Sk % 4 != 0", 4, 130, 37, 320,
     True, (2, 130), 0.0),
)


def tf32_twin(fn, q, k, v, *rest, **kw):
    """The twin ``fn`` with q, k and v rounded to TF32 (10 mantissa bits,
    to nearest) and its products on TF32: the f32 instances' control."""
    import torch

    def tf32(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(tf32(q), tf32(k), tf32(v), *rest, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def f32_control(tag, names, ref, bad):
    """compare() of the TF32 control (:func:`tf32_twin`) with the sound
    twin under F32_ATTN_TOL: at least one output must fail, by more than
    10 times its allowance, or the limit could not tell an f32 kernel
    from one on bf16 or TF32 tensor cores."""
    failed, worst = [], 0.0
    for name, a, r in zip(names, bad, ref):
        a, r = a.float(), r.float()
        allowed = F32_ATTN_TOL["atol"] + F32_ATTN_TOL["rtol"] * r.abs()
        worst = max(worst, float(((a - r).abs() / allowed).max()))
        try:
            compare(f"{tag} {name}, control (twin on TF32)", a, r,
                    F32_ATTN_TOL)
        except AssertionError:
            failed.append(name)
    ok = bool(failed) and worst > 10.0
    log(f"  {tag} control fails on {failed or 'nothing'}, worst "
        f"err/allowance {worst:.1f}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"{tag}: F32_ATTN_TOL does not reject TF32 products by 10x")


#: K5 f32's dbias limit (ROADMAP C7): dbias = p·(dp - delta) cancels two
#: sums of D products down to about 1, so the summation error of the
#: kernel and of its twin grows with the magnitude of those sums, not
#: with |dbias|.  The allowance of element (i, j) adds to F32_ATTN_TOL
#: ``K5_F32_SUMS_C · 2^-23 · t_ij``, ``t_ij = p_ij · (Σ_d |dO_id·v_jd|·D_ij
#: + Σ_d |dO_id·o_id|)`` (D_ij the dropout scale, 1 without dropout); where
#: dbias sums a group's members (G < BH, or RS = 1) the members' t are
#: summed in quadrature, as their independent rounding errors add
#: (:func:`k5_f32_sums`).  Readings on an H100 (NVIDIA H100 80GB HBM3,
#: 700.00 W), phase 1 with seeds 0, 1 and 2, the 13 f32 cases with a
#: bias (D 64-384, the triangle and MSA row shapes): at c = 16 the sound
#: kernel reads at most 0.118 of its allowance (D = 384) and the TF32
#: control at least 29.5 times it (D = 320); the worst sound case needs c
#: >= 0.675 to read 0.5 and the weakest control stays above 10 up to c =
#: 62.1, so c = 16 sits between them (4.2x from the sound side, 2.9x from
#: the control's).  The fixed F32_ATTN_TOL alone read up to 1.717 (seed
#: 1, D = 320, S_k 37) and the control at least 118.6.  The window's
#: edges are read with ``--seed N`` (:func:`k5_f32_readings`).
K5_F32_SUMS_C = 16.0
#: set by ``--seed``: phase 1 also reads, per f32 case, the c at which
#: the sound reading would be 0.5 and the control's 10
K5_F32_WINDOW = False


def k5_f32_sums(q, k, v, do, m, l, bias, do_o, *, scale, causal, dropout_p,
                seed):
    """The twin's ``t = p_ij · (Σ_d |dO_id·v_jd|·D_ij + Σ_d |dO_id·o_id|)``
    (``do_o`` = Σ_d |dO_id·o_id| from the twin's o), causally masked,
    summed in quadrature (sqrt of the sum of squares) into dbias's (G,
    RS, Sk) layout as ``flash_dbias_reference`` sums ds; f32 on the
    card."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    s = attn._flat_scores(q, k, bias, causal, scale)
    t = torch.exp(s - m.float()[..., None]) / l.float()[..., None]
    del s
    dpa = torch.einsum("...qd,...kd->...qk", do.float().abs(),
                       v.float().abs())
    if dropout_p > 0.0:
        keep = attn.dropout_keep_mask(seed, dpa.shape, dropout_p)
        dpa = torch.where(keep, dpa / (1.0 - dropout_p), 0.0)
    t = t * (dpa + do_o.float()[..., None])
    del dpa
    sq, sk = t.shape[-2:]
    if causal:
        t = t.masked_fill(~attn._causal_mask(sq, sk, t.device), 0.0)
    g, rs, _ = bias.shape
    t = (t * t).reshape(g, -1, sq, sk).sum(dim=1)
    return (t.sum(dim=1, keepdim=True) if rs == 1 else t).sqrt()


def k5_f32_readings(err, ref, sums):
    """Readings of one dbias error against the C7 allowance: the worst
    err/allowance at ``K5_F32_SUMS_C`` (``at_c``) and under F32_ATTN_TOL
    alone (``fixed``, the old limit); with :data:`K5_F32_WINDOW`, also
    the c at which the worst ratio would be 0.5 and 10 (bisection; inf
    where no c reaches it)."""
    base = F32_ATTN_TOL["atol"] + F32_ATTN_TOL["rtol"] * ref.abs()
    term = sums * 2.0 ** -23

    def ratio(c):
        return float((err / (base + c * term)).max())

    def c_at(target):
        if ratio(0.0) <= target:
            return 0.0
        lo, hi = 0.0, 1e9
        if ratio(hi) > target:
            return float("inf")
        for _ in range(80):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if ratio(mid) > target else (lo, mid)
        return hi

    out = {"fixed": ratio(0.0), "at_c": ratio(K5_F32_SUMS_C)}
    if K5_F32_WINDOW:
        out.update({"c_for_0.5": c_at(0.5), "c_for_10": c_at(10.0)})
    return out


def check_k5_f32(tag, out, ref, bad, sums):
    """K5 f32's dbias against its twin under the C7 allowance (F32_ATTN_TOL
    plus ``K5_F32_SUMS_C`` times the quadrature term), and the TF32
    control ``bad`` against the same allowance: the sound reading must
    stay at or below 1 and the control's above 10.  Logs both readings,
    with the old fixed limit's beside them, and returns (max |out - ref|,
    the readings)."""
    import torch

    out, ref, bad = out.float(), ref.float(), bad.float()
    err = (out - ref).abs()
    sound = k5_f32_readings(err, ref, sums)
    control = k5_f32_readings((bad - ref).abs(), ref, sums)
    ok = bool(torch.isfinite(out).all()) and sound["at_c"] <= 1.0
    window = (f"; c for 0.5: {sound['c_for_0.5']:.3g}, c for 10: "
              f"{control['c_for_10']:.3g}" if K5_F32_WINDOW else "")
    log(f"  K5 {tag} dbias: max_abs_err={float(err.max()):.3e} worst "
        f"err/allowance {sound['at_c']:.3e} at c={K5_F32_SUMS_C:g} (fixed "
        f"F32_ATTN_TOL {sound['fixed']:.3e}) {'ok' if ok else 'FAIL'}; "
        f"TF32 control {control['at_c']:.1f} (fixed {control['fixed']:.1f}) "
        f"{'ok' if control['at_c'] > 10.0 else 'FAIL'}{window}")
    if not ok:
        raise AssertionError(f"K5 {tag} dbias disagrees with its twin")
    if not control["at_c"] > 10.0:
        raise AssertionError(
            f"K5 {tag}: the C7 allowance does not reject TF32 products by "
            f"10x")
    return float(err.max()), {"sound": sound, "control": control}


def phase1_head_dims(gen):
    """K3, K4 and K5 at the head dims past the main paths' 32 and 64, and
    their f32 instances, against the twins on the same inputs and seed
    (m, l from the twin's forward).  bf16 (``HEAD_DIM_CASES``): D = 128
    and 256, the kernels' own instances, with every bias mode (TMA tiles,
    the key-padding row, a row stride TMA cannot map) and dropout, and D
    = 48, 96 and 160, which the wrappers pad to 64, 128 and 256; K3 under
    BF16_TOL and F32_TOL, K4 under K4_TOL, K5 under K5_TOL, and the D =
    128 causal case run twice for the same bits.  f32 (``F32_CASES``, q,
    k, v and dO drawn in full f32): D 32, 64, 96 and 192, with and
    without a bias, causal and not, with dropout, a bias whose S_k is no
    multiple of 4, and the evoformer's three shapes (triangle, MSA row,
    MSA column) at full size, which phase 10's f32 run gives them; o, lse,
    m, l, dq, dk, dv under F32_ATTN_TOL and dbias under the C7 allowance
    (:func:`check_k5_f32`), and each kernel's TF32
    control (:func:`f32_control`) failing it.  Returns the first D = 128
    case's and the first f32 case's errors for the kernels line."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K3/K4/K5 at D = 128, 256, 384 and padded head dims, and "
        "their f32 instances, against their twins")
    errs, k5_limits = {}, {}
    for tag, bh, sq, sk, d, causal, layout, p in HEAD_DIM_CASES + F32_CASES:
        f32 = tag.startswith("f32")
        if f32:  # full f32: no value that bf16 or TF32 holds exactly
            q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                       for s in (sq, sk, sk))
        else:
            q, k, v = attn_inputs(bh, sq, sk, d, gen)
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(q.dtype)
        bias = (None if layout is None else
                torch.randn(*layout, sk, generator=gen, device="cuda"))
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                             device="cuda", dtype=torch.int32)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_p=p, seed=seed)
        tag = f"{tag} BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}"
        ref = attn.flash_fwd_reference(q, k, v, bias, **kw)
        out = attn.flash_fwd(q, k, v, bias, **kw)
        if f32:
            e3 = compare(f"K3 {tag} o", out[0], ref[0], F32_ATTN_TOL)
            for name, a, r in zip(("lse", "m", "l"), out[1:], ref[1:]):
                compare(f"K3 {tag} {name}", a, r, F32_ATTN_TOL)
            f32_control("K3 " + tag, ("o", "lse"), ref,
                        tf32_twin(attn.flash_fwd_reference, q, k, v, bias,
                                  **kw))
        else:
            e3 = check_k3("K3 " + tag, out, ref)
        if d in (128, 320) and causal and bias is None and not f32:
            check_repeat("K3 " + tag, out, attn.flash_fwd(q, k, v, bias, **kw))
        o, _, m, l = ref
        delta = (do.float() * o.float()).sum(-1)
        do_o = (do.float() * o.float()).abs().sum(-1)
        args = (q, k, v, do, m, l, delta, bias)
        del ref, out, o
        out = attn.flash_bwd(*args, **kw)
        ref = attn.flash_bwd_reference(*args, **kw)
        if f32:
            e4 = [compare(f"K4 {tag} {n}", a, r, F32_ATTN_TOL)
                  for n, a, r in zip(("dq", "dk", "dv"), out, ref)]
            f32_control("K4 " + tag, ("dq", "dk", "dv"), ref,
                        tf32_twin(attn.flash_bwd_reference, *args, **kw))
        else:
            e4 = check_k4("K4 " + tag, out, ref)
        if d in (128, 320) and causal and bias is None and not f32:
            check_repeat("K4 " + tag, out, attn.flash_bwd(*args, **kw))
        del out, ref
        e5 = None
        if bias is not None and f32:
            ref = attn.flash_dbias_reference(*args, **kw)
            sums = k5_f32_sums(q, k, v, do, m, l, bias, do_o, **kw)
            e5, k5_limits[tag] = check_k5_f32(
                tag, attn.flash_dbias(*args, **kw), ref,
                tf32_twin(attn.flash_dbias_reference, *args, **kw), sums)
            del ref, sums
        elif bias is not None:
            e5 = check_k5("K5 " + tag, attn.flash_dbias(*args, **kw),
                          attn.flash_dbias_reference(*args, **kw))
        suffix = "_f32" if f32 else "_d128"
        if d in (64, 128) and f"flash_fwd{suffix}" not in errs:
            errs[f"flash_fwd{suffix}"] = e3
            errs[f"flash_bwd{suffix}"] = max(e4)
        if e5 is not None and f"flash_dbias{suffix}" not in errs:
            errs[f"flash_dbias{suffix}"] = e5
        del args, q, k, v, do, m, l, delta, do_o, bias
        torch.cuda.empty_cache()
    errs["k5_f32_limits"] = k5_limits
    return errs


def phase1_dropout_mask(gen):
    """Reads K3's and K4's dropout keep masks back bit for bit at BERT's
    shape (BH = 2048, S = 128, p = 0.1) and compares each with the twin's
    ``dropout_keep_mask``.  BF16_TOL cannot see one flipped bit, which
    moves o by ~|v|/S.  q = 0 makes every score 0; the bias leaves 64
    keys unmasked (keys 0..63 for even bh, 64..127 for odd bh), so every
    (row, key) pair of the (BH, S, S) mask is read once:

    - K3: v is the identity on the unmasked keys, so o[i, c] =
      keep(i, j0 + c) · bf16(1/(1-p)) / 64;
    - K4's dK/dV pass: dO[i, c] = [c == i mod 64] · (1 if i < 64 else 2),
      so dv[j0 + c', c] / (bf16(1/(1-p)) / 64) = keep(c, j) + 2 keep(c + 64,
      j) with j = j0 + c';
    - K4's dQ pass: k = v = the identity on the unmasked keys and dO = 1,
      so dq[i, c] = scale · (keep ? 1/(1-p) : 0 - delta_i) / 64, kept
      iff dq[i, c] > -scale · delta_i / 128."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: K3/K4 dropout keep masks read back bit for bit")
    bh, s, d, p, scale = BERT_BATCH * 16, BERT_SEQ, 64, 0.1, 0.125
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                         device="cuda", dtype=torch.int32)
    keep = attn.dropout_keep_mask(seed, (bh, s, s), p)
    j0 = (torch.arange(bh, device="cuda") % 2) * 64
    cols = torch.arange(s, device="cuda")
    live = (cols[None] >= j0[:, None]) & (cols[None] < j0[:, None] + 64)
    bias = torch.where(live, 0.0, -1e9)[:, None, :].contiguous()
    eye = torch.zeros(bh, s, d, device="cuda")
    eye[live] = torch.eye(d, device="cuda").repeat(bh, 1)
    eye = eye.to(torch.bfloat16)
    zeros = torch.zeros(bh, s, d, dtype=torch.bfloat16, device="cuda")
    kw = dict(scale=scale, causal=False, dropout_p=p, seed=seed)
    # per bh, the (S, 64) block of the mask over its unmasked keys
    want = keep[live[:, None, :].expand(bh, s, s)].reshape(bh, s, 64)
    unit = float(torch.tensor(1 / (1 - p)).to(torch.bfloat16)) / 64

    o, _, m, l = attn.flash_fwd(zeros, zeros, eye, bias, **kw)
    got = o.float() > 0
    bad = int((got != want).sum())
    vals = o.float()[got]
    log(f"  K3 o: {bad} of {want.numel()} mask bits differ; kept entries "
        f"in [{float(vals.min()):.6f}, {float(vals.max()):.6f}], expected "
        f"{unit:.6f}")
    if bad or not torch.all(vals == unit):
        raise AssertionError("K3's dropout mask differs from the twin's")

    rows = torch.arange(s, device="cuda")
    do = torch.zeros(bh, s, d, device="cuda")
    do[:, rows, rows % 64] = torch.where(rows < 64, 1.0, 2.0)
    do = do.to(torch.bfloat16)
    delta = torch.zeros(bh, s, device="cuda")
    _, _, dv = attn.flash_bwd(zeros, zeros, eye, do, m, l, delta, bias, **kw)
    code = torch.round(dv.float()[live] / unit).reshape(bh, 64, d)
    # code[b, c', c] = keep(c, j0 + c') + 2 keep(c + 64, j0 + c')
    got = torch.stack([code % 2, code // 2], 1).bool()  # (bh, 2, 64', 64)
    want_dv = want.reshape(bh, 2, 64, 64).transpose(2, 3)
    bad_dv = int((got != want_dv).sum()) + int((code > 3).sum())
    log(f"  K4 dK/dV pass dv: {bad_dv} of {want.numel()} mask bits differ")

    ones = torch.ones(bh, s, d, dtype=torch.bfloat16, device="cuda")
    o, _, m, l = attn.flash_fwd(zeros, eye, eye, bias, **kw)
    delta = o.float().sum(-1)
    dq, _, _ = attn.flash_bwd(zeros, eye, eye, ones, m, l, delta, bias, **kw)
    got = dq.float() > -scale * delta[..., None] / 128
    bad_dq = int((got != want).sum())
    log(f"  K4 dQ pass dq: {bad_dq} of {want.numel()} mask bits differ")
    if bad_dv or bad_dq:
        raise AssertionError("K4's dropout mask differs from the twin's")


# ---------------------------------------------------------------------------
# phase 2: the serving slice at full width
# ---------------------------------------------------------------------------


PROMPT_LENS = (17, 100, 256, 511, 1000, 1024, 1500, 1900)
NEW_TOKENS = 32


def phase2():
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        Request,
        ServeConfig,
    )

    log("phase 2: GptConfig() at full width, 8 greedy requests")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = GptConfig()
    model = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(1234))
    n_params = sum(p.numel() for p in model.parameters())
    serve = ServeConfig(page_size=16, max_batch=8, max_pages_per_seq=128,
                        num_pages=1025)
    engine = InferenceEngine(cfg, model, serve)
    log(f"  params={n_params} ({n_params / 1e6:.1f} M) "
        f"kv_pool_bytes={sum(t.numel() * t.element_size() for t in engine.cache.values())}")

    warm = ContinuousBatchingScheduler(engine)
    warm.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
    warm.run()

    prefill, decode = engine.prefill, engine.decode

    def serve_once():
        """The 8 requests through a new scheduler, with the host time of
        the prefill and decode calls; checks that each request finished
        and that no page leaked."""
        clock = {"prefill": 0.0, "decode": 0.0, "decode_tokens": 0}

        def timed_prefill(*a, **k):
            t = time.perf_counter()
            out = prefill(*a, **k)  # returns a host token: synchronised
            clock["prefill"] += time.perf_counter() - t
            return out

        def timed_decode(tokens, lengths, *a, **k):
            t = time.perf_counter()
            out = decode(tokens, lengths, *a, **k)  # host tokens: synced
            clock["decode"] += time.perf_counter() - t
            clock["decode_tokens"] += int((np.asarray(lengths) > 0).sum())
            return out

        engine.prefill, engine.decode = timed_prefill, timed_decode
        rs = np.random.RandomState(0)
        sched = ContinuousBatchingScheduler(engine)
        reqs = [
            sched.submit(Request(
                prompt=[int(t) for t in rs.randint(0, cfg.vocab_size,
                                                   size=n)],
                max_new_tokens=NEW_TOKENS,
            ))
            for n in PROMPT_LENS
        ]
        sched.run()
        torch.cuda.synchronize()
        engine.prefill, engine.decode = prefill, decode
        for r in reqs:
            if r.status != "done" or len(r.tokens) != NEW_TOKENS:
                raise AssertionError(
                    f"request of {len(r.prompt)} tokens ended {r.status} "
                    f"({r.shed_reason}) with {len(r.tokens)} tokens"
                )
            if not all(0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError("a generated token is outside the vocab")
        sched.leak_check()
        if engine.pool.in_use != 0:
            raise AssertionError(f"{engine.pool.in_use} pages still in use")
        return reqs, clock

    prefills0, decodes0 = engine.prefill_calls, engine.decode_iters
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    reqs, clock = serve_once()
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    n_prefill = engine.prefill_calls - prefills0
    n_decode = engine.decode_iters - decodes0
    log(f"  prefill_calls={n_prefill} decode_iters={n_decode} "
        f"launches={launches} paths={paths}")
    layers = cfg.num_layers
    want = {
        "layer_norm_fwd": (2 * layers + 1) * (n_prefill + n_decode),
        "flash_fwd": layers * n_prefill,
        "paged_decode": layers * n_decode,
    }
    if launches != want or min(want.values()) <= 0:
        raise AssertionError(f"launches {launches} != expected {want}")
    want_paths = {"layer_norm": "cuda", "flash_attention": "cuda",
                  "paged_decode_attention": "cuda"}
    if paths != want_paths:
        raise AssertionError(f"op paths {paths} != {want_paths}")
    # the same requests again: every shape has run once, so this run
    # pays no first-call cost (cuBLAS's choice and loading of a GEMM
    # kernel for each new shape)
    again = serve_once()[1]
    prompt_tokens = sum(PROMPT_LENS)
    rates = {
        "prefill_tokens": prompt_tokens,
        "prefill_s": clock["prefill"],
        "prefill_tokens_per_s": prompt_tokens / clock["prefill"],
        "decode_tokens": clock["decode_tokens"],
        "decode_steps": n_decode,
        "decode_s": clock["decode"],
        "decode_tokens_per_s": clock["decode_tokens"] / clock["decode"],
        "prefill_tokens_per_s_warm": prompt_tokens / again["prefill"],
        "decode_tokens_per_s_warm": again["decode_tokens"] / again["decode"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"  prefill {rates['prefill_tokens_per_s']:.0f} tokens/s, decode "
        f"{rates['decode_tokens_per_s']:.1f} tokens/s; served again: "
        f"prefill {rates['prefill_tokens_per_s_warm']:.0f}, decode "
        f"{rates['decode_tokens_per_s_warm']:.1f}")
    log("  first tokens:", [r.tokens[:4] for r in reqs])
    return launches, rates, engine, [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# phase 3: card engine (bf16) against the CPU engine (f32), 2 layers
# ---------------------------------------------------------------------------


#: phase 3's planted faults on the card engine, each of which must push
#: its own reading past its wire's limit: the int8 KV codec's scales
#: halved (``encode_kv``'s twin on the card), and the weight codec's
#: scales halved (``comm.dequantize_blocks``)
WIRE_FAULTS = {"kv_int8": "encode_kv scales halved",
               "weights_int8": "weight scales halved"}


def _planted_fault(name):
    """A context manager that plants WIRE_FAULTS[name] (None: none)."""
    import contextlib

    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.serve import cache as cache_lib

    @contextlib.contextmanager
    def patched(module, attr, fn):
        orig = getattr(module, attr)
        setattr(module, attr, fn(orig))
        try:
            yield
        finally:
            setattr(module, attr, orig)

    if name is None:
        return contextlib.nullcontext()
    if name == "kv_int8":
        return patched(cache_lib, "encode_kv", lambda f: (
            lambda x: (lambda c, sc: (c, sc * 0.5))(*f(x))))
    return patched(comm, "dequantize_blocks", lambda f: (
        lambda q, scale, *a, **k: f(q, scale * 0.5, *a, **k)))


def cross_serve(cfg, card, cpu, serve_kw, fault=None):
    """One 256-token prefill and 4 decode steps through a card engine
    and a CPU engine on ``serve_kw`` (``fault`` planted on the card
    engine's calls, its graph captured under it), both fed the CPU's
    tokens.  Returns the steps' (name, card logits, cpu logits, card
    token, cpu token)."""
    import torch

    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    serve = ServeConfig(page_size=16, max_batch=1, max_pages_per_seq=128,
                        num_pages=129, **serve_kw)
    e_card = InferenceEngine(cfg, card, serve)
    e_cpu = InferenceEngine(cpu_cfg, cpu, serve, device="cpu")
    rs = np.random.RandomState(1)
    prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, size=256)]
    p_card, p_cpu = e_card.pool.alloc(17), e_cpu.pool.alloc(17)
    with _planted_fault(fault):
        lg, tg = e_card.prefill(prompt, p_card[:16])
    lc, tc = e_cpu.prefill(prompt, p_cpu[:16])
    steps = [("prefill", lg.float().cpu(), lc, tg, tc)]
    t_card = np.zeros((1, 128), np.int32)
    t_cpu = np.zeros((1, 128), np.int32)
    t_card[0, :17], t_cpu[0, :17] = p_card, p_cpu
    cur, ctx = tc, len(prompt)
    for i in range(4):
        # both engines are fed the reference's token (teacher forcing),
        # so every step compares the same computation
        with _planted_fault(fault):
            lg, ng = e_card.decode(np.array([cur]), np.array([ctx + 1]),
                                   t_card)
        lc, nc = e_cpu.decode(np.array([cur]), np.array([ctx + 1]), t_cpu)
        steps.append((f"decode{i}", lg[0].float().cpu(), lc[0], int(ng[0]),
                      int(nc[0])))
        cur, ctx = int(nc[0]), ctx + 1
    return steps


def check_steps(tag, steps, tol):
    """Each step's logits within ``tol``; a different greedy token only
    at a near-tie.  Returns (worst diff, steps with the same token)."""
    import torch

    worst, same = 0.0, 0
    for name, l_card, l_cpu, tok_card, tok_cpu in steps:
        err = float((l_card - l_cpu).abs().max())
        worst = max(worst, err)
        top = float(l_cpu.max())
        log(f"  {tag} {name}: max|logits diff|={err:.4f} token card="
            f"{tok_card} cpu={tok_cpu} cpu top-1 logit={top:.4f}")
        if not torch.isfinite(l_card).all() or err > tol:
            raise AssertionError(f"{tag} {name}: logits differ by {err}")
        if tok_card == tok_cpu:
            same += 1
        elif float(l_cpu[tok_card]) < top - 2 * tol:
            # a different greedy token is allowed only for a near-tie
            # that the bf16 tolerance itself can flip
            raise AssertionError(
                f"{tag} {name}: greedy token {tok_card} != {tok_cpu} and "
                f"not a near-tie"
            )
    log(f"  {tag}: greedy tokens identical in {same}/{len(steps)} steps; "
        f"worst logits diff {worst:.4f} <= {tol}")
    return worst, same


def phase3():
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    log("phase 3: 2-layer full width, card bf16 against CPU f32, on the "
        "f32 wires, the int8 KV wire and the int8 weight wire")
    cfg = GptConfig(num_layers=2)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    card = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(7))
    cpu = GptModel(cpu_cfg, device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    worst, same = check_steps("f32 wires", cross_serve(cfg, card, cpu, {}),
                              LOGITS_TOL)
    out = {"same_tokens": same, "steps": 5, "max_logits_diff": worst}
    for fault, wire, tol in (("kv_int8", dict(kv_wire="int8"),
                              LOGITS_TOL_KV_INT8),
                             ("weights_int8", dict(weight_wire="int8"),
                              LOGITS_TOL_WEIGHTS_INT8)):
        worst, same = check_steps(fault, cross_serve(cfg, card, cpu, wire),
                                  tol)
        bad = cross_serve(cfg, card, cpu, wire, fault=fault)
        planted = max(float((a - b).abs().max()) for _, a, b, _, _ in bad)
        log(f"  {fault} planted fault ({WIRE_FAULTS[fault]}): worst logits "
            f"diff {planted:.4f}, {planted / tol:.1f}x the limit {tol} "
            f"(the sound reading {worst / tol:.2f}x)")
        if not planted > tol:
            raise AssertionError(f"phase 3: the planted fault of {fault} "
                                 f"reads {planted} <= {tol}")
        out[fault] = {"same_tokens": same, "steps": 5,
                      "max_logits_diff": worst, "planted_fault_diff": planted,
                      "limit": tol}
    # chunked prefill (two 128-token chunks) against the monolithic
    # prefill, both on the card
    serve = ServeConfig(page_size=16, max_batch=1, max_pages_per_seq=128,
                        num_pages=129)
    e_mono = InferenceEngine(cfg, card, serve)
    e_chunk = InferenceEngine(cfg, card, serve)
    rs = np.random.RandomState(1)
    prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, size=256)]
    pages = e_chunk.pool.alloc(16)
    lm, tm = e_mono.prefill(prompt, e_mono.pool.alloc(16))
    e_chunk.chunk_prefill(prompt[:128], 0, pages, pages[:8])
    lc, tc = e_chunk.chunk_prefill(prompt[128:], 128, pages, pages[8:])
    worst, same = check_steps(
        "chunked vs monolithic",
        [("prefill", lc.float().cpu(), lm.float().cpu(), tc, tm)],
        LOGITS_TOL)
    out["chunked_vs_monolithic"] = {"max_logits_diff": worst,
                                    "same_token": bool(same)}
    return out


# ---------------------------------------------------------------------------
# phase 12: the engine's full surface at full width
# ---------------------------------------------------------------------------


#: phase 12's requests: six open with one 1024-token system prompt and
#: go on with these tails, two share nothing; 0, 2, 4, 6 are greedy, the
#: others sample at SAMPLE_TEMP with a stream seed
SYSTEM_TOKENS = 1024
SHARED_TAILS = (17, 60, 100, 250, 400, 700)
ALONE_LENS = (300, 1900)
SAMPLE_TEMP = 0.8
TOP_K = 50
CHUNK_TOKENS = 512


def phase12():
    """``GptConfig()`` (the seeded weights of phase 2) behind the engine
    on both int8 wires with top-k sampling, and a scheduler with the
    prefix cache and 512-token chunks; 8 requests, 32 new tokens each,
    served twice (the second time every prompt hits the cache).  Checks
    the exact launches of K1 and K6 (counted per graph replay; K3 none),
    the pool's accounting after each run, the hits, the hits' streams
    against the cold run's, the sampled tokens' support, the decode
    graph against the eager step bit for bit, and that another stream
    seed draws another stream."""
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        Request,
        ServeConfig,
    )

    log("phase 12: GptConfig() on the int8 KV and weight wires, top-k "
        "sampling, prefix cache, 512-token chunks, the decode graph")
    torch.cuda.empty_cache()
    cfg = GptConfig()
    model = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(1234))
    serve = ServeConfig(page_size=16, max_batch=8, max_pages_per_seq=128,
                        num_pages=1025, kv_wire="int8", weight_wire="int8",
                        top_k=TOP_K, sample_seed=0)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, model, serve).build(chunked=True)
    build_s = time.perf_counter() - t0
    dense_bytes = sum(p.numel() * 2 for p in model.parameters())
    del model
    bf16_pool = (2 * cfg.num_layers * serve.num_pages * cfg.num_heads
                 * serve.page_size * cfg.head_dim * 2)
    mem = {"kv_pool_bytes": engine.kv_pool_bytes(),
           "kv_pool_bytes_bf16": bf16_pool,
           "kv_pool_ratio": engine.kv_pool_bytes() / bf16_pool,
           "weight_bytes": engine.weight_bytes(),
           "weight_bytes_bf16": dense_bytes,
           "graph_launches_per_replay": engine.graph_launches,
           "build_s": build_s}
    log(f"  built in {build_s:.1f} s (every prefill and chunk bucket run "
        f"once, the decode step captured: {engine.graph_launches} counted "
        f"launches a replay); KV pool {mem['kv_pool_bytes']} bytes (int8 "
        f"codes + f32 scales) = {mem['kv_pool_ratio']:.3f} x the bf16 "
        f"pool's {bf16_pool}; resident weights {mem['weight_bytes']} bytes "
        f"(bf16 {dense_bytes})")

    rs = np.random.RandomState(12)
    system = [int(t) for t in rs.randint(0, cfg.vocab_size,
                                         size=SYSTEM_TOKENS)]
    prompts = [system + [int(t) for t in rs.randint(0, cfg.vocab_size,
                                                    size=n)]
               for n in SHARED_TAILS]
    prompts += [[int(t) for t in rs.randint(0, cfg.vocab_size, size=n)]
                for n in ALONE_LENS]
    sampled = [i % 2 == 1 for i in range(len(prompts))]

    def requests(seed_base=100):
        return [Request(prompt=list(p), max_new_tokens=NEW_TOKENS,
                        temperature=SAMPLE_TEMP if sampled[i] else 0.0,
                        stream_seed=seed_base + i if sampled[i] else None)
                for i, p in enumerate(prompts)]

    sched = ContinuousBatchingScheduler(engine, prefix_cache=True,
                                        prefill_chunk_tokens=CHUNK_TOKENS)
    decode = engine.decode
    support = {"checked": 0}

    def checked_decode(tokens, lengths, tables, temps, **kw):
        """The engine's decode, then each sampled row's token against its
        logits' top 50 (phase 12's support check)."""
        logits, nxt = decode(tokens, lengths, tables, temps, **kw)
        rows = np.flatnonzero((np.asarray(lengths) > 0)
                              & (np.asarray(temps) > 0))
        if rows.size:
            # in the top k: at least the k-th largest logit (ties too)
            idx = torch.as_tensor(rows, device=logits.device)
            kth = torch.topk(logits[idx], TOP_K, dim=-1).values[:, -1]
            picked = logits[idx, torch.as_tensor(nxt[rows],
                                                 device=logits.device)]
            if not bool((picked >= kth).all()):
                raise AssertionError(
                    f"a sampled token of slots {rows.tolist()} "
                    f"({nxt[rows].tolist()}) is not in its top {TOP_K}")
            support["checked"] += rows.size
        return logits, nxt

    def serve_once(reqs):
        sched_calls = (engine.prefill_calls, engine.decode_iters)
        for r in reqs:
            sched.submit(r)
        t = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for r in reqs:
            if r.status != "done" or len(r.tokens) != NEW_TOKENS:
                raise AssertionError(
                    f"request of {len(r.prompt)} tokens ended {r.status} "
                    f"({r.shed_reason}) with {len(r.tokens)} tokens")
        # the pool holds only what the cache holds
        sched.leak_check()
        if engine.pool.in_use != len(sched.prefix):
            raise AssertionError(
                f"{engine.pool.in_use} pages in use, the cache holds "
                f"{len(sched.prefix)}")
        return (engine.prefill_calls - sched_calls[0],
                engine.decode_iters - sched_calls[1], wall)

    engine.decode = checked_decode
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    cold = requests()
    chunks1, decodes1, wall1 = serve_once(cold)
    hits1 = sched.prefix.hits
    warm = requests()
    chunks2, decodes2, wall2 = serve_once(warm)
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    engine.decode = decode
    layers = cfg.num_layers
    n_chunk, n_decode = chunks1 + chunks2, decodes1 + decodes2
    want = {"layer_norm_fwd": (2 * layers + 1) * (n_chunk + n_decode),
            "paged_decode": layers * n_decode}
    log(f"  run 1: {chunks1} chunk calls, {decodes1} decode replays, "
        f"{wall1:.2f} s; run 2: {chunks2} chunk calls, {decodes2} decode "
        f"replays, {wall2:.2f} s; launches={launches} paths={paths}")
    if launches != want:
        raise AssertionError(f"phase 12 launches {launches} != {want}")
    want_paths = {"layer_norm": "cuda", "paged_decode_attention": "cuda"}
    if paths != want_paths:
        raise AssertionError(f"phase 12 op paths {paths} != {want_paths}")
    hits = sched.prefix.hits - hits1
    log(f"  prefix cache: run 1 {hits1} hits, {sched.prefix.misses} misses; "
        f"run 2 {hits} hits ({[r.cache_hit_tokens for r in warm]} tokens), "
        f"{sched.forks} copy-on-write forks, {len(sched.prefix)} cached "
        f"pages; {support['checked']} sampled tokens in their top {TOP_K}")
    # run 1 admits all 8 at once, so only the first of the shared prompts
    # to finish commits its pages; run 2 hits at least the system prompt
    if hits != len(prompts) or any(
            r.cache_hit_tokens < min(len(r.prompt), SYSTEM_TOKENS)
            for r in warm):
        raise AssertionError("phase 12: a prompt of run 2 missed the cache")
    for c, w in zip(cold, warm):
        # greedy and seeded streams alike: a hit re-runs the cold run's
        # last chunk over the same pages
        if c.tokens != w.tokens:
            raise AssertionError(
                f"phase 12: the hit's stream {w.tokens[:8]} differs from "
                f"the cold run's {c.tokens[:8]} (temperature "
                f"{c.temperature})")
    if not support["checked"]:
        raise AssertionError("phase 12: no sampled token was checked")

    # graph against eager: 4 steps of the full batch, bit for bit
    eager_checks = {"steps": 0}

    def compared_decode(tokens, lengths, tables, temps, **kw):
        if eager_checks["steps"] < 4 and (np.asarray(lengths) > 0).all():
            le, te, fe = engine._decode_eager(tokens, lengths, tables, temps,
                                              **kw)
            lg, tg = decode(tokens, lengths, tables, temps, **kw)
            if not (torch.equal(lg, le) and np.array_equal(tg, te)
                    and np.array_equal(engine.last_decode_finite, fe)):
                err = float((lg.float() - le.float()).abs().max())
                raise AssertionError(
                    f"phase 12: the graph's decode differs from the eager "
                    f"step (max |logits diff| {err})")
            eager_checks["steps"] += 1
            return lg, tg
        return decode(tokens, lengths, tables, temps, **kw)

    engine.decode = compared_decode
    third = requests()
    serve_once(third)
    engine.decode = decode
    if eager_checks["steps"] < 4:
        raise AssertionError("phase 12: fewer than 4 full-batch steps to "
                             "compare")
    if any(a.tokens != c.tokens for a, c in zip(third, cold)):
        raise AssertionError("phase 12: run 3 differs from run 1")
    # another stream seed draws another stream
    other = requests(seed_base=900)
    serve_once(other)
    differ = [i for i in range(len(prompts))
              if sampled[i] and other[i].tokens != cold[i].tokens]
    if len(differ) != sum(sampled):
        raise AssertionError(f"phase 12: other seeds gave the same stream "
                             f"(requests {differ} differ)")
    log(f"  graph == eager bit for bit over {eager_checks['steps']} full "
        f"steps; the seeded streams repeat under the same seeds and differ "
        f"under others; greedy streams: {[c.tokens[:4] for c in cold[::2]]}")
    return launches, dict(mem, chunk_calls=[chunks1, chunks2],
                          decode_replays=[decodes1, decodes2],
                          run_s=[wall1, wall2], hits=[hits1, hits],
                          forks=sched.forks,
                          sampled_tokens_checked=support["checked"],
                          graph_eager_steps=eager_checks["steps"],
                          peak_memory_bytes=torch.cuda.max_memory_allocated())


# ---------------------------------------------------------------------------
# phase 13: speculative decoding at full width
# ---------------------------------------------------------------------------


#: phase 13: proposals per round and the truncated draft's depth (the
#: reference's ``serve_bench --speculate 4 --draft-layers 2``)
SPEC_K = 4
DRAFT_LAYERS = 2
SPEC_TEMP = 0.8
SPEC_SAMPLED = 4


def _spec_want(cfg, draft_layers, k, calls, chunked):
    """The exact K1/K3/K6 launches of a speculative serving run: each
    target prefill L blocks (K1 2L + 1, K3 L; a chunk call K1 2L + 1 and
    no K3), each draft prefill the draft's, each plain decode replay K1
    2L + 1 and K6 L, each spec round k + 1 draft steps and k + 1 verify
    steps (K1 2Ld + 1 and 2L + 1, K6 Ld and L a step; no K3)."""
    layers, ld = cfg.num_layers, draft_layers
    rounds, plain = calls["spec_rounds"], calls["plain_decodes"]
    return {
        "layer_norm_fwd": (2 * layers + 1) * (calls["prefills"] + plain)
        + (2 * ld + 1) * calls["draft_prefills"]
        + rounds * (k + 1) * (2 * ld + 1 + 2 * layers + 1),
        "flash_fwd": (0 if chunked else layers * calls["prefills"])
        + ld * calls["draft_prefills"],
        "paged_decode": layers * plain + rounds * (k + 1) * (ld + layers),
    }


def _spec_serve(engine, prompts, *, draft_layers, temperature=0.0,
                seeds=None, sched=None, on_round=None):
    """Serve ``prompts`` (32 new tokens each) through a scheduler over a
    speculative engine with the launch counters zeroed before and read
    after; checks that every request finished, the ledger and (without a
    prefix cache) the empty pool, and the exact launches.  Returns
    (streams, launches, calls, clock) — ``clock`` the host time of the
    decode-side engine calls (spec rounds, plain decodes, rollbacks) and
    the n_accept of every live slot of every round."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    sched = sched or ContinuousBatchingScheduler(engine)
    clock = {"decode_s": 0.0, "round_s": [], "accepts": []}
    saved = {n: getattr(engine, n) for n in
             ("spec_step", "decode", "rollback", "draft_rollback")}

    def timed(name):
        fn = saved[name]

        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)  # host tokens or in-place writes
            if name in ("rollback", "draft_rollback"):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
            clock["decode_s"] += dt
            if name == "spec_step":
                clock["round_s"].append(dt)
                live = np.asarray(a[1]) > 0
                clock["accepts"].extend(int(x) for x in out[1][live])
                if on_round is not None:
                    on_round(a, out)
            return out
        return call

    for name in saved:
        setattr(engine, name, timed(name))
    before = dict(prefills=engine.prefill_calls,
                  draft_prefills=engine.draft_prefill_calls,
                  spec_rounds=engine.spec_rounds,
                  decodes=engine.decode_iters)
    reqs = [Request(prompt=list(p), max_new_tokens=NEW_TOKENS,
                    temperature=temperature,
                    stream_seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    try:
        for r in reqs:
            sched.submit(r)
        sched.run()
        torch.cuda.synchronize()
    finally:
        # drop the wrappers (a restored bound method would tie the engine
        # to itself in a cycle and keep its pool and graphs alive)
        for name in saved:
            delattr(engine, name)
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    for r in reqs:
        if r.status != "done" or len(r.tokens) != NEW_TOKENS:
            raise AssertionError(
                f"phase 13: a request of {len(r.prompt)} tokens ended "
                f"{r.status} ({r.shed_reason}) with {len(r.tokens)} tokens")
    sched.leak_check()
    if sched.prefix is None and engine.pool.in_use != 0:
        raise AssertionError(f"phase 13: {engine.pool.in_use} pages in use")
    calls = dict(prefills=engine.prefill_calls - before["prefills"],
                 draft_prefills=(engine.draft_prefill_calls
                                 - before["draft_prefills"]),
                 spec_rounds=engine.spec_rounds - before["spec_rounds"])
    calls["plain_decodes"] = (engine.decode_iters - before["decodes"]
                              - calls["spec_rounds"])
    want = _spec_want(engine.cfg, draft_layers, engine.spec.k, calls,
                      chunked=sched.prefix is not None
                      or sched.prefill_chunk_tokens is not None)
    per_round = engine.spec_graph_launches
    want_round = {
        "layer_norm_fwd": (engine.spec.k + 1) * (2 * draft_layers + 1
                                                 + 2 * engine.cfg.num_layers
                                                 + 1),
        "paged_decode": (engine.spec.k + 1) * (draft_layers
                                               + engine.cfg.num_layers)}
    if launches != want or per_round != want_round:
        raise AssertionError(
            f"phase 13 launches {launches} != {want} (calls {calls}); a "
            f"replay counts {per_round}, want {want_round}")
    want_paths = {"layer_norm": "cuda", "flash_attention": "cuda",
                  "paged_decode_attention": "cuda"}
    if paths != want_paths:
        raise AssertionError(f"phase 13 op paths {paths} != {want_paths}")
    if not calls["spec_rounds"] or sched.draft_faults:
        raise AssertionError(f"phase 13: {calls['spec_rounds']} spec rounds, "
                             f"{sched.draft_faults} draft faults")
    return [r.tokens for r in reqs], launches, calls, clock, sched


def _spec_profile(engine, steps=4):
    """Spec rounds at batch 8 with ~512-token contexts (as phase 5's
    decode profile): host ms a round unprofiled and the counted launches,
    a torch.profiler trace of 4 more (device ms, kernels a round, the
    kernels that took most), and one replay of the captured round between
    CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    rs = np.random.RandomState(2)
    sched = ContinuousBatchingScheduler(engine)
    for _ in range(8):
        sched.submit(Request(
            prompt=[int(t) for t in rs.randint(0, engine.cfg.vocab_size,
                                               size=512)],
            max_new_tokens=(2 * steps + 2) * (engine.spec.k + 1)))
    sched.step()  # the prefills and the first round, not timed
    torch.cuda.synchronize()
    before = _dispatch.launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    after = _dispatch.launches()
    counted = {k: (after.get(k, 0) - before.get(k, 0)) / steps for k in after
               if after.get(k, 0) != before.get(k, 0)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graph = engine._spec_graph["graph"]
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    sched.run()
    kernels = device_kernels(prof)
    out = {"host_ms_per_round_unprofiled": host_ms,
           "counted_launches_per_round": counted,
           "replay_device_ms": statistics.median(times)}
    if kernels:
        busy_us = sum(k[1] for k in kernels)
        out.update({
            "device_ms_per_round": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches_per_round": sum(k[2] for k in kernels) / steps,
        })
        k6 = [k for k in kernels if "paged_decode_kernel" in k[0]]
        out["k6_ms_per_round"] = sum(k[1] for k in k6) / 1e3 / steps
        for key, us, count in sorted(kernels, key=lambda k: -k[1])[:6]:
            log(f"    {us / steps / 1e3:8.4f} ms/round  {count // steps:4d}x"
                f"  {key[:90]}")
    else:
        log("  the profiler recorded no device kernels: device time not "
            "measured")
    log(f"  spec round at batch 8, ~512-token contexts: host "
        f"{host_ms:.3f} ms/round unprofiled, one replay "
        f"{out['replay_device_ms']:.3f} ms (CUDA events), device kernels "
        f"{out.get('device_ms_per_round', float('nan')):.3f} ms/round in "
        f"{out.get('kernel_launches_per_round', float('nan')):.0f} "
        f"launches; counted {counted}")
    return out


def phase13(plain_streams, plain_rates):
    """Speculative decoding at the full width of ``GptConfig()`` (phase
    2's seeded weights), ``ServeConfig(page_size=16, max_batch=8)``,
    ``SpecConfig(k=4)`` with the target's first 2 layers as the draft
    (``draft_from_params``), phase 2's 8 greedy requests:

    - every stream equals phase 2's plain decode bit for bit, with exact
      K1, K3 and K6 launches (K3 only in the prefills; the round one
      graph replay with its launches counted per replay);
    - with a self-draft, every live slot accepts all k proposals on every
      round, the streams again equal phase 2's;
    - on the int8 KV wire, the streams equal plain decode on int8 pages;
    - four requests at temperature 0.8 with stream seeds: at k = 0 the
      streams equal plain decode's; at k = 4, served twice behind the
      prefix cache (the second run hits, and copy-on-write forks the
      span), every emitted token lies in its position's top 50, the
      streams repeat, and no draft page enters the cache;
    - the pool ends empty.

    Reports the draft's acceptance rate, tokens per slot a round, host
    and device ms per round, launches per round and decode tokens/s
    beside phase 2's."""
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        ServeConfig,
        SpecConfig,
        draft_from_params,
    )

    log(f"phase 13: speculative decoding at full width, k={SPEC_K}, a "
        f"{DRAFT_LAYERS}-layer draft, a self-draft, both KV wires")
    torch.cuda.empty_cache()
    cfg = GptConfig()
    model = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(1234))
    serve = ServeConfig(page_size=16, max_batch=8, max_pages_per_seq=128,
                        num_pages=1025, top_k=TOP_K)
    rs = np.random.RandomState(0)  # phase 2's prompts
    prompts = [[int(t) for t in rs.randint(0, cfg.vocab_size, size=n)]
               for n in PROMPT_LENS]
    draft = draft_from_params(model, DRAFT_LAYERS)

    def engine(spec, **kw):
        t0 = time.perf_counter()
        eng = InferenceEngine(cfg, model, dataclasses.replace(serve, **kw),
                              spec=spec).build()
        log(f"  engine {'plain' if spec is None else f'k={spec.k}'} {kw} "
            f"built in {time.perf_counter() - t0:.1f} s; a spec round "
            f"counts {eng.spec_graph_launches}")
        return eng

    def same(tag, got, want):
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"phase 13: {tag}: streams {bad} differ "
                                 f"from plain decode")
        log(f"  {tag}: all {len(got)} streams equal plain decode's")

    out = {}
    # the 2-layer draft on bf16 pages: phase 2's streams, timing
    eng = engine(SpecConfig(draft, k=SPEC_K))
    streams, launches, calls, clock, sched = _spec_serve(
        eng, prompts, draft_layers=DRAFT_LAYERS)
    same(f"{DRAFT_LAYERS}-layer draft, bf16 KV", streams, plain_streams)
    decode_tokens = len(prompts) * (NEW_TOKENS - 1)
    acc = np.asarray(clock["accepts"])
    out["draft"] = {
        "calls": calls, "launches": launches,
        "spec_graph_launches_per_round": eng.spec_graph_launches,
        "acceptance_rate": sched.spec_accepted / sched.spec_drafted,
        "tokens_per_slot_round": float((acc + 1).mean()),
        "rollbacks": sched.spec_rollbacks,
        "host_ms_per_round": 1e3 * float(np.mean(clock["round_s"])),
        "decode_s": clock["decode_s"],
        "decode_tokens_per_s": decode_tokens / clock["decode_s"],
        "plain_decode_tokens_per_s": plain_rates["decode_tokens_per_s"],
    }
    d = out["draft"]
    log(f"  {calls}; acceptance {d['acceptance_rate']:.4f} "
        f"({sched.spec_accepted}/{sched.spec_drafted}), "
        f"{d['tokens_per_slot_round']:.3f} tokens a slot a round, "
        f"{d['rollbacks']} rollbacks, host {d['host_ms_per_round']:.3f} ms "
        f"a round; decode {d['decode_tokens_per_s']:.1f} tokens/s against "
        f"phase 2's plain {d['plain_decode_tokens_per_s']:.1f}")
    out["draft"]["profile"] = _spec_profile(eng)

    # the same engine: 4 seeded sampled requests twice behind the cache
    seeds = [100 + i for i in range(SPEC_SAMPLED)]
    support = {"checked": 0}

    def in_top_k(args, res):
        toks, acc_r, _ = res
        logits = eng.last_verify_logits
        for b in np.flatnonzero(np.asarray(args[1]) > 0):
            for j in range(int(acc_r[b]) + 1):
                row = logits[j, b]
                kth = torch.topk(row, TOP_K).values[-1]
                if not bool(row[int(toks[b, j])] >= kth):
                    raise AssertionError(
                        f"phase 13: token {int(toks[b, j])} of slot {b} at "
                        f"position {j} is not in its top {TOP_K}")
                support["checked"] += 1

    cached = ContinuousBatchingScheduler(eng, prefix_cache=True,
                                         prefill_chunk_tokens=CHUNK_TOKENS)
    runs = []
    for _ in range(2):
        s_streams, s_launches, s_calls, _, _ = _spec_serve(
            eng, prompts[:SPEC_SAMPLED], draft_layers=DRAFT_LAYERS,
            temperature=SPEC_TEMP, seeds=seeds, sched=cached,
            on_round=in_top_k)
        runs.append(s_streams)
        if any(eng.pool.namespace(p) != "kv"
               for p in cached.prefix.cached_pages()):
            raise AssertionError("phase 13: a draft page is in the cache")
        if eng.pool.in_use != len(cached.prefix):
            raise AssertionError("phase 13: pages outside the cache's hold")
    if runs[0] != runs[1] or not cached.prefix.hits or not cached.forks:
        raise AssertionError(
            f"phase 13: the cached run's seeded streams differ, or it did "
            f"not hit ({cached.prefix.hits} hits, {cached.forks} forks)")
    cached.prefix.flush()
    if eng.pool.in_use:
        raise AssertionError("phase 13: pages left after the cache's flush")
    log(f"  sampled at k={SPEC_K} behind the prefix cache, served twice: "
        f"{cached.prefix.hits} hits, {cached.forks} forks, the streams "
        f"repeat, {support['checked']} emitted tokens in their top {TOP_K}")
    out["sampled_k4"] = {"tokens_checked": support["checked"],
                         "hits": cached.prefix.hits, "forks": cached.forks,
                         "launches": s_launches, "calls": s_calls}
    del eng, cached, sched
    torch.cuda.empty_cache()

    # self-draft: every proposal accepted
    eng = engine(SpecConfig(None, k=SPEC_K))
    streams, launches, calls, clock, sched = _spec_serve(
        eng, prompts, draft_layers=cfg.num_layers)
    same("self-draft, bf16 KV", streams, plain_streams)
    if set(clock["accepts"]) != {SPEC_K}:
        raise AssertionError(f"phase 13: a self-draft slot accepted "
                             f"{sorted(set(clock['accepts']))}, not {SPEC_K}")
    out["self_draft"] = {
        "calls": calls, "launches": launches,
        "acceptance_rate": sched.spec_accepted / sched.spec_drafted,
        "host_ms_per_round": 1e3 * float(np.mean(clock["round_s"])),
        "decode_tokens_per_s": decode_tokens / clock["decode_s"]}
    log(f"  self-draft: every live slot accepted {SPEC_K} of {SPEC_K} on "
        f"all {calls['spec_rounds']} rounds; host "
        f"{out['self_draft']['host_ms_per_round']:.3f} ms a round, decode "
        f"{out['self_draft']['decode_tokens_per_s']:.1f} tokens/s")
    del eng, sched
    torch.cuda.empty_cache()

    # the int8 KV wire against plain decode on int8 pages
    base = engine(None, kv_wire="int8")
    sched = ContinuousBatchingScheduler(base)
    want8 = [sched.submit(_plain_request(p)) for p in prompts]
    sched.run()
    want8 = [r.tokens for r in want8]
    del base, sched
    eng = engine(SpecConfig(draft, k=SPEC_K), kv_wire="int8")
    streams, launches, calls, clock, sched = _spec_serve(
        eng, prompts, draft_layers=DRAFT_LAYERS)
    same(f"{DRAFT_LAYERS}-layer draft, int8 KV", streams, want8)
    out["int8_kv"] = {"calls": calls, "launches": launches,
                      "acceptance_rate": (sched.spec_accepted
                                          / sched.spec_drafted)}
    del eng, sched
    torch.cuda.empty_cache()

    # k = 0: sampled streams equal plain decode's
    base = engine(None)
    sched = ContinuousBatchingScheduler(base)
    want_s = [sched.submit(_plain_request(p, SPEC_TEMP, seeds[i]))
              for i, p in enumerate(prompts[:SPEC_SAMPLED])]
    sched.run()
    want_s = [r.tokens for r in want_s]
    del base, sched
    eng = engine(SpecConfig(draft, k=0))
    streams, launches, calls, _, _ = _spec_serve(
        eng, prompts[:SPEC_SAMPLED], draft_layers=DRAFT_LAYERS,
        temperature=SPEC_TEMP, seeds=seeds)
    same(f"k=0, temperature {SPEC_TEMP}, seeded", streams, want_s)
    out["k0_sampled"] = {"calls": calls, "launches": launches}
    del eng, model, draft
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out["draft"]["launches"], out


def _plain_request(prompt, temperature=0.0, seed=None):
    from apex_tpu_torch.serve import Request

    return Request(prompt=list(prompt), max_new_tokens=NEW_TOKENS,
                   temperature=temperature, stream_seed=seed)


# ---------------------------------------------------------------------------
# phase 15: serving robustness at full width (half depth) under a chaos storm
# ---------------------------------------------------------------------------


#: phase 15's pool: 256 usable pages (4096 tokens of KV) against the
#: drill's 8 slots of up to 1024 + 64 tokens, so the clamp rung (60%
#: occupancy) and page pressure (growth-page victims) are reached
CHAOS_PAGES = 257
#: phase 15's depth: half of GptConfig()'s 12 layers at its full width
#: (the whole script passed 950 s when phase 24 joined it)
CHAOS_LAYERS = 6
CHAOS_PROMPTS = (64, 256, 1024)
CHAOS_OUTPUTS = (16, 32, 64)
#: drain requests: more than the 8 slots, so the drain sheds a queue
CHAOS_DRAIN = 12
#: the speculative run's storm: two faulted draft rounds (each falls
#: back to plain decode) and one crashed spec round (retries, a
#: re-capture of both graphs at the idle point)
CHAOS_SPEC_FAULTS = "serve.draft:raise:x2@1,3;serve.decode:raise:x1@5"
CHAOS_SPEC_EXPECTED = {"draft_faults": 2, "engine_faults": 1}
CHAOS_REBUILDS = 3


def _chaos_args(tmp):
    """The drill's parser with phase 15's load: 100 Poisson arrivals
    (seed 0) of prompts from CHAOS_PROMPTS and outputs from
    CHAOS_OUTPUTS, the drill's ladder knobs, spans recorded."""
    from apex_tpu_torch.tools import serve_chaos_drill as drill

    return drill.build_parser().parse_args([
        "--prompt-mix", *map(str, CHAOS_PROMPTS),
        "--output-mix", *map(str, CHAOS_OUTPUTS),
        "--batch", "8", "--page-size", "16", "--pages", str(CHAOS_PAGES),
        "--pages-per-seq", "128", "--vocab", "50304",
        "--drain-requests", str(CHAOS_DRAIN),
        "--spans", os.path.join(tmp, "spans.json")])


def _timed_decode(engine, record):
    """Wrap ``engine.decode`` to append each call's host ms (it returns
    host tokens: synchronised) to ``record``; the wrapper is an instance
    attribute, dropped with ``delattr``."""
    fn = engine.decode

    def decode(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        record.append(1e3 * (time.perf_counter() - t))
        return out

    engine.decode = decode


def _serving_want(engines, layers):
    """The exact K1/K3/K6 launches of plain serving on ``engines``: each
    prefill K1 2L + 1 and K3 L, each decode replay K1 2L + 1 and K6 L."""
    prefills = sum(e.prefill_calls for e in engines)
    decodes = sum(e.decode_iters for e in engines)
    return {"layer_norm_fwd": (2 * layers + 1) * (prefills + decodes),
            "flash_fwd": layers * prefills,
            "paged_decode": layers * decodes}


WANT_PATHS = {"layer_norm": "cuda", "flash_attention": "cuda",
              "paged_decode_attention": "cuda"}


def _chaos_drill(model, kv_wire, tmp):
    """One run of the ported chaos drill at full width on ``kv_wire``:
    the fault-free reference, the storm (DEFAULT_CHAOS_SPEC), the
    overload probe and the drain, with the launch counters zeroed before
    and read after.  Holds the drill's four guarantees and its ledger to
    DEFAULT_EXPECTED exactly, every retry's cause to an injected fault,
    the streams of requests that completed in both runs, the exact
    launches and the kernel paths; returns (launches, numbers)."""
    import gc

    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig
    from apex_tpu_torch.tools import serve_chaos_drill as drill

    args = _chaos_args(tmp)
    serve = ServeConfig(page_size=16, num_pages=CHAOS_PAGES, max_batch=8,
                        max_pages_per_seq=128, kv_wire=kv_wire)
    engines, decode_ms = [], []

    def factory(args, registry=None):
        eng = InferenceEngine(model.cfg, model, serve,
                              registry=registry).build()
        decode_ms.append([])
        _timed_decode(eng, decode_ms[-1])
        engines.append(eng)
        return eng

    keep = {}
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    art = drill.run_drill(args, engine_factory=factory, keep=keep)
    torch.cuda.synchronize()
    launches, paths = _dispatch.launches(), _dispatch.last_paths()
    tag = f"phase 15 ({kv_wire} KV)"
    failures = drill.check(art, args)
    probe = art["overload_probe"]
    if probe["clamped_to"] != [4]:
        failures.append(f"the probe clamped to {probe['clamped_to']}, not 4")
    if not art["storm"]["clamped"] or not art["storm"]["shed_reasons"].get(
            "growth_victim"):
        failures.append("the storm reached neither the clamp rung nor "
                        f"page pressure: {art['storm']}")
    with open(args.spans) as f:
        spans = json.load(f)["spans"]
    causes = [e["args"]["cause"] for e in spans
              if e["name"] == "req/retrying"]
    if (len(causes) != art["registry"]["serve/retries"]
            or any(c.split(":")[1] != "InjectedFault" for c in causes)):
        failures.append(f"retries whose cause is not an injected fault: "
                        f"{causes}")
    # a request that completed in both runs streams the same tokens (a
    # retried one resumed from its kept pages); where the clamp rung cut
    # one run short, the shorter stream is the longer's prefix
    pairs = [(a, b) for a, b in zip(keep["reference"], keep["storm"])
             if a.status == b.status == "done"]
    same = sum(a.tokens == b.tokens for a, b in pairs)
    for a, b in pairs:
        n = min(len(a.tokens), len(b.tokens))
        if a.tokens[:n] != b.tokens[:n] or (
                a.max_new_tokens == b.max_new_tokens
                and a.tokens != b.tokens):
            failures.append(f"request {a.rid}/{b.rid}: the storm's stream "
                            "differs from the fault-free run's")
    retried = [b for a, b in pairs if b.retries]
    want = _serving_want(engines, model.cfg.num_layers)
    if launches != want or min(want.values()) <= 0:
        failures.append(f"launches {launches} != {want}")
    if paths != WANT_PATHS:
        failures.append(f"op paths {paths} != {WANT_PATHS}")
    per_replay = {"layer_norm_fwd": 2 * model.cfg.num_layers + 1,
                  "paged_decode": model.cfg.num_layers}
    if any(e.graph_launches != per_replay for e in engines):
        failures.append("a replay's launches "
                        f"{[e.graph_launches for e in engines]}")
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))
    ref_ms, storm_ms = decode_ms
    tick_ms = 1e3 * drill.VirtualClock().tick_s
    out = {"config": art["config"], "chaos_spec": art["chaos_spec"],
           "engine_faults": art["registry"]["serve/engine_faults"],
           "rebuilds": art["engine"]["rebuilds"],
           "graph_captures": art["engine"]["graph_captures"],
           "overload_probe": probe, "drain": art["drain"],
           "p99_ttft_inflation": art["p99_ttft_inflation"],
           "streams_equal": same, "completed_in_both": len(pairs),
           "retried_completed": len(retried)}
    for run, ms in (("reference", ref_ms), ("storm", storm_ms)):
        r = art[run]
        out[run] = {
            "host_s": r["host_s"], "completed": r["completed"],
            "shed_reasons": r["shed_reasons"], "clamped": r["clamped"],
            "retries": r["retries_total"],
            "ttft_p50_ticks": r["ttft_ms"]["p50"] / tick_ms,
            "ttft_p99_ticks": r["ttft_ms"]["p99"] / tick_ms,
            "decode_steps": len(ms),
            "decode_host_ms_median": statistics.median(ms),
            "decode_host_ms_mean": statistics.fmean(ms)}
        log(f"  {kv_wire} KV, {run}: {r['completed']}/{r['offered']} "
            f"done, shed {r['shed_reasons']}, clamped {r['clamped']}, "
            f"retries {r['retries_total']}; host {r['host_s']:.3f} s; "
            f"TTFT p50/p99 {out[run]['ttft_p50_ticks']:.1f}/"
            f"{out[run]['ttft_p99_ticks']:.1f} ticks; decode "
            f"{len(ms)} steps, host ms median "
            f"{out[run]['decode_host_ms_median']:.3f} mean "
            f"{out[run]['decode_host_ms_mean']:.3f}")
    log(f"  {kv_wire} KV: ledger {dict((k, art['registry'][v]) for k, v in drill.EXPECTED_KEYS.items())} "
        f"= DEFAULT_EXPECTED; inflation {art['p99_ttft_inflation']:.3f}; "
        f"probe {probe['queue_full']} queue_full of {probe['burst']}, "
        f"{probe['clamped']} clamped to {probe['clamped_to']}; drain "
        f"{art['drain']['statuses']}, pool {art['drain']['pool_in_use']}; "
        f"{same}/{len(pairs)} streams equal ({len(retried)} retried); "
        f"launches {launches}")
    for eng in engines:
        del eng.decode
    engines.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def _chaos_requests(cfg, seed=5):
    """8 greedy requests, prompts from CHAOS_PROMPTS, 32 new tokens."""
    from apex_tpu_torch.serve import Request

    rs = np.random.RandomState(seed)
    lens = [CHAOS_PROMPTS[i % 3] for i in range(8)]
    return [Request(prompt=[int(t) for t in rs.randint(0, cfg.vocab_size,
                                                      size=n)],
                    max_new_tokens=NEW_TOKENS) for n in lens]


def _chaos_spec(model):
    """A self-draft SpecConfig(k=4) engine under CHAOS_SPEC_FAULTS: the
    greedy streams equal plain decode's, the ledger is the injected one,
    the pool ends empty, and K1/K3/K6 launch exactly as the calls that
    ran require (a faulted round runs nothing)."""
    import gc

    import torch

    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.resilience import chaos
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        ServeConfig,
        SpecConfig,
    )

    cfg = model.cfg
    serve = ServeConfig(page_size=16, num_pages=1025, max_batch=8,
                        max_pages_per_seq=128)
    plain = InferenceEngine(cfg, model, serve).build()
    sched = ContinuousBatchingScheduler(plain)
    reqs = [sched.submit(r) for r in _chaos_requests(cfg)]
    sched.run()
    want_streams = [r.tokens for r in reqs]
    del plain, sched
    gc.collect()
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, model, serve,
                          spec=SpecConfig(None, k=4)).build()
    ran = {"spec_step": 0, "decode": 0}
    for name in ran:
        fn = getattr(eng, name)

        def call(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            ran[_name] += 1  # the call ran its graph: no fault raised
            return out

        setattr(eng, name, call)
    reg = MetricRegistry(fetch_every=1)
    sched = ContinuousBatchingScheduler(eng, registry=reg)
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    with chaos.inject(*chaos.parse_spec(CHAOS_SPEC_FAULTS)[0]):
        reqs = [sched.submit(r) for r in _chaos_requests(cfg)]
        sched.run()
    torch.cuda.synchronize()
    launches, paths = _dispatch.launches(), _dispatch.last_paths()
    for name in ran:
        delattr(eng, name)
    reg.fetch()
    vals = reg.values()
    got = {k: vals[f"serve/{k}"] for k in CHAOS_SPEC_EXPECTED}
    layers, k = cfg.num_layers, eng.spec.k
    calls = {"prefills": eng.prefill_calls,
             "draft_prefills": eng.draft_prefill_calls,
             "spec_rounds": ran["spec_step"], "plain_decodes": ran["decode"]}
    want = _spec_want(cfg, layers, k, calls, chunked=False)
    failures = []
    if [r.tokens for r in reqs] != want_streams:
        failures.append("the spec streams under faults differ from plain "
                        "decode's")
    if any(r.status != "done" for r in reqs) or eng.pool.in_use:
        failures.append(f"statuses {[r.status for r in reqs]}, "
                        f"{eng.pool.in_use} pages in use")
    # the owed rebuild runs at the idle exit, after the last publish: the
    # engine counts it
    if got != CHAOS_SPEC_EXPECTED or eng.rebuilds != 1:
        failures.append(f"ledger {got} (rebuilds {eng.rebuilds}) != "
                        f"{CHAOS_SPEC_EXPECTED}")
    if eng.captures != {"decode": 2, "spec": 2}:
        failures.append(f"graph captures {eng.captures}")
    if launches != want or not ran["spec_step"] or not ran["decode"]:
        failures.append(f"launches {launches} != {want} (calls {calls})")
    if paths != WANT_PATHS:
        failures.append(f"op paths {paths}")
    if failures:
        raise AssertionError("phase 15 (spec): " + "; ".join(failures))
    log(f"  spec k=4 self-draft under {CHAOS_SPEC_FAULTS!r}: 8 streams "
        f"equal plain decode's; ledger {got}; captures {eng.captures}; "
        f"{ran['spec_step']} rounds and {ran['decode']} plain decodes ran; "
        f"launches {launches}")
    out = {"faults": CHAOS_SPEC_FAULTS, "ledger": got,
           "rebuilds": eng.rebuilds,
           "captures": dict(eng.captures), "calls": calls,
           "launches": launches}
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _decode_args(sched):
    """The inputs the scheduler's next plain decode would feed (the live
    slots' last tokens at their context lengths, their page tables)."""
    from apex_tpu_torch.serve import NULL_PAGE

    b, np_ = len(sched.slots), sched.serve.max_pages_per_seq
    tokens = np.zeros((b,), np.int64)
    lengths = np.zeros((b,), np.int32)
    tables = np.full((b, np_), NULL_PAGE, np.int32)
    for i, r in enumerate(sched.slots):
        if r is not None and r.status == "running":
            tokens[i] = r.tokens[-1]
            lengths[i] = r.ctx_len + 1
            tables[i, : len(r.pages)] = r.pages
    return tokens, lengths, tables


def _chaos_rebuilds(model):
    """CHAOS_REBUILDS re-captures in the middle of a run: before and
    after each, the replay of the live batch's next decode gives the
    same bits, equal to the eager step's; ``memory_reserved`` never
    exceeds its value before the first rebuild; the run then completes
    with the streams of an uninterrupted run.  Then a crashed decode
    step (``serve.decode:raise`` at the batch's third iteration): every
    running request retries with its pages and prefix kept, the owed
    rebuild runs at the idle point, and the streams are again the
    uninterrupted run's (the reference's
    ``test_decode_fault_retries_preserve_prefix`` at full width).
    Reports the host ms of a re-capture."""
    import gc

    import torch

    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.resilience import chaos
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        ServeConfig,
    )

    cfg = model.cfg
    eng = InferenceEngine(cfg, model, ServeConfig(
        page_size=16, num_pages=1025, max_batch=8,
        max_pages_per_seq=128)).build()
    sched = ContinuousBatchingScheduler(eng)
    reqs = [sched.submit(r) for r in _chaos_requests(cfg, seed=6)]
    sched.run()
    want = [r.tokens for r in reqs]
    sched = ContinuousBatchingScheduler(eng)
    reqs = [sched.submit(r) for r in _chaos_requests(cfg, seed=6)]
    for _ in range(4):  # every request admitted and a few tokens decoded
        sched.step()
    args = _decode_args(sched)
    if int((args[1] > 0).sum()) != 8:
        raise AssertionError("phase 15: the batch is not full mid-run")
    logits0, tok0 = eng.decode(*args)
    logits0 = logits0.clone()
    e_logits, e_tok, _ = eng._decode_eager(*args)
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    allocated0 = torch.cuda.memory_allocated()
    ms, reserved, allocated = [], [], []
    failures = []
    if not (torch.equal(logits0, e_logits) and np.array_equal(tok0, e_tok)):
        failures.append("the replay differs from the eager step")
    for i in range(CHAOS_REBUILDS):
        t = time.perf_counter()
        eng.rebuild()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        logits, tok = eng.decode(*args)
        if not (torch.equal(logits, logits0) and np.array_equal(tok, tok0)):
            failures.append(f"the replay after rebuild {i + 1} differs")
        reserved.append(torch.cuda.memory_reserved())
        allocated.append(torch.cuda.memory_allocated())
    sched.run()
    if [r.tokens for r in reqs] != want or eng.pool.in_use:
        failures.append("the run across the rebuilds did not stream the "
                        "uninterrupted run's tokens")
    sched = ContinuousBatchingScheduler(eng, registry=MetricRegistry(
        fetch_every=1))
    fault = chaos.Fault(chaos.SERVE_DECODE, steps=(eng.decode_iters + 2,),
                        mode="raise", max_hits=1)
    with chaos.inject(fault):
        reqs = [sched.submit(r) for r in _chaos_requests(cfg, seed=6)]
        sched.run()
    sched.registry.fetch()
    vals = sched.registry.values()
    if ([r.tokens for r in reqs] != want
            or [r.retries for r in reqs] != [1] * 8
            or vals["serve/engine_faults"] != 1
            or vals["serve/readmitted"] != 8
            or eng.rebuilds != 1 + CHAOS_REBUILDS or eng.pool.in_use):
        failures.append(
            f"after a crashed decode: retries {[r.retries for r in reqs]}, "
            f"faults {vals['serve/engine_faults']}, readmitted "
            f"{vals['serve/readmitted']}, rebuilds {eng.rebuilds}, or the "
            "streams differ from the uninterrupted run's")
    if max(reserved) > reserved0:
        failures.append(f"memory_reserved grew: {reserved0} -> {reserved}")
    if eng.captures.get("decode") != 2 + CHAOS_REBUILDS:
        failures.append(f"captures {eng.captures}")
    if failures:
        raise AssertionError("phase 15 (rebuilds): " + "; ".join(failures))
    log(f"  {CHAOS_REBUILDS} rebuilds mid-run: the replay equal to itself "
        f"and the eager step bit for bit; re-capture host ms "
        f"{[round(x, 3) for x in ms]}; memory_reserved {reserved0} -> "
        f"{reserved}, allocated {allocated0} -> {allocated}; the run's "
        "streams equal the uninterrupted run's; after a crashed decode "
        "step all 8 requests retried and streamed them again")
    out = {"recapture_ms": ms, "reserved_before": reserved0,
           "reserved_after": reserved, "allocated_before": allocated0,
           "allocated_after": allocated}
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: phase 15's telemetry modes: (registry fetched every step, spans)
TELEMETRY_MODES = {"none": (False, False), "registry": (True, False),
                   "spans": (False, True), "both": (True, True)}


def _telemetry_cost(model, rounds=2):
    """The host ms of a decode-only scheduler step with a registry
    (fetch every step), a span recorder, both or neither attached,
    alternated ``rounds`` times on one engine; the launches of every
    timed step must be the graph's (publishing adds none)."""
    import gc

    import torch

    from apex_tpu_torch.observability import MetricRegistry, SpanRecorder
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        Request,
        ServeConfig,
    )

    cfg = model.cfg
    eng = InferenceEngine(cfg, model, ServeConfig(
        page_size=16, num_pages=1025, max_batch=8,
        max_pages_per_seq=128)).build()
    times = {mode: [] for mode in TELEMETRY_MODES}
    rs = np.random.RandomState(7)
    prompts = [[int(t) for t in rs.randint(0, cfg.vocab_size, size=64)]
               for _ in range(8)]
    per_step = eng.graph_launches
    for _ in range(rounds):
        for mode, (reg, spans) in TELEMETRY_MODES.items():
            sched = ContinuousBatchingScheduler(
                eng, registry=MetricRegistry(fetch_every=1) if reg else None,
                spans=SpanRecorder() if spans else None)
            for p in prompts:
                sched.submit(Request(prompt=list(p), max_new_tokens=64))
            sched.step()  # admissions and the first decode
            while sched.pending:
                _dispatch.reset_launches()
                t = time.perf_counter()
                sched.step()
                dt = 1e3 * (time.perf_counter() - t)
                if sched.pending:  # the last step retires every request
                    times[mode].append(dt)
                if _dispatch.launches() != per_step:
                    raise AssertionError(
                        f"phase 15: a {mode} step launched "
                        f"{_dispatch.launches()}, a replay {per_step}")
    med = {m: statistics.median(v) for m, v in times.items()}
    log("  telemetry: a decode-only scheduler step's host ms "
        + ", ".join(f"{m} {v:.3f}" for m, v in med.items())
        + f" (both - none +{med['both'] - med['none']:.3f} ms; "
        f"{len(times['none'])} steps each); launches a step {per_step}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": med, "steps": len(times["none"])}


def _registry_on_card(steps=12, fetch_every=2):
    """A MetricRegistry whose state lives on the card (each fetch a
    ``non_blocking`` copy into pinned memory behind a CUDA event) against
    one on the host, fed the same updates: at every step the same
    fetched values and step, at most ``2 * fetch_every`` steps stale."""
    import torch

    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.serve import declare_serve_metrics

    regs = {d: MetricRegistry(fetch_every=fetch_every, device=d)
            for d in ("cuda", "cpu")}
    states = {}
    for dev, reg in regs.items():
        declare_serve_metrics(reg)
        reg.minimum("train/loss_min")
        states[dev] = reg.init()
    for step in range(steps):
        upd = {"serve/tokens_out": 8, "serve/queue_depth": step % 5,
               "serve/ttft_ms": 0.1 * step, "train/loss_min": 9.0 - step % 4}
        for dev, reg in regs.items():
            # a device tensor feeds the card's state, as a step would
            vals = dict(upd, **{"serve/completed": torch.tensor(
                float(step), device=dev)})
            reg.update(states[dev], vals)
            reg.observe(step, states[dev])
        card, host = regs["cuda"], regs["cpu"]
        if (card.values() != host.values()
                or card.fetched_step != host.fetched_step
                or (card.fetched_step is not None
                    and step - card.fetched_step > 2 * fetch_every)):
            raise AssertionError(
                f"phase 15: the card's registry at step {step} read "
                f"{card.fetched_step}, the host's {host.fetched_step}")
    if regs["cuda"].fetch() != regs["cpu"].fetch():
        raise AssertionError("phase 15: the card's registry drained other "
                             "values than the host's")
    log(f"  a registry on the card: {steps} steps at fetch_every "
        f"{fetch_every} read the host registry's values and steps")
    return {"steps": steps, "fetch_every": fetch_every}


def phase15():
    """Serving robustness at the full width of ``GptConfig()``, at
    CHAOS_LAYERS of its 12 layers (phase 2's
    seeded weights) under a chaos storm, through the ported drill
    (``apex_tpu_torch.tools.serve_chaos_drill``) on bf16 and on int8 KV
    pages; a speculative run under draft and decode faults; three
    re-captures in the middle of a run; and the telemetry's cost a
    decode step.  Returns (the bf16 drill's launches, the numbers)."""
    import tempfile

    import torch

    from apex_tpu_torch.models import GptConfig, GptModel

    log(f"phase 15: GptConfig(num_layers={CHAOS_LAYERS}) serving under a "
        "chaos storm (the drill at "
        f"{CHAOS_PAGES - 1} pages, prompts {CHAOS_PROMPTS}, outputs "
        f"{CHAOS_OUTPUTS}), spec under draft faults, rebuilds, telemetry")
    torch.cuda.empty_cache()
    model = GptModel(GptConfig(num_layers=CHAOS_LAYERS),
                     generator=torch.Generator("cuda").manual_seed(1234))
    out = {}
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_phase15_") as tmp:
        launches, out["bf16_kv"] = _chaos_drill(model, "f32", tmp)
        out["int8_kv"] = _chaos_drill(model, "int8", tmp)[1]
    out["spec"] = _chaos_spec(model)
    out["rebuilds"] = _chaos_rebuilds(model)
    out["telemetry"] = _telemetry_cost(model)
    out["registry_on_card"] = _registry_on_card()
    del model
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 4: timing at the main-path shapes
# ---------------------------------------------------------------------------


def _time_ln(gen, flush, rows, hidden, dtype="bf16"):
    """K1 and K2 at x (rows, hidden) in ``dtype`` (bf16 or f32), each
    beside its plain version and the library call (``aten.native_layer_norm``
    and ``aten.native_layer_norm_backward``, what ``F.layer_norm`` and its
    backward launch, affine, with the weights in x's dtype), with the
    bounds."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln

    aten = torch.ops.aten
    x, w, b = ln_inputs(rows, hidden, gen)
    if dtype == "f32":
        x = x.float()
    wb, bb = w.to(x.dtype), b.to(x.dtype)
    fwd = dict(
        ms=time_ms(lambda: ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False),
                   flush=flush),
        plain_ms=time_ms(lambda: ln.layer_norm_reference(x, w, b, 1e-5, False),
                         flush=flush),
        library_ms=time_ms(lambda: aten.native_layer_norm(
            x, [hidden], wb, bb, 1e-5), flush=flush),
    )
    fwd["bound_ms"], fwd["bound_by"] = roofline_bound(
        ln.kernel_specs(rows, hidden, x.dtype))

    _, mu, rstd = ln.layer_norm_reference(x, w, b, 1e-5, False)
    g = torch.randn(rows, hidden, generator=gen, device="cuda").to(x.dtype)
    _, lmu, lrstd = aten.native_layer_norm(x, [hidden], wb, bb, 1e-5)
    bwd = dict(
        ms=time_ms(lambda: ln.layer_norm_bwd(x, w, b, mu, rstd, g, rms=False,
                                             x_is_output=False), flush=flush),
        plain_ms=time_ms(lambda: ln.layer_norm_bwd_reference(
            x, w, b, mu, rstd, g, False, False), flush=flush),
        library_ms=time_ms(lambda: aten.native_layer_norm_backward(
            g, x, [hidden], lmu, lrstd, wb, bb, [True, True, True]),
            flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = roofline_bound(
        ln.kernel_specs(rows, hidden, x.dtype, bwd=True))
    return fwd, bwd


def _time_ln_wide(gen, flush, streamed=False):
    """K1 and K2 at :data:`LN_WIDE_SHAPES` (and, with ``streamed``, at
    :data:`LN_STREAM_SHAPE`): ``{kernel: {tag: row}}`` for phase 4's
    extra rows."""
    import torch

    extra = {}
    for rows, hidden, dt in LN_WIDE_SHAPES + ((LN_STREAM_SHAPE,) if streamed
                                              else ()):
        ln_fwd, ln_bwd = _time_ln(gen, flush, rows, hidden, dt)
        what = "streamed" if hidden > 8192 else "wide"
        tag = f"{what}_{hidden}_{dt}_shape"
        extra.setdefault("layer_norm_fwd", {})[tag] = dict(
            ln_fwd, shape=f"x ({rows}, {hidden}) {dt} ({what} row)")
        extra.setdefault("layer_norm_bwd", {})[tag] = dict(
            ln_bwd, shape=f"x, g ({rows}, {hidden}) {dt} ({what} row)")
        torch.cuda.empty_cache()
    return extra


#: the wide-row layouts held side by side (``--norms``): at 2048 and 4096
#: values, 4 and 8 warps a row (each with the plan's values a lane)
LN_LAYOUT_SHAPES = ((16384, 2048, "bf16"), (16384, 4096, "bf16"),
                    (16384, 4096, "f32"))


def _ln_layout_calls(x, w, b, mu, rstd, g, warps):
    """K1 and K2 on ``x`` in the wide layout of ``warps`` warps a row and
    the fewest values a lane that cover it, launched through the dispatch
    with a plan built here (the wrappers take the one layout their plan
    picks for a width): ``(fwd, bwd, values a lane)``; ``fwd()`` returns
    y, ``bwd()`` dx and the summed dw, db."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import layer_norm as ln

    rows, hidden = x.shape
    per_lane = next(n for n in (16, 32) if 32 * warps * n >= hidden)
    vec, code = 16 // x.element_size(), ln._DTYPE_CODES[x.dtype]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = {k: min(-(-rows // (ln.NORM_WARPS // warps)),
                   sms * ln._resident_ctas(k, code, x.device.index, vec,
                                           per_lane, warps))
            for k in (ln.KERNEL, ln.KERNEL_BWD)}
    y, dx = torch.empty_like(x), torch.empty_like(x)
    mu_o, rstd_o = torch.empty_like(mu), torch.empty_like(rstd)
    part = torch.empty(grid[ln.KERNEL_BWD], 2, hidden, dtype=torch.float32,
                       device=x.device)
    lanes = 32 * warps

    def fwd():
        _dispatch.launch(
            ln.KERNEL, ln._FWD_ARGS, x.device, x.data_ptr(), w.data_ptr(),
            b.data_ptr(), y.data_ptr(), mu_o.data_ptr(), rstd_o.data_ptr(),
            rows, hidden, 1e-5, 0, code, vec, per_lane, lanes,
            grid[ln.KERNEL], dtype=x.dtype)
        return y

    def bwd():
        _dispatch.launch(
            ln.KERNEL_BWD, ln._BWD_ARGS, x.device, x.data_ptr(), w.data_ptr(),
            b.data_ptr(), mu.data_ptr(), rstd.data_ptr(), g.data_ptr(),
            dx.data_ptr(), part.data_ptr(), rows, hidden, 0, 0, code, vec,
            per_lane, lanes, grid[ln.KERNEL_BWD], dtype=x.dtype)
        return (dx, *part.sum(dim=0))

    return fwd, bwd, per_lane


def _time_ln_layouts(gen, flush):
    """K1 and K2 ms at :data:`LN_LAYOUT_SHAPES` in each wide layout (4 and
    8 warps a row), each held to the plain versions first:
    ``{"<hidden> <dtype> W<warps>": {"fwd_ms", "bwd_ms", "per_lane"}}``."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln

    out = {}
    if not hasattr(ln, "WIDE_MAX_HIDDEN"):  # an older tree: one layout
        return out
    for rows, hidden, dt in LN_LAYOUT_SHAPES:
        x, w, b = ln_inputs(rows, hidden, gen)
        if dt == "f32":
            x = x.float()
        y_ref, mu, rstd = ln.layer_norm_reference(x, w, b, 1e-5, False)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        bwd_ref = ln.layer_norm_bwd_reference(x, w, b, mu, rstd, g, False,
                                              False)
        tol = BF16_TOL if dt == "bf16" else F32_TOL
        for warps in (4, 8):
            fwd, bwd, per_lane = _ln_layout_calls(x, w, b, mu, rstd, g, warps)
            tag = f"wide layout ({rows}, {hidden}) {dt} {warps} x {per_lane}"
            compare(f"{tag} K1 y", fwd(), y_ref, tol)
            for name, o, ref, t in zip(("dx", "dw", "db"), bwd(), bwd_ref,
                                       (tol, SUM_TOL, SUM_TOL)):
                compare(f"{tag} K2 {name}", o, ref, t)
            out[f"{hidden} {dt} W{warps}"] = r = dict(
                per_lane=per_lane, fwd_ms=time_ms(fwd, flush=flush),
                bwd_ms=time_ms(bwd, flush=flush))
            log(f"  wide layout ({rows}, {hidden}) {dt}, {warps} warps x "
                f"{per_lane} values a lane: K1 {r['fwd_ms']:.4f} ms, K2 "
                f"{r['bwd_ms']:.4f} ms")
        del x, g
        torch.cuda.empty_cache()
    return out


def phase4_norms(gen):
    """Phase 4's K1/K2 rows alone (``--norms``): the training shape
    (16384, 1024) in bf16 and f32, the wide rows and the streamed width,
    each beside its plain version, library call and bound; returns
    ``{kernel: {tag: row}}``."""
    import torch

    log("phase 4, K1/K2 rows: timing (median of 25 queued runs, L2 "
        "flushed before each)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    out = {"layer_norm_fwd": {}, "layer_norm_bwd": {}}
    n = TRAIN_BATCH * TRAIN_SEQ
    for dt in ("bf16", "f32"):
        fwd, bwd = _time_ln(gen, flush, n, 1024, dt)
        out["layer_norm_fwd"][f"train_{dt}_shape"] = dict(
            fwd, shape=f"x ({n}, 1024) {dt}")
        out["layer_norm_bwd"][f"train_{dt}_shape"] = dict(
            bwd, shape=f"x, g ({n}, 1024) {dt}")
        torch.cuda.empty_cache()
    for name, by_tag in _time_ln_wide(gen, flush, streamed=True).items():
        out[name].update(by_tag)
    layouts = _time_ln_layouts(gen, flush)
    for name, by_tag in out.items():
        for r in by_tag.values():
            log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return dict(out, wide_layouts=layouts)


def _time_attn(gen, flush, bh, s, *, with_bwd, d=64):
    """K3 (and K4) at q/k/v (bh, s, d) causal bf16, scale 1/sqrt(d),
    beside the plain versions and SDPA (``is_causal``; its backward timed
    on its own), with the bounds: 2 products of 2*D flops per live pair
    forward, 5 backward (the recompute, dO V^T, P^T dO, dS K, dS^T Q)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    scale = d ** -0.5
    q, k, v = attn_inputs(bh, s, s, d, gen)
    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, scale=scale, causal=True),
                   flush=flush),
        plain_ms=time_ms(lambda: attn.flash_fwd_reference(
            q, k, v, causal=True, scale=scale), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=scale),
            flush=flush),
    )
    plans = attn.kernel_specs(bh, s, s, d, causal=True, defines=())
    fwd["bound_ms"], fwd["bound_by"] = roofline_bound(plans[:1])
    if not with_bwd:
        return fwd, None
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, _, m, l = attn.flash_fwd(q, k, v, scale=scale, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=scale)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(q, k, v, do, m, l, delta,
                                          scale=scale, causal=True),
                   flush=flush),
        # the f32 twin materialises five (BH, S, S) f32 score-sized
        # tensors (~10 GB here): fewer runs
        plain_ms=time_ms(lambda: attn.flash_bwd_reference(
            q, k, v, do, m, l, delta, scale=scale, causal=True),
            iters=5, warmup=1, flush=flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do[None], retain_graph=True), flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = roofline_bound(plans[1:])
    return fwd, bwd


#: the reference's long-context benchmark (``bench.py``'s long-context
#: config: B 1, H 8, S 16384, D 128, causal)
LONG_BH, LONG_S, LONG_D = 8, 16384, 128
#: phase 4's head dim past 128 (B 4, H 8, S 2048, D 256, causal)
WIDE_BH, WIDE_S, WIDE_D = 32, 2048, 256
#: and past 256: the wide instance
WIDER_D = 384


def sdpa_backend(fn):
    """The backend SDPA dispatches ``fn`` to: the first of its priority
    order (``torch._C._get_sdp_priority_order``, else flash, efficient,
    cuDNN, math) that accepts the call."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        order = [SDPBackend(int(b)) for b in torch._C._get_sdp_priority_order()]
    except (AttributeError, TypeError, ValueError):
        order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    for backend in order:
        try:
            with sdpa_kernel([backend]):
                fn()
            return backend.name.lower()
        except RuntimeError:
            continue
    return "none"


def _time_attn_wider(gen, flush):
    """K3, K4 (causal) and K5 (non-causal, a (BH, S, S) f32 bias at G =
    BH) at BH 32, S 2048, D 384, the wide instance, beside their plain
    versions and SDPA on whichever backend it picks for a head dim its
    flash kernels refuse (named in each row); None where this tree's
    kernels refuse the head dim (an older tree)."""
    import torch
    import torch.nn.functional as F

    bh, s, d = WIDE_BH, WIDE_S, WIDER_D
    try:
        fwd, bwd = _time_attn(gen, flush, bh, s, with_bwd=True, d=d)
    except ValueError as exc:  # a tree without the wide instance
        log(f"  D = {d} refused: {exc}")
        return None
    q, k, v = attn_inputs(bh, s, s, d, gen)
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    lib = sdpa_backend(lambda: F.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True, scale=d ** -0.5))
    fwd["library"] = bwd["library"] = f"SDPA ({lib} backend)"
    del q, k, v, qr, kr, vr
    torch.cuda.empty_cache()
    k5 = _time_evo_attention(gen, flush, bh, s, d, with_k34=False)
    b = bh // EVO_HEADS
    q, k, v = (t.reshape(b, EVO_HEADS, s, d) for t in attn_inputs(bh, s, s, d,
                                                                  gen))
    mask = torch.zeros(b, EVO_HEADS, s, s, device="cuda",
                       dtype=torch.bfloat16, requires_grad=True)
    lib = sdpa_backend(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       scale=d ** -0.5), mask,
        torch.ones_like(q)))
    k5["flash_dbias"]["library"] = (f"SDPA backward with the mask's "
                                    f"gradient ({lib} backend)")
    return fwd, bwd, k5["flash_dbias"]


def _time_attn_long(gen, flush):
    """K3 and K4 at the long-context shape (BH 8, S 16384, D 128, causal,
    bf16) beside the plain versions and SDPA (``is_causal``; its backward
    timed on its own), with the bounds: 2 products of 2*D flops per live
    pair forward, 5 backward.  The plain versions hold (8, 16384, 16384)
    f32 score-sized tensors (8.6 GB each): one run each after one warm-up,
    and "not measured" if the card runs out of memory."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    bh, s, d = LONG_BH, LONG_S, LONG_D
    scale = d ** -0.5
    q, k, v = attn_inputs(bh, s, s, d, gen)

    def plain(fn):
        try:
            return time_ms(fn, iters=1, warmup=1, flush=flush)
        except torch.cuda.OutOfMemoryError:
            log("  the plain version ran out of device memory: not measured")
            return None
        finally:
            torch.cuda.empty_cache()

    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, scale=scale, causal=True),
                   flush=flush),
        plain_ms=plain(lambda: attn.flash_fwd_reference(
            q, k, v, causal=True, scale=scale)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=scale),
            flush=flush),
    )
    plans = attn.kernel_specs(bh, s, s, d, causal=True, defines=())
    fwd["bound_ms"], fwd["bound_by"] = roofline_bound(plans[:1])
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, _, m, l = attn.flash_fwd(q, k, v, scale=scale, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    del o
    qr, kr, vr = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=scale)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(q, k, v, do, m, l, delta,
                                          scale=scale, causal=True),
                   flush=flush),
        plain_ms=plain(lambda: attn.flash_bwd_reference(
            q, k, v, do, m, l, delta, scale=scale, causal=True)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do[None], retain_graph=True), flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = roofline_bound(plans[1:])
    return fwd, bwd


def _time_attn_masked(gen, flush, b, heads, sq, sk, bias, dropout_p, d=64):
    """K3 and K4 at a non-causal (B·heads, sq, sk, D 64) bf16 shape with a
    head-independent bias in the kernels' layout (``bias`` (B, RS, Sk)
    f32, G = B: (B, 1, Sk) key padding, or (B, Sq, Sk)) and
    ``dropout_p``, beside the plain versions and SDPA with the same
    additive mask (bf16) and dropout rate, forward and backward (timed on
    its own), with the bounds of their launch plans: the bytes of q, k, v
    (and dO) read, o (dq, dk, dv) written and the f32 row statistics, the
    bias and the seed; 2 products of 2·D flops per pair forward, 5
    backward (BERT's shape and phase 25's multihead and fmha shapes)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    bh = b * heads
    q, k, v = attn_inputs(bh, sq, sk, d, gen)
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                         device="cuda", dtype=torch.int32)
    kw = dict(scale=d ** -0.5, causal=False, dropout_p=dropout_p, seed=seed)
    q4 = q.reshape(b, heads, sq, d)
    k4, v4 = (t.reshape(b, heads, sk, d) for t in (k, v))
    mask4 = bias[:, None].to(torch.bfloat16)  # (B, 1, RS, Sk)

    def sdpa(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, attn_mask=mask4,
                                              dropout_p=dropout_p,
                                              scale=d ** -0.5)

    fwd = dict(
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, bias, **kw), flush=flush),
        plain_ms=time_ms(lambda: attn.flash_fwd_reference(q, k, v, bias, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: sdpa(q4, k4, v4), flush=flush),
    )
    plans = attn.kernel_specs(bh, sq, sk, d, causal=False,
                              bias_shape=tuple(bias.shape[:2]),
                              dropout=dropout_p > 0, defines=())
    fwd["bound_ms"], fwd["bound_by"] = roofline_bound(plans[:1])
    do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    o, _, m, l = attn.flash_fwd(q, k, v, bias, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, m, l, delta, bias)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    o_lib = sdpa(qr, kr, vr)
    bwd = dict(
        ms=time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush),
        plain_ms=time_ms(lambda: attn.flash_bwd_reference(*args, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do.reshape(q4.shape), retain_graph=True),
            flush=flush),
    )
    bwd["bound_ms"], bwd["bound_by"] = roofline_bound(plans[1:])
    return fwd, bwd


def _time_evo_attention(gen, flush, bh, s, d, *, with_k34, with_bias=True,
                        dtype="bf16"):
    """K5 (and K3, K4) at an evoformer shape: q/k/v (bh, s, d) bf16,
    non-causal, a (bh, s, s) f32 bias at G = BH, beside the plain
    versions and SDPA with the same bias as a bf16 ``attn_mask`` of (B,
    H, S, S), H = 4.  K5's library call is SDPA's backward with the mask
    requiring grad, which returns dq, dk, dv and the mask's gradient: it
    stands beside K4 + K5 (``k4_plus_k5_ms``), not K5 alone.  Bounds:
    q, k, v (dO) read, o (dq, dk, dv) written, the f32 row statistics,
    the bias read and (K5) dbias written, against 2 products of 2·D
    flops per pair forward, 5 backward, 2 for K5's recompute.  Without
    ``with_bias`` (MSA column attention) only K3 and K4 run, and SDPA
    without a mask.  With ``dtype="f32"`` q, k, v, dO, the SDPA mask and
    SDPA run in f32 and the bytes count 4 per element; the f32 instances
    of K3, K4 and K5 count three TF32 products per product against the
    TF32 tensor-core peak (3xTF32)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    b = bh // EVO_HEADS
    scale = d ** -0.5
    q, k, v = attn_inputs(bh, s, s, d, gen)
    if dtype == "f32":
        q, k, v = (t.float() for t in (q, k, v))
    elem = q.element_size()
    # (product multiplier, peak) of K3, K4 and K5
    k34 = (3, TF32_TENSOR_FLOPS) if dtype == "f32" else (1, BF16_TENSOR_FLOPS)
    bias = (torch.randn(bh, s, s, generator=gen, device="cuda") if with_bias
            else None)
    kw = dict(scale=scale, causal=False)
    pairs = bh * s * s
    elems = bh * s * d
    stats = 3 * bh * s * 4
    bias_bytes = 0 if bias is None else bias.numel() * 4
    q4, k4, v4 = (t.reshape(b, EVO_HEADS, s, d) for t in (q, k, v))
    mask4 = (None if bias is None
             else bias.reshape(b, EVO_HEADS, s, s).to(q.dtype))

    def library(fn):
        """A library timing, or None (logged) where SDPA refuses."""
        try:
            return time_ms(fn, flush=flush)
        except RuntimeError as exc:
            log(f"  SDPA refused: {str(exc).splitlines()[0][:200]}")
            return None

    rows = {}
    o, _, m, l = attn.flash_fwd(q, k, v, bias, **kw)
    do = torch.randn(bh, s, d, generator=gen, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, m, l, delta, bias)
    if with_k34:
        rows["flash_fwd"] = dict(
            ms=time_ms(lambda: attn.flash_fwd(q, k, v, bias, **kw),
                       flush=flush),
            plain_ms=time_ms(lambda: attn.flash_fwd_reference(q, k, v, bias,
                                                              **kw),
                             flush=flush),
            library_ms=library(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, scale=scale)),
        )
        rows["flash_fwd"]["bound_ms"], rows["flash_fwd"]["bound_by"] = bound(
            4 * elems * elem + stats + bias_bytes, k34[0] * 4 * d * pairs,
            k34[1])
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask4,
                                               scale=scale)
        rows["flash_bwd"] = dict(
            ms=time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush),
            plain_ms=time_ms(lambda: attn.flash_bwd_reference(*args, **kw),
                             flush=flush),
            library_ms=library(lambda: torch.autograd.grad(
                o_lib, (qr, kr, vr), do.reshape(q4.shape),
                retain_graph=True)),
        )
        rows["flash_bwd"]["bound_ms"], rows["flash_bwd"]["bound_by"] = bound(
            7 * elems * elem + stats + bias_bytes, k34[0] * 10 * d * pairs,
            k34[1])
        del o_lib
    if bias is None:
        return rows
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    mr = mask4.detach().clone().requires_grad_()
    lib_k45 = None
    try:
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mr,
                                               scale=scale)
        lib_k45 = library(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr, mr), do.reshape(q4.shape), retain_graph=True))
        del o_lib
    except RuntimeError as exc:
        log(f"  SDPA refused a mask that requires grad: "
            f"{str(exc).splitlines()[0][:200]}")
    k5_ms = time_ms(lambda: attn.flash_dbias(*args, **kw), flush=flush)
    k4_ms = (rows["flash_bwd"]["ms"] if with_k34
             else time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush))
    rows["flash_dbias"] = dict(
        ms=k5_ms,
        plain_ms=time_ms(lambda: attn.flash_dbias_reference(*args, **kw),
                         flush=flush),
        library_ms=lib_k45,
        k4_ms=k4_ms,
        k4_plus_k5_ms=k4_ms + k5_ms,
    )
    rows["flash_dbias"]["bound_ms"], rows["flash_dbias"]["bound_by"] = bound(
        4 * elems * elem + stats + 2 * bias_bytes, k34[0] * 4 * d * pairs,
        k34[1])
    # (an older tree, timed with this script, has no fused call)
    if hasattr(attn, "flash_bwd_dbias") and attn._fused_dbias(
            bias, bh, s, q.dtype, d):
        # the fused call computes K4's and K5's functions in one: q, k, v,
        # dO, the statistics and the bias read once, dq, dk, dv and dbias
        # written once, K4's five products
        fused_ms = time_ms(lambda: attn.flash_bwd_dbias(*args, **kw),
                           flush=flush)
        rows["flash_bwd_dbias"] = dict(
            ms=fused_ms,
            plain_ms=time_ms(
                lambda: attn.flash_bwd_dbias_reference(*args, **kw),
                flush=flush),
            library_ms=lib_k45,
            k4_ms=k4_ms,
            k5_ms=k5_ms,
            k4_plus_k5_ms=k4_ms + k5_ms,
        )
        rows["flash_bwd_dbias"]["bound_ms"], rows["flash_bwd_dbias"][
            "bound_by"] = bound(7 * elems * elem + stats + 2 * bias_bytes,
                                10 * d * pairs, BF16_TENSOR_FLOPS)
    return rows


def _time_f32_attention(gen, flush):
    """The f32 instances of K3, K4 and K5 at the evoformer's three shapes,
    those of phase 10's f32 run (:func:`_time_evo_attention` with
    ``dtype="f32"``): {kernel: {"triangle_shape" | "msa_row_shape" |
    "msa_col_shape": row}}; MSA column attention has no bias and no K5."""
    import torch

    out = {}
    for tag, (bh, s, d), with_bias, what in (
            ("triangle_shape", TRIANGLE_SHAPE, True, "triangle attention"),
            ("msa_row_shape", MSA_ROW_SHAPE, True, "MSA row attention"),
            ("msa_col_shape", MSA_COL_SHAPE, False, "MSA column attention")):
        timed = _time_evo_attention(gen, flush, bh, s, d, with_k34=True,
                                    with_bias=with_bias, dtype="f32")
        shape = (f"BH={bh} S={s} D={d} non-causal f32, "
                 + (f"bias ({bh}, {s}, {s}) f32" if with_bias else "no bias")
                 + f" ({what})")
        for name, row in timed.items():
            out.setdefault(name + "_f32", {})[tag] = dict(row, shape=shape)
        torch.cuda.empty_cache()
    return out


def phase4(gen, launches, errs, off_path=True):
    """Each kernel at its main-path shapes: the GPT training shapes of
    phase 6 (K1, K2 at x (16384, 1024), which is also BERT's B·S x
    hidden; K3, K4 at BH=128, S=2048), BERT's attention of phase 8 (K3,
    K4 at BH=2048, S=128 with the padding bias, without and with dropout
    0.1) and the serving shapes of phase 2 (K1 at (2048, 1024), K3 at
    BH=16, S=2048, K6 at the decode batch), and the evoformer's attention
    of phase 10 (K3, K4 and K5 at the triangle and MSA row shapes, K3
    and K4 at the MSA column shape).  Beside them: K1 and K2 at the
    evoformer's f32 rows (pair (65536, 128), MSA (32768, 256)), K3 and K4
    at the reference's long-context shape (BH 8, S 16384, D 128, causal)
    and at D = 256 (BH 32, S 2048, causal), K3, K4 and K5 at D = 384 (BH
    32, S 2048), K1, K2 at (8192, 1024) and K3, K4 at BH = 64 (phase
    16's tp = 2 shapes), K6 at phase 1's short lengths, and the f32
    instances of K3, K4 and K5 at the triangle, MSA row and MSA column shapes (the
    f32-attention run of phase 10).  ``launches`` maps kernel -> {path:
    count} from the phase-2, -6, -8 and -10 runs (empty with
    ``--timing``).  ``off_path=False`` (the whole run) leaves out the
    rows no model runs — the long-context shape, D = 256 and D = 384 —
    which ``--timing`` keeps."""
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import paged_attention as pa

    log("phase 4: timing (median of 25 queued runs, L2 flushed before each)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    train_rows = TRAIN_BATCH * TRAIN_SEQ
    train_bh = TRAIN_BATCH * 16
    rows = {}
    ln_fwd, ln_bwd = _time_ln(gen, flush, train_rows, 1024)
    rows["layer_norm_fwd"] = dict(ln_fwd, shape=f"x ({train_rows}, 1024) bf16")
    rows["layer_norm_bwd"] = dict(ln_bwd, shape=f"x, g ({train_rows}, 1024) bf16")
    torch.cuda.empty_cache()
    extra = {}  # kernel -> {tag: row} of the shapes beside its main one
    # phase 22's O1 GPT: the same rows in f32 (the O1 cast of the residual)
    ln_fwd, ln_bwd = _time_ln(gen, flush, train_rows, 1024, "f32")
    extra["layer_norm_fwd"] = {"amp_o1_shape": dict(
        ln_fwd, shape=f"x ({train_rows}, 1024) f32 (amp O1)")}
    extra["layer_norm_bwd"] = {"amp_o1_shape": dict(
        ln_bwd, shape=f"x, g ({train_rows}, 1024) f32 (amp O1)")}
    torch.cuda.empty_cache()
    # the wide-row instance (hidden > 1024), and with --timing the
    # streamed width past it
    for name, by_tag in _time_ln_wide(gen, flush, streamed=off_path).items():
        extra[name].update(by_tag)
    for tag, n_rows, hidden in (
            ("evo_pair_shape", EVO_RES * EVO_RES, EVO["pair_dim"]),
            ("evo_msa_shape", EVO_SEQ * EVO_RES, EVO["msa_dim"]),
            ("dap_pair_shape", EVO_RES * EVO_RES // DAP, EVO["pair_dim"]),
            ("dap_msa_shape", EVO_SEQ * EVO_RES // DAP, EVO["msa_dim"])):
        ln_fwd, ln_bwd = _time_ln(gen, flush, n_rows, hidden, "f32")
        extra.setdefault("layer_norm_fwd", {})[tag] = dict(
            ln_fwd, shape=f"x ({n_rows}, {hidden}) f32 (evoformer)")
        extra.setdefault("layer_norm_bwd", {})[tag] = dict(
            ln_bwd, shape=f"x, g ({n_rows}, {hidden}) f32 (evoformer)")
        torch.cuda.empty_cache()
    at_fwd, at_bwd = _time_attn(gen, flush, train_bh, TRAIN_SEQ, with_bwd=True)
    shape = f"BH={train_bh} S={TRAIN_SEQ} D=64 causal bf16"
    rows["flash_fwd"] = dict(at_fwd, shape=shape)
    rows["flash_bwd"] = dict(at_bwd, shape=shape + ", m/l/delta f32")
    torch.cuda.empty_cache()
    # phase 16's sharded shapes (tp = 2 with sequence parallelism)
    ln_fwd, ln_bwd = _time_ln(gen, flush, train_rows // 2, 1024)
    shape = f"({train_rows // 2}, 1024) bf16 (tp = 2 + SP)"
    extra.setdefault("layer_norm_fwd", {})["tp2_shape"] = dict(
        ln_fwd, shape="x " + shape)
    extra.setdefault("layer_norm_bwd", {})["tp2_shape"] = dict(
        ln_bwd, shape="x, g " + shape)
    at_fwd, at_bwd = _time_attn(gen, flush, train_bh // 2, TRAIN_SEQ,
                                with_bwd=True)
    shape = f"BH={train_bh // 2} S={TRAIN_SEQ} D=64 causal bf16 (tp = 2)"
    extra.setdefault("flash_fwd", {})["tp2_shape"] = dict(at_fwd, shape=shape)
    extra.setdefault("flash_bwd", {})["tp2_shape"] = dict(
        at_bwd, shape=shape + ", m/l/delta f32")
    torch.cuda.empty_cache()

    for p, tag in ((0.0, "bert_shape"), (0.1, "bert_dropout_shape")):
        b_fwd, b_bwd = _time_attn_masked(
            gen, flush, BERT_BATCH, 16, BERT_SEQ, BERT_SEQ,
            padding_bias(bert_lengths(gen), BERT_SEQ), p)
        shape = (f"BH={BERT_BATCH * 16} S={BERT_SEQ} D=64 non-causal bf16, "
                 f"bias (B, 1, S) f32, dropout {p}")
        extra.setdefault("flash_fwd", {})[tag] = dict(b_fwd, shape=shape)
        extra.setdefault("flash_bwd", {})[tag] = dict(b_bwd, shape=shape)
        torch.cuda.empty_cache()

    # phase 25's multihead modules (25d) and fmha (25e): ragged key
    # padding (row 0 full), the enc-dec's padding + causal-shaped mask
    def lengths(b, sk):
        n = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda")
        n[0] = sk
        return n

    enc_bias = padding_bias(lengths(P25_B, P25_SK), P25_SK).expand(
        P25_B, P25_S, P25_SK) + torch.where(
            torch.arange(P25_SK, device="cuda")[None, :]
            > torch.arange(P25_S, device="cuda")[:, None] + (P25_SK - P25_S),
            -1e9, 0.0)
    for tag, b, sq, sk, bias, p, shape in (
            ("mha_self_shape", P25_B, P25_S, P25_S,
             padding_bias(lengths(P25_B, P25_S), P25_S), P25_DROPOUT,
             f"BH={P25_B * P25_H} S={P25_S} D=64 non-causal bf16, bias "
             f"(B, 1, S) f32, dropout {P25_DROPOUT} (SelfMultiheadAttn)"),
            ("mha_encdec_shape", P25_B, P25_S, P25_SK,
             torch.clamp(enc_bias, min=-1e9).contiguous(), P25_DROPOUT,
             f"BH={P25_B * P25_H} Sq={P25_S} Sk={P25_SK} D=64 bf16, bias "
             f"(B, Sq, Sk) f32, dropout {P25_DROPOUT} (EncdecMultiheadAttn)"),
            ("fmha_shape", P25_FMHA_B, P25_FMHA_S, P25_FMHA_S,
             padding_bias(lengths(P25_FMHA_B, P25_FMHA_S), P25_FMHA_S), 0.0,
             f"BH={P25_FMHA_B * P25_FMHA_H} S={P25_FMHA_S} D=64 non-causal "
             f"bf16, bias (B, 1, S) f32 (fmha)")):
        a_fwd, a_bwd = _time_attn_masked(gen, flush, b, P25_FMHA_H
                                         if tag == "fmha_shape" else P25_H,
                                         sq, sk, bias, p)
        extra.setdefault("flash_fwd", {})[tag] = dict(a_fwd, shape=shape)
        extra.setdefault("flash_bwd", {})[tag] = dict(a_bwd, shape=shape)
        torch.cuda.empty_cache()

    tri_bh, tri_s, tri_d = TRIANGLE_SHAPE
    row_bh, row_s, row_d = MSA_ROW_SHAPE
    evo = _time_evo_attention(gen, flush, tri_bh, tri_s, tri_d,
                              with_k34=True)
    tri_shape = (f"BH={tri_bh} S={tri_s} D={tri_d} non-causal bf16, bias "
                 f"({tri_bh}, {tri_s}, {tri_s}) f32 (triangle attention)")
    for name in ("flash_fwd", "flash_bwd"):
        extra.setdefault(name, {})["triangle_shape"] = dict(evo[name],
                                                           shape=tri_shape)
    rows["flash_dbias"] = dict(evo["flash_dbias"], shape=tri_shape)
    if "flash_bwd_dbias" in evo:
        rows["flash_bwd_dbias"] = dict(evo["flash_bwd_dbias"], shape=tri_shape)
    torch.cuda.empty_cache()
    msa = _time_evo_attention(gen, flush, row_bh, row_s, row_d,
                              with_k34=True)
    row_shape = (f"BH={row_bh} S={row_s} D={row_d} non-causal bf16, bias "
                 f"({row_bh}, {row_s}, {row_s}) f32 (MSA row attention)")
    for name in ("flash_fwd", "flash_bwd", "flash_dbias", "flash_bwd_dbias"):
        if name in msa:
            extra.setdefault(name, {})["msa_row_shape"] = dict(
                msa[name], shape=row_shape)
    torch.cuda.empty_cache()
    col_bh, col_s, col_d = MSA_COL_SHAPE
    msa = _time_evo_attention(gen, flush, col_bh, col_s, col_d,
                              with_k34=True, with_bias=False)
    for name in ("flash_fwd", "flash_bwd"):
        extra[name]["msa_col_shape"] = dict(
            msa[name], shape=f"BH={col_bh} S={col_s} D={col_d} non-causal "
            f"bf16, no bias (MSA column attention)")
    torch.cuda.empty_cache()
    # phase 17's DAP rank (dap = 2): the three calls on half the rows
    for what, (bh, sq, d) in DAP_SHAPES.items():
        with_bias = what != "msa_col"
        timed = _time_evo_attention(gen, flush, bh, sq, d, with_k34=True,
                                    with_bias=with_bias)
        shape = (f"BH={bh} S={sq} D={d} non-causal bf16, "
                 + (f"bias ({bh}, {sq}, {sq}) f32" if with_bias
                    else "no bias") + f" ({what} at a DAP rank, dap = 2)")
        for name, row in timed.items():
            extra.setdefault(name, {})[f"dap_{what}_shape"] = dict(
                row, shape=shape)
        torch.cuda.empty_cache()
    if off_path:
        # the reference's long-context shape (no model path)
        long_fwd, long_bwd = _time_attn_long(gen, flush)
        shape = (f"BH={LONG_BH} S={LONG_S} D={LONG_D} causal bf16 (long "
                 f"context)")
        extra["flash_fwd"]["long_context_shape"] = dict(long_fwd,
                                                        shape=shape)
        extra["flash_bwd"]["long_context_shape"] = dict(
            long_bwd, shape=shape + ", m/l/delta f32")
        torch.cuda.empty_cache()
    for name, by_shape in _time_f32_attention(gen, flush).items():
        rows[name] = by_shape.pop("triangle_shape")
        extra.setdefault(name, {}).update(by_shape)
    # phase 19's ring hops (f32, K4 with dlse)
    for name, by_shape in _time_ring_hops(gen, flush).items():
        extra.setdefault(name, {}).update(by_shape)
    if off_path:
        # a head dim past 128, which no model of either package runs
        wide_fwd, wide_bwd = _time_attn(gen, flush, WIDE_BH, WIDE_S,
                                        with_bwd=True, d=WIDE_D)
        shape = (f"BH={WIDE_BH} S={WIDE_S} D={WIDE_D} causal bf16 (no "
                 f"model path)")
        extra["flash_fwd"]["d256_shape"] = dict(wide_fwd, shape=shape)
        extra["flash_bwd"]["d256_shape"] = dict(
            wide_bwd, shape=shape + ", m/l/delta f32")
        torch.cuda.empty_cache()
        # and past 256 (the wide instance)
        wider = _time_attn_wider(gen, flush)
        if wider is not None:
            shape = (f"BH={WIDE_BH} S={WIDE_S} D={WIDER_D} bf16 (no model "
                     f"path)")
            for name, r, what in zip(
                    ("flash_fwd", "flash_bwd", "flash_dbias"), wider,
                    (" causal", " causal, m/l/delta f32",
                     f" non-causal, bias ({WIDE_BH}, {WIDE_S}, {WIDE_S})"
                     f" f32")):
                extra.setdefault(name, {})["d384_shape"] = dict(
                    r, shape=shape + what)
    torch.cuda.empty_cache()

    serving = {}
    serving["layer_norm_fwd"] = dict(_time_ln(gen, flush, 2048, 1024)[0],
                                     shape="x (2048, 1024) bf16")
    serving["flash_fwd"] = dict(
        _time_attn(gen, flush, 16, 2048, with_bwd=False)[0],
        shape="BH=16 S=2048 D=64 causal bf16")
    xs, ws, bs = ln_inputs(8, 1024, gen)
    log(f"  K1 at the decode shape (8, 1024): "
        f"{time_ms(lambda: ln.layer_norm_fwd(xs, ws, bs, eps=1e-5, rms=False), flush=flush):.4f} ms")

    # K6 at the decode shape of phase 2's batch
    args = paged_inputs(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                        lengths=MAIN_LENGTHS, gen=gen)
    pos = [args[k] for k in ("q", "k_pages", "v_pages", "page_table",
                             "lengths")]
    kw = dict(scale=0.125, rope_cos=args["rope_cos"],
              rope_sin=args["rope_sin"])
    b_ms, b_by = roofline_bound(pa.kernel_specs(
        8, 16, 64, page=16, np_=128, lengths=MAIN_LENGTHS))

    def library_paged(a, scale):
        """The same decode as one PyTorch gather of the pages and SDPA
        over them, with the RoPE applied to q first and the lengths as a
        mask, at any B, H, D and page size of ``a`` (paged_inputs)."""
        import torch.nn.functional as F

        from apex_tpu_torch.ops.rope import rotate_half

        b, h, d = a["q"].shape
        qf = a["q"].float()
        qr = (qf * a["rope_cos"][:, None] + rotate_half(qf)
              * a["rope_sin"][:, None]).to(a["k_pages"].dtype)
        table = a["page_table"].long()
        kk = a["k_pages"][table].transpose(1, 2).reshape(b, h, -1, d)
        vv = a["v_pages"][table].transpose(1, 2).reshape(b, h, -1, d)
        mask = (torch.arange(kk.shape[2], device="cuda")[None]
                < a["lengths"][:, None])[:, None, None]
        return F.scaled_dot_product_attention(qr[:, :, None], kk, vv,
                                              attn_mask=mask, scale=scale)

    serving["paged_decode"] = dict(
        shape="B=8 H=16 D=64 page=16 NP=128 bf16, "
        f"lengths {MAIN_LENGTHS}",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(lambda: library_paged(args, 0.125), flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )
    # and on int8 pages (the codes and f32 scales of the int8 KV wire,
    # phase 12's path) at the same batch and lengths
    q8 = paged_inputs(b=8, h=16, d=64, page=16, np_=128, pool=1025,
                      lengths=MAIN_LENGTHS, gen=gen, kv="int8")
    pos = [q8[k] for k in ("q", "k_pages", "v_pages", "page_table",
                           "lengths")]
    kw = dict(scale=0.125, k_scale=q8["k_scale"], v_scale=q8["v_scale"],
              rope_cos=q8["rope_cos"], rope_sin=q8["rope_sin"])
    b_ms, b_by = roofline_bound(pa.kernel_specs(
        8, 16, 64, page=16, np_=128, kv_dtype=torch.int8,
        lengths=MAIN_LENGTHS))

    def library_paged_int8(a, scale):
        """The dequantizing gather (the rows of the table's pages, codes
        x scales in q's dtype) and SDPA over it, with the RoPE applied
        to q first and the lengths as a mask."""
        import torch.nn.functional as F

        from apex_tpu_torch.ops.rope import rotate_half

        b, h, d = a["q"].shape
        qf = a["q"].float()
        qr = (qf * a["rope_cos"][:, None] + rotate_half(qf)
              * a["rope_sin"][:, None]).to(a["q"].dtype)
        table = a["page_table"].long()

        def rows(name):
            x = (a[f"{name}_pages"][table].float()
                 * a[f"{name}_scale"][table][..., None]).to(a["q"].dtype)
            return x.transpose(1, 2).reshape(b, h, -1, d)

        kk, vv = rows("k"), rows("v")
        mask = (torch.arange(kk.shape[2], device="cuda")[None]
                < a["lengths"][:, None])[:, None, None]
        return F.scaled_dot_product_attention(qr[:, :, None], kk, vv,
                                              attn_mask=mask, scale=scale)

    extra.setdefault("paged_decode", {})["int8_shape"] = dict(
        shape="B=8 H=16 D=64 page=16 NP=128 int8 pages + f32 scales, "
        f"lengths {MAIN_LENGTHS}",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(lambda: library_paged_int8(q8, 0.125),
                           flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )
    del q8
    torch.cuda.empty_cache()
    # and at phase 1's short lengths (one split a row): f32 pages
    short = paged_inputs(b=3, h=4, d=32, page=8, np_=3, pool=12,
                         lengths=[17, 9, 0], gen=gen, kv="f32")
    pos = [short[k] for k in ("q", "k_pages", "v_pages", "page_table",
                              "lengths")]
    kw = dict(scale=32 ** -0.5, rope_cos=short["rope_cos"],
              rope_sin=short["rope_sin"])
    b_ms, b_by = roofline_bound(pa.kernel_specs(
        3, 4, 32, page=8, np_=3, q_dtype=torch.float32,
        kv_dtype=torch.float32, lengths=[17, 9, 0]))
    extra.setdefault("paged_decode", {})["short_shape"] = dict(
        shape="B=3 H=4 D=32 page=8 NP=3 f32, lengths [17, 9, 0]",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(lambda: library_paged(short, 32 ** -0.5),
                           flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )
    del short
    # phase 28a's serving path in the tool's f32: K6 on f32 pages at its
    # decode batch, and K3 f32 at its longest causal prefill
    b, h, d, page, np_ = P28_DECODE
    f32p = paged_inputs(b=b, h=h, d=d, page=page, np_=np_,
                        pool=b * np_ + 1, lengths=P28_LENGTHS, gen=gen,
                        kv="f32")
    pos = [f32p[k] for k in ("q", "k_pages", "v_pages", "page_table",
                             "lengths")]
    kw = dict(scale=d ** -0.5, rope_cos=f32p["rope_cos"],
              rope_sin=f32p["rope_sin"])
    b_ms, b_by = roofline_bound(pa.kernel_specs(
        b, h, d, page=page, np_=np_, q_dtype=torch.float32,
        kv_dtype=torch.float32, lengths=P28_LENGTHS))
    extra.setdefault("paged_decode", {})["serve_bench_f32_shape"] = dict(
        shape=f"B={b} H={h} D={d} page={page} NP={np_} f32 pages, lengths "
        f"{list(P28_LENGTHS)} (phase 28a's decode batch)",
        ms=time_ms(lambda: pa.paged_decode_fwd(*pos, **kw), flush=flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_reference(*pos, **kw),
            flush=flush),
        library_ms=time_ms(lambda: library_paged(f32p, d ** -0.5),
                           flush=flush),
        bound_ms=b_ms, bound_by=b_by,
    )
    del f32p, pos
    extra.setdefault("flash_fwd_f32", {})["serve_bench_prefill_shape"] = \
        _time_p28_prefill(gen, flush)
    torch.cuda.empty_cache()

    def fields(r):
        return {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "library",
                                        "shape", "k4_ms", "k5_ms",
                                        "k4_plus_k5_ms")
                if key in r}

    kernels = []
    for name in KERNEL_ENTRIES:
        main = rows.get(name, serving.get(name))
        if main is None:  # --timing on an older tree without this entry
            log(f"  {name}: not in this tree")
            continue
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"apex_tpu_torch/csrc/{_build.library(name)}.cu",
            "replaces": REPLACES[name],
            "launches": sum(launches.get(name, {}).values()),
            "launches_by_path": launches.get(name, {}),
            "max_abs_err": errs.get(name),
            **fields(main),
        }
        if name in PHASE1_ONLY_ENTRIES:  # no main path: phase 1's count
            entry["phase1_launches"] = errs.get(f"{name}_phase1_launches")
        if name + "_d128" in errs:  # phase 1's first D = 128 case
            entry["max_abs_err_d128"] = errs[name + "_d128"]
        if name + "_ring" in errs:  # phase 1's ring hops (dlse != 0)
            entry["max_abs_err_ring"] = errs[name + "_ring"]
        if name in rows and name in serving:
            entry["serving_shape"] = fields(serving[name])
        for tag, r in extra.get(name, {}).items():
            entry[tag] = fields(r)
        kernels.append(entry)
        for tag, r in (("", main), (" (serving)", entry.get("serving_shape")),
                       (" (tp = 2)", entry.get("tp2_shape")),
                       (" (BERT)", entry.get("bert_shape")),
                       (" (BERT, dropout)", entry.get("bert_dropout_shape")),
                       (" (multihead self)", entry.get("mha_self_shape")),
                       (" (multihead enc-dec)",
                        entry.get("mha_encdec_shape")),
                       (" (fmha)", entry.get("fmha_shape")),
                       (" (triangle)", entry.get("triangle_shape")),
                       (" (MSA row)", entry.get("msa_row_shape")),
                       (" (MSA column)", entry.get("msa_col_shape")),
                       (" (long context)", entry.get("long_context_shape")),
                       (" (D = 256)", entry.get("d256_shape")),
                       (" (D = 384)", entry.get("d384_shape")),
                       (" (int8 pages)", entry.get("int8_shape")),
                       (" (short lengths)", entry.get("short_shape")),
                       (" (ring self hop)", entry.get("ring_self_shape")),
                       (" (ring past hop)", entry.get("ring_past_shape")),
                       (" (zigzag self half)",
                        entry.get("zigzag_self_shape")),
                       (" (zigzag past half)",
                        entry.get("zigzag_past_shape")),
                       (" (evoformer pair)", entry.get("evo_pair_shape")),
                       (" (evoformer MSA)", entry.get("evo_msa_shape")),
                       (" (amp O1, f32)", entry.get("amp_o1_shape")),
                       *((f" ({t.removesuffix('_shape').replace('_', ' ')})",
                          entry[t]) for t in entry
                         if t.startswith(("wide_", "streamed_")))):
            if r is None:
                continue
            lib = ("not measured" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            plain_s = ("not measured" if r["plain_ms"] is None
                       else f"{r['plain_ms']:.4f} ms")
            k45 = ("" if "k4_plus_k5_ms" not in r else
                   f" (K4 {r['k4_ms']:.4f} ms, "
                   + (f"K5 {r['k5_ms']:.4f} ms, " if "k5_ms" in r else "")
                   + f"K4 + K5 {r['k4_plus_k5_ms']:.4f} ms beside the "
                   f"library's backward with the mask's gradient)")
            if "library" in r:
                lib += f" ({r['library']})"
            log(f"  {name}{tag} [{r['shape']}]: kernel {r['ms']:.4f} ms, "
                f"plain {plain_s}, library {lib}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}){k45}")
    return kernels


def device_kernels(prof):
    """(name, self device us, launches) of every kernel a
    ``torch.profiler`` run recorded, without the GPU ranges of user
    annotations (``Optimizer.step#...``), which overlap the kernels they
    enclose and would count their time twice."""
    from torch.autograd import DeviceType

    return [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]


def group_kernels(kernels):
    """Device ms per layer (phases 6, 8, 10): the kernel-name table of
    :data:`apex_tpu_torch.observability.attribution.KERNEL_GROUPS`, then
    the rest (elementwise, copies, reductions)."""
    from apex_tpu_torch.observability.attribution import group_kernels as g

    return g(kernels)


# ---------------------------------------------------------------------------
# phase 5: where the decode step's time goes
# ---------------------------------------------------------------------------


def _decode_profile(engine, eager):
    """Decode iterations at batch 8 (full width, contexts ~512) through
    the scheduler: the host time of 4 unprofiled iterations and their
    counted launches, then a torch.profiler trace of 4 more — the summed
    device time of the kernels they ran, the kernels that took most, and
    where the host time went: inside PyTorch ops and CUDA runtime calls
    (self CPU time, by op) or in Python outside them.  ``eager`` runs the
    step eagerly on the card (the engine's private eager entry point)
    instead of replaying the captured graph."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    rs = np.random.RandomState(2)
    sched = ContinuousBatchingScheduler(engine)
    steps = 4
    for _ in range(8):
        sched.submit(Request(
            prompt=[int(t) for t in rs.randint(0, engine.cfg.vocab_size,
                                               size=512)],
            max_new_tokens=2 * steps + 2,
        ))
    sched.step()  # the 8 prefills and the first decode, not timed
    decode = engine.decode
    if eager:
        def eager_decode(tokens, lengths, tables, temps=None, **kw):
            logits, nxt, finite = engine._decode_eager(
                tokens, lengths, tables, temps, **kw)
            engine.decode_iters += 1
            engine.last_decode_finite = finite
            return logits, nxt

        engine.decode = eager_decode
    try:
        torch.cuda.synchronize()
        before = _dispatch.launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / steps
        after = _dispatch.launches()
        counted = {k: (after.get(k, 0) - before.get(k, 0)) / steps
                   for k in after if after.get(k, 0) != before.get(k, 0)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                sched.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine.decode = decode
    replay = None if eager else _replay_ms(engine)
    sched.run()
    kernels = device_kernels(prof)
    host_ops = [
        (e.key, e.self_cpu_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0
    ]
    in_ops_ms = sum(o[1] for o in host_ops) / 1e3 / steps
    out = {
        "host_ms_per_step_unprofiled": plain_ms,
        "host_ms_per_step": wall * 1e3 / steps,
        "host_ms_per_step_in_ops": in_ops_ms,
        "host_ms_per_step_outside_ops": wall * 1e3 / steps - in_ops_ms,
        "counted_launches_per_step": counted,
    }
    if replay is not None:
        out["replay_device_ms"] = replay
        log(f"  one replay of the captured step {replay:.4f} ms on the card "
            f"(CUDA events)")
    log(f"  host {plain_ms:.3f} ms/step unprofiled; profiled "
        f"{out['host_ms_per_step']:.3f} ms/step, of which "
        f"{in_ops_ms:.3f} inside PyTorch ops and runtime calls (self CPU "
        f"time) and {out['host_ms_per_step_outside_ops']:.3f} outside them; "
        f"counted launches a step {counted}")
    for key, us, count in sorted(host_ops, key=lambda o: -o[1])[:6]:
        log(f"    host {us / steps / 1e3:8.4f} ms/step  {count // steps:4d}x  "
            f"{key[:80]}")
    if not kernels:
        log("  the profiler recorded no device kernels: device time not "
            "measured")
        return out
    busy_us = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    out.update({
        "device_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_busy_share_unprofiled": busy_us / 1e3 / steps / plain_ms,
        "kernel_launches_per_step": launches / steps,
    })
    k6 = [k for k in kernels if "paged_decode_kernel" in k[0]]
    out["k6_ms_per_step"] = sum(k[1] for k in k6) / 1e3 / steps
    out["k6_launches_per_step"] = sum(k[2] for k in k6) / steps
    out["k6_share_of_device"] = out["k6_ms_per_step"] / out[
        "device_ms_per_step"]
    log(f"  device kernels {out['device_ms_per_step']:.3f} ms/step, busy "
        f"share {out['device_busy_share']:.3f} profiled and "
        f"{out['device_busy_share_unprofiled']:.3f} against the unprofiled "
        f"host time, {out['kernel_launches_per_step']:.0f} kernel "
        f"launches/step; K6 {out['k6_ms_per_step']:.4f} ms/step in "
        f"{out['k6_launches_per_step']:.0f} launches, "
        f"{out['k6_share_of_device']:.3f} of the kernel time")
    for key, us, count in sorted(kernels, key=lambda k: -k[1])[:6]:
        log(f"    {us / steps / 1e3:8.4f} ms/step  {count // steps:4d}x  "
            f"{key[:90]}")
    return out


def _replay_ms(engine, iters=20):
    """Median device ms of one replay of the captured decode step (CUDA
    events around ``replay``) on the static inputs of the last step,
    whose appends rewrite the same slots of pages the live requests
    still own."""
    import torch

    graph = engine._graph["graph"]
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase5(engine):
    """The decode step at batch 8 through the captured CUDA graph and
    eagerly on the card, on the bf16 KV pool of phase 2's engine and on
    an int8 KV pool (the same weights): host and device time per step,
    launches per step."""
    import torch

    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    log("phase 5: decode iterations at batch 8, the graph against the "
        "eager step, bf16 and int8 KV pages")
    out = {}
    int8 = InferenceEngine(engine.cfg, engine.model, dataclasses.replace(
        engine.serve, kv_wire="int8")).build(buckets=(512,))
    for tag, eng in (("bf16_kv", engine), ("int8_kv", int8)):
        out[tag] = {}
        for mode in ("graph", "eager"):
            log(f"  {tag}, {mode}:")
            out[tag][mode] = _decode_profile(eng, eager=mode == "eager")
    del int8
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: the training slice at full width
# ---------------------------------------------------------------------------


TRAIN_BATCH = 8
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-4


def phase6():
    """``examples.train_gpt`` (its ``train``, which ``main`` wraps) at
    ``GptConfig(remat=True)``, seq 2048, batch 8, 8 steps, lr 3e-4 on the
    synthetic zipf corpus it writes to the temporary directory.  Per
    step with full remat, L layers: K1 runs 2L+1 times forward and 2L
    again in the recompute, K2 2L+1 times, K3 L + L times and K4 L
    times; every count must be exactly that times the steps.  Then one
    more step under ``torch.profiler``.  Then 3 steps each under
    ``remat_policy="dots"`` and ``"sums"`` (the same launches a step: K1
    and K3 are recomputed under every policy), with their step time,
    tokens/s and peak memory beside ``"full"``'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.ops import _dispatch

    log(f"phase 6: train GptConfig(remat=True) {TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH}, seq {TRAIN_SEQ}")
    args = train_gpt.parse_args([
        "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
        "--seq-len", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    run = train_gpt.train(args)
    torch.cuda.synchronize()
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    peak = torch.cuda.max_memory_allocated()
    layers = run.cfg.num_layers
    per_step = {"layer_norm_fwd": 2 * (2 * layers) + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "flash_fwd": 2 * layers, "flash_bwd": layers}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"  launches={launches} (per step {per_step}) paths={paths}")
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"training op paths {paths}")
    losses = run.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    n_params = sum(p.numel() for p in run.model.parameters())
    step_s = statistics.median(run.step_seconds[1:])
    tokens_per_s = run.tokens_per_step / step_s
    mfu = 6 * n_params * run.tokens_per_step / step_s / BF16_TENSOR_FLOPS
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  step seconds {[round(x, 4) for x in run.step_seconds]}; median "
        f"of steps 1.. {step_s * 1e3:.1f} ms, {tokens_per_s:.0f} tokens/s, "
        f"6NT MFU {mfu:.4f} (N={n_params}), peak memory {peak / 1e9:.2f} GB")

    ids = next(run.batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_gpt.train_step(run.model, run.optimizer, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(device_kernels(prof), key=lambda o: -o[1])
    busy_ms = sum(o[1] for o in ops) / 1e3
    groups = group_kernels(ops)
    log(f"  profiled step: {wall * 1e3:.1f} ms host, {busy_ms:.1f} ms of "
        f"device kernels ({busy_ms / (wall * 1e3):.3f} busy), "
        f"{sum(o[2] for o in ops)} kernel launches")
    log("  device ms by layer: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    top = []
    for key, us, count in ops[:15]:
        log(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")
        top.append({"op": key[:100], "ms": us / 1e3, "count": count})
    out = {
        "losses": losses,
        "step_seconds": run.step_seconds,
        "step_ms_median": step_s * 1e3,
        "tokens_per_step": run.tokens_per_step,
        "tokens_per_s": tokens_per_s,
        "params": n_params,
        "mfu_6nt": mfu,
        "peak_memory_bytes": peak,
        "profiled_step_ms": wall * 1e3,
        "profiled_device_ms": busy_ms,
        "device_ms_by_layer": groups,
        "top_device_ops": top,
    }
    cfg = run.cfg
    full = dict(step_ms_median=step_s * 1e3, tokens_per_s=tokens_per_s,
                peak_memory_bytes=peak)
    full.update(_profiled_train_step(run.model, run.optimizer,
                                     next(run.batches), step_s))
    log(f"  remat_policy='full' (the run above): one profiled step "
        f"{full['profiled_step_ms']:.1f} ms host, "
        f"{full['profiled_device_ms']:.1f} ms of kernels in "
        f"{full['profiled_kernel_launches']} launches, "
        f"{full['profiled_host_ms_in_ops']:.1f} ms of host time in ops")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["remat_policies"] = {"full": full}
    for policy in ("dots", "sums"):
        out["remat_policies"][policy] = _train_gpt_policy(
            args, dataclasses.replace(cfg, remat_policy=policy), per_step)
    return launches, out


def _profiled_train_step(model, opt, ids, step_s):
    """One more training step under ``torch.profiler``: its host time,
    its kernels' device time and launches, and the host time inside
    PyTorch ops (self CPU time, where a dispatch mode's Python shows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples import train_gpt

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_gpt.train_step(model, opt, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    host_in_ops = sum(e.self_cpu_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU) / 1e3
    device_ms = sum(k[1] for k in kernels) / 1e3
    return {"profiled_step_ms": wall * 1e3, "profiled_device_ms": device_ms,
            "profiled_kernel_launches": sum(k[2] for k in kernels),
            "profiled_host_ms_in_ops": host_in_ops,
            "device_busy_share_unprofiled": device_ms / (step_s * 1e3)}


def _train_gpt_policy(args, cfg, per_step, steps=3):
    """``steps`` FusedAdam steps of a fresh seeded ``GptModel(cfg)`` on
    the example's corpus and loader, with the launches checked against
    ``per_step``; returns the median step time of steps 1.., tokens/s and
    the peak memory."""
    import torch

    from apex_tpu_torch.data import DataLoader, TokenFileDataset
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import GptModel
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GptModel(cfg)  # weights seeded with 0, as the example's
    opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
    loader = DataLoader(TokenFileDataset(
        train_gpt.corpus(args, cfg.vocab_size), seq_len=TRAIN_SEQ),
        batch_size=TRAIN_BATCH, seed=7)
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    losses, seconds = [], []
    for _, batch in zip(range(steps), loader):
        ids = torch.as_tensor(batch.T.astype(np.int64), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_gpt.train_step(model, opt, ids)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = _dispatch.launches()
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"training under {cfg.remat_policy!r}: launches "
                             f"{launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"losses not finite: {losses}")
    step_s = statistics.median(seconds[1:])
    res = {"losses": losses, "step_seconds": seconds,
           "step_ms_median": step_s * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    res.update(_profiled_train_step(model, opt, ids, step_s))
    log(f"  remat_policy={cfg.remat_policy!r}: {steps} steps, launches "
        f"{launches} (per step as 'full'), step {res['step_ms_median']:.1f} "
        f"ms, {res['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{res['peak_memory_bytes'] / 1e9:.2f} GB, losses "
        f"{[round(x, 4) for x in losses]}; one profiled step: "
        f"{res['profiled_step_ms']:.1f} ms host, "
        f"{res['profiled_device_ms']:.1f} ms of kernels in "
        f"{res['profiled_kernel_launches']} launches, "
        f"{res['profiled_host_ms_in_ops']:.1f} ms of host time in ops")
    del model, opt
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 7: one training step, card bf16 against CPU f32, 2 layers
# ---------------------------------------------------------------------------


#: The phase-7 limits sit between sound and faulty readings of the same
#: comparison.  Sound: an H100 read a loss 5.5e-5 off the CPU's, a worst
#: per-parameter gradient error of 1.27% and a worst mean |Δ update| of
#: 9.0e-6 to 9.6e-6; the CPU path in bf16 against the CPU in f32 (other
#: random weights) reads 2.3e-4, 1.29% and 8.9e-6.  Faulty, each against
#: the sound CPU f32 step with one plain twin altered: K3 dropping the
#: second 64-key tile for the last 64 rows moves the loss by 3.2e-3 and
#: a gradient by 38%; K4 dropping that tile in the dQ pass moves a
#: gradient by 14% (mean |Δ update| 2.9e-5), in the dK/dV pass by 22%;
#: K2 dropping the mean(g·w) term of dx moves one by 4.8%.
#: |loss(card bf16) - loss(CPU f32)|: the loss is ~11 (ln 50304)
LOSS_TOL = 1e-3
#: per parameter, ||grad_card - grad_cpu|| / ||grad_cpu||
GRAD_REL_TOL = 2.5e-2
#: Adam's first step moves each weight by -lr * g / (|g| + eps), i.e.
#: by ±lr: an element whose gradient sign differs between the two runs
#: moves 2*lr apart and no element moves further; such sign flips are
#: rare (they need |g| within the gradient error), so the mean |Δ update|
#: over a parameter's elements stays small
ADAM_MAX_TOL = 2 * TRAIN_LR * (1 + 1e-3)
ADAM_MEAN_TOL = 2e-5


def _gpt_cross_step(model, ids):
    """One ``gpt_lm_loss`` + FusedAdam step: (loss, {name: grad}, {name:
    update}) on the CPU in f32."""
    from apex_tpu_torch.models import gpt_lm_loss
    from apex_tpu_torch.optimizers import FusedAdam

    before = {k: p.detach().clone().cpu() for k, p in model.named_parameters()}
    opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
    loss = gpt_lm_loss(model, ids)
    loss.backward()
    grads = {k: p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    opt.step()
    updates = {k: p.detach().cpu() - before[k]
               for k, p in model.named_parameters()}
    return float(loss.detach()), grads, updates


def phase7():
    """GptConfig at full width with 2 layers, B=2, S=256: the loss, every
    parameter's gradient and the weights after one FusedAdam step on the
    card (bf16 compute, kernels K1-K4) against the CPU (f32, the plain
    versions), from the same f32 weights and the same batch: without
    remat, and with ``remat=True`` under each of ``"full"``, ``"dots"``
    and ``"sums"``, whose losses and gradients on the card must be equal
    bit for bit."""
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel

    log("phase 7: 2-layer full width training step, card bf16 against "
        "CPU f32, without remat and under each remat policy")
    cfg = GptConfig(num_layers=2, max_seq_len=256)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    card = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(11))
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu = GptModel(cpu_cfg, device="cpu")
    cpu.load_state_dict(state)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(256, 2)).astype(np.int64))
    l_cpu, g_cpu, u_cpu = _gpt_cross_step(cpu, ids)
    results = {"card": _gpt_cross_step(card, ids.cuda())}
    for policy in ("full", "dots", "sums"):
        model = GptModel(dataclasses.replace(cfg, remat=True,
                                             remat_policy=policy))
        model.load_state_dict(state)
        results[f"remat {policy}"] = _gpt_cross_step(model, ids.cuda())
        del model
    out = {"loss_cpu": l_cpu}
    for name, (l_card, g_card, u_card) in results.items():
        log(f"  {name}: loss card={l_card:.6f} cpu={l_cpu:.6f} "
            f"diff={abs(l_card - l_cpu):.2e} tol={LOSS_TOL}")
        if not np.isfinite(l_card) or abs(l_card - l_cpu) > LOSS_TOL:
            raise AssertionError(f"phase 7 ({name}): the losses disagree")
        worst_grad, worst_max, worst_mean = 0.0, 0.0, 0.0
        for k in g_cpu:
            rel = float((g_card[k] - g_cpu[k]).norm()
                        / g_cpu[k].norm().clamp_min(1e-30))
            du = (u_card[k] - u_cpu[k]).abs()
            worst_grad = max(worst_grad, rel)
            worst_max = max(worst_max, float(du.max()))
            worst_mean = max(worst_mean, float(du.mean()))
            if not rel <= GRAD_REL_TOL:
                raise AssertionError(
                    f"phase 7 ({name}): grad of {k} off by {rel:.3e}")
        log(f"  {name}: worst per-parameter grad relative error "
            f"{worst_grad:.3e} (tol {GRAD_REL_TOL}); after one Adam step: "
            f"worst max |Δ update| {worst_max:.3e} (tol {ADAM_MAX_TOL:.3e}), "
            f"worst mean |Δ update| {worst_mean:.3e} (tol "
            f"{ADAM_MEAN_TOL:.3e})")
        if not (worst_max <= ADAM_MAX_TOL and worst_mean <= ADAM_MEAN_TOL):
            raise AssertionError(f"phase 7 ({name}): the Adam updates "
                                 f"disagree")
        key = "card" if name == "card" else name.replace(" ", "_")
        out[key] = {"loss_card": l_card, "max_grad_rel_err": worst_grad,
                    "max_update_diff": worst_max,
                    "max_mean_update_diff": worst_mean}
    ref = results["remat full"]
    for policy in ("dots", "sums"):
        l_p, g_p, _ = results[f"remat {policy}"]
        if l_p != ref[0] or any(not torch.equal(g_p[k], ref[1][k])
                                for k in g_p):
            raise AssertionError(f"phase 7: remat_policy {policy!r} differs "
                                 f"from 'full' on the card")
    log("  the three remat policies give the same loss and gradients on "
        "the card, bit for bit")
    out["policies_bit_identical"] = True
    # the keys of earlier runs' JSON
    out.update(loss_card=out["card"]["loss_card"],
               max_grad_rel_err=out["card"]["max_grad_rel_err"],
               max_update_diff=out["card"]["max_update_diff"],
               max_mean_update_diff=out["card"]["max_mean_update_diff"])
    return out


# ---------------------------------------------------------------------------
# phase 8: BERT-Large pretraining at full width
# ---------------------------------------------------------------------------


BERT_STEPS = 8
BERT_DROPOUT_STEPS = 2


def bert_step_launches(layers):
    """Kernel launches of one BERT training step with full remat and L
    layers: K1 runs 2L+2 times forward (the embedding LayerNorm, two per
    block, the MLM transform's) and 2L again in the blocks' recompute, K2
    2L+2 times, K3 L + L times (forward and recompute) and K4 L times."""
    return {"layer_norm_fwd": (2 * layers + 2) + 2 * layers,
            "layer_norm_bwd": 2 * layers + 2,
            "flash_fwd": 2 * layers, "flash_bwd": layers}


def _check_launches(tag, steps, layers):
    from apex_tpu_torch.ops import _dispatch

    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    per_step = bert_step_launches(layers)
    want = {k: n * steps for k, n in per_step.items()}
    log(f"  {tag}: launches={launches} (per step {per_step}) paths={paths}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"{tag}: op paths {paths}")
    return launches


def phase8():
    """``examples.pretrain_bert``'s ``train`` at ``BertConfig(remat=True)``
    (BERT-Large, bf16 compute on f32 weights), batch 128, seq 128, K = 20
    masked predictions per sequence, FusedLAMB at lr 1e-3, 8 steps on the
    synthetic corpus; then 2 steps with dropout 0.1 in the attention and
    hidden layers (``deterministic=False``) through the same
    ``train_step``.  The launch counters are zeroed before each run and
    read after it: K1-K4 must have launched exactly their per-step counts
    times the steps.  Losses must be finite, and falling over the 8
    steps.  Then one more step under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples import pretrain_bert
    from apex_tpu_torch.ops import _dispatch

    log(f"phase 8: train BertConfig(remat=True) {BERT_STEPS} steps at batch "
        f"{BERT_BATCH}, seq {BERT_SEQ}, then {BERT_DROPOUT_STEPS} with "
        f"dropout")
    args = pretrain_bert.parse_args([
        "--steps", str(BERT_STEPS), "--batch", str(BERT_BATCH),
        "--seq-len", str(BERT_SEQ),
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    run = pretrain_bert.train(args)
    torch.cuda.synchronize()
    layers = run.cfg.num_layers
    launches = {"bert": _check_launches("BERT", BERT_STEPS, layers)}
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")

    gen = torch.Generator().manual_seed(99)
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    drop_losses, drop_seconds = [], []
    for _ in range(BERT_DROPOUT_STEPS):
        batch = next(run.batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drop_losses.append(float(pretrain_bert.train_step(
            run.model, run.optimizer, batch, generator=gen)))
        torch.cuda.synchronize()
        drop_seconds.append(time.perf_counter() - t0)
    launches["bert_dropout"] = _check_launches(
        "BERT with dropout", BERT_DROPOUT_STEPS, layers)
    if not all(np.isfinite(drop_losses)):
        raise AssertionError(f"dropout losses not finite: {drop_losses}")

    n_params = sum(p.numel() for p in run.model.parameters())
    step_s = statistics.median(run.step_seconds[1:])
    mfu = 6 * n_params * run.tokens_per_step / step_s / BF16_TENSOR_FLOPS
    log(f"  losses {[round(x, 4) for x in losses]}; with dropout "
        f"{[round(x, 4) for x in drop_losses]}")
    log(f"  step seconds {[round(x, 4) for x in run.step_seconds]}; median "
        f"of steps 1.. {step_s * 1e3:.1f} ms, "
        f"{run.sequences_per_step / step_s:.1f} sequences/s, "
        f"{run.tokens_per_step / step_s:.0f} tokens/s, 6NT MFU {mfu:.4f} "
        f"(N={n_params}), peak memory {peak / 1e9:.2f} GB; with dropout "
        f"{[round(x * 1e3, 1) for x in drop_seconds]} ms")

    batch = next(run.batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pretrain_bert.train_step(run.model, run.optimizer, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(device_kernels(prof), key=lambda o: -o[1])
    busy_ms = sum(o[1] for o in ops) / 1e3
    groups = group_kernels(ops)
    log(f"  profiled step: {wall * 1e3:.1f} ms host, {busy_ms:.1f} ms of "
        f"device kernels ({busy_ms / (wall * 1e3):.3f} busy; "
        f"{busy_ms / (step_s * 1e3):.3f} of the unprofiled median step), "
        f"{sum(o[2] for o in ops)} kernel launches")
    log("  device ms by layer: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    top = []
    for key, us, count in ops[:15]:
        log(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")
        top.append({"op": key[:100], "ms": us / 1e3, "count": count})
    out = {
        "device_busy_share_unprofiled": busy_ms / (step_s * 1e3),
        "losses": losses,
        "dropout_losses": drop_losses,
        "step_seconds": run.step_seconds,
        "dropout_step_seconds": drop_seconds,
        "step_ms_median": step_s * 1e3,
        "sequences_per_s": run.sequences_per_step / step_s,
        "tokens_per_s": run.tokens_per_step / step_s,
        "params": n_params,
        "mfu_6nt": mfu,
        "peak_memory_bytes": peak,
        "profiled_step_ms": wall * 1e3,
        "profiled_device_ms": busy_ms,
        "device_ms_by_layer": groups,
        "top_device_ops": top,
    }
    del run
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 9: one BERT training step with dropout, card bf16 against CPU f32
# ---------------------------------------------------------------------------


#: The phase-9 limits, like phase 7's, sit between the sound reading and
#: the readings of a planted fault in one plain twin.  Faulty, each f32
#: CPU step with one twin altered against the sound f32 CPU step: K3
#: dropping the bias moves the loss by 4.0e-3, a gradient by 55% and an
#: update by 104%; K4 recomputing p = exp(s - lse) (the TPU's rule, wrong
#: in the fully padded row) moves a gradient 4300-fold and an update by
#: 154%; K4 hashing the keep mask with seed + 1 moves a gradient by 22%
#: and an update by 84%; K4 leaving the keep mask off dP by 14% and 74%;
#: K4 dropping the bias gives non-finite gradients; K2 dropping the
#: mean(g·w) term of dx moves a gradient by 4.1% and an update by 19%.
#: The same comparison with the CPU in bf16 reads 2.2e-3, 1.1% and 17.5%.
#: |loss(card bf16) - loss(CPU f32)|: the loss is ~11.6
BERT_LOSS_TOL = 3e-3
#: per parameter, ||grad_card - grad_cpu|| / ||grad_cpu||
BERT_GRAD_REL_TOL = 3e-2
#: per parameter, ||update_card - update_cpu|| / ||update_cpu||: LAMB's
#: first step moves each element by about ±lr·ratio, so an element whose
#: gradient sign differs between bf16 and f32 moves the other way; this
#: limit catches the attention twins' faults, the gradient limit K2's
BERT_UPDATE_REL_TOL = 0.5
BERT_LR = 1e-3
BERT_CROSS_LENGTHS = (128, 100, 37, 0)


def bert_cross_step(device, seed_model=13, **over):
    """One ``bert_pretrain_loss`` + FusedLAMB step of the 2-layer,
    full-width BERT with attention dropout 0.1 (hidden dropout 0) on
    ``device`` ("cuda": bf16 compute; "cpu": f32), from the weights drawn
    on the CPU from ``seed_model`` and a fixed batch: B = 4, S = 128,
    attention_mask lengths 128/100/37/0 (the last sequence has no real
    token), 20 packed predictions per sequence, the dropout generator
    seeded alike on both sides (the same attention masks).  ``over``
    sets more config fields (the remat options).  Returns (loss, {name:
    grad}, {name: update}) on the CPU in f32."""
    import torch

    from apex_tpu_torch import data
    from apex_tpu_torch.models import BertConfig, BertForPreTraining
    from apex_tpu_torch.models import bert_pretrain_loss
    from apex_tpu_torch.optimizers import FusedLAMB

    cfg = BertConfig(num_layers=2, attention_dropout=0.1, hidden_dropout=0.0,
                     dtype=torch.bfloat16 if device == "cuda"
                     else torch.float32, **over)
    model = BertForPreTraining(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(
                                   seed_model)).to(device)
    rs = np.random.RandomState(5)
    b, s = len(BERT_CROSS_LENGTHS), BERT_SEQ
    ids = rs.randint(1000, cfg.vocab_size, size=(s, b)).astype(np.int32)
    labels = np.where(rs.rand(s, b) < 0.15, ids, -1).astype(np.int32)
    pos, pids, w = data.pack_mlm_predictions(labels, 20)
    batch = {
        "input_ids": ids,
        "token_type_ids": (np.arange(s)[:, None] >= s // 2).repeat(b, 1)
        .astype(np.int32),
        "attention_mask": (np.arange(s)[None] < np.array(
            BERT_CROSS_LENGTHS)[:, None]).astype(np.int32),
        "nsp_labels": rs.randint(0, 2, size=(b,)).astype(np.int32),
        "mlm_positions": pos, "mlm_label_ids": pids, "mlm_weights": w,
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    before = {k: p.detach().float().cpu().clone()
              for k, p in model.named_parameters()}
    opt = FusedLAMB(model.parameters(), lr=BERT_LR, weight_decay=0.01)
    loss = bert_pretrain_loss(model, batch, deterministic=False,
                              generator=torch.Generator().manual_seed(17))
    loss.backward()
    grads = {k: p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    opt.step()
    updates = {k: p.detach().float().cpu() - before[k]
               for k, p in model.named_parameters()}
    return float(loss.detach()), grads, updates


def compare_cross(a, b):
    """(|loss diff|, worst per-parameter relative gradient error, worst
    per-parameter relative update error) of step ``a`` against the
    reference step ``b``, with the names of the worst parameters."""
    (la, ga, ua), (lb, gb, ub) = a, b

    def worst(x, y):
        rel = {k: float((x[k] - y[k]).norm() / y[k].norm().clamp_min(1e-30))
               for k in y}
        rel = {k: r if np.isfinite(r) else float("inf") for k, r in rel.items()}
        k = max(rel, key=rel.get)
        return rel[k], k

    return abs(la - lb), worst(ga, gb), worst(ua, ub)


#: phase 9's card runs: without remat, and under the remat options
BERT_REMAT_RUNS = {
    "card": {},
    "remat full": dict(remat=True, remat_policy="full"),
    "remat dots": dict(remat=True, remat_policy="dots"),
    "remat sums": dict(remat=True, remat_policy="sums"),
    "remat sums + remat_attention": dict(remat=True, remat_policy="sums",
                                         remat_attention=True),
}


def phase9():
    """BERT at full width with 2 layers: the loss, every parameter's
    gradient and the weights after one FusedLAMB step on the card (bf16,
    K1-K4 with the padding bias and attention dropout) against the CPU
    (f32, the plain twins), from the same weights, batch and attention
    dropout seeds: without remat, and with ``remat=True`` under ``"full"``,
    ``"dots"``, ``"sums"`` and ``"sums"`` with ``remat_attention``, whose
    losses and gradients on the card must be equal bit for bit."""
    import torch

    log("phase 9: 2-layer full-width BERT step with attention dropout and "
        "a fully padded row, card bf16 against CPU f32, without remat and "
        "under the remat options")
    cpu = bert_cross_step("cpu")
    out = {"loss_cpu": cpu[0]}
    runs = {}
    for name, over in BERT_REMAT_RUNS.items():
        card = runs[name] = bert_cross_step("cuda", **over)
        dloss, (grad_rel, grad_k), (upd_rel, upd_k) = compare_cross(card, cpu)
        log(f"  {name}: loss card={card[0]:.6f} cpu={cpu[0]:.6f} "
            f"diff={dloss:.2e} (tol {BERT_LOSS_TOL}); worst grad relative "
            f"error {grad_rel:.3e} ({grad_k}, tol {BERT_GRAD_REL_TOL}); after "
            f"one LAMB step worst update relative error {upd_rel:.3e} "
            f"({upd_k}, tol {BERT_UPDATE_REL_TOL})")
        if not dloss <= BERT_LOSS_TOL:
            raise AssertionError(f"phase 9 ({name}): the losses disagree")
        if not grad_rel <= BERT_GRAD_REL_TOL:
            raise AssertionError(
                f"phase 9 ({name}): grad of {grad_k} off by {grad_rel}")
        if not upd_rel <= BERT_UPDATE_REL_TOL:
            raise AssertionError(
                f"phase 9 ({name}): update of {upd_k} off by {upd_rel}")
        out[name.replace(" ", "_")] = {
            "loss_card": card[0], "max_grad_rel_err": grad_rel,
            "max_update_rel_err": upd_rel}
    ref = runs["remat full"]
    for name in ("remat dots", "remat sums", "remat sums + remat_attention"):
        loss, grads, _ = runs[name]
        if loss != ref[0] or any(not torch.equal(grads[k], ref[1][k])
                                 for k in grads):
            raise AssertionError(f"phase 9: {name} differs from remat full "
                                 f"on the card")
    log("  remat full, dots, sums and sums + remat_attention give the same "
        "loss and gradients on the card, bit for bit")
    out["policies_bit_identical"] = True
    out.update({k: out["card"][k] for k in
                ("loss_card", "max_grad_rel_err", "max_update_rel_err")})
    return out


# ---------------------------------------------------------------------------
# phase 14: checkpoints, preemption and bit-exact resume of BERT-Large
# ---------------------------------------------------------------------------


#: phase 14's runs: phase 8's configuration at 6 of BERT-Large's 24
#: layers (the depth cuts that made room for phases 26 and 27, 24 -> 12
#: -> 6: a checkpoint of ~1.5 GB instead of ~4.0 GB, the same schedule),
#: 8 steps, a checkpoint every 2; the drill's chaos spec (a save that
#: fails once at step 2, partial debris then a failure at 4, SIGTERM
#: while step 5 runs)
RES_LAYERS = 6
RES_STEPS = 8
RES_SAVE_EVERY = 2
RES_SPEC = ("checkpoint_save:raise:x1@2;checkpoint_save:partial:x1@4;"
            "preemption@5")
RES_SEED = 1234
#: (c)'s steps in each mode (10 before phase 25 joined the script: the
#: depth cut that keeps the whole script near its earlier time)
RES_TIMING_STEPS = 4
#: one checkpoint at 12 layers is ~2.2 GB (f32 params and LAMB's f32 m
#: and v; ~4.0 GB at BERT-Large's 24, less at 6); each part of phase 14 keeps at
#: most two steps plus one staging directory (~6 GB; (b)'s partial
#: debris is smaller than a step) and removes its directory before the
#: next part starts: phase 14 refuses to start below this
RES_DISK_BYTES = 8e9


def _bert_final_state(model, opt):
    """CPU copies of the params, LAMB's m and v (by parameter name) and
    its step count."""
    from apex_tpu_torch.models.convert import optimizer_state

    tree = optimizer_state(opt, model)
    return {"params": {k: p.detach().cpu() for k, p in
                       model.named_parameters()},
            "m": {k: t.cpu() for k, t in tree["m"].items()},
            "v": {k: t.cpu() for k, t in tree["v"].items()},
            "count": tree["count"]}


def _same_state(tag, a, b):
    """Bit-for-bit equality of two :func:`_bert_final_state`s (raises with
    the first leaf that differs)."""
    import torch

    if a["count"] != b["count"]:
        raise AssertionError(f"{tag}: LAMB count {a['count']} != "
                             f"{b['count']}")
    differ = [f"{part} {k} (max |diff| "
              f"{float((t.float() - b[part][k].float()).abs().max()):.3e})"
              for part in ("params", "m", "v") for k, t in a[part].items()
              if not torch.equal(t, b[part][k])]
    if differ:
        raise AssertionError(f"{tag}: {len(differ)} leaves differ: "
                             + "; ".join(differ))


class _Events:
    """run_resilient's observer: every event in order, and the async
    engine's phase records."""

    def __init__(self):
        self.events, self.phases = [], []

    def on_step(self, step, skipped, info):
        self.events.append(("step", step))

    def on_retry(self, what, attempt, error):
        self.events.append(("retry", what, attempt, type(error).__name__))

    def on_resume(self, step):
        self.events.append(("resume", step))

    def on_preempt(self, step):
        self.events.append(("preempt", step))

    def on_rollback(self, *args):
        self.events.append(("rollback",) + args)

    def on_checkpoint(self, step, info=None):
        if info is None:
            self.events.append(("checkpoint", step))
        else:
            self.phases.append(info)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase14():
    """Checkpoint, preemption and resume of ``BertConfig(remat=True)``
    at ``RES_LAYERS`` of its layers (phase 8's configuration otherwise:
    batch 128 x 128, 20 MLM predictions, FusedLAMB) on the card, every
    run compared bit for bit:

    (a) the example: two uninterrupted 8-step runs (they must agree: the
        card's step is reproducible), then ``--steps 4 --ckpt-dir D
        --save-every 2`` (leaves steps 2 and 4) and ``--resume --steps
        8``: it resumes at 4, its losses, params and LAMB m, v and count
        equal the uninterrupted run's, and its K1-K4 launches are 4
        steps' (the counters zeroed before it, read after it);
    (b) ``run_resilient`` on the same step with dropout 0.1 (the seeds
        drawn from the RNG tracker's generator), fed by a
        ``ResumableStream`` over the example's MLM batches (keyed by
        step, prefetched onto the card), the async engine saving every 2
        steps under ``RES_SPEC``: the first call is preempted after step
        5 with a final checkpoint at 5, the partial save's debris on disk
        and invisible; the second call resumes at 5 and runs to 8, and
        its weights, LAMB state and generator state equal an
        uninterrupted dropout run's; the events are the schedule's (a
        retry at each faulted save, the preemption, the resume), the
        stream reseeked once (back to 0 after the reference run; the
        resume continues it), the SIGTERM handler is restored;
    (c) the costs: checkpoint bytes, the step path's ms per save
        (snapshot + enqueue), the background write's ms, the restore's
        ms, the engine's stall fraction, and the median step with a save
        every 2 steps beside the same loop without saving."""
    import shutil
    import signal
    import tempfile

    import torch

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.examples import pretrain_bert
    from apex_tpu_torch.goodput import AsyncCheckpointEngine, ResumableStream
    from apex_tpu_torch.models import BertForPreTraining
    from apex_tpu_torch.models.convert import (
        load_optimizer_state,
        optimizer_state,
    )
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.resilience import chaos, run_resilient
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        model_parallel_tpu_manual_seed,
    )

    root = tempfile.mkdtemp(prefix="apex_tpu_torch_phase14_")
    free = shutil.disk_usage(root).free
    log(f"phase 14: checkpoint, preemption and resume of BertConfig(remat="
        f"True) at {RES_LAYERS} layers, batch {BERT_BATCH}, seq {BERT_SEQ}; "
        f"{free / 1e9:.1f} GB free under {root}")
    if free < RES_DISK_BYTES:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"phase 14 needs {RES_DISK_BYTES / 1e9:.0f} GB "
                             f"of disk under {root}, {free / 1e9:.1f} free")
    base = ["--steps", str(RES_STEPS), "--batch", str(BERT_BATCH),
            "--seq-len", str(BERT_SEQ), "--num-layers", str(RES_LAYERS)]
    out = {}
    try:
        # (a) the example
        full = []
        for _ in range(2):
            run = pretrain_bert.train(pretrain_bert.parse_args(base))
            run.close()
            torch.cuda.synchronize()
            full.append((run.losses, _bert_final_state(run.model,
                                                       run.optimizer)))
            layers = run.cfg.num_layers
            del run
            torch.cuda.empty_cache()
        if full[0][0] != full[1][0]:
            raise AssertionError(f"phase 14: two uninterrupted runs differ: "
                                 f"{full[0][0]} != {full[1][0]}")
        _same_state("phase 14: two uninterrupted runs", full[0][1], full[1][1])
        log(f"  two uninterrupted 8-step runs agree bit for bit (losses "
            f"{[round(x, 4) for x in full[0][0]]})")
        d = os.path.join(root, "example")
        args = pretrain_bert.parse_args(
            base[:1] + ["4"] + base[2:] + ["--ckpt-dir", d, "--save-every",
                                           str(RES_SAVE_EVERY)])
        t0 = time.perf_counter()
        run = pretrain_bert.train(args)
        run.close()
        first_s = time.perf_counter() - t0
        first_steps = run.checkpoints
        if first_steps != [2, 4] or run.losses != full[0][0][:4]:
            raise AssertionError(f"phase 14: the 4-step run left "
                                 f"{first_steps}, losses {run.losses}")
        del run
        torch.cuda.empty_cache()
        _dispatch.reset_launches()
        _dispatch.clear_paths()
        t0 = time.perf_counter()
        run = pretrain_bert.train(pretrain_bert.parse_args(
            base + ["--ckpt-dir", d, "--resume", "--save-every",
                    str(RES_SAVE_EVERY)]))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        run.close()
        launches = _check_launches("phase 14 resumed example", 4, layers)
        if run.resumed_from != 4 or run.losses != full[0][0][4:]:
            raise AssertionError(
                f"phase 14: resumed from {run.resumed_from}, losses "
                f"{run.losses} against {full[0][0][4:]}")
        _same_state("phase 14: the resumed example", _bert_final_state(
            run.model, run.optimizer), full[0][1])
        log(f"  example: --steps 4 --save-every 2 left {first_steps} "
            f"after a 4-step run ({first_s:.1f} s with its 3 saves); "
            f"--resume at 4 to 8 ({resume_s:.1f} s with a restore and 2 "
            f"saves): losses, params, LAMB m, v and count equal the "
            f"uninterrupted run's bit for bit")
        out["example"] = {"resumed_from": run.resumed_from,
                          "losses_resumed": run.losses,
                          "checkpoints": run.checkpoints,
                          "first_run_s": first_s, "resumed_run_s": resume_s,
                          "bit_identical": True}
        cfg, margs = run.cfg, pretrain_bert.parse_args(base)
        del run, full
        torch.cuda.empty_cache()
        shutil.rmtree(d, ignore_errors=True)

        # (b) run_resilient with dropout under the chaos drill
        stream = ResumableStream(pretrain_bert.MLMBatches(margs, cfg),
                                 prefetch=2, device="cuda")

        def fresh():
            model = BertForPreTraining(cfg, device="cuda")
            opt = FusedLAMB(model.parameters(), lr=margs.lr,
                            weight_decay=0.01)
            tracker = model_parallel_tpu_manual_seed(RES_SEED)
            return model, opt, tracker

        def stepper(model, opt, tracker):
            def state():
                return {"params": {k: p.detach() for k, p in
                                   model.named_parameters()},
                        "opt_state": optimizer_state(opt, model),
                        "rng": tracker.get_states()}

            def step_fn(st, batch):
                tracker.set_states(st["rng"])
                load_optimizer_state(opt, model, st["opt_state"])
                loss = pretrain_bert.train_step(model, opt, batch,
                                                generator=tracker.fork())
                return state(), {"skipped": False, "loss": loss}

            return state, step_fn

        model, opt, tracker = fresh()
        state, step_fn = stepper(model, opt, tracker)
        st = state()
        _dispatch.reset_launches()
        _dispatch.clear_paths()
        for step in range(RES_STEPS):
            st, _ = step_fn(st, stream(step))
        torch.cuda.synchronize()
        _check_launches("phase 14 dropout reference", RES_STEPS, layers)
        ref = _bert_final_state(model, opt)
        ref_rng = tracker.get_states()
        del model, opt, st
        torch.cuda.empty_cache()
        d = os.path.join(root, "resilient")
        handler = signal.getsignal(signal.SIGTERM)
        calls = []
        faults = chaos.parse_spec(RES_SPEC)[0]
        for call in range(2):
            model, opt, tracker = fresh()  # a relaunch: fresh weights
            state, step_fn = stepper(model, opt, tracker)
            rec = _Events()
            _dispatch.reset_launches()
            _dispatch.clear_paths()
            t0 = time.perf_counter()
            with chaos.inject(*faults):
                res = run_resilient(step_fn, state(), stream,
                                    directory=d, num_steps=RES_STEPS,
                                    save_interval_steps=RES_SAVE_EVERY,
                                    max_to_keep=2, observer=rec)
            torch.cuda.synchronize()
            # call 1 runs steps 0-5, call 2 steps 6 and 7 (checked below)
            _check_launches(f"phase 14 run_resilient call {call + 1}",
                            res.steps_run, layers)
            calls.append((res, rec, time.perf_counter() - t0,
                          ckpt.all_steps(d), sorted(os.listdir(d))))
            if call == 0:
                del model, opt, state, step_fn, res
                torch.cuda.empty_cache()
        if signal.getsignal(signal.SIGTERM) != handler:
            raise AssertionError("phase 14: the SIGTERM handler was not "
                                 "restored")
        (r1, e1, s1, steps1, ls1), (r2, e2, s2, steps2, _) = calls
        debris = [n for n in ls1 if n.startswith("4.orbax-checkpoint-tmp-")]
        log(f"  run_resilient call 1: {tuple(r1[1:])} in {s1:.1f} s, steps "
            f"on disk {steps1}, directory {ls1}")
        log(f"  run_resilient call 2: {tuple(r2[1:])} in {s2:.1f} s, steps "
            f"on disk {steps2}")
        if not (r1.preempted and r1.last_step == 5 and steps1[-1:] == [5]):
            raise AssertionError(f"phase 14: call 1 {tuple(r1[1:])}, steps "
                                 f"{steps1}")
        if not debris or steps1 != [4, 5]:
            raise AssertionError(f"phase 14: the partial save's debris: "
                                 f"{ls1}, complete steps {steps1}")
        if not (r1.steps_run == 6 and r2.resumed_from == 5
                and r2.last_step == RES_STEPS - 1 and r2.steps_run == 2
                and not r2.preempted):
            raise AssertionError(f"phase 14: call 2 {tuple(r2[1:])}")
        retries = [e for e in e1.events if e[0] == "retry"]
        want_retries = [("retry", f"checkpoint save (step {s})", 0,
                         "InjectedFault") for s in (2, 4)]
        marks = ([e for e in e1.events if e[0] in ("preempt", "resume")],
                 [e for e in e2.events if e[0] in ("preempt", "resume",
                                                   "retry")])
        if retries != want_retries or marks != ([("preempt", 5)],
                                                [("resume", 5)]):
            raise AssertionError(f"phase 14: events {e1.events} / "
                                 f"{e2.events}")
        if stream.seeks != 1:
            raise AssertionError(f"phase 14: {stream.seeks} stream seeks")
        _same_state("phase 14: run_resilient after the drill",
                    _bert_final_state(model, opt), ref)
        if any(not torch.equal(tracker.get_states()[k], ref_rng[k])
               for k in ref_rng):
            raise AssertionError("phase 14: the generator's state differs")
        log(f"  run_resilient: preempted at 5 (debris {debris} invisible, "
            f"latest {steps1[-1]}), resumed at 5 to 8; weights, LAMB state "
            f"and generator state equal the uninterrupted dropout run's bit "
            f"for bit; events {retries + marks[0] + marks[1]}; stream seeks "
            f"{stream.seeks}; SIGTERM handler restored")
        writes = [p for p in e1.phases + e2.phases if p["phase"] == "write"]
        out["run_resilient"] = {
            "call1": list(r1[1:]), "call2": list(r2[1:]),
            "steps_on_disk": [steps1, steps2], "debris": debris,
            "retries": len(retries), "stream_seeks": stream.seeks,
            "write_ms": [(p["t1"] - p["t0"]) * 1e3 for p in writes],
            "call_seconds": [s1, s2], "bit_identical": True}
        shutil.rmtree(d, ignore_errors=True)

        # (c) the costs, with a save every 2 steps and without saving
        state, step_fn = stepper(model, opt, tracker)
        tmpl = state()
        d = os.path.join(root, "timing")
        batches = [stream(RES_STEPS + i) for i in range(RES_TIMING_STEPS)]
        stream.close()
        per_mode = {}
        for mode in ("save every 2", "no save"):
            eng = (AsyncCheckpointEngine(d, max_to_keep=2,
                                         save_interval_steps=RES_SAVE_EVERY)
                   if mode == "save every 2" else None)
            secs = []
            st = state()
            if eng is not None:
                # the pinned slots (queue depth + 1) allocated at set-up
                eng.reserve(st)
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, info = step_fn(st, batch)
                float(info["loss"])
                if eng is not None:
                    eng.save(i, st)
                secs.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            per_mode[mode] = secs
            if eng is not None:
                stall = eng.stall_fraction()
                t0 = time.perf_counter()
                eng.wait_until_finished()
                drain_s = time.perf_counter() - t0
                stats = eng.stats()
                # one more save with the writer idle, into a slot an
                # earlier save used: the step path's cost at a cadence
                # the disk keeps up with (saves further apart than a
                # write); its checkpoint is restored and checked below
                t0 = time.perf_counter()
                eng.save(RES_TIMING_STEPS, st, force=True)
                idle_save_ms = (time.perf_counter() - t0) * 1e3
                saved = _bert_final_state(model, opt)
                eng.wait_until_finished()
                eng.close()
                if stats["pinned_slots"] != eng._max_slots:
                    raise AssertionError(f"phase 14: {stats['pinned_slots']}"
                                         f" pinned slots, not "
                                         f"{eng._max_slots}")
        last = ckpt.latest_step(d)
        nbytes = _dir_bytes(os.path.join(d, str(last)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ckpt.restore_step_dir(d, last, template=tmpl)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if last != RES_TIMING_STEPS:
            raise AssertionError(f"phase 14: latest step {last}")
        back = _bert_final_state(model, opt)
        back["count"] = int(got["opt_state"]["count"])
        _same_state("phase 14: the idle save (a reused pinned slot), "
                    "restored", back, saved)
        del got, back, saved
        saves = stats["saves"]
        costs = {
            "checkpoint_bytes": nbytes,
            "step_path_ms_per_save": (stats["snapshot_ms_total"]
                                      + stats["enqueue_wait_ms_total"])
            / saves,
            "snapshot_ms_per_save": stats["snapshot_ms_total"] / saves,
            "enqueue_wait_ms_per_save": stats["enqueue_wait_ms_total"]
            / saves,
            "write_ms_per_save": stats["write_ms_total"] / stats["writes"],
            "write_gb_per_s": nbytes / (stats["write_ms_total"]
                                        / stats["writes"]) / 1e6,
            "restore_ms": restore_ms,
            "stall_fraction": stall,
            "drain_after_loop_s": drain_s,
            "pinned_slots": stats["pinned_slots"],
            "reserve_ms": stats["reserve_ms_total"],
            "step_path_ms_idle_writer_save": idle_save_ms,
            "saves": saves, "failures": stats["failures"],
            "step_ms_median_saving": statistics.median(
                per_mode["save every 2"][1:]) * 1e3,
            "step_ms_median_no_save": statistics.median(
                per_mode["no save"][1:]) * 1e3,
            "step_ms_mean_saving": statistics.mean(
                per_mode["save every 2"][1:]) * 1e3,
            "step_ms_mean_no_save": statistics.mean(
                per_mode["no save"][1:]) * 1e3,
            "step_ms_saving": [x * 1e3 for x in per_mode["save every 2"]],
            "step_ms_no_save": [x * 1e3 for x in per_mode["no save"]],
        }
        log(f"  pinned pool: {stats['pinned_slots']:.0f} slots reserved in "
            f"{stats['reserve_ms_total']:.0f} ms; the idle save's slot "
            f"restored bit for bit")
        log(f"  costs: checkpoint {nbytes / 1e9:.3f} GB; step path "
            f"{costs['step_path_ms_per_save']:.1f} ms a save (snapshot "
            f"{costs['snapshot_ms_per_save']:.1f} + enqueue "
            f"{costs['enqueue_wait_ms_per_save']:.1f}; {idle_save_ms:.1f} "
            f"with the writer idle); background write "
            f"{costs['write_ms_per_save']:.0f} ms "
            f"({costs['write_gb_per_s']:.2f} GB/s); restore "
            f"{restore_ms:.0f} ms; stall fraction {stall:.4f}; median step "
            f"{costs['step_ms_median_saving']:.1f} ms saving every 2 steps, "
            f"{costs['step_ms_median_no_save']:.1f} ms without (means "
            f"{costs['step_ms_mean_saving']:.1f} / "
            f"{costs['step_ms_mean_no_save']:.1f})")
        out["costs"] = costs
        del model, opt, tmpl, state, step_fn, batches
        torch.cuda.empty_cache()
        return {"bert_resume": launches}, out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: evoformer training at AlphaFold2's widths
# ---------------------------------------------------------------------------


#: EvoformerBlock(msa_dim=256, pair_dim=128, heads=4, mlp_ratio=4,
#: opm_hidden=32): OpenFold's evoformer_stack widths (c_m 256, c_z 128,
#: c_hidden_mul 128, c_hidden_opm 32, 4 triangle heads of 32,
#: transition_n 4); 4 of its 48 blocks, at the initial-training crop
#: (N_res 256, N_seq 128, ``EVO_RES``/``EVO_SEQ``)
EVO = dict(msa_dim=256, pair_dim=128, heads=EVO_HEADS, mlp_ratio=4,
           opm_hidden=32)
EVO_BLOCKS = 4
EVO_STEPS = 8
EVO_LR = 3e-4
#: per block and step: LayerNorm 12 times (MSA row attention 2, column
#: attention, MSA transition, outer product mean, 2 per triangle update,
#: 1 per triangle attention, pair transition), attention 4 times (MSA
#: row, MSA column, triangle start, triangle end), a trainable bias 3
#: times (all but the column attention): those three backwards take the
#: fused call (G = BH, RS = Sq), the column attention the plain K4, and
#: the standalone K5 launches no time
EVO_BLOCK_LAUNCHES = {"layer_norm_fwd": 12, "layer_norm_bwd": 12,
                      "flash_fwd": 4, "flash_bwd": 1, "flash_bwd_dbias": 3,
                      "flash_dbias": 0}


def evoformer_block_flops(n_seq, n_res, msa_dim, pair_dim, heads, mlp_ratio,
                          opm_hidden):
    """Matrix-product flops of one EvoformerBlock forward (2 per
    multiply-add; the triangle updates' hidden width is pair_dim):
    MSA row and column attention (q, k, v, gate, out projections, the
    pair-bias projection, QK^T and PV), the MSA transition, the outer
    product mean (a, b, the outer product, out), two triangle
    multiplicative updates (a, a_gate, b, b_gate, the contraction, out,
    gate), two triangle attentions and the pair transition."""
    s, r, cm, cz, h = n_seq, n_res, msa_dim, pair_dim, heads
    msa_rows = s * r
    pair_rows = r * r
    f = 0
    f += 5 * 2 * msa_rows * cm * cm + 2 * pair_rows * cz * h   # row proj
    f += 4 * s * r * r * cm                                   # row attention
    f += 5 * 2 * msa_rows * cm * cm + 4 * r * s * s * cm      # column
    f += 2 * 2 * msa_rows * cm * mlp_ratio * cm               # transition
    f += 2 * 2 * msa_rows * cm * opm_hidden                   # OPM a, b
    f += 2 * s * pair_rows * opm_hidden ** 2                  # outer product
    f += 2 * pair_rows * opm_hidden ** 2 * cz                 # OPM out
    tri_mul = 4 * 2 * pair_rows * cz * cz + 2 * r ** 3 * cz + 2 * 2 * pair_rows * cz * cz
    f += 2 * tri_mul
    tri_att = 5 * 2 * pair_rows * cz * cz + 2 * pair_rows * cz * h + 4 * r ** 3 * cz
    f += 2 * tri_att
    f += 2 * 2 * pair_rows * cz * mlp_ratio * cz              # transition
    return f


def randomize_zero_params(module, generator, std=0.02):
    """Every parameter that is exactly zero at init (the out/down and gate
    kernels, the biases, the LayerNorm biases) gets N(0, std^2) from
    ``generator``, as the JAX tests' ``_randomize`` breaks the zero init:
    otherwise the output is the input and every gradient through the
    attention, dbias included, is zero."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if not bool(p.any()):
                p.copy_(std * torch.randn(p.shape, generator=generator,
                                          device=generator.device))


def evoformer_stack(n_blocks, device, generator, dtype):
    import torch

    from apex_tpu_torch.contrib.openfold import EvoformerBlock

    blocks = torch.nn.ModuleList(
        EvoformerBlock(**EVO, dtype=dtype, device=device, generator=generator)
        for _ in range(n_blocks))
    randomize_zero_params(blocks, generator)
    return blocks


def evoformer_data(n_seq, n_res, device, seed):
    """Seeded MSA and pair inputs and MSE targets (numpy, then
    ``device``): m (n_seq, n_res, 256), z (n_res, n_res, 128)."""
    import torch

    rs = np.random.RandomState(seed)
    shapes = ((n_seq, n_res, EVO["msa_dim"]), (n_res, n_res, EVO["pair_dim"]))
    m, z, tm, tz = (torch.from_numpy(rs.randn(*shp).astype(np.float32))
                    .to(device) for shp in shapes * 2)
    return m, z, tm, tz


def evoformer_loss(blocks, m, z, tm, tz):
    for blk in blocks:
        m, z = blk(m, z)
    return (m - tm).pow(2).mean() + (z - tz).pow(2).mean()


def profiled_step(step, step_s):
    """One ``step()`` under ``torch.profiler``: its host time, the device
    kernels' time by layer (``KERNEL_GROUPS``) and the top kernels, and
    the kernels' share of the unprofiled median step ``step_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(device_kernels(prof), key=lambda o: -o[1])
    busy_ms = sum(o[1] for o in ops) / 1e3
    groups = group_kernels(ops)
    log(f"  profiled step: {wall * 1e3:.1f} ms host, {busy_ms:.1f} ms of "
        f"device kernels ({busy_ms / (wall * 1e3):.3f} busy; "
        f"{busy_ms / (step_s * 1e3):.3f} of the unprofiled median step), "
        f"{sum(o[2] for o in ops)} kernel launches")
    log("  device ms by layer: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    top = []
    for key, us, count in ops[:15]:
        log(f"    {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")
        top.append({"op": key[:100], "ms": us / 1e3, "count": count})
    return {
        "device_busy_share_unprofiled": busy_ms / (step_s * 1e3),
        "profiled_step_ms": wall * 1e3,
        "profiled_device_ms": busy_ms,
        "device_ms_by_layer": groups,
        "top_device_ops": top,
    }


def phase10(check_launches=True):
    """4 full-width ``EvoformerBlock``s chained (the JAX package has no
    stack module, so the script chains them) at N_seq 128, N_res 256,
    bf16 attention on f32 weights, the zero-initialised parameters
    randomized, MSE to seeded targets, FusedAdam at lr 3e-4 for 8 steps.
    The launch counters are zeroed before and read after: K1-K5 must
    have launched exactly ``EVO_BLOCK_LAUNCHES`` x blocks x steps (the
    fused K4 + K5 call included; ``check_launches=False`` only logs them,
    for ``--evoformer`` on an older tree), and every op must have taken
    the kernel path.  Losses finite and falling; step time, the analytic
    MFU, peak memory, then one profiled step by layer."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam

    log(f"phase 10: train {EVO_BLOCKS} EvoformerBlock({EVO}) at N_seq "
        f"{EVO_SEQ}, N_res {EVO_RES}, {EVO_STEPS} FusedAdam steps")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(21)
    blocks = evoformer_stack(EVO_BLOCKS, "cuda", gen, torch.bfloat16)
    m, z, tm, tz = evoformer_data(EVO_SEQ, EVO_RES, "cuda", seed=22)
    opt = FusedAdam(blocks.parameters(), lr=EVO_LR)

    def step():
        loss = evoformer_loss(blocks, m, z, tm, tz)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    losses, seconds = [], []
    for _ in range(EVO_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * EVO_BLOCKS * EVO_STEPS
            for k, n in EVO_BLOCK_LAUNCHES.items() if n}
    log(f"  launches={launches} (per block and step {EVO_BLOCK_LAUNCHES}) "
        f"paths={paths}")
    if check_launches and launches != want:
        raise AssertionError(f"evoformer launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"evoformer op paths {paths}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    n_params = sum(p.numel() for p in blocks.parameters())
    flops = 3 * EVO_BLOCKS * evoformer_block_flops(EVO_SEQ, EVO_RES, **EVO)
    step_s = statistics.median(seconds[1:])
    mfu = flops / step_s / BF16_TENSOR_FLOPS
    log(f"  losses {[round(x, 5) for x in losses]}")
    log(f"  step seconds {[round(x, 4) for x in seconds]}; median of steps "
        f"1.. {step_s * 1e3:.1f} ms; MFU {mfu:.4f} = 3 x {EVO_BLOCKS} x "
        f"{flops / 3 / EVO_BLOCKS / 1e9:.1f} GFLOP (one block's forward "
        f"matrix products, evoformer_block_flops; backward counted 2x) / "
        f"step time / 989 TFLOP/s; N={n_params}; peak memory "
        f"{peak / 1e9:.2f} GB")

    out = {
        "losses": losses,
        "step_seconds": seconds,
        "step_ms_median": step_s * 1e3,
        "params": n_params,
        "flops_per_step": flops,
        "mfu": mfu,
        "peak_memory_bytes": peak,
        **profiled_step(step, step_s),
    }
    del blocks, opt, m, z, tm, tz
    torch.cuda.empty_cache()
    return launches, out


#: phase 10's second run: the same blocks with f32 attention (the JAX
#: module's precision), through the f32 instances of K3, K4 and K5; 4
#: blocks and 8 steps, as the bf16 run
EVO_F32_BLOCKS = 4
EVO_F32_STEPS = 8
EVO_F32_BLOCK_LAUNCHES = {"layer_norm_fwd": 12, "layer_norm_bwd": 12,
                          "flash_fwd_f32": 4, "flash_bwd_f32": 4,
                          "flash_dbias_f32": 3}


def phase10_f32():
    """``EVO_F32_BLOCKS`` full-width ``EvoformerBlock`` with f32 attention
    (``dtype=torch.float32``: q, k and v reach the kernels in f32, as the
    JAX module computes them) at the same crop, FusedAdam, ``EVO_F32_STEPS``
    steps, with the launch counters zeroed before and read after: K1, K2
    and the f32 instances of K3, K4 and K5 must have launched exactly
    ``EVO_F32_BLOCK_LAUNCHES`` x blocks x steps, every op on the kernel
    path; losses finite and falling; the median step time, then one
    profiled step by layer."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam

    log(f"phase 10: train {EVO_F32_BLOCKS} EvoformerBlock({EVO}) with f32 "
        f"attention at N_seq {EVO_SEQ}, N_res {EVO_RES}, {EVO_F32_STEPS} "
        f"FusedAdam steps")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(23)
    blocks = evoformer_stack(EVO_F32_BLOCKS, "cuda", gen, torch.float32)
    m, z, tm, tz = evoformer_data(EVO_SEQ, EVO_RES, "cuda", seed=24)
    opt = FusedAdam(blocks.parameters(), lr=EVO_LR)

    def step():
        loss = evoformer_loss(blocks, m, z, tm, tz)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    torch.cuda.synchronize()
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    losses, seconds = [], []
    for _ in range(EVO_F32_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _dispatch.launches()
    paths = _dispatch.last_paths()
    want = {k: n * EVO_F32_BLOCKS * EVO_F32_STEPS
            for k, n in EVO_F32_BLOCK_LAUNCHES.items()}
    log(f"  launches={launches} (per block and step "
        f"{EVO_F32_BLOCK_LAUNCHES}) paths={paths}")
    if launches != want:
        raise AssertionError(f"f32 evoformer launches {launches} != {want}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        raise AssertionError(f"f32 evoformer op paths {paths}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_s = statistics.median(seconds[1:])
    log(f"  losses {[round(x, 5) for x in losses]}; step seconds "
        f"{[round(x, 4) for x in seconds]}; median of steps 1.. "
        f"{step_s * 1e3:.1f} ms")
    out = {"losses": losses, "step_seconds": seconds,
           "step_ms_median": step_s * 1e3, "blocks": EVO_F32_BLOCKS,
           **profiled_step(step, step_s)}
    k5_ms = out["device_ms_by_layer"]["K5 flash_dbias_f32"]
    out["k5_f32_share_of_device"] = k5_ms / out["profiled_device_ms"]
    log(f"  K5 flash_dbias_f32: {k5_ms:.2f} ms of the profiled step's "
        f"{out['profiled_device_ms']:.1f} ms of kernels "
        f"({out['k5_f32_share_of_device']:.3f})")
    del blocks, opt, m, z, tm, tz
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 11: one evoformer training step, card bf16 against CPU f32
# ---------------------------------------------------------------------------


EVO_CROSS_RES, EVO_CROSS_SEQ = 64, 32
#: The phase-11 limits, one per reading of the card's step against the
#: CPU's.  Each sits between the card's sound reading and that of a
#: planted fault (``EVO_FAULTS``) which the phase runs each time as a CPU
#: f32 step against the sound CPU f32 step.
EVO_LIMITS = {
    # |loss(card bf16) - loss(CPU f32)|; the loss is ~4.4, where one f32
    # step is 4.8e-7
    "loss_diff": 2e-5,
    # the worst parameter's ||grad_card - grad_cpu|| / ||grad_cpu||
    "max_grad_rel_err": 5e-2,
    # the worst parameter's mean |update_card - update_cpu| after one
    # FusedAdam step.  Adam's first step moves each weight by about lr
    # whatever the gradient's scale, so this reading sees the optimizer
    # and not a gradient scaled by a constant: only the gradient limit
    # sees a halved dbias
    "max_mean_update_diff": 1e-5,
    # |grad EVO_ZERO_GRAD| / |grad EVO_BIAS_KERNELS[0]|, the larger side
    "zero_grad_norm_ratio": 1e-3,
}
#: each planted fault and the reading it must push past its limit
EVO_FAULTS = {
    "K3 twin's output x 0.99": "loss_diff",
    "K5 twin's dbias x 0.5": "max_grad_rel_err",
    "K5 twin's dbias without delta": "zero_grad_norm_ratio",
    "FusedAdam lr x 1.1": "max_mean_update_diff",
}
#: a parameter whose gradient is zero in exact arithmetic: MSA row
#: attention's ``ln_z`` feeds only the pair-bias projection, so its bias
#: adds one value per head to every score, which the softmax ignores.
#: Both runs read round-off there (an H100 read a relative difference of
#: 6.3e3 and Adam's first step turns round-off into ±lr), so it is held
#: to a bound on its norm instead (``zero_grad_norm_ratio``): a dbias
#: whose rows do not sum to zero, as without delta, moves it
EVO_ZERO_GRAD = "msa_row_att.ln_z_bias"
#: the parameters K5's gradient feeds
EVO_BIAS_KERNELS = ("msa_row_att.pair_bias.weight",
                    "pair_block.tri_att_start.tri_bias.weight",
                    "pair_block.tri_att_end.tri_bias.weight")


def evoformer_cross_step(device, fault=None):
    """One MSE + FusedAdam step of one full-width EvoformerBlock at N_res
    64, N_seq 32 on ``device`` ("cuda": bf16 attention; "cpu": f32), from
    weights drawn on the CPU (seed 31, zero-initialised parameters
    randomized) and seeded data.  ``fault`` names one of ``EVO_FAULTS``
    to plant (CPU only: it patches the twins or the learning rate).
    Returns (loss, {name: grad}, {name: update}) on the CPU in f32."""
    import torch

    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.optimizers import FusedAdam

    fwd, dbias = attn.flash_fwd_reference, attn.flash_dbias_reference

    def fwd_scaled(*a, **kw):
        o, *rest = fwd(*a, **kw)
        return (0.99 * o, *rest)

    def dbias_without_delta(q, k, v, do, m, l, delta, *a, **kw):
        return dbias(q, k, v, do, m, l, torch.zeros_like(delta), *a, **kw)

    planted = {
        "K3 twin's output x 0.99": ("flash_fwd_reference", fwd_scaled),
        "K5 twin's dbias x 0.5": (
            "flash_dbias_reference", lambda *a, **kw: 0.5 * dbias(*a, **kw)),
        "K5 twin's dbias without delta": ("flash_dbias_reference",
                                          dbias_without_delta),
    }
    lr = EVO_LR * (1.1 if fault == "FusedAdam lr x 1.1" else 1.0)

    cpu = evoformer_stack(1, "cpu", torch.Generator().manual_seed(31),
                          torch.float32)
    if device == "cpu":
        blocks = cpu
    else:
        blocks = evoformer_stack(1, device, torch.Generator().manual_seed(0),
                                 torch.bfloat16)
        blocks.load_state_dict({k: v.to(device)
                                for k, v in cpu.state_dict().items()})
    data = evoformer_data(EVO_CROSS_SEQ, EVO_CROSS_RES, device, seed=32)
    before = {k: p.detach().float().cpu().clone()
              for k, p in blocks.named_parameters()}
    opt = FusedAdam(blocks.parameters(), lr=lr)
    if fault in planted:
        setattr(attn, *planted[fault])
    try:
        loss = evoformer_loss(blocks, *data)
        loss.backward()
    finally:
        attn.flash_fwd_reference, attn.flash_dbias_reference = fwd, dbias
    grads = {k.removeprefix("0."): p.grad.detach().float().cpu()
             for k, p in blocks.named_parameters()}
    opt.step()
    updates = {k.removeprefix("0."): p.detach().float().cpu() - before[k]
               for k, p in blocks.named_parameters()}
    return float(loss.detach()), grads, updates


def evoformer_cross_readings(a, b):
    """The readings of step ``a`` against step ``b``, keyed as
    ``EVO_LIMITS``, plus the worst gradient's parameter and the bias
    kernels' relative gradient errors; ``EVO_ZERO_GRAD`` is left out of
    the gradient and update readings."""
    (la, ga, ua), (lb, gb, ub) = a, b
    keys = [k for k in gb if k != EVO_ZERO_GRAD]
    rel = {k: float((ga[k] - gb[k]).norm() / gb[k].norm().clamp_min(1e-30))
           for k in keys}
    rel = {k: r if np.isfinite(r) else float("inf") for k, r in rel.items()}
    worst = max(rel, key=rel.get)
    zero = max(float(g[EVO_ZERO_GRAD].norm()
                     / g[EVO_BIAS_KERNELS[0]].norm().clamp_min(1e-30))
               for g in (ga, gb))
    return {"loss_diff": abs(la - lb), "max_grad_rel_err": rel[worst],
            "max_mean_update_diff": max(float((ua[k] - ub[k]).abs().mean())
                                        for k in keys),
            "zero_grad_norm_ratio": zero, "worst_param": worst,
            "bias_kernel_grad_rel_err": {k: rel[k] for k in EVO_BIAS_KERNELS}}


def phase11():
    """One EvoformerBlock at full channel widths, N_res 64, N_seq 32: the
    loss, every gradient (the pair-bias and triangle-bias kernels, which
    K5 feeds, named) and the weights after one FusedAdam step on the card
    (bf16 attention, K1-K5) against the CPU (f32, the plain twins), from
    the same weights and data, within ``EVO_LIMITS``; then each planted
    fault of ``EVO_FAULTS`` on the CPU against the sound CPU step, which
    must push its reading past its limit."""
    log(f"phase 11: one full-width EvoformerBlock step at N_res "
        f"{EVO_CROSS_RES}, N_seq {EVO_CROSS_SEQ}, card bf16 against CPU f32")
    card = evoformer_cross_step("cuda")
    cpu = evoformer_cross_step("cpu")
    out = {"loss_card": card[0], "loss_cpu": cpu[0]}
    runs = [("card", card, None)] + [
        (f"planted {fault}", evoformer_cross_step("cpu", fault), key)
        for fault, key in EVO_FAULTS.items()]
    for tag, a, key in runs:
        r = evoformer_cross_readings(a, cpu)
        out[tag] = r
        outside = [k for k, lim in EVO_LIMITS.items() if not r[k] <= lim]
        log(f"  {tag} against CPU f32: loss {a[0]:.6f} vs {cpu[0]:.6f}; "
            + ", ".join(f"{k} {r[k]:.3e} (limit {lim:.0e})"
                        for k, lim in EVO_LIMITS.items())
            + f"; worst gradient {r['worst_param']}; bias kernels "
            + ", ".join(f"{k} {v:.3e}"
                        for k, v in r["bias_kernel_grad_rel_err"].items())
            + f"; outside: {outside or 'none'}")
        if key is None and outside:
            raise AssertionError("phase 11: the card's step disagrees")
        if key is not None and key not in outside:
            raise AssertionError(
                f"phase 11: the {key} limit passes the {tag}")
    return out


def ptxas_summary(text, nvcc):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (demangled by the toolkit's ``cu++filt`` beside ``nvcc``), registers
    and spills."""
    import re

    rows, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (f", spills {m.group(1)}/{m.group(2)} bytes"
                     if m.group(1) != "0" or m.group(2) != "0" else "")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, m.group(1), spill))
            name = None
    names = [r[0] for r in rows]
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if names and os.path.exists(filt):
        res = subprocess.run([filt, *names], capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            # "void ns::name<args>(parameters)" -> "ns::name<args>"
            names = [n.split(">(")[0].removeprefix("void ") + ">"
                     for n in res.stdout.splitlines()]
    return [f"{n}: {r} registers{sp}" for n, (_, r, sp) in zip(names, rows)]


# ---------------------------------------------------------------------------
# phase 16: data and tensor parallelism — workers on one card
# ---------------------------------------------------------------------------

#: phase 16's runs: 4 steps (at 3, 16c's planted fault in BERT's
#: gradient sync moves the losses by less than P16_BERT_LOSS_TOL); 16b
#: and 16c's GPT cut to 2 layers (the width stays GptConfig()'s: hidden
#: 1024, 16 heads, vocab 50304) at phase 6's batch 8 x 2048; BERT-Large
#: whole (24 x 1024) at phase 8's batch 128 x 128
P16_STEPS = 4
P16_GPT_LAYERS = 2
#: every init_process_group's timeout, and a spawn's deadline
P16_GROUP_TIMEOUT_S = 180.0
P16_SPAWN_TIMEOUT_S = 600.0
#: 16b: tp = 2 against tp = 1 on the card, each gradient's max |diff|
#: over the tensor's max |value| (bf16 products; the row-parallel
#: outputs summed as two bf16 partials instead of one product)
P16_TP_GRAD_TOL = 3e-2
#: the planted fault (one RowParallelLinear that skips its reduction)
#: must read more than this many times the limit
P16_FAULT_FACTOR = 10.0
#: 16b: the losses of ``train_gpt --tp 2 --sequence-parallel`` against
#: the same steps at tp = 1, and the one hand-built forward's: each
#: loss's relative difference.  The planted fault's loss must read more.
#: On an H100 (700 W) the sound run reads 1.9e-5 and the fault 1.8e-4
P16_TP_LOSS_TOL = 6e-5
#: 16c's ZeRO f32 run against FusedAdam at dp 1: each loss's relative
#: difference.  The planted fault (the reduce-scatter skipped, each rank
#: stepping on its local gradient) must read more.  On an H100 the sound
#: run reads 3.5e-5 and the fault 2.0e-3
P16_ZERO_LOSS_TOL = 3e-4
#: 16c's ZeRO int8 run against FusedAdam at dp 1 (the wire's rounding);
#: the same planted fault on the int8 wire must read more.  On an H100
#: the sound run reads 8.3e-4 and the fault 1.4e-3: over 4 steps the
#: int8 rounding moves the losses almost as far as the lost half of the
#: batch does, so this margin is thin; the shard probe, against the
#: codec's bound, is the check that reads the fault with room (~5x)
P16_INT8_LOSS_TOL = 1.1e-3
#: 16c BERT-Large dp = 2 against dp = 1 (the mean of the two halves'
#: losses, the reference's per-rank normalization): relative, per step.
#: On an H100 the sound run equals dp = 1 bit for bit; the limit allows
#: the f32 summation-order differences ZeRO's f32 run shows (3.5e-5),
#: and the planted fault (DDP's sync skipped) must read more
P16_BERT_LOSS_TOL = 3e-4
#: 16d SyncBatchNorm: bf16 output and input gradient, and the f32
#: parameter gradients and running statistics, each over its max |value|.
#: On an H100 the sound run reads at most 6.7e-3 (dw) and the planted
#: fault (statistics over one rank's rows) at least 0.115 (dx)
P16_BN_TOL = 2e-2
P16_BN_SHAPE = (32, 64, 56, 56)


def _p16_jobs(rank, world, jobs):
    """A phase-16 worker's body (in a group on card 0 that
    :func:`apex_tpu_torch.tools._ranks.run_ranks` joined): run ``jobs``
    (names of functions here, with kwargs) and return their results as
    JSON would carry them back."""
    import torch

    out = {}
    for name, fn, kwargs in jobs:
        out[name] = globals()[fn](rank, world, **kwargs)
        gc.collect()
        torch.cuda.empty_cache()
    return json.loads(json.dumps(out))


def _start_worker_server():
    """Start the server the worker processes fork from (the
    ``forkserver`` start method), with ``torch`` and numpy imported once
    in it: a fresh interpreter's ``import torch`` took 8.2 s on an H100
    host, in every worker of every spawn.  The server never touches the
    card; each worker takes it itself.  It stops when the script does."""
    import multiprocessing as mp
    from multiprocessing import forkserver

    mp.get_context("forkserver").set_forkserver_preload(["torch", "numpy"])
    forkserver.ensure_running()


def _p16_spawn(world, backend, jobs):
    """Run ``jobs`` (``(name, function name, kwargs)``) on ``world``
    processes sharing card 0 (:func:`apex_tpu_torch.tools._ranks.run_ranks`,
    forked from :func:`_start_worker_server`'s server).  A worker that
    raises, exits non-zero or outlives ``P16_SPAWN_TIMEOUT_S`` fails the
    phase (the others are killed).  Returns each rank's results."""
    import torch

    from apex_tpu_torch.tools._ranks import run_ranks

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        out = run_ranks(world, _p16_jobs, dict(jobs=jobs), backend=backend,
                        timeout_s=P16_SPAWN_TIMEOUT_S,
                        group_timeout_s=P16_GROUP_TIMEOUT_S)
    except RuntimeError as e:
        raise AssertionError(f"phase 16: {e}") from e
    log(f"  {world} worker(s) over {backend}: "
        f"{time.perf_counter() - t0:.1f} s wall")
    return out


def _param_digests(model):
    """sha256 of every parameter's bytes (bit-for-bit comparisons
    across processes)."""
    import hashlib

    return {n: hashlib.sha256(
        p.detach().cpu().contiguous().view(-1).view(
            __import__("torch").uint8).numpy().tobytes()).hexdigest()
        for n, p in model.named_parameters()}


def _timed_steps(step, batches, steps):
    """(losses, step seconds, first step's collective summary)."""
    import torch

    from apex_tpu_torch.parallel import comm

    losses, seconds, summary = [], [], None
    for i in range(steps):
        b = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with comm.collective_log() as rec:
                loss = step(b)
                torch.cuda.synchronize()
            summary = comm.collective_summary(rec)
        else:
            loss = step(b)
        losses.append(float(loss))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, summary


def _gpt_args(extra, layers=None, steps=P16_STEPS):
    from apex_tpu_torch.examples import train_gpt

    argv = ["--steps", str(steps), "--batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), *extra]
    if layers is not None:
        argv += ["--num-layers", str(layers)]
    return train_gpt.parse_args(argv)


def p16_world1(rank, world):
    """16a worker: ``examples.train_gpt`` at phase 6's configuration, 4
    steps, in a world of 1 over NCCL (DDP on the f32 wire and
    parallel_state at tp = 1: every sync the identity)."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.ops import _dispatch

    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    run = train_gpt.train(_gpt_args(["--backend", "nccl"]))
    torch.cuda.synchronize()
    return dict(losses=run.losses, step_seconds=run.step_seconds,
                launches=_dispatch.launches(),
                digests=_param_digests(run.model),
                peak=torch.cuda.max_memory_allocated(),
                backend=torch.distributed.get_backend(),
                world=torch.distributed.get_world_size(),
                ddp=run.ddp is not None)


def _gather_full(model, name, t):
    """Parameter ``name``'s tensor ``t`` gathered over tp to its full
    shape (the replicated parameters as they are)."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        VocabParallelEmbedding,
        _TPLinear,
    )

    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name)
    dim = None
    if isinstance(mod, VocabParallelEmbedding):
        dim = 0
    elif isinstance(mod, _TPLinear):
        dim = mod.shard_dim if leaf == "weight" else (
            0 if mod.shard_dim == 0 else None)
    tp = ps.get_tensor_model_parallel_world_size()
    if dim is None or tp == 1:
        return t
    out = t.new_empty((tp,) + tuple(t.shape))
    comm.all_gather_into(out.view(-1), t.contiguous().view(-1),
                         ps.get_tensor_model_parallel_group())
    return torch.cat(out.unbind(0), dim=dim)


def _rel_errs(model, grads, ref):
    """Per parameter: max |full(grad) - ref| / max |ref|."""
    out = {}
    for n, g in grads.items():
        full = _gather_full(model, n, g).float()
        r = ref[n].float()
        out[n] = float((full - r).abs().max() / r.abs().max().clamp_min(1e-30))
    return out


def p16_tp(rank, world, layers, steps):
    """16b worker at GptConfig()'s width, ``layers`` layers, remat, phase
    6's batch.  The gradients, on a model built here: tp = 1 first (no
    model-parallel group), one forward and backward, then tp = 2 with
    sequence parallelism from the same seeded full weights, each gradient
    gathered over tp against tp = 1's; then the planted fault.  The
    training run goes through ``examples.train_gpt --tp 2
    --sequence-parallel`` (``build`` and ``train_step``: the tp and dp
    groups, this dp rank's columns, DDP at dp 1, the sequence-parallel
    gradient sum): ``steps`` steps after the batch the ZeRO workers probe
    on, so that its losses line up with phase 16's dp = 1 run, the
    launches counted around those steps."""
    import dataclasses as dc

    import torch
    import torch.nn.functional as F

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models.gpt import GptConfig, GptModel, gpt_lm_loss
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.transformer.tensor_parallel import (
        allreduce_sequence_parallel_gradients,
        mappings,
    )

    dev = torch.device("cuda", 0)
    cfg = GptConfig(num_layers=layers, remat=True, max_seq_len=TRAIN_SEQ)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_SEQ, TRAIN_BATCH),
                        generator=torch.Generator().manual_seed(5)).to(dev)

    def grads_of(model):
        loss = gpt_lm_loss(model, ids)
        loss.backward()
        if model.cfg.sequence_parallel:
            allreduce_sequence_parallel_gradients(model)
        return float(loss.detach()), {n: p.grad.detach().clone()
                                      for n, p in model.named_parameters()}

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    ps.destroy_model_parallel()
    dense = GptModel(cfg, device=dev, generator=seeded())
    loss1, ref = grads_of(dense)
    del dense
    gc.collect()
    torch.cuda.empty_cache()

    ps.initialize_model_parallel(2)
    try:
        cfg2 = dc.replace(cfg, sequence_parallel=True)
        model = GptModel(cfg2, device=dev, generator=seeded())
        loss2, grads = grads_of(model)
        errs = _rel_errs(model, grads, ref)
        del model, grads
        gc.collect()
        torch.cuda.empty_cache()

        # the planted fault: layer 0's out projection skips its sum
        bad = GptModel(cfg2, device=dev, generator=seeded())
        lin = bad.layers[0].out

        def skip_reduce(x, name=None):
            y = F.linear(x.to(lin.compute_dtype), lin.weight.to(
                lin.compute_dtype))
            return mappings._split_along_first_dim(y) + lin.bias.to(
                lin.compute_dtype)

        lin.forward = skip_reduce
        loss_bad, bad_grads = grads_of(bad)
        fault = _rel_errs(bad, bad_grads, ref)
        del bad, bad_grads
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ps.destroy_model_parallel()

    args = _gpt_args(["--tp", "2", "--sequence-parallel", "--backend",
                      "gloo"], layers=layers, steps=steps)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, model, opt, batches, ddp = train_gpt.build(args)
        next(batches)  # the ZeRO workers' probe batch
        _dispatch.reset_launches()
        losses, seconds, summary = _timed_steps(
            lambda b: train_gpt.train_step(model, opt, b, ddp), batches,
            steps)
        launches = _dispatch.launches()
        mesh = ps.get_mesh().shape
    finally:
        ps.destroy_model_parallel()
    return dict(loss_tp1=loss1, loss_tp2=loss2, loss_fault=loss_bad,
                grad_rel_errs=errs, fault_rel_errs=fault, losses=losses,
                seconds=seconds, launches=launches, mesh=dict(mesh),
                sp=model.cfg.sequence_parallel, ddp=ddp is not None,
                peak=torch.cuda.max_memory_allocated(), collectives=summary)


def _p16_probe_shard(model, opt, ids, world):
    """One backward on ``ids``: this rank's reduce-scattered shard (on
    the optimizer's wire) against the exact (f32) one, and the int8
    codec's bound (0.5 (world + 1) + 0.5) / 127 of the largest gradient
    before the reduction, averaged over the world (the quantized tests'
    statement); on the f32 wire the two are the same reduction."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models.gpt import gpt_lm_loss
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.parallel.distributed_fused_optimizers import (
        _flatten_pad,
    )

    gpt_lm_loss(model, ids).backward()
    flat = _flatten_pad([p.grad for p in model.parameters()], opt.spec)
    gmax = flat.abs().max().reshape(1)
    comm.all_reduce(gmax, ps.get_data_parallel_group(), op="max")
    exact = comm.reduce_scatter_flat(flat, wire="f32") / world
    got = opt.reduce_scatter_grads()
    opt.zero_grad()
    err = float((got - exact).abs().max())
    bound = float((0.5 * (world + 1) + 0.5) / 127.0 * gmax / world)
    return err, bound


def p16_zero(rank, world, layers, steps, wire, fault=False):
    """16c worker: ``examples.train_gpt --zero`` (DistributedFusedAdam)
    at ``layers`` layers over dp = world on ``wire``: the shard probe on
    the first batch, then ``steps`` steps; the first step's call log and
    the optimizer's plan.  ``fault`` plants the fault the checks exist to
    catch: the reduce-scatter skipped, each rank updating its shard from
    its own local gradient."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.parallel.distributed_fused_optimizers import (
        _flatten_pad,
    )

    args = _gpt_args(["--zero", "--wire", wire, "--backend", "gloo"],
                     layers=layers, steps=steps)
    torch.cuda.reset_peak_memory_stats()
    cfg, model, opt, batches, ddp = train_gpt.build(args)
    if fault:
        def local_shard(grads=None, gradient_average=True):
            return opt._rank_slice(_flatten_pad(
                [p.grad for p in opt.params], opt.spec))

        opt.reduce_scatter_grads = local_shard
    err, bound = _p16_probe_shard(model, opt, next(batches), world)
    _dispatch.reset_launches()
    losses, seconds, summary = _timed_steps(
        lambda ids: train_gpt.train_step(model, opt, ids, ddp), batches,
        steps)
    return dict(losses=losses, seconds=seconds, collectives=summary,
                plan=opt.collective_plan(), probe_err=err,
                probe_bound=bound, launches=_dispatch.launches(),
                peak=torch.cuda.max_memory_allocated(),
                padded=opt.spec.padded_size, shard=opt.spec.shard_size)


def _bert_args(extra=(), steps=P16_STEPS):
    from apex_tpu_torch.examples import pretrain_bert

    return pretrain_bert.parse_args([
        "--steps", str(steps), "--batch", str(BERT_BATCH),
        "--seq-len", str(BERT_SEQ), *extra])


def p16_bert(rank, world, steps, fault=False):
    """16c worker: ``examples.pretrain_bert`` (BERT-Large, FusedLAMB) at
    dp = world under DistributedDataParallel, ``steps`` steps.  ``fault``
    plants the fault the check exists to catch: DDP's gradient sync
    skipped, each rank stepping on its own half of the batch."""
    import torch

    from apex_tpu_torch.examples import pretrain_bert
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.parallel import DistributedDataParallel

    torch.cuda.reset_peak_memory_stats()
    cfg, model, opt, batches, _ = pretrain_bert.build(
        _bert_args(["--backend", "gloo"], steps))
    ddp = DistributedDataParallel(model, pretrain_bert._loss)
    if fault:
        ddp.all_reduce_gradients = lambda grads=None: None
    try:
        _dispatch.reset_launches()
        losses, seconds, summary = _timed_steps(
            lambda b: pretrain_bert.train_step(model, opt, b, ddp=ddp),
            batches, steps)
    finally:
        batches.close()
    return dict(losses=losses, seconds=seconds, collectives=summary,
                plan=ddp.collective_plan(), launches=_dispatch.launches(),
                peak=torch.cuda.max_memory_allocated(),
                sizes=[p.numel() for p in model.parameters()])


def p16_syncbn(rank, world):
    """16d worker: SyncBatchNorm on this rank's rows of a seeded
    (N, C, H, W) bf16 batch against the unsplit cuDNN BatchNorm on the
    whole batch (computed on every rank).  The ranks' rows differ in
    mean and scale, so that statistics over one rank's rows are wrong:
    the planted fault is the same layer normalizing over its own rows
    (its statistics' group the tp axis, of size 1)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import SyncBatchNorm, comm

    ps.destroy_model_parallel()
    ps.initialize_model_parallel()
    try:
        dev = torch.device("cuda", 0)
        n, c, h, w = P16_BN_SHAPE
        g = torch.Generator().manual_seed(3)
        half = torch.arange(n).reshape(n, 1, 1, 1) >= n // 2
        x = (torch.randn(n, c, h, w, generator=g)
             * torch.where(half, 3.0, 2.0)
             + torch.where(half, 2.0, 0.5)).to(dev, torch.bfloat16)
        cot = torch.randn(n, c, h, w, generator=g).to(dev, torch.bfloat16)
        weight = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bias = (0.1 * torch.randn(c, generator=g)).to(dev)
        rows = slice(rank * n // world, (rank + 1) * n // world)
        grp = ps.get_data_parallel_group()

        xf = x.clone().requires_grad_(True)
        wf = weight.clone().requires_grad_(True)
        bf = bias.clone().requires_grad_(True)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        yf = F.batch_norm(xf, rm, rv, wf, bf, training=True, momentum=0.1,
                          eps=1e-5)
        yf.backward(cot)

        def rel(a, b):
            b = b.detach().float()
            return float((a.detach().float() - b).abs().max()
                         / b.abs().max().clamp_min(1e-30))

        def run(axis):
            bn = SyncBatchNorm(c, device=dev, axis_name=axis)
            with torch.no_grad():
                bn.weight.copy_(weight)
                bn.bias.copy_(bias)
            xr = x[rows].clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = bn(xr)
            y.backward(cot[rows])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
            comm.all_reduce(dw, grp)
            comm.all_reduce(db, grp)
            return dict(y=rel(y, yf[rows]), dx=rel(xr.grad, xf.grad[rows]),
                        dw=rel(dw, wf.grad), db=rel(db, bf.grad),
                        running_mean=rel(bn.running_mean, rm),
                        running_var=rel(bn.running_var, rv), ms=ms)

        out = run(ps.DATA_PARALLEL_AXIS)
        out["fault"] = run(ps.TENSOR_PARALLEL_AXIS)
        return out
    finally:
        ps.destroy_model_parallel()


def _bert_dp1_reference(steps, world):
    """BERT-Large at dp = 1 on the global batch, with dp = world's
    objective: the mean of the ``world`` slices' losses (each normalized
    by its own count of predictions, as each dp rank's is), so the
    gradients are the mean of the slices' gradients."""
    import torch

    from apex_tpu_torch.examples import pretrain_bert
    from apex_tpu_torch.models.bert import bert_pretrain_loss

    cfg, model, opt, batches, _ = pretrain_bert.build(_bert_args((), steps))
    losses, seconds = [], []
    try:
        for _ in range(steps):
            b = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total = 0.0
            for r in range(world):
                part = {}
                for k, v in b.items():
                    axis = pretrain_bert._BATCH_AXIS.get(k, 1)
                    per = v.shape[axis] // world
                    part[k] = v.narrow(axis, r * per, per)
                total = total + bert_pretrain_loss(model, part)
            loss = total / world
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    finally:
        batches.close()
    return losses, seconds


def _zero_exact_bytes(kind, shard, world, wire):
    """The exact bytes a ZeRO step's ``kind`` moves (the plan writes
    ``[0, hi]`` around them): the f32 shard a reduce-scatter returns, or
    the world's encoded payloads of an all-to-all or all-gather, chunk
    by chunk as ``comm`` cuts them."""
    from apex_tpu_torch.parallel import comm

    if kind == "reduce-scatter":
        return shard * 4
    bounds = comm._chunk_bounds(
        shard, min(comm.resolve_chunks(int(
            world * shard * comm.wire_bytes_per_element(wire))), shard),
        1 if wire == "f32" else comm.DEFAULT_BLOCK)
    return sum(world * comm.wire_payload_bytes(hi - lo, wire)
               for lo, hi in bounds)


def _check_plan(tag, summary, plan):
    """The call log of one step against a plan: every planned collective
    with its count and bytes within the plan's bounds, and nothing
    unplanned."""
    kinds = {e["kind"] for e in plan["collectives"]}
    extra = set(summary) - kinds
    if extra:
        raise AssertionError(f"{tag}: unplanned collectives {extra}")
    for e in plan["collectives"]:
        got = summary.get(e["kind"], {"count": 0, "bytes": 0})
        if e["count"] is not None and got["count"] != e["count"]:
            raise AssertionError(f"{tag}: {e['kind']} count {got['count']} "
                                 f"!= planned {e['count']}")
        lo, hi = e["bytes"]
        if not lo <= got["bytes"] <= hi:
            raise AssertionError(f"{tag}: {e['kind']} bytes {got['bytes']} "
                                 f"outside the planned [{lo}, {hi}]")


def _gpt_step_launches(layers):
    """K1-K4 launches of one remat GPT step: two LayerNorms a layer and
    the final one, each layer's forward run twice (the recompute)."""
    return {"layer_norm_fwd": 2 * (2 * layers) + 1,
            "layer_norm_bwd": 2 * layers + 1,
            "flash_fwd": 2 * layers, "flash_bwd": layers}


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase16(phase6_losses=None):
    """Data and tensor parallelism on the card (ROADMAP item 5), in
    worker processes started with ``torch.multiprocessing`` (spawn), each
    in a ``file://``-store process group with a timeout, every kernel
    built by this process first:

    - 16a: ``train_gpt`` at phase 6's configuration, 4 steps, in a world
      of 1 over NCCL (DDP, parallel_state at tp = 1) equals the same run
      in this process with no process group bit for bit (losses,
      parameters' bytes, K1-K4 launches; and phase 6's first 4 losses
      when phase 6 ran);
    - 16b: tp = 2 with sequence parallelism, two ranks on the card over
      gloo: the gradients gathered over tp against tp = 1, a planted
      fault past 10x the limit; 4 steps of ``train_gpt --tp 2
      --sequence-parallel`` against the same steps at tp = 1, K1-K4
      counts equal per rank;
    - 16c: dp = 2 over gloo: GPT with DistributedFusedAdam on the f32
      and int8 wires against FusedAdam at dp = 1 (the reduced shard
      within the int8 codec's bound), each beside its planted fault (the
      reduce-scatter skipped), BERT-Large through ``pretrain_bert`` under
      DDP and FusedLAMB against dp = 1 on the same global batch, and each
      first step's call log against ``zero_plan`` / ``sync_plan``;
    - 16d: SyncBatchNorm over two ranks against the unsplit BatchNorm,
      beside its planted fault (statistics over one rank's rows).

    Every reading is logged before a failed check fails the phase.

    The two-rank times are of two processes sharing one card, their
    collectives staged through the host by gloo: not a rank's speed."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.ops import _dispatch

    out = {}
    log("phase 16: data and tensor parallelism")
    # 16a ------------------------------------------------------------------
    torch.cuda.empty_cache()
    _dispatch.reset_launches()
    ref = train_gpt.train(_gpt_args([]))
    torch.cuda.synchronize()
    ref_launches = _dispatch.launches()
    ref_digests = _param_digests(ref.model)
    ref_losses, ref_seconds = ref.losses, ref.step_seconds
    layers = ref.cfg.num_layers
    del ref
    (w1,) = _p16_spawn(1, "nccl", [("p16_world1", "p16_world1", {})])
    w1 = w1["p16_world1"]
    want = {k: n * P16_STEPS for k, n in _gpt_step_launches(layers).items()}
    if (w1["backend"], w1["world"], w1["ddp"]) != ("nccl", 1, True):
        raise AssertionError(f"16a ran as {w1['backend']} x {w1['world']}")
    if w1["losses"] != ref_losses:
        raise AssertionError(f"16a losses {w1['losses']} != {ref_losses}")
    if phase6_losses is not None and \
            w1["losses"] != phase6_losses[:P16_STEPS]:
        raise AssertionError(f"16a losses {w1['losses']} != phase 6's "
                             f"{phase6_losses[:P16_STEPS]}")
    diff = [n for n in ref_digests if ref_digests[n] != w1["digests"][n]]
    if diff:
        raise AssertionError(f"16a parameters differ: {diff[:5]}")
    if w1["launches"] != want or ref_launches != want:
        raise AssertionError(f"16a launches {w1['launches']} / "
                             f"{ref_launches} != {want}")
    step_w1 = statistics.median(w1["step_seconds"][1:]) * 1e3
    step_ref = statistics.median(ref_seconds[1:]) * 1e3
    log(f"  16a world 1 over NCCL: losses {w1['losses']} equal the "
        f"no-group run's{' and phase 6' if phase6_losses else ''}; "
        f"{len(ref_digests)} parameters bit for bit; launches {want}; "
        f"step {step_w1:.1f} ms (no group {step_ref:.1f} ms), peak "
        f"{w1['peak'] / 1e9:.2f} GB")
    out["16a"] = dict(losses=w1["losses"], launches=w1["launches"],
                      step_ms=step_w1, step_ms_no_group=step_ref,
                      peak_memory_bytes=w1["peak"])

    # 16b and 16c's dp = 1 reference (this process, no group) ---------------
    def gpt_ref():
        cfg, model, opt, batches, ddp = train_gpt.build(
            _gpt_args([], layers=P16_GPT_LAYERS))
        next(batches)  # the workers' probe batch
        torch.cuda.reset_peak_memory_stats()
        _dispatch.reset_launches()
        losses, seconds, _ = _timed_steps(
            lambda ids: train_gpt.train_step(model, opt, ids, ddp), batches,
            P16_STEPS)
        return (losses, seconds, _dispatch.launches(),
                torch.cuda.max_memory_allocated())

    gpt_dp1, gpt_dp1_s, gpt_dp1_launches, gpt_dp1_peak = gpt_ref()
    want2 = {k: n * P16_STEPS
             for k, n in _gpt_step_launches(P16_GPT_LAYERS).items()}
    if gpt_dp1_launches != want2:
        raise AssertionError(f"16b/16c dp 1 launches {gpt_dp1_launches} != "
                             f"{want2}")
    gc.collect()
    torch.cuda.empty_cache()
    bert_dp1, bert_dp1_s = _bert_dp1_reference(P16_STEPS, 2)
    gc.collect()
    torch.cuda.empty_cache()

    # 16b, 16c, 16d: one spawn of two ranks over gloo ------------------------
    zero = dict(layers=P16_GPT_LAYERS, steps=P16_STEPS)
    runs = _p16_spawn(2, "gloo", [
        ("p16_tp", "p16_tp", dict(layers=P16_GPT_LAYERS, steps=P16_STEPS)),
        ("p16_zero", "p16_zero", dict(zero, wire="f32")),
        ("p16_zero_int8", "p16_zero", dict(zero, wire="int8")),
        ("p16_zero_fault", "p16_zero", dict(zero, wire="f32", fault=True)),
        ("p16_zero_int8_fault", "p16_zero", dict(zero, wire="int8",
                                                 fault=True)),
        ("p16_bert", "p16_bert", dict(steps=P16_STEPS)),
        ("p16_bert_fault", "p16_bert", dict(steps=P16_STEPS, fault=True)),
        ("p16_syncbn", "p16_syncbn", {}),
    ])
    failed, faults = [], []

    def check(ok, msg):
        if not ok:
            failed.append(msg)

    # 16b
    for r, run in enumerate(runs):
        tp = run["p16_tp"]
        worst = max(tp["grad_rel_errs"].items(), key=lambda kv: kv[1])
        fault = max(tp["fault_rel_errs"].values())
        loss_err = max(_rel(tp["losses"], gpt_dp1),
                       _rel([tp["loss_tp2"]], [tp["loss_tp1"]]))
        fault_loss = _rel([tp["loss_fault"]], [tp["loss_tp1"]])
        log(f"  16b rank {r}: tp 2 + SP against tp 1: worst gradient "
            f"{worst[1]:.4g} ({worst[0]}; limit {P16_TP_GRAD_TOL}), planted "
            f"fault {fault:.4g} ({fault / P16_TP_GRAD_TOL:.1f}x the limit); "
            f"one loss {tp['loss_tp2']} vs {tp['loss_tp1']} (planted fault "
            f"{tp['loss_fault']}, rel {fault_loss:.3g}); train_gpt "
            f"{tp['mesh']} sp {tp['sp']} ddp {tp['ddp']}: losses "
            f"{tp['losses']} vs dp 1 {gpt_dp1} (worst rel {loss_err:.3g}, "
            f"limit {P16_TP_LOSS_TOL}); launches {tp['launches']} (dp 1 "
            f"{gpt_dp1_launches}); step "
            f"{statistics.median(tp['seconds'][1:]) * 1e3:.1f} ms (tp 1 "
            f"{statistics.median(gpt_dp1_s[1:]) * 1e3:.1f} ms; two processes "
            f"sharing the card over gloo), peak {tp['peak'] / 1e9:.2f} GB "
            f"(tp 1 {gpt_dp1_peak / 1e9:.2f} GB); one step's collectives "
            f"{tp['collectives']}")
        check(tp["mesh"]["tp"] == 2 and tp["mesh"]["dp"] == 1 and tp["sp"]
              and tp["ddp"], f"16b rank {r}: train_gpt ran as {tp['mesh']} "
              f"sp {tp['sp']} ddp {tp['ddp']}")
        check(worst[1] <= P16_TP_GRAD_TOL, f"16b rank {r}: gradient {worst}")
        check(fault > P16_FAULT_FACTOR * P16_TP_GRAD_TOL,
              f"16b rank {r}: the planted fault reads only {fault}")
        check(loss_err <= P16_TP_LOSS_TOL, f"16b rank {r}: losses {loss_err}")
        faults.append(fault_loss)
        check(tp["launches"] == gpt_dp1_launches,
              f"16b rank {r}: launches {tp['launches']} != "
              f"{gpt_dp1_launches}")
    # a fault is caught when the check fails on any rank
    check(max(faults) > P16_TP_LOSS_TOL,
          f"16b: the planted fault's loss reads only {max(faults)}")
    out["16b"] = {k: runs[0]["p16_tp"][k] for k in (
        "loss_tp1", "loss_tp2", "loss_fault", "losses", "seconds", "launches",
        "peak", "collectives")}
    out["16b"]["peak_tp1"] = gpt_dp1_peak
    out["16b"]["worst_grad_rel_err"] = max(
        max(run["p16_tp"]["grad_rel_errs"].values()) for run in runs)
    out["16b"]["fault_rel_err"] = min(
        max(run["p16_tp"]["fault_rel_errs"].values()) for run in runs)
    # 16c GPT ZeRO, and each wire's planted fault (the reduce-scatter
    # skipped): the fault must fail both the loss limit and the probe
    for wire, key, tol in (("f32", "p16_zero", P16_ZERO_LOSS_TOL),
                           ("int8", "p16_zero_int8", P16_INT8_LOSS_TOL)):
        fault_losses, fault_probes = [], []
        for r, run in enumerate(runs):
            z, zf = run[key], run[key + "_fault"]
            err = _rel(z["losses"], gpt_dp1)
            ferr = _rel(zf["losses"], gpt_dp1)
            log(f"  16c rank {r} ZeRO Adam {wire}: losses {z['losses']} vs "
                f"dp 1 {gpt_dp1} (rel {err:.3g}, limit {tol}); shard probe "
                f"{z['probe_err']:.3g} (bound {z['probe_bound']:.3g}); "
                f"planted fault (no reduce-scatter): losses {zf['losses']} "
                f"(rel {ferr:.3g}, {ferr / tol:.1f}x the limit), probe "
                f"{zf['probe_err']:.3g} ({zf['probe_err'] / zf['probe_bound']:.1f}"
                f"x the bound); step "
                f"{statistics.median(z['seconds'][1:]) * 1e3:.1f} ms (dp 1 "
                f"{statistics.median(gpt_dp1_s[1:]) * 1e3:.1f}; two processes "
                f"sharing the card over gloo), peak {z['peak'] / 1e9:.2f} GB; "
                f"one step's collectives {z['collectives']}")
            check(err <= tol, f"16c ZeRO {wire} rank {r}: {err}")
            check(z["probe_err"] <= z["probe_bound"],
                  f"16c ZeRO {wire} rank {r}: shard error {z['probe_err']} > "
                  f"{z['probe_bound']}")
            fault_losses.append(ferr / tol)
            fault_probes.append(zf["probe_err"] / zf["probe_bound"])
            try:
                _check_plan(f"16c ZeRO {wire} rank {r}", z["collectives"],
                            z["plan"])
            except AssertionError as e:
                failed.append(str(e))
            for kind in ("reduce-scatter", "all-to-all", "all-gather"):
                if kind in z["collectives"]:
                    want = _zero_exact_bytes(kind, z["shard"], 2, wire)
                    check(z["collectives"][kind]["bytes"] == want,
                          f"16c ZeRO {wire} rank {r}: {kind} moved "
                          f"{z['collectives'][kind]['bytes']} bytes, the "
                          f"plan's exact count is {want}")
        check(max(fault_losses) > 1, f"16c ZeRO {wire}: the planted "
              f"fault's losses read only {max(fault_losses):.3g}x the limit")
        check(max(fault_probes) > 1, f"16c ZeRO {wire}: the planted "
              f"fault's shard reads only {max(fault_probes):.3g}x the bound")
        out[f"16c_zero_{wire}"] = {k: runs[0][key][k] for k in (
            "losses", "seconds", "collectives", "probe_err", "probe_bound",
            "peak")}
        out[f"16c_zero_{wire}"]["fault"] = {
            k: runs[0][key + "_fault"][k] for k in (
                "losses", "probe_err", "probe_bound")}
    out["16c_gpt_dp1"] = dict(losses=gpt_dp1, seconds=gpt_dp1_s)
    # 16c BERT, and its planted fault (DDP's sync skipped)
    fault_losses = []
    for r, run in enumerate(runs):
        b = run["p16_bert"]
        err = _rel(b["losses"], bert_dp1)
        ferr = _rel(run["p16_bert_fault"]["losses"], bert_dp1)
        fault_losses.append(ferr)
        log(f"  16c rank {r} BERT-Large dp 2: losses {b['losses']} vs dp 1 "
            f"{bert_dp1} (rel {err:.3g}, limit {P16_BERT_LOSS_TOL}); planted "
            f"fault (no gradient sync): losses "
            f"{run['p16_bert_fault']['losses']} (rel {ferr:.3g}, "
            f"{ferr / P16_BERT_LOSS_TOL:.1f}x the limit); step "
            f"{statistics.median(b['seconds'][1:]) * 1e3:.1f} ms (dp 1 "
            f"{statistics.median(bert_dp1_s[1:]) * 1e3:.1f}; two processes "
            f"sharing the card over gloo), peak {b['peak'] / 1e9:.2f} GB; "
            f"one step's collectives {b['collectives']}")
        check(err <= P16_BERT_LOSS_TOL, f"16c BERT rank {r}: {err}")
        try:
            _check_plan(f"16c BERT rank {r}", b["collectives"], b["plan"])
        except AssertionError as e:
            failed.append(str(e))
        # the exact path: every parameter's gradient once, and the loss
        ar = b["collectives"].get("all-reduce", {"bytes": None})
        check(ar["bytes"] == 4 * sum(b["sizes"]) + 4,
              f"16c BERT rank {r}: all-reduce bytes {ar['bytes']}")
    check(max(fault_losses) > P16_BERT_LOSS_TOL, f"16c BERT: the planted "
          f"fault's losses read only {max(fault_losses)}")
    out["16c_bert"] = {k: runs[0]["p16_bert"][k] for k in (
        "losses", "seconds", "collectives", "peak")}
    out["16c_bert"]["fault_losses"] = runs[0]["p16_bert_fault"]["losses"]
    out["16c_bert_dp1"] = dict(losses=bert_dp1, seconds=bert_dp1_s)
    # 16d
    for r, run in enumerate(runs):
        bn = dict(run["p16_syncbn"])
        bad = bn.pop("fault")
        log(f"  16d rank {r} SyncBatchNorm {P16_BN_SHAPE} bf16: "
            + ", ".join(f"{k} {v:.3g}" for k, v in bn.items())
            + f" (limit {P16_BN_TOL}); planted fault (local statistics): "
            + ", ".join(f"{k} {v:.3g}" for k, v in bad.items()))
        over = {k: v for k, v in bn.items() if k != "ms" and v > P16_BN_TOL}
        check(not over, f"16d rank {r}: {over}")
        for k in ("y", "dx", "running_mean", "running_var"):
            check(bad[k] > P16_BN_TOL, f"16d rank {r}: the planted fault's "
                  f"{k} reads only {bad[k]}")
    out["16d"] = runs[0]["p16_syncbn"]
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))
    out["launches_tp2"] = runs[0]["p16_tp"]["launches"]
    out["launches_world1"] = w1["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 17: the evoformer under dynamic axial parallelism — two ranks
# ---------------------------------------------------------------------------

#: 2 of phase 10's blocks (its widths and crop), 3 FusedAdam steps, the
#: pair and MSA rows sharded over dap = 2 ranks sharing the card (gloo)
P17_BLOCKS = 2
P17_STEPS = 3
P17_SEED = 31
#: the sharded run against dap = 1 in one process: the step-0 outputs'
#: max |diff| over max |ref|, each loss's relative difference, and each
#: parameter gradient's max |diff| over its max |value| (bf16 attention:
#: a rank's partial sums round apart from the unsharded contraction's;
#: ``EVO_ZERO_GRAD``, 0 in exact arithmetic, is read as phase 11 reads
#: it).  The planted faults must read more than P16_FAULT_FACTOR x the
#: limit: gather's backward slicing instead of reduce-scattering (the
#: gradients), the all-to-alls landing the blocks in reverse rank order
#: (the outputs and the loss; a mean squared error hardly sees a
#: permutation of rows, so the loss limit sits close under it).  On an
#: H100 (700 W) the sound run reads 1.42e-4 (outputs), 1.06e-7 (losses)
#: and 1.30e-3 (gradients); the faults 0.120, 1.10e-5 and 0.712 (the MSA
#: pair-bias kernel's gradient)
P17_OUT_TOL = 2e-3
P17_LOSS_TOL = 1e-6
P17_GRAD_TOL = 2e-2


def _p17_blocks(axis_name):
    import torch

    from apex_tpu_torch.contrib.openfold import EvoformerBlock

    gen = torch.Generator(device="cuda").manual_seed(P17_SEED)
    blocks = torch.nn.ModuleList(
        EvoformerBlock(**EVO, axis_name=axis_name, dtype=torch.bfloat16,
                       device="cuda", generator=gen)
        for _ in range(P17_BLOCKS))
    randomize_zero_params(blocks, gen)
    return blocks


def _p17_train(blocks, data, steps, n_m, n_z, group=None, on_step0=None):
    """``steps`` FusedAdam steps of the mean squared error (its sum over
    this rank's rows over the global counts ``n_m``/``n_z``), the
    gradients and the loss summed over ``group``; ``on_step0(outs)`` sees
    step 0's outputs and gradients.  Returns (losses, step seconds, the
    step-0 call log summary)."""
    import torch

    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import comm

    m, z, tm, tz = data
    opt = FusedAdam(blocks.parameters(), lr=EVO_LR)
    losses, seconds, summary = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with comm.collective_log() as rec:
            om, oz = m, z
            for blk in blocks:
                om, oz = blk(om, oz)
            loss = ((om - tm).pow(2).sum() / n_m
                    + (oz - tz).pow(2).sum() / n_z)
            loss.backward()
            for p in blocks.parameters():
                comm.all_reduce(p.grad, group)
            loss = comm.all_reduce(loss.detach().clone(), group)
        if step == 0:
            summary = comm.collective_summary(rec)
            if on_step0 is not None:
                on_step0(om.detach(), oz.detach())
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, summary


def p17_dap(rank, world, ref_path, steps, fault=None):
    """17 worker: the blocks at dap = ``world`` on this rank's rows of the
    MSA and the pair, ``steps`` steps; step 0's outputs and gradients
    against the dap = 1 run saved at ``ref_path``.  ``fault`` plants a
    fault a check exists for: ``"gather"`` — ``gather``'s backward
    keeping this rank's rows instead of summing every rank's cotangent
    (the gradients); ``"all_to_all"`` — the transitions landing the
    received blocks in reverse rank order (the outputs and losses)."""
    from apex_tpu_torch import parallel_state as ps

    ps.initialize_model_parallel(1)
    try:
        return _p17_rank(ref_path, steps, fault)
    finally:
        ps.destroy_model_parallel()


def _p17_rank(ref_path, steps, fault):
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.contrib import openfold as pof
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.parallel import comm

    if fault == "gather":
        def sliced(ctx, g):
            n = g.shape[ctx.dim] // ps.axis_size(ctx.axis_name)
            return (g.narrow(ctx.dim, ps.axis_rank(ctx.axis_name) * n, n),
                    None, None)

        pof._Gather.backward = staticmethod(sliced)
    elif fault == "all_to_all":
        a2a = comm._tiled_all_to_all

        def reversed_blocks(x, axis_name, split, concat):
            out = a2a(x, axis_name, split, concat)
            world = ps.axis_size(axis_name)
            return torch.cat(out.chunk(world, dim=concat)[::-1], dim=concat)

        comm._tiled_all_to_all = reversed_blocks
    ref = torch.load(ref_path, map_location="cuda")
    blocks = _p17_blocks("dp")
    full = evoformer_data(EVO_SEQ, EVO_RES, "cuda", seed=P17_SEED)
    data = [pof.scatter(t, "dp", 0).contiguous() for t in full]
    n_m, n_z = full[0].numel(), full[1].numel()
    del full
    errs = {}

    def check(om, oz):
        for name, got in (("m", om), ("z", oz)):
            want = pof.scatter(ref[name], "dp", 0)
            errs[f"out_{name}"] = float((got - want).abs().max()
                                        / want.abs().max())
        grads = {}
        for name, p in blocks.named_parameters():
            want = ref["grads"][name]
            if name.endswith(EVO_ZERO_GRAD):
                # zero in exact arithmetic: its norm against the pair
                # bias kernel's gradient, as phase 11 reads it
                kernel = name.replace(EVO_ZERO_GRAD, EVO_BIAS_KERNELS[0])
                errs.setdefault("zero_grad_norm_ratio", []).append(float(
                    p.grad.norm() / ref["grads"][kernel].norm()))
                continue
            grads[name] = float((p.grad - want).abs().max()
                                / want.abs().max().clamp_min(1e-30))
        errs["grads"] = grads

    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    losses, seconds, summary = _p17_train(
        blocks, data, steps, n_m, n_z, ps.get_group("dp"), check)
    return dict(losses=losses, seconds=seconds, collectives=summary,
                launches=_dispatch.launches(), errs=errs,
                peak=torch.cuda.max_memory_allocated())


def phase17():
    """The evoformer under dynamic axial parallelism (ROADMAP item 5's
    rest): phase 10's widths and crop (c_m 256, c_z 128, 4 heads; MSA
    (128, 256, 256), pair (256, 256, 128)), 2 blocks, bf16 attention, 3
    FusedAdam steps, the rows sharded over dap = 2 worker processes
    sharing the card over gloo, the parameter gradients all-reduced over
    the DAP group.  Held to the same blocks at dap = 1 in this process
    (step 0's outputs and every gradient, the losses), beside the planted
    fault (gather's backward slicing); rank 0's K1-K5 launches must be
    ``EVO_BLOCK_LAUNCHES`` x blocks x steps (the fused K4 + K5 call
    included); the bytes of each collective kind and the step time are
    logged.  The two-rank times are of two processes sharing one card,
    their collectives staged through the host by gloo."""
    import shutil
    import tempfile

    import torch

    from apex_tpu_torch.ops import _dispatch

    log(f"phase 17: {P17_BLOCKS} evoformer blocks under DAP (dap = {DAP}, "
        f"N_seq {EVO_SEQ}, N_res {EVO_RES}, {P17_STEPS} FusedAdam steps)")
    torch.cuda.empty_cache()
    blocks = _p17_blocks(None)
    data = evoformer_data(EVO_SEQ, EVO_RES, "cuda", seed=P17_SEED)
    ref = {}

    def keep(om, oz):
        ref["m"], ref["z"] = om.float(), oz.float()
        ref["grads"] = {n: p.grad.detach().clone()
                        for n, p in blocks.named_parameters()}

    _dispatch.reset_launches()
    ref_losses, ref_seconds, _ = _p17_train(
        blocks, data, P17_STEPS, data[0].numel(), data[1].numel(),
        on_step0=keep)
    ref_launches = _dispatch.launches()
    del blocks, data
    tmp = tempfile.mkdtemp(prefix="apex_p17_")
    path = os.path.join(tmp, "ref.pt")
    torch.save(ref, path)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    try:
        runs = _p16_spawn(DAP, "gloo", [
            ("sound", "p17_dap", dict(ref_path=path, steps=P17_STEPS)),
            ("fault", "p17_dap", dict(ref_path=path, steps=1,
                                      fault="gather")),
            ("a2a_fault", "p17_dap", dict(ref_path=path, steps=1,
                                          fault="all_to_all")),
        ])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = {k: n * P17_BLOCKS * P17_STEPS
            for k, n in EVO_BLOCK_LAUNCHES.items() if n}
    sound = [r["sound"] for r in runs]
    fault = [r["fault"] for r in runs]
    a2a = [r["a2a_fault"] for r in runs]
    a2a_out = max(max(r["errs"]["out_m"], r["errs"]["out_z"]) for r in a2a)
    a2a_loss = max(_rel(r["losses"], ref_losses[:1]) for r in a2a)
    out_err = max(max(r["errs"]["out_m"], r["errs"]["out_z"]) for r in sound)
    grad_err = max(max(r["errs"]["grads"].values()) for r in sound)
    worst = max(((v, n) for r in sound for n, v in r["errs"]["grads"].items()))
    fault_err = max(max(r["errs"]["grads"].values()) for r in fault)
    fault_worst = max(((v, n) for r in fault
                       for n, v in r["errs"]["grads"].items()))
    zero = max(max(r["errs"]["zero_grad_norm_ratio"]) for r in sound)
    top = sorted(((v, n) for n, v in sound[0]["errs"]["grads"].items()),
                 reverse=True)[:4]
    top_fault = sorted(((v, n) for n, v in fault[0]["errs"]["grads"].items()),
                       reverse=True)[:4]
    log(f"  gradients' worst readings, sound {top}; fault {top_fault}; "
        f"{EVO_ZERO_GRAD} (0 in exact arithmetic) norm / pair-bias "
        f"kernel's {zero:.3e}")
    loss_err = max(_rel(r["losses"], ref_losses) for r in sound)
    step_ms = statistics.median(sound[0]["seconds"][1:]) * 1e3
    log(f"  dap = 1 (this process): losses {ref_losses}, step "
        f"{statistics.median(ref_seconds[1:]) * 1e3:.1f} ms, launches "
        f"{ref_launches}")
    log(f"  dap = {DAP} over gloo: losses {[r['losses'] for r in sound]} "
        f"(max rel diff {loss_err:.3e}, limit {P17_LOSS_TOL}); step-0 "
        f"outputs max rel {out_err:.3e} (limit {P17_OUT_TOL}); gradients "
        f"max rel {grad_err:.3e} at {worst[1]} (limit {P17_GRAD_TOL})")
    log(f"  planted fault (gather's backward slicing): gradients max rel "
        f"{fault_err:.3e} at {fault_worst[1]} (must exceed "
        f"{P16_FAULT_FACTOR} x {P17_GRAD_TOL})")
    log(f"  planted fault (all-to-all blocks in reverse order): outputs max "
        f"rel {a2a_out:.3e}, loss rel {a2a_loss:.3e} (must exceed "
        f"{P16_FAULT_FACTOR} x {P17_OUT_TOL} and x {P17_LOSS_TOL})")
    log(f"  rank 0: launches {sound[0]['launches']} (want {want}); step "
        f"{step_ms:.1f} ms; peak {sound[0]['peak'] / 1e9:.2f} GB; step-0 "
        f"collectives {sound[0]['collectives']}")
    if ref_launches != want:
        raise AssertionError(f"17 dap = 1 launches {ref_launches} != {want}")
    for r in sound:
        if r["launches"] != want:
            raise AssertionError(f"17 launches {r['launches']} != {want}")
    if loss_err > P17_LOSS_TOL or out_err > P17_OUT_TOL or \
            grad_err > P17_GRAD_TOL:
        raise AssertionError("17: the sharded run is past its limits")
    if fault_err <= P16_FAULT_FACTOR * P17_GRAD_TOL:
        raise AssertionError("17: the gradient check cannot tell the "
                             "planted gather fault")
    if a2a_out <= P16_FAULT_FACTOR * P17_OUT_TOL or \
            a2a_loss <= P16_FAULT_FACTOR * P17_LOSS_TOL:
        raise AssertionError("17: the output and loss checks cannot tell "
                             "the planted all-to-all fault")
    return sound[0]["launches"], dict(
        losses=sound[0]["losses"], ref_losses=ref_losses,
        loss_rel_err=loss_err, out_rel_err=out_err, grad_rel_err=grad_err,
        worst_grad=worst[1], fault_grad_rel_err=fault_err,
        fault_worst_grad=fault_worst[1], zero_grad_norm_ratio=zero,
        a2a_fault_out_rel_err=a2a_out, a2a_fault_loss_rel_err=a2a_loss,
        step_ms=step_ms, ref_step_ms=statistics.median(ref_seconds[1:]) * 1e3,
        collectives=sound[0]["collectives"], peak=sound[0]["peak"])


# ---------------------------------------------------------------------------
# phase 18: the composable trainer
# ---------------------------------------------------------------------------

#: 18b-d: GptConfig()'s width cut to 2 layers (P16_GPT_LAYERS), phase
#: 6's batch, dp = 2 over gloo; 18c's guarded run (the dynamic scaler at
#: 2**16, GradGuard with a warm-up of 2) poisons step 3's gradients; 18d
#: saves every 2 steps and is preempted at step 3 of 6 (at 5 of 8 before
#: phase 26 joined the script: the same schedule, four steps fewer)
P18_STEPS = 4
P18_GUARDED_STEPS = 5
P18_CHAOS = "grads:nan@3"
P18_FIT_STEPS = 6
P18_FIT_PREEMPT = 3
#: 18a: the trainer's losses against phase 6's hand-written loop over the
#: same batches, relative, per step (0 when both run the same kernels in
#: the same order: on an H100 at 700 W they are equal bit for bit, and
#: the planted functional_call fault reads 5.9e-2 at its third step)
P18_LOSS_TOL = 1e-6
P18_FAULT_STEPS = 3


def _gpt_batches(args, cfg, n):
    """The first ``n`` GLOBAL (S, B) batches of ``train_gpt``'s corpus
    and loader (the stream ``train_gpt.build`` slices per dp rank)."""
    import itertools

    import torch

    from apex_tpu_torch.data import DataLoader, TokenFileDataset
    from apex_tpu_torch.examples import train_gpt

    ds = TokenFileDataset(train_gpt.corpus(args, cfg.vocab_size),
                          seq_len=args.seq_len)
    loader = DataLoader(ds, batch_size=args.batch, seed=7)
    return [torch.as_tensor(b.T.astype(np.int64), device="cuda")
            for b in itertools.islice(loader, n)]


def _gpt_trainer(cfg, dp, mode="auto", verify="error", **kw):
    """``Trainer.build`` over a fresh ``GptModel(cfg)`` (seed 0) through
    ``module_loss``: every leaf replicated, the batch's columns over dp,
    FusedAdam at phase 6's lr."""
    from apex_tpu_torch.analysis import P
    from apex_tpu_torch.models.gpt import GptModel, gpt_lm_loss
    from apex_tpu_torch.train import (
        TrainConfig,
        Trainer,
        module_loss,
        module_params,
    )

    model = GptModel(cfg, device="cuda")
    config = TrainConfig(
        mesh={"dp": dp}, rules=[(r".*", P())], learning_rate=TRAIN_LR,
        batch_rules=[(r".*", P(None, "dp"))], update_sharding=mode,
        verify=verify, **kw)
    return model, Trainer(config), module_loss(model, gpt_lm_loss), \
        module_params(model)


def _p18a_functional_call(cfg, batches):
    """18a's planted fault: the trainer with its loss through
    ``torch.func.functional_call`` (the substitution ends with the
    forward, so remat's recompute reads the module's own, initial
    weights); its losses over ``batches``."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models.gpt import gpt_lm_loss

    model, trainer, _, params = _gpt_trainer(cfg, 1, verify="off")

    class Bound(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.module = model

        def forward(self, ids):
            return gpt_lm_loss(self.module, ids)

    bound = Bound()

    def loss_fn(p, ids):
        return torch.func.functional_call(
            bound, {"module." + k.replace("/", "."): t for k, t in p.items()},
            (ids,))

    step = trainer.build(loss_fn, params, batches[0])
    st, losses = step.state, []
    for b in batches:
        st, aux = step(st, b)
        losses.append(float(aux["loss"]))
    del model, trainer, step, st
    ps.destroy_model_parallel()
    return losses


def _syncs(fn):
    """The device synchronizations ``fn()`` makes (the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(x.message) for x in w)


def _digest(t):
    import hashlib

    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def p18_workers(rank, world, phase):
    """18b-d worker (dp = ``world``, GptConfig()'s width at 2 layers):

    - 18b: ``Trainer.build(verify="error")`` in both update modes, 4
      steps each (losses, the build's plan report and one step's log);
      a planted bogus ``model_collectives`` entry must fail the build;
      ``build_demo(1, 2)`` at tp = 2 issues one all-reduce over tp a
      step; the DDP path with its gradient sync skipped (the planted
      fault of the loss check);
    - 18c: ``build_guarded`` with ``APEX_TPU_CHAOS="grads:nan@3"``'s
      fault between the two programs: per step the loss, the verdict,
      the scale and the params' digest ("18c_blind": a scaler whose
      overflow flag never fires, the planted fault of the skip checks);
    - 18d: ``TrainStep.fit`` in ZeRO mode on the async engine, every 2
      steps, once whole and once preempted at step 3 and resumed by a
      fresh build: the final params' and master shard's digests; the
      same resume with every rank reading the other rank's shards (the
      planted fault of the bit-for-bit check).
    ``phase`` picks one of "18b" / "18c" / "18c_blind" / "18d"."""
    import torch

    from apex_tpu_torch import parallel_state as ps

    try:
        if phase == "18c_blind":
            return _p18c(rank, world, blind=True)
        return globals()[f"_p{phase}"](rank, world)
    finally:
        ps.destroy_model_parallel()
        torch.cuda.empty_cache()


def _p18_cfg():
    from apex_tpu_torch.examples import train_gpt

    args = _gpt_args(["--backend", "gloo"], layers=P16_GPT_LAYERS)
    return args, train_gpt.config(args)


def _p18b(rank, world):
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.train import TrainBuildError, build_demo

    args, cfg = _p18_cfg()
    batches = _gpt_batches(args, cfg, P18_STEPS)
    out = {}
    sync = comm.sync_gradients
    # the planted fault: the DDP path's gradient sync skipped (each rank
    # steps on its own half of the batch)
    for mode in ("auto", "replicate", "replicate:no_sync"):
        upd, _, fault = mode.partition(":")
        model, trainer, loss_fn, params = _gpt_trainer(
            cfg, world, upd, verify="off" if fault else "error")
        step = trainer.build(loss_fn, params, batches[0])
        if fault:
            comm.sync_gradients = lambda grads, *a, **k: grads
        try:
            st, losses = step.state, []
            for b in batches:
                st, aux = step(st, b)
                losses.append(float(aux["loss"]))
        finally:
            comm.sync_gradients = sync
        out[mode] = dict(mode=step.mode, losses=losses)
        if not fault:
            out[mode].update(
                findings=[f.render() for f in step.report.findings],
                plan=step.report.sections["plan"],
                memory=step.report.sections["memory"])
        del model, trainer, step, st
        ps.destroy_model_parallel()
    model, trainer, loss_fn, params = _gpt_trainer(
        cfg, world, model_collectives=[{
            "kind": "all-to-all", "axis": "dp", "count": 7,
            "dtypes": ["s8"]}])
    try:
        trainer.build(loss_fn, params, batches[0])
        out["bogus"] = None
    except TrainBuildError as e:
        out["bogus"] = str(e)
    del model, trainer
    ps.destroy_model_parallel()
    demo = build_demo(1, world)
    with comm.collective_log() as rec:
        demo(demo.state, demo.example_batch)
    out["demo_tp"] = dict(findings=[f.render() for f in demo.report.findings],
                          log=[(r["kind"], r["axis"]) for r in rec])
    return out


def _p18c(rank, world, blind=False):
    """18c's guarded run at dp = ``world`` (also the dp = 1 run).
    ``blind`` plants the fault the skip checks exist for: a scaler whose
    overflow flag never fires."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.analysis import P
    from apex_tpu_torch.models.gpt import GptModel, gpt_lm_loss
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.resilience import GradGuard, chaos
    from apex_tpu_torch.train import (
        TrainConfig,
        Trainer,
        module_loss,
        module_params,
    )

    args, cfg = _p18_cfg()
    batches = _gpt_batches(args, cfg, P18_GUARDED_STEPS)
    model = GptModel(cfg, device="cuda")
    inner = module_loss(model, gpt_lm_loss)
    class Blind(amp.DynamicLossScaler):
        def unscale(self, grads, state):
            grads, found = super().unscale(grads, state)
            return grads, torch.zeros_like(found)

    g = Trainer(TrainConfig(mesh={"dp": world}, rules=[(r".*", P())],
                            update_sharding="replicate")).build_guarded(
        lambda p, b: inner(p, b[0].T), module_params(model),
        tx=fused_adam(TRAIN_LR),
        scaler=Blind() if blind else amp.DynamicLossScaler(),
        guard=GradGuard(warmup_steps=2), verify="error",
        example_batch=(batches[0].T[None],))
    faults, seed = chaos.parse_spec(P18_CHAOS)
    chaos.configure(*faults, seed=seed)
    rows, state = [], g.state
    try:
        for i, ids in enumerate(batches):
            loss, scaled = g.compute_grads(state["params"], state["scaler"],
                                           (ids.T[None],))
            scaled = chaos.corrupt_tree(scaled, i)
            state, v = g.apply_update(scaled, state, loss)
            rows.append(dict(
                loss=float(loss), skipped=float(v.skipped),
                scale=float(state["scaler"].loss_scale),
                digest=_digest(torch.cat([t.reshape(-1) for t in
                                          state["params"].values()]))))
    finally:
        chaos.clear()
    return dict(rows=rows, findings=[f.render() for f in g.report.findings])


def _p18d(rank, world):
    import shutil
    import tempfile

    import torch

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.resilience import chaos

    args, cfg = _p18_cfg()
    batches = _gpt_batches(args, cfg, P18_FIT_STEPS)
    root = tempfile.gettempdir()
    out = {}
    for run in ("plain", "preempted"):
        d = os.path.join(root, f"apex_p18d_{run}")
        # an earlier run's checkpoints there would be resumed from
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
        torch.distributed.barrier()
        model, trainer, loss_fn, params = _gpt_trainer(cfg, world, "shard",
                                                       verify="off")
        step = trainer.build(loss_fn, params, batches[0])
        if run == "preempted":
            chaos.configure(chaos.Fault(chaos.PREEMPTION,
                                        steps=(P18_FIT_PREEMPT,)))
            try:
                first = step.fit(lambda i: batches[i], P18_FIT_STEPS,
                                 directory=d, save_interval_steps=2,
                                 max_to_keep=2)
            finally:
                chaos.clear()
            out["first"] = (first.last_step, first.preempted,
                            ckpt.all_steps(d))
            del model, trainer, step, first
            ps.destroy_model_parallel()
            out["swapped"] = _p18d_swapped(cfg, world, batches, d)
            model, trainer, loss_fn, params = _gpt_trainer(
                cfg, world, "shard", verify="off")
            step = trainer.build(loss_fn, params, batches[0])
        t0 = time.perf_counter()
        res = step.fit(lambda i: batches[i], P18_FIT_STEPS, directory=d,
                       save_interval_steps=2, max_to_keep=2)
        torch.cuda.synchronize()
        out[run] = dict(
            params=_digest(torch.cat([t.reshape(-1) for t in
                                      res.state["params"].values()])),
            master=_digest(res.state["opt"].tree["master"]),
            last=res.last_step, resumed=res.resumed_from,
            steps_run=res.steps_run, seconds=time.perf_counter() - t0,
            goodput=step.goodput.snapshot(), steps=ckpt.all_steps(d))
        del model, trainer, step, res
        ps.destroy_model_parallel()
    return out


def _p18d_swapped(cfg, world, batches, d):
    """The planted fault of 18d's bit-for-bit check: a resume of a copy
    of the preempted run's directory in which every rank reads the other
    rank's shards (its rank swapped for the checkpoint's reads and
    writes).  Returns the final params' and master shard's digests."""
    import shutil

    import torch

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch import parallel_state as ps

    bad = d + "_swapped"
    if torch.distributed.get_rank() == 0:
        shutil.rmtree(bad, ignore_errors=True)
        shutil.copytree(d, bad)
    torch.distributed.barrier()
    model, trainer, loss_fn, params = _gpt_trainer(cfg, world, "shard",
                                                   verify="off")
    step = trainer.build(loss_fn, params, batches[0])
    world_of = ckpt._world
    ckpt._world = lambda: (world - 1 - world_of()[0], world)
    try:
        res = step.fit(lambda i: batches[i], P18_FIT_STEPS, directory=bad,
                       save_interval_steps=2, max_to_keep=2)
    finally:
        ckpt._world = world_of
    out = dict(params=_digest(torch.cat([t.reshape(-1) for t in
                                         res.state["params"].values()])),
               master=_digest(res.state["opt"].tree["master"]),
               resumed=res.resumed_from)
    del model, trainer, step, res
    ps.destroy_model_parallel()
    return out


def phase18(phase6_losses=None):
    """The composable trainer (ROADMAP item 6) on the card:

    - 18a: ``Trainer.build(verify="error")`` over ``GptConfig(remat=True)``
      at full width through ``module_loss``, phase 6's batch 8 x 2048 and
      8 FusedAdam steps, dp = 1: its losses against phase 6's hand-written
      loop on the same batches (``P18_LOSS_TOL``; planted fault: the loss
      through ``torch.func.functional_call``, which remat's recompute
      does not see), K1-K4 launches a step equal to phase 6's, no host
      synchronization a step (``torch.cuda.set_sync_debug_mode``; the
      hand-written step's count logged; planted fault: the metric fold on
      the host), the step time, tokens/s and MFU from the ported
      ``StepMeter``;
    - 18b-d in two worker processes over gloo (:func:`p18_workers`) at
      GptConfig()'s width with 2 layers: both update modes against dp = 1
      (16c's limit; planted fault: the DDP sync skipped), the call
      log within the declared plan (planted fault: a bogus plan entry),
      the demo's tp arm; the guarded build under a NaN step against dp =
      1 under the same fault (planted fault: a scaler whose overflow flag
      never fires); ``fit`` preempted and resumed bit for bit (planted
      fault: each rank resuming from the other's shards)."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models.gpt import gpt_lm_loss
    from apex_tpu_torch.observability import StepMeter, peak_flops_for
    from apex_tpu_torch.ops import _dispatch

    out = {}
    log(f"phase 18: the trainer (18a: GptConfig(remat=True), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps, dp = 1)")
    torch.cuda.empty_cache()
    args = _gpt_args([])
    if phase6_losses is None:  # alone (--trainer): phase 6's loop here
        run = train_gpt.train(args)
        phase6_losses = run.losses
        del run
        gc.collect()
        torch.cuda.empty_cache()
    cfg, model, opt, _, _ = train_gpt.build(args)
    batches = _gpt_batches(args, cfg, TRAIN_STEPS)
    hand_syncs = _syncs(lambda: train_gpt.train_step(model, opt,
                                                     batches[0]))
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    model, trainer, loss_fn, params = _gpt_trainer(cfg, 1)
    step = trainer.build(loss_fn, params, batches[0])
    if step.report.findings:
        raise AssertionError("18a: " + step.report.render())
    del params
    n_params = step.n_params()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    meter = StepMeter(tokens_per_step=tokens, flops_per_step=6.0 * n_params
                      * tokens, peak_flops=peak_flops_for(
                          torch.cuda.get_device_name(0)))
    st, losses, seconds = step.state, [], []
    _dispatch.reset_launches()
    torch.cuda.synchronize()
    meter.tick()
    for b in batches:
        t0 = time.perf_counter()
        st, aux = step(st, b)
        losses.append(float(aux["loss"]))
        seconds.append(time.perf_counter() - t0)
        meter.tick()
    launches = _dispatch.launches()
    trainer_syncs = _syncs(lambda: step(st, batches[0]))
    # the planted fault of the sync check: the metric fold on the host
    from apex_tpu_torch.observability import MetricRegistry

    good = step.registry, step.metrics_state
    step.registry = MetricRegistry(device="cpu")
    step.registry.gauge("train/loss")
    step.metrics_state = step.registry.init()
    host_fold_syncs = _syncs(lambda: step(st, batches[0]))
    step.registry, step.metrics_state = good
    per_step = _gpt_step_launches(cfg.num_layers)
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    ref = phase6_losses[:TRAIN_STEPS] if phase6_losses else None
    loss_err = _rel(losses, ref) if ref else None
    log(f"  18a: losses {losses}; phase 6's {ref} (max rel diff "
        f"{loss_err}); launches {launches} (want {want}); host syncs a "
        f"step {trainer_syncs} (hand-written step {hand_syncs}; planted "
        f"fault, the metric fold on the host: {host_fold_syncs}); step "
        f"{meter.step_time * 1e3:.1f} ms, {meter.tokens_per_sec:.0f} "
        f"tokens/s, MFU {meter.mfu:.4f} (StepMeter, N={n_params}); peak "
        f"{step.report.sections['memory']['peak_bytes'] / 1e9:.2f} GB in "
        "the verify step")
    if launches != want:
        raise AssertionError(f"18a launches {launches} != {want}")
    if trainer_syncs > 0 or host_fold_syncs <= 0:
        raise AssertionError(f"18a: {trainer_syncs} host syncs a step (the "
                             f"hand-written step {hand_syncs}, the host-fold "
                             f"fault {host_fold_syncs})")
    if ref and loss_err > P18_LOSS_TOL:
        raise AssertionError(f"18a losses {losses} != phase 6's {ref}")
    out["18a"] = dict(losses=losses, loss_rel_err=loss_err,
                      launches=launches, syncs=trainer_syncs,
                      hand_syncs=hand_syncs, step_ms=meter.step_time * 1e3,
                      tokens_per_s=meter.tokens_per_sec, mfu=meter.mfu,
                      params=n_params,
                      memory=step.report.sections["memory"])
    del model, trainer, loss_fn, step, st, aux
    gc.collect()
    torch.cuda.empty_cache()
    # the planted fault of the loss check: the loss through
    # torch.func.functional_call, whose substitution the remat recompute
    # in the backward does not see (it reads the module's own weights)
    fault_losses = _p18a_functional_call(cfg, batches[:P18_FAULT_STEPS])
    fault_err = _rel(fault_losses, ref[:P18_FAULT_STEPS])
    log(f"  18a planted fault (functional_call under remat): losses "
        f"{fault_losses}, max rel {fault_err:.3e} (must exceed "
        f"{P18_LOSS_TOL})")
    if fault_err <= P18_LOSS_TOL:
        raise AssertionError("18a: the loss check cannot tell the planted "
                             "functional_call fault")
    out["18a"].update(host_fold_fault_syncs=host_fold_syncs,
                      functional_call_fault_rel_err=fault_err)
    del batches
    gc.collect()
    torch.cuda.empty_cache()

    # the dp = 1 references of 18b and 18c (this process)
    args2, cfg2 = _p18_cfg()
    b2 = _gpt_batches(args2, cfg2, P18_STEPS)
    dp1 = {}
    for mode in ("auto", "replicate"):
        model, trainer, loss_fn, params = _gpt_trainer(cfg2, 1, mode)
        s2 = trainer.build(loss_fn, params, b2[0])
        st, ls = s2.state, []
        for b in b2:
            st, aux = s2(st, b)
            ls.append(float(aux["loss"]))
        dp1[mode] = ls
        del model, trainer, s2, st
        from apex_tpu_torch import parallel_state as ps

        ps.destroy_model_parallel()
    guarded1 = _p18c(0, 1)
    from apex_tpu_torch import parallel_state as ps

    ps.destroy_model_parallel()
    gc.collect()
    torch.cuda.empty_cache()
    runs = _p16_spawn(DAP, "gloo", [
        (ph, "p18_workers", dict(phase=ph))
        for ph in ("18b", "18c", "18c_blind", "18d")])
    b, c, cb, d = ([r[ph] for r in runs]
                   for ph in ("18b", "18c", "18c_blind", "18d"))
    checks = []

    def check(ok, what):
        checks.append((bool(ok), what))

    for mode in ("auto", "replicate"):
        err = max(_rel(r[mode]["losses"], dp1[mode]) for r in b)
        log(f"  18b {mode}: mode {b[0][mode]['mode']}, losses "
            f"{b[0][mode]['losses']} vs dp = 1 {dp1[mode]} (max rel "
            f"{err:.3e}, limit {P16_ZERO_LOSS_TOL}); plan "
            f"{b[0][mode]['plan']}; findings {b[0][mode]['findings']}")
        check(err <= P16_ZERO_LOSS_TOL, f"18b {mode} losses")
        check(all(not r[mode]["findings"] for r in b), f"18b {mode} plan")
        check(b[0][mode]["mode"] == {"auto": "zero",
                                     "replicate": "ddp"}[mode],
              f"18b {mode} decision")
        out[f"18b_{mode}"] = dict(losses=b[0][mode]["losses"],
                                  loss_rel_err=err, plan=b[0][mode]["plan"])
    ferr = max(_rel(r["replicate:no_sync"]["losses"], dp1["replicate"])
               for r in b)
    log(f"  18b planted fault (the DDP sync skipped): losses max rel "
        f"{ferr:.3e} against dp = 1 (must exceed {P16_ZERO_LOSS_TOL})")
    check(ferr > P16_ZERO_LOSS_TOL, "18b the sync-skipped fault caught")
    out["18b_sync_fault_rel_err"] = ferr
    log(f"  18b planted bogus plan: {b[0]['bogus']!r:.200}")
    check(all(r["bogus"] and "reshard-plan" in r["bogus"] for r in b),
          "18b bogus plan refused")
    log(f"  18b build_demo(1, 2): step log {b[0]['demo_tp']['log']}")
    check(all(r["demo_tp"]["log"] == [["all-reduce", "tp"]]
              and not r["demo_tp"]["findings"] for r in b),
          "18b demo tp arm: one all-reduce over tp")
    skip = [row["skipped"] for row in c[0]["rows"]]
    scales = [row["scale"] for row in c[0]["rows"]]
    log(f"  18c guarded under {P18_CHAOS}: skipped {skip}, scales "
        f"{scales}; dp = 1 skipped "
        f"{[row['skipped'] for row in guarded1['rows']]}")
    check(skip == [1.0 if i == 3 else 0.0 for i in range(P18_GUARDED_STEPS)]
          and all([row["skipped"] for row in r["rows"]] == skip for r in c),
          "18c step 3 skipped on both ranks")
    check(all(r["rows"][3]["digest"] == r["rows"][2]["digest"] for r in c),
          "18c params unchanged by the skipped step")
    check(scales[3] == scales[2] / 2, "18c the scale halves")
    gerr = max(_rel([row["loss"] for row in r["rows"]],
                    [row["loss"] for row in guarded1["rows"]]) for r in c)
    check(gerr <= P16_ZERO_LOSS_TOL, "18c losses against dp = 1")
    check(not c[0]["findings"], "18c plan")
    bskip = [row["skipped"] for row in cb[0]["rows"]]
    log(f"  18c planted fault (an overflow flag that never fires): skipped "
        f"{bskip}, step 3 params unchanged "
        f"{cb[0]['rows'][3]['digest'] == cb[0]['rows'][2]['digest']}")
    check(bskip != skip and all(r["rows"][3]["digest"] != r["rows"][2][
        "digest"] for r in cb), "18c the blind-scaler fault caught")
    out["18c"] = dict(skipped=skip, scales=scales, loss_rel_err=gerr)
    for r in d:
        log(f"  18d: first run {r['first']}; whole run {r['plain']['last']} "
            f"in {r['plain']['seconds']:.1f} s, resumed from "
            f"{r['preempted']['resumed']} ({r['preempted']['steps_run']} "
            f"steps); params/master equal: "
            f"{r['plain']['params'] == r['preempted']['params']}/"
            f"{r['plain']['master'] == r['preempted']['master']}")
        check(r["first"][:2] == [P18_FIT_PREEMPT, True], "18d preempted")
        check(r["plain"]["params"] == r["preempted"]["params"]
              and r["plain"]["master"] == r["preempted"]["master"],
              "18d resume bit for bit")
        log(f"  18d planted fault (each rank reads the other's shards): "
            f"resumed from {r['swapped']['resumed']}, params/master equal "
            f"the whole run: {r['plain']['params'] == r['swapped']['params']}"
            f"/{r['plain']['master'] == r['swapped']['master']}")
        check(r["swapped"]["resumed"] == P18_FIT_PREEMPT
              and r["plain"]["params"] != r["swapped"]["params"],
              "18d the swapped-shard fault caught")
    out["18d"] = dict(first=d[0]["first"], plain=d[0]["plain"],
                      preempted=d[0]["preempted"])
    bad = [what for ok, what in checks if not ok]
    if bad:
        raise AssertionError(f"phase 18 failed: {bad}")
    return launches, out


# ---------------------------------------------------------------------------
# the ring hops' f32 K3/K4 (phases 1 and 4)
# ---------------------------------------------------------------------------

#: phase 19's ring hops (GPT width: B 8 x H 16 heads, S_local 1024 at cp
#: = 2, D 64; q widened to f32 and k, v with it): the contiguous layout's
#: causal self hop and plain past hop, and zigzag's 512-row half blocks
RING_HOPS = (("ring_self", 128, 1024, True), ("ring_past", 128, 1024, False),
             ("zigzag_self", 128, 512, True), ("zigzag_past", 128, 512, False))


def phase1_ring_hops(gen):
    """The f32 instances of K3 and K4 at the ring hops' shapes, with the
    non-zero lse cotangent the online-softmax merge feeds K4 (``dlse``,
    folded into ``delta``): o, lse, m, l, dq, dk, dv against the twins
    under F32_ATTN_TOL, beside the TF32 control that must fail it."""
    import torch

    from apex_tpu_torch.ops import attention as attn

    log("phase 1: f32 K3/K4 at the ring hops' shapes, dlse != 0")
    errs = {}
    for tag, bh, s, causal in RING_HOPS:
        q, k, v, do = (torch.randn(bh, s, 64, generator=gen, device="cuda")
                       for _ in range(4))
        dlse = 0.5 * torch.randn(bh, s, generator=gen, device="cuda")
        kw = dict(scale=0.125, causal=causal)
        tag = f"{tag} BH={bh} S={s} D=64 causal={causal} f32"
        ref = attn.flash_fwd_reference(q, k, v, **kw)
        out = attn.flash_fwd(q, k, v, **kw)
        e3 = compare(f"K3 {tag} o", out[0], ref[0], F32_ATTN_TOL)
        for name, a, r in zip(("lse", "m", "l"), out[1:], ref[1:]):
            compare(f"K3 {tag} {name}", a, r, F32_ATTN_TOL)
        f32_control("K3 " + tag, ("o", "lse"), ref,
                    tf32_twin(attn.flash_fwd_reference, q, k, v, **kw))
        o, _, m, l = ref
        delta = (do * o).sum(-1) - dlse
        args = (q, k, v, do, m, l, delta)
        del ref, out, o
        out = attn.flash_bwd(*args, **kw)
        ref = attn.flash_bwd_reference(*args, **kw)
        e4 = [compare(f"K4 {tag} {n} (dlse)", a, r, F32_ATTN_TOL)
              for n, a, r in zip(("dq", "dk", "dv"), out, ref)]
        f32_control("K4 " + tag, ("dq", "dk", "dv"), ref,
                    tf32_twin(attn.flash_bwd_reference, *args, **kw))
        errs.setdefault("flash_fwd_f32_ring", e3)
        errs.setdefault("flash_bwd_f32_ring", max(e4))
        del out, ref, args, q, k, v, do, m, l, delta, dlse
        torch.cuda.empty_cache()
    return errs


def _time_ring_hops(gen, flush):
    """The f32 K3 and K4 at the ring hops' shapes (``RING_HOPS``), K4
    with a non-zero dlse, beside the plain versions and f32 SDPA (B 8,
    H 16).  Bounds: q, k, v (dO) read, o (dq, dk, dv) written, the f32
    row statistics (and dlse), against three TF32 products a product
    (3xTF32) of 2·D flops per live pair, 2 forward and 5 backward."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    out = {}
    for tag, bh, s, causal in RING_HOPS:
        q, k, v, do = (torch.randn(bh, s, 64, generator=gen, device="cuda")
                       for _ in range(4))
        dlse = 0.5 * torch.randn(bh, s, generator=gen, device="cuda")
        kw = dict(scale=0.125, causal=causal)
        live = bh * attn.causal_pairs(s, s, causal)
        elems = bh * s * 64
        q4, k4, v4 = (t.reshape(8, 16, s, 64) for t in (q, k, v))
        fwd = dict(
            ms=time_ms(lambda: attn.flash_fwd(q, k, v, **kw), flush=flush),
            plain_ms=time_ms(lambda: attn.flash_fwd_reference(q, k, v, **kw),
                             flush=flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=0.125), flush=flush),
        )
        fwd["bound_ms"], fwd["bound_by"] = bound(
            4 * elems * 4 + 3 * 4 * bh * s, 3 * 4 * 64 * live,
            TF32_TENSOR_FLOPS)
        o, _, m, l = attn.flash_fwd(q, k, v, **kw)
        delta = (do * o).sum(-1) - dlse
        args = (q, k, v, do, m, l, delta)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        o_lib, lse_lib = None, None
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                               scale=0.125)
        bwd = dict(
            ms=time_ms(lambda: attn.flash_bwd(*args, **kw), flush=flush),
            plain_ms=time_ms(lambda: attn.flash_bwd_reference(*args, **kw),
                             iters=5, warmup=1, flush=flush),
            library_ms=time_ms(lambda: torch.autograd.grad(
                o_lib, (qr, kr, vr), do.reshape(q4.shape),
                retain_graph=True), flush=flush),
        )
        bwd["bound_ms"], bwd["bound_by"] = bound(
            7 * elems * 4 + 4 * 4 * bh * s, 3 * 10 * 64 * live,
            TF32_TENSOR_FLOPS)
        shape = (f"BH={bh} S={s} D=64 {'causal' if causal else 'non-causal'}"
                 f" f32 ({tag.replace('_', ' ')} hop, phase 19)")
        out.setdefault("flash_fwd_f32", {})[f"{tag}_shape"] = dict(
            fwd, shape=shape)
        out.setdefault("flash_bwd_f32", {})[f"{tag}_shape"] = dict(
            bwd, shape=shape + ", dlse != 0")
        del o_lib, lse_lib, args, o, m, l, delta, q, k, v, do, qr, kr, vr
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 19: context parallelism — ring, zigzag and Ulysses on two workers
# ---------------------------------------------------------------------------

#: ``examples.train_gpt`` at GptConfig()'s width (hidden 1024, 16 heads,
#: vocab 50304, bf16, remat) and 2 layers, a global sequence of 2048
#: (1024 a rank at cp = 2), batch 8, 3 FusedAdam steps at phase 6's
#: learning rate, on the example's corpus and loader
P19_CP = 2
P19_LAYERS = 2
P19_STEPS = 3
P19_MODES = ("ring", "ring_zigzag", "ulysses")
#: limits against cp = 1 in this process: the hidden states and each
#: gradient as max |diff| over the reference's max |value| (and each
#: gradient's relative Frobenius error ||diff|| / ||ref||), the losses
#: relative per step, step 0's on its own (Adam carries the rounding of
#: one step into the next).  The ring's hops run the f32 K3/K4, so the
#: ring modes are held to cp = 1 with f32 attention (q, k, v widened,
#: the output cast back, as a hop does) and Ulysses, whose attention is
#: bf16, to cp = 1 as it trains.  The bf16 weight gradients are each
#: rank's bf16 product over its rows, summed: one bf16 rounding apart
#: from cp = 1's, which every mode reads alike (4.6e-3, Ulysses too,
#: whose forward is bit for bit).  That floor hides the planted dlse
#: fault (1.3e-2), so each mode is also held in f32: the same weights
#: as an f32 GptModel, one train_step on the first batch against cp = 1
#: in f32 (f32 attention on both sides), where the floor is the kernels'
#: 3xTF32 rounding.  The planted faults: the ring's backward fed no dlse
#: (at random weights every hop's output is close to the merged one, so
#: dlse is small) and the shard-edge targets taken from the rank's own
#: rows (8 of 16,376 targets); the f32 gradients must read each past
#: P16_FAULT_FACTOR x their limit.  On an H100 (700 W), bf16 sound →
#: fault: gradients max rel 4.59e-3 → 1.31e-2 (dlse), norm rel 2.31e-3
#: → 5.73e-3; step-0 loss ≤ 9.5e-7 → 1.03e-5 (boundary); losses over 3
#: steps ≤ 2.12e-5; hidden ≤ 1.30e-2 (Ulysses bit for bit).  f32 twin:
#: gradients 2.49e-5 (the embedding's scatter-add) → 1.31e-2 (dlse),
#: 2.41e-3 (boundary); loss 0 → 1.09e-5 (boundary)
P19_OUT_TOL = 2e-2
P19_LOSS0_TOL = 2e-6
P19_LOSS_TOL = 5e-5
P19_GRAD_TOL = 1e-2
P19_GRAD_NORM_TOL = 5e-3
P19_F32_GRAD_TOL = 1e-4
P19_F32_LOSS_TOL = 1e-6


def _grad_errs(model, ref, rows=None, norm=False):
    """{name: max |grad - ref| / max |ref|} over the model's parameters
    (``rows(name, ref)`` cuts a reference tensor to this rank's part);
    with ``norm``, ||grad - ref|| / ||ref|| instead."""
    out = {}
    for name, p in model.named_parameters():
        want = ref[name] if rows is None else rows(name, ref[name])
        diff = p.grad.float() - want
        if norm:
            out[name] = float(diff.norm() / want.norm().clamp_min(1e-30))
        else:
            out[name] = float(diff.abs().max()
                              / want.abs().max().clamp_min(1e-30))
    return out


def _read_grads_at_step(opt, read):
    """Have ``opt.step`` call ``read()`` once, before its first update:
    the gradients as ``train_step`` hands them to the optimizer."""
    step = opt.step

    def read_then_step(*args, **kwargs):
        opt.step = step
        read()
        return step(*args, **kwargs)

    opt.step = read_then_step


def _cp_rows(t, mode, rank, world):
    from apex_tpu_torch.transformer.context_parallel import zigzag_shard

    if mode == "ring_zigzag":
        return zigzag_shard(t, rank, world, axis=0)
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def p19_cp(rank, world, ref_path, f32_ref_path, mode, steps, fault=None):
    """19 worker: ``examples.train_gpt --context-parallel mode --cp
    world`` at 2 layers through ``build`` and ``train_step`` (the cp
    group, this rank's rows of the loader's batches by ``local_rows``,
    DDP at dp = 1, ``gpt_lm_loss_cp``, the cp mean of the gradients).
    Step 0's hidden states and the gradients ``train_step`` hands the
    optimizer against the cp = 1 run saved at ``ref_path``, the losses,
    the launches of the training steps, the step-0 call log.  Then the
    f32 twin (the same weights as an f32 GptModel, one ``train_step`` on
    the first batch) against ``f32_ref_path``: its gradients and loss.
    ``fault``: ``"dlse"`` — the attention backward fed no lse cotangent
    (the ring's hops); ``"boundary"`` — gpt_lm_loss_cp's shard-edge
    targets taken from the rank's own first rows instead of the
    neighbour's."""
    import dataclasses as dc
    import itertools
    import types

    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.models.gpt import GptModel
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.optimizers import FusedAdam

    orig_bwd, orig_p2p = attn._Flash.backward, gpt_mod.p2p
    if fault == "dlse":
        attn._Flash.backward = staticmethod(
            lambda ctx, do, dlse: orig_bwd(ctx, do, None))
    elif fault == "boundary":
        gpt_mod.p2p = types.SimpleNamespace(
            send_backward_recv_backward=lambda x, *a, **k: x,
            send_forward_recv_forward=lambda x, *a, **k: x)
    args = _gpt_args(["--context-parallel", mode, "--cp", str(world),
                      "--backend", "gloo"], layers=P19_LAYERS, steps=steps)
    try:
        ref = torch.load(ref_path, map_location="cuda")
        cfg, model, opt, batches, ddp = train_gpt.build(args)
        first = next(batches)
        errs = {}
        with torch.no_grad():
            h = model(first)
            want = _cp_rows(ref["h"], mode, rank, world)
            errs["out"] = float((h.float() - want.float()).abs().max()
                                / want.float().abs().max())
        del h

        def read():
            errs["grads"] = _grad_errs(model, ref["grads"])
            errs["grads_norm"] = _grad_errs(model, ref["grads"], norm=True)

        _read_grads_at_step(opt, read)
        torch.cuda.reset_peak_memory_stats()
        _dispatch.reset_launches()
        losses, seconds, summary = _timed_steps(
            lambda b: train_gpt.train_step(model, opt, b, ddp),
            itertools.chain([first], batches), steps)
        launches = _dispatch.launches()
        peak = torch.cuda.max_memory_allocated()
        out = dict(losses=losses, seconds=seconds, collectives=summary,
                   launches=launches, errs=errs, peak=peak,
                   mesh=dict(ps.get_mesh().shape), ddp=ddp is not None)
        del model, opt, ddp, ref
        gc.collect()
        torch.cuda.empty_cache()

        # the f32 twin: one train_step on the first batch
        ref = torch.load(f32_ref_path, map_location="cuda")
        model = GptModel(dc.replace(cfg, dtype=torch.float32), device="cuda")
        opt = FusedAdam(model.parameters(), lr=TRAIN_LR)

        def read_f32():
            errs["grads_f32"] = _grad_errs(model, ref["grads"])

        _read_grads_at_step(opt, read_f32)
        loss = float(train_gpt.train_step(model, opt, first, None))
        errs["loss_f32"] = abs(loss - ref["loss"]) / abs(ref["loss"])
        return out
    finally:
        attn._Flash.backward, gpt_mod.p2p = orig_bwd, orig_p2p
        ps.destroy_model_parallel()


def _p19_want(mode, rank, steps):
    """Rank ``rank``'s launches in ``steps`` steps at cp = 2 under the
    example's remat (each block forwarded twice): the ring's computed
    half or whole blocks (f32, each forwarded three times: the block's
    recompute and the hop's own checkpoint), Ulysses' bf16 attention
    over the full sequence, K1/K2 at the rank's rows."""
    L = P19_LAYERS
    want = {"layer_norm_fwd": (4 * L + 1) * steps,
            "layer_norm_bwd": (2 * L + 1) * steps}
    if mode == "ulysses":
        want.update(flash_fwd=2 * L * steps, flash_bwd=L * steps)
        return want
    # contiguous causal: rank r computes r + 1 blocks; zigzag: 5 half
    # blocks on every rank (3 at the self hop, 2 at the other)
    blocks = 5 if mode == "ring_zigzag" else rank + 1
    want.update(flash_fwd_f32=3 * blocks * L * steps,
                flash_bwd_f32=blocks * L * steps)
    return want


def _p19_reference(args, f32_attention=False, dtype=None, steps=P19_STEPS):
    """cp = 1 in this process on the example's model (seed 0; ``dtype``
    in place of its bf16) and global batches: step 0's hidden states,
    gradients and loss, the losses and step seconds of ``gpt_lm_loss`` +
    FusedAdam; with ``f32_attention`` the blocks' attention runs on f32
    q, k, v (K3/K4's f32 instances) and is cast back, as a ring hop
    computes it."""
    import dataclasses as dc

    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = train_gpt.config(args)
    if dtype is not None:
        cfg = dc.replace(cfg, dtype=dtype)
    model = gpt_mod.GptModel(cfg, device="cuda")
    ids = _gpt_batches(args, cfg, P19_STEPS)
    orig = gpt_mod._attention
    if f32_attention:
        gpt_mod._attention = lambda c, q, k, v: orig(
            c, q.float(), k.float(), v.float()).to(q.dtype)
    try:
        ref = {}
        with torch.no_grad():
            ref["h"] = model(ids[0])
        opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
        losses, seconds = [], []
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = gpt_mod.gpt_lm_loss(model, ids[step])
            loss.backward()
            if step == 0:
                ref["loss"] = float(loss.detach())
                ref["grads"] = {n: p.grad.detach().float().clone()
                                for n, p in model.named_parameters()}
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    finally:
        gpt_mod._attention = orig
    return ref, losses, seconds


def phase19():
    """Context parallelism (ROADMAP item 7): ``examples.train_gpt
    --context-parallel {ring,ring_zigzag,ulysses} --cp 2`` at
    ``GptConfig()``'s width and 2 layers, global sequence 2048 and batch
    8, in two worker processes sharing the card over gloo (1024 rows a
    rank), 3 FusedAdam steps through ``build`` and ``train_step``.  Held
    to the same model at cp = 1 in this process (``gpt_lm_loss``, the
    same weights and batches; f32 attention for the ring modes): step 0's
    hidden states, the losses and every gradient; beside two planted
    faults.  Rank 0's launches are exact (:func:`_p19_want`); the bytes
    of each collective kind and the step time are logged (two processes
    on one card: gloo stages every collective through the host)."""
    import shutil
    import tempfile

    import torch

    log(f"phase 19: train_gpt ({P19_LAYERS} layers, GptConfig() width) "
        f"under context parallelism, cp = {P19_CP}, seq {TRAIN_SEQ}, batch "
        f"{TRAIN_BATCH}, {P19_STEPS} FusedAdam steps")
    torch.cuda.empty_cache()
    args = _gpt_args([], layers=P19_LAYERS, steps=P19_STEPS)
    tmp = tempfile.mkdtemp(prefix="apex_p19_")
    paths, refs = {}, {}
    for kind, kw in (("bf16", {}), ("f32", dict(f32_attention=True)),
                     ("f32_model", dict(dtype=torch.float32, steps=1))):
        ref, losses, seconds = _p19_reference(args, **kw)
        paths[kind] = os.path.join(tmp, f"ref_{kind}.pt")
        torch.save(ref, paths[kind])
        refs[kind] = (losses, seconds)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    attention_of = {"ring": "f32", "ring_zigzag": "f32", "ulysses": "bf16"}
    jobs = [(mode, "p19_cp", dict(ref_path=paths[attention_of[mode]],
                                  f32_ref_path=paths["f32_model"],
                                  mode=mode, steps=P19_STEPS))
            for mode in P19_MODES]
    jobs += [(f"{fault}_fault", "p19_cp", dict(
        ref_path=paths["f32"], f32_ref_path=paths["f32_model"], mode="ring",
        steps=1, fault=fault)) for fault in ("dlse", "boundary")]
    try:
        runs = _p16_spawn(P19_CP, "gloo", jobs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for kind, (losses, seconds) in refs.items():
        log(f"  cp = 1 ({kind}, this process): losses {losses}, step "
            f"{statistics.median(seconds[1:] or seconds) * 1e3:.1f} ms")
    ref_losses = {m: refs[attention_of[m]][0] for m in P19_MODES}
    out = dict(ref_losses=refs["bf16"][0], ref_f32_losses=refs["f32"][0],
               ref_step_ms=statistics.median(refs["bf16"][1][1:]) * 1e3,
               ref_f32_step_ms=statistics.median(refs["f32"][1][1:]) * 1e3)
    failed = []
    def top(errs, n=3):
        return [(f"{v:.2e}", k) for v, k in sorted(
            ((v, k) for k, v in errs.items()), reverse=True)[:n]]

    for mode in P19_MODES:
        rs = [r[mode] for r in runs]
        out_err = max(r["errs"]["out"] for r in rs)
        loss_err = max(_rel(r["losses"], ref_losses[mode]) for r in rs)
        loss0_err = max(_rel(r["losses"][:1], ref_losses[mode]) for r in rs)
        worst = max((v, n) for r in rs for n, v in r["errs"]["grads"].items())
        worst_n = max((v, n) for r in rs
                      for n, v in r["errs"]["grads_norm"].items())
        worst32 = max((v, n) for r in rs
                      for n, v in r["errs"]["grads_f32"].items())
        loss32 = max(r["errs"]["loss_f32"] for r in rs)
        step_ms = statistics.median(rs[0]["seconds"][1:]) * 1e3
        want = [_p19_want(mode, rank, P19_STEPS) for rank in range(P19_CP)]
        log(f"  {mode}: losses {rs[0]['losses']} (max rel diff "
            f"{loss_err:.3e}, limit {P19_LOSS_TOL}; step 0 "
            f"{loss0_err:.3e}, limit {P19_LOSS0_TOL}); step-0 hidden max "
            f"rel {out_err:.3e} (limit {P19_OUT_TOL}); gradients max rel "
            f"{worst[0]:.3e} at {worst[1]} (limit {P19_GRAD_TOL}), norm rel "
            f"{worst_n[0]:.3e} at {worst_n[1]} (limit {P19_GRAD_NORM_TOL});"
            f" f32 twin: gradients max rel {worst32[0]:.3e} at {worst32[1]} "
            f"(limit {P19_F32_GRAD_TOL}), loss {loss32:.3e} (limit "
            f"{P19_F32_LOSS_TOL}); step {step_ms:.1f} ms; peak "
            f"{rs[0]['peak'] / 1e9:.2f} GB")
        log(f"    worst gradients: max rel {top(rs[0]['errs']['grads'])}, "
            f"norm rel {top(rs[0]['errs']['grads_norm'])}, f32 twin "
            f"{top(rs[0]['errs']['grads_f32'])}")
        log(f"    rank 0 launches {rs[0]['launches']} (want {want[0]}); "
            f"rank 1 {rs[1]['launches']}; step-0 collectives "
            f"{rs[0]['collectives']}")
        for rank, r in enumerate(rs):
            if r["launches"] != want[rank]:
                failed.append(f"{mode} rank {rank} launches")
            if r["mesh"]["cp"] != P19_CP or not r["ddp"]:
                failed.append(f"{mode} rank {rank} built {r['mesh']}, "
                              f"DDP {r['ddp']}")
        if loss_err > P19_LOSS_TOL or out_err > P19_OUT_TOL or \
                worst[0] > P19_GRAD_TOL or loss0_err > P19_LOSS0_TOL or \
                worst_n[0] > P19_GRAD_NORM_TOL or \
                worst32[0] > P19_F32_GRAD_TOL or loss32 > P19_F32_LOSS_TOL:
            failed.append(f"{mode} past its limits")
        out[mode] = dict(losses=rs[0]["losses"], loss_rel_err=loss_err,
                         loss0_rel_err=loss0_err, out_rel_err=out_err,
                         grad_rel_err=worst[0], worst_grad=worst[1],
                         grad_norm_rel_err=worst_n[0],
                         worst_grad_norm=worst_n[1],
                         f32_grad_rel_err=worst32[0], f32_worst=worst32[1],
                         f32_loss_rel_err=loss32, step_ms=step_ms,
                         collectives=rs[0]["collectives"],
                         launches_rank0=rs[0]["launches"],
                         launches_rank1=rs[1]["launches"],
                         peak=rs[0]["peak"])
    for fault, what in (("dlse", "the hops' backward fed no dlse"),
                        ("boundary", "boundary targets from the rank's own "
                                     "rows")):
        rs = [r[f"{fault}_fault"] for r in runs]
        g = max((v, n) for r in rs for n, v in r["errs"]["grads"].items())
        g_n = max((v, n) for r in rs
                  for n, v in r["errs"]["grads_norm"].items())
        g32 = max((v, n) for r in rs
                  for n, v in r["errs"]["grads_f32"].items())
        loss0 = max(_rel(r["losses"][:1], ref_losses["ring"]) for r in rs)
        loss32 = max(r["errs"]["loss_f32"] for r in rs)
        log(f"  planted fault ({what}): f32 twin gradients max rel "
            f"{g32[0]:.3e} at {g32[1]} (must exceed {P16_FAULT_FACTOR} x "
            f"{P19_F32_GRAD_TOL}), loss {loss32:.3e}; bf16 gradients max "
            f"rel {g[0]:.3e} at {g[1]}, norm rel {g_n[0]:.3e}, step-0 loss "
            f"{loss0:.3e}; worst f32 {top(rs[0]['errs']['grads_f32'])}")
        out[f"{fault}_fault"] = dict(
            f32_grad_rel_err=g32[0], f32_worst=g32[1], f32_loss_rel_err=loss32,
            grad_rel_err=g[0], worst_grad=g[1], grad_norm_rel_err=g_n[0],
            loss0_rel_err=loss0)
        if g32[0] <= P16_FAULT_FACTOR * P19_F32_GRAD_TOL:
            failed.append(f"the f32 gradient check cannot tell the {fault} "
                          "fault")
    if failed:
        raise AssertionError(f"19: {failed}")
    launches = {}
    for mode in P19_MODES:
        for name, n in out[mode]["launches_rank0"].items():
            launches[name] = launches.get(name, 0) + n
    return launches, out


# ---------------------------------------------------------------------------
# phase 20: experts — Switch MoE GPT at full size, and at ep = 2
# ---------------------------------------------------------------------------

P20_EXPERTS = 8
P20_STEPS = 8
P20B_STEPS = 3
#: 20b: ep = dp = 2 against ep = 1 on the same two half batches (each
#: rank's routing, capacity and token order are the half batch's at ep =
#: 1), relative per tensor and per loss; the planted fault
#: (sync_moe_gradients averaging the expert_ leaves over dp, which mixes
#: different experts) must read more than P16_FAULT_FACTOR x the limit
P20_LOSS_TOL = 1e-4
P20_GRAD_TOL = 3e-2


def _moe_active_params(model):
    """Parameters a token meets at top-1: every non-expert parameter and
    one expert's two matrices a layer."""
    total, experts, one = 0, 0, 0
    for name, p in model.named_parameters():
        total += p.numel()
        if ".expert_" in name:
            experts += p.numel()
            one += p[0].numel()
    return total - experts + one


def phase20a():
    """``train_gpt --num-experts 8`` at ``GptConfig()``'s full width and
    depth (12 layers, remat), batch 8 x 2048, one process (ep = 1), 8
    steps: the kernels' launches (the MoE blocks launch none: their
    dispatch, combine and expert products are einsums), the step time,
    tokens/s, peak memory and MFU over the active parameters (6 N T,
    N = the parameters a token meets at top-1: the dense ones and one
    expert's two matrices a layer)."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.ops import _dispatch

    log(f"phase 20a: train_gpt --num-experts {P20_EXPERTS} (GptConfig(), "
        f"remat) {P20_STEPS} steps at batch {TRAIN_BATCH}, seq {TRAIN_SEQ}")
    args = train_gpt.parse_args([
        "--steps", str(P20_STEPS), "--batch", str(TRAIN_BATCH), "--seq-len",
        str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--num-experts",
        str(P20_EXPERTS)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    run = train_gpt.train(args)
    torch.cuda.synchronize()
    launches = _dispatch.launches()
    peak = torch.cuda.max_memory_allocated()
    L = run.cfg.num_layers
    per_step = {"layer_norm_fwd": 2 * (2 * L) + 1,
                "layer_norm_bwd": 2 * L + 1,
                "flash_fwd": 2 * L, "flash_bwd": L}
    want = {k: n * P20_STEPS for k, n in per_step.items()}
    losses = run.losses
    n_total = sum(p.numel() for p in run.model.parameters())
    n_active = _moe_active_params(run.model)
    step_s = statistics.median(run.step_seconds[1:])
    tokens_per_s = run.tokens_per_step / step_s
    mfu = 6 * n_active * tokens_per_s / BF16_TENSOR_FLOPS
    log(f"  launches {launches} (want {want}); losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"  step {step_s * 1e3:.1f} ms (median of steps 1..), "
        f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} over the active "
        f"parameters (6 N T, N = {n_active} active of {n_total}: dense "
        f"+ one expert a layer at top-1), peak memory {peak / 1e9:.2f} GB")
    if launches != want:
        raise AssertionError(f"20a launches {launches} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"20a losses not finite and falling: {losses}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(losses=losses, step_ms=step_s * 1e3,
                          tokens_per_s=tokens_per_s, mfu_active=mfu,
                          active_params=n_active, params=n_total,
                          peak_memory_bytes=peak)


def _p20_step_grads(model, ids_half):
    """The mean over the two half batches of ``gpt_lm_loss`` and its
    gradients (the ep = 2 objective at ep = 1)."""
    from apex_tpu_torch.models.gpt import gpt_lm_loss

    losses = []
    for part in ids_half:
        loss = gpt_lm_loss(model, part) * 0.5
        loss.backward()
        losses.append(float(loss.detach()))
    return sum(losses)


def p20_ep(rank, world, ref_path, steps, top_ks=(1, 2), fault=False):
    """20b worker: ``examples.train_gpt --num-experts 8`` at 2 layers
    through ``build`` (ep = dp = ``world``: this rank's expert shard and
    batch columns, no DDP) and ``train_step`` (``sync_moe_gradients``,
    then the dp-mean loss), top-1 on the example's model and top-2 on the
    same model built with ``moe_top_k=2``, both on the built batches.
    Against the ep = 1 runs saved at ``ref_path``: the gradients that
    ``train_step`` hands the optimizer (the expert shards against the
    matching experts), the losses, the launches.  ``fault``: the
    expert_ leaves averaged over dp too."""
    import dataclasses as dc

    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models.gpt import GptModel
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import moe

    orig = moe._is_expert
    if fault:
        moe._is_expert = lambda path: False
    args = _gpt_args(["--num-experts", str(P20_EXPERTS), "--backend",
                      "gloo"], layers=P19_LAYERS, steps=steps)
    try:
        ref = torch.load(ref_path, map_location="cuda")
        cfg, model, opt, batches, ddp = train_gpt.build(args)
        ids = [next(batches) for _ in range(steps)]
        mesh = dict(ps.get_mesh().shape)
        e_l = P20_EXPERTS // world

        def rows(name, t):
            return t[rank * e_l:(rank + 1) * e_l] if ".expert_" in name else t

        out = {}
        for top_k in top_ks:
            if top_k != cfg.moe_top_k:
                del model, opt
                gc.collect()
                torch.cuda.empty_cache()
                model = GptModel(dc.replace(cfg, moe_top_k=top_k),
                                 device="cuda")
                opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
            errs = {}

            def read(model=model, errs=errs, top_k=top_k):
                errs["grads"] = _grad_errs(model, ref[top_k]["grads"], rows)

            _read_grads_at_step(opt, read)
            torch.cuda.reset_peak_memory_stats()
            _dispatch.reset_launches()
            losses, seconds, summary = _timed_steps(
                lambda b: train_gpt.train_step(model, opt, b, ddp),
                iter(ids), steps)
            out[top_k] = dict(losses=losses, seconds=seconds,
                              collectives=summary, errs=errs,
                              launches=_dispatch.launches(), mesh=mesh,
                              ddp=ddp is not None,
                              peak=torch.cuda.max_memory_allocated())
        return out
    finally:
        moe._is_expert = orig
        ps.destroy_model_parallel()


def phase20b():
    """Experts at ep = dp = 2: ``examples.train_gpt --num-experts 8`` at
    ``GptConfig()``'s width and 2 layers, top-1 and top-2, in two worker
    processes over gloo, 3 FusedAdam steps through ``build`` and
    ``train_step`` on the example's global batch 8 x 2048 (each rank its
    4 columns); held to ep = 1 in this process on the same two half
    batches (the mean of their losses and gradients) with the same
    ep-invariant weights: the losses (the aux term included) and every
    gradient, beside the planted fault."""
    import dataclasses as dc
    import shutil
    import tempfile

    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models.gpt import GptModel
    from apex_tpu_torch.optimizers import FusedAdam

    log(f"phase 20b: train_gpt --num-experts {P20_EXPERTS} ({P19_LAYERS} "
        f"layers) at ep = dp = 2 against ep = 1, top-1 and top-2, "
        f"{P20B_STEPS} steps")
    args = _gpt_args(["--num-experts", str(P20_EXPERTS)], layers=P19_LAYERS,
                     steps=P20B_STEPS)
    cfg = train_gpt.config(args)
    ids = _gpt_batches(args, cfg, P20B_STEPS)
    half = TRAIN_BATCH // 2
    ref = {}
    for top_k in (1, 2):
        torch.cuda.empty_cache()
        model = GptModel(dc.replace(cfg, moe_top_k=top_k), device="cuda")
        opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
        ref[top_k] = {"losses": []}
        for step in range(P20B_STEPS):
            loss = _p20_step_grads(model, [ids[step][:, :half].contiguous(),
                                           ids[step][:, half:].contiguous()])
            if step == 0:
                ref[top_k]["grads"] = {n: p.grad.detach().float().clone()
                                       for n, p in model.named_parameters()}
            opt.step()
            opt.zero_grad(set_to_none=True)
            ref[top_k]["losses"].append(loss)
        del model, opt
    del ids
    tmp = tempfile.mkdtemp(prefix="apex_p20_")
    path = os.path.join(tmp, "ref.pt")
    torch.save(ref, path)
    gc.collect()
    torch.cuda.empty_cache()
    jobs = [("sound", "p20_ep", dict(ref_path=path, steps=P20B_STEPS)),
            ("fault", "p20_ep", dict(ref_path=path, steps=1, top_ks=(1,),
                                     fault=True))]
    try:
        runs = _p16_spawn(2, "gloo", jobs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out, failed = {}, []
    L = P19_LAYERS
    want = {"layer_norm_fwd": (4 * L + 1) * P20B_STEPS,
            "layer_norm_bwd": (2 * L + 1) * P20B_STEPS,
            "flash_fwd": 2 * L * P20B_STEPS, "flash_bwd": L * P20B_STEPS}
    for k in (1, 2):
        rs = [r["sound"][str(k)] for r in runs]
        loss_err = max(_rel(r["losses"], ref[k]["losses"]) for r in rs)
        worst = max((v, n) for r in rs for n, v in r["errs"]["grads"].items())
        step_ms = statistics.median(rs[0]["seconds"][1:]) * 1e3
        log(f"  top-{k}: ep = 1 losses {ref[k]['losses']}, ep = 2 "
            f"{rs[0]['losses']} (max rel diff {loss_err:.3e}, limit "
            f"{P20_LOSS_TOL}); gradients max rel {worst[0]:.3e} at "
            f"{worst[1]} (limit {P20_GRAD_TOL}); step {step_ms:.1f} ms; "
            f"peak {rs[0]['peak'] / 1e9:.2f} GB")
        log(f"    rank 0 launches {rs[0]['launches']} (want {want}); "
            f"mesh {rs[0]['mesh']}; step-0 collectives "
            f"{rs[0]['collectives']}")
        if loss_err > P20_LOSS_TOL or worst[0] > P20_GRAD_TOL:
            failed.append(f"top-{k} past its limits")
        for rank, r in enumerate(rs):
            if r["launches"] != want:
                failed.append(f"top-{k} rank {rank} launches "
                              f"{r['launches']} != {want}")
            if r["mesh"]["dp"] != 2 or r["ddp"]:
                failed.append(f"top-{k} rank {rank} built {r['mesh']}, "
                              f"DDP {r['ddp']}")
        out[f"top{k}"] = dict(losses=rs[0]["losses"],
                              ref_losses=ref[k]["losses"],
                              loss_rel_err=loss_err, grad_rel_err=worst[0],
                              worst_grad=worst[1], step_ms=step_ms,
                              collectives=rs[0]["collectives"],
                              launches_rank0=rs[0]["launches"],
                              peak=rs[0]["peak"])
    fault = max((v, n) for r in runs for n, v in
                r["fault"]["1"]["errs"]["grads"].items())
    log(f"  planted fault (the expert_ leaves averaged over dp): gradients "
        f"max rel {fault[0]:.3e} at {fault[1]} (must exceed "
        f"{P16_FAULT_FACTOR} x {P20_GRAD_TOL})")
    out.update(fault_grad_rel_err=fault[0], fault_worst=fault[1])
    if fault[0] <= P16_FAULT_FACTOR * P20_GRAD_TOL:
        failed.append("the gradient check cannot tell the planted fault")
    if failed:
        raise AssertionError(f"20b: {failed}")
    return out["top1"]["launches_rank0"], out


def phase20():
    launches, full = phase20a()
    launches_ep2, ep2 = phase20b()
    return launches, launches_ep2, dict(full=full, ep2=ep2)


# ---------------------------------------------------------------------------
# phase 21: pipeline parallelism — the five schedules on two workers
# ---------------------------------------------------------------------------

#: BertEncoderCore at BertConfig()'s widths (hidden 1024, 16 heads,
#: intermediate 4096, bf16), 4 layers in all over pp = 2, S 128, 4
#: microbatches of 8, the tied head over vocab 30522
P21_PP = 2
P21_LAYERS = 4
P21_NM = 4
P21_MB = 8
P21_SEED = 21
P21_SCHEDULES = (
    ("without_interleaving",
     "forward_backward_pipelining_without_interleaving", {}),
    ("1f1b_residuals", "forward_backward_pipelining_1f1b",
     dict(stash="residuals")),
    ("1f1b_input", "forward_backward_pipelining_1f1b", dict(stash="input")),
    ("with_interleaving", "forward_backward_pipelining_with_interleaving",
     dict(num_model_chunks=2)),
    ("interleaved_1f1b", "forward_backward_pipelining_interleaved_1f1b",
     dict(num_model_chunks=2)),
)
#: against forward_backward_no_pipelining over the 4 layers in this
#: process: the per-microbatch losses (relative) and every stage's
#: gradients (max |diff| over max |value| per tensor).  The planted fault
#: (a cotangent routed to another microbatch's stash) must read more than
#: P16_FAULT_FACTOR x the gradient limit.  On an H100 (700 W) every
#: schedule equals no pipelining bit for bit (the same kernels on the
#: same microbatches, the gradients summed in the same order) and the
#: fault reads 1.53
P21_LOSS_TOL = 1e-5
P21_GRAD_TOL = 1e-2


def _p21_cfg():
    from apex_tpu_torch.models.bert import BertConfig

    return BertConfig(num_layers=P21_LAYERS)


def _p21_fns(core):
    """(stage_fn, loss_fn): the activation is ``(h, bias)`` — the hidden
    states and the key-padding bias, which rides along unchanged; the
    loss is the cross entropy through the tied table ``head``."""
    import torch

    from apex_tpu_torch.models.gpt import vocab_logits
    from apex_tpu_torch.train.trainer import module_loss

    run = module_loss(core, lambda m, x: m(x[0], x[1]))

    def stage_fn(p, x):
        return run(p["core"], x), x[1]

    def loss_fn(p, y, tgt):
        logits = vocab_logits(y[0], p["head"].to(y[0].dtype))
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1))

    return stage_fn, loss_fn


def _p21_data():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(P21_SEED)
    cfg = _p21_cfg()
    h = torch.randn(P21_NM, BERT_SEQ, P21_MB, cfg.hidden_size,
                    generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(BERT_SEQ // 2, BERT_SEQ + 1, (P21_NM, P21_MB),
                            generator=gen, device="cuda")
    keep = torch.arange(BERT_SEQ, device="cuda") < lengths[..., None]
    bias = torch.where(keep, 0.0, -1e9)[:, :, None, None, :].contiguous()
    tgt = torch.randint(0, cfg.vocab_size, (P21_NM, BERT_SEQ, P21_MB),
                        generator=gen, device="cuda")
    return (h, bias), tgt


def _p21_params():
    """The 4 layers' params (``module_params`` names) and the head."""
    import torch

    from apex_tpu_torch.examples.train_gpt_pp import init_core
    from apex_tpu_torch.models.bert import BertEncoderCore
    from apex_tpu_torch.train.trainer import module_params

    cfg = _p21_cfg()
    core = BertEncoderCore(cfg, P21_LAYERS, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(P21_SEED)
    init_core(core, gen)
    head = torch.randn(cfg.vocab_size, cfg.hidden_size, generator=gen,
                       device="cuda") * 0.02
    return core, {k: v.clone() for k, v in module_params(core).items()}, head


def _p21_layers(params, first, n):
    """Layers [first, first + n) of a ``module_params`` tree, renamed
    from 0."""
    out = {}
    for name, t in params.items():
        i, rest = name.split("/", 2)[1:]
        if first <= int(i) < first + n:
            out[f"layers/{int(i) - first}/{rest}"] = t
    return out


def p21_pp(rank, world, ref_path, schedule, kwargs, fault=False):
    """21 worker: this rank's stage (or chunks, stacked) of the 4 layers,
    one call of ``schedule``; its per-microbatch losses and every
    gradient against the no-pipelining run saved at ``ref_path`` (each
    layer's against the same layer's), a second call timed, the
    launches of the first.  ``fault``: rank 0's backward of microbatch 0
    takes microbatch 1's stash and the other way round."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.models.bert import BertEncoderCore
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer import pipeline_parallel as pl
    from apex_tpu_torch.transformer.pipeline_parallel import schedules

    vpp = kwargs.get("num_model_chunks")
    ps.initialize_model_parallel(1, world, vpp)
    orig = schedules._Ticks.backward
    if fault:
        def swapped(self, c, m, g):
            if self.rank == 0 and m in (0, 1):
                other = (1 - m, c)
                if other in self.inflight:
                    self.inflight[(m, c)], self.inflight[other] = (
                        self.inflight[other], self.inflight[(m, c)])
            return orig(self, c, m, g)

        schedules._Ticks.backward = swapped
    try:
        ref = torch.load(ref_path, map_location="cuda")
        chunks = vpp or 1
        per = P21_LAYERS // (world * chunks)
        stages = [c * world + rank for c in range(chunks)]
        trees = [{"core": _p21_layers(ref["params"], v * per, per),
                  "head": ref["head"]} for v in stages]
        if vpp:
            params = {"core": {k: torch.stack([t["core"][k] for t in trees])
                               for k in trees[0]["core"]},
                      "head": torch.stack([t["head"] for t in trees])}
        else:
            params = trees[0]
        core = BertEncoderCore(_p21_cfg(), per, "cuda")
        stage_fn, loss_fn = _p21_fns(core)
        batch = (ref["inputs"], ref["targets"])

        def call():
            return getattr(pl, schedule)(
                stage_fn, loss_fn, params, batch, num_microbatches=P21_NM,
                loss_takes_params=True, **kwargs)

        torch.cuda.synchronize()
        _dispatch.reset_launches()
        with comm.collective_log() as rec:
            losses, grads = call()
        torch.cuda.synchronize()
        launches = _dispatch.launches()
        errs = {}
        for c, v in enumerate(stages):
            want = _p21_layers(ref["grads"]["core"], v * per, per)
            for k, w in want.items():
                g = grads["core"][k][c] if vpp else grads["core"][k]
                errs[f"layers/{v * per + int(k.split('/')[1])}/"
                     f"{k.split('/', 2)[2]}"] = float(
                    (g.float() - w).abs().max() / w.abs().max())
        head = grads["head"][-1] if vpp else grads["head"]
        if rank == world - 1:
            errs["head"] = float((head - ref["grads"]["head"]).abs().max()
                                 / ref["grads"]["head"].abs().max())
        elif head.abs().max() != 0:
            errs["head"] = float("inf")  # only the last stage meets the loss
        loss_err = float(((losses - ref["losses"]).abs()
                          / ref["losses"].abs()).max())
        del grads
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return dict(loss_err=loss_err, losses=losses.tolist(), errs=errs,
                    launches=launches, step_ms=(time.perf_counter() - t0)
                    * 1e3, collectives=comm.collective_summary(rec),
                    peak=torch.cuda.max_memory_allocated())
    finally:
        schedules._Ticks.backward = orig
        ps.destroy_model_parallel()


def p21_example(rank, world, argv):
    """The ported ``train_gpt_pp`` on this rank (its group is up)."""
    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples import train_gpt_pp

    try:
        return train_gpt_pp.main(list(argv))
    finally:
        ps.destroy_model_parallel()


def phase21():
    """Pipeline parallelism (ROADMAP item 7): BertEncoderCore stages at
    BertConfig()'s widths, 4 layers over pp = 2 worker processes sharing
    the card over gloo, S 128, 4 microbatches of 8 with BERT's
    key-padding bias, the loss through the tied head (vocab 30522,
    ``loss_takes_params=True``).  Each schedule — without_interleaving,
    1f1b with both stash modes, with_interleaving and interleaved_1f1b
    at vpp = 2 — held to ``forward_backward_no_pipelining`` over the
    same 4 layers in this process: the per-microbatch losses and every
    stage's gradients, beside a planted fault (a cotangent routed to
    another microbatch's stash).  Then the ported ``train_gpt_pp --pp
    2`` and ``--pp 2 --vpp 2`` at their defaults: the loss must fall."""
    import shutil
    import tempfile

    import torch

    from apex_tpu_torch.transformer import pipeline_parallel as pl

    log(f"phase 21: BertEncoderCore pipeline (BertConfig() widths, "
        f"{P21_LAYERS} layers, pp = {P21_PP}), S {BERT_SEQ}, {P21_NM} "
        f"microbatches of {P21_MB}")
    torch.cuda.empty_cache()
    core, params, head = _p21_params()
    inputs, targets = _p21_data()
    stage_fn, loss_fn = _p21_fns(core)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, grads = pl.forward_backward_no_pipelining(
        stage_fn, loss_fn, {"core": params, "head": head},
        (inputs, targets), num_microbatches=P21_NM, loss_takes_params=True)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref = dict(params=params, head=head, inputs=inputs, targets=targets,
               losses=losses, grads={"core": {k: v.float() for k, v in
                                              grads["core"].items()},
                                     "head": grads["head"].float()})
    tmp = tempfile.mkdtemp(prefix="apex_p21_")
    path = os.path.join(tmp, "ref.pt")
    torch.save(ref, path)
    del ref, grads, core, params, head, inputs, targets
    gc.collect()
    torch.cuda.empty_cache()
    jobs = [(name, "p21_pp", dict(ref_path=path, schedule=fn, kwargs=kw))
            for name, fn, kw in P21_SCHEDULES]
    jobs.append(("fault", "p21_pp", dict(
        ref_path=path, schedule="forward_backward_pipelining_1f1b",
        kwargs=dict(stash="residuals"), fault=True)))
    for name, extra in (("example", []), ("example_vpp", ["--vpp", "2"])):
        jobs.append((name, "p21_example", dict(argv=[
            "--pp", "2", *extra, "--device", "cuda", "--backend", "gloo"])))
    try:
        runs = _p16_spawn(P21_PP, "gloo", jobs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  no pipelining (this process): losses {losses.tolist()}, "
        f"{ref_ms:.1f} ms")
    out, failed = dict(ref_losses=losses.tolist(), ref_ms=ref_ms), []
    for name, _, _ in P21_SCHEDULES:
        rs = [r[name] for r in runs]
        loss_err = max(r["loss_err"] for r in rs)
        worst = max((v, n) for r in rs for n, v in r["errs"].items())
        log(f"  {name}: losses max rel {loss_err:.3e} (limit "
            f"{P21_LOSS_TOL}); gradients max rel {worst[0]:.3e} at "
            f"{worst[1]} (limit {P21_GRAD_TOL}); second call "
            f"{rs[0]['step_ms']:.1f} ms; rank 0 launches "
            f"{rs[0]['launches']}, rank 1 {rs[1]['launches']}; rank 0 "
            f"collectives {rs[0]['collectives']}; peak "
            f"{rs[0]['peak'] / 1e9:.2f} GB")
        if loss_err > P21_LOSS_TOL or worst[0] > P21_GRAD_TOL:
            failed.append(f"{name} past its limits")
        for r in rs:
            if not r["launches"].get("flash_fwd") or \
                    not r["launches"].get("layer_norm_bwd"):
                failed.append(f"{name}: a rank launched no K1-K4")
        out[name] = dict(loss_rel_err=loss_err, grad_rel_err=worst[0],
                         worst_grad=worst[1], step_ms=rs[0]["step_ms"],
                         launches_rank0=rs[0]["launches"],
                         launches_rank1=rs[1]["launches"],
                         collectives=rs[0]["collectives"],
                         peak=rs[0]["peak"])
    fault = max((v, n) for r in runs for n, v in r["fault"]["errs"].items())
    log(f"  planted fault (rank 0's microbatch 0 and 1 cotangents swapped "
        f"in the 1F1B stash): gradients max rel {fault[0]:.3e} at "
        f"{fault[1]} (must exceed {P16_FAULT_FACTOR} x {P21_GRAD_TOL})")
    out.update(fault_grad_rel_err=fault[0], fault_worst=fault[1])
    if fault[0] <= P16_FAULT_FACTOR * P21_GRAD_TOL:
        failed.append("the gradient check cannot tell the planted fault")
    for name in ("example", "example_vpp"):
        a, b = (r[name] for r in runs)
        log(f"  train_gpt_pp --pp 2{' --vpp 2' if 'vpp' in name else ''}: "
            f"losses {[round(x, 4) for x in a]}")
        if a != b or not all(np.isfinite(a)) or not a[-1] < a[0]:
            failed.append(f"{name}: losses not shared, finite and falling")
        out[name] = a
    if failed:
        raise AssertionError(f"21: {failed}")
    launches = {}
    for name, _, _ in P21_SCHEDULES:
        for k, n in out[name]["launches_rank0"].items():
            launches[k] = launches.get(k, 0) + n
    return launches, out


# ---------------------------------------------------------------------------
# phase 22: amp — O1 over K1-K4, O2 with masters, the amp state's resume
# ---------------------------------------------------------------------------


#: 22a: GptConfig(remat=True) at phase 6's batch for this many steps
AMP_STEPS = 4
#: 22b: phase 7's shape (2 layers at full width, B 2, S 256) as an f32
#: GPT with remat, whose attention O1 casts to bf16 (the f32 GPT is where
#: the attention hook changes a dtype), one O1 step on the card against
#: two CPU steps on the plain twins: under O1 (``o1``) and without amp
#: (``f32``).  Readings: the loss's absolute difference and the worst
#: parameter gradient's ||card - cpu|| / ||cpu||.  The card's O1 step must
#: lie within AMP_CROSS_LOSS_TOL / AMP_CROSS_GRAD_TOL of the CPU's O1
#: step, and at least AMP_CROSS_CAST_MIN (gradients) from the CPU's f32
#: step: the bf16 rounding of q, k and v shows.  Planted faults on the
#: card: the attention hook removed (the f32 K3/K4 run: within f32
#: rounding of the CPU's f32 step, so below AMP_CROSS_CAST_MIN) and the
#: recompute run without the forward's policy (a non-reentrant
#: checkpoint refuses a recompute whose saved tensors change dtype:
#: ``CheckpointError``, else its readings must fail a limit).  On an H100
#: (700 W): sound loss 3.6e-5 and gradients 4.8e-3 from the O1 step,
#: gradients 5.2e-3 from the f32 step; the hook fault 1.06e-4 and 5.1e-3
#: from the O1 step — the kernels' bf16 rounding of p and dS inside K3/K4
#: is as large as the rounding of their inputs, so the O1 reading alone
#: cannot tell them apart — but 2.5e-6 from the f32 step (the f32 K3/K4's
#: 3xTF32 against the f32 twin): AMP_CROSS_CAST_MIN sits 5.2x under the
#: sound reading and 400x over the fault's
AMP_CROSS_LOSS_TOL = 1e-3
AMP_CROSS_GRAD_TOL = 2.5e-2
AMP_CROSS_CAST_MIN = 1e-3
#: 22c: the step whose gradients carry the planted inf
AMP_OVERFLOW_STEP = 2
#: 22d: growth after this many clean steps, so the scale moves
AMP_GROWTH_INTERVAL = 2


def _amp_gpt(cfg, level, device="cuda", **amp_kw):
    """A fresh ``GptModel(cfg)`` (seeded 0) and its flat parameters
    through ``amp.initialize(level, **amp_kw)`` over FusedAdam at phase
    6's rate: ``(model, loss_fn, params, handle, state)``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GptModel, gpt_lm_loss
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.train import module_loss, module_params

    model = GptModel(cfg, device=device)
    params, handle = amp.initialize(module_params(model),
                                    fused_adam(TRAIN_LR), level, **amp_kw)
    return (model, module_loss(model, gpt_lm_loss), params, handle,
            handle.init(params))


def _amp_grads(loss_fn, params, handle, state, ids):
    """``(loss, scaled grads)`` of one forward (under the O1 policy when
    the level patches functions); the backward, and so any remat
    recompute, runs after the block."""
    import contextlib

    import torch

    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    ctx = (handle.patch_functions() if handle.properties.opt_level == "O1"
           else contextlib.nullcontext())
    with ctx:
        loss = loss_fn(leaves, ids)
        scaled = handle.scale_loss(loss, state)
    grads = torch.autograd.grad(scaled, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _amp_step(loss_fn, params, handle, state, ids, plant=None):
    """One amp training step; ``plant(grads)`` may alter the scaled
    gradients first.  Returns ``(loss, params, state, found_inf)``."""
    loss, grads = _amp_grads(loss_fn, params, handle, state, ids)
    if plant is not None:
        plant(grads)
    params, state, found = handle.step(params, grads, state)
    return loss, params, state, found


def _clone_tree(tree):
    """A copy of a tree of tensors (dicts, NamedTuples, None, ints)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_tree(v) for v in tree))
    return tree


def _amp_state_equal(tag, a_params, a_state, b_params, b_state):
    """Parameters, masters, moments, step count and scaler state of two
    runs, bit for bit."""
    import torch

    bad = [k for k in a_params if not torch.equal(a_params[k], b_params[k])]
    for name in ("m", "v"):
        bad += [f"{name}:{k}" for k in a_params
                if not torch.equal(getattr(a_state.opt_state, name)[k],
                                   getattr(b_state.opt_state, name)[k])]
    if a_state.master_params is not None:
        bad += [f"master:{k}" for k in a_params
                if not torch.equal(a_state.master_params[k],
                                   b_state.master_params[k])]
    bad += [f"scaler:{f}" for f, x, y in zip(
        a_state.scaler_state._fields, a_state.scaler_state,
        b_state.scaler_state) if not torch.equal(x, y)]
    if int(a_state.opt_state.count) != int(b_state.opt_state.count):
        bad.append("count")
    devs = {str(getattr(st.opt_state.count, "device", "host"))
            for st in (a_state, b_state)}
    if len(devs) > 1:
        bad.append(f"count on {sorted(devs)}")
    if bad:
        raise AssertionError(f"{tag}: differs in {bad[:6]} "
                             f"({len(bad)} tensors)")


def _phase22_kernel_checks():
    """K1 and K2 at the O1 GPT's rows (16384, 1024) in f32 against their
    twins (F32_TOL; dw, db under SUM_TOL), on a generator of their own
    (phase 1's draws stay as they were).  Returns max |y - y_ref|."""
    import torch

    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = TRAIN_BATCH * TRAIN_SEQ
    x, w, b = ln_inputs(rows, 1024, gen)
    x = x.float()
    y, mu, rstd = ln.layer_norm_fwd(x, w, b, eps=1e-5, rms=False)
    y_r, mu_r, rstd_r = ln.layer_norm_reference(x, w, b, 1e-5, False)
    tag = f"K1 layer_norm_fwd rows={rows} hidden=1024 f32 (amp O1)"
    err = compare(tag + " y", y, y_r, F32_TOL)
    compare(tag + " mu", mu, mu_r, F32_TOL)
    compare(tag + " rstd", rstd, rstd_r, F32_TOL)
    g = torch.randn(rows, 1024, generator=gen, device="cuda")
    out = ln.layer_norm_bwd(x, w, b, mu_r, rstd_r, g, rms=False,
                            x_is_output=False)
    ref = ln.layer_norm_bwd_reference(x, w, b, mu_r, rstd_r, g, False, False)
    tag = f"K2 layer_norm_bwd rows={rows} hidden=1024 f32 (amp O1)"
    err_bwd = compare(tag + " dx", out[0], ref[0], F32_TOL)
    compare(tag + " dw", out[1], ref[1], SUM_TOL)
    compare(tag + " db", out[2], ref[2], SUM_TOL)
    return err, err_bwd


def _phase22a(baseline):
    """22a: ``GptConfig(remat=True)`` at phase 6's batch for AMP_STEPS
    steps through ``amp.initialize(..., "O1", loss_scale="dynamic")``:
    exact launches (phase 6's a step), K1/K2 on f32 rows and K3/K4 on
    bf16 (the bf16 entries, none of the f32 ones), finite falling losses,
    no overflow, and the step's speed beside ``baseline`` (phase 6's)."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import GptConfig
    from apex_tpu_torch.ops import _dispatch

    cfg = GptConfig(remat=True)
    args = train_gpt.parse_args(["--batch", str(TRAIN_BATCH), "--seq-len",
                                 str(TRAIN_SEQ)])
    batches = _gpt_batches(args, cfg, AMP_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, loss_fn, params, handle, state = _amp_gpt(
        cfg, "O1", loss_scale="dynamic")
    n_params = sum(p.numel() for p in params.values())
    _dispatch.reset_launches()
    _dispatch.clear_paths()
    losses, seconds, found = [], [], []
    for ids in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, state, f = _amp_step(loss_fn, params, handle, state,
                                           ids)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        found.append(float(f))
    launches = _dispatch.launches()
    dtypes = _dispatch.launch_dtypes()
    paths = _dispatch.last_paths()
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    per_step = {"layer_norm_fwd": 2 * (2 * layers) + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "flash_fwd": 2 * layers, "flash_bwd": layers}
    want = {k: n * AMP_STEPS for k, n in per_step.items()}
    step_s = statistics.median(seconds[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / step_s / BF16_TENSOR_FLOPS
    baseline.setdefault("mfu_6nt", 6 * n_params * tokens / (
        baseline["step_ms_median"] / 1e3) / BF16_TENSOR_FLOPS)
    out = {"losses": losses, "found_inf": found, "step_seconds": seconds,
           "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "mfu_6nt": mfu, "params": n_params, "peak_memory_bytes": peak,
           "launches": launches, "launch_dtypes": dtypes,
           "loss_scale": float(state.scaler_state.loss_scale),
           "phase6": baseline}
    log(f"  22a O1: launches {launches} (per step {per_step}), dtypes "
        f"{dtypes}, paths {paths}")
    log(f"  22a O1: losses {[round(x, 4) for x in losses]}, found_inf "
        f"{found}; step {step_s * 1e3:.1f} ms, {tokens / step_s:.0f} "
        f"tokens/s, 6NT MFU {mfu:.4f}, peak memory {peak / 1e9:.2f} GB; "
        f"phase 6 in this call: {baseline['step_ms_median']:.1f} ms, "
        f"{baseline['tokens_per_s']:.0f} tokens/s, MFU "
        f"{baseline['mfu_6nt']:.4f}, peak "
        f"{baseline['peak_memory_bytes'] / 1e9:.2f} GB")
    failures = []
    if launches != want:
        failures.append(f"launches {launches} != {want}")
    want_dtypes = {"layer_norm_fwd": {"float32": want["layer_norm_fwd"]},
                   "layer_norm_bwd": {"float32": want["layer_norm_bwd"]}}
    if dtypes != want_dtypes:
        failures.append(f"K1/K2 operand dtypes {dtypes} != {want_dtypes}")
    if paths != {"layer_norm": "cuda", "flash_attention": "cuda"}:
        failures.append(f"op paths {paths}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses not finite and falling: {losses}")
    if any(found):
        failures.append(f"an O1 step overflowed: {found}")
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out, failures


def _cross_o1(model, ids, fault=None):
    """One O1 forward and backward of ``model`` on ``ids``: the loss and
    the unscaled f32 gradients on the host.  ``fault``: "hook" (the
    attention category removed from the registry) or "recompute" (the
    checkpoint wrappers without ``carry_policy``)."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.amp import lists
    from apex_tpu_torch.amp.lists import _registry
    from apex_tpu_torch.models import gpt_lm_loss
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.train import module_loss, module_params

    params, handle = amp.initialize(module_params(model),
                                    fused_adam(TRAIN_LR), "O1",
                                    loss_scale="dynamic")
    state = handle.init(params)
    saved_cat, saved_carry = dict(_registry._CATEGORY), lists.carry_policy
    if fault == "hook":
        _registry._CATEGORY.pop("attention")
    elif fault == "recompute":
        lists.carry_policy = lambda fn: fn
    try:
        loss, grads = _amp_grads(module_loss(model, gpt_lm_loss), params,
                                 handle, state, ids)
    finally:
        _registry._CATEGORY.clear()
        _registry._CATEGORY.update(saved_cat)
        lists.carry_policy = saved_carry
    scale = float(state.scaler_state.loss_scale)
    return float(loss), {k: (g.float() / scale).cpu()
                         for k, g in grads.items()}


def _cross_readings(card, cpu):
    l_card, g_card = card
    l_cpu, g_cpu = cpu
    worst = max(float((g_card[k] - g_cpu[k]).norm()
                      / g_cpu[k].norm().clamp_min(1e-30)) for k in g_cpu)
    return {"loss_diff": abs(l_card - l_cpu), "max_grad_rel_err": worst}


def _cross_f32(model, ids):
    """The loss and f32 gradients of one step without amp."""
    from apex_tpu_torch.models import gpt_lm_loss

    model.zero_grad(set_to_none=True)
    loss = gpt_lm_loss(model, ids)
    loss.backward()
    grads = {k.replace(".", "/"): p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _phase22b():
    """22b (see AMP_CROSS_LOSS_TOL): every reading is logged before any
    is checked."""
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel

    cfg = GptConfig(num_layers=2, max_seq_len=256, dtype=torch.float32,
                    remat=True)
    card = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(11))
    cpu = GptModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(256, 2)).astype(np.int64))
    refs = {"o1": _cross_o1(cpu, ids), "f32": _cross_f32(cpu, ids)}
    readings = {}
    for run in ("sound", "hook", "recompute"):
        try:
            got = _cross_o1(card, ids.cuda(),
                            None if run == "sound" else run)
        except torch.utils.checkpoint.CheckpointError as exc:
            readings[run] = {"raised": type(exc).__name__,
                             "message": str(exc).splitlines()[0]}
            continue
        readings[run] = {name: _cross_readings(got, ref)
                         for name, ref in refs.items()}
    limits = {"o1_loss_diff": AMP_CROSS_LOSS_TOL,
              "o1_max_grad_rel_err": AMP_CROSS_GRAD_TOL,
              "f32_max_grad_rel_err_min": AMP_CROSS_CAST_MIN}
    for name, r in readings.items():
        log(f"  22b {name}: {r}")
    log(f"  22b limits {limits}")

    def passes(r):
        return ("raised" not in r
                and r["o1"]["loss_diff"] <= AMP_CROSS_LOSS_TOL
                and r["o1"]["max_grad_rel_err"] <= AMP_CROSS_GRAD_TOL
                and r["f32"]["max_grad_rel_err"] >= AMP_CROSS_CAST_MIN)

    failures = []
    if not passes(readings["sound"]):
        failures.append(f"the sound O1 step reads {readings['sound']} "
                        f"against {limits}")
    for fault in ("hook", "recompute"):
        if passes(readings[fault]):
            failures.append(f"the planted {fault} fault reads "
                            f"{readings[fault]}, within {limits}")
    return dict(readings, limits=limits), failures


def _phase22c():
    """22c: O2 on GptConfig()'s width cut to 2 layers (remat) at phase
    6's batch, 4 steps with bf16 parameters, f32 masters and the dynamic
    scaler; step AMP_OVERFLOW_STEP's gradients carry a planted inf: that
    step is skipped (parameters, masters and moments bit-identical, the
    scale halved, the growth tracker 0) and the next applies.  K1/K2 on
    bf16 rows (O2 casts the model, nothing per op)."""
    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import GptConfig
    from apex_tpu_torch.ops import _dispatch

    cfg = GptConfig(num_layers=P16_GPT_LAYERS, remat=True)
    args = train_gpt.parse_args(["--batch", str(TRAIN_BATCH), "--seq-len",
                                 str(TRAIN_SEQ)])
    batches = _gpt_batches(args, cfg, AMP_STEPS)
    model, loss_fn, params, handle, state = _amp_gpt(
        cfg, "O2", loss_scale="dynamic")
    dtypes = sorted({str(p.dtype) for p in params.values()})
    master = sorted({str(p.dtype) for p in state.master_params.values()})

    def plant(grads):
        g = grads["layers/0/fc1/weight"]
        g.view(-1)[g.numel() // 3] = float("inf")

    _dispatch.reset_launches()
    failures, rows = [], []
    for step, ids in enumerate(batches):
        before = (params, state)
        loss, params, state, found = _amp_step(
            loss_fn, params, handle, state, ids,
            plant if step == AMP_OVERFLOW_STEP else None)
        sc = state.scaler_state
        rows.append({"loss": float(loss), "found_inf": float(found),
                     "loss_scale": float(sc.loss_scale),
                     "growth_tracker": int(sc.growth_tracker),
                     "hysteresis": int(sc.hysteresis),
                     "count": int(state.opt_state.count)})
        if step == AMP_OVERFLOW_STEP:
            try:
                _amp_state_equal("22c: the skipped step", before[0],
                                 before[1]._replace(scaler_state=sc), params,
                                 state)
            except AssertionError as exc:
                failures.append(str(exc))
            want_scale = (float(before[1].scaler_state.loss_scale)
                          * handle.scaler.backoff_factor)
            if float(sc.loss_scale) != want_scale or int(
                    sc.growth_tracker) != 0 or float(found) != 1.0:
                failures.append(f"22c: the overflow step reads {rows[-1]}, "
                                f"want the scale {want_scale} and tracker 0")
        elif float(found) != 0.0:
            failures.append(f"22c: clean step {step} overflowed")
        if step == AMP_OVERFLOW_STEP + 1 and torch.equal(
                params["layers/0/fc1/weight"], before[0][
                    "layers/0/fc1/weight"]):
            failures.append("22c: the step after the skip did not apply")
    launches, ldt = _dispatch.launches(), _dispatch.launch_dtypes()
    per_step = {"layer_norm_fwd": 2 * (2 * cfg.num_layers) + 1,
                "layer_norm_bwd": 2 * cfg.num_layers + 1,
                "flash_fwd": 2 * cfg.num_layers, "flash_bwd": cfg.num_layers}
    want = {k: n * AMP_STEPS for k, n in per_step.items()}
    if launches != want:
        failures.append(f"22c launches {launches} != {want}")
    if set(ldt.get("layer_norm_fwd", {})) != {"bfloat16"}:
        failures.append(f"22c K1 operand dtypes {ldt}")
    log(f"  22c O2: params {dtypes}, masters {master}; steps {rows}; "
        f"launches {launches}, dtypes {ldt}")
    del model, params, state
    torch.cuda.empty_cache()
    return {"param_dtypes": dtypes, "master_dtypes": master, "steps": rows,
            "launches": launches, "launch_dtypes": ldt}, failures


def _phase22d(root):
    """22d: O2 with the dynamic scaler growing every AMP_GROWTH_INTERVAL
    clean steps, on 22c's model: 4 uninterrupted steps (twice: the same
    bits) against 2 steps, ``snapshot_training_state(..., amp_handle=,
    amp_state=)`` saved, a fresh state restored from it
    (``restore_training_state``; it must equal the saved state) and 2
    more steps: parameters, masters, moments, count and the scaler's
    loss scale, growth tracker and hysteresis equal bit for bit.  (The
    first card run of this check found the restored step count on the
    host, which changed the resumed update's arithmetic: ``AmpHandle.
    init`` now puts it on the device.)"""
    import torch

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import GptConfig

    cfg = GptConfig(num_layers=P16_GPT_LAYERS, remat=True)
    args = train_gpt.parse_args(["--batch", str(TRAIN_BATCH), "--seq-len",
                                 str(TRAIN_SEQ)])
    batches = _gpt_batches(args, cfg, AMP_STEPS)

    def fresh():
        model, loss_fn, params, handle, _ = _amp_gpt(cfg, "O2",
                                                     loss_scale="dynamic")
        handle.scaler.growth_interval = AMP_GROWTH_INTERVAL
        return model, loss_fn, params, handle, handle.init(params)

    saved = {}

    def run(resume_at=None):
        """The run's final (params, state) and the save/restore seconds.
        The first run keeps its state at the resume step, which the
        resumed run's restored state must equal before it steps on."""
        model, loss_fn, params, handle, state = fresh()
        seconds = {}
        for step, ids in enumerate(batches):
            if resume_at is None and step == AMP_STEPS // 2 and not saved:
                saved["state"] = ({k: v.clone() for k, v in params.items()},
                                  _clone_tree(state))
            if step == resume_at:
                path = os.path.join(root, "amp_ckpt")
                snap = ckpt.snapshot_training_state(
                    params, state.opt_state, step=step, amp_handle=handle,
                    amp_state=state, extra={"master": state.master_params})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save_checkpoint(path, snap)
                seconds["save"] = time.perf_counter() - t0
                del model, loss_fn, params, handle, state, snap
                model, loss_fn, params, handle, state = fresh()
                template = ckpt.snapshot_training_state(
                    params, state.opt_state, step=0, amp_handle=handle,
                    amp_state=state, extra={"master": state.master_params})
                t0 = time.perf_counter()
                restored = ckpt.restore_checkpoint(path, template)
                torch.cuda.synchronize()
                seconds["restore"] = time.perf_counter() - t0
                params, opt, at, state, extra = ckpt.restore_training_state(
                    restored, amp_handle=handle, amp_state=state)
                if at != step:
                    raise AssertionError(f"22d: restored step {at}")
                state = state._replace(opt_state=opt,
                                       master_params=extra["master"])
                try:
                    _amp_state_equal("22d: the restored state", *saved[
                        "state"], params, state)
                except AssertionError as exc:
                    seconds["restore_diff"] = str(exc)
            _, params, state, _ = _amp_step(loss_fn, params, handle, state,
                                            ids)
        return params, state, seconds

    full_p, full_s, _ = run()
    again_p, again_s, _ = run()
    res_p, res_s, seconds = run(resume_at=AMP_STEPS // 2)
    del saved["state"]
    failures = [seconds.pop("restore_diff")] if "restore_diff" in seconds \
        else []
    for tag, (p, st) in (("a second uninterrupted run", (again_p, again_s)),
                         ("the resumed run", (res_p, res_s))):
        try:
            _amp_state_equal(f"22d: {tag}", full_p, full_s, p, st)
        except AssertionError as exc:
            failures.append(str(exc))
    sc = full_s.scaler_state
    out = {"loss_scale": float(sc.loss_scale),
           "growth_tracker": int(sc.growth_tracker),
           "hysteresis": int(sc.hysteresis), "seconds": seconds,
           "bit_identical": not failures}
    if float(sc.loss_scale) <= 2.0 ** 16:
        failures.append(f"22d: the scale never grew ({out})")
    log(f"  22d amp resume: {out}")
    torch.cuda.empty_cache()
    return out, failures


def _phase22e():
    """22e: ``examples.dcgan.main_amp`` for 5 steps on the card (O1):
    its three losses finite."""
    from apex_tpu_torch.examples.dcgan import main_amp

    t0 = time.perf_counter()
    losses = main_amp.main(["--steps", "5"])
    seconds = time.perf_counter() - t0
    log(f"  22e dcgan: {losses} in {seconds:.1f} s")
    failures = []
    if not all(np.isfinite(v).all() and len(v) == 5
               for v in losses.values()):
        failures.append(f"22e: dcgan losses {losses}")
    return {"losses": losses, "seconds": seconds}, failures


def phase22(baseline=None):
    """Amp on the card (the frontend, the O1 cast lists, fp16 masters,
    the amp state through a checkpoint, the DCGAN example): K1/K2 checked
    on f32 rows at the training shape, then 22a-e (their docstrings).
    ``baseline`` is phase 6's run (step ms, tokens/s, MFU, peak memory);
    without one, 4 steps of phase 6's hand loop run here first.  Every
    part logs its readings before any failure fails the phase.  Returns
    (22a's launches, results)."""
    import tempfile

    import torch

    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import GptConfig

    t_start = time.perf_counter()
    log("phase 22: amp — O1 GptConfig(remat=True) over K1-K4, a 2-layer "
        "O1 cross-check, O2 with a planted overflow, the amp state "
        "through a checkpoint, the DCGAN example")
    k1_err, k2_err = _phase22_kernel_checks()
    if baseline is None:
        cfg = GptConfig(remat=True)
        args = train_gpt.parse_args(["--batch", str(TRAIN_BATCH),
                                     "--seq-len", str(TRAIN_SEQ)])
        layers = cfg.num_layers
        per_step = {"layer_norm_fwd": 2 * (2 * layers) + 1,
                    "layer_norm_bwd": 2 * layers + 1,
                    "flash_fwd": 2 * layers, "flash_bwd": layers}
        baseline = _train_gpt_policy(args, cfg, per_step, steps=AMP_STEPS)
    baseline = {k: baseline[k] for k in ("step_ms_median", "tokens_per_s",
                                         "mfu_6nt", "peak_memory_bytes")
                if k in baseline}
    launches, out_a, failures = _phase22a(baseline)
    out = {"kernel_checks": {"layer_norm_fwd_f32": k1_err,
                             "layer_norm_bwd_f32": k2_err},
           "o1_gpt": out_a}
    out["o1_cross_check"], f = _phase22b()
    failures += f
    out["o2_overflow"], f = _phase22c()
    failures += f
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_phase22_") as d:
        out["amp_resume"], f = _phase22d(d)
    failures += f
    out["dcgan"], f = _phase22e()
    failures += f
    out["seconds"] = time.perf_counter() - t_start
    log(f"  phase 22 took {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 22: " + "; ".join(failures))
    return launches, out


# ---------------------------------------------------------------------------
# phase 23: the serving engine's build checks, the kernels' launch plans
# against the card, the tuning cache, the serving example
# ---------------------------------------------------------------------------

#: 23a: the budgets around the largest estimate: 10% under must fail the
#: build with memory-budget, 10% over must build
P23_BUDGET_UNDER, P23_BUDGET_OVER = 0.9, 1.1
#: memstats.crosscheck's tolerance (the reference's default)
P23_DRIFT_TOL = 0.25
#: 23b: the 2-layer engine the planted faults are built on (GptConfig()'s
#: width, phase 2's seed)
P23_FAULT_LAYERS = 2
#: 23d: the shape the tuning cache names a variant for, the one it does
#: not, and the variants (the sweep's bk64 s2 for K3, s2 for K4; a K3
#: whose 96-key stage fails its static_assert)
P23_TUNED = (16, 512, 64)
P23_UNTUNED = (16, 256, 64)
P23_VARIANTS = {"fwd": ("APEX_FLASH_FWD_BLOCK_K=64", "APEX_FLASH_FWD_STAGES=2"),
                "bwd": ("APEX_FLASH_BWD_STAGES=2",)}
P23_BAD_VARIANT = ("APEX_FLASH_FWD_BLOCK_K=96",)
#: the pending builds of P23_VARIANTS (started in main)
VARIANT_BUILDS = []


def ptxas_table(text, nvcc):
    """``{demangled instance: {"regs", "smem"}}`` of an ``nvcc -Xptxas -v``
    log (the names as ``ptxas_summary`` prints them)."""
    import re

    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), int(sm.group(1)) if sm else 0))
            name = None
    names = [r[0] for r in rows]
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if names and os.path.exists(filt):
        res = subprocess.run([filt, *names], capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            names = [n.split(">(")[0].removeprefix("void ") + ">"
                     for n in res.stdout.splitlines()]
    return {_plain_name(n): {"regs": r, "smem": sm}
            for n, (_, r, sm) in zip(names, rows)}


def _plain_name(name):
    """A demangled instance as the launch plans name it: no namespace,
    ``(int)64`` as 64, ``(bool)0``/``(bool)1`` as false/true."""
    import re

    name = re.sub(r"\(int\)(-?\d+)", r"\1", name)
    name = re.sub(r"\(bool\)0", "false", name)
    name = re.sub(r"\(bool\)1", "true", name)
    for ns in ("<unnamed>::", "(anonymous namespace)::"):
        name = name.replace(ns, "")
    return name


def _p23_engine(layers=None, **serve_kw):
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = GptConfig()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = GptModel(cfg, generator=torch.Generator("cuda").manual_seed(1234))
    serve = ServeConfig(page_size=16, max_batch=8, max_pages_per_seq=128,
                        num_pages=1025, **serve_kw)
    return cfg, InferenceEngine(cfg, model, serve)


def _p23_free():
    """Return the memory of the engines just dropped to the card."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _p23_serve(engine, cfg):
    """Phase 2's 8 requests through a new scheduler: the streams and the
    launches (zeroed just before, read just after)."""
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.serve import ContinuousBatchingScheduler, Request

    rs = np.random.RandomState(0)
    sched = ContinuousBatchingScheduler(engine)
    reqs = [sched.submit(Request(
        prompt=[int(t) for t in rs.randint(0, cfg.vocab_size, size=n)],
        max_new_tokens=NEW_TOKENS)) for n in PROMPT_LENS]
    p0, d0 = engine.prefill_calls, engine.decode_iters
    _dispatch.reset_launches()
    sched.run()
    launches = _dispatch.launches()
    n_prefill, n_decode = engine.prefill_calls - p0, engine.decode_iters - d0
    want = {"layer_norm_fwd": (2 * cfg.num_layers + 1) * (n_prefill + n_decode),
            "flash_fwd": cfg.num_layers * n_prefill,
            "paged_decode": cfg.num_layers * n_decode}
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    for r in reqs:
        if r.status != "done" or len(r.tokens) != NEW_TOKENS:
            raise AssertionError(f"request ended {r.status} ({r.shed_reason})")
    sched.leak_check()
    return [r.tokens for r in reqs], launches


def _phase23a(streams=None):
    import torch

    from apex_tpu_torch.observability import memstats
    from apex_tpu_torch.ops import _dispatch

    log("phase 23a: GptConfig() built with verify=True (phase 2's weights)")
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    # the build time without the checks, then with them
    cfg, plain = _p23_engine(verify=False)
    t = time.perf_counter()
    plain.build()
    torch.cuda.synchronize()
    out["build_s_verify_off"] = time.perf_counter() - t
    plain_streams, _ = _p23_serve(plain, cfg)
    if streams is not None and plain_streams != streams:
        raise AssertionError("the unverified engine's streams differ from "
                             "phase 2's")
    streams = plain_streams
    del plain
    _p23_free()
    _dispatch.reset_launches()
    cfg, engine = _p23_engine(verify=True)
    t = time.perf_counter()
    engine.build()
    torch.cuda.synchronize()
    out["build_s_verify_on"] = time.perf_counter() - t
    build_launches = _dispatch.launches()
    if build_launches:
        raise AssertionError(f"the build counted launches {build_launches}")
    log(f"  build {out['build_s_verify_off']:.2f} s without the checks, "
        f"{out['build_s_verify_on']:.2f} s with them")
    programs = {}
    for name, report in sorted(engine.reports.items()):
        est = report.sections["peak_hbm_bytes"]
        meas = engine.measured[name]
        args = sum(b.nbytes for b in engine.records[name].argument_buffers())
        ratio = est / meas["peak"]
        transient = (est - args) / max(meas["peak"] - meas["before"], 1)
        programs[name] = dict(errors=len(report.errors()),
                              rules=report.rule_ids(), estimate=est,
                              measured_peak=meas["peak"],
                              measured_before=meas["before"], ratio=ratio,
                              transient_ratio=transient,
                              recorded_ops=len(engine.records[name].ops),
                              run_ms=report.sections["recorded_run_ms"])
        log(f"  {name}: {len(report.errors())} ERROR, estimate {est} B vs "
            f"max_memory_allocated {meas['peak']} B: ratio {ratio:.4f} "
            f"(the step's own: {transient:.4f}); {len(engine.records[name].ops)} "
            f"ops recorded in {report.sections['recorded_run_ms']:.1f} ms")
        if report.errors():
            raise AssertionError(f"{name}: {report.render()}")
    out["programs"] = programs
    want_programs = {f"prefill_{b}" for b in engine.serve.buckets()} | {"decode"}
    if set(programs) != want_programs:
        raise AssertionError(f"programs {sorted(programs)} != {sorted(want_programs)}")
    # serving with the checked engine: phase 2's streams, its launches
    got, launches = _p23_serve(engine, cfg)
    if got != streams:
        raise AssertionError("the verified engine's streams differ from "
                             "the unverified engine's")
    out["launches"] = launches
    # the allocator's live peak against the estimates (the engine's
    # programs over what the process held before the engine existed)
    monitor = memstats.MemStatsMonitor(memstats.DeviceMemoryProvider())
    torch.cuda.reset_peak_memory_stats()
    got2, _ = _p23_serve(engine, cfg)
    monitor.sample()
    static = {n: p["estimate"] + baseline for n, p in programs.items()}
    drift = monitor.crosscheck(static, tolerance=P23_DRIFT_TOL)
    live = monitor.live_peaks()["device0"]
    out["memstats"] = dict(live_peak=live, baseline=baseline,
                           largest_estimate=max(static.values()),
                           ratio=live / max(static.values()),
                           findings=drift)
    log(f"  memstats: live peak {live:.0f} B against the largest estimate "
        f"{max(static.values())} B (with {baseline} B held before): "
        f"{out['memstats']['ratio']:.4f}, {len(drift)} drift findings")
    if drift or got2 != streams:
        raise AssertionError(f"memstats drift {drift}")
    top = max(p["estimate"] for p in programs.values())
    del engine
    _p23_free()
    # the budget gate
    for factor, must_fail in ((P23_BUDGET_UNDER, True),
                              (P23_BUDGET_OVER, False)):
        budget = int(top * factor)
        cfg, gated = _p23_engine(verify=True, hbm_budget_bytes=budget)
        t = time.perf_counter()
        try:
            gated.build()
            failed = None
        except RuntimeError as exc:
            failed = str(exc)
        build_s = time.perf_counter() - t
        log(f"  budget {budget} B ({factor}x the largest estimate): "
            + ("build failed" if failed else "built") + f" in {build_s:.2f} s")
        if must_fail and (failed is None or "memory-budget" not in failed):
            raise AssertionError(f"a budget under the estimate built: {failed}")
        if not must_fail and failed is not None:
            raise AssertionError(f"a budget over the estimate failed: {failed}")
        out[f"budget_{factor}"] = {"budget": budget, "build_s": build_s,
                                   "failed": bool(failed)}
        del gated
        _p23_free()
    return out


def _phase23b():
    """Planted faults on the card: each must be caught by its rule, and
    the sound build beside it must read clean."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch import analysis
    from apex_tpu_torch.serve import model as model_lib

    log("phase 23b: planted faults on a 2-layer GptConfig() engine")
    real = model_lib.prefill_body

    def with_item(*a, **k):
        out = real(*a, **k)
        float(out[0].float().sum())  # a host read inside the body
        return out

    def pool_copy(cfg, weights, kv_pages, *a, **k):
        copy = {n: t.clone() for n, t in kv_pages.items()}
        return real(cfg, weights, copy, *a, **k)

    out = {}
    for tag, body, rule in (("sound", real, None),
                            ("item", with_item, "transfer-hlo-host"),
                            ("pool_copy", pool_copy, "donation-dropped")):
        cfg, engine = _p23_engine(layers=P23_FAULT_LAYERS, verify=True,
                                  prefill_buckets=(64,))
        model_lib.prefill_body = body
        try:
            engine.build()
            failed = None
        except RuntimeError as exc:
            failed = str(exc)
        finally:
            model_lib.prefill_body = real
        log(f"  {tag}: " + ("clean" if failed is None else
                            f"caught: {failed.splitlines()[1].strip()[:160]}"))
        out[tag] = failed is None or failed.splitlines()[1].strip()
        if rule is None and failed is not None:
            raise AssertionError(f"the sound engine failed its checks: {failed}")
        if rule is not None and (failed is None or rule not in failed):
            raise AssertionError(f"{tag} was not caught as {rule}: {failed}")
        del engine
        _p23_free()
    # an f32 widening in a bf16 layer
    g = torch.Generator("cuda").manual_seed(7)
    w1 = (0.02 * torch.randn(4096, 1024, generator=g, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(1024, 4096, generator=g, device="cuda")).bfloat16()
    b1 = torch.zeros(4096, device="cuda", dtype=torch.bfloat16)
    f32_bias = torch.zeros(4096, device="cuda")
    x = torch.randn(2048, 1024, generator=g, device="cuda").bfloat16()

    def layer(x):
        return F.linear(F.gelu(F.linear(x, w1, b1)), w2)

    def widened(x):
        return F.linear(F.gelu(F.linear(x, w1, b1) + f32_bias).bfloat16(), w2)

    for tag, fn, want in (("layer_sound", layer, []),
                          ("layer_widened", widened, ["promotion-widen"])):
        report = analysis.check(fn, x, policy=torch.bfloat16, name=tag)
        log(f"  {tag}: {report.rule_ids()}")
        out[tag] = report.rule_ids()
        if report.rule_ids() != want:
            raise AssertionError(f"{tag}: {report.render()}")
    return out


def phase23c(signatures):
    """Every kernel instance the run launched (``signatures``: its
    distinct launches): its launch plan (``kernel_specs``) against the
    card's own figures (the query of ``csrc/launch_query.cuh``), and the
    registers against ptxas's (the build log of this process)."""
    import torch

    from apex_tpu_torch.analysis import kernels
    from apex_tpu_torch.ops import _build, _dispatch

    t0 = time.perf_counter()
    tables = {}

    def table(entry, defines):
        key = (_build.library(entry), tuple(defines))
        if key not in tables:
            tables[key] = ptxas_table(_build.build_log(*key), _build._nvcc())
        return tables[key]

    log(f"phase 23c: {len(signatures)} distinct launches' plans against the "
        "card's figures")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind = torch.cuda.get_device_name(0)
    seen, rows, bad = set(), [], []
    for (kernel, defines, sig), n in sorted(signatures.items(),
                                            key=lambda kv: repr(kv[0])):
        specs = kernels.specs_from_launch(kernel, sig, defines)
        key = (kernel, defines, tuple((s.full_name, s.smem_bytes, s.grid)
                                      for s in specs))
        if key in seen:
            continue
        seen.add(key)
        got = _dispatch.query(kernel, sig, 0, defines)
        if len(got) != len(specs):
            bad.append(f"{kernel} {sig}: {len(got)} launches, the plan "
                       f"{len(specs)}")
            continue
        for spec, q in zip(specs, got):
            ptx_table = table(spec.entry, defines)
            name = next((n for n in ptx_table
                         if n == spec.full_name
                         or n.endswith("::" + spec.full_name)), None)
            ptx = ptx_table.get(name)
            if ptx is None:
                bad.append(f"{spec.full_name}: not in the build log")
                continue
            occ = kernels.occupancy(spec, ptx["regs"], ptx["smem"], kind)
            row = dict(kernel=kernel, instance=spec.full_name,
                       defines=list(defines), launches=n,
                       smem_plan=spec.smem_bytes, smem_card=q["dyn_smem"],
                       static_smem_ptxas=ptx["smem"],
                       static_smem_card=q["static_smem"],
                       occupancy_plan=occ, occupancy_card=q["ctas_per_sm"],
                       regs_ptxas=ptx["regs"], regs_card=q["regs"],
                       grid_plan=spec.grid, grid_card=q["grid"],
                       threads_plan=spec.threads, threads_card=q["threads"])
            rows.append(row)
            if (spec.smem_bytes != q["dyn_smem"] or occ != q["ctas_per_sm"]
                    or ptx["regs"] != q["regs"] or spec.grid != q["grid"]
                    or spec.threads != q["threads"]):
                bad.append(f"{spec.full_name} {sig}: {row}")
    by_inst = sorted({r["instance"] for r in rows})
    log(f"  {len(rows)} launches of {len(by_inst)} instances checked, "
        f"{len(bad)} disagree, in {time.perf_counter() - t0:.1f} s")
    for r in rows[:400]:
        log(f"  {r['instance']}{' ' + str(r['defines']) if r['defines'] else ''}: "
            f"smem {r['smem_plan']}/{r['smem_card']}, CTAs/SM "
            f"{r['occupancy_plan']}/{r['occupancy_card']}, regs "
            f"{r['regs_ptxas']}/{r['regs_card']}, grid {r['grid_plan']}/"
            f"{r['grid_card']}")
    for b in bad:
        log(f"  DISAGREES: {b}")
    if bad:
        raise AssertionError(f"{len(bad)} launch plans disagree with the card")
    return {"launches_checked": len(rows), "instances": by_inst}


def _phase23d(gen, tmp):
    """A tuning cache naming a non-default K3/K4 variant for one shape."""
    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import attention as attn
    from apex_tpu_torch.ops import tune_cache

    log("phase 23d: a tuning cache naming K3/K4 variants for one shape")
    bh, s, d = P23_TUNED
    path = os.path.join(tmp, "tune.json")
    tune_cache.update_flash(path, sq=s, d=d, causal=True,
                            defines={m: list(v) for m, v in
                                     P23_VARIANTS.items()},
                            dtype="bfloat16",
                            backend=torch.cuda.get_device_name(0))
    old = os.environ.get(tune_cache.ENV_VAR)
    os.environ[tune_cache.ENV_VAR] = path
    tune_cache.reset()
    out = {}
    try:
        for tag, (bh_, s_, d_) in (("tuned", P23_TUNED),
                                   ("untuned", P23_UNTUNED)):
            q, k, v = attn_inputs(bh_, s_, s_, d_, gen)
            do = torch.randn(bh_, s_, d_, generator=gen,
                             device="cuda").to(torch.bfloat16)
            kw = dict(scale=d_ ** -0.5, causal=True)
            _dispatch.reset_launches()
            o = attn.flash_fwd(q, k, v, **kw)
            ref = attn.flash_fwd_reference(q, k, v, **kw)
            check_k3(f"23d {tag}", o, ref)
            delta = (do.float() * o[0].float()).sum(-1)
            grads = attn.flash_bwd(q, k, v, do, o[2], o[3], delta, **kw)
            want = attn.flash_bwd_reference(q, k, v, do, ref[2], ref[3],
                                             delta, **kw)
            check_k4(f"23d {tag}", grads, want)
            variants = {kk: {"+".join(dd): n for dd, n in by.items()}
                        for kk, by in _dispatch.launch_variants().items()}
            launches = _dispatch.launches()
            log(f"  {tag} (BH={bh_} S={s_} D={d_}): launches {launches}, "
                f"variants {variants}")
            expect = ({"flash_fwd": {"+".join(P23_VARIANTS["fwd"]): 1},
                       "flash_bwd": {"+".join(P23_VARIANTS["bwd"]): 1}}
                      if tag == "tuned" else {})
            if variants != expect or launches != {"flash_fwd": 1,
                                                  "flash_bwd": 1}:
                raise AssertionError(f"{tag}: variants {variants} != {expect}")
            out[tag] = variants
        # a variant that cannot build raises: no fallback to the default
        tune_cache.update_flash(path, sq=s, d=d, causal=True,
                                defines={"fwd": list(P23_BAD_VARIANT)},
                                dtype="bfloat16",
                                backend=torch.cuda.get_device_name(0))
        q, k, v = attn_inputs(bh, s, s, d, gen)
        try:
            attn.flash_fwd(q, k, v, scale=d ** -0.5, causal=True)
            raised = None
        except RuntimeError as exc:
            raised = str(exc).splitlines()[0]
        log(f"  a variant that cannot build ({P23_BAD_VARIANT}): "
            f"{raised or 'did not raise'}")
        if raised is None or "nvcc failed" not in raised:
            raise AssertionError("the unbuildable variant did not raise")
        out["bad_variant_raised"] = raised
    finally:
        if old is None:
            os.environ.pop(tune_cache.ENV_VAR, None)
        else:
            os.environ[tune_cache.ENV_VAR] = old
        tune_cache.reset()
    return out


def _phase23e(tmp):
    """``examples/serve_gpt.py`` end to end, its JSONL checked."""
    from apex_tpu_torch.examples import serve_gpt

    log("phase 23e: serve_gpt end to end (train, restore, verify, serve)")
    jsonl = os.path.join(tmp, "serve.jsonl")
    engine, sched = serve_gpt.main(["--dir", os.path.join(tmp, "serve_gpt"),
                                    "--metrics-out", jsonl])
    errors = {n: len(r.errors()) for n, r in engine.reports.items()}
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    keys = {"metric", "value", "unit", "vs_baseline", "step"}
    bad = [r for r in records if set(r) < keys]
    metrics = {r["metric"] for r in records}
    log(f"  {len(sched.completed)} served, ERRORs {errors}; {len(records)} "
        f"JSONL records, {len(metrics)} metrics")
    for need in ("serve/ttft_ms", "serve/peak_hbm_bytes"):
        if need not in metrics:
            raise AssertionError(f"the JSONL lacks {need}")
    if bad or any(errors.values()) or len(sched.completed) != 6:
        raise AssertionError(f"serve_gpt: {bad[:3]} {errors}")
    return {"records": len(records), "served": len(sched.completed),
            "errors": errors}


def phase23(gen, streams=None):
    """The serving build checks (23a), planted faults (23b), the tuning
    cache (23d), serve_gpt (23e); 23c (:func:`phase23c`) runs last, over
    the distinct launches of the whole run."""
    import tempfile

    t0 = time.perf_counter()
    for build in VARIANT_BUILDS:
        build.result()
    log(f"phase 23: 23d's variants built (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    out = {"23a": _phase23a(streams), "23b": _phase23b()}
    with tempfile.TemporaryDirectory() as tmp:
        out["23d"] = _phase23d(gen, tmp)
        out["23e"] = _phase23e(tmp)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 23 (but 23c) in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 24: observation and the fleet (the rest of ROADMAP item 8)
# ---------------------------------------------------------------------------


#: 24a: the training steps (0..P24_STEPS-1) and the profiler window armed
#: through APEX_TPU_TRACE_STEPS ("start+length")
P24_STEPS = 8
P24_WINDOW = "2+2"
#: 24a: the attribution's compute time against the summed kernel
#: durations of the same trace (both from the one trace: they differ by
#: the copies and memsets only)
P24_COMPUTE_TOL = 0.05
#: kernels a launch of each entry runs (a K4 launch is its dK/dV pass,
#: then its dQ pass), and the KERNEL_GROUPS layer its kernels count under
P24_KERNELS = {"layer_norm_fwd": (1, "K1 layer_norm_fwd"),
               "layer_norm_bwd": (1, "K2 layer_norm_bwd"),
               "flash_fwd": (1, "K3 flash_fwd"),
               "flash_bwd": (2, "K4 flash_bwd")}
#: 24b: the example's chaos storm over P24B_STEPS steps (30 since phase
#: 26 joined the script, with the preemption at 21 and the window at
#: steps 12-14; 60, 42 and 20-22 before), and what its two invocations'
#: final train/goodput records must carry (a CPU run of the example and
#: the reference's own give these counts)
P24B_STEPS = 30
P24B_WINDOW = (12, 3)
P24_CHAOS = "grads:nan@7,8;checkpoint_save:raise:x1@5;preemption@21"
P24_GOODPUT = (
    dict(accepted=20, skipped=2, discarded=0, rollbacks=0, retries=1,
         resumes=0, preempted=True),
    dict(accepted=8, skipped=0, discarded=0, rollbacks=0, retries=0,
         resumes=1, preempted=False),
)
#: the span and flight dumps phase 24 leaves for 26e's timeline (kept in
#: a directory of their own until the script exits)
P24_DUMPS = {}
#: 24c: the fleet drill's flags (the reference drill's storm and pool,
#: at most 3 replicas), and the ledgers (every request's status, shed
#: reason, retries and TTFT in ticks) a CPU run of the same drill gives
#: (``python -m apex_tpu_torch.tools.fleet_drill --device cpu
#: --max-replicas 3 --vocab 50304``, at 2 layers of 32 or of 1024 wide):
#: no scheduler decision reads a token value
P24C_FLAGS = ("--max-replicas", "3", "--vocab", "50304")
P24C_CPU_LEDGERS = {"reference": "6c2d3fb22d6b55bb",
                    "storm": "db63d45ced15a246"}
#: 24d: the canary drill's flags (one clean seed; the planted-fault run
#: needs only the regression)
P24D_FLAGS = ("--vocab", "50304", "--clean-seeds", "1", "--requests", "100")
P24D_FAULT_FLAGS = ("--vocab", "50304", "--clean-seeds", "0",
                    "--requests", "100")
#: 24c and 24d: GptConfig()'s width at 6 of its 12 layers (the depth cut
#: that made room for phase 26, as phase 15's; no decision of either
#: drill reads a token value, and the launch counts follow the depth)
P24_DRILL_LAYERS = 6


def _phase24a():
    """A profiler window over GPT training (phase 18a's trainer at
    ``GptConfig(remat=True)``, batch 8 x 2048, steps 0..7, the window
    armed by APEX_TPU_TRACE_STEPS="2+2"; 8 steps): the trace's K1-K4 kernel events
    against the launch counters over the same two steps, the
    attribution's compute time against the summed kernel durations, the
    fractions, ``trace_step_period`` beside the steps outside the window,
    then ``Watchdog(default_rules())`` over the run's meter and goodput
    with the MFU floor above the measured MFU (fires) and below it
    (quiet)."""
    import tempfile

    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.observability import (
        GoodputAccountant,
        StepMeter,
        TraceScheduler,
        Watchdog,
        board,
        default_rules,
        peak_flops_for,
    )
    from apex_tpu_torch.observability import attribution as attr
    from apex_tpu_torch.observability import trace as tr
    from apex_tpu_torch.ops import _dispatch

    args = _gpt_args([])
    cfg = train_gpt.config(args)
    batches = _gpt_batches(args, cfg, P24_STEPS)
    model, trainer, loss_fn, params = _gpt_trainer(cfg, 1)
    step = trainer.build(loss_fn, params, batches[0])
    del params
    n_params = step.n_params()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    meter = StepMeter(tokens_per_step=tokens,
                      flops_per_step=6.0 * n_params * tokens,
                      peak_flops=peak_flops_for(torch.cuda.get_device_name(0)))
    goodput = GoodputAccountant()
    out = {}
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_p24a_") as tmp:
        env = {tr.ENV_TRACE_STEPS: P24_WINDOW, tr.ENV_TRACE_DIR: tmp}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            sched = TraceScheduler()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        st, step_ms, window = step.state, [], {}
        torch.cuda.synchronize()
        meter.tick()
        for i, b in enumerate(batches):
            if i == sched.end + 1:
                window["after"] = _dispatch.launches()
            sched.on_step(i)
            if i == sched.start:
                window["before"] = _dispatch.launches()
            t0 = time.perf_counter()
            st, aux = step(st, b)
            float(aux["loss"])
            step_ms.append(1e3 * (time.perf_counter() - t0))
            meter.tick()
            goodput.on_step(i, skipped=False)
        sched.stop()
        trace = attr.load_trace_dir(sched.log_dir)
    in_window = {k: window["after"].get(k, 0) - window["before"].get(k, 0)
                 for k in P24_KERNELS}
    meas = attr.attribute_trace(trace)
    events = {k: meas.kernel_events.get(layer, 0)
              for k, (_, layer) in P24_KERNELS.items()}
    want_events = {k: per * in_window[k]
                   for k, (per, _) in P24_KERNELS.items()}
    kernel_ms = sum(float(e["dur"]) for e in attr.device_events(trace)
                    if e.get("cat") == "kernel") / 1e3
    period_ms = 1e3 * attr.trace_step_period(trace)
    # a step outside the window: neither the first step nor the one after
    # the window (it follows the trace's export)
    outside = [ms for i, ms in enumerate(step_ms)
               if not sched.start <= i <= sched.end + 1 and i > 0]
    outside_ms = statistics.median(outside)
    fr = attr.publish_attribution(meas)
    mfu = meter.mfu
    wd_fire = Watchdog(default_rules(mfu_floor={"floor": 2.0 * mfu,
                                                "warmup_steps": 2}),
                       meter=meter, goodput=goodput, check_every=1)
    wd_quiet = Watchdog(default_rules(mfu_floor={"floor": 0.5 * mfu,
                                                 "warmup_steps": 2}),
                        meter=meter, goodput=goodput, check_every=1)
    fired = [e.rule for e in wd_fire.check(P24_STEPS)]
    quiet = [e.rule for e in wd_quiet.check(P24_STEPS)]
    board.clear()
    log(f"  24a: window steps {sched.start}..{sched.end}: launches "
        f"{in_window}, kernel events {events} (want {want_events}); "
        f"{meas.events} device events, source {meas.source}; compute "
        f"{meas.compute_ms:.3f} ms against {kernel_ms:.3f} ms of kernels; "
        f"fractions {fr}; buckets {meas.bucket_fractions()}; layers "
        f"{meas.layer_ms}; trace step period {period_ms:.3f} ms against "
        f"{outside_ms:.3f} ms a step outside the window (steps {step_ms}; "
        f"the profiler's cost a step {period_ms - outside_ms:.3f} ms); MFU "
        f"{mfu:.4f}; floor 2x MFU fires {fired}, floor MFU/2 {quiet}")
    failures = []
    if events != want_events or not all(in_window.values()):
        failures.append(f"kernel events {events} != launches {want_events}")
    if abs(meas.compute_ms - kernel_ms) > P24_COMPUTE_TOL * kernel_ms:
        failures.append(f"compute {meas.compute_ms} ms vs kernels "
                        f"{kernel_ms} ms")
    if meas.source != "device-ops" or period_ms <= 0:
        failures.append(f"source {meas.source}, period {period_ms}")
    if "mfu_floor" not in fired or "mfu_floor" in quiet:
        failures.append(f"mfu_floor fired {fired}, its twin {quiet}")
    out.update(launches=in_window, kernel_events=events,
               device_events=meas.events, compute_ms=meas.compute_ms,
               kernel_ms=kernel_ms, fractions=fr,
               bucket_fractions=meas.bucket_fractions(),
               layer_ms=meas.layer_ms, trace_period_ms=period_ms,
               step_ms=step_ms, outside_ms=outside_ms,
               profiler_cost_ms=period_ms - outside_ms, mfu=mfu,
               fired=fired, quiet=quiet)
    del model, trainer, step, st, batches
    ps.destroy_model_parallel()
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("24a: " + "; ".join(failures))
    return out


def _phase24a_process():
    """24a in a process of its own (``--trace-window``), its log relayed:
    after the whole script's earlier phases had profiled in this process,
    kineto's traces of the window lacked one layer's forward kernels in
    four whole runs of five on the H100, never in a process that had not
    traced before."""
    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py"),
         "--trace-window"], cwd=root, capture_output=True, text=True,
        timeout=900, env=dict(os.environ, PYTHONPATH=root))
    lines = p.stdout.splitlines()
    for line in lines[:-1]:
        log(f"  [24a] {line}")
    if p.returncode != 0:
        raise AssertionError(f"24a exited {p.returncode}:\n"
                             + p.stdout[-3000:] + p.stderr[-3000:])
    return json.loads(lines[-1])["24a"]


def _p24b_goodput(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    (final,) = [r for r in recs
                if r["metric"] == "train/goodput" and "accepted" in r]
    return final


def _keep_dump(kind, path):
    """Copy a dump into the script's keep directory for 26e."""
    import atexit
    import shutil
    import tempfile

    if "_dir" not in P24_DUMPS:
        P24_DUMPS["_dir"] = tempfile.mkdtemp(prefix="apex_tpu_torch_dumps_")
        atexit.register(shutil.rmtree, P24_DUMPS["_dir"], True)
    dst = os.path.join(P24_DUMPS["_dir"],
                       f"{kind}_{len(P24_DUMPS)}_{os.path.basename(path)}")
    shutil.copy(path, dst)
    P24_DUMPS.setdefault(kind, []).append(dst)


def _phase24b():
    """``examples/train_resilient.py`` on the card as a subprocess under
    the chaos storm (NaN steps 7 and 8, a save fault healed by its
    retry, a preemption at step 21) with a profiler window, then the
    same command again: it resumes and finishes; both final
    ``train/goodput`` records carry the exact counts.  The preempted
    run's flight dump is kept for 26e."""
    import glob
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    start, length = P24B_WINDOW
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_p24b_") as tmp:
        env = dict(os.environ, APEX_TPU_CHAOS=P24_CHAOS,
                   APEX_TPU_TRACE_STEPS=f"{start}+{length}:{tmp}/trace",
                   PYTHONPATH=root)
        finals = []
        for i in range(2):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m",
                 "apex_tpu_torch.examples.train_resilient", "--steps",
                 str(P24B_STEPS), "--dir", f"{tmp}/run", "--metrics-out",
                 f"{tmp}/m{i}.jsonl"],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=300)
            secs = time.perf_counter() - t0
            lines = [ln for ln in p.stdout.splitlines()
                     if ln.startswith(("done:", "trace attribution",
                                       "final loss", "ckpt:"))]
            log(f"  24b run {i}: exit {p.returncode} in {secs:.1f} s: "
                + " | ".join(lines))
            if p.returncode != 0:
                raise AssertionError(f"24b run {i} exited {p.returncode}:\n"
                                     + p.stdout[-3000:] + p.stderr[-3000:])
            finals.append(_p24b_goodput(f"{tmp}/m{i}.jsonl"))
            out[f"run{i}_s"] = secs
        traced = os.listdir(os.path.join(
            f"{tmp}/trace", f"steps_{start:06d}_{start + length - 1:06d}"))
        for path in sorted(glob.glob(f"{tmp}/run/flight/flight_*.json")):
            _keep_dump("flight", path)
    got = [{k: f[k] for k in P24_GOODPUT[0]} for f in finals]
    out.update(goodput=got, trace_files=traced)
    if got != list(P24_GOODPUT) or len(traced) != 1:
        raise AssertionError(f"24b: goodput {got} != {P24_GOODPUT} "
                             f"(trace files {traced})")
    return out


def _p24_configs(model):
    """The drills' ``configs``: ``GptConfig()`` (bf16) and the drill's
    page pool on bf16 KV pages."""
    from apex_tpu_torch.serve import ServeConfig

    def configs(a):
        return model.cfg, ServeConfig(
            page_size=a.page_size, num_pages=a.pages, max_batch=a.batch,
            max_pages_per_seq=a.pages_per_seq)

    return configs


def _p24_params(model):
    """The drills' ``params_fn``: key 1 is phase 2's seeded model, every
    other key a model seeded with the key."""
    import torch

    from apex_tpu_torch.models import GptModel

    def params_fn(a, key, configs):
        if key == 1:
            return model
        return GptModel(model.cfg,
                        generator=torch.Generator("cuda").manual_seed(key))

    return params_fn


def _p24_launch_check(tag, engines, layers, launches):
    want = _serving_want(engines, layers)
    per_replay = {"layer_norm_fwd": 2 * layers + 1, "paged_decode": layers}
    bad = [e.graph_launches for e in engines
           if e.decode_iters and e.graph_launches != per_replay]
    if launches != want or min(want.values()) <= 0 or bad:
        raise AssertionError(f"{tag}: launches {launches} != {want} "
                             f"(replays {bad})")
    return want


def _p24_graph_trace(engine):
    """Three replays of ``engine``'s captured decode step (idle slots)
    under a profiler window: whether kineto records the kernels a
    CUDA-graph replay runs, or only its ``cudaGraphLaunch``."""
    import tempfile

    from apex_tpu_torch.observability import attribution as attr
    from apex_tpu_torch.observability import trace as tr
    from apex_tpu_torch.serve.cache import NULL_PAGE

    b = engine.serve.max_batch
    tokens = np.zeros((b,), np.int64)
    lengths = np.zeros((b,), np.int32)
    table = np.full((b, engine.serve.max_pages_per_seq), NULL_PAGE, np.int32)
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_p24g_") as tmp:
        with tr.trace(tmp):
            for _ in range(3):
                engine.decode(tokens, lengths, table)
        meas = attr.attribute_trace_dir(tmp)
    out = dict(graph_launches=meas.graph_launches,
               graph_kernel_events=meas.graph_kernel_events,
               kernel_events=meas.kernel_events, note=meas.graph_note())
    log(f"  24c: three decode graph replays under the profiler: {out}")
    return out


def _phase24c(model):
    """The fleet drill at ``GptConfig()`` (phase 2's seeded weights, bf16
    KV pages, 2 replicas, at most 3; the reference drill's storm and
    pool): its five guarantees, exact K1/K3/K6 launches over every
    engine of both fleets, and its ledgers against the CPU run's."""
    import tempfile

    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.tools import fleet_drill as drill

    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_p24c_") as tmp:
        args = drill.build_parser().parse_args(
            [*P24C_FLAGS, "--spans", f"{tmp}/spans.json"])
        keep = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        art = drill.run_drill(args, configs=_p24_configs(model),
                              params_fn=_p24_params(model), keep=keep)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _dispatch.launches()
        _keep_dump("spans", f"{tmp}/spans.json")
    peak = torch.cuda.max_memory_allocated() - before
    engines = [r.engine for f in (keep["reference_fleet"],
                                  keep["storm_fleet"]) for r in f.replicas]
    failures = drill.check(art, args)
    ledgers = {run: art[run]["ledger_digest"] for run in P24C_CPU_LEDGERS}
    fr = art["fleet_registry"]
    log(f"  24c: {secs:.1f} s; storm {art['storm']['completed']}/"
        f"{art['storm']['offered']} completed over "
        f"{len(art['replicas'])} replicas, reference "
        f"{art['reference']['completed']}/{art['reference']['offered']}; "
        f"p99 TTFT {art['storm']['ttft_ms']['p99']} ms vs "
        f"{art['reference']['ttft_ms']['p99']} ms (inflation "
        f"{art['p99_ttft_inflation']:.3f}); crashes "
        f"{fr['fleet/replica_crashes']} preempts {fr['fleet/preempts']} "
        f"router faults {fr['fleet/router_faults']} scale out "
        f"{fr['fleet/scale_out']} in {fr['fleet/scale_in']}; leaks "
        f"{art['pages']['per_replica_in_use']}; ledgers {ledgers} (CPU run "
        f"{P24C_CPU_LEDGERS}: "
        f"{'equal' if ledgers == P24C_CPU_LEDGERS else 'DIFFERENT'}); "
        f"launches {launches}; {len(engines)} engines; peak "
        f"{peak / 1e9:.3f} GB over the drill")
    if failures:
        raise AssertionError("24c: " + "; ".join(failures))
    want = _p24_launch_check("24c", engines, model.cfg.num_layers, launches)
    graphs = _p24_graph_trace(keep["reference_fleet"].replicas[0].engine)
    out = dict(seconds=secs, terminals=art["terminals"], graph_trace=graphs,
               p99_ttft_inflation=art["p99_ttft_inflation"],
               fleet_registry=fr, replicas=len(art["replicas"]),
               ledgers=ledgers,
               ledgers_equal_cpu=ledgers == P24C_CPU_LEDGERS,
               launches=launches, want=want, peak_bytes=peak,
               deploys=art["deploys"])
    del keep, engines
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def _p24_tensors(weights):
    from apex_tpu_torch.serve.model import PackedParams, PackedWeight

    if isinstance(weights, PackedParams):
        out = []
        for leaf in weights.leaves():
            out += ([leaf.codes, leaf.scale]
                    if isinstance(leaf, PackedWeight) else [leaf])
        return out
    return list(weights.parameters())


def _p24_inplace_redeploy(self, params, draft_params=None):
    """24d's planted fault: a redeploy that copies the new weights into
    the replica's tensors in place — which the fleet's other replicas
    share."""
    import torch

    from apex_tpu_torch.fleetctl import LIVE
    from apex_tpu_torch.serve.model import PackedParams

    if self.sched.prefix is not None:
        self.sched.prefix.flush()
    self.engine.reset_cache()
    new = (params if isinstance(params, PackedParams)
           or getattr(params, "_serving_copy", False)
           else self.engine.prepare_weights(params))
    with torch.no_grad():
        for dst, src in zip(_p24_tensors(self.engine.weights),
                            _p24_tensors(new)):
            dst.copy_(src)
    self.engine.rebuild(full=True)
    self.sched.resume()
    self.state = LIVE
    self.drain_reason = None


def _phase24d(model):
    """The canary drill at ``GptConfig()`` (phase 2's seeded weights,
    3 replicas sharing them): the fingerprint identities, a sound deploy
    passing and rolling to every replica (each fingerprinting as the
    canary's new weights), NaN weights failing with exposure within the
    canary fraction and a rollback whose digest is the incumbent's bit
    for bit, exact K1/K3/K6 launches; then the planted fault (the
    redeploy copying into the shared weights in place), which must fail
    the drill with the incumbents' fingerprints moved."""
    import tempfile

    import torch

    from apex_tpu_torch.fleetctl import EngineReplica
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.tools import canary_drill as drill

    def run(flags, tmp):
        args = drill.build_parser().parse_args(
            [*flags, "--spans", f"{tmp}/spans.json"])
        keep = {}
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        art = drill.run_drill(args, configs=_p24_configs(model),
                              params_fn=_p24_params(model), keep=keep)
        torch.cuda.synchronize()
        engines = [keep["fingerprint_engine"]] + [
            r.engine for k, f in keep.items() if k.startswith("fleet:")
            for r in f.replicas]
        return (args, art, time.perf_counter() - t0, _dispatch.launches(),
                engines)

    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_p24d_") as tmp:
        args, art, secs, launches, engines = run(P24D_FLAGS, tmp)
        _keep_dump("spans", f"{tmp}/spans.json")
        failures = drill.check(args, art)
        want = _serving_want(engines, model.cfg.num_layers)
        del engines
        gc.collect()
        sound = {}
        for label in ("clean[0]", "regression"):
            r = (art["clean_runs"][0] if label != "regression"
                 else art["regression"])
            d = r["deploys"][-1]
            c = d["canary"]
            sound[label] = dict(
                verdict=c.get("verdict"), detect_ticks=c.get("detect_ticks"),
                exposure=c.get("exposure_frac"),
                routed=(c.get("canary_routed"), c.get("routed")),
                tokens=(c.get("tokens_canary"), c.get("tokens_total")),
                lost=d["lost_requests"], completed=r["completed"],
                shed=r["shed_reasons"], ticks=r["ticks"],
                ledger=r["ledger_digest"])
        reg = art["regression"]
        rollback_exact = (reg["deploys"][-1]["canary"].get("rollback_digest")
                          == reg["incumbent_digest"])
        log(f"  24d: {secs:.1f} s; fingerprints {art['fingerprints']['digest'][:16]} "
            f"rebuild exact {art['fingerprints']['rebuild_bit_exact']}, one "
            f"flipped bit moves it {art['fingerprints']['single_bit_flips_digest']}, "
            f"restored {art['fingerprints']['restore_matches']}; {sound}; "
            f"rollback bit for bit {rollback_exact}; launches {launches} "
            f"(want {want})")
        if failures or not rollback_exact:
            raise AssertionError("24d: " + "; ".join(failures))
        if launches != want or min(want.values()) <= 0:
            raise AssertionError(f"24d: launches {launches} != {want}")
        orig = EngineReplica.redeploy
        EngineReplica.redeploy = _p24_inplace_redeploy
        try:
            fargs, fart, fsecs, _, fengines = run(P24D_FAULT_FLAGS, tmp)
        finally:
            EngineReplica.redeploy = orig
        del fengines
        ffail = drill.check(fargs, fart)
        freg = fart["regression"]
        moved = sorted(n for n, dg in freg["post_rollback_digests"].items()
                       if dg != freg["incumbent_digest"])
        log(f"  24d planted fault (in-place redeploy into the shared "
            f"weights): {fsecs:.1f} s; drill failures {ffail}; incumbents "
            f"whose fingerprint moved {moved} of "
            f"{sorted(freg['post_rollback_digests'])}")
        if not ffail or not moved:
            raise AssertionError("24d: the in-place redeploy fault was not "
                                 "caught")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(seconds=secs, fingerprints=art["fingerprints"],
                          runs=sound, rollback_bit_exact=rollback_exact,
                          launches=launches, want=want,
                          fault=dict(seconds=fsecs, failures=ffail,
                                     moved=moved))


def phase24(model=None):
    """Observation and the fleet (ROADMAP item 8's rest): 24a, 24b, 24c,
    24d (see the module docstring); returns (24a's, 24c's and 24d's
    launches, the numbers).  ``model`` is the drills' seeded GptConfig()
    at P24_DRILL_LAYERS (made here when None)."""
    import torch

    from apex_tpu_torch.models import GptConfig, GptModel

    log(f"phase 24: a profiler window over GptConfig(remat=True) training "
        f"(APEX_TPU_TRACE_STEPS={P24_WINDOW}), train_resilient under chaos, "
        f"the fleet drill and the canary drill at GptConfig()")
    t0 = time.perf_counter()
    out = {"24a": _phase24a_process()}
    launches = {"trace_window": out["24a"]["launches"]}
    out["24b"] = _phase24b()
    torch.cuda.empty_cache()
    if model is None:
        model = GptModel(GptConfig(num_layers=P24_DRILL_LAYERS),
                         generator=torch.Generator("cuda").manual_seed(1234))
    launches["fleet"], out["24c"] = _phase24c(model)
    launches["canary"], out["24d"] = _phase24d(model)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 24: {out['seconds']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 25: ResNet-50 and the ImageNet amp example (dp + SyncBatchNorm),
# the fused multihead attention, fmha and the norm modules, the remaining
# optimizers (ROADMAP item 11, first part)
# ---------------------------------------------------------------------------

#: 25a: BASELINE row 1 — examples/imagenet/main_amp.py at ImageNet's size
#: (8 steps a level since phase 26 joined the script, 12 before)
P25_STEPS, P25_BATCH, P25_IMAGE = 8, 128, 224
#: 25b and 25c: the cross-checks' images; 25c's global batch and steps
P25_SMALL_IMAGE = 64
P25_DP_BATCH, P25_DP_STEPS = 32, 3
#: 25d: the width upstream Apex's perf_test_multihead_attn.py sweeps;
#: enc-dec keys
P25_E, P25_H, P25_S, P25_B, P25_SK = 1024, 16, 64, 120, 80
P25_DROPOUT = 0.1
#: 25e: fmha at BERT-Large's heads and the longest FMHAFun sequence;
#: the norm modules at BERT-Large's rows
P25_FMHA_B, P25_FMHA_S, P25_FMHA_H, P25_FMHA_D = 32, 512, 16, 64
P25_LN_ROWS, P25_LN_HIDDEN = 16384, 1024
#: 25b: card bf16 against CPU f32 on the same weights, relative (max
#: |card - cpu| / max |cpu|) for the logits and every norm's running
#: statistics; the limit sits between the sound reading and that of the
#: planted fault (symmetric padding in the strided conv2): on an H100 the
#: sound logits read 0.029 and the fault's 0.80 (statistics 3e-3 and 0.25)
P25_RESNET_TOL = 1e-1
#: 25c: dp = 2 + SyncBatchNorm against one process at the merged batch,
#: relative, the losses and every running statistic; the planted fault
#: reduces each norm's statistics over the rank's own rows: on an H100
#: the sound run reads 1.4e-4 (losses) and 1.5e-3 (statistics), the fault
#: 2.1e-3 and 1.0 (the fault is held to the statistics)
P25_DP_TOL = 1e-2
#: 25d: the multihead modules, card bf16 against CPU f32 (relative, the
#: output, the query's and the parameters' gradients); the planted fault
#: drops the padding mask on the card: on an H100 the sound modules read
#: 4.4e-3 to 7.8e-3, the fault 0.71 to 1.08
P25_MHA_TOL = 5e-2
#: 25f: one optimizer step on the card against the CPU (f32 both), the
#: updates relative to each tensor's largest update, each optimizer under
#: its own limit.  0 where the update is elementwise (both SGDs, Adagrad:
#: an H100 matched the CPU bit for bit).  1e-4 where a norm scales it
#: (LARC, NovoGrad, ``clip_grad_norm_``): f32 sums over up to 2.4 M
#: elements a tensor and 25.6 M in all, taken in another order on each
#: side, read up to 1.9e-5 on an H100.  3e-4 for the mixed-precision
#: LAMB and the plain ``fused_lamb`` under it, whose trust ratio takes
#: two such norms of each tensor: an H100 read 1.34e-4 at the 512x512x3x3
#: ``conv2`` weights with and without the masters.  The mixed-precision
#: LAMB's update is also its rounded f32 master less the parameter, so
#: each side's rounding of p + u may move an element by up to one ulp of
#: the parameter (2.5e-4 of the update at that tensor): that ulp is taken
#: off before its relative reading (:func:`_rel_max_less_ulp`).
P25_OPT_TOL = dict(fused_sgd=0.0, fused_sgd_nesterov=0.0, fused_adagrad=0.0,
                   larc_fused_sgd=1e-4, fused_novograd=1e-4,
                   fused_lamb=3e-4, fused_mixed_precision_lamb=3e-4,
                   clip_grad_norm_=1e-4)
#: 25e: the memory-efficient backward recomputes x-hat from the bf16
#: output, and the card's and the CPU's outputs may round one bf16 step
#: apart, so their dw and db sums over 16384 rows differ by more than
#: SUM_TOL's order-only allowance.  The planted fault (ME_FAULT_ROWS):
#: the CPU's memory-efficient backward drops its last 64-row block from
#: dw and db; 25e reads the sound and the faulty comparison on seeds
#: ME_SEEDS (ROADMAP C14).  On an H100 (700 W) the sound dw/db read
#: 0.42-1.17 of SUM_TOL over both modules and the three seeds, the fault
#: 1,090-1,686 of it: the limit is three times SUM_TOL (sound at most
#: 0.39 of it, the fault at least 363 times it; ten times SUM_TOL before)
ME_SUM_TOL = dict(atol=3e-2, rtol=3e-3)
ME_FAULT_ROWS = 64
ME_SEEDS = (0, 1, 2)


def _tol_ratio(out, ref, tol):
    """The worst |out - ref| / (atol + rtol |ref|): 1 is the limit."""
    out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
    return float(((out - ref).abs() / (tol["atol"] + tol["rtol"]
                                       * ref.abs())).max())


def _me_dropped_block(ln):
    """25e's planted fault: the plain K2's memory-efficient path leaves
    the last ME_FAULT_ROWS rows out of dw and db."""
    import contextlib

    orig = ln.layer_norm_bwd_reference

    def faulty(x2d, w, b, mu, rstd, g, rms, x_is_output):
        dx, dw, db = orig(x2d, w, b, mu, rstd, g, rms, x_is_output)
        if x_is_output:
            k = ME_FAULT_ROWS
            _, dw_k, db_k = orig(x2d[-k:], w, b, mu[-k:], rstd[-k:],
                                 g[-k:], rms, x_is_output)
            dw, db = dw - dw_k, db - db_k
        return dx, dw, db

    @contextlib.contextmanager
    def planted():
        ln.layer_norm_bwd_reference = faulty
        try:
            yield
        finally:
            ln.layer_norm_bwd_reference = orig

    return planted()


def _phase25e_me_readings():
    """C14: the memory-efficient dw/db of both norm modules at (16384,
    1024) bf16, card against CPU, on ME_SEEDS, sound and with the
    dropped-row fault planted on the CPU side; each reading as its worst
    err/allowance under ME_SUM_TOL (and SUM_TOL beside it).  Returns
    (readings, failures)."""
    import contextlib

    import torch

    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    from apex_tpu_torch.ops import layer_norm as ln

    rows, hidden = P25_LN_ROWS, P25_LN_HIDDEN
    readings, failures = [], []
    for seed in ME_SEEDS:
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        x = (torch.randn(rows, hidden, generator=g, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        gy = torch.randn(rows, hidden, generator=g,
                         device="cuda").to(torch.bfloat16)
        for cls in (FusedLayerNorm, FusedRMSNorm):
            grads = {}
            for side in ("cuda", "cpu", "cpu_fault"):
                dev = "cuda" if side == "cuda" else "cpu"
                mod = cls(hidden, memory_efficient=True, device=dev)
                with torch.no_grad():
                    for p in mod.parameters():
                        p.add_(0.1 * torch.randn(
                            p.shape, generator=torch.Generator().manual_seed(
                                200 + seed)).to(dev))
                xd = x.detach().to(dev).requires_grad_(True)
                with (_me_dropped_block(ln) if side == "cpu_fault"
                      else contextlib.nullcontext()):
                    mod(xd).backward(gy.to(dev))
                grads[side] = [p.grad for p in mod.parameters()]
            sound = max(_tol_ratio(a, r, ME_SUM_TOL)
                        for a, r in zip(grads["cuda"], grads["cpu"]))
            fault = max(_tol_ratio(a, r, ME_SUM_TOL)
                        for a, r in zip(grads["cuda"], grads["cpu_fault"]))
            sound_sum = max(_tol_ratio(a, r, SUM_TOL)
                            for a, r in zip(grads["cuda"], grads["cpu"]))
            fault_sum = max(_tol_ratio(a, r, SUM_TOL)
                            for a, r in zip(grads["cuda"],
                                            grads["cpu_fault"]))
            tag = f"25e {cls.__name__}(memory_efficient=True) seed {seed}"
            log(f"  {tag}: dw/db worst err/allowance under ME_SUM_TOL "
                f"{ME_SUM_TOL} sound {sound:.4f}, {ME_FAULT_ROWS} rows "
                f"dropped {fault:.4f}; under SUM_TOL {SUM_TOL} sound "
                f"{sound_sum:.4f}, fault {fault_sum:.4f}")
            readings.append(dict(module=cls.__name__, seed=seed,
                                 sound=sound, fault=fault,
                                 sound_sum_tol=sound_sum,
                                 fault_sum_tol=fault_sum))
            if not sound < 1.0:
                failures.append(f"{tag}: sound {sound} over ME_SUM_TOL")
            if not fault > 1.0:
                failures.append(f"{tag}: the dropped-row fault reads "
                                f"{fault}, within ME_SUM_TOL")
    return readings, failures


def _rel_max(a, b):
    """max |a - b| / max |b| (f32, on the host)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _rel_max_less_ulp(a, b, p):
    """max (|a - b| - ulp(|p| + |b|))⁺ / max |b| (f32, on the host): the
    updates ``a`` and ``b`` of parameter ``p`` once each element's one
    ulp of rounding p + u is allowed."""
    import torch

    a, b, p = (t.detach().float().cpu() for t in (a, b, p))
    mag = p.abs() + b.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((a - b).abs() - ulp).clamp_min(0).max()
                 / b.abs().max().clamp_min(1e-30))


def _launched(counts):
    return {k: n for k, n in counts.items() if n}


def _phase25a():
    """25a: ``main_amp.main`` at O1 and at O2, ResNet-50 at ImageNet's
    size on synthetic data: the median step time of steps 2-7, img/s,
    MFU (3 x the forward's convolution and fc FLOPs over 989 TFLOP/s),
    peak memory, the losses finite and the loss scale as the example
    prints it.  No K1-K6 launch: the convolutions and batch norms run
    outside Pallas in the reference too."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.models import resnet
    from apex_tpu_torch.ops import _dispatch

    flops = resnet.forward_flops(resnet.resnet50_config(), P25_IMAGE)
    log(f"  25a: ResNet-50 forward {flops} FLOPs an image at {P25_IMAGE}^2 "
        f"(convolutions and fc; MFU = 3x that x img/s / 989e12)")
    out, failures, launches = {"forward_flops_per_image": flops}, [], {}
    for level in ("O1", "O2"):
        gc.collect()
        torch.cuda.empty_cache()
        _dispatch.reset_launches()
        run = main_amp.main(["--opt-level", level, "--batch-size",
                             str(P25_BATCH), "--image-size", str(P25_IMAGE),
                             "--steps", str(P25_STEPS)])
        counts = _dispatch.launches()
        ps.destroy_model_parallel()
        r = dict(step_ms_median=run["median_step_s"] * 1e3,
                 images_per_s=run["steady_images_per_s"],
                 images_per_s_whole_run=run["images_per_s"],
                 mfu=run["mfu"], peak_memory_bytes=run["peak_bytes"],
                 step_ms=[s * 1e3 for s in run["step_s"]],
                 losses=run["losses"], loss_scales=run["loss_scales"],
                 launches=_launched(counts))
        del run
        log(f"  25a {level}: median step {r['step_ms_median']:.1f} ms "
            f"(steps 2-{P25_STEPS - 1}), {r['images_per_s']:.1f} img/s "
            f"({r['images_per_s_whole_run']:.1f} over the whole run, the "
            f"data's generation included), MFU {r['mfu']:.4f}, peak "
            f"{r['peak_memory_bytes'] / 1e9:.2f} GB, losses "
            f"{[round(x, 4) for x in r['losses']]}, loss scale "
            f"{r['loss_scales'][-1]:.0f}; K1-K6 launches {r['launches']} "
            f"(want none)")
        if r["launches"]:
            failures.append(f"25a {level}: kernel launches {r['launches']}")
        if not all(np.isfinite(r["losses"])) or len(r["losses"]) != P25_STEPS:
            failures.append(f"25a {level}: losses {r['losses']}")
        out[level] = r
        launches[f"resnet_{level.lower()}"] = counts
    return launches, out, failures


def _p25_resnet(use_syncbn, dtype, device, stage_sizes=(1, 1, 1, 1)):
    """A seeded ResNet (full widths, 1000 classes) whose norms are moved
    off their initial values: bn3's zero scale would make every residual
    branch, and the strided conv2 in it, invisible in the logits."""
    import torch

    from apex_tpu_torch.models import resnet

    cfg = resnet.resnet50_config(stage_sizes=stage_sizes,
                                 use_syncbn=use_syncbn, dtype=dtype)
    model = resnet.ResNet(cfg, device=device,
                          generator=torch.Generator().manual_seed(25))
    g = torch.Generator().manual_seed(26)
    with torch.no_grad():
        for _, mod in model.norms():
            n = mod.weight.shape[0]
            mod.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
            mod.bias.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_var.copy_(1 + 0.1 * torch.rand(n, generator=g))
    return model


def _p25_resnet_step(model, x, y):
    """One training forward and backward: logits, loss, the updated
    running statistics (on the host, f32)."""
    from apex_tpu_torch.examples.imagenet import main_amp

    logits, stats = model(x)
    loss = main_amp.xent(logits, y)
    loss.backward()
    return (logits.detach().float().cpu(), float(loss.detach()),
            {k: (m.float().cpu(), v.float().cpu())
             for k, (m, v) in stats.items()})


def _p25_resnet_readings(card, cpu):
    stats = max(max(_rel_max(a[0], b[0]), _rel_max(a[1], b[1]))
                for a, b in zip((card[2][k] for k in cpu[2]),
                                cpu[2].values()))
    return dict(logits=_rel_max(card[0], cpu[0]),
                loss=abs(card[1] - cpu[1]) / abs(cpu[1]), batch_stats=stats)


def _phase25b():
    """25b: one training step of ResNet at stage sizes (1, 1, 1, 1), full
    widths, 64 x 64 images, bf16 on the card against f32 on the CPU from
    the same weights, in both norm branches: the logits, the loss and
    every norm's updated running statistics under P25_RESNET_TOL, beside
    the planted fault (the strided conv2 padded (1, 1))."""
    import torch

    from apex_tpu_torch.models import resnet

    g = torch.Generator().manual_seed(27)
    x = torch.randn(16, P25_SMALL_IMAGE, P25_SMALL_IMAGE, 3, generator=g)
    y = torch.randint(0, 1000, (16,), generator=g)
    out, failures = {}, []
    for branch in ("bn", "syncbn"):
        sync = branch == "syncbn"
        cpu = _p25_resnet_step(_p25_resnet(sync, torch.float32, "cpu"), x, y)
        card = _p25_resnet_step(_p25_resnet(sync, torch.bfloat16, "cuda"),
                                x.cuda(), y.cuda())
        sound = _p25_resnet_readings(card, cpu)
        orig = resnet.same_pads
        resnet.same_pads = lambda n, k, s: (k // 2, k // 2)
        try:
            bad = _p25_resnet_step(
                _p25_resnet(sync, torch.bfloat16, "cuda"), x.cuda(), y.cuda())
        finally:
            resnet.same_pads = orig
        fault = _p25_resnet_readings(bad, cpu)
        log(f"  25b {branch}: card bf16 vs CPU f32 {sound}; planted "
            f"symmetric padding {fault} (limit {P25_RESNET_TOL})")
        if not np.isfinite(card[1]) or max(sound.values()) > P25_RESNET_TOL:
            failures.append(f"25b {branch}: {sound}")
        if max(fault["logits"], fault["batch_stats"]) <= P25_RESNET_TOL:
            failures.append(f"25b {branch}: the padding fault reads {fault}")
        out[branch] = dict(sound=sound, fault=fault)
        gc.collect()
        torch.cuda.empty_cache()
    return out, failures


def _p25_dp_argv(world):
    return ["--opt-level", "O1", "--sync-bn", "--batch-size",
            str(P25_DP_BATCH), "--image-size", str(P25_SMALL_IMAGE),
            "--steps", str(P25_DP_STEPS)] + (
                ["--backend", "gloo"] if world > 1 else [])


def _p25_dp_run(world, fault=False):
    """``main_amp.main`` with ``--sync-bn`` on this rank; ``fault``
    reduces every norm's statistics over the rank's rows only (the
    tensor-parallel axis, of size 1).  The losses, the step times and the
    running statistics (lists)."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.models import resnet

    try:
        model = resnet.ResNet(resnet.resnet50_config(use_syncbn=True),
                              device="cuda",
                              generator=torch.Generator().manual_seed(0))
        if fault:
            for _, mod in model.norms():
                mod.axis_name = ps.TENSOR_PARALLEL_AXIS
        run = main_amp.main(_p25_dp_argv(world), model=model)
        stats = {k: [m.float().cpu().tolist(), v.float().cpu().tolist()]
                 for k, (m, v) in run["model"].batch_stats().items()}
        return dict(losses=run["losses"], step_s=run["step_s"], stats=stats)
    finally:
        ps.destroy_model_parallel()


def p25_dp(rank, world, fault=False):
    """25c worker: :func:`_p25_dp_run` at dp = ``world``."""
    return _p25_dp_run(world, fault)


def _p25_dp_readings(run, ref):
    import torch

    losses = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                     ref["losses"]))
    stats = max(_rel_max(torch.tensor(run["stats"][k][i]),
                         torch.tensor(ref["stats"][k][i]))
                for k in ref["stats"] for i in (0, 1))
    return dict(losses=losses, batch_stats=stats)


def _phase25c():
    """25c: BASELINE row 2 — ``main_amp --sync-bn`` at dp = 2 (two worker
    processes on the card over gloo, 64 x 64, global batch 32, 3 steps,
    O1) against one process at the merged batch: the dp-mean losses and
    every SyncBatchNorm running statistic under P25_DP_TOL, beside the
    planted fault (each rank's statistics over its own rows).  The
    workers' step times are host staging (gloo), not a rank's speed."""
    import torch

    ref = _p25_dp_run(1)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _p16_spawn(2, "gloo", [
        ("sound", "p25_dp", {}), ("fault", "p25_dp", {"fault": True})])
    out, failures = {"one_process_losses": ref["losses"]}, []
    for name in ("sound", "fault"):
        readings = [_p25_dp_readings(r[name], ref) for r in ranks]
        worst = {k: max(rd[k] for rd in readings) for k in readings[0]}
        step_ms = [statistics.median(r[name]["step_s"]) * 1e3 for r in ranks]
        log(f"  25c dp = 2 {name}: against one process {worst} (limit "
            f"{P25_DP_TOL}); losses {ranks[0][name]['losses']} against "
            f"{ref['losses']}; median step {step_ms} ms a rank (gloo host "
            f"staging, not a rank's speed)")
        out[name] = dict(readings=worst, losses=ranks[0][name]["losses"],
                         step_ms_median=step_ms)
    if max(out["sound"]["readings"].values()) > P25_DP_TOL:
        failures.append(f"25c: dp = 2 reads {out['sound']['readings']}")
    if out["fault"]["readings"]["batch_stats"] <= P25_DP_TOL:
        failures.append(f"25c: the local-statistics fault reads "
                        f"{out['fault']['readings']}")
    return out, failures


def _p25_mha(encdec, norm_add, device, dtype):
    import torch

    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn,
        SelfMultiheadAttn,
    )

    cls = EncdecMultiheadAttn if encdec else SelfMultiheadAttn
    return cls(P25_E, P25_H, dropout=P25_DROPOUT, bias=True,
               include_norm_add=norm_add, dtype=dtype, device=device,
               generator=torch.Generator().manual_seed(28))


def _p25_mha_inputs(encdec):
    """query (S, B, E), key (Sk, B, E), the cotangent, a ragged boolean
    key-padding mask (row 0 full), the enc-dec's causal-shaped additive
    (Sq, Sk) attn_mask, the dropout seed (host tensors, f32)."""
    import torch

    g = torch.Generator().manual_seed(29)
    sk = P25_SK if encdec else P25_S
    q = torch.randn(P25_S, P25_B, P25_E, generator=g)
    k = torch.randn(sk, P25_B, P25_E, generator=g) if encdec else None
    cot = torch.randn(P25_S, P25_B, P25_E, generator=g)
    lengths = torch.randint(1, sk + 1, (P25_B,), generator=g)
    lengths[0] = sk
    kpm = torch.arange(sk)[None, :] >= lengths[:, None]
    am = None
    if encdec:
        shape = (torch.arange(sk)[None, :]
                 > torch.arange(P25_S)[:, None] + (sk - P25_S))
        am = torch.where(shape, -1e9, 0.0)
    seed = torch.tensor([20251], dtype=torch.int32)
    return q, k, cot, kpm, am, seed


def _p25_mha_call(module, q, k, kpm, am, seed):
    args = (q, k) if k is not None else (q,)
    return module(*args, kpm, am, deterministic=False, dropout_seed=seed)


def _p25_mha_step(module, inputs, device, dtype, mask=True):
    """The module's output and query (and key) gradient, and its
    parameters' gradients, on ``device`` with the inputs in ``dtype``."""
    q, k, cot, kpm, am, seed = inputs
    qd = q.detach().to(device, dtype).requires_grad_(True)
    kd = None if k is None else k.detach().to(device, dtype).requires_grad_(
        True)
    out = _p25_mha_call(module, qd, kd, kpm.to(device) if mask else None,
                        None if am is None else am.to(device),
                        seed.to(device))
    out.backward(cot.to(device, dtype))
    return (out.detach().float().cpu(), qd.grad.float().cpu(),
            {n: p.grad.float().cpu() for n, p in module.named_parameters()})


def _phase25d():
    """25d: BASELINE row 4 — ``SelfMultiheadAttn`` (with and without
    ``include_norm_add``) and ``EncdecMultiheadAttn`` (Sq 64 against Sk
    80, a boolean padding mask + a causal-shaped additive attn_mask) at E
    1024, H 16, S 64, B 120, dropout 0.1 at one seed, forward and
    backward: exactly one K3 and one K4 a call (and one K1, one K2 with
    ``include_norm_add``); bf16 on the card against f32 on the CPU from
    the same weights (the dropout mask is the kernels' hash of the seed
    on both) under P25_MHA_TOL, beside the planted fault (the padding
    mask dropped on the card); each module's forward + backward timed
    beside ``torch.nn.MultiheadAttention``'s (bf16, the same mask and
    dropout), a yardstick only."""
    import torch

    from apex_tpu_torch.ops import _dispatch

    out, failures, launches = {}, [], {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for tag, encdec, norm_add in (("self", False, False),
                                  ("self_norm_add", False, True),
                                  ("encdec", True, False)):
        inputs = _p25_mha_inputs(encdec)
        card = _p25_mha(encdec, norm_add, "cuda", torch.bfloat16)
        cpu = _p25_mha(encdec, norm_add, "cpu", None)
        torch.cuda.synchronize()
        _dispatch.reset_launches()
        got = _p25_mha_step(card, inputs, "cuda", torch.bfloat16)
        torch.cuda.synchronize()
        counts = _launched(_dispatch.launches())
        want = {"flash_fwd": 1, "flash_bwd": 1}
        if norm_add:
            want.update(layer_norm_fwd=1, layer_norm_bwd=1)
        ref = _p25_mha_step(cpu, inputs, "cpu", torch.float32)
        card.zero_grad()
        bad = _p25_mha_step(card, inputs, "cuda", torch.bfloat16, mask=False)

        def readings(a):
            return dict(out=_rel_max(a[0], ref[0]),
                        dq=_rel_max(a[1], ref[1]),
                        param_grads=max(_rel_max(a[2][n], ref[2][n])
                                        for n in ref[2]))

        sound, fault = readings(got), readings(bad)
        # the times: the module and torch.nn.MultiheadAttention, forward
        # + backward (bf16, the same mask, dropout and seed)
        q, k, cot, kpm, am, seed = inputs
        qd = q.to("cuda", torch.bfloat16).requires_grad_(True)
        kd = None if k is None else k.to("cuda", torch.bfloat16)
        kpm_d = kpm.cuda()
        am_d = None if am is None else am.cuda().to(torch.bfloat16)
        cot_d = cot.to("cuda", torch.bfloat16)
        seed_d = seed.cuda()
        ms = time_ms(lambda: _p25_mha_call(card, qd, kd, kpm_d, am_d,
                                           seed_d).backward(cot_d),
                     flush=flush)
        lib = torch.nn.MultiheadAttention(P25_E, P25_H, dropout=P25_DROPOUT,
                                          device="cuda", dtype=torch.bfloat16)
        kv = qd if kd is None else kd

        def lib_step():
            o, _ = lib(qd, kv, kv, key_padding_mask=kpm_d, attn_mask=am_d,
                       need_weights=False)
            o.backward(cot_d)

        lib_ms = time_ms(lib_step, flush=flush)
        log(f"  25d {tag}: launches {counts} (want {want}); card bf16 vs "
            f"CPU f32 {sound}; planted fault (padding mask dropped) {fault} "
            f"(limit {P25_MHA_TOL}); forward + backward {ms:.4f} ms, "
            f"torch.nn.MultiheadAttention {lib_ms:.4f} ms")
        if counts != want:
            failures.append(f"25d {tag}: launches {counts} != {want}")
        if max(sound.values()) > P25_MHA_TOL:
            failures.append(f"25d {tag}: {sound}")
        if fault["out"] <= P25_MHA_TOL:
            failures.append(f"25d {tag}: the dropped mask reads {fault}")
        out[tag] = dict(sound=sound, fault=fault, launches=counts, ms=ms,
                        torch_mha_ms=lib_ms)
        launches[f"multihead_{tag}"] = counts
        del card, cpu, lib, qd
        gc.collect()
        torch.cuda.empty_cache()
    return launches, out, failures


def _phase25e():
    """25e: ``fmha`` at B 32, S 512, H 16, D 64 with seqlens drawn from
    1-512 (row 0 full), forward and backward, against its plain twin on
    the card (``mha_reference`` in f32 through autograd), the output
    compared on the rows inside each sequence only and the rows past it
    given no cotangent (the reference's docstring); then
    ``FusedLayerNorm`` and ``FusedRMSNorm`` at BERT-Large's rows (16384 x
    1024, bf16, f32 parameters), ``memory_efficient`` both ways, forward
    and backward against the same modules on the CPU (the kernels' plain
    twins).  Launches exact: one K3 and one K4; one K1 and one K2 a
    module call."""
    import torch

    from apex_tpu_torch.contrib import fmha as pfmha
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import attention as attn

    out, failures, launches = {}, [], {}
    b, s, h, d = P25_FMHA_B, P25_FMHA_S, P25_FMHA_H, P25_FMHA_D
    g = torch.Generator(device="cuda").manual_seed(30)
    qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(
        torch.bfloat16)
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lengths[0] = s
    inside = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    cot = (torch.randn(b, s, h, d, generator=g, device="cuda")
           * inside[:, :, None, None]).to(torch.bfloat16)
    qk = qkv.clone().requires_grad_(True)
    _dispatch.reset_launches()
    o = pfmha.fmha(qk, lengths)
    o.backward(cot)
    torch.cuda.synchronize()
    counts = _launched(_dispatch.launches())
    qr = qkv.float().requires_grad_(True)
    bias = pfmha.padding_bias_from_seqlens(lengths, s)
    q_, k_, v_ = (qr[:, :, i].transpose(1, 2) for i in range(3))
    ref = attn.mha_reference(q_, k_, v_, bias).transpose(1, 2)
    ref.backward(cot.float())
    e_o = compare("25e fmha o (rows inside each sequence)", o[inside],
                  ref[inside], BF16_TOL)
    grads = [qk.grad[:, :, i].transpose(1, 2).reshape(b * h, s, d)
             for i in range(3)]
    grads_ref = [qr.grad[:, :, i].transpose(1, 2).reshape(b * h, s, d)
                 for i in range(3)]
    e_g = check_k4("25e fmha", grads, grads_ref)
    want = {"flash_fwd": 1, "flash_bwd": 1}
    log(f"  25e fmha: launches {counts} (want {want})")
    if counts != want:
        failures.append(f"25e fmha: launches {counts} != {want}")
    out["fmha"] = dict(max_abs_err_o=e_o, max_abs_err_dqkv=e_g,
                       launches=counts)
    launches["fmha"] = counts
    del qk, qr, ref, o
    torch.cuda.empty_cache()

    x = (torch.randn(P25_LN_ROWS, P25_LN_HIDDEN, generator=g, device="cuda")
         * 2 + 0.5).to(torch.bfloat16)
    gy = torch.randn(P25_LN_ROWS, P25_LN_HIDDEN, generator=g,
                     device="cuda").to(torch.bfloat16)
    for cls in (FusedLayerNorm, FusedRMSNorm):
        for me in (False, True):
            tag = f"{cls.__name__}(memory_efficient={me})"
            runs = {}
            for dev in ("cuda", "cpu"):
                mod = cls(P25_LN_HIDDEN, memory_efficient=me, device=dev)
                with torch.no_grad():
                    for p in mod.parameters():
                        p.add_(0.1 * torch.randn(
                            p.shape, generator=torch.Generator().manual_seed(31)
                        ).to(dev))
                xd = x.detach().to(dev).requires_grad_(True)
                if dev == "cuda":
                    _dispatch.reset_launches()
                y = mod(xd)
                y.backward(gy.to(dev))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = _launched(_dispatch.launches())
                runs[dev] = [y.detach(), xd.grad] + [
                    p.grad for p in mod.parameters()]
            card, cpu = runs["cuda"], [t.cuda() for t in runs["cpu"]]
            errs = [compare(f"25e {tag} y", card[0], cpu[0], BF16_TOL),
                    compare(f"25e {tag} dx", card[1], cpu[1], BF16_TOL)]
            errs += [compare(f"25e {tag} d{n}", a, r,
                             ME_SUM_TOL if me else SUM_TOL)
                     for n, a, r in zip(("w", "b"), card[2:], cpu[2:])]
            want = {"layer_norm_fwd": 1, "layer_norm_bwd": 1}
            log(f"  25e {tag}: launches {counts} (want {want})")
            if counts != want:
                failures.append(f"25e {tag}: launches {counts} != {want}")
            out[tag] = dict(max_abs_err=errs, launches=counts)
            launches[f"norm_{cls.__name__}_{me}"] = counts
    out["memory_efficient_readings"], f = _phase25e_me_readings()
    failures += f
    return launches, out, failures


def _phase25f():
    """25f: one step of each of the remaining optimizers on ResNet-50's
    parameter set (seeded parameters and gradients, f32): ``fused_sgd``
    with and without nesterov, ``larc`` in front of ``fused_sgd``,
    ``fused_adagrad``, ``fused_novograd``, ``fused_mixed_precision_lamb``
    and ``clip_grad_norm_`` (and the plain ``fused_lamb`` under the
    mixed-precision one), on the card against the CPU under
    P25_OPT_TOL."""
    import torch

    from apex_tpu_torch import optimizers as popt
    from apex_tpu_torch.models import resnet

    model = resnet.ResNet(resnet.resnet50_config(), device="cpu",
                          generator=torch.Generator().manual_seed(32))
    g = torch.Generator().manual_seed(33)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: 0.01 * torch.randn(p.shape, generator=g)
             for n, p in params.items()}
    del model
    cases = {
        "fused_sgd": lambda: popt.fused_sgd(0.1, momentum=0.9,
                                            weight_decay=1e-4),
        "fused_sgd_nesterov": lambda: popt.fused_sgd(
            0.1, momentum=0.9, nesterov=True, weight_decay=1e-4),
        "larc_fused_sgd": lambda: popt.LARC(
            popt.fused_sgd(0.1, momentum=0.9), 0.1, weight_decay=1e-4),
        "fused_adagrad": lambda: popt.fused_adagrad(0.01, weight_decay=1e-4),
        "fused_novograd": lambda: popt.fused_novograd(0.01,
                                                      weight_decay=1e-4),
        "fused_lamb": lambda: popt.fused_lamb(1e-3),
        "fused_mixed_precision_lamb": lambda: popt.fused_mixed_precision_lamb(
            1e-3),
    }
    out, failures = {}, []
    for name, make in cases.items():
        got = {}
        for dev in ("cuda", "cpu"):
            p = {k: v.to(dev) for k, v in params.items()}
            tx = make()
            got[dev], _ = tx.update({k: v.to(dev) for k, v in grads.items()},
                                    tx.init(p), p)
        out[name] = dict(updates=max(_rel_max(got["cuda"][k], got["cpu"][k])
                                     for k in params))
        if name == "fused_mixed_precision_lamb":
            out[name]["updates_less_ulp"] = max(
                _rel_max_less_ulp(got["cuda"][k], got["cpu"][k], params[k])
                for k in params)
    for dev in ("cuda", "cpu"):
        gd = {k: v.to(dev) for k, v in grads.items()}
        total = popt.clip_grad_norm_(gd, 1.0)
        out.setdefault("clip_grad_norm_", {})[dev] = (float(total), gd)
    (t_card, g_card), (t_cpu, g_cpu) = (out["clip_grad_norm_"][d]
                                        for d in ("cuda", "cpu"))
    out["clip_grad_norm_"] = dict(
        norm=abs(t_card - t_cpu) / t_cpu,
        updates=max(_rel_max(g_card[k], g_cpu[k]) for k in grads))
    log(f"  25f optimizers, one step on ResNet-50's {len(params)} tensors "
        f"({sum(p.numel() for p in params.values())} parameters), card f32 "
        f"vs CPU f32 (relative; limits {P25_OPT_TOL}): {out}")
    for name, r in out.items():
        held = ({"updates_less_ulp": r["updates_less_ulp"]}
                if "updates_less_ulp" in r else r)
        if max(held.values()) > P25_OPT_TOL[name]:
            failures.append(f"25f {name}: {r} > {P25_OPT_TOL[name]}")
    return out, failures


def phase25():
    """ROADMAP item 11's first part on the card: 25a-25f (see their
    docstrings).  Every part logs its readings before any failure fails
    the phase.  Returns (the launches of each path, results)."""
    import torch

    t0 = time.perf_counter()
    log("phase 25: ResNet-50 and the ImageNet amp example (O1, O2), its "
        "card-vs-CPU step, dp = 2 + SyncBatchNorm, the fused multihead "
        "attention, fmha and the norm modules, the remaining optimizers")
    seconds = {}
    t = time.perf_counter()
    launches, out, failures = _phase25a()
    seconds["25a"] = time.perf_counter() - t
    for name, part in (("25b", _phase25b), ("25c", _phase25c),
                       ("25d", _phase25d), ("25e", _phase25e),
                       ("25f", _phase25f)):
        t = time.perf_counter()
        res = part()
        if name in ("25d", "25e"):
            launches.update(res[0])
        out[name], f = res[-2:]
        failures += f
        seconds[name] = time.perf_counter() - t
    out["part_seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    log(f"  phase 25 by part: {out['part_seconds']} s")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 25 took {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 25: " + "; ".join(failures))
    return launches, out


# ---------------------------------------------------------------------------
# phase 26: ROADMAP item 11 steps 1-5 — mlp, fused_dense, the RNNs, weight
# norm, the native host ops, the three profile tools on a GptConfig() step,
# the standalone providers
# ---------------------------------------------------------------------------


#: 26a: upstream Apex's tests/L0/run_mlp/test_mlp.py sizes and batch; the
#: fused dense layers at BERT-Large's FFN over phase 8's 16384 tokens
P26_MLP_SIZES = (480, 1024, 1024, 512, 256, 1)
P26_MLP_BATCH = 1024
P26_FD_TOKENS, P26_FD_IN, P26_FD_HIDDEN = 16384, 1024, 4096
#: 26a-26b: card bf16 against CPU f32 on the same (bf16-exact) weights
#: and inputs, each tensor's relative Frobenius error ||card - cpu|| /
#: ||cpu|| over the output, the input's and every parameter's gradient,
#: the worst of them.  On an H100 (700 W) the fused dense layers read
#: 1.7e-3 and 3.1e-3, mLSTM's 32 steps 1.1e-2, and its planted i/f swap
#: 0.97
P26_BF16_TOL = 5e-2
#: the MLPs' own bf16 limit: bf16 rounding flips relu gates and, through
#: four sigmoids, leaves the first layers' gradients as small differences
#: of large terms; an H100 read 0.065 (relu) and 0.125 (sigmoid), and the
#: same modules in bf16 on the CPU read the same order (0.02-0.09)
P26_MLP_BF16_TOL = 0.3
#: 26a-26c: f32 on the card (TF32 off) against f32 on the CPU, relative:
#: max |card - cpu| / max |cpu|.  Every 26a module has this f32 twin, and
#: it carries 26a's planted faults, which a bf16 floor would hide: the
#: activation after the last MLP layer (1.0 and 4.07 on an H100) and the
#: exact GELU in place of the tanh form (4.7e-4); the sound twins read
#: 1.1e-6 to 3.6e-6, the sigmoid MLP's 1.8e-5 (its gradients' f32 sums
#: cancel), WeightNorm's 3.1e-6
P26_F32_TOL = 1e-4
#: 26b: the byte-level multiplicative LSTM of Radford et al. 2017 (64
#: input bytes, 4096 hidden) over T 256 at batch 128, held to the CPU on
#: its first 32 steps; the other RNNs at hidden 1024, T 128, batch 64
#: against torch.nn.LSTM/GRU/RNN (cuDNN) with the same weights and
#: bias_hh = 0, f32, within P26_RNN_F32_TOL (128 recurrent steps of f32
#: sums in another order on each side)
P26_MLSTM = dict(input=64, hidden=4096, steps=256, batch=128, checked=32)
P26_RNN = dict(hidden=1024, steps=128, batch=64)
P26_RNN_F32_TOL = 1e-4
#: 26c: WeightNorm around FusedDense(1024, 4096) over 4096 tokens
P26_WN_TOKENS = 4096
#: 26e: the profiled steady-state steps of step_profile's GptConfig() step
P26_PROFILE_STEPS = 3
#: 26f: the standalone providers' batch and their f32 launches a step
P26_PROVIDER_BATCH = 4
P26_PROVIDER_TOL = 1e-4


def _p26_run(module, x, gy):
    """Forward and backward of ``module`` on a leaf copy of ``x``:
    ``[y, dx, *parameter grads]``."""
    xl = x.detach().clone().requires_grad_(True)
    y = module(xl)
    y.backward(gy)
    return [y.detach(), xl.grad] + [p.grad for p in module.parameters()]


def _rel_fro(a, b):
    """||a - b|| / ||b|| (f32, on the host)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _p26_rel(card, cpu, norm=False):
    """The worst :func:`_rel_max` (or with ``norm``, :func:`_rel_fro`)
    over paired tensors (None pairs skipped)."""
    rel = _rel_fro if norm else _rel_max
    return max(rel(a, b) for a, b in zip(card, cpu)
               if a is not None and b is not None)


def _p26_cpu_twin(module):
    """A CPU copy of ``module`` in f32 (the card's bf16 weights are exact
    in f32)."""
    import copy

    return copy.deepcopy(module).cpu().float()


def _p26_patched(obj, attr, value):
    import contextlib

    @contextlib.contextmanager
    def patched():
        orig = getattr(obj, attr)
        setattr(obj, attr, value)
        try:
            yield
        finally:
            setattr(obj, attr, orig)

    return patched()


def _phase26a():
    """26a: ``MLP(P26_MLP_SIZES)`` at batch 1024 with relu and with
    sigmoid, ``FusedDense(1024, 4096)`` and ``FusedDenseGeluDense(1024,
    4096, 1024)`` over 16384 tokens: bf16 on the card against f32 on the
    CPU (forward and backward), then each module's f32 twin on the card
    against the same CPU run, beside the planted faults (the activation
    after the last MLP layer, the exact GELU); each module's forward +
    backward ms beside ``torch.nn.Linear`` chains with the same
    weights."""
    import types

    import torch
    import torch.nn.functional as F

    from apex_tpu_torch import fused_dense as pfd
    from apex_tpu_torch import mlp as pmlp
    from apex_tpu_torch.ops import _dispatch

    out, failures = {}, []
    gen = torch.Generator(device="cuda").manual_seed(26)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def bias_init(module):
        with torch.no_grad():
            for name, p in module.named_parameters():
                if "bias" in name:
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen,
                                              device="cuda"))
        return module

    def timed_pair(module, chain, x, gy):
        def step(m):
            def run():
                xl = x.detach().requires_grad_(True)
                m(xl).backward(gy)
            return run

        return (time_ms(step(module), iters=10, flush=flush),
                time_ms(step(chain), iters=10, flush=flush))

    _dispatch.reset_launches()
    cases = []
    for act in ("relu", "sigmoid"):
        m = bias_init(pmlp.MLP(P26_MLP_SIZES, activation=act,
                               generator=torch.Generator("cuda")
                               .manual_seed(1))).to(torch.bfloat16)
        x, gy = draw(P26_MLP_BATCH, P26_MLP_SIZES[0]), draw(P26_MLP_BATCH, 1)
        layers = []
        for i in range(m.num_layers):
            lin = torch.nn.Linear(P26_MLP_SIZES[i], P26_MLP_SIZES[i + 1],
                                  device="cuda", dtype=torch.bfloat16)
            with torch.no_grad():
                lin.weight.copy_(getattr(m, f"weight_{i}"))
                lin.bias.copy_(getattr(m, f"bias_{i}"))
            layers.append(lin)
            if i != m.num_layers - 1:
                layers.append(torch.nn.ReLU() if act == "relu"
                              else torch.nn.Sigmoid())
        cases.append((f"MLP({list(P26_MLP_SIZES)}, {act})", m,
                      torch.nn.Sequential(*layers), x, gy))
    fd = bias_init(pfd.FusedDense(
        P26_FD_IN, P26_FD_HIDDEN,
        generator=torch.Generator("cuda").manual_seed(2))).to(torch.bfloat16)
    lin = torch.nn.Linear(P26_FD_IN, P26_FD_HIDDEN, device="cuda",
                          dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(fd.weight)
        lin.bias.copy_(fd.bias)
    cases.append((f"FusedDense({P26_FD_IN}, {P26_FD_HIDDEN})", fd, lin,
                  draw(P26_FD_TOKENS, P26_FD_IN),
                  draw(P26_FD_TOKENS, P26_FD_HIDDEN)))
    fdg = bias_init(pfd.FusedDenseGeluDense(
        P26_FD_IN, P26_FD_HIDDEN, P26_FD_IN,
        generator=torch.Generator("cuda").manual_seed(3))).to(torch.bfloat16)
    l1 = torch.nn.Linear(P26_FD_IN, P26_FD_HIDDEN, device="cuda",
                         dtype=torch.bfloat16)
    l2 = torch.nn.Linear(P26_FD_HIDDEN, P26_FD_IN, device="cuda",
                         dtype=torch.bfloat16)
    with torch.no_grad():
        l1.weight.copy_(fdg.weight1)
        l1.bias.copy_(fdg.bias1)
        l2.weight.copy_(fdg.weight2)
        l2.bias.copy_(fdg.bias2)
    cases.append((f"FusedDenseGeluDense({P26_FD_IN}, {P26_FD_HIDDEN}, "
                  f"{P26_FD_IN})", fdg, torch.nn.Sequential(
                      l1, torch.nn.GELU(approximate="tanh"), l2),
                  draw(P26_FD_TOKENS, P26_FD_IN),
                  draw(P26_FD_TOKENS, P26_FD_IN)))
    # the planted faults, each in the f32 twin: the activation after the
    # last MLP layer, the exact GELU
    orig_mlp = pmlp.mlp_function
    after_last = (lambda x, w, b, activation="relu": pmlp._ACTIVATIONS[
        activation](orig_mlp(x, w, b, activation)))
    exact = types.SimpleNamespace(
        gelu=lambda h, approximate="none": F.gelu(h))
    for tag, m, chain, x, gy in cases:
        cpu = _p26_run(_p26_cpu_twin(m), x.float().cpu(), gy.float().cpu())
        cpu = [t.cuda() for t in cpu]
        row = dict(sound=_p26_rel(_p26_run(m, x, gy), cpu, norm=True))
        limit = P26_MLP_BF16_TOL if tag.startswith("MLP") else P26_BF16_TOL
        if not row["sound"] <= limit:
            failures.append(f"26a {tag}: {row['sound']} over {limit}")
        f32 = _p26_cpu_twin(m).cuda()
        row["f32"] = _p26_rel(_p26_run(f32, x.float(), gy.float()), cpu)
        if not row["f32"] <= P26_F32_TOL:
            failures.append(f"26a {tag}: f32 twin {row['f32']} over "
                            f"P26_F32_TOL")
        plant = (("fault_activation_after_last", pmlp, "mlp_function",
                  after_last) if tag.startswith("MLP") else
                 ("fault_exact_gelu", pfd, "F", exact)
                 if "Gelu" in tag else None)
        if plant is not None:
            f32.zero_grad(set_to_none=True)
            with _p26_patched(*plant[1:]):
                row[plant[0]] = _p26_rel(_p26_run(f32, x.float(),
                                                  gy.float()), cpu)
            if not row[plant[0]] > P26_F32_TOL:
                failures.append(f"26a {tag}: {plant[0]} reads "
                                f"{row[plant[0]]}, within P26_F32_TOL")
        del f32
        row["ms"], row["torch_nn_ms"] = timed_pair(m, chain, x, gy)
        log(f"  26a {tag}: card bf16 vs CPU f32 rel (Frobenius) "
            f"{row['sound']:.3e} (limit {limit}); f32 twin rel "
            f"{row['f32']:.3e}, planted {plant[0] if plant else '-'} "
            f"{row.get(plant[0]) if plant else '-'} (limit {P26_F32_TOL}); "
            f"forward + backward {row['ms']:.4f} ms against torch.nn."
            f"Linear's {row['torch_nn_ms']:.4f} ms")
        out[tag] = row
    launched = _launched(_dispatch.launches())
    log(f"  26a: K1-K6 launches {launched} (want none: plain cuBLAS)")
    if launched:
        failures.append(f"26a launched kernels {launched}")
    del cases, fd, fdg, flush
    torch.cuda.empty_cache()
    return out, failures


def _swapped_if(gates, c):
    """The planted LSTM-cell fault: the i and f gates swapped."""
    import torch

    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(i) * c + torch.sigmoid(f) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _phase26b():
    """26b: mLSTM(64, 4096) over T 256 at batch 128 in bf16, forward and
    backward (ms and peak memory), its first 32 steps against the CPU in
    f32 beside the i/f-swapped fault; LSTM, GRU, RNNTanh and RNNReLU at
    hidden 1024, T 128, batch 64 in f32 against ``torch.nn.LSTM``,
    ``GRU`` and ``RNN`` (cuDNN) with the same weights and bias_hh = 0
    (the LSTM again with the fault), ms a time step against cuDNN's."""
    import torch

    from apex_tpu_torch import RNN as prnn
    from apex_tpu_torch.ops import _dispatch

    out, failures = {}, []
    gen = torch.Generator(device="cuda").manual_seed(27)
    mc = P26_MLSTM
    mod = prnn.mLSTM(mc["input"], mc["hidden"], device="cuda",
                     generator=torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        mod.b_ih_0.copy_(0.1 * torch.randn(mod.b_ih_0.shape, generator=gen,
                                           device="cuda"))
    mod = mod.to(torch.bfloat16)
    x = torch.randn(mc["steps"], mc["batch"], mc["input"], generator=gen,
                    device="cuda").to(torch.bfloat16)
    gy = torch.randn(mc["steps"], mc["batch"], mc["hidden"], generator=gen,
                     device="cuda").to(torch.bfloat16)

    def full():
        xl = x.detach().requires_grad_(True)
        y, _ = mod(xl)
        y.backward(gy)

    _dispatch.reset_launches()
    full()
    torch.cuda.synchronize()
    mod.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    mod.zero_grad(set_to_none=True)
    k = mc["checked"]

    def first_steps(module, xs, gs):
        xl = xs.detach().clone().requires_grad_(True)
        y, (h, c) = module(xl)
        y.backward(gs)
        return [y.detach(), h.detach(), c.detach(), xl.grad] + [
            p.grad for p in module.parameters()]

    cpu = first_steps(_p26_cpu_twin(mod), x[:k].float().cpu(),
                      gy[:k].float().cpu())
    cpu = [t.cuda() for t in cpu]
    sound = _p26_rel(first_steps(mod, x[:k], gy[:k]), cpu, norm=True)
    mod.zero_grad(set_to_none=True)
    with _p26_patched(prnn, "_lstm_update", _swapped_if):
        fault = _p26_rel(first_steps(mod, x[:k], gy[:k]), cpu, norm=True)
    row = dict(ms_forward_backward=secs * 1e3,
               ms_a_step=secs * 1e3 / mc["steps"], peak_bytes=peak,
               sound=sound, fault_if_swapped=fault)
    log(f"  26b mLSTM({mc['input']}, {mc['hidden']}) T {mc['steps']} batch "
        f"{mc['batch']} bf16: forward + backward {secs * 1e3:.1f} ms "
        f"({row['ms_a_step']:.3f} ms a step), peak {peak / 1e9:.2f} GB; its "
        f"first {k} steps against the CPU f32 rel {sound:.3e}, i/f swapped "
        f"{fault:.3e} (limit {P26_BF16_TOL})")
    if not sound <= P26_BF16_TOL < fault:
        failures.append(f"26b mLSTM: sound {sound}, fault {fault}")
    out["mLSTM"] = row
    del mod, x, gy, cpu
    torch.cuda.empty_cache()

    rc = P26_RNN
    h = rc["hidden"]
    x = torch.randn(rc["steps"], rc["batch"], h, generator=gen,
                    device="cuda")
    gy = torch.randn(rc["steps"], rc["batch"], h, generator=gen,
                     device="cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for name, ref_cls, kw in (("LSTM", torch.nn.LSTM, {}),
                              ("GRU", torch.nn.GRU, {}),
                              ("RNNTanh", torch.nn.RNN,
                               {"nonlinearity": "tanh"}),
                              ("RNNReLU", torch.nn.RNN,
                               {"nonlinearity": "relu"})):
        port = getattr(prnn, name)(h, h, device="cuda",
                                   generator=torch.Generator("cuda")
                                   .manual_seed(3))
        with torch.no_grad():
            port.b_ih_0.copy_(0.1 * torch.randn(port.b_ih_0.shape,
                                                generator=gen,
                                                device="cuda"))
        ref = ref_cls(h, h, device="cuda", **kw)
        with torch.no_grad():
            ref.weight_ih_l0.copy_(port.w_ih_0)
            ref.weight_hh_l0.copy_(port.w_hh_0)
            ref.bias_ih_l0.copy_(port.b_ih_0)
            ref.bias_hh_l0.zero_()

        def both(module, is_port):
            xl = x.detach().clone().requires_grad_(True)
            y, fin = module(xl)
            y.backward(gy)
            fins = fin if isinstance(fin, tuple) else (fin,)
            return [y.detach(), *(f.detach() for f in fins), xl.grad]

        got = both(port, True)
        want = both(ref, False)
        sound = _p26_rel(got, want)
        row = dict(sound=sound)
        if name == "LSTM":
            with _p26_patched(prnn, "_lstm_update", _swapped_if):
                row["fault_if_swapped"] = _p26_rel(both(port, True), want)
        ms = [time_ms(lambda m=m: both(m, False), iters=5, warmup=1,
                      flush=flush) for m in (port, ref)]
        row.update(ms_a_step=ms[0] / rc["steps"],
                   cudnn_ms_a_step=ms[1] / rc["steps"])
        log(f"  26b {name}(hidden {h}) T {rc['steps']} batch {rc['batch']} "
            f"f32 against torch.nn's (cuDNN, bias_hh 0): rel {row} (limit "
            f"{P26_RNN_F32_TOL}); {row['ms_a_step']:.4f} ms a time step "
            f"(forward + backward) against cuDNN's "
            f"{row['cudnn_ms_a_step']:.4f}")
        if not sound <= P26_RNN_F32_TOL:
            failures.append(f"26b {name}: {sound} over P26_RNN_F32_TOL")
        if name == "LSTM" and not row["fault_if_swapped"] > P26_RNN_F32_TOL:
            failures.append(f"26b LSTM: the i/f fault reads {row}")
        out[name] = row
    launched = _launched(_dispatch.launches())
    log(f"  26b: K1-K6 launches {launched} (want none)")
    if launched:
        failures.append(f"26b launched kernels {launched}")
    del x, gy, flush
    torch.cuda.empty_cache()
    return out, failures


def _max_ulp(a, b):
    """The largest distance in f32 ulps between same-shaped tensors."""
    import torch

    ia = a.detach().float().contiguous().view(torch.int32).long()
    ib = b.detach().float().contiguous().view(torch.int32).long()
    # a monotone integer line for negative floats too
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def _phase26c():
    """26c: ``WeightNorm(FusedDense(1024, 4096))`` forward and backward
    over 4096 tokens in f32 on the card against the CPU, and
    ``remove_weight_norm(apply_weight_norm(module))`` on the card: the
    weights back within one ulp, the forward in between the plain
    module's."""
    import torch

    from apex_tpu_torch import fused_dense as pfd
    from apex_tpu_torch import reparameterization as rep

    gen = torch.Generator(device="cuda").manual_seed(28)
    layer = pfd.FusedDense(P26_FD_IN, P26_FD_HIDDEN,
                           generator=torch.Generator("cuda").manual_seed(4))
    wn = rep.WeightNorm(layer)
    with torch.no_grad():
        for p in wn.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
    x = torch.randn(P26_WN_TOKENS, P26_FD_IN, generator=gen, device="cuda")
    gy = torch.randn(P26_WN_TOKENS, P26_FD_HIDDEN, generator=gen,
                     device="cuda")
    cpu = _p26_run(_p26_cpu_twin(wn), x.cpu(), gy.cpu())
    sound = _p26_rel(_p26_run(wn, x, gy), [t.cuda() for t in cpu])
    plain = pfd.FusedDense(P26_FD_IN, P26_FD_HIDDEN,
                           generator=torch.Generator("cuda").manual_seed(5))
    before = {k: v.clone() for k, v in plain.state_dict().items()}
    with torch.no_grad():
        y0 = plain(x)
        rep.apply_weight_norm(plain)
        y1 = plain(x)
        rep.remove_weight_norm(plain)
    after = plain.state_dict()
    ulps = max(_max_ulp(after[k], v) for k, v in before.items())
    fwd = _rel_max(y1, y0)
    failures = []
    log(f"  26c WeightNorm(FusedDense({P26_FD_IN}, {P26_FD_HIDDEN})) f32: "
        f"card vs CPU rel {sound:.3e} (limit {P26_F32_TOL}); remove(apply"
        f"(p)) within {ulps} ulp of p (keys {sorted(after)}), the forward "
        f"in between rel {fwd:.3e}")
    if not sound <= P26_F32_TOL:
        failures.append(f"26c: {sound} over P26_F32_TOL")
    if sorted(after) != sorted(before) or ulps > 1 or fwd > P26_F32_TOL:
        failures.append(f"26c round trip: {ulps} ulp, forward {fwd}")
    return dict(sound=sound, round_trip_ulps=ulps, forward_rel=fwd), failures


def _native_off():
    """The port's native host ops on their numpy replay (the library
    unloaded and its build refused, as on a host without g++)."""
    import contextlib

    from apex_tpu_torch import _native

    @contextlib.contextmanager
    def off():
        saved = _native._LIB, _native._LOAD_FAILED
        _native._LIB, _native._LOAD_FAILED = None, True
        try:
            yield
        finally:
            _native._LIB, _native._LOAD_FAILED = saved

    return off()


def _host_ms(fn, reps=3):
    """Median host ms of ``fn()`` over ``reps`` runs (and its last
    result)."""
    times, res = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), res


def _phase26d():
    """26d: the native host ops on the card's host, built from the
    repository's ``host_ops.cpp``: ``gather_rows`` and ``mlm_mask_batch``
    at phase 8's batch (128 x 128 ids of its corpus) and
    ``flatten_f32``/``unflatten_f32`` over BERT-Large's parameters, each
    bit for bit against the numpy replay, with both paths' ms; phase 8's
    batches (``pretrain_bert.MLMBatches``) drawn through ``_native`` (its
    calls counted) against the same batches on the numpy replay, the
    host's ms a batch both ways."""
    import itertools

    import torch

    from apex_tpu_torch import _native
    from apex_tpu_torch.data import TokenFileDataset
    from apex_tpu_torch.examples import pretrain_bert
    from apex_tpu_torch.models import BertForPreTraining, bert_large_config

    out, failures = {}, []
    root = os.path.dirname(os.path.abspath(__file__))
    lib = _native.library_path()
    built = _native.available()
    out.update(native_available=_native.NATIVE_AVAILABLE, library=str(lib),
               threads=_native.threads())
    log(f"  26d: native {built} ({lib}; built from "
        f"{os.path.relpath(str(_native._SRC), root)}), "
        f"{_native.threads()} threads")
    if not (built and _native.NATIVE_AVAILABLE and lib.is_file()
            and str(lib).startswith(os.path.join(root, "build"))):
        failures.append(f"26d: the native library did not build from the "
                        f"checkout ({lib})")
        return out, failures
    args = pretrain_bert.parse_args(["--batch", str(BERT_BATCH),
                                     "--seq-len", str(BERT_SEQ)])
    cfg = pretrain_bert.config(args)
    ds = TokenFileDataset(pretrain_bert.corpus(args, cfg.vocab_size),
                          seq_len=args.seq_len)
    starts = ds.sample_starts(np.arange(BERT_BATCH) * 7 + 3)
    ids = _native.gather_rows(ds.tokens, starts, BERT_SEQ).astype(np.int32)
    rows = {}
    for name, fn in (
            ("gather_rows", lambda: _native.gather_rows(ds.tokens, starts,
                                                        BERT_SEQ)),
            ("mlm_mask_batch", lambda: _native.mlm_mask_batch(ids, 77))):
        ms, got = _host_ms(fn, 5)
        with _native_off():
            ms_np, ref = _host_ms(fn, 5)
        same = all(np.array_equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            ref if isinstance(ref, tuple) else (ref,)))
        rows[name] = dict(native_ms=ms, numpy_ms=ms_np, bit_identical=same)
        if not same:
            failures.append(f"26d {name}: native and numpy differ")
    model = BertForPreTraining(bert_large_config(), device="cuda")
    arrays = [p.detach().float().cpu().numpy() for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    ms, flat = _host_ms(lambda: _native.flatten_f32(arrays))
    with _native_off():
        ms_np, flat_np = _host_ms(lambda: _native.flatten_f32(arrays))
        ums_np, back_np = _host_ms(lambda: _native.unflatten_f32(flat,
                                                                 arrays))
    ums, back = _host_ms(lambda: _native.unflatten_f32(flat, arrays))
    same = (np.array_equal(flat, flat_np) and all(
        np.array_equal(a, b) and np.array_equal(a, c)
        for a, b, c in zip(back, back_np, arrays)))
    n = sum(a.size for a in arrays)
    rows["flatten_f32"] = dict(native_ms=ms, numpy_ms=ms_np,
                               bit_identical=same, elements=n)
    rows["unflatten_f32"] = dict(native_ms=ums, numpy_ms=ums_np,
                                 bit_identical=same, elements=n)
    if not same:
        failures.append("26d flatten/unflatten: native and numpy differ")
    del arrays, flat, flat_np, back, back_np
    # phase 8's batches through _native, counted, against the replay (the
    # corpus's pages read once before either is timed)
    mlm = pretrain_bert.MLMBatches(args, cfg)
    list(itertools.islice(mlm.iter_from(0), 8))
    calls = {"gather_rows": 0, "mlm_mask_batch": 0}
    originals = {k: getattr(_native, k) for k in calls}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return originals[name](*a, **kw)
        return fn

    for k in calls:
        setattr(_native, k, counted(k))
    try:
        t0 = time.perf_counter()
        native_batches = list(itertools.islice(mlm.iter_from(0), 8))
        per_native = (time.perf_counter() - t0) * 1e3 / 8
    finally:
        for k, fn in originals.items():
            setattr(_native, k, fn)
    with _native_off():
        t0 = time.perf_counter()
        numpy_batches = list(itertools.islice(mlm.iter_from(0), 8))
        per_numpy = (time.perf_counter() - t0) * 1e3 / 8
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(
        native_batches, numpy_batches) for k in a)
    rows["phase8_batches"] = dict(native_ms_a_batch=per_native,
                                  numpy_ms_a_batch=per_numpy, calls=calls,
                                  bit_identical=same)
    if calls != {"gather_rows": 8, "mlm_mask_batch": 8} or not same:
        failures.append(f"26d phase 8's batches: calls {calls}, same {same}")
    for name, r in rows.items():
        log(f"  26d {name}: {r}")
    out.update(rows)
    return out, failures


def _phase26e():
    """26e: ``python -m apex_tpu_torch.tools.step_profile --target gpt``
    in a process of its own (kineto drops a layer's events in a process
    that profiled before) at ``GptConfig()`` (train_gpt's, remat on),
    batch 8 x 2048, P26_PROFILE_STEPS profiled steps: exit 0, fractions
    summing to 1 within 1e-6, the MFU pin agreeing with its StepMeter,
    the trace's K1-K4 events equal to the launch counters over the same
    steps (a K4 launch is two kernels) and to the steps' counts;
    ``trace_summary`` over the same window lists K1-K4 with those counts;
    ``timeline --json`` over phase 24's span and flight dumps plus the
    window exits 0, and 1 with one request's terminal event deleted."""
    import contextlib
    import io
    import tempfile

    from apex_tpu_torch.tools import timeline, trace_summary

    root = os.path.dirname(os.path.abspath(__file__))
    out, failures = {}, []
    if not (P24_DUMPS.get("spans") and P24_DUMPS.get("flight")):
        # run alone (--tail): phase 24's dumps made here first
        import torch

        from apex_tpu_torch.models import GptConfig, GptModel

        log("  26e: phase 24's dumps first (24b and 24c)")
        _phase24b()
        _phase24c(GptModel(GptConfig(num_layers=P24_DRILL_LAYERS),
                           generator=torch.Generator("cuda")
                           .manual_seed(1234)))
        torch.cuda.empty_cache()
    steps = P26_PROFILE_STEPS
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_p26e_") as tmp:
        base = os.path.join(tmp, "trace")
        window = os.path.join(base, f"steps_{2:06d}_{1 + steps:06d}")
        report = os.path.join(tmp, "profile.json")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "apex_tpu_torch.tools.step_profile",
             "--target", "gpt", "--steps", str(steps), "--batch",
             str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--json", report,
             "--trace-dir", window, "--hlo-out", os.path.join(tmp, "rec"),
             "--metrics-out", os.path.join(tmp, "m.jsonl")],
            cwd=root, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=root))
        secs = time.perf_counter() - t0
        for line in p.stdout.splitlines():
            if not line.startswith("USDT"):
                log(f"  [26e] {line}")
        if p.returncode != 0:
            raise AssertionError(f"26e step_profile exited {p.returncode}:\n"
                                 + p.stdout[-3000:] + p.stderr[-3000:])
        with open(report) as f:
            rep = json.load(f)
        launches = {k: rep["launches"].get(k, 0) for k in P24_KERNELS}
        events = {k: rep["kernel_events"].get(layer, 0)
                  for k, (_, layer) in P24_KERNELS.items()}
        want_events = {k: per * launches[k]
                       for k, (per, _) in P24_KERNELS.items()}
        want_launches = {k: steps * n for k, n in
                         _gpt_step_launches(12).items()}
        mfu = rep["mfu"]
        log(f"  26e: step_profile in {secs:.1f} s: fractions "
            f"{rep['fractions']} (sum {rep['fraction_sum']!r}), MFU "
            f"{mfu}, step {rep['step_time_ms']:.3f} ms (trace "
            f"{rep['trace_step_ms']:.3f}), launches {launches} (want "
            f"{want_launches}), kernel events {events} (want {want_events})")
        if abs(rep["fraction_sum"] - 1.0) > 1e-6:
            failures.append(f"26e fractions sum {rep['fraction_sum']}")
        if not (mfu["meter"] > 0 and mfu["agreement"] < 1e-6):
            failures.append(f"26e MFU pin {mfu}")
        if launches != want_launches or events != want_events:
            failures.append(f"26e launches {launches} / events {events}")
        # trace_summary over the same window
        with contextlib.redirect_stdout(io.StringIO()):
            trace = trace_summary.load_trace(
                trace_summary.resolve_window(base))
        rows, summ = trace_summary.top_ops(trace)
        by_layer, rank = {}, {}
        for i, (name, _, n, layer) in enumerate(rows):
            by_layer[layer] = by_layer.get(layer, 0) + n
            rank.setdefault(layer, i + 1)
        listed = {k: by_layer.get(layer, 0)
                  for k, (_, layer) in P24_KERNELS.items()}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_summary = trace_summary.main([base, "-n", "12",
                                             "--attribution"])
        for line in buf.getvalue().splitlines():
            log(f"  [26e trace_summary] {line}")
        log(f"  26e trace_summary: {len(rows)} ops, {summ}; K1-K4 counts "
            f"{listed}, first rank by time {dict((k, rank.get(l)) for k, (_, l) in P24_KERNELS.items())}")
        if listed != want_events or rc_summary != 0:
            failures.append(f"26e trace_summary lists {listed}, rc "
                            f"{rc_summary}")
        # timeline over phase 24's dumps and the window
        argv = ["--spans", *P24_DUMPS["spans"], "--flight",
                *P24_DUMPS["flight"], "--trace-dir", base, "--json"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_clean = timeline.main(argv)
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        with open(P24_DUMPS["spans"][0]) as f:
            dump = json.load(f)
        terminal = next(e for e in dump["spans"]
                        if e.get("name") in timeline.TERMINALS)
        dump["spans"].remove(terminal)
        broken = os.path.join(tmp, "broken_spans.json")
        with open(broken, "w") as f:
            json.dump(dump, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_broken = timeline.main(["--spans", broken, *argv[
                1 + len(P24_DUMPS["spans"]):]])
        broken_summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"  26e timeline --json over {len(P24_DUMPS['spans'])} span "
            f"dumps, {len(P24_DUMPS['flight'])} flight dumps and the "
            f"window: exit {rc_clean}, requests {summary['requests']}, "
            f"canary windows {len(summary['canary']['windows'])}; one "
            f"terminal event deleted (rid {terminal.get('lane')}): exit "
            f"{rc_broken}, {broken_summary['violations'][:1]}")
        if rc_clean != 0 or rc_broken != 1:
            failures.append(f"26e timeline exits {rc_clean} / {rc_broken}")
    out.update(seconds=secs, fractions=rep["fractions"],
               fraction_sum=rep["fraction_sum"], mfu=mfu,
               step_time_ms=rep["step_time_ms"],
               trace_step_ms=rep["trace_step_ms"],
               bucket_fractions=rep["bucket_fractions"],
               roofline=rep["roofline"], launches=launches,
               kernel_events=events, trace_summary_counts=listed,
               timeline_exits=[rc_clean, rc_broken],
               timeline_requests=summary["requests"])
    return launches, out, failures


def _phase26f():
    """26f: ``gpt_model_provider()`` and ``bert_model_provider()`` at
    their TEST_CONFIG (f32) one forward and backward on the card against
    a CPU copy with the same weights: the loss and every gradient, with
    the f32 K1-K4 launches counted exactly (no remat: per layer two K1,
    two K2, one K3 and one K4; the final LayerNorm for GPT, the embedding
    and MLM transform's for BERT)."""
    import torch

    from apex_tpu_torch.models import bert_pretrain_loss, gpt_lm_loss
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.transformer import testing as ptesting

    out, failures, launches = {}, [], {}
    gen = torch.Generator().manual_seed(29)
    for name in ("gpt", "bert"):
        provider = getattr(ptesting, f"{name}_model_provider")
        card = provider(generator=torch.Generator("cuda").manual_seed(6))
        cpu = provider(device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        cfg = card.cfg
        s, b = 64, P26_PROVIDER_BATCH
        ids = torch.randint(0, cfg.vocab_size, (s, b), generator=gen)
        if name == "gpt":
            def loss_of(m, dev):
                return gpt_lm_loss(m, ids.to(dev))
            layers = cfg.num_layers
            want = {"layer_norm_fwd": 2 * layers + 1,
                    "layer_norm_bwd": 2 * layers + 1,
                    "flash_fwd_f32": layers, "flash_bwd_f32": layers}
        else:
            mask = torch.ones(b, s, dtype=torch.int64)
            mask[1, 40:] = 0
            labels = torch.where(torch.rand(s, b, generator=gen) < 0.2, ids,
                                 torch.full_like(ids, -1))
            batch = dict(input_ids=ids, token_type_ids=torch.zeros_like(ids),
                         attention_mask=mask, mlm_labels=labels,
                         nsp_labels=torch.randint(0, 2, (b,), generator=gen))

            def loss_of(m, dev):
                return bert_pretrain_loss(
                    m, {k: v.to(dev) for k, v in batch.items()})
            layers = cfg.num_layers
            want = {"layer_norm_fwd": 2 * layers + 2,
                    "layer_norm_bwd": 2 * layers + 2,
                    "flash_fwd_f32": layers, "flash_bwd_f32": layers}
        _dispatch.reset_launches()
        loss = loss_of(card, "cuda")
        loss.backward()
        torch.cuda.synchronize()
        counts = _launched(_dispatch.launches())
        ref = loss_of(cpu, "cpu")
        ref.backward()
        loss, ref = loss.detach(), ref.detach()
        loss_err = abs(float(loss) - float(ref)) / abs(float(ref))
        grad_err = max(_rel_max(a.grad, r.grad) for a, r in zip(
            card.parameters(), cpu.parameters()) if r.grad is not None)
        log(f"  26f {name}_model_provider() f32: loss {float(loss):.6f} vs "
            f"CPU {float(ref):.6f} (rel {loss_err:.2e}), worst gradient rel "
            f"{grad_err:.2e} (limit {P26_PROVIDER_TOL}); launches {counts} "
            f"(want {want})")
        if counts != want:
            failures.append(f"26f {name}: launches {counts} != {want}")
        if not (loss_err <= P26_PROVIDER_TOL and grad_err <= P26_PROVIDER_TOL):
            failures.append(f"26f {name}: loss {loss_err}, grads {grad_err}")
        out[name] = dict(loss=float(loss), loss_cpu=float(ref),
                         loss_rel=loss_err, grad_rel=grad_err,
                         launches=counts)
        launches[f"providers_{name}"] = counts
    return launches, out, failures


def phase26():
    """ROADMAP item 11 steps 1-5 on the card: 26a-26f (see their
    docstrings).  Every part logs its readings before any failure fails
    the phase.  Returns (the launches of each path, results)."""
    import torch

    t0 = time.perf_counter()
    log("phase 26: mlp and fused_dense at their public widths, the RNNs "
        "(the mLSTM of Radford et al. 2017), weight norm, the native host "
        "ops, step_profile/trace_summary/timeline on a GptConfig() step, "
        "the standalone providers")
    out, failures, launches, seconds = {}, [], {}, {}
    for name, part in (("26a", _phase26a), ("26b", _phase26b),
                       ("26c", _phase26c), ("26d", _phase26d),
                       ("26e", _phase26e), ("26f", _phase26f)):
        t = time.perf_counter()
        res = part()
        if name in ("26e", "26f"):
            launches.update({"step_profile": res[0]} if name == "26e"
                            else res[0])
        out[name], f = res[-2:]
        failures += f
        seconds[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    out["part_seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    log(f"  phase 26 by part: {out['part_seconds']} s")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 26 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 26: " + "; ".join(failures))
    return launches, out



# ---------------------------------------------------------------------------
# phase 27: the rest of ROADMAP item 11 (the remaining contrib packages)
# ---------------------------------------------------------------------------


#: 27a: ResNet-50's bottleneck shapes at phase 25's batch (in, bottleneck,
#: out, stride, input size): layer 3's stride-1 block and layer 2's first
#: block (stride 2, with its downsample); timed at P27_BATCH, held to the
#: CPU at P27_CHECK_BATCH (the CPU's f32 convolutions set the phase's
#: time)
P27_BATCH = 128
P27_CHECK_BATCH = 32
P27_BLOCKS = {"layer3": (1024, 256, 1024, 1, 14),
              "layer2_first": (256, 128, 512, 2, 56)}
#: 27a: the 3x3, 256-channel convolution at 56 x 56, batch 32 (the card
#: against the CPU on its first P27_CONV_CHECKED images)
P27_CONV = dict(batch=32, size=56, channels=256)
P27_CONV_CHECKED = 4
#: Stable Diffusion v1.5's UNet norms (diffusers UNet2DConditionModel:
#: norm_num_groups 32, block_out_channels 320/640/1280, sample_size 64)
#: at batch 8, NHWC
P27_GN_SHAPES = ((8, 64, 64, 320), (8, 32, 32, 640), (8, 16, 16, 1280))
P27_BN_SHAPE = (128, 14, 14, 1024)
#: 27a-27c: f32 on the card (TF32 off) against the same port function in
#: f32 on the CPU: max |card - cpu| / max |cpu|, the worst over the
#: outputs, the input gradients, the parameter gradients and the running
#: statistics.  Each planted fault must read more than 10x its limit.
#: On an H100 (700 W) the sound readings of ConvBias, GroupNorm, focal,
#: index_mul_2d and the halo cases were 1.1e-7 to 2.0e-5
P27_F32_TOL = 1e-4
#: ... but where a ReLU gates a gradient, an element whose pre-activation
#: lies within the convolution's f32 error (~1e-5 on the card's cuDNN
#: algorithms) of zero takes the other side of the gate on one of the two,
#: and its whole cotangent (up to ~1 against a tensor max of ~5) moves:
#: on an H100 (700 W) the max reading of such checks jumped from 1.5e-5 to
#: 0.17 with the seed (a handful of flipped gates), with the planted
#: faults at 0.86-1.3.  Those checks read the relative Frobenius error
#: ||card - cpu|| / ||cpu|| (the worst tensor) under this limit: 5.1e-6 to
#: 1.7e-3 sound, 0.79 to 1.64 for their planted faults
P27_GATED_TOL = 1e-2
#: 27a: the bf16 runs on the card against the CPU's f32, relative
#: Frobenius error over the output and the input gradient: bf16 rounding
#: of every activation through three convolutions and three batch-norm
#: backwards flips more ReLU gates than f32 does: an H100 (700 W) read
#: 5.1e-3-5.4e-3 on the output and 7.6e-2-7.8e-2 on dx (the planted faults
#: are read by the f32 twin, whose floor is far lower)
P27_BF16_TOL = 0.1
#: 27b: MLPerf Training RetinaNet's head on OpenImages: 264 classes,
#: 120087 anchors of an 800 x 800 image (9 anchors on P3-P7), batch 8,
#: bf16 logits, ~100 positive anchors an image, 1% ignored
P27_FOCAL = dict(batch=8, anchors=120087, classes=264, positives=100,
                 ignored=0.01)
#: 27b: in1 (65536, 128), 1048576 gathered rows (each row ~16 times)
P27_INDEX = dict(rows=65536, width=128, gathered=1 << 20)
#: 27b: of the order of MLPerf Training's RNN-T on LibriSpeech: B 8, T 256,
#: U 96 labels, joint width 512, vocabulary 1024 with the blank
P27_RNNT = dict(batch=8, frames=256, labels=96, hidden=512, vocab=1024)
#: 27b's card-against-CPU limits: focal (f32 math) and index_mul_2d
#: (f32; the card's scatter-add sums in an order that varies from run to
#: run) against the CPU in f32, the transducer's one sample against the
#: CPU in f64: max |card - cpu| / max |cpu| over the loss and gradients
P27_LOSS_TOL = 1e-4
#: 27b: the transducer's gradient on the card (f32) against the CPU's
#: f64, relative Frobenius.  The posterior exp(alpha + score + beta -
#: log_likelihood) cancels terms of ~2,000 nats in f32 (an ulp ~2e-4,
#: summed over ~350 diagonals), so single elements read up to 8.5e-4 of
#: the tensor's max on an H100 (700 W); the planted terminal moves the
#: whole last row of the lattice
P27_RNNT_GRAD_TOL = 1e-2
#: 27c: SpatialBottleneck at ResNet-50's layer 1 (in 256, bottleneck 64,
#: out 256), 56 x 56 split 28 / 28 over two ranks, batch 32
P27_SPATIAL = dict(batch=32, size=56, block=(256, 64, 256))
#: 27d: the permutation search's swaps on one fc2.weight
P27_PERM_SWAPS = 8
#: 27d: dense steps before pruning (they give the optimizer the moments
#: that the planted fault needs), then the sparse steps
P27_DENSE_STEPS = 2
P27_SPARSE_STEPS = 8


#: phase 27's seed offset (``--seed``; 0 by default)
P27_SEED = 0


def _p27_seed():
    return 27_000 + P27_SEED


def _p27_fwd_bwd(fn, inputs, gy, params=()):
    """``[y, *input grads, *parameter grads]`` of ``fn(*inputs)`` with
    cotangent ``gy`` (leaf copies of the inputs; the parameters' grads
    zeroed first)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    for p in params:
        p.grad = None
    y = fn(*leaves)
    y.backward(gy)
    return [y.detach()] + [t.grad for t in leaves] + [p.grad for p in params]


def _p27_check(tag, failures, sound, fault=None, tol=P27_F32_TOL):
    """Log ``sound`` (and ``fault``) beside ``tol``; a sound reading over
    it, or a fault reading not past 10x it, is a failure."""
    line = f"  {tag}: {sound:.3e} (limit {tol:.0e})"
    if fault is not None:
        line += f"; planted fault {fault:.3e}"
    log(line)
    if not (sound <= tol):
        failures.append(f"{tag}: {sound:.3e} > {tol}")
    if fault is not None and not (fault > 10 * tol):
        failures.append(f"{tag}: the planted fault reads {fault:.3e}")
    return dict(sound=sound, fault=fault, limit=tol)


def _p27_block(cin, cb, cout, stride, dtype, device, seed, spatial=False):
    """A seeded (Spatial)Bottleneck with its norms' parameters and
    running statistics drawn too (the same on every device)."""
    import torch

    from apex_tpu_torch.contrib import bottleneck, groupbn

    cls = bottleneck.SpatialBottleneck if spatial else bottleneck.Bottleneck
    g = torch.Generator().manual_seed(seed)
    block = cls(cin, cb, cout, stride, dtype=dtype, device=device,
                generator=g)
    with torch.no_grad():
        for mod in block.modules():
            if isinstance(mod, groupbn.BatchNorm2d_NHWC):
                c = mod.num_features
                mod.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                mod.bias.copy_(0.2 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.2 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return block


def _p27_block_run(block, x, gy):
    return _p27_fwd_bwd(lambda a: block(a, train=True), (x,), gy,
                        list(block.parameters())) + [
        b for name, b in block.named_buffers() if "running" in name]


def _phase27a():
    """27a: the NHWC vision blocks at full width.  ``Bottleneck`` at
    ResNet-50's layer 3 stride-1 block and layer 2's first block, batch
    128, in training: f32 on the card against f32 on the CPU (outputs,
    input and parameter gradients, running statistics) beside the
    residual dropped, bf16 on the card against the CPU's f32, and the
    bf16 forward + backward ms beside ``models/resnet.py``'s
    ``BottleneckBlock`` on NCHW (channels-last); the checks at batch
    P27_CHECK_BATCH.  ``ConvBias``,
    ``ConvBiasReLU`` and ``ConvBiasMaskReLU`` at the 3x3 256-channel conv
    (56 x 56, batch 32): the card's f32 against the CPU on 4 images, the
    bf16 ms beside ``F.conv2d`` with its bias + ReLU (27c's worker, a
    fresh process, profiles its forward's kernels).
    ``GroupNorm(32, C, act="silu")`` at Stable Diffusion v1.5's three
    UNet shapes: f32 against the CPU beside the statistics over one
    group, bf16 ms beside ``torch.nn.GroupNorm`` + ``F.silu``.
    ``BatchNorm2d_NHWC(fuse_relu=True)`` with ``z`` at (128, 14, 14,
    1024): f32 against the CPU beside the ReLU dropped, bf16 ms beside
    ``torch.nn.BatchNorm2d`` + add + ReLU.  No K1-K6 launch (the
    reference runs these outside Pallas)."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.contrib import conv_bias_relu as cbr
    from apex_tpu_torch.contrib import group_norm as gn
    from apex_tpu_torch.contrib import groupbn
    from apex_tpu_torch.models import resnet
    from apex_tpu_torch.ops import _dispatch

    out, failures = {}, []
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    g = torch.Generator().manual_seed(_p27_seed())
    gcuda = torch.Generator(device="cuda").manual_seed(_p27_seed())
    _dispatch.reset_launches()

    def fwd_bwd_ms(fn, x, gy):
        def run():
            fn(x.detach().requires_grad_(True)).backward(gy)
        return time_ms(run, iters=10, warmup=2, flush=flush)

    # Bottleneck
    for name, (cin, cb, cout, stride, size) in P27_BLOCKS.items():
        x = torch.randn(P27_CHECK_BATCH, size, size, cin, generator=g)
        gy = torch.randn(P27_CHECK_BATCH, size // stride, size // stride,
                         cout, generator=g)
        seed = _p27_seed() + stride
        cpu = _p27_block_run(
            _p27_block(cin, cb, cout, stride, torch.float32, "cpu", seed),
            x, gy)
        xc, gyc = x.cuda(), gy.cuda()
        card_block = _p27_block(cin, cb, cout, stride, torch.float32, "cuda",
                                seed)
        card = _p27_block_run(card_block, xc, gyc)
        faulty = _p27_block(cin, cb, cout, stride, torch.float32, "cuda",
                            seed)
        conv3 = faulty.conv3.forward
        faulty.conv3.forward = lambda y, z=None, train=True: conv3(
            y, None, train=train)
        fault = _p26_rel(_p27_block_run(faulty, xc, gyc), cpu, norm=True)
        del faulty
        res = _p27_check(f"27a Bottleneck {name} f32 (relative Frobenius)",
                         failures, _p26_rel(card, cpu, norm=True), fault,
                         tol=P27_GATED_TOL)
        res["max_rel"] = [_rel_max(a, b) for a, b in zip(card, cpu)]
        log(f"    by tensor (max |card - cpu| / max |cpu|): "
            f"{[f'{r:.1e}' for r in res['max_rel']]}")
        bf = _p27_block(cin, cb, cout, stride, torch.bfloat16, "cuda", seed)
        card_bf = _p27_fwd_bwd(lambda a: bf(a, train=True),
                               (xc.bfloat16(),), gyc.bfloat16())
        res["bf16_y_dx"] = [_rel_fro(a, b) for a, b in zip(card_bf[:2],
                                                            cpu[:2])]
        res["bf16"] = max(res["bf16_y_dx"])
        log(f"    bf16 y, dx: {[f'{r:.2e}' for r in res['bf16_y_dx']]}")
        _p27_check(f"27a Bottleneck {name} bf16 (relative Frobenius)",
                   failures, res["bf16"], tol=P27_BF16_TOL)
        cfg = resnet.resnet50_config(dtype=torch.bfloat16)
        ref_block = resnet.BottleneckBlock(cfg, cin, cout // 4, stride,
                                           "cuda")
        with torch.no_grad():
            for prm in ref_block.parameters():
                prm.normal_(0.0, 0.05)
        xb = torch.randn(P27_BATCH, size, size, cin, generator=gcuda,
                         device="cuda").bfloat16()
        gyb = torch.randn(P27_BATCH, size // stride, size // stride, cout,
                          generator=gcuda, device="cuda").bfloat16()
        res["ms"] = fwd_bwd_ms(lambda a: bf(a, train=True), xb, gyb)
        res["resnet_block_ms"] = fwd_bwd_ms(
            lambda a: ref_block(a.permute(0, 3, 1, 2), True, None),
            xb, gyb.permute(0, 3, 1, 2))
        log(f"  27a Bottleneck {name} bf16 forward + backward at batch "
            f"{P27_BATCH} {res['ms']:.3f} ms, models/resnet.py "
            f"BottleneckBlock (NCHW channels-last) "
            f"{res['resnet_block_ms']:.3f} ms")
        out[f"bottleneck_{name}"] = res
        del cpu, card_block, bf, ref_block, xb, gyb
        gc.collect()
        torch.cuda.empty_cache()

    # ConvBias, ConvBiasReLU, ConvBiasMaskReLU
    n, s, c = P27_CONV["batch"], P27_CONV["size"], P27_CONV["channels"]
    x = torch.randn(n, s, s, c, generator=g)
    w = torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5
    b = 0.1 * torch.randn(c, generator=g)
    mask = (torch.rand(n, s, s, c, generator=g) > 0.3).float()
    gy = torch.randn(n, s, s, c, generator=g)
    k = P27_CONV_CHECKED
    conv = {}
    for op in ("ConvBias", "ConvBiasReLU", "ConvBiasMaskReLU"):
        extra = (mask,) if op == "ConvBiasMaskReLU" else ()

        def fn(x, w, b, *m, op=op):
            return getattr(cbr, op)(x, w, b, *m)

        cpu = _p27_fwd_bwd(fn, (x[:k], w, b, *[e[:k] for e in extra]),
                           gy[:k])
        card = _p27_fwd_bwd(fn, (x[:k].cuda(), w.cuda(), b.cuda(),
                                 *[e[:k].cuda() for e in extra]),
                            gy[:k].cuda())
        if op == "ConvBias":
            conv[op] = _p27_check(f"27a {op} f32 ({k} images)", failures,
                                  _p26_rel(card[:4], cpu[:4]))
        else:
            conv[op] = _p27_check(
                f"27a {op} f32 ({k} images, relative Frobenius)", failures,
                _p26_rel(card[:4], cpu[:4], norm=True), tol=P27_GATED_TOL)
    xb = x.cuda().bfloat16()
    wb = w.cuda().bfloat16().contiguous(memory_format=torch.channels_last)
    bb, gyb = b.cuda().bfloat16(), gy.cuda().bfloat16()

    conv["ms"] = fwd_bwd_ms(lambda a: cbr.ConvBiasReLU(a, wb, bb), xb, gyb)
    conv["library_ms"] = fwd_bwd_ms(
        lambda a: F.relu(F.conv2d(a.permute(0, 3, 1, 2), wb, bb, padding=1)),
        xb, gyb.permute(0, 3, 1, 2))
    log(f"  27a ConvBiasReLU bf16 forward + backward {conv['ms']:.3f} ms, "
        f"F.conv2d + bias + ReLU {conv['library_ms']:.3f} ms")
    out["conv_bias_relu"] = conv
    del x, mask, gy, xb, wb, gyb
    torch.cuda.empty_cache()

    # GroupNorm + SiLU at the UNet's shapes
    gns = {}
    for shape in P27_GN_SHAPES:
        c = shape[-1]
        # per-channel offsets and scales, as activations have: statistics
        # over the wrong channels then read wrong
        x = torch.randn(*shape, generator=g) * (
            1 + torch.rand(c, generator=g)) + torch.randn(c, generator=g)
        gy = torch.randn(*shape, generator=g)
        wgt, bias = 1 + 0.2 * torch.randn(c, generator=g), \
            0.2 * torch.randn(c, generator=g)

        def run(x, w, b, groups=32):
            return gn.group_norm(x, groups, w, b, 1e-5, "silu")

        cpu = _p27_fwd_bwd(run, (x, wgt, bias), gy)
        dev = [t.cuda() for t in (x, wgt, bias)]
        card = _p27_fwd_bwd(run, dev, gy.cuda())
        bad = _p27_fwd_bwd(lambda *a: run(*a, groups=1), dev, gy.cuda())
        res = _p27_check(f"27a GroupNorm(32, {c}, silu) {shape} f32",
                         failures, _p26_rel(card, cpu),
                         _p26_rel(bad, cpu))
        module = gn.GroupNorm(32, c, act="silu")
        lib = torch.nn.GroupNorm(32, c, device="cuda")
        xb, gyb = dev[0].bfloat16(), gy.cuda().bfloat16()
        with torch.no_grad():
            for m in (module, lib):
                m.weight.copy_(dev[1])
                m.bias.copy_(dev[2])
        lib = lib.bfloat16()
        res["ms"] = fwd_bwd_ms(module, xb, gyb)
        res["library_ms"] = fwd_bwd_ms(
            lambda a: F.silu(lib(a.permute(0, 3, 1, 2))), xb,
            gyb.permute(0, 3, 1, 2))
        log(f"  27a GroupNorm {shape} bf16 forward + backward "
            f"{res['ms']:.3f} ms, torch.nn.GroupNorm + F.silu "
            f"{res['library_ms']:.3f} ms")
        gns["x".join(map(str, shape))] = res
    out["group_norm"] = gns
    torch.cuda.empty_cache()

    # BatchNorm2d_NHWC with the fused add + ReLU
    c = P27_BN_SHAPE[-1]
    x = torch.randn(*P27_BN_SHAPE, generator=g) * 1.5 + 0.3
    z = torch.randn(*P27_BN_SHAPE, generator=g)
    gy = torch.randn(*P27_BN_SHAPE, generator=g)

    def bn_module(device, fuse_relu=True, dtype=None):
        m = groupbn.BatchNorm2d_NHWC(c, fuse_relu=fuse_relu, dtype=dtype,
                                     device=device)
        with torch.no_grad():
            gg = torch.Generator().manual_seed(_p27_seed() + 5)
            m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gg))
            m.bias.copy_(0.2 * torch.randn(c, generator=gg))
        return m

    def bn_run(m, x, z, gy):
        return _p27_fwd_bwd(lambda a, b: m(a, b, use_running_average=False),
                            (x, z), gy, [m.weight, m.bias]) + [
            m.running_mean, m.running_var]

    cpu = bn_run(bn_module("cpu"), x, z, gy)
    dev = [t.cuda() for t in (x, z, gy)]
    res = _p27_check(
        "27a BatchNorm2d_NHWC(fuse_relu) + z f32 (relative Frobenius)",
        failures, _p26_rel(bn_run(bn_module("cuda"), *dev), cpu, norm=True),
        _p26_rel(bn_run(bn_module("cuda", False), *dev), cpu, norm=True),
        tol=P27_GATED_TOL)
    mod = bn_module("cuda")
    lib = torch.nn.BatchNorm2d(c, device="cuda")  # f32 parameters: cuDNN's
    xb, zb, gyb = (t.bfloat16() for t in dev)
    res["ms"] = fwd_bwd_ms(
        lambda a: mod(a, zb, use_running_average=False), xb, gyb)
    zc = zb.permute(0, 3, 1, 2)
    res["library_ms"] = fwd_bwd_ms(
        lambda a: F.relu(lib(a.permute(0, 3, 1, 2)) + zc), xb,
        gyb.permute(0, 3, 1, 2))
    log(f"  27a BatchNorm2d_NHWC bf16 forward + backward {res['ms']:.3f} "
        f"ms, torch.nn.BatchNorm2d + add + ReLU {res['library_ms']:.3f} ms")
    out["batchnorm_nhwc"] = res
    launched = _launched(_dispatch.launches())
    if launched:
        failures.append(f"27a launched {launched}")
    return out, failures


def _phase27b():
    """27b: the losses at full size, forward + backward on the card, and
    one sample of each against the same port function on the CPU:
    ``focal_loss`` at RetinaNet's OpenImages head (bf16 logits; the CPU
    in f32, the math's own precision) beside alpha not flipped for the
    negatives; ``index_mul_2d`` (f32) against the CPU over the whole
    batch beside an ``index_copy`` in place of the accumulating
    scatter-add; ``TransducerJoint(relu=True)``, a ``torch.matmul``
    projection (512 -> 1024) and ``TransducerLoss`` at the RNN-T sizes,
    its first sample against the CPU in f64 beside the terminal read at
    ``y_len - 1``.  The transducer's forward + backward ms and peak
    memory; no K1-K6 launch."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.contrib import focal_loss as fl
    from apex_tpu_torch.contrib import index_mul_2d as im
    from apex_tpu_torch.contrib import transducer as tr
    from apex_tpu_torch.ops import _dispatch

    out, failures = {}, []
    g = torch.Generator().manual_seed(_p27_seed() + 1)
    gc_ = torch.Generator(device="cuda").manual_seed(_p27_seed() + 1)
    _dispatch.reset_launches()

    def run_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # focal loss
    p = P27_FOCAL
    b, a, c = p["batch"], p["anchors"], p["classes"]
    logits = torch.randn(b, a, c, generator=gc_, device="cuda").bfloat16()
    targets = torch.zeros(b, a, dtype=torch.long)
    for i in range(b):
        pos = torch.randperm(a, generator=g)[:p["positives"] + int(
            p["ignored"] * a)]
        targets[i, pos[:p["positives"]]] = torch.randint(
            1, c + 1, (p["positives"],), generator=g)
        targets[i, pos[p["positives"]:]] = -1
    targets = targets.cuda()
    npos = torch.tensor(float((targets > 0).sum()), device="cuda")

    def focal(lg, t, n):
        lg = lg.detach().requires_grad_(True)
        loss = fl.focal_loss(lg, t, n)
        loss.backward()
        return [loss.detach(), lg.grad]

    torch.cuda.reset_peak_memory_stats()
    focal(logits, targets, npos)  # warm
    ms = run_ms(lambda: focal(logits, targets, npos))
    full = focal(logits, targets, npos)
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(t).all()) for t in full)
    # one image in f32 (the bf16 values, exact), on both sides
    one = [logits[:1].float(), targets[:1], npos]
    cpu = focal(*(t.cpu() for t in one))
    card = focal(*one)
    sound = _p26_rel(card, cpu)
    orig = fl.sigmoid_focal_loss

    def alpha_unflipped(lg, t, alpha=0.25, gamma=2.0, smoothing=0.0):
        # alpha_t = alpha for the negatives too
        return orig(lg, t, alpha, gamma, smoothing) * torch.where(
            t > 0, 1.0, alpha / (1.0 - alpha))

    with _p26_patched(fl, "sigmoid_focal_loss", alpha_unflipped):
        bad = focal(*one)
    res = _p27_check("27b focal_loss one image (CPU f32)", failures, sound,
                     _p26_rel(bad, cpu), tol=P27_LOSS_TOL)
    res.update(ms=ms, peak_memory_bytes=peak, finite=finite,
               loss=float(full[0]), positives=float(npos))
    log(f"  27b focal_loss {tuple(logits.shape)} bf16: loss "
        f"{float(full[0]):.4f} over {int(npos)} positives, forward + "
        f"backward {ms:.2f} ms, peak {peak / 1e9:.2f} GB, finite {finite}")
    if not finite:
        failures.append("27b focal_loss not finite")
    out["focal_loss"] = res
    del logits, targets, full, card, bad
    torch.cuda.empty_cache()

    # index_mul_2d
    p = P27_INDEX
    in1 = torch.randn(p["rows"], p["width"], generator=g)
    in2 = torch.randn(p["gathered"], p["width"], generator=g)
    idx = torch.randint(0, p["rows"], (p["gathered"],), generator=g)
    gy = torch.randn(p["gathered"], p["width"], generator=g)
    cpu = _p27_fwd_bwd(lambda a, b: im.index_mul_2d(a, b, idx), (in1, in2),
                       gy)
    dev = [t.cuda() for t in (in1, in2, idx, gy)]
    card = _p27_fwd_bwd(lambda a, b: im.index_mul_2d(a, b, dev[2]),
                        dev[:2], dev[3])
    copied = torch.zeros_like(dev[0]).index_copy_(0, dev[2], dev[3] * dev[1])
    res = _p27_check("27b index_mul_2d (CPU f32)", failures,
                     _p26_rel(card, cpu),
                     _p26_rel([card[0], copied, card[2]], cpu),
                     tol=P27_LOSS_TOL)

    def fwd_bwd(fn):
        def run():
            a = dev[0].detach().requires_grad_(True)
            b = dev[1].detach().requires_grad_(True)
            fn(a, b).backward(dev[3])
        return run

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    res["ms"] = time_ms(fwd_bwd(lambda a, b: im.index_mul_2d(a, b, dev[2])),
                        iters=10, flush=flush)
    res["library_ms"] = time_ms(
        fwd_bwd(lambda a, b: F.embedding(dev[2], a) * b), iters=10,
        flush=flush)
    log(f"  27b index_mul_2d forward + backward {res['ms']:.3f} ms, "
        f"F.embedding * in2 {res['library_ms']:.3f} ms")
    out["index_mul_2d"] = res
    del dev, cpu, card, copied
    torch.cuda.empty_cache()

    # the transducer: joint, projection, loss
    p = P27_RNNT
    bsz, t_, u_, h, v = (p[k] for k in ("batch", "frames", "labels",
                                        "hidden", "vocab"))
    f = torch.randn(bsz, t_, h, generator=gc_, device="cuda")
    gg = torch.randn(bsz, u_ + 1, h, generator=gc_, device="cuda")
    proj = torch.randn(h, v, generator=gc_, device="cuda") / h ** 0.5
    labels = torch.randint(1, v, (bsz, u_), generator=g).cuda()
    f_len = torch.randint(t_ // 2, t_ + 1, (bsz,), generator=g)
    y_len = torch.randint(u_ // 2, u_ + 1, (bsz,), generator=g)
    f_len[0], y_len[0] = t_, u_
    f_len, y_len = f_len.cuda(), y_len.cuda()
    joint, loss_fn = tr.TransducerJoint(relu=True), tr.TransducerLoss()

    def rnnt():
        fl_, gl_ = (t.detach().requires_grad_(True) for t in (f, gg))
        logits = torch.matmul(joint(fl_, gl_), proj)
        logits.retain_grad()
        nll = loss_fn(logits, labels, f_len, y_len)
        nll.sum().backward()
        return nll.detach(), logits

    rnnt()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = run_ms(rnnt)
    peak = torch.cuda.max_memory_allocated()
    nll, logits = rnnt()
    lg = logits.detach()
    loss_ms = run_ms(lambda: loss_fn(lg.clone().requires_grad_(True), labels,
                                     f_len, y_len).sum().backward())
    one = (labels[:1].cpu(), f_len[:1].cpu(), y_len[:1].cpu())

    def cpu64(y_len):
        x64 = lg[:1].double().cpu().requires_grad_(True)
        nll64 = loss_fn(x64, one[0], one[1], y_len)
        nll64.sum().backward()
        return nll64.detach(), x64.grad

    ref, ref_grad = cpu64(one[2])
    bad, bad_grad = cpu64(one[2] - 1)  # planted: the terminal at y_len - 1
    res = _p27_check("27b TransducerLoss sample 0 loss (CPU f64)", failures,
                     _p26_rel([nll[:1]], [ref]),
                     _p26_rel([bad], [ref]), tol=P27_LOSS_TOL)
    res["gradient"] = _p27_check(
        "27b TransducerLoss sample 0 gradient (CPU f64, relative "
        "Frobenius)", failures,
        _p26_rel([logits.grad[:1]], [ref_grad], norm=True),
        _p26_rel([bad_grad], [ref_grad], norm=True), tol=P27_RNNT_GRAD_TOL)
    finite = bool(torch.isfinite(nll).all()) and bool(
        torch.isfinite(logits.grad).all())
    res.update(ms=ms, loss_ms=loss_ms, peak_memory_bytes=peak,
               finite=finite, nll=nll.tolist(),
               logits_bytes=lg.numel() * lg.element_size())
    log(f"  27b RNN-T joint + projection + loss {tuple(lg.shape)}: forward "
        f"+ backward {ms:.1f} ms (the loss alone {loss_ms:.1f} ms), peak "
        f"{peak / 1e9:.2f} GB, nll {[round(x, 1) for x in nll.tolist()]}")
    if not finite:
        failures.append("27b transducer not finite")
    out["transducer"] = res
    launched = _launched(_dispatch.launches())
    if launched:
        failures.append(f"27b launched {launched}")
    return out, failures


def _p27_conv_layout(seed):
    """The CUDA kernels of one ``ConvBiasReLU`` forward (bf16, P27_CONV,
    a channels-last 3x3 weight) under ``torch.profiler``, and the layout
    copies around it: kernels that copy or transpose a layout, and the
    host's ``aten::copy_`` calls; the same with a contiguous OIHW weight,
    which the convolution must copy (the control).  Run in a process that
    has not profiled before: in one that has, kineto can drop a call's
    kernel events (the control's second profile once showed no copy
    kernel), which the host-side ``aten::copy_`` does not depend on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.contrib import conv_bias_relu as cbr

    n, s, c = P27_CONV["batch"], P27_CONV["size"], P27_CONV["channels"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, s, s, c, generator=g, device="cuda").bfloat16()
    w = (torch.randn(c, c, 3, 3, generator=g, device="cuda")
         / (9 * c) ** 0.5).bfloat16()
    b = torch.zeros(c, device="cuda", dtype=torch.bfloat16)
    out = {}
    for tag, weight in (("channels_last", w.contiguous(
            memory_format=torch.channels_last)), ("oihw", w.contiguous())):
        cbr.ConvBiasReLU(x, weight, b)  # warm: cuDNN picks its algorithm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cbr.ConvBiasReLU(x, weight, b)
            torch.cuda.synchronize()
        names = sorted({k[0] for k in device_kernels(prof)})
        copies = sum(e.count for e in prof.key_averages()
                     if e.key == "aten::copy_")
        out[tag] = dict(kernels=[nm[:120] for nm in names], layout=[
            nm[:120] for nm in names if any(t in nm.lower() for t in (
                "transpose", "nchwtonhwc", "nhwctonchw", "copy"))]
            + [f"aten::copy_ x{copies}"] * bool(copies))
    return out


def p27_halo(rank, world, seed):
    """27c worker (dp = ``world`` over gloo on the card): on rank 0 first,
    :func:`_p27_conv_layout` (a fresh process); the halo exchanges, ``SpatialBottleneck`` against the unsplit block in this
    process (eval), ``BatchNorm2d_NHWC(bn_group=world)`` against one
    BatchNorm over the whole batch, each beside its planted fault; the
    N/A stubs.  Returns the readings."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.contrib import (gpu_direct_storage, groupbn,
                                        nccl_allocator, nccl_p2p,
                                        peer_memory)

    out = {"conv_layout": _p27_conv_layout(seed)} if rank == 0 else {}
    ps.initialize_model_parallel()
    try:
        p = P27_SPATIAL
        n, s, (cin, cb, cout) = p["batch"], p["size"], p["block"]
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(n, s, s, cin, generator=g).cuda()
        rows = s // world
        strip = x[:, rank * rows:(rank + 1) * rows]

        def expected(halo):
            zero = torch.zeros_like(strip[:, :halo])
            above = zero if rank == 0 else x[:, rank * rows - halo:
                                             rank * rows]
            below = zero if rank == world - 1 else \
                x[:, (rank + 1) * rows:(rank + 1) * rows + halo]
            return torch.cat([above, strip, below], dim=1)

        for halo in (1, 3):
            got = peer_memory.halo_exchange_1d(strip, halo)
            want = expected(halo)
            zeros = torch.cat([torch.zeros_like(strip[:, :halo]), strip,
                               torch.zeros_like(strip[:, :halo])], dim=1)
            out[f"halo{halo}"] = [float((got - want).abs().max()),
                                  float((zeros - want).abs().max())]
        got = peer_memory.PeerHaloExchanger1d(half_halo=2)(strip)
        out["exchanger"] = float((got - expected(2)).abs().max())
        left = torch.full((8,), float(rank), device="cuda")
        li, ri = nccl_p2p.left_right_halo_exchange(left, left + 100)
        want_l = 0.0 if rank == 0 else 100.0 + rank - 1
        want_r = 0.0 if rank == world - 1 else rank + 1.0
        out["left_right"] = float(max((li - want_l).abs().max(),
                                      (ri - want_r).abs().max()))

        # the spatial block on this rank's strip against the unsplit one
        block_seed = seed + 1
        full = _p27_block(cin, cb, cout, 1, torch.float32, "cuda",
                          block_seed)
        spatial = _p27_block(cin, cb, cout, 1, torch.float32, "cuda",
                             block_seed, spatial=True)
        with torch.no_grad():
            want = full(x, train=False)[:, rank * rows:(rank + 1) * rows]
            got = spatial(strip, train=False)
            out["spatial_eval"] = _rel_max(got, want)
            # planted: the halos left at zero (the strip's own padding)
            with _p26_patched(spatial.conv2, "spatial_axis_name", None):
                out["spatial_eval_zero_halos"] = _rel_max(
                    spatial(strip, train=False), want)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spatial(strip.detach().clone().requires_grad_(True),
                train=True).sum().backward()
        torch.cuda.synchronize()
        out["spatial_train_step_ms"] = (time.perf_counter() - t0) * 1e3

        # bn_group over the two ranks against one BatchNorm on the batch
        shape = P27_BN_SHAPE
        c = shape[-1]
        xb = torch.randn(*shape, generator=g)
        half = shape[0] // world
        xb[half:] = xb[half:] * 2.0 + 1.0  # the halves differ
        gy = torch.randn(*shape, generator=g)
        xb, gy = xb.cuda(), gy.cuda()

        def bn_run(bn, x, gy):
            return _p27_fwd_bwd(lambda a: bn(a, use_running_average=False),
                                (x,), gy) + [bn.running_mean, bn.running_var]

        lo, hi = rank * half, (rank + 1) * half
        one = bn_run(groupbn.BatchNorm2d_NHWC(c, fuse_relu=True), xb, gy)
        with nccl_allocator.nccl_mem():
            grouped = bn_run(groupbn.BatchNorm2d_NHWC(
                c, fuse_relu=True, bn_group=world), xb[lo:hi], gy[lo:hi])
        local = bn_run(groupbn.BatchNorm2d_NHWC(c, fuse_relu=True),
                       xb[lo:hi], gy[lo:hi])
        want = [one[0][lo:hi], one[1][lo:hi], one[2], one[3]]
        out["bn_group"] = _p26_rel(grouped, want, norm=True)
        out["bn_group_local"] = _p26_rel(local, want, norm=True)
        nccl_allocator.init()
        refused = []
        for fn in (gpu_direct_storage.load_data,
                   peer_memory.PeerMemoryPool().allocate_peer_tensors):
            try:
                fn("unused")
            except NotImplementedError as exc:
                refused.append(str(exc)[:60])
        out["refused"] = refused
        return out
    finally:
        ps.destroy_model_parallel()


def _phase27c():
    """27c: two worker processes on the card over gloo, one launch for
    every case (:func:`p27_halo`): no layout copy or transpose around
    ``ConvBiasReLU``'s convolution with a channels-last weight (a
    contiguous OIHW weight shows one); ``halo_exchange_1d`` (halo 1 and 3)
    and ``PeerHaloExchanger1d`` exactly the neighbours' rows (beside the
    halos left at zero), ``left_right_halo_exchange``,
    ``SpatialBottleneck`` at ResNet-50's layer 1 (56 x 56 split 28 / 28,
    batch 32) in eval against the unsplit ``Bottleneck`` (beside the
    halos left at zero), ``BatchNorm2d_NHWC(bn_group=2)`` against one
    process over the whole batch (beside the statistics left local),
    inside ``nccl_mem()``; ``load_data`` and ``allocate_peer_tensors``
    refuse."""
    ranks = _p16_spawn(2, "gloo", [("run", "p27_halo",
                                    {"seed": _p27_seed() + 2})])
    out, failures = {"ranks": [r["run"] for r in ranks]}, []
    runs = out["ranks"]
    for halo in (1, 3):
        sound = max(r[f"halo{halo}"][0] for r in runs)
        fault = max(r[f"halo{halo}"][1] for r in runs)
        log(f"  27c halo_exchange_1d halo {halo}: max |got - neighbour rows| "
            f"{sound} (exact); halos left at zero {fault:.3e}")
        if sound != 0.0 or fault == 0.0:
            failures.append(f"27c halo {halo}: {sound}, fault {fault}")
    for key in ("exchanger", "left_right"):
        worst = max(r[key] for r in runs)
        log(f"  27c {key}: {worst} (exact)")
        if worst != 0.0:
            failures.append(f"27c {key}: {worst}")
    out["spatial"] = _p27_check(
        "27c SpatialBottleneck eval against the unsplit block", failures,
        max(r["spatial_eval"] for r in runs),
        max(r["spatial_eval_zero_halos"] for r in runs))
    out["bn_group"] = _p27_check(
        "27c BatchNorm2d_NHWC(bn_group=2) against one process (relative "
        "Frobenius)", failures, max(r["bn_group"] for r in runs),
        max(r["bn_group_local"] for r in runs), tol=P27_GATED_TOL)
    log(f"  27c SpatialBottleneck train step a rank "
        f"{[round(r['spatial_train_step_ms'], 1) for r in runs]} ms (two "
        f"processes on one card, gloo host staging: not a rank's speed)")
    if any(len(r["refused"]) != 2 for r in runs):
        failures.append(f"27c refusals {[r['refused'] for r in runs]}")
    lay = runs[0]["conv_layout"]
    log(f"  27c ConvBiasReLU forward kernels (rank 0, a fresh process): "
        f"{lay['channels_last']['kernels']}")
    log(f"  27c layout copies around the convolution: "
        f"{lay['channels_last']['layout']} (a contiguous OIHW weight, the "
        f"control: {lay['oihw']['layout']})")
    if (not lay["channels_last"]["kernels"] or lay["channels_last"]["layout"]
            or not lay["oihw"]["layout"]):
        failures.append(f"27c conv layout: {lay}")
    out["conv_layout"] = lay
    return out, failures


def _p27_violations(model, masks):
    """(groups of 4 along the input axis holding more than 2 non-zeros,
    groups holding fewer), over the pruned weights."""
    more = fewer = 0
    for name, p in model.named_parameters():
        m = masks[name]
        if m.ndim:
            nz = (p.detach() != 0).movedim(1, -1)
            nz = nz.reshape(*nz.shape[:-1], -1, 4).sum(dim=-1)
            more += int((nz > 2).sum())
            fewer += int((nz < 2).sum())
    return more, fewer


def _phase27d():
    """27d: ASP on ``GptConfig(remat=True)`` at phase 6's batch (8 x
    2048) over K1-K4: 2 dense FusedAdam steps (their launches a step the
    dense step's), ``ASP.prune_trained_model`` over the named parameters,
    then 8 steps with the masks applied to the gradients before each step
    and to the weights after it.  Every pruned weight keeps exactly 2
    non-zeros in each group of 4 along its input axis; the losses finite
    and falling; K1-K4 launches a step equal to the dense step's (masking
    launches none of K1-K6).  One more step without the masks re-applied
    after it (the planted fault) must leave groups with more than 2.
    The masks of ``resnet50()``'s weights on the card equal the CPU's bit
    for bit; ``compute_permutations`` on ``layers.0.fc2.weight`` (1024 x
    4096, P27_PERM_SWAPS swaps) gives the CPU's permutation, ``after >=
    before``.  Returns (the sparse steps' launches, results)."""
    import torch

    from apex_tpu_torch.contrib.sparsity import ASP
    from apex_tpu_torch.data import DataLoader, TokenFileDataset
    from apex_tpu_torch.examples import train_gpt
    from apex_tpu_torch.models import GptConfig, GptModel, resnet50
    from apex_tpu_torch.models.gpt import gpt_lm_loss
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam

    out, failures = {}, []
    cfg = GptConfig(vocab_size=50304, remat=True, max_seq_len=TRAIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GptModel(cfg)  # weights seeded with 0
    opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
    args = train_gpt.parse_args(["--seq-len", str(TRAIN_SEQ)])
    loader = iter(DataLoader(TokenFileDataset(
        train_gpt.corpus(args, cfg.vocab_size), seq_len=TRAIN_SEQ),
        batch_size=TRAIN_BATCH, seed=7))
    params = dict(model.named_parameters())

    def steps(n, masks=None, reapply=True):
        losses, seconds = [], []
        for _ in range(n):
            ids = torch.as_tensor(next(loader).T.astype(np.int64),
                                  device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = gpt_lm_loss(model, ids)
            loss.backward()
            if masks is not None:
                ASP.apply_masks_({k: p.grad for k, p in params.items()},
                                 masks)
            opt.step()
            opt.zero_grad(set_to_none=True)
            if masks is not None and reapply:
                ASP.apply_masks_(params, masks)
            losses.append(loss.item())
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return losses, seconds

    _dispatch.reset_launches()
    dense_losses, dense_s = steps(P27_DENSE_STEPS)
    dense = {k: n // P27_DENSE_STEPS
             for k, n in _launched(_dispatch.launches()).items()}
    layers = cfg.num_layers
    per_step = {"layer_norm_fwd": 2 * (2 * layers) + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "flash_fwd": 2 * layers, "flash_bwd": layers}
    if dense != per_step:
        failures.append(f"27d dense launches a step {dense} != {per_step}")
    fc2 = params["layers.0.fc2.weight"].detach().clone()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pruned, masks = ASP.prune_trained_model(params)
    with torch.no_grad():
        for name, m in masks.items():
            if m.ndim:
                params[name].copy_(pruned[name])
    del pruned
    torch.cuda.synchronize()
    prune_ms = (time.perf_counter() - t0) * 1e3
    n_pruned = sum(1 for m in masks.values() if m.ndim)
    pruned_elems = sum(m.numel() for m in masks.values() if m.ndim)
    _dispatch.reset_launches()
    losses, seconds = steps(P27_SPARSE_STEPS, masks)
    launches = _launched(_dispatch.launches())
    want = {k: n * P27_SPARSE_STEPS for k, n in dense.items()}
    more, fewer = _p27_violations(model, masks)
    _, _ = steps(1, masks, reapply=False)
    fault_more, _ = _p27_violations(model, masks)
    log(f"  27d ASP on GptConfig(remat=True): {n_pruned} weights pruned "
        f"({pruned_elems} elements) in {prune_ms:.1f} ms; dense steps "
        f"{[round(x, 4) for x in dense_losses]}, sparse steps "
        f"{[round(x, 4) for x in losses]}")
    log(f"  27d launches over {P27_SPARSE_STEPS} sparse steps {launches} "
        f"(want {want}: the dense step's {dense} a step)")
    log(f"  27d groups of 4 off 2:4 after the last step: {more} with more "
        f"than 2 non-zeros, {fewer} with fewer; planted (masks not "
        f"re-applied after one more step): {fault_more} with more")
    step_ms = statistics.median(seconds[1:]) * 1e3
    dense_ms = dense_s[-1] * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"  27d sparse step median {step_ms:.1f} ms (the second dense step "
        f"{dense_ms:.1f} ms), peak {peak / 1e9:.2f} GB")
    if launches != want:
        failures.append(f"27d launches {launches} != {want}")
    if more or fewer or not fault_more:
        failures.append(f"27d 2:4 violations {more}/{fewer}, fault "
                        f"{fault_more}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"27d losses not finite and falling: {losses}")
    out.update(pruned_weights=n_pruned, pruned_elements=pruned_elems,
               prune_ms=prune_ms, dense_losses=dense_losses, losses=losses,
               dense_launches_per_step=dense, launches=launches,
               violations=[more, fewer], fault_violations=fault_more,
               step_ms_median=step_ms, dense_step_ms=dense_ms,
               peak_memory_bytes=peak)
    del model, opt, params, masks
    gc.collect()
    torch.cuda.empty_cache()

    # resnet50()'s masks: the card's equal the CPU's bit for bit
    net = resnet50(device="cpu",
                   generator=torch.Generator().manual_seed(_p27_seed()))
    cpu_masks = ASP.compute_sparse_masks(dict(net.named_parameters()))
    card_masks = ASP.compute_sparse_masks(
        dict(net.cuda().named_parameters()))
    differ = [k for k in cpu_masks
              if not torch.equal(card_masks[k].cpu(), cpu_masks[k])]
    n_res = sum(1 for m in cpu_masks.values() if m.ndim)
    log(f"  27d resnet50() masks: {n_res} weights pruned, {len(differ)} "
        f"differ between the card and the CPU")
    if differ or not n_res:
        failures.append(f"27d resnet50 masks differ: {differ[:4]}")
    out["resnet50_masks"] = dict(pruned=n_res, differ=len(differ))
    del net, cpu_masks, card_masks

    # the permutation search on one fc2.weight, card and CPU
    res = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perms = ASP.compute_permutations({"fc2.weight": fc2.to(dev)},
                                         max_swaps=P27_PERM_SWAPS)
        torch.cuda.synchronize()
        e = perms["fc2.weight"]
        res[dev] = dict(perm=e["perm"].cpu(), before=e["before"],
                        after=e["after"],
                        ms=(time.perf_counter() - t0) * 1e3)
    same = torch.equal(res["cuda"]["perm"], res["cpu"]["perm"])
    moved = int((res["cuda"]["perm"] != torch.arange(fc2.shape[1])).sum())
    log(f"  27d compute_permutations fc2.weight {tuple(fc2.shape)}, "
        f"{P27_PERM_SWAPS} swaps: kept magnitude {res['cuda']['before']:.2f}"
        f" -> {res['cuda']['after']:.2f} (CPU {res['cpu']['after']:.2f}), "
        f"{moved} channels moved, the same permutation on both: {same}; "
        f"{res['cuda']['ms']:.0f} ms on the card, {res['cpu']['ms']:.0f} ms "
        f"on the CPU")
    if not same or not res["cuda"]["after"] >= res["cuda"]["before"]:
        failures.append("27d permutation search differs or loses")
    out["permutation"] = {d: {k: v for k, v in r.items() if k != "perm"}
                          for d, r in res.items()}
    out["permutation"].update(same=same, moved=moved)
    return {"asp": launches}, out, failures


def phase27():
    """ROADMAP item 11's last step on the card: 27a-27d (see their
    docstrings).  Every part logs its readings before any failure fails
    the phase.  Returns (the ASP path's launches, results)."""
    import torch

    t0 = time.perf_counter()
    log(f"phase 27: the remaining contrib packages (NHWC vision blocks, "
        f"focal and transducer losses, halo exchange, ASP on "
        f"GptConfig(remat=True)); seed offset {P27_SEED or 0}")
    out, failures, launches, seconds = {}, [], {}, {}
    for name, part in (("27a", _phase27a), ("27b", _phase27b),
                       ("27c", _phase27c), ("27d", _phase27d)):
        t = time.perf_counter()
        res = part()
        if name == "27d":
            launches.update(res[0])
        out[name], f = res[-2:]
        failures += f
        seconds[name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    out["part_seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    log(f"  phase 27 by part: {out['part_seconds']} s")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 27 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 27: " + "; ".join(failures))
    return launches, out


# ---------------------------------------------------------------------------
# phase 28: the root tools that drive the system (ROADMAP item 12)
# ---------------------------------------------------------------------------


#: 28a: the port's serve_bench at GptConfig()'s width (vocab, hidden,
#: layers, heads, FFN) in the tool's own f32, batch 8 on 16-token pages
#: with 64 pages a sequence (1024 positions, the RoPE table's length:
#: the longest prompt, 768, plus the longest output, 128, fits) and
#: enough pages that no request waits for one (8 x 64 + 1, and as many
#: again for the prefix cache)
P28_MODEL = ("--vocab", "50304", "--hidden", "1024", "--layers", "12",
             "--heads", "16", "--intermediate", "4096")
P28_SERVE = ("--batch", "8", "--page-size", "16", "--pages-per-seq", "64",
             "--pages", "1025")
P28_LOAD = ("--requests", "48", "--prompt-mix", "64", "256", "768",
            "--output-mix", "32", "64", "128")
#: the Poisson rate (requests/s): the highest of the sweep in PERF.md
#: (4 to 64 requests/s) at which the first invocation sheds nothing and
#: its mean batch fill is above the single-request baseline.  Every rate
#: of the sweep meets both (1025 pages shed nothing, and the fill rises
#: with the rate), so this is the sweep's top
P28_RATE = 64.0
#: the first invocation's TTFT SLO: only the threshold of the burn-rate
#: alerts it prints (no gate reads them, and no source gives the value)
P28_SLO_TTFT_MS = 1000.0
P28_RUNS = (
    ("serve_bench", ("--prefix-cache", "--shared-prefix-tokens", "512",
                     "--shared-frac", "0.75", "--chunk-tokens", "512",
                     "--ops-port", "0", "--slo-ttft-ms",
                     str(P28_SLO_TTFT_MS))),
    ("serve_bench_int8_spec", ("--kv-wire", "int8", "--weight-wire", "int8",
                               "--speculate", "4", "--draft-layers", "2")),
)
#: 28b: the goodput drill's ledger at its defaults, as the reference
#: drill (tools/goodput_drill.py) gives it on the CPU
P28_GOODPUT = dict(accepted=60, skipped=0, discarded=0, retries=1,
                   resumes=4, invocations=5)
#: 28d: the sweeps at their smallest setting
P28_INT8WIRE = ("small (9.5k params)", 256)
P28_PIPELINE_PP = 2


def _time_p28_prefill(gen, flush):
    """K3 f32 at 28a's longest prefill (q/k/v (16, 768, 64) f32, causal)
    beside the plain version and f32 SDPA; the bound from its launch
    plan."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as attn

    bh, s, d = P28_PREFILL
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(scale=d ** -0.5, causal=True)
    row = dict(
        shape=f"BH={bh} S={s} D={d} causal f32 (phase 28a's prefill)",
        ms=time_ms(lambda: attn.flash_fwd(q, k, v, **kw), flush=flush),
        plain_ms=time_ms(lambda: attn.flash_fwd_reference(q, k, v, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, scale=d ** -0.5),
            flush=flush),
    )
    row["bound_ms"], row["bound_by"] = roofline_bound(attn.kernel_specs(
        bh, s, s, d, dtype=torch.float32, causal=True, modes=("fwd",)))
    return row


@contextlib.contextmanager
def _p28_engine_calls():
    """Record every engine call that launches kernels while the block
    runs — prefill, chunk prefill, decode (a graph replay), spec round,
    draft prefill — and every unpaged ``GptModel`` forward, each with
    the depths it ran at: ``(kind, layers, draft layers, k)``."""
    from apex_tpu_torch.models import GptModel
    from apex_tpu_torch.serve import InferenceEngine

    calls = []
    saved = {}

    def wrap(cls, name, kind):
        fn = saved[(cls, name)] = getattr(cls, name)

        def call(self, *a, **kw):
            out = fn(self, *a, **kw)
            if cls is GptModel:
                calls.append((kind, self.cfg.num_layers, 0, 0))
            else:
                calls.append((kind, self.cfg.num_layers,
                              self.draft_cfg.num_layers
                              if self.draft_cfg is not None else 0,
                              self.spec.k if self.spec is not None else 0))
            return out

        setattr(cls, name, call)

    for name, kind in (("prefill", "prefill"), ("chunk_prefill", "chunk"),
                       ("decode", "decode"), ("spec_step", "spec"),
                       ("draft_prefill", "draft_prefill")):
        wrap(InferenceEngine, name, kind)
    wrap(GptModel, "forward", "forward")
    try:
        yield calls
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def _p28_want(calls):
    """The exact K1/K3 f32/K6 launches of ``calls``: a prefill or an
    unpaged forward K1 2L + 1 and K3 L; a chunk call K1 2L + 1 (its
    attention is the plain composition); a decode replay K1 2L + 1 and
    K6 L; a draft prefill the draft's K1 2Ld + 1 and K3 Ld; a spec round
    k + 1 draft steps and k + 1 verify steps (K1 2Ld + 1 and 2L + 1, K6
    Ld and L a step).  The model is f32, so K3 is its f32 instance."""
    want = {}

    def add(name, n):
        if n:
            want[name] = want.get(name, 0) + n

    for kind, layers, ld, k in calls:
        if kind in ("prefill", "forward"):
            add("layer_norm_fwd", 2 * layers + 1)
            add("flash_fwd_f32", layers)
        elif kind == "chunk":
            add("layer_norm_fwd", 2 * layers + 1)
        elif kind == "decode":
            add("layer_norm_fwd", 2 * layers + 1)
            add("paged_decode", layers)
        elif kind == "draft_prefill":
            add("layer_norm_fwd", 2 * ld + 1)
            add("flash_fwd_f32", ld)
        elif kind == "spec":
            add("layer_norm_fwd", (k + 1) * (2 * ld + 1 + 2 * layers + 1))
            add("paged_decode", (k + 1) * (ld + layers))
    return want


def _phase28a(tmp):
    """``apex_tpu_torch.tools.serve_bench`` at GptConfig()'s width (f32),
    twice, through its ``main`` in this process: f32 pages with the
    prefix cache, 512-token chunks, the ops endpoint on an OS-assigned
    port, a TTFT SLO and span chains (``tools/timeline.py --json`` then
    accounts for them, as the reference's serving gate does), then both
    int8 wires with a 2-layer draft proposing 4 tokens.  Each must exit
    0 under the tool's own gates (batch fill over the single-request
    baseline, both numerics records within TOL_F32 / TOL_INT8_KV, the
    build's reports over ``decode`` and a ``prefill*`` program with no
    ERROR, the prefix and spec replays bit-identical).  The launch
    counters are zeroed just before each invocation and read just after;
    they must equal :func:`_p28_want` of the engine calls it made."""
    import io

    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.tools import serve_bench, timeline

    launches, out, failures = {}, {}, []
    for tag, extra in P28_RUNS:
        art_path = os.path.join(tmp, f"{tag}.json")
        argv = [*P28_MODEL, *P28_SERVE, *P28_LOAD, "--rate", str(P28_RATE),
                *extra, "--json", art_path]
        spans = None
        if tag == "serve_bench":
            spans = os.path.join(tmp, "spans.json")
            argv += ["--spans", spans]
        gc.collect()
        torch.cuda.empty_cache()
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        _dispatch.reset_launches()
        _dispatch.clear_paths()
        with _p28_engine_calls() as calls, \
                contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(err):
            rc = serve_bench.main(argv)
        got = _dispatch.launches()
        paths = _dispatch.last_paths()
        dtypes = _dispatch.launch_dtypes()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            if not line.startswith("  ") or "ms |" not in line:
                log(f"  28a {tag}: {line}")
        for line in err.getvalue().splitlines():
            log(f"  28a {tag} stderr: {line}")
        want = _p28_want(calls)
        kinds = {}
        for kind, *_ in calls:
            kinds[kind] = kinds.get(kind, 0) + 1
        log(f"  28a {tag}: exit {rc} in {secs:.1f} s; engine calls {kinds}; "
            f"launches {got} (want {want}); dtypes {dtypes}; paths {paths}")
        launches[tag] = got
        with open(art_path) as f:
            art = json.load(f)
        load = art["load"]
        rec = dict(
            exit=rc, seconds=secs, calls=kinds, launches=got,
            launch_dtypes=dtypes,
            ttft_ms=load["ttft_ms"], per_token_ms=load["per_token_ms"],
            tokens_per_s=load["tokens"]["throughput_per_s"],
            goodput=load["requests"]["goodput"],
            token_goodput=load["tokens"]["goodput"],
            shed=load["requests"]["shed_reasons"],
            batch_fill=load["batch_fill"],
            baseline_fill=art["batch_fill_single_request_baseline"],
            ttft_attribution={k: v for k, v in load["ttft_attribution"].items()
                              if k.endswith("_ms")},
            numerics=art["numerics_vs_unpaged_f32"],
            programs=sorted(art["graph_lint_errors"]),
            memstats_findings=[f["message"] for f in
                               art["memstats"]["findings"]],
            live_peaks=art["memstats"]["live_peaks"],
            wall_s=load["wall_s"])
        for sec in ("prefix", "spec"):
            if sec in load:
                rec[sec] = {k: v for k, v in load[sec].items()
                            if k not in ("leak_checks_run",)}
        if art["slo"] is not None:
            rec["slo_alerts"] = art["slo"]["alerts_fired"]
        if art["ops"] is not None:
            rec["ops_scrape_ok"] = [bool(art["ops"]["mid_scrape"] and
                                         art["ops"]["mid_scrape"]["ok"]),
                                    bool(art["ops"]["scrape"]["ok"])]
        out[tag] = rec
        if rc != 0:
            failures.append(f"28a {tag} exited {rc}: {art['failures']}")
        if got != want:
            failures.append(f"28a {tag} launches {got} != {want}")
        if set(paths.values()) != {"cuda"}:
            failures.append(f"28a {tag} op paths {paths}")
        if load["requests"]["shed"]:
            failures.append(
                f"28a {tag} shed {load['requests']['shed_reasons']}")
        if spans is not None:
            tbuf = io.StringIO()
            with contextlib.redirect_stdout(tbuf):
                rc_tl = timeline.main(["--spans", spans, "--json"])
            summary = json.loads(tbuf.getvalue().strip().splitlines()[-1])
            log(f"  28a timeline --json over the spans: exit {rc_tl}, "
                f"requests {summary['requests']}, violations "
                f"{summary['violations'][:2]}")
            rec["timeline"] = dict(exit=rc_tl, requests=summary["requests"])
            if rc_tl != 0:
                failures.append(f"28a timeline exited {rc_tl}")
    return launches, out, failures


def _phase28b(tmp):
    """``apex_tpu_torch.tools.goodput_drill`` at its defaults on the card,
    through its ``main`` in this process: it must print PASS, and its
    ledger must equal the reference drill's at the same flags
    (P28_GOODPUT).  Its kernel launches are counted (the toy regression
    reaches no K1-K6)."""
    import io

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.tools import goodput_drill

    art_path = os.path.join(tmp, "goodput.json")
    buf = io.StringIO()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = goodput_drill.main(["--dir", os.path.join(tmp, "drill"),
                                 "--json", art_path])
    secs = time.perf_counter() - t0
    got = _dispatch.launches()
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith("[spans]"):
            log(f"  28b {line}")
    with open(art_path) as f:
        art = json.load(f)
    ledger = {k: art["accountant"][k] for k in P28_GOODPUT
              if k != "invocations"}
    ledger["invocations"] = art["invocations"]
    out = dict(exit=rc, seconds=secs, ledger=ledger,
               goodput=art["goodput"], stall_frac=art["ckpt"]["stall_frac"],
               storm_max_stall_frac=art["ckpt"]["storm_max_stall_frac"],
               snapshot_ms_median=statistics.median(art["ckpt"]["snapshot_ms"])
               if art["ckpt"]["snapshot_ms"] else None,
               write_ms_median=statistics.median(art["ckpt"]["write_ms"])
               if art["ckpt"]["write_ms"] else None,
               bit_exact=art["loss_trajectory"]["bit_exact"],
               midwrite=art["planted_midwrite"], launches=got)
    log(f"  28b goodput drill: exit {rc} in {secs:.1f} s; ledger {ledger}; "
        f"stall {out['stall_frac']:.5f}; launches {got}")
    failures = []
    if rc != 0 or "goodput drill: PASS" not in text:
        failures.append(f"28b goodput drill exited {rc}")
    if ledger != P28_GOODPUT:
        failures.append(f"28b ledger {ledger} != {P28_GOODPUT}")
    return out, failures


def _phase28c(tmp):
    """``flight_view`` renders phase 24b's kept flight dump (its render,
    then ``--json``, whose counts must equal the dump's own), and
    ``concurrency_lint`` lints ``apex_tpu_torch/`` in a process of its
    own: both exit 0, the lint with no finding."""
    import io

    from apex_tpu_torch.tools import flight_view

    failures, out = [], {}
    if not P24_DUMPS.get("flight"):
        log("  28c: phase 24b's flight dump first")
        _phase24b()
    dump = P24_DUMPS["flight"][0]
    with open(dump) as f:
        data = json.load(f)
    want = dict(
        reason=data["reason"], frames=len(data["frames"]),
        events=len(data["events"]),
        frame_skips=sum(1 for fr in data["frames"] if fr.get("skipped")),
        rollbacks=sum(1 for e in data["events"] if e["kind"] == "rollback"),
        retries=sum(1 for e in data["events"] if e["kind"] == "retry"),
        health_events=sum(1 for e in data["events"]
                          if e["kind"] == "health"),
        preempted=any(e["kind"] == "preempt" for e in data["events"]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_render = flight_view.main([dump])
    rendered = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_json = flight_view.main([dump, "--json"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = {k: summary[k] for k in want}
    log(f"  28c flight_view: render exit {rc_render} "
        f"({len(rendered.splitlines())} lines: "
        f"{rendered.splitlines()[1].strip()}), --json exit {rc_json}: {got}")
    out["flight_view"] = dict(exits=[rc_render, rc_json], summary=got)
    if rc_render != 0 or rc_json != 0 or got != want:
        failures.append(f"28c flight_view exits {rc_render}/{rc_json}, "
                        f"summary {got} != {want}")
    root = os.path.dirname(os.path.abspath(__file__))
    lint_json = os.path.join(tmp, "lint.json")
    p = subprocess.run([sys.executable, "-m",
                        "apex_tpu_torch.tools.concurrency_lint", "--json",
                        lint_json], cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=root), timeout=120)
    with open(lint_json) as f:
        rep = json.load(f)
    log(f"  28c concurrency_lint: exit {p.returncode}, "
        f"{rep['files_scanned']} files, {len(rep['findings'])} findings")
    out["concurrency_lint"] = dict(exit=p.returncode,
                                   files_scanned=rep["files_scanned"],
                                   findings=len(rep["findings"]))
    if p.returncode != 0 or rep["findings"]:
        failures.append(f"28c concurrency_lint exited {p.returncode}: "
                        + p.stdout[-2000:])
    return out, failures


#: 28d's int8-wire sweep, started beside the kernels' build (it reaches
#: no kernel, and its wall time is not what it measures) and waited for
#: when the build ends, so that its 8 workers hold the card in no
#: measured phase: a process of its own (and its own session, so that
#: its workers stop with it) whose last line is the rows as JSON
P28_INT8WIRE_PROC = {}


def _start_p28_int8wire():
    """Start 28d's int8-wire sweep (:data:`P28_INT8WIRE`) in a process
    of its own; it is stopped, with its workers, when the script exits."""
    import atexit
    import signal

    scale, block = P28_INT8WIRE
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, time\n"
            "from apex_tpu_torch.tools import int8wire_sensitivity as m\n"
            "t = time.perf_counter()\n"
            f"rows = m.sweep([{scale!r}], ({block},))\n"
            "print(json.dumps(dict(rows=rows, "
            "seconds=time.perf_counter() - t)))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=root))
    P28_INT8WIRE_PROC.update(proc=proc, t0=time.perf_counter())

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)

    atexit.register(stop)


def _finish_p28_int8wire():
    """Wait for the sweep that :func:`_start_p28_int8wire` started (its
    output is kept for 28d) and log whether it had finished by then."""
    proc = P28_INT8WIRE_PROC["proc"]
    done = proc.poll() is not None
    t = time.perf_counter()
    text, _ = proc.communicate(timeout=P16_SPAWN_TIMEOUT_S)
    P28_INT8WIRE_PROC["text"] = text
    log(f"28d's int8-wire sweep: {'had finished' if done else 'still ran'}"
        f" when the build ended; waited {time.perf_counter() - t:.1f} s "
        f"for it ({time.perf_counter() - P28_INT8WIRE_PROC['t0']:.1f} s "
        f"after its start)")


def _phase28d():
    """The two sweeps at their smallest setting, their tables printed:
    ``int8wire_sensitivity`` at the small scale and block 256 (its 8 DP
    worker processes on the card, over gloo; started beside the build,
    :func:`_start_p28_int8wire`), and ``pipeline_cost``'s lockstep rows
    at pp 2, remat on and off (two workers), beside its one-rank
    baseline."""
    import io

    from apex_tpu_torch.tools import pipeline_cost

    out, failures = {}, []
    if "text" not in P28_INT8WIRE_PROC:
        _finish_p28_int8wire()
    proc, text = P28_INT8WIRE_PROC["proc"], P28_INT8WIRE_PROC["text"]
    lines = text.strip().splitlines()
    for line in lines[:-1]:
        log(f"  28d {line}")
    if proc.returncode != 0:
        raise AssertionError("28d int8wire_sensitivity exited "
                             f"{proc.returncode}:\n{text[-3000:]}")
    res = json.loads(lines[-1])
    rows = out["int8wire"] = res["rows"]
    out["int8wire_s"] = res["seconds"]
    log(f"  28d int8wire_sensitivity: exit 0, its sweep {res['seconds']:.1f}"
        f" s (beside the build)")
    r = rows[0]
    if not (0 < r["rel_err_mean_worst_leaf"] < r["rel_err_max_worst_leaf"]
            < 1.0 and abs(r["loss_delta_frac_of_init"]) < 1e-2):
        failures.append(f"28d int8wire row {r}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rows = pipeline_cost.schedules_table(
            "lockstep", pps=(P28_PIPELINE_PP,))
    out["pipeline_s"] = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  28d {line}")
    log(f"  28d pipeline_cost: {out['pipeline_s']:.1f} s")
    out["pipeline"] = [{k: v for k, v in row.items() if k != "line"}
                       for row in rows]
    if len(rows) != 2 or not all(row["wall_ms"] > 0 and row["mem_mb"] > 0
                                 for row in rows):
        failures.append(f"28d pipeline rows {out['pipeline']}")
    return out, failures


def phase28():
    """ROADMAP item 12 on the card: 28a-28d (see their docstrings).  Every
    part logs its readings before any failure fails the phase.  Returns
    (28a's launches by path, results)."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    log("phase 28: the root tools — serve_bench at GptConfig()'s width "
        "(f32), goodput_drill, flight_view, concurrency_lint, the int8-wire "
        "and pipeline-cost sweeps")
    out, failures, seconds = {}, [], {}
    tmp = tempfile.mkdtemp(prefix="apex_tpu_torch_p28_")
    try:
        t = time.perf_counter()
        launches, out["28a"], f = _phase28a(tmp)
        failures += f
        seconds["28a"] = time.perf_counter() - t
        for name, part in (("28b", _phase28b), ("28c", _phase28c),
                           ("28d", lambda _tmp: _phase28d())):
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            out[name], f = part(tmp)
            failures += f
            seconds[name] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["part_seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    log(f"  phase 28 by part: {out['part_seconds']} s")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 28 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 28: " + "; ".join(failures))
    return launches, out


#: 29a's sweep: GPT's width and a wide one, at ln_tune's default rows
P29_HIDDENS = (1024, 4096)
P29_ROWS = 16384
#: 29b's world, and its tp block and ResNet batch (comm_structure's)
P29_WORLD = 2

#: 29a's check in a fresh process: the tuning cache named by the
#: environment reaches K1/K2's launch plan, and the outputs match
P29_CACHE_CHECK = """
import json, sys
import torch
from apex_tpu_torch.ops import layer_norm as ln, tune_cache
from apex_tpu_torch.tools import ln_tune
out = {}
gen = torch.Generator(device="cuda").manual_seed(1)
for hidden in json.loads(sys.argv[1]):
    x, w, b, g = ln_tune._inputs(%(rows)d, hidden, torch.bfloat16, gen)
    fwd = ln._plan(ln.KERNEL, x, x, w, b, bwd=False)
    bwd = ln._plan(ln.KERNEL_BWD, x, g, x, w, bwd=True)
    ln_tune.check(x, w, b, g, None, "bf16")
    out[hidden] = dict(cached=tune_cache.layer_norm_block_rows(hidden),
                       fwd_per_cta=fwd.per_cta, fwd_grid=fwd.grid,
                       bwd_per_cta=bwd.per_cta, bwd_grid=bwd.grid)
print(json.dumps(out))
""" % dict(rows=P29_ROWS)


def _phase29a(tmp):
    """``ln_tune`` through its ``main`` at :data:`P29_HIDDENS` (every
    candidate held to the plain versions inside it).  Returns (the
    tool's K1/K2 launches less its checks', results, the cache's path,
    failures)."""
    import io

    import torch

    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.tools import ln_tune

    cache = os.path.join(tmp, "tune.json")
    argv = ["--rows", str(P29_ROWS), "--cache-out", cache]
    for h in P29_HIDDENS:
        argv += ["--hidden", str(h)]
    buf = io.StringIO()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ln_tune.main(argv)
    secs = time.perf_counter() - t0
    got = _dispatch.launches()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cands = {h: ln_tune.candidates(P29_ROWS, h, 2, sms) for h in P29_HIDDENS}
    # one K1 and one K2 a candidate were its checks against the twins
    checks = sum(len(c) for c in cands.values())
    launches = {k: got.get(k, 0) - checks
                for k in ("layer_norm_fwd", "layer_norm_bwd")}
    rows = []
    for line in buf.getvalue().splitlines():
        if line.startswith("{"):
            rows.append(json.loads(line))
        else:
            log(f"  29a {line}")
    times, other = {}, {}
    for r in rows:
        into = times if r["block_rows"] is not None else other
        key = r["block_rows"] if r["block_rows"] is not None else r["call"]
        into.setdefault(r["hidden"], {}).setdefault(key, []).append(r["ms"])
    means = {h: {b: statistics.mean(v) for b, v in by.items()}
             for h, by in times.items()}
    # the plain and library pairs, timed in the candidates' two passes
    other_ms = {h: {k: statistics.mean(v) for k, v in by.items()}
                for h, by in other.items()}
    best = {h: min(by, key=by.get) for h, by in means.items()}
    entries = []
    if os.path.exists(cache):
        with open(cache) as f:
            entries = json.load(f)["layer_norm"]
    log(f"  29a ln_tune: exit {rc} in {secs:.1f} s; winners {best}; cache "
        f"{entries}; launches {got} ({checks} of each its checks); plain "
        f"and library pairs (ms) {other_ms}")
    failures = []
    if rc != 0:
        failures.append(f"29a ln_tune exited {rc}")
    if {e["hidden"]: e["block_rows"] for e in entries} != best:
        failures.append(f"29a cache {entries} != winners {best}")
    out = dict(exit=rc, seconds=secs, candidates=cands, ms=means,
               other_ms=other_ms, winners=best, launches=launches,
               bound_ms={h: ln_tune.bound_ms(P29_ROWS, h, 2)
                         for h in P29_HIDDENS})
    return launches, out, cache, failures


def _phase29a_cache(proc, best):
    """The fresh process of 29a (:data:`P29_CACHE_CHECK`, started with
    ``APEX_TPU_TUNE_CACHE`` naming ln_tune's cache): K1/K2's launch plan
    takes the cached rows (and their grid) and the outputs match."""
    out, err = proc.communicate(timeout=300)
    failures, plans = [], {}
    if proc.returncode != 0:
        failures.append(f"29a fresh process exited {proc.returncode}:\n"
                        + err[-3000:])
    else:
        plans = {int(h): v for h, v in json.loads(
            out.strip().splitlines()[-1]).items()}
    log(f"  29a fresh process with APEX_TPU_TUNE_CACHE: exit "
        f"{proc.returncode}, plans {plans}")
    for h, v in plans.items():
        want_grid = -(-P29_ROWS // best[h])
        if not (v["cached"] == v["fwd_per_cta"] == v["bwd_per_cta"]
                == best[h]) or max(v["fwd_grid"], v["bwd_grid"]) > want_grid:
            failures.append(f"29a plan at hidden {h}: {v}, cached {best[h]}")
    return plans, failures


def _phase29b_tp():
    """``comm_structure``'s h 1024 tp + SP block at world 2: its
    collectives must equal ``tp_sp_block_plan``."""
    from apex_tpu_torch.tools import comm_structure as cs

    t0 = time.perf_counter()
    kinds, flops, _ = cs.tp_gpt_structure(P29_WORLD)
    want = cs.tp_sp_block_plan(P29_WORLD, 1024, 1024, 8, 2)
    rec = cs.config_record("tp_gpt_block", kinds, flops, P29_WORLD,
                           cs.NVLINK_GBPS, cs.PEAK_TFLOPS)
    log(f"  29b {json.dumps(rec)} ({time.perf_counter() - t0:.1f} s)")
    return rec, ([] if kinds == want else
                 [f"29b tp block {kinds} != plan {want}"])


def _phase29b_ddp(say=log):
    """``comm_structure``'s ResNet-50 DDP with SyncBatchNorm at world 2
    (f32 wire): its gradient sync must hold to ``sync_plan`` and equal
    its exact summary.  It reaches no kernel of the port."""
    from apex_tpu_torch.tools import comm_structure as cs

    t0 = time.perf_counter()
    details = {}
    kinds, flops, _ = cs.ddp_syncbn_structure(P29_WORLD, details=details)
    rec = cs.config_record("ddp_resnet50_syncbn", kinds, flops, P29_WORLD,
                           cs.NVLINK_GBPS, cs.PEAK_TFLOPS)
    problems = cs.check_ddp(details, P29_WORLD, False)
    say(f"  29b {json.dumps(rec)} ({time.perf_counter() - t0:.1f} s); "
        f"gradient sync {len(details['grad_sync'])} calls against "
        f"sync_plan: {problems or 'equal'}")
    return rec, [f"29b ddp: {p}" for p in problems]


def _phase29c(say=log):
    """``shard_report --target train`` at dp 2 x tp 2 (four workers),
    through the builder and renderer its ``main`` calls (no stdout
    redirect: it runs beside other threads): no ERROR finding, every
    row's verdict ok.  The demo's MLP reaches no kernel of the port."""
    import torch

    from apex_tpu_torch.tools import shard_report

    t0 = time.perf_counter()
    args = shard_report.build_parser().parse_args(["--target", "train"])
    report = shard_report.lint_train(args, torch.device("cuda"))
    for line in shard_report.render(report, top=args.top).splitlines():
        say(f"  29c {line}")
    rep = report.to_json()
    rc = 0 if report.ok() else 1
    verdicts = sorted({r["verdict"] for r in rep["shard_plan"]})
    out = dict(exit=rc, rows=len(rep["shard_plan"]), verdicts=verdicts,
               peak_hbm_bytes=rep["peak_hbm_bytes"],
               seconds=time.perf_counter() - t0)
    say(f"  29c shard_report: {out}")
    return out, ([] if rc == 0 and verdicts == ["ok"] else
                 [f"29c shard_report exit {rc}, verdicts {verdicts}"])


#: 29e: one GPT block at the reference's ``tp_gpt_block_h4096`` shape
#: (``tools/comm_structure.py``: hidden 4096, 32 heads, FFN 16384) at tp
#: 1, forward and backward through the module call on 8 x 1024 tokens in
#: bf16, timed over P29E_STEPS; its norms take K1/K2's wide-row instance
P29E_SHAPE = dict(hidden_size=4096, num_heads=32, intermediate_size=16384)
P29E_SEQ, P29E_BATCH, P29E_STEPS = 1024, 8, 3
#: 29e's cross-check: the first 128 tokens of one sequence, the card's
#: bf16 block against the CPU's f32 block (the plain versions) from the
#: same weights, under phase 7's GRAD_REL_TOL
P29E_CROSS_TOKENS = 128


class _NormLaunchArgs:
    """A :data:`apex_tpu_torch.ops._dispatch.RECORDERS` entry that keeps
    the threads-a-row argument (``lanes``) of every K1 and K2 launch."""

    #: the argument's position in each entry's C argument list
    AT = {"layer_norm_fwd": 13, "layer_norm_bwd": 15}

    def __init__(self):
        self.lanes = {k: [] for k in self.AT}

    def note_launch(self, kernel, argtypes, args, dtype):
        if kernel in self.AT:
            self.lanes[kernel].append(args[self.AT[kernel]])


def _p29e_step(blk, x, gy, cos, sin):
    """One forward and backward of ``blk`` over ``x``: (the output, x's
    gradient); the parameters' gradients accumulate on ``blk``."""
    x = x.detach().requires_grad_()
    out = blk(x, cos, sin)
    out.backward(gy)
    return out.detach(), x.grad


def _phase29e():
    """A ``GptBlock`` at hidden 4096 (:data:`P29E_SHAPE`) on the card:
    forward and backward at 8 x 1024 tokens, its K1/K2 launches (two
    each a step, every one the wide-row instance's by the launch plan)
    and ms a step; then a 128-token copy against the CPU's f32 block.
    Returns (launches, results, failures)."""
    import torch

    from apex_tpu_torch.models import GptBlock, GptConfig, rope_cos_sin
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import layer_norm as ln

    t0 = time.perf_counter()
    cfg = GptConfig(**P29E_SHAPE, max_seq_len=P29E_SEQ)
    blk = GptBlock(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    with torch.no_grad():  # GptModel's draws; the norms moved off 1 and 0
        for lin in (blk.qkv, blk.out, blk.fc1, blk.fc2):
            lin.load_full_(randn(lin.output_size, lin.input_size)
                           * lin.input_size ** -0.5)
        for norm in (blk.ln_attn, blk.ln_mlp):
            norm.scale.add_(0.1 * randn(cfg.hidden_size))
            norm.bias.add_(0.1 * randn(cfg.hidden_size))
    x = randn(P29E_SEQ, P29E_BATCH, cfg.hidden_size).to(cfg.dtype)
    gy = randn(*x.shape).to(cfg.dtype)
    cos, sin = rope_cos_sin(P29E_SEQ, cfg.head_dim, device="cuda")
    _p29e_step(blk, x, gy, cos, sin)  # warm-up
    torch.cuda.synchronize()
    rec = _NormLaunchArgs()
    _dispatch.reset_launches()
    _dispatch.RECORDERS.append(rec)
    ms = []
    try:
        for _ in range(P29E_STEPS):
            blk.zero_grad(set_to_none=True)
            t = time.perf_counter()
            _p29e_step(blk, x, gy, cos, sin)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    finally:
        _dispatch.RECORDERS.remove(rec)
    launches = _dispatch.launches()
    rows = P29E_SEQ * P29E_BATCH
    plan = ln.kernel_specs(rows, cfg.hidden_size, cfg.dtype)[0].tile
    wide = plan["lanes"] * plan["warps_per_row"]
    failures = []
    for kernel, lanes in rec.lanes.items():
        want = 2 * P29E_STEPS  # ln_attn and ln_mlp, a step
        if len(lanes) != want or launches.get(kernel) != want or any(
                n != wide for n in lanes):
            failures.append(f"29e {kernel}: {launches.get(kernel)} launches "
                            f"with threads a row {lanes}, want {want} at "
                            f"{wide}")
    # the 128-token copy: the card's bf16 block against the CPU's f32
    n = P29E_CROSS_TOKENS
    xs, gs = x[:n, :1].contiguous(), gy[:n, :1].contiguous()
    # built on the meta device and given the card's weights (no init)
    cpu = GptBlock(dataclasses.replace(cfg, dtype=torch.float32), "meta")
    cpu.load_state_dict({k: v.cpu() for k, v in blk.state_dict().items()},
                        assign=True)
    blk.zero_grad(set_to_none=True)
    out_c, dx_c = _p29e_step(blk, xs, gs, cos[:n], sin[:n])
    out_r, dx_r = _p29e_step(cpu, xs.cpu().float(), gs.cpu().float(),
                             cos[:n].cpu(), sin[:n].cpu())
    errs = {"out": _rel_fro(out_c, out_r), "dx": _rel_fro(dx_c, dx_r)}
    cpu_params = dict(cpu.named_parameters())
    for name, p in blk.named_parameters():
        errs[f"d{name}"] = _rel_fro(p.grad, cpu_params[name].grad)
    worst = max(errs, key=errs.get)
    log(f"  29e GptBlock h {cfg.hidden_size}, {cfg.num_heads} heads, FFN "
        f"{cfg.intermediate_size}, bf16, {P29E_BATCH} x {P29E_SEQ} tokens: "
        f"{statistics.median(ms):.2f} ms a forward + backward (steps "
        f"{[round(t, 2) for t in ms]}); launches {launches}; K1/K2 threads "
        f"a row {sorted(set(sum(rec.lanes.values(), [])))} (the plan's "
        f"{plan['warps_per_row']} warps x {plan['per_lane']} values a "
        f"lane); {n} tokens against the CPU's f32 block: relative errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (worst {worst}, tol {GRAD_REL_TOL})")
    if not all(np.isfinite(v) and v <= GRAD_REL_TOL for v in errs.values()):
        failures.append(f"29e card against CPU: {worst} {errs[worst]:.3e}")
    out = dict(ms=ms, median_ms=statistics.median(ms), launches=launches,
               threads_a_row=wide, rel_errs=errs,
               seconds=time.perf_counter() - t0)
    del blk, cpu, x, gy
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out, failures


def _popen(args, env=None):
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, *args], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=root, **(env or {})))


#: phase 29's parts that reach no kernel of the port — 29b's ResNet-50
#: DDP, 29c's shard_report and 29d's repo_lint — started beside the
#: kernels' build (as 28d's sweep), their log lines kept for phase 29
P29_EARLY = {}


def _start_p29_early():
    """Start :data:`P29_EARLY`'s parts: two threads of this process (each
    runs its workers through ``tools/_ranks.py``) and the lint's process,
    which is stopped at exit if it still runs."""
    import atexit
    from concurrent.futures import ThreadPoolExecutor

    lines = P29_EARLY["lines"] = []
    pool = ThreadPoolExecutor(2)
    P29_EARLY.update(
        t0=time.perf_counter(),
        ddp=pool.submit(_phase29b_ddp, lines.append),
        shard=pool.submit(_phase29c, lines.append),
        lint=_popen(["-m", "apex_tpu_torch.tools.repo_lint"]))
    pool.shutdown(wait=False)

    def stop():
        if P29_EARLY["lint"].poll() is None:
            P29_EARLY["lint"].kill()

    atexit.register(stop)


def _finish_p29_early():
    """Wait for :data:`P29_EARLY`'s parts (as :func:`_finish_p28_int8wire`
    waits for 28d's sweep), so that their workers hold the card in no
    measured phase, and log whether they had finished by then.  Their
    results are kept for phase 29, which reads them."""
    parts = (P29_EARLY["ddp"], P29_EARLY["shard"])
    lint = P29_EARLY["lint"]
    done = [p.done() for p in parts] + [lint.poll() is not None]
    t = time.perf_counter()
    # a part that raised fails phase 29, where its exception is raised
    P29_EARLY["results"] = [p.exception() or p.result() for p in parts]
    text, err = lint.communicate(timeout=120)
    P29_EARLY["lint_out"] = (text, err)
    P29_EARLY["wait_s"] = time.perf_counter() - t
    log(f"29's parts started beside the build (ResNet-50 DDP, "
        f"shard_report, repo_lint): had finished {done} when the build "
        f"ended; waited {P29_EARLY['wait_s']:.1f} s for them "
        f"({time.perf_counter() - P29_EARLY['t0']:.1f} s after their "
        f"start)")


def phase29():
    """The last root tools on the card: 29a ``ln_tune`` alone on the
    card (it times), then its cache's fresh process beside 29b's tp
    block; 29b's ResNet-50 DDP, 29c and 29d ran beside the build
    (:data:`P29_EARLY`, waited for when it ended) and are read here.  Every part logs its readings
    before any failure fails the phase.  Returns (29a's K1/K2 launches by
    path, results)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    t0 = time.perf_counter()
    log("phase 29: the last root tools — ln_tune, comm_structure, "
        "shard_report, repo_lint")
    if not P29_EARLY:
        _start_p29_early()
    if "results" not in P29_EARLY:
        _finish_p29_early()
    out, failures = {}, []
    tmp = tempfile.mkdtemp(prefix="apex_tpu_torch_p29_")
    fresh = None
    try:
        launches, out["29a"], cache, f = _phase29a(tmp)
        failures += f
        out["29a"]["part_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        fresh = _popen(["-c", P29_CACHE_CHECK, json.dumps(P29_HIDDENS)],
                       env={"APEX_TPU_TUNE_CACHE": cache})
        with ThreadPoolExecutor(1) as pool:
            tp = pool.submit(_phase29b_tp)
            out["29a"]["plans"], f = _phase29a_cache(
                fresh, out["29a"]["winners"])
            failures += f
            out["29b"] = {}
            out["29b"]["tp_gpt_block"], f = tp.result()
            failures += f
        for r in P29_EARLY["results"]:
            if isinstance(r, BaseException):
                raise r
        (out["29b"]["ddp_resnet50_syncbn"], f), (out["29c"], f2) = \
            P29_EARLY["results"]
        failures += f + f2
        block_launches, out["29e"], f = _phase29e()
        failures += f
        lint = P29_EARLY["lint"]
        text, err = P29_EARLY["lint_out"]
        out["early_wait_s"] = P29_EARLY["wait_s"]
        for line in P29_EARLY["lines"]:
            log(line)
        log(f"  29d repo_lint: exit {lint.returncode}: {text.strip()[-300:]}")
        out["29d"] = dict(exit=lint.returncode, text=text.strip()[-300:])
        if lint.returncode != 0:
            failures.append(f"29d repo_lint exited {lint.returncode}: "
                            + (text + err)[-2000:])
    finally:
        if fresh is not None and fresh.poll() is None:
            fresh.kill()
            fresh.wait(10)
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 29 took {out['seconds']:.1f} s (29a "
        f"{out['29a']['part_s']:.1f} s, 29e {out['29e']['seconds']:.1f} s; "
        f"the build's end waited {out['early_wait_s']:.1f} s for the parts "
        f"started beside it)")
    if failures:
        raise AssertionError("phase 29: " + "; ".join(failures))
    return {"ln_tune": launches, "gpt_block_h4096": block_launches}, out


#: the flags that run one part of the script alone
SINGLE_PHASE_FLAGS = ("f32_attention", "timing", "phase1", "serving",
                      "evoformer", "resilience", "chaos", "parallel", "dap",
                      "trainer", "context", "experts", "pipeline", "amp",
                      "analysis", "trace_window", "observe", "modules",
                      "tail", "contrib", "tools", "last_tools", "norms")


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32-attention", action="store_true",
                        help="time only the f32 instances of K3-K5 and "
                        "phase 10's f32 run")
    parser.add_argument("--timing", action="store_true",
                        help="run phase 4 alone (the kernels' times)")
    parser.add_argument("--phase1", action="store_true",
                        help="run phase 1 alone (the kernels against their "
                        "plain versions)")
    parser.add_argument("--serving", action="store_true",
                        help="run the serving phases alone (2, 3, 12, 13, "
                        "15, 5)")
    parser.add_argument("--evoformer", action="store_true",
                        help="run phase 10's bf16 evoformer training alone "
                        "(launches logged, not checked)")
    parser.add_argument("--resilience", action="store_true",
                        help="run phase 14 alone (checkpoint, preemption "
                        "and resume of BERT-Large)")
    parser.add_argument("--chaos", action="store_true",
                        help="run phase 15 alone (serving under a chaos "
                        "storm, rebuilds, the telemetry's cost)")
    parser.add_argument("--parallel", action="store_true",
                        help="run phase 16 alone (data and tensor "
                        "parallelism: worker processes on the card)")
    parser.add_argument("--dap", action="store_true",
                        help="run phase 17 alone (the evoformer under DAP: "
                        "two worker processes on the card)")
    parser.add_argument("--trainer", action="store_true",
                        help="run phase 18 alone (the trainer: GPT at dp "
                        "1, then dp 2 in worker processes)")
    parser.add_argument("--context", action="store_true",
                        help="run phase 19 alone (GPT under ring, zigzag "
                        "and Ulysses context parallelism: two workers)")
    parser.add_argument("--experts", action="store_true",
                        help="run phase 20 alone (the MoE GPT at full "
                        "size, and at ep = 2 on two workers)")
    parser.add_argument("--pipeline", action="store_true",
                        help="run phase 21 alone (the five pipeline "
                        "schedules and train_gpt_pp on two workers)")
    parser.add_argument("--amp", action="store_true",
                        help="run phase 22 alone (amp: O1 GPT over K1-K4, "
                        "the O1 cross-check, O2 with an overflow, the amp "
                        "resume, DCGAN), with phase 6's loop for 4 steps "
                        "beside it")
    parser.add_argument("--analysis", action="store_true",
                        help="run phase 23 alone (the serving build checks, "
                        "planted faults, the launch plans against the card, "
                        "the tuning cache, serve_gpt)")
    parser.add_argument("--trace-window", action="store_true",
                        help="run phase 24a alone, in this process, with "
                        "the kernels as built (phase 24 starts it as a "
                        "process of its own)")
    parser.add_argument("--observe", action="store_true",
                        help="run phase 24 alone (a profiler window over "
                        "GPT training, train_resilient under chaos, the "
                        "fleet and canary drills at GptConfig())")
    parser.add_argument("--modules", action="store_true",
                        help="run phase 25 alone (ResNet-50 and the "
                        "ImageNet amp example, dp = 2 + SyncBatchNorm, the "
                        "multihead attention, fmha, the norm modules, the "
                        "remaining optimizers)")
    parser.add_argument("--tail", action="store_true",
                        help="run phase 26 alone (mlp, fused_dense, the "
                        "RNNs, weight norm, the native host ops, the "
                        "three profile tools on a GptConfig() step, the "
                        "standalone providers; phase 24b and 24c first, "
                        "for 26e's dumps)")
    parser.add_argument("--contrib", action="store_true",
                        help="run phase 27 alone (the remaining contrib "
                        "packages: the NHWC vision blocks, the focal and "
                        "transducer losses, the halo exchange on two "
                        "workers, ASP on GptConfig(remat=True))")
    parser.add_argument("--tools", action="store_true",
                        help="run phase 28 alone (the root tools: "
                        "serve_bench at GptConfig()'s width, goodput_drill, "
                        "flight_view, concurrency_lint, the int8-wire and "
                        "pipeline-cost sweeps; phase 24b first, for 28c's "
                        "flight dump), then phase 4's two rows on 28a's "
                        "path")
    parser.add_argument("--last-tools", action="store_true",
                        help="run phase 29 alone (ln_tune at hidden 1024 "
                        "and 4096 with its cache read back, comm_structure "
                        "at world 2, shard_report --target train, "
                        "repo_lint)")
    parser.add_argument("--norms", action="store_true",
                        help="build K1 and K2 alone and run phase 4's K1/K2 "
                        "rows (the training shape, the wide rows, the "
                        "streamed width)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of phase 1's generator (the kernels' "
                        "inputs; 0 by default); also reads K5 f32's c "
                        "window per case, and offsets phase 27's seeds")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"({smi})")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    if args.trace_window:
        print(json.dumps({"24a": _phase24a()}), flush=True)
        return
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    # the worker processes' server, and, where the run reaches phases 28
    # and 29, their parts that reach no kernel, start beside the build
    _start_worker_server()
    if args.tools or not any(getattr(args, flag)
                             for flag in SINGLE_PHASE_FLAGS):
        _start_p28_int8wire()
    if args.last_tools or not any(getattr(args, flag)
                                  for flag in SINGLE_PHASE_FLAGS):
        _start_p29_early()
    # the kernels (one nvcc per source, all started together); where the
    # run reaches phase 23, its two tuned variants build beside the first
    # phases, off the build's critical path, and phase 23 waits for them
    libs = _build.build(("layer_norm_fwd", "layer_norm_bwd") if args.norms
                        else _build.KERNELS)
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    if P28_INT8WIRE_PROC:
        _finish_p28_int8wire()
    if P29_EARLY:
        _finish_p29_early()
    if args.analysis or not any(getattr(args, flag)
                                for flag in SINGLE_PHASE_FLAGS):
        pool = ThreadPoolExecutor(2)
        VARIANT_BUILDS.extend(
            pool.submit(_build.build, [f"flash_{m}"], P23_VARIANTS[m])
            for m in ("fwd", "bwd"))
        pool.shutdown(wait=False)
    for name in _build.KERNELS:
        for line in ptxas_summary(_build.build_log(name), _build._nvcc()):
            log(f"  [{name}] {line}")
    from apex_tpu_torch.ops import _dispatch

    # the distinct launches of the run, for phase 23c
    _dispatch.record_signatures(True)

    global K5_F32_WINDOW, P27_SEED
    K5_F32_WINDOW = args.seed is not None
    P27_SEED = args.seed or 0
    gen = torch.Generator(device="cuda").manual_seed(args.seed or 0)
    if args.f32_attention:
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        rows = _time_f32_attention(gen, flush)
        for name, by_shape in rows.items():
            for tag, r in by_shape.items():
                log(f"  {name} ({tag}): kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
        _, run = phase10_f32()
        print(json.dumps({"f32_attention": rows,
                          "evoformer_f32_attention": run}), flush=True)
        return
    if args.timing:
        print(json.dumps({"timing": phase4(gen, {}, {})}), flush=True)
        return
    if args.norms:
        _dispatch.record_signatures(False)
        print(json.dumps({"norms": phase4_norms(gen)}), flush=True)
        return
    if args.serving:
        serve_launches, rates, engine, streams = phase2()
        cross = phase3()
        wires_launches, wires = phase12()
        spec_launches, spec = phase13(streams, rates)
        chaos_launches, chaos = phase15()
        profile = phase5(engine)
        print(json.dumps({"serving": dict(rates, launches=serve_launches),
                          "cross_check": cross,
                          "serving_int8_wires": dict(
                              wires, launches=wires_launches),
                          "speculative": spec,
                          "serving_chaos": dict(
                              chaos, launches=chaos_launches),
                          "decode_profile": profile}), flush=True)
        return
    if args.chaos:
        launches, chaos = phase15()
        print(json.dumps({"serving_chaos": dict(chaos, launches=launches)}),
              flush=True)
        return
    if args.resilience:
        launches, run = phase14()
        print(json.dumps({"resilience": dict(run, launches=launches)}),
              flush=True)
        return
    if args.parallel:
        print(json.dumps({"parallel": phase16()}), flush=True)
        return
    if args.dap:
        launches, run = phase17()
        print(json.dumps({"dap": dict(run, launches=launches)}), flush=True)
        return
    if args.trainer:
        launches, run = phase18()
        print(json.dumps({"trainer": dict(run, launches=launches)}),
              flush=True)
        return
    if args.context or args.experts or args.pipeline:
        # each requested phase runs, and any failure fails the run after
        # the others have logged their readings
        out, failures = {}, []
        for flag, name, fn in (("context", "context", phase19),
                               ("experts", "experts", phase20),
                               ("pipeline", "pipeline", phase21)):
            if not getattr(args, flag):
                continue
            try:
                res = fn()
            except AssertionError as exc:
                log(f"  {name} FAILED: {exc}")
                failures.append(name)
                continue
            out[name] = dict(res[-1], launches=res[0])
        if failures:
            raise AssertionError(f"phases failed: {failures}")
        print(json.dumps(out), flush=True)
        return
    if args.amp:
        launches, run = phase22()
        print(json.dumps({"amp": dict(run, launches=launches)}), flush=True)
        return
    if args.analysis:
        run = {}
        if args.phase1:
            # phase 1's launches too: the widest set of instances for 23c
            run["phase1"] = phase1(gen)
            run["phase1"].update(phase1_flash_dbias(gen))
        run.update(phase23(gen))
        run["23c"] = phase23c(_dispatch.launch_signatures())
        print(json.dumps({"analysis": run}, default=str), flush=True)
        return
    if args.observe:
        launches, run = phase24()
        print(json.dumps({"observe": dict(run, launches=launches)},
                         default=str), flush=True)
        return
    if args.tail:
        launches, run = phase26()
        print(json.dumps({"tail": dict(run, launches=launches)},
                         default=str), flush=True)
        return
    if args.contrib:
        launches, run = phase27()
        print(json.dumps({"contrib": dict(run, launches=launches)},
                         default=str), flush=True)
        return
    if args.tools:
        launches, run = phase28()
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        run["phase4_rows"] = {"flash_fwd_f32": _time_p28_prefill(gen, flush)}
        log(f"  phase 4's rows on 28a's path: {run['phase4_rows']}")
        print(json.dumps({"tools": dict(run, launches=launches)},
                         default=str), flush=True)
        return
    if args.last_tools:
        launches, run = phase29()
        print(json.dumps({"last_tools": dict(run, launches=launches)},
                         default=str), flush=True)
        return
    if args.modules:
        launches, run = phase25()
        print(json.dumps({"modules": dict(run, launches=launches)},
                         default=str), flush=True)
        return
    if args.evoformer:
        launches, run = phase10(check_launches=False)
        print(json.dumps({"evoformer": dict(run, launches=launches)}),
              flush=True)
        return
    from apex_tpu_torch.ops import _dispatch

    errs = timed("1", phase1, gen)
    errs.update(phase1_flash_dbias(gen))
    # phase 1's launches (phase 2 zeroes the counters): the entries no
    # main path launches must have launched here and passed their checks
    phase1_launches = _dispatch.launches()
    for name in PHASE1_ONLY_ENTRIES:
        n = phase1_launches.get(name, 0)
        log(f"  {name}: {n} phase-1 launches, {errs['k5_checks']} cases "
            f"within K5_TOL (no main path launches it)")
        if not n or not errs["k5_checks"]:
            raise AssertionError(f"phase 1 never held {name} to its twin")
        errs[f"{name}_phase1_launches"] = n
    if args.phase1:
        print(json.dumps({"phase1": errs}), flush=True)
        return
    serve_launches, rates, engine, streams = timed("2", phase2)
    cross = timed("3", phase3)
    wires_launches, wires = timed("12", phase12)
    spec_launches, spec = timed("13", phase13, streams, rates)
    chaos_launches, chaos = timed("15", phase15)
    train_launches, training = timed("6", phase6)
    train_cross = timed("7", phase7)
    bert_launches, bert = timed("8", phase8)
    bert_cross = timed("9", phase9)
    res_launches, resilience = timed("14", phase14)
    evo_launches, evoformer = timed("10", phase10)
    evo_f32_launches, evoformer_f32 = timed("10 f32", phase10_f32)
    evo_cross = timed("11", phase11)
    parallel = timed("16", phase16, training["losses"])
    dap_launches, dap = timed("17", phase17)
    trainer_launches, trainer = timed("18", phase18, training["losses"])
    cp_launches, context = timed("19", phase19)
    moe_launches, ep2_launches, experts = timed("20", phase20)
    pp_launches, pipeline = timed("21", phase21)
    amp_launches, amp_run = timed("22", phase22, training)
    analysis_run = timed("23", phase23, gen, streams)
    observe_launches, observe = timed("24", phase24)
    modules_launches, modules = timed("25", phase25)
    tail_launches, tail = timed("26", phase26)
    contrib_launches, contrib = timed("27", phase27)
    tools_launches, tools = timed("28", phase28)
    last_tools_launches, last_tools = timed("29", phase29)
    runs = (("serving", serve_launches),
            ("serving_int8_wires", wires_launches),
            ("speculative", spec_launches),
            ("serving_chaos", chaos_launches),
            ("training", train_launches),
            ("bert", bert_launches["bert"]),
            ("bert_dropout", bert_launches["bert_dropout"]),
            ("bert_resume", res_launches["bert_resume"]),
            ("evoformer", evo_launches),
            ("evoformer_f32", evo_f32_launches),
            ("parallel_world1", parallel["launches_world1"]),
            ("parallel_tp2_rank0", parallel["launches_tp2"]),
            ("dap_rank0", dap_launches),
            ("trainer", trainer_launches),
            ("cp_rank0", cp_launches),
            ("experts", moe_launches),
            ("ep2_rank0", ep2_launches),
            ("pp2_rank0", pp_launches),
            ("amp_o1", amp_launches),
            ("analysis_serving", analysis_run["23a"]["launches"]),
            ("trace_window", observe_launches["trace_window"]),
            ("fleet", observe_launches["fleet"]),
            ("canary", observe_launches["canary"]),
            *modules_launches.items(),
            *tail_launches.items(),
            *contrib_launches.items(),
            *tools_launches.items(),
            *last_tools_launches.items())
    launches = {
        name: {path: counts[name] for path, counts in runs if name in counts}
        for name in KERNEL_ENTRIES
    }
    idle = [name for name in KERNEL_ENTRIES if not sum(launches[name].values())
            and name not in PHASE1_ONLY_ENTRIES]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    # phase 4 times the kernels with the launch log off (it costs a few
    # microseconds a launch); 23c reads the launches of every other phase
    signatures = _dispatch.launch_signatures()
    _dispatch.record_signatures(False)
    kernels = timed("4", phase4, gen, launches, errs, False)
    profile = timed("5", phase5, engine)
    analysis_run["23c"] = timed("23c", phase23c, signatures)
    log(json.dumps({"serving": rates, "cross_check": cross,
                    "serving_int8_wires": wires, "speculative": spec,
                    "serving_chaos": chaos, "training": training, "training_cross_check": train_cross,
                    "bert": bert, "bert_cross_check": bert_cross,
                    "resilience": resilience,
                    "evoformer": evoformer,
                    "evoformer_f32_attention": evoformer_f32,
                    "evoformer_cross_check": evo_cross,
                    "parallel": parallel,
                    "dap": dap, "trainer": trainer,
                    "context": context, "experts": experts,
                    "pipeline": pipeline, "amp": amp_run,
                    "analysis": analysis_run, "observe": observe,
                    "modules": modules, "tail": tail, "contrib": contrib,
                    "tools": tools, "last_tools": last_tools,
                    "decode_profile": profile},
                   default=str))
    log(f"seconds by phase: {PHASE_SECONDS}")
    log(f"time_ms: {SPIN_TOTAL['calls']} calls spun {SPIN_TOTAL['s']:.1f} s "
        f"in all")
    log(f"whole run {time.perf_counter() - t0:.1f} s (the build included)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
