#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --serve mamba2-2.7b --repeats 2 [--trace]
    python3 chip_smoke.py --serve resnet18 --repeats 8
    python3 chip_smoke.py --serve resnet18 --repeats 3 --switch-interval 0.0005
    python3 chip_smoke.py --host-calls
    python3 chip_smoke.py --drill smollm-135m --repeats 3
    python3 chip_smoke.py --epoch --repeats 10
    python3 chip_smoke.py --cluster --repeats 2
    python3 chip_smoke.py --resume --repeats 2
    python3 chip_smoke.py --lm-paths
    python3 chip_smoke.py --families
    python3 chip_smoke.py --train
    python3 chip_smoke.py --dist

The --serve forms run only one model's serving phase (step 3, 5, 6, 9, 12
or 13 below),
``--repeats`` times, each with the host's side of the run and the card's
clocks after it, after the last the profile of a decode step
(``decode_step_profile``) or of each CNN stage (``cnn_stage_profile``;
a profiler session slows the process's graph launches after it, so no
run follows one), and with ``--trace`` what
the card did during it (``device_timeline``); a ``serve_repeats`` line
sums the runs up (runs with an HP miss, HP mean, p99 and max response,
and for the CNNs the runs and HP jobs over SchedCheck's static bound,
those jobs by their largest part and step, and each run's HP ``input``
step at stage 0 beside the later stages').
``--switch-interval S`` sets the process's ``sys.setswitchinterval``
before the runs.
``--host-calls`` prints only what each call of a served stage's enqueue
costs the host (``host_calls``; a first stage's ``torch.zeros`` also
right behind a pending graph launch). ``--drill ARCH`` runs only step 21's drills of
``resnet18`` or ``smollm-135m``, ``--repeats`` times in turns, and sums
them up in a ``drill_repeats`` line.
Copied into a checkout from before the compiled stage (``git archive``
under ``build/``), the same forms measure that tree, without the
``stage_graphs`` fields; --epoch only the epoch phase (step 4), --resume only
the resume phase (step 7), --cluster only the cluster phase (step 8, the
fleet over 4000 ms), --lm-paths only the kernel phase and steps 9-11,
--families only the kernel phase and steps 12-15 with the Dh 160
check, and --train only the kernel phase (gradient rows included) and
steps 16-17, ``--repeats`` times (events/s on the host's clock vary from
run to run).
None of them prints a result line, but --dist: the kernel phase and steps
18-20, with the ``kernels`` line (launches from steps 18 and 20) and the
result line. Without arguments:

1. Builds the port's Hopper kernels from ``src/repro_torch/kernels/csrc``
   (into ``build/kernels/``).
2. Kernel phase: each kernel at the decode path's shapes (B=4, H=9, KV=3,
   Dh=64, D=576, a 513-slot cache after a 512-token prompt; prefill over
   512 tokens), in bf16 and f32, against its plain PyTorch version on the
   same inputs (tolerance 2e-4 in f32, 3e-2 in bf16, as
   tests/test_kernels.py); flash attention also at Dh 128 (H 8, KV 2,
   S 512), so that both of its tensor-core tile widths are held to the
   plain version. Each row names what its wrapper counted for the checked
   call (counts reset just before it): the instances launched and, where
   the wrapper records one, each one's grid; the flash rows name the
   instance that ran (``tensor_core`` or ``cuda_core``), the decode row
   the split kernel's split count and blocks, which must fill the card.
   Times: the kernel, its plain version and, where
   one PyTorch call computes the same function, that call (a yardstick the
   port never uses), each the median of CUDA-event-timed batches of
   launches; the bound is the larger of bytes over 3.35 TB/s and
   operations over the card's peak for their type.
   RMSNorm also runs at the mamba2 step's widths (2560, 5120) and at the
   donor prefill's 2048 rows of 5120; each norm row names the instance its
   plan took (``rmsnorm_plan``). The SSD scan runs at the mamba2-2.7b
   donor prefill's shapes (B 4, L 512, H 80, P 64, N 128, chunk 256;
   tolerance 3e-2 in bf16, 5e-4 in f32): bf16 must take the tensor-core
   instance, f32 the CUDA-core one, and the CUDA-core kernel also runs at
   those bf16 shapes through the same entry (uncounted), so that the row
   gives the time of the kernel the tensor cores replace; the CUDA-core
   instance is held to its plain version through the wrapper at a shape
   it takes (chunk 96, L 576: ``ssd_cuda_core``). Steps 9-11's shapes
   have rows of their own: RMSNorm at 4 x 2048 (qwen2-moe), 3584 and 7168
   (zamba2; 5120 is also qwen1.5's); RMSNorm and the fused residual norm
   at every donor prefill's 2048 rows (576, 2048, 2560, 3584, 5120, 7168;
   the residual at 576, 2048, 3584, 5120) and the residual at 4 x 2048,
   3584 and 5120; flash attention at Dh 128 with H = KV = 16 (qwen2-moe)
   and 40 (qwen1.5) besides H 8, KV 2, and at Dh 112 (32 heads, zamba2's
   shared block: the CUDA-core instance, which no tensor-core tile width
   covers); decode attention at Dh 128 (16 and 40 heads) and Dh 112 (32
   heads) over 513 slots; and the SSD scan at the zamba2 donor prefill's
   shapes (B 4, L 512, H 112, P 64, N 64, chunk 256; the tensor-core
   instance in bf16). Each wrapper counts its launches by instance and
   shape (``Counts.by_shape``; decode attention's leaves out the slots),
   so each row records the keys its checked call launched, and every key
   a model path launches must be one that a bf16 row checked
   (``shape_coverage``, whose ``path_shapes`` line lists them). The
   contention + ETA kernel runs on fleet-scale rate-groups of 4096 lanes
   (one where all three branches fire, one where none does; both in
   shared memory) and on one of 12,289 lanes past the shared-memory
   limit (the ``tiled`` instance): the f64 instance must return its
   plain version's bits and those of ``rates_seq`` on the host, from
   lists and from numpy arrays, the f32 one agree within 2e-6 relative.
   Its bound is the larger of its bytes and its serial chain of 3 m
   dependent adds at one add per cycle of the card's top SM clock;
   beside it, the latency floor: 3 m times one add's latency in cycles,
   measured on the card by the kernel's ``clock64`` probe
   (``contention_eta.chain_cycles``). Its round trip is timed from lists
   and from numpy arrays, beside ``rates_seq`` on the host.
3. Serving phase, dense path: two full-width smollm-135m staged decode
   tasks (HP and LP; 4 stages, batch 4, prompt 512; random weights from
   seed 0) built with ``staged_lm_taskspec`` and served in real time by
   ``ServerConfig.realtime()`` (2 contexts x 2 streams, oversubscription
   2.0, n_units = the card's SM count); every bf16 flash-attention launch
   on it must take the tensor-core instance. Then its output checks: a served
   task's payload chain gives finite logits of the expected shape that
   match the unstaged ``decode_step``, and a cut-depth f32 model run on
   the card through the kernels matches the same model run on the CPU
   through the plain versions. Each stage payload is a ``StageProgram``
   (``serving/stage_graph.py``): a CUDA graph a (stage, lane stream),
   captured in the lanes' warm-up into the lane's graph pool (one a lane,
   shared by the programs that replay there) and replayed for every job;
   an LM stage writes its static copy of the cache slice in place. The
   ``serving`` line's ``stage_graphs`` gives the warm-up's captures and
   their seconds (within ``warm_up_s``) and, over the run, the replays,
   the launches they counted and the payload stages the lanes ran: every
   one must have been a replay, and every one enqueued on the engine
   thread (``pool_stage_runs`` 0: on the card the worker pool runs no
   stage); and the graph pools and the GB they hold:
   one a lane and one for the calibration's stream. The caching
   allocator must not call the driver in the run (``allocator_in_run``:
   no device allocation and no retry after the lanes' warm-up). Its
   ``hp_response_parts`` splits each HP job's response by stage (release
   -> first launch; hand-off, prep, stream wait, device, notice, gap;
   ROADMAP C7): the parts must sum to the response within
   ``PARTS_TOL_MS``. ``enqueue`` gives the card stages' enqueues on the
   engine thread (ms from the stage's start to its last step, median,
   p99 and max, and each step's), ``engine_stalls`` every stretch of the
   engine thread over 1 ms (the step that ends it, its wall and CPU ms,
   the collections that overlap it) and ``over_bound`` each HP job above
   SchedCheck's bound with its largest part and that stage's largest
   step. ``ready`` counts the HP stages' calls made ready ahead of their
   boundary (made, used, discarded by reason, left at the stop, the share
   of HP stages that took theirs) and ``hp_prep_by_stage`` a HP job's
   prep by stage: a run fails if a ready call was discarded without a
   named reason (``unnamed``). The host events behind a stall beside
   them: the interpreter's switch interval (``switch_interval_s``;
   ``--serve ... --switch-interval S`` sets this process's), the garbage
   collections in the run by
   generation (count, seconds, longest pause, each on the backend's
   clock; ``gc``) and, for the slowest HP jobs, whether the largest part
   overlaps one (``slowest_vs_gc``). Then
   the ``stage_graphs`` check: two jobs of differing seeded inputs through
   the served task's payloads on two new streams, interleaved (job A's
   stage k, then job B's, on stream k % 2), each stage against its
   functional eager stage function on the same state: bit for bit for
   the LMs (output and cache slice), within ``CNN_TOL`` of the scale for
   the CNNs; a job's state must be what its last stage made of it when
   its next stage reads it. An LM's donor caches (HP and LP) must keep
   their checksum over the run and the check (``donor_checksum``). Every
   served model of steps 3, 5, 6, 9, 12 and 13 runs it;
   ``phase_seconds`` gives its seconds. The ``serving`` line also gives
   the allocated block sizes that hold the most card memory
   (``allocated_blocks_mib``).
4. Epoch phase: one single-device simulated scenario (4 contexts x 6
   streams, twelve tasks, chaos with a brownout) on the heap engine, on
   ``engine("epoch")`` at its default threshold, and on ``engine("epoch")``
   with the threshold at 1, so that every rate-group goes through the f64
   contention kernel; decision logs and metric digests must be identical.
5. Serving phase, ssm path: the same as 3 for full-width mamba2-2.7b (64
   layers cut into 4 stages of 16, batch 4, prompt 512), whose donor
   prefill runs the SSD kernel (every launch on the tensor-core instance)
   and whose decode steps run RMSNorm at widths 2560 and 5120, with the
   same output checks; the cut-depth f32 check reports its launches by
   instance (its SSD calls take the CUDA-core instance).
6. CNN phase, the paper's Table II path: ResNet18 and UNet at their
   published widths (64/128/256/512; UNet's middle block 1024),
   InceptionV3 at its builder's width 24 (the reference's reduced-depth
   model, which no published configuration matches), each cut into 4 stages, on 224 x 224 x 3 inputs, batch 1, f32 with TF32 off
   (random weights from seed 0). Each is served as in 3 by an HP and an LP
   task built with ``staged_cnn_taskspec``, at its Table II per-task rate
   (30, 24 and 24 jobs/s); its convolutions go to cuDNN through torch, and
   no port kernel and no plain version of one may run. Then, per DNN, a
   ``cnn_stage_profile`` line (each stage's kernels, host wall ms against
   device busy ms, and conv FLOPs from the shapes with their bound at 67
   TFLOP/s) and its output checks: the HP task's payload chain on a seeded
   input gives finite outputs of the reference's shape, and a cut-width
   copy (width 8, input 65, batch 2) gives the same on the card as on the
   CPU, stage by stage, within 1e-3 of each output's scale. Before each
   DNN's run, SchedCheck's ``verify(enforce=False)`` on the config it
   serves: a ``schedcheck_served`` line gives the report's verdicts and HP
   bound beside the run's largest HP response and HP misses, with any
   violation the differential oracle's two rules would name (a
   measurement, not a gate).
7. Resume phase (checkpointing and the serving daemon): ResNet18 as in 6,
   served cold for 3 s and its scheduler state saved (``save_state``), then
   a fresh server of the same config loads the file before it runs
   (``load_state``): every task's MRET windows, ``ctx``, ``fixed_ctx``, the
   migration count and the context geometry must equal the file's. A
   ``resume`` line gives per run each task's MRET at its start and end,
   each HP stage's ``t_alone`` against its served mean ``et_ms``, HP misses
   and responses, LP rejects, and the file's bytes and the µs of the save
   and the load; ``python -m repro_torch.launch.serve --ckpt`` runs twice
   and the second run must resume. The served parameters go through
   ``save_pytree``/``load_pytree`` from and to the card and must come back
   bit for bit (``params_roundtrip``: MB and seconds each way), and
   examples/serve_daemon_torch.py (the ops daemon, SIGTERM, restart, zero
   lost, audit, replay) must exit 0 (``serve_daemon``: its wall time and
   submit round trips); ``msgpack`` must not have been imported.
8. Cluster phase (simulated fleets; the sim backend, on the three engines
   of step 4, whose digests must be identical): benchmarks/perf_engine.py's
   ``fleet_64dev_diurnal`` (64 devices x 4 contexts, 192 two-stage LP
   services replaying a diurnal Poisson trace; 1500 ms here), with the
   rate-groups the engines asked for (calls, groups, the most in one
   call, lanes a group); its ``cluster_rn18_4gpu`` (Table II ResNet18 on
   two a100 and two v100 models, 1500 ms); benchmarks/figure_specs.py's
   ``fig13_fail_1of4`` (4 GPUs, device 1 failing at 30% of 2000 ms). Then
   SchedCheck's differential oracle on ``fig13_light`` and
   ``fig13_fail_1of4``, each simulated on the epoch engine with every
   rate-group on the f64 contention kernel: both must be ``ok``.
9. MoE phase, the slice's main path: qwen2-moe-a2.7b at full width and
   depth (24 layers, d 2048, 16 heads at Dh 128, 60 routed experts top-4
   of width 1408 and 4 shared (5632), qkv bias, vocab 151,936; bf16,
   random weights from seed 0: 14.3 B parameters, 28.7 GB), served as in
   3 (4 stages of 6 layers, batch 4 after a 512-token prompt) at 2 jobs/s
   a task, lowered (a ``rate_lowered`` line says why) only if the
   calibrated HP stage sum exceeds a third of the period. Its stages run
   the dense expert oracle, as the reference stages them; its donor
   prefill the capacity path. Every flash launch must take the tensor
   cores; the chain is held to the unstaged ``forward(...,
   moe_oracle=True)`` decode from the same donor (``decode_step`` would
   take the capacity path, which at N = 4 keeps one pair an expert), and
   a 2-layer f32 copy to itself on the CPU, within 2e-3; the
   ``decode_step_profile`` line adds the peak of allocated memory.
10. Hybrid phase: zamba2-7b at full width and depth (81 Mamba2 layers at
    d 3584, the shared block 13 times over 7168 at Dh 112; bf16, seed 0),
    a prefill of 512 tokens at batch 4 and 4 decode steps (``model_run``
    line). Every SSD launch must take the tensor cores; its flash launches
    take the CUDA-core instance, recorded. A 2-layer f32 copy with
    ``attn_every`` 2 against the CPU, within 2e-3.
11. Int8 phase: qwen1.5-32b at full width (d 5120, 40 heads at Dh 128,
    d_ff 27,392, vocab 152,064) with its int8 KV cache, depth cut to 8 of
    64 layers (all 64 hold about 70 GB of bf16 weights; the mechanism is
    per layer), run as in 10. The same weights and tokens with a bf16
    cache: the int8 cache must take (1 + 4/128) / 2 of its bytes; at layer
    0, whose k/v are the same in both runs, every written slot's codes
    must lie within half a code step of the bf16 values and its scales be
    their max|x| / 127; the decode logits must lie within ``INT8_TOL`` of
    the bf16-cache logits' largest magnitude, each row's int8 top-1 token
    scored by the bf16 run within that of its best (``int8_check`` line,
    with the rows whose top-1 is the same). One more decode step (the
    probe) runs from the cache and from two planted faults (the newest
    slot's scales unwritten, every code one step up): the layer-0 check
    must flag both, and so must the probe's logits against the bf16
    cache's: the sound cache within ``INT8_TOL``, each fault past it. A 2-layer f32 copy with the int8 cache against the CPU:
    logits within 1e-2, dequantized caches at most one code step apart
    (codes one apart where the f32 projections round differently).
12. MLA phase, slice 10's main path: deepseek-v2-236b at full width (d
    5120, 128 heads; MLA with q_lora 1536, kv_lora 512, rope 64 / nope 128
    / v 128; 160 routed experts top-6 of width 1536 and 2 shared (3072);
    the dense layer's d_ff 12,288; vocab 102,400; bf16, seed 0), depth cut
    to its dense layer and 4 MoE layers (about 17.3 B parameters), served
    as in 9 at 2 jobs/s. Its donor prefill attends through flash at Dh 192
    with H = KV = 128 (the CUDA-core instance: every flash launch must
    take it) and the capacity path; its stages decode absorbed (plain
    products, as in the reference) on the dense expert oracle. R4
    (ROADMAP.md §3): the stages never run the dense layer and the last
    holds no layer, so the chain is held, within 3e-2, to the unstaged
    decode that does the same (embedding, the 4 MoE layers on the oracle
    over the donor's cache, logits); a cut-depth f32 copy (the dense
    layer and one MoE layer at full width; its routed experts cut to 16
    where the host's memory would not hold it) gives the same staged
    chain and unstaged prefill and decode logits on the card as on the
    CPU, within 2e-3.
13. Gemma2 phase: gemma2-27b at full width (d 4608, 32 / 16 heads at Dh
    128, d_ff 36,864, vocab 256,000 tied, window 4096, softcaps 50 / 30,
    (1 + w) norms before and after each block), depth cut to 24 of 46
    layers (12 local/global pairs, 3 a stage; 14.8 B parameters), served
    as in 12. Every flash launch takes the tensor cores; the chain is held
    to the unstaged decode; one pair in f32 on the card against the CPU
    (chain included).
14. Vlm phase: pixtral-12b at full width and depth (40 layers, d 5120, 32
    / 8 heads at Dh 128): the no-cache forward over seeded image
    embeddings [2, 1024, 5120] before 512 token embeddings, then a prefill
    of 512 tokens at batch 4 and 4 decode steps; finite logits of the
    expected shapes, flash on the tensor cores; 2 layers in f32 on the
    card against the CPU (with a forward over 16 image embeddings).
15. Encdec phase: whisper-tiny at full width and depth (4 + 4 layers, d
    384, 6 heads at Dh 64, 1500 frames, vocab 51,865): ``encode`` of seeded
    frames [4, 1500, 384], a prefill of 64 tokens and 4 decode steps. The
    encoder's flash launches must be non-causal at S 1500 on the tensor
    cores and the cross-attention's run at S_kv 1500 (counted by shape
    key); the whole model in f32 on the card against the CPU. Then
    stablelm-12b at full width (Dh 160), 2 layers in f32, a 64-token
    prompt and 2 decode steps on the card against the CPU; its flash
    launches take the CUDA-core instance.
    The kernel phase holds every instance and shape these paths launch:
    flash with softcap 50 and with a window of 128 that masks (32 / 16
    heads, Dh 128), non-causal at S 1500, cross-attention at S 64 and 1
    against 1500 keys, whisper's decoder prefill, Dh 192 (H = KV = 128),
    Dh 160, pixtral's prefill and its forward over 1536 rows; decode
    attention with softcap and with a window that masks (Dh 128, 32 / 16
    heads), at 32 / 8 heads, at Dh 64 (6 heads) and Dh 160; norms at 512
    and 1536 (MLA's), at 3072 rows of 5120, and with ``plus_one`` at 4608
    (plain and residual). Each row with an option also runs the call with
    that option dropped (softcap, window, causality, the 28 keys of the
    ragged last tile of 1500, ``plus_one``): the result must leave the
    plain version's tolerance (``planted_fault``). Rows whose every output
    averages hundreds of keys (non-causal over 1500, decode over 513
    slots without a sharpened query) are held to 3e-3 in bf16, since
    their outputs are about 0.03; the others to 3e-2.
16. Training phase: smollm-135m at full width and
    depth (30 layers, d 576, 9 / 3 heads at Dh 64, vocab 49,152 tied;
    bf16 parameters, f32 moments, seed 0) trained 20 AdamW steps (lr
    1e-3, 2 warmup steps, cosine over 20) by ``make_train_step`` with
    ``accum`` 2, remat ``"dots"`` and ``q_chunk`` 1024 (the reference
    dryrun's at S 4096: the attention's backward recomputes query blocks
    of 1024 rows), on ``TokenPipeline(49152, 8, 4096,
    seed=0)`` batches: 8 sequences of 4096 tokens a step (the reference's
    train_4k cell has 256). Each wrapper's forward is its kernel; under
    autograd it goes through its ``torch.autograd.Function``, whose
    backward recomputes the plain version (the reference has no backward
    kernel), counted in ``counts.backward``. A ``train_step`` line a step
    (loss, grad_norm, lr, CUDA-event and host ms, tokens/s), then
    ``train_summary``: model FLOPs a step (6 N D + causal attention) and
    their share of 989 TFLOP/s at the median step, peak memory, launches
    and backward recomputes a step by kernel and instance, and one more
    step under ``torch.profiler`` (device busy ms against host wall, each
    kernel's recompute device ms). It fails on a non-finite loss or
    grad_norm, a last loss less than 10% below the first, a bf16 flash
    launch off the tensor cores, a plain version on the card outside the
    counted backward, a parameter leaf (each layer's slice of the
    stacked ones) with a zero or non-finite gradient, or a shape the
    backward recomputed at (``backward_recomputes_by_shape``) that no
    gradient row checks.
17. Cut-size training check: each of the ten architectures' reduced
    configs (f32) one ``make_train_step`` step on the card against the
    same step on the CPU, from the same parameters and batch, remat
    ``"none"`` and ``"full"`` (smollm also ``"dots"``): loss, each
    gradient leaf, grad_norm and lr within 1e-3 relative, new parameters
    within 1e-5 where the gradient's sign is certain (``train_cut``
    lines, with the card's launches by instance: the flash CUDA-core
    instance and the SSD scan under autograd).
    The kernel phase adds the training path's forward rows (norms over
    16,384 rows of 576, causal flash at S 4096) and gradient rows
    (``grad_check``): for rmsnorm, the fused residual norm and flash at
    those shapes and the SSD scan at mamba2's donor-prefill shapes, bf16
    and f32, a seeded cotangent's gradients through the Function against
    a witness, the plain version differentiated in f64 on the card
    (``GRAD_TOL``); the same output cut from the graph (a planted fault)
    and the plain version computed in bf16 (a control) must leave it.
    The flash row at S 4096 is held per query row (``ROW_TOL``), with a
    planted fault that hides the oldest key tile from the last 64 rows.
    Each gradient row times the
    kernel's forward, the recompute, the plain version's forward and
    backward and the library's (SDPA, ``F.rms_norm``).
18. Four ranks of the card (``dist_phase``): this script started four
    times (``--dist-rank``; gloo, all on ``cuda:0``, the kernels built
    once here) on a (1, 4) ("data", "model") mesh serves qwen2-moe-a2.7b
    at its published width, 4 of 24 layers, bf16, seed 0, with TP 4 and
    EP 4 (4 heads and 15 experts a rank): a prefill of 512 tokens at
    batch 4 and 4 decode steps through ``Model`` with ``dist``, then the
    same in f32. Held to the same layers run unsharded on the card (f32:
    ``DIST_TOL_F32`` of the largest logit; bf16: the median position
    within ``DIST_TOL``) and layer 0's ``moe_ep`` to ``moe_capacity`` in
    f32 (``EP_TOL``); each rank's launches at its local shapes
    (``dist_serving`` line). The same prefill and decode once more under
    ``serve_seq_shard`` (a rank's 128 of the 512 rows between blocks),
    held to the same unsharded logits (``dist_seq_prefill`` line). Then
    the same ranks, as a (2, 2) mesh, run smollm-135m at full width (10
    of 30 layers) one AdamW step of 4 x 4096 tokens under each of the
    reference's layouts (``LAYOUTS``: seq_shard, no_seq_shard, no_fsdp,
    mlp_fsdp, dp_only), in f32 held to the same step unsharded on the
    card (``SPMD_TOL``: loss, gradient norm, every gradient and new
    parameter) and in bf16 (the loss, ``LAYOUT_BF16_TOL``); each rank's
    FLOPs (``FlopCounterMode``) and collectives must equal the dry-run's
    for the same cut cell and flags (the ``2x2`` cells of step 19), its
    peak GB printed beside the dry-run's (``dist_layouts`` line a
    layout).
19. Dry-run (``start_dryruns``, ``finish_dryruns``): the reference's
    three tiny-mesh cells, a cell a family at the 16 x 16 mesh, the
    roofline cells at 1 x 1 and step 18's layout cells at 2 x 2 (train_4k
    cut to 4 sequences and 10 layers, heads unpadded), each
    ``launch/dryrun.py`` in a
    process of
    its own at the lowest CPU priority, started after the build and run
    beside the kernel and gradient rows (timed on the card); the script
    waits for them (``dryrun_wait``) before any phase that reads the
    host's clock (``dryrun`` lines; a cell not ``ok`` or with no FLOPs
    fails).
20. Roofline (``roofline_phase``): smollm-135m at full width and depth
    through ``build_model(..., dist=<1 x 1 mesh>)`` on train_4k cut to 8
    sequences (the training phase's step), prefill_32k cut to 2 and
    decode_32k to 16: ``FlopCounterMode`` on the card must count the
    dry-run's FLOPs for the same cut cell exactly; the dry-run's peak
    bytes over the card's, and the model-FLOP share (``Model.
    model_flops`` over 989 TFLOP/s x the measured seconds) beside the
    roofline row's ``roofline_fraction`` (``roofline`` lines).
    The kernel phase adds the rows of their shapes: flash and decode at
    4 heads of Dh 128, flash at S 32,768 (B 2), decode over 32,768 slots
    (B 16; held per output row to ``ROW_TOL``, with a planted fault that
    hides the kernel's first split of slots), the norms over 65,536 and
    16 rows of 576; and those of step 18's later runs: the norms over a
    rank's 512 rows of 2048 (the ``serve_seq_shard`` prefill) and over
    4096 rows of 576, flash over one sequence of 4096 (9 heads over 3).
21. Drill phase (``drill_phase``), the paper's elastic mechanism served:
    ResNet18 and full-width smollm-135m (their tasks as in 6 and 3)
    served as in 3 with a fault plan through the entry point's own calls
    (``DRILLS``): ``reshape``, ``reconfigure_at`` 750 ms to 4 contexts x 1
    stream at oversubscription 4.0, 1500 ms to 3 x 2 at 3.0, 2250 ms to 2
    x 2 at 2.0 (4 -> 4 -> 6 -> 4 lanes, each reshape's lanes new to the
    scheduler); ``fault``, ``fail_context_at(0, 1000)`` and
    ``scale_out_at(2000)`` (4 -> 2 -> 4 lanes; no task is placed on the
    added context, whose lanes stay idle); ``scale_out``,
    ``scale_out_at(1000)`` and ``fail_context_at(1, 2000)`` (4 -> 6 -> 4
    lanes; the LP task of the failed context is re-placed onto the added
    one, whose lanes first launch then). A ``drill`` line a run
    gives, event by event (to the next): the engine thread's stop (the
    lane warm-ups after the clock started and captures outside them),
    ``rewarm``, captures, replays, the lanes first launched, streams and
    pools made, the caching allocator's driver calls, and the HP jobs
    released in the 500 ms
    after the event (misses, maximum) against those away from every
    event; and the run's streams, pools and their GB, and warm-up. The
    backend reads the plan at its start and warms a stream for each lane
    of the busiest moment (6 for ``reshape`` and ``scale_out``, 4 for
    ``fault``), and a new
    lane takes a retired or failed lane's stream: it fails on a capture
    after the clock started, another count of streams, two live lanes on
    one stream handle, or an HP miss, besides the served run's own
    gates (one replay a stage, one pool a stream, no driver allocation).
Each phase's model is freed before the next; ``phase_seconds`` and
``phase_peak_memory_gb`` give each phase's wall and peak of allocated card
memory, and ``script_seconds`` the whole script's wall and its phases'
sum beside those of commit 464ae87 and the wall's aim.

Kernel launch counts are reset just before each path and read just after;
every kernel must be launched on a path (the f32 contention kernel, which
no engine calls, on the kernel phase's own fleet-sweep call); the f64
contention kernel on each simulated path of steps 4 and 8, whose launches
its row lists path by path (``launches_by_path``). A decode
attention call counts two launches, its split kernel and its merge; a
tensor-core SSD call likewise two, its state pass
(``tensor_core/states``) and its output kernel (``tensor_core/out``),
and the SSD row gives each one's device µs (``torch.profiler``). The
``kernels`` line also lists the rows that run a kernel at
other shapes or as another instance (``OTHER_SHAPES``), each with the
launches at its own instance and shape on the model paths, path by path,
and each kernel's launches path by path (``launches_by_path``).

It fails (non-zero exit, no result line) without a CUDA device, outside a
checkout of the repo, or when a kernel is out of tolerance or unlaunched,
a flash, norm or SSD check took another instance than its plan or dtype
names, the CUDA-core SSD kernel at the tensor-core shapes disagrees with
the plain version, the decode check's
split grid held fewer blocks than the card has SMs, a plain version ran on
a CUDA tensor during a path, a flash-attention launch on the dense or MoE
path took the CUDA-core instance, an SSD launch on the ssm or hybrid path
took the CUDA-core instance, a worker caught an exception, no HP job
completed, the three runs of the epoch phase or of a cluster scenario
differ, a port kernel or its plain version ran on the CNN path, a payload
stage on a served lane was not a CUDA-graph replay, a served run's
graph pools were not one a lane stream (and the calibration's), an HP
job's
response parts missed its response, a donor cache changed, a
``stage_graphs`` check failed, an output check failed, a restored
scheduler state differs from its file, the second launcher run did not
resume, the parameters did not round-trip bit for bit, the daemon
example failed, the oracle was not ``ok`` on fig13_light or
fig13_fail_1of4, an int8 check of step 11 failed, a drill of step 21
failed a gate, a planted fault
agreed with a plain version, a step 12-15 instance or launch-shape check
failed, a gradient row or a check of steps 16-20 failed, or a model path
launched a kernel at an instance and shape that no bf16 row checked. The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import hashlib
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()      # the whole script's wall clock
# the whole script's wall and phase seconds on one H100 (700 W) at commit
# 464ae87, before the host readings of ``run_host``, and the aim for the
# wall (``script_seconds``)
PREVIOUS_SECONDS = {"commit": "464ae87", "wall_s": 675.2, "phases_s": 640.2}
WALL_AIM_S = 600.0
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "float32": 67e12}       # f32 outside the tensor cores
ELEMENTWISE_FLOPS = 67e12             # norms compute in f32 on CUDA cores
B, H, KV, DH, D, PROMPT = 4, 9, 3, 64, 576, 512
N_STAGES, HORIZON_MS, JPS = 4, 3000.0, 5.0
# mamba2-2.7b donor prefill: heads, head dim, state, groups, chunk
SSM_H, SSM_P, SSM_N, SSM_G, SSM_Q = 80, 64, 128, 1, 256
SSM_JPS = 2.0
# the model paths of steps 9-11: staged MoE decode (full width and depth),
# the hybrid's prefill and decode, and the int8 KV cache (depth cut)
MOE_ARCH, MOE_JPS = "qwen2-moe-a2.7b", 2.0
MOE_MAX_LOAD = 1.0 / 3.0              # the HP stage sum's most of a period
HYBRID_ARCH, INT8_ARCH = "zamba2-7b", "qwen1.5-32b"
INT8_LAYERS = 8                       # of 64 (~70 GB of bf16 weights)
DECODE_STEPS = 4
# of the bf16-cache logits' largest magnitude: between the sound cache's
# 1.4% and the 5.4% of its newest slot's scales left unwritten, measured
# on the H100 by the probe step (PERF.md, PR 19); both planted faults
# must land past it
INT8_TOL = 0.03
# the int8 codes and scales at layer 0 (whose k/v do not depend on the
# cache's dtype) against a bf16 cache's values: round-to-nearest puts a
# value within half a code step of its code
INT8_HALF_STEP = 0.5 + 1e-3           # code steps
INT8_SCALE_RTOL = 1e-6                # the stored scale against max|x| / 127
INT8_SMALL_TOL = 1e-2                 # card vs CPU, cut-depth f32, int8 cache
# slice 10's paths (steps 12-15): deepseek-v2 (MLA + MoE) and gemma2
# served staged at cut depth, pixtral-12b and whisper-tiny at full depth,
# stablelm-12b's Dh 160 at 2 layers in f32
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 5     # 1 dense + 4 MoE of 60
GEMMA_ARCH, GEMMA_LAYERS = "gemma2-27b", 24      # 12 of 23 pairs
VLM_ARCH, ENCDEC_ARCH, DH160_ARCH = ("pixtral-12b", "whisper-tiny",
                                     "stablelm-12b")
FAMILY_JPS = 2.0
VLM_BATCH, VLM_SEQ = 2, 1024 + PROMPT            # image + token embeddings
ENC_FRAMES, ENC_PROMPT = 1500, 64                # whisper's frames, prompt
SMALL_TOL = 2e-3                                 # card vs CPU in f32
# bf16 attention rows whose every output averages hundreds of keys under
# an unsharpened softmax: a typical output is about n^-1/2 (0.03 at 1,500
# keys), so the 3e-2 of the other bf16 rows would be as large as the
# values compared (the kernels read within 1e-3 of their plain versions)
AVG_TOL = 3e-3
FLASH_BK = 64         # key rows a tile in both flash instances (csrc)
HOST_RAM_SHARE = 0.5                             # of MemAvailable, at most
# zamba2-7b's donor prefill scan: heads, head dim, state, groups, chunk
ZSSM_H, ZSSM_P, ZSSM_N, ZSSM_G, ZSSM_Q = 112, 64, 64, 1, 256
LANES = 4096                          # a fleet-scale rate-group
TILED_LANES = 12289                   # past the kernel's shared-memory limit
SMALL_LANES = 16                      # a rate-group of the epoch scenario
DEFAULT_SM_MHZ = 1980.0               # H100 SXM top boost clock (data sheet)
# Table II's DNNs: ResNet18 and UNet at their published widths
# (64/128/256/512), InceptionV3 at its builder's default (the reference's
# reduced-depth model has no published widths); Table I's input, batch 1
CNN_WIDTHS = {"resnet18": 64, "unet": 64, "inceptionv3": 24}
CNN_HW, CNN_BATCH = 224, 1
CNN_TOL = 1e-3                        # card vs CPU, of the output's scale
PARTS_TOL_MS = 0.01                   # an HP job's parts against its response
# the stage parts of an HP response after its release -> first launch
RESPONSE_PARTS = ("release_to_launch", "hand_off", "prep", "stream_wait",
                  "device", "notice", "gap")
RESUME_DNN = "resnet18"               # served cold, saved, then resumed
# step 21, the elastic drills on the served configuration's 3 s (2 x 2
# lanes at 2.0): events (kind, ms, argument) and the most lanes live at
# once. A scale-out's context gets work only where a failure re-places a
# task onto it, the least used survivor (or an LP task fails admission on
# its own): ``fault``'s never does; ``scale_out``'s takes the LP task once
# context 1, its home, fails
DRILLS = {
    "reshape": (("reconfigure", 750.0, {"n_contexts": 4, "n_streams": 1,
                                        "oversubscription": 4.0}),
                ("reconfigure", 1500.0, {"n_contexts": 3, "n_streams": 2,
                                         "oversubscription": 3.0}),
                ("reconfigure", 2250.0, {"n_contexts": 2, "n_streams": 2,
                                         "oversubscription": 2.0})),
    "fault": (("fail_context", 1000.0, 0), ("scale_out", 2000.0, None)),
    "scale_out": (("scale_out", 1000.0, None), ("fail_context", 2000.0, 1))}
DRILL_LANES = {"reshape": 6, "fault": 4, "scale_out": 6}
DRILL_ARCHS = ("resnet18", "smollm-135m")
DRILL_WINDOW_MS = 500.0               # HP jobs released this long after one
# the training phase: smollm-135m at full width and depth (bf16, f32 m/v),
# 20 AdamW steps of 8 sequences of 4096 tokens in 2 microbatches of 4
# (the reference's train_4k cell is 256 sequences a step)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "smollm-135m", 20, 8, 4096
TRAIN_ACCUM, TRAIN_REMAT, TRAIN_LR, TRAIN_WARMUP = 2, "dots", 1e-3, 2
TRAIN_MB = TRAIN_BATCH // TRAIN_ACCUM               # sequences a microbatch
TRAIN_ROWS = TRAIN_MB * TRAIN_SEQ                   # norm rows a call
TRAIN_MIN_DROP = 0.10          # the last step's loss below the first's by
TRAIN_Q_CHUNK = 1024           # the reference dryrun's for train at S 4096
# flash_attention_train_s4096: a causal row i averages i + 1 keys, so its
# outputs shrink as about (e / (i + 1))^1/2 (1 at row 0, 0.026 at row 4095);
# the error of each query row is taken over that row's largest |output|
# (``row_rel_err``). On the H100: 7.8e-3 in bf16 (an ulp), 5.4e-6 in f32;
# the oldest key tile hidden from the last 64 rows (a window of S - 64),
# which must land past the limit, 0.448 in both (PERF.md, Findings)
ROW_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# gradient rows: the Function (kernel forward, plain recompute backward)
# against a witness, the plain version differentiated by autograd in f64
# on the card; largest |difference| over the largest witness gradient of
# each input. The Function rounds an f32 gradient to bf16 once (at most
# 2^-8 = 3.9e-3 of it); the SSD's plain version also takes C.B in the
# inputs' dtype, as the reference does. On the H100 the Functions read
# 2.5e-3-2.9e-3 in bf16 (SSD 4.8e-3), 3.1e-6 at most in f32 (SSD 1.5e-5);
# a bf16-compute control (the plain version with its f32 upcast taken
# out, on bf16 inputs), which must land past the limit, 4.9e-3-8.2e-3 in
# bf16 (SSD 0.55) and 6.1e-3 at least in f32 (PERF.md, Findings)
GRAD_TOL = {"bfloat16": 4e-3, "float32": 1e-4}
GRAD_TOL_SSD_BF16 = 1e-2
# the cut-size training step, card against CPU (f32, reduced configs):
# loss, grad_norm and each gradient leaf relative to its scale; new
# parameters where |g| passes TRAIN_G_FLOOR of the leaf's scale (Adam's
# first step moves every other element by up to lr either way)
TRAIN_SMALL_TOL, TRAIN_G_FLOOR, TRAIN_P_TOL = 1e-3, 1e-3, 1e-5
TRAIN_NOISE_FLOOR = 1e-3       # of the largest |g| of any leaf
# slice 12 (steps 18-20). Four ranks of the one card (gloo: NCCL refuses
# two ranks on one GPU) serve qwen2-moe-a2.7b at its published width on a
# (1, 4) ("data", "model") mesh: TP 4 (4 heads a rank), EP 4 (15 experts
# a rank), 4 of its 24 layers, bf16, seed 0; prefill of 512 tokens at
# batch 4, then 4 decode steps
DIST_LAYERS, DIST_MESH, DIST_LAST = 4, (1, 4), 8   # last prefill positions
# The ranks' logits against the same layers run unsharded. In f32 (the
# same weights, an f32 cache) the largest difference over the largest
# |logit|: the runs sum partial products in other orders (the model
# axis's all-reduces), 1e-6 relative a sum. In bf16 each rank rounds its
# partial sums to bf16 before the f32 sum, where the unsharded run rounds
# once; a difference that flips one token's top-4 experts changes that
# token's logits whole (and, at capacity, which later pairs drop), so the
# bf16 run is held by the median over positions of a position's error
# over its largest |logit| (on the H100 the maxima read 0.03-0.77 over
# the prefill's last 8 positions and the 4 steps: PERF.md, Findings)
DIST_TOL_F32 = 1e-4
DIST_TOL = 3e-2
# one MoE layer in f32, moe_ep on the ranks against moe_capacity: the same
# products; only the order in which a token's k pairs are summed differs
EP_TOL = 1e-5
# slice 13: the reference's layouts. Step 18's ranks also run smollm-135m
# at full width, 10 of its 30 layers, on a (2, 2) ("data", "model") mesh
# (at full depth the ten steps took 167 s over gloo on an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md §6: a collective costs about 8 ms there):
# one AdamW step of train_4k
# cut to a global batch of 4 sequences of 4096 tokens
# (the dry-run's accum for it: 2 microbatches a rank, 1 under dp_only;
# remat "full", q_chunk 1024), under each layout, in f32 and then in
# bf16. The heads run unpadded: the reference's padding for tp 2 (9 -> 10
# heads over 3 KV heads) leaves GQA's groups uneven, which neither
# package's attention can run, so every model rank computes the 9 heads
# whole (the sequence's gather with a slice in its backward) while the
# MLP (1536 / 2) and the vocabulary (49,152 / 2) split
LAYOUT_MESH, LAYOUT_BATCH, LAYOUT_PAD, LAYOUT_LAYERS = (2, 2), 4, 1, 10
LAYOUTS = {"seq_shard": [], "no_seq_shard": ["--no_seq_shard"],
           "no_fsdp": ["--no_fsdp"], "mlp_fsdp": ["--mlp_fsdp"],
           "dp_only": ["--dp_only"]}
# f32: loss and global gradient norm relative, every gradient (gathered
# whole) of the largest, and every new parameter whose gradient passes
# TRAIN_G_FLOOR of its leaf's scale of the largest parameter (elsewhere 2
# lr more: Adam's first step moves an element by lr either way), against
# the same step unsharded on the card (the test suite's SPMD_TOL); bf16:
# the loss against the unsharded bf16 step's
SPMD_TOL = 1e-4
LAYOUT_BF16_TOL = 3e-2
DRYRUN_CELLS = (("smollm-135m", "train_4k", "tiny"),
                ("qwen2-moe-a2.7b", "decode_32k", "tiny"),
                ("mamba2-2.7b", "prefill_32k", "tiny-multi"))
# a cell a family at the production mesh (16 x 16): dense, moe, ssm,
# hybrid, encdec, vlm
DRYRUN_SINGLE = (("smollm-135m", "decode_32k"),
                 ("qwen2-moe-a2.7b", "decode_32k"),
                 ("mamba2-2.7b", "decode_32k"), ("zamba2-7b", "decode_32k"),
                 ("whisper-tiny", "decode_32k"),
                 ("pixtral-12b", "decode_32k"))
# the roofline cells: smollm-135m at full width and depth on a 1 x 1 mesh,
# train_4k cut to 8 sequences (the training phase's step), prefill_32k to
# 2 and decode_32k to 16 (its bf16 cache is about 12 GB)
ROOF_SEQ, ROOF_PREFILL_B, ROOF_DECODE_B = 32768, 2, 16
ROOF_CELLS = {
    "train_4k": {"global_batch": TRAIN_BATCH, "accum": TRAIN_ACCUM,
                 "remat": TRAIN_REMAT, "q_chunk": TRAIN_Q_CHUNK},
    "prefill_32k": {"global_batch": ROOF_PREFILL_B, "q_chunk": 512},
    "decode_32k": {"global_batch": ROOF_DECODE_B}}
ROOF_REPS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e!r})"


def cuda_ms(torch, fn, reps: int = 30, inner: int = 10) -> float:
    """Eager time per call: median over ``reps`` batches of the mean of
    ``inner`` back-to-back calls, timed with CUDA events after warm-up. At
    these sizes it is the host's enqueue rate, not the device's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 30, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured once in a CUDA graph,
    replayed ``reps`` times under CUDA events; median replay / ``inner``.
    The host's per-call cost is out of the picture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def kernel_us(torch, fn, calls: int = 5) -> dict:
    """Device µs per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls (a wrapper that launches more
    than one kernel: where its time goes)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.device_time_total / calls
                for e in prof.key_averages() if e.device_time_total > 0}
    except Exception as e:   # noqa: BLE001 — a measurement, not a check
        return {"error": repr(e)}


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_cases(torch, F, dtype):
    """(name, kernel call, plain call, library call | None, bytes, ops,
    peak, options) at the main paths' shapes; options may set the
    tolerance and fewer timing repeats for the heavy calls."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_scan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    dname = str(dtype).replace("torch.", "")
    x, r, w = rand(B, 1, D), rand(B, 1, D), rand(D)
    cache_k, cache_v = rand(B, PROMPT + 1, KV, DH), rand(B, PROMPT + 1, KV, DH)
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)   # the model's view
    kv_pos = torch.arange(PROMPT + 1, dtype=torch.int32, device=dev)
    q_pos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
    q1 = rand(B, H, DH)
    mask = ((kv_pos[None] >= 0) & (kv_pos[None] <= q_pos[:, None]))[:, None,
                                                                     None]
    qp, kp, vp = (rand(B, PROMPT, n, DH).transpose(1, 2) for n in (H, KV, KV))
    # flash attention's other tensor-core tile width: Dh 128
    q8, k8, v8 = (rand(B, PROMPT, n, 128).transpose(1, 2) for n in (8, 2, 2))
    s = PROMPT + 1
    dec_ops = 4 * B * H * s * DH
    fa_ops = 4 * B * H * DH * PROMPT * (PROMPT + 1) // 2
    fa8_ops = 4 * B * 8 * 128 * PROMPT * (PROMPT + 1) // 2
    fa_want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    # the options of a row that averages hundreds of keys (AVG_TOL)
    avg_tol = {"tol": AVG_TOL} if dtype == torch.bfloat16 else {}

    def sdpa(q, kk, vv, **kw):
        return F.scaled_dot_product_attention(q, kk, vv, enable_gqa=True,
                                              **kw)

    # the SSD scan at the mamba2 donor prefill's shapes (the donor's cache
    # hands it a zero initial state)
    sx = rand(B, PROMPT, SSM_H, SSM_P)
    sb, sc = rand(B, PROMPT, SSM_G, SSM_N), rand(B, PROMPT, SSM_G, SSM_N)
    sdt = torch.empty((B, PROMPT, SSM_H), device=dev).uniform_(
        0.001, 0.1, generator=g)
    sal = torch.log(torch.linspace(1.0, 16.0, SSM_H, device=dev)).to(dtype)
    s0 = torch.zeros((B, SSM_H, SSM_P, SSM_N), device=dev)
    q_, n_chunks = SSM_Q, PROMPT // SSM_Q
    pairs = q_ * (q_ + 1) // 2         # causal (i, j) pairs in a chunk
    ssd_ops = 2 * B * SSM_H * n_chunks * (pairs * (SSM_N + SSM_P)
                                          + 2 * q_ * SSM_N * SSM_P)
    ssd_bytes = nbytes(sx, sdt, sal, sb, sc, s0, sx, s0)
    ssd_tol = 3e-2 if dtype == torch.bfloat16 else 5e-4
    # the CUDA-core SSD instance at a shape it takes (chunk 96: L 576), and
    # at the donor's own shapes through the same entry, uncounted
    sdt32, sal32 = sdt.float(), sal.float()
    ssd_cc = {"tol": ssd_tol, "reps": 10, "inner": 3, "graph": False,
              "instance": "cuda_core"}
    cl = 6 * 96
    cx = rand(B, cl, SSM_H, SSM_P)
    cb_, cc_ = rand(B, cl, SSM_G, SSM_N), rand(B, cl, SSM_G, SSM_N)
    cdt = torch.empty((B, cl, SSM_H), device=dev).uniform_(0.001, 0.1,
                                                           generator=g)
    cc_ops = 2 * B * SSM_H * 6 * (96 * 97 // 2 * (SSM_N + SSM_P)
                                  + 2 * 96 * SSM_N * SSM_P)
    # the decode steps' norms (B rows): mamba2's ln (2560) and gated
    # (5120), which is also qwen1.5's width; qwen2-moe's (2048); zamba2's
    # ln (3584) and its gated norm and shared block's ln1 (7168); and the
    # donor prefills' B x 512 rows at each model's widths (smollm 576,
    # qwen2-moe 2048, mamba2 2560 / 5120, zamba2 3584 / 7168, qwen1.5 5120)
    # (and slice 10's: deepseek's q_norm 1536 and kv_norm 512; pixtral's
    # no-cache forward over 2 x (1024 + 512) rows of 5120)
    wide = {f"rmsnorm_d{dd}": (rand(B, 1, dd), rand(dd))
            for dd in (2048, 2560, 3584, 5120, 7168, 1536, 512)}
    wide.update({f"rmsnorm_prefill_d{dd}": (rand(B * PROMPT, dd), rand(dd))
                 for dd in (5120, 576, 2048, 2560, 3584, 7168, 1536, 512)})
    wide["rmsnorm_vlm_d5120"] = (rand(VLM_BATCH * VLM_SEQ, 5120),
                                 rand(5120))
    wide["rmsnorm"] = (x, w)
    # gemma2's (1 + w) norms at 4608, decode and prefill rows
    plus = {"rmsnorm_d4608_plus_one": (rand(B, 1, 4608), rand(4608)),
            "rmsnorm_prefill_d4608_plus_one": (rand(B * PROMPT, 4608),
                                               rand(4608))}
    res_plus = {
        "rmsnorm_residual_d4608_plus_one": (rand(B, 1, 4608),
                                            rand(B, 1, 4608), rand(4608)),
        "rmsnorm_residual_prefill_d4608_plus_one": (
            rand(B * PROMPT, 4608), rand(B * PROMPT, 4608), rand(4608))}
    # the fused residual + norm (ln2) of the dense, moe and shared-block
    # layers: decode rows and donor-prefill rows at each model's width
    res = {"rmsnorm_residual": (x, r, w)}
    res.update({f"rmsnorm_residual_d{dd}": (rand(B, 1, dd), rand(B, 1, dd),
                                            rand(dd))
                for dd in (2048, 3584, 5120)})
    res.update({f"rmsnorm_residual_prefill_d{dd}": (
        rand(B * PROMPT, dd), rand(B * PROMPT, dd), rand(dd))
        for dd in (576, 2048, 3584, 5120)})
    res["rmsnorm_residual_vlm_d5120"] = (rand(VLM_BATCH * VLM_SEQ, 5120),
                                         rand(VLM_BATCH * VLM_SEQ, 5120),
                                         rand(5120))
    # the training path's norms: smollm-135m's microbatch of 4 x 4096 rows
    wide["rmsnorm_train_d576"] = (rand(TRAIN_ROWS, D), rand(D))
    res["rmsnorm_residual_train_d576"] = (rand(TRAIN_ROWS, D),
                                          rand(TRAIN_ROWS, D), rand(D))
    # slice 13: qwen2-moe's serve_seq_shard prefill (a rank's 128 of 512
    # rows, B 4, at 2048) and the layouts' microbatch of one sequence of
    # 4096 rows (no_seq_shard, dp_only; the sequence-split layouts' 2048
    # rows are the donor prefills' shape)
    seq_rows = B * PROMPT // DIST_MESH[1]
    wide["rmsnorm_seq_d2048"] = (rand(seq_rows, 2048), rand(2048))
    res["rmsnorm_residual_seq_d2048"] = (rand(seq_rows, 2048),
                                         rand(seq_rows, 2048), rand(2048))
    wide["rmsnorm_layout_d576"] = (rand(TRAIN_SEQ, D), rand(D))
    res["rmsnorm_residual_layout_d576"] = (rand(TRAIN_SEQ, D),
                                           rand(TRAIN_SEQ, D), rand(D))
    # slice 12's roofline cells: smollm-135m's prefill_32k cut to 2
    # sequences (65,536 rows) and decode_32k cut to 16 (16 rows)
    if dtype == torch.bfloat16:
        n32 = ROOF_PREFILL_B * ROOF_SEQ
        wide["rmsnorm_prefill32k_d576"] = (rand(n32, D), rand(D))
        res["rmsnorm_residual_prefill32k_d576"] = (rand(n32, D),
                                                   rand(n32, D), rand(D))
        wide["rmsnorm_b16_d576"] = (rand(ROOF_DECODE_B, 1, D), rand(D))
        res["rmsnorm_residual_b16_d576"] = (rand(ROOF_DECODE_B, 1, D),
                                            rand(ROOF_DECODE_B, 1, D),
                                            rand(D))

    def decode_case(name, h, dh, kv=None, window=0, softcap=0.0,
                    q_scale=1.0, fault=None):
        """Decode attention at another head width (KV = H, as in
        qwen2-moe, qwen1.5 and zamba2's shared block, unless ``kv`` says
        otherwise), with a window and a softcap where given (q scaled by
        ``q_scale`` so that the cap bites). Bytes and operations count the
        slots the window leaves visible. ``fault`` names an option the
        planted-fault call drops."""
        kv = h if kv is None else kv
        ck, cv = rand(B, PROMPT + 1, kv, dh), rand(B, PROMPT + 1, kv, dh)
        qq, kk, vv = rand(B, h, dh) * q_scale, ck.transpose(1, 2), \
            cv.transpose(1, 2)
        kw = dict(window=window, softcap=softcap)
        seen = min(s, window) if window else s
        lib = None
        if not softcap:
            ok = mask if not window else (
                mask & (q_pos[:, None] - kv_pos[None] < window)[:, None, None])
            lib = (lambda: sdpa(qq[:, :, None], kk, vv, attn_mask=ok))
        # every output averages the 513 slots unless q is sharpened
        opt = dict(avg_tol) if q_scale == 1.0 and not window else {}
        if fault is not None:
            opt.update(fault=fault, fault_call=lambda: dec.decode_attention(
                qq, kk, vv, kv_pos, q_pos, **{**kw, fault: 0}))
        return (name,
                lambda: dec.decode_attention(qq, kk, vv, kv_pos, q_pos, **kw),
                lambda: dec.decode_attention_plain(qq, kk, vv, kv_pos, q_pos,
                                                   **kw),
                lib,
                nbytes(qq, kv_pos, q_pos, qq) + nbytes(ck, cv) * seen // s,
                4 * B * h * seen * dh, PEAK_FLOPS[dname], opt)

    def flash_row(name, b, h, kv, sq, dh, s_kv=None, causal=True, window=0,
                  softcap=0.0, q_scale=1.0, fault=None, heavy=False,
                  per_row=False, q_chunk=0):
        """Prefill (or cross-) attention at the model paths' other shapes
        and options: keys of their own length ``s_kv``, not causal,
        windowed or softcapped (q scaled by ``q_scale`` so that the cap
        bites). Operations count the (query, key) pairs the masks leave.
        The library call is SDPA where it computes the same function (no
        softcap). ``fault`` names the option the planted-fault call drops
        (``s_kv``: the ragged last tile's keys, ``s_kv % FLASH_BK``). Rows
        whose every query averages hundreds of keys take ``AVG_TOL``;
        ``per_row`` rows (causal: from one key to thousands) are held to
        ``ROW_TOL`` of each query row's scale, and ``fault="old_tile"``
        hides the oldest key tile from the last tile's rows. ``heavy`` rows (the plain version's f32 scores take gigabytes) are
        timed eagerly, a few calls. ``q_chunk`` blocks the plain version's
        queries (its f32 scores would not fit the card whole)."""
        s_kv = sq if s_kv is None else s_kv
        qq = rand(b, sq, h, dh).transpose(1, 2) * q_scale
        kk, vv = (rand(b, s_kv, kv, dh).transpose(1, 2) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        qi = torch.arange(sq, device=dev)[:, None]
        kj = torch.arange(s_kv, device=dev)[None]
        vis = torch.ones((sq, s_kv), dtype=torch.bool, device=dev)
        if causal:
            vis &= kj <= qi
        if window:
            vis &= qi - kj < window
        pairs = int(vis.sum())
        lib = None
        if not softcap:
            lib = ((lambda: sdpa(qq, kk, vv, attn_mask=vis)) if window else
                   (lambda: sdpa(qq, kk, vv, is_causal=causal)))
        tc = dtype == torch.bfloat16 and dh in fa.TENSOR_CORE_DH
        opt = {"instance": "tensor_core" if tc else "cuda_core"}
        if not causal and q_scale == 1.0 and s_kv >= 256:
            opt.update(avg_tol)
        if not tc:                     # milliseconds a call: timed eagerly
            opt.update(reps=10, inner=4, graph=False)
        if heavy:
            opt.update(reps=5, inner=2, graph=False)
        if per_row:
            opt.update(row_tol=ROW_TOL[dname])
        if fault == "old_tile":
            assert causal and sq > FLASH_BK
            opt.update(fault=fault, fault_call=lambda: fa.flash_attention(
                qq, kk, vv, **{**kw, "window": sq - FLASH_BK}))
        elif fault == "s_kv":
            kept = s_kv - s_kv % FLASH_BK
            assert kept < s_kv, "the s_kv fault needs a ragged last tile"
            opt.update(fault=fault, fault_call=lambda: fa.flash_attention(
                qq, kk[:, :, :kept], vv[:, :, :kept], **kw))
        elif fault is not None:
            bad = {**kw, fault: {"causal": True, "window": 0,
                                 "softcap": 0.0}[fault]}
            opt.update(fault=fault,
                       fault_call=lambda: fa.flash_attention(qq, kk, vv,
                                                             **bad))
        return (name, lambda: fa.flash_attention(qq, kk, vv, **kw),
                lambda: fa.flash_attention_plain(qq, kk, vv, q_chunk=q_chunk,
                                                 **kw), lib,
                nbytes(qq, kk, vv, qq), 4 * b * h * dh * pairs,
                PEAK_FLOPS[dname], opt)

    def flash_case(name, h, dh):
        """Causal prefill attention over ``PROMPT`` tokens at H = KV = ``h``
        (qwen2-moe 16 and qwen1.5 40 at Dh 128: no GQA grouping); f32
        takes the CUDA-core instance, timed eagerly."""
        qq, kk, vv = (rand(B, PROMPT, h, dh).transpose(1, 2) for _ in range(3))
        return (name, lambda: fa.flash_attention(qq, kk, vv),
                lambda: fa.flash_attention_plain(qq, kk, vv),
                lambda: sdpa(qq, kk, vv, is_causal=True),
                nbytes(qq, kk, vv, qq),
                4 * B * h * dh * PROMPT * (PROMPT + 1) // 2,
                PEAK_FLOPS[dname],
                {"instance": fa_want, **({} if dtype == torch.bfloat16 else
                                         {"reps": 10, "inner": 4,
                                          "graph": False})})

    def decode_long(name, b, s_len):
        """Decode attention for ``b`` sequences over a cache of ``s_len``
        slots, every one visible (smollm-135m's decode_32k cell). Its
        outputs average tens of thousands of slots (RMS about 9e-3), so
        each output row is held to ``ROW_TOL`` of its own scale; the
        planted fault hides the kernel's first split (a window of
        ``s_len`` less one split's slots), which must land past it."""
        ck, cv = rand(b, s_len, KV, DH), rand(b, s_len, KV, DH)
        kk, vv = ck.transpose(1, 2), cv.transpose(1, 2)
        pos = torch.arange(s_len, dtype=torch.int32, device=dev)
        qpos = torch.full((b,), s_len - 1, dtype=torch.int32, device=dev)
        qq = rand(b, H, DH)
        chunk, _ = dec.decode_split(
            s_len, b, KV, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        opt = {"row_tol": ROW_TOL[dname], "fault": "first_split",
               "fault_call": lambda: dec.decode_attention(
                   qq, kk, vv, pos, qpos, window=s_len - chunk)}
        return (name, lambda: dec.decode_attention(qq, kk, vv, pos, qpos),
                lambda: dec.decode_attention_plain(qq, kk, vv, pos, qpos),
                lambda: sdpa(qq[:, :, None], kk, vv),
                nbytes(qq, ck, cv, pos, qpos, qq), 4 * b * H * s_len * DH,
                PEAK_FLOPS[dname], opt)

    # slice 12: qwen2-moe-a2.7b's 4 local heads a rank under TP 4, and
    # smollm-135m's prefill_32k (2 sequences) and decode_32k (16) cells
    slice12 = [
        flash_case("flash_attention_d128_h4", 4, 128),
        decode_case("decode_attention_d128_h4", 4, 128),
    ]
    if dtype == torch.bfloat16:
        slice12 += [
            flash_row("flash_attention_s32768", ROOF_PREFILL_B, H, KV,
                      ROOF_SEQ, DH, heavy=True, per_row=True,
                      q_chunk=2048),
            decode_long("decode_attention_b16_s32768", ROOF_DECODE_B,
                        ROOF_SEQ)]

    # zamba2's shared block: 32 heads at Dh 112, which no tensor-core
    # instance takes
    qz, kz, vz = (rand(B, PROMPT, 32, 112).transpose(1, 2) for _ in range(3))
    fz_ops = 4 * B * 32 * 112 * PROMPT * (PROMPT + 1) // 2
    # the SSD scan at the zamba2 donor prefill's shapes
    zx = rand(B, PROMPT, ZSSM_H, ZSSM_P)
    zb, zc = rand(B, PROMPT, ZSSM_G, ZSSM_N), rand(B, PROMPT, ZSSM_G, ZSSM_N)
    zdt = torch.empty((B, PROMPT, ZSSM_H), device=dev).uniform_(
        0.001, 0.1, generator=g)
    zal = torch.log(torch.linspace(1.0, 16.0, ZSSM_H, device=dev)).to(dtype)
    z0 = torch.zeros((B, ZSSM_H, ZSSM_P, ZSSM_N), device=dev)
    zq, zn_chunks = ZSSM_Q, PROMPT // ZSSM_Q
    z_ops = 2 * B * ZSSM_H * zn_chunks * (
        zq * (zq + 1) // 2 * (ZSSM_N + ZSSM_P) + 2 * zq * ZSSM_N * ZSSM_P)
    return [
        *((nm, lambda xx=xx, ww=ww: rms.rmsnorm(xx, ww),
           lambda xx=xx, ww=ww: rms.rmsnorm_plain(xx, ww),
           lambda xx=xx, ww=ww: F.rms_norm(xx, (ww.shape[0],), ww, 1e-6),
           nbytes(xx, ww, xx), 4 * xx.numel(), ELEMENTWISE_FLOPS,
           {"instance": rms.plan_for(xx, ww).instance})
          for nm, (xx, ww) in wide.items()),
        *((nm, lambda xx=xx, rr=rr, ww=ww: rms.rmsnorm_residual(xx, rr, ww),
           lambda xx=xx, rr=rr, ww=ww: rms.rmsnorm_residual_plain(xx, rr, ww),
           None, nbytes(xx, rr, ww, xx, xx), 5 * xx.numel(),
           ELEMENTWISE_FLOPS, {"instance": rms.plan_for(xx, ww, rr).instance})
          for nm, (xx, rr, ww) in res.items()),
        *((nm, lambda xx=xx, ww=ww: rms.rmsnorm(xx, ww, plus_one=True),
           lambda xx=xx, ww=ww: rms.rmsnorm_plain(xx, ww, plus_one=True),
           # the library's norm takes the weight 1 + w, formed beforehand
           lambda xx=xx, w1=1.0 + ww: F.rms_norm(xx, (w1.shape[0],), w1,
                                                 1e-6),
           nbytes(xx, ww, xx), 5 * xx.numel(), ELEMENTWISE_FLOPS,
           {"instance": rms.plan_for(xx, ww).instance, "fault": "plus_one",
            "fault_call": lambda xx=xx, ww=ww: rms.rmsnorm(xx, ww)})
          for nm, (xx, ww) in plus.items()),
        *((nm, lambda xx=xx, rr=rr, ww=ww: rms.rmsnorm_residual(
            xx, rr, ww, plus_one=True),
           lambda xx=xx, rr=rr, ww=ww: rms.rmsnorm_residual_plain(
               xx, rr, ww, plus_one=True),
           None, nbytes(xx, rr, ww, xx, xx), 6 * xx.numel(),
           ELEMENTWISE_FLOPS,
           {"instance": rms.plan_for(xx, ww, rr).instance,
            "fault": "plus_one",
            "fault_call": lambda xx=xx, rr=rr, ww=ww: rms.rmsnorm_residual(
                xx, rr, ww)})
          for nm, (xx, rr, ww) in res_plus.items()),
        ("decode_attention", lambda: dec.decode_attention(q1, k, v, kv_pos,
                                                          q_pos),
         lambda: dec.decode_attention_plain(q1, k, v, kv_pos, q_pos),
         lambda: sdpa(q1[:, :, None], k, v, attn_mask=mask),
         nbytes(q1, cache_k, cache_v, kv_pos, q_pos, q1), dec_ops,
         PEAK_FLOPS[dname], avg_tol),
        ("flash_attention", lambda: fa.flash_attention(qp, kp, vp),
         lambda: fa.flash_attention_plain(qp, kp, vp),
         lambda: sdpa(qp, kp, vp, is_causal=True),
         nbytes(qp, kp, vp, qp), fa_ops, PEAK_FLOPS[dname],
         {"instance": fa_want}),
        ("flash_attention_d128", lambda: fa.flash_attention(q8, k8, v8),
         lambda: fa.flash_attention_plain(q8, k8, v8),
         lambda: sdpa(q8, k8, v8, is_causal=True),
         nbytes(q8, k8, v8, q8), fa8_ops, PEAK_FLOPS[dname],
         {"instance": fa_want}),
        ("ssd", lambda: ssd_scan.ssd(sx, sdt, sal, sb, sc, SSM_Q, s0),
         lambda: ssd_scan.ssd_plain(sx, sdt, sal, sb, sc, SSM_Q, s0), None,
         ssd_bytes, ssd_ops, PEAK_FLOPS[dname],
         {**ssd_cc, "instance": "+".join(ssd_scan.INSTANCE_KERNELS[
             "tensor_core" if dtype == torch.bfloat16 else "cuda_core"]),
          "profile": True,
          "cuda_core_same_shapes": (lambda: ssd_scan.launch(
              sx, sdt32, sal32, sb, sc, SSM_Q, s0, "cuda_core")[:2])
          if dtype == torch.bfloat16 else None}),
        ("ssd_cuda_core", lambda: ssd_scan.ssd(cx, cdt, sal, cb_, cc_, 96, s0),
         lambda: ssd_scan.ssd_plain(cx, cdt, sal, cb_, cc_, 96, s0), None,
         nbytes(cx, cdt, sal, cb_, cc_, s0, cx, s0), cc_ops,
         PEAK_FLOPS[dname], ssd_cc),
        decode_case("decode_attention_d128", 16, 128),
        decode_case("decode_attention_d112", 32, 112),
        decode_case("decode_attention_d128_h40", 40, 128),
        flash_case("flash_attention_d128_h16", 16, 128),
        flash_case("flash_attention_d128_h40", 40, 128),
        ("flash_attention_d112", lambda: fa.flash_attention(qz, kz, vz),
         lambda: fa.flash_attention_plain(qz, kz, vz),
         lambda: sdpa(qz, kz, vz, is_causal=True),
         nbytes(qz, kz, vz, qz), fz_ops, PEAK_FLOPS[dname],
         {"instance": "cuda_core", "reps": 10, "inner": 4, "graph": False}),
        ("ssd_zamba2",
         lambda: ssd_scan.ssd(zx, zdt, zal, zb, zc, ZSSM_Q, z0),
         lambda: ssd_scan.ssd_plain(zx, zdt, zal, zb, zc, ZSSM_Q, z0), None,
         nbytes(zx, zdt, zal, zb, zc, z0, zx, z0), z_ops, PEAK_FLOPS[dname],
         {**ssd_cc, "instance": "+".join(ssd_scan.INSTANCE_KERNELS[
             "tensor_core" if dtype == torch.bfloat16 else "cuda_core"])}),
        # slice 10 (steps 12-15): gemma2's softcapped global and windowed
        # local layers (32 / 16 heads at Dh 128; a window of 128 so that it
        # masks at S 512), whisper's encoder (non-causal, S 1500), its
        # cross-attention (S 64 and 1 against 1500 frames) and decoder
        # prefill, deepseek's MLA prefill (Dh 192, H = KV = 128), stablelm
        # (Dh 160), pixtral's prefill and its no-cache forward
        flash_row("flash_attention_d128_softcap", B, 32, 16, PROMPT, 128,
                  softcap=50.0, q_scale=8.0, fault="softcap"),
        flash_row("flash_attention_d128_window", B, 32, 16, PROMPT, 128,
                  window=128, softcap=50.0, q_scale=8.0, fault="window"),
        flash_row("flash_attention_full_s1500", B, 6, 6, ENC_FRAMES, 64,
                  causal=False, fault="causal"),
        flash_row("flash_attention_cross", B, 6, 6, ENC_PROMPT, 64,
                  s_kv=ENC_FRAMES, causal=False, fault="s_kv"),
        flash_row("flash_attention_cross_s1", B, 6, 6, 1, 64,
                  s_kv=ENC_FRAMES, causal=False, fault="s_kv"),
        flash_row("flash_attention_s64_h6", B, 6, 6, ENC_PROMPT, 64),
        flash_row("flash_attention_d192", B, 128, 128, PROMPT, 192),
        flash_row("flash_attention_d160", B, 32, 8, PROMPT, 160),
        flash_row("flash_attention_d128_h32kv8", B, 32, 8, PROMPT, 128),
        flash_row("flash_attention_vlm_s1536", VLM_BATCH, 32, 8, VLM_SEQ,
                  128),
        decode_case("decode_attention_d128_softcap", 32, 128, kv=16,
                    softcap=50.0, q_scale=8.0, fault="softcap"),
        decode_case("decode_attention_d128_window", 32, 128, kv=16,
                    window=128, softcap=50.0, q_scale=8.0, fault="window"),
        decode_case("decode_attention_d128_h32kv8", 32, 128, kv=8),
        decode_case("decode_attention_d64_h6", 6, 64),
        decode_case("decode_attention_d160", 32, 160, kv=8),
        # the training path: smollm-135m's causal prefill over 4096 tokens
        flash_row("flash_attention_train_s4096", TRAIN_MB, H, KV, TRAIN_SEQ,
                  DH, heavy=True, per_row=True, fault="old_tile"),
        *slice12,
        # slice 13: the layouts' 9 heads whole on each rank's microbatch of
        # one sequence
        flash_row("flash_attention_layout_s4096", 1, H, KV, TRAIN_SEQ, DH,
                  heavy=True, per_row=True),
    ]


SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:41"),
    "rmsnorm_residual": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:70"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:64"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
    "contention_eta_f64": ("src/repro_torch/kernels/csrc/contention_eta.cu",
                           "src/repro/kernels/contention_eta.py:58"),
    "contention_eta_f32": ("src/repro_torch/kernels/csrc/contention_eta.cu",
                           "src/repro/kernels/contention_eta.py:164"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan.py:71"),
}
# rows of the kernel phase that run a kernel above at other shapes, or
# another instance of it: row -> kernel. A row's launches are those of
# the instance and shape its checked call launched, on every model path
# (``PATH_SHAPES``)
OTHER_SHAPES = {
    **{f"rmsnorm_d{dd}": "rmsnorm" for dd in (2560, 5120, 2048, 3584, 7168)},
    **{f"rmsnorm_prefill_d{dd}": "rmsnorm"
       for dd in (5120, 576, 2048, 2560, 3584, 7168)},
    **{f"rmsnorm_residual_d{dd}": "rmsnorm_residual"
       for dd in (2048, 3584, 5120)},
    **{f"rmsnorm_residual_prefill_d{dd}": "rmsnorm_residual"
       for dd in (576, 2048, 3584, 5120)},
    "ssd_cuda_core": "ssd",
    "flash_attention_d128": "flash_attention",
    "flash_attention_d128_h16": "flash_attention",
    "flash_attention_d128_h40": "flash_attention",
    "decode_attention_d128": "decode_attention",
    "decode_attention_d128_h40": "decode_attention",
    "decode_attention_d112": "decode_attention",
    "flash_attention_d112": "flash_attention",
    "ssd_zamba2": "ssd",
    # slice 10
    **{f"rmsnorm_{k}": "rmsnorm"
       for k in ("d1536", "d512", "prefill_d1536", "prefill_d512",
                 "vlm_d5120", "d4608_plus_one", "prefill_d4608_plus_one")},
    **{f"rmsnorm_residual_{k}": "rmsnorm_residual"
       for k in ("vlm_d5120", "d4608_plus_one",
                 "prefill_d4608_plus_one")},
    **{f"flash_attention_{k}": "flash_attention"
       for k in ("d128_softcap", "d128_window", "full_s1500", "cross",
                 "cross_s1", "s64_h6", "d192", "d160", "d128_h32kv8",
                 "vlm_s1536")},
    **{f"decode_attention_{k}": "decode_attention"
       for k in ("d128_softcap", "d128_window", "d128_h32kv8", "d64_h6",
                 "d160")},
    # the training path
    "rmsnorm_train_d576": "rmsnorm",
    "rmsnorm_residual_train_d576": "rmsnorm_residual",
    "flash_attention_train_s4096": "flash_attention",
    # slice 12: the ranks' local heads, the roofline cells
    "flash_attention_d128_h4": "flash_attention",
    "decode_attention_d128_h4": "decode_attention",
    "flash_attention_s32768": "flash_attention",
    "decode_attention_b16_s32768": "decode_attention",
    "rmsnorm_prefill32k_d576": "rmsnorm",
    "rmsnorm_residual_prefill32k_d576": "rmsnorm_residual",
    "rmsnorm_b16_d576": "rmsnorm",
    "rmsnorm_residual_b16_d576": "rmsnorm_residual",
    # slice 13: the serve_seq_shard prefill's rows, the layouts' shapes
    "rmsnorm_seq_d2048": "rmsnorm",
    "rmsnorm_residual_seq_d2048": "rmsnorm_residual",
    "rmsnorm_layout_d576": "rmsnorm",
    "rmsnorm_residual_layout_d576": "rmsnorm_residual",
    "flash_attention_layout_s4096": "flash_attention",
}
# the model each model path serves or runs
PATH_MODELS = {"dense": "smollm-135m", "ssm": "mamba2-2.7b",
               "moe": MOE_ARCH, "hybrid": HYBRID_ARCH, "int8": INT8_ARCH,
               "mla": MLA_ARCH, "gemma2": GEMMA_ARCH, "vlm": VLM_ARCH,
               "encdec": ENCDEC_ARCH, "train": f"{TRAIN_ARCH} training",
               "dist": f"{MOE_ARCH} on 4 ranks",
               "dist_seq": f"{MOE_ARCH} on 4 ranks, serve_seq_shard",
               "layouts": f"{TRAIN_ARCH} layouts on 4 ranks",
               "roofline": f"{TRAIN_ARCH} roofline cells",
               **{f"drill_{d}": f"smollm-135m/{d}" for d in DRILLS}}
DENSE_PATH = ("rmsnorm", "rmsnorm_residual", "decode_attention",
              "flash_attention")
SSM_PATH = ("rmsnorm", "ssd")
MOE_PATH = INT8_PATH = GEMMA2_PATH = VLM_PATH = DENSE_PATH
HYBRID_PATH = DENSE_PATH + ("ssd",)
# MLA's decode attends the latent cache in plain products, as the
# reference does; whisper's norms are LayerNorms
MLA_PATH = ("rmsnorm", "rmsnorm_residual", "flash_attention")
ENCDEC_PATH = ("decode_attention", "flash_attention")
# training runs no decode (the wrapper raises under autograd)
TRAIN_PATH = ("rmsnorm", "rmsnorm_residual", "flash_attention")
# the drills' stages replay rows 1-3; flash runs in the donors' prefill only
DRILL_PATH = ("rmsnorm", "rmsnorm_residual", "decode_attention")
EPOCH_PATH = ("contention_eta_f64",)


def launch_record(KERNELS):
    """What the wrappers counted since the last reset: for each instance
    launched, its launches and, where the wrapper records it, the grid of
    its last launch and that grid's blocks."""
    rec = {}
    for fn in KERNELS.values():
        for inst, n in fn.counts.by_instance.items():
            rec[inst] = {"launches": n}
            grid = fn.counts.grids.get(inst)
            if grid is not None:
                rec[inst].update(grid=list(grid), blocks=math.prod(grid))
    return rec


def row_rel_err(x, y) -> float:
    """The largest over the output rows (all but the last axis) of a row's
    largest |x - y| over that row's largest |y|."""
    d = (x.float() - y.float()).abs().amax(-1)
    return float((d / y.float().abs().amax(-1).clamp_min(1e-30)).max())


def kernel_phase(torch, F, failures):
    """Every kernel against its plain version in bf16 and f32; returns the
    bf16 (main path) rows keyed by kernel name."""
    from repro_torch.kernels import KERNELS, reset_counts

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, kern, plain, lib, nb, ops, peak, opt in kernel_cases(
                torch, F, dtype):
            tol = opt.get("tol", 3e-2 if dtype == torch.bfloat16 else 2e-4)
            reps, inner = opt.get("reps", 30), opt.get("inner", 10)
            # calls of a millisecond or more are timed eagerly: the host's
            # enqueue hides behind the device, and no graph is captured
            dev_ms = (graph_ms if opt.get("graph", True) else
                      lambda t, f, r, i: cuda_ms(t, f, r, i // 2))
            reset_counts()
            a = kern()
            torch.cuda.synchronize()
            launched = launch_record(KERNELS)
            # the instance and shape keys the checked call launched at
            shapes = {n: sorted(fn.counts.by_shape)
                      for n, fn in KERNELS.items() if fn.counts.by_shape}
            b = plain()
            torch.cuda.synchronize()
            pairs = list(zip(a, b)) if isinstance(a, tuple) else [(a, b)]
            err = max(float((x.float() - y.float()).abs().max())
                      for x, y in pairs)
            row_tol = opt.get("row_tol")

            def within(ps):
                if row_tol is not None:
                    return max(row_rel_err(x, y) for x, y in ps) <= row_tol
                return all(torch.allclose(x.float(), y.float(), rtol=tol,
                                          atol=tol) for x, y in ps)
            ok = within(pairs)
            row = {"name": name, "dtype": str(dtype).replace("torch.", ""),
                   "max_err": err, "tol": tol, "within_tol": ok,
                   "kernel_ms": dev_ms(torch, kern, reps, 2 * inner),
                   "plain_ms": dev_ms(torch, plain, reps, 2 * inner),
                   "library_ms": None,
                   "kernel_host_ms": cuda_ms(torch, kern, reps, inner),
                   "plain_host_ms": cuda_ms(torch, plain, reps, inner)}
            if lib is not None:
                try:
                    row["library_ms"] = graph_ms(torch, lib)
                    row["library_host_ms"] = cuda_ms(torch, lib)
                except (TypeError, RuntimeError) as e:   # yardstick only
                    row["library_error"] = repr(e)
            row["bound_ms"], row["bound_by"] = bound(nb, ops, peak)
            if row_tol is not None:
                row.update(tol=None, row_tol=row_tol, max_row_rel_err=max(
                    row_rel_err(x, y) for x, y in pairs))
            if launched:
                row["launched"] = launched
            if shapes:
                row["shapes"] = shapes
            want = opt.get("instance")
            if want is not None:
                row["instance"] = "+".join(launched)
                if row["instance"] != want:
                    failures.append(f"{name} {row['dtype']}: launched "
                                    f"{launched}, not {want}")
            if opt.get("profile"):
                row["device_us_by_kernel"] = kernel_us(torch, kern)
            same = opt.get("cuda_core_same_shapes")
            if same is not None:   # the kernel the tensor cores replace
                c = same()
                cerr = max(float((u.float() - v.float()).abs().max())
                           for u, v in zip(c, b))
                row["cuda_core_same_shapes"] = {
                    "max_err": cerr, "ms": cuda_ms(torch, same, reps, inner)}
                if not all(torch.allclose(u.float(), v.float(), rtol=tol,
                                          atol=tol) for u, v in zip(c, b)):
                    failures.append(f"{name} {row['dtype']}: CUDA-core "
                                    f"instance max_err {cerr} > {tol}")
            fault = opt.get("fault_call")
            if fault is not None:   # the option dropped: the row must see it
                c = fault()
                fpairs = list(zip(c, b)) if isinstance(c, tuple) else [(c, b)]
                caught = not within(fpairs)
                row["planted_fault"] = {
                    "dropped": opt["fault"], "caught": caught,
                    "max_err": max(float((u.float() - v.float()).abs().max())
                                   for u, v in fpairs)}
                if row_tol is not None:
                    row["planted_fault"]["max_row_rel_err"] = max(
                        row_rel_err(u, v) for u, v in fpairs)
                if not caught:
                    failures.append(f"{name} {row['dtype']}: the call "
                                    f"without {opt['fault']} agrees with "
                                    f"the plain version")
            if name.startswith("decode_attention"):
                split = launched.get("split", {})
                row["n_split"] = split.get("grid", [0])[0]
                row["blocks"] = split.get("blocks", 0)
                if row["blocks"] < sm or "combine" not in launched:
                    failures.append(f"{name} {row['dtype']}: "
                                    f"launched {launched}, want a split "
                                    f"grid of {sm} blocks or more and the "
                                    f"merge")
            emit({"kernel_check": row})
            if not ok or not math.isfinite(err):
                failures.append(f"{name} {row['dtype']}: max_err {err} "
                                f"(per row {row.get('max_row_rel_err')}) "
                                f"past {tol or row_tol}")
            if dtype == torch.bfloat16:
                rows[name] = row
            else:
                F32_CHECKED.update((k, key) for k, keys in shapes.items()
                                   for key in keys)
    return rows


# launches by instance and shape of each model path's kernels, keyed by
# the model's name (``path_counts`` fills it when it reads a path)
PATH_SHAPES = {}
# (kernel, instance and shape) of every f32 row's checked call
F32_CHECKED = set()


def shape_coverage(rows, paths, failures) -> None:
    """Every instance and shape a model path launched a kernel at must be
    one that a bf16 row of the kernel phase (``rows``) held to its plain
    version; emits each path's launches by shape (``path_shapes``)."""
    checked = {(k, key) for row in rows.values()
               for k, keys in row.get("shapes", {}).items() for key in keys}
    by_path = {p: PATH_SHAPES.get(PATH_MODELS[p], {}) for p in paths}
    emit({"path_shapes": by_path})
    for p, per in by_path.items():
        for k, counted in per.items():
            for key, n in counted.items():
                if (k, key) not in checked:
                    failures.append(f"{k}: {n} launches at {key} on the {p} "
                                    f"path, a shape no kernel row checks")


def path_counts(KERNELS, names, path, failures):
    """Launches of a path's kernels (counts reset just before the path);
    fails a kernel with none, and any plain version run on the card. Keeps
    the launches by instance and shape in ``PATH_SHAPES[path]``."""
    launches = {n: KERNELS[n].counts.launches for n in names}
    PATH_SHAPES[path] = {n: dict(KERNELS[n].counts.by_shape) for n in names
                         if KERNELS[n].counts.by_shape}
    plain_cuda = {n: fn.counts.plain_cuda_calls for n, fn in KERNELS.items()}
    for n, c in launches.items():
        if c == 0:
            failures.append(f"{n}: no launch on the {path} path")
    if any(plain_cuda.values()):
        failures.append(f"plain versions ran on CUDA tensors on the {path} "
                        f"path: {plain_cuda}")
    return launches


class ThreadCpu:
    """CPU seconds each thread of this process spends inside the ``with``
    block, from ``/proc/self/task`` read as the block starts and as it
    ends (no thread of the script's own runs meanwhile, so the measured
    work shares the host with nothing of it), named as ``threading``
    names them: which thread burns the host's time in a stalled run. A
    thread born inside the block counts from zero; one that ends inside
    it is not seen."""

    def __init__(self):
        self._tick = os.sysconf("SC_CLK_TCK")
        self.first, self.last, self.names = {}, {}, {}

    def _sample(self, into: dict):
        import threading
        names = {t.native_id: t.name for t in threading.enumerate()}
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:                   # the thread just ended
                continue
            into[tid] = (int(fields[11]) + int(fields[12])) / self._tick
            self.names.setdefault(tid, names.get(int(tid), f"native-{tid}"))

    def __enter__(self):
        self._sample(self.first)
        return self

    def __exit__(self, *exc):
        self._sample(self.last)

    def top(self, n: int = 6) -> list:
        used = sorted(((cpu - self.first.get(t, 0.0), self.names[t])
                       for t, cpu in self.last.items()), reverse=True)
        return [[name, round(cpu, 3)] for cpu, name in used[:n]]


def device_timeline(torch, prof, window_ms: float = 100.0) -> dict:
    """What the card did under ``prof`` (CUDA activity): kernels, busy
    time (the union of their intervals) against the traced span, the
    longest kernel, the kernels with the most device time, and per
    ``window_ms`` window the kernels that ran and their busy ms. A stall
    of the host leaves windows with few kernels and little busy time; a
    slow kernel shows as a long one and busy windows."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"kernels": 0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    t0, t1 = spans[0][0], max(b for _, b in spans)
    n_win = int((t1 - t0) / (window_ms * 1e3)) + 1
    count, busy_w = [0] * n_win, [0.0] * n_win
    busy, end = 0.0, -math.inf
    for a, b in spans:
        count[int((a - t0) / (window_ms * 1e3))] += 1
        a = max(a, end)
        if b > a:
            busy += b - a
            while a < b:                     # split across windows
                w = int((a - t0) / (window_ms * 1e3))
                cut = min(b, t0 + (w + 1) * window_ms * 1e3)
                busy_w[w] += cut - a
                a = cut
            end = b
    top = sorted(by_kernel(kern).items(), key=lambda kv: -kv[1][1])[:6]
    longest = max(kern, key=lambda e: e.time_range.elapsed_us())
    return {"kernels": len(kern), "span_ms": (t1 - t0) / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / (t1 - t0),
            "longest_kernel": [longest.name[:60],
                               longest.time_range.elapsed_us()],
            "top_kernels_us": {n[:60]: [c, t] for n, (c, t) in top},
            "window_ms": window_ms, "window_kernels": count,
            "window_busy_ms": [round(b / 1e3, 3) for b in busy_w]}


def serving_phase(torch, failures, arch, n_layers, jps, kernels,
                  trace=False, max_load=None):
    """``arch`` at full width (depth ``n_layers``, None for all of it),
    two staged decode tasks served in real time; returns the model, its
    parameters, the HP task and the path's launch counts (``serve``).
    With ``max_load``, where the calibrated HP stage sum exceeds that share
    of the period, both tasks' rate drops until it does not (a
    ``rate_lowered`` line says why)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_counts
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg)
    params = model.init_params(0)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    specs = lm_specs(model, params, jps)
    hp_sum = sum(st.t_alone_ms for st in specs[0].stages)
    if max_load is not None and hp_sum > max_load * 1000.0 / jps:
        lowered = 1000.0 * max_load / hp_sum
        emit({"rate_lowered": {
            "model": cfg.name, "from_jobs_per_s": jps,
            "to_jobs_per_s": lowered, "hp_stage_sum_ms": hp_sum,
            "why": f"the calibrated HP stage sum exceeds {max_load:.3g} of "
                   f"the {1000.0 / jps:g} ms period"}})
        jps = lowered
        for sp in specs:
            sp.period_ms = 1000.0 / jps
    leaves = tree_leaves(params)
    desc = {"model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": B, "prompt_len": PROMPT,
            "stages": N_STAGES, "params": sum(t.numel() for t in leaves),
            "param_gb": sum(t.numel() * t.element_size()
                            for t in leaves) / 1e9,
            # the donors' prefill and the calibration, and what they left
            "setup_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "allocated_before_serve_gb": torch.cuda.memory_allocated() / 1e9}
    donors = [donor_checksum(torch, sp) for sp in specs]
    _, launches, instances, _ = serve(torch, failures, specs,
                                      time.perf_counter() - t0, jps,
                                      kernels, desc, trace=trace)
    stage_graph_check(torch, cfg.name, specs[0], failures)
    after = [donor_checksum(torch, sp) for sp in specs]
    emit({"donor_checksum": {"model": cfg.name, "before": donors,
                             "after": after, "unchanged": after == donors}})
    if after != donors:
        failures.append(f"{cfg.name}: a donor cache changed over the run "
                        f"({donors} -> {after})")
    return model, params, specs[0], launches, instances


def lm_specs(model, params, jps) -> list:
    """An HP and an LP staged decode task of ``model`` at ``jps`` (batch
    ``B`` after a ``PROMPT``-token prompt, ``N_STAGES`` stages)."""
    from repro_torch.api import HP, LP
    from repro_torch.serving.engine import staged_lm_taskspec
    return [staged_lm_taskspec(model, priority=p, jps=jps, n_stages=N_STAGES,
                               prompt_len=PROMPT, batch=B, tag=tag,
                               params=params)
            for p, tag in ((HP, "-hp"), (LP, "-lp"))]


def cnn_specs(model, jps) -> list:
    """An HP and an LP staged task of the CNN ``model`` at ``jps``
    (``CNN_HW`` x ``CNN_HW`` x 3, batch ``CNN_BATCH``)."""
    from repro_torch.api import HP, LP
    from repro_torch.serving.engine import staged_cnn_taskspec
    return [staged_cnn_taskspec(model, priority=p, jps=jps, input_hw=CNN_HW,
                                batch=CNN_BATCH, tag=tag)
            for p, tag in ((HP, "-hp"), (LP, "-lp"))]


def donor_checksum(torch, spec) -> list:
    """One checksum a stage of an LM task: the bytes of its donor cache
    slice (``lm_stage``'s ``donor_slice``), each weighted by its offset
    modulo 65,521 plus 1, summed in int64 (in chunks of 64 MiB)."""
    sums = []
    for st in spec.stages:
        total, off = 0, 0
        for t in tree_leaves(st.payload.keywords["donor_slice"]):
            flat = t.contiguous().view(-1).view(torch.uint8)
            for chunk in flat.split(1 << 26):
                w = (torch.arange(off, off + chunk.numel(),
                                  device=chunk.device) % 65521) + 1
                total += int((chunk.long() * w).sum())
                off += chunk.numel()
        sums.append(total)
    return sums


def serve(torch, failures, specs, setup_s, jps, kernels, desc, trace=False,
          input_hw=None, schedcheck=False, prepare=None, fresh=True,
          plan=None):
    """Serve ``specs`` (an HP and an LP task) in real time for
    ``HORIZON_MS`` (2 contexts x 2 streams, oversubscription 2.0, n_units
    the card's SM count, seed 0; NHWC inputs of ``input_hw`` where given)
    and emit the ``serving`` line, which also gives the host's side of the
    run (wall, the process's CPU seconds and context switches, the threads
    that used the most CPU, and from the clock's start the engine
    thread's own, the cgroup's throttling and the polls: ``run_host``);
    ``trace`` puts the run under
    ``torch.profiler`` and adds ``device_timeline``; ``schedcheck`` runs
    ``verify(enforce=False)`` on the config before it is built and emits
    the report beside the run (``schedcheck_served``); ``prepare`` is
    called with the built server before it runs; ``plan`` with the config
    before it is built (the drills' events). Launch counts were reset
    before the tasks were built; ``fresh``: and no server ran them since
    (so the graph pools are the lane streams' and the calibration's).
    Returns the metrics, the launches of ``kernels``, the launches by
    instance and the server."""
    from repro_torch.api import HP, LP, DeviceModel, ServerConfig
    from repro_torch.kernels import KERNELS

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = (ServerConfig.realtime()
           .tasks(specs)
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(DeviceModel(n_units=float(sm)))
           .horizon_ms(HORIZON_MS).seed(0))
    if input_hw is not None:
        cfg = cfg.realtime_io(input_hw=input_hw, batch=specs[0].batch)
    if plan is not None:
        cfg = plan(cfg)
    report = cfg.verify(enforce=False).schedcheck_report if schedcheck \
        else None
    srv = cfg.build()
    if prepare is not None:
        prepare(srv)
    if trace:
        from torch.profiler import ProfilerActivity, profile
        tracer = profile(activities=[ProfilerActivity.CUDA])
    else:
        tracer = contextlib.nullcontext()
    # the allocator's counters as the clock starts (after the warm-up)
    started = srv.backend.start
    warm = {}

    def start():
        import threading
        started()
        warm["alloc"] = allocator_counts(torch)
        warm["stats"] = torch.cuda.memory_stats()
        warm["engine"] = threading.get_ident()
        warm["host"] = {"usage": thread_usage(switches_counted()),
                        "cgroup": cgroup_cpu()[0]}
    srv.backend.start = start
    engine_cpus = sorted(os.sched_getaffinity(0))
    stat0 = proc_stat()
    ru0, w0 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    with tracer, ThreadCpu() as threads, GcTime() as gc_time:
        m = srv.run()
        run_reads = run_host(warm["host"], warm["engine"], srv.backend)
        torch.cuda.synchronize()
    ru1, w1 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    stat1 = proc_stat()
    alloc = {k: v - warm["alloc"][k]
             for k, v in allocator_counts(torch).items()}
    stats = allocator_stats_diff(warm["stats"], torch.cuda.memory_stats())
    host = {"wall_s": w1 - w0, "cpu_user_s": ru1.ru_utime - ru0.ru_utime,
            "cpu_sys_s": ru1.ru_stime - ru0.ru_stime,
            "involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
            "voluntary_switches": ru1.ru_nvcsw - ru0.ru_nvcsw,
            "cpu_s_by_thread": threads.top(), "engine_cpus": engine_cpus,
            # the machine's CPU seconds by kind over the run (/proc/stat)
            "proc_stat_s": (None if None in (stat0, stat1) else
                            {k: stat1[k] - stat0[k] for k in stat0}),
            # from the clock's start: the engine thread's own CPU and
            # switches, the cgroup's throttling, the backend's polls
            **run_reads}
    name = desc["model"]
    launches = path_counts(KERNELS, kernels, name, failures)
    instances = {n: dict(KERNELS[n].counts.by_instance) for n in kernels
                 if KERNELS[n].counts.by_instance}
    be = srv.backend
    graphs = be.graph_summary() if has_stage_graphs() else None
    bound = report.hp_bound_ms() if report is not None else None
    hp = list(m.response_ms[HP])
    # where each HP response went (a tree from before the stamps has
    # none): every job in full for the jobs over the bound and the HP
    # stages' enqueues, then the 3 slowest shown
    parts = (be.hp_response_parts(slowest=len(hp) + 3)
             if hasattr(be, "hp_response_parts") else None)
    over = hp_enqueue = hp_input = hp_prep = None
    if parts is not None:
        over = over_bound_jobs(parts, bound)
        hp_enqueue = stage_enqueues(parts)
        hp_input = input_steps(parts)
        hp_prep = prep_by_stage(parts)
        parts["slowest"] = parts["slowest"][:3]
    lanes = len(be.core.sched.lanes)
    # lane streams the run made: one a lane live at once (a tree before
    # their reuse made one a lane it ever had)
    streams = (graphs or {}).get("streams", len(be._streams))
    # the collections on the backend's clock: in the served run (from the
    # clock's start), and before it (the lanes' warm-up)
    collections = gc_time.on_clock(be._t0)
    in_run = [c for c in collections if c[1] >= 0.0]
    # the engine thread's stalls and the card stages' enqueues (none in a
    # tree from before their stamps)
    stalls = (be.engine_stalls(in_run) if hasattr(be, "engine_stalls")
              else None)
    enqueue = (be.enqueue_summary() if hasattr(be, "enqueue_summary")
               else None)
    if enqueue is not None and "hp_step_median_by_stage" not in enqueue:
        # a tree from before the summary took HP stages apart: from its
        # enqueue rows (stage, priority, ms, steps by name, result ms)
        enqueue["hp_step_median_by_stage"] = hp_step_medians(
            [r for r in be._enqueues if r[1] == HP])
    # the HP stages' calls made ready ahead of their boundary (none in a
    # tree from before them)
    ready = be.ready_summary() if hasattr(be, "ready_summary") else None
    SERVED.append({"model": name, "hp_missed": m.missed[HP],
                   "lp_completed": m.completed[LP],
                   "hp_response_ms": hp,
                   "hp_parts_total_ms": parts and parts["total_ms"],
                   "hp_jobs": parts and parts["jobs"],
                   "graph_pools": graphs and graphs.get("pools"),
                   "hp_bound_ms": bound, "over_bound": over,
                   "hp_enqueue": hp_enqueue, "hp_input": hp_input,
                   "hp_engine_median_ms": enqueue and enqueue.get(
                       "engine_median_by", {}).get("hp"),
                   "hp_prep_by_stage": hp_prep,
                   "hp_steps_by_stage": enqueue and enqueue.get(
                       "hp_step_median_by_stage"),
                   "ready": ready,
                   "stage_device_ms": {
                       k: v["mean_device_ms"]
                       for k, v in be.stage_time_summary().items()},
                   "stalls": stalls_by_step(stalls),
                   "host": host_row(host),
                   "gc": gc_summary(in_run)})
    if graphs is not None and (graphs["stage_runs"] == 0
                               or graphs["replays"] != graphs["stage_runs"]):
        failures.append(f"{name}: {graphs['stage_runs']} payload stages "
                        f"ran on the lanes, {graphs['replays']} of them "
                        f"CUDA-graph replays (every one must be)")
    if graphs is not None and "pools" in graphs and (
            graphs["run_pools"] != streams
            or fresh and graphs["pools"] != streams + 1):
        failures.append(f"{name}: graph pools {graphs['run_pools']} for "
                        f"{streams} lane streams, {graphs['pools']} with "
                        f"the calibration's stream (one a stream)")
    if graphs is not None and graphs.get("events_in_run"):
        failures.append(f"{name}: {graphs['events_in_run']} CUDA events made "
                        f"after the clock started (each lane stream's ring "
                        f"is made with the stream)")
    unnamed = ready and sum(ready["discarded"]["unnamed"].values())
    if unnamed:
        failures.append(f"{name}: {unnamed} HP calls made ready ahead were "
                        f"discarded without a reason ({ready['discarded']})")
    if graphs is not None and graphs.get("pool_stage_runs"):
        failures.append(f"{name}: {graphs['pool_stage_runs']} payload "
                        f"stages ran on the worker pool (every one must be "
                        f"enqueued on the engine thread)")
    if alloc["num_device_alloc"] or alloc["num_alloc_retries"]:
        failures.append(f"{name}: the caching allocator called the driver "
                        f"in the served run ({alloc}): the lanes' warm-up "
                        f"left a stream without its stages' blocks")
    if parts is not None and (parts["jobs"] != len(m.response_ms[HP])
                              or not parts["sum_err_ms"] <= PARTS_TOL_MS):
        failures.append(f"{name}: HP response parts of {parts['jobs']} of "
                        f"{len(m.response_ms[HP])} jobs, off their responses "
                        f"by up to {parts['sum_err_ms']} ms")
    emit({"serving": {
        **desc, "sm_count": sm,
        "jobs_per_s": jps, "setup_s": setup_s, "horizon_ms": HORIZON_MS,
        "t_alone_ms": {s.name: [st.t_alone_ms for st in s.stages]
                       for s in specs},
        "completed": {"hp": m.completed[HP], "lp": m.completed[LP]},
        "missed": {"hp": m.missed[HP], "lp": m.missed[LP]},
        "rejected": {"hp": m.rejected[HP], "lp": m.rejected[LP]},
        # in completion order: where in the run the misses fall
        "hp_response_ms": [round(r, 1) for r in m.response_ms[HP]],
        "mean_response_ms": {
            "hp": m.resp_stats(HP)["mean"] if m.response_ms[HP] else None,
            "lp": m.resp_stats(LP)["mean"] if m.response_ms[LP] else None},
        "p99_response_ms": {
            "hp": m.resp_stats(HP)["p99"] if m.response_ms[HP] else None,
            "lp": m.resp_stats(LP)["p99"] if m.response_ms[LP] else None},
        "migrations": m.migrations,
        # before the clock starts; in host's wall and CPU seconds
        "warm_up_s": be.warm_s,
        "worker_exceptions": be.worker_exceptions,
        "last_worker_exception": repr(be.last_worker_exception),
        "stage_times": be.stage_time_summary(),
        # the stage programs' CUDA graphs: captured in the warm-up (within
        # warm_up_s), one replay a payload stage run on a lane after it
        "stage_graphs": graphs, "lanes": lanes,
        "hp_response_parts": parts,
        "enqueue": enqueue, "hp_enqueue": hp_enqueue, "over_bound": over,
        # the HP stages' calls made ready ahead: made, used, discarded by
        # reason, left at the stop, the share of HP stages that took
        # theirs; and a HP job's prep by stage (median ms)
        "ready": ready, "hp_prep_by_stage": hp_prep,
        "engine_stalls": (None if stalls is None else {
            "count": len(stalls), "by_step": stalls_by_step(stalls),
            "rows": stalls}),
        # the host events behind a stall: the interpreter lock's switch
        # interval, the collections in the run by generation (and each
        # one on the backend's clock), those of the warm-up, and whether
        # the slowest HP jobs' largest part overlaps one
        "switch_interval_s": sys.getswitchinterval(),
        "gc": {"run": gc_summary(in_run), "run_events_ms": in_run,
               "warm_up": gc_summary([c for c in collections
                                      if c[1] < 0.0])},
        "slowest_vs_gc": (slowest_vs_collections(parts, in_run)
                          if parts is not None else None),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "allocated_blocks_mib": allocated_blocks(torch),
        # the caching allocator's calls to the driver in the run (a retry
        # frees cached blocks after synchronizing every stream)
        "allocator_in_run": alloc,
        # and its counters that moved in the run (allocations and frees by
        # pool, calls that synchronized every stream)
        "allocator_stats_in_run": stats,
        "launches": launches, "launches_by_instance": instances,
        "host": host,
        **({"device_timeline": device_timeline(torch, tracer)}
           if trace else {})}})
    if report is not None:
        emit({"schedcheck_served": schedcheck_served(name, report, m)})
    if be.worker_exceptions:
        failures.append(f"{be.worker_exceptions} worker exception(s), last "
                        f"{be.last_worker_exception!r}")
    if m.completed[HP] == 0:
        failures.append(f"{name}: no HP job completed")
    return m, launches, instances, srv


ALLOCATOR_COUNTS = ("num_alloc_retries", "num_sync_all_streams",
                    "num_device_alloc", "num_device_free", "num_ooms")


def allocator_counts(torch) -> dict:
    """The caching allocator's counters of its calls to the driver."""
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ALLOCATOR_COUNTS}


def allocator_stats_diff(before: dict, after: dict) -> dict:
    """The caching allocator's event counters (``num_*`` and the
    allocations and frees of each pool) that moved between two
    ``torch.cuda.memory_stats()`` readings."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if (k.startswith("num_") or k.endswith(
                (".all.allocated", ".all.freed")))
            and v != before.get(k, 0)}


def allocated_blocks(torch, top: int = 6) -> list:
    """What holds the card's allocated memory: [MiB a block, blocks] of
    the allocated block sizes that hold the most bytes."""
    sizes = {}
    for seg in torch.cuda.memory_snapshot():
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                sizes[b["size"]] = sizes.get(b["size"], 0) + 1
    return [[size / 2**20, n] for size, n in sorted(
        sizes.items(), key=lambda kv: -kv[0] * kv[1])[:top]]


# seconds of each served model's stage_graphs check (``phase_seconds``)
STAGE_GRAPH_S = {}
# each served run's HP side, in order (``serve_repeats`` sums them up)
SERVED = []


def has_stage_graphs() -> bool:
    """Whether the port beside this script compiles its stages
    (``serving/stage_graph.py``): not so in a checkout from before it,
    where this script runs as the other side of an A/B (``--serve``)."""
    import importlib.util
    return importlib.util.find_spec("repro_torch.serving.stage_graph") \
        is not None


def eager_payload(payload):
    """``payload`` with its stage program's functional stage function
    called in place of the program (an LM payload's ``program`` keyword,
    or the CNN payload, a ``StageProgram``, itself): the eager stage the
    compiled one is held to. An LM program's own ``fn`` writes its static
    cache copy in place; a tree from before that has no ``functional``."""
    import functools
    if isinstance(payload, functools.partial):
        prog = payload.keywords["program"]
        return functools.partial(payload.func, **{
            **payload.keywords,
            "program": getattr(prog, "functional", prog.fn)})
    return getattr(payload, "functional", payload.fn)


def stage_graph_check(torch, name, spec, failures, tol=None):
    """The ``stage_graphs`` phase for one served model: two jobs (seeded
    inputs that differ: tokens for an LM, images for a CNN) through the
    served task's compiled payloads on two lane streams, interleaved (job
    A's stage k, then job B's, on stream k % 2: B's replay on A's lane
    overwrites the graph's static outputs A's state came from), each stage
    held to its eager stage function run from the same input state. An
    LM's output and cache slice must be bit-identical (``tol`` None), a
    CNN's within ``tol`` of the output's scale; a job's state must still
    be what its last stage made of it when its next stage reads it, and
    at the end. Emits the ``stage_graphs`` line with the captures,
    replays and seconds."""
    import numpy as np

    if not has_stage_graphs():
        return
    from repro_torch.kernels import _lib
    from torch.utils._pytree import tree_flatten

    t0 = time.perf_counter()
    g0 = _lib.stage_graphs.snapshot()
    rng = np.random.default_rng(11)
    payloads = [st.payload for st in spec.stages]
    lm = tol is None
    if lm:      # tokens below 200: below every vocabulary, reduced ones too
        fresh = payloads[0].keywords["fresh"]
        states = [{"hidden": torch.from_numpy(rng.integers(
            0, 200, tuple(fresh.shape))).to(fresh.device, torch.int32),
            "slices": {}} for _ in range(2)]
    else:
        states = [torch.from_numpy(rng.standard_normal(
            (spec.batch, CNN_HW, CNN_HW, 3)).astype(np.float32)).cuda()
            for _ in range(2)]

    def leaves(state):
        return tree_flatten(state)[0]

    def unchanged(j):
        return kept[j] is None or all(
            torch.equal(a, b) for a, b in zip(leaves(states[j]), kept[j]))

    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    worst, same, held = 0.0, True, True
    kept = [None, None]       # each job's state as its last stage made it
    for k, p in enumerate(payloads):
        for j in range(2):
            held = held and unchanged(j)
            with torch.cuda.stream(streams[k % 2]):
                out = p(states[j])
            torch.cuda.synchronize()
            ref = eager_payload(p)(states[j])
            torch.cuda.synchronize()
            for a, b in zip(leaves(out), leaves(ref)):
                if lm:
                    same = same and torch.equal(a, b)
                else:
                    scale = max(1.0, float(b.abs().max()))
                    worst = max(worst, float((a - b).abs().max()) / scale)
            states[j] = out
            kept[j] = [t.clone() for t in leaves(out)]
    torch.cuda.synchronize()
    held = held and unchanged(0) and unchanged(1)
    g1 = _lib.stage_graphs.snapshot()
    seconds = time.perf_counter() - t0
    STAGE_GRAPH_S[name] = seconds
    line = {"model": name, "stages": len(payloads), "jobs": 2, "streams": 2,
            "captures": g1["captures"] - g0["captures"],
            "capture_s": g1["capture_s"] - g0["capture_s"],
            "replays": g1["replays"] - g0["replays"],
            "replayed_launches": (g1["replayed_launches"]
                                  - g0["replayed_launches"]),
            "states_held": held, "seconds": seconds}
    if lm:
        line["bit_identical"] = same
    else:
        line.update(max_rel_err=worst, tol=tol)
    emit({"stage_graphs": line})
    if not held:
        failures.append(f"{name}: a job's state changed after its stage "
                        f"(a later replay overwrote it)")
    if lm and not same:
        failures.append(f"{name}: compiled stages differ from the eager "
                        f"ones on the same state")
    if not lm and not worst <= tol:
        failures.append(f"{name}: compiled CNN stages differ from the eager "
                        f"ones by {worst} of the output's scale (> {tol})")
    if line["replays"] != 2 * len(payloads):
        failures.append(f"{name}: {line['replays']} replays for "
                        f"{2 * len(payloads)} compiled stage calls")


def schedcheck_served(name, report, m) -> dict:
    """The static report of a served config beside what the run showed,
    with the violations the differential oracle's two rules would name
    (observed HP response above the bound; GUARANTEED with HP misses). A
    measurement of ROADMAP C7, not a gate: served HP misses are an open
    fault."""
    from repro_torch.analysis.schedcheck import GUARANTEED
    from repro_torch.api import HP

    hp = m.response_ms[HP]
    observed = max(hp) if hp else 0.0
    bound = report.hp_bound_ms()
    violations = []
    if observed > bound + 1e-6:
        violations.append(f"observed HP response {observed:.3f}ms exceeds "
                          f"the static bound {bound:.3f}ms")
    if report.hp_verdict == GUARANTEED and m.dmr(HP) > 0.0:
        violations.append(f"HP verdict GUARANTEED but the run missed "
                          f"{m.dmr(HP):.2%} of HP deadlines")
    return {"model": name, "verdict": report.verdict,
            "hp_verdict": report.hp_verdict, "hp_bound_ms": finite(bound),
            "observed_hp_max_ms": observed, "hp_missed": m.missed[HP],
            "dmr_hp": m.dmr(HP), "violations": violations,
            "assumptions": report.assumptions}


def contention_phase(torch, failures):
    """The contention + ETA kernel on three rate-groups: two of 4096 lanes
    (all three branches fire in one, none in the other), whose columns stay
    in shared memory, and one of 12,289, past the shared-memory limit
    (the tiled instance). Returns the f64 and f32 rows; the f32 row's
    launches are those of its fleet-sweep call."""
    import numpy as np

    from repro_torch.api import DeviceModel
    from repro_torch.kernels import contention_eta as ce
    from repro_torch.runtime.contention import ContentionModel

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    groups = {   # (device model, u, ns, mf, rem)
        "branches_fire": (DeviceModel(n_units=float(sm)),
                          rng.uniform(0.2, 4.0, LANES), rng.uniform(5, 40, LANES),
                          rng.uniform(0.05, 0.9, LANES),
                          rng.uniform(0.1, 8.0, LANES)),
        "no_branch": (DeviceModel(n_units=1e6, l2_pressure=0.0),
                      rng.uniform(0.2, 0.4, LANES), rng.uniform(30, 40, LANES),
                      np.full(LANES, 1e-5), rng.uniform(0.1, 8.0, LANES)),
        "tiled": (DeviceModel(n_units=float(sm)),
                  rng.uniform(0.2, 4.0, TILED_LANES),
                  rng.uniform(5, 40, TILED_LANES),
                  rng.uniform(0.05, 0.9, TILED_LANES),
                  rng.uniform(0.1, 8.0, TILED_LANES)),
    }
    arrays = groups
    groups = {k: (g[0], *(a.tolist() for a in g[1:]))
              for k, g in groups.items()}
    # the f32 variant's own path: one fleet-sweep call per group
    ce.fused_f32.counts.reset()
    for dm, u, ns, mf, rem in groups.values():
        ce.fused_f32(dm, 1.0, u, ns, mf, rem)
    torch.cuda.synchronize()
    f32_launches = ce.fused_f32.counts.launches
    if f32_launches == 0:
        failures.append("contention_eta_f32: no launch on its fleet sweep")

    mhz = DEFAULT_SM_MHZ
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        mhz = float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    rows = {}
    for name, dtype, elt in (("contention_eta_f64", torch.float64, 8),
                             ("contention_eta_f32", torch.float32, 4)):
        checks, instances, err = {}, {}, 0.0
        counts = (ce.fused if dtype == torch.float64 else ce.fused_f32).counts
        for gname, (dm, u, ns, mf, rem) in groups.items():
            counts.reset()
            if dtype == torch.float64:
                got = ce.fused(dm, 1.0, u, ns, mf, rem)
                want = ce.fused_plain(dm, 1.0, u, ns, mf, rem, device=dev)
                seq = ContentionModel(dm).rates_seq(u, ns, mf)
                seq = [r if r > 1e-6 else 1e-6 for r in seq]
                speed = ce.rates(dm, u, ns, mf)
                from_arrays = ce.fused(dm, 1.0, *arrays[gname][1:])
                ok = (all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
                          for a, b in zip(got, want))
                      and all(np.array_equal(a, b)
                              for a, b in zip(from_arrays, got))
                      and got[0].tolist() == seq
                      and [r if r > 1e-6 else 1e-6 for r in speed] == seq)
            else:
                got = ce.fused_f32(dm, 1.0, u, ns, mf, rem)
                want = ce.fused_f32_plain(dm, 1.0, u, ns, mf, rem, device=dev)
                ok = all(np.allclose(a, b, rtol=2e-6, atol=0)
                         for a, b in zip(got, want))
            err = max(err, max(float(np.abs(a.astype(np.float64) - b).max())
                               for a, b in zip(got, want)))
            checks[gname] = ok
            instances[gname] = "+".join(counts.by_instance)
            if not ok:
                failures.append(f"{name} on {gname}: kernel and plain "
                                f"version disagree")
            want_inst = "tiled" if gname == "tiled" else "resident"
            if instances[gname] != want_inst:
                failures.append(f"{name} on {gname}: launched "
                                f"{counts.by_instance}, not {want_inst}")
        dm, u, ns, mf, rem = groups["branches_fire"]
        comp = ce.SUM_IS_COMPENSATED and dtype == torch.float64

        def timed_launch(g):
            dm_g, *cols = groups[g]
            x = ce.lane_columns(*cols, dtype).to(dev)
            out_t = torch.empty((3, x.shape[1]), dtype=dtype, device=dev)
            return lambda: ce.launch(x, out_t, 1.0, dm_g, comp)

        def wall_ms(fn, n=20):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n
        wrapper = ce.fused if dtype == torch.float64 else ce.fused_f32
        plain = ce.fused_plain if dtype == torch.float64 else ce.fused_f32_plain
        cm = ContentionModel(dm)
        au, ans, amf, arem = arrays["branches_fire"][1:]
        add_cycles = ce.chain_cycles(dtype, "add")
        t_bytes = LANES * elt * 7 / HBM_BYTES_PER_S
        t_chain = 3 * LANES / (mhz * 1e6)
        row = {"name": name, "dtype": str(dtype).replace("torch.", ""),
               "lanes": LANES, "checks": checks, "instances": instances,
               "max_err": err,
               "tol": 0.0 if dtype == torch.float64 else "2e-6 relative",
               "kernel_ms": graph_ms(torch, timed_launch("branches_fire")),
               "kernel_ms_tiled": graph_ms(torch, timed_launch("tiled"),
                                           reps=10, inner=5),
               "tiled_lanes": TILED_LANES,
               "round_trip_ms": wall_ms(lambda: wrapper(dm, 1.0, u, ns, mf,
                                                        rem)),
               "round_trip_arrays_ms": wall_ms(
                   lambda: wrapper(dm, 1.0, au, ans, amf, arem)),
               "plain_ms": wall_ms(lambda: plain(dm, 1.0, u, ns, mf, rem,
                                                 device=dev), 5),
               "rates_seq_host_ms": wall_ms(lambda: cm.rates_seq(u, ns, mf)),
               "library_ms": None,
               "add_cycles": add_cycles,
               "chain_cycles": ce.chain_cycles(dtype, "chain"),
               "latency_floor_ms": 3 * LANES * add_cycles / (mhz * 1e6) * 1e3,
               "bound_bytes_ms": t_bytes * 1e3,
               "bound_serial_chain_ms": t_chain * 1e3, "sm_clock_mhz": mhz,
               "bound_ms": max(t_bytes, t_chain) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_chain else "operations"}
        if dtype == torch.float64:
            row["rates_round_trip_ms"] = wall_ms(
                lambda: ce.rates(dm, u, ns, mf))
            # a rate-group of the epoch phase's size (its scenario has 24
            # lanes), from lists, against rates_seq on the host
            su, sns, smf = u[:SMALL_LANES], ns[:SMALL_LANES], mf[:SMALL_LANES]
            row["small_group_lanes"] = SMALL_LANES
            row["rates_round_trip_small_ms"] = wall_ms(
                lambda: ce.rates(dm, su, sns, smf), 200)
            row["rates_seq_host_small_ms"] = wall_ms(
                lambda: cm.rates_seq(su, sns, smf), 200)
            xs = ce.lane_columns(su, sns, smf, rem[:SMALL_LANES], dtype).to(dev)
            outs = torch.empty((3, SMALL_LANES), dtype=dtype, device=dev)
            row["kernel_ms_small"] = graph_ms(
                torch, lambda: ce.launch(xs, outs, 1.0, dm, comp))
            row["neumaier_select_cycles"] = ce.chain_cycles(
                dtype, "neumaier_select")
        else:
            row["launches_fleet_sweep"] = f32_launches
        emit({"kernel_check": row})
        rows[name] = row
    return rows, f32_launches


EPOCH_HORIZON_MS = 2000.0


def epoch_scenario(api, sm):
    """One device, 4 contexts x 6 streams, twelve tasks with stage noise,
    seeded faults and a brownout window."""
    specs = [api.TaskSpec(
        name=f"t{i:02d}", period_ms=12.0 + 2 * i,
        priority=api.HP if i < 3 else api.LP,
        stages=[api.StageProfile(f"t{i:02d}/s{j}", t, n_sat=8.0 + i,
                                 mem_frac=0.3, overhead_ms=0.05)
                for j, t in enumerate((3.0 + i % 4, 2.0 + i % 3))])
        for i in range(12)]
    plan = api.ChaosPlan(seed=3, stage_fault_rate=0.02,
                         brownouts=(api.Brownout(500.0, 1200.0, device=0,
                                                 slow_factor=2.5),))
    return (api.ServerConfig.sim().tasks(specs).contexts(4).streams(6)
            .oversubscribe(2.0).device(api.DeviceModel(n_units=float(sm)))
            .horizon_ms(EPOCH_HORIZON_MS).seed(5).chaos(plan)
            .record_decisions())


ENGINE_RUNS = (("heap", "heap", None), ("epoch", "epoch", None),
               ("epoch_kernel_min_1", "epoch", "1"))


def count_rate_groups(srv) -> dict:
    """Wrap ``srv.scheduler.rate_groups`` (the engines ask it for the
    rate-groups a running-set change dirtied): its calls, the groups it
    returned, the most in one call, and the lanes a group as a
    histogram."""
    stats = {"calls": 0, "groups": 0, "max_groups_per_call": 0,
             "lanes_per_group": {}}
    rate_groups, hist = srv.scheduler.rate_groups, stats["lanes_per_group"]

    def counted(entries):
        out = rate_groups(entries)
        stats["calls"] += 1
        stats["groups"] += len(out)
        stats["max_groups_per_call"] = max(stats["max_groups_per_call"],
                                           len(out))
        for _, _, group in out:
            hist[len(group)] = hist.get(len(group), 0) + 1
        return out
    srv.scheduler.rate_groups = counted
    return stats


def time_rates(srv) -> dict:
    """Wrap the epoch engine's ``_rates_for`` (one call a rate-group:
    ``rates_seq`` on the host, or the kernel's round trip): its calls and
    the host seconds spent inside it."""
    stats = {"calls": 0, "s": 0.0}
    rates_for = srv.backend._rates_for

    def timed(*a):
        t0 = time.perf_counter()
        out = rates_for(*a)
        stats["s"] += time.perf_counter() - t0
        stats["calls"] += 1
        return out
    srv.backend._rates_for = timed
    return stats


class GcTime:
    """The interpreter's garbage collections inside the ``with`` block:
    how many, the host seconds they took, and each one's generation and
    start and end ``time.perf_counter`` seconds (``gc.callbacks``)."""

    def __enter__(self):
        import gc
        self._gc, self.collections, self.s, self._t0 = gc, 0, 0.0, 0.0
        self.events = []
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            t1 = time.perf_counter()
            self.s += t1 - self._t0
            self.collections += 1
            self.events.append((info["generation"], self._t0, t1))

    def __exit__(self, *exc):
        self._gc.callbacks.remove(self._callback)

    def on_clock(self, t0: float) -> list:
        """[generation, start ms, end ms] of each collection on a clock
        that reads 0 at ``time.perf_counter()`` ``t0`` (a realtime
        backend's)."""
        return [[g, (a - t0) * 1000.0, (b - t0) * 1000.0]
                for g, a, b in self.events]


def gc_summary(events: list) -> dict:
    """Collections ([generation, start ms, end ms]) by generation: how
    many, their seconds and the longest pause in ms."""
    out = {}
    for g, a, b in events:
        row = out.setdefault(str(g), {"count": 0, "s": 0.0, "max_ms": 0.0})
        row["count"] += 1
        row["s"] += (b - a) / 1000.0
        row["max_ms"] = max(row["max_ms"], b - a)
    return out


def slowest_vs_collections(parts: dict, events: list) -> list:
    """For each of ``hp_response_parts``' slowest jobs: its largest stage
    part (the parts follow each other from the release, so each has its
    interval on the backend's clock) and the collections that overlap it
    ([generation, ms of the part they cover])."""
    rows = []
    for job in parts["slowest"]:
        t = job["release_ms"] + job["parts"]["release_to_launch"]
        best = None
        for st in job["stages"]:
            for k in RESPONSE_PARTS[1:]:
                ms = st.get(k, 0.0)           # no prep in an older tree
                if best is None or ms > best[2]:
                    best = (st["stage"], k, ms, t, t + ms)
                t += ms
        stage, part, ms, a, b = best
        hit = [[g, min(b, e) - max(a, s)] for g, s, e in events
               if s < b and e > a]
        rows.append({"response_ms": job["response_ms"], "stage": stage,
                     "part": part, "ms": ms,
                     "overlaps_collection": bool(hit), "collections": hit})
    return rows


PROC_STAT = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
             "steal")


def proc_stat():
    """The machine's CPU seconds by kind since boot (``/proc/stat``'s
    first line), or None where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:1 + len(PROC_STAT)]
    except OSError:
        return None
    tick = os.sysconf("SC_CLK_TCK")
    return {k: int(v) / tick for k, v in zip(PROC_STAT, fields)}


# the host readings below are the script's own (the backend has its
# like for its stalls): an A/B runs this script in older trees too

def thread_usage(counted: bool):
    """The calling thread's CPU seconds, voluntary and involuntary context
    switches (``getrusage(RUSAGE_THREAD)``; None where the host does not
    count them: ``counted``, from ``switches_counted``)."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    if not counted:
        return ru.ru_utime + ru.ru_stime, None, None
    return ru.ru_utime + ru.ru_stime, ru.ru_nvcsw, ru.ru_nivcsw


def switches_counted() -> bool:
    """Whether this host counts a thread's context switches (its kernel
    lists them in the thread's ``/proc`` status)."""
    try:
        with open("/proc/thread-self/status") as f:
            return "voluntary_ctxt_switches" in f.read()
    except OSError:
        return False


CGROUP_COUNTS = ("nr_periods", "nr_throttled", "throttled_usec")


def cgroup_cpu():
    """The process's cgroup CPU limit and throttling counters: (reading,
    None); (reading with the counters None, the reason) where only the
    limit can be read; or (None, the reason) where neither can. The cgroup
    is the one ``/proc/self/cgroup`` names, under the unified (v2)
    hierarchy (``cpu.max``, ``cpu.stat``) or the ``cpu`` controller's (v1)
    mount (``cpu.cfs_quota_us``, ``cpu.cfs_period_us``, ``cpu.stat``,
    whose ``throttled_time`` is in ns), or that mount's root where the
    path is not in it (a container's own namespace): the first whose
    ``cpu.stat`` counts throttling, else the first with a limit file."""
    def read(path):
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None
    text = read("/proc/self/cgroup")
    if text is None:
        return None, "/proc/self/cgroup unreadable"
    tried, limited = [], None
    for line in text.splitlines():
        if line.count(":") < 2:
            continue
        _, ctl, path = line.split(":", 2)
        if ctl == "":
            version, limits = 2, ("cpu.max",)
            roots = ["/sys/fs/cgroup", "/sys/fs/cgroup/unified"]
        elif "cpu" in ctl.split(","):
            version, limits = 1, ("cpu.cfs_quota_us", "cpu.cfs_period_us")
            roots = [f"/sys/fs/cgroup/{ctl}", "/sys/fs/cgroup/cpu",
                     "/sys/fs/cgroup/cpu,cpuacct"]
        else:
            continue
        for root in roots:
            for d in (root + path.rstrip("/"), root):
                limit = {f: read(f"{d}/{f}") for f in limits}
                limit = {f: v.strip() for f, v in limit.items()
                         if v is not None}
                row = {"dir": d, "version": version, "limit": limit}
                stat = read(f"{d}/cpu.stat")
                if stat is None or "nr_throttled" not in stat:
                    tried.append(d)
                    if limit and limited is None:
                        limited = {**row, **dict.fromkeys(CGROUP_COUNTS)}
                    continue
                kv = dict(ln.split() for ln in stat.splitlines()
                          if len(ln.split()) == 2)
                if "throttled_usec" not in kv:
                    kv["throttled_usec"] = int(kv.get("throttled_time",
                                                      0)) // 1000
                return {**row, **{k: int(kv.get(k, 0))
                                  for k in CGROUP_COUNTS}}, None
    return limited, (f"no cpu.stat that counts throttling (tried "
                     f"{sorted(set(tried))})")


def run_host(before: dict, engine_ident: int, be) -> dict:
    """The served run's host readings beside ``host``'s process-wide ones,
    from the clock's start (``before``: the engine thread's
    ``thread_usage`` and ``cgroup_cpu`` then) to the run's end, read on
    the thread that ran ``srv.run()``: the engine thread's CPU seconds and
    switches (``on_engine_thread``: the backend's start ran on it too;
    the switches None where the host does not count them), the cgroup's
    CPU limit and the deltas of its period and throttling counters (None
    with ``cgroup_reason`` where they cannot be read), and
    the backend's polls and end-event queries (None in a tree without
    those counts)."""
    import threading
    counted = before["usage"][1] is not None
    cpu, vol, invol = thread_usage(counted)
    cg, reason = cgroup_cpu()
    cg0 = before["cgroup"]
    if cg is not None:
        cg = {**cg, **{k: None if cg0 is None or cg[k] is None
                       else cg[k] - cg0[k] for k in CGROUP_COUNTS}}
    polls = getattr(be, "poll_counts", None)
    return {"engine_thread": {
                "on_engine_thread": threading.get_ident() == engine_ident,
                "cpu_s": cpu - before["usage"][0],
                "switches_counted": counted,
                "voluntary_switches": (vol - before["usage"][1]
                                       if counted else None),
                "involuntary_switches": (invol - before["usage"][2]
                                         if counted else None)},
            "cgroup": cg, "cgroup_reason": reason,
            "poll_counts": polls and dict(polls)}


def over_bound_jobs(parts: dict, bound) -> list:
    """Each HP job of ``parts["slowest"]`` above ``bound`` (SchedCheck's
    static HP bound, ms): its response, its largest stage part, and that
    stage's enqueue and its largest step (where the tree stamps them)."""
    if bound is None:
        return []
    rows = []
    for job in parts["slowest"]:
        if job["response_ms"] <= bound + 1e-6:
            continue
        best = max(((st, k, st.get(k, 0.0)) for st in job["stages"]
                    for k in RESPONSE_PARTS[1:]), key=lambda b: b[2])
        st, part, ms = best
        steps = st.get("steps") or {}
        if part == "prep":
            # of the steps before the one that enqueues the start event
            names = list(steps)
            cut = next((i for i, k in enumerate(names)
                        if k in ("start", "launch")), len(names))
            steps = {k: steps[k] for k in names[:cut]}
        step = max(steps, key=steps.get) if steps else None
        rows.append({"response_ms": job["response_ms"], "stage": st["stage"],
                     "part": part, "ms": ms, "enqueue_ms": st["enqueue"],
                     "step": step, "step_ms": steps.get(step)})
    return rows


def input_steps(parts: dict) -> dict:
    """The completed HP jobs' ``input`` step (ms; its stage's input made
    or taken on the engine thread): median at stage 0 and at the later
    stages, with their counts."""
    by = {"s0": [], "later": []}
    for job in parts["slowest"]:
        for st in job["stages"]:
            ms = (st.get("steps") or {}).get("input")
            if ms is not None:
                by["s0" if st["stage"] == 0 else "later"].append(ms)
    return {k: {"n": len(v), "median": statistics.median(v) if v else None}
            for k, v in by.items()}


def prep_by_stage(parts: dict) -> dict:
    """The completed HP jobs' ``prep`` (ms; a stage's start to the launch
    that records its start event) by stage index: how many, median and
    max, and how many of them took a call made ready ahead."""
    by = {}
    for job in parts["slowest"]:
        for st in job["stages"]:
            by.setdefault(st["stage"], []).append(st)
    return {f"s{k}": {"n": len(v),
                      "median": statistics.median(s["prep"] for s in v),
                      "max": max(s["prep"] for s in v),
                      "ready": sum(1 for s in v if s.get("ready") is not None)}
            for k, v in sorted(by.items())}


def stage_enqueues(parts: dict) -> dict:
    """The completed HP jobs' stages' ``enqueue`` ms (the stage's start to
    its payload enqueued, in every tree that stamps the parts): how many,
    median, p99 and max, and the median by stage index."""
    by = {}
    for job in parts["slowest"]:
        for st in job["stages"]:
            by.setdefault(st["stage"], []).append(st["enqueue"])
    xs = sorted(x for v in by.values() for x in v)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "median": statistics.median(xs),
            "p99": percentile(xs, 99), "max": xs[-1],
            "median_by_stage": {f"s{k}": statistics.median(v)
                                for k, v in sorted(by.items())}}


def stalls_by_step(stalls) -> dict:
    """Engine-thread stalls by the step that ends them: [count, wall ms,
    CPU ms, longest wall ms, involuntary switches, cgroup throttled
    periods] (the last two summed over the stalls' windows, None in a
    tree that does not read them or where the cgroup is not readable)."""
    if stalls is None:
        return None
    out = {}
    for row in stalls:
        acc = out.setdefault(row["step"], [0, 0.0, 0.0, 0.0, None, None])
        acc[0] += 1
        acc[1] += row["wall_ms"]
        acc[2] += row["cpu_ms"]
        acc[3] = max(acc[3], row["wall_ms"])
        for i, k in ((4, "involuntary"), (5, "nr_throttled")):
            if row.get(k) is not None:
                acc[i] = (acc[i] or 0) + row[k]
    return out


def host_row(host: dict) -> dict:
    """A served run's host readings as ``serve_repeats`` sums them: the
    process's CPU seconds and switches, the engine thread's, the cgroup's
    throttled periods and µs (None where not readable) and the backend's
    polls and end-event queries (None in a tree without them)."""
    eng, cg = host["engine_thread"], host["cgroup"]
    polls = host["poll_counts"]
    return {"process_cpu_s": host["cpu_user_s"] + host["cpu_sys_s"],
            "process_involuntary": host["involuntary_switches"],
            "engine_cpu_s": eng["cpu_s"],
            "engine_voluntary": eng["voluntary_switches"],
            "engine_involuntary": eng["involuntary_switches"],
            **{k: cg and cg[k] for k in CGROUP_COUNTS},
            **{k: polls and polls[k] for k in ("polls", "queries")}}


def run_engines(make_cfg, path, failures, rate_groups=False):
    """``make_cfg()`` (an unbuilt sim config recording its decisions) on
    the heap engine, on ``engine("epoch")`` at its default threshold and
    on ``engine("epoch")`` with the threshold at 1, so that every
    rate-group goes through the f64 contention kernel (the threshold is
    read when the backend is built). Returns each run's events (releases
    and stage completions), wall s, events/s, the garbage collections in
    the run and their host seconds, on the epoch engine the host seconds
    inside its per-group rate pass (``time_rates``) and, with
    ``rate_groups``, its rate-group counts; whether the three runs' decision logs and
    metric digests are identical; the heap run's decision digest; and the
    kernel's launches in the last run (counts reset just before it)."""
    from repro_torch.kernels import KERNELS, reset_counts

    runs, digests, launches = {}, {}, {}
    for label, engine, threshold in ENGINE_RUNS:
        if threshold is not None:
            os.environ["DARIS_EPOCH_KERNEL_MIN"] = threshold
        try:
            srv = make_cfg().engine(engine).build()
        finally:
            os.environ.pop("DARIS_EPOCH_KERNEL_MIN", None)
        core, counts = srv.core, {"releases": 0, "stage_completions": 0}
        advance, release = core.backend.advance, core._handle_release

        def counted_advance(cap_ms, advance=advance, counts=counts):
            out = advance(cap_ms)
            counts["stage_completions"] += len(out)
            return out

        def counted_release(*a, release=release, counts=counts, **kw):
            counts["releases"] += 1
            return release(*a, **kw)
        core.backend.advance = counted_advance
        core._handle_release = counted_release
        groups = count_rate_groups(srv) if rate_groups else None
        rates = time_rates(srv) if engine == "epoch" else None
        reset_counts()
        with GcTime() as gc_time:
            t0 = time.perf_counter()
            m = srv.run()
            wall = time.perf_counter() - t0
        if threshold is not None:
            launches = path_counts(KERNELS, EPOCH_PATH, path, failures)
        resp = json.dumps({str(k): [v.hex() for v in vs]
                           for k, vs in sorted(m.response_ms.items())})
        digests[label] = {
            "decisions_sha256": hashlib.sha256(
                "\n".join(srv.decisions).encode()).hexdigest(),
            "response_sha256": hashlib.sha256(resp.encode()).hexdigest(),
            "summary": m.summary()}
        events = counts["releases"] + counts["stage_completions"]
        runs[label] = {"wall_s": wall, "events": events,
                       "events_per_s": events / wall,
                       "decisions": len(srv.decisions),
                       "completed": dict(m.completed),
                       "missed": dict(m.missed),
                       "gc": {"collections": gc_time.collections,
                              "s": gc_time.s}}
        if groups is not None:
            runs[label]["rate_groups"] = groups
        if rates is not None:
            runs[label]["rates_for"] = {
                **rates, "us_per_call": rates["s"] / max(rates["calls"], 1)
                * 1e6}
    same = all(d == digests["heap"] for d in digests.values())
    if not same:
        failures.append(f"{path}: the three runs' decision logs or metric "
                        f"digests differ")
    return runs, same, digests["heap"]["decisions_sha256"], launches


def epoch_phase(torch, failures):
    """The scenario on the heap engine, on the epoch engine at its default
    threshold, and on the epoch engine with every rate-group on the f64
    kernel; returns the kernel's launches in the last run."""
    from repro_torch import api

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    runs, same, decisions, launches = run_engines(
        lambda: epoch_scenario(api, sm), "epoch", failures)
    emit({"epoch": {"scenario": "4 contexts x 6 streams, 12 tasks, chaos "
                                "with a brownout, one device",
                    "horizon_ms": EPOCH_HORIZON_MS, "runs": runs,
                    "digests_identical": same,
                    "decisions_sha256": decisions,
                    "launches": launches}})
    return launches


# the cluster phase (step 8): benchmarks/perf_engine.py's
# fleet_64dev_diurnal and cluster_rn18_4gpu, benchmarks/figure_specs.py's
# fig13 cells; their builders are written here because benchmarks/
# imports the JAX package
FLEET_DEVICES, FLEET_PER_DEVICE = 64, 3
FLEET_HORIZON_MS = 1500.0             # the default run; --cluster: 4000
FLEET_HORIZON_LONG_MS = 4000.0
FIG13_HORIZON_MS = 2000.0


def diurnal_trace(rng, base_per_ms: float, horizon_ms: float) -> list:
    """Arrival times (ms) of an inhomogeneous Poisson process whose rate
    swings sinusoidally over one cycle of the horizon (peak 1.8x base),
    drawn by thinning against the peak rate."""
    peak = base_per_ms * 1.8
    times, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= horizon_ms:
            return times
        lam = base_per_ms * (1.0 + 0.8 * math.sin(
            2.0 * math.pi * t / horizon_ms))
        if float(rng.uniform()) * peak < lam:
            times.append(t)


def fleet_scenario(horizon_ms: float):
    """64 devices x 4 contexts x 1 stream (oversubscription 4.0), 3 LP
    services a device (192), each two stages of 2 ms (n_sat 20, mem_frac
    0.3) at a 24 ms period, replaying a diurnal Poisson trace (base 1/24
    a ms; one rng seeded 9000 + i a service)."""
    import numpy as np

    from repro_torch import api
    from repro_torch.serving.profiles import device

    specs = [api.TaskSpec(
        name=f"svc{i:03d}", period_ms=24.0, priority=api.LP,
        stages=[api.StageProfile(name=f"svc{i:03d}/s{j}", t_alone_ms=2.0,
                                 n_sat=20.0, mem_frac=0.3) for j in (0, 1)])
        for i in range(FLEET_DEVICES * FLEET_PER_DEVICE)]
    cfg = (api.ServerConfig.cluster(FLEET_DEVICES).tasks(specs)
           .contexts(4).streams(1).oversubscribe(4.0).device(device())
           .horizon_ms(horizon_ms).seed(0).record_decisions())
    for i, s in enumerate(specs):
        cfg.arrival(s.name, api.TraceArrival(diurnal_trace(
            np.random.default_rng(9000 + i), 1.0 / 24.0, horizon_ms)))
    return cfg


def cluster_rn18_scenario(horizon_ms: float):
    """Table II's ResNet18 task set on 4 GPUs (two a100, two v100), 4 x 1
    each, oversubscription 4.0."""
    from repro_torch import api
    from repro_torch.serving.profiles import device
    from repro_torch.serving.requests import table2_taskset

    return (api.ServerConfig.cluster(
                4, device_models=["a100", "a100", "v100", "v100"])
            .tasks(table2_taskset("resnet18")).contexts(4).streams(1)
            .oversubscribe(4.0).device(device()).horizon_ms(horizon_ms)
            .seed(0).record_decisions())


def _fig13(n_gpus, specs_per_gpu, nc):
    import dataclasses

    from repro_torch import api
    from repro_torch.serving.profiles import device

    specs = [dataclasses.replace(s, name=f"g{g}-{s.name}")
             for g in range(n_gpus) for s in specs_per_gpu()]
    return (api.ServerConfig.cluster(n_gpus).tasks(specs)
            .contexts(nc).streams(1).oversubscribe(float(nc))
            .device(device()).horizon_ms(FIG13_HORIZON_MS).seed(0))


def fig13_light():
    """An under-loaded 2-GPU fleet: an HP and an LP ResNet18 task at 30
    jobs/s a device, 2 x 1, oversubscription 2.0."""
    from repro_torch.serving.profiles import make_task
    return _fig13(2, lambda: [make_task("resnet18", priority=p, jps=30.0,
                                        tag=tag)
                              for p, tag in ((0, "-hp0"), (1, "-lp0"))], 2)


def fig13_fail_1of4():
    """4 GPUs, Table II ResNet18 at half load on each, 4 x 1 (os 4.0);
    device 1 fails at 30% of the horizon."""
    from repro_torch.serving.requests import table2_taskset
    return _fig13(4, lambda: table2_taskset("resnet18", load_scale=0.5),
                  4).fail_device_at(1, FIG13_HORIZON_MS * 0.3)


def cluster_phase(torch, failures, fleet_horizon_ms=FLEET_HORIZON_MS):
    """Each cluster scenario on the three engines (``run_engines``; the
    fleet with its rate-group counts), then SchedCheck's differential
    oracle on fig13_light and fig13_fail_1of4 on the epoch engine with
    every rate-group on the kernel. Returns the kernel's launches on each
    path (counts reset just before each)."""
    from repro_torch.analysis.schedcheck import differential_check
    from repro_torch.kernels import KERNELS, reset_counts

    launches = {}
    for name, make_cfg, horizon in (
            ("fleet_64dev_diurnal",
             lambda: fleet_scenario(fleet_horizon_ms), fleet_horizon_ms),
            ("cluster_rn18_4gpu",
             lambda: cluster_rn18_scenario(fleet_horizon_ms),
             fleet_horizon_ms),
            ("fig13_fail_1of4", lambda: fig13_fail_1of4().record_decisions(),
             FIG13_HORIZON_MS)):
        fleet = name.startswith("fleet")
        runs, same, decisions, n = run_engines(make_cfg, name, failures,
                                               rate_groups=fleet)
        launches[name] = n
        emit({"cluster": {"scenario": name, "horizon_ms": horizon,
                          "runs": runs, "digests_identical": same,
                          "decisions_sha256": decisions, "launches": n,
                          "card": gpu_line()}})
    for name, make_cfg in (("fig13_light", fig13_light),
                           ("fig13_fail_1of4", fig13_fail_1of4)):
        reset_counts()
        os.environ["DARIS_EPOCH_KERNEL_MIN"] = "1"
        try:
            t0 = time.perf_counter()
            res = differential_check(make_cfg().engine("epoch"), label=name)
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("DARIS_EPOCH_KERNEL_MIN", None)
        n = path_counts(KERNELS, EPOCH_PATH, f"{name} oracle", failures)
        launches[f"{name}_oracle"] = n
        emit({"schedcheck_oracle": {
            "scenario": name, "ok": res.ok, "verdict": res.verdict,
            "hp_verdict": res.hp_verdict, "hp_bound_ms": finite(res.bound_ms),
            "observed_hp_max_ms": res.observed_max_ms,
            "dmr_hp": res.dmr_hp, "vacuous": res.vacuous,
            "violations": res.violations, "wall_s": wall, "launches": n}})
        if not res.ok:
            failures.append(f"SchedCheck oracle on {name}: {res.violations}")
    return launches


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile of ``xs``, interpolated as numpy's."""
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def finite(x: float):
    """``x``, or None where it is infinite (an unbounded static bound)."""
    return x if math.isfinite(x) else None


def per_step_launches(torch, spec):
    """Kernel launches of one decode step (the 4 stage payloads in turn)."""
    from repro_torch.kernels import KERNELS, reset_counts
    reset_counts()
    state = None
    for st in spec.stages:
        state = st.payload(state)
    torch.cuda.synchronize()
    return state, {n: fn.counts.launches for n, fn in KERNELS.items()}


# the port's kernels as the profiler names them (launches, device us and
# share of the step's device busy time in the decode_step_profile line)
PORT_KERNEL_NAMES = ("rmsnorm_kernel", "decode_split", "decode_combine",
                     "flash_", "ssd_")


def profiled(torch, fn, reps: int):
    """``reps`` calls of ``fn`` under torch.profiler (CPU and CUDA): the
    host wall ms of all of them, ended by a synchronize, and the CUDA
    kernels they ran."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(kern) -> float:
    """Device busy µs: the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def by_kernel(kern) -> dict:
    """Launches and device µs of each kernel name."""
    out = {}
    for e in kern:
        n, t = out.get(e.name, (0, 0.0))
        out[e.name] = (n + 1, t + e.time_range.elapsed_us())
    return out


def staged_step(spec):
    """One decode step of a staged task: its payloads in turn."""
    def step():
        state = None
        for st in spec.stages:
            state = st.payload(state)
    return step


def profile_step(torch, step, reps: int = 3):
    """Where one decode step's time goes: ``reps`` calls of ``step`` (one
    stream) under torch.profiler; device busy time is the union of the
    CUDA kernels' intervals, against the host wall time."""
    try:
        wall_ms, kern = profiled(torch, step, reps)
        busy = busy_us(kern)
        names = by_kernel(kern)
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:10]
        ours = {}
        for n, (c, t) in names.items():
            key = next((k for k in PORT_KERNEL_NAMES if k in n), None)
            if key is not None:
                c0, t0 = ours.get(key, (0, 0.0))
                ours[key] = (c0 + c, t0 + t)
        return {"steps": reps, "wall_ms_per_step": wall_ms / reps,
                "device_busy_ms_per_step": busy / 1e3 / reps,
                "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
                "kernels_per_step": len(kern) / reps,
                "top_kernels_us_per_step": {
                    n[:60]: [c / reps, t / reps] for n, (c, t) in top},
                "port_kernels_us_per_step": {
                    k: [c / reps, t / reps, t / busy]
                    for k, (c, t) in sorted(ours.items())}}
    except Exception as e:   # noqa: BLE001 — a measurement, not a check
        return {"error": repr(e)}


def card_vs_cpu(torch, small, seed: int = 1, steps: int = 1, extra=None):
    """The cut-depth f32 copy ``small`` from the same parameters (drawn on
    the card from ``seed``): a prefill of 2 x 64 seeded tokens (whisper:
    over 2 seeded frame sequences) and ``steps`` decode steps on the card
    through the kernels and on the CPU through the plain versions.
    ``extra(model, params, device, prefill_cache)`` adds named outputs
    (a staged chain, a forward over embeddings). Returns ((prefill logits,
    first decode logits, prefill cache, {name: the other outputs}) on the
    card, the same on the CPU) and the card's launches by instance."""
    import numpy as np

    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import build_model

    gm, cm = build_model(small), build_model(small, device="cpu")
    gp = gm.init_params(seed)
    cp = tree_map(lambda t: t.cpu(), gp)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, small.vocab_size, (2, 64 + steps))
    frames = (rng.standard_normal((2, small.encoder_frames, small.d_model))
              .astype(np.float32) if small.family == "encdec" else None)
    outs = []
    reset_counts()
    for mdl, p, dev in ((gm, gp, "cuda"), (cm, cp, "cpu")):
        tk = torch.from_numpy(toks).to(dev)
        batch = {"tokens": tk[:, :64], "cache": mdl.init_cache(2, 64 + steps)}
        step = {}
        if frames is not None:
            batch["frames"] = torch.from_numpy(frames).to(dev)
            step["enc_out"] = mdl.encode(p, batch["frames"])
        pl, cache = mdl.prefill(p, batch)
        more, c = {}, cache
        for i in range(steps):
            dl, c = mdl.decode_step(p, {"tokens": tk[:, 64 + i:65 + i],
                                        "cache": c, **step})
            more[f"decode_{i}"] = dl.cpu()
        if "enc_out" in step:
            more["enc_out"] = step["enc_out"].cpu()
        if extra is not None:
            more.update({k: v.cpu() for k, v in
                         extra(mdl, p, dev, cache).items()})
        outs.append((pl.cpu(), more.pop("decode_0"),
                     tree_map(lambda t: t.cpu(), cache), more))
    torch.cuda.synchronize()
    instances = {n: dict(fn.counts.by_instance) for n, fn in KERNELS.items()
                 if fn.counts.by_instance}
    return outs, instances


def logits_err(torch, outs, tol: float):
    """Largest |card - CPU| over the prefill and decode logits (and the
    other named outputs), and whether every element is within ``tol``
    (relative and absolute)."""
    (gp, gd, _, gm), (cp, cd, _, cm) = outs
    pairs = [(gp, cp), (gd, cd)] + [(gm[k], cm[k]) for k in gm]
    err = max(float((a - b).abs().max()) for a, b in pairs)
    return err, all(torch.allclose(a, b, rtol=tol, atol=tol)
                    for a, b in pairs)


def output_checks(torch, model, params, spec, failures, unstaged=None,
                  small=None, extra=None, note=None):
    """A served task's payload chain against the unstaged decode from the
    same donor (``unstaged(params, tokens, donor)`` -> logits; default
    ``decode_step``; ``note`` says what ``unstaged`` reproduces), and the
    cut-depth f32 copy ``small`` (default: 2 layers, f32 KV cache) on the
    card against the CPU (``extra`` as in ``card_vs_cpu``); the decode
    step's profile (``decode_step_profile``, with the peak memory) comes
    before that copy is built."""
    import numpy as np

    state, step = per_step_launches(torch, spec)
    logits = state["hidden"]
    cfg = model.cfg
    shape_ok = tuple(logits.shape) == (B, 1, cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    # the same step unstaged, from the same donor (same tokens, seed 0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT))).cuda()
    _, donor = model.prefill(params, {
        "tokens": tokens, "cache": model.init_cache(B, PROMPT + 1)})
    zeros = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    if unstaged is None:
        ref, _ = model.decode_step(params, {"tokens": zeros, "cache": donor})
    else:
        ref = unstaged(params, zeros, donor)
    staged_err = float((logits.float() - ref.float()).abs().max())
    staged_ok = torch.allclose(logits.float(), ref.float(), rtol=3e-2,
                               atol=3e-2)
    del donor
    profile = {"model": cfg.name, **profile_step(torch, staged_step(spec)),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    # cut-depth f32 model: kernels on the card vs plain versions on the CPU
    if small is None:
        small = cfg.replace(n_layers=2, dtype="float32",
                            kv_cache_dtype="float32")
    outs, f32_instances = card_vs_cpu(torch, small, extra=extra)
    f32_check(torch, failures, cfg.name, small, outs, f32_instances, {
        "logits_shape": [B, 1, cfg.vocab_size] if shape_ok else None,
        "finite": finite,
        "staged_vs_unstaged_max_err": staged_err, "staged_tol": 3e-2,
        **({"staged_vs_unstaged": note} if note else {}),
        "launches_per_decode_step": step})
    emit({"decode_step_profile": profile})
    if not (shape_ok and finite):
        failures.append(f"{cfg.name} served logits: shape not "
                        f"(B, 1, vocab) or not finite ({finite})")
    if not staged_ok:
        failures.append(f"{cfg.name} staged vs unstaged decode: max_err "
                        f"{staged_err}")
    return f32_instances


def run_model(torch, model, params, tokens, steps: int, spare: int = 0):
    """``prefill`` of ``tokens`` [B, S] into a fresh cache of S + ``steps``
    (+ ``spare``) slots, then ``steps`` ``decode_step``s, each on a seeded
    token a row;
    returns the prefill logits, each step's logits, the final cache and
    the host seconds of the prefill and of each step (ended by a
    synchronize)."""
    import numpy as np

    b, s = tokens.shape
    nxt = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (b, steps))).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl, cache = model.prefill(
        params, {"tokens": tokens,
                 "cache": model.init_cache(b, s + steps + spare)})
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    dls = []
    for i in range(steps):
        t0 = time.perf_counter()
        dl, cache = model.decode_step(params, {"tokens": nxt[:, i:i + 1],
                                               "cache": cache})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dls.append(dl)
    return pl, dls, cache, times


def model_phase(torch, failures, cfg, kernels, spare: int = 0, before=None):
    """``cfg`` built with ``build_model`` on the card (random weights from
    seed 0), a prefill of ``PROMPT`` seeded tokens at batch ``B`` and
    ``DECODE_STEPS`` decode steps (``run_model``, with ``spare`` more
    slots in the cache); checks finite logits of
    the expected shapes and that each of ``kernels`` launched, no plain
    version on the card. ``before(model, params)``, where given, runs
    first on the same counts and returns what the ``model_run`` line adds
    (pixtral's forward over image embeddings). Returns the model, its
    parameters, the run, the path's launches and its launches by
    instance; emits a ``model_run`` line and the profile of one more
    decode step."""
    import numpy as np

    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init_params(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT))).cuda()
    reset_counts()
    first = {} if before is None else before(model, params)
    run = run_model(torch, model, params, tokens, DECODE_STEPS, spare)
    launches = path_counts(KERNELS, kernels, cfg.name, failures)
    instances = {n: dict(KERNELS[n].counts.by_instance) for n in kernels
                 if KERNELS[n].counts.by_instance}
    pl, dls, cache, times = run
    ok = (tuple(pl.shape) == (B, PROMPT, cfg.vocab_size)
          and all(tuple(d.shape) == (B, 1, cfg.vocab_size) for d in dls)
          and all(bool(torch.isfinite(t).all()) for t in (pl, *dls)))
    n_params = sum(t.numel() for t in tree_leaves(params))
    emit({"model_run": {
        "model": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "batch": B, "prompt_len": PROMPT,
        "decode_steps": DECODE_STEPS, "dtype": cfg.dtype,
        "kv_cache_dtype": cfg.kv_cache_dtype, "params": n_params,
        "param_gb": sum(t.numel() * t.element_size()
                        for t in tree_leaves(params)) / 1e9,
        "init_s": init_s, "prefill_s": times[0], "decode_step_s": times[1:],
        "logits_ok": ok, "launches": launches,
        "launches_by_instance": instances, **first,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}})
    if not ok:
        failures.append(f"{cfg.name}: logits not finite or of another shape")
    # one more decode step from the final cache, repeated under the profiler
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    emit({"decode_step_profile": {"model": cfg.name, **profile_step(
        torch, lambda: model.decode_step(params, {"tokens": tok,
                                                  "cache": cache}))}})
    return model, params, run, launches, instances


def moe_phase(torch, failures):
    """Step 9, this slice's main path: full-width, full-depth
    qwen2-moe-a2.7b served as the LMs of steps 3 and 5 (its stages on the
    dense expert oracle, as the reference stages them), at ``MOE_JPS``
    unless the HP stage sum exceeds ``MOE_MAX_LOAD`` of the period. The
    chain is held to the unstaged ``forward(..., moe_oracle=True)``
    decode (``decode_step`` takes the capacity path at 60 experts, which
    drops pairs at N = 4 as the reference does)."""
    from repro_torch.models import transformer

    model, params, spec, launches, inst = serving_phase(
        torch, failures, MOE_ARCH, None, MOE_JPS, MOE_PATH,
        max_load=MOE_MAX_LOAD)
    fa_inst = inst.get("flash_attention", {})
    if fa_inst.get("tensor_core", 0) != launches["flash_attention"]:
        failures.append(f"{MOE_ARCH}: bf16 flash-attention launches by "
                        f"instance {fa_inst}, not all tensor_core")
    cfg = model.cfg

    def oracle(p, tok, donor):
        return transformer.forward(p, cfg, tok, cache=donor,
                                   moe_oracle=True)[0]
    output_checks(torch, model, params, spec, failures, unstaged=oracle)
    return launches, inst


def hybrid_phase(torch, failures):
    """Step 10: full-width, full-depth zamba2-7b (81 Mamba2 layers, 13
    applications of the shared block over 7168 at Dh 112), prefill and
    decode (``model_phase``). Every SSD launch must take the tensor cores;
    the flash launches at Dh 112 take the CUDA-core instance, recorded.
    A 2-layer f32 copy (``attn_every`` 2: one application) on the card
    against the CPU, within 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan

    cfg = get_config(HYBRID_ARCH)
    model, params, _, launches, inst = model_phase(torch, failures, cfg,
                                                   HYBRID_PATH)
    ssd_inst = inst.get("ssd", {})
    state_pass, outputs = (ssd_inst.get(k, 0)
                           for k in ssd_scan.INSTANCE_KERNELS["tensor_core"])
    if state_pass + outputs != launches["ssd"] or state_pass != outputs:
        failures.append(f"{cfg.name}: bf16 SSD launches by kernel "
                        f"{ssd_inst}, not all tensor_core")
    del model, params
    torch.cuda.empty_cache()
    small = cfg.replace(n_layers=2, attn_every=2, dtype="float32",
                        kv_cache_dtype="float32")
    outs, small_inst = card_vs_cpu(torch, small)
    err, ok = logits_err(torch, outs, 2e-3)
    emit({"output_check": {
        "model": cfg.name,
        "small_model": {"layers": 2, "attn_every": 2, "dtype": "float32"},
        "small_f32_gpu_vs_cpu_max_err": err, "small_tol": 2e-3,
        "small_f32_launches_by_instance": small_inst}})
    if not ok:
        failures.append(f"{cfg.name} cut-depth f32 GPU vs CPU: max_err {err}")
    return launches, inst


def cache_bytes(cache) -> int:
    """Bytes of a stacked KV cache's k/v (and scales), not its positions."""
    return sum(t.numel() * t.element_size() for k, t in cache.items()
               if k not in ("length", "slots_pos"))


def int8_layer0(torch, cache, ref, slots: int):
    """The int8 ``cache``'s layer 0 over its first ``slots`` slots against
    the bf16 cache ``ref`` of the same run: (largest |codes * scale - x| in
    code steps of max|x| / 127, the largest relative error of a stored
    scale), with x the bf16 value and the dequantization written out here,
    not the port's. Layer 0's k/v come from the embedded tokens alone, so
    both caches quantize or store the same values."""
    steps, srel = 0.0, 0.0
    for name in ("k", "v"):
        x = ref[name][0, :, :slots].float()
        want = (x.abs().amax(-1) / 127.0).clamp(min=1e-8)
        got = cache[f"{name}_scale"][0, :, :slots]
        deq = cache[name][0, :, :slots].float() * got[..., None]
        steps = max(steps, float(((deq - x).abs() / want[..., None]).max()))
        srel = max(srel, float(((got - want).abs() / want).max()))
    return steps, srel


def int8_faults(torch, cache, newest: int) -> dict:
    """Two planted faults on copies of an int8 cache: the newest slot's
    scales left unwritten (0) in every layer, and every code one step up
    (clamped at 127)."""
    unwritten = dict(cache)
    for name in ("k_scale", "v_scale"):
        unwritten[name] = cache[name].clone()
        unwritten[name][:, :, newest] = 0.0
    shifted = dict(cache)
    for name in ("k", "v"):
        shifted[name] = (cache[name].int() + 1).clamp(max=127).to(torch.int8)
    return {"newest_scales_unwritten": unwritten, "codes_one_up": shifted}


def int8_phase(torch, failures):
    """Step 11: qwen1.5-32b at full width with its int8 KV cache, depth cut
    to ``INT8_LAYERS``; prefill and decode (``model_phase``). The same
    weights and tokens with a bf16 cache: the cache's bytes against it
    (codes and f32 scales: (1 + 4/128) / 2 of it at Dh 128); layer 0's
    codes within half a code step of the bf16 cache's values at every
    written slot, its scales max|x| / 127 (``int8_layer0``); the decode
    logits within ``INT8_TOL`` of the bf16-cache logits' largest
    magnitude, each row's int8 top-1 token scored by the bf16 run within
    that tolerance of its best. One more decode step (the probe) from the
    cache and from two faulty copies of it (``int8_faults``): the layer-0
    check must flag both, and the probe's logits must lie within
    ``INT8_TOL`` of the bf16 cache's from the sound cache and past it
    from each fault. A 2-layer f32 copy with the int8 cache on the card
    against the CPU: logits within ``INT8_SMALL_TOL``, the dequantized
    caches at most one code step apart."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.attention import read_kv_cache

    cfg = get_config(INT8_ARCH).replace(n_layers=INT8_LAYERS)
    # one spare slot a cache, for the probe step
    model, params, run, launches, inst = model_phase(torch, failures, cfg,
                                                     INT8_PATH, spare=1)
    bf = build_model(cfg.replace(kv_cache_dtype="bfloat16"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT))).cuda()        # model_phase's
    _, bf_dls, bf_cache, _ = run_model(torch, bf, params, tokens,
                                       DECODE_STEPS, spare=1)
    ratio = cache_bytes(run[2]) / cache_bytes(bf_cache)
    want_ratio = (1 + 4 / cfg.resolved_head_dim) / 2
    a = torch.cat([d.float() for d in run[1]], 1)          # int8 cache
    b = torch.cat([d.float() for d in bf_dls], 1)          # bf16 cache
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    best = b.max(-1).values
    chosen = b.gather(-1, a.argmax(-1, keepdim=True))[..., 0]
    top1_within = bool((best - chosen <= INT8_TOL * scale).all())
    top1_same = int((a.argmax(-1) == b.argmax(-1)).sum())
    # the layer-0 check and the probe step, on the cache and its faults
    slots = PROMPT + DECODE_STEPS                 # written before the probe
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    want, _ = bf.decode_step(params, {"tokens": tok, "cache": bf_cache})
    want = want.float()
    probe_scale = float(want.abs().max())
    caches = {"sound": run[2], **int8_faults(torch, run[2], slots - 1)}
    probe = {}
    for key, c in caches.items():
        steps, srel = int8_layer0(torch, c, bf_cache, slots)
        got, _ = model.decode_step(params, {"tokens": tok, "cache": c})
        probe[key] = {"layer0_code_steps": steps, "layer0_scale_rel": srel,
                      "probe_err_vs_bf16_cache": float(
                          (got.float() - want).abs().max()),
                      "flagged": (steps > INT8_HALF_STEP
                                  or srel > INT8_SCALE_RTOL)}
    del model, bf, params, run, bf_cache, caches
    torch.cuda.empty_cache()
    small = cfg.replace(n_layers=2, dtype="float32")
    outs, small_inst = card_vs_cpu(torch, small)
    small_err, small_ok = logits_err(torch, outs, INT8_SMALL_TOL)
    # card against CPU: codes one apart where the f32 projections round
    # differently; dequantized, at most one code step (the scale) apart
    gc, cc = outs[0][2], outs[1][2]
    codes_apart = sum(int((gc[n].int() != cc[n].int()).sum())
                      for n in ("k", "v"))
    code_steps = 0.0
    for i in range(small.n_layers):
        gkv = read_kv_cache(tree_map(lambda t: t[i], gc), torch.float32)
        ckv = read_kv_cache(tree_map(lambda t: t[i], cc), torch.float32)
        for j, name in enumerate(("k", "v")):
            step = torch.maximum(gc[f"{name}_scale"][i],
                                 cc[f"{name}_scale"][i]).clamp(min=1e-30)
            code_steps = max(code_steps, float(
                ((gkv[j] - ckv[j]).abs() / step[..., None]).max()))
    emit({"int8_check": {
        "model": cfg.name, "layers": cfg.n_layers,
        "cache_bytes_vs_bf16": ratio, "expected_ratio": want_ratio,
        "decode_max_err_vs_bf16_cache": err, "bf16_logits_max_abs": scale,
        "tol": INT8_TOL * scale, "rows": int(a.shape[0] * a.shape[1]),
        "top1_same": top1_same, "top1_within_tol": top1_within,
        "layer0_half_step": INT8_HALF_STEP,
        "layer0_scale_rtol": INT8_SCALE_RTOL,
        "probe_bf16_logits_max_abs": probe_scale,
        "probe_tol": INT8_TOL * probe_scale, "probe": probe,
        "small_f32_gpu_vs_cpu_max_err": small_err,
        "small_tol": INT8_SMALL_TOL,
        "small_codes_apart": codes_apart,
        "small_dequant_max_err_in_code_steps": code_steps,
        "small_f32_launches_by_instance": small_inst}})
    if abs(ratio - want_ratio) > 1e-9:
        failures.append(f"{cfg.name}: int8 cache {ratio} of the bf16 "
                        f"cache's bytes, not {want_ratio}")
    if err > INT8_TOL * scale or not top1_within:
        failures.append(f"{cfg.name}: int8-cache decode max_err {err} "
                        f"(tol {INT8_TOL * scale}), top-1 within tol "
                        f"{top1_within}")
    sound = probe.pop("sound")
    if sound["flagged"]:
        failures.append(f"{cfg.name}: int8 cache's layer 0 off the bf16 "
                        f"cache's values: {sound}")
    if sound["probe_err_vs_bf16_cache"] > INT8_TOL * probe_scale:
        failures.append(f"{cfg.name}: int8-cache probe step max_err "
                        f"{sound['probe_err_vs_bf16_cache']} (tol "
                        f"{INT8_TOL * probe_scale})")
    for key, got in probe.items():
        if not got["flagged"]:
            failures.append(f"{cfg.name}: the layer-0 check missed the "
                            f"planted fault {key}: {got}")
        if got["probe_err_vs_bf16_cache"] <= INT8_TOL * probe_scale:
            failures.append(f"{cfg.name}: the logits' tolerance "
                            f"{INT8_TOL * probe_scale} missed the planted "
                            f"fault {key}: {got}")
    if not small_ok:
        failures.append(f"{cfg.name} cut-depth f32 int8 GPU vs CPU: "
                        f"max_err {small_err}")
    if code_steps > 1.0 + 1e-3:
        failures.append(f"{cfg.name} cut-depth int8 caches: dequantized "
                        f"values {code_steps} code steps apart")
    return launches, inst


def host_ram_allows(nbytes_needed: float) -> bool:
    """Whether ``nbytes_needed`` fit in ``HOST_RAM_SHARE`` of the host's
    available memory (``/proc/meminfo``)."""
    try:
        with open("/proc/meminfo") as f:
            avail = next(int(ln.split()[1]) * 1024 for ln in f
                         if ln.startswith("MemAvailable:"))
    except (OSError, StopIteration):
        return False
    return nbytes_needed <= HOST_RAM_SHARE * avail


def cut_f32_bytes(params) -> int:
    """Bytes in f32 of the served moe model cut to its leading dense
    layers and its first MoE layer, from the served parameters' leaves."""
    from repro_torch.models import transformer

    cut = {**params, "layers": transformer.index_tree(params["layers"], 0)}
    return 4 * sum(t.numel() for t in tree_leaves(cut))


def staged_chain(torch, n_stages: int = N_STAGES):
    """``card_vs_cpu``'s extra: the staged decode chain of one zero token a
    row from the prefill's cache, at the position after the prompt."""
    from repro_torch.serving.staging import make_lm_stage_fns, slice_cache

    def run(mdl, p, dev, donor):
        fns = make_lm_stage_fns(mdl, n_stages=n_stages)
        h = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        pos = torch.tensor([64], dtype=torch.int32, device=dev)
        for i, fn in enumerate(fns):
            h, _ = fn(p, h, slice_cache(mdl.cfg, donor, i, n_stages), pos)
        return {"staged_chain": h}
    return run


def instance_share(inst: dict, kernel: str, want: str, launches: dict):
    """Whether every launch of ``kernel`` on a path took instance
    ``want``."""
    return inst.get(kernel, {}).get(want, 0) == launches[kernel]


def mla_phase(torch, failures):
    """Step 12, this slice's main path: deepseek-v2-236b at full width
    (MLA with q_lora 1536, kv_lora 512, rope 64 / nope 128 / v 128 at 128
    heads; 160 routed experts top-6 of 1536 and 2 shared; dense d_ff
    12288; vocab 102,400), depth cut to its dense layer and 4 MoE layers,
    served staged as the LMs of steps 3 and 9 (the stages on the dense
    expert oracle, the donor prefill on the capacity path). The donor
    prefill's flash launches run at Dh 192 with H = KV = 128, which the
    CUDA-core instance takes. R4 (ROADMAP.md §3): the stages never run the
    dense layer and the last holds no layer, so the chain is held to the
    unstaged decode that does the same (the MoE layers on the oracle over
    the donor's cache, the dense layer skipped); a cut-depth f32 copy (the
    dense layer and one MoE layer; its routed experts cut to 16 where the
    host's memory would not hold the copy) gives the same staged chain
    and the same unstaged prefill and decode logits on the card as on the
    CPU."""
    from repro_torch.models import transformer

    model, params, spec, launches, inst = serving_phase(
        torch, failures, MLA_ARCH, MLA_LAYERS, FAMILY_JPS, MLA_PATH,
        max_load=MOE_MAX_LOAD)
    if not instance_share(inst, "flash_attention", "cuda_core", launches):
        failures.append(f"{MLA_ARCH}: flash launches by instance "
                        f"{inst.get('flash_attention')}, not all cuda_core "
                        f"(Dh 192)")
    cfg = model.cfg

    def r4(p, tok, donor):
        pos = transformer.cache_length(cfg, donor)[None]
        x, _, _ = transformer.run_layers(p["layers"], transformer.embed(
            p, cfg, tok), cfg, pos, donor["layers"], moe_oracle=True)
        return transformer.logits(p, cfg, x)

    small = cfg.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32")
    if not host_ram_allows(2 * cut_f32_bytes(params)):
        small = small.replace(n_experts=16)
    output_checks(torch, model, params, spec, failures, unstaged=r4,
                  small=small, extra=staged_chain(torch),
                  note="R4: the MoE layers unstaged on the oracle, the "
                       "dense layer skipped")
    return launches, inst


def gemma2_phase(torch, failures):
    """Step 13: gemma2-27b at full width (d 4608, 32 / 16 heads at Dh 128,
    d_ff 36,864, vocab 256,000 tied, window 4096, softcaps 50 / 30),
    depth cut to 24 of 46 layers (12 local/global pairs, 3 a stage),
    served staged as in step 12. Every flash launch must take the tensor
    cores; the chain is held to the unstaged decode (no R4); one pair in
    f32 on the card against the CPU, its chain too."""
    model, params, spec, launches, inst = serving_phase(
        torch, failures, GEMMA_ARCH, GEMMA_LAYERS, FAMILY_JPS, GEMMA2_PATH,
        max_load=MOE_MAX_LOAD)
    if not instance_share(inst, "flash_attention", "tensor_core", launches):
        failures.append(f"{GEMMA_ARCH}: flash launches by instance "
                        f"{inst.get('flash_attention')}, not all "
                        f"tensor_core")
    output_checks(torch, model, params, spec, failures,
                  extra=staged_chain(torch))
    return launches, inst


def vlm_phase(torch, failures):
    """Step 14: pixtral-12b at full width and depth (40 layers, d 5120, 32
    / 8 heads at Dh 128): the no-cache ``forward`` over image embeddings
    [2, 1024, 5120] drawn from a seed before 512 token embeddings, then a
    prefill of 512 tokens at batch 4 and 4 decode steps
    (``model_phase``). Finite logits of the expected shapes; every flash
    launch on the tensor cores; 2 layers in f32 on the card against the
    CPU, with a forward over 16 image embeddings."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(VLM_ARCH)
    n_img = cfg.n_image_tokens

    def embeds_forward(model, params, n=n_img, batch=VLM_BATCH, seed=3):
        dev = params["embed"].device
        rng = np.random.default_rng(seed)
        img = torch.from_numpy(rng.standard_normal(
            (batch, n, model.cfg.d_model)).astype(np.float32) * 0.02)
        tok = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (batch, VLM_SEQ - n_img)))
        emb = torch.cat([img.to(dev, params["embed"].dtype),
                         params["embed"][tok.to(dev)]], dim=1)
        return transformer.forward(params, model.cfg, embeds=emb)[0]

    def first(model, params):
        t0 = time.perf_counter()
        logits = embeds_forward(model, params)
        torch.cuda.synchronize()
        want = (VLM_BATCH, VLM_SEQ, cfg.vocab_size)
        ok = (tuple(logits.shape) == want
              and bool(torch.isfinite(logits).all()))
        if not ok:
            failures.append(f"{cfg.name}: forward over image embeddings "
                            f"gave {tuple(logits.shape)}, not {want}, or "
                            f"not finite")
        return {"embeds_forward": {"image_tokens": n_img,
                                   "batch": VLM_BATCH, "seq": VLM_SEQ,
                                   "s": time.perf_counter() - t0,
                                   "logits_ok": ok}}

    model, params, _, launches, inst = model_phase(torch, failures, cfg,
                                                   VLM_PATH, before=first)
    if not instance_share(inst, "flash_attention", "tensor_core", launches):
        failures.append(f"{cfg.name}: flash launches by instance "
                        f"{inst.get('flash_attention')}, not all "
                        f"tensor_core")
    del model, params
    free_card(torch)
    small = cfg.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32")
    outs, small_inst = card_vs_cpu(torch, small, extra=lambda m, p, dev, _: {
        "embeds_forward": embeds_forward(m, p, n=16, seed=4)})
    f32_check(torch, failures, cfg.name, small, outs, small_inst)
    return launches, inst


def f32_check(torch, failures, name, small, outs, inst,
              more=None) -> None:
    """Emit the card-against-CPU line of a cut f32 copy (after the fields
    ``more``); fail past ``SMALL_TOL``."""
    err, ok = logits_err(torch, outs, SMALL_TOL)
    emit({"output_check": {
        "model": name, **(more or {}),
        "small_model": {"layers": small.n_layers, "dtype": small.dtype,
                        "kv_cache_dtype": small.kv_cache_dtype,
                        "d_model": small.d_model,
                        **({"n_experts": small.n_experts}
                           if small.n_experts else {})},
        "small_f32_gpu_vs_cpu_max_err": err, "small_tol": SMALL_TOL,
        "small_f32_compared": ["prefill", "decode", *outs[0][3]],
        "small_f32_launches_by_instance": inst}})
    if not ok:
        failures.append(f"{name} cut-depth f32 GPU vs CPU: max_err {err}")


def encdec_phase(torch, failures):
    """Step 15: whisper-tiny at full width and depth (4 + 4 layers, d 384,
    6 heads at Dh 64, 1500 frames, vocab 51,865): ``encode`` of seeded
    frames [4, 1500, 384], a prefill of 64 tokens (which encodes them
    again) and 4 ``decode_step``s against the encoder states. The
    encoder's flash launches are non-causal at S 1500 (ragged) on the
    tensor cores, the cross-attention's run at S_kv 1500; every flash
    launch on the tensor cores. The whole model in f32 on the card
    against the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import build_model

    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    params = model.init_params(0)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)).cuda().to(
        params["embed"].dtype)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, ENC_PROMPT + DECODE_STEPS))).cuda()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    enc = model.encode(params, frames)
    torch.cuda.synchronize()
    times = {"encode_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    pl, cache = model.prefill(params, {
        "frames": frames, "tokens": tokens[:, :ENC_PROMPT],
        "cache": model.init_cache(B, ENC_PROMPT + DECODE_STEPS)})
    torch.cuda.synchronize()
    times["prefill_s"] = time.perf_counter() - t0
    dls, steps = [], []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        dl, cache = model.decode_step(params, {
            "tokens": tokens[:, ENC_PROMPT + i:ENC_PROMPT + i + 1],
            "enc_out": enc, "cache": cache})
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        dls.append(dl)
    launches = path_counts(KERNELS, ENCDEC_PATH, cfg.name, failures)
    inst = {n: dict(KERNELS[n].counts.by_instance) for n in ENCDEC_PATH
            if KERNELS[n].counts.by_instance}
    fa_shapes = PATH_SHAPES[cfg.name].get("flash_attention", {})
    frames_n = cfg.encoder_frames
    encoder = sum(n for k, n in fa_shapes.items()
                  if k.startswith("tensor_core ") and f" S{frames_n} " in k
                  and k.endswith(" full"))
    cross = sum(n for k, n in fa_shapes.items()
                if f" Skv{frames_n} full" in k)
    # the encoder runs twice (encode, then inside prefill); cross-attention
    # once a decoder layer a call
    want_enc = 2 * cfg.n_encoder_layers
    want_cross = cfg.n_layers * (1 + DECODE_STEPS)
    ok = (tuple(pl.shape) == (B, ENC_PROMPT, cfg.vocab_size)
          and tuple(enc.shape) == (B, cfg.encoder_frames, cfg.d_model)
          and all(tuple(d.shape) == (B, 1, cfg.vocab_size) for d in dls)
          and all(bool(torch.isfinite(t).all()) for t in (enc, pl, *dls)))
    emit({"model_run": {
        "model": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
        "encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
        "batch": B, "frames": cfg.encoder_frames, "prompt_len": ENC_PROMPT,
        "decode_steps": DECODE_STEPS,
        "params": sum(t.numel() for t in tree_leaves(params)),
        **times, "decode_step_s": steps, "logits_ok": ok,
        "encoder_flash_noncausal_s1500": encoder,
        "cross_attention_flash_skv1500": cross,
        "launches": launches, "launches_by_instance": inst,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}})
    if not ok:
        failures.append(f"{cfg.name}: outputs not finite or of another "
                        f"shape")
    if encoder != want_enc or cross != want_cross:
        failures.append(f"{cfg.name}: {encoder} non-causal S {frames_n} "
                        f"encoder launches on the tensor cores (want "
                        f"{want_enc}) and {cross} cross-attention launches "
                        f"at S_kv {frames_n} (want {want_cross}): "
                        f"{fa_shapes}")
    if not instance_share(inst, "flash_attention", "tensor_core", launches):
        failures.append(f"{cfg.name}: flash launches by instance "
                        f"{inst.get('flash_attention')}, not all "
                        f"tensor_core")
    tok = tokens[:, -1:]
    emit({"decode_step_profile": {"model": cfg.name, **profile_step(
        torch, lambda: model.decode_step(params, {
            "tokens": tok, "enc_out": enc, "cache": cache}))}})
    del model, params, enc, cache
    free_card(torch)
    small = cfg.replace(dtype="float32", kv_cache_dtype="float32")
    outs, small_inst = card_vs_cpu(torch, small)
    f32_check(torch, failures, cfg.name, small, outs, small_inst)
    return launches, inst


def dh160_check(torch, failures) -> None:
    """stablelm-12b at full width (d 5120, 32 / 8 heads at Dh 160, d_ff
    13,824, vocab 100,352), 2 layers in f32: a 64-token prompt and 2
    decode steps on the card against the CPU. Its flash launches take the
    CUDA-core instance (no tensor-core tile is 160 wide)."""
    from repro_torch.configs import get_config

    small = get_config(DH160_ARCH).replace(n_layers=2, dtype="float32",
                                           kv_cache_dtype="float32")
    outs, inst = card_vs_cpu(torch, small, steps=2)
    f32_check(torch, failures, DH160_ARCH, small, outs, inst)
    if set(inst.get("flash_attention", {})) != {"cuda_core"}:
        failures.append(f"{DH160_ARCH}: flash launches by instance "
                        f"{inst.get('flash_attention')}, not cuda_core")


def family_paths(torch, failures, seconds, peaks) -> dict:
    """Steps 12-15 and the Dh 160 check, each model freed before the next;
    {path: (launches, launches by instance)}."""
    paths = {}
    for key, run in (("mla", mla_phase), ("gemma2", gemma2_phase),
                     ("vlm", vlm_phase), ("encdec", encdec_phase)):
        free_card(torch)
        with timed_phase(torch, f"{key}_path", seconds, peaks):
            paths[key] = run(torch, failures)
    free_card(torch)
    with timed_phase(torch, "dh160_check", seconds, peaks):
        dh160_check(torch, failures)
    free_card(torch)
    return paths


def cnn_serving_phase(torch, failures, name, trace=False):
    """One of Table II's DNNs (``CNN_WIDTHS``, 224 x 224 x 3, batch 1, f32,
    random weights from seed 0): an HP and an LP task at its Table II
    per-task rate, served as the LM paths are (``serve``). No port kernel
    may run: the convolutions go to cuDNN through torch. Returns the HP
    task."""
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import BUILDERS
    from repro_torch.serving.requests import TABLE2

    jps = TABLE2[name][2]
    torch.cuda.reset_peak_memory_stats()      # this DNN's own peak
    model = BUILDERS[name](width=CNN_WIDTHS[name])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    specs = cnn_specs(model, jps)
    desc = {"model": name, "width": CNN_WIDTHS[name], "input_hw": CNN_HW,
            "batch": CNN_BATCH, "stages": len(specs[0].stages),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    serve(torch, failures, specs, time.perf_counter() - t0, jps, (), desc,
          trace=trace, input_hw=CNN_HW, schedcheck=True)
    ran = {n: [fn.counts.launches, fn.counts.plain_cuda_calls]
           for n, fn in KERNELS.items()
           if fn.counts.launches or fn.counts.plain_cuda_calls}
    if ran:
        failures.append(f"{name}: port kernels or their plain versions ran "
                        f"on the CNN path (launches, plain CUDA calls): {ran}")
    stage_graph_check(torch, name, specs[0], failures, tol=CNN_TOL)
    return specs[0]


def device_alone(torch, payload, x, reps: int):
    """The mean device ms of ``reps`` calls of a stage program on ``x``,
    each alone on the current stream, between the events its graph
    records (a served stage's device interval); None for a payload
    without ``prepare``."""
    prepare = getattr(payload, "prepare", None)
    if prepare is None:
        return None
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for ev in events:
        ev.record()                         # makes it
    ms = []
    for _ in range(reps):
        call = prepare(x)
        call.issue(*events)
        call.result()
        events[1].synchronize()
        ms.append(events[0].elapsed_time(events[1]))
    return statistics.fmean(ms)


def cnn_stage_profile(torch, spec, reps: int = 5):
    """Where each stage's time goes, on a seeded input (the 4 payloads in
    turn): per call, the CUDA kernels, host wall ms against device busy ms
    (``torch.profiler``), the conv FLOPs reckoned from the shapes
    (``FlopCounterMode``) and their bound at 67 TFLOP/s (f32 outside the
    tensor cores: TF32 is off), and the mean device ms between the stage
    graph's own event nodes, each call alone (``device_alone_ms``; None
    in a tree without them). Returns the rows and the chain's output."""
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = torch.randn((CNN_BATCH, CNN_HW, CNN_HW, 3), generator=gen,
                        device="cuda")
    rows = []
    for st in spec.stages:
        def call(x=state, fn=st.payload):
            return fn(x)
        try:
            call()
            wall_ms, kern = profiled(torch, call, reps)
            # a replay dispatches no operator: count the stage function's
            # (a checkout before the compiled stage: the payload's own)
            with FlopCounterMode(display=False) as fc:
                getattr(st.payload, "fn", st.payload)(state)
            out = call()
            flops = fc.get_flop_counts().get("Global", {})
            conv = sum(n for op, n in flops.items() if "convolution" in str(op))
            busy = busy_us(kern) / 1e3 / reps
            top = sorted(by_kernel(kern).items(), key=lambda kv: -kv[1][1])[:5]
            rows.append({
                "stage": st.name, "t_alone_ms": st.t_alone_ms,
                "device_alone_ms": device_alone(torch, st.payload, state,
                                                reps),
                "kernels": len(kern) / reps,
                "host_wall_ms": wall_ms / reps, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy * reps / wall_ms,
                "conv_gflop": conv / 1e9,
                "conv_bound_ms": conv / PEAK_FLOPS["float32"] * 1e3,
                "other_gflop": (sum(flops.values()) - conv) / 1e9,
                "top_kernels_us": {n[:60]: [c / reps, t / reps]
                                   for n, (c, t) in top}})
        except Exception as e:   # noqa: BLE001 — a measurement, not a check
            rows.append({"stage": st.name, "error": repr(e)})
            out = call()
        state = out
    return rows, state


def cnn_output_checks(torch, name, spec, failures):
    """The served HP task's payload chain on a seeded input gives finite
    outputs of the reference's shape; and a cut-width copy (width 8, input
    65: odd maps, asymmetric SAME padding; batch 2) gives, stage by stage,
    on the card what it gives on the CPU with the same parameters, within
    ``CNN_TOL`` of each output's scale (``stage_errors``)."""
    import numpy as np

    from repro_torch.models import BUILDERS
    from repro_torch.models.cnn import stage_errors

    rows, out = cnn_stage_profile(torch, spec)
    want = ((CNN_BATCH, CNN_HW, CNN_HW, 2) if name == "unet"
            else (CNN_BATCH, 100))
    shape_ok = tuple(out.shape) == want
    finite = bool(torch.isfinite(out).all())
    x = np.random.default_rng(1).standard_normal((2, 65, 65, 3)).astype(
        np.float32)
    errs = stage_errors(BUILDERS[name](width=8, seed=1), torch.from_numpy(x))
    emit({"cnn_output_check": {
        "model": name, "output_shape": list(out.shape), "finite": finite,
        "small_gpu_vs_cpu_rel_err_by_stage": errs, "small_tol": CNN_TOL}})
    emit({"cnn_stage_profile": {
        "model": name, "card": gpu_line(),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark, "stages": rows}})
    if not (shape_ok and finite):
        failures.append(f"{name} served outputs: shape {tuple(out.shape)}, "
                        f"want {want}, finite {finite}")
    if not all(e <= CNN_TOL for e in errs):
        failures.append(f"{name} cut-width GPU vs CPU: relative errors by "
                        f"stage {errs} > {CNN_TOL}")


def restored_mismatches(srv, path, work) -> list:
    """The top-level fields of the state file at ``path`` that differ in
    ``srv``'s scheduler, saved again after its restore: each task's MRET
    windows, AFET seeds, ``ctx`` and ``fixed_ctx``, the migration count,
    the context geometry and the runtime shape."""
    from repro_torch.checkpoint._msgpack import unpackb

    again = srv.save_state(os.path.join(work, "restored.msgpack"))
    want, got = (unpackb(Path(p).read_bytes()) for p in (path, again))
    return [k for k in want if got.get(k) != want[k]]


def same_bits(torch, a, b) -> bool:
    """Tensors ``a`` and ``b`` hold the same bits (shape, dtype, words)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    word = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return bool((a.view(word) == b.view(word)).all())


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in their order."""
    out = []
    tree_map(out.append, tree)
    return out


def resume_phase(torch, failures):
    """ResNet18 served as in the CNN phase (its published width, 224 x 224
    x 3, batch 1, f32, TF32 off; an HP and an LP task at Table II's rate),
    cold then resumed (``served_resume``); the launcher's ``--ckpt``
    (``launcher_resume``); the served parameters through the parameter
    files on the card (``params_roundtrip``); and the daemon example
    (``daemon_example``). Files go under a temporary directory, removed
    after; the phase must not import ``msgpack``."""
    import shutil
    import tempfile

    from repro_torch.api import HP, LP
    from repro_torch.kernels import reset_counts
    from repro_torch.models import BUILDERS
    from repro_torch.serving.engine import staged_cnn_taskspec
    from repro_torch.serving.requests import TABLE2

    jps = TABLE2[RESUME_DNN][2]
    model = BUILDERS[RESUME_DNN](width=CNN_WIDTHS[RESUME_DNN])
    reset_counts()                    # the graph pools since the tasks
    t0 = time.perf_counter()
    specs = [staged_cnn_taskspec(model, priority=p, jps=jps, input_hw=CNN_HW,
                                 batch=CNN_BATCH, tag=tag)
             for p, tag in ((HP, "-hp"), (LP, "-lp"))]
    setup_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="resume-")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
    try:
        line = served_resume(torch, failures, specs, setup_s, jps, work)
        line["launcher"] = launcher_resume(failures, work, env)
        emit({"resume": line})
        params_roundtrip(torch, failures, model, work)
        daemon_example(failures, env)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "msgpack" in sys.modules:
        failures.append("resume: msgpack was imported")


def served_resume(torch, failures, specs, setup_s, jps, work) -> dict:
    """``specs`` served twice (``serve``): a cold run whose scheduler
    state is then saved (``save_state``), and a fresh server of the same
    config that loads the file before it runs (``load_state``) and must
    equal it field by field (``restored_mismatches``). Returns the
    ``resume`` line: for each run every task's MRET at its start and end,
    per HP stage ``t_alone``, the AFET seed, MRET at start and end and the
    served mean ``et_ms`` (HP and LP stages share names), HP misses, LP
    rejects and HP responses; the file's bytes and the µs of the save and
    the load."""
    from repro_torch.api import HP, LP

    path = os.path.join(work, "sched.msgpack")
    runs, io, mismatches = [], {}, []
    for run in ("cold", "resumed"):
        start = {}

        def prepare(srv, run=run):
            if run == "resumed":
                t0 = time.perf_counter()
                srv.load_state(path)
                io["load_us"] = (time.perf_counter() - t0) * 1e6
                mismatches.extend(restored_mismatches(srv, path, work))
            start.update({t.name: [st.value() for st in t.mret.stages]
                          for t in srv.scheduler.tasks})

        desc = {"model": RESUME_DNN, "width": CNN_WIDTHS[RESUME_DNN],
                "input_hw": CNN_HW, "batch": CNN_BATCH,
                "stages": len(specs[0].stages), "resume_run": run}
        m, _, _, srv = serve(torch, failures, specs, setup_s, jps, (), desc,
                             input_hw=CNN_HW, prepare=prepare,
                             fresh=run == "cold")
        if run == "cold":
            t0 = time.perf_counter()
            srv.save_state(path)
            io["save_us"] = (time.perf_counter() - t0) * 1e6
            io["file_bytes"] = os.path.getsize(path)
        served = srv.backend.stage_time_summary()
        hp = m.response_ms[HP]
        hp_task = srv.task_named(specs[0].name)
        runs.append({
            "run": run,
            "task_mret_start_ms": {k: sum(v) for k, v in start.items()},
            "task_mret_end_ms": {t.name: t.mret.task_mret()
                                 for t in srv.scheduler.tasks},
            "hp_stages": [{"stage": st.name, "t_alone_ms": st.t_alone_ms,
                           "afet_ms": est.afet_ms,
                           "mret_start_ms": start[hp_task.name][j],
                           "mret_end_ms": est.value(),
                           "served_et_ms": served.get(st.name, {}).get(
                               "mean_et_ms")}
                          for j, (st, est) in enumerate(
                              zip(specs[0].stages, hp_task.mret.stages))],
            "hp_completed": m.completed[HP], "hp_missed": m.missed[HP],
            "lp_rejected": m.rejected[LP],
            "hp_mean_response_ms": m.resp_stats(HP)["mean"] if hp else None,
            "hp_response_ms": [round(r, 3) for r in hp]})
    if mismatches:
        failures.append(f"resume: restored state differs from the file in "
                        f"{mismatches}")
    return {"model": RESUME_DNN, "card": gpu_line(), **io,
            "restored_equal": not mismatches, "runs": runs}


def launcher_resume(failures, work, env) -> list:
    """``python -m repro_torch.launch.serve --ckpt FILE`` twice (width 8,
    1 s): the first saves, the second must print that it resumed."""
    ckpt, runs = os.path.join(work, "launch.msgpack"), []
    for _ in range(2):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--dnns",
             RESUME_DNN, "--seconds", "1", "--ckpt", ckpt],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=300)
        runs.append({"rc": out.returncode, "wall_s": time.perf_counter() - t0,
                     "stdout": out.stdout.strip().splitlines()})
        if out.returncode != 0:
            failures.append(f"resume: launcher --ckpt exited "
                            f"{out.returncode}: {out.stderr[-1500:]}")
    if not any(ln.startswith("resumed scheduler state")
               for ln in runs[1]["stdout"]):
        failures.append(f"resume: the second launcher run did not resume: "
                        f"{runs[1]['stdout']}")
    return runs


def params_roundtrip(torch, failures, model, work) -> None:
    """The served model's parameters from the card through
    ``save_pytree``, then ``load_pytree`` into a zeroed template on the
    card: every leaf must come back bit for bit, on its device. Emits the
    MB and the seconds of each direction."""
    from repro_torch.checkpoint import load_pytree, save_pytree

    path = os.path.join(work, RESUME_DNN)
    leaves = tree_leaves(model.params)
    mb = sum(t.numel() * t.element_size() for t in leaves) / 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_pytree(model.params, path, step=0)
    save_s = time.perf_counter() - t0
    template = tree_map(torch.zeros_like, model.params)
    t0 = time.perf_counter()
    back = load_pytree(template, path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = tree_leaves(back)
    identical = len(got) == len(leaves) and all(
        g.device == t.device and same_bits(torch, g, t)
        for g, t in zip(got, leaves))
    emit({"params_roundtrip": {
        "model": RESUME_DNN, "width": CNN_WIDTHS[RESUME_DNN],
        "leaves": len(leaves), "parameters": sum(t.numel() for t in leaves),
        "mb": mb, "save_s": save_s, "load_s": load_s,
        "save_mb_per_s": mb / save_s, "load_mb_per_s": mb / load_s,
        "bit_identical": identical, "card": gpu_line()}})
    if not identical:
        failures.append("resume: parameters did not round-trip bit for bit "
                        "through save_pytree/load_pytree")


def daemon_example(failures, env) -> None:
    """examples/serve_daemon_torch.py in a subprocess (daemon, burst,
    cancel, SIGTERM, restart, zero lost, audit, replay): it must exit 0.
    Emits its wall time and the submit round trips it prints. The socket
    lives in a short temporary directory (a unix socket's path is at most
    107 bytes)."""
    import shutil
    import tempfile

    import signal

    work = tempfile.mkdtemp(prefix="d-")
    t0 = time.perf_counter()
    # its own session, so that a timeout also ends the daemons it spawned
    proc = subprocess.Popen(
        [sys.executable, "examples/serve_daemon_torch.py", "--dir", work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT), start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rt = [json.loads(ln.split(":", 1)[1]) for ln in stdout.splitlines()
          if ln.strip().startswith("submit round trip us:")]
    emit({"serve_daemon": {"rc": proc.returncode,
                           "wall_s": time.perf_counter() - t0,
                           "submit_round_trip_us": rt[0] if rt else None,
                           "stdout_tail": stdout.splitlines()[-3:],
                           "card": gpu_line()}})
    if proc.returncode != 0:
        failures.append(f"resume: examples/serve_daemon_torch.py exited "
                        f"{proc.returncode}: {stderr[-1500:]}")


def grad_cases(torch, F, dtype, dev="cuda"):
    """(name, leaf inputs, wrapper call, plain call, library call | None,
    eager timing repeats) of the gradient rows, at the training path's
    shapes (norms over 16,384 rows of 576; causal flash at B 4, H 9, KV 3,
    S 4096, Dh 64, its backward in query blocks of ``TRAIN_Q_CHUNK`` as the
    training phase runs it) and the SSD scan at mamba2's donor-prefill
    shapes with no initial state (as its training forward calls it)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_scan

    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def leaf(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=dev).to(
            dt).requires_grad_()

    x, r, w = leaf(TRAIN_ROWS, D), leaf(TRAIN_ROWS, D), leaf(D)
    # q, k, v in the model's [B, S, heads, Dh] layout, attended transposed
    q, k, v = (leaf(TRAIN_MB, TRAIN_SEQ, n, DH) for n in (H, KV, KV))

    def t12(*ts):
        return [t.transpose(1, 2) for t in ts]

    sx = leaf(B, PROMPT, SSM_H, SSM_P)
    sdt = (torch.empty((B, PROMPT, SSM_H), device=dev).uniform_(
        0.001, 0.1, generator=g).requires_grad_())
    sal = torch.log(torch.linspace(1.0, 16.0, SSM_H, device=dev)).to(
        dtype).requires_grad_()
    sb, sc = leaf(B, PROMPT, SSM_G, SSM_N), leaf(B, PROMPT, SSM_G, SSM_N)
    return [
        ("rmsnorm", (x, w), lambda a, c: rms.rmsnorm(a, c),
         lambda a, c: rms.rmsnorm_plain(a, c),
         lambda a, c: F.rms_norm(a, (D,), c, 1e-6), 10),
        ("rmsnorm_residual", (x, r, w),
         lambda a, b, c: rms.rmsnorm_residual(a, b, c),
         lambda a, b, c: rms.rmsnorm_residual_plain(a, b, c),
         lambda a, b, c: (F.rms_norm(a + b, (D,), c, 1e-6), a + b), 10),
        ("flash_attention", (q, k, v),
         lambda a, b, c: fa.flash_attention(*t12(a, b, c),
                                            q_chunk=TRAIN_Q_CHUNK),
         lambda a, b, c: fa.flash_attention_plain(*t12(a, b, c)),
         lambda a, b, c: F.scaled_dot_product_attention(
             *t12(a, b, c), is_causal=True, enable_gqa=True), 2),
        ("ssd", (sx, sdt, sal, sb, sc),
         lambda *t: ssd_scan.ssd(*t, SSM_Q),
         lambda *t: ssd_scan.ssd_plain(*t, SSM_Q), None, 2),
    ]


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def rel_grad_err(got, want) -> float:
    """Largest |got - want| over the largest |want|, over the inputs; a
    missing gradient counts as zeros (1.0)."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = max(float(b.double().abs().max()), 1e-30)
        diff = (float(b.double().abs().max()) if a is None else
                float((a.double() - b.double()).abs().max()))
        worst = max(worst, diff / scale)
    return worst


@contextlib.contextmanager
def no_upcast():
    """The plain versions with their f32 upcast (``at_least_f32``) taken
    out, so that bf16 inputs are computed in bf16 throughout: the
    gradient rows' control."""
    from repro_torch.kernels import _lib
    from repro_torch.models import mamba2
    saved = _lib.at_least_f32, mamba2.at_least_f32
    _lib.at_least_f32 = mamba2.at_least_f32 = lambda t: t
    try:
        yield
    finally:
        _lib.at_least_f32, mamba2.at_least_f32 = saved


def plain_grads_of(torch, plain, inputs, cots, cast):
    """Gradients to ``inputs`` of ``plain`` on the inputs cast by ``cast``
    (autograd through the cast), each cotangent in its output's dtype."""
    outs = as_tuple(plain(*(cast(t) for t in inputs)))
    return torch.autograd.grad(outs, inputs, [c.to(o.dtype) for c, o in
                                              zip(cots, outs)])


def grad_phase(torch, F, failures, dev="cuda") -> dict:
    """The gradient rows, bf16 and f32: a seeded cotangent's gradients
    through each Function (the kernel's forward, the plain version
    recomputed in the backward) against a witness that is not the
    Function's code, the plain version differentiated by autograd in f64
    on the card (``GRAD_TOL``). Two controls must leave the tolerance: a
    planted fault, the wrapper's output cut from the graph (what the
    wrappers returned before the Functions), and the plain version
    computed in bf16 (``no_upcast``, inputs rounded to bf16). Also read:
    the Function against autograd of the plain version in the inputs'
    dtype (the same arithmetic: 0 but for the order of sums), and the
    shapes its backward counted. Times (µs, eager, CUDA events): the
    kernel's forward, the Function's backward (the recompute), the plain
    version's forward + backward and the library's (SDPA, ``F.rms_norm``;
    a yardstick). Returns the bf16 rows by kernel name."""
    from repro_torch.kernels import KERNELS

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for name, inputs, kern, plain, lib, reps in grad_cases(
                torch, F, dtype, dev):
            counts = KERNELS[name].counts
            outs = as_tuple(kern(*inputs))
            g = torch.Generator(device=dev)
            g.manual_seed(2)
            cots = [torch.randn(o.shape, generator=g, device=dev).to(
                o.dtype) for o in outs]
            counts.reset()
            got = torch.autograd.grad(outs, inputs, cots, retain_graph=True)
            backward_shapes = dict(counts.backward_by_shape)
            wide = [t.detach().double().requires_grad_() for t in inputs]
            witness = plain_grads_of(torch, plain, wide, cots, lambda t: t)
            del wide
            err = rel_grad_err(got, witness)
            same = rel_grad_err(got, plain_grads_of(torch, plain, inputs,
                                                    cots, lambda t: t))
            with no_upcast():
                control = rel_grad_err(plain_grads_of(
                    torch, plain, inputs, cots,
                    lambda t: t.to(torch.bfloat16)), witness)
            cut = [o.detach().requires_grad_() for o in outs]
            fault = rel_grad_err(torch.autograd.grad(
                cut, inputs, cots, allow_unused=True), witness)
            del witness
            tol = (GRAD_TOL_SSD_BF16 if name == "ssd" and
                   dtype == torch.bfloat16 else GRAD_TOL[dname])

            def fwd_bwd(fn):
                def run():
                    torch.autograd.grad(as_tuple(fn(*inputs)), inputs, cots)
                return run

            with torch.no_grad():
                fwd = cuda_ms(torch, lambda: kern(*inputs), reps, reps)
            row = {"name": name, "dtype": dname,
                   "shapes": [list(t.shape) for t in inputs],
                   "backward_shapes": backward_shapes,
                   "max_rel_err": err, "witness": "plain version, f64",
                   "tol": tol, "within_tol": err <= tol,
                   "same_arithmetic_max_rel_err": same,
                   "bf16_compute_control": {"max_rel_err": control,
                                            "caught": control > tol},
                   "planted_fault": {"cut_from_graph": True,
                                     "max_rel_err": fault,
                                     "caught": fault > tol},
                   "forward_kernel_us": fwd * 1e3,
                   "backward_recompute_us": cuda_ms(
                       torch, lambda: torch.autograd.grad(
                           outs, inputs, cots, retain_graph=True),
                       reps, reps) * 1e3,
                   "plain_fwd_bwd_us": cuda_ms(torch, fwd_bwd(plain), reps,
                                               reps) * 1e3,
                   "library_fwd_bwd_us": None}
            if lib is not None:
                try:
                    row["library_fwd_bwd_us"] = cuda_ms(
                        torch, fwd_bwd(lib), reps, reps) * 1e3
                except (TypeError, RuntimeError) as e:   # yardstick only
                    row["library_error"] = repr(e)
            emit({"grad_check": row})
            if not (err <= tol and math.isfinite(err)
                    and same <= tol and math.isfinite(same)):
                failures.append(f"{name} {dname} gradients: {err} against "
                                f"the f64 witness, {same} against the plain "
                                f"version's autograd; tolerance {tol}")
            if not fault > tol:
                failures.append(f"{name} {dname}: gradients of the output "
                                f"cut from the graph agree with the witness")
            if not control > tol:
                failures.append(f"{name} {dname}: the bf16-compute control "
                                f"({control}) is within {tol}")
            del outs, got, cut
            if dtype == torch.bfloat16:
                rows[name] = row
        torch.cuda.empty_cache()
    return rows


def backward_coverage(grad_rows, shapes, failures) -> None:
    """Every shape the training path's backward recomputed a kernel's plain
    version at (``shapes``: kernel -> shape key -> count) must be one a
    bf16 gradient row held to the witness."""
    for name, per in shapes.items():
        checked = grad_rows.get(name, {}).get("backward_shapes", {})
        for key, n in per.items():
            if key not in checked:
                failures.append(f"{name}: {n} backward recomputes at {key} "
                                f"on the training path, a shape no "
                                f"gradient row checks")


def recompute_ms(torch, events) -> dict:
    """Device ms of each kernel's backward recompute: the kernels' busy time
    inside the ``{name}_backward_recompute`` ranges of the card's timeline
    (the backward runs on one stream, so nothing else runs inside them),
    or an error where the trace holds no such range."""
    suffix = "_backward_recompute"
    dev = torch.autograd.DeviceType.CUDA
    spans, kern = {}, []
    for e in events:
        if e.device_type == dev:
            if e.name.endswith(suffix):
                spans.setdefault(e.name[:-len(suffix)], []).append(
                    (e.time_range.start, e.time_range.end))
            else:
                kern.append(e)
    if not spans:
        return {"error": "no device ranges of the backward recomputes"}
    out = {}
    for n, sp in spans.items():
        inside = [e for e in kern if any(a <= e.time_range.start < b
                                         for a, b in sp)]
        out[n] = busy_us(inside) / 1e3
    return out


def train_phase(torch, failures, dev="cuda"):
    """smollm-135m at full width and depth trained ``TRAIN_STEPS`` AdamW
    steps on the card (bf16 params, f32 m/v, seed 0; ``TokenPipeline``
    batches of 8 x 4096; ``accum`` 2, remat ``"dots"``, the attention's
    backward recompute in query blocks of ``TRAIN_Q_CHUNK``): a ``train_step``
    line a step, then a ``train_summary``. Counts are reset just before the
    steps and read just after. Fails on a non-finite loss or grad_norm, a
    last loss less than ``TRAIN_MIN_DROP`` below the first, a bf16 flash
    launch off the tensor cores, a plain version on the card outside the
    counted backward, or (one more microbatch's gradients, after the
    steps) a parameter leaf, or one layer's slice of a stacked leaf, with
    a zero or non-finite gradient. Returns (launches, launches by
    instance, backward recomputes a step, backward recomputes by shape)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (make_loss_fn,
                                                 make_train_step,
                                                 value_and_grad)

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    params = model.init_params(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(model, opt_cfg, q_chunk=TRAIN_Q_CHUNK,
                           accum=TRAIN_ACCUM, remat=TRAIN_REMAT)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the reference's MODEL_FLOPS of the cut cell (6 N_active D, N without
    # the embedding), the roofline's yardstick
    flops = model.model_flops(ShapeCell("train_4k", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, dev_ms, wall_ms, first = [], [], [], [], None
    reset_counts()
    for i in range(TRAIN_STEPS):
        batch = {"tokens": torch.from_numpy(
            pipe.next_batch()["tokens"]).to(dev)}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        params, opt, m = step(params, opt, batch)
        b.record()
        b.synchronize()
        wall = time.perf_counter() - t0
        loss, gn, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        losses.append(loss)
        norms.append(gn)
        dev_ms.append(a.elapsed_time(b))
        wall_ms.append(wall * 1e3)
        if first is None:         # one step's launches and recomputes
            first = {n: (fn.counts.launches, dict(fn.counts.by_instance),
                         fn.counts.backward)
                     for n, fn in KERNELS.items() if fn.counts.launches
                     or fn.counts.backward}
        emit({"train_step": {"step": i, "loss": loss, "grad_norm": gn,
                             "lr": lr, "device_ms": dev_ms[-1],
                             "wall_ms": wall_ms[-1],
                             "tokens_per_s": tokens / wall}})
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = path_counts(KERNELS, TRAIN_PATH, PATH_MODELS["train"],
                           failures)
    instances = {n: dict(KERNELS[n].counts.by_instance) for n in TRAIN_PATH
                 if KERNELS[n].counts.by_instance}
    backward = {n: fn.counts.backward for n, fn in KERNELS.items()
                if fn.counts.backward}
    backward_shapes = {n: dict(fn.counts.backward_by_shape)
                       for n, fn in KERNELS.items() if fn.counts.backward}
    fa_inst = instances.get("flash_attention", {})
    if set(fa_inst) != {"tensor_core"}:
        failures.append(f"training: bf16 flash launches by instance "
                        f"{fa_inst}, not all tensor_core")
    if not all(math.isfinite(x) for x in losses + norms):
        failures.append(f"training: loss {losses} / grad_norm {norms} not "
                        f"finite")
    drop = 1.0 - losses[-1] / losses[0]
    if not drop >= TRAIN_MIN_DROP:
        failures.append(f"training: last loss {losses[-1]} is not "
                        f"{TRAIN_MIN_DROP:.0%} below the first {losses[0]}")

    # every leaf the loss reaches gets a gradient, every layer's slice of
    # a stacked leaf too (one microbatch from the next batch)
    mb = {"tokens": torch.from_numpy(pipe.next_batch()["tokens"][
        :TRAIN_MB]).to(dev)}
    loss_fn = make_loss_fn(model, q_chunk=TRAIN_Q_CHUNK, remat=TRAIN_REMAT)
    _, grads = value_and_grad(loss_fn, params, mb)
    missing = []
    for path, gl in tree_paths(grads):
        stacked = path.startswith("layers/")    # [n_layers, ...]: each layer
        per = gl.float().reshape(gl.shape[0] if stacked else 1, -1)
        bad = [j for j, x in enumerate(per.abs().amax(1).tolist())
               if not (x > 0 and math.isfinite(x))]
        if bad:
            missing.append(f"{path} layers {bad}" if stacked else path)
    if missing:
        failures.append(f"training: zero or non-finite gradients at "
                        f"{missing}")
    del grads

    # where one step's time goes
    batch = {"tokens": torch.from_numpy(
        pipe.next_batch()["tokens"]).to(dev)}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        kern = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.endswith("_backward_recompute")]
        profile_line = {"wall_ms": prof_wall,
                        "device_busy_ms": busy_us(kern) / 1e3,
                        "kernels": len(kern),
                        "backward_recompute_ms": recompute_ms(torch, events),
                        "top_kernels_us": {
                            n[:60]: [c, t] for n, (c, t) in sorted(
                                by_kernel(kern).items(),
                                key=lambda kv: -kv[1][1])[:12]}}
        profile_line["device_idle_share"] = (
            1.0 - profile_line["device_busy_ms"] / prof_wall)
    except Exception as e:   # noqa: BLE001 — a measurement, not a check
        profile_line = {"error": repr(e)}
    steady = sorted(dev_ms[2:]) or dev_ms
    med_ms = steady[len(steady) // 2]
    emit({"train_summary": {
        "model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": n_params, "dtype": cfg.dtype, "moments": "float32",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM,
        "remat": TRAIN_REMAT, "q_chunk": TRAIN_Q_CHUNK,
        "steps": TRAIN_STEPS, "lr": TRAIN_LR,
        "warmup_steps": TRAIN_WARMUP,
        "cuts": "global batch 8 sequences (train_4k: 256); 20 steps",
        "first_loss": losses[0], "last_loss": losses[-1], "drop": drop,
        "median_device_ms_from_step_2": med_ms,
        "tokens_per_s_at_median": tokens / med_ms * 1e3,
        "model_flops_per_step": flops,
        "model_flops_formula": "Model.model_flops of train_4k cut to 8 "
                               "sequences: 6 N_active D (N without the "
                               "embedding; no attention term)",
        "model_flop_share_of_989_tflops": flops / 989e12 / (med_ms / 1e3),
        "peak_memory_gb": peak,
        "launches_per_step": {n: v[0] for n, v in first.items()},
        "launches_per_step_by_instance": {n: v[1] for n, v in first.items()
                                          if v[1]},
        "backward_recomputes_per_step": {n: v[2] for n, v in first.items()},
        "launches": launches, "backward_recomputes": backward,
        "backward_recomputes_by_shape": backward_shapes,
        "profile_one_step": profile_line}})
    per_step = {n: v[2] for n, v in first.items()}
    del model, params, opt, step
    return launches, instances, per_step, backward_shapes


def tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) of a tree of dicts and lists, paths joined by "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in tree_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def train_cut_check(torch, failures, dev="cuda") -> None:
    """Every architecture's reduced config (f32) one training step on the
    card (the kernels' forwards and the Functions' recomputes) against the
    same step on the CPU (the plain versions), from the same parameters
    (the port's init, seed 0) and a seeded batch of 2 x 16 tokens (whisper:
    and 2 seeded frame sequences; pixtral: and 2 seeded image-embedding
    sequences): remat "none" and "full", smollm also "dots". Compares the
    loss and each gradient leaf (``value_and_grad``), then the step's loss,
    grad_norm and lr, within ``TRAIN_SMALL_TOL`` relative (a gradient leaf
    of its scale: its largest |g|, or ``TRAIN_NOISE_FLOOR`` of the largest
    of any leaf where that is more), and every new parameter within
    ``TRAIN_P_TOL`` where |g| passes ``TRAIN_G_FLOOR`` of its leaf's scale
    and within 2 lr + ``TRAIN_P_TOL`` elsewhere. A
    ``train_cut`` line an architecture, with the card's launches by
    instance."""
    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (make_loss_fn,
                                                 make_train_step,
                                                 value_and_grad)

    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        cm, gm = build_model(cfg, device="cpu"), build_model(cfg, device=dev)
        cp = cm.init_params(0)
        gp = tree_map(lambda t: t.to(dev), cp)
        rng = np.random.default_rng(0)
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
        if cfg.family == "encdec":
            arrays["frames"] = rng.standard_normal(
                (2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            arrays["image_embeds"] = rng.standard_normal(
                (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        line = {"model": cfg.name, "family": cfg.family, "remat": {}}
        reset_counts()
        for remat in ("none", "full") + (("dots",) if arch == TRAIN_ARCH
                                         else ()):
            res = []
            for mdl, p in ((gm, gp), (cm, cp)):
                batch = {k: torch.from_numpy(v).to(mdl.device)
                         for k, v in arrays.items()}
                loss, grads = value_and_grad(make_loss_fn(mdl, remat=remat),
                                             p, batch)
                new, _, met = make_train_step(mdl, opt_cfg, remat=remat)(
                    p, adamw_init(p, opt_cfg), batch)
                res.append((loss, grads, new, met))
            (gl, gg, gn, gmet), (cl, cg, cn, cmet) = res

            def rel(a, b):
                return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

            errs = {"loss": rel(gl, cl),
                    **{f"step_{k}": rel(gmet[k], cmet[k])
                       for k in ("loss", "grad_norm", "lr")}}
            g_err, p_err, p_far = 0.0, 0.0, 0.0
            # a leaf's scale: its largest |g|, or TRAIN_NOISE_FLOOR of the
            # largest of any leaf where that is more (a leaf whose true
            # gradient is 0, such as a key bias, holds rounding noise)
            floor = TRAIN_NOISE_FLOOR * max(float(b.abs().max())
                                            for _, b in tree_paths(cg))
            for (_, a), (_, b), (_, na), (_, nb) in zip(
                    tree_paths(gg), tree_paths(cg), tree_paths(gn),
                    tree_paths(cn)):
                a = a.cpu()
                top = max(float(b.abs().max()), floor)
                g_err = max(g_err, float((a - b).abs().max()) / top)
                d = (na.cpu() - nb).abs()
                sure = b.abs() > TRAIN_G_FLOOR * top
                if sure.any():
                    p_err = max(p_err, float(d[sure].max()))
                p_far = max(p_far, float(d.max()))
            errs.update(grad_leaf=g_err, new_params_sure=p_err,
                        new_params_any=p_far)
            line["remat"][remat] = errs
            ok = (max(errs["loss"], errs["step_loss"], errs["step_grad_norm"],
                      errs["step_lr"], g_err) <= TRAIN_SMALL_TOL
                  and p_err <= TRAIN_P_TOL
                  and p_far <= 2 * TRAIN_LR + TRAIN_P_TOL)
            if not ok:
                failures.append(f"{cfg.name} remat {remat}: card against CPU "
                                f"{errs}")
        line["launches_by_instance"] = {
            n: dict(fn.counts.by_instance) for n, fn in KERNELS.items()
            if fn.counts.by_instance}
        line["backward_recomputes"] = {n: fn.counts.backward
                                       for n, fn in KERNELS.items()
                                       if fn.counts.backward}
        line["plain_cuda_calls"] = {n: fn.counts.plain_cuda_calls
                                    for n, fn in KERNELS.items()
                                    if fn.counts.plain_cuda_calls}
        emit({"train_cut": line})
        if line["plain_cuda_calls"]:
            failures.append(f"{cfg.name}: plain versions on the card outside "
                            f"the counted backward: "
                            f"{line['plain_cuda_calls']}")


# ---------------------------------------------------------------------------
# Slice 12 (steps 18-20): four ranks of the card, the dry-run, the roofline
# ---------------------------------------------------------------------------
def start_dryruns(out_dir: Path) -> list:
    """Step 19's dry-run cells, each its own process at the lowest CPU
    priority (fake tensors: CPU only), started before the kernel rows
    (timed on the card) and awaited (``finish_dryruns``) before any phase
    that reads the host's clock: the reference's three tiny-mesh cells, a
    cell a family at the production mesh, the roofline cells at a 1 x 1
    mesh and the layout cells at 2 x 2 (``LAYOUTS``). Returns [(cell,
    process, log path)], a cell (arch, shape, mesh, tag)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONWARNINGS="ignore")
    jobs = [((a, s, m, ""), []) for a, s, m in DRYRUN_CELLS]
    jobs += [((a, s, "single", ""), []) for a, s in DRYRUN_SINGLE]
    for shape, extra in ROOF_CELLS.items():
        args = ["--global-batch", str(extra["global_batch"])]
        for key, flag in (("accum", "--accum"), ("remat", "--remat"),
                          ("q_chunk", "--q-chunk")):
            if key in extra:
                args += [flag, str(extra[key])]
        jobs.append(((TRAIN_ARCH, shape, "unit", "roofline"), args))
    for name, flags in LAYOUTS.items():
        jobs.append(((TRAIN_ARCH, "train_4k", "2x2", f"layout_{name}"),
                     ["--global-batch", str(LAYOUT_BATCH), "--layers",
                      str(LAYOUT_LAYERS), "--pad-for-tp", str(LAYOUT_PAD),
                      *flags]))
    procs = []
    for (arch, shape, mesh, tag), args in jobs:
        suffix = f"__{tag}" if tag else ""
        log = out_dir / f"{arch}__{shape}__{mesh}{suffix}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out",
               str(out_dir), *(["--tag", tag] if tag else []), *args]
        with open(log, "w") as fh:
            procs.append(((arch, shape, mesh, tag), subprocess.Popen(
                cmd, env=env, cwd=str(ROOT), stdout=fh,
                stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(19)), log))
    return procs


def dryrun_artifact(out_dir: Path, arch, shape, mesh, tag="") -> dict:
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape}__{mesh}{suffix}.json"
    return json.loads(path.read_text()) if path.exists() else {
        "status": "missing"}


def finish_dryruns(procs, out_dir: Path, failures, timeout_s=900.0):
    """Wait for the dry-run processes; emits a ``dryrun`` line a cell
    (status, FLOPs and collective bytes a device, peak bytes and the fit
    on 80 GB, seconds) and fails a cell whose status is not ``ok`` or
    whose FLOPs are not positive."""
    t0 = time.perf_counter()
    for (arch, shape, mesh, tag), proc, log in procs:
        try:
            proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter()
                                                     - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failures.append(f"dry-run {arch} {shape} {mesh} {tag}: no end "
                            f"in {timeout_s:g} s")
            continue
        art = dryrun_artifact(out_dir, arch, shape, mesh, tag)
        line = {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
                "status": art.get("status"), "returncode": proc.returncode}
        if art.get("status") == "ok":
            line.update({k: art[k] for k in (
                "n_chips", "mesh_shape", "extra", "flops_per_device",
                "model_flops", "peak_bytes_per_device",
                "resident_bytes_per_device", "fits_80gb",
                "analytic_hbm_bytes_global", "accum", "build_s", "run_s")})
            line["collectives_per_device"] = art["collectives_per_device"]
        else:
            line["error"] = art.get("error") or log.read_text()[-1500:]
        emit({"dryrun": line})
        if art.get("status") != "ok" or not line.get("flops_per_device"):
            failures.append(f"dry-run {arch} {shape} {mesh} {tag}: "
                            f"{line.get('error', line)}")
    return time.perf_counter() - t0


def lm_run(model, params, tokens, cache, last: int = DIST_LAST):
    """A prefill of ``PROMPT`` tokens and ``DECODE_STEPS`` decode steps:
    [the prefill's last ``last`` positions' logits, each step's]."""
    logits, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT],
                                           "cache": cache})
    outs = [logits[:, -last:]]
    for i in range(DECODE_STEPS):
        logits, cache = model.decode_step(
            params, {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1],
                     "cache": cache})
        outs.append(logits)
    return outs


def shard_tree(tree, specs, mesh):
    from repro_torch.parallel.sharding import shard_local
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return shard_local(tree, specs, mesh)


def f32_config(cfg):
    """``cfg`` computing in f32 with an f32 KV cache."""
    return cfg.replace(dtype="float32", kv_cache_dtype="float32")


def moe_layer0_f32(params) -> dict:
    """Layer 0's router and experts in f32 (the EP check's layer)."""
    m = params["layers"]["moe"]
    return {"router": m["router"][0].float(),
            "experts": {k: v[0].float() for k, v in m["experts"].items()}}


def dist_rank(rank: int, work: Path, port: int) -> int:
    """One of step 18's four rank processes (``--dist-rank``): its shards
    of qwen2-moe-a2.7b on the card, the prefill and decode steps through
    ``Model`` with ``dist``, the logits gathered to rank 0, the f32 EP
    check, and its launch counts, seconds and peak memory in
    ``work/rank{rank}.json``."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, _lib, reset_counts
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import moe_ep
    from repro_torch.parallel.sharding import ShardingRules

    torch.cuda.set_device(0)
    world = math.prod(DIST_MESH)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", DIST_MESH,
                            mesh_dim_names=("data", "model"))
    _lib.lib()                        # the parent's build, loaded
    cfg = get_config(MOE_ARCH).replace(n_layers=DIST_LAYERS)
    tp = DIST_MESH[1]
    whole = build_model(cfg, pad_for_tp=tp)
    params = whole.init_params(0)     # every rank draws the same weights
    rules = ShardingRules(whole.cfg, mesh).for_batch(B)
    dist = rules.dist_ctx()
    dist["param_specs"] = rules.param_specs(params)
    local = shard_tree(params, dist["param_specs"], mesh)
    del params
    free_card(torch)
    model = build_model(cfg, pad_for_tp=tp, dist=dist)
    spmd = dist["spmd"]
    inputs = torch.load(work / "inputs.pt")
    tokens = inputs["tokens"].cuda()
    cache = whole.init_cache(B, PROMPT + DECODE_STEPS)
    cache = shard_tree(cache, rules.cache_specs(cache), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tdist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = lm_run(model, local, tokens, cache)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts(KERNELS)
    with torch.no_grad():
        full = [spmd._all_gather(o, o.dim() - 1, "model") for o in outs]
        # the same layers in f32 (the bf16 weights, an f32 cache); after
        # the counts are read: f32 launches are no part of the served path
        cfg32 = f32_config(cfg)
        model32 = build_model(cfg32, pad_for_tp=tp, dist=dist)
        cache32 = build_model(cfg32, pad_for_tp=tp).init_cache(
            B, PROMPT + DECODE_STEPS)
        cache32 = shard_tree(cache32, rules.cache_specs(cache32), mesh)
        full32 = [spmd._all_gather(o, o.dim() - 1, "model") for o in lm_run(
            model32, tree_map(lambda t: t.float(), local), tokens, cache32)]
        lp = moe_layer0_f32(local)
        ep, aux = moe_ep(lp, inputs["h"].cuda(), topk=cfg.n_experts_active,
                         dist=dist, norm_topk=cfg.router_norm_topk,
                         act=cfg.mlp_act, n_valid=cfg.n_experts)
    torch.cuda.synchronize()
    if rank == 0:
        torch.save({"outs": [o.float().cpu() for o in full],
                    "outs32": [o.cpu() for o in full32],
                    "ep": ep.cpu(), "aux": aux.cpu()}, work / "rank0.pt")
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "coord": spmd.coord, "seconds": seconds,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "local_experts": lp["experts"]["w_gate"].shape[0],
        "local_heads": local["layers"]["attn"]["wq"].shape[-2],
        "collectives": spmd.counts.as_dict(), "counts": counts}))
    # the same prefill and decode under serve_seq_shard, then the layouts
    seq_prefill_rank(torch, rank, work, cfg, rules, whole, local, tokens,
                     dist["param_specs"])
    del local, model, model32, cache, cache32, lp, outs, full, full32
    free_card(torch)
    (work / f"layouts_rank{rank}.json").write_text(json.dumps(
        layout_rank(torch, tdist, rank, work)))
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def kernel_counts(KERNELS) -> dict:
    """What each wrapper counted since the last reset: launches, by shape,
    by instance, plain versions run on the card."""
    return {n: {"launches": fn.counts.launches,
                "by_shape": dict(fn.counts.by_shape),
                "by_instance": dict(fn.counts.by_instance),
                "plain_cuda_calls": fn.counts.plain_cuda_calls}
            for n, fn in KERNELS.items()}


def seq_prefill_rank(torch, rank, work, cfg, rules, whole, local, tokens,
                     specs) -> None:
    """Step 18 once more under ``serve_seq_shard``: the hidden states
    between blocks are this rank's 128 of the prompt's 512 rows, each
    block gathers the sequence and reduce-scatters its output (decode's
    one token takes none). bf16 (counted), then f32; the logits gathered
    to rank 0 (``rank0_seq.pt``), each rank's counts in
    ``rank{rank}_seq.json``."""
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models.api import build_model
    tp = DIST_MESH[1]
    mesh = rules.mesh
    dist = rules.dist_ctx()
    dist["seq_shard"] = True
    dist["param_specs"] = specs
    spmd = dist["spmd"]
    model = build_model(cfg, pad_for_tp=tp, dist=dist)
    cache = whole.init_cache(B, PROMPT + DECODE_STEPS)
    cache = shard_tree(cache, rules.cache_specs(cache), mesh)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = lm_run(model, local, tokens, cache)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts(KERNELS)
    collectives = spmd.counts.as_dict()
    with torch.no_grad():
        full = [spmd._all_gather(o, o.dim() - 1, "model") for o in outs]
        cfg32 = f32_config(cfg)
        model32 = build_model(cfg32, pad_for_tp=tp, dist=dist)
        cache32 = build_model(cfg32, pad_for_tp=tp).init_cache(
            B, PROMPT + DECODE_STEPS)
        cache32 = shard_tree(cache32, rules.cache_specs(cache32), mesh)
        full32 = [spmd._all_gather(o, o.dim() - 1, "model") for o in lm_run(
            model32, tree_map(lambda t: t.float(), local), tokens, cache32)]
    torch.cuda.synchronize()
    if rank == 0:
        torch.save({"outs": [o.float().cpu() for o in full],
                    "outs32": [o.cpu() for o in full32]},
                   work / "rank0_seq.pt")
    (work / f"rank{rank}_seq.json").write_text(json.dumps({
        "rank": rank, "seconds": seconds, "collectives": collectives,
        "counts": counts}))


def layout_opt_cfg():
    from repro_torch.training.optimizer import AdamWConfig
    return AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)


def spec_at(specs, path: str):
    """The spec at a ``tree_paths`` path of a tree of specs."""
    for k in path.split("/"):
        specs = specs[int(k)] if isinstance(specs, list) else specs[k]
    return specs


class GradSpy:
    """Inside the ``with`` block, the gradients ``make_train_step`` hands
    AdamW (after the data-parallel sync) are kept in ``grads``."""

    def __enter__(self):
        from repro_torch.training import train_step
        self._mod, self._update = train_step, train_step.adamw_update

        def spy(params, grads, *args, **kwargs):
            self.grads = grads
            return self._update(params, grads, *args, **kwargs)
        train_step.adamw_update = spy
        return self

    def __exit__(self, *exc):
        self._mod.adamw_update = self._update


def layout_errors(torch, spmd, specs, grads, new, ref) -> dict:
    """The f32 step's gradients and new parameters gathered whole (every
    rank takes part; ``ref`` on rank 0 only) against the unsharded step's
    (``SPMD_TOL``): the largest |difference| of a gradient over the
    largest gradient, of a new parameter whose gradient passes
    ``TRAIN_G_FLOOR`` of its leaf's scale over the largest parameter, and
    of any new parameter (absolute)."""
    def whole(t, spec):
        for i, e in enumerate(spec):
            if e is not None:
                t = spmd._all_gather(t, i, e)
        return t
    g_err = p_err = p_far = 0.0
    if ref is not None:
        g_top = max(float(g.abs().max()) for g in ref["grads"].values())
        p_top = max(float(p.abs().max()) for p in ref["new"].values())
        floor = TRAIN_NOISE_FLOOR * g_top
    with torch.no_grad():
        for (path, g), (_, p) in zip(tree_paths(grads), tree_paths(new)):
            spec = spec_at(specs, path)
            g, p = whole(g, spec), whole(p, spec)
            if ref is None:
                continue
            rg, rp = ref["grads"][path].cuda(), ref["new"][path].cuda()
            g_err = max(g_err, float((g - rg).abs().max()) / g_top)
            d = (p - rp).abs()
            sure = rg.abs() > TRAIN_G_FLOOR * max(float(rg.abs().max()),
                                                  floor)
            if sure.any():
                p_err = max(p_err, float(d[sure].max()) / p_top)
            p_far = max(p_far, float(d.max()))
    return {"grad_rel_err": g_err, "new_params_sure_rel_err": p_err,
            "new_params_any_abs_err": p_far}


def layout_rank(torch, tdist, rank: int, work: Path) -> list:
    """This rank's steps of the layouts (``LAYOUTS``) on the (2, 2) mesh:
    smollm-135m at full width, ``LAYOUT_LAYERS`` of its layers, params
    drawn whole from seed 0
    and cut to this rank's shards, its rows of the seeded batch, one
    ``make_train_step`` step (the dry-run's accum for the cut cell, remat
    "full", q_chunk 1024) under ``FlopCounterMode`` with the kernels' and
    the ``Spmd``'s counts reset just before it; every layout in f32, then
    in bf16. A record a step: seconds, FLOPs, collectives, peak memory,
    loss, grad_norm, launches; in f32 the gradients and new parameters
    against the unsharded step (``layout_errors``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step

    mesh = init_device_mesh("cpu", LAYOUT_MESH,
                            mesh_dim_names=("data", "model"))
    tokens = torch.load(work / "inputs.pt")["layout_tokens"]
    ref = torch.load(work / "layout_ref.pt") if rank == 0 else None
    opt_cfg = layout_opt_cfg()
    out = []
    for dtype in ("float32", "bfloat16"):
        for name, flags in LAYOUTS.items():
            opts = {f.lstrip("-"): True for f in flags}
            cfg = get_config(TRAIN_ARCH).replace(n_layers=LAYOUT_LAYERS)
            if dtype == "float32":
                cfg = f32_config(cfg)
            whole = build_model(cfg, pad_for_tp=LAYOUT_PAD)
            params = whole.init_params(0)     # the same on every rank
            rules = ShardingRules(
                whole.cfg, mesh, no_fsdp=opts.get("no_fsdp", False),
                dp_only=opts.get("dp_only", False),
                mlp_fsdp=opts.get("mlp_fsdp", False)).for_batch(LAYOUT_BATCH)
            dist = rules.dist_ctx()
            dist["seq_shard"] = not opts.get("no_seq_shard")
            dist["param_specs"] = specs = rules.param_specs(params)
            local = shard_tree(params, specs, mesh)
            del params, whole
            model = build_model(cfg, pad_for_tp=LAYOUT_PAD, dist=dist)
            spmd = dist["spmd"]
            nd, rd = spmd.size(rules.dp), spmd.rank(rules.dp)
            n = LAYOUT_BATCH // nd
            batch = {"tokens": tokens[rd * n:(rd + 1) * n].cuda()}
            accum = max(1, min(16, LAYOUT_BATCH // rules._dp_size))
            step = make_train_step(model, opt_cfg, q_chunk=TRAIN_Q_CHUNK,
                                   remat="full", accum=accum)
            opt = adamw_init(local, opt_cfg)
            free_card(torch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tdist.barrier()
            reset_counts()
            spmd.counts.reset()
            t0 = time.perf_counter()
            with GradSpy() as spy, FlopCounterMode(display=False) as fc:
                new, _, met = step(local, opt, batch)
                torch.cuda.synchronize()
            rec = {"layout": name, "dtype": dtype, "rank": rank,
                   "coord": spmd.coord, "accum": accum,
                   "seconds": time.perf_counter() - t0,
                   "flops": float(fc.get_total_flops()),
                   "collectives": spmd.counts.as_dict(),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "loss": float(met["loss"]),
                   "grad_norm": float(met["grad_norm"]),
                   "seq_rows": sorted(spmd.seq_rows),
                   "counts": kernel_counts(KERNELS)}
            if dtype == "float32":
                rec.update(layout_errors(torch, spmd, specs, spy.grads, new,
                                         ref))
            out.append(rec)
            del local, opt, new, spy, model, dist, step
            free_card(torch)
    return out


def free_tcp_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_phase(torch, failures, dry_dir: Path) -> dict:
    """Step 18: qwen2-moe-a2.7b at its published width (4 of 24 layers,
    bf16, seed 0) on four ranks of the card, a (1, 4) mesh over gloo:
    each rank holds 4 heads and 15 experts, prefills 512 tokens at batch
    4 and decodes 4 steps. Held against the same layers run unsharded on
    the card (``DIST_TOL``); layer 0's ``moe_ep`` in f32 against
    ``moe_capacity`` (``EP_TOL``). Then the same under
    ``serve_seq_shard``, held to the same unsharded logits, and the
    layouts (``layout_report``). Returns {path: (launches, launches by
    instance)} for the paths "dist", "dist_seq" and "layouts", summed over
    the ranks."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import moe_capacity

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    cfg = get_config(MOE_ARCH).replace(n_layers=DIST_LAYERS)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT + DECODE_STEPS),
                           generator=g)
    h = torch.randn((B, PROMPT, cfg.d_model), generator=g) * 0.5
    model = build_model(cfg)
    params = model.init_params(0)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = [o.float().cpu() for o in lm_run(
            model, params, tokens.cuda(),
            model.init_cache(B, PROMPT + DECODE_STEPS))]
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        model32 = build_model(f32_config(cfg))
        ref32 = [o.cpu() for o in lm_run(
            model32, tree_map(lambda t: t.float(), params), tokens.cuda(),
            model32.init_cache(B, PROMPT + DECODE_STEPS))]
        del model32
        lp = moe_layer0_f32(params)
        ref_ep, ref_aux = moe_capacity(
            lp, h.cuda(), cfg.n_experts_active,
            norm_topk=cfg.router_norm_topk, act=cfg.mlp_act,
            n_valid=cfg.n_experts)
        ref_ep, ref_aux = ref_ep.cpu(), float(ref_aux)
    del model, params, lp
    free_card(torch)
    layout_tokens = torch.randint(0, get_config(TRAIN_ARCH).vocab_size,
                                  (LAYOUT_BATCH, TRAIN_SEQ), generator=g)
    t0 = time.perf_counter()
    layout_ref = layout_reference(torch, work, layout_tokens)
    layout_ref_s = time.perf_counter() - t0
    torch.save({"tokens": tokens, "h": h, "layout_tokens": layout_tokens},
               work / "inputs.pt")
    port = free_tcp_port()
    world = math.prod(DIST_MESH)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-rank",
         str(r), "--dist-work", str(work), "--dist-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode:
            errs.append(err[-2000:])
    ranks_s = time.perf_counter() - t0
    if errs:
        failures.append(f"dist: a rank failed: {errs[0]}")
        return {}
    got = torch.load(work / "rank0.pt")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(world)]
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got["outs"], ref)]
    rows = [((a - b).abs().amax(-1) / b.abs().amax(-1)).flatten()
            for a, b in zip(got["outs"], ref)]
    median = [float(r.median()) for r in rows]
    errs32 = [float((a - b).abs().max() / b.abs().max())
              for a, b in zip(got["outs32"], ref32)]
    ep_err = float((got["ep"] - ref_ep).abs().max() / ref_ep.abs().max())
    # launches: the sum over the ranks; by instance and by shape too
    launches, by_inst, by_shape = sum_counts(
        [r["counts"] for r in ranks], DENSE_PATH, "dist", failures)
    PATH_SHAPES[PATH_MODELS["dist"]] = {n: by_shape[n] for n in DENSE_PATH
                                        if n in by_shape}
    emit({"dist_serving": {
        "model": cfg.name, "layers": DIST_LAYERS, "mesh": list(DIST_MESH),
        "axes": ["data", "model"], "backend": "gloo", "ranks": world,
        "batch": B, "prompt": PROMPT, "decode_steps": DECODE_STEPS,
        "local_heads": [r["local_heads"] for r in ranks],
        "local_experts": [r["local_experts"] for r in ranks],
        "logits_rel_err": errs, "logits_median_row_rel_err": median,
        "tol_median": DIST_TOL, "logits_f32_rel_err": errs32,
        "tol_f32": DIST_TOL_F32,
        "ep_f32_rel_err": ep_err, "ep_tol": EP_TOL,
        "aux_f32": [float(got["aux"]), ref_aux],
        "unsharded_s": whole_s, "ranks_wall_s": ranks_s,
        "rank_run_s": [r["seconds"] for r in ranks],
        "rank_peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
        "collectives_per_rank": ranks[0]["collectives"],
        "launches": {n: launches.get(n, 0) for n in DENSE_PATH},
        "launches_by_shape_per_rank": [
            {n: r["counts"][n]["by_shape"] for n in
             ("flash_attention", "decode_attention")} for r in ranks]}})
    if not all(math.isfinite(e) and e <= DIST_TOL for e in median):
        failures.append(f"dist: bf16 logits of the four ranks off the "
                        f"unsharded run by {median} (median over positions "
                        f"of a position's largest |logit|), past {DIST_TOL}")
    if not all(math.isfinite(e) and e <= DIST_TOL_F32 for e in errs32):
        failures.append(f"dist: f32 logits of the four ranks off the "
                        f"unsharded run by {errs32} (of the largest "
                        f"|logit|), past {DIST_TOL_F32}")
    if not (math.isfinite(ep_err) and ep_err <= EP_TOL):
        failures.append(f"dist: moe_ep off moe_capacity in f32 by {ep_err}, "
                        f"past {EP_TOL}")
    paths = {"dist": ({n: launches.get(n, 0) for n in DENSE_PATH},
                      {n: v for n, v in by_inst.items() if n in DENSE_PATH})}
    paths["dist_seq"] = seq_prefill_report(torch, failures, work, ref, ref32,
                                           world)
    paths["layouts"] = layout_report(failures, work, world, dry_dir,
                                     layout_ref, layout_ref_s, ranks_s)
    return paths


def sum_counts(records, names, path, failures):
    """Launches (by kernel), launches by instance and by shape summed over
    ``records`` (each a ``kernel_counts``); a plain version on the card
    fails."""
    launches, by_inst, by_shape = {}, {}, {}
    for rec in records:
        for n, c in rec.items():
            launches[n] = launches.get(n, 0) + c["launches"]
            for key, per in (("by_instance", by_inst),
                             ("by_shape", by_shape)):
                for i, k in c[key].items():
                    per.setdefault(n, {})
                    per[n][i] = per[n].get(i, 0) + k
            if c["plain_cuda_calls"]:
                failures.append(f"{path}: plain {n} on the card")
    for n in names:
        if not launches.get(n):
            failures.append(f"{n}: no launch on the {path} path")
    return launches, by_inst, by_shape


def seq_prefill_report(torch, failures, work, ref, ref32, world):
    """Step 18 under ``serve_seq_shard`` against the unsharded logits:
    the ``dist_seq_prefill`` line; (launches, by instance) of its bf16
    run."""
    got = torch.load(work / "rank0_seq.pt")
    ranks = [json.loads((work / f"rank{r}_seq.json").read_text())
             for r in range(world)]
    rows = [((a - b).abs().amax(-1) / b.abs().amax(-1)).flatten()
            for a, b in zip(got["outs"], ref)]
    median = [float(r.median()) for r in rows]
    errs32 = [float((a - b).abs().max() / b.abs().max())
              for a, b in zip(got["outs32"], ref32)]
    launches, by_inst, by_shape = sum_counts(
        [r["counts"] for r in ranks], DENSE_PATH, "dist_seq", failures)
    PATH_SHAPES[PATH_MODELS["dist_seq"]] = {n: by_shape[n] for n in DENSE_PATH
                                            if n in by_shape}
    emit({"dist_seq_prefill": {
        "model": MOE_ARCH, "layers": DIST_LAYERS, "mesh": list(DIST_MESH),
        "serve_seq_shard": True, "prompt_rows_per_rank": PROMPT
        // DIST_MESH[1], "logits_median_row_rel_err": median,
        "tol_median": DIST_TOL, "logits_f32_rel_err": errs32,
        "tol_f32": DIST_TOL_F32, "rank_run_s": [r["seconds"] for r in ranks],
        "collectives_per_rank": ranks[0]["collectives"],
        "launches": {n: launches.get(n, 0) for n in DENSE_PATH}}})
    if not all(math.isfinite(e) and e <= DIST_TOL for e in median):
        failures.append(f"dist seq_shard: bf16 logits off the unsharded run "
                        f"by {median} (median over positions), past "
                        f"{DIST_TOL}")
    if not all(math.isfinite(e) and e <= DIST_TOL_F32 for e in errs32):
        failures.append(f"dist seq_shard: f32 logits off the unsharded run "
                        f"by {errs32}, past {DIST_TOL_F32}")
    if not ranks[0]["collectives"]["counts"].get("reduce-scatter"):
        failures.append("dist seq_shard: no reduce-scatter: the prefill ran "
                        "without sequence parallelism")
    return ({n: launches.get(n, 0) for n in DENSE_PATH},
            {n: v for n, v in by_inst.items() if n in DENSE_PATH})


def layout_reference(torch, work: Path, tokens) -> dict:
    """The layouts' step run unsharded on the card from the same seed-0
    parameters and batch (4 microbatches of one sequence: the shapes of
    the layouts' kernel calls), in f32 (its gradients and new parameters
    saved to ``layout_ref.pt`` for rank 0) and in bf16: {dtype: loss,
    grad_norm, seconds}."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    opt_cfg = layout_opt_cfg()
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(TRAIN_ARCH).replace(n_layers=LAYOUT_LAYERS)
        if dtype == "float32":
            cfg = f32_config(cfg)
        model = build_model(cfg, pad_for_tp=LAYOUT_PAD)
        params = model.init_params(0)
        step = make_train_step(model, opt_cfg, q_chunk=TRAIN_Q_CHUNK,
                               remat="full", accum=LAYOUT_BATCH)
        t0 = time.perf_counter()
        with GradSpy() as spy:
            new, _, met = step(params, adamw_init(params, opt_cfg),
                               {"tokens": tokens.cuda()})
            torch.cuda.synchronize()
        out[dtype] = {"loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "seconds": time.perf_counter() - t0}
        if dtype == "float32":
            torch.save({"grads": {p: g.cpu() for p, g in
                                  tree_paths(spy.grads)},
                        "new": {p: t.cpu() for p, t in tree_paths(new)}},
                       work / "layout_ref.pt")
        del model, params, step, spy, new
        free_card(torch)
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def layout_report(failures, work: Path, world: int, dry_dir: Path, ref,
                  ref_s: float, ranks_s: float):
    """The layouts' records of the four ranks: a ``dist_layouts`` line a
    layout. f32 is held to the unsharded step (``SPMD_TOL``), bf16's loss
    to the unsharded bf16 step's (``LAYOUT_BF16_TOL``); each rank's FLOPs
    and collectives (calls, and in bf16 bytes, by kind) must equal the
    dry-run's for the same cut cell and flags exactly, its peak memory
    beside the dry-run's. Every f32 launch must be at an instance and
    shape an f32 kernel row checked. Returns (launches, by instance) of
    the bf16 steps (the counted path)."""
    recs = [r for k in range(world) for r in json.loads(
        (work / f"layouts_rank{k}.json").read_text())]
    counted, f32_counts = [], []
    for name, flags in LAYOUTS.items():
        art = dryrun_artifact(dry_dir, TRAIN_ARCH, "train_4k", "2x2",
                              f"layout_{name}")
        mine = {d: sorted((r for r in recs if r["layout"] == name
                           and r["dtype"] == d), key=lambda r: r["rank"])
                for d in ("float32", "bfloat16")}
        f32, bf16 = mine["float32"][0], mine["bfloat16"][0]
        counted += [r["counts"] for r in mine["bfloat16"]]
        f32_counts += [r["counts"] for r in mine["float32"]]
        errs = {"loss": rel(f32["loss"], ref["float32"]["loss"]),
                "grad_norm": rel(f32["grad_norm"],
                                 ref["float32"]["grad_norm"]),
                **{k: f32[k] for k in ("grad_rel_err",
                                       "new_params_sure_rel_err",
                                       "new_params_any_abs_err")}}
        bf16_err = rel(bf16["loss"], ref["bfloat16"]["loss"])
        dry = ({"flops": art["flops_per_device"],
                "collectives": art["collectives_per_device"],
                "peak_gb": art["peak_bytes_per_device"] / 1e9,
                "accum": art["accum"]} if art.get("status") == "ok"
               else {"status": art.get("status")})
        emit({"dist_layouts": {
            "layout": name, "flags": flags, "model": TRAIN_ARCH,
            "mesh": list(LAYOUT_MESH), "global_batch": LAYOUT_BATCH,
            "layers": LAYOUT_LAYERS,
            "seq": TRAIN_SEQ, "heads_padded_for": LAYOUT_PAD,
            "accum": f32["accum"], "seq_rows": f32["seq_rows"],
            "f32": {**errs, "loss_value": f32["loss"],
                    "rank_s": [r["seconds"] for r in mine["float32"]]},
            "bf16": {"loss_rel_err": bf16_err, "loss_value": bf16["loss"],
                     "rank_s": [r["seconds"] for r in mine["bfloat16"]]},
            "flops_per_rank": [r["flops"] for r in mine["bfloat16"]],
            "collectives_per_rank": bf16["collectives"],
            "f32_collectives_per_rank": f32["collectives"],
            "peak_memory_gb_per_rank": {
                d: [r["peak_memory_gb"] for r in mine[d]] for d in mine},
            "dryrun": dry, "unsharded": ref, "unsharded_s": ref_s,
            "ranks_wall_s": ranks_s}})
        bad = {k: v for k, v in errs.items()
               if k != "new_params_any_abs_err"
               and not (math.isfinite(v) and v <= SPMD_TOL)}
        if not (errs["new_params_any_abs_err"]
                <= 2 * TRAIN_LR + SPMD_TOL):
            bad["new_params_any_abs_err"] = errs["new_params_any_abs_err"]
        if bad:
            failures.append(f"layout {name} f32 off the unsharded step: "
                            f"{bad}")
        if not (math.isfinite(bf16_err) and bf16_err <= LAYOUT_BF16_TOL):
            failures.append(f"layout {name} bf16 loss off the unsharded "
                            f"step's by {bf16_err}")
        if "flops" not in dry:
            failures.append(f"layout {name}: no dry-run artifact ({dry})")
            continue
        want = dry["collectives"]
        for d, rs in mine.items():
            for r in rs:
                got = r["collectives"]
                same = (r["flops"] == dry["flops"]
                        and got["counts"] == want["counts"]
                        and (d == "float32"
                             or got["bytes_by_op"] == want["bytes_by_op"]))
                if not same:
                    failures.append(
                        f"layout {name} {d} rank {r['rank']}: FLOPs "
                        f"{r['flops']} and collectives {got} against the "
                        f"dry-run's {dry['flops']} and {want}")
    launches, by_inst, by_shape = sum_counts(counted, TRAIN_PATH, "layouts",
                                             failures)
    PATH_SHAPES[PATH_MODELS["layouts"]] = {n: by_shape[n] for n in TRAIN_PATH
                                           if n in by_shape}
    fa = by_inst.get("flash_attention", {})
    if fa.get("tensor_core", 0) != launches.get("flash_attention"):
        failures.append(f"layouts: bf16 flash launches by instance {fa}, "
                        f"not all tensor_core")
    _, _, f32_shapes = sum_counts(f32_counts, (), "layouts f32", failures)
    for n, per in f32_shapes.items():
        for key, k in per.items():
            if (n, key) not in F32_CHECKED:
                failures.append(f"{n}: {k} f32 launches at {key} on the "
                                f"layouts path, a shape no f32 row checks")
    return ({n: launches.get(n, 0) for n in TRAIN_PATH},
            {n: v for n, v in by_inst.items() if n in TRAIN_PATH})


def roofline_inputs(torch, model, cell, seed: int = 0) -> dict:
    """A cut cell's batch on the card, in ``input_specs``' layout: tokens
    drawn from ``seed``, an empty cache of the cell's length."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = {}
    for k, v in model.input_specs(cell).items():
        if k == "cache":
            out[k] = model.init_cache(cell.global_batch, cell.seq_len)
        else:
            out[k] = torch.randint(0, model.cfg.vocab_size, tuple(v.shape),
                                   generator=g, device="cuda",
                                   dtype=v.dtype)
    return out


def roofline_phase(torch, failures, dry_dir: Path) -> dict:
    """Step 20: smollm-135m at full width and depth through
    ``build_model(..., dist=<1 x 1 mesh>)`` on the roofline cells
    (``ROOF_CELLS``). For each: ``FlopCounterMode`` on the card's run
    must equal the dry-run's FLOPs a device for the same cut cell at
    mesh 1 x 1; the dry-run's peak bytes beside
    ``torch.cuda.max_memory_allocated`` (less what was allocated before
    the phase); the step's device seconds
    (CUDA events, median of ``ROOF_REPS``) and the model-FLOP share
    ``model_flops / (989e12 s)`` beside the roofline row's predicted
    ``roofline_fraction``. Returns (launches, launches by instance) of
    the timed runs."""
    import dataclasses
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.launch.roofline import PEAK_FLOPS as H100_FLOPS
    from repro_torch.launch.roofline import roofline_row
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    # what earlier phases left on the card is no part of a cell's bytes
    base = torch.cuda.memory_allocated()
    tdist.init_process_group("gloo", world_size=1, rank=0,
                             init_method=f"tcp://localhost:"
                                         f"{free_tcp_port()}")
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config(TRAIN_ARCH)
        rules = ShardingRules(cfg, mesh)
        dist = rules.dist_ctx()
        model = build_model(cfg, dist=dist)
        params = model.init_params(0)
        dist["param_specs"] = rules.param_specs(params)
        reset_counts()
        rows = {}
        for shape, extra in ROOF_CELLS.items():
            cell = dataclasses.replace(shape_by_name(shape),
                                       global_batch=extra["global_batch"])
            art = dryrun_artifact(dry_dir, TRAIN_ARCH, shape, "unit",
                                  "roofline")
            if art.get("status") != "ok":
                failures.append(f"roofline {shape}: no dry-run artifact "
                                f"({art.get('error', art.get('status'))})")
                continue
            batch = roofline_inputs(torch, model, cell)
            if cell.kind == "train":
                opt_cfg = AdamWConfig()
                opt = adamw_init(params, opt_cfg)
                step = make_train_step(model, opt_cfg,
                                       q_chunk=extra["q_chunk"],
                                       remat=extra["remat"],
                                       accum=extra["accum"])

                def run(opt=opt, step=step, batch=batch):
                    return step(params, opt, batch)
                grad = torch.enable_grad
            else:
                opt = None
                q_chunk = extra.get("q_chunk", 0)

                def run(batch=batch, kind=cell.kind, q_chunk=q_chunk):
                    if kind == "prefill":
                        return model.prefill(params, batch, q_chunk=q_chunk)
                    return model.decode_step(params, batch)
                grad = torch.no_grad
            with grad():
                with FlopCounterMode(display=False) as fc:
                    out = run()
                del out
                torch.cuda.synchronize()
                flops = float(fc.get_total_flops())
                times = []
                for _ in range(ROOF_REPS + 1):       # the first warms up
                    free_card(torch)
                    torch.cuda.reset_peak_memory_stats()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = run()
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b) / 1e3)
                    peak = torch.cuda.max_memory_allocated() - base
                    del out
            del batch, opt
            free_card(torch)
            sec = statistics.median(times[1:])
            row = roofline_row(art)
            mf = model.model_flops(cell)
            rows[shape] = {
                "cell": shape, "cut": extra, "flops_card": flops,
                "flops_dryrun": art["flops_per_device"],
                "flops_equal": flops == art["flops_per_device"],
                "peak_bytes_card": peak,
                "peak_bytes_dryrun": art["peak_bytes_per_device"],
                "peak_ratio_dryrun_over_card":
                    art["peak_bytes_per_device"] / peak,
                "device_s": times[1:], "median_s": sec,
                "model_flops": mf,
                "model_flop_share": mf / (H100_FLOPS * sec),
                "counted_flop_share": flops / (H100_FLOPS * sec),
                "roofline_fraction": row["roofline_fraction"],
                "roofline_dominant": row["dominant"],
                "roofline_terms_s": {k: row[f"t_{k}_s"] for k in
                                     ("compute", "memory", "collective")}}
            emit({"roofline": rows[shape]})
            if flops != art["flops_per_device"]:
                failures.append(f"roofline {shape}: FLOPs counted on the "
                                f"card {flops:.6e} != dry-run "
                                f"{art['flops_per_device']:.6e}")
        launches = path_counts(KERNELS, DENSE_PATH,
                               PATH_MODELS["roofline"], failures)
        inst = {n: dict(KERNELS[n].counts.by_instance) for n in DENSE_PATH
                if KERNELS[n].counts.by_instance}
        del model, params
        free_card(torch)
        return launches, inst
    finally:
        tdist.destroy_process_group()


def slice12_paths(torch, failures, seconds, peaks, dry_dir) -> dict:
    """Steps 18 and 20 (step 19's dry-runs have ended), each freed before
    the next; {path: (launches, launches by instance)}."""
    paths = {}
    free_card(torch)
    with timed_phase(torch, "dist_path", seconds, peaks):
        paths.update(dist_phase(torch, failures, dry_dir))
    free_card(torch)
    with timed_phase(torch, "roofline_path", seconds, peaks):
        paths["roofline"] = roofline_phase(torch, failures, dry_dir)
    free_card(torch)
    return paths


@contextlib.contextmanager
def timed_phase(torch, name, seconds, peaks):
    """Records a phase's wall seconds and its peak of allocated card memory
    under ``name``."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    peaks[name] = torch.cuda.max_memory_allocated() / 1e9


def lm_paths(torch, failures, seconds, peaks) -> dict:
    """Steps 9-11, each freed before the next; {path: (launches, launches
    by instance)}."""
    paths = {}
    for key, run in (("moe", moe_phase), ("hybrid", hybrid_phase),
                     ("int8", int8_phase)):
        free_card(torch)              # the model of the phase before
        with timed_phase(torch, f"{key}_path", seconds, peaks):
            paths[key] = run(torch, failures)
    free_card(torch)
    return paths


def free_card(torch) -> None:
    """Return the memory of a phase's model to the card: a served model
    stays reachable from the server's reference cycles until the
    collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def drill_plan(cfg, drill: str):
    """``cfg`` with ``drill``'s events (``DRILLS``) through the entry
    point's own calls."""
    for kind, t_ms, arg in DRILLS[drill]:
        if kind == "reconfigure":
            cfg = cfg.reconfigure_at(t_ms, **arg)
        elif kind == "fail_context":
            cfg = cfg.fail_context_at(arg, t_ms)
        else:
            cfg = cfg.scale_out_at(t_ms)
    return cfg


def drill_specs(torch, arch: str) -> dict:
    """``arch``'s HP and LP tasks as its serving phase builds them
    (ResNet18: Table II's rate, 224 x 224, batch 1, f32; smollm-135m: full
    width and depth, bf16, decode batch 4 after a 512-token prompt, 4
    stages, random weights from seed 0), with launch counts reset just
    before they are built."""
    from repro_torch.kernels import reset_counts
    torch.cuda.reset_peak_memory_stats()
    if arch in CNN_WIDTHS:
        from repro_torch.models import BUILDERS
        from repro_torch.serving.requests import TABLE2
        jps = TABLE2[arch][2]
        model = BUILDERS[arch](width=CNN_WIDTHS[arch])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        specs = cnn_specs(model, jps)
        return {"specs": specs, "jps": jps, "kernels": (), "input_hw": CNN_HW,
                "setup_s": time.perf_counter() - t0,
                "desc": {"width": CNN_WIDTHS[arch], "input_hw": CNN_HW,
                         "batch": CNN_BATCH, "stages": len(specs[0].stages)}}
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init_params(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    specs = lm_specs(model, params, JPS)
    return {"specs": specs, "jps": JPS, "kernels": DRILL_PATH,
            "input_hw": None, "setup_s": time.perf_counter() - t0,
            "desc": {"layers": cfg.n_layers, "d_model": cfg.d_model,
                     "batch": B, "prompt_len": PROMPT, "stages": N_STAGES}}


def stage_programs(spec) -> list:
    """The stage programs behind a task's payloads (an LM payload's
    ``program`` keyword, or the CNN payload itself)."""
    import functools
    return [st.payload.keywords["program"]
            if isinstance(st.payload, functools.partial) else st.payload
            for st in spec.stages]


def drop_stage_graphs(torch, specs) -> None:
    """Forget the graphs the tasks' stage programs hold (and with them
    their lanes and pools), so that the next server starts as a fresh one
    would, whatever stream handles PyTorch hands out again."""
    torch.cuda.synchronize()
    for spec in specs:
        for prog in stage_programs(spec):
            prog._lanes.clear()
    free_card(torch)


class DrillRecorder:
    """Put on a built server (``serve``'s ``prepare``): a mark as the
    clock starts, at each of the drill's events (the scheduler's
    ``reconfigure``, ``fail_context`` and ``add_context``) and at
    ``stop``: the backend's clock, the live lanes, the lane streams made,
    the stage programs' graph counts (``_lib.stage_graphs``), the caching
    allocator's driver calls, ``rewarm`` and the lane warm-ups' host and
    capture seconds since the clock started. Each completed HP job's
    release, response and miss; at each lane's first launch, how many
    live lanes share a stream handle with another."""

    def __init__(self, torch, srv) -> None:
        from repro_torch.api import HP
        from repro_torch.kernels import _lib
        be, sched = srv.backend, srv.core.sched
        self.torch, self.be, self.sched = torch, be, sched
        self.graphs = _lib.stage_graphs
        self.marks, self.hp, self.seen, self.shared = [], [], set(), 0
        self.warm = {"s": 0.0, "capture_s": 0.0}
        for name, kind in (("reconfigure", "reconfigure"),
                           ("fail_context", "fail_context"),
                           ("add_context", "scale_out")):
            def event(*a, fn=getattr(sched, name), kind=kind, **k):
                out = fn(*a, **k)
                self.marks.append(self.mark(kind))
                return out
            setattr(sched, name, event)
        # the lane warm-ups: the tree's streams, or a tree before their
        # reuse warming lanes
        wname = ("_warm_streams" if hasattr(be, "_warm_streams")
                 else "_warm_lanes")
        warm, start, stop = getattr(be, wname), be.start, be.stop
        launch, job_done = be.launch, be.on_job_done

        def warmed(new):
            if not be._t0:                  # before the clock starts
                return warm(new)
            g0, t0 = self.graphs.snapshot(), time.perf_counter()
            try:
                return warm(new)
            finally:
                self.warm["s"] += time.perf_counter() - t0
                self.warm["capture_s"] += (self.graphs.snapshot()["capture_s"]
                                           - g0["capture_s"])

        def started():
            start()
            self.marks.append(self.mark("start"))

        def stopped():
            self.marks.append(self.mark("end"))
            stop()

        def launched(lane, inst):
            launch(lane, inst)
            if lane not in self.seen:
                self.seen.add(lane)
                alive = self.sched.contexts
                held = [st.cuda_stream for ln, st in be._streams.items()
                        if alive[ln[0]].alive]
                self.shared = max(self.shared, len(held) - len(set(held)))

        def done(job):
            job_done(job)
            if (job.task.priority == HP and not job.cancelled
                    and job.finish_ms is not None and job.is_last_stage()):
                for r in job.release_times:
                    self.hp.append((r, job.finish_ms - r,
                                    job.finish_ms > job.abs_deadline_ms))
        setattr(be, wname, warmed)
        be.start, be.stop, be.launch, be.on_job_done = (started, stopped,
                                                        launched, done)

    def mark(self, kind: str) -> dict:
        be = self.be
        return {"kind": kind, "t_ms": be.now_ms(),
                "live_lanes": len(be._live_lanes()),
                "lanes_launched": len(self.seen),
                "streams": len(getattr(be, "_slots", be._streams)),
                "graphs": self.graphs.snapshot(),
                "alloc": allocator_counts(self.torch),
                "rewarm": dict(be.rewarm), "warm": dict(self.warm)}

    def report(self) -> dict:
        """Each event, from its mark to the next: the engine thread's stop
        (the warm-ups' host seconds and the captures outside them),
        ``rewarm``, captures, replays, lanes first launched, streams and
        pools made, the
        allocator's driver calls; the HP jobs released in the
        ``DRILL_WINDOW_MS`` after it (count, misses, maximum response)
        against the HP jobs released away from every event."""
        def delta(a, b, *keys):
            for k in keys[:-1]:
                a, b = a[k], b[k]
            return b[keys[-1]] - a[keys[-1]]
        events = []
        windows = []
        for a, b in zip(self.marks[1:-1], self.marks[2:]):
            t = a["t_ms"]
            windows.append((t, t + DRILL_WINDOW_MS))
            after = [j for j in self.hp if t <= j[0] < t + DRILL_WINDOW_MS]
            capture_s = delta(a, b, "graphs", "capture_s")
            warm_s = delta(a, b, "warm", "s")
            events.append({
                "kind": a["kind"], "t_ms": t, "live_lanes": a["live_lanes"],
                "engine_stop_s": warm_s + capture_s
                - delta(a, b, "warm", "capture_s"),
                "rewarm_count": delta(a, b, "rewarm", "count"),
                "rewarm_s": delta(a, b, "rewarm", "s"),
                "captures": delta(a, b, "graphs", "captures"),
                "capture_s": capture_s,
                "replays": delta(a, b, "graphs", "replays"),
                "lanes_first_launched": delta(a, b, "lanes_launched"),
                "streams_made": delta(a, b, "streams"),
                "pools_made": delta(a, b, "graphs", "pools"),
                "driver_allocs": delta(a, b, "alloc", "num_device_alloc"),
                "alloc_retries": delta(a, b, "alloc", "num_alloc_retries"),
                "hp_jobs_after": len(after),
                "hp_missed_after": sum(j[2] for j in after),
                "hp_max_after_ms": max((j[1] for j in after), default=None)})
        away = [j for j in self.hp
                if not any(lo <= j[0] < hi for lo, hi in windows)]
        return {"events": events, "hp_jobs": len(self.hp),
                "hp_missed": sum(j[2] for j in self.hp),
                "hp_max_away_ms": max((j[1] for j in away), default=None),
                "hp_jobs_away": len(away),
                "live_lanes_sharing_a_stream": self.shared}


def drill_phase(torch, failures, arch: str, repeats: int = 1):
    """Step 21, the elastic drills (``DRILLS``) served on the card: each
    drill on ``arch``'s tasks (``drill_specs``) through ``serve`` with the
    drill's plan, ``repeats`` times in turns; a ``drill`` line a run
    (``DrillRecorder.report``, with the run's streams, pools, pool GB and
    warm-up). Gates: no capture after the clock starts, a stream a lane
    of the busiest moment (``DRILL_LANES``), no two live lanes on one
    stream handle, HP misses 0; ``serve`` gates one replay a stage, the
    pools (one a stream) and no driver allocation in the run. Returns
    each drill's path (its last run's launches and launches by instance,
    keyed ``drill_<name>``) and the ``drill`` lines."""
    from repro_torch.api import HP
    from repro_torch.kernels import KERNELS, reset_counts
    built = drill_specs(torch, arch)
    paths, lines = {}, []
    for i in range(repeats):
        for k, drill in enumerate(DRILLS):
            if i or k:
                drop_stage_graphs(torch, built["specs"])
                reset_counts()
            rec = []
            desc = {"model": f"{arch}/{drill}", **built["desc"]}
            m, launches, instances, srv = serve(
                torch, failures, built["specs"], built["setup_s"],
                built["jps"], built["kernels"], desc,
                input_hw=built["input_hw"], fresh=not (i or k),
                prepare=lambda s: rec.append(DrillRecorder(torch, s)),
                plan=lambda cfg, d=drill: drill_plan(cfg, d))
            g = srv.backend.graph_summary()
            # the HP stages' calls made ready ahead, and those a drill's
            # events discarded (none in a tree from before them)
            ready = (srv.backend.ready_summary()
                     if hasattr(srv.backend, "ready_summary") else None)
            report = rec[0].report()
            name = desc["model"]
            lines.append({
                "model": name, "run": i, "drill": drill,
                "plan": [list(e) for e in DRILLS[drill]],
                **report, "streams": g.get("streams", len(
                    srv.backend._streams)),
                "captures_in_run": g["captures"],
                "pools": g["pools"], "run_pools": g["run_pools"],
                "pool_gb": g["pool_gb"], "warm_up_s": srv.backend.warm_s,
                "rewarm": srv.backend.rewarm,
                # a stop of the engine thread skips the releases it
                # overran (the arrival process re-anchors on its schedule)
                "completed_hp": m.completed[HP], "missed_hp": m.missed[HP],
                "skipped_releases": m.skipped_releases,
                "ready_used_share": ready and ready["used_share"],
                "ready_discarded": ready and {
                    r: sum(by.values()) for r, by in
                    ready["discarded"].items() if any(by.values())}})
            emit({"drill": lines[-1]})
            if g["captures"]:
                failures.append(f"{name}: {g['captures']} captures after "
                                f"the clock started")
            if g.get("streams") != DRILL_LANES[drill]:
                failures.append(f"{name}: {g.get('streams')} lane streams "
                                f"for {DRILL_LANES[drill]} lanes live at "
                                f"most")
            if report["live_lanes_sharing_a_stream"]:
                failures.append(f"{name}: live lanes shared a stream "
                                f"handle")
            if m.missed[HP] or report["hp_missed"]:
                failures.append(f"{name}: {m.missed[HP]} HP misses")
            if len(report["events"]) != len(DRILLS[drill]):
                failures.append(f"{name}: {len(report['events'])} of "
                                f"{len(DRILLS[drill])} events happened")
            if arch in CNN_WIDTHS:
                ran = {n: [fn.counts.launches, fn.counts.plain_cuda_calls]
                       for n, fn in KERNELS.items()
                       if fn.counts.launches or fn.counts.plain_cuda_calls}
                if ran:
                    failures.append(f"{name}: port kernels or their plain "
                                    f"versions ran on the CNN path: {ran}")
            else:
                paths[f"drill_{drill}"] = (launches, instances)
            del srv
    del built
    free_card(torch)
    return paths, lines


def drill_repeats(torch, arch: str, repeats: int) -> int:
    """``--drill ARCH``: only the drill phase of ``arch``, ``repeats`` times
    in this process; a ``drill_repeats`` line sums the runs up by drill
    and event. For runs of one tree against another, as ``--serve``."""
    from repro_torch.kernels import _lib
    _lib.lib()
    failures = []
    lines = drill_phase(torch, failures, arch, repeats)[1]
    summary = {}
    for drill in DRILLS:
        runs = [ln for ln in lines if ln["drill"] == drill]
        summary[drill] = {
            "runs": len(runs),
            "events": [{k: [r["events"][e][k] if e < len(r["events"])
                            else None for r in runs]
                        for k in ("kind", "engine_stop_s", "rewarm_s",
                                  "captures", "lanes_first_launched",
                                  "streams_made", "pools_made",
                                  "driver_allocs", "hp_missed_after",
                                  "hp_max_after_ms")}
                       for e in range(len(DRILLS[drill]))],
            **{k: [r[k] for r in runs]
               for k in ("streams", "captures_in_run", "run_pools",
                         "pool_gb", "warm_up_s", "completed_hp",
                         "skipped_releases", "hp_missed",
                         "hp_max_away_ms", "ready_used_share",
                         "ready_discarded")}}
    emit({"drill_repeats": {"model": arch, "repeats": repeats,
                            "failures": failures, **summary}})
    for f in failures:
        print(f"chip_smoke: FAIL {f}", file=sys.stderr)
    return 1 if failures else 0


def hp_step_medians(rows: list) -> dict:
    """Each stage's enqueue steps, the median ms of each over ``rows``
    (the backend's enqueue rows), as the backend's summary takes it."""
    out = {}
    for j in sorted({r[0] for r in rows}):
        at = [r[3] for r in rows if r[0] == j]
        names = sorted({k for steps in at for k in steps})
        out[f"s{j}"] = {k: sorted(s[k] for s in at if k in s)[
            sum(1 for s in at if k in s) // 2] for k in names}
    return out


def serve_repeats(torch, arch: str, repeats: int, trace: bool) -> int:
    """``--serve ARCH``: only ``arch``'s serving phase, ``repeats`` times
    in this process, each followed by the card's clocks, power and
    throttle reasons, the last by the profile of a decode step or of each
    CNN stage; a summary line last. For runs of one tree against
    another (copy this script into the other checkout and run it there
    too): HP misses, stage device intervals, and with ``--trace`` what
    the card did during each run."""
    from repro_torch.kernels import _lib
    _lib.lib()
    path = {"mamba2-2.7b": SSM_PATH, MLA_ARCH: MLA_PATH}.get(arch,
                                                          DENSE_PATH)
    jps = {"mamba2-2.7b": SSM_JPS, MOE_ARCH: MOE_JPS, MLA_ARCH: FAMILY_JPS,
           GEMMA_ARCH: FAMILY_JPS}.get(arch, JPS)
    depth = {MLA_ARCH: MLA_LAYERS, GEMMA_ARCH: GEMMA_LAYERS}.get(arch)
    heavy = arch in (MOE_ARCH, MLA_ARCH, GEMMA_ARCH)
    runs = []
    SERVED.clear()
    for i in range(repeats):
        failures = []
        # after the last run, where each stage's (or decode step's) time
        # goes: a ``torch.profiler`` session leaves the process's graph
        # launches slower after it (on the H100 machine a served smollm
        # stage's launch 30 -> 200 µs, its device ms a job +0.8), so no
        # run is served after one
        last = i == repeats - 1
        if arch in CNN_WIDTHS:
            spec = cnn_serving_phase(torch, failures, arch, trace=trace)
            if last:
                rows = cnn_stage_profile(torch, spec)[0]
                emit({"cnn_stage_profile": {"model": arch, "stages": rows}})
                # each stage's served device ms over its device ms alone
                # (both between the stage graph's own event nodes)
                alone = {r["stage"]: r.get("device_alone_ms") for r in rows}
                for run in SERVED:
                    run["device_vs_alone"] = {
                        k: v / alone[k] for k, v in
                        run["stage_device_ms"].items() if alone.get(k)}
        else:
            spec = serving_phase(torch, failures, arch, depth, jps, path,
                                 trace=trace,
                                 max_load=MOE_MAX_LOAD if heavy else None)[2]
            if last:
                emit({"decode_step_profile": {
                    "model": arch, **profile_step(torch, staged_step(spec)),
                    "peak_memory_gb": torch.cuda.max_memory_allocated()
                    / 1e9}})
        del spec
        free_card(torch)
        try:
            clocks = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw,temperature.gpu,clocks_throttle_reasons.active",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            clocks = repr(e)
        emit({"after_run": {"run": i, "card": clocks,
                            "failures": failures}})
        runs.append(not failures)
    hp = [r for run in SERVED for r in run["hp_response_ms"]]
    emit({"serve_repeats": {
        "model": arch, "runs": repeats, "runs_without_failure": sum(runs),
        "runs_with_hp_miss": sum(1 for run in SERVED if run["hp_missed"]),
        "hp_missed": sum(run["hp_missed"] for run in SERVED),
        "hp_completed": len(hp),
        "hp_mean_ms": statistics.fmean(hp) if hp else None,
        "hp_p99_ms": percentile(hp, 99) if hp else None,
        "hp_max_ms": max(hp) if hp else None,
        "graph_pools": [run["graph_pools"] for run in SERVED],
        # SchedCheck's static HP bound against the runs (CNNs): the runs
        # whose observed HP maximum exceeds it, and the HP jobs above it
        "hp_bound_ms": [run["hp_bound_ms"] for run in SERVED],
        "runs_over_bound": sum(
            1 for run in SERVED if run["hp_bound_ms"] is not None
            and run["hp_response_ms"]
            and max(run["hp_response_ms"]) > run["hp_bound_ms"] + 1e-6),
        "hp_jobs_over_bound": sum(
            sum(1 for r in run["hp_response_ms"]
                if r > run["hp_bound_ms"] + 1e-6)
            for run in SERVED if run["hp_bound_ms"] is not None),
        "switch_interval_s": sys.getswitchinterval(),
        # each run's LP completions; its HP stages' median enqueue (ms,
        # the stage's start to its payload enqueued), its HP jobs' prep
        # and device ms a job, and its engine stalls by step
        "lp_completed": [run["lp_completed"] for run in SERVED],
        "hp_enqueue_median_ms": [(run["hp_enqueue"] or {}).get("median")
                                 for run in SERVED],
        # its HP stages' median engine-thread ms a stage: the enqueue and
        # the output's result after it (a tree whose enqueue holds both:
        # None), and each CNN stage's served device ms over its own alone
        "hp_engine_median_ms": [run["hp_engine_median_ms"] for run in SERVED],
        "device_vs_alone": [run.get("device_vs_alone") for run in SERVED],
        "hp_prep_ms_per_job": [per_job(run, "prep") for run in SERVED],
        "hp_device_ms_per_job": [per_job(run, "device") for run in SERVED],
        "stalls_by_run": [run["stalls"] for run in SERVED],
        "over_bound": [row for run in SERVED for row in run["over_bound"]
                       or ()],
        # those jobs by their largest part and, of its stage, its largest
        # step (of a ``prep`` part: of the steps before the start event);
        # and each run's HP ``input`` step at stage 0 and at the later
        # stages (median ms)
        "over_bound_by": dict(collections.Counter(
            f"{row['part']} {row['step']}" for run in SERVED
            for row in run["over_bound"] or ())),
        "hp_input_median_ms": [run["hp_input"] for run in SERVED],
        # each run's HP prep by stage, its HP steps' median ms by stage,
        # and its calls made ready ahead: the share of HP stages that took
        # theirs, and those discarded by reason
        "hp_prep_by_stage": [run["hp_prep_by_stage"] for run in SERVED],
        "hp_steps_by_stage": [run["hp_steps_by_stage"] for run in SERVED],
        "ready_used_share": [(run["ready"] or {}).get("used_share")
                             for run in SERVED],
        "ready_discarded": [
            None if run["ready"] is None else {
                r: by for r, by in run["ready"]["discarded"].items()
                if any(by.values())} for run in SERVED],
        "gc_by_run": [run["gc"] for run in SERVED],
        # each run's host readings (``host_row``) and their sums
        "host_by_run": [run["host"] for run in SERVED],
        "host_sum": {k: (None if any(run["host"][k] is None
                                     for run in SERVED)
                         else sum(run["host"][k] for run in SERVED))
                     for k in (SERVED[0]["host"] if SERVED else ())},
        # each run's HP responses by part, summed over its jobs
        "hp_parts_total_ms": [run["hp_parts_total_ms"] for run in SERVED]}})
    return 0 if all(runs) else 1


def host_calls(torch, reps: int = 200) -> int:
    """``--host-calls``: what the calls a served stage's enqueue makes
    cost the calling thread on this host, each timed alone ``reps`` times
    on a lane stream (median and p90 µs; the card is synchronized every
    50 calls so that no queue builds up): ResNet18's second stage program
    (width 64, 224 x 224) captured on that stream, its input and output,
    and the events and contexts around them; and a first stage's input
    made anew for each job (``torch.zeros``, and its ``torch.empty`` and
    ``zero_`` apart), as the backend once made it, right behind a launch of that
    graph (not timed) on the same stream, and on another. The
    ``serving`` line's ``enqueue`` steps are made of these calls."""
    from repro_torch.api import HP
    from repro_torch.kernels import _lib
    from repro_torch.models import BUILDERS
    from repro_torch.serving.engine import staged_cnn_taskspec
    _lib.lib()
    model = BUILDERS["resnet18"](width=CNN_WIDTHS["resnet18"])
    spec = staged_cnn_taskspec(model, priority=HP, jps=30.0, input_hw=CNN_HW,
                               batch=CNN_BATCH)
    first, prog = spec.stages[0].payload, spec.stages[1].payload
    stream = torch.cuda.Stream()
    shape = (CNN_BATCH, CNN_HW, CNN_HW, 3)
    rows = {}

    def timed(name, fn, before=None):
        us = []
        for i in range(reps):
            if before is not None:
                before()
            t0 = time.perf_counter()
            fn()
            us.append((time.perf_counter() - t0) * 1e6)
            if i % 50 == 49:
                torch.cuda.synchronize()
        us.sort()
        rows[name] = [us[len(us) // 2], us[int(0.9 * len(us))]]
    with torch.cuda.stream(stream):
        x = first(torch.zeros(shape, device="cuda"))
        out = prog(x)                             # the capture
        ev, ev2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev.record()
        ev2.record()
        timed("torch.zeros (a first stage's input)",
              lambda: torch.zeros(shape, device="cuda"))
        timed("torch.cuda.Event() and its first record",
              lambda: torch.cuda.Event(enable_timing=True).record())
        timed("Event.record (an event made before)", ev.record)
        timed("torch.cuda.current_stream", torch.cuda.current_stream)
        buf = torch.empty_like(x)
        timed("Tensor.copy_ (the stage's input)", lambda: buf.copy_(x))
        timed("Tensor.clone (the stage's output)", out.clone)
        timed("torch.empty_like (the stage's output)",
              lambda: torch.empty_like(out))
        timed("StageProgram call (resolve, copies, replay, output)",
              lambda: prog(x))
        timed("StageProgram.prepare", lambda: prog.prepare(x))
        timed("StageProgram.prepare, then StageCall.issue (the "
              "graph's nodes set, one launch)",
              lambda: prog.prepare(x).issue(ev, ev2))
        timed("Event.query (done)", ev.query)
        # a first stage's input as the served path made it: right behind
        # the launch of a stage's graph on the same stream (the launch not
        # timed), its allocation and its fill apart; and behind a launch
        # on another stream
        other = torch.cuda.Stream()
        for name, fn in (("torch.zeros", lambda: torch.zeros(
                             shape, device="cuda")),
                         ("torch.empty", lambda: torch.empty(
                             shape, device="cuda")),
                         ("Tensor.zero_", buf.zero_)):
            timed(f"{name} behind a pending graph launch (same stream)",
                  fn, before=lambda: prog.prepare(x).issue(ev, ev2))
        lane = (torch.cuda.current_device(), stream.cuda_stream)
        with torch.cuda.stream(other):
            timed("torch.zeros behind a pending graph launch (another "
                  "stream)", lambda: torch.zeros(shape, device="cuda"),
                  before=lambda: prog.prepare(x, lane=lane).issue(ev, ev2))
    torch.cuda.synchronize()

    def ctx():
        with torch.cuda.stream(stream):
            pass
    timed("torch.cuda.stream context, entered and left", ctx)
    timed("time.perf_counter", time.perf_counter)
    timed("time.thread_time", time.thread_time)
    timed("resource.getrusage(RUSAGE_THREAD)",
          lambda: resource.getrusage(resource.RUSAGE_THREAD))
    emit({"host_calls": {"us_median_p90": rows, "reps": reps,
                         "thread_time_resolution_s":
                             time.get_clock_info("thread_time").resolution,
                         "card": gpu_line()}})
    return 0


def per_job(run: dict, part: str):
    """A served run's ms of ``part`` a completed HP job (None without the
    parts, or without that part)."""
    total = run["hp_parts_total_ms"]
    if not total or part not in total or not run["hp_jobs"]:
        return None
    return total[part] / run["hp_jobs"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve", metavar="ARCH",
                    help="only this model's serving phase (smollm-135m, "
                         "mamba2-2.7b, qwen2-moe-a2.7b, deepseek-v2-236b, "
                         "gemma2-27b, resnet18, unet or inceptionv3), "
                         "--repeats times")
    ap.add_argument("--epoch", action="store_true",
                    help="only the epoch phase, --repeats times")
    ap.add_argument("--cluster", action="store_true",
                    help="only the cluster phase (the fleet over "
                         f"{FLEET_HORIZON_LONG_MS:g} ms), --repeats times")
    ap.add_argument("--resume", action="store_true",
                    help="only the resume phase, --repeats times")
    ap.add_argument("--lm-paths", action="store_true",
                    help="only the kernel phase and the moe, hybrid and "
                         "int8 phases, --repeats times")
    ap.add_argument("--families", action="store_true",
                    help="only the kernel phase, steps 12-15 and the Dh "
                         "160 check, --repeats times")
    ap.add_argument("--train", action="store_true",
                    help="only the kernel phase (gradient rows included) "
                         "and the training phase, --repeats times")
    ap.add_argument("--dist", action="store_true",
                    help="only the kernel phase and steps 18-20 (four "
                         "ranks of the card, the dry-run, the roofline), "
                         "with the result line")
    ap.add_argument("--drill", metavar="ARCH",
                    help="only the elastic drills of this model (resnet18 "
                         "or smollm-135m), --repeats times")
    ap.add_argument("--host-calls", action="store_true",
                    help="only the host cost of each call a served stage's "
                         "enqueue makes (µs, on one lane stream)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--trace", action="store_true",
                    help="with --serve: each run under torch.profiler")
    ap.add_argument("--switch-interval", type=float, metavar="S",
                    help="with --serve: this process's interpreter switch "
                         "interval (sys.setswitchinterval) for its runs")
    # one rank of step 18 (the script starts four of itself)
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-work", help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank is not None:
        return dist_rank(args.dist_rank, Path(args.dist_work), args.dist_port)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _lib, ssd_scan
    except ImportError as e:
        print(f"chip_smoke: the port (src/repro_torch) is not beside this "
              f"script: {e!r}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    print(card, flush=True)
    emit({"setup": {"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": name,
                    "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}})
    t0 = time.perf_counter()
    _lib.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _lib.build_log.splitlines()
             if "Used" in ln or "Compiling entry" in ln
             or "Performance" in ln]
    emit({"build": {"seconds": build_s, "ptxas": ptxas}})
    dry_dir = Path(ROOT / "build" / "dryrun")
    if args.dist:
        failures, seconds, peaks = [], {}, {}
        procs = start_dryruns(dry_dir)
        with timed_phase(torch, "kernels", seconds, peaks):
            rows = kernel_phase(torch, F, failures)
        with timed_phase(torch, "dryrun_wait", seconds, peaks):
            finish_dryruns(procs, dry_dir, failures)
        paths = slice12_paths(torch, failures, seconds, peaks, dry_dir)
        emit({"phase_seconds": seconds})
        emit({"phase_peak_memory_gb": peaks})
        return result_line(torch, name, card, failures, rows, paths)
    if args.drill:
        return drill_repeats(torch, args.drill, args.repeats)
    if args.host_calls:
        return host_calls(torch)
    if args.serve:
        if args.switch_interval is not None:
            sys.setswitchinterval(args.switch_interval)
        return serve_repeats(torch, args.serve, args.repeats, args.trace)
    if (args.epoch or args.cluster or args.resume or args.lm_paths
            or args.families or args.train):
        failures = []
        for _ in range(args.repeats):
            if args.train:
                seconds, peaks = {}, {}
                with timed_phase(torch, "kernels", seconds, peaks):
                    rows = kernel_phase(torch, F, failures)
                    grad_rows = grad_phase(torch, F, failures)
                free_card(torch)
                with timed_phase(torch, "train_path", seconds, peaks):
                    train = train_phase(torch, failures)
                free_card(torch)
                with timed_phase(torch, "train_cut", seconds, peaks):
                    train_cut_check(torch, failures)
                shape_coverage(rows, {"train": train[:2]}, failures)
                backward_coverage(grad_rows, train[3], failures)
                emit({"phase_seconds": seconds})
                emit({"phase_peak_memory_gb": peaks})
            elif args.lm_paths or args.families:
                seconds, peaks = {}, {}
                with timed_phase(torch, "kernels", seconds, peaks):
                    rows = kernel_phase(torch, F, failures)
                run = lm_paths if args.lm_paths else family_paths
                shape_coverage(rows, run(torch, failures, seconds, peaks),
                               failures)
                emit({"phase_seconds": seconds})
                emit({"phase_peak_memory_gb": peaks})
            elif args.epoch:
                epoch_phase(torch, failures)
            elif args.resume:
                resume_phase(torch, failures)
                torch.cuda.empty_cache()
            else:
                cluster_phase(torch, failures, FLEET_HORIZON_LONG_MS)
        for f in failures:
            print(f"chip_smoke: FAIL {f}", file=sys.stderr)
        return 1 if failures else 0

    failures, seconds, peaks = [], {}, {}
    procs = start_dryruns(dry_dir)     # CPU only, lowest priority

    def phase(name):
        return timed_phase(torch, name, seconds, peaks)

    # the dry-runs share the host only with the kernel and gradient rows,
    # which are timed on the card; every later phase has the host to itself
    with phase("kernels"):
        rows = kernel_phase(torch, F, failures)
        grad_rows = grad_phase(torch, F, failures)
    with phase("dryrun_wait"):
        finish_dryruns(procs, dry_dir, failures)
    with phase("contention"):
        contention_rows, f32_launches = contention_phase(torch, failures)
        rows.update(contention_rows)

    # each model path: (its launches, its launches by instance)
    paths = {}
    with phase("dense_path"):
        model, params, spec, dense, dense_inst = serving_phase(
            torch, failures, PATH_MODELS["dense"], None, JPS, DENSE_PATH)
        fa_inst = dense_inst.get("flash_attention", {})
        if fa_inst.get("tensor_core", 0) != dense["flash_attention"]:
            failures.append(f"smollm-135m: bf16 flash-attention launches by "
                            f"instance {fa_inst}, not all tensor_core")
        output_checks(torch, model, params, spec, failures)
        del model, params, spec
        torch.cuda.empty_cache()
        paths["dense"] = (dense, dense_inst)

    with phase("epoch_path"):
        epoch = epoch_phase(torch, failures)

    with phase("ssm_path"):
        model, params, spec, ssm, ssm_inst = serving_phase(
            torch, failures, PATH_MODELS["ssm"], None, SSM_JPS, SSM_PATH)
        ssd_inst = ssm_inst.get("ssd", {})
        state_pass, outputs = (ssd_inst.get(k, 0) for k in
                               ssd_scan.INSTANCE_KERNELS["tensor_core"])
        if state_pass + outputs != ssm["ssd"] or state_pass != outputs:
            failures.append(f"mamba2-2.7b: bf16 SSD launches by kernel "
                            f"{ssd_inst}, not all tensor_core (a state pass "
                            f"and an output kernel a call)")
        ssm_f32 = output_checks(torch, model, params, spec, failures)
        del model, params, spec
        torch.cuda.empty_cache()
        paths["ssm"] = (ssm, ssm_inst)

    paths.update(lm_paths(torch, failures, seconds, peaks))
    paths.update(family_paths(torch, failures, seconds, peaks))

    free_card(torch)
    with phase("train_path"):
        launched, by_inst, train_backward, train_shapes = train_phase(
            torch, failures)
        paths["train"] = (launched, by_inst)
    free_card(torch)
    with phase("train_cut"):
        train_cut_check(torch, failures)
    paths.update(slice12_paths(torch, failures, seconds, peaks, dry_dir))

    for dnn in CNN_WIDTHS:
        with phase(f"{dnn}_path"):
            spec = cnn_serving_phase(torch, failures, dnn)
            cnn_output_checks(torch, dnn, spec, failures)
            del spec
            torch.cuda.empty_cache()

    with phase("drills"):
        for arch in DRILL_ARCHS:
            paths.update(drill_phase(torch, failures, arch)[0])

    with phase("resume_path"):
        resume_phase(torch, failures)
        torch.cuda.empty_cache()

    with phase("cluster_path"):
        cluster = cluster_phase(torch, failures)
    # within the served paths' seconds: each model's stage_graphs check
    seconds["stage_graphs"] = dict(STAGE_GRAPH_S,
                                   total=sum(STAGE_GRAPH_S.values()))
    emit({"phase_seconds": seconds})
    emit({"phase_peak_memory_gb": peaks})
    emit({"script_seconds": {
        "wall_s": time.perf_counter() - T_START,
        "phases_s": sum(v for k, v in seconds.items()
                        if k != "stage_graphs"),
        "previous": PREVIOUS_SECONDS, "aim_wall_s": WALL_AIM_S}})

    return result_line(torch, name, card, failures, rows, paths,
                       epoch=epoch, cluster=cluster,
                       f32_launches=f32_launches, grad_rows=grad_rows,
                       train_backward=train_backward,
                       train_shapes=train_shapes, ssm_f32=ssm_f32)


def result_line(torch, name, card, failures, rows, paths, epoch=None,
                cluster=None, f32_launches=0, grad_rows=None,
                train_backward=None, train_shapes=None,
                ssm_f32=None) -> int:
    """The ``kernels`` line (every row of the kernel phase that ran, its
    launches on the paths run) and the result line, or the failures and
    exit code 1."""
    epoch, cluster = epoch or {}, cluster or {}
    grad_rows, train_backward = grad_rows or {}, train_backward or {}
    ssm_f32 = ssm_f32 or {}
    # launches: the sum over the paths, each counted from a reset just
    # before it; the f32 contention kernel's own fleet-sweep call
    counted = [p for p, _ in paths.values()] + [epoch, *cluster.values()]
    launches = {k: sum(p.get(k, 0) for p in counted) for k in SOURCES}
    launches["contention_eta_f32"] = f32_launches
    # launches by instance, summed over the model paths (decode attention
    # counts its split kernel and its merge, one each a call)
    by_inst = {}
    for _, inst in paths.values():
        for kname, per in inst.items():
            for i, n in per.items():
                by_inst.setdefault(kname, {})
                by_inst[kname][i] = by_inst[kname].get(i, 0) + n
    shape_coverage(rows, paths, failures)
    if train_shapes is not None:
        backward_coverage(grad_rows, train_shapes, failures)
    kernels = []
    for rname in (*SOURCES, *OTHER_SHAPES):
        if rname not in rows:          # --dist runs no contention rows
            continue
        kname = OTHER_SHAPES.get(rname, rname)
        src, replaces = SOURCES[kname]
        row = rows[rname]
        entry = {
            "name": rname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("instance", "n_split", "blocks",
                                   "cuda_core_same_shapes",
                                   "latency_floor_ms") if k in row}}
        if rname in EPOCH_PATH:        # the simulated paths, one by one
            entry["launches_by_path"] = {
                "epoch": epoch.get(rname, 0),
                **{p: n.get(rname, 0) for p, n in cluster.items()}}
        elif rname == kname:
            entry["launches_by_path"] = {p: c.get(kname, 0)
                                         for p, (c, _) in paths.items()}
            if kname in by_inst:
                entry["launches_by_instance"] = by_inst[kname]
        else:                          # the instance and shape it checked
            keys = row.get("shapes", {}).get(kname, [])
            per = {p: sum(PATH_SHAPES.get(PATH_MODELS[p], {}).get(
                kname, {}).get(key, 0) for key in keys) for p in paths}
            entry["launches"] = sum(per.values())
            entry["launches_by_path"] = {p: n for p, n in per.items() if n}
            entry["launches_of"] = f"{kname} at {' and '.join(keys)}"
        if rname in grad_rows:         # its backward recomputes the plain
            entry["backward_recompute_us"] = grad_rows[rname][
                "backward_recompute_us"]
            entry["train_backward_per_step"] = train_backward.get(rname, 0)
        if rname == "ssd_cuda_core":   # bf16 serving takes the tensor cores
            entry["launches_f32_output_check"] = ssm_f32.get(
                "ssd", {}).get("cuda_core", 0)
        kernels.append(entry)
    for f in failures:
        print(f"chip_smoke: FAIL {f}", file=sys.stderr)
    if failures:
        return 1
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0




if __name__ == "__main__":
    sys.exit(main())
