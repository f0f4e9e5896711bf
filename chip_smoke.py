#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100 by design).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. build the CUDA kernels from ``paddle_tpu_torch/ops/cuda/csrc`` with
   nvcc and print the card (``nvidia-smi`` name and power limit);
2. the contiguous decode-attention kernel against its plain version on
   the card (f32, bf16 and f16, several chunk lengths, scalar and ragged
   fills, d 40 to 256, caches of 512 and 4096 columns, and q in another
   type than the cache), each case held to the absolute ``TOL`` and the
   norm-relative ``DECODE_NORM_TOL``; per case the kernel it ran on, from
   the launch counters (s = 1 on the split-K decode kernel, bf16 and f16
   chunks at d 64 / 128 on the mma kernel, the rest on the scalar one),
   and a second launch of a Hopper kernel must give the same bits;
3. the paged (block-table) decode-attention kernel, the same checks over
   block sizes 16, 24 and 128; on each case's values gathered into a
   contiguous cache of nb * bs columns the contiguous kernel must give the
   paged kernel's bits;
4. the main path at full width: GPT-2 small (``GPTConfig()``) with random
   weights from a seed. f32: ``ServeLoop`` tokens must equal sequential
   ``GPT.generate`` tokens (a divergence passes only at a top-2 logit
   near-tie, gap < 1e-4). bf16: a continuous-batching throughput run
   with 32 client threads, ~20 serve decode steps at 64 active slots under
   torch.profiler (device busy and paged-kernel ms per step, idle share),
   then a batched ``generate``. Every kernel's launch count is zeroed
   before this phase and must be > 0 after it; the decode steps must have
   run the split-K kernel and the prefills the mma kernel;
5. kernel timings (CUDA events, median of 30 runs, L2 flushed before
   each) beside the plain version, the ``scaled_dot_product_attention``
   yardstick and the bound, at the serve run's decode and prefill shapes
   and at GPT-2's full context (b64 and b1 at fill 1023, a 1024-token
   prefill), in bf16 and in f16;
6. the three fused-CE kernels (forward, dh, dW/db) against their plain
   versions: f32 and bf16, bias and none, V in {517, 30522, 50304}, n in
   {8, 300, 1000, 4096}, H in {64, 72, 768, 1024}, ~30% ignored rows and
   two out-of-range labels per case, and per type one batch with every row
   ignored; limits per quantity (``CE_TOL``). bf16 at H % 64 == 0 must run
   the Hopper forward and backward (``fused_ce_sm90.cu``), f32 and H 72
   the kernels of ``fused_ce.cu`` (per case, from the launch counters); on
   the Hopper kernels ``fused_ce_bwd`` and a second launch of each wrapper
   must give the same bits as the first;
7. BERT-base at full width in f32 (batch 8, s 128, dropout 0): one
   AdamW step through the CE kernels against the same step with
   ``FLAGS_use_fused_ce`` off (the plain forward under autograd, cuBLAS
   f32 logits): loss, every parameter's gradient, parameters after;
8. the flagship training step, as ``bench.py:bench_bert`` shapes it:
   BERT-base bf16 (O2: bf16 params, f32 master weights and moments in
   AdamW), batch 32, s 128, dropout 0.1, LMDataset batches cycled; 5
   warm-up and 30 timed steps, step ms / samples/s / tokens/s / MFU. Every
   kernel's launch count is zeroed before this phase and the three CE
   kernels' must be > 0 after it; with the default FLAGS_flash_min_seq
   at or below s, the attention takes the flash kernels too, and each
   must count 12 x 35 launches;
9. CE kernel timings at the flagship head (n 4096, H 768, V 30522, bf16,
   bias, 85% ignored) and at GPT-2's (V 50304, no bias, none ignored: the
   head of phase 12's path): the forward, dh alone, dW/db alone and
   ``fused_ce_bwd`` (dh, dW and db from one recompute), each with its
   bound, plain version, the ``F.linear`` + ``F.cross_entropy`` yardstick
   (its autograd backward for the same gradients) and ``fused_ce.cu``'s
   kernels on the same inputs; the library's
   whole backward against ``fused_ce_bwd`` (median and spread of 60 runs);
   the kernels held to phase 6's limits and repeats at both shapes;
10. the three flash-attention kernels (forward, dq, dk/dv) against their
    plain versions: f32 and bf16, causal and not, bias and none, (s_q,
    s_k) in {(128, 128), (1024, 1024), (33, 33), (7, 65), (1, 40), (32,
    64), (4096, 4096), (190, 317), (1000, 1000), (4000, 4096)}, d in {16,
    64, 128, 256}; O, lse, dq, dk, dv each held to its limits
    (``FLASH_TOL``). bf16 at d 64 and 128 must run the Hopper forward, dq
    and dk/dv (``flash_attention_sm90.cu``), everything else the kernels of
    ``flash_attention.cu`` (per case, from the launch counters), and two
    launches of each Hopper kernel on the same inputs must be bitwise
    equal;
11. GPT-2 small at full width in f32 (b 1, s 1024, dropout 0,
    ``FLAGS_flash_min_seq=0``): one AdamW step through the flash kernels
    against the same step with ``FLAGS_use_flash_attention`` off (the
    composite under autograd): loss, every parameter's gradient,
    parameters after;
12. the long-sequence training path, as ``bench.py:bench_longseq`` shapes
    it: GPT-2 small bf16 (O2) at b 1, s 4096, dropout 0, 2 warm-up and 15
    timed steps through the flash and CE kernels (tokens/s, step ms, MFU,
    the time breakdown with the CE forward's and backward's device ms per
    step); every kernel's launch count is zeroed before it, each flash
    kernel must count 12 x 17 launches (all on the Hopper kernels) and each
    CE kernel > 0 after it (all on the Hopper forward and backward);
    then the same steps with flash off (``vs_baseline``);
13. flash kernel timings at that path's shape (b 1, h 12, s 4096, d 64,
    bf16, causal) and at the flagship's attention (b 32, h 12, s 128, d 64,
    bf16, key bias) beside their bounds, plain versions, the torch SDPA
    yardstick and the flash_attention.cu kernel on the same bf16 inputs;
    SDPA's whole backward against dq + dk/dv (median and spread of 60
    runs); and the ``FLAGS_flash_min_seq`` sweep: forward + backward
    through the kernels and through the composite at 16384 tokens, s from
    128 to 4096, causal and not;
14. f16 through the five kernels of the training path (flash forward, dq,
    dk/dv, the CE forward and the joint CE backward): phase 6's CE cases
    and phase 10's flash cases in f16, the flash ones also with BERT's
    f16 O2 mask (-inf on right-padded keys), each case on the kernel its
    shape takes (f16 at d 64 / 128 and H % 64 == 0 on the Hopper kernels,
    counted in ``<kernel>.f16``), the Hopper launches repeated bitwise,
    limits ``CE_TOL`` / ``FLASH_TOL`` for f16; then the five f16 kernels
    timed at phase 9's heads and phase 13's shapes (kernel, bound, plain
    version, the library call in f16);
15. the f16 O2 training path at the flagship's shape (BERT-base, b32,
    s128, dropout 0.1, 16 LMDataset batches): ``decorate`` and
    ``auto_cast`` O2 f16, a dynamic ``GradScaler`` from 2^15, AdamW with
    master weights and decay 0.01, LinearWarmup over PolynomialDecay,
    ClipGradByGlobalNorm(1.0); 5 warm-up and 30 timed steps (step ms,
    samples/s, MFU, loss start and end, the loss-scale trajectory and the
    skipped steps, device busy ms and idle share). Every count is zeroed
    before it; each of the five kernels must launch only in f16 on its
    Hopper kernel, the loss must be finite and fall, and a skipped step
    must leave every parameter and slot bitwise as it was. Then 10 steps
    of the f32 model under O1 bf16 with Lamb: step ms and the dtype and
    kernel each attention and CE call took;
16. one f16 O2 step of BERT-base (b8, s128, dropout 0) through the
    kernels against the same step with ``FLAGS_use_fused_ce`` and
    ``FLAGS_use_flash_attention`` off (the composites), from the same
    weights on the same batch: loss, unscaled gradients, masters after
    (``O2_STEP_TOL``);
17. the high-level API: BERT-base (b32, s128, dropout 0.1) trained by
    ``Model(MLM(bert)).prepare(AdamW + LinearWarmup over PolynomialDecay
    + ClipGradByGlobalNorm, amp O2).fit(LMDataset, epochs=1, shuffle,
    History, ModelCheckpoint)`` for 40 steps, once in f16 O2 (the
    GradScaler's pure form) and once in bf16 O2: the step ms over the
    last 30 steps, device busy ms and idle share over 10 more profiled
    steps, ``hapi/train_steps``, host loss reads per step, loss start
    and end, beside phases 8 and 15 of the same run. Every count is
    zeroed before each fit, and every step must launch each flash kernel
    12 times and each CE kernel once, all on the Hopper kernels (in f16
    for f16). Then, at dropout 0: three ``Model.train_batch`` steps
    against three of phase 15's hand-written steps (loss, masters,
    ``O2_STEP_TOL``); ``Model.save`` into a fresh Model's ``load``
    (parameters, slots and the next step bitwise); two steps at a loss
    scale of 2^40 (state bitwise kept, the step count advancing, the
    scale halved); ``evaluate`` and ``predict`` over 4 batches;
18. the dygraph API, written against ``import paddle_tpu_torch as
    paddle`` alone: the op core's checks (the card by default for
    layers, ``to_tensor`` and ``zeros``; O1 bf16 makes ``x @ w`` of f32
    tensors bf16; ``no_grad``; a PyLayer doubling a gradient); BERT-base
    (b32, s128, dropout 0.1, bf16 O2 with f32 masters, AdamW lr 1e-4 wd
    0.01) through ``loss.backward(); opt.step(); opt.clear_grad()`` for 40
    steps of LMDataset batches made by ``paddle.to_tensor`` (step ms over
    the last 30, busy and idle over 10 profiled steps; every count zeroed
    before, 12 / 12 / 12 / 1 / 1 / 1 Hopper launches a step, the loss
    finite and falling); at dropout 0, state_dict -> save -> load ->
    set_state_dict gives the next step bitwise, ``paddle.grad`` equals
    backward's ``.grad`` bitwise, a ``no_grad`` eval builds no graph and
    a forward-post hook fires once per encoder layer; GPT-2 small
    decorated to f16 through ``generate`` and a ``ServeLoop`` (every
    decode launch in f16 on the Hopper kernels); the op layer's host
    microseconds per call against the bare torch call;
19. the encoder-decoder Transformer-base (``paddle.nn.Transformer()`` at
    its defaults, a shared 37,000-token embedding tied to the output
    through ``F.fused_linear_cross_entropy``, sinusoidal positions),
    built from the port's public surface: the kernels at this path's new
    shapes (flash at (s_q, s_k) = (256, 200) and (1, 256), d 64, bf16,
    a key bias; decode at b32 h8 d64 L320 fill 255) against their plain
    versions; 40 bf16 O2 training steps (Adam 0.9 / 0.98 / 1e-9 under
    NoamDecay from its peak, dropout 0.1, b 32, synthetic pairs of 128-256
    tokens padded to 256, each target its source reversed): step ms over
    the last 30, target tokens/s, busy and idle over 10 profiled steps,
    12 / 12 / 12 flash and 1 / 1 / 1 CE Hopper launches and 6 ``shape``
    rejections (the decoder's [s, s] mask) a step, the loss finite and
    falling; greedy decoding in bf16 (32 sources of 256, 64 new tokens,
    one StaticKVCache a decoder layer): ms a token, 6 decode and 6 flash
    forward launches a token; one f32 step through the kernels against
    the composites (``TF_STEP_TOL``); f32 cached greedy tokens against an
    uncached decoder (phase 4's near-tie rule); the masks hold (a padded
    source token or a later target token changed leaves the outputs as
    they were, ``TF_MASK_TOL``);
20. vision and conv, through none of the eight kernels (every launch
    count stays 0 over the phase): (a) the conv ops on the card against a
    float64 numpy oracle written here (im2col for the convs, a scatter for
    the transposed ones, explicit windows for the pools, the resize
    weights of jax.image), f32 and bf16, each op within its limit
    (``CONV_ORACLE_TOL``): conv2d with groups, depthwise, dilation, SAME
    at stride 2 on odd and even sizes, 4-element pads and NHWC;
    conv2d_transpose with output_padding, groups and 4-element pads; max
    and avg pools with ceil_mode (the windows of padding only among
    them); every interpolate mode; (b) LeNet through ``Model.fit`` on
    MNIST's synthetic digits (Adam 1e-3, b64, f32, 2 epochs = 256 steps),
    then ``evaluate`` on the test split: step ms, the loss, test accuracy
    above 0.3; (c) ResNet-50 in ``bench.py:bench_resnet``'s recipe through
    ``Model.fit``, bf16 O2 (b64, 224^2, Momentum 0.02 / 0.9 with decay
    1e-4 and f32 masters, 8 synthetic batches cycled, 40 steps): step ms
    over the last 30, images/s, busy and idle over 10 profiled steps,
    peak memory, FLOPs (``FlopCounterMode``) and MFU, the loss finite and
    falling; (d) one ResNet-50 step at b2 64^2 on the card against the
    port's CPU path from the same weights, f64 and f32
    (``VISION_STEP_TOL``); (e) gelu's special values against
    jax.nn.gelu's;
21. generation and serving, the rest, on GPT-2 small at full width
    (random weights, seed 0): (a) ``BeamSearchDecoder`` over StaticKVCache
    states through ``dynamic_decode`` in bf16 (8 prompts of 32, beam 4, 32
    steps): ms a step, tokens/s, 12 decode launches a pass (split-K, 32
    rows); the scores against an uncached forward of each path; in f32
    beam 1 against greedy ``generate`` (phase 4's rule) and the beam-4
    scores within ``BEAM_SCORE_TOL`` (``phase_beam_scores``); (b)
    ``export_decode`` (bf16, b 8, prompt 32, 16 new) into a torch.export
    artifact run by ``create_predictor``: its tokens against
    ``generate``'s, 12 x 16 decode launches in ``run``, ms a token of
    both; (f, first) ``pick_block_size`` measuring the paged kernel at
    256 / 128 / 64 for h12 d64 bf16 at L 1024 into ``BLOCK_TABLE``, no
    candidate failing; (c) ``traffic.run_spec`` of the steady, diurnal
    and flash shapes (30 requests/s for 6 s, bench_serve's lengths)
    through one bf16 ``ServeLoop`` (max_active 64, the measured block
    size): completed, errors, TTFT and token ms p50 / p99, tokens/s,
    backpressure waits, preemptions, paged launches; errors 0 and every
    event completed; (e) the steady replay's Chrome trace, with
    ``serve/decode_step`` and ``serve/prefill`` slices and flow events;
    (d) the steady replay with one 0.2 s STALL at ("serve", "beat"): it
    fires once, nothing fails, a request waits it out and TTFT p99 rises;
    then three RESETs there, absorbed; (f) bench_serve's 64 requests
    served at each block size, tokens/s.
22. the static graph and jit (``phase_static``): (a) BASELINE config 3,
    BERT-base built under ``paddle.enable_static()`` + ``program_guard``
    (b32 s128, ``masked_lm_labels``), ``static.amp.decorate`` of AdamW
    (lr 1e-4, wd 0.01) at O2 bf16, 40 ``Executor.run`` steps of LMDataset
    batches: step ms (median after 10 warm-up steps), samples/s, MFU,
    busy and idle over 10 profiled steps, the loss falling, 12 / 12 / 12 /
    1 / 1 / 1 Hopper launches of the flash and CE kernels a step, one
    lowering over the 40 runs; (b) one f32 BERT-base step (b8, dropout 0)
    through ``Executor.run`` against phase 18's dygraph step from the same
    weights and batch (loss, every gradient, parameters after, within
    ``STEP_TOL``), then the ``clone(for_test)`` program's loss twice, the
    same bits; (c) ``to_static`` of GPT-2 small's f32 forward against
    eager (``GPT_STEP_TOL``); ``jit.save`` of BERT-base in bf16 eval
    (spec [None, 128] int64), then ``jit.load``, ``create_predictor`` on
    the ``.pdmodel`` and on the ``.pt2``, each against eager at b32
    within ``JIT_BF16_TOL``, the flash forward's launches counted in every
    route, save / export / load seconds, artifact sizes, ms a batch;
    (d) a layer with a data-dependent ``while`` saved, loaded and run on
    CUDA tensors, equal to eager at two trip counts.
23. the trainer's host path (``phase_trainer_host``): (a) 22(a)'s
    program fed by an ``InMemoryDataset`` over MultiSlot files holding
    phase 22's 16 LMDataset batches (40 steps, batch i = batch i % 16),
    trained through ``Executor.train_from_dataset`` in flight 0 (the
    synchronous loop), in flight 2 and in flight 2 with scan K 4, each
    from the same state with a fresh Executor: the loss trails (every
    step's lazy fetch, read after the run) and final scopes bitwise
    equal, 12 / 12 / 12 / 1 / 1 / 1 Hopper launches a step, one
    lowering each; step ms over the last 28 steps (synced at both ends)
    and the median over its spans of one megastep (one step unfused),
    busy and idle over 8 profiled steps, host syncs a step (torch's
    sync-debug warnings plus the runner's event waits) and
    ``executor/host_overhead_ms``; then the synchronous run's step-20
    state restored and ``start_batch=20`` in flight 2: the trail's tail
    and final scope bitwise. (b) phase 17's BERT-base bf16 O2
    ``Model.fit`` (40 steps of 32, shuffled) in child processes
    (``--phase23-child``): uninterrupted and, side by side with it, with
    ``auto_checkpoint_dir`` (every 10 steps, 2 kept) and SIGTERM after
    step 25 (the PreemptionGuard's save, steps 20 and 25 left); resumed
    to 40: the final parameters' manifest equal to the uninterrupted
    run's; one flipped byte in step 40 found by its hash, quarantined,
    the restore walking back to 30; bytes a checkpoint, async and sync
    save seconds, restore seconds. (c) (a)'s program through
    ``capi_train.save_train_program`` / ``create`` / ``run_step`` for 10
    steps, bitwise equal to ``Executor.run`` from the same state. (d)
    ``FLAGS_check_nan_inf``: an inf in a feed raises at the op layer
    (``matmul``), at ``Executor.run``'s sweep with the scope unwritten
    and at ``Model``'s step sweep with the parameters unwritten; a
    failing in-flight step raises ``PipelineStepError`` naming step 3
    and leaves a flight-recorder dump; the flag's cost a step on (a)'s
    program. (e) a GPT-2 small bf16 ``ServeLoop`` answers 64 requests
    (32 + 97 tokens) through the paged kernel with
    ``on_complete=StreamingDataset.offer``; every record re-offered and
    rejected; two ``traffic.Window`` rounds of 4 batches train GPT-2
    small's static causal-LM step (b8 s128, bf16 O2) through
    ``train_from_dataset`` on the flash and CE kernels, the losses
    finite, the stream's counters exact.
24. the parameter-server tier at GPT-2 small's width (V 50304 x 768
    f32 tables; phase 24 alone: ``c.phase_ps(card)``, its parts
    ``c.phase_p24_downpour()``, ``phase_p24_online()``,
    ``phase_p24_device_tier()``, ``phase_p24_telemetry()``). (a) sync
    Downpour: ids -> Embedding -> fc -> BCE, 16 batches of 8 x 128 ids,
    the server's SGD accessor owning the embedding; the same program
    trained locally from the server's initial rows: rows and head within
    ``P24_ROW_TOL``; pull / push rows/s at 8192 rows against one server
    over loopback. (b) the closed online loop: a bf16 GPT-2 small
    ``ServeLoop`` serves 64 requests (32 + 64 tokens, paged kernel);
    every record offered twice to a ``StreamingDataset``; the online
    trainer runs 8 batches (sync_every 1, an ``EmbeddingPrefetcher`` on
    the card) against three shard servers with one backup each holding a
    ``geo_sparse`` table; ``EmbeddingSnapshotPublisher`` (a card
    ``HeterPSCache`` as its cache) publishes; ``publish_weights``
    hot-swaps ``wte`` and 16 more requests are served, their greedy
    tokens held to batched ``generate`` (phase 4's rule, bf16 gap
    0.0625). Then the same records on a fresh cluster with a lost ack
    (a frozen payload resent under its key) and shard 0's primary killed
    after batch 4: the table bitwise the fault-free run's, ``applied``
    exact on every live server, the card cache re-reading after the
    promotion, ``model_version`` +1 a publish, no request dropped, the
    tokens after the second swap equal the first's. (c) a
    ``DeviceHashTable`` of 131072 x 768 f32 on the card and on the CPU
    through the same inserts (a 16 x 64 duplicate storm, 8192-id
    batches), removes and lookups: keys bitwise, rows and masks equal;
    lookup of 1024 ids and insert of a 1024-id miss set timed with CUDA
    events (median of 20). (d) a ``TelemetryHub`` here; the serve loop
    and the trainer (here, each shipping its own names) and three PS
    servers (child processes) ship to it: the hub's counters for each
    member equal that member's monitor bitwise; pull / push rows/s over
    the three; the hub stopped: ``flush()`` returns False; then a 2 s
    replay of phase 21's steady spec through ``run_spec(hub=...)``.
25. the serve capacity model and the collective tier (``phase_distributed``;
    its rank bodies ``p25_ranks_body`` and ``p25_dp_body`` run in child
    processes through ``testing.spmd.run_ranks``, gloo over a FileStore,
    every rank on the one card, after phase 1 has built the kernels). (a)
    a ``DeviceProfile`` calibrated on GPT-2 small's bf16 ServeLoop (64
    slots, the paged kernel) and the analytic one from ``serve_evidence``
    at the H100's peaks; phase 21's steady / diurnal / flash specs
    predicted by both and replayed through ``run_spec`` scored by a
    ``TelemetryHub``: predicted, observed, the error against the
    ``FLAGS_capacity_*_band_pct`` bands and the headroom for each profile
    (errors 0, every event completed and hub scoring are checked; the
    bands are recorded); ``prefill_flops`` at 8-128 and the bare
    forward's MFU. (b) 4 ranks: the transport table (which gloo ops take
    CUDA tensors on this torch, the rest staged through pinned host
    buffers), the collective battery on CUDA tensors exact against numpy
    (five reduce ops, a 3-of-4 subgroup, all_gather, reduce,
    reduce_scatter, alltoall, broadcast, scatter, a ppermute ring, send /
    recv, ``hierarchical_all_reduce`` on a 2 x 2 mesh), all_reduce timed
    at 1 / 16 / 256 MB. (c) ring and Ulysses attention at sp 4, bf16, h12
    d64, b1 s16384 (s 4096 a rank), causal and not, against one flash
    call over the whole sequence (``P25_RING_TOL``): the flash launches a
    rank (all on the Hopper kernel), the causal ring's skipped steps (3,
    2, 1, 0), ms against the single call. (d) GPT-2's MLP as
    Column / RowParallelLinear at tp 4 (f32, ``P25_TP_TOL``);
    DataParallel BERT-base b32 s128 as 16 / 16 over 2 ranks, two AdamW
    steps in f32 (``STEP_TOL``) and bf16 O2 (``P25_DP_BF16_TOL``) against
    the whole batch unwrapped, step ms and the all-reduce's bytes; one
    GPT-2 block under ``recompute``: gradients bitwise the plain ones,
    flash forwards doubled.
26. training across processes (``phase_fleet_training``; its rank bodies
    ``p26_fleet_body`` and ``p26_ranks_body`` run as phase 25's do). (a)
    2 ranks: ``Model.fit`` of BERT-base (b32 s128 split 16 / 16, bf16
    O2, AdamW, dropout 0) under ``fleet.init`` and
    ``fleet.distributed_optimizer``, 3 steps plain (the gradients
    all-reduced) and with ``strategy.sharding`` (ZeRO: reduce-scatter,
    the rank's chunk of masters and slots updated, all-gather): the f32
    masters after step 3 within ``STEP_TOL["param"]`` of each other
    (bitwise predicted: two ranks' sums are one addition either way), the
    optimizer-state bytes and peak memory a rank; then
    ``strategy.localsgd`` k 2 for 4 steps: the replicas' parameters
    bitwise equal after steps 2 and 4 only. (b) 4 ranks: GPT-2 small's 12
    blocks at pp 4 (3 a stage; the embedding before, ln_f and the tied
    head's fused CE on the last stage), b8 s1024 in 4 micro-batches,
    ``gpipe``, ``1f1b`` and ``interleaved`` (3 one-block chunks a rank),
    f32 and bf16, one forward and backward each against the whole model
    in one process over the same micro-batches (``P26_PP_TOL``), the CE on
    the last rank only, bf16 on the Hopper kernels. (c) ring and Ulysses
    attention at sp 4 (s 4096 a rank, h12 d64, bf16), forward and
    backward against one flash forward and backward over s 16384
    (``P26_RING_GRAD_TOL``): the flash launches summed over ranks (ring
    16 / 16 / 16 non-causal, 10 / 10 / 10 causal; Ulysses 4 each), all on
    the Hopper kernels, ms against the single call. (d) Switch-Base-8's
    MoE FFN (d 768, d_ff 3072, 8 experts, top-1, capacity 1.25) at ep 4,
    b2 s512 a rank, f32, against the dense layer over each rank's tokens
    (``P26_MOE_TOL``), dropped tokens and all_to_all bytes. (e)
    SyncBatchNorm at ResNet-50's first BN shape ([8, 64, 56, 56] a rank)
    over dp 4 against one BN over the concatenated batch
    (``P26_BN_TOL``).
27. the rest of the distributed tier (``phase_multi_process``). (a)
    ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
    on ``paddle_tpu_torch/testing/fit_job.py`` (fleet DP ``Model.fit``
    of BERT-base bf16 O2, b32 s128 as 16 / 16, a checkpoint every 2
    steps, 4 steps), once as it is and, side by side, with rank 1
    SIGKILLed after step 3 and ``--elastic_retries 1``: the restarted job
    resumes both ranks at step 2 and its losses and f32 masters are
    bitwise the uninterrupted launch's; the restart's seconds and each
    rank's launches. (b) 2 ranks: phase 22's static BERT-base bf16 O2
    program under ``with_data_parallel`` (b32 as 16 / 16, 3 steps), plain
    and with ``strategy.recompute`` (a segment an encoder layer):
    recompute's gradients and losses bitwise the plain ones, the first
    step's loss, gradients and masters against one process over the whole
    batch (``P27_ONE_TOL``) and a planted rank's gradient without the sum
    over dp that the gradient limit must fail, flash forwards a step.
    (c) 4 ranks: ``Model.fit`` of GPT-2 small bf16 O2 under {"tp": 4},
    b8 s1024, 2 AdamW steps: the first step against one process
    (``P27_ONE_TOL``, the gradients as AdamW's first moments) and a
    planted fit without the column layers' backward all-reduce that the
    gradient limit must fail, the forward's all-reduce bytes against
    ``analyze_program``'s prediction for the preset specs and the step's
    from them, the head's all-gather, state bytes a rank. (d)
    ``plan_program`` of GPT-2 small at tp 4 on the host, the fit under
    the plan's whole layout (as exact-name rules) against one process
    (and bitwise the preset's fit where the layouts agree);
    ``StagedPipelineRunner`` over ``plan_pipeline`` of GPT-2
    small's 12 blocks at pp 4 (b8 s1024, 4 micro-batches, f32 SGD, 3
    steps) against the whole stack in one process (``P27_PP_TOL``).

The line before the last is the card as nvidia-smi reports it; the last
line is ``{"ok": true, "device": {...}}``. The kernel summary line
(``{"kernels": [...]}``) comes before both.

One phase alone (after ``phase_build()``), from the repo root:
``python3 -c "import chip_smoke as c; c.setup(); c.phase_build();
c.phase_flash()"``; phase 25: ``python3 -c "import chip_smoke as c;
c.setup(); card = c.phase_build(); c.phase_distributed(card)"``; phase
26 the same with ``c.phase_fleet_training(card)``, phase 27 with
``c.phase_multi_process(card)``. ``python3 chip_smoke.py --faults`` runs phases 2-3
(decode faults), 6 (CE faults), 10 (flash faults), 14 (f16 faults),
18's API checks (op-core faults), 19's mask checks (a Transformer
fault), 20's conv oracle (a conv fault) or 21(a)'s f32 beam scores (a
beam-search fault) or 23(a), (b) and (d) (the trainer's host-path
faults) or 24(b) and (c) (the PS tier's faults) on copies of the checkout with one planted fault each
(``FAULTS``) and exits 0 when every copy fails them.
``python3 chip_smoke.py --compare DIR`` runs phases 8 and 15 of the
checkout at DIR and of this one, each in a fresh process, in the order
DIR, this, this, DIR twice over, and prints their step ms as one JSON
line; ``--attribute DIR`` takes phase 8's step apart on the host (the
forward, the backward, the zero grads, ``opt.step()``, ``clear_grad``,
then a cProfile) for DIR's package and this one, in the order DIR, this,
this, DIR. ``--compare-serve DIR`` runs phase 4's bf16 serve run of
DIR's checkout and of this one in the order DIR, this, this, DIR, and
prints the decode step's wall and busy ms.
"""
import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
# decode attention, absolute; f16 at an eighth of bf16's (three more
# mantissa bits)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
# decode attention, ||error|| / ||plain||, set from phases 2-3's worst
# readings (f32 5.7e-7, bf16 2.2e-3: the output's rounding to bf16 and, on
# the mma kernel, P's; PERF.md section 6) with 7x and 2.3x headroom; f16
# at an eighth of bf16's, as its rounding unit (2^-11 against 2^-8)
DECODE_NORM_TOL = {torch.float32: 4e-6, torch.bfloat16: 5e-3,
                   torch.float16: 6.25e-4}
# the 16-bit types of the decode kernels
HALF = (torch.bfloat16, torch.float16)
# Fused-CE limits per quantity, set from the worst readings of phases 6 and
# 9 with headroom (PERF.md section 6 gives the readings): "fused_ce_fwd" is
# loss and lse, absolute; "<grad>_max" the largest |error| over the largest
# |entry|; "<grad>_norm" the error's norm over the entry's (Frobenius),
# which sees a term missing from every row even where that term is small
# beside the largest entry (the softmax part of dh, the softmax-only rows
# of dW).
CE_TOL = {
    torch.float32: {"fused_ce_fwd": 2e-5, "dh_max": 1e-4, "dh_norm": 1e-5,
                    "dw_max": 2e-5, "dw_norm": 1e-5, "db_max": 2e-5,
                    "db_norm": 1e-5},
    torch.bfloat16: {"fused_ce_fwd": 1e-4, "dh_max": 1e-2, "dh_norm": 2e-3,
                     "dw_max": 1e-2, "dw_norm": 2e-3, "db_max": 1e-2,
                     "db_norm": 2e-3},
    # f16 (phase 14): from its worst readings (loss/lse 1.3e-5; dh 6.5e-4
    # / 1.5e-4, dW 8.8e-4 / 5.3e-5, db 1.3e-4 / 2.1e-5, max / norm) with
    # 2.3-5x headroom: "_max" 2e-3 is four f16 ulps (2^-11) of the
    # largest entry; each limit at or under bf16's
    torch.float16: {"fused_ce_fwd": 5e-5, "dh_max": 2e-3, "dh_norm": 5e-4,
                    "dw_max": 2e-3, "dw_norm": 2e-4, "db_max": 5e-4,
                    "db_norm": 1e-4},
}
# f32 BERT-base step, kernels against the plain head: every parameter's
# gradient (largest |error| over largest |entry|, per tensor) and loss
STEP_TOL = {"loss": 1e-4, "grad": 1e-5, "param": 1e-5}
# phase 22(c): jit routes of BERT-base bf16 eval against eager, the largest
# |difference| over the largest |logit| (bf16's rounding step is 2^-8)
JIT_BF16_TOL = 2e-2
SOURCES = {
    "decode_attention": "paddle_tpu_torch/ops/cuda/csrc/decode_attention.cu",
    "paged_decode_attention":
        "paddle_tpu_torch/ops/cuda/csrc/decode_attention.cu",
    "fused_ce_fwd": "paddle_tpu_torch/ops/cuda/csrc/fused_ce_sm90.cu",
    "fused_ce_bwd_dh": "paddle_tpu_torch/ops/cuda/csrc/fused_ce_sm90.cu",
    "fused_ce_bwd_dw": "paddle_tpu_torch/ops/cuda/csrc/fused_ce_sm90.cu",
    "flash_fwd": "paddle_tpu_torch/ops/cuda/csrc/flash_attention_sm90.cu",
    "flash_bwd_dq": "paddle_tpu_torch/ops/cuda/csrc/flash_attention_sm90.cu",
    "flash_bwd_dkv":
        "paddle_tpu_torch/ops/cuda/csrc/flash_attention_sm90.cu",
}
# the kernels that the rest takes in place of the Hopper ones: those of
# flash_attention.cu for f32, other head dims and unaligned inputs; those of
# fused_ce.cu for f32 and H not a multiple of 64
OTHER_SOURCE = {
    "flash_fwd": "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
    "flash_bwd_dq": "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
    "flash_bwd_dkv": "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
    "fused_ce_fwd": "paddle_tpu_torch/ops/cuda/csrc/fused_ce.cu",
    "fused_ce_bwd_dh": "paddle_tpu_torch/ops/cuda/csrc/fused_ce.cu",
    "fused_ce_bwd_dw": "paddle_tpu_torch/ops/cuda/csrc/fused_ce.cu",
}
REPLACES = {
    "decode_attention": "paddle_tpu/ops/pallas/decode_attention.py:46",
    "paged_decode_attention":
        "paddle_tpu/ops/pallas/decode_attention.py:189",
    "fused_ce_fwd": "paddle_tpu/ops/pallas/fused_ce.py:41",
    "fused_ce_bwd_dh": "paddle_tpu/ops/pallas/fused_ce.py:145",
    "fused_ce_bwd_dw": "paddle_tpu/ops/pallas/fused_ce.py:173",
    "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:103",
    "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:234",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:272",
}
CE_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# launch_counts keys of the Hopper kernels
SM90_COUNTS = ("flash_fwd.sm90", "flash_bwd_dq.sm90", "flash_bwd_dkv.sm90")
CE_SM90_COUNTS = ("fused_ce_fwd.sm90", "fused_ce_bwd_dh.sm90",
                  "fused_ce_bwd_dw.sm90")
# launch_counts keys of the f16 launches (either kernel of a wrapper)
F16_COUNTS = ("flash_fwd.f16", "flash_bwd_dq.f16", "flash_bwd_dkv.f16")
CE_F16_COUNTS = ("fused_ce_fwd.f16", "fused_ce_bwd_dh.f16",
                 "fused_ce_bwd_dw.f16")
# Flash limits per quantity, as CE_TOL: "lse" absolute; "<x>_max" the
# largest |error| of x over its largest |entry|, "<x>_norm" the error's
# norm over x's. Set from the worst readings of phase 10 with headroom
# (PERF.md section 6 gives them): f32 2-8x; bf16 "_max" 1e-2, since one
# bf16 ulp of the largest entry is at most 2^-7 = 7.8e-3 of it and the
# readings are such single rounding flips, "_norm" 4-8x.
FLASH_TOL = {
    torch.float32: {"lse": 1e-5, "o_max": 2e-5, "o_norm": 5e-6,
                    "dq_max": 5e-6, "dq_norm": 5e-6, "dk_max": 5e-6,
                    "dk_norm": 5e-6, "dv_max": 1e-5, "dv_norm": 5e-6},
    torch.bfloat16: {"lse": 1e-5, "o_max": 1e-2, "o_norm": 1e-2,
                     "dq_max": 1e-2, "dq_norm": 2e-3, "dk_max": 1e-2,
                     "dk_norm": 2e-3, "dv_max": 1e-2, "dv_norm": 2e-3},
    # f16 (phase 14, -inf key biases included): from its worst readings
    # (lse 1.9e-6; o 8.4e-4 / 3.0e-4, dq 7.8e-4 / 2.3e-4, dk 7.7e-4 /
    # 1.5e-4, dv 7.1e-4 / 8.9e-5, max / norm) with 2.4-5x headroom; each
    # limit at or under bf16's
    torch.float16: {"lse": 1e-5, "o_max": 2e-3, "o_norm": 1e-3,
                    "dq_max": 2e-3, "dq_norm": 1e-3, "dk_max": 2e-3,
                    "dk_norm": 5e-4, "dv_max": 2e-3, "dv_norm": 5e-4},
}
# f32 GPT-2 step, flash kernels against the composite, as STEP_TOL; set
# from phase 11's readings (loss equal, gradients 2.8e-6, parameters
# 1.7e-6) with 6-7x headroom
GPT_STEP_TOL = {"loss": 1e-5, "grad": 2e-5, "param": 1e-5}
# f16 O2 BERT-base step, kernels against the composites (phase 16): loss
# absolute; each unscaled gradient's largest |difference| over its largest
# |entry|; the f32 masters after one AdamW step (lr 1e-4) absolute. Set
# from phase 16's readings (loss equal; gradients 2.1e-3; masters 1.8e-4):
# the loss to one f16 ulp at its size (7.8e-3 at 10.4), the gradients with
# 4.7x headroom, the masters at twice the learning rate, the most two
# first Adam steps can differ by (each moves an entry by lr * sign(g), and
# an entry whose gradient is near zero can move either way)
O2_STEP_TOL = {"loss": 7.8e-3, "grad": 1e-2, "master": 2e-4}
PEAK_NAME = "H100 SXM dense bf16 peak, 989 TFLOP/s (NVIDIA data sheet)"
PEAK_NAME_F16 = "H100 SXM dense f16 peak, 989 TFLOP/s (NVIDIA data sheet)"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.build_all()
    dt = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[build] nvcc {dt:.2f} s; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; card: {card}")
    for name in _build.SOURCES:
        for kernel, regs, spill_st, spill_ld in _ptxas_rows(
                _build.report(name)):
            log(f"[build] {name}.cu {kernel}: {regs} registers, spill "
                f"stores {spill_st} B, loads {spill_ld} B")
    return card


def _ptxas_rows(text):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in nvcc's -Xptxas -v report."""
    import re
    rows, name, spill = [], None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


# --------------------------------------------------------------------------
# phases 2-3: kernels against their plain versions
# --------------------------------------------------------------------------

def _fills(kind, b, top, gen):
    """Scalar or ragged [b] fills, covering 0 and the largest (top)."""
    if kind == "scalar0":
        return 0
    if kind == "scalar_top":
        return top
    f = torch.randint(0, top + 1, (b,), generator=gen)
    f[0], f[-1] = 0, top
    return f.to(torch.int32).cuda()


def _err(out, ref):
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    return float((out.float() - ref.float()).abs().max())


def _expect_path(dt, s, d):
    """The decode kernel a call takes (ops/cuda/decode_attention._path on
    16-byte aligned tensors, q and cache of one dtype)."""
    if s == 1:
        return "split" if d * torch.finfo(dt).bits // 8 % 16 == 0 \
            else "scalar"
    return "mma" if dt in HALF and d in (64, 128) else "scalar"


def decode_check(fn, args, ref, dt, what, cols):
    """One decode-kernel case: the output against the f32 plain version
    (absolute TOL and norm-relative DECODE_NORM_TOL), the kernel it ran on
    from the launch counters, and, on the Hopper kernels, a second launch
    that must give the same bits. Returns (abs error, norm error)."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda.decode_attention import _kv_splits, _n_sm
    q = args[0]
    b, h, s, d = q.shape
    name = fn.__name__
    before = kernels.launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    ran = "mma" if after[name + ".mma"] > before[name + ".mma"] else \
        "split" if after[name + ".sm90"] > before[name + ".sm90"] \
        else "scalar"
    want = _expect_path(dt, s, d)
    check(after[name] == before[name] + 1, f"{name}: {what} launched "
                                           f"{after[name] - before[name]}")
    check(ran == want, f"{name}: {what} ran the {ran} kernel, not {want}")
    check(out.shape == q.shape and out.dtype == q.dtype, "out shape")
    err = _err(out, ref)
    rel = float((out.float() - ref.float()).norm()
                / ref.float().norm().clamp_min(1e-30))
    splits = 1 if ran == "scalar" else _kv_splits(
        b, h, -(-s // 64), cols, _n_sm(q.device.index))[0]
    log(f"[{'paged' if 'paged' in name else 'contiguous'}] {what} "
        f"{ran} x{splits}: max_abs_err {err:.3e} (tol {TOL[dt]:g}), "
        f"norm_rel_err {rel:.3e} (tol {DECODE_NORM_TOL[dt]:g})")
    check(err <= TOL[dt], f"{name} disagrees: {what}: {err}")
    check(rel <= DECODE_NORM_TOL[dt], f"{name} disagrees in norm: {what}: "
                                      f"{rel}")
    if ran != "scalar":
        check(torch.equal(fn(*args), out), f"{name}: {what}: a second "
                                           "launch gave other bits")
    return err, rel


def phase_contiguous():
    from paddle_tpu_torch.ops.cuda import (decode_attention,
                                           decode_attention_ref)
    gen = torch.Generator().manual_seed(1)
    worst = {}
    # (dtype, b, s, d, L, fill kind)
    cases = [(dt, 3, s, 64, 512, kind)
             for dt in (torch.float32, *HALF)
             for s in (1, 7, 64, 300)
             for kind in ("scalar0", "scalar_top", "ragged")]
    cases += [(torch.float32, 3, s, 256, 512, "ragged") for s in (1, 7)]
    cases += [(dt, 3, s, 40, 512, "ragged") for dt in HALF for s in (1, 64)]
    # many splits: one or two rows over a 4096-column cache
    cases += [(dt, b, 1, d, 4096, kind)
              for dt in (torch.float32, *HALF) for b in (1, 2)
              for d in (64, 128) for kind in ("scalar_top", "ragged")]
    # chunks on the mma kernel at d 128, and a long one over 4096 columns
    cases += [(dt, 3, s, 128, 512, kind) for dt in HALF for s in (33, 300)
              for kind in ("scalar0", "ragged")]
    cases += [(dt, 1, 200, 64, 4096, "scalar_top") for dt in HALF]
    # q in another type than the cache: q is cast to the cache's type,
    # the output comes back in q's
    mixed = [(qd, cd) for qd in (torch.float32, *HALF)
             for cd in (torch.float32, *HALF) if qd != cd]
    h = 4
    for dt, b, s, d, L, kind in cases:
        q = torch.randn(b, h, s, d, generator=gen).to("cuda", dt)
        kc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
        vc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
        fill = _fills(kind, b, L - s, gen)
        ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fill)
        err, _ = decode_check(decode_attention, (q, kc, vc, fill), ref, dt,
                              f"{str(dt)[6:]} b={b} s={s} d={d} L={L} "
                              f"fill={kind}", L)
        worst[dt] = max(worst.get(dt, 0.0), err)
    for qd, cd in mixed:
        for s in (1, 64):
            q = torch.randn(3, h, s, 64, generator=gen).to("cuda", qd)
            kc = torch.randn(3, h, 512, 64, generator=gen).to("cuda", cd)
            vc = torch.randn(3, h, 512, 64, generator=gen).to("cuda", cd)
            fill = _fills("ragged", 3, 512 - s, gen)
            ref = decode_attention_ref(q.to(cd).float(), kc.float(),
                                       vc.float(), fill)
            out = decode_attention(q, kc, vc, fill)
            torch.cuda.synchronize()
            # the looser of the two types' limits: the output is rounded
            # to q's type, the scores are formed from the cache's
            tol = max(TOL[qd], TOL[cd])
            err = _err(out, ref)
            log(f"[contiguous] q {str(qd)[6:]} cache {str(cd)[6:]} s={s}: "
                f"max_abs_err {err:.3e} (tol {tol:g})")
            check(out.dtype == qd and err <= tol,
                  f"decode_attention q {qd} cache {cd} s={s}: {out.dtype}, "
                  f"{err}")
    check(decode_attention.launches > 0, "contiguous kernel never launched")
    log(f"[contiguous] launches {decode_attention.launches}, on the Hopper "
        f"kernels {decode_attention.launches_sm90} (mma "
        f"{decode_attention.launches_mma})")
    return worst


def _paged_case(b, h, s, d, bs, nb, dt, fill, gen):
    """A random arena with shuffled block tables; entries past each
    row's allocation are 0 (the trash block)."""
    fills = fill if isinstance(fill, torch.Tensor) \
        else torch.full((b,), fill, dtype=torch.int32)
    need = [-(-(int(f) + s) // bs) for f in fills.cpu()]
    n_blocks = sum(need) + 3
    perm = (torch.randperm(n_blocks, generator=gen) + 1).tolist()
    bt = torch.zeros(b, nb, dtype=torch.int32)
    for i, n in enumerate(need):
        bt[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    ka = torch.randn(n_blocks + 1, h, bs, d, generator=gen).to("cuda", dt)
    va = torch.randn(n_blocks + 1, h, bs, d, generator=gen).to("cuda", dt)
    q = torch.randn(b, h, s, d, generator=gen).to("cuda", dt)
    return q, ka, va, bt.cuda(), fills.to("cuda", torch.int32)


def phase_paged():
    """The paged kernel against its plain version; then, on each case's
    values gathered into a contiguous cache of L = nb * bs columns, the
    contiguous kernel must give the paged kernel's bits."""
    from paddle_tpu_torch.ops.cuda import (decode_attention,
                                           paged_attention_ref,
                                           paged_decode_attention)
    from paddle_tpu_torch.ops.cuda.decode_attention import gather_pages
    gen = torch.Generator().manual_seed(2)
    worst = {}
    h = 4
    # (dtype, b, s, d, bs, nb, fill kind)
    cases = [(dt, 3, s, 64, bs, 512 // bs, kind)
             for dt in (torch.float32, *HALF) for bs in (16, 128)
             for s in (1, 7, 64, 300)
             for kind in ("scalar0", "scalar_top", "ragged")]
    cases += [(dt, b, 1, 64, bs, 4096 // bs, kind)
              for dt in (torch.float32, *HALF) for b in (1, 2)
              for bs in (24, 128) for kind in ("scalar_top", "ragged")]
    cases += [(dt, 3, s, 128, bs, 512 // bs, "ragged") for dt in HALF
              for s in (33, 300) for bs in (24, 128)]
    equal = 0
    for dt, b, s, d, bs, nb, kind in cases:
        fill = _fills(kind, b, nb * bs - s, gen)
        q, ka, va, bt, lens = _paged_case(b, h, s, d, bs, nb, dt, fill, gen)
        ref = paged_attention_ref(q.float(), ka.float(), va.float(), bt,
                                  lens)
        what = f"{str(dt)[6:]} b={b} s={s} d={d} bs={bs} nb={nb} fill={kind}"
        err, _ = decode_check(paged_decode_attention, (q, ka, va, bt, lens),
                              ref, dt, what, nb * bs)
        worst[dt] = max(worst.get(dt, 0.0), err)
        out = paged_decode_attention(q, ka, va, bt, lens)
        contig = decode_attention(q, gather_pages(ka, bt),
                                  gather_pages(va, bt), lens)
        check(torch.equal(contig, out), f"contiguous != paged bitwise: "
                                        f"{what}")
        equal += 1
    check(paged_decode_attention.launches > 0, "paged kernel never launched")
    log(f"[paged] launches {paged_decode_attention.launches}, on the Hopper "
        f"kernels {paged_decode_attention.launches_sm90} (mma "
        f"{paged_decode_attention.launches_mma}); contiguous = paged "
        f"bitwise in {equal} of {len(cases)} cases")
    return worst


# --------------------------------------------------------------------------
# phase 4: the main path at full width
# --------------------------------------------------------------------------

def _top2_gap(net, prefix):
    with torch.no_grad():
        lg = net(torch.tensor(prefix, device="cuda")[None])[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def phase_serve_f32():
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    net = GPT(GPTConfig(), device="cuda", dtype=torch.float32, seed=0)
    net.eval()
    rng = np.random.RandomState(0)
    new = 48
    prompts = [rng.randint(1, 50304, (n,)).astype(np.int64)
               for n in (5, 17, 9, 33, 12, 3, 24, 40)]
    loop = ServeLoop(net, ServeConfig(max_active=4, kv_blocks=64,
                                      max_seq_len=128))
    t0 = time.perf_counter()
    served = loop.serve(prompts, max_new_tokens=new)
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = [net.generate(p[None], max_new_tokens=new, temperature=0)
            [0, len(p):].cpu().numpy() for p in prompts]
    t_gen = time.perf_counter() - t0
    near_ties = []
    for i, (p, got, ref) in enumerate(zip(prompts, served, refs)):
        check(got.shape == (new,), f"request {i} returned {got.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        gap = _top2_gap(net, np.concatenate([p, ref[:j]]))
        log(f"[serve f32] request {i} diverges at token {j}: served "
            f"{got[j]} vs generate {ref[j]}, top-2 logit gap {gap:.3e}")
        check(gap < 1e-4, "divergence without a near-tie")
        near_ties.append((i, j, gap))
    log(f"[serve f32] {len(prompts)} requests x {new} tokens: served "
        f"{t_serve:.2f} s, sequential generate {t_gen:.2f} s; "
        f"token-identical {len(prompts) - len(near_ties)}/{len(prompts)}"
        f", near-ties {near_ties}; pool block size {loop.stats()['block_size']}")
    check(loop.stats()["kv_pool_used_blocks"] == 0, "pool leaked blocks")
    del net, loop


def phase_serve_bf16():
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    n_req, prompt, new, clients = 64, 32, 64, 32
    cfg = GPTConfig()
    net = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.eval()
    loop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                      max_seq_len=prompt + new))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (prompt,)).astype(np.int64)
               for _ in range(n_req)]
    loop.serve([prompts[0]], max_new_tokens=2)      # warm-up
    monitor.reset(prefix="serve.")
    monitor.reset(prefix="serve/")
    loop.start()
    reqs = [None] * n_req

    def client(base):
        for i in range(base, n_req, clients):
            reqs[i] = loop.submit(prompts[i], max_new_tokens=new)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ths = [threading.Thread(target=client, args=(c,))
           for c in range(clients)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
        check(not t.is_alive(), "client thread hung")
    outs = [r.result(timeout=600) for r in reqs]
    dt = time.perf_counter() - t0
    loop.stop()
    profile = _profile_serve_decode(loop, prompts, new)
    for o in outs:
        check(o.shape == (new,) and o.min() >= 0 and o.max() < cfg.vocab_size,
              "bad served tokens")
    ttft = [r.ttft_s * 1e3 for r in reqs]
    tok = [r.per_token_s * 1e3 for r in reqs]
    toks = sum(len(o) for o in outs)
    res = {"tokens_per_s": toks / dt, "requests": n_req, "prompt": prompt,
           "new": new, "clients": clients, "wall_s": dt,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "token_ms_p50": float(np.percentile(tok, 50)),
           "token_ms_p99": float(np.percentile(tok, 99)),
           "block_size": loop.stats()["block_size"],
           "decode_steps": loop.stats()["steps"],
           "decode_profile": profile}
    log(f"[serve bf16] {json.dumps(res)}")
    # the same model through generate: one static batch of all prompts
    ids = torch.tensor(np.stack(prompts), device="cuda")
    net.generate(ids[:2], max_new_tokens=2, temperature=0)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = net.generate(ids, max_new_tokens=new, temperature=0)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    check(out.shape == (n_req, prompt + new), "generate shape")
    with torch.no_grad():
        lg = net(ids[:4])
    check(bool(torch.isfinite(lg.float()).all()), "non-finite bf16 logits")
    log(f"[generate bf16] batch {n_req} x {new} new tokens: "
        f"{n_req * new / dt_gen:.1f} tokens/s ({dt_gen:.3f} s)")
    res["generate_tokens_per_s"] = n_req * new / dt_gen
    return res


DECODE_KERNEL_NAMES = ("decode_split_kernel", "decode_mma_kernel",
                       "decode_combine_kernel", "decode_attn_kernel")


def _profile_serve_decode(loop, prompts, new, n=20):
    """The (stopped) serve loop driven on this thread with every slot
    active, each beat one fused decode step: the wall ms per step over
    ``n`` beats, then torch.profiler over ``n`` more for the device's busy
    ms and the paged decode kernels' ms per step; the idle share is 1 -
    busy / wall. None where the profiler records no device time here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [loop.submit(p, max_new_tokens=new) for p in prompts]
    while loop.stats()["queue_depth"] or \
            loop.stats()["active_slots"] < len(prompts):
        loop._tick()
    for _ in range(3):
        loop._tick()
    # the wall time per step from n beats without the profiler (its host
    # overhead would inflate it), then the device time from n beats under it
    torch.cuda.synchronize()
    s0 = loop.stats()["steps"]
    active = loop.stats()["active_slots"]
    t0 = time.perf_counter()
    for _ in range(n):
        loop._tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (loop.stats()["steps"] - s0)
    s0 = loop.stats()["steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            loop._tick()
        torch.cuda.synchronize()
    steps = loop.stats()["steps"] - s0
    loop.run_until_idle()
    for r in reqs:
        check(r.result(timeout=60).shape == (new,), "profiled request")
    rows = [(ev.self_device_time_total / 1e3, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        log("[serve decode profile] not measured: no device time recorded")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    attn = sum(r[0] for r in rows
               if any(k in r[1] for k in DECODE_KERNEL_NAMES))
    out = {"decode_steps": steps, "active_slots": active,
           "wall_ms_per_step": wall,
           "device_busy_ms_per_step": busy / steps,
           "paged_kernel_ms_per_step": attn / steps,
           "device_idle_share": 1 - busy / steps / wall,
           "top": [{"ms_per_step": r[0] / steps, "kernel": r[1][:80]}
                   for r in rows[:8]]}
    log(f"[serve decode profile] {json.dumps(out)}")
    return out


def phase_main_path():
    from paddle_tpu_torch.ops import cuda as kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    phase_serve_f32()
    serve = phase_serve_bf16()
    counts = kernels.launch_counts()
    log(f"[main path] {time.perf_counter() - t0:.1f} s; kernel launches "
        f"{counts}")
    for name in ("decode_attention", "paged_decode_attention"):
        check(counts[name] > 0, f"{name} never launched on the main path")
        # decode steps on the split-K kernel, prefills (generate's s 32,
        # the serve loop's 32-token bucket) on the mma kernel
        check(counts[name + ".sm90"] > counts[name + ".mma"] > 0,
              f"{name}: decode steps or prefills missed the Hopper kernels: "
              f"{counts[name + '.sm90']} Hopper launches, "
              f"{counts[name + '.mma']} of them chunks")
    return counts, serve


# --------------------------------------------------------------------------
# phase 5: timings
# --------------------------------------------------------------------------

_FLUSH = None


def time_ms(fn, runs=30, warmup=3):
    """Median device time of fn() over ``runs``, each after an L2 flush."""
    return statistics.median(time_samples(fn, runs, warmup))


def time_samples(fn, runs=30, warmup=3):
    """Device times (ms) of fn() over ``runs``, each after an L2 flush.
    A ~1 ms device sleep before the flush keeps the device busy while the
    host enqueues the events and fn, so a kernel shorter than its
    wrapper's host time is timed without the host's gaps."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                             device="cuda")          # 256 MB > 50 MB L2
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        torch.cuda._sleep(2_000_000)
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(a.elapsed_time(e))
    return ts


def bound(b, h, s, d, fill, dt):
    """Least time for the work: each input read once (q and the LIVE K/V
    columns), the output written once, against the HBM rate; or the
    attention flops against the peak rate of the input type."""
    el = torch.finfo(dt).bits // 8
    live = fill + s
    nbytes = b * h * (2 * s * d + 2 * live * d) * el + b * 4
    flops = 4 * d * b * h * (s * fill + s * (s + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_shape(b, s, fill, L, bs, dt=torch.bfloat16, h=12, d=64):
    """Both kernels, plain versions and the SDPA yardstick at one shape."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import (decode_attention,
                                           decode_attention_ref,
                                           paged_attention_ref,
                                           paged_decode_attention)
    from paddle_tpu_torch.ops.cuda.decode_attention import gather_pages
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(b, h, s, d, generator=gen).to("cuda", dt)
    kc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
    vc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
    nb = -(-L // bs)
    q2, ka, va, bt, lens = _paged_case(b, h, s, d, bs, nb, dt, fill, gen)
    row = fill + torch.arange(s, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] <= row[:, None])
    kg, vg = gather_pages(ka, bt), gather_pages(va, bt)
    maskg = (torch.arange(nb * bs, device="cuda")[None] <= row[:, None])
    bnd, by = bound(b, h, s, d, fill, dt)
    # right at these shapes too, against the f32 plain version
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fill)
    err = _err(decode_attention(q, kc, vc, fill), ref)
    ref_p = paged_attention_ref(q2.float(), ka.float(), va.float(), bt, lens)
    err_p = _err(paged_decode_attention(q2, ka, va, bt, lens), ref_p)
    torch.cuda.synchronize()
    check(max(err, err_p) <= TOL[dt], f"kernels disagree: {err} {err_p}")
    out = {}
    out["decode_attention"] = {
        "ms": time_ms(lambda: decode_attention(q, kc, vc, fill)),
        "plain_ms": time_ms(lambda: decode_attention_ref(q, kc, vc, fill)),
        "library_ms": time_ms(lambda: tF.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask)),
        "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
    out["paged_decode_attention"] = {
        "ms": time_ms(lambda: paged_decode_attention(q2, ka, va, bt, lens)),
        "plain_ms": time_ms(lambda: paged_attention_ref(q2, ka, va, bt,
                                                        lens)),
        "library_ms": time_ms(lambda: tF.scaled_dot_product_attention(
            q2, kg, vg, attn_mask=maskg)),
        "bound_ms": bnd, "bound_by": by, "max_abs_err": err_p}
    for name, r in out.items():
        log(f"[timing] {name} b={b} h={h} s={s} d={d} fill={fill} "
            f"{str(dt)[6:]} (max_abs_err {r['max_abs_err']:.3e}): "
            f"kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def phase_timings(block_size, dt=torch.bfloat16):
    """Both kernels at the serve run's shapes and at GPT-2's full context
    (L 1024, the pool's block size 128 there), in ``dt``:
    {shape: _time_shape}."""
    shapes = {
        # the bf16 serve run's full batch at its longest live length
        # (prompt 32 + 64 new = 96 tokens), and one 32-token prompt
        "serve_decode": dict(b=64, s=1, fill=95, L=96, bs=block_size),
        "prefill_s32": dict(b=1, s=32, fill=0, L=96, bs=block_size),
        # the full batch at the full context; one stream there (split-K);
        # the longest prefill bucket of a 1024-token serve loop
        "decode_b64_fill1023": dict(b=64, s=1, fill=1023, L=1024, bs=128),
        "decode_b1_fill1023": dict(b=1, s=1, fill=1023, L=1024, bs=128),
        "prefill_b1_s1024": dict(b=1, s=1024, fill=0, L=1024, bs=128),
    }
    return {k: _time_shape(**v, dt=dt) for k, v in shapes.items()}


# --------------------------------------------------------------------------
# phase 6: the fused-CE kernels against their plain versions
# --------------------------------------------------------------------------

def _ce_inputs(n, hd, vocab, dt, bias, gen, ignored=0.3, oob=True):
    """h ~ N(0, 1), W ~ N(0, 0.05^2) (logits O(1)), labels with
    ``ignored`` of the rows at -100 and, with ``oob``, two labels outside
    [0, V) (-5 and V + 3); upstream g ~ U(0, 1)."""
    h = torch.randn(n, hd, generator=gen).to("cuda", dt)
    w = (0.05 * torch.randn(vocab, hd, generator=gen)).to("cuda", dt)
    b = (0.05 * torch.randn(vocab, generator=gen)).to("cuda", dt) \
        if bias else None
    y = torch.randint(0, vocab, (n,), generator=gen)
    y[torch.rand(n, generator=gen) < ignored] = -100
    if oob and n >= 3:
        y[1], y[2] = -5, vocab + 3
    g = torch.rand(n, generator=gen).to("cuda")
    return h, w, b, y.to("cuda"), g


def _rel_errs(got, ref):
    """(largest |error| / largest |entry|, ||error|| / ||entry||)."""
    check(bool(torch.isfinite(got.float()).all()), "non-finite output")
    d, r = got.float() - ref.float(), ref.float()
    return (float(d.abs().max() / r.abs().max().clamp_min(1e-30)),
            float(d.norm() / r.norm().clamp_min(1e-30)))


def ce_errors(h, w, b, y, g, where, repeat=False):
    """Errors of the three kernels against the f32 plain versions on the
    same inputs, checked against CE_TOL: absolute for loss/lse, dh and dW
    (under the kernels' names) and the relative ones of ``_rel_errs`` for
    dh, dW and db. With ``repeat``, ``fused_ce_bwd`` (both gradients from
    one call) and a second launch of each wrapper (the forward too) must
    give the same bits as the first."""
    from paddle_tpu_torch.ops.cuda import (fused_ce_bwd, fused_ce_bwd_dh,
                                           fused_ce_bwd_dw, fused_ce_bwd_ref,
                                           fused_ce_fwd, fused_ce_fwd_ref)
    f32 = [None if t is None else t.float() for t in (h, w, b)]
    ref_loss, ref_lse = fused_ce_fwd_ref(*f32, y)
    loss, lse = fused_ce_fwd(h, w, b, y)
    dh = fused_ce_bwd_dh(h, w, b, y, ref_lse, g)
    dw, db = fused_ce_bwd_dw(h, w, b, y, ref_lse, g)
    if repeat:
        loss2, lse2 = fused_ce_fwd(h, w, b, y)
        check(torch.equal(loss, loss2) and torch.equal(lse, lse2),
              f"two forward launches differ at {where}")
        both = fused_ce_bwd(h, w, b, y, ref_lse, g)
        again = (fused_ce_bwd_dh(h, w, b, y, ref_lse, g),
                 *fused_ce_bwd_dw(h, w, b, y, ref_lse, g))
        for label, got in (("fused_ce_bwd", both), ("a second launch", again)):
            check(all(x is y_ if x is None else torch.equal(x, y_)
                      for x, y_ in zip((dh, dw, db), got)),
                  f"{label} differs from the first dh and dW launches at "
                  f"{where}")
    torch.cuda.synchronize()
    dh_r, dw_r, db_r = fused_ce_bwd_ref(h, w, b, y, ref_lse, g)
    check(dh.dtype == h.dtype and dw.dtype == w.dtype, "grad dtypes")
    check((db is None) == (b is None), "db without a bias")
    out = {"fused_ce_fwd": max(_err(loss, ref_loss), _err(lse, ref_lse)),
           "fused_ce_bwd_dh": _err(dh, dh_r),
           "fused_ce_bwd_dw": _err(dw, dw_r)}
    out["dh_max"], out["dh_norm"] = _rel_errs(dh, dh_r)
    out["dw_max"], out["dw_norm"] = _rel_errs(dw, dw_r)
    if b is not None:
        out["db_max"], out["db_norm"] = _rel_errs(db, db_r)
    ignored = y == -100
    check(bool((loss[ignored] == 0).all()), "ignored rows have a loss")
    for k, tol in CE_TOL[h.dtype].items():
        if k in out:
            check(out[k] <= tol, f"{k} {out[k]:.3e} > {tol:g} at {where}")
    return out


def _ce_line(errs):
    return (f"loss/lse {errs['fused_ce_fwd']:.2e}; dh abs "
            f"{errs['fused_ce_bwd_dh']:.2e} max {errs['dh_max']:.2e} norm "
            f"{errs['dh_norm']:.2e}; dW abs {errs['fused_ce_bwd_dw']:.2e} max "
            f"{errs['dw_max']:.2e} norm {errs['dw_norm']:.2e}"
            + (f"; db max {errs['db_max']:.2e} norm {errs['db_norm']:.2e}"
               if "db_max" in errs else ""))


def phase_ce(dtypes=(torch.float32, torch.bfloat16)):
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda.fused_ce import (_sm90_bwd_path,
                                                    _sm90_fwd_path)
    gen = torch.Generator().manual_seed(6)
    # BERT's head (4096, 30522, 768) and GPT-2's (4096, 50304, 768); the
    # last: H not a multiple of 64 (bf16 on fused_ce.cu's kernels)
    shapes = [(8, 517, 64), (1000, 517, 1024), (4096, 517, 64),
              (1000, 30522, 768), (4096, 30522, 768), (4096, 50304, 768),
              (4096, 50304, 1024), (300, 517, 72)]
    cases = [(dt, bias, n, v, hd, 0.3) for dt in dtypes
             for bias in (True, False) for n, v, hd in shapes]
    cases += [(dt, True, 1000, 517, 768, 1.0) for dt in dtypes]  # all ignored
    worst = {}
    t0 = time.perf_counter()
    n_sm90 = 0
    for dt, bias, n, v, hd, ign in cases:
        where = (f"{str(dt)[6:]} bias={bias} n={n} V={v} H={hd} "
                 f"ignored={ign:.0%}")
        sm90 = int(_sm90_bwd_path(dt, hd))
        fwd90 = int(_sm90_fwd_path(dt, hd))
        before = kernels.launch_counts()
        errs = ce_errors(*_ce_inputs(n, hd, v, dt, bias, gen, ignored=ign,
                                     oob=ign < 1), where, repeat=bool(sm90))
        used = {k: kernels.launch_counts()[k] - before[k]
                for k in CE_KERNELS + CE_SM90_COUNTS + CE_F16_COUNTS}
        # a Hopper case repeats every launch (the forward once more)
        want = {"fused_ce_fwd": 1 + sm90, "fused_ce_bwd_dh": 1 + 2 * sm90,
                "fused_ce_bwd_dw": 1 + 2 * sm90,
                "fused_ce_fwd.sm90": (1 + sm90) * fwd90,
                "fused_ce_bwd_dh.sm90": 3 * sm90,
                "fused_ce_bwd_dw.sm90": 3 * sm90}
        f16 = dt == torch.float16
        want.update({f"{k}.f16": want[k] * f16 for k in CE_KERNELS})
        check(used == want, f"CE kernel variants at {where}: launched "
                            f"{used}, want {want}")
        n_sm90 += sm90
        log(f"[ce] {where}: {_ce_line(errs)}")
        for k, e in errs.items():
            worst.setdefault(k, {})
            worst[k][dt] = max(worst[k].get(dt, 0.0), e)
    log(f"[ce] {len(cases)} cases ({n_sm90} on the Hopper forward and "
        f"backward, each repeated bitwise) in {time.perf_counter() - t0:.1f}"
        f" s; limits "
        f"{json.dumps({str(k)[6:]: CE_TOL[k] for k in dtypes})}; worst "
        + json.dumps({key: {str(t)[6:]: e for t, e in w.items()}
                      for key, w in worst.items()}))
    return worst


# --------------------------------------------------------------------------
# phases 7-8: BERT-base training at full width
# --------------------------------------------------------------------------

def _bert_batches(cfg, batch, seq, n_batches, seed=0):
    from paddle_tpu_torch.text.datasets import LMDataset
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                   n=n_batches * batch, mode="mlm", seed=seed)
    ids = torch.from_numpy(ds.inputs.reshape(n_batches, batch, seq))
    lab = torch.from_numpy(ds.labels.reshape(n_batches, batch, seq))
    return ids.to("cuda"), lab.to("cuda")


def _zero_missing_grads(net):
    """A zero grad on every trainable parameter that autograd left at None
    (BERT's pooler and token-type table), as ``jax.grad`` gives in
    ``bench.py:_build``'s step: ``step()`` skips a None grad, and the
    zeros keep those parameters' moments and AdamW decay moving."""
    for p in net.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


def _train_step(net, opt, ids, lab):
    loss = net(ids, masked_lm_labels=lab)
    loss.backward()
    _zero_missing_grads(net)
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _grad_rel(gk, gp):
    """Largest |difference| over largest |entry| of two gradients (0 when
    neither exists)."""
    check((gk is None) == (gp is None), "a gradient exists on one path only")
    if gk is None:
        return 0.0
    return float((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30))


def phase_bert_equivalence():
    """One f32 AdamW step of BERT-base through the CE kernels and one with
    FLAGS_use_fused_ce off, from the same weights on the same batch: the
    losses, every parameter's gradient before the step (Adam's first step
    is +-lr whatever the gradient's scale, so the parameters alone would
    see only its signs) and the parameters after it."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig.bert_base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    ids, lab = _bert_batches(cfg, 8, 128, 1)
    out = {}
    for fused in (True, False):
        flags.set_flags({"FLAGS_use_fused_ce": fused})
        try:
            net = Bert(cfg, device="cuda", dtype=torch.float32, seed=0)
            net.train()
            opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                        parameters=net.named_parameters())
            before = kernels.launch_counts()
            loss = net(ids[0], masked_lm_labels=lab[0])
            loss.backward()
            grads = {k: None if p.grad is None else p.grad.detach().clone()
                     for k, p in net.named_parameters()}
            _zero_missing_grads(net)
            opt.step()
            opt.clear_grad()
            used = {k: kernels.launch_counts()[k] - before[k]
                    for k in CE_KERNELS}
            check(set(used.values()) == {1 if fused else 0},
                  f"flag did not route the head: {used}")
            out[fused] = (float(loss.detach()), grads,
                          {k: p.detach().clone()
                           for k, p in net.named_parameters()})
        finally:
            flags.set_flags({"FLAGS_use_fused_ce": True})
        del net, opt
    (lk, gk, pk), (lp, gp, pp) = out[True], out[False]
    rel = abs(lk - lp) / abs(lp)
    dgrad = {k: _grad_rel(gk[k], gp[k]) for k in gk}
    worst = max(dgrad, key=dgrad.get)
    dparam = max(float((pk[k] - pp[k]).abs().max()) for k in pk)
    log(f"[bert f32 equivalence] b8 s128: loss kernels {lk:.7f} plain "
        f"{lp:.7f} (rel {rel:.2e}, tol {STEP_TOL['loss']:g}); gradients "
        f"largest rel diff {dgrad[worst]:.2e} ({worst}; tol "
        f"{STEP_TOL['grad']:g}), tied word embeddings "
        f"{dgrad['embeddings.word_embeddings.weight']:.2e}, mlm_bias "
        f"{dgrad['mlm_bias']:.2e}; params after one AdamW step max abs "
        f"diff {dparam:.2e} (tol {STEP_TOL['param']:g}) over {len(pk)} "
        f"tensors, {sum(g is None for g in gk.values())} without a gradient")
    check(np.isfinite(lk) and rel <= STEP_TOL["loss"], "BERT loss differs")
    check(dgrad[worst] <= STEP_TOL["grad"],
          f"BERT gradient {worst} differs: {dgrad[worst]}")
    check(dparam <= STEP_TOL["param"], "BERT parameters differ after a step")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": rel,
            "grad_max_rel_diff": dgrad[worst], "grad_worst": worst,
            "param_max_abs_diff": dparam}


def _profile_steps(step, n=3, named=(), steps_per_call=1):
    """Device time by kernel over ``n`` calls of ``step``, each of
    ``steps_per_call`` training steps (torch.profiler, CUDA kernel rows
    only), and per step the summed time of the kernels whose names hold
    each string of ``named``; None where the profiler records no device
    time here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    n *= steps_per_call
    rows = [(ev.self_device_time_total / 1e3 / n, ev.key, ev.count // n)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        return None
    rows.sort(reverse=True)
    out = {"device_busy_ms_per_step": sum(r[0] for r in rows),
           "top": [{"ms_per_step": r[0], "kernel": r[1][:80],
                    "calls_per_step": r[2]} for r in rows[:12]]}
    if named:
        out["kernel_ms_per_step"] = {
            name: sum(r[0] for r in rows if name in r[1]) for name in named}
    return out


def _step_breakdown(net, opt, ids, lab, step_ms, n=10):
    """Where the flagship step's time goes: forward + backward alone (the
    step without the optimizer), the optimizer's host time, and the
    device's busy time per step with the idle share it leaves."""
    def fwd_bwd():
        net(ids[0], masked_lm_labels=lab[0]).backward()

    fwd_bwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fwd_bwd()
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) * 1e3 / n
    _zero_missing_grads(net)
    t0 = time.perf_counter()
    opt.step()
    opt_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    opt.clear_grad()
    out = {"fwd_bwd_ms": fb_ms, "optimizer_host_ms": opt_host_ms}
    try:
        prof = _profile_steps(lambda: _train_step(net, opt, ids[1], lab[1]))
    except Exception as e:   # the measurement is optional, the step is not
        prof = None
        log(f"[flagship profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        out.update(prof)
        out["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
            / step_ms
    return out


def phase_flagship():
    """bench.py's flagship shape: BERT-base, bf16 O2, b32 s128."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import Bert, BertConfig
    batch, seq, warmup, steps, n_batches = 32, 128, 5, 30, 16
    cfg = BertConfig.bert_base()
    ids, lab = _bert_batches(cfg, batch, seq, n_batches)
    kernels.reset_launch_counts()
    t_path = time.perf_counter()
    net = Bert(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.train()
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=net.named_parameters(), multi_precision=True)
    n_params = net.num_params()
    it = itertools.count()

    def step():
        i = next(it) % n_batches
        return _train_step(net, opt, ids[i], lab[i])

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step()
        if i in (0, steps - 1):
            losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    loss_start, loss_end = (float(x) for x in losses)
    tokens = batch * seq
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    flops = 6 * n_params * tokens + 12 * L * H * seq * tokens
    res = {"config": "bert_base", "dtype": "bfloat16", "batch": batch,
           "seq": seq, "params": n_params, "warmup": warmup, "steps": steps,
           "step_ms": dt * 1e3 / steps,
           "samples_per_s": steps * batch / dt,
           "tokens_per_s": steps * tokens / dt,
           "mfu": flops * steps / dt / PEAK_FLOPS[torch.bfloat16],
           "mfu_peak": PEAK_NAME,
           "loss_start": loss_start, "loss_end": loss_end,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: counts[k]
                        for k in CE_KERNELS + FLASH_KERNELS + SM90_COUNTS
                        + CE_SM90_COUNTS}}
    log(f"[flagship] {json.dumps(res)}")
    for k in CE_KERNELS:
        check(counts[k] > 0, f"{k} never launched on the training path")
    for k in CE_SM90_COUNTS:   # bf16 at H 768: every backward on Hopper's
        check(counts[k] == counts[k[:-5]], f"{k} launched {counts[k]} of "
                                           f"{counts[k[:-5]]} times")
    # at s 128 the attention takes the flash kernels once the default
    # FLAGS_flash_min_seq admits it
    from paddle_tpu_torch.core import flags
    want = L * (warmup + steps) \
        if flags.flag("FLAGS_flash_min_seq") <= seq else 0
    for k in FLASH_KERNELS + SM90_COUNTS:
        check(counts[k] == want, f"{k} launched {counts[k]} times on the "
                                 f"training path, not {want}")
    check(np.isfinite(loss_start) and np.isfinite(loss_end),
          "non-finite loss")
    check(loss_end < loss_start, "loss did not fall")
    log(f"[training path] {time.perf_counter() - t_path:.1f} s; kernel "
        f"launches {counts}")
    res["breakdown"] = _step_breakdown(net, opt, ids, lab, res["step_ms"])
    log(f"[flagship breakdown] {json.dumps(res['breakdown'])}")
    del net, opt
    return counts, res


# --------------------------------------------------------------------------
# phase 9: CE timings
# --------------------------------------------------------------------------

def ce_bound(kernel, n, n_valid, hd, vocab, dt, bias):
    """Least time: inputs read once and outputs written once over the HBM
    rate, or the products' flops over the peak of the input type. The
    forward needs every row (lse is an output for all); dh and dW need only
    the valid rows (an ignored row's ds is zero), each the recompute and
    its own product; ``fused_ce_bwd`` (dh, dW and db) one recompute and
    both products."""
    el = torch.finfo(dt).bits // 8
    nbytes = (n * hd + vocab * hd + (vocab if bias else 0)) * el + n * 4
    if kernel == "fused_ce_fwd":
        nbytes += 2 * n * 4                          # loss, lse
        flops = 2 * n * hd * vocab
    else:
        nbytes += 2 * n * 4                          # lse, g
        if kernel != "fused_ce_bwd_dw":
            nbytes += n * hd * el                    # dh
        if kernel != "fused_ce_bwd_dh":
            nbytes += (vocab * hd + (vocab if bias else 0)) * el   # dW, db
        products = 3 if kernel == "fused_ce_bwd" else 2
        flops = 2 * products * n_valid * hd * vocab
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _ce_time_shape(n, hd, vocab, bias, ignored, dt=torch.bfloat16):
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import (fused_ce_bwd, fused_ce_bwd_dh,
                                           fused_ce_bwd_dw, fused_ce_bwd_ref,
                                           fused_ce_fwd, fused_ce_fwd_ref)
    gen = torch.Generator().manual_seed(9)
    h, w, b, y, g = _ce_inputs(n, hd, vocab, dt, bias, gen, ignored=ignored,
                               oob=False)
    n_valid = int((y != -100).sum())
    errs = ce_errors(h, w, b, y, g, f"n={n} ({n_valid} valid) H={hd} "
                     f"V={vocab} bias={bias} {str(dt)[6:]}", repeat=True)
    log(f"[ce timing] errors: {_ce_line(errs)}")
    _, lse = fused_ce_fwd(h, w, b, y)
    hl = h.detach().requires_grad_()
    wl = w.detach().requires_grad_()
    bl = None if b is None else b.detach().requires_grad_()
    lib_loss = tF.cross_entropy(tF.linear(hl, wl, bl).float(), y.long(),
                                ignore_index=-100, reduction="none")
    # the library's backward for one kernel's outputs: dh alone, dW (and
    # db) alone, or all of them; each forms the [n, V] dlogits
    lib_wrt = {"fused_ce_bwd_dh": (hl,),
               "fused_ce_bwd_dw": (wl,) if bl is None else (wl, bl)}
    lib_wrt["fused_ce_bwd"] = lib_wrt["fused_ce_bwd_dh"] \
        + lib_wrt["fused_ce_bwd_dw"]

    def lib_grad(name):
        return lambda: torch.autograd.grad(lib_loss, lib_wrt[name],
                                           grad_outputs=g, retain_graph=True)

    timed = {
        "fused_ce_fwd": (lambda: fused_ce_fwd(h, w, b, y),
                         lambda: fused_ce_fwd_ref(h, w, b, y),
                         lambda: tF.cross_entropy(
                             tF.linear(h, w, b).float(), y.long(),
                             ignore_index=-100, reduction="none")),
        "fused_ce_bwd_dh": (lambda: fused_ce_bwd_dh(h, w, b, y, lse, g),
                            lambda: fused_ce_bwd_ref(h, w, b, y, lse, g,
                                                     need_dw=False),
                            lib_grad("fused_ce_bwd_dh")),
        "fused_ce_bwd_dw": (lambda: fused_ce_bwd_dw(h, w, b, y, lse, g),
                            lambda: fused_ce_bwd_ref(h, w, b, y, lse, g,
                                                     need_dh=False),
                            lib_grad("fused_ce_bwd_dw")),
        "fused_ce_bwd": (lambda: fused_ce_bwd(h, w, b, y, lse, g),
                         lambda: fused_ce_bwd_ref(h, w, b, y, lse, g),
                         lib_grad("fused_ce_bwd")),
    }
    out = {}
    for name, (kern, plain, lib) in timed.items():
        bnd, by = ce_bound(name, n, n_valid, hd, vocab, dt, bias)
        full, _ = ce_bound(name, n, n, hd, vocab, dt, bias)
        out[name] = {
            "ms": time_ms(kern, runs=20), "plain_ms": time_ms(plain, runs=20),
            "library_ms": time_ms(lib, runs=20),
            "bound_ms": bnd, "bound_by": by, "bound_all_rows_ms": full,
            "n": n, "n_valid": n_valid, "H": hd, "V": vocab, "bias": bias}
        # fused_ce.cu's kernels on the same inputs
        gate = "_sm90_fwd_path" if name == "fused_ce_fwd" \
            else "_sm90_bwd_path"
        with _other_source("fused_ce", gate):
            out[name]["other_kernel_ms"] = time_ms(kern, runs=20)
        if name in errs:
            out[name]["max_abs_err"] = errs[name]
        if name == "fused_ce_bwd_dw":
            out[name]["max_rel_err"] = max(errs["dw_max"],
                                           errs.get("db_max", 0.0))
        r = out[name]
        log(f"[ce timing] {name} n={n} ({n_valid} valid) H={hd} V={vocab} "
            f"bias={bias} {str(dt)[6:]}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; all rows "
            f"{r['bound_all_rows_ms']:.4f} ms)"
            + (f", fused_ce.cu {r['other_kernel_ms']:.4f} ms"
               if "other_kernel_ms" in r else ""))
    # the library's whole backward (dh, dW, db in one call) against
    # fused_ce_bwd, in turns, 60 runs each
    runs = 60
    lib_all = time_samples(lib_grad("fused_ce_bwd"), runs=runs)
    ours = time_samples(lambda: fused_ce_bwd(h, w, b, y, lse, g), runs=runs)
    out["whole_backward"] = {
        "runs": runs, "library_ms": statistics.median(lib_all),
        "library_min_ms": min(lib_all), "library_max_ms": max(lib_all),
        "kernels_ms": statistics.median(ours), "kernels_min_ms": min(ours),
        "kernels_max_ms": max(ours)}
    log(f"[ce timing] whole backward n={n} ({n_valid} valid) V={vocab} "
        f"bias={bias} {str(dt)[6:]}: {json.dumps(out['whole_backward'])}")
    return out


def phase_ce_timings():
    # BERT's MLM labels: 15% of the rows masked (valid), the rest -100;
    # GPT's LM labels: every row valid
    bert = _ce_time_shape(4096, 768, 30522, bias=True, ignored=0.85)
    gpt = _ce_time_shape(4096, 768, 50304, bias=False, ignored=0.0)
    return bert, gpt


def phase_ce_chunk_sweep(elems=(1 << 23, 1 << 24, 1 << 25, 1 << 26)):
    """Not run by ``main``: ``fused_ce_bwd`` at GPT-2's head (n 4096, H
    768, V 50304, bf16, every label valid) with the ds chunk holding each
    of ``elems`` elements (Vc = elems / n columns), in turns (the widths
    in order, then in reverse), and the better time of each. The chunk in
    the source (``fused_ce._CHUNK_ELEMS``) is the fastest of this sweep."""
    import importlib
    fc = importlib.import_module("paddle_tpu_torch.ops.cuda.fused_ce")
    gen = torch.Generator().manual_seed(9)
    n, hd, vocab = 4096, 768, 50304
    h, w, b, y, g = _ce_inputs(n, hd, vocab, torch.bfloat16, False, gen,
                               ignored=0.0, oob=False)
    lse = fc.fused_ce_fwd(h, w, b, y)[1]
    saved = fc._CHUNK_ELEMS
    times, vcs = {}, {}
    try:
        for e in list(elems) + list(reversed(elems)):
            fc._CHUNK_ELEMS = e
            vcs[e] = fc.vocab_chunk(n, vocab)
            times.setdefault(e, []).append(time_ms(
                lambda: fc.fused_ce_bwd(h, w, b, y, lse, g), runs=20))
    finally:
        fc._CHUNK_ELEMS = saved
    rows = [{"chunk_elems": e, "vc": vcs[e], "ms": min(ts), "turns": ts}
            for e, ts in times.items()]
    for r in rows:
        log(f"[ce chunk sweep] {json.dumps(r)}")
    best = min(rows, key=lambda r: r["ms"])
    log(f"[ce chunk sweep] fastest chunk {best['chunk_elems']} elements "
        f"(Vc {best['vc']}); the source's {saved}")
    return rows


# --------------------------------------------------------------------------
# phase 10: the flash-attention kernels against their plain versions
# --------------------------------------------------------------------------

def _flash_inputs(bh, b, sq, sk, d, dt, bias, gen):
    """q, k, v, dO ~ N(0, 1) (logits O(1) at scale d^-0.5) and, with
    ``bias``, an f32 key bias [b, s_k] ~ N(0, 0.5^2) with 30% of the keys
    at -1e9 but key 0 kept, so every causal row sees a key. ``bias ==
    "-inf"``: BERT's f16 O2 mask instead, -inf on the keys past each batch
    row's length (right padding, at least the first key and at least half
    of them kept), 0 before."""
    q, k, v = (torch.randn(bh, s, d, generator=gen).to("cuda", dt)
               for s in (sq, sk, sk))
    do = torch.randn(bh, sq, d, generator=gen).to("cuda", dt)
    bb = None
    if bias == "-inf":
        keep = torch.randint(max(1, sk // 2), sk + 1, (b,), generator=gen)
        bb = torch.where(torch.arange(sk)[None] < keep[:, None], 0.0,
                         float("-inf")).to("cuda")
    elif bias:
        bb = 0.5 * torch.randn(b, sk, generator=gen)
        bb[torch.rand(b, sk, generator=gen) < 0.3] = -1e9
        bb[:, 0] = 0.0
        bb = bb.to("cuda")
    return q, k, v, bb, do


def flash_errors(q, k, v, bias, causal, do, where, repeat=False):
    """Errors of the three kernels against the plain versions on the same
    inputs (the backward kernels and the plain backward both take the
    plain forward's o and lse), checked against FLASH_TOL: absolute under
    the kernels' names, ``_rel_errs`` per quantity. With ``repeat`` each
    kernel launches a second time and must give the same bits."""
    from paddle_tpu_torch.ops.cuda import (flash_bwd_dkv, flash_bwd_dq,
                                           flash_bwd_ref, flash_fwd,
                                           flash_fwd_ref)
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_delta
    o_r, lse_r = flash_fwd_ref(q, k, v, bias, causal)
    o, lse = flash_fwd(q, k, v, bias, causal)
    delta = flash_delta(o_r, do)
    dq = flash_bwd_dq(q, k, v, bias, do, lse_r, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, bias, do, lse_r, delta, causal)
    if repeat:
        o2, lse2 = flash_fwd(q, k, v, bias, causal)
        dq2 = flash_bwd_dq(q, k, v, bias, do, lse_r, delta, causal)
        dk2, dv2 = flash_bwd_dkv(q, k, v, bias, do, lse_r, delta, causal)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"two forward launches differ at {where}")
        check(torch.equal(dq, dq2), f"two dq launches differ at {where}")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"two dk/dv launches differ at {where}")
    torch.cuda.synchronize()
    dq_r, dk_r, dv_r = flash_bwd_ref(q, k, v, bias, o_r, lse_r, do, causal)
    check(o.dtype == q.dtype and dq.dtype == dk.dtype == dv.dtype == q.dtype
          and lse.dtype == torch.float32, "flash output dtypes")
    out = {"lse": _err(lse, lse_r), "flash_fwd": _err(o, o_r),
           "flash_bwd_dq": _err(dq, dq_r),
           "flash_bwd_dkv": max(_err(dk, dk_r), _err(dv, dv_r))}
    for name, got, ref in (("o", o, o_r), ("dq", dq, dq_r), ("dk", dk, dk_r),
                           ("dv", dv, dv_r)):
        out[f"{name}_max"], out[f"{name}_norm"] = _rel_errs(got, ref)
    for key, tol in FLASH_TOL[q.dtype].items():
        check(out[key] <= tol, f"{key} {out[key]:.3e} > {tol:g} at {where}")
    return out


def _flash_line(e):
    return (f"lse {e['lse']:.2e}; o max {e['o_max']:.2e} norm "
            f"{e['o_norm']:.2e}; dq {e['dq_max']:.2e} / {e['dq_norm']:.2e}"
            f"; dk {e['dk_max']:.2e} / {e['dk_norm']:.2e}; dv "
            f"{e['dv_max']:.2e} / {e['dv_norm']:.2e}")


def phase_flash(dtypes=(torch.float32, torch.bfloat16),
                biases=(False, True)):
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda.flash_attention import _sm90_path
    gen = torch.Generator().manual_seed(11)
    # the last three: ragged, several tiles of both kernels, s_q <= s_k
    shapes = [(128, 128), (1024, 1024), (33, 33), (7, 65), (1, 40),
              (32, 64), (4096, 4096), (190, 317), (1000, 1000), (4000, 4096)]
    b, h = 2, 2
    worst = {}
    t0 = time.perf_counter()
    n = n_sm90 = 0
    for dt, causal, bias, (sq, sk), d in itertools.product(
            dtypes, (False, True), biases, shapes, (16, 64, 128, 256)):
        where = (f"{str(dt)[6:]} causal={causal} bias={bias} sq={sq} "
                 f"sk={sk} d={d}")
        q, k, v, bb, do = _flash_inputs(b * h, b, sq, sk, d, dt, bias, gen)
        sm90 = _sm90_path(dt, d, True)      # fresh tensors: 16-byte aligned
        before = kernels.launch_counts()
        errs = flash_errors(q, k, v, bb, causal, do, where, repeat=sm90)
        used = {key: kernels.launch_counts()[key] - before[key]
                for key in FLASH_KERNELS + SM90_COUNTS + F16_COUNTS}
        want = {"flash_fwd": 1 + sm90, "flash_bwd_dq": 1 + sm90,
                "flash_bwd_dkv": 1 + sm90, "flash_fwd.sm90": 2 * sm90,
                "flash_bwd_dq.sm90": 2 * sm90,
                "flash_bwd_dkv.sm90": 2 * sm90}
        f16 = dt == torch.float16
        want.update({f"{k}.f16": want[k] * f16 for k in FLASH_KERNELS})
        check(used == want, f"kernel variants at {where}: launched {used}, "
                            f"want {want}")
        n += 1
        n_sm90 += sm90
        if sq >= 1024 or (d == 64 and not bias):
            log(f"[flash] {where}: {_flash_line(errs)}")
        for key, e in errs.items():
            worst.setdefault(key, {})
            worst[key][dt] = max(worst[key].get(dt, 0.0), e)
    log(f"[flash] {n} cases ({n_sm90} on the Hopper forward, dq and dk/dv,"
        f" each launched twice and bitwise equal) in "
        f"{time.perf_counter() - t0:.1f} s; limits "
        f"{json.dumps({str(t)[6:]: FLASH_TOL[t] for t in dtypes})}; worst "
        + json.dumps({key: {str(t)[6:]: e for t, e in w.items()}
                      for key, w in worst.items()}))
    return worst


# --------------------------------------------------------------------------
# phase 14: f16 through the five kernels of the training path
# --------------------------------------------------------------------------

def phase_fp16_kernels():
    """Phase 6's CE cases and phase 10's flash cases in f16 (the flash ones
    also with BERT's f16 O2 mask: -inf on right-padded keys), each case on
    the kernel its shape takes, the Hopper launches repeated bitwise."""
    return (phase_ce(dtypes=(torch.float16,)),
            phase_flash(dtypes=(torch.float16,),
                        biases=(False, True, "-inf")))


def phase_fp16_timings():
    """The five kernels in f16 at phase 9's heads and phase 13's shapes."""
    ce = {"bert_head": _ce_time_shape(4096, 768, 30522, bias=True,
                                      ignored=0.85, dt=torch.float16),
          "gpt_head": _ce_time_shape(4096, 768, 50304, bias=False,
                                     ignored=0.0, dt=torch.float16)}
    fl = {"longseq": _flash_time_shape(1, 12, 4096, 64, causal=True,
                                       bias=False, dt=torch.float16),
          "flagship": _flash_time_shape(32, 12, 128, 64, causal=False,
                                        bias=True, dt=torch.float16)}
    return ce, fl


# --------------------------------------------------------------------------
# phases 15-16: the rest of the training stack, f16 O2 at full width
# --------------------------------------------------------------------------

# the five kernels of the f16 O2 training path, by launch_counts key
PATH_KERNELS = CE_KERNELS + FLASH_KERNELS


def _o2_f16_trainer(cfg, lr=None, clip=True, seed=0):
    """BERT ``cfg`` on the card, decorated O2 f16, with its AdamW (f32
    master weights, decay 0.01; ``lr`` a float or, by default, LinearWarmup
    over PolynomialDecay), ClipGradByGlobalNorm(1.0) and a dynamic
    GradScaler from 2^15: (net, optimizer, scheduler or None, scaler)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.text.models import Bert
    net = Bert(cfg, device="cuda", dtype=torch.float32, seed=seed)
    net.train()
    sched = None
    if lr is None:
        sched = lr = lr_mod.LinearWarmup(
            lr_mod.PolynomialDecay(1e-4, decay_steps=1000, end_lr=0.0),
            warmup_steps=10, start_lr=0.0, end_lr=1e-4)
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                parameters=net.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0) if clip else None,
                multi_precision=True)
    amp.decorate(net, opt, level="O2", dtype="float16")
    return net, opt, sched, amp.GradScaler(init_loss_scaling=2.0 ** 15)


def _snapshot(net, opt):
    return ({k: p.detach().clone() for k, p in net.named_parameters()},
            {k: {s: v.clone() for s, v in sl.items()}
             for k, sl in opt._slots.items()})


def _o2_step(net, opt, sched, scaler, ids, lab):
    """One f16 O2 step through GradScaler: (loss, skipped). A skipped step
    must leave every parameter and optimizer slot bitwise as it was."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(level="O2", dtype="float16"):
        loss = net(ids, masked_lm_labels=lab)
    scaler.scale(loss).backward()
    _zero_missing_grads(net)
    scaler.unscale_(opt)
    skipped = bool(scaler._found_inf)
    before = _snapshot(net, opt) if skipped else None
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    if sched is not None:
        sched.step()
    if before is not None:
        params, slots = _snapshot(net, opt)
        check(all(torch.equal(params[k], v) for k, v in before[0].items())
              and all(torch.equal(slots[k][s], v)
                      for k, sl in before[1].items() for s, v in sl.items()),
              "a skipped step changed a parameter or a slot")
    return loss.detach(), skipped


def phase_o2_f16():
    """Phase 15: the flagship's shape (BERT-base, b32 s128, dropout 0.1,
    16 LMDataset batches) trained in f16 O2 through decorate, auto_cast,
    GradScaler, AdamW, LinearWarmup and ClipGradByGlobalNorm; then 10
    steps of the f32 model under O1 bf16 with Lamb."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import BertConfig
    batch, seq, warmup, steps, n_batches = 32, 128, 5, 30, 16
    cfg = BertConfig.bert_base()
    ids, lab = _bert_batches(cfg, batch, seq, n_batches)
    net, opt, sched, scaler = _o2_f16_trainer(cfg)
    n_params = net.num_params()
    it = itertools.count()
    scales, skipped = [], []

    def step():
        i = next(it)
        scales.append(scaler.get_loss_scaling())
        loss, skip = _o2_step(net, opt, sched, scaler, ids[i % n_batches],
                              lab[i % n_batches])
        if skip:
            skipped.append(i)
        return loss

    kernels.reset_launch_counts()
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step()
        if i in (0, steps - 1):
            losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    loss_start, loss_end = (float(x) for x in losses)
    tokens = batch * seq
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    flops = 6 * n_params * tokens + 12 * L * H * seq * tokens
    res = {"config": "bert_base", "amp": "O2 float16", "batch": batch,
           "seq": seq, "params": n_params, "warmup": warmup, "steps": steps,
           "step_ms": dt * 1e3 / steps, "samples_per_s": steps * batch / dt,
           "tokens_per_s": steps * tokens / dt,
           "mfu": flops * steps / dt / PEAK_FLOPS[torch.float16],
           "mfu_peak": PEAK_NAME_F16, "loss_start": loss_start,
           "loss_end": loss_end, "loss_scale": scales + [
               scaler.get_loss_scaling()],
           "skipped_steps": skipped, "lr_end": opt.get_lr(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: counts[k] for k in PATH_KERNELS
                        + CE_SM90_COUNTS + SM90_COUNTS + CE_F16_COUNTS
                        + F16_COUNTS}}
    log(f"[o2 f16] {json.dumps(res)}")
    check(np.isfinite(loss_start) and np.isfinite(loss_end),
          "non-finite f16 O2 loss")
    check(loss_end < loss_start, "the f16 O2 loss did not fall")
    # every launch of the five kernels in f16 on its Hopper kernel (at s
    # 128 the flash kernels once the default FLAGS_flash_min_seq admits it)
    flash_on = flags.flag("FLAGS_flash_min_seq") <= seq
    for k in PATH_KERNELS:
        want_any = k in CE_KERNELS or flash_on
        check((counts[k] > 0) == want_any, f"{k} launched {counts[k]} "
                                           f"times on the f16 O2 path")
        check(counts[f"{k}.sm90"] == counts[k] == counts[f"{k}.f16"],
              f"{k}: {counts[k]} launches, {counts[k + '.sm90']} on the "
              f"Hopper kernel, {counts[k + '.f16']} in f16")
    breakdown = {}
    try:
        prof = _profile_steps(step)
    except Exception as e:    # the measurement is optional, the step is not
        prof = None
        log(f"[o2 f16 profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        breakdown = dict(prof)
        breakdown["device_idle_share"] = \
            1 - prof["device_busy_ms_per_step"] / res["step_ms"]
    res["breakdown"] = breakdown
    log(f"[o2 f16 breakdown] {json.dumps(breakdown)}")
    del net, opt, scaler
    res["o1_bf16_lamb"] = _o1_bf16_lamb(cfg, ids, lab)
    return counts, res


def _o1_bf16_lamb(cfg, ids, lab, steps=10):
    """10 steps of the f32 flagship model under auto_cast O1 bf16 with Lamb
    and ClipGradByGlobalNorm(1.0): step ms, and the dtype and kernel each
    attention and CE call took (from the AMP cast points' inputs and the
    launch counters)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, Lamb
    from paddle_tpu_torch.text.models import Bert
    net = Bert(cfg, device="cuda", dtype=torch.float32, seed=0)
    net.train()
    opt = Lamb(learning_rate=1e-4, parameters=net.named_parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    seen = {}
    inner = amp.cast_inputs

    def record(name, vals):
        out = inner(name, vals)
        if name in ("flash_sdpa", "sdpa", "fused_ce_op", "ce_head_fallback"):
            seen.setdefault(name, str(out[0].dtype)[6:])
        return out

    def step(i):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = net(ids[i % len(ids)], masked_lm_labels=lab[i % len(lab)])
        loss.backward()
        _zero_missing_grads(net)
        opt.step()
        opt.clear_grad()
        return loss.detach()

    amp.cast_inputs = record
    try:
        step(0)
    finally:
        amp.cast_inputs = inner
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(1, steps + 1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = {"steps": steps, "step_ms": dt * 1e3 / steps,
           "loss_start": float(losses[0]), "loss_end": float(losses[-1]),
           "kernel_input_dtypes": seen,
           "launches": {k: counts[k] for k in PATH_KERNELS
                        + CE_SM90_COUNTS + SM90_COUNTS}}
    log(f"[o1 bf16 lamb] {json.dumps(res)}")
    check(all(np.isfinite(float(x)) for x in losses),
          "non-finite O1 bf16 loss")
    for k in CE_KERNELS:
        check(counts[k] > 0, f"{k} never launched under O1")
    del net, opt
    return res


def phase_o2_f16_equivalence():
    """Phase 16: one f16 O2 step of BERT-base (b8, s128, dropout 0) through
    the kernels and the same step with FLAGS_use_fused_ce and
    FLAGS_use_flash_attention off (the composites), from the same weights
    on the same batch: the loss, every unscaled gradient before the step
    and every parameter and f32 master after it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.bert_base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    ids, lab = _bert_batches(cfg, 8, 128, 1)
    lr = 1e-4
    out = {}
    for use in (True, False):
        flags.set_flags({"FLAGS_use_fused_ce": use,
                         "FLAGS_use_flash_attention": use})
        try:
            net, opt, _, scaler = _o2_f16_trainer(cfg, lr=lr)
            before = kernels.launch_counts()
            with amp.auto_cast(level="O2", dtype="float16"):
                loss = net(ids[0], masked_lm_labels=lab[0])
            scaler.scale(loss).backward()
            _zero_missing_grads(net)
            scaler.unscale_(opt)
            check(not bool(scaler._found_inf), "the f16 step overflowed")
            grads = {k: p.grad.detach().float().clone()
                     for k, p in net.named_parameters()}
            scaler.step(opt)
            scaler.update()
            used = {k: kernels.launch_counts()[k] - before[k]
                    for k in PATH_KERNELS}
            want = set(used.values()) == ({12, 1} if use else {0})
            check(want, f"the flags did not route the f16 step: {used}")
            out[use] = (float(loss.detach()), grads,
                        {k: p.detach().float().clone()
                         for k, p in net.named_parameters()},
                        {k: sl["master"].clone()
                         for k, sl in opt._slots.items()})
        finally:
            flags.set_flags({"FLAGS_use_fused_ce": True,
                             "FLAGS_use_flash_attention": True})
        del net, opt, scaler
    (lk, gk, pk, mk), (lp, gp, pp, mp) = out[True], out[False]
    dloss = abs(lk - lp)
    dgrad = {k: _grad_rel(gk[k], gp[k]) for k in gk}
    worst = max(dgrad, key=dgrad.get)
    dmaster = max(float((mk[k] - mp[k]).abs().max()) for k in mk)
    moved = {k: float((mk[k] - mp[k]).abs().gt(1e-6).float().mean())
             for k in mk}
    dparam = max(float((pk[k] - pp[k]).abs().max()) for k in pk)
    res = {"loss_kernels": lk, "loss_composite": lp, "loss_abs_diff": dloss,
           "grad_max_rel_diff": dgrad[worst], "grad_worst": worst,
           "master_max_abs_diff": dmaster,
           "master_share_over_1e-6": max(moved.values()),
           "param_max_abs_diff": dparam, "lr": lr,
           "limits": O2_STEP_TOL}
    log(f"[o2 f16 equivalence] b8 s128: {json.dumps(res)}")
    check(np.isfinite(lk) and dloss <= O2_STEP_TOL["loss"],
          "f16 O2 loss differs")
    check(dgrad[worst] <= O2_STEP_TOL["grad"],
          f"f16 O2 gradient {worst} differs: {dgrad[worst]}")
    check(dmaster <= O2_STEP_TOL["master"], "f16 O2 masters differ")
    return res


# --------------------------------------------------------------------------
# phase 17: the high-level API, Model.fit over BERT-base
# --------------------------------------------------------------------------

# per training step of BERT-base through Model (12 layers): the launches
# of each of the five training kernels
HAPI_STEP_LAUNCHES = {"flash_fwd": 12, "flash_bwd_dq": 12,
                      "flash_bwd_dkv": 12, "fused_ce_fwd": 1,
                      "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}


def _identity_loss(loss):
    return loss


class MLM(torch.nn.Module):
    """BERT's MLM loss through ``forward(ids, labels)`` (the logits
    without labels): the network ``Model`` trains."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, ids, labels=None):
        return self.bert(ids, masked_lm_labels=labels)


def _hapi_model(cfg, dtype, seed=0):
    """``Model(MLM(Bert(cfg)))`` on the card, prepared as phase 15's
    trainer: AdamW (lr LinearWarmup over PolynomialDecay, decay 0.01,
    ClipGradByGlobalNorm(1.0)), an identity loss, amp O2 in ``dtype`` (a
    GradScaler from 2^15 in f16)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.text.models import Bert
    net = MLM(Bert(cfg, device="cuda", dtype=torch.float32, seed=seed))
    spec = [pt.InputSpec([None, None], "int64", "ids"),
            pt.InputSpec([None, None], "int64", "labels")]
    model = pt.Model(net, inputs=spec)
    sched = lr_mod.LinearWarmup(
        lr_mod.PolynomialDecay(1e-4, decay_steps=1000, end_lr=0.0),
        warmup_steps=10, start_lr=0.0, end_lr=1e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model.prepare(opt, loss=_identity_loss,
                  amp_configs={"level": "O2", "dtype": dtype})
    return model


def _hapi_clock(steps, window):
    """A callback: the launch-count delta of every step, the step clock
    over the last ``window`` steps (synced at both ends) and every step's
    ``logs["loss"]`` kept unread."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.ops import cuda as kernels

    class Clock(Callback):
        def __init__(self):
            super().__init__()
            self.deltas, self.losses = [], []
            self._last = kernels.launch_counts()
            self.t0 = self.t1 = None

        def on_train_batch_begin(self, step, logs=None):
            if step == steps - window:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            now = kernels.launch_counts()
            self.deltas.append({k: now[k] - self._last[k] for k in now})
            self._last = now
            self.losses.append(logs["loss"])
            if step == steps - 1:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()
    return Clock()


def _hapi_fit(cfg, ds, dtype, batch, steps, card, window=30,
              profile_steps=10):
    """``Model.fit`` over ``ds`` for one epoch (``steps`` batches) in O2
    ``dtype`` with History and ModelCheckpoint, as a user calls it; then a
    profiled fit of ``profile_steps`` more batches."""
    import shutil
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.hapi.callbacks import History, ModelCheckpoint
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.ops import cuda as kernels
    model = _hapi_model(cfg, dtype)
    save_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            ".scratch", f"hapi_{dtype}")
    history = History()
    monitor.reset(prefix="hapi/")
    kernels.reset_launch_counts()
    clock = _hapi_clock(steps, window)
    t_fit = time.perf_counter()
    model.fit(ds, batch_size=batch, epochs=1, shuffle=True, log_freq=10,
              verbose=0, callbacks=[history, clock,
                                    ModelCheckpoint(save_dir=save_dir)])
    fit_s = time.perf_counter() - t_fit
    counts = kernels.launch_counts()
    stats = monitor.stats("hapi/")
    saved = sorted(os.listdir(save_dir))
    shutil.rmtree(save_dir, ignore_errors=True)
    losses = [float(v) for v in clock.losses]
    step_ms = (clock.t1 - clock.t0) * 1e3 / window
    res = {"card": card, "config": "bert_base", "amp": f"O2 {dtype}",
           "batch": batch, "seq": ds.inputs.shape[1], "steps": steps,
           "step_ms": step_ms, "step_ms_window": window,
           "samples_per_s": batch * 1e3 / step_ms,
           "fit_s_with_checkpoints": fit_s,
           "loss_start": losses[0], "loss_end": losses[-1],
           "history_loss": history.history["loss"],
           "train_steps": stats.get("hapi/train_steps", 0),
           "host_loss_reads_per_step":
               stats.get("hapi/loss_reads", 0) / steps,
           "step_count": model._optimizer._step_count,
           "checkpoints": saved,
           "launches": {k: counts[k] for k in PATH_KERNELS + SM90_COUNTS
                        + CE_SM90_COUNTS + F16_COUNTS + CE_F16_COUNTS}}
    if dtype == "float16":
        res["loss_scale_end"] = model._amp_configs["scaler"] \
            .get_loss_scaling()
    check(all(np.isfinite(losses)), f"non-finite hapi {dtype} loss")
    check(losses[-1] < losses[0], f"the hapi {dtype} loss did not fall")
    check(res["train_steps"] == steps and res["step_count"] == steps,
          f"hapi {dtype}: {res['train_steps']} train steps, step count "
          f"{res['step_count']}, for {steps} batches")
    check(saved == ["0.pdopt", "0.pdparams", "final.pdopt",
                    "final.pdparams"], f"ModelCheckpoint wrote {saved}")
    # every step launched each of the five kernels, on its Hopper kernel
    # (in f16 for f16)
    for i, d in enumerate(clock.deltas):
        for k, n in HAPI_STEP_LAUNCHES.items():
            want = {k: n, f"{k}.sm90": n,
                    f"{k}.f16": n if dtype == "float16" else 0}
            got = {key: d[key] for key in want}
            check(got == want, f"hapi {dtype} step {i}: {got}, not {want}")
    try:
        def more():
            model.fit(Subset(ds, range(profile_steps * batch)),
                      batch_size=batch, epochs=1, shuffle=False,
                      log_freq=10, verbose=0)
        prof = _profile_steps(more, n=1, steps_per_call=profile_steps)
    except Exception as e:    # the measurement is optional, the fit is not
        prof = None
        log(f"[hapi {dtype} profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        res["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
        res["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
            / step_ms
        res["top_kernels"] = prof["top"][:6]
    log(f"[hapi fit {dtype}] {json.dumps(res)}")
    del model
    return counts, res


def _hapi_equivalence_and_state(cfg, batch, seq, card):
    """Dropout 0, the same weights and batches: three ``Model.train_batch``
    steps in f16 O2 against three of phase 15's hand-written steps (loss
    and masters within O2_STEP_TOL); then ``Model.save`` into a fresh
    Model's ``load`` (parameters and slots bitwise, the next step's loss
    and parameters bitwise); then two steps at a loss scale of 2^40
    (parameters and slots bitwise kept, ``_step_count`` advancing, the
    scale halved after the second); then ``evaluate`` and ``predict`` over
    4 batches."""
    import shutil
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models.bert import BertPretrainingCriterion
    cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    ids, lab = _bert_batches(cfg, batch, seq, 4)
    net, opt, sched, scaler = _o2_f16_trainer(cfg)
    hand = [float(_o2_step(net, opt, sched, scaler, ids[i], lab[i])[0])
            for i in range(3)]
    hand_masters = {k: sl["master"].clone() for k, sl in opt._slots.items()}
    del net, opt, scaler
    model = _hapi_model(cfg, "float16")
    mopt = model._optimizer
    got = []
    for i in range(3):
        got.append(model.train_batch([ids[i], lab[i]])[0])
        mopt._learning_rate.step()          # fit steps LinearWarmup here
    dloss = max(abs(a - b) for a, b in zip(got, hand))
    # the hand-written step names parameters without the wrapper's prefix
    dmaster = max(float((mopt._slots["bert." + k]["master"] - v).abs().max())
                  for k, v in hand_masters.items())
    res = {"card": card, "hand_losses": hand, "model_losses": got,
           "loss_max_abs_diff": dloss, "master_max_abs_diff": dmaster,
           "limits": O2_STEP_TOL}
    check(dloss <= O2_STEP_TOL["loss"], f"Model loss differs: {dloss}")
    check(dmaster <= O2_STEP_TOL["master"],
          f"Model masters differ: {dmaster}")
    # save -> load into a Model of other weights
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".scratch", "hapi_save", "m")
    t0 = time.perf_counter()
    model.save(path)
    other = _hapi_model(cfg, "float16", seed=1)
    other.load(path)
    save_load_s = time.perf_counter() - t0
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)

    def state(m):
        return ([p.detach().clone() for p in m.parameters()],
                {(k, s): v.clone() for k, sl in m._optimizer._slots.items()
                 for s, v in sl.items()})

    (pa, sa), (pb, sb) = state(model), state(other)
    same = (all(torch.equal(a, b) for a, b in zip(pa, pb)) and set(sa) ==
            set(sb) and all(torch.equal(v, sb[k]) for k, v in sa.items())
            and other._optimizer._step_count == mopt._step_count)
    check(same, "Model.load did not restore the parameters and slots")
    la = model.train_batch([ids[3], lab[3]])[0]
    lb = other.train_batch([ids[3], lab[3]])[0]
    after = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  other.parameters()))
    res["save_load"] = {"bitwise_state": same, "next_loss": [la, lb],
                        "params_after_next_step_bitwise": after,
                        "save_and_load_s": save_load_s}
    check(la == lb and after, f"the loaded Model's next step differs: "
                              f"{la} vs {lb}, parameters equal: {after}")
    del other
    # forced overflow: the scale at 2^40 is inf in f16
    scaler = model._amp_configs["scaler"]
    scaler.set_init_loss_scaling(2.0 ** 40)
    pa, sa = state(model)
    steps = []
    for _ in range(2):
        count = mopt._step_count
        loss = model.train_batch([ids[0], lab[0]])[0]
        kept = (all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                      pa))
                and all(torch.equal(mopt._slots[k][s], v)
                        for (k, s), v in sa.items()))
        steps.append({"loss": loss, "state_bitwise_kept": kept,
                      "step_count_advance": mopt._step_count - count,
                      "scale_after": scaler.get_loss_scaling()})
        check(kept and mopt._step_count == count + 1 and np.isfinite(loss),
              f"forced-overflow step: {steps[-1]}")
    check(steps[0]["scale_after"] == 2.0 ** 40
          and steps[1]["scale_after"] == 2.0 ** 39,
          f"the scale did not halve after two bad steps: {steps}")
    res["forced_overflow"] = steps
    # evaluate through the logits head (labels split off), predict the MLM
    # loss of each batch through the fused head
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq, n=4 * batch,
                   seed=7)
    evaluator = pt.Model(model.network, inputs=[pt.InputSpec([None, seq],
                                                             "int64")],
                         labels=[pt.InputSpec([None, seq], "int64")])
    evaluator.prepare(loss=BertPretrainingCriterion(cfg.vocab_size),
                      amp_configs={"level": "O2", "dtype": "float16"})
    ev = evaluator.evaluate(ds, batch_size=batch, verbose=0)
    pred = model.predict(ds, batch_size=batch)
    per_batch = [float(x) for x in pred[0]]
    res["evaluate"] = ev
    res["predict_losses"] = per_batch
    check(len(pred) == 1 and len(pred[0]) == 4
          and all(np.isfinite(per_batch)), f"predict gave {per_batch}")
    check(np.isfinite(ev["loss"]) and abs(ev["loss"] - np.mean(per_batch))
          <= 2e-2 * abs(ev["loss"]),
          f"evaluate's loss {ev['loss']} against predict's {per_batch}")
    log(f"[hapi state] {json.dumps(res)}")
    return res


def phase_hapi(card=None, flagship=None, o2=None):
    """Phase 17: BERT-base b32 s128 through ``Model.fit`` (40 steps of
    ``LMDataset``, dropout 0.1) in f16 O2 and bf16 O2, then the
    equivalence, save / load, forced-overflow and evaluate / predict
    checks. ``card``: phase 1's nvidia-smi line; ``flagship`` / ``o2``:
    phases 8 and 15's results from the same run, printed beside the
    fit's."""
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import BertConfig
    batch, seq, steps = 32, 128, 40
    cfg = BertConfig.bert_base()
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq, n=batch * steps,
                   seed=0)
    np.random.seed(0)
    out, counts = {}, {}
    for dtype in ("float16", "bfloat16"):
        counts[dtype], out[dtype] = _hapi_fit(cfg, ds, dtype, batch, steps,
                                              card)
    out["state"] = _hapi_equivalence_and_state(cfg, batch, seq, card)
    beside = {"card": card}
    for name, res in (("phase 8 bf16 hand-written", flagship),
                      ("phase 15 f16 O2 hand-written", o2)):
        if res is not None:
            bd = res.get("breakdown", {})
            beside[name] = {"step_ms": res["step_ms"],
                            "device_busy_ms_per_step":
                                bd.get("device_busy_ms_per_step"),
                            "device_idle_share": bd.get("device_idle_share")}
    for dtype in ("float16", "bfloat16"):
        r = out[dtype]
        beside[f"Model.fit {dtype} O2"] = {
            "step_ms": r["step_ms"],
            "device_busy_ms_per_step": r.get("device_busy_ms_per_step"),
            "device_idle_share": r.get("device_idle_share"),
            "host_loss_reads_per_step": r["host_loss_reads_per_step"]}
    out["beside"] = beside
    log(f"[hapi beside] {json.dumps(beside)}")
    return counts, out


# --------------------------------------------------------------------------
# phase 18: the dygraph API, written against the port's Paddle surface
# --------------------------------------------------------------------------

def phase_api_checks():
    """The op core and the Layer tier on the card without a model: the
    default device is the card (layers, to_tensor, creation ops), O1 bf16
    casts ``x @ w`` of f32 tensors to bf16 as the JAX package does, a
    ``no_grad`` op builds no graph, a PyLayer doubles a gradient. Returns
    the readings."""
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    lin = paddle.nn.Linear(4, 4)
    t = paddle.to_tensor([1.0])
    z = paddle.zeros([2])
    where = {"Linear.weight": lin.weight.device.type,
             "to_tensor": t.device.type, "zeros": z.device.type}
    check(set(where.values()) == {"cuda"}, f"not on the card by default: "
                                           f"{where}")
    check(tuple(lin.weight.shape) == (4, 4) and
          isinstance(lin.weight, paddle.Tensor), "Linear weight")
    x = paddle.randn([8, 16])
    w = paddle.randn([16, 4])
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = x @ w
        y_add = x + x
    check(y.dtype == torch.bfloat16, f"O1 bf16 x @ w gave {y.dtype}")
    check(y_add.dtype == torch.float32, f"O1 bf16 x + x gave {y_add.dtype}")
    xs = paddle.to_tensor(np.ones((4, 3), np.float32), stop_gradient=False)
    with paddle.no_grad():
        ng = paddle.matmul(xs, xs.T)
    check(ng.grad_fn is None and ng.stop_gradient, "no_grad built a graph")

    class Double(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, v):
            return v * 1.0

        @staticmethod
        def backward(ctx, g):
            return g * 2.0

    Double.apply(xs).sum().backward()
    check(bool((xs.grad == 2.0).all()), f"PyLayer gave {xs.grad}")
    out = {"default_device": where, "o1_bf16_matmul": str(y.dtype),
           "o1_bf16_add": str(y_add.dtype), "pylayer_grad": float(
               xs.grad[0, 0])}
    log(f"[api] {json.dumps(out)}")
    return out


def _dygraph_bert(paddle, cfg, seed=0):
    """BERT-base on the current device, decorated to bf16 O2 (f32
    masters) with AdamW lr 1e-4, wd 0.01: bench.py:bench_bert's recipe
    through the Paddle surface."""
    from paddle_tpu_torch.text.models import Bert
    net = Bert(cfg, seed=seed)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=net.parameters())
    net, opt = paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    net.train()
    return net, opt


def _dygraph_state(paddle, cfg, ds, batch):
    """(b), at dropout 0: state_dict -> paddle.save -> paddle.load ->
    set_state_dict (model and optimizer) into a second model of another
    seed gives the next step bitwise; paddle.grad equals backward's .grad
    bitwise; a no_grad eval pass builds no graph; a forward-post hook
    fires once per encoder layer."""
    import shutil
    cfg = copy.copy(cfg)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0

    def batch_of(i):
        return (paddle.to_tensor(ds.inputs[i * batch:(i + 1) * batch]),
                paddle.to_tensor(ds.labels[i * batch:(i + 1) * batch]))

    def step(net, opt, i):
        ids, lab = batch_of(i)
        loss = net(ids, masked_lm_labels=lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    out = {}
    net, opt = _dygraph_bert(paddle, cfg, seed=0)
    step(net, opt, 0)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".scratch", "dygraph_ckpt")
    os.makedirs(root, exist_ok=True)
    try:
        t0 = time.perf_counter()
        paddle.save(net.state_dict(), os.path.join(root, "m.pdparams"))
        paddle.save(opt.state_dict(), os.path.join(root, "m.pdopt"))
        net2, opt2 = _dygraph_bert(paddle, cfg, seed=1)
        missing, unexpected = net2.set_state_dict(
            paddle.load(os.path.join(root, "m.pdparams")))
        opt2.set_state_dict(paddle.load(os.path.join(root, "m.pdopt")))
        out["save_load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not missing and not unexpected,
          f"set_state_dict: missing {missing}, unexpected {unexpected}")
    l1, l2 = step(net, opt, 1), step(net2, opt2, 1)
    same = all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 net2.parameters()))
    out["next_step_loss"] = [float(l1.detach()), float(l2.detach())]
    check(torch.equal(l1, l2) and same, f"the step after save -> load "
                                        f"differs: {float(l1)} {float(l2)}, "
                                        f"parameters equal {same}")
    # paddle.grad against backward's .grad, one graph
    ids, lab = batch_of(2)
    wemb = net.embeddings.word_embeddings.weight
    loss = net(ids, masked_lm_labels=lab)
    (g,) = paddle.grad(loss, [wemb], retain_graph=True)
    loss.backward()
    check(torch.equal(g, wemb.grad), "paddle.grad != backward's .grad")
    check(isinstance(wemb.grad, paddle.Tensor), "a Parameter's .grad is "
                                                 "not a Tensor")
    opt.clear_grad()
    # a no_grad eval pass, with a post hook on every encoder layer
    fired = []
    hooks = [layer.register_forward_post_hook(
        lambda m, inp, o: fired.append(1)) for layer in net.encoder.layers]
    net.eval()
    with paddle.no_grad():
        h = net(ids)
    for hk in hooks:
        hk.remove()
    check(h.grad_fn is None and h.stop_gradient, "no_grad built a graph")
    check(len(fired) == cfg.num_hidden_layers, f"post hooks fired "
                                               f"{len(fired)} times")
    out.update({"paddle_grad_equals_backward": True,
                "eval_builds_graph": False, "post_hook_fires": len(fired)})
    del net, opt, net2, opt2
    return out


def _dygraph_serve_f16(paddle):
    """(c): GPT-2 small decorated to f16 through generate and a short
    ServeLoop: the f16 decode kernels' launches."""
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    cfg = GPTConfig()
    net = paddle.amp.decorate(GPT(cfg, seed=0), level="O2", dtype="float16")
    net.eval()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int64)
               for n in (5, 17, 9, 32, 12, 3, 24, 30)]
    kernels.reset_launch_counts()
    ids = paddle.to_tensor(np.stack([p[:3] for p in prompts]))
    gen = net.generate(ids, max_new_tokens=16, temperature=0)
    loop = ServeLoop(net, ServeConfig(max_active=8, kv_blocks=64,
                                      max_seq_len=64))
    outs = loop.serve(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(gen.shape == (8, 19) and bool((gen >= 0).all()) and
          bool((gen < cfg.vocab_size).all()), "bad f16 generate tokens")
    for o in outs:
        check(o.shape == (16,) and o.min() >= 0 and o.max() < cfg.vocab_size,
              "bad f16 served tokens")
    with torch.no_grad():
        lg = net(ids)
    check(lg.dtype == torch.float16 and bool(torch.isfinite(lg).all()),
          "non-finite f16 logits")
    res = {k: counts[k] for k in ("decode_attention", "decode_attention.f16",
                                  "decode_attention.sm90",
                                  "decode_attention.mma",
                                  "paged_decode_attention",
                                  "paged_decode_attention.f16",
                                  "paged_decode_attention.sm90",
                                  "paged_decode_attention.mma")}
    for name in ("decode_attention", "paged_decode_attention"):
        check(counts[name] > 0 and counts[f"{name}.f16"] == counts[name],
              f"{name}: {counts[name]} launches, {counts[name + '.f16']} "
              f"in f16")
        check(counts[f"{name}.sm90"] > counts[f"{name}.mma"] > 0,
              f"{name}: f16 decode steps or chunks missed the Hopper "
              f"kernels: {res}")
    log(f"[serve f16] launches {json.dumps(res)}")
    del net, loop
    return counts, res


def _dispatch_cost(paddle, n=10_000):
    """(d): host microseconds per call of five ops through the port's op
    layer against the bare torch call, on small CUDA tensors, without AMP
    and under O1 bf16; the device work is queued, and the clock stops
    after a synchronize."""
    import torch.nn.functional as tF
    x = paddle.randn([64, 64])
    w = paddle.randn([64, 64])
    xt, wt = x.as_subclass(torch.Tensor), w.as_subclass(torch.Tensor)
    cases = {
        "add": (lambda: paddle.add(x, w), lambda: torch.add(xt, wt)),
        "matmul": (lambda: paddle.matmul(x, w),
                   lambda: torch.matmul(xt, wt)),
        "reshape": (lambda: paddle.reshape(x, [32, 128]),
                    lambda: torch.reshape(xt, (32, 128))),
        "transpose": (lambda: paddle.transpose(x, [1, 0]),
                      lambda: torch.permute(xt, (1, 0))),
        "softmax": (lambda: paddle.nn.functional.softmax(x),
                    lambda: tF.softmax(xt, -1)),
    }

    def per_call(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    out = {}
    for amp_on in (False, True):
        tag = "o1_bf16" if amp_on else "no_amp"
        ctx = paddle.amp.auto_cast(level="O1", dtype="bfloat16") \
            if amp_on else contextlib.nullcontext()
        with ctx:
            out[tag] = {name: {"port_us": per_call(port),
                               "torch_us": per_call(bare)}
                        for name, (port, bare) in cases.items()}
    log(f"[dispatch] host us per call, {n} calls: {json.dumps(out)}")
    return out


def phase_dygraph(card=None):
    """Phase 18, written against ``import paddle_tpu_torch as paddle``
    only: (a) BERT-base b32 s128 (dropout 0.1, bf16 O2 with f32 masters,
    AdamW) through the plain dygraph loop, loss.backward(); opt.step();
    opt.clear_grad(), 40 steps of LMDataset batches through
    paddle.to_tensor; (b) the Layer and autograd API at dropout 0; (c)
    GPT-2 small in f16 through generate and a ServeLoop; (d) the op
    layer's host cost per call."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import BertConfig
    batch, seq, steps, timed = 32, 128, 40, 30
    paddle.set_device("gpu")
    paddle.seed(0)
    cfg = BertConfig.bert_base()
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq, n=16 * batch,
                   mode="mlm", seed=0)
    api = phase_api_checks()
    net, opt = _dygraph_bert(paddle, cfg)
    it = itertools.count()

    def step():
        i = next(it) % 16
        ids = paddle.to_tensor(ds.inputs[i * batch:(i + 1) * batch])
        lab = paddle.to_tensor(ds.labels[i * batch:(i + 1) * batch])
        loss = net(ids, masked_lm_labels=lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    kernels.reset_launch_counts()
    losses = []
    torch.cuda.synchronize()
    t_start = None
    for i in range(steps):
        if i == steps - timed:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(step().detach())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / timed
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    for k, per in HAPI_STEP_LAUNCHES.items():      # as Model.fit's step
        check(counts[k] == per * steps == counts[f"{k}.sm90"],
              f"{k}: {counts[k]} launches in {steps} dygraph steps "
              f"({counts[k + '.sm90']} Hopper), not {per * steps}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(bool(np.isfinite(losses).all()) and last < first,
          f"the dygraph loss is not finite and falling: {first} -> {last}")
    res = {"config": "bert_base", "batch": batch, "seq": seq,
           "steps": steps, "timed_steps": timed, "step_ms": step_ms,
           "loss_first5": first, "loss_last5": last, "losses": losses,
           "launches": {k: counts[k] for k in PATH_KERNELS + SM90_COUNTS
                        + CE_SM90_COUNTS}, "card": card}
    try:
        prof = _profile_steps(step, n=10)
    except Exception as e:   # the measurement is optional, the step is not
        prof = None
        log(f"[dygraph profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        res["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
        res["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
            / step_ms
        res["top"] = prof["top"]
    log(f"[dygraph] {json.dumps(res)}")
    del net, opt
    res["api"] = api
    res["state"] = _dygraph_state(paddle, cfg, ds, 8)
    log(f"[dygraph state] {json.dumps(res['state'])}")
    serve_counts, res["serve_f16"] = _dygraph_serve_f16(paddle)
    res["dispatch_us"] = _dispatch_cost(paddle)
    return counts, serve_counts, res


# --------------------------------------------------------------------------
# phase 19: the encoder-decoder Transformer-base
# --------------------------------------------------------------------------

TF_VOCAB, TF_PAD, TF_BOS = 37000, 0, 1
TF_D = 512
# each training step of Transformer-base: the encoder's 6 self-attentions
# and the decoder's 6 cross-attentions on the flash kernels, the tied head
# on the CE kernels, all Hopper
TF_STEP_LAUNCHES = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                    "fused_ce_fwd": 1, "fused_ce_bwd_dh": 1,
                    "fused_ce_bwd_dw": 1}
# f32 Transformer-base step, the kernels (flash_attention.cu, fused_ce.cu)
# against the composites: the loss relative; each gradient's largest
# |difference| over its largest |entry| ("grad_max") and its difference's
# norm over its norm ("grad_norm"). ReLU's kink makes both coarser than
# GELU models' (GPT_STEP_TOL): a pre-activation within rounding of 0
# falls on the other side on one path, which moves one of the 2048 terms
# of each entry of its FFN weight's gradient. Set from the worst readings
# (loss equal; an FFN linear1 weight 5.0e-4 max, 5.8e-5 norm; PERF.md
# section 6) with 4x headroom
TF_STEP_TOL = {"loss": 1e-5, "grad_max": 2e-3, "grad_norm": 2.5e-4}
# the masks hold: outputs where a mask must hide the change, absolute
TF_MASK_TOL = 1e-6


def _sinusoid(n, d):
    """The sinusoidal positions of Vaswani et al. [n, d]: sines on the
    even channels, cosines on the odd ones."""
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    ang = pos / 10000 ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    pe = torch.zeros(n, d, dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(ang), torch.cos(ang)
    return pe.float()


def _seq2seq(paddle, dropout, seed=0):
    """Transformer-base for translation from the port's public surface: one
    embedding shared by the source, the target and the output (V 37000,
    Vaswani's shared BPE vocabulary; N(0, d^-1/2), scaled by sqrt(d)),
    sinusoidal positions, ``paddle.nn.Transformer()`` at its defaults, and
    the loss through ``F.fused_linear_cross_entropy`` on the tied table."""
    F = paddle.nn.functional
    paddle.seed(seed)

    class Seq2Seq(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = paddle.nn.Embedding(
                TF_VOCAB, TF_D, weight_attr=paddle.ParamAttr(
                    initializer=paddle.nn.initializer.Normal(
                        0.0, TF_D ** -0.5)))
            self.tf = paddle.nn.Transformer(dropout=dropout)
            self.register_buffer("pos", _sinusoid(512, TF_D).cuda(),
                                 persistable=False)

        def embed(self, ids, start=0):
            x = self.emb(ids) * TF_D ** 0.5
            return x + self.pos[start:start + ids.shape[1]].to(x.dtype)

        def forward(self, src, tgt_in, src_mask, tgt_mask, labels):
            h = self.tf(self.embed(src), self.embed(tgt_in), src_mask,
                        tgt_mask, src_mask)
            return F.fused_linear_cross_entropy(h, self.emb.weight, None,
                                                labels, ignore_index=TF_PAD)

        def logits(self, h):
            return paddle.matmul(h, self.emb.weight, transpose_y=True)

    return Seq2Seq()


def _tf_batch(b, seq, rng, lo=128, hi=256):
    """Synthetic pairs: source tokens Zipf-like over the vocabulary (rank
    r drawn with weight 1/r, mapped through a fixed permutation), lengths
    in [lo, hi], padded to ``seq``; each target is its source reversed.
    Returns (src, tgt_in = BOS + target[:-1], labels = target with
    padding as ``ignore_index``, src_mask bool [b, 1, 1, seq]) on the card,
    and the count of target tokens."""
    perm = np.random.RandomState(7).permutation(TF_VOCAB - 2) + 2
    ranks = np.minimum(rng.zipf(1.1, (b, seq)), TF_VOCAB - 2) - 1
    toks = perm[ranks]
    lens = rng.randint(lo, hi + 1, b)
    src = np.full((b, seq), TF_PAD, np.int64)
    tgt_in = np.full((b, seq), TF_PAD, np.int64)
    labels = np.full((b, seq), TF_PAD, np.int64)
    for i, n in enumerate(lens):
        src[i, :n] = toks[i, :n]
        labels[i, :n] = toks[i, :n][::-1]
        tgt_in[i, 0] = TF_BOS
        tgt_in[i, 1:n] = labels[i, :n - 1]
    src_t = torch.from_numpy(src).cuda()
    return (src_t, torch.from_numpy(tgt_in).cuda(),
            torch.from_numpy(labels).cuda(),
            (src_t != TF_PAD)[:, None, None, :]), int(lens.sum())


def _tf_train(paddle, card, batch=32, seq=256, steps=40, timed=30):
    """(a) bf16 O2 training: Adam (0.9, 0.98, 1e-9) under NoamDecay(512,
    4000) from its peak, dropout 0.1, 8 batches cycled."""
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.ops import cuda as kernels
    net = _seq2seq(paddle, dropout=0.1)
    sched = paddle.optimizer.lr.NoamDecay(d_model=TF_D, warmup_steps=4000,
                                          last_epoch=3999)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=net.parameters())
    net, opt = paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    net.train()
    rng = np.random.RandomState(0)
    data = [_tf_batch(batch, seq, rng) for _ in range(8)]
    sq_mask = paddle.nn.Transformer.generate_square_subsequent_mask(seq)
    lr0 = sched.get_lr()
    it = itertools.count()

    def step():
        (src, tgt_in, labels, mask), _ = data[next(it) % len(data)]
        loss = net(src, tgt_in, mask, sq_mask, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    kernels.reset_launch_counts()
    monitor.reset(prefix="cuda.")
    losses, t_start = [], None
    torch.cuda.synchronize()
    for i in range(steps):
        if i == steps - timed:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(step().detach())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) * 1e3 / timed
    counts = kernels.launch_counts()
    gates = monitor.stats("cuda.")
    losses = [float(v) for v in losses]
    for k, per in TF_STEP_LAUNCHES.items():
        check(counts[k] == per * steps == counts[f"{k}.sm90"],
              f"{k}: {counts[k]} launches in {steps} Transformer steps "
              f"({counts[k + '.sm90']} Hopper), not {per * steps}")
    check(gates.get("cuda.gate_reject.flash_attention.shape") == 6 * steps,
          f"the decoder self-attentions' shape rejections: {gates}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(bool(np.isfinite(losses).all()) and last < first,
          f"the Transformer loss is not finite and falling: {first} -> "
          f"{last}")
    tokens = np.mean([n for _, n in data])
    res = {"config": "transformer_base", "batch": batch, "seq": seq,
           "steps": steps, "timed_steps": timed, "step_ms": step_ms,
           "target_tokens_per_step": tokens,
           "target_tokens_per_s": tokens / step_ms * 1e3,
           "padded_tokens_per_s": batch * seq / step_ms * 1e3,
           "lr_first": lr0, "loss_first5": first, "loss_last5": last,
           "losses": losses, "gates_per_step": {
               k: v / steps for k, v in gates.items()},
           "launches": {k: counts[k] for k in PATH_KERNELS + SM90_COUNTS
                        + CE_SM90_COUNTS}, "card": card}
    try:
        prof = _profile_steps(step, n=10)
    except Exception as e:   # the measurement is optional, the step is not
        prof = None
        log(f"[transformer profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        res["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
        res["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
            / step_ms
        res["top"] = prof["top"]
    log(f"[transformer train] {json.dumps(res)}")
    return net, counts, res


def _tf_decode(paddle, net, b=32, src_len=256, new=64):
    """(c) greedy decoding, eval: the encoder once, then one token at a
    time through one StaticKVCache per decoder layer, the cross-attention
    recomputed from ``memory`` each step. Returns (tokens, counts, the
    readings)."""
    from paddle_tpu_torch.ops import cuda as kernels
    net.eval()
    rng = np.random.RandomState(1)
    (src, _, _, mask), _ = _tf_batch(b, src_len, rng, src_len, src_len)
    dtype = net.emb.weight.dtype
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with paddle.no_grad():
        memory = net.tf.encoder(net.embed(src), src_mask=mask)
        caches = net.tf.decoder.gen_static_cache(b, src_len + new, dtype)
        tok = torch.full((b, 1), TF_BOS, dtype=torch.int64, device="cuda")
        toks = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kernels.reset_launch_counts()
        for i in range(new):
            out, caches = net.tf.decoder(net.embed(tok, i), memory,
                                         memory_mask=mask, cache=caches)
            tok = paddle.argmax(net.logits(out), axis=-1)
            toks.append(tok)
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = kernels.launch_counts()
    toks = torch.cat(toks, 1)
    ms_tok = (t_end - t1) * 1e3 / new
    for k, per in (("decode_attention", 6), ("decode_attention.sm90", 6),
                   ("flash_fwd", 6), ("flash_fwd.sm90", 6)):
        check(counts[k] == per * new, f"{k}: {counts[k]} launches in {new} "
                                      f"decoded tokens, not {per * new}")
    check(toks.shape == (b, new) and bool((toks >= 0).all()) and
          bool((toks < TF_VOCAB).all()), "bad decoded tokens")
    res = {"batch": b, "src_len": src_len, "new_tokens": new,
           "cache_len": src_len + new, "dtype": str(dtype)[6:],
           "encoder_ms": (t1 - t0) * 1e3, "ms_per_token": ms_tok,
           "tokens_per_s": b / ms_tok * 1e3,
           "launches_per_token": {k: counts[k] / new for k in (
               "decode_attention", "decode_attention.sm90", "flash_fwd",
               "flash_fwd.sm90")}}
    log(f"[transformer decode] {json.dumps(res)}")
    return toks, counts, res


def _tf_step_f32(paddle, use_kernels, batch):
    """One f32 Adam step at dropout 0 with the flash and CE kernels on or
    both flags off: (loss, {name: grad}, launches, the net)."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops import cuda as kernels
    flags.set_flags({"FLAGS_use_flash_attention": use_kernels,
                     "FLAGS_use_fused_ce": use_kernels})
    net = _seq2seq(paddle, dropout=0.0)
    net.train()
    opt = paddle.optimizer.Adam(learning_rate=1e-4, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=net.parameters())
    (src, tgt_in, labels, mask), _ = batch
    sq = paddle.nn.Transformer.generate_square_subsequent_mask(
        src.shape[1])
    before = kernels.launch_counts()
    loss = net(src, tgt_in, mask, sq, labels)
    loss.backward()
    grads = {k: None if p.grad is None else p.grad.detach().clone()
             for k, p in net.named_parameters()}
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    used = {k: kernels.launch_counts()[k] - before[k] for k in PATH_KERNELS}
    return float(loss.detach()), grads, used, net


def _tf_equivalence(paddle):
    """(b) f32, dropout 0, b 8, s 256: one step through the kernels against
    one with FLAGS_use_flash_attention and FLAGS_use_fused_ce off, from the
    same weights on the same batch. Returns (the kernel path's net, the
    readings)."""
    from paddle_tpu_torch.core import flags
    names = ("FLAGS_use_flash_attention", "FLAGS_use_fused_ce")
    saved = {n: flags.flag(n) for n in names}
    batch = _tf_batch(8, 256, np.random.RandomState(2))
    try:
        lk, gk, used_k, net = _tf_step_f32(paddle, True, batch)
        lp, gp, used_p, _ = _tf_step_f32(paddle, False, batch)
    finally:
        flags.set_flags(saved)
    check(used_k == {**{k: 12 for k in FLASH_KERNELS},
                     **{k: 1 for k in CE_KERNELS}} and
          set(used_p.values()) == {0},
          f"the flags did not route the step: {used_k} / {used_p}")
    rel = abs(lk - lp) / abs(lp)
    dgrad = {k: _grad_rel(gk[k], gp[k]) for k in gk}
    dnorm = {k: 0.0 if gk[k] is None else float(
        (gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30)) for k in gk}
    worst = max(dgrad, key=dgrad.get)
    worst_n = max(dnorm, key=dnorm.get)
    res = {"loss_kernels": lk, "loss_composites": lp, "loss_rel_diff": rel,
           "grad_max_rel_diff": dgrad[worst], "grad_worst": worst,
           "grad_norm_rel_diff": dnorm[worst_n], "grad_norm_worst": worst_n,
           "tol": TF_STEP_TOL}
    log(f"[transformer f32 equivalence] {json.dumps(res)}")
    check(np.isfinite(lk), "Transformer loss not finite")
    check(rel <= TF_STEP_TOL["loss"], f"Transformer loss differs: {rel}")
    check(dgrad[worst] <= TF_STEP_TOL["grad_max"],
          f"Transformer gradient {worst} differs: {dgrad[worst]}")
    check(dnorm[worst_n] <= TF_STEP_TOL["grad_norm"],
          f"Transformer gradient {worst_n} differs in norm: "
          f"{dnorm[worst_n]}")
    return net, res


def _tf_cached_vs_uncached(paddle, net, b=8, new=24):
    """(d) f32, eval: greedy tokens through the StaticKVCaches against an
    uncached re-run of the whole decoder over the prefix at every step;
    a divergence passes only at a top-2 logit near-tie (gap < 1e-4), as
    phase 4's rule."""
    net.eval()
    (src, _, _, mask), _ = _tf_batch(b, 256, np.random.RandomState(3))
    with paddle.no_grad():
        memory = net.tf.encoder(net.embed(src), src_mask=mask)
        caches = net.tf.decoder.gen_static_cache(b, new + 1)
        tok = torch.full((b, 1), TF_BOS, dtype=torch.int64, device="cuda")
        cached = [tok]
        for i in range(new):
            out, caches = net.tf.decoder(net.embed(tok, i), memory,
                                         memory_mask=mask, cache=caches)
            tok = paddle.argmax(net.logits(out), axis=-1)
            cached.append(tok)
        cached = torch.cat(cached, 1)
        prefix = cached[:, :1]
        ties = []
        for i in range(new):
            sq = paddle.nn.Transformer.generate_square_subsequent_mask(
                i + 1)
            h = net.tf.decoder(net.embed(prefix), memory, tgt_mask=sq,
                               memory_mask=mask)
            lg = net.logits(h[:, -1:])[:, 0].float()
            want = lg.argmax(-1)
            for row in torch.nonzero(want != cached[:, i + 1]).flatten():
                top = torch.topk(lg[row], 2).values
                gap = float(top[0] - top[1])
                ties.append((int(row), i, gap))
                check(gap < 1e-4, f"cached decoding diverges from the "
                                  f"uncached decoder at row {int(row)} "
                                  f"token {i} without a near-tie ({gap})")
            # follow the cached tokens, so one near-tie does not change
            # the rest of the row
            prefix = cached[:, :i + 2]
    res = {"batch": b, "new_tokens": new, "near_ties": ties,
           "token_identical_rows": b - len({r for r, _, _ in ties})}
    log(f"[transformer cached f32] {json.dumps(res)}")
    return res


def phase_transformer_masks(net=None):
    """(e) the masks hold, f32 eval, kernels on: source tokens under the
    padding mask changed leave the decoder's output as it was
    (``src_mask`` and the cross-attention's ``memory_mask``), and a target
    token changed leaves every earlier position's output as it was
    (``tgt_mask``). Returns the readings."""
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    if net is None:
        net = _seq2seq(paddle, dropout=0.0)
    net.eval()
    (src, tgt_in, _, mask), _ = _tf_batch(4, 256, np.random.RandomState(4),
                                          128, 200)
    sq = paddle.nn.Transformer.generate_square_subsequent_mask(256)
    src2 = torch.where(mask[:, 0, 0], src, 5)
    tgt2 = tgt_in.clone()
    tgt2[:, 100] = 7 + (tgt2[:, 100] + 1) % 1000
    with paddle.no_grad():
        h = net.tf(net.embed(src), net.embed(tgt_in), mask, sq, mask)
        h_src = net.tf(net.embed(src2), net.embed(tgt_in), mask, sq, mask)
        h_tgt = net.tf(net.embed(src), net.embed(tgt2), mask, sq, mask)
    res = {"padded_source_changed": float((h_src - h).abs().max()),
           "later_target_changed": float(
               (h_tgt[:, :100] - h[:, :100]).abs().max()),
           "target_change_seen_at_its_position": float(
               (h_tgt[:, 100] - h[:, 100]).abs().max()), "tol": TF_MASK_TOL}
    log(f"[transformer masks] {json.dumps(res)}")
    check(res["padded_source_changed"] <= TF_MASK_TOL,
          f"the padding mask leaks: {res['padded_source_changed']}")
    check(res["later_target_changed"] <= TF_MASK_TOL,
          f"the causal mask leaks: {res['later_target_changed']}")
    check(res["target_change_seen_at_its_position"] > 1e-3,
          "a changed target token changed nothing")
    return res


def _tf_kernel_checks():
    """(f) the kernels at this path's new shapes against their plain
    versions: flash forward, dq and dk/dv at (s_q, s_k) = (256, 200) and
    (1, 256), b 2, h 8, d 64, bf16, a key bias, not causal (phase 10's
    limits, each Hopper kernel repeated bitwise); the contiguous decode
    kernel at b 32, h 8, d 64, L 320, fill 255 (phase 2's limits)."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda import decode_attention
    from paddle_tpu_torch.ops.cuda.decode_attention import \
        decode_attention_ref
    gen = torch.Generator().manual_seed(19)
    worst = {}
    for sq, sk in ((256, 200), (1, 256)):
        where = f"transformer bf16 sq={sq} sk={sk} d=64 bias"
        q, k, v, bb, do = _flash_inputs(16, 2, sq, sk, 64, torch.bfloat16,
                                        True, gen)
        before = kernels.launch_counts()
        errs = flash_errors(q, k, v, bb, False, do, where, repeat=True)
        used = {key: kernels.launch_counts()[key] - before[key]
                for key in SM90_COUNTS}
        check(set(used.values()) == {2}, f"{where}: Hopper launches {used}")
        log(f"[transformer kernels] {where}: {_flash_line(errs)}")
        for key, e in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
    b, h, d, L, fill = 32, 8, 64, 320, 255
    q, kc, vc = (torch.randn(b, h, s, d, generator=gen).to(
        "cuda", torch.bfloat16) for s in (1, L, L))
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fill)
    err, rel = decode_check(decode_attention, (q, kc, vc, fill), ref,
                            torch.bfloat16,
                            f"transformer b{b} h{h} d{d} L{L} fill {fill}",
                            L)
    worst["decode_attention"] = err
    worst["decode_norm"] = rel
    return worst


def phase_transformer(card=None):
    """Phase 19: the encoder-decoder Transformer-base (Vaswani et al. 2017,
    "base": d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1,
    ReLU, post-norm) built from the port's public surface, as a
    translation model with a shared 37,000-token embedding tied to the
    output. Cuts from the paper's recipe: ~8k padded (~6k target) tokens
    a step, not ~25k; no label smoothing (the fused CE has none); the
    schedule starts at its peak (NoamDecay's step 4000, lr 7e-4), since
    from step 0 it would stay under 1e-5 for these 40 steps; random
    synthetic pairs (each target its source reversed), not WMT. (a) bf16
    O2 training, 40 steps (30 timed, 10 profiled), 12 / 12 / 12 flash and
    1 / 1 / 1 CE Hopper launches and 6 ``shape`` rejections a step; (b)
    the f32 step through the kernels against the composites; (c) greedy
    decoding of 32 sources of 256 tokens, 64 new tokens, 6 decode and 6
    flash-forward launches a token; (d) f32 cached tokens against an
    uncached decoder; (e) the masks hold; (f) the kernels at the new
    shapes."""
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    kernel_worst = _tf_kernel_checks()
    net, train_counts, res = _tf_train(paddle, card)
    toks, decode_counts, res["decode_bf16"] = _tf_decode(paddle, net)
    del net
    net32, res["f32_equivalence"] = _tf_equivalence(paddle)
    res["f32_cached_vs_uncached"] = _tf_cached_vs_uncached(paddle, net32)
    res["masks"] = phase_transformer_masks(net32)
    res["kernel_checks"] = kernel_worst
    del net32
    return train_counts, decode_counts, res


# --------------------------------------------------------------------------
# phase 20: vision and conv
# --------------------------------------------------------------------------

# Phase 20(a)'s limits: the largest |port - oracle| over the finite
# entries, over max(1, the largest |oracle|), per op and dtype. The
# oracle is float64 numpy on the same (bf16-rounded) values. f32 (no TF32,
# ``setup()``): sums of at most 128 products. bf16: the output rounded to
# bf16 (2^-9 of its value); the port's CPU path reads up to 4.3e-3 for a
# conv and 5.3e-3 for interpolate (its weights rounded to bf16, as JAX
# casts them to the input dtype, and one more rounding between the two
# axes); an average's sum and quotient are two roundings. A max reads
# stored values: exact in both. A wrong pad moves entries by O(1).
CONV_ORACLE_TOL = {
    "conv2d": {torch.float32: 1e-5, torch.bfloat16: 2 ** -6},
    "conv2d_transpose": {torch.float32: 1e-5, torch.bfloat16: 2 ** -6},
    "max_pool2d": {torch.float32: 0.0, torch.bfloat16: 0.0},
    "avg_pool2d": {torch.float32: 1e-6, torch.bfloat16: 2 ** -7},
    "interpolate": {torch.float32: 1e-5, torch.bfloat16: 2 ** -6},
}
# phase 20(d), ResNet-50 at b2 64^2, the card against the port's CPU path
# on the same weights and batch. f64: both sides compute the same
# function, so loss, every gradient's norm and every BN running stat
# agree to rounding (readings on the H100: 1.9e-15, 1.7e-13, 1.3e-13).
# f32: the JAX formula's variance (E[x^2] - E[x]^2) at 8 values a channel
# in the last stage amplifies each side's own rounding (two packages on
# one CPU differ there by up to 9% of a gradient's norm,
# tests/test_torch_vision.py), so f32 holds the gradient norms loosely
# (readings: loss 2.5e-6, gradient norms 4.6e-3, running stats 8.8e-5).
VISION_STEP_TOL = {torch.float64: {"loss": 1e-9, "grad_norm": 1e-8,
                                   "stat": 1e-9},
                   torch.float32: {"loss": 1e-4, "grad_norm": 0.05,
                                   "stat": 1e-3}}
RESNET_PEAK = 989e12          # H100 SXM dense bf16, data sheet
# name fragments of the kernels a ResNet-50 step runs, summed per step:
# cuDNN's convs (xmma / cutlass / cudnn names) and layout transposes,
# torch's elementwise, reduction and copy kernels (BN's composite, ReLU,
# the adds, the casts, the optimizer)
RESNET_KERNEL_KINDS = ("xmma", "cutlass", "cudnn", "nchwToNhwc",
                       "nhwcToNchw", "elementwise", "reduce_kernel", "copy",
                       "Memcpy", "max_pool")


def _np_same(size, k, s, d=1):
    """XLA's SAME pads of one axis, for the oracle."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _np_conv2d(x, w, stride, pads, dilation, groups):
    """float64 im2col: x [N, C, H, W], w [O, C / groups, kh, kw], pads
    ((lo, hi), (lo, hi))."""
    x = np.pad(x, ((0, 0), (0, 0)) + tuple(pads))
    n, c, hp, wp = x.shape
    o, cg, kh, kw = w.shape
    (sh, sw), (dh, dw) = stride, dilation
    oh = (hp - (kh - 1) * dh - 1) // sh + 1
    ow = (wp - (kw - 1) * dw - 1) // sw + 1
    cols = np.empty((n, c, kh, kw, oh, ow))
    for i in range(kh):
        for j in range(kw):
            cols[:, :, i, j] = x[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                                 j * dw:j * dw + (ow - 1) * sw + 1:sw]
    cols = cols.reshape(n, groups, cg, kh, kw, oh, ow)
    wg = w.reshape(groups, o // groups, cg, kh, kw)
    return np.einsum("ngcijhw,gocij->ngohw", cols, wg).reshape(n, o, oh, ow)


def _np_conv2d_transpose(x, w, stride, pads, opad, dilation, groups):
    """float64 scatter of each input entry times each tap: w [Ci, Co /
    groups, kh, kw]; the full output cut by lo at the low side and
    hi - output_padding at the high side (zeros past its end)."""
    n, ci, h, wd = x.shape
    _, cog, kh, kw = w.shape
    (sh, sw), (dh, dw) = stride, dilation
    cig = ci // groups
    fh, fw = (h - 1) * sh + (kh - 1) * dh + 1, (wd - 1) * sw + (kw - 1) * dw + 1
    full = np.zeros((n, cog * groups, fh + opad[0], fw + opad[1]))
    for g in range(groups):
        xg, wg = x[:, g * cig:(g + 1) * cig], w[g * cig:(g + 1) * cig]
        for i in range(kh):
            for j in range(kw):
                full[:, g * cog:(g + 1) * cog,
                     i * dh:i * dh + (h - 1) * sh + 1:sh,
                     j * dw:j * dw + (wd - 1) * sw + 1:sw] += np.einsum(
                    "nchw,co->nohw", xg, wg[:, :, i, j])
    (lh, hh), (lw, hw) = pads
    return full[:, :, lh:fh - hh + opad[0], lw:fw - hw + opad[1]]


def _np_pool(x, k, s, pads, ceil_mode, kind, exclusive=True):
    """float64 explicit windows under JAX's rule: with ceil_mode the count
    is ceil((L + lo + hi - k) / s) + 1 and a window may cover padding
    only (max -inf, exclusive average 0 / 0); padding is never a max and
    never counted by an exclusive average."""
    n, c, h, w = x.shape
    counts = []
    for size, kk, ss, (lo, hi) in zip((h, w), k, s, pads):
        span = size + lo + hi - kk
        counts.append((-(-span // ss) if ceil_mode else span // ss) + 1)
    out = np.empty((n, c) + tuple(counts))
    for a in range(counts[0]):
        for b in range(counts[1]):
            y0, x0 = a * s[0] - pads[0][0], b * s[1] - pads[1][0]
            ys = [y for y in range(y0, y0 + k[0]) if 0 <= y < h]
            xs = [v for v in range(x0, x0 + k[1]) if 0 <= v < w]
            win = x[:, :, ys][:, :, :, xs].reshape(n, c, -1)
            if kind == "max":
                out[:, :, a, b] = win.max(-1) if win.shape[-1] else -np.inf
                continue
            total = win.sum(-1) if win.shape[-1] else np.zeros((n, c))
            div = win.shape[-1] if exclusive else k[0] * k[1]
            with np.errstate(invalid="ignore"):
                out[:, :, a, b] = total / div if div else total / 0.0
    return out


def _np_resize_weights(m, n, method):
    """jax.image.resize's [m, n] weights of one axis (antialiased when it
    shrinks), float64."""
    scale = n / m
    ksc = max(1.0 / scale, 1.0)
    sample = (np.arange(n) + 0.5) / scale - 0.5
    t = np.abs(sample[None, :] - np.arange(m)[:, None]) / ksc
    if method == "linear":
        wts = np.maximum(0.0, 1.0 - t)
    else:    # Keys' cubic, a = -0.5
        wts = np.where(t < 1, (1.5 * t - 2.5) * t * t + 1,
                       np.where(t < 2, ((-0.5 * t + 2.5) * t - 4) * t + 2,
                                0.0))
    tot = wts.sum(0, keepdims=True)
    wts = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps,
                   wts / np.where(tot != 0, tot, 1), 0.0)
    keep = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(keep[None, :], wts, 0.0)


def _np_interpolate(x, size, mode):
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic", "area": "linear"}[mode]
    for axis, n in ((2, size[0]), (3, size[1])):
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            src = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                           * np.float32(m) / np.float32(n)).astype(int)
            x = np.take(x, src, axis=axis)
        else:
            x = np.moveaxis(np.tensordot(x, _np_resize_weights(m, n, method),
                                         axes=([axis], [0])), -1, axis)
    return x


def _oracle_cases():
    """(op, case, port call, oracle, [input arrays]) of phase 20(a): the
    oracle takes the float64 copies of the inputs as the card holds
    them."""
    r = np.random.RandomState(20)

    def a(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    x17, x16, x9, x5 = a(2, 8, 17, 17), a(2, 8, 16, 16), a(2, 8, 9, 9), \
        a(1, 2, 5, 5)
    relu = np.maximum(a(2, 8, 18, 18), 0)
    cases = []

    def conv(name, x, w, b, stride=1, padding=0, dilation=1, groups=1,
             nhwc=False):
        st, dl = (stride,) * 2, (dilation,) * 2
        k = w.shape[:2] if nhwc else w.shape[2:]
        hw = x.shape[1:3] if nhwc else x.shape[2:]
        if padding == "SAME":
            pads = tuple(_np_same(hw[i], k[i], st[i], dl[i]) for i in (0, 1))
        elif isinstance(padding, list):
            pads = ((padding[0], padding[1]), (padding[2], padding[3]))
        else:
            pads = ((padding, padding),) * 2

        def oracle(xo, wo, bo):
            if nhwc:
                xo, wo = xo.transpose(0, 3, 1, 2), wo.transpose(3, 2, 0, 1)
            out = _np_conv2d(xo, wo, st, pads, dl, groups) \
                + bo.reshape(1, -1, 1, 1)
            return out.transpose(0, 2, 3, 1) if nhwc else out
        cases.append(("conv2d", name, lambda p, xt, wt, bt: p.ops.conv2d(
            xt, wt, bt, stride=stride, padding=padding, dilation=dilation,
            groups=groups, data_format="NHWC" if nhwc else "NCHW"),
            oracle, [x, w, b]))

    conv("groups", x17, a(16, 4, 3, 3, scale=0.3), a(16), padding=1,
         groups=2)
    conv("depthwise_s2", x17, a(8, 1, 3, 3, scale=0.3), a(8), stride=2,
         padding=1, groups=8)
    conv("dilation", x17, a(16, 8, 3, 3, scale=0.2), a(16), padding=2,
         dilation=2)
    conv("same_s2_odd", x17, a(16, 8, 4, 4, scale=0.2), a(16), stride=2,
         padding="SAME")
    conv("same_s2_even", x16, a(16, 8, 3, 3, scale=0.2), a(16), stride=2,
         padding="SAME")
    conv("pads4_s2", x17, a(16, 8, 3, 3, scale=0.2), a(16), stride=2,
         padding=[1, 2, 0, 1])
    conv("nhwc", x17.transpose(0, 2, 3, 1).copy(), a(3, 3, 8, 16, scale=0.2),
         a(16), padding=1, nhwc=True)

    def convt(name, x, w, b, stride, padding, opad, groups=1):
        pads = ((padding[0], padding[1]), (padding[2], padding[3])) \
            if isinstance(padding, list) else ((padding, padding),) * 2
        cases.append((
            "conv2d_transpose", name,
            lambda p, xt, wt, bt: p.ops.conv2d_transpose(
                xt, wt, bt, stride=stride, padding=padding,
                output_padding=opad, groups=groups),
            lambda xo, wo, bo: _np_conv2d_transpose(
                xo, wo, (stride,) * 2, pads, (opad,) * 2, (1, 1), groups)
            + bo.reshape(1, -1, 1, 1), [x, w, b]))

    convt("opad", x9, a(8, 6, 3, 3, scale=0.3), a(6), 2, 1, 1)
    convt("groups", x9, a(8, 3, 3, 3, scale=0.3), a(6), 2, 0, 0, groups=2)
    convt("pads4_opad", x9, a(8, 6, 3, 3, scale=0.3), a(6), 2, [1, 0, 0, 2],
          1)

    def pool(op, name, x, k, s, p, ceil, exclusive=True):
        kw = {} if op == "max_pool2d" else {"exclusive": exclusive}
        cases.append((op, name, lambda pk, xt: pk.ops.OP_REGISTRY[op](
            xt, k, stride=s, padding=p, ceil_mode=ceil, **kw),
            lambda xo: _np_pool(xo, (k, k), (s, s), ((p, p), (p, p)), ceil,
                                op[:3], exclusive), [x]))

    pool("max_pool2d", "resnet_ties", relu, 3, 2, 1, False)
    pool("max_pool2d", "ceil_padding_window", x5, 2, 2, 1, True)
    pool("max_pool2d", "ceil", x17, 3, 2, 0, True)
    pool("avg_pool2d", "exclusive", x17, 3, 2, 1, False)
    pool("avg_pool2d", "inclusive", x17, 3, 2, 1, False, exclusive=False)
    pool("avg_pool2d", "ceil_padding_window_nan", x5, 2, 2, 1, True)
    pool("avg_pool2d", "ceil_overhang", x17, 3, 2, 1, True)

    for mode, size in (("nearest", (29, 23)), ("nearest", (7, 9)),
                       ("bilinear", (29, 23)), ("bilinear", (7, 9)),
                       ("bicubic", (29, 12)), ("area", (8, 6))):
        cases.append(("interpolate", f"{mode}_{size[0]}x{size[1]}",
                      lambda p, xt, size=size, mode=mode: p.ops.interpolate(
                          xt, size=list(size), mode=mode),
                      lambda xo, size=size, mode=mode: _np_interpolate(
                          xo, size, mode), [x17]))
    return cases


def conv_oracle_errors(device="cuda", dtypes=(torch.float32,
                                              torch.bfloat16)):
    """Phase 20(a)'s readings: {op: {dtype: worst}} and every case's
    (op, case, dtype, error, limit); each case must keep the oracle's
    shape, its -inf and nan entries, and stay within its limit."""
    import paddle_tpu_torch as paddle
    worst, rows = {}, []
    for op, name, call, oracle, arrays in _oracle_cases():
        for dt in dtypes:
            ts = [torch.from_numpy(v).to(device, dt) for v in arrays]
            got = call(paddle, *ts).float().cpu().numpy().astype(np.float64)
            ref = oracle(*(t.double().cpu().numpy() for t in ts))
            check(got.shape == ref.shape, f"{op} {name} {dt}: shape "
                                          f"{got.shape}, oracle {ref.shape}")
            check(np.array_equal(np.isnan(got), np.isnan(ref))
                  and np.array_equal(np.isneginf(got), np.isneginf(ref)),
                  f"{op} {name} {dt}: its -inf / nan entries are not the "
                  f"oracle's")
            fin = np.isfinite(ref)
            err = float(np.abs(got[fin] - ref[fin]).max(initial=0.0)) \
                / max(1.0, float(np.abs(ref[fin]).max(initial=0.0)))
            tol, tag = CONV_ORACLE_TOL[op][dt], str(dt).split(".")[-1]
            rows.append((op, name, tag, err, tol))
            per_op = worst.setdefault(op, {})
            per_op[tag] = max(err, per_op.get(tag, 0.0))
            check(err <= tol, f"{op} {name} {dt}: {err:.3e} from the "
                              f"float64 oracle, limit {tol:.3e}")
    return worst, rows


def phase_conv_oracle():
    """Phase 20(a): the conv ops on the card against the float64 oracle."""
    worst, rows = conv_oracle_errors()
    for op, name, dt, err, tol in rows:
        log(f"[conv oracle] {op} {name} {dt}: {err:.3e} (limit {tol:.3e})")
    log(f"[conv oracle] worst {json.dumps(worst)}")
    return worst


def _fit_clock(start):
    """A ``Model.fit`` callback: every step's loss kept unread, and the
    step clock from step ``start`` (counted across epochs) to the last
    (synced at both ends)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Clock(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.t0, self.t1 = [], None, None

        def on_train_batch_begin(self, step, logs=None):
            if len(self.losses) == start:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_end(self, mode, logs=None):
            if mode == "train":
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()

        def step_ms(self):
            return (self.t1 - self.t0) * 1e3 / (len(self.losses) - start)
    return Clock()


def _vision_lenet(paddle, card):
    """(b) LeNet on the synthetic MNIST through Model.fit: Adam 1e-3,
    CrossEntropyLoss, Accuracy, b64, f32, 2 epochs (256 steps), then
    evaluate on the test split."""
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision.datasets import MNIST
    paddle.seed(1)
    model = paddle.Model(paddle.vision.models.LeNet())
    model.prepare(optimizer=paddle.optimizer.Adam(
        learning_rate=0.001, parameters=model.parameters()),
        loss=paddle.nn.CrossEntropyLoss(), metrics=Accuracy())
    train, test = MNIST(mode="train"), MNIST(mode="test")
    clock = _fit_clock(start=128)
    t0 = time.perf_counter()
    model.fit(train, batch_size=64, epochs=2, verbose=0, shuffle=True,
              drop_last=True, callbacks=[clock])
    fit_s = time.perf_counter() - t0
    logs = model.evaluate(test, batch_size=64, verbose=0)
    losses = [float(v) for v in clock.losses]
    res = {"card": card, "images": len(train), "steps": len(losses),
           "step_ms_epoch2": clock.step_ms(), "fit_s": fit_s,
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_first10_mean": float(np.mean(losses[:10])),
           "loss_last10_mean": float(np.mean(losses[-10:])),
           "test_acc": float(logs["acc"]), "test_loss": float(logs["loss"])}
    check(len(losses) == 256, f"LeNet ran {len(losses)} steps, not 256")
    check(bool(np.isfinite(losses).all()) and res["loss_last10_mean"]
          < res["loss_first10_mean"], "the LeNet loss did not fall")
    check(res["test_acc"] > 0.3, f"LeNet test accuracy {res['test_acc']}")
    log(f"[vision lenet] {json.dumps(res)}")
    return res


def _resnet_model(paddle, amp=True):
    """bench.py's bench_resnet trainer through Model: resnet50, Momentum
    0.02 / 0.9, weight decay 1e-4, f32 masters; bf16 O2."""
    paddle.seed(0)
    model = paddle.Model(paddle.vision.models.resnet50())
    model.prepare(optimizer=paddle.optimizer.Momentum(
        learning_rate=0.02, momentum=0.9, parameters=model.parameters(),
        weight_decay=1e-4, multi_precision=True),
        loss=paddle.nn.CrossEntropyLoss(),
        amp_configs={"level": "O2", "dtype": "bfloat16"} if amp else None)
    return model


def _vision_resnet(paddle, card, batch=64, img=224, steps=40, timed=30,
                   profiled=10):
    """(c) ResNet-50 as bench_resnet trains it (b64, 224^2, 8 synthetic
    batches of N(0, 1) images and labels from RandomState(0), cycled, bf16
    on the card as bench.py holds them), through Model.fit in bf16 O2:
    step ms over the last ``timed`` of ``steps``, busy and idle over
    ``profiled`` more, peak memory, the FLOPs of one step (FlopCounterMode:
    the convs and matmuls of forward and backward) and the MFU they give."""
    from torch.utils.flop_counter import FlopCounterMode
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(8):
        x = torch.from_numpy(rng.randn(batch, 3, img, img).astype(
            np.float32)).to("cuda", torch.bfloat16)
        y = torch.from_numpy(rng.randint(0, 1000, batch)).to("cuda")
        batches.append([x, y])
    model = _resnet_model(paddle)
    data = [batches[i % 8] for i in range(steps)]
    clock = _fit_clock(start=steps - timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.fit(data, epochs=1, verbose=0, callbacks=[clock])
    peak = torch.cuda.max_memory_allocated()
    step_ms = clock.step_ms()
    losses = [float(v) for v in clock.losses]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    res = {"card": card, "config": "resnet50", "amp": "O2 bfloat16",
           "batch": batch, "image": img, "steps": steps,
           "timed_steps": timed, "step_ms": step_ms,
           "images_per_s": batch * 1e3 / step_ms,
           "peak_memory_gib": peak / 2 ** 30,
           "loss_first5": float(first), "loss_last5": float(last),
           "losses": losses}
    check(bool(np.isfinite(losses).all()) and last < first,
          f"the ResNet-50 loss is not finite and falling: {first} -> {last}")
    try:
        prof = _profile_steps(lambda: model.fit(data[:profiled], epochs=1,
                                                verbose=0),
                              n=1, steps_per_call=profiled,
                              named=RESNET_KERNEL_KINDS)
    except Exception as e:   # the measurement is optional, the fit is not
        prof = None
        log(f"[vision resnet profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        res["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
        res["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
            / step_ms
        res["top"] = prof["top"]
        res["kernel_kinds_ms_per_step"] = prof["kernel_ms_per_step"]
    with FlopCounterMode(display=False) as fc:
        model.train_batch([batches[0][0]], [batches[0][1]])
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    res["flops_per_step"] = flops
    res["mfu"] = flops / (step_ms / 1e3) / RESNET_PEAK
    res["mfu_peak"] = PEAK_NAME
    log(f"[vision resnet50] {json.dumps(res)}")
    del model, batches, data
    return res


def _resnet_step_state(paddle, device, dtype, state, x, y):
    """One train-mode step of ResNet-50 (no AMP) on ``device`` in
    ``dtype`` from ``state``: the loss, every gradient's norm and the BN
    buffers after it, on the host in float64."""
    with paddle.device.device_scope(device):
        paddle.seed(0)
        net = paddle.vision.models.resnet50()
    net.set_state_dict(state)
    net.to(device=device, dtype=dtype)
    net.train()
    xt = torch.from_numpy(x).to(device, dtype)
    loss = paddle.nn.functional.cross_entropy(
        net(xt), torch.from_numpy(y).to(device))
    loss.backward()
    norms = {k: float(p.grad.double().norm()) for k, p in
             net.named_parameters()}
    bufs = {k: b.double().cpu().numpy() for k, b in net.named_buffers()}
    return float(loss.detach()), norms, bufs


def _vision_cpu_vs_card(paddle):
    """(d) One ResNet-50 step at b2, 64^2 on the card and on the port's
    CPU path, from the same weights and batch, in f32 and f64."""
    with paddle.device.device_scope("cpu"):
        paddle.seed(0)
        state = {k: v.clone() for k, v in
                 paddle.vision.models.resnet50().state_dict().items()}
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 1000, 2)
    res = {}
    for dt in (torch.float64, torch.float32):
        tol = VISION_STEP_TOL[dt]
        lc, nc, bc = _resnet_step_state(paddle, "cuda", dt, state, x, y)
        lh, nh, bh = _resnet_step_state(paddle, "cpu", dt, state, x, y)
        loss_err = abs(lc - lh) / abs(lh)
        grad_err = max(abs(nc[k] - nh[k]) / max(nh[k], 1e-30) for k in nh)
        stat_err = max(float(np.linalg.norm(bc[k] - bh[k])
                             / max(np.linalg.norm(bh[k]), 1e-30))
                       for k in bh)
        tag = str(dt).split(".")[-1]
        res[tag] = {"loss_card": lc, "loss_cpu": lh, "loss_rel": loss_err,
                    "grad_norm_rel_max": grad_err, "bn_stat_rel_max": stat_err,
                    "limits": tol}
        check(loss_err <= tol["loss"] and grad_err <= tol["grad_norm"]
              and stat_err <= tol["stat"],
              f"ResNet-50 {tag} card vs CPU: {res[tag]}")
    log(f"[vision cpu vs card] {json.dumps(res)}")
    return res


def _gelu_special_values():
    """(e) gelu and gelu(approximate=True) at +inf, -inf, nan, 0, -0.0 in
    tensors of 1 and 64 elements, f32 and bf16, on the card: the port's
    op must give jax.nn.gelu's values (inf, nan, nan, 0, -0.0); torch's
    own F.gelu is read beside it (ROADMAP Queue 3 C7)."""
    import paddle_tpu_torch as paddle
    special = torch.tensor([math.inf, -math.inf, math.nan, 0.0, -0.0])
    want = torch.tensor([math.inf, math.nan, math.nan, 0.0, -0.0])
    res = {}
    for n in (1, 64):
        for dt in (torch.float32, torch.bfloat16):
            for approx in (False, True):
                x = special[:1] if n == 1 else special.repeat(13)[:64]
                w = want[:1] if n == 1 else want.repeat(13)[:64]
                x = x.to("cuda", dt)
                got = paddle.nn.functional.gelu(x, approximate=approx)
                raw = torch.nn.functional.gelu(
                    x, approximate="tanh" if approx else "none")
                got, raw = got.float().cpu(), raw.float().cpu()
                key = f"n{n}_{str(dt).split('.')[-1]}" \
                      f"{'_tanh' if approx else ''}"
                res[key] = {"port": [str(v) for v in got[:5].tolist()],
                            "torch": [str(v) for v in raw[:5].tolist()]}
                same = torch.equal(torch.isnan(got), torch.isnan(w)) and \
                    torch.equal(got[~torch.isnan(w)], w[~torch.isnan(w)]) \
                    and torch.equal(torch.signbit(got[~torch.isnan(w)]),
                                    torch.signbit(w[~torch.isnan(w)]))
                check(same, f"gelu {key} on the card: {got[:5].tolist()}, "
                            f"jax.nn.gelu gives {w[:5].tolist()}")
    log(f"[vision gelu] {json.dumps(res)}")
    return res


def phase_vision(card=None):
    """Phase 20: vision and conv. (a) the conv ops on the card against a
    float64 numpy oracle; (b) LeNet through Model.fit on the synthetic
    MNIST; (c) ResNet-50 in bench_resnet's recipe through Model.fit, bf16
    O2; (d) one ResNet-50 step, card against CPU; (e) gelu's special
    values. None of the eight kernels lies on this path: every launch
    count must stay 0 over the phase."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import cuda as kernels
    paddle.set_device("gpu")
    kernels.reset_launch_counts()
    res = {"conv_oracle": phase_conv_oracle(),
           "lenet": _vision_lenet(paddle, card),
           "resnet50": _vision_resnet(paddle, card),
           "resnet50_cpu_vs_card": _vision_cpu_vs_card(paddle),
           "gelu": _gelu_special_values()}
    counts = kernels.launch_counts()
    res["kernel_launches"] = counts
    check(not any(counts.values()), f"phase 20 launched kernels: {counts}")
    return res


def _native_bn_forward(self, x):
    """A BatchNorm layer's forward on torch's fused kernel (cuDNN on the
    card) in f32, as the port's composite runs under O2: a measurement of
    the composite's cost only, since its running variance is unbiased."""
    return torch.nn.functional.batch_norm(
        x.float(), self._mean, self._variance, self.weight.float(),
        self.bias.float(), self.training and not self._use_global_stats,
        1 - self._momentum, self._epsilon)


def vision_probes(steps=20, timed=10, profiled=5):
    """Open questions of phase 20(c), measured and not enacted: ResNet-50's
    bf16 O2 ``Model.fit`` step (b64, 224^2, bench_resnet's data) as the
    port runs it, with cuDNN's algorithm search on
    (``cudnn.benchmark``), with the network and images in channels_last,
    and with BN on torch's fused kernel in place of the composite; in
    turns, the default first and last. Step ms over the last ``timed`` of
    ``steps``, busy over ``profiled`` more; one line of JSON."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn.layer import norm
    paddle.set_device("gpu")
    rng = np.random.RandomState(0)
    batches = [[torch.from_numpy(rng.randn(64, 3, 224, 224).astype(
        np.float32)).to("cuda", torch.bfloat16),
        torch.from_numpy(rng.randint(0, 1000, 64)).to("cuda")]
        for _ in range(8)]
    plain_forward = norm._BatchNormBase.forward

    @contextlib.contextmanager
    def variant(name):
        norm._BatchNormBase.forward = _native_bn_forward \
            if name == "native_bn" else plain_forward
        torch.backends.cudnn.benchmark = name == "cudnn_benchmark"
        try:
            yield
        finally:
            norm._BatchNormBase.forward = plain_forward
            torch.backends.cudnn.benchmark = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    out = {"card": card, "steps": steps, "timed": timed, "runs": []}
    for name in ("default", "cudnn_benchmark", "channels_last", "native_bn",
                 "default"):
        with variant(name):
            model = _resnet_model(paddle)
            data = [batches[i % 8] for i in range(steps)]
            if name == "channels_last":
                model.network.to(memory_format=torch.channels_last)
                data = [[x.contiguous(memory_format=torch.channels_last), y]
                        for x, y in data]
            clock = _fit_clock(start=steps - timed)
            model.fit(data, epochs=1, verbose=0, callbacks=[clock])
            prof = _profile_steps(lambda: model.fit(
                data[:profiled], epochs=1, verbose=0), n=1,
                steps_per_call=profiled, named=RESNET_KERNEL_KINDS)
            losses = [float(v) for v in clock.losses]
            run = {"variant": name, "step_ms": clock.step_ms(),
                   "loss_first": losses[0], "loss_last": losses[-1]}
            if prof is not None:
                run["device_busy_ms_per_step"] = \
                    prof["device_busy_ms_per_step"]
                run["kernel_kinds_ms_per_step"] = prof["kernel_ms_per_step"]
            out["runs"].append(run)
            log(f"[vision probe] {json.dumps(run)}")
            del model, data
    print(json.dumps(out))
    return out


def compare(parent, runs=("parent", "change", "change", "parent") * 2):
    """Phases 8 and 15 of the checkout at ``parent`` and of this one, each
    run in a fresh process, in the order ``runs``: the step ms of each
    (and phase 8's forward + backward and optimizer host ms), printed as
    one JSON line."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import chip_smoke as c; c.setup(); c.phase_build(); "
            "c.phase_flagship(); c.phase_o2_f16()")
    out = []
    for tag in runs:
        cwd = parent if tag == "parent" else here
        proc = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                              capture_output=True, text=True, timeout=900)
        rec = {"tree": tag, "exit": proc.returncode}
        for line in proc.stdout.splitlines():
            for key, tagname in (("[flagship] ", "phase8_bf16"),
                                 ("[o2 f16] ", "phase15_f16_o2")):
                if line.startswith(key):
                    rec[f"{tagname}_step_ms"] = json.loads(
                        line[len(key):])["step_ms"]
            for key, tagname in (("[flagship breakdown] ", "phase8_bf16"),
                                 ("[o2 f16 breakdown] ", "phase15_f16_o2")):
                if line.startswith(key):
                    bd = json.loads(line[len(key):])
                    rec[f"{tagname}_busy_ms"] = bd.get(
                        "device_busy_ms_per_step")
                    for k in ("fwd_bwd_ms", "optimizer_host_ms"):
                        if k in bd:
                            rec[f"{tagname}_{k}"] = bd[k]
        log(f"[compare] {json.dumps(rec)}")
        check(proc.returncode == 0, f"{tag} run failed: "
                                    f"{proc.stderr[-2000:]}")
        out.append(rec)
    print(json.dumps({"compare": out}))
    return 0


def compare_serve(parent, runs=("parent", "change", "change", "parent")):
    """Phase 4's bf16 serve run (``phase_serve_bf16``: the continuous-
    batching run and its profiled decode steps) of the checkout at
    ``parent`` and of this one, each in a fresh process, in the order
    ``runs``: the decode step's wall and busy ms, tokens/s and TTFT,
    printed as one JSON line."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import chip_smoke as c; c.setup(); c.phase_build(); "
            "c.phase_serve_bf16()")
    out = []
    for tag in runs:
        cwd = parent if tag == "parent" else here
        proc = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                              capture_output=True, text=True, timeout=900)
        rec = {"tree": tag, "exit": proc.returncode}
        for line in proc.stdout.splitlines():
            if line.startswith("[serve bf16] "):
                r = json.loads(line[len("[serve bf16] "):])
                prof = r.get("decode_profile") or {}
                rec.update({
                    "decode_step_wall_ms": prof.get("wall_ms_per_step"),
                    "decode_step_busy_ms": prof.get(
                        "device_busy_ms_per_step"),
                    "paged_kernel_ms_per_step": prof.get(
                        "paged_kernel_ms_per_step"),
                    "tokens_per_s": r["tokens_per_s"],
                    "ttft_ms_p50": r["ttft_ms_p50"],
                    "ttft_ms_p99": r["ttft_ms_p99"]})
        log(f"[compare serve] {json.dumps(rec)}")
        check(proc.returncode == 0, f"{tag} run failed: "
                                    f"{proc.stderr[-2000:]}")
        out.append(rec)
    print(json.dumps({"compare_serve": out}))
    return 0


def host_attribution(steps=20, profiled=10):
    """Phase 8's step taken apart on the host, for whichever
    ``paddle_tpu_torch`` is first on ``sys.path``: the host ms of the
    forward, the backward, the zero grads, ``opt.step()`` and
    ``opt.clear_grad()``, each between two synchronizes (medians over
    ``steps`` steps); then cProfile over ``profiled`` plain steps: Python
    calls a step and the functions with the most own time."""
    import cProfile
    import pstats
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig.bert_base()
    ids, lab = _bert_batches(cfg, 32, 128, 16)
    net = Bert(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.train()
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=net.named_parameters(), multi_precision=True)
    for i in range(5):
        _train_step(net, opt, ids[i], lab[i])
    parts = {k: [] for k in ("forward", "backward", "zero_missing_grads",
                             "opt_step", "clear_grad")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        parts[name].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return out

    for i in range(steps):
        j = i % 16
        loss = timed("forward", lambda: net(ids[j], masked_lm_labels=lab[j]))
        timed("backward", loss.backward)
        timed("zero_missing_grads", lambda: _zero_missing_grads(net))
        timed("opt_step", opt.step)
        timed("clear_grad", opt.clear_grad)
    out = {f"{k}_host_ms": statistics.median(v) for k, v in parts.items()}
    prof = cProfile.Profile()
    prof.enable()
    for i in range(profiled):
        _train_step(net, opt, ids[i % 16], lab[i % 16])
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    out["python_calls_per_step"] = stats.total_calls / profiled
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    out["top_own_ms_per_step"] = [
        [f"{os.path.basename(k[0])}:{k[2]}", v[2] / profiled * 1e3]
        for k, v in rows]
    log(f"[attribution] {json.dumps(out)}")
    return out


def attribute(parent, runs=("parent", "change", "change", "parent")):
    """``host_attribution`` of this script over the package of the
    checkout at ``parent`` and over this one, each in a fresh process, in
    the order ``runs``."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, importlib.util, torch; sys.path.insert(0, {tree!r});"
            " spec = importlib.util.spec_from_file_location('cs', {me!r});"
            " c = importlib.util.module_from_spec(spec);"
            " spec.loader.exec_module(c);"
            " torch.backends.cuda.matmul.allow_tf32 = False;"
            " c.phase_build(); c.host_attribution()")
    for tag in runs:
        tree = parent if tag == "parent" else here
        proc = subprocess.run(
            [sys.executable, "-c", code.format(
                tree=tree, me=os.path.join(here, "chip_smoke.py"))],
            cwd=tree, capture_output=True, text=True, timeout=900)
        said = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("[attribution] ")]
        log(f"[attribute] {tag} exit {proc.returncode} "
            f"{said[-1][len('[attribution] '):] if said else ''}")
        check(proc.returncode == 0 and said, f"{tag} attribution failed: "
                                              f"{proc.stderr[-2000:]}")
    return 0


# --------------------------------------------------------------------------
# phases 11-12: GPT-2 small training through the flash kernels
# --------------------------------------------------------------------------

def _lm_batch(vocab, batch, seq, seed=0):
    """bench.py:bench_longseq's batch: ids from RandomState(seed) in
    [4, vocab), labels the ids rolled by -1 (every row valid)."""
    ids = np.random.RandomState(seed).randint(4, vocab, (batch, seq))
    return (torch.from_numpy(ids).to("cuda"),
            torch.from_numpy(np.roll(ids, -1, axis=1)).to("cuda"))


def _flash_flags(use):
    """Attention on the flash kernels (use) or the composite, at any s."""
    from paddle_tpu_torch.core import flags
    flags.set_flags({"FLAGS_use_flash_attention": use,
                     "FLAGS_flash_min_seq": 0})


@contextlib.contextmanager
def _flash_flags_kept():
    """Restore the two flash flags on leaving."""
    from paddle_tpu_torch.core import flags
    names = ("FLAGS_use_flash_attention", "FLAGS_flash_min_seq")
    saved = {n: flags.flag(n) for n in names}
    try:
        yield
    finally:
        flags.set_flags(saved)


def phase_gpt_equivalence():
    """One f32 AdamW step of GPT-2 small (b 1, s 1024) through the flash
    kernels and one with FLAGS_use_flash_attention off, from the same
    weights on the same batch: the losses, every parameter's gradient and
    the parameters after the step."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(dropout=0.0)
    ids, labels = _lm_batch(cfg.vocab_size, 1, 1024, seed=1)
    out = {}
    with _flash_flags_kept():
        for use in (True, False):
            _flash_flags(use)
            net = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
            net.train()
            opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                        parameters=net.named_parameters())
            before = kernels.launch_counts()
            loss = net(ids, labels=labels)
            loss.backward()
            grads = {k: None if p.grad is None else p.grad.detach().clone()
                     for k, p in net.named_parameters()}
            _zero_missing_grads(net)
            opt.step()
            opt.clear_grad()
            used = {k: kernels.launch_counts()[k] - before[k]
                    for k in FLASH_KERNELS}
            check(set(used.values()) == {cfg.num_layers if use else 0},
                  f"flag did not route attention: {used}")
            out[use] = (float(loss.detach()), grads,
                        {k: p.detach().clone()
                         for k, p in net.named_parameters()})
            del net, opt
    (lk, gk, pk), (lp, gp, pp) = out[True], out[False]
    rel = abs(lk - lp) / abs(lp)
    dgrad = {k: _grad_rel(gk[k], gp[k]) for k in gk}
    worst = max(dgrad, key=dgrad.get)
    dparam = max(float((pk[k] - pp[k]).abs().max()) for k in pk)
    log(f"[gpt f32 equivalence] b1 s1024: loss flash {lk:.7f} composite "
        f"{lp:.7f} (rel {rel:.2e}, tol {GPT_STEP_TOL['loss']:g}); gradients "
        f"largest rel diff {dgrad[worst]:.2e} ({worst}; tol "
        f"{GPT_STEP_TOL['grad']:g}), qkv of block 0 "
        f"{dgrad['blocks.0.attn.qkv_proj.weight']:.2e}; params after one "
        f"AdamW step max abs diff {dparam:.2e} (tol "
        f"{GPT_STEP_TOL['param']:g}) over {len(pk)} tensors")
    check(np.isfinite(lk), "GPT loss not finite")
    check(rel <= GPT_STEP_TOL["loss"], f"GPT loss differs: {rel}")
    check(dgrad[worst] <= GPT_STEP_TOL["grad"],
          f"GPT gradient {worst} differs: {dgrad[worst]}")
    check(dparam <= GPT_STEP_TOL["param"],
          "GPT parameters differ after a step")
    return {"loss_flash": lk, "loss_composite": lp, "loss_rel_diff": rel,
            "grad_max_rel_diff": dgrad[worst], "grad_worst": worst,
            "param_max_abs_diff": dparam}


def _longseq_run(cfg, ids, labels, use_flash, warmup, steps):
    """bench_longseq's step (bf16 params, f32 master weights and moments)
    with flash on or off: (result, the step closure)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPT
    _flash_flags(use_flash)
    net = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.train()
    opt = AdamW(learning_rate=1e-4, parameters=net.named_parameters(),
                multi_precision=True)

    def step():
        return _train_step_lm(net, opt, ids, labels)

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step()
        if i in (0, steps - 1):
            losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"step_ms": dt * 1e3 / steps,
            "loss_start": float(losses[0]), "loss_end": float(losses[1]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params": sum(p.numel() for p in net.parameters())}, step


def _train_step_lm(net, opt, ids, labels):
    loss = net(ids, labels=labels)
    loss.backward()
    _zero_missing_grads(net)
    opt.step()
    opt.clear_grad()
    return loss.detach()


def phase_longseq():
    """The long-sequence training path: bench.py:bench_longseq at GPT-2
    small, b 1, s 4096, bf16, flash on (the kernels) and then off."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models.gpt import GPTConfig
    batch, seq, warmup, steps = 1, 4096, 2, 15
    cfg = GPTConfig(max_seq_len=seq, dropout=0.0)
    ids, labels = _lm_batch(cfg.vocab_size, batch, seq)
    ce_fwd = ("ce_sm90_fwd", "ce_fwd_")
    ce_bwd = ("compact_rows_kernel", "ce_sm90_gather", "ce_sm90_chunk",
              "ce_sm90_dh_reduce", "ce_bwd_dh_kernel",
              "ce_dh_reduce_kernel", "ce_bwd_dw_kernel")
    named = FLASH_KERNELS + ce_fwd + ce_bwd

    with _flash_flags_kept():
        kernels.reset_launch_counts()
        t_path = time.perf_counter()
        res, step = _longseq_run(cfg, ids, labels, True, warmup, steps)
        counts = kernels.launch_counts()
        log(f"[longseq path] {time.perf_counter() - t_path:.1f} s; kernel "
            f"launches {counts}")
        for k in FLASH_KERNELS + SM90_COUNTS:
            check(counts[k] == cfg.num_layers * (warmup + steps),
                  f"{k} launched {counts[k]} times on the long-sequence "
                  f"path, not {cfg.num_layers * (warmup + steps)}")
        for k in CE_KERNELS:
            check(counts[k] > 0, f"{k} never launched on the path")
        for k in CE_SM90_COUNTS:
            check(counts[k] == counts[k[:-5]], f"{k} launched {counts[k]} "
                                               f"of {counts[k[:-5]]} times")
        try:   # the time breakdown, after the counts are read
            prof = _profile_steps(step, named=named)
        except Exception as e:   # the measurement is optional, the path not
            prof = None
            log(f"[longseq profile] not measured: {type(e).__name__}: {e}")
        del step
        comp, step = _longseq_run(cfg, ids, labels, False, warmup, steps)
        del step
    tokens = batch * seq
    L, H = cfg.num_layers, cfg.hidden_size
    flops = 6 * res["params"] * tokens + 6 * L * H * seq * tokens
    res.update({"config": "gpt2_small_longseq", "dtype": "bfloat16",
                "batch": batch, "seq": seq, "warmup": warmup, "steps": steps,
                "tokens_per_s": tokens / res["step_ms"] * 1e3,
                "mfu": flops / (res["step_ms"] / 1e3)
                / PEAK_FLOPS[torch.bfloat16],
                "mfu_peak": PEAK_NAME,
                "step_ms_composite": comp["step_ms"],
                "vs_baseline": comp["step_ms"] / res["step_ms"],
                "composite_loss_start": comp["loss_start"],
                "composite_loss_end": comp["loss_end"],
                "composite_peak_mem_gb": comp["peak_mem_gb"],
                "launches": {k: counts[k] for k in
                             FLASH_KERNELS + SM90_COUNTS + CE_KERNELS
                             + CE_SM90_COUNTS}})
    if prof is not None:
        res["breakdown"] = prof
        res["breakdown"]["device_idle_share"] = \
            1 - prof["device_busy_ms_per_step"] / res["step_ms"]
        # the CE forward (either source, its combine too); the CE
        # backward: the valid-row list and every backward kernel
        res["breakdown"]["ce_forward_ms_per_step"] = sum(
            prof["kernel_ms_per_step"][k] for k in ce_fwd)
        res["breakdown"]["ce_backward_ms_per_step"] = sum(
            prof["kernel_ms_per_step"][k] for k in ce_bwd)
    log(f"[longseq] {json.dumps(res)}")
    check(np.isfinite(res["loss_start"]) and np.isfinite(res["loss_end"]),
          "non-finite loss")
    check(res["loss_end"] < res["loss_start"], "loss did not fall")
    return counts, res


# --------------------------------------------------------------------------
# phase 13: flash timings and the FLAGS_flash_min_seq sweep
# --------------------------------------------------------------------------

def _live_pairs(sq, sk, causal):
    """(row, key) pairs the causal mask leaves (all without it)."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(max(0, min(sk, r + off + 1)) for r in range(sq))


def flash_bound(kernel, bh, sq, sk, d, dt, causal, bias_rows=0):
    """Least time: inputs read once and outputs written once over the HBM
    rate, or the products' flops over the peak of the input type (the
    forward 2 products, dq 3 with the recompute, dk/dv 4; causal counts
    the live pairs only). ``bias_rows``: rows of an f32 key bias."""
    el = torch.finfo(dt).bits // 8
    qkv = (bh * sq * d + 2 * bh * sk * d) * el + bias_rows * sk * 4
    if kernel == "flash_fwd":
        nbytes = qkv + bh * sq * d * el + bh * sq * 4         # + o, lse
        products = 2
    elif kernel == "flash_bwd_dq":
        nbytes = qkv + 2 * bh * sq * d * el + 2 * bh * sq * 4  # dO, dq
        products = 3
    else:
        nbytes = qkv + bh * sq * d * el + 2 * bh * sq * 4 \
            + 2 * bh * sk * d * el                             # dk, dv
        products = 4
    flops = 2 * products * bh * d * _live_pairs(sq, sk, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


@contextlib.contextmanager
def _other_source(module="flash_attention", gate="_sm90_path"):
    """Inside: the wrappers of ops/cuda/<module> send every call to the
    kernels of the older source (their Hopper ``gate`` says no), so those
    are timed on the inputs that the Hopper kernels take outside (a
    yardstick; phases 6 and 10 check that route on f32 and other shapes)."""
    import importlib
    mod = importlib.import_module(f"paddle_tpu_torch.ops.cuda.{module}")
    saved = getattr(mod, gate)
    setattr(mod, gate, lambda *args: False)
    try:
        yield
    finally:
        setattr(mod, gate, saved)


def _flash_time_shape(b, h, s, d, causal, bias, dt=torch.bfloat16):
    """The three kernels at one shape: time, bound, plain version, SDPA
    (forward; its autograd backward w.r.t. q alone, k and v alone, and all
    three), and flash_attention.cu's forward and dk/dv on the same inputs."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import (flash_bwd_dkv, flash_bwd_dq,
                                           flash_fwd, flash_fwd_ref)
    from paddle_tpu_torch.ops.cuda.flash_attention import _bwd_ref, flash_delta
    gen = torch.Generator().manual_seed(12)
    q, k, v, bb, do = _flash_inputs(b * h, b, s, s, d, dt, bias, gen)
    where = f"b{b} h{h} s{s} d{d} {str(dt)[6:]} causal={causal} bias={bias}"
    errs = flash_errors(q, k, v, bb, causal, do, where, repeat=True)
    log(f"[flash timing] errors at {where}: {_flash_line(errs)}")
    o, lse = flash_fwd(q, k, v, bb, causal)
    delta = flash_delta(o, do)
    scale = d ** -0.5
    q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q, k, v, do))
    mask = None if bb is None else bb.to(dt)[:, None, None, :]
    ql, kl, vl = (t.detach().requires_grad_() for t in (q4, k4, v4))
    lib_out = tF.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                              is_causal=causal)

    def lib_grad(wrt):
        return lambda: torch.autograd.grad(lib_out, wrt, grad_outputs=do4,
                                           retain_graph=True)

    timed = {
        "flash_fwd": (lambda: flash_fwd(q, k, v, bb, causal),
                      lambda: flash_fwd_ref(q, k, v, bb, causal),
                      lambda: tF.scaled_dot_product_attention(
                          q4, k4, v4, attn_mask=mask, is_causal=causal)),
        "flash_bwd_dq": (lambda: flash_bwd_dq(q, k, v, bb, do, lse, delta,
                                              causal),
                         lambda: _bwd_ref(q, k, v, bb, do, lse, delta,
                                          causal, scale, need_dkv=False),
                         lib_grad((ql,))),
        "flash_bwd_dkv": (lambda: flash_bwd_dkv(q, k, v, bb, do, lse,
                                                delta, causal),
                          lambda: _bwd_ref(q, k, v, bb, do, lse, delta,
                                           causal, scale, need_dq=False),
                          lib_grad((kl, vl))),
    }
    out = {}
    for name, (kern, plain, lib) in timed.items():
        bnd, by = flash_bound(name, b * h, s, s, d, dt, causal,
                              bias_rows=b if bias else 0)
        out[name] = {"ms": time_ms(kern, runs=20),
                     "plain_ms": time_ms(plain, runs=5, warmup=1),
                     "library_ms": time_ms(lib, runs=20),
                     "bound_ms": bnd, "bound_by": by,
                     "max_abs_err": errs[name],
                     "b": b, "h": h, "s": s, "d": d, "causal": causal,
                     "bias": bias}
        if name in OTHER_SOURCE:
            with _other_source():
                out[name]["other_kernel_ms"] = time_ms(kern, runs=20)
        r = out[name]
        log(f"[flash timing] {name} {where}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f", flash_attention.cu {r['other_kernel_ms']:.4f} ms"
               if "other_kernel_ms" in r else ""))
    # SDPA's whole backward (dq, dk, dv in one call) against dq + dk/dv
    runs = 60
    lib_all = time_samples(lib_grad((ql, kl, vl)), runs=runs)
    ours = time_samples(lambda: (
        flash_bwd_dq(q, k, v, bb, do, lse, delta, causal),
        flash_bwd_dkv(q, k, v, bb, do, lse, delta, causal)), runs=runs)
    out["whole_backward"] = {
        "runs": runs, "sdpa_ms": statistics.median(lib_all),
        "sdpa_min_ms": min(lib_all), "sdpa_max_ms": max(lib_all),
        "kernels_ms": statistics.median(ours), "kernels_min_ms": min(ours),
        "kernels_max_ms": max(ours)}
    log(f"[flash timing] whole backward {where}: "
        f"{json.dumps(out['whole_backward'])}")
    return out


def _sweep_ms(route, b, h, s, d, causal, gen):
    """Forward + backward of attention at [b, h, s, d] bf16 through the
    flash kernels or the composite, under autograd."""
    from paddle_tpu_torch.nn.functional import _sdpa
    from paddle_tpu_torch.ops.cuda import flash_attention
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen)
                   .to("cuda", torch.bfloat16) for _ in range(4))
    ql, kl, vl = (t.requires_grad_() for t in (q, k, v))
    scale = d ** -0.5

    def run():
        if route == "flash":
            out = flash_attention(ql, kl, vl, causal=causal, scale=scale)
        else:
            out = _sdpa(ql, kl, vl, None, scale, causal)
        torch.autograd.grad(out, (ql, kl, vl), grad_outputs=do)

    return time_ms(run, runs=10, warmup=2)


def phase_flash_timings():
    timing = {
        "longseq": _flash_time_shape(1, 12, 4096, 64, causal=True,
                                     bias=False),
        "flagship": _flash_time_shape(32, 12, 128, 64, causal=False,
                                      bias=True)}
    gen = torch.Generator().manual_seed(13)
    tokens, h, d = 16384, 12, 64
    rows = []
    for causal in (False, True):
        for s in (128, 256, 512, 1024, 2048, 4096):
            b = tokens // s
            # turns: composite, flash, flash, composite
            c1 = _sweep_ms("composite", b, h, s, d, causal, gen)
            f1 = _sweep_ms("flash", b, h, s, d, causal, gen)
            f2 = _sweep_ms("flash", b, h, s, d, causal, gen)
            c2 = _sweep_ms("composite", b, h, s, d, causal, gen)
            row = {"s": s, "b": b, "causal": causal,
                   "flash_ms": min(f1, f2), "composite_ms": min(c1, c2)}
            rows.append(row)
            log(f"[min_seq sweep] {json.dumps(row)}")
    # the smallest s from which the kernels are no slower, causal and not,
    # at that s and every larger one
    wins = {s: all(r["flash_ms"] <= r["composite_ms"] for r in rows
                   if r["s"] >= s) for s in sorted({r["s"] for r in rows})}
    measured = min((s for s, w in wins.items() if w), default=4096)
    from paddle_tpu_torch.core import flags
    default = flags.flag("FLAGS_flash_min_seq")
    log(f"[min_seq sweep] measured FLAGS_flash_min_seq {measured}; the "
        f"port's default {default}")
    return timing, {"rows": rows, "min_seq_measured": measured,
                    "min_seq_default": default}


# --------------------------------------------------------------------------
# phase 21: generation and serving, the rest
# --------------------------------------------------------------------------

GEN_BATCH, GEN_PROMPT, GEN_BEAM, GEN_NEW = 8, 32, 4, 32
# 21(b)'s new tokens: export_decode unrolls every decode step into the
# graph, so its export and load grow with them (111 s and 36 s at 32 on
# an H100 80GB HBM3 at 700 W, in a whole run past the script's budget);
# 8 keeps the same checks (16 until phase 26 needed the time)
EXPORT_NEW = 8
# beam scores against an uncached forward of each path (the sum of the
# chosen tokens' log-probs over GEN_NEW tokens): f32 2e-3, the cached
# split-K decode kernel against the uncached composite attention (the
# CPU's f32 readings are ~1e-5 at 8 tokens); bf16 0.05 a token, the
# logits' bf16 rounding (2^-8 of values ~10) on two attention paths. A
# cache reordered by the token in place of the parent beam (the planted
# beam fault) moved f32 sums by ~1 on the CPU at 8 tokens.
BEAM_SCORE_TOL = {torch.float32: 2e-3, torch.bfloat16: 0.05 * GEN_NEW}
STALL_S = 0.2
TRAFFIC_RATE, TRAFFIC_SECONDS = 30.0, 6.0
BLOCK_TABLE = ".scratch/block_size_table.json"    # listed in .gitignore
BLOCK_L, BLOCK_H, BLOCK_D, BLOCK_BATCH = 1024, 12, 64, 64


class _BeamCell:
    """GPT over StaticKVCache states for BeamSearchDecoder: the first call
    returns the prompts' last logits tiled over the beams and runs no
    pass; each later call is one cached one-token pass at the fill."""

    def __init__(self, net, first):
        self.net, self.first = net, first

    def __call__(self, inputs, states):
        if self.first is not None:
            lg = self.first.repeat_interleave(
                inputs.shape[0] // self.first.shape[0], 0)
            self.first = None
            return lg, states
        return self.net._forward_cached(inputs[:, None], states,
                                        states[0].index)


def _gen_prompts(seed=0):
    ids = np.random.RandomState(seed).randint(1, 50257,
                                              (GEN_BATCH, GEN_PROMPT))
    return torch.from_numpy(ids).to("cuda")


def _beam_search(net, ids, beam, new):
    """Beam search from each prompt's last logits; the decode launches of
    the steps alone (the prefill's are not counted)."""
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    from paddle_tpu_torch.ops import cuda as kernels
    b, p = ids.shape
    caches = [blk.attn.gen_static_cache(b, p + new, net.dtype)
              for blk in net.blocks]
    with torch.no_grad():
        lg, caches = net._forward_cached(ids, caches, 0)
    dec = BeamSearchDecoder(_BeamCell(net, lg), start_token=0, end_token=-1,
                            beam_size=beam)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (paths, scores), _ = dynamic_decode(dec, caches, max_step_num=new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return paths.numpy(), scores.numpy(), dt, kernels.launch_counts()


def _beam_score_error(net, ids, paths, scores):
    """Largest |beam score - the sum of its tokens' log-probs from one
    uncached forward of prompt + path|."""
    b, k, t = paths.shape
    p = ids.shape[1]
    full = torch.cat([ids.repeat_interleave(k, 0),
                      torch.from_numpy(paths.reshape(b * k, t)).to("cuda")],
                     1)
    with torch.no_grad():
        logp = torch.log_softmax(net(full).float(), -1)
    picked = logp[:, p - 1:p - 1 + t].gather(-1, full[:, p:, None])[..., 0]
    return float(np.abs(picked.sum(-1).cpu().numpy().reshape(b, k)
                        - scores).max())


def _greedy_rule(net, ids, got, ref, what, tie):
    """Phase 4's rule: tokens equal, or equal up to a first divergence
    where the top-2 logit gap is below ``tie``; [(row, position, gap)]."""
    ties = []
    for i in range(got.shape[0]):
        diff = np.nonzero(got[i] != ref[i])[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        prefix = np.concatenate([ids[i].cpu().numpy(), ref[i, :j]])
        gap = _top2_gap(net, prefix)
        log(f"[{what}] row {i} diverges at token {j}: {got[i, j]} vs "
            f"{ref[i, j]}, top-2 logit gap {gap:.3e}")
        check(gap < tie, f"{what}: divergence without a near-tie")
        ties.append((i, j, gap))
    return ties


def phase_beam_scores(net=None, ids=None):
    """21(a)'s f32 checks on GPT-2 small: beam 1 equals greedy generate
    (phase 4's near-tie rule) and the beam-4 scores equal an uncached
    forward of each path within BEAM_SCORE_TOL; the second fails when
    the cache is not reordered by parent beam."""
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    if net is None:
        net = GPT(GPTConfig(), device="cuda", dtype=torch.float32, seed=0)
        net.eval()
    ids = _gen_prompts() if ids is None else ids
    p1, _, _, _ = _beam_search(net, ids, 1, GEN_NEW)
    ref = net.generate(ids, max_new_tokens=GEN_NEW,
                       temperature=0)[:, GEN_PROMPT:].cpu().numpy()
    ties = _greedy_rule(net, ids, p1[:, 0], ref, "beam f32", 1e-4)
    p4, s4, _, _ = _beam_search(net, ids, GEN_BEAM, GEN_NEW)
    err = _beam_score_error(net, ids, p4, s4)
    log(f"[beam f32] beam 1 = greedy generate on {GEN_BATCH - len(ties)}"
        f"/{GEN_BATCH} rows, near-ties {ties}; beam {GEN_BEAM} score error "
        f"{err:.3e} (tol {BEAM_SCORE_TOL[torch.float32]:g})")
    check(err <= BEAM_SCORE_TOL[torch.float32],
          f"beam scores disagree with an uncached forward: {err}")
    return {"beam1_near_ties": ties, "beam4_score_err_f32": err}


def _gen_beam(net, net32):
    """21(a): bf16 beam search, b 8 x beam 4 from prompts of 32, 32 steps,
    then phase_beam_scores in f32."""
    ids = _gen_prompts()
    _beam_search(net, ids[:2], GEN_BEAM, 3)                 # warm-up
    paths, scores, dt, counts = _beam_search(net, ids, GEN_BEAM, GEN_NEW)
    passes = GEN_NEW - 1          # the first step reuses the prefill
    n = counts["decode_attention"]
    check(n == 12 * passes, f"beam search: {n} decode launches in "
                            f"{passes} passes, not 12 a pass")
    check(counts["decode_attention.sm90"] == n and
          counts["decode_attention.mma"] == 0,
          f"beam steps missed the split-K kernel: {counts}")
    check(counts["paged_decode_attention"] == 0, "paged launches in beam")
    err = _beam_score_error(net, ids, paths, scores)
    res = {"batch": GEN_BATCH, "beam": GEN_BEAM, "prompt": GEN_PROMPT,
           "new": GEN_NEW, "ms_per_step": dt * 1e3 / GEN_NEW,
           "tokens_per_s": GEN_BATCH * GEN_NEW / dt,
           "beam_tokens_per_s": GEN_BATCH * GEN_BEAM * GEN_NEW / dt,
           "decode_launches": n, "decode_launches_per_pass": n / passes,
           "decode_launches_sm90": counts["decode_attention.sm90"],
           "score_err_bf16": err,
           "score_tol_bf16": BEAM_SCORE_TOL[torch.bfloat16]}
    log(f"[beam bf16] {json.dumps(res)}")
    check(np.isfinite(scores).all(), "non-finite beam scores")
    check(err <= BEAM_SCORE_TOL[torch.bfloat16],
          f"bf16 beam scores disagree with an uncached forward: {err}")
    res.update(phase_beam_scores(net32, ids))
    return res, counts


def _gen_export(net):
    """21(b): export_decode of the bf16 GPT-2 (b 8, prompt 32, 16 new),
    create_predictor(...).run, against generate."""
    import tempfile

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models.gpt import export_decode
    ids = _gen_prompts()
    ids32 = ids.to(torch.int32).cpu().numpy()
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "gpt2_decode")
        t0 = time.perf_counter()
        export_decode(net, prefix, GEN_BATCH, GEN_PROMPT, EXPORT_NEW)
        t_export = time.perf_counter() - t0
        size = os.path.getsize(prefix + ".pt2")
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix))
        t_load = time.perf_counter() - t0
        pred.run([ids32, np.int32(0)])                     # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        (toks,) = pred.run([ids32, np.int32(0)])
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
    net.generate(ids[:2], max_new_tokens=2, temperature=0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = net.generate(ids, max_new_tokens=EXPORT_NEW, temperature=0)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    ref = ref[:, GEN_PROMPT:].cpu().numpy()
    n = counts["decode_attention"]
    check(n == 12 * EXPORT_NEW, f"the artifact's run launched {n} decode "
                                f"kernels, not 12 x {EXPORT_NEW}")
    check(counts["paged_decode_attention"] == 0, "paged launches in run")
    # bf16 logits: a divergence passes where the top two are within one
    # bf16 step of each other (2^-7 at the logits' size, ~10)
    ties = _greedy_rule(net, ids, toks.astype(np.int64), ref, "export",
                        0.0625)
    res = {"batch": GEN_BATCH, "prompt": GEN_PROMPT, "new": EXPORT_NEW,
           "export_s": t_export, "load_s": t_load, "pt2_bytes": size,
           "run_ms_per_token": dt * 1e3 / EXPORT_NEW,
           "generate_ms_per_token": dt_gen * 1e3 / EXPORT_NEW,
           "decode_launches_run": n,
           "decode_launches_run_sm90": counts["decode_attention.sm90"],
           "decode_launches_run_mma": counts["decode_attention.mma"],
           "token_identical_rows": GEN_BATCH - len(ties),
           "near_ties": ties}
    log(f"[export] {json.dumps(res)}")
    return res, counts


def _traffic_spec(name, seconds=TRAFFIC_SECONDS):
    """builtin_spec's arrivals (30 requests/s for ``seconds``, 6 s by
    default) and tenant mix, at GPT-2's vocabulary and context, the
    lengths widened to bench_serve's scale: prompts of median 32, 16-64
    new tokens."""
    from paddle_tpu_torch.traffic import workload
    base = workload.builtin_spec(name, rate=TRAFFIC_RATE,
                                 duration_s=seconds)
    tenants = (
        {"name": "chat", "weight": 0.7, "kind": "llm",
         "prompt": {"kind": "lognormal", "median": 32, "sigma": 0.45,
                    "lo": 2, "hi": 128},
         "new": {"kind": "uniform", "lo": 16, "hi": 64}},
        {"name": "recsys", "weight": 0.3, "kind": "hybrid", "lookups": 8,
         "lookup_vocab": 65_536,
         "prompt": {"kind": "lognormal", "median": 27, "sigma": 0.35,
                    "lo": 2, "hi": 96},
         "new": {"kind": "fixed", "value": 32}})
    return workload.WorkloadSpec(name=name, arrival=base.arrival,
                                 duration_s=base.duration_s, tenants=tenants,
                                 vocab=50257, max_seq_len=1024)


def _traffic_line(rep, counts):
    return {"spec": rep.spec, "events": rep.events,
            "completed": rep.completed, "errors": rep.errors,
            "ttft_ms": rep.ttft_ms, "token_ms": rep.token_ms,
            "tokens_per_s": rep.tokens_per_s,
            "throughput_rps": rep.throughput_rps,
            "offered_rps": rep.offered_rps, "wall_s": rep.wall_s,
            "backpressure_waits": rep.backpressure_waits,
            "preempted": rep.preempted,
            "paged_launches": counts["paged_decode_attention"],
            "paged_launches_sm90": counts["paged_decode_attention.sm90"],
            "schedule_digest": rep.schedule_digest[:16],
            "outputs_digest": rep.outputs_digest[:16]}


def _replay(loop, name, seconds=TRAFFIC_SECONDS, **kw):
    """One run_spec of ``name`` through ``loop``, counted and checked:
    nothing failed, every event completed, the schedule is the seed's."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.traffic import harness, workload
    spec = _traffic_spec(name, seconds)
    kernels.reset_launch_counts()
    rep = harness.run_spec(spec, seed=0, loop=loop, **kw)
    counts = kernels.launch_counts()
    check(rep.errors == 0, f"{name}: {rep.errors} requests failed")
    check(rep.completed == rep.events > 0,
          f"{name}: {rep.completed} of {rep.events} completed")
    check(rep.schedule_digest == workload.schedule_digest(
        workload.schedule(spec, 0)), f"{name}: the schedule is not the "
                                     "seed's")
    check(counts["paged_decode_attention"] > 0, f"{name}: no paged launch")
    return rep, counts


def _gen_traffic(net):
    """21(c)-(e): the three arrival shapes through one GPT-2 bf16 ServeLoop
    (max_active 64, the measured block size), the steady replay under
    trace.start(); then the fault seam on the steady replay."""
    import tempfile

    from paddle_tpu_torch.core import monitor, trace
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.testing import faults
    loop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                      max_seq_len=1024))
    res, counts = {"block_size": loop.stats()["block_size"]}, {}
    for name in ("steady", "diurnal", "flash"):
        if name == "steady":
            trace.reset()
            trace.start()
        rep, c = _replay(loop, name)
        counts[name] = c
        res[name] = _traffic_line(rep, c)
        log(f"[traffic] {json.dumps(res[name])}")
        if name == "steady":
            spans = trace.stop()
            ttft_max = monitor.histogram_summary("serve/ttft_ms")["max"]
            with tempfile.TemporaryDirectory() as d:
                path = trace.export_chrome_trace(os.path.join(d, "t.json"),
                                                 spans)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                size = os.path.getsize(path)
            names = {e["name"] for e in events if e["ph"] == "X"}
            flows = [e for e in events if e.get("cat") == "flow"]
            res["chrome_trace"] = {
                "events": len(events), "bytes": size, "spans": len(spans),
                "flow_events": len(flows),
                "threads": sorted({e["args"]["name"] for e in events
                                   if e["ph"] == "M"}),
                "decode_step_slices": sum(1 for e in events
                                          if e["name"] == "serve/decode_step"
                                          and e["ph"] == "X")}
            log(f"[chrome trace] {json.dumps(res['chrome_trace'])}")
            check({"serve/decode_step", "serve/prefill"} <= names,
                  f"the trace lacks serve slices: {sorted(names)}")
            check(flows and {e["ph"] for e in flows} == {"s", "t", "f"},
                  "the trace lacks the request flows")
    # (d) the fault seam: one STALL at ("serve", "beat") on the steady
    # replay (the loop is warm; the stall lands on the run's first beat),
    # then RESETs there, absorbed
    clean = res["steady"]
    with faults.inject(faults.Fault("serve", "beat", faults.STALL,
                                    delay=STALL_S)) as inj:
        rep, c = _replay(loop, "steady", warm=False)
    stall_max = monitor.histogram_summary("serve/ttft_ms")["max"]
    res["stall"] = dict(_traffic_line(rep, c), fired=inj.fired(),
                        stall_ms=STALL_S * 1e3, ttft_max_ms=stall_max,
                        ttft_max_ms_clean=ttft_max,
                        ttft_p99_rise_ms=rep.ttft_ms["p99"]
                        - clean["ttft_ms"]["p99"])
    log(f"[serve fault] {json.dumps(res['stall'])}")
    check(inj.log == [("serve", "beat", "tick", faults.STALL)],
          f"the stall fired {inj.log}")
    check(stall_max >= STALL_S * 1e3, "no request waited out the stall")
    check(rep.ttft_ms["p99"] > clean["ttft_ms"]["p99"],
          "TTFT p99 did not rise under the stall")
    with faults.inject(faults.Fault("serve", "beat", faults.RESET,
                                    times=3)) as inj:
        rep, c = _replay(loop, "steady", warm=False)
    res["reset"] = dict(_traffic_line(rep, c), fired=inj.fired())
    log(f"[serve fault] {json.dumps(res['reset'])}")
    check(inj.fired() == 3, f"the resets fired {inj.log}")
    res["outputs_digest_repeats"] = len({res[k]["outputs_digest"] for k in
                                         ("steady", "stall", "reset")}) == 1
    log(f"[traffic] steady outputs_digest repeats over the three steady "
        f"replays: {res['outputs_digest_repeats']}")
    return res, counts


def _gen_block_size(net):
    """21(f): pick_block_size measures the paged kernel at 256 / 128 / 64
    for h12 d64 bf16 at L 1024 (64 rows, every row's cache full) and
    writes the table to BLOCK_TABLE; then bench_serve's 64 requests
    (prompt 32, 64 new) served at each candidate."""
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.nn.kv_pool import pick_block_size
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda import autotune
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, BLOCK_TABLE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for p in (path, path + ".lock"):
        if os.path.exists(p):
            os.remove(p)
    os.environ["PADDLE_TPU_CUDA_AUTOTUNE_CACHE"] = path
    autotune.clear()
    monitor.reset(prefix="autotune.")
    kernels.reset_launch_counts()
    winner = pick_block_size(BLOCK_L, BLOCK_H, BLOCK_D, torch.bfloat16,
                             BLOCK_BATCH, device="cuda")
    counts = kernels.launch_counts()
    with open(path) as f:
        table = json.load(f)
    key = (f"paged_decode_attention|{BLOCK_L},{BLOCK_D}|bfloat16|"
           f"{torch.cuda.get_device_name(0)}")
    entry = table["entries"][key]
    failed = monitor.stat_get(
        "autotune.failed_candidate.paged_decode_attention")
    res = {"key": key, "winner": winner,
           "candidates_ms": {str(p[0]): t * 1e3
                             for p, t in entry["candidates"]},
           "failed_candidates": failed,
           "measured": monitor.stat_get(
               "autotune.measured.paged_decode_attention"),
           "sweep_launches": counts["paged_decode_attention"],
           "bound_ms": bound(BLOCK_BATCH, BLOCK_H, 1, BLOCK_D, BLOCK_L - 1,
                             torch.bfloat16)[0],
           "table_file": BLOCK_TABLE}
    log(f"[block size] {json.dumps(res)}")
    check(failed == 0, f"{failed} block-size candidates failed")
    check(res["measured"] == 1 and len(res["candidates_ms"]) == 3,
          "the block sizes were not measured")
    check(winner == entry["params"][0], "the winner is not the table's")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 50304, (32,)).astype(np.int64)
               for _ in range(64)]
    loops = {bs: ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                            max_seq_len=BLOCK_L,
                                            block_size=bs))
             for bs in (64, 128, 256)}
    for loop in loops.values():
        loop.serve([prompts[0]], max_new_tokens=2)           # warm-up
    res["serve_tokens_per_s"] = {str(bs): [] for bs in loops}
    # in turns, each block size twice: 64, 128, 256, 256, 128, 64
    for bs in (64, 128, 256, 256, 128, 64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = loops[bs].serve(prompts, max_new_tokens=64)
        dt = time.perf_counter() - t0
        check(all(o.shape == (64,) for o in outs), "bad served tokens")
        res["serve_tokens_per_s"][str(bs)].append(64 * 64 / dt)
    del loops
    log(f"[block size serve] {json.dumps(res['serve_tokens_per_s'])} "
        f"(winner {winner})")
    return res, counts


def phase_generation(card=None):
    """Phase 21: generation and serving, the rest, on GPT-2 small at full
    width (random weights, seed 0). (a) beam search over the KV cache;
    (b) export_decode through a Predictor; (f, measured first) the pool's
    block size; (c) the traffic replay of the three arrival shapes with
    SLO scoring; (e) the Chrome trace of the steady replay; (d) the fault
    seam of the scheduler beat; (f) serving at each block size."""
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    t0 = time.perf_counter()
    net = GPT(GPTConfig(), device="cuda", dtype=torch.bfloat16, seed=0)
    net.eval()
    net32 = GPT(GPTConfig(), device="cuda", dtype=torch.float32, seed=0)
    net32.eval()
    res, counts = {}, {}
    res["beam"], counts["beam"] = _gen_beam(net, net32)
    del net32
    res["export"], counts["export"] = _gen_export(net)
    res["block_size"], counts["block_sweep"] = _gen_block_size(net)
    res["traffic"], counts["traffic"] = _gen_traffic(net)
    os.environ.pop("PADDLE_TPU_CUDA_AUTOTUNE_CACHE", None)
    res["seconds"] = time.perf_counter() - t0
    log(f"[generation] {res['seconds']:.1f} s")
    return res, counts


# --------------------------------------------------------------------------
# phase 22: the static graph and jit
# --------------------------------------------------------------------------

STATIC_STEP_LAUNCHES = {"flash_fwd": 12, "flash_bwd_dq": 12,
                        "flash_bwd_dkv": 12, "fused_ce_fwd": 1,
                        "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}


def _static_bert(paddle, cfg, batch, seq, amp=True, seed=0):
    """BERT-base recorded into a Program with the fused MLM loss, AdamW
    (bench.py:bench_bert's lr 1e-4, wd 0.01), at O2 bf16 through
    static.amp.decorate when ``amp``. Returns (program, net, loss var,
    [(param, grad var)])."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.text.models import Bert
    paddle.enable_static()
    try:
        main = static.Program("bert_static")
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [batch, seq], "int64")
            lab = static.data("labels", [batch, seq], "int64")
            net = Bert(cfg, seed=seed)
            loss = net(ids, masked_lm_labels=lab)
            opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                         weight_decay=0.01,
                                         parameters=net.parameters())
            if amp:
                opt = static.amp.decorate(opt, level="O2", dtype="bfloat16")
            _, pairs = opt.minimize(loss)
    finally:
        paddle.disable_static()
    return main, net, loss, pairs


def _static_train(paddle, card):
    """22(a): 40 static bf16 O2 steps of BERT-base b32 s128."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import BertConfig
    batch, seq, steps, warmup, n_batches = 32, 128, 40, 10, 16
    cfg = BertConfig.bert_base()
    ids, lab = _bert_batches(cfg, batch, seq, n_batches)
    t0 = time.perf_counter()
    main, net, loss, _ = _static_bert(paddle, cfg, batch, seq)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in net.parameters())
    exe = static.Executor()
    it = itertools.count()

    def step():
        i = next(it) % n_batches
        return exe.run(main, feed={"ids": ids[i], "labels": lab[i]},
                       fetch_list=[loss])[0]

    kernels.reset_launch_counts()
    lowerings = monitor.stat_get("executor/lowerings")
    losses, ms = [], []
    for i in range(steps):
        t = time.perf_counter()
        losses.append(float(step()))
        ms.append((time.perf_counter() - t) * 1e3)
    counts = kernels.launch_counts()
    lowered = monitor.stat_get("executor/lowerings") - lowerings
    step_ms = statistics.median(ms[warmup:])
    tokens = batch * seq
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    flops = 6 * n_params * tokens + 12 * L * H * seq * tokens
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    res = {"config": "bert_base", "dtype": "bfloat16 O2 (static.amp)",
           "batch": batch, "seq": seq, "steps": steps, "warmup": warmup,
           "params": n_params, "build_s": build_s, "ops": len(main.ops),
           "scope_entries": len(main.persistable_vars),
           "step_ms": step_ms, "step_ms_min": min(ms[warmup:]),
           "step_ms_max": max(ms[warmup:]),
           "samples_per_s": batch / (step_ms / 1e3),
           "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "mfu_peak": PEAK_NAME, "loss_first5": first, "loss_last5": last,
           "loss_start": losses[0], "loss_end": losses[-1],
           "lowerings": lowered,
           "launches_per_step": {k: counts[k] / steps
                                 for k in PATH_KERNELS + SM90_COUNTS
                                 + CE_SM90_COUNTS}, "card": card}
    for k, per in STATIC_STEP_LAUNCHES.items():
        check(counts[k] == per * steps == counts[f"{k}.sm90"],
              f"{k}: {counts[k]} launches in {steps} static steps "
              f"({counts[k + '.sm90']} Hopper), not {per * steps}")
    check(lowered == 1, f"executor/lowerings rose by {lowered} over "
                        f"{steps} runs, not 1")
    check(bool(np.isfinite(losses).all()) and last < first,
          f"the static loss is not finite and falling: {first} -> {last}")
    try:
        prof = _profile_steps(step, n=10)
    except Exception as e:   # the measurement is optional, the step is not
        prof = None
        log(f"[static profile] not measured: {type(e).__name__}: {e}")
    if prof is not None:
        res["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
        res["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
            / step_ms
        res["top"] = prof["top"][:6]
    log(f"[static bert] {json.dumps(res)}")
    del main, net, exe
    return counts, res


def _static_vs_dygraph(paddle):
    """22(b): one f32 step through Executor.run against phase 18's
    dygraph step from the same weights and batch; then clone(for_test)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig.bert_base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    ids, lab = _bert_batches(cfg, 8, 128, 1, seed=1)
    main, net_s, loss_v, pairs = _static_bert(paddle, cfg, 8, 128,
                                              amp=False)
    test_prog = main.clone(for_test=True)
    scope = static.global_scope()
    net = Bert(cfg, dtype=torch.float32, seed=7)
    net.train()
    with torch.no_grad():
        own = dict(net.named_parameters())
        for n, sp in net_s.named_parameters():
            torch.Tensor.copy_(own[n], scope.get(sp.scope_name))
    exe = static.Executor()
    feed = {"ids": ids[0], "labels": lab[0]}
    outs = exe.run(main, feed=feed, fetch_list=[loss_v]
                   + [g for _, g in pairs], return_numpy=False)
    ls = float(outs[0])
    by_scope = {sp.scope_name: n for n, sp in net_s.named_parameters()}
    gs = {by_scope[p.scope_name]: g for (p, _), g in zip(pairs, outs[1:])}
    ps = {n: scope.get(sp.scope_name).clone()
          for n, sp in net_s.named_parameters()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=net.named_parameters())
    loss = net(ids[0], masked_lm_labels=lab[0])
    loss.backward()
    _zero_missing_grads(net)
    gd = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    opt.step()
    opt.clear_grad()
    ld = float(loss.detach())
    rel = abs(ls - ld) / abs(ld)
    dgrad = {n: _grad_rel(gs[n], gd[n]) for n in gd}
    worst = max(dgrad, key=dgrad.get)
    dparam = max(float((ps[n] - p.detach()).abs().max())
                 for n, p in net.named_parameters())
    t1 = float(exe.run(test_prog, feed=feed, fetch_list=[loss_v])[0])
    t2 = float(exe.run(test_prog, feed=feed, fetch_list=[loss_v])[0])
    res = {"loss_static": ls, "loss_dygraph": ld, "loss_rel_diff": rel,
           "grad_max_rel_diff": dgrad[worst], "grad_worst": worst,
           "param_max_abs_diff": dparam, "tensors": len(gd),
           "clone_for_test_losses": [t1, t2]}
    log(f"[static vs dygraph f32] {json.dumps(res)}")
    check(np.isfinite(ls) and rel <= STEP_TOL["loss"],
          f"static loss {ls} != dygraph {ld}")
    check(dgrad[worst] <= STEP_TOL["grad"],
          f"static gradient {worst} differs: {dgrad[worst]}")
    check(dparam <= STEP_TOL["param"],
          f"static parameters differ after a step: {dparam}")
    check(t1 == t2 and np.isfinite(t1), f"clone(for_test) gave {t1}, {t2}")
    del main, net_s, net, exe, opt
    return res


class _LoopNet:
    """Built on first use: a Layer with a data-dependent trip count
    (the JAX package's tests/test_dy2static.py LoopNet)."""
    cls = None

    @classmethod
    def make(cls):
        if cls.cls is None:
            import paddle_tpu_torch as paddle

            class LoopNet(paddle.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.scale = self.create_parameter(
                        [1], default_initializer=paddle.nn.initializer
                        .Constant(2.0))

                def forward(self, x):
                    s = x
                    while s.sum() < 50.0:
                        s = s * self.scale
                    return s
            cls.cls = LoopNet
        return cls.cls()


def _wall_ms(fn, warmup=2, runs=5):
    """Wall ms of one fn() call (no_grad), the mean of ``runs`` after
    ``warmup``, synchronized."""
    with torch.no_grad():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


def _dir_bytes(prefix):
    d, base = os.path.split(prefix)
    return {f: os.path.getsize(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.startswith(base + ".")}


def _jit_routes(paddle):
    """22(c) and (d)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.hapi.model import InputSpec
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import Bert, BertConfig
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    res = {}
    # to_static on GPT-2 small's f32 forward
    gpt = GPT(GPTConfig(), device="cuda", dtype=torch.float32, seed=0)
    gpt.eval()
    gids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50257, (4, 256))).to("cuda")
    with torch.no_grad():
        ref = gpt(gids)
        got = jit.to_static(gpt)(gids)
    rel = float((got - ref).abs().max() / ref.abs().max())
    res["gpt_to_static_rel_diff"] = rel
    check(rel <= GPT_STEP_TOL["loss"], f"to_static GPT-2 differs: {rel}")
    del gpt, ref, got
    # BERT-base bf16 eval through every route
    cfg = BertConfig.bert_base()
    bert = Bert(cfg, dtype=torch.bfloat16, seed=0)
    bert.eval()
    ids, _ = _bert_batches(cfg, 32, 128, 1, seed=2)
    x = ids[0]
    tmp = tempfile.mkdtemp()
    prefix = os.path.join(tmp, "bert")
    try:
        routes = {}

        def launches(fn):
            before = kernels.launch_counts()
            out = fn()
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            return out, {k: after[k] - before[k]
                         for k in ("flash_fwd", "flash_fwd.sm90")}

        with torch.no_grad():
            ref, routes["eager"] = launches(lambda: bert(x))
        ref = ref.float()
        ms = {"eager": _wall_ms(lambda: bert(x))}
        static_fn = jit.to_static(bert)
        t0 = time.perf_counter()
        jit.save(bert, prefix, input_spec=[InputSpec([None, 128], "int64",
                                                     "ids")])
        res["save_and_export_s"] = time.perf_counter() - t0
        res["artifact_bytes"] = _dir_bytes(prefix)
        with open(prefix + ".pdinfer.json") as f:
            meta = json.load(f)
        check("pt2_skipped" not in meta, f"no .pt2: {meta.get('pt2_skipped')}")
        t0 = time.perf_counter()
        loaded = jit.load(prefix)
        res["jit_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred_pt2 = inference.create_predictor(inference.Config(prefix))
        res["predictor_pt2_load_s"] = time.perf_counter() - t0
        os.rename(prefix + ".pt2", prefix + ".pt2.off")
        t0 = time.perf_counter()
        pred_pd = inference.create_predictor(inference.Config(prefix))
        res["predictor_pdmodel_load_s"] = time.perf_counter() - t0
        check(pred_pd._translated is not None and pred_pt2._program
              is not None, "the Predictors did not take the two routes")
        xn = x.cpu().numpy()
        fns = {"to_static": lambda: static_fn(x),
               "translated_layer": lambda: loaded(x),
               "predictor_pdmodel": lambda: pred_pd.run([xn])[0],
               "predictor_pt2": lambda: pred_pt2.run([xn])[0]}
        errs = {}
        for name, fn in fns.items():
            with torch.no_grad():
                out, routes[name] = launches(fn)
            out = torch.as_tensor(np.asarray(out) if not isinstance(
                out, torch.Tensor) else out.float().cpu().numpy())
            errs[name] = float((out.to("cuda").float() - ref).abs().max()
                               / ref.abs().max())
        res["rel_err"] = errs
        res["flash_fwd_launches"] = routes
        ms.update({name: _wall_ms(fn) for name, fn in fns.items()})
        res["ms_per_batch32"] = ms
        for name, e in errs.items():
            check(e <= JIT_BF16_TOL, f"{name} differs from eager: {e}")
        for name, c in routes.items():
            check(c["flash_fwd"] == cfg.num_hidden_layers
                  == c["flash_fwd.sm90"],
                  f"{name}: flash forward launches {c}, not "
                  f"{cfg.num_hidden_layers} Hopper ones")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del bert, loaded, pred_pd, pred_pt2
    # (d) data-dependent while on the card
    net = _LoopNet.make()
    net.eval()
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "loopnet")
        jit.save(net, path, input_spec=[InputSpec([2, 2], "float32", "x")])
        loaded = jit.load(path)
        for v in (1.0, 4.0):
            xv = torch.full((2, 2), v, device="cuda")
            want, got = net(xv), loaded(xv)
            check(got.device.type == "cuda" and torch.equal(got, want),
                  f"loaded while-loop layer differs at {v}: "
                  f"{got.tolist()} vs {want.tolist()}")
        with open(path + ".pdinfer.json") as f:
            res["loop_pt2_skipped"] = "pt2_skipped" in json.load(f)
        res["loop_equal"] = True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[jit] {json.dumps(res)}")
    return res


def phase_static(card=None):
    """Phase 22: the static graph and jit; see the module docstring."""
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    paddle.seed(0)
    counts, res = _static_train(paddle, card)
    res["vs_dygraph"] = _static_vs_dygraph(paddle)
    res["jit"] = _jit_routes(paddle)
    res["seconds"] = time.perf_counter() - t0
    log(f"[static] {res['seconds']:.1f} s")
    return counts, res


# --------------------------------------------------------------------------
# phase 23: the trainer's host path
# --------------------------------------------------------------------------

P23_DIR = ".scratch/phase23"                       # listed in .gitignore
# depth cut from 40 / 12 / 8 / 20 and 40 / 25 / 10 to make room for
# phase 26: the same checks over fewer steps
P23_STEPS, P23_WARMUP, P23_BATCHES, P23_PROFILED = 24, 8, 16, 6
P23_MODES = (("sync", 0, 0), ("inflight2", 2, 0), ("inflight2_scan4", 2, 4))
P23_RESUME_AT = 12
# 23(b)'s fit cut from 24 / 15 / 6 to make room for phase 27: the same
# kill, walk and resume over fewer steps
P23_FIT_STEPS, P23_KILL_AFTER, P23_CKPT_FREQ = 16, 10, 4
P23_CAPI_STEPS, P23_NAN_STEPS = 10, 6
P23_SERVE = {"requests": 64, "prompt": 32, "new": 97, "batch": 8,
             "round": 4}
P23_PATH_KERNELS = PATH_KERNELS + SM90_COUNTS + CE_SM90_COUNTS


def _p23_path(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        P23_DIR, *parts)


def _multislot(path, rows):
    """(ids, labels) int rows as MultiSlot lines: two slots a line."""
    with open(path, "w") as f:
        for ids, lab in rows:
            f.write(f"{len(ids)} {' '.join(map(str, ids.tolist()))} "
                    f"{len(lab)} {' '.join(map(str, lab.tolist()))}\n")
    return path


def _p23_dataset(feed_vars, cfg, batch, seq):
    """23(a)'s data: phase 22's 16 LMDataset batches written as MultiSlot
    files for 40 steps (the files' batch i is LMDataset batch i % 16) and
    read by an InMemoryDataset in the files' order."""
    from paddle_tpu_torch.io import InMemoryDataset
    from paddle_tpu_torch.text.datasets import LMDataset
    lm = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                   n=P23_BATCHES * batch, mode="mlm", seed=0)
    os.makedirs(_p23_path(), exist_ok=True)
    half = P23_STEPS // 2
    files = [_multislot(_p23_path(f"lm-{k}.txt"), [
        (lm.inputs[(i % P23_BATCHES) * batch + j],
         lm.labels[(i % P23_BATCHES) * batch + j])
        for i in range(k * half, (k + 1) * half) for j in range(batch)])
        for k in range(2)]
    ds = InMemoryDataset()
    ds.init(batch_size=batch, thread_num=2, use_var=list(feed_vars))
    ds.set_filelist(files)
    t0 = time.perf_counter()
    ds.load_into_memory()
    return ds, time.perf_counter() - t0


def _p23_snapshot(main, opt):
    """The scope's values, the optimizer's slots and step count and the
    port's CPU generator (the runs' seeds) of this moment."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import rng
    scope = static.global_scope()
    return ({n: scope.get(n).clone() for n in main.persistable_vars
             if scope.has(n)},
            {n: {k: v.clone() for k, v in d.items()}
             for n, d in opt._slots.items()},
            opt._step_count, rng.generator("cpu").get_state())


def _p23_restore(snap, opt):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import rng
    vals, slots, count, gen = snap
    scope = static.global_scope()
    with torch.no_grad():
        for n, v in vals.items():
            scope.get(n).copy_(v)
    opt._slots = {n: {k: v.clone() for k, v in d.items()}
                  for n, d in slots.items()}
    opt._step_count = count
    rng.generator("cpu").set_state(gen)


def _p23_params(main):
    from paddle_tpu_torch import static
    scope = static.global_scope()
    return {n: scope.get(n).clone() for n in main.persistable_vars
            if scope.has(n)}


def _same_tensors(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                          for k in a)


def _p23_train(main, loss, ds, inflight, scan, start_batch=0,
               on_batch=None):
    """One ``train_from_dataset`` run of (a)'s program in a mode, with a
    fresh Executor: (losses, launches, lowerings, seconds over the steps
    after the warm-up, host syncs, the runner's host overhead ms a step).
    A handler keeps every step's lazy loss, read after the run."""
    import warnings
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.ops import cuda as kernels
    es = static.ExecutionStrategy()
    es.max_inflight, es.scan_fuse_steps = inflight, scan
    prog = static.CompiledProgram(main, exec_strategy=es)
    exe = static.Executor()
    handles, marks, stamps = [], {}, []

    def handler(it, outs):
        handles.append(outs[0])
        if on_batch is not None:
            on_batch(it)
        if it == start_batch + P23_WARMUP:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
        stamps.append(time.perf_counter())

    monitor.reset("executor/host_overhead_ms")
    kernels.reset_launch_counts()
    low0 = monitor.stat_get("executor/lowerings")
    waits0 = monitor.stat_get("executor/retire_waits")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            exe.train_from_dataset(prog, ds, fetch_list=[loss],
                                   print_period=0, start_batch=start_batch,
                                   fetch_handler=handler)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    t1 = time.perf_counter()
    steps = len(handles)
    counts = kernels.launch_counts()
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    # the median over spans of one megastep (one step unfused) after the
    # warm-up, each span's time shared by its steps
    k = max(scan, 1)
    tail = stamps[P23_WARMUP - 1:]
    res = {"steps": steps,
           "step_ms": (t1 - marks["t0"]) * 1e3 / (steps - P23_WARMUP),
           "step_ms_median": statistics.median(
               (tail[j + k] - tail[j]) * 1e3 / k
               for j in range(0, len(tail) - k, k)),
           "lowerings": monitor.stat_get("executor/lowerings") - low0,
           "host_syncs_per_step": (syncs + monitor.stat_get(
               "executor/retire_waits") - waits0) / steps,
           "device_to_host_syncs": syncs,
           "event_waits": monitor.stat_get("executor/retire_waits") - waits0,
           "host_overhead_ms": monitor.stat_get(
               "executor/host_overhead_ms") or None}
    losses = [float(np.asarray(h)) for h in handles]
    return losses, counts, res, exe, prog


def _p23_modes(paddle, card):
    """23(a): BERT-base static bf16 O2 (phase 22(a)'s program) trained
    from a dataset three ways, the trails compared, then the resume."""
    from paddle_tpu_torch.text.models import BertConfig
    batch, seq = 32, 128
    cfg = BertConfig.bert_base()
    paddle.seed(0)
    main, net, loss, _ = _static_bert(paddle, cfg, batch, seq)
    opt = main.optimizer_section[0]
    ds, load_s = _p23_dataset([main.data_vars["ids"],
                               main.data_vars["labels"]], cfg, batch, seq)
    start = _p23_snapshot(main, opt)
    res = {"card": card, "config": "bert_base", "batch": batch, "seq": seq,
           "steps": P23_STEPS, "warmup": P23_WARMUP,
           "dataset_load_s": load_s, "modes": {}}
    trails, finals, counts_by_mode, cut = {}, {}, {}, {}

    def snapshot_at_cut(it):
        if it == P23_RESUME_AT:
            cut["snap"] = _p23_snapshot(main, opt)

    for name, inflight, scan in P23_MODES:
        _p23_restore(start, opt)
        losses, counts, r, exe, prog = _p23_train(
            main, loss, ds, inflight, scan,
            on_batch=snapshot_at_cut if name == "sync" else None)
        trails[name], finals[name] = losses, _p23_params(main)
        counts_by_mode[name] = counts
        r["launches_per_step"] = {k: counts[k] / P23_STEPS
                                  for k in P23_PATH_KERNELS}
        r["loss_start"], r["loss_end"] = losses[0], losses[-1]
        for k, per in STATIC_STEP_LAUNCHES.items():
            check(counts[k] == per * P23_STEPS == counts[f"{k}.sm90"],
                  f"23(a) {name}: {k} {counts[k]} launches "
                  f"({counts[k + '.sm90']} Hopper) in {P23_STEPS} steps, "
                  f"not {per * P23_STEPS}")
        check(r["lowerings"] == 1, f"23(a) {name}: {r['lowerings']} "
                                   f"lowerings, not 1")
        try:
            prof = _profile_steps(lambda: exe.train_from_dataset(
                prog, ds, fetch_list=[loss], print_period=0,
                start_batch=P23_STEPS - P23_PROFILED), n=1,
                steps_per_call=P23_PROFILED)
        except Exception as e:  # the measurement is optional, the run not
            prof = None
            log(f"[23(a) profile] not measured: {type(e).__name__}: {e}")
        if prof is not None:
            r["device_busy_ms_per_step"] = prof["device_busy_ms_per_step"]
            r["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] \
                / r["step_ms"]
        res["modes"][name] = r
        log(f"[23(a) {name}] {json.dumps(r)}")
        del exe, prog
    for name in trails:
        check(trails[name] == trails["sync"], f"23(a): the {name} loss "
              f"trail differs from the synchronous loop's")
        check(_same_tensors(finals[name], finals["sync"]),
              f"23(a): {name}'s final scope differs from the sync loop's")
    check(bool(np.isfinite(trails["sync"]).all())
          and np.mean(trails["sync"][-5:]) < np.mean(trails["sync"][:5]),
          "23(a): the loss is not finite and falling")
    # the resume: the step-20 state restored, start_batch=20, in flight 2
    _p23_restore(cut.pop("snap"), opt)
    tail, _, r, exe, _ = _p23_train(main, loss, ds, 2, 0,
                                    start_batch=P23_RESUME_AT)
    check(tail == trails["sync"][P23_RESUME_AT:],
          "23(a): start_batch=20 after the step-20 restore is not the "
          "trail's tail")
    check(_same_tensors(_p23_params(main), finals["sync"]),
          "23(a): the resumed run's final scope differs")
    res["resume"] = {"start_batch": P23_RESUME_AT, "steps": len(tail),
                     "bitwise": True, "lowerings": r["lowerings"]}
    res["loss_trail_bitwise"] = True
    del finals, start
    return main, loss, ds, opt, counts_by_mode["inflight2"], res


def _p23_capi(paddle, main, loss, ds):
    """23(c): (a)'s program through save_train_program / create /
    run_step for 10 steps, against Executor.run from the same state."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import capi_train
    art = _p23_path("capi", "bert.pdprog")
    os.makedirs(os.path.dirname(art), exist_ok=True)
    t0 = time.perf_counter()
    capi_train.save_train_program(main, art)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = capi_train.create(art)
    create_s = time.perf_counter() - t0
    feeds = list(itertools.islice(ds.batches(), P23_CAPI_STEPS))
    paddle.seed(5)
    got = [capi_train.run_step(h, [
        (memoryview(np.ascontiguousarray(f["ids"])), 2, f["ids"].shape),
        (memoryview(np.ascontiguousarray(f["labels"])), 2,
         f["labels"].shape)]) for f in feeds]
    paddle.seed(5)
    exe = static.Executor()
    want = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])
                  .mean()) for f in feeds]
    check(got == want, f"23(c): run_step {got[:3]} ... differs from "
                       f"Executor.run {want[:3]} ...")
    scope = static.global_scope()
    same = all(torch.equal(h["scope"].get(n), scope.get(n))
               for n in main.persistable_vars if scope.has(n))
    check(same, "23(c): the capi scope differs from Executor.run's")
    res = {"steps": P23_CAPI_STEPS, "bitwise": True, "save_s": save_s,
           "create_s": create_s,
           "artifact_bytes": sum(os.path.getsize(_p23_path("capi", f))
                                 for f in os.listdir(_p23_path("capi")))}
    log(f"[23(c) capi_train] {json.dumps(res)}")
    del h
    import shutil
    shutil.rmtree(_p23_path("capi"), ignore_errors=True)
    return res


def _raises(fn):
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return None


def _p23_nan(paddle, main, loss, ds):
    """23(d): FLAGS_check_nan_inf's three raise points with an inf planted
    in a feed, the PipelineStepError's dump, and the flag's cost a step
    on (a)'s program."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.static.pipeline_runner import (PipelineRunner,
                                                         PipelineStepError)
    feeds = list(itertools.islice(ds.batches(), P23_NAN_STEPS))
    exe = static.Executor()
    cost = {}
    for on in (False, True):
        flags.set_flags({"FLAGS_check_nan_inf": on})
        ms = []
        for f in feeds:
            t = time.perf_counter()
            exe.run(main, feed=f, fetch_list=[loss])
            ms.append((time.perf_counter() - t) * 1e3)
        cost["on" if on else "off"] = statistics.median(ms[1:])
    res = {"step_ms_flag_off": cost["off"], "step_ms_flag_on": cost["on"],
           "flag_cost_ms": cost["on"] - cost["off"]}
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = np.ones((4, 8), "float32")
        x[1, 3] = np.inf
        # the op layer
        msg = _raises(lambda: paddle.matmul(paddle.to_tensor(x),
                                            paddle.ones([8, 4])))
        check(msg is not None and "op 'matmul' output 0" in msg,
              f"23(d): the op layer did not name matmul: {msg}")
        res["op_layer"] = msg
        # Executor.run, before the scope is written
        paddle.enable_static()
        try:
            prog = static.Program("nan")
            with static.program_guard(prog, static.Program()):
                xv = static.data("x", [4, 8], "float32")
                lin = paddle.nn.Linear(8, 1)
                lv = paddle.mean(lin(xv))
                paddle.optimizer.SGD(learning_rate=0.1).minimize(lv)
        finally:
            paddle.disable_static()
        scope = static.global_scope()
        before = scope.get(lin.weight.scope_name).clone()
        msg = _raises(lambda: exe.run(prog, feed={"x": x}, fetch_list=[lv]))
        check(msg is not None and "after Executor.run step" in msg
              and "['fetches'][0]" in msg,
              f"23(d): Executor.run did not raise at its sweep: {msg}")
        check(torch.equal(before, scope.get(lin.weight.scope_name)),
              "23(d): Executor.run wrote the scope before its sweep")
        res["executor"] = msg.splitlines()[0]
        # Model's step
        net = torch.nn.Sequential()
        net.fc = paddle.nn.Linear(8, 2)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.SGD(learning_rate=0.1,
                                           parameters=model.parameters()),
                      loss=paddle.nn.CrossEntropyLoss())
        w0 = net.fc.weight.detach().clone()
        msg = _raises(lambda: model.train_batch(
            [x], [np.zeros((4, 1), "int64")]))
        check(msg is not None and "after train_batch step" in msg
              and "['loss']" in msg,
              f"23(d): Model's step did not raise at its sweep: {msg}")
        check(torch.equal(w0, net.fc.weight.detach()),
              "23(d): Model's step wrote its parameters before its sweep")
        res["model"] = msg.splitlines()[0]
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    # a failing in-flight step: its index named, a flight-recorder dump
    dump_dir = _p23_path("dumps")
    import shutil
    shutil.rmtree(dump_dir, ignore_errors=True)
    os.environ["PADDLE_TPU_DUMP_DIR"] = dump_dir
    try:
        good = {"x": np.ones((4, 8), "float32")}
        run = [good] * 3 + [{"x": np.ones((4, 9), "float32")}] + [good]
        err = None
        try:
            with PipelineRunner(exe, prog, fetch_list=[lv],
                                max_inflight=2) as r:
                for hs in r.run(iter(run)):
                    hs[0].numpy()
        except PipelineStepError as e:
            err = e
        check(err is not None and err.step_index == 3,
              f"23(d): the failing step is not named 3: {err}")
        dumps = [f for f in os.listdir(dump_dir)
                 if f.startswith("obsdump_pipeline_step_error")]
        check(len(dumps) >= 1, "23(d): no flight-recorder dump")
        with open(os.path.join(dump_dir, dumps[0])) as f:
            rec = json.load(f)
        check(rec["extra"]["step_index"] == 3, "23(d): the dump names "
              f"step {rec['extra']}")
        res["pipeline_step_error"] = str(err)
        res["dump_spans"] = len(rec["spans"])
    finally:
        del os.environ["PADDLE_TPU_DUMP_DIR"]
        shutil.rmtree(dump_dir, ignore_errors=True)
    log(f"[23(d) nan check] {json.dumps(res)}")
    return res


def _p23_fit_child(mode, ckpt, out):
    """23(b)'s child process: phase 17's BERT-base bf16 O2 Model.fit for
    40 steps of 32 (shuffled LMDataset), with auto-checkpointing unless
    ``mode`` is "ref"; "kill" sends itself SIGTERM after step 25. Writes
    the final parameters' manifest to ``out`` and prints one JSON line."""
    import signal
    setup()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.checkpoint import (TrainingCheckpoint,
                                                      build_manifest)
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import BertConfig
    paddle.set_device("gpu")
    cfg = BertConfig.bert_base()
    np.random.seed(0)
    paddle.seed(0)
    model = _hapi_model(cfg, "bfloat16")
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=128,
                   n=P23_FIT_STEPS * 32, mode="mlm", seed=0)

    class Term(Callback):
        def on_train_batch_end(self, step, logs=None):
            if mode == "kill" and step == P23_KILL_AFTER - 1:
                os.kill(os.getpid(), signal.SIGTERM)

    kw = {} if mode == "ref" else dict(
        auto_checkpoint_dir=ckpt, auto_checkpoint_freq=P23_CKPT_FREQ,
        keep_checkpoint_max=2)
    model.fit(ds, batch_size=32, epochs=1, shuffle=True, log_freq=10,
              verbose=0, callbacks=[Term()], **kw)
    torch.cuda.synchronize()
    res = {"mode": mode, "step_count": model._optimizer._step_count}
    if mode != "ref":
        res["async_save_s"] = model._acp.last_save_seconds
        timing = TrainingCheckpoint(os.path.join(ckpt + "_timing"), keep=1)
        state = model._acp.capture(model, 0, P23_FIT_STEPS - 1,
                                   P23_FIT_STEPS)
        t0 = time.perf_counter()
        timing.save(1, state, force=True)
        res["sync_save_s"] = time.perf_counter() - t0
        timing.close()
        import shutil
        shutil.rmtree(ckpt + "_timing", ignore_errors=True)
    with open(out, "w") as f:
        json.dump(build_manifest(P23_FIT_STEPS,
                                 dict(model.network.state_dict())), f)
    print(json.dumps(res), flush=True)


def _p23_children(*modes):
    """Run 23(b)'s children for ``modes`` ((mode, checkpoint dir, out)
    each) at once on the card; their CompletedProcess results."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase23-child", *m],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))) for m in modes]
    out = []
    for p, m in zip(procs, modes):
        try:
            so, se = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out.append(subprocess.CompletedProcess(m, p.returncode, so, se))
    return out


def _p23_kill_resume():
    """23(b): the SIGTERM'd Model.fit resumed to the uninterrupted run's
    parameters; a flipped byte quarantined; bytes and seconds."""
    import shutil
    import signal
    from paddle_tpu_torch.incubate.checkpoint import TrainingCheckpoint
    ckpt = _p23_path("ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(_p23_path(), exist_ok=True)
    t0 = time.perf_counter()
    # the uninterrupted run and the one SIGTERM'd, side by side
    ref, killed = _p23_children(("ref", ckpt, _p23_path("ref.json")),
                                ("kill", ckpt, _p23_path("killed.json")))
    check(ref.returncode == 0, f"23(b) ref child: {ref.stderr[-2000:]}")
    check(killed.returncode == -signal.SIGTERM,
          f"23(b): the killed child exited {killed.returncode}: "
          f"{killed.stderr[-2000:]}")
    ck = TrainingCheckpoint(ckpt, keep=2)
    check(ck.all_steps() == [P23_KILL_AFTER // P23_CKPT_FREQ * P23_CKPT_FREQ,
                             P23_KILL_AFTER],
          f"23(b): the kill left steps {ck.all_steps()}")
    t1 = time.perf_counter()
    state = ck.restore()
    restore_s = time.perf_counter() - t1
    check(state["counters"] == {"epoch": 0, "step": P23_KILL_AFTER - 1,
                                "global_step": P23_KILL_AFTER},
          f"23(b): the SIGTERM save holds {state['counters']}")
    del state
    (resumed,) = _p23_children(("resume", ckpt, _p23_path("resumed.json")))
    check(resumed.returncode == 0,
          f"23(b) resume child: {resumed.stderr[-2000:]}")
    with open(_p23_path("ref.json")) as f:
        want = json.load(f)["leaves"]
    with open(_p23_path("resumed.json")) as f:
        got = json.load(f)["leaves"]
    check(got == want, "23(b): the resumed run's final parameters differ "
          "from the uninterrupted run's")
    rinfo = json.loads(resumed.stdout.strip().splitlines()[-1])
    check(rinfo["step_count"] == P23_FIT_STEPS,
          f"23(b): the resumed run ends at step {rinfo['step_count']}")
    steps = ck.all_steps()
    last, prev = P23_FIT_STEPS, P23_FIT_STEPS - P23_CKPT_FREQ
    check(steps == [prev, last], f"23(b): the resume left steps {steps}")
    step_dir = os.path.join(ckpt, str(last))
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    # one flipped byte in the last step's largest tensor data:
    # quarantined, the restore walks back to the one before
    path = os.path.join(step_dir, "state.pt")
    with open(path, "r+b") as f:
        f.seek(nbytes // 2)
        b = f.read(1)
        f.seek(nbytes // 2)
        f.write(bytes([b[0] ^ 0x10]))
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.incubate.checkpoint import CheckpointCorruptError
    try:
        ck.restore(step=last)
        reason = None
    except CheckpointCorruptError as e:
        reason = e.reason
    check(reason == "sha256 mismatch", f"23(b): the flipped byte of step "
          f"{last} was not found by its manifest's hash ({reason})")
    q0 = monitor.stat_get("ckpt.corrupt_skipped")
    t1 = time.perf_counter()
    state = ck.restore()
    walk_s = time.perf_counter() - t1
    check(state is not None and state["counters"]["global_step"] == prev,
          f"23(b): the restore did not walk back to step {prev}")
    check(monitor.stat_get("ckpt.corrupt_skipped") - q0 == 1
          and ck.all_steps() == [prev], f"23(b): step {last} not quarantined")
    del state
    res = {"fit_steps": P23_FIT_STEPS, "killed_after": P23_KILL_AFTER,
           "checkpoint_freq": P23_CKPT_FREQ, "keep": 2, "bitwise": True,
           "checkpoint_bytes": nbytes, "restore_s": restore_s,
           "corrupt_walk_back_s": walk_s,
           "async_save_s": rinfo["async_save_s"],
           "sync_save_s": rinfo["sync_save_s"],
           "seconds": time.perf_counter() - t0}
    log(f"[23(b) kill and resume] {json.dumps(res)}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


def _p23_stream(paddle, card):
    """23(e): a GPT-2 small bf16 ServeLoop's completions offered to a
    StreamingDataset (through the paged kernel), re-offers delivered
    once, and the records trained by GPT-2 small's static causal-LM step
    through Window rounds of train_from_dataset."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.dataset import StreamingDataset
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.traffic.harness import Window
    sv = P23_SERVE
    seq = sv["prompt"] + sv["new"] - 1

    def collate(recs):
        full = np.asarray([r["prompt"] + r["tokens"] for r in recs],
                          "int64")
        return {"ids": full[:, :seq], "labels": full[:, 1:seq + 1]}

    ds = StreamingDataset(batch_size=sv["batch"], collate=collate,
                          name="phase23")
    cfg = GPTConfig()
    net = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.eval()
    loop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                      max_seq_len=sv["prompt"] + sv["new"]),
                     on_complete=ds.offer)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, (sv["prompt"],))
               .astype(np.int64) for _ in range(sv["requests"])]
    kernels.reset_launch_counts()
    loop.start()
    t0 = time.perf_counter()
    reqs = [loop.submit(p, max_new_tokens=sv["new"]) for p in prompts]
    for r in reqs:
        r.result(timeout=600)
    serve_s = time.perf_counter() - t0
    loop.stop()
    serve_counts = kernels.launch_counts()
    check(serve_counts["paged_decode_attention"] > 0,
          "23(e): the serve loop launched no paged decode kernel")
    check(ds.stats()["accepted"] == sv["requests"],
          f"23(e): {ds.stats()['accepted']} records accepted")
    for rec in ds.state_dict()["buffered"]:      # the transport replays
        check(not ds.offer(rec), "23(e): a re-offer was accepted")
    del loop, net
    # GPT-2 small's static causal-LM step, bf16 O2, AdamW
    paddle.seed(0)
    paddle.enable_static()
    try:
        main = static.Program("gpt_stream")
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [sv["batch"], seq], "int64")
            lab = static.data("labels", [sv["batch"], seq], "int64")
            gnet = GPT(cfg, seed=0)
            loss = gnet(ids, labels=lab)
            opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                         weight_decay=0.01,
                                         parameters=gnet.parameters())
            static.amp.decorate(opt, level="O2",
                                dtype="bfloat16").minimize(loss)
    finally:
        paddle.disable_static()
    window = Window(ds)
    exe = static.Executor()
    losses, rounds = [], []
    kernels.reset_launch_counts()
    n_batches = sv["requests"] // sv["batch"]
    for _ in range(n_batches // sv["round"]):
        exe.train_from_dataset(main, window.take(sv["round"]),
                               fetch_list=[loss], print_period=0,
                               fetch_handler=lambda it, o: losses.append(
                                   o[0]))
        rounds.append(ds.stats())
    ds.close()
    train_counts = kernels.launch_counts()
    losses = [float(np.asarray(h)) for h in losses]
    st = ds.stats()
    check(len(losses) == n_batches and bool(np.isfinite(losses).all()),
          f"23(e): {len(losses)} streamed steps, losses {losses}")
    check(st["delivered_batches"] == n_batches
          and st["delivered_records"] == sv["requests"]
          and st["duplicates"] == sv["requests"],
          f"23(e): the stream's counters {st}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_ce_fwd",
              "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        check(train_counts[k] > 0 and train_counts[k]
              == train_counts[f"{k}.sm90"],
              f"23(e): {k} launched {train_counts[k]} times "
              f"({train_counts[k + '.sm90']} Hopper) in the streamed steps")
    res = {"card": card, "requests": sv["requests"], "prompt": sv["prompt"],
           "new": sv["new"], "serve_s": serve_s,
           "serve_tokens_per_s": sv["requests"] * sv["new"] / serve_s,
           "train_batch": sv["batch"], "train_seq": seq,
           "window_rounds": [{k: r[k] for k in (
               "delivered_batches", "delivered_records", "backlog",
               "duplicates")} for r in rounds],
           "losses": losses,
           "paged_launches": serve_counts["paged_decode_attention"],
           "train_launches": {k: train_counts[k] for k in
                              PATH_KERNELS + SM90_COUNTS + CE_SM90_COUNTS}}
    log(f"[23(e) streaming] {json.dumps(res)}")
    return res, serve_counts, train_counts


def _p23_setup():
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    return paddle


def phase_p23_modes():
    """23(a) alone (the planted trainer faults of the scan stream and the
    resume)."""
    _p23_modes(_p23_setup(), None)


def phase_p23_kill_resume():
    """23(b) alone (the planted manifest fault)."""
    _p23_kill_resume()


def phase_p23_nan():
    """23(d) alone, on (a)'s program and data (the planted sweep fault)."""
    from paddle_tpu_torch.text.models import BertConfig
    paddle = _p23_setup()
    cfg = BertConfig.bert_base()
    paddle.seed(0)
    main, _, loss, _ = _static_bert(paddle, cfg, 32, 128)
    ds, _ = _p23_dataset([main.data_vars["ids"], main.data_vars["labels"]],
                         cfg, 32, 128)
    _p23_nan(paddle, main, loss, ds)


def p23_host_probe():
    """Where 23(a)'s host time goes (not part of the run): each mode's
    step ms with Python's collector on and then off for the run
    (``gc.disable()``), the collector's passes and seconds over each run
    (``gc.callbacks``), and a cProfile of the in-flight run (the top
    entries by cumulative and by own time), as one JSON line."""
    import cProfile
    import gc
    import io
    import pstats
    from paddle_tpu_torch.text.models import BertConfig
    paddle = _p23_setup()
    cfg = BertConfig.bert_base()
    paddle.seed(0)
    main, _, loss, _ = _static_bert(paddle, cfg, 32, 128)
    opt = main.optimizer_section[0]
    ds, _ = _p23_dataset([main.data_vars["ids"], main.data_vars["labels"]],
                         cfg, 32, 128)
    start = _p23_snapshot(main, opt)
    passes = []

    def on_gc(phase, info):
        if phase == "start":
            passes.append([info["generation"], time.perf_counter()])
        elif passes:
            passes[-1][1] = time.perf_counter() - passes[-1][1]

    gc.callbacks.append(on_gc)
    out = {"objects_tracked": len(gc.get_objects())}
    try:
        for name, inflight, scan in P23_MODES:
            for collector in ("on", "off"):
                _p23_restore(start, opt)
                del passes[:]
                if collector == "off":
                    gc.collect()
                    gc.disable()
                del passes[:]
                try:
                    _, _, r, _, _ = _p23_train(main, loss, ds, inflight,
                                               scan)
                finally:
                    gc.enable()
                out[f"{name}_gc_{collector}"] = {
                    "step_ms": r["step_ms"],
                    "host_overhead_ms": r["host_overhead_ms"],
                    "gc_passes": [sum(1 for g, _ in passes if g == k)
                                  for k in range(3)],
                    "gc_seconds": sum(t for _, t in passes)}
        # the runner's submit in the main thread, no prefetch thread
        from paddle_tpu_torch import static
        from paddle_tpu_torch.static.pipeline_runner import PipelineRunner
        _p23_restore(start, opt)
        with PipelineRunner(static.Executor(), main, fetch_list=[loss],
                            max_inflight=2) as r:
            for i, feed in enumerate(ds.batches()):
                if i == P23_WARMUP:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                r.submit(feed)
        torch.cuda.synchronize()
        out["inflight2_submit_loop_step_ms"] = (
            (time.perf_counter() - t0) * 1e3 / (P23_STEPS - P23_WARMUP))
        _p23_restore(start, opt)
        prof = cProfile.Profile()
        prof.enable()
        _p23_train(main, loss, ds, 2, 0)
        prof.disable()
        for key in ("cumulative", "tottime"):
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(25)
            out[f"profile_{key}"] = buf.getvalue().splitlines()[-32:]
    finally:
        gc.callbacks.remove(on_gc)
    log(f"[23 host probe] {json.dumps(out)}")
    return out


def phase_trainer_host(card=None):
    """Phase 23: the trainer's host path; see the module docstring."""
    import shutil
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    main, loss, ds, opt, tfd_counts, res = _p23_modes(paddle, card)
    res["capi_train"] = _p23_capi(paddle, main, loss, ds)
    res["nan_check"] = _p23_nan(paddle, main, loss, ds)
    del main, loss, ds, opt
    torch.cuda.empty_cache()
    res["kill_resume"] = _p23_kill_resume()
    res["streaming"], serve_counts, stream_counts = _p23_stream(paddle, card)
    shutil.rmtree(_p23_path(), ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    log(f"[trainer host] {res['seconds']:.1f} s")
    return {"tfd": tfd_counts, "serve": serve_counts,
            "stream_train": stream_counts}, res


# --------------------------------------------------------------------------
# phase 24: the parameter-server tier and cluster telemetry
# --------------------------------------------------------------------------

PS_V, PS_DIM = 50304, 768       # GPT-2 small's padded vocabulary and width
# PS transport for phase 24 (generous deadlines: 768-wide rows are ~3 KB
# each) and a 2 s heartbeat deadline, as the CPU tests use
P24_RPC = dict(timeout=30.0, max_retries=2, backoff_base=0.01,
               backoff_max=0.05, connect_retry_s=30.0)
P24_HB = dict(heartbeat_s=0.1, heartbeat_timeout_s=2.0)
P24_SERVE = {"requests": 64, "prompt": 32, "new": 64, "after_swap": 16,
             "batch_records": 8}
# 24(a): the PS-held rows against the local run's: bitwise. The same
# gradients come from the same program on the card, and the server's
# numpy update row - lr * g rounds twice, as the card's SGD does (a
# multiply, then a subtraction; no fused multiply-add in its kernels)
P24_ROW_TOL = 0.0
P24_KILL_AFTER = 4              # 24(b): the primary dies after batch 4


def _p24_cluster(specs, n=3, k=1):
    from paddle_tpu_torch.distributed.ps import PSServer, ShardMap
    servers = [PSServer("127.0.0.1:0", dict(specs)) for _ in range(n)]
    eps = [s.start() for s in servers]
    if k:
        smap = ShardMap.create(eps, n_backups=k)
        for s in servers:
            s.enable_replication(shard_map=smap, peers=eps, n_backups=k,
                                 rpc_opts=dict(P24_RPC), **P24_HB)
    return servers, eps


def _p24_close(servers, *closers):
    for c in closers:
        try:
            c.close()
        except Exception:
            pass
    for s in servers:
        s.shutdown()


def _p24_static(paddle, name, build):
    from paddle_tpu_torch import static
    paddle.enable_static()
    try:
        main = static.Program(name)
        with static.program_guard(main, static.Program()):
            out = build(static)
    finally:
        paddle.disable_static()
    return (main,) + out


def _p24_downpour(paddle):
    """24(a): sync Downpour at V 50304 x 768: the server owns the
    embedding's SGD; 16 batches of 8 x 128 ids. The same program trained
    locally from the same weights is the reference."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed.ps import PSClient, PSServer
    b, s, n = 8, 128, 16
    rng = np.random.RandomState(24)
    feeds = []
    for _ in range(n):
        ids = rng.randint(0, PS_V, (b, s)).astype(np.int64)
        feeds.append({"ids": ids,
                      "label": (ids % 2).astype(np.float32)[..., None]})

    def build(st):
        ids = st.data("ids", [b, s], "int64")
        label = st.data("label", [b, s, 1], "float32")
        emb = paddle.nn.Embedding(PS_V, PS_DIM)
        head = paddle.nn.Linear(PS_DIM, 1, bias_attr=False)
        loss = paddle.ops.mean(
            paddle.nn.functional.binary_cross_entropy_with_logits(
                head(emb(ids)), label))
        paddle.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return loss, emb.weight.scope_name, head.weight.scope_name

    ps_main, ps_loss, ps_emb, ps_head = _p24_static(paddle, "p24_ps", build)
    lo_main, lo_loss, lo_emb, lo_head = _p24_static(paddle, "p24_local",
                                                    build)

    class Feeds:
        def batches(self):
            yield from feeds

    srv = PSServer(tables={"emb": {"type": "sparse", "dim": PS_DIM,
                                   "optimizer": "sgd", "lr": 0.5,
                                   "init": "uniform", "seed": 24}})
    client = PSClient([srv.start()], **P24_RPC)
    scope = static.global_scope()
    res = {}
    try:
        # the server's initial rows are the local run's embedding
        t0 = time.perf_counter()
        init = client.pull_sparse("emb", np.arange(PS_V, dtype=np.int64))
        res["pull_all_s"] = time.perf_counter() - t0
        scope.set(lo_emb, torch.tensor(init, device="cuda"))
        scope.set(lo_head, scope.get(ps_head).clone())
        exe = static.Executor()
        saved = flags.get_flags(["FLAGS_executor_max_inflight"])
        flags.set_flags({"FLAGS_executor_max_inflight": 0})
        losses = {"ps": [], "local": []}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.train_from_dataset(
                ps_main, Feeds(), fetch_list=[ps_loss], print_period=0,
                fetch_handler=lambda it, o: losses["ps"].append(
                    float(np.asarray(o[0]))),
                ps_config={"client": client,
                           "sparse": [{"param": ps_emb, "slot": "ids",
                                       "table": "emb"}]})
            res["ps_train_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            exe.train_from_dataset(
                lo_main, Feeds(), fetch_list=[lo_loss], print_period=0,
                fetch_handler=lambda it, o: losses["local"].append(
                    float(np.asarray(o[0]))))
            torch.cuda.synchronize()
            res["local_train_s"] = time.perf_counter() - t0
        finally:
            flags.set_flags(saved)
        check(all(p.scope_name != ps_emb
                  for p, _ in ps_main.optimizer_section[1])
              and srv.table("emb").applied == n,
              f"24(a): {srv.table('emb').applied} pushes applied, not {n}")
        touched = np.unique(np.concatenate([f["ids"].ravel()
                                            for f in feeds]))
        ps_rows = client.pull_sparse("emb", touched)
        lo_rows = scope.get(lo_emb)[torch.as_tensor(
            touched, device="cuda")].cpu().numpy()
        head_err = float((scope.get(ps_head) - scope.get(lo_head)).abs()
                         .max())
        row_err = float(np.abs(ps_rows - lo_rows).max())
        moved = float(np.abs(ps_rows - init[touched]).max())
        res.update({"vocab": PS_V, "dim": PS_DIM, "batches": n,
                    "batch_ids": b * s, "touched_rows": int(touched.size),
                    "row_max_abs_err": row_err,
                    "rows_bitwise": bool(np.array_equal(ps_rows, lo_rows)),
                    "head_max_abs_err": head_err, "rows_moved": moved,
                    "losses_ps": losses["ps"],
                    "losses_local": losses["local"]})
        log(f"[24(a) downpour] {json.dumps(res)}")
        check(moved > 0.0, "24(a): the rows did not train")
        check(row_err <= P24_ROW_TOL and head_err <= P24_ROW_TOL,
              f"24(a): PS rows / head differ from the local run by "
              f"{row_err:.3e} / {head_err:.3e} (> {P24_ROW_TOL})")
        # pull / push rows/s at dim 768 over loopback, one server
        ids = np.arange(8192, dtype=np.int64) * 5
        grads = np.full((ids.size, PS_DIM), 1e-3, np.float32)
        pulls, pushes = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            client.pull_sparse("emb", ids)
            pulls.append(ids.size / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            client.push_sparse_grad("emb", ids, grads)
            pushes.append(ids.size / (time.perf_counter() - t0))
        res["pull_rows_per_s_1server"] = statistics.median(pulls)
        res["push_rows_per_s_1server"] = statistics.median(pushes)
        log(f"[24(a) loopback] pull {res['pull_rows_per_s_1server']:.0f} "
            f"rows/s, push {res['push_rows_per_s_1server']:.0f} rows/s "
            f"(8192 x {PS_DIM} f32, one server)")
    finally:
        _p24_close([srv], client)
        for name in (ps_emb, ps_head, lo_emb, lo_head):
            scope.set(name, None)
    return res


def _p24_await_promotion(client, dead_ep, deadline=20.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline:
        try:
            client.refresh_shard_map()
        except Exception:
            pass
        if dead_ep not in client.shard_map.servers:
            return time.perf_counter() - t0
        time.sleep(0.1)
    check(False, f"24(b): no promotion after {dead_ep} died")


def _p24_online_program(paddle):
    def build(st):
        ids = st.data("ids", [-1], "int64")
        target = st.data("target", [-1, PS_DIM], "float32")
        emb = paddle.nn.Embedding(PS_V, PS_DIM)
        diff = emb(ids) - target
        loss = paddle.ops.mean(paddle.ops.sum(diff * diff, axis=-1))
        paddle.optimizer.SGD(learning_rate=0.25).minimize(loss)
        return loss, emb.weight.scope_name
    return _p24_static(paddle, "p24_online", build)


def _p24_train_leg(paddle, records, target, kill):
    """One online training run over ``records`` (each offered twice) on a
    fresh 3-server / 1-backup cluster: 8 batches, sync_every 1, an
    EmbeddingPrefetcher landing rows on the card. With ``kill``: shard
    0's primary dies after batch 4, for good; the last batch's first
    delta push is applied but its acks are lost past the transport
    retries (failover re-routes off), so the payload freezes and the end
    of the stream resends it under its key (no batch reads the local
    view after it, so the trained values stay the fault-free run's); the
    serving cache, warmed before training, must not serve a
    pre-promotion row after the training. Returns the cluster's
    state."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import flags, monitor
    from paddle_tpu_torch.dataset import StreamingDataset
    from paddle_tpu_torch.distributed.ps import (EmbeddingPrefetcher,
                                                 HeterPSCache, PSClient)
    from paddle_tpu_torch.testing import faults
    servers, eps = _p24_cluster({"wte": {"type": "geo_sparse",
                                         "dim": PS_DIM, "init": "zeros"}})
    client_t = PSClient(eps, **P24_RPC)
    client_p = PSClient(eps, **P24_RPC)
    cache = HeterPSCache(client_p, "wte", PS_DIM, host_rows=0,
                         device="cuda")
    pf = EmbeddingPrefetcher(client_t, table="wte", device="cuda")
    main, loss, emb_name = _p24_online_program(paddle)
    ds = StreamingDataset(batch_size=P24_SERVE["batch_records"],
                          name=f"p24-{kill}",
                          collate=lambda recs: _p24_collate(recs, target))
    for rec in records:                 # at-least-once: every record twice
        ds.offer(rec)
        ds.offer(rec)
    ds.close()
    first = np.unique(_p24_collate(records[:P24_SERVE["batch_records"]],
                                   target)["ids"])
    cache.pull(first)                   # warm: every row zero
    holder, res = {}, {"killed": kill}
    default_failover = flags.get_flags(["PADDLE_PS_FAILOVER_RETRIES"])

    n_batches = len(records) // P24_SERVE["batch_records"]
    stack = contextlib.ExitStack()

    def on_batch(drv):
        holder["drv"] = drv
        if kill and drv._batch_count == P24_KILL_AFTER:
            res["k_kill"] = len(drv.flush_log)
            servers[0].shutdown()
        if kill and drv._batch_count == n_batches - 1:
            # the last flush pushes shard 0 first: its replies are the
            # backup's forward (where shard 0 still has a backup), then
            # the primary's; drop the primary's three times (one try and
            # two transport retries)
            flags.set_flags({"PADDLE_PS_FAILOVER_RETRIES": 0})
            holder["inj"] = stack.enter_context(faults.inject(faults.Fault(
                "server", "reply", faults.DROP, method="push_sparse_delta",
                after=1 if client_t.shard_map.backups(0) else 0,
                times=3)))

    before = monitor.stats("ps.")
    try:
        t0 = time.perf_counter()
        static.Executor().train_from_dataset(
            main, ds, ps_config={
                "client": client_t, "mode": "online", "sync_every": 1,
                "trainer_id": 24, "on_batch": on_batch,
                "sparse": [{"param": emb_name, "slot": "ids",
                            "table": "wte", "prefetcher": pf}]})
        torch.cuda.synchronize()
        res["train_s"] = time.perf_counter() - t0
        stack.close()
    finally:
        stack.close()
        flags.set_flags(default_failover)
    drv = holder["drv"]
    log_ = drv.flush_log
    check([seq for _, seq, _ in log_] == list(range(n_batches)),
          f"24(b): flush log {[seq for _, seq, _ in log_]}")
    expected = {ep: 0 for ep in eps}
    for _, seq, ids in log_:
        for s in sorted({int(i) % 3 for i in ids}):
            for ep in (eps[s], eps[(s + 1) % 3]):
                if kill and seq >= res["k_kill"] and ep == eps[0]:
                    continue
                expected[ep] += 1
    live = servers[1:] if kill else servers
    applied = {s.endpoint: s.table("wte").applied for s in live}
    check(all(applied[ep] == expected[ep] for ep in applied),
          f"24(b): applied {applied}, the schedule says {expected}")
    res["applied"] = list(applied.values())
    if kill:
        check(holder["inj"].fired(faults.DROP) == 3
              and monitor.stat_get("ps.online.deferred_flushes")
              - before.get("ps.online.deferred_flushes", 0) == 1,
              "24(b): the lost ack did not defer exactly one flush")
        res["promotion_s"] = _p24_await_promotion(client_p, eps[0])
        rows, inv = cache.pull(first)
        fresh = client_p.pull_sparse("wte", first)
        check(torch.equal(rows.cpu(), torch.from_numpy(fresh)),
              "24(b): the card cache served a row cached before the "
              "promotion")
        res["cache_invalidations"] = monitor.stat_get(
            "ps.heter.invalidations") - before.get(
            "ps.heter.invalidations", 0)
    res["trained_ids"] = sorted({int(i) for _, _, ids in log_ for i in ids})
    res["table"] = client_p.pull_sparse(
        "wte", np.asarray(res["trained_ids"], np.int64))
    return res, {"servers": live, "clients": (client_t, client_p, pf),
                 "cache": cache, "log": log_}


def _p24_collate(recs, target):
    ids = np.concatenate([np.asarray(r["prompt"] + r["tokens"], np.int64)
                          for r in recs])
    return {"ids": ids, "target": target[ids]}


def _p24_online(paddle):
    """24(b): the closed online loop at GPT-2 small's width."""
    from paddle_tpu_torch.distributed.ps import EmbeddingSnapshotPublisher
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    sv = P24_SERVE
    t_all = time.perf_counter()
    cfg = GPTConfig()
    net = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.eval()
    records = []
    loop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                      max_seq_len=sv["prompt"] + sv["new"]),
                     on_complete=records.append)
    rng = np.random.RandomState(24)
    prompts = [rng.randint(1, cfg.vocab_size, (sv["prompt"],))
               .astype(np.int64) for _ in range(sv["requests"])]
    target = np.random.RandomState(77).uniform(
        -0.05, 0.05, (PS_V, PS_DIM)).astype(np.float32)
    res, legs = {}, {}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [loop.submit(p, max_new_tokens=sv["new"]) for p in prompts]
    loop.run_until_idle()
    torch.cuda.synchronize()
    legs["serve_s"] = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(counts["paged_decode_attention"] > 0,
          "24(b): the serve leg launched no paged decode kernel")
    check(len(records) == sv["requests"]
          and all(len(r.result(timeout=0)) == sv["new"] for r in reqs),
          f"24(b): {len(records)} records of {sv['requests']} requests")
    base = net.wte.weight.detach().float().cpu().numpy()
    after_prompts = torch.tensor(np.stack(prompts[:sv["after_swap"]]),
                                 device="cuda")
    served = list(records)
    outs = {}
    for kill in (False, True):
        leg, keep = _p24_train_leg(paddle, served, target, kill)
        pub = EmbeddingSnapshotPublisher(keep["clients"][1], "wte",
                                         cache=keep["cache"])
        try:
            t0 = time.perf_counter()
            version, _ = pub.publish()
            snap = pub.materialize(base)
            leg["publish_s"] = time.perf_counter() - t0
            v0 = loop.model_version
            records.clear()
            t0 = time.perf_counter()
            loop.publish_weights(v0 + 1, {"wte.weight": snap})
            kernels.reset_launch_counts()
            reqs = [loop.submit(p, max_new_tokens=sv["new"])
                    for p in prompts[:sv["after_swap"]]]
            loop.run_until_idle()
            torch.cuda.synchronize()
            leg["swap_serve_s"] = time.perf_counter() - t0
            c = kernels.launch_counts()
            counts = {k: counts.get(k, 0) + c.get(k, 0)
                      for k in set(counts) | set(c)}
            check(loop.model_version == v0 + 1,
                  f"24(b): model_version {loop.model_version} after a "
                  f"publish from {v0}")
            got = np.stack([r.result(timeout=0) for r in reqs])
            check(len(records) == sv["after_swap"]
                  and all(r["version"] == v0 + 1 for r in records),
                  "24(b): a request after the swap ran on another version "
                  "or was dropped")
            ref = net.generate(after_prompts, max_new_tokens=sv["new"],
                               temperature=0)[:, sv["prompt"]:]
            ties = _greedy_rule(net, after_prompts, got,
                                ref.cpu().numpy(), "24(b) swap", 0.0625)
            leg.update({"version": loop.model_version,
                        "publish_version": version, "near_ties": ties})
            outs[kill] = (leg.pop("table"), leg.pop("trained_ids"), got)
            legs["killed" if kill else "fault_free"] = leg
        finally:
            _p24_close(keep["servers"], *keep["clients"])
    (ref_t, ref_ids, ref_got), (k_t, k_ids, k_got) = outs[False], outs[True]
    check(k_ids == ref_ids and np.array_equal(k_t, ref_t),
          "24(b): the killed run's table differs from the fault-free "
          f"run's ({int((k_t != ref_t).sum()) if k_t.shape == ref_t.shape else 'shape'} values)")
    check(np.array_equal(k_got, ref_got),
          "24(b): the tokens served after the two swaps differ")
    res.update(legs)
    res.update({"requests": sv["requests"], "prompt": sv["prompt"],
                "new": sv["new"], "after_swap": sv["after_swap"],
                "trained_rows": len(ref_ids),
                "table_bitwise_killed_vs_fault_free": True,
                "seconds": time.perf_counter() - t_all})
    del loop, net
    torch.cuda.empty_cache()
    log(f"[24(b) online loop] {json.dumps(res)}")
    return res, counts


def _p24_device_tier():
    """24(c): DeviceHashTable at 2 x PADDLE_PS_HETER_CACHE_ROWS x 768 f32
    on the card against the same operations through the CPU path."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed.ps.heter import DeviceHashTable
    cap = 2 * int(flags.flag("PADDLE_PS_HETER_CACHE_ROWS"))
    card = DeviceHashTable(cap, PS_DIM, device="cuda")
    host = DeviceHashTable(cap, PS_DIM, device="cpu")
    rng = np.random.RandomState(24)

    def rows(n):
        return rng.standard_normal((n, PS_DIM)).astype(np.float32)

    def same(what, probe):
        check(np.array_equal(card.keys.cpu().numpy(), host.keys.numpy())
              and len(card) == len(host), f"24(c): keys differ ({what})")
        cr, cf = card.lookup(probe)
        hr, hf = host.lookup(probe)
        check(torch.equal(cf.cpu(), hf) and torch.equal(cr.cpu(), hr),
              f"24(c): lookups differ ({what})")

    # a duplicate storm: 16 ids, 64 copies each with their own rows
    storm = np.repeat(rng.randint(0, PS_V, 16), 64)
    rng.shuffle(storm)
    ops = [("insert", storm, rows(storm.size))]
    for _ in range(4):
        ids = rng.randint(0, 4 * PS_V, 8192).astype(np.int64)
        ops.append(("insert", ids, rows(ids.size)))
        ops.append(("remove", rng.choice(ids, 2048), None))
    t0 = time.perf_counter()
    for i, (op, ids, vals) in enumerate(ops):
        if op == "insert":
            pc = card.insert(ids, vals, best_effort=True)
            ph = host.insert(ids, vals, best_effort=True)
            check(np.array_equal(pc, ph), "24(c): placed masks differ")
        else:
            card.remove(ids)
            host.remove(ids)
        same(f"op {i} {op}", rng.randint(0, 4 * PS_V, 4096))
    script_s = time.perf_counter() - t0
    # timings: lookup of 1024 ids (on the card), insert of a fresh
    # 1024-id miss set (host placement + two scatters)
    look = torch.as_tensor(rng.randint(0, 4 * PS_V, 1024), device="cuda")
    lookup = time_samples(lambda: card.lookup(look), runs=20, warmup=3)
    fresh = iter([(np.arange(1024, dtype=np.int64) + (10 + k) * PS_V * 4,
                   rows(1024)) for k in range(23)])
    done = []

    def insert():
        ids, vals = next(fresh)
        done.append((ids, vals))
        card.insert(ids, vals)

    ins = time_samples(insert, runs=20, warmup=3)
    for ids, vals in done:
        host.insert(ids, vals)
    same("after the timed inserts", np.concatenate(
        [done[0][0], done[-1][0], rng.randint(0, 4 * PS_V, 2048)]))
    res = {"capacity": cap, "dim": PS_DIM,
           "values_bytes": cap * PS_DIM * 4, "rows_resident": len(card),
           "script_ops": len(ops), "script_s": script_s,
           "lookup_1024_ms": statistics.median(lookup),
           "insert_1024_ms": statistics.median(ins),
           "keys_bitwise": True}
    log(f"[24(c) device tier] {json.dumps(res)}")
    del card, host
    torch.cuda.empty_cache()
    return res


# A PS server process of 24(d): it binds port 0 and prints its endpoint,
# reads its peers and replicates with them (one backup a shard), ships
# its monitor to the hub; on "quiesce" it stops its heartbeats, on
# "report" it drains its shipper and prints its monitor, on "stop" it
# exits.
_P24_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
from paddle_tpu_torch.core import monitor, telemetry
from paddle_tpu_torch.distributed.ps import PSServer, ShardMap
hub, member, dim = sys.argv[1], sys.argv[2], int(sys.argv[3])
srv = PSServer(tables={"wte": {"type": "geo_sparse", "dim": dim,
                               "init": "zeros"}})
ep = srv.start()
ship = telemetry.TelemetryShipper(hub, member_id=member, role="ps",
                                  flush_s=0.2, capture_spans=False,
                                  report_incidents=False).start()
print(json.dumps({"endpoint": ep}), flush=True)
peers = json.loads(sys.stdin.readline())
srv.enable_replication(shard_map=ShardMap.create(peers, n_backups=1),
                       peers=peers, n_backups=1, heartbeat_s=0.1,
                       heartbeat_timeout_s=2.0)
print("ready", flush=True)
sys.stdin.readline()
srv.replica.close()
time.sleep(0.5)
print("quiet", flush=True)
sys.stdin.readline()
ok = ship.drain(timeout=20.0)
print(json.dumps({"drained": ok, "stats": monitor.stats("")}), flush=True)
sys.stdin.readline()
ship.close(drain_timeout=0.5)
srv.shutdown()
"""


def _p24_tell(kid, line):
    """Send one line to a 24(d) server process; its one-line answer."""
    kid.stdin.write(line + "\n")
    kid.stdin.flush()
    return kid.stdout.readline()


def _p24_member_snapshot(prefixes):
    """A shipper snapshot of the monitor names under ``prefixes``: two
    members in one process ship their own names, not each other's."""
    from paddle_tpu_torch.core import monitor

    def snap():
        s = monitor.snapshot(include_series=False)
        return {"values": {n: v for n, v in s["values"].items()
                           if n.startswith(prefixes)},
                "types": {n: t for n, t in s["types"].items()
                          if n.startswith(prefixes)},
                "histograms": {n: h for n, h in s["histograms"].items()
                               if n.startswith(prefixes)}}
    return snap


def _p24_telemetry():
    """24(d): a TelemetryHub in this process; the serve loop and the
    trainer (here) and three PS servers (child processes) ship to it."""
    from paddle_tpu_torch.core import monitor, telemetry
    from paddle_tpu_torch.distributed.ps import PSClient
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    t_all = time.perf_counter()
    hub = telemetry.TelemetryHub()
    root = os.path.dirname(os.path.abspath(__file__))
    kids = [subprocess.Popen(
        [sys.executable, "-c", _P24_CHILD, hub.endpoint, f"ps{k}",
         str(PS_DIM)], cwd=root, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for k in range(3)]
    ships, client, res = [], None, {}
    try:
        eps = [json.loads(k.stdout.readline())["endpoint"] for k in kids]
        for kid in kids:
            check(_p24_tell(kid, json.dumps(eps)).strip() == "ready",
                  "24(d): a server process did not start replicating")
        ships = [telemetry.TelemetryShipper(
            hub.endpoint, member_id=m, role=m, flush_s=0.2,
            snapshot_fn=_p24_member_snapshot(p), capture_spans=False,
            report_incidents=False, rpc_opts=dict(
                timeout=1.0, max_retries=1, connect_retry_s=0.5)).start()
            for m, p in (("serve", ("serve.", "serve/")),
                         ("trainer", ("ps.", "executor/")))]
        net = GPT(GPTConfig(), device="cuda", dtype=torch.bfloat16, seed=0)
        net.eval()
        loop = ServeLoop(net, ServeConfig(max_active=8, kv_blocks=64,
                                          max_seq_len=64))
        rng = np.random.RandomState(5)
        loop.serve([rng.randint(1, 50257, 16) for _ in range(8)],
                   max_new_tokens=16)
        client = PSClient(eps, **P24_RPC)
        pulls, pushes = [], []
        for r in range(6):
            ids = np.arange(4096, dtype=np.int64) * 7 + r
            t0 = time.perf_counter()
            client.pull_sparse("wte", ids)
            pulls.append(ids.size / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            client.push_sparse_delta(
                "wte", ids, np.full((ids.size, PS_DIM), 1e-3, np.float32),
                request_key=("p24d", r))
            pushes.append(ids.size / (time.perf_counter() - t0))
        res["pull_rows_per_s"] = statistics.median(pulls)
        res["push_rows_per_s"] = statistics.median(pushes)
        for s in ships:
            check(s.drain(timeout=20.0), f"24(d): {s.member_id} did not "
                                         "drain")
        local = monitor.stats("")
        for kid in kids:
            check(_p24_tell(kid, "quiesce").strip() == "quiet",
                  "24(d): a server process did not stop its heartbeats")
        checked = {}
        for s in ships:
            got = hub.member_counters(s.member_id)
            check(got and all(v == local[n] for n, v in got.items()),
                  f"24(d): the hub's {s.member_id} counters differ from "
                  f"the local monitor's")
            checked[s.member_id] = len(got)
        for k, kid in enumerate(kids):
            rep = json.loads(_p24_tell(kid, "report"))
            got = hub.member_counters(f"ps{k}")
            check(rep["drained"] and got
                  and all(v == rep["stats"][n] for n, v in got.items()),
                  f"24(d): the hub's ps{k} counters differ from that "
                  f"server's monitor")
            checked[f"ps{k}"] = len(got)
        res["members_bitwise"] = checked
        for kid in kids:                  # the servers leave while the
            kid.stdin.write("stop\n")    # hub still answers their drain
            kid.stdin.flush()
        for kid in kids:
            kid.wait(timeout=60)
        ships.pop(0).close(drain_timeout=5.0)      # the serve member
        # the hub dies mid-run: a flush degrades to False, never raises
        hub.stop()
        ok = ships[0].flush()                       # the trainer
        check(ok is False, f"24(d): flush() against a stopped hub gave "
                           f"{ok!r}")
        res["flush_after_hub_stop"] = ok
        del loop
        # phase 21's steady spec for 2 s, scored by a hub
        hub2 = telemetry.TelemetryHub()
        try:
            rloop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                               max_seq_len=1024))
            rep, c = _replay(rloop, "steady", seconds=2.0, hub=hub2)
            check(rep.scored_by == "hub", "24(d): run_spec was not scored "
                                          "by the hub")
            snap = hub2.snapshot()
            check(int(snap["counters"].get("serve.requests_completed", 0))
                  == rep.completed, "24(d): the hub's completed count "
                                    "differs from the replay's")
            res["steady_2s"] = _traffic_line(rep, c)
        finally:
            hub2.stop()
            del rloop
        del net
    finally:
        for s in ships:
            s.close(drain_timeout=0.0)
        if client is not None:
            client.close()
        hub.stop()
        for kid in kids:
            if kid.poll() is None:
                kid.kill()
                kid.wait(timeout=30)
    res["seconds"] = time.perf_counter() - t_all
    torch.cuda.empty_cache()
    log(f"[24(d) telemetry] {json.dumps(res)}")
    return res


def phase_p24_downpour():
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    return _p24_downpour(paddle)


def phase_p24_online():
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    return _p24_online(paddle)


def phase_p24_device_tier():
    return _p24_device_tier()


def phase_p24_telemetry():
    return _p24_telemetry()


def phase_ps(card=None):
    """Phase 24: the parameter-server tier, the online loop, the device
    cache and cluster telemetry at GPT-2 small's width."""
    t0 = time.perf_counter()
    res = {"card": card, "downpour": phase_p24_downpour()}
    res["online"], counts = phase_p24_online()
    res["device_tier"] = phase_p24_device_tier()
    res["telemetry"] = phase_p24_telemetry()
    res["seconds"] = time.perf_counter() - t0
    log(f"[ps] {res['seconds']:.1f} s; card: {card}")
    return counts, res


# --------------------------------------------------------------------------
# phase 25: the serve capacity model and the collective tier
# --------------------------------------------------------------------------

P25_RANKS = 4
# 25(a)'s capacity replays cut from phase 21's 6 s and the calibration's
# refinements from 4 s to make room for phase 27: the same three specs
# and comparisons over shorter replays
P25_REPLAY_SECONDS, P25_REFINE_SECONDS = 3.0, 2.0
P25_SP_S, P25_H, P25_D = 16384, 12, 64       # ring: b 1, s 16384, GPT-2 heads
P25_MB = (1, 16, 256)                         # all_reduce sizes timed
P25_TP_D, P25_TP_F = 768, 3072                # GPT-2 small's MLP
# ring / Ulysses at sp 4 against one flash call over the whole s 16384,
# bf16: FLASH_TOL's bf16 forward limits (largest |error| over largest
# |entry|, and the error's norm over the output's): the ring merges four
# f32 blocks (each rounded to bf16 by the kernel) where the one call
# rounds once
P25_RING_TOL = {"o_max": FLASH_TOL[torch.bfloat16]["o_max"],
                "o_norm": FLASH_TOL[torch.bfloat16]["o_norm"]}
# GPT-2's MLP at tp 4 against the dense layers, f32 (no TF32): largest
# |error| over largest |entry| of the output and of each gradient; the
# tp=4 split sums the 3072-wide contraction in four partial sums
P25_TP_TOL = 1e-5
# DataParallel BERT-base, two AdamW steps (lr 1e-4) against the unwrapped
# model on the whole batch. f32: STEP_TOL (loss relative, the first step's
# gradients largest |error| over largest |entry| per tensor, parameters
# absolute). bf16 O2 (f32 masters): the loss to one bf16 step at its
# size, 7.8e-3 (logits in bf16); the masters to twice the learning rate a
# step, 4e-4 after two (Adam's first steps move an entry by +-lr whatever
# the gradient's size, so an entry whose gradient is near zero can move
# either way: O2_STEP_TOL's argument). That bound is the widest gap any
# two runs can reach, so the gradients decide. bf16 "grad" 1e-1: the bf16
# sum of two halves against one bf16 gradient of the whole batch read
# 1.27e-2 on the H100 (3.1e-2 for tiny BERT on the CPU), and a planted
# fault, a DP without the sum over ranks, 0.708 (f32: 0.699 against
# STEP_TOL's 1e-5 and a sound 1.3e-6); the phase fails if either limit
# passes that fault.
P25_DP_BF16_TOL = {"loss": 7.8e-3, "grad": 1e-1, "master": 4e-4}
P25_DP_LR = 1e-4


def _p25_counts(before, after=None):
    from paddle_tpu_torch.ops import cuda as kernels
    after = after or kernels.launch_counts()
    return {k: after[k] - before.get(k, 0) for k in after}


def _p25_spec(name, rate, seconds):
    """Phase 21's arrival shapes and bench_serve-scale tenants at
    ``rate`` requests/s for ``seconds``."""
    from paddle_tpu_torch.traffic import workload
    spec = _traffic_spec(name, seconds)
    base = workload.builtin_spec(name, rate=rate, duration_s=seconds)
    return dataclasses.replace(spec, arrival=base.arrival)


def _p25_capacity(card):
    """25(a): calibrate a DeviceProfile on the card's GPT-2 small bf16
    ServeLoop, build the analytic one from serve_evidence at the H100's
    peaks, predict phase 21's three specs with both, replay each through
    run_spec scored by a TelemetryHub; prefill FLOPs and MFU."""
    from paddle_tpu_torch.core import flags, telemetry
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.static import capacity as C
    from paddle_tpu_torch.text.models import GPT, GPTConfig
    from paddle_tpu_torch.tools.capacity_plan import score
    from paddle_tpu_torch.traffic import harness
    t0 = time.perf_counter()
    cfg = GPTConfig()
    cfg.dropout = 0.0
    net = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.eval()
    loop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                      max_seq_len=1024))
    bs = loop.stats()["block_size"]
    serve = {"max_active": 64, "kv_blocks": 512, "block_size": bs,
             "max_seq_len": 1024}
    buckets = (8, 16, 32, 64)
    kernels.reset_launch_counts()
    cal = C.calibrate(serve, loop=loop, buckets=buckets,
                      refine_specs=(_p25_spec("steady", 15.0,
                                              P25_REFINE_SECONDS),
                                    _p25_spec("steady", 45.0,
                                              P25_REFINE_SECONDS)))
    counts_cal = kernels.launch_counts()
    t_cal = time.perf_counter() - t0
    ev = C.serve_evidence(cfg, 64, fill=64, block_size=bs, blocks=512,
                          max_seq_len=1024, dtype="bfloat16", prompt=32,
                          new=40)
    ana = C.analytic_profile(ev, device="h100-sxm", buckets=buckets,
                             gpt_cfg=cfg)
    band50 = float(flags.flag("FLAGS_capacity_p50_band_pct"))
    band99 = float(flags.flag("FLAGS_capacity_p99_band_pct"))
    log(f"[capacity] calibrated on the card in {t_cal:.1f} s: "
        f"{json.dumps(cal.as_dict())}")
    log(f"[capacity] analytic h100-sxm: {json.dumps(ana.as_dict())}; "
        f"evidence {json.dumps(ev['graphs']['serve_decode']['cost_analysis'])}")
    res = {"card": card, "block_size": bs, "calibrated": cal.as_dict(),
           "analytic": ana.as_dict(), "bands_pct": [band50, band99],
           "calibration_s": t_cal, "specs": {},
           "calibration_launches": counts_cal["paged_decode_attention"],
           "calibration_launches_sm90":
               counts_cal["paged_decode_attention.sm90"]}
    counts = {}
    for name in ("steady", "diurnal", "flash"):
        spec = _traffic_spec(name, P25_REPLAY_SECONDS)
        preds = {tag: C.predict(spec, 0, prof, slots=64, kv_blocks=512,
                                block_size=bs)
                 for tag, prof in (("calibrated", cal), ("analytic", ana))}
        hub = telemetry.TelemetryHub(eval_s=5.0)
        before = kernels.launch_counts()
        try:
            rep = harness.run_spec(spec, seed=0, loop=loop, hub=hub)
        finally:
            hub.stop()
        counts[name] = _p25_counts(before)
        check(rep.errors == 0, f"capacity {name}: {rep.errors} failed")
        check(rep.completed == rep.events > 0,
              f"capacity {name}: {rep.completed} of {rep.events} completed")
        check(rep.scored_by == "hub", f"capacity {name}: scored by "
                                      f"{rep.scored_by}")
        row = {"observed": {"throughput_rps": rep.throughput_rps,
                            "ttft_ms": rep.ttft_ms,
                            "token_ms": rep.token_ms,
                            "completed": rep.completed,
                            "events": rep.events, "errors": rep.errors,
                            "scored_by": rep.scored_by},
               "paged_launches": counts[name]["paged_decode_attention"]}
        for tag, p in preds.items():
            errs, ok = score(p, rep, band50, band99)
            row[tag] = {"predicted": {k: p[k] for k in
                                      ("throughput_rps", "ttft_ms",
                                       "token_ms", "knee_rps", "rho")},
                        "err_pct": errs, "in_band": ok}
        res["specs"][name] = row
        log(f"[capacity] {name}: {json.dumps(row)}")
    for tag in ("calibrated", "analytic"):
        worst50 = max((e or 0.0) for r in res["specs"].values()
                      for k, e in r[tag]["err_pct"].items()
                      if not k.endswith("p99"))
        worst99 = max((e or 0.0) for r in res["specs"].values()
                      for k, e in r[tag]["err_pct"].items()
                      if k.endswith("p99"))
        res[f"{tag}_headroom_x"] = min(band50 / max(worst50, 1e-9),
                                       band99 / max(worst99, 1e-9))
        res[f"{tag}_in_band"] = all(r[tag]["in_band"]
                                    for r in res["specs"].values())
    # prefill FLOPs (the registry over GPT-2's Program) and the bare
    # forward's MFU at each bucket
    pf = {}
    for b in (8, 16, 32, 64, 128):
        flops = C.prefill_flops(b, cfg)
        ids = torch.randint(0, 50257, (1, b), device="cuda")
        with torch.no_grad():
            ms = time_ms(lambda: net(ids), runs=20)
        pf[b] = {"flops": flops, "forward_ms": ms,
                 "mfu": flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
                 "calibrated_prefill_ms": cal.prefill_ms.get(b)}
    res["prefill"] = pf
    log(f"[capacity] prefill FLOPs and MFU over 989 TFLOP/s: "
        f"{json.dumps(pf)}")
    log(f"[capacity] bands p50 {band50:g}% / p99 {band99:g}% "
        f"(FLAGS_capacity_*_band_pct); headroom calibrated "
        f"{res['calibrated_headroom_x']:.3f}"
        f" (in band: {res['calibrated_in_band']}), analytic "
        f"{res['analytic_headroom_x']:.3f} (in band: "
        f"{res['analytic_in_band']}); {time.perf_counter() - t0:.1f} s")
    loop.stop()
    del loop, net
    torch.cuda.empty_cache()
    return res, counts


def _p25_battery_expected(n=4, k=8):
    """numpy's result of ``testing.spmd.collectives_battery`` for each
    rank."""
    x = [np.arange(k, dtype=np.float32) + 3 * r for r in range(n)]
    sg = [np.asarray([r - 1.0, 2.0, -1.0, 0.0 if r == 2 else 1.5],
                     np.float32) for r in range(n)]
    rs = [np.arange(4 * n, dtype=np.float32) * (i + 1) for i in range(n)]
    sub = [0, 1, 2]
    exp = []
    for r in range(n):
        e = {"all_reduce_sum": sum(x), "all_reduce_max": np.max(x, 0),
             "all_reduce_min": np.min(x, 0), "all_reduce_avg": sum(x) / n,
             "all_reduce_prod": np.prod(sg, 0),
             "subgroup_sum": sum(x[i] for i in sub) if r in sub else x[r],
             "subgroup_max": np.max([x[i] for i in sub], 0)
             if r in sub else x[r],
             "subgroup_prod": np.prod([sg[i] for i in sub], 0)
             if r in sub else sg[r],
             "all_gather": np.stack(x),
             "reduce": sum(x) if r == 1 else x[r],
             "reduce_scatter": np.sum(rs, 0)[4 * r:4 * r + 4],
             "reduce_scatter_max": np.max(rs, 0)[4 * r:4 * r + 4],
             "reduce_scatter_avg": (np.sum(rs, 0) / n)[4 * r:4 * r + 4],
             "reduce_scatter_prod": np.prod(sg, 0)[r:r + 1],
             "reduce_scatter_via_all_reduce":
                 np.sum(rs, 0)[4 * r:4 * r + 4],
             "alltoall": np.stack([np.arange(n * 3, dtype=np.float32)
                                   .reshape(n, 3)[r] + 100 * i
                                   for i in range(n)]),
             "broadcast": x[3], "broadcast_sub": x[2] if r else x[0],
             "scatter": np.arange(n * 2, dtype=np.float32)
             .reshape(n, 2)[r] + 10,
             "ppermute": x[(r - 1) % n],
             "send_recv": x[r - 1] if r % 2 else np.zeros(k, np.float32),
             "hierarchical_sum": sum(x),
             "hierarchical_avg": (sum(x) / n)[:5],
             "hierarchical_max": np.max(x, 0),
             "gather_dp_pod": np.stack([x[0], x[2], x[1], x[3]])}
        exp.append(e)
    return exp


def _p25_child_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def p25_ranks_body():
    """One of the 4 ranks on the card: the transport probe, the
    collective battery on CUDA tensors, all_reduce timed at P25_MB, ring
    and Ulysses attention at sp 4 (s 16384, bf16), GPT-2's MLP at tp 4."""
    _p25_child_setup()
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import ring_attention as R
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.testing import spmd
    r, n = M.world_rank(), M.world_size()
    out = {"transport": C.probe_transport(torch.device("cuda", 0))}
    staged0 = monitor.stat_get("dist.staged_bytes")
    out["battery"] = spmd.collectives_battery()
    out["battery_staged_bytes"] = monitor.stat_get("dist.staged_bytes") \
        - staged0
    # all_reduce at 1, 16, 256 MB of f32, host clock around synced calls
    mesh = M.init_mesh({"dp": n})
    times = {}
    with M.MeshGuard(mesh):
        for mb in P25_MB:
            x = torch.ones(mb * 2 ** 18, device="cuda")
            C.barrier()
            ts = []
            for i in range(4):
                torch.cuda.synchronize()
                C.barrier()
                t = time.perf_counter()
                y = C._allreduce_raw(x, axis="dp", op="sum")
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1e3)
                if i == 0:
                    check(bool((y == n).all()), f"all_reduce {mb} MB wrong")
            times[mb] = statistics.median(ts[1:])
    out["all_reduce_ms"] = times
    # ring and Ulysses attention: global q, k, v from one seed on every
    # rank; rank r holds s/n of them
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(1, P25_H, P25_SP_S, P25_D, device="cuda",
                           dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    sp = M.init_mesh({"sp": n}, name="sp")
    ring = {}
    for mode in ("ring", "ulysses"):
        for causal in (False, True):
            tag = f"{mode}_causal{int(causal)}"
            R.sequence_parallel_attention(q, k, v, mesh=sp, causal=causal,
                                          mode=mode)    # warm
            R.reset_ring_stats()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            C.barrier()
            t = time.perf_counter()
            o = R.sequence_parallel_attention(q, k, v, mesh=sp,
                                              causal=causal, mode=mode)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            cnt = kernels.launch_counts()
            rec = {"ms": ms, "stats": R.ring_stats(),
                   "flash_fwd": cnt["flash_fwd"],
                   "flash_fwd_sm90": cnt["flash_fwd.sm90"]}
            if r == 0:
                from paddle_tpu_torch.ops.cuda.flash_attention import \
                    flash_attention
                ref = flash_attention(q, k, v, causal=causal)
                err = (o.float() - ref.float())
                rec["o_max"] = float(err.abs().max()
                                     / ref.float().abs().max())
                rec["o_norm"] = float(err.norm() / ref.float().norm())
            ring[tag] = rec
    out["ring"] = ring
    del q, k, v
    # GPT-2's MLP at tp 4, f32: Column (768 -> 3072, no gather) + GELU +
    # Row (3072 -> 768), forward and backward, against the dense layers
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import meta_parallel as MP
    tpm = M.init_mesh({"tp": n}, name="tp")
    g = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(8, 128, P25_TP_D, device="cuda", generator=g)
    wc = torch.randn(P25_TP_D, P25_TP_F, device="cuda", generator=g) * 0.02
    bc = torch.randn(P25_TP_F, device="cuda", generator=g) * 0.02
    wr = torch.randn(P25_TP_F, P25_TP_D, device="cuda", generator=g) * 0.02
    br = torch.randn(P25_TP_D, device="cuda", generator=g) * 0.02
    ct = torch.randn(8, 128, P25_TP_D, device="cuda", generator=g)
    with M.MeshGuard(tpm):
        col = MP.ColumnParallelLinear(P25_TP_D, P25_TP_F, gather_output=False)
        row = MP.RowParallelLinear(P25_TP_F, P25_TP_D, input_is_parallel=True)
    sl = slice(r * P25_TP_F // n, (r + 1) * P25_TP_F // n)
    with torch.no_grad():
        col.inner.weight.copy_(wc[:, sl])
        col.inner.bias.copy_(bc[sl])
        row.inner.weight.copy_(wr[sl])
        row.bias.copy_(br)
    xt = x.clone().requires_grad_()
    outp = M.shard_map(lambda xl: row(nn.functional.gelu(col(xl))),
                       mesh=tpm, in_specs=(M.P(),), out_specs=M.P())(xt)
    (outp * ct).sum().backward()
    shards = {"dwc": col.inner.weight.grad, "dbc": col.inner.bias.grad,
              "dwr": row.inner.weight.grad}
    gathered = {}
    with M.MeshGuard(tpm):
        for key, dim in (("dwc", 1), ("dbc", 0), ("dwr", 0)):
            parts = []
            C.all_gather(parts, shards[key].contiguous(), group="tp")
            gathered[key] = torch.cat(parts, dim)
    tp_err = {}
    if r == 0:
        ws = [t.clone().requires_grad_() for t in (wc, bc, wr, br)]
        xd = x.clone().requires_grad_()
        dense = torch.nn.functional.linear(torch.nn.functional.gelu(
            xd @ ws[0] + ws[1]), ws[2].t(), ws[3])
        (dense * ct).sum().backward()

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())
        tp_err = {"out": rel(outp.detach(), dense.detach()),
                  "dx": rel(xt.grad, xd.grad),
                  "dwc": rel(gathered["dwc"], ws[0].grad),
                  "dbc": rel(gathered["dbc"], ws[1].grad),
                  "dwr": rel(gathered["dwr"], ws[2].grad),
                  "dbr": rel(row.bias.grad, ws[3].grad)}
    out["tp"] = tp_err
    out["staged_bytes"] = monitor.stat_get("dist.staged_bytes")
    M.reset_mesh()
    return out


def _p25_mlm_tokens(bert):
    """BERT-base's MLM head as per-token losses (the fused CE kernels,
    reduction "none"), so that DataParallel gathers per-token outputs and
    the loss is taken on the global batch."""
    from paddle_tpu_torch import nn, ops
    from paddle_tpu_torch.nn import functional as F

    class MLMTokens(nn.Layer):
        def __init__(self, b):
            super().__init__()
            self.bert = b

        def forward(self, ids, lab):
            b = self.bert
            h = b.encoder(b.embeddings(ids))
            t = b.mlm_norm(ops.gelu(b.mlm_transform(h)))
            return F.fused_linear_cross_entropy(
                t, b.embeddings.word_embeddings.weight, b.mlm_bias, lab,
                ignore_index=-100, reduction="none")
    return MLMTokens(bert)


def _p25_valid(lab):
    return (lab.reshape(-1) != -100).sum().float().clamp_min(1.0)


def _p25_dp_run(dtype, ids, lab, dp, steps=2, valid=None):
    """``steps`` AdamW steps of BERT-base (dropout 0) on ``ids`` /
    ``lab``, through DataParallel when ``dp`` or unwrapped: losses, step
    ms, the first step's gradients, the parameters (f32 masters for bf16)
    and, for dp, the gradient all-reduce's bytes. The loss is the tokens'
    sum over ``valid`` (the batch's own count of labelled tokens by
    default)."""
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig.bert_base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    net = Bert(cfg, device="cuda", dtype=torch.float32, seed=0)
    net.to(dtype=dtype)
    valid = _p25_valid(lab) if valid is None else valid
    net.train()
    opt = AdamW(learning_rate=P25_DP_LR, weight_decay=0.01,
                parameters=net.named_parameters(),
                multi_precision=dtype != torch.float32)
    head = _p25_mlm_tokens(net)
    model = DataParallel(head) if dp else head
    losses, ms = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = model(ids, lab).sum() / valid
        loss.backward()
        _zero_missing_grads(net)
        opt.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if step == 0:       # the step leaves the gradients as they were
            grads = {kk: p.grad.detach().clone()
                     for kk, p in net.named_parameters()}
        opt.clear_grad()
        losses.append(float(loss.detach()))
    if dtype == torch.float32:
        params = {kk: p.detach().clone() for kk, p in net.named_parameters()}
    else:
        params = {kk: opt._slots[kk]["master"].clone()
                  for kk, _ in net.named_parameters()
                  if "master" in opt._slots.get(kk, {})}
    return {"losses": losses, "ms": ms, "params": params, "grads": grads,
            "allreduce_bytes": model.allreduce_bytes if dp else 0}


def _p25_grad_err(got, want):
    """The largest over parameters of each gradient's largest |error|
    over its largest |entry| (0 where both are all zero)."""
    err = 0.0
    for kk, w in want.items():
        scale = float(w.float().abs().max())
        diff = float((got[kk].float() - w.float()).abs().max())
        err = max(err, diff / scale if scale else diff)
    return err


def p25_dp_body():
    """One of the 2 dp ranks: DataParallel BERT-base, the flagship's b32
    s128 split 16 / 16, two AdamW steps in f32 and in bf16 O2; rank 0 then
    runs the unwrapped model on the whole batch from the same state and
    compares, and takes the first step's gradients of a planted fault: a
    DP that does not sum over ranks, whose rank 0 holds the gradient of
    its 16 rows alone."""
    _p25_child_setup()
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import BertConfig
    C.probe_transport(torch.device("cuda", 0))
    M.init_mesh({"dp": M.world_size()})
    ids, lab = _bert_batches(BertConfig.bert_base(), 32, 128, 1)
    ids, lab = ids[0], lab[0]
    out = {"rank": M.world_rank()}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kernels.reset_launch_counts()
        staged = monitor.stat_get("dist.staged_bytes")
        dp = _p25_dp_run(dt, ids, lab, True)
        rec = {"losses": dp["losses"], "step_ms": dp["ms"],
               "allreduce_bytes": dp["allreduce_bytes"],
               "staged_bytes": monitor.stat_get("dist.staged_bytes")
               - staged, "launches": kernels.launch_counts()}
        if M.world_rank() == 0:
            ref = _p25_dp_run(dt, ids, lab, False)
            rec["grad_err"] = _p25_grad_err(dp["grads"], ref["grads"])
            half = _p25_dp_run(dt, ids[:16], lab[:16], False, steps=1,
                               valid=_p25_valid(lab))
            rec["fault_grad_err"] = _p25_grad_err(half["grads"],
                                                  ref["grads"])
            del half
            rec["ref_losses"] = ref["losses"]
            rec["ref_step_ms"] = ref["ms"]
            rec["param_max_abs_diff"] = max(
                float((dp["params"][kk] - ref["params"][kk]).abs().max())
                for kk in ref["params"])
            rec["n_params_compared"] = len(ref["params"])
        out[name] = rec
        del dp
        torch.cuda.empty_cache()
    M.reset_mesh()
    return out


def _p25_recompute():
    """25(d): one GPT-2 small block (bf16, b 1, s 1024) forward and
    backward with and without ``recompute``: the gradients equal, the
    flash forward launched twice as often."""
    from paddle_tpu_torch.distributed import recompute
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import GPTConfig
    from paddle_tpu_torch.text.models.gpt import GPTBlock
    from paddle_tpu_torch.device import device_scope
    cfg = GPTConfig()
    cfg.dropout = 0.0
    with device_scope("cuda"):
        torch.manual_seed(0)
        blk = GPTBlock(cfg).to(dtype=torch.bfloat16)
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(1, 1024, 768, device="cuda", dtype=torch.bfloat16,
                    generator=g)
    ct = torch.randn(1, 1024, 768, device="cuda", dtype=torch.bfloat16,
                     generator=g)
    res = {}
    for rec in (False, True):
        for p in blk.parameters():
            p.grad = None
        xt = x.clone().requires_grad_()
        kernels.reset_launch_counts()
        y = recompute(blk, xt) if rec else blk(xt)
        (y.float() * ct.float()).sum().backward()
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        res[rec] = ({k: p.grad.detach().clone()
                     for k, p in blk.named_parameters()},
                    xt.grad.detach().clone(),
                    {k: c[k] for k in ("flash_fwd", "flash_fwd.sm90",
                                       "flash_bwd_dq", "flash_bwd_dkv")})
    diff = max(float((res[True][0][k] - res[False][0][k]).abs().max())
               for k in res[False][0])
    diff = max(diff, float((res[True][1] - res[False][1]).abs().max()))
    out = {"grad_max_abs_diff": diff, "launches_plain": res[False][2],
           "launches_recompute": res[True][2]}
    log(f"[recompute] GPT-2 block bf16 s1024: {json.dumps(out)}")
    check(diff == 0.0, f"recompute changed the gradients by {diff}")
    check(res[True][2]["flash_fwd"] == 2 * res[False][2]["flash_fwd"] > 0,
          f"recompute's flash forwards: {res[True][2]} against "
          f"{res[False][2]}")
    return out, res[True][2]


def phase_distributed(card=None):
    """Phase 25: the capacity model (a), then 4 ranks on the card: the
    collective battery (b), ring and Ulysses attention (c), the TP MLP
    (d); 2 ranks: DataParallel BERT-base (d); recompute (d). Returns the
    paths' launch counts (children's summed) and the results."""
    import tempfile

    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    from paddle_tpu_torch.testing import spmd
    t0 = time.perf_counter()
    res = {"card": card}
    res["capacity"], cap_counts = _p25_capacity(card)
    t_ranks = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spmd.run_ranks(p25_ranks_body, P25_RANKS, tmp_path=tmp,
                               device="cuda", timeout=600)
    res["ranks_s"] = time.perf_counter() - t_ranks
    tr = ranks[0]["transport"]
    log(f"[collectives] transport on {torch.__version__} gloo, 4 ranks on "
        f"one card: {json.dumps(tr)}")
    exp = _p25_battery_expected(P25_RANKS)
    bad = [(r, k) for r in range(P25_RANKS) for k, v in exp[r].items()
           if not np.array_equal(np.asarray(ranks[r]["battery"][k]), v)]
    check(not bad, f"collective battery differs from numpy: {bad[:5]}")
    log(f"[collectives] battery on CUDA tensors: {len(exp[0])} cases x "
        f"{P25_RANKS} ranks exact; staged bytes a rank "
        f"{ranks[0]['battery_staged_bytes']:.0f}")
    ar = {mb: max(r["all_reduce_ms"][mb] for r in ranks) for mb in P25_MB}
    res["collectives"] = {
        "transport": tr, "battery_cases": len(exp[0]),
        "all_reduce_ms": ar,
        "all_reduce_transport": tr.get("all_reduce"),
        "all_reduce_gbps": {mb: mb * 2 ** 20 / (ms / 1e3) / 1e9
                            for mb, ms in ar.items()}}
    log(f"[collectives] all_reduce f32 over 4 ranks ({tr.get('all_reduce')}"
        f" through gloo): {json.dumps(res['collectives']['all_reduce_ms'])}"
        f" ms")
    # (c) the ring against one flash call over the whole sequence here
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(1, P25_H, P25_SP_S, P25_D, device="cuda",
                           dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    single = {c: time_ms(lambda c=c: flash_attention(q, k, v, causal=c),
                         runs=10) for c in (False, True)}
    del q, k, v
    ring = {}
    for tag, rec0 in ranks[0]["ring"].items():
        causal = tag.endswith("1")
        per = [r["ring"][tag] for r in ranks]
        ring[tag] = {"ms": max(p["ms"] for p in per),
                     "transport": {"p2p": tr.get("p2p")} if
                     tag.startswith("ring") else
                     {"all_to_all": tr.get("all_to_all")},
                     "single_flash_ms": single[causal],
                     "o_max": rec0["o_max"], "o_norm": rec0["o_norm"],
                     "flash_fwd_per_rank": [p["flash_fwd"] for p in per],
                     "flash_fwd_sm90_per_rank":
                         [p["flash_fwd_sm90"] for p in per],
                     "skipped_per_rank": [p["stats"]["skipped"]
                                          for p in per]}
        log(f"[ring] sp 4 x s {P25_SP_S // 4} bf16 h12 d64 {tag}: "
            f"{json.dumps(ring[tag])}")
        check(rec0["o_max"] <= P25_RING_TOL["o_max"]
              and rec0["o_norm"] <= P25_RING_TOL["o_norm"],
              f"{tag} differs from the single flash call: {rec0}")
        check(ring[tag]["flash_fwd_sm90_per_rank"]
              == ring[tag]["flash_fwd_per_rank"],
              f"{tag}: a flash launch off the Hopper kernel")
    check(ring["ring_causal1"]["skipped_per_rank"] == [3, 2, 1, 0],
          "the causal ring skipped other steps than the later ranks'")
    check(ring["ring_causal1"]["flash_fwd_per_rank"] == [1, 2, 3, 4]
          and ring["ring_causal0"]["flash_fwd_per_rank"] == [4] * 4,
          "the ring's flash launches a rank")
    res["ring"] = ring
    tp_err = ranks[0]["tp"]
    log(f"[tp] GPT-2 MLP 768 -> 3072 -> 768 at tp 4, f32, b8 s128 against "
        f"the dense layers (largest |error| / largest |entry|, tol "
        f"{P25_TP_TOL:g}): {json.dumps(tp_err)}")
    check(max(tp_err.values()) <= P25_TP_TOL, f"TP MLP differs: {tp_err}")
    res["tp"] = tp_err
    res["staged_bytes_per_rank"] = [r["staged_bytes"] for r in ranks]
    # DataParallel BERT-base over dp 2
    t_dp = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dps = spmd.run_ranks(p25_dp_body, 2, tmp_path=tmp, device="cuda",
                             timeout=600)
    dp0 = dps[0]
    res["dp_s"] = time.perf_counter() - t_dp
    res["dp"] = {}
    for name in ("f32", "bf16"):
        rec = dp0[name]
        lrel = max(abs(a - b) / abs(b) for a, b in
                   zip(rec["losses"], rec["ref_losses"]))
        labs = max(abs(a - b) for a, b in
                   zip(rec["losses"], rec["ref_losses"]))
        res["dp"][name] = {
            "losses": rec["losses"], "ref_losses": rec["ref_losses"],
            "loss_rel_diff": lrel, "loss_abs_diff": labs,
            "param_max_abs_diff": rec["param_max_abs_diff"],
            "params_compared": rec["n_params_compared"],
            "grad_err": rec["grad_err"],
            "fault_grad_err": rec["fault_grad_err"],
            "step_ms": rec["step_ms"], "ref_step_ms": rec["ref_step_ms"],
            "allreduce_bytes": rec["allreduce_bytes"],
            "staged_bytes": rec["staged_bytes"],
            "allreduce_transport": tr.get("all_reduce")}
        log(f"[dp] BERT-base {name} b32 s128 as 16 / 16 over dp 2, two "
            f"AdamW steps: {json.dumps(res['dp'][name])}")
    f32 = res["dp"]["f32"]
    check(f32["loss_rel_diff"] <= STEP_TOL["loss"]
          and f32["grad_err"] <= STEP_TOL["grad"]
          and f32["param_max_abs_diff"] <= STEP_TOL["param"],
          f"DP f32 differs from the whole-batch step: {f32}")
    b16 = res["dp"]["bf16"]
    check(b16["loss_abs_diff"] <= P25_DP_BF16_TOL["loss"]
          and b16["grad_err"] <= P25_DP_BF16_TOL["grad"]
          and b16["param_max_abs_diff"] <= P25_DP_BF16_TOL["master"],
          f"DP bf16 differs from the whole-batch step: {b16}")
    # the gradient limits must tell the planted fault (no sum over dp)
    # from a sound run
    check(f32["fault_grad_err"] > STEP_TOL["grad"]
          and b16["fault_grad_err"] > P25_DP_BF16_TOL["grad"],
          "the DP gradient limits pass a DP without the sum over ranks")
    res["recompute"], rc_counts = _p25_recompute()
    # the paths' launches: the capacity replays and calibration here, the
    # ranks' ring / Ulysses calls and DP steps summed
    counts = {"capacity": {k: sum(c[k] for c in cap_counts.values())
                           for k in kernels.launch_counts()},
              "ring": {}, "dp": {}, "recompute": rc_counts}
    for tag in ring:
        counts["ring"][tag] = {"flash_fwd": sum(ring[tag][
            "flash_fwd_per_rank"]), "flash_fwd.sm90": sum(ring[tag][
                "flash_fwd_sm90_per_rank"])}
    for name in ("f32", "bf16"):
        counts["dp"][name] = {k: sum(d[name]["launches"][k] for d in dps)
                              for k in dps[0][name]["launches"]}
    b16c = counts["dp"]["bf16"]
    for kname in CE_KERNELS + FLASH_KERNELS:
        check(b16c[kname] > 0 and b16c[f"{kname}.sm90"] == b16c[kname],
              f"DP bf16: {kname} launched {b16c[kname]} times, "
              f"{b16c[kname + '.sm90']} on the Hopper kernel")
    check(counts["capacity"]["paged_decode_attention"] > 0,
          "the capacity replays launched no paged kernel")
    res["seconds"] = time.perf_counter() - t0
    log(f"[distributed] phase 25 {res['seconds']:.1f} s (capacity "
        f"{t_ranks - t0:.1f}, 4 ranks {res['ranks_s']:.1f}, dp "
        f"{res['dp_s']:.1f}); card: {card}")
    return counts, res


# --------------------------------------------------------------------------
# phase 26: training across processes (pipeline, ring backward, MoE, sync
# BN, fleet Model.fit with ZeRO and LocalSGD)
# --------------------------------------------------------------------------

P26_RANKS = 4
P26_FIT_STEPS, P26_LSGD_STEPS, P26_LSGD_K = 3, 4, 2
P26_PP_MICRO, P26_PP_B, P26_PP_S = 4, 8, 1024     # GPT-2 small at pp 4
P26_MOE = {"d_model": 768, "d_ff": 3072, "experts": 8, "cf": 1.25,
           "b": 2, "s": 512}                      # google/switch-base-8
P26_BN = (8, 64, 56, 56)                          # ResNet-50's first BN
# the pipeline against the whole model in one process over the same
# micro-batches: the same ops a micro-batch, so the loss to f32 rounding;
# the gradients differ by the order each parameter's micro-batch
# contributions accumulate in: f32 as GPT_STEP_TOL's gradients, bf16 to
# a few bf16 ulps of the largest entry (2^-8 each)
P26_PP_TOL = {torch.float32: {"loss": 1e-5, "grad": 2e-5},
              torch.bfloat16: {"loss": 1e-5, "grad": 5e-2}}
# the ring's and Ulysses' forward and dq / dk / dv against one flash
# forward and backward over the whole s 16384, bf16 (largest |error| over
# largest |entry|, and the norms' ratio): the forward to P25_RING_TOL; the
# gradients to twice FLASH_TOL's bf16 limits, since dq sums four blocks'
# bf16-rounded partials where the one call rounds once
P26_RING_GRAD_TOL = {"max": 2e-2, "norm": 1e-2}
# MoE at ep 4 against the dense layer over each rank's tokens, f32 (no
# TF32): largest |error| over largest |entry|, outputs and gradients (the
# expert matmuls batched over other expert counts)
P26_MOE_TOL = 1e-5
# synchronized BN against one BN over the concatenated batch, f32: the
# moments are the mean of four ranks' means
P26_BN_TOL = 1e-5


def _p26_rel(a, b):
    a, b = a.float(), b.float()
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / scale if scale else diff


def _p26_norm(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _p26_counts():
    from paddle_tpu_torch.ops import cuda as kernels
    c = kernels.launch_counts()
    return {k: c[k] for k in PATH_KERNELS + SM90_COUNTS + CE_SM90_COUNTS}


def _p26_sync_ms(fn, runs=3):
    from paddle_tpu_torch.distributed import collective as C
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        C.barrier()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def _p26_pipeline(dtype):
    """26(b) on this rank: GPT-2 small's 12 blocks at pp 4 (3 a stage; the
    embedding before, ln_f and the tied head's fused CE after, on the last
    stage), b8 s1024 in 4 micro-batches, one forward and backward in each
    schedule; the whole model in this process over the same micro-batches
    as the reference."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import pipeline as PL
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.text.models import GPT, GPTConfig
    r, n = M.world_rank(), M.world_size()
    cfg = GPTConfig()
    cfg.dropout = 0.0
    net = GPT(cfg, device="cuda", dtype=dtype, seed=0)
    ids, lab = _lm_batch(50257, P26_PP_B, P26_PP_S, seed=1)
    ids_m = PL.micro_batch(ids, P26_PP_MICRO)
    lab_m = PL.micro_batch(lab, P26_PP_MICRO)
    shared = [net.wte.weight, net.wpe.weight, net.ln_f.weight,
              net.ln_f.bias]

    def zero():
        for p in net.parameters():
            p.grad = None

    def embed(i):
        pos = torch.arange(i.shape[1], device="cuda")
        return net.wte(i) + net.wpe(pos)

    def head(h, lbl):
        return F.fused_linear_cross_entropy(net.ln_f(h), net.wte.weight,
                                            None, lbl, ignore_index=-100)

    zero()
    ref_loss = sum(net(ids_m[m], lab_m[m]) for m in range(P26_PP_MICRO)) \
        / P26_PP_MICRO
    ref_loss.backward()
    ref = {i: p.grad.detach().clone() for i, p in
           enumerate(net.parameters())}
    ref_loss = float(ref_loss)
    mesh = M.init_mesh({"pp": n}, name="pp")
    owned = {"gpipe": [net.blocks[3 * r + j] for j in range(3)],
             "interleaved": [net.blocks[c * n + r] for c in range(3)]}
    out = {}
    for sched in ("gpipe", "1f1b", "interleaved"):
        zero()
        blocks = owned["interleaved" if sched == "interleaved" else "gpipe"]
        with M.MeshGuard(mesh):
            x_m = torch.stack([embed(ids_m[m])
                               for m in range(P26_PP_MICRO)])
            before = _p26_counts()
            torch.cuda.synchronize()
            C.barrier()
            t = time.perf_counter()
            if sched == "interleaved":
                loss = PL.pipeline_loss(list(blocks), head, x_m, lab_m,
                                        "pp", schedule="interleaved")
            else:
                stage = torch.nn.Sequential(*blocks)
                loss = PL.pipeline_loss(stage, head, x_m, lab_m, "pp",
                                        schedule=sched)
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            after = _p26_counts()
            # the replicated embedding, ln_f and tied head: each rank holds
            # its part of their gradients; the sum over pp is theirs
            for p in shared:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = g.detach().contiguous()
                C._all_reduce_(g, mesh.group("pp")[0])
                p.grad = g
        errs = {}
        mine = {id(p) for b in blocks for p in b.parameters()} \
            | {id(p) for p in shared}
        for i, p in enumerate(net.parameters()):
            if id(p) in mine:
                errs[i] = _p26_rel(p.grad, ref[i])
        out[sched] = {"loss": float(loss), "ref_loss": ref_loss,
                      "loss_rel": abs(float(loss) - ref_loss) / abs(ref_loss),
                      "grad_err": max(errs.values()),
                      "params_compared": len(errs), "ms": ms,
                      "launches": {k: after[k] - before[k] for k in after}}
    M.reset_mesh("pp")
    zero()
    del net
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    return out


def _p26_ring():
    """26(c) on this rank: ring and Ulysses attention at sp 4 (s 4096 a
    rank, h12 d64, bf16), forward and backward through
    ``sequence_parallel_attention`` against one flash forward and backward
    over s 16384 (rank 0), the flash launches of the call; then ms of a
    rank's own forward and backward inside the region."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import ring_attention as R
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    r, n = M.world_rank(), M.world_size()
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, P25_H, P25_SP_S, P25_D, device="cuda",
                               dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    sp = M.init_mesh({"sp": n}, name="sp26")
    out = {}
    for mode in ("ring", "ulysses"):
        for causal in (False, True):
            tag = f"{mode}_causal{int(causal)}"
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            before = _p26_counts()
            o = R.sequence_parallel_attention(*ts, mesh=sp, causal=causal,
                                              mode=mode)
            o.backward(do)
            torch.cuda.synchronize()
            after = _p26_counts()
            rec = {"launches": {kk: after[kk] - before[kk] for kk in after}}
            if r == 0:
                rs = [t.clone().requires_grad_() for t in (q, k, v)]
                ro = flash_attention(*rs, causal=causal)
                ro.backward(do)
                for name, got, want in (("o", o, ro), ("dq", ts[0].grad,
                                                       rs[0].grad),
                                        ("dk", ts[1].grad, rs[1].grad),
                                        ("dv", ts[2].grad, rs[2].grad)):
                    rec[f"{name}_max"] = _p26_rel(got.detach(), want.detach())
                    rec[f"{name}_norm"] = _p26_norm(got.detach(),
                                                    want.detach())
            # a rank's own shard, forward and backward inside the region
            lo = r * (P25_SP_S // n)
            loc = [t[:, :, lo:lo + P25_SP_S // n].contiguous()
                   .requires_grad_() for t in (q, k, v)]
            dl = do[:, :, lo:lo + P25_SP_S // n].contiguous()
            fn = R.ring_attention if mode == "ring" else R.ulysses_attention

            def step():
                with M.MeshGuard(sp):
                    fn(*loc, axis="sp", causal=causal).backward(dl)
            step()
            rec["ms"] = _p26_sync_ms(step)
            out[tag] = rec
    if r == 0:      # one flash forward + backward over the whole sequence
        single = [t.clone().requires_grad_() for t in (q, k, v)]
        for causal in (False, True):
            def whole():
                flash_attention(*single, causal=causal).backward(do)
            whole()
            out[f"single_causal{int(causal)}_ms"] = time_ms(whole, runs=10)
    C.barrier()
    M.reset_mesh("sp26")
    del q, k, v, do
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    return out


def _p26_moe():
    """26(d) on this rank: Switch-Base-8's MoE FFN at ep 4 (2 experts a
    rank) over this rank's b2 s512 tokens, f32, forward and backward,
    against the dense layer (all 8 experts) over the same tokens; the
    experts' gradients summed over ranks for the comparison."""
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.moe import MoELayer
    from paddle_tpu_torch.device import device_scope
    r, n = M.world_rank(), M.world_size()
    cfg = P26_MOE
    d, f, e = cfg["d_model"], cfg["d_ff"], cfg["experts"]
    with device_scope("cuda"):
        dense = MoELayer(d, f, e, capacity_factor=cfg["cf"], axis="ep")
        ep = M.init_mesh({"ep": n}, name="ep26")
        with M.MeshGuard(ep):
            moe = MoELayer(d, f, e, capacity_factor=cfg["cf"], axis="ep")
    g = torch.Generator("cuda").manual_seed(3)
    el = e // n
    with torch.no_grad():
        for name, scale in (("w_up", 0.02), ("b_up", 0.02),
                            ("w_down", 0.02), ("b_down", 0.02)):
            full = getattr(dense, name)
            full.copy_(torch.randn(full.shape, device="cuda", generator=g)
                       * scale)
            getattr(moe, name).copy_(full[r * el:(r + 1) * el])
        dense.gate.weight.copy_(torch.randn(d, e, device="cuda",
                                            generator=g) * 0.02)
        moe.gate.weight.copy_(dense.gate.weight)
    gx = torch.Generator("cuda").manual_seed(100 + r)
    x = torch.randn(cfg["b"], cfg["s"], d, device="cuda", generator=gx)
    ct = torch.randn(cfg["b"], cfg["s"], d, device="cuda", generator=gx)
    dropped = monitor.stat_get("moe.dropped_tokens")
    staged = monitor.stat_get("dist.staged_bytes")
    a2a = monitor.stat_get("dist.all_to_all_bytes")
    xe = x.clone().requires_grad_()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with M.MeshGuard(ep):
        ye = moe(xe)
        (ye * ct).sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    out = {"dropped": monitor.stat_get("moe.dropped_tokens") - dropped,
           "staged_bytes": monitor.stat_get("dist.staged_bytes") - staged,
           "all_to_all_bytes": monitor.stat_get("dist.all_to_all_bytes")
           - a2a, "ms": ms}
    xd = x.clone().requires_grad_()
    yd = dense(xd)
    (yd * ct).sum().backward()
    errs = {"out": _p26_rel(ye.detach(), yd.detach()),
            "dx": _p26_rel(xe.grad, xd.grad),
            "gate": _p26_rel(moe.gate.weight.grad, dense.gate.weight.grad)}
    pg = ep.group("ep")[0]
    for name in ("w_up", "b_up", "w_down", "b_down"):
        full = getattr(dense, name).grad.detach().contiguous()
        C._all_reduce_(full, pg)
        errs[name] = _p26_rel(getattr(moe, name).grad,
                              full[r * el:(r + 1) * el])
    tokens = cfg["b"] * cfg["s"]
    cap = int(cfg["cf"] * tokens / e) + 1
    out.update(errs=errs, capacity=cap,
               # 2 forward + 2 backward calls of [e, capacity, d] f32
               all_to_all_bytes_expected=4 * e * cap * d * 4)
    M.reset_mesh("ep26")
    return out


def _p26_sync_bn():
    """26(e) on this rank: SyncBatchNorm over dp 4 at ResNet-50's first BN
    shape ([8, 64, 56, 56] a rank, f32) under shard_map, against one BN
    over the concatenated batch: outputs, running stats, gradients."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    r, n = M.world_rank(), M.world_size()
    b, c, hh, ww = P26_BN
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn(n * b, c, hh, ww, device="cuda", generator=g) * 2 + 1
    ct = torch.randn(n * b, c, hh, ww, device="cuda", generator=g)
    mesh = M.init_mesh({"dp": n}, name="bn26")
    with device_scope("cuda"):
        sbn, bn = nn.SyncBatchNorm(c), nn.BatchNorm2D(c)
    for m in (sbn, bn):
        with torch.no_grad():
            m.weight.copy_(torch.linspace(0.5, 1.5, c, device="cuda"))
            m.bias.copy_(torch.linspace(-0.2, 0.2, c, device="cuda"))
        m.train()
    xs = x.clone().requires_grad_()
    ys = M.shard_map(sbn, mesh=mesh, in_specs=(M.P("dp"),),
                     out_specs=M.P("dp"))(xs)
    (ys * ct).sum().backward()
    pg = mesh.group("dp")[0]
    dw = sbn.weight.grad.detach().contiguous()
    db = sbn.bias.grad.detach().contiguous()
    C._all_reduce_(dw, pg)
    C._all_reduce_(db, pg)
    xr = x.clone().requires_grad_()
    yr = bn(xr)
    (yr * ct).sum().backward()
    errs = {"out": _p26_rel(ys.detach(), yr.detach()),
            "dx": _p26_rel(xs.grad, xr.grad),
            "dweight": _p26_rel(dw, bn.weight.grad),
            "dbias": _p26_rel(db, bn.bias.grad),
            "running_mean": float((sbn._mean - bn._mean).abs().max()),
            "running_var": float((sbn._variance - bn._variance).abs().max())}
    M.reset_mesh("bn26")
    return {"errs": errs}


def p26_ranks_body():
    """One of the 4 ranks on the card: 26(b) the pipeline schedules in f32
    and bf16, (c) the ring and Ulysses backward, (d) MoE, (e) sync BN."""
    _p25_child_setup()
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.recompute import recompute
    C.probe_transport(torch.device("cuda", 0))
    # torch.utils.checkpoint's first call imports torch._dynamo and
    # torch.distributed.tensor (15-21 s in four processes at once on the
    # card's host): out of the timed schedules
    recompute(torch.sin, torch.ones(1, device="cuda",
                                    requires_grad=True)).sum().backward()
    out = {"pipeline": {}}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        out["pipeline"][name] = _p26_pipeline(dt)
    out["ring"] = _p26_ring()
    out["moe"] = _p26_moe()
    out["sync_bn"] = _p26_sync_bn()
    out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _p26_masters(opt, net):
    return {k: opt._slots[k]["master"].detach().clone()
            for k, _ in net.named_parameters()
            if "master" in opt._slots.get(k, {})}


def _p26_digest(net):
    import hashlib
    h = hashlib.sha1()
    for _, p in sorted(net.named_parameters()):
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _p26_fit(kind, ds, steps, valid=None):
    """``Model.fit`` of BERT-base (dropout 0, bf16 O2, AdamW lr 1e-4
    decay 0.01) over ``steps`` batches of 32: kind "dp", "zero"
    (``strategy.sharding``) or "localsgd" (k ``P26_LSGD_K``) under
    ``fleet.init`` over the ranks, or "one": this process alone, no mesh.
    The network gives the per-token MLM losses (``_p25_mlm_tokens``) and
    the loss is their sum over the batch's labelled tokens (``valid`` in
    their place: the planted fault). Returns the masters (dp / zero), the
    first step's AdamW first moments (0.1 x the gradient its update got)
    and masters (dp / one), the per-step parameter digests (localsgd),
    the optimizer-state bytes, peak memory and the step ms."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import Bert, BertConfig
    if kind != "one":
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 2}
        strategy.sharding = kind == "zero"
        if kind == "localsgd":
            strategy.localsgd = True
            strategy.localsgd_configs = {"k_steps": P26_LSGD_K}
        fleet.init(is_collective=True, strategy=strategy)
    cfg = BertConfig.bert_base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _p25_mlm_tokens(Bert(cfg, device="cuda", dtype=torch.float32,
                               seed=0))
    spec = [pt.InputSpec([None, None], "int64", "ids"),
            pt.InputSpec([None, None], "int64", "labels")]
    model = pt.Model(net, inputs=spec,
                     labels=[pt.InputSpec([None, None], "int64", "labels")])
    inner = AdamW(learning_rate=1e-4, weight_decay=0.01,
                  parameters=model.parameters())
    opt = inner if kind == "one" else fleet.distributed_optimizer(inner,
                                                                  strategy)

    def loss(tok, lab):
        return tok.sum() / (_p25_valid(lab) if valid is None else valid)
    model.prepare(opt, loss=loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    rec = {"step_ms": [], "digests": [], "losses": []}

    class Clock(Callback):
        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self.t = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - self.t) * 1e3)
            rec["losses"].append(float(logs["loss"]))
            if kind == "localsgd":
                rec["digests"].append(_p26_digest(net))
            if step == 0 and kind in ("dp", "one"):
                # on the host, out of the step's time and peak memory
                rec["moment1"] = {k: sl["moment1"].cpu()
                                  for k, sl in inner._slots.items()}
                rec["masters1"] = {k: v.cpu() for k, v in
                                   _p26_masters(inner, net).items()}

    before = _p26_counts()
    model.fit(ds, batch_size=32, epochs=1, shuffle=False, verbose=0,
              num_iters=steps, callbacks=[Clock()])
    after = _p26_counts()
    rec["launches"] = {k: after[k] - before[k] for k in after}
    rec["state_bytes"] = model._engine.zero_state_bytes()
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if kind in ("dp", "zero"):
        model._engine.consolidate_zero()
        rec["masters"] = _p26_masters(inner, net)
    rec["final_digest"] = _p26_digest(net)
    del model, net, opt, inner
    gc.collect()        # the callback's closure holds the network
    torch.cuda.empty_cache()
    return rec


def _p26_fit_ref(ids, lab, dp):
    """26(a)'s independent reference on dp index 0: one fit step of the
    whole b32 batch in this process, and of the planted fault (the step a
    DP without the sum over ranks takes on rank 0: its 16 rows, the loss
    over the whole batch's labelled tokens). Their first moments and
    masters after the step, and the loss."""
    from paddle_tpu_torch.io import TensorDataset
    whole = TensorDataset([ids.cpu(), lab.cpu(), lab.cpu()])
    ref = _p26_fit("one", whole, 1)
    half = TensorDataset([ids[:16].cpu(), lab[:16].cpu(), lab[:16].cpu()])
    fault = _p26_fit("one", half, 1, valid=_p25_valid(lab))
    return {"loss_abs_diff": abs(dp["losses"][0] - ref["losses"][0]),
            "grad_err": _p25_grad_err(dp["moment1"], ref["moment1"]),
            "fault_grad_err": _p25_grad_err(fault["moment1"],
                                            ref["moment1"]),
            "param_max_abs_diff": max(
                float((dp["masters1"][k] - ref["masters1"][k]).abs().max())
                for k in ref["masters1"]),
            "fault_param_max_abs_diff": max(
                float((fault["masters1"][k] - ref["masters1"][k]).abs()
                      .max()) for k in ref["masters1"]),
            "n_params_compared": len(ref["masters1"]),
            "loss_dp": dp["losses"][0], "loss_ref": ref["losses"][0],
            "ref_step_ms": ref["step_ms"][0]}


def p26_fleet_body():
    """One of the 2 dp ranks: 26(a) fleet ``Model.fit`` of BERT-base b32
    s128 (16 / 16), bf16 O2, 3 steps plain and with ZeRO; rank 0 holds the
    plain fit's first step against one process over the whole batch and
    a planted fault; then LocalSGD k 2 for 4 steps. Returns the
    comparisons and readings of this rank."""
    _p25_child_setup()
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.text.models import BertConfig
    C.probe_transport(torch.device("cuda", 0))
    ids, lab = _bert_batches(BertConfig.bert_base(), 32, 128,
                             max(P26_FIT_STEPS, P26_LSGD_STEPS))
    ids_all, lab_all = torch.cat(list(ids)).cpu(), torch.cat(list(lab)).cpu()
    ds = TensorDataset([ids_all, lab_all, lab_all])
    out = {"rank": M.world_rank()}
    dp = _p26_fit("dp", ds, P26_FIT_STEPS)
    M.reset_mesh()
    if out["rank"] == 0:
        out["dp_vs_one"] = _p26_fit_ref(ids[0], lab[0], dp)
    torch.distributed.barrier()
    for k in ("moment1", "masters1"):
        del dp[k]
    zero = _p26_fit("zero", ds, P26_FIT_STEPS)
    M.reset_mesh()
    diffs = [float((zero["masters"][k] - dp["masters"][k]).abs().max())
             for k in dp["masters"]]
    out["zero_vs_dp"] = {
        "masters_compared": len(diffs), "max_abs_diff": max(diffs),
        "bitwise": all(torch.equal(zero["masters"][k], dp["masters"][k])
                       for k in dp["masters"]),
        "losses_dp": dp["losses"], "losses_zero": zero["losses"]}
    for name, rec in (("dp", dp), ("zero", zero)):
        out[name] = {k: rec[k] for k in ("step_ms", "state_bytes",
                                         "max_memory_gb", "launches",
                                         "losses")}
    del dp, zero
    torch.cuda.empty_cache()
    lsgd = _p26_fit("localsgd", ds, P26_LSGD_STEPS)
    M.reset_mesh()
    out["localsgd"] = {k: lsgd[k] for k in ("step_ms", "digests", "losses",
                                            "final_digest", "launches")}
    return out


def phase_fleet_training(card=None):
    """Phase 26: 2 ranks (a) fleet Model.fit DP / ZeRO / LocalSGD; 4 ranks
    (b) the pipeline schedules, (c) the ring and Ulysses backward, (d)
    MoE, (e) sync BN. Returns the paths' launch counts (ranks summed) and
    the results."""
    import tempfile
    from paddle_tpu_torch.testing import spmd
    t0 = time.perf_counter()
    res = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        fl = spmd.run_ranks(p26_fleet_body, 2, tmp_path=tmp, device="cuda",
                            timeout=900)
    res["fleet_s"] = time.perf_counter() - t0
    z = fl[0]["zero_vs_dp"]
    a = {"zero_vs_dp": z,
         "state_bytes": {k: [f[k]["state_bytes"] for f in fl]
                         for k in ("dp", "zero")},
         "max_memory_gb": {k: [f[k]["max_memory_gb"] for f in fl]
                           for k in ("dp", "zero")},
         "step_ms": {k: [f[k]["step_ms"] for f in fl]
                     for k in ("dp", "zero")},
         "localsgd": {"step_ms": [f["localsgd"]["step_ms"] for f in fl],
                      "losses": fl[0]["localsgd"]["losses"]}}
    same = [fl[0]["localsgd"]["digests"][i] == fl[1]["localsgd"]["digests"][i]
            for i in range(P26_LSGD_STEPS)]
    a["localsgd"]["replicas_equal_after_step"] = same
    a["zero_state_share"] = [z_ / d_ for z_, d_ in
                             zip(a["state_bytes"]["zero"],
                                 a["state_bytes"]["dp"])]
    log(f"[fleet fit] BERT-base bf16 O2 b32 s128 as 16 / 16, "
        f"{P26_FIT_STEPS} AdamW steps, DP against ZeRO: {json.dumps(a)}")
    one = fl[0]["dp_vs_one"]
    a["dp_vs_one"] = one
    log(f"[fleet fit] DP's first step against one process over the whole "
        f"b32 batch, and a planted DP without the sum: {json.dumps(one)}")
    check(one["loss_abs_diff"] <= P25_DP_BF16_TOL["loss"]
          and one["grad_err"] <= P25_DP_BF16_TOL["grad"]
          and one["param_max_abs_diff"] <= P25_DP_BF16_TOL["master"],
          f"fleet DP fit differs from one process over the whole batch: "
          f"{one}")
    check(one["fault_grad_err"] > P25_DP_BF16_TOL["grad"],
          f"the gradient limit {P25_DP_BF16_TOL['grad']} passes a DP "
          f"without the sum: {one['fault_grad_err']}")
    check(z["max_abs_diff"] <= STEP_TOL["param"],
          f"ZeRO's masters differ from DP's by {z['max_abs_diff']}")
    check(all(zs < ds_ for zs, ds_ in zip(a["state_bytes"]["zero"],
                                          a["state_bytes"]["dp"])),
          f"ZeRO's optimizer state not smaller: {a['state_bytes']}")
    check(same == [(i + 1) % P26_LSGD_K == 0
                   for i in range(P26_LSGD_STEPS)],
          f"LocalSGD replicas equal after steps {same}, not after every "
          f"{P26_LSGD_K}th only")
    check(all(np.isfinite(fl[0][k]["losses"]).all() for k in ("dp", "zero")),
          "non-finite fleet fit loss")
    res["fit"] = a
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spmd.run_ranks(p26_ranks_body, P26_RANKS, tmp_path=tmp,
                               device="cuda", timeout=900)
    res["ranks_s"] = time.perf_counter() - t1
    # (b) the pipeline
    pp = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol = P26_PP_TOL[dt]
        for sched in ("gpipe", "1f1b", "interleaved"):
            per = [rk["pipeline"][name][sched] for rk in ranks]
            rec = {"loss": per[0]["loss"], "ref_loss": per[0]["ref_loss"],
                   "loss_rel": max(p["loss_rel"] for p in per),
                   "grad_err": max(p["grad_err"] for p in per),
                   "params_compared": sum(p["params_compared"]
                                          for p in per),
                   "ms": max(p["ms"] for p in per),
                   "launches_per_rank": {
                       k: [p["launches"][k] for p in per]
                       for k in ("flash_fwd", "flash_fwd.sm90",
                                 "flash_bwd_dq", "flash_bwd_dkv",
                                 "fused_ce_fwd", "fused_ce_fwd.sm90",
                                 "fused_ce_bwd_dh")},
                   "launches": {k: sum(p["launches"][k] for p in per)
                                for k in per[0]["launches"]}}
            pp[f"{sched}_{name}"] = rec
            log(f"[pipeline] GPT-2 small pp 4 b8 s1024 / 4 micro-batches "
                f"{sched} {name}: {json.dumps(rec)}")
            check(rec["loss_rel"] <= tol["loss"]
                  and rec["grad_err"] <= tol["grad"],
                  f"pipeline {sched} {name} differs from the whole model: "
                  f"{rec}")
            ce = rec["launches_per_rank"]["fused_ce_fwd"]
            check(ce[:-1] == [0] * (P26_RANKS - 1) and ce[-1] > 0,
                  f"pipeline {sched} {name}: CE launches a rank {ce}")
            if dt == torch.bfloat16:
                for k in ("flash_fwd", "fused_ce_fwd"):
                    check(rec["launches"][k] == rec["launches"][f"{k}.sm90"]
                          > 0, f"pipeline {sched} bf16: {k} off the Hopper "
                               f"kernel")
    res["pipeline"] = pp
    # (c) the ring backward
    rg = {}
    r0 = ranks[0]["ring"]
    for tag in ("ring_causal0", "ring_causal1", "ulysses_causal0",
                "ulysses_causal1"):
        causal = tag.endswith("1")
        rec = dict(r0[tag])
        rec["launches"] = {k: sum(rk["ring"][tag]["launches"][k]
                                  for rk in ranks)
                           for k in r0[tag]["launches"]}
        rec["ms"] = max(rk["ring"][tag]["ms"] for rk in ranks)
        rec["single_flash_fwd_bwd_ms"] = r0[f"single_causal{int(causal)}_ms"]
        rg[tag] = rec
        log(f"[ring bwd] sp 4 x s 4096 bf16 h12 d64 {tag}: "
            f"{json.dumps(rec)}")
        check(rec["o_max"] <= P25_RING_TOL["o_max"]
              and rec["o_norm"] <= P25_RING_TOL["o_norm"],
              f"{tag} forward differs from the single flash call: {rec}")
        for gname in ("dq", "dk", "dv"):
            check(rec[f"{gname}_max"] <= P26_RING_GRAD_TOL["max"]
                  and rec[f"{gname}_norm"] <= P26_RING_GRAD_TOL["norm"],
                  f"{tag} {gname} differs from the single flash backward: "
                  f"{rec}")
        lc = rec["launches"]
        for kname in FLASH_KERNELS:
            check(lc[kname] == lc[f"{kname}.sm90"],
                  f"{tag}: {kname} off the Hopper kernel: {lc}")
    want = {"ring_causal0": 16, "ring_causal1": 10, "ulysses_causal0": 4,
            "ulysses_causal1": 4}
    for tag, nwant in want.items():
        lc = rg[tag]["launches"]
        check(lc["flash_bwd_dq"] == lc["flash_bwd_dkv"] == lc["flash_fwd"]
              == nwant, f"{tag}: flash launches {lc}, not {nwant} each")
    res["ring"] = rg
    # (d) MoE, (e) sync BN
    moe = {"errs": {k: max(rk["moe"]["errs"][k] for rk in ranks)
                    for k in ranks[0]["moe"]["errs"]},
           "dropped_per_rank": [rk["moe"]["dropped"] for rk in ranks],
           "capacity": ranks[0]["moe"]["capacity"],
           "all_to_all_bytes_per_rank": [rk["moe"]["all_to_all_bytes"]
                                         for rk in ranks],
           "all_to_all_bytes_expected": ranks[0]["moe"][
               "all_to_all_bytes_expected"],
           "staged_bytes_per_rank": [rk["moe"]["staged_bytes"]
                                     for rk in ranks],
           "ms": max(rk["moe"]["ms"] for rk in ranks)}
    log(f"[moe] Switch-Base-8 FFN ep 4, b2 s512 a rank, f32: "
        f"{json.dumps(moe)}")
    check(max(moe["errs"].values()) <= P26_MOE_TOL,
          f"MoE at ep 4 differs from the dense layer: {moe['errs']}")
    res["moe"] = moe
    bn = {k: max(rk["sync_bn"]["errs"][k] for rk in ranks)
          for k in ranks[0]["sync_bn"]["errs"]}
    log(f"[sync bn] [8, 64, 56, 56] a rank over dp 4, f32, against one BN "
        f"over [32, 64, 56, 56]: {json.dumps(bn)}")
    check(max(bn.values()) <= P26_BN_TOL, f"sync BN differs: {bn}")
    res["sync_bn"] = bn
    res["max_memory_gb_per_rank"] = [rk["max_memory_gb"] for rk in ranks]
    counts = {"fit": {k: {kk: sum(f[k]["launches"][kk] for f in fl)
                          for kk in fl[0][k]["launches"]}
                      for k in ("dp", "zero")},
              "pipeline": {t: r["launches"] for t, r in pp.items()},
              "ring": {t: r["launches"] for t, r in rg.items()}}
    counts["fit"]["localsgd"] = {
        kk: sum(f["localsgd"]["launches"][kk] for f in fl)
        for kk in fl[0]["localsgd"]["launches"]}
    for kname in PATH_KERNELS:
        check(counts["fit"]["dp"][kname] > 0
              and counts["fit"]["dp"][kname]
              == counts["fit"]["dp"][f"{kname}.sm90"],
              f"fleet fit: {kname} launched {counts['fit']['dp'][kname]} "
              f"times, not all on the Hopper kernel")
    res["seconds"] = time.perf_counter() - t0
    log(f"[fleet training] phase 26 {res['seconds']:.1f} s (2 ranks "
        f"{res['fleet_s']:.1f}, 4 ranks {res['ranks_s']:.1f}); card: {card}")
    return counts, res


def _fleet_training_fields(rec, name, counts):
    """Phase 26's launches of one of the six training kernels, summed over
    the ranks: the fleet fits (DP, ZeRO, LocalSGD; 2 ranks), the pipeline
    schedules (f32 and bf16; 4 ranks) and, for the flash kernels, the ring
    and Ulysses forward and backward (4 ranks)."""
    for tag, c in counts["fit"].items():
        rec[f"launches_fleet_{tag}"] = c[name]
        rec[f"launches_fleet_{tag}_sm90"] = c[f"{name}.sm90"]
    for tag, c in counts["pipeline"].items():
        rec[f"launches_pipeline_{tag}"] = c[name]
        rec[f"launches_pipeline_{tag}_sm90"] = c[f"{name}.sm90"]
    if name in FLASH_KERNELS:
        for tag, c in counts["ring"].items():
            rec[f"launches_{tag}_bwd_phase"] = c[name]
            rec[f"launches_{tag}_bwd_phase_sm90"] = c[f"{name}.sm90"]


# --------------------------------------------------------------------------
# phase 27: the rest of the distributed tier (the launcher and a whole-job
# restart, the static Executor over dp ranks with recompute segments,
# Model.fit under a tp mesh, the planner and the staged pipeline)
# --------------------------------------------------------------------------

P27_FIT = {"steps": 4, "kill_after": 3, "save_every": 2}   # 27(a)
P27_STATIC_STEPS = 3                                       # 27(b)
P27_TP, P27_TP_B, P27_TP_S, P27_TP_STEPS = 4, 8, 1024, 2   # 27(c)
P27_PP = {"stages": 4, "micro": 4, "steps": 3, "b": 8, "s": 1024,
          "lr": 1e-3}                                      # 27(d)
# 26(a)'s limits against one process over the whole batch (bf16 O2,
# AdamW lr 1e-4). Adam's first step moves a master by about lr whatever
# the gradient, so the masters' 2e-4 cannot fail a wrong gradient: the
# first step's gradients decide (largest |error| over largest |entry| a
# tensor, P25_DP_BF16_TOL's "grad"; the fetched gradients in (b), AdamW's
# first moments in (c) and (d)), and a planted fault each run must fail
# that limit: (b) a rank's gradient without the sum over dp, (c) the tp
# fit without the column layers' backward all-reduce.
P27_ONE_TOL = {"loss": 2e-3, "grad": P25_DP_BF16_TOL["grad"],
               "master": 2e-4}
P27_PP_TOL = 1e-5                       # f32 losses, the staged pipeline
P27_KERNELS = PATH_KERNELS + SM90_COUNTS + CE_SM90_COUNTS


def _p27_counts():
    from paddle_tpu_torch.ops import cuda as kernels
    c = kernels.launch_counts()
    return {k: c[k] for k in P27_KERNELS}


def _p27_diff(after, before):
    return {k: after[k] - before[k] for k in after}


def _p27_free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _p27_launch(out, kill):
    """27(a): start ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2`` on ``testing/fit_job.py`` (BERT-base bf16 O2,
    b32 s128 as 16 / 16, a checkpoint every 2 steps); with ``kill`` rank 1
    SIGKILLs itself after step 3 and ``--elastic_retries 1`` restarts the
    job. Returns a function that waits for it: (its output, seconds)."""
    import subprocess
    root = os.path.dirname(os.path.abspath(__file__))
    job = os.path.join(root, "paddle_tpu_torch", "testing", "fit_job.py")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--started_port", str(_p27_free_port())]
    if kill:
        cmd += ["--elastic_retries", "1"]
    cmd += [job, "--config", "base", "--amp", "O2", "--device", "gpu",
            "--out", out, "--steps", str(P27_FIT["steps"]), "--batch", "32",
            "--seq", "128", "--save-every", str(P27_FIT["save_every"])]
    if kill:
        cmd += ["--kill-after", str(P27_FIT["kill_after"])]
    t = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            raise
        check(p.returncode == 0, f"27(a) launch (kill={kill}) failed rc "
                                 f"{p.returncode}: {stdout[-2000:]} "
                                 f"{stderr[-4000:]}")
        return stdout, time.perf_counter() - t
    return wait


def _p27_launcher(tmp):
    """27(a): the launch without and with the kill, side by side on the
    card (4 processes); the per-step losses and the final f32 masters held
    bitwise."""
    ref_dir, kill_dir = os.path.join(tmp, "ref"), os.path.join(tmp, "kill")
    ref_wait = _p27_launch(ref_dir, False)
    kill_wait = _p27_launch(kill_dir, True)
    _, ref_s = ref_wait()
    out, kill_s = kill_wait()
    check("elastic restart 1/1" in out, f"27(a): no restart: {out[-2000:]}")

    def rec(d, r, a):
        with open(os.path.join(d, f"rank{r}_attempt{a}.json")) as f:
            return json.load(f)
    res = {"ref_s": ref_s, "kill_s": kill_s, "ranks": {}}
    with open(os.path.join(kill_dir, "killed.json")) as f:
        killed = json.load(f)
    for r in (0, 1):
        ref, resumed = rec(ref_dir, r, 0), rec(kill_dir, r, 1)
        steps = sorted(resumed["losses"], key=int)
        check(steps == [str(k) for k in range(
            P27_FIT["save_every"], P27_FIT["steps"])],
            f"27(a) rank {r} resumed at steps {steps}")
        same_loss = all(resumed["losses"][k] == ref["losses"][k]
                        for k in steps)
        a = np.load(os.path.join(ref_dir, f"rank{r}.npz"))
        b = np.load(os.path.join(kill_dir, f"rank{r}.npz"))
        same = [bool(np.array_equal(a[k], b[k])) for k in a.files]
        first = min(float(v) for v in resumed["ended"].values())
        res["ranks"][r] = {
            "losses_ref": ref["losses"], "losses_resumed": resumed["losses"],
            "losses_bitwise": same_loss, "masters_compared": len(same),
            "masters_bitwise": all(same),
            "launches_ref": ref["launches"],
            "launches_resumed": resumed["launches"],
            "restart_s": first - killed["time"]}
        check(same_loss, f"27(a) rank {r}: resumed losses differ: "
                         f"{resumed['losses']} against {ref['losses']}")
        check(all(same) and len(same) > 100,
              f"27(a) rank {r}: {same.count(False)} of {len(same)} masters "
              f"differ from the launch without the kill")
    killed_first = rec(kill_dir, 1, 0)["losses"]
    check(all(killed_first[k] == res["ranks"][1]["losses_ref"][k]
              for k in killed_first),
          f"27(a): attempt 0's losses differ: {killed_first}")
    res["restart_s"] = max(v["restart_s"] for v in res["ranks"].values())
    return res


def _p27_static_bert(paddle, cfg, recompute, batch=32):
    """Phase 22's static BERT-base bf16 O2 program (``_static_bert``) over
    ``batch`` rows, with ``recompute`` through
    ``fleet.distributed_optimizer`` over ``strategy.recompute`` with one
    checkpoint an encoder layer. Returns (program, net, loss, [(param,
    grad var)])."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.testing.spmd_static import encoder_checkpoints
    from paddle_tpu_torch.text.models import Bert
    paddle.enable_static()
    try:
        main = static.Program("bert_static_dp")
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [batch, 128], "int64")
            lab = static.data("labels", [batch, 128], "int64")
            net = Bert(cfg, seed=0)
            ck = encoder_checkpoints(net)
            loss = net(ids, masked_lm_labels=lab)
            opt = static.amp.decorate(
                paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                       parameters=net.parameters()),
                level="O2", dtype="bfloat16")
            if recompute:
                st = fleet.DistributedStrategy()
                st.recompute = True
                st.recompute_configs = {"checkpoints": list(ck)}
                opt = fleet.distributed_optimizer(opt, st)
            _, pairs = opt.minimize(loss)
    finally:
        paddle.disable_static()
    return main, net, loss, pairs


def _p27_static_run(paddle, cfg, ids, lab, recompute, data_parallel):
    """Steps of the static program over the batches (ids [n, b, 128]):
    the losses, the first step's gradients (the fetched ones: under
    ``with_data_parallel`` the sum over dp, the global batch's) and f32
    weights (the scope's: O2 casts them per op), the steady step ms and
    the launches."""
    from paddle_tpu_torch import static
    main, net, loss, pairs = _p27_static_bert(paddle, cfg, recompute,
                                              int(ids.shape[1]))
    prog = static.CompiledProgram(main)
    if data_parallel:
        prog = prog.with_data_parallel(loss_name=loss.name)
    exe = static.Executor()
    scope = static.global_scope()
    names = {k: p.scope_name for k, p in net.named_parameters()}
    rec = {"losses": [], "step_ms": []}
    before = _p27_counts()
    paddle.enable_static()
    try:
        for k in range(ids.shape[0]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = exe.run(prog, feed={"ids": ids[k], "labels": lab[k]},
                          fetch_list=[loss] + ([g for _, g in pairs]
                                               if k == 0 else []),
                          return_numpy=False)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t) * 1e3)
            rec["losses"].append(float(got[0]))
            if k == 0:
                rec["grads"] = [g.detach().clone() for g in got[1:]]
                rec["weights1"] = {k: scope.get(n).detach().clone()
                                   for k, n in names.items()}
    finally:
        paddle.disable_static()
    rec["launches"] = _p27_diff(_p27_counts(), before)
    e = next(iter(exe._cache.values()))
    rec["segments"] = 0 if e.segments is None else len(e.segments[1])
    rec["dp_rows"] = None if e.dp is None else \
        int(ids.shape[1]) // e.dp.k
    return rec


def p27_static_body():
    """27(b), one of the 2 dp ranks: phase 22's static BERT-base bf16 O2
    program under ``with_data_parallel`` for 3 steps of b32 (16 / 16),
    plain and with recompute; rank 0 then runs one step of the whole batch
    alone, and the planted fault: the gradient a rank holds without the
    sum over dp (one step of its 16 rows alone, scaled from their
    labelled tokens' mean to the whole batch's). Returns the comparisons
    and readings of this rank."""
    _p25_child_setup()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.recompute import recompute
    from paddle_tpu_torch.text.models import BertConfig
    C.probe_transport(torch.device("cuda", 0))
    recompute(torch.sin, torch.ones(1, device="cuda",
                                    requires_grad=True)).sum().backward()
    paddle.set_device("gpu")
    cfg = BertConfig.bert_base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    ids, lab = _bert_batches(cfg, 32, 128, P27_STATIC_STEPS)
    M.init_mesh({"dp": 2}, name="default")
    rank = M.world_rank()
    plain = _p27_static_run(paddle, cfg, ids, lab, False, True)
    rc = _p27_static_run(paddle, cfg, ids, lab, True, True)
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(plain["grads"], rc["grads"])]
    out = {"rank": rank,
           "recompute_grads_bitwise": all(torch.equal(a, b) for a, b in
                                          zip(plain["grads"], rc["grads"])),
           "recompute_grad_max_abs_diff": max(diffs),
           "recompute_grads_differing": sum(d > 0 for d in diffs),
           "grads_compared": len(diffs),
           "recompute_losses_bitwise": plain["losses"] == rc["losses"]}
    for name, r in (("plain", plain), ("recompute", rc)):
        out[name] = {k: r[k] for k in ("losses", "step_ms", "launches",
                                       "segments", "dp_rows")}
    del rc
    torch.cuda.empty_cache()
    M.reset_mesh("default")
    if rank == 0:
        one = _p27_static_run(paddle, cfg, ids[:1], lab[:1], False, False)
        half = _p27_static_run(paddle, cfg, ids[:1, :16], lab[:1, :16],
                               False, False)
        scale = float(_p25_valid(lab[0, :16]) / _p25_valid(lab[0]))
        want = dict(enumerate(one["grads"]))
        out["vs_one"] = {
            "loss_dp": plain["losses"][0], "loss_one": one["losses"][0],
            "loss_abs_diff": abs(plain["losses"][0] - one["losses"][0]),
            "grads_compared": len(want),
            "grad_err": _p25_grad_err(dict(enumerate(plain["grads"])), want),
            "fault_grad_err": _p25_grad_err(
                {k: g.float() * scale for k, g in enumerate(half["grads"])},
                want),
            "weights_compared": len(one["weights1"]),
            "master_max_abs_diff": max(
                float((plain["weights1"][k] - v).abs().max())
                for k, v in one["weights1"].items()),
            "one_step_ms": one["step_ms"][0]}
        del one, half
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _p27_gpt_cfg():
    from paddle_tpu_torch.text.models.gpt import GPTConfig
    return GPTConfig(dropout=0.0)          # GPT-2 small, V 50304


def _p27_lm_batch():
    g = torch.Generator().manual_seed(27)
    ids = torch.randint(0, 50257, (P27_TP_B, P27_TP_S), generator=g)
    return ids, torch.roll(ids, -1, dims=1)


def _p27_tp_fit(ids, lab, rules=None, tp=P27_TP, steps=P27_TP_STEPS,
                fault=False):
    """27(c): ``Model.fit`` of GPT-2 small (``spmd_static.GPTLM``: the
    fused CE head) bf16 O2, AdamW lr 1e-4, b8 s1024, under the default
    mesh ``{"tp": tp}`` (one process: tp 1) for ``steps`` steps; ``rules``
    (a plan's layout) installed first; ``fault``: the column layers'
    input copy without its backward all-reduce (the planted fault, one
    step). Returns the losses, step ms, the first step's whole masters
    and AdamW first moments (on the host, rank 0 only), the final whole
    parameters' digest, the state bytes, the forward's and the fit's
    collective bytes (the smoke's own gathers of the masters and moments
    left out) and the launches."""
    import hashlib
    from unittest import mock
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import sharding as SH
    from paddle_tpu_torch.distributed.fleet import meta_parallel as MP
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        whole_parameters
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.spmd_static import GPTLM
    if tp > 1:
        M.init_mesh({"tp": tp}, name="default")
    installed = []
    for tmpl, nd, spec in rules or ():
        def build(ndim, _nd=nd, _s=tuple(spec)):
            return M.PartitionSpec(*_s) if ndim == _nd else M.PartitionSpec()
        SH.add_tp_rule(tmpl, build)
        installed.append(tmpl)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    keys = ("dist.all_reduce_bytes", "dist.all_gather_bytes",
            "dist.staged_bytes")

    def counters():
        return {k: monitor.stat_get(k) for k in keys}
    try:
        net = GPTLM(_p27_gpt_cfg())
        spec = [pt.InputSpec([None, None], "int64", "ids"),
                pt.InputSpec([None, None], "int64", "labels")]
        model = pt.Model(net, inputs=spec)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), multi_precision=True)
        model.prepare(opt, loss=lambda loss: loss,
                      amp_configs={"level": "O2", "dtype": "bfloat16"})
        rec = {"step_ms": [], "losses": []}

        def whole(slot):
            vals = {k: sl[slot] for k, sl in opt._slots.items()
                    if slot in sl}
            vals = whole_parameters(net, vals) if tp > 1 else vals
            if M.world_rank() != 0:
                return None
            return {k: v.float().cpu() for k, v in vals.items()}

        class Clock(Callback):
            def on_train_batch_begin(self, step, logs=None):
                torch.cuda.synchronize()
                self.t = time.perf_counter()

            def on_train_batch_end(self, step, logs=None):
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - self.t) * 1e3)
                rec["losses"].append(float(logs["loss"]))
                if step == 0:
                    # the gathers of the capture are the smoke's, not the
                    # step's: their bytes are taken out of fit_bytes
                    c = counters()
                    rec["masters1"] = whole("master")
                    rec["moment1"] = whole("moment1")
                    rec["capture_bytes"] = {k: v - c[k]
                                            for k, v in counters().items()}

        b0 = counters()
        c0 = _p27_counts()
        ds = TensorDataset([ids.repeat(steps, 1), lab.repeat(steps, 1)])
        with contextlib.ExitStack() as stack:
            if fault:
                stack.enter_context(mock.patch.object(
                    MP, "_identity_fwd_allreduce_bwd",
                    lambda x, axis, mesh=None: x))
            model.fit(ds, batch_size=P27_TP_B, epochs=1, shuffle=False,
                      verbose=0, callbacks=[Clock()])
        rec["launches"] = _p27_diff(_p27_counts(), c0)
        rec["fit_bytes"] = {k: v - b0[k] - rec["capture_bytes"][k]
                            for k, v in counters().items()}
        if not fault:
            b1 = counters()
            model.eval_batch([ids.cuda(), lab.cuda()])
            rec["forward_bytes"] = {k: v - b1[k]
                                    for k, v in counters().items()}
            rec["state_bytes"] = model._engine.state_bytes()
            w = net.gpt.wte._parameters["weight"]
            rec["head_shard_bytes"] = w.numel() * w.element_size()
            params = whole_parameters(net) if tp > 1 else dict(
                net.named_parameters())
            h = hashlib.sha1()
            for k in sorted(params):
                h.update(params[k].detach().float().cpu().numpy().tobytes())
            rec["digest"] = h.hexdigest()
        rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, net, opt
        gc.collect()
        torch.cuda.empty_cache()
        return rec
    finally:
        for tmpl in installed:
            SH.remove_tp_rule(tmpl)
        if tp > 1:
            M.reset_mesh("default")


def _p27_blocks_program():
    """GPT-2 small's 12 blocks recorded over a [8, 1024, 768] hidden on
    the host (the stage-cut planner's program; a block a plan segment)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.text.models.gpt import GPTBlock
    cfg = _p27_gpt_cfg()
    paddle.enable_static()
    try:
        main = static.Program("gpt2_blocks")
        with static.program_guard(main, static.Program()), \
                device_scope("cpu"):
            h = static.data("h", [P27_PP["b"], P27_PP["s"], cfg.hidden_size],
                            "float32")
            for _ in range(cfg.num_layers):
                h = GPTBlock(cfg)(h)
        main._jit_fetch_vars = [h]
        return main, len(main.ops) // cfg.num_layers
    finally:
        paddle.disable_static()


def _p27_staged():
    """27(d): ``StagedPipelineRunner`` over ``plan_pipeline`` of GPT-2
    small's 12 blocks at pp 4 (b8 s1024, 4 micro-batches, f32, its SGD),
    the loss the mean squared error to a random hidden target; rank 0
    runs the same SGD steps on the whole stack alone. Returns the plan's
    cuts, the losses, the reference's, the step ms and the launches."""
    from torch.func import functional_call
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.static.pipeline_runner import StagedPipelineRunner
    from paddle_tpu_torch.static.spmd_planner import plan_pipeline
    from paddle_tpu_torch.text.models.gpt import GPT
    cfg = _p27_gpt_cfg()
    main, opl = _p27_blocks_program()
    plan = plan_pipeline(main, {"pp": P27_PP["stages"]},
                         num_micro=P27_PP["micro"],
                         boundaries=[k * opl for k in range(1, 12)])
    del main
    whole = GPT(cfg, device="cuda", seed=0)
    template = whole.blocks[0]
    units = [{k: v.detach() for k, v in blk.named_parameters()}
             for blk in whole.blocks]
    g = torch.Generator().manual_seed(7)
    x = torch.randn(P27_PP["b"], P27_PP["s"], cfg.hidden_size,
                    generator=g).cuda()
    y = torch.randn(P27_PP["b"], P27_PP["s"], cfg.hidden_size,
                    generator=g).cuda()

    def unit(h, p):
        return functional_call(template, p, (h,))

    def mse(h, t):
        return ((h - t) ** 2).mean()
    mesh = M.init_mesh({"pp": P27_PP["stages"]}, name="staged")
    out = {"cuts": list(plan.cuts), "stage_segments": plan.stage_segments()}
    try:
        runner = StagedPipelineRunner(plan, unit, units, mse, mesh=mesh,
                                      learning_rate=P27_PP["lr"])
        c0 = _p27_counts()
        losses, ms = [], []
        for _ in range(P27_PP["steps"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(runner.step(x, y)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out.update(losses=losses, step_ms=ms,
                   launches=_p27_diff(_p27_counts(), c0))
        del runner
    finally:
        M.reset_mesh("staged")
    if M.world_rank() == 0:
        ps = [{k: v.clone().requires_grad_(True) for k, v in u.items()}
              for u in units]
        ref = []
        for _ in range(P27_PP["steps"]):
            h = x
            for p in ps:
                h = unit(h, p)
            loss = mse(h, y)
            grads = torch.autograd.grad(loss, [v for p in ps
                                               for v in p.values()])
            with torch.no_grad():
                for v, gr in zip([v for p in ps for v in p.values()],
                                 grads):
                    v.sub_(P27_PP["lr"] * gr)
            ref.append(float(loss))
        out["ref_losses"] = ref
        out["loss_rel"] = max(abs(a - b) / abs(b)
                              for a, b in zip(losses, ref))
    del whole, units
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p27_tp_body(layout):
    """27(c) and (d), one of the 4 ranks: rank 0 first runs one process's
    fit step of GPT-2 small over the whole batch; then all fit it under
    {"tp": 4} with the preset rules, with the planted fault (one step)
    and under the plan's ``layout``; rank 0 holds the first steps against
    the one process's. Then the staged pipeline at pp 4."""
    _p25_child_setup()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.recompute import recompute
    C.probe_transport(torch.device("cuda", 0))
    recompute(torch.sin, torch.ones(1, device="cuda",
                                    requires_grad=True)).sum().backward()
    paddle.set_device("gpu")
    rank = M.world_rank()
    ids, lab = _p27_lm_batch()
    one = _p27_tp_fit(ids, lab, tp=1) if rank == 0 else None
    torch.distributed.barrier()
    preset = _p27_tp_fit(ids, lab)
    fault = _p27_tp_fit(ids, lab, steps=1, fault=True)
    planned = _p27_tp_fit(ids, lab, rules=layout)
    out = {"rank": rank}
    keep = ("losses", "step_ms", "launches", "fit_bytes", "forward_bytes",
            "state_bytes", "max_memory_gb", "digest", "head_shard_bytes")
    out["preset"] = {k: preset[k] for k in keep}
    out["plan_layout"] = {k: planned[k] for k in keep}
    out["fault"] = {k: fault[k] for k in ("losses", "step_ms", "fit_bytes")}
    if rank == 0:
        def vs(run, ref):
            return {
                "loss_abs_diff": abs(run["losses"][0] - ref["losses"][0]),
                "grads_compared": len(ref["moment1"]),
                "grad_err": _p25_grad_err(run["moment1"], ref["moment1"]),
                "masters_compared": len(ref["masters1"]),
                "master_max_abs_diff": max(
                    float((run["masters1"][k] - v).abs().max())
                    for k, v in ref["masters1"].items())}
        out["vs_one"] = dict(
            vs(preset, one), loss_tp=preset["losses"][0],
            loss_one=one["losses"][0],
            fault_grad_err=_p25_grad_err(fault["moment1"], one["moment1"]),
            one_step_ms=one["step_ms"], one_launches=one["launches"],
            one_state_bytes=one["state_bytes"])
        out["layout_vs_one"] = vs(planned, one)
        out["layout_vs_preset"] = dict(
            vs(planned, preset),
            masters_bitwise=all(torch.equal(planned["masters1"][k], v)
                                for k, v in preset["masters1"].items()),
            digest_equal=planned["digest"] == preset["digest"],
            losses_bitwise=planned["losses"] == preset["losses"])
    del one, preset, fault, planned
    gc.collect()
    torch.distributed.barrier()
    out["staged"] = _p27_staged()
    return out


def _p27_plan():
    """27(d) on the host: ``plan_program`` of GPT-2 small (b8 s1024, the
    fused CE head) at tp 4, its rules against the preset's, the
    analyzer's forward collectives of the preset specs, and the plan's
    whole layout as exact-name rules (the fit's)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.distributed import sharding as SH
    from paddle_tpu_torch.static.spmd_analyzer import analyze_program
    from paddle_tpu_torch.static.spmd_planner import plan_program
    from paddle_tpu_torch.text.models.gpt import GPT
    t = time.perf_counter()
    paddle.enable_static()
    try:
        main = static.Program("gpt2_tp_plan")
        with static.program_guard(main, static.Program()), \
                device_scope("cpu"):
            ids = static.data("ids", [P27_TP_B, P27_TP_S], "int64")
            lab = static.data("labels", [P27_TP_B, P27_TP_S], "int64")
            net = GPT(_p27_gpt_cfg())
            loss = net(ids, labels=lab)
        main._jit_fetch_vars = [loss]
    finally:
        paddle.disable_static()
    mesh = {"tp": P27_TP}
    plan = plan_program(main, mesh, layer=net)
    plan_s = time.perf_counter() - t
    meshlike = SH.mesh_like(mesh)

    def norm(spec):
        spec = tuple(spec)
        return spec if any(e is not None for e in spec) else ()
    differ, layout = [], []
    for name, p in net.named_parameters():
        want = norm(SH._validate_divisible(
            SH.param_spec_for(name, p.dim(), meshlike), p.shape, meshlike))
        got = norm(plan.spec_for(name, p.dim()))
        if got != want:
            differ.append({"param": name, "plan": list(got),
                           "preset": list(want)})
        # the plan's whole layout as exact-name rules, replicated ones too:
        # install_rules, as JAX's, emits no rule for a replicated group, so
        # under it alone the presets stand for those (the preset's layout
        # here, where the plan only adds wte's template)
        layout.append((r"^gpt\." + re.escape(name) + "$", p.dim(),
                       got or (None,) * p.dim()))
    rep = analyze_program(main, mesh=mesh,
                          param_specs=SH.named_param_specs(net, mesh))
    coll = [{"kind": c.kind, "axis": c.axis, "bytes": c.bytes,
             "op": c.op_name, "dtype": c.dtype} for c in rep.collectives]
    res = {"plan_s": plan_s, "evaluations": plan.evaluations,
           "rules": [(r.template, r.ndim, list(r.spec)) for r in plan.rules],
           "differing_rules": differ, "predicted": plan.predicted,
           "baseline": plan.baseline,
           "preset_collectives": coll,
           "preset_diagnostics": [str(d) for d in rep.diagnostics]}
    del main, net
    gc.collect()
    return res, layout


def phase_multi_process(card=None):
    """Phase 27: (a) the launcher with a whole-job restart; (b) the static
    Executor over 2 dp ranks, plain and with recompute; (c) Model.fit of
    GPT-2 small under {"tp": 4}; (d) the planner at tp 4 and the staged
    pipeline at pp 4. Returns the paths' launch counts (ranks summed) and
    the results."""
    import tempfile
    from paddle_tpu_torch.testing import spmd
    import threading
    t0 = time.perf_counter()
    res = {"card": card}
    # (d)'s plan on the host while (a)'s launches run on the card
    planned = {}

    def plan_on_host():
        try:
            planned["plan"], planned["layout"] = _p27_plan()
        except Exception as exc:  # noqa: BLE001 - raised below
            planned["error"] = exc
    planner = threading.Thread(target=plan_on_host)
    planner.start()
    # (a) the launcher
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a = _p27_launcher(tmp)
    finally:
        planner.join()
    a["seconds"] = time.perf_counter() - t
    log(f"[launch] BERT-base bf16 O2 b32 s128 as 16 / 16, 2 ranks, "
        f"{P27_FIT['steps']} steps, rank 1 SIGKILLed after step "
        f"{P27_FIT['kill_after']}: {json.dumps(a)}")
    res["launch"] = a
    if "error" in planned:
        raise planned["error"]
    plan, layout = planned["plan"], planned["layout"]
    log(f"[planner] GPT-2 small b8 s1024 at tp 4: {plan['evaluations']} "
        f"analyzer evaluations in {plan['plan_s']:.1f} s; rules "
        f"{plan['rules']}; predicted {plan['predicted']} against the "
        f"replicated baseline {plan['baseline']}; "
        f"{len(plan['differing_rules'])} parameters differ from the "
        f"preset: {plan['differing_rules']}")
    check(plan["predicted"]["diagnostics"] == 0,
          f"27(d) plan carries diagnostics: {plan['predicted']}")
    # (b) the static Executor over dp 2
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        st = spmd.run_ranks(p27_static_body, 2, tmp_path=tmp, device="cuda",
                            timeout=600)
    b = {"vs_one": st[0]["vs_one"],
         "recompute_grads_bitwise": [s["recompute_grads_bitwise"]
                                     for s in st],
         "recompute_grad_max_abs_diff": max(
             s["recompute_grad_max_abs_diff"] for s in st),
         "recompute_losses_bitwise": all(s["recompute_losses_bitwise"]
                                         for s in st),
         "grads_compared": st[0]["grads_compared"],
         "max_memory_gb": [s["max_memory_gb"] for s in st],
         "seconds": time.perf_counter() - t}
    for name in ("plain", "recompute"):
        b[name] = {"step_ms": [s[name]["step_ms"] for s in st],
                   "losses": st[0][name]["losses"],
                   "segments": st[0][name]["segments"],
                   "dp_rows": [s[name]["dp_rows"] for s in st],
                   "launches": {k: sum(s[name]["launches"][k] for s in st)
                                for k in P27_KERNELS},
                   "flash_fwd_per_step_rank": st[0][name]["launches"][
                       "flash_fwd"] / P27_STATIC_STEPS}
    log(f"[static dp] BERT-base bf16 O2 b32 s128 as 16 / 16 over 2 ranks, "
        f"{P27_STATIC_STEPS} steps, plain and recompute: {json.dumps(b)}")
    one = b["vs_one"]
    check(one["loss_abs_diff"] <= P27_ONE_TOL["loss"]
          and one["grad_err"] <= P27_ONE_TOL["grad"]
          and one["master_max_abs_diff"] <= P27_ONE_TOL["master"]
          and one["grads_compared"] > 100,
          f"27(b) dp step differs from one process: {one}")
    check(one["fault_grad_err"] > P27_ONE_TOL["grad"],
          f"27(b) the gradient limit {P27_ONE_TOL['grad']} passes a rank's "
          f"gradient without the sum over dp: {one['fault_grad_err']}")
    check(all(b["recompute_grads_bitwise"]) and b["recompute_losses_bitwise"]
          and b["grads_compared"] > 100,
          f"27(b) recompute's gradients or losses differ from the plain "
          f"program's: {b['grads_compared']} gradients compared, bitwise "
          f"{b['recompute_grads_bitwise']}, largest |difference| "
          f"{b['recompute_grad_max_abs_diff']}, losses bitwise "
          f"{b['recompute_losses_bitwise']}")
    check(all(r == 16 for r in b["plain"]["dp_rows"]),
          f"27(b) ranks ran {b['plain']['dp_rows']} rows, not 16 each")
    check(b["recompute"]["segments"] == 13,
          f"27(b) recompute segments {b['recompute']['segments']}, not 13")
    check(b["recompute"]["flash_fwd_per_step_rank"]
          == 2 * b["plain"]["flash_fwd_per_step_rank"] == 24,
          f"27(b) flash forwards a step: recompute "
          f"{b['recompute']['flash_fwd_per_step_rank']}, plain "
          f"{b['plain']['flash_fwd_per_step_rank']}")
    res["static_dp"] = b
    # (c) and (d) on 4 ranks
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tp = spmd.run_ranks(p27_tp_body, 4, layout, tmp_path=tmp,
                            device="cuda", timeout=900)
    pred = plan["preset_collectives"]
    pred_ar = sum(c["bytes"] for c in pred if c["kind"] == "all_reduce"
                  and c["op"] != "fused_ce_op")
    pred_ce = sum(c["bytes"] for c in pred if c["op"] == "fused_ce_op")
    fb = tp[0]["preset"]["forward_bytes"]
    c = {"vs_one": tp[0]["vs_one"],
         "step_ms": [r["preset"]["step_ms"] for r in tp],
         "losses": tp[0]["preset"]["losses"],
         "state_bytes": [r["preset"]["state_bytes"] for r in tp],
         "one_state_bytes": tp[0]["vs_one"]["one_state_bytes"],
         "max_memory_gb": [r["preset"]["max_memory_gb"] for r in tp],
         "launches_per_rank": {k: [r["preset"]["launches"][k] for r in tp]
                               for k in P27_KERNELS},
         "fit_bytes_per_rank": tp[0]["preset"]["fit_bytes"],
         "forward_bytes_per_rank": fb,
         "fault": {"losses": tp[0]["fault"]["losses"],
                   "step_ms": [r["fault"]["step_ms"] for r in tp]},
         "predicted_forward": {"all_reduce_f32": pred_ar,
                               "ce_all_reduce_f32": pred_ce,
                               "collectives": len(pred)},
         "seconds": time.perf_counter() - t}
    one = c["vs_one"]
    check(one["loss_abs_diff"] <= P27_ONE_TOL["loss"]
          and one["grad_err"] <= P27_ONE_TOL["grad"]
          and one["master_max_abs_diff"] <= P27_ONE_TOL["master"]
          and one["grads_compared"] > 100,
          f"27(c) tp fit's first step differs from one process: {one}")
    check(one["fault_grad_err"] > P27_ONE_TOL["grad"],
          f"27(c) the gradient limit {P27_ONE_TOL['grad']} passes the tp "
          f"fit without the column layers' backward all-reduce: "
          f"{one['fault_grad_err']}")
    # the forward's all-reduces are the analyzer's (the embedding's and
    # the row layers'), in bf16 under O2 where it priced the f32 program
    check(fb["dist.all_reduce_bytes"] * 2 == pred_ar,
          f"27(c) forward all-reduce bytes {fb['dist.all_reduce_bytes']} "
          f"(bf16) against the analyzer's {pred_ar} (f32)")
    head = tp[0]["preset"]["head_shard_bytes"]
    check(fb["dist.all_gather_bytes"] == head,
          f"27(c) the head's all-gather {fb['dist.all_gather_bytes']} "
          f"bytes, not {head}")
    # a step: the forward's all-reduces, then one a column layer in the
    # backward (the input copy's, of the same [b, s, d] as the row layer
    # it pairs with: every forward one but the embedding's), in bf16 as
    # the column layer's input is under O2; the head's table gathered
    # once a step (its backward takes this rank's rows)
    n_ar = sum(1 for k in pred if k["kind"] == "all_reduce"
               and k["op"] != "fused_ce_op")
    fit = c["fit_bytes_per_rank"]
    want_ar = P27_TP_STEPS * fb["dist.all_reduce_bytes"] * (2 * n_ar - 1) \
        // n_ar
    check(fit["dist.all_reduce_bytes"] == want_ar
          and fit["dist.all_gather_bytes"] == P27_TP_STEPS * head
          and fit["dist.staged_bytes"] == 0,
          f"27(c) the fit's collective bytes {fit}, not all-reduce "
          f"{want_ar} and all-gather {P27_TP_STEPS * head}")
    check(all(s < c["one_state_bytes"] for s in c["state_bytes"]),
          f"27(c) state a rank {c['state_bytes']} not below one "
          f"process's {c['one_state_bytes']}")
    # 27(d): the fit under the plan's whole layout (exact-name rules):
    # bitwise the preset's fit where the plan's layout is the preset's,
    # else within (c)'s limits of one process (the differing parameters
    # are in the planner's line above)
    lvo, lvp = tp[0]["layout_vs_one"], tp[0]["layout_vs_preset"]
    if not plan["differing_rules"]:
        check(lvp["masters_bitwise"] and lvp["digest_equal"]
              and lvp["losses_bitwise"],
              f"27(d) the plan's layout is the preset's but its fit "
              f"differs: {lvp}")
    check(lvo["loss_abs_diff"] <= P27_ONE_TOL["loss"]
          and lvo["grad_err"] <= P27_ONE_TOL["grad"]
          and lvo["master_max_abs_diff"] <= P27_ONE_TOL["master"]
          and lvo["grads_compared"] > 100,
          f"27(d) the fit under the plan's layout differs from one "
          f"process: {lvo}")
    c["plan_layout"] = {"vs_one": lvo, "vs_preset": lvp,
                        "differing_rules": len(plan["differing_rules"]),
                        "step_ms": [r["plan_layout"]["step_ms"] for r in tp],
                        "state_bytes": [r["plan_layout"]["state_bytes"]
                                        for r in tp],
                        "fit_bytes_per_rank": tp[0]["plan_layout"][
                            "fit_bytes"]}
    log(f"[tp fit] GPT-2 small bf16 O2 b8 s1024 under tp 4, "
        f"{P27_TP_STEPS} AdamW steps, the preset and the plan's layout: "
        f"{json.dumps(c)}")
    res["tp_fit"] = c
    d = {"plan": plan, "staged": {
        "cuts": tp[0]["staged"]["cuts"],
        "stage_segments": tp[0]["staged"]["stage_segments"],
        "losses": tp[0]["staged"]["losses"],
        "ref_losses": tp[0]["staged"]["ref_losses"],
        "loss_rel": tp[0]["staged"]["loss_rel"],
        "step_ms": [r["staged"]["step_ms"] for r in tp],
        "launches": {k: sum(r["staged"]["launches"][k] for r in tp)
                     for k in P27_KERNELS}}}
    log(f"[staged pp] GPT-2 small's 12 blocks at pp 4, b8 s1024 / 4 "
        f"micro-batches, f32 SGD, 3 steps: {json.dumps(d['staged'])}")
    check(d["staged"]["loss_rel"] <= P27_PP_TOL,
          f"27(d) staged pipeline differs from the whole stack: "
          f"{d['staged']}")
    check(d["staged"]["stage_segments"] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                            [9, 10, 11]],
          f"27(d) stages {d['staged']['stage_segments']}")
    res["planner"] = d
    counts = {
        "launch": {k: sum(a["ranks"][r]["launches_resumed"].get(k, 0)
                          for r in (0, 1)) for k in P27_KERNELS},
        "launch_ref": {k: sum(a["ranks"][r]["launches_ref"].get(k, 0)
                              for r in (0, 1)) for k in P27_KERNELS},
        "static_dp": b["plain"]["launches"],
        "static_dp_recompute": b["recompute"]["launches"],
        "tp_fit": {k: sum(v) for k, v in c["launches_per_rank"].items()},
        "staged_pp": d["staged"]["launches"]}
    for tag in ("launch_ref", "static_dp", "static_dp_recompute", "tp_fit"):
        for kname in PATH_KERNELS:
            check(counts[tag][kname] > 0
                  and counts[tag][kname] == counts[tag][f"{kname}.sm90"],
                  f"27 {tag}: {kname} launched {counts[tag][kname]} times, "
                  f"{counts[tag][kname + '.sm90']} on the Hopper kernel")
    for kname in FLASH_KERNELS:
        check(counts["staged_pp"][kname] > 0,
              f"27(d) staged pipeline launched no {kname}")
    res["seconds"] = time.perf_counter() - t0
    log(f"[multi-process] phase 27 {res['seconds']:.1f} s (launch "
        f"{a['seconds']:.1f}, static dp {b['seconds']:.1f}, tp + pp "
        f"{c['seconds']:.1f}); card: {card}")
    return counts, res


def _multi_process_fields(rec, name, counts):
    """Phase 27's launches of one of the six training kernels, summed over
    the ranks: the launched fit's resumed attempt and its uninterrupted
    launch (2 ranks), the static program over dp 2 plain and with
    recompute, the tp 4 fit (4 ranks) and the staged pipeline (4 ranks)."""
    for tag, c in counts.items():
        rec[f"launches_p27_{tag}"] = c[name]
        rec[f"launches_p27_{tag}_sm90"] = c[f"{name}.sm90"]


# Planted faults (``python3 chip_smoke.py --faults``): each changes one
# line of a kernel source (path under paddle_tpu_torch/ops/cuda/csrc) in a
# copy of the checkout, and the phases that check that source (2-3 for the
# decode source, 6 for the CE sources, 10 for the flash ones) must fail on
# that copy. The flash faults are in the Hopper kernels that bf16 d 64 /
# 128 runs (the forward's tile count, dq's and dk/dv's ds) and in
# flash_attention.cu's dq (f32 and the other d), the CE faults in the
# Hopper forward and backward that bf16 at H % 64 == 0 runs, the decode
# faults in the split-K combine, the s = 1 kernel's loop bound and the mma
# chunk kernel's mask.
FAULTS = {
    "last_live_causal_key_tile_skipped":
        ("flash_attention_sm90.cu", "min(n, last / bn + 1)",
         "min(n, last / bn)"),
    "dkv_without_delta":
        ("flash_attention_sm90.cu",
         "const float ds = p * (dpv - dl) * a.scale;",
         "const float ds = p * dpv * a.scale;"),
    "dq_sm90_without_delta":
        ("flash_attention_sm90.cu",
         "dp[j][e] = p * (dp[j][e] - dl[e >> 1]) * a.scale;",
         "dp[j][e] = p * dp[j][e] * a.scale;"),
    "dq_without_scale":
        ("flash_attention.cu",
         "ds_s[r * ldp + c] = from_f32<T>(ds);   // rounded to k's dtype",
         "ds_s[r * ldp + c] = from_f32<T>(ds / a.scale);"),
    "ce_fwd_label_logit_dropped":
        ("fused_ce_sm90.cu",
         "if (lc == 8 * j + e) t[hf] += acc[4 * j + 2 * hf + e];",
         "if (lc == 8 * j + e) t[hf] += 0.f;"),
    "ce_ds_without_label_term":
        ("fused_ce_sm90.cu",
         "v = (p - (col == label[hf] ? 1.f : 0.f)) * g[hf];",
         "v = p * g[hf];"),
    "ce_last_chunk_dh_skipped":
        ("fused_ce_sm90.cu",
         "a.n_dh = dh != nullptr && c > 0 ? row_tiles * h_tiles : 0;",
         "a.n_dh = dh != nullptr && c > 0 && c < n_chunks ? row_tiles * "
         "h_tiles : 0;"),
    "ce_dw_k_loop_one_tile_short":
        ("fused_ce_sm90.cu",
         "kt1 = (count + kBK - 1) / kBK;   // dW: K = the listed rows",
         "kt1 = (count + kBK - 1) / kBK - 1;"),
    "decode_combine_last_split_unscaled":
        ("decode_attention.cu",
         "return split_weight(ml[((int64_t)i * rows + row) * 2], m_tot);",
         "return i == a.splits - 1 ? 1.f : split_weight(ml[((int64_t)i * "
         "rows + row) * 2], m_tot);"),
    "decode_s1_last_live_tile_skipped":
        ("decode_attention.cu",
         "const int n_tiles = lim < c_begin ? 0 : (lim - c_begin) / kTile + 1;",
         "const int n_tiles = lim < c_begin ? 0 : (lim - c_begin) / kTile;"),
    "decode_mma_mask_one_column_late":
        ("decode_attention.cu",
         "if (c > fill + r) s[j][e] = kNegInf2;",
         "if (c > fill + r + 1) s[j][e] = kNegInf2;"),
    # f16 (phase 14): the f16 products read as bf16; the f16 pack's halves
    # swapped (ds, dW and dh of the CE backward)
    "f16_flash_mma_type_bf16":
        ("flash_attention_sm90.cu",
         '"mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "',
         '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "'),
    "f16_ce_pack_halves_swapped":
        ("fused_ce_sm90.cu",
         "__half2 h = __floats2half2_rn(lo, hi);",
         "__half2 h = __floats2half2_rn(hi, lo);"),
    # the f16 decode launches told the kernels their f16 data is bf16
    "decode_f16_flag_bf16":
        ("paddle_tpu_torch/ops/cuda/decode_attention.py",
         "_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, "
         "torch.float16: 2}",
         "_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, "
         "torch.float16: 1}"),
    # the op core (phase 18's API checks): an op without its AMP cast
    # point; to_tensor on the CPU unless asked for the card
    "api_defop_skips_amp_cast":
        ("paddle_tpu_torch/ops/_dispatch.py",
         "                args, kwargs = _cast(opname, args, kwargs)",
         "                pass"),
    "api_to_tensor_on_cpu":
        ("paddle_tpu_torch/core/tensor.py",
         "    t = _coerce(data, dtype, resolve_device(place))",
         "    t = _coerce(data, dtype, resolve_device(place or 'cpu'))"),
    # the Transformer (phase 19's mask checks): the decoder's
    # cross-attention loses the source padding mask
    "transformer_cross_attention_mask_dropped":
        ("paddle_tpu_torch/nn/layer/transformer.py",
         "tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)",
         "tgt = self.cross_attn(tgt, memory, memory, attn_mask=None)"),
    # the conv ops (phase 20(a)'s oracle): XLA's SAME pads with the odd
    # element on the low side
    "vision_same_pads_low_side":
        ("paddle_tpu_torch/ops/conv.py",
         "        pads.append((total // 2, total - total // 2))",
         "        pads.append((total - total // 2, total // 2))"),
    # beam search (phase 21(a)'s score check): the StaticKVCache states
    # reordered by the chosen token in place of the parent beam
    # the trainer's host path (phase 23): the scan megastep's per-step
    # stream one step ahead (its step t, which sets AdamW's bias
    # correction; the lr is constant); train_from_dataset's resume one
    # batch late; verify_manifest not comparing hashes; the Executor's
    # nan sweep after the scope write-back
    "trainer_scan_stream_one_step_ahead":
        ("paddle_tpu_torch/static/pipeline_runner.py",
         "stream.append((lr, t, self._exe._next_seed()))",
         "stream.append((lr, t + 1, self._exe._next_seed()))"),
    "trainer_resume_skips_a_batch":
        ("paddle_tpu_torch/io/fleet_dataset.py",
         "for lo in range(int(start_batch) * bs, stop, bs):",
         "for lo in range((int(start_batch) + bool(start_batch)) * bs, "
         "stop, bs):"),
    "trainer_manifest_hashes_unchecked":
        ("paddle_tpu_torch/incubate/checkpoint.py",
         'if rec["sha256"] != ref["sha256"]:',
         'if False and rec["sha256"] != ref["sha256"]:'),
    "trainer_nan_sweep_after_write_back":
        ("paddle_tpu_torch/static/executor.py",
         "        if _flags.flag(\"FLAGS_check_nan_inf\"):\n"
         "            _sweep_step(fetches, new_scope)\n"
         "        fetches = _unalias(fetches, scope_vals)\n"
         "        write_back(scope, scope_vals, new_scope)\n",
         "        fetches = _unalias(fetches, scope_vals)\n"
         "        write_back(scope, scope_vals, new_scope)\n"
         "        if _flags.flag(\"FLAGS_check_nan_inf\"):\n"
         "            _sweep_step(fetches, new_scope)\n"),
    # the parameter-server tier (phase 24): the online trainer's delta
    # push without its replay key (a resent frozen payload applies twice,
    # 24(b)); the card cache deaf to shard-map changes (a pre-promotion
    # row served, 24(b)); the device table's insert scattering duplicate
    # slots without keeping each slot's last write (24(c))
    "ps_delta_push_without_replay_key":
        ("paddle_tpu_torch/distributed/ps/client.py",
         "            key = self._rkey(request_key, \"psd\", table)",
         "            key = None"),
    "ps_cache_ignores_map_changes":
        ("paddle_tpu_torch/distributed/ps/heter.py",
         "        if self._invalidate_pending or e != self._valid_epoch:",
         "        if False:"),
    "ps_insert_duplicates_not_deduped":
        ("paddle_tpu_torch/distributed/ps/heter.py",
         "            keep = keep[last_per_slot(slots[keep])]",
         "            keep = keep"),
    "beam_cache_gathered_by_token":
        ("paddle_tpu_torch/nn/decode.py",
         "        cache_rows = gather_idx",
         "        cache_rows = to_tensor((np.arange(b)[:, None] * k + "
         "token.cpu().numpy() % k).reshape(-1), place=logp.device)"),
}
CSRC = "paddle_tpu_torch/ops/cuda/csrc"


def fault_path(source):
    """A fault's file from the repo root: a bare name is a kernel source
    under ``CSRC``."""
    return source if "/" in source else f"{CSRC}/{source}"


def _fault_phase(name, source):
    """(phase function names, numbers) that check a fault in a source."""
    if name.startswith("f16_"):
        return ("phase_fp16_kernels",), "14"
    if name.startswith("api_"):
        return ("phase_api_checks",), "18"
    if name.startswith("transformer_"):
        return ("phase_transformer_masks",), "19"
    if name.startswith("vision_"):
        return ("phase_conv_oracle",), "20"
    if name.startswith("beam_"):
        return ("phase_beam_scores",), "21(a)"
    if name.startswith("ps_"):
        return {"ps_delta_push_without_replay_key": (
            ("phase_p24_online",), "24(b)"),
            "ps_cache_ignores_map_changes": (("phase_p24_online",), "24(b)"),
            "ps_insert_duplicates_not_deduped": (
                ("phase_p24_device_tier",), "24(c)")}[name]
    if name.startswith("trainer_"):
        return {"trainer_scan_stream_one_step_ahead": (
            ("phase_p23_modes",), "23(a)"),
            "trainer_resume_skips_a_batch": (("phase_p23_modes",), "23(a)"),
            "trainer_manifest_hashes_unchecked": (
                ("phase_p23_kill_resume",), "23(b)"),
            "trainer_nan_sweep_after_write_back": (
                ("phase_p23_nan",), "23(d)")}[name]
    if source.startswith("fused_ce"):
        return ("phase_ce",), "6"
    if "decode_attention" in source:
        return ("phase_contiguous", "phase_paged"), "2-3"
    return ("phase_flash",), "10"


def plant_faults():
    """On a copy of the checkout per planted fault, the phase that checks
    its source; 0 when the phase fails on every copy, each failure
    printed."""
    import shutil
    import tempfile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    caught = 0
    for name, (source, old, new) in FAULTS.items():
        src = fault_path(source)
        with tempfile.TemporaryDirectory() as tmp:
            copy = os.path.join(tmp, "tree")
            shutil.copytree(root, copy, ignore=shutil.ignore_patterns(
                ".git", ".build", ".scratch", "__pycache__"))
            path = os.path.join(copy, src)
            with open(path) as f:
                text = f.read()
            check(text.count(old) == 1, f"fault {name}: its line is not "
                                        f"in {src} exactly once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            phases, number = _fault_phase(name, source)
            proc = subprocess.run(
                [sys.executable, "-c", "import chip_smoke as c; c.setup(); "
                 "c.phase_build(); " + "; ".join(f"c.{p}()" for p in phases)],
                cwd=copy, capture_output=True, text=True, timeout=900)
        said = [ln for ln in (proc.stdout + proc.stderr).splitlines()
                if "chip_smoke:" in ln]
        failed = proc.returncode != 0 and bool(said)
        caught += failed
        log(f"[faults] {name}: phase {number} exit {proc.returncode}; "
            f"{said[-1] if said else 'no check failed'}")
    log(f"[faults] {caught} of {len(FAULTS)} planted faults fail their "
        f"phase")
    return 0 if caught == len(FAULTS) else 1


def setup():
    """The checkout on sys.path, and f32 products in f32 (no TF32)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f16_fields(rec, name, counts, worst, timings):
    """Phase 14's and 15's numbers of one of the five f16 kernels: its
    launches on the f16 O2 path (all, on the Hopper kernel, in f16), its
    worst error in phase 14 and its f16 times at the timed shapes; the
    overall max_abs_err takes the f16 readings in."""
    rec["launches_f16_o2"] = counts[name]
    rec["launches_f16_o2_sm90"] = counts[f"{name}.sm90"]
    rec["launches_f16_o2_f16"] = counts[f"{name}.f16"]
    rec["max_abs_err_f16"] = max(worst[torch.float16],
                                 *(t["max_abs_err"] for t in timings.values()
                                   if "max_abs_err" in t))
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["max_abs_err_f16"])
    rec["f16"] = timings


def _hapi_fields(rec, name, counts):
    """Phase 17's launches of one of the five training kernels: in each
    ``Model.fit`` run (40 steps), on the Hopper kernel and in f16."""
    for dtype, c in counts.items():
        tag = {"float16": "f16", "bfloat16": "bf16"}[dtype]
        rec[f"launches_hapi_{tag}"] = c[name]
        rec[f"launches_hapi_{tag}_sm90"] = c[f"{name}.sm90"]
        rec[f"launches_hapi_{tag}_f16"] = c[f"{name}.f16"]


def _trainer_host_fields(rec, name, counts):
    """Phase 23's launches of one of the six training kernels: the
    in-flight-2 train_from_dataset run of 23(a) (40 steps) and 23(e)'s
    streamed GPT-2 steps, all and on the Hopper kernel."""
    for tag, c in (("tfd", counts["tfd"]),
                   ("stream_train", counts["stream_train"])):
        rec[f"launches_{tag}"] = c[name]
        rec[f"launches_{tag}_sm90"] = c[f"{name}.sm90"]


def _distributed_fields(rec, name, counts):
    """Phase 25's launches of one of the six training kernels, summed over
    the ranks: the DataParallel BERT-base steps (f32 and bf16 O2, 2 ranks
    x 2 steps), and for the flash kernels the recompute check's GPT-2
    block and, for the forward, the ring and Ulysses calls (4 ranks)."""
    for tag in ("f32", "bf16"):
        rec[f"launches_dp_{tag}"] = counts["dp"][tag][name]
        rec[f"launches_dp_{tag}_sm90"] = counts["dp"][tag][f"{name}.sm90"]
    if name in FLASH_KERNELS:
        rec["launches_recompute"] = counts["recompute"].get(name, 0)
    if name == "flash_fwd":
        for tag, c in counts["ring"].items():
            rec[f"launches_{tag}"] = c["flash_fwd"]
            rec[f"launches_{tag}_sm90"] = c["flash_fwd.sm90"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    setup()
    t_all = time.perf_counter()
    card = phase_build()
    worst_c = phase_contiguous()
    worst_p = phase_paged()
    counts, serve = phase_main_path()
    timings = phase_timings(serve["block_size"])
    timings16 = phase_timings(serve["block_size"], torch.float16)
    worst_ce = phase_ce()
    equiv = phase_bert_equivalence()
    ce_counts, flagship = phase_flagship()
    ce_bert, ce_gpt = phase_ce_timings()
    worst_fl = phase_flash()
    gpt_equiv = phase_gpt_equivalence()
    ls_counts, longseq = phase_longseq()
    fl_timing, sweep = phase_flash_timings()
    worst_ce16, worst_fl16 = phase_fp16_kernels()
    ce16, fl16 = phase_fp16_timings()
    o2_counts, o2 = phase_o2_f16()
    o2_equiv = phase_o2_f16_equivalence()
    hapi_counts, hapi = phase_hapi(card, flagship, o2)
    dy_counts, dy_serve_counts, dygraph = phase_dygraph(card)
    tf_counts, tf_decode_counts, transformer = phase_transformer(card)
    vision = phase_vision(card)
    generation, gen_counts = phase_generation(card)
    st_counts, static_res = phase_static(card)
    th_counts, trainer_host = phase_trainer_host(card)
    ps_counts, ps_res = phase_ps(card)
    p25_counts, p25 = phase_distributed(card)
    p26_counts, p26 = phase_fleet_training(card)
    p27_counts, p27 = phase_multi_process(card)
    kernels = []
    for name, worst in (("decode_attention", worst_c),
                        ("paged_decode_attention", worst_p)):
        rec = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": counts[name],
               "launches_sm90": counts[f"{name}.sm90"],
               "launches_mma": counts[f"{name}.mma"]}
        rec.update(timings["serve_decode"][name])
        for shape, t in timings.items():
            if shape != "serve_decode":
                rec[shape] = t[name]
        # over every comparison of phases 2-3 and the timed shapes
        rec["max_abs_err"] = max(*worst.values(),
                                 *(t[name]["max_abs_err"]
                                   for t in (*timings.values(),
                                             *timings16.values())))
        rec["max_abs_err_f32"] = worst[torch.float32]
        rec["max_abs_err_f16"] = max(worst[torch.float16],
                                     *(t[name]["max_abs_err"]
                                       for t in timings16.values()))
        rec["f16"] = {shape: t[name] for shape, t in timings16.items()}
        for key in ("", ".f16", ".sm90", ".mma"):
            rec[f"launches_dygraph_serve_f16{key.replace('.', '_')}"] = \
                dy_serve_counts[name + key]
        # phase 19's greedy decoding (the contiguous kernel only)
        rec["launches_transformer"] = tf_decode_counts[name]
        rec["launches_transformer_sm90"] = tf_decode_counts[f"{name}.sm90"]
        # phase 23(e): the serve loop that fed the stream
        rec["launches_stream_serve"] = th_counts["serve"][name]
        rec["launches_stream_serve_sm90"] = th_counts["serve"][f"{name}.sm90"]
        # phase 24(b): the online loop's serve legs (before and after the
        # two hot swaps)
        rec["launches_online_serve"] = ps_counts.get(name, 0)
        rec["launches_online_serve_sm90"] = ps_counts.get(f"{name}.sm90", 0)
        # phase 25(a): the capacity calibration and the three hub-scored
        # replays
        rec["launches_capacity"] = p25_counts["capacity"][name]
        rec["launches_capacity_sm90"] = p25_counts["capacity"][f"{name}.sm90"]
        # phase 21: beam search's steps and the exported program's run
        # (contiguous), the three traffic replays and the block-size
        # sweep (paged)
        for tag, c in (("beam", gen_counts["beam"]),
                       ("export_run", gen_counts["export"]),
                       ("block_sweep", gen_counts["block_sweep"]),
                       *((f"traffic_{k}", v) for k, v in
                         gen_counts["traffic"].items())):
            rec[f"launches_{tag}"] = c[name]
            rec[f"launches_{tag}_sm90"] = c[f"{name}.sm90"]
        kernels.append(rec)
    for name in CE_KERNELS:
        rec = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": ce_counts[name],
               "launches_longseq": ls_counts[name]}
        if name in OTHER_SOURCE:
            rec["launches_sm90"] = ce_counts[f"{name}.sm90"]
            rec["launches_longseq_sm90"] = ls_counts[f"{name}.sm90"]
            rec["source_f32_other_h"] = OTHER_SOURCE[name]
        rec.update(ce_bert[name])
        rec["gpt_head"] = ce_gpt[name]
        # over every comparison of phase 6 and both timed shapes
        rec["max_abs_err"] = max(*worst_ce[name].values(),
                                 ce_bert[name]["max_abs_err"],
                                 ce_gpt[name]["max_abs_err"])
        rec["max_abs_err_f32"] = worst_ce[name][torch.float32]
        _f16_fields(rec, name, o2_counts, worst_ce16[name],
                    {shape: t[name] for shape, t in ce16.items()})
        _hapi_fields(rec, name, hapi_counts)
        rec["launches_dygraph"] = dy_counts[name]
        rec["launches_dygraph_sm90"] = dy_counts[f"{name}.sm90"]
        rec["launches_transformer"] = tf_counts[name]
        rec["launches_transformer_sm90"] = tf_counts[f"{name}.sm90"]
        rec["launches_static"] = st_counts[name]
        rec["launches_static_sm90"] = st_counts[f"{name}.sm90"]
        _trainer_host_fields(rec, name, th_counts)
        _distributed_fields(rec, name, p25_counts)
        _fleet_training_fields(rec, name, p26_counts)
        _multi_process_fields(rec, name, p27_counts)
        if name == "fused_ce_bwd_dw":
            rec["max_rel_err"] = max(*worst_ce["dw_max"].values(),
                                     *worst_ce["db_max"].values(),
                                     ce_bert[name]["max_rel_err"],
                                     ce_gpt[name]["max_rel_err"])
        kernels.append(rec)
    for name in FLASH_KERNELS:
        rec = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": ls_counts[name],
               "launches_flagship": ce_counts[name]}
        if name in OTHER_SOURCE:
            rec["launches_sm90"] = ls_counts[f"{name}.sm90"]
            rec["launches_flagship_sm90"] = ce_counts[f"{name}.sm90"]
            rec["source_f32_other_d"] = OTHER_SOURCE[name]
        rec.update(fl_timing["longseq"][name])
        rec["flagship_shape"] = fl_timing["flagship"][name]
        # over every comparison of phase 10 and the timed shapes
        rec["max_abs_err"] = max(*worst_fl[name].values(),
                                 fl_timing["longseq"][name]["max_abs_err"],
                                 fl_timing["flagship"][name]["max_abs_err"])
        rec["max_abs_err_f32"] = worst_fl[name][torch.float32]
        _f16_fields(rec, name, o2_counts, worst_fl16[name],
                    {shape: t[name] for shape, t in fl16.items()})
        _hapi_fields(rec, name, hapi_counts)
        rec["launches_dygraph"] = dy_counts[name]
        rec["launches_dygraph_sm90"] = dy_counts[f"{name}.sm90"]
        rec["launches_transformer"] = tf_counts[name]
        rec["launches_transformer_sm90"] = tf_counts[f"{name}.sm90"]
        rec["launches_static"] = st_counts[name]
        rec["launches_static_sm90"] = st_counts[f"{name}.sm90"]
        _trainer_host_fields(rec, name, th_counts)
        _distributed_fields(rec, name, p25_counts)
        _fleet_training_fields(rec, name, p26_counts)
        _multi_process_fields(rec, name, p27_counts)
        if name == "flash_fwd":     # 22(c): each jit route's forward
            rec["launches_jit"] = {
                r: c["flash_fwd"] for r, c in
                static_res["jit"]["flash_fwd_launches"].items()}
        if name == "flash_fwd":     # phase 19's decoding: the cross-attention
            rec["launches_transformer_decode"] = tf_decode_counts[name]
            rec["launches_transformer_decode_sm90"] = \
                tf_decode_counts[f"{name}.sm90"]
        kernels.append(rec)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels, "serve_bf16": serve,
                      "bert_f32_equivalence": equiv,
                      "flagship_bf16": flagship,
                      "gpt_f32_equivalence": gpt_equiv,
                      "longseq_bf16": longseq, "min_seq_sweep": sweep,
                      "flash_whole_backward": {
                          shape: t["whole_backward"]
                          for shape, t in fl_timing.items()},
                      "ce_bwd": {"bert_head": ce_bert["fused_ce_bwd"],
                                 "gpt_head": ce_gpt["fused_ce_bwd"]},
                      "ce_whole_backward": {
                          "bert_head": ce_bert["whole_backward"],
                          "gpt_head": ce_gpt["whole_backward"]},
                      "o2_f16": o2, "o2_f16_equivalence": o2_equiv,
                      "hapi": hapi, "dygraph": dygraph,
                      "transformer": transformer, "vision": vision,
                      "generation": generation, "static": static_res,
                      "trainer_host": trainer_host, "ps": ps_res,
                      "distributed": p25, "fleet_training": p26,
                      "multi_process": p27}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase23-child"] and len(sys.argv) == 5:
        _p23_fit_child(*sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:] == ["--faults"]:
        sys.exit(plant_faults())
    if sys.argv[1:2] in (["--compare"], ["--attribute"],
                         ["--compare-serve"]) and len(sys.argv) == 3:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        run = {"--compare": compare, "--attribute": attribute,
               "--compare-serve": compare_serve}[sys.argv[1]]
        sys.exit(run(os.path.abspath(sys.argv[2])))
    sys.exit(main())
