#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, runs its kernels right and
serves.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is printed as a
result unless every phase passed). The kernels build in a thread while
the training that launches none of them runs first: phase 15 (a)'s remat
turns, then phase 18 (a) and its one-device references; phase 1 then
reads the build, and phases 2-15 follow in order. Then phase 18's gloo
ranks start and run beside phases 16 and 17, and are read while phase
17's own ranks run (every profiled phase runs before phases 16 and 17:
after their NCCL serving the profiler lost a trace's records):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. the W4A8 kernel (``w4a8_matmul``) against its plain version on the card
   at the main path's shapes — M in {1, 4, 8, 64, 256, 300, 512} (decode to
   the paged engine's largest prompt, and 512, phase 10's batched
   admit) x (K, N) in {(960, 960),
   (960, 320), (960, 2560), (2560, 960)}, uint8 and int8 activation codes,
   bf16 output, plus a ragged M=3, N=100 case and the ragged-N shapes
   (N % 4 != 0, the kernel's byte loader: xlstm-350m's sLSTM ``up`` at
   (M, K, N) = (4, 1024, 1365), (64, 1024, 1365), (256, 1024, 1365),
   tiny-xlstm's (4, 64, 85) and N = 1), each launching once with the
   ragged plan — all bit-equal; the P_I
   certificate check on an l1-budgeted weight; per shape the kernel's plan
   (path, grid, K chunks), its time, the plain version's, the
   ``torch._int_mm`` yardstick's and the byte/operation bound, per M the
   sums over one layer's 7 sites beside the previous kernel's, and the
   wrapper's host time a call with its plan cached and computed anew, and
   B6's (``norm_and_quantize``) beside it: both before any profiler trace,
   since earlier traces in a process raise a call's host time;
3. the slice: smollm-360m at full width (32 layers, d_model 960, bf16,
   seeded random init), RTN-packed, greedy ``GenerationEngine.generate`` of
   batch 4 x prompt 64 + 16 new tokens: an eager prefill, then 15 replays
   of the bucket's decode step, captured once as a CUDA graph by the
   engine's first call. The kernel's launch counter (which adds, per
   replay, what the capture recorded) must rise by 7 sites x 32 layers x
   16 forwards = 3584 over that run (224 of them in the prefill, at M =
   256); its tokens must equal the eager ``generate_host_loop``'s and the
   ``reference`` backend's; one generate's decode runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync between the
   prefill and the final read). The profiled eager decode step's and the
   profiled replay's w4a8 kernels, counted by name, must each equal the
   launch counter's 224 (a replay's trace counts only when it holds a
   device record for every node of the graph). It prints the captured
   generate and the eager host loop timed in turns, a replayed and an
   eager decode step in turns (median and spread of 6 runs each), the
   capture time, the memory the bucket holds and peak memory with and
   without the graph, and the card's busy share of a replayed step.

4. the GPFQ panel solver (``gpfq_solve``, kernel B5) against its plain
   version on the card at the (K, C) shapes of one smollm-360m layer —
   (960, 960), (960, 320), (960, 2560), (2560, 960) — with H and G H^-1 from
   2048 seeded samples X and a distinct perturbed copy Xq = X + 0.05 noise
   (as in calibration, where the quantized stream differs from the float
   one, so G H^-1 != H and <h_k, g_k> != |h_k|^2: a kernel that mixed up the
   two matrices would fail), the AXE state of P_I = 16, T = 128 and 8-bit
   unsigned activations, the act_order permutation and permuted tile ids;
   plus (960, 320) in round-to-zero, in joint mode (signed activations) and
   without AXE, and (8192, 64) (128 row blocks, one U tile of channels).
   Each case holds tie-limited agreement (codes equal in every channel up
   to the first row whose pre-rounding value lies within 1e-3 of a rounding
   boundary), pos/neg equal to the tile sums of the kernel's own codes
   exactly, the certificate of the kernel's codes, a second run
   bit-identical to the first (Q, U, pos, neg), and U equal to
   Xg^T W - Xh^T Q recomputed in float64 from the kernel's own codes
   (rtol 1e-4); it prints the block plan (64-row blocks, 2 + 2 x K/64
   kernels), the device kernels one solve launched (counted by the C
   launcher, held to the plan), the time of the per-panel kernel it
   replaced (commit fbec649) beside the kernel's, and for the split cases
   a profiler view of one solve (its kernels by name, held to the plan,
   and their span);
5. the calibration slice: smollm-360m at full width in float32 (the
   reference's solvers take float32 weights), ``calibrate_and_quantize``
   with the default ``PTQConfig`` on 4 x 4 x 128 tokens — exactly 224 B5
   launches (7 sites x 32 layers) and 224 certified sites; its wall time;
   a second, instrumented calibration for the breakdown of that time (B5's
   share and its sum per layer) — then the
   exported v2 artifact, written with ``save_pytree`` and loaded back,
   served greedy (batch 4 x prompt 64 + 16 new, B1 with float32 output and
   the calibrated static activation quantizers) through the captured
   decode step: exactly 3584 B1 launches and tokens identical to the
   ``reference`` backend and to the eager host loop;
6. the paged decode-attention kernels (B2 ``paged_decode_attention`` on
   float pages, B3 on int8 pages) against their plain versions on the card
   over the reference sweep's shapes (hd 16, 7 and 11, bs 8/16/128, ragged,
   exact and +-1 lengths, odd heads, softcap) and smollm-360m's (nh 15,
   nkv 5, hd 64, bs 64, 4 slots of 1/63/64/65 and 80/2048 tokens), f32 and
   bf16: B2 within 1e-5 (f32) or one bf16 ulp; B3 within 5e-2 everywhere
   and within 1e-4 (f32) or one bf16 ulp on rows with no q or probability
   code within 1e-3 of a rounding boundary, watermarks equal to the plain
   version's, and the full-magnitude case reaching qk_worst_abs and
   pv_worst_abs exactly; idle slots (length 0) give 0. The cases include
   rows across the kernels' split boundaries in PagedEngine's 512-page
   table (1 token beside 2048, idle slots, k * S * bs +- 1 tokens for the
   card's split count S). One B2 and one B3 call run under
   ``torch.cuda.set_sync_debug_mode("error")`` (the wrapper reads no
   length on the host). Each is timed at smollm-360m decode (4 slots x 80
   and x 2048 tokens, 1 x 2048, 16 x 512, bf16, 512-page table) beside its
   split count, its byte bound, its plain version,
   ``scaled_dot_product_attention`` on K/V gathered beforehand (the
   yardstick; the port never calls it) and the first kernels' time;
7. the paged slice: smollm-360m at full width, bf16, RTN-packed, through
   ``PagedEngine`` (block 64, 64 pages, 4 slots, chunks of 8, attention
   ``auto``), every decode chunk replaying the engine's one captured step:
   (a) 4 x prompt 64 + 16 new against ``GenerationEngine``, tokens
   identical or tie-limited, and identical to the eager chunk's (the
   logits of the tie-limited comparisons are recorded on the eager chunk,
   which reads them to the host); (b) 12 requests of seeded lengths
   (prompts 8-300, 4-32 new) admitted mid-flight into 4 slots, float then
   int8 KV (with the B3 watermark check), each engine warmed by one short
   request that captures its step: B2/B3 launches exactly 32 per decode
   step, B1 launches 224 per forward, every page back on the free list,
   equal allocator digests, and streams, digest and watermarks equal to
   the same trace through the eager chunk; then a decode chunk over 4 live
   slots replayed and eager in turns (6 each), float and int8; (c) the
   prefix cache: six requests over a shared 128-token prefix and one fully
   cached prompt, warm streams against a cold engine's (identical or
   tie-limited; both equal to the eager chunk's), the cached admit adding
   0 to every kernel counter. It prints decode-step time, tokens/s, admit
   time, capture time, peak memory and a profiler breakdown of 8 replayed
   decode steps (a trace each, at most 48 traced; a step whose trace lost
   device kernel records is run but not counted, and says where it lost
   them; with no complete trace the breakdown is "not measured"), whose
   w4a8 kernels, counted by name, must equal the launch counter's 224 a
   step. Every count by name is
   taken on a trace that holds a device record for each launch it
   recorded, and for each graph node of each replay (phase 3 and phase 8
   profile a call again until one does).

8. the 2:4 kernels: B4 (``w4a8_sparse_matmul``) at phase 2's shapes,
   uint8 and int8 codes, bit-equal to its plain version and to B1 on the
   expanded codes, the P_I check on an l1-budgeted 2:4 weight, and per
   shape its plan and time beside B1's, the plain version's, ``torch._int_mm`` on
   the expanded int8 codes and ``torch.sparse.to_sparse_semi_structured``
   int8 x int8 (or the library's refusal); B5 with a 2:4 mask at one
   layer's shapes (tie-limited agreement, exact pos/neg, zeros where the
   mask is 0, U consistent with its own codes, the sparse certificate)
   timed masked and unmasked; B6 (``quant_rmsnorm``) driven once through
   ``ops.norm_and_quantize`` at RMSNORM_DRIVEN's shapes (the launch
   counter, and the profiler's one device kernel a call, by name, with
   Python-number and device-scalar quantizers), then the sweep: M in {4,
   256, 4096} x D in {960, 3072, 8192, 16384} and (512, 1024), (1024,
   4096), f32 and bf16, and rows staged through shared memory ((4, 32768)
   and (256, 65536) f32, and (256, 16384) f32 at a 4-byte offset), each
   bit-equal to ``quant_rmsnorm_model`` and
   within one code of its plain version on under 1% of elements, timed in
   3 rounds by events beside an empty kernel on the same grid, by the
   profiler, beside ``F.rms_norm`` alone, the plain version and the byte
   bound, and its three targets printed met or missed (B6's wrapper host
   time a call is taken in phase 2, before any profiler trace);
9. the 2:4 slice: the float32 smollm-360m calibrated with
   ``PTQConfig(sparsity="2:4")`` (exactly 224 masked B5 launches, 224 sites
   certified at sparsity 2:4, each site's register floor beside phase 5's
   dense one), its artifact saved, loaded and served greedy (batch 4 x
   prompt 64 + 16 new) through the captured step: exactly 3584 B4 launches
   and 0 B1, tokens identical to the ``reference`` backend and the eager
   host loop; then the bf16 model RTN-packed with
   ``DatapathSpec(sparsity="2:4")`` through ``PagedEngine`` (its step
   captured by a warm-up request) over phase 7's 12-request trace: B4
   launches 224 per forward, 0 B1, every page back on the free list. It
   prints decode-step time, tokens/s, peak memory and
   ``packed_weight_bytes`` dense vs 2:4;
10. the throughput slice: phase 7's model and pool through
   ``PagedEngine``'s throughput loop, each engine's step captured by a
   warm-up request. (a) ``SchedulerPolicy(admit_window=4, batch_max=4,
   prefill_chunk=128)``, float then int8 KV, over 4 cold prompts of 65-128
   tokens (one batched group, M = 512) followed by phase 7's 12-request
   trace: B2/B3 launches exactly 32 per decode step, B1 224 per forward
   (decode steps, B = 1 admits, batched groups and prefill chunks), at least
   one batched group, one stub and one prefill chunk, one capture, B3
   watermarks within P_qk/P_pv, every page back on the free list, and
   streams tie-limited against the FIFO engine on the same trace (logits
   recorded through the replays, ``ReplayRecorder``); it prints the admit
   side split into batched groups, B = 1 admits, stubs and prefill chunks,
   the decode step, tok/s, wall and peak memory beside the FIFO engine's on
   the same trace and phase 7's figures. (b) ``SchedulerPolicy(
   admit_window=2, batch_max=4, watermark=(1, 4))`` on float KV in a
   12-page pool over phase 7's prompts with 4x their new tokens, its
   logits recorded on the measured run: at least one grow and one
   preemption, the same launch and pool gates, streams tie-limited against
   FIFO. The kernels line adds each of B1, B2 and B3's
   launches in (a) float, (a) int8 and (b) as ``throughput_launches``;
11. the MoE family on granite-moe-3b-a800m (32 layers, d_model 1536, 24/8
   heads, 40 experts top-8, d_ff_expert 512). First the expert-axis
   kernels B1e (``w4a8_expert_matmul``) and B4e
   (``w4a8_sparse_expert_matmul``), one launch for all E experts of a
   site, bit-equal to their plain versions (E calls of B1's and B4's) at E
   in {8, 40} x M in {1, 4, 8, 9, 16, 17, 48, 49, 64, 65, 80} rows an
   expert (each side of the tier boundaries: the decode tier up to 48 and
   from 65 to 80, between them for wd only, its widths split at 16 | 17)
   x (K, N) in {(1536, 512),
   (512, 1536)}, uint8 and int8 codes, one expert's input all zero, and a
   ragged E=5, M=3, N=60 case; at E = 40 each shape's plan (tier, grid, K
   chunks) and time beside the time before the decode tier (a constant,
   PREVIOUS_EXPERT_US), at M = 4 the kernels' device time by the profiler, the plain
   versions', 40 ``torch._int_mm`` calls on the unpacked codes, one bf16
   ``torch.bmm`` on the dequantized stack, one copy of the packed stack
   (each byte read and written once) and the byte bound, and at M = 4
   B1e after a flush by a read (a clean cold L2: no dirty line to write
   back); B4e also on a hand-made meta of every position pair, equal ones
   summed, at M = 4, 17, 64, 80; per M one layer's sums, and the decode
   tier's targets printed met or missed (``[expert-target]``); B1 at
   granite's dense sites (1536, 1536) and (1536, 512), M = 4 and 256.
   Then the slice at full width, bf16, seeded random init, RTN-packed:
   (a) ``GenerationEngine.generate`` of batch 4 x prompt 64 + 16 new,
   one capture: B1e exactly 96 launches a forward (3 sites x 32 layers)
   and B1 128 (4 attention sites x 32), a replay adding 96 and 128; greedy
   streams tie-limited against the eager host loop (the replays' logits
   recorded by ``FixedRecorder``); generate and decode step captured vs
   eager in turns, tokens/s, peak memory and ``packed_weight_bytes``; one
   replayed step profiled on a complete trace (``[moe-profile]``: the
   device's busy share of its span, B1e's and B1's device time and share,
   counted by kernel name and held to 96 and 128);
   (b) ``PagedEngine``'s FIFO loop over phase 7's 12-request trace, float
   then int8 KV, its step captured by a warm-up request: B2/B3 32 a step,
   B1e 96 and B1 128 a forward, every page back on the free list, and the
   4 prompts of (a) served alone through the paged engine tie-limited
   against the fixed slot run of each prompt alone (a dispatch group's
   tokens share expert capacity, so a batched prefill routes otherwise);
   (c) AXE-GPFQ calibration (default ``PTQConfig``) of a float32 cut to 4
   of the 32 layers at full width on phase 5's batches: exactly (4 + 3 x
   40) x 4 = 496 B5 launches, every site certified and every expert of a
   stack on its own, register floors per site, the artifact served through
   (a)'s path with tokens identical to the reference backend and the host
   loop; (d) the same cut RTN-packed at ``DatapathSpec(sparsity="2:4")``:
   B4e 3 and B4 4 a layer a forward, 0 B1e and 0 B1. The kernels line
   gains B1e's launches from (a) and B4e's from (d);
12. the mixed-precision search on smollm-360m at full width (float32
   copy, phase 5's batches). (a) ``repro_torch.launch.search`` at the
   uniform P_I = 20, T = 128 with ``--kv-static``: exactly 224 B5 solves,
   224 sites certified before and after the P_I-only re-spec, the searched
   perplexity bit-identical to the uniform one, savings rate >= 1; it
   prints both accumulator budgets, the floor per slot site and the wall
   time. (b) ``repro_torch.launch.serve --artifact --plan --packed --paged
   --kv-dtype int8`` (its ``plan validated`` line counting all 224 packed
   sites), then phase 7's 12-request trace through ``PagedEngine`` with the
   plan's static KV scales and with dynamic int8 pages, each step captured
   once: B3 32 a step inside P_qk / P_pv, B1 224 a forward, the static
   engine's installs all through the static quantizer (no per-page max:
   counted by a spy on the engine's two install quantizers), fewer device
   operations in its replay; it prints per path the replayed step in
   turns (median and spread of 6), the device operations of a replay,
   admit time and tok/s, and how far the greedy streams agree before they
   part with each parting's top-2 gap (tie-limited: no gate). (c) the
   launcher with ``--sparsify 2 --promote-w8 1``: 2 x 224 B5 solves, 64 of
   them masked (the re-calibration's 2:4 slot sites), every int4 site
   certified, a second re-calibration from ``plan.json`` bit-identical,
   served through ``GenerationEngine``: B4 64 and B1 128 a forward, none
   for the float w8 site, tokens equal to the reference backend. Each of
   phase 12's lines carries the card's name and power limit as
   ``nvidia-smi`` prints them. The kernels line gains each kernel's
   ``search_launches``;
13. the serving observers on smollm-360m at full width, reusing phase
   12's static-act artifact and ``plan.json`` (nothing calibrates). (a)
   Phase 7's 12-request trace through two ``PagedEngine``s alike but for
   ``observe``, with the plan's static KV scales on int8 pages, in turns
   (plain, observed, observed, plain): greedy streams identical, one
   capture each, B1 224 a forward and B3 32 a step in both (the taps
   ride inside the observed engine's captured step), the saturation
   report's 7 labels with ``n_calls`` = 32 x decode steps, ``clip_total``
   = ``n_calls`` x rows x K, ``clip_count <= clip_total``, every
   watermark inside its P_I (headroom = P_I - bits within 1e-3) and every
   KV head's inside P_qk / P_pv; ``assert_observation_transparent`` on
   the card's graph nodes; it prints the replayed step observed against
   bare in turns (median and spread of 6), the device operations a replay
   adds, tok/s, the fold's host time and per site the clip fraction, code
   range, watermark and headroom, per KV head the watermark bits. (b) A
   drift trace (another seed, ids below 256) through the same observed
   engine: per-site clip fractions beside (a)'s (a measurement, no
   gate). (c) Phase 7's bf16 RTN model with dynamic activations on float
   pages, observed: no clip at any site, no KV section, streams equal to
   phase 7's; then ``launch/serve.py --artifact --plan --packed --paged
   --kv-dtype int8 --observe`` must print its ``observed 7 sites;
   binding watermark:`` line. The kernels line gains B1's, B2's and B3's
   ``observe_launches``;
14. the recurrent families. (a) xlstm-350m at full width (24 layers: 21
   mLSTM, 3 sLSTM; d_model 1024, bf16, seeded random init), RTN-packed:
   111 packed sites, the three sLSTM ``down`` projections (K = 1365, odd)
   float as in the reference; B1 bit-equal to its plain version at each
   of the model's packed (K, N) at M = 4 and 256, with plan, time and
   bound; ``GenerationEngine.generate`` of batch 4 x
   prompt 64 + 16 new on the captured step (the recurrent states are
   written in place): B1 exactly 111 a forward (the counter, and a
   replay's nodes by name), streams tie-limited against the eager host
   loop, generate and decode step captured vs eager in turns, prefill
   time, a replay profiled on a complete trace (B1's share of busy); the
   state MiB a slot, peak memory and packed weight bytes; then phase 7's
   12 requests through ``PagedEngine``'s FIFO loop in 4 slots (B1 111 a
   forward, every page back on the free list, streams and digest equal to
   the eager chunk's, a chunk replayed vs eager in turns). (b) AXE-GPFQ
   calibration of a float32 copy at full depth on phase 5's batches: one
   B5 solve a site (114), every site certified; the v2 artifact saved,
   loaded strictly and served (B1 111 a forward, tokens identical to the
   reference backend and the host loop). (c) One Mamba block at
   jamba-1.5-large-398b's widths (d_model 8192, d_in 16384, d_state 16,
   dt_rank 512), bf16, RTN-packed: B1 bit-equal to its plain version at
   the block's four (K, N) (K up to 16384) at M = 4 and 256; for each
   input seed of MAMBA_SEEDS a parallel prefill of 4 x 64 and 16 decode
   steps from its state (B1 4 a step), against the block run step by step
   from zero, through the dequantized weights and through B1 with one
   static activation quantizer a site (MAMBA_STEP_TOL); its scan against the f32 step-by-step recurrence
   (MAMBA_SCAN_TOL). (d) tiny-hybrid RTN-packed
   through the paged FIFO loop, float and int8 pages: B1 11 and B1e 3 a
   forward, B2/B3 1 a step, streams and digest equal to the eager
   chunk's. The kernels line gains ``recurrent_launches`` on B1, B2, B3,
   B5 and B1e;
15. training, checkpoint restore and the registry. (a) smollm-360m in f32
   at full width trains 20 steps of 8 x 128 TokenBatcher tokens through
   ``launch/train.py`` (lr 5e-3 with the optimizer's default warmup of 100
   steps, so 9.5e-4 at step 20; deterministic algorithms; a
   checkpoint every 10 steps): the loss falls and no port kernel
   launches; a blocking write and a restore of the whole train state,
   timed; a second run resumes from the step-10 checkpoint and must reach
   step 20's loss within rel 1e-6 and its params within atol 1e-7 (the
   reference's resume tolerance; bit-equality is reported);
   ``launch/quantize.py --ckpt-dir`` calibrates the checkpoint (224 B5
   solves, every site certified, float and quantized perplexity);
   ``launch/serve.py --ckpt-dir --artifact --paged`` serves it, and the
   trained artifact serves phase 7's trace through ``PagedEngine``; then
   the same model from one init trains at its config's ``remat="block"``
   and at ``"none"``, a step of each in turns (REMAT_STEPS): each one's
   step time and peak memory, the losses equal and the states bit-equal
   after. (b)
   tiny-lm-l trained with the paper-table recipe (400 steps, batch 8 x 96,
   lr 1e-3, warmup 20, data seed 7), calibrated with AXE-GPFQ at P_I = 16
   (28 B5 solves, every site certified): quantized against float
   perplexity, the quantized under 1.5x the float. (c) stablelm-3b,
   phi4-mini-3.8b and musicgen-medium, bf16 from a seeded init at full
   width cut to REGISTRY_LAYERS layers, RTN-packed, one at a time: B1
   bit-equal at each packed (K, N) at M = 4 and 256; batch 4 x prompt 64
   + 16 new on the captured fixed-slot step (B1 exactly sites x 16, tokens equal to the eager host loop's, a
   replayed and an eager step in turns); the short trace (phase 7's
   PAGED_SLOTS + 1 shortest prompts and its longest, at most SHORT_MAX_NEW
   new tokens each: requests queue and take freed slots) through the FIFO
   paged engine, float and int8 pages. Phase 6 holds B2/B3 at the
   registry's attention shapes (head dim 80 and 128, groups 1-16) and
   times them in its timed loop beside the plain versions and SDPA (rows
   of B2's and B3's ``shapes``, each naming its ``arch``). The kernels
   line gains ``training_launches`` on B1, B2, B3 and B5 and
   ``registry_sites`` on B1;
16. mesh-sharded paged serving over ``torch.distributed``. (a) The
   production backend at world size 1: NCCL, ``parse_mesh_spec("auto")``
   (one rank on the data axis), smollm-360m bf16 RTN at full width through
   ``PagedEngine(mesh=)`` with the reference attention (the mesh rule) and
   its decode step captured with the collectives inside, phase 7's trace
   with float and int8 pages: B1 exactly 224 a forward, B2/B3 none,
   streams and digest identical to a one-device engine with the same
   attention (size-1 collectives are identities), the collectives a step
   issues, and a replayed chunk of each in turns. (b) Two ranks sharing
   the card over gloo (NCCL refuses two ranks on one device), mesh (1, 2),
   phi4-mini-3.8b bf16 RTN at full width (24/8 heads, d_ff 8192, vocab
   200064: q/k/v, wg/wu and the head shard N, wo/wd K), cut to
   MESH_B_LAYERS of its 32 layers: B1 bit-equal to
   its plain version at every sharded (K, N), checked here before the
   ranks start (this script with ``--mesh-rank``; the kernels are built
   in this process first), then each rank serves the short trace with
   float and int8 pages, eagerly (gloo stages through the host):
   tie-limited against a one-device engine on the card, the logits'
   largest relative error, digests equal on both ranks, each rank's
   placed weights and peak memory against half the packed weight bytes,
   the eager step time. The kernels line gains ``mesh_launches`` and
   ``mesh_sites`` on B1;
17. MoE and recurrent patterns under the mesh. (a) NCCL at world size 1:
   granite-moe-3b-a800m bf16 RTN at full width through ``PagedEngine(
   mesh=)``, phase 7's trace on float pages, its decode step captured with
   B1e inside (96 B1e and 128 B1 kernel nodes by name): streams and digest
   identical to a one-device engine with the same attention, B1e 96 and B1
   128 a forward, a replayed step of each in turns. Then, before the ranks
   start: B1e and B4e, and their accumulator-only form, bit-equal to their
   plain versions at granite's expert shards (E, K, N) in
   GRANITE_SHARD_SITES at M = 1, 4 and 64, timed beside a bf16 ``bmm`` and
   the byte bound; B1 at the (1, 2) shards of xlstm-350m and of the
   Jamba-width Mamba block (with ``_int_mm`` beside). Then two gloo ranks
   sharing the card (this script with ``--family-rank``): (b) granite on a
   (2, 1) mesh, 20 experts a rank, (c) xlstm-350m on a (1, 2) mesh, each
   serving the short trace on float pages (more requests than slots: a
   freed slot reused and, for xlstm, an end state installed into a
   recycled lane while the others decode): B1e/B1 exactly their
   sites a forward, streams tie-limited against a one-device engine on the
   card, digests equal on both ranks, the placed expert bytes a rank
   against half the stacks' bytes, the state MiB a slot a rank against
   the one-device figure, the serve's peak memory; (d) the Mamba block on
   8192 of its 16384 channels, a 4 x 64 prefill and 16 decode steps within
   MAMBA_STEP_TOL (relative L2) of its one-device run. The kernels line
   gains ``family_launches`` on B1 and B1e, ``family_sites`` on B1 and
   ``family_shards`` on B1e and B4e;
18. training on the mesh. Two gloo ranks sharing the card (this script
   with ``--train-rank``) run beside phases 16 and 17: (b)
   smollm-360m f32 at full width cut to MESH_TRAIN_LAYERS layers through
   ``launch/train.py`` on the host mesh (data,) = (2,), 4 steps with
   checkpoints every 2 under ``build/phase18`` (removed after), (c)
   the same model on (pod, data, model) = (2, 1, 1) under int8-pod, and
   (d) the whole model (32 layers) through ``launch/train.py`` on the host
   mesh under ``remat="block"``, 3 steps: its first loss within rel 1e-5
   of phase 15 (a)'s, its loop's peak a rank below phase 15 (a)'s
   one-device ``"block"`` peak, printed beside ``mesh_train_bytes``. Here:
   (a) smollm-360m f32 uncut at NCCL world size 1 on (1, 1, 1), 4 steps
   of 8 x 128: the train state bit-equal to the one-device trainer's, and
   under int8-pod m and v bit-equal to the plain int8 formula on the
   one-device gradient; the one-device, mesh and int8-pod steps in turns;
   then the one-device references of (b) and (c). (b)'s losses within rel
   1e-5 of the one-device trainer's, its final state (the ranks'
   checkpoint, whole leaves) with m and v within 1e-5 and the parameters
   tie-limited (MESH_TRAIN_PARAM_SHARE), and a one-device run resumed from
   the ranks' step-2 checkpoint likewise; (c)'s m and v bit-equal to the
   plain formula on the two pods' one-device gradients. No port kernel
   launches in any mesh train step. It prints the step time a rank, the
   collectives and bytes a step, the state MiB a rank against one device
   and the peak memory; the kernels line gains ``mesh_training_launches``.

Each phase prints its wall (``[wall] phase N``) and the script its total.

Before driving a path, every launch counter is set to 0, and the counts are
read just after it. Phase 3 ends with a ``torch.profiler`` breakdown of one
eager and one replayed decode step (the device's busy share and the
kernel's part of it). The line
before the last is a JSON object describing each kernel; the last line is
the device JSON ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15  # dense int8 tensor-core peak, H100 SXM

F32_OPS_PER_S = 67e12  # non-tensor float32 peak, H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM

SHAPES_KN = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
#: the 7 packed sites of one smollm-360m layer, as (K, N): wq, wk, wv, wo, wg, wu, wd
LAYER_SITES = [(960, 960), (960, 320), (960, 320), (960, 960),
               (960, 2560), (960, 2560), (2560, 960)]
BATCH, PROMPT, MAX_NEW = 4, 64, 16
#: phase 2's ragged-N shapes (N % 4 != 0: the byte-loading kernel), (M, K,
#: N): xlstm-350m's sLSTM ``up`` site (N = int(1024 * 4/3)) at decode, a
#: prefill chunk and a batched prefill, tiny-xlstm's (N = 85), and N = 1
RAGGED_MKN = [(4, 1024, 1365), (64, 1024, 1365), (256, 1024, 1365), (4, 64, 85),
              (4, 1024, 1)]
#: phases 2 and 8: M at one layer's shapes, from decode (1-8: K split over
#: a cluster of blocks) to the paged engine's largest prompt (the FIFO loop
#: admits prompts of 8-300 tokens one at a time) and its largest batched
#: admit (phase 10: 4 prompts of 2 pages of 64 tokens)
W4A8_M = (1, 4, 8, 64, 256, 300, 512)
#: the previous B1/B4 (one block per 64-column tile, dp4a on the CUDA
#: cores) summed over one layer's 7 sites, ms, cold L2: chip_smoke.py phases
#: 2 and 8 at commit 9ae5607, NVIDIA H100 80GB HBM3, 700.00 W; for the
#: [w4a8] and [b4] lines only
PREVIOUS_LAYER_MS = {("b1", 4): 0.12925, ("b1", 256): 0.18382, ("b4", 4): 0.13309,
                     ("b4", 256): 0.21293}
#: phase 4: (K, C, mode, rounding); the first four are one layer's shapes
GPFQ_CASES = [(k, c, "split", "nearest") for k, c in SHAPES_KN] + [
    (960, 320, "split", "zero"), (960, 320, "joint", "nearest"),
    (960, 320, "plain", "nearest"), (8192, 64, "split", "nearest")]
GPFQ_SAMPLES = 2048
#: the per-panel B5 that the blocked one replaced (one block per channel
#: panel) on the same cases, for the [gpfq] lines only (ms; chip_smoke.py
#: phase 4 at commit fbec649, NVIDIA H100 80GB HBM3, 700.00 W)
GPFQ_PANEL_MS = {(960, 960, "split", "nearest"): 6.9895, (960, 320, "split", "nearest"): 7.0172,
                (960, 2560, "split", "nearest"): 6.9624, (2560, 960, "split", "nearest"): 26.0790,
                (960, 320, "split", "zero"): 6.9972, (960, 320, "joint", "nearest"): 6.9997,
                (960, 320, "plain", "nearest"): 6.9432, (8192, 64, "split", "nearest"): 1729.6852}
CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ, EVAL_BATCHES = 4, 4, 128, 2
#: phase 6: (B, nkv, g, hd, bs, P, lengths or a sweep mode, softcap); P is
#: the table's width. The last four cross the kernels' split boundaries in
#: the registry's decode attention, (arch, kv heads, group, head dim): B2/B3
#: held to their plain versions at 4 slots of 80 and 2048 tokens (block 64)
#: and timed at 4 x 80 and 4 x 2048 after smollm-360m's PAGED_TIMED
REGISTRY_ATTN = (("stablelm-3b", 32, 1, 80), ("phi4-mini-3.8b", 8, 3, 128),
                 ("musicgen-medium", 24, 1, 64), ("dbrx-132b", 8, 6, 128),
                 ("internvl2-76b", 8, 8, 128), ("llama3-405b", 8, 16, 128))
#: PagedEngine's 512-page table: a 1-token row beside a 2048-token one,
#: idle slots (length 0, sentinel rows), and k * S * bs +- 1 tokens for the
#: card's split count S (one page per split, then one more)
PAGED_CASES = (
    [(4, 2, 2, 16, bs, 2 if bs == 128 else 3, mode, None)
     for bs in (8, 16, 128) for mode in ("ragged", "exact", "exact+-1")]
    + [(3, 1, 3, 7, 8, 3, "ragged", None), (2, 3, 1, 16, 8, 2, "ragged", None),
       (3, 1, 5, 11, 16, 2, "ragged", None), (3, 2, 2, 16, 8, 4, "ragged", 10.0),
       (4, 5, 3, 64, 64, 33, (1, 63, 64, 65), None),
       (4, 5, 3, 64, 64, 33, (80, 2048, 80, 2048), None),
       (2, 5, 3, 64, 64, 512, (1, 2048), None),
       (4, 5, 3, 64, 64, 512, (0, 80, 0, 2048), None),
       (4, 5, 3, 64, 64, 512, "split+-1", None),
       (16, 5, 3, 64, 64, 512, "split+-1", None)]
    + [(4, nkv, g, hd, 64, 33, (80, 2048, 80, 2048), None) for _, nkv, g, hd in REGISTRY_ATTN])
#: smollm-360m decode attention: 15 query heads over 5 kv heads, hd 64
SMOLLM_NKV, SMOLLM_G, SMOLLM_HD = 5, 3, 64
#: timed (slots, tokens), in PagedEngine's 512-page table (max_seq_len / bs)
PAGED_TIMED = ((4, 80), (4, 2048), (1, 2048), (16, 512))
PAGED_TABLE = 512
#: the first kernels' times at the same shapes (ms; chip_smoke.py phase 6 at
#: commit aa35be4, NVIDIA H100 80GB HBM3, 700.00 W)
PAGED_FIRST_MS = {("float", 4, 80): 0.06840, ("float", 4, 2048): 1.13171,
                  ("int8", 4, 80): 0.07446, ("int8", 4, 2048): 1.24144}
#: phase 8, B6: (M, D) from a decode batch (4) through a prefill of 4 x 64
#: tokens (256) to a large prefill (4096), at smollm-360m's d_model (960),
#: phi4-mini's (3072), the registry's 8192 and llama3-405b's (16384), plus
#: the shapes of earlier runs; each in f32 and bf16, timed in
#: RMSNORM_ROUNDS rounds
RMSNORM_SWEEP = [(m, d) for d in (960, 3072, 8192, 16384) for m in (4, 256, 4096)] + [
    (512, 1024), (1024, 4096)]
#: phase 8, B6's staged tier (rows past the registers): (M, D, element
#: offset of x in its buffer), f32 only (bf16 rows stay in registers up to
#: 32768); the offset view is unaligned, so staged past 8192
RMSNORM_STAGED = [(4, 32768, 0), (256, 65536, 0), (256, 16384, 1)]
RMSNORM_DRIVEN = [(256, 960), (512, 1024), (1024, 4096), (4, 16384)]
RMSNORM_ROUNDS = 3
#: phase 7: the paged engine's configuration
PAGED_BLOCK, PAGED_BLOCKS, PAGED_SLOTS, PAGED_CHUNK = 64, 64, 4, 8
#: phase 7's profile: replayed decode steps traced at most, one trace each,
#: for PAGED_CHUNK complete ones
PAGED_PROFILE_TRIES = 48
TRACE_REQUESTS, PREFIX_LEN = 12, 128
#: phase 11: granite-moe-3b-a800m, its expert sites (K, N) (wg and wu, then
#: wd), its dense (attention) sites, the kernel cases' expert counts and
#: rows an expert (1 and 4: decode; 64: a 4 x 64 prefill's capacity; 80: a
#: paged admit's G x C; the rest on each side of B1e/B4e's tier
#: boundaries, ``w4a8_mm.expert_tier``), and the layers of the calibration
#: cut
GRANITE = "granite-moe-3b-a800m"
MOE_EXPERT_KN = [(1536, 512), (512, 1536)]
MOE_LAYER_SITES = [(1536, 512), (1536, 512), (512, 1536)]  # wg, wu, wd
GRANITE_DENSE_KN = [(1536, 1536), (1536, 512)]
MOE_KERNEL_E, MOE_KERNEL_M = (8, 40), (1, 4, 8, 9, 16, 17, 48, 49, 64, 65, 80)
MOE_CALIB_LAYERS = 4
#: traces of one replayed granite step tried for a complete one (earlier
#: traces in the process make a lost device record likelier)
MOE_PROFILE_ATTEMPTS = 16
#: B1e and B4e before the decode tier (the 64 x 64 tile kernel at every M,
#: no K split at E = 40) at the timed E = 40 shapes (M, K, N), us, cold
#: L2: chip_smoke.py phase 11 at commit 5bb4d0c, NVIDIA H100 80GB HBM3,
#: 700.00 W; for the [expert] lines only
PREVIOUS_EXPERT_US = {(1, 1536, 512): (24.26, 34.77), (1, 512, 1536): (23.49, 32.61),
                      (4, 1536, 512): (24.16, 34.59), (4, 512, 1536): (23.58, 32.66),
                      (64, 1536, 512): (25.92, 36.10), (64, 512, 1536): (26.85, 34.88),
                      (80, 1536, 512): (38.06, 54.21), (80, 512, 1536): (40.32, 57.89)}
#: the same kernels' sums over one granite MoE layer's 3 expert sites, us
#: (the same run)
PREVIOUS_EXPERT_LAYER_US = {1: (72.00, 102.14), 4: (71.90, 101.84), 64: (78.69, 107.07),
                            80: (116.45, 166.30)}
#: the largest logit difference between two runs of one model that the
#: tie-limited comparison accepts as numerical noise (logits here are
#: about unit variance)
TIE_BAND_CAP = 2.0


def reset_counts():
    """Set every kernel's launch counter to 0."""
    from repro_torch.kernels.gpfq_solve import gpfq_solve
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant_rmsnorm import quant_rmsnorm
    from repro_torch.kernels.w4a8_mm import (
        w4a8_expert_matmul,
        w4a8_matmul,
        w4a8_sparse_expert_matmul,
        w4a8_sparse_matmul,
    )

    w4a8_matmul.launches = 0
    w4a8_sparse_matmul.launches = 0
    w4a8_expert_matmul.launches = 0
    w4a8_sparse_expert_matmul.launches = 0
    gpfq_solve.launches = 0
    gpfq_solve.masked_launches = 0
    gpfq_solve.device_kernels = 0
    paged_decode_attention.launches = 0
    paged_decode_attention.int8_launches = 0
    quant_rmsnorm.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.gpfq_solve import gpfq_solve
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant_rmsnorm import quant_rmsnorm
    from repro_torch.kernels.w4a8_mm import (
        w4a8_expert_matmul,
        w4a8_matmul,
        w4a8_sparse_expert_matmul,
        w4a8_sparse_matmul,
    )

    return {"w4a8_matmul": w4a8_matmul.launches,
            "w4a8_sparse_matmul": w4a8_sparse_matmul.launches,
            "w4a8_expert_matmul": w4a8_expert_matmul.launches,
            "w4a8_sparse_expert_matmul": w4a8_sparse_expert_matmul.launches,
            "gpfq_solve": gpfq_solve.launches,
            "gpfq_solve_masked": gpfq_solve.masked_launches,
            "gpfq_solve_device_kernels": gpfq_solve.device_kernels,
            "paged_decode_attention": paged_decode_attention.launches,
            "paged_decode_attention_int8": paged_decode_attention.int8_launches,
            "quant_rmsnorm": quant_rmsnorm.launches}


#: processes this script started that run on beside later phases; main
#: kills any still running when it ends
CHILDREN: list = []


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one call: inputs read once (codes, packed weight, the
    two f32 epilogue vectors), the bf16 output written once, against the
    int8 operations at the tensor-core peak."""
    nbytes = m * k + k * n // 2 + 2 * 4 * n + 2 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * n * k / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def plan_fields(plan) -> dict:
    """The plan a B1/B4 wrapper last launched with (its ``last_plan``):
    grid and K chunks."""
    return {"grid": list(plan.grid), "k_chunks": plan.grid[2],
            "plan": f"grid {plan.grid} ({plan.blocks} blocks), {plan.grid[2]} K chunk(s) of "
                    f"{plan.ck} rows, {plan.vec}-byte loads"}


def layer_sum(rows, m: int, key: str):
    """``key`` summed over the 7 sites of one smollm-360m layer at M = m
    (None where a site has none)."""
    by_shape = {(r["K"], r["N"]): r for r in rows if r["M"] == m}
    vals = [by_shape[kn][key] for kn in LAYER_SITES]
    return None if any(v is None for v in vals) else sum(vals)


def print_layer_sums(tag: str, who: str, rows) -> None:
    """One line per M: the kernel's, plain version's, ``_int_mm``'s and the
    bound's sums over one layer's 7 sites, with the previous kernel's beside."""
    for m in W4A8_M:
        lib = layer_sum(rows, m, "library_ms")
        old = PREVIOUS_LAYER_MS.get((who, m))
        extra = (f"  B1 on the same codes {layer_sum(rows, m, 'b1_ms'):.5f} ms"
                 if who == "b4" else "")
        print(f"[{tag}] M={m:4d} one layer's 7 sites: kernel {layer_sum(rows, m, 'ms'):.5f} ms"
              f"{extra}  plain {layer_sum(rows, m, 'plain_ms'):.5f} ms  _int_mm "
              f"{'n/a' if lib is None else f'{lib:.5f}'} ms  bound "
              f"{layer_sum(rows, m, 'bound_ms'):.5f} ms  previous kernel (9ae5607) "
              f"{'not measured' if old is None else f'{old:.5f} ms'}")


def time_ms(torch, fn, reps: int = 30, flush=None, clean: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` runs by CUDA events, with
    the L2 cache flushed before each run (a decode step finds each layer's
    weights cold: 157 MB of packed codes do not fit the 50 MB L2): by
    writing ``flush``, or with ``clean`` by reading it, which leaves no
    dirty line in the L2 for ``fn``'s reads to write back first. A
    device-side sleep before the start event keeps the card busy while the
    host enqueues ``fn``, so the interval holds device time, not the host's
    launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None and clean:
            flush.view(torch.int32).sum()
        elif flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of device time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def w4a8_seen(kernels) -> int:
    """The profiler's count of B1/B4 kernels, by the name ``w4a8_kernel``."""
    return sum(e.count for e in kernels if "w4a8_kernel" in e.key)


def traced(torch, fn, graph_ops=None):
    """``fn`` under torch.profiler (CPU and CUDA activities): WARMUP short
    device sleeps (``spin_kernel``) and a synchronize first, then ``fn`` and
    a synchronize. Returns (profiler, fn's result, complete): complete is
    ``repro_torch.trace.launches_recorded``, which says every kernel launch
    that ``fn`` recorded on the host has a device record, and every CUDA
    graph replay (one ``cudaGraphLaunch`` host record) has ``graph_ops``
    device records under its correlation id, one per kernel, copy and fill
    node of the captured graph (a replay with no ``graph_ops`` given is never
    complete). With torch 2.11 and driver 580.159.03 on an H100 the profiler
    can lose the device records of a trace's first kernels (more of them
    after earlier traces in the process) and now and then others; it keeps
    the host's launch records, so a count by name is exact only on a
    complete trace."""
    from repro_torch.trace import WARMUP, launches_recorded

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(WARMUP):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    complete = launches_recorded(prof.profiler.kineto_results.events(), graph_ops=graph_ops)
    return prof, out, complete


def traced_kernels(torch, events):
    """The device records of a trace's events (``prof.events()`` or
    ``key_averages()``): kernels and copies, without the warm-up sleeps or
    annotations (``repro_torch.trace.traced_kernels``)."""
    from repro_torch import trace

    return trace.traced_kernels(events)


def profile_complete(torch, fn, attempts: int = 4, graph_ops=None):
    """``traced(fn, graph_ops)`` until its trace is complete, at most
    ``attempts`` times; ``fn`` must repeat the same work each time. Returns
    (profiler, fn's result)."""
    for _ in range(attempts):
        prof, out, complete = traced(torch, fn, graph_ops)
        if complete:
            return prof, out
    check(False, f"the profiler lost device kernel records in {attempts} traces of one call")


def reset_peak(torch) -> None:
    """Start a peak-memory window: collect the garbage of earlier phases
    first (engines and closures form reference cycles that only the cyclic
    collector frees), so the peak counts what the measured run holds."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def wall_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize: the time a
    caller waits, host overhead included (eager PyTorch enqueues each op
    from Python)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def spread_ms(times) -> dict:
    """Median, min, max and spread (max - min) of host-clock times, ms."""
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "spread": max(times) - min(times), "runs": len(times)}


def fmt_spread(s: dict) -> str:
    return (f"{s['median']:.3f} ms (min {s['min']:.3f}, max {s['max']:.3f}, spread "
            f"{s['spread']:.3f}, {s['runs']} runs)")


def in_turns(torch, fns: dict, runs: int, scale: float = 1.0) -> dict:
    """Host-clock time of each of ``fns`` (name -> callable), ``runs``
    times each, taken in turns within one process (a, b, b, a, ...), each
    run ending in a synchronize; divided by ``scale``. Returns name ->
    :func:`spread_ms`."""
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(runs):
        for n in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[n]()
            torch.cuda.synchronize()
            times[n].append(1e3 * (time.perf_counter() - t0) / scale)
    return {n: spread_ms(t) for n, t in times.items()}


def sync_checked_generate(torch, engine, prompts):
    """``engine.generate`` with its decode (every step between the prefill
    and the final read of the tokens) under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync there raises."""
    decode = engine._decode

    def guarded(bucket, n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(bucket, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._decode = guarded
    try:
        return engine.generate(prompts, MAX_NEW)
    finally:
        del engine._decode  # the class's method again


def decode_step_ms(torch, model, prompts, out) -> float:
    """Host-clock time of one fixed-slot decode step (ending in a
    synchronize) after a prefill of ``prompts``, through the kernels."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import use_packed_backend

    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode(), use_packed_backend("kernel"):
        _, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        return wall_ms(torch, lambda: T.decode_step(model, step_tok, caches, PROMPT), reps=10)


def build_kernels() -> tuple[dict, float]:
    """Every kernel source built (one nvcc each, all started together):
    (the compiler logs, seconds)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    return logs, time.perf_counter() - t0


def phase_card(torch, build=None):
    """The card's name and power limit, and the kernels' build: ``build``
    (a future of :func:`build_kernels` started earlier) or one now."""
    smi = _smi()
    print(f"[card] nvidia-smi: {smi}")
    print(f"[card] torch.cuda.get_device_name(): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    logs, build_s = build.result() if build is not None else build_kernels()
    print(f"[build] {len(logs)} kernel source(s) built in {build_s:.3f} s: {sorted(logs)}")
    for name, log in logs.items():
        usage = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                        if "Used" in line and "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
        print(f"[build] {name}: {'; '.join(usage)}; {'; '.join(spills)}")
    check(bool(logs), "no kernel source was built")
    return smi


def phase_kernel(torch):
    from repro_torch.kernels.w4a8_mm import (
        check_inner,
        pack_int4,
        unpack_int4,
        w4a8_matmul,
        w4a8_matmul_kernel,
        w4a8_matmul_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [(m, k, n) for m in W4A8_M for k, n in SHAPES_KN] + [(3, 960, 100)] + RAGGED_MKN
    rows, max_err = [], 0.0
    for m, k, n in cases:
        q = torch.randint(-8, 8, (k, n), generator=gen, device=dev)
        wp = pack_int4(q)
        col_sums = q.sum(0).to(torch.int32)
        scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 1e-3
        act_scale = torch.tensor(0.0213, device=dev)
        row = {"M": m, "K": k, "N": n}
        for act in ("uint8", "int8"):
            lo, hi = (0, 256) if act == "uint8" else (-128, 128)
            x = torch.randint(lo, hi, (m, k), generator=gen, device=dev).to(getattr(torch, act))
            zp = torch.tensor(131.0 if act == "uint8" else 0.0, device=dev)

            def kern():
                return w4a8_matmul(x, wp, scale, act_scale, zp, col_sums=col_sums,
                                   out_dtype=torch.bfloat16)

            def plain():
                return w4a8_matmul(x, wp, scale, act_scale, zp, col_sums=col_sums,
                                   out_dtype=torch.bfloat16, reference=True)

            before = w4a8_matmul.launches
            y, r = kern(), plain()
            torch.cuda.synchronize()
            check(w4a8_matmul.launches == before + 1 and w4a8_matmul.last_plan.vec == (
                1 if n % 4 else w4a8_matmul.last_plan.vec), f"M={m} K={k} N={n}: the kernel did "
                f"not launch once (or not with the ragged loader)")
            err = (y.float() - r.float()).abs().max().item()
            max_err = max(max_err, err)
            check(torch.equal(y, r), f"kernel != plain at M={m} K={k} N={n} {act}")
            row[f"bit_equal_{act}"] = True
            if act == "uint8":
                # the kernel and its plain version alone, on the formed
                # epilogue vectors (the wrapper's two small vector ops apart)
                sw = scale * act_scale
                corr = col_sums.to(torch.float32) * zp
                row["ms"] = time_ms(torch, lambda: w4a8_matmul_kernel(
                    x, wp, sw, corr, torch.bfloat16), flush=flush)
                row.update(plan_fields(w4a8_matmul.last_plan))
                row["plain_ms"] = time_ms(torch, lambda: w4a8_matmul_plain(
                    x, wp, sw, corr, torch.bfloat16), flush=flush)
                row["library_ms"] = None
                if k % 8 == 0:
                    # yardstick: cuBLASLt int8 GEMM on pre-unpacked weights,
                    # activations shifted by -128 (128 * col_sums folds back
                    # into the correction); it needs M > 16, so rows pad to
                    # 32, and N a multiple of 8, so a ragged N pads with
                    # zero columns
                    mp, n8 = max(m, 32), -(-n // 8) * 8
                    xs = torch.zeros((mp, k), dtype=torch.int8, device=dev)
                    xs[:m] = (x.to(torch.int16) - 128).to(torch.int8)
                    w8 = torch.zeros((k, n8), dtype=torch.int8, device=dev)
                    w8[:, :n] = unpack_int4(wp)
                    acc = torch._int_mm(xs, w8)[:m, :n] + 128 * col_sums
                    exact = x.to(torch.float64) @ q.to(torch.float64)
                    check(torch.equal(acc.to(torch.float64), exact),
                          "the _int_mm yardstick disagrees with the exact product")
                    row["library_ms"] = time_ms(torch, lambda: torch._int_mm(xs, w8),
                                                flush=flush)
        row["bound_ms"], row["bound_by"] = bound_ms(m, k, n)
        rows.append(row)
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        print(f"[w4a8] M={m:4d} K={k:5d} N={n:5d} bit-equal(u8,s8) "
              f"kernel {row['ms']:.5f} ms  plain {row['plain_ms']:.5f} ms  "
              f"_int_mm {lib} ms  bound {row['bound_ms']:.5f} ms ({row['bound_by']})  "
              f"{row['plan']}")
    print_layer_sums("w4a8", "b1", rows)
    host = wrapper_host_us(torch, gen)

    # the P_I certificate on an l1-budgeted weight: every certified 64-wide
    # tile (K=960 is not a multiple of T=128) keeps sum|q| <= 128 per
    # column, so |partial| <= 255 * 128 < 2^15 - 1
    k, n = 960, 960
    q = torch.randint(-7, 8, (k, n), generator=gen, device=dev)
    tiles = q.reshape(k // 64, 64, n)
    keep = torch.cumsum(tiles.abs(), dim=1) <= 128
    q = (tiles * keep).reshape(k, n)
    x = torch.randint(0, 256, (256, k), generator=gen, device=dev).to(torch.uint8)
    y = w4a8_matmul(x, pack_int4(q), torch.ones(n, device=dev), 0.01, 131.0,
                    block_k=128, p_inner=16, assert_inner=True, out_dtype=torch.bfloat16)
    watermark = check_inner(x, pack_int4(q), 128, 16)
    check(bool(torch.isfinite(y.float()).all()), "non-finite output")
    full = pack_int4(torch.full((k, n), -8, device=dev))
    raised = False
    try:
        check_inner(x, full, 128, 16)
    except OverflowError:
        raised = True
    check(raised, "an unbudgeted weight passed the P_I=16 check")
    print(f"[w4a8] assert_inner: l1-budgeted weight passes P_I=16 "
          f"(watermark {watermark} <= {2 ** 15 - 1}); an unbudgeted one raises")
    return rows, max_err, host


def wrapper_host_us(torch, gen, rounds: int = 6, calls: int = 2000) -> dict:
    """Host time of one ``w4a8_matmul_kernel`` call at a decode site (M =
    4, K = N = 960), with the plan cached and with it computed anew each
    call (the cache cleared first), in alternating rounds; median us a
    call. The card runs each kernel in about 5 us, faster than the host
    enqueues them, so the wall time of a run of calls is the host's."""
    from repro_torch.kernels import w4a8_mm as W

    dev = torch.device("cuda")
    q = torch.randint(-8, 8, (960, 960), generator=gen, device=dev)
    x = torch.randint(0, 256, (BATCH, 960), generator=gen, device=dev).to(torch.uint8)
    wp, sw, corr = W.pack_int4(q), torch.ones(960, device=dev), torch.zeros(960, device=dev)

    def cached():
        W.w4a8_matmul_kernel(x, wp, sw, corr, torch.bfloat16)

    def anew():
        W.w4a8_plan.cache_clear()
        W.w4a8_matmul_kernel(x, wp, sw, corr, torch.bfloat16)

    times = {"cached": [], "anew": []}
    for r in range(rounds):
        for name in (("cached", "anew") if r % 2 == 0 else ("anew", "cached")):
            fn = cached if name == "cached" else anew
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            times[name].append(1e6 * (time.perf_counter() - t) / calls)
    out = {name: statistics.median(v) for name, v in times.items()}
    print(f"[w4a8] wrapper host time a call (M={BATCH}, K=N=960, median of {rounds} "
          f"alternating rounds of {calls}): plan cached {out['cached']:.3f} us, plan computed "
          f"each call {out['anew']:.3f} us")
    return out


def phase_slice(torch):
    import torch.profiler
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import use_packed_backend
    from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes
    from repro_torch.serving import GenerationEngine, SamplerConfig
    from repro_torch.trace import replay_spans_ns

    cfg = get_config("smollm-360m")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                      global_batch=BATCH, seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(model, cfg, SamplerConfig(temperature=0.0), device="cuda")
    # what the bucket holds: its buffers, the capture stream's cuBLAS
    # workspace and the graph's private pool (which empty_cache keeps)
    gc.collect()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    engine.generate(prompts, MAX_NEW)  # builds the bucket and captures its step
    gc.collect()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() - held0[0], torch.cuda.memory_reserved() - held0[1])
    (bucket,) = engine._buckets.values()
    program = bucket.program
    check(program.graph is not None and engine.gen_traces == 1,
          "the first generate did not capture its bucket's step")
    reset_peak(torch)

    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)  # ends in a host read: the device is done
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["w4a8_matmul"]
    check(counts["gpfq_solve"] == 0, f"serving launched gpfq_solve: {counts}")

    peak = torch.cuda.max_memory_allocated()
    expected = 7 * cfg.n_layers * MAX_NEW
    check(launches == expected, f"{launches} w4a8 launches, expected {expected}")
    check(program.rise[0] == 7 * cfg.n_layers and engine.gen_traces == 1,
          f"a replay adds {program.rise[0]} w4a8 launches, expected {7 * cfg.n_layers}")
    check(out.shape == (BATCH, PROMPT + MAX_NEW), f"output shape {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    reset_peak(torch)
    host = engine.generate_host_loop(prompts, MAX_NEW)
    peak_eager = torch.cuda.max_memory_allocated()
    check((out == host).all(), "the captured generate and the eager host loop disagree")
    ref_out = GenerationEngine(model, cfg, SamplerConfig(temperature=0.0), device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
    check((out == ref_out).all(), "kernel and reference backends disagree on tokens")
    synced = sync_checked_generate(torch, engine, prompts)
    check((synced == out).all(), "the generate under sync-debug differs")

    # the captured generate against the eager host loop, in turns
    gen_t = in_turns(torch, {"graph": lambda: engine.generate(prompts, MAX_NEW),
                             "host_loop": lambda: engine.generate_host_loop(prompts, MAX_NEW)},
                     runs=6)

    # per-phase times, and the packed path against the dequant one
    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode(), use_packed_backend("kernel"):
        reset_counts()
        logits, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        prefill_launches = read_counts()["w4a8_matmul"]
        check(prefill_launches == 7 * cfg.n_layers,
              f"{prefill_launches} w4a8 launches in a prefill, expected {7 * cfg.n_layers}")
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        prefill_ms = wall_ms(torch, lambda: T.prefill(model, {"tokens": tokens},
                                                      PROMPT + MAX_NEW), reps=5)
        # one eager decode step (at one position) and one replay of the
        # captured step (each at the next position), in turns
        engine._start(bucket, tokens)
        step_t = in_turns(torch, {
            "eager": lambda: T.decode_step(model, step_tok, caches, PROMPT),
            "replay": lambda: program.run(1)}, runs=6)
        decode_ms = step_t["eager"]["median"]
        check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
        with use_packed_backend("dequant"):
            dq, _ = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        a = logits[..., :cfg.vocab].float().flatten()
        b = dq[..., :cfg.vocab].float().flatten()
        corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        check(corr > 0.99, f"kernel vs dequant prefill logits correlation {corr}")
        def counted_step():
            reset_counts()
            T.decode_step(model, step_tok, caches, PROMPT)
            return read_counts()["w4a8_matmul"]

        prof, step_launches = profile_complete(torch, counted_step)
        events = prof.key_averages()
        print(events.table(sort_by="self_cuda_time_total", row_limit=12))
        # device kernels only (the CPU ops' device columns repeat them); one
        # stream, so their sum is the time the card was busy
        kernels = traced_kernels(torch, events)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        w4a8_ms = sum(e.self_device_time_total for e in kernels
                      if "w4a8_kernel" in e.key) / 1e3
        check(w4a8_ms > 0, "the profiler saw no w4a8 kernel in a decode step")
        seen = w4a8_seen(kernels)
        check(seen == step_launches == 7 * cfg.n_layers,
              f"the profiler saw {seen} w4a8 kernels in a decode step, the launch counter "
              f"{step_launches}, expected {7 * cfg.n_layers}")
        print(f"[profile] one eager decode step: device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / decode_ms:.1f}% of the {decode_ms:.3f} ms step), "
              f"w4a8 kernels {w4a8_ms:.3f} ms; by name {seen}, launch counter "
              f"{step_launches}")

        # one replay of the captured step under the profiler: complete when
        # the replay holds a device record for every node of the graph
        engine._start(bucket, tokens)

        def counted_replay():
            # the replay's own wall: launch to the end of its synchronize,
            # from an idle card (traced synchronizes before it)
            reset_counts()
            t0 = time.perf_counter()
            program.run(1)
            torch.cuda.synchronize()
            return read_counts()["w4a8_matmul"], 1e3 * (time.perf_counter() - t0)

        prof_r, (replay_launches, replay_wall) = profile_complete(
            torch, counted_replay, graph_ops=program.device_ops)
        kernels_r = traced_kernels(torch, prof_r.key_averages())
        busy_r = sum(e.self_device_time_total for e in kernels_r) / 1e3
        (span_r,) = replay_spans_ns(prof_r.profiler.kineto_results.events())
        span_r /= 1e6
        w4a8_r = sum(e.self_device_time_total for e in kernels_r if "w4a8_kernel" in e.key) / 1e3
        seen_r = w4a8_seen(kernels_r)
        check(seen_r == replay_launches == 7 * cfg.n_layers,
              f"the profiler saw {seen_r} w4a8 kernels in a replayed decode step, the launch "
              f"counter {replay_launches}, expected {7 * cfg.n_layers}")
        print(f"[profile] one replayed decode step ({program.device_ops} device operations in "
              f"the graph, every one recorded), all from this trace: device busy "
              f"{busy_r:.3f} ms = {100 * busy_r / replay_wall:.1f}% of the replay's own "
              f"{replay_wall:.3f} ms wall (launch to synchronize) and "
              f"{100 * busy_r / span_r:.1f}% of its {span_r:.3f} ms device span (first "
              f"kernel's start to last one's end); w4a8 kernels {w4a8_r:.3f} ms; by name "
              f"{seen_r}, launch counter {replay_launches}")

    head_bytes = cfg.vocab_padded * cfg.d_model * 2
    step_bytes = packed_weight_bytes(cfg)["packed_code_bytes"] + head_bytes
    print(f"[slice] smollm-360m full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"bf16), batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new, greedy")
    print(f"[slice] w4a8 launches in one generate: {launches} (= 7 x {cfg.n_layers} x "
          f"{MAX_NEW}: {prefill_launches} in the prefill at M={BATCH * PROMPT}, "
          f"{launches - prefill_launches} at M={BATCH} in {MAX_NEW - 1} replays of the "
          f"captured step, {program.rise[0]} a replay); tokens identical to the eager host "
          f"loop and to the reference backend; the decode of a generate ran under "
          f"set_sync_debug_mode('error')")
    print(f"[slice] generate wall {wall:.4f} s, {BATCH * MAX_NEW / wall:.1f} tok/s; "
          f"prefill {prefill_ms:.3f} ms, decode step {decode_ms:.3f} ms eager (host clock)")
    print(f"[graph] fixed-slot generate, in turns: captured {fmt_spread(gen_t['graph'])} "
          f"= {1e3 * BATCH * MAX_NEW / gen_t['graph']['median']:.1f} tok/s; eager host loop "
          f"{fmt_spread(gen_t['host_loop'])} = "
          f"{1e3 * BATCH * MAX_NEW / gen_t['host_loop']['median']:.1f} tok/s")
    print(f"[graph] fixed-slot decode step, in turns: replay {fmt_spread(step_t['replay'])}; "
          f"eager {fmt_spread(step_t['eager'])}")
    print(f"[graph] fixed-slot capture {1e3 * program.capture_s:.3f} ms (warm-up step, "
          f"capture, node walk, instantiation; the walk that counts the graph's kernels by "
          f"name {1e3 * program.walk_s:.3f} ms) for {program.device_ops} device operations; "
          f"the bucket "
          f"holds {held[0] / 2**20:.1f} MiB allocated, {held[1] / 2**20:.1f} MiB reserved "
          f"(its graph's pool included); peak memory allocated: captured generate "
          f"{peak / 2**20:.1f} MiB, "
          f"eager host loop {peak_eager / 2**20:.1f} MiB")
    print(f"[slice] decode-step byte bound: {step_bytes / 1e6:.1f} MB (packed codes + bf16 "
          f"head) = {1e3 * step_bytes / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
    print(f"[slice] peak memory allocated {peak / 2**20:.1f} MiB; kernel-vs-dequant "
          f"prefill logits correlation {corr:.5f}")
    print(f"[slice] sample tokens: {out[0, PROMPT:].tolist()}")
    return launches


def gpfq_bound_ms(k: int, d: int, c: int) -> tuple[float, str]:
    """Least time for one solve: the operations (a multiply-add of the
    reduction and two multiplies and adds of the update per U entry per
    step, 6*K*D*C) at the float32 peak, against the bytes of w, xg, xh, the
    row terms, lambda and the tile ids read once and Q, U, pos, neg
    written once."""
    n_tiles = -(-k // 128)
    nbytes = 4 * (2 * k * c + 2 * k * d + 3 * k + 3 * n_tiles * c + d * c)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 6 * k * d * c / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gpfq_case_inputs(torch, k: int, c: int, mode: str, rounding: str, gen):
    """One B5 call as calibration makes it, on the card: H and G H^-1 from
    seeded samples X and a distinct perturbed copy Xq (so the two matrices
    differ, as they do in calibration), w normal*0.02 in the integer domain,
    the AXE state of P_I = 16, T = 128 (unless ``mode`` is "plain"), rows and
    tile ids in the act_order permutation."""
    from repro_torch.core import gpfq as G
    from repro_torch.core.alphabet import act_alphabet, weight_alphabet
    from repro_torch.kernels.gpfq_solve import row_terms

    dev = torch.device("cuda")
    x = torch.randn((k, GPFQ_SAMPLES), generator=gen, device=dev)
    xq = x + 0.05 * torch.randn((k, GPFQ_SAMPLES), generator=gen, device=dev)
    h_half, g = G.me_stats(x, xq)
    w = torch.randn((k, c), generator=gen, device=dev) * 0.02
    w_int, _ = G._prepare(w, weight_alphabet(4))
    act = act_alphabet(8, signed=(mode == "joint"))
    axe = None if mode == "plain" else G.AxeConfig(p_bits=16, tile=128)
    state = G.make_axe_state(w_int, axe, act, rounding, k)
    order = G.act_order_permutation(h_half)
    xg = G.gh_inverse(h_half, g)[order].contiguous()
    xh = h_half[order].contiguous()
    hg, hn = row_terms(xg, xh)
    if state is None:
        lam = torch.zeros((1, c), device=dev)
        tid = torch.zeros((k,), dtype=torch.int32, device=dev)
        a = b = 0.0
    else:
        lam, a, b = state["lam"].contiguous(), state["A"], state["B"]
        tid = state["tile_ids"][order].to(torch.int32).contiguous()
    args = (w_int[order].contiguous(), xg, xh, hg, hn, lam, tid, a, b)
    return args, act, order, axe


def u_consistent(torch, args, q, u) -> bool:
    """U equal to Xg^T W - Xh^T Q recomputed in float64 from the solve's own
    codes: rtol 1e-4, and an atol of 1e-4 of the largest sum of the terms'
    magnitudes (an entry that cancels to near 0 keeps f32 rounding of its
    terms)."""
    w, xg, xh = (a.double() for a in args[:3])
    qd = q.double()
    ref = xg.T @ w - xh.T @ qd
    scale = float((xg.abs().T @ w.abs() + xh.abs().T @ qd.abs()).max())
    return bool(torch.allclose(u.double(), ref, rtol=1e-4, atol=1e-4 * scale))


def gpfq_profile(torch, fn, plan: dict) -> dict:
    """One solve under torch.profiler, run after a warm-up solve and a
    short device sleep (``spin_kernel``) in the same trace, so the trace is
    open before the solve starts: the card's kernels for the solve (those
    that start after the sleep) by name, held to the plan (one Gram
    product, one sum of its parts, a recurrence and an update per row
    block), and the span from the first one's start to the last one's
    end."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.start for e in evs if "spin_kernel" in e.name]
    check(len(marks) == 1, f"the profiler saw {len(marks)} device sleeps, not 1")
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if "gpfq_" in e.name and e.time_range.start > marks[0])
    names = {n: sum(f"gpfq_{n}_kernel" in e[2] for e in evs)
             for n in ("gram", "gram_sum", "rows", "update")}
    want = {"gram": 1, "gram_sum": 1, "rows": plan["blocks"], "update": plan["blocks"]}
    check(names == want, f"the profiler saw gpfq_solve kernels {names}, the plan has {want}")
    return {"kernels": len(evs), "by_name": names,
            "span_ms": (evs[-1][1] - evs[0][0]) / 1e3}


def phase_gpfq(torch):
    from repro_torch.core.overflow import certify
    from repro_torch.kernels.gpfq_solve import (
        block_plan,
        gpfq_solve,
        gpfq_solve_kernel,
        gpfq_solve_plain,
        tie_limited_agreement,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows, max_err = [], 0.0
    for k, c, mode, rounding in GPFQ_CASES:
        plan = block_plan(k, k, c)
        check(plan["rows"] == 64 and plan["kernels"] == 2 + 2 * -(-k // 64),
              f"gpfq_solve plan K={k} C={c}: {plan}")
        args, act, order, axe = gpfq_case_inputs(torch, k, c, mode, rounding, gen)
        kw = dict(qmax=7.0, mode=mode, rounding=rounding)
        before = gpfq_solve.device_kernels
        q, u, pos, neg = gpfq_solve_kernel(*args, **kw)
        kernels = gpfq_solve.device_kernels - before
        check(kernels == plan["kernels"], f"gpfq_solve K={k} C={c}: {kernels} kernels "
                                          f"launched, plan {plan['kernels']}")
        again = gpfq_solve_kernel(*args, **kw)
        pq, pu, ppos, pneg, v = gpfq_solve_plain(*args, **kw, return_v=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((q, u, pos, neg), again)),
              f"gpfq_solve K={k} C={c}: two runs differ")
        del again
        ok, share, cut = tie_limited_agreement(pq, q, v, rounding, 1e-3)
        check(ok, f"gpfq_solve K={k} C={c} {mode}/{rounding}: codes differ before the first "
                  f"tie (share equal {share:.5f})")
        check(u_consistent(torch, args, q, u),
              f"gpfq_solve K={k} C={c}: U is not Xg^T W - Xh^T Q of its own codes")
        max_err = max(max_err, (q - pq).abs().max().item())
        tid, n_tiles = args[6], args[5].shape[0]
        if mode == "plain":
            check(not pos.any() and not neg.any(), "plain GPFQ kept budget state")
        else:
            sums_p = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(),
                                                                      q.clamp(min=0))
            sums_n = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(),
                                                                      q.clamp(max=0))
            check(torch.equal(sums_p, pos) and torch.equal(sums_n, neg),
                  f"gpfq_solve K={k} C={c}: pos/neg are not the tile sums of its codes")
        cert = None
        if axe is not None:
            rep = certify(q[torch.argsort(order)], act, 16, 128)
            check(bool(rep), f"gpfq_solve K={k} C={c} {mode}: certificate fails: {rep}")
            cert = rep.headroom_bits
        ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw), reps=5, flush=flush)
        plain_ms = wall_ms(torch, lambda: gpfq_solve_plain(*args, **kw), reps=2)
        bms, by = gpfq_bound_ms(k, k, c)
        rows.append({"K": k, "C": c, "mode": mode, "rounding": rounding,
                     "row_blocks": plan["blocks"], "kernels_per_solve": kernels,
                     "share_equal": share, "channels_cut_by_tie": cut,
                     "headroom_bits": cert, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
        print(f"[gpfq] K={k:5d} C={c:5d} {mode:5s} {rounding:7s} {plan['blocks']} blocks of "
              f"{plan['rows']} rows, {kernels} kernels a solve: tie-limited agreement ok, "
              f"{share:.5f} of codes equal ({cut} channels cut by a tie), pos/neg exact, "
              f"two runs bit-identical, U consistent, "
              f"headroom {cert if cert is None else round(cert, 4)} bits; kernel {ms:.4f} ms "
              f"(per-panel kernel: {GPFQ_PANEL_MS[(k, c, mode, rounding)]:.4f} ms)  "
              f"plain {plain_ms:.1f} ms  bound {bms:.4f} ms ({by})")
        if (mode, rounding) == ("split", "nearest"):
            prof = gpfq_profile(torch, lambda: gpfq_solve_kernel(*args, **kw), plan)
            rows[-1]["profile"] = prof
            print(f"[gpfq-profile] K={k:5d} C={c:5d}: {prof['kernels']} kernels on the card "
                  f"{prof['by_name']}, as planned; span {prof['span_ms']:.4f} ms")
    layer = {(r["K"], r["C"]): r["ms"] for r in rows
             if (r["mode"], r["rounding"]) == ("split", "nearest")}
    print(f"[gpfq] one smollm-360m layer's 7 sites: {sum(layer[kn] for kn in LAYER_SITES):.4f} "
          f"ms (per-panel kernel: "
          f"{sum(GPFQ_PANEL_MS[(*kn, 'split', 'nearest')] for kn in LAYER_SITES):.4f} ms)")
    return rows, max_err


def phase_calibration(torch):
    import tempfile
    from dataclasses import replace

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core import gpfq as G
    from repro_torch.core.axe import PTQConfig
    from repro_torch.core.calibration import ActObserver, LayerStats
    from repro_torch.core.overflow import min_feasible_p_bits
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.kernels import gpfq_solve as B5
    from repro_torch.models import transformer as T
    from repro_torch.quant.pipeline import calibrate_and_quantize, float_ppl, quantized_ppl
    from repro_torch.quant.serve_packed import (
        export_quantized_artifact,
        load_flat_artifact,
        packed_params_from_artifact,
    )
    from repro_torch.serving import GenerationEngine, SamplerConfig

    # the reference's solvers take float32 weights: an f32 copy of the config
    cfg = replace(get_config("smollm-360m"), param_dtype="float32", act_dtype="float32")
    model = T.init_model(cfg, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    evalb = list(data.eval_batches(EVAL_BATCHES))

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    # where the time goes, from a second calibration: events around each B5
    # launch; host clock (ending in a synchronize, which the first run does
    # not have) around the eigendecomposition, the solve for G H^-1 and the
    # host-side percentile observer
    spent = {"eigh": 0.0, "solve": 0.0, "observer": 0.0}
    b5_events = []
    originals = (B5.gpfq_solve_kernel, LayerStats.gpfq_stats, G.gh_inverse,
                 ActObserver.update)

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    def b5_timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = originals[0](*a, **kw)
        end.record()
        b5_events.append((start, end))
        return out

    B5.gpfq_solve_kernel = b5_timed
    LayerStats.gpfq_stats = timed("eigh", originals[1])
    G.gh_inverse = timed("solve", originals[2])
    ActObserver.update = timed("observer", originals[3])
    try:
        t0 = time.perf_counter()
        calibrate_and_quantize(model, cfg, calib, PTQConfig(), device="cuda")
        torch.cuda.synchronize()
        wall_i = time.perf_counter() - t0
    finally:
        (B5.gpfq_solve_kernel, LayerStats.gpfq_stats, G.gh_inverse,
         ActObserver.update) = originals
    b5_s = sum(s.elapsed_time(e) for s, e in b5_events) / 1e3
    sites = 7 * cfg.n_layers
    check(counts["gpfq_solve"] == sites,
          f"{counts['gpfq_solve']} gpfq_solve launches in calibration, expected {sites}")
    check(counts["w4a8_matmul"] == 0, f"calibration launched w4a8_matmul: {counts}")
    summary = qm.cert_summary()
    check(summary["ok"] and summary["n_certified"] == sites, f"certificates: {summary}")
    ppl_f, ppl_q = float_ppl(model, cfg, evalb), quantized_ppl(qm, evalb)
    check(math.isfinite(ppl_f) and math.isfinite(ppl_q), f"perplexities {ppl_f} {ppl_q}")
    print(f"[calib] smollm-360m full width in float32 ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), GPFQ W4A8 P_I=16 T=128 act_order SmoothQuant, "
          f"{CALIB_BATCHES} x {CALIB_BATCH} x {CALIB_SEQ} tokens")
    print(f"[calib] gpfq_solve launches {counts['gpfq_solve']} (= 7 x {cfg.n_layers}); "
          f"certified {summary['n_certified']} sites, min headroom "
          f"{summary['min_headroom_bits']:.4f} bits at {summary['min_headroom_site']}")
    print(f"[calib] wall {wall:.3f} s; the instrumented second run {wall_i:.3f} s: B5 "
          f"{b5_s:.3f} s ({100 * b5_s / wall_i:.1f}%), eigh {spent['eigh']:.3f} s "
          f"({100 * spent['eigh'] / wall_i:.1f}%), solve {spent['solve']:.3f} s "
          f"({100 * spent['solve'] / wall_i:.1f}%), host observer {spent['observer']:.3f} s "
          f"({100 * spent['observer'] / wall_i:.1f}%)")
    print(f"[calib] B5 per layer {1e3 * b5_s / cfg.n_layers:.3f} ms (7 solves, summed over "
          f"the instrumented run's {len(b5_events)} solves / {cfg.n_layers} layers)")
    print(f"[calib] float ppl {ppl_f:.4f}, quantized ppl {ppl_q:.4f} on {EVAL_BATCHES} eval "
          f"batches (random weights)")

    artifact, meta = export_quantized_artifact(qm)
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(artifact, os.path.join(tmp, "quantized"), meta)
        flat, meta2 = load_flat_artifact(os.path.join(tmp, "quantized"))
    served = packed_params_from_artifact(flat, model, cfg, meta=meta2)
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                      global_batch=BATCH, seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(served, cfg, SamplerConfig(temperature=0.0), device="cuda")
    engine.generate(prompts, MAX_NEW)  # warm-up
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    gen_s = time.perf_counter() - t0
    serve_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = 7 * cfg.n_layers * MAX_NEW
    check(serve_counts["w4a8_matmul"] == expected,
          f"{serve_counts['w4a8_matmul']} w4a8 launches serving the artifact, expected "
          f"{expected}")
    check(serve_counts["gpfq_solve"] == 0, f"serving launched gpfq_solve: {serve_counts}")
    ref_out = GenerationEngine(served, cfg, SamplerConfig(temperature=0.0), device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
    check((out == ref_out).all(), "kernel and reference backends disagree on the artifact")
    check((out == engine.generate_host_loop(prompts, MAX_NEW)).all(),
          "the captured generate and the eager host loop disagree on the artifact")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    step_ms = decode_step_ms(torch, served, prompts, out)
    print(f"[calib] artifact: {len(artifact)} leaves, {meta['datapath']}; served greedy batch "
          f"{BATCH} x prompt {PROMPT} + {MAX_NEW} new (float32, static activation "
          f"quantizers): {serve_counts['w4a8_matmul']} w4a8 launches through the captured "
          f"step, tokens identical to the reference backend and the eager host loop, "
          f"{BATCH * MAX_NEW / gen_s:.1f} tok/s (wall {gen_s:.4f} s), eager decode step "
          f"{step_ms:.3f} ms (host clock), peak memory {peak / 2**20:.1f} MiB")
    floors = {name: min_feasible_p_bits(ql.cert) for name, ql in qm.quantized_linears()}
    return {"launches": counts["gpfq_solve"], "wall_s": wall, "instrumented_wall_s": wall_i,
            "b5_s": b5_s, **spent,
            "serve_launches": serve_counts["w4a8_matmul"], "floors": floors,
            "serve": {"gen_s": gen_s, "tok_s": BATCH * MAX_NEW / gen_s, "step_ms": step_ms,
                      "peak_mib": peak / 2**20}}


# ---------------------------------------------------------------------------
# Phase 6: the paged decode-attention kernels (B2, B3)
# ---------------------------------------------------------------------------
def paged_case(torch, rng, B, nkv, g, hd, bs, P, lens, dtype):
    """One paged-attention call on the card: distinct pages per row, the
    sentinel nb past each row's pages in a table P wide, a pool of the pages
    the lengths need and 4 more; ``lens`` a tuple or a sweep mode of the
    reference's tests (ragged, exact, exact+-1) or "split+-1" (k * S * bs
    +- 1 tokens, k = 1, 2, for the card's split count S)."""
    import numpy as np
    from repro_torch.kernels import paged_attention as PA

    full = P * bs
    if lens == "ragged":
        lens = rng.integers(1, full + 1, size=B)
    elif lens == "exact":
        lens = [((i % P) + 1) * bs for i in range(B)]
    elif lens == "exact+-1":
        lens = [max(1, bs - 1), bs + 1, full, max(1, full - 1)][:B]
    elif lens == "split+-1":
        S = PA.split_plan(B, nkv, P, PA._sm_count(0))
        lens = [k * S * bs + d for k in (1, 2) for d in (-1, 1)] * (B // 4)
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // bs) for n in lens]
    nb = sum(need) + 4
    tab = np.full((B, P), nb, np.int32)
    perm, o = rng.permutation(nb), 0
    for b in range(B):
        tab[b, :need[b]] = perm[o:o + need[b]]
        o += need[b]
    dev = torch.device("cuda")

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    q = normal(B, nkv * g, hd).to(dtype)
    kp, vp = normal(nb, bs, nkv, hd), normal(nb, bs, nkv, hd)
    return q, kp, vp, torch.from_numpy(tab).to(dev), torch.from_numpy(lens).to(dev)


def bf16_ulp_ok(torch, a, b) -> bool:
    """|a - b| within one bf16 ulp of the larger magnitude, or 1e-5 (an
    output near 0 moves by more than its bf16 ulp when the f32 sums are
    taken in another order)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(min=1e-5)
    return bool(((a - b).abs() <= ulp).all())


def paged_bound_ms(torch, q, k_pages, lens, quantized) -> tuple[float, str]:
    """Least time for one call: q, the K/V pages the lengths need (and
    their scales), the table entries and lengths read once, the output
    written once, against 4*nh*len*hd operations at the peak for the
    pages' type."""
    B, nh, hd = q.shape
    _, bs, nkv, _ = k_pages.shape
    pages = int(sum(-(-int(n) // bs) for n in lens.tolist()))
    page_bytes = bs * nkv * hd * k_pages.element_size() + (4 * nkv if quantized else 0)
    nbytes = 2 * q.numel() * q.element_size() + 2 * pages * page_bytes + 4 * (pages + B)
    ops = 4 * nh * hd * int(lens.sum())
    peak = INT8_OPS_PER_S if quantized else (BF16_OPS_PER_S if q.dtype == torch.bfloat16
                                             else F32_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(torch, q, k_pages, v_pages, tab, lens, k_scales=None, v_scales=None):
    """``scaled_dot_product_attention`` on K/V gathered beforehand into
    dense (B, nkv, S, hd) form (dequantized for int8 pages), with the
    length mask and GQA: one library call computing the same function."""
    import torch.nn.functional as F

    B, nh, hd = q.shape
    nb, bs, nkv, _ = k_pages.shape
    idx = tab.clamp(max=nb - 1).long()

    def dense(pages, scales):
        x = pages[idx]
        if scales is not None:
            x = x.float() * scales[idx][:, :, None, :, None]
        return x.reshape(B, -1, nkv, hd).transpose(1, 2).to(q.dtype).contiguous()

    k, v = dense(k_pages, k_scales), dense(v_pages, v_scales)
    mask = (torch.arange(k.shape[2], device=q.device)[None, :] < lens[:, None])[:, None, None]
    q4 = q[:, :, None, :]

    def call():
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)

    return call, lambda: call()[:, :, 0]


def phase_paged_kernels(torch):
    import numpy as np
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.quant.spec import AttnDatapathSpec

    rng = np.random.default_rng(0)
    err = {"float": 0.0, "int8": 0.0}
    n_cases = n_ties = 0
    for B, nkv, g, hd, bs, P, lens, cap in PAGED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tab, ln = paged_case(torch, rng, B, nkv, g, hd, bs, P, lens, dtype)
            kp, vp = kp.to(dtype), vp.to(dtype)
            case = (B, nkv, g, hd, bs, P, tuple(ln.tolist()), cap)
            live = ln > 0  # an idle slot: the kernels give 0, the plain B2 softmax NaN
            out = PA.paged_attention_kernel(q, kp, vp, tab, ln, softcap=cap)
            ref = PA.paged_attention_plain(q, kp, vp, tab, ln, softcap=cap)
            torch.cuda.synchronize()
            e = (out[live].float() - ref[live].float()).abs().max().item()
            err["float"] = max(err["float"], e)
            ok = (torch.allclose(out[live], ref[live], rtol=1e-5, atol=1e-5)
                  if dtype == torch.float32 else bf16_ulp_ok(torch, out[live], ref[live]))
            check(ok and not out[~live].any(), f"B2 != plain at {case} {dtype}: {e}")
            (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
            wm = torch.zeros(2, dtype=torch.int32, device="cuda")
            out = PA.paged_attention_int8_kernel(q, kc, vc, tab, ln, ks, vs, softcap=cap,
                                                 watermarks=wm)
            wm_ref = torch.zeros(2, dtype=torch.int32)
            ref, ties = PA.paged_attention_int8_plain(q, kc, vc, tab, ln, ks, vs, softcap=cap,
                                                      watermarks=wm_ref, return_ties=True,
                                                      tie_eps=1e-4)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err["int8"] = max(err["int8"], diff.max().item())
            clean = ~ties
            n_ties += int(ties.sum())
            check(diff.max().item() <= 5e-2 and bool(clean.any()) and not out[~live].any(),
                  f"B3 != plain at {case} {dtype}: {diff.max().item()}")
            ok = (diff[clean].max().item() <= 1e-4 if dtype == torch.float32
                  else bf16_ulp_ok(torch, out[clean], ref[clean]))
            check(ok, f"B3 != plain off the ties at {case} {dtype}")
            check(wm.cpu().tolist() == wm_ref.tolist(), f"B3 watermarks {wm.tolist()} != "
                                                        f"plain {wm_ref.tolist()} at {case}")
            PA.check_bounds(wm, AttnDatapathSpec.for_cache(hd, bs))
            n_cases += 1
    print(f"[paged] B2 and B3 against their plain versions: {n_cases} cases x (f32, bf16) "
          f"agree (B2 max |err| {err['float']:.3g}; B3 max |err| {err['int8']:.3g}, "
          f"{n_ties} near-tie rows within 5e-2, the others within 1e-4 / one bf16 ulp; "
          f"watermarks equal; idle slots 0)")

    # the full-magnitude case: every q and k code 127, v codes 127, full pages
    spec = AttnDatapathSpec.for_cache(SMOLLM_HD, PAGED_BLOCK)
    codes = torch.full((8, PAGED_BLOCK, SMOLLM_NKV, SMOLLM_HD), 127, dtype=torch.int8,
                       device="cuda")
    scales = torch.full((8, SMOLLM_NKV), 0.01, device="cuda")
    q = torch.full((2, SMOLLM_NKV * SMOLLM_G, SMOLLM_HD), 0.75, device="cuda",
                   dtype=torch.bfloat16)
    tab = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    lens = torch.tensor([4 * PAGED_BLOCK, 2 * PAGED_BLOCK], dtype=torch.int32, device="cuda")
    wm = torch.zeros(2, dtype=torch.int32, device="cuda")
    PA.paged_decode_attention(q, codes, codes, tab, lens, k_scales=scales, v_scales=scales,
                              attn_spec=spec, assert_bounds=True, watermarks=wm)
    reached = PA.check_bounds(wm, spec)
    check(reached == (spec.qk_worst_abs(), spec.pv_worst_abs()),
          f"full-magnitude watermarks {reached}")
    print(f"[paged] full magnitude: watermarks {reached} = (qk_worst_abs, pv_worst_abs) within "
          f"P_qk={spec.p_qk}, P_pv={spec.p_pv} ({spec.describe()})")

    # the wrapper reads no length on the host: one B2 and one B3 call under
    # the sync debug mode "error"
    q, kp, vp, tab, ln = paged_case(torch, rng, 2, SMOLLM_NKV, SMOLLM_G, SMOLLM_HD, PAGED_BLOCK,
                                    PAGED_TABLE, (1, 2048), torch.bfloat16)
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        PA.paged_decode_attention(q, kp, vp, tab, ln)
        PA.paged_decode_attention(q, kc, vc, tab, ln, k_scales=ks, v_scales=vs, watermarks=wm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[paged] one B2 and one B3 call under torch.cuda.set_sync_debug_mode('error'): "
          "no synchronization")

    # times at smollm-360m decode, then at the registry's attention shapes,
    # bf16 q (and bf16 pages for B2), in PagedEngine's 512-page table; the
    # plain version and the SDPA yardstick take the table cut to the pages
    # the lengths need (the same function)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {"float": [], "int8": []}
    timed = ([("smollm-360m", SMOLLM_NKV, SMOLLM_G, SMOLLM_HD, slots, n)
              for slots, n in PAGED_TIMED]
             + [(arch, nkv, g, hd, 4, n) for arch, nkv, g, hd in REGISTRY_ATTN
                for n in (80, 2048)])
    for arch, nkv, g, hd, slots, n in timed:
        q, kp, vp, tab, ln = paged_case(torch, rng, slots, nkv, g, hd, PAGED_BLOCK, PAGED_TABLE,
                                        (n,) * slots, torch.bfloat16)
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        (kc, ks), (vc, vs) = PA.quantize_kv_pages(kp), PA.quantize_kv_pages(vp)
        cut = tab[:, :-(-n // PAGED_BLOCK)].contiguous()
        splits = PA.split_plan(slots, nkv, PAGED_TABLE, PA._sm_count(0))
        for kind, pages, scale_args in (("float", (kp, vp), ()), ("int8", (kc, vc), (ks, vs))):
            if kind == "float":
                def kern():
                    return PA.paged_attention_kernel(q, *pages, tab, ln)

                def plain():
                    return PA.paged_attention_plain(q, *pages, cut, ln)
            else:
                def kern():
                    return PA.paged_attention_int8_kernel(q, *pages, tab, ln, *scale_args)

                def plain():
                    return PA.paged_attention_int8_plain(q, *pages, cut, ln, *scale_args)
            lib_call, lib_out = sdpa_yardstick(torch, q, *pages, cut, ln, *scale_args)
            scale_kw = dict(zip(("k_scales", "v_scales"), scale_args))
            oracle = PA.paged_attention_reference(q, *pages, cut, ln, **scale_kw)
            lib_err = (lib_out().float() - oracle.float()).abs().max().item()
            check(lib_err < 5e-2, f"the SDPA yardstick disagrees ({arch}, {kind}, {n}): "
                                  f"{lib_err}")
            bms, by = paged_bound_ms(torch, q, pages[0], ln, kind == "int8")
            row = {"arch": arch, "slots": slots, "tokens": n, "nh": nkv * g, "nkv": nkv,
                   "hd": hd, "bs": PAGED_BLOCK, "dtype": "bfloat16", "table_cols": PAGED_TABLE,
                   "splits": splits, "ms": time_ms(torch, kern, flush=flush),
                   "plain_ms": time_ms(torch, plain, reps=10, flush=flush),
                   "library_ms": time_ms(torch, lib_call, flush=flush),
                   "bound_ms": bms, "bound_by": by}
            rows[kind].append(row)
            # printed for the reader only: not measured in this run, so it
            # stays out of the kernels record
            first = PAGED_FIRST_MS.get((kind, slots, n)) if arch == "smollm-360m" else None
            print(f"[paged] {'B2' if kind == 'float' else 'B3'} at {arch}'s attention (nkv "
                  f"{nkv}, group {g}, hd {hd}), {slots} slots x {n} tokens, {splits} splits: "
                  f"kernel {row['ms']:.5f} ms  bound {bms:.5f} ms ({by})  plain "
                  f"{row['plain_ms']:.5f} ms  sdpa {row['library_ms']:.5f} ms  first kernel "
                  f"(PR 14) {'n/a' if first is None else f'{first:.5f} ms'}")
    return rows, err


# ---------------------------------------------------------------------------
# Phase 7: the paged slice on smollm-360m
# ---------------------------------------------------------------------------
class LogitRecorder:
    """Records every row ``engine`` samples, keyed (uid, step). The
    recording reads each step's logits to the host, which a captured step
    cannot do, so the engine's decode chunks run the same step eagerly
    while it records (streams equal to the replays', which the callers
    check)."""

    def __init__(self, engine):
        self.engine = engine
        self.rows = {}

    def __enter__(self):
        from repro_torch.serving import paged_engine as PE

        self._orig = PE.sample_rows
        chunk = self.engine._chunk

        def spy(logits, temperature, seed, uids, steps):
            host = logits.float().cpu()
            for i, key in enumerate(zip(uids.tolist(), steps.tolist())):
                self.rows.setdefault(key, host[i])
            return self._orig(logits, temperature, seed, uids, steps)

        PE.sample_rows = spy
        self.engine._chunk = lambda k: chunk(k, eager=True)
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import paged_engine as PE

        PE.sample_rows = self._orig
        del self.engine._chunk  # the class's method again


class ReplayRecorder:
    """Records, keyed (uid, step), every row ``engine`` samples while its
    decode chunks replay the captured step: entered on a fresh engine,
    before its step is captured, it adds to the step two device copies, of
    the logits and of each slot's (uid, step, active), into static buffers
    at the chunk's device column, read once after each chunk; an active
    row's record stands, an idle one's is dropped. Rows sampled outside the
    step (first tokens of admits and final prefill chunks) are read where
    they are sampled. A later record of a key replaces an earlier one, so a
    preempted request keeps the logits of the run that finished it."""

    def __init__(self, engine):
        self.engine = engine
        self.rows = {}

    def __enter__(self):
        import torch
        from repro_torch.serving import paged_engine as PE

        e = self.engine
        check(e._program is None, "ReplayRecorder needs an engine whose step is not captured")
        n, cmax = e.paged.max_concurrency, e.paged.chunk_max
        vp = e.model.cfg.vocab_padded
        self.logits = torch.zeros((cmax, n, vp), dtype=torch.float32, device=e.device)
        self.keys = torch.zeros((cmax, n, 3), dtype=torch.int32, device=e.device)
        self._orig, in_step = PE.sample_rows, [False]

        def spy(logits, temperature, seed, uids, steps):
            if in_step[0]:  # inside the captured step: device copies only
                col = e._col.reshape(1)
                self.logits.index_copy_(0, col, logits.float()[None])
                keys = torch.stack([uids, steps, e.cache["active"].to(torch.int32)], dim=1)
                self.keys.index_copy_(0, col, keys[None])
            else:
                host = logits.float().cpu()
                for i, key in enumerate(zip(uids.tolist(), steps.tolist())):
                    self.rows[key] = host[i]
            return self._orig(logits, temperature, seed, uids, steps)

        step, chunk = e._decode_step, e._chunk

        def recorded_step():
            in_step[0] = True
            try:
                step()
            finally:
                in_step[0] = False

        def recorded_chunk(k, **kw):
            buf = chunk(k, **kw)
            logits = self.logits[:k].to("cpu", copy=True)
            keys = self.keys[:k].to("cpu", copy=True)
            for t in range(k):
                for i, (uid, st, active) in enumerate(keys[t].tolist()):
                    if active:
                        self.rows[(uid, st)] = logits[t, i]
            return buf

        PE.sample_rows = spy
        e._decode_step, e._chunk = recorded_step, recorded_chunk
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import paged_engine as PE

        PE.sample_rows = self._orig  # the engine keeps its recording graph


def tie_limited(streams, vocab: int) -> dict:
    """Compare pairs of greedy streams that should be equal: ``streams`` is
    a list of (new tokens a, new tokens b, logits of a by step, logits of b
    by step). The tie band is twice the largest logit difference between
    the two runs over every step where their streams still agree (the same
    prefix); a pair may part only at a step whose top-1/top-2 gap in run b
    lies within the band, and the band must stay within TIE_BAND_CAP."""
    import torch

    deltas, partings, agree, total = [], [], 0, 0
    for a, b, la, lb in streams:
        n = len(b)
        first = next((t for t in range(n) if a[t] != b[t]), None)
        upto = n if first is None else first
        agree += upto
        total += n
        for t in range(upto):
            deltas.append((la[t][:vocab] - lb[t][:vocab]).abs().max().item())
        if first is not None:
            top2 = torch.topk(lb[first][:vocab], 2).values
            partings.append((first, (top2[0] - top2[1]).item()))
    check(bool(deltas), "no agreeing step to measure the tie band on")
    band = 2 * max(deltas)
    check(band <= TIE_BAND_CAP, f"tie band {band:.4f} above {TIE_BAND_CAP}: the runs differ "
                                f"by more than numerical noise")
    for t, gap in partings:
        check(gap <= band, f"streams part at step {t} where the top-2 gap {gap:.4f} exceeds "
                           f"the tie band {band:.4f}")
    return {"agree": agree, "total": total, "band": band, "partings": partings}


def fixed_slot_run(torch, model, prompts, max_new):
    """Greedy fixed-slot generation as ``GenerationEngine.generate`` runs
    it (prefill, then decode steps), with every step's logits."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import use_packed_backend

    with torch.inference_mode(), use_packed_backend("kernel"):
        p = torch.as_tensor(prompts, device="cuda")
        B, s0 = p.shape
        logits, caches = T.prefill(model, {"tokens": p}, s0 + max_new)
        steps = [logits[:, -1].float().cpu()]
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks = [nxt]
        for t in range(1, max_new):
            logits, caches = T.decode_step(model, nxt[:, None], caches, s0 + t - 1)
            steps.append(logits[:, -1].float().cpu())
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            toks.append(nxt)
    return torch.stack(toks, dim=1).cpu().numpy(), steps


#: the paged engine's programs, by method, and the kind serve_timed files
#: each one's time under
PROGRAM_KINDS = {"_admit": "admit", "_admit_suffix": "admit", "_admit_cached": "admit",
                 "_admit_batch": "batch", "_admit_stub": "stub", "_prefill_chunk": "prefill",
                 "_grow": "grow", "_chunk": "chunk"}


def serve_timed(torch, engine, reqs):
    """``engine.serve`` with each program timed on the host clock, from its
    call to a synchronize after it (an admit and a decode chunk end in a
    host read anyway): seconds by kind (B = 1 admits of every variant,
    batched groups, stubs, prefill chunks, grows, decode chunks), and the
    serve's wall time."""
    spent = dict.fromkeys(PROGRAM_KINDS.values(), 0.0)
    kept = {name: engine.__dict__.get(name) for name in PROGRAM_KINDS}

    def timed(fn, kind):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t
            return out
        return run

    for name, kind in PROGRAM_KINDS.items():
        setattr(engine, name, timed(getattr(engine, name), kind))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = engine.serve(reqs)
        torch.cuda.synchronize()
    finally:
        for name, fn in kept.items():
            if fn is None:
                delattr(engine, name)
            else:
                setattr(engine, name, fn)
    return out, time.perf_counter() - t0, spent


#: the short trace (phases 15 (c), 16 (b) and 17 (b), (c)): phase 7's
#: requests with the PAGED_SLOTS + 1 shortest prompts and the one with the
#: longest (five pages of PAGED_BLOCK), the i-th in uid order given
#: min(its new tokens, SHORT_MAX_NEW) - i % 3: more requests than slots, so
#: requests queue and are admitted into slots freed mid-run (a recurrent
#: end state installed into a recycled lane while the others decode); a
#: gloo rank's eager step takes up to a second, and the script must finish
#: well inside its limit
SHORT_MAX_NEW = 8


def short_trace_specs(cfg):
    """The short trace's (uid, prompt, max_new), in uid order."""
    specs, _ = trace_specs(cfg)
    by_size = sorted(specs, key=lambda s: s[1].size)
    keep = sorted(by_size[:PAGED_SLOTS + 1] + by_size[-1:], key=lambda s: s[0])
    return [(u, p, min(n, SHORT_MAX_NEW) - i % 3) for i, (u, p, n) in enumerate(keep)]


def trace_specs(cfg):
    """Phase 7's trace: TRACE_REQUESTS (uid, prompt, max_new) of seeded
    lengths (prompts 8-300, 4-32 new), and the generator it leaves."""
    import numpy as np

    rng = np.random.default_rng(0)
    specs = [(uid, rng.integers(0, cfg.vocab, size=int(rng.integers(8, 301))),
              int(rng.integers(4, 33))) for uid in range(TRACE_REQUESTS)]
    return specs, rng


def warm_paged(engine, prompt) -> None:
    """One short request through ``engine``: its first decode chunk
    captures the step, so later timings hold replays only."""
    from repro_torch.serving import Request

    engine.serve([Request(uid=10_000, prompt=prompt[:8], max_new=2)])
    check(engine._program.graph is not None and engine.chunk_traces == 1,
          "the paged warm-up did not capture the decode step")


def paged_step_turns(torch, engine, prompts, runs: int = 6) -> dict:
    """Per-step host-clock time of a decode chunk of PAGED_CHUNK steps over
    PAGED_SLOTS live slots (prompts of PROMPT tokens), replayed and run
    eagerly in turns on one engine; each chunk ends in its host read."""
    import numpy as np
    from repro_torch.models.layers import use_packed_backend
    from repro_torch.serving import Request

    sched = engine._make_scheduler()
    for b in range(PAGED_SLOTS):
        sched.submit(Request(uid=20_000 + b, prompt=np.asarray(prompts[b % len(prompts)]),
                             max_new=2 * runs * PAGED_CHUNK + 1))
    with torch.inference_mode(), use_packed_backend(engine.backend):
        adm = sched.try_admit()
        while adm is not None:
            engine._do_admit(adm)
            adm = sched.try_admit()
        check(len(sched.active) == PAGED_SLOTS, "the timing slots were not all admitted")
        return in_turns(torch, {"replay": lambda: engine._chunk(PAGED_CHUNK),
                                "eager": lambda: engine._chunk(PAGED_CHUNK, eager=True)},
                        runs=runs, scale=PAGED_CHUNK)


def phase_paged_slice(torch):
    import numpy as np
    import torch.profiler
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )
    from repro_torch.serving.scheduler import kv_pool_bytes

    cfg = get_config("smollm-360m")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    greedy = SamplerConfig(temperature=0.0)
    sites = 7 * cfg.n_layers

    def engine(kv_dtype="act", **kw):
        return PagedEngine(model, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, attn_impl="auto", kv_dtype=kv_dtype, **kw), greedy,
            device="cuda", **({"assert_bounds": True} if kv_dtype == "int8" else {}))

    # (a) equal-length batch against the fixed-slot engine
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]
    engine().generate(prompts, MAX_NEW)  # warm-up (allocator, cuBLAS handles)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng_a = engine()
    out = eng_a.generate(prompts, MAX_NEW)  # its first chunk captures the step
    wall_a = time.perf_counter() - t0
    counts = read_counts()
    check(counts["paged_decode_attention"] == cfg.n_layers * eng_a.decode_steps,
          f"B2 launches {counts} for {eng_a.decode_steps} decode steps")
    check(counts["w4a8_matmul"] == sites * (eng_a.decode_steps + eng_a.admits),
          f"B1 launches {counts}")
    check(eng_a.chunk_traces == 1 and eng_a._program.replays == eng_a.decode_steps - 1,
          f"{eng_a._program.replays} replays for {eng_a.decode_steps} decode steps")
    fixed = GenerationEngine(model, cfg, greedy, device="cuda").generate(prompts, MAX_NEW)
    fixed_toks, fixed_logits = fixed_slot_run(torch, model, prompts, MAX_NEW)
    check((fixed_toks == fixed[:, PROMPT:]).all(), "the recorded fixed-slot run differs "
                                                   "from GenerationEngine.generate")
    eng_r = engine()
    with LogitRecorder(eng_r) as rec:
        again = eng_r.generate(prompts, MAX_NEW)
    check((again == out).all(), "the eager chunk and the replayed one differ")
    cmp_a = tie_limited([(out[b, PROMPT:], fixed_toks[b],
                          [rec.rows[(b, t)] for t in range(MAX_NEW)],
                          [fixed_logits[t][b] for t in range(MAX_NEW)])
                         for b in range(BATCH)], cfg.vocab)
    print(f"[paged-slice] (a) {BATCH} x prompt {PROMPT} + {MAX_NEW} new: {cmp_a['agree']} of "
          f"{cmp_a['total']} tokens agree with GenerationEngine (partings {cmp_a['partings']}, "
          f"tie band {cmp_a['band']:.4f}); B2 launches {counts['paged_decode_attention']} = "
          f"{cfg.n_layers} x {eng_a.decode_steps} steps ({eng_a._program.replays} replays of "
          f"the captured step); tokens identical to the eager chunk's; "
          f"{BATCH * MAX_NEW / wall_a:.1f} tok/s with the capture")

    # (b) mid-flight admission, float then int8 KV, through the captured
    # step (each engine warmed by one short request, which captures it),
    # and the same trace through the eager chunk
    specs, rng = trace_specs(cfg)

    def trace():
        return [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]

    runs = {}
    for kv in ("act", "int8"):
        eng = engine(kv)
        warm_paged(eng, specs[0][1])
        before = {"steps": eng.decode_steps, "admits": eng.admits, "chunks": eng.chunks,
                  "suffix": eng.suffix_admits}
        reset_peak(torch)
        reset_counts()
        res, wall, spent = serve_timed(torch, eng, trace())
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = eng.decode_steps - before["steps"]
        admits = eng.admits - before["admits"]
        key = "paged_decode_attention" if kv == "act" else "paged_decode_attention_int8"
        other = "paged_decode_attention_int8" if kv == "act" else "paged_decode_attention"
        check(counts[key] == cfg.n_layers * steps and counts[other] == 0,
              f"{kv}: attention launches {counts} for {steps} decode steps")
        forwards = steps + admits + eng.suffix_admits - before["suffix"]
        check(counts["w4a8_matmul"] == sites * forwards, f"{kv}: B1 launches {counts} for "
                                                         f"{forwards} forwards")
        for u, p, n in specs:
            check(res[u].size == p.size + n, f"{kv}: request {u} incomplete")
        pool = eng.pool_state
        check(pool.free_top == 0 and not pool.page_rc.any()
              and int(eng.cache["free_top"]) == 0 and not eng.cache["page_refcounts"].any(),
              f"{kv}: pages not all back on the free list")
        eager = engine(kv)
        warm_paged(eager, specs[0][1])
        chunk = eager._chunk
        eager._chunk = lambda k, _c=chunk: _c(k, eager=True)
        eager_res = eager.serve(trace())
        check(eager.pool_state.digest() == pool.digest(), f"{kv}: the eager chunk's allocator "
                                                          f"digest differs from the replays'")
        check(all((eager_res[u] == res[u]).all() for u, _, _ in specs),
              f"{kv}: the eager chunk's streams differ from the replays'")
        check(getattr(eager, "watermark_values", None) == getattr(eng, "watermark_values", None),
              f"{kv}: the eager chunk's B3 watermarks differ from the replays'")
        n_new = sum(n for _, _, n in specs)
        runs[kv] = {"res": res, "digest": pool.digest(), "counts": counts, "wall": wall,
                    "steps": steps, "admits": admits, "spent": spent,
                    "peak": peak, "tok_s": n_new / wall,
                    "step_ms": 1e3 * spent["chunk"] / steps,
                    "admit_ms": 1e3 * spent["admit"] / admits,
                    "capture_ms": 1e3 * eng._program.capture_s,
                    "walk_ms": 1e3 * eng._program.walk_s,
                    "device_ops": eng._program.device_ops,
                    "pool_mib": kv_pool_bytes(cfg, PAGED_BLOCKS, PAGED_BLOCK, kv) / 2**20,
                    "watermarks": getattr(eng, "watermark_values", None)}
        print(f"[paged-slice] (b) {kv} KV: {TRACE_REQUESTS} requests, {steps} decode steps in "
              f"{eng.chunks - before['chunks']} chunks, replays of the captured step, {admits} "
              f"admits; launches {counts}; decode step {runs[kv]['step_ms']:.3f} ms, admit "
              f"{runs[kv]['admit_ms']:.3f} ms (host clock), {runs[kv]['tok_s']:.1f} tok/s, wall "
              f"{wall:.3f} s; pool {runs[kv]['pool_mib']:.2f} MiB; peak memory "
              f"{peak / 2**20:.1f} MiB; streams, digest and watermarks equal to the eager "
              f"chunk's")
    check(runs["act"]["digest"] == runs["int8"]["digest"], "float and int8 allocator digests differ")
    spec = engine("int8").attn_spec
    qk, pv = runs["int8"]["watermarks"]
    check(qk <= 2 ** (spec.p_qk - 1) - 1 and pv <= 2 ** (spec.p_pv - 1) - 1 and spec.p_qk == 21
          and spec.p_pv == 22, f"B3 watermarks {qk}, {pv} against {spec.describe()}")
    same = sum(int((runs["act"]["res"][u][p.size:] == runs["int8"]["res"][u][p.size:]).sum())
               for u, p, _ in specs)
    total = sum(n for _, _, n in specs)
    print(f"[paged-slice] (b) equal digests {runs['act']['digest']}; B3 watermarks |QK^T| {qk} "
          f"<= {2 ** (spec.p_qk - 1) - 1}, |PV| {pv} <= {2 ** (spec.p_pv - 1) - 1} "
          f"({spec.describe()}); int8 agrees with float on {same} of {total} tokens "
          f"({same / total:.4f})")

    # the decode step replayed and eager, in turns, over PAGED_SLOTS live slots
    for kv in ("act", "int8"):
        eng = engine(kv)
        warm_paged(eng, specs[0][1])
        reset_peak(torch)
        turns = paged_step_turns(torch, eng, prompts)
        runs[kv]["turns"] = turns
        runs[kv]["turns_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        print(f"[graph] paged {kv} KV decode step ({PAGED_SLOTS} slots of {PROMPT}+ tokens, "
              f"chunks of {PAGED_CHUNK}), in turns: replay {fmt_spread(turns['replay'])} = "
              f"{1e3 * PAGED_SLOTS / turns['replay']['median']:.1f} tok/s; eager "
              f"{fmt_spread(turns['eager'])} = "
              f"{1e3 * PAGED_SLOTS / turns['eager']['median']:.1f} tok/s; capture "
              f"{runs[kv]['capture_ms']:.3f} ms (node walk {runs[kv]['walk_ms']:.3f} ms) for "
              f"{runs[kv]['device_ops']} device "
              f"operations; peak memory {runs[kv]['turns_peak_mib']:.1f} MiB")

    # (c) the prefix cache: warm streams against a cold engine's, both
    # through the captured step; the logits of the tie-limited comparison
    # come from the eager chunk, whose streams must equal the replays'
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN)
    pspecs = [(100 + i, np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                              size=int(rng.integers(1, 41)))]),
               8) for i in range(6)] + [(106, prefix.copy(), 8)]

    def preqs():
        return [Request(uid=u, prompt=p, max_new=n) for u, p, n in pspecs]

    warm_eng = engine(prefix_cache=True)
    cached_counts = []
    orig = warm_eng._admit_cached

    def admit_cached(adm):
        before = read_counts()
        orig(adm)
        torch.cuda.synchronize()
        cached_counts.append({k: v - before[k] for k, v in read_counts().items()})

    warm_eng._admit_cached = admit_cached
    warm = warm_eng.serve(preqs())
    cold = engine().serve(preqs())
    rec_warm = engine(prefix_cache=True)
    with LogitRecorder(rec_warm) as warm_rec:
        warm_e = rec_warm.serve(preqs())
    rec_cold = engine()
    with LogitRecorder(rec_cold) as cold_rec:
        cold_e = rec_cold.serve(preqs())
    check(all((warm[u] == warm_e[u]).all() and (cold[u] == cold_e[u]).all()
              for u, _, _ in pspecs), "prefix cache: the eager chunk's streams differ from "
                                      "the replays'")
    check(len(cached_counts) == 1 and not any(cached_counts[0].values()),
          f"cached admit launches {cached_counts}")
    check(warm_eng.suffix_admits == 5 and warm_eng.cached_admits == 1,
          f"admits {warm_eng.admits}/{warm_eng.suffix_admits}/{warm_eng.cached_admits}")
    cmp_c = tie_limited([(warm[u][p.size:], cold[u][p.size:],
                          [warm_rec.rows[(u, t)] for t in range(n)],
                          [cold_rec.rows[(u, t)] for t in range(n)]) for u, p, n in pspecs],
                        cfg.vocab)
    print(f"[paged-slice] (c) prefix cache: 1 cold, {warm_eng.suffix_admits} suffix and "
          f"{warm_eng.cached_admits} cached admits (the cached one launched nothing: "
          f"{cached_counts[0]}); hit rate {warm_eng.prefix_cache.stats()['hit_rate']:.3f}; "
          f"{cmp_c['agree']} of {cmp_c['total']} tokens agree with a cold engine (partings "
          f"{cmp_c['partings']}, tie band {cmp_c['band']:.4f}); streams through the captured "
          f"step equal the eager chunk's")

    # replayed decode steps under the profiler, a trace each (a trace of a
    # whole 8-step chunk, about 45000 kernels, mostly loses device records):
    # the profiled engine runs each chunk one step at a time, its first step
    # (the capture) untraced, and traces at most PAGED_PROFILE_TRIES steps
    # until PAGED_CHUNK of them hold every node of the graph; those are
    # counted, and each lost trace says where it lost its records
    from repro_torch.trace import WARMUP, record_gaps

    prof_eng = engine()
    orig_chunk = prof_eng._chunk
    steps, lost = [], []

    def profiled(k):
        bufs = []
        for _ in range(k):
            program = prof_eng._program
            if (len(steps) == PAGED_CHUNK or len(steps) + len(lost) == PAGED_PROFILE_TRIES
                    or program is None or program.graph is None):
                bufs.append(orig_chunk(1))
                continue
            before = read_counts()["w4a8_matmul"]
            t = []

            def step():
                t.append(time.perf_counter())
                bufs.append(orig_chunk(1))  # ends in a host read of its tokens
                t.append(time.perf_counter())

            prof, _, complete = traced(torch, step, graph_ops=program.device_ops)
            if complete:
                steps.append({"wall_ms": 1e3 * (t[1] - t[0]), "prof": prof,
                              "launches": read_counts()["w4a8_matmul"] - before})
            else:
                gaps, graph_records = record_gaps(prof.profiler.kineto_results.events())
                lost.append({"launches_lost": gaps, "graph_records": graph_records,
                             "graph_ops": program.device_ops})
        buf = bufs[0].copy()
        for t, b in enumerate(bufs):
            buf[:, t] = b[:, 0]
        return buf

    prof_eng._chunk = profiled
    prof_eng.generate(prompts, PAGED_PROFILE_TRIES + 2)
    for i, g in enumerate(lost[:4]):
        gaps = g["launches_lost"]
        where = f"{gaps}" if len(gaps) <= 8 else f"{gaps[:4]} ... {gaps[-2:]}"
        print(f"[profile] lost trace {i}: {len(gaps)} host launches without a device record, "
              f"at {where} (launch order; the first {WARMUP} are the opening sleeps); the "
              f"graph replays' device records {g['graph_records']} of {g['graph_ops']}")
    if not steps:  # the run goes on: the kernels are held to the counters above
        print(f"[profile] not measured: the profiler lost device kernel records in all "
              f"{len(lost)} traced decode steps")
        return {"a": cmp_a, "runs": runs, "c": cmp_c, "model": model, "profile": None}
    n = len(steps)
    print(steps[0]["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=12))
    wall = sum(st["wall_ms"] for st in steps)
    launches = sum(st["launches"] for st in steps)
    busy = b2 = b1 = 0.0
    b2_calls = seen = 0
    for st in steps:
        kernels = traced_kernels(torch, st["prof"].key_averages())
        busy += sum(e.self_device_time_total for e in kernels) / 1e3
        b2 += sum(e.self_device_time_total for e in kernels if "paged_attn_float" in e.key) / 1e3
        b2_calls += sum(e.count for e in kernels if "paged_attn_float" in e.key)
        b1 += sum(e.self_device_time_total for e in kernels if "w4a8_kernel" in e.key) / 1e3
        seen += w4a8_seen(kernels)
    check(b2 > 0 and b1 > 0, "the profiler saw no B2 or B1 kernel in the profiled decode steps")
    check(seen == launches == 7 * cfg.n_layers * n,
          f"the profiler saw {seen} w4a8 kernels in {n} replayed decode steps, the "
          f"launch counter {launches}")
    check(b2_calls == cfg.n_layers * n,
          f"the profiler saw {b2_calls} B2 kernels in {n} replayed decode steps")
    print(f"[profile] {n} replayed decode steps, {PAGED_SLOTS} slots, a trace each "
          f"({len(lost)} more steps' traces lost device records and are not counted): "
          f"{wall:.3f} ms on the host clock, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), B2 {b2:.3f} ms in {b2_calls} launches "
          f"({1e3 * b2 / max(b2_calls, 1):.3f} us a launch), B1 {b1:.3f} ms in {seen} launches "
          f"by name (launch counter {launches})")
    return {"a": cmp_a, "runs": runs, "c": cmp_c, "model": model,
            "profile": {"steps_wall_ms": wall, "busy_ms": busy, "b2_ms": b2,
                        "b2_launches": b2_calls, "b1_ms": b1, "steps": n,
                        "steps_lost": len(lost)}}


# ---------------------------------------------------------------------------
# Phase 10: the throughput scheduler loop
# ---------------------------------------------------------------------------
#: phase 10 (a): the policy, and the burst of cold prompts (65-128 tokens,
#: two pages each) put before phase 7's trace, which the first admission
#: pass takes as one batched group of M = 4 x 2 x 64 = 512 (phase 7's trace
#: alone forms none: under chunks of 128 its cold admits are separated by
#: chunked stubs)
THROUGHPUT_POLICY = dict(admit_window=4, batch_max=4, prefill_chunk=128)
BURST = 4
#: phase 10 (b): the policy and pool of the preemption run, over phase 7's
#: prompts with PREEMPT_NEW_SCALE x their new tokens (with 4-32 new tokens,
#: 64-token pages and a 1-page reserve, no pool size preempts: a request
#: crosses at most one page boundary)
PREEMPT_POLICY = dict(admit_window=2, batch_max=4, watermark=(1, 4))
PREEMPT_BLOCKS, PREEMPT_NEW_SCALE = 12, 4


def program_counts(e) -> dict:
    return {"steps": e.decode_steps, "admits": e.admits, "suffix": e.suffix_admits,
            "cached": e.cached_admits, "batch": e.batch_admits, "stubs": e.stub_admits,
            "chunks": e.prefill_chunks, "grows": e.grows, "preemptions": e.preemptions,
            "decode_chunks": e.chunks}


def driven(torch, cfg, engine, reqs, kv, per_forward=None) -> dict:
    """Serve ``reqs`` on ``engine`` (its step captured) with the launch
    counters set to 0 just before and read just after; checks the exact
    GEMM counts (``per_forward``: counter -> launches a forward, default
    smollm-360m's 7 B1 sites a layer) and B2/B3 counts, every request
    complete and every page back on the free list, host and device.
    Returns the run's figures."""
    before = program_counts(engine)
    reset_peak(torch)
    reset_counts()
    res, wall, spent = serve_timed(torch, engine, reqs)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    ran = {k: v - before[k] for k, v in program_counts(engine).items()}
    key = "paged_decode_attention" if kv == "act" else "paged_decode_attention_int8"
    other = "paged_decode_attention_int8" if kv == "act" else "paged_decode_attention"
    n_attn = sum(cfg.layer_spec(i).mixer == "attn" for i in range(cfg.n_layers))
    check(counts[key] == n_attn * ran["steps"] and counts[other] == 0,
          f"{kv}: attention launches {counts} for {ran['steps']} decode steps")
    forwards = ran["steps"] + ran["admits"] + ran["suffix"] + ran["batch"] + ran["chunks"]
    for counter, n in (per_forward or {"w4a8_matmul": 7 * cfg.n_layers}).items():
        check(counts[counter] == n * forwards,
              f"{kv}: {counter} launches {counts} for {forwards} forwards ({ran})")
    check(engine.chunk_traces == 1, f"{engine.chunk_traces} captures of the decode step")
    for r in reqs:
        check(res[r.uid].size == r.prompt.size + r.max_new, f"{kv}: request {r.uid} incomplete")
    pool, cache = engine.pool_state, engine.cache
    check(pool.free_top == 0 and not pool.page_rc.any()
          and sorted(pool.free_list.tolist()) == list(range(pool.free_list.size))
          and int(cache["free_top"]) == 0 and not cache["page_refcounts"].any()
          and cache["free_list"].cpu().tolist() == pool.free_list.tolist(),
          f"{kv}: pages not all back on the free list")
    n_new = sum(r.max_new for r in reqs)
    admit_s = sum(spent[k] for k in ("admit", "batch", "stub", "prefill"))
    return {"res": res, "counts": counts, "ran": ran, "wall": wall, "spent": spent,
            "admit_ms_per_request": 1e3 * admit_s / len(reqs),
            "peak_mib": peak / 2**20, "tok_s": n_new / wall, "digest": pool.digest(),
            "step_ms": 1e3 * spent["chunk"] / max(ran["steps"], 1),
            "watermarks": getattr(engine, "watermark_values", None)}


def recorded(engine, reqs, warm_prompt):
    """``reqs`` through a fresh ``engine`` warmed by one short request,
    every row's logits recorded through the replays."""
    with ReplayRecorder(engine) as rec:
        warm_paged(engine, warm_prompt)
        res = engine.serve(reqs)
    return res, rec.rows


def tie_vs(specs, a, rec_a, b, rec_b, vocab):
    return tie_limited([(a[u][p.size:], b[u][p.size:], [rec_a[(u, t)] for t in range(n)],
                         [rec_b[(u, t)] for t in range(n)]) for u, p, n in specs], vocab)


def fmt_admits(run) -> str:
    sp, ran = run["spent"], run["ran"]
    return (f"admit side {run['admit_ms_per_request']:.3f} ms a request: {ran['batch']} "
            f"batched groups {1e3 * sp['batch']:.1f} ms, "
            f"{ran['admits'] + ran['suffix']} B = 1 admits {1e3 * sp['admit']:.1f} ms, "
            f"{ran['stubs']} stubs {1e3 * sp['stub']:.1f} ms, {ran['chunks']} prefill chunks "
            f"{1e3 * sp['prefill']:.1f} ms")


def phase_throughput_slice(torch, paged):
    from repro_torch.configs import get_config
    from repro_torch.serving import (
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
        SchedulerPolicy,
    )

    cfg = get_config("smollm-360m")
    model = paged["model"]
    greedy = SamplerConfig(temperature=0.0)

    def engine(kv="act", num_blocks=PAGED_BLOCKS, **policy):
        return PagedEngine(model, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=num_blocks, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, attn_impl="auto", kv_dtype=kv,
            sched=SchedulerPolicy(**policy)), greedy, device="cuda",
            **({"assert_bounds": True} if kv == "int8" else {}))

    specs, rng = trace_specs(cfg)
    burst = [(200 + i, rng.integers(0, cfg.vocab, size=int(rng.integers(65, 129))),
              int(rng.integers(4, 33))) for i in range(BURST)]
    specs_a = burst + specs
    warm = specs[0][1]

    def reqs(sp):
        return [Request(uid=u, prompt=p, max_new=n) for u, p, n in sp]

    # (a) batched and chunked admission against FIFO on the same trace,
    # float then int8 KV; every engine warmed by one short request
    out = {}
    for kv in ("act", "int8"):
        eng = engine(kv, **THROUGHPUT_POLICY)
        warm_paged(eng, warm)
        thr = driven(torch, cfg, eng, reqs(specs_a), kv)
        ran = thr["ran"]
        check(ran["batch"] >= 1 and ran["stubs"] >= 1 and ran["chunks"] >= 1,
              f"{kv}: the throughput programs did not all run: {ran}")
        fifo_eng = engine(kv)
        warm_paged(fifo_eng, warm)
        fifo = driven(torch, cfg, fifo_eng, reqs(specs_a), kv)
        thr_r, thr_rows = recorded(engine(kv, **THROUGHPUT_POLICY), reqs(specs_a), warm)
        fifo_r, fifo_rows = recorded(engine(kv), reqs(specs_a), warm)
        check(all((thr_r[u] == thr["res"][u]).all() and (fifo_r[u] == fifo["res"][u]).all()
                  for u, _, _ in specs_a), f"{kv}: the recorded runs' streams differ")
        cmp = tie_vs(specs_a, thr["res"], thr_rows, fifo["res"], fifo_rows, cfg.vocab)
        if kv == "int8":
            spec = eng.attn_spec
            qk, pv = thr["watermarks"]
            check(qk <= 2 ** (spec.p_qk - 1) - 1 and pv <= 2 ** (spec.p_pv - 1) - 1,
                  f"B3 watermarks {qk}, {pv} against {spec.describe()}")
        out[kv] = {"thr": thr, "fifo": fifo, "cmp": cmp}
        ph7 = paged["runs"][kv]
        print(f"[throughput] (a) {kv} KV, policy {THROUGHPUT_POLICY}, {len(specs_a)} requests "
              f"({BURST} cold prompts of {[p.size for _, p, _ in burst]} tokens, then phase 7's "
              f"{TRACE_REQUESTS}): {ran}; launches {thr['counts']}; {cmp['agree']} of "
              f"{cmp['total']} tokens agree with FIFO (partings {cmp['partings']}, tie band "
              f"{cmp['band']:.4f}); throughput: {fmt_admits(thr)}; decode step "
              f"{thr['step_ms']:.3f} ms; {thr['tok_s']:.1f} tok/s, "
              f"wall {thr['wall']:.3f} s, peak {thr['peak_mib']:.1f} MiB | FIFO, same trace: "
              f"{fmt_admits(fifo)}; decode step {fifo['step_ms']:.3f} ms; {fifo['tok_s']:.1f} "
              f"tok/s, wall {fifo['wall']:.3f} s, peak {fifo['peak_mib']:.1f} MiB | phase 7 "
              f"FIFO ({TRACE_REQUESTS} requests): admit {ph7['admit_ms']:.3f} ms, step "
              f"{ph7['step_ms']:.3f} ms, {ph7['tok_s']:.1f} tok/s, wall {ph7['wall']:.3f} s"
              + (f"; B3 watermarks {thr['watermarks']}" if kv == "int8" else ""))

    # (b) watermark growth and preemption, float KV
    specs_b = [(u, p, PREEMPT_NEW_SCALE * n) for u, p, n in specs]
    # (the measured run records its logits: recording adds two device copies
    # a step and one host read a chunk)
    eng = engine("act", PREEMPT_BLOCKS, **PREEMPT_POLICY)
    with ReplayRecorder(eng) as rec:
        warm_paged(eng, warm)
        pre = driven(torch, cfg, eng, reqs(specs_b), "act")
    check(pre["ran"]["preemptions"] >= 1 and pre["ran"]["grows"] >= 1,
          f"no preemption in a {PREEMPT_BLOCKS}-page pool: {pre['ran']}")
    fifo_r, fifo_rows = recorded(engine("act"), reqs(specs_b), warm)
    cmp_b = tie_vs(specs_b, pre["res"], rec.rows, fifo_r, fifo_rows, cfg.vocab)
    out["b"] = {"run": pre, "cmp": cmp_b}
    print(f"[throughput] (b) float KV, policy {PREEMPT_POLICY}, {PREEMPT_BLOCKS}-page pool, "
          f"phase 7's prompts with {PREEMPT_NEW_SCALE}x their new tokens: {pre['ran']}; "
          f"launches {pre['counts']}; {cmp_b['agree']} of {cmp_b['total']} tokens agree with "
          f"FIFO (partings {cmp_b['partings']}, tie band {cmp_b['band']:.4f}); every page free "
          f"(digest {pre['digest']}); decode step {pre['step_ms']:.3f} ms, {pre['tok_s']:.1f} "
          f"tok/s, wall {pre['wall']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the 2:4 kernels (B4, masked B5) and the fused RMSNorm quantizer (B6)
# ---------------------------------------------------------------------------
def sparse_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one B4 call: codes, packed kept codes and meta (K/4
    bytes each per column) and the two f32 epilogue vectors read once, the
    bf16 output written once, against the products the kept codes need
    (half of K) at the int8 tensor-core peak."""
    nbytes = m * k + 2 * (k // 4) * n + 2 * 4 * n + 2 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * n * (k // 2) / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_bound_ms(m: int, d: int, in_bytes: int) -> tuple[float, str]:
    """Least time for one B6 call: x and gamma read once, the uint8 codes
    written once, against about 8 float32 operations an element."""
    nbytes = m * d * in_bytes + 4 * d + 8 + m * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 8 * m * d / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def semi_structured_yardstick(torch, w8, xs, exact):
    """``torch.sparse.to_sparse_semi_structured`` int8 x int8 on the expanded
    codes (2:4 along K, so the transposed (N, K) weight is compressed), the
    activations as a column-major operand: ``torch.mm``, else the int32
    output of ``torch._cslt_sparse_mm`` on the same compressed weight.
    Returns (call, its name) for the first whose product passes the
    caller's ``exact`` check, else (None, why not)."""
    why = []
    try:
        from torch.sparse import to_sparse_semi_structured

        ws = to_sparse_semi_structured(w8.t().contiguous())
    except Exception as e:  # the library's refusal is the record, not a failure
        return None, (str(e).strip().splitlines() or [type(e).__name__])[0][:160]
    xb = xs.t()
    calls = [("mm", lambda: torch.mm(ws, xb))]
    if hasattr(torch, "_cslt_sparse_mm") and getattr(ws, "packed", None) is not None:
        calls.append(("_cslt_sparse_mm int32", lambda: torch._cslt_sparse_mm(
            ws.packed, xb, out_dtype=torch.int32)))
    for name, call in calls:
        try:
            out = call()
            prod = out.t() if out.shape[0] == w8.shape[1] else out
            if exact(prod):
                return call, name
            why.append(f"{name}: {out.dtype} output disagrees with the exact product")
        except Exception as e:
            why.append(f"{name}: " + (str(e).strip().splitlines() or [type(e).__name__])[0])
    return None, "; ".join(why)[:240]


def phase_sparse_kernels(torch, gpfq_rows):
    from repro_torch.core.alphabet import act_alphabet
    from repro_torch.core.overflow import certify
    from repro_torch.core.sparsity import is_2to4, mask_2to4
    from repro_torch.kernels import quant_rmsnorm as B6
    from repro_torch.kernels.gpfq_solve import (
        gpfq_solve_kernel,
        gpfq_solve_plain,
        tie_limited_agreement,
    )
    from repro_torch.kernels.ops import norm_and_quantize
    from repro_torch.kernels.w4a8_mm import (
        check_inner,
        compress_2to4,
        pack_int4,
        unpack_sparse24,
        w4a8_matmul,
        w4a8_matmul_kernel,
        w4a8_sparse_matmul,
        w4a8_sparse_matmul_kernel,
        w4a8_sparse_matmul_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    # B4 at phase 2's shapes: bit-equal to its plain version and to B1 on
    # the expanded codes
    b4_rows, b4_err = [], 0.0
    cases = [(m, k, n) for m in W4A8_M for k, n in SHAPES_KN] + [(3, 960, 100)] + RAGGED_MKN
    for m, k, n in cases:
        q = torch.randint(-8, 8, (k, n), generator=gen, device=dev)
        q = q * mask_2to4(q.float()).to(q.dtype)
        packed, meta = compress_2to4(q)
        check(torch.equal(unpack_sparse24(packed, meta), q.to(torch.int8)),
              f"2:4 compression does not round-trip at K={k} N={n}")
        dense = pack_int4(q)
        col_sums = q.sum(0).to(torch.int32)
        scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 1e-3
        act_scale = torch.tensor(0.0213, device=dev)
        row = {"M": m, "K": k, "N": n}
        for act in ("uint8", "int8"):
            lo, hi = (0, 256) if act == "uint8" else (-128, 128)
            x = torch.randint(lo, hi, (m, k), generator=gen, device=dev).to(getattr(torch, act))
            zp = torch.tensor(131.0 if act == "uint8" else 0.0, device=dev)
            kw = dict(col_sums=col_sums, out_dtype=torch.bfloat16)
            y = w4a8_sparse_matmul(x, packed, meta, scale, act_scale, zp, **kw)
            r = w4a8_sparse_matmul(x, packed, meta, scale, act_scale, zp, reference=True, **kw)
            b1 = w4a8_matmul(x, dense, scale, act_scale, zp, **kw)
            torch.cuda.synchronize()
            b4_err = max(b4_err, (y.float() - r.float()).abs().max().item())
            check(torch.equal(y, r), f"B4 != plain at M={m} K={k} N={n} {act}")
            check(torch.equal(y, b1), f"B4 != B1 on the expanded codes at M={m} K={k} N={n} "
                                      f"{act}")
            if act == "uint8":
                sw = scale * act_scale
                corr = col_sums.to(torch.float32) * zp
                row["ms"] = time_ms(torch, lambda: w4a8_sparse_matmul_kernel(
                    x, packed, meta, sw, corr, torch.bfloat16), flush=flush)
                row.update(plan_fields(w4a8_sparse_matmul.last_plan))
                row["b1_ms"] = time_ms(torch, lambda: w4a8_matmul_kernel(
                    x, dense, sw, corr, torch.bfloat16), flush=flush)
                row["plain_ms"] = time_ms(torch, lambda: w4a8_sparse_matmul_plain(
                    x, packed, meta, sw, corr, torch.bfloat16), flush=flush)
                row["library_ms"] = row["semi_structured_ms"] = None
                if k % 8 == 0 and n % 8 == 0:
                    mp = max(m, 32)  # _int_mm needs M > 16
                    xs = torch.zeros((mp, k), dtype=torch.int8, device=dev)
                    xs[:m] = (x.to(torch.int16) - 128).to(torch.int8)
                    w8 = q.to(torch.int8).contiguous()
                    exact = x.to(torch.float64) @ q.to(torch.float64)
                    acc = torch._int_mm(xs, w8)[:m] + 128 * col_sums
                    check(torch.equal(acc.to(torch.float64), exact),
                          "the _int_mm yardstick disagrees with the exact product")
                    row["library_ms"] = time_ms(torch, lambda: torch._int_mm(xs, w8),
                                                flush=flush)
                    call, why = semi_structured_yardstick(
                        torch, w8, xs, lambda p: torch.equal(
                            (p[:m].to(torch.int64) + 128 * col_sums).to(torch.float64), exact))
                    row["semi_structured_ms"] = (f"n/a: {why}" if call is None
                                                 else time_ms(torch, call, flush=flush))
                    row["semi_structured_call"] = why
        row["bound_ms"], row["bound_by"] = sparse_bound_ms(m, k, n)
        b4_rows.append(row)
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        ss = row["semi_structured_ms"]
        ss = ss if ss is None or isinstance(ss, str) else (
            f"{ss:.5f} ms ({row['semi_structured_call']})")
        print(f"[b4] M={m:4d} K={k:5d} N={n:5d} bit-equal to plain and B1 (u8,s8) "
              f"kernel {row['ms']:.5f} ms  B1 {row['b1_ms']:.5f} ms  plain "
              f"{row['plain_ms']:.5f} ms  _int_mm {lib} ms  semi-structured {ss}  bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})  {row['plan']}")
    print_layer_sums("b4", "b4", b4_rows)

    # the P_I check over the certified tiles of the expanded codes, on an
    # l1-budgeted 2:4 weight
    k, n = 960, 960
    q = torch.randint(-7, 8, (k, n), generator=gen, device=dev)
    q = q * mask_2to4(q.float()).to(q.dtype)
    tiles = q.reshape(k // 64, 64, n)
    q = (tiles * (torch.cumsum(tiles.abs(), dim=1) <= 128)).reshape(k, n)
    check(is_2to4(q), "the budgeted weight lost its 2:4 pattern")
    packed, meta = compress_2to4(q)
    x = torch.randint(0, 256, (256, k), generator=gen, device=dev).to(torch.uint8)
    y = w4a8_sparse_matmul(x, packed, meta, torch.ones(n, device=dev), 0.01, 131.0,
                           col_sums=q.sum(0).to(torch.int32), block_k=128, p_inner=16,
                           assert_inner=True, out_dtype=torch.bfloat16)
    watermark = check_inner(x, packed, 128, 16, meta=meta)
    check(bool(torch.isfinite(y.float()).all()), "non-finite B4 output")
    full = torch.full((k, n), -8, device=dev)
    fp, fm = compress_2to4(full * mask_2to4(full.float()).to(full.dtype))
    raised = False
    try:
        check_inner(x, fp, 128, 15, meta=fm)
    except OverflowError:
        raised = True
    check(raised, "an unbudgeted 2:4 weight passed the P_I=15 check")
    print(f"[b4] assert_inner: an l1-budgeted 2:4 weight passes P_I=16 (watermark {watermark} "
          f"<= {2 ** 15 - 1}); an unbudgeted one raises at P_I=15")

    # B5 with a mask at one layer's shapes, split mode
    by_shape = {(r["K"], r["C"]): r for r in gpfq_rows
                if (r["mode"], r["rounding"]) == ("split", "nearest")}
    b5_rows, b5_err = [], 0.0
    for k, c in SHAPES_KN:
        args, act, order, axe = gpfq_case_inputs(torch, k, c, "split", "nearest", gen)
        inv = torch.argsort(order)
        mask = mask_2to4(args[0][inv])[order].to(torch.uint8).contiguous()
        kw = dict(qmax=7.0, mode="split", rounding="nearest")
        q, u, pos, neg = gpfq_solve_kernel(*args, **kw, mask=mask)
        pq, _, _, _, v = gpfq_solve_plain(*args, **kw, mask=mask, return_v=True)
        torch.cuda.synchronize()
        ok, share, cut = tie_limited_agreement(pq, q, v, "nearest", 1e-3)
        check(ok, f"masked gpfq_solve K={k} C={c}: codes differ before the first tie "
                  f"(share equal {share:.5f})")
        b5_err = max(b5_err, (q - pq).abs().max().item())
        check(not q[mask == 0].any(), f"masked gpfq_solve K={k} C={c}: a pruned code is "
                                      f"nonzero")
        check(u_consistent(torch, args, q, u),
              f"masked gpfq_solve K={k} C={c}: U is not Xg^T W - Xh^T Q of its own codes")
        tid, n_tiles = args[6], args[5].shape[0]
        sums_p = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(), q.clamp(min=0))
        sums_n = torch.zeros((n_tiles, c), device=dev).index_add_(0, tid.long(), q.clamp(max=0))
        check(torch.equal(sums_p, pos) and torch.equal(sums_n, neg),
              f"masked gpfq_solve K={k} C={c}: pos/neg are not the tile sums of its codes")
        rep = certify(q[inv], act, 16, 128, sparsity="2:4")
        check(bool(rep), f"masked gpfq_solve K={k} C={c}: sparse certificate fails: {rep}")
        ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw, mask=mask), reps=5,
                     flush=flush)
        dense_ms = time_ms(torch, lambda: gpfq_solve_kernel(*args, **kw), reps=5, flush=flush)
        plain_ms = wall_ms(torch, lambda: gpfq_solve_plain(*args, **kw, mask=mask), reps=2)
        bms, by = gpfq_bound_ms(k, k, c)
        bms += 1e3 * k * c / HBM_BYTES_PER_S  # the mask's bytes (never the binding term)
        b5_rows.append({"K": k, "C": c, "share_equal": share, "channels_cut_by_tie": cut,
                        "headroom_bits": rep.headroom_bits, "ms": ms, "unmasked_ms": dense_ms,
                        "phase4_ms": by_shape[(k, c)]["ms"], "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "library_ms": None})
        print(f"[b5-mask] K={k:5d} C={c:5d} split nearest: tie-limited agreement ok, "
              f"{share:.5f} of codes equal ({cut} channels cut by a tie), zeros where the mask "
              f"is 0, pos/neg exact, sparse certificate headroom {rep.headroom_bits:.4f} bits; "
              f"masked {ms:.4f} ms  unmasked {dense_ms:.4f} ms (phase 4 "
              f"{by_shape[(k, c)]['ms']:.4f} ms)  plain {plain_ms:.1f} ms  bound {bms:.4f} ms "
              f"({by})")

    return {"b4": (b4_rows, b4_err), "b5": (b5_rows, b5_err)}


def rmsnorm_profile_us(torch, fn, flush, name: str, calls: int = 5) -> float:
    """Median device time (us) of the kernels whose name holds ``name``, one
    a call of ``fn`` over ``calls`` calls each after an L2 flush, from a
    complete torch.profiler trace."""
    def run():
        for _ in range(calls):
            flush.zero_()
            fn()

    prof, _ = profile_complete(torch, run)
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    check(len(durs) == calls, f"the profiler saw {len(durs)} {name} kernels in {calls} calls")
    return statistics.median(durs)


def phase_rmsnorm(torch):
    """Phase 8's B6 part: the counts of one driven run of
    ``ops.norm_and_quantize`` (and the profiler's one kernel a call), then
    the sweep: per shape and type the kernel bit-equal to its model and
    within one code of its plain version, timed in RMSNORM_ROUNDS rounds by
    events beside an empty kernel on the same grid, by the profiler, and
    beside ``F.rms_norm``, the plain version and the byte bound."""
    from repro_torch.kernels import quant_rmsnorm as B6
    from repro_torch.kernels.ops import norm_and_quantize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    kw = dict(eps=1e-6, qmax=255.0)
    inputs = {}
    for m, d in RMSNORM_SWEEP:
        x = torch.randn((m, d), generator=gen, device=dev) * 2
        g = torch.randn((d,), generator=gen, device=dev) * 0.1 + 1.0
        inputs[(m, d)] = (x, g)

    # ops.norm_and_quantize, its entry point: the counts of one driven run,
    # then one kernel a call by name, with Python-number and device-scalar
    # quantizers
    driven = [inputs[s] for s in RMSNORM_DRIVEN]
    torch.cuda.synchronize()
    reset_counts()
    for x, g in driven:
        norm_and_quantize(x, g, 0.02, 128, block_m=x.shape[0])
    torch.cuda.synchronize()
    launches = read_counts()["quant_rmsnorm"]
    check(launches == len(driven), f"{launches} quant_rmsnorm launches through "
                                   f"norm_and_quantize, expected {len(driven)}")
    s_dev = torch.tensor(0.02, device=dev)
    z_dev = torch.tensor(128.0, device=dev)
    def both():
        for x, g in driven:
            norm_and_quantize(x, g, 0.02, 128, block_m=x.shape[0])
            norm_and_quantize(x, g, s_dev, z_dev, block_m=x.shape[0])

    prof, _ = profile_complete(torch, both)
    kernels = traced_kernels(torch, prof.events())
    named = sum("quant_rmsnorm_" in e.name for e in kernels)
    check(named == len(kernels) == 2 * len(driven),
          f"norm_and_quantize: the profiler saw {len(kernels)} kernels, {named} of them B6, "
          f"in {2 * len(driven)} calls")
    print(f"[b6] norm_and_quantize at {RMSNORM_DRIVEN}: {launches} launches counted; the "
          f"profiler saw {named} device kernels in {2 * len(driven)} calls, all B6 (Python "
          f"numbers and device scalars)")

    cases = [(m, d, 0, dtype) for m, d in RMSNORM_SWEEP
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(m, d, off, torch.float32) for m, d, off in RMSNORM_STAGED]
    rows, max_err = [], 0
    for m, d, offset, dtype in cases:
        if offset:  # a view at an offset into a larger buffer
            buf = torch.randn((m * d + offset,), generator=gen, device=dev) * 2
            xd = buf[offset:].view(m, d)
            g = torch.randn((d,), generator=gen, device=dev) * 0.1 + 1.0
        elif (m, d) in inputs:
            x, g = inputs[(m, d)]
            xd = x.to(dtype).contiguous()
        else:
            xd = torch.randn((m, d), generator=gen, device=dev).to(dtype) * 2
            g = torch.randn((d,), generator=gen, device=dev) * 0.1 + 1.0
        gd = g.to(dtype)
        qp = B6.quantizer_pair(0.02, 128, dev)
        y = B6.quant_rmsnorm_kernel(xd, g, 0.02, 128, **kw)
        plan = B6.quant_rmsnorm.last_plan
        model = B6.quant_rmsnorm_model(xd, g, qp, plan, **kw)
        r = B6.quant_rmsnorm_plain(xd, g, qp, **kw)
        torch.cuda.synchronize()
        name = (f"({m}, {d}) {str(dtype).split('.')[-1]}"
                + (f" at offset {offset}" if offset else ""))
        check(torch.equal(y, model), f"B6 != its model at {name}: "
                                     f"{int((y != model).sum())} codes differ")
        diff = (y.to(torch.int32) - r.to(torch.int32)).abs()
        off = float((diff > 0).float().mean())
        max_err = max(max_err, int(diff.max()))
        check(int(diff.max()) <= 1 and off < 0.01,
              f"B6 != plain at {name}: max {int(diff.max())} code(s), {off:.4f} of "
              f"elements off")
        bms, by = rmsnorm_bound_ms(m, d, xd.element_size())

        def kern():
            return B6.quant_rmsnorm_kernel(xd, g, 0.02, 128, **kw)

        def floor():
            return B6.quant_rmsnorm_floor(xd, g)

        ms, floor_ms = [], []
        for _ in range(RMSNORM_ROUNDS):
            ms.append(time_ms(torch, kern, flush=flush))
            floor_ms.append(time_ms(torch, floor, flush=flush))
        row = {"M": m, "D": d, "dtype": str(dtype).split(".")[-1], "offset": offset,
               "codes_off": off,
               "plan": f"vec {plan.vec}, {plan.threads} threads a row, {plan.per_thread} "
                       f"slots, block {plan.block}"
                       + (f", staged ({plan.held} vectors held)" if plan.staged else ""),
               "ms": statistics.median(ms), "ms_rounds": ms,
               "floor_ms": statistics.median(floor_ms), "floor_ms_rounds": floor_ms,
               "kernel_us": rmsnorm_profile_us(torch, kern, flush, "quant_rmsnorm_"),
               "floor_kernel_us": rmsnorm_profile_us(torch, floor, flush, "empty_probe"),
               "plain_ms": time_ms(torch, lambda: B6.quant_rmsnorm_plain(xd, g, qp, **kw),
                                   reps=10, flush=flush),
               "rms_norm_ms": time_ms(torch, lambda: torch.nn.functional.rms_norm(
                   xd, (d,), gd, 1e-6), flush=flush),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        row["bound_share"] = bms / (1e-3 * row["kernel_us"])
        rows.append(row)
        print(f"[b6] {name}: bit-equal to its model, within one code of plain on {off:.5f} "
              f"of elements; {row['plan']}; kernel {row['ms']:.5f} ms ({min(ms):.5f}-"
              f"{max(ms):.5f} over {RMSNORM_ROUNDS} rounds), {row['kernel_us']:.3f} us by the "
              f"profiler ({100 * row['bound_share']:.1f}% of the bound); empty kernel on its "
              f"grid {row['floor_ms']:.5f} ms, {row['floor_kernel_us']:.3f} us; F.rms_norm "
              f"alone {row['rms_norm_ms']:.5f} ms; plain {row['plain_ms']:.5f} ms; bound "
              f"{bms:.5f} ms ({by})")
    rmsnorm_targets(rows)
    return rows, max_err, launches


def rmsnorm_host_us(torch, gen, rounds: int = 6, calls: int = 2000) -> float:
    """Host time of one ``norm_and_quantize`` call at (4, 960) f32 with
    Python-number quantizers, median us a call over ``rounds`` runs of
    ``calls`` calls: the card runs each kernel in a few us, faster than
    the host enqueues them, so a run's wall time is the host's. Taken
    before any profiler trace: traces earlier in a process raise it."""
    from repro_torch.kernels.ops import norm_and_quantize

    x = torch.randn((BATCH, 960), generator=gen, device="cuda")
    g = torch.randn((960,), generator=gen, device="cuda")

    def fn():
        norm_and_quantize(x, g, 0.02, 128, block_m=BATCH)

    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append(1e6 * (time.perf_counter() - t) / calls)
    host = statistics.median(times)
    print(f"[b6] wrapper host time a call (norm_and_quantize at ({BATCH}, 960) f32, Python-number "
          f"quantizers, median of {rounds} rounds of {calls}): {host:.3f} us")
    return host


def rmsnorm_targets(rows) -> None:
    """Print B6's targets, met or missed: profiler time at least 70% of the
    byte bound where the bound is at least 15 us; events faster than
    F.rms_norm alone where it is at least 2 us; events within 1 us of the
    empty kernel at (4, 960) and (256, 960)."""
    def say(what, sel, ok):
        hit = [r for r in rows if sel(r)]
        bad = [f"({r['M']}, {r['D']}) {r['dtype']}" for r in hit if not ok(r)]
        print(f"[b6-target] {what}: {'met' if not bad else 'missed at ' + ', '.join(bad)} "
              f"({len(hit) - len(bad)} of {len(hit)} shapes)")
    say("kernel time >= 70% of the byte bound where the bound >= 15 us",
        lambda r: r["bound_ms"] >= 0.015, lambda r: r["bound_share"] >= 0.7)
    say("events faster than F.rms_norm alone where the bound >= 2 us",
        lambda r: r["bound_ms"] >= 0.002, lambda r: r["ms"] < r["rms_norm_ms"])
    say("events within 1 us of the empty kernel at (4, 960) and (256, 960)",
        lambda r: (r["M"], r["D"]) in ((4, 960), (256, 960)),
        lambda r: r["ms"] - r["floor_ms"] <= 0.001)


# ---------------------------------------------------------------------------
# Phase 9: the 2:4 slice on smollm-360m
# ---------------------------------------------------------------------------
def phase_sparse_slice(torch, dense_calib, paged):
    import tempfile
    from dataclasses import replace

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.axe import PTQConfig
    from repro_torch.core.overflow import min_feasible_p_bits
    from repro_torch.core.sparsity import is_2to4
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.quant.pipeline import calibrate_and_quantize
    from repro_torch.quant.serve_packed import (
        export_quantized_artifact,
        load_flat_artifact,
        pack_decode_params,
        packed_params_from_artifact,
        packed_weight_bytes,
    )
    from repro_torch.quant.spec import DatapathSpec
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )

    greedy = SamplerConfig(temperature=0.0)
    # (a) 2:4 calibration of the float32 copy, phase 5's batches
    cfg = replace(get_config("smollm-360m"), param_dtype="float32", act_dtype="float32")
    sites = 7 * cfg.n_layers
    model = T.init_model(cfg, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model, cfg, calib, PTQConfig(sparsity="2:4"), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calib_counts = read_counts()
    check(calib_counts["gpfq_solve"] == sites and calib_counts["gpfq_solve_masked"] == sites,
          f"2:4 calibration launches {calib_counts}, expected {sites} masked gpfq_solve")
    check(calib_counts["w4a8_matmul"] == 0 and calib_counts["w4a8_sparse_matmul"] == 0,
          f"calibration launched a GEMM kernel: {calib_counts}")
    summary = qm.cert_summary()
    check(summary["ok"] and summary["n_certified"] == sites, f"certificates: {summary}")
    floors, fell = {}, 0
    for name, ql in qm.quantized_linears():
        check(ql.cert.sparsity == "2:4" and is_2to4(ql.q_int), f"{name} is not certified 2:4")
        floors[name] = min_feasible_p_bits(ql.cert)
        fell += floors[name] < dense_calib["floors"][name]
    print(f"[sparse-calib] smollm-360m full width in float32, GPFQ W4A8 P_I=16 T=128 "
          f"sparsity=2:4, {CALIB_BATCHES} x {CALIB_BATCH} x {CALIB_SEQ} tokens: "
          f"{calib_counts['gpfq_solve_masked']} masked gpfq_solve launches (= 7 x {cfg.n_layers}); "
          f"certified {summary['n_certified']} sites at sparsity=2:4, min headroom "
          f"{summary['min_headroom_bits']:.4f} bits at {summary['min_headroom_site']}; wall "
          f"{wall:.3f} s (dense, phase 5: {dense_calib['wall_s']:.3f} s)")
    print("[sparse-calib] min_feasible_p_bits per site, 2:4 / dense: " + ", ".join(
        f"{n.replace('layer', 'L')} {floors[n]}/{dense_calib['floors'][n]}" for n in floors))
    print(f"[sparse-calib] the register floor fell at {fell} of {sites} sites")

    # (b) the exported 2:4 artifact, saved, loaded and served through B4
    artifact, meta = export_quantized_artifact(qm)
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(artifact, os.path.join(tmp, "quantized"), meta)
        flat, meta2 = load_flat_artifact(os.path.join(tmp, "quantized"))
    served = packed_params_from_artifact(flat, model, cfg, meta=meta2)
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT,
                                      global_batch=BATCH, seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(served, cfg, greedy, device="cuda")
    engine.generate(prompts, MAX_NEW)  # warm-up
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    gen_s = time.perf_counter() - t0
    serve_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = sites * MAX_NEW
    check(serve_counts["w4a8_sparse_matmul"] == expected and serve_counts["w4a8_matmul"] == 0,
          f"serving the 2:4 artifact: launches {serve_counts}, expected {expected} B4 and 0 B1")
    ref_out = GenerationEngine(served, cfg, greedy, device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
    check((out == ref_out).all(), "kernel and reference backends disagree on the 2:4 artifact")
    check((out == engine.generate_host_loop(prompts, MAX_NEW)).all(),
          "the captured generate and the eager host loop disagree on the 2:4 artifact")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    step_ms = decode_step_ms(torch, served, prompts, out)
    fixed = {"gen_s": gen_s, "tok_s": BATCH * MAX_NEW / gen_s, "step_ms": step_ms,
             "peak_mib": peak / 2**20}
    print(f"[sparse-serve] artifact: {len(artifact)} leaves, {meta['datapath']}; served greedy "
          f"batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new (float32, static activation "
          f"quantizers): {serve_counts['w4a8_sparse_matmul']} B4 launches (= 7 x "
          f"{cfg.n_layers} x {MAX_NEW}) through the captured step, "
          f"{serve_counts['w4a8_matmul']} B1; tokens identical to the reference backend and "
          f"the eager host loop; {fixed['tok_s']:.1f} tok/s (wall {gen_s:.4f} s), eager "
          f"decode step {step_ms:.3f} ms (host clock), peak memory {fixed['peak_mib']:.1f} MiB; "
          f"dense artifact (phase 5): {dense_calib['serve']['tok_s']:.1f} tok/s, eager decode step "
          f"{dense_calib['serve']['step_ms']:.3f} ms, peak {dense_calib['serve']['peak_mib']:.1f}"
          f" MiB")
    del model, served, engine, qm
    torch.cuda.empty_cache()

    # (c) RTN 2:4 packing of the bf16 model, served through the paged
    # engine over phase 7's trace
    cfg = get_config("smollm-360m")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"), cfg,
                               DatapathSpec(sparsity="2:4"))
    eng = PagedEngine(model, cfg, PagedConfig(
        block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
        chunk_max=PAGED_CHUNK, attn_impl="auto"), greedy, device="cuda")
    specs, _ = trace_specs(cfg)
    warm_paged(eng, specs[0][1])  # captures the decode step
    steps0, admits0 = eng.decode_steps, eng.admits
    reset_peak(torch)
    reset_counts()
    res, wall_t, spent = serve_timed(torch, eng, [Request(uid=u, prompt=p, max_new=n)
                                                  for u, p, n in specs])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps, admits = eng.decode_steps - steps0, eng.admits - admits0
    forwards = steps + admits + eng.suffix_admits
    check(counts["w4a8_sparse_matmul"] == sites * forwards and counts["w4a8_matmul"] == 0,
          f"paged 2:4 trace: launches {counts} for {forwards} forwards")
    check(counts["paged_decode_attention"] == cfg.n_layers * steps,
          f"paged 2:4 trace: B2 launches {counts} for {steps} decode steps")
    for u, p, n in specs:
        check(res[u].size == p.size + n, f"2:4 trace: request {u} incomplete")
    pool = eng.pool_state
    check(pool.free_top == 0 and not pool.page_rc.any()
          and int(eng.cache["free_top"]) == 0 and not eng.cache["page_refcounts"].any(),
          "2:4 trace: pages not all back on the free list")
    n_new = sum(n for _, _, n in specs)
    dense_run = paged["runs"]["act"]
    trace = {"decode_steps": steps, "forwards": forwards,
             "launches": counts["w4a8_sparse_matmul"], "wall_s": wall_t,
             "tok_s": n_new / wall_t, "step_ms": 1e3 * spent["chunk"] / steps,
             "admit_ms": 1e3 * spent["admit"] / admits, "peak_mib": peak / 2**20}
    print(f"[sparse-paged] RTN 2:4 bf16 through PagedEngine, {TRACE_REQUESTS} requests, "
          f"decode steps replayed from one capture: "
          f"{counts['w4a8_sparse_matmul']} B4 launches = {sites} x {forwards} forwards, "
          f"{counts['w4a8_matmul']} B1; every page back on the free list; decode step "
          f"{trace['step_ms']:.3f} ms, admit {trace['admit_ms']:.3f} ms (host clock), "
          f"{trace['tok_s']:.1f} tok/s, wall {wall_t:.3f} s, peak memory "
          f"{trace['peak_mib']:.1f} MiB; dense (phase 7, float KV): decode step "
          f"{dense_run['step_ms']:.3f} ms, {dense_run['tok_s']:.1f} tok/s, peak "
          f"{dense_run['peak'] / 2**20:.1f} MiB")
    nbytes = {s: packed_weight_bytes(cfg, sparsity=s) for s in (None, "2:4")}
    print(f"[sparse-paged] packed_weight_bytes dense vs 2:4: codes "
          f"{nbytes[None]['packed_code_bytes']} vs {nbytes['2:4']['packed_code_bytes']} + meta "
          f"{nbytes['2:4']['meta_bytes']}; total {nbytes[None]['packed_bytes']} vs "
          f"{nbytes['2:4']['packed_bytes']} bytes")
    return {"calib_launches": calib_counts["gpfq_solve_masked"], "calib_wall_s": wall,
            "floors_fell": fell, "fixed": fixed, "serve_launches":
            serve_counts["w4a8_sparse_matmul"], "trace": trace, "bytes": nbytes}


# ---------------------------------------------------------------------------
# Phase 11: the MoE family (B1e, B4e; granite-moe-3b-a800m)
# ---------------------------------------------------------------------------
def expert_bound_ms(e: int, m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one B1e or B4e call: E problems' codes, packed weights
    (K/2 bytes a column, dense or 2:4) and f32 epilogue vectors read once,
    their bf16 outputs written once, against their int8 operations at the
    tensor-core peak."""
    nbytes = e * (m * k + k * n // 2 + 2 * 4 * n + 2 * m * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * e * m * n * k / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def moe_layer_sum(rows, m: int, key: str) -> float:
    """``key`` summed over the 3 expert sites of one granite MoE layer at
    M = m rows an expert (the timed E = 40 rows)."""
    by_shape = {(r["K"], r["N"]): r for r in rows if "ms" in r and r["M"] == m}
    return sum(by_shape[kn][key] for kn in MOE_LAYER_SITES)


def kernel_device_us(torch, fn, attempts: int = 4):
    """The device time of the one kernel ``fn`` launches, by the profiler
    on a complete trace (without the event pair's floor), us; None when
    ``attempts`` traces all lost the kernel's record."""
    for _ in range(attempts):
        prof, _, complete = traced(torch, fn)
        if complete:
            (kernel,) = traced_kernels(torch, prof.key_averages())
            return kernel.self_device_time_total / kernel.count
    return None


def expert_targets(rows, layers) -> None:
    """Print the decode tier's targets met or missed: B1e's layer at M = 4
    30-40 us and at least 1.5x faster than before it (2x at M = 1 and 4, or
    it missed), B4e within 1.15x B1e at decode, both no slower than one
    bf16 bmm at M = 80, and neither slower than before at any shape."""
    def verdict(ok):
        return "met" if ok else "MISSED"

    for m in (1, 4):
        b1e, old = 1e3 * layers[m]["ms"], PREVIOUS_EXPERT_LAYER_US[m][0]
        print(f"[expert-target] M={m} B1e layer {b1e:.2f} us against {old:.2f} before: "
              f"{old / b1e:.2f}x faster; 2x: {verdict(old / b1e >= 2.0)}; 1.5x: "
              f"{verdict(old / b1e >= 1.5)}"
              + (f"; 30-40 us: {verdict(b1e <= 40.0)}" if m == 4 else "")
              + f" (one copy of each site's packed stack, summed: "
                f"{1e3 * layers[m]['copy_ms']:.2f} us"
              + (f"; B1e after a read flush, a clean cold L2: "
                 f"{1e3 * layers[m]['clean_ms']:.2f} us" if "clean_ms" in layers[m] else "")
              + ")")
        ratio = layers[m]["b4e_ms"] / layers[m]["ms"]
        print(f"[expert-target] M={m} B4e layer {1e3 * layers[m]['b4e_ms']:.2f} us = "
              f"{ratio:.3f}x B1e; at most 1.15x: {verdict(ratio <= 1.15)}")
    for m in (64, 80):
        bmm = layers[m]["library_ms"]
        print(f"[expert-target] M={m} layer: B1e {1e3 * layers[m]['ms']:.2f} us, B4e "
              f"{1e3 * layers[m]['b4e_ms']:.2f} us, bf16 bmm {1e3 * bmm:.2f} us; no slower "
              f"than bmm: B1e {verdict(layers[m]['ms'] <= bmm)}, B4e "
              f"{verdict(layers[m]['b4e_ms'] <= bmm)}")
    timed = {(r["M"], r["K"], r["N"]): r for r in rows if "ms" in r}
    slower = [(*shape, who) for shape, old in PREVIOUS_EXPERT_US.items() if shape in timed
              for who, key, i in (("B1e", "ms", 0), ("B4e", "b4e_ms", 1))
              if 1e3 * timed[shape][key] > old[i]]
    print(f"[expert-target] no shape slower than before the decode tier: "
          f"{verdict(not slower)}{'' if not slower else f' (slower: {slower})'}")


def phase_expert_kernels(torch):
    """B1e and B4e against their plain versions (E calls of B1's and B4's)
    over E x M x granite's expert (K, N) x uint8/int8 codes, each with one
    expert's input all zero, and a ragged case; per (M, K, N) at E = 40 the
    plan and times of both kernels (events, and at M = 4 the profiler's
    device time), the plain versions, E ``torch._int_mm`` calls on the unpacked
    codes, bf16 ``torch.bmm`` on the dequantized stack and one copy of the
    packed stack; B1 at granite's dense sites."""
    from repro_torch.core.sparsity import mask_2to4
    from repro_torch.kernels import w4a8_mm as W

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [(e, m, k, n) for e in MOE_KERNEL_E for m in MOE_KERNEL_M
             for k, n in MOE_EXPERT_KN] + [(5, 3, 192, 60)]
    rows, err = [], {"b1e": 0.0, "b4e": 0.0}
    for e, m, k, n in cases:
        q = torch.randint(-8, 8, (e, k, n), generator=gen, device=dev).to(torch.int8)
        qs = q * mask_2to4(q)
        wp, (sp, meta) = W.pack_int4(q), W.compress_2to4(qs)
        col, scol = q.sum(1).to(torch.int32), qs.sum(1).to(torch.int32)
        scale = torch.rand((e, n), generator=gen, device=dev) * 0.05 + 1e-3
        act_scale = torch.rand(e, generator=gen, device=dev) * 0.05 + 0.01
        row = {"E": e, "M": m, "K": k, "N": n}
        for act in ("uint8", "int8"):
            lo, hi = (0, 256) if act == "uint8" else (-128, 128)
            x = torch.randint(lo, hi, (e, m, k), generator=gen, device=dev).to(getattr(torch,
                                                                                      act))
            x[e // 2] = 0  # an expert that got no token
            zp = (torch.randint(0, 256, (e,), generator=gen, device=dev).float()
                  if act == "uint8" else torch.zeros(e, device=dev))
            for name, fn, ws, cs in (("b1e", W.w4a8_expert_matmul, (wp,), col),
                                     ("b4e", W.w4a8_sparse_expert_matmul, (sp, meta), scol)):
                y = fn(x, *ws, scale, cs, act_scale, zp, out_dtype=torch.bfloat16)
                r = fn(x, *ws, scale, cs, act_scale, zp, out_dtype=torch.bfloat16,
                       reference=True)
                torch.cuda.synchronize()
                err[name] = max(err[name], (y.float() - r.float()).abs().max().item())
                check(torch.equal(y, r), f"{name} != plain at E={e} M={m} K={k} N={n} {act}")
            if act != "uint8" or e != max(MOE_KERNEL_E) or (k, n) not in MOE_EXPERT_KN:
                continue
            sw, corr = W._expert_epilogue(scale, col, act_scale, zp, e, n)
            _, scorr = W._expert_epilogue(scale, scol, act_scale, zp, e, n)
            row["ms"] = time_ms(torch, lambda: W._launch(
                "w4a8_expert_matmul", x, (wp,), sw, corr, torch.bfloat16, 2), flush=flush)
            plan = W.w4a8_expert_plan(m, n, k, e, True, W._sm_count(0))
            row.update(plan_fields(plan))
            row["tier"] = plan.tier
            if plan.tier == "decode":
                row["plan"] = (f"decode tier: grid {plan.grid} ({plan.blocks} blocks of 128 "
                               f"columns), {plan.grid[2]} K chunk(s) of {plan.ck} rows, a ring "
                               f"of {plan.ring} stages, {plan.vec}-byte loads")
            else:
                row["plan"] = "tile tier: " + row["plan"]
            row["b4e_ms"] = time_ms(torch, lambda: W._launch(
                "w4a8_sparse_expert_matmul", x, (sp, meta), sw, scorr, torch.bfloat16, 4),
                flush=flush)
            row["plain_ms"] = time_ms(torch, lambda: W.w4a8_expert_matmul_plain(
                x, wp, sw, corr, torch.bfloat16), flush=flush, reps=5)
            row["b4e_plain_ms"] = time_ms(torch, lambda: W.w4a8_sparse_expert_matmul_plain(
                x, sp, meta, sw, scorr, torch.bfloat16), flush=flush, reps=5)
            # yardsticks: E cuBLASLt int8 GEMMs on the unpacked codes (rows
            # padded to 32, codes shifted by -128), and one bf16 bmm on the
            # dequantized stack (the dequant backend's product)
            mp = max(m, 32)
            xs = torch.zeros((e, mp, k), dtype=torch.int8, device=dev)
            xs[:, :m] = (x.to(torch.int16) - 128).to(torch.int8)
            w8 = W.unpack_int4(wp).contiguous()
            check(torch.equal((torch._int_mm(xs[0], w8[0])[:m] + 128 * col[0]).double(),
                              x[0].double() @ q[0].double()),
                  "the _int_mm yardstick disagrees with the exact product")
            row["int_mm_ms"] = time_ms(torch, lambda: [torch._int_mm(xs[i], w8[i])
                                                        for i in range(e)], flush=flush)
            xb = x.to(torch.bfloat16)
            wb = (w8.to(torch.bfloat16) * scale[:, None, :].to(torch.bfloat16)).contiguous()
            row["library_ms"] = time_ms(torch, lambda: torch.bmm(xb, wb), flush=flush)
            copy = torch.empty_like(wp)
            row["copy_ms"] = time_ms(torch, lambda: copy.copy_(wp), flush=flush)
            # at decode, B1e again after a flush by a read: no dirty line of
            # the flush to write back during the launch
            row["clean_ms"] = time_ms(torch, lambda: W._launch(
                "w4a8_expert_matmul", x, (wp,), sw, corr, torch.bfloat16, 2), flush=flush,
                clean=True) if m == BATCH else None
            # the profiler's device time at decode only: every trace in a
            # process makes a later one likelier to lose device records
            row["device_us"] = [kernel_device_us(torch, lambda: W._launch(
                entry, x, weights, sw, cr, torch.bfloat16, rpk)) for entry, weights, cr, rpk in (
                    ("w4a8_expert_matmul", (wp,), corr, 2),
                    ("w4a8_sparse_expert_matmul", (sp, meta), scorr, 4))] if m == BATCH else None
            row["bound_ms"], row["bound_by"] = expert_bound_ms(e, m, k, n)
            old = PREVIOUS_EXPERT_US.get((m, k, n))
            print(f"[expert] E={e} M={m:3d} K={k:5d} N={n:5d} B1e {row['ms']:.5f} ms  B4e "
                  f"{row['b4e_ms']:.5f} ms  (before the decode tier, 5bb4d0c: "
                  f"{'not measured' if old is None else f'{old[0]:.2f} / {old[1]:.2f} us'})  "
                  f"plain {row['plain_ms']:.5f} / "
                  f"{row['b4e_plain_ms']:.5f} ms  {e} x _int_mm {row['int_mm_ms']:.5f} ms  "
                  f"bf16 bmm {row['library_ms']:.5f} ms  copy of the stack "
                  f"{row['copy_ms']:.5f} ms  bound {row['bound_ms']:.5f} ms "
                  f"({row['bound_by']})  "
                  + ("" if row["clean_ms"] is None else
                     f"B1e after a read flush (clean cold L2) {row['clean_ms']:.5f} ms  ")
                  + ("" if row["device_us"] is None else "profiler device time B1e / B4e "
                     + " / ".join("not measured" if v is None else f"{v:.2f} us"
                                  for v in row["device_us"]) + "  ") + row["plan"])
        rows.append(row)
    # B4e on a hand-made meta of every position pair, equal positions in
    # every third row (the reference sums them), in both tiers
    for m in (4, 17, 64, 80):
        k, n = MOE_EXPERT_KN[0]
        e = max(MOE_KERNEL_E)
        sp = torch.randint(-128, 128, (e, k // 4, n), generator=gen, device=dev).to(torch.int8)
        meta = torch.randint(0, 16, (e, k // 4, n), generator=gen, device=dev)
        meta[:, ::3] = torch.randint(0, 4, meta[:, ::3].shape, generator=gen, device=dev) * 5
        meta = meta.to(torch.int8)
        x = torch.randint(0, 256, (e, m, k), generator=gen, device=dev).to(torch.uint8)
        scale = torch.rand((e, n), generator=gen, device=dev) * 0.05 + 1e-3
        scol = W.unpack_sparse24(sp, meta).sum(1).to(torch.int32)
        act_scale = torch.rand(e, generator=gen, device=dev) * 0.05 + 0.01
        zp = torch.randint(0, 256, (e,), generator=gen, device=dev).float()
        args = (x, sp, meta, scale, scol, act_scale, zp)
        y = W.w4a8_sparse_expert_matmul(*args, out_dtype=torch.bfloat16)
        r = W.w4a8_sparse_expert_matmul(*args, out_dtype=torch.bfloat16, reference=True)
        torch.cuda.synchronize()
        err["b4e"] = max(err["b4e"], (y.float() - r.float()).abs().max().item())
        check(torch.equal(y, r), f"b4e != plain on a hand-made meta at E={e} M={m} K={k} N={n}")
    print(f"[expert] B1e and B4e bit-equal to their plain versions (E calls of B1 / B4) on "
          f"{len(cases)} shapes x uint8/int8 codes, one all-zero expert each; B4e also on a "
          f"hand-made meta of every position pair (equal ones summed) at M = 4, 17, 64, 80")
    layers = {}
    for m in MOE_KERNEL_M:
        sums = {key: moe_layer_sum(rows, m, key)
                for key in ("ms", "b4e_ms", "plain_ms", "int_mm_ms", "library_ms", "bound_ms",
                            "copy_ms") + (("clean_ms",) if m == BATCH else ())}
        layers[m] = sums
        old = PREVIOUS_EXPERT_LAYER_US.get(m)
        print(f"[expert] M={m:3d} one granite MoE layer's 3 expert sites (E=40): B1e "
              f"{sums['ms']:.5f} ms  B4e {sums['b4e_ms']:.5f} ms  (before the decode tier: "
              f"{'not measured' if old is None else f'{old[0]:.2f} / {old[1]:.2f} us'})  "
              f"plain {sums['plain_ms']:.5f} ms"
              f"  40 x _int_mm {sums['int_mm_ms']:.5f} ms  bf16 bmm {sums['library_ms']:.5f} ms"
              f"  copies of the stacks {sums['copy_ms']:.5f} ms  bound {sums['bound_ms']:.5f} ms")
    expert_targets(rows, layers)
    # B1 at granite's dense (attention) sites
    for m in (BATCH, BATCH * PROMPT):
        for k, n in GRANITE_DENSE_KN:
            q = torch.randint(-8, 8, (k, n), generator=gen, device=dev)
            x = torch.randint(0, 256, (m, k), generator=gen, device=dev).to(torch.uint8)
            wp, col = W.pack_int4(q), q.sum(0).to(torch.int32)
            scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 1e-3
            args = (x, wp, scale, col, 0.0213, 131.0)
            y = W.w4a8_decode_matmul(*args, out_dtype=torch.bfloat16)
            r = W.w4a8_decode_matmul(*args, out_dtype=torch.bfloat16, reference=True)
            check(torch.equal(y, r), f"B1 != plain at granite's M={m} K={k} N={n}")
            sw = scale * 0.0213
            corr = col.float() * 131.0
            ms = time_ms(torch, lambda: W.w4a8_matmul_kernel(x, wp, sw, corr, torch.bfloat16),
                         flush=flush)
            b, by = bound_ms(m, k, n)
            print(f"[expert] B1 at granite's dense site M={m:3d} K={k} N={n}: bit-equal, "
                  f"{ms:.5f} ms, bound {b:.5f} ms ({by}), "
                  f"{plan_fields(W.w4a8_matmul.last_plan)['plan']}")
    return rows, err


class FixedRecorder:
    """Records the logits a fresh ``GenerationEngine`` samples from, by
    column: entered before the engine's first generate, it adds to the
    captured step a device copy of the logits into a static buffer at the
    step's column (the prefill's first token is copied the same way,
    eagerly), read once after the generate."""

    def __init__(self, engine, batch: int, max_len: int):
        import torch

        self.engine = engine
        vp = engine.model.cfg.vocab_padded
        self.buf = torch.zeros((max_len, batch, vp), dtype=torch.float32, device=engine.device)

    def __enter__(self):
        from repro_torch.serving import engine as EN

        check(not self.engine._buckets, "FixedRecorder needs an engine with no bucket yet")
        self._orig = EN.sample_rows

        def spy(logits, temperature, seed, rows, cols):
            self.buf.index_copy_(0, cols[:1].long(), logits.float()[None])
            return self._orig(logits, temperature, seed, rows, cols)

        EN.sample_rows = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine as EN

        EN.sample_rows = self._orig

    def logits(self, row: int, start: int, n: int):
        host = self.buf[start:start + n, row].cpu()
        return [host[t] for t in range(n)]


def replay_profile(torch, program, restart, want: dict, tag: str, what: str) -> dict:
    """One replay of a captured decode step (``what``) under the profiler,
    on a complete trace (a device record for every node of the graph): the
    device's busy share of the replay's device span, and each ``want``
    kernel's (counter -> launches a replay) device time, share and count by
    kernel name, each held to the launch counters' rise. ``restart``
    (outside the trace) sets the bucket back to its first decode position
    before each try. None, with a line under ``[tag]`` saying so, when none
    of MOE_PROFILE_ATTEMPTS traces is complete."""
    from repro_torch.serving.graphs import COUNTERS
    from repro_torch.trace import replay_spans_ns

    def counted_replay():
        reset_counts()
        program.run(1)
        torch.cuda.synchronize()
        return read_counts()

    for _ in range(MOE_PROFILE_ATTEMPTS):
        restart()
        prof, counts, complete = traced(torch, counted_replay, program.device_ops)
        if complete:
            break
    else:  # the run goes on: the kernels are held to the counters elsewhere
        print(f"[{tag}] not measured: the profiler lost device kernel records in "
              f"{MOE_PROFILE_ATTEMPTS} traces of one replay")
        return None
    kernels = traced_kernels(torch, prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    (span,) = replay_spans_ns(prof.profiler.kineto_results.events())
    span /= 1e6
    # the profiler's keys are demangled (template arguments as written:
    # CP, code signedness, Sparse[, Experts]); graph nodes' names, which
    # COUNTERS reads, are mangled: either form counts
    mangled = {fn.__name__: pat for fn, attr, pat in COUNTERS if attr == "launches" and pat}
    demangled = {
        "w4a8_expert_matmul": re.compile(r"w4a8_expert_decode_kernel<\s*\d+\s*,\s*\w+\s*,\s*false\b"
                                         r"|w4a8_kernel<\s*\d+\s*,\s*\w+\s*,\s*false\s*,\s*true\b"),
        "w4a8_matmul": re.compile(r"w4a8_kernel<\s*\d+\s*,\s*\w+\s*,\s*false\s*,\s*false\b")}
    out = {"busy_ms": busy, "span_ms": span, "device_ops": program.device_ops}
    for name, n_want in want.items():
        mine = [e for e in kernels if mangled[name].search(e.key) or demangled[name].search(e.key)]
        seen = sum(e.count for e in mine)
        if not seen == counts[name] == n_want:
            print(f"[{tag}] the replay's kernels by name: " + "; ".join(
                f"{e.key[:160]} x{e.count}" for e in kernels))
        check(seen == counts[name] == n_want,
              f"a profiled {what} replay: {seen} {name} kernels by name, the counter "
              f"{counts[name]}, expected {n_want}")
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        out[name] = {"ms": ms, "launches": seen, "share_of_busy": ms / busy}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    label = {"w4a8_expert_matmul": "B1e", "w4a8_matmul": "B1"}
    print(f"[{tag}] one replayed {what} decode step, a complete trace "
          f"({program.device_ops} device operations): device busy {busy:.3f} ms = "
          f"{100 * busy / span:.1f}% of its {span:.3f} ms device span; " + ", ".join(
              f"{label[name]} {out[name]['ms']:.3f} ms in {out[name]['launches']} launches "
              f"({100 * out[name]['share_of_busy']:.1f}% of busy)" for name in want))
    print(f"[{tag}] the replay's 8 largest kernels by device time: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    return out


def phase_moe_slice(torch):
    """granite-moe-3b-a800m at full width: (a) fixed slot, (b) paged FIFO,
    (c) calibration of a 4-layer cut, (d) 2:4 serving of the cut."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.axe import PTQConfig
    from repro_torch.core.overflow import min_feasible_p_bits
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.quant.pipeline import calibrate_and_quantize
    from repro_torch.quant.serve_packed import (
        export_quantized_artifact,
        load_flat_artifact,
        pack_decode_params,
        packed_params_from_artifact,
        packed_weight_bytes,
    )
    from repro_torch.quant.spec import DatapathSpec
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )
    from repro_torch.serving.graphs import COUNTERS

    t_phase = time.perf_counter()
    greedy = SamplerConfig(temperature=0.0)
    cfg = get_config(GRANITE)
    L, E = cfg.n_layers, cfg.moe.n_experts
    per_forward = {"w4a8_matmul": 4 * L, "w4a8_expert_matmul": 3 * L}
    t0 = time.perf_counter()
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]

    # (a) the fixed-slot engine: one capture, then generates of replays
    engine = GenerationEngine(model, cfg, greedy, device="cuda")
    t0 = time.perf_counter()
    engine.generate(prompts, MAX_NEW)  # builds the bucket and captures its step
    first_s = time.perf_counter() - t0
    (bucket,) = engine._buckets.values()
    program = bucket.program
    check(program.graph is not None and engine.gen_traces == 1,
          "the first generate did not capture the MoE step")
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for counter, n in per_forward.items():
        check(counts[counter] == n * MAX_NEW,
              f"{counter}: {counts[counter]} launches in a generate, expected {n * MAX_NEW}")
    check(counts["w4a8_sparse_matmul"] == counts["w4a8_sparse_expert_matmul"] == 0,
          f"dense serving launched a 2:4 kernel: {counts}")
    rise = {getattr(fn, "__name__", "?"): r for (fn, _, _), r in zip(COUNTERS, program.rise)}
    check(rise["w4a8_expert_matmul"] == 3 * L and rise["w4a8_matmul"] == 4 * L,
          f"a replay adds {rise}, expected B1e {3 * L} and B1 {4 * L}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    host = engine.generate_host_loop(prompts, MAX_NEW)
    eager_toks, eager_logits = fixed_slot_run(torch, model, prompts, MAX_NEW)
    check((eager_toks == host[:, PROMPT:]).all(), "the recorded eager run differs from the "
                                                  "host loop")
    rec_engine = GenerationEngine(model, cfg, greedy, device="cuda")
    with FixedRecorder(rec_engine, BATCH, PROMPT + MAX_NEW) as rec:
        rec_out = rec_engine.generate(prompts, MAX_NEW)
    check((rec_out == out).all(), "two captures of the MoE step disagree")
    cmp_a = tie_limited([(out[b, PROMPT:], host[b, PROMPT:], rec.logits(b, PROMPT, MAX_NEW),
                          [eager_logits[t][b] for t in range(MAX_NEW)]) for b in range(BATCH)],
                        cfg.vocab)
    del rec_engine, rec
    gen_t = in_turns(torch, {"graph": lambda: engine.generate(prompts, MAX_NEW),
                             "host_loop": lambda: engine.generate_host_loop(prompts, MAX_NEW)},
                     runs=4)
    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        _, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        engine._start(bucket, tokens)
        step_t = in_turns(torch, {"eager": lambda: T.decode_step(model, step_tok, caches,
                                                                  PROMPT),
                                  "replay": lambda: program.run(1)}, runs=6)
        profile = replay_profile(torch, program, lambda: engine._start(bucket, tokens),
                                 {"w4a8_expert_matmul": 3 * L, "w4a8_matmul": 4 * L},
                                 "moe-profile", "granite")
    nbytes = packed_weight_bytes(cfg)
    fixed = {"wall_s": wall, "tok_s": BATCH * MAX_NEW / wall, "gen": gen_t, "step": step_t,
             "peak_mib": peak / 2**20, "capture_ms": 1e3 * program.capture_s,
             "device_ops": program.device_ops, "cmp": cmp_a, "counts": counts,
             "replay_profile": profile}
    print(f"[moe] {GRANITE} full width ({L} layers, d_model {cfg.d_model}, {E} experts "
          f"top-{cfg.moe.top_k}, bf16, seeded random init) RTN-packed in {init_s:.3f} s: "
          f"packed_weight_bytes {nbytes['packed_bytes']} ({nbytes['packed_code_bytes']} code "
          f"bytes; bf16 {nbytes['bf16_bytes']})")
    print(f"[moe] (a) fixed slot, batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new: launches "
          f"{ {k: counts[k] for k in per_forward} } = a forward's {per_forward} x {MAX_NEW}; "
          f"one capture ({1e3 * program.capture_s:.3f} ms, {program.device_ops} device "
          f"operations; first generate {first_s:.3f} s); {cmp_a['agree']} of {cmp_a['total']} "
          f"tokens agree with the eager host loop (partings {cmp_a['partings']}, tie band "
          f"{cmp_a['band']:.4f})")
    print(f"[moe] (a) generate wall {wall:.4f} s = {fixed['tok_s']:.1f} tok/s; in turns: "
          f"captured {fmt_spread(gen_t['graph'])}, host loop {fmt_spread(gen_t['host_loop'])}; "
          f"decode step replay {fmt_spread(step_t['replay'])}, eager "
          f"{fmt_spread(step_t['eager'])}; peak memory {peak / 2**20:.1f} MiB")

    # (b) the paged FIFO loop over phase 7's trace, float then int8 KV
    def paged_engine(kv="act"):
        return PagedEngine(model, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, attn_impl="auto", kv_dtype=kv), greedy, device="cuda",
            **({"assert_bounds": True} if kv == "int8" else {}))

    specs, _ = trace_specs(cfg)
    warm = specs[0][1]
    # the shared prompts, each prefilled alone as the paged engine admits
    # it: a dispatch group shares expert capacity, so the fixed slot's
    # batched prefill routes otherwise
    alone = [fixed_slot_run(torch, model, prompts[b:b + 1], MAX_NEW) for b in range(BATCH)]
    shared = [(300 + b, prompts[b], MAX_NEW) for b in range(BATCH)]
    paged = {}
    for kv in ("act", "int8"):
        eng = paged_engine(kv)
        warm_paged(eng, warm)
        run = driven(torch, cfg, eng, [Request(uid=u, prompt=p, max_new=n)
                                       for u, p, n in specs], kv, per_forward)
        if kv == "int8":
            spec = eng.attn_spec
            qk, pv = run["watermarks"]
            check(qk <= 2 ** (spec.p_qk - 1) - 1 and pv <= 2 ** (spec.p_pv - 1) - 1,
                  f"B3 watermarks {qk}, {pv} against {spec.describe()}")
        res, rows = recorded(paged_engine(kv), [Request(uid=u, prompt=p, max_new=n)
                                                for u, p, n in shared], warm)
        cmp = tie_limited([(res[u][PROMPT:], alone[b][0][0], [rows[(u, t)] for t in
                                                              range(MAX_NEW)],
                            [alone[b][1][t][0] for t in range(MAX_NEW)])
                           for b, (u, _, _) in enumerate(shared)], cfg.vocab)
        run["cmp"] = cmp
        paged[kv] = run
        print(f"[moe] (b) paged FIFO, {kv} KV, {TRACE_REQUESTS} requests: launches "
              f"{run['counts']} ({run['ran']}), every page back on the free list; decode step "
              f"{run['step_ms']:.3f} ms, {run['admit_ms_per_request']:.3f} ms of admits a "
              f"request, {run['tok_s']:.1f} tok/s, wall {run['wall']:.3f} s, peak "
              f"{run['peak_mib']:.1f} MiB; the {BATCH} shared prompts: {cmp['agree']} of "
              f"{cmp['total']} tokens agree with the fixed slot run alone (partings "
              f"{cmp['partings']}, tie band {cmp['band']:.4f})"
              + (f"; B3 watermarks {run['watermarks']}" if kv == "int8" else ""))
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()

    # (c) calibration of a float32 cut to MOE_CALIB_LAYERS layers at full width
    cfg_c = replace(cfg, n_layers=MOE_CALIB_LAYERS, param_dtype="float32",
                    act_dtype="float32")
    model_c = T.init_model(cfg_c, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model_c, cfg_c, calib, PTQConfig(), device="cuda")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    ccounts = read_counts()
    solves = (4 + 3 * E) * MOE_CALIB_LAYERS
    check(ccounts["gpfq_solve"] == solves, f"{ccounts['gpfq_solve']} B5 launches calibrating, "
                                           f"expected {solves}")
    summary = qm.cert_summary()
    check(summary["ok"] and summary["n_certified"] == 7 * MOE_CALIB_LAYERS,
          f"certificates: {summary}")
    floors, experts_certified = {}, 0
    for name, ql in qm.quantized_linears():
        if ql.stacked:
            check(len(ql.cert.reports) == E and all(r.ok for r in ql.cert.reports),
                  f"{name}: not every expert certified")
            experts_certified += E
        floors[name] = min_feasible_p_bits(ql.cert)
    artifact, meta = export_quantized_artifact(qm)
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(artifact, os.path.join(tmp, "quantized"), meta)
        flat, meta2 = load_flat_artifact(os.path.join(tmp, "quantized"))
    served = packed_params_from_artifact(flat, model_c, cfg_c, meta=meta2)

    def serve_cut(m, expect):
        eng = GenerationEngine(m, cfg_c, greedy, device="cuda")
        eng.generate(prompts, MAX_NEW)  # captures
        reset_counts()
        t = time.perf_counter()
        o = eng.generate(prompts, MAX_NEW)
        s = time.perf_counter() - t
        c = read_counts()
        for counter, n in expect.items():
            check(c[counter] == n * MOE_CALIB_LAYERS * MAX_NEW,
                  f"{counter}: {c[counter]} launches serving the cut, expected "
                  f"{n * MOE_CALIB_LAYERS * MAX_NEW}")
        ref = GenerationEngine(m, cfg_c, greedy, device="cuda",
                               backend="reference").generate(prompts, MAX_NEW)
        check((o == ref).all(), "kernel and reference backends disagree on the cut")
        check((o == eng.generate_host_loop(prompts, MAX_NEW)).all(),
              "the captured generate and the eager host loop disagree on the cut")
        return c, s

    serve_c, serve_c_s = serve_cut(served, {"w4a8_matmul": 4, "w4a8_expert_matmul": 3,
                                            "w4a8_sparse_matmul": 0,
                                            "w4a8_sparse_expert_matmul": 0})
    print(f"[moe] (c) AXE-GPFQ calibration (default PTQConfig) of a float32 cut to "
          f"{MOE_CALIB_LAYERS} of {L} layers at full width, {CALIB_BATCHES} x {CALIB_BATCH} x "
          f"{CALIB_SEQ} tokens: wall {calib_s:.3f} s; B5 launches {ccounts['gpfq_solve']} = "
          f"(4 + 3 x {E}) x {MOE_CALIB_LAYERS}; {summary['n_certified']} sites certified, "
          f"{experts_certified} expert slices each certified on its own, min headroom "
          f"{summary['min_headroom_bits']:.4f} bits at {summary['min_headroom_site']}")
    print("[moe] (c) min_feasible_p_bits per site: " + ", ".join(
        f"{n.replace('layer', 'L')} {p}" for n, p in floors.items()))
    print(f"[moe] (c) the artifact ({len(artifact)} leaves, {meta['datapath']}) served greedy "
          f"batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new through the captured step: "
          f"{ {k: v for k, v in serve_c.items() if v} }; tokens identical to the reference "
          f"backend and the eager host loop; {BATCH * MAX_NEW / serve_c_s:.1f} tok/s")

    # (d) the same cut RTN-packed at 2:4, served through B4e
    packed24 = pack_decode_params(model_c, cfg_c, DatapathSpec(sparsity="2:4"))
    serve_d, serve_d_s = serve_cut(packed24, {"w4a8_sparse_matmul": 4,
                                              "w4a8_sparse_expert_matmul": 3,
                                              "w4a8_matmul": 0, "w4a8_expert_matmul": 0})
    print(f"[moe] (d) the cut RTN-packed at sparsity=2:4: "
          f"{ {k: v for k, v in serve_d.items() if v} } in a generate (B4e 3 a layer a "
          f"forward, 0 B1e); tokens identical to the reference backend and the eager host "
          f"loop; {BATCH * MAX_NEW / serve_d_s:.1f} tok/s")
    print(f"[moe] phase 11 wall {time.perf_counter() - t_phase:.3f} s")
    return {"fixed": fixed, "paged": paged, "calib_s": calib_s, "floors": floors,
            "b1e_launches": counts["w4a8_expert_matmul"],
            "b4e_launches": serve_d["w4a8_sparse_expert_matmul"]}


# ---------------------------------------------------------------------------
# Phase 12: the mixed-precision search slice on smollm-360m
# ---------------------------------------------------------------------------
#: phase 12: the uniform baseline register the search tightens (the
#: reference launcher's default), and the code-changing moves of (c)
SEARCH_P_BITS, SEARCH_SPARSIFY, SEARCH_PROMOTE = 20, 2, 1


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured; returns (result,
    the captured lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def search_args(out: str, *extra) -> list:
    """The search launcher's arguments: the f32 copy of smollm-360m, phase
    5's batches, P_I = 20, T = 128."""
    return ["--arch", "smollm-360m", "--float32", "--p-bits", str(SEARCH_P_BITS), "--tile",
            "128", "--calib-batches", str(CALIB_BATCHES), "--calib-batch-size",
            str(CALIB_BATCH), "--seq", str(CALIB_SEQ), "--eval-batches", str(EVAL_BATCHES),
            "--device", "cuda", "--out", out, *extra]


def install_spy():
    """Counts the paged engine's install quantizers (dynamic per-page max
    and static stamp) until the returned restore is called."""
    from repro_torch.serving import paged_engine as PE

    calls = {"dynamic": 0, "static": 0}
    orig = PE.quantize_kv_pages, PE.quantize_kv_pages_static

    def dynamic(*a, **kw):
        calls["dynamic"] += 1
        return orig[0](*a, **kw)

    def static(*a, **kw):
        calls["static"] += 1
        return orig[1](*a, **kw)

    PE.quantize_kv_pages, PE.quantize_kv_pages_static = dynamic, static

    def restore():
        PE.quantize_kv_pages, PE.quantize_kv_pages_static = orig

    return calls, restore


def partings(specs, a, rec_a, b, rec_b, vocab) -> dict:
    """How far pairs of greedy streams agree before they part, and at each
    parting the top-1/top-2 gap of both runs' logits; no gate (the streams
    are tie-limited: static and dynamic pages quantize differently)."""
    import torch

    agree = total = 0
    parts = []
    for u, p, n in specs:
        x, y = a[u][p.size:], b[u][p.size:]
        first = next((t for t in range(n) if x[t] != y[t]), None)
        agree += n if first is None else first
        total += n
        if first is not None:
            gaps = [float((lambda v: v[0] - v[1])(torch.topk(r[(u, first)][:vocab], 2).values))
                    for r in (rec_a, rec_b)]
            parts.append({"uid": u, "step": first, "gap_static": gaps[0],
                          "gap_dynamic": gaps[1]})
    return {"agree": agree, "total": total, "partings": parts}


def phase_search_slice(torch, smi: str):
    import tempfile

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.axe import PTQConfig
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.launch import search as S
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.quant.observe import MixedPrecisionPlan
    from repro_torch.quant.pipeline import calibrate_and_quantize
    from repro_torch.quant.serve_packed import load_flat_artifact, packed_params_from_artifact
    from repro_torch.serving import GenerationEngine, PagedConfig, PagedEngine, Request
    from repro_torch.serving import SamplerConfig

    t_phase = time.perf_counter()
    cfg = S.f32_config(get_config("smollm-360m"))
    sites = 7 * cfg.n_layers
    greedy = SamplerConfig(temperature=0.0)
    tmp = tempfile.mkdtemp(prefix="search_", dir=os.environ.get("TMPDIR"))
    out_a, out_c = os.path.join(tmp, "a"), os.path.join(tmp, "c")

    # (a) calibrate -> observe -> search -> export, through the launcher
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep, lines = quiet(S.main, search_args(out_a, "--kv-static"))
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    counts_a = read_counts()
    uni, srch = rep["uniform"], rep["searched"]
    check(counts_a["gpfq_solve"] == sites and counts_a["gpfq_solve_masked"] == 0,
          f"search: {counts_a['gpfq_solve']} B5 solves, expected {sites}")
    for name, cert in (("uniform", uni["cert"]), ("searched", srch["cert"])):
        check(cert["ok"] and cert["n_certified"] == sites, f"{name} certificates {cert}")
    check(srch["ppl"] == uni["ppl"] and math.isfinite(uni["ppl"]),
          f"searched ppl {srch['ppl']!r} != uniform {uni['ppl']!r} (a P_I-only plan)")
    check(rep["savings_rate"] >= 1 and srch["kv_static"], f"search report {rep}")
    plan = MixedPrecisionPlan.load(os.path.join(out_a, "plan.json"))
    # the default budget is the floor: each planned site sits at its floor
    floors = {k: spec.p_inner for k, spec in plan.sites.items()}
    obs = rep["observe"]
    print(f"[search] [{smi}] (a) smollm-360m full width in float32, {CALIB_BATCHES} x "
          f"{CALIB_BATCH} x {CALIB_SEQ} tokens, uniform P_I={SEARCH_P_BITS} T=128: "
          f"{counts_a['gpfq_solve']} B5 solves, {counts_a['w4a8_matmul']} B1 launches (the "
          f"static KV ranges' prefills); uniform {uni['accumulator_bits']} accumulator bits, "
          f"searched "
          f"{srch['accumulator_bits']} (floor {obs['floor_accumulator_bits']}), savings rate "
          f"{rep['savings_rate']:.6f}; {obs['n_sites']} slot sites x {cfg.n_layers} repeats, "
          f"binding {obs['binding_site']}; ppl uniform {uni['ppl']!r} == searched "
          f"{srch['ppl']!r}; {sites} sites certified before and after (min headroom "
          f"{uni['cert']['min_headroom_bits']:.4f} -> {srch['cert']['min_headroom_bits']:.4f} "
          f"bits); wall {wall_a:.3f} s")
    print(f"[search] [{smi}] (a) P_I floors per slot site (each of its 32 layers): " + ", ".join(
        f"{k} {p}" for k, p in floors.items())
        + f"; unlisted sites stay at {SEARCH_P_BITS}")

    # (b) serve the artifact with its plan: the launcher, then phase 7's
    # trace through static and dynamic int8 pages
    _, lines = quiet(SV.main, ["--arch", "smollm-360m", "--float32", "--artifact",
                               os.path.join(out_a, "quantized"), "--plan",
                               os.path.join(out_a, "plan.json"), "--packed", "--paged",
                               "--kv-dtype", "int8", "--block-size", str(PAGED_BLOCK),
                               "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                               "--max-new", str(MAX_NEW), "--device", "cuda"])
    for line in lines:
        print(f"[search] [{smi}] (b) launcher: {line}")
    validated = next((ln for ln in lines if "plan validated" in ln), "")
    check(f"plan validated: {sites} per-site datapaths match" in validated,
          f"serve --plan: {validated!r}")
    flat, meta = load_flat_artifact(os.path.join(out_a, "quantized"))
    served = packed_params_from_artifact(flat, T.init_model(cfg, 0, device="cuda"), cfg,
                                         meta=meta)
    specs, _ = trace_specs(cfg)

    def trace():
        return [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]

    def engine(kv):
        return PagedEngine(served, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, attn_impl="auto", kv_dtype="int8"), greedy, device="cuda",
            assert_bounds=True, kv_scales=plan.kv if kv == "static" else None)

    runs, engines = {}, {}
    for kv in ("static", "dynamic"):
        eng = engines[kv] = engine(kv)
        warm_paged(eng, specs[0][1])
        calls, restore = install_spy()
        try:
            run = driven(torch, cfg, eng, trace(), "int8")
        finally:
            restore()
        installs = 2 * cfg.n_layers * run["ran"]["admits"]
        want = {"static": installs, "dynamic": 0} if kv == "static" else {
            "static": 0, "dynamic": installs}
        check(calls == want, f"{kv}: install quantizer calls {calls}, expected {want}")
        spec = eng.attn_spec
        qk, pv = run["watermarks"]
        check(0 < qk <= 2 ** (spec.p_qk - 1) - 1 and 0 < pv <= 2 ** (spec.p_pv - 1) - 1,
              f"{kv}: B3 watermarks {qk}, {pv} against {spec.describe()}")
        check(eng.datapath_fingerprint.endswith("+kv-static") == (kv == "static"),
              f"{kv}: fingerprint {eng.datapath_fingerprint}")
        run.update(calls=calls, device_ops=eng._program.device_ops,
                   admit_ms=1e3 * run["spent"]["admit"] / run["ran"]["admits"])
        runs[kv] = run
    check(runs["static"]["device_ops"] < runs["dynamic"]["device_ops"],
          f"device operations a replay: static {runs['static']['device_ops']}, dynamic "
          f"{runs['dynamic']['device_ops']}")

    # the replayed decode step over PAGED_SLOTS live slots, static and
    # dynamic in turns
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]
    from repro_torch.models.layers import use_packed_backend

    with torch.inference_mode(), use_packed_backend("kernel"):
        for kv, eng in engines.items():
            sched = eng._make_scheduler()
            for b in range(PAGED_SLOTS):
                sched.submit(Request(uid=30_000 + b, prompt=np.asarray(prompts[b % BATCH]),
                                     max_new=2 * 6 * PAGED_CHUNK + 1))
            adm = sched.try_admit()
            while adm is not None:
                eng._do_admit(adm)
                adm = sched.try_admit()
            check(len(sched.active) == PAGED_SLOTS, f"{kv}: timing slots not all admitted")
        turns = in_turns(torch, {kv: (lambda e=eng: e._chunk(PAGED_CHUNK))
                                 for kv, eng in engines.items()}, runs=6, scale=PAGED_CHUNK)

    # how far the greedy streams agree (logits recorded through the replays)
    rec = {kv: recorded(engine(kv), trace(), specs[0][1]) for kv in ("static", "dynamic")}
    for kv in rec:
        check(all((rec[kv][0][u] == runs[kv]["res"][u]).all() for u, _, _ in specs),
              f"{kv}: the recorded run's streams differ from the timed run's")
    agree = partings(specs, rec["static"][0], rec["static"][1], rec["dynamic"][0],
                     rec["dynamic"][1], cfg.vocab)
    for kv, run in runs.items():
        print(f"[search] [{smi}] (b) {kv} int8 KV "
              f"({'plan.kv' if kv == 'static' else 'per-page max'}): {TRACE_REQUESTS} "
              f"requests, {run['ran']['steps']} decode steps, {run['ran']['admits']} admits; "
              f"launches B1 {run['counts']['w4a8_matmul']} (224 a forward), B3 "
              f"{run['counts']['paged_decode_attention_int8']} (32 a step); "
              f"install quantizer calls {run['calls']}; one capture, {run['device_ops']} device "
              f"operations a replay; replayed step in turns {fmt_spread(turns[kv])}; decode "
              f"step in the trace {run['step_ms']:.3f} ms, admit {run['admit_ms']:.3f} ms "
              f"(host clock), {run['tok_s']:.1f} tok/s, wall {run['wall']:.3f} s; B3 "
              f"watermarks |QK^T| {run['watermarks'][0]}, |PV| {run['watermarks'][1]}")
    print(f"[search] [{smi}] (b) static vs dynamic greedy streams: {agree['agree']} of "
          f"{agree['total']} tokens agree before they part; partings (uid, step, top-2 gap "
          f"static / dynamic): "
          + ("none" if not agree["partings"] else "; ".join(
              f"({p['uid']}, {p['step']}, {p['gap_static']:.4f} / {p['gap_dynamic']:.4f})"
              for p in agree["partings"])))

    # (c) code-changing moves: 2:4 on the most headroomed slot sites, w8 on
    # the most binding one, a masked re-calibration, the fixed-slot engine
    reset_counts()
    t0 = time.perf_counter()
    rep_c, _ = quiet(S.main, search_args(out_c, "--sparsify", str(SEARCH_SPARSIFY),
                                         "--promote-w8", str(SEARCH_PROMOTE)))
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    counts_c = read_counts()
    sc = rep_c["searched"]
    n_sparse, n_w8 = len(sc["sparsified"]), len(sc["promoted_w8"])
    check((n_sparse, n_w8) == (SEARCH_SPARSIFY, SEARCH_PROMOTE), f"moves {sc}")
    check(counts_c["gpfq_solve"] == 2 * sites
          and counts_c["gpfq_solve_masked"] == cfg.n_layers * n_sparse,
          f"(c): B5 {counts_c['gpfq_solve']} solves ({counts_c['gpfq_solve_masked']} masked), "
          f"expected {2 * sites} ({cfg.n_layers * n_sparse} masked)")
    n_int4 = 7 - n_w8
    check(sc["cert"]["ok"] and sc["cert"]["n_certified"] == n_int4 * cfg.n_layers,
          f"(c) certificates {sc['cert']}")
    plan_c = MixedPrecisionPlan.load(os.path.join(out_c, "plan.json"))
    flat_c, meta_c = load_flat_artifact(os.path.join(out_c, "quantized"))
    # a second run of the re-calibration from plan.json: bit-identical codes
    model = T.init_model(cfg, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    ptq = PTQConfig(w_bits=4, act_bits=8, p_bits=SEARCH_P_BITS, tile=128)
    again = calibrate_and_quantize(model, cfg, calib, ptq, plan=plan_c, device="cuda")
    for name, ql in again.quantized_linears():
        check(np.array_equal(ql.q_int.cpu().numpy().astype(np.int8), flat_c[f"{name}/q"]),
              f"(c): a second re-calibration's codes differ at {name}")
    served_c = packed_params_from_artifact(flat_c, model, cfg, meta=meta_c)
    eng_c = GenerationEngine(served_c, cfg, greedy, device="cuda")
    eng_c.generate(prompts, MAX_NEW)  # warm-up: the bucket's capture
    reset_counts()
    out = eng_c.generate(prompts, MAX_NEW)
    serve_counts = read_counts()
    per_forward = {"w4a8_sparse_matmul": cfg.n_layers * n_sparse,
                   "w4a8_matmul": cfg.n_layers * (n_int4 - n_sparse)}
    for counter, n in per_forward.items():
        check(serve_counts[counter] == n * MAX_NEW,
              f"(c) serving: {counter} {serve_counts[counter]}, expected {n} x {MAX_NEW}")
    check((out == GenerationEngine(served_c, cfg, greedy, device="cuda",
                                   backend="reference").generate(prompts, MAX_NEW)).all(),
          "(c): kernel and reference backends disagree on the mixed artifact")
    print(f"[search] [{smi}] (c) --sparsify {SEARCH_SPARSIFY} --promote-w8 {SEARCH_PROMOTE}: "
          f"sparsified {sc['sparsified']}, promoted {sc['promoted_w8']}; B5 "
          f"{counts_c['gpfq_solve']} solves ({counts_c['gpfq_solve_masked']} masked: the "
          f"re-calibration's 2:4 sites); "
          f"{sc['cert']['n_certified']} int4 sites certified (min headroom "
          f"{sc['cert']['min_headroom_bits']:.4f} bits); ppl uniform "
          f"{rep_c['uniform']['ppl']:.4f}, re-calibrated {sc['ppl']:.4f}; a second "
          f"re-calibration from plan.json gives bit-identical codes; wall {wall_c:.3f} s")
    print(f"[search] [{smi}] (c) served greedy batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new "
          f"through the captured step: B4 {serve_counts['w4a8_sparse_matmul']} "
          f"({per_forward['w4a8_sparse_matmul']} a forward), B1 {serve_counts['w4a8_matmul']} "
          f"({per_forward['w4a8_matmul']} a forward), none for the w8 site (float Linear); "
          f"tokens identical to the reference backend")
    print(f"[search] [{smi}] phase 12 wall {time.perf_counter() - t_phase:.3f} s")
    return {"b5": counts_a["gpfq_solve"] + counts_c["gpfq_solve"],
            "b5_masked": counts_c["gpfq_solve_masked"],
            "b1": runs["static"]["counts"]["w4a8_matmul"] + serve_counts["w4a8_matmul"],
            "b3": runs["static"]["counts"]["paged_decode_attention_int8"],
            "b4": serve_counts["w4a8_sparse_matmul"], "turns": turns, "runs": runs,
            "agree": agree, "floors": floors, "served": served, "plan": plan,
            "artifact": os.path.join(out_a, "quantized"),
            "plan_path": os.path.join(out_a, "plan.json")}


# ---------------------------------------------------------------------------
# Phase 13: the serving observers
# ---------------------------------------------------------------------------
#: phase 13 (b): the drift trace's seed and token range (the calibration
#: batches draw the whole vocabulary from TokenBatcher's seed 0)
DRIFT_SEED, DRIFT_TOKENS = 13, (0, 256)
#: phase 13: the observed sites' K (rows x K values a call reach the tap)
OBSERVED_K = {"mixer.wq": 960, "mixer.wk": 960, "mixer.wv": 960, "mixer.wo": 960,
              "ffn.wg": 960, "ffn.wu": 960, "ffn.wd": 2560}


def drift_specs(cfg):
    """Phase 13 (b)'s trace: TRACE_REQUESTS prompts of phase 7's lengths
    from another seed and only the first DRIFT_TOKENS ids."""
    import numpy as np

    rng = np.random.default_rng(DRIFT_SEED)
    return [(40_000 + u, rng.integers(*DRIFT_TOKENS, size=int(rng.integers(8, 301))),
             int(rng.integers(4, 33))) for u in range(TRACE_REQUESTS)]


def check_report(rep, engine, cfg, smi: str, tag: str, static: bool, steps: int) -> None:
    """Phase 13's gates on a saturation report of ``steps`` decode steps:
    the reference's 7 labels, n_calls = layers x steps, clip_total =
    n_calls x rows x K,
    clip_count <= clip_total (0 for the dynamic quantizer), every
    watermark inside its P_I with headroom = P_I - bits, every KV head's
    inside P_qk / P_pv (an int8 pool) or no KV section (a float pool)."""
    want = {f"slot0/{k}" for k in OBSERVED_K}
    check(set(rep["sites"]) == want, f"{tag}: labels {sorted(rep['sites'])}")
    n_calls = cfg.n_layers * steps
    for label, sec in rep["sites"].items():
        k = OBSERVED_K[label.split("/", 1)[1]]
        check(sec["n_calls"] == n_calls and sec["clip_total"] == n_calls * PAGED_SLOTS * k,
              f"{tag} {label}: n_calls {sec['n_calls']}, clip_total {sec['clip_total']}; "
              f"expected {n_calls}, {n_calls * PAGED_SLOTS * k}")
        check(sec["clip_count"] <= sec["clip_total"] and (static or sec["clip_count"] == 0),
              f"{tag} {label}: clip_count {sec['clip_count']}")
        if static:
            check(sec["watermark_bits"] <= sec["p_inner"]
                  and abs(sec["headroom_bits_observed"]
                          - (sec["p_inner"] - sec["watermark_bits"])) <= 1e-3,
                  f"{tag} {label}: watermark {sec['watermark_bits']} bits, P_I "
                  f"{sec['p_inner']}, headroom {sec['headroom_bits_observed']}")
    if engine.attn_spec is None:
        check("kv_heads" not in rep, f"{tag}: a float pool reports KV heads")
        return
    for slot, heads in rep["kv_heads"].items():
        for h, sec in heads.items():
            check(sec["qk_watermark_bits"] <= sec["p_qk"]
                  and sec["pv_watermark_bits"] <= sec["p_pv"],
                  f"{tag} {slot}/{h}: {sec}")
    print(f"[observe] [{smi}] {tag} KV heads (int8 pages, P_qk {engine.attn_spec.p_qk}, P_pv "
          f"{engine.attn_spec.p_pv}): " + "; ".join(
              f"{slot}/{h} k {sec['k_code_max']:.0f} v {sec['v_code_max']:.0f} -> QK "
              f"{sec['qk_watermark_bits']:.4f} / PV {sec['pv_watermark_bits']:.4f} bits"
              for slot, heads in rep["kv_heads"].items() for h, sec in heads.items()))


def print_sites(smi: str, tag: str, rep, other=None) -> None:
    """Per site: clip fraction (beside ``other``'s), code range, watermark
    bits and observed headroom."""
    parts = []
    for label, sec in rep["sites"].items():
        wm = (f", watermark {sec['watermark_bits']:.4f} bits of P_I {sec['p_inner']}, "
              f"headroom {sec['headroom_bits_observed']:.4f}") if "watermark_bits" in sec else ""
        vs = f" (trace (a) {other['sites'][label]['clip_frac']:.6f})" if other else ""
        parts.append(f"{label} clips {sec['clip_count']}/{sec['clip_total']} = "
                     f"{sec['clip_frac']:.6f}{vs}, codes [{sec['code_min']:.0f}, "
                     f"{sec['code_max']:.0f}]{wm}")
    print(f"[observe] [{smi}] {tag} per site: " + "; ".join(parts))


def phase_observe_slice(torch, smi: str, search: dict, paged: dict):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import search as S
    from repro_torch.launch import serve as SV
    from repro_torch.models.layers import use_packed_backend
    from repro_torch.serving import PagedConfig, PagedEngine, Request, SamplerConfig

    t_phase = time.perf_counter()
    cfg = S.f32_config(get_config("smollm-360m"))
    greedy = SamplerConfig(temperature=0.0)
    served, plan = search["served"], search["plan"]
    specs, _ = trace_specs(cfg)

    def engine(observe, model=served, kv_dtype="int8", kv_scales=plan.kv):
        return PagedEngine(model, None, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, attn_impl="auto", kv_dtype=kv_dtype), greedy,
            device="cuda", observe=observe, kv_scales=kv_scales)

    def reqs(spec_list):
        return [Request(uid=u, prompt=p, max_new=n) for u, p, n in spec_list]

    # (a) observed against plain on phase 12's static-act artifact with its
    # static KV scales, int8 pages; the engines run in turns
    engines = {"plain": engine(False), "observed": engine(True)}
    for eng in engines.values():
        warm_paged(eng, specs[0][1])
    obs = engines["observed"]
    obs.observer.reset()  # the report covers the trace alone
    runs = {"plain": [], "observed": []}
    for name in ("plain", "observed", "observed", "plain"):
        runs[name].append(driven(torch, cfg, engines[name], reqs(specs), "int8"))
    check(obs.datapath_fingerprint == engines["plain"].datapath_fingerprint.replace(
        "+kv-static", "+obs+kv-static"), f"fingerprint {obs.datapath_fingerprint}")
    want = runs["plain"][0]["res"]
    for run in runs["plain"][1:] + runs["observed"]:
        for r in want:
            check((run["res"][r] == want[r]).all(),
                  f"(a) observed and plain greedy streams differ at request {r}")
    t0 = time.perf_counter()
    rep_a = obs.saturation_report()
    report_s = time.perf_counter() - t0
    check_report(rep_a, obs, cfg, smi, "(a)", static=True,
                 steps=sum(r["ran"]["steps"] for r in runs["observed"]))
    ops = {n: e._program.device_ops for n, e in engines.items()}
    per_engine = []
    for n, rs in runs.items():
        tok_s = " / ".join(f"{r['tok_s']:.1f}" for r in rs)
        step_ms = " / ".join(f"{r['step_ms']:.3f}" for r in rs)
        per_engine.append(
            f"{n}: one capture, {ops[n]} device operations a replay, B1 "
            f"{rs[0]['counts']['w4a8_matmul']} (224 a forward), B3 "
            f"{rs[0]['counts']['paged_decode_attention_int8']} (32 a step) over "
            f"{rs[0]['ran']['steps']} steps a run, {tok_s} tok/s, decode step {step_ms} ms "
            f"in the trace (host clock)")
    print(f"[observe] [{smi}] (a) phase 12's static-act artifact (f32) with plan.kv, int8 "
          f"pages, phase 7's {TRACE_REQUESTS} requests, twice an engine in turns (plain, "
          f"observed, observed, plain): every observed stream identical to the plain one's; "
          + "; ".join(per_engine)
          + f"; the observed replay adds {ops['observed'] - ops['plain']} device operations "
          f"({len(obs.observer.block.labels) * cfg.n_layers} taps); saturation_report {1e3 * report_s:.3f} ms (host clock)")
    print_sites(smi, "(a)", rep_a)

    # (b) drift: the same observed engine, a trace unlike the calibration
    obs.observer.reset()
    run_b = driven(torch, cfg, obs, reqs(drift_specs(cfg)), "int8")
    rep_b = obs.saturation_report()
    check_report(rep_b, obs, cfg, smi, "(b)", static=True, steps=run_b["ran"]["steps"])
    print(f"[observe] [{smi}] (b) drift: {TRACE_REQUESTS} prompts of seed {DRIFT_SEED}, ids "
          f"in [{DRIFT_TOKENS[0]}, {DRIFT_TOKENS[1]}), {run_b['ran']['steps']} steps, "
          f"{run_b['tok_s']:.1f} tok/s")
    print_sites(smi, "(b)", rep_b, rep_a)

    # the replayed step, observed against bare, in turns over PAGED_SLOTS
    # live slots; the fold's host time
    from repro_torch.data import DataConfig, TokenBatcher

    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]
    with torch.inference_mode(), use_packed_backend("kernel"):
        for name, eng in engines.items():
            sched = eng._make_scheduler()
            for b in range(PAGED_SLOTS):
                sched.submit(Request(uid=50_000 + b, prompt=np.asarray(prompts[b % BATCH]),
                                     max_new=2 * 6 * PAGED_CHUNK + 1))
            adm = sched.try_admit()
            while adm is not None:
                eng._do_admit(adm)
                adm = sched.try_admit()
            check(len(sched.active) == PAGED_SLOTS, f"{name}: timing slots not all admitted")
        turns = in_turns(torch, {"bare": lambda: engines["plain"]._chunk(PAGED_CHUNK),
                                 "observed": lambda: obs._chunk(PAGED_CHUNK)},
                         runs=6, scale=PAGED_CHUNK)
    folds = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs.observer.fold()
        folds.append(1e3 * (time.perf_counter() - t0))
    fold = spread_ms(folds)
    t0 = time.perf_counter()
    obs.assert_observation_transparent()
    transparent_s = time.perf_counter() - t0
    print(f"[observe] [{smi}] replayed step in turns over {PAGED_SLOTS} live slots: bare "
          f"{fmt_spread(turns['bare'])}, observed {fmt_spread(turns['observed'])}, ratio "
          f"{turns['observed']['median'] / turns['bare']['median']:.4f}; fold (one read of "
          f"the {len(obs.observer.block.labels)} x 32-byte block, zeroed in place) "
          f"{fmt_spread(fold)} (host clock); assert_observation_transparent on the card's "
          f"graph nodes (three throwaway captures) passed in {transparent_s:.3f} s")

    # (c) the float pool: phase 7's bf16 RTN model, dynamic activations,
    # observed; then the launcher with --observe
    eng_c = engine(True, model=paged["model"], kv_dtype="act", kv_scales=None)
    warm_paged(eng_c, specs[0][1])
    eng_c.observer.reset()
    run_c = driven(torch, paged["model"].cfg, eng_c, reqs(specs), "act")
    check(all((run_c["res"][u] == paged["runs"]["act"]["res"][u]).all() for u, _, _ in specs),
          "(c): the observed float-KV streams differ from phase 7's plain run")
    rep_c = eng_c.saturation_report()
    check_report(rep_c, eng_c, cfg, smi, "(c)", static=False, steps=run_c["ran"]["steps"])
    print(f"[observe] [{smi}] (c) phase 7's bf16 RTN model (dynamic activations), float "
          f"pages, observed: streams equal phase 7's plain run; B1 "
          f"{run_c['counts']['w4a8_matmul']}, B2 {run_c['counts']['paged_decode_attention']} "
          f"(32 a step) over {run_c['ran']['steps']} steps; {eng_c._program.device_ops} device "
          f"operations a replay (phase 7's plain float replay: "
          f"{paged['runs']['act']['device_ops']}); "
          f"{run_c['tok_s']:.1f} tok/s; no clip at any site, no KV section")
    print_sites(smi, "(c)", rep_c)
    _, lines = quiet(SV.main, ["--arch", "smollm-360m", "--float32", "--artifact",
                               search["artifact"], "--plan", search["plan_path"], "--packed",
                               "--paged", "--kv-dtype", "int8", "--block-size",
                               str(PAGED_BLOCK), "--batch", str(BATCH), "--prompt-len",
                               str(PROMPT), "--max-new", str(MAX_NEW), "--device", "cuda",
                               "--observe"])
    observed_line = next((ln for ln in lines if "binding watermark:" in ln), "")
    check(observed_line.startswith("[serve] observed 7 sites; binding watermark: slot0/"),
          f"serve --observe: {observed_line!r}")
    for line in lines:
        if line.startswith("[serve]") and "saturation report" not in line:
            print(f"[observe] [{smi}] (c) launcher: {line}")
    print(f"[observe] [{smi}] phase 13 wall {time.perf_counter() - t_phase:.3f} s")
    return {"b1": sum(r["counts"]["w4a8_matmul"] for r in runs["observed"]),
            "b3": sum(r["counts"]["paged_decode_attention_int8"] for r in runs["observed"]),
            "b2": run_c["counts"]["paged_decode_attention"], "turns": turns, "fold": fold,
            "ops": ops}


# ---------------------------------------------------------------------------
# Phase 14: the recurrent families (xlstm-350m, a Mamba block at Jamba's
# widths, tiny-hybrid)
# ---------------------------------------------------------------------------
XLSTM, JAMBA = "xlstm-350m", "jamba-1.5-large-398b"
#: phase 14 (c): the Mamba block's stated tolerances. Its parallel scan
#: against the f32 step-by-step recurrence on the same (xin, dt, B, C), as
#: a share of the largest |y| and |h| (MAMBA_SCAN_TOL). Its prefill and 16
#: decode steps from the prefill's state against the block run step by
#: step from zero through all 80 positions, as the relative L2 error of
#: the outputs and of the final SSM state, for each input seed of
#: MAMBA_SEEDS (MAMBA_STEP_TOL): through the dequantized weights, where
#: only bf16 rounding of the conv and the scan parts the two runs; and
#: through B1 with one static activation quantizer a site, so that both
#: runs quantize a row alike and part only where that rounding moves an
#: activation code by a step
MAMBA_SCAN_TOL, MAMBA_STEP_TOL = 1e-4, 1e-3
MAMBA_SEEDS = (14, 15, 16)
#: phase 14 (d): tiny-hybrid's paged trace (the rung's 256-token context)
HYBRID_REQUESTS, HYBRID_BLOCK = 12, 8


def state_bytes(cfg, batch: int = 1) -> int:
    """Bytes of every recurrent layer's decode state for ``batch`` sequences."""
    import torch
    from repro_torch.models.transformer import recurrent_state_shapes

    total = 0
    for i in range(cfg.n_layers):
        for shape, dt in recurrent_state_shapes(cfg.layer_spec(i), cfg, batch).values():
            total += math.prod(shape) * torch.empty((), dtype=dt).element_size()
    return total


def eager_paged_run(engine, specs, warm):
    """The same trace through ``engine`` with its decode chunks run eagerly
    (the reference loop), its step captured first by the warm-up."""
    from repro_torch.serving import Request

    warm_paged(engine, warm)
    chunk = engine._chunk
    engine._chunk = lambda k, _c=chunk: _c(k, eager=True)
    return engine.serve([Request(uid=u, prompt=p, max_new=n) for u, p, n in specs])


def packed_site_shapes(model) -> list[tuple[int, int]]:
    """The distinct (K, N) of a model's packed sites, in module order."""
    from repro_torch.models.layers import PackedLinear

    shapes = [(2 * m.packed.shape[0], m.packed.shape[1]) for m in model.modules()
              if isinstance(m, PackedLinear)]
    return list(dict.fromkeys(shapes))


def b1_site_check(torch, what: str, shapes, smi: str, tag: str = "recurrent") -> list[dict]:
    """B1 bit-equal to its plain version at a model's packed (K, N), at the
    decode and the prefill M of phase 14, with its plan, time (cold L2) and
    bound at each, and ``torch._int_mm`` on the same codes (phase 2's
    yardstick: rows padded to 32, N to a multiple of 8, codes shifted by
    -128) where K is a multiple of 8."""
    from repro_torch.kernels import w4a8_mm as W

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    for m in (BATCH, BATCH * PROMPT):
        for k, n in shapes:
            q = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
            x = torch.randint(0, 256, (m, k), generator=gen, device=dev).to(torch.uint8)
            wp, col = W.pack_int4(q), q.sum(0, dtype=torch.int32)
            scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 1e-3
            args = (x, wp, scale, col, 0.0213, 131.0)
            y = W.w4a8_decode_matmul(*args, out_dtype=torch.bfloat16)
            r = W.w4a8_decode_matmul(*args, out_dtype=torch.bfloat16, reference=True)
            check(torch.equal(y, r), f"B1 != plain at {what}'s M={m} K={k} N={n}")
            plan = plan_fields(W.w4a8_matmul.last_plan)["plan"]
            sw, corr = scale * 0.0213, col.float() * 131.0
            ms = time_ms(torch, lambda: W.w4a8_matmul_kernel(x, wp, sw, corr, torch.bfloat16),
                         flush=flush)
            lib = None
            if k % 8 == 0:
                mp, n8 = max(m, 32), -(-n // 8) * 8
                xs = torch.zeros((mp, k), dtype=torch.int8, device=dev)
                xs[:m] = (x.to(torch.int16) - 128).to(torch.int8)
                w8 = torch.zeros((k, n8), dtype=torch.int8, device=dev)
                w8[:, :n] = q
                check(torch.equal((torch._int_mm(xs, w8)[:m, :n] + 128 * col).double(),
                                  x.double() @ q.double()),
                      "the _int_mm yardstick disagrees with the exact product")
                lib = time_ms(torch, lambda: torch._int_mm(xs, w8), flush=flush)
                del xs, w8
            b, by = bound_ms(m, k, n)
            rows.append({"m": m, "k": k, "n": n, "ms": ms, "bound_ms": b, "bound_by": by,
                         "plan": plan, "library_ms": lib})
            print(f"[{tag}] B1 at {what}'s site M={m:3d} K={k:5d} N={n:5d}: bit-equal, "
                  f"{ms:.5f} ms, bound {b:.5f} ms ({by}), _int_mm "
                  f"{'n/a' if lib is None else f'{lib:.5f} ms'}, {plan}; {smi}")
            del q, x, wp, y, r
    return rows


def mamba_block_check(torch, smi: str) -> dict:
    """(c): one Mamba block at Jamba's widths, bf16, RTN-packed: B1 at its
    site shapes; a parallel prefill and 16 decode steps from its state,
    through the dequantized weights and through B1 with static activation
    quantizers, each against the block run step by step, for each input
    seed of MAMBA_SEEDS."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import quantize_activations
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.config import LayerSpec
    from repro_torch.models.layers import PackedLinear, use_packed_backend
    from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes

    jcfg = get_config(JAMBA)
    cfg = replace(jcfg, name="jamba-mamba-block", n_layers=1, moe=None, vocab=128,
                  pattern=(LayerSpec("mamba", "none"),))
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    p = model.layers[0].mixer
    sites = {n: getattr(p, n) for n in ("in_proj", "x_proj", "dt_proj", "out_proj")}
    check(all(isinstance(s, PackedLinear) for s in sites.values()),
          "a Mamba site at Jamba's widths is not packed")
    b1_rows = b1_site_check(torch, "the Jamba-width Mamba block", packed_site_shapes(model),
                            smi)
    d, d_in, n_st = cfg.d_model, cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    total = PROMPT + MAX_NEW

    def rel(a, b):
        return (torch.linalg.vector_norm((a - b).float())
                / torch.linalg.vector_norm(b.float())).item()

    def run(backend, x):
        """Prefill + decode from its state, and the block step by step from
        zero through every position; relative L2 errors and timings."""
        with torch.inference_mode(), use_packed_backend(backend):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            y_pre, st = S.mamba(p, x[:, :PROMPT], cfg, return_state=True)
            torch.cuda.synchronize()
            pre_ms = 1e3 * (time.perf_counter() - t0)
            pre_b1 = read_counts()["w4a8_matmul"]
            conv, ssm = st["conv"].clone(), st["ssm"].clone()
            reset_counts()
            ys, step_ms = [], []
            for t in range(PROMPT, total):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ys.append(S.mamba_decode(p, x[:, t:t + 1], cfg, conv, ssm)[0])
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            dec_b1 = read_counts()["w4a8_matmul"]
            conv0, ssm0 = torch.zeros_like(conv), torch.zeros_like(ssm)
            y_step = torch.cat([S.mamba_decode(p, x[:, t:t + 1], cfg, conv0, ssm0)[0]
                                for t in range(total)], dim=1)
        return {"prefill_ms": pre_ms, "step": spread_ms(step_ms[1:]), "b1": (pre_b1, dec_b1),
                "prefill_err": rel(y_pre, y_step[:, :PROMPT]),
                "decode_err": rel(torch.cat(ys, dim=1), y_step[:, PROMPT:]),
                "ssm_err": rel(ssm, ssm0)}

    def set_static_quantizers(x):
        """Each site's static activation quantizer: the dynamic one's scale
        and zero point over what reaches the site in a dequantized forward
        of all 80 positions."""
        seen = {}
        hooks = [s.register_forward_pre_hook(lambda mod, a, n=n: seen.__setitem__(n, a[0]))
                 for n, s in sites.items()]
        with torch.inference_mode(), use_packed_backend("dequant"):
            S.mamba(p, x, cfg)
        for h in hooks:
            h.remove()
        for n, s in sites.items():
            _, scale, zp = quantize_activations(seen[n].reshape(-1, seen[n].shape[-1]))
            s.act_scale, s.act_zp = scale.clone(), zp.clone()
            s.spec = replace(s.spec, static_act=True)

    runs = {"dequant": [], "kernel": []}
    for seed in MAMBA_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((BATCH, total, d), generator=gen, device="cuda").to(torch.bfloat16)
        runs["dequant"].append(run("dequant", x))
        set_static_quantizers(x)
        runs["kernel"].append(run("kernel", x))
    for backend in runs:
        for seed, r in zip(MAMBA_SEEDS, runs[backend]):
            errs = (r["prefill_err"], r["decode_err"], r["ssm_err"])
            check(r["b1"] == ((4, 4 * MAX_NEW) if backend == "kernel" else (0, 0)),
                  f"B1 launches (prefill, decode) {r['b1']} through {backend} (seed {seed})")
            check(all(math.isfinite(v) and v <= MAMBA_STEP_TOL for v in errs),
                  f"the Mamba block ({backend}, seed {seed}): prefill {errs[0]:.3e}, decode "
                  f"{errs[1]:.3e}, SSM state {errs[2]:.3e} against its stepwise run (relative "
                  f"L2, tolerance {MAMBA_STEP_TOL})")
    # the scan alone against the f32 step-by-step recurrence on its inputs
    with torch.inference_mode(), use_packed_backend("kernel"):
        xz = p.in_proj(x[:, :PROMPT])
        xin = torch.nn.functional.silu(S._causal_conv(xz[..., :d_in], p.conv_w, p.conv_b)[0])
        dt, b_ssm, c_ssm, a = S._ssm_params(p, xin, cfg)
        y_scan, h_scan = S.selective_scan(xin, dt, b_ssm, c_ssm, a, p.D, n_st,
                                          return_state=True)
        h = torch.zeros((BATCH, d_in, n_st), dtype=torch.float32, device="cuda")
        y_ref = []
        for t in range(PROMPT):
            dtf = dt[:, t].float()
            h = torch.exp(dtf[..., None] * a) * h + (dtf * xin[:, t].float())[..., None] * \
                b_ssm[:, t].float()[:, None, :]
            y_ref.append(torch.einsum("bdn,bn->bd", h, c_ssm[:, t].float())
                         + p.D.float() * xin[:, t].float())
        y_ref = torch.stack(y_ref, dim=1)
    scan_err = ((y_scan - y_ref).abs().max() / y_ref.abs().max()).item()
    state_err = ((h_scan - h).abs().max() / h.abs().max()).item()
    check(scan_err <= MAMBA_SCAN_TOL and state_err <= MAMBA_SCAN_TOL,
          f"the parallel scan at Jamba's widths: y {scan_err:.3e}, state {state_err:.3e} "
          f"against the step-by-step recurrence (tolerance {MAMBA_SCAN_TOL})")
    nbytes = packed_weight_bytes(cfg)["packed_bytes"]
    st_mib = state_bytes(cfg) / 2**20
    k = runs["kernel"][0]
    print(f"[recurrent] (c) one Mamba block at {JAMBA}'s widths (d_model {d}, d_in {d_in}, "
          f"d_state {n_st}, dt_rank {cfg.dt_rank}), bf16 RTN-packed ({nbytes} packed bytes; "
          f"state {st_mib:.4f} MiB a slot); {smi}: prefill {BATCH} x {PROMPT} with the "
          f"parallel scan {k['prefill_ms']:.3f} ms (B1 {k['b1'][0]}), {MAX_NEW} decode steps "
          f"{fmt_spread(k['step'])} each after the first (B1 {k['b1'][1]}), static quantizers, "
          f"seed {MAMBA_SEEDS[0]}; the scan against the f32 step-by-step recurrence: y "
          f"{scan_err:.3e}, state {state_err:.3e} of their largest magnitude (tolerance "
          f"{MAMBA_SCAN_TOL})")
    for backend in runs:
        print(f"[recurrent] (c) {backend}: parallel prefill + decode against the block run "
              f"step by step from zero, relative L2 (prefill, decode, SSM state) by input seed: "
              + "; ".join(f"{seed}: {r['prefill_err']:.3e}, {r['decode_err']:.3e}, "
                          f"{r['ssm_err']:.3e}" for seed, r in zip(MAMBA_SEEDS, runs[backend]))
              + f" (tolerance {MAMBA_STEP_TOL})")
    return {"runs": runs, "scan_err": scan_err, "scan_state_err": state_err,
            "packed_bytes": nbytes, "state_mib_slot": st_mib, "b1_sites": b1_rows,
            "b1_launches": sum(sum(r["b1"]) for r in runs["kernel"])}


def hybrid_paged_check(torch, smi: str) -> dict:
    """(d): tiny-hybrid RTN-packed through the paged engine, float and int8
    pages: B1, B1e, B2 and B3 on the card, replays against eager chunks."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.serving import PagedConfig, PagedEngine, Request, SamplerConfig

    cfg = get_config("tiny-hybrid")
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    rng = np.random.default_rng(14)
    specs = [(u, rng.integers(0, cfg.vocab, size=int(rng.integers(4, 41))),
              int(rng.integers(4, 17))) for u in range(HYBRID_REQUESTS)]
    per_forward = {"w4a8_matmul": 11, "w4a8_expert_matmul": 3}  # Mamba 4 + MLP 3 + attn 4

    def engine(kv):
        return PagedEngine(model, cfg, PagedConfig(
            block_size=HYBRID_BLOCK, num_blocks=64, max_concurrency=PAGED_SLOTS,
            max_pages_per_seq=8, chunk_max=PAGED_CHUNK, kv_dtype=kv),
            SamplerConfig(temperature=0.0), device="cuda")

    runs = {}
    for kv in ("act", "int8"):
        eng = engine(kv)
        warm_paged(eng, specs[0][1])
        run = driven(torch, cfg, eng, [Request(uid=u, prompt=p, max_new=n)
                                       for u, p, n in specs], kv, per_forward)
        eager = engine(kv)
        eager_res = eager_paged_run(eager, specs, specs[0][1])
        check(eager.pool_state.digest() == run["digest"],
              f"tiny-hybrid {kv}: the eager chunk's allocator digest differs")
        check(all((eager_res[u] == run["res"][u]).all() for u, _, _ in specs),
              f"tiny-hybrid {kv}: the replays' streams differ from the eager chunk's")
        runs[kv] = run
        print(f"[recurrent] (d) tiny-hybrid RTN-packed, paged FIFO, {kv} KV, "
              f"{HYBRID_REQUESTS} requests in {PAGED_SLOTS} slots: launches {run['counts']} "
              f"({run['ran']}); streams and digest equal to the eager chunk's; decode step "
              f"{run['step_ms']:.3f} ms, {run['tok_s']:.1f} tok/s; {smi}")
    return runs


def phase_recurrent_slice(torch, smi: str):
    """xlstm-350m at full width: (a) fixed slot and paged FIFO serving, (b)
    calibration, export and serving of the artifact; (c) a Mamba block at
    Jamba's widths; (d) tiny-hybrid paged."""
    import tempfile
    from dataclasses import replace

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.axe import PTQConfig
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Linear, PackedLinear
    from repro_torch.quant.pipeline import calibrate_and_quantize
    from repro_torch.quant.serve_packed import (
        export_quantized_artifact,
        load_flat_artifact,
        pack_decode_params,
        packed_params_from_artifact,
        packed_weight_bytes,
    )
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )
    from repro_torch.serving.graphs import COUNTERS

    t_phase = time.perf_counter()
    greedy = SamplerConfig(temperature=0.0)
    cfg = get_config(XLSTM)
    kinds = [cfg.layer_spec(i).mixer for i in range(cfg.n_layers)]
    b1_forward = 5 * kinds.count("mlstm") + 2 * kinds.count("slstm")
    per_forward = {"w4a8_matmul": b1_forward}
    t0 = time.perf_counter()
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    packed = sum(isinstance(m, PackedLinear) for m in model.modules())
    check(packed == b1_forward == 111, f"{packed} packed sites, expected 111")
    check(all(isinstance(b.mixer.down, Linear) for b in model.layers if b.spec.mixer == "slstm"),
          "the sLSTM down projection (K = 1365, odd) must stay float")
    b1_sites = b1_site_check(torch, XLSTM, packed_site_shapes(model), smi)
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]

    # (a) the fixed slot: one capture, then generates of replays
    engine = GenerationEngine(model, cfg, greedy, device="cuda")
    t0 = time.perf_counter()
    engine.generate(prompts, MAX_NEW)
    first_s = time.perf_counter() - t0
    (bucket,) = engine._buckets.values()
    program = bucket.program
    check(program.graph is not None and engine.gen_traces == 1,
          "the first generate did not capture the xLSTM step")
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["w4a8_matmul"] == b1_forward * MAX_NEW and sum(counts.values()) ==
          counts["w4a8_matmul"], f"launches in a generate {counts}, expected B1 "
          f"{b1_forward} x {MAX_NEW} and nothing else")
    rise = {getattr(fn, "__name__", "?"): r for (fn, _, _), r in zip(COUNTERS, program.rise)}
    check(rise["w4a8_matmul"] == b1_forward, f"a replay adds {rise}, expected B1 {b1_forward} "
                                             f"(read by name from the graph's kernel nodes)")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of the vocabulary")
    host = engine.generate_host_loop(prompts, MAX_NEW)
    eager_toks, eager_logits = fixed_slot_run(torch, model, prompts, MAX_NEW)
    check((eager_toks == host[:, PROMPT:]).all(), "the recorded eager run differs from the "
                                                  "host loop")
    rec_engine = GenerationEngine(model, cfg, greedy, device="cuda")
    with FixedRecorder(rec_engine, BATCH, PROMPT + MAX_NEW) as rec:
        rec_out = rec_engine.generate(prompts, MAX_NEW)
    check((rec_out == out).all(), "two captures of the xLSTM step disagree")
    cmp_a = tie_limited([(out[b, PROMPT:], host[b, PROMPT:], rec.logits(b, PROMPT, MAX_NEW),
                          [eager_logits[t][b] for t in range(MAX_NEW)]) for b in range(BATCH)],
                        cfg.vocab)
    del rec_engine, rec
    gen_t = in_turns(torch, {"graph": lambda: engine.generate(prompts, MAX_NEW),
                             "host_loop": lambda: engine.generate_host_loop(prompts, MAX_NEW)},
                     runs=4)
    tokens = torch.as_tensor(prompts, device="cuda")
    pre_ms = []
    with torch.inference_mode():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        engine._start(bucket, tokens)
        step_t = in_turns(torch, {"eager": lambda: T.decode_step(model, step_tok, caches,
                                                                  PROMPT),
                                  "replay": lambda: program.run(1)}, runs=6)
        prof = replay_profile(torch, program, lambda: engine._start(bucket, tokens),
                              per_forward, "xlstm-profile", XLSTM)
    nbytes = packed_weight_bytes(cfg)
    st_mib = state_bytes(cfg) / 2**20
    c_mib = sum(math.prod(s) * 4 for i in range(cfg.n_layers) if kinds[i] == "mlstm"
                for s in [T.recurrent_state_shapes(cfg.layer_spec(i), cfg, 1)["C"][0]]) / 2**20
    fixed = {"wall_s": wall, "tok_s": BATCH * MAX_NEW / wall, "gen": gen_t, "step": step_t,
             "prefill": spread_ms(pre_ms[1:]), "peak_mib": peak / 2**20,
             "capture_ms": 1e3 * program.capture_s, "device_ops": program.device_ops,
             "cmp": cmp_a, "counts": counts, "profile": prof, "state_mib_slot": st_mib,
             "packed_bytes": nbytes["packed_bytes"]}
    print(f"[recurrent] {XLSTM} full width ({cfg.n_layers} layers: {kinds.count('mlstm')} "
          f"mLSTM, {kinds.count('slstm')} sLSTM; d_model {cfg.d_model}, bf16, seeded random "
          f"init) RTN-packed in {init_s:.3f} s: {packed} packed sites, the "
          f"{kinds.count('slstm')} sLSTM down projections (K = 1365) float; "
          f"packed_weight_bytes {nbytes['packed_bytes']} ({nbytes['packed_code_bytes']} code "
          f"bytes; bf16 {nbytes['bf16_bytes']}); "
          f"recurrent state {st_mib:.3f} MiB a slot ({c_mib:.3f} MiB of it mLSTM C); {smi}")
    print(f"[recurrent] (a) fixed slot, batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new: "
          f"B1 {counts['w4a8_matmul']} = {b1_forward} a forward x {MAX_NEW}; one capture "
          f"({1e3 * program.capture_s:.3f} ms, {program.device_ops} device operations; first "
          f"generate {first_s:.3f} s); {cmp_a['agree']} of {cmp_a['total']} tokens agree with "
          f"the eager host loop (partings {cmp_a['partings']}, tie band {cmp_a['band']:.4f})")
    print(f"[recurrent] (a) generate wall {wall:.4f} s = {fixed['tok_s']:.1f} tok/s; in turns: "
          f"captured {fmt_spread(gen_t['graph'])}, host loop {fmt_spread(gen_t['host_loop'])}; "
          f"decode step replay {fmt_spread(step_t['replay'])}, eager "
          f"{fmt_spread(step_t['eager'])}; prefill {fmt_spread(fixed['prefill'])}; peak "
          f"memory {peak / 2**20:.1f} MiB; {smi}")

    def paged_engine():
        return PagedEngine(model, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK), greedy, device="cuda")

    specs, _ = trace_specs(cfg)
    warm = specs[0][1]
    eng = paged_engine()
    warm_paged(eng, warm)
    paged = driven(torch, cfg, eng, [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs],
                   "act", per_forward)
    eager = paged_engine()
    eager_res = eager_paged_run(eager, specs, warm)
    check(eager.pool_state.digest() == paged["digest"],
          "xLSTM paged: the eager chunk's allocator digest differs from the replays'")
    check(all((eager_res[u] == paged["res"][u]).all() for u, _, _ in specs),
          "xLSTM paged: the replays' streams differ from the eager chunk's")
    paged["cmp"] = "identical"
    paged["step_turns"] = paged_step_turns(torch, eng, [s[1] for s in specs[:PAGED_SLOTS]])
    print(f"[recurrent] (a) paged FIFO, {TRACE_REQUESTS} requests in {PAGED_SLOTS} slots: "
          f"launches {paged['counts']} ({paged['ran']}), every page back on the free list; "
          f"streams against the eager chunk's: {paged['cmp']}; decode step "
          f"{paged['step_ms']:.3f} ms, admits {paged['admit_ms_per_request']:.3f} ms a "
          f"request, {paged['tok_s']:.1f} tok/s, wall {paged['wall']:.3f} s, peak "
          f"{paged['peak_mib']:.1f} MiB; a chunk over {PAGED_SLOTS} live slots per step: "
          f"replay {fmt_spread(paged['step_turns']['replay'])}, eager "
          f"{fmt_spread(paged['step_turns']['eager'])}; {smi}")
    del model, engine, eng, eager
    gc.collect()
    torch.cuda.empty_cache()

    # (b) calibration of a float32 copy at full width, the artifact served
    cfg_c = replace(cfg, param_dtype="float32", act_dtype="float32")
    sites_c = 5 * kinds.count("mlstm") + 3 * kinds.count("slstm")
    model_c = T.init_model(cfg_c, 0, device="cuda")
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=CALIB_SEQ,
                                   global_batch=CALIB_BATCH, seed=0))
    calib = [data.batch(10_000 + i) for i in range(CALIB_BATCHES)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model_c, cfg_c, calib, PTQConfig(), device="cuda")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    ccounts = read_counts()
    check(ccounts["gpfq_solve"] == sites_c, f"{ccounts['gpfq_solve']} B5 launches calibrating, "
                                            f"expected {sites_c}")
    summary = qm.cert_summary()
    check(summary["ok"] and summary["n_certified"] == sites_c
          and all(ql.cert is not None and ql.cert.ok for _, ql in qm.quantized_linears()),
          f"certificates: {summary}")
    artifact, meta = export_quantized_artifact(qm)
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(artifact, os.path.join(tmp, "quantized"), meta)
        flat, meta2 = load_flat_artifact(os.path.join(tmp, "quantized"))
    served = packed_params_from_artifact(flat, model_c, cfg_c, meta=meta2, strict=True)
    check(all(isinstance(b.mixer.down, Linear) for b in served.layers
              if b.spec.mixer == "slstm"), "the artifact's sLSTM down must serve float")
    eng_c = GenerationEngine(served, cfg_c, greedy, device="cuda")
    eng_c.generate(prompts, MAX_NEW)  # captures
    reset_counts()
    t0 = time.perf_counter()
    out_c = eng_c.generate(prompts, MAX_NEW)
    serve_c_s = time.perf_counter() - t0
    serve_c = read_counts()
    check(serve_c["w4a8_matmul"] == b1_forward * MAX_NEW,
          f"B1 {serve_c['w4a8_matmul']} serving the artifact, expected {b1_forward * MAX_NEW}")
    ref = GenerationEngine(served, cfg_c, greedy, device="cuda",
                           backend="reference").generate(prompts, MAX_NEW)
    check((out_c == ref).all(), "kernel and reference backends disagree on the artifact")
    check((out_c == eng_c.generate_host_loop(prompts, MAX_NEW)).all(),
          "the captured generate and the eager host loop disagree on the artifact")
    print(f"[recurrent] (b) AXE-GPFQ calibration (default PTQConfig) of a float32 copy, "
          f"{cfg.n_layers} layers at full width, {CALIB_BATCHES} x "
          f"{CALIB_BATCH} x {CALIB_SEQ} tokens: wall {calib_s:.3f} s; B5 launches "
          f"{ccounts['gpfq_solve']}; {summary['n_certified']} sites certified, min headroom "
          f"{summary['min_headroom_bits']:.4f} bits at {summary['min_headroom_site']}; the "
          f"artifact ({len(artifact)} leaves, {meta['datapath']}) served batch {BATCH} x "
          f"prompt {PROMPT} + {MAX_NEW}: B1 {serve_c['w4a8_matmul']}, tokens identical to the "
          f"reference backend and the eager host loop, "
          f"{BATCH * MAX_NEW / serve_c_s:.1f} tok/s; {smi}")
    del model_c, qm, served, eng_c
    gc.collect()
    torch.cuda.empty_cache()

    mamba = mamba_block_check(torch, smi)
    hybrid = hybrid_paged_check(torch, smi)
    wall_s = time.perf_counter() - t_phase
    print(f"[recurrent] phase 14 wall {wall_s:.3f} s")
    return {"fixed": fixed, "paged": paged, "calib_s": calib_s, "mamba": mamba,
            "hybrid": hybrid, "wall_s": wall_s, "b1_sites": b1_sites,
            "b1": {"fixed": counts["w4a8_matmul"], "paged": paged["counts"]["w4a8_matmul"],
                   "artifact": serve_c["w4a8_matmul"], "mamba_block": mamba["b1_launches"],
                   "hybrid": [hybrid[k]["counts"]["w4a8_matmul"] for k in ("act", "int8")]},
            "b5": ccounts["gpfq_solve"],
            "b1e": [hybrid[k]["counts"]["w4a8_expert_matmul"] for k in ("act", "int8")],
            "b2": hybrid["act"]["counts"]["paged_decode_attention"],
            "b3": hybrid["int8"]["counts"]["paged_decode_attention_int8"]}


# ---------------------------------------------------------------------------
# Phase 15: training and checkpoint restore, the trained rung, the registry
# ---------------------------------------------------------------------------
#: (a) smollm-360m in f32 through launch/train.py: steps, batch x seq, a
#: checkpoint every TRAIN_EVERY steps; the launcher keeps the optimizer's
#: warmup of 100 steps, so the peak lr is set high enough that 20 steps of
#: the ramp move the loss
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_EVERY = "smollm-360m", 20, 8, 128, 10
TRAIN_LR = 5e-3
#: (b) the paper-table recipe (benchmarks/common.py): tiny-lm-l, 400 steps,
#: batch 8 x seq 96, lr 1e-3, warmup 20, init seed 0, data seed 7; 4
#: calibration batches from 50000, 4 eval batches; AXE-GPFQ at P_I = 16
RUNG, RUNG_STEPS, RUNG_BATCH, RUNG_SEQ, RUNG_LR, RUNG_WARMUP, RUNG_DATA_SEED = (
    "tiny-lm-l", 400, 8, 96, 1e-3, 20, 7)
#: (c) the registry's models that fit one card, bf16 at full width, each cut
#: to REGISTRY_LAYERS layers (their B1 sites are checked at every shape)
REGISTRY_FULL = ("stablelm-3b", "phi4-mini-3.8b", "musicgen-medium")
REGISTRY_LAYERS = 8


def sites_per_forward(cfg) -> int:
    """Packed sites of a dense model: 4 attention sites and 3 (SwiGLU) or 2
    (GELU) MLP sites a layer."""
    return cfg.n_layers * (4 + (3 if cfg.act == "swiglu" else 2))


def train_and_resume(torch, smi: str, root: str) -> dict:
    """(a), first half: smollm-360m in f32 trains TRAIN_STEPS steps through
    launch/train.py with checkpoints; the step's launches are none of the
    port's kernels; a second run resumes from the step-10 checkpoint and
    must reach step 20's loss within rel 1e-6 and its params within atol
    1e-7 (the reference's resume tolerance; the trainer runs deterministic
    algorithms on the card, so the runs are expected bit-equal)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.interop import load_train_state_, train_state_tree
    from repro_torch.launch import train as TR

    ckpt = os.path.join(root, "ckpt")
    args = ["--arch", TRAIN_ARCH, "--float32", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--ckpt-dir", ckpt,
            "--ckpt-every", str(TRAIN_EVERY), "--log-every", str(TRAIN_EVERY), "--device", "cuda"]
    mon = TR.StragglerMonitor()
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    (state, losses), _ = quiet(lambda: TR.main(args, monitor=mon))
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    check(not any(counts.values()), f"training launched port kernels: {counts}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"losses {losses}")
    k = TRAIN_STEPS // 4
    check(losses[-1] < losses[0] and sum(losses[-k:]) < sum(losses[:k]),
          f"the loss does not fall: {losses}")
    check(losses[0] == PHASE15["first_loss"],
          f"the launcher's first loss {losses[0]} is not the remat turns' "
          f"{PHASE15['first_loss']} (the same init and batch)")
    mgr = CheckpointManager(ckpt)
    check(mgr.latest_step() == TRAIN_STEPS and os.path.isdir(mgr.directory(TRAIN_EVERY)),
          f"checkpoints {sorted(os.listdir(ckpt))}")
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    step_ms = [1e3 * t for t in mon.times[1:]]  # the first step builds and warms up
    step_t = spread_ms(step_ms)
    # a blocking write of the whole train state and its restore, timed
    timing = CheckpointManager(os.path.join(root, "timing"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.save(TRAIN_STEPS, train_state_tree(state), blocking=True)
    write_s = time.perf_counter() - t0
    ck_bytes = sum(os.path.getsize(os.path.join(timing.directory(TRAIN_STEPS), f))
                   for f in os.listdir(timing.directory(TRAIN_STEPS)))
    kept = {n: p.detach().clone() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    _, tree, _ = timing.restore_latest(train_state_tree(state, spec=True), device="cuda")
    load_train_state_(state, tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(all(torch.equal(p, kept[n]) for n, p in model.named_parameters()),
          "a restored train state differs from the one written")
    shutil.rmtree(os.path.join(root, "timing"))
    del state, model, tree
    gc.collect()
    torch.cuda.empty_cache()

    # resume: drop the final checkpoint, restart from step 10
    shutil.rmtree(mgr.directory(TRAIN_STEPS))
    (state2, losses2), lines = quiet(lambda: TR.main(args))
    check(f"[train] resumed from step {TRAIN_EVERY}" in lines and
          len(losses2) == TRAIN_STEPS - TRAIN_EVERY, f"the resume: {lines[:3]}")
    rel = abs(losses2[-1] - losses[-1]) / abs(losses[-1])
    diff = max((p - kept[n]).abs().max().item() for n, p in state2["params"].named_parameters())
    equal = all(torch.equal(p, kept[n]) for n, p in state2["params"].named_parameters())
    check(rel <= 1e-6 and diff <= 1e-7, f"the resumed run's step {TRAIN_STEPS}: loss rel "
                                        f"{rel:.3g}, params max |diff| {diff:.3g}")
    del state2, kept
    gc.collect()
    torch.cuda.empty_cache()
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_t["median"] / 1e3)
    print(f"[train] (a) {TRAIN_ARCH} f32 at full width ({n_params} parameters), launch/train.py "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} TokenBatcher tokens, lr "
          f"{TRAIN_LR} on the default warmup of 100 steps, deterministic algorithms: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first {k} mean {sum(losses[:k]) / k:.4f}, last {k} mean "
          f"{sum(losses[-k:]) / k:.4f}); step {fmt_spread(step_t)} (steps 2-{TRAIN_STEPS}, each "
          f"ending in its loss read) = {tok_s:.1f} tok/s; first step {1e3 * mon.times[0]:.1f} ms; "
          f"wall {train_s:.3f} s with 2 async checkpoints; peak memory {peak / 2**20:.1f} MiB; "
          f"no port kernel launched; {smi}")
    print(f"[train] (a) checkpoint of the whole train state (params, m, v, step; "
          f"{ck_bytes / 2**30:.3f} GiB): blocking write {write_s:.3f} s, restore to the card "
          f"{restore_s:.3f} s (page-cache warm); resumed from step {TRAIN_EVERY}: step "
          f"{TRAIN_STEPS} loss rel diff {rel:.3g}, params max |diff| {diff:.3g} "
          f"({'bit-equal' if equal else 'not bit-equal'}); {smi}")
    return {"losses": losses, "step": step_t, "tok_s": tok_s, "train_s": train_s,
            "peak_mib": peak / 2**20, "write_s": write_s, "restore_s": restore_s,
            "ckpt_gib": ck_bytes / 2**30, "resume_rel": rel, "resume_diff": diff,
            "resume_equal": equal, "ckpt": ckpt}


#: what phase 18 (d) holds itself to: the one-device trainer's first loss
#: and its peak memory a step under remat="block", from phase 15 (a)'s
#: remat turns (:func:`remat_turns`, run first)
PHASE15: dict = {}
#: (a), the recomputation: steps each trainer takes in turns (the first
#: builds and warms up)
REMAT_STEPS = 6


def remat_turns(torch, smi: str) -> dict:
    """(a), the recomputation: smollm-360m f32 uncut from the same init,
    trained with its config's ``remat="block"`` and with a
    ``remat="none"`` copy, a step of each in turns on launch/train.py's
    batches, under deterministic algorithms. Each step's peak memory
    (``max_memory_allocated`` after ``reset_peak_memory_stats``, less the
    other trainer's resident state: the trainer's own peak) and time
    (ending in its loss read; median and spread of steps 2 on); the losses
    equal and the two train states bit-equal after the steps; no port
    kernel launched."""
    from repro_torch.launch.train import _deterministic
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import TrainRunConfig, init_train_state, make_train_step

    cfg = _train_cfg()
    check(cfg.remat == "block", f"{TRAIN_ARCH}'s config has remat={cfg.remat!r}")
    run = TrainRunConfig(optimizer=OptimizerConfig(lr=TRAIN_LR, total_steps=REMAT_STEPS))
    data = _train_data(cfg)
    names = ("block", "none")
    times, peaks, losses = ({k: [] for k in names} for _ in range(3))
    with _deterministic(torch.device("cuda")):
        trainers = {k: [init_train_state(cfg.scaled(remat=k), run, 0, device="cuda"),
                        make_train_step(cfg.scaled(remat=k), run)] for k in names}
        resident = {k: _state_bytes(trainers[k][0]) for k in names}
        reset_counts()
        for i in range(REMAT_STEPS):
            batch = _cuda_batch(torch, data.batch(i)["tokens"])
            for k in (names if i % 2 == 0 else names[::-1]):
                other = names[1 - names.index(k)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainers[k][0], m = trainers[k][1](trainers[k][0], batch)
                losses[k].append(float(m["loss"]))
                times[k].append(1e3 * (time.perf_counter() - t0))
                peaks[k].append(torch.cuda.max_memory_allocated() - resident[other])
        counts = read_counts()
    check(not any(counts.values()), f"(a) remat: port kernels launched: {counts}")
    check(losses["block"] == losses["none"], f"(a) remat: losses {losses}")
    equal = _same_state(torch, trainers["block"][0], trainers["none"][0])
    check(equal, "(a) remat: the train states at block and none differ")
    step = {k: spread_ms(times[k][1:]) for k in names}
    peak = {k: max(peaks[k]) / 2**20 for k in names}
    PHASE15.update(first_loss=losses["block"][0], block_peak_mib=peak["block"])
    ratio = step["block"]["median"] / step["none"]["median"]
    print(f"[train] (a) remat, {TRAIN_ARCH} f32 uncut ({resident['block'] / 2**20:.1f} MiB of "
          f"params, m and v), {REMAT_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} each, in turns "
          f"from the same init, deterministic algorithms: remat=\"block\" (a checkpoint a "
          f"layer) step {fmt_spread(step['block'])}, peak {peak['block']:.1f} MiB; "
          f"remat=\"none\" step {fmt_spread(step['none'])}, peak {peak['none']:.1f} MiB (steps "
          f"2-{REMAT_STEPS}, each ending in its loss read; a peak less the other trainer's "
          f"resident state); block / none {ratio:.3f}x the time, "
          f"{peak['none'] - peak['block']:.1f} MiB less at its peak; losses equal, the two "
          f"train states bit-equal after {REMAT_STEPS} steps; no port kernel launched; {smi}")
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    return {"step": step, "peak_mib": peak, "ratio": ratio, "losses": losses["block"]}


def calibrate_and_serve_trained(torch, smi: str, root: str, ckpt: str) -> dict:
    """(a), second half: launch/quantize.py --ckpt-dir calibrates the
    trained checkpoint (224 B5 solves, every site certified), launch/serve.py
    --ckpt-dir --artifact serves it through the paged engine, and the same
    trained artifact serves phase 7's trace (FIFO, float pages)."""
    from repro_torch.configs import get_config
    from repro_torch.interop import restore_params_
    from repro_torch.launch import quantize as Q
    from repro_torch.launch import serve as S
    from repro_torch.launch.search import f32_config
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import load_flat_artifact, packed_params_from_artifact
    from repro_torch.serving import PagedConfig, PagedEngine, Request, SamplerConfig

    cfg = f32_config(get_config(TRAIN_ARCH))
    sites = sites_per_forward(cfg)
    qdir = os.path.join(root, "q")
    reset_counts()
    t0 = time.perf_counter()
    report, _ = quiet(Q.main, ["--arch", TRAIN_ARCH, "--float32", "--ckpt-dir", ckpt, "--out",
                              qdir, "--calib-batches", str(CALIB_BATCHES), "--calib-batch-size",
                              str(CALIB_BATCH), "--seq", str(CALIB_SEQ), "--eval-batches",
                              str(EVAL_BATCHES), "--device", "cuda"])
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qcounts = read_counts()
    cert = report["cert"]
    check(qcounts["gpfq_solve"] == sites, f"{qcounts['gpfq_solve']} B5 launches calibrating "
                                         f"the checkpoint, expected {sites}")
    check(cert["ok"] and cert["n_certified"] == sites, f"certificates: {cert}")
    check(math.isfinite(report["float_ppl"]) and math.isfinite(report["quant_ppl"]),
          f"perplexities {report['float_ppl']} / {report['quant_ppl']}")
    print(f"[train] (a) launch/quantize.py --ckpt-dir (step {TRAIN_STEPS}): AXE-GPFQ of the "
          f"trained f32 {TRAIN_ARCH} on {CALIB_BATCHES} x {CALIB_BATCH} x {CALIB_SEQ} tokens, "
          f"{qcounts['gpfq_solve']} B5 launches, {cert['n_certified']} sites certified (min "
          f"headroom {cert['min_headroom_bits']:.4f} bits); perplexity float "
          f"{report['float_ppl']:.4f}, quantized {report['quant_ppl']:.4f} (ratio "
          f"{report['quant_ppl'] / report['float_ppl']:.4f}); launcher wall {quant_s:.3f} s "
          f"(calibration, two {EVAL_BATCHES}-batch evaluations, export); {smi}")

    art = os.path.join(qdir, "quantized")
    reset_counts()
    out, lines = quiet(S.main, ["--arch", TRAIN_ARCH, "--float32", "--ckpt-dir", ckpt,
                               "--artifact", art, "--paged", "--block-size", str(PAGED_BLOCK),
                               "--max-concurrency", str(PAGED_SLOTS), "--batch", str(BATCH),
                               "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW),
                               "--device", "cuda"])
    scounts = read_counts()
    check(f"[serve] restored step {TRAIN_STEPS}" in lines and out.shape == (BATCH,
                                                                            PROMPT + MAX_NEW)
          and scounts["w4a8_matmul"] > 0 and scounts["paged_decode_attention"] > 0,
          f"serve --ckpt-dir --artifact: {lines[:2]}, launches {scounts}")
    line = next(x for x in lines if "tok/s" in x)
    print(f"[train] (a) launch/serve.py --ckpt-dir --artifact --paged: {line.strip()}; "
          f"launches (warm-up and timed run) {scounts}; {smi}")

    model = T.init_model(cfg, 0, device="cuda")
    check(restore_params_(model, ckpt) == TRAIN_STEPS, "restore_params_ found no checkpoint")
    flat, meta = load_flat_artifact(art)
    served = packed_params_from_artifact(flat, model, cfg, meta=meta, strict=True)
    del model
    engine = PagedEngine(served, cfg, PagedConfig(
        block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
        chunk_max=PAGED_CHUNK), SamplerConfig(temperature=0.0), device="cuda")
    specs, _ = trace_specs(cfg)
    warm_paged(engine, specs[0][1])
    run = driven(torch, cfg, engine, [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs],
                 "act")
    print(f"[train] (a) the trained artifact through PagedEngine, phase 7's {TRAIN_ARCH} trace "
          f"({TRACE_REQUESTS} requests, prompts 8-300 tokens, 4-32 new, {PAGED_SLOTS} slots, "
          f"float pages): launches {run['counts']} ({run['ran']}), every page back on "
          f"the free list; decode step {run['step_ms']:.3f} ms, admits "
          f"{run['admit_ms_per_request']:.3f} ms a request, {run['tok_s']:.1f} tok/s, wall "
          f"{run['wall']:.3f} s, peak {run['peak_mib']:.1f} MiB; {smi}")
    del served, engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"report": report, "quant_s": quant_s, "b5": qcounts["gpfq_solve"],
            "serve_counts": scounts, "paged": run}


def trained_rung(torch, smi: str) -> dict:
    """(b) the paper-table recipe on tiny-lm-l, then AXE-GPFQ at P_I = 16:
    quantized against float perplexity on the recipe's eval batches, every
    site certified, the quantized perplexity under 1.5x the float one (the
    reference's end-to-end test's bound)."""
    from repro_torch.configs import get_config
    from repro_torch.core.axe import PTQConfig
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.optim import OptimizerConfig
    from repro_torch.quant.pipeline import calibrate_and_quantize, float_ppl, quantized_ppl
    from repro_torch.runtime import TrainRunConfig, init_train_state, make_train_step

    cfg = get_config(RUNG)
    run = TrainRunConfig(optimizer=OptimizerConfig(lr=RUNG_LR, warmup_steps=RUNG_WARMUP,
                                                   total_steps=RUNG_STEPS))
    data = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=RUNG_SEQ, global_batch=RUNG_BATCH,
                                   seed=RUNG_DATA_SEED))
    state = init_train_state(cfg, run, 0, device="cuda")
    step = make_train_step(cfg, run)
    batches = [torch.from_numpy(data.batch(i)["tokens"]).to("cuda") for i in range(RUNG_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = None
    for i, tokens in enumerate(batches):
        state, m = step(state, {"tokens": tokens})
        if i == 0:
            first = m["loss"].clone()
    last = float(m["loss"])
    train_s = time.perf_counter() - t0
    check(last < float(first), f"{RUNG}: the loss does not fall ({float(first)} -> {last})")
    model = state["params"].requires_grad_(False)
    calib = [data.batch(50_000 + i) for i in range(4)]
    evalb = list(data.eval_batches(4))
    ptq = PTQConfig(p_bits=16, algorithm="gpfq")
    reset_counts()
    t0 = time.perf_counter()
    qm = calibrate_and_quantize(model, cfg, calib, ptq, device="cuda")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    b5 = read_counts()["gpfq_solve"]
    fp, qp = float_ppl(model, cfg, evalb), quantized_ppl(qm, evalb)
    cert = qm.cert_summary()
    sites = sites_per_forward(cfg)
    check(b5 == sites and cert["ok"] and cert["n_certified"] == sites,
          f"{RUNG}: B5 {b5}, certificates {cert}")
    check(math.isfinite(fp) and math.isfinite(qp) and qp < 1.5 * fp,
          f"{RUNG}: quantized perplexity {qp} against float {fp}")
    print(f"[train] (b) {RUNG} (d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab}) trained with the paper-table recipe ({RUNG_STEPS} steps, batch "
          f"{RUNG_BATCH} x {RUNG_SEQ}, lr {RUNG_LR}, warmup {RUNG_WARMUP}, data seed "
          f"{RUNG_DATA_SEED}): loss {float(first):.4f} -> {last:.4f} in {train_s:.3f} s; "
          f"AXE-GPFQ W4A8 P_I=16 T={ptq.tile}: {b5} B5 launches, {cert['n_certified']} sites "
          f"certified, {calib_s:.3f} s; perplexity float {fp:.4f}, quantized {qp:.4f} (ratio "
          f"{qp / fp:.4f}); {smi}")
    del state, model, qm
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": (float(first), last), "train_s": train_s, "float_ppl": fp,
            "quant_ppl": qp, "b5": b5, "calib_s": calib_s}


def registry_model(torch, arch: str, smi: str) -> dict:
    """(c) one registry model, bf16 from a seeded init at full width cut to
    REGISTRY_LAYERS layers, RTN-packed: B1 bit-equal at every packed (K, N)
    at M = 4 and 256; batch 4 x prompt 64 + 16 new through the captured
    fixed-slot step (B1 exactly
    sites x 16, tokens equal to the eager host loop's), a replayed and an
    eager step in turns; then the short trace through the FIFO paged engine
    with float and int8 pages (B2/B3 exactly one a layer a decode step)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenBatcher
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes
    from repro_torch.serving import (
        GenerationEngine,
        PagedConfig,
        PagedEngine,
        Request,
        SamplerConfig,
    )

    greedy = SamplerConfig(temperature=0.0)
    cfg = replace(get_config(arch), n_layers=REGISTRY_LAYERS)
    sites = sites_per_forward(cfg)
    t0 = time.perf_counter()
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    b1_rows = b1_site_check(torch, arch, packed_site_shapes(model), smi, tag="registry")
    prompts = TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH,
                                      seed=0)).batch(0)["tokens"]
    engine = GenerationEngine(model, cfg, greedy, device="cuda")
    engine.generate(prompts, MAX_NEW)  # captures the bucket's step
    (bucket,) = engine._buckets.values()
    program = bucket.program
    reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, MAX_NEW)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["w4a8_matmul"] == sites * MAX_NEW and sum(counts.values()) ==
          counts["w4a8_matmul"], f"{arch}: launches in a generate {counts}, expected B1 "
                                 f"{sites} x {MAX_NEW} and nothing else")
    host = engine.generate_host_loop(prompts, MAX_NEW)
    check((out == host).all(), f"{arch}: the captured generate and the eager host loop differ")
    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        _, caches = T.prefill(model, {"tokens": tokens}, PROMPT + MAX_NEW)
        step_tok = torch.as_tensor(out[:, PROMPT:PROMPT + 1], device="cuda")
        engine._start(bucket, tokens)
        step_t = in_turns(torch, {"eager": lambda: T.decode_step(model, step_tok, caches,
                                                                  PROMPT),
                                  "replay": lambda: program.run(1)}, runs=6)
    del caches
    nbytes = packed_weight_bytes(cfg)

    specs = short_trace_specs(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]
    paged = {}
    for kv in ("act", "int8"):
        eng = PagedEngine(model, cfg, PagedConfig(
            block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, max_concurrency=PAGED_SLOTS,
            chunk_max=PAGED_CHUNK, kv_dtype=kv), greedy, device="cuda")
        warm_paged(eng, specs[0][1])
        paged[kv] = driven(torch, cfg, eng, reqs, kv, {"w4a8_matmul": sites})
        del eng
        gc.collect()
    hd, g = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    print(f"[registry] {arch} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads (hd {hd}, group {g}), d_ff {cfg.d_ff}, "
          f"{cfg.norm} + {cfg.act}, vocab {cfg.vocab}; bf16, seeded random init) RTN-packed in "
          f"{init_s:.3f} s: {sites} packed sites, packed_weight_bytes {nbytes['packed_bytes']} "
          f"(bf16 {nbytes['bf16_bytes']}); {smi}")
    print(f"[registry] {arch} fixed slot, batch {BATCH} x prompt {PROMPT} + {MAX_NEW} new: B1 "
          f"{counts['w4a8_matmul']} = {sites} a forward x {MAX_NEW}, tokens equal to the eager "
          f"host loop's; capture {1e3 * program.capture_s:.3f} ms ({program.device_ops} device "
          f"operations); generate {wall:.4f} s = {BATCH * MAX_NEW / wall:.1f} tok/s; decode "
          f"step replay {fmt_spread(step_t['replay'])}, eager {fmt_spread(step_t['eager'])}; "
          f"peak memory {peak / 2**20:.1f} MiB; {smi}")
    for kv, run in paged.items():
        print(f"[registry] {arch} paged FIFO, {kv} pages, the short trace: launches "
              f"{run['counts']} ({run['ran']}), every page back on the free list; decode step "
              f"{run['step_ms']:.3f} ms, admits {run['admit_ms_per_request']:.3f} ms a request, "
              f"{run['tok_s']:.1f} tok/s, wall {run['wall']:.3f} s, peak {run['peak_mib']:.1f} "
              f"MiB; {smi}")
    del model, engine, program, bucket
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "sites": sites, "b1_sites": b1_rows, "fixed_counts": counts,
            "tok_s": BATCH * MAX_NEW / wall, "step": step_t, "peak_mib": peak / 2**20,
            "packed_bytes": nbytes["packed_bytes"], "paged": paged}


def phase_training_slice(torch, smi: str, remat: dict) -> dict:
    """Phase 15: (a) train smollm-360m, checkpoint, resume, calibrate and
    serve the checkpoint (``remat``: its training at remat "block" and
    "none" in turns, :func:`remat_turns`, run beside the build); (b) the
    paper-table recipe's trained rung and its quantized perplexity; (c) the
    registry's models that fit the card."""
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "phase15")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        trained = train_and_resume(torch, smi, root)
        served = calibrate_and_serve_trained(torch, smi, root, trained["ckpt"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rung = trained_rung(torch, smi)
    registry = [registry_model(torch, arch, smi) for arch in REGISTRY_FULL]
    wall_s = time.perf_counter() - t_phase
    print(f"[train] phase 15 wall {wall_s:.3f} s")
    b1 = {"trained_paged": served["paged"]["counts"]["w4a8_matmul"],
          "trained_serve_launcher": served["serve_counts"]["w4a8_matmul"]}
    for r in registry:
        b1[r["arch"]] = {"fixed": r["fixed_counts"]["w4a8_matmul"],
                         "paged": [r["paged"][k]["counts"]["w4a8_matmul"]
                                   for k in ("act", "int8")]}
    return {"trained": trained, "served": served, "remat": remat, "rung": rung,
            "registry": registry, "wall_s": wall_s, "b1": b1,
            "b2": {"trained_paged": served["paged"]["counts"]["paged_decode_attention"],
                   "trained_serve_launcher": served["serve_counts"]["paged_decode_attention"],
                   **{r["arch"]: r["paged"]["act"]["counts"]["paged_decode_attention"]
                      for r in registry}},
            "b3": {r["arch"]: r["paged"]["int8"]["counts"]["paged_decode_attention_int8"]
                   for r in registry},
            "b5": {"trained_checkpoint": served["b5"], "trained_rung": rung["b5"]}}


MESH_A_ARCH, MESH_B_ARCH = "smollm-360m", "phi4-mini-3.8b"
#: (b) runs phi4-mini at full width cut to MESH_B_LAYERS of its 32 layers:
#: a gloo rank's eager step is its collectives, about 8 a layer
MESH_B_LAYERS = 8
#: a phase-16 engine's block-table row: the trace's longest request (300 +
#: 32 tokens) needs 6 pages, and the reference attention (the mesh rule)
#: gathers a slot's whole row, 512 pages at phi4's 32768-token default
MESH_MAX_PAGES = 8
#: seconds a phase-16 rank may take before the phase fails (and a gloo
#: collective waits for its peer)
MESH_RANK_TIMEOUT = 420


def mesh_driven(torch, cfg, engine, reqs, tag: str, per_forward=None) -> dict:
    """Serve ``reqs`` on a mesh (or its one-device twin) engine with the
    launch counters set to 0 just before and read just after: each counter
    of ``per_forward`` (default: B1 at the dense model's sites) exactly its
    launches a forward and nothing else, B2/B3 none (the reference
    attention, the mesh rule), every request complete and every page back
    on the free list. Returns the run's figures."""
    before = program_counts(engine)
    reset_counts()
    res, wall, spent = serve_timed(torch, engine, reqs)
    counts = read_counts()
    ran = {k: v - before[k] for k, v in program_counts(engine).items()}
    forwards = ran["steps"] + ran["admits"] + ran["suffix"] + ran["batch"] + ran["chunks"]
    per_forward = per_forward or {"w4a8_matmul": sites_per_forward(cfg)}
    check(all(counts[c] == n * forwards for c, n in per_forward.items())
          and sum(counts.values()) == sum(counts[c] for c in per_forward),
          f"{tag}: launches {counts} for {forwards} forwards of {per_forward} a forward, "
          f"and nothing else")
    for r in reqs:
        check(res[r.uid].size == r.prompt.size + r.max_new, f"{tag}: request {r.uid} incomplete")
    pool = engine.pool_state
    check(pool.free_top == 0 and not pool.page_rc.any()
          and engine.cache["free_list"].cpu().tolist() == pool.free_list.tolist(),
          f"{tag}: pages not all back on the free list")
    return {"res": res, "counts": counts, "ran": ran, "wall": wall,
            "step_ms": 1e3 * spent["chunk"] / max(ran["steps"], 1),
            "admit_ms_per_request": 1e3 * (spent["admit"] + spent["batch"]) / len(reqs),
            "digest": pool.digest()}


def mesh_paged_config(kv: str):
    from repro_torch.serving import PagedConfig

    return PagedConfig(block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS,
                       max_concurrency=PAGED_SLOTS, max_pages_per_seq=MESH_MAX_PAGES,
                       chunk_max=PAGED_CHUNK, kv_dtype=kv, attn_impl="reference")


def mesh_world_one(torch, smi: str, root: str) -> dict:
    """(a) NCCL at world size 1: ``parse_mesh_spec("auto")`` (one rank on
    the data axis), smollm-360m bf16 RTN at full width, phase 7's trace
    with float and int8 pages through the mesh engine, its decode step
    captured with the collectives inside, against a one-device engine
    with the same attention on the same trace: identical streams and
    digests (size-1 collectives are identities); then a decode chunk of
    each, replayed in turns."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.runtime import collectives
    from repro_torch.serving import PagedEngine, Request, SamplerConfig

    mesh = parse_mesh_spec("auto", device="cuda:0", init_method=f"file://{root}/rdv_a",
                           rank=0, world_size=1)
    check(mesh.backend == "nccl" and mesh.shape == {"data": 1},
          f"phase 16 (a): mesh {mesh.shape} over {mesh.backend}")
    greedy = SamplerConfig(temperature=0.0)
    cfg = get_config(MESH_A_ARCH)
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    specs, _ = trace_specs(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]
    prompts = [p[:PROMPT] for _, p, _ in specs if p.size >= PROMPT]
    out = {}
    try:
        for kv in ("act", "int8"):
            one = PagedEngine(model, cfg, mesh_paged_config(kv), greedy, device="cuda")
            meshed = PagedEngine(model, cfg, mesh_paged_config(kv), greedy, device="cuda",
                                 mesh=mesh)
            check(meshed.step_mode == "captured", f"(a) {kv}: step mode {meshed.step_mode}")
            warm_paged(one, specs[0][1])
            warm_paged(meshed, specs[0][1])  # the capture, collectives inside
            # the step a replay runs, eagerly once: the collectives it issues
            collectives.reset_counts()
            with torch.inference_mode():
                meshed._chunk(1, eager=True)
            step_calls, step_bytes = collectives.calls, collectives.nbytes
            nccl = sum("nccl" in n.lower() for n in meshed._program.names)
            run_one = mesh_driven(torch, cfg, one, reqs, f"(a) {kv} one device")
            run_mesh = mesh_driven(torch, cfg, meshed, reqs, f"(a) {kv} mesh")
            same = all(np.array_equal(run_mesh["res"][u], run_one["res"][u]) for u, _, _ in specs)
            check(same, f"(a) {kv}: the world-size-1 mesh engine's streams differ from the "
                        f"one-device engine's")
            check(run_mesh["digest"] == run_one["digest"], f"(a) {kv}: digests differ")
            turns = mesh_step_turns(torch, {"mesh": meshed, "one device": one}, prompts)
            out[kv] = {"counts": run_mesh["counts"], "one_counts": run_one["counts"],
                       "ran": run_mesh["ran"], "turns": turns, "step_calls": step_calls,
                       "step_bytes": step_bytes, "nccl_nodes": nccl,
                       "capture_ms": 1e3 * meshed._program.capture_s,
                       "device_ops": meshed._program.device_ops,
                       "one_device_ops": one._program.device_ops,
                       "wall": run_mesh["wall"], "one_wall": run_one["wall"]}
            print(f"[mesh] (a) {MESH_A_ARCH} {kv} pages, NCCL world size 1, mesh "
                  f"{mesh.shape}: phase 7's trace, streams and digest identical to the "
                  f"one-device engine (reference attention both); B1 {run_mesh['counts']['w4a8_matmul']}"
                  f" ({sites_per_forward(cfg)} a forward), B2/B3 0; decode step captured, "
                  f"{step_calls} collectives of {step_bytes} bytes a step inside it, "
                  f"{nccl} NCCL kernel nodes ({meshed._program.device_ops} device operations "
                  f"against the one-device step's {one._program.device_ops}); replayed step mesh "
                  f"{fmt_spread(turns['mesh'])}, one device {fmt_spread(turns['one device'])}; "
                  f"serve wall {run_mesh['wall']:.3f} s against {run_one['wall']:.3f} s; {smi}")
            del one, meshed
            gc.collect()
    finally:
        dist.destroy_process_group()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_step_turns(torch, engines: dict, prompts, runs: int = 6) -> dict:
    """Per-step host-clock time of a decode chunk of PAGED_CHUNK replayed
    steps over PAGED_SLOTS live slots of each engine, in turns."""
    import numpy as np
    from repro_torch.models.layers import use_packed_backend
    from repro_torch.serving import Request

    with torch.inference_mode():
        for engine in engines.values():
            sched = engine._make_scheduler()
            for b in range(PAGED_SLOTS):
                sched.submit(Request(uid=20_000 + b, prompt=np.asarray(prompts[b % len(prompts)]),
                                     max_new=2 * runs * PAGED_CHUNK + 1))
            with use_packed_backend(engine.backend):
                adm = sched.try_admit()
                while adm is not None:
                    engine._do_admit(adm)
                    adm = sched.try_admit()
            check(len(sched.active) == PAGED_SLOTS, "the timing slots were not all admitted")
        return in_turns(torch, {n: (lambda e=e: e._chunk(PAGED_CHUNK))
                                for n, e in engines.items()}, runs=runs, scale=PAGED_CHUNK)


def mesh_two_ranks(torch, smi: str, root: str) -> dict:
    """(b) two ranks sharing the card over gloo, mesh (1, 2): B1 bit-equal
    at every sharded (K, N) of phi4-mini-3.8b (here, before the ranks
    start: the kernels are built in this process, and the build's lock
    holds within a process only); then the ranks (this script with
    ``--mesh-rank``) serve the short trace with float and int8 pages at
    full width (MESH_B_LAYERS layers), their streams tie-limited against a one-device engine on
    the card and their digests equal."""
    cfg_shapes = mesh_site_shapes(_config(MESH_B_ARCH), (1, 2))[0]
    b1_rows = b1_site_check(torch, f"{MESH_B_ARCH} (1, 2) shard", cfg_shapes, smi, tag="mesh")
    gc.collect()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                               "--mesh-root", root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=MESH_RANK_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n(timed out)")
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if line.startswith("[mesh]"):
                print(line)
        check(p.returncode == 0, f"phase 16 (b): rank {r} failed (rc {p.returncode}):\n"
                                 f"{log[-4000:]}")
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(2)]
    for kv in ("act", "int8"):
        check(ranks[0][kv]["digest"] == ranks[1][kv]["digest"], f"(b) {kv}: digests differ")
    return {"b1": b1_rows, "ranks": ranks}


def _config(arch):
    from repro_torch.configs import get_config

    return get_config(arch)


def mesh_rank_main(argv) -> int:
    """One rank of phase 16 (b): ``--mesh-rank R --mesh-root DIR``."""
    from dataclasses import replace

    import numpy as np
    import torch

    rank = int(argv[argv.index("--mesh-rank") + 1])
    root = argv[argv.index("--mesh-root") + 1]
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params, packed_weight_bytes
    from repro_torch.runtime.collectives import gather_dim
    from repro_torch.serving import PagedEngine, Request, SamplerConfig

    t0 = time.perf_counter()
    mesh = make_mesh((1, 2), device="cuda:0", backend="gloo",
                     init_method=f"file://{root}/rdv_b", rank=rank, world_size=2,
                     timeout=MESH_RANK_TIMEOUT)
    greedy = SamplerConfig(temperature=0.0)
    cfg = replace(_config(MESH_B_ARCH), n_layers=MESH_B_LAYERS)
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    engines = {kv: PagedEngine(model, cfg, mesh_paged_config(kv), greedy, device="cuda:0",
                               mesh=mesh) for kv in ("act", "int8")}
    placed = sum(t.numel() * t.element_size() for t in engines["act"].model.state_dict().values())
    half = packed_weight_bytes(cfg)["packed_bytes"] / 2
    if rank:
        del model  # rank 0 keeps the full model for its one-device engine
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    specs = short_trace_specs(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]
    out = {"setup_s": setup_s, "placed_bytes": placed, "half_packed_bytes": half}
    for kv, meshed in engines.items():
        check(meshed.step_mode == "eager (gloo)", f"(b) {kv}: step mode {meshed.step_mode}")
        torch.cuda.reset_peak_memory_stats()
        with ReplayRecorder(meshed) as rec:
            meshed.serve([Request(uid=10_000, prompt=specs[0][1][:8], max_new=2)])
            run = mesh_driven(torch, cfg, meshed, reqs, f"(b) {kv} rank {rank}")
        peak = torch.cuda.max_memory_allocated()
        h = hashlib.blake2b(digest_size=16)
        for u, _, _ in specs:
            h.update(np.asarray(run["res"][u], np.int32).tobytes())
        h.update(run["digest"].encode())
        mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8).to("cuda:0")
        every = gather_dim(mine[None], 0, mesh, mesh.axis_names).cpu()
        check(all(torch.equal(every[r], every[0]) for r in range(2)),
              f"(b) {kv}: the ranks' digests differ")
        rec_out = {"counts": run["counts"], "ran": run["ran"], "step_ms": run["step_ms"],
                   "admit_ms_per_request": run["admit_ms_per_request"], "wall": run["wall"],
                   "peak_mib": peak / 2**20, "digest": h.hexdigest()}
        if rank == 0:
            one = PagedEngine(model, cfg, mesh_paged_config(kv), greedy, device="cuda:0")
            with ReplayRecorder(one) as rec_one:
                warm_paged(one, specs[0][1])
                run_one = mesh_driven(torch, cfg, one, reqs, f"(b) {kv} one device")
            tie = tie_vs(specs, run["res"], rec.rows, run_one["res"], rec_one.rows, cfg.vocab)
            # the logits of each step whose history both runs share
            same = []
            for u, p, n in specs:
                a, b = run["res"][u][p.size:], run_one["res"][u][p.size:]
                first = next((t for t in range(n) if a[t] != b[t]), n - 1)
                same += [(u, t) for t in range(first + 1)]
            rel = max(((rec.rows[k] - rec_one.rows[k]).abs().max()
                       / rec_one.rows[k].abs().max()).item() for k in same)
            rec_out.update({"tie": {k: v for k, v in tie.items() if k != "partings"},
                            "partings": tie["partings"], "logits_max_rel_err": rel,
                            "one_step_ms": run_one["step_ms"], "one_wall": run_one["wall"]})
            print(f"[mesh] (b) {MESH_B_ARCH} {kv} pages, 2 ranks sharing the card over gloo, "
                  f"mesh (1, 2): the short trace, {tie['agree']} / {tie['total']} tokens "
                  f"agree with the one-device engine (tie band {tie['band']:.4f}, partings "
                  f"{tie['partings']}), logits' largest relative error {rel:.3e} over the steps "
                  f"whose history both share; B1 "
                  f"{run['counts']['w4a8_matmul']} a rank ({sites_per_forward(cfg)} a forward); "
                  f"eager step {run['step_ms']:.3f} ms (gloo stages every collective through "
                  f"the host: not an NCCL figure) against the one-device captured step "
                  f"{run_one['step_ms']:.3f} ms; digests equal on both ranks; {_smi()}")
            del one
        print(f"[mesh] (b) rank {rank} {kv}: placed weights {placed / 2**20:.1f} MiB against "
              f"half the packed weight bytes {half / 2**20:.1f} MiB; peak during the serve "
              f"{peak / 2**20:.1f} MiB{' (this rank also holds the full model)' if rank == 0 else ''}"
              f"; serve wall {run['wall']:.3f} s; {_smi()}")
        out[kv] = rec_out
        gc.collect()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def phase_mesh_slice(torch, smi: str) -> dict:
    """Phase 16: mesh-sharded paged serving over torch.distributed: (a)
    NCCL at world size 1, (b) two gloo ranks sharing the card."""
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "phase16")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a = mesh_world_one(torch, smi, root)
    t_a = time.perf_counter() - t0
    b = mesh_two_ranks(torch, smi, root)
    wall_s = time.perf_counter() - t0
    print(f"[mesh] phase 16 wall {wall_s:.3f} s ((a) {t_a:.3f} s, (b) {wall_s - t_a:.3f} s)")
    return {"a": a, "b": b, "wall_s": wall_s,
            "b1": {"a": {kv: a[kv]["counts"]["w4a8_matmul"] for kv in a},
                   "b": [{kv: r[kv]["counts"]["w4a8_matmul"] for kv in ("act", "int8")}
                         for r in b["ranks"]]}}


# ---------------------------------------------------------------------------
# Phase 17: MoE and recurrent patterns under the mesh
# ---------------------------------------------------------------------------
#: (E, K, N) a rank's B1e/B4e take of granite's expert sites: 20 experts a
#: rank on (2, 1) (expert-parallel); all 40 on (1, 2), wg/wu N-sharded and
#: wd K-sharded (the accumulator-only form)
GRANITE_SHARD_SITES = [(20, 1536, 512), (20, 512, 1536), (40, 1536, 256), (40, 256, 1536)]
#: seconds the two phase-17 ranks may take together
FAMILY_RANK_TIMEOUT = 600


def packed_per_forward(model) -> dict:
    """Launches a forward of a packed model: B1 at its dense sites, B1e at
    its expert stacks (one launch a stacked site)."""
    from repro_torch.models.layers import PackedLinear

    sites = [m for m in model.modules() if isinstance(m, PackedLinear)]
    out = {"w4a8_matmul": sum(not m.stacked for m in sites)}
    stacked = sum(m.stacked for m in sites)
    if stacked:
        out["w4a8_expert_matmul"] = stacked
    return out


def mesh_site_shapes(cfg, shape) -> tuple[list, list]:
    """The distinct local (K, N) of a model's packed dense sites and (E, K,
    N) of its expert stacks on a mesh under the serving rules (what one
    rank's B1 and B1e launches take), from the RTN-packed model on meta
    tensors."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import PackedLinear
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.runtime import sharding as S

    model = pack_decode_params(T.abstract_params(cfg))
    mesh = make_mesh(shape, abstract=True)
    specs = S.param_shardings(model, mesh, S.SERVING_QUANT_RULES)
    dense, stacked = [], []
    for name, mod in model.named_modules():
        if not isinstance(mod, PackedLinear):
            continue
        sizes = [mesh.axes_size(S.spec_axes(e)) for e in specs[name + ".packed"]]
        kn = (2 * mod.packed.shape[-2] // sizes[-2], mod.packed.shape[-1] // sizes[-1])
        if mod.stacked:
            stacked.append((mod.packed.shape[0] // sizes[0], *kn))
        else:
            dense.append(kn)
    return list(dict.fromkeys(dense)), list(dict.fromkeys(stacked))


def stacked_bytes(model) -> int:
    """Bytes of a model's expert-stacked site buffers (codes, scales,
    col_sums and the rest)."""
    from repro_torch.models.layers import PackedLinear

    return sum(t.numel() * t.element_size() for m in model.modules()
               if isinstance(m, PackedLinear) and m.stacked for t in m.buffers())


def expert_shard_check(torch, smi: str) -> list[dict]:
    """B1e and B4e bit-equal to their plain versions at every (E, K, N) of
    GRANITE_SHARD_SITES and M in {1, 4, 64}, with the accumulator-only form
    of both (the K-sharded stacked site's partial); at M = 4 and 64 B1e's,
    B4e's and the accumulator form's time (cold L2), one bf16 ``torch.bmm``
    on the dequantized stack and the byte bound."""
    from repro_torch.core.sparsity import mask_2to4
    from repro_torch.kernels import w4a8_mm as W

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    for e, k, n in GRANITE_SHARD_SITES:
        q = torch.randint(-8, 8, (e, k, n), generator=gen, device=dev, dtype=torch.int8)
        qs = q * mask_2to4(q)
        wp, (sp, meta) = W.pack_int4(q), W.compress_2to4(qs)
        col, scol = q.sum(1, dtype=torch.int32), qs.sum(1, dtype=torch.int32)
        scale = torch.rand((e, n), generator=gen, device=dev) * 0.05 + 1e-3
        act_scale = torch.rand(e, generator=gen, device=dev) * 0.04 + 0.01
        zp = torch.randint(0, 256, (e,), generator=gen, device=dev).float()
        for m in (1, BATCH, PROMPT):
            x = torch.randint(0, 256, (e, m, k), generator=gen, device=dev).to(torch.uint8)
            x[e // 2] = 0  # an expert that got no token
            for name, fn, ws, cs in (("b1e", W.w4a8_expert_matmul, (wp,), col),
                                     ("b4e", W.w4a8_sparse_expert_matmul, (sp, meta), scol)):
                # the full epilogue, then the accumulator-only form (ones and zeros an expert)
                for form, qargs, out in (
                        ("epilogue", (scale, cs, act_scale, zp), torch.bfloat16),
                        ("accumulator", (torch.ones_like(scale), cs, torch.ones_like(act_scale),
                                         torch.zeros_like(zp)), torch.float32)):
                    args = (x, *ws, *qargs)
                    y = fn(*args, out_dtype=out)
                    r = fn(*args, out_dtype=out, reference=True)
                    check(torch.equal(y, r), f"{name} != plain at a granite shard E={e} M={m} "
                                             f"K={k} N={n} ({form} form)")
            if m == 1:
                continue
            sw, corr = W._expert_epilogue(scale, col, act_scale, zp, e, n)
            _, scorr = W._expert_epilogue(scale, scol, act_scale, zp, e, n)
            one, nil = torch.ones_like(sw), torch.zeros_like(corr)
            row = {"E": e, "M": m, "K": k, "N": n,
                   "ms": time_ms(torch, lambda: W._launch(
                       "w4a8_expert_matmul", x, (wp,), sw, corr, torch.bfloat16, 2),
                       flush=flush),
                   "b4e_ms": time_ms(torch, lambda: W._launch(
                       "w4a8_sparse_expert_matmul", x, (sp, meta), sw, scorr, torch.bfloat16,
                       4), flush=flush),
                   "acc_ms": time_ms(torch, lambda: W._launch(
                       "w4a8_expert_matmul", x, (wp,), one, nil, torch.float32, 2),
                       flush=flush)}
            row.update(plan_fields(W.w4a8_expert_plan(m, n, k, e, True, W._sm_count(0))))
            xb = x.to(torch.bfloat16)
            wb = (q.to(torch.bfloat16) * scale[:, None, :].to(torch.bfloat16)).contiguous()
            row["library_ms"] = time_ms(torch, lambda: torch.bmm(xb, wb), flush=flush)
            row["bound_ms"], row["bound_by"] = expert_bound_ms(e, m, k, n)
            rows.append(row)
            print(f"[family] B1e/B4e at granite's shard E={e} M={m:2d} K={k:4d} N={n:4d}: "
                  f"bit-equal (and the accumulator-only form); B1e {row['ms']:.5f} ms, B4e "
                  f"{row['b4e_ms']:.5f} ms, accumulator form {row['acc_ms']:.5f} ms, bf16 bmm "
                  f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
                  f"({row['bound_by']}), {row['plan']}; {smi}")
    del flush
    return rows


def family_world_one(torch, smi: str, root: str) -> dict:
    """(a) NCCL at world size 1: granite-moe-3b-a800m bf16 RTN at full width
    through ``PagedEngine(mesh=)``, phase 7's trace on float pages, its
    decode step captured with B1e (and the collectives) inside, against a
    one-device engine with the same attention: streams and digest
    identical, B1e and B1 exactly their sites a forward, the captured
    step's nodes by name."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.serving import PagedEngine, Request, SamplerConfig
    from repro_torch.serving.graphs import COUNTERS, count_kernels

    mesh = parse_mesh_spec("auto", device="cuda:0", init_method=f"file://{root}/rdv_a",
                           rank=0, world_size=1)
    check(mesh.backend == "nccl" and mesh.shape == {"data": 1},
          f"phase 17 (a): mesh {mesh.shape} over {mesh.backend}")
    greedy = SamplerConfig(temperature=0.0)
    cfg = _config(GRANITE)
    model = pack_decode_params(T.init_model(cfg, 0, device="cuda"))
    per_forward = packed_per_forward(model)
    specs, _ = trace_specs(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]
    prompts = [p[:PROMPT] for _, p, _ in specs if p.size >= PROMPT]
    try:
        one = PagedEngine(model, cfg, mesh_paged_config("act"), greedy, device="cuda")
        meshed = PagedEngine(model, cfg, mesh_paged_config("act"), greedy, device="cuda",
                             mesh=mesh)
        check(meshed.step_mode == "captured", f"(a): step mode {meshed.step_mode}")
        warm_paged(one, specs[0][1])
        warm_paged(meshed, specs[0][1])  # the capture, B1e and the collectives inside
        nodes = dict(zip((fn.__name__ for fn, _, _ in COUNTERS),
                         count_kernels(meshed._program.names)))
        check(nodes["w4a8_expert_matmul"] == per_forward["w4a8_expert_matmul"]
              and nodes["w4a8_matmul"] == per_forward["w4a8_matmul"],
              f"(a): the captured step's kernel nodes {nodes}, {per_forward} a forward wanted")
        run_one = mesh_driven(torch, cfg, one, reqs, "(a) one device", per_forward)
        run_mesh = mesh_driven(torch, cfg, meshed, reqs, "(a) mesh", per_forward)
        check(all(np.array_equal(run_mesh["res"][u], run_one["res"][u]) for u, _, _ in specs),
              "(a): the world-size-1 mesh engine's streams differ from the one-device engine's")
        check(run_mesh["digest"] == run_one["digest"], "(a): digests differ")
        turns = mesh_step_turns(torch, {"mesh": meshed, "one device": one}, prompts)
        out = {"counts": run_mesh["counts"], "ran": run_mesh["ran"], "nodes": nodes,
               "turns": turns, "capture_ms": 1e3 * meshed._program.capture_s,
               "device_ops": meshed._program.device_ops,
               "one_device_ops": one._program.device_ops, "wall": run_mesh["wall"],
               "one_wall": run_one["wall"], "per_forward": per_forward}
        print(f"[family] (a) {GRANITE} float pages, NCCL world size 1, mesh {mesh.shape}: "
              f"phase 7's trace, streams and digest identical to the one-device engine "
              f"(reference attention both); B1e {run_mesh['counts']['w4a8_expert_matmul']} "
              f"({per_forward['w4a8_expert_matmul']} a forward), B1 "
              f"{run_mesh['counts']['w4a8_matmul']} ({per_forward['w4a8_matmul']} a forward); "
              f"the captured step holds {nodes['w4a8_expert_matmul']} B1e and "
              f"{nodes['w4a8_matmul']} B1 kernel nodes ({meshed._program.device_ops} device "
              f"operations against the one-device step's {one._program.device_ops}), capture "
              f"{out['capture_ms']:.1f} ms; replayed step mesh {fmt_spread(turns['mesh'])}, one "
              f"device {fmt_spread(turns['one device'])}; serve wall {run_mesh['wall']:.3f} s "
              f"against {run_one['wall']:.3f} s; {smi}")
        del one, meshed
    finally:
        dist.destroy_process_group()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_rank_serve(torch, mesh, arch: str, rank: int, tag: str) -> dict:
    """One model at full width, bf16 RTN, on this rank's shard: the short
    trace (``short_trace_specs``) on float pages through the gloo mesh
    engine (B1/B1e exactly
    their sites a forward, its logits recorded), the placed expert bytes
    and recurrent state against the one-device figures, the serve's peak
    memory, the digest held across the ranks; rank 0 then runs the
    one-device engine on the card and holds the streams tie-limited."""
    import numpy as np
    from repro_torch.models import transformer as T
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.runtime.collectives import gather_dim
    from repro_torch.serving import PagedEngine, Request, SamplerConfig

    greedy = SamplerConfig(temperature=0.0)
    cfg = _config(arch)
    t0 = time.perf_counter()
    model = pack_decode_params(T.init_model(cfg, 0, device=mesh.device))
    per_forward = packed_per_forward(model)
    gc.collect()
    torch.cuda.empty_cache()
    meshed = PagedEngine(model, cfg, mesh_paged_config("act"), greedy, device=mesh.device,
                         mesh=mesh)
    check(meshed.step_mode == ("eager (gloo)" if mesh.device.type == "cuda" else "eager"),
          f"{tag}: step mode {meshed.step_mode}")
    placed_experts, half_experts = stacked_bytes(meshed.model), stacked_bytes(model) / 2
    if rank:
        del model  # rank 0 keeps the full model for its one-device engine
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    specs = short_trace_specs(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=n) for u, p, n in specs]
    torch.cuda.reset_peak_memory_stats()
    with ReplayRecorder(meshed) as rec:
        meshed.serve([Request(uid=10_000, prompt=specs[0][1][:8], max_new=2)])
        run = mesh_driven(torch, cfg, meshed, reqs, f"{tag} rank {rank}", per_forward)
    peak = torch.cuda.max_memory_allocated()
    check(run["ran"]["admits"] == len(reqs) > meshed.paged.max_concurrency,
          f"{tag}: {run['ran']['admits']} admits of {len(reqs)} requests in "
          f"{meshed.paged.max_concurrency} slots (the trace must reuse freed slots)")
    h = hashlib.blake2b(digest_size=16)
    for u, _, _ in specs:
        h.update(np.asarray(run["res"][u], np.int32).tobytes())
    h.update(run["digest"].encode())
    mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8).to(mesh.device)
    every = gather_dim(mine[None], 0, mesh, mesh.axis_names).cpu()
    check(all(torch.equal(every[r], every[0]) for r in range(every.shape[0])),
          f"{tag}: the ranks' digests differ")
    slots = meshed.paged.max_concurrency
    out = {"arch": arch, "counts": run["counts"], "ran": run["ran"], "step_ms": run["step_ms"],
           "admit_ms_per_request": run["admit_ms_per_request"], "wall": run["wall"],
           "peak_mib": peak / 2**20, "digest": h.hexdigest(), "setup_s": setup_s,
           "per_forward": per_forward, "placed_expert_bytes": placed_experts,
           "half_expert_bytes": half_experts,
           "state_mib_slot": meshed.state_bytes / slots / 2**20,
           "state_mib_slot_one_device": meshed.state_bytes_one_device / slots / 2**20}
    if rank == 0:
        one = PagedEngine(model, cfg, mesh_paged_config("act"), greedy, device=mesh.device)
        with ReplayRecorder(one) as rec_one:
            warm_paged(one, specs[0][1])
            run_one = mesh_driven(torch, cfg, one, reqs, f"{tag} one device", per_forward)
        tie = tie_vs(specs, run["res"], rec.rows, run_one["res"], rec_one.rows, cfg.vocab)
        same = []
        for u, p, n in specs:
            a, b = run["res"][u][p.size:], run_one["res"][u][p.size:]
            first = next((t for t in range(n) if a[t] != b[t]), n - 1)
            same += [(u, t) for t in range(first + 1)]
        rel = max(((rec.rows[k] - rec_one.rows[k]).abs().max()
                   / rec_one.rows[k].abs().max()).item() for k in same)
        out.update({"tie": {k: v for k, v in tie.items() if k != "partings"},
                    "partings": tie["partings"], "logits_max_rel_err": rel,
                    "one_step_ms": run_one["step_ms"], "one_wall": run_one["wall"]})
        print(f"[family] {tag} {arch} float pages, 2 ranks sharing the card over gloo, mesh "
              f"{tuple(mesh.axis_sizes)}: the short trace ({len(specs)} requests in "
              f"{PAGED_SLOTS} slots, at most {SHORT_MAX_NEW} new tokens each), "
              f"{tie['agree']} / {tie['total']} tokens agree with the one-device engine "
              f"(tie band {tie['band']:.4f}, partings "
              f"{tie['partings']}), logits' largest relative error {rel:.3e} over the steps "
              f"whose history both share; {per_forward} a forward on a rank; eager step "
              f"{run['step_ms']:.3f} ms (gloo stages every collective through the host) "
              f"against the one-device captured step {run_one['step_ms']:.3f} ms; digests "
              f"equal on both ranks; {_smi()}")
        del one, model
    held = (f"placed expert stacks {placed_experts / 2**20:.1f} MiB against half the stacks "
            f"{half_experts / 2**20:.1f} MiB; " if half_experts else "")
    held += (f"recurrent state {out['state_mib_slot']:.3f} MiB a slot against "
             f"{out['state_mib_slot_one_device']:.3f} on one device; "
             if meshed.state_bytes_one_device else "")
    print(f"[family] {tag} rank {rank} {arch}: {held}peak during the serve {peak / 2**20:.1f} "
          f"MiB{' (this rank also holds the full model)' if rank == 0 else ''}; serve wall "
          f"{run['wall']:.3f} s, set-up {setup_s:.1f} s; {_smi()}")
    del meshed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_rank_mamba(torch, mesh, rank: int) -> dict:
    """(d) the Jamba-width Mamba block (d_in 16384) on this rank's 8192
    channels: a 4 x 64 parallel prefill and 16 decode steps from its state
    (B1 4 a forward), against the one-device block on the same input
    (relative L2 within MAMBA_STEP_TOL: the outputs, and this rank's
    channels of the SSM state)."""
    from dataclasses import replace

    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.config import LayerSpec
    from repro_torch.models.layers import use_packed_backend
    from repro_torch.quant.serve_packed import pack_decode_params
    from repro_torch.runtime import sharding as shardlib

    cfg = replace(_config(JAMBA), name="jamba-mamba-block", n_layers=1, moe=None, vocab=128,
                  pattern=(LayerSpec("mamba", "none"),))
    model = pack_decode_params(T.init_model(cfg, 0, device=mesh.device))
    placed = shardlib.shard_model(model, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(MAMBA_SEEDS[0])
    x = torch.randn((BATCH, PROMPT + MAX_NEW, cfg.d_model), generator=gen,
                    device=mesh.device).to(torch.bfloat16)

    def run(p):
        with torch.inference_mode(), use_packed_backend("kernel"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            y_pre, st = S.mamba(p, x[:, :PROMPT], cfg, return_state=True)
            torch.cuda.synchronize()
            pre_ms = 1e3 * (time.perf_counter() - t0)
            pre_b1 = read_counts()["w4a8_matmul"]
            reset_counts()
            ys, step_ms = [], []
            for t in range(PROMPT, PROMPT + MAX_NEW):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ys.append(S.mamba_decode(p, x[:, t:t + 1], cfg, st["conv"], st["ssm"])[0])
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
        return (y_pre, torch.cat(ys, dim=1), st["ssm"], pre_ms, spread_ms(step_ms[1:]),
                (pre_b1, read_counts()["w4a8_matmul"]))

    one, mine = run(model.layers[0].mixer), run(placed.layers[0].mixer)
    sh = placed.layers[0].mixer._shard

    def rel(a, b):
        return (torch.linalg.vector_norm((a - b).float())
                / torch.linalg.vector_norm(b.float())).item()

    errs = (rel(mine[0], one[0]), rel(mine[1], one[1]),
            rel(mine[2], shardlib.local_slice(one[2], (None, sh.ch, None), mesh)))
    check(mine[5] == (4, 4 * MAX_NEW), f"(d) rank {rank}: B1 launches (prefill, decode) "
                                       f"{mine[5]}, (4, {4 * MAX_NEW}) wanted")
    check(all(math.isfinite(v) and v <= MAMBA_STEP_TOL for v in errs),
          f"(d) rank {rank}: the sharded Mamba block against its one-device run: prefill "
          f"{errs[0]:.3e}, decode {errs[1]:.3e}, SSM state {errs[2]:.3e} (relative L2, "
          f"tolerance {MAMBA_STEP_TOL})")
    d_in = cfg.ssm.expand * cfg.d_model
    print(f"[family] (d) rank {rank}: the Mamba block at {JAMBA}'s widths on {d_in // 2} of "
          f"{d_in} channels, mesh {tuple(mesh.axis_sizes)}: relative L2 against its "
          f"one-device run prefill {errs[0]:.3e}, decode {errs[1]:.3e}, SSM state {errs[2]:.3e} "
          f"(tolerance {MAMBA_STEP_TOL}); prefill {BATCH} x {PROMPT} {mine[3]:.3f} ms (one "
          f"device {one[3]:.3f}), decode step {fmt_spread(mine[4])} (one device "
          f"{fmt_spread(one[4])}); B1 {mine[5]}; {_smi()}")
    out = {"errs": errs, "prefill_ms": mine[3], "one_prefill_ms": one[3], "step": mine[4],
           "one_step": one[4], "b1": mine[5]}
    del model, placed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_rank_main(argv) -> int:
    """One rank of phase 17 (b)-(d): ``--family-rank R --mesh-root DIR``:
    granite on a (2, 1) mesh, then xlstm-350m and the Mamba block on a
    (1, 2) mesh of the same two gloo ranks."""
    import torch

    rank = int(argv[argv.index("--family-rank") + 1])
    root = argv[argv.index("--mesh-root") + 1]
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    init = dict(device="cuda:0", backend="gloo", init_method=f"file://{root}/rdv_17",
                rank=rank, world_size=2, timeout=FAMILY_RANK_TIMEOUT)
    out, walls = {}, {}
    t0 = time.perf_counter()
    out["b"] = family_rank_serve(torch, make_mesh((2, 1), **init), GRANITE, rank, "(b)")
    walls["b"] = time.perf_counter() - t0
    mesh = make_mesh((1, 2), **init)
    t0 = time.perf_counter()
    out["c"] = family_rank_serve(torch, mesh, XLSTM, rank, "(c)")
    walls["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = family_rank_mamba(torch, mesh, rank)
    walls["d"] = time.perf_counter() - t0
    out["walls"] = walls
    with open(os.path.join(root, f"family{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def family_mesh_start(torch, smi: str) -> dict:
    """Phase 17, its first part: MoE and recurrent patterns under the mesh.
    (a) granite at NCCL world size 1; B1e/B4e at granite's expert shards, B1
    at xlstm-350m's and the Mamba block's (1, 2) shards (here, before the
    ranks start: the kernels are built in this process); then two gloo
    ranks sharing the card are started: (b) granite expert-parallel on (2,
    1), (c) xlstm-350m on (1, 2), (d) the Jamba-width Mamba block on (1,
    2), read by :func:`family_mesh_finish`."""
    from dataclasses import replace

    from repro_torch.models.config import LayerSpec

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "phase17")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a = family_world_one(torch, smi, root)
    walls = {"a": time.perf_counter() - t0}
    t1 = time.perf_counter()
    expert_rows = expert_shard_check(torch, smi)
    block = replace(_config(JAMBA), name="jamba-mamba-block", n_layers=1, moe=None, vocab=128,
                    pattern=(LayerSpec("mamba", "none"),))
    b1_rows = {what: b1_site_check(torch, f"{what} (1, 2) shard",
                                   mesh_site_shapes(cfg, (1, 2))[0], smi, tag="family")
               for what, cfg in ((XLSTM, _config(XLSTM)), ("the Mamba block", block))}
    walls["kernels"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--family-rank",
                               str(r), "--mesh-root", root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    CHILDREN.extend(procs)
    return {"t0": t0, "root": root, "a": a, "walls": walls, "expert_rows": expert_rows,
            "b1_rows": b1_rows, "procs": procs, "t_started": time.perf_counter()}


def family_mesh_finish(torch, smi: str, started: dict) -> dict:
    """Phase 17, its second part: the ranks of (b), (c) and (d) read (what
    ran here since :func:`family_mesh_start` ran beside them)."""
    t0, root, a, walls, procs = (started[k] for k in ("t0", "root", "a", "walls", "procs"))
    expert_rows, b1_rows, t1 = started["expert_rows"], started["b1_rows"], started["t_started"]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=FAMILY_RANK_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n(timed out)")
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if line.startswith("[family]"):
                print(line)
        check(p.returncode == 0, f"phase 17: rank {r} failed (rc {p.returncode}):\n"
                                 f"{log[-4000:]}")
    ranks = [json.load(open(os.path.join(root, f"family{r}.json"))) for r in range(2)]
    for part in ("b", "c"):
        check(ranks[0][part]["digest"] == ranks[1][part]["digest"],
              f"({part}): digests differ")
    walls["ranks"] = time.perf_counter() - t1
    wall_s = time.perf_counter() - t0
    print(f"[family] phase 17 wall {wall_s:.3f} s ((a) {walls['a']:.3f} s, kernel checks "
          f"{walls['kernels']:.3f} s, ranks {walls['ranks']:.3f} s with phase 18's read of "
          f"its own ranks here meanwhile; the ranks' parts "
          + ", ".join(f"({k}) {v:.3f} s" for k, v in ranks[0]["walls"].items()) + ")")
    b1e = {"a": a["counts"]["w4a8_expert_matmul"],
           "b": [r["b"]["counts"]["w4a8_expert_matmul"] for r in ranks]}
    b1 = {"a": a["counts"]["w4a8_matmul"], "b": [r["b"]["counts"]["w4a8_matmul"] for r in ranks],
          "c": [r["c"]["counts"]["w4a8_matmul"] for r in ranks],
          "d": [sum(r["d"]["b1"]) for r in ranks]}
    return {"a": a, "ranks": ranks, "expert_rows": expert_rows, "b1_rows": b1_rows,
            "wall_s": wall_s, "walls": walls, "b1e": b1e, "b1": b1}


# ---------------------------------------------------------------------------
# Phase 18: training on the mesh
# ---------------------------------------------------------------------------
#: (a): steps of the world-size-1 runs, each of TRAIN_BATCH x TRAIN_SEQ
MESH_TRAIN_A_STEPS = 4
#: (b): layers of smollm-360m the two ranks train (full width), steps, the
#: checkpoint every MESH_TRAIN_EVERY steps; (c): steps under int8-pod
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, MESH_TRAIN_EVERY, MESH_TRAIN_C_STEPS = 8, 4, 2, 3
#: (b)'s tolerances against the one-device trainer: those of the CPU tests
#: (tests/test_torch_mesh_training.py): losses rel 1e-5, m and v atol
#: 1e-5. The parameters are tie-limited: AdamW's step is about lr x the
#: sign of a gradient element, so an element whose gradient cancels to
#: near 0 takes either sign under another summation order (two ranks'
#: sum against one device's); all but MESH_TRAIN_PARAM_SHARE of the
#: parameters within 1e-5, and every one within twice the sum of the
#: steps' learning rates (each step's flip at most 2 lr).
MESH_TRAIN_LOSS_REL, MESH_TRAIN_STATE_ATOL, MESH_TRAIN_PARAM_SHARE = 1e-5, 1e-5, 1e-4
#: (d): steps of the full-depth model on the two ranks
MESH_TRAIN_D_STEPS = 3
#: seconds the two phase-18 ranks may take together
MESH_TRAIN_RANK_TIMEOUT = 420


def _train_cfg(layers: int | None = None):
    """smollm-360m's f32 copy (the form ``--float32`` trains), full width,
    cut to ``layers`` when given."""
    from dataclasses import replace

    from repro_torch.launch.search import f32_config

    cfg = f32_config(_config(TRAIN_ARCH))
    return cfg if layers is None else replace(cfg, n_layers=layers)


def _train_data(cfg):
    from repro_torch.data import DataConfig, TokenBatcher

    return TokenBatcher(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))


def _cuda_batch(torch, rows):
    import numpy as np

    return {"tokens": torch.from_numpy(np.asarray(rows)).to("cuda:0")}


def _state_bytes(state) -> int:
    """Bytes of a train state's parameters and both moments on this rank."""
    model, opt = state["params"], state["opt"]
    return sum(t.numel() * t.element_size() for t in list(model.parameters())
               + list(opt["m"].values()) + list(opt["v"].values()))


def _same_state(torch, a, b, moments_only: bool = False) -> bool:
    """Whether two train states hold the same bits (the moments alone, or
    the parameters too)."""
    pa, pb = dict(a["params"].named_parameters()), dict(b["params"].named_parameters())
    same = all(torch.equal(a["opt"][k][n], b["opt"][k][n]) for k in ("m", "v")
               for n in a["opt"]["m"])
    return same and (moments_only or all(torch.equal(pa[n], pb[n]) for n in pa))


def int8_plain(torch, grads: list, n: int) -> dict:
    """The reference's int8-pod formula, written plainly, on the pods'
    gradients ``grads`` (dicts by parameter name): the absmax over the
    pods, codes rounded half to even in [-127, 127], summed in int32,
    dequantized, cast, divided by the pod count."""
    out = {}
    for name in grads[0]:
        gs = [g[name] for g in grads]
        absmax = torch.max(torch.abs(gs[0].to(torch.float32)))
        for g in gs[1:]:
            absmax = torch.maximum(absmax, torch.max(torch.abs(g.to(torch.float32))))
        scale = torch.clamp(absmax, min=1e-30) / 127.0
        total = sum(torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127).to(
            torch.int8).to(torch.int32) for g in gs)
        out[name] = (total.to(torch.float32) * scale).to(gs[0].dtype) / n
    return out


def plain_grads(torch, state, rows) -> dict:
    """The one-device gradient of the loss on ``rows`` (no update)."""
    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim import trainable_parameters

    params = trainable_parameters(state["params"])
    total, _ = loss_fn(state["params"], _cuda_batch(torch, rows))
    grads = torch.autograd.grad(total, list(params.values()))
    return dict(zip(params, grads))


def plain_int8_steps(torch, cfg, run, pods: int, steps: int):
    """A one-device train state through ``steps`` updates whose gradient is
    :func:`int8_plain` on the ``pods`` pods' one-device gradients (each on
    its rows of the global batch)."""
    from repro_torch.optim import adamw_update, trainable_parameters
    from repro_torch.runtime import init_train_state

    state, data = init_train_state(cfg, run, 0, device="cuda"), _train_data(cfg)
    per = TRAIN_BATCH // pods
    for i in range(steps):
        rows = data.batch(i)["tokens"]
        grads = int8_plain(torch, [plain_grads(torch, state, rows[p * per:(p + 1) * per])
                                   for p in range(pods)], pods)
        adamw_update(trainable_parameters(state["params"]), grads, state["opt"], run.optimizer)
    return state


def mesh_train_world_one(torch, smi: str, root: str) -> dict:
    """(a) NCCL at world size 1, mesh (pod, data, model) = (1, 1, 1),
    smollm-360m f32 at full width and depth, MESH_TRAIN_A_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ: the mesh step without compression against the
    one-device trainer (the whole train state bit-equal), then under
    int8-pod against the plain formula on the one-device gradient (m and v
    bit-equal); no port kernel launched in either mesh run; then the three
    steps timed in turns."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _deterministic
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import (
        TrainRunConfig,
        init_train_state,
        make_train_step,
        place_train_state,
    )
    from repro_torch.runtime import collectives

    mesh = make_mesh((1, 1, 1), device="cuda:0", init_method=f"file://{root}/rdv_a", rank=0,
                     world_size=1)
    check(mesh.backend == "nccl", f"phase 18 (a): backend {mesh.backend}")
    cfg, out, kept = _train_cfg(), {}, {}
    opt = OptimizerConfig(lr=TRAIN_LR, total_steps=MESH_TRAIN_A_STEPS)
    data = _train_data(cfg)
    try:
        with _deterministic(torch.device("cuda")):
            one = init_train_state(cfg, TrainRunConfig(optimizer=opt), 0, device="cuda")
            step = make_train_step(cfg, TrainRunConfig(optimizer=opt))
            one_ms = []
            for i in range(MESH_TRAIN_A_STEPS):
                t0 = time.perf_counter()
                one, m = step(one, _cuda_batch(torch, data.batch(i)["tokens"]))
                float(m["loss"])
                one_ms.append(1e3 * (time.perf_counter() - t0))
            one_bytes = _state_bytes(one)
            for comp in ("none", "int8-pod"):
                run = TrainRunConfig(optimizer=opt, grad_compression=comp)
                state = place_train_state(init_train_state(cfg, run, 0, device="cuda"), mesh)
                step = make_train_step(cfg, run, mesh)
                reset_peak(torch)
                reset_counts()
                collectives.reset_counts()
                times, losses = [], []
                for i in range(MESH_TRAIN_A_STEPS):
                    t0 = time.perf_counter()
                    state, m = step(state, _cuda_batch(torch, data.batch(i)["tokens"]))
                    losses.append(float(m["loss"]))
                    times.append(1e3 * (time.perf_counter() - t0))
                counts = read_counts()
                calls, nbytes = collectives.calls, collectives.nbytes
                peak = torch.cuda.max_memory_allocated()
                check(not any(counts.values()), f"(a) {comp}: port kernels launched: {counts}")
                if comp == "none":
                    equal = _same_state(torch, state, one)
                    check(equal, "(a): the world-size-1 mesh step's train state differs from the "
                                 "one-device trainer's")
                    what = "the whole train state bit-equal to the one-device trainer's"
                else:
                    plain = plain_int8_steps(torch, cfg, run, 1, MESH_TRAIN_A_STEPS)
                    equal = _same_state(torch, state, plain, moments_only=True)
                    check(equal, "(a) int8-pod: m and v differ from the plain int8 formula on "
                                 "the one-device gradient")
                    what = ("m and v bit-equal to the plain int8 formula on the one-device "
                            "gradient" + (", params too" if _same_state(torch, state, plain)
                                          else ""))
                    del plain
                st = spread_ms(times[1:])
                out[comp] = {"step": st, "first_ms": times[0], "losses": losses,
                             "collectives": calls / MESH_TRAIN_A_STEPS,
                             "bytes": nbytes / MESH_TRAIN_A_STEPS, "peak_mib": peak / 2**20,
                             "state_mib": _state_bytes(state) / 2**20, "counts": counts}
                print(f"[mesh-train] (a) {TRAIN_ARCH} f32 full width and depth, NCCL world size 1, "
                      f"mesh (pod, data, model) = (1, 1, 1), grad_compression={comp}, "
                      f"{MESH_TRAIN_A_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: {what}; step "
                      f"{fmt_spread(st)} (steps 2-{MESH_TRAIN_A_STEPS}, each ending in its loss "
                      f"read; first {times[0]:.1f} ms) against the one-device trainer's "
                      f"{fmt_spread(spread_ms(one_ms[1:]))}; {calls / MESH_TRAIN_A_STEPS:.1f} "
                      f"collectives of {nbytes / MESH_TRAIN_A_STEPS / 2**20:.3f} MiB a step; "
                      f"state {_state_bytes(state) / 2**20:.1f} MiB a rank against "
                      f"{one_bytes / 2**20:.1f} MiB on one device; peak {peak / 2**20:.1f} MiB; "
                      f"port kernels launched: 0; {smi}")
                kept[comp] = (state, step)
            # the three steps in turns, each ending in its loss read
            batch = _cuda_batch(torch, data.batch(MESH_TRAIN_A_STEPS)["tokens"])

            def turn(st, fn):
                def go():
                    float(fn(st, batch)[1]["loss"])
                return go

            one_step = make_train_step(cfg, TrainRunConfig(optimizer=opt))
            turns = in_turns(torch, {"one device": turn(one, one_step),
                                     **{f"mesh {c}": turn(*kept[c]) for c in kept}}, 4)
            out["turns"] = turns
            print(f"[mesh-train] (a) in turns (4 runs each, a step ending in its loss read; the "
                  f"card shared with the build): "
                  + "; ".join(f"{n} {fmt_spread(t)}" for n, t in turns.items()) + f"; {smi}")
            out["one_step"] = spread_ms(one_ms[1:])
            del one, kept, one_step
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _layers_patch(layers: int):
    """``launch/train.py``'s config lookup cut to ``layers`` (full width)."""
    from dataclasses import replace

    from repro_torch.launch import train as TR

    get = TR.get_config
    TR.get_config = lambda arch: replace(get(arch), n_layers=layers)
    return lambda: setattr(TR, "get_config", get)


def train_launch_args(ckpt: str | None, n_steps: int = MESH_TRAIN_STEPS) -> list:
    """launch/train.py's arguments for phase 18: checkpoints under ``ckpt``
    every MESH_TRAIN_EVERY steps (none without it)."""
    args = ["--arch", TRAIN_ARCH, "--float32", "--steps", str(n_steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--log-every", "1",
            "--device", "cuda"]
    return args + (["--ckpt-dir", ckpt, "--ckpt-every", str(MESH_TRAIN_EVERY)] if ckpt else [])


def train_rank_main(argv) -> int:
    """One rank of phase 18 (b), (c) and (d): ``--train-rank R --mesh-root
    DIR``. (b) launch/train.py on the host mesh (data,) = (2,); (c) the
    int8-pod step on (pod, data, model) = (2, 1, 1), rank 0 then saving its
    state for the parent to hold to the plain formula; (d) launch/train.py
    on the host mesh at full depth, remat="block", no checkpoint."""
    import torch

    rank = int(argv[argv.index("--train-rank") + 1])
    root = argv[argv.index("--mesh-root") + 1]
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    import torch.distributed as dist
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import (
        TrainRunConfig,
        init_train_state,
        make_train_step,
        place_train_state,
    )
    from repro_torch.runtime import collectives, steps

    init = dict(device="cuda:0", backend="gloo", init_method=f"file://{root}/rdv_b", rank=rank,
                world_size=2, timeout=MESH_TRAIN_RANK_TIMEOUT)
    init_distributed(**init)
    out = {}
    # (b) the launcher, 2 ranks on the host mesh
    restore = _layers_patch(MESH_TRAIN_LAYERS)
    mon = TR.StragglerMonitor(rank=rank)
    reset_counts()
    collectives.reset_counts()
    steps.reset_gathered()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, losses), lines = quiet(lambda: TR.main(train_launch_args(f"{root}/ckpt_b"),
                                                   monitor=mon))
    wall = time.perf_counter() - t0
    restore()
    counts = read_counts()
    check(not any(counts.values()), f"(b) rank {rank}: port kernels launched: {counts}")
    out["b"] = {"losses": losses, "step": spread_ms([1e3 * t for t in mon.times[1:]]),
                "first_ms": 1e3 * mon.times[0], "wall_s": wall, "lines": lines,
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "state_mib": _state_bytes(state) / 2**20, "counts": counts,
                "gathered_mib": steps.gathered_peak / 2**20}
    # the collectives of one step alone (the launcher's run adds the
    # checkpoints' gathers and the stop flag's)
    model = state["params"]
    opt = OptimizerConfig(lr=TRAIN_LR, total_steps=MESH_TRAIN_STEPS)
    step = make_train_step(model.cfg, TrainRunConfig(optimizer=opt), model._mesh)
    per = TRAIN_BATCH // 2
    rows = _train_data(model.cfg).batch(MESH_TRAIN_STEPS)["tokens"][rank * per:][:per]
    collectives.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with TR._deterministic(torch.device("cuda")):
        state, m = step(state, _cuda_batch(torch, rows))
        float(m["loss"])
    out["b"].update(collectives=collectives.calls, bytes=collectives.nbytes,
                    step_peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    # (c) int8-pod across two one-rank pods
    cfg = _train_cfg(MESH_TRAIN_LAYERS)
    run = TrainRunConfig(optimizer=OptimizerConfig(lr=TRAIN_LR, total_steps=MESH_TRAIN_C_STEPS),
                         grad_compression="int8-pod")
    mesh = make_mesh((2, 1, 1), **init)
    data = _train_data(cfg)
    per = TRAIN_BATCH // 2
    reset_counts()
    collectives.reset_counts()
    with TR._deterministic(torch.device("cuda")):
        state = place_train_state(init_train_state(cfg, run, 0, device="cuda"), mesh)
        step = make_train_step(cfg, run, mesh)
        times = []
        for i in range(MESH_TRAIN_C_STEPS):
            rows = data.batch(i)["tokens"][mesh.coords["pod"] * per:][:per]
            t0 = time.perf_counter()
            state, m = step(state, _cuda_batch(torch, rows))
            float(m["loss"])
            times.append(1e3 * (time.perf_counter() - t0))
        counts = read_counts()
        check(not any(counts.values()), f"(c) rank {rank}: port kernels launched: {counts}")
        out["c"] = {"step": spread_ms(times[1:]), "collectives": collectives.calls,
                    "bytes": collectives.nbytes, "counts": counts}
        if rank == 0:  # for the parent to hold to the plain formula
            torch.save({"params": {n: t.detach() for n, t in state["params"].named_parameters()},
                        "m": state["opt"]["m"], "v": state["opt"]["v"]},
                       os.path.join(root, "c_rank0.pt"))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the whole model (32 layers) through the launcher on the host mesh
    mon = TR.StragglerMonitor(rank=rank)
    reset_counts()
    collectives.reset_counts()
    steps.reset_gathered()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, losses), lines = quiet(lambda: TR.main(train_launch_args(
        None, MESH_TRAIN_D_STEPS), monitor=mon))
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(not any(counts.values()), f"(d) rank {rank}: port kernels launched: {counts}")
    check(state["params"].cfg.remat == "block", "(d): the config's remat is not block")
    out["d"] = {"losses": losses, "step": spread_ms([1e3 * t for t in mon.times[1:]]),
                "first_ms": 1e3 * mon.times[0], "wall_s": wall, "lines": lines,
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "state_mib": _state_bytes(state) / 2**20, "counts": counts,
                "collectives": collectives.calls / MESH_TRAIN_D_STEPS,
                "bytes": collectives.nbytes / MESH_TRAIN_D_STEPS,
                "gathered_mib": steps.gathered_peak / 2**20}
    del state
    with open(os.path.join(root, f"train{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def start_train_ranks(root: str) -> list:
    """The two gloo ranks of (b) and (c) (this script with
    ``--train-rank``), started."""
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--train-rank", str(r),
                              "--mesh-root", root], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(2)]


def one_device_references(torch, root: str) -> dict:
    """What (b) and (c) are held to, computed before the ranks start: the
    one-device trainer through launch/train.py on (b)'s config and batches
    (its losses and final train state), and (c)'s plain int8 formula."""
    from repro_torch.interop import train_state_tree
    from repro_torch.launch import train as TR
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import TrainRunConfig

    restore = _layers_patch(MESH_TRAIN_LAYERS)
    try:
        (one, losses), _ = quiet(lambda: TR.main(train_launch_args(f"{root}/ckpt_one")))
    finally:
        restore()
    out = {"losses": losses, "spec": train_state_tree(one, spec=True),
           "state": train_state_tree(one), "bytes": _state_bytes(one)}
    del one
    run = TrainRunConfig(optimizer=OptimizerConfig(lr=TRAIN_LR, total_steps=MESH_TRAIN_C_STEPS),
                         grad_compression="int8-pod")
    with TR._deterministic(torch.device("cuda")):
        plain = plain_int8_steps(torch, _train_cfg(MESH_TRAIN_LAYERS), run, 2,
                                 MESH_TRAIN_C_STEPS)
    out["plain_c"] = {"params": {n: p.detach().cpu() for n, p in
                                 plain["params"].named_parameters()},
                      "m": {n: t.cpu() for n, t in plain["opt"]["m"].items()},
                      "v": {n: t.cpu() for n, t in plain["opt"]["v"].items()}}
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_train_two_ranks(torch, smi: str, root: str, procs: list, ref: dict) -> dict:
    """(b) and (c), the ranks' side read: their losses and final state (the
    final checkpoint, whole leaves) against the one-device trainer's, a
    one-device run resuming from their step-2 checkpoint against it, and
    rank 0's (c) state against the plain formula."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.interop import train_state_tree
    from repro_torch.launch import train as TR

    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=MESH_TRAIN_RANK_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n(timed out)")
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"phase 18: rank {r} failed (rc {p.returncode}):\n{log[-4000:]}")
    ranks = [json.load(open(os.path.join(root, f"train{r}.json"))) for r in range(2)]
    b0 = ranks[0]["b"]
    check(ranks[1]["b"]["losses"] == b0["losses"], "(b): the ranks' losses differ")
    check(sum("[train] step" in ln for ln in ranks[1]["b"]["lines"]) == 0 and
          sum("[train] step" in ln for ln in b0["lines"]) == MESH_TRAIN_STEPS,
          "(b): rank 0 alone prints the loss lines")
    losses_one, spec, want = ref["losses"], ref["spec"], ref["state"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(b0["losses"], losses_one))
    check(rel <= MESH_TRAIN_LOSS_REL, f"(b): losses rel {rel:.3g} from the one-device "
                                      f"trainer's: {b0['losses']} vs {losses_one}")
    restore = _layers_patch(MESH_TRAIN_LAYERS)
    try:
        two = CheckpointManager(f"{root}/ckpt_b")
        check(two.latest_step() == MESH_TRAIN_STEPS, f"(b): checkpoints {os.listdir(root)}")
        diff = train_state_held(torch, two.restore(MESH_TRAIN_STEPS, spec)[0], want,
                                "(b) the ranks' final state")
        shutil.rmtree(two.directory(MESH_TRAIN_STEPS))
        (resumed, losses_r), lines = quiet(lambda: TR.main(train_launch_args(f"{root}/ckpt_b")))
        check(f"[train] resumed from step {MESH_TRAIN_EVERY}" in lines,
              f"(b): the resume: {lines[:3]}")
        rdiff = train_state_held(torch, train_state_tree(resumed), want,
                                 f"(b) the one-device resume from the ranks' step-"
                                 f"{MESH_TRAIN_EVERY} checkpoint")
        rrel = abs(losses_r[-1] - losses_one[-1]) / abs(losses_one[-1])
        check(rrel <= MESH_TRAIN_LOSS_REL, f"(b): the resumed run's last loss rel {rrel:.3g}")
    finally:
        restore()
    one_bytes = ref["bytes"]
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    c0, got, plain = ranks[0]["c"], torch.load(os.path.join(root, "c_rank0.pt")), ref["plain_c"]
    same = {k: all(torch.equal(got[k][n].cpu(), plain[k][n]) for n in plain[k])
            for k in ("params", "m", "v")}
    check(same["m"] and same["v"], "(c): rank 0's m and v differ from the plain int8 formula on "
                                   "the two pods' one-device gradients")
    c0["params_equal"] = same["params"]
    bound_b, bound_d = (train_bytes_a_rank(layers) for layers in (MESH_TRAIN_LAYERS, None))
    st = b0["step"]
    print(f"[mesh-train] (b) {TRAIN_ARCH} f32 full width cut to {MESH_TRAIN_LAYERS} layers, "
          f"launch/train.py on 2 gloo ranks sharing the card, host mesh (data,) = (2,), "
          f"{MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, checkpoints every "
          f"{MESH_TRAIN_EVERY}: losses within rel {rel:.3g} of the one-device trainer's "
          f"(limit {MESH_TRAIN_LOSS_REL:g}); final state (the ranks' checkpoint, whole leaves): "
          f"{fmt_held(diff)}; a one-device run resumed from the ranks' step-"
          f"{MESH_TRAIN_EVERY} checkpoint: {fmt_held(rdiff)}, last loss rel {rrel:.3g}; step a rank "
          f"{fmt_spread(st)} (steps 2-{MESH_TRAIN_STEPS}, gloo stages every collective through "
          f"the host: not an NCCL figure; the card and host shared with phases 16 and 17; "
          f"first {b0['first_ms']:.1f} ms); "
          f"{b0['collectives']} collectives of {b0['bytes'] / 2**20:.1f} MiB a step; state {b0['state_mib']:.1f} MiB a rank against {one_bytes / 2**20:.1f} "
          f"MiB on one device; peak in the launcher's loop {b0['peak_mib']:.1f} MiB rank 0, "
          f"{ranks[1]['b']['peak_mib']:.1f} MiB rank 1 (its checkpoints gather the whole "
          f"state); a step alone {b0['step_peak_mib']:.1f} / "
          f"{ranks[1]['b']['step_peak_mib']:.1f} MiB, against the specs' "
          f"{fmt_train_bytes(bound_b)} (mesh_train_bytes; activations not counted); gathered "
          f"parameters alive at once at most {b0['gathered_mib']:.1f} MiB; launcher wall "
          f"{b0['wall_s']:.3f} s; port kernels launched: 0; {smi}")
    print(f"[mesh-train] (c) the same model on 2 gloo ranks, (pod, data, model) = (2, 1, 1), "
          f"int8-pod, {MESH_TRAIN_C_STEPS} steps: m and v bit-equal to the plain formula on "
          f"the two pods' one-device gradients"
          + (", params too" if c0["params_equal"] else "")
          + f"; step a rank {fmt_spread(c0['step'])}; "
          f"{c0['collectives'] / MESH_TRAIN_C_STEPS:.1f} collectives of "
          f"{c0['bytes'] / MESH_TRAIN_C_STEPS / 2**20:.1f} MiB a step; port kernels launched: "
          f"0; {smi}")
    d = [r["d"] for r in ranks]
    check(d[1]["losses"] == d[0]["losses"], "(d): the ranks' losses differ")
    check(sum("[train] step" in ln for ln in d[0]["lines"]) == MESH_TRAIN_D_STEPS and
          sum("[train] step" in ln for ln in d[1]["lines"]) == 0,
          "(d): rank 0 alone prints the loss lines")
    check("first_loss" in PHASE15 and "block_peak_mib" in PHASE15,
          "(d) is held to phase 15 (a): run phase 15 first")
    drel = abs(d[0]["losses"][0] - PHASE15["first_loss"]) / abs(PHASE15["first_loss"])
    check(drel <= MESH_TRAIN_LOSS_REL, f"(d): the first loss {d[0]['losses'][0]} against the "
                                       f"one-device trainer's {PHASE15['first_loss']}")
    d_peak = max(x["peak_mib"] for x in d)
    check(d_peak < PHASE15["block_peak_mib"],
          f"(d): peak {d_peak:.1f} MiB a rank, not below one device's "
          f"{PHASE15['block_peak_mib']:.1f} MiB at remat block")
    print(f"[mesh-train] (d) {TRAIN_ARCH} f32 at full depth (32 layers), remat=\"block\", "
          f"launch/train.py on 2 gloo ranks sharing the card, host mesh (data,) = (2,), "
          f"{MESH_TRAIN_D_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, no checkpoint: first loss "
          f"{d[0]['losses'][0]:.6f} within rel {drel:.3g} of phase 15 (a)'s one-device trainer "
          f"(limit {MESH_TRAIN_LOSS_REL:g}), losses {[round(x, 4) for x in d[0]['losses']]}; "
          f"peak in the launcher's loop {d[0]['peak_mib']:.1f} MiB rank 0, "
          f"{d[1]['peak_mib']:.1f} MiB rank 1, against "
          f"phase 15 (a)'s one-device peak at remat block {PHASE15['block_peak_mib']:.1f} MiB "
          f"and the specs' {fmt_train_bytes(bound_d)}; state {d[0]['state_mib']:.1f} MiB a "
          f"rank; gathered parameters alive at once at most {d[0]['gathered_mib']:.1f} MiB; "
          f"step a rank {fmt_spread(d[0]['step'])} (steps 2-{MESH_TRAIN_D_STEPS}, gloo: not "
          f"an NCCL figure; first {d[0]['first_ms']:.1f} ms); {d[0]['collectives']:.1f} "
          f"collectives of {d[0]['bytes'] / 2**20:.1f} MiB a step (the launcher's stop flag "
          f"included); launcher wall {d[0]['wall_s']:.3f} s; port kernels launched: 0; {smi}")
    return {"ranks": ranks, "rel": rel, "diff": diff, "resume_diff": rdiff,
            "one_mib": one_bytes / 2**20, "bytes_b": bound_b, "bytes_d": bound_d,
            "d_rel": drel}


def train_bytes_a_rank(layers: int | None) -> dict:
    """``mesh_train_bytes`` of phase 18's model (cut to ``layers``) on the
    host mesh (data,) = (2,), at its config's remat."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import TrainRunConfig, mesh_train_bytes

    run = TrainRunConfig(optimizer=OptimizerConfig(lr=TRAIN_LR))
    return mesh_train_bytes(_train_cfg(layers), run, AbstractMesh(("data",), (2,)))


def fmt_train_bytes(b: dict) -> str:
    return (f"{b['total'] / 2**20:.1f} MiB (state {b['state'] / 2**20:.1f}, gradient slices "
            f"{b['grads'] / 2**20:.1f}, gathered units {b['gathered'] / 2**20:.1f})")


def tree_diffs(torch, a, b, atol: float) -> tuple[float, int, int]:
    """(largest |a - b|, elements beyond ``atol``, elements) over two trees
    of the same structure (nested dicts, tuples, tensors or arrays)."""
    if isinstance(a, (dict, tuple, list)):
        keys = a if isinstance(a, dict) else range(len(a))
        parts = [tree_diffs(torch, a[k], b[k], atol) for k in keys]
        return (max((p[0] for p in parts), default=0.0), sum(p[1] for p in parts),
                sum(p[2] for p in parts))
    x, y = (torch.as_tensor(t).detach().cpu().to(torch.float64) for t in (a, b))
    check(x.shape == y.shape, f"shapes {tuple(x.shape)} and {tuple(y.shape)}")
    d = (x - y).abs()
    return (float(d.max()) if d.numel() else 0.0), int((d > atol).sum()), d.numel()


def train_state_held(torch, got, want, what: str) -> dict:
    """A train state (reference layout) against the one-device trainer's:
    m and v within MESH_TRAIN_STATE_ATOL, the parameters tie-limited (see
    MESH_TRAIN_PARAM_SHARE)."""
    lr_sum = sum(TRAIN_LR * min(k / 100, 1.0) for k in range(1, MESH_TRAIN_STEPS + 1))
    out = {k: tree_diffs(torch, got["opt"][k], want["opt"][k], MESH_TRAIN_STATE_ATOL)
           for k in ("m", "v")}
    out["params"] = tree_diffs(torch, got["params"], want["params"], MESH_TRAIN_STATE_ATOL)
    for k in ("m", "v"):
        check(out[k][0] <= MESH_TRAIN_STATE_ATOL, f"{what}: {k} differs by {out[k][0]:.3g}")
    top, over, n = out["params"]
    check(top <= 2 * lr_sum and over <= MESH_TRAIN_PARAM_SHARE * n,
          f"{what}: params differ by up to {top:.3g} (limit {2 * lr_sum:.3g}), {over} of {n} "
          f"beyond {MESH_TRAIN_STATE_ATOL:g}")
    return out


def fmt_held(h: dict) -> str:
    return (f"m within {h['m'][0]:.3g}, v within {h['v'][0]:.3g}, params within "
            f"{h['params'][0]:.3g} ({h['params'][1]} of {h['params'][2]} beyond "
            f"{MESH_TRAIN_STATE_ATOL:g})")


def mesh_training_start(torch, smi: str) -> dict:
    """Phase 18, its first part, beside the build: (a) and the one-device
    references of (b) and (c) (host copies), before the ranks start
    (:func:`mesh_training_ranks`)."""
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "phase18")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a = mesh_train_world_one(torch, smi, root)
    t_a = time.perf_counter() - t0
    ref = one_device_references(torch, root)
    return {"root": root, "a": a, "ref": ref, "t_a": t_a, "t_ref": time.perf_counter() - t0}


def mesh_training_ranks(torch, smi: str, started: dict) -> dict:
    """Phase 18, its second part: the two gloo ranks of (b), (c) and (d)
    started; they run beside phases 16 and 17 until
    :func:`mesh_training_finish` reads them."""
    procs = start_train_ranks(started["root"])
    CHILDREN.extend(procs)
    return {**started, "procs": procs, "t_started": time.perf_counter()}


def mesh_training_finish(torch, smi: str, started: dict) -> dict:
    """Phase 18, its second part: the ranks of (b), (c) and (d) read and
    held (:func:`mesh_train_two_ranks`); the kernels line's launches of
    every mesh train step."""
    t0 = time.perf_counter()
    root, procs, a = started["root"], started["procs"], started["a"]
    try:
        bc = mesh_train_two_ranks(torch, smi, root, procs, started["ref"])
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(root, ignore_errors=True)
    t_read = time.perf_counter() - t0
    wall_s = started["t_ref"] + t_read
    print(f"[mesh-train] phase 18 wall {wall_s:.3f} s here ((a) {started['t_a']:.3f} s, then "
          f"the one-device references to {started['t_ref']:.3f} s, beside the build; the "
          f"ranks ran {t0 - started['t_started']:.3f} s beside phases 16 and 17 before their "
          f"read here, which took {t_read:.3f} s; the ranks' launcher (b) "
          f"{bc['ranks'][0]['b']['wall_s']:.3f} s, (d) {bc['ranks'][0]['d']['wall_s']:.3f} s)")
    counts = [a["none"]["counts"], a["int8-pod"]["counts"]] + [
        r[k]["counts"] for r in bc["ranks"] for k in ("b", "c", "d")]
    launches = {n: sum(c[n] for c in counts) for n in counts[0]}
    return {"a": a, "bc": bc, "wall_s": wall_s, "launches": launches}


def expert_record(name, rows, err, launches, ms_key, plain_key, replaces, pallas):
    """One record for B1e or B4e: times summed over the 3 expert sites of
    one granite MoE layer at decode (M = 4, E = 40); the same at M = 64 (a
    prefill's capacity rows) in ``m64``; every shape beside."""
    def layer(m):
        rs = [r for r in rows if "ms" in r and r["M"] == m]
        return {"ms": moe_layer_sum(rows, m, ms_key),
                "plain_ms": moe_layer_sum(rows, m, plain_key),
                "bound_ms": moe_layer_sum(rows, m, "bound_ms"),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs)
                else "operations",
                "library_ms": moe_layer_sum(rows, m, "library_ms"),
                "int_mm_ms": moe_layer_sum(rows, m, "int_mm_ms")}

    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w4a8_mm.cu",
        "replaces": f"src/repro/kernels/w4a8_mm.py:{replaces}",
        "pallas_call": f"src/repro/kernels/w4a8_mm.py:{pallas}",
        "vmapped_at": "src/repro/models/moe.py:122",
        "launches": launches,
        "max_abs_err": err,
        **layer(BATCH),
        "m64": layer(PROMPT),
        "m80": layer(80),
        "timed_as": "sum over the 3 expert sites of one granite-moe-3b-a800m layer (E=40; "
                    "(1536, 512) twice and (512, 1536)) at decode, M=4 rows an expert, cold "
                    "L2; m64 and m80 the same at M=64 and 80; the library call is one bf16 "
                    "torch.bmm on the dequantized stack, int_mm_ms 40 torch._int_mm calls on "
                    "the unpacked codes",
        "shapes": rows,
    }


def paged_record(name, rows, err, launches, source_line) -> dict:
    """One record for a paged-attention kernel: times at smollm-360m decode,
    4 slots x 80 tokens (the slice's lengths); the other timed shapes beside."""
    main = rows[0]
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": f"src/repro/kernels/paged_attention.py:{source_line}",
        "launches": launches,
        "max_abs_err": err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "timed_as": f"one call at smollm-360m decode: {main['slots']} slots x {main['tokens']} "
                    f"tokens in a {main['table_cols']}-page table ({main['splits']} splits), "
                    f"nh 15 / nkv 5, hd 64, bs 64, bf16 q, cold L2; the library call is "
                    f"scaled_dot_product_attention on K/V gathered beforehand; every timed "
                    f"shape in shapes",
        "shapes": rows,
    }


def gpfq_record(rows, max_err, launches, masked_rows, masked_err, masked_launches):
    """One record for gpfq_solve: times summed over the 7 site shapes of one
    smollm-360m layer (split budgets, round-to-nearest); per-case rows beside;
    the masked solve of the 2:4 slice (phases 8, 9) as its own sub-record."""
    by_shape = {(r["K"], r["C"]): r for r in rows
                if (r["mode"], r["rounding"]) == ("split", "nearest")}
    layer = [by_shape[kn] for kn in LAYER_SITES]
    masked_by = {(r["K"], r["C"]): r for r in masked_rows}
    masked = [masked_by[kn] for kn in LAYER_SITES]
    return {
        "name": "gpfq_solve",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gpfq_solve.cu",
        "replaces": "src/repro/kernels/gpfq_solve.py:33",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in layer),
        "plain_ms": sum(r["plain_ms"] for r in layer),
        "bound_ms": sum(r["bound_ms"] for r in layer),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in layer)
        else "bytes",
        "library_ms": None,
        "timed_as": "sum over the 7 sites of one smollm-360m layer, K x C as calibration "
                    "solves them; no single PyTorch call computes this solve",
        "shapes": rows,
        "masked": {
            "launches": masked_launches,
            "max_abs_err": masked_err,
            "ms": sum(r["ms"] for r in masked),
            "unmasked_ms": sum(r["unmasked_ms"] for r in masked),
            "plain_ms": sum(r["plain_ms"] for r in masked),
            "bound_ms": sum(r["bound_ms"] for r in masked),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in masked)
            else "bytes",
            "library_ms": None,
            "timed_as": "the 2:4 solve with its (K, C) uint8 mask, summed over one layer's "
                        "7 sites; unmasked_ms times the same inputs without the mask",
            "shapes": masked_rows,
        },
    }


def layer_record(rows, m: int, keys) -> dict:
    """``keys`` summed over one layer's 7 sites at M = m, and the bound's
    kind (bytes only if every site is bound by bytes)."""
    by_shape = {(r["K"], r["N"]): r for r in rows if r["M"] == m}
    layer = [by_shape[kn] for kn in LAYER_SITES]
    rec = {key: layer_sum(rows, m, key) for key in keys}
    rec["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in layer)
                       else "operations")
    return rec


def sparse_kernel_record(rows, max_err, launches):
    """One record for w4a8_sparse_matmul (B4): times summed over the 7 site
    shapes of one layer at decode (M = 4), B1's times on the expanded codes
    beside; the same sums at prefill (M = 256) in ``m256``; per-shape rows
    beside."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "b1_ms")
    return {
        "name": "w4a8_sparse_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w4a8_mm.cu",
        "replaces": "src/repro/kernels/w4a8_mm.py:311",
        "pallas_call": "src/repro/kernels/w4a8_mm.py:410",
        "launches": launches,
        "max_abs_err": max_err,
        **layer_record(rows, BATCH, keys),
        "m256": layer_record(rows, BATCH * PROMPT, keys),
        "timed_as": "sum over the 7 packed 2:4 sites of one layer at decode, M=4, cold L2; "
                    "m256 the same at prefill, M=256; the library call is torch._int_mm on "
                    "the expanded int8 codes; b1_ms is the dense kernel on the same codes",
        "shapes": rows,
    }


def rmsnorm_record(rows, max_err, launches, host):
    """One record for quant_rmsnorm (B6): the (256, 960) float32 call (one
    smollm-360m prefill of 4 x 64 tokens); every shape and type of the
    sweep beside, and the wrapper's host time a call."""
    main = next(r for r in rows if (r["M"], r["D"], r["dtype"]) == (256, 960, "float32"))
    return {
        "name": "quant_rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_rmsnorm.cu",
        "replaces": "src/repro/kernels/quant_rmsnorm.py:22",
        "pallas_call": "src/repro/kernels/quant_rmsnorm.py:51",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "rms_norm_ms": main["rms_norm_ms"],
        "timed_as": f"one call at ({main['M']}, {main['D']}) {main['dtype']}, cold L2, median "
                    f"of {RMSNORM_ROUNDS} rounds, through ops.norm_and_quantize's kernel; no "
                    f"single PyTorch call computes it (rms_norm_ms: F.rms_norm alone, for "
                    f"scale); launches: one run of norm_and_quantize at "
                    f"{len(RMSNORM_DRIVEN)} shapes, the only entry point that reaches it",
        "shapes": rows,
        "wrapper_host_us": host,
    }


def kernel_record(rows, max_err, launches, host):
    """One record for w4a8_matmul: times summed over the 7 site shapes of
    one layer at decode (M = batch = 4), the main path's most frequent
    call (15 of 16 forwards); the same sums at prefill (M = 256, the other
    forward) in ``m256``; per-shape rows and the wrapper's host time a call
    beside."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    return {
        "name": "w4a8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w4a8_mm.cu",
        "replaces": "src/repro/kernels/w4a8_mm.py:140",
        "launches": launches,
        "max_abs_err": max_err,
        **layer_record(rows, BATCH, keys),
        "m256": layer_record(rows, BATCH * PROMPT, keys),
        "timed_as": "sum over the 7 packed sites of one layer at decode, M=4, cold L2; m256 "
                    "the same at prefill, M=256; the library call is torch._int_mm on the "
                    "pre-unpacked int8 codes",
        "shapes": rows,
        "wrapper_host_us": host,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__} — run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    walls, t_start = {}, time.perf_counter()

    def phase(n, fn, *args):
        """Run one phase (or a part of one) and print its wall."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[n] = walls.get(n, 0.0) + time.perf_counter() - t0
        print(f"[wall] phase {n} ({fn.__name__}): {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    smi = _smi()
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            # the kernels build while the training that launches none of
            # them runs: phase 15 (a)'s remat turns and phase 18 (a) with
            # its references
            build = pool.submit(build_kernels)
            remat = phase(15, remat_turns, torch, smi)
            mesh_training = phase(18, mesh_training_start, torch, smi)
            smi = phase(1, phase_card, torch, build)
        rows, max_err, host = phase(2, phase_kernel, torch)
        b6_host = phase(2, rmsnorm_host_us, torch, torch.Generator(device="cuda").manual_seed(0))
        launches = phase(3, phase_slice, torch)
        gpfq_rows, gpfq_err = phase(4, phase_gpfq, torch)
        calib = phase(5, phase_calibration, torch)
        paged_rows, paged_err = phase(6, phase_paged_kernels, torch)
        paged = phase(7, phase_paged_slice, torch)
        sparse_k = phase(8, phase_sparse_kernels, torch, gpfq_rows)
        b6 = phase(8, phase_rmsnorm, torch)
        sparse = phase(9, phase_sparse_slice, torch, calib, paged)
        throughput = phase(10, phase_throughput_slice, torch, paged)
        expert_rows, expert_err = phase(11, phase_expert_kernels, torch)
        moe = phase(11, phase_moe_slice, torch)
        search = phase(12, phase_search_slice, torch, smi)
        observe = phase(13, phase_observe_slice, torch, smi, search, paged)
        recurrent = phase(14, phase_recurrent_slice, torch, smi)
        training = phase(15, phase_training_slice, torch, smi, remat)
        # phase 18's gloo ranks run while phases 16 and 17 do, and are read
        # while phase 17's own ranks run
        mesh_training = phase(18, mesh_training_ranks, torch, smi, mesh_training)
        mesh = phase(16, phase_mesh_slice, torch, smi)
        family = phase(17, family_mesh_start, torch, smi)
        mesh_training = phase(18, mesh_training_finish, torch, smi, mesh_training)
        family = phase(17, family_mesh_finish, torch, smi, family)
    finally:
        for p in CHILDREN:
            p.kill()
    print(f"[wall] total {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{n}: {w:.1f}" for n, w in walls.items()), flush=True)
    records = [
        kernel_record(rows, max_err, launches, host),
        paged_record("paged_decode_attention", paged_rows["float"], paged_err["float"],
                     paged["runs"]["act"]["counts"]["paged_decode_attention"], 189),
        paged_record("paged_decode_attention_int8", paged_rows["int8"], paged_err["int8"],
                     paged["runs"]["int8"]["counts"]["paged_decode_attention_int8"], 226),
        sparse_kernel_record(*sparse_k["b4"], sparse["serve_launches"]),
        gpfq_record(gpfq_rows, gpfq_err, calib["launches"], *sparse_k["b5"],
                    sparse["calib_launches"]),
        rmsnorm_record(*b6, b6_host),
        expert_record("w4a8_expert_matmul", expert_rows, expert_err["b1e"],
                      moe["b1e_launches"], "ms", "plain_ms", 140, 263),
        expert_record("w4a8_sparse_expert_matmul", expert_rows, expert_err["b4e"],
                      moe["b4e_launches"], "b4e_ms", "b4e_plain_ms", 311, 410)]
    # phase 10's launches on the throughput loop: (a) float, (a) int8, (b)
    for rec, counter in zip(records[:3], ("w4a8_matmul", "paged_decode_attention",
                                          "paged_decode_attention_int8")):
        rec["throughput_launches"] = [throughput[k]["thr"]["counts"][counter]
                                      for k in ("act", "int8")] + [
            throughput["b"]["run"]["counts"][counter]]
    # phase 12's launches on the search slice: B5 in (a) and (c), B1 and B3
    # serving (b)'s static-KV trace and (c)'s artifact, B4 serving (c)
    for rec, n in zip(records, (search["b1"], None, search["b3"], search["b4"], search["b5"])):
        if n is not None:
            rec["search_launches"] = n
    records[4]["masked"]["search_launches"] = search["b5_masked"]
    # phase 13's launches on the observed engines: B1 and B3 in (a)'s
    # observed trace, B2 in (c)'s float-KV trace
    for rec, n in zip(records[:3], (observe["b1"], observe["b2"], observe["b3"])):
        rec["observe_launches"] = n
    # phase 14's launches on the recurrent families: B1 (xlstm-350m fixed
    # slot, paged, the calibrated artifact, the Jamba-width Mamba block,
    # tiny-hybrid float and int8), B5 calibrating xlstm-350m, and
    # tiny-hybrid's B2 (float pages), B3 (int8) and B1e (float, int8)
    for rec, n in zip(records, (recurrent["b1"], recurrent["b2"], recurrent["b3"], None,
                                recurrent["b5"], None, recurrent["b1e"])):
        if n is not None:
            rec["recurrent_launches"] = n
    # phase 15's launches: B1
    # (the trained artifact, the registry models' fixed slot and paged
    # runs), B2/B3 (paged runs), B5 (the trained checkpoint, the rung)
    for rec, key in zip(records[:3] + records[4:5], ("b1", "b2", "b3", "b5")):
        rec["training_launches"] = training[key]
    records[0]["registry_sites"] = {r["arch"]: r["b1_sites"] for r in training["registry"]}
    # phase 16's launches: B1 on the world-size-1 NCCL mesh (a) and on each
    # of the two gloo ranks (b), and B1 at phi4-mini-3.8b's sharded sites
    records[0]["mesh_launches"] = mesh["b1"]
    records[0]["mesh_sites"] = mesh["b"]["b1"]
    # phase 17's launches: B1e and B1 on granite at NCCL world size 1 (a)
    # and on each gloo rank of (b); B1 on each rank of xlstm-350m (c) and
    # the Mamba block (d); B1e/B4e at granite's expert shards, B1 at the
    # (1, 2) shards of xlstm-350m and the Mamba block
    records[0]["family_launches"] = family["b1"]
    records[0]["family_sites"] = family["b1_rows"]
    records[6]["family_launches"] = family["b1e"]
    records[6]["family_shards"] = [{k: r[k] for k in (
        "E", "M", "K", "N", "ms", "acc_ms", "bound_ms", "bound_by", "library_ms", "plan")}
        for r in family["expert_rows"]]
    records[7]["family_shards"] = [{k: r[k] for k in (
        "E", "M", "K", "N", "b4e_ms", "bound_ms", "bound_by", "library_ms")}
        for r in family["expert_rows"]]
    # phase 18's launches: none on the mesh train steps ((a) both runs, (b),
    # (c) and (d) on each rank)
    for rec, key in zip(records, ("w4a8_matmul", "paged_decode_attention",
                                  "paged_decode_attention_int8", "w4a8_sparse_matmul",
                                  "gpfq_solve", "quant_rmsnorm", "w4a8_expert_matmul",
                                  "w4a8_sparse_expert_matmul")):
        rec["mesh_training_launches"] = mesh_training["launches"][key]
    print(json.dumps({"kernels": records}))
    # one card: every phase runs on cuda:0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        sys.exit(mesh_rank_main(sys.argv))
    if "--family-rank" in sys.argv:
        sys.exit(family_rank_main(sys.argv))
    if "--train-rank" in sys.argv:
        sys.exit(train_rank_main(sys.argv))
    sys.exit(main())
