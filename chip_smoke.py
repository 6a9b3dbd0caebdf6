#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # needs one CUDA device, no arguments

Drives ``repro_torch`` through the entry points a user would call and fails
(non-zero exit, no result line) if any phase fails or there is no CUDA device.
It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing one JSON line:

  env      torch/CUDA versions, the card and its power limit, TF32 settings.
  kernels  builds the CUDA kernels from the sources in this checkout (one
           nvcc per source, all started together) and holds each against its
           plain PyTorch version on the card.  AdaLomo K1/K2: the shapes of
           h2o-danube-1.8b plus ragged ones, for every pairing of fp32 and
           bf16 params and grads; weight decay, the literal mode, a stacked
           [3, m, n] case and a bitwise re-run; deepseek-moe-16b's expert
           batches [64, 2048, 1408] and [64, 1408, 2048] (bf16) and its fp32
           router [2048, 64], with a bitwise re-run on an expert batch;
           paligemma-3b's leaf shapes in bf16 (the layer matrices and the
           tied [257216, 2048] head), steps 1 and 5, r and c against the
           plain version, K2 held on its update at lr 1.0, the head bitwise
           on a re-run; the same at mamba2-1.3b's and zamba2-1.2b's leaf
           shapes (in_proj, out_proj, LoRA sides, the shared block's
           matrices, both tied heads), and at whisper-base's (the attention
           and MLP matrices, the tied [51865, 512] head).  K1/K2's sharded
           entries (ZeRO-3 shards): danube's attn/wq and mlp/w_gate split by
           rows, attn/wo and mlp/w_down by columns, 2 and 4 ways, alone and
           as stacked [24, m, n] leaves, bf16 and fp32, the sums over the
           ranks emulated by fixed-order sums — r and c (3e-5) and theta'
           (K2's tolerance) against the whole-tensor kernels, a bitwise
           re-run, and the shard's element count in place of the tensor's
           made to disagree; timed per shard at a 2-way split.  K1's mode
           3 (a 2-D block of the model axis: both sums left raw): the same
           four leaves split as the rules split them on (data, model) =
           (2, 2) and (1, 2) (wq and w_gate rows over data and columns over
           model, wo and w_down the transpose), alone and [24, m, n], bf16
           and fp32, the grid's sums emulated by fixed-order sums
           (``ref.adalomo_update_grid``) — against its plain version and
           the emulated update against the whole-tensor kernels, a bitwise
           re-run, a block's element count made to disagree; timed on one
           rank's quarter blocks of danube's 170 matrices.
           Paged decode attention K3:
           the CPU tests' cases, a danube-shaped ragged case with and without
           a window, danube serving shapes (8 sequences, 32/8 heads, dh 80,
           pages of 16, up to 2048 tokens), shuffled page tables and garbage
           in the scratch page, runs with no live slot (a short sequence in
           a wide table, a window that leaves only the last page, a
           sequence with no token, which must give 0), fp32 (1e-5) and bf16
           (3e-2), a bitwise re-run, and ten launches on the same ticket
           counters at B 1 and B 8 x 2048 tokens, bit-identical; the same
           serving shapes, runs with no live slot and bitwise re-runs
           (fp32 and bf16) at the other configs' heads (``NEW_HEADS``: dh
           120 and 160 at 32/8 heads, a query group of 1 at 16/16, 64/8 at
           dh 128, paligemma-3b's 8/1 at dh 256, the smoke configs' dh 16
           and 24).
           Ring-cache decode attention K4: the reference kernel
           tests' cases, a dozen ragged rings, danube's shapes (B 8 x W 1024
           and B 4 x W 4096, windows none, 4096 and 256) over partly filled
           rings (empty slots hold large garbage) and wrapped ones, fp32
           (1e-5) and bf16 (3e-2), a bitwise re-run, and ten launches on the
           same ticket counters at B 1 and B 4 x W 4096, bit-identical; rings
           of 1024 (partly filled) and 4096 (wrapped) with bitwise re-runs at
           the other configs' heads, and paligemma-3b's rings of 4 x 1280
           (its prefix phase's) and 8 x 4352 slots at dh 256, zamba2-1.2b's
           32/32 heads at dh 64 (``NEW_HEADS``) and its ring of 4 x 1024
           (the ssm phase's), whisper-base's 8/8 heads at dh 64 over its
           self-attention ring (16 x 448: partly filled at 40, wrapped at
           479) and its cross-attention over 16 x 1500 frames (every slot
           valid, query position 2**30; W not a multiple of 16), each
           with a bitwise re-run.  K4's partial entry (a rank's block of
           a ring split over ranks: o and the log-sum-exp in fp32): each
           half of every K4 case's ring against its plain version, fp32
           and bf16, halves with no valid slot among them (lse -inf, o
           0), the two halves merged against one whole-ring K4 launch
           (fp32 2e-5, bf16 3e-2), bitwise re-runs; timed at
           ``serve_1x2``'s block beside its bound and SDPA's time for o
           alone; the library call that computes the same (o, lse),
           flex_attention with enable_gqa and the log-sum-exp, compiled,
           is timed at the end of the run, after every other phase.  Every
           bf16 and fp32 instance of K3, K4 and the partial entry: its ptxas
           registers and spill bytes, its dynamic shared memory and its
           blocks an SM as the card reports them (each bf16 instance at
           least the blocks its split aims at; at dh 256 at least two and
           no spill), and ten launches back to back on the same tickets at
           paligemma-3b's 8/1 heads, dh 256 (K4 4 x 4096, K3 8 x 1024),
           bit-identical.  Then
           times kernel and plain version (CUDA events, after warm-up, inputs
           rotated so they are not served from the L2 cache) beside the least
           time the card could take, and, for K4,
           scaled_dot_product_attention on the same inputs (the library call,
           never used by the port); for K3 the two-call library path (the
           pages gathered into a dense cache, then the same call).  All four
           kernels, whose launches at danube's smaller shapes take about
           what their wrappers cost on the host, are timed as replays of a
           CUDA graph, with the eager time beside.
  train    ``repro_torch.run.run(spec)``: h2o-danube-1.8b at its published
           width and depth, random weights from a seed, AdaLomo fused into
           the backward pass, batch 4 x 1024 tokens, 3 steps.  Launch counts
           are set to 0 just before and read just after: 170 tensors a step
           go through each kernel.  One device-to-host transfer a step.
           The same spec traced on the meta device (the dry run,
           ``repro_torch/launch/dryrun.py``): its K1/K2 launches equal the
           card's every step, its step peak within 15 % of the card's;
           each ``dist`` sub-phase's ranks trace their own spec so too
           (counts equal every step; peaks printed, held in
           ``gloo_2rank``), the ``dry`` key of each line.
  parity   one fused step at full width and 2 layers, CUDA kernels against the
           plain PyTorch update, from the same weights and batch.
  dist     the sharded run (ZeRO-3 over the data axis), one JSON line a
           part.  A one-rank NCCL world: ``run(spec)`` with mesh (1,) on
           h2o-danube-1.8b at full width and depth, 4 x 1024, 3 steps, twice
           — loss (rtol 1e-5) and params (rtol 5e-4, atol 1e-5, plus one
           bf16 ulp) against the train phase's unsharded run of the same
           seed, bitwise on the re-run (on-card digest), 170 launches a step
           of each of K1/K2's four sharded wrappers and none of the
           whole-tensor ones, collective calls and bytes a step, one host
           sync a step, step seconds and peak beside train's.  Two gloo
           ranks sharing the card (spawned): danube at full width, 4 layers,
           its own bf16 params, global batch 4 x 1024, 2 steps, checkpoints
           every step — loss and params against the unsharded bf16 run at the
           same depth, bounded by that run's own distance from an fp32 run
           of the same seed (losses: rtol 1e-5 or that distance a step;
           params: each leaf's RMS distance at most that run's from fp32),
           then the same in fp32 against the fp32 run within the
           reference's sharded tolerance (loss rtol 1e-5; params rtol 5e-4,
           atol 1e-5), the replicated leaves bitwise equal on both ranks,
           each rank's peak beside the reckoning (half the params, one
           whole layer, one layer's fp32 gradient) and the collectives'
           host staging.  Elastic: the two-rank step-1 checkpoint
           restored onto the one-rank world and onto no mesh,
           every leaf bitwise equal to the files, and each continued to step
           2 with losses within 1e-5 of the two-rank run's.  The model
           axis (sequence and expert parallelism, 2-D ZeRO-3), gloo ranks
           sharing the card, the sub-phases of one mesh run in one world
           of ranks (on (1, 2) two worlds side by side, for the time
           limit: (c), (i), (k) and (m) in one, (f), (g), (h), (j) and
           (l) in the other): (a) danube on (1, 2) at 4 layers, 4 x 1024, 2 steps,
           bf16 then fp32, in the data-axis ranks' world after their runs
           and held as they are;
           (b) four ranks on (2, 2), fp32, 2 layers, 2 steps, at the
           reference's tolerance (the only mesh here whose leaves are split
           both ways: K1 mode 3 launched on every rank); (c)
           deepseek-moe-16b on (1, 2), fp32, 2 layers, 2 x 1024, 2 steps,
           experts expert-parallel and never gathered over model — each
           against the unsharded run at its depth, with per-rank peaks,
           collective calls and bytes a step, step seconds and mode-3
           launches a step, each line printed before its checks.  (d)
           ``model_mla``: deepseek-v3-671b at its published width, 1
           layer, bf16, 1 x 1024 on (1, 2), 2 steps (MLA on the tiles, the
           latent gathered over model, the MTP head on the tiles, 128
           experts a rank) against the unsharded run, run first in a
           process of its own and read back from its checkpoint: losses
           and MTP losses within 1e-3, each rank's blocks beyond rtol
           5e-4 / atol 1e-5 plus one bf16 ulp at most 5e-5 of them, no
           expert stack
           gathered over model, the per-rank peak beside its reckoning
           (``rank_reckoning``).  (e) ``model_moe_1x3``: deepseek-moe-16b,
           2 layers, fp32, 2 x 768 on (1, 3), 2 steps (64 experts over 3
           ranks: every rank runs all of them on the gathered sequence)
           at the reference's sharded tolerance, nothing gathered over
           model.  Every decoder-only family on a model axis, two gloo
           ranks on (1, 2), fp32, 2 steps each, against the
           unsharded run at its depth (loss rtol 1e-5; params rtol 5e-4,
           atol 1e-5), K1/K2 through their sharded entries on every rank,
           each rank's tile checked, its peak beside ``rank_reckoning``:
           (f) ``model_prefix_1x2``: paligemma-3b, 2 layers, 4 x (1024 +
           256), the prefix and the tokens tiled together (tiles of 640:
           tile 0 the 256 patches and 384 tokens); (g) ``model_ssm_1x2``:
           mamba2-1.3b, 2 layers, 4 x 1024, each rank's mixer on the
           sequence gathered over model; (h) ``model_hybrid_1x2``:
           zamba2-1.2b, 7 layers (the shared block at layers 0 and 6), 4 x
           1024; and the encoder-decoder family, (i) ``model_encdec_1x2``:
           whisper-base at full depth (6 + 6 layers), 4 x 448 tokens over
           1500 frames, the frames tiled apart from the tokens (each rank
           750 frames and 224 tokens, both tiles checked), the encoder's
           output gathered once a step and its gradient reduce-scattered
           back to the frame tile, the per-rank peak beside
           ``rank_reckoning`` of the two stacks, the collectives and K1/K2's
           sharded and whole-tensor launches a step a rank, the
           sub-phase's seconds.  (j) ``baseline_1x2``, in (f)'s world:
           the paper-faithful baseline sharding (``MeshSpec.optimized=
           False``: each rank its rows' whole sequence, every whole
           gradient all-reduced, params and state resting as in the
           optimized plan), danube at 2 layers, fp32, 4 x 1024, 2 steps,
           against the unsharded run at the reference's sharded
           tolerance; then the optimized plan at the same depth, whose
           per-rank peak, collectives and K1/K2 launches a step are
           printed beside the baseline's (the same launches, no tile, no
           reduce-scatter, or the phase fails).  (k) ``serve_1x2``, in
           (c)'s world: per-rank prefill and decode
           (``repro_torch/serve/sharded.py``), danube at 2 layers, fp32,
           4 x 6136 tokens into a ring of 4096 slots, 2048 a rank, then
           16 greedy decode steps whose writes cross from rank 0's block
           into rank 1's at step 9 — each rank's logits within 2e-4 of
           the unsharded legacy steps', tokens equal, both ranks' logits
           bitwise equal, each rank's cache block within 2e-4 of its
           slice of the unsharded cache, K4's partial entry once a layer
           a decode step; per rank the peak beside its param and cache
           blocks and their reckoning, collectives and staged bytes a
           prefill and a decode step, seconds, and the dry trace's counts
           equal the card's every step.  (l) ``serve_ssm_1x2``, in (g)'s
           world, the same checks a model, one line each: mamba2-1.3b at
           2 layers, 4 x 1024 tokens, 8 decode steps (its 64 SSM heads 32
           a rank, their outputs gathered before the out norm; no K4),
           then zamba2-1.2b at 7 layers, 4 x 1016 tokens into a ring of
           1024 slots, 512 a rank, 10 decode steps (the first 8 fill rank
           1's slots 1016-1023, the 9th wraps into rank 0's slot 0; K4's
           partial entry twice a step, once a shared-block application).
           (m) ``serve_encdec_1x2``, in (i)'s world: whisper-base at full
           depth, 4 x 1500 frames encoded on tiles of 750, the cross
           cache 750 frames a rank, a self ring of 16 slots, 8 a rank
           (rank 1's empty until the 9th step), 12 decode steps from the
           start token, the encoder's output within 2e-4 too; K4's
           partial entry 12 times a step (6 self, 6 cross).
           ``--phases dist`` without ``train`` runs (b) to (m) alone
           (``--subs`` picks among them).
           The
           optimizer side of a mesh (``optimizers``), two gloo ranks on
           (2,), started before the worlds of (b) to (m) and run beside
           them (for the time limit; its wall and step seconds are taken
           so, its peaks are its own processes'): Table 1's four arms (fused AdaLomo and LOMO, unfused
           Adafactor and AdamW) on danube at 4 layers in bf16, 4 x 1024,
           2 steps each, memory freed and asserted between arms — per
           rank the peak, the params' and state's bytes after init, the
           collectives a step, step seconds, K1/K2's sharded launches
           (the AdaLomo arm only); peaks AdaLomo ~ LOMO (5 %) < Adafactor
           < AdamW, AdamW's state 8 B a param of the rank's blocks, one
           host sync a step outside the gloo staging.  Unfused AdamW and
           Adafactor in fp32 at 2 layers, 2 steps, each rank's blocks
           against the same arm unsharded on the card (loss rtol 1e-5;
           params rtol 5e-4, atol 1e-5; AdamW's near-zero-gradient
           elements counted apart within 2 lr a step, at most 1e-6 of the
           params).  Fused AdaLomo under the sentinel (skip + backoff, the
           trust guard) with every probe (the factored ones every 2), fp32
           at 2 layers, 4 steps, a 100x update at step 3: skipped there on
           both ranks and in the unsharded run, every probe value and
           verdict the same bits on both ranks and within rtol 1e-4 /
           atol 1e-5 of the unsharded run's (histogram counts exactly),
           K1/K2's sharded entries launched, one host sync a step outside
           the staging.
  resume   ``run(spec)`` on h2o-danube-1.8b as in train, 4 steps, with
           checkpoints every 2 steps (3.67 GB each, written under the
           system temp or ``_chip_smoke_tmp/`` and removed), eval every 2
           steps (1 batch), the metrics stream, a heartbeat and a profiler
           window over step 1.  A runs uninterrupted (K1/K2 launch counts
           set to 0 before and read after: 170 a step each; the trace holds
           170 K1 and 340 K2 kernels).  B gets SIGTERM and exits resumable
           at step 2; C resumes it; D's step raises torch.AcceleratorError
           after its 4th call and recovers from the step-2 checkpoint.
           Asserts C's and D's params and OptState bitwise equal to A's,
           their losses and eval losses equal to A's, the marker consumed,
           the metrics stream holding steps 0-3 once, no heartbeat stall.
           Reports each save's and restore's seconds and bytes, the free
           disk, straggler events, step seconds and peak memory.
  sentinel  ``run(spec)`` on h2o-danube-1.8b as in train with the training
           sentinel on (fused AdaLomo through K1/K2, the metrics stream on),
           three runs, each one's memory freed before the next (asserted).
           A: 8 steps, ladder skip+backoff, the optimizer-health probes every
           step (the factored ones every 2), a NaN'd update injected at step
           3 — asserts the verdict nonfinite at 3 only, params and the whole
           OptState after 3 bitwise equal on the card to a copy taken after
           2, opt_state.step 7, K1/K2 1360 launches each (a skipped step
           still launches), one host sync a step, probe records every step
           (finite group ratios, histogram counts summing to the units,
           finite residuals >= 0 on the two largest factored moments) and
           one anomaly record (nonfinite, 3, backoff).  B: 8 steps, an
           update scaled 100x at step 6 — the spike guard fires there only,
           the step is a bitwise no-op, lr scaled 0.1 from step 7.  C: 6
           steps, ladder skip+rollback, checkpoints every 2 (3.67 GB each,
           under the system temp or ``_chip_smoke_tmp/``, removed), a NaN'd
           update at step 4 — rolled back to the step-4 checkpoint,
           quarantine [4, 5), finite losses, the rollback record.  Reports
           step seconds and peak memory beside the train phase's, the
           snapshot's bytes, and C's save and restore seconds.
  baselines  the paper's Table 1: ``run(spec)`` on h2o-danube-1.8b at its
           published width and depth, batch 4 x 1024, 2 steps in four arms
           — AdaLomo fused (K1/K2), LOMO fused, Adafactor unfused, AdamW
           unfused — each arm's memory freed before the next (asserted: the
           card holds what it held before the phase).  Reports per arm the
           peak memory, the bytes after init (params and state), the state's
           and the gradients' bytes, step seconds, losses, K1/K2 launches.
           Asserts finite losses, K1/K2 launches 340 each in the AdaLomo arm
           and 0 elsewhere, one host sync a step, AdamW's state = 8 bytes a
           parameter, peaks AdaLomo ~ LOMO (5 %) < Adafactor < AdamW; then
           AdamW's and Adafactor's steps 1 and 2 on the embedding, a stacked
           [24, 2560, 640] projection and a norm scale, each on the card and
           on CPU copies of what the card held before it: fp32 state within
           1e-6 relative, params within 1e-6 of their step plus one bf16
           ulp (or 1e-6 of an fp32 value).
  packed   ``run(spec)`` on h2o-danube-1.8b as in train with segment-packed
           batches: 2 rows of 4096 tokens of ragged synthetic documents
           (64-3000 tokens), fused AdaLomo (K1/K2), attention on the
           segmented flash branch, 2 steps.  First, at the initial weights:
           two documents' losses (one across a 1024-token block boundary)
           bitwise unchanged when every other document's tokens are junk,
           and each within 1e-2 of the same document alone in a row.  Then
           asserts K1/K2 launches 340 each, one host sync a step, finite
           losses and params; reports step seconds, peak memory, padding
           efficiency and documents a row.
  serve    ``repro_torch.serve.engine.PagedEngine``: h2o-danube-1.8b at its
           published width and depth, bf16, random weights from a seed;
           pages of 16, 8 slots, 128 pages a sequence, 1025 pages, chunks of
           8, 64 new tokens; 16 requests with prompts of 32-1900 tokens from
           a seed, 8 submitted, the other 8 after the first step (mid-flight
           admission).  Asserts: every request emits 64 tokens, every page
           comes back, K3 launches == 24 x decode steps (counted after the
           warmup), synchronising host transfers == chunks + admissions, no
           input signature the warmup had not run.
  serve_parity  at full width and 2 layers, fp32 and bf16: one decode
           step's logits through K3 against the plain version over the same
           pool (within 1e-3 fp32, 0.1 bf16), and greedy tokens of the
           engine end to end (asserted equal in fp32, reported in bf16).
  legacy_serve  ``repro_torch.serve.engine.Engine``: h2o-danube-1.8b at its
           published width and depth, bf16, random weights from a seed; 4
           prompts of 6144 tokens (prefill through the sliding-window gather,
           a ring of the window's 4096 slots that wraps every step), 64
           greedy tokens.  Asserts: 64 tokens a row inside the vocabulary,
           K4 launches == 24 x 63 decode steps, synchronising host transfers
           == 64 (one a step).
  legacy_parity  at full width and 2 layers, fp32 and bf16, after prefills of
           1024, 3072 and 6144 tokens (direct, blockwise and window-gather
           attention): one decode step's logits through K4 against the plain
           version over the same cache (1e-3 fp32, 0.1 bf16), greedy tokens
           of Engine (asserted equal in fp32, reported in bf16); then, fp32
           at danube's heads and 4096 tokens, the flash branch's value and
           gradients against direct attention's autograd.
  moe      deepseek-moe-16b at its published width and depth (28 layers,
           d_model 2048, 16/16 heads, 64 routed experts top-6 of width
           1408, 2 shared, vocab 102400, bf16; 16.9 B parameters), random
           weights from a seed.  ``run(spec)`` with fused AdaLomo at 4 x
           1024, 3 steps: finite losses that move, K1/K2 310 launches a step
           each (the fp32 router through K2's fp32 variant), one host sync a
           step, the aux loss in the metrics, and step 1 re-run from the
           same seed bitwise equal (a digest of params and OptState on the
           card); fused LOMO's peak beside AdaLomo's, and AdamW's and
           Adafactor's bytes reckoned (they cannot fit).  Then PagedEngine
           as in serve (16 requests of 32-1900 tokens, 64 new, 8 slots; K3
           at a query group of 1: 28 launches a decode step), and at 2
           layers the serve_parity checks (greedy tokens asserted in fp32).
  configs  qwen3-32b (full depth, 1 x 1024: 65.5 GB of weights),
           stablelm-12b and h2o-danube-3-4b (full depth, 4 x 1024): one
           fused AdaLomo step each — finite loss, K1/K2 launches (450, 282,
           170), one host sync, peak.  Then for the new head dims
           (stablelm-12b's 160, danube-3's 120) at full depth: PagedEngine
           (8 requests of 32-1000 tokens, 16 new) and Engine (2 x 1024
           tokens, 16 new) with serve's and legacy_serve's token, launch and
           sync checks; at 2 layers, fp32 greedy tokens through K3 and K4
           equal to the plain attention's.

  mla      deepseek-v3-671b at its published widths (d_model 7168, 128
           heads, MLA with q rank 1536, kv rank 512, q/k head dim 128 + 64
           against v head dim 128, 256 routed experts top-8 of width 2048 +
           1 shared, sigmoid router, an MTP head, vocab 129280, bf16; 704.1 B
           parameters at 61 layers), random weights from a seed, depth cut.
           K1/K2 on whole expert batches [256, 7168, 2048] and [256, 2048,
           7168] held against the plain versions on entries 0, 1, 254, 255
           (the last starts past 2**31 elements), bitwise on re-run, timed
           beside their bounds.  ``run(spec)`` with fused AdaLomo at 1 layer,
           1 x 1024, 3 steps: finite losses that move, the aux and MTP losses
           in the metrics, 27 K1/K2 launches a step each, one host sync a
           step, step 1 re-run bitwise (on-card digest); fused LOMO's peak
           within 1 % of AdaLomo's; AdamW and Adafactor reckoned at full
           depth.  Engine at 2 layers (50.4 GB of weights) from the latent
           cache: 4 prompts of 1024 tokens, 32 greedy tokens, one host sync
           a step, no K4 (MLA decodes in plain PyTorch); PagedEngine refuses
           the model.  fp32 at 1 layer: a decode step's logits against a
           prefill over one more token (1e-3), Engine's greedy tokens equal
           to a loop that recomputes the whole sequence.
  prefix   paligemma-3b at its published width and depth (18 layers,
           d_model 2048, 8 query heads over 1 at dh 256, d_ff 16384, a tied
           257,216-token head, gelu, 256 prefix embeddings; 2.51 B
           parameters), bf16, random weights and data from a seed.
           ``run(spec)`` with fused AdaLomo at 4 x (1024 text + 256
           prefix), 3 steps (the direct branch, no flash call): finite
           losses that move, 127 K1/K2 launches a step each, one host sync
           a step, step 1 re-run bitwise (on-card digest); one step at 1 x
           (2048 + 256) through the flash branch with the prefix mask (18
           flash forwards with and 18 without a gradient, 18 recomputing
           backwards); fused LOMO's step at 4 x 1280; AdamW and Adafactor
           reckoned.  Engine through K4 at dh 256: 4 prompts of 1024 tokens
           behind 256 seeded prefix embeddings, 32 greedy tokens, 18 K4
           launches a decode step, one host sync a step, the same tokens on
           a re-run and through the plain attention; one decode step's
           bf16 logits through K4 within 0.15 of the plain attention's and
           within the gap between the plain attention's and an fp32 copy of
           the model's; PagedEngine refuses the model.  fp32 at full
           depth: a decode step's logits through K4 within 1e-3 of the
           plain attention's, Engine's greedy tokens equal.
  ssm      mamba2-1.3b (48 layers, d_model 2048, 64 SSD heads of 64 over a
           state of 128, chunk 128, a tied 50,280-token head; 1.34 B) and
           zamba2-1.2b (38 mamba2 layers with a state of 64, a shared
           attention block at 32/32 heads, dh 64, applied at layers 0, 6,
           ..., 36 on concat(x, x0) with a LoRA of rank 128 a layer, d_ff
           8192, vocab 32000; 1.21 B) at their published widths and
           depths, bf16, random weights and data from a seed.  Each:
           ``run(spec)`` with fused AdaLomo at 4 x 1024, 3 steps — finite
           losses that move, every param finite after step 1 and after the
           run, K1/K2 97 (mamba2) and 312 (zamba2) launches a step, one host
           sync a step, step 1 re-run bitwise (on-card digest), peak; fused
           LOMO's step and peak.  Engine over the state cache, 4 prompts of
           1024 tokens, 32 greedy tokens, one host sync a step, the same
           tokens on a re-run: mamba2 with no K4 launch; zamba2 with 7 K4
           launches a decode step, its tokens equal to the plain
           attention's in fp32 (the same weights widened); in bf16,
           teacher-forced on K4's tokens, every step's logits within 0.15
           of the plain attention's and every argmax flip at a near tie.
           fp32 at 2 layers (zamba2 at 7: two
           applications): a decode step's logits within 1e-3 of a prefill
           over one more token, Engine's greedy tokens equal to a loop that
           recomputes the whole sequence.  PagedEngine refuses both.  Then
           Table 1 on mamba2-1.3b at 4 x 1024: unfused Adafactor measured,
           unfused AdamW reckoned (it does not fit on the card), beside
           fused AdaLomo.
  encdec   whisper-base at its published widths and depth (6 + 6 layers,
           d_model 512, 8/8 heads at dh 64, d_ff 2048, a tied 51,865-token
           head, 1500 frames; 70.7 M parameters), bf16, random weights and
           frames from a seed.  ``run(spec)`` with fused AdaLomo at 16 x 448
           decoder tokens over 1500 frames, 3 steps: finite losses that
           move, every param finite after step 1, 97 K1/K2 launches a step,
           one host sync a step, step 1 re-run bitwise (on-card digest);
           Table 1 at the same batch, all four arms measured (fused LOMO,
           unfused Adafactor and AdamW, 2 steps each; peaks AdaLomo, LOMO <
           Adafactor < AdamW).  ``make_prefill_step(max_decode_len=448)``
           on 16 x 1500 frames and 64 greedy decode steps from
           <|startoftranscript|> (50258), both attentions of a step through
           K4 (12 launches a step), one host sync a step, the same tokens
           on a re-run; against the plain attention, teacher-forced bf16
           logits within 0.15 with every argmax flip at a near tie, and fp32
           (the same weights widened) greedy tokens equal.  fp32 at 2 + 2
           layers: every decode step's logits within 1e-4 of the
           teacher-forced decoder forward's over the prefill's encoder
           output.  ``Engine`` refuses the family (it is served by its step
           functions).
  sweep    ``repro_torch.fleet.sweep.run_sweep`` in subprocess mode, the
           three members at once, on mamba2-1.3b at full size, 2 x 512 tokens,
           2 steps a member: AdaLomo at lr 5e-4 and 1e-3 and LOMO, each
           member ``python -m repro_torch.launch.train --spec ... --device
           cuda`` — every member done, ``report.json`` ranked by final
           loss, a second call skipping all three (``DONE.json``); each
           member's wall seconds.

Then the card's name and power limit, one JSON line that lists the kernels
with their measured numbers, and the result line.

``--phases configs_lomo`` (not in the default run, to keep it short) takes
Table 1's fused LOMO step of qwen3-32b at full depth, 1 x 1024.

``--phases timing`` (not in the default run) times the kernels as the
kernels phase does, without its checks, and prints digests of their outputs
on seeded inputs; with ``--src DIR`` it imports ``repro_torch`` from another
tree, so that one call can time a parent commit and this one with the same
script (parent, change, change, parent) and show which kernels' outputs
stayed bit-identical.

Matrix products stay full fp32 for fp32 inputs: TF32 is switched off here,
for matmul (PyTorch's default) and for cuDNN (not its default).

The whole-step re-run is reported, not asserted: the hand-written kernels
are bit-reproducible (asserted in ``kernels``), the token-embedding gradient
goes through ``F.embedding``'s sorted, fixed-order backward, and what is
left is cuBLAS, which this script does not vouch for.
"""
import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available() "
                     "is False); this script measures on the GPU only\n")
    sys.exit(1)

# --src DIR imports repro_torch from another tree (a parent commit unpacked
# beside this one), so that this script times both in one process's terms
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
for _i, _arg in enumerate(sys.argv[1:], 1):
    if _arg.startswith("--src="):
        SRC = os.path.abspath(_arg.split("=", 1)[1])
    elif _arg == "--src" and _i + 1 < len(sys.argv):
        SRC = os.path.abspath(sys.argv[_i + 1])
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402

from repro_torch.core import optimizers as opt_lib  # noqa: E402
from repro_torch.core.adalomo import AdaLomoConfig  # noqa: E402
from repro_torch.core.tree import (leading_pieces, tree_leaves,  # noqa: E402
                                   tree_map)
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.adalomo_update import adalomo_update as K  # noqa: E402
from repro_torch.kernels.adalomo_update.ops import adalomo_update  # noqa: E402
from repro_torch.kernels.adalomo_update.ref import adalomo_step_ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as KD  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref, ring_decode_attention_ref)
from repro_torch.models import layers as ML  # noqa: E402
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.models.transformer import cache_window  # noqa: E402
from repro_torch.run import (ModelSpec, OptSpec, RunSpec, StepSpec,  # noqa: E402
                             TimingHook, run)
from repro_torch.serve.engine import (Engine, PagedEngine,  # noqa: E402
                                      PagedServeConfig, ServeConfig)
from repro_torch.serve.paging import build_block_tables  # noqa: E402

DEV = torch.device("cuda", 0)
ARCH_ID = "h2o-danube-1.8b"

# Published peaks of one H100 SXM: memory rate, and fp32 outside the tensor
# cores (both kernels do plain fp32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Operations per element: K1 squares, adds eps and adds into two sums; K2 (in
# each of its two passes) forms v_hat, a square root, a division and the sums
# or the write.
K1_FLOP_PER_ELEM = 4
K2_FLOP_PER_ELEM = 13

# Per layer: wq, wo (2560, 2560); wk, wv (2560, 640); w_gate, w_up
# (2560, 6912); w_down (6912, 2560).  Outside: tok_embed, head.
N_LAYERS = 24
DANUBE_SHAPES = {(2560, 2560): 2 * N_LAYERS, (2560, 640): 2 * N_LAYERS,
                 (2560, 6912): 2 * N_LAYERS, (6912, 2560): N_LAYERS,
                 (32000, 2560): 1, (2560, 32000): 1}
TENSORS_PER_STEP = sum(DANUBE_SHAPES.values())          # 170
RAGGED_SHAPES = [(300, 700), (128, 130), (1000, 96), (16, 4096)]
DTYPE_PAIRS = [(torch.float32, torch.float32),       # (param, grad)
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32)]
# Tolerances of the reference's kernel tests: params 1e-5 in fp32, 5e-3
# where a bf16 value is stored (one bf16 rounding at the write); r and c
# rtol 3e-5 / atol 1e-5 (another summation order).
TOL_P = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
TOL_RC = dict(rtol=3e-5, atol=1e-5)

CFG = AdaLomoConfig()


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}), flush=True)


def progress(msg: str) -> None:
    """A line on standard error as each part of a phase starts, so that a
    run cut by its time limit shows where it stood."""
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def make_inputs(shape, pdt, gdt, seed, step, lead=()):
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    full = tuple(lead) + tuple(shape)
    p = (torch.randn(full, generator=g, device=DEV) * 0.1).to(pdt)
    gr = (torch.randn(full, generator=g, device=DEV) * 0.3).to(gdt)
    live = 1e-2 if step > 1 else 0.0
    r = torch.rand(full[:-1], generator=g, device=DEV) * live
    c = torch.rand(full[:-2] + full[-1:], generator=g, device=DEV) * live
    return p, gr, r, c


def scal_for(r, lr, step, beta, wd, clip):
    """The [.., 4] scalar buffer of K2, as ``ops.adalomo_update`` forms it."""
    denom = torch.clamp_min(r.sum(dim=-1), CFG.eps_stat)
    corr = max(1.0 - beta ** step, CFG.eps_stat)
    inv = 1.0 / (denom * corr)
    return torch.stack([inv, torch.full_like(inv, lr),
                        torch.full_like(inv, 1.0 - lr * wd),
                        torch.full_like(inv, clip)], dim=-1)


def max_err(a, b) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def assert_close(a, b, *, rtol, atol, what):
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    bad = (a32 - b32).abs() > atol + rtol * b32.abs()
    if bool(bad.any()) or not bool(torch.isfinite(a32).all()):
        raise AssertionError(
            f"{what}: kernel and plain version disagree "
            f"(max abs err {max_err(a, b):.3e}, rtol {rtol}, atol {atol})")


def check_kernels(errs: dict) -> int:
    """K1 and K2, each against its plain version on the same inputs."""
    n = 0
    beta, lr = 0.999, 5e-4
    beta_t = torch.full((), beta, device=DEV)
    for shape in list(DANUBE_SHAPES) + RAGGED_SHAPES:
        for pdt, gdt in DTYPE_PAIRS:
            for step in (1.0, 5.0):
                p, g, r, c = make_inputs(shape, pdt, gdt,
                                         shape[0] * 7 + shape[1], step)
                what = f"{shape} {pdt}/{gdt} step {step}"
                # K1
                want_r, want_c = K.adalomo_stats_ref(g, r, c, beta_t,
                                                     eps_stat=CFG.eps_stat)
                K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
                assert_close(r, want_r, what="adalomo_stats r " + what,
                             **TOL_RC)
                assert_close(c, want_c, what="adalomo_stats c " + what,
                             **TOL_RC)
                errs["adalomo_stats"] = max(errs["adalomo_stats"],
                                            max_err(r, want_r),
                                            max_err(c, want_c))
                # K2, on the r', c' that K1 just wrote
                scal = scal_for(r, lr, step, beta, 0.0, 1.0)
                want_p = K.adalomo_update_ref(
                    p, g, r, c, scal, eps_div=CFG.eps_div,
                    eps_rms=CFG.eps_rms, literal=False)
                K.adalomo_update(p, g, r, c, scal, eps_div=CFG.eps_div,
                                 eps_rms=CFG.eps_rms, literal=False)
                assert_close(p, want_p, rtol=TOL_P[pdt], atol=TOL_P[pdt],
                             what="adalomo_update " + what)
                errs["adalomo_update"] = max(errs["adalomo_update"],
                                             max_err(p, want_p))
                n += 1
    torch.cuda.synchronize()
    return n


# deepseek-moe-16b's leaves that the dense configs lack, as the fused step
# hands them over: expert stacks (one layer's [64, m, n] a call, 64
# independent matrices) and the fp32 router
MOE_KERNEL_CASES = {"experts [64,2048,1408]": ((2048, 1408), (64,),
                                               torch.bfloat16),
                    "experts [64,1408,2048]": ((1408, 2048), (64,),
                                               torch.bfloat16),
                    "router fp32 [2048,64]": ((2048, 64), (), torch.float32)}
MOE_CALLS_PER_STEP = {"experts [64,2048,1408]": 56,
                      "experts [64,1408,2048]": 28,
                      "router fp32 [2048,64]": 28}


def check_moe_kernels(errs: dict) -> dict:
    """K1 and K2 at deepseek-moe-16b's expert batches and fp32 router
    against their plain versions, steps 1 and 5 (params and grads in the
    leaf's dtype, as the fused step passes them), and a bitwise re-run of
    the whole op on an expert batch."""
    beta, lr = 0.999, 5e-4
    beta_t = torch.full((), beta, device=DEV)
    n = 0
    for name, (shape, lead, dt) in MOE_KERNEL_CASES.items():
        for step in (1.0, 5.0):
            p, g, r, c = make_inputs(shape, dt, dt, shape[0] + len(lead),
                                     step, lead=lead)
            what = f"{name} step {step}"
            want_r, want_c = K.adalomo_stats_ref(g, r, c, beta_t,
                                                 eps_stat=CFG.eps_stat)
            K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
            assert_close(r, want_r, what="adalomo_stats r " + what, **TOL_RC)
            assert_close(c, want_c, what="adalomo_stats c " + what, **TOL_RC)
            errs["adalomo_stats"] = max(errs["adalomo_stats"],
                                        max_err(r, want_r), max_err(c, want_c))
            scal = scal_for(r, lr, step, beta, 0.0, 1.0)
            want_p = K.adalomo_update_ref(p, g, r, c, scal,
                                          eps_div=CFG.eps_div,
                                          eps_rms=CFG.eps_rms, literal=False)
            K.adalomo_update(p, g, r, c, scal, eps_div=CFG.eps_div,
                             eps_rms=CFG.eps_rms, literal=False)
            assert_close(p, want_p, rtol=TOL_P[dt], atol=TOL_P[dt],
                         what="adalomo_update " + what)
            errs["adalomo_update"] = max(errs["adalomo_update"],
                                         max_err(p, want_p))
            n += 1
            del p, g, r, c, want_r, want_c, want_p
    runs = []
    for _ in range(2):
        p, g, r, c = make_inputs((2048, 1408), torch.bfloat16, torch.bfloat16,
                                 6, 3.0, lead=(64,))
        adalomo_update(p, g, r, c, 5e-4, 3.0, 0.999, 0.01, 1.0)
        runs.append((p, r, c))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("adalomo_update on [64, 2048, 1408]: the same "
                             "inputs did not give bit-identical outputs")
    del runs
    torch.cuda.empty_cache()
    return {"cases": n, "rerun_bitwise": True}


# K2 on a bf16 leaf is held on its update, at an lr whose update is as large
# as the params (std 0.1): a few hundred bf16 ulps where one rounding is at
# most 0.3 % of the largest update (at an lr of 5e-4 the update is a tenth
# of a bf16 ulp of such a param).  Per matrix, the kernel's update (θ' − θ)
# lies within 1 % of the largest plain update (fp32, unrounded) of the
# plain one, and the plain update moves at least 95 % of the matrix's bf16
# elements; a matrix left unwritten, a flipped sign or another matrix's r
# and c are off by the whole update.
K2_HELD_LR = 1.0
K2_HELD_UPDATE_RTOL = 1e-2
K2_HELD_MOVED_MIN = 0.95


def held_update(p0, p_new, want32, what: str) -> dict:
    """K2's update ``p0 -> p_new`` of a matrix or a batch of them (the
    last two dims) against the plain version's fp32 result ``want32``: per
    matrix, the largest gap between the two updates over the plain update's
    largest value, which must stay within ``K2_HELD_UPDATE_RTOL``, and the
    share of its bf16 elements the plain update moves, at least
    ``K2_HELD_MOVED_MIN``."""
    base = p0.to(torch.float32)
    d_plain = want32 - base
    gap = (p_new.to(torch.float32) - base - d_plain).abs().amax(dim=(-2, -1))
    rel = gap / d_plain.abs().amax(dim=(-2, -1))
    moved = (want32.to(p0.dtype) != p0).to(torch.float32).mean(dim=(-2, -1))
    rec = {"update_rel_err": rel.tolist(), "moved_share": moved.tolist(),
           "max_abs_err_vs_fp32": max_err(p_new, want32)}
    if (bool((rel > K2_HELD_UPDATE_RTOL).any())
            or bool((moved < K2_HELD_MOVED_MIN).any())):
        raise AssertionError(
            f"{what}: the kernel's update and the plain one disagree, or the "
            f"plain one does not move the matrices "
            f"(rtol {K2_HELD_UPDATE_RTOL}, moved >= {K2_HELD_MOVED_MIN}): "
            f"{rec}")
    return rec


# paligemma-3b's leaves as its fused step hands them over, one 2-D matrix a
# call, bf16 params and grads: the layer slices of wq and wo, wk and wv,
# w_gate and w_up, w_down (18 of each) and the tied embedding, 527 M
# elements, the widest leaf K1/K2 take
PALI_KERNEL_CASES = {"wq, wo [2048,2048]": (2048, 2048),
                     "wk, wv [2048,256]": (2048, 256),
                     "w_gate, w_up [2048,16384]": (2048, 16384),
                     "w_down [16384,2048]": (16384, 2048),
                     "tied embedding [257216,2048]": (257216, 2048)}
# the state-space configs' leaves that the earlier cases lack, as their fused
# steps hand them over (bf16, one 2-D matrix a call): mamba2-1.3b's in_proj,
# out_proj (zamba2-1.2b's too) and tied head; zamba2-1.2b's in_proj, LoRA
# sides, shared attention and MLP projections and tied head
SSM_KERNEL_CASES = {"mamba2 in_proj [2048,8512]": (2048, 8512),
                    "out_proj, shared wq/wk/wv [4096,2048]": (4096, 2048),
                    "mamba2 tied embedding [50280,2048]": (50280, 2048),
                    "zamba2 in_proj [2048,8384]": (2048, 8384),
                    "zamba2 lora A [4096,128]": (4096, 128),
                    "zamba2 lora B [128,2048]": (128, 2048),
                    "zamba2 shared wo [2048,2048]": (2048, 2048),
                    "zamba2 w_gate, w_up [2048,8192]": (2048, 8192),
                    "zamba2 w_down [8192,2048]": (8192, 2048),
                    "zamba2 tied embedding [32000,2048]": (32000, 2048)}


# whisper-base's leaves (bf16, one 2-D matrix a call, as its fused step
# hands them over): the attention projections, the MLP's two and the tied
# head, whose 51,865 rows are odd
WHISPER_KERNEL_CASES = {"whisper wq, wk, wv, wo [512,512]": (512, 512),
                        "whisper w_up [512,2048]": (512, 2048),
                        "whisper w_down [2048,512]": (2048, 512),
                        "whisper tied embedding [51865,512]": (51865, 512)}


def check_leaf_kernels(errs: dict, cases: dict, rerun: tuple) -> dict:
    """K1 then K2 at a model's leaf shapes (``cases``: name -> shape), bf16,
    steps 1 and 5: K1's r' and c' against the plain version within
    ``TOL_RC``, K2's update (at ``K2_HELD_LR``, on the r', c' K1 wrote)
    against the plain version's fp32 one by ``held_update``; then the step-5
    inputs of each case named in ``rerun`` (the tied heads) again,
    bitwise."""
    beta, lr = 0.999, K2_HELD_LR
    beta_t = torch.full((), beta, device=DEV)
    kw2 = dict(eps_div=CFG.eps_div, eps_rms=CFG.eps_rms, literal=False)
    rows = {}
    for name, shape in cases.items():
        for step in (1.0, 5.0):
            p, g, r, c = make_inputs(shape, torch.bfloat16, torch.bfloat16,
                                     shape[0] * 3 + shape[1], step)
            what = f"{name} step {step}"
            want_r, want_c = K.adalomo_stats_ref(g, r, c, beta_t,
                                                 eps_stat=CFG.eps_stat)
            K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
            assert_close(r, want_r, what="adalomo_stats r " + what, **TOL_RC)
            assert_close(c, want_c, what="adalomo_stats c " + what, **TOL_RC)
            scal = scal_for(r, lr, step, beta, 0.0, 1.0)
            p0 = p.clone()
            want_p = K.adalomo_update_ref(p0.to(torch.float32), g, r, c,
                                          scal, **kw2)
            K.adalomo_update(p, g, r, c, scal, **kw2)
            update = held_update(p0, p, want_p, "adalomo_update " + what)
            err = {"adalomo_stats": max(max_err(r, want_r),
                                        max_err(c, want_c)),
                   "adalomo_update": max_err(p, want_p)}
            errs["adalomo_stats"] = max(errs["adalomo_stats"],
                                        err["adalomo_stats"])
            rows[what] = {"max_abs_err": err, "update": update}
            del p, g, r, c, p0, want_r, want_c, want_p, scal
            torch.cuda.empty_cache()
    for name in rerun:
        runs = []
        for _ in range(2):
            p, g, r, c = make_inputs(cases[name], torch.bfloat16,
                                     torch.bfloat16, 8, 5.0)
            K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
            K.adalomo_update(p, g, r, c, scal_for(r, lr, 5.0, beta, 0.0,
                                                  1.0), **kw2)
            runs.append((p, r, c))
            del g
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        del runs
        torch.cuda.empty_cache()
        if not bitwise:
            raise AssertionError(f"K1/K2 on {name}: the same inputs did not "
                                 "give bit-identical outputs")
    return {"per_case": rows, "rerun_bitwise": list(rerun)}


def check_op_variants() -> dict:
    """The whole op (K1, glue, K2) against the port's oracle: weight decay,
    the literal mode, a stacked [3, m, n] tensor, and a bitwise re-run."""
    out = {}
    cases = {"weight_decay": dict(lr=0.1, wd=0.5, cfg=CFG, lead=()),
             "literal": dict(lr=1e-3, wd=0.0,
                             cfg=AdaLomoConfig(literal_div_v=True), lead=()),
             "stacked": dict(lr=1e-3, wd=0.1, cfg=CFG, lead=(3,))}
    for name, kw in cases.items():
        p, g, r, c = make_inputs((300, 700), torch.float32, torch.float32,
                                 11, 2.0, lead=kw["lead"])
        want = adalomo_step_ref(p, g, r, c, lr=kw["lr"], step=2.0,
                                weight_decay=kw["wd"], cfg=kw["cfg"])
        adalomo_update(p, g, r, c, kw["lr"], 2.0, 0.999, kw["wd"], 1.0,
                       cfg=kw["cfg"])
        assert_close(p, want[0], rtol=2e-5, atol=2e-6, what=f"op {name} p")
        assert_close(r, want[1], rtol=2e-5, atol=2e-7, what=f"op {name} r")
        assert_close(c, want[2], rtol=2e-5, atol=2e-7, what=f"op {name} c")
        out[name] = max_err(p, want[0])
    runs = []
    for _ in range(2):
        p, g, r, c = make_inputs((2560, 6912), torch.bfloat16, torch.bfloat16,
                                 5, 3.0)
        adalomo_update(p, g, r, c, 5e-4, 3.0, 0.999, 0.01, 1.0)
        runs.append((p, r, c))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    if not bitwise:
        raise AssertionError("the same inputs did not give bit-identical "
                             "outputs on a re-run")
    out["rerun_bitwise"] = bitwise
    return out


def time_ms(fn, sets, rounds: int) -> float:
    """Mean device time of ``fn(*set)`` over ``rounds`` passes over ``sets``."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        for s in sets:
            fn(*s)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (rounds * len(sets))


def time_graph_ms(fn, sets, rounds: int) -> float:
    """Mean device time of ``fn(*set)``, from one CUDA graph of ``rounds``
    passes over ``sets``, replayed: the host's cost per call (the wrapper's
    checks and allocations, the launch itself) drops out, which matters for
    calls that take tens of microseconds on the device."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for s in sets:
                fn(*s)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (rounds * len(sets))


def time_kernels() -> tuple:
    """Per danube shape, bf16 params and grads (what the train step passes):
    kernel, plain-version and bound, in ms, and per step (x the shape's
    count of the 170 tensors); then per call at deepseek-moe-16b's expert
    batches and fp32 router.  Kernel and plain version are timed as
    replays of a CUDA graph, because at danube's smaller shapes an eager
    launch takes about what the wrapper costs on the host; eager_ms is the
    kernel launched one call after another from the host."""
    beta_t = torch.full((), 0.999, device=DEV)
    kw2 = dict(eps_div=CFG.eps_div, eps_rms=CFG.eps_rms, literal=False)

    def k1(p, g, r, c, s):
        K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)

    def k1_plain(p, g, r, c, s):
        K.adalomo_stats_ref(g, r, c, beta_t, eps_stat=CFG.eps_stat)

    def k2(p, g, r, c, s):
        K.adalomo_update(p, g, r, c, s, **kw2)

    def k2_plain(p, g, r, c, s):
        K.adalomo_update_ref(p, g, r, c, s, **kw2)

    def time_shape(shape, lead, dt, count):
        m, n = shape
        L = math.prod(lead)
        elt = torch.finfo(dt).bits // 8
        set_bytes = 2 * L * m * n * elt
        copies = min(32, max(2, math.ceil(192e6 / set_bytes)))
        sets = []
        for i in range(copies):
            p, g, r, c = make_inputs(shape, dt, dt, i, 5.0, lead=lead)
            K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
            sets.append((p, g, r, c, scal_for(r, 5e-4, 5.0, 0.999, 0.0, 1.0)))
        rounds = max(2, min(20, 200 // copies))
        state_bytes = 4 * L * (m + n)
        k1_bytes = L * m * n * elt + 2 * state_bytes      # g; r, c in and out
        k2_bytes = 3 * L * m * n * elt + state_bytes + 16 * L  # theta, g
        row = {"shape": list(lead) + list(shape), "dtype": str(dt),
               "per_step": count}
        for key, fn, plain, nbytes, flop in (
                ("stats", k1, k1_plain, k1_bytes, K1_FLOP_PER_ELEM),
                ("update", k2, k2_plain, k2_bytes, K2_FLOP_PER_ELEM)):
            row[key + "_ms"] = time_graph_ms(fn, sets, rounds)
            row[key + "_eager_ms"] = time_ms(fn, sets, rounds)
            row[key + "_plain_ms"] = time_graph_ms(plain, sets, rounds)
            row[key + "_bound_ms"] = max(
                nbytes / HBM_BYTES_PER_S,
                flop * L * m * n / FP32_FLOP_PER_S) * 1e3
        del sets
        torch.cuda.empty_cache()
        return row

    rows = [time_shape(shape, (), torch.bfloat16, count)
            for shape, count in DANUBE_SHAPES.items()]

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in rows)

    totals = {name: {k: per_step(f"{key}_{k}")
                     for k in ("ms", "eager_ms", "plain_ms", "bound_ms")}
              for name, key in (("adalomo_stats", "stats"),
                                ("adalomo_update", "update"))}
    # deepseek-moe-16b's own leaves, per call (28 layers: 56, 28 and 28 calls
    # a step); not in the danube totals
    moe_rows = {name: time_shape(shape, lead, dt, MOE_CALLS_PER_STEP[name])
                for name, (shape, lead, dt) in MOE_KERNEL_CASES.items()}
    return rows, totals, moe_rows


def ptxas_by_entry(lines: list) -> dict:
    """``ptxas -v`` lines of a build log by kernel: each entry function's
    mangled name and the register and spill lines that follow it."""
    out, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if "'" in ln else ln
            out[cur] = []
        elif cur and ("registers" in ln or "spill" in ln):
            out[cur].append(ln.split(":", 1)[-1].strip())
    return out


# K3's and K4's kernel instances in the ptxas log: (entry, dtype, dh) from a
# mangled name (the partial entry's bf16 kernel writes fp32; its fp32 kernel
# is K4's own)
DECODE_INSTANCES = (
    (re.compile(r"22ring_decode_kernel_mmaILi(\d+)E\d*__nv_bfloat16E"),
     "ring", torch.bfloat16),
    (re.compile(r"22ring_decode_kernel_mmaILi(\d+)EfE"), "partial",
     torch.bfloat16),
    (re.compile(r"18ring_decode_kernelILi(\d+)EE"), "ring", torch.float32),
    (re.compile(r"19paged_decode_kernelI\d*__nv_bfloat16Li(\d+)EE"),
     "paged", torch.bfloat16),
    (re.compile(r"19paged_decode_kernelIfLi(\d+)EE"), "paged",
     torch.float32))


def decode_usage(by_entry: dict) -> dict:
    """Every bf16 and fp32 instance of K3, K4 and K4's partial entry: its
    ptxas registers and spill bytes (stores, loads; from the build log)
    beside its blocks an SM, dynamic shared memory, registers and local
    memory as the card reports them (``KD.kernel_usage``), emitted as a
    line of its own.  Then asserts that each bf16 instance fits the blocks
    an SM its split aims at (``KD.blocks_per_sm``: the grid in one wave)
    and that at head dim 256 every instance fits two blocks an SM and
    spills nothing."""
    logged = {}
    for name, lines in by_entry.items():
        for pattern, entry, dtype in DECODE_INSTANCES:
            hit = pattern.search(name)
            if hit:
                text = " ".join(lines)
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", text)
                logged[(entry, dtype, int(hit.group(1)))] = {
                    "ptxas_registers": int(regs.group(1)) if regs else None,
                    "ptxas_spill_bytes": ([int(spill.group(1)),
                                           int(spill.group(2))]
                                          if spill else None),
                    "ptxas": lines}
    out, failures = {}, []
    for dh in KD.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for entry in ("paged", "ring", "partial"):
                # fp32: the partial entry launches K4's own kernel
                key = ("ring" if entry == "partial" and
                       dtype == torch.float32 else entry, dtype, dh)
                row = dict(KD.kernel_usage(entry, dtype, dh))
                row.update(logged.get(key, {"ptxas_registers": None,
                                            "ptxas_spill_bytes": None}))
                if dh != 256:
                    row.pop("ptxas", None)
                name = f"{entry} {str(dtype)[6:]} dh{dh}"
                out[name] = row
                if dtype == torch.bfloat16 and \
                        row["blocks_per_sm"] < KD.blocks_per_sm(dh):
                    failures.append(
                        f"{name}: {row['blocks_per_sm']} blocks an SM on "
                        f"the card, the split aims at "
                        f"{KD.blocks_per_sm(dh)}")
                if dh == 256 and (row["blocks_per_sm"] < 2 or
                                  row["ptxas_spill_bytes"] != [0, 0]):
                    failures.append(
                        f"{name}: {row['blocks_per_sm']} blocks an SM, "
                        f"{row['ptxas_spill_bytes']} bytes spilled (stores, "
                        "loads; two blocks and none wanted)")
    emit("kernels_decode_instances", instances=out,
         blocks_per_sm_aimed={dh: KD.blocks_per_sm(dh)
                              for dh in KD.HEAD_DIMS})
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_kernels() -> dict:
    t0 = time.time()
    libs = [(K.LIB_NAME, K.SOURCES), (KD.LIB_NAME, KD.SOURCES)]
    progress("kernels: building")
    build.load_libraries(libs)         # every nvcc at once, from the sources
    K._library()
    KD._library()
    build_s = time.time() - t0
    progress(f"kernels: built in {build_s:.1f} s")
    usage, by_entry = {}, {}
    for name, sources in libs:
        log = build.build_dir(name, list(sources)) / "build.log"
        lines = log.read_text().splitlines() if log.exists() else []
        usage[name] = sorted({ln.split(":", 1)[-1].strip() for ln in lines
                              if "registers" in ln or "spill" in ln})
        by_entry.update(ptxas_by_entry(lines))
    errs = {"adalomo_stats": 0.0, "adalomo_update": 0.0,
            "adalomo_stats_sharded": 0.0, "adalomo_update_sharded": 0.0,
            "adalomo_stats_2d": 0.0,
            "paged_decode_attention": 0.0, "decode_attention": 0.0,
            "decode_attention_partial": 0.0}
    progress("kernels: K1/K2 cases")
    n_cases = check_kernels(errs)
    variants = check_op_variants()
    progress("kernels: K1/K2 sharded entries at danube's shards")
    sharded_checks = check_sharded_kernels(errs)
    progress("kernels: K1 mode 3 at danube's 2-D blocks")
    block_checks = check_block_kernels(errs)
    progress("kernels: K1/K2 at the MoE shapes")
    moe_checks = check_moe_kernels(errs)
    progress("kernels: K1/K2 at paligemma-3b's shapes")
    pali_checks = check_leaf_kernels(errs, PALI_KERNEL_CASES,
                                     ("tied embedding [257216,2048]",))
    progress("kernels: K1/K2 at mamba2-1.3b's and zamba2-1.2b's shapes")
    ssm_checks = check_leaf_kernels(
        errs, SSM_KERNEL_CASES, ("mamba2 tied embedding [50280,2048]",
                                 "zamba2 tied embedding [32000,2048]"))
    progress("kernels: K1/K2 at whisper-base's shapes")
    whisper_checks = check_leaf_kernels(
        errs, WHISPER_KERNEL_CASES, ("whisper tied embedding [51865,512]",))
    progress("kernels: K3 cases")
    k3_cases, k3_bitwise = check_k3(errs)
    progress("kernels: K4 cases")
    k4_cases, k4_bitwise = check_k4(errs)
    progress("kernels: K4's partial entry, and halves merged")
    partial_checks = check_k4_partial(errs)
    progress("kernels: timing K1/K2")
    rows, totals, moe_rows = time_kernels()
    progress("kernels: timing K1/K2's sharded entries")
    shard_rows, shard_totals = time_sharded_kernels()
    totals.update(shard_totals)
    progress("kernels: timing K1 mode 3")
    block_rows, totals["adalomo_stats_2d"] = time_block_kernels()
    progress("kernels: timing K3")
    k3_rows, totals["paged_decode_attention"] = time_k3()
    progress("kernels: timing K4")
    k4_rows, totals["decode_attention"] = time_k4()
    progress("kernels: timing K4's partial entry")
    partial_rows = time_k4_partial()
    totals["decode_attention_partial"] = partial_rows["float32"]
    progress("kernels: K3/K4 instances on the card")
    decode_instances = decode_usage(by_entry)
    emit("kernels", kernels=["adalomo_stats", "adalomo_update",
                             "paged_decode_attention", "decode_attention",
                             "decode_attention_partial"],
         build_seconds=build_s, ptxas=usage,
         decode_instances=decode_instances, cases=n_cases,
         max_abs_err=errs, op_variants=variants,
         tolerances={"param_fp32": 1e-5, "param_bf16": 5e-3, "r_c": TOL_RC,
                     "paged_fp32": 1e-5, "paged_bf16": 3e-2,
                     "ring_fp32": 1e-5, "ring_bf16": 3e-2,
                     "dh256_bf16_vs_fp32_plain": WIDE_TIGHT},
         dh256_bf16=WIDE_READINGS,
         timing_dtype="bf16 param, bf16 grad", per_shape=rows,
         per_step_of_170_tensors={k: totals[k] for k in
                                  ("adalomo_stats", "adalomo_update")},
         sharded_cases=sharded_checks,
         sharded_per_shape_2way_bf16=shard_rows,
         sharded_per_step_of_170_shards_2way=shard_totals,
         block_cases=block_checks, block_per_shape_2x2_bf16=block_rows,
         block_per_step_of_170_blocks_2x2=totals["adalomo_stats_2d"],
         moe_cases=moe_checks, moe_per_call=moe_rows,
         pali_cases=pali_checks, ssm_cases=ssm_checks,
         whisper_cases=whisper_checks,
         pali_tolerances={"r_c": TOL_RC, "k2_lr": K2_HELD_LR,
                          "k2_update_rtol": K2_HELD_UPDATE_RTOL,
                          "k2_moved_min": K2_HELD_MOVED_MIN},
         new_heads=NEW_HEADS,
         paged_cases=k3_cases, paged_rerun_bitwise=k3_bitwise,
         paged_per_shape_bf16=k3_rows,
         paged_per_decode_step_B8_n1024=totals["paged_decode_attention"],
         ring_cases=k4_cases, ring_rerun_bitwise=k4_bitwise,
         ring_per_shape_bf16=k4_rows,
         ring_per_decode_step_B4_W4096=totals["decode_attention"],
         partial_cases=partial_checks,
         partial_per_launch_serve_1x2_block=partial_rows)
    return {"errs": errs, "totals": totals,
            "rows": {"paged_decode_attention": k3_rows,
                     "decode_attention": k4_rows,
                     "decode_attention_partial": partial_rows}}


# --------------------------------------------------------------------------
# K3: paged decode attention
# --------------------------------------------------------------------------

# (B, H, K, dh, page_size, P, window, seq_lens): the CPU tests' cases, a
# danube-shaped ragged case with and without a window; danube serving shapes
# (8 sequences, 32/8 heads, dh 80, pages of 16, up to 2048 tokens) are added
# in check_k3.  seq_lens include the token being decoded.
K3_CASES = [
    (3, 8, 2, 64, 8, 4, None, (19, 9, 25)),
    (2, 4, 4, 32, 16, 2, None, (1, 32)),
    (4, 8, 8, 64, 4, 8, 6, (30, 3, 17, 8)),
    (1, 16, 4, 128, 8, 3, None, (24,)),
    (5, 32, 8, 80, 16, 19, None, (1, 15, 16, 17, 300)),
    (5, 32, 8, 80, 16, 19, 6, (1, 15, 16, 17, 300)),
    # runs with no live slot: a short sequence in a wide table, a window that
    # leaves only the last page, a sequence with none
    (3, 8, 2, 64, 8, 16, 5, (3, 100, 128)),
    (2, 32, 8, 80, 16, 64, 16, (2, 1024)),
    (8, 32, 8, 80, 16, 128, 16, (0, 2, 17, 33, 700, 1024, 2047, 2048)),
]
# The reference's paged-attention tolerances (rtol = atol): fp32 1e-5; bf16
# 3e-2, where the plain version rounds the probabilities to bf16 before the
# weighted sum and the kernel keeps them in fp32.
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# dh 256's bf16 cases (the wide loop and its combine) are held a second time,
# against the plain version computed in fp32 from the same bf16 inputs: each
# element within atol plus bf16's own rounding of the output (2**-8 of it),
# and the error's RMS within `rms` of the output's (the partial entry's lse,
# fp32 and never rounded: within atol alone).  A run or a 16-slot step
# left out moves the RMS by about 6-20 % at paligemma-3b's rings, the
# kernel's own roundings (the probabilities and the output to bf16) by about
# 0.2 % (reckoned: the square root of the share of slots left out, and
# bf16's 2**-9).
WIDE_TIGHT = {"atol": 4e-3, "rtol": 2 ** -8, "rms": 1e-2}
# entry -> the largest errors of its dh-256 bf16 cases: against the bf16
# plain version (the 3e-2 check) and against the fp32 one (WIDE_TIGHT)
WIDE_READINGS = {}


def wide_close(entry, got, want, want_fp32, what, lse=False) -> None:
    """A dh-256 bf16 case of ``entry`` (K3, K4 or the partial entry's o or,
    with ``lse``, its log-sum-exp), already held against its bf16 plain
    version ``want`` at ``K3_TOL``: held against ``want_fp32`` at
    ``WIDE_TIGHT``; both readings go to ``WIDE_READINGS``."""
    got, want_fp32 = got.float(), want_fp32.float()
    err = (got - want_fp32).abs()
    rms = float(err.pow(2).mean().sqrt() /
                want_fp32.pow(2).mean().sqrt().clamp_min(1e-30))
    row = WIDE_READINGS.setdefault(entry, {
        "cases": 0, "vs_bf16_plain_max_abs_err": 0.0,
        "vs_fp32_plain_max_abs_err": 0.0, "vs_fp32_plain_rms_ratio": 0.0})
    row["cases"] += 1
    row["vs_bf16_plain_max_abs_err"] = max(
        row["vs_bf16_plain_max_abs_err"], max_err(got, want.float()))
    row["vs_fp32_plain_max_abs_err"] = max(
        row["vs_fp32_plain_max_abs_err"], float(err.max()))
    row["vs_fp32_plain_rms_ratio"] = max(row["vs_fp32_plain_rms_ratio"], rms)
    bound = WIDE_TIGHT["atol"] + (0.0 if lse else WIDE_TIGHT["rtol"] *
                                  want_fp32.abs())
    if not bool((err <= bound).all()) or (not lse and
                                          rms > WIDE_TIGHT["rms"]):
        raise AssertionError(
            f"{what}: against the plain version in fp32, largest error "
            f"{float(err.max()):.3e} (beyond atol + rtol * |want| at "
            f"{int((err > bound).sum())} elements), error RMS {rms:.3e} of "
            f"the output's; {WIDE_TIGHT} wanted")


SERVE_WINDOW = 4096                 # h2o-danube-1.8b's sliding window
# The other configs' heads (query, KV, head dim, window): the head dims 120
# and 160 (not whole 16-wide k-steps; more than the dense path had seen), a
# query group of 1 (deepseek-moe-16b is MHA), paligemma-3b's 8 query heads
# over 1 at dh 256, and the smoke configs' dh 16 (4 over 1) and dh 24
# (h2o-danube-3-4b's smoke config: 4 over 2, window 8)
NEW_HEADS = {"danube3 dh120": (32, 8, 120, 4096),
             "stablelm dh160": (32, 8, 160, None),
             "moe G1 dh128": (16, 16, 128, None),
             "qwen3 G8 dh128": (64, 8, 128, None),
             "paligemma G8 dh256": (8, 1, 256, None),
             "smoke dh16": (4, 1, 16, None),
             "smoke dh24": (4, 2, 24, 8),
             "zamba2 G1 dh64": (32, 32, 64, None),
             "whisper G1 dh64": (8, 8, 64, None)}
# The legacy decode rings of the serving phases, as (B, W, heads):
# paligemma-3b's K4 over the prefix phase's prompts (4 x (1024 text + 256
# prefix), every slot valid once the ring wraps) and over 8 x (4096 + 256)
# slots; zamba2-1.2b's shared attention over the ssm phase's prompts (4 x
# 1024 tokens); whisper-base's self-attention ring of 448 slots and its
# cross-attention over 1500 frames (the encdec phase's 16 rows; W = 1500 is
# not a multiple of 16)
PALI_HEADS = NEW_HEADS["paligemma G8 dh256"]
ZAMBA_HEADS = NEW_HEADS["zamba2 G1 dh64"]
WHISPER_HEADS = NEW_HEADS["whisper G1 dh64"]
DECODE_RINGS = {"paligemma B4 W1280": (4, 1280, PALI_HEADS),
                "paligemma B8 W4352": (8, 4352, PALI_HEADS),
                "zamba2 B4 W1024": (4, 1024, ZAMBA_HEADS),
                "whisper self B16 W448": (16, 448, WHISPER_HEADS),
                "whisper cross B16 W1500": (16, 1500, WHISPER_HEADS)}
# whisper-base's decode attention as the encdec phase calls K4, (B, W, H,
# K, dh, window, cur, wrapped): the cross-attention (slot t holds frame t,
# the query at 2**30 sees all 1500), and the self-attention ring partly
# filled (cur 40) and wrapped (cur 448 + 31)
WHISPER_K4_CASES = [(16, 1500) + WHISPER_HEADS + (2 ** 30, False),
                    (16, 448) + WHISPER_HEADS + (40, False),
                    (16, 448) + WHISPER_HEADS + (448 + 31, True)]


def k3_inputs(B, H, Kh, dh, ps, P, seq_lens, dtype, seed):
    """q, k/v pages, block tables and lengths.  Each sequence's pages are a
    shuffled draw from the pool and its table's tail points at the scratch
    page 0, which holds large garbage; every slot no live token uses holds
    random values.  Nothing a kernel must mask is zero."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    N = 1 + B * P
    q = torch.randn((B, H, dh), generator=g, device=DEV).to(dtype)
    kp = torch.randn((N, ps, Kh, dh), generator=g, device=DEV)
    vp = torch.randn((N, ps, Kh, dh), generator=g, device=DEV)
    kp[0] = 1e4
    vp[0] = -1e4
    bt = (torch.randperm(N - 1, generator=g, device=DEV) + 1).to(
        torch.int32).view(B, P)
    for b, n in enumerate(seq_lens):
        bt[b, -(-n // ps):] = 0
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=DEV)
    return q, kp.to(dtype), vp.to(dtype), bt, sl


def check_k3(errs: dict) -> tuple:
    """K3 against its plain version at every case, fp32 and bf16, and a
    bitwise re-run at the danube serving shape."""
    rng = np.random.default_rng(3)
    serve_lens = tuple(int(x) for x in rng.integers(1, 2049, 6)) + (1, 2048)
    cases = K3_CASES + [(8, 32, 8, 80, 16, 128, w, serve_lens)
                        for w in (None, SERVE_WINDOW, 100)]
    for H, Kh, dh, window in NEW_HEADS.values():
        cases += [(8, H, Kh, dh, 16, 128, w, serve_lens)
                  for w in sorted({window, 100}, key=str)]
        cases.append((3, H, Kh, dh, 16, 16, 5, (3, 100, 256)))
    n = 0
    for i, (B, H, Kh, dh, ps, P, window, lens) in enumerate(cases):
        progress(f"  K3 case {i}: B{B} {H}/{Kh} dh {dh} window {window}")
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, sl = k3_inputs(B, H, Kh, dh, ps, P, lens, dtype,
                                          100 + i)
            want = paged_decode_attention_ref(q, kp, vp, bt, sl,
                                              window=window)
            got = KD.paged_decode_attention(q, kp, vp, bt, sl, window=window)
            # a sequence with no token: the kernel gives 0, the plain
            # version mean(V); the others are compared
            live = torch.tensor(lens, device=DEV) > 0
            if bool((got[~live] != 0).any()):
                raise AssertionError(f"paged_decode_attention case {i}: a "
                                     "sequence with no token is not 0")
            got, want = got[live], want[live]
            tol = K3_TOL[dtype]
            assert_close(got, want, rtol=tol, atol=tol,
                         what=f"paged_decode_attention case {i} {dtype}")
            if dh == 256 and dtype == torch.bfloat16:
                want_fp32 = paged_decode_attention_ref(
                    q.float(), kp.float(), vp.float(), bt, sl,
                    window=window)[live]
                wide_close("paged_decode_attention", got, want, want_fp32,
                           f"paged_decode_attention case {i} {dtype}")
            errs["paged_decode_attention"] = max(
                errs["paged_decode_attention"], max_err(got, want))
            n += 1
    for H, Kh, dh, window in [(32, 8, 80, SERVE_WINDOW)] + list(
            NEW_HEADS.values()):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, sl = k3_inputs(8, H, Kh, dh, 16, 128, serve_lens,
                                          dtype, 7)
            a = KD.paged_decode_attention(q, kp, vp, bt, sl, window=window)
            b = KD.paged_decode_attention(q, kp, vp, bt, sl, window=window)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(
                    f"paged_decode_attention {H}/{Kh} dh {dh} {dtype}: the "
                    "same inputs did not give bit-identical outputs on a "
                    "re-run")
    # Ten launches back to back on the same ticket counters: each must find
    # them at 0, as the last run of the launch before left them; danube's
    # heads and paligemma-3b's (8/1, dh 256: the wide loop) at 8 x 1024
    for B, n_tok, P, (H, Kh, dh, window), seed in (
            (1, 2048, 128, (32, 8, 80, SERVE_WINDOW), 21),
            (8, 2048, 128, (32, 8, 80, SERVE_WINDOW), 28),
            (8, 1024, 64, PALI_HEADS, 30)):
        args = k3_inputs(B, H, Kh, dh, 16, P, (n_tok,) * B, torch.bfloat16,
                         seed)
        outs = [KD.paged_decode_attention(*args, window=window)
                for _ in range(10)]
        torch.cuda.synchronize()
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"paged_decode_attention B{B} n{n_tok} "
                                 f"dh {dh}: ten launches on reused counters "
                                 "were not bit-identical")
    return n, True


def k3_bound_ms(B, H, Kh, dh, ps, seq_lens, window, elt) -> float:
    """Least time for the function: live K/V rows read once, q read and
    out written once, the used block-table entries and lengths; or its
    operations on the fp32 units, whichever is larger."""
    live = [min(n, window) if window else n for n in seq_lens]
    nbytes = (sum(live) * Kh * dh * 2 * elt + 2 * B * H * dh * elt
              + 4 * sum(-(-n // ps) for n in seq_lens) + 4 * B)
    # per cached token and query head: q.k and p.v (2 dh each as
    # multiply-adds) and the online softmax's handful
    ops = sum(live) * H * (4 * dh + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3


def k3_library(q, kp, vp, bt, mask):
    """The two-call library path for K3's function, never used by the port:
    gather the pages into a dense [B, P * ps, K, dh] cache (one indexing
    call each for K and V), then scaled_dot_product_attention with
    enable_gqa and a boolean mask [B, 1, 1, P * ps] made beforehand."""
    B, P = bt.shape
    _, ps, Kh, dh = kp.shape
    idx = bt.long()
    kc = kp[idx].view(B, P * ps, Kh, dh).transpose(1, 2)
    vc = vp[idx].view(B, P * ps, Kh, dh).transpose(1, 2)
    return F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                          attn_mask=mask, enable_gqa=True)


def time_k3() -> tuple:
    """bf16 at danube serving shapes (32/8 heads, dh 80, pages of 16, the
    model's window), then at the other configs' heads (``NEW_HEADS``) where
    the tree under test takes their head dim: kernel, plain version, the
    two-call library path (``k3_library``) and bound per launch, in ms.  K3 takes tens of
    microseconds, about what its wrapper costs on the host, so all three
    are timed as replays of a CUDA graph; eager_ms is the kernel launched
    one call after another from the host."""
    rng = np.random.default_rng(5)
    danube = (32, 8, 80, SERVE_WINDOW)
    shapes = {"B8 n1024": ((1024,) * 8, danube),
              "B8 n2048": ((2048,) * 8, danube),
              "B8 ragged<=2048": (tuple(int(x) for x in
                                        rng.integers(1, 2049, 8)), danube),
              "B1 n2048": ((2048,), danube)}
    # the other configs' heads at 8 x 1024 (window 4096 > 1024 for danube3)
    shapes.update({f"{name} B8 n1024": ((1024,) * 8, heads)
                   for name, heads in NEW_HEADS.items()
                   if heads[2] in KD.HEAD_DIMS})
    ps = 16
    rows = {}
    for name, (lens, (H, Kh, dh, window)) in shapes.items():
        B, P = len(lens), -(-max(lens) // ps)
        set_bytes = (1 + B * P) * ps * Kh * dh * 2 * 2
        copies = min(16, max(2, math.ceil(200e6 / set_bytes)))
        sets = [k3_inputs(B, H, Kh, dh, ps, P, lens, torch.bfloat16, 50 + c)
                for c in range(copies)]
        rounds = max(2, 64 // copies)

        def kernel(q, kp, vp, bt, sl):
            return KD.paged_decode_attention(q, kp, vp, bt, sl,
                                             window=window)

        eager = time_ms(kernel, sets, rounds)
        ms = time_graph_ms(kernel, sets, rounds)
        plain = time_graph_ms(
            lambda q, kp, vp, bt, sl: paged_decode_attention_ref(
                q, kp, vp, bt, sl, window=window), sets, rounds)
        pos = torch.arange(P * ps, device=DEV)
        lens_t = torch.tensor(lens, device=DEV)
        mask = pos[None] < lens_t[:, None]
        if window:
            mask &= lens_t[:, None] - 1 - pos[None] < window
        lib_sets = [(q, kp, vp, bt, mask[:, None, None])
                    for q, kp, vp, bt, _ in sets]
        library = time_graph_ms(k3_library, lib_sets, rounds)
        rows[name] = {"heads": [H, Kh, dh], "window": window,
                      "seq_lens": list(lens),
                      "S": paged_split_of(B, P, Kh, dh),
                      "ms": ms, "eager_ms": eager, "plain_ms": plain,
                      "library_ms": library,
                      "library_calls": "2 (page gather, then SDPA)",
                      "bound_ms": k3_bound_ms(B, H, Kh, dh, ps, lens,
                                              window, 2)}
        del sets, lib_sets
        torch.cuda.empty_cache()
    step = rows["B8 n1024"]
    total = {k: step[k] * N_LAYERS
             for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                       "library_ms")}
    return rows, total


def paged_split_of(B, P, Kh, dh):
    """K3's runs a sequence at ``Kh`` KV heads, head dim ``dh`` and pages of
    16, as the tree under test splits them (a tree whose split reads no head
    dim: without it)."""
    try:
        return KD.paged_split(B, Kh, P, 16, dh)
    except TypeError:
        return KD.paged_split(B, Kh, P, 16)


def ring_split_of(B, W, Kh, dh):
    """K4's ``(S, span)`` as the tree under test splits a ring (as
    ``paged_split_of``)."""
    try:
        return tuple(KD.ring_split(B, Kh, W, dh))
    except TypeError:
        return tuple(KD.ring_split(B, Kh, W))


# --------------------------------------------------------------------------
# K4: decode attention over a ring cache
# --------------------------------------------------------------------------

# (B, W, H, K, dh, window, cur): the reference kernel tests' CASES; a dozen
# ragged rings and danube's serving shapes are added in check_k4.
K4_CASES = [
    (2, 128, 8, 2, 64, None, 100),
    (1, 300, 4, 4, 128, None, 250),
    (3, 512, 16, 4, 64, 64, 400),
    (2, 64, 8, 8, 32, None, 10),
    (1, 1024, 32, 8, 128, 256, 900),
]


def k4_inputs(B, W, H, Kh, dh, cur, dtype, seed, wrapped=False):
    """q, k/v caches [B, W, K, dh], kv_pos [W] and q_pos.  A partly filled
    ring holds positions 0..cur in slots 0..cur and -1 after them, whose
    slots hold large garbage; a wrapped ring holds the last W positions up
    to cur, rotated: slot (p - 1) % W holds position p."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    q = torch.randn((B, H, dh), generator=g, device=DEV).to(dtype)
    kc = torch.randn((B, W, Kh, dh), generator=g, device=DEV)
    vc = torch.randn((B, W, Kh, dh), generator=g, device=DEV)
    slots = torch.arange(W, device=DEV)
    if wrapped:
        pos = cur - W + 1 + torch.remainder(slots - cur, W)
    else:
        pos = torch.where(slots <= cur, slots, -1)
        kc[:, pos < 0] = 1e4
        vc[:, pos < 0] = -1e4
    q_pos = torch.full((), cur, dtype=torch.int32, device=DEV)
    return q, kc.to(dtype), vc.to(dtype), pos.to(torch.int32), q_pos


def k4_cases() -> list:
    """(B, W, H, K, dh, window, cur, wrapped) for every K4 check."""
    rng = np.random.default_rng(4)
    cases = [c + (False,) for c in K4_CASES]
    for _ in range(12):
        W = int(rng.integers(16, 401))
        Kh, G = (int(x) for x in rng.choice([1, 2, 4], 2))
        dh = int(rng.choice(KD.HEAD_DIMS))
        cases.append((2, W, Kh * G, Kh, dh, None, max(W // 2, 1), False))
    for B, W in ((8, 1024), (4, 4096)):
        for window in (None, SERVE_WINDOW, 256):
            cases.append((B, W, 32, 8, 80, window, W - 200, False))
            cases.append((B, W, 32, 8, 80, window, W + 2047, True))
    # the other configs' heads: a partly filled ring of 1024 and a wrapped
    # one of 4096, with and without a window
    for H, Kh, dh, _ in NEW_HEADS.values():
        for window in (None, 256):
            cases.append((8, 1024, H, Kh, dh, window, 1024 - 200, False))
            cases.append((4, 4096, H, Kh, dh, window, 4096 + 2047, True))
    # the serving phases' rings, as their first and their last decode step
    # see them (slot 0 overwritten by position W, then 30 or 31 more)
    for B, W, (H, Kh, dh, _) in DECODE_RINGS.values():
        cases.append((B, W, H, Kh, dh, None, W, True))
        cases.append((B, W, H, Kh, dh, None, W + 31, True))
    return cases + WHISPER_K4_CASES


def check_k4(errs: dict) -> tuple:
    """K4 against its plain version at every case, fp32 and bf16, and a
    bitwise re-run at danube's deep ring."""
    n = 0
    for i, (B, W, H, Kh, dh, window, cur, wrapped) in enumerate(k4_cases()):
        progress(f"  K4 case {i}: B{B} W{W} {H}/{Kh} dh {dh} window "
                 f"{window}")
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc, pos, q_pos = k4_inputs(B, W, H, Kh, dh, cur, dtype,
                                              200 + i, wrapped)
            want = ring_decode_attention_ref(q, kc, vc, pos, q_pos,
                                             window=window)
            got = KD.decode_attention(q, kc, vc, pos, q_pos, window=window)
            tol = K3_TOL[dtype]
            assert_close(got, want, rtol=tol, atol=tol,
                         what=f"decode_attention case {i} {dtype}")
            if dh == 256 and dtype == torch.bfloat16:
                want_fp32 = ring_decode_attention_ref(
                    q.float(), kc.float(), vc.float(), pos, q_pos,
                    window=window)
                wide_close("decode_attention", got, want, want_fp32,
                           f"decode_attention case {i} {dtype}")
            errs["decode_attention"] = max(errs["decode_attention"],
                                           max_err(got, want))
            n += 1
    reruns = [(4, 4096, 32, 8, 80, SERVE_WINDOW)] + [
        (4, 4096) + heads for heads in NEW_HEADS.values()] + [
        (B, W) + heads for B, W, heads in DECODE_RINGS.values()]
    for B, W, H, Kh, dh, window in reruns:
        for dtype in (torch.float32, torch.bfloat16):
            args = k4_inputs(B, W, H, Kh, dh, W + 2047, dtype, 8, True)
            a = KD.decode_attention(*args, window=window)
            b = KD.decode_attention(*args, window=window)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(
                    f"decode_attention B{B} W{W} {H}/{Kh} dh {dh} {dtype}: "
                    "the same inputs did not give bit-identical outputs on "
                    "a re-run")
    for B, W, H, Kh, dh, window, cur, wrapped in WHISPER_K4_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = k4_inputs(B, W, H, Kh, dh, cur, dtype, 8, wrapped)
            a = KD.decode_attention(*args, window=window)
            b = KD.decode_attention(*args, window=window)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(
                    f"decode_attention whisper B{B} W{W} cur {cur} {dtype}: "
                    "the same inputs did not give bit-identical outputs on "
                    "a re-run")
    # Ten launches back to back on the same ticket counters: each must find
    # them at 0, as the last run of the launch before left them; danube's
    # heads and paligemma-3b's (8/1, dh 256: the wide loop) at 4 x 4096
    for B, (H, Kh, dh, window), seed in (
            (1, (32, 8, 80, SERVE_WINDOW), 10),
            (4, (32, 8, 80, SERVE_WINDOW), 13),
            (4, PALI_HEADS, 14)):
        args = k4_inputs(B, 4096, H, Kh, dh, 6143, torch.bfloat16, seed,
                         True)
        outs = [KD.decode_attention(*args, window=window)
                for _ in range(10)]
        torch.cuda.synchronize()
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"decode_attention B{B} W4096 dh {dh}: ten "
                                 "launches on reused counters were not "
                                 "bit-identical")
    return n, True


def k4_bound_ms(B, H, Kh, dh, W, n_valid, elt) -> float:
    """Least time for the function: the valid K/V rows read once, q read,
    out written, kv_pos and q_pos read; or its operations on the fp32
    units, whichever is larger."""
    nbytes = (B * n_valid * Kh * dh * 2 * elt + 2 * B * H * dh * elt
              + 4 * W + 4)
    ops = B * n_valid * H * (4 * dh + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3


def time_k4() -> tuple:
    """bf16, danube's heads (32 query / 8 KV, dh 80) and window, then the
    other configs' heads (``NEW_HEADS``) where the tree under test takes
    their head dim, over a wrapped ring whose every slot is valid (the
    legacy engine's steady state): kernel, plain version, bound and the
    library call per launch, in ms.
    The library call is scaled_dot_product_attention of q [B, H, 1, dh]
    against the cache's [B, K, W, dh] views with enable_gqa and a boolean
    mask made before the timed region.  K4 takes tens of microseconds, about
    what its wrapper costs on the host, so all three are timed as replays of
    a CUDA graph; eager_ms is the kernel's time launched one call after
    another from the host.  The serving phases' rings (``DECODE_RINGS``:
    paligemma-3b's, zamba2-1.2b's) are timed too."""
    danube = (32, 8, 80, SERVE_WINDOW)
    shapes = {"B8 W1024": (8, 1024, danube), "B4 W4096": (4, 4096, danube),
              "B1 W4096": (1, 4096, danube)}
    shapes.update({f"{name} B4 W4096": (4, 4096, heads)
                   for name, heads in NEW_HEADS.items()
                   if heads[2] in KD.HEAD_DIMS})
    shapes.update({name: ring for name, ring in DECODE_RINGS.items()
                   if ring[2][2] in KD.HEAD_DIMS})
    rows = {}
    for name, (B, W, (H, Kh, dh, window)) in shapes.items():
        cur = W + 2047
        set_bytes = 2 * B * W * Kh * dh * 2
        copies = min(16, max(2, math.ceil(200e6 / set_bytes)))
        sets = [k4_inputs(B, W, H, Kh, dh, cur, torch.bfloat16, 60 + c, True)
                for c in range(copies)]
        rounds = max(2, 64 // copies)

        def kernel(q, kc, vc, pos, qp):
            return KD.decode_attention(q, kc, vc, pos, qp, window=window)

        eager = time_ms(kernel, sets, rounds)
        ms = time_graph_ms(kernel, sets, rounds)
        plain = time_graph_ms(
            lambda q, kc, vc, pos, qp: ring_decode_attention_ref(
                q, kc, vc, pos, qp, window=window), sets, rounds)
        valid = (sets[0][3] >= 0) & (sets[0][3] <= cur)
        if window:
            valid &= cur - sets[0][3] < window
        lib_sets = [(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                     valid.view(1, 1, 1, W)) for q, kc, vc, _, _ in sets]
        library = time_graph_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True), lib_sets, rounds)
        n_valid = int(valid.sum())
        rows[name] = {"heads": [H, Kh, dh], "window": window, "B": B, "W": W,
                      "split": list(ring_split_of(B, W, Kh, dh)),
                      "valid_slots": n_valid, "ms": ms,
                      "eager_ms": eager, "plain_ms": plain,
                      "library_ms": library,
                      "bound_ms": k4_bound_ms(B, H, Kh, dh, W, n_valid, 2)}
        del sets, lib_sets
        torch.cuda.empty_cache()
    step = rows["B4 W4096"]
    total = {k: step[k] * N_LAYERS
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return rows, total


# K4's partial entry (one rank's block of a ring split over ranks): held
# against its plain version at every K4 case; the halves of each case's ring
# merged (serve/sharded.py::combine_partials) and held against one
# whole-ring K4 launch at the reference kernel tests' tolerances (fp32 2e-5,
# bf16 3e-2); timed at serve_1x2's block, danube's heads over 4 x 2048 of
# the ring's 4096 slots, every slot valid
PARTIAL_MERGE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
PARTIAL_BLOCK = (4, 2048)


def partial_close(got, want, tol, what) -> float:
    """K4's partial ``(o, lse)`` against the plain version's: ``lse``'s
    -inf where the plain one's is (a head with no valid slot, whose o must
    be 0), both within ``tol`` elsewhere.  Returns the largest error."""
    (o, lse), (o_w, lse_w) = got, want
    empty = torch.isneginf(lse_w)
    if not torch.equal(torch.isneginf(lse), empty) or bool(
            empty.any() and o[empty].abs().max() != 0):
        raise AssertionError(f"{what}: the heads with no valid slot differ")
    assert_close(o, o_w, rtol=tol, atol=tol, what=f"{what} o")
    fin = ~empty
    assert_close(lse[fin], lse_w[fin], rtol=tol, atol=tol,
                 what=f"{what} lse")
    return max(max_err(o, o_w), max_err(lse[fin], lse_w[fin])
               if fin.any() else 0.0)


def check_k4_partial(errs: dict) -> dict:
    """K4's partial entry at every K4 case, fp32 and bf16: each half of the
    case's ring (the second half of a partly filled ring has no valid
    slot) against the plain version; the halves merged against one
    whole-ring K4 launch; bitwise re-runs at K4's re-run shapes."""
    from repro_torch.kernels.decode_attention.ref import (
        ring_decode_attention_partial_ref)
    from repro_torch.serve.sharded import combine_partials
    n, empty, merge_err = 0, 0, 0.0
    for i, (B, W, H, Kh, dh, window, cur, wrapped) in enumerate(k4_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc, pos, q_pos = k4_inputs(B, W, H, Kh, dh, cur, dtype,
                                              200 + i, wrapped)
            halves = []
            for lo, hi in ((0, W // 2), (W // 2, W)):
                # copies of their own: the kernel takes 16-byte aligned
                # operands, which a slice at slot W // 2 need not be
                args = (q, kc[:, lo:hi].clone(), vc[:, lo:hi].clone(),
                        pos[lo:hi].clone(), q_pos)
                got = KD.decode_attention_partial(*args, window=window)
                want = ring_decode_attention_partial_ref(*args,
                                                         window=window)
                errs["decode_attention_partial"] = max(
                    errs["decode_attention_partial"],
                    partial_close(got, want, K3_TOL[dtype],
                                  f"decode_attention_partial case {i} "
                                  f"[{lo}, {hi}) {dtype}"))
                fin = ~torch.isneginf(want[1])
                if dh == 256 and dtype == torch.bfloat16 and fin.any():
                    # the plain version is fp32 already
                    for part, a, b in (("o", got[0], want[0]),
                                       ("lse", got[1], want[1])):
                        wide_close(f"decode_attention_partial {part}",
                                   a[fin], b[fin], b[fin],
                                   f"decode_attention_partial case {i} "
                                   f"[{lo}, {hi}) {dtype} {part}",
                                   lse=part == "lse")
                empty += int(torch.isneginf(got[1]).all())
                halves.append(got)
                n += 1
            merged = combine_partials(
                torch.stack([o for o, _ in halves]),
                torch.stack([lse for _, lse in halves])).to(dtype)
            whole = KD.decode_attention(q, kc, vc, pos, q_pos,
                                        window=window)
            tol = PARTIAL_MERGE_TOL[dtype]
            assert_close(merged, whole, rtol=tol, atol=tol,
                         what=f"decode_attention_partial case {i} {dtype}: "
                              "two halves merged against the whole ring")
            merge_err = max(merge_err, max_err(merged, whole))
    reruns = [(4, 4096, 32, 8, 80, SERVE_WINDOW)] + [
        (4, 4096) + heads for heads in NEW_HEADS.values()]
    for B, W, H, Kh, dh, window in reruns:
        for dtype in (torch.float32, torch.bfloat16):
            args = k4_inputs(B, W, H, Kh, dh, W + 2047, dtype, 8, True)
            a = KD.decode_attention_partial(*args, window=window)
            b = KD.decode_attention_partial(*args, window=window)
            torch.cuda.synchronize()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(
                    f"decode_attention_partial B{B} W{W} {H}/{Kh} dh {dh} "
                    f"{dtype}: a re-run gave other bits")
    if not empty:
        raise AssertionError("decode_attention_partial: no case had a "
                             "block without a valid slot")
    return {"cases": n, "blocks_without_a_valid_slot": empty,
            "merge_max_abs_err": merge_err, "rerun_bitwise": True,
            "merge_tolerance": {str(k)[6:]: v
                                for k, v in PARTIAL_MERGE_TOL.items()}}


def k4_partial_bound_ms(B, H, Kh, dh, W, n_valid, elt) -> float:
    """K4's bound with the partial entry's result: o and lse in fp32."""
    nbytes = (B * n_valid * Kh * dh * 2 * elt + B * H * dh * elt
              + 4 * B * H * (dh + 1) + 4 * W + 4)
    ops = B * n_valid * H * (4 * dh + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3


# the PartialLibraryWarmup that phase_dist starts beside its worlds, if any
LIBRARY_WARMUP = []


def k4_partial_library():
    """The one PyTorch call that computes K4's partial entry on the same
    inputs: flex_attention with enable_gqa, returning the log-sum-exp
    beside o, compiled (its Triton kernel is the library's; the compile is
    made by the first call, outside any timed region).  ``fn(q [B,H,1,dh],
    k, v [B,K,W,dh]) -> (o [B,H,1,dh], lse [B,H,1])``; no block mask, so
    every slot is attended to."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention import flex_attention as FA
    inductor_config.compile_threads = 1   # no pool of compile workers
    compiled = torch.compile(FA.flex_attention, dynamic=False)
    if hasattr(FA, "AuxRequest"):
        def fn(q, k, v):
            o, aux = compiled(q, k, v, enable_gqa=True,
                              return_aux=FA.AuxRequest(lse=True))
            return o, aux.lse
        return fn
    return lambda q, k, v: compiled(q, k, v, enable_gqa=True,
                                    return_lse=True)


def k4_partial_sets(dtype) -> tuple:
    """The timing inputs at serve_1x2's block (danube's 32/8 heads, dh 80,
    window 4096, 4 rows over a block of 2048 slots, every slot valid):
    ``(sets, rounds, valid)``, the same from the same seeds at every call."""
    (B, W), (H, Kh, dh) = PARTIAL_BLOCK, (32, 8, 80)
    elt = torch.finfo(dtype).bits // 8
    cur = W + 2047
    copies = min(16, max(2, math.ceil(200e6 / (2 * B * W * Kh * dh * elt))))
    sets = [k4_inputs(B, W, H, Kh, dh, cur, dtype, 90 + c, True)
            for c in range(copies)]
    pos = sets[0][3]
    valid = (pos >= 0) & (pos <= cur) & (cur - pos < SERVE_WINDOW)
    return sets, max(2, 64 // copies), valid


def k4_partial_kernel(q, kc, vc, pos, qp):
    return KD.decode_attention_partial(q, kc, vc, pos, qp,
                                       window=SERVE_WINDOW)


def time_k4_partial() -> dict:
    """K4's partial entry at ``k4_partial_sets``' block, fp32 (the
    sub-phase's) and bf16: kernel, plain version and bound a launch (graph
    replays, as K4's), and scaled_dot_product_attention's time for ``o``
    alone on the same inputs.  The library call is timed at the end of the
    run (``time_k4_partial_library``)."""
    from repro_torch.kernels.decode_attention.ref import (
        ring_decode_attention_partial_ref)
    (B, W), (H, Kh, dh) = PARTIAL_BLOCK, (32, 8, 80)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        sets, rounds, valid = k4_partial_sets(dtype)
        ms = time_graph_ms(k4_partial_kernel, sets, rounds)
        plain = time_graph_ms(
            lambda q, kc, vc, pos, qp: ring_decode_attention_partial_ref(
                q, kc, vc, pos, qp, window=SERVE_WINDOW), sets, rounds)
        lib_sets = [(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                     valid.view(1, 1, 1, W)) for q, kc, vc, _, _ in sets]
        sdpa = time_graph_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True), lib_sets, rounds)
        n_valid = int(valid.sum())
        rows[str(dtype)[6:]] = {
            "heads": [H, Kh, dh], "window": SERVE_WINDOW, "B": B, "W": W,
            "valid_slots": n_valid, "ms": ms, "plain_ms": plain,
            "library_ms": None, "sdpa_o_only_ms": sdpa,
            "eager_ms": time_ms(k4_partial_kernel, sets, rounds),
            "bound_ms": k4_partial_bound_ms(B, H, Kh, dh, W, n_valid,
                                            torch.finfo(dtype).bits // 8)}
        del sets, lib_sets
        torch.cuda.empty_cache()
    return rows


class PartialLibraryWarmup:
    """``k4_partial_library`` compiled in a thread of its own, each dtype's
    compile made by one call on an input of ``k4_partial_sets``' shapes, so
    that the compile overlaps ``phase_dist``'s waits on its worlds of ranks
    (the main thread polls them) and ``time_k4_partial_library`` only
    times.  ``result()``: the compiled call, or the thread's exception."""

    def __init__(self):
        import threading
        self.fn, self.error, self.seconds = None, None, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        t0 = time.time()
        try:
            torch.cuda.set_device(DEV)
            fn = k4_partial_library()
            (B, W), (H, Kh, dh) = PARTIAL_BLOCK, (32, 8, 80)
            for dtype in (torch.float32, torch.bfloat16):
                q, kc, vc, _, _ = k4_inputs(B, W, H, Kh, dh, W + 2047, dtype,
                                            90, True)
                fn(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2))
            torch.cuda.synchronize()
            self.fn = fn
        except Exception as e:   # raised again by result()
            self.error = e
        self.seconds = time.time() - t0

    def result(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.fn


def time_k4_partial_library(rows: dict, warm=None) -> None:
    """The library call of K4's partial entry (``k4_partial_library``) on
    ``k4_partial_sets``' inputs, fp32 and bf16, a launch (graph replays),
    into ``rows`` (``time_k4_partial``'s) beside the kernel's time, with its
    largest difference from the kernel's (o, lse); emitted as its own line.
    Timed last, after every other phase; compiled by ``warm`` (a
    ``PartialLibraryWarmup``) where one was started, else here."""
    t0 = time.time()
    compile_s, thread_error, library_fn = None, None, None
    if warm is not None:
        try:
            library_fn, compile_s = warm.result(), warm.seconds
        except Exception as e:   # compiled again here, the error reported
            thread_error = repr(e)
    if library_fn is None:
        library_fn = k4_partial_library()
    for dtype in (torch.float32, torch.bfloat16):
        sets, rounds, valid = k4_partial_sets(dtype)
        if int(valid.sum()) != valid.numel():
            raise AssertionError("time_k4_partial_library: a slot is not "
                                 "valid; the library call takes no mask")
        lib_sets = [(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2))
                    for q, kc, vc, _, _ in sets]
        row = rows[str(dtype)[6:]]
        row["library_ms"] = time_graph_ms(library_fn, lib_sets, rounds)
        row["library_call"] = ("flex_attention(enable_gqa, log-sum-exp), "
                               "compiled")
        o_lib, lse_lib = library_fn(*lib_sets[0])
        o_k, lse_k = k4_partial_kernel(*sets[0])
        row["library_vs_kernel_max_abs_diff"] = {
            "o": max_err(o_lib[:, :, 0].float(), o_k),
            "lse": max_err(lse_lib[:, :, 0].float(), lse_k)}
        del sets, lib_sets, o_lib, lse_lib, o_k, lse_k
        torch.cuda.empty_cache()
    emit("kernels_library", kernel="decode_attention_partial",
         seconds=time.time() - t0, compiled_beside_dist_seconds=compile_s,
         compile_thread_error=thread_error,
         rows={k: {key: r[key] for key in (
             "ms", "library_ms", "library_call",
             "library_vs_kernel_max_abs_diff", "sdpa_o_only_ms")}
             for k, r in rows.items()})


# --------------------------------------------------------------------------
# timing: the kernels' times alone, and digests of their outputs
# --------------------------------------------------------------------------

def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def output_digests() -> dict:
    """sha256 of each kernel's output on inputs made from seeds on the card,
    at danube's shapes.  Run against two trees (``--src``), equal digests
    show that a change left a kernel bit-identical.  K2 is fed r and c from
    the plain statistics, so that its digest does not depend on K1's."""
    out = {}
    beta_t = torch.full((), 0.999, device=DEV)
    for m, n in DANUBE_SHAPES:
        p, g, r, c = make_inputs((m, n), torch.bfloat16, torch.bfloat16, 1,
                                 5.0)
        r, c = K.adalomo_stats_ref(g, r, c, beta_t, eps_stat=CFG.eps_stat)
        r2, c2 = r.clone(), c.clone()
        K.adalomo_stats(g, r2, c2, beta_t, eps_stat=CFG.eps_stat)
        out[f"adalomo_stats {m}x{n}"] = digest(torch.cat([r2, c2]))
        K.adalomo_update(p, g, r, c, scal_for(r, 5e-4, 5.0, 0.999, 0.0, 1.0),
                         eps_div=CFG.eps_div, eps_rms=CFG.eps_rms,
                         literal=False)
        out[f"adalomo_update {m}x{n}"] = digest(p)
        # K1's sharded entry on the same g: mode 1 (rows), mode 2
        # (columns) and, where the tree has it, mode 3 (both)
        for axis, mode in ((-2, "mode1"), (-1, "mode2"),
                           (getattr(K, "BOTH", None), "mode3")):
            if axis is None:
                out[f"adalomo_stats_partial {mode} {m}x{n}"] = \
                    "mode not in this tree"
                continue
            r2, c2 = r.clone(), c.clone()
            raw = K.adalomo_stats_partial(g, r2, c2, beta_t,
                                          eps_stat=CFG.eps_stat, axis=axis)
            if axis == getattr(K, "BOTH", None):
                raw = torch.cat([raw[0], raw[1][..., :-1]])
            out[f"adalomo_stats_partial {mode} {m}x{n}"] = digest(
                torch.cat([r2, c2, raw.flatten()]))
    for B, W in ((8, 1024), (4, 4096), (1, 4096)):
        for wrapped, cur in ((True, W + 2047), (False, W - 200)):
            args = k4_inputs(B, W, 32, 8, 80, cur, torch.bfloat16, 70,
                             wrapped)
            out[f"decode_attention B{B} W{W} cur{cur}"] = digest(
                KD.decode_attention(*args, window=SERVE_WINDOW))
    for B, n in ((8, 1024), (8, 2048), (1, 2048)):
        args = k3_inputs(B, 32, 8, 80, 16, 128, (n,) * B, torch.bfloat16, 71)
        out[f"paged_decode_attention B{B} n{n}"] = digest(
            KD.paged_decode_attention(*args, window=SERVE_WINDOW))
    # the other configs' shapes, where the tree under test takes them
    for name, (shape, lead, dt) in MOE_KERNEL_CASES.items():
        p, g, r, c = make_inputs(shape, dt, dt, 1, 5.0, lead=lead)
        r, c = K.adalomo_stats_ref(g, r, c, beta_t, eps_stat=CFG.eps_stat)
        r2, c2 = r.clone(), c.clone()
        K.adalomo_stats(g, r2, c2, beta_t, eps_stat=CFG.eps_stat)
        out[f"adalomo_stats {name}"] = digest(torch.cat([r2.flatten(),
                                                         c2.flatten()]))
        K.adalomo_update(p, g, r, c, scal_for(r, 5e-4, 5.0, 0.999, 0.0, 1.0),
                         eps_div=CFG.eps_div, eps_rms=CFG.eps_rms,
                         literal=False)
        out[f"adalomo_update {name}"] = digest(p)
        del p, g, r, c, r2, c2
    for name, (H, Kh, dh, window) in NEW_HEADS.items():
        if dh not in KD.HEAD_DIMS:
            out[f"{name}"] = "head dim not taken by this tree"
            continue
        args = k3_inputs(8, H, Kh, dh, 16, 64, (1024,) * 8, torch.bfloat16,
                         72)
        out[f"paged_decode_attention {name} B8 n1024"] = digest(
            KD.paged_decode_attention(*args, window=window))
        args = k4_inputs(4, 4096, H, Kh, dh, 6143, torch.bfloat16, 73, True)
        out[f"decode_attention {name} B4 W4096"] = digest(
            KD.decode_attention(*args, window=window))
    torch.cuda.synchronize()
    return out


def phase_timing() -> None:
    """The kernels phase's timings without its checks, and the outputs'
    digests: the same script times a parent tree (``--src``) and this one
    in one call (parent, change, change, parent)."""
    t0 = time.time()
    build.load_libraries([(K.LIB_NAME, K.SOURCES), (KD.LIB_NAME, KD.SOURCES)])
    build_s = time.time() - t0
    rows, totals, moe_rows = time_kernels()
    k3_rows, totals["paged_decode_attention"] = time_k3()
    k4_rows, totals["decode_attention"] = time_k4()
    partial_rows = time_k4_partial()
    emit("timing", src=SRC, build_seconds=build_s, per_shape=rows,
         totals=totals, moe_per_call=moe_rows, paged_per_shape_bf16=k3_rows,
         ring_per_shape_bf16=k4_rows,
         partial_per_launch_serve_1x2_block=partial_rows,
         digests=output_digests())


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def phase_train(steps: int = 3) -> dict:
    dry_warmup()
    spec = RunSpec(model=ModelSpec(ARCH_ID, smoke=False),
                   data=DataConfig(vocab=0, seq_len=1024, global_batch=4,
                                   seed=0),
                   opt=OptSpec(name="adalomo"),          # backend auto -> cuda
                   steps=StepSpec(total=steps), log_every=1, seed=0)
    timing = TimingHook()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                StepMeter() as meter:
            warnings.simplefilter("always")
            K.adalomo_stats.launches = 0
            K.adalomo_update.launches = 0
            result = run(spec, hooks=[timing],
                         log_fn=lambda s: print("  " + s, flush=True))
            launches = {"adalomo_stats": K.adalomo_stats.launches,
                        "adalomo_update": K.adalomo_update.launches}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the same spec traced on the meta device
    dry = dry_reading(spec, meter)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    losses = result.history["loss"]
    params = tree_leaves(result.params)
    n_params = sum(p.numel() for p in params)
    finite = all_finite(result.params)
    emit("train", arch=ARCH_ID, n_layers=result.program.arch.cfg.n_layers,
         n_params=n_params, batch=4, seq=1024, steps=steps, losses=losses,
         step_seconds=timing.step_s, launches=launches,
         host_syncs=len(syncs),
         host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                 for w in syncs}),
         opt_step=int(result.opt_state.step),
         peak_memory_bytes=meter.run_peak(), dry=dry)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses not finite: {losses}")
    if not finite:
        raise AssertionError("train: a parameter is not finite after the run")
    want = TENSORS_PER_STEP * steps
    if launches != {"adalomo_stats": want, "adalomo_update": want}:
        raise AssertionError(f"train: kernel launches {launches}, expected "
                             f"{want} each ({TENSORS_PER_STEP} a step)")
    if len(syncs) != steps:
        raise AssertionError(
            f"train: {len(syncs)} synchronising host transfers in {steps} "
            "steps, expected one a step")
    failed = dry_failures("train", [dry], hold_peak=True)
    if dry["dry_step"]["launches"] != {"adalomo_stats": TENSORS_PER_STEP,
                                       "adalomo_update": TENSORS_PER_STEP}:
        failed.append(f"train: dry launches {dry['dry_step']['launches']}")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": launches, "step_seconds": timing.step_s,
            "peak_memory_bytes": meter.run_peak(),
            "losses": losses,
            # the dist phase's one-rank world is held against these
            "params_cpu": [t.to("cpu") for t in params]}


# --------------------------------------------------------------------------
# parity
# --------------------------------------------------------------------------

def phase_parity() -> None:
    arch = get_arch(ARCH_ID)
    arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=2))
    base = arch.init_params(0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(
        rng.integers(0, arch.cfg.vocab, (2, 512)).astype(np.int32)).to(DEV)
        for k in ("tokens", "labels")}

    def one_step(backend):
        params = tree_map(torch.clone, base)
        opt = opt_lib.get_opt("adalomo", backend=backend)
        state = opt.init(params)
        _, state, loss, _ = arch.make_fused_train_step(opt)(
            params, state, batch, hparams=5e-4)
        return params, float(loss)

    p_cuda, loss_cuda = one_step("cuda")
    p_again, _ = one_step("cuda")
    p_torch, loss_torch = one_step("torch")
    torch.cuda.synchronize()
    worst = 0.0
    for a, b, c in zip(tree_leaves(p_cuda), tree_leaves(p_torch),
                       tree_leaves(base)):
        assert_close(a, b, rtol=5e-3, atol=5e-3, what="parity params")
        worst = max(worst, max_err(a, b))
        if torch.equal(a, c) and a.ndim >= 2:
            raise AssertionError("parity: a matrix was not updated")
    emit("parity", n_layers=2, d_model=arch.cfg.d_model, batch=2, seq=512,
         loss_cuda=loss_cuda, loss_torch=loss_torch,
         max_abs_param_err=worst, tolerance={"params": 5e-3, "loss": 1e-3},
         step_rerun_bitwise=all(
             torch.equal(a, b) for a, b in zip(tree_leaves(p_cuda),
                                               tree_leaves(p_again))))
    if not math.isfinite(loss_cuda) or abs(loss_cuda - loss_torch) > 1e-3:
        raise AssertionError(
            f"parity: loss {loss_cuda} (cuda) vs {loss_torch} (torch)")


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------

RESUME_STEPS = 4
# bytes: a save stages its files beside the previous step's, so a directory
# holds two checkpoints of 3.67 GB at once
RESUME_MIN_FREE = 10 * 2 ** 30


def resume_root(prefix: str = "chip_smoke_resume_") -> str:
    """A fresh directory for a phase's checkpoints, under the system temp
    or this checkout's git-ignored ``_chip_smoke_tmp/``, whichever disk has
    more free space; the phase removes it before it returns."""
    here = os.path.dirname(os.path.abspath(__file__))
    best = max((tempfile.gettempdir(), here),
               key=lambda d: shutil.disk_usage(d).free)
    if shutil.disk_usage(best).free < RESUME_MIN_FREE:
        raise AssertionError(
            f"resume: {shutil.disk_usage(best).free} bytes free in {best}, "
            f"need {RESUME_MIN_FREE}")
    if best == here:
        best = os.path.join(here, "_chip_smoke_tmp")
        os.makedirs(best, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=best)


def resume_spec(root, ckpt, metrics, *, resume=False, profile=False):
    from repro_torch.run import (CheckpointSpec, EvalSpec, FaultSpec,
                                 ProfileSpec)
    return RunSpec(
        model=ModelSpec(ARCH_ID, smoke=False),
        data=DataConfig(vocab=0, seq_len=1024, global_batch=4, seed=0),
        opt=OptSpec(name="adalomo"),
        steps=StepSpec(total=RESUME_STEPS), log_every=1, seed=0,
        checkpoint=CheckpointSpec(dir=os.path.join(root, ckpt), every=2,
                                  resume=resume, keep_last=1),
        eval=EvalSpec(every=2, n_batches=1),
        metrics_path=os.path.join(root, metrics),
        fault=FaultSpec(heartbeat_timeout_s=600.0),
        profile=ProfileSpec(dir=os.path.join(root, "prof") if profile
                            else None, start=1, steps=1))


def bitwise_equal(a, b) -> bool:
    from repro_torch.core.tree import pytree_leaves
    la, lb = pytree_leaves(a), pytree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def run_record(result, root) -> dict:
    """What one run of the phase reports: its history, step seconds (from
    its metrics stream), liveness, and the checkpoint manager's save and
    restore timings."""
    from repro_torch.run import CheckpointHook, HeartbeatHook, StragglerHook
    from repro_torch.telemetry.schema import read_stream
    mgr = result.find_hook(CheckpointHook).manager
    mgr.wait()
    hb = result.find_hook(HeartbeatHook).heartbeat
    dt = {r["step"]: r["dt_s"] for r in
          read_stream(result.program.spec.metrics_path).steps()}
    return {"start_step": result.start_step,
            "steps": result.history["step"],
            "step_seconds": [dt[s] for s in result.history["step"]],
            "losses": result.history["loss"],
            "eval_steps": result.history["eval_step"],
            "eval_losses": result.history["eval_loss"],
            "stragglers": [list(e) for e in
                           result.find_hook(StragglerHook).monitor.events],
            "heartbeat_stalled": bool(hb.stalled),
            "checkpoint_io": list(mgr.timings),
            "disk_free_bytes": shutil.disk_usage(root).free}


def profiled_kernels(path: str) -> dict:
    """CUDA kernel events in a Chrome trace, counted for K1 and K2 (K2's
    wrapper launches two kernels: its partial sums, then the update)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(names),
            "adalomo_stats": sum("stats_kernel" in n for n in names),
            "adalomo_update": sum("update_kernel" in n for n in names)}


def phase_resume() -> dict:
    """h2o-danube-1.8b at full width through ``run(spec)`` with checkpoints,
    eval, the metrics stream, the heartbeat and a profiler window: A
    uninterrupted; B preempted by SIGTERM; C resumed from B; D with an
    injected transient device error — C and D bitwise equal to A."""
    import signal
    from repro_torch.fleet import Preempted
    from repro_torch.run import Hook, ProfilerHook, build_step_program
    from repro_torch.telemetry.schema import read_stream

    log = lambda s: print("  " + s, flush=True)            # noqa: E731
    t0 = time.perf_counter()
    root = resume_root()
    out = {"root": root, "disk_free_bytes": shutil.disk_usage(root).free}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        # A: uninterrupted, the slice's main path
        spec_a = resume_spec(root, "ck_a", "a.jsonl", profile=True)
        K.adalomo_stats.launches = 0
        K.adalomo_update.launches = 0
        res_a = run(spec_a, log_fn=log)
        launches = {"adalomo_stats": K.adalomo_stats.launches,
                    "adalomo_update": K.adalomo_update.launches}
        out["A"] = run_record(res_a, root)
        prof = res_a.find_hook(ProfilerHook)
        if prof.trace_path is None:
            raise AssertionError("resume: the profiler wrote no trace")
        out["profile"] = {"trace_bytes": os.path.getsize(prof.trace_path),
                          "window": [1, 2],
                          **profiled_kernels(prof.trace_path)}
        out["launches_A"] = launches
        want = TENSORS_PER_STEP * RESUME_STEPS
        if launches != {"adalomo_stats": want, "adalomo_update": want}:
            raise AssertionError(f"resume: A launched {launches}, expected "
                                 f"{want} each")
        if (out["profile"]["adalomo_stats"] != TENSORS_PER_STEP or
                out["profile"]["adalomo_update"] != 2 * TENSORS_PER_STEP):
            raise AssertionError(
                f"resume: the trace of step 1 holds {out['profile']}, "
                f"expected {TENSORS_PER_STEP} K1 and "
                f"{2 * TENSORS_PER_STEP} K2 kernels")
        final_a = (res_a.params, res_a.opt_state)
        shutil.rmtree(os.path.join(root, "ck_a"))

        # B: SIGTERM at step 0's boundary (user hooks run after the
        # PreemptionHook, which sees it at step 1's): checkpoint at step 2
        class SendSigterm(Hook):
            def on_step_end(self, ctx, ev):
                if ev.step == 0:
                    os.kill(os.getpid(), signal.SIGTERM)

        from repro_torch.checkpoint.manager import CheckpointManager
        spec_b = resume_spec(root, "ck_bc", "bc.jsonl")
        mgr_b = CheckpointManager(spec_b.checkpoint.dir, keep_last=1)
        try:
            run(spec_b, hooks=[SendSigterm()], ckpt_manager=mgr_b,
                log_fn=log)
            raise AssertionError("resume: B was not preempted")
        except Preempted as e:
            out["B"] = {"preempted_at": e.step, "signum": e.signum}
        marker = mgr_b.read_preempt_marker()
        out["B"].update(marker=marker, latest_step=mgr_b.latest_step(),
                        checkpoint_io=list(mgr_b.timings),
                        disk_free_bytes=shutil.disk_usage(root).free)
        if out["B"]["preempted_at"] != 2 or (marker or {}).get("step") != 2:
            raise AssertionError(f"resume: B preempted as {out['B']}")
        torch.cuda.empty_cache()

        # C: resumed from B's checkpoint, steps 2-3
        spec_c = dataclasses.replace(
            spec_b, checkpoint=dataclasses.replace(spec_b.checkpoint,
                                                   resume=True))
        res_c = run(spec_c, log_fn=log)
        out["C"] = run_record(res_c, root)
        stream = read_stream(spec_c.metrics_path)
        out["C"]["metrics_steps"] = [r["step"] for r in stream.steps()]
        out["C"]["bitwise_equal_A"] = bitwise_equal(
            (res_c.params, res_c.opt_state), final_a)
        checks = {
            "C resumed at 2": res_c.start_step == 2,
            "C params and OptState bitwise": out["C"]["bitwise_equal_A"],
            "C losses = A's tail": (res_c.history["loss"] ==
                                    res_a.history["loss"][2:]),
            "C eval = A's tail": (res_c.history["eval_loss"] ==
                                  res_a.history["eval_loss"][1:]),
            "marker consumed": mgr_b.read_preempt_marker() is None,
            "metrics steps 0-3 once": (out["C"]["metrics_steps"] ==
                                       list(range(RESUME_STEPS)))}
        del res_c
        shutil.rmtree(os.path.join(root, "ck_bc"))
        torch.cuda.empty_cache()

        # D: a transient device error after the real call 4 (step 3)
        spec_d = resume_spec(root, "ck_d", "d.jsonl")
        prog = build_step_program(spec_d)
        real, calls = prog.step, {"n": 0}

        def flaky(params, opt_state, batch, hp):
            result = real(params, opt_state, batch, hp)
            calls["n"] += 1
            if calls["n"] == 4:
                raise torch.AcceleratorError("injected")
            return result

        prog.step = flaky
        res_d = run(spec_d, program=prog, log_fn=log)
        out["D"] = run_record(res_d, root)
        out["D"]["step_calls"] = calls["n"]
        out["D"]["recover_events"] = read_stream(spec_d.metrics_path).events(
            "recover")
        out["D"]["bitwise_equal_A"] = bitwise_equal(
            (res_d.params, res_d.opt_state), final_a)
        checks.update({
            "D params and OptState bitwise": out["D"]["bitwise_equal_A"],
            "D history = A's": (res_d.history["step"] == list(
                range(RESUME_STEPS)) and res_d.history["loss"] ==
                res_a.history["loss"]),
            "D eval = A's": res_d.history["eval_loss"] ==
            res_a.history["eval_loss"],
            "D restored step 2 once": [(r["step"], r["failed_step"]) for r in
                                       out["D"]["recover_events"]] == [(2, 3)],
            "no heartbeat stall": not any(out[r]["heartbeat_stalled"]
                                          for r in "ACD")})
        del res_d
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t0
    emit("resume", arch=ARCH_ID, batch=4, seq=1024, steps=RESUME_STEPS,
         **out)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resume: failed {failed}")
    return {"launches": launches}


# --------------------------------------------------------------------------
# sentinel: the step guard, its policies and the optimizer-health probes
# --------------------------------------------------------------------------

SENTINEL_STEPS = {"A": 8, "B": 8, "C": 6}
# the two largest factored moments of danube (424,673,280 elements each
# reconstructed; ties broken by path)
SENTINEL_RECON_KEYS = ("recon/stacks/blocks/mlp/w_down",
                       "recon/stacks/blocks/mlp/w_gate")


def sentinel_spec(name: str, sentinel, *, root, observe=None,
                  checkpoint=None):
    from repro_torch.run import CheckpointSpec, ObservabilitySpec
    return RunSpec(
        model=ModelSpec(ARCH_ID, smoke=False),
        data=DataConfig(vocab=0, seq_len=1024, global_batch=4, seed=0),
        opt=OptSpec(name="adalomo"),
        steps=StepSpec(total=SENTINEL_STEPS[name]), log_every=1, seed=0,
        sentinel=sentinel, observe=observe or ObservabilitySpec(),
        checkpoint=checkpoint or CheckpointSpec(),
        metrics_path=os.path.join(root, f"{name}.jsonl"))


def n_syncs(caught: list) -> int:
    return sum("synchroniz" in str(w.message) for w in caught)


def sentinel_watch(caught: list, copy_at: int, check_at: int):
    """A user hook (the pipeline's last) that keeps each step's verdict and
    host syncs (counted from its own end at the previous step, so its own
    checks are not counted), the peak memory before it copies the state,
    and whether the state after ``check_at`` equals, bitwise on the card,
    the copy it took after ``copy_at``."""
    from repro_torch.core.tree import pytree_leaves, pytree_unflatten
    from repro_torch.run import Hook

    class Watch(Hook):
        def __init__(self):
            self.verdicts, self.syncs = [], []
            self.copy = self.bitwise = self.peak_before_copy = None
            self._mark = 0

        def on_run_start(self, ctx):
            self._mark = n_syncs(caught)

        def on_step_end(self, ctx, ev):
            self.syncs.append(n_syncs(caught) - self._mark)
            self.verdicts.append(dict(ev.metrics["sentinel"]))
            tree = (ctx.params, ctx.opt_state)
            if ev.step == copy_at:
                self.peak_before_copy = torch.cuda.max_memory_allocated()
                self.copy = pytree_unflatten(
                    tree, [t.clone() for t in pytree_leaves(tree)])
            elif ev.step == check_at:
                self.bitwise = bitwise_equal(tree, self.copy)
                self.copy = None
                torch.cuda.reset_peak_memory_stats()
            self._mark = n_syncs(caught)

    return Watch()


def sentinel_run(spec, inject, *, copy_at, check_at, logs):
    """One run of the phase: ``run(spec, inject=...)`` with K1/K2 counts
    set to 0 before it and read after, host syncs counted under the sync
    debug mode."""
    timing = TimingHook()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            watch = sentinel_watch(caught, copy_at, check_at)
            K.adalomo_stats.launches = 0
            K.adalomo_update.launches = 0
            result = run(spec, hooks=[timing, watch], inject=inject,
                         log_fn=lambda s: (logs.append(s),
                                           print("  " + s, flush=True)))
            launches = {"adalomo_stats": K.adalomo_stats.launches,
                        "adalomo_update": K.adalomo_update.launches}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return result, watch, timing, launches


def check_all_finite() -> dict:
    """The guard's finiteness sweep on the card: one NaN, +inf or -inf at a
    seeded position of a bf16 leaf of danube's largest shape, or of an fp32
    moment, is found ({case: found})."""
    from repro_torch.sentinel.guard import _all_finite
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    leaves = {"bf16 [24, 2560, 6912]": torch.randn(
        (N_LAYERS, 2560, 6912), generator=gen, device=DEV).to(torch.bfloat16),
        "fp32 [24, 6912]": torch.rand((N_LAYERS, 6912), generator=gen,
                                      device=DEV)}
    found = {}
    if not bool(_all_finite(leaves)):
        raise AssertionError("sentinel: a finite tree was found non-finite")
    for name, t in leaves.items():
        for bad in (float("nan"), float("inf"), -float("inf")):
            at = int(torch.randint(t.numel(), (1,), generator=gen,
                                   device=DEV))
            keep = t.view(-1)[at].clone()
            t.view(-1)[at] = bad
            found[f"{name} {bad} at {at}"] = not bool(_all_finite(leaves))
            t.view(-1)[at] = keep
    del leaves
    return found


def time_guard_parts(rounds: int = 5) -> dict:
    """Each part of the guard and the probes on danube's params at full
    size (a seeded relative update of 1e-3), timed alone: the device's time
    by CUDA events and the host's by its clock, medians of ``rounds``
    calls after one warm-up, in ms."""
    from repro_torch.core.tree import tree_leaves as leaves
    from repro_torch.run import ObservabilitySpec, build_step_program
    from repro_torch.sentinel import SentinelSpec
    from repro_torch.sentinel.guard import _all_finite
    from repro_torch.telemetry import probes as P
    spec = sentinel_spec("A", SentinelSpec(enabled=True),
                         root=tempfile.gettempdir(),
                         observe=ObservabilitySpec(optimizer_every=1,
                                                   factored_every=2))
    program = build_step_program(spec)
    params, state = program.init(0)
    opt = program.opt
    snap = P.Snapshot()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    old_p, old_s = snap.capture(params, state)
    for t in leaves(params):
        t.mul_(1 + 1e-3 * torch.randn(t.shape, generator=gen, device=DEV,
                                     dtype=t.dtype))
    for st in leaves(state.moments):
        for t in st:
            if t is not None:
                t.add_(torch.rand(t.shape, generator=gen, device=DEV))
    keep = torch.ones((), dtype=torch.bool, device=DEV)
    ospec = spec.observe
    sums = P.leaf_sums(old_p, params)
    hp = program.hparams_fn(1)

    def commit():
        for new, o in zip(P._tensors((params, state.moments)),
                          P._tensors((old_p, old_s.moments))):
            if new.is_floating_point():
                torch.where(keep, new, o, out=new)

    parts = {
        "snapshot copy": lambda: snap.capture(params, state),
        "finiteness sweep": lambda: _all_finite(params, state.moments),
        "unit sums (update only)": lambda: P.leaf_sums(old_p, params,
                                                       par=False),
        "unit sums (update and params)": lambda: P.leaf_sums(old_p, params),
        "commit": commit,
        "probes from the sums": lambda: P.optimizer_health(
            old_p, params, old_s, state, hp, opt=opt, ospec=ospec,
            sums=P.committed_sums(sums, keep)),
        "factored residuals": lambda: P.factored_health(
            old_s.moments, state.moments, 0.999, ospec)}
    out = {}
    for name, fn in parts.items():
        fn()
        dev_ms, host_ms = [], []
        for _ in range(rounds):
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            a.record()
            fn()
            b.record()
            host_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            dev_ms.append(a.elapsed_time(b))
        out[name] = {"ms": float(np.median(dev_ms)),
                     "host_ms": float(np.median(host_ms))}
    del params, state, old_p, old_s, snap, sums, program
    return out


def phase_sentinel(train=None) -> dict:
    """h2o-danube-1.8b at full width and depth through ``run(spec)`` with
    the sentinel on, fused AdaLomo (K1/K2), batch 4 x 1024, the metrics
    stream on: A skips a NaN'd update under the probes, B skips a spike
    and backs the lr off, C rolls back to a checkpoint and quarantines the
    batch.  Each run's memory is freed before the next (asserted)."""
    from repro_torch.run import (CheckpointHook, CheckpointSpec,
                                 ObservabilitySpec)
    from repro_torch.sentinel import Injection, SentinelSpec
    from repro_torch.telemetry.schema import read_stream

    t0 = time.perf_counter()
    finite = check_all_finite()
    parts = time_guard_parts()
    base = held_bytes()
    root = resume_root("chip_smoke_sentinel_")
    out, checks = {"baseline_allocated_bytes": base,
                   "all_finite_on_card": finite, "guard_parts": parts}, {
        "one bad element found in any piece": all(finite.values())}
    steps = SENTINEL_STEPS
    try:
        # A: a NaN'd update at step 3, skip + backoff, probes every step
        logs = []
        spec = sentinel_spec(
            "A", SentinelSpec(enabled=True, ladder=("skip", "backoff")),
            root=root, observe=ObservabilitySpec(optimizer_every=1,
                                                 factored_every=2))
        res, watch, timing, launches = sentinel_run(
            spec, Injection("nan_grads", at_step=3), copy_at=2, check_at=3,
            logs=logs)
        stream = read_stream(spec.metrics_path)
        probes = stream.probes()
        health = [r for r in probes if r["probe"] == "opt_health"]
        factored = [r for r in probes if r["probe"] == "factored"]
        v = watch.verdicts
        peak = max(watch.peak_before_copy, torch.cuda.max_memory_allocated())
        clean = [dt for i, dt in enumerate(timing.step_s) if i not in (0, 3)]
        out["A"] = {
            "steps": steps["A"], "losses": res.history["loss"],
            "step_seconds": timing.step_s, "launches": launches,
            "host_syncs_per_step": watch.syncs,
            "anomalies": [(a["anomaly"], a["step"], a["action"])
                          for a in stream.anomalies()],
            "verdict_step_3": v[3], "opt_step": int(res.opt_state.step),
            "bitwise_step_3_equals_step_2": watch.bitwise,
            "snapshot_bytes": res.program.snapshot.nbytes,
            "peak_memory_bytes": peak,
            "peak_before_check_copy_bytes": watch.peak_before_copy,
            "clean_step_seconds_median": float(np.median(clean)),
            "probe_records": {"opt_health": len(health),
                              "factored": len(factored)},
            "eff_lr_step_1": health[1]["eff_lr"] if len(health) > 1
            else None,
            "group_ratio_step_1": health[1]["group_ratio"]
            if len(health) > 1 else None,
            "factored_step_0": factored[0] if factored else None}
        if train is not None:
            out["A"]["train_phase"] = {
                "step_seconds": train["step_seconds"],
                "peak_memory_bytes": train["peak_memory_bytes"],
                "step_seconds_median_after_first": float(
                    np.median(train["step_seconds"][1:]))}
            out["A"]["guard_and_probes_ms_a_step"] = 1e3 * (
                out["A"]["clean_step_seconds_median"]
                - out["A"]["train_phase"]["step_seconds_median_after_first"])
        want_k = TENSORS_PER_STEP * steps["A"]
        checks.update({
            "A step 3 anomaly/nonfinite": (v[3]["anomaly"] == 1.0 and
                                           v[3]["nonfinite"] == 1.0),
            "A only step 3 anomalous": [x["anomaly"] for x in v] ==
            [float(i == 3) for i in range(steps["A"])],
            "A step 3 bitwise a no-op": watch.bitwise is True,
            "A opt_state.step == 7": int(res.opt_state.step) == 7,
            "A K1/K2 1360 each": launches == {"adalomo_stats": want_k,
                                              "adalomo_update": want_k},
            "A one host sync a step": watch.syncs == [1] * steps["A"],
            "A losses finite": len(res.history["loss"]) == steps["A"] and
            all(math.isfinite(x) for x in res.history["loss"]),
            "A probe records every step": (
                [r["step"] for r in health] == list(range(steps["A"])) and
                [r["step"] for r in factored] ==
                list(range(0, steps["A"], 2))),
            "A group ratios finite": all(
                math.isfinite(x) for r in health
                for x in r["group_ratio"].values()),
            # the skipped step committed nothing: every unit's relative
            # update is 0, below the histogram's range
            "A counts sum to n_units (0 at the skip)": all(
                sum(r["eff_lr"]["counts"]) == (
                    0 if r["step"] == 3 else r["eff_lr"]["n_units"])
                for r in health),
            "A recon finite >= 0 on the two largest": all(
                sorted(k for k in r if k.startswith("recon/")) ==
                list(SENTINEL_RECON_KEYS) and all(
                    math.isfinite(r[k]) and r[k] >= 0
                    for k in SENTINEL_RECON_KEYS) for r in factored),
            "A one anomaly record nonfinite/3/backoff": out["A"]["anomalies"]
            == [("nonfinite", 3, "backoff")]})
        del res, watch, stream
        out["A"]["allocated_after_free_bytes"] = held_bytes()
        checks["A memory freed"] = out["A"]["allocated_after_free_bytes"] \
            == base

        # B: an update scaled 100x at step 6, after the default warmup of 5
        spec = sentinel_spec(
            "B", SentinelSpec(enabled=True, ladder=("skip", "backoff")),
            root=root)
        res, watch, timing, launches = sentinel_run(
            spec, Injection("spike", at_step=6, scale=100.0), copy_at=5,
            check_at=6, logs=[])
        v = watch.verdicts
        stream = read_stream(spec.metrics_path)
        out["B"] = {
            "steps": steps["B"], "losses": res.history["loss"],
            "step_seconds": timing.step_s, "launches": launches,
            "host_syncs_per_step": watch.syncs,
            "update_norms": [x["update_norm"] for x in v],
            "ema_refs": [x["ema_ref"] for x in v],
            "lr_scales": [x["lr_scale"] for x in v],
            "anomalies": [(a["anomaly"], a["step"], a["action"])
                          for a in stream.anomalies()],
            "bitwise_step_6_equals_step_5": watch.bitwise,
            "opt_step": int(res.opt_state.step),
            "peak_memory_bytes": max(watch.peak_before_copy,
                                     torch.cuda.max_memory_allocated())}
        checks.update({
            "B spike at 6 and only there": (
                [x["spike"] for x in v] == [float(i == 6) for i in
                                            range(steps["B"])] and
                [x["anomaly"] for x in v] == [x["spike"] for x in v]),
            "B lr_scale 0.1 from step 7": out["B"]["lr_scales"] ==
            [1.0] * 7 + [float(torch.tensor(0.1, dtype=torch.float32))],
            "B step 6 bitwise a no-op": watch.bitwise is True,
            "B opt_state.step == 7": out["B"]["opt_step"] == 7,
            "B one host sync a step": watch.syncs == [1] * steps["B"],
            "B one anomaly record spike/6/backoff": out["B"]["anomalies"] ==
            [("spike", 6, "backoff")]})
        del res, watch, stream
        out["B"]["allocated_after_free_bytes"] = held_bytes()
        checks["B memory freed"] = out["B"]["allocated_after_free_bytes"] \
            == base

        # C: a NaN'd update at step 4 rolls back to the step-4 checkpoint
        logs = []
        ck = CheckpointSpec(dir=os.path.join(root, "ck_c"), every=2,
                            keep_last=1)
        spec = sentinel_spec(
            "C", SentinelSpec(enabled=True, ladder=("skip", "rollback"),
                              rollback_after=1), root=root, checkpoint=ck)
        res, watch, timing, launches = sentinel_run(
            spec, Injection("nan_grads", at_step=4), copy_at=-1,
            check_at=-1, logs=logs)
        mgr = res.find_hook(CheckpointHook).manager
        mgr.wait()
        stream = read_stream(spec.metrics_path)
        anoms = stream.anomalies()
        out["C"] = {
            "steps": steps["C"], "history_steps": res.history["step"],
            "losses": res.history["loss"], "step_seconds": timing.step_s,
            "launches": launches,
            "anomalies": anoms, "checkpoint_io": list(mgr.timings),
            "rolled_back_log": [m for m in logs if "rolled back" in m],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "disk_free_bytes": shutil.disk_usage(root).free}
        checks.update({
            "C rolled back to step 4": any("rolled back to step 4" in m
                                           for m in logs),
            "C quarantine [4, 5)": [a.get("quarantine") for a in anoms] ==
            [[4, 5]],
            "C rollback record": [(a["anomaly"], a["step"], a["action"],
                                   a.get("anomaly_step")) for a in anoms] ==
            [("nonfinite", 4, "rollback", 4)],
            "C completes with finite losses": (
                res.history["step"] == list(range(steps["C"])) and
                all(math.isfinite(x) for x in res.history["loss"])),
            "C K1/K2 170 a step run": launches == {
                "adalomo_stats": TENSORS_PER_STEP * (steps["C"] + 1),
                "adalomo_update": TENSORS_PER_STEP * (steps["C"] + 1)}})
        del res, watch, stream, mgr
        shutil.rmtree(ck.dir, ignore_errors=True)
        out["C"]["allocated_after_free_bytes"] = held_bytes()
        checks["C memory freed"] = out["C"]["allocated_after_free_bytes"] \
            == base
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t0
    emit("sentinel", arch=ARCH_ID, batch=4, seq=1024, **out)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sentinel: failed {failed}")
    return out


# --------------------------------------------------------------------------
# baselines: the paper's Table 1 on the card
# --------------------------------------------------------------------------

# (registry name, fused): AdaLomo and LOMO fuse the update into the backward
# loop; Adafactor and AdamW take whole-model gradients, then Opt.step.
BASELINE_ARMS = (("adalomo", True), ("lomo", True), ("adafactor", False),
                 ("adamw", False))
BASELINE_STEPS = 2
BASELINE_BATCH, BASELINE_SEQ = 4, 1024
# the three leaves of the card-against-CPU check: (path, shape, dtype,
# batch_dims) — the embedding, a stacked [L, m, n] projection, a norm scale
RULE_CHECK_LEAVES = (("outer/tok_embed", (32000, 2560), torch.bfloat16, 0),
                     ("stacks/blocks/attn/wk", (N_LAYERS, 2560, 640),
                      torch.bfloat16, 1),
                     ("outer/final_norm/scale", (2560,), torch.float32, 0))
RULE_CHECK_RTOL = 1e-6


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def ticket_bytes() -> int:
    """Bytes of the kernels' integer ticket counters on the card: allocated
    once a device and kernel and kept for the life of the process (a dry
    trace's, on the meta device, hold nothing)."""
    from repro_torch.kernels import tickets
    return sum(t.numel() * t.element_size()
               for bufs in tickets._BUFFERS.values() for t in bufs
               if t.is_cuda)


def held_bytes() -> int:
    """Bytes allocated on the card beside the ticket counters, after the
    cyclic GC, with cuBLAS's workspaces (one a thread and stream, kept by
    the allocator) released and the allocator's cache emptied."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() - ticket_bytes()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at ``x`` (8 significant bits)."""
    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), 2.0 ** -126)))
    return torch.exp2(e - 7)


def check_rules_card_vs_cpu() -> dict:
    """AdamW and Adafactor steps 1 and 2 on three leaves of danube's shapes
    (seeded values, weight decay on), each step on the card and on CPU
    copies of the card's params and state before it, with the same
    gradient.  fp32 state within 1e-6 relative; params within 1e-6 of the
    step they took (the update's own arithmetic) plus, in bf16, one ulp of
    the stored value (its rounding) and, in fp32, 1e-6 of it.  Where a step
    cancels the value, the first term is many ulps of the small result:
    the count of bf16 params more than one ulp off is reported."""
    from repro_torch.core.api import hparams_on_device
    out = {}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    cpu = torch.device("cpu")

    def host(t):
        return None if t is None else t.to(cpu, copy=True)

    for name in ("adamw", "adafactor"):
        rule = opt_lib.get_rule(name)
        hp = {**rule.hparams, "lr": 1e-3, "weight_decay": 0.1}
        hp_dev = hparams_on_device((hp,), DEV)[0]
        hp_cpu = hparams_on_device((hp,), cpu)[0]
        for path, shape, dt, bd in RULE_CHECK_LEAVES:
            p = (torch.randn(shape, generator=gen, device=DEV) * 0.05).to(dt)
            st = rule.init(p, batch_dims=bd)
            rec = {}
            for step in (1.0, 2.0):
                p0, pc = host(p), host(p)
                stc = type(st)(*map(host, st))
                g = (torch.randn(shape, generator=gen, device=DEV)
                     * 1e-3).to(dt)
                rule.update(p, g, st, hp_dev,
                            torch.tensor(step, device=DEV), batch_dims=bd)
                rule.update(pc, host(g), stc, hp_cpu, torch.tensor(step),
                            batch_dims=bd)
                for field, a, b in zip(st._fields, st, stc):
                    if a is None:
                        continue
                    d = (host(a) - b).abs()
                    rel = float((d / torch.clamp_min(b.abs(), 1e-30)).max())
                    key = f"{field}_max_rel_err"
                    rec[key] = max(rec.get(key, 0.0), rel)
                    if bool((d > RULE_CHECK_RTOL * b.abs()).any()):
                        raise AssertionError(
                            f"baselines: {name} {path} step {step:.0f} state "
                            f"{field} on the card is {rel:.3e} from the "
                            f"CPU's (rtol {RULE_CHECK_RTOL})")
                a32, b32 = host(p).float(), pc.float()
                d = (a32 - b32).abs()
                # the update's own error, 1e-6 of the step it took, beside
                # the rounding of the stored value: where the step cancels
                # the value, the first is many ulps of the small result
                lim = RULE_CHECK_RTOL * (b32 - p0.float()).abs()
                if dt == torch.bfloat16:
                    ulp = torch.maximum(bf16_ulp(a32), bf16_ulp(b32))
                    ulps = d / bf16_ulp(b32)
                    rec["param_max_ulps"] = max(rec.get("param_max_ulps", 0),
                                                float(ulps.max()))
                    rec["params_over_1_ulp"] = rec.get(
                        "params_over_1_ulp", 0) + int((ulps > 1).sum())
                    lim = lim + ulp
                else:
                    rec["param_max_abs_err"] = max(
                        rec.get("param_max_abs_err", 0.0), float(d.max()))
                    lim = lim + RULE_CHECK_RTOL * b32.abs()
                bad = bool((d > lim).any())
                if bad or torch.equal(pc, p0):
                    raise AssertionError(
                        f"baselines: {name} {path} step {step:.0f}: params on "
                        f"the card and on the CPU disagree or did not move: "
                        f"{rec}")
            out[f"{name}:{path}"] = rec
            del p, pc, p0, st, stc, g
    return out


def finite_flag(tree) -> torch.Tensor:
    """A 0-d bool on the card: whether every element of ``tree`` is finite,
    checked in ``leading_pieces`` (a whole-leaf mask of qwen3-32b's largest
    stack would take 15.6 GiB)."""
    return torch.stack([torch.isfinite(x).all() for t in tree_leaves(tree)
                        for x in leading_pieces(t.detach())]).all()


def all_finite(tree) -> bool:
    """``finite_flag`` read back."""
    return bool(finite_flag(tree))


def baseline_arm(name: str, fused: bool, base: int, *, arch_id=ARCH_ID,
                 steps=BASELINE_STEPS, batch=BASELINE_BATCH,
                 seq=BASELINE_SEQ, hooks=(), n_layers=None) -> dict:
    """One arm of the Table-1 comparison through ``run(spec)``: its step
    program and init first, to read what params and state hold; then the
    run, with K1/K2 counts set to 0 before it and read after, host syncs
    counted under the sync debug mode (``hooks`` join the pipeline's end);
    then everything freed.  ``n_layers`` cuts the depth (published widths
    kept)."""
    from repro_torch.run import build_step_program
    spec = RunSpec(model=ModelSpec(arch_id, smoke=False),
                   data=DataConfig(vocab=0, seq_len=seq, global_batch=batch,
                                   seed=0),
                   opt=OptSpec(name=name),
                   steps=StepSpec(total=steps, fused=fused),
                   log_every=1, seed=0)
    arch = get_arch(arch_id)
    if n_layers is not None:
        arch = with_layers(arch, n_layers)
    torch.cuda.reset_peak_memory_stats()
    program = build_step_program(spec, arch)
    params, opt_state = program.init(spec.seed)
    init_bytes = held_bytes() - base
    rec = {"arch": arch_id, "n_layers": getattr(arch.cfg, "n_layers", None),
           "batch": batch,
           "seq": seq,
           "optimizer": name, "engine": "fused" if fused else "unfused",
           "n_params": sum(p.numel() for p in tree_leaves(params)),
           "param_bytes": tree_bytes(params),
           "state_bytes": program.opt.state_bytes(params),
           # unfused: one gradient a parameter, in the parameter's dtype,
           # all alive at once; fused: about one layer's, never the model's
           "grad_bytes": 0 if fused else tree_bytes(params),
           "init_allocated_bytes": init_bytes}
    timing = TimingHook()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            K.adalomo_stats.launches = 0
            K.adalomo_update.launches = 0
            result = run(spec, program=program, params=params,
                         opt_state=opt_state, hooks=[timing, *hooks],
                         log_fn=lambda s: print("  " + s, flush=True))
            launches = {"adalomo_stats": K.adalomo_stats.launches,
                        "adalomo_update": K.adalomo_update.launches}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rec.update(
        losses=result.history["loss"], step_seconds=timing.step_s,
        launches=launches,
        host_syncs=sum("synchroniz" in str(w.message) for w in caught),
        host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in caught
                                if "synchroniz" in str(w.message)}),
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        peak_above_baseline_bytes=torch.cuda.max_memory_allocated() - base,
        params_finite=all_finite(result.params))
    del result, params, opt_state, program
    rec["allocated_after_free_bytes"] = held_bytes()
    return rec


def phase_baselines() -> dict:
    """The paper's Table 1 on the card: h2o-danube-1.8b at full width and
    depth, batch 4 x 1024, 2 steps of fused AdaLomo (K1/K2), fused LOMO,
    unfused Adafactor and unfused AdamW, each arm's memory freed before the
    next; then the new rules' arithmetic on the card against the CPU."""
    t0 = time.perf_counter()
    base = held_bytes()
    arms, failed = [], []
    for name, fused in BASELINE_ARMS:
        rec = baseline_arm(name, fused, base)
        print("  " + json.dumps({"arm": rec}), flush=True)
        arms.append(rec)
        if rec["allocated_after_free_bytes"] != base:
            failed.append(f"{name}: {rec['allocated_after_free_bytes']} "
                          f"bytes held after the arm, {base} before")
    by = {r["optimizer"]: r for r in arms}
    n = by["adamw"]["n_params"]
    want_k = {"adalomo_stats": TENSORS_PER_STEP * BASELINE_STEPS,
              "adalomo_update": TENSORS_PER_STEP * BASELINE_STEPS}
    for r in arms:
        if len(r["losses"]) != BASELINE_STEPS or not all(
                math.isfinite(x) for x in r["losses"]):
            failed.append(f"{r['optimizer']}: losses {r['losses']}")
        if not r["params_finite"]:
            failed.append(f"{r['optimizer']}: a parameter is not finite")
        want = (want_k if r["optimizer"] == "adalomo"
                else dict.fromkeys(want_k, 0))
        if r["launches"] != want:
            failed.append(f"{r['optimizer']}: K1/K2 launches "
                          f"{r['launches']}, expected {want}")
        if r["host_syncs"] != BASELINE_STEPS:
            failed.append(f"{r['optimizer']}: {r['host_syncs']} host syncs "
                          f"in {BASELINE_STEPS} steps")
    if by["adamw"]["state_bytes"] != 8 * n:
        failed.append(f"adamw: state {by['adamw']['state_bytes']} bytes, "
                      f"expected 8 x {n}")
    peak = {k: r["peak_memory_bytes"] for k, r in by.items()}
    lo, hi = sorted((peak["adalomo"], peak["lomo"]))
    if not (hi <= 1.05 * lo and hi < peak["adafactor"] < peak["adamw"]):
        failed.append(f"peak ordering AdaLomo ~ LOMO < Adafactor < AdamW "
                      f"does not hold: {peak}")
    rules = check_rules_card_vs_cpu()
    emit("baselines", arch=ARCH_ID, batch=BASELINE_BATCH, seq=BASELINE_SEQ,
         steps=BASELINE_STEPS, baseline_allocated_bytes=base, arms=arms,
         peak_ratio_adamw_over_adalomo=peak["adamw"] / peak["adalomo"],
         rules_card_vs_cpu=rules, rule_rtol=RULE_CHECK_RTOL,
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"baselines: {failed}")
    return by


# --------------------------------------------------------------------------
# packed: segment-packed AdaLomo training
# --------------------------------------------------------------------------

PACKED_ROWS, PACKED_SEQ = 2, 4096
PACKED_DOC_LENS = (64, 3000)       # slots a document, inclusive
PACKED_STEPS = 2
PACKED_SOLO_RTOL = 1e-2


def packed_batches(seed: int, vocab: int):
    """Packed numpy batches of ragged synthetic documents, 64-3000 tokens
    each (the pipeline's synthetic language, its own packer), first-fit
    into 2 rows of 4096; a row's worth of slack is drawn for it to drop."""
    from repro_torch.data.pipeline import SyntheticLM, pack_documents
    src = SyntheticLM(DataConfig(vocab=vocab, seq_len=PACKED_SEQ,
                                 global_batch=PACKED_ROWS, seed=seed))
    step = 0
    while True:
        rng = np.random.default_rng((seed, step))
        docs, total = [], 0
        while total < (PACKED_ROWS + 1) * PACKED_SEQ:
            n = int(rng.integers(PACKED_DOC_LENS[0], PACKED_DOC_LENS[1] + 1))
            docs.append(src._doc(rng, n))
            total += n
        yield pack_documents(docs, PACKED_ROWS, PACKED_SEQ)[0].as_dict()
        step += 1


def segments(batch) -> list:
    """(row, segment id, start, length) of every document of a batch."""
    out = []
    for r, row in enumerate(batch["segment_ids"]):
        for s in range(1, int(row.max()) + 1):
            idx = np.flatnonzero(row == s)
            out.append((r, s, int(idx[0]), int(idx.size)))
    return out


def doc_loss(loss_fn, params, batch, row, seg, tokens=None):
    """The loss of one document of a packed batch, with the labels of every
    other slot masked; ``tokens`` replaces the batch's."""
    b = dict(batch)
    keep = (batch["segment_ids"] == seg) & (
        np.arange(batch["tokens"].shape[0])[:, None] == row)
    b["labels"] = np.where(keep, batch["labels"], -1).astype(np.int32)
    if tokens is not None:
        b["tokens"] = tokens
    with torch.no_grad():
        loss, m = loss_fn(params, {k: torch.from_numpy(v).to(DEV)
                                   for k, v in b.items()})
    return loss, int(m["ntokens"])


def check_packed_documents(loss_fn, params, batch, vocab: int) -> dict:
    """At the initial weights: two documents' losses bitwise unchanged when
    every other document's tokens are junk (one crosses a 1024-token block
    boundary), and each within 1e-2 of the same document alone in a row of
    4096 (bf16 activations change the reduction order across layouts)."""
    from repro_torch.data.pipeline import pack_documents
    segs = segments(batch)
    crossing = [s for s in segs if s[2] // 1024 != (s[2] + s[3] - 1) // 1024]
    if not crossing:
        raise AssertionError(f"packed: no document crosses a block boundary: "
                             f"{segs}")
    # rather one that starts inside a row, behind foreign documents
    chosen = [max(crossing, key=lambda s: s[2] > 0)]
    chosen.append(next(s for s in reversed(segs) if s[:2] != chosen[0][:2]))
    junk = np.random.default_rng(1).integers(
        0, vocab, batch["tokens"].shape).astype(np.int32)
    out = []
    for row, seg, start, n in chosen:
        keep = (batch["segment_ids"] == seg) & (
            np.arange(PACKED_ROWS)[:, None] == row)
        ref, ntok = doc_loss(loss_fn, params, batch, row, seg)
        scrub, _ = doc_loss(loss_fn, params, batch, row, seg,
                            tokens=np.where(keep, batch["tokens"], junk))
        doc = np.concatenate([batch["tokens"][row, start:start + n],
                              batch["labels"][row, start + n - 1:start + n]])
        solo = pack_documents([doc], 1, PACKED_SEQ)[0].as_dict()
        solo_loss, solo_ntok = doc_loss(loss_fn, params, solo, 0, 1)
        rec = {"row": row, "segment": seg, "start": start, "tokens": n,
               "crosses_block": start // 1024 != (start + n - 1) // 1024,
               "loss": float(ref), "loss_scrubbed": float(scrub),
               "bitwise_unchanged": bool(torch.equal(ref, scrub)),
               "loss_solo": float(solo_loss), "ntokens": ntok,
               "solo_rel_gap": abs(float(ref) - float(solo_loss))
               / abs(float(solo_loss))}
        out.append(rec)
        if ntok != n or solo_ntok != n:
            raise AssertionError(f"packed: a document's tokens {rec}")
    return {"documents": out}


def phase_packed() -> dict:
    """``run(spec)`` on h2o-danube-1.8b at full width and depth with
    segment-packed batches of 2 x 4096 tokens: fused AdaLomo through K1/K2,
    attention on the segmented flash branch (S > 2048), 2 steps; before
    them, zero leakage and packed-against-solo at the initial weights."""
    from repro_torch.run import build_step_program
    from repro_torch.telemetry.schema import read_stream
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_packed_")
    try:
        spec = RunSpec(model=ModelSpec(ARCH_ID, smoke=False),
                       data=DataConfig(vocab=0, seq_len=PACKED_SEQ,
                                       global_batch=PACKED_ROWS, seed=0,
                                       packing=True),
                       opt=OptSpec(name="adalomo"),
                       steps=StepSpec(total=PACKED_STEPS), log_every=1,
                       seed=0, metrics_path=os.path.join(root, "m.jsonl"))
        program = build_step_program(spec)
        params, opt_state = program.init(spec.seed)
        vocab = program.arch.cfg.vocab
        first = next(packed_batches(0, vocab))
        docs = check_packed_documents(program.loss_fn, params, first, vocab)
        it = packed_batches(0, vocab)
        batches = [next(it) for _ in range(PACKED_STEPS)]
        timing = TimingHook()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                K.adalomo_stats.launches = 0
                K.adalomo_update.launches = 0
                result = run(spec, program=program, params=params,
                             opt_state=opt_state, batch_iter=iter(batches),
                             hooks=[timing],
                             log_fn=lambda s: print("  " + s, flush=True))
                launches = {"adalomo_stats": K.adalomo_stats.launches,
                            "adalomo_update": K.adalomo_update.launches}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        losses = result.history["loss"]
        finite = all_finite(result.params)
        eff = [r["padding_efficiency"]
               for r in read_stream(spec.metrics_path).steps()]
        out = dict(
            docs, losses=losses, step_seconds=timing.step_s,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            padding_efficiency=eff,
            docs_per_row=[[int(row.max()) for row in b["segment_ids"]]
                          for b in batches],
            doc_lengths=[sorted(n for *_, n in segments(b)) for b in batches],
            launches=launches, host_syncs=syncs, params_finite=finite)
        del result, params, opt_state, program
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    emit("packed", arch=ARCH_ID, rows=PACKED_ROWS, seq=PACKED_SEQ,
         steps=PACKED_STEPS, doc_len_range=PACKED_DOC_LENS,
         solo_rtol=PACKED_SOLO_RTOL, **out)
    want = TENSORS_PER_STEP * PACKED_STEPS
    failed = []
    if launches != {"adalomo_stats": want, "adalomo_update": want}:
        failed.append(f"K1/K2 launches {launches}, expected {want} each")
    if syncs != PACKED_STEPS:
        failed.append(f"{syncs} host syncs in {PACKED_STEPS} steps")
    if len(losses) != PACKED_STEPS or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    if not finite:
        failed.append("a parameter is not finite")
    for d in out["documents"]:
        if not d["bitwise_unchanged"]:
            failed.append(f"leakage: document {d} changed under the scrub")
        if d["solo_rel_gap"] > PACKED_SOLO_RTOL:
            failed.append(f"document {d}: packed and solo losses differ by "
                          f"more than {PACKED_SOLO_RTOL}")
    if not any(d["crosses_block"] for d in out["documents"]):
        failed.append("no checked document crosses a block boundary")
    if failed:
        raise AssertionError(f"packed: {failed}")
    return out


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

SERVE_CFG = dict(page_size=16, max_batch=8, max_pages_per_seq=128,
                 num_pages=1025, chunk=8, max_new_tokens=64)
SERVE_REQUESTS = 16
SERVE_PROMPT_LENS = (32, 1900)


def phase_serve() -> dict:
    """PagedEngine on h2o-danube-1.8b at its published width and depth, bf16,
    random weights from a seed: 16 requests, 8 submitted, the other 8 after
    the first step (mid-flight admission)."""
    arch = get_arch(ARCH_ID)
    params = arch.init_params(0)
    report, launches = paged_serve_run(arch, params, SERVE_CFG,
                                       SERVE_REQUESTS, SERVE_PROMPT_LENS)
    emit("serve", arch=ARCH_ID, **report)
    return {"launches": launches}


def paged_serve_run(arch, params, serve_cfg: dict, requests: int,
                    prompt_lens: tuple, seed: int = 0) -> tuple:
    """PagedEngine over ``requests`` prompts of ``prompt_lens`` tokens (drawn
    from ``seed``), half submitted, the rest after the first step
    (mid-flight admission), after a warmup of the prompt buckets.  Asserts
    every request's tokens, every page back, K3 launches == layers x decode
    steps (counted after the warmup), synchronising host transfers ==
    chunks + admissions, no input signature the warmup had not run.
    Returns the report and the K3 launches."""
    n_layers = arch.cfg.n_layers
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, requests)
    prompts = [rng.integers(1, arch.cfg.vocab, int(n)).tolist()
               for n in lens]
    first = requests // 2
    with tempfile.TemporaryDirectory() as tmp:
        gauges = os.path.join(tmp, "serve.jsonl")
        scfg = PagedServeConfig(**serve_cfg, telemetry_path=gauges)
        eng = PagedEngine(arch, params, scfg)
        free0 = eng.allocator.n_free
        t0 = time.perf_counter()
        eng.warmup(list(prompt_lens))
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        warm_prefill, warm_decode = (eng.prefill_compile_count(),
                                     eng.decode_compile_count())
        chunks0 = eng.chunk_count
        admitted0 = eng.scheduler.counters["admitted"]
        pf0, dec0 = eng.telemetry.prefill_s, eng.telemetry.decode_s
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                KD.paged_decode_attention.launches = 0
                t0 = time.perf_counter()
                rids = [eng.submit(p) for p in prompts[:first]]
                eng.step()
                rids += [eng.submit(p) for p in prompts[first:]]
                eng.run()
                wall_s = time.perf_counter() - t0
                launches = KD.paged_decode_attention.launches
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng.telemetry.close()
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    chunks = eng.chunk_count - chunks0
    admissions = eng.scheduler.counters["admitted"] - admitted0
    decode_steps = chunks * scfg.chunk
    outs = [eng.requests[r].out for r in rids]
    prefill_s = eng.telemetry.prefill_s - pf0
    decode_s = eng.telemetry.decode_s - dec0
    # the first token of each admission comes from its prefill
    decode_tokens = sum(len(o) for o in outs) - admissions
    report = dict(
        n_layers=n_layers,
        dtype=str(arch.cfg.dtype), config=serve_cfg,
        requests=requests, prompt_lens=[int(n) for n in lens],
        warmup_seconds=warmup_s, wall_seconds=wall_s,
        prefill_seconds=prefill_s, decode_seconds=decode_s,
        decode_tokens=decode_tokens,
        decode_tokens_per_s=decode_tokens / decode_s,
        ms_per_decode_step=decode_s / decode_steps * 1e3,
        chunks=chunks, decode_steps=decode_steps, admissions=admissions,
        preemptions=eng.scheduler.counters["preempted"],
        launches={"paged_decode_attention": launches},
        host_syncs=len(syncs),
        host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in syncs}),
        decode_signatures=eng.decode_compile_count(),
        prefill_signatures=eng.prefill_compile_count(),
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    bad = [i for i, o in enumerate(outs) if len(o) != serve_cfg[
        "max_new_tokens"]]
    if bad:
        raise AssertionError(f"serve: requests {bad} did not emit "
                             f"{serve_cfg['max_new_tokens']} tokens")
    if any(not 0 <= t < arch.cfg.vocab for o in outs for t in o):
        raise AssertionError("serve: a token id outside the vocabulary")
    if eng.allocator.n_free != free0 or eng.scheduler.has_work():
        raise AssertionError(f"serve: {eng.allocator.n_free} pages free "
                             f"after the run, {free0} before")
    if launches != n_layers * decode_steps:
        raise AssertionError(f"serve: {launches} paged_decode_attention "
                             f"launches, expected {n_layers} x "
                             f"{decode_steps} decode steps")
    if len(syncs) != chunks + admissions:
        raise AssertionError(
            f"serve: {len(syncs)} synchronising host transfers, expected "
            f"{chunks} chunks + {admissions} admissions")
    if (eng.decode_compile_count(), eng.prefill_compile_count()) != (
            warm_decode, warm_prefill):
        raise AssertionError("serve: an input signature the warmup had not "
                             "run")
    return report, launches


SERVE_PARITY_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
SERVE_PARITY_PROMPT_LENS = (700, 33, 1500, 257)


def phase_serve_parity() -> None:
    """The engine through K3 (use_kernel=None) against the plain version
    (use_kernel=False), at full width and 2 layers: the logits of one decode
    step over the same pool, and greedy tokens end to end."""
    rng = np.random.default_rng(1)
    report = {str(dtype): paged_parity(ARCH_ID, dtype, rng,
                                       SERVE_PARITY_PROMPT_LENS)
              for dtype in (torch.float32, torch.bfloat16)}
    emit("serve_parity", n_layers=2, d_model=get_arch(ARCH_ID).cfg.d_model,
         prompt_lens=list(SERVE_PARITY_PROMPT_LENS), max_new_tokens=16,
         **report)


def paged_parity(arch_id: str, dtype, rng, prompt_lens, *, n_layers: int = 2,
                 check_bf16_logits: bool = True) -> dict:
    """``arch_id`` at full width and ``n_layers`` layers in ``dtype``: one
    decode step's logits through K3 against the plain version over the same
    pool (asserted within ``SERVE_PARITY_TOL``; in bf16 only with
    ``check_bf16_logits``), and greedy tokens of the engine end to end
    (asserted equal in fp32, reported in bf16)."""
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=n_layers, dtype=dtype))
    params = arch.init_params(0)
    prompts = [rng.integers(1, arch.cfg.vocab, n).tolist()
               for n in prompt_lens]
    scfg = PagedServeConfig(**dict(SERVE_CFG, max_batch=4,
                                   max_new_tokens=16))
    eng = PagedEngine(arch, params, scfg)
    for p in prompts:
        eng.submit(p)
    eng._admit_all()
    eng._ensure_ahead_all()
    tables = build_block_tables(eng.scheduler.page_lists(),
                                scfg.max_pages_per_seq)
    batch = {"tokens": torch.from_numpy(eng._tok[:, None]).to(DEV),
             "block_tables": torch.from_numpy(tables).to(DEV),
             "seq_lens": torch.from_numpy(eng._n).to(DEV),
             "emit": torch.from_numpy(~eng._done).to(DEV)}
    logits = {}
    for use_kernel in (None, False):
        pages = {k: v.clone() for k, v in eng._pages.items()}
        logits[use_kernel] = arch.make_paged_decode_step(
            use_kernel=use_kernel)(params, pages, batch)[0]
    err = max_err(logits[None], logits[False])
    tokens = {}
    for use_kernel in (None, False):
        e = PagedEngine(arch, params, dataclasses.replace(
            scfg, use_kernel=use_kernel))
        tokens[use_kernel] = e.generate(prompts)
    torch.cuda.synchronize()
    out = {
        "logits_max_abs_err": err, "tolerance": SERVE_PARITY_TOL[dtype],
        "greedy_tokens_equal": tokens[None] == tokens[False],
        "tokens_kernel": tokens[None][0][:8],
        "tokens_plain": tokens[False][0][:8]}
    if not err <= SERVE_PARITY_TOL[dtype] and (
            dtype == torch.float32 or check_bf16_logits):
        raise AssertionError(f"paged parity {arch_id} {dtype}: "
                             f"decode-step logits differ by {err}")
    if dtype == torch.float32 and tokens[None] != tokens[False]:
        raise AssertionError(f"paged parity {arch_id} fp32: greedy "
                             "tokens differ between the kernel and the "
                             "plain version")
    del eng, e, params
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# legacy serve
# --------------------------------------------------------------------------

LEGACY_BATCH = 4
LEGACY_PROMPT_LEN = 6144
LEGACY_NEW_TOKENS = 64


def _event_timed(fn, log: list):
    """``fn`` with CUDA events recorded around each call (no host sync)."""
    def run(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kwargs)
        e1.record()
        log.append((e0, e1))
        return out
    return run


def phase_legacy_serve() -> dict:
    """Engine on h2o-danube-1.8b at its published width and depth, bf16,
    random weights from a seed: 4 prompts of 6144 tokens (prefill through
    the sliding-window gather; a ring of the window's 4096 slots that wraps
    every step), 64 greedy tokens each."""
    arch = get_arch(ARCH_ID)
    params = arch.init_params(0)
    report, launches, _ = legacy_serve_run(
        arch, params, LEGACY_BATCH, LEGACY_PROMPT_LEN, LEGACY_NEW_TOKENS)
    emit("legacy_serve", arch=ARCH_ID, **report)
    return {"launches": launches}


def k4_per_decode_step(arch, use_kernel=None) -> int:
    """K4 launches a legacy decode step: one a layer of a GQA transformer,
    one an application of zamba2-1.2b's shared attention block; none for
    MLA (its latent cache decodes in plain PyTorch), for mamba2 (no
    attention) or with ``use_kernel=False``."""
    if (use_kernel is False or arch.family == "mamba2"
            or getattr(arch.cfg, "mla", None) is not None):
        return 0
    if arch.family == "hybrid":
        return arch.cfg.n_attn_applications()
    return arch.cfg.n_layers


def legacy_serve_run(arch, params, batch: int, prompt_len: int,
                     new_tokens: int, seed: int = 2, *, extras=None,
                     use_kernel=None) -> tuple:
    """Engine over ``batch`` prompts of ``prompt_len`` tokens from ``seed``
    (and ``extras``, a modality prefix's inputs), ``new_tokens`` greedy
    tokens each.  Asserts the tokens, K4 launches ==
    ``k4_per_decode_step`` x decode steps and one synchronising host
    transfer a step.
    Returns the report, the K4 launches and the tokens."""
    n_layers = arch.cfg.n_layers
    k4_layers = k4_per_decode_step(arch, use_kernel)
    n_prefix = getattr(arch.cfg, "n_prefix_tokens", 0)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, arch.cfg.vocab, prompt_len).tolist()
               for _ in range(batch)]
    eng = Engine(arch, params, ServeConfig(max_new_tokens=new_tokens,
                                           use_kernel=use_kernel))
    prefill_ev, decode_ev = [], []
    eng._prefill = _event_timed(eng._prefill, prefill_ev)
    eng._decode = _event_timed(eng._decode, decode_ev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            KD.decode_attention.launches = 0
            t0 = time.perf_counter()
            outs = eng.generate(prompts, extras=extras)
            wall_s = time.perf_counter() - t0
            launches = KD.decode_attention.launches
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    steps = len(decode_ev)
    prefill_s = prefill_ev[0][0].elapsed_time(prefill_ev[0][1]) / 1e3
    decode_s = decode_ev[0][0].elapsed_time(decode_ev[-1][1]) / 1e3
    report = dict(
        n_layers=n_layers, dtype=str(arch.cfg.dtype), batch=batch,
        prompt_len=prompt_len, n_prefix_tokens=n_prefix,
        ring_slots=(0 if arch.family == "mamba2" else
                    prompt_len if arch.family == "hybrid" else
                    cache_window(arch.cfg, prompt_len + n_prefix)),
        max_new_tokens=new_tokens, wall_seconds=wall_s,
        prefill_seconds=prefill_s, decode_steps=steps,
        decode_seconds=decode_s, ms_per_decode_step=decode_s / steps * 1e3,
        decode_tokens_per_s=batch * steps / decode_s,
        launches={"decode_attention": launches}, host_syncs=len(syncs),
        host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in syncs}),
        tokens_row0=outs[0][:8],
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    if [len(o) for o in outs] != [new_tokens] * batch:
        raise AssertionError(f"legacy_serve: rows emitted "
                             f"{[len(o) for o in outs]} tokens, expected "
                             f"{new_tokens} each")
    if any(not 0 <= t < arch.cfg.vocab for o in outs for t in o):
        raise AssertionError("legacy_serve: a token id outside the vocabulary")
    if steps != new_tokens - 1 or launches != k4_layers * steps:
        raise AssertionError(f"legacy_serve: {launches} decode_attention "
                             f"launches in {steps} decode steps, expected "
                             f"{k4_layers} x {new_tokens - 1}")
    if len(syncs) != new_tokens:
        raise AssertionError(
            f"legacy_serve: {len(syncs)} synchronising host transfers, "
            f"expected one per emitted step ({new_tokens})")
    return report, launches, outs



LEGACY_PARITY_LENS = (1024, 3072, 6144)   # direct, blockwise, window gather


def decode_step_both(arch, params, batch: dict) -> tuple:
    """A prefill of ``batch`` (``tokens`` and any prefix leaves, numpy or
    on the card), then one decode step of its greedy token through K4
    (``None``) and through the plain attention (``False``), each on its own
    copy of the ring: the two steps' logits by ``use_kernel``, and the
    ring's slots."""
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    logits0, cache = arch.make_prefill_step()(params, batch)
    nxt = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
    logits = {}
    for use_kernel in (None, False):
        c = {k: v.clone() for k, v in cache.items()}
        logits[use_kernel] = arch.make_decode_step(use_kernel=use_kernel)(
            params, c, {"tokens": nxt})[0]
    return logits, int(cache["pos"].shape[0])


def phase_legacy_parity() -> None:
    """At full width and 2 layers, fp32 and bf16: one decode step's logits
    through K4 (use_kernel=None) against the plain version (use_kernel=False)
    over the same cache, and greedy tokens of Engine end to end, after
    prefills that take each attention branch; then the flash branch's value
    and gradients against direct attention at danube's heads."""
    rng = np.random.default_rng(3)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        arch = get_arch(ARCH_ID)
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=2, dtype=dtype))
        params = arch.init_params(0)
        for S in LEGACY_PARITY_LENS:
            toks = rng.integers(1, arch.cfg.vocab, (2, S)).astype(np.int32)
            logits, slots = decode_step_both(arch, params, {"tokens": toks})
            err = max_err(logits[None], logits[False])
            prompts = toks.tolist()
            tokens = {u: Engine(arch, params, ServeConfig(
                max_new_tokens=16, use_kernel=u)).generate(prompts)
                for u in (None, False)}
            torch.cuda.synchronize()
            report[f"{dtype} S{S}"] = {
                "ring_slots": slots,
                "logits_max_abs_err": err,
                "tolerance": SERVE_PARITY_TOL[dtype],
                "greedy_tokens_equal": tokens[None] == tokens[False],
                "tokens_kernel": tokens[None][0][:8],
                "tokens_plain": tokens[False][0][:8]}
            if not err <= SERVE_PARITY_TOL[dtype]:
                raise AssertionError(f"legacy_parity {dtype} S={S}: "
                                     f"decode-step logits differ by {err}")
            if dtype == torch.float32 and tokens[None] != tokens[False]:
                raise AssertionError(f"legacy_parity fp32 S={S}: greedy "
                                     "tokens differ between the kernel and "
                                     "the plain version")
            del logits
        del params
        torch.cuda.empty_cache()
    report["flash_vs_direct"] = check_flash_vs_direct()
    emit("legacy_parity", n_layers=2, d_model=arch.cfg.d_model, batch=2,
         prompt_lens=list(LEGACY_PARITY_LENS), max_new_tokens=16, **report)


FLASH_CHECK = dict(S=4096, Kh=8, G=4, dh=80)    # B = 1, danube's heads


def check_flash_vs_direct() -> dict:
    """fp32, B = 1, S = 4096, danube's heads (8 KV x 4, dh 80) and window:
    the flash branch's value and gradients against direct attention's
    autograd, at the reference flash-VJP test's tolerances (the scalar
    rtol 5e-5; gradients rtol 1e-4, atol 1e-5)."""
    S, Kh, G, dh = (FLASH_CHECK[k] for k in ("S", "Kh", "G", "dh"))
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    base = [torch.randn(shape, generator=g, device=DEV)
            for shape in ((1, S, Kh, G, dh), (1, S, Kh, dh), (1, S, Kh, dh))]
    pos = torch.arange(S, dtype=torch.int32, device=DEV)
    spec = ML.MaskSpec(causal=True, window=SERVE_WINDOW)
    results = []
    for impl in ("flash", "direct"):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        if impl == "flash":
            o = ML._flash_attention(q, k, v, pos, pos, spec, dh ** -0.5,
                                    ML._Q_BLOCK, ML._KV_BLOCK)
        else:
            mask = ML._mask_block(pos, pos, spec)[None, None, None]
            o = ML._direct_attention(q, k, v, mask, dh ** -0.5)
        val = torch.sum(o * torch.cos(o))
        results.append((val.detach(), torch.autograd.grad(val, (q, k, v))))
        del o, val
        torch.cuda.empty_cache()
    (v1, g1), (v2, g2) = results
    out = {"value_flash": float(v1), "value_direct": float(v2)}
    if not abs(float(v1) - float(v2)) <= 5e-5 * abs(float(v2)):
        raise AssertionError(f"legacy_parity: flash value {float(v1)} vs "
                             f"direct {float(v2)}")
    for a, b, name in zip(g1, g2, "qkv"):
        assert_close(a, b, rtol=1e-4, atol=1e-5,
                     what=f"legacy_parity flash d{name}")
        out[f"d{name}_max_abs_err"] = max_err(a, b)
    return out


# --------------------------------------------------------------------------
# moe: deepseek-moe-16b at its published width and depth
# --------------------------------------------------------------------------

MOE_ID = "deepseek-moe-16b"
MOE_STEPS = 3
# 11 factored leaves a layer (wq, wk, wv, wo, the fp32 router, the expert
# stacks w_gate, w_up, w_down, the shared experts' three) x 28, embed, head
MOE_LEAVES_PER_STEP = 310
MOE_PARITY_LAYERS = 2
DIGEST_CHUNK = 1 << 24


def factored_leaves(params) -> int:
    """Tensors a fused AdaLomo step hands to K1 and K2 (each once): a layer
    slice of every stacked matrix or expert stack, each outer and shared
    matrix — those whose last two dims are both at least the rule's
    ``min_dim_size_to_factor`` (mamba2's [C, 4] conv weights stay plain)."""
    def big(t):
        return min(t.shape[-2:]) >= CFG.min_dim_size_to_factor

    n = sum(t.shape[0] for t in tree_leaves(params["stacks"])
            if t.ndim >= 3 and big(t))
    return n + sum(1 for k in ("outer", "shared")
                   for t in tree_leaves(params[k]) if t.ndim >= 2 and big(t))


def device_digest(tree) -> torch.Tensor:
    """Two int64 sums a leaf of its raw bits, plain and weighted by position,
    computed on the card in pieces (no host sync, no second copy of the
    model): bitwise-equal trees give equal digests, a changed bit changes
    them."""
    from repro_torch.core.tree import pytree_leaves
    out = []
    for t in pytree_leaves(tree):
        bits = t.detach().reshape(-1).view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[t.element_size()])
        s1 = torch.zeros((), dtype=torch.int64, device=t.device)
        s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), DIGEST_CHUNK):
            piece = bits[i:i + DIGEST_CHUNK].to(torch.int64)
            w = torch.arange(i, i + piece.numel(), device=t.device) % 1000003
            s1 += piece.sum()
            s2 += (piece * (w + 1)).sum()
        out += [s1, s2]
    return torch.stack(out)


def moe_watch(digest_at: int):
    """A user hook: each step's aux loss (the metrics' ``aux_loss``) where
    the model has one and MTP loss where the model has the head
    (``mtp_loss``), the bytes allocated
    when the run starts (params and state), and the digest of params and
    OptState after step ``digest_at`` and whether every param is finite
    then (``finite``)."""
    from repro_torch.run import Hook

    class Watch(Hook):
        def __init__(self):
            self.aux, self.digest, self.start_bytes = [], None, None
            self.mtp, self.finite = [], None

        def on_run_start(self, ctx):
            self.start_bytes = torch.cuda.memory_allocated()

        def on_step_end(self, ctx, ev):
            if "aux_loss" in ev.metrics:
                self.aux.append(ev.metrics["aux_loss"])
            if "mtp_loss" in ev.metrics:
                self.mtp.append(ev.metrics["mtp_loss"])
            if ev.step == digest_at:
                # an asynchronous copy into pinned host memory: no host
                # sync inside the run, and nothing left on the card
                self.digest = device_digest(
                    (ctx.params, ctx.opt_state)).to("cpu", non_blocking=True)
                self.finite = finite_flag(ctx.params).to("cpu",
                                                         non_blocking=True)

    return Watch()


def reckoned_bytes(arch_id: str) -> dict:
    """Table 1's unfused rules on ``arch_id``, reckoned, not run: the dry
    run's resting bytes of each (params and optimizer state, traced at
    full depth on the meta device, ``launch/dryrun.py``) and one gradient
    a parameter in its dtype (all alive at once)."""
    from repro_torch.launch import dryrun as D
    arch = get_arch(arch_id)
    params = tree_bytes(arch.init_params(0, device="meta"))
    out = {}
    for name in ("adamw", "adafactor"):
        spec = RunSpec(model=ModelSpec(arch_id, smoke=False),
                       data=DataConfig(vocab=0, seq_len=1024, global_batch=1),
                       opt=OptSpec(name=name),
                       steps=StepSpec(total=1, fused=False))
        resting = D.trace_train(spec, arch=arch, steps=0).resting_bytes
        out[name] = {"param_bytes": params, "grad_bytes": params,
                     "state_bytes": resting - params,
                     "total_bytes": resting + params}
    return out


def phase_moe() -> dict:
    """deepseek-moe-16b at its published width and depth: fused AdaLomo
    through ``run(spec)`` (the Table-1 line beside fused LOMO and the
    reckoned unfused rules), then paged serving through K3 and its parity
    with the plain attention."""
    t0 = time.perf_counter()
    base = held_bytes()
    arch = get_arch(MOE_ID)
    meta = arch.init_params(0, device="meta")
    leaves = factored_leaves(meta)
    if leaves != MOE_LEAVES_PER_STEP:
        raise AssertionError(f"moe: {leaves} factored leaves a step, "
                             f"expected {MOE_LEAVES_PER_STEP}")
    failed = []
    watch = moe_watch(0)
    progress("moe: fused AdaLomo, 3 steps")
    rec = baseline_arm("adalomo", True, base, arch_id=MOE_ID,
                       steps=MOE_STEPS, hooks=[watch])
    rec.update(aux_losses=watch.aux, allocated_at_run_start_bytes=(
        watch.start_bytes))
    digest = watch.digest
    rerun_watch = moe_watch(0)
    progress("moe: step 1 re-run, then LOMO")
    rerun = baseline_arm("adalomo", True, base, arch_id=MOE_ID, steps=1,
                         hooks=[rerun_watch])
    rerun_bitwise = (rerun["losses"][0] == rec["losses"][0]
                     and torch.equal(rerun_watch.digest, digest))
    lomo = baseline_arm("lomo", True, base, arch_id=MOE_ID, steps=1)
    losses = rec["losses"]
    want = {"adalomo_stats": MOE_LEAVES_PER_STEP * MOE_STEPS,
            "adalomo_update": MOE_LEAVES_PER_STEP * MOE_STEPS}
    if len(losses) != MOE_STEPS or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif losses[-1] == losses[0]:
        failed.append(f"losses do not move: {losses}")
    if rec["launches"] != want:
        failed.append(f"K1/K2 launches {rec['launches']}, expected {want}")
    if rec["host_syncs"] != MOE_STEPS:
        failed.append(f"{rec['host_syncs']} host syncs in {MOE_STEPS} steps")
    if not rec["params_finite"]:
        failed.append("a parameter is not finite")
    if len(watch.aux) != MOE_STEPS or not all(
            math.isfinite(a) and a > 0 for a in watch.aux):
        failed.append(f"aux losses {watch.aux}")
    if not rerun_bitwise:
        failed.append("step 1 re-run from the same seed is not bitwise equal")
    if lomo["launches"] != dict.fromkeys(want, 0) or not all(
            map(math.isfinite, lomo["losses"])):
        failed.append(f"lomo: {lomo['launches']} {lomo['losses']}")
    for r in (rec, rerun, lomo):
        if r["allocated_after_free_bytes"] != base:
            failed.append(f"{r['optimizer']}: "
                          f"{r['allocated_after_free_bytes']} bytes held "
                          f"after the run, {base} before")
    emit("moe_train", arch=MOE_ID, n_layers=arch.cfg.n_layers,
         active_params=arch.cfg.active_param_count(),
         factored_leaves_per_step=leaves, adalomo=rec,
         rerun_step1={"losses": rerun["losses"], "bitwise": rerun_bitwise,
                      "step_seconds": rerun["step_seconds"]},
         lomo=lomo, reckoned_unfused=reckoned_bytes(MOE_ID),
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"moe train: {failed}")

    t0 = time.perf_counter()
    progress("moe: paged serving")
    params = arch.init_params(0)
    serve, launches = paged_serve_run(arch, params, SERVE_CFG,
                                      SERVE_REQUESTS, SERVE_PROMPT_LENS)
    del params
    emit("moe_serve", arch=MOE_ID, **serve, seconds=time.perf_counter() - t0,
         held_after_bytes=held_bytes(), held_before_bytes=base)
    rng = np.random.default_rng(11)
    progress("moe: serve parity at 2 layers")
    parity = {str(dt): paged_parity(MOE_ID, dt, rng, SERVE_PARITY_PROMPT_LENS,
                                    n_layers=MOE_PARITY_LAYERS,
                                    check_bf16_logits=False)
              for dt in (torch.float32, torch.bfloat16)}
    emit("moe_serve_parity", arch=MOE_ID, n_layers=MOE_PARITY_LAYERS,
         prompt_lens=list(SERVE_PARITY_PROMPT_LENS), max_new_tokens=16,
         **parity)
    return {"launches": {"adalomo_stats": rec["launches"]["adalomo_stats"],
                         "adalomo_update": rec["launches"]["adalomo_update"],
                         "paged_decode_attention": launches}}


# --------------------------------------------------------------------------
# configs: the other dense transformer configs at full width
# --------------------------------------------------------------------------

# arch: (batch, seq) of its one fused AdaLomo step at full width and depth;
# qwen3-32b's 65.5 GB of bf16 weights leave room for one row of 1024
CONFIG_TRAIN = {"stablelm-12b": (4, 1024), "h2o-danube-3-4b": (4, 1024),
                "qwen3-32b": (1, 1024)}
# K1/K2 launches of one fused AdaLomo step: 7 factored leaves a layer
CONFIG_LAUNCHES = {"stablelm-12b": 282, "h2o-danube-3-4b": 170,
                   "qwen3-32b": 450}
# the two new head dims: stablelm-12b's 160, h2o-danube-3-4b's 120
CONFIG_SERVE = ("stablelm-12b", "h2o-danube-3-4b")
CONFIG_SERVE_CFG = dict(page_size=16, max_batch=8, max_pages_per_seq=64,
                        num_pages=513, chunk=8, max_new_tokens=16)
CONFIG_PROMPT_LENS = (32, 1000)
CONFIG_LEGACY = dict(batch=2, prompt_len=1024, new_tokens=16)


def legacy_parity(arch_id: str, prompt_len: int, rng) -> dict:
    """fp32 at full width and 2 layers: one decode step's logits through K4
    against the plain version over the same cache (1e-3), and greedy
    tokens of Engine (asserted equal)."""
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=2, dtype=torch.float32))
    params = arch.init_params(0)
    toks = torch.from_numpy(rng.integers(
        1, arch.cfg.vocab, (2, prompt_len)).astype(np.int32)).to(DEV)
    logits0, cache = arch.make_prefill_step()(params, {"tokens": toks})
    nxt = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
    logits = {}
    for use_kernel in (None, False):
        c = {k: v.clone() for k, v in cache.items()}
        logits[use_kernel] = arch.make_decode_step(use_kernel=use_kernel)(
            params, c, {"tokens": nxt})[0]
    err = max_err(logits[None], logits[False])
    prompts = toks.cpu().tolist()
    tokens = {u: Engine(arch, params, ServeConfig(
        max_new_tokens=16, use_kernel=u)).generate(prompts)
        for u in (None, False)}
    torch.cuda.synchronize()
    out = {"logits_max_abs_err": err,
           "tolerance": SERVE_PARITY_TOL[torch.float32],
           "greedy_tokens_equal": tokens[None] == tokens[False],
           "tokens_kernel": tokens[None][0][:8]}
    if not err <= SERVE_PARITY_TOL[torch.float32]:
        raise AssertionError(f"legacy parity {arch_id}: decode-step logits "
                             f"differ by {err}")
    if tokens[None] != tokens[False]:
        raise AssertionError(f"legacy parity {arch_id}: greedy tokens differ "
                             "between K4 and the plain version")
    del params, cache, c
    torch.cuda.empty_cache()
    return out


def phase_configs() -> dict:
    """qwen3-32b, stablelm-12b and h2o-danube-3-4b at their published
    widths and depths.  For the two new head dims (stablelm-12b's 160,
    danube-3's 120): paged serving through K3 and legacy serving through K4
    with their token checks, and fp32 greedy tokens through each kernel
    against the plain attention at 2 layers.  Then one fused AdaLomo step
    each through ``run(spec)``, qwen3-32b (the one that needs most of the
    card) last."""
    base = held_bytes()
    launches = dict.fromkeys(("adalomo_stats", "adalomo_update",
                              "paged_decode_attention", "decode_attention"),
                             0)
    rng = np.random.default_rng(12)
    for arch_id in CONFIG_SERVE:
        progress(f"configs: serving {arch_id}")
        t0 = time.perf_counter()
        arch = get_arch(arch_id)
        params = arch.init_params(0)
        paged, n3 = paged_serve_run(arch, params, CONFIG_SERVE_CFG, 8,
                                    CONFIG_PROMPT_LENS)
        legacy, n4, _ = legacy_serve_run(arch, params, **CONFIG_LEGACY)
        del params
        launches["paged_decode_attention"] += n3
        launches["decode_attention"] += n4
        emit("configs_serve", arch=arch_id, head_dim=arch.cfg.head_dim,
             paged=paged, legacy=legacy,
             paged_parity_fp32=paged_parity(arch_id, torch.float32, rng,
                                            SERVE_PARITY_PROMPT_LENS),
             legacy_parity_fp32=legacy_parity(arch_id, 1024, rng),
             seconds=time.perf_counter() - t0)
    held_after_serving = held_bytes()
    failed = []
    for arch_id in CONFIG_TRAIN:
        rec, bad = config_step(arch_id, "adalomo", base, held_after_serving)
        failed += bad
        for k in ("adalomo_stats", "adalomo_update"):
            launches[k] += rec["launches"][k]
    if failed:
        raise AssertionError(f"configs train: {failed}")
    return {"launches": launches}


def config_step(arch_id: str, opt: str, base: int, held: int) -> tuple:
    """One fused ``opt`` step of ``arch_id`` at full width and depth
    through ``baseline_arm`` (``held``: the bytes the card holds before
    it): its record, emitted and returned, and its failures."""
    batch, seq = CONFIG_TRAIN[arch_id]
    progress(f"configs: one fused {opt} step of {arch_id}")
    t0 = time.perf_counter()
    leaves = factored_leaves(get_arch(arch_id).init_params(0, device="meta"))
    rec = baseline_arm(opt, True, held, arch_id=arch_id, steps=1,
                       batch=batch, seq=seq)
    emit("configs_train", factored_leaves_per_step=leaves,
         held_before_phase_bytes=base, seconds=time.perf_counter() - t0,
         reckoned_unfused=reckoned_bytes(arch_id), **rec)
    want = dict.fromkeys(("adalomo_stats", "adalomo_update"),
                         CONFIG_LAUNCHES[arch_id] if opt == "adalomo" else 0)
    what = f"{arch_id} {opt}"
    failed = []
    if len(rec["losses"]) != 1 or not all(map(math.isfinite,
                                              rec["losses"])):
        failed.append(f"{what}: losses {rec['losses']}")
    if leaves != CONFIG_LAUNCHES[arch_id] or rec["launches"] != want:
        failed.append(f"{what}: {leaves} factored leaves, K1/K2 launches "
                      f"{rec['launches']}, expected {want}")
    if rec["host_syncs"] != 1 or not rec["params_finite"]:
        failed.append(f"{what}: {rec['host_syncs']} host syncs, params "
                      f"finite {rec['params_finite']}")
    if rec["allocated_after_free_bytes"] != held:
        failed.append(f"{what}: memory held after the run")
    return rec, failed


def phase_configs_lomo() -> None:
    """Table 1's fused LOMO step on qwen3-32b at full depth, 1 x 1024 (not
    in the default run, to keep it short); the SGD update works in pieces
    of 2**24 elements, so its peak is about fused AdaLomo's."""
    base = held_bytes()
    failed = config_step("qwen3-32b", "lomo", base, base)[1]
    if failed:
        raise AssertionError(f"configs_lomo: {failed}")


# --------------------------------------------------------------------------
# mla: deepseek-v3-671b (MLA, MTP, 256 experts) at its published widths
# --------------------------------------------------------------------------

MLA_ID = "deepseek-v3-671b"
MLA_STEPS = 3
# Depth is the one cut.  At 1 layer the params are 13,694,580,736 (27.4 GB
# in bf16) and one MoE layer's gradients 23.0 GB; at 2 layers the params
# alone are 50.4 GB and the fused step does not fit in the card.
MLA_TRAIN_LAYERS = 1
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ = 1, 1024
# K1/K2 launches of one fused step: 14 factored leaves a layer (w_dq, w_uq,
# w_dkv, w_kr, w_uk, w_uv, wo; the fp32 router; the expert stacks w_gate,
# w_up, w_down; the shared expert's three) and 13 in outer (tok_embed,
# head, mtp_proj; the MTP block's 7 MLA and 3 MLP matrices)
MLA_LEAVES_PER_LAYER, MLA_OUTER_LEAVES = 14, 13
MLA_LOMO_PEAK_RTOL = 0.01
MLA_SERVE_LAYERS = 2                    # 50.4 GB of bf16 weights
MLA_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
# fp32 parity at 1 layer (54.8 GB): 2 prompts of 16 tokens, 8 greedy tokens
MLA_PARITY_LAYERS = 1
MLA_PARITY_B, MLA_PARITY_S, MLA_PARITY_NEW = 2, 16, 8
MLA_PARITY_TOL = 1e-3
# K1/K2 on whole expert batches of 256 [m, n] matrices, held against their
# plain versions on entries 0, 1, 254 and 255; entry 255 of [256, 7168,
# 2048] starts at element 3,743,416,320, past 2**31
MLA_EXPERTS = 256
MLA_KERNEL_SHAPES = ((7168, 2048), (2048, 7168))
MLA_CHECK_ENTRIES = (0, 1, 254, 255)


def with_layers(arch, n_layers: int, **cfg_changes):
    """``arch`` at its published widths with the depth cut (and any other
    config field changed)."""
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=n_layers, **cfg_changes))


def expert_batch_inputs(shape, seed: int) -> tuple:
    """bf16 params and grads ``[256, m, n]`` drawn 16 matrices at a time
    (no fp32 copy of a whole 7.5 GB batch), fp32 r and c as a later step
    holds them."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    full = (MLA_EXPERTS,) + tuple(shape)
    p = torch.empty(full, dtype=torch.bfloat16, device=DEV)
    g = torch.empty_like(p)
    for t, std in ((p, 0.1), (g, 0.3)):
        for part in t.split(16):
            part.copy_(torch.randn(part.shape, generator=gen, device=DEV)
                       * std)
    r = torch.rand(full[:-1], generator=gen, device=DEV) * 1e-2
    c = torch.rand(full[:-2] + full[-1:], generator=gen, device=DEV) * 1e-2
    return p, g, r, c


def check_expert_batches(errs: dict) -> dict:
    """K1 then K2 (step 5, bf16 params and grads, as the fused step hands
    an expert stack over) on each whole ``[256, m, n]`` batch, held against
    the plain versions on ``MLA_CHECK_ENTRIES``: K1's r' and c' within
    ``TOL_RC``, K2's update (at ``K2_HELD_LR``, on the r', c' K1 wrote) by
    ``held_update``; the same inputs again, bitwise; then each kernel timed
    on the whole batch (CUDA events: a batch is far past the L2 cache)
    beside its bound, and the plain versions on the four entries."""
    beta, lr, step = 0.999, K2_HELD_LR, 5.0
    beta_t = torch.full((), beta, device=DEV)
    kw2 = dict(eps_div=CFG.eps_div, eps_rms=CFG.eps_rms, literal=False)
    sel = torch.tensor(MLA_CHECK_ENTRIES, device=DEV)
    rows = {}
    for shape in MLA_KERNEL_SHAPES:
        name = f"experts [{MLA_EXPERTS},{shape[0]},{shape[1]}]"
        first = None
        for rep in range(2):
            p, g, r, c = expert_batch_inputs(shape, seed=shape[0])
            p0, r0, c0 = p[sel], r[sel], c[sel]          # copies
            K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
            scal = scal_for(r, lr, step, beta, 0.0, 1.0)
            K.adalomo_update(p, g, r, c, scal, **kw2)
            if first is None:
                g4 = g[sel]
                want_r, want_c = K.adalomo_stats_ref(
                    g4, r0, c0, beta_t, eps_stat=CFG.eps_stat)
                assert_close(r[sel], want_r, what=f"adalomo_stats r {name}",
                             **TOL_RC)
                assert_close(c[sel], want_c, what=f"adalomo_stats c {name}",
                             **TOL_RC)
                want_p = K.adalomo_update_ref(
                    p0.to(torch.float32), g4, r[sel], c[sel], scal[sel],
                    **kw2)
                update = held_update(p0, p[sel], want_p,
                                     f"adalomo_update {name}")
                err = {"adalomo_stats": max(max_err(r[sel], want_r),
                                            max_err(c[sel], want_c)),
                       "adalomo_update": max_err(p[sel], want_p)}
                for k, v in err.items():
                    errs[k] = max(errs[k], v)
                first = (p, r, c)
                del g, g4, want_r, want_c, want_p
                continue
            bitwise = all(torch.equal(a, b) for a, b in zip(first, (p, r, c)))
            if not bitwise:
                raise AssertionError(f"K1/K2 on {name}: the same inputs did "
                                     "not give bit-identical outputs")
        del first
        L, (m, n) = MLA_EXPERTS, shape
        g4, r4, c4, p4, s4 = g[sel], r[sel], c[sel], p[sel], scal[sel]
        one = (p, g, r, c, scal)
        row = {"entries_checked": list(MLA_CHECK_ENTRIES),
               "max_abs_err": err, "update": update,
               "rerun_bitwise": bitwise,
               "stats_ms": time_ms(
                   lambda p, g, r, c, s: K.adalomo_stats(
                       g, r, c, beta_t, eps_stat=CFG.eps_stat), [one], 5),
               "update_ms": time_ms(
                   lambda p, g, r, c, s: K.adalomo_update(p, g, r, c, s,
                                                          **kw2), [one], 5),
               "stats_plain_ms_4_entries": time_ms(
                   lambda: K.adalomo_stats_ref(g4, r4, c4, beta_t,
                                               eps_stat=CFG.eps_stat),
                   [()], 3),
               "update_plain_ms_4_entries": time_ms(
                   lambda: K.adalomo_update_ref(p4, g4, r4, c4, s4, **kw2),
                   [()], 3)}
        state_bytes = 4 * L * (m + n)
        for key, nbytes, flop in (
                ("stats", L * m * n * 2 + 2 * state_bytes, K1_FLOP_PER_ELEM),
                ("update", 3 * L * m * n * 2 + state_bytes + 16 * L,
                 K2_FLOP_PER_ELEM)):
            row[key + "_bound_ms"] = max(
                nbytes / HBM_BYTES_PER_S,
                flop * L * m * n / FP32_FLOP_PER_S) * 1e3
        rows[name] = row
        del p, g, r, c, scal, one, g4, r4, c4, p4, s4
        torch.cuda.empty_cache()
    return rows


def mla_parity() -> dict:
    """fp32 at full width and 1 layer: one decode step's logits from the
    absorbed latent path (the ring of the prompt's 16 slots, so the step
    overwrites position 0) against the last-position logits of a prefill
    over the same tokens plus one with a window of 16 (the positions that
    ring holds), within 1e-3; then Engine's greedy tokens equal to a plain
    loop that recomputes the whole sequence each token.  Both sides at a
    capacity factor of 32 (experts / top-k: no token is ever dropped),
    since a prefill drops by capacity where a one-token decode cannot."""
    B, S, new = MLA_PARITY_B, MLA_PARITY_S, MLA_PARITY_NEW
    arch = get_arch(MLA_ID)
    moe = arch.cfg.moe
    arch = with_layers(arch, MLA_PARITY_LAYERS, dtype=torch.float32,
                       window=S, moe=dataclasses.replace(
                           moe, capacity_factor=moe.n_routed / moe.top_k))
    params = arch.init_params(0)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(
        1, arch.cfg.vocab, (B, S + 1)).astype(np.int32)).to(DEV)
    prefill = arch.make_prefill_step()
    _, cache = prefill(params, {"tokens": toks[:, :S]})
    ring_slots = int(cache["ckv"].shape[2])
    dec = arch.make_decode_step()(params, cache, {"tokens": toks[:, S:]})[0]
    full = prefill(params, {"tokens": toks})[0]
    err = max_err(dec, full)
    tokens = Engine(arch, params, ServeConfig(max_new_tokens=new)).generate(
        toks[:, :S].cpu().tolist())
    seq, plain = toks[:, :S], []
    for _ in range(new):
        nxt = torch.argmax(prefill(params, {"tokens": seq})[0],
                           dim=-1).to(torch.int32)
        plain.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    plain = torch.stack(plain, dim=1).cpu().tolist()
    torch.cuda.synchronize()
    out = {"n_layers": MLA_PARITY_LAYERS, "dtype": "float32", "batch": B,
           "prompt_len": S, "ring_slots": ring_slots,
           "capacity_factor": arch.cfg.moe.capacity_factor,
           "decode_vs_prefill_logits_max_abs_err": err,
           "tolerance": MLA_PARITY_TOL, "greedy_tokens_equal": tokens == plain,
           "tokens_engine": tokens[0], "tokens_recompute": plain[0]}
    del params, cache
    torch.cuda.empty_cache()
    if not err <= MLA_PARITY_TOL:
        raise AssertionError(f"mla parity: decode-step logits differ from "
                             f"the prefill's by {err}")
    if tokens != plain:
        raise AssertionError(f"mla parity: Engine's greedy tokens {tokens} "
                             f"differ from the recompute loop's {plain}")
    return out


def phase_mla() -> dict:
    """deepseek-v3-671b at its published widths, depth cut: K1/K2 on its
    expert batches; fused AdaLomo (and fused LOMO beside it) through
    ``run(spec)`` at 1 layer; the legacy Engine serving from the latent
    cache at 2 layers; fp32 parity of the latent decode at 1 layer."""
    t0 = time.perf_counter()
    base = held_bytes()
    errs = {"adalomo_stats": 0.0, "adalomo_update": 0.0}
    progress("mla: K1/K2 on the [256, m, n] expert batches")
    kernels = check_expert_batches(errs)
    emit("mla_kernels", arch=MLA_ID, dtype="bf16 param, bf16 grad",
         tolerances={"r_c": TOL_RC, "k2_lr": K2_HELD_LR,
                     "k2_update_rtol": K2_HELD_UPDATE_RTOL,
                     "k2_moved_min": K2_HELD_MOVED_MIN},
         per_call=kernels, max_abs_err=errs,
         held_after_bytes=held_bytes(), held_before_bytes=base,
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    arch = with_layers(get_arch(MLA_ID), MLA_TRAIN_LAYERS)
    leaves = factored_leaves(arch.init_params(0, device="meta"))
    want_leaves = MLA_LEAVES_PER_LAYER * MLA_TRAIN_LAYERS + MLA_OUTER_LEAVES
    failed = []
    if leaves != want_leaves:
        failed.append(f"{leaves} factored leaves a step, expected "
                      f"{want_leaves}")
    kw = dict(arch_id=MLA_ID, batch=MLA_TRAIN_BATCH, seq=MLA_TRAIN_SEQ,
              n_layers=MLA_TRAIN_LAYERS)
    watch = moe_watch(0)
    progress(f"mla: fused AdaLomo, {MLA_STEPS} steps at 1 layer")
    rec = baseline_arm("adalomo", True, base, steps=MLA_STEPS,
                       hooks=[watch], **kw)
    rec.update(aux_losses=watch.aux, mtp_losses=watch.mtp,
               allocated_at_run_start_bytes=watch.start_bytes)
    rerun_watch = moe_watch(0)
    progress("mla: step 1 re-run, then LOMO")
    rerun = baseline_arm("adalomo", True, base, steps=1,
                         hooks=[rerun_watch], **kw)
    rerun_bitwise = (rerun["losses"][0] == rec["losses"][0]
                     and torch.equal(rerun_watch.digest, watch.digest))
    lomo = baseline_arm("lomo", True, base, steps=1, **kw)
    losses = rec["losses"]
    want = dict.fromkeys(("adalomo_stats", "adalomo_update"),
                         want_leaves * MLA_STEPS)
    if len(losses) != MLA_STEPS or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif losses[-1] == losses[0]:
        failed.append(f"losses do not move: {losses}")
    if rec["launches"] != want:
        failed.append(f"K1/K2 launches {rec['launches']}, expected {want}")
    if rec["host_syncs"] != MLA_STEPS:
        failed.append(f"{rec['host_syncs']} host syncs in {MLA_STEPS} steps")
    if not rec["params_finite"]:
        failed.append("a parameter is not finite")
    for what, vals in (("aux", watch.aux), ("mtp", watch.mtp)):
        if len(vals) != MLA_STEPS or not all(
                math.isfinite(a) and a > 0 for a in vals):
            failed.append(f"{what} losses {vals}")
    if not rerun_bitwise:
        failed.append("step 1 re-run from the same seed is not bitwise equal")
    if lomo["launches"] != dict.fromkeys(want, 0) or not all(
            map(math.isfinite, lomo["losses"])):
        failed.append(f"lomo: {lomo['launches']} {lomo['losses']}")
    lomo_gap = (lomo["peak_memory_bytes"] / rec["peak_memory_bytes"]) - 1.0
    if abs(lomo_gap) > MLA_LOMO_PEAK_RTOL:
        failed.append(f"LOMO's peak is {lomo_gap:+.2%} of AdaLomo's")
    for r in (rec, rerun, lomo):
        if r["allocated_after_free_bytes"] != base:
            failed.append(f"{r['optimizer']}: "
                          f"{r['allocated_after_free_bytes']} bytes held "
                          f"after the run, {base} before")
    emit("mla_train", arch=MLA_ID, cut={"n_layers": [61, MLA_TRAIN_LAYERS],
                                        "batch": MLA_TRAIN_BATCH,
                                        "seq": MLA_TRAIN_SEQ,
                                        "steps": MLA_STEPS},
         factored_leaves_per_step=leaves, adalomo=rec,
         rerun_step1={"losses": rerun["losses"], "bitwise": rerun_bitwise,
                      "step_seconds": rerun["step_seconds"]},
         lomo=lomo, lomo_peak_vs_adalomo=lomo_gap,
         reckoned_unfused_full_depth=reckoned_bytes(MLA_ID),
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"mla train: {failed}")

    t0 = time.perf_counter()
    progress(f"mla: Engine from the latent cache at {MLA_SERVE_LAYERS} "
             "layers")
    arch = with_layers(get_arch(MLA_ID), MLA_SERVE_LAYERS)
    params = arch.init_params(0)
    try:
        PagedEngine(arch, params, PagedServeConfig(**SERVE_CFG))
    except ValueError as e:
        paged_refusal = str(e)
    else:
        raise AssertionError("mla serve: PagedEngine accepted an MLA model")
    report, launches, _ = legacy_serve_run(arch, params, **MLA_SERVE)
    del params
    emit("mla_serve", arch=MLA_ID, cut={"n_layers": [61, MLA_SERVE_LAYERS]},
         cache="latent ckv [L,B,W,512] + kr [L,B,W,64]",
         paged_refusal=paged_refusal, **report,
         held_after_bytes=held_bytes(), held_before_bytes=base,
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    progress("mla: fp32 parity of the latent decode at 1 layer")
    emit("mla_parity", arch=MLA_ID, **mla_parity(),
         seconds=time.perf_counter() - t0)
    return {"launches": {"adalomo_stats": rec["launches"]["adalomo_stats"],
                         "adalomo_update": rec["launches"]["adalomo_update"],
                         "decode_attention": launches},
            "per_call": kernels, "errs": errs}


# --------------------------------------------------------------------------
# prefix: paligemma-3b (prefix-LM over a stubbed modality prefix)
# --------------------------------------------------------------------------

PALI_ID = "paligemma-3b"
PREFIX_STEPS = 3
# rows x text tokens; each row adds the 256 prefix embeddings: 4 x 1,280
# positions take the direct branch, 1 x 2,304 the flash branch
PREFIX_TRAIN = (4, 1024)
PREFIX_FLASH = (1, 2048)
# K1/K2 launches of one fused step: 7 matrices a layer (wq, wk, wv, wo,
# w_gate, w_up, w_down) x 18, and the tied embedding
PREFIX_LEAVES_PER_STEP = 18 * 7 + 1
PREFIX_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
# fp32 at full depth: K4 (its fp32 tile loop at dh 256) against the plain
# attention, a decode step's logits within 1e-3 and greedy tokens equal
PREFIX_PARITY = dict(batch=2, prompt_len=256, new_tokens=16)
PREFIX_PARITY_TOL = 1e-3
# bf16 at the serving shape: one decode step's logits through K4 against the
# plain attention's, within 4x the 0.038 first read on the card; and K4 must
# move them less than bf16 itself does (the plain attention in bf16 against
# an fp32 copy of the same weights)
PREFIX_BF16_LOGITS_TOL = 0.15


def prefix_extras(cfg, batch: int, seed: int) -> dict:
    """A modality prefix's inputs as the data layer draws them: seeded
    normal ``prefix_embed [B, n_prefix_tokens, d_model]`` (float32) and
    ``prefix_len`` = n_prefix_tokens a row."""
    rng = np.random.default_rng(seed)
    n = cfg.n_prefix_tokens
    return {"prefix_embed": rng.standard_normal((batch, n, cfg.d_model),
                                                dtype=np.float32),
            "prefix_len": np.full((batch,), n, np.int32)}


class FlashCount:
    """Counts, while active, the dispatcher's calls of the flash branch with
    a gradient asked for (they take the recomputing backward) and without,
    and the runs of that backward."""

    def __enter__(self):
        self.counts = {"with_grad": 0, "no_grad": 0, "backward": 0}
        self._fa, self._bw = ML._flash_attention, ML._FlashAttention.backward

        def fa(q, *args, **kw):
            grad = torch.is_grad_enabled() and q.requires_grad
            self.counts["with_grad" if grad else "no_grad"] += 1
            return self._fa(q, *args, **kw)

        def bw(ctx, *grads):
            self.counts["backward"] += 1
            return self._bw(ctx, *grads)

        ML._flash_attention = fa
        ML._FlashAttention.backward = staticmethod(bw)
        return self

    def __exit__(self, *exc):
        ML._flash_attention = self._fa
        ML._FlashAttention.backward = staticmethod(self._bw)


def prefix_parity(rng) -> dict:
    """fp32 at full width and depth: after a prefill of 256 prefix
    embeddings and 256 tokens, one decode step's logits through K4 (the
    fp32 tile loop at dh 256, group 8) against the plain attention over the
    same ring (``PREFIX_PARITY_TOL``), and Engine's greedy tokens through
    each (asserted equal)."""
    cfg = PREFIX_PARITY
    arch = get_arch(PALI_ID)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype=torch.float32))
    params = arch.init_params(0)
    B, S = cfg["batch"], cfg["prompt_len"]
    extras = prefix_extras(arch.cfg, B, seed=23)
    toks = rng.integers(1, arch.cfg.vocab, (B, S)).astype(np.int32)
    logits, slots = decode_step_both(arch, params,
                                     dict(extras, tokens=toks))
    err = max_err(logits[None], logits[False])
    tokens = {u: Engine(arch, params, ServeConfig(
        max_new_tokens=cfg["new_tokens"], use_kernel=u)).generate(
            toks.tolist(), extras=extras) for u in (None, False)}
    torch.cuda.synchronize()
    out = {"dtype": "float32", "n_layers": arch.cfg.n_layers, **cfg,
           "ring_slots": slots,
           "decode_logits_max_abs_err": err, "tolerance": PREFIX_PARITY_TOL,
           "greedy_tokens_equal": tokens[None] == tokens[False],
           "tokens_kernel": tokens[None][0], "tokens_plain": tokens[False][0]}
    del params, logits
    torch.cuda.empty_cache()
    if not err <= PREFIX_PARITY_TOL:
        raise AssertionError(f"prefix parity: decode-step logits through K4 "
                             f"differ from the plain attention's by {err}")
    if tokens[None] != tokens[False]:
        raise AssertionError("prefix parity: fp32 greedy tokens differ "
                             "between K4 and the plain attention")
    return out


def phase_prefix() -> dict:
    """paligemma-3b at its published width and depth (18 layers, d_model
    2048, 8 query heads over 1 at dh 256, a tied 257,216-token head, 256
    prefix embeddings), bf16, random weights and data from a seed: fused
    AdaLomo through ``run(spec)`` at 4 x (1024 + 256) (the direct branch),
    3 steps, step 1 re-run bitwise; one step at 1 x (2048 + 256) (the flash
    branch, forward and recomputing backward, with the prefix mask); fused
    LOMO's step for Table 1; the legacy Engine through K4 at dh 256 with a
    bitwise re-run, beside the plain attention; PagedEngine refusing; fp32
    parity of K4 at full depth."""
    t0 = time.perf_counter()
    base = held_bytes()
    arch = get_arch(PALI_ID)
    leaves = factored_leaves(arch.init_params(0, device="meta"))
    failed = []
    if leaves != PREFIX_LEAVES_PER_STEP:
        failed.append(f"{leaves} factored leaves a step, expected "
                      f"{PREFIX_LEAVES_PER_STEP}")
    B, T = PREFIX_TRAIN
    kw = dict(arch_id=PALI_ID, batch=B, seq=T)
    watch = moe_watch(0)
    progress(f"prefix: fused AdaLomo, {PREFIX_STEPS} steps at {B} x "
             f"({T} + {arch.cfg.n_prefix_tokens})")
    with FlashCount() as direct_fc:
        rec = baseline_arm("adalomo", True, base, steps=PREFIX_STEPS,
                           hooks=[watch], **kw)
    rec["allocated_at_run_start_bytes"] = watch.start_bytes
    rerun_watch = moe_watch(0)
    progress("prefix: step 1 re-run, the flash step, then LOMO")
    rerun = baseline_arm("adalomo", True, base, steps=1,
                         hooks=[rerun_watch], **kw)
    rerun_bitwise = (rerun["losses"][0] == rec["losses"][0]
                     and torch.equal(rerun_watch.digest, watch.digest))
    fB, fT = PREFIX_FLASH
    with FlashCount() as flash_fc:
        flash = baseline_arm("adalomo", True, base, steps=1, arch_id=PALI_ID,
                             batch=fB, seq=fT)
    lomo = baseline_arm("lomo", True, base, steps=1, **kw)
    want = dict.fromkeys(("adalomo_stats", "adalomo_update"),
                         PREFIX_LEAVES_PER_STEP * PREFIX_STEPS)
    losses = rec["losses"]
    if len(losses) != PREFIX_STEPS or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif losses[-1] == losses[0]:
        failed.append(f"losses do not move: {losses}")
    if rec["launches"] != want:
        failed.append(f"K1/K2 launches {rec['launches']}, expected {want}")
    if rec["host_syncs"] != PREFIX_STEPS:
        failed.append(f"{rec['host_syncs']} host syncs in {PREFIX_STEPS} "
                      "steps")
    if not rec["params_finite"]:
        failed.append("a parameter is not finite")
    if any(direct_fc.counts.values()):
        failed.append(f"the 1,280-position steps reached the flash branch: "
                      f"{direct_fc.counts}")
    if not rerun_bitwise:
        failed.append("step 1 re-run from the same seed is not bitwise equal")
    n = arch.cfg.n_layers
    if flash_fc.counts != {"with_grad": n, "no_grad": n, "backward": n}:
        failed.append(f"the 2,304-position step's flash calls "
                      f"{flash_fc.counts}, expected {n} of each")
    if (flash["launches"] != dict.fromkeys(want, PREFIX_LEAVES_PER_STEP)
            or not all(map(math.isfinite, flash["losses"]))
            or not flash["params_finite"]):
        failed.append(f"flash step: {flash['launches']} {flash['losses']}")
    if lomo["launches"] != dict.fromkeys(want, 0) or not all(
            map(math.isfinite, lomo["losses"])):
        failed.append(f"lomo: {lomo['launches']} {lomo['losses']}")
    for r in (rec, rerun, flash, lomo):
        if r["allocated_after_free_bytes"] != base:
            failed.append(f"{r['optimizer']} {r['seq']}: "
                          f"{r['allocated_after_free_bytes']} bytes held "
                          f"after the run, {base} before")
    emit("prefix_train", arch=PALI_ID, n_prefix_tokens=arch.cfg.n_prefix_tokens,
         cut={"steps": PREFIX_STEPS}, factored_leaves_per_step=leaves,
         adalomo=rec, flash_calls_in_direct_run=direct_fc.counts,
         rerun_step1={"losses": rerun["losses"], "bitwise": rerun_bitwise,
                      "step_seconds": rerun["step_seconds"]},
         flash_step=dict(flash, positions=fT + arch.cfg.n_prefix_tokens,
                         flash_calls=flash_fc.counts),
         lomo=lomo, lomo_peak_vs_adalomo=(
             lomo["peak_memory_bytes"] / rec["peak_memory_bytes"] - 1.0),
         reckoned_unfused=reckoned_bytes(PALI_ID),
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"prefix train: {failed}")

    t0 = time.perf_counter()
    progress("prefix: legacy Engine through K4 at dh 256")
    params = arch.init_params(0)
    try:
        PagedEngine(arch, params, PagedServeConfig(**SERVE_CFG))
    except ValueError as e:
        paged_refusal = str(e)
    else:
        raise AssertionError("prefix serve: PagedEngine accepted a "
                             "prefix-LM model")
    extras = prefix_extras(arch.cfg, PREFIX_SERVE["batch"], seed=21)
    report, launches, outs = legacy_serve_run(arch, params, **PREFIX_SERVE,
                                              extras=extras)
    again = legacy_serve_run(arch, params, **PREFIX_SERVE, extras=extras)
    plain = legacy_serve_run(arch, params, **PREFIX_SERVE, extras=extras,
                             use_kernel=False)
    # one decode step after the prefill, through K4 and the plain attention,
    # in bf16 and in fp32 (the same weights, widened)
    toks = np.random.default_rng(2).integers(
        1, arch.cfg.vocab, (PREFIX_SERVE["batch"], PREFIX_SERVE[
            "prompt_len"])).astype(np.int32)
    batch = dict(extras, tokens=toks)
    step_logits, _ = decode_step_both(arch, params, batch)
    arch32 = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype=torch.float32))
    params = tree_map(lambda t: t.to(torch.float32), params)
    logits32, _ = decode_step_both(arch32, params, batch)
    step_err = max_err(step_logits[None], step_logits[False])
    control = {"k4_bf16": max_err(step_logits[None], logits32[False]),
               "plain_bf16": max_err(step_logits[False], logits32[False]),
               "k4_fp32": max_err(logits32[None], logits32[False])}
    del params, step_logits, logits32
    torch.cuda.empty_cache()
    report.update(
        rerun_tokens_equal=again[2] == outs, rerun_launches=again[1],
        plain={"tokens_equal": plain[2] == outs,
               "ms_per_decode_step": plain[0]["ms_per_decode_step"],
               "tokens_row0": plain[2][0][:8]},
        decode_step_logits_bf16={
            "k4_vs_plain_max_abs_err": step_err,
            "tolerance": PREFIX_BF16_LOGITS_TOL,
            "max_abs_err_vs_plain_fp32": control})
    emit("prefix_serve", arch=PALI_ID, paged_refusal=paged_refusal, **report,
         held_after_bytes=held_bytes(), held_before_bytes=base,
         seconds=time.perf_counter() - t0)
    if again[2] != outs:
        raise AssertionError("prefix serve: a re-run of the same prompts "
                             "gave other tokens")
    if plain[2] != outs:
        raise AssertionError("prefix serve: the tokens through K4 differ "
                             "from the plain attention's")
    if not step_err <= min(PREFIX_BF16_LOGITS_TOL, control["plain_bf16"]):
        raise AssertionError(
            f"prefix serve: bf16 decode-step logits through K4 differ from "
            f"the plain attention's by {step_err} (limit "
            f"{PREFIX_BF16_LOGITS_TOL}, and bf16 itself moves them by "
            f"{control['plain_bf16']})")

    t0 = time.perf_counter()
    progress("prefix: fp32 K4 parity at full depth")
    emit("prefix_parity", arch=PALI_ID,
         **prefix_parity(np.random.default_rng(14)),
         seconds=time.perf_counter() - t0)
    return {"launches": {"adalomo_stats": rec["launches"]["adalomo_stats"],
                         "adalomo_update": rec["launches"]["adalomo_update"],
                         "decode_attention": launches}}


# --------------------------------------------------------------------------
# ssm: the state-space families at full width and depth
# --------------------------------------------------------------------------

SSM_IDS = ("mamba2-1.3b", "zamba2-1.2b")
SSM_STEPS = 3
SSM_TRAIN = (4, 1024)
# K1/K2 launches a fused step: mamba2-1.3b's in_proj and out_proj a layer
# and the tied head (its [4352, 4] conv weights stay plain); zamba2-1.2b's
# in_proj, out_proj and six LoRA sides a layer, the shared block's seven
# matrices and the tied head
SSM_LEAVES_PER_STEP = {"mamba2-1.3b": 48 * 2 + 1,
                       "zamba2-1.2b": 38 * 8 + 7 + 1}
SSM_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
SSM_BF16_LOGITS_TOL = 0.15
# fp32 parity: zamba2 at 7 layers applies its shared block twice (0, 6)
SSM_PARITY = dict(batch=2, prompt_len=256, new_tokens=16)
SSM_PARITY_LAYERS = {"mamba2-1.3b": 2, "zamba2-1.2b": 7}
SSM_PARITY_TOL = 1e-3
# Table 1's unfused arms at the train cell: Adafactor measured on the card;
# AdamW does not fit at 4 x 1024 (its 10.75 GB of fp32 moments on top of
# Adafactor's peak pass the card's 80 GB), so it is reckoned
SSM_TABLE1_ID = "mamba2-1.3b"
SSM_TABLE1_STEPS = 2


def ssm_train(arch_id: str) -> dict:
    """Fused AdaLomo through ``run(spec)`` at 4 x 1024, 3 steps: finite
    losses that move, every param finite after step 1 and after the run,
    the K1/K2 launches of ``SSM_LEAVES_PER_STEP``, one host sync a step,
    step 1 re-run bitwise (on-card digest); fused LOMO's step beside it."""
    t0 = time.perf_counter()
    base = held_bytes()
    arch = get_arch(arch_id)
    leaves = factored_leaves(arch.init_params(0, device="meta"))
    failed = []
    if leaves != SSM_LEAVES_PER_STEP[arch_id]:
        failed.append(f"{leaves} factored leaves a step, expected "
                      f"{SSM_LEAVES_PER_STEP[arch_id]}")
    B, T = SSM_TRAIN
    kw = dict(arch_id=arch_id, batch=B, seq=T)
    watch = moe_watch(0)
    progress(f"ssm: {arch_id} fused AdaLomo, {SSM_STEPS} steps at {B} x {T}")
    rec = baseline_arm("adalomo", True, base, steps=SSM_STEPS, hooks=[watch],
                       **kw)
    rec["allocated_at_run_start_bytes"] = watch.start_bytes
    rerun_watch = moe_watch(0)
    progress(f"ssm: {arch_id} step 1 re-run, then LOMO")
    rerun = baseline_arm("adalomo", True, base, steps=1,
                         hooks=[rerun_watch], **kw)
    rerun_bitwise = (rerun["losses"][0] == rec["losses"][0]
                     and torch.equal(rerun_watch.digest, watch.digest))
    lomo = baseline_arm("lomo", True, base, steps=1, **kw)
    want = dict.fromkeys(("adalomo_stats", "adalomo_update"),
                         SSM_LEAVES_PER_STEP[arch_id] * SSM_STEPS)
    losses = rec["losses"]
    if len(losses) != SSM_STEPS or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif losses[-1] == losses[0]:
        failed.append(f"losses do not move: {losses}")
    if rec["launches"] != want:
        failed.append(f"K1/K2 launches {rec['launches']}, expected {want}")
    if rec["host_syncs"] != SSM_STEPS:
        failed.append(f"{rec['host_syncs']} host syncs in {SSM_STEPS} steps")
    if not (bool(watch.finite) and rec["params_finite"]):
        failed.append(f"a parameter is not finite (after step 1: "
                      f"{bool(watch.finite)}; after the run: "
                      f"{rec['params_finite']})")
    if not rerun_bitwise:
        failed.append("step 1 re-run from the same seed is not bitwise equal")
    if lomo["launches"] != dict.fromkeys(want, 0) or not all(
            map(math.isfinite, lomo["losses"])) or not lomo["params_finite"]:
        failed.append(f"lomo: {lomo['launches']} {lomo['losses']}")
    for r in (rec, rerun, lomo):
        if r["allocated_after_free_bytes"] != base:
            failed.append(f"{r['optimizer']}: "
                          f"{r['allocated_after_free_bytes']} bytes held "
                          f"after the run, {base} before")
    emit("ssm_train", arch=arch_id, family=arch.family,
         n_layers=arch.cfg.n_layers, chunk=arch.cfg.chunk,
         factored_leaves_per_step=leaves, adalomo=rec,
         params_finite_after_step1=bool(watch.finite),
         rerun_step1={"losses": rerun["losses"], "bitwise": rerun_bitwise,
                      "step_seconds": rerun["step_seconds"]},
         lomo=lomo, lomo_peak_vs_adalomo=(
             lomo["peak_memory_bytes"] / rec["peak_memory_bytes"] - 1.0),
         reckoned_unfused=reckoned_bytes(arch_id),
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"ssm train {arch_id}: {failed}")
    return rec


def teacher_forced_logits(arch, params, prompts, follow, use_kernel):
    """fp32 logits ``[B, n, vocab]`` of a prefill of ``prompts [B, S]``
    and then of ``n - 1`` decode steps fed ``follow [B, n]``'s tokens
    (teacher forcing: both attentions see the same tokens)."""
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=DEV)
    follow = torch.as_tensor(follow, dtype=torch.int32, device=DEV)
    logits, cache = arch.make_prefill_step()(params, {"tokens": toks})
    decode = arch.make_decode_step(use_kernel=use_kernel)
    out = [logits]
    for t in range(follow.shape[1] - 1):
        logits, cache = decode(params, cache, {"tokens": follow[:, t:t + 1]})
        out.append(logits)
    return torch.stack(out, dim=1)


def flips_at_near_ties(k4: torch.Tensor, plain: torch.Tensor) -> dict:
    """Per (row, step): |K4 - plain| logits, and the argmax flips between
    the two with the plain logits' top-2 margin there; a flip is a near tie
    when that margin is at most twice the step's gap."""
    gap = (k4 - plain).abs().amax(dim=-1)
    top2 = torch.topk(plain, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flip = k4.argmax(dim=-1) != plain.argmax(dim=-1)
    return {"max_abs_err": float(gap.max()),
            "flips": int(flip.sum()),
            "flips_not_near_tie": int((flip & (margin > 2 * gap)).sum()),
            "flip_margins": margin[flip].tolist(),
            "flip_gaps": gap[flip].tolist(),
            "median_margin": float(margin.median())}


def ssm_serve(arch_id: str) -> int:
    """The legacy Engine over the state cache at full width and depth,
    bf16: 4 prompts of 1024 tokens, 32 greedy tokens, one host sync a step,
    the same tokens on a re-run; PagedEngine refusing the family.
    zamba2-1.2b's shared attention goes through K4 (7 launches a decode
    step).  Against the plain attention: teacher-forced on K4's tokens, the
    bf16 logits of the prefill and all 31 decode steps within
    ``SSM_BF16_LOGITS_TOL`` and every argmax flip at a near tie (the
    random init's logits are nearly flat: its loss is about ln 32000); the
    plain attention's own greedy tokens reported; in fp32 (the same weights,
    widened) a decode step's logits within ``SSM_PARITY_TOL`` and the
    greedy tokens equal.  Returns the K4 launches of the first run."""
    t0 = time.perf_counter()
    base = held_bytes()
    arch = get_arch(arch_id)
    progress(f"ssm: {arch_id} legacy Engine over the state cache")
    params = arch.init_params(0)
    try:
        PagedEngine(arch, params, PagedServeConfig(**SERVE_CFG))
    except ValueError as e:
        paged_refusal = str(e)
    else:
        raise AssertionError(f"ssm serve: PagedEngine accepted {arch_id}")
    report, launches, outs = legacy_serve_run(arch, params, **SSM_SERVE)
    again = legacy_serve_run(arch, params, **SSM_SERVE)
    report["rerun_tokens_equal"] = again[2] == outs
    if again[2] != outs:
        raise AssertionError(f"ssm serve {arch_id}: a re-run of the same "
                             "prompts gave other tokens")
    if arch.family == "hybrid":
        plain = legacy_serve_run(arch, params, **SSM_SERVE, use_kernel=False)
        prompts = np.random.default_rng(2).integers(
            1, arch.cfg.vocab, (SSM_SERVE["batch"], SSM_SERVE["prompt_len"])
        ).astype(np.int32)
        forced = {u: teacher_forced_logits(arch, params, prompts, outs, u)
                  for u in (None, False)}
        flips = flips_at_near_ties(forced[None], forced[False])
        del forced
        arch32 = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, dtype=torch.float32))
        params32 = tree_map(lambda t: t.to(torch.float32), params)
        logits32, _ = decode_step_both(arch32, params32, {"tokens": prompts})
        err32 = max_err(logits32[None], logits32[False])
        tokens32 = {u: legacy_serve_run(arch32, params32, **SSM_SERVE,
                                        use_kernel=u)[2]
                    for u in (None, False)}
        del params32, logits32
        agree = [sum(a == b for a, b in zip(r, q))
                 for r, q in zip(outs, plain[2])]
        report.update(
            plain={"tokens_equal": plain[2] == outs,
                   "tokens_agreeing_per_row": agree,
                   "ms_per_decode_step": plain[0]["ms_per_decode_step"],
                   "tokens_row0": plain[2][0][:8]},
            teacher_forced_bf16=dict(flips, tolerance=SSM_BF16_LOGITS_TOL),
            fp32={"decode_step_k4_vs_plain_max_abs_err": err32,
                  "tolerance": SSM_PARITY_TOL,
                  "tokens_equal": tokens32[None] == tokens32[False]})
        if not flips["max_abs_err"] <= SSM_BF16_LOGITS_TOL:
            raise AssertionError(
                f"ssm serve {arch_id}: bf16 logits through K4 differ from "
                f"the plain attention's by {flips['max_abs_err']} (limit "
                f"{SSM_BF16_LOGITS_TOL})")
        if flips["flips_not_near_tie"]:
            raise AssertionError(
                f"ssm serve {arch_id}: {flips['flips_not_near_tie']} argmax "
                f"flips between K4 and the plain attention away from a near "
                f"tie: {flips}")
        if not err32 <= SSM_PARITY_TOL or tokens32[None] != tokens32[False]:
            raise AssertionError(
                f"ssm serve {arch_id}: fp32 decode-step logits K4 vs plain "
                f"{err32}, tokens equal {tokens32[None] == tokens32[False]}")
    del params
    emit("ssm_serve", arch=arch_id, paged_refusal=paged_refusal, **report,
         held_after_bytes=held_bytes(), held_before_bytes=base,
         seconds=time.perf_counter() - t0)
    return launches


def ssm_parity(arch_id: str, rng) -> dict:
    """fp32 at full width and ``SSM_PARITY_LAYERS`` layers: one decode
    step's logits against the last-position logits of a prefill over the
    same tokens plus one (1e-3), and Engine's greedy tokens equal to a loop
    that recomputes the whole sequence each token.  zamba2's decode runs
    over a ring that holds every token (``make_prefill_step(max_len=...)``),
    so both sides attend to the same positions; its default ring, sized to
    the prompt, is held through K4 against the plain attention (tokens
    equal)."""
    B, S, new = (SSM_PARITY[k] for k in ("batch", "prompt_len",
                                         "new_tokens"))
    arch = with_layers(get_arch(arch_id), SSM_PARITY_LAYERS[arch_id],
                       dtype=torch.float32)
    hybrid = arch.family == "hybrid"
    params = arch.init_params(0)
    toks = torch.from_numpy(rng.integers(
        1, arch.cfg.vocab, (B, S + 1)).astype(np.int32)).to(DEV)
    prefill = arch.make_prefill_step()
    wide = (arch.make_prefill_step(max_len=S + new) if hybrid else prefill)
    _, cache = wide(params, {"tokens": toks[:, :S]})
    KD.decode_attention.launches = 0
    dec = arch.make_decode_step()(params, cache, {"tokens": toks[:, S:]})[0]
    step_launches = KD.decode_attention.launches
    full = prefill(params, {"tokens": toks})[0]
    err = max_err(dec, full)
    eng = Engine(arch, params, ServeConfig(max_new_tokens=new))
    eng._prefill = wide
    tokens = eng.generate(toks[:, :S].cpu().tolist())
    seq, plain = toks[:, :S], []
    for _ in range(new):
        nxt = torch.argmax(prefill(params, {"tokens": seq})[0],
                           dim=-1).to(torch.int32)
        plain.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    plain = torch.stack(plain, dim=1).cpu().tolist()
    out = {"arch": arch_id, "n_layers": arch.cfg.n_layers,
           "dtype": "float32", **SSM_PARITY,
           "decode_vs_prefill_logits_max_abs_err": err,
           "tolerance": SSM_PARITY_TOL, "k4_launches_one_step": step_launches,
           "greedy_tokens_equal": tokens == plain,
           "tokens_engine": tokens[0], "tokens_recompute": plain[0]}
    if hybrid:
        ring = {u: Engine(arch, params, ServeConfig(
            max_new_tokens=new, use_kernel=u)).generate(
                toks[:, :S].cpu().tolist()) for u in (None, False)}
        out["prompt_sized_ring"] = {
            "k4_tokens_equal_plain": ring[None] == ring[False],
            "tokens_equal_recompute": ring[None] == plain}
    torch.cuda.synchronize()
    del params, cache
    torch.cuda.empty_cache()
    if not err <= SSM_PARITY_TOL:
        raise AssertionError(f"ssm parity {arch_id}: decode-step logits "
                             f"differ from the prefill's by {err}")
    if tokens != plain:
        raise AssertionError(f"ssm parity {arch_id}: Engine's greedy tokens "
                             f"{tokens} differ from the recompute loop's "
                             f"{plain}")
    if step_launches != k4_per_decode_step(arch):
        raise AssertionError(f"ssm parity {arch_id}: {step_launches} K4 "
                             "launches in one decode step, expected "
                             f"{k4_per_decode_step(arch)}")
    if hybrid and not out["prompt_sized_ring"]["k4_tokens_equal_plain"]:
        raise AssertionError(f"ssm parity {arch_id}: fp32 tokens through K4 "
                             "differ from the plain attention's")
    return out


def ssm_table1(base_rec: dict) -> None:
    """Table 1 on mamba2-1.3b at the train cell, beside the fused AdaLomo
    arm of ``ssm_train``: unfused Adafactor measured (2 steps, its memory
    freed after); unfused AdamW reckoned — Adafactor's measured peak with
    Adafactor's state swapped for AdamW's (the same parameters, gradients
    and activations), and the plain reckoning of params, gradients and
    state."""
    t0 = time.perf_counter()
    base = held_bytes()
    B, T = SSM_TRAIN
    failed = []
    progress(f"ssm: Table 1, adafactor unfused on {SSM_TABLE1_ID}")
    r = baseline_arm("adafactor", False, base, arch_id=SSM_TABLE1_ID,
                     steps=SSM_TABLE1_STEPS, batch=B, seq=T)
    print("  " + json.dumps({"arm": r}), flush=True)
    if (len(r["losses"]) != SSM_TABLE1_STEPS
            or not all(map(math.isfinite, r["losses"]))
            or not r["params_finite"]
            or r["launches"] != dict.fromkeys(r["launches"], 0)
            or r["host_syncs"] != SSM_TABLE1_STEPS
            or r["allocated_after_free_bytes"] != base):
        failed.append(f"adafactor: {r['losses']} {r['launches']} "
                      f"{r['host_syncs']} syncs, "
                      f"{r['allocated_after_free_bytes']} bytes held after")
    reckoned = reckoned_bytes(SSM_TABLE1_ID)
    adamw_state = reckoned["adamw"]["state_bytes"]
    peak = {"adalomo": base_rec["peak_memory_bytes"],
            "adafactor": r["peak_memory_bytes"],
            "adamw_reckoned": (r["peak_memory_bytes"] - r["state_bytes"]
                               + adamw_state)}
    if not peak["adalomo"] < peak["adafactor"] < peak["adamw_reckoned"]:
        failed.append(f"peaks AdaLomo < Adafactor < AdamW do not hold: "
                      f"{peak}")
    emit("ssm_table1", arch=SSM_TABLE1_ID, batch=B, seq=T,
         measured=["adalomo", "adafactor"], reckoned=["adamw"],
         adafactor=r, adamw_reckoned={
             "peak_bytes": peak["adamw_reckoned"],
             "state_bytes": adamw_state,
             "params_grads_state_bytes": reckoned["adamw"]["total_bytes"],
             "card_bytes": torch.cuda.get_device_properties(0).total_memory},
         peaks=peak,
         peak_ratio_adafactor_over_adalomo=(peak["adafactor"]
                                            / peak["adalomo"]),
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"ssm table1: {failed}")


def phase_ssm() -> dict:
    """mamba2-1.3b, then zamba2-1.2b, at their published widths and depths
    (bf16, random weights and data from a seed): fused AdaLomo, LOMO and
    the legacy Engine over the state cache (zamba2's shared attention
    through K4), fp32 parity of decode against prefill; then Table 1's
    unfused arms on mamba2-1.3b."""
    launches = dict.fromkeys(("adalomo_stats", "adalomo_update",
                              "decode_attention"), 0)
    recs = {}
    rng = np.random.default_rng(15)
    for arch_id in SSM_IDS:
        recs[arch_id] = ssm_train(arch_id)
        for k in ("adalomo_stats", "adalomo_update"):
            launches[k] += recs[arch_id]["launches"][k]
        gc.collect()
        torch.cuda.empty_cache()
        launches["decode_attention"] += ssm_serve(arch_id)
        t0 = time.perf_counter()
        progress(f"ssm: {arch_id} fp32 parity")
        emit("ssm_parity", **ssm_parity(arch_id, rng),
             seconds=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    ssm_table1(recs[SSM_TABLE1_ID])
    return {"launches": launches}


# --------------------------------------------------------------------------
# encdec: whisper-base trained by fused AdaLomo and decoded through K4
# --------------------------------------------------------------------------

ENCDEC_ID = "whisper-base"
ENCDEC_STEPS = 3
# 16 rows of 448 decoder tokens (whisper's text context) over 1500 frames
ENCDEC_TRAIN = (16, 448)
# K1/K2 launches a fused step: wq, wk, wv, wo, w_up, w_down an encoder
# layer; self and cross wq, wk, wv, wo, w_up, w_down a decoder layer; the
# tied head
ENCDEC_LEAVES_PER_STEP = 6 * 6 + 6 * 10 + 1
ENCDEC_TABLE1_STEPS = 2
# serving: 16 rows of 1500 frames, a ring of whisper's 448 text positions,
# 64 greedy tokens from <|startoftranscript|>
ENCDEC_SERVE = dict(batch=16, max_decode_len=448, new_tokens=64)
ENCDEC_SOT = 50258
ENCDEC_BF16_LOGITS_TOL = SSM_BF16_LOGITS_TOL
ENCDEC_PARITY = dict(layers=2, batch=2, new_tokens=16)
ENCDEC_PARITY_TOL = 1e-4


def encdec_frames(cfg, batch: int, seed: int) -> torch.Tensor:
    """Frame embeddings ``[batch, n_frames, d_model]`` (the stubbed audio
    frontend's output), float32 normal draws on the card from ``seed``."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    return torch.randn((batch, cfg.n_frames, cfg.d_model), generator=g,
                       device=DEV)


def encdec_decode(arch, params, frames, new_tokens: int, *, use_kernel=None,
                  follow=None) -> dict:
    """``make_prefill_step`` on ``frames``, then ``new_tokens`` decode steps
    from the start token: greedy, or fed ``follow [B, new_tokens]``'s tokens
    (teacher forcing).  One host transfer a step (the step's tokens).  K4
    launches counted from 0; prefill and decode steps timed by CUDA events.
    Returns the tokens, the stacked fp32 logits and the counts."""
    B = frames.shape[0]
    prefill = arch.make_prefill_step(
        max_decode_len=ENCDEC_SERVE["max_decode_len"])
    decode = arch.make_decode_step(use_kernel=use_kernel)
    prefill_ev, decode_ev = [], []
    prefill = _event_timed(prefill, prefill_ev)
    decode = _event_timed(decode, decode_ev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            KD.decode_attention.launches = 0
            _, cache = prefill(params, {"frames": frames})
            tok = torch.full((B, 1), ENCDEC_SOT, dtype=torch.int32,
                             device=DEV)
            tokens, logits = [], []
            for t in range(new_tokens):
                out, cache = decode(params, cache, {"tokens": tok})
                logits.append(out)
                tok = (torch.argmax(out, dim=-1).to(torch.int32)[:, None]
                       if follow is None else follow[:, t:t + 1])
                tokens.append(tok.cpu())
            launches = KD.decode_attention.launches
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    decode_s = decode_ev[0][0].elapsed_time(decode_ev[-1][1]) / 1e3
    return {"tokens": torch.cat(tokens, dim=1), "logits": torch.stack(
                logits, dim=1),
            "launches": launches,
            "host_syncs": sum("synchroniz" in str(w.message) for w in caught),
            "prefill_seconds": prefill_ev[0][0].elapsed_time(
                prefill_ev[0][1]) / 1e3,
            "ms_per_decode_step": decode_s / new_tokens * 1e3,
            "decode_tokens_per_s": B * new_tokens / decode_s}


def encdec_train() -> dict:
    """Fused AdaLomo through ``run(spec)`` at 16 x 448 over 1500 frames, 3
    steps: finite losses that move, every param finite after step 1, the
    K1/K2 launches of ``ENCDEC_LEAVES_PER_STEP``, one host sync a step,
    step 1 re-run bitwise (on-card digest); then Table 1's other arms at
    the same batch, all measured: fused LOMO, unfused Adafactor and
    unfused AdamW (2 steps each), each arm's memory freed after it."""
    t0 = time.perf_counter()
    base = held_bytes()
    arch = get_arch(ENCDEC_ID)
    leaves = factored_leaves(arch.init_params(0, device="meta"))
    failed = []
    if leaves != ENCDEC_LEAVES_PER_STEP:
        failed.append(f"{leaves} factored leaves a step, expected "
                      f"{ENCDEC_LEAVES_PER_STEP}")
    B, T = ENCDEC_TRAIN
    kw = dict(arch_id=ENCDEC_ID, batch=B, seq=T)
    watch = moe_watch(0)
    progress(f"encdec: fused AdaLomo, {ENCDEC_STEPS} steps at {B} x {T}")
    rec = baseline_arm("adalomo", True, base, steps=ENCDEC_STEPS,
                       hooks=[watch], **kw)
    rerun_watch = moe_watch(0)
    rerun = baseline_arm("adalomo", True, base, steps=1, hooks=[rerun_watch],
                         **kw)
    rerun_bitwise = (rerun["losses"][0] == rec["losses"][0]
                     and torch.equal(rerun_watch.digest, watch.digest))
    progress("encdec: Table 1's other arms")
    arms = {"adalomo": rec}
    for name, fused in BASELINE_ARMS[1:]:
        arms[name] = baseline_arm(name, fused, base,
                                  steps=ENCDEC_TABLE1_STEPS, **kw)
    want = dict.fromkeys(("adalomo_stats", "adalomo_update"),
                         ENCDEC_LEAVES_PER_STEP * ENCDEC_STEPS)
    losses = rec["losses"]
    if len(losses) != ENCDEC_STEPS or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif losses[-1] == losses[0]:
        failed.append(f"losses do not move: {losses}")
    if rec["launches"] != want:
        failed.append(f"K1/K2 launches {rec['launches']}, expected {want}")
    if not bool(watch.finite):
        failed.append("a parameter is not finite after step 1")
    if not rerun_bitwise:
        failed.append("step 1 re-run from the same seed is not bitwise equal")
    for name, r in arms.items():
        steps = ENCDEC_STEPS if name == "adalomo" else ENCDEC_TABLE1_STEPS
        if (len(r["losses"]) != steps
                or not all(map(math.isfinite, r["losses"]))
                or not r["params_finite"] or r["host_syncs"] != steps):
            failed.append(f"{name}: losses {r['losses']}, "
                          f"{r['host_syncs']} host syncs, params finite "
                          f"{r['params_finite']}")
        if name != "adalomo" and r["launches"] != dict.fromkeys(want, 0):
            failed.append(f"{name}: K1/K2 launches {r['launches']}")
    for r in (*arms.values(), rerun):
        if r["allocated_after_free_bytes"] != base:
            failed.append(f"{r['optimizer']}: "
                          f"{r['allocated_after_free_bytes']} bytes held "
                          f"after the run, {base} before")
    peak = {k: r["peak_memory_bytes"] for k, r in arms.items()}
    if not (max(peak["adalomo"], peak["lomo"]) < peak["adafactor"]
            < peak["adamw"]):
        failed.append(f"peaks AdaLomo, LOMO < Adafactor < AdamW do not "
                      f"hold: {peak}")
    if arms["adamw"]["state_bytes"] != 8 * arms["adamw"]["n_params"]:
        failed.append(f"adamw: state {arms['adamw']['state_bytes']} bytes")
    emit("encdec_train", arch=ENCDEC_ID, family=arch.family,
         n_layers=[arch.cfg.n_enc_layers, arch.cfg.n_dec_layers],
         n_frames=arch.cfg.n_frames, batch=B, seq=T,
         factored_leaves_per_step=leaves, adalomo=rec,
         params_finite_after_step1=bool(watch.finite),
         rerun_step1={"losses": rerun["losses"], "bitwise": rerun_bitwise,
                      "step_seconds": rerun["step_seconds"]},
         table1={name: {k: r[k] for k in (
             "engine", "n_params", "param_bytes", "state_bytes",
             "grad_bytes", "init_allocated_bytes", "peak_memory_bytes",
             "step_seconds", "losses", "launches")}
             for name, r in arms.items()},
         peak_ratio_adamw_over_adalomo=peak["adamw"] / peak["adalomo"],
         peak_ratio_lomo_over_adalomo=peak["lomo"] / peak["adalomo"],
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"encdec train: {failed}")
    return rec


def encdec_serve() -> int:
    """bf16 at full width and depth: prefill on 16 x 1500 frames, then 64
    greedy decode steps from the start token, 12 K4 launches a step (6
    self, 6 cross), one host sync a step, the same tokens on a re-run (whose
    times are reported).  Against the plain attention (``use_kernel=False``):
    teacher-forced on K4's tokens, every step's bf16 logits within
    ``ENCDEC_BF16_LOGITS_TOL`` and every argmax flip at a near tie; in fp32
    (the same weights, widened) the greedy tokens equal.  Returns the K4
    launches of the first run."""
    t0 = time.perf_counter()
    base = held_bytes()
    arch = get_arch(ENCDEC_ID)
    B, n = ENCDEC_SERVE["batch"], ENCDEC_SERVE["new_tokens"]
    per_step = 2 * arch.cfg.n_dec_layers
    params = arch.init_params(0)
    frames = encdec_frames(arch.cfg, B, 7)
    progress(f"encdec: prefill on {B} x {arch.cfg.n_frames} frames, {n} "
             "greedy steps through K4")
    first = encdec_decode(arch, params, frames, n)
    again = encdec_decode(arch, params, frames, n)
    failed = []
    if first["launches"] != per_step * n:
        failed.append(f"{first['launches']} K4 launches in {n} decode "
                      f"steps, expected {per_step} a step")
    for r in (first, again):
        if r["host_syncs"] != n:
            failed.append(f"{r['host_syncs']} host syncs in {n} steps")
    toks = first["tokens"]
    if not bool(((toks >= 0) & (toks < arch.cfg.vocab)).all()):
        failed.append("a token id outside the vocabulary")
    if not torch.equal(again["tokens"], toks):
        failed.append("a re-run gave other tokens")
    progress("encdec: the plain attention, teacher-forced and greedy")
    plain = encdec_decode(arch, params, frames, n, use_kernel=False)
    forced = encdec_decode(arch, params, frames, n, use_kernel=False,
                           follow=toks.to(DEV))
    flips = flips_at_near_ties(first["logits"], forced["logits"])
    if not flips["max_abs_err"] <= ENCDEC_BF16_LOGITS_TOL:
        failed.append(f"bf16 logits through K4 differ from the plain "
                      f"attention's by {flips['max_abs_err']}")
    if flips["flips_not_near_tie"]:
        failed.append(f"argmax flips away from a near tie: {flips}")
    if plain["launches"] or forced["launches"]:
        failed.append("the plain attention launched K4")
    for r in (first, again, plain, forced):
        del r["logits"]
    arch32 = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype=torch.float32))
    params32 = tree_map(lambda t: t.to(torch.float32), params)
    del params
    progress("encdec: fp32 tokens, K4 and plain")
    fp32 = {u: encdec_decode(arch32, params32, frames, n, use_kernel=u)
            for u in (None, False)}
    err32 = max_err(fp32[None]["logits"], fp32[False]["logits"])
    tokens32_equal = torch.equal(fp32[None]["tokens"], fp32[False]["tokens"])
    if not tokens32_equal:
        failed.append("fp32 greedy tokens differ between K4 and the plain "
                      "attention")
    del params32, fp32, frames
    torch.cuda.empty_cache()
    agree = (plain["tokens"] == toks).sum(dim=1).tolist()
    emit("encdec_serve", arch=ENCDEC_ID, dtype="bfloat16", batch=B,
         n_frames=arch.cfg.n_frames, ring_slots=ENCDEC_SERVE[
             "max_decode_len"], new_tokens=n, start_token=ENCDEC_SOT,
         k4_launches=first["launches"], k4_per_decode_step=per_step,
         host_syncs=again["host_syncs"],
         prefill_seconds=again["prefill_seconds"],
         ms_per_decode_step=again["ms_per_decode_step"],
         decode_tokens_per_s=again["decode_tokens_per_s"],
         first_run={k: first[k] for k in ("prefill_seconds",
                                          "ms_per_decode_step")},
         rerun_tokens_equal=torch.equal(again["tokens"], toks),
         tokens_row0=toks[0, :8].tolist(),
         plain={"tokens_equal": torch.equal(plain["tokens"], toks),
                "tokens_agreeing_per_row": agree,
                "ms_per_decode_step": plain["ms_per_decode_step"]},
         teacher_forced_bf16=dict(flips, tolerance=ENCDEC_BF16_LOGITS_TOL),
         fp32={"logits_k4_vs_plain_max_abs_err": err32,
               "tokens_equal": tokens32_equal},
         held_after_bytes=held_bytes(), held_before_bytes=base,
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"encdec serve: {failed}")
    return first["launches"]


def encdec_parity() -> dict:
    """fp32 at the published widths and 2 + 2 layers: the decode steps'
    logits (through K4) at each position against the teacher-forced
    decoder forward's (``encdec.decoder_logits``, what ``loss_fn`` scores)
    over the prefill's own encoder output, within ``ENCDEC_PARITY_TOL``."""
    from repro_torch.models.encdec import decoder_logits
    L_, B, n = (ENCDEC_PARITY[k] for k in ("layers", "batch", "new_tokens"))
    arch = get_arch(ENCDEC_ID)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_enc_layers=L_, n_dec_layers=L_, dtype=torch.float32))
    params = arch.init_params(0)
    frames = encdec_frames(arch.cfg, B, 8)
    enc_out, cache = arch.make_prefill_step(max_decode_len=n)(
        params, {"frames": frames})
    decode = arch.make_decode_step()
    tok = torch.full((B, 1), ENCDEC_SOT, dtype=torch.int32, device=DEV)
    seq, logits = [tok], []
    KD.decode_attention.launches = 0
    for _ in range(n):
        out, cache = decode(params, cache, {"tokens": tok})
        logits.append(out)
        tok = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
        seq.append(tok)
    launches = KD.decode_attention.launches
    with torch.no_grad():
        want = decoder_logits(arch.cfg, params, enc_out,
                              torch.cat(seq[:-1], dim=1))
    err = max_err(torch.stack(logits, dim=1), want)
    del params, cache, enc_out
    torch.cuda.empty_cache()
    out = {"n_layers": [L_, L_], "dtype": "float32", "batch": B,
           "decode_steps": n, "k4_launches": launches,
           "decode_vs_teacher_forced_max_abs_err": err,
           "tolerance": ENCDEC_PARITY_TOL}
    if not err <= ENCDEC_PARITY_TOL or launches != 2 * L_ * n:
        raise AssertionError(f"encdec parity: {out}")
    return out


def phase_encdec() -> dict:
    """whisper-base at its published widths and depth (bf16, random weights
    and frames from a seed): fused AdaLomo and Table 1's arms at 16 x 448
    over 1500 frames, then decoding through K4 from the prefill's caches,
    then fp32 parity of decode against the teacher-forced forward."""
    launches = dict.fromkeys(("adalomo_stats", "adalomo_update",
                              "decode_attention"), 0)
    rec = encdec_train()
    for k in ("adalomo_stats", "adalomo_update"):
        launches[k] = rec["launches"][k]
    gc.collect()
    torch.cuda.empty_cache()
    launches["decode_attention"] = encdec_serve()
    t0 = time.perf_counter()
    progress("encdec: fp32 parity at 2 + 2 layers")
    emit("encdec_parity", **encdec_parity(), seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


# --------------------------------------------------------------------------
# K1/K2 sharded entries: ZeRO-3 row and column shards of danube's leaves
# --------------------------------------------------------------------------

# danube's leaves as the rules split them over the data axis: rows for
# attn/wq and mlp/w_gate, columns for attn/wo and mlp/w_down
SHARD_CASES = {"attn/wq [2560,2560]": ((2560, 2560), -2),
               "mlp/w_gate [2560,6912]": ((2560, 6912), -2),
               "attn/wo [2560,2560]": ((2560, 2560), -1),
               "mlp/w_down [6912,2560]": ((6912, 2560), -1)}
# The 170 leaves of a step by shape and split (wq, wk, wv, w_gate, w_up and
# the head by rows; wo, w_down and the embedding by columns)
SHARDED_PER_STEP = {((2560, 2560), -2): 24, ((2560, 2560), -1): 24,
                    ((2560, 640), -2): 48, ((2560, 6912), -2): 48,
                    ((6912, 2560), -1): 24, ((32000, 2560), -1): 1,
                    ((2560, 32000), -2): 1}
# A clip above RMS(u), so that a wrong element count does not cancel
# between RMS(u) and RMS(theta)
SHARD_WRONG_CLIP = 100.0
SHARDED_WRAPPERS = ("adalomo_stats_partial", "adalomo_stats_fold",
                    "adalomo_update_partials", "adalomo_update_apply")


def split_shards(p, g, r, c, w, axis):
    """w shards of [.., m, n] along ``axis``, each a contiguous copy, and
    each rank's state: its part of the split axis' vector, all of the
    other.  The inputs are left as they are."""
    def parts(t, dim):
        return [x.clone(memory_format=torch.contiguous_format)
                for x in t.chunk(w, dim=dim)]
    if axis == -2:
        return parts(p, -2), parts(g, -2), parts(r, -1), \
            [c.clone() for _ in range(w)]
    return parts(p, -1), parts(g, -1), [r.clone() for _ in range(w)], \
        parts(c, -1)


def run_shards(p, g, r, c, w, axis, *, lr, step, beta, clip=1.0,
               n_total=None, plain=False):
    """The sharded entries on w shards (their kernels, or with ``plain``
    their plain versions), the sums over the ranks emulated by fixed-order
    sums in this process; the shards put back together."""
    from repro_torch.kernels.adalomo_update.ref import adalomo_update_shards
    ps, gs, rs, cs = split_shards(p, g, r, c, w, axis)
    adalomo_update_shards(ps, gs, rs, cs, lr=lr, step=step, beta=beta,
                          clip=clip, axis=axis, n_total=n_total, plain=plain)
    folded = cs if axis == -2 else rs
    if not all(torch.equal(t, folded[0]) for t in folded[1:]):
        raise AssertionError("sharded K1: the ranks folded different bits "
                             "from the same sum")
    return (torch.cat(ps, dim=axis),
            torch.cat(rs, dim=-1) if axis == -2 else rs[0],
            cs[0] if axis == -2 else torch.cat(cs, dim=-1))


def check_sharded_kernels(errs: dict) -> dict:
    """K1/K2's sharded entries on danube's leaves split 1, 2 and 4 ways
    along the dim the rules give them, alone and as stacked [24, m, n]
    leaves (the one-way split at those shapes is what the one-rank world of
    the dist phase runs), bf16 and fp32: held against their plain versions
    on the same shards (the kernels' line's max_abs_err) and against the
    whole-tensor kernels on the same inputs, r and c within TOL_RC and
    theta' within K2's tolerance; a bitwise re-run; and one case with the
    shard's element count in place of the tensor's, which must
    disagree."""
    beta, lr, step = 0.999, 5e-4, 5.0
    cases = {}
    for name, (shape, axis) in SHARD_CASES.items():
        for lead in ((), (N_LAYERS,)):
            for dt in (torch.bfloat16, torch.float32):
                for w in (1, 2, 4):
                    key = (f"{name} {'x'.join(map(str, lead)) or '1'} "
                           f"{str(dt)[6:]} /{w}")
                    p, g, r, c = make_inputs(shape, dt, dt, shape[1] + w, step,
                                             lead=lead)
                    kw = dict(lr=lr, step=step, beta=beta)
                    ps, rs, cs = run_shards(p, g, r, c, w, axis, **kw)
                    pp, rp, cp = run_shards(p, g, r, c, w, axis, plain=True,
                                            **kw)
                    assert_close(rs, rp, what="sharded K1 r " + key, **TOL_RC)
                    assert_close(cs, cp, what="sharded K1 c " + key, **TOL_RC)
                    assert_close(ps, pp, rtol=TOL_P[dt], atol=TOL_P[dt],
                                 what="sharded K2 " + key)
                    vs_plain = (max(max_err(rs, rp), max_err(cs, cp)),
                                max_err(ps, pp))
                    del pp, rp, cp
                    pw, rw, cw = p.clone(), r.clone(), c.clone()
                    adalomo_update(pw, g, rw, cw, lr, step, beta)
                    for what, a, b, tol in (
                            ("r", rs, rw, TOL_RC), ("c", cs, cw, TOL_RC),
                            ("theta'", ps, pw, dict(rtol=TOL_P[dt],
                                                    atol=TOL_P[dt]))):
                        assert_close(a, b, **tol, what=f"sharded K1/K2 {what} "
                                     f"against the whole-tensor kernel {key}")
                    again = run_shards(p, g, r, c, w, axis, **kw)
                    rerun = all(torch.equal(a, b) for a, b in
                                zip(again, (ps, rs, cs)))
                    if not rerun:
                        raise AssertionError(f"sharded K1/K2 {key}: a re-run "
                                             "gave other bits")
                    errs["adalomo_stats_sharded"] = max(
                        errs["adalomo_stats_sharded"], vs_plain[0])
                    errs["adalomo_update_sharded"] = max(
                        errs["adalomo_update_sharded"], vs_plain[1])
                    cases[key] = {
                        "r_c_max_abs_err_vs_plain": vs_plain[0],
                        "param_max_abs_err_vs_plain": vs_plain[1],
                        "r_c_max_abs_err_vs_whole": max(max_err(rs, rw),
                                                        max_err(cs, cw)),
                        "param_max_abs_err_vs_whole": max_err(ps, pw),
                        "bitwise_vs_whole": bool(
                            torch.equal(ps, pw) and torch.equal(rs, rw)
                            and torch.equal(cs, cw)),
                        "rerun_bitwise": rerun}
                    del p, g, r, c, pw, rw, cw, ps, rs, cs, again
    # the silent error of this design: the shard's m*n in place of the
    # tensor's.  It must move theta' away from the whole-tensor kernel's.
    shape, axis = next(iter(SHARD_CASES.values()))      # attn/wq, rows
    p, g, r, c = make_inputs(shape, torch.float32, torch.float32, 7, step)
    pw, rw, cw = p.clone(), r.clone(), c.clone()
    adalomo_update(pw, g, rw, cw, 5e-2, step, beta, clip=SHARD_WRONG_CLIP)
    wrong, _, _ = run_shards(p, g, r, c, 4, axis, lr=5e-2, step=step,
                             beta=beta, clip=SHARD_WRONG_CLIP,
                             n_total=shape[0] * shape[1] // 4)
    try:
        assert_close(wrong, pw, rtol=TOL_P[torch.float32],
                     atol=TOL_P[torch.float32], what="wrong element count")
    except AssertionError:
        caught = True
    else:
        caught = False
    if not caught:
        raise AssertionError("sharded K2 with the shard's element count "
                             "agreed with the whole tensor's update")
    torch.cuda.synchronize()
    return {"cases": cases, "wrong_count_disagrees": caught,
            "wrong_count_max_abs_err": max_err(wrong, pw)}


def time_sharded_kernels() -> tuple:
    """One rank's work at a 2-way split of each danube leaf, bf16: K1's
    sharded entry, the fold, K2's partials and apply launches (graph
    replays), their plain versions and bounds, and the totals over the 170
    leaves of a step beside the whole-tensor kernels'."""
    beta_t = torch.full((), 0.999, device=DEV)
    kw2 = dict(eps_div=CFG.eps_div, eps_rms=CFG.eps_rms, literal=False)
    rows = []
    for (shape, axis), count in SHARDED_PER_STEP.items():
        m, n = shape
        sm, sn = (m // 2, n) if axis == -2 else (m, n // 2)
        elt = 2
        set_bytes = 2 * sm * sn * elt
        copies = min(32, max(2, math.ceil(192e6 / set_bytes)))
        sets = []
        for i in range(copies):
            # the shard, and this rank's state: its part of the split
            # axis' vector, all of the other
            p, g, r, c = make_inputs((sm, sn), torch.bfloat16,
                                     torch.bfloat16, i, 5.0)
            raw = K.adalomo_stats_partial(g, r, c, beta_t,
                                          eps_stat=CFG.eps_stat, axis=axis)
            scal = scal_for(r, 5e-4, 5.0, 0.999, 0.0, 1.0)
            sums = K.adalomo_update_partials(p, g, r, c, scal, **kw2)
            vec = c if axis == -2 else r
            sets.append((p, g, r, c, scal, raw, vec, sums))
        rounds = max(2, min(20, 200 // copies))
        state = 4 * (r.numel() + c.numel())
        fns = {
            "stats_partial": (
                lambda p, g, r, c, s, raw, v, su: K.adalomo_stats_partial(
                    g, r, c, beta_t, eps_stat=CFG.eps_stat, axis=axis),
                lambda p, g, r, c, s, raw, v, su:
                K.adalomo_stats_partial_ref(g, r, c, beta_t,
                                            eps_stat=CFG.eps_stat, axis=axis),
                sm * sn * elt + 2 * state + 4 * raw.numel(),
                K1_FLOP_PER_ELEM * sm * sn),
            "stats_fold": (
                lambda p, g, r, c, s, raw, v, su: K.adalomo_stats_fold(
                    v, raw, beta_t),
                lambda p, g, r, c, s, raw, v, su: K.adalomo_stats_fold_ref(
                    v, raw, beta_t),
                4 * (2 * vec.numel() + raw.numel()), 3 * vec.numel()),
            "update_partials": (
                lambda p, g, r, c, s, raw, v, su: K.adalomo_update_partials(
                    p, g, r, c, s, **kw2),
                lambda p, g, r, c, s, raw, v, su:
                K.adalomo_update_partials_ref(p, g, r, c, s, **kw2),
                2 * sm * sn * elt + state, K2_FLOP_PER_ELEM * sm * sn),
            "update_apply": (
                lambda p, g, r, c, s, raw, v, su: K.adalomo_update_apply(
                    p, g, r, c, s, su, m * n, **kw2),
                lambda p, g, r, c, s, raw, v, su: K.adalomo_update_apply_ref(
                    p, g, r, c, s, su, m * n, **kw2),
                3 * sm * sn * elt + state, K2_FLOP_PER_ELEM * sm * sn)}
        row = {"shape": [m, n], "split": "rows" if axis == -2 else "columns",
               "shard": [sm, sn], "dtype": "bf16", "per_step": count}
        for key, (fn, plain, nbytes, flop) in fns.items():
            row[key + "_ms"] = time_graph_ms(fn, sets, rounds)
            row[key + "_plain_ms"] = time_graph_ms(plain, sets, rounds)
            row[key + "_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                         flop / FP32_FLOP_PER_S) * 1e3
        rows.append(row)
        del sets
        torch.cuda.empty_cache()

    def per_step(keys, what):
        return sum(r[f"{k}_{what}"] * r["per_step"] for r in rows
                   for k in keys)

    totals = {name: {what: per_step(keys, what)
                     for what in ("ms", "plain_ms", "bound_ms")}
              for name, keys in (
                  ("adalomo_stats_sharded", ("stats_partial", "stats_fold")),
                  ("adalomo_update_sharded", ("update_partials",
                                              "update_apply")))}
    return rows, totals


# --------------------------------------------------------------------------
# K1 mode 3: 2-D blocks of danube's leaves (the model axis)
# --------------------------------------------------------------------------

# danube's leaves as the rules split them on a (data, model) mesh: attn/wq
# and mlp/w_gate by rows over data and columns over model, attn/wo and
# mlp/w_down the transpose (rows over model, columns over data)
BLOCK_CASES = {"attn/wq [2560,2560]": ((2560, 2560), "data"),
               "mlp/w_gate [2560,6912]": ((2560, 6912), "data"),
               "attn/wo [2560,2560]": ((2560, 2560), "model"),
               "mlp/w_down [6912,2560]": ((6912, 2560), "model")}
BLOCK_MESHES = ((2, 2), (1, 2))         # (data, model)
# One rank's blocks of the 170 leaves of a step on (2, 2): every leaf is
# split both ways there (wq, wo; wk, wv; w_gate, w_up; w_down; the embedding
# and the head)
BLOCKS_PER_STEP = {(1280, 1280): 48, (1280, 320): 48, (1280, 3456): 48,
                   (3456, 1280): 24, (16000, 1280): 1, (1280, 16000): 1}


def block_grid(mesh, rows_over):
    """(row blocks, column blocks) of a leaf whose rows the ``rows_over``
    axis splits, on a (data, model) mesh."""
    data, model = mesh
    return (data, model) if rows_over == "data" else (model, data)


def run_blocks(p, g, r, c, R, C, *, lr, step, beta, clip=1.0, n_total=None,
               plain=False):
    """The R x C grid of blocks through K1's mode 3 and K2's sharded
    entries (their kernels, or with ``plain`` their plain versions), the
    sums over the ranks emulated by fixed-order sums in this process
    (``ref.adalomo_update_grid``); every block of a row must fold the same
    r and every block of a column the same c; the blocks put back
    together."""
    from repro_torch.kernels.adalomo_update.ref import adalomo_update_grid

    def blocks(t):
        return [[b.clone(memory_format=torch.contiguous_format)
                 for b in rows.chunk(C, dim=-1)] for rows in t.chunk(R, -2)]
    P, G = blocks(p), blocks(g)
    rs = [[t.clone() for _ in range(C)] for t in r.chunk(R, dim=-1)]
    cs = [[t.clone() for t in c.chunk(C, dim=-1)] for _ in range(R)]
    adalomo_update_grid(P, G, rs, cs, lr=lr, step=step, beta=beta, clip=clip,
                        n_total=n_total, plain=plain)
    if not (all(torch.equal(t, row[0]) for row in rs for t in row) and all(
            torch.equal(cs[i][j], cs[0][j]) for i in range(R)
            for j in range(C))):
        raise AssertionError("K1 mode 3: the blocks of a row or a column "
                             "folded different bits from the same sums")
    return (torch.cat([torch.cat(row, -1) for row in P], -2),
            torch.cat([row[0] for row in rs], -1), torch.cat(cs[0], -1))


def check_block_kernels(errs: dict) -> dict:
    """K1's mode 3 (both sums raw) with K2's sharded entries on danube's
    leaves split as the rules split them on (2, 2) and (1, 2), alone and as
    stacked [24, m, n] leaves, bf16 and fp32: against their plain versions
    on the same blocks (the kernels line's max_abs_err), and the emulated
    update against the whole-tensor kernels on the same inputs, r and c
    within TOL_RC and theta' within K2's tolerance; a bitwise re-run; and
    one case with a block's element count in place of the tensor's, which
    must disagree."""
    beta, lr, step = 0.999, 5e-4, 5.0
    cases = {}
    for name, (shape, rows_over) in BLOCK_CASES.items():
        for mesh in BLOCK_MESHES:
            R, C = block_grid(mesh, rows_over)
            for lead in ((), (N_LAYERS,)):
                for dt in (torch.bfloat16, torch.float32):
                    key = (f"{name} {'x'.join(map(str, lead)) or '1'} "
                           f"{str(dt)[6:]} grid {R}x{C}")
                    p, g, r, c = make_inputs(shape, dt, dt, shape[1] + R * C,
                                             step, lead=lead)
                    kw = dict(lr=lr, step=step, beta=beta)
                    pk, rk, ck = run_blocks(p, g, r, c, R, C, **kw)
                    pp, rp, cp = run_blocks(p, g, r, c, R, C, plain=True,
                                            **kw)
                    assert_close(rk, rp, what="K1 mode 3 r " + key, **TOL_RC)
                    assert_close(ck, cp, what="K1 mode 3 c " + key, **TOL_RC)
                    assert_close(pk, pp, rtol=TOL_P[dt], atol=TOL_P[dt],
                                 what="K2 on blocks " + key)
                    vs_plain = (max(max_err(rk, rp), max_err(ck, cp)),
                                max_err(pk, pp))
                    del pp, rp, cp
                    pw, rw, cw = p.clone(), r.clone(), c.clone()
                    adalomo_update(pw, g, rw, cw, lr, step, beta)
                    for what, a, b, tol in (
                            ("r", rk, rw, TOL_RC), ("c", ck, cw, TOL_RC),
                            ("theta'", pk, pw, dict(rtol=TOL_P[dt],
                                                    atol=TOL_P[dt]))):
                        assert_close(a, b, **tol, what=f"K1 mode 3 / K2 "
                                     f"{what} against the whole-tensor "
                                     f"kernel {key}")
                    again = run_blocks(p, g, r, c, R, C, **kw)
                    rerun = all(torch.equal(a, b) for a, b in
                                zip(again, (pk, rk, ck)))
                    if not rerun:
                        raise AssertionError(f"K1 mode 3 {key}: a re-run "
                                             "gave other bits")
                    errs["adalomo_stats_2d"] = max(errs["adalomo_stats_2d"],
                                                   vs_plain[0])
                    cases[key] = {
                        "r_c_max_abs_err_vs_plain": vs_plain[0],
                        "param_max_abs_err_vs_plain": vs_plain[1],
                        "r_c_max_abs_err_vs_whole": max(max_err(rk, rw),
                                                        max_err(ck, cw)),
                        "param_max_abs_err_vs_whole": max_err(pk, pw),
                        "rerun_bitwise": rerun}
                    del p, g, r, c, pw, rw, cw, pk, rk, ck, again
    # a block's m*n in place of the tensor's must move theta' away from the
    # whole-tensor kernel's
    shape, _ = next(iter(BLOCK_CASES.values()))
    p, g, r, c = make_inputs(shape, torch.float32, torch.float32, 7, step)
    pw, rw, cw = p.clone(), r.clone(), c.clone()
    adalomo_update(pw, g, rw, cw, 5e-2, step, beta, clip=SHARD_WRONG_CLIP)
    wrong, _, _ = run_blocks(p, g, r, c, 2, 2, lr=5e-2, step=step,
                             beta=beta, clip=SHARD_WRONG_CLIP,
                             n_total=shape[0] * shape[1] // 4)
    try:
        assert_close(wrong, pw, rtol=TOL_P[torch.float32],
                     atol=TOL_P[torch.float32], what="wrong element count")
    except AssertionError:
        caught = True
    else:
        caught = False
    if not caught:
        raise AssertionError("K2 on 2-D blocks with a block's element count "
                             "agreed with the whole tensor's update")
    torch.cuda.synchronize()
    return {"cases": cases, "wrong_count_disagrees": caught,
            "wrong_count_max_abs_err": max_err(wrong, pw)}


def time_block_kernels() -> tuple:
    """K1's mode 3 on one rank's blocks of each danube leaf at a 2 x 2
    split, bf16 (graph replays), its plain version and its bound, and the
    totals over the 170 blocks of a step."""
    beta_t = torch.full((), 0.999, device=DEV)
    rows = []
    for (sm, sn), count in BLOCKS_PER_STEP.items():
        elt = 2
        copies = min(32, max(2, math.ceil(192e6 / (sm * sn * elt))))
        sets = [make_inputs((sm, sn), torch.bfloat16, torch.bfloat16, i, 5.0)
                for i in range(copies)]
        rounds = max(2, min(20, 200 // copies))

        def k1(p, g, r, c):
            return K.adalomo_stats_partial(g, r, c, beta_t,
                                           eps_stat=CFG.eps_stat, axis=K.BOTH)

        def k1_plain(p, g, r, c):
            return K.adalomo_stats_partial_ref(g, r, c, beta_t,
                                               eps_stat=CFG.eps_stat,
                                               axis=K.BOTH)
        # g read once, the raw row and column sums written once
        nbytes = sm * sn * elt + 4 * (sm + sn)
        rows.append({"block": [sm, sn], "dtype": "bf16", "per_step": count,
                     "ms": time_graph_ms(k1, sets, rounds),
                     "plain_ms": time_graph_ms(k1_plain, sets, rounds),
                     "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                     K1_FLOP_PER_ELEM * sm * sn
                                     / FP32_FLOP_PER_S) * 1e3})
        del sets
        torch.cuda.empty_cache()
    totals = {what: sum(r[what] * r["per_step"] for r in rows)
              for what in ("ms", "plain_ms", "bound_ms")}
    return rows, totals


# --------------------------------------------------------------------------
# dist: the sharded run — a one-rank NCCL world at full size, two gloo ranks
# sharing the card, and elastic restores between them
# --------------------------------------------------------------------------

DIST_STEPS = 3
DIST_GLOO_LAYERS = 4
DIST_GLOO_STEPS = 2
DIST_CKPT_STEP = 1
DIST_LOSS_RTOL = 1e-5
DIST_GLOO_TIMEOUT_S = 300       # the two ranks' runs take about 90 s
DIST_PARAM_TOL = dict(rtol=5e-4, atol=1e-5)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_launches() -> dict:
    return {name: getattr(K, name).launches
            for name in SHARDED_WRAPPERS + ("adalomo_stats",
                                            "adalomo_update")}


def reset_launches() -> None:
    for name in SHARDED_WRAPPERS + ("adalomo_stats", "adalomo_update"):
        getattr(K, name).launches = 0
    K.adalomo_stats_partial.both_launches = 0


def dist_spec(steps, *, shape=None, ckpt=None, every=0, arch_id=ARCH_ID,
              batch=4, seq=1024, optimized=True):
    from repro_torch.run import CheckpointSpec, MeshSpec
    return RunSpec(model=ModelSpec(arch_id, smoke=False),
                   data=DataConfig(vocab=0, seq_len=seq,
                                   global_batch=batch, seed=0),
                   opt=OptSpec(name="adalomo"),
                   steps=StepSpec(total=steps), log_every=0, seed=0,
                   mesh=(MeshSpec(kind="multi", shape=shape,
                                  optimized=optimized) if shape
                         else MeshSpec()),
                   checkpoint=CheckpointSpec(dir=ckpt, every=every,
                                             resume=True))


def cut_arch(layers: int, dtype=None, arch_id=ARCH_ID):
    """danube (or ``arch_id``) at its published width, ``layers`` deep
    (an encoder-decoder: ``layers`` in each stack), in its own dtype (bf16)
    unless ``dtype`` is given."""
    arch = get_arch(arch_id)
    depth = ({"n_enc_layers": layers, "n_dec_layers": layers}
             if arch.family == "encdec" else {"n_layers": layers})
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, **depth, dtype=dtype or arch.cfg.dtype))


def within(a, b, *, rtol, atol) -> tuple:
    """(ok, max abs difference): |a - b| <= atol + rtol |b|, widened to
    fp32; for a bf16 leaf one bf16 ulp of b is allowed beside it (one
    rounding of the write landing on the other side)."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    lim = atol + rtol * b32.abs()
    if b.dtype == torch.bfloat16:
        lim = lim + bf16_ulp(b32)
    diff = (a32 - b32).abs()
    return bool((diff <= lim).all()), float(diff.max()) if diff.numel() \
        else 0.0


def bf16_gap_readings(got, want, want32) -> dict:
    """How far the bf16 leaves ``got`` lie from ``want`` (the unsharded
    bf16 run's), against how far bf16 itself moves that run: the largest
    ratio over the leaves of the root-mean-square distance from ``want``
    to ``want``'s own from an fp32 run of the same seed (``want32``; the
    check: at most 1), and the elements outside within()'s limit (a
    reading: two ranks' bf16 partial sums, added in fp32 and rounded once,
    leave some params two ulps from the one-rank rounding)."""
    outside, ratio = 0, 0.0
    for a, b, b32 in zip(got, want, want32):
        a32, b16 = a.to(torch.float32), b.to(torch.float32)
        diff = (a32 - b16).abs()
        lim = DIST_PARAM_TOL["atol"] + DIST_PARAM_TOL["rtol"] * b16.abs() \
            + bf16_ulp(b16)
        outside += int((diff > lim).sum())
        gap = float(torch.sqrt(torch.mean(torch.square(
            b16 - b32.to(torch.float32)))))
        rms = float(torch.sqrt(torch.mean(torch.square(diff))))
        if rms:
            ratio = max(ratio, rms / gap if gap else math.inf)
    return {"max_rms_ratio_to_bf16_fp32_gap": ratio,
            "elements_outside_tol": outside}


class HostProbe:
    """What the host did over a run: the time Python's collector took, the
    caching allocator's cudaMalloc retries and device allocations and
    frees, the process's CPU seconds, and the state it started from (the
    allocator's reserved bytes, the live Python objects)."""

    KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
            "num_sync_all_streams")

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        stats = torch.cuda.memory_stats()
        self.before = {k: stats.get(k, 0) for k in self.KEYS}
        self.start = {"reserved_bytes": torch.cuda.memory_reserved(),
                      "python_objects": len(gc.get_objects())}
        self.cpu0 = time.process_time()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def close(self, *, step_seconds) -> dict:
        gc.callbacks.remove(self._on_gc)
        stats = torch.cuda.memory_stats()
        return {"step_seconds": step_seconds, **self.start,
                "process_cpu_seconds": time.process_time() - self.cpu0,
                "gc_seconds": self.gc_s, "gc_collections": self.gc_n,
                **{k: stats.get(k, 0) - v for k, v in self.before.items()}}


# --------------------------------------------------------------------------
# the dry run beside the card: the same spec traced on the meta device
# (repro_torch/launch/dryrun.py) in the process that ran it
# --------------------------------------------------------------------------

# the dry trace's step peak held within this share of the card's, in train
# and in the data axis' gloo_2rank
DRY_PEAK_RTOL = 0.15
DRY_STAT_KEYS = ("calls", "gather_bytes", "scatter_bytes", "reduce_bytes")


_DRY_WARM = []


def dry_warmup() -> None:
    """Start importing, beside this process's live run, what its first dry
    trace would import (``torch._dynamo``, which the meta device's
    reference kernels load at their first use: a few seconds), so that the
    readings cost the traces' own time."""
    import importlib
    import threading
    th = threading.Thread(target=importlib.import_module,
                          args=("torch._dynamo",), daemon=True)
    th.start()
    _DRY_WARM.append(th)


def launch_counts() -> dict:
    out = sharded_launches()
    out["mode3"] = K.adalomo_stats_partial.both_launches
    return out


class StepMeter:
    """While active (a context), each step of the programs ``run`` builds
    (and of those given to :meth:`attach`): what it added to the
    collectives' STATS (``DRY_STAT_KEYS``: gloo's host staging apart) and
    to the K1/K2 counts, and the allocator's peak over the step (it is
    reset before each step; :meth:`run_peak` is the peak since the meter
    started, as one reading of ``max_memory_allocated`` would give it).
    ``base`` is what the process held when the meter started."""

    def __init__(self):
        from repro_torch.fleet import elastic
        from repro_torch.run import runner
        self.steps = []
        self._peak = 0
        self._mods = (elastic, runner)

    def __enter__(self):
        self.base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self._orig = self._mods[0].build_step_program

        def build(*a, **k):
            return self.attach(self._orig(*a, **k))

        for m in self._mods:
            m.build_step_program = build
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.build_step_program = self._orig
        self._peak = self.run_peak()
        self._done = True

    def attach(self, program):
        from repro_torch.sharding import collectives as C
        inner = program.step

        def step(*a, **k):
            s0, l0 = dict(C.STATS), launch_counts()
            self._peak = max(self._peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = inner(*a, **k)
            l1 = launch_counts()
            self.steps.append({
                "stats": {k: C.STATS[k] - s0[k] for k in DRY_STAT_KEYS},
                "launches": {k: l1[k] - l0[k] for k in l1 if l1[k] - l0[k]},
                "peak_bytes": torch.cuda.max_memory_allocated()})
            return out

        program.step = step
        return program

    def run_peak(self) -> int:
        if getattr(self, "_done", False):
            return self._peak
        return max(self._peak, torch.cuda.max_memory_allocated())


def dry_reading(spec, meter, *, arch=None, mesh=None, rank=0) -> dict:
    """Rank ``rank`` of ``spec`` traced on the meta device, its first
    step (each step of the card held to it: these specs' steps are alike),
    beside what ``meter`` measured of the same run on the card:
    ``counts_equal`` (every step's collectives and K1/K2 launches), the
    step peaks (the card's less what the process held before the run) and
    the run's peaks (the dry one the larger of the init's and the
    steps')."""
    from repro_torch.launch import dryrun as D
    for th in _DRY_WARM:
        th.join()
    t0 = time.time()
    tr = D.trace_train(spec, arch=arch, mesh=mesh, rank=rank, steps=1)
    dry = [{"stats": {k: p["stats"][k] for k in DRY_STAT_KEYS},
            "launches": p["launches"]} for p in tr.per_step]
    live = [{k: s[k] for k in ("stats", "launches")} for s in meter.steps]
    if len(dry) < len(live):
        dry = dry + [dry[-1]] * (len(live) - len(dry))
    step_peak = max(s["peak_bytes"] for s in meter.steps) - meter.base
    peak = max(tr.peak_bytes, tr.init_peak_bytes)
    out = {"counts_equal": dry == live, "steps": len(live),
           "dry_step": dry[0], "card_step": live[0],
           "step_peak_bytes": step_peak, "dry_step_peak_bytes": tr.peak_bytes,
           "step_peak_ratio": tr.peak_bytes / step_peak,
           "run_peak_bytes": meter.run_peak() - meter.base,
           "dry_peak_bytes": peak,
           "peak_ratio": peak / (meter.run_peak() - meter.base),
           "dry_resting_bytes": tr.resting_bytes,
           "base_bytes": meter.base, "dry_seconds": time.time() - t0}
    if not out["counts_equal"]:
        out["dry_steps"], out["card_steps"] = dry, live
    return out


def dry_failures(where: str, readings, *, hold_peak: bool) -> list:
    """What a sub-phase's dry readings (one a rank) fail: counts that are
    not the card's, or (``hold_peak``) a step peak beyond DRY_PEAK_RTOL."""
    out = []
    for r, d in enumerate(readings):
        if not d["counts_equal"]:
            out.append(f"{where} rank {r}: the dry plan's collectives or "
                       f"launches {d.get('dry_steps')} are not the card's "
                       f"{d.get('card_steps')}")
        if hold_peak and abs(d["step_peak_ratio"] - 1) > DRY_PEAK_RTOL:
            out.append(f"{where} rank {r}: dry step peak "
                       f"{d['dry_step_peak_bytes']} against the card's "
                       f"{d['step_peak_bytes']}")
    return out


def dist_nccl(train) -> dict:
    """run(spec) on a one-rank NCCL world at full width and depth, twice,
    against the train phase's unsharded run of the same seed."""
    from repro_torch.sharding import collectives as C
    out = {}
    digests, host = [], []
    for attempt in range(2):
        reset_launches()
        C.reset_stats()
        timing = TimingHook()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        probe = HostProbe()
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    StepMeter() as meter:
                warnings.simplefilter("always")
                res = run(dist_spec(DIST_STEPS, shape=(1,)), hooks=[timing],
                          device=DEV,
                          log_fn=lambda s: print("  " + s, flush=True))
                launches = sharded_launches()
                stats = dict(C.STATS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            host.append(probe.close(step_seconds=timing.step_s))
        torch.cuda.synchronize()
        peak = meter.run_peak()                     # before the checks
        digests.append(device_digest((res.params, res.opt_state)))
        if attempt == 0:
            syncs = n_syncs(caught)
            ok_p, worst, bitwise = True, 0.0, True
            for a, b in zip(tree_leaves(res.params), train["params_cpu"]):
                b = b.to(DEV)
                ok, d = within(a, b, **DIST_PARAM_TOL)
                ok_p &= ok
                worst = max(worst, d)
                bitwise &= bool(torch.equal(a, b))
            losses = res.history["loss"]
            loss_err = max(abs(x - y) / abs(y)
                           for x, y in zip(losses, train["losses"]))
            out = {"losses": losses, "train_losses": train["losses"],
                   "loss_max_rel_err": loss_err,
                   "param_max_abs_diff": worst, "params_within_tol": ok_p,
                   "params_bitwise_vs_train": bitwise,
                   "launches": launches,
                   "launches_per_step": {k: v / DIST_STEPS
                                         for k, v in launches.items()},
                   "collectives_per_step": {k: v / DIST_STEPS
                                            for k, v in stats.items()},
                   "host_syncs": syncs,
                   "step_seconds": timing.step_s,
                   "train_step_seconds": train["step_seconds"],
                   "peak_memory_bytes": peak,
                   "train_peak_memory_bytes": train["peak_memory_bytes"],
                   "dry": dry_reading(dist_spec(DIST_STEPS, shape=(1,)),
                                      meter, mesh=(1,))}
        del res
        gc.collect()
        torch.cuda.empty_cache()
    out["rerun_bitwise"] = bool(torch.equal(digests[0], digests[1]))
    out["host"] = host
    emit("dist", sub="nccl_1rank", arch=ARCH_ID, mesh=[1], batch=4, seq=1024,
         steps=DIST_STEPS, tolerance={"loss_rtol": DIST_LOSS_RTOL,
                                      **DIST_PARAM_TOL,
                                      "bf16": "plus one bf16 ulp of the value"},
         **out)
    if out["loss_max_rel_err"] > DIST_LOSS_RTOL or not out[
            "params_within_tol"]:
        raise AssertionError(f"dist nccl: loss rel err "
                             f"{out['loss_max_rel_err']}, params within "
                             f"tolerance {out['params_within_tol']} "
                             f"(max diff {out['param_max_abs_diff']})")
    if not out["rerun_bitwise"]:
        raise AssertionError("dist nccl: a re-run gave other bits")
    if out["host_syncs"] != DIST_STEPS:
        raise AssertionError(f"dist nccl: {out['host_syncs']} host syncs in "
                             f"{DIST_STEPS} steps, expected one a step")
    want = TENSORS_PER_STEP * DIST_STEPS
    if any(out["launches"][k] != want for k in SHARDED_WRAPPERS) or \
            out["launches"]["adalomo_stats"] or \
            out["launches"]["adalomo_update"]:
        raise AssertionError(f"dist nccl: launches {out['launches']}, "
                             f"expected {want} of each sharded entry")
    failed = dry_failures("dist nccl", [out["dry"]], hold_peak=False)
    if failed:
        raise AssertionError("; ".join(failed))
    return out


# the two gloo ranks' runs: danube's own bf16 (checkpoints every step, for
# the elastic restores), then fp32 (a checkpoint at the end, to read
# the params at the reference's sharded tolerance)
DIST_GLOO_RUNS = (("bfloat16", None, "ck", DIST_CKPT_STEP),
                  ("float32", torch.float32, "ck32", DIST_GLOO_STEPS))
DIST_GLOO_JOB = dict(shape=(2,), layers=DIST_GLOO_LAYERS,
                     steps=DIST_GLOO_STEPS, runs=DIST_GLOO_RUNS,
                     arch=ARCH_ID, batch=4, tag="")


def dist_gloo_rank(rank: int, world: int, store: str, root: str,
                   jobs: list) -> None:
    """One of the gloo ranks sharing the card (spawned): the runs of each
    of ``jobs`` in turn, in one world, each rank writing what it measured
    to ``rank{r}_{tag}{name}.json``.  A run's fifth item, where it has
    one, is its plan's ``MeshSpec.optimized`` (False: the baseline).
    ``job["against"]``: the step directory of an unsharded run's
    checkpoint, which each rank's final blocks are counted against
    (:func:`blocks_against`)."""
    import torch.distributed as dist
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.sharding import collectives as C
    dry_warmup()
    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for job, (name, dtype, ck, every, *plan) in [
                (j, r) for j in jobs for r in j["runs"]]:
            if job.get("serve"):
                for part in serve_parts(job):
                    serve_rank(rank, part, root)
                continue
            reset_launches()
            C.reset_stats()
            timing, watch = TimingHook(), moe_watch(-1)
            t_job = time.time()
            spec = dist_spec(job["steps"], shape=tuple(job["shape"]),
                             ckpt=os.path.join(root, ck), every=every,
                             arch_id=job["arch"], batch=job["batch"],
                             seq=job.get("seq", 1024),
                             optimized=plan[0] if plan else True)
            arch = cut_arch(job["layers"], dtype, job["arch"])
            with StepMeter() as meter:
                res = run(spec, arch=arch, hooks=[timing, watch], device=DEV,
                          log_fn=lambda s: None)
            torch.cuda.synchronize()
            zero = res.program.zero
            places = [pl for _, pl in tree_flatten_with_path(zero.dims)]
            whole = [t for t, pl in zip(tree_leaves(res.params), places)
                     if pl.whole]
            rec = {"losses": res.history["loss"],
                   "step_seconds": timing.step_s,
                   "peak_memory_bytes": meter.run_peak(),
                   "local_param_bytes": sum(
                       t.numel() * t.element_size()
                       for t in tree_leaves(res.params)),
                   "whole_leaves": len(whole),
                   "whole_digest": device_digest(whole).tolist(),
                   "collectives": dict(C.STATS),
                   "launches": sharded_launches(),
                   "mode3_launches": K.adalomo_stats_partial.both_launches,
                   "gathers": {f"{a}/{k}": n for (a, k), n
                               in sorted(zero.gathers.items())},
                   "tile": zero.tile and list(zero.tile),
                   "frame_tile": zero.frame_tile and list(zero.frame_tile),
                   "run_seconds": time.time() - t_job,
                   "aux_losses": watch.aux, "mtp_losses": watch.mtp,
                   "allocated_at_run_start_bytes": watch.start_bytes}
            if job.get("against"):
                rec["against"] = blocks_against(res.params, zero,
                                                job["against"])
            rec["dry"] = dry_reading(spec, meter, arch=arch,
                                     mesh=tuple(job["shape"]), rank=rank)
            with open(os.path.join(root, f"rank{rank}_{job['tag']}{name}"
                                   ".json"), "w") as f:
                json.dump(rec, f)
            del res, whole
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def start_gloo(world: int, root: str, jobs: list, target=None) -> tuple:
    """``world`` gloo ranks on the card running ``jobs`` in turn
    (``target``, default dist_gloo_rank), started and not waited for:
    ``(world, context, start time)`` for :func:`wait_gloo`."""
    import torch.multiprocessing as mp
    t0 = time.time()
    store = os.path.join(root, f"store_{jobs[0]['tag']}")
    ctx = mp.spawn(target or dist_gloo_rank, args=(world, store, root, jobs),
                   nprocs=world, join=False)
    return world, ctx, t0


def wait_gloo(started: tuple, timeout=DIST_GLOO_TIMEOUT_S) -> float:
    """The ranks of :func:`start_gloo` joined, killed if they are not done
    ``timeout`` seconds after their start; returns their wall seconds."""
    world, ctx, t0 = started
    try:
        while not ctx.join(timeout=2.0):
            if time.time() - t0 > timeout:
                raise AssertionError(f"dist gloo: the {world} ranks did not "
                                     f"finish in {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return time.time() - t0


def spawn_gloo(world: int, root: str, jobs: list,
               timeout=DIST_GLOO_TIMEOUT_S, target=None) -> float:
    """``world`` gloo ranks on the card running ``jobs`` in turn
    (``target``, default dist_gloo_rank), killed after ``timeout``
    seconds; returns the wall seconds."""
    return wait_gloo(start_gloo(world, root, jobs, target), timeout)


def checkpoint_leaves_equal(tree, step_dir) -> bool:
    """Every leaf of ``tree`` (whole tensors) bitwise equal to the
    checkpoint's file of it."""
    from repro_torch.core.tree import pytree_leaves
    files = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))
    leaves = pytree_leaves(tree)
    if len(files) != len(leaves):
        return False
    for t, f in zip(leaves, files):
        a = np.load(os.path.join(step_dir, f))
        # a bf16 leaf's file holds its raw 16-bit words (descr <V2)
        a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            if t.dtype == torch.bfloat16 else torch.from_numpy(a)
        if not torch.equal(t.detach().cpu(), a):
            return False
    return True


def dist_gloo_and_elastic(root) -> dict:
    """Two gloo ranks on the card on (2,), then in the same world on
    (1, 2) (read by :func:`dist_model_axis`), against the unsharded run
    at the same depth; then the two-rank step-1 checkpoint restored onto
    the one-rank NCCL world and onto no mesh, bitwise, and continued.
    Prints the two lines, then fails if a check did not hold.  Returns the
    unsharded bf16 and fp32 runs' losses and params, ``{"bf16": (losses,
    params), "fp32": ..., "spawn_seconds": the world's}``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.run.program import build_step_program
    from repro_torch.sharding.zero import Zero3
    arch = cut_arch(DIST_GLOO_LAYERS)
    # the model axis' (1, 2) danube runs (dist_model_axis) in the same
    # world, after the data axis' own
    spawn_s = spawn_gloo(2, root, [DIST_GLOO_JOB, dict(
        DIST_MODEL_JOBS["model_1x2"], tag="m12_")],
        timeout=2 * DIST_GLOO_TIMEOUT_S)
    ranks, ranks32 = ([json.loads(open(os.path.join(
        root, f"rank{r}_{name}.json")).read()) for r in range(2)]
        for name, *_ in DIST_GLOO_RUNS)
    torch.cuda.reset_peak_memory_stats()
    ref = run(dist_spec(DIST_GLOO_STEPS), arch=arch, device=DEV,
              log_fn=lambda s: None)
    ref_peak = torch.cuda.max_memory_allocated()
    # the same seed in fp32: how far bf16 itself moves the unsharded run
    ref32 = run(dist_spec(DIST_GLOO_STEPS),
                arch=cut_arch(DIST_GLOO_LAYERS, torch.float32), device=DEV,
                log_fn=lambda s: None)
    losses = ranks[0]["losses"]
    ref_losses = ref.history["loss"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
    # each step's loss within rtol 1e-5, or within the unsharded run's own
    # bf16-vs-fp32 distance at that step
    loss_ok = all(abs(x - y) <= max(DIST_LOSS_RTOL * abs(y), abs(y - z))
                  for x, y, z in zip(losses, ref_losses,
                                     ref32.history["loss"]))
    loss_gap = max(abs(x - y) / abs(y) for x, y in
                   zip(ref_losses, ref32.history["loss"]))
    opt = opt_lib.get_opt("adalomo")
    ck = os.path.join(root, "ck")
    _, tree, _ = CheckpointManager(ck).restore(
        DIST_GLOO_STEPS, template=(ref.params, opt.init(ref.params)))
    ok_p, worst = True, 0.0
    for a, b in zip(tree_leaves(tree[0]), tree_leaves(ref.params)):
        ok, d = within(a, b, **DIST_PARAM_TOL)
        ok_p &= ok
        worst = max(worst, d)
    readings = bf16_gap_readings(tree_leaves(tree[0]),
                                 tree_leaves(ref.params),
                                 tree_leaves(ref32.params))
    # fp32: the reference's sharded tolerance
    _, tree32, _ = CheckpointManager(os.path.join(root, "ck32")).restore(
        DIST_GLOO_STEPS, template=(ref32.params, opt.init(ref32.params)))
    ok32, worst32 = True, 0.0
    for a, b in zip(tree_leaves(tree32[0]), tree_leaves(ref32.params)):
        ok, d = within(a, b, **DIST_PARAM_TOL)
        ok32 &= ok
        worst32 = max(worst32, d)
    losses32 = ranks32[0]["losses"]
    fp32 = {"losses": losses32, "unsharded_losses": ref32.history["loss"],
            "loss_max_rel_err": max(abs(x - y) / abs(y) for x, y in zip(
                losses32, ref32.history["loss"])),
            "param_max_abs_diff": worst32, "params_within_tol": ok32,
            "replicated_bitwise_across_ranks":
                ranks32[0]["whole_digest"] == ranks32[1]["whole_digest"],
            "rank_peak_memory_bytes": [r["peak_memory_bytes"]
                                       for r in ranks32],
            "rank_step_seconds": [r["step_seconds"] for r in ranks32],
            "rank_collectives": [r["collectives"] for r in ranks32],
            "dry": [r["dry"] for r in ranks32]}
    del tree32
    leaves = tree_leaves(ref.params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    layer = [t[0] for t in tree_leaves(ref.params["stacks"])]
    reckoning = n_bytes // 2 + sum(t.numel() * (t.element_size() + 4)
                                   for t in layer)
    # the unsharded runs at this depth, for the model axis' two ranks
    refs = {"bf16": (ref_losses, ref.params),
            "fp32": (ref32.history["loss"], ref32.params),
            "spawn_seconds": spawn_s}
    del ref, ref32, tree, leaves, layer
    gc.collect()
    torch.cuda.empty_cache()

    # elastic: the step-1 checkpoint onto the one-rank world and no mesh
    src = os.path.join(ck, f"step_{DIST_CKPT_STEP:09d}")
    spec = dist_spec(DIST_GLOO_STEPS, shape=(1,))
    zero = Zero3(make_mesh((1,), DEV), arch.init_params(0, device="meta"))
    program = build_step_program(spec, arch, device=DEV, zero=zero)
    tree = program.init(0)
    CheckpointManager(ck, zero=zero).restore_into(tree, step=DIST_CKPT_STEP)
    onto_one = checkpoint_leaves_equal(tree, src)
    del tree, program
    params = arch.init_params(0, device=DEV)
    tree = (params, opt.init(params))
    CheckpointManager(ck).restore_into(tree, step=DIST_CKPT_STEP)
    onto_none = checkpoint_leaves_equal(tree, src)
    del tree, params
    cont = {}
    for name, shape in (("one_rank_nccl", (1,)), ("no_mesh", None)):
        d = os.path.join(root, "cont_" + name)
        os.makedirs(d)
        shutil.copytree(src, os.path.join(d, os.path.basename(src)))
        res = run(dist_spec(DIST_GLOO_STEPS, shape=shape, ckpt=d,
                            every=DIST_CKPT_STEP),
                  arch=arch, device=DEV, log_fn=lambda s: None)
        cont[name] = {
            "steps": res.history["step"], "losses": res.history["loss"],
            "loss_max_rel_err": max(
                abs(x - y) / abs(y) for x, y in
                zip(res.history["loss"], losses[DIST_CKPT_STEP:]))}
        del res
        gc.collect()
        torch.cuda.empty_cache()
    out = {
        "n_layers": DIST_GLOO_LAYERS, "dtype": str(arch.cfg.dtype)[6:],
        "spawn_seconds": spawn_s, "losses": losses,
        "unsharded_losses": ref_losses, "loss_max_rel_err": loss_err,
        "unsharded_bf16_vs_fp32_loss_max_rel_err": loss_gap,
        "bound": "each step's loss within rtol 1e-5 of the unsharded bf16 "
                 "run's or within that run's distance from fp32; each "
                 "leaf's RMS distance from the unsharded bf16 run at most "
                 "that run's own from fp32; params_within_tol (rtol 5e-4, "
                 "atol 1e-5, one ulp) is read, not held",
        "losses_within_bound": loss_ok, "param_max_abs_diff": worst,
        "params_within_tol": ok_p, **readings,
        "replicated_leaves": ranks[0]["whole_leaves"],
        "replicated_bitwise_across_ranks":
            ranks[0]["whole_digest"] == ranks[1]["whole_digest"],
        "rank_peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "rank_local_param_bytes": [r["local_param_bytes"] for r in ranks],
        "reckoning_bytes": reckoning,
        "reckoning": "half the params + one whole layer + the fp32 "
                     "gradient of one layer",
        "unsharded_peak_memory_bytes": ref_peak,
        "rank_step_seconds": [r["step_seconds"] for r in ranks],
        "rank_collectives": [r["collectives"] for r in ranks],
        "rank_launches": [r["launches"] for r in ranks],
        "dry": [r["dry"] for r in ranks],
        "float32": fp32,
        "elastic": {"checkpoint_step": DIST_CKPT_STEP,
                    "restore_onto_one_rank_bitwise": onto_one,
                    "restore_onto_no_mesh_bitwise": onto_none,
                    "continued": cont}}
    elastic = out.pop("elastic")
    emit("dist", sub="gloo_2rank", arch=ARCH_ID, mesh=[2], batch=4, seq=1024,
         steps=DIST_GLOO_STEPS, **out)
    emit("dist", sub="elastic", arch=ARCH_ID, from_mesh=[2],
         onto=["one-rank NCCL world", "no mesh"], **elastic)
    if not loss_ok or readings["max_rms_ratio_to_bf16_fp32_gap"] > 1.0:
        raise AssertionError(
            f"dist gloo: losses within their bound {loss_ok} (rel err "
            f"{loss_err}, bf16 vs fp32 {loss_gap}); params' RMS distance "
            f"{readings['max_rms_ratio_to_bf16_fp32_gap']} of bf16's own")
    if fp32["loss_max_rel_err"] > DIST_LOSS_RTOL or not ok32:
        raise AssertionError(f"dist gloo fp32: loss rel err "
                             f"{fp32['loss_max_rel_err']}, params within "
                             f"tolerance {ok32} (max diff {worst32})")
    if not (out["replicated_bitwise_across_ranks"]
            and fp32["replicated_bitwise_across_ranks"]):
        raise AssertionError("dist gloo: a replicated leaf differs between "
                             "the ranks")
    if not (onto_one and onto_none):
        raise AssertionError(f"dist elastic: restore bitwise onto one rank "
                             f"{onto_one}, onto no mesh {onto_none}")
    failed = (dry_failures("dist gloo_2rank", out["dry"], hold_peak=True)
              + dry_failures("dist gloo_2rank fp32", fp32["dry"],
                             hold_peak=False))
    if failed:
        raise AssertionError("; ".join(failed))
    for name, c in cont.items():
        if c["steps"] != list(range(DIST_CKPT_STEP, DIST_GLOO_STEPS)) or \
                c["loss_max_rel_err"] > DIST_LOSS_RTOL:
            raise AssertionError(f"dist elastic {name}: {c}")
    return refs


# The model axis on the card: gloo ranks sharing it, each rank its rows and
# sequence tile, 2-D ZeRO-3 blocks, K/V gathered over ``model``, the MoE
# experts expert-parallel.  (a) danube on (1, 2), bf16 then fp32, against
# the data-axis sub-phase's unsharded runs; (b) danube on (2, 2), fp32,
# the only mesh of the three where a leaf is split both ways (K1 mode 3);
# (c) deepseek-moe-16b on (1, 2), fp32.
DIST_MODEL_JOBS = {
    "model_1x2": dict(shape=(1, 2), layers=DIST_GLOO_LAYERS,
                      steps=DIST_GLOO_STEPS, arch=ARCH_ID, batch=4,
                      runs=(("bfloat16", None, "m12", DIST_GLOO_STEPS),
                            ("float32", torch.float32, "m12_32",
                             DIST_GLOO_STEPS))),
    "model_2x2": dict(shape=(2, 2), layers=2, steps=2, arch=ARCH_ID, batch=4,
                      runs=(("float32", torch.float32, "m22", 2),)),
    "moe_1x2": dict(shape=(1, 2), layers=2, steps=2, arch=MOE_ID, batch=2,
                    runs=(("float32", torch.float32, "moe12", 2),)),
    # (e) 64 experts over 3 model ranks: every rank runs all of them; the
    # sequence (768 = 3 x 256) divides over the ranks
    "model_moe_1x3": dict(shape=(1, 3), layers=2, steps=2, arch=MOE_ID,
                          batch=2, seq=768,
                          runs=(("float32", torch.float32, "moe13", 2),)),
    # (f) paligemma-3b's prefix on the tiles: the 256 + 1024 rows tiled in
    # two, tile 0 the 256 patches and 384 tokens, tile 1 640 tokens
    "model_prefix_1x2": dict(shape=(1, 2), side=1, layers=2, steps=2,
                             arch=PALI_ID,
                             batch=4, tile=[4, 640],
                             runs=(("float32", torch.float32, "pre12", 2),)),
    # (g) mamba2-1.3b: each rank's mixer on the sequence gathered whole
    "model_ssm_1x2": dict(shape=(1, 2), side=1, layers=2, steps=2,
                          arch=SSM_IDS[0],
                          batch=4, tile=[4, 512],
                          runs=(("float32", torch.float32, "ssm12", 2),)),
    # (h) zamba2-1.2b at 7 layers: its shared block applied at layers 0 and
    # 6, its gradients summed over both on each rank before the scatter
    "model_hybrid_1x2": dict(shape=(1, 2), side=1, layers=7, steps=2,
                             arch=SSM_IDS[1], batch=4, tile=[4, 512],
                             runs=(("float32", torch.float32, "hyb12", 2),)),
    # (i) whisper-base at full depth (6 + 6): 448 tokens over 1500 frames,
    # each sequence tiled in two along its own length
    "model_encdec_1x2": dict(shape=(1, 2), layers=6, steps=2, arch=ENCDEC_ID,
                             batch=4, seq=ENCDEC_TRAIN[1], tile=[4, 224],
                             frame_tile=[4, 750],
                             runs=(("float32", torch.float32, "enc12", 2),)),
    # (j) the paper-faithful baseline sharding (MeshSpec.optimized=False):
    # danube at 2 layers, each rank its rows' whole sequence, whole
    # gradients all-reduced; then the optimized plan at the same depth,
    # for its peak and collectives beside the baseline's
    "baseline_1x2": dict(shape=(1, 2), side=1, layers=2, steps=2,
                         arch=ARCH_ID,
                         batch=4,
                         runs=(("float32", torch.float32, "base12", 2, False),
                               ("optimized", torch.float32, "base12o", 2,
                                True))),
    # (k) per-rank prefill and decode (serve/sharded.py): danube at 2
    # layers, fp32, 4 x 6136 tokens into a ring of 4096 slots, 2048 a rank;
    # the first decode slot is 2040, so the 16 greedy steps' writes cross
    # from rank 0's block into rank 1's at step 9
    "serve_1x2": dict(shape=(1, 2), layers=2, steps=16, arch=ARCH_ID,
                      batch=4, seq=6136, serve=True,
                      runs=(("float32", torch.float32, "serve12", 0),)),
    # (l) the state-space families' per-rank serving, in (g)'s world:
    # mamba2-1.3b at 2 layers (its 64 SSM heads 32 a rank), 4 x 1024
    # tokens, 8 decode steps; zamba2-1.2b at 7 layers, 4 x 1016 tokens into
    # a ring of 1024 slots, 512 a rank: the first 8 decode writes fill rank
    # 1's slots 1016-1023, the 9th wraps into rank 0's slot 0
    "serve_ssm_1x2": dict(shape=(1, 2), side=1, batch=4, serve=True,
                          parts=(dict(model="mamba2", arch=SSM_IDS[0],
                                      layers=2, seq=1024, steps=8),
                                 dict(model="zamba2", arch=SSM_IDS[1],
                                      layers=7, seq=1016, steps=10,
                                      prefill=dict(max_len=1024))),
                          runs=(("float32", torch.float32, "servessm12", 0),)),
    # (m) whisper-base at full depth, in (i)'s world: 4 x 1500 frames, 750
    # a rank (the cross cache split over model), a self ring of 16 slots,
    # 8 a rank: rank 1's empty until the 9th of 12 decode steps
    "serve_encdec_1x2": dict(shape=(1, 2), batch=4, serve=True,
                             parts=(dict(model="whisper", arch=ENCDEC_ID,
                                         layers=6, steps=12,
                                         prefill=dict(max_decode_len=16)),),
                             runs=(("float32", torch.float32, "serveenc12",
                                    0),)),
}
# every family beside the transformer's on a model axis
FAMILY_SUBS = ("model_prefix_1x2", "model_ssm_1x2", "model_hybrid_1x2",
               "model_encdec_1x2")
# the fp32 sub-phases each held against its own unsharded run
# (dist_model_runs): (b), (c), (f)-(i), (j), (k), (l), (m) and (e), one
# world for each mesh, two side by side on (1, 2) (``side``)
MODEL_RUN_SUBS = ("model_2x2", "moe_1x2", *FAMILY_SUBS, "baseline_1x2",
                  "serve_1x2", "serve_ssm_1x2", "serve_encdec_1x2",
                  "model_moe_1x3")


def model_axis_readings(ranks: list, steps: int) -> dict:
    """What each rank of a model-axis run measured, a step where it is a
    count."""
    return {
        "rank_peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "rank_local_param_bytes": [r["local_param_bytes"] for r in ranks],
        "rank_step_seconds": [r["step_seconds"] for r in ranks],
        "collectives_per_step": [{k: v / steps for k, v in
                                  r["collectives"].items()} for r in ranks],
        "mode3_launches": [r["mode3_launches"] for r in ranks],
        "mode3_launches_per_step": [r["mode3_launches"] / steps
                                    for r in ranks],
        "launches_per_step": [{k: v / steps for k, v in r["launches"].items()}
                              for r in ranks],
        "gathers": ranks[0]["gathers"],
        "rank_tiles": [r["tile"] for r in ranks],
        "rank_frame_tiles": [r["frame_tile"] for r in ranks],
        "rank_run_seconds": [r["run_seconds"] for r in ranks],
        "replicated_leaves": ranks[0]["whole_leaves"],
        "replicated_bitwise_across_ranks": all(
            r["whole_digest"] == ranks[0]["whole_digest"] for r in ranks),
        "dry": [r["dry"] for r in ranks]}


def params_within(tree, want) -> tuple:
    """(all within DIST_PARAM_TOL, max abs difference) leaf by leaf."""
    ok_all, worst = True, 0.0
    for a, b in zip(tree_leaves(tree), tree_leaves(want)):
        ok, d = within(a, b, **DIST_PARAM_TOL)
        ok_all &= ok
        worst = max(worst, d)
    return ok_all, worst


def restored_params(root, ck, step, like):
    from repro_torch.checkpoint.manager import CheckpointManager
    _, tree, _ = CheckpointManager(os.path.join(root, ck)).restore(
        step, template=(like, opt_lib.get_opt("adalomo").init(like)))
    return tree[0]


def dist_model_axis(root, refs) -> None:
    """The model axis' sub-phase (a): danube on (1, 2), its ranks run in
    :func:`dist_gloo_and_elastic`'s world, bf16 as the data axis' two
    ranks are held, then fp32 at the reference's sharded tolerance.
    Prints its line before it can fail."""
    job = DIST_MODEL_JOBS["model_1x2"]
    spawn_s = refs["spawn_seconds"]
    ranks, ranks32 = ([json.loads(open(os.path.join(
        root, f"rank{r}_m12_{name}.json")).read()) for r in range(2)]
        for name, *_ in job["runs"])
    (ref_l, ref_p), (ref32_l, ref32_p) = refs["bf16"], refs["fp32"]
    losses, losses32 = ranks[0]["losses"], ranks32[0]["losses"]
    loss_ok = all(abs(x - y) <= max(DIST_LOSS_RTOL * abs(y), abs(y - z))
                  for x, y, z in zip(losses, ref_l, ref32_l))
    got = restored_params(root, "m12", DIST_GLOO_STEPS, ref_p)
    readings = bf16_gap_readings(tree_leaves(got), tree_leaves(ref_p),
                                 tree_leaves(ref32_p))
    del got
    got32 = restored_params(root, "m12_32", DIST_GLOO_STEPS, ref32_p)
    ok32, worst32 = params_within(got32, ref32_p)
    del got32
    loss32_err = max(abs(x - y) / abs(y) for x, y in zip(losses32, ref32_l))
    a = {"spawn_seconds": spawn_s, "world": ["gloo_2rank", "model_1x2"],
         "losses": losses,
         "unsharded_losses": ref_l, "losses_within_bound": loss_ok,
         "loss_max_rel_err": max(abs(x - y) / abs(y)
                                 for x, y in zip(losses, ref_l)),
         **readings, "bf16": model_axis_readings(ranks, DIST_GLOO_STEPS),
         "float32": {"losses": losses32, "unsharded_losses": ref32_l,
                     "loss_max_rel_err": loss32_err,
                     "param_max_abs_diff": worst32,
                     "params_within_tol": ok32,
                     **model_axis_readings(ranks32, DIST_GLOO_STEPS)}}
    emit("dist", sub="model_1x2", arch=ARCH_ID, mesh=[1, 2], batch=4,
         seq=1024, steps=DIST_GLOO_STEPS, n_layers=DIST_GLOO_LAYERS,
         bound="bf16 as the data axis' two ranks (each step's loss within "
               "rtol 1e-5 or the unsharded run's bf16-vs-fp32 distance, "
               "each leaf's RMS distance at most bf16's own); fp32 at loss "
               "rtol 1e-5, params rtol 5e-4 / atol 1e-5", **a)
    if not loss_ok or readings["max_rms_ratio_to_bf16_fp32_gap"] > 1.0:
        raise AssertionError(f"dist model (1, 2) bf16: losses within bound "
                             f"{loss_ok}, params' RMS ratio "
                             f"{readings['max_rms_ratio_to_bf16_fp32_gap']}")
    if loss32_err > DIST_LOSS_RTOL or not ok32:
        raise AssertionError(f"dist model (1, 2) fp32: loss rel err "
                             f"{loss32_err}, params within tolerance {ok32} "
                             f"(max diff {worst32})")
    if not (a["bf16"]["replicated_bitwise_across_ranks"]
            and a["float32"]["replicated_bitwise_across_ranks"]):
        raise AssertionError("dist model (1, 2): a whole leaf differs "
                             "between the ranks")
    failed = (dry_failures("dist model_1x2", a["bf16"]["dry"],
                           hold_peak=False)
              + dry_failures("dist model_1x2 fp32", a["float32"]["dry"],
                             hold_peak=False))
    if failed:
        raise AssertionError("; ".join(failed))
    refs.clear()
    gc.collect()
    torch.cuda.empty_cache()


def dist_model_runs(root, subs, before_checks=None) -> dict:
    """The fp32 model-axis sub-phases ``subs`` (DIST_MODEL_JOBS), each
    against the unsharded run at its depth at the reference's sharded
    tolerance, printing its line before it can fail.  The sub-phases of
    one mesh run in one world, one after the other (one spawn, whose wall
    seconds each line's ``spawn_seconds`` gives), and are then checked in
    turn.  Where sub-phases of one mesh carry ``side`` (DIST_MODEL_JOBS),
    each side is a world of its own, the worlds side by side (for the time
    limit).  ``before_checks`` (if given) is called before the first
    check."""
    out = {}
    jobs = {sub: dict(DIST_MODEL_JOBS[sub], tag=sub + "_") for sub in subs}
    meshes = {}
    for sub in subs:
        groups = meshes.setdefault(tuple(jobs[sub]["shape"]), {})
        groups.setdefault(jobs[sub].get("side", 0), []).append(sub)
    for shape, groups in meshes.items():
        world = math.prod(shape)
        groups = list(groups.values())
        progress(f"dist: model axis on {shape}, "
                 + " beside ".join(f"[{', '.join(g)}]" for g in groups)
                 + f", each one world of {world} ranks")
        started = []
        try:
            for group in groups:
                started.append(start_gloo(world, root,
                                          [jobs[sub] for sub in group]))
            spawn_s = [wait_gloo(st, timeout=DIST_GLOO_TIMEOUT_S * len(g))
                       for st, g in zip(started, groups)]
        finally:
            for _, ctx, _ in started:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
        if before_checks is not None:
            before_checks()
            before_checks = None
        for group, s in zip(groups, spawn_s):
            for sub in group:
                out[sub] = dist_model_check(root, sub, jobs[sub], s, group)
    return out


def dist_model_check(root, sub, job, spawn_s, group) -> dict:
    """One fp32 model-axis sub-phase of :func:`dist_model_runs`, its ranks
    run in the world of ``group``: the unsharded run, the line, the
    checks."""
    if job.get("serve"):
        return serve_check(root, sub, job, spawn_s, group)
    t0 = time.time()
    world, (_, _, ck, *_) = math.prod(job["shape"]), job["runs"][0]
    seq = job.get("seq", 1024)
    ranks = [json.loads(open(os.path.join(
        root, f"rank{r}_{sub}_float32.json")).read())
        for r in range(world)]
    torch.cuda.reset_peak_memory_stats()
    timing = TimingHook()
    ref = run(dist_spec(job["steps"], arch_id=job["arch"],
                        batch=job["batch"], seq=seq),
              arch=cut_arch(job["layers"], torch.float32, job["arch"]),
              hooks=[timing], device=DEV, log_fn=lambda s: None)
    ref_peak = torch.cuda.max_memory_allocated()
    got = restored_params(root, ck, job["steps"], ref.params)
    ok, worst = params_within(got, ref.params)
    del got
    losses, ref_l = ranks[0]["losses"], ref.history["loss"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_l))
    rec = {"spawn_seconds": spawn_s, "world": list(group), "losses": losses,
           "unsharded_losses": ref_l, "loss_max_rel_err": loss_err,
           "param_max_abs_diff": worst, "params_within_tol": ok,
           "unsharded_peak_memory_bytes": ref_peak,
           "unsharded_step_seconds": timing.step_s,
           **model_axis_readings(ranks, job["steps"])}
    if sub == "model_moe_1x3" or sub in FAMILY_SUBS:
        rec["rank_reckoning"] = rank_reckoning(
            dist_spec(job["steps"], shape=tuple(job["shape"]),
                      arch_id=job["arch"], batch=job["batch"], seq=seq),
            cut_arch(job["layers"], torch.float32, job["arch"]))
    if sub == "model_moe_1x3":
        rec["aux_losses"] = ranks[0]["aux_losses"]
    if sub == "baseline_1x2":
        rec["optimized"] = optimized_beside(root, sub, job, world, ref_l)
    # the ranks' runs in the world and this process's unsharded run and
    # checks
    rec["seconds"] = max(rec["rank_run_seconds"]) + time.time() - t0
    emit("dist", sub=sub, arch=job["arch"], mesh=list(job["shape"]),
         batch=job["batch"], seq=seq, steps=job["steps"],
         n_layers=job["layers"], dtype="float32",
         tolerance={"loss_rtol": DIST_LOSS_RTOL, **DIST_PARAM_TOL},
         **rec)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    if loss_err > DIST_LOSS_RTOL or not ok:
        raise AssertionError(f"dist {sub}: loss rel err {loss_err}, "
                             f"params within tolerance {ok} (max diff "
                             f"{worst})")
    if not rec["replicated_bitwise_across_ranks"]:
        raise AssertionError(f"dist {sub}: a whole leaf differs between "
                             "the ranks")
    failed = dry_failures(f"dist {sub}", rec["dry"], hold_peak=False)
    if failed:
        raise AssertionError("; ".join(failed))
    if sub == "model_2x2" and not all(
            n > 0 for n in rec["mode3_launches_per_step"]):
        raise AssertionError(f"dist {sub}: K1 mode 3 launched "
                             f"{rec['mode3_launches_per_step']} a step")
    if sub == "moe_1x2" and (
            rec["gathers"].get("model/expert", 0)
            or not rec["gathers"].get("model/dense")):
        raise AssertionError(f"dist {sub}: gathers {rec['gathers']}: "
                             "an expert stack gathered over model")
    if sub == "baseline_1x2":
        baseline_failures(rec)
    if sub == "model_moe_1x3" and any(
            k.startswith("model/") for k in rec["gathers"]):
        # 64 experts, d_model 2048 and the vocabulary do not divide
        # by 3: every leaf rests whole, nothing is gathered over model
        raise AssertionError(f"dist {sub}: gathers {rec['gathers']}: "
                             "a leaf gathered over model")
    if sub in FAMILY_SUBS:
        # the tile each rank trained on, and K1/K2 through their
        # sharded entries on every rank (the leaves split over model)
        sharded = [sum(n[k] for k in SHARDED_WRAPPERS)
                   for n in rec["launches_per_step"]]
        if (rec["rank_tiles"] != [job["tile"]] * world
                or rec["rank_frame_tiles"] != [job.get("frame_tile")] * world
                or not all(sharded) or not rec["gathers"].get("model/dense")):
            raise AssertionError(
                f"dist {sub}: tiles {rec['rank_tiles']} (expected "
                f"{job['tile']}), frame tiles {rec['rank_frame_tiles']} "
                f"(expected {job.get('frame_tile')}), sharded K1/K2 "
                f"launches a step {sharded}, gathers {rec['gathers']}")
    return rec


def optimized_beside(root, sub, job, world, ref_losses) -> dict:
    """The optimized plan's run of ``job`` (``baseline_1x2``'s second
    run) on each rank: its peak, collectives and K1/K2 launches a step,
    tiles and dry readings, beside the baseline's; its losses' distance
    from the unsharded run's."""
    ranks = [json.loads(open(os.path.join(
        root, f"rank{r}_{sub}_optimized.json")).read())
        for r in range(world)]
    got = model_axis_readings(ranks, job["steps"])
    losses = ranks[0]["losses"]
    return {"losses": losses,
            "loss_max_rel_err": max(abs(x - y) / abs(y)
                                    for x, y in zip(losses, ref_losses)),
            **{k: got[k] for k in (
                "rank_peak_memory_bytes", "rank_local_param_bytes",
                "rank_step_seconds", "collectives_per_step",
                "launches_per_step", "gathers", "rank_tiles",
                "rank_run_seconds", "dry")}}


def baseline_failures(rec) -> None:
    """``baseline_1x2``'s own checks: every rank ran its rows' whole
    sequence (no tile) and reduce-scattered nothing, the optimized plan
    ran its tiles, both plans launched the same K1/K2 entries a step, the
    optimized run is within the loss tolerance too, and its dry counts
    equal its card's.  Raises on a miss."""
    opt = rec["optimized"]
    tile = [4, 1024 // 2]
    scattered = [c["scatter_bytes"] for c in rec["collectives_per_step"]]
    sharded = [sum(n[k] for k in SHARDED_WRAPPERS)
               for n in rec["launches_per_step"]]
    if (rec["rank_tiles"] != [None] * len(rec["rank_tiles"])
            or opt["rank_tiles"] != [tile] * len(opt["rank_tiles"])
            or any(scattered) or not all(sharded)
            or rec["launches_per_step"] != opt["launches_per_step"]):
        raise AssertionError(
            f"dist baseline_1x2: tiles {rec['rank_tiles']} (optimized "
            f"{opt['rank_tiles']}), scattered bytes a step {scattered}, "
            f"K1/K2 a step {rec['launches_per_step']} (optimized "
            f"{opt['launches_per_step']})")
    if opt["loss_max_rel_err"] > DIST_LOSS_RTOL:
        raise AssertionError(f"dist baseline_1x2: the optimized plan's "
                             f"loss rel err {opt['loss_max_rel_err']}")
    failed = dry_failures("dist baseline_1x2 optimized", opt["dry"],
                          hold_peak=False)
    if failed:
        raise AssertionError("; ".join(failed))


# the serving sub-phases' logits and caches against the unsharded legacy
# steps: the port's prefill-vs-decode tolerance
# (tests/test_torch_legacy_serve.py)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)


def serve_parts(job) -> list:
    """The models a serving sub-phase serves one after the other, each a
    dict of :func:`serve_rank`'s keys (the job's, a part's own over them):
    ``arch``, ``layers``, ``batch``, ``seq`` (prompt tokens; none for an
    encoder-decoder, whose prompt is its frames), ``steps`` (greedy decode
    steps), ``prefill`` (the prefill's keywords), ``shape`` and ``key``
    (its files' name)."""
    if "parts" not in job:
        return [dict(job, key="serve12", model=None, prefill={})]
    return [{**job, "prefill": {}, **part,
             "key": f"{job['tag']}{part['model']}"} for part in job["parts"]]


def serve_prompt(arch, job) -> dict:
    """A serving part's global prefill batch from a seed: ``batch`` x
    ``seq`` tokens, or an encoder-decoder's ``batch`` frames."""
    if arch.family == "encdec":
        return {"frames": encdec_frames(arch.cfg, job["batch"], 5)}
    g = torch.Generator().manual_seed(5)
    return {"tokens": torch.randint(1, arch.cfg.vocab,
                                    (job["batch"], job["seq"]), generator=g,
                                    dtype=torch.int32).to(DEV)}


def serve_ring(job) -> int:
    """The slots of a serving part's ring (its whole cache's ``max_len``):
    the prefill's ``max_len`` or ``max_decode_len``, else the prompt's."""
    kw = job["prefill"]
    return kw.get("max_len") or kw.get("max_decode_len") or job["seq"]


def serve_tokens(arch, job, logits, step: int) -> torch.Tensor:
    """A decode step's tokens ``[B, 1]``: greedy from the last logits, an
    encoder-decoder's start token at step 0."""
    if arch.family == "encdec" and step == 0:
        return torch.full((job["batch"], 1), ENCDEC_SOT, dtype=torch.int32,
                          device=DEV)
    return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)


def serve_launches() -> dict:
    """K4's two entries' launch counts as they stand."""
    return {"decode_attention_partial": KD.decode_attention_partial.launches,
            "decode_attention": KD.decode_attention.launches}


def serve_rank(rank: int, job: dict, root: str) -> None:
    """One rank of a serving part (spawned, in the world of the (1, 2)
    sub-phases; :func:`serve_parts`): its param blocks from the whole
    params of seed 0, the prefill of the global prompt and ``steps``
    greedy decode steps (``serve/sharded.py``), each step's collectives,
    K4 launches and seconds, with the counts set to 0 just before the run;
    its peak beside its param and cache blocks and their reckoning under
    the rules; then its dry trace of the same steps.  Writes its logits,
    tokens, final cache block (and an encoder-decoder's prefill output) to
    ``{key}_rank{r}.pt`` and its record to ``rank{r}_{key}.json``."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import AXES_BY_NDIM, MeshLayout, make_mesh
    from repro_torch.serve.sharded import sharded_serving
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import zero as Z
    t_job = time.time()
    arch = cut_arch(job["layers"], torch.float32, job["arch"])
    shape = tuple(job["shape"])
    srv = sharded_serving(arch, make_mesh(shape, DEV), **job["prefill"])
    params = srv.zero.place_params(arch.init_params(0, device=DEV))
    gc.collect()
    torch.cuda.empty_cache()
    prompt = serve_prompt(arch, job)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps, logits_all, tokens = [], [], []

    def counted(fn, *args):
        torch.cuda.synchronize()
        s0, n0 = dict(C.STATS), serve_launches()
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        n = {k: v - n0[k] for k, v in serve_launches().items() if v > n0[k]}
        steps.append({"stats": {k: C.STATS[k] - s0[k] for k in DRY_STAT_KEYS},
                      "launches": n,
                      "staged_bytes": C.STATS["staged_bytes"]
                      - s0["staged_bytes"],
                      "seconds": time.time() - t0})
        return out

    C.reset_stats()
    KD.decode_attention_partial.launches = 0
    KD.decode_attention.launches = 0
    t_run = time.time()
    out, cache = counted(srv.prefill_step, params, prompt)
    enc_out = out.cpu() if arch.family == "encdec" else None
    logits = out
    if enc_out is None:
        logits_all.append(out.cpu())
    for i in range(job["steps"]):
        tok = serve_tokens(arch, job, logits, i)
        tokens.append(tok[:, 0].cpu())
        logits, cache = counted(srv.decode_step, params, cache,
                                {"tokens": tok})
        logits_all.append(logits.cpu())
    run_s = time.time() - t_run
    launches = serve_launches()
    peak = torch.cuda.max_memory_allocated() - base
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in tree_leaves(tree))
    layout = MeshLayout(shape, AXES_BY_NDIM[len(shape)])
    axes = R.MeshAxes(layout)
    meta = arch.init_params(0, device="meta")
    whole = arch.init_cache(job["batch"], serve_ring(job), device="meta")
    reckoned = {"param_bytes": D.pspec_bytes(
                    meta, Z.rest_pspecs(meta, axes), layout.shape),
                "cache_bytes": D.pspec_bytes(whole, R.cache_pspecs(
                    whole, axes, job["batch"]), layout.shape)}
    torch.save({"logits": torch.stack(logits_all),
                "tokens": torch.stack(tokens), "enc_out": enc_out,
                "cache": {k: v.cpu() for k, v in cache.items()}},
               os.path.join(root, f"{job['key']}_rank{rank}.pt"))
    for th in _DRY_WARM:
        th.join()
    t_dry = time.time()
    dry_block, tr = D.trace_serving(
        arch, shape, rank=rank,
        prompt={k: (tuple(v.shape), v.dtype) for k, v in prompt.items()},
        decode_steps=job["steps"], **job["prefill"])
    dry = [{"stats": {k: p["stats"][k] for k in DRY_STAT_KEYS},
            "launches": p["launches"]} for p in tr.per_step]
    card = [{k: st[k] for k in ("stats", "launches")} for st in steps]
    rec = {"peak_memory_bytes": peak, "base_bytes": base,
           "param_block_bytes": nbytes(params),
           "cache_block_bytes": nbytes(cache), "reckoned": reckoned,
           "steps": steps, "launches": launches,
           "partial_launches": launches["decode_attention_partial"],
           "tile": srv.zero.tile and list(srv.zero.tile),
           "frame_tile": srv.zero.frame_tile and list(srv.zero.frame_tile),
           "run_seconds": run_s,
           "dry": {"counts_equal": dry == card, "dry_steps": dry,
                   "step_peak_bytes": tr.peak_bytes,
                   "resting_bytes": tr.resting_bytes,
                   "cache_block_bytes": nbytes(dry_block),
                   "dry_seconds": time.time() - t_dry},
           "seconds": time.time() - t_job}
    with open(os.path.join(root, f"rank{rank}_{job['key']}.json"),
              "w") as f:
        json.dump(rec, f)
    del params, cache, logits, out
    gc.collect()
    torch.cuda.empty_cache()


def serve_decode_launches(arch, shape) -> dict:
    """K4's launches one decode step makes on a rank of ``shape``: the
    partial entry once a GQA layer (none for MLA or mamba2), once an
    application of the hybrid's shared block, once a whisper decoder layer
    for its self ring and once more for its cross cache where the model
    axis divides the frames, else the whole-ring entry once."""
    cfg = arch.cfg
    if arch.family == "mamba2" or getattr(cfg, "mla", None) is not None:
        return {}
    if arch.family == "hybrid":
        return {"decode_attention_partial": cfg.n_attn_applications()}
    if arch.family == "encdec":
        n = cfg.n_dec_layers
        if cfg.n_frames % shape[-1] == 0:
            return {"decode_attention_partial": 2 * n}
        return {"decode_attention_partial": n, "decode_attention": n}
    return {"decode_attention_partial": cfg.n_layers}


def dim2_block(n: int, shape, rank: int) -> tuple:
    """``rules.cache_pspecs``' block of a cache leaf's dim 2 of ``n`` (a
    ring's slots, mamba's heads or conv taps, whisper's frames) on rank
    ``rank`` of a (1, tp) mesh: split over ``model`` where it divides."""
    tp = shape[-1]
    if tp > 1 and n % tp == 0 and n > 1:
        k = n // tp
        return rank * k, (rank + 1) * k
    return 0, n


def serve_check(root, sub, job, spawn_s, group) -> dict:
    """A serving sub-phase's check, each of its parts (:func:`serve_parts`)
    in turn: the unsharded legacy prefill and decode steps of the same
    weights and prompt on the card (K4 whole), then each rank's logits
    every step (and an encoder-decoder's prefill output) within SERVE_TOL
    of them, its greedy tokens equal, both ranks' logits bitwise equal,
    each rank's cache block within SERVE_TOL of its slice of the
    unsharded cache (``pos``, ``cur`` equal), K4 launched as
    :func:`serve_decode_launches` says a decode step and never in the
    prefill, and the dry counts equal the card's every step.  Prints a
    line a part before any check can fail; returns the record (a
    sub-phase of parts: ``{"parts": {model: record}}``)."""
    world = math.prod(job["shape"])
    recs, failed = {}, []
    for part in serve_parts(job):
        rec, why = serve_part_check(root, sub, part, spawn_s, group, world)
        recs[part["model"]] = rec
        failed += why
    if failed:
        raise AssertionError("; ".join(failed))
    return recs[None] if None in recs else {"parts": recs}


def serve_part_check(root, sub, job, spawn_s, group, world) -> tuple:
    """One part of :func:`serve_check`: its record and what failed."""
    t0 = time.time()
    ranks = [json.loads(open(os.path.join(
        root, f"rank{r}_{job['key']}.json")).read()) for r in range(world)]
    got = [torch.load(os.path.join(root, f"{job['key']}_rank{r}.pt"))
           for r in range(world)]
    arch = cut_arch(job["layers"], torch.float32, job["arch"])
    params = arch.init_params(0, device=DEV)
    prompt = serve_prompt(arch, job)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_ref = time.time()
    out, cache = arch.make_prefill_step(**job["prefill"])(params, prompt)
    enc_out = out.cpu() if arch.family == "encdec" else None
    want, tokens, logits = [], [], out
    if enc_out is None:
        want.append(out.cpu())
    decode = arch.make_decode_step()
    for i in range(job["steps"]):
        tok = serve_tokens(arch, job, logits, i)
        tokens.append(tok[:, 0].cpu())
        logits, cache = decode(params, cache, {"tokens": tok})
        want.append(logits.cpu())
    torch.cuda.synchronize()
    ref_s = time.time() - t_ref
    ref_peak = torch.cuda.max_memory_allocated() - base
    want, tokens = torch.stack(want), torch.stack(tokens)
    logit_ok, logit_err, cache_ok, cache_err = True, 0.0, True, 0.0
    enc_ok, enc_err = True, 0.0
    shape = tuple(job["shape"])
    for r, g in enumerate(got):
        ok, d = within(g["logits"], want, **SERVE_TOL)
        logit_ok, logit_err = logit_ok and ok, max(logit_err, d)
        if enc_out is not None:
            ok, d = within(g["enc_out"], enc_out, **SERVE_TOL)
            enc_ok, enc_err = enc_ok and ok, max(enc_err, d)
        for k, v in cache.items():
            if v.ndim >= 3:
                lo, hi = dim2_block(v.shape[2], shape, r)
                ok, d = within(g["cache"][k], v[:, :, lo:hi].cpu(),
                               **SERVE_TOL)
            else:
                ok, d = bool(torch.equal(g["cache"][k], v.cpu())), 0.0
            cache_ok, cache_err = cache_ok and ok, max(cache_err, d)
    per_step = serve_decode_launches(arch, shape)
    prefill = [r["steps"][0] for r in ranks]
    decode_steps = [r["steps"][1:] for r in ranks]
    W = int(cache["pos"].shape[0]) if "pos" in cache else None
    rec = {
        "spawn_seconds": spawn_s, "world": list(group),
        "ring_slots": W,
        "rank_slots": [W and list(dim2_block(W, shape, r))
                       for r in range(world)],
        "rank_blocks": {k: [list(dim2_block(v.shape[2], shape, r))
                            for r in range(world)]
                        for k, v in cache.items() if v.ndim >= 3},
        "first_decode_slot": W and (job["seq"] if "seq" in job else 0) % W,
        "logits_max_abs_diff": logit_err, "logits_within_tol": logit_ok,
        "tokens_equal": all(torch.equal(g["tokens"], tokens) for g in got),
        "ranks_logits_bitwise": all(torch.equal(g["logits"],
                                                got[0]["logits"])
                                    for g in got),
        "cache_max_abs_diff": cache_err, "cache_blocks_within_tol": cache_ok,
        "rank_peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "rank_param_block_bytes": [r["param_block_bytes"] for r in ranks],
        "rank_cache_block_bytes": [r["cache_block_bytes"] for r in ranks],
        "rank_reckoned": [r["reckoned"] for r in ranks],
        "unsharded_peak_memory_bytes": ref_peak,
        "unsharded_seconds": ref_s,
        "collectives_prefill": [p["stats"] for p in prefill],
        "staged_bytes_prefill": [p["staged_bytes"] for p in prefill],
        "collectives_decode_step": [d[0]["stats"] for d in decode_steps],
        "staged_bytes_decode_step": [d[0]["staged_bytes"]
                                     for d in decode_steps],
        "decode_steps_alike": all(s["stats"] == d[0]["stats"]
                                  for d in decode_steps for s in d),
        "launches_per_decode_step_expected": per_step,
        "launches_prefill": [p["launches"] for p in prefill],
        "partial_launches_prefill": [p["launches"].get(
            "decode_attention_partial", 0) for p in prefill],
        "partial_launches_per_decode_step": [
            [s["launches"].get("decode_attention_partial", 0) for s in d]
            for d in decode_steps],
        "launches_per_decode_step": [[s["launches"] for s in d]
                                     for d in decode_steps],
        "partial_launches": [r["partial_launches"] for r in ranks],
        "rank_prefill_seconds": [p["seconds"] for p in prefill],
        "rank_decode_step_seconds": [
            sum(s["seconds"] for s in d) / len(d) for d in decode_steps],
        "rank_tiles": [r["tile"] for r in ranks],
        "rank_frame_tiles": [r.get("frame_tile") for r in ranks],
        "rank_run_seconds": [r["run_seconds"] for r in ranks],
        "dry": [r["dry"] for r in ranks]}
    if enc_out is not None:
        rec.update(enc_out_max_abs_diff=enc_err, enc_out_within_tol=enc_ok)
    rec["seconds"] = max(r["seconds"] for r in ranks) + time.time() - t0
    emit("dist", sub=sub, model=job["model"], arch=job["arch"],
         mesh=list(shape), batch=job["batch"], prompt=job.get("seq"),
         decode_steps=job["steps"], n_layers=job["layers"], dtype="float32",
         prefill_keywords=job["prefill"], tolerance=SERVE_TOL, **rec)
    del params, cache, logits, out
    gc.collect()
    torch.cuda.empty_cache()
    failed = []
    what = f"dist {sub}" + (f" {job['model']}" if job["model"] else "")
    if not (logit_ok and cache_ok and enc_ok and rec["tokens_equal"]
            and rec["ranks_logits_bitwise"]):
        failed.append(
            f"{what}: logits within tolerance {logit_ok} (max diff "
            f"{logit_err}), encoder output within tolerance {enc_ok} (max "
            f"diff {enc_err}), tokens equal {rec['tokens_equal']}, ranks "
            f"bitwise {rec['ranks_logits_bitwise']}, cache blocks within "
            f"tolerance {cache_ok} (max diff {cache_err})")
    if any(rec["launches_prefill"]) or any(
            n != per_step for d in rec["launches_per_decode_step"]
            for n in d):
        failed.append(f"{what}: K4 launches, prefill "
                      f"{rec['launches_prefill']}, a decode step "
                      f"{rec['launches_per_decode_step']} (expected "
                      f"{per_step})")
    bad = [r for r, d in enumerate(rec["dry"]) if not d["counts_equal"]]
    if bad:
        failed.append(f"{what}: ranks {bad}: the dry plan's collectives or "
                      "launches are not the card's")
    return rec, failed


# deepseek-v3-671b on a model axis (d): two gloo ranks on (1, 2) at its
# published width, 1 layer (the depth the unsharded run fits at), bf16,
# 1 x 1024 (a tile of 512), 2 fused AdaLomo steps: MLA on the tiles with
# the latent gathered over model, the MTP head on the tiles, the 256
# routed experts 128 a rank.  Held against the unsharded run of the same
# seed, run first in a process of its own (57.3 GB), whose final params
# are read back from its checkpoint (27.4 GB of files, removed after).
DIST_MLA_JOB = dict(shape=(1, 2), layers=MLA_TRAIN_LAYERS, steps=2,
                    arch=MLA_ID, batch=1, seq=1024, tag="mla12_",
                    runs=(("bfloat16", None, "mla12", 0),))
# No fp32 run fits on the card at this width (13.7 G params), so the bf16
# bound is stated: each step's loss and MTP loss within 1e-3 of the
# unsharded run's, a quarter of bf16's own relative step (2^-8) and about
# 40x the distance danube's (1, 2) bf16 sub-phase keeps (2.3e-5 on an
# H100 80GB HBM3).  The params beyond the reference's sharded tolerance
# plus one bf16 ulp (two ranks' partial sums rounded once in fp32 leave
# some a second ulp away, as on the data axis) are held to a share of a
# rank's elements: about twice the 2.2e-5 and 2.3e-5 the two ranks leave
# after 2 steps on an H100 80GB HBM3.
DIST_MLA_LOSS_RTOL = 1e-3
DIST_MLA_OUTSIDE_MAX = 5e-5
# the unsharded checkpoint's files, with room to spare
DIST_MLA_MIN_FREE = 32 * 10 ** 9
BLOCK_PIECE = 1 << 26


def rank_reckoning(spec, arch) -> dict:
    """A rank's bytes on the mesh of ``spec``, reckoned by the dry run
    (``launch/dryrun.py``): rank 0 of the spec's first step traced on the
    meta device, its resting blocks, the init's peak (the whole model is
    drawn, then cut) and the step's."""
    from repro_torch.launch import dryrun as D
    tr = D.trace_train(spec, arch=arch, mesh=spec.mesh.shape, steps=1)
    return {"resting": tr.resting_bytes, "init_peak": tr.init_peak_bytes,
            "step_peak": tr.peak_bytes,
            "total": max(tr.peak_bytes, tr.init_peak_bytes)}


def index_runs(shape, piece=BLOCK_PIECE):
    """Index tuples that cover an array of ``shape`` once, in order: runs
    of at most ``piece`` elements along its leading dim (an index whose
    sub-array is larger is cut further along the next)."""
    if len(shape) <= 1 or math.prod(shape) <= piece:
        yield ()
        return
    row = math.prod(shape[1:])
    if row > piece:
        for i in range(shape[0]):
            for rest in index_runs(shape[1:], piece):
                yield (i,) + rest
        return
    for i in range(0, shape[0], piece // row):
        yield (slice(i, i + piece // row),)


def blocks_against(params, zero, step_dir) -> dict:
    """This rank's param blocks against the whole params in an unsharded
    run's checkpoint (``step_dir``): each leaf's file memory-mapped, this
    rank's block of it read in pieces and compared on the card.  The
    elements beyond DIST_PARAM_TOL plus one bf16 ulp (as
    ``bf16_gap_readings`` counts them), the largest difference, and the
    elements compared."""
    from repro_torch.core.tree import tree_flatten_with_path
    with open(os.path.join(step_dir, "manifest.json")) as f:
        files = [leaf["file"] for leaf in json.load(f)["leaves"]]
    places = [pl for _, pl in tree_flatten_with_path(zero.dims)]
    out = {"elements": 0, "outside": 0, "max_abs_diff": 0.0}
    for t, pl, name in zip(tree_leaves(params), places, files):
        whole = np.load(os.path.join(step_dir, name), mmap_mode="r")
        if t.dtype == torch.bfloat16:
            whole = whole.view(np.int16)    # raw 16-bit words (<V2)
        idx = [slice(None)] * whole.ndim
        for dim, parts, k in zero.block(pl):
            n = whole.shape[dim] // parts
            idx[dim] = slice(k * n, (k + 1) * n)
        want = whole[tuple(idx)]
        if want.shape != tuple(t.shape):
            raise AssertionError(f"{name}: block {want.shape}, param "
                                 f"{tuple(t.shape)}")
        for sl in index_runs(want.shape):
            b = torch.from_numpy(np.array(want[sl])).to(DEV)
            b32 = (b.view(torch.bfloat16) if t.dtype == torch.bfloat16
                   else b).to(torch.float32)
            diff = (t[sl].to(torch.float32) - b32).abs()
            lim = DIST_PARAM_TOL["atol"] + DIST_PARAM_TOL["rtol"] * b32.abs()
            if t.dtype == torch.bfloat16:
                lim += bf16_ulp(b32)
            out["outside"] += int((diff > lim).sum())
            out["max_abs_diff"] = max(out["max_abs_diff"],
                                      float(diff.max()))
            out["elements"] += diff.numel()
            del b, b32, diff, lim
    return out


def dist_unsharded_proc(rank, world, store, root, jobs) -> None:
    """The unsharded run of ``jobs``' one job in a process of its own
    (spawned), so that its memory is the card's again when it ends:
    losses, MTP and aux losses, peak and step seconds to
    ``{tag}unsharded.json``, and its final params and state in a
    checkpoint under ``{tag}unsharded/``."""
    del rank, world, store
    (job,) = jobs
    torch.cuda.set_device(DEV)
    timing, watch = TimingHook(), moe_watch(-1)
    torch.cuda.reset_peak_memory_stats()
    res = run(dist_spec(job["steps"], ckpt=os.path.join(
                  root, job["tag"] + "unsharded"), every=job["steps"],
                  arch_id=job["arch"], batch=job["batch"], seq=job["seq"]),
              arch=cut_arch(job["layers"], None, job["arch"]),
              hooks=[timing, watch], device=DEV, log_fn=lambda s: None)
    torch.cuda.synchronize()
    with open(os.path.join(root, job["tag"] + "unsharded.json"), "w") as f:
        json.dump({"losses": res.history["loss"], "aux_losses": watch.aux,
                   "mtp_losses": watch.mtp, "step_seconds": timing.step_s,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "launches": sharded_launches()}, f)


def dist_model_mla(root) -> dict:
    """(d) deepseek-v3-671b on (1, 2) (``DIST_MLA_JOB``) against its
    unsharded run, printing its line before it can fail."""
    job = DIST_MLA_JOB
    free = shutil.disk_usage(root).free
    if free < DIST_MLA_MIN_FREE:
        raise AssertionError(f"dist model_mla: {free} bytes free in {root}, "
                             f"need {DIST_MLA_MIN_FREE}")
    arch = cut_arch(job["layers"], None, job["arch"])
    reckoning = rank_reckoning(
        dist_spec(job["steps"], shape=tuple(job["shape"]),
                  arch_id=job["arch"], batch=job["batch"], seq=job["seq"]),
        arch)
    progress("dist: model axis model_mla, the unsharded run in its own "
             "process")
    unsharded_s = spawn_gloo(1, root, [job], target=dist_unsharded_proc)
    ref = json.loads(open(os.path.join(root, job["tag"] + "unsharded.json"
                                       )).read())
    step_dir = os.path.join(root, job["tag"] + "unsharded",
                            f"step_{job['steps']:09d}")
    progress("dist: model axis model_mla, two gloo ranks on (1, 2)")
    # the ranks' allocators grow their segments rather than keep many:
    # two 35 GB ranks share the card
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawn_s = spawn_gloo(2, root, [dict(job, against=step_dir)])
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    shutil.rmtree(os.path.join(root, job["tag"] + "unsharded"),
                  ignore_errors=True)
    ranks = [json.loads(open(os.path.join(
        root, f"rank{r}_{job['tag']}bfloat16.json")).read())
        for r in range(2)]

    def rel(got, want):
        return max(abs(x - y) / abs(y) for x, y in zip(got, want))

    loss_err = rel(ranks[0]["losses"], ref["losses"])
    mtp_err = rel(ranks[0]["mtp_losses"], ref["mtp_losses"])
    rec = {"unsharded_seconds": unsharded_s, "spawn_seconds": spawn_s,
           "losses": ranks[0]["losses"], "unsharded_losses": ref["losses"],
           "loss_max_rel_err": loss_err,
           "mtp_losses": ranks[0]["mtp_losses"],
           "unsharded_mtp_losses": ref["mtp_losses"],
           "mtp_loss_max_rel_err": mtp_err,
           "aux_losses": ranks[0]["aux_losses"],
           "unsharded_aux_losses": ref["aux_losses"],
           "params_against_unsharded": [r["against"] for r in ranks],
           "unsharded_peak_memory_bytes": ref["peak_memory_bytes"],
           "unsharded_step_seconds": ref["step_seconds"],
           "unsharded_launches": ref["launches"],
           "rank_reckoning": reckoning,
           "rank_allocated_at_run_start_bytes": [
               r["allocated_at_run_start_bytes"] for r in ranks],
           **model_axis_readings(ranks, job["steps"])}
    emit("dist", sub="model_mla", arch=job["arch"], mesh=list(job["shape"]),
         batch=job["batch"], seq=job["seq"], steps=job["steps"],
         n_layers=job["layers"], dtype="bfloat16",
         tolerance={"loss_rtol": DIST_MLA_LOSS_RTOL,
                    "mtp_loss_rtol": DIST_MLA_LOSS_RTOL,
                    "params_outside": dict(DIST_PARAM_TOL, ulp=1),
                    "params_outside_max_share": DIST_MLA_OUTSIDE_MAX},
         **rec)
    failed = []
    if loss_err > DIST_MLA_LOSS_RTOL or mtp_err > DIST_MLA_LOSS_RTOL:
        failed.append(f"loss rel err {loss_err}, mtp {mtp_err}")
    if not all(a > 0 for a in ranks[0]["aux_losses"]):
        failed.append(f"aux losses {ranks[0]['aux_losses']}")
    for r, got in enumerate(rec["params_against_unsharded"]):
        if (not got["elements"]
                or got["outside"] > DIST_MLA_OUTSIDE_MAX * got["elements"]):
            failed.append(f"rank {r}: {got['outside']} of "
                          f"{got['elements']} params beyond the tolerance "
                          f"+ one ulp")
    if not rec["replicated_bitwise_across_ranks"]:
        failed.append("a whole leaf differs between the ranks")
    if (rec["gathers"].get("model/expert", 0)
            or not rec["gathers"].get("model/dense")):
        failed.append(f"gathers {rec['gathers']}: an expert stack gathered "
                      "over model")
    if not all(sum(n.values()) > 0 for n in rec["launches_per_step"]):
        failed.append(f"K1/K2 launches {rec['launches_per_step']}")
    failed += dry_failures("dist model_mla", rec["dry"], hold_peak=False)
    if failed:
        raise AssertionError(f"dist model_mla: {failed}")
    return rec


# The optimizer side of a mesh: two gloo ranks sharing the card on (2,).
# Table 1's four arms in danube's bf16 at 4 layers; unfused AdamW and
# Adafactor in fp32 at 2 layers against the same arms unsharded; fused
# AdaLomo under the sentinel (skip + backoff, the trust guard) and every
# probe, fp32 at 2 layers, a 100x update at step 3.
DIST_OPT_STEPS = 2
DIST_OPT_LAYERS = 2                 # parity and the guard, fp32
DIST_OPT_PARITY = ("adamw", "adafactor")
DIST_OPT_GUARD_STEPS = 4
DIST_OPT_SPIKE_AT = 3
DIST_OPT_TRUST_MAX = 1.0            # above every group ratio: read, held
# lr 3e-4 puts AdaLomo's clipped relative update at log10 = -3.52, clear of
# the histogram's half-decade edges
DIST_OPT_GUARD_LR = 3e-4
PROBE_TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW's update divides by sqrt(v): an element whose summed gradient is
# within fp32 rounding of 0 moves by up to 2 lr differently under another
# order of the sum over the ranks.  Such elements (beyond DIST_PARAM_TOL,
# within 2 lr a step) are counted apart, at most this share of the params.
NEAR_ZERO_SHARE = 1e-6
DIST_OPT_TIMEOUT_S = 600   # from their start, beside the model-axis worlds


def dist_opt_spec(name, steps, *, shape=None, fused=None, guard=False,
                  lr=None):
    from repro_torch.run import MeshSpec, ObservabilitySpec
    from repro_torch.sentinel import SentinelSpec
    kw = {}
    if guard:
        kw = dict(sentinel=SentinelSpec(enabled=True,
                                        ladder=("skip", "backoff"), warmup=2,
                                        trust_max=DIST_OPT_TRUST_MAX),
                  observe=ObservabilitySpec(optimizer_every=1,
                                            factored_every=2))
    return RunSpec(model=ModelSpec(ARCH_ID, smoke=False),
                   data=DataConfig(vocab=0, seq_len=1024, global_batch=4,
                                   seed=0),
                   opt=OptSpec(name=name, lr=lr),
                   steps=StepSpec(total=steps, fused=fused), log_every=0,
                   seed=0, mesh=(MeshSpec(kind="multi", shape=shape)
                                 if shape else MeshSpec()), **kw)


def own_syncs(caught: list) -> int:
    """Synchronising host transfers outside the collectives' gloo staging
    of CUDA tensors (which is a copy through host memory by nature, counted
    in ``collectives.STATS["staged_bytes"]``)."""
    return sum("synchroniz" in str(w.message)
               and os.path.basename(w.filename) != "collectives.py"
               for w in caught)


def flat_probes(metrics: dict) -> dict:
    """A step's probe values and the guard's verdict, flat and host-side:
    ``{"group_ratio/<group>": x, "eff_lr/counts": [...], "factored/<key>":
    x, "sentinel/<key>": x}``."""
    out = {}
    for part, vals in metrics.get("opt_health", {}).items():
        for k, v in vals.items():
            out[f"{part}/{k}"] = v.tolist() if hasattr(v, "tolist") else v
    for k, v in metrics.get("sentinel", {}).items():
        out[f"sentinel/{k}"] = v
    return out


def dist_opt_watch(caught: list):
    """A hook keeping each step's flat probes and verdict and the host
    syncs outside the staging (from its own end at the previous step)."""
    from repro_torch.run import Hook

    class Watch(Hook):
        def __init__(self):
            self.values, self.syncs, self._mark = [], [], 0

        def on_run_start(self, ctx):
            self._mark = own_syncs(caught)

        def on_step_end(self, ctx, ev):
            self.syncs.append(own_syncs(caught) - self._mark)
            self.values.append(flat_probes(ev.metrics))
            self._mark = own_syncs(caught)

    return Watch()


def dist_opt_arm(name, fused, base, arch, world) -> dict:
    """One arm of Table 1 on this rank of a (world,) mesh: its program and
    this rank's shards first (bytes after init), then ``run(spec)``, K1/K2
    counts and the collectives' stats set to 0 before it and read after,
    host syncs outside the staging counted; then everything freed."""
    from repro_torch.core.tree import pytree_leaves, tree_flatten_with_path
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.run import build_step_program
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.zero import Zero3
    spec = dist_opt_spec(name, DIST_OPT_STEPS, shape=(world,), fused=fused)
    meter = StepMeter().__enter__()
    zero = Zero3(make_mesh((world,), DEV), arch.init_params(0, device="meta"))
    program = meter.attach(build_step_program(spec, arch, device=DEV,
                                              zero=zero))
    params, state = program.init(spec.seed)
    shapes = [shp for _, shp in tree_flatten_with_path(zero.shapes)]
    places = [pl for _, pl in tree_flatten_with_path(zero.dims)]
    n_split = sum(math.prod(s) for s, pl in zip(shapes, places)
                  if not pl.whole)
    n_whole = sum(math.prod(s) for s, pl in zip(shapes, places) if pl.whole)
    rec = {"optimizer": name, "engine": "fused" if fused else "unfused",
           "n_params": n_split + n_whole, "n_params_whole_leaves": n_whole,
           "local_param_bytes": tree_bytes(params),
           "local_state_bytes": sum(t.numel() * t.element_size() for t in
                                    pytree_leaves(state.moments)),
           "init_allocated_bytes": held_bytes() - base}
    if name == "adamw":
        # fp32 m and v: 8 bytes for each param of this rank's blocks
        rec["state_bytes_expected"] = 8 * (n_split // world + n_whole)
    timing = TimingHook()
    reset_launches()
    C.reset_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = run(spec, program=program, params=params,
                         opt_state=state, hooks=[timing],
                         log_fn=lambda s: None)
            launches = sharded_launches()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        meter.__exit__(None, None, None)
    torch.cuda.synchronize()
    rec.update(
        losses=result.history["loss"], step_seconds=timing.step_s,
        launches=launches,
        collectives_per_step={k: v / DIST_OPT_STEPS
                              for k, v in C.STATS.items()},
        host_syncs=own_syncs(caught),
        peak_memory_bytes=meter.run_peak(),
        params_finite=all_finite(result.params),
        dry=dry_reading(spec, meter, arch=arch, mesh=(world,),
                        rank=zero.mesh.rank))
    del result, params, state, program, zero
    rec["allocated_after_free_bytes"] = held_bytes()
    return rec


def dist_opt_rank(rank: int, world: int, store: str, root: str,
                  jobs: list) -> None:
    """One of the two gloo ranks of ``dist_optimizers`` (spawned): Table
    1's arms, the fp32 parity arms (this rank's blocks saved), the guarded
    and probed run; what it measured to ``rank{r}_opt.json``."""
    import torch.distributed as dist
    from repro_torch.sentinel import Injection
    from repro_torch.sharding import collectives as C
    del jobs
    dry_warmup()
    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {"arms": [], "parity": {}}
    try:
        base = held_bytes()
        out["base_bytes"] = base
        arch = cut_arch(DIST_GLOO_LAYERS)
        for name, fused in BASELINE_ARMS:
            out["arms"].append(dist_opt_arm(name, fused, base, arch, world))
        arch32 = cut_arch(DIST_OPT_LAYERS, torch.float32)
        for name in DIST_OPT_PARITY:
            timing = TimingHook()
            res = run(dist_opt_spec(name, DIST_OPT_STEPS, shape=(world,)),
                      arch=arch32, device=DEV, hooks=[timing],
                      log_fn=lambda s: None)
            torch.save(tree_map(lambda t: t.cpu(), res.params),
                       os.path.join(root, f"opt_{name}_rank{rank}.pt"))
            out["parity"][name] = {"losses": res.history["loss"],
                                   "step_seconds": timing.step_s}
            del res
            gc.collect()
            torch.cuda.empty_cache()
        timing = TimingHook()
        reset_launches()
        C.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                watch = dist_opt_watch(caught)
                res = run(dist_opt_spec("adalomo", DIST_OPT_GUARD_STEPS,
                                        shape=(world,), guard=True,
                                        lr=DIST_OPT_GUARD_LR),
                          arch=arch32, device=DEV, hooks=[timing, watch],
                          inject=Injection("spike", at_step=DIST_OPT_SPIKE_AT,
                                           scale=100.0),
                          log_fn=lambda s: None)
                launches = sharded_launches()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["guard"] = {
            "losses": res.history["loss"], "step_seconds": timing.step_s,
            "values": watch.values, "host_syncs_per_step": watch.syncs,
            "launches": launches,
            "collectives_per_step": {k: v / DIST_OPT_GUARD_STEPS
                                     for k, v in C.STATS.items()},
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del res
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}_opt.json"), "w") as f:
        json.dump(out, f)


def rank_block(full: torch.Tensor, pl, rank: int, world: int):
    """Rank ``rank``'s block of a whole tensor placed at ``pl`` on a
    (world,) mesh."""
    if pl.data is None:
        return full
    k = full.shape[pl.data] // world
    return full.narrow(pl.data, rank * k, k)


def near_zero_parity(blocks, whole, places, rank, world, lr) -> dict:
    """This rank's blocks against the unsharded run's params: elements
    beyond DIST_PARAM_TOL, those of them within 2 lr a step, the largest
    difference."""
    out = {"outside": 0, "within_2lr_a_step": 0, "max_abs_diff": 0.0}
    for a, b, pl in zip(blocks, whole, places):
        b = rank_block(b, pl, rank, world).to(torch.float32).cpu()
        diff = (a.to(torch.float32) - b).abs()
        bad = diff > DIST_PARAM_TOL["atol"] + DIST_PARAM_TOL["rtol"] * b.abs()
        out["outside"] += int(bad.sum())
        out["within_2lr_a_step"] += int(
            (bad & (diff <= 2 * lr * DIST_OPT_STEPS)).sum())
        out["max_abs_diff"] = max(out["max_abs_diff"], float(diff.max()))
    return out


def start_dist_optimizers(root) -> tuple:
    """The two gloo ranks of :func:`dist_optimizers`, started: they run
    beside the model-axis worlds (``phase_dist``), for the script's time
    limit; each rank's readings are its own process's."""
    return start_gloo(2, root, [dict(tag="opt")], target=dist_opt_rank)


def dist_optimizers(root, started: tuple) -> dict:
    """The optimizer side of a mesh on the card (``dist_optimizers``): the
    two gloo ranks on (2,) ``started`` (:func:`start_dist_optimizers`)
    waited for, then the unsharded fp32 arms and guarded run in this
    process.  Prints its line, then fails if a check did not hold."""
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.sentinel import Injection
    from repro_torch.sharding.rules import MeshAxes
    from repro_torch.sharding.zero import param_places
    t0 = started[2]
    world = started[0]
    spawn_s = wait_gloo(started, timeout=DIST_OPT_TIMEOUT_S)
    ranks = [json.loads(open(os.path.join(root, f"rank{r}_opt.json")).read())
             for r in range(world)]
    checks = {}
    by = [{a["optimizer"]: a for a in r["arms"]} for r in ranks]
    for r, arms in enumerate(by):
        peak = {k: a["peak_memory_bytes"] for k, a in arms.items()}
        checks[f"rank {r} peaks AdaLomo ~ LOMO (5 %) < Adafactor < AdamW"] = (
            abs(peak["adalomo"] - peak["lomo"]) <= 0.05 * peak["lomo"]
            and max(peak["adalomo"], peak["lomo"]) < peak["adafactor"]
            < peak["adamw"])
        checks[f"rank {r} AdamW state 8 B a param of its blocks"] = (
            arms["adamw"]["local_state_bytes"]
            == arms["adamw"]["state_bytes_expected"])
        ada = arms["adalomo"]["launches"]
        checks[f"rank {r} K1/K2 sharded entries in the AdaLomo arm only"] = (
            all(ada[k] > 0 for k in SHARDED_WRAPPERS)
            and ada["adalomo_stats"] == ada["adalomo_update"] == 0
            and all(sum(arms[k]["launches"].values()) == 0
                    for k in ("lomo", "adafactor", "adamw")))
        checks[f"rank {r} one host sync a step in every arm"] = all(
            a["host_syncs"] == DIST_OPT_STEPS for a in arms.values())
        checks[f"rank {r} memory freed after every arm"] = all(
            a["allocated_after_free_bytes"] == ranks[r]["base_bytes"]
            for a in arms.values())
        checks[f"rank {r} finite losses and params"] = all(
            a["params_finite"] and all(math.isfinite(x) for x in a["losses"])
            for a in arms.values())
        checks[f"rank {r} every arm's dry plan: the card's collectives and "
               f"launches"] = all(a["dry"]["counts_equal"]
                                 for a in arms.values())
    # fp32 parity: the same arms unsharded on the card
    arch32 = cut_arch(DIST_OPT_LAYERS, torch.float32)
    meta = arch32.init_params(0, device="meta")
    places = [pl for _, pl in tree_flatten_with_path(param_places(
        meta, MeshAxes(MeshLayout((world,), ("data",)))))]
    parity = {}
    for name in DIST_OPT_PARITY:
        spec = dist_opt_spec(name, DIST_OPT_STEPS)
        res = run(spec, arch=arch32, device=DEV, log_fn=lambda s: None)
        whole = tree_leaves(res.params)
        lr = spec.opt.resolved_lr()
        rec = {"losses": ranks[0]["parity"][name]["losses"],
               "unsharded_losses": res.history["loss"],
               "loss_max_rel_err": max(
                   abs(x - y) / abs(y) for x, y in
                   zip(ranks[0]["parity"][name]["losses"],
                       res.history["loss"])),
               "rank_step_seconds": [r["parity"][name]["step_seconds"]
                                     for r in ranks], "lr": lr}
        for r in range(world):
            blocks = tree_leaves(torch.load(
                os.path.join(root, f"opt_{name}_rank{r}.pt")))
            rec[f"rank{r}"] = near_zero_parity(blocks, whole, places, r,
                                               world, lr)
        n = sum(t.numel() for t in whole)
        allowed = NEAR_ZERO_SHARE * n if name == "adamw" else 0
        checks[f"{name} fp32 parity"] = (
            rec["loss_max_rel_err"] <= DIST_LOSS_RTOL and all(
                rec[f"rank{r}"]["outside"]
                == rec[f"rank{r}"]["within_2lr_a_step"]
                and rec[f"rank{r}"]["outside"] <= allowed
                for r in range(world)))
        parity[name] = rec
        del res, whole
        gc.collect()
        torch.cuda.empty_cache()
    # the guard and the probes: bitwise across the ranks, within PROBE_TOL
    # of the unsharded guarded run
    caught: list = []
    watch = dist_opt_watch(caught)
    res = run(dist_opt_spec("adalomo", DIST_OPT_GUARD_STEPS, guard=True,
                            lr=DIST_OPT_GUARD_LR),
              arch=arch32, device=DEV, hooks=[watch],
              inject=Injection("spike", at_step=DIST_OPT_SPIKE_AT,
                               scale=100.0), log_fn=lambda s: None)
    want = watch.values
    del res
    got = [r["guard"]["values"] for r in ranks]
    worst, counts_equal = 0.0, True
    for a, b in zip(got[0], want):
        for k, v in a.items():
            if k.endswith("counts"):
                counts_equal &= v == b.get(k)
            elif k.startswith(("group_ratio/", "eff_lr/", "factored/")) or \
                    k == "sentinel/trust_worst":
                lim = PROBE_TOL["atol"] + PROBE_TOL["rtol"] * abs(b[k])
                worst = max(worst, abs(v - b[k]) / lim)
    anomaly = [[v["sentinel/anomaly"] for v in g] for g in got]
    spike_at = [float(i == DIST_OPT_SPIKE_AT)
                for i in range(DIST_OPT_GUARD_STEPS)]
    checks.update({
        "guard: the spike skipped at step 3 only, on both ranks": all(
            a == spike_at for a in anomaly) and all(
            [v["sentinel/spike"] for v in g] == spike_at for g in got),
        "guard: the unsharded run skips the same step":
            [v["sentinel/anomaly"] for v in want] == spike_at,
        "guard: every probe value and verdict bitwise across the ranks":
            got[0] == got[1],
        "guard: probes within PROBE_TOL of the unsharded run":
            worst <= 1.0 and counts_equal
            and all(a.keys() == b.keys() for a, b in zip(got[0], want)),
        "guard: one host sync a step on both ranks": all(
            r["guard"]["host_syncs_per_step"] == [1] * DIST_OPT_GUARD_STEPS
            for r in ranks),
        "guard: K1/K2 sharded entries launched": all(
            all(r["guard"]["launches"][k] > 0 for k in SHARDED_WRAPPERS)
            for r in ranks)})
    arms_out = {name: {
        "rank_peak_memory_bytes": [b[name]["peak_memory_bytes"] for b in by],
        "rank_dry": [b[name]["dry"] for b in by],
        "rank_local_param_bytes": [b[name]["local_param_bytes"] for b in by],
        "rank_local_state_bytes": [b[name]["local_state_bytes"] for b in by],
        "rank_init_allocated_bytes": [b[name]["init_allocated_bytes"]
                                      for b in by],
        "rank_step_seconds": [b[name]["step_seconds"] for b in by],
        "rank_collectives_per_step": [b[name]["collectives_per_step"]
                                      for b in by],
        "rank_launches": [b[name]["launches"] for b in by],
        "losses": by[0][name]["losses"]} for name, _ in BASELINE_ARMS}
    guard = {"losses": ranks[0]["guard"]["losses"],
             "unsharded_anomalies": [v["sentinel/anomaly"] for v in want],
             "rank_anomalies": anomaly,
             "trust_worst": [v.get("sentinel/trust_worst") for v in got[0]],
             "probe_max_ratio_to_tol": worst,
             "rank_host_syncs_per_step": [r["guard"]["host_syncs_per_step"]
                                          for r in ranks],
             "rank_launches": [r["guard"]["launches"] for r in ranks],
             "rank_collectives_per_step": [r["guard"]["collectives_per_step"]
                                           for r in ranks],
             "rank_step_seconds": [r["guard"]["step_seconds"] for r in ranks],
             "rank_peak_memory_bytes": [r["guard"]["peak_memory_bytes"]
                                        for r in ranks]}
    failed = [k for k, ok in checks.items() if not ok]
    emit("dist", sub="optimizers", arch=ARCH_ID, mesh=[world], batch=4,
         seq=1024, n_params=by[0]["adamw"]["n_params"],
         table1={"n_layers": DIST_GLOO_LAYERS, "dtype": "bfloat16",
                 "steps": DIST_OPT_STEPS, "arms": arms_out},
         parity={"n_layers": DIST_OPT_LAYERS, "dtype": "float32",
                 "tolerance": {"loss_rtol": DIST_LOSS_RTOL, **DIST_PARAM_TOL,
                               "near_zero_share": NEAR_ZERO_SHARE},
                 **parity},
         guard={"n_layers": DIST_OPT_LAYERS, "dtype": "float32",
                "steps": DIST_OPT_GUARD_STEPS, "spike_at": DIST_OPT_SPIKE_AT,
                "trust_max": DIST_OPT_TRUST_MAX, "lr": DIST_OPT_GUARD_LR,
                "probe_tolerance": PROBE_TOL, **guard},
         spawn_seconds=spawn_s, seconds=time.time() - t0, checks=checks)
    if failed:
        raise AssertionError(f"dist optimizers: {failed}")
    return {"seconds": time.time() - t0}


def phase_dist(train, subs=None, warm_library=False) -> dict:
    """The sharded run on the card (module docstring).  Without the train
    phase (``--phases dist``) only the sub-phases that are not held against
    its run: deepseek-v3-671b on a model axis (``dist_model_mla``), then
    the fp32 ones each held against its own unsharded run
    (``MODEL_RUN_SUBS``), or those of them ``subs`` names (``model_mla``
    among them); then it returns None."""
    import torch.distributed as dist
    t0 = time.time()
    root = resume_root("chip_smoke_dist_")
    if train is None:
        subs = subs or ("model_mla",) + MODEL_RUN_SUBS
        try:
            t_mla = time.time()
            if "model_mla" in subs:
                dist_model_mla(root)
            mla_s = time.time() - t_mla
            dist_model_runs(root, [sub for sub in MODEL_RUN_SUBS
                                   if sub in subs])
        finally:
            shutil.rmtree(root, ignore_errors=True)
        emit("dist", sub="done", seconds=time.time() - t0,
             mla_seconds=mla_s, model_runs_seconds=time.time() - t_mla - mla_s)
        return None
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    opt_ranks = None
    try:
        progress("dist: one-rank NCCL world, full size")
        nccl = dist_nccl(train)
        progress("dist: two gloo ranks on (2,) then on (1, 2) in one "
                 "world, then elastic restores")
        t_gloo = time.time()
        refs = dist_gloo_and_elastic(root)
        dist_model_axis(root, refs)
        gloo_s = time.time() - t_gloo
        t_mla = time.time()
        dist_model_mla(root)
        gc.collect()
        torch.cuda.empty_cache()
        mla_s = time.time() - t_mla
        progress("dist: the optimizer side of a mesh, two gloo ranks, "
                 "started beside the model-axis worlds")
        opt_ranks = start_dist_optimizers(root)
        if warm_library:
            LIBRARY_WARMUP.append(PartialLibraryWarmup())
        t_runs = time.time()
        # the compile's thread joined before the checks' unsharded runs,
        # which draw from the process's random state
        runs = dist_model_runs(
            root, MODEL_RUN_SUBS,
            before_checks=LIBRARY_WARMUP[0].thread.join if LIBRARY_WARMUP
            else None)
        runs_s = time.time() - t_runs
        progress("dist: the optimizer side of a mesh, its ranks joined")
        opt = dist_optimizers(root, opt_ranks)
    finally:
        if opt_ranks is not None:
            for proc in opt_ranks[1].processes:
                if proc.is_alive():
                    proc.kill()
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    emit("dist", sub="done", seconds=time.time() - t0,
         gloo_and_model_1x2_seconds=gloo_s, mla_seconds=mla_s,
         model_runs_seconds=runs_s, optimizers_seconds=opt["seconds"])
    return {"launches": nccl["launches"],
            "mode3_launches": runs["model_2x2"]["mode3_launches"][0],
            "partial_launches": runs["serve_1x2"]["partial_launches"][0]}


# --------------------------------------------------------------------------
# sweep: the sweep driver's subprocess members on the card
# --------------------------------------------------------------------------

SWEEP_ID = "mamba2-1.3b"
SWEEP_DATA = (2, 512)
SWEEP_STEPS = 2
SWEEP_VARIANTS = [{"opt.lr": 5e-4}, {"opt.lr": 1e-3},
                  {"opt.name": "lomo", "opt.lr": 1e-2}]
SWEEP_PARALLEL = len(SWEEP_VARIANTS)


def phase_sweep() -> dict:
    """``run_sweep`` in subprocess mode, all three members in flight at
    once on the card (for the whole script's time limit), on mamba2-1.3b at its published width and depth (2 x 512
    tokens, 2 steps a member, a checkpoint at the last step): AdaLomo at
    two learning rates and LOMO, each ``python -m repro_torch.launch.train
    --spec ... --device cuda``.  Every member done, ``report.json`` ranked
    by final loss; a second call skips all three (``DONE.json``).  Reports
    each member's wall seconds; the members' directories are removed."""
    from repro_torch.fleet.sweep import run_sweep
    from repro_torch.run import CheckpointSpec
    t0 = time.perf_counter()
    held_bytes()
    B, T = SWEEP_DATA
    base = RunSpec(model=ModelSpec(SWEEP_ID, smoke=False),
                   data=DataConfig(vocab=0, seq_len=T, global_batch=B,
                                   seed=0),
                   opt=OptSpec(name="adalomo"),
                   steps=StepSpec(total=SWEEP_STEPS),
                   checkpoint=CheckpointSpec(every=SWEEP_STEPS, keep_last=1),
                   log_every=1, seed=0)
    root = resume_root("chip_smoke_sweep_")
    sweep_dir = os.path.join(root, "sweep")
    logs, again_logs = [], []

    def log(line):
        logs.append((time.perf_counter(), line))
        print("  " + line, flush=True)

    try:
        progress("sweep: 3 subprocess members")
        report = run_sweep(base, SWEEP_VARIANTS, sweep_dir,
                           mode="subprocess", parallel=SWEEP_PARALLEL,
                           log_fn=log)
        again = run_sweep(base, SWEEP_VARIANTS, sweep_dir,
                          mode="subprocess", parallel=SWEEP_PARALLEL,
                          log_fn=again_logs.append)
        with open(os.path.join(sweep_dir, "report.json")) as f:
            on_disk = json.load(f)
        tails = {}
        for row in report["members"]:
            with open(os.path.join(sweep_dir, row["name"],
                                   "stdout.log")) as f:
                tails[row["name"]] = f.read().strip().splitlines()[-3:]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def member(line):
        return line.split("]")[0][1:]

    start = {member(line): t for t, line in logs if "launched" in line}
    wall = {member(line): t - start[member(line)] for t, line in logs
            if " exit " in line}
    rows = {r["name"]: r for r in report["members"]}
    failed = []
    if report["n_done"] != len(SWEEP_VARIANTS):
        statuses = {n: r["status"] for n, r in rows.items()}
        failed.append(f"{report['n_done']} members done: {statuses}; "
                      f"stdout tails {tails}")
    losses = [rows[n].get("final_loss") for n in report["ranking"]]
    if (len(losses) != len(SWEEP_VARIANTS)
            or not all(math.isfinite(x) for x in losses)
            or losses != sorted(losses)):
        failed.append(f"ranking {report['ranking']} by final losses "
                      f"{losses}")
    if on_disk["ranking"] != report["ranking"]:
        failed.append("report.json's ranking differs from the returned one")
    if (sum("skipping" in line for line in again_logs) != len(SWEEP_VARIANTS)
            or any("launched" in line for line in again_logs)
            or again["ranking"] != report["ranking"]):
        failed.append(f"second call: {again_logs}")
    emit("sweep", arch=SWEEP_ID, batch=B, seq=T, steps=SWEEP_STEPS,
         mode="subprocess", parallel=SWEEP_PARALLEL, variants=SWEEP_VARIANTS,
         ranking=report["ranking"],
         members={n: {"status": r["status"], "final_loss":
                      r.get("final_loss"), "steps_done": r.get("steps_done"),
                      "mean_tokens_per_s": r.get("mean_tokens_per_s"),
                      "wall_seconds": wall.get(n), "stdout_tail": tails[n]}
                  for n, r in rows.items()},
         second_call_skipped=sum("skipping" in line for line in again_logs),
         seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"sweep: {failed}")
    return {"wall_seconds": wall}


# --------------------------------------------------------------------------

PHASES = ("kernels", "train", "parity", "dist", "resume", "sentinel",
          "baselines",
          "packed", "serve", "serve_parity", "legacy_serve", "legacy_parity",
          "moe", "configs", "mla", "prefix", "ssm", "encdec", "sweep")
EXTRA_PHASES = ("timing", "configs_lomo")


# phase -> its wall seconds in this run (``timed``; the phase_seconds line)
PHASE_SECONDS = {}


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept under ``name`` in
    ``PHASE_SECONDS``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-joined subset of " + ",".join(PHASES) +
                         " (the result line is printed only when all ran); "
                         "kernels,serve is a short call after touching K3 "
                         "or the paged engine, kernels,legacy_serve,"
                         "legacy_parity after touching K4, the legacy "
                         "engine or the long-sequence attention, "
                         "kernels,train,resume after touching the run "
                         "layer or the checkpoints, kernels,train,dist "
                         "after touching the sharded step, the "
                         "collectives, the checkpoints or K1/K2's sharded "
                         "entries (dist alone: deepseek-v3-671b, "
                         "deepseek-moe-16b, paligemma-3b, mamba2-1.3b, "
                         "zamba2-1.2b and whisper-base on a model axis), "
                         "kernels,train,sentinel "
                         "after touching the sentinel or the probes, "
                         "kernels,baselines "
                         "after touching an optimizer rule, "
                         "kernels,packed after touching the segment "
                         "masks or the packed path, kernels,moe,configs "
                         "after touching the MoE FFN, the configs or the "
                         "head dims of K3/K4, kernels,mla after touching "
                         "MLA, MTP, the latent cache or deepseek-v3-671b, "
                         "kernels,prefix after touching the prefix-LM "
                         "masks, paligemma-3b or K4 at dh 256, "
                         "kernels,ssm,sweep after touching mamba2, the "
                         "hybrid family, zamba2's shared attention or the "
                         "sweep driver, kernels,encdec after touching the "
                         "encoder-decoder family (whisper-base), the fused "
                         "engine's ctx gradient or K4's rings; "
                         "configs_lomo (not in the "
                         "default) qwen3-32b's fused LOMO step; timing "
                         "(not in the default) times the kernels without "
                         "checking them and prints their outputs' digests")
    ap.add_argument("--subs", default="",
                    help="with --phases dist and no train: the comma-joined "
                         "dist sub-phases to run, of model_mla," +
                         ",".join(MODEL_RUN_SUBS) + " (default: all)")
    ap.add_argument("--src", default=SRC,
                    help="the src directory to import repro_torch from "
                         "(default: this checkout's); another tree's, to "
                         "time a parent commit with this script")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES) - set(EXTRA_PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(DEV)
    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, nvcc=build.find_nvcc(), matmul_allow_tf32=False,
         cudnn_allow_tf32=False, src=SRC)

    if "timing" in phases:
        timed("timing", phase_timing)

    kern = timed("kernels", phase_kernels) if "kernels" in phases else None
    train = timed("train", phase_train) if "train" in phases else None
    torch.cuda.empty_cache()
    if "parity" in phases:
        timed("parity", phase_parity)
        torch.cuda.empty_cache()
    subs = [s for s in args.subs.split(",") if s]
    unknown = sorted(set(subs) - {"model_mla", *MODEL_RUN_SUBS})
    if unknown or (subs and "train" in phases):
        ap.error(f"--subs {args.subs}: unknown {unknown}, or with train")
    dist_rec = (timed("dist", phase_dist, train, subs,
                      warm_library=kern is not None)
                if "dist" in phases else None)
    if train is not None:
        train.pop("params_cpu", None)
    gc.collect()
    torch.cuda.empty_cache()
    if "resume" in phases:
        timed("resume", phase_resume)
        # the process's first profiler start keeps its caller's frames (run
        # A's) in a reference cycle; free them before the serving phases
        gc.collect()
        torch.cuda.empty_cache()
    if "sentinel" in phases:
        timed("sentinel", phase_sentinel, train)
        gc.collect()
        torch.cuda.empty_cache()
    if "baselines" in phases:
        timed("baselines", phase_baselines)
        torch.cuda.empty_cache()
    if "packed" in phases:
        timed("packed", phase_packed)
        gc.collect()
        torch.cuda.empty_cache()
    serve = timed("serve", phase_serve) if "serve" in phases else None
    torch.cuda.empty_cache()
    if "serve_parity" in phases:
        timed("serve_parity", phase_serve_parity)
        torch.cuda.empty_cache()
    legacy = (timed("legacy_serve", phase_legacy_serve)
              if "legacy_serve" in phases else None)
    torch.cuda.empty_cache()
    if "legacy_parity" in phases:
        timed("legacy_parity", phase_legacy_parity)
    gc.collect()
    torch.cuda.empty_cache()
    moe = timed("moe", phase_moe) if "moe" in phases else None
    gc.collect()
    torch.cuda.empty_cache()
    configs = (timed("configs", phase_configs) if "configs" in phases
               else None)
    gc.collect()
    torch.cuda.empty_cache()
    mla = timed("mla", phase_mla) if "mla" in phases else None
    gc.collect()
    torch.cuda.empty_cache()
    prefix = timed("prefix", phase_prefix) if "prefix" in phases else None
    gc.collect()
    torch.cuda.empty_cache()
    ssm = timed("ssm", phase_ssm) if "ssm" in phases else None
    gc.collect()
    torch.cuda.empty_cache()
    encdec = timed("encdec", phase_encdec) if "encdec" in phases else None
    gc.collect()
    torch.cuda.empty_cache()
    if "sweep" in phases:
        timed("sweep", phase_sweep)
    if "configs_lomo" in phases:
        timed("configs_lomo", phase_configs_lomo)
    if kern is not None:
        progress("kernels: the library call of K4's partial entry")
        timed("kernels_library", time_k4_partial_library,
              kern["rows"]["decode_attention_partial"],
              LIBRARY_WARMUP[0] if LIBRARY_WARMUP else None)
    emit("phase_seconds", **PHASE_SECONDS)
    if set(phases) != set(PHASES):
        print("chip_smoke: partial run (--phases); no result line")
        sys.exit(3)

    kernels = []
    for name, src, replaces, launches, unit, library in (
            ("adalomo_stats", "adalomo_update/csrc/adalomo_stats.cu",
             "adalomo_update/adalomo_update.py:68",
             train["launches"]["adalomo_stats"], TRAIN_UNIT, None),
            ("adalomo_update", "adalomo_update/csrc/adalomo_update.cu",
             "adalomo_update/adalomo_update.py:137",
             train["launches"]["adalomo_update"], TRAIN_UNIT, None),
            ("paged_decode_attention",
             "decode_attention/csrc/paged_decode_attention.cu",
             "decode_attention/decode_attention.py:109",
             serve["launches"], DECODE_UNIT,
             kern["totals"]["paged_decode_attention"]["library_ms"]),
            ("decode_attention", "decode_attention/csrc/decode_attention.cu",
             "decode_attention/decode_attention.py:163",
             legacy["launches"], RING_UNIT,
             kern["totals"]["decode_attention"]["library_ms"])):
        t = kern["totals"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": launches,
            "max_abs_err": max(kern["errs"][name],
                               mla["errs"].get(name, 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": library, "unit": unit,
            "launches_by_phase": {
                "train" if name.startswith("adalomo") else
                "serve" if name.startswith("paged") else "legacy_serve":
                launches,
                "moe": moe["launches"].get(name, 0),
                "configs": configs["launches"][name],
                "mla": mla["launches"].get(name, 0),
                "prefix": prefix["launches"].get(name, 0),
                "ssm": ssm["launches"].get(name, 0),
                "encdec": encdec["launches"].get(name, 0)}})
        if name == "paged_decode_attention":
            kernels[-1]["library_note"] = PAGED_LIBRARY_NOTE
        if name.endswith("decode_attention"):
            # per launch at dh 256 (paligemma-3b's 8 query heads over 1),
            # at zamba2-1.2b's 32/32 heads and at whisper-base's 8/8, dh 64
            for key, heads in (("dh256_per_launch", None),
                               ("zamba2_dh64_per_launch", [32, 32, 64]),
                               ("whisper_dh64_per_launch", [8, 8, 64])):
                kernels[-1][key] = {
                    shape: {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")}
                    for shape, row in kern["rows"][name].items()
                    if (row["heads"] == heads if heads
                        else row["heads"][2] == 256)}
        if name.startswith("adalomo"):
            key = "stats" if name == "adalomo_stats" else "update"
            kernels[-1]["deepseek_v3_expert_batch_per_call"] = {
                shape: {k.replace(key + "_", ""): v for k, v in row.items()
                        if k.startswith(key + "_")}
                for shape, row in mla["per_call"].items()}
    for name, src, replaces, wrappers in (
            ("adalomo_stats_sharded", "adalomo_update/csrc/adalomo_stats.cu",
             "adalomo_update/adalomo_update.py:68",
             ("adalomo_stats_partial", "adalomo_stats_fold")),
            ("adalomo_update_sharded", "adalomo_update/csrc/adalomo_update.cu",
             "adalomo_update/adalomo_update.py:137",
             ("adalomo_update_partials", "adalomo_update_apply"))):
        t = kern["totals"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": sum(dist_rec["launches"][w] for w in wrappers),
            "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "unit": SHARDED_UNIT,
            "launches_by_wrapper": {w: dist_rec["launches"][w]
                                    for w in wrappers},
            "launches_phase": "dist (one-rank NCCL world, 3 steps)"})
    t = kern["totals"]["adalomo_stats_2d"]
    kernels.append({
        "name": "adalomo_stats_2d", "route": "cuda",
        "source": "src/repro_torch/kernels/adalomo_update/csrc/"
                  "adalomo_stats.cu",
        "replaces": "src/repro/kernels/adalomo_update/adalomo_update.py:68",
        "launches": dist_rec["mode3_launches"],
        "max_abs_err": kern["errs"]["adalomo_stats_2d"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "unit": BLOCK_UNIT,
        "launches_phase": "dist model_2x2 (rank 0 of four gloo ranks on "
                          "(2, 2), 2 steps)"})
    t = kern["totals"]["decode_attention_partial"]
    kernels.append({
        "name": "decode_attention_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:163",
        "launches": dist_rec["partial_launches"],
        "max_abs_err": kern["errs"]["decode_attention_partial"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"],
        "sdpa_o_only_ms": t["sdpa_o_only_ms"], "unit": PARTIAL_UNIT,
        "launches_phase": "dist serve_1x2 (rank 0 of two gloo ranks on "
                          "(1, 2): a prefill and 16 decode steps)"})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


TRAIN_UNIT = ("one train step: the 170 matrices of h2o-danube-1.8b, bf16 "
              "params and grads")
DECODE_UNIT = ("one decode step of h2o-danube-1.8b: 24 launches, 8 sequences "
               "of 1024 cached tokens, bf16")
PAGED_LIBRARY_NOTE = ("two PyTorch calls, not one: the pages gathered into "
                      "a dense cache, then scaled_dot_product_attention "
                      "with enable_gqa and a boolean mask")
SHARDED_UNIT = ("one rank's share of a train step at a 2-way split: the 170 "
                "matrices of h2o-danube-1.8b, each halved along the dim the "
                "rules split, bf16 params and grads; both launches of the "
                "entry pair")
BLOCK_UNIT = ("one rank's share of a train step on a (2, 2) mesh: the 170 "
              "matrices of h2o-danube-1.8b, each a quarter block (rows and "
              "columns halved), bf16 grads; K1's mode 3 launch alone")
PARTIAL_UNIT = ("one launch of K4's partial entry at serve_1x2's block: "
                "h2o-danube-1.8b's 32/8 heads, dh 80, 4 sequences over a "
                "block of 2048 of a ring's 4096 slots, every slot valid, "
                "fp32; library_ms: flex_attention with enable_gqa and the "
                "log-sum-exp, compiled (sdpa_o_only_ms: SDPA's time for o "
                "alone)")
RING_UNIT = ("one decode step of h2o-danube-1.8b: 24 launches, 4 sequences "
             "over a wrapped ring of 4096 slots, window 4096, bf16")


if __name__ == "__main__":
    main()
