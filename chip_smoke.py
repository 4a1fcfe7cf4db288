#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--quick]

Phases, each of which raises (and so exits non-zero) on a failed check:

1. Print the card's name and power limit (nvidia-smi), build every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc`` into
   ``build/repro_torch/``, and print the registers, spills and resident
   CTAs an SM of the SIMT core's kernels (the f32 matmuls and
   ``sfc_tile_update``), of the register-tiled f32 core's kernels (rows
   20 at D = 64, 80, 128 and 22), of row 20's tensor-core kernel (D =
   64, 80, 128) and of the
   k-means update (D = 128 and 960, and the shard update), fold and
   assign (the one kernel of the three assign entries), of the ε-join's
   kernel of each pass (16-deep stages, and 8-deep for D <= 8), and of
   Floyd–Warshall's diagonal closure and panel kernel (with the panels'
   widest grid, table rows × strips, as the launcher records it over the
   panel launches of the main path's two calls' shapes).
2. Hold each kernel against its plain PyTorch version on the same CUDA
   inputs, at a small ragged and a mid-size shape (the k-means update up
   to D = 960, its column-chunked grid, and its group partials through
   both update entries equal to the bit to ``group_partials`` on the CPU
   at D = 128 and 960 over 400 tiles; ``sfc_chol_diag`` equal to
   ``_chol_tile`` to the bit; ``sfc_matmul3d`` bf16 to bf16 and to f32),
   and the reference paths against
   the fused ones; the sharded paths' kernels (rows 7, 9, 11) on every
   shard, shards of pure padding and a halo table whose slots are not the
   global tile ids included (``compare_sharded``).
3. Reset the launch counts, drive the main path through the public entry
   points at realistic sizes, and read the counts:
   ``ops.matmul`` (8192³ f32, TF32 off; 8000×7000×6000 bf16; both once
   more with ``schedule_ndim=3``), ``ops.kmeans_lloyd`` (1,000,000 × 128
   f32, K = 1024, 10 iterations — SIFT1M's shapes; once more with
   ``fused=False``; and GIST1M's 1,000,000 × 960, K = 1024, 3 iterations,
   fused and not), ``ops.kmeans_assign`` (the 1,000,000 points and a
   4,096-probe batch against the Lloyd run's centroids),
   ``ops.simjoin_counts`` and ``ops.simjoin_pairs`` (262,144 × 16 f32, ε
   for a mean of ~32 neighbours; once more with ``hilbert_order=True``),
   ``ops.floyd_warshall`` (an 8192-node random digraph, edge probability
   0.05, integer weights 1..100; and 5000 nodes, padded to 5016 with
   b = 88) and ``ops.cholesky`` (an 8192-point Gaussian-process covariance
   M·Mᵀ/n + I; and n = 6001, padded to 6016), both 8192 calls once more
   with ``fused=False``; then the streaming services: ``StreamKMeans``
   (the first 131,072 of 262,144 SIFT-width points in 128 insert requests
   of 1,024, one per tick, a 4,096-probe assign every 8 ticks; decay 1.0
   and 0.9) and ``StreamSimJoin`` (the first 131,072 of 262,144 points
   uniform in the unit cube, ε = 0.0308 for ~32 neighbours among the
   262,144, 128 inserts of 1,024, a 1,024-point query every 8 ticks; once
   more with ``max_residents=65,536``).  Every kernel must have launched,
   and both cores of ``sfc_matmul`` and ``sfc_matmul3d``
   (``LAUNCHES.cores()``: the f32 calls on SIMT, the bf16 ones on
   ``wgmma``).
4. Check the results against the ``ref.py`` oracles: matmul allclose;
   k-means assignments exact outside the float64 tie band and centroids
   allclose; ε-join counts and pair set exact outside the float64
   threshold band (the band sizes are printed); Floyd–Warshall equal to
   the dense k-loop (exact on integer weights); Cholesky within 1e-4 of
   the float64 factor and of A (relative); fused equal to ``fused=False``
   for the phased apps and for k-means; every input unchanged; the
   streams: StreamKMeans with every point inserted in one tick, then 10
   ticks, equal to the bit to ``ops.kmeans_lloyd``, its assign results
   exact outside the tie band; StreamSimJoin's pairs equal to
   ``ops.simjoin_pairs`` on the inserted points (restricted to the pairs
   whose older point was still resident) and its query results equal to
   brute force, outside the threshold band.
5. Time each kernel at the main path's shapes with CUDA events (median of
   a few runs), its plain version (one run) and, where one PyTorch call
   computes the same function, that call; compute each kernel's bound
   (``sfc_matmul`` in f32 and, on its tensor-core core, in bf16; the SM
   clock read beside the 8192³ f32 matmuls, ``sfc_kmeans_assign`` and
   their library calls).
   The phased kernels are timed per entry point: the launches of one
   phase over all k-blocks of one call (``sfc_chol_diag`` also against
   one ``linalg.cholesky`` call per diagonal tile; ``sfc_chol_trailing``
   against the 63 in-place ``addmm_`` of the trailing squares and beside
   the per-k form's ``sfc_tile_update`` on the same tiles, which must
   leave the matrix equal to the bit); the k-means assigns also against
   ``addmm`` + ``min`` (one cuBLAS product and one read of the metric
   matrix) beside ``cdist`` + ``argmin``, ``sfc_kmeans_assign`` at
   GIST1M's width too; ``sfc_tile_update`` on the 64 x 64
   tile grid at Kp = 128 equal to the bit to ``O - sfc_matmul(A, Bᵀ)``,
   the chain both compute;
   ``sfc_chol_panel`` is first held on its own against ``_solve_tiles`` on
   the panels of k = 0 and k = 32 of the 8192 call, as the fused program
   leaves them; ``sfc_matmul3d`` in bf16 with bf16 and f32 outputs; the
   join passes (rows 8–11) with their persistent CTAs, ring and
   registers; Floyd–Warshall's diagonal and panels with their device time
   (torch.profiler) beside the event time, the panels with their strips
   and CTAs a launch.
6. Run the main path's calls once more, warm, under ``torch.profiler``:
   wall time, kernel (device) time and the device's busy share per call,
   and one warm tick of each streaming service.
7. LM serving (``serving_path``), TinyLlama-1.1B at full width with
   seeded random weights: (a) the three flash kernels against their plain
   versions at the serving shapes, f32 and bf16 (the bf16 prefill on
   its tensor-core core, the f32 one on the register-tiled core, in both
   at half the query heads, ps g = 64, two q tiles a CTA, on those same
   cores, and at 5 of the 8 query heads, Qwen's ps g = 80, on the SIMT
   core); (b) with the launch
   counts reset, the bf16 ``ServeEngine`` (paged, flash, compiled
   prefill, prefix sharing, Hilbert page layout; 8 slots, max_len 2048)
   serves 16 requests (prompts of 64-1024 tokens, every other one behind
   a shared 256-token prefix, 32-128 new tokens), every one of its
   ``sfc_flash_prefill`` launches on the tensor-core core, and, counted apart,
   ``forward`` of 2 x 2048 tokens with ``use_hilbert_kernels``, whose
   22 ``sfc_flash_attention`` launches must all be on the tensor-core
   core (and its wall time again, warm); prints
   tokens/s, time to first token, tick p99, pages and the busy share of
   a warm decode tick; (c) the f32 gate: 8 requests served on f32
   weights, every ``sfc_flash_prefill`` launch of its admissions on the
   register-tiled core (counted, with the admissions' wall time), each
   served token equal to the dense forward's argmax outside
   the top-2 margin band, the flash decode step allclose to the page
   gather, and the f32 ``forward`` of 1 x 2048 tokens with
   ``use_hilbert_kernels`` (its 22 ``sfc_flash_attention`` launches all on
   the register-tiled core, counted apart) against the plain forward:
   logits allclose, argmax equal outside the top-2 margin band, its wall
   time and the flash kernels' device time; (d) each flash kernel's
   time, bound, plain version and a PyTorch SDPA call
   (``sfc_flash_attention`` and ``sfc_flash_prefill`` in bf16 and f32;
   ``sfc_flash_decode``, whose call is shorter on the
   card than on the host, by the device time of its kernels and of the
   gather + SDPA call's, beside both calls' CUDA-event times, with its
   split-KV launch and its time at other split sizes).
7b. DeepSeek-V2 paged serving (``mla_serving_path``, after TinyLlama's
   weights are freed): (a) ``compare flash latent``: rows 21 and 22 on
   the latent core (one kv head, the latent pool given as K and V, f32
   queries) against their plain versions at MLA's full shapes (8 slots,
   g 128, D 576, pools of 16-row pages in bf16 and in f32, Tq 1024 for
   prefill) and at D = 48, g = 4, ragged positions and garbage in the
   trash page; (b) ``serving deepseek:``: DeepSeek-V2 at full width, its
   depth cut to MLA_LAYERS = 4 of 60, bf16, seeded random weights, the
   paged flash engine (8 slots, max_len 2048, compiled prefill, prefix
   sharing) serving 16 requests (prompts of 64-1024 tokens, every other
   one behind a shared 256-token prefix, 16-64 new tokens), every
   ``sfc_flash_prefill`` / ``sfc_flash_decode`` launch on the latent core,
   4 x the admissions and 4 x the decode ticks of them; the warm decode
   tick's ``profile:``; (c) ``check serving deepseek gate:``: the same
   model at 1 layer in f32, the paged flash engine's greedy tokens equal
   to the dense-cache engine's (``mla_decode``) up to each request's first
   token inside the top-2 margin band (or behind a routing flip of the
   two engines within ROUTER_GATE_BAND, as 7d's gate), one decode step
   flash vs "xla";
   (d) ``time sfc_flash_decode latent`` / ``time sfc_flash_prefill
   latent``: ms, bound (FP32 operations), plain ms and a page gather +
   SDPA in f32.
7c. Mamba2-2.7B and Zamba2-2.7B dense serving (``ssm_serving_path``, after
   DeepSeek's weights are freed): (a) ``compare flash d80``: row 20 at
   Zamba2's shared-attention shapes (B·H 64, S 2048, D 80, causal) in bf16
   and f32 against its plain version, the core read from the launch
   record (bf16 on "wgmma", f32 on "tiled"), and ``flash_rows`` ("simt")
   at D = 80 on tiles of 64 beside them; (b) ``serving mamba2:`` and (c)
   ``serving zamba2:``: each model at full width and depth (64 layers;
   54 + 9 shared-block applications), bf16, seeded random weights, on the
   dense engine (8 slots, max_len 2048, chunked prefill) serving 8
   requests (prompts of 16-64 tokens, 16-64 new tokens): tokens/s, TTFT,
   tick p99, the cache's bytes, the where-merge's ms, a warm decode tick's
   ``profile:``; then Zamba2's ``forward`` of 2 x 2048 tokens with
   ``use_hilbert_kernels``, its 9 ``sfc_flash_attention`` launches counted
   apart, all on wgmma (the logits' difference from the plain forward
   reported); (d) ``check serving mamba2 gate:`` / ``check serving zamba2
   gate:``: each model in f32 at full depth, 4 requests (prompts of
   128-160, 16-32 new tokens) whose served tokens equal the argmax of the
   f32 forward replay outside the top-2 margin band (Zamba2's replay with
   ``use_hilbert_kernels``: row 20 at D = 80 in f32, its launches
   counted, all on tiled), each decode step's logits against the
   forward's at the same position (the recurrence against the chunked SSD
   form), and Zamba2's f32 forward of 1 x 2048 tokens through row 20
   against the plain forward (allclose at STEP_TOL, argmax outside the
   band); (e) ``time
   sfc_flash_attention d80``: ms, bound, plain ms and SDPA, bf16 and f32,
   the core from the launch record and ``flash_rows``' time at D = 80
   (tiles of 64) in the same run as the "was" time.
7d. OLMoE-1B-7B paged serving (``olmoe_serving_path``, after the SSM
   weights are freed; MHA: 16 query over 16 kv heads, g = 1, D = 128):
   (a) ``compare flash mha``: rows 21 and 22 at OLMoE's serving shapes (8
   slots, Hkv 16, g 1, D 128, 128 pages of 16; ragged positions with a
   slot at pos -1, garbage in the trash page; the prefill cohort of phase
   7) and row 20 at D = 128 (2 x 16 x 2048, causal) against their plain
   versions, bf16 and f32, each launch's core read from the launch record
   (decode on split, prefill on the core ``prefill_core`` names: ps g = 16
   rows a q tile, 8 tiles a CTA on wgmma / tiled; row 20 on wgmma /
   tiled); (b) ``serving olmoe:``: the
   model at full size (16 layers, 64 experts, top-8; 13.84 GB of bf16
   weights, seeded random) on the paged flash engine (8 slots, max_len
   2048, compiled prefill, prefix sharing, Hilbert page layout) serving 10
   requests, a wave and two more (prompts of 64-1024 tokens, every other
   one behind a shared 256-token prefix, 16-64 new tokens): tokens/s,
   TTFT, tick p99, pages,
   the bytes of the weights and of the pool; 16 x the decode ticks of
   ``sfc_flash_decode`` launches, all on split, and 16 x the admissions of
   ``sfc_flash_prefill`` launches, all on ``prefill_core``'s core; a warm
   decode tick's ``profile:``; the bf16 ``forward`` of 2 x 2048 tokens with
   ``use_hilbert_kernels``, its 16 ``sfc_flash_attention`` launches counted
   apart, all on wgmma (wall time, the logits' difference from the plain
   forward reported); (c) ``check serving olmoe gate:``: the model in f32
   at 8 of its 16 layers (OLMOE_GATE_LAYERS; 27.68 GB at full depth), 4
   requests (prompts of 64-192 tokens, every
   other one behind a shared 128-token prefix, 16-32 new tokens) through
   the paged flash engine and the dense-cache engine
   (``gqa_decode`` on ``_sdpa``, independent of rows 21-22): each
   request's tokens equal up to its first token inside the top-2 margin
   band (GATE_BAND), or behind a routing flip of the two engines that is a
   near-tie (ROUTER_GATE_BAND; both engines' routing is logged by (request,
   position, layer)); one decode step flash vs "xla"; the f32 forward of 1
   x 2048 tokens through row 20 (a launch a layer, on tiled) against the
   plain forward at STEP_TOL up to its first routing flip; (d) ``time ...
   mha`` / ``time sfc_flash_attention d128``: ms (row 21 also its device
   time), bound, plain ms, the library call (page gather + SDPA for rows
   21-22, SDPA with is_causal for row 20) and the core, bf16 and f32; row
   22 also its CTAs and rows a CTA from the launch record and
   ``flash_rows_ms``, the SIMT core (``flash_rows``, one q tile a CTA)
   on the same cohort in the same run, the "was" time.
7e. Qwen2.5-14B paged serving (``dense_serving_path(QWEN, ...)``, after
   OLMoE's weights are freed; GQA: 40 query over 8 kv heads, g = 5, D = 128, QKV
   bias): (a) ``compare flash g5``: rows 21 and 22 at Qwen's serving
   shapes (8 slots, Hkv 8, g 5, D 128, 128 pages of 16; the cohorts of
   7d) against their plain versions, bf16 and f32, decode on split and
   prefill on wgmma / tiled (CTAs of 25 tokens, 125 rows); (b) ``serving
   qwen:``: the model at full size (48 layers; 29.54 GB of bf16 weights,
   seeded random, the QKV biases drawn N(0, 0.02)) on the 7d engine
   serving 16 requests of 7d's mix (two waves): tokens/s, TTFT, tick p99,
   pages, a warm tick's wall and device time; 48 x the decode ticks of
   ``sfc_flash_decode`` launches on split and 48 x the admissions of
   ``sfc_flash_prefill`` launches on wgmma, none on simt, each timed by
   CUDA events (``prefill_attention_ms`` beside the admissions' wall);
   (c) ``check serving qwen gate:``: f32 at full depth (59.08 GB), 8
   requests through the paged flash engine (prefill on tiled) and the
   dense-cache engine, both of 384 positions a slot, as 7d's gate, with
   the peak allocated bytes beside the prediction; (d) ``time ... g5``:
   rows 21 and 22 at g = 5 as 7d's (d).
7f. HuBERT-xlarge encodes (``hubert_path``, after Qwen's weights are
   freed; encoder only: not causal, f32 frame embeddings in, 504 cluster
   logits a frame out; 16 heads of D = 80): (a) ``compare flash full
   d80``: row 20 at HuBERT's shape with the full (rectangular) table, B·H
   256, S 1,536 (1,500 frames zero-padded, as ``ops.attention`` pads them),
   ``kv_valid`` 1,500, tiles of 128, against its plain version, bf16 on
   wgmma and f32 on tiled (the cores read from the launch record, none
   simt); (b) ``encode hubert:``: the model at full size (48 layers, d
   1,280; 1.89 GB of bf16 weights, seeded random) runs ``forward`` with
   ``use_hilbert_kernels`` over 16 utterances x 1,500 frames of seeded
   N(0, 1) f32 embeddings: 48 ``sfc_flash_attention`` launches, all on
   wgmma; cold and warm wall, frames/s, a warm call's ``profile:``
   (device time, busy share), the peak allocated bytes, the logits'
   difference from the bf16 plain forward (reported), and
   ``make_prefill_step`` on the same batch (the last frame's logits,
   timed); (c) ``check encode hubert gate:``: f32 at full depth on the
   same batch, the forward through row 20 (48 launches on tiled) against
   the plain forward (``_sdpa`` on the 1,500 frames, independent of row
   20) at STEP_TOL, argmax outside the margin band, and ``loss_fn`` on
   seeded cluster labels (a tenth -1) through both within 1e-4 relative;
   the peak allocated bytes; (d) ``time sfc_flash_attention full d80``:
   ms, bound (4 D operations for each of the 1,500² frame pairs, bytes of
   the padded q, k, v, o), plain ms and SDPA(is_causal=False) over the
   unpadded frames, bf16 and f32, the core from the launch record.
7g. Minitron-8B and StableLM-1.6B paged serving (``dense_serving_path``
   with ``MINITRON`` then ``STABLELM``, after HuBERT's weights are freed,
   each model's before the next's; Minitron: GQA 32 query over 8 kv heads,
   g = 4, D = 128, a tanh-GeLU MLP of 16,384, an untied head of 256,000;
   StableLM: MHA, 32 heads of D = 64, SwiGLU, an untied head of 100,352),
   for each model as 7e: (a) ``compare flash g4`` / ``compare flash
   mha_d64``: rows 21 and 22 at its serving shapes (the cohorts of 7d)
   against their plain versions, bf16 and f32, decode on split and prefill
   on wgmma / tiled (Minitron's CTAs of 32 tokens, two q tiles, StableLM's
   of 128, eight); (b) ``serving minitron:`` / ``serving stablelm:``: the
   model at full size in bf16 (15.47 / 3.29 GB of weights, seeded random,
   the parameter count held to the published one) serving 16 requests of
   7d's mix, the launches and cores of 7e (b), each prefill launch timed
   by CUDA events, a warm tick's profile and its ``unembed`` (the f32 cast
   of the bf16 head and the f32 product) timed by CUDA events; (c)
   ``check serving minitron gate:`` / ``check serving stablelm gate:``:
   f32 at full depth (30.94 / 6.58 GB), both engines of 2,048 positions a
   slot, as 7e's gate, the peak beside the prediction; (d) ``time ... g4``
   / ``time ... mha_d64``: rows 21 and 22 as 7d's (d), the kernels line's
   ``sfc_flash_decode.g4``, ``sfc_flash_prefill.g4``,
   ``sfc_flash_decode.mha_d64`` and ``sfc_flash_prefill.mha_d64``.
7h. Chameleon-34B paged serving (``dense_serving_path(CHAMELEON, ...)``,
   after StableLM's weights are freed; GQA: 64 query over 8 kv heads, g =
   8, D = 128, SwiGLU of 22,016, an untied head of 65,536, token ids in),
   as 7g: (a) ``compare flash g8_d128``: rows 21 and 22 at its serving
   shapes against their plain versions, decode on split (all 8 rows of a
   split CTA live) and prefill on wgmma / tiled (CTAs of 16 tokens, one q
   tile of 128 rows); (b) ``serving chameleon:``: the model at full size
   in bf16 (68.59 GB of weights), the launches, cores and events of 7g
   (b), the run's peak allocated bytes beside what earlier phases hold and
   CHAMELEON_SERVE_PEAK_PREDICTED, each engine freed before the next is
   built; (c) ``check serving chameleon gate:``: f32 at 16 of its 48 layers
   (CHAMELEON_GATE_LAYERS; 48.59 GB, the count held to the closed form at
   that depth), both engines of 2,048 positions a slot, the peak beside
   CHAMELEON_GATE_PEAK_PREDICTED; (d) ``time ... g8_d128``: the kernels
   line's ``sfc_flash_decode.g8_d128`` and ``sfc_flash_prefill.g8_d128``.
8. The curve-range-sharded apps (``sharded_path``), SHARDS = 4 shards on
   the one card (the code path of a mesh, not multi-GPU scaling): with the
   launch counts reset, ``ops.kmeans_lloyd(mesh=)`` on phase 3's SIFT1M
   data in the exact, tree and psum classes and exact on one shard, the
   halo ε-join (``ops.simjoin_pairs(mesh=, hilbert_order=True)``) and the
   replicated one on the stream's 262,144 points in the unit cube, and
   the replicated one on phase 3's 262,144 × 16 set; exact S = 4 and
   S = 1 equal to phase 3's single-core call to the bit, tree equal to
   itself, every class allclose to phase 3's centroids with assignments
   exact outside the band, every join array-equal to the single-core
   join; phase 3's default-``bp`` pairs in the 256-tile order and the
   reorder's time; collective counts and bytes per shard, the halo
   plan's rows and host time, a warm profile of each call, and the five
   sharded kernels' times, bounds and plain versions (the update also
   with the exact class's group partials; the assign against ``cdist`` +
   ``argmin`` and ``addmm`` + ``min`` over each shard's points).
9. The training stack (``training_path``; no kernel row: training runs
   no hand-written kernel, as the JAX package's runs no Pallas one):
   (a) ``check train card vs cpu:`` TinyLlama at full width and 1 layer
   in f32, one ``Trainer`` step of 1 x 2048 tokens on the card and the
   same step on the CPU from the same seeded state and batch: loss rel
   1e-5, grad norm rel 1e-4, the first moments (0.1 x the clipped grads)
   allclose, the parameters whose grad is away from 0 within
   TRAIN_PARAM_TOL of lr and every one within a step (2 lr); (b) ``check
   train recovery:`` the reference's exact-recovery case on the card (a
   ``SimulatedFailure`` at step 9 of 16: one restart, steps 12-15's
   losses rel 1e-5 of the uninterrupted run's); (c) ``train tinyllama:``
   TinyLlama-1.1B at full size in bf16 through the launcher's configs
   (``repro_torch.launch.train``: 2 x 2048 tokens x 2 micro-batches, 6
   steps, lr 3e-4, warm-up 2): each step's loss, grad norm, lr and
   seconds, the median wall of the 4 warm steps, a profiled step's device time
   and busy share, tokens/s, the step against its bound (the dry run's
   compute term of one micro-batch step, phase 11 (c), times the
   micro-batches), peak memory; every loss and grad norm finite (its
   steps run without checkpoints: an 11 GB save and restore took 60-70
   s).
10. The schedule autotuner (``autotune_path``), the tuning cache in a
   temporary file: ``autotune.autotune_app`` for each tunable entry point
   at phase 3's shapes and inputs (f32 matmul 8192³, SIFT1M Lloyd, the
   ε-join's counts and pairs at 262,144 × 16, Floyd–Warshall and
   Cholesky at 8192) over 4 curves each (AUTOTUNE_CURVES, the default
   first), 3 timed (the default and the 2 best by ``locality_rank``), 3
   repeats each: ``autotune <app>:`` lines with the card, each
   candidate's warm ms, the winner, the default's ms and the cold host
   seconds of each curve's first schedule build.  Checked: the winner
   recorded under ``cuda`` and not ``cpu``; ``choice="auto"`` equal to
   the explicit winner to the bit; the fastest non-default candidate's
   result equal to the default curve's (FW, Cholesky, matmul to the bit;
   counts equal; pairs set-equal; k-means exact outside the tie band,
   centroids allclose), its kernels counted in ``LAUNCHES``;
   ``launch(fw_program(...), choice=harmonious)`` equal to the default on
   the 8192 graph; an explicit FW block of 256 refused before any launch;
   a ``cpu`` entry unused on the card and a ``cuda`` one used.  Then the
   four example twins (``examples/*_torch.py``) run on the card at once,
   each within 120 s, every match line ``True``.
11. The dry run against the card (``dryrun_path``): for (a) Mamba2-2.7B
   x ``decode_32k`` (128 slots, a 32,768 state cache), (b) Zamba2-2.7B x
   ``long_500k`` (1 x 524,288 positions), (c) TinyLlama-1.1B training
   at one micro-batch of 2 x 2,048 (AdamW) and (d) HuBERT-xlarge
   training at one micro-batch of 4 x 4,096 frames (AdamW; seeded f32
   frame embeddings), the one-card dry run
   (``repro_torch.launch.dryrun.run_cell`` on ``make_one_card_mesh``,
   traced on the host) logs its prediction (``dryrun predict``: peak
   bytes, the roofline terms, FLOPs by dtype).  Then the cell is built
   from seeded weights on the card, the peak reset before its first
   input, and one cold and one warm step of the dry run's own step
   function run (``dryrun <cell>:``; (d) runs its profiled step alone as
   both, ``DRY_ONE_STEP``): the measured peak within 0.5 GiB
   plus 1 % of the prediction (DRY_TOL), the warm step against
   max(t_compute, t_memory), its fraction of the roofline, and against
   the arguments' bytes read once at the HBM rate (a floor that the
   memory term of a hybrid's decode misses: it leaves out the attention
   cache); one more warm step under torch.profiler gives the device's
   busy share.  (b) runs only where the prediction leaves 4 GiB of the
   card free, and says so otherwise.
12. Training, MoE expert parallelism and a decode cell on a ("data",
   "model") ``DeviceMesh`` of the one card, its devices repeated
   (``mesh_path``; a program a data shard, single-controller): (a)
   TinyLlama-1.1B at full size in bf16, one ``Trainer`` step of 4 x 512
   tokens on a (2, 4) mesh of ``cuda:0`` x 8 from the same state and
   batch as the one-card Trainer's, loss, grad norm and every leaf's
   gathered grads within MESH_TOL; a warm step of each, timed (wall and
   CUDA events), the mesh step's ``VolumeLedger``; ``reshard`` to (4, 2)
   and (8, 1), every parameter and moment to the bit, a step on each; the
   same comparison in f32 at 2 layers (``check mesh train f32 gate:``);
   (b) OLMoE-1B-7B at full width, 2 of its 16 layers (64 experts, top-8,
   16 a rank): the f32 EP forward (capacity factor 64) against the
   forward with no mesh within 1e-5 of the logits' scale, the aux within
   1e-6, and a bf16 train cell's step on the mesh (EP at the default
   capacity): a finite loss, every model rank's expert moments moved; (c)
   TinyLlama-1.1B f32: the decode ``CellStep`` against the one-card one
   over 4 steps, the paged prefill and decode steps (rows 22 and 21) as
   each data shard's program on its slots, the prefill ``CellStep`` with
   the flash forward (row 20): logits and pools within 1e-4, tokens equal
   outside the 1e-3 argmax band, each data shard's launches of rows 20-22
   read from ``LAUNCHES.scoped_counts()``; (d) the ``mesh:`` line: the card, the
   warm steps, the ledger by primitive, the peak against
   MESH_PEAK_PREDICTED; (e) the dry run's trace of (a)'s and (b)'s steps
   on ``meta`` meshes of the same shape (``launch.dryrun.mesh_trace``),
   each ledger equal to the card's step's, calls and bytes per primitive,
   and the ``mesh dryrun:`` line: (a)'s collective term at NVLink's 450
   GB/s (a data-sheet prediction), the trace seconds, the card.  With
   every position on one card these are the single-controller layout's
   costs, not NVLink's.

The second-to-last line of output is one JSON object ``{"kernels": [...]}``,
the last ``{"ok": true, "device": {...}}``.  ``--quick`` runs phases 1-2
(and 7a, 7b (a), 7c (a), 7d (a), 7e (a), 7f (a), 7g (a) of both models,
7h (a)) only (a first check of a new kernel), and prints no result line.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's data-sheet peaks, as the dry run's roofline prices them:
# FP32 pipes (no tensor cores), dense bf16 tensor cores, HBM3 bytes/s
from repro_torch.roofline.analysis import HBM_BW as HBM_RATE  # noqa: E402
from repro_torch.roofline.analysis import PEAK_FLOPS as BF16_PEAK  # noqa: E402
from repro_torch.roofline.analysis import PEAK_FLOPS_FP32 as FP32_PEAK  # noqa: E402

PEAK_SMS = 132  # H100 SXM, the SMs that FP32_PEAK is the sum of
REPLACES = {
    "sfc_matmul": "src/repro/kernels/matmul.py:32",
    "sfc_kmeans_assign": "src/repro/kernels/kmeans.py:271",
    "sfc_kmeans_update": "src/repro/kernels/kmeans.py:271",
    "sfc_join_hits": "src/repro/kernels/simjoin.py:112",
    "sfc_join_emit": "src/repro/kernels/simjoin.py:289",
    "sfc_tile_update": "src/repro/kernels/matmul.py:191",
    "sfc_fw_diag": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_fw_row": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_fw_col": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_fw_trailing": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_chol_diag": "src/repro/kernels/cholesky.py:108",
    "sfc_chol_panel": "src/repro/kernels/cholesky.py:108",
    "sfc_chol_trailing": "src/repro/kernels/cholesky.py:108",
    "sfc_kmeans_assign_tiles": "src/repro/kernels/kmeans.py:199",
    "sfc_matmul3d": "src/repro/kernels/matmul.py:94",
    "sfc_flash_attention": "src/repro/kernels/attention.py:138",
    "sfc_flash_decode": "src/repro/kernels/attention.py:338",
    "sfc_flash_prefill": "src/repro/kernels/attention.py:570",
    "sfc_kmeans_shard_assign": "src/repro/kernels/kmeans.py:556",
    "sfc_kmeans_shard_update": "src/repro/kernels/kmeans.py:556",
    "sfc_kmeans_fold": "src/repro/kernels/kmeans.py:556",
    "sfc_join_hits_rows": "src/repro/kernels/simjoin.py:187",
    "sfc_join_emit_halo": "src/repro/kernels/simjoin.py:301",
}
# the reference-path kernels the same entry points replace too
# (fused=False: the per-k oracles; the k-means reference's update)
ALSO_REPLACES = {
    "sfc_kmeans_update": "src/repro/kernels/kmeans.py:436",
    "sfc_fw_diag": "src/repro/kernels/floyd_warshall.py:95",
    "sfc_fw_row": "src/repro/kernels/floyd_warshall.py:99",
    "sfc_fw_col": "src/repro/kernels/floyd_warshall.py:104",
    "sfc_fw_trailing": "src/repro/kernels/floyd_warshall.py:109",
    "sfc_chol_diag": "src/repro/kernels/cholesky.py:98",
    "sfc_chol_panel": "src/repro/kernels/cholesky.py:102",
    # the exact fold over the gathered per-tile partials was a lax.scan
    "sfc_kmeans_fold": "src/repro/kernels/sharded.py:204",
}
SOURCES = {
    "sfc_matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_kmeans_assign": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_update": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_join_hits": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_join_emit": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_tile_update": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_fw_diag": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_fw_row": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_fw_col": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_fw_trailing": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_chol_diag": "src/repro_torch/kernels/csrc/cholesky.cu",
    "sfc_chol_panel": "src/repro_torch/kernels/csrc/cholesky.cu",
    "sfc_chol_trailing": "src/repro_torch/kernels/csrc/cholesky.cu",
    "sfc_kmeans_assign_tiles": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_matmul3d": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_flash_attention": "src/repro_torch/kernels/csrc/attention.cu",
    "sfc_flash_decode": "src/repro_torch/kernels/csrc/attention.cu",
    "sfc_flash_prefill": "src/repro_torch/kernels/csrc/attention.cu",
    "sfc_kmeans_shard_assign": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_shard_update": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_fold": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_join_hits_rows": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_join_emit_halo": "src/repro_torch/kernels/csrc/simjoin.cu",
}
BAND = 1e-4  # relative width of the float64 tie / threshold band
# the join kernels' metric (|xi|² − 2 xi·xj) + |xj|² in f32 is off by at
# most ~9·2⁻²⁴·(|xi|² + |xj|²) at D = 3; the stream's points in the unit
# cube are not centred, so its query band adds that scale to BAND·ε²
F32_METRIC = 1e-6
# the main path's sizes
MATMUL_F32 = 8192  # M = N = K
MATMUL_BF16 = (8000, 7000, 6000)  # M, N, K
KMEANS = (1_000_000, 128, 1024, 10)  # N, D, K, iterations
JOIN = (262_144, 16)  # N, D
FW = (8192, 5000)  # nodes: the main call (b = 128) and a padded one (b = 88)
FW_EDGE_P = 0.05  # edge probability of the random digraphs
CHOL = (8192, 6001)  # n: the main call (b = 128) and a padded one (to 6016)
KMEANS_GIST = (1_000_000, 960, 1024, 3)  # N, D, K, iterations: GIST1M's shapes
# StreamKMeans: points, points per insert request, an assign every n ticks,
# probes per assign (SIFT-width points, K of the Lloyd run)
STREAM_KMEANS = (262_144, 1024, 8, 4096)
STREAM_DECAYS = (1.0, 0.9)
# StreamSimJoin: points uniform in the unit cube, D, eps (a mean of ~32
# neighbours), points per insert request, a query every n ticks, probes per
# query, max_residents of the second run
STREAM_JOIN = (262_144, 3, 0.0308, 1024, 8, 1024, 65_536)
# the insert requests of each stream's runs: the first 128 x 1,024 of its
# points (StreamSimJoin's ~16 neighbours a point among them); StreamKMeans'
# batch check and phase 8's sharded joins take all 262,144
STREAM_INSERTS = 128
# the LM serving slice: TinyLlama-1.1B at full width, seeded random weights
SERVE_ARCH = "tinyllama-1.1b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE = 8, 2048, 16
SERVE_REQUESTS = 16
SERVE_PROMPT = (64, 1024)  # prompt lengths
SERVE_PREFIX = 256  # the shared system prefix of every other request
SERVE_NEW = (32, 128)  # new tokens per request
GATE_REQUESTS = 8  # requests of the f32 replay gate
# the f32 engine gates of phases 7d-7h: the dense-cache engine prefills a
# token a step (over every layer), so their prompts are short: 64-192
# tokens, every other one behind a shared 128-token prefix (8 pages)
GATE_PREFIX = 128
# the replay gate's band: a served token may differ from the dense
# forward's argmax only where that forward's top-2 logit margin is at most
# this (f32 logits of std ~0.25; the two paths differ by ~1e-5)
GATE_BAND = 1e-3
STEP_TOL = 1e-3  # f32 logits: flash vs xla decode step, kernel vs plain forward
ATTN_ROW20 = (2, 32, 2048)  # B, H, S of the full-sequence forward
# flash kernel vs plain version on the card: f32 sums in another order;
# bf16 outputs round apart by up to an ulp (2^-8 to 2^-7 relative; the
# largest difference read on the card was 1.95e-3, at outputs of up to
# 3.8), so about two ulps at the outputs' scale
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=8e-3, atol=4e-3)}
SERVING_KERNELS = ("sfc_flash_attention", "sfc_flash_decode", "sfc_flash_prefill")
PREFILL_CORES = ("sfc_flash_prefill.wgmma", "sfc_flash_prefill.tiled", "sfc_flash_prefill.simt")
# the MLA slice: DeepSeek-V2 at full width, its depth cut from 60 layers to
# MLA_LAYERS (~34 GB of bf16 weights; 8 would leave no room), seeded random
# weights, the engine and page shapes of the TinyLlama run
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 4
MLA_REQUESTS = 16
MLA_NEW = (16, 64)  # new tokens per request
MLA_QK_WIDTH = 192  # qk_nope_head_dim + qk_rope_head_dim: the scores' scale is 1/sqrt(192)
# the f32 gate: 1 layer (~20 GB), a few shorter requests (the dense engine
# prefills a token a step)
MLA_GATE_LAYERS = 1
MLA_GATE_REQUESTS = 4
MLA_GATE_PROMPT = (64, 320)
MLA_GATE_NEW = (16, 32)
# the latent core against its plain version: f32 outputs (q is f32), sums
# in other orders over up to 2048 kv rows of 576 columns
LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
# the SSM / hybrid slice: Mamba2-2.7B and Zamba2-2.7B at full width and
# depth, seeded random weights, on the dense engine (8 slots, max_len 2048,
# chunked prefill: one token a step for every slot, its other slots
# waiting).  A step is host-bound (a bf16 decode step 65-150 ms on the
# H100), so prompts are short: at 32-256 tokens the two runs' admissions
# alone took 71 and 92 s (PERF.md)
SSM_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
SSM_HYBRID = "zamba2-2.7b"
SSM_REQUESTS = 8  # one wave on the 8 slots (16, two waves, took 75 s of the phase's 114 s)
SSM_PROMPT = (16, 64)
SSM_NEW = (16, 64)
SSM_WARM_PROMPT = 16  # prompt tokens of the warm decode tick's requests
# the f32 gate: both models at full depth, served tokens against the replay.
# Its band: a decode step's f32 logits and the forward's at the same
# position differed by at most 1.3e-5 on the H100 (PERF.md §6), so a token
# can flip only where the top-2 margin is at most 2.6e-5; the band is ~4x
# that (GATE_BAND's 1e-3 held 6 of 78 Mamba2 tokens)
SSM_GATE_BAND = 1e-4
SSM_GATE_REQUESTS = 4
# prompts of at least 128 tokens: Zamba2's replays then run row 20 on 128-row
# tiles, the register-tiled core's shape (a shorter sequence is one tile of
# its own length, on flash_rows)
SSM_GATE_PROMPT = (128, 160)
SSM_GATE_NEW = (16, 32)
# the OLMoE slice: OLMoE-1B-7B at full size (16 layers, 64 experts, top-8,
# MHA: 16 query over 16 kv heads of 128), seeded random weights, the
# engine and page shapes of the TinyLlama run, DeepSeek's request mix
OLMOE_ARCH = "olmoe-1b-7b"
# the serving run's wall is the MoE host loop: one wave on the 8 slots and
# two requests more, one of them behind the shared prefix (a prefix is
# shared only across cohorts, so 8 requests in one would share no page)
OLMOE_REQUESTS = 10
OLMOE_NEW = (16, 64)
# its f32 gate at 8 of the 16 layers (at full depth, 27.68 GB, it took
# 49-51 s of the script: the dense engine prefills a token a step through
# every layer's expert loop): 4 requests in one cohort, the
# prompts of GATE_PREFIX
OLMOE_GATE_LAYERS = 8
OLMOE_GATE_REQUESTS = 4
OLMOE_GATE_PROMPT = (64, 192)
OLMOE_GATE_NEW = (16, 32)
# two f32 paths rank an 8th and a 9th expert apart (a flip) only where
# their routing probabilities tie within the paths' difference: where the
# two runs' top-8 agreed, their probabilities differed by at most 1.2e-6
# on the H100 (34,592 engine and 32,768 forward decisions; the smallest
# gaps were 3e-8 to 6e-8), so a flip needs a gap under ~2.4e-6.  The gates
# accept a token that differs outside GATE_BAND only behind a flip of the
# two runs' routing, and every flip must be a tie within this band, ~4x that
ROUTER_GATE_BAND = 1e-5
MHA_ROW20 = (2, 16, 2048)  # B, H, S of OLMoE's full-sequence forward (D = 128)
# the dense decoders' phases (7e, 7g, 7h): each model at full size, seeded
# random weights, the engine and page shapes of the TinyLlama run, OLMoE's
# request mix
DENSE_REQUESTS = 16
DENSE_NEW = (16, 64)
# their f32 gates (at full depth but Chameleon's): 8 requests in one
# cohort (prompts of 64-192 tokens behind GATE_PREFIX, 16-32 new)
DENSE_GATE_REQUESTS = 8
DENSE_GATE_PROMPT = (64, 192)
DENSE_GATE_NEW = (16, 32)
# the Qwen slice (7e): Qwen2.5-14B (48 layers, d 5,120, 40 query over 8 kv
# heads of 128: g = 5, QKV bias), its biases drawn N(0, 0.02)
QWEN_ARCH = "qwen2.5-14b"
QWEN_PARAMS = 14_770_033_664  # param_count_analytic: 29.54 GB in bf16, 59.08 GB in f32
QWEN_BIAS_STD = 0.02
# its f32 gate's engines cut to 384 positions a slot (an f32 pool
# of 193 pages of 16 x 393,216 B a token: 1.21 GB, where max_len 2048
# would take 6.45 GB), and the peak the phase predicts: the weights, four
# pools' worth (the engine's, its snapshot, the two decode-step copies)
# and 1 GB of activations
QWEN_GATE_MAX_LEN = 384
QWEN_GATE_PEAK_PREDICTED = 4 * QWEN_PARAMS + 4 * 193 * 16 * 393_216 + 2**30
# the Minitron and StableLM slice (7g): Minitron-8B (32 layers, d 4,096,
# 32 query over 8 kv heads of 128: g = 4, tanh-GeLU MLP of 16,384, an
# untied head of 256,000) and StableLM-1.6B (24 layers, d 2,048, MHA: 32
# heads of 64, SwiGLU of 5,632, an untied head of 100,352); their f32
# gates keep SERVE_MAX_LEN (1,025 pages of 16 a pool: 4.30 GB at
# Minitron's 262,144 B a token, 6.45 GB at StableLM's 393,216), the peak
# predicted as Qwen's
MINITRON_ARCH = "minitron-8b"
MINITRON_PARAMS = 7_734_562_816  # param_count_analytic: 15.47 GB in bf16, 30.94 GB in f32
MINITRON_GATE_PEAK_PREDICTED = 4 * MINITRON_PARAMS + 4 * 1025 * 16 * 262_144 + 2**30
STABLELM_ARCH = "stablelm-1.6b"
STABLELM_PARAMS = 1_644_267_520  # param_count_analytic: 3.29 GB in bf16, 6.58 GB in f32
STABLELM_GATE_PEAK_PREDICTED = 4 * STABLELM_PARAMS + 4 * 1025 * 16 * 393_216 + 2**30
# the Chameleon slice (7h): Chameleon-34B (48 layers, d 8,192, 64 query
# over 8 kv heads of 128: g = 8, SwiGLU of 22,016, an untied head of
# 65,536; token ids in: the VQ image tokenizer is a stub) at full size in
# bf16, 68.59 GB of its 79.2 GiB card.  The serving run's predicted peak:
# the weights, one pool (1,025 pages of 16 x 196,608 B a token), the f32
# copy of the head that unembed casts, and 2 GiB of a 1,024-wide
# cohort's activations (8 lanes: the MLP's three 8,192 x 22,016 products)
CHAMELEON_ARCH = "chameleon-34b"
CHAMELEON_PARAMS = 34_293_424_128  # param_count_analytic: 68.59 GB in bf16, 137.2 GB in f32
CHAMELEON_SERVE_PEAK_PREDICTED = 2 * CHAMELEON_PARAMS + 1025 * 16 * 196_608 + 4 * 65_536 * 8_192 + 2**31
# its f32 gate cut to 16 of the 48 layers (48.59 GB of f32 weights, under
# Qwen's 59.08 at full depth), both engines at SERVE_MAX_LEN (a pool of
# 1,025 pages of 16 x 131,072 B a token: 2.15 GB), the peak predicted as
# Qwen's
CHAMELEON_GATE_LAYERS = 16
CHAMELEON_GATE_PARAMS = 12_146_974_720  # 16 x 692,076,544 + the embedding, head and final norm
CHAMELEON_GATE_PEAK_PREDICTED = 4 * CHAMELEON_GATE_PARAMS + 4 * 1025 * 16 * 131_072 + 2**30
# the HuBERT slice: HuBERT-xlarge at full size (48 layers, d 1,280, 16
# heads of 80, not causal, encoder only, f32 frame embeddings in, 504
# cluster targets out), seeded random weights; a batch of 16 utterances of
# 30 s at 50 frames a second, padded by ops.attention to 1,536 rows
HUBERT_ARCH = "hubert-xlarge"
HUBERT_PARAMS = 944_487_680  # param_count_analytic: 1.89 GB in bf16, 3.78 GB in f32
HUBERT_BATCH = (16, 1500)  # utterances, frames
HUBERT_LABEL_MASK = 0.1  # share of the f32 gate's cluster labels set to -1
HUBERT_LOSS_TOL = 1e-4  # the f32 gate's losses, kernel against plain, relative
# phase 11's HuBERT train cell, cut from train_4k's global batch of 256: B, S
HUBERT_TRAIN = (4, 4096)
# the sharded phase: shards of its meshes, all on the one card
SHARDS = 4
SHARDED_KERNELS = ("sfc_kmeans_shard_assign", "sfc_kmeans_shard_update", "sfc_kmeans_fold",
                   "sfc_join_hits_rows", "sfc_join_emit_halo")
# the training phase: TinyLlama-1.1B; (a) 1 layer at full width, f32, one
# step of B x S on the card and on the CPU; (c) full size, bf16, micro-batch,
# sequence and micro-batches of a step, steps, lr and warm-up
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_CHECK = (1, 1, 2048)  # layers, B, S
TRAIN_CHECK_LR = 3e-4
# Adam's first step moves each parameter by g / (|g| + eps) · lr, about ±lr.
# Where the CPU's grad is away from 0 (|g| above TRAIN_GRAD_FLOOR of its
# leaf's largest) the two devices' parameters agree to TRAIN_PARAM_TOL · lr;
# a grad that is 0 up to its rounding (|g| near eps) may move its parameter
# by up to one step, 2 lr, apart (0.27 lr read on the H100)
TRAIN_GRAD_FLOOR = 1e-3
TRAIN_PARAM_TOL = 1e-3
TRAIN_FULL = (2, 2048, 2, 6, 3e-4, 2)
# the mesh phase: a ("data", "model") DeviceMesh of the one card, its
# devices repeated.  (a) TinyLlama-1.1B's Trainer step on MESH_SHAPE (B x S)
# against the one-card step, then reshards; the f32 gate at 2 layers.
# Tolerances (loss rel, grad norm rel, each leaf's ‖Δg‖ / ‖g‖): bf16 runs
# each data shard's products on half the rows, rounding its grads to bf16
# apart before the f32 sum; f32 differs only in the sums' order.
MESH_SHAPE = (2, 4)
MESH_RESHARDS = ((4, 2), (8, 1))
MESH_TRAIN = (4, 512)
MESH_GATE_LAYERS = 2
MESH_TOL = {"bfloat16": (2e-3, 1e-2, 2e-2), "float32": (1e-5, 1e-5, 1e-4)}
TRAIN_PARAMS = 1_100_048_384  # TinyLlama-1.1B, param_count_analytic
# the one-card and the mesh state (bf16 parameters, f32 moments: 10 bytes
# a parameter each), the one-card grads kept for the comparison (2), the
# gathered parameters (2), two data shards' bf16 grads (4), and 4 GiB of
# one step's activations over 4 x 512 tokens
MESH_PEAK_PREDICTED = 28 * TRAIN_PARAMS + 2 ** 32
# (b) OLMoE-1B-7B at full width, 2 of its 16 layers: 16 experts a rank
MESH_OLMOE_LAYERS = 2
MESH_OLMOE_BATCH = (4, 128)
# (c) the decode cell: slots, cache positions, steps; the paged steps'
# prompt width (each slot's prompt 32-128 tokens); the prefill cell's tokens
MESH_DECODE = (8, 512, 4)
MESH_PAGED_PROMPT = 128
MESH_PREFILL = 256
# the autotuner phase: the curves each app's candidates are drawn from (its
# default first).  A curve whose cover is the square of the grid's long side
# takes the host minutes on a ragged grid, so the k-means grid (7,813 x 8)
# gets none of peano, zorder or gray.
AUTOTUNE_CURVES = {
    "matmul": ("fur", "hilbert", "harmonious", "zorder"),
    "kmeans_lloyd": ("fur", "hilbert", "harmonious", "hcyclic"),
    "simjoin_counts": ("hilbert", "harmonious", "hcyclic", "row"),
    "simjoin_pairs": ("hilbert", "harmonious", "hcyclic", "row"),
    "floyd_warshall": ("hilbert", "harmonious", "zorder", "row"),
    "cholesky": ("hilbert", "harmonious", "hcyclic", "zorder"),
}
AUTOTUNE_MEASURE = 3  # candidates timed per app, the default among them
AUTOTUNE_REPEATS = 3
# the kernels each app launches (each must run under a swapped choice)
AUTOTUNE_KERNELS = {
    "matmul": ("sfc_matmul",),
    "kmeans_lloyd": ("sfc_kmeans_assign", "sfc_kmeans_update"),
    "simjoin_counts": ("sfc_join_hits",),
    "simjoin_pairs": ("sfc_join_hits", "sfc_join_emit"),
    "floyd_warshall": ("sfc_fw_diag", "sfc_fw_row", "sfc_fw_col", "sfc_fw_trailing"),
    "cholesky": ("sfc_chol_diag", "sfc_chol_panel", "sfc_chol_trailing"),
}
EXAMPLE_TWINS = ("quickstart", "datamining_apps", "stream_apps", "serve_lm")
TWIN_TIMEOUT = 120  # seconds, each


class Timeline:
    """The seconds between consecutive log lines: :meth:`slowest` names
    the lines that ended the longest waits, which is where a run's time
    went (the script must fit its time limit)."""

    def __init__(self):
        self.last, self.gaps = time.perf_counter(), []

    def mark(self, msg: str) -> None:
        now = time.perf_counter()
        self.gaps.append((now - self.last, msg[:100]))
        self.last = now

    def slowest(self, n: int) -> list:
        return [[round(s, 1), m] for s, m in sorted(self.gaps, reverse=True)[:n]]


TIMELINE = Timeline()


def log(msg: str) -> None:
    TIMELINE.mark(msg)
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILE_ATTEMPTS = 6  # windows kernel_stats profiles before it gives up


def kernel_stats(fn, reps: int, need: tuple = ()) -> dict:
    """(total device ms, launches recorded) of each kernel that ``fn()``
    launches over ``reps`` calls under torch.profiler, after one warm-up
    call, by its full name (empty, or without a kernel whose name holds a
    string of ``need``, only if PROFILE_ATTEMPTS windows recorded none or
    lacked it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # CUPTI now and then records no kernel of a whole window (none of row 21
    # latent's 10 calls, once; three windows of row 21 g = 4 in a row,
    # once), or none of one of a call's kernels (row 21 MHA's split kernel,
    # once): such a window is profiled again, and logged
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if attempt > 1:
            caller = sys._getframe(1)
            while caller.f_code.co_name == "kernel_ms":
                caller = caller.f_back
            log(f"profile window empty: {caller.f_code.co_name} profiles it again "
                f"(attempt {attempt} of {PROFILE_ATTEMPTS})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {e.key: (1e-3 * e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
        if out and all(any(n in k for k in out) for n in need):
            break
    return out


def kernel_ms(fn, reps: int) -> dict:
    """Device time per call of each kernel that ``fn()`` launches, by its
    full name: mean ms over ``reps`` calls under torch.profiler, after one
    warm-up call."""
    return {k: total / reps for k, (total, _) in kernel_stats(fn, reps).items()}


def bound_ms(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def smi_clocks() -> tuple[int, int]:
    """The card's SM clock and its maximum, MHz (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    sm, top = out.stdout.splitlines()[0].split(",")
    return int(sm), int(top)


class SmClock:
    """The SM clock read by nvidia-smi, one call after another on a
    thread, while the block runs: ``record`` = the reading before it, the
    readings during it (min, median, max: null where the block ended
    before the first reading; count) and the card's maximum.  A failed
    reading fails the block."""

    def __enter__(self):
        self.before, self.max_sm = smi_clocks()
        self.samples: list[int] = []
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        try:
            while not self._stop.is_set():
                self.samples.append(smi_clocks()[0])
        except BaseException as e:  # re-raised by __exit__
            self.error = e

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=120)
        check(not self._thread.is_alive(), "nvidia-smi: the SM clock reading did not return")
        if self.error is not None and exc[0] is None:
            raise RuntimeError(f"nvidia-smi: the SM clock reading failed: {self.error!r}") from self.error
        s = sorted(self.samples)
        self.record = {"before": self.before, "min": s[0] if s else None,
                       "median": statistics.median(s) if s else None,
                       "max": s[-1] if s else None, "n": len(s), "max_sm": self.max_sm}
        return False


# ---------------------------------------------------------------------------
# data and float64 bands
# ---------------------------------------------------------------------------

def join_data(rng, n: int, d: int, device):
    """Points uniform in the unit cube centred at 0 (the classic
    similarity-join workload; centring keeps |x|² near ε², so f32
    cancellation stays far inside the band) and an ε for a mean of ~32
    neighbours, from a 1024-point sample's nearest distances."""
    import torch

    x = rng.uniform(-0.5, 0.5, size=(n, d)).astype(np.float32)
    xt = torch.as_tensor(x, device=device)
    sample = xt[torch.as_tensor(rng.choice(n, size=min(n, 1024), replace=False), device=device)]
    d2 = torch.cdist(sample.double(), xt.double()) ** 2
    near = torch.topk(d2, k=min(n, 65), largest=False).values[:, 1:].reshape(-1)
    eps2 = torch.sort(near).values[min(len(near) - 1, 32 * len(sample))].item()
    return xt, float(np.sqrt(eps2))


def join_band(x, eps: float, metric: float = 0.0):
    """Encoded keys i*N + j (i > j) of the pairs whose float64 d² lies
    within BAND·ε² of ε² — where f32 rounding may decide either way; with
    ``metric`` (F32_METRIC, for points that are not centred) the width
    grows by metric·(|xi|² + |xj|²), the f32 metric's own error."""
    import torch

    n = x.shape[0]
    xd = x.double()
    nd = (xd * xd).sum(1)
    e2 = eps * eps
    keys = []
    step = max(1, (1 << 25) // n)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = nd[r0:r1, None] - 2.0 * xd[r0:r1] @ xd.T + nd[None, :]
        width = BAND * e2 + metric * (nd[r0:r1, None] + nd[None, :])
        i, j = ((d2 - e2).abs() <= width).nonzero(as_tuple=True)
        i = i + r0
        keep = i > j
        keys.append(i[keep] * n + j[keep])
    return torch.sort(torch.cat(keys)).values


def pair_keys(pairs, n: int):
    import torch

    k = pairs[:, 0].long() * n + pairs[:, 1].long()
    return torch.sort(k).values


def check_pairs(pairs, oracle, band, n: int, what: str) -> dict:
    """Pair SET equality outside the band; no duplicate, every i > j."""
    import torch

    check(bool((pairs[:, 0] > pairs[:, 1]).all()), f"{what}: a pair with i <= j")
    kp, ko = pair_keys(pairs, n), pair_keys(oracle, n)
    check(bool((kp[1:] != kp[:-1]).all()), f"{what}: duplicate pairs")
    only_p = kp[~torch.isin(kp, ko)]
    only_o = ko[~torch.isin(ko, kp)]
    off = torch.cat([only_p, only_o])
    check(bool(torch.isin(off, band).all()), f"{what}: {len(off)} pairs differ outside the band")
    return {"pairs": int(len(kp)), "differ_in_band": int(len(off))}


def check_counts(counts, oracle, band, n: int, what: str) -> None:
    import torch

    deg = torch.bincount(torch.cat([band // n, band % n]), minlength=n)
    diff = (counts.long() - oracle.long()).abs()
    check(bool((diff <= deg).all()), f"{what}: counts differ outside the band")


def check_tile_counts(tri, got, want, band, n: int, bp: int, what: str) -> int:
    """Pass-1 (row, column) counts per schedule row of the kernel against
    its plain version: each count may differ by at most the number of band
    pairs it covers (the rule of :func:`check_counts`, per tile).  Returns
    the largest difference."""
    import torch

    t = int(tri.max()) + 1
    row_of = torch.full((t * t,), -1, dtype=torch.long, device=tri.device)
    row_of[tri[:, 0].long() * t + tri[:, 1].long()] = torch.arange(tri.shape[0], device=tri.device)
    gi, gj = band // n, band % n
    row = row_of[(gi // bp) * t + gj // bp]
    check(bool((row >= 0).all()), f"{what}: a band pair outside the schedule")
    err = 0
    for side, g, l, w in zip(("row", "column"), got, want, (gi, gj)):
        diff = (g - l).abs().reshape(-1)
        bad = diff.nonzero().squeeze(1)  # flat (schedule row, in-tile index)
        covering = torch.sort(row * bp + w % bp).values
        deg = torch.searchsorted(covering, bad, right=True) - torch.searchsorted(covering, bad)
        check(bool((diff[bad] <= deg).all()), f"{what}: {side} counts differ outside the band")
        err = max(err, int(diff.max()) if diff.numel() else 0)
    return err


def addmm_min(x, c, cn):
    """The assign's strongest library yardstick: the metric |c|² − 2 x·c
    as one cuBLAS product (f32, TF32 off) and one min over its rows."""
    import torch

    return torch.addmm(cn, x, c.T, alpha=-2).min(1)


def argmin_band(x, c) -> "torch.Tensor":
    """Points whose two best float64 squared distances to ``c`` lie within
    BAND·(|x|² + best) of each other — the scale of the f32 cancellation
    in the kernels' metric |c|² − 2 x·c."""
    import torch

    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    cd = c.double()
    cn = (cd * cd).sum(1)
    step = max(1, (1 << 25) // c.shape[0])
    for r0 in range(0, x.shape[0], step):
        xd = x[r0:r0 + step].double()
        d2 = (xd * xd).sum(1)[:, None] - 2.0 * xd @ cd.T + cn[None, :]
        top = torch.topk(d2, k=min(2, c.shape[0]), largest=False).values
        gap = top[:, -1] - top[:, 0]
        out[r0:r0 + step] = gap <= BAND * ((xd * xd).sum(1) + top[:, 0].abs())
    return out


def emission(tri, row_hits, eps: float, npad: int, n_valid):
    """``(P, sfc_join_emit program)`` from pass-1 row counts, through the
    same host step as ``simjoin_pairs_scheduled``."""
    import torch
    from repro_torch.kernels.simjoin import emission_table, simjoin_emit_program

    table, P, cap, p_pad = emission_table(tri, row_hits)
    return P, simjoin_emit_program(
        table, eps=eps, bp=row_hits.shape[1], npad=npad, cap=cap, p_pad=p_pad, n_valid=n_valid,
    )


def join_walk(programs) -> dict:
    """A join pass's launch (rows 8–11) as its entry point reported it in
    ``program.launched``: the persistent CTAs of the program's last launch
    (a list of programs, one a shard: a grid each, 0 for a shard that
    launched nothing), and the launched kernel's registers, ring (dynamic
    shared memory), stage depth and stages."""
    from repro_torch.kernels.simjoin import simjoin_kernel_info

    progs = programs if isinstance(programs, list) else [programs]
    grids = [p_.launched.get("grid", 0) for p_ in progs]
    info = simjoin_kernel_info(next(p_.launched["kernel"] for p_ in progs if p_.launched))
    return {"persistent_ctas": grids if isinstance(programs, list) else grids[0],
            "smem_bytes": info["smem_bytes"], "registers": info["registers"],
            "stage_depth": info["stage_depth"], "stages": info["stages"]}


def fw_graph(rng, n: int, device, *, p: float = FW_EDGE_P, integer: bool = True):
    """Distance matrix of a random digraph: each edge present with
    probability ``p``, weights uniform on 1..100 (whole numbers with
    ``integer``, so every path sum is exact in f32 and the dense oracle
    must agree to the bit), +inf for a missing edge, 0 on the diagonal."""
    import torch

    present = rng.random((n, n), dtype=np.float32) < p
    if integer:
        w = rng.integers(1, 101, size=(n, n), dtype=np.int32).astype(np.float32)
    else:
        w = rng.uniform(1.0, 100.0, size=(n, n)).astype(np.float32)
    d = np.where(present, w, np.float32(np.inf))
    np.fill_diagonal(d, 0.0)
    return torch.as_tensor(d, device=device)


def gp_covariance(rng, n: int, device):
    """A = M·Mᵀ/n + I, M standard normal (n × n): the exact covariance of a
    Gaussian process with a linear kernel on n training points plus unit
    noise.  Formed in float64 on the card, returned in f32."""
    import torch

    m = torch.as_tensor(rng.standard_normal((n, n), dtype=np.float32), device=device).double()
    a = m @ m.T / n
    a.diagonal().add_(1.0)
    return a.float()


def max_diff(a, b) -> float:
    """Largest |a − b| where the two differ (0 where both are the same
    +inf, inf where only one is)."""
    import torch

    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


# kernel vs plain Cholesky on the card: the factor's entries are O(1) and
# both sides sum up to n f32 terms, in other orders
CHOL_RTOL, CHOL_ATOL = 1e-4, 1e-5
# sfc_chol_panel vs _solve_tiles on the same tiles, relative and as a
# share of the panel's max |X|: one rounded FMA a step against a matmul a
# step (a float64-product emulation of the kernel's order: within 7e-7)
PANEL_TOL = 1e-5


def compare_phased(rng, device) -> None:
    """Floyd–Warshall, Cholesky (fused and per-k programs, b = 8, 24, 40,
    88, 120, 128: the FW panels' strips end inside the tile at 88, 120 and
    128) and sfc_tile_update against their plain versions on the card; the
    two entry points at n = 1000 (padded) against the same call on the
    CPU."""
    import torch
    from repro_torch.core import triangle_schedule_device
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.cholesky import _chol_tile, cholesky_program, cholesky_reference_program
    from repro_torch.kernels.floyd_warshall import fw_program, fw_reference_program
    from repro_torch.kernels.matmul import tile_update_program

    for b in (8, 88, 128):
        prog = cholesky_program("hilbert", 1, b, device=device)
        for _ in range(3):
            a = gp_covariance(rng, b, device)
            got, want = launch(prog, a.clone()), _chol_tile(a.clone())
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"sfc_chol_diag b={b}: kernel != _chol_tile "
                                          f"(max diff {max_diff(got, want)})")
    log("compare sfc_chol_diag b=8, 88, 128 (3 tiles each): array_equal to the plain _chol_tile")

    for n, b in [(64, 8), (96, 24), (200, 40), (528, 88), (480, 120), (1024, 128)]:
        d = fw_graph(rng, n, device, integer=False)
        outs = []
        for build in (fw_program, fw_reference_program):
            prog = build("hilbert", n // b, b, device=device)
            got, want = launch(prog, d.clone()), prog.plain(prog, d.clone())
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{prog.name} n={n} b={b}: kernel != plain "
                                          f"(max diff {max_diff(got, want)})")
            outs.append(got)
        check(torch.equal(*outs), f"floyd_warshall n={n} b={b}: fused != per-k")
        reach = float(torch.isfinite(outs[0]).float().mean())
        a = gp_covariance(rng, n, device)
        outs, errs = [], []
        for build in (cholesky_program, cholesky_reference_program):
            prog = build("hilbert", n // b, b, device=device)
            got, want = launch(prog, a.clone()).tril(), prog.plain(prog, a.clone()).tril()
            torch.cuda.synchronize()
            errs.append(float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, rtol=CHOL_RTOL, atol=CHOL_ATOL)),
                  f"{prog.name} n={n} b={b}: kernel vs plain max err {errs[-1]}")
            outs.append(got)
        check(torch.equal(*outs), f"cholesky n={n} b={b}: fused != per-k")
        log(f"compare sfc_fw_* n={n} b={b}: fused and per-k array_equal to plain and to each other "
            f"(reachable pairs {reach:.3f}); "
            f"sfc_chol_* + sfc_tile_update: max_abs_err fused {errs[0]:.3e}, per-k {errs[1]:.3e} "
            f"(rtol {CHOL_RTOL}, atol {CHOL_ATOL}), fused == per-k")

    d = fw_graph(rng, 1000, device, integer=False)
    got, want = ops.floyd_warshall(d), ops.floyd_warshall(d.cpu())
    check(torch.equal(got.cpu(), want), "ops.floyd_warshall n=1000: card != CPU")
    a = gp_covariance(rng, 1000, device)
    got, want = ops.cholesky(a), ops.cholesky(a.cpu())
    cerr = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, rtol=CHOL_RTOL, atol=CHOL_ATOL)),
          f"ops.cholesky n=1000: card vs CPU max err {cerr}")
    log(f"compare ops.floyd_warshall n=1000 (b=112, padded to 1008): card == CPU plain; "
        f"ops.cholesky n=1000: max_abs_err {cerr:.3e}")

    for M, Kp, bm, curve in [(384, 88, 128, "hilbert"), (768, 128, 256, "row")]:
        o = torch.as_tensor(rng.standard_normal((M, M), dtype=np.float32), device=device)
        a = torch.as_tensor(rng.standard_normal((M, Kp), dtype=np.float32), device=device)
        b = torch.as_tensor(rng.standard_normal((M, Kp), dtype=np.float32), device=device)
        sched = triangle_schedule_device(curve, M // bm, strict=False, device=device)
        prog = tile_update_program(sched, o, a, b, bm=bm, bn=bm, alpha=-1.0)
        got, want = launch(prog, o.clone(), a, b), prog.plain(prog, o.clone(), a, b)
        torch.cuda.synchronize()
        err, tol = float((got - want).abs().max()), 1e-4 * Kp ** 0.5
        check(err <= tol, f"sfc_tile_update M={M} Kp={Kp} bm={bm}: max err {err} > {tol}")
        upper = torch.ones(M // bm, M // bm, dtype=torch.bool, device=device).triu(1)
        upper = upper.repeat_interleave(bm, 0).repeat_interleave(bm, 1)
        check(torch.equal(got[upper], o[upper]), f"sfc_tile_update M={M}: a tile off the schedule changed")
        log(f"compare sfc_tile_update M=N={M} Kp={Kp} bm={bm} {curve} triangle: max_abs_err={err:.3e} "
            f"(tol {tol:.1e}), tiles off the schedule unchanged")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def compare_kernels(rng, device) -> None:
    import torch
    from repro_torch.core import kmeans_schedule_device, tile_schedule_device, triangle_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_lloyd_program
    from repro_torch.kernels.matmul import matmul_program
    from repro_torch.kernels.simjoin import simjoin_hits_program, simjoin_pairs_scheduled

    # bf16 runs the wgmma core: 128² tiles, a 256² tile's sub-tile loop,
    # and bf16 -> f32 (tolerance as sfc_matmul3d's f32 output)
    for (M, N, K, bm, dtype, out) in [(200, 136, 40, 64, torch.float32, None),
                                      (300, 260, 48, 256, torch.float32, None),
                                      (1024, 1536, 1024, 128, torch.float32, None),
                                      (1000, 700, 608, 128, torch.bfloat16, None),
                                      (300, 260, 48, 256, torch.bfloat16, None),
                                      (1000, 700, 608, 128, torch.bfloat16, torch.float32)]:
        a = torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32), device=device)
        b = torch.as_tensor(rng.standard_normal((K, N), dtype=np.float32), device=device)
        a, b = a.to(dtype), b.to(dtype)
        Mp, Np, Kp = -(-M // bm) * bm, -(-N // bm) * bm, -(-K // 16) * 16
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M)).contiguous()
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K)).contiguous()
        sched = tile_schedule_device("fur", (Mp // bm, Np // bm), device=device)
        prog = matmul_program(sched, a, b, bm=bm, bn=bm, bk=16, out_dtype=out)
        got, want = launch(prog, a, b), prog.plain(prog, a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.bfloat16 and out is None:
            tol = 1e-2 * max(1.0, float(want.float().abs().max()))
        else:
            tol = 1e-4 * K ** 0.5
        check(err <= tol, f"sfc_matmul {M}x{N}x{K} {dtype} -> {got.dtype}: max err {err} > {tol}")
        log(f"compare sfc_matmul {M}x{N}x{K} {str(dtype)[6:]} -> {str(got.dtype)[6:]} bm={bm}: "
            f"max_abs_err={err:.3e} (tol {tol:.1e})")

    for (N, D, K, bp, bc) in [(300, 5, 7, 64, 4), (600, 8, 20, 256, 8), (20000, 128, 1000, 128, 128)]:
        x = torch.as_tensor(rng.standard_normal((N, D), dtype=np.float32), device=device)
        c = x[torch.as_tensor(rng.choice(N, K, replace=False), device=device)].clone()
        Np_, Kp = -(-N // bp) * bp, -(-K // bc) * bc
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        cp = torch.nn.functional.pad(c, (0, 0, 0, Kp - K)).contiguous()
        sched = kmeans_schedule_device("fur", Np_ // bp, Kp // bc, device=device)
        assign, update = kmeans_lloyd_program(
            sched, pt=Np_ // bp, ct=Kp // bc, bp=bp, bc=bc, D=D,
            k_valid=K if Kp != K else None, n_valid=N if Np_ != N else None,
        )
        cn = (cp * cp).sum(1)
        (m_k, a_k), (m_p, a_p) = launch(assign, xp, cp, cn), assign.plain(assign, xp, cp, cn)
        torch.cuda.synchronize()
        band = argmin_band(xp[:N], c)
        off = (a_k[:N] != a_p[:N]) & ~band
        check(not bool(off.any()), f"sfc_kmeans_assign N={N}: {int(off.sum())} argmins differ outside the band")
        check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_assign N={N}: minima differ")
        (s_k, n_k), (s_p, n_p) = launch(update, xp, a_k), update.plain(update, xp, a_k)
        torch.cuda.synchronize()
        check(torch.equal(n_k, n_p), f"sfc_kmeans_update N={N}: counts differ")
        serr = float((s_k - s_p).abs().max())
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_update N={N}: sums err {serr}")
        log(f"compare sfc_kmeans_assign/update N={N} D={D} K={K}: argmin band points={int(band.sum())}, "
            f"argmin mismatches={int((a_k[:N] != a_p[:N]).sum())}, sums max_abs_err={serr:.3e}")

    for (N, D, bp) in [(1000, 16, 96), (16384, 16, 128)]:
        x, eps = join_data(rng, N, D, device)
        Np_ = -(-N // bp) * bp
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        nv = N if Np_ != N else None
        tri = triangle_schedule_device("hilbert", Np_ // bp, strict=False, device=device)
        hits = simjoin_hits_program(tri, eps=eps, bp=bp, npad=Np_, n_valid=nv)
        (r_k, c_k), (r_p, c_p) = launch(hits, xp), hits.plain(hits, xp)
        torch.cuda.synchronize()
        band = join_band(x, eps)
        mism = int((r_k - r_p).abs().sum() + (c_k - c_p).abs().sum())
        check_tile_counts(tri, (r_k, c_k), (r_p, c_p), band, N, bp, f"sfc_join_hits N={N}")
        pairs_k = simjoin_pairs_scheduled(tri, xp, eps=eps, bp=bp, n_valid=nv)

        P, emit_k = emission(tri, r_k, eps, Np_, nv)
        P_p, emit_p = emission(tri, r_p, eps, Np_, nv)
        e_k, e_p = launch(emit_k, xp), emit_p.plain(emit_p, xp)
        torch.cuda.synchronize()
        check(not bool((e_k[:P] < 0).any()), f"sfc_join_emit N={N}: pass 2 wrote fewer pairs than pass 1 counted")
        check(not bool((e_k[P:] >= 0).any()), f"sfc_join_emit N={N}: a write past the pass-1 total")
        check(torch.equal(e_k[:P], pairs_k), f"sfc_join_emit N={N}: emit != simjoin_pairs_scheduled")
        same = P == P_p and torch.equal(e_k[:P], e_p[:P])
        stats = check_pairs(e_k[:P], e_p[:P_p], band, N, f"sfc_join_emit N={N}")
        log(f"compare sfc_join_hits/emit N={N} D={D} bp={bp} eps={eps:.4f}: pairs={P}, band pairs={len(band)}, "
            f"hit-count mismatches={mism}, emit array_equal={same}, differ_in_band={stats['differ_in_band']}")


def compare_reference(rng, device) -> None:
    """The k-means reference path's kernels and the 3-D matmul against
    their plain versions on the card: sfc_kmeans_assign_tiles (whose
    merged result must also equal sfc_kmeans_assign's to the bit: the two
    run the same device code), sfc_kmeans_update over its own table up to
    D = 960 (the column-chunked grid), sfc_matmul3d in f32 and bf16; then
    ops.kmeans_lloyd with fused=False equal to the fused call."""
    import torch
    from repro_torch.core import kmeans_schedule_device, tile_schedule_device
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.kmeans import (
        kmeans_assign_program, kmeans_assign_swizzled, kmeans_lloyd_program, kmeans_update_program,
    )
    from repro_torch.kernels.matmul import matmul3d_csr_device, matmul3d_program

    for (N, D, K, bp, bc) in [(300, 5, 7, 64, 4), (20000, 128, 1000, 128, 128)]:
        x = torch.as_tensor(rng.standard_normal((N, D), dtype=np.float32), device=device)
        c = x[torch.as_tensor(rng.choice(N, K, replace=False), device=device)].clone()
        Np_, Kp = -(-N // bp) * bp, -(-K // bc) * bc
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        cp = torch.nn.functional.pad(c, (0, 0, 0, Kp - K)).contiguous()
        pt, ct = Np_ // bp, Kp // bc
        kv = K if Kp != K else None
        prog = kmeans_assign_program(tile_schedule_device("fur", (pt, ct), device=device),
                                     pt=pt, ct=ct, bp=bp, bc=bc, k_valid=kv)
        cn = (cp * cp).sum(1)
        (m_k, a_k), (m_p, a_p) = launch(prog, xp, cp, cn), prog.plain(prog, xp, cp, cn)
        torch.cuda.synchronize()
        terr = float((m_k - m_p).abs().max())
        check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)),
              f"sfc_kmeans_assign_tiles N={N}: tile minima differ (max err {terr})")
        fused, _update = kmeans_lloyd_program(
            kmeans_schedule_device("fur", pt, ct, device=device), pt=pt, ct=ct, bp=bp, bc=bc, D=D,
            k_valid=kv, n_valid=N if Np_ != N else None,
        )
        m_f, a_f = launch(fused, xp, cp, cn)
        m_r, a_r = kmeans_assign_swizzled(prog.schedule, xp, cp, bp=bp, bc=bc, k_valid=kv)
        check(torch.equal(m_r, m_f) and torch.equal(a_r, a_f),
              f"sfc_kmeans_assign_tiles N={N}: merged result != sfc_kmeans_assign")
        band = argmin_band(xp[:N], c)
        best = torch.argmin(m_p, dim=1, keepdim=True)
        a_pm = torch.gather(a_p, 1, best).reshape(-1)
        off = (a_r[:N] != a_pm[:N]) & ~band
        check(not bool(off.any()), f"sfc_kmeans_assign_tiles N={N}: {int(off.sum())} argmins differ "
                                   f"from the plain version outside the band")
        log(f"compare sfc_kmeans_assign_tiles N={N} D={D} K={K} bp={bp} bc={bc}: tile minima "
            f"max_abs_err={terr:.3e}; merged == sfc_kmeans_assign to the bit; argmin band points="
            f"{int(band.sum())}, mismatches vs plain={int((a_r[:N] != a_pm[:N]).sum())}")

    for (N, D, K) in [(20000, 960, 1000), (3000, 453, 300), (3000, 454, 300)]:
        bp = 128
        Np_ = -(-N // bp) * bp
        x = torch.as_tensor(rng.standard_normal((Np_, D), dtype=np.float32), device=device)
        a = torch.as_tensor(rng.integers(0, K, size=Np_).astype(np.int32), device=device)
        host = np.stack([rng.permutation(Np_ // bp), np.ones(Np_ // bp)], 1).astype(np.int32)
        prog = kmeans_update_program(torch.as_tensor(host, device=device), col_i=0, bp=bp, Kp=K, D=D,
                                     n_valid=N, columns=("i", "first_visit"))
        (s_k, n_k), (s_p, n_p) = launch(prog, x, a), prog.plain(prog, x, a)
        torch.cuda.synchronize()
        check(torch.equal(n_k, n_p), f"sfc_kmeans_update D={D}: counts differ")
        serr = float((s_k - s_p).abs().max())
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_update D={D}: sums err {serr}")
        log(f"compare sfc_kmeans_update N={N} D={D} K={K}: grid {prog.grid} (column chunk "
            f"{prog.params['dchunk']}, {prog.params['smem_bytes']} B shared memory per CTA), "
            f"counts equal, sums max_abs_err={serr:.3e}")

    compare_update_bits(rng, device)

    # bf16 inputs run the tensor-core kernel: bf16 outputs within one bf16
    # ulp of the largest output, f32 outputs (exact bf16 products summed in
    # f32 in another order) within 1e-4 sqrt(K) of the plain version
    f32, bf16 = torch.float32, torch.bfloat16
    for (M, N, K, bm, bk, curve, dtype, out) in [(200, 136, 40, 64, 16, "hilbert", f32, f32),
                                                 (1024, 1536, 1024, 128, 128, "hilbert", f32, f32),
                                                 (1024, 1536, 1024, 128, 128, "row", f32, f32),
                                                 (1000, 700, 608, 128, 128, "zorder", bf16, bf16),
                                                 (1000, 700, 608, 128, 128, "hilbert", bf16, f32),
                                                 (100, 90, 40, 100, 40, "row", bf16, bf16)]:
        a = torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32), device=device).to(dtype)
        b = torch.as_tensor(rng.standard_normal((K, N), dtype=np.float32), device=device).to(dtype)
        bn = min(bm, N)
        Mp, Np_, Kp = -(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M)).contiguous()
        b = torch.nn.functional.pad(b, (0, Np_ - N, 0, Kp - K)).contiguous()
        ij, ks = matmul3d_csr_device(curve, (Mp // bm, Np_ // bn, Kp // bk), device=device)
        prog = matmul3d_program(ij, ks, a, b, bm=bm, bn=bn, bk=bk, out_dtype=out)
        got, want = launch(prog, a, b), prog.plain(prog, a, b)
        torch.cuda.synchronize()
        check(got.dtype == out and got.shape == want.shape, f"sfc_matmul3d {M}x{N}x{K}: {got.dtype} {got.shape}")
        err = float((got.float() - want.float()).abs().max())
        tol = 1e-2 * max(1.0, float(want.float().abs().max())) if out == bf16 else 1e-4 * K ** 0.5
        check(err <= tol, f"sfc_matmul3d {M}x{N}x{K} {dtype}->{out}: max err {err} > {tol}")
        log(f"compare sfc_matmul3d {M}x{N}x{K} {str(dtype)[6:]}->{str(out)[6:]} bm={bm} bn={bn} bk={bk} "
            f"{curve}: max_abs_err={err:.3e} (tol {tol:.1e})")

    for (N, D, K) in [(5000, 16, 50), (3000, 960, 40)]:
        x = torch.as_tensor(rng.standard_normal((N, D), dtype=np.float32), device=device)
        c_f, a_f = ops.kmeans_lloyd(x, K, iters=3)
        c_r, a_r = ops.kmeans_lloyd(x, K, iters=3, fused=False)
        check(torch.equal(c_f, c_r) and torch.equal(a_f, a_r),
              f"ops.kmeans_lloyd N={N} D={D}: fused != fused=False")
        log(f"compare ops.kmeans_lloyd N={N} D={D} K={K}: fused == fused=False to the bit")


def compare_update_bits(rng, device) -> None:
    """The update's group partials through both entries equal to the bit
    to group_partials on the CPU (index_add_ there adds in source order,
    one f32 add at a time: the chain each element of a partial is), at
    D = 128 and 960 over 600 tiles of 128 points (960 CTAs each: 2.4 and
    7.3 waves at 3 and 1 CTAs an SM), K = 1024, n_valid 45 short of the
    last tile, the tiles in a permuted order, tile 3 with 90 % of its
    points on one centroid, and every point of group 1 (5 and 15 tiles)
    on centroid 11, so warp 3 of its first centroid range queues 640 and
    1,920 rows: 2.5 and 7.5 laps of its 256-entry queue.
    sfc_kmeans_update over its own table, sfc_kmeans_shard_update over the
    same groups as a 600-tile shard."""
    import torch
    from repro_torch.core import kmeans_schedule_device
    from repro_torch.kernels.kmeans import (
        group_partials, kmeans_shard_program, kmeans_update_program, shard_update_cuda,
        update_partials_cuda,
    )

    pt, bp, K = 600, 128, 1024
    nv = pt * bp - 45
    for D in (128, 960):
        x = rng.standard_normal((pt * bp, D), dtype=np.float32)
        a = rng.integers(0, K, size=pt * bp).astype(np.int32)
        a[3 * bp:3 * bp + 116] = 11
        xc, ac = torch.as_tensor(x), torch.as_tensor(a)
        table = np.stack([rng.permutation(pt), np.ones(pt)], 1).astype(np.int32)
        prog = kmeans_update_program(torch.as_tensor(table, device=device), col_i=0, bp=bp, Kp=K, D=D,
                                     n_valid=nv, columns=("i", "first_visit"))
        G, tpg = prog.grid[0], prog.params["tiles_per_group"]
        ac[tpg * bp:2 * tpg * bp] = 11  # group 1: tiles tpg .. 2 tpg - 1
        xd, ad = xc.to(device), ac.to(device)
        groups = prog.schedule.reshape(-1)
        want = group_partials(xc, ac, groups.cpu().view(G, tpg), bp=bp, Kp=K, n_valid=nv)
        check(int(want[1][:, 11].max()) == tpg * bp, f"update bits D={D}: group 1 is not all on centroid 11")
        got = update_partials_cuda(prog, xd, ad)
        check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
              f"sfc_kmeans_update D={D}: group partials != group_partials on the CPU")
        sprog = kmeans_shard_program(kmeans_schedule_device("fur", pt, K // 128, device=device), pt=pt,
                                     ct=K // 128, bp=bp, bc=128, D=D, groups=groups, tiles_per_group=tpg)
        lim = torch.tensor([nv, K], dtype=torch.int32, device=device)
        got = shard_update_cuda(sprog, xd, ad.view(pt, bp), lim)
        check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
              f"sfc_kmeans_shard_update D={D}: group partials != group_partials on the CPU")
        log(f"compare sfc_kmeans_update / sfc_kmeans_shard_update N={nv} D={D} K={K}: grid {prog.grid} "
            f"({tpg} tiles a group; group 1's {tpg * bp} rows in one warp's queue), group partials "
            f"torch.equal to group_partials on the CPU through both")
        del xd, got


def shard_case(rng, N: int, D: int, K: int, bp: int, bc: int, S: int, device) -> dict:
    """Row 7's operands for S shards: clustered points (centres 10·N(0, 1),
    unit noise) laid out as the sharded k-means lays them out, the
    centres (zero-padded to Kp) as centroids, and each shard's limits."""
    import torch
    from repro_torch.core import kmeans_schedule_device
    from repro_torch.kernels.kmeans import kmeans_shard_program

    centres = 10.0 * rng.standard_normal((K, D), dtype=np.float32)
    x = centres[rng.integers(0, K, size=N)] + rng.standard_normal((N, D), dtype=np.float32)
    pt = -(-N // bp)
    ptl = -(-pt // S)
    Nl = ptl * bp
    Kp = -(-K // bc) * bc
    xp = torch.as_tensor(np.pad(x, ((0, Nl * S - N), (0, 0))), device=device)
    cp = torch.as_tensor(np.pad(centres, ((0, Kp - K), (0, 0))), device=device)
    lims = [torch.tensor([min(max(N - s * Nl, 0), Nl), K], dtype=torch.int32, device=device)
            for s in range(S)]
    prog = kmeans_shard_program(kmeans_schedule_device("fur", ptl, Kp // bc, device=device), pt=ptl,
                                ct=Kp // bc, bp=bp, bc=bc, D=D)
    return {"x": x, "xs": list(xp.split(Nl)), "cp": cp, "cn": (cp * cp).sum(1), "lims": lims,
            "prog": prog, "pt": pt, "Kp": Kp, "centres": centres}


def compare_sharded(rng, device) -> None:
    """Rows 7, 9, 11 against their plain versions on the card.  Row 7 on
    every shard of a small ragged case (8 shards over 5 tiles: three of
    pure padding, n_valid_local = 0; K = 7 of Kp = 8) and a mid-size one
    (4 shards, K = 1000 of 1024), its update held against the plain
    update on the kernel's own assignments, and the fold of the gathered
    partials against the plain fold (to the bit).  Rows 9 and 11 over a
    4-column halo table whose slots are not the global tile ids (a
    permuted buffer with an extra copy of one tile): the rows kernel equal
    to sfc_join_hits' row counts on the global layout, the halo emission
    equal to simjoin_pairs_scheduled's pairs (the same device code on the
    same bits), and each against its plain version outside the band."""
    import torch
    from repro_torch.core import kmeans_schedule, triangle_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import (
        kmeans_fold_program, shard_assign_cuda, shard_assign_plain, shard_update_cuda,
        shard_update_plain,
    )
    from repro_torch.kernels.simjoin import (
        emission_table, simjoin_emit_halo_program, simjoin_hits_program, simjoin_hits_rows_program,
        simjoin_pairs_scheduled,
    )

    for (N, D, K, bp, bc, S) in [(300, 5, 7, 64, 4, 8), (20000, 128, 1000, 128, 128, 4)]:
        case = shard_case(rng, N, D, K, bp, bc, S, device)
        prog, cp, cn = case["prog"], case["cp"], case["cn"]
        parts, mism, serr, band_pts, empty = [], 0, 0.0, 0, 0
        for s, (xs, lim) in enumerate(zip(case["xs"], case["lims"])):
            (m_k, a_k), (m_p, a_p) = shard_assign_cuda(prog, xs, cp, cn, lim), shard_assign_plain(prog, xs, cp, cn, lim)
            (s_k, n_k), (s_p, n_p) = shard_update_cuda(prog, xs, a_k, lim), shard_update_plain(prog, xs, a_k, lim)
            torch.cuda.synchronize()
            nv = int(lim[0])
            band = argmin_band(xs[:nv], cp[:K])
            off = (a_k.reshape(-1)[:nv] != a_p.reshape(-1)[:nv]) & ~band
            check(not bool(off.any()), f"sfc_kmeans_shard_assign N={N} shard {s}: argmins differ outside the band")
            check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_shard_assign N={N}: minima differ")
            check(nv == 0 or int(a_k.reshape(-1)[:nv].max()) < K, "a pad centroid was chosen")
            check(torch.equal(n_k, n_p), f"sfc_kmeans_shard_update N={N} shard {s}: counts differ")
            check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_shard_update N={N}: sums differ")
            if nv == 0:
                check(not bool(s_k.any()) and not bool(n_k.any()), "a shard of pure padding wrote non-zero partials")
                empty += 1
            mism += int((a_k.reshape(-1)[:nv] != a_p.reshape(-1)[:nv]).sum())
            serr = max(serr, float((s_k - s_p).abs().max()))
            band_pts += int(band.sum())
            parts.append(s_k)
        gathered = torch.cat(parts)
        host = kmeans_schedule("fur", case["pt"], case["Kp"] // bc)
        order = torch.as_tensor(np.ascontiguousarray(host[host[:, 0] == 1][:, 1:2]), device=device)
        fold = kmeans_fold_program(order)
        check(torch.equal(launch(fold, gathered), fold.plain(fold, gathered)), f"sfc_kmeans_fold N={N}: != plain")
        log(f"compare sfc_kmeans_shard_assign/update + sfc_kmeans_fold N={N} D={D} K={K} (Kp {case['Kp']}) "
            f"S={S} ({empty} shards of pure padding, zeros): argmin band points={band_pts}, mismatches={mism}, "
            f"partial sums max_abs_err={serr:.3e}, counts equal; fold of {len(order)} tiles == plain to the bit")

    for (N, D, bp) in [(1000, 16, 96), (16384, 16, 128)]:
        x, eps = join_data(rng, N, D, device)
        Np_ = -(-N // bp) * bp
        t = Np_ // bp
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        nv = N if Np_ != N else None
        tri = triangle_schedule_device("hilbert", t, strict=False, device=device)
        rows2 = launch(simjoin_hits_rows_program(tri, eps=eps, bp=bp, npad=Np_, n_valid=nv), xp)
        rows_full, _ = launch(simjoin_hits_program(tri, eps=eps, bp=bp, npad=Np_, n_valid=nv), xp)
        check(torch.equal(rows2, rows_full), f"sfc_join_hits_rows N={N}: 2-column rows != sfc_join_hits rows")
        # slot s holds global tile perm[s]; slot t an extra copy of tile perm[0]
        perm = rng.permutation(t)
        slot = np.empty(t, np.int64)
        slot[perm] = np.arange(t)
        buf = xp.view(t, bp, D)[torch.as_tensor(np.append(perm, perm[0]), device=device)].reshape(-1, D)
        th = tri.cpu().numpy().astype(np.int64)
        js = np.where(th[:, 1] == perm[0], t, slot[th[:, 1]])
        table4 = torch.as_tensor(np.column_stack([slot[th[:, 0]], js, th]).astype(np.int32), device=device)
        hp = simjoin_hits_rows_program(table4, eps=eps, bp=bp, npad=Np_, n_valid=nv, halo=True)
        r_k, r_p = launch(hp, buf), hp.plain(hp, buf)
        torch.cuda.synchronize()
        check(torch.equal(r_k, rows2), f"sfc_join_hits_rows N={N}: halo rows != global rows")
        band = join_band(x, eps)
        herr = check_tile_counts(tri, (r_k,), (r_p,), band, N, bp, f"sfc_join_hits_rows N={N}")
        emitted = []
        for rows in (r_k, r_p):
            table6, P, cap, p_pad = emission_table(table4, rows)
            emitted.append((P, simjoin_emit_halo_program(table6, eps=eps, bp=bp, npad=Np_, cap=cap,
                                                         p_pad=p_pad, n_valid=nv)))
        (P, e_prog), (P_p, p_prog) = emitted
        e_k, e_p = launch(e_prog, buf), p_prog.plain(p_prog, buf)
        torch.cuda.synchronize()
        check(not bool((e_k[P:] >= 0).any()), f"sfc_join_emit_halo N={N}: a write past the pass-1 total")
        check(torch.equal(e_k[:P], simjoin_pairs_scheduled(tri, xp, eps=eps, bp=bp, n_valid=nv)),
              f"sfc_join_emit_halo N={N}: != the single-core pairs")
        stats = check_pairs(e_k[:P], e_p[:P_p], band, N, f"sfc_join_emit_halo N={N}")
        log(f"compare sfc_join_hits_rows/emit_halo N={N} D={D} bp={bp} eps={eps:.4f}: 4-column table, "
            f"{int((table4[:, :2] != table4[:, 2:]).any(1).sum())} of {len(th)} rows load by slots != ids; "
            f"rows == sfc_join_hits rows on the global layout; pairs={P} == simjoin_pairs_scheduled; "
            f"vs plain: max row-count diff {herr}, differ_in_band={stats['differ_in_band']}")


# ---------------------------------------------------------------------------
# phases 3-5: the main path, its checks, and the kernel timings
# ---------------------------------------------------------------------------

def lloyd_oracle(x, c0, iters: int):
    """Plain Lloyd from ``c0`` on the dense oracle (f32 assign, index_add
    sums) — what the kernels' k-means is held against."""
    import torch
    from repro_torch.kernels import ref

    c = c0.clone()
    for _ in range(iters):
        _d2, a = ref.kmeans_assign(x, c)
        sums = torch.zeros_like(c).index_add_(0, a.long(), x)
        cnt = torch.bincount(a.long(), minlength=c.shape[0]).float()[:, None]
        c = torch.where(cnt > 0, sums / cnt.clamp(min=1.0), c)
    return c, a


def drive_stream_kmeans(xs, probe_pool, k: int, decay: float, seed: int, device):
    """StreamKMeans over ``xs`` (host f32): one insert request per tick and
    an assign request every few ticks.  Returns the service, the assign
    tickets with the centroids they saw (the state before their tick),
    and the stream's metrics (the clock stops while those centroids are
    copied out for the check)."""
    import torch
    from repro_torch.serve import StreamKMeans

    _n, per, every, m = STREAM_KMEANS
    n = len(xs)
    svc = StreamKMeans(k, decay=decay, seed=seed, device=device)
    asks, n_req, busy = [], 0, 0.0
    for t, i in enumerate(range(0, n, per)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.insert(xs[i:i + per])
        n_req += 1
        if t % every == every - 1:
            busy += time.perf_counter() - t0
            seen = svc.centroids()
            probes = probe_pool[(len(asks) * m) % len(probe_pool):][:m]
            t0 = time.perf_counter()
            asks.append((svc.assign(probes), seen, probes))
            n_req += 1
        svc.tick()
        busy += time.perf_counter() - t0
    return svc, asks, {
        "requests": n_req, "ticks": svc.stats.total_ticks, "wall_s": busy, "req_per_s": n_req / busy,
        "p99_tick_ms": 1e3 * svc.stats.p99(), "mean_tick_ms": 1e3 * svc.stats.mean(),
        "lloyd_dispatches": svc.stats.total("lloyd_dispatch"),
        "assign_dispatches": svc.stats.total("assign_dispatch"),
    }


def drive_stream_join(pts, qpool, max_residents, device):
    """StreamSimJoin over ``pts`` (host f32) with fixed bounds: one insert
    request per tick and a query request every few ticks.  Returns the
    service, the query tickets with their probes and the id range of the
    residents they probed, and the stream's metrics."""
    import torch
    from repro_torch.serve import StreamSimJoin

    _n, d, eps, per, every, m, _ = STREAM_JOIN
    n = len(pts)
    svc = StreamSimJoin(eps, bounds=(np.zeros(d), np.ones(d)), max_residents=max_residents,
                        device=device)
    queries, n_req = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, i in enumerate(range(0, n, per)):
        svc.insert(pts[i:i + per])
        n_req += 1
        if t % every == every - 1:
            probes = qpool[(len(queries) * m) % len(qpool):][:m]
            lo = max(0, i + per - max_residents) if max_residents else 0
            queries.append((svc.query(probes), probes, lo, i + per))
            n_req += 1
        svc.tick()
    wall = time.perf_counter() - t0
    return svc, queries, {
        "requests": n_req, "ticks": svc.stats.total_ticks, "wall_s": wall, "req_per_s": n_req / wall,
        "p99_tick_ms": 1e3 * svc.stats.p99(), "mean_tick_ms": 1e3 * svc.stats.mean(),
        "pairs": int(svc.stats.total("pairs_emitted")),
        "tiles_scheduled": int(svc.stats.total("tiles_scheduled")),
        "tiles_pruned": int(svc.stats.total("tiles_pruned")),
        "halo_intervals": int(svc.stats.total("halo_intervals")),
        "mean_probe_rows": svc.stats.total("probe_rows") / svc.stats.total_ticks,
        "residents": svc.resident_count,
    }


def check_kmeans_asks(asks, k: int, device, what: str) -> dict:
    """Each assign result against the f32 oracle on the centroids it saw,
    exact outside the float64 tie band."""
    import torch
    from repro_torch.kernels import ref

    band_pts = mism = 0
    for ticket, seen, probes in asks:
        check(ticket.done and seen is not None and ticket.result is not None, f"{what}: assign not served")
        pt, ct = torch.as_tensor(probes, device=device), torch.as_tensor(seen, device=device)
        _d, want = ref.kmeans_assign(pt, ct)
        got = torch.as_tensor(ticket.result, device=device)
        band = argmin_band(pt, ct)
        check(not bool(((got != want) & ~band).any()), f"{what}: assignments differ outside the band")
        band_pts += int(band.sum())
        mism += int((got != want).sum())
    return {"assigns": len(asks), "band_points": band_pts, "mismatches": mism}


def check_join_queries(queries, pts_t, eps: float) -> dict:
    """Each query's (probe, resident id) rows against float64 brute force
    over the residents it probed, exact outside the threshold band
    |d² − ε²| ≤ BAND·ε² + F32_METRIC·(|probe|² + |resident|²)."""
    import torch

    n = pts_t.shape[0]
    band_rows = rows = 0
    e2 = eps * eps
    for ticket, probes, lo, hi in queries:
        res = torch.as_tensor(ticket.result, device=pts_t.device)
        got = torch.sort(res[:, 0] * n + res[:, 1]).values
        want, band = [], []
        pd = torch.as_tensor(probes, device=pts_t.device).double()
        rd = pts_t[lo:hi].double()
        rn = (rd * rd).sum(1)
        for r0 in range(0, len(pd), 128):
            q = pd[r0:r0 + 128]
            d2 = torch.cdist(q, rd) ** 2
            i, j = (d2 <= e2).nonzero(as_tuple=True)
            want.append((i + r0) * n + j + lo)
            width = BAND * e2 + F32_METRIC * ((q * q).sum(1)[:, None] + rn[None, :])
            i, j = ((d2 - e2).abs() <= width).nonzero(as_tuple=True)
            band.append((i + r0) * n + j + lo)
        want, band = torch.sort(torch.cat(want)).values, torch.cat(band)
        off = torch.cat([got[~torch.isin(got, want)], want[~torch.isin(want, got)]])
        check(bool(torch.isin(off, band).all()), f"query: {len(off)} rows differ outside the band")
        rows += len(got)
        band_rows += len(band)
    return {"queries": len(queries), "rows": rows, "band_rows": band_rows}


def main_path(rng, device, seed: int) -> dict:
    import torch
    from repro_torch.core import kmeans_schedule_device, tile_schedule_device, triangle_schedule_device
    from repro_torch.kernels import LAUNCHES, launch, ops, ref
    from repro_torch.kernels.kmeans import kmeans_init_indices, kmeans_lloyd_program
    from repro_torch.kernels.matmul import matmul_program
    from repro_torch.kernels.simjoin import simjoin_hits_program

    # --- data, made from the seed with numpy ---------------------------------
    t0 = time.perf_counter()
    S = MATMUL_F32
    M16, N16, K16 = MATMUL_BF16
    a32 = torch.as_tensor(rng.standard_normal((S, S), dtype=np.float32), device=device)
    b32 = torch.as_tensor(rng.standard_normal((S, S), dtype=np.float32), device=device)
    a16 = torch.as_tensor(rng.standard_normal((M16, K16), dtype=np.float32), device=device).bfloat16()
    b16 = torch.as_tensor(rng.standard_normal((K16, N16), dtype=np.float32), device=device).bfloat16()
    NK, DK, K, ITERS = KMEANS
    centres = 10.0 * rng.standard_normal((K, DK), dtype=np.float32)
    labels = rng.integers(0, K, size=NK)
    # one init seed per cluster: kmeans_init's draw depends on (N, K, seed) only
    labels[kmeans_init_indices(NK, K, seed).numpy()] = np.arange(K)
    xk = torch.as_tensor(centres[labels] + rng.standard_normal((NK, DK), dtype=np.float32), device=device)
    NJ, DJ = JOIN
    xj, eps = join_data(rng, NJ, DJ, device)
    NF, NFR = FW
    NC, NCR = CHOL
    fw_d, fw_dr = fw_graph(rng, NF, device), fw_graph(rng, NFR, device)
    ch_a, ch_ar = gp_covariance(rng, NC, device), gp_covariance(rng, NCR, device)
    saved = [t.clone() for t in (fw_d, fw_dr, ch_a, ch_ar)]
    probes = torch.as_tensor(centres[rng.integers(0, K, size=4096)]
                             + rng.standard_normal((4096, DK), dtype=np.float32), device=device)
    # GIST1M's shapes, made on the card from the seed (3.8 GB)
    NG, DG, KG, ITERS_G = KMEANS_GIST
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    labels_g = torch.randint(0, KG, (NG,), generator=gen, device=device)
    labels_g[kmeans_init_indices(NG, KG, seed).to(device)] = torch.arange(KG, device=device)
    xg = torch.randn((KG, DG), generator=gen, device=device).mul_(10.0)[labels_g]
    xg.add_(torch.randn((NG, DG), generator=gen, device=device))
    NS, PER, _every, MP = STREAM_KMEANS
    xs_k = xk[:NS].cpu().numpy()
    NSK = STREAM_INSERTS * PER  # the stream's points: the first NSK of xs_k
    probe_pool = xk[NS:NS + 32 * MP].cpu().numpy()
    NSJ, DSJ, EPS_S, PER_J, _qe, MQ, MAXR = STREAM_JOIN
    xs_j = rng.uniform(0.0, 1.0, size=(NSJ, DSJ)).astype(np.float32)
    NSS = STREAM_INSERTS * PER_J  # the stream's points: the first NSS of xs_j
    q_pool = rng.uniform(0.0, 1.0, size=(32 * MQ, DSJ)).astype(np.float32)
    torch.cuda.synchronize()
    log(f"data: {time.perf_counter() - t0:.1f} s (matmul {S}^3 f32 + {M16}x{N16}x{K16} bf16, "
        f"k-means {NK}x{DK} K={K}, e-join {NJ}x{DJ} eps={eps:.5f}, floyd_warshall {NF} and {NFR} "
        f"nodes p={FW_EDGE_P}, cholesky {NC} and {NCR}, k-means GIST {NG}x{DG} K={KG}, "
        f"streams: k-means {NSK} of {NS}x{DK}, e-join {NSS} of {NSJ}x{DSJ} eps={EPS_S})")

    # --- phase 3: the main path through the public entry points ------------
    wall = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t)
        return out

    LAUNCHES.reset()
    c32 = run(f"ops.matmul f32 {S}^3", lambda: ops.matmul(a32, b32))
    c16 = run(f"ops.matmul bf16 {M16}x{N16}x{K16}", lambda: ops.matmul(a16, b16))
    cent, asg = run(f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS}",
                    lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed))
    counts = run(f"ops.simjoin_counts {NJ}x{DJ}", lambda: ops.simjoin_counts(xj, eps))
    pairs = run(f"ops.simjoin_pairs {NJ}x{DJ}", lambda: ops.simjoin_pairs(xj, eps))
    pairs_h = run("ops.simjoin_pairs hilbert_order", lambda: ops.simjoin_pairs(xj, eps, hilbert_order=True))
    fw = run(f"ops.floyd_warshall {NF}", lambda: ops.floyd_warshall(fw_d))
    fw_r = run(f"ops.floyd_warshall {NFR}", lambda: ops.floyd_warshall(fw_dr))
    ch = run(f"ops.cholesky {NC}", lambda: ops.cholesky(ch_a))
    ch_r = run(f"ops.cholesky {NCR}", lambda: ops.cholesky(ch_ar))
    fw_k = run(f"ops.floyd_warshall {NF} fused=False", lambda: ops.floyd_warshall(fw_d, fused=False))
    ch_k = run(f"ops.cholesky {NC} fused=False", lambda: ops.cholesky(ch_a, fused=False))
    d2_all, asg_all = run(f"ops.kmeans_assign {NK}x{DK} K={K}", lambda: ops.kmeans_assign(xk, cent))
    d2_pr, asg_pr = run(f"ops.kmeans_assign 4096x{DK} K={K}", lambda: ops.kmeans_assign(probes, cent))
    cent_r, asg_r = run(f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS} fused=False",
                        lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed, fused=False))
    cent_g, asg_g = run(f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G}",
                        lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed))
    cent_gr, asg_gr = run(f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G} fused=False",
                          lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed, fused=False))
    c3 = run(f"ops.matmul f32 {S}^3 schedule_ndim=3", lambda: ops.matmul(a32, b32, schedule_ndim=3))
    c3_16 = run(f"ops.matmul bf16 {M16}x{N16}x{K16} schedule_ndim=3",
                lambda: ops.matmul(a16, b16, schedule_ndim=3))
    streams = {}
    for decay in STREAM_DECAYS:
        streams[f"StreamKMeans decay={decay}"] = run(
            f"StreamKMeans decay={decay}",
            lambda: drive_stream_kmeans(xs_k[:NSK], probe_pool, K, decay, seed, device))
    for maxr in (None, MAXR):
        streams[f"StreamSimJoin max_residents={maxr}"] = run(
            f"StreamSimJoin max_residents={maxr}", lambda: drive_stream_join(xs_j[:NSS], q_pool, maxr, device))
    launches = {k: n for k, n in LAUNCHES.counts().items()
                if k not in SERVING_KERNELS + SHARDED_KERNELS}
    cores = {k: n for k, n in LAUNCHES.cores().items() if k.split(".")[0] not in SERVING_KERNELS}
    log("main path wall ms: " + json.dumps({k: round(v, 3) for k, v in wall.items()}))
    log("main path launches: " + json.dumps(launches))
    log("main path cores: " + json.dumps(cores))
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    # the f32 matmuls on the SIMT core, the bf16 ones on the tensor cores
    for name, n in cores.items():
        check(n > 0, f"{name} was not launched on the main path")

    # --- phase 4: results against the oracles -------------------------------
    err32 = float((c32 - ref.matmul(a32, b32)).abs().max())
    check(c32.shape == (S, S) and bool(torch.isfinite(c32).all()), "matmul f32: shape or non-finite")
    check(err32 <= 1e-2, f"matmul f32 {S}^3: max err {err32} > 1e-2")
    r16 = ref.matmul(a16, b16)
    err16 = float((c16.float() - r16.float()).abs().max())
    tol16 = 1e-2 * float(r16.float().abs().max())
    check(c16.shape == (M16, N16) and c16.dtype == torch.bfloat16, "matmul bf16: shape or dtype")
    check(err16 <= tol16, f"matmul bf16: max err {err16} > {tol16}")
    del r16
    log(f"check matmul: f32 max_abs_err={err32:.3e} (tol 1e-2, |C| ~ {float(c32.abs().max()):.0f}); "
        f"bf16 max_abs_err={err16:.3e} (tol {tol16:.3e}, one bf16 ulp of max|C|)")

    c0 = xk[kmeans_init_indices(NK, K, seed).to(device)]
    c_ref, a_ref = lloyd_oracle(xk, c0, ITERS)
    band_k = argmin_band(xk, c_ref)
    off = (asg != a_ref) & ~band_k
    check(not bool(off.any()), f"k-means: {int(off.sum())} assignments differ outside the band")
    cerr = float((cent - c_ref).abs().max())
    check(bool(torch.allclose(cent, c_ref, rtol=1e-4, atol=1e-3)), f"k-means centroids: max err {cerr}")
    check(torch.equal(asg.cpu(), torch.as_tensor(labels, dtype=torch.int32)), "k-means: clusters not recovered")
    log(f"check kmeans: assignments equal outside band (band points={int(band_k.sum())}, "
        f"mismatches={int((asg != a_ref).sum())}), centroids max_abs_err={cerr:.3e} (rtol 1e-4, atol 1e-3)")
    del c_ref, a_ref

    band_j = join_band(xj, eps)
    check_counts(counts, ref.simjoin_counts(xj, eps), band_j, NJ, "simjoin_counts")
    mean_nb = float(counts.float().mean())
    check(8 <= mean_nb <= 64, f"e-join mean neighbour count {mean_nb} outside [8, 64]")
    oracle = ref.simjoin_pairs(xj, eps)
    st = check_pairs(pairs, oracle, band_j, NJ, "simjoin_pairs")
    sth = check_pairs(pairs_h, oracle, band_j, NJ, "simjoin_pairs hilbert_order")
    check(2 * len(pairs) == int(counts.sum()), "simjoin: pairs and counts disagree")
    log(f"check simjoin: mean neighbours={mean_nb:.2f}, pairs={st['pairs']}, band pairs={len(band_j)}, "
        f"differ in band: plain order {st['differ_in_band']}, hilbert_order {sth['differ_in_band']}")
    del oracle

    for name, d, out in ((f"floyd_warshall {NF}", fw_d, fw), (f"floyd_warshall {NFR}", fw_dr, fw_r)):
        check(out.shape == d.shape and out.dtype == torch.float32, f"{name}: shape or dtype")
        check(torch.equal(out, ref.floyd_warshall(d)), f"{name}: differs from the dense k-loop")
        log(f"check {name}: equal to the dense k-loop oracle; reachable pairs "
            f"{float(torch.isfinite(out).float().mean()):.6f}, longest shortest path {float(out[torch.isfinite(out)].max()):.0f}")
    check(torch.equal(fw, fw_k), f"floyd_warshall {NF}: fused != fused=False")
    for name, a, L in ((f"cholesky {NC}", ch_a, ch), (f"cholesky {NCR}", ch_ar, ch_r)):
        check(L.shape == a.shape and bool(torch.isfinite(L).all()), f"{name}: shape or non-finite")
        stats = cholesky_errors(a, L)
        lib = cholesky_errors(a, ref.cholesky(a))
        check(stats["factor_rel"] <= 1e-4, f"{name}: max|L - L64| / max|L64| = {stats['factor_rel']} > 1e-4")
        check(stats["residual_rel"] <= 1e-4, f"{name}: |LL^T - A|_F / |A|_F = {stats['residual_rel']} > 1e-4")
        log(f"check {name}: " + json.dumps({"port": stats, "torch.linalg.cholesky f32": lib, "limits": 1e-4}))
    check(torch.equal(ch, ch_k), f"cholesky {NC}: fused != fused=False")
    for t, before in zip((fw_d, fw_dr, ch_a, ch_ar), saved):
        check(torch.equal(t, before), "an input of floyd_warshall / cholesky changed")
    log("check phased: fused == fused=False (floyd_warshall, cholesky), inputs unchanged")
    del fw_r, fw_k, ch_r, ch_k, saved

    # the k-means reference path, ops.kmeans_assign and GIST1M's width
    check(torch.equal(cent, cent_r) and torch.equal(asg, asg_r),
          f"kmeans_lloyd {NK}x{DK}: fused != fused=False")
    check(torch.equal(cent_g, cent_gr) and torch.equal(asg_g, asg_gr),
          f"kmeans_lloyd {NG}x{DG}: fused != fused=False")
    assign_stats = {}
    for name, xq, d2q, aq in ((f"{NK} points", xk, d2_all, asg_all), ("4096 probes", probes, d2_pr, asg_pr)):
        d_ref, a_ref = ref.kmeans_assign(xq, cent)
        band_q = argmin_band(xq, cent)
        check(aq.shape == (len(xq),) and bool(torch.isfinite(d2q).all()), f"kmeans_assign {name}: shape")
        check(not bool(((aq != a_ref) & ~band_q).any()), f"kmeans_assign {name}: differs outside the band")
        # the f32 metric |c|² − 2 x·c + |x|² cancels at the scale of |x|²
        d2err = float((d2q - d_ref).abs().max() / (xq * xq).sum(1).max())
        check(d2err <= 1e-5, f"kmeans_assign {name}: d2 err {d2err} of max |x|²")
        assign_stats[name] = {"band_points": int(band_q.sum()), "mismatches": int((aq != a_ref).sum()),
                              "d2_rel_err": d2err}
    check(torch.equal(asg_all.cpu(), torch.as_tensor(labels, dtype=torch.int32)),
          "kmeans_assign on the final centroids: clusters not recovered")
    c0g = xg[kmeans_init_indices(NG, KG, seed).to(device)]
    cg_ref, ag_ref = lloyd_oracle(xg, c0g, ITERS_G)
    band_g = argmin_band(xg, cg_ref)
    check(not bool(((asg_g != ag_ref) & ~band_g).any()), f"k-means {NG}x{DG}: differs outside the band")
    gerr = float((cent_g - cg_ref).abs().max())
    check(bool(torch.allclose(cent_g, cg_ref, rtol=1e-4, atol=1e-3)), f"k-means {NG}x{DG}: centroids err {gerr}")
    check(torch.equal(asg_g, labels_g.int()), f"k-means {NG}x{DG}: clusters not recovered")
    gist = {"band_points": int(band_g.sum()), "mismatches": int((asg_g != ag_ref).sum()),
            "centroids_max_abs_err": gerr}
    del cg_ref, ag_ref, c0g, band_g
    log("check kmeans reference path: fused == fused=False to the bit at "
        f"{NK}x{DK} and {NG}x{DG}; " + json.dumps({"kmeans_assign": assign_stats, f"{NG}x{DG}": gist}))

    # the 3-D matmul, with the 2-D path's tolerances
    r32 = ref.matmul(a32, b32)
    err3 = float((c3 - r32).abs().max())
    check(c3.shape == (S, S) and bool(torch.isfinite(c3).all()), "matmul 3d f32: shape or non-finite")
    check(err3 <= 1e-2, f"matmul 3d f32 {S}^3: max err {err3} > 1e-2")
    del r32
    r16 = ref.matmul(a16, b16)
    err3_16 = float((c3_16.float() - r16.float()).abs().max())
    tol3_16 = 1e-2 * float(r16.float().abs().max())
    check(c3_16.shape == (M16, N16) and c3_16.dtype == torch.bfloat16, "matmul 3d bf16: shape or dtype")
    check(err3_16 <= tol3_16, f"matmul 3d bf16: max err {err3_16} > {tol3_16}")
    del r16
    log(f"check matmul schedule_ndim=3: f32 max_abs_err={err3:.3e} (tol 1e-2); bf16 max_abs_err={err3_16:.3e} "
        f"(tol {tol3_16:.3e})")

    # the streams: StreamKMeans to the bit against ops, StreamSimJoin's
    # pairs and queries exact outside the band
    stream_checks = {}
    for decay in STREAM_DECAYS:
        svc, asks, _m = streams[f"StreamKMeans decay={decay}"]
        c_fin = torch.as_tensor(svc.centroids(), device=device)
        check(c_fin.shape == (K, DK) and bool(torch.isfinite(c_fin).all()), f"StreamKMeans decay={decay}: centroids")
        stream_checks[f"StreamKMeans decay={decay}"] = check_kmeans_asks(asks, K, device, f"StreamKMeans {decay}")
    from repro_torch.serve import StreamKMeans

    chk = StreamKMeans(K, seed=seed, device=device)
    for i in range(0, NS, PER):
        chk.insert(xs_k[i:i + PER])
    for _ in range(ITERS):
        chk.tick()
    c_b, a_b = ops.kmeans_lloyd(torch.as_tensor(chk.points(), device=device), K, iters=ITERS, seed=seed)
    check(torch.equal(torch.as_tensor(chk.centroids(), device=device), c_b)
          and torch.equal(torch.as_tensor(chk.assignment(), device=device), a_b),
          "StreamKMeans: all points in one tick, then ticks != ops.kmeans_lloyd")
    stream_checks["StreamKMeans batch_identical"] = True
    del chk, c_b, a_b
    xs_jt = torch.as_tensor(xs_j, device=device)
    oracle_j = ops.simjoin_pairs(xs_jt[:NSS], EPS_S)
    band_s = join_band(xs_jt[:NSS], EPS_S)
    for maxr in (None, MAXR):
        svc, queries, _m = streams[f"StreamSimJoin max_residents={maxr}"]
        check(np.array_equal(svc.points_by_id(), xs_j[:NSS]), "StreamSimJoin: points_by_id != the inserted points")
        got = torch.as_tensor(svc.pairs(), device=device)
        want = oracle_j.long()
        if maxr is not None:
            # a pair (a, b), b < a, is emitted iff b was still resident when
            # a's insert request was admitted
            lo = torch.clamp(want[:, 0] // PER_J * PER_J - maxr, min=0)
            want = want[want[:, 1] >= lo]
        st = check_pairs(got, want, band_s, NSS, f"StreamSimJoin max_residents={maxr}")
        stream_checks[f"StreamSimJoin max_residents={maxr}"] = {
            **st, **check_join_queries(queries, xs_jt[:NSS], EPS_S),
        }
    log("check streams: " + json.dumps({"band pairs": len(band_s), **stream_checks}))
    del oracle_j, band_s
    log("streams: " + json.dumps({name: v[2] for name, v in streams.items()}))

    # --- phase 5: kernel timings at the main path's shapes ------------------
    rows = []

    def entry(name, kern, plain, library, ops_, peak, nbytes, reps, err, extra=None, clock=False):
        if clock:  # the SM clock while the kernel and the library call run
            with SmClock() as k_clock:
                ms = cuda_ms(kern, reps)
            with SmClock() as l_clock:
                l_ms = cuda_ms(library, reps)
            extra = {**(extra or {}), "sm_clock_mhz": {"kernel": k_clock.record,
                                                       "library": l_clock.record}}
            log(f"sm clock {name}: kernel {json.dumps(k_clock.record)}, library "
                f"{json.dumps(l_clock.record)}")
        else:
            ms = cuda_ms(kern, reps)
            l_ms = cuda_ms(library, reps) if library is not None else None
        p_ms = cuda_ms(plain, 1, warmup=0)
        b_ms, b_by = bound_ms(ops_, peak, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
            **(extra or {}),
        })
        log(f"time {name}: {json.dumps(rows[-1])}")

    # the kernel against its plain version at the main path's shapes, with
    # the tolerances of compare_kernels
    del c32
    sched = tile_schedule_device("fur", (S // 128, S // 128), device=device)
    prog = matmul_program(sched, a32, b32, bm=128, bn=128, bk=16)
    got, want = launch(prog, a32, b32), prog.plain(prog, a32, b32)
    merr, mtol = float((got - want).abs().max()), 1e-4 * S ** 0.5
    check(merr <= mtol, f"sfc_matmul {S}^3 f32 vs plain: max err {merr} > {mtol}")
    del got, want
    # the bf16 case, ops.matmul's padded program, on the wgmma core
    a16p = torch.nn.functional.pad(a16, (0, (-K16) % 16, 0, (-M16) % 128)).contiguous()
    b16p = torch.nn.functional.pad(b16, (0, (-N16) % 128, 0, (-K16) % 16)).contiguous()
    s16 = tile_schedule_device("fur", (a16p.shape[0] // 128, b16p.shape[1] // 128), device=device)
    p16 = matmul_program(s16, a16p, b16p, bm=128, bn=128, bk=16)
    got, want = launch(p16, a16p, b16p), p16.plain(p16, a16p, b16p)
    merr16 = float((got.float() - want.float()).abs().max())
    mtol16 = 1e-2 * max(1.0, float(want.float().abs().max()))
    check(merr16 <= mtol16, f"sfc_matmul {list(got.shape)} bf16 vs plain: max err {merr16} > {mtol16}")
    del got, want
    b16_ms, b16_by = bound_ms(2.0 * M16 * N16 * K16, BF16_PEAK, 2 * (M16 * K16 + K16 * N16 + M16 * N16))
    bf16_row = {"shape": [M16, N16, K16], "padded": [a16p.shape[0], b16p.shape[1], a16p.shape[1]],
                "core": "wgmma", "ms": cuda_ms(lambda: launch(p16, a16p, b16p), 5),
                "plain_ms": cuda_ms(lambda: p16.plain(p16, a16p, b16p), 1, warmup=0),
                "library_ms": cuda_ms(lambda: torch.matmul(a16, b16), 5), "bound_ms": b16_ms,
                "bound_by": b16_by, "max_abs_err": merr16, "tol": mtol16, "oracle_max_abs_err": err16}
    entry("sfc_matmul", lambda: launch(prog, a32, b32), lambda: prog.plain(prog, a32, b32),
          lambda: torch.matmul(a32, b32), 2.0 * S ** 3, FP32_PEAK, 3 * S * S * 4, 5, merr,
          {"core": "simt", "bf16": bf16_row}, clock=True)

    pt = -(-NK // 128)
    xkp = torch.nn.functional.pad(xk, (0, 0, 0, pt * 128 - NK)).contiguous()
    ksched = kmeans_schedule_device("fur", pt, K // 128, device=device)
    assign, update = kmeans_lloyd_program(ksched, pt=pt, ct=K // 128, bp=128, bc=128, D=DK,
                                          k_valid=None, n_valid=NK)
    cn = (cent * cent).sum(1)
    m_k, a_k = launch(assign, xkp, cent, cn)
    m_p, a_p = assign.plain(assign, xkp, cent, cn)
    band_a = argmin_band(xk, cent)
    check(not bool(((a_k[:NK] != a_p[:NK]) & ~band_a).any()), "sfc_kmeans_assign vs plain at full size")
    aerr = float((m_k - m_p).abs().max())
    entry("sfc_kmeans_assign", lambda: launch(assign, xkp, cent, cn), lambda: assign.plain(assign, xkp, cent, cn),
          lambda: torch.cdist(xkp, cent).argmin(dim=1), 2.0 * pt * 128 * K * DK, FP32_PEAK,
          4 * (pt * 128 * DK + K * DK + K + 2 * pt * 128), 5, aerr,
          {"addmm_min_ms": cuda_ms(lambda: addmm_min(xkp, cent, cn), 5)}, clock=True)
    rows[-1]["d960"] = time_assign_d960(xg, cent_g, device)
    log(f"time sfc_kmeans_assign D={DG}: {json.dumps(rows[-1]['d960'])}")
    (s_k, n_k), (s_p, n_p) = launch(update, xkp, a_k), update.plain(update, xkp, a_k)
    check(torch.equal(n_k, n_p), "sfc_kmeans_update counts vs plain at full size")
    uerr = float((s_k - s_p).abs().max())
    x_aug = torch.cat([xkp[:NK], torch.ones(NK, 1, device=device)], dim=1)
    acc = torch.zeros(K, DK + 1, device=device)
    entry("sfc_kmeans_update", lambda: launch(update, xkp, a_k), lambda: update.plain(update, xkp, a_k),
          lambda: acc.zero_().index_add_(0, a_k[:NK].long(), x_aug), float(NK * DK), FP32_PEAK,
          4 * (pt * 128 * DK + pt * 128 + K * DK + K), 10, uerr,
          {"d960": time_update_d960(xg, asg_g, KG, device)})
    del x_aug, acc
    time_assign_tiles(entry, xk, probes, cent, device)
    time_matmul3d(entry, a32, b32, a16, b16, device)

    trid = triangle_schedule_device("hilbert", NJ // 128, strict=False, device=device)
    hits = simjoin_hits_program(trid, eps=eps, bp=128, npad=NJ, n_valid=None)
    r_k, c_k = launch(hits, xj)
    r_p, c_p = hits.plain(hits, xj)
    herr = float(check_tile_counts(trid, (r_k, c_k), (r_p, c_p), band_j, NJ, 128, "sfc_join_hits"))
    del c_k, c_p
    pair_ops = NJ * (NJ - 1) / 2 * (2 * DJ + 3)
    entry("sfc_join_hits", lambda: launch(hits, xj), lambda: hits.plain(hits, xj), None,
          pair_ops, FP32_PEAK, 4 * (NJ * DJ + 2 * len(trid) * 128), 5, herr,
          join_walk(hits))
    P, emit = emission(trid, r_k, eps, NJ, None)
    P_p, emit_p = emission(trid, r_p, eps, NJ, None)
    e_k = launch(emit, xj)
    e_p = emit_p.plain(emit_p, xj)
    # a band pair shifts every later row of the buffer, so the emitted
    # outputs are compared as pair sets: equal outside the band (else
    # check_pairs fails), so the error is 0; the pairs in their symmetric
    # difference (each one inside the band) are counted apart
    differ = check_pairs(e_k[:P], e_p[:P_p], band_j, NJ, "sfc_join_emit")["differ_in_band"]
    # the emission table holds only the tiles with pairs: only they do the
    # (2D + 3) operations per pair of their tile
    busy = emit.schedule[:, 3] > 0
    on_diag = emit.schedule[:, 0] == emit.schedule[:, 1]
    n_off, n_diag = int((busy & ~on_diag).sum()), int((busy & on_diag).sum())
    emit_ops = (n_off * 128 * 128 + n_diag * 128 * 127 / 2) * (2 * DJ + 3)
    log(f"sfc_join_emit: {n_off + n_diag} of {len(trid)} tiles hold a pair ({n_diag} on the diagonal)")
    entry("sfc_join_emit", lambda: launch(emit, xj), lambda: emit_p.plain(emit_p, xj), None,
          emit_ops, FP32_PEAK, 4 * (NJ * DJ + 4 * len(trid) + 2 * P), 5, 0.0,
          {"differ_in_band": differ, **join_walk(emit)})

    del r_k, r_p, e_k, e_p
    time_phased(entry, device, fw_d, fw_dr, ch_a, ch_ar, ch)

    # --- phase 6: where the time goes in a warm second pass ------------------
    # (the warm ticks: one more insert request and one probe request each)
    svc_k, svc_j = streams["StreamKMeans decay=1.0"][0], streams["StreamSimJoin max_residents=None"][0]
    more_k = xk[NS + 32 * MP:][:PER].cpu().numpy()
    more_j = rng.uniform(0.0, 1.0, size=(PER_J, DSJ)).astype(np.float32)
    profile_calls({
        f"ops.matmul f32 {S}^3": lambda: ops.matmul(a32, b32),
        f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS}": lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed),
        f"ops.simjoin_counts {NJ}x{DJ}": lambda: ops.simjoin_counts(xj, eps),
        f"ops.simjoin_pairs {NJ}x{DJ}": lambda: ops.simjoin_pairs(xj, eps),
        f"ops.floyd_warshall {NF}": lambda: ops.floyd_warshall(fw_d),
        f"ops.floyd_warshall {NF} fused=False": lambda: ops.floyd_warshall(fw_d, fused=False),
        f"ops.cholesky {NC}": lambda: ops.cholesky(ch_a),
        f"ops.cholesky {NC} fused=False": lambda: ops.cholesky(ch_a, fused=False),
        f"ops.kmeans_assign {NK}x{DK} K={K}": lambda: ops.kmeans_assign(xk, cent),
        f"ops.kmeans_assign 4096x{DK} K={K}": lambda: ops.kmeans_assign(probes, cent),
        f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS} fused=False":
            lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed, fused=False),
        f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G}": lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed),
        f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G} fused=False":
            lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed, fused=False),
        f"ops.matmul f32 {S}^3 schedule_ndim=3": lambda: ops.matmul(a32, b32, schedule_ndim=3),
        f"StreamKMeans warm tick ({NSK} residents + {PER}, one assign of {MP})":
            lambda: (svc_k.insert(more_k), svc_k.assign(probe_pool[:MP]), svc_k.tick()),
        f"StreamSimJoin warm tick ({NSS} residents + {PER_J}, one query of {MQ})":
            lambda: (svc_j.insert(more_j), svc_j.query(q_pool[:MQ]), svc_j.tick()),
    })
    # what the sharded and autotuner phases hold their runs against
    ctx = {"xk": xk, "K": K, "iters": ITERS, "cent": cent, "asg": asg, "band_a": band_a,
           "xs_j": xs_jt, "eps_s": EPS_S, "xj": xj, "eps": eps, "pairs": pairs,
           "a32": a32, "b32": b32, "fw_d": fw_d, "ch_a": ch_a}
    return {"kernels": rows}, ctx


def time_update_d960(xg, asg_g, k: int, device) -> dict:
    """Row 6 at GIST1M's width: sfc_kmeans_update over its own (point
    tile, first_visit) table (the reference path's update, three column
    chunks of 320), its plain version, index_add_ and the bound."""
    import torch
    from repro_torch.core import kmeans_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_update_program

    n, d = xg.shape
    pt = -(-n // 128)
    xgp = torch.nn.functional.pad(xg, (0, 0, 0, pt * 128 - n)).contiguous()
    ag = torch.nn.functional.pad(asg_g, (0, pt * 128 - n)).contiguous()
    upd = kmeans_schedule_device("fur", pt, k // 128, device=device)[pt * (k // 128):, [1, 3]].contiguous()
    prog = kmeans_update_program(upd, col_i=0, bp=128, Kp=k, D=d, n_valid=n, columns=("i", "first_visit"))
    (s_k, n_k), (s_p, n_p) = launch(prog, xgp, ag), prog.plain(prog, xgp, ag)
    check(torch.equal(n_k, n_p), f"sfc_kmeans_update D={d}: counts vs plain at full size")
    err = float((s_k - s_p).abs().max())
    check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-2)), f"sfc_kmeans_update D={d}: sums err {err}")
    del s_k, s_p
    x_aug = torch.cat([xg, torch.ones(n, 1, device=device)], dim=1)
    acc = torch.zeros(k, d + 1, device=device)
    b_ms, b_by = bound_ms(float(n * d), FP32_PEAK, 4 * (n * d + n + k * d + k))
    out = {
        "shape": [n, d, k], "grid": list(prog.grid), "smem_bytes": prog.params["smem_bytes"],
        "ms": cuda_ms(lambda: launch(prog, xgp, ag), 10), "plain_ms": cuda_ms(lambda: prog.plain(prog, xgp, ag), 1, 0),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: acc.zero_().index_add_(0, asg_g.long(), x_aug), 10),
        "max_abs_err": err,
    }
    del x_aug, acc, xgp
    return out


def time_assign_d960(xg, cg, device) -> dict:
    """Row 5a at GIST1M's width: sfc_kmeans_assign over the k-means
    table's point tiles at the GIST run's centroids, held against its
    plain version (argmins outside the float64 band), its plain version's
    time, cdist + argmin, addmm + min and the bound 2 N Kp D over FP32."""
    import torch
    from repro_torch.core import kmeans_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_lloyd_program

    n, d = xg.shape
    k = cg.shape[0]
    pt = -(-n // 128)
    xgp = torch.nn.functional.pad(xg, (0, 0, 0, pt * 128 - n)).contiguous()
    assign, _update = kmeans_lloyd_program(kmeans_schedule_device("fur", pt, k // 128, device=device),
                                           pt=pt, ct=k // 128, bp=128, bc=128, D=d, k_valid=None,
                                           n_valid=n)
    cn = (cg * cg).sum(1)
    (m_k, a_k), (m_p, a_p) = launch(assign, xgp, cg, cn), assign.plain(assign, xgp, cg, cn)
    band = argmin_band(xg, cg)
    check(not bool(((a_k[:n] != a_p[:n]) & ~band).any()), f"sfc_kmeans_assign D={d} vs plain at full size")
    err = float((m_k - m_p).abs().max())
    del m_k, a_k, m_p, a_p, band
    b_ms, b_by = bound_ms(2.0 * pt * 128 * k * d, FP32_PEAK, 4 * (pt * 128 * d + k * d + k + 2 * pt * 128))
    out = {
        "shape": [n, d, k], "ms": cuda_ms(lambda: launch(assign, xgp, cg, cn), 5),
        "plain_ms": cuda_ms(lambda: assign.plain(assign, xgp, cg, cn), 1, 0),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.cdist(xgp, cg).argmin(dim=1), 5),
        "addmm_min_ms": cuda_ms(lambda: addmm_min(xgp, cg, cn), 5), "max_abs_err": err,
    }
    del xgp
    return out


def time_assign_tiles(entry, xk, probes, cent, device) -> None:
    """Row 4 at ops.kmeans_assign's main-path shapes: the 1,000,000 points
    (pt x ct = 7813 x 8 CTAs) and a 4,096-probe batch (32 x 8)."""
    import torch
    from repro_torch.core import tile_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_assign_program

    def program(x):
        pt = -(-x.shape[0] // 128)
        xp = torch.nn.functional.pad(x, (0, 0, 0, pt * 128 - x.shape[0])).contiguous()
        sched = tile_schedule_device("fur", (pt, k // 128), device=device)
        return kmeans_assign_program(sched, pt=pt, ct=k // 128, bp=128, bc=128, k_valid=None), xp

    k, d = cent.shape
    cn = (cent * cent).sum(1)
    prog, xp = program(xk)
    (m_k, _a), (m_p, _b) = launch(prog, xp, cent, cn), prog.plain(prog, xp, cent, cn)
    err = float((m_k - m_p).abs().max())
    check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_assign_tiles vs plain: err {err}")
    del m_k, m_p, _a, _b
    pprog, pp = program(probes)
    n_pt = prog.params["pt"]
    p_ms = cuda_ms(lambda: launch(pprog, pp, cent, cn), 10)
    p_bound, _by = bound_ms(2.0 * pp.shape[0] * k * d, FP32_PEAK, 4 * (pp.shape[0] * d + k * d + k + 2 * 8 * pp.shape[0]))
    entry("sfc_kmeans_assign_tiles", lambda: launch(prog, xp, cent, cn), lambda: prog.plain(prog, xp, cent, cn),
          lambda: torch.cdist(xp, cent).argmin(dim=1), 2.0 * n_pt * 128 * k * d, FP32_PEAK,
          4 * (n_pt * 128 * d + k * d + k + 2 * n_pt * (k // 128) * 128), 5, err,
          {"addmm_min_ms": cuda_ms(lambda: addmm_min(xp, cent, cn), 5),
           "probes_4096": {"ms": p_ms, "bound_ms": p_bound, "ctas": pprog.steps,
                           "library_ms": cuda_ms(lambda: torch.cdist(pp, cent).argmin(dim=1), 10),
                           "addmm_min_ms": cuda_ms(lambda: addmm_min(pp, cent, cn), 10)}})


def time_matmul3d(entry, a32, b32, a16, b16, device) -> None:
    """Row 2 at ops.matmul(schedule_ndim=3)'s main-path shapes: f32 8192³
    over the 64³ hilbert table (against torch.matmul and against the 2-D
    sfc_matmul on the same operands, in this run), and bf16 padded."""
    import torch
    from repro_torch.core import tile_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.matmul import matmul3d_csr_device, matmul3d_program, matmul_program

    s = a32.shape[0]
    ij, ks = matmul3d_csr_device("hilbert", (s // 128, s // 128, s // 128), device=device)
    prog = matmul3d_program(ij, ks, a32, b32, bm=128, bn=128, bk=128)
    got, want = launch(prog, a32, b32), prog.plain(prog, a32, b32)
    err, tol = float((got - want).abs().max()), 1e-4 * s ** 0.5
    check(err <= tol, f"sfc_matmul3d {s}^3 f32 vs plain: max err {err} > {tol}")
    del got, want
    p2 = matmul_program(tile_schedule_device("fur", (s // 128, s // 128), device=device), a32, b32,
                        bm=128, bn=128, bk=16)
    sfc_2d = cuda_ms(lambda: launch(p2, a32, b32), 5)
    m16, k16 = a16.shape
    n16 = b16.shape[1]
    a16p = torch.nn.functional.pad(a16, (0, (-k16) % 128, 0, (-m16) % 128)).contiguous()
    b16p = torch.nn.functional.pad(b16, (0, (-n16) % 128, 0, (-k16) % 128)).contiguous()
    shape16 = (a16p.shape[0] // 128, b16p.shape[1] // 128, a16p.shape[1] // 128)
    ij16, ks16 = matmul3d_csr_device("hilbert", shape16, device=device)
    p16 = matmul3d_program(ij16, ks16, a16p, b16p, bm=128, bn=128, bk=128)
    g16, w16 = launch(p16, a16p, b16p), p16.plain(p16, a16p, b16p)
    err16 = float((g16.float() - w16.float()).abs().max())
    tol16 = 1e-2 * max(1.0, float(w16.float().abs().max()))
    check(err16 <= tol16, f"sfc_matmul3d bf16 vs plain: max err {err16} > {tol16}")
    del g16, w16
    # bf16 inputs, f32 output: the same kernel's other epilogue
    p16f = matmul3d_program(ij16, ks16, a16p, b16p, bm=128, bn=128, bk=128, out_dtype=torch.float32)
    g16, w16 = launch(p16f, a16p, b16p), p16f.plain(p16f, a16p, b16p)
    err16f, tol16f = float((g16 - w16).abs().max()), 1e-4 * k16 ** 0.5
    check(err16f <= tol16f, f"sfc_matmul3d bf16->f32 vs plain: max err {err16f} > {tol16f}")
    del g16, w16
    b16_ms, b16_by = bound_ms(2.0 * m16 * n16 * k16, BF16_PEAK, 2 * (m16 * k16 + k16 * n16 + m16 * n16))
    entry("sfc_matmul3d", lambda: launch(prog, a32, b32), lambda: prog.plain(prog, a32, b32),
          lambda: torch.matmul(a32, b32), 2.0 * s ** 3, FP32_PEAK, 3 * s * s * 4, 5, err,
          {"table": [s // 128] * 3, "sfc_matmul_ms": sfc_2d,
           "bf16": {"shape": [m16, n16, k16], "table": list(shape16), "ms": cuda_ms(lambda: launch(p16, a16p, b16p), 5),
                    "plain_ms": cuda_ms(lambda: p16.plain(p16, a16p, b16p), 1, warmup=0),
                    "library_ms": cuda_ms(lambda: torch.matmul(a16, b16), 5), "bound_ms": b16_ms,
                    "bound_by": b16_by, "max_abs_err": err16, "tol": tol16,
                    "f32_out_ms": cuda_ms(lambda: launch(p16f, a16p, b16p), 5),
                    "f32_out_max_abs_err": err16f, "f32_out_tol": tol16f}}, clock=True)


# ---------------------------------------------------------------------------
# the LM serving slice: TinyLlama-1.1B on the paged flash engine
# ---------------------------------------------------------------------------

def _serve_cfg(**overrides):
    import dataclasses as dc

    from repro_torch.configs import get_config

    return dc.replace(get_config(SERVE_ARCH), **overrides)


def decode_inputs(rng, device, dtype, cfg=None, inactive=()):
    """Row 21 at the serving shapes: 8 slots of 128 pages of 16, the kv
    heads, query heads a kv head and head width of ``cfg`` (TinyLlama's
    4 x 8 x 64 by default), ragged positions (0 and 2047 included; pos =
    -1 in the ``inactive`` slots, whose page table is all trash page),
    the page table of a Hilbert-laid-out PagedKVCache; the trash page
    holds garbage."""
    import torch
    from repro_torch.serve import PagedKVCache

    B, MP, ps = SERVE_SLOTS, SERVE_MAX_LEN // SERVE_PAGE, SERVE_PAGE
    cfg = cfg or _serve_cfg()
    hkv, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim
    pos = rng.integers(0, SERVE_MAX_LEN, size=B).astype(np.int32)
    pos[:2] = (0, SERVE_MAX_LEN - 1)
    pos[list(inactive)] = -1
    kv = PagedKVCache(B, MP, ps, layout="hilbert")
    for b in range(B):
        if pos[b] >= 0:
            kv.ensure_pos(b, int(pos[b]))
    P = kv.num_pages

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=device).to(dtype)

    kp, vp = t((P, ps, hkv, d)), t((P, ps, hkv, d))
    kp[0], vp[0] = 3e3, -3e3
    return (torch.as_tensor(kv.page_table, device=device), torch.as_tensor(pos, device=device),
            t((B, hkv, g, d)), kp, vp)


def prefill_inputs(rng, device, dtype, cfg=None, trash=False):
    """Row 22 at the serving shapes: a cohort of 8 slots with 64-1024 new
    tokens each at staggered resume positions (the padded width 1024 of
    the engine's pow2-page bucket), pages from a Hilbert PagedKVCache, the
    heads and width of ``cfg`` (TinyLlama's by default); with ``trash``
    the trash page holds garbage."""
    import torch
    from repro_torch.serve import PagedKVCache

    B, MP, ps = SERVE_SLOTS, SERVE_MAX_LEN // SERVE_PAGE, SERVE_PAGE
    cfg = cfg or _serve_cfg()
    hkv, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim
    T = SERVE_MAX_LEN // 2  # the engine's bucket for prompts of up to 1024 new tokens
    lo = min(SERVE_PROMPT[0], T)
    n_new = rng.integers(lo, T + 1, size=B).astype(np.int32)
    n_new[:2] = (lo, T)
    pos0 = rng.integers(0, SERVE_MAX_LEN - n_new + 1).astype(np.int32)
    kv = PagedKVCache(B, MP, ps, layout="hilbert")
    for b in range(B):
        kv.ensure_pos(b, int(pos0[b] + n_new[b] - 1))
    P = kv.num_pages

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=device).to(dtype)

    q, kp, vp = t((B, T, hkv, g, d)), t((P, ps, hkv, d)), t((P, ps, hkv, d))
    if trash:
        kp[0], vp[0] = 3e3, -3e3
    return (torch.as_tensor(kv.page_table, device=device), torch.as_tensor(pos0, device=device),
            q, kp, vp, n_new)


def attention_inputs(rng, device, dtype, cfg=None, shape=None):
    """Row 20 at the model's full-sequence shapes: B·H sequences of S x D
    (TinyLlama's 2·32 of 2048 x 64 by default; ``shape`` = (B, H, S), D
    of ``cfg``), and per-sequence kv lengths for the kv_seqlen case."""
    import torch

    B, H, S = shape or ATTN_ROW20
    d = (cfg or _serve_cfg()).attn_head_dim

    def t():
        return torch.as_tensor(rng.standard_normal((B * H, S, d), dtype=np.float32), device=device).to(dtype)

    seqlen = torch.as_tensor(rng.integers(1, S + 1, size=B * H).astype(np.int32), device=device)
    return t(), t(), t(), seqlen


def prefill_covered(n_new, T: int, ps: int, device):
    """(B, T) bool: the rows of the q tiles a prefill schedule covers."""
    import torch

    rows = torch.zeros((len(n_new), T), dtype=torch.bool, device=device)
    for b, n in enumerate(n_new):
        rows[b, : -(-int(n) // ps) * ps] = True
    return rows


def flash_programs(device, dec, pre, att):
    """The three programs over the inputs of :func:`decode_inputs`,
    :func:`prefill_inputs` and :func:`attention_inputs` (row 20's None
    without ``att``)."""
    from repro_torch.kernels import attention as katt

    B, MP = dec[0].shape
    scale = 1.0 / float(np.sqrt(dec[2].shape[-1]))
    sd = katt.decode_page_schedule_device(B, MP, device=device)
    p_dec = katt.flash_decode_program(sd, dec[2], page_size=dec[3].shape[1], max_pages=MP, sm_scale=scale)
    ps = pre[3].shape[1]
    sp = katt.prefill_page_schedule_device(pre[1].cpu().numpy(), pre[5], ps, pre[0].shape[1], device=device)
    p_pre = katt.flash_prefill_program(sp, pre[2], page_size=ps, sm_scale=scale)
    if att is None:
        return p_dec, p_pre, None
    S = att[0].shape[1]
    sa = katt.attention_schedule_device(S // 128, S // 128, causal=True, device=device)
    p_att = katt.flash_attention_program(sa, att[0], causal=True, sm_scale=scale, bq=128, bkv=128,
                                         kv_valid=None)
    return p_dec, p_pre, p_att


def decode_work(dec):
    """Row 21's work on :func:`decode_inputs`' tensors: its operations (4
    g D for each live (kv head, kv row) pair of a slot: pos + 1 rows, none
    at pos < 0), its bytes (q read and o written once, each live K/V row
    and live page-table entry read once) and its library call, a page
    gather + SDPA under the positional mask."""
    import torch
    import torch.nn.functional as F

    pt, pos, q, kp, vp = dec
    B, hkv, g, d = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    p = pos.long()
    n_kv = int((p + 1).clamp(min=0).sum())
    live_pages = int(torch.where(p >= 0, p // ps + 1, 0).sum())
    mask = torch.arange(MP * ps, device=q.device)[None, None, None] <= p[:, None, None, None]

    def library():
        kk = kp[pt.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        vv = vp[pt.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q.reshape(B, hkv * g, 1, d), kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    nbytes = 2 * q.element_size() * (q.numel() + n_kv * hkv * d) + 4 * (live_pages + B)
    return 4.0 * g * hkv * d * n_kv, nbytes, library


def prefill_work(pre):
    """Row 22's work on :func:`prefill_inputs`' tensors: its operations (4
    g D for each (new token, kv row up to it) pair of a kv head), its bytes
    (the new tokens' q read and o written once; each lane with new tokens
    reads its pos0 + n_new kv rows and their pages' table entries once)
    and its library call, a page gather + SDPA under the causal mask of
    each token's position (``library(q, k_pages, v_pages)``: other dtypes
    of the same cohort)."""
    import torch
    import torch.nn.functional as F

    pt, pos0, q, kp, vp, n_new = pre
    B, T, hkv, g, d = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    dev = q.device
    positions = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
    nn = torch.as_tensor(n_new, device=dev).long()
    need = torch.arange(T, device=dev)[None] < nn[:, None]
    ops = 4.0 * g * hkv * d * float(((positions + 1) * need).sum())
    ends = (pos0.long() + nn)[nn > 0]
    kv_rows, pages = int(ends.sum()), int(((ends - 1) // ps + 1).sum())
    nbytes = q.element_size() * (2 * int(need.sum()) * hkv * g * d + 2 * kv_rows * hkv * d) + 4 * (pages + 2 * B)
    pmask = (torch.arange(MP * ps, device=dev)[None, None] <= positions[:, :, None])[:, None]

    def library(q=q, kp=kp, vp=vp):
        kk = kp[pt.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        vv = vp[pt.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        qq = q.reshape(B, T, hkv * g, d).transpose(1, 2)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=pmask, enable_gqa=True)

    return ops, nbytes, library


def attention_work(att, shape, causal: bool = True, valid: int | None = None):
    """Row 20's work on :func:`attention_inputs`' (B·H, S, D) tensors of
    ``shape`` (B, H, S): its operations (4 D a (query, kv) pair of the
    first ``valid`` rows, the unpadded sequence: causal, the pairs at or
    below the diagonal; else every pair), its bytes (q, k, v read and o
    written once, padding included: the kernel reads it) and its library
    call, ``scaled_dot_product_attention(is_causal=causal)`` over the first
    ``valid`` rows."""
    import torch.nn.functional as F

    q, k, v = att[:3]
    B, H, _ = shape
    BH, S, d = q.shape
    n = S if valid is None else valid

    def library():
        return F.scaled_dot_product_attention(*(t.reshape(B, H, S, d)[:, :, :n] for t in (q, k, v)),
                                              is_causal=causal)

    pairs = n * (n + 1) / 2 if causal else float(n) * n
    return 4.0 * BH * d * pairs, 4 * BH * S * d * q.element_size(), library


def compare_attention(rng, device) -> dict:
    """Each flash kernel against its plain version on the card at the
    serving shapes, in f32 and bf16 (the bf16 prefill on its tensor-core
    core, the f32 one on the register-tiled core, on the same cores at
    half the query heads, two q tiles a CTA, and at 5 of the 8 query
    heads, 25 tokens a CTA, and on the SIMT core at 12 query heads a kv
    head, 192 rows a q tile; row 20 in bf16 on the tensor cores, in f32 on the
    register-tiled core, and in both on the SIMT core at q and kv tiles of
    64 rows); returns the largest errors."""
    import torch
    from repro_torch.kernels import LAUNCHES, launch
    from repro_torch.kernels import attention as katt

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype)[6:]]
        dec, pre, att = (decode_inputs(rng, device, dtype), prefill_inputs(rng, device, dtype),
                         attention_inputs(rng, device, dtype))
        p_dec, p_pre, p_att = flash_programs(device, dec, pre, att)
        got, want = launch(p_dec, *dec), p_dec.plain(p_dec, *dec)
        torch.cuda.synchronize()
        errs[("sfc_flash_decode", dtype)] = attn_err(got, want, tol, f"sfc_flash_decode {dtype}")
        before = LAUNCHES.cores()
        got = launch(p_pre, *pre[:5])
        core = "wgmma" if dtype == torch.bfloat16 else "tiled"
        check(LAUNCHES.cores()[f"sfc_flash_prefill.{core}"] == before[f"sfc_flash_prefill.{core}"] + 1,
              f"sfc_flash_prefill {dtype}: not launched on its {core} core")
        want = p_pre.plain(p_pre, *pre[:5])
        torch.cuda.synchronize()
        rows = prefill_covered(pre[5], pre[2].shape[1], SERVE_PAGE, device)
        e_pre = attn_err(got[rows], want[rows], tol, f"sfc_flash_prefill {dtype}")
        errs[("sfc_flash_prefill", dtype)] = e_pre
        # the same cohort with half of each kv head's query heads (ps g =
        # 64 rows a q tile: 32 tokens, two tiles a CTA on the same core),
        # with 5 of them (Qwen's g = 5: 25 tokens, 125 rows a CTA, pages
        # partly held), and with 12 (the 8 and 4 of them again: ps g = 192
        # rows a q tile, past a CTA's 128: flash_rows, the "simt" core)
        sp = katt.prefill_page_schedule_device(pre[1].cpu().numpy(), pre[5], SERVE_PAGE, pre[0].shape[1],
                                               device=device)
        g8 = pre[2].shape[3]
        for key, heads, want_core in (("half", g8 // 2, core), ("g5", 5, core), ("simt_g12", 12, "simt")):
            q_part = torch.cat([pre[2], pre[2]], dim=3)[:, :, :, :heads].contiguous()
            p_part = katt.flash_prefill_program(sp, q_part, page_size=SERVE_PAGE, sm_scale=p_pre.params["sm_scale"])
            args = (pre[0], pre[1], q_part, pre[3], pre[4])
            got, ran = launch_core(p_part, args)
            check(ran == want_core, f"sfc_flash_prefill g={heads} {dtype}: launched on {ran}, expected {want_core}")
            check(p_part.launched["tokens"] == (katt.WGMMA_BQ // heads if ran != "simt" else SERVE_PAGE),
                  f"sfc_flash_prefill g={heads} {dtype}: {p_part.launched['tokens']} tokens a CTA")
            want = p_part.plain(p_part, *args)
            torch.cuda.synchronize()
            errs[(f"sfc_flash_prefill.{key}", dtype)] = attn_err(got[rows], want[rows], tol,
                                                                 f"sfc_flash_prefill {ran} g={heads} {dtype}")
        q, k, v, seqlen = att
        before = LAUNCHES.cores()
        got = launch(p_att, q, k, v)
        core = "wgmma" if dtype == torch.bfloat16 else "tiled"
        check(LAUNCHES.cores()[f"sfc_flash_attention.{core}"] == before[f"sfc_flash_attention.{core}"] + 1,
              f"sfc_flash_attention {dtype}: not launched on its {core} core")
        want = p_att.plain(p_att, q, k, v)
        torch.cuda.synchronize()
        e1 = attn_err(got, want, tol, f"sfc_flash_attention {dtype}")
        got, want = launch(p_att, q, k, v, seqlen), p_att.plain(p_att, q, k, v, seqlen)
        torch.cuda.synchronize()
        e2 = attn_err(got, want, tol, f"sfc_flash_attention kv_seqlen {dtype}")
        # every other shape runs flash_rows (the "simt" core): q and kv tiles
        # of 64 rows on the same inputs
        S = q.shape[1]
        p_simt = katt.flash_attention_program(
            katt.attention_schedule_device(S // 64, S // 64, causal=True, device=device), q,
            causal=True, sm_scale=p_att.params["sm_scale"], bq=64, bkv=64, kv_valid=None)
        before = LAUNCHES.cores()
        got = launch(p_simt, q, k, v, seqlen)
        check(LAUNCHES.cores()["sfc_flash_attention.simt"] == before["sfc_flash_attention.simt"] + 1,
              f"sfc_flash_attention bq=bkv=64 {dtype}: not launched on its simt core")
        want = p_simt.plain(p_simt, q, k, v, seqlen)
        torch.cuda.synchronize()
        e3 = attn_err(got, want, tol, f"sfc_flash_attention simt bq=bkv=64 kv_seqlen {dtype}")
        errs[("sfc_flash_attention", dtype)] = max(e1, e2, e3)
        B, hkv, g, d = dec[2].shape
        log(f"compare flash {str(dtype)[6:]} (rtol {tol['rtol']}, atol {tol['atol']}): decode B={B} Hkv={hkv} "
            f"g={g} D={d} ps={SERVE_PAGE} MP={dec[0].shape[1]} pos={dec[1].tolist()} max_abs_err="
            f"{errs[('sfc_flash_decode', dtype)]:.3e}; prefill Tq={pre[2].shape[1]} n_new={pre[5].tolist()} "
            f"pos0={pre[1].tolist()} max_abs_err={errs[('sfc_flash_prefill', dtype)]:.3e}, two q tiles a CTA "
            f"at g={pre[2].shape[3] // 2} max_abs_err={errs[('sfc_flash_prefill.half', dtype)]:.3e}, 25 tokens a "
            f"CTA at g=5 max_abs_err={errs[('sfc_flash_prefill.g5', dtype)]:.3e}, simt core at g=12 "
            f"max_abs_err={errs[('sfc_flash_prefill.simt_g12', dtype)]:.3e}; attention "
            f"BH={q.shape[0]} S={q.shape[1]} causal max_abs_err={e1:.3e}, with kv_seqlen {e2:.3e}, "
            f"simt core (bq = bkv = 64) with kv_seqlen {e3:.3e}")
        del dec, pre, att, got, want
    return errs


def launch_order_ab(p_pre, args, rows) -> dict:
    """A prefill launch with its CTAs longest first (the port's launch
    order, ``katt.longest_first``) against the same runs in table order (a
    permutation of the runs at launch; each run writes its own rows, so
    the covered rows are equal), timed in turns: table, longest, longest,
    table."""
    import dataclasses as dc

    import torch
    from repro_torch.kernels import launch

    runs = p_pre.params["runs"]
    table_order = runs[torch.argsort(runs[:, 0])].contiguous()
    check(bool((runs[1:, 1] <= runs[:-1, 1]).all()), "prefill runs are not launched longest first")
    p_tab = dc.replace(p_pre, params={**p_pre.params, "runs": table_order})
    check(torch.equal(launch(p_pre, *args)[rows], launch(p_tab, *args)[rows]),
          "prefill launched in table order: output differs")
    t = [cuda_ms(lambda p=p: launch(p, *args), 10) for p in (p_tab, p_pre, p_pre, p_tab)]
    return {"table_order_ms": [t[0], t[3]], "longest_first_ms": [t[1], t[2]]}


def attn_err(got, want, tol, what: str) -> float:
    import torch

    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), **tol)), f"{what}: max err {err} (tol {tol})")
    log(f"  {what}: max_abs_err {err:.3e}, max |plain| {float(want.float().abs().max()):.3e}")
    return err


def make_requests(rng, vocab: int, n: int | None = None, new=None, prompt=None, prefix: int | None = None):
    """n (SERVE_REQUESTS) prompts of 64-1024 tokens (``prompt``), every
    other one behind a shared system prefix of ``prefix`` (SERVE_PREFIX)
    tokens, with 32-128 (``new``) new tokens each."""
    n, new, prompt = n or SERVE_REQUESTS, new or SERVE_NEW, prompt or SERVE_PROMPT
    prefix = prefix or SERVE_PREFIX
    lo, hi = prompt
    system = rng.integers(0, vocab, size=prefix).tolist()
    reqs = []
    for i in range(n):
        if i % 2:
            n = int(rng.integers(max(lo, prefix + 1), hi + 1))
            prompt = system + rng.integers(0, vocab, size=n - prefix).tolist()
        else:
            prompt = rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
        reqs.append((prompt, int(rng.integers(new[0], new[1] + 1))))
    return reqs


def serve_engine(cfg, params, max_len: int = SERVE_MAX_LEN):
    from repro_torch.serve import ServeEngine

    return ServeEngine(cfg, params, num_slots=SERVE_SLOTS, max_len=max_len,
                       page_size=SERVE_PAGE, paged=True, attn_impl="flash", prefill="compiled",
                       prefix_sharing=True, page_layout="hilbert", stats_capacity=8192)


def time_prefill(engine) -> dict:
    """Time the engine's admissions (its compiled prefill; the dense
    engine's chunked one), synchronised: the returned dict accumulates their
    seconds, new tokens and calls until ``delattr(engine, d["attr"])``
    restores the engine (the class's method; setting the bound method back
    would leave a reference cycle that keeps the engine's weights and pool
    alive until the next garbage collection)."""
    import torch

    attr = "_prefill_compiled" if engine.prefill_mode == "compiled" else "_prefill_chunked"
    prefill = {"s": 0.0, "tokens": 0, "calls": 0, "launching": 0, "attr": attr, "inner": getattr(engine, attr)}

    def timed_prefill(slots):
        n = sum(len(engine.slot_req[s].prompt) - 1 - int(engine.pos[s]) for s in slots)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill["inner"](slots)
        torch.cuda.synchronize()
        prefill["s"] += time.perf_counter() - t
        prefill["tokens"] += n
        prefill["calls"] += 1
        prefill["launching"] += int(n > 0)  # an admission with new tokens runs the model

    setattr(engine, attr, timed_prefill)
    return prefill


def drive_engine(engine, requests) -> tuple[list, dict]:
    """Submit every request at once and tick until all are served.
    Prefill (admission) and decode are timed apart (synchronised), and
    each request's time to first token from its submission."""
    import torch

    prefill = time_prefill(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new=m) for p, m in requests]
    ttft = {}
    ticks = 0
    while any(not r.done for r in reqs):
        engine.step()
        ticks += 1
        now = time.perf_counter()
        for r in reqs:
            if r.out and r.rid not in ttft:
                ttft[r.rid] = now - t0
        check(ticks < 100_000, "the engine does not finish")
    wall = time.perf_counter() - t0
    delattr(engine, prefill["attr"])
    decode_tokens = sum(len(r.out) for r in reqs)
    decode_s = wall - prefill["s"]
    t = np.array(sorted(ttft.values()))
    kv = engine.kv_pages
    pages = {} if kv is None else {
        "pages_allocated": kv.stat_allocated, "pages_shared": kv.stat_shared, "pages_cow": kv.stat_cow}
    return reqs, {
        "requests": len(reqs), "ticks": ticks, "wall_s": wall,
        "admissions": prefill["calls"], "launching_admissions": prefill["launching"],
        "prefill_tokens": prefill["tokens"], "prefill_s": prefill["s"],
        "prefill_tok_per_s": prefill["tokens"] / prefill["s"],
        "decode_tokens": decode_tokens, "decode_s": decode_s, "decode_tok_per_s": decode_tokens / decode_s,
        "ttft_p50_ms": 1e3 * float(np.percentile(t, 50)), "ttft_p99_ms": 1e3 * float(np.percentile(t, 99)),
        "tick_p99_ms": 1e3 * engine.stats.p99(), "tick_mean_ms": 1e3 * engine.stats.mean(), **pages,
    }


def warm_decode_tick(cfg, params, requests, device, make_engine=None, unembed: bool = False) -> dict:
    """Device busy share of one warm decode tick (8 active slots, no
    admission) under torch.profiler, on ``make_engine(cfg, params)``
    (default :func:`serve_engine`); with ``unembed``, one more tick with
    its ``unembed`` timed apart (:func:`unembed_tick`)."""
    engine = (make_engine or serve_engine)(cfg, params)
    for p, _m in requests[:SERVE_SLOTS]:
        engine.submit(p, max_new=64)
    for _ in range(4):
        engine.step()
    check(bool(engine.active.all()) and not engine._queue, "warm tick: not all slots decoding")
    label = f"ServeEngine warm decode tick ({SERVE_SLOTS} slots, {cfg.name} {cfg.num_layers} layers {cfg.dtype})"
    out = profile_calls({label: engine.step})[0]
    if unembed:
        out["unembed"] = unembed_tick(engine.step, cfg)
    return out


def decode_snapshot(engine) -> tuple:
    """The state a paged engine's next decode step starts from: the next
    tokens, positions, active mask, page table and a copy of the pools,
    the pages of the step's positions allocated first, as the engine's own
    tick does (a slot whose position starts a page would otherwise write
    to, and read, the trash page, where two such slots collide)."""
    for s in np.nonzero(engine.active)[0]:
        engine.kv_pages.ensure_pos(int(s), int(engine.pos[s]))
    return (engine.next_token.copy(), engine.pos.copy(), engine.active.copy(),
            engine.kv_pages.page_table.copy(), {k: v.clone() for k, v in engine.cache["blocks"].items()})


def replay_gate(cfg32, params32, reqs, step_logits=None, band=GATE_BAND) -> dict:
    """Every served token against the argmax of the port's dense forward
    (plain attention, no kernel, unless ``cfg32`` sets
    ``use_hilbert_kernels``) over the request's prompt and served tokens,
    outside the top-2 margin band.  ``step_logits``: {(rid, i): the f32
    logits of the decode step that served token i}, held against the
    forward's at the same position (the largest difference is returned).
    Returns the tokens checked, those in the band and those in the band that
    differ from the forward's argmax."""
    import torch
    from repro_torch.models import forward

    in_band = differ = checked = 0
    step_diff = 0.0
    for r in reqs:
        seq = r.prompt + r.out[:-1]
        logits, _ = forward(params32, {"tokens": np.asarray([seq], np.int32)}, cfg32)
        lg = logits[0, len(r.prompt) - 1:]
        if step_logits is not None:
            steps = torch.stack([step_logits[(r.rid, i)] for i in range(len(r.out))])
            step_diff = max(step_diff, float((steps - lg).abs().max()))
        top2 = torch.topk(lg, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        pick = lg.argmax(dim=-1).cpu().numpy()
        served = np.asarray(r.out)
        near = margin <= band
        check(not bool(((pick != served) & ~near).any()),
              f"replay rid {r.rid}: served tokens differ from the dense forward's argmax outside the band")
        in_band += int(near.sum())
        differ += int((pick != served).sum())
        checked += len(served)
    out = {"positions": checked, "in_band": in_band, "in_band_differ": differ, "band": band}
    if step_logits is not None:
        out["decode_step_vs_forward_max_abs_diff"] = step_diff
    return out


def serving_path(rng, device, seed: int) -> list:
    """(a) the three flash kernels against their plain versions; (b) the
    bf16 serving run of TinyLlama-1.1B at full width and the model's
    full-sequence forward through sfc_flash_attention, launches counted
    per path; (c) the f32 correctness gate; (d) kernel timings."""
    import dataclasses as dc

    import torch
    from repro_torch.kernels import LAUNCHES, launch
    from repro_torch.kernels import attention as katt
    from repro_torch.models import count_params, decode_step_paged, forward, init_params

    errs = compare_attention(rng, device)

    # --- (b) the serving run, bf16 -----------------------------------------
    cfg = _serve_cfg()
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=device)
    torch.cuda.synchronize()
    log(f"serving model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"Hkv={cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}, "
        f"{count_params(params)} parameters, seeded random, {time.perf_counter() - t0:.1f} s to make")
    requests = make_requests(rng, cfg.vocab_size)
    # warm-up: one short request through a throwaway engine (allocator,
    # cuBLAS handles); its launches are not counted
    warm = serve_engine(cfg, params)
    warm.submit(requests[0][0][:80], max_new=2)
    warm.run_until_done()
    del warm
    LAUNCHES.reset()
    reqs, metrics = drive_engine(serve_engine(cfg, params), requests)
    serve_launches = LAUNCHES.counts()
    serve_cores = LAUNCHES.cores()
    for r in reqs:
        check(len(r.out) == r.max_new and all(0 <= t < cfg.vocab_size for t in r.out), f"rid {r.rid}: output")
    check(metrics["pages_shared"] > 0, "prefix sharing never engaged")
    metrics["launches"] = {k: serve_launches[k] for k in SERVING_KERNELS}
    metrics["prefill_cores"] = {k: serve_cores[k] for k in PREFILL_CORES}
    log("serving: " + json.dumps(metrics))
    for name in ("sfc_flash_decode", "sfc_flash_prefill"):
        check(serve_launches[name] > 0, f"{name} was not launched by the serving run")
    # bf16 at Dk = Dv = 64, pages of 16, g = 8: every prefill on the tensor-core core
    check(serve_cores["sfc_flash_prefill.wgmma"] == serve_launches["sfc_flash_prefill"],
          f"serving: sfc_flash_prefill cores {metrics['prefill_cores']}, expected every launch on wgmma")
    cfg_hk = dc.replace(cfg, use_hilbert_kernels=True)
    toks = rng.integers(0, cfg.vocab_size, size=(ATTN_ROW20[0], ATTN_ROW20[2])).astype(np.int32)
    LAUNCHES.reset()
    t = time.perf_counter()
    logits_hk, _ = forward(params, {"tokens": toks}, cfg_hk)
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - t)
    fwd_launches = LAUNCHES.counts()
    fwd_cores = LAUNCHES.cores()
    check(fwd_launches["sfc_flash_attention"] > 0, "sfc_flash_attention was not launched by forward")
    # bf16 at D = 64, bq = bkv = 128: every layer on the tensor-core core
    check(fwd_cores["sfc_flash_attention.wgmma"] == fwd_launches["sfc_flash_attention"] == cfg.num_layers
          and fwd_cores["sfc_flash_attention.simt"] == 0,
          f"forward: sfc_flash_attention cores {fwd_cores}, expected {cfg.num_layers} wgmma launches")
    check(logits_hk.shape == (ATTN_ROW20[0], ATTN_ROW20[2], cfg.vocab_size)
          and bool(torch.isfinite(logits_hk).all()), "forward(use_hilbert_kernels): shape or non-finite")
    logits_pl, _ = forward(params, {"tokens": toks}, cfg)
    agree = float((logits_hk.argmax(-1) == logits_pl.argmax(-1)).float().mean())
    fwd_diff = float((logits_hk - logits_pl).abs().max())
    del logits_hk, logits_pl
    # the same forward warm: the median wall of 3 more (counted apart)
    warm_ms = []
    for _ in range(3):
        t = time.perf_counter()
        forward(params, {"tokens": toks}, cfg_hk)
        torch.cuda.synchronize()
        warm_ms.append(1e3 * (time.perf_counter() - t))
    log(f"forward {ATTN_ROW20[0]}x{ATTN_ROW20[2]} bf16 use_hilbert_kernels: {fwd_ms:.1f} ms "
        f"(warm {statistics.median(warm_ms):.2f} ms, median of 3), "
        f"sfc_flash_attention launches {fwd_launches['sfc_flash_attention']} (wgmma "
        f"{fwd_cores['sfc_flash_attention.wgmma']}, simt {fwd_cores['sfc_flash_attention.simt']}); "
        f"against the plain attention: "
        f"argmax agreement {agree:.4f}, max |dlogit| {fwd_diff:.3e}")
    busy = warm_decode_tick(cfg, params, requests, device)
    del params

    # --- (c) the correctness gate, f32 -------------------------------------
    cfg32 = _serve_cfg(dtype="float32")
    params32 = init_params(seed + 1, cfg32, device=device)
    engine = serve_engine(cfg32, params32)
    # every f32 admission through sfc_flash_prefill on the register-tiled
    # core (Dk = Dv = 64, pages of 16, g = 8), counted and timed apart
    gate_prefill = time_prefill(engine)
    LAUNCHES.reset()
    # two cohorts, so the second one shares the first one's prefix pages
    half = GATE_REQUESTS // 2
    gate_reqs = [engine.submit(p, max_new=m) for p, m in requests[:half]]
    engine.step()
    gate_reqs += [engine.submit(p, max_new=m) for p, m in requests[half:GATE_REQUESTS]]
    snap = None
    while any(not r.done for r in gate_reqs):
        engine.step()
        if snap is None and engine.active.all():
            snap = decode_snapshot(engine)
    delattr(engine, gate_prefill["attr"])
    gate_launches, gate_cores = LAUNCHES.counts()["sfc_flash_prefill"], LAUNCHES.cores()
    check(gate_launches > 0 and gate_cores["sfc_flash_prefill.tiled"] == gate_launches,
          f"f32 gate: sfc_flash_prefill launches {gate_launches}, cores "
          f"{ {k: gate_cores[k] for k in PREFILL_CORES} }, expected every launch on tiled")
    gate = replay_gate(cfg32, params32, gate_reqs)
    gate["pages_shared"], gate["pages_cow"] = engine.kv_pages.stat_shared, engine.kv_pages.stat_cow
    gate["prefill"] = {"sfc_flash_prefill_launches": gate_launches,
                       "cores": {k: gate_cores[k] for k in PREFILL_CORES},
                       "admissions": gate_prefill["calls"], "tokens": gate_prefill["tokens"],
                       "wall_s": gate_prefill["s"]}
    check(snap is not None, "f32 gate: the engine never ran every slot at once")
    nt, pos, act, pt, pools = snap
    outs = {}
    for impl in ("flash", "xla"):
        cache = {"blocks": {k: v.clone() for k, v in pools.items()}}
        outs[impl], _ = decode_step_paged(params32, nt[:, None], cache, pos, pt, cfg32, write_mask=act,
                                          attn_impl=impl)
    step_err = float((outs["flash"] - outs["xla"]).abs().max())
    check(bool(torch.allclose(outs["flash"], outs["xla"], rtol=STEP_TOL, atol=STEP_TOL)),
          f"decode_step_paged flash vs xla: max err {step_err}")
    gate["decode_step_paged_flash_vs_xla_max_abs_err"] = step_err
    # the f32 forward, 1 x 2048 tokens, through row 20's register-tiled core
    toks32 = rng.integers(0, cfg32.vocab_size, size=(1, ATTN_ROW20[2])).astype(np.int32)
    cfg32_hk = dc.replace(cfg32, use_hilbert_kernels=True)
    LAUNCHES.reset()
    t = time.perf_counter()
    lk, _ = forward(params32, {"tokens": toks32}, cfg32_hk)
    torch.cuda.synchronize()
    f32_fwd_ms = 1e3 * (time.perf_counter() - t)
    f32_launches, f32_cores = LAUNCHES.counts()["sfc_flash_attention"], LAUNCHES.cores()
    check(f32_cores["sfc_flash_attention.tiled"] == f32_launches == cfg32.num_layers,
          f"f32 forward: sfc_flash_attention launches {f32_launches}, cores {f32_cores}, expected "
          f"{cfg32.num_layers} on the tiled core")
    lp, _ = forward(params32, {"tokens": toks32}, cfg32)
    fwd_err = float((lk - lp).abs().max())
    check(bool(torch.isfinite(lk).all()) and lk.shape == lp.shape, "f32 forward: non-finite or shape")
    check(bool(torch.allclose(lk, lp, rtol=STEP_TOL, atol=STEP_TOL)), f"f32 forward kernel vs plain: {fwd_err}")
    # logits allclose at STEP_TOL can swap the top two only where their
    # margin is at most 2 (atol + rtol |top|): the band left out
    top2 = lp.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * STEP_TOL * (1 + top2[..., 0].abs())
    same = lk.argmax(-1) == lp.argmax(-1)
    check(bool(same[clear].all()), f"f32 forward: argmax differs at {int((~same & clear).sum())} positions "
                                   f"outside the margin band")
    del lk, lp
    warm = [cuda_ms(lambda: forward(params32, {"tokens": toks32}, cfg32_hk), 1, warmup=0) for _ in range(3)]
    fwd_dev = kernel_ms(lambda: forward(params32, {"tokens": toks32}, cfg32_hk), 2)
    att_dev = sum(v for k, v in fwd_dev.items() if "flash_tiled" in k)
    gate["forward_flash_vs_plain_max_abs_err"] = fwd_err
    gate["forward_f32"] = {
        "tokens": int(toks32.size), "wall_ms": f32_fwd_ms, "warm_ms": statistics.median(warm),
        "device_ms": sum(fwd_dev.values()), "sfc_flash_attention_device_ms": att_dev,
        "sfc_flash_attention_launches": f32_launches,
        "cores": {k: f32_cores[k] for k in ("sfc_flash_attention.tiled", "sfc_flash_attention.simt",
                                            "sfc_flash_attention.wgmma")},
        "argmax_clear_share": float(clear.float().mean()), "argmax_agreement": float(same.float().mean()),
    }
    log("check serving f32 gate: " + json.dumps(gate) + f" (tolerance rtol = atol = {STEP_TOL}; the f32 "
        f"forward's argmax where the top-2 margin exceeds 2 (atol + rtol |top|))")
    del params32, engine, pools, snap, outs

    # --- (d) timings at the serving shapes (bf16) --------------------------
    rows = []
    dec, pre, att = (decode_inputs(rng, device, torch.bfloat16), prefill_inputs(rng, device, torch.bfloat16),
                     attention_inputs(rng, device, torch.bfloat16))
    p_dec, p_pre, p_att = flash_programs(device, dec, pre, att)
    launches = {**{k: serve_launches[k] for k in ("sfc_flash_decode", "sfc_flash_prefill")},
                "sfc_flash_attention": fwd_launches["sfc_flash_attention"]}

    def row(name, kern, plain, library, ops_, nbytes, err, extra, device_time=False):
        """ms and library_ms are the CUDA-event time of a call, as for
        every row; with device_time, device_ms and library_device_ms add
        the device time of the kernels a call launches (torch.profiler),
        each kernel's beside them: for a call whose kernels take less than
        its host side."""
        b_ms, b_by = bound_ms(ops_, BF16_PEAK, nbytes)
        timing = {"ms": cuda_ms(kern, 10), "library_ms": cuda_ms(library, 10)}
        if device_time:
            kern_dev, lib_dev = kernel_ms(kern, 10), kernel_ms(library, 10)
            timing.update(device_ms=sum(kern_dev.values()), library_device_ms=sum(lib_dev.values()),
                          kernels_ms=kern_dev, library_kernels_ms=lib_dev)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timing["library_ms"], "peak": "bf16 tensor cores (989 TFLOP/s), HBM 3.35 TB/s",
            **timing, **extra,
        })
        log(f"time {name}: {json.dumps(rows[-1])}")

    pt, pos, q, kp, _ = dec
    B, hkv, g, d = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    dec_ops, dec_bytes, sdpa_decode = decode_work(dec)
    # the split-KV launch: split CTAs (those past a slot's last live page
    # exit at once), the merge's B x Hkv CTAs, the f32 workspace
    lay = katt.decode_launch(B, hkv, g, ps, MP)
    live_ctas = int(sum(-(-(int(pp) // ps + 1) // lay.split_pages) for pp in pos.tolist())) * hkv
    row("sfc_flash_decode", lambda: launch(p_dec, *dec), lambda: p_dec.plain(p_dec, *dec), sdpa_decode,
        dec_ops, dec_bytes, errs[("sfc_flash_decode", torch.bfloat16)],
        {"shape": {"B": B, "Hkv": hkv, "g": g, "D": d, "page_size": ps, "max_pages": MP,
                   "pos": pos.tolist()},
         "split_pages": lay.split_pages, "splits": lay.splits,
         "ctas": int(np.prod(lay.grid)), "live_ctas": live_ctas, "merge_ctas": B * hkv,
         "workspace_bytes": 4 * int(np.prod(lay.workspace(g, d))),
         "sms": torch.cuda.get_device_properties(device).multi_processor_count}, device_time=True)

    pt2, pos0, q2, kp2, vp2, n_new = pre
    T = q2.shape[1]
    rows_pre = prefill_covered(n_new, T, ps, device)
    pref_ops, pref_bytes, sdpa_prefill = prefill_work(pre)
    # f32 on the register-tiled core: the same cohort, bound by the FP32
    # pipes; its launches are the f32 gate's
    pre32 = (pt2, pos0, q2.float(), kp2.float(), vp2.float())
    pf_bound, pf_by = bound_ms(pref_ops, FP32_PEAK, 2 * pref_bytes)
    pf32 = {"core": "tiled", "launches": gate["prefill"]["sfc_flash_prefill_launches"],
            "launch_order": launch_order_ab(p_pre, pre32, rows_pre),
            "ms": cuda_ms(lambda: launch(p_pre, *pre32), 10),
            "plain_ms": cuda_ms(lambda: p_pre.plain(p_pre, *pre32), 1, warmup=0),
            "library_ms": cuda_ms(lambda: sdpa_prefill(*pre32[2:]), 10),
            "bound_ms": pf_bound, "bound_by": pf_by,
            "max_abs_err": errs[("sfc_flash_prefill", torch.float32)],
            "half_max_abs_err": errs[("sfc_flash_prefill.half", torch.float32)],
            "g5_max_abs_err": errs[("sfc_flash_prefill.g5", torch.float32)],
            "simt_g12_max_abs_err": errs[("sfc_flash_prefill.simt_g12", torch.float32)]}
    del pre32
    row("sfc_flash_prefill", lambda: launch(p_pre, *pre[:5]), lambda: p_pre.plain(p_pre, *pre[:5]), sdpa_prefill,
        pref_ops, pref_bytes, errs[("sfc_flash_prefill", torch.bfloat16)],
        {"shape": {"B": B, "Tq": T, "n_new": [int(n) for n in n_new], "pos0": pos0.tolist(), "Hkv": hkv,
                   "g": g, "D": d, "page_size": ps}, "launch_order": launch_order_ab(p_pre, pre[:5], rows_pre),
         "ctas": int(p_pre.grid[0] * p_pre.grid[1]), "rows_per_cta": p_pre.launched["rows_per_cta"],
         "core": p_pre.launched["core"], "half_max_abs_err": errs[("sfc_flash_prefill.half", torch.bfloat16)],
         "g5_max_abs_err": errs[("sfc_flash_prefill.g5", torch.bfloat16)],
         "simt_g12_max_abs_err": errs[("sfc_flash_prefill.simt_g12", torch.bfloat16)], "f32": pf32})

    qa, ka, va, _seqlen = att
    BH, S, d = qa.shape
    att_ops, att_bytes, sdpa_causal = attention_work(att, ATTN_ROW20)
    # f32 on the register-tiled core: the same function, bound by the FP32 pipes
    att32 = attention_inputs(rng, device, torch.float32)
    _, bytes32, sdpa32 = attention_work(att32, ATTN_ROW20)
    f32_bound, f32_by = bound_ms(att_ops, FP32_PEAK, bytes32)
    f32 = {"core": "tiled", "ms": cuda_ms(lambda: launch(p_att, *att32[:3]), 10),
           "plain_ms": cuda_ms(lambda: p_att.plain(p_att, *att32[:3]), 1, warmup=0),
           "library_ms": cuda_ms(sdpa32, 10), "bound_ms": f32_bound, "bound_by": f32_by,
           "max_abs_err": errs[("sfc_flash_attention", torch.float32)]}
    del att32, sdpa32
    row("sfc_flash_attention", lambda: launch(p_att, qa, ka, va), lambda: p_att.plain(p_att, qa, ka, va),
        sdpa_causal, att_ops, att_bytes, errs[("sfc_flash_attention", torch.bfloat16)],
        {"shape": {"BH": BH, "S": S, "D": d, "bq": 128, "bkv": 128, "causal": True},
         "ctas": int(p_att.grid[0] * p_att.grid[1]), "core": "wgmma", "f32": f32})
    log("serving busy: " + json.dumps(busy))
    return rows


# ---------------------------------------------------------------------------
# phase 7b: DeepSeek-V2 paged serving (MLA + MoE) on the latent core
# ---------------------------------------------------------------------------

def _mla_cfg(layers: int, dtype: str):
    import dataclasses as dc

    from repro_torch.configs import get_config

    return dc.replace(get_config(MLA_ARCH), num_layers=layers, dtype=dtype)


def latent_inputs(rng, device, pool_dtype, *, g=None, D=None, prefill=False):
    """Rows 21 / 22 at MLA's shapes: 8 slots of 128 pages of 16 (max_len
    2048), Hkv 1, g 128 query heads of D 576 = r 512 + dr 64 in f32, one
    latent pool (bf16 or f32) given as K and V, garbage in the trash page.
    Decode: ragged positions (0 and 2047 included); prefill: the cohort of
    :func:`prefill_inputs` (64-1024 new tokens at staggered pos0, Tq 1024).
    Returns (page_table, pos or pos0, q, pool, n_new or None)."""
    import torch
    from repro_torch.serve import PagedKVCache

    cfg = _mla_cfg(1, "float32")
    g = g or cfg.num_heads
    D = D or cfg.kv_lora_rank + cfg.qk_rope_head_dim
    B, MP, ps = SERVE_SLOTS, SERVE_MAX_LEN // SERVE_PAGE, SERVE_PAGE
    kv = PagedKVCache(B, MP, ps, layout="hilbert")
    n_new = None
    if prefill:
        T = SERVE_MAX_LEN // 2
        n_new = rng.integers(SERVE_PROMPT[0], T + 1, size=B).astype(np.int32)
        n_new[:2] = (SERVE_PROMPT[0], T)
        pos = rng.integers(0, SERVE_MAX_LEN - n_new + 1).astype(np.int32)
        last = pos + n_new - 1
        qshape = (B, T, 1, g, D)
    else:
        pos = rng.integers(0, SERVE_MAX_LEN, size=B).astype(np.int32)
        pos[:2] = (0, SERVE_MAX_LEN - 1)
        last = pos
        qshape = (B, 1, g, D)
    for b in range(B):
        kv.ensure_pos(b, int(last[b]))
    pool = torch.as_tensor(rng.standard_normal((kv.num_pages, ps, 1, D), dtype=np.float32), device=device)
    pool[0] = 3e3 * torch.sign(pool[0])
    q = torch.as_tensor(rng.standard_normal(qshape, dtype=np.float32), device=device)
    return (torch.as_tensor(kv.page_table, device=device), torch.as_tensor(pos, device=device), q,
            pool.to(pool_dtype), n_new)


def latent_programs(device, inputs, scale):
    """The decode or prefill program of :func:`latent_inputs`' tensors, on
    the latent core."""
    from repro_torch.kernels import attention as katt

    pt, pos, q, pool, n_new = inputs
    B, MP = pt.shape
    ps = pool.shape[1]
    if n_new is None:
        sd = katt.decode_page_schedule_device(B, MP, device=device)
        return katt.flash_decode_program(sd, q, page_size=ps, max_pages=MP, sm_scale=scale, latent=True)
    sp = katt.prefill_page_schedule_device(pos.cpu().numpy(), n_new, ps, MP, device=device)
    return katt.flash_prefill_program(sp, q, page_size=ps, sm_scale=scale, latent=True)


def compare_latent(rng, device) -> dict:
    """Rows 21 and 22 on the latent core against their plain versions: at
    MLA's full shapes with the pool in bf16 and in f32, and at the reduced
    width D = 48, g = 4; each launch counted on the latent core.  Returns
    the largest errors by (name, pool dtype)."""
    import torch
    from repro_torch.kernels import LAUNCHES, launch

    scale = 1.0 / float(np.sqrt(MLA_QK_WIDTH))
    errs, parts = {}, []
    for pool_dtype in (torch.bfloat16, torch.float32):
        for g, D in ((None, None), (4, 48)):
            for prefill in (False, True):
                inp = latent_inputs(rng, device, pool_dtype, g=g, D=D, prefill=prefill)
                prog = latent_programs(device, inp, scale)
                name = prog.name
                args = inp[:4] + (inp[3],)
                before = LAUNCHES.cores()[f"{name}.latent"]
                got = launch(prog, *args)
                check(LAUNCHES.cores()[f"{name}.latent"] == before + 1, f"{name}: not launched on the latent core")
                want = prog.plain(prog, *args)
                torch.cuda.synchronize()
                what = f"{name} latent g={inp[2].shape[-2]} D={inp[2].shape[-1]} pool {str(pool_dtype)[6:]}"
                if prefill:
                    rows = prefill_covered(inp[4], inp[2].shape[1], SERVE_PAGE, device)
                    got, want = got[rows], want[rows]
                err = attn_err(got, want, LATENT_TOL, what)
                key = (name, str(pool_dtype)[6:])
                errs[key] = max(errs.get(key, 0.0), err)
                parts.append(f"{what}: pos{'0' if prefill else ''}={inp[1].tolist()} max_abs_err={err:.3e}")
                del inp, prog, got, want
    log(f"compare flash latent (rtol {LATENT_TOL['rtol']}, atol {LATENT_TOL['atol']}): " + "; ".join(parts))
    return errs


def served_steps(engine, record):
    """Record ``record(logits)[slot]`` for every token the dense engine
    serves, by (rid, index): returns (the dict, a callable that restores
    the engine module).  Wraps the engine module's masked step; chunked
    prefill's steps (no token served) are left out."""
    from repro_torch.serve import engine as engine_mod

    out, inner_step, inner_prefill = {}, engine_mod._masked_step, engine._prefill_chunked
    state = {"prefill": False}

    def prefill(slots):
        state["prefill"] = True
        try:
            inner_prefill(slots)
        finally:
            state["prefill"] = False

    def step(params, toks, cache, pos, mask, *, cfg):
        logits, cache = inner_step(params, toks, cache, pos, mask, cfg=cfg)
        if not state["prefill"]:
            values = record(logits)
            for s in range(engine.num_slots):
                req = engine.slot_req[s]
                if engine.active[s] and req is not None:
                    out[(req.rid, len(req.out))] = values[s]
        return logits, cache

    engine._prefill_chunked = prefill
    engine_mod._masked_step = step
    return out, lambda: setattr(engine_mod, "_masked_step", inner_step)


def margins_of_dense_engine(engine):
    """The top-2 logit margin of the decode step of every token the dense
    engine samples (:func:`served_steps`)."""
    import torch

    def margins(logits):
        top2 = torch.topk(logits, 2, dim=-1).values
        return [float(m) for m in (top2[:, 0] - top2[:, 1]).cpu().numpy()]

    return served_steps(engine, margins)


class RouterLog:
    """The routing of every MoE call while entered (``moe_forward``
    wrapped; every block of the model is MoE, so a call's layer is its
    index modulo the layers): for each live token row (its token mask, or
    every row) that ``key(b, t)`` names (None: left out), under that key
    and the layer, its top-k experts (sorted), the gap between its k-th
    and (k+1)-th routing probabilities and its top-k probabilities, read
    on the host (a sync a call)."""

    def __init__(self, key):
        self.key, self.rec, self.calls = key, {}, 0

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self._inner = inner = moe_mod.moe_forward

        def wrapped(params, x, cfg, token_mask=None, lossless=False):
            self.record(params, x, cfg, token_mask)
            return inner(params, x, cfg, token_mask=token_mask, lossless=lossless)

        moe_mod.moe_forward = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod

        moe_mod.moe_forward = self._inner

    def record(self, params, x, cfg, token_mask):
        import torch

        B, S, d = x.shape
        k, layer = cfg.top_k, self.calls % cfg.num_layers
        self.calls += 1
        probs = torch.softmax(x.reshape(B * S, d).float() @ params.router, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top = torch.sort(idx[:, :k], dim=-1).values.reshape(B, S, k).cpu().numpy()
        gap = (vals[:, k - 1] - vals[:, k]).reshape(B, S).cpu().numpy()
        pk = vals[:, :k].reshape(B, S, k).cpu().numpy()
        live = np.ones((B, S), bool) if token_mask is None else token_mask.cpu().numpy()
        for b, t in zip(*np.nonzero(live)):
            key = self.key(int(b), int(t))
            if key is not None:
                self.rec[key + (layer,)] = (tuple(top[b, t]), float(gap[b, t]), pk[b, t])


def router_flips(a: RouterLog, b: RouterLog) -> dict:
    """The decisions two runs' logs both hold: those whose top-k expert
    sets differ (flips; each with the larger of its two k-th to (k+1)-th
    gaps), and the largest difference of the top-k probabilities where the
    sets agree; the smallest gap of either log."""
    common = a.rec.keys() & b.rec.keys()
    flips = {key: max(a.rec[key][1], b.rec[key][1]) for key in common if a.rec[key][0] != b.rec[key][0]}
    diff = max((float(np.abs(a.rec[key][2] - b.rec[key][2]).max()) for key in common if key not in flips),
               default=0.0)
    gaps = [r[1] for log in (a, b) for r in log.rec.values()]
    return {"decisions": len(common), "flips": flips, "agreeing_prob_max_abs_diff": diff,
            "min_gap": min(gaps, default=float("inf"))}


class EngineRouterLog(RouterLog):
    """A :class:`RouterLog` of an engine's steps keyed (rid, position):
    while entered it also wraps the engine module's masked steps (decode,
    and the dense engine's chunked prefill: one token a slot, live where
    the step's slot mask is) and ``prefill_paged`` (the compiled prefill:
    row t of slot b is position pos0[b] + t, live where its token mask
    is)."""

    STEPS = ("_masked_step", "_masked_step_paged", "prefill_paged")

    def __init__(self, engine):
        super().__init__(self._key)
        self.engine, self.state = engine, {}

    def _key(self, b, t):
        if "mask" in self.state and not self.state["mask"][b]:
            return None
        return self.engine.slot_req[b].rid, int(self.state["pos"][b]) + t

    def __enter__(self):
        from repro_torch.serve import engine as engine_mod

        self._steps = {name: getattr(engine_mod, name) for name in self.STEPS}
        state = self.state

        def wrap(inner, masked):
            def step(params, toks, cache, pos, *a, **kw):
                state.clear()
                state["pos"] = pos.cpu().numpy()
                if masked:  # (.., pos, mask, ..): one token a slot
                    state["mask"] = a[0].cpu().numpy()
                return inner(params, toks, cache, pos, *a, **kw)
            return step

        for name, inner in self._steps.items():
            setattr(engine_mod, name, wrap(inner, name != "prefill_paged"))
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.serve import engine as engine_mod

        for name, inner in self._steps.items():
            setattr(engine_mod, name, inner)
        self.engine = None  # the log outlives the engine's pools
        super().__exit__(*exc)


def engine_gate(cfg32, params32, requests, what: str, cores: dict, max_len: int = SERVE_MAX_LEN) -> dict:
    """The f32 gate: the paged flash engine's greedy tokens against the
    dense-cache engine's (``paged=False``: the plain decode, independent of
    rows 21-22), both of ``max_len`` positions a slot, each request's
    first differing token inside the top-2 margin band of the dense
    engine's logits, or (a MoE model, both
    engines' routing logged) at or after a position where the two
    engines' routing differs, every such flip a near-tie (the k-th and
    (k+1)-th routing probabilities within ROUTER_GATE_BAND in both); every
    launch of the flash engine on its core (``cores``: {entry point:
    core}); one decode step flash vs "xla" from :func:`decode_snapshot`
    of the engine with every request decoding."""
    import contextlib

    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import decode_step_paged
    from repro_torch.serve import ServeEngine

    moe = cfg32.block_kind == "moe"
    engine = serve_engine(cfg32, params32, max_len)
    flash_log = EngineRouterLog(engine) if moe else contextlib.nullcontext()
    LAUNCHES.reset()
    with flash_log:
        flash = [engine.submit(p, max_new=m) for p, m in requests]
        snap = None
        while any(not r.done for r in flash):
            engine.step()
            if snap is None and engine.active[: len(requests)].all():
                snap = decode_snapshot(engine)
    counts, got_cores = LAUNCHES.counts(), LAUNCHES.cores()
    for name, core in cores.items():
        check(counts[name] > 0 and got_cores[f"{name}.{core}"] == counts[name],
              f"{what} f32 gate: {name} launches {counts[name]}, {core} {got_cores[f'{name}.{core}']}")
    check(snap is not None, f"{what} f32 gate: the engine never ran every request at once")
    nt, pos, act, pt, pools = snap
    outs = {}
    for impl in ("flash", "xla"):
        cache = {"blocks": {k: v.clone() for k, v in pools.items()}}
        outs[impl], _ = decode_step_paged(params32, nt[:, None], cache, pos, pt, cfg32, write_mask=act,
                                          attn_impl=impl)
    step_err = float((outs["flash"] - outs["xla"]).abs().max())
    check(bool(torch.allclose(outs["flash"], outs["xla"], rtol=STEP_TOL, atol=STEP_TOL)),
          f"{what} decode_step_paged flash vs xla: max err {step_err}")
    del engine, snap, pools, outs
    free_cuda()
    dense = ServeEngine(cfg32, params32, num_slots=SERVE_SLOTS, max_len=max_len, paged=False)
    dense_log = EngineRouterLog(dense) if moe else contextlib.nullcontext()
    margins, restore = margins_of_dense_engine(dense)
    try:
        with dense_log:
            ref = [dense.submit(p, max_new=m) for p, m in requests]
            dense.run_until_done()
    finally:
        restore()
    routing = router_flips(flash_log, dense_log) if moe else None
    compared = diverged = routed = 0
    for f, d in zip(flash, ref):
        check(len(f.out) == len(d.out) == f.max_new, f"{what} gate rid {f.rid}: lengths")
        differ = [i for i, (a, b) in enumerate(zip(f.out, d.out)) if a != b]
        compared += differ[0] + 1 if differ else len(d.out)
        if not differ:
            continue
        i = differ[0]
        if margins[(d.rid, i)] <= GATE_BAND:
            diverged += 1
            continue
        # the token at index i is sampled from the step at position len(prompt) - 1 + i
        behind = routing is not None and any(rid == d.rid and p <= len(d.prompt) - 1 + i
                                             for rid, p, _layer in routing["flips"])
        check(behind, f"{what} gate rid {f.rid}: token {i} differs outside the band (margin {margins[(d.rid, i)]})"
              + ("" if routing is None else ", behind no routing difference"))
        routed += 1
    del dense
    free_cuda()
    out = {"requests": len(requests), "tokens_compared": compared, "diverged_in_band": diverged,
           "band": GATE_BAND, "decode_step_paged_flash_vs_xla_max_abs_err": step_err, "step_tol": STEP_TOL,
           "launches": {k: counts[k] for k in cores},
           "cores": {f"{k}.{c}": got_cores[f"{k}.{c}"] for k, c in cores.items()}}
    if routing is not None:
        flips = routing.pop("flips")
        check(all(g <= ROUTER_GATE_BAND for g in flips.values()),
              f"{what} gate: routing differs outside the router band {ROUTER_GATE_BAND} ({flips})")
        out["router"] = {**routing, "band": ROUTER_GATE_BAND, "flips": len(flips),
                         "flip_gaps": sorted(flips.values()), "diverged_behind_a_flip": routed}
    return out


def mla_gate(seed: int, device, requests) -> dict:
    """The f32 gate at 1 layer (:func:`engine_gate`): the flash engine's
    launches all on the latent core, the dense engine's ``mla_decode``."""
    import torch
    from repro_torch.models import init_params

    cfg32 = _mla_cfg(MLA_GATE_LAYERS, "float32")
    params32 = init_params(seed + 1, cfg32, device=device)
    out = engine_gate(cfg32, params32, requests, "deepseek",
                      {"sfc_flash_decode": "latent", "sfc_flash_prefill": "latent"})
    del params32
    torch.cuda.empty_cache()
    return {"layers": MLA_GATE_LAYERS, **out}


def time_latent(rng, device, errs, launches) -> list:
    """Rows 21 and 22 on the latent core at MLA's full shapes (bf16 pool;
    the f32 pool beside it): CUDA-event ms, the bound (FP32 operations: 4
    g D per live (query, kv row) pair; bytes: q, the live pool rows, the
    page-table entries and the output once), the plain version's ms, and a
    page gather + SDPA in f32 as the library call.  With one kv head the
    g query heads fold into SDPA's query axis (decode: g rows, prefill: T
    g rows, each with its token's causal limit in an additive mask), so
    SDPA reads the gathered pool once, as the kernel does; its largest
    difference from the kernel on the live rows is reported beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch

    scale = 1.0 / float(np.sqrt(MLA_QK_WIDTH))
    rows = []
    for prefill in (False, True):
        inp = latent_inputs(rng, device, torch.bfloat16, prefill=prefill)
        pt, pos, q, pool, n_new = inp
        prog = latent_programs(device, inp, scale)
        args = (pt, pos, q, pool, pool)
        B, MP = pt.shape
        ps, D = pool.shape[1], pool.shape[-1]
        g = q.shape[-2]
        S = MP * ps
        if prefill:
            T = q.shape[1]
            positions = pos.long()[:, None] + torch.arange(T, device=device)[None]
            need = torch.arange(T, device=device)[None] < torch.as_tensor(n_new, device=device)[:, None]
            pairs = float(((positions + 1) * need).sum())
            nn_ = torch.as_tensor(n_new, device=device).long()
            ends = (pos.long() + nn_)[nn_ > 0]
            kv_rows, pages = int(ends.sum()), int(((ends - 1) // ps + 1).sum())
            nbytes = 2 * 4 * int(need.sum()) * g * D + 2 * kv_rows * D + 4 * (pages + 2 * B)
            limit = positions[:, :, None, None].expand(B, T, g, 1).reshape(B, 1, T * g, 1)
            live = need[:, :, None].expand(B, T, g).reshape(B, T * g)
        else:
            pairs = float((pos.long() + 1).sum())
            pages = int((pos.long() // ps + 1).sum())
            nbytes = 2 * 4 * B * g * D + 2 * int(pairs) * D + 4 * (pages + B)
            limit = pos.long()[:, None, None, None]
            live = torch.ones((B, g), dtype=torch.bool, device=device)
        # query row (token, head) of slot b as SDPA's row t g + head of its one head
        qq = q.reshape(B, 1, -1, D)
        mask = torch.zeros((B, 1, qq.shape[2], S), device=device).masked_fill_(
            torch.arange(S, device=device) > limit, float("-inf"))
        del limit

        def library(qq=qq, mask=mask):
            kk = pool[pt.long()].reshape(B, 1, S, D).float()
            return F.scaled_dot_product_attention(qq, kk, kk, attn_mask=mask, scale=scale)

        lib_err = float((library().reshape(B, -1, D) - launch(prog, *args).reshape(B, -1, D))[live].abs().max())

        b_ms, b_by = bound_ms(4.0 * g * D * pairs, FP32_PEAK, nbytes)
        pool32 = pool.float()
        name = prog.name
        row = {
            "name": f"{name}.latent", "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[f"{name}.latent"], "max_abs_err": errs[(name, "bfloat16")],
            "ms": cuda_ms(lambda: launch(prog, *args), 5),
            "plain_ms": cuda_ms(lambda: prog.plain(prog, *args), 1, warmup=0),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library, 3),
            "library": "page gather + scaled_dot_product_attention f32, the g heads folded into the query axis",
            "library_max_abs_err": lib_err,
            "peak": "FP32 pipes (67 TFLOP/s), HBM 3.35 TB/s", "core": "latent",
            "f32_pool": {"ms": cuda_ms(lambda: launch(prog, pt, pos, q, pool32, pool32), 5),
                         "max_abs_err": errs[(name, "float32")]},
            "shape": {"B": B, "Hkv": 1, "g": g, "D": D, "page_size": ps, "max_pages": MP,
                      ("pos0" if prefill else "pos"): pos.tolist(),
                      **({"Tq": q.shape[1], "n_new": [int(n) for n in n_new]} if prefill else {})},
            "ctas": int(np.prod(prog.grid)),
        }
        if not prefill:
            row.update(decode_device_time(prog, args, library, device))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"time {name} latent: {json.dumps(row)}")
        del inp, args, q, pool, pool32, prog, qq, mask, live
        torch.cuda.empty_cache()
    return rows


def decode_device_time(prog, args, library, device) -> dict:
    """Row 21 latent beside its event-timed call: the device time of the
    split and merge kernels a call launches (each launched once a call:
    the mean over the launches the profiler recorded, with their count)
    and of the library call's kernels (torch.profiler; a call's host side
    is about half its event time), and the split grid as the wrapper
    launched it (``prog.launched``) with its live CTAs (splits that reach
    a slot's last live page, by pos) and the waves they take at the
    kernel's CTAs an SM."""
    import torch
    from repro_torch.kernels import launch
    from repro_torch.kernels import attention as katt

    stats = kernel_stats(lambda: launch(prog, *args), 10, need=("decode_kernel", "merge_kernel"))
    kern = {k: total / count for k, (total, count) in stats.items()}
    dev_ms = sum(kern.values())
    check(dev_ms > 0 and any("decode_kernel" in k for k in kern) and any("merge_kernel" in k for k in kern),
          f"sfc_flash_decode latent: no device time of its split and merge kernels read ({kern})")
    lib = kernel_ms(library, 10)
    live = katt.decode_live_ctas(prog, args[1], args[3].shape[1])
    per_sm = katt.latent_kernel_info()["sfc_flash_decode.latent"]["ctas_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"device_ms": dev_ms, "kernels_ms": kern,
            "profiled_launches": {k: count for k, (_, count) in stats.items()},
            "library_device_ms": sum(lib.values()),
            "grid": list(prog.launched["grid"]), "live_ctas": live, "ctas_per_sm": per_sm, "sms": sms,
            "waves": live / (sms * per_sm)}


def serve_counted(cfg, params, requests, what: str, cores: dict):
    """The paged flash engine (:func:`serve_engine`) serves ``requests``
    with the launch counts reset and its decode ticks counted: every
    output full and in the vocabulary, prefix sharing engaged, and every
    sfc_flash_prefill / sfc_flash_decode launch on its core (``cores``:
    {entry point: core}), layers x the admissions that ran the model and
    layers x the decode ticks of them.  Returns the metrics (the bytes of
    the engine's page pools among them)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serve import engine as engine_mod

    ticks = {"decode": 0}
    inner = engine_mod._masked_step_paged

    def counted(*a, **k):
        ticks["decode"] += 1
        return inner(*a, **k)

    engine = serve_engine(cfg, params)
    engine_mod._masked_step_paged = counted
    LAUNCHES.reset()
    try:
        reqs, metrics = drive_engine(engine, requests)
    finally:
        engine_mod._masked_step_paged = inner
    counts, got = LAUNCHES.counts(), LAUNCHES.cores()
    for r in reqs:
        check(len(r.out) == r.max_new and all(0 <= t < cfg.vocab_size for t in r.out), f"{what} rid {r.rid}: output")
    check(metrics["pages_shared"] > 0, f"{what}: prefix sharing never engaged")
    L = cfg.num_layers
    want = {"sfc_flash_prefill": L * metrics["launching_admissions"], "sfc_flash_decode": L * ticks["decode"]}
    for name, n in want.items():
        core = cores[name]
        check(counts[name] == got[f"{name}.{core}"] == n,
              f"{what} serving: {name} launches {counts[name]}, {core} {got[f'{name}.{core}']}, expected {n}")
    metrics["decode_ticks"] = ticks["decode"]
    metrics["launches"] = {k: counts[k] for k in want}
    metrics["cores"] = {k: v for k, v in got.items() if k.split(".")[0] in want}
    metrics["layers"] = L
    metrics["pool_bytes"] = cache_bytes(engine.cache)["blocks"]
    return metrics


def mla_serving_path(rng, device, seed: int) -> list:
    """(a) rows 21 and 22 on the latent core against their plain versions;
    (b) DeepSeek-V2 at MLA_LAYERS layers, full width, bf16, seeded random
    weights: the paged flash engine serves MLA_REQUESTS requests, every
    sfc_flash_prefill / sfc_flash_decode launch on the latent core, layers
    x admissions and layers x decode ticks of them; the warm decode tick's
    profile; (c) the f32 gate at MLA_GATE_LAYERS layer; (d) the latent
    rows' timings.  Returns the two kernel rows."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import count_params, init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # TinyLlama's weights are gone (serving_path)
    errs = compare_latent(rng, device)
    cfg = _mla_cfg(MLA_LAYERS, "bfloat16")
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=device)
    torch.cuda.synchronize()
    log(f"serving deepseek model: {cfg.name} {cfg.num_layers} of 60 layers d={cfg.d_model} H={cfg.num_heads} "
        f"q_lora={cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} rope={cfg.qk_rope_head_dim} "
        f"experts={cfg.num_experts} top_k={cfg.top_k} shared={cfg.num_shared_experts} "
        f"d_ff_expert={cfg.d_ff_expert} vocab={cfg.vocab_size} {cfg.dtype}, {count_params(params)} parameters, "
        f"seeded random, {time.perf_counter() - t0:.1f} s to make, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.1f} GiB allocated")
    requests = make_requests(rng, cfg.vocab_size, MLA_REQUESTS, MLA_NEW)
    warm = serve_engine(cfg, params)
    warm.submit(requests[0][0][:80], max_new=2)
    warm.run_until_done()
    del warm
    metrics = serve_counted(cfg, params, requests, "deepseek",
                            {"sfc_flash_decode": "latent", "sfc_flash_prefill": "latent"})
    launches = LAUNCHES.cores()
    log("serving deepseek: " + json.dumps(metrics))
    busy = warm_decode_tick(cfg, params, requests, device)
    del params
    torch.cuda.empty_cache()

    gate = mla_gate(seed, device, make_requests(rng, cfg.vocab_size, MLA_GATE_REQUESTS, MLA_GATE_NEW,
                                                MLA_GATE_PROMPT))
    log("check serving deepseek gate: " + json.dumps(gate))
    rows = time_latent(rng, device, errs, launches)
    log("serving deepseek busy: " + json.dumps(busy))
    log(f"deepseek phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 7c: Mamba2-2.7B and Zamba2-2.7B dense serving (the SSD mixer, its
# recurrence, the hybrid shared attention block on row 20 at D = 80)
# ---------------------------------------------------------------------------

def ssm_requests(rng, vocab: int, n: int, prompt, new):
    """n requests of random prompts (lengths in ``prompt``) with ``new``
    new tokens each; no shared prefix (the dense engine shares no pages)."""
    return [(rng.integers(0, vocab, size=int(rng.integers(prompt[0], prompt[1] + 1))).tolist(),
             int(rng.integers(new[0], new[1] + 1))) for _ in range(n)]


def ssm_engine(cfg, params, slots: int | None = None):
    """The dense engine, the serving route of the recurrent archs: one
    (slots, max_len) cache (SERVE_SLOTS slots by default), chunked prefill
    (one token a step)."""
    from repro_torch.serve import ServeEngine

    return ServeEngine(cfg, params, num_slots=slots or SERVE_SLOTS, max_len=SERVE_MAX_LEN, paged=False,
                       prefill="chunked", stats_capacity=8192)


def d80_inputs(rng, device, dtype):
    """Row 20 at Zamba2's shared-attention shapes: B·H = 2·32 sequences of
    2048 x 80 (MHA, so K and V are not expanded)."""
    import torch

    B, H, S = ATTN_ROW20
    d = _ssm_cfg(SSM_HYBRID, "bfloat16").attn_head_dim

    def t():
        return torch.as_tensor(rng.standard_normal((B * H, S, d), dtype=np.float32), device=device).to(dtype)

    return t(), t(), t()


def d80_program(device, q, causal: bool = True, kv_valid: int | None = None):
    """The program ``ops.attention`` builds for q of :func:`d80_inputs`
    (causal, bq = bkv = 128, the model's 1/sqrt(D)), or of
    :func:`full_d80_inputs` (the full table, ``kv_valid`` the unpadded
    frames)."""
    from repro_torch.kernels import attention as katt

    S, d = q.shape[1], q.shape[2]
    sched = katt.attention_schedule_device(S // 128, S // 128, causal=causal, device=device)
    return katt.flash_attention_program(sched, q, causal=causal, sm_scale=1.0 / float(np.sqrt(d)), bq=128,
                                        bkv=128, kv_valid=kv_valid)


D80_CORES = {"bfloat16": "wgmma", "float32": "tiled"}


def d80_rows_program(device, q):
    """Row 20 at D = 80 on tiles of 64 (causal), the shape at which
    ``flash_rows`` (the "simt" core) keeps Zamba2's width."""
    from repro_torch.kernels import attention as katt

    S, d = q.shape[1], q.shape[2]
    sched = katt.attention_schedule_device(S // 64, S // 64, causal=True, device=device)
    return katt.flash_attention_program(sched, q, causal=True, sm_scale=1.0 / float(np.sqrt(d)), bq=64,
                                        bkv=64, kv_valid=None)


def compare_d80(rng, device) -> dict:
    """(a) row 20 at D = 80 against its plain version, bf16 and f32, each
    launch read from the launch record's cores: bf16 on the tensor-core
    core, f32 on the register-tiled core, by the core rule; then
    ``flash_rows`` (simt) at D = 80 on tiles of 64, the shape that keeps
    it.  Returns the largest errors by dtype (and by ``(dtype, "simt")``)."""
    import torch
    from repro_torch.kernels import attention as katt

    errs, parts = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATTN_TOL[str(dtype)[6:]]
        q, k, v = d80_inputs(rng, device, dtype)
        for key, prog, core in ((dtype, d80_program(device, q), D80_CORES[str(dtype)[6:]]),
                                ((dtype, "simt"), d80_rows_program(device, q), "simt")):
            got, ran = launch_core(prog, (q, k, v))
            p = prog.params
            check(ran == core and katt.flash_core(dtype, q.shape[2], p["bq"], p["bkv"]) == core,
                  f"sfc_flash_attention D={q.shape[2]} bq={p['bq']} {dtype}: launched on {ran}, "
                  f"expected the {core} core")
            want = prog.plain(prog, q, k, v)
            torch.cuda.synchronize()
            errs[key] = attn_err(got, want, tol, f"sfc_flash_attention D={q.shape[2]} bq={p['bq']} {dtype}")
            parts.append(f"{str(dtype)[6:]} bq=bkv={p['bq']} (rtol {tol['rtol']}, atol {tol['atol']}) core "
                         f"{core} max_abs_err={errs[key]:.3e}")
            del got, want
        del q, k, v
    B, H, S = ATTN_ROW20
    log(f"compare flash d80: BH={B * H} S={S} D={_ssm_cfg(SSM_HYBRID, 'bfloat16').attn_head_dim} causal: "
        + "; ".join(parts))
    return errs


def _ssm_cfg(arch: str, dtype: str, **overrides):
    import dataclasses as dc

    from repro_torch.configs import get_config

    return dc.replace(get_config(arch), dtype=dtype, **overrides)


def cache_bytes(cache) -> dict:
    """Bytes of each group of a dense cache."""
    return {g: sum(leaf.numel() * leaf.element_size() for leaf in leaves.values()) for g, leaves in cache.items()}


def merge_ms(engine) -> float:
    """CUDA-event ms of the dense engine's where-merge alone (every cache
    leaf cloned, then merged back under a slot mask), as ``_masked_step``
    runs it each step, on the engine's cache."""
    import torch
    from repro_torch.serve import engine as engine_mod

    leaves = engine_mod._leaves(engine.cache)
    mask = torch.ones(engine.num_slots, dtype=torch.bool, device=engine.device)

    def merge():
        old = [leaf.clone() for leaf in leaves]
        for leaf, before in zip(leaves, old):
            leaf.copy_(torch.where(mask.reshape((1, -1) + (1,) * (leaf.dim() - 2)), leaf, before))

    return cuda_ms(merge, 5)


def ssm_serve(arch: str, rng, device, seed: int):
    """(b) / (c): one arch at full width and depth in bf16 on the dense
    engine: SSM_REQUESTS requests, the serving metrics, the cache's bytes,
    the where-merge's ms and a warm decode tick's profile.  Returns (the
    tick's profile, the params)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import count_params, init_params

    cfg = _ssm_cfg(arch, "bfloat16")
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=device)
    torch.cuda.synchronize()
    log(f"serving {cfg.name} model: {cfg.num_layers} layers d={cfg.d_model} d_inner={cfg.d_inner} "
        f"ssm heads={cfg.ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state} chunk={cfg.ssm_chunk}"
        + (f" shared attention every {cfg.hybrid_attn_every} (H={cfg.num_heads} Hkv={cfg.num_kv_heads} "
           f"D={cfg.attn_head_dim} d_ff={cfg.d_ff})" if cfg.hybrid_attn_every else "")
        + f" vocab={cfg.vocab_size} {cfg.dtype}, {count_params(params)} parameters, seeded random, "
        f"{time.perf_counter() - t0:.1f} s to make, {torch.cuda.memory_allocated(device) / 2**30:.1f} GiB allocated")
    requests = ssm_requests(rng, cfg.vocab_size, SSM_REQUESTS, SSM_PROMPT, SSM_NEW)
    warm = ssm_engine(cfg, params)
    warm.submit(requests[0][0][:16], max_new=2)
    warm.run_until_done()
    del warm
    engine = ssm_engine(cfg, params)
    LAUNCHES.reset()
    reqs, metrics = drive_engine(engine, requests)
    counts = LAUNCHES.counts()
    for r in reqs:
        check(len(r.out) == r.max_new and all(0 <= t < cfg.vocab_size for t in r.out), f"{arch} rid {r.rid}: output")
    metrics["cache_bytes"] = cache_bytes(engine.cache)
    metrics["where_merge_ms"] = merge_ms(engine)
    metrics["launches"] = {k: v for k, v in counts.items() if v}
    metrics["layers"] = cfg.num_layers
    del engine
    log(f"serving {arch.split('-')[0]}: " + json.dumps(metrics))
    # a tick's cost does not depend on the prompts (a recurrent state; the
    # shared K/V attended over max_len under a mask): short ones admit fast
    busy = warm_decode_tick(cfg, params, [(p[:SSM_WARM_PROMPT], m) for p, m in requests], device,
                            make_engine=ssm_engine)
    return busy, params


def row20_launches(cfg) -> int:
    """Row 20 launches of one forward: one a layer, or one a shared-block
    application of the hybrid pattern."""
    return -(-cfg.num_layers // cfg.hybrid_attn_every) if cfg.hybrid_attn_every else cfg.num_layers


def forward_bf16(params, cfg, rng, what: str) -> dict:
    """The bf16 forward of 2 x 2048 tokens with use_hilbert_kernels, its
    row 20 launches counted apart (all on the tensor-core core: one a
    layer, or a shared application), its logits against the plain
    forward's; the wall time, cold and warm."""
    import dataclasses as dc

    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import forward

    cfg_hk = dc.replace(cfg, use_hilbert_kernels=True)
    napp = row20_launches(cfg)
    toks = rng.integers(0, cfg.vocab_size, size=(ATTN_ROW20[0], ATTN_ROW20[2])).astype(np.int32)
    LAUNCHES.reset()
    t = time.perf_counter()
    lk, _ = forward(params, {"tokens": toks}, cfg_hk)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    n, cores = LAUNCHES.counts()["sfc_flash_attention"], LAUNCHES.cores()
    check(n == napp == cores["sfc_flash_attention.wgmma"],
          f"{what} forward: sfc_flash_attention launches {n}, cores {cores}, expected {napp} on wgmma")
    check(lk.shape == (ATTN_ROW20[0], ATTN_ROW20[2], cfg.vocab_size) and bool(torch.isfinite(lk).all()),
          f"{what} forward(use_hilbert_kernels): shape or non-finite")
    # in bf16 the two attention forms round apart (on the CPU, with the
    # plain versions on both sides, reduced Zamba2's logits already differ
    # by ~1e-2), so the bf16 forward is reported; the f32 gate holds it
    lp, _ = forward(params, {"tokens": toks}, cfg)
    out = {"tokens": int(toks.size), "wall_ms": wall, "sfc_flash_attention_launches": n,
           "wgmma": cores["sfc_flash_attention.wgmma"], "max_abs_diff": float((lk - lp).abs().max()),
           "argmax_agreement": float((lk.argmax(-1) == lp.argmax(-1)).float().mean())}
    del lk, lp
    warm = []
    for _ in range(3):
        t = time.perf_counter()
        forward(params, {"tokens": toks}, cfg_hk)
        torch.cuda.synchronize()
        warm.append(1e3 * (time.perf_counter() - t))
    out["warm_ms"] = statistics.median(warm)
    log(f"forward {what} {ATTN_ROW20[0]}x{ATTN_ROW20[2]} bf16 use_hilbert_kernels: " + json.dumps(out))
    return out


def forward_against_plain(params32, cfg32, rng, device) -> dict:
    """The f32 forward of 1 x 2048 tokens with use_hilbert_kernels (row 20
    at the model's head width, its launches all on tiled) against the plain
    forward: logits allclose at STEP_TOL, argmax equal where the top-2
    margin exceeds 2 (atol + rtol |top|).  For a MoE model both forwards'
    routing is logged: where a token's top-k experts differ (a flip, which
    must be a near-tie: the k-th and (k+1)-th routing probabilities within
    ROUTER_GATE_BAND in both, unless an earlier flip explains it: one at
    the same or an earlier token and a lower layer), that token and the
    later ones (causal attention carries the flip forward) are left out of
    the comparison."""
    import contextlib
    import dataclasses as dc

    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import forward

    toks = rng.integers(0, cfg32.vocab_size, size=(1, ATTN_ROW20[2])).astype(np.int32)
    cfg_hk = dc.replace(cfg32, use_hilbert_kernels=True)
    napp = row20_launches(cfg32)
    moe = cfg32.block_kind == "moe"
    logs = [RouterLog(lambda b, t: (t,)) if moe else contextlib.nullcontext() for _ in range(2)]
    LAUNCHES.reset()
    t = time.perf_counter()
    with logs[0]:
        lk, _ = forward(params32, {"tokens": toks}, cfg_hk)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    n, cores = LAUNCHES.counts()["sfc_flash_attention"], LAUNCHES.cores()
    check(n == napp == cores["sfc_flash_attention.tiled"],
          f"{cfg32.name} f32 forward: sfc_flash_attention launches {n}, cores {cores}, expected {napp} on tiled")
    with logs[1]:
        lp, _ = forward(params32, {"tokens": toks}, cfg32)
    check(bool(torch.isfinite(lk).all()) and lk.shape == lp.shape, f"{cfg32.name} f32 forward: non-finite or shape")
    out = {"tokens": int(toks.size), "wall_ms": wall, "sfc_flash_attention_launches": n,
           "tiled": cores["sfc_flash_attention.tiled"], "step_tol": STEP_TOL}
    if moe:
        routing = router_flips(*logs)
        flips = routing.pop("flips")
        # a flip at (token t, layer l) changes token t from layer l on and,
        # through attention, every later token from layer l + 1 on: a flip
        # there follows from it, and only the others must be near-ties
        roots = {key: gap for key, gap in flips.items()
                 if not any(t <= key[0] and layer < key[1] for t, layer in flips)}
        check(all(g <= ROUTER_GATE_BAND for g in roots.values()),
              f"{cfg32.name} f32 forward: routing differs outside the router band {ROUTER_GATE_BAND} where no "
              f"earlier flip explains it ({roots}; all flips {flips})")
        first = min((key[0] for key in flips), default=lk.shape[1])
        out["router"] = {**routing, "band": ROUTER_GATE_BAND, "flips": len(flips), "flip_gaps": sorted(flips.values()),
                         "root_flips": len(roots), "first_flipped_token": first if flips else None}
        check(first > 0, f"{cfg32.name} f32 forward: the routing flips at the first token")
        lk, lp = lk[:, :first], lp[:, :first]
    return {**out, **logits_against_plain(lk, lp, f"{cfg32.name} f32 forward")}


def logits_against_plain(lk, lp, what: str) -> dict:
    """The kernel path's f32 logits ``lk`` against the plain path's ``lp``:
    allclose at STEP_TOL, argmax equal where the top-2 margin exceeds 2
    (atol + rtol |top|)."""
    import torch

    err = float((lk - lp).abs().max())
    check(bool(torch.allclose(lk, lp, rtol=STEP_TOL, atol=STEP_TOL)), f"{what} kernel vs plain: {err}")
    top2 = lp.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * STEP_TOL * (1 + top2[..., 0].abs())
    same = lk.argmax(-1) == lp.argmax(-1)
    check(bool(same[clear].all()), f"{what}: argmax differs at {int((~same & clear).sum())} "
                                   f"positions outside the margin band")
    return {"max_abs_err": err, "argmax_clear_share": float(clear.float().mean()),
            "argmax_agreement": float(same.float().mean())}


def ssm_gate(arch: str, rng, device, seed: int) -> dict:
    """(d): the arch in f32 at full depth, SSM_GATE_REQUESTS requests on the
    dense engine; every served token against the argmax of the f32 forward
    replay (Zamba2's with use_hilbert_kernels: row 20 at D = 80 in f32,
    its launches counted) outside GATE_BAND, and each decode step's logits
    against the forward's at the same position: the recurrence against the
    chunked SSD form."""
    import dataclasses as dc

    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import init_params

    cfg32 = _ssm_cfg(arch, "float32")
    params32 = init_params(seed + 1, cfg32, device=device)
    requests = ssm_requests(rng, cfg32.vocab_size, SSM_GATE_REQUESTS, SSM_GATE_PROMPT, SSM_GATE_NEW)
    engine = ssm_engine(cfg32, params32, slots=SSM_GATE_REQUESTS)
    logits, restore = served_steps(engine, lambda lg: lg.clone())
    try:
        reqs = [engine.submit(p, max_new=m) for p, m in requests]
        engine.run_until_done()
    finally:
        restore()
    for r in reqs:
        check(len(r.out) == r.max_new, f"{arch} f32 gate rid {r.rid}: output length")
    replay_cfg = dc.replace(cfg32, use_hilbert_kernels=bool(cfg32.hybrid_attn_every))
    LAUNCHES.reset()
    gate = replay_gate(replay_cfg, params32, reqs, step_logits=logits, band=SSM_GATE_BAND)
    n, cores = LAUNCHES.counts()["sfc_flash_attention"], LAUNCHES.cores()
    if cfg32.hybrid_attn_every:
        napp = row20_launches(cfg32)
        check(n == napp * len(reqs) == cores["sfc_flash_attention.tiled"],
              f"{arch} f32 gate replay: sfc_flash_attention launches {n}, cores {cores}, expected "
              f"{napp * len(reqs)} on tiled")
    gate.update(layers=cfg32.num_layers, requests=len(reqs),
                replay_use_hilbert_kernels=replay_cfg.use_hilbert_kernels,
                sfc_flash_attention_launches=n, tiled=cores["sfc_flash_attention.tiled"])
    if cfg32.hybrid_attn_every:
        gate["forward_f32"] = forward_against_plain(params32, cfg32, rng, device)
    log(f"check serving {arch.split('-')[0]} gate: " + json.dumps(gate))
    del engine, params32, logits
    torch.cuda.empty_cache()
    return gate


def time_d80(rng, device, errs, launches: int) -> dict:
    """(e) row 20 at D = 80 (bf16; f32 beside it): CUDA-event ms, the bound
    (causal pairs x 4 D operations; q, k, v read and o written once), the
    plain version and ``scaled_dot_product_attention(is_causal=True)``; the
    core from the launch record, and ``flash_rows`` at D = 80 (tiles of
    64) on the same inputs as the "was" time."""
    import torch
    from repro_torch.kernels import launch

    B, H, S = ATTN_ROW20
    timed = {}
    for dtype, peak in ((torch.bfloat16, BF16_PEAK), (torch.float32, FP32_PEAK)):
        q, k, v = d80_inputs(rng, device, dtype)
        prog = d80_program(device, q)
        rows = d80_rows_program(device, q)
        d = q.shape[2]
        ops_, nbytes, library = attention_work((q, k, v), ATTN_ROW20)
        b_ms, b_by = bound_ms(ops_, peak, nbytes)
        _, core = launch_core(prog, (q, k, v))
        timed[dtype] = {
            "ms": cuda_ms(lambda: launch(prog, q, k, v), 10),
            "flash_rows_ms": cuda_ms(lambda: launch(rows, q, k, v), 3),
            "plain_ms": cuda_ms(lambda: prog.plain(prog, q, k, v), 1, warmup=0),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library, 10),
            "max_abs_err": errs[dtype], "core": core,
            "ctas": int(np.prod(prog.grid)), "flash_rows_max_abs_err": errs[(dtype, "simt")],
        }
        del q, k, v, library
    row = {"name": "sfc_flash_attention.d80", "route": "cuda", "source": SOURCES["sfc_flash_attention"],
           "replaces": REPLACES["sfc_flash_attention"], "launches": launches, **timed[torch.bfloat16],
           "peak": "bf16 tensor cores (989 TFLOP/s), HBM 3.35 TB/s; f32: FP32 pipes (67 TFLOP/s)",
           "shape": {"BH": B * H, "S": S, "D": d, "bq": 128, "bkv": 128, "causal": True},
           "flash_rows_shape": {"bq": 64, "bkv": 64},
           "f32": timed[torch.float32]}
    log(f"time sfc_flash_attention d80: {json.dumps(row)}")
    return row


def ssm_serving_path(rng, device, seed: int) -> list:
    """Phase 7c, after DeepSeek's weights are freed: (a) row 20 at D = 80
    against its plain version; (b) Mamba2-2.7B and (c) Zamba2-2.7B at full
    width and depth in bf16 on the dense engine, and Zamba2's forward with
    use_hilbert_kernels (its 9 row 20 launches); (d) both in f32 against
    their forward replay; (e) row 20 at D = 80 timed.  Returns its kernel
    row."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    errs = compare_d80(rng, device)
    busy = {}
    fwd = None
    for arch in SSM_ARCHS:
        busy[arch], params = ssm_serve(arch, rng, device, seed)
        if arch == SSM_HYBRID:
            fwd = forward_bf16(params, _ssm_cfg(arch, "bfloat16"), rng, "zamba2")
        del params
        torch.cuda.empty_cache()
    for arch in SSM_ARCHS:
        ssm_gate(arch, rng, device, seed)
    row = time_d80(rng, device, errs, fwd["sfc_flash_attention_launches"])
    log("serving ssm busy: " + json.dumps(busy))
    log(f"ssm phase: {time.perf_counter() - t_phase:.1f} s")
    return [row]


# ---------------------------------------------------------------------------
# phase 7d: OLMoE-1B-7B paged serving at full size (MoE at full depth; rows
# 20-22 at MHA's g = 1 and D = 128)
# ---------------------------------------------------------------------------

def _olmoe_cfg(dtype: str):
    import dataclasses as dc

    from repro_torch.configs import get_config

    return dc.replace(get_config(OLMOE_ARCH), dtype=dtype)


def cohort_cores(cfg, dtype) -> dict:
    """The core each row runs at ``cfg``'s shapes, by the wrappers' rules:
    decode on the split-KV core, prefill on the core ``prefill_core``
    names (a q tile of ps g rows within a CTA's 128: ``"wgmma"`` in bf16,
    ``"tiled"`` in f32, never ``"simt"``; OLMoE's 128 tokens a CTA,
    Qwen's 25), row 20 on ``flash_core``'s."""
    import torch
    from repro_torch.kernels import attention as katt

    d, g = cfg.attn_head_dim, cfg.num_heads // cfg.num_kv_heads
    pre = katt.prefill_core(dtype, d, d, SERVE_PAGE, g)
    check(pre == ("wgmma" if dtype == torch.bfloat16 else "tiled"),
          f"sfc_flash_prefill at {cfg.name}'s shapes, {dtype}: the rule names {pre}")
    return {"sfc_flash_decode": "split", "sfc_flash_prefill": pre,
            "sfc_flash_attention": katt.flash_core(dtype, d, 128, 128)}


def launch_core(prog, args):
    """Launch ``prog`` once; (its output, the one core the launch record
    counted)."""
    from repro_torch.kernels import LAUNCHES, launch

    before = LAUNCHES.cores()
    out = launch(prog, *args)
    after = LAUNCHES.cores()
    ran = [c for c in after if after[c] != before[c]]
    check(len(ran) == 1 and after[ran[0]] == before[ran[0]] + 1, f"{prog.name}: launch record {ran}")
    return out, ran[0].split(".", 1)[1]


def mha_inputs(rng, device, dtype, inactive=()):
    """Rows 21, 22 and 20 at OLMoE's shapes and their programs: decode over
    8 slots of 128 pages of 16 (Hkv 16, g 1, D 128; ``inactive`` slots at
    pos -1), the prefill cohort of :func:`prefill_inputs` with garbage in
    the trash page, row 20 over 2 x 16 sequences of 2048 (causal)."""
    cfg = _olmoe_cfg("float32")
    dec = decode_inputs(rng, device, dtype, cfg, inactive=inactive)
    pre = prefill_inputs(rng, device, dtype, cfg, trash=True)
    att = attention_inputs(rng, device, dtype, cfg, MHA_ROW20)[:3]
    return (dec, pre, att), flash_programs(device, dec, pre, att)


def compare_cohort(rng, device, inputs, cfg, tag: str) -> tuple[dict, dict]:
    """(a) rows 21 and 22 at ``cfg``'s serving shapes (``inputs``: a slot
    at pos -1 among the ragged positions, garbage in the trash page) and
    row 20 where ``inputs`` gives it, against their plain versions, bf16
    and f32, each launch's core read from the launch record and held to
    :func:`cohort_cores`.  Returns the largest errors and the cores, by
    (entry point, dtype)."""
    import torch

    errs, cores, parts = {}, {}, []
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATTN_TOL[str(dtype)[6:]]
        want_cores = cohort_cores(cfg, dtype)
        (dec, pre, att), progs = inputs(rng, device, dtype, inactive=(2,))
        rows = prefill_covered(pre[5], pre[2].shape[1], SERVE_PAGE, device)
        for prog, args, sel in zip(progs, (dec, pre[:5], att), (None, rows, None)):
            if prog is None:
                continue
            name = prog.name
            got, core = launch_core(prog, args)
            check(core == want_cores[name], f"{name} {tag} {dtype}: launched on {core}, expected {want_cores[name]}")
            want = prog.plain(prog, *args)
            torch.cuda.synchronize()
            if sel is not None:
                got, want = got[sel], want[sel]
            errs[(name, dtype)] = attn_err(got, want, tol, f"{name} {tag} {str(dtype)[6:]}")
            cores[(name, dtype)] = core
            del got, want
        B, hkv, g, d = dec[2].shape
        part = (f"{str(dtype)[6:]} (rtol {tol['rtol']}, atol {tol['atol']}): decode B={B} Hkv={hkv} g={g} D={d} "
                f"ps={SERVE_PAGE} MP={dec[0].shape[1]} pos={dec[1].tolist()} core "
                f"{cores[('sfc_flash_decode', dtype)]} max_abs_err={errs[('sfc_flash_decode', dtype)]:.3e}; prefill "
                f"Tq={pre[2].shape[1]} n_new={pre[5].tolist()} core {cores[('sfc_flash_prefill', dtype)]} "
                f"tokens a CTA {progs[1].launched['tokens']} max_abs_err={errs[('sfc_flash_prefill', dtype)]:.3e}")
        if att is not None:
            part += (f"; attention BH={att[0].shape[0]} S={att[0].shape[1]} D={att[0].shape[2]} causal core "
                     f"{cores[('sfc_flash_attention', dtype)]} "
                     f"max_abs_err={errs[('sfc_flash_attention', dtype)]:.3e}")
        parts.append(part)
        del dec, pre, att, progs
    log(f"compare flash {tag}: " + "; ".join(parts))
    return errs, cores


def compare_mha(rng, device) -> tuple[dict, dict]:
    """:func:`compare_cohort` at OLMoE's shapes (rows 21, 22 and 20 at D =
    128)."""
    return compare_cohort(rng, device, mha_inputs, _olmoe_cfg("float32"), "mha")


def olmoe_gate(rng, device, seed: int) -> dict:
    """(c) the f32 gate at OLMOE_GATE_LAYERS layers: :func:`engine_gate`
    over OLMOE_GATE_REQUESTS requests (the flash engine's decode on split,
    prefill on ``prefill_core``'s core; the dense engine's ``gqa_decode``
    on ``_sdpa``), then the f32 forward of 1 x 2048 tokens through row 20
    (a launch a layer, on tiled) against the plain forward, both with the
    routing compared (ROUTER_GATE_BAND)."""
    import torch
    from repro_torch.models import init_params

    cfg32 = dataclasses.replace(_olmoe_cfg("float32"), num_layers=OLMOE_GATE_LAYERS)
    params32 = init_params(seed + 1, cfg32, device=device)
    requests = make_requests(rng, cfg32.vocab_size, OLMOE_GATE_REQUESTS, OLMOE_GATE_NEW, OLMOE_GATE_PROMPT,
                             GATE_PREFIX)
    cores = cohort_cores(cfg32, torch.float32)
    gate = engine_gate(cfg32, params32, requests, "olmoe",
                       {k: cores[k] for k in ("sfc_flash_decode", "sfc_flash_prefill")})
    gate["forward_f32"] = forward_against_plain(params32, cfg32, rng, device)
    gate.update(layers=cfg32.num_layers, experts=cfg32.num_experts, top_k=cfg32.top_k,
                weight_bytes=sum(p.numel() * p.element_size() for p in params32.parameters()))
    log("check serving olmoe gate: " + json.dumps(gate))
    del params32
    torch.cuda.empty_cache()
    return gate


def flash_rows_prefill(prog, args, n_new):
    """Row 22's SIMT core (``flash_rows``, one q tile of ps g rows a CTA)
    on the cohort of a program the rule sends to a CTA core: the C entry
    called with the simt core's code over the schedule's per-tile runs
    (longest first), as those shapes were launched before; the "was" time
    of :func:`time_cohort`.  Returns a function that launches it (counted
    on ``sfc_flash_prefill.simt``) and returns its output; its ``ctas`` is
    the launch's CTA count."""
    import torch
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels._build import call, stream_of

    pt, pos0, q, kp, vp = args
    B, Tq, hkv, g, dk = q.shape
    P, ps = kp.shape[:2]
    dv, MP = vp.shape[-1], pt.shape[1]
    sched = katt.prefill_page_schedule_device(pos0.cpu().numpy(), n_new, ps, MP, device=q.device)
    check(prog.params["ctas"] and prog.schedule is katt.prefill_cta_schedule_device(sched, prog.params["tokens"]).table,
          "flash_rows_prefill: another cohort than the program's")
    runs = sched.runs

    def run():
        o = torch.empty((B, Tq, hkv, g, dv), dtype=q.dtype, device=q.device)
        call("sfc_flash_prefill", q.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(), sched.table.data_ptr(),
             runs.data_ptr(), int(runs.shape[0]), ps, hkv, pt.data_ptr(), pos0.data_ptr(), Tq, g, dk, dv, ps, MP, B,
             P, prog.params["sm_scale"], 0 if q.dtype == torch.float32 else 1, katt.PREFILL_CORE_CODE["simt"],
             stream_of(q), core="simt")
        return o

    run.ctas = int(runs.shape[0]) * hkv
    return run


def time_cohort(rng, device, errs, launches: dict, inputs, cfg, tags: dict, att_shape=None) -> list:
    """(d) rows 21 and 22 at ``inputs``' shapes (every slot live) and row
    20 where ``inputs`` gives it, bf16 with f32 beside each: CUDA-event ms
    (row 21 also the device time of its kernels, the mean over the
    launches torch.profiler recorded, and of the library call's), the
    bound (operations at the dtype's peak, or bytes: :func:`decode_work`,
    :func:`prefill_work`, :func:`attention_work`), the plain version's ms,
    the library call (page gather + SDPA; SDPA with is_causal for row 20),
    the core, grid and (row 22) tokens and rows a CTA from the launch
    record; row 22 also ``flash_rows_ms``, its SIMT core on the same
    cohort (:func:`flash_rows_prefill`), held to the kernel's covered rows
    at ATTN_TOL.  The kernel rows are named by entry point and ``tags``
    (e.g. ``sfc_flash_prefill.mha``)."""
    import torch
    from repro_torch.kernels import launch

    timed = {}
    for dtype, peak in ((torch.bfloat16, BF16_PEAK), (torch.float32, FP32_PEAK)):
        (dec, pre, att), progs = inputs(rng, device, dtype)
        work = (decode_work(dec), prefill_work(pre), None if att is None else attention_work(att, att_shape))
        for prog, args, w in zip(progs, (dec, pre[:5], att), work):
            if prog is None:
                continue
            ops_, nbytes, library = w
            out, core = launch_core(prog, args)
            b_ms, b_by = bound_ms(ops_, peak, nbytes)
            t = {"ms": cuda_ms(lambda: launch(prog, *args), 10),
                 "plain_ms": cuda_ms(lambda: prog.plain(prog, *args), 1, warmup=0),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library, 10),
                 "max_abs_err": errs[(prog.name, dtype)], "core": core,
                 "ctas": int(np.prod(prog.launched.get("grid", prog.grid)))}
            if prog.name == "sfc_flash_decode":
                # split + merge, each once a call: the mean over the launches
                # the profiler recorded (it drops some), with their count
                stats = kernel_stats(lambda: launch(prog, *args), 10, need=("split_kernel", "merge_kernel"))
                kern = {k: total / count for k, (total, count) in stats.items()}
                check(any("split_kernel" in k for k in kern) and any("merge_kernel" in k for k in kern),
                      f"sfc_flash_decode {tags[prog.name]} {dtype}: no device time of its split and merge kernels "
                      f"read ({kern})")
                lib = kernel_ms(library, 10)
                t.update(device_ms=sum(kern.values()), kernels_ms=kern,
                         profiled_launches={k: count for k, (_, count) in stats.items()},
                         library_device_ms=sum(lib.values()), library_kernels_ms=lib, pos=args[1].tolist())
            if prog.name == "sfc_flash_prefill":
                rows_fn = flash_rows_prefill(prog, args, pre[5])
                sel = prefill_covered(pre[5], pre[2].shape[1], SERVE_PAGE, device)
                was = attn_err(rows_fn()[sel], out[sel], ATTN_TOL[str(dtype)[6:]],
                               f"sfc_flash_prefill {tags[prog.name]} {str(dtype)[6:]}: flash_rows vs {core}")
                t.update(n_new=[int(n) for n in pre[5]], pos0=pre[1].tolist(),
                         rows_per_cta=prog.launched["rows_per_cta"], tokens=prog.launched["tokens"],
                         flash_rows_ms=cuda_ms(rows_fn, 3), flash_rows_ctas=rows_fn.ctas,
                         flash_rows_max_abs_diff=was)
            del out
            t["bound_share"] = b_ms / t["ms"]
            timed[(prog.name, dtype)] = t
        del dec, pre, att, progs, work
        torch.cuda.empty_cache()
    hkv, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim
    shapes = {"sfc_flash_decode": {"B": SERVE_SLOTS, "Hkv": hkv, "g": g, "D": d, "page_size": SERVE_PAGE,
                                   "max_pages": SERVE_MAX_LEN // SERVE_PAGE},
              "sfc_flash_prefill": {"B": SERVE_SLOTS, "Tq": SERVE_MAX_LEN // 2, "Hkv": hkv, "g": g, "D": d,
                                    "page_size": SERVE_PAGE}}
    if att_shape is not None:
        B, H, S = att_shape
        shapes["sfc_flash_attention"] = {"BH": B * H, "S": S, "D": d, "bq": 128, "bkv": 128, "causal": True}
    library = {"sfc_flash_decode": "page gather + scaled_dot_product_attention",
               "sfc_flash_prefill": "page gather + scaled_dot_product_attention (causal mask)",
               "sfc_flash_attention": "scaled_dot_product_attention(is_causal=True)"}
    rows = []
    for name, tag in tags.items():
        row = {"name": f"{name}.{tag}", "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
               "launches": launches[name], **timed[(name, torch.bfloat16)], "library": library[name],
               "peak": "bf16 tensor cores (989 TFLOP/s), HBM 3.35 TB/s; f32: FP32 pipes (67 TFLOP/s)",
               "shape": shapes[name], "f32": timed[(name, torch.float32)]}
        rows.append(row)
        log(f"time {name} {tag}: {json.dumps(row)}")
    return rows


def olmoe_serving_path(rng, device, seed: int) -> list:
    """Phase 7d, after the SSM weights are freed: (a) rows 20-22 at
    OLMoE's shapes against their plain versions; (b) OLMoE-1B-7B at full
    size in bf16 on the paged flash engine: OLMOE_REQUESTS requests, every
    sfc_flash_decode launch on split and every sfc_flash_prefill launch on
    the core ``prefill_core`` names, layers x decode ticks and layers x
    admissions of them; a warm decode tick's profile; the bf16 forward of 2
    x 2048 tokens (16 row 20 launches on wgmma); (c) the f32 gate at full
    depth; (d) the three rows timed.  Returns the kernel rows."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import count_params, init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    errs, _ = compare_mha(rng, device)
    cfg = _olmoe_cfg("bfloat16")
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=device)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"serving olmoe model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"Hkv={cfg.num_kv_heads} D={cfg.attn_head_dim} experts={cfg.num_experts} top_k={cfg.top_k} "
        f"d_ff_expert={cfg.d_ff_expert} vocab={cfg.vocab_size} {cfg.dtype}, {count_params(params)} parameters "
        f"({weight_bytes} B), seeded random, {time.perf_counter() - t0:.1f} s to make, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.1f} GiB allocated")
    requests = make_requests(rng, cfg.vocab_size, OLMOE_REQUESTS, OLMOE_NEW)
    warm = serve_engine(cfg, params)
    warm.submit(requests[0][0][:80], max_new=2)
    warm.run_until_done()
    del warm
    cores = cohort_cores(cfg, torch.bfloat16)
    metrics = serve_counted(cfg, params, requests, "olmoe",
                            {k: cores[k] for k in ("sfc_flash_decode", "sfc_flash_prefill")})
    launches = LAUNCHES.counts()
    metrics.update(weight_bytes=weight_bytes, experts=cfg.num_experts, top_k=cfg.top_k)
    log("serving olmoe: " + json.dumps(metrics))
    busy = warm_decode_tick(cfg, params, requests, device)
    fwd = forward_bf16(params, cfg, rng, "olmoe")
    del params
    torch.cuda.empty_cache()
    olmoe_gate(rng, device, seed)
    rows = time_cohort(rng, device, errs, {**launches, "sfc_flash_attention": fwd["sfc_flash_attention_launches"]},
                       mha_inputs, _olmoe_cfg("float32"),
                       {"sfc_flash_decode": "mha", "sfc_flash_prefill": "mha", "sfc_flash_attention": "d128"},
                       MHA_ROW20)
    log("serving olmoe busy: " + json.dumps(busy))
    log(f"olmoe phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phases 7e, 7g and 7h: dense decoders' paged serving at full size (7e:
# Qwen2.5-14B, GQA g = 5, D = 128, QKV bias; 7g: Minitron-8B, g = 4, D =
# 128, tanh-GeLU, a 256,000 vocabulary, and StableLM-1.6B, MHA at D = 64;
# 7h: Chameleon-34B, g = 8, D = 128, 68.59 GB of bf16 weights; rows 21 and
# 22 at each model's shapes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseModel:
    """A dense decoder that a serving phase runs at full size: its name in
    the log lines, its registry arch, its published parameter count, the
    tag of its kernel rows, the positions a slot of its f32 gate's engines
    and the gate's predicted peak; its QKV biases drawn N(0, ``bias_std``)
    where it has them (``init_params`` zeroes them); ``unembed``: a warm
    tick's ``unembed`` timed apart; ``gate_layers``: the f32 gate's depth
    (None: the model's); ``serve_peak``: the bf16 serving run's predicted
    peak (0: none predicted)."""

    name: str
    arch: str
    params: int
    rows: str
    gate_max_len: int
    gate_peak: int
    bias_std: float = 0.0
    unembed: bool = False
    gate_layers: int | None = None
    serve_peak: int = 0

    def cfg(self, dtype: str):
        import dataclasses as dc

        from repro_torch.configs import get_config

        return dc.replace(get_config(self.arch), dtype=dtype)

    def gate_cfg(self):
        """The f32 gate's config: the model's, cut to ``gate_layers``."""
        cfg = self.cfg("float32")
        return dataclasses.replace(cfg, num_layers=self.gate_layers or cfg.num_layers)

    def inputs(self, rng, device, dtype, inactive=()):
        """Rows 21 and 22 at the model's shapes and their programs: decode
        over 8 slots of 128 pages of 16 (its Hkv, g and D; ``inactive``
        slots at pos -1), the prefill cohort of :func:`prefill_inputs` (8
        lanes, Tq 1,024) with garbage in the trash page; no row 20 (its
        serving runs none)."""
        cfg = self.cfg("float32")
        dec = decode_inputs(rng, device, dtype, cfg, inactive=inactive)
        pre = prefill_inputs(rng, device, dtype, cfg, trash=True)
        return (dec, pre, None), flash_programs(device, dec, pre, None)


QWEN = DenseModel("qwen", QWEN_ARCH, QWEN_PARAMS, "g5", QWEN_GATE_MAX_LEN, QWEN_GATE_PEAK_PREDICTED,
                  bias_std=QWEN_BIAS_STD)
MINITRON = DenseModel("minitron", MINITRON_ARCH, MINITRON_PARAMS, "g4", SERVE_MAX_LEN, MINITRON_GATE_PEAK_PREDICTED,
                      unembed=True)
STABLELM = DenseModel("stablelm", STABLELM_ARCH, STABLELM_PARAMS, "mha_d64", SERVE_MAX_LEN,
                      STABLELM_GATE_PEAK_PREDICTED, unembed=True)
CHAMELEON = DenseModel("chameleon", CHAMELEON_ARCH, CHAMELEON_PARAMS, "g8_d128", SERVE_MAX_LEN,
                       CHAMELEON_GATE_PEAK_PREDICTED, unembed=True, gate_layers=CHAMELEON_GATE_LAYERS,
                       serve_peak=CHAMELEON_SERVE_PEAK_PREDICTED)
# rows 21 and 22 at each model's shapes (tools/gqa_hashes.py reads these)
qwen_inputs, minitron_inputs, stablelm_inputs = QWEN.inputs, MINITRON.inputs, STABLELM.inputs
chameleon_inputs = CHAMELEON.inputs


def dense_params(m: DenseModel, seed: int, cfg, device):
    """Seeded random weights of ``m`` at ``cfg`` (``init_params``), the QKV
    biases (where ``cfg`` has them) drawn N(0, ``m.bias_std``) from a
    seeded generator on the device, so that the bias add runs at full size;
    the parameter count held to the published ``m.params`` at the model's
    depth, to the closed form at a cut one."""
    import torch
    from repro_torch.models import count_params, init_params, param_count_analytic

    params = init_params(seed, cfg, device=device)
    if m.bias_std:
        gen = torch.Generator(device=device).manual_seed(seed + 1000)
        with torch.no_grad():
            for name, p in params.named_parameters():
                if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) * m.bias_std)
    n = count_params(params)
    want = m.params if cfg.num_layers == m.cfg(cfg.dtype).num_layers else param_count_analytic(cfg)
    check(n == want, f"{m.name} at {cfg.num_layers} layers: {n} parameters, expected {want}")
    return params


class PrefillEvents:
    """While entered, each ``sfc_flash_prefill`` launch is timed by a pair
    of CUDA events recorded around its wrapper on the current stream (the
    wrapper enqueues its kernel and nothing else there); :meth:`ms` is
    their sum."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import attention as katt

        self._inner = inner = katt._prefill_cuda
        self.pairs = []

        def timed(program, *args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = inner(program, *args)
            b.record()
            self.pairs.append((a, b))
            return out

        katt._prefill_cuda = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import attention as katt

        katt._prefill_cuda = self._inner

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def unembed_tick(step, cfg) -> dict:
    """One more warm decode tick (``step``) with the model's ``unembed``
    timed by a pair of CUDA events around it (the f32 cast of the bf16
    head and the f32 product), beside the tick's wall and the bytes of
    the head's f32 copy."""
    import torch
    from repro_torch.models import model as model_mod

    inner, pairs = model_mod.unembed, []

    def timed(x, head):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(x, head)
        b.record()
        pairs.append((a, b))
        return out

    model_mod.unembed = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    finally:
        model_mod.unembed = inner
    check(len(pairs) == 1, f"unembed: {len(pairs)} calls in a decode tick")
    ms = pairs[0][0].elapsed_time(pairs[0][1])
    return {"ms": ms, "tick_wall_ms": wall, "share_of_tick": ms / wall,
            "head_f32_bytes": 4 * cfg.vocab_size * cfg.d_model}


def free_cuda() -> None:
    """Collect the garbage that holds device tensors in reference cycles
    (an engine whose method was swapped for a closure over it, as
    :func:`served_steps` does), then return the cached blocks: the next
    model of a phase must find the card empty."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def dense_gate(m: DenseModel, rng, device, seed: int) -> dict:
    """(c) the f32 gate at ``m.gate_layers`` (full depth by default):
    :func:`engine_gate` over DENSE_GATE_REQUESTS requests, both engines of
    ``m.gate_max_len`` positions a slot, the flash engine's decode on split
    and every prefill launch on tiled (none on simt), the dense engine's
    ``gqa_decode`` on ``_sdpa``; the peak allocated bytes beside
    ``m.gate_peak``."""
    import torch

    cfg32 = m.gate_cfg()
    torch.cuda.reset_peak_memory_stats(device)
    params32 = dense_params(m, seed + 1, cfg32, device)
    n_params = sum(p.numel() for p in params32.parameters())
    requests = make_requests(rng, cfg32.vocab_size, DENSE_GATE_REQUESTS, DENSE_GATE_NEW, DENSE_GATE_PROMPT,
                             GATE_PREFIX)
    cores = cohort_cores(cfg32, torch.float32)
    gate = engine_gate(cfg32, params32, requests, m.name,
                       {k: cores[k] for k in ("sfc_flash_decode", "sfc_flash_prefill")}, m.gate_max_len)
    gate.update(layers=cfg32.num_layers, of_layers=m.cfg("float32").num_layers, params=n_params,
                max_len=m.gate_max_len, weight_bytes=sum(p.numel() * p.element_size() for p in params32.parameters()),
                peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
                predicted_peak_bytes=m.gate_peak)
    log(f"check serving {m.name} gate: " + json.dumps(gate))
    del params32
    free_cuda()
    return gate


def dense_serving_path(m: DenseModel, rng, device, seed: int) -> list:
    """A dense decoder's phase, after the previous model's weights are
    freed: (a) rows 21 and 22 at ``m``'s shapes against their plain
    versions; (b) ``m`` at full size in bf16 (QKV biases drawn where it
    has them) on the paged flash engine: DENSE_REQUESTS requests, every
    sfc_flash_decode launch on split and every sfc_flash_prefill launch on
    wgmma (none on simt), layers x decode ticks and layers x admissions of
    them, each prefill launch of the run timed by CUDA events beside the
    admissions' wall, the run's peak allocated bytes beside what earlier
    phases hold and ``m.serve_peak``; a warm decode tick's profile (and,
    with ``m.unembed``, its ``unembed`` timed apart), each engine freed
    before the next is built; (c) the f32 gate (:func:`dense_gate`); (d)
    rows 21 and 22 timed at ``m``'s shapes (the CTAs the rule picks,
    ``flash_rows`` on the same cohort, page gather + SDPA).  Returns the
    kernel rows."""
    import torch
    from repro_torch.kernels import LAUNCHES

    t_phase = time.perf_counter()
    free_cuda()
    cfg32 = m.cfg("float32")
    errs, _ = compare_cohort(rng, device, m.inputs, cfg32, m.rows)
    free_cuda()
    held = torch.cuda.memory_allocated(device)
    cfg = m.cfg("bfloat16")
    t0 = time.perf_counter()
    params = dense_params(m, seed, cfg, device)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    mlp = "" if cfg.mlp_act == "swiglu" else f" mlp={cfg.mlp_act}"
    bias = " qkv_bias" if cfg.qkv_bias else ""
    drawn = f" (biases N(0, {m.bias_std}))" if m.bias_std else ""
    log(f"serving {m.name} model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"Hkv={cfg.num_kv_heads} D={cfg.attn_head_dim} d_ff={cfg.d_ff}{mlp} vocab={cfg.vocab_size}{bias} "
        f"{cfg.dtype}, {m.params} parameters ({weight_bytes} B), seeded random{drawn}, "
        f"{time.perf_counter() - t0:.1f} s to make, {torch.cuda.memory_allocated(device) / 2**30:.1f} GiB allocated")
    requests = make_requests(rng, cfg.vocab_size, DENSE_REQUESTS, DENSE_NEW)
    warm = serve_engine(cfg, params)
    warm.submit(requests[0][0][:80], max_new=2)
    warm.run_until_done()
    del warm
    free_cuda()
    cores = cohort_cores(cfg, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(device)
    with PrefillEvents() as events:
        metrics = serve_counted(cfg, params, requests, m.name,
                                {k: cores[k] for k in ("sfc_flash_decode", "sfc_flash_prefill")})
    peak = torch.cuda.max_memory_allocated(device)
    free_cuda()
    launches, got = LAUNCHES.counts(), LAUNCHES.cores()
    check(got["sfc_flash_prefill.simt"] == 0 and len(events.pairs) == launches["sfc_flash_prefill"],
          f"{m.name} serving: prefill launches {launches['sfc_flash_prefill']}, timed {len(events.pairs)}, "
          f"cores {got}")
    attn_ms = events.ms()
    busy = warm_decode_tick(cfg, params, requests, device, unembed=m.unembed)
    free_cuda()
    memory = {"peak_allocated_bytes": peak, "held_before_bytes": held}
    if m.serve_peak:
        memory.update(predicted_peak_bytes=m.serve_peak, peak_less_held_bytes=peak - held)
    metrics.update(weight_bytes=weight_bytes, **memory, prefill_attention_ms=attn_ms,
                   prefill_attention_launches=len(events.pairs),
                   prefill_attention_share=attn_ms / (1e3 * metrics["prefill_s"]),
                   warm_tick={k: busy[k] for k in ("wall_ms", "device_ms", "busy_share", "unembed") if k in busy})
    log(f"serving {m.name}: " + json.dumps(metrics))
    del params
    free_cuda()
    dense_gate(m, rng, device, seed)
    rows = time_cohort(rng, device, errs, launches, m.inputs, cfg32,
                       {"sfc_flash_decode": m.rows, "sfc_flash_prefill": m.rows})
    log(f"serving {m.name} busy: " + json.dumps(busy))
    log(f"{m.name} phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 7f: HuBERT-xlarge encodes at full size (encoder only: row 20 on the
# full table at D = 80, f32 frame embeddings in, cluster logits out)
# ---------------------------------------------------------------------------

def _hubert_cfg(dtype: str, **overrides):
    import dataclasses as dc

    from repro_torch.configs import get_config

    return dc.replace(get_config(HUBERT_ARCH), dtype=dtype, **overrides)


def hubert_frames(seed: int, device, dim: int):
    """HUBERT_BATCH's frame embeddings, seeded N(0, 1) f32, made on the
    device."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((*HUBERT_BATCH, dim), generator=gen, device=device, dtype=torch.float32)


def full_d80_inputs(rng, device, dtype):
    """Row 20 as HuBERT's forward gives it to the kernel: B·H = 16·16
    sequences of 1,500 frames x 80, zero-padded to the 128-row lattice
    (1,536 rows), as ``ops.attention`` pads them."""
    import torch

    B, S = HUBERT_BATCH
    cfg = _hubert_cfg("float32")
    BH, d, Sp = B * cfg.num_heads, cfg.attn_head_dim, -(-S // 128) * 128

    def t():
        x = torch.zeros((BH, Sp, d), dtype=torch.float32, device=device)
        x[:, :S] = torch.as_tensor(rng.standard_normal((BH, S, d), dtype=np.float32), device=device)
        return x.to(dtype)

    return t(), t(), t()


def compare_full_d80(rng, device) -> dict:
    """(a) row 20 at HuBERT's shape with the full table against its plain
    version, bf16 and f32, each launch's core read from the launch record
    (bf16 on the tensor-core core, f32 on the register-tiled core, never
    the SIMT core).  Returns the largest error by dtype."""
    import torch
    from repro_torch.kernels import attention as katt

    errs, parts = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATTN_TOL[str(dtype)[6:]]
        q, k, v = full_d80_inputs(rng, device, dtype)
        prog = d80_program(device, q, causal=False, kv_valid=HUBERT_BATCH[1])
        got, ran = launch_core(prog, (q, k, v))
        core = D80_CORES[str(dtype)[6:]]
        check(ran == core and katt.flash_core(dtype, q.shape[2], 128, 128) == core,
              f"sfc_flash_attention full D={q.shape[2]} {dtype}: launched on {ran}, expected the {core} core")
        want = prog.plain(prog, q, k, v)
        torch.cuda.synchronize()
        errs[dtype] = attn_err(got, want, tol, f"sfc_flash_attention full D={q.shape[2]} {dtype}")
        parts.append(f"{str(dtype)[6:]} (rtol {tol['rtol']}, atol {tol['atol']}) core {ran} "
                     f"max_abs_err={errs[dtype]:.3e}")
        del q, k, v, got, want
    B, S = HUBERT_BATCH
    cfg = _hubert_cfg("float32")
    log(f"compare flash full d80: BH={B * cfg.num_heads} S={-(-S // 128) * 128} kv_valid={S} "
        f"D={cfg.attn_head_dim} full table, bq=bkv=128: " + "; ".join(parts))
    return errs


def hubert_encode(device, seed: int) -> dict:
    """(b) HuBERT-xlarge at full size in bf16 (seeded random weights):
    ``forward`` with use_hilbert_kernels over HUBERT_BATCH's frame
    embeddings, every frame's logits; its row 20 launches, one a layer, all
    on the tensor-core core; cold and warm wall, frames/s, a warm call's
    device time and busy share (torch.profiler), the peak allocated bytes;
    the logits against the bf16 plain forward (reported: the two attention
    forms round apart in bf16); ``make_prefill_step`` on the same batch."""
    import dataclasses as dc

    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import count_params, forward, init_params

    cfg = _hubert_cfg("bfloat16")
    cfg_hk = dc.replace(cfg, use_hilbert_kernels=True)
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=device)
    n = count_params(params)
    check(n == HUBERT_PARAMS, f"hubert: {n} parameters, expected {HUBERT_PARAMS}")
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    frames = hubert_frames(seed + 2000, device, cfg.d_model)
    torch.cuda.synchronize()
    log(f"encode hubert model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"D={cfg.attn_head_dim} d_ff={cfg.d_ff} ({cfg.mlp_act}) targets={cfg.vocab_size} causal={cfg.causal} "
        f"encoder_only={cfg.encoder_only} embed_inputs={cfg.embed_inputs} {cfg.dtype}, {n} parameters "
        f"({weight_bytes} B), seeded random, {time.perf_counter() - t0:.1f} s to make; frames "
        f"{tuple(frames.shape)} f32")
    B, S = HUBERT_BATCH
    batch = {"embeds": frames}
    torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.reset()
    t = time.perf_counter()
    logits, _ = forward(params, batch, cfg_hk)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    counts, cores = LAUNCHES.counts(), LAUNCHES.cores()
    peak = torch.cuda.max_memory_allocated(device)
    launches = counts["sfc_flash_attention"]
    check(launches == cfg.num_layers == cores["sfc_flash_attention.wgmma"] and cores["sfc_flash_attention.simt"] == 0,
          f"hubert forward: sfc_flash_attention launches {launches}, cores {cores}, expected "
          f"{cfg.num_layers} on wgmma")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"hubert forward: logits {tuple(logits.shape)} or non-finite")
    warm = []
    for _ in range(3):
        t = time.perf_counter()
        forward(params, batch, cfg_hk)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    prof = profile_calls({"encode hubert forward (warm)": lambda: forward(params, batch, cfg_hk)})[0]
    step = make_prefill_step(cfg_hk)
    last = step(params, batch)
    torch.cuda.synchronize()
    check(tuple(last.shape) == (B, cfg.vocab_size) and bool(torch.allclose(last, logits[:, -1], rtol=STEP_TOL,
                                                                          atol=STEP_TOL)),
          "hubert make_prefill_step: not the forward's last-frame logits")
    prefill_ms = []
    for _ in range(3):
        t = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t))
    plain, _ = forward(params, batch, cfg)
    w = statistics.median(warm)
    out = {
        "utterances": B, "frames": S, "frames_total": B * S, "weight_bytes": weight_bytes,
        "sfc_flash_attention_launches": launches, "wgmma": cores["sfc_flash_attention.wgmma"],
        "cold_s": cold, "warm_s": w, "frames_per_s": B * S / w,
        "device_ms": prof["device_ms"], "busy_share": prof["busy_share"],
        "peak_allocated_bytes": peak, "prefill_step_ms": statistics.median(prefill_ms),
        "prefill_step_max_abs_diff": float((last - logits[:, -1]).abs().max()),
        "plain_max_abs_diff": float((logits - plain).abs().max()), "max_abs_logit": float(plain.abs().max()),
        "plain_argmax_agreement": float((logits.argmax(-1) == plain.argmax(-1)).float().mean()),
    }
    log("encode hubert: " + json.dumps(out))
    del params, frames, batch, logits, plain, last
    free_cuda()
    return out


def hubert_gate(rng, device, seed: int) -> dict:
    """(c) the model in f32 at full depth on HUBERT_BATCH's frames: the
    forward with use_hilbert_kernels (row 20 on the register-tiled core, one
    launch a layer) against the plain forward (``_sdpa`` on the unpadded
    frames, independent of row 20) at STEP_TOL, argmax equal outside the
    top-2 margin band; ``loss_fn`` on seeded cluster labels (about
    HUBERT_LABEL_MASK of them -1) through both, within HUBERT_LOSS_TOL
    relative; the peak allocated bytes."""
    import dataclasses as dc

    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import forward, init_params, loss_fn

    cfg32 = _hubert_cfg("float32")
    cfg_hk = dc.replace(cfg32, use_hilbert_kernels=True)
    torch.cuda.reset_peak_memory_stats(device)
    params32 = init_params(seed + 1, cfg32, device=device)
    B, S = HUBERT_BATCH
    frames = hubert_frames(seed + 2000, device, cfg32.d_model)
    labels = rng.integers(0, cfg32.vocab_size, size=(B, S)).astype(np.int32)
    labels[rng.random((B, S)) < HUBERT_LABEL_MASK] = -1
    labels = torch.as_tensor(labels, device=device)
    LAUNCHES.reset()
    t = time.perf_counter()
    lk, _ = forward(params32, {"embeds": frames}, cfg_hk)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    n, cores = LAUNCHES.counts()["sfc_flash_attention"], LAUNCHES.cores()
    check(n == cfg32.num_layers == cores["sfc_flash_attention.tiled"],
          f"hubert f32 forward: sfc_flash_attention launches {n}, cores {cores}, expected {cfg32.num_layers} on tiled")
    lp, _ = forward(params32, {"embeds": frames}, cfg32)
    check(bool(torch.isfinite(lk).all()) and lk.shape == lp.shape, "hubert f32 forward: non-finite or shape")
    versus = logits_against_plain(lk, lp, "hubert f32 forward")
    del lk, lp
    batch = {"embeds": frames, "labels": labels}
    loss_k, met_k = loss_fn(params32, batch, cfg_hk)
    loss_p, met_p = loss_fn(params32, batch, cfg32)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(bool(torch.isfinite(loss_k)) and rel <= HUBERT_LOSS_TOL,
          f"hubert f32 loss kernel {float(loss_k)} vs plain {float(loss_p)}: rel {rel}")
    gate = {"layers": cfg32.num_layers, "frames_total": B * S, "sfc_flash_attention_launches": n,
            "tiled": cores["sfc_flash_attention.tiled"], "wall_ms": wall, **versus, "step_tol": STEP_TOL,
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "ce_plain": float(met_p["ce"]),
            "loss_rel_diff": rel, "loss_tol": HUBERT_LOSS_TOL, "masked_labels": int((labels < 0).sum()),
            "weight_bytes": sum(p.numel() * p.element_size() for p in params32.parameters()),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(device)}
    log("check encode hubert gate: " + json.dumps(gate))
    del params32, frames, labels, batch
    free_cuda()
    return gate


def time_full_d80(rng, device, errs, launches: int) -> dict:
    """(d) row 20 at (a)'s shape, bf16 (f32 beside it): CUDA-event ms, the
    bound (4 D operations for every pair of the unpadded frames; q, k, v
    read and o written once, padding included), the plain version and
    ``scaled_dot_product_attention(is_causal=False)`` over the unpadded
    frames (its largest difference from the kernel's frames reported); the
    core from the launch record."""
    import torch
    from repro_torch.kernels import launch

    B, S = HUBERT_BATCH
    H = _hubert_cfg("float32").num_heads
    timed = {}
    for dtype, peak in ((torch.bfloat16, BF16_PEAK), (torch.float32, FP32_PEAK)):
        q, k, v = full_d80_inputs(rng, device, dtype)
        prog = d80_program(device, q, causal=False, kv_valid=S)
        Sp, d = q.shape[1], q.shape[2]
        ops_, nbytes, library = attention_work((q, k, v), (B, H, Sp), causal=False, valid=S)
        b_ms, b_by = bound_ms(ops_, peak, nbytes)
        out, core = launch_core(prog, (q, k, v))
        lib_err = float((out.reshape(B, H, Sp, d)[:, :, :S].float() - library().float()).abs().max())
        del out
        timed[dtype] = {
            "ms": cuda_ms(lambda: launch(prog, q, k, v), 10),
            "plain_ms": cuda_ms(lambda: prog.plain(prog, q, k, v), 1, warmup=0),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library, 10),
            "max_abs_err": errs[dtype], "library_max_abs_diff": lib_err, "core": core,
            "ctas": int(np.prod(prog.grid)),
        }
        del q, k, v, library
    row = {"name": "sfc_flash_attention.full_d80", "route": "cuda", "source": SOURCES["sfc_flash_attention"],
           "replaces": REPLACES["sfc_flash_attention"], "launches": launches, **timed[torch.bfloat16],
           "peak": "bf16 tensor cores (989 TFLOP/s), HBM 3.35 TB/s; f32: FP32 pipes (67 TFLOP/s)",
           "shape": {"BH": B * H, "S": Sp, "kv_valid": S, "D": d, "bq": 128, "bkv": 128, "causal": False},
           "library": "scaled_dot_product_attention(is_causal=False) over the unpadded frames",
           "f32": timed[torch.float32]}
    log(f"time sfc_flash_attention full d80: {json.dumps(row)}")
    return row


def hubert_path(rng, device, seed: int) -> list:
    """Phase 7f, after Qwen's weights are freed: (a) row 20 at HuBERT's
    shape with the full table against its plain version; (b) HuBERT-xlarge
    encodes HUBERT_BATCH at full size in bf16 through row 20; (c) the f32
    gate at full depth; (d) row 20 at (a)'s shape timed.  Returns its
    kernel row."""
    t_phase = time.perf_counter()
    free_cuda()
    errs = compare_full_d80(rng, device)
    enc = hubert_encode(device, seed)
    hubert_gate(rng, device, seed)
    row = time_full_d80(rng, device, errs, enc["sfc_flash_attention_launches"])
    log(f"hubert phase: {time.perf_counter() - t_phase:.1f} s")
    return [row]


# ---------------------------------------------------------------------------
# phase 8: the curve-range-sharded apps, SHARDS shards on the one card
# ---------------------------------------------------------------------------

def sharded_path(device, seed: int, ctx: dict) -> list:
    """(b) sharded k-means on SIFT1M's shapes in the three reduction
    classes (and exact once more on one shard), against phase 3's
    single-core run; (c) the sharded ε-join, halo and replicated, on the
    stream's 262,144 points in the unit cube and, replicated, on phase 3's
    262,144 × 16 set, array-equal to the single-core join; (d) launches,
    volumes, the host plan's time, a warm profile of each call and the
    five kernels' timings at these shapes."""
    import torch
    from repro_torch.core import kmeans_schedule, kmeans_schedule_device, triangle_schedule
    from repro_torch.kernels import LAUNCHES, launch, ops
    from repro_torch.kernels import sharded as ksh
    from repro_torch.kernels.kmeans import (
        hilbert_point_order_cached, kmeans_fold_program, kmeans_shard_program, shard_assign_cuda,
        shard_assign_plain, shard_update_cuda, shard_update_plain,
    )
    from repro_torch.kernels.simjoin import pairs_in_tile_order, simjoin_hits_rows_program
    from repro_torch.launch.mesh import make_app_mesh

    t_phase = time.perf_counter()
    xk, K, iters, cent, asg, band_a = (ctx[k] for k in ("xk", "K", "iters", "cent", "asg", "band_a"))
    xs_j, eps_s, xj, eps, pairs = (ctx[k] for k in ("xs_j", "eps_s", "xj", "eps", "pairs"))
    NK, DK = xk.shape
    mesh = make_app_mesh(SHARDS, devices=[device] * SHARDS)
    mesh1 = make_app_mesh(1, devices=[device])
    single_h = ops.simjoin_pairs(xs_j, eps_s, hilbert_order=True)
    wall, vols = {}, {}

    def run(name, m, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with m.recording() as vol:
            out = fn()
            torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t)
        vols[name] = vol.as_dict()
        return out

    def lloyd(m, reduce):
        return lambda: ops.kmeans_lloyd(xk, K, iters=iters, seed=seed, mesh=m, shard_reduce=reduce)

    calls = {f"ops.kmeans_lloyd {NK}x{DK} K={K} x{iters} mesh={SHARDS} {r}": (mesh, lloyd(mesh, r))
             for r in ("exact", "tree", "psum")}
    calls[f"ops.kmeans_lloyd {NK}x{DK} K={K} x{iters} mesh=1 exact"] = (mesh1, lloyd(mesh1, "exact"))
    NJ3 = xs_j.shape[0]
    calls[f"ops.simjoin_pairs {NJ3}x{xs_j.shape[1]} hilbert_order mesh={SHARDS} halo"] = (
        mesh, lambda: ops.simjoin_pairs(xs_j, eps_s, hilbert_order=True, mesh=mesh))
    calls[f"simjoin_pairs_sharded {NJ3}x{xs_j.shape[1]} hilbert_order mesh={SHARDS} halo=False"] = (
        mesh, lambda: ksh.simjoin_pairs_sharded(xs_j, eps_s, mesh=mesh, hilbert_order=True, halo=False))
    calls[f"simjoin_pairs_sharded {xj.shape[0]}x{xj.shape[1]} mesh={SHARDS} halo=False"] = (
        mesh, lambda: ksh.simjoin_pairs_sharded(xj, eps, mesh=mesh, halo=False))
    LAUNCHES.reset()
    outs = {name: run(name, m, fn) for name, (m, fn) in calls.items()}
    launches = {k: LAUNCHES.counts()[k] for k in SHARDED_KERNELS}
    log("sharded cold wall ms: " + json.dumps({k: round(v, 3) for k, v in wall.items()}))
    log("sharded launches: " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the sharded path")
    tree_again = lloyd(mesh, "tree")()

    # --- checks --------------------------------------------------------------
    names = list(calls)
    km = {r: outs[n] for r, n in zip(("exact", "tree", "psum", "exact S=1"), names[:4])}
    check(torch.equal(km["exact"][0], km["exact S=1"][0]) and torch.equal(km["exact"][1], km["exact S=1"][1]),
          f"sharded k-means exact: S={SHARDS} != S=1 to the bit")
    check(torch.equal(km["tree"][0], tree_again[0]) and torch.equal(km["tree"][1], tree_again[1]),
          "sharded k-means tree: two runs differ")
    for r in ("exact", "exact S=1"):
        check(torch.equal(km[r][0], cent) and torch.equal(km[r][1], asg),
              f"sharded k-means {r}: != the single-core ops.kmeans_lloyd to the bit")
    kstats = {}
    for r, (c, a) in km.items():
        check(c.shape == cent.shape and bool(torch.isfinite(c).all()), f"sharded k-means {r}: shape")
        err = float((c - cent).abs().max())
        check(bool(torch.allclose(c, cent, rtol=1e-4, atol=1e-3)), f"sharded k-means {r}: centroids err {err}")
        check(not bool(((a != asg) & ~band_a).any()), f"sharded k-means {r}: assignments differ outside the band")
        kstats[r] = {"centroids_max_abs_err_vs_single_core": err, "assign_mismatches": int((a != asg).sum()),
                     "bit_equal_single_core": bool(torch.equal(c, cent))}
    jn = names[4:]
    for name, want in zip(jn, (single_h, single_h, pairs)):
        check(torch.equal(outs[name], want), f"{name}: != the single-core ops.simjoin_pairs")
    log("check sharded: exact S=4 == S=1 == single core to the bit, tree bit-stable run to run, every class allclose to "
        "the single-core centroids (rtol 1e-4, atol 1e-3), assignments exact outside the band; every join "
        "array_equal to the single-core join; " + json.dumps(kstats))
    coll = {r: {p: n // iters for p, n in vols[n_]["counts"].items()} for r, n_ in zip(km, names[:4])}
    log("sharded volume: " + json.dumps({
        "kmeans collectives per step": coll,
        "kmeans bytes per shard": {r: vols[n_]["bytes_per_shard"] for r, n_ in zip(km, names[:4])},
        "join bytes per shard": {n_: vols[n_] for n_ in jn},
    }))

    # the single-core default-bp join (phase 3's pairs): in the 256-tile
    # order, and the reorder of the 128-tile join's pairs into it, timed
    NJ = xj.shape[0]
    nt = -(-NJ // 256)
    tri256 = torch.as_tensor(triangle_schedule("hilbert", nt, strict=False), device=device).long()
    rank = torch.zeros(nt * nt, dtype=torch.long, device=device)
    rank[tri256[:, 0] * nt + tri256[:, 1]] = torch.arange(len(tri256), device=device)
    pi, pj = pairs[:, 0].long(), pairs[:, 1].long()
    key = (rank[(pi // 256) * nt + pj // 256] * 256 + pi % 256) * 256 + pj % 256
    check(bool((key[1:] > key[:-1]).all()), "ops.simjoin_pairs default bp: pairs not in the 256-tile order")
    pairs128 = ops.simjoin_pairs(xj, eps, bp=128)
    check(torch.equal(pairs_in_tile_order(pairs128, n=NJ, bp=256, curve="hilbert"), pairs),
          "ops.simjoin_pairs: the reordered 128-tile pairs != the default call's")
    order = {"pairs": len(pairs), "bp": 256, "run_bp": 128,
             "reorder_ms": cuda_ms(lambda: pairs_in_tile_order(pairs128, n=NJ, bp=256, curve="hilbert"), 5),
             "pairs_bp128_ms": cuda_ms(lambda: ops.simjoin_pairs(xj, eps, bp=128), 3),
             "pairs_default_ms": cuda_ms(lambda: ops.simjoin_pairs(xj, eps), 3)}
    log("check simjoin_pairs default bp: pairs in the 256-tile order (strictly increasing key), the 128-tile "
        "join reordered equal to it, set-equal to the oracle outside the band (phase 4); " + json.dumps(order))
    del pairs128, key, pi, pj, rank

    # the halo join's host plan at these sizes
    xsorted = xs_j[hilbert_point_order_cached(xs_j)]
    pt = NJ3 // 128
    tri = triangle_schedule("hilbert", pt, strict=False)
    t = time.perf_counter()
    reach = ksh._tile_reach(xsorted, pt, 128, eps_s, True)
    t_reach = 1e3 * (time.perf_counter() - t)
    pruned = tri[reach[tri[:, 0], tri[:, 1]]]
    t = time.perf_counter()
    row_ids, plan, _tables, _slots, n_buf = ksh._halo_plan(pruned, -(-pt // SHARDS), SHARDS)
    t_plan = 1e3 * (time.perf_counter() - t)
    log("sharded halo plan: " + json.dumps({
        "triangle_rows": len(tri), "pruned_rows": len(pruned), "rows_per_shard": [len(r) for r in row_ids],
        "plan_(delta,m)": plan, "buffer_tiles_per_shard": n_buf, "resident_tiles": -(-pt // SHARDS),
        "tile_reach_host_ms": t_reach, "halo_plan_host_ms": t_plan}))

    # --- warm: wall, device time and busy share of each call ----------------
    profile_calls({name + " (warm)": fn for name, (_m, fn) in calls.items()})

    # --- the five kernels at these shapes -----------------------------------
    rows = []

    def entry(name, kern, plain, library, ops_, nbytes, reps, err, extra):
        b_ms, b_by = bound_ms(ops_, FP32_PEAK, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": cuda_ms(kern, reps),
            "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, reps) if library is not None else None,
            **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}), **extra,
        })
        log(f"time {name}: {json.dumps(rows[-1])}")

    # row 7 on the SHARDS shards of the exact run, at its final centroids
    st = ksh._lloyd_setup(xk, K, curve="fur", seed=seed, bp=128, bc=128, hilbert_order=False, mesh=mesh)
    ptl, bp, Kp = st["ptl"], st["bp"], st["cp"].shape[0]
    prog = kmeans_shard_program(
        kmeans_schedule_device("fur", ptl, st["ct"], device=device), pt=ptl, ct=st["ct"], bp=bp, bc=st["bc"], D=DK)
    xs = mesh.shard(st["xp"])
    lims = [t.reshape(2) for t in mesh.shard(torch.as_tensor(st["limits"], device=device))]
    cp = torch.nn.functional.pad(km["exact"][0], (0, 0, 0, Kp - K)).contiguous()
    cn = (cp * cp).sum(1)
    got = [shard_assign_cuda(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)]
    want = [shard_assign_plain(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)]
    a_k = torch.cat([g[1].reshape(-1) for g in got])[:NK]
    a_p = torch.cat([w[1].reshape(-1) for w in want])[:NK]
    band = argmin_band(xk, km["exact"][0])
    check(not bool(((a_k != a_p) & ~band).any()), "sfc_kmeans_shard_assign vs plain at full size")
    aerr = max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want))
    del want
    args = [g[1] for g in got]
    pt_all = st["pt"]
    # the library call, as rows 4 and 5a's: cdist + argmin over each
    # shard's points (one call a shard, as one launch a shard)
    entry("sfc_kmeans_shard_assign", lambda: [shard_assign_cuda(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)],
          lambda: [shard_assign_plain(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)],
          lambda: [torch.cdist(xs[i], cp[:K]).argmin(dim=1) for i in range(SHARDS)],
          2.0 * NK * Kp * DK, 4 * (NK * DK + Kp * DK + Kp + 2 * NK), 5, aerr,
          {"shards": SHARDS, "tiles_per_shard": ptl, "ctas_per_launch": ptl,
           "argmin_band_points": int(band.sum()), "argmin_mismatches": int((a_k != a_p).sum()),
           "addmm_min_ms": cuda_ms(lambda: [addmm_min(xs[i], cp[:K], cn[:K]) for i in range(SHARDS)], 5)})
    got = [shard_update_cuda(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)]
    want = [shard_update_plain(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)]
    for (s_k, n_k), (s_p, n_p) in zip(got, want):
        check(torch.equal(n_k, n_p), "sfc_kmeans_shard_update counts vs plain at full size")
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), "sfc_kmeans_shard_update sums vs plain")
    uerr = max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want))
    del want
    gathered = torch.cat([g[0] for g in got])
    del got
    # the library call: one index_add_ of [x, 1] into a (pt·Kp, D+1) buffer
    # at tile·Kp + arg — the same per-tile partials (sums and counts)
    x_aug = torch.cat([st["xp"][:NK], torch.ones(NK, 1, device=device)], dim=1)
    slot = (torch.arange(NK, device=device) // bp) * Kp + torch.cat([a.reshape(-1) for a in args])[:NK].long()
    acc = torch.zeros(pt_all * Kp, DK + 1, device=device)
    acc.index_add_(0, slot, x_aug)
    lerr = float((acc.view(pt_all, Kp, DK + 1)[:, :, :DK] - gathered[:pt_all]).abs().max())
    check(lerr <= 1e-3, f"index_add_ partials vs sfc_kmeans_shard_update: {lerr}")
    entry("sfc_kmeans_shard_update", lambda: [shard_update_cuda(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)],
          lambda: [shard_update_plain(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)],
          lambda: acc.zero_().index_add_(0, slot, x_aug),
          float(NK * DK), 4 * (NK * DK + NK + pt_all * Kp * (DK + 1)), 5, uerr,
          {"grid_per_shard": list(prog.grid), "partials_bytes": 4 * ptl * SHARDS * Kp * (DK + 1),
           "library_partials_max_abs_err": lerr})
    del x_aug, slot, acc
    # the exact class's launch: one partial per single-core update group
    local, _gid = ksh._exact_groups(st, SHARDS)
    gprogs = [kmeans_shard_program(
        kmeans_schedule_device("fur", ptl, st["ct"], device=device), pt=ptl, ct=st["ct"], bp=bp, bc=st["bc"],
        D=DK, groups=torch.as_tensor(local[i], device=device), tiles_per_group=st["tpg"]) for i in range(SHARDS)]
    gerr = 0.0
    for i in range(SHARDS):
        (s_k, n_k), (s_p, n_p) = (shard_update_cuda(gprogs[i], xs[i], args[i], lims[i]),
                                  shard_update_plain(gprogs[i], xs[i], args[i], lims[i]))
        check(torch.equal(n_k, n_p), "sfc_kmeans_shard_update (groups) counts vs plain at full size")
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), "sfc_kmeans_shard_update (groups) sums")
        gerr = max(gerr, float((s_k - s_p).abs().max()))
    del s_k, s_p
    rows[-1]["exact_groups"] = {
        "tiles_per_group": st["tpg"], "groups_per_shard": gprogs[0].grid[0], "grid_per_shard": list(gprogs[0].grid),
        "ms": cuda_ms(lambda: [shard_update_cuda(gprogs[i], xs[i], args[i], lims[i]) for i in range(SHARDS)], 5),
        "partials_bytes": 4 * gprogs[0].grid[0] * SHARDS * Kp * (DK + 1), "max_abs_err": gerr}
    log(f"time sfc_kmeans_shard_update exact groups: {json.dumps(rows[-1]['exact_groups'])}")
    host = kmeans_schedule("fur", pt_all, st["ct"])
    fold = kmeans_fold_program(torch.as_tensor(np.ascontiguousarray(host[host[:, 0] == 1][:, 1:2]), device=device))
    check(torch.equal(launch(fold, gathered), fold.plain(fold, gathered)), "sfc_kmeans_fold vs plain at full size")
    entry("sfc_kmeans_fold", lambda: launch(fold, gathered), lambda: fold.plain(fold, gathered),
          lambda: gathered[:pt_all].sum(0),
          float((pt_all - 1) * Kp * DK), 4 * (pt_all * Kp * DK + Kp * DK), 20, 0.0,
          {"tiles_folded": pt_all, "elements": Kp * DK})
    del gathered

    # rows 9 and 11 on the halo join's own plan: its tables and buffers
    hj = ksh._HaloJoin(mesh, xsorted, xsorted, float(eps_s), bp=128, pt=pt, n_valid=None, tri=tri,
                       sorted_keys=True, reach=reach)
    hprogs = [simjoin_hits_rows_program(t, **hj.args, halo=True) for t in hj.scheds]
    band_s = join_band(xsorted, float(eps_s), metric=F32_METRIC)
    rk = hj.rows([launch(p_, b) for p_, b in zip(hprogs, hj.bufs)])
    rp = hj.rows([p_.plain(p_, b) for p_, b in zip(hprogs, hj.bufs)])
    pruned_t = torch.as_tensor(hj.pruned, device=device)
    herr = check_tile_counts(pruned_t, (rk,), (rp,), band_s, NJ3, 128, "sfc_join_hits_rows")
    # each side's emission from its own pass-1 totals, compared as pair sets
    tot = rk.sum(1).cpu().numpy().astype(np.int64)
    eprogs, src = hj.emission(tot)
    pprogs, psrc = hj.emission(rp.sum(1).cpu().numpy().astype(np.int64))
    pk = ksh._gather([launch(p_, b) for p_, b in zip(eprogs, hj.bufs)], device)[src.to(device)]
    pp = ksh._gather([p_.plain(p_, b) for p_, b in zip(pprogs, hj.bufs)], device)[psrc.to(device)]
    estats = check_pairs(pk, pp, band_s, NJ3, "sfc_join_emit_halo")
    band_tiles = torch.unique((band_s // NJ3 // 128) * pt + band_s % NJ3 // 128)
    log(f"sfc_join_emit_halo vs plain: {estats['pairs']} pairs, {len(band_s)} band pairs in {len(band_tiles)} "
        f"tiles, {estats['differ_in_band']} pairs differ (all in the band)")
    # the work the data needs: the pruned rows (not the zero padding rows)
    on_diag = hj.pruned[:, 0] == hj.pruned[:, 1]
    cand = int((~on_diag).sum()) * 128 * 128 + int(on_diag.sum()) * 128 * 127 / 2
    hr = int(hj.sched.shape[0])
    DJ3 = xs_j.shape[1]
    buf_rows = sum(b.shape[0] for b in hj.bufs)
    entry("sfc_join_hits_rows", lambda: [launch(p_, b) for p_, b in zip(hprogs, hj.bufs)],
          lambda: [p_.plain(p_, b) for p_, b in zip(hprogs, hj.bufs)], None,
          cand * (2 * DJ3 + 3), 4 * (buf_rows * DJ3 + 4 * hr + hr * 128), 5, float(herr),
          {"table_rows": hr, "pruned_rows": len(hj.pruned), "triangle_rows": len(tri), "buffer_rows": buf_rows,
           **join_walk(hprogs)})
    busy = tot > 0
    n_off, n_diag = int((busy & ~on_diag).sum()), int((busy & on_diag).sum())
    P = int(tot.sum())
    # pairs are indices, compared as sets: equal outside the band (else
    # check_pairs fails), so the error is 0; the band pairs in which the
    # two differ are counted apart
    entry("sfc_join_emit_halo", lambda: [launch(p_, b) for p_, b in zip(eprogs, hj.bufs)],
          lambda: [p_.plain(p_, b) for p_, b in zip(eprogs, hj.bufs)], None,
          (n_off * 128 * 128 + n_diag * 128 * 127 / 2) * (2 * DJ3 + 3),
          4 * (buf_rows * DJ3 + 6 * hr + 2 * P), 5, 0.0,
          {"tiles_with_pairs": n_off + n_diag, "pairs": P, "p_pad": eprogs[0].params["p_pad"],
           "differ_in_band": estats["differ_in_band"], "band_pairs": len(band_s), "band_tiles": len(band_tiles),
           **join_walk(eprogs)})
    log(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 9: the training stack; TinyLlama-1.1B trains on the card
# ---------------------------------------------------------------------------

def _train_cfg(layers: int | None, dtype: str):
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers, dtype=dtype)


def train_card_vs_cpu(device, seed: int, tmp: str) -> dict:
    """(a) One Trainer step on the card against the same step on the CPU."""
    import torch

    from repro_torch.models import init_params, params_from_numpy, params_to_numpy
    from repro_torch.train import Trainer, TrainerConfig

    layers, B, S = TRAIN_CHECK
    cfg = _train_cfg(layers, "float32")
    tcfg = TrainerConfig(lr=TRAIN_CHECK_LR, warmup_steps=0, micro_batch=B, seq_len=S, seed=seed,
                         ckpt_dir=tmp)
    cpu, gpu = Trainer(cfg, tcfg, device="cpu"), Trainer(cfg, tcfg, device=device)
    params = init_params(seed, cfg, device="cpu")
    s_gpu = gpu.state_from_params(params_from_numpy(params_to_numpy(params), cfg, device))
    s_cpu = cpu.state_from_params(params)
    t = time.perf_counter()
    s_gpu, m_gpu = gpu.step(s_gpu, gpu.batch_at(0))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    s_cpu, m_cpu = cpu.step(s_cpu, cpu.batch_at(0))
    t_cpu = time.perf_counter() - t
    rel = {k: abs(float(m_gpu[k]) - float(m_cpu[k])) / abs(float(m_cpu[k])) for k in ("loss", "grad_norm")}
    # the first moments are 0.1 x the clipped grads: the grads compared
    m_err = max(float((s_gpu["opt"].m[n].cpu() - m).abs().max()) / max(float(m.abs().max()), 1e-30)
                for n, m in s_cpu["opt"].m.items())
    p_err = p_err_away = 0.0
    for n, b in s_cpu["params"].named_parameters():
        diff = (dict(s_gpu["params"].named_parameters())[n].detach().cpu() - b.detach()).abs()
        m = s_cpu["opt"].m[n].abs()
        away = m > TRAIN_GRAD_FLOOR * m.max()
        p_err = max(p_err, float(diff.max()))
        p_err_away = max(p_err_away, float(diff[away].max()) if away.any() else 0.0)
    out = {"layers": layers, "B": B, "S": S, "loss": float(m_cpu["loss"]), "rel_loss": rel["loss"],
           "rel_grad_norm": rel["grad_norm"], "max_moment_diff_rel": m_err,
           "max_param_diff_over_lr": p_err / TRAIN_CHECK_LR,
           "max_param_diff_over_lr_grad_away_from_0": p_err_away / TRAIN_CHECK_LR,
           "card_s": t_gpu, "cpu_s": t_cpu}
    log("check train card vs cpu: " + json.dumps(out))
    check(rel["loss"] <= 1e-5, f"train card vs cpu: loss rel {rel['loss']:.2e} > 1e-5")
    check(rel["grad_norm"] <= 1e-4, f"train card vs cpu: grad norm rel {rel['grad_norm']:.2e} > 1e-4")
    check(m_err <= 1e-4, f"train card vs cpu: first moments differ by {m_err:.2e} of their max")
    check(p_err_away <= TRAIN_PARAM_TOL * TRAIN_CHECK_LR,
          f"train card vs cpu: a parameter differs by {p_err_away / TRAIN_CHECK_LR:.2e} lr")
    check(p_err <= 2 * TRAIN_CHECK_LR * (1 + 1e-3),
          f"train card vs cpu: a parameter differs by {p_err / TRAIN_CHECK_LR:.2e} lr, more than a step")
    return out


def train_recovery(device, tmp: str) -> dict:
    """(b) The reference's test_recovery_is_exact on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig

    cfg = get_reduced(TRAIN_ARCH, num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                      head_dim=32, d_ff=128, vocab_size=128)

    def trainer(sub):
        return Trainer(cfg, TrainerConfig(lr=3e-3, warmup_steps=5, total_steps=100, micro_batch=4,
                                          seq_len=32, ckpt_dir=f"{tmp}/{sub}", ckpt_every=5),
                       device=device)

    _, hist1 = trainer("a").run(16)
    tr2, armed = trainer("b"), [True]

    def hook(step):
        if step == 9 and armed[0]:
            armed[0] = False
            raise SimulatedFailure("node lost at step 9")

    _, hist2 = tr2.run(16, failure_hook=hook)
    tail1 = {h["step"]: h["loss"] for h in hist1}
    tail2 = {h["step"]: h["loss"] for h in hist2}
    rel = max(abs(tail1[s] - tail2[s]) / abs(tail1[s]) for s in range(12, 16))
    out = {"restarts": tr2.restarts, "steps_run": len(hist2), "max_rel_loss_12_15": rel}
    log("check train recovery: " + json.dumps(out))
    check(tr2.restarts == 1, f"train recovery: {tr2.restarts} restarts, expected 1")
    check(rel <= 1e-5, f"train recovery: steps 12-15 differ by rel {rel:.2e}")
    return out


def train_bound(dry: dict, accum: int) -> dict:
    """Phase 9's step bound: ``accum`` micro-batches of the dry run's
    compute term of one micro-batch step (``dry``: its record of TinyLlama
    at TRAIN_FULL's B x S; AdamW does no product).  The dry run counts the
    products the step really runs, by operand dtype, from the trace."""
    return {"tflop": {k: accum * v / 1e12 for k, v in dry["flops_by_dtype"].items()},
            "bound_ms": accum * 1e3 * dry["t_compute_s"], "bound_by": "operations",
            "source": f"dry run compute term x {accum} micro-batches"}


def train_full(device, seed: int, tmp: str, dry: dict) -> dict:
    """(c) TinyLlama-1.1B at full size in bf16 through the launcher's
    configs, ``Trainer.step`` by step (no checkpoint); ``dry``: the dry
    run's record of one of its micro-batch steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launcher
    from repro_torch.train import Trainer

    B, S, accum, steps, lr, warmup = TRAIN_FULL
    args = launcher.parse_args(["--arch", TRAIN_ARCH, "--full", "--steps", str(steps),
                                "--seq-len", str(S), "--micro-batch", str(B),
                                "--grad-accum", str(accum), "--lr", str(lr), "--ckpt-dir", tmp,
                                "--device", str(device)])
    cfg, tcfg = launcher.build(args)
    # warm-up 2 (the launcher's steps // 10 is 1); the steps of ``run``
    # without its checkpoints (an ~11 GB save and restore took 60-70 s of
    # the script; phase 9 (b) and the cuda tests restore on the card)
    tcfg = dataclasses.replace(tcfg, warmup_steps=warmup, seed=seed)
    trainer = Trainer(cfg, tcfg, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, hist = trainer.init_state(tcfg.seed), []
    for step in range(steps):
        batch = trainer.batch_at(step)
        t = time.perf_counter()
        state, met = trainer.step(state, batch)
        hist.append({"step": step, **{k: float(v) for k, v in met.items()}, "seconds": time.perf_counter() - t})
    peak = torch.cuda.max_memory_allocated()
    for h in hist:
        log("train tinyllama step: " + json.dumps(h))
    check(len(hist) == steps and all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist),
          "train tinyllama: a loss or grad norm is not finite")
    warm = statistics.median(h["seconds"] for h in hist[2:])

    # one more step under the profiler: its device time and busy share
    batch = trainer.batch_at(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = 1e-3 * sum(e.self_device_time_total for e in kernels) if kernels else None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]

    bound = train_bound(dry, accum)
    tokens = B * S * accum
    out = {
        "config": {"layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                   "dtype": cfg.dtype, "micro_batch": B, "seq_len": S, "grad_accum": accum,
                   "tokens_a_step": tokens, "steps": steps, "lr": lr, "warmup_steps": warmup},
        "params": sum(p.numel() for p in state["params"].parameters()),
        "loss_first_last": [hist[0]["loss"], hist[-1]["loss"]],
        "warm_step_s_median": warm, "tokens_per_s": tokens / warm,
        "step_bound_s": bound["bound_ms"] / 1e3, "bound_share": bound["bound_ms"] / 1e3 / warm,
        "bound": bound,
        "profiled_step": {"wall_s": wall, "device_s": dev_ms / 1e3 if dev_ms else "not measured",
                          "busy_share": dev_ms / 1e3 / wall if dev_ms else "not measured",
                          "top": [[e.key[:60], 1e-3 * e.self_device_time_total, e.count] for e in top]},
        "peak_memory_gb": peak / 1e9,
    }
    log("train tinyllama: " + json.dumps(out))
    return out


def training_path(device, seed: int, dry: dict) -> dict:
    """Phase 9: (a) a step on the card against the CPU, (b) exact recovery
    on the card, (c) TinyLlama-1.1B trains at full size (its bound from
    ``dry``, the dry run of one micro-batch step).  Checkpoints go to a
    temporary directory, removed afterwards."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"train: checkpoints under {tmp} ({free / 1e9:.1f} GB free)")
        out = {"card_vs_cpu": train_card_vs_cpu(device, seed, f"{tmp}/a"),
               "recovery": train_recovery(device, f"{tmp}/b"),
               "tinyllama": train_full(device, seed, f"{tmp}/c", dry)}
    torch.cuda.empty_cache()
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the schedule autotuner on the card
# ---------------------------------------------------------------------------

def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(_outputs(a), _outputs(b)))


def schedule_builds(app: str, shapes: dict, device):
    """The device tables one call of ``app`` builds under a curve, as a
    function of the curve (timed cold, before the tuner runs)."""
    from repro_torch.core import (kmeans_schedule_device, phase_groups, phased_schedule_device,
                                  tile_schedule_device, triangle_schedule_device)

    if app == "matmul":
        return lambda c: tile_schedule_device(c, shapes["tiles"], device=device)
    if app == "kmeans_lloyd":
        return lambda c: kmeans_schedule_device(c, *shapes["kmeans"], device=device)
    if app == "simjoin_counts":
        return lambda c: triangle_schedule_device(c, shapes["join"], strict=False, device=device)
    if app == "simjoin_pairs":  # the 128-tile passes and the 256-tile order
        return lambda c: [triangle_schedule_device(c, nt, strict=False, device=device)
                          for nt in (shapes["join"], -(-shapes["join"] // 2))]
    kind = {"floyd_warshall": "fw", "cholesky": "cholesky"}[app]
    return lambda c: (phased_schedule_device(c, shapes["phased"], kind=kind, device=device),
                      phase_groups(c, shapes["phased"], kind=kind))


def check_against_default(app: str, got, base, ctx: dict) -> dict:
    """A swapped curve's result against the default's: FW, Cholesky and
    matmul equal to the bit (the curve only reorders independent tiles),
    counts equal, pairs set-equal, k-means assignments exact outside the
    float64 tie band and centroids allclose at phase 4's tolerances."""
    import torch

    if app == "kmeans_lloyd":
        (c, a), (cb, ab) = got, base
        off = (a != ab) & ~ctx["band_a"]
        check(not bool(off.any()), f"autotune {app}: {int(off.sum())} assignments differ outside the band")
        check(bool(torch.allclose(c, cb, rtol=1e-4, atol=1e-3)), f"autotune {app}: centroids not allclose")
        return {"mismatches": int((a != ab).sum()), "centroid_max_abs_err": float((c - cb).abs().max())}
    if app == "simjoin_pairs":
        n = ctx["xj"].shape[0]
        check(len(got) == len(base) and torch.equal(pair_keys(got, n), pair_keys(base, n)),
              f"autotune {app}: pair set differs from the default curve's")
        return {"pairs": len(got), "same_order": bool(torch.equal(got, base))}
    check(torch.equal(got, base), f"autotune {app}: result differs from the default curve's")
    return {"equal_bits": True}


def run_twins() -> dict:
    """Run the four example twins on the card at once, each in its own
    process with TWIN_TIMEOUT; a non-zero exit or a False match line
    fails.  Every process is stopped before this returns."""
    import os
    import re

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}_torch.py")],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                                    cwd=ROOT)
             for name in EXAMPLE_TWINS}
    outs = {}
    try:
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=max(1.0, TWIN_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"example twin {name}: no end within {TWIN_TIMEOUT} s") from None
            verdicts = re.findall(r":\s*(True|False)\b", out)
            outs[name] = {"rc": proc.returncode, "verdicts": len(verdicts),
                          "s": round(time.perf_counter() - t0, 1)}
            check(proc.returncode == 0, f"example twin {name}: exit {proc.returncode}: {err[-2000:]}")
            check(verdicts and set(verdicts) == {"True"}, f"example twin {name}: match lines {verdicts}\n{out}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def autotune_path(device, seed: int, ctx: dict) -> dict:
    """Phase 10: ``autotune_app`` for each of the six tunable apps at the
    main path's shapes (phase 3's inputs), the cache in a temporary file;
    each candidate's warm ms and cold schedule build, the winner and the
    default; ``choice="auto"`` equal to the explicit winner to the bit;
    the best non-default candidate's result against the default curve's,
    its kernels' launches counted; ``launch(fw_program, choice=...)``
    equal to the default; the refusals; the four example twins."""
    import os
    import tempfile

    import torch
    from repro_torch.core import ScheduleChoice, schedule_cache_clear
    from repro_torch.kernels import LAUNCHES, autotune, launch, ops
    from repro_torch.kernels.floyd_warshall import fw_program

    t_phase = time.perf_counter()
    card = card_line()
    xk, K, iters, xj, eps = (ctx[k] for k in ("xk", "K", "iters", "xj", "eps"))
    a32, b32, fw_d, ch_a = (ctx[k] for k in ("a32", "b32", "fw_d", "ch_a"))
    calls = {
        "matmul": ((a32, b32), {}),
        "kmeans_lloyd": ((xk, K), {"iters": iters, "seed": seed}),
        "simjoin_counts": ((xj, eps), {}),
        "simjoin_pairs": ((xj, eps), {}),
        "floyd_warshall": ((fw_d,), {}),
        "cholesky": ((ch_a,), {}),
    }
    # the grids of the calls above at the entry points' default blocks
    shapes = {"tiles": (a32.shape[0] // 128, b32.shape[1] // 128), "kmeans": (-(-xk.shape[0] // 128), K // 128),
              "join": -(-xj.shape[0] // 128), "phased": fw_d.shape[0] // 128}
    check(ch_a.shape[0] == fw_d.shape[0], "autotune: the phased inputs' sizes differ")
    saved_env = os.environ.get(autotune.ENV_VAR)
    backend = device.type  # the key's backend: "cuda" on the card
    other = "cpu" if backend == "cuda" else "cuda"
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        os.environ[autotune.ENV_VAR] = f"{tmp}/tuning.json"
        schedule_cache_clear()  # cold schedule builds, and an empty tuning layer
        try:
            for app, (args, kw) in calls.items():
                fn = getattr(ops, app)
                build = schedule_builds(app, shapes, device)
                cold = {}
                for curve in AUTOTUNE_CURVES[app]:
                    t = time.perf_counter()
                    build(curve)
                    torch.cuda.synchronize()
                    cold[curve] = time.perf_counter() - t
                base = fn(*args, **kw)
                out = autotune.autotune_app(app, *args, curves=AUTOTUNE_CURVES[app], max_measure=AUTOTUNE_MEASURE,
                                            repeats=AUTOTUNE_REPEATS, **kw)
                winner = ScheduleChoice.from_key(out["winner"])
                check(out["key"].split("|")[1] == backend, f"autotune {app}: key {out['key']} is not {backend}'s")
                shp = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
                check(autotune.lookup(app, shp, backend=backend) == winner, f"autotune {app}: winner not recorded")
                check(autotune.lookup(app, shp, backend=other) is None, f"autotune {app}: a {other} entry appeared")
                alt_row = min((r for r in out["rows"] if not r["default"]), key=lambda r: r["warm_ms"])
                alt = ScheduleChoice.from_key(alt_row["choice"])
                LAUNCHES.reset()
                got_alt = fn(*args, choice=alt, **kw)
                torch.cuda.synchronize()
                launches = {k: LAUNCHES.counts().get(k, 0) for k in AUTOTUNE_KERNELS[app]}
                for name, n in launches.items():
                    check(n > 0, f"autotune {app}: {name} was not launched under {alt.key()}")
                vs_default = check_against_default(app, got_alt, base, ctx)
                got_win = got_alt if winner == alt else fn(*args, choice=winner, **kw)
                auto = fn(*args, choice="auto", **kw)
                check(same_bits(auto, got_win), f"autotune {app}: choice='auto' != the explicit winner")
                if app == "kmeans_lloyd":
                    check(same_bits(base, (ctx["cent"], ctx["asg"])), f"autotune {app}: default != phase 3's")
                report[app] = {
                    "card": card, "key": out["key"],
                    "candidates_warm_ms": {r["choice"]: r["warm_ms"] for r in out["rows"]},
                    "winner": out["winner"], "default_ms": out["default_ms"],
                    "winner_speedup": out["default_ms"] / min(r["warm_ms"] for r in out["rows"]),
                    "cold_schedule_build_s": cold, "swapped": alt.key(), "swapped_launches": launches,
                    "vs_default": vs_default, "auto_equals_winner": True,
                }
                log(f"autotune {app}: " + json.dumps(report[app]))
                del base, got_alt, got_win, auto

            # launch() swaps the phased table, its barrier groups rebuilt
            nt = shapes["phased"]
            base_fw = ops.floyd_warshall(fw_d)
            prog = fw_program("hilbert", nt, 128, device=device)
            swapped = launch(prog, fw_d.clone(), choice=ScheduleChoice(curve="harmonious", kind="phased:fw"))
            check(torch.equal(swapped, base_fw), "launch(fw_program, choice=harmonious) != the default")
            del swapped, base_fw

            # refusals: a block above the kernels' limit; the backend in the key
            d1k = fw_graph(np.random.default_rng(seed + 10), 1024, device)
            LAUNCHES.reset()
            try:
                ops.floyd_warshall(d1k, choice=ScheduleChoice(curve="hilbert", block=(256,), kind="phased:fw"))
                refused = None
            except ValueError as e:
                refused = str(e)
            check(refused is not None and "outside" in refused, f"floyd_warshall b=256: not refused ({refused})")
            check(not any(LAUNCHES.counts().values()), "floyd_warshall b=256: a kernel launched")
            zorder = ScheduleChoice(curve="zorder", kind="phased:fw")
            autotune.record("floyd_warshall", ((1024, 1024),), zorder, 1.0, backend=other)
            check(ops._app_choice("auto", "floyd_warshall", d1k) is None, f"a {other} entry was used")
            check(autotune.resolve_program_choice(fw_program("hilbert", 8, 128, device=device), "auto", (d1k,))
                  .choice.curve == "hilbert", f"launch: a {other} entry was used")
            base_1k = ops.floyd_warshall(d1k)
            autotune.record("floyd_warshall", ((1024, 1024),), zorder, 1.0, backend=backend)
            check(ops._app_choice("auto", "floyd_warshall", d1k) == zorder, f"the {backend} entry was not used")
            check(autotune.resolve_program_choice(fw_program("hilbert", 8, 128, device=device), "auto", (d1k,))
                  .choice.curve == "zorder", f"launch: the {backend} entry was not used")
            LAUNCHES.reset()
            check(torch.equal(ops.floyd_warshall(d1k, choice="auto"), base_1k), "floyd_warshall 1024 auto != default")
            check(LAUNCHES.counts()["sfc_fw_trailing"] > 0, "floyd_warshall 1024 auto: no kernel launched")
            log(f"check autotune refusals: b=256 raised ({refused}); on {backend} a {other} entry "
                f"unused, a {backend} entry used")
        finally:
            if saved_env is None:
                os.environ.pop(autotune.ENV_VAR, None)
            else:
                os.environ[autotune.ENV_VAR] = saved_env
            autotune.tuning_cache_clear()
    twins = run_twins()
    log("example twins: " + json.dumps(twins))
    log(f"autotune phase: {time.perf_counter() - t_phase:.1f} s ({card})")
    return report


# ---------------------------------------------------------------------------
# phase 11: the dry run against the card
# ---------------------------------------------------------------------------

def dry_cells():
    """(a) Mamba2-2.7B x decode_32k and (b) Zamba2-2.7B x long_500k at
    their full shapes, (c) TinyLlama-1.1B training at one micro-batch of
    TRAIN_FULL's B x S and (d) HuBERT-xlarge training at one micro-batch
    of HUBERT_TRAIN's (train_4k's sequence, its batch cut from 256).  The
    HuBERT prefill cell (1 x 32,768, ~44 s of the script) is left out to
    make room for phase 12; PERF.md keeps its earlier record."""
    from repro_torch.configs import SHAPES, ShapeSpec

    B, S = TRAIN_FULL[:2]
    tb, ts = HUBERT_TRAIN
    return (("mamba2-2.7b", SHAPES["decode_32k"]), (SSM_HYBRID, SHAPES["long_500k"]),
            (TRAIN_ARCH, ShapeSpec(f"train_{B}x{S}", S, B, "train")),
            (HUBERT_ARCH, ShapeSpec(f"train_{tb}x{ts}", ts, tb, "train")))


def cell_name(arch: str, shape) -> str:
    return f"{arch} x {shape.name}"


def dry_record(arch: str, shape, device) -> dict:
    """The one-card dry run of a cell, traced on the host (``meta``)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_one_card_mesh

    t = time.perf_counter()
    rec = run_cell(arch, shape, mesh=make_one_card_mesh(device), verbose=False)
    rec["host_s"] = time.perf_counter() - t
    return rec


def dry_inputs(cfg, shape, device, seed: int):
    """A cell's arguments on the card, at ``input_specs``' shapes and
    dtypes: seeded weights (and AdamW's state); in the train and prefill
    modes the batch of ``input_specs``, leaf by leaf: seeded tokens and
    labels (ids below the vocabulary, or the cluster targets), seeded
    N(0, 1) f32 frame embeddings where the model reads embeddings
    (``embed_inputs=False``); in the decode mode seeded tokens and a zero
    cache with every slot at its last position."""
    import torch

    from repro_torch.launch.steps import input_specs
    from repro_torch.models import init_cache, init_params, named_params
    from repro_torch.optim import adamw_init

    B, S = shape.global_batch, shape.seq_len
    g = torch.Generator(device=device).manual_seed(seed)

    def leaf(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=device, dtype=dtype)
        return torch.randint(0, cfg.vocab_size, shape, generator=g, device=device, dtype=dtype)

    params = init_params(seed, cfg, device=device)
    if shape.mode in ("train", "prefill"):
        batch = {k: leaf(a.shape, a.dtype) for k, a in input_specs(cfg, shape)[1].items()}
        if shape.mode == "train":
            return {"params": params, "opt": adamw_init(named_params(params))}, batch
        return params, batch
    if shape.mode == "decode":
        return (params, leaf((B, 1), torch.int32), init_cache(cfg, B, S, device=device),
                torch.full((B,), S - 1, dtype=torch.int32, device=device))
    raise ValueError(f"no phase-11 inputs for mode {shape.mode}")


# The measured peak must lie within DRY_TOL_BYTES plus DRY_TOL of the
# prediction: tighter than 10 % or 1 GiB, so that a prediction without
# cell (b)'s 5.1 GiB of f32 K/V casts fails.  On an H100 80GB HBM3 at
# 700 W the peaks read 0.003-0.117 GiB above the predictions (this
# script's phase 11, two runs).  The fixed part holds what the trace
# cannot see: the cuBLAS workspace (32 MiB at sm_90's default
# CUBLAS_WORKSPACE_CONFIG :4096:8, allocated through the caching allocator
# on a process's first product) and the allocator's rounding (each block
# to 512 bytes, which the prediction applies too; a large block's
# unsplit remainder, under 1 MiB).
DRY_TOL = 0.01
DRY_TOL_BYTES = 2 ** 29
DRY_SPARE = 4 * 2 ** 30  # cell (b) runs only where the prediction leaves this free
# the cells (arch, mode) that run one step, under the profiler, as their
# cold and warm step: HuBERT's train step takes ~3.6 s on the device (busy
# 0.94), its cold and warm steps agreed within 1 % on the H100, and the
# profiler's cost is within a few per cent
DRY_ONE_STEP = ((HUBERT_ARCH, "train"),)


def dry_cell(arch: str, shape, rec: dict, device, seed: int) -> dict:
    """Build the cell on the card from seeded weights, reset the peak
    before its first input, run one cold and one warm step of the dry
    run's own step function, and hold the peak and the warm step against
    the prediction; one more warm step under the profiler gives the
    device's busy share (a cell of DRY_ONE_STEP runs its profiled step
    alone, as its cold and its warm step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_one_card_mesh
    from repro_torch.launch.steps import jit_for_cell

    cfg = get_config(arch)
    step = jit_for_cell(cfg, shape, make_one_card_mesh(device))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = dry_inputs(cfg, shape, device, seed)
    one_step = (arch, shape.mode) in DRY_ONE_STEP
    if not one_step:
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        del out
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    del out, args
    if one_step:
        cold = warm = wall
    dev = 1e-6 * sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    predicted = rec["memory_per_device_bytes"]
    tol = DRY_TOL_BYTES + DRY_TOL * predicted
    bound = max(rec["t_compute_s"], rec["t_memory_s"])
    floor = rec["argument_bytes"] / HBM_RATE
    return {"predicted_peak_gib": predicted / 2 ** 30, "measured_peak_gib": peak / 2 ** 30,
            "diff_gib": (peak - predicted) / 2 ** 30, "tol_gib": tol / 2 ** 30,
            "cold_step_s": cold, "warm_step_s": warm, "one_profiled_step": one_step, "bound_s": bound,
            "roofline_fraction": bound / warm, "arguments_read_s": floor,
            "arguments_fraction": max(bound, floor) / warm,
            "profiled_step": {"wall_s": wall, "device_s": dev if dev else "not measured",
                              "busy_share": dev / wall if dev else "not measured"},
            "within_tol": abs(peak - predicted) <= tol}


def dryrun_path(device, seed: int, records: dict) -> dict:
    """Phase 11: each cell's one-card dry run on the host (taken from
    ``records`` by :func:`cell_name` where an earlier phase traced it), its
    prediction logged, then the cell on the card (``dry_cell``)."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for arch, shape in dry_cells():
        name = cell_name(arch, shape)
        rec = records[name] if name in records else dry_record(arch, shape, device)
        pred = {k: rec[k] for k in ("memory_per_device_bytes", "argument_bytes", "t_compute_s", "t_memory_s",
                                   "t_memory_hlo_s", "bottleneck", "fits_hbm_80g", "aten_ops", "trace_s")}
        pred["flops_tflop"] = {k: v / 1e12 for k, v in rec["flops_by_dtype"].items()}
        log(f"dryrun predict {name}: " + json.dumps(pred))
        free = torch.cuda.mem_get_info(device)[0]
        if rec["memory_per_device_bytes"] + DRY_SPARE > free:
            check(arch == SSM_HYBRID, f"dryrun {name}: predicted not to fit the card")
            log(f"dryrun {name}: skipped: the prediction {rec['memory_per_device_bytes'] / 2 ** 30:.2f} GiB "
                f"+ {DRY_SPARE / 2 ** 30:.0f} GiB spare exceeds {free / 2 ** 30:.2f} GiB free")
            continue
        got = dry_cell(arch, shape, rec, device, seed)
        out[name] = got
        log(f"dryrun {name}: " + json.dumps({**got, "card": card_line()}))
        check(got["within_tol"], f"dryrun {name}: measured peak {got['measured_peak_gib']:.3f} GiB, "
              f"predicted {got['predicted_peak_gib']:.3f} GiB (tol {got['tol_gib']:.3f})")
    log(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: training, MoE expert parallelism and a decode cell on a
# ("data", "model") DeviceMesh of the one card, its devices repeated
# ---------------------------------------------------------------------------

def _mesh(shape, device):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), devices=[device])


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def grads_against(mesh_grads: dict, one: dict, device) -> float:
    """(the largest ‖g_mesh − g_one‖ / ‖g_one‖ over the leaves, its
    leaf), the mesh's f32 shards gathered on the card."""
    import torch

    from repro_torch.launch.steps import gather

    worst = (0.0, None)
    for n, g in one.items():
        d = (gather(mesh_grads[n], device) - g.float()).norm() / torch.clamp(g.float().norm(), min=1e-30)
        worst = max(worst, (float(d), n), key=lambda w: w[0])
    return worst


def timed_step(trainer, state, batch) -> tuple:
    """One warm step: (state, metrics, wall s, CUDA-event ms)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    state, met = trainer.step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return state, met, time.perf_counter() - t, start.elapsed_time(end)


def step_breakdown(trainer, state, batch) -> tuple:
    """One more mesh step with the wall seconds of its parts (each part's
    device work synchronised at its ends): the parameters' gathers, each
    leaf's grad reduction, the clip, AdamW; the rest of the step is the
    programs' forward and the backward.  Returns (state, {part: s})."""
    import torch

    from repro_torch.launch import spmd

    parts = {"gather_params": 0.0, "reduce_grads": 0.0, "mesh_clip": 0.0, "mesh_adamw": 0.0}
    names = {"gather_params": "gather_params", "reduce_grads": "_reduce_grads", "mesh_clip": "mesh_clip",
             "mesh_adamw": "mesh_adamw"}
    saved = {k: getattr(spmd, v) for k, v in names.items()}

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[key] += time.perf_counter() - t
            return out

        return wrapper

    for k, v in names.items():
        setattr(spmd, v, timed(k, saved[k]))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        for k, v in names.items():
            setattr(spmd, v, saved[k])
    parts["forward_backward_and_rest"] = total - sum(parts.values())
    return state, {"step_s": total, **parts}


def mesh_train_check(device, seed: int, dtype: str, layers: int | None, tmp: str) -> dict:
    """(a) One Trainer step on MESH_SHAPE from the same state and batch as
    the one-card Trainer's: loss, grad norm and every leaf's grads held
    at MESH_TOL[dtype]; with ``layers`` None (full depth, bf16) also a
    warm step of each timed, the mesh step's ledger, and the reshards of
    MESH_RESHARDS, every parameter and moment to the bit and a step on
    each."""
    import torch

    from repro_torch.launch import spmd
    from repro_torch.launch.steps import gather
    from repro_torch.models import loss_and_grads
    from repro_torch.train import Trainer, TrainerConfig

    cfg = _train_cfg(layers, dtype)
    B, S = MESH_TRAIN
    tcfg = TrainerConfig(lr=TRAIN_CHECK_LR, warmup_steps=0, micro_batch=B, seq_len=S, seed=seed, ckpt_dir=tmp)
    mesh = _mesh(MESH_SHAPE, device)
    one, tr = Trainer(cfg, tcfg, device=device), Trainer(cfg, tcfg, mesh=mesh)
    s1 = one.init_state(seed)
    s2 = tr.place_state(s1)
    batch = one.batch_at(0)
    _, _, g1 = loss_and_grads(s1["params"], batch, cfg, tcfg.aux_weight)
    _, _, g2 = spmd.mesh_grads(cfg, mesh, s2["params"], batch, aux_weight=tcfg.aux_weight)
    grad_err, grad_leaf = grads_against(g2, g1, device)
    del g1, g2
    s1, m1 = one.step(s1, batch)
    s2, m2 = tr.step(s2, batch)
    loss_tol, norm_tol, grad_tol = MESH_TOL[dtype]
    out = {"dtype": dtype, "layers": cfg.num_layers, "mesh": list(MESH_SHAPE), "B": B, "S": S,
           "loss": float(m1["loss"]), "rel_loss": _rel(float(m2["loss"]), float(m1["loss"])),
           "rel_grad_norm": _rel(float(m2["grad_norm"]), float(m1["grad_norm"])),
           "max_grad_rel_norm": grad_err, "max_grad_rel_norm_leaf": grad_leaf, "tol": {"loss": loss_tol, "grad_norm": norm_tol, "grads": grad_tol}}
    check(out["rel_loss"] <= loss_tol, f"mesh train {dtype}: loss rel {out['rel_loss']:.2e} > {loss_tol}")
    check(out["rel_grad_norm"] <= norm_tol, f"mesh train {dtype}: grad norm rel {out['rel_grad_norm']:.2e}")
    check(grad_err <= grad_tol, f"mesh train {dtype}: a leaf's grads differ by {grad_err:.2e} of its norm")
    if layers is not None:
        return out
    # a warm step each, timed; the mesh step's collectives
    _, _, one_wall, one_ms = timed_step(one, s1, one.batch_at(1))
    del s1
    free_cuda()
    with mesh.recording() as ledger:
        s2, _, mesh_wall, mesh_ms = timed_step(tr, s2, tr.batch_at(1))
    out["warm_step"] = {"one_card_wall_s": one_wall, "one_card_event_ms": one_ms, "mesh_wall_s": mesh_wall,
                        "mesh_event_ms": mesh_ms, "wall_ratio": mesh_wall / one_wall,
                        "event_ratio": mesh_ms / one_ms}
    out["ledger"] = ledger.as_dict()
    s2, out["warm_step_parts_s"] = step_breakdown(tr, s2, tr.batch_at(2))
    # reshard: every parameter and moment keeps its bits; a step on each
    out["reshards"] = []
    for shape in MESH_RESHARDS:
        new_mesh = _mesh(shape, device)
        t = time.perf_counter()
        new = tr.reshard(s2, new_mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        same = all(torch.equal(gather(a, device), gather(b, device))
                   for old_d, new_d in ((s2["params"], new["params"]), (s2["opt"].m, new["opt"].m),
                                        (s2["opt"].v, new["opt"].v))
                   for a, b in ((old_d[n], new_d[n]) for n in old_d))
        same = same and torch.equal(gather(s2["opt"].step, device), gather(new["opt"].step, device))
        s2 = new
        free_cuda()
        s2, met, wall, ms = timed_step(tr, s2, tr.batch_at(3))
        rec = {"mesh": list(shape), "reshard_s": secs, "bits_equal": same, "loss": float(met["loss"]),
               "step_wall_s": wall, "step_event_ms": ms}
        out["reshards"].append(rec)
        check(same, f"mesh reshard to {shape}: a parameter or moment changed")
        check(bool(np.isfinite(rec["loss"])), f"mesh reshard to {shape}: the next step's loss is not finite")
    return out


def _olmoe_mesh_cfg(dtype: str, **overrides):
    from repro_torch.configs import get_config

    cfg = get_config(OLMOE_ARCH)
    return dataclasses.replace(cfg, num_layers=MESH_OLMOE_LAYERS, dtype=dtype, **overrides)


def mesh_moe_check(device, seed: int) -> dict:
    """(b) OLMoE-1B-7B at full width, MESH_OLMOE_LAYERS layers: the f32
    EP forward on MESH_SHAPE (capacity factor 64: no drop) against the
    forward with no mesh; then a bf16 train cell's step on the mesh (EP at
    the default capacity): a finite loss and every model rank's expert
    moments moved."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import spmd
    from repro_torch.launch.steps import jit_for_cell
    from repro_torch.models import forward, init_params
    from repro_torch.models.moe import expert_parallel
    from repro_torch.models.sharding import activation_mesh
    from repro_torch.train import Trainer

    mesh = _mesh(MESH_SHAPE, device)
    B, S = MESH_OLMOE_BATCH
    cfg32 = _olmoe_mesh_cfg("float32", capacity_factor=64.0)
    check(expert_parallel(cfg32, mesh) == MESH_SHAPE[1], "mesh moe: the EP branch does not apply")
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg32.vocab_size, (B, S), generator=g, device=device, dtype=torch.int32)
    params = init_params(seed, cfg32, device=device)
    t = time.perf_counter()
    want, aux = forward(params, {"tokens": tokens}, cfg32)
    with mesh.recording() as ledger, activation_mesh(mesh, ("data",)):
        got, aux_ep = forward(params, {"tokens": tokens}, cfg32)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    out = {"layers": cfg32.num_layers, "experts": cfg32.num_experts, "top_k": cfg32.top_k,
           "experts_a_rank": cfg32.num_experts // MESH_SHAPE[1], "B": B, "S": S,
           "f32_forward_max_abs_diff": err, "logits_max_abs": scale,
           "aux_abs_diff": abs(float(aux_ep) - float(aux)), "forward_ledger": ledger.as_dict(), "forwards_s": fwd_s}
    del params, want, got
    free_cuda()
    check(err <= 1e-5 * max(1.0, scale), f"mesh moe: the f32 EP forward differs by {err:.2e}")
    check(out["aux_abs_diff"] <= 1e-6, f"mesh moe: the EP aux differs by {out['aux_abs_diff']:.2e}")
    cfg16 = _olmoe_mesh_cfg("bfloat16")
    step = jit_for_cell(cfg16, ShapeSpec(f"train_{B}x{S}", S, B, "train"), mesh)
    state = spmd.place_state(cfg16, Trainer.state_from_params(init_params(seed + 1, cfg16, device=device)), mesh)
    labels = torch.randint(0, cfg16.vocab_size, (B, S), generator=g, device=device, dtype=torch.int32)
    t = time.perf_counter()
    with mesh.recording() as ledger:
        state, met = step(state, {"tokens": tokens, "labels": labels})
    torch.cuda.synchronize()
    moved = {r: all(float(m.parts[0, r].abs().sum()) > 0 for n, m in state["opt"].m.items()
                    if n.endswith(("ffn.w_gate", "ffn.w_up", "ffn.w_down")))
             for r in range(MESH_SHAPE[1])}
    out.update({"bf16_step_loss": float(met["loss"]), "bf16_step_grad_norm": float(met["grad_norm"]),
                "bf16_step_s": time.perf_counter() - t, "expert_moments_moved_by_rank": moved,
                "step_ledger": ledger.as_dict()})
    del state
    free_cuda()
    check(bool(np.isfinite(out["bf16_step_loss"])), "mesh moe: the bf16 step's loss is not finite")
    check(all(moved.values()), f"mesh moe: a model rank's expert grads are zero: {moved}")
    return out


def mesh_dryrun_check(train: dict, moe: dict) -> dict:
    """(e) The dry run's trace (``launch.dryrun.mesh_trace``: the cell's
    step on a mesh of ``meta`` devices, program 0 standing for the others)
    of (a)'s TinyLlama step and (b)'s OLMoE step on MESH_SHAPE: each
    ledger equal to the one the card's step recorded, calls and bytes per
    primitive, exactly; and the collective term of (a)'s step at NVLink's
    450 GB/s, a prediction from the data sheet (nothing crosses cards on
    this machine), beside the card's name and power limit."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.roofline.analysis import LINK_BW, collective_bytes

    logical = LogicalMesh(("data", "model"), np.arange(int(np.prod(MESH_SHAPE))).reshape(MESH_SHAPE))
    out = {"mesh": list(MESH_SHAPE), "card": card_line(),
           "prediction": f"data sheet: NVLink 4 at {LINK_BW / 1e9:.0f} GB/s a direction; nothing crosses "
                         "cards on this machine"}
    (B, S), (ob, os_) = MESH_TRAIN, MESH_OLMOE_BATCH
    cells = (("tinyllama", _train_cfg(None, "bfloat16"), ShapeSpec(f"train_{B}x{S}", S, B, "train"), train["ledger"]),
             ("olmoe", _olmoe_mesh_cfg("bfloat16"), ShapeSpec(f"train_{ob}x{os_}", os_, ob, "train"),
              moe["step_ledger"]))
    for name, cfg, shape, card in cells:
        rec, _ = dryrun.mesh_trace(cfg, shape, logical)
        ledger, hlo = rec["ledger"], collective_bytes(rec["collectives"])
        ring = sum(ledger["bytes"].values())
        out[name] = {"counts": ledger["counts"], "bytes": ledger["bytes"], "ring_bytes": ring,
                     "ring_ms": 1e3 * ring / LINK_BW, "hlo_bytes": hlo["total"],
                     "t_collective_ms": 1e3 * hlo["total"] / LINK_BW, "trace_s": rec["trace_s"],
                     "mesh_trace_s": rec["mesh_trace_s"],
                     "equal_to_card": ledger["counts"] == card["counts"] and ledger["bytes"] == card["bytes"]}
        check(out[name]["equal_to_card"], f"mesh dryrun {name}: the meta ledger {ledger['counts']} "
              f"{ledger['bytes']} differs from the card's {card['counts']} {card['bytes']}")
    return out


def _band_equal(got, want, band: float) -> tuple[int, int]:
    """(positions, positions in the band): the argmaxes must agree outside
    the top-2 margin band."""
    import torch

    top2 = torch.topk(want, 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= band
    differ = got.argmax(-1) != want.argmax(-1)
    check(not bool((differ & ~near).any()), "mesh decode: a token differs outside the argmax band")
    return int(want.shape[0]), int(near.sum())


def mesh_decode_check(device, seed: int) -> dict:
    """(c) TinyLlama-1.1B f32 on MESH_SHAPE: the decode CellStep (dense
    cache) against the one-card CellStep over MESH_DECODE's steps; the
    paged prefill (row 22) and decode step (row 21) run as each data
    shard's program on its slots against the one-card steps on all; the
    prefill CellStep with the flash forward (row 20) on the mesh against
    the one-card one.  Logits and pools within 1e-4, tokens equal outside
    the 1e-3 argmax band; each data shard's launches read from
    ``LAUNCHES.scoped_counts()``."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_one_card_mesh
    from repro_torch.launch.steps import jit_for_cell
    from repro_torch.models import decode_step_paged, init_cache, init_paged_cache, init_params, prefill_paged

    B, S, steps = MESH_DECODE
    cfg = _train_cfg(None, "float32")
    mesh, one = _mesh(MESH_SHAPE, device), make_one_card_mesh(device)
    params = init_params(seed, cfg, device=device)
    placed = spmd.place_params(cfg, params, mesh)
    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.randint(0, S - steps - 1, (B,), generator=g, device=device, dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=device, dtype=torch.int32)
    shape = ShapeSpec(f"decode_{B}x{S}", S, B, "decode")
    cell1, cellm = jit_for_cell(cfg, shape, one), jit_for_cell(cfg, shape, mesh)
    c1, cm = init_cache(cfg, B, S, device=device), init_cache(cfg, B, S, device=device)
    diff, checked, in_band = 0.0, 0, 0
    for _ in range(steps):
        want, c1 = cell1(params, tok, c1, pos)
        got, cm = cellm(placed, tok, cm, pos)
        diff = max(diff, float((got - want).abs().max()))
        n, near = _band_equal(got, want, GATE_BAND)
        checked, in_band = checked + n, in_band + near
        tok, pos = want.argmax(-1, keepdim=True).to(torch.int32), pos + 1
    cache_diff = max(float((a - b).abs().max()) for a, b in zip(c1["blocks"].values(), cm["blocks"].values()))
    out = {"cell": {"B": B, "S": S, "steps": steps, "max_abs_diff": diff, "cache_max_abs_diff": cache_diff,
                    "tokens": checked, "in_band": in_band}}
    check(diff <= 1e-4, f"mesh decode cell: logits differ by {diff:.2e}")
    check(cache_diff <= 1e-4, f"mesh decode cell: caches differ by {cache_diff:.2e}")
    del c1, cm
    # the paged steps (rows 22 and 21): each data shard's program prefills
    # its slots' prompts, then decodes a token, over its slots' pages of one
    # pool (a slot's pages are its own)
    ps, T = 16, MESH_PAGED_PROMPT
    mp = S // ps
    n_new = torch.randint(T // 4, T + 1, (B,), generator=g, device=device, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=device, dtype=torch.int32)
    pos0 = torch.zeros(B, dtype=torch.int32, device=device)
    table = (1 + torch.arange(B * mp, device=device, dtype=torch.int32)).reshape(B, mp)
    nxt = prompt.gather(1, (n_new.long() - 1)[:, None])
    pool, pool_m = init_paged_cache(cfg, 1 + B * mp, ps, device=device), init_paged_cache(cfg, 1 + B * mp, ps,
                                                                                          device=device)
    prefill_paged(params, prompt, pool, pos0, n_new, table, cfg, attn_impl="flash")
    want, _ = decode_step_paged(params, nxt, pool, n_new, table, cfg, attn_impl="flash")
    axes = ("data",)
    coords, devices = spmd.programs(mesh, axes)
    lms = [spmd.program_lm(cfg, nd) for nd in spmd.gather_params(cfg, placed, mesh, axes)]
    n = len(coords)
    rows = lambda t, i: t[i * (B // n):(i + 1) * (B // n)]  # noqa: E731

    def paged(p, tk, pz, nn, tb, nx):
        prefill_paged(p, tk, pool_m, pz, nn, tb, cfg, attn_impl="flash")
        return decode_step_paged(p, nx, pool_m, nn, tb, cfg, attn_impl="flash")[0]

    outs = mesh.run(paged, [(lms[i], rows(prompt, i), rows(pos0, i), rows(n_new, i), rows(table, i), rows(nxt, i))
                            for i in range(n)], axes)
    got = torch.cat(outs)
    pdiff = float((got - want).abs().max())
    # page 0 is the trash page: pad tokens' writes land there in any order
    pool_diff = max(float((a[:, 1:] - b[:, 1:]).abs().max())
                    for a, b in zip(pool["blocks"].values(), pool_m["blocks"].values()))
    pn, pnear = _band_equal(got, want, GATE_BAND)
    out["paged"] = {"page_size": ps, "prompt": T, "new_tokens": n_new.tolist(), "max_abs_diff": pdiff,
                    "pool_max_abs_diff": pool_diff, "tokens": pn, "in_band": pnear}
    check(pdiff <= 1e-4 and pool_diff <= 1e-4, f"mesh paged prefill + decode: logits {pdiff:.2e}, pools {pool_diff:.2e}")
    del pool, pool_m, lms
    # the prefill cell with the flash forward (row 20) on every data shard
    cfgk = dataclasses.replace(cfg, use_hilbert_kernels=True)
    pshape = ShapeSpec(f"prefill_{B}x{MESH_PREFILL}", MESH_PREFILL, B, "prefill")
    ptok = torch.randint(0, cfg.vocab_size, (B, MESH_PREFILL), generator=g, device=device, dtype=torch.int32)
    pw = jit_for_cell(cfgk, pshape, one)(params, {"tokens": ptok})
    pg = jit_for_cell(cfgk, pshape, mesh)(placed, {"tokens": ptok})
    fdiff = float((pg - pw).abs().max())
    fn, fnear = _band_equal(pg, pw, GATE_BAND)
    out["prefill"] = {"B": B, "S": MESH_PREFILL, "max_abs_diff": fdiff, "tokens": fn, "in_band": fnear}
    check(fdiff <= 1e-4, f"mesh prefill cell: logits differ by {fdiff:.2e}")
    scoped = {",".join(f"{a}={c}" for a, c in key): counts for key, counts in LAUNCHES.scoped_counts().items()}
    rows_launched = ("sfc_flash_prefill", "sfc_flash_decode", "sfc_flash_attention")
    out["launches_by_data_shard"] = {k: {name: n for name, n in v.items() if name.startswith(rows_launched)}
                                     for k, v in scoped.items()}
    for c in coords:
        k = ",".join(f"{a}={i}" for a, i in zip(axes, c))
        got_l = out["launches_by_data_shard"].get(k, {})
        check(all(got_l.get(name, 0) > 0 for name in rows_launched),
              f"mesh: data shard {k} did not launch each of rows 22, 21, 20: {got_l}")
    del params, placed
    free_cuda()
    return out


def mesh_path(device, seed: int) -> dict:
    """Phase 12: (a) TinyLlama-1.1B's Trainer step on a MESH_SHAPE mesh of
    the one card against the one-card Trainer (bf16 at full size, and the
    f32 gate at MESH_GATE_LAYERS layers), the reshards; (b) OLMoE's EP
    forward and a bf16 step; (e) the dry run's ledgers of (a)'s and (b)'s
    steps against the card's; (c) the decode and prefill cells; (d) the
    times, ledger and peak, beside the card's name and power limit.  With
    every position on one card these are the cost of the single-controller
    layout, not NVLink's."""
    import tempfile

    import torch

    from repro_torch.kernels._build import LAUNCHES

    t_phase = time.perf_counter()
    free_cuda()
    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        train = mesh_train_check(device, seed, "bfloat16", None, tmp)
        free_cuda()
        peak_a = torch.cuda.max_memory_allocated() - held
        log("mesh train tinyllama: " + json.dumps({**train, "peak_allocated_bytes": peak_a,
                                                   "peak_predicted_bytes": MESH_PEAK_PREDICTED}))
        gate = mesh_train_check(device, seed, "float32", MESH_GATE_LAYERS, tmp)
        free_cuda()
        log("check mesh train f32 gate: " + json.dumps(gate))
    moe = mesh_moe_check(device, seed)
    log("mesh moe olmoe: " + json.dumps(moe))
    dry = mesh_dryrun_check(train, moe)
    log("mesh dryrun: " + json.dumps(dry))
    dec = mesh_decode_check(device, seed)
    log("mesh decode tinyllama: " + json.dumps(dec))
    out = {"card": card_line(), "layout": "one card, its devices repeated: the single-controller layout's "
                                          "cost, not NVLink's",
           "warm_step": train["warm_step"], "warm_step_parts_s": train["warm_step_parts_s"],
           "ledger_by_primitive": train["ledger"],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated() - held, "train_peak_bytes": peak_a,
           "peak_predicted_bytes": MESH_PEAK_PREDICTED, "held_before_bytes": held,
           "launches_by_data_shard": dec["launches_by_data_shard"]}
    log("mesh: " + json.dumps(out))
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return {"train": train, "gate": gate, "moe": moe, "dryrun": dry, "decode": dec, **out}


def cholesky_errors(a, L) -> dict:
    """max|L − L₆₄| / max|L₆₄| and ‖L·Lᵀ − A‖_F / ‖A‖_F, in float64 on the
    card, L₆₄ the float64 factor of the same (f32) A."""
    import torch

    a64 = a.double()
    l64 = torch.linalg.cholesky(a64)
    L = L.double()
    out = {
        "factor_rel": float((L - l64).abs().max() / l64.abs().max()),
        "residual_rel": float(torch.linalg.matrix_norm(L @ L.T - a64) / torch.linalg.matrix_norm(a64)),
    }
    del a64, l64, L
    return out


def only_phase(prog, phase: int):
    """The program restricted to one phase's barrier groups: the launches of
    one entry point over all k-blocks of a call."""
    groups = tuple(g for g in prog.params["groups"] if g[0] == phase)
    return dataclasses.replace(prog, params={**prog.params, "groups": groups})


def fw_panel_grids(device) -> dict:
    """The widest grid (table rows, strips) that each FW panel entry was
    launched with at the main path's two calls' blocks, as the launcher
    records it (``program.launched``): the panel launches of one call each,
    on a scratch matrix (the grid does not depend on the values)."""
    import torch
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.floyd_warshall import fw_program

    grids = {}
    for n in FW:
        b, npad = ops._block_and_pad(n, 128, mult=8)
        prog = fw_program("hilbert", npad // b, b, device=device)
        work = torch.full((npad, npad), float("inf"), device=device)
        for phase in (1, 2):
            sub = only_phase(prog, phase)
            launch(sub, work)
            for name, (rows, strips) in sub.launched.items():
                grids[f"n={n} b={b} {name}"] = {"rows": rows, "strips": strips,
                                                "ctas": rows * strips}
        del work
    torch.cuda.synchronize()
    return grids


def time_phased(entry, device, fw_d, fw_dr, ch_a, ch_ar, ch) -> None:
    """Phase 5 of the Floyd–Warshall and Cholesky kernels at the main path's
    shapes (n = 8192, b = 128, hilbert): the whole fused program against
    its plain version once, then each entry point (its launches over all
    k-blocks of one call, on a scratch copy: the kernels' work does not
    depend on the values) with its plain version and bound; then
    sfc_tile_update on the full 64 x 64 tile grid at Kp = 128, and the
    entry points' own times."""
    import torch
    from repro_torch.core import tile_schedule_device
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.cholesky import ENTRY_POINTS as CHOL_ENTRY
    from repro_torch.kernels.cholesky import cholesky_program, cholesky_reference_program
    from repro_torch.kernels.floyd_warshall import ENTRY_POINTS as FW_ENTRY
    from repro_torch.kernels.floyd_warshall import fw_program
    from repro_torch.kernels.matmul import (matmul_program, simt_kernel_info, tile_update_launch,
                                            tile_update_program, tile_update_residency)

    n, b = fw_d.shape[0], 128
    nt = n // b
    per_sm = FP32_PEAK / PEAK_SMS  # one SM's share of the table's FP32 peak
    tile_bytes = 4 * b * b

    def plain_once(prog, x):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prog.plain(prog, x)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    # Floyd-Warshall: (min, +) lane instructions at half the FP32 FLOP rate
    prog = fw_program("hilbert", nt, b, device=device)
    want, fw_plain_ms = plain_once(prog, fw_d.clone())
    got = launch(prog, fw_d.clone())
    fw_err = max_diff(got, want)
    check(torch.equal(got, want), f"fused floyd_warshall {n} vs plain: max diff {fw_err}")
    del got, want
    work = fw_d.clone()
    for phase, name in enumerate(FW_ENTRY):
        sub = only_phase(prog, phase)
        groups = sub.params["groups"]
        ctas = sum(hi - lo for _p, _k, lo, hi in groups)
        ops_ = 2.0 * ctas * b ** 3  # one add and one min per candidate
        if phase == 3:  # trailing: its tiles plus row k and column k, read once
            nbytes = sum(2 * (hi - lo) + 2 * (nt - 1) for _p, _k, lo, hi in groups) * tile_bytes
        else:  # diag: tile in, tile + workspace out; panels: tiles + workspace
            nbytes = sum(2 * (hi - lo) + 1 for _p, _k, lo, hi in groups) * tile_bytes
        # beside the event time, the device time of the launches (their
        # host enqueue is ~10 µs each)
        extra = {"device_ms": sum(kernel_ms(lambda: launch(sub, work), 3).values())}
        if phase == 0:
            extra["bound_one_sm_ms"] = 1e3 * ops_ / (per_sm / 2)
        if phase in (1, 2):  # a CTA a (table row, strip): the widest grid launched
            rows_, extra["strips"] = sub.launched[name]
            extra["ctas_per_launch"] = rows_ * extra["strips"]
        entry(name, lambda: launch(sub, work), lambda: sub.plain(sub, work), None, ops_, FP32_PEAK / 2,
              nbytes, 3, fw_err, extra)
    del work

    # Cholesky: FP32 FMAs (2 flops each)
    prog = cholesky_program("hilbert", nt, b, device=device)
    want, ch_plain_ms = plain_once(prog, ch_a.clone())
    want = want.tril()
    got = launch(prog, ch_a.clone()).tril()
    ch_err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=CHOL_RTOL, atol=CHOL_ATOL)),
          f"fused cholesky {n} vs plain: max err {ch_err}")
    check(torch.equal(got, ch), f"fused cholesky {n}: program != ops.cholesky")
    del got, want
    # sfc_chol_panel on its own, on the main path's panels: the matrix as
    # the fused program leaves it just before the panel launches of k = 0
    # and k = nt / 2, then that launch against _solve_tiles on the same tiles
    groups_all = prog.params["groups"]
    panel_err = panel_rel = 0.0
    for kc in (0, nt // 2):
        at = next(i for i, g in enumerate(groups_all) if g[:2] == (1, kc))
        state = ch_a.clone()
        launch(dataclasses.replace(prog, params={**prog.params, "groups": groups_all[:at]}), state)
        one = dataclasses.replace(prog, params={**prog.params, "groups": groups_all[at:at + 1]})
        got, want = launch(one, state.clone()), one.plain(one, state.clone())
        sl = (slice((kc + 1) * b, None), slice(kc * b, (kc + 1) * b))
        err, scale = float((got[sl] - want[sl]).abs().max()), float(want[sl].abs().max())
        check(bool(torch.allclose(got[sl], want[sl], rtol=PANEL_TOL, atol=PANEL_TOL * scale)),
              f"sfc_chol_panel k={kc} of cholesky {n}: max err {err} at max |X| {scale}")
        check(torch.equal(got[:, (kc + 1) * b:], state[:, (kc + 1) * b:]),
              f"sfc_chol_panel k={kc}: a tile right of the panel changed")
        panel_err, panel_rel = max(panel_err, err), max(panel_rel, err / scale)
        del state, got, want
    log(f"check sfc_chol_panel on the panels of k = 0 and {nt // 2} of cholesky {n}: vs _solve_tiles "
        f"max_abs_err {panel_err:.3e}, {panel_rel:.3e} of max |X| (tol {PANEL_TOL})")
    av, lv = ch_a.view(nt, b, nt, b), ch.view(nt, b, nt, b)
    ar = torch.arange(nt, device=device)
    diag_tiles = av[ar, :, ar, :].contiguous()
    panel = [g for g in prog.params["groups"] if g[0] == 1]
    rows = prog.schedule[torch.cat([torch.arange(lo, hi) for _p, _k, lo, hi in panel]).to(device)].long()
    l_kk = lv[rows[:, 1], :, rows[:, 1], :].contiguous()
    a_ik = av[rows[:, 2], :, rows[:, 3], :].contiguous()
    lib_work = ch_a.clone()

    def trailing_addmm():
        # the trailing update of every k as one in-place addmm_ on the
        # square below and right of block k (TF32 off): the full square,
        # twice the operations of the lower triangle the kernel updates
        for k in range(nt - 1):
            lo = (k + 1) * b
            l21 = ch[lo:, k * b:lo]
            lib_work[lo:, lo:].addmm_(l21, l21.T, alpha=-1.0)

    libraries = {
        0: lambda: torch.linalg.cholesky(diag_tiles),
        1: lambda: torch.linalg.solve_triangular(l_kk.mT, a_ik, upper=True, left=False),
        2: trailing_addmm,
    }
    work = ch_a.clone()
    table = prog.schedule.cpu().numpy()
    ci = prog.params["col_i"]
    for phase, name in enumerate(CHOL_ENTRY):
        sub = only_phase(prog, phase)
        groups = sub.params["groups"]
        ctas = sum(hi - lo for _p, _k, lo, hi in groups)
        # diag: b^3/3 flops per tile; panel: b^3 per tile (b rows, b^2/2
        # FMAs each); trailing: 2 b^3 per off-diagonal tile and b^3 per
        # diagonal one, whose upper half no later step reads (tril zeroes it)
        ops_ = ctas * b ** 3 * (1 / 3, 1.0, 2.0)[phase]
        if phase == 2:
            rows = np.concatenate([table[lo:hi, ci:ci + 2] for _p, _k, lo, hi in groups])
            ops_ -= int((rows[:, 0] == rows[:, 1]).sum()) * b ** 3
        if phase == 2:  # trailing tiles, plus column k's tiles below k, read once
            nbytes = sum(2 * (hi - lo) + (nt - k - 1) for _p, k, lo, hi in groups) * tile_bytes
        else:
            nbytes = sum(2 * (hi - lo) + phase for _p, _k, lo, hi in groups) * tile_bytes
        extra, err = None, ch_err
        if phase == 1:  # the panel's own check, above; CTAs of 32 rows, b / 32 a tile
            err = panel_err
            extra = {"max_rel_err": panel_rel, "ctas": int(ctas) * (b // 32), "tiles": int(ctas)}
        if phase == 0:  # beside the batched call: one library call per tile
            extra = {"bound_one_sm_ms": 1e3 * ops_ / per_sm,
                     "library_single_tiles_ms": cuda_ms(lambda: [torch.linalg.cholesky(t) for t in diag_tiles], 3),
                     "tiles": int(ctas)}
        if phase == 2:  # beside it, the per-k form's trailing updates: the same tiles on sfc_tile_update
            ref_sub = only_phase(cholesky_reference_program("hilbert", nt, b, device=device), 2)
            same = torch.equal(launch(sub, work.clone()), launch(ref_sub, work.clone()))
            check(same, f"cholesky {n}: sfc_chol_trailing and sfc_tile_update differ on the same tiles")
            extra = {"tiles": int(ctas), "library": f"{nt - 1} in-place addmm_ of the full trailing square",
                     "per_k_tile_update_ms": cuda_ms(lambda: launch(ref_sub, work), 3),
                     "equal_to_per_k_tile_update": same}
        entry(name, lambda: launch(sub, work), lambda: sub.plain(sub, work), libraries[phase], ops_,
              FP32_PEAK, nbytes, 3, err, extra)
    del work, lib_work, diag_tiles, l_kk, a_ik

    # sfc_tile_update on the full tile grid, against torch.addmm
    kp = 128
    rng = np.random.default_rng(12)
    o = torch.as_tensor(rng.standard_normal((n, n), dtype=np.float32), device=device)
    a = torch.as_tensor(rng.standard_normal((n, kp), dtype=np.float32), device=device)
    bb = torch.as_tensor(rng.standard_normal((n, kp), dtype=np.float32), device=device)
    tu = tile_update_program(tile_schedule_device("hilbert", (nt, nt), device=device), o, a, bb,
                             bm=b, bn=b, alpha=-1.0)
    got, want = launch(tu, o.clone(), a, bb), tu.plain(tu, o.clone(), a, bb)
    tu_err, tu_tol = float((got - want).abs().max()), 1e-4 * kp ** 0.5
    check(tu_err <= tu_tol, f"sfc_tile_update {n}^2 Kp={kp} vs plain: max err {tu_err} > {tu_tol}")
    # the chain to the bit: each element __fmaf_rn over k ascending from 0
    # (sfc_matmul f32's chain too), times alpha, added to O, rounded apart
    prod = launch(matmul_program(tile_schedule_device("row", (nt, nt), device=device), a,
                                 bb.T.contiguous(), bm=b, bn=b, bk=kp), a, bb.T.contiguous())
    chain = torch.equal(got, o + prod * -1.0)
    check(chain, f"sfc_tile_update {n}^2 Kp={kp}: not O - sfc_matmul(A, B^T) to the bit")
    del got, want, prod
    grid = tile_update_launch(nt * nt, *tile_update_residency(device.index))
    smem = simt_kernel_info()["sfc_tile_update"]["smem_bytes"]
    entry("sfc_tile_update", lambda: launch(tu, o, a, bb), lambda: tu.plain(tu, o, a, bb),
          lambda: torch.addmm(o, a, bb.T, alpha=-1.0), 2.0 * n * n * kp, FP32_PEAK,
          4 * (2 * n * n + 2 * n * kp), 5, tu_err,
          {"equal_to_the_matmul_chain": chain, "tiles": nt * nt, "persistent_ctas": grid, "smem_bytes": smem})
    del o, a, bb

    # the entry points end to end (each copies its input once)
    fb, fpad = ops._block_and_pad(fw_dr.shape[0], 128, mult=8)
    cb, cpad = ops._block_and_pad(ch_ar.shape[0], 128, mult=8)
    apps = {
        f"floyd_warshall {n}": {
            "fused_ms": cuda_ms(lambda: ops.floyd_warshall(fw_d), 3),
            "per_k_ms": cuda_ms(lambda: ops.floyd_warshall(fw_d, fused=False), 3),
            "plain_ms": fw_plain_ms, "library_ms": None,
            "bound_ms": 1e3 * 2.0 * n ** 3 / (FP32_PEAK / 2),
        },
        f"floyd_warshall {fw_dr.shape[0]} (b={fb}, padded to {fpad})": {
            "fused_ms": cuda_ms(lambda: ops.floyd_warshall(fw_dr), 3),
            "bound_ms": 1e3 * 2.0 * fpad ** 3 / (FP32_PEAK / 2),
        },
        f"cholesky {n}": {
            "fused_ms": cuda_ms(lambda: ops.cholesky(ch_a), 3),
            "per_k_ms": cuda_ms(lambda: ops.cholesky(ch_a, fused=False), 3),
            "plain_ms": ch_plain_ms, "library_ms": cuda_ms(lambda: torch.linalg.cholesky(ch_a), 3),
            "bound_ms": 1e3 * n ** 3 / 3 / FP32_PEAK,
        },
        f"cholesky {ch_ar.shape[0]} (b={cb}, padded to {cpad})": {
            "fused_ms": cuda_ms(lambda: ops.cholesky(ch_ar), 3),
            "library_ms": cuda_ms(lambda: torch.linalg.cholesky(ch_ar), 3),
            "bound_ms": 1e3 * cpad ** 3 / 3 / FP32_PEAK,
        },
    }
    log("apps: " + json.dumps(apps))


def profile_calls(calls: dict) -> list:
    """Run each call once more under torch.profiler and print its wall
    time, the device time of the kernels it ran (one stream, so their sum
    is the device's busy time), the busy share, and the top kernels;
    returns the printed records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = []
    for name, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        dev = 1e-3 * sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out.append({
            "call": name, "wall_ms": wall,
            "device_ms": dev if kernels else "not measured",
            "busy_share": dev / wall if kernels else "not measured",
            "top": [[e.key[:60], 1e-3 * e.self_device_time_total, e.count] for e in top],
        })
        log("profile: " + json.dumps(out[-1]))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="build and compare only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(card_line())
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower() or line.startswith("=="):
            log("  " + line.strip())
    from repro_torch.kernels.attention import latent_kernel_info, tiled_kernel_info, wgmma_kernel_info
    from repro_torch.kernels.floyd_warshall import fw_kernel_info
    from repro_torch.kernels.kmeans import kmeans_kernel_info
    from repro_torch.kernels.matmul import simt_kernel_info
    from repro_torch.kernels.simjoin import simjoin_kernel_info

    log("simt kernels: " + json.dumps(simt_kernel_info()))
    log("kmeans kernels: " + json.dumps(kmeans_kernel_info()))
    log("simjoin kernels: " + json.dumps(simjoin_kernel_info()))
    log("flash tiled kernels: " + json.dumps(tiled_kernel_info()))
    log("flash wgmma kernels: " + json.dumps(wgmma_kernel_info()))
    log("flash latent kernels: " + json.dumps(latent_kernel_info()))
    log("fw kernels: " + json.dumps(fw_kernel_info()))
    log("fw panel grid: " + json.dumps(fw_panel_grids(device)))
    rng = np.random.default_rng(args.seed)
    compare_kernels(rng, device)
    compare_phased(np.random.default_rng(args.seed + 1), device)
    compare_reference(np.random.default_rng(args.seed + 2), device)
    compare_sharded(np.random.default_rng(args.seed + 4), device)
    if args.quick:
        compare_attention(np.random.default_rng(args.seed + 3), device)
        compare_latent(np.random.default_rng(args.seed + 5), device)
        compare_d80(np.random.default_rng(args.seed + 6), device)
        compare_mha(np.random.default_rng(args.seed + 7), device)
        for i, m in enumerate((QWEN, MINITRON, STABLELM, CHAMELEON)):
            compare_cohort(np.random.default_rng(args.seed + 8 + 2 * i), device, m.inputs, m.cfg("float32"), m.rows)
        compare_full_d80(np.random.default_rng(args.seed + 9), device)
        return 0
    t = time.perf_counter()
    result, ctx = main_path(rng, device, args.seed)
    log(f"main path phases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    result["kernels"] += serving_path(np.random.default_rng(args.seed + 3), device, args.seed)
    log(f"serving phase: {time.perf_counter() - t:.1f} s")
    result["kernels"] += mla_serving_path(np.random.default_rng(args.seed + 5), device, args.seed)
    result["kernels"] += ssm_serving_path(np.random.default_rng(args.seed + 6), device, args.seed)
    result["kernels"] += olmoe_serving_path(np.random.default_rng(args.seed + 7), device, args.seed)
    result["kernels"] += dense_serving_path(QWEN, np.random.default_rng(args.seed + 8), device, args.seed)
    result["kernels"] += hubert_path(np.random.default_rng(args.seed + 9), device, args.seed)
    result["kernels"] += dense_serving_path(MINITRON, np.random.default_rng(args.seed + 10), device, args.seed)
    result["kernels"] += dense_serving_path(STABLELM, np.random.default_rng(args.seed + 12), device, args.seed)
    result["kernels"] += dense_serving_path(CHAMELEON, np.random.default_rng(args.seed + 14), device, args.seed)
    result["kernels"] += sharded_path(device, args.seed, ctx)
    train_cell = dry_cells()[2]
    train_rec = dry_record(*train_cell, device)
    training_path(device, args.seed, train_rec)
    autotune_path(device, args.seed, ctx)
    del ctx
    dryrun_path(device, args.seed, {cell_name(*train_cell): train_rec})
    mesh_path(device, args.seed)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s, the build included")
    log("slowest waits between log lines (s, the line that ended each): " + json.dumps(TIMELINE.slowest(40)))
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
