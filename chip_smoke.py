#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py [--out results.json]

To compare two checkouts on one card, ``--kernels-only --src DIR`` runs
only phase 3 (every kernel entry's checks and times) and the three paged
profiles of phase 4 on the ``repro_torch`` under DIR, and prints no
result line. ``--sharded-only`` builds the kernels and runs only phase 17;
on a machine with a card for every rank (four), its ranks take a card each
over nccl. It prints no result line either, nor does ``--train-only``,
which builds the kernels and runs only phase 18, nor
``--shard-paths-only``, which builds them and runs only phase 20, nor
``--sync-audit-only``, which builds them and runs only phase 21, nor
``--head256-only``, which builds them, runs phase 3's head-width-256
cases and phase 22, nor ``--wide-heads-only``, which builds them, prints
the head-width-384 and -512 instances' ptxas report, runs phase 3's cases
at those widths and phase 23, nor ``--wider-heads-only``, which builds
them, prints the width-generic instances' ptxas report, runs phase 3's
cases above head width 512 and phase 27, nor ``--tiers-only``, which
builds them and runs only phase 25, nor ``--sweeps-only``, which builds
them and runs phase 17 (whose ranks serve phase 26's rank cells) and
phase 26, nor ``--graphs-only``, which builds them and runs phase 28
(serving phase 4's captured runs itself first).

The engines capture the blocks the reference compiles with ``jax.jit``
as CUDA graphs on the card by default (``serving.graphs``): the
continuous engine's decode block, prefill chunk and verify pass, the
static engine's greedy K-step block and sampled one-token step, and the
model draft's prefill chunk, catch-up pass and propose block. So every
phase that serves the continuous engine at one shard (4, 6, 7, 19, 21,
22, 23, 25, 26 and 27), the static engine (5, 7, 8-16, 19, 21, 22, 23,
24 and 27) or the model draft (4 and 26) replays them; the head-sharded
engines of phase 17 cannot capture (``serving.graphs.capture_refusal``),
and phase 28 holds the captured blocks against eager ones.

Phases (any failure exits non-zero before the result line):
  1. needs CUDA; prints the card's name and power limit (nvidia-smi);
     TF32 off for f32 matmuls and convolutions.
  2. builds the four attention kernels from ``src/repro_torch/kernels/
     csrc`` (nvcc, one process a source, in parallel) and prints the build
     time and ptxas report, and the paged decode's registers, shared
     memory and spills for its pass 1 (the main path's instance on its
     own) and its combine; counts the tensor-core (HMMA) instructions in
     the flash and chunk libraries' bf16/f16 kernels (cuobjdump -sass),
     which must hold some (64 in each dh=128 flash kernel), and checks
     that the paged decode library is built anew from its split-K header
     (not the library of its earlier body); prints every library's
     head-width-256, -384 and -512 instances by kernel template
     (registers, shared memory, spill stores; each library must hold
     some at each width), and its width-generic instances (every multiple
     of 128 above 512: ``wide_ptxas``; each library must hold some, and
     the chunk and flash libraries' tensor-core ones HMMA).
  3. holds each kernel entry against its plain PyTorch version on the card
     and times kernel, plain version and, as a yardstick only,
     ``F.scaled_dot_product_attention``; prints each kernel's bound (bytes
     over 3.35 TB/s or operations over the type's peak, whichever is
     larger). Paged entries at page 16 for head_dim 64 (group 1 and 4) and
     at qwen2.5-3b's width (head_dim 128, group 8): ragged lengths up to
     576 over a shuffled page table with stale entries; a 64-token chunk
     with scalar and per-sequence start; the speculative verify window at
     C = 1, 2, 4, 5, 8 with ragged fed lengths and an inactive row on the
     null page; decode at B=16 with seq_lens at 1, the full table and on
     and beside each edge of the paged decode's split (paged_split);
     chunks and C=5 windows whose frontiers fall on and beside the chunk
     kernel's split edges (right-padded chunks); f32, bf16, f16 and int8
     pools (SDPA on the gathered dense KV). Each decode case also times
     the chunk kernel's C=1 verify route on the same inputs (the same
     function; the port never takes it for decode) as a second
     yardstick.
     Dense decode (split-K) at B=4, H=16, Hkv=2, dh=128, L=545, ragged
     kv_valid, f32, bf16, f16 and int8 (at least 132 pass-1 blocks), with
     kv_valid at 1, L and the split boundaries +-1, at B=32 with Hkv=8
     (where only the 128-key cap splits the cache), plus a dh=64 group-1
     case (SDPA with a length mask).
     Flash attention at B=4, H=16, Hkv 2 and 16, dh=128, causal and full:
     bf16 and f16 (tensor-core tiles) at S = 1, 17, 64, 256, 300 and 512,
     f32 at 256, 300 and 512 (SDPA with enable_gqa). At arctic-480b's
     width (H=56, Hkv=8, dh=128, GQA group 7), bf16 and int8: paged
     decode (B=8 ragged, B=16 on the split edges), the chunk at a scalar
     and a per-sequence start, the C=5 verify window, dense decode (B=4
     ragged, B=12 on the split edges), and flash (bf16) at S = 17, 300 and
     512, causal and full. At the VLM widths: dense decode at
     llava15-13b's (B=4, H = Hkv = 40, L=1,121, fp16 and int8; B=1 over
     a 32,256-position cache) and paligemma-3b's (B=4, H=8, Hkv=1,
     dh=256, L=545, f32/bf16/f16/int8, ragged and at B=12 on the split
     edges); flash at llava's (B=4, S=1,088, group 1, fp16, causal and
     full). At llama3.2-1b's width as phase 19 (f)'s static engine serves
     it (H = Hkv = 32, dh=64, bf16): flash (causal) on its longest wave
     (B=1, S=60) and its widest (B=2, S=11), and the dense decode over
     their caches (L = 77 and 28, ragged; B=12 at L=77 on the split
     edges). At head width 256 (``head256_cases``): the paged entries at
     paligemma-3b's width (H=8, Hkv=1, group 8; verify C = 1, 5, 8) and
     gemma3-1b's (H=4, group 4; C=5) over pages of 32 keys, f32, bf16 and
     f16 queries over their own pool and bf16 and f16 over int8, ragged,
     on the split edges and with chunk and window frontiers on them;
     flash (B=4) at group 8, bf16 at S = 512, 300, 17, f16 and f32 at
     300, and group 4, bf16 and f32 at 300, causal and full. At head
     widths 384 and 512 (``wide_cases``), at groups 8 and 4 over one KV
     head: the paged entries over pages of 32 keys as at 256 (verify C =
     1, 5, 8 at dh 512 group 4, the served width, else C = 5), the dense
     decode (L=545; B=4 ragged, B=12 on the split edges; f32, bf16, f16,
     int8 with bf16 and with f16 queries) and flash (B=4; bf16 at S =
     512, 300, 17 at the served width, else 300; f16 and f32 at 300;
     causal and full. Above head width 512 (``wider_cases``, the
     width-generic instances), at 640 and 1024 over one KV head at groups
     2 and 8, and at 1024 at group 1 (8 heads over 8 KV heads): the paged
     entries as at 384 and 512 (verify C = 5, 9, 13 at dh 1024 group 2,
     the served width, else C = 5; decode, chunk and window lengths on
     the splits' edges at the new splits), the dense decode (L=545, as at
     512) and flash (B=4; bf16 at S = 512, 300, 17 at the served width,
     else 300; f16 and f32 at 300); at 768 and 2048 at group 2, each
     entry in bf16 over bf16 and over int8 and in f32 (flash bf16 and
     f32 at S=300). Of these only the served width's main-path cases and
     one row a width at 640, 768 and 2048 are timed (``WIDER_MAIN``,
     ``WIDER_ROWS``); the rest are checked only. Every kernel entry must
     give bitwise the same result on a second call.
  4. serves llama3.2-1b at full width (bf16, the port's own seeded init)
     through ``ServeEngine(scheduler="continuous")``: 16 requests of 64-448
     prompt tokens, 8 sharing a 128-token document, 64 new tokens each,
     once with native and once with int8 KV; then, on the same traffic
     and counting the launches of this path on their own, with n-gram
     speculation (k=4), with the target drafting for itself (acceptance
     must reach 0.9 at temperature 0) and twice with sampling
     (temperature 0.8, top-k 50, top-p 0.9, n-gram spec, one
     sample_seed: the two runs must agree). Every run must launch its
     path's kernels, reconcile its trace, free every page and emit
     in-vocabulary tokens. The native run's Chrome trace must pass the
     port's ``check_trace --strict-vocab``. The sampler's counter-based
     draws on the card
     must equal the CPU's, and its tokens follow the filtered softmax.
     Then torch.profiler splits by kernel the time of one fused decode
     block (the paged decode's pass 1 and its combine apart), one prefill
     chunk (B=1, C=64 at start 384) and one verify pass (B=8, C=5), and
     gives the device's busy share of their wall time and the chunk
     kernel's share of the busy time.
  5. serves qwen2.5-3b at full width (bf16, seeded init) through
     ``ServeEngine(scheduler="static", decode_lookahead=8, max_len=640)``:
     serve_bucketed on 4 prompts of 256 and 4 of 512 tokens, 32 new
     tokens each, native and int8 KV. Each run must launch the flash
     kernel 36 times a wave and the dense decode kernel 36 times a
     micro-step, call no plain version, and emit in-vocabulary tokens.
     Then the profiler splits one fused static decode block, with a
     native and with an int8 cache.
  6. in f32 at full width: the kernel path's logits agree with the CPU
     plain path on one prompt; decode_lookahead 8 is token-identical to
     decode_lookahead 1, and n-gram speculation (k=4) to no speculation
     (a divergence is allowed only where the spec-off top-2 logit gap is
     below 1e-4). The same on qwen2.5-3b cut to 4 layers for the static
     path: prefill and decode logits against the CPU, static K=8 == K=1,
     and static == continuous on phase 5's requests (the same near-tie
     allowance).
  7. frees the earlier models and serves arctic-480b (MoE: 128 experts
     top-2 and a dense residual FFN a layer, GQA group 7) at full width
     cut to 2 of its 35 layers (bf16, the port's seeded init, about 55 GB)
     through the continuous engine (8 requests of 64-448 prompt tokens, 4
     sharing a 128-token document, 32 new tokens, streams serialized):
     native, int8 and n-gram spec k=4; and through the static engine
     (serve_bucketed on phase 5's prompts, 16 new tokens), native and
     int8. Each run is made twice and must emit the same tokens both
     times, launch each kernel of its path exactly n_layers times a
     micro-step, prefill chunk, verify pass or wave, call no plain
     version, reconcile its trace and free its pages. Then the MoE FFN on
     the card: ragged == capacity at capacity_factor = E at one full-width
     layer (two bf16 ulps), no host sync in the capacity path (sync debug
     mode "error"), the reduced twin in f32 == the CPU; and one K=8 decode
     block profiled (the expert products' and the attention kernels'
     shares of busy time), then run again with no host sync inside it.
  8. frees arctic and serves llava15-13b at full width and all 40 layers
     (fp16, 12.9 B parameters, 25.8 GB) through the static engine's
     ``generate`` with 576 seeded-normal patch rows before the prompts:
     (a) B=4 x 512 prompt tokens, 32 new; (b) B=1 x 31,616 prompt tokens
     (32,192 positions), 64 new; native and int8, each run twice (the
     same tokens both times), with exactly 40 flash launches a wave, 40
     dense decode launches a micro-step, no plain version and no masked
     attention; prints tokens/s, prefill_s, decode_s, peak allocated
     memory and the decode micro-step against its byte bound; then
     profiles one K=8 decode block over (b)'s cache, native and int8.
  9. paligemma-3b at full width (18 layers, bf16): ``generate`` on 4 x
     (256 patch rows + 256 prompt tokens), 32 new, native and int8, each
     twice: the masked attention 18 times a wave (prefix-LM), the dense
     decode at head width 256 18 times a micro-step, flash never.
  10. gemma3-1b at full width (26 layers, bf16): ``serve_bucketed`` on 4
     prompts of 1,024 and 4 of 2,048 tokens, 32 new, native and int8,
     each twice: every attention is the masked attention (soft-capped;
     26 calls a wave and a micro-step), no kernel launch.
  11. in f32 at full width cut in depth (llava and paligemma 4 layers,
     gemma3 6): prefill and decode logits on the card against the CPU,
     and static K=8 == K=1.
  12. deepseek-v2-236b (MLA, a dense first layer, 160 experts top-6 and
     2 shared) at full width cut to its dense layer and 2 of its 59 MoE
     layers (bf16) through the static engine's ``generate``:
     (a) B=4 x 512 prompt tokens, 32 new, native and int8 (the latent
     cache stays native: the same tokens); (b) B=1 x 32,128 prompt tokens
     (32,192 positions), 64 new. Prints the latent cache's bytes at
     32,192 positions beside llava15-13b's KV there.
  13. mamba2-130m at full width and all 24 layers: (a) 4 x 512, (b) 1 x
     32,768 prompt tokens, 32 new; the state a sequence must be the same
     size in both.
  14. zamba2-2.7b at full width, all 54 blocks and 9 shared-attention
     sites: serve_bucketed on 4 prompts of 512 and 4 of 1,024 tokens, 32
     new (the masked attention 9 times a wave and a micro-step).
  15. whisper-medium at full width, 24 + 24 layers: ``generate`` with
     1,500 seeded-normal frame rows before 4 x 32 prompt tokens, 64 new
     (the masked attention 72 times a wave, 48 a micro-step).
     In 12-15 every run is made twice and must repeat its tokens, launch
     no kernel, call no plain version, call the masked attention exactly
     as counted and emit in-vocabulary tokens; each prints tokens/s,
     prefill_s, decode_s, the decode micro-step against its byte bound
     (the weights a step reads, every expert for deepseek, plus the cache
     it reads, over 3.35 TB/s) and peak memory; and one K=8 decode block
     of each model runs under sync debug mode "error" (no host sync).
  16. in f32 at full width cut in depth (deepseek: the dense layer and 1
     MoE layer with 16 experts; mamba 4 layers; zamba 12 blocks, 2 sites;
     whisper 4 + 4 layers): prefill and decode logits on the card against
     the CPU, and static K=8 == K=1.
  17. head-sharded continuous serving (``ServeEngine(shards=N)``):
     llama3.2-1b at full width cut to 4 of its 16 layers (``CUT_LAYERS``;
     bf16, 32 KV heads, page 16, K=8), 8 of
     phase 4's requests with 32 new tokens, at 2 shards (native, int8,
     n-gram k=4) and at 4 (native), the ranks spawned here
     (``launch.ranks.run_ranks``) and sharing the one card over gloo
     (nccl where every rank has a card). Every rank's tokens must equal a
     shards=1 run's on the same card, its pool bytes be 1/N of them, its
     trace reconcile and its pages be freed; on each rank the paged
     decode, chunk and verify kernels must launch exactly n_layers times a
     micro-step, prefill chunk and verify pass, on pools of Hkv/N heads,
     with no plain version; and a decode step, a prefill chunk and a
     verify window (bf16 and int8) gathered over the head shards must be
     bitwise the whole pool's call. Prints each run's tokens/s and decode
     step, the backend and the rank-to-device map; then checks and times
     the three paged entries at a shard's shapes. The same ranks then
     serve phase 26's shard_sweep cells of their shard count
     (``sweep_rank``): phase 26 spawns no rank group of its own.
  18. training (no kernel is on its path: each entry's launches must stay
     0). (a) llama3.2-1b at full width and depth (1.34 B parameters) in
     f32, remat "block", 4 x 1,024 tokens a step in 2 micro-batches, 8
     AdamW steps (lr 3e-4, warmup 1) through ``build_train_step``: every
     loss and grad_norm finite, the last loss below the first, the params
     f32 beside a separate f32 master, the masked attention called
     n_layers x 2 (forward and remat's recompute) x micro-batches x steps
     times; prints ``[smoke] train llama3.2-1b f32 step_ms=... tokens/s=...
     peak_GB=... flop_bound_ms=...`` (the median of steps 2-7; the bound
     is the step's operations over 67 TFLOP/s f32), then 2 steps in bf16
     (the params stay bf16, each its master's round trip). (b) the same
     8 steps at full width cut to 4 layers (``CUT_LAYERS``): the step-4
     state saved with ``save_checkpoint`` under build/, restored onto the
     CPU and bitwise the card's; ``train()`` resumes from it on the card
     and must repeat the straight run's losses of steps 4-7 (rel 1e-5;
     says whether bitwise). (c) each family's reduced twin in f32, loss
     and every gradient leaf on the card against the CPU, remat == none
     and n_micro 2 == 1 on llama. (d) the reduced llama3.2-1b twin is
     refused on the card with NotImplementedError before any weights are
     drawn (``ServeEngine``, both schedulers, and the serve CLI's
     ``--reduced``); gemma3-1b's twin still serves there.
  19. the analytic model (``repro_torch.core``) against the card. (a)
     the card's own rates, each printed with its name and power limit:
     device-to-device and pinned host-to-device copies of 1 MB to 2 GB
     (median of 10 each; the line's rate and intercept) and the dense
     bf16 rate of an 8192^3 ``torch.matmul``. (b) two H100 hierarchies
     (``core.h100_roofline.h100_hierarchy``): the published figures and
     (a)'s. (c) for every native run whose decode step phases 4-16 record
     (llama continuous, qwen and arctic static, llava (a)/(b), paligemma,
     gemma3, deepseek (a)/(b), mamba (a)/(b), zamba, whisper): the model's
     decode step under both (all weights and KV in HBM, the run's batch,
     positions and depth, 2-byte types) beside the measured step and the
     byte bound; llava (a) and (b) must be within 2% of their bound on
     the published H100. (d) ``paper.beyond_gpu_tiers`` under both, and
     the host-link rate at which llava15-13b holds 10 tokens/s of decode
     at 32k positions with its KV in host DRAM. (e) the cost extractor
     (``core.cost_analysis``, which must refuse a CUDA tensor) on the CPU
     over one full-width llama3.2-1b decode step of phase 4's block
     shape: FLOPs and bytes against ``model_flops_for`` and
     ``decode_compulsory_bytes``, the three roofline terms, the card's
     busy time a step. (f) ``paper.concurrency_sweep``'s runtime halves
     on the card (llama3.2-1b at full width, bf16, seeded init): static
     vs continuous at 2, 4, 8 ragged requests and the shared-document
     stream with the prefix cache off and on (it must dedup pages). Every
     serve, with the counts set to 0 just before it, must launch exactly
     its kernels (flash once a layer a wave and the dense decode once a
     layer a micro-step on the static engine; the chunk kernel once a
     layer a prefill chunk and the paged decode once a layer a micro-step
     on the continuous one) and no plain version. The counters (decode
     steps, preemptions, peak pages, deduped pages, prefill tokens) must
     equal those of the same sweep on the CPU at the reduced twin (the
     same prompt lengths), and every output token must lie within 0.5
     standard deviations of its position's logits of the f32 argmax of
     the same weights on the CPU's plain path, given the tokens before
     it.
  20. the dry run's two sharded paths on the card, and its bytes against
     the card's allocator; no kernel is on either sharded path (the counts
     stay 0 there). (a) llama3.2-1b at full width cut to 4 layers
     (``CUT_LAYERS``), static, B=4 x 512 + 32 steps, a 4,096-position
     cache length-sharded over 2 ranks on the one card (gloo,
     ``models.seq_shard_attn``): in f32 its tokens equal the unsharded
     decode's on the card (the dense decode kernel, a launch a
     layer a step) over the tie-free prefix, logits within 1e-4, and each
     rank's cache slice is bitwise the unsharded cache's at the prefilled
     positions and at layer 0's decoded ones (later layers' decoded KV
     follow attention sums in another order: within 1e-4); the bf16 step
     at N=1, 2 and on the kernel path. (b) arctic-480b at full width cut
     to 2 of 35 layers, 2 ranks each holding 64 of the 128 experts
     (``init_params(experts=)``, ``moe_ffn(impl="shard_map")``): a 4 x 64
     forward's logits and one layer's output within phase 7's two bf16
     ulps of the capacity path here, aux losses within 1e-5, and one EP
     layer's time at T=8. (c) three cells whose dry run on a 1 x 1 mesh
     holds under 70 GB (mamba2-130m long_500k and decode_32k, zamba2-2.7b
     long_500k): the bytes their params, cache and inputs ask the card's
     allocator for equal the dry run's argument bytes, and one real step's
     peak and CUDA-event time beside the dry run's peak and step bound.
  21. the sync audit: ``repro_torch.analysis`` against the syncs the card
     takes. Under ``torch.cuda.set_sync_debug_mode("warn")``, every
     warning's Python stack kept: llama3.2-1b at full width, bf16, on
     phase 4's continuous engine with 4 of its requests and 16 new tokens
     (greedy, then n-gram k=4), and a static ``generate`` (B=2 x 64, 16
     new). One line a sync site (its innermost ``repro_torch`` frame:
     file, line, function; pull, upload or other; the count; the serving
     statement it came from) and ``ServeStats.host_syncs`` beside the
     pulls. Every pull must lie at a site the host-sync rule counts; no
     sync may lie under a ``CAPTURE_ROOTS`` entry unless its site carries
     a justified pragma or baseline entry; each root the runs called runs
     once more, at its first call's arguments, under "error".
  22. head width 256: paligemma-3b's Gemma-2B decoder served as a
     text-only causal LM (``PALI_TEXT``: 18 layers, d_model 2048, 8
     heads over 1 KV head at dh 256) at full width, cut to 6 of its 18
     layers, in bf16: the continuous engine (8 of phase 4's requests, 32
     new, pages of 32; native, int8, n-gram k=4) and the static engine
     (phase 5's waves, 32 new; native, int8), each run twice and required
     to repeat its tokens, launch each kernel exactly n_layers times a
     micro-step, prefill chunk, verify pass or wave, call no plain version
     and never the masked attention; prints each spec-off run's decode
     micro-step and tokens/s beside its byte bound (every parameter, the
     tied head reading the whole table, plus the KV its tokens read, over
     3.35 TB/s). Then in f32 at 4 layers the continuous and static
     engines' tokens on the card equal the CPU's over each request's
     tie-free prefix.
  23. head width 512: the same decoder with its 8 heads of 256 regrouped
     as 4 query heads of 512 over its 1 KV head (``WIDE_TEXT``: K and V
     projections 2048 x 512; no published checkpoint has this width),
     served, checked and timed as phase 22. Phases 22 and 23 run their
     decoder at ``TEXT_LAYERS`` (6) of its 18 layers.
  24. the port's examples on the card: ``examples.serve_batched`` at its
     defaults (no plain version; continuous == bucketed) and
     ``examples.train_100m --tiny`` for 8 steps, restarted from step 4
     (the step-8 checkpoint removed): the resumed losses and the step-8
     checkpoint bitwise the straight run's.
  25. the paper's two memory levers: the paged decode and the chunk at
     the sweeps' pool (4 slots of 120 positions, pages of 16, chunks of
     32, bf16) at both sweeps' widths (``TIER_MAIN``: llava15-13b's
     decoder; ``TIER_MAIN_1B``: llama3.2-1b) against their plain
     versions; then ``paper.hbs_sweep`` (llava15-13b's
     decoder as a dense text decoder at full width, 5 of 40 layers) and
     ``paper.chiplet_sweep`` (llama3.2-1b at full width and depth), both
     in bf16: each analytic half, and each measured half on the card
     with its streams serialized (``overlap=False``) over its bandwidth
     grid scaled to the card's page bytes. Every cell must be
     token-identical to the card's no-offload baseline and reconcile its
     trace; every serve must launch exactly the baseline's paged decodes
     (n_layers a micro-step) and chunks (n_layers a chunk) and no plain
     version; the generous point must not stall; the stingiest HBS cell
     must stall more than it; an overlap cell must save no less than 0
     against its own barrier counterfactual and, on the dedicated link,
     stall at most what the barrier run of its chiplet size stalled
     (whose stall the schedule fixes), a barrier cell save nothing, a
     chiplet cell promote with its ddr->chiplet bytes the promotions'
     pages, and the hit rate be above 0 at the smallest chiplet and
     grow with its size; the page counters
     (``paper.common.SCHEDULE_COUNTERS``) must equal those of the reduced
     twins served on this machine's CPU at the twins' grid (in a spawned
     process beside the kernels' build, finished before phase 3). Prints
     each cell, the analytic envelope beside the card's ITL p95 by
     bandwidth, and the overlap-vs-barrier pairs with the reference's
     cross-run tolerance.
  26. the paper's last two sweeps: the paged entries in bf16 at their
     pools against their plain versions (``sweep_cases``: spec_sweep's, 4
     slots of 168, pages of 16, the chunk C=32 at 64, at llama3.2-1b's
     width with the verify windows C = 1, 5, 9, 13 and at its model
     draft's, 16 heads of 64, with C = 1; shard_sweep's, 3 slots of 40,
     pages of 8, the chunk C=32 at 0, at a shard's 16 and 8 KV heads,
     split as the whole pool); then ``paper.spec_sweep`` (llama3.2-1b at
     full width, 4 of 16 layers, bf16; its model draft at half width, 1
     layer; the HBS grid scaled by the page bytes, x16) and
     ``paper.shard_sweep`` (llama3.2-1b at full width, 4 of 16 layers;
     its rank cells served on phase 17's ranks of 2 and 4 on the one
     card over gloo, ``sweep_rank``), streams serialized but for the
     overlap section's overlapped run. Every serve (with the counts set
     to 0 just before it) must launch exactly n_layers paged decodes a
     decode micro-step, chunks a prefill chunk and verify windows a
     verify pass, the model draft's one a micro-step, chunk and catch-up
     pass of its own at its own KV heads, a rank's at Hkv/N, no plain
     version, reconcile its trace and free its pages. Every n-gram cell,
     the model draft and each spec x HBS cell must be token-identical to
     the spec-off baseline, every mesh cell at N = 1, 2, 4 on every rank,
     both overlap runs and four shards' serve of the long request to the
     card's shards=1 serve; the model draft (its head untied) must have
     a proposal rejected; the generous point must not stall, and in each
     mode the stingiest bandwidth must stall more and stall must not
     shrink as the bandwidth does; the single device must reject the
     long request "across all" its tiers; serialized, the concurrent mix
     must preempt at N=1 and not at N=4; a rank's pool must hold 1/N of
     the bytes. The counters must equal the reduced twins' on this
     machine's CPU (served beside the kernels' build): every one of a
     spec-off cell and of shard_sweep's one-shard cells, and of an
     n-gram cell those no token moves (``spec_token_free``). Prints each
     cell, the overlapped and serialized serve_ms
     (``overlap_beats_serialized`` and the n-gram ``speedup_ge_1_2x``
     recorded, not asserted) and the mesh cells'
     tokens/s and pool bytes a rank.
  27. head width 1024 (the width-generic instances): the same decoder
     with its 8 heads of 256 regrouped as 2 query heads of 1024 over its
     1 KV head (``WIDER_TEXT``: q projection 2048 x 2048, K and V 2048 x
     1024; no published checkpoint has this width), at 6 of its 18
     layers, served, checked and timed as phase 22.
  28. the continuous engine's blocks as CUDA graphs, llama3.2-1b at full
     width and 16 layers with phase 4's weights, bf16: (a) native, int8,
     n-gram k=4 and phase 4's sampled run on phase 4's 16 requests, each
     served eagerly (``graphs=False``) and captured, both with the
     streams serialized (with overlap on, a decode block's membership
     follows measured wall times, which the capture changes by design):
     tokens equal, and equal to phase 4's captured run, but for a
     divergence after a near tie (phase 6's rule); host syncs, decode
     steps, decode and prefill compiles and every launch count equal;
     captures equal to compiles in each captured engine and in phase 4's,
     and a second serve on the captured native engine captures nothing;
     (b) one K=8 decode block (8 slots x 300 cached, a seeded random
     pool) replayed twice from one pool state bitwise equal to its eager
     run, tokens and pool; (c) PERF.md's three llama blocks (the K=8
     decode block, the chunk B=1, C=64 at 384, the verify pass B=8, C=5)
     eager and captured: wall (median of 5), device busy (torch.profiler,
     which records a replay's kernels), busy share and the seconds of one
     capture, and the launches one replay adds to the counters equal to
     the eager block's and to the count the profiler records of each
     attention kernel in that replay, and beside them
     the static engine's K=8 qwen2.5-3b block (B=4 at 512, native) eager
     and captured, checked the same way; (d) each captured engine's
     graph memory (the allocator's growth across its captures); (e)
     qwen2.5-3b at full width, bf16, through the static engine
     (phase 5's waves, native and int8), served eagerly and captured:
     tokens equal up to a near tie, host syncs, decode steps, decode
     compiles and every launch count equal, captures equal to the
     distinct (B, L, k_eff) keys the serve made; (f) phase 4's
     self-draft run (the model draft: its chunk, catch-up pass and
     propose block captured beside the engine's blocks) served eagerly
     and captured with the streams serialized: the same equalities and
     the draft's passes, one capture a key, and a second serve on the
     captured engine captures nothing.
Then prints the per-kernel JSON line (each kernel at its main-path case
and at arctic-480b's group 7, with that path's launches; the dense
decode at llava's long context and at paligemma's head width 256,
flash at llava's group 1, the three paged entries at a head shard
of 2 and of 4, the verify entry there with 0 launches, and the four
entries phase 19 (f)'s sweep runs, at llama3.2-1b's width with that
sweep's launches, and the five at head width 256 with phase 22's
launches, and the five at head width 512 with phase 23's, and the
five at head width 1024 with phase 27's, and the
paged decode and the chunk at the hbs sweep's pool with its launches
and at their main-path case with the chiplet sweep's, and phase 26's:
the three paged entries at spec_sweep's pool with its target's launches
(the verify window at C = 5, 9, 13 with the launches of the serves at k
= 4, 8, 12), at its draft's width with the draft's, and the paged decode
and the chunk at a shard's heads over pages of 8 with rank 0's) and,
last, the device JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM device memory
# dense peak operations/s by input type (H100 SXM data sheet): bf16/f16 on
# the tensor cores; f32 on the CUDA cores (TF32 is off)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PS, MAX_LEN, C = 16, 576, 64
# (heads, head_dim, kv heads) of the paged kernel cases: llama3.2-1b as the
# continuous path serves it (group 1), at group 4, and qwen2.5-3b's width
PAGED_WIDTHS = ((32, 64, 32), (32, 64, 8), (16, 128, 2))
# the paged decode library before its redesign (split over pages, a
# decode body of its own) and the headers the redesign is built from; the
# tensor-core instructions of each dh=128 flash kernel on its tiles
OLD_PAGED_DECODE_LIB = "paged_decode_attention_0fd935ec44eda43a.so"
PAGED_DECODE_HEADERS = {"dispatch.cuh", "paged_attention.cuh",
                        "split_decode.cuh", "wide_tile.cuh"}
FLASH_HMMA_DH128 = 64
VERIFY_C = (1, 2, 4, 5, 8)    # verify windows of spec_k 4 (1, 2, 4, 5) and 7
# the static phase: qwen2.5-3b, prompts of 256 and 512 tokens, 32 new
QWEN_PROMPTS, QWEN_NEW, QWEN_MAX_LEN = (256, 512), 32, 640
# arctic-480b's attention width (heads, head_dim, kv heads): GQA group 7
ARCTIC_WIDTH = (56, 128, 8)
# the MoE phase: arctic-480b at full width cut to 2 of its 35 layers; 8
# requests and 32 new tokens on the continuous engine, the static waves'
# prompts with 16 new tokens on the static one
ARCTIC_LAYERS, ARCTIC_REQS, ARCTIC_NEW, ARCTIC_STATIC_NEW = 2, 8, 32, 16
# llava15-13b's attention width (heads, head_dim, kv heads): MHA, group 1;
# paligemma-3b's: 8 heads over 1 KV head at head width 256
LLAVA_WIDTH, PALIGEMMA_WIDTH = (40, 128, 40), (8, 256, 1)
# the VLM phase: llava15-13b at full width and depth, fp16; (a) a wave of 4
# with 576 patch rows and 512 prompt tokens, 32 new; (b) the paper's long
# context, one sequence of 576 patch rows and 31,616 prompt tokens (32,192
# positions), 64 new
LLAVA_PATCHES = 576
LLAVA_RUNS = {"a": (4, 512, 32), "b": (1, 31616, 64)}
# paligemma-3b at full width: 4 x (256 patch rows + 256 prompt tokens), 32
# new; gemma3-1b at full width: serve_bucketed on 4 prompts of 1,024 and 4
# of 2,048 tokens (past its 512-token window), 32 new
PALIGEMMA_RUN = (4, 256, 256, 32)
GEMMA_PROMPTS, GEMMA_NEW = (1024, 2048), 32
# the last four families, at full width on the static engine:
# deepseek-v2-236b cut to its dense first layer and 2 of its 59 MoE layers,
# (a) a wave of 4 x 512 prompt tokens, 32 new, (b) one sequence of 32,128
# prompt tokens (32,192 positions, llava's long context), 64 new
DEEPSEEK_LAYERS = 3
DEEPSEEK_RUNS = {"a": (4, 512, 32), "b": (1, 32128, 64)}
# llava15-13b's KV bytes a position (fp16, 40 layers x 2 x 40 x 128)
LLAVA_KV_POS_BYTES = 819200
# mamba2-130m at all 24 layers: (a) 4 x 512, 32 new; (b) 1 x 32,768, 32 new
MAMBA_RUNS = {"a": (4, 512, 32), "b": (1, 32768, 32)}
# zamba2-2.7b at all 54 blocks: serve_bucketed on 4 prompts of 512 and 4 of
# 1,024 tokens, 32 new
ZAMBA_PROMPTS, ZAMBA_NEW = (512, 1024), 32
# whisper-medium at 24 + 24 layers: 1,500 frame rows before 4 x 32 prompt
# tokens, 64 new
WHISPER_RUN = (4, 32, 64)
# the head-sharded phase: llama3.2-1b at full width on the continuous
# engine, 8 of phase 4's requests with 32 new tokens, at 2 shards (native,
# int8, n-gram k=4) and at 4 (native), every rank on the one card over gloo
SHARD_REQS, SHARD_NEW = 8, 32
SHARD_RUNS = {2: ("native", "int8", "ngram"), 4: ("native",)}
SHARD_TIMEOUT_S = 300.0
# paper.concurrency_sweep's runtime halves: new tokens a request
SWEEP_NEW = 16
# the head-width-256 phase: paligemma-3b's Gemma-2B decoder served text-only
# (no image prefix: a causal dense LM, 18 layers, 8 heads over 1 KV head at
# head width 256), at full width in bf16 on both engines; pages of 32 keys
# (the reference's _page_tile_ok takes them for bf16 and int8 pools); 8 of
# phase 4's requests with 32 new tokens on the continuous engine, phase 5's
# waves with 32 on the static one; the f32 card-vs-CPU check at 4 layers
PALI_TEXT = dict(family="dense", prefix_len=0, prefix_bidirectional=False)
PALI_TEXT_PS, PALI_TEXT_REQS, PALI_TEXT_NEW, PALI_TEXT_F32_LAYERS = (
    32, 8, 32, 4)
# gemma3-1b's attention width (heads, head_dim, kv heads): group 4 at 256
GEMMA3_WIDTH = (4, 256, 1)
# head widths 384 and 512 (phase 3's wide cases): (heads, head_dim, kv
# heads) at groups 8 and 4 over one KV head
WIDE_DIMS = (384, 512)
WIDE_WIDTHS = tuple((H, dh, 1) for dh in WIDE_DIMS for H in (8, 4))
# the dh-512 phase: paligemma-3b's Gemma-2B decoder text-only with its 8
# heads of 256 regrouped as 4 query heads of 512 over its 1 KV head (K and
# V projections 2048 x 512; no published checkpoint has this width); its
# runs as phase 22's
WIDE_TEXT = dict(PALI_TEXT, n_heads=4, head_dim=512)
# head widths above 512 (phase 3's wider cases, the width-generic
# instances): (heads, head_dim, kv heads) at groups 2 and 8 over one KV
# head at 640 and 1024, and group 1 (8 over 8) at 1024, over the full
# dtype grid; 768 and 2048 at group 2 in bf16, bf16 over int8 and f32
WIDER_WIDTHS = ((2, 640, 1), (8, 640, 1), (2, 1024, 1), (8, 1024, 1),
                (8, 1024, 8))
WIDER_SPOT_WIDTHS = ((2, 768, 1), (2, 2048, 1))
# the dh-1024 phase: the decoder's 8 heads of 256 regrouped as 2 query
# heads of 1024 over its 1 KV head (q projection 2048 x 2048, K and V 2048
# x 1024; no published checkpoint has this width); its runs as phase 22's
WIDER_TEXT = dict(PALI_TEXT, n_heads=2, head_dim=1024)
# the depth of phases 22, 23 and 27's decoder (of its 18 layers), cut so
# that the script keeps within its time; the f32 checks keep
# PALI_TEXT_F32_LAYERS
TEXT_LAYERS = 6
# the training phase: llama3.2-1b at full width in f32, (B, S, n_micro,
# steps, the step saved and resumed from); the families whose reduced twins
# train on the card against the CPU
TRAIN_RUN = (4, 1024, 2, 8, 4)
# llama3.2-1b's depth in phase 17, phase 18's checkpoint part and phase 20
# (a), cut from its 16 layers at full width so that the script keeps
# within its time as later phases join it; phase 18's training steps keep
# all 16
CUT_LAYERS = 4
# train_100m --tiny's steps in phase 24, restarted at half of them
EXAMPLE_STEPS = 8
TRAIN_FAMILIES = ("llama3.2-1b", "arctic-480b", "llava15-13b",
                  "paligemma-3b", "gemma3-1b", "deepseek-v2-236b",
                  "mamba2-130m", "zamba2-2.7b", "whisper-medium")


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    """A failed phase: raise (the script then exits non-zero)."""
    if not ok:
        raise RuntimeError(f"[smoke] FAIL: {msg}")


def median_ms(torch, fn, iters: int = 30) -> float:
    """Median device time of one call. Each call is queued behind a 64 MB
    write that evicts the 50 MB L2 (a serving step finds its KV cold) and
    behind a spin kernel longer than the host takes to enqueue the call, so
    the two events bracket the device's work and not the host's."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(max(4 * host_s, 1e-4) * 2e9)      # ~2 GHz SM clock
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def ptxas_entries(text: str) -> dict:
    """{kernel: (registers, smem bytes, spill-store bytes)} of a build's
    ``-Xptxas -v`` report."""
    def num(pat, part):
        m = re.search(pat, part)
        return int(m.group(1)) if m else 0
    return {part.split("'", 1)[0]: (num(r"Used (\d+) registers", part),
                                    num(r"(\d+) bytes smem", part),
                                    num(r"(\d+) bytes spill stores", part))
            for part in text.split("Compiling entry function '")[1:]}


def pass_ptxas(ents: dict, label: str) -> dict:
    """Registers, shared memory and spills of the split kernels' pass 1 and
    combine among the ptxas entries ``ents``."""
    report = {}
    for part, pick in (("pass 1", lambda n: "combine" not in n),
                       ("combine", lambda n: "combine" in n)):
        sel = [v for n, v in ents.items() if pick(n)]
        report[part] = dict(
            kernels=len(sel), registers=[min((v[0] for v in sel), default=0),
                                         max((v[0] for v in sel), default=0)],
            smem_max=max((v[1] for v in sel), default=0),
            spill_max=max((v[2] for v in sel), default=0))
        log(f"ptxas {label} {part}: {len(sel)} kernels, registers "
            f"{report[part]['registers'][0]}-{report[part]['registers'][1]}"
            f", smem max {report[part]['smem_max']} B, spill stores max "
            f"{report[part]['spill_max']} B")
    return report


def paged_ptxas(kbuild) -> dict:
    """The paged decode library's pass-1 and combine kernels: registers,
    shared memory and spills, and the main path's pass-1 instance (bf16
    queries over a bf16 pool, dh=64, one row a block)."""
    ents = ptxas_entries(kbuild.build_log("paged_decode_attention"))
    report = pass_ptxas(ents, "paged decode")
    main = [v for n, v in ents.items()
            if "paged_split_kernelI13__nv_bfloat16S2_Li64ELi1E" in n]
    if main:
        report["main_path"] = dict(zip(("registers", "smem", "spill"),
                                       main[0]))
        log(f"ptxas paged decode pass 1, main path (bf16/bf16, dh=64, 1 row):"
            f" {main[0][0]} registers, {main[0][1]} B smem + the split's "
            f"rows, {main[0][2]} B spill stores")
    return report


def width_ptxas(kbuild, dh) -> dict:
    """Every head-width-``dh`` instance of the four libraries (``dh="wide"``:
    the width-generic instances of every multiple of 128 above 512, whose
    kernels' names hold "wide"): registers, shared memory and spill
    stores by library and kernel template, from the build's ptxas report.
    Each library must hold some; spills are reported, not refused."""
    report = {}
    for lib in kbuild.SOURCES:
        ents = {n: v for n, v in ptxas_entries(kbuild.build_log(lib)).items()
                if ("wide" in n if dh == "wide" else f"Li{dh}E" in n)}
        check(ents, f"{lib} has no head-width-{dh} instances")
        by_kernel = {}
        for name, v in ents.items():
            tmpl = re.search(r"\d+([a-z_]+_kernel)I", name)
            key = tmpl.group(1) if tmpl else name[:40]
            by_kernel.setdefault(key, []).append((name, *v))
        rows = {}
        for key, vs in sorted(by_kernel.items()):
            rows[key] = dict(
                kernels=len(vs), registers=[min(v[1] for v in vs),
                                            max(v[1] for v in vs)],
                smem_max=max(v[2] for v in vs),
                spill_max=max(v[3] for v in vs),
                spilling=[v[0] for v in vs if v[3]])
            log(f"ptxas {lib} dh={dh} {key}: {len(vs)} kernels, registers "
                f"{rows[key]['registers'][0]}-{rows[key]['registers'][1]}, "
                f"smem max {rows[key]['smem_max']} B, spill stores max "
                f"{rows[key]['spill_max']} B ({len(rows[key]['spilling'])} "
                f"spilling)")
            for n in rows[key]["spilling"]:
                log(f"  spills: {n}")
        report[lib] = rows
    return report


@functools.lru_cache(maxsize=None)
def _sass(path: str) -> str:
    """The SASS of the built library at ``path`` (cuobjdump -sass)."""
    from repro_torch.kernels import build as kbuild
    return subprocess.run(
        [str(Path(kbuild._nvcc()).with_name("cuobjdump")), "-sass", path],
        capture_output=True, text=True, check=True).stdout


def hmma_counts(kbuild, lib: str, kernel: str) -> dict:
    """Tensor-core (HMMA) instructions in each kernel named ``kernel`` of
    the built library ``lib``, from its SASS (cuobjdump -sass)."""
    sass = _sass(str(kbuild.lib_path(lib)))
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel in name:
            counts[name] = fn.count("HMMA")
    return counts


# ------------------------------ phase 3 --------------------------------- #

def _pools(torch, g, shape, pool, qdt):
    """Random K and V of ``shape`` in the pool type: f32/bf16, or int8 with
    per-kv-head (dim 2) scales. Returns (k, v, scale kwargs)."""
    kf = torch.randn(shape, generator=g, device="cuda")
    vf = torch.randn(shape, generator=g, device="cuda")
    if pool != "int8":
        return kf.to(qdt), vf.to(qdt), {}
    ksc = kf.abs().amax((0, 1, 3)) / 127.0
    vsc = vf.abs().amax((0, 1, 3)) / 127.0
    kq = torch.round(kf / ksc[:, None]).clamp(-127, 127).to(torch.int8)
    vq = torch.round(vf / vsc[:, None]).clamp(-127, 127).to(torch.int8)
    return kq, vq, dict(k_scale=ksc.float().contiguous(),
                        v_scale=vsc.float().contiguous())


def kernel_cases(torch, kern, flash):
    """Inputs at the serving paths' shapes. Yields (name, label, dtype
    name, kernel fn, plain fn, sdpa fn, bytes, ops, tolerance)."""
    for width in PAGED_WIDTHS:
        yield from paged_cases(torch, kern, *width)
    # arctic-480b's width (group 7): bf16 and int8 pools, the C=5 window
    yield from paged_cases(torch, kern, *ARCTIC_WIDTH,
                           pools=("bfloat16", "int8"), verify_c=(5,),
                           chunk_edges=False)
    yield from dense_decode_cases(torch, kern)
    yield from flash_cases(torch, flash)
    yield from vlm_kernel_cases(torch, kern, flash)
    yield from sweep_kernel_cases(torch, kern, flash)


def paged_cases(torch, kern, H, DH, Hkv,
                pools=("float32", "bfloat16", "float16", "int8"),
                verify_c=VERIFY_C, chunk_edges=True, split_kv_heads=None,
                ps=PS, slots=8, max_len=MAX_LEN, chunk_len=C,
                scalar_start=384, main_only=False, tag=""):
    """The paged entries at one width and over ``pools`` ("int8" with bf16
    queries, "int8/float16" with f16 ones): decode, the chunk at a scalar
    and a per-sequence start, the verify windows of ``verify_c``, and
    (with ``chunk_edges``, where the chunk kernel splits its keys) chunks
    and windows whose frontiers fall on and beside its split edges, over
    pages of ``ps`` keys, a pool of ``slots`` sequences of up to
    ``max_len`` positions and chunks of ``chunk_len`` tokens. With
    ``split_kv_heads``, a head shard's calls: the kernels split as a pool
    of that many KV heads would (no edge cases). With ``main_only``, the
    decode, the chunk at ``scalar_start`` and the windows of ``verify_c``
    alone (a serving path's shapes). ``tag`` ends each case's label."""
    sk = {} if split_kv_heads is None else dict(split_kv_heads=split_kv_heads)
    shard = ("" if split_kv_heads is None
             else f" shard=1/{split_kv_heads // Hkv}")
    import torch.nn.functional as F
    dev = "cuda"
    B = slots
    n_pp = -(-max_len // ps)
    P = B * n_pp + 1
    g = torch.Generator(device=dev).manual_seed(0)
    wide = (("" if DH == 64 else f" dh={DH}") + shard
            + ("" if ps == PS else f" ps={ps}")
            + ("" if (slots, max_len) == (8, MAX_LEN)
               else f" slots={slots} max_len={max_len}") + tag)
    grp = H // Hkv
    pos = torch.arange(n_pp * ps, device=dev)
    for pool in pools:
        kind, _, q_name = pool.partition("/")
        q_name = q_name or ("bfloat16" if kind == "int8" else kind)
        qdt = getattr(torch, q_name)
        ops_type = q_name
        kp, vp, sc = _pools(torch, g, (P, ps, Hkv, DH), kind, qdt)
        elem = kp.element_size()
        # shuffled pages; entries past each sequence's last page are
        # stale ids of other pages, which must stay masked
        pt = (torch.randperm(P - 1, generator=g, device=dev)[:B * n_pp]
              .reshape(B, n_pp) + 1).to(torch.int32)
        lens = torch.randint(1, max_len + 1, (B,), generator=g,
                             device=dev).to(torch.int32)
        lens[0], lens[1] = max_len, 1
        kd = kern._dequant(kp, pt, sc.get("k_scale")).to(qdt)
        vd = kern._dequant(vp, pt, sc.get("v_scale")).to(qdt)
        kdh = kd.permute(0, 2, 1, 3).repeat_interleave(grp, 1)
        vdh = vd.permute(0, 2, 1, 3).repeat_interleave(grp, 1)
        tol = 1e-4 if pool == "float32" else 2e-2
        kv_row = 2 * Hkv * DH * elem + (8 * Hkv if sc else 0)

        def decode(label, pt, lens, gen):
            # q (B, H, dh) at seq_lens; the yardsticks: SDPA on the
            # gathered keys, and the chunk kernel's verify route at C=1
            # (a one-row window at seq_lens - 1 is the same function)
            Bd = len(lens)
            q = torch.randn((Bd, H, DH), generator=gen, device=dev).to(qdt)
            kdd = kern._dequant(kp, pt, sc.get("k_scale")).to(qdt)
            vdd = kern._dequant(vp, pt, sc.get("v_scale")).to(qdt)
            dmask = (pos[None] < lens[:, None])[:, None, None]
            before, ones = lens - 1, torch.ones_like(lens)
            n_keys = int(lens.sum())
            return ("paged_decode_attention",
                    f"group={grp} pool={pool}{label}{wide}", ops_type,
                    lambda q=q, kp=kp, vp=vp, pt=pt, lens=lens, sc=sc:
                        kern.paged_decode_attention(q, kp, vp, pt, lens,
                                                    **sc, **sk),
                    lambda q=q, kp=kp, vp=vp, pt=pt, lens=lens, sc=sc:
                        kern.paged_decode_attention_plain(q, kp, vp, pt,
                                                          lens, **sc),
                    lambda q=q, k=kdd.permute(0, 2, 1, 3)
                    .repeat_interleave(grp, 1),
                    v=vdd.permute(0, 2, 1, 3).repeat_interleave(grp, 1),
                    m=dmask: F.scaled_dot_product_attention(
                        q[:, :, None], k, v, attn_mask=m),
                    2 * q.numel() * q.element_size() + pt.numel() * 4
                    + Bd * 4 + n_keys * kv_row,
                    4 * H * DH * n_keys, tol,
                    lambda q=q[:, None], kp=kp, vp=vp, pt=pt, sl=before,
                    nf=ones, sc=sc: kern.spec_verify_attention(
                        q, kp, vp, pt, sl, nf, **sc, **sk)[:, 0])

        yield decode("", pt, lens, g)
        if hasattr(kern, "paged_split") and not sk and not main_only:
            # seq_lens at 1, the table and each split edge +-1 (B=16 over
            # pages drawn at random: shared and stale pages alike), from a
            # generator of their own (the other cases draw as before)
            ge = torch.Generator(device=dev).manual_seed(16)
            Be = 16
            split = kern.paged_split(Be, Hkv, n_pp * ps, grp, ps,
                                     kern._sm_count(
                                         torch.cuda.current_device()),
                                     **_wide_kw(DH))
            lens_e = torch.tensor(decode_boundaries(Be, n_pp * ps, split),
                                  dtype=torch.int32, device=dev)
            pt_e = torch.randint(1, P, (Be, n_pp), generator=ge, device=dev,
                                 dtype=torch.int32)
            yield decode(f" B={Be} seq_lens=edges {split}", pt_e, lens_e,
                         ge)

        def chunk(label, starts, reals):
            Bc = len(starts)
            qc = torch.randn((Bc, chunk_len, H, DH), generator=g,
                             device=dev).to(qdt)
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            nv = st + torch.tensor(reals, dtype=torch.int32, device=dev)
            s_arg = starts[0] if Bc == 1 else st
            ptc = pt[:Bc].contiguous()
            qpos = st[:, None] + torch.arange(chunk_len, device=dev)
            lim = torch.minimum(qpos + 1, nv[:, None])        # (Bc, C)
            cmask = (pos[None, None] < lim[..., None])[:, None]
            keys = int(torch.minimum(st + chunk_len, nv).sum())
            clab = "" if chunk_len == C else f" C={chunk_len}"
            return ("chunk_prefill_attention",
                    f"group={grp} pool={pool} {label}{wide}{clab}", ops_type,
                    lambda q=qc, kp=kp, vp=vp, pt=ptc, s=s_arg, nv=nv,
                    sc=sc: kern.chunk_prefill_attention(q, kp, vp, pt, s,
                                                        nv, **sc, **sk),
                    lambda q=qc, kp=kp, vp=vp, pt=ptc, s=s_arg, nv=nv,
                    sc=sc: kern.chunk_prefill_attention_plain(
                        q, kp, vp, pt, s, nv, **sc),
                    lambda q=qc, k=kdh[:Bc], v=vdh[:Bc], m=cmask:
                        F.scaled_dot_product_attention(
                            q.transpose(1, 2), k, v, attn_mask=m),
                    2 * qc.numel() * qc.element_size() + ptc.numel() * 4
                    + 8 * Bc + keys * kv_row,
                    4 * H * DH * int(lim.sum()), tol)

        def verify(label, Cv, sl, nf):
            # row 0 is inactive as the model draft's catch-up feeds it
            # (seq_len 0, one fed token, a table of null pages)
            sl[0], nf[0] = 0, 1
            ptv = pt.clone()
            ptv[0] = 0
            qv = torch.randn((B, Cv, H, DH), generator=g, device=dev).to(qdt)
            kdv = kern._dequant(kp, ptv, sc.get("k_scale")).to(qdt)
            vdv = kern._dequant(vp, ptv, sc.get("v_scale")).to(qdt)
            qpos = torch.minimum(                             # (B, Cv)
                sl[:, None] + torch.arange(Cv, device=dev),
                (sl + nf - 1)[:, None])
            vmask = (pos[None, None] <= qpos[..., None])[:, None]
            return ("spec_verify_attention",
                    f"group={grp} pool={pool} {label}{wide}", ops_type,
                    lambda q=qv, kp=kp, vp=vp, pt=ptv, sl=sl, nf=nf,
                    sc=sc: kern.spec_verify_attention(q, kp, vp, pt, sl,
                                                      nf, **sc, **sk),
                    lambda q=qv, kp=kp, vp=vp, pt=ptv, sl=sl, nf=nf,
                    sc=sc: kern.spec_verify_attention_plain(
                        q, kp, vp, pt, sl, nf, **sc),
                    lambda q=qv, k=kdv.permute(0, 2, 1, 3)
                    .repeat_interleave(grp, 1),
                    v=vdv.permute(0, 2, 1, 3).repeat_interleave(grp, 1),
                    m=vmask: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k, v, attn_mask=m),
                    2 * qv.numel() * qv.element_size() + ptv.numel() * 4
                    + 8 * B + int((sl + nf).sum()) * kv_row,
                    4 * H * DH * int((qpos + 1).sum()), tol)

        # chunk: scalar start (B=1, as the engine prefills) and a
        # per-sequence start (B=4)
        yield chunk("start=scalar", [scalar_start], [chunk_len])
        if not main_only:
            yield chunk("start=(B,)", [0, 64, 320, 512], [64, 37, 64, 50])
        # speculative verify: the windows of ``verify_c``; ragged landed
        # lengths with room for the window, 1..C fed tokens
        for Cv in verify_c:
            sl = torch.randint(0, max_len - Cv + 1, (B,), generator=g,
                               device=dev).to(torch.int32)
            nf = torch.randint(1, Cv + 1, (B,), generator=g,
                               device=dev).to(torch.int32)
            sl[1], nf[1] = max_len - Cv, Cv
            yield verify(f"C={Cv}", Cv, sl, nf)
        if main_only or not chunk_edges or not hasattr(kern, "chunk_split"):
            continue
        n_sm = kern._sm_count(torch.cuda.current_device())
        for edge in (kern.chunk_split(4, Hkv, C, grp, n_pp * ps, n_sm, DH),
                     2 * kern.chunk_split(4, Hkv, C, grp, n_pp * ps, n_sm,
                                          DH)):
            # the last row's frontier one key before, on and past the
            # edge, the last two right-padded, and a chunk at 0
            starts = [0] + [min(max(edge - C + d, 0), MAX_LEN - C)
                            for d in (-1, 0, 1)]
            yield chunk(f"start=edge {edge}", starts, [C, C, C - 3, C - 1])
        Cv = VERIFY_C[3]
        edge = kern.chunk_split(B, Hkv, Cv, grp, n_pp * ps, n_sm, DH)
        sl = torch.tensor([0, edge - Cv, edge - 3, edge - 1, edge, edge + 1,
                           2 * edge - 1, 2 * edge - Cv], dtype=torch.int32,
                          device=dev).clamp(0, MAX_LEN - Cv)
        nf = torch.tensor([1, Cv, Cv, 2, Cv, 1, Cv, Cv - 1],
                          dtype=torch.int32, device=dev)
        yield verify(f"C={Cv} seq_lens=edge {edge}", Cv, sl, nf)


def _wide_kw(DH) -> dict:
    """The head width for the split rules above 512, where they count the
    column blocks (at or below it a checkout's rules need not take it)."""
    return dict(dh=DH) if DH > 512 else {}


def decode_boundaries(B, L, split):
    """kv_valid for B sequences: 1, L and each split boundary +-1, in
    turn."""
    vals = [1, L]
    for edge in range(split, L + 1, split):
        vals += [edge - 1, edge, edge + 1]
    vals = [v for v in vals if 1 <= v <= L]
    return [vals[i % len(vals)] for i in range(B)]


def _dense_decode_case(torch, kern, g, B, H, DH, Hkv, L, pool, qdt,
                       valid=None, label="", tol=None):
    """One dense decode case (the tuple check_kernels takes): random q and
    caches in ``pool`` (int8 with scales), ``valid`` kv_valid (default
    ragged 1..L with L and 1 first), SDPA with a length mask as the
    yardstick; ``tol`` (default 1e-4 for f32, else 2e-2) bounds the max
    abs error against the plain version."""
    import torch.nn.functional as F
    dev = "cuda"
    kc, vc, sc = _pools(torch, g, (B, L, Hkv, DH), pool, qdt)
    if valid is None:
        valid = torch.randint(1, L + 1, (B,), generator=g,
                              device=dev).to(torch.int32)
        valid[0] = L
        if B > 1:
            valid[1] = 1
    q = torch.randn((B, H, DH), generator=g, device=dev).to(qdt)
    kd = kern._dequant_dense(kc, sc.get("k_scale")).to(qdt)
    vd = kern._dequant_dense(vc, sc.get("v_scale")).to(qdt)
    mask = (torch.arange(L, device=dev)[None]
            < valid[:, None])[:, None, None]                     # (B,1,1,L)
    n_keys = int(valid.sum())
    kv_row = 2 * Hkv * DH * kc.element_size()
    return ("decode_attention",
            f"group={H // Hkv} pool={pool} L={L} dh={DH}{label}",
            str(qdt).split(".")[-1],
            lambda q=q, k=kc, v=vc, n=valid, sc=sc:
                kern.decode_attention(q, k, v, n, **sc),
            lambda q=q, k=kc, v=vc, n=valid, sc=sc:
                kern.decode_attention_plain(q, k, v, n, **sc),
            lambda q=q, k=kd.transpose(1, 2), v=vd.transpose(1, 2), m=mask:
                F.scaled_dot_product_attention(q[:, :, None], k, v,
                                               attn_mask=m, enable_gqa=True),
            2 * q.numel() * q.element_size() + 4 * B + n_keys * kv_row
            + (8 * Hkv if sc else 0),
            4 * H * DH * n_keys,
            tol or (1e-4 if pool == "float32" else 2e-2))


def dense_decode_cases(torch, kern):
    """The static engine's decode at qwen2.5-3b's width (B=4, H=16, Hkv=2,
    dh=128, the 545-position cache of a 512-token wave, ragged kv_valid
    1..545) in f32, bf16, f16 and an int8 cache with bf16 queries; the same
    width with kv_valid at the split boundaries (B=12) and at B=32 with
    Hkv=8 (where only the 128-key cap splits the cache); a dh=64 group-1
    case; and arctic-480b's width (H=56, Hkv=8, group 7) in bf16 and int8,
    ragged (B=4) and at the split boundaries (B=12). The SDPA yardstick
    runs on the dense cache (dequantized beforehand when int8) with a
    length mask."""
    g = torch.Generator(device="cuda").manual_seed(1)
    L = 545
    for B, H, DH, Hkv, pools, edges in (
            (4, 16, 128, 2, ("float32", "bfloat16", "float16", "int8"),
             False),
            (12, 16, 128, 2, ("float32", "bfloat16", "int8"), True),
            (32, 64, 128, 8, ("bfloat16",), True),
            (4, 32, 64, 32, ("bfloat16",), False),
            (4, *ARCTIC_WIDTH, ("bfloat16", "int8"), False),
            (12, *ARCTIC_WIDTH, ("bfloat16", "int8"), True)):
        yield from _dense_decode_pools(torch, kern, g, B, H, DH, Hkv, L,
                                       pools, edges)


def _dense_decode_pools(torch, kern, g, B, H, DH, Hkv, L, pools, edges,
                        qdt_16=None):
    """The dense decode cases of one width over ``pools`` (queries of the
    pool's type, or ``qdt_16`` (default bf16) over an int8 cache): ragged
    kv_valid, or with ``edges`` kv_valid at 1, L and the split edges
    +-1."""
    split = kern.decode_split(B, Hkv, L, H // Hkv, kern._sm_count(
        torch.cuda.current_device()), **_wide_kw(DH))
    for pool in pools:
        qdt = ((qdt_16 or torch.bfloat16) if pool == "int8"
               else getattr(torch, pool))
        valid = (torch.tensor(decode_boundaries(B, L, split),
                              dtype=torch.int32, device="cuda")
                 if edges else None)
        yield _dense_decode_case(
            torch, kern, g, B, H, DH, Hkv, L, pool, qdt, valid,
            f" B={B} split={split} kv_valid=edges" if edges else "")


def vlm_kernel_cases(torch, kern, flash):
    """The widths the VLM and masked-attention slice adds: the dense decode
    at llava15-13b's width (B=4, H = Hkv = 40, dh=128, the 1,121-position
    cache of a 576 + 512-token wave, fp16 and an int8 cache with fp16
    queries; and B=1 over a 32,256-position cache, every key valid: the
    long-context step, 661 MB a layer) and at paligemma-3b's (B=4, H=8,
    Hkv=1, dh=256, L=545, f32/bf16/f16/int8, ragged and on its split
    edges); flash at llava's width (B=4, S=1,088, H = Hkv = 40, fp16,
    causal and full)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    H, DH, Hkv = LLAVA_WIDTH
    yield from _dense_decode_pools(torch, kern, g, 4, H, DH, Hkv, 1121,
                                   ("float16", "int8"), False,
                                   torch.float16)
    # the long step averages 32k unit-normal values: outputs of a few
    # hundredths (std about sqrt(e / L) = 0.009), so 2e-2 would pass a
    # kernel that dropped splits; 1e-4 is about six f16 ulps at 0.03
    L = LLAVA_PATCHES + LLAVA_RUNS["b"][1] + LLAVA_RUNS["b"][2]
    yield _dense_decode_case(
        torch, kern, g, 1, H, DH, Hkv, L, "float16", torch.float16,
        torch.tensor([L], dtype=torch.int32, device=dev), " B=1", 1e-4)
    for B, edges in ((4, False), (12, True)):
        yield from _dense_decode_pools(
            torch, kern, g, B, *PALIGEMMA_WIDTH, 545,
            ("float32", "bfloat16", "float16", "int8"), edges)
    B, S = 4, LLAVA_PATCHES + LLAVA_RUNS["a"][1]
    q, k, v = (torch.randn((B, S, H, DH), generator=g, device=dev).half()
               for _ in range(3))
    for causal in (True, False):
        yield _flash_case(flash, q, k, v, causal, "float16",
                          f"group=1 float16 S={S}", gqa=False)


def flash_cases(torch, flash):
    """The static engine's prefill attention at qwen2.5-3b's width (B=4,
    H=16, dh=128; Hkv 2 and 16), causal and full: bf16 and f16 (the
    tensor-core tiles) for prompts of 1, 17, 64, 256, 512 and 300 tokens,
    f32 (the FMA body) for 256, 512 and 300; then arctic-480b's width (H=56,
    Hkv=8, group 7) in bf16 at 512, 300 and 17. SDPA (enable_gqa) is the
    yardstick."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, DH = 4, 16, 128
    widths = [(S, H, Hkv, dt) for S in (256, 512, 300, 1, 17, 64)
              for Hkv in (2, 16)
              for dt in (("float32",) if S >= 256 else ()) + ("bfloat16",
                                                              "float16")]
    widths += [(S, ARCTIC_WIDTH[0], ARCTIC_WIDTH[2], "bfloat16")
               for S in (512, 300, 17)]
    for S, H, Hkv, dt in widths:
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, h, DH), generator=g,
                               device=dev).to(tdt)
                   for h in (H, Hkv, Hkv))
        for causal in (True, False):
            yield _flash_case(flash, q, k, v, causal, dt,
                              f"group={H // Hkv} {dt} S={S}")


def _flash_case(flash, q, k, v, causal, dt, label, gqa=True):
    """One flash case (the tuple check_kernels takes) on (B, S, heads, dh)
    ``q``, ``k``, ``v``: SDPA (``enable_gqa`` with ``gqa``) is the
    yardstick; 1e-4 bounds an f32 case's error, 2e-2 the others'."""
    import torch.nn.functional as F
    B, S, H, DH = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return ("flash_attention",
            f"{label} {'causal' if causal else 'full'}", dt,
            lambda: flash.flash_attention(q, k, v, causal=causal),
            lambda: flash.flash_attention_plain(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, **({"enable_gqa": True} if gqa else {})),
            (2 * q.numel() + 2 * k.numel()) * q.element_size(),
            4 * B * H * DH * pairs, 1e-4 if dt == "float32" else 2e-2)


def sweep_waves():
    """Phase 19 (f)'s static waves, as (B, S, dense cache length): the one
    with the longest prompt and the one with the most requests. The
    static engine's cache holds the prompt, the first token and whole
    decode blocks of 8 for the other 15 new tokens."""
    from repro_torch.paper import concurrency_sweep as cs
    waves = set()
    for reqs in cs.ragged_requests(cs.runtime_model("cuda")[0].vocab
                                   ).values():
        lens = [len(r) for r in reqs]
        waves |= {(lens.count(S), S) for S in lens}
    picks = {max(waves, key=lambda w: (w[1], w[0])),
             max(waves, key=lambda w: (w[0], w[1]))}
    return sorted((B, S, S + 1 + 8 * -(-(SWEEP_NEW - 1) // 8))
                  for B, S in picks)


def sweep_kernel_cases(torch, kern, flash):
    """The static engine's kernels at llama3.2-1b's width (H = Hkv = 32,
    dh=64) as phase 19 (f) serves it, bf16: flash (causal) on each wave
    of ``sweep_waves`` and the dense decode over its cache, ragged, and at
    B=12 on the longest cache with kv_valid at its split edges."""
    H, DH, Hkv = PAGED_WIDTHS[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    waves = sweep_waves()
    for B, S, _ in waves:
        q, k, v = (torch.randn((B, S, H, DH), generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        yield _flash_case(flash, q, k, v, True, "bfloat16",
                          f"group=1 bfloat16 S={S} dh=64 B={B}", gqa=False)
    for B, _, L in waves:
        yield _dense_decode_case(torch, kern, g, B, H, DH, Hkv, L,
                                 "bfloat16", torch.bfloat16, label=f" B={B}")
    yield from _dense_decode_pools(torch, kern, g, 12, H, DH, Hkv,
                                   max(L for _, _, L in waves),
                                   ("bfloat16",), True)


def check_kernels(torch, kern, flash, cases=None, timed=None):
    """Each case (name, label, dtype name, kernel fn, plain fn, SDPA fn,
    bytes, ops, tolerance[, a second yardstick fn]) of ``cases`` (default:
    ``kernel_cases``) against its plain version, twice (bitwise equal),
    then timed; with ``timed`` (a set of (name, label)), only the cases
    in it are timed, the others checked only."""
    rows = []
    for case in (kernel_cases(torch, kern, flash) if cases is None
                 else cases):
        (name, label, ops_type, fn, plain, sdpa, nbytes, ops,
         tol) = case[:9]
        got = fn()
        again = fn()
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(math.isfinite(err) and err <= tol,
              f"{name} [{label}] max_abs_err {err:.3g} > {tol:g}")
        check(torch.equal(got, again),
              f"{name} [{label}] differs between two calls")
        if timed is not None and (name, label) not in timed:
            rows.append(dict(name=name, case=label, max_abs_err=err,
                             tol=tol))
            log(f"{name:24s} {label:38s} err={err:.2e} (tol {tol:g}) "
                f"bitwise repeat, not timed")
            continue
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[ops_type] * 1e3
        row = dict(name=name, case=label, max_abs_err=err, tol=tol,
                   ms=median_ms(torch, fn), plain_ms=median_ms(torch, plain),
                   library_ms=median_ms(torch, sdpa),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, ops=ops)
        extra = ""
        if len(case) > 9:          # the chunk kernel's C=1 verify route
            row["chunk_c1_err"] = float(
                (case[9]().float() - want.float()).abs().max())
            row["chunk_c1_ms"] = median_ms(torch, case[9])
            extra = f" chunk_c1={row['chunk_c1_ms']:.4f}ms"
        rows.append(row)
        log(f"{name:24s} {label:38s} err={err:.2e} (tol {tol:g}) "
            f"kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}ms "
            f"sdpa={row['library_ms']:.4f}ms{extra} "
            f"bound={row['bound_ms']:.4f}ms ({row['bound_by']})")
    return rows


def head256_cases(torch, kern, flash):
    """Kernels 1, 2, 3 and 5 at head width 256: the paged entries at
    paligemma-3b's width (H=8 over Hkv=1, group 8) and gemma3-1b's (H=4,
    group 4) over pages of 32 keys, f32, bf16 and f16 queries over their
    own pool and bf16 and f16 over int8, ragged and with lengths on the
    split (whole-page) edges (``paged_cases``); flash at both widths, B=4,
    bf16 at S = 512, 300 and 17, f16 at 300 and f32 (the FMA body) at 300
    (group 8), bf16 and f32 at 300 (group 4), causal and full."""
    pools = ("float32", "bfloat16", "float16", "int8", "int8/float16")
    for (H, DH, Hkv), verify_c in ((PALIGEMMA_WIDTH, (1, 5, 8)),
                                   (GEMMA3_WIDTH, (5,))):
        yield from paged_cases(torch, kern, H, DH, Hkv, pools=pools,
                               verify_c=verify_c, ps=PALI_TEXT_PS)
    g = torch.Generator(device="cuda").manual_seed(6)
    B = 4
    for (H, DH, Hkv), waves in (
            (PALIGEMMA_WIDTH, ((512, "bfloat16"), (300, "bfloat16"),
                               (17, "bfloat16"), (300, "float16"),
                               (300, "float32"))),
            (GEMMA3_WIDTH, ((300, "bfloat16"), (300, "float32")))):
        for S, dt in waves:
            q, k, v = (torch.randn((B, S, h, DH), generator=g, device="cuda")
                       .to(getattr(torch, dt)) for h in (H, Hkv, Hkv))
            for causal in (True, False):
                yield _flash_case(flash, q, k, v, causal, dt,
                                  f"group={H // Hkv} {dt} S={S} dh={DH}")


# the head-width-256 phase's kernel cases at its main path's shapes: the
# continuous engine's bf16 pool at 8 slots, scalar-start chunks and the
# C=5 window of spec_k 4; the static engine's 512-token wave of 4 (flash)
# and the dense decode at paligemma-3b's width (phase 3's dh-256 case)
PALI_TEXT_MAIN = {
    "paged_decode_attention": "group=8 pool=bfloat16 dh=256 ps=32",
    "chunk_prefill_attention":
        "group=8 pool=bfloat16 start=scalar dh=256 ps=32",
    "spec_verify_attention": "group=8 pool=bfloat16 C=5 dh=256 ps=32",
    "decode_attention": "group=8 pool=bfloat16 L=545 dh=256",
    "flash_attention": "group=8 bfloat16 S=512 dh=256 causal"}


def wide_cases(torch, kern, flash):
    """Every kernel entry at head widths 384 and 512, at groups 8 and 4
    over one KV head (``WIDE_WIDTHS``): the paged entries over pages of 32
    keys, f32, bf16 and f16 queries over their own pool and bf16 and f16
    over int8, ragged and with lengths, chunk and window frontiers on and
    beside the split edges (``paged_cases``; verify windows C = 1, 5, 8 at
    the served width, dh 512 group 4, and C = 5 elsewhere); the dense
    decode at L=545 over the same five query/cache pairs, ragged (B=4) and
    with kv_valid on its split edges (B=12, f32/bf16/f16/int8); flash at
    B=4, bf16 at S = 512, 300, 17 (the served width) or 300, f16 and f32
    (the FMA body) at 300, causal and full."""
    pools = ("float32", "bfloat16", "float16", "int8", "int8/float16")
    for H, DH, Hkv in WIDE_WIDTHS:
        served = (H, DH) == (WIDE_TEXT["n_heads"], WIDE_TEXT["head_dim"])
        yield from paged_cases(torch, kern, H, DH, Hkv, pools=pools,
                               verify_c=(1, 5, 8) if served else (5,),
                               ps=PALI_TEXT_PS)
    g = torch.Generator(device="cuda").manual_seed(8)
    L = QWEN_PROMPTS[-1] + QWEN_NEW + 1
    for H, DH, Hkv in WIDE_WIDTHS:
        for B, edges in ((4, False), (12, True)):
            yield from _dense_decode_pools(
                torch, kern, g, B, H, DH, Hkv, L,
                ("float32", "bfloat16", "float16", "int8"), edges)
        yield _dense_decode_case(torch, kern, g, 4, H, DH, Hkv, L, "int8",
                                 torch.float16, label=" q=float16")
    for H, DH, Hkv in WIDE_WIDTHS:
        served = (H, DH) == (WIDE_TEXT["n_heads"], WIDE_TEXT["head_dim"])
        waves = (((512, "bfloat16"), (17, "bfloat16")) if served else ())
        for S, dt in waves + ((300, "bfloat16"), (300, "float16"),
                              (300, "float32")):
            q, k, v = (torch.randn((4, S, h, DH), generator=g, device="cuda")
                       .to(getattr(torch, dt)) for h in (H, Hkv, Hkv))
            for causal in (True, False):
                yield _flash_case(flash, q, k, v, causal, dt,
                                  f"group={H // Hkv} {dt} S={S} dh={DH}")


# phase 23's kernel cases at its main path's shapes (as PALI_TEXT_MAIN):
# dh 512, group 4 over one KV head
WIDE_MAIN = {
    "paged_decode_attention": "group=4 pool=bfloat16 dh=512 ps=32",
    "chunk_prefill_attention":
        "group=4 pool=bfloat16 start=scalar dh=512 ps=32",
    "spec_verify_attention": "group=4 pool=bfloat16 C=5 dh=512 ps=32",
    "decode_attention": "group=4 pool=bfloat16 L=545 dh=512",
    "flash_attention": "group=4 bfloat16 S=512 dh=512 causal"}
# the dh-384 row of PERF.md's kernel table (off every served path)
WIDE_384 = {name: case.replace("group=4", "group=8").replace("dh=512",
                                                             "dh=384")
            .replace("S=512", "S=300")
            for name, case in WIDE_MAIN.items()}


def wider_cases(torch, kern, flash):
    """Every kernel entry above head width 512, on its width-generic
    instances: at ``WIDER_WIDTHS`` (640 and 1024 at groups 2 and 8 over
    one KV head, 1024 at group 1) the paged entries over pages of 32 keys,
    f32, bf16 and f16 queries over their own pool and bf16 and f16 over
    int8, ragged and with lengths, chunk and window frontiers on and
    beside the new splits' edges (verify windows C = 5, 9, 13 at the
    served width, dh 1024 group 2, and C = 5 elsewhere); the dense decode
    at L=545 over the same pairs, ragged (B=4) and on its split edges
    (B=12); flash at B=4, bf16 at S = 512, 300, 17 (the served width) or
    300, f16 and f32 at 300, causal and full. At ``WIDER_SPOT_WIDTHS``
    (768 and 2048, group 2) each entry in bf16 over bf16 and over int8
    and in f32, flash in bf16 and f32 at S=300."""
    served = (WIDER_TEXT["n_heads"], WIDER_TEXT["head_dim"], 1)
    for width in WIDER_WIDTHS:
        yield from paged_cases(torch, kern, *width,
                               pools=("float32", "bfloat16", "float16",
                                      "int8", "int8/float16"),
                               verify_c=(5, 9, 13) if width == served
                               else (5,), ps=PALI_TEXT_PS)
    for width in WIDER_SPOT_WIDTHS:
        yield from paged_cases(torch, kern, *width,
                               pools=("float32", "bfloat16", "int8"),
                               verify_c=(5,), ps=PALI_TEXT_PS)
    g = torch.Generator(device="cuda").manual_seed(9)
    L = QWEN_PROMPTS[-1] + QWEN_NEW + 1
    for H, DH, Hkv in WIDER_WIDTHS:
        for B, edges in ((4, False), (12, True)):
            yield from _dense_decode_pools(
                torch, kern, g, B, H, DH, Hkv, L,
                ("float32", "bfloat16", "float16", "int8"), edges)
        yield _dense_decode_case(torch, kern, g, 4, H, DH, Hkv, L, "int8",
                                 torch.float16, label=" q=float16")
    for H, DH, Hkv in WIDER_SPOT_WIDTHS:
        yield from _dense_decode_pools(torch, kern, g, 4, H, DH, Hkv, L,
                                       ("float32", "bfloat16", "int8"), False)
    for H, DH, Hkv in WIDER_WIDTHS + WIDER_SPOT_WIDTHS:
        waves = ((512, "bfloat16"), (17, "bfloat16")) if (
            H, DH, Hkv) == served else ()
        dts = (("bfloat16", "float32") if (H, DH, Hkv) in WIDER_SPOT_WIDTHS
               else ("bfloat16", "float16", "float32"))
        for S, dt in waves + tuple((300, dt) for dt in dts):
            q, k, v = (torch.randn((4, S, h, DH), generator=g, device="cuda")
                       .to(getattr(torch, dt)) for h in (H, Hkv, Hkv))
            for causal in (True, False):
                yield _flash_case(flash, q, k, v, causal, dt,
                                  f"group={H // Hkv} {dt} S={S} dh={DH}")


# phase 27's kernel cases at its main path's shapes (as PALI_TEXT_MAIN):
# dh 1024, group 2 over one KV head
WIDER_MAIN = {name: case.replace("group=4", "group=2").replace("dh=512",
                                                               "dh=1024")
              for name, case in WIDE_MAIN.items()}
# one row a width at 640, 768 and 2048 (off every served path), group 2
WIDER_ROWS = {dh: {name: case.replace("dh=1024", f"dh={dh}")
                   .replace("S=512", "S=300")
                   for name, case in WIDER_MAIN.items()}
              for dh in (640, 768, 2048)}
# the wider cases that phase 3 times; the rest it checks only
WIDER_TIMED = {(name, case) for cases in (WIDER_MAIN, *WIDER_ROWS.values())
               for name, case in cases.items()}


# ------------------------------ phase 4 --------------------------------- #

def requests(vocab: int, n_reqs: int = 16):
    """``n_reqs`` prompts of 64-448 tokens from a fixed seed; every other
    one opens with one shared 128-token document."""
    import numpy as np
    rng = np.random.default_rng(0)
    doc = rng.integers(1, vocab, size=128).tolist()
    reqs = []
    for i in range(n_reqs):
        if i % 2 == 0:
            n = int(rng.integers(160, 449))
            reqs.append(doc + rng.integers(1, vocab, size=n - 128).tolist())
        else:
            n = int(rng.integers(64, 449))
            reqs.append(rng.integers(1, vocab, size=n).tolist())
    return reqs


KERNELS = ("paged_decode_attention", "chunk_prefill_attention",
           "spec_verify_attention", "decode_attention", "flash_attention")
PAGED = KERNELS[:3]


def _entries() -> dict:
    """The counted kernel entries (``repro_torch.kernels.entries``)."""
    from repro_torch.kernels import entries
    return entries()


def zero_counts() -> None:
    for fn in _entries().values():
        fn.launches = 0
        fn.launches_by_heads.clear()


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _entries().items()}


def read_heads() -> dict:
    """The launches since ``zero_counts`` by (entry, KV heads)."""
    return {(name, h): n for name, fn in _entries().items()
            for h, n in fn.launches_by_heads.items()}


@contextlib.contextmanager
def count_plain(*modules):
    """Count the calls of every plain version (``*_plain``) of the
    kernels' modules while the block runs: on the card the serving path
    must make none."""
    calls, saved = {}, []
    for mod in modules:
        for name in dir(mod):
            if name.endswith("_plain"):
                fn = getattr(mod, name)

                def counted(*a, _fn=fn, _name=f"{mod.__name__}.{name}", **kw):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*a, **kw)
                saved.append((mod, name, fn))
                setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_run(torch, kern, ServeEngine, RuntimeOptions, cfg, params, reqs,
              label, need, **kw):
    """One full-width bf16 serve of ``reqs`` (64 new tokens each). The
    kernels in ``need`` must launch during it; the trace must reconcile,
    every page must be freed and every token lie in the vocabulary.
    Returns (engine, outputs, result row)."""
    before = read_counts()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, RuntimeOptions(dtype="bfloat16"),
                      device="cuda", seed=0, scheduler="continuous",
                      page_size=PS, max_batch=8, prefill_chunk=C,
                      decode_lookahead=8, max_len=MAX_LEN, **kw)
    outs = eng.serve([r[:] for r in reqs], 64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats
    n = {k: v - before[k] for k, v in read_counts().items()}
    g = eng.graphs
    check(all(n[k] > 0 for k in need), f"{label}: kernels not launched {n}")
    check(eng.trace_report["ok"], f"{label}: trace did not reconcile")
    check(eng.kv_manager.n_used == 0, f"{label}: pages leaked")
    check(all(len(o) == 64 and all(0 <= t < cfg.vocab for t in o)
              for o in outs), f"{label}: malformed outputs")
    row = dict(
        tokens_per_s=s.tps, ttft_p50_ms=s.ttft_p50 * 1e3,
        ttft_p95_ms=s.ttft_p95 * 1e3, itl_p50_ms=s.itl_p50 * 1e3,
        itl_p95_ms=s.itl_p95 * 1e3, host_syncs=s.host_syncs,
        prefill_tokens_computed=s.prefill_tokens_computed,
        prefill_tokens_saved=s.cached_prefix_tokens,
        peak_pages=s.peak_pages_used, cow_copies=s.cow_copies,
        decode_steps=s.decode_steps, prefill_s=s.prefill_s,
        decode_s=s.decode_s, serve_s=s.serve_s, wall_s=wall,
        spec_blocks=s.spec_blocks, draft_proposed=s.draft_proposed,
        draft_accepted=s.draft_accepted, acceptance=s.acceptance_rate,
        launches=n, decode_compiles=s.decode_compiles,
        prefill_compiles=s.prefill_compiles,
        captures=g.captures if g else 0, capture_s=g.capture_s if g else 0.0,
        graph_bytes=g.memory_bytes if g else 0, outputs=outs)
    log(f"engine {label:14s} tokens/s={s.tps:.1f} "
        f"ttft p50/p95={s.ttft_p50*1e3:.1f}/{s.ttft_p95*1e3:.1f}ms "
        f"itl p50/p95={s.itl_p50*1e3:.2f}/{s.itl_p95*1e3:.2f}ms "
        f"host_syncs={s.host_syncs} accept={s.acceptance_rate:.3f} "
        f"({s.draft_accepted}/{s.draft_proposed}, {s.spec_blocks} passes) "
        f"prefill_saved={s.cached_prefix_tokens} "
        f"peak_pages={s.peak_pages_used} launches "
        + " ".join(f"{k.split('_')[0]}={v}" for k, v in n.items())
        + (f" captures={g.captures} ({g.capture_s:.2f}s)" if g else " eager")
        + f" wall={wall:.1f}s")
    return eng, outs, row


def serve_full_width(torch, kern, ServeEngine, RuntimeOptions, cfg):
    """The spec-off path: greedy, native and int8 KV; the native run's
    Chrome trace through ``check_trace_on``."""
    reqs = requests(cfg.vocab)
    results = {}
    params = None
    zero_counts()
    for policy in ("native", "int8"):
        eng, _, results[policy] = serve_run(
            torch, kern, ServeEngine, RuntimeOptions, cfg, params, reqs,
            policy, PAGED[:2], kv_policy=policy)
        params = eng.params                 # one seeded init for every run
        if policy == "native":
            results[policy]["trace_check"] = check_trace_on(eng)
    return results, read_counts(), params


def check_trace_on(eng) -> str:
    """Write ``eng``'s Chrome trace of its last serve under build/ and pass
    it through the port's ``check_trace --strict-vocab`` (structure, each
    request's phases summing to its latency, the channel vocabulary),
    which must exit 0. Returns its line."""
    from repro_torch.serving import check_trace
    path = ROOT / "build" / "smoke_serve_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    eng.trace.save(str(path))
    try:
        rc, line = check_trace.main(["--strict-vocab", str(path)])
    finally:
        path.unlink()
    check(rc == 0, f"check_trace --strict-vocab failed: {line}")
    log(f"check_trace on the native serve's trace: {line}")
    return line


def sampling_on_card(torch):
    """The counter-based draws on the card equal the CPU's (the integer
    hash exactly, the Gumbel noise to the last f32 place), and tokens
    sampled on the card follow softmax(filtered logits)."""
    from repro_torch.models import sampling as ts
    rids, idx = torch.arange(64) * 7919, torch.arange(64) * 3
    draw = torch.arange(4096)
    kc = ts.request_keys(5, rids.cuda(), idx.cuda())
    kh = ts.request_keys(5, rids, idx)
    check(torch.equal(ts.uniforms(kc, draw.cuda()).cpu(),
                      ts.uniforms(kh, draw)), "uniforms differ card vs CPU")
    gerr = float((ts.gumbel(kc, 4096).cpu() - ts.gumbel(kh, 4096)).abs()
                 .max())
    check(gerr <= 1e-5, f"Gumbel noise differs card vs CPU by {gerr:.2e}")
    V, N = 8, 20000
    row = torch.tensor([1.2, 0.3, -0.4, 2.0, 0.0, -1.0, 0.9, 0.1],
                       device="cuda")
    keys = ts.request_keys(1, torch.arange(N, device="cuda") % 97,
                           torch.arange(N, device="cuda") // 97)
    kw = dict(temperature=0.8, top_k=6, top_p=0.9)
    tok = ts.sample(row.expand(N, V), ts.gumbel(keys, V), **kw)
    emp = torch.bincount(tok.long(), minlength=V).float().cpu() / N
    want = torch.softmax(ts.filtered_logits(row[None], **kw), -1)[0].cpu()
    tv = 0.5 * float((emp - want).abs().sum())
    check(tv < 0.03, f"sampled frequencies off by TV {tv:.3f}")
    log(f"sampling draws on the card == CPU (Gumbel max diff {gerr:.1e}); "
        f"{N} sampled tokens within TV {tv:.4f} of softmax(filtered)")
    return dict(gumbel_max_diff=gerr, sample_tv=tv)


def serve_spec(torch, kern, ServeEngine, RuntimeOptions, cfg, params):
    """The speculative and sampling path on the same traffic: n-gram spec,
    the target drafting for itself, and two sampled runs."""
    reqs = requests(cfg.vocab)
    spec = dict(spec_mode="ngram", spec_k=4)
    sampled = dict(spec, temperature=0.8, top_k=50, top_p=0.9,
                   sample_seed=7, overlap=False)
    runs = {}
    zero_counts()
    _, greedy, runs["ngram"] = serve_run(
        torch, kern, ServeEngine, RuntimeOptions, cfg, params, reqs, "ngram",
        ("spec_verify_attention", "chunk_prefill_attention"), **spec)
    _, _, runs["self-draft"] = serve_run(
        torch, kern, ServeEngine, RuntimeOptions, cfg, params, reqs,
        "self-draft", PAGED, spec_mode="model", spec_k=4, draft_cfg=cfg,
        draft_params=params)
    acc = runs["self-draft"]["acceptance"]
    check(acc >= 0.9, f"self-draft accepted {acc:.3f} < 0.9 of its "
          f"proposals: the draft's decode path and the target's verify "
          f"path disagree")
    outs = []
    for i in range(2):
        _, o, runs[f"sampled-{i}"] = serve_run(
            torch, kern, ServeEngine, RuntimeOptions, cfg, params, reqs,
            f"sampled-{i}", ("spec_verify_attention",), **sampled)
        outs.append(o)
    check(outs[0] == outs[1], "sampled runs with one sample_seed differ")
    same = sum(a == b for a, b in zip(outs[0], greedy))
    log(f"sampled runs identical; {same}/{len(greedy)} requests equal to "
        f"the greedy n-gram run")
    counts = read_counts()
    runs["sampling_draws"] = sampling_on_card(torch)
    return runs, counts


def profile_decode_block(torch, tm, cfg, params, name="decode block",
                         ops=(), no_sync=False):
    """Where a fused paged decode block's time goes: one K=8 block over 8
    slots holding 300 cached tokens each, at full width; the device time of
    the PyTorch ops in ``ops``. With ``no_sync`` the block then runs once
    more under sync debug mode "error": no host sync inside it."""
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, K = 8, 8
    n_pp = -(-MAX_LEN // PS)
    cache = tm.init_paged_cache(cfg, B * n_pp + 1, PS, opts, "cuda")
    pt = torch.arange(1, B * n_pp + 1, dtype=torch.int32,
                      device="cuda").reshape(B, n_pp)
    lens = torch.full((B,), 300, dtype=torch.int32, device="cuda")
    tok = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")

    def block():
        tm.decode_steps_paged(cfg, params, tok, lens, pt, cache, K, opts)
        torch.cuda.synchronize()
    res = profile_block(torch, block, f"{name} K={K} B={B} len=300",
                        paged_passes=True, ops=ops)
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
        try:
            tm.decode_steps_paged(cfg, params, tok, lens, pt, cache, K, opts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"{name} K={K}: no host sync inside it")
    return res


def profile_chunk_block(torch, tm, cfg, params):
    """Where a full-width prefill chunk's time goes: one
    prefill_paged_chunk of B=1, C=64 positions at start 384 (448 keys),
    bf16 pool."""
    opts = tm.RuntimeOptions(dtype="bfloat16")
    n_pp = -(-MAX_LEN // PS)
    cache = tm.init_paged_cache(cfg, n_pp + 1, PS, opts, "cuda")
    pt = torch.arange(1, n_pp + 1, dtype=torch.int32, device="cuda")[None]
    toks = torch.arange(1, C + 1, dtype=torch.int32, device="cuda")[None]
    nv = torch.tensor([384 + C], dtype=torch.int32, device="cuda")

    def block():
        tm.prefill_paged_chunk(cfg, params, toks, cache, pt, 384, nv, opts)
        torch.cuda.synchronize()
    return profile_block(torch, block, f"prefill chunk B=1 C={C} start=384",
                         chunk_pass2=True)


def profile_verify_block(torch, tm, cfg, params):
    """Where a full-width verify pass's time goes: one spec_decode_verify
    of B=8 windows of C=5 (4 drafts each) over 300 cached tokens, bf16
    pool, greedy."""
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, Cv = 8, 5
    n_pp = -(-MAX_LEN // PS)
    cache = tm.init_paged_cache(cfg, B * n_pp + 1, PS, opts, "cuda")
    pt = torch.arange(1, B * n_pp + 1, dtype=torch.int32,
                      device="cuda").reshape(B, n_pp)
    toks = torch.arange(1, B * Cv + 1, dtype=torch.int32,
                        device="cuda").reshape(B, Cv)
    draft = torch.full((B,), Cv - 1, dtype=torch.int32, device="cuda")
    lens = torch.full((B,), 300, dtype=torch.int32, device="cuda")

    def block():
        tm.spec_decode_verify(cfg, params, toks, draft, lens, pt, cache,
                              opts=opts)
        torch.cuda.synchronize()
    return profile_block(torch, block, f"verify pass B={B} C={Cv} len=300",
                         chunk_pass2=True)


# ------------------------------ phase 5 --------------------------------- #

def qwen_requests(vocab: int):
    """4 prompts of 256 and 4 of 512 tokens from a fixed seed: two static
    waves."""
    import numpy as np
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=n).tolist()
            for n in QWEN_PROMPTS for _ in range(4)]


def serve_static(torch, kern, ServeEngine, RuntimeOptions, cfg):
    """qwen2.5-3b at full width, bf16, the port's seeded init on the card,
    through the static engine (serve_bucketed, K=8), native and int8 KV.
    Each wave must launch the flash kernel once a layer and the dense
    decode kernel once a layer a micro-step, the plain versions never,
    and emit in-vocabulary tokens. Returns (rows, launches, params)."""
    from repro_torch.kernels import flash_attention as flash
    reqs = qwen_requests(cfg.vocab)
    waves = len(QWEN_PROMPTS)
    results, params = {}, None
    zero_counts()
    for policy in ("native", "int8"):
        eng = ServeEngine(cfg, params, RuntimeOptions(dtype="bfloat16"),
                          device="cuda", seed=0, scheduler="static",
                          kv_policy=policy, decode_lookahead=8,
                          max_len=QWEN_MAX_LEN)
        params = eng.params                 # one seeded init for both runs
        before = read_counts()
        with count_plain(kern, flash) as plain:
            t0 = time.perf_counter()
            outs = eng.serve([r[:] for r in reqs], QWEN_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        s = eng.stats
        n = {k: v - before[k] for k, v in read_counts().items()}
        label = f"static {policy}"
        check(s.decode_steps == waves * QWEN_NEW,
              f"{label}: {s.decode_steps} micro-steps, not {QWEN_NEW} a wave")
        check(n["flash_attention"] == cfg.n_layers * waves,
              f"{label}: flash launches {n['flash_attention']} != "
              f"{cfg.n_layers} x {waves} waves")
        check(n["decode_attention"] == cfg.n_layers * s.decode_steps,
              f"{label}: decode launches {n['decode_attention']} != "
              f"{cfg.n_layers} x {s.decode_steps} micro-steps")
        check(all(n[k] == 0 for k in PAGED), f"{label}: paged launches {n}")
        check(not plain, f"{label}: plain versions called on the card: "
              f"{plain}")
        check(all(len(o) == QWEN_NEW and all(0 <= t < cfg.vocab for t in o)
                  for o in outs), f"{label}: malformed outputs")
        results[policy] = dict(
            tokens_per_s=s.tps, prefill_s=s.prefill_s, decode_s=s.decode_s,
            host_syncs=s.host_syncs, decode_steps=s.decode_steps,
            decode_compiles=s.decode_compiles, new_tokens=s.new_tokens,
            requests=s.requests, wall_s=wall, launches=n)
        log(f"{label} tokens/s={s.tps:.1f} prefill_s={s.prefill_s:.3f} "
            f"decode_s={s.decode_s:.3f} host_syncs={s.host_syncs} "
            f"decode_steps={s.decode_steps} "
            f"decode_compiles={s.decode_compiles} launches flash="
            f"{n['flash_attention']} decode={n['decode_attention']} "
            f"wall={wall:.1f}s")
    return results, read_counts(), params


def profile_static_block(torch, tm, cfg, params, cache_dtype="", B=4,
                         S=max(QWEN_PROMPTS), dtype="bfloat16"):
    """Where a fused static decode block's time goes: one K=8 block of a
    B-sequence wave whose dense caches hold an S-token prompt, at full
    width, with a native ("") or int8 cache."""
    opts = tm.RuntimeOptions(dtype=dtype, cache_dtype=cache_dtype)
    K = 8
    cache = tm.init_cache(cfg, B, S + 1 + QWEN_NEW, opts, "cuda")
    tok = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")

    def block():
        tm.decode_steps(cfg, params, tok, S, cache, K, opts)
        torch.cuda.synchronize()
    res = profile_block(torch, block,
                        f"{cfg.name} static decode block K={K} B={B} "
                        f"pos={S} cache={cache_dtype or 'native'}")
    del cache
    return res


def profile_block(torch, block, label, chunk_pass2=False,
                  paged_passes=False, ops=()):
    """Device busy time of one call of ``block`` is the sum of the kernels
    torch.profiler records (a CUDA graph's replay too); the wall time is
    taken without the profiler (median of 5). The port's attention kernels live in the namespace
    ``repro_paged``. With ``paged_passes`` (a block whose only attention
    is the paged decode) its pass 1 and its combine are reported apart.
    For each PyTorch op named in ``ops`` (e.g. ``aten::bmm``), the device
    time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    block()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        block()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block()
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            count[e.name] = count.get(e.name, 0) + 1
    busy_ms = sum(by_name.values())
    check(busy_ms > 0, "the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if "repro_paged" in k)
    # the chunk kernel; with chunk_pass2 its combine pass too (the block
    # runs no other split-K kernel, which would share the combine's name)
    chunk = sum(v for k, v in by_name.items() if "repro_paged" in k
                and ("chunk_" in k or chunk_pass2 and "split_combine" in k))
    log(f"{label}: wall {wall_ms:.2f}ms, device "
        f"busy {busy_ms:.2f}ms ({100 * busy_ms / wall_ms:.1f}% of wall), "
        f"attention kernels {attn:.2f}ms "
        f"({100 * attn / busy_ms:.1f}% of busy), chunk kernel {chunk:.3f}ms "
        f"({100 * chunk / busy_ms:.1f}% of busy)")
    for name, ms in top:
        log(f"  {ms:7.3f}ms {100 * ms / busy_ms:5.1f}%  {name[:70]}")
    kernels = {n: dict(launches=count[n], mean_us=1e3 * v / count[n])
               for n, v in by_name.items() if "repro_paged" in n}
    for name, k in kernels.items():
        log(f"  attention {k['launches']:4d} x {k['mean_us']:7.2f}us  "
            f"{name[:60]}")
    passes = {}
    if paged_passes:
        for part, pick in (("pass1", lambda n: "combine" not in n),
                           ("combine", lambda n: "combine" in n)):
            names = [n for n in by_name if "repro_paged" in n and pick(n)]
            ms = sum(by_name[n] for n in names)
            n_launch = sum(count[n] for n in names)
            passes[part] = dict(ms=ms, launches=n_launch,
                                mean_us=1e3 * ms / max(n_launch, 1))
            log(f"  paged decode {part}: {n_launch} x "
                f"{passes[part]['mean_us']:.2f}us = {ms:.3f}ms "
                f"({100 * ms / busy_ms:.1f}% of busy)")
    op_ms = {}
    for name in ops:
        op_ms[name] = sum(k.duration for e in prof.events()
                          if e.device_type == DeviceType.CPU
                          and e.name == name for k in e.kernels) / 1e3
        log(f"  {name}: {op_ms[name]:.3f}ms "
            f"({100 * op_ms[name] / busy_ms:.1f}% of busy)")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, paged=passes,
                op_ms=op_ms,
                busy_share=busy_ms / wall_ms, attention_ms=attn,
                chunk_ms=chunk, chunk_share=chunk / busy_ms,
                top=[dict(name=n, ms=v) for n, v in top],
                attention_kernels=kernels)


# ------------------------------ phase 6 --------------------------------- #

def f32_checks(torch, tm, ServeEngine, cfg):
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tm.init_params(cfg, gen, "float32", "cuda")
    opts = tm.RuntimeOptions(dtype="float32")

    # the kernel path against the CPU plain path, one prompt
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab, size=(1, C)).astype(np.int32)
    n_pp = -(-MAX_LEN // PS)
    pt = np.zeros((1, n_pp), np.int32)
    pt[0, :6] = [7, 3, 11, 5, 9, 2]
    logits = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to(params, "cpu")
        cache = tm.init_paged_cache(cfg, 13, PS, opts, dev)
        lg, cache = tm.prefill_paged_chunk(
            cfg, p, torch.as_tensor(toks, device=dev), cache,
            torch.as_tensor(pt, device=dev), 0,
            torch.tensor([C - 3], dtype=torch.int32, device=dev), opts)
        tok = torch.tensor([int(toks[0, 5])], dtype=torch.int32, device=dev)
        ld, _ = tm.decode_step_paged(
            cfg, p, tok, torch.tensor([C - 3], dtype=torch.int32, device=dev),
            torch.as_tensor(pt, device=dev), cache, opts)
        logits[dev] = (lg[0, :C - 3].float().cpu(), ld.float().cpu())
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cuda"], logits["cpu"]))
    scale = float(logits["cpu"][0].abs().max())
    log(f"f32 kernel path vs CPU plain path: max |logit diff| = {err:.2e} "
        f"(max |logit| {scale:.2f})")
    check(err <= 2e-3 * max(scale, 1.0), "GPU and CPU logits disagree")

    # decode_lookahead 8 == decode_lookahead 1
    reqs = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
            for n in rng.integers(16, 129, size=4)]
    outs = {}
    for k in (1, 8):
        eng = ServeEngine(cfg, params, opts, device="cuda",
                          scheduler="continuous", page_size=PS, max_batch=8,
                          prefill_chunk=C, decode_lookahead=k,
                          max_len=MAX_LEN)
        outs[k] = eng.serve([r[:] for r in reqs], 16)
        check(eng.trace_report["ok"] and eng.kv_manager.n_used == 0,
              f"K={k}: trace did not reconcile or pages leaked")
    check(outs[1] == outs[8], "decode_lookahead 8 diverged from 1")
    log(f"f32 decode_lookahead 8 == 1 on {len(reqs)} requests "
        f"({sum(map(len, outs[8]))} tokens)")

    # n-gram speculation (k=4) == no speculation, up to a near-tie
    eng = ServeEngine(cfg, params, opts, device="cuda",
                      scheduler="continuous", page_size=PS, max_batch=8,
                      prefill_chunk=C, max_len=MAX_LEN, spec_mode="ngram",
                      spec_k=4)
    spec = eng.serve([r[:] for r in reqs], 16)
    check(eng.trace_report["ok"] and eng.kv_manager.n_used == 0,
          "spec: trace did not reconcile or pages leaked")
    check(eng.stats.spec_blocks > 0, "spec: no verify pass ran")
    n_tie = 0
    for prompt, got, want in zip(reqs, spec, outs[8]):
        if got != want:
            n = tie_free_prefix(torch, tm, cfg, params, opts, prompt, want)
            check(n < len(want) and got[:n] == want[:n],
                  f"f32 n-gram spec diverged from spec-off before any "
                  f"near-tie: {got} vs {want}")
            n_tie += 1
    log(f"f32 n-gram spec k=4 == spec-off on {len(reqs)} requests "
        f"({eng.stats.spec_blocks} verify passes, accepted "
        f"{eng.stats.draft_accepted}/{eng.stats.draft_proposed}; "
        f"{n_tie} requests differ after a top-2 gap < 1e-4)")
    return err


def f32_static_checks(torch, tm, ServeEngine, cfg_full):
    """qwen2.5-3b at full width but 4 layers, f32: the kernel path's
    prefill and decode logits against the CPU plain path; static K=8 ==
    K=1; static == continuous on the static phase's requests (up to a
    near-tie)."""
    import numpy as np
    cfg = dataclasses.replace(cfg_full, n_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tm.init_params(cfg, gen, "float32", "cuda")
    opts = tm.RuntimeOptions(dtype="float32")

    rng = np.random.default_rng(2)
    B, S, n_dec = 2, 128, 3
    toks = rng.integers(1, cfg.vocab, size=(B, S + n_dec)).astype(np.int32)
    logits = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to(params, "cpu")
        cache = tm.init_cache(cfg, B, S + n_dec, opts, dev)
        lg, cache = tm.prefill(cfg, p, torch.as_tensor(toks[:, :S],
                                                       device=dev),
                               cache, opts)
        rows = [lg.float().cpu()]
        for j in range(n_dec):
            lg, cache = tm.decode_step(
                cfg, p, torch.as_tensor(toks[:, S + j], device=dev), S + j,
                cache, opts)
            rows.append(lg.float().cpu())
        logits[dev] = torch.stack(rows)
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    log(f"f32 static kernel path vs CPU plain path (qwen2.5-3b, 4 layers): "
        f"max |logit diff| = {err:.2e} (max |logit| {scale:.2f})")
    check(err <= 2e-3 * max(scale, 1.0), "static GPU and CPU logits disagree")

    reqs = qwen_requests(cfg.vocab)
    new = 16
    outs = {}
    for k in (1, 8):
        eng = ServeEngine(cfg, params, opts, device="cuda",
                          scheduler="static", decode_lookahead=k,
                          max_len=QWEN_MAX_LEN)
        outs[k] = eng.serve([r[:] for r in reqs], new)
    check(outs[1] == outs[8], "static decode_lookahead 8 diverged from 1")
    eng = ServeEngine(cfg, params, opts, device="cuda",
                      scheduler="continuous", page_size=PS, max_batch=8,
                      prefill_chunk=C, max_len=QWEN_MAX_LEN)
    cont = eng.serve([r[:] for r in reqs], new)
    check(eng.trace_report["ok"] and eng.kv_manager.n_used == 0,
          "continuous: trace did not reconcile or pages leaked")
    n_tie = 0
    for prompt, got, want in zip(reqs, cont, outs[8]):
        if got != want:
            n = tie_free_prefix(torch, tm, cfg, params, opts, prompt, want)
            check(n < len(want) and got[:n] == want[:n],
                  f"f32 continuous diverged from static before any "
                  f"near-tie: {got} vs {want}")
            n_tie += 1
    log(f"f32 static K=8 == K=1 and static == continuous on {len(reqs)} "
        f"requests ({sum(map(len, outs[8]))} tokens; {n_tie} differ after "
        f"a top-2 gap < 1e-4)")
    return dict(logit_err=err, near_tie_requests=n_tie)


def tie_free_prefix(torch, tm, cfg, params, opts, prompt, out, gap=1e-4):
    """Length of ``out`` before the first position whose spec-off logits
    (one chunked prefill of prompt + out) have a top-2 gap below ``gap``:
    there argmax may flip between two correct runs."""
    seq = prompt + out
    n_pp = -(-MAX_LEN // PS)
    cache = tm.init_paged_cache(cfg, n_pp + 1, PS, opts, "cuda")
    pt = torch.arange(1, n_pp + 1, dtype=torch.int32, device="cuda")[None]
    rows = []
    for start in range(0, len(seq), C):
        toks = torch.zeros((1, C), dtype=torch.int32, device="cuda")
        chunk = seq[start:start + C]
        toks[0, :len(chunk)] = torch.tensor(chunk, device="cuda")
        lg, cache = tm.prefill_paged_chunk(
            cfg, params, toks, cache, pt, start,
            torch.tensor([start + len(chunk)], dtype=torch.int32,
                         device="cuda"), opts)
        rows.append(lg[0, :len(chunk)].float().cpu())
    lg = torch.cat(rows)[len(prompt) - 1:len(prompt) - 1 + len(out)]
    top2 = lg.topk(2, dim=-1).values
    near = torch.nonzero(top2[:, 0] - top2[:, 1] < gap)
    return int(near[0, 0]) if len(near) else len(out)


# ------------------------------ phase 7 --------------------------------- #

def n_prefill_chunks(eng) -> int:
    """Prefill chunks the continuous engine ran in its last serve (its
    trace records one span each)."""
    return sum(e.get("name") == "prefill_chunk"
               for e in eng.trace.to_chrome()["traceEvents"])


def engine_twice(torch, kern, ServeEngine, RuntimeOptions, cfg, params,
                 reqs, label, scheduler, new, model="arctic", page_size=PS,
                 cm=None, **kw):
    """One full-width bf16 serve of ``reqs`` (arctic-480b's, or ``model``'s),
    twice: the two runs must emit the same tokens. The continuous engine
    runs its streams serialized (``overlap=False``): overlapped, a decode
    block's slots depend on measured wall times, and under capacity
    routing the tokens a step holds decide which replicas drop (and a
    bf16 product's rounding may follow its batch). Each run must launch
    its path's kernels exactly n_layers times a micro-step, prefill chunk,
    verify pass or static wave (counts set to 0 just before it), call no
    plain version (nor, given the models' ``cm``, the masked attention),
    reconcile its trace (continuous), free every page and emit
    in-vocabulary tokens. Returns (launches of the first run, the runs'
    rows)."""
    from repro_torch.kernels import flash_attention as flash
    L = cfg.n_layers
    outs, runs = [], []
    for _ in range(2):
        if scheduler == "static":
            eng = ServeEngine(cfg, params, RuntimeOptions(dtype="bfloat16"),
                              device="cuda", scheduler="static",
                              decode_lookahead=8, max_len=QWEN_MAX_LEN, **kw)
        else:
            eng = ServeEngine(cfg, params, RuntimeOptions(dtype="bfloat16"),
                              device="cuda", scheduler="continuous",
                              page_size=page_size, max_batch=8,
                              prefill_chunk=C, decode_lookahead=8,
                              max_len=MAX_LEN, overlap=False, **kw)
        zero_counts()
        if cm is not None:
            cm.attention.calls = 0
        with count_plain(kern, flash) as plain:
            t0 = time.perf_counter()
            out = eng.serve([r[:] for r in reqs], new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = read_counts()
        s = eng.stats
        if scheduler == "static":
            waves = len({len(r) for r in reqs})
            check(s.decode_steps == waves * new, f"{label}: "
                  f"{s.decode_steps} micro-steps, not {new} a wave")
            want = dict(paged_decode_attention=0, chunk_prefill_attention=0,
                        spec_verify_attention=0,
                        decode_attention=L * s.decode_steps,
                        flash_attention=L * waves)
        else:
            check(eng.trace_report["ok"], f"{label}: trace did not reconcile")
            check(eng.kv_manager.n_used == 0, f"{label}: pages leaked")
            want = dict(paged_decode_attention=L * (s.decode_steps
                                                    - s.spec_blocks),
                        chunk_prefill_attention=L * n_prefill_chunks(eng),
                        spec_verify_attention=L * s.spec_blocks,
                        decode_attention=0, flash_attention=0)
        check(n == want, f"{label}: launches {n} != {want}")
        check(not plain, f"{label}: plain versions called on the card: "
              f"{plain}")
        check(cm is None or cm.attention.calls == 0,
              f"{label}: the masked attention ran on a kernel path")
        check(all(len(o) == new and all(0 <= t < cfg.vocab for t in o)
                  for o in out), f"{label}: malformed outputs")
        outs.append(out)
        runs.append(dict(
            tokens_per_s=s.tps, ttft_p50_ms=s.ttft_p50 * 1e3,
            ttft_p95_ms=s.ttft_p95 * 1e3, itl_p50_ms=s.itl_p50 * 1e3,
            itl_p95_ms=s.itl_p95 * 1e3, prefill_s=s.prefill_s,
            decode_s=s.decode_s, host_syncs=s.host_syncs,
            decode_steps=s.decode_steps, spec_blocks=s.spec_blocks,
            acceptance=s.acceptance_rate, decode_compiles=s.decode_compiles,
            prefill_tokens_saved=s.cached_prefix_tokens, wall_s=wall,
            launches=n))
        log(f"{model} {label:16s} tokens/s={s.tps:.1f} "
            f"ttft p50={s.ttft_p50*1e3:.1f}ms itl p50={s.itl_p50*1e3:.2f}ms "
            f"prefill_s={s.prefill_s:.3f} decode_s={s.decode_s:.3f} "
            f"host_syncs={s.host_syncs} decode_steps={s.decode_steps} "
            f"verify={s.spec_blocks} accept={s.acceptance_rate:.3f} "
            f"saved={s.cached_prefix_tokens} launches "
            + " ".join(f"{k.split('_')[0]}={v}" for k, v in n.items())
            + f" wall={wall:.1f}s")
    check(outs[0] == outs[1], f"{label}: a repeated run emitted other "
          f"tokens")
    return runs[0]["launches"], dict(runs=runs)


def moe_on_card(torch, tm, cfg, params):
    """The MoE FFN on the card: at one full-width layer and a decode step's
    T=8 tokens, the ragged path against the capacity path at
    capacity_factor = E (nothing drops) in bf16; the capacity path at T=8
    and T=64 with no host sync (sync debug mode "error"); and on the
    reduced twin in f32 against the same function on the CPU (same expert
    ids, outputs within 1e-5). Returns the measurements."""
    from repro_torch.configs.reduce import reduced
    from repro_torch.models import moe as tmoe
    p = _layer(params["stack"], 0)["moe"]
    E, d = cfg.moe.n_experts, cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(7)
    x8 = torch.randn((1, 8, d), generator=g, device="cuda").bfloat16()
    cap, _ = tmoe.moe_ffn(p, x8, cfg, capacity_factor=float(E))
    rag, _ = tmoe.moe_ffn(p, x8, cfg, impl="ragged")
    rag_err = float((cap.float() - rag.float()).abs().max())
    scale = float(rag.float().abs().max())
    # two bf16 ulps at the output's largest magnitude: the two paths round
    # the same products to bf16 after summing them in other orders
    rag_tol = 2 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    check(rag_err <= rag_tol, f"MoE ragged vs capacity (cf=E) at T=8: "
          f"{rag_err:.3g} > {rag_tol:.3g}")
    ms = {}
    for T in (8, 64):
        x = torch.randn((1, T, d), generator=g, device="cuda").bfloat16()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = tmoe.moe_ffn(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(y).all()), f"MoE output at T={T} is not "
              f"finite")
        ms[T] = median_ms(torch, lambda p=p, x=x: tmoe.moe_ffn(p, x, cfg),
                          iters=10)
    # the bytes one layer's capacity dispatch must read: every expert's
    # weights (C >= 1 for each of the E experts), the router and the
    # dense residual
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(p))
    log(f"MoE ffn full width: ragged vs capacity (cf=E) T=8 max err "
        f"{rag_err:.3g} (tol {rag_tol:.3g}, |out| max {scale:.3g}); no host "
        f"sync at T=8, 64; one layer {ms[8]:.3f}ms (T=8), {ms[64]:.3f}ms "
        f"(T=64) for {w_bytes / 1e9:.2f} GB of weights "
        f"(bound {w_bytes / HBM_BYTES_PER_S * 1e3:.3f}ms)")

    small = reduced(cfg, d_model=64)
    sp = tm.init_params(small, torch.Generator().manual_seed(0), "float32",
                        "cpu")
    p32 = _layer(sp["stack"], 0)["moe"]
    x = torch.randn((1, 64, 64), generator=torch.Generator().manual_seed(1))
    x = x + torch.randn((64,), generator=torch.Generator().manual_seed(2))
    outs, ids = {}, {}
    for dev in ("cpu", "cuda"):
        pd, xd = _to(p32, dev), x.to(dev)
        ids[dev] = tmoe._route(pd, xd.reshape(64, 64), small.moe.top_k)[-1]
        outs[dev] = tmoe.moe_ffn(pd, xd, small)[0].cpu()
    check(torch.equal(ids["cuda"].cpu(), ids["cpu"]),
          "MoE routing differs card vs CPU (reduced twin, f32)")
    cpu_err = float((outs["cuda"] - outs["cpu"]).abs().max())
    check(cpu_err <= 1e-5, f"MoE card vs CPU (reduced twin, f32): "
          f"{cpu_err:.3g} > 1e-5")
    log(f"MoE ffn reduced twin f32: card == CPU routing, max err "
        f"{cpu_err:.2e} (tol 1e-5)")
    return dict(ragged_vs_capacity_err=rag_err, ragged_tol=rag_tol,
                out_max=scale, layer_ms_t8=ms[8], layer_ms_t64=ms[64],
                layer_weight_bytes=w_bytes, cpu_err=cpu_err)


def serve_arctic(torch, kern, tm, ServeEngine, get_config):
    """arctic-480b at full width but 2 of 35 layers (the only cut), bf16,
    the port's seeded init: the continuous engine (native, int8, n-gram
    k=4) and the static engine (native, int8); the MoE FFN on the card;
    one decode block profiled."""
    full = get_config("arctic-480b")
    cfg = dataclasses.replace(full, n_layers=ARCTIC_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "bfloat16", "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    per_layer = sum(t[0].numel() for t in _leaves(params["stack"]))
    log(f"arctic-480b: depth cut {full.n_layers} -> {cfg.n_layers} layers, "
        f"width as published (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff_expert "
        f"{cfg.moe.d_ff_expert}, dense residual {cfg.moe.d_ff_dense}, vocab "
        f"{cfg.vocab}): {per_layer / 1e9:.2f} B parameters a layer, "
        f"{n_params / 1e9:.2f} B in all, "
        f"{(torch.cuda.memory_allocated() - before) / 1e9:.1f} GB on the "
        f"card ({before / 1e9:.2f} GB held before), init "
        f"{time.perf_counter() - t0:.1f}s")
    reqs = requests(cfg.vocab, ARCTIC_REQS)
    static_reqs = qwen_requests(cfg.vocab)
    runs, launches = {}, {}
    for label, sched, new, kw in (
            ("native", "continuous", ARCTIC_NEW, {}),
            ("int8", "continuous", ARCTIC_NEW, dict(kv_policy="int8")),
            ("ngram", "continuous", ARCTIC_NEW,
             dict(spec_mode="ngram", spec_k=4)),
            ("static native", "static", ARCTIC_STATIC_NEW, {}),
            ("static int8", "static", ARCTIC_STATIC_NEW,
             dict(kv_policy="int8"))):
        launches[label], runs[label] = engine_twice(
            torch, kern, ServeEngine, tm.RuntimeOptions, cfg, params,
            static_reqs if sched == "static" else reqs, label, sched, new,
            **kw)
    moe = moe_on_card(torch, tm, cfg, params)
    # the expert products are the block's only batched matmuls
    block = profile_decode_block(torch, tm, cfg, params, "arctic decode block",
                                 ops=("aten::bmm",), no_sync=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, moe=moe, decode_block=block,
                n_layers=cfg.n_layers, params=n_params), launches


# ------------------------ phases 8-10: the VLMs ------------------------ #

def _param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _init_on_card(torch, tm, cfg, dtype, seed=0):
    """The port's seeded init of ``cfg`` on the card, logged with its size
    and time."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = tm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(seed), dtype, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {dtype}: {n / 1e9:.3f} B "
        f"parameters, {_param_bytes(params) / 1e9:.2f} GB, init "
        f"{time.perf_counter() - t0:.1f}s")
    return params


def static_vlm_run(torch, kern, cm, eng, label, run, new, want, n_masked):
    """One static-engine run ``run()`` -> outputs, made twice: the runs must
    emit the same in-vocabulary tokens, launch exactly ``want(stats)``
    kernels (counts set to 0 just before each), call the masked attention
    exactly ``n_masked(stats)`` times and no plain version. Returns the
    first run's row (its launches, masked calls and peak memory)."""
    from repro_torch.kernels import flash_attention as flash
    cfg = eng.cfg
    outs, rows = [], []
    for _ in range(2):
        eng.stats = type(eng.stats)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        cm.attention.calls = 0
        with count_plain(kern, flash) as plain:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = read_counts()
        masked = cm.attention.calls
        s = eng.stats
        check(n == want(s), f"{label}: launches {n} != {want(s)}")
        check(masked == n_masked(s), f"{label}: masked-attention calls "
              f"{masked} != {n_masked(s)}")
        check(not plain, f"{label}: plain versions called on the card: "
              f"{plain}")
        check(all(len(o) == new and all(0 <= t < cfg.vocab for t in o)
                  for o in out), f"{label}: malformed outputs")
        outs.append(out)
        rows.append(dict(
            tokens_per_s=s.tps, prefill_s=s.prefill_s, decode_s=s.decode_s,
            host_syncs=s.host_syncs, decode_steps=s.decode_steps,
            decode_compiles=s.decode_compiles, new_tokens=s.new_tokens,
            step_ms=1e3 * s.decode_s / max(s.decode_steps, 1),
            peak_bytes=torch.cuda.max_memory_allocated(), wall_s=wall,
            launches=n, masked_calls=masked))
        log(f"{label:22s} tokens/s={s.tps:.1f} prefill_s={s.prefill_s:.3f} "
            f"decode_s={s.decode_s:.3f} micro-step={rows[-1]['step_ms']:.2f}"
            f"ms host_syncs={s.host_syncs} decode_steps={s.decode_steps} "
            f"peak={rows[-1]['peak_bytes'] / 1e9:.2f}GB launches flash="
            f"{n['flash_attention']} decode={n['decode_attention']} "
            f"masked={masked} wall={wall:.1f}s")
    check(outs[0] == outs[1], f"{label}: a repeated run emitted other "
          f"tokens")
    return dict(rows[0], repeat=rows[1], tokens=outs[0])


def serve_llava(torch, kern, tm, cm, ServeEngine, get_config):
    """llava15-13b at full width and all 40 layers, fp16, the port's seeded
    init, through the static engine's ``generate`` with seeded-normal patch
    rows (the stub frontend) before the prompts: (a) a wave of 4, (b) the
    long context, each native and int8, each twice. Every layer's prompt
    attention launches flash and every decode layer the dense decode;
    no masked attention. Prints each run's decode micro-step against its
    byte bound: the weights a step reads (all but the embedding table, of
    which it reads B rows) plus the KV of the valid positions, over
    3.35 TB/s."""
    import numpy as np
    cfg = get_config("llava15-13b")
    params = _init_on_card(torch, tm, cfg, "float16")
    L = cfg.n_layers
    w_bytes = _param_bytes(params) - _param_bytes(params["embed"])
    kv_pos_bytes = 2 * L * cfg.n_kv_heads * cfg.head_dim   # a position, x1 B
    runs = {}
    for key, (B, S, new) in LLAVA_RUNS.items():
        P = LLAVA_PATCHES
        rng = np.random.default_rng(18)
        prompts = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
        patches = torch.randn((B, P, cfg.d_model),
                              generator=torch.Generator(device="cuda")
                              .manual_seed(18), device="cuda").half()
        for policy in ("native", "int8"):
            eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="float16"),
                              device="cuda", scheduler="static",
                              kv_policy=policy, decode_lookahead=8,
                              max_len=P + S + new)
            label = f"llava ({key}) {policy}"
            row = static_vlm_run(
                torch, kern, cm, eng, label,
                lambda eng=eng, prompts=prompts, patches=patches, new=new:
                    eng.generate(prompts, new, prefix_emb=patches),
                new,
                lambda s: dict(paged_decode_attention=0,
                               chunk_prefill_attention=0,
                               spec_verify_attention=0,
                               decode_attention=L * s.decode_steps,
                               flash_attention=L),
                lambda s: 0)
            # the decode steps write at P + S .. P + S + steps - 1 and read
            # every position up to it: their mean valid length
            elem = 1 if policy == "int8" else 2
            mean_valid = P + S + (row["decode_steps"] + 1) / 2
            bound_ms = ((w_bytes + B * cfg.d_model * 2
                         + B * mean_valid * kv_pos_bytes * elem)
                        / HBM_BYTES_PER_S * 1e3)
            row.update(B=B, positions=P + S, bound_ms=bound_ms,
                       weight_bytes=w_bytes,
                       kv_bytes=B * mean_valid * kv_pos_bytes * elem)
            log(f"{label}: {P} patches + {S} prompt tokens x B={B}; decode "
                f"micro-step {row['step_ms']:.2f}ms (host clock, mean of "
                f"{row['decode_steps']}) against its byte bound "
                f"{bound_ms:.2f}ms ({w_bytes / 1e9:.2f} GB weights + "
                f"{row['kv_bytes'] / 1e9:.2f} GB KV); peak "
                f"{row['peak_bytes'] / 1e9:.2f} GB allocated")
            runs[f"{key} {policy}"] = row
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    # where (b)'s decode step goes: one K=8 block over the long cache
    blocks = {policy: profile_static_block(
        torch, tm, cfg, params, cache_dtype, B=1,
        S=LLAVA_PATCHES + LLAVA_RUNS["b"][1], dtype="float16")
        for policy, cache_dtype in (("native", ""), ("int8", "int8"))}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, n_layers=L, decode_block=blocks)


def serve_paligemma(torch, kern, tm, cm, ServeEngine, get_config):
    """paligemma-3b at full width (18 layers, bf16): ``generate`` on 4
    prompts after 256 seeded-normal patch rows, native and int8, each
    twice. The prompt attention is prefix-LM (the masked attention, once a
    layer); every decode layer launches the dense decode at head width
    256; flash never."""
    import numpy as np
    cfg = get_config("paligemma-3b")
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    L = cfg.n_layers
    B, P, S, new = PALIGEMMA_RUN
    prompts = np.random.default_rng(19).integers(
        1, cfg.vocab, size=(B, S)).astype(np.int32)
    patches = torch.randn((B, P, cfg.d_model),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(19), device="cuda").bfloat16()
    runs = {}
    for policy in ("native", "int8"):
        eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="bfloat16"),
                          device="cuda", scheduler="static", kv_policy=policy,
                          decode_lookahead=8, max_len=P + S + new)
        runs[policy] = static_vlm_run(
            torch, kern, cm, eng, f"paligemma {policy}",
            lambda eng=eng: eng.generate(prompts, new, prefix_emb=patches),
            new,
            lambda s: dict(paged_decode_attention=0,
                           chunk_prefill_attention=0,
                           spec_verify_attention=0,
                           decode_attention=L * s.decode_steps,
                           flash_attention=0),
            lambda s: L)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, n_layers=L)


def serve_gemma3(torch, kern, tm, cm, ServeEngine, get_config):
    """gemma3-1b at full width (26 layers, bf16): serve_bucketed on 4
    prompts of 1,024 and 4 of 2,048 tokens (its 512-token window cuts in),
    native and int8, each twice. Every layer is soft-capped, so every
    prompt and decode attention is the masked attention (26 calls a wave
    and a micro-step), as the reference attends gemma3 through XLA; no
    kernel launches."""
    import numpy as np
    cfg = get_config("gemma3-1b")
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    L = cfg.n_layers
    rng = np.random.default_rng(20)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in GEMMA_PROMPTS for _ in range(4)]
    waves = len(GEMMA_PROMPTS)
    runs = {}
    for policy in ("native", "int8"):
        eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="bfloat16"),
                          device="cuda", scheduler="static", kv_policy=policy,
                          decode_lookahead=8,
                          max_len=max(GEMMA_PROMPTS) + GEMMA_NEW)
        runs[policy] = static_vlm_run(
            torch, kern, cm, eng, f"gemma3 {policy}",
            lambda eng=eng: eng.serve([r[:] for r in reqs], GEMMA_NEW),
            GEMMA_NEW, lambda s: {k: 0 for k in KERNELS},
            lambda s: L * (waves + s.decode_steps))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, n_layers=L)


def f32_masked_checks(torch, tm, ServeEngine, get_config):
    """The three VLM-phase families in f32 at full width, cut in depth
    (llava and paligemma to 4 layers, gemma3 to 6, which keeps its first
    global layer): ``f32_card_vs_cpu``. The gemma3 prompt (1,500 tokens)
    takes the masked attention's blocked branch and its decode runs past
    the window."""
    return {arch: f32_card_vs_cpu(
        torch, tm, ServeEngine,
        dataclasses.replace(get_config(arch), n_layers=n_layers), B, P, S)
        for arch, n_layers, B, P, S in (("llava15-13b", 4, 2, 64, 64),
                                        ("paligemma-3b", 4, 2, 256, 32),
                                        ("gemma3-1b", 6, 1, 0, 1500))}


def f32_card_vs_cpu(torch, tm, ServeEngine, cfg, B, P, S):
    """``cfg`` in f32 (the port's seeded init on the card): prefill of B x
    S tokens (after P seeded-normal prefix rows: VLM patches or Whisper
    frames) and 4 decode steps, logits on the card against the CPU; then
    static K=8 == K=1 on the card (16 new tokens)."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = tm.init_params(cfg, gen, "float32", "cuda")
    opts = tm.RuntimeOptions(dtype="float32")
    rng = np.random.default_rng(4)
    n_dec = 4
    toks = rng.integers(1, cfg.vocab, size=(B, S + n_dec)).astype(np.int32)
    pfx = (rng.standard_normal((B, P, cfg.d_model), dtype=np.float32)
           if P else None)
    logits = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to(params, "cpu")
        cache = tm.init_cache(cfg, B, P + S + n_dec, opts, dev)
        lg, cache = tm.prefill(
            cfg, p, torch.as_tensor(toks[:, :S], device=dev), cache, opts,
            None if pfx is None else torch.as_tensor(pfx, device=dev))
        rows = [lg.float().cpu()]
        for j in range(n_dec):
            lg, cache = tm.decode_step(
                cfg, p, torch.as_tensor(toks[:, S + j], device=dev),
                P + S + j, cache, opts)
            rows.append(lg.float().cpu())
        logits[dev] = torch.stack(rows)
        del p, cache
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    check(err <= 2e-3 * max(scale, 1.0),
          f"f32 {cfg.name} ({cfg.n_layers} layers): card and CPU logits "
          f"disagree by {err:.3g}")
    outs = {}
    for k in (1, 8):
        eng = ServeEngine(cfg, params, opts, device="cuda",
                          scheduler="static", decode_lookahead=k,
                          max_len=P + S + 16)
        outs[k] = eng.generate(toks[:, :S], 16, prefix_emb=(
            None if pfx is None else torch.as_tensor(pfx, device="cuda")))
    check(outs[1] == outs[8], f"f32 {cfg.name}: static K=8 diverged from "
          f"K=1")
    log(f"f32 {cfg.name} ({cfg.n_layers} layers, full width): card vs CPU "
        f"max |logit diff| = {err:.2e} (max |logit| {scale:.2f}); static "
        f"K=8 == K=1 on {B} x 16 tokens")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(logit_err=err, logit_max=scale, n_layers=cfg.n_layers)


# ------------- phases 12-16: MLA, Mamba-2, Zamba2 and Whisper ------------- #

def sync_free_block(torch, tm, cfg, params, opts, label, B=2, S=64,
                    frames=None):
    """Prefill a B x S wave at full width (after ``frames`` for an
    encoder-decoder), then run one K=8 fused decode block under sync debug
    mode "error": a host sync inside it raises."""
    P = 0 if frames is None else frames.shape[1]
    cache = tm.init_cache(cfg, B, P + S + 9, opts, "cuda")
    toks = torch.randint(1, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5), dtype=torch.int32)
    logits, cache = tm.prefill(cfg, params, toks, cache, opts,
                               None if frames is None else frames[:B])
    tok = logits.argmax(dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blk, _ = tm.decode_steps(cfg, params, tok, P + S, cache, 8, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(((blk >= 0) & (blk < cfg.vocab)).all()),
          f"{label}: the sync-free block emitted tokens outside the vocab")
    log(f"{label}: no host sync in a K=8 decode block (B={B}, S={S})")
    del cache


def _bounded(label, row, w_bytes, cache_bytes):
    """Attach and print a decode step's byte bound: the weights a step
    reads plus the cache bytes it must move, over 3.35 TB/s."""
    bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=bound_ms, weight_bytes=w_bytes,
               cache_bytes=cache_bytes)
    log(f"{label}: decode micro-step {row['step_ms']:.2f}ms (host clock, "
        f"mean of {row['decode_steps']}) against its byte bound "
        f"{bound_ms:.3f}ms ({w_bytes / 1e9:.2f} GB weights + "
        f"{cache_bytes / 1e9:.3f} GB cache); tokens/s="
        f"{row['tokens_per_s']:.1f}; peak {row['peak_bytes'] / 1e9:.2f} GB "
        f"allocated")
    return row


def serve_deepseek(torch, kern, tm, cm, ServeEngine, get_config):
    """deepseek-v2-236b at full width (d_model 5120, 128 heads, MLA ranks
    512/1536, rope 64, 160 routed experts top-6 and 2 shared, vocab
    102,400, untied head) cut to the dense first layer and 2 MoE layers,
    bf16, the port's seeded init, through the static engine's
    ``generate``: (a) native and int8 (the latent cache stays native, so
    the tokens must equal native's), (b) native; each twice. The prompt
    attends through the masked attention once a layer, decode in the
    latent space; no kernel launches. Prints the latent cache's bytes at
    32,192 positions beside llava15-13b's KV there. A decode step reads
    every expert (the capacity dispatch pads each to C >= 1)."""
    import numpy as np
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DEEPSEEK_LAYERS)
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    L = cfg.n_layers
    opts = tm.RuntimeOptions(dtype="bfloat16")
    w_bytes = _param_bytes(params) - _param_bytes(params["embed"])
    lat_pos = L * cfg.mla.cache_width * 2           # latent bytes a position
    runs = {}
    for key, (B, S, new) in DEEPSEEK_RUNS.items():
        prompts = np.random.default_rng(21).integers(
            1, cfg.vocab, size=(B, S)).astype(np.int32)
        for policy in ("native", "int8") if key == "a" else ("native",):
            eng = ServeEngine(cfg, params, opts, device="cuda",
                              scheduler="static", kv_policy=policy,
                              decode_lookahead=8, max_len=S + new)
            label = f"deepseek ({key}) {policy}"
            row = static_vlm_run(
                torch, kern, cm, eng, label,
                lambda eng=eng, prompts=prompts, new=new:
                    eng.generate(prompts, new),
                new, lambda s: {k: 0 for k in KERNELS}, lambda s: L)
            mean_valid = S + (row["decode_steps"] + 1) / 2
            runs[f"{key} {policy}"] = _bounded(
                label, dict(row, B=B, positions=S), w_bytes,
                B * cfg.d_model * 2 + B * mean_valid * lat_pos)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    check(runs["a int8"]["tokens"] == runs["a native"]["tokens"],
          "deepseek: the int8 policy changed the tokens (MLA's latent cache "
          "stays native)")
    n_pos = sum(DEEPSEEK_RUNS["b"][1:])
    lat = _param_bytes(tm.init_cache(cfg, 1, n_pos, opts, "cuda"))
    per_layer = lat / (n_pos * L)
    full_depth = get_config("deepseek-v2-236b").n_layers
    log(f"deepseek latent cache at {n_pos} positions: {lat / 1e6:.1f} MB "
        f"for {L} layers ({per_layer:.0f} B a position a layer; at all "
        f"{full_depth} layers {per_layer * full_depth * n_pos / 1e9:.2f} GB) "
        f"against llava15-13b's KV {LLAVA_KV_POS_BYTES * n_pos / 1e9:.2f} GB "
        f"there")
    sync_free_block(torch, tm, cfg, params, opts, "deepseek")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, n_layers=L, latent_bytes=lat, positions=n_pos,
                latent_bytes_pos_layer=per_layer,
                llava_kv_bytes=LLAVA_KV_POS_BYTES * n_pos)


def serve_mamba(torch, kern, tm, cm, ServeEngine, get_config):
    """mamba2-130m at full width and all 24 layers, bf16, through
    ``generate``: (a) 4 x 512, (b) 1 x 32,768, 32 new, each twice; no
    attention at all. The state a sequence is the same at both lengths."""
    import numpy as np
    cfg = get_config("mamba2-130m")
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    opts = tm.RuntimeOptions(dtype="bfloat16")
    w_bytes = _param_bytes(params)           # the tied table is the logits' too
    runs = {}
    for key, (B, S, new) in MAMBA_RUNS.items():
        prompts = np.random.default_rng(22).integers(
            1, cfg.vocab, size=(B, S)).astype(np.int32)
        eng = ServeEngine(cfg, params, opts, device="cuda",
                          scheduler="static", decode_lookahead=8,
                          max_len=S + new)
        label = f"mamba ({key})"
        row = static_vlm_run(torch, kern, cm, eng, label,
                             lambda eng=eng, prompts=prompts, new=new:
                                 eng.generate(prompts, new),
                             new, lambda s: {k: 0 for k in KERNELS},
                             lambda s: 0)
        state = _param_bytes(tm.init_cache(cfg, B, S + new, opts, "cuda")) // B
        log(f"{label}: cache {state} B a sequence at {S + new} positions")
        # a step reads and writes each sequence's state once
        runs[key] = _bounded(label, dict(row, B=B, positions=S,
                                         state_bytes_per_seq=state),
                             w_bytes, 2 * B * state)
        del eng
    check(runs["a"]["state_bytes_per_seq"] == runs["b"]["state_bytes_per_seq"],
          "mamba: the state a sequence grew with the length")
    sync_free_block(torch, tm, cfg, params, opts, "mamba")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, n_layers=cfg.n_layers)


def serve_zamba(torch, kern, tm, cm, ServeEngine, get_config):
    """zamba2-2.7b at full width, all 54 Mamba-2 blocks and 9 shared
    attention sites, bf16: ``serve_bucketed`` on 4 prompts of 512 and 4 of
    1,024 tokens, 32 new, native, twice. The masked attention runs once a
    site: 9 times a wave and 9 times a micro-step."""
    import numpy as np
    from repro_torch.models import zamba
    cfg = get_config("zamba2-2.7b")
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    opts = tm.RuntimeOptions(dtype="bfloat16")
    n_sites = zamba._layout(cfg)[0]
    rng = np.random.default_rng(23)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in ZAMBA_PROMPTS for _ in range(4)]
    waves = len(ZAMBA_PROMPTS)
    eng = ServeEngine(cfg, params, opts, device="cuda", scheduler="static",
                      decode_lookahead=8,
                      max_len=max(ZAMBA_PROMPTS) + ZAMBA_NEW)
    row = static_vlm_run(torch, kern, cm, eng, "zamba native",
                         lambda: eng.serve([r[:] for r in reqs], ZAMBA_NEW),
                         ZAMBA_NEW, lambda s: {k: 0 for k in KERNELS},
                         lambda s: n_sites * (waves + s.decode_steps))
    # the mean over both waves of the KV a step reads (4 sequences, 9
    # sites) and the Mamba states it reads and writes
    steps = row["decode_steps"] / waves
    kv_pos = n_sites * 2 * cfg.n_heads * cfg.head_dim * 2
    states = _param_bytes(tm.init_cache(cfg, 4, 1, opts, "cuda")["mamba"])
    kv = statistics.mean(4 * (S + (steps + 1) / 2) * kv_pos
                         for S in ZAMBA_PROMPTS)
    row = _bounded("zamba native", dict(row, sites=n_sites), _param_bytes(params),
                   kv + 2 * states)
    sync_free_block(torch, tm, cfg, params, opts, "zamba")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run=row, n_layers=cfg.n_layers, sites=n_sites)


def serve_whisper(torch, kern, tm, cm, ServeEngine, get_config):
    """whisper-medium at full width, 24 encoder and 24 decoder layers,
    bf16: ``generate`` with 1,500 seeded-normal frame rows (the stub
    frontend) before 4 x 32 prompt tokens, 64 new, twice. The masked
    attention runs 72 times a wave (24 full in the encoder, 24 causal, 24
    cross) and 48 times a micro-step. Decode positions start after the
    frames, as in the reference (ROADMAP.md C4): a step reads 1,500 zero
    rows of its self cache too."""
    import numpy as np
    cfg = get_config("whisper-medium")
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    opts = tm.RuntimeOptions(dtype="bfloat16")
    L, P = cfg.n_layers, cfg.source_len
    B, S, new = WHISPER_RUN
    prompts = np.random.default_rng(24).integers(
        1, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = torch.randn((B, P, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(24)).bfloat16()
    eng = ServeEngine(cfg, params, opts, device="cuda", scheduler="static",
                      decode_lookahead=8, max_len=P + S + new)
    row = static_vlm_run(torch, kern, cm, eng, "whisper native",
                         lambda: eng.generate(prompts, new,
                                              prefix_emb=frames),
                         new, lambda s: {k: 0 for k in KERNELS},
                         lambda s: (cfg.enc_layers + 2 * L)
                         + 2 * L * s.decode_steps)
    # a step reads the decoder's weights and the tied table, its self KV
    # up to its position and the cross KV of the frames
    w_bytes = (_param_bytes(params["dec_stack"]) + _param_bytes(params["embed"])
               + _param_bytes(params["ln_dec"]))
    kv_pos = L * 2 * cfg.n_heads * cfg.head_dim * 2
    mean_valid = S + P + (row["decode_steps"] + 1) / 2
    row = _bounded("whisper native", dict(row, B=B, frames=P), w_bytes,
                   B * (mean_valid + P) * kv_pos)
    sync_free_block(torch, tm, cfg, params, opts, "whisper", frames=frames)
    del eng, params, frames
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run=row, n_layers=L, enc_layers=cfg.enc_layers)


def f32_family_checks(torch, tm, ServeEngine, get_config):
    """The four families in f32 at full width, cut in depth: deepseek to
    its dense layer and 1 MoE layer with 16 of its 160 experts, mamba to 4
    layers, zamba to 12 blocks (2 sites), whisper to 4 + 4 layers (its
    1,500 frames kept): prefill and decode logits on the card against the
    CPU, and static K=8 == K=1 on the card."""
    ds = get_config("deepseek-v2-236b")
    cases = (
        (dataclasses.replace(ds, n_layers=2, moe=dataclasses.replace(
            ds.moe, n_experts=16)), 2, 0, 64),
        (dataclasses.replace(get_config("mamba2-130m"), n_layers=4), 2, 0,
         300),
        (dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12), 2, 0,
         300),
        (dataclasses.replace(get_config("whisper-medium"), n_layers=4,
                             enc_layers=4), 2, 1500, 16))
    return {cfg.name: f32_card_vs_cpu(torch, tm, ServeEngine, cfg, B, P, S)
            for cfg, B, P, S in cases}


# --------------------- phase 17: head-sharded serving -------------------- #

def cut_llama(get_config):
    """llama3.2-1b at full width cut to ``CUT_LAYERS`` layers: the model of
    phase 17 and phase 20 (a)."""
    return dataclasses.replace(get_config("llama3.2-1b"), n_layers=CUT_LAYERS)


def _shard_engine(ServeEngine, RuntimeOptions, cfg, params, run, shards):
    """Phase 17's continuous engine: full-width bf16 llama3.2-1b as phase 4
    serves it, with native or int8 KV or n-gram speculation (k=4)."""
    kw = (dict(spec_mode="ngram", spec_k=4) if run == "ngram"
          else dict(kv_policy=run))
    return ServeEngine(cfg, params, RuntimeOptions(dtype="bfloat16"),
                       device="cuda", seed=0, scheduler="continuous",
                       page_size=PS, max_batch=8, prefill_chunk=C,
                       decode_lookahead=8, max_len=MAX_LEN, shards=shards,
                       **kw)


def _pool_bytes(tm, eng) -> int:
    """Bytes of the paged pool (pages and scales) this engine's device
    holds, as ``serve_continuous`` allocates it."""
    cache = tm.init_paged_cache(eng.cfg, eng.n_pages, PS, eng.opts,
                                eng.device)
    return sum(t.numel() * t.element_size() for t in cache["stack"].values())


@contextlib.contextmanager
def kv_heads_seen(kern):
    """The KV-head counts of the pools the CUDA kernels' launches were
    given while the block runs (each launch validates its operands with
    ``_check`` first; the entries count their own launches by name, so
    they are not wrapped)."""
    seen, check_fn = set(), kern._check

    def wrapped(q, k_pages, *a, **kw):
        seen.add(k_pages.shape[2])
        return check_fn(q, k_pages, *a, **kw)
    kern._check = wrapped
    try:
        yield seen
    finally:
        kern._check = check_fn


def _shard_attention_check(torch, kern, group, H, DH, Hkv):
    """One decode step (B=8, 36 pages a sequence, ragged lengths), one
    prefill chunk (B=1, C=64 at 384) and one C=5 verify window over a
    full-width pool, bf16 and int8, on every rank: the rank's head slice
    through ``sharded_attend`` must give bitwise the unsharded call's
    output. Every rank draws the same inputs; the launches here are not
    the serving run's."""
    from repro_torch.kernels import sharded as ksh
    B, n_pp = 8, -(-MAX_LEN // PS)
    P = B * n_pp + 1
    hl = ksh.head_slice(group, Hkv)
    g = torch.Generator(device="cuda").manual_seed(17)
    dev = dict(device="cuda")
    checked = []
    for pool in ("bfloat16", "int8"):
        kp, vp, sc = _pools(torch, g, (P, PS, Hkv, DH), pool, torch.bfloat16)
        pt = (torch.randperm(P - 1, generator=g, **dev)[:B * n_pp]
              .reshape(B, n_pp) + 1).to(torch.int32)
        lens = torch.randint(1, MAX_LEN + 1, (B,), generator=g,
                             **dev).to(torch.int32)
        sl = torch.randint(0, MAX_LEN - 4, (B,), generator=g,
                           **dev).to(torch.int32)
        nf = torch.randint(1, 6, (B,), generator=g, **dev).to(torch.int32)
        nv = torch.tensor([384 + C], dtype=torch.int32, **dev)
        local = (kp[:, :, hl].contiguous(), vp[:, :, hl].contiguous(),
                 *(sc[k][hl].contiguous() if sc else None
                   for k in ("k_scale", "v_scale")))

        def q(*shape):
            return torch.randn(shape, generator=g, **dev).to(torch.bfloat16)
        for name, qq, axis, extras in (
                ("paged_decode_attention", q(B, H, DH), 1, (pt, lens)),
                ("chunk_prefill_attention", q(1, C, H, DH), 2,
                 (pt[:1], 384, nv)),
                ("spec_verify_attention", q(B, 5, H, DH), 2, (pt, sl, nf))):
            fn = getattr(kern, name)
            whole = fn(qq, kp, vp, *extras, **sc)

            def attend(q_, kp_, vp_, ks_, vs_, *ex, _fn=fn):
                return _fn(q_, kp_, vp_, *ex, k_scale=ks_, v_scale=vs_,
                           split_kv_heads=Hkv)
            got = ksh.sharded_attend(group, attend, qq, *local, extras,
                                     q_head_axis=axis)
            torch.cuda.synchronize()
            check(torch.equal(got, whole),
                  f"rank {group.rank}/{group.size}: {name} ({pool}) gathered "
                  f"over head shards differs from the whole pool's call")
            checked.append(f"{name}/{pool}")
    return checked


def shard_rank(rank, shards, reqs, runs):
    """One rank of phase 17 (spawned): serves ``runs`` at ``shards`` on its
    head slice with the counts set to 0 just before each run, and checks
    what this rank can see alone: exact launches of the paged kernels at
    Hkv/N heads and no plain version, a reconciled trace and freed pages,
    and the gathered attention bitwise equal to the whole pool's. Then
    phase 26's shard_sweep cells of this shard count (``sweep_rank``), in
    ``out["sweep"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kern
    import repro_torch.models as tm
    from repro_torch.serving import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cut_llama(get_config)
    L, n_kv = cfg.n_layers, cfg.n_kv_heads // shards
    out, params = {}, None
    for run in runs:
        eng = _shard_engine(ServeEngine, tm.RuntimeOptions, cfg, params, run,
                            shards)
        params = eng.params
        check(torch.cuda.current_device() == eng.device.index,
              f"rank {rank}: the engine's device {eng.device} is not the "
              f"current one (cuda:{torch.cuda.current_device()})")
        zero_counts()
        with count_plain(kern) as plain, kv_heads_seen(kern) as heads:
            t0 = time.perf_counter()
            toks = eng.serve([r[:] for r in reqs], SHARD_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = read_counts()
        s = eng.stats
        label = f"rank {rank}/{shards} {run}"
        want = dict(paged_decode_attention=L * (s.decode_steps
                                                - s.spec_blocks),
                    chunk_prefill_attention=L * n_prefill_chunks(eng),
                    spec_verify_attention=L * s.spec_blocks,
                    decode_attention=0, flash_attention=0)
        check(n == want, f"{label}: launches {n} != {want}")
        check(heads == {n_kv}, f"{label}: pools of {heads} KV heads, not "
              f"{n_kv}")
        check(not plain, f"{label}: plain versions called: {plain}")
        check(eng.trace_report["ok"], f"{label}: trace did not reconcile")
        check(eng.kv_manager.n_used == 0, f"{label}: pages leaked")
        out[run] = dict(
            tokens=toks, launches=n, pool_bytes=_pool_bytes(tm, eng),
            device=str(eng.device), backend=dist.get_backend(),
            tokens_per_s=s.tps, itl_p50_ms=s.itl_p50 * 1e3,
            ttft_p50_ms=s.ttft_p50 * 1e3, decode_s=s.decode_s,
            decode_steps=s.decode_steps, prefill_s=s.prefill_s,
            host_syncs=s.host_syncs, spec_blocks=s.spec_blocks,
            acceptance=s.acceptance_rate, wall_s=wall)
    out["attention"] = _shard_attention_check(
        torch, kern, eng.shard, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads)
    from repro_torch.paper import shard_sweep
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["sweep"] = sweep_rank(rank, shard_sweep.parser().parse_args([]),
                              shards, shard_sweep.GROUP_CELLS[shards], None,
                              False)
    out["sweep_s"] = time.perf_counter() - t0
    return out


def serve_sharded(torch, kern, tm, ServeEngine, get_config):
    """Phase 17: head-sharded continuous serving of llama3.2-1b at full
    width (32 KV heads), ranks spawned here and sharing the one card over
    gloo, against shards=1 on the same card and requests: every rank's
    tokens equal shards=1's, each rank's pool bytes are 1/N of them, and
    (checked in the ranks) launches are exact at Hkv/N with no plain
    version and the gathered attention is bitwise the whole pool's. Then
    the three paged entries are checked and timed here at a shard's
    shapes. Each rank also serves phase 26's shard_sweep cells of its
    shard count, returned as ``measurements["sweep_groups"]``
    (``shard_sweep.run_groups``' form). Returns (measurements, kernel
    rows, launches by shards)."""
    from repro_torch.launch.ranks import backend_for, run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cut_llama(get_config)
    reqs = requests(cfg.vocab, SHARD_REQS)
    want, params = {}, None
    for run in SHARD_RUNS[2]:
        eng = _shard_engine(ServeEngine, tm.RuntimeOptions, cfg, params, run,
                            1)
        params = eng.params
        t0 = time.perf_counter()
        toks = eng.serve([r[:] for r in reqs], SHARD_NEW)
        torch.cuda.synchronize()
        s = eng.stats
        want[run] = dict(tokens=toks, pool_bytes=_pool_bytes(tm, eng),
                         tokens_per_s=s.tps, itl_p50_ms=s.itl_p50 * 1e3,
                         decode_s=s.decode_s, decode_steps=s.decode_steps,
                         wall_s=time.perf_counter() - t0)
        log(f"shards=1 {run:7s} tokens/s={s.tps:.1f} "
            f"decode step={s.decode_s / s.decode_steps * 1e3:.2f}ms "
            f"itl p50={s.itl_p50 * 1e3:.2f}ms pool={want[run]['pool_bytes']}B")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    result = {"shards=1": want, "sweep_groups": {}}
    for n, runs in SHARD_RUNS.items():
        backend = backend_for(n, "cuda")
        t0 = time.perf_counter()
        ranks = run_ranks(shard_rank, n, (n, reqs, runs), backend=backend,
                          timeout=SHARD_TIMEOUT_S)
        result["sweep_groups"][n] = [r.pop("sweep") for r in ranks]
        log(f"shards={n}: phase 26's shard_sweep cells on the same ranks, "
            f"{max(r.pop('sweep_s') for r in ranks):.1f}s")
        log(f"shards={n} backend={backend} ranks "
            + " ".join(f"{r}->{res[runs[0]]['device']}"
                       for r, res in enumerate(ranks))
            + f" ({time.perf_counter() - t0:.1f}s with spawn)")
        for run in runs:
            for r, res in enumerate(ranks):
                got = res[run]
                check(got["backend"] == backend, f"rank {r}: backend "
                      f"{got['backend']}, not {backend}")
                check(got["tokens"] == want[run]["tokens"],
                      f"shards={n} {run}: rank {r}'s tokens differ from "
                      f"shards=1's")
                check(got["pool_bytes"] * n == want[run]["pool_bytes"],
                      f"shards={n} {run}: rank {r} holds {got['pool_bytes']} "
                      f"pool bytes, not 1/{n} of {want[run]['pool_bytes']}")
            r0 = ranks[0][run]
            log(f"shards={n} {run:7s} tokens/s={r0['tokens_per_s']:.1f} "
                f"decode step={r0['decode_s'] / r0['decode_steps'] * 1e3:.2f}"
                f"ms itl p50={r0['itl_p50_ms']:.2f}ms "
                f"pool={r0['pool_bytes']}B/rank tokens == shards=1 on "
                f"{n} ranks; launches "
                + " ".join(f"{k.split('_')[0]}={v}"
                           for k, v in r0["launches"].items())
                + " a rank")
        log(f"shards={n}: gathered attention bitwise equal to the whole "
            f"pool's on every rank ({', '.join(ranks[0]['attention'])})")
        result[f"shards={n}"] = ranks
    # the three entries at a shard's shapes (llama3.2-1b's group 1, bf16
    # pool), split as the whole pool: the kernels line's sharded rows
    H, DH, Hkv = PAGED_WIDTHS[0]
    rows = []
    for n in SHARD_RUNS:
        rows += check_kernels(torch, kern, None, paged_cases(
            torch, kern, H // n, DH, Hkv // n, pools=("bfloat16",),
            verify_c=(5,), chunk_edges=False, split_kv_heads=Hkv))
    launches = {n: {**result[f"shards={n}"][0][runs[0]]["launches"],
                    **({"spec_verify_attention": result[f"shards={n}"][0][
                        "ngram"]["launches"]["spec_verify_attention"]}
                       if "ngram" in runs else {})}
                for n, runs in SHARD_RUNS.items()}
    return result, rows, launches


# -------------------------- phase 18: training -------------------------- #

def train_flops(cfg, n_params: int, B: int, S: int) -> dict:
    """Operations of one training step of ``cfg`` on B x S tokens as the
    port runs it (f32, remat "block", the tied head in 512-row chunks that
    are recomputed in the backward pass): the weight matrices' 6 N T
    (forward, the two products of the backward), remat's second forward 2
    N T, the head's 8 T d V (its forward, backward and recompute; N
    excludes the embedding table, whose lookup does no product), and the
    masked attention, which computes every query-key score of its single
    block: 4 B S^2 H dh a layer forward, times 4 (forward, backward,
    recompute)."""
    T = B * S
    n_mat = n_params - cfg.vocab * cfg.d_model
    parts = {"weights": 6 * n_mat * T, "remat": 2 * n_mat * T,
             "head": 8 * T * cfg.d_model * cfg.vocab,
             "attention": 16 * B * S * S * cfg.n_heads * cfg.head_dim
             * cfg.n_layers}
    return dict(parts, total=sum(parts.values()))


def _kernel_launches(kern) -> int:
    return sum(read_counts().values())


def _same_bits(torch, a, b) -> bool:
    """Bitwise equality of two tensors of one dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _train_run(torch, kern, tm, cm, cfg, tcfg, opts, ckpt_dir=None):
    """``tcfg.steps`` AdamW steps of ``cfg`` in f32 on the card through
    ``build_train_step``, the loss read once a step; with ``ckpt_dir`` the
    step-``tcfg.ckpt_every`` state is saved there, restored onto the CPU
    and held bitwise against the card's. Checks every loss and grad_norm
    finite, the loss falling, no kernel launch, the masked attention
    called n_layers x (forward + remat) x micro-batches x steps times and
    the params f32 beside a separate master. Returns the run's numbers."""
    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.data import for_arch
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    B, S, n_micro, steps = (tcfg.global_batch, tcfg.seq_len, tcfg.n_micro,
                            tcfg.steps)
    save_at = tcfg.ckpt_every
    params = _init_on_card(torch, tm, cfg, "float32", seed=tcfg.seed)
    n_params = sum(t.numel() for t in _leaves(params))
    state = adamw_init(params)
    step_fn = build_train_step(cfg, opts, tcfg)
    ds = for_arch(cfg, S, B, tcfg.seed)
    zero_counts()
    calls0 = cm.attention.calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, gnorms, io, peak = [], [], [], {}, 0
    for step in range(steps):
        t0 = time.perf_counter()
        batch = {k: v.to("cuda") for k, v in ds.batch_at(step).items()}
        loss, params, state, om = step_fn(params, state, batch)
        losses.append(float(loss))              # the step's one host read
        step_s.append(time.perf_counter() - t0)
        gnorms.append(om["grad_norm"])
        if ckpt_dir is not None and step + 1 == save_at:
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            save_checkpoint(ckpt_dir, save_at, (params, state), keep=1)
            io["save_s"] = time.perf_counter() - t0
            check(latest_step(ckpt_dir) == save_at,
                  f"no complete step-{save_at} checkpoint")
            t0 = time.perf_counter()
            (cp, cs), got = restore_checkpoint(ckpt_dir, (params, state),
                                               device="cpu")
            io["restore_cpu_s"] = time.perf_counter() - t0
            host = _leaves((cp, cs))
            card = _leaves((params, state))
            check(len(host) == len(card) and all(
                h.device.type == "cpu" and _same_bits(torch, h, c.cpu())
                for h, c in zip(host, card)),
                f"the step-{save_at} checkpoint restored onto the CPU is "
                f"not bitwise the card's state")
            io["leaves"] = len(host)
            io["bytes"] = sum(t.numel() * t.element_size() for t in host)
            del cp, cs, host
            gc.collect()
    torch.cuda.synchronize()
    peak = max(peak, torch.cuda.max_memory_allocated())
    launches = _kernel_launches(kern)
    calls = cm.attention.calls - calls0
    gn = [float(g) for g in gnorms]
    check(all(math.isfinite(x) for x in losses + gn),
          f"non-finite loss or grad_norm: {losses} {gn}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(launches == 0, f"training launched kernels: {read_counts()}")
    # each micro-batch's forward calls the masked attention once a layer,
    # and remat recomputes each block's forward once in the backward pass
    want_calls = cfg.n_layers * 2 * n_micro * steps
    check(calls == want_calls, f"masked attention called {calls} times, "
          f"want {want_calls} (n_layers x (forward + remat) x micro-batches "
          f"x steps)")
    for p, m in zip(_leaves(params), _leaves(state["master"])):
        check(p.dtype == torch.float32 and m.dtype == torch.float32
              and p.data_ptr() != m.data_ptr(),
              "params left f32, or the master aliases them")
    del params, state, step_fn, gnorms, om, loss, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, losses=losses, grad_norm=gn,
                step_s=step_s, peak_bytes=peak, attention_calls=calls, io=io)


def train_full_width(torch, kern, tm, cm, get_config, ckpt_dir):
    """(a) llama3.2-1b at full width and depth in f32, remat "block", B x
    S = 4 x 1,024 in 2 micro-batches, 8 AdamW steps through
    ``build_train_step``: step time, tokens/s, peak memory, FLOP bound.
    (b) the same run at full width cut to ``CUT_LAYERS`` layers: the
    step-4 state saved, restored onto the CPU and held bitwise against the
    card's; then ``train()`` resumes from that checkpoint on the card and
    must repeat steps 4-7's losses."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train
    cfg = get_config("llama3.2-1b")
    B, S, n_micro, steps, save_at = TRAIN_RUN
    tcfg = TrainConfig(steps=steps, seq_len=S, global_batch=B,
                       n_micro=n_micro, ckpt_every=save_at, keep=1,
                       ckpt_dir=str(ckpt_dir), seed=0, log_every=1,
                       optimizer=AdamWConfig(lr=3e-4, warmup_steps=1,
                                             total_steps=steps))
    opts = tm.RuntimeOptions(dtype="float32", remat="block")
    full = _train_run(torch, kern, tm, cm, cfg, tcfg, opts)
    n_params, losses, step_s = (full["n_params"], full["losses"],
                                full["step_s"])
    med = statistics.median(step_s[2:steps])
    tokens = B * S
    flops = train_flops(cfg, n_params, B, S)
    bound_ms = flops["total"] / PEAK_OPS["float32"] * 1e3
    log(f"train llama3.2-1b f32 step_ms={med * 1e3:.1f} "
        f"tokens/s={tokens / med:.0f} peak_GB={full['peak_bytes'] / 1e9:.2f} "
        f"flop_bound_ms={bound_ms:.1f}")
    log(f"train llama3.2-1b: {n_params} parameters, losses "
        + " ".join(f"{x:.4f}" for x in losses) + ", grad_norm "
        + " ".join(f"{x:.3f}" for x in full["grad_norm"]) + ", step_ms "
        + " ".join(f"{x * 1e3:.1f}" for x in step_s))

    # (b) the checkpoint part at CUT_LAYERS layers: save, restore onto the
    # CPU, and the loop's own resume from the step-4 checkpoint, on the card
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    part = _train_run(torch, kern, tm, cm, cut, tcfg, opts, ckpt_dir)
    straight, io = part["losses"], part["io"]
    log(f"train llama3.2-1b at {CUT_LAYERS} layers: {part['n_params']} "
        f"parameters, losses " + " ".join(f"{x:.4f}" for x in straight)
        + f"; checkpoint {io['bytes'] / 1e9:.2f} GB in {io['leaves']} "
        f"leaves: save {io['save_s']:.1f}s, restore onto the CPU "
        f"{io['restore_cpu_s']:.1f}s (bitwise)")
    t0 = time.perf_counter()
    out = train(cut, tcfg, opts, log_fn=log, device="cuda")
    io["resume_s"] = time.perf_counter() - t0
    resumed = out["losses"]
    check(out["last_step"] == steps and len(resumed) == steps - save_at,
          f"the resumed run did not run steps {save_at}-{steps - 1}: {out}")
    bitwise = resumed == straight[save_at:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                  straight[save_at:]))
    check(rel <= 1e-5, f"resumed losses {resumed} differ from the straight "
          f"run's {straight[save_at:]} (rel {rel:.2e})")
    log(f"train resume from step {save_at} ({CUT_LAYERS} layers): losses "
        + " ".join(f"{x:.6f}" for x in resumed)
        + f" {'bitwise equal to' if bitwise else f'within rel {rel:.2e} of'}"
        f" the straight run's; train() took {io['resume_s']:.1f}s (init, "
        f"restore, {steps - save_at} steps, step-{steps} checkpoint)")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, losses=losses, grad_norm=full["grad_norm"],
                step_ms=[x * 1e3 for x in step_s], step_ms_median=med * 1e3,
                tokens_per_s=tokens / med, peak_bytes=full["peak_bytes"],
                flops=flops, flop_bound_ms=bound_ms,
                attention_calls=full["attention_calls"],
                checkpoint_layers=CUT_LAYERS,
                checkpoint_n_params=part["n_params"],
                checkpoint_losses=straight, resumed_losses=resumed,
                resume_bitwise=bitwise, resume_rel=rel, io=io)


def train_bf16(torch, tm, get_config):
    """bf16 llama3.2-1b at full width, 2 steps: the params stay bf16 and
    are their f32 master's round trip on the card."""
    from repro_torch.data import for_arch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, build_train_step
    cfg = get_config("llama3.2-1b")
    B, S, n_micro, _, _ = TRAIN_RUN
    tcfg = TrainConfig(steps=2, seq_len=S, global_batch=B, n_micro=n_micro,
                       optimizer=AdamWConfig(lr=3e-4, warmup_steps=1,
                                             total_steps=2))
    opts = tm.RuntimeOptions(dtype="bfloat16", remat="block")
    params = _init_on_card(torch, tm, cfg, "bfloat16", seed=1)
    state = adamw_init(params)
    step_fn = build_train_step(cfg, opts, tcfg)
    ds = for_arch(cfg, S, B, 1)
    losses = []
    for step in range(2):
        batch = {k: v.to("cuda") for k, v in ds.batch_at(step).items()}
        loss, params, state, om = step_fn(params, state, batch)
        losses.append(float(loss))
    check(all(math.isfinite(x) for x in losses), f"bf16 losses {losses}")
    for p, m in zip(_leaves(params), _leaves(state["master"])):
        check(p.dtype == torch.bfloat16 and m.dtype == torch.float32
              and torch.equal(p, m.to(torch.bfloat16)),
              "a bf16 param is not its master's round trip")
    log(f"train llama3.2-1b bf16: 2 steps, losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f", grad_norm {float(om['grad_norm']):.3f}; params bf16, each "
        f"the round trip of its f32 master")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses)


def _grads(torch, tm, cfg, params, batch, opts):
    from repro_torch.tree import leaves, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = tm.train_loss(cfg, p, batch, opts)
    return float(loss.detach()), torch.autograd.grad(loss, leaves(p))


def _grad_err(torch, got, want) -> float:
    """max over leaves of max |got - want| / (1e-4 max |want| + 1e-6): at
    most 1 passes."""
    return max(float((a.cpu() - b.cpu()).abs().max())
               / (1e-4 * float(b.abs().max()) + 1e-6)
               for a, b in zip(got, want))


def train_card_vs_cpu(torch, kern, tm, get_config):
    """(c) each family's reduced twin (head width 16: training reaches no
    kernel, so it is not refused) in f32: loss to rel 1e-5 and every
    gradient leaf within 1e-4 max|g_cpu| + 1e-6 of the CPU's; on llama,
    remat "block" == "none" and n_micro 2 == 1 (rel 2e-3 over 3 steps)."""
    from repro_torch.configs.reduce import reduced
    from repro_torch.data import for_arch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.tree import tree_map
    opts = tm.RuntimeOptions(dtype="float32")
    rows = {}
    zero_counts()
    for arch in TRAIN_FAMILIES:
        cfg = reduced(get_config(arch))
        params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                                "float32", "cpu")
        batch = for_arch(cfg, 32, 2, seed=0).batch_at(0)
        l_cpu, g_cpu = _grads(torch, tm, cfg, params, batch, opts)
        pc = _to(params, "cuda")
        bc = {k: v.to("cuda") for k, v in batch.items()}
        l_gpu, g_gpu = _grads(torch, tm, cfg, pc, bc, opts)
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        gerr = _grad_err(torch, g_gpu, g_cpu)
        check(rel <= 1e-5 and gerr <= 1.0,
              f"{arch} twin: card vs CPU loss rel {rel:.2e}, gradient "
              f"error {gerr:.3f} of its tolerance")
        row = dict(loss_rel=rel, grad_err_of_tol=gerr)
        if arch == "llama3.2-1b":
            l_r, g_r = _grads(torch, tm, cfg, pc, bc, tm.RuntimeOptions(
                dtype="float32", remat="block"))
            row["remat_grad_err_of_tol"] = _grad_err(torch, g_r, g_gpu)
            check(abs(l_r - l_gpu) <= 1e-5 * abs(l_gpu)
                  and row["remat_grad_err_of_tol"] <= 1.0,
                  "remat 'block' differs from 'none' on the card")
            micro = {}
            for n in (1, 2):
                tc = TrainConfig(steps=3, seq_len=32, global_batch=4,
                                 n_micro=n, optimizer=AdamWConfig(
                                     lr=1e-3, warmup_steps=0, total_steps=3))
                step = build_train_step(cfg, opts, tc)
                # a copy: the steps update it in place
                p = tree_map(lambda t: t.to("cuda", copy=True), params)
                st = adamw_init(p)
                ds = for_arch(cfg, 32, 4, seed=2)
                micro[n] = []
                for s in range(3):
                    b = {k: v.to("cuda") for k, v in ds.batch_at(s).items()}
                    loss, p, st, _ = step(p, st, b)
                    micro[n].append(float(loss))
            row["micro_rel"] = max(abs(a - b) / abs(b)
                                   for a, b in zip(micro[2], micro[1]))
            check(row["micro_rel"] <= 2e-3,
                  f"n_micro 2 vs 1 on the card: {micro}")
        rows[arch] = row
        del params, pc, g_cpu, g_gpu
    check(_kernel_launches(kern) == 0,
          f"the twins' training launched kernels: {read_counts()}")
    log("train card vs CPU (reduced twins, f32): "
        + ", ".join(f"{a} loss rel {r['loss_rel']:.1e} grad "
                    f"{r['grad_err_of_tol']:.3f} of tol"
                    for a, r in rows.items())
        + f"; llama remat block vs none {rows['llama3.2-1b']['remat_grad_err_of_tol']:.3f}"
        f" of tol, n_micro 2 vs 1 rel {rows['llama3.2-1b']['micro_rel']:.1e}")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def width_refusal(torch, kern, tm, get_config):
    """(d) the reduced llama3.2-1b twin on the card is refused with
    NotImplementedError before any weights are drawn, by ``ServeEngine``
    (both schedulers) and by the serve CLI's ``--reduced`` (default
    ``--device cuda``); gemma3-1b's twin, whose layers reach no kernel,
    still serves on the card."""
    import repro_torch.launch.serve as tserve
    import repro_torch.serving.engine as teng
    from repro_torch.configs.reduce import reduced
    drawn = []
    real = teng.init_params

    def spy(*a, **k):
        drawn.append(1)
        return real(*a, **k)
    teng.init_params = spy
    try:
        for sched in ("continuous", "static"):
            try:
                teng.ServeEngine(reduced(get_config("llama3.2-1b")),
                                 device="cuda", scheduler=sched)
            except NotImplementedError as e:
                msg = str(e)
            else:
                check(False, f"the reduced twin was served ({sched})")
        check(not drawn and "head_dim 16" in msg and "--device cpu" in msg,
              f"refusal after drawing weights or without its reason: {msg}")
        try:
            tserve.main(["--arch", "llama3.2-1b", "--reduced"])
        except NotImplementedError:
            pass
        else:
            check(False, "the serve CLI served the reduced twin on cuda")
        check(not drawn, "the CLI drew weights before refusing")
        zero_counts()
        eng = teng.ServeEngine(reduced(get_config("gemma3-1b")),
                               opts=tm.RuntimeOptions(dtype="float32"),
                               device="cuda", scheduler="static", max_len=48)
        import numpy as np
        out = eng.generate(np.tile(np.arange(1, 17, dtype=np.int32),
                                   (2, 1)), 16)
        check(drawn and len(out) == 2 and all(len(o) == 16 for o in out),
              f"gemma3-1b's twin did not serve on the card: {out}")
        check(_kernel_launches(kern) == 0, "gemma3-1b's twin launched")
    finally:
        teng.init_params = real
    log(f"width refusal: reduced llama3.2-1b on cuda refused before any "
        f"weights were drawn ({msg[:90]}...); the CLI's --reduced too; "
        f"reduced gemma3-1b served 2 x 16 tokens on the card, no launch")
    return dict(message=msg)


def train_phase(torch, kern, tm, cm, get_config) -> dict:
    """Phase 18 (a)-(d), the checkpoints in a temporary directory of the
    checkout's build/ (removed afterwards)."""
    import shutil
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=base))
    free = shutil.disk_usage(ckpt).free
    log(f"train: checkpoints under {ckpt.name}, {free / 1e9:.0f} GB free")
    try:
        out = dict(full_width=train_full_width(torch, kern, tm, cm,
                                               get_config, ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["bf16"] = train_bf16(torch, tm, get_config)
    out["card_vs_cpu"] = train_card_vs_cpu(torch, kern, tm, get_config)
    out["refusal"] = width_refusal(torch, kern, tm, get_config)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 (training) {out['phase_s']:.1f}s")
    return out


# -------------- phase 19: the analytic model against the card -------------- #

# (a)'s transfer sizes, 1 MB to 2 GB, and the matmul's side
CARD_SIZES = tuple(1 << s for s in range(20, 32, 2)) + (1 << 31,)
MATMUL_N = 8192


def _line_fit(xs, ys):
    """Least-squares (slope, intercept) of ``ys`` against ``xs``, each
    point weighted by 1 / y^2: every size counts by its relative error, so
    the microseconds of noise on a 2 GB copy do not set the intercept."""
    w = [1 / y ** 2 for y in ys]
    mx = sum(a * x for a, x in zip(w, xs)) / sum(w)
    my = sum(a * y for a, y in zip(w, ys)) / sum(w)
    slope = (sum(a * (x - mx) * (y - my) for a, x, y in zip(w, xs, ys))
             / sum(a * (x - mx) ** 2 for a, x in zip(w, xs)))
    return slope, my - slope * mx


def measure_card(torch, smi):
    """(a) The card's own rates: device-to-device copies (a copy reads and
    writes its bytes, so it moves twice its size) and host-to-device
    copies from pinned memory, 1 MB to 2 GB, each the median of 10 (the
    L2 flushed before each); the line fitted to (bytes moved, seconds) gives
    a rate (1 / slope) and an intercept. Then the dense bf16 rate of an
    8192^3 ``torch.matmul`` (a measurement of the card, not a kernel
    port)."""
    big = CARD_SIZES[-1]
    src = torch.empty(big, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    host = torch.empty(big, dtype=torch.uint8, pin_memory=True)
    out = {}
    for label, moved, frm in (("hbm copy", 2, src), ("host->device", 1,
                                                      host)):
        ms = {n: median_ms(torch, lambda n=n: dst[:n].copy_(
            frm[:n], non_blocking=True), iters=10) for n in CARD_SIZES}
        slope, icpt = _line_fit([moved * n for n in CARD_SIZES],
                                [ms[n] * 1e-3 for n in CARD_SIZES])
        out[label] = dict(ms=ms, bytes_per_s=1 / slope, intercept_s=icpt)
        log(f"card {label}: "
            + " ".join(f"{n >> 20}MB={ms[n]:.4f}ms" for n in CARD_SIZES)
            + f"; line: {1 / slope / 1e9:.1f} GB/s moved, intercept "
            f"{icpt * 1e6:.2f}us ({smi})")
    del src, dst, host
    g = torch.Generator(device="cuda").manual_seed(19)
    a, b = (torch.randn((MATMUL_N, MATMUL_N), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    ms = median_ms(torch, lambda: torch.matmul(a, b), iters=10)
    out["bf16_flops"] = 2 * MATMUL_N ** 3 / (ms * 1e-3)
    out["matmul_ms"] = ms
    log(f"card bf16 matmul {MATMUL_N}^3: {ms:.4f}ms, "
        f"{out['bf16_flops'] / 1e12:.1f} TFLOP/s ({smi})")
    return out


def served_steps(get_config, reqs_llama, engine, static, arctic, llava,
                 paligemma, gemma3, deepseek, mamba, zamba, whisper):
    """(c)'s runs: every native run whose decode step this script records,
    as (label, config as served, [(B, mean positions a step reads), one a
    wave], measured step ms, byte bound ms or None). A step's positions
    are its wave's prompt plus the mean of its decode offsets; the
    continuous llama run's are its requests' mean at 8 slots."""
    def waves(prompts, B, new):
        return [(B, S + (new + 1) / 2) for S in prompts]

    def step(row):
        return 1e3 * row["decode_s"] / row["decode_steps"]

    def static_row(label, cfg, row, ws):
        return (label, cfg, ws, row["step_ms"], row.get("bound_ms"))

    def at(row):
        return [(row["B"], row["positions"] + (row["decode_steps"] + 1) / 2)]
    llama = get_config("llama3.2-1b")
    qwen = get_config("qwen2.5-3b")
    arc = dataclasses.replace(get_config("arctic-480b"),
                              n_layers=ARCTIC_LAYERS)
    ds = dataclasses.replace(get_config("deepseek-v2-236b"),
                             n_layers=DEEPSEEK_LAYERS)
    B, P, S, _ = PALIGEMMA_RUN
    whisper_B, whisper_S, _ = WHISPER_RUN
    rows = [
        ("llama continuous", llama,
         [(8, statistics.mean(len(r) for r in reqs_llama) + (64 + 1) / 2)],
         step(engine["native"]), None),
        ("qwen static", qwen, waves(QWEN_PROMPTS, 4, QWEN_NEW),
         step(static["native"]), None),
        ("arctic static", arc, waves(QWEN_PROMPTS, 4, ARCTIC_STATIC_NEW),
         step(arctic["runs"]["static native"]["runs"][0]), None)]
    for key in LLAVA_RUNS:
        r = llava["runs"][f"{key} native"]
        rows.append(static_row(f"llava ({key})", get_config("llava15-13b"),
                               r, at(r)))
    r = paligemma["runs"]["native"]
    rows.append(static_row("paligemma", get_config("paligemma-3b"), r,
                           [(B, P + S + (r["decode_steps"] + 1) / 2)]))
    rows.append(static_row("gemma3", get_config("gemma3-1b"),
                           gemma3["runs"]["native"],
                           waves(GEMMA_PROMPTS, 4, GEMMA_NEW)))
    for key in DEEPSEEK_RUNS:
        r = deepseek["runs"][f"{key} native"]
        rows.append(static_row(f"deepseek ({key})", ds, r, at(r)))
    for key in MAMBA_RUNS:
        r = mamba["runs"][key]
        rows.append(static_row(f"mamba ({key})", get_config("mamba2-130m"),
                               r, at(r)))
    rows.append(static_row("zamba", get_config("zamba2-2.7b"), zamba["run"],
                           waves(ZAMBA_PROMPTS, 4, ZAMBA_NEW)))
    r = whisper["run"]
    rows.append(static_row("whisper", get_config("whisper-medium"), r,
                           [(whisper_B, whisper_S + r["frames"]
                             + (r["decode_steps"] + 1) / 2)]))
    return rows


def model_step_ms(core, cfg, ws, hier) -> tuple:
    """The model's decode step, all weights and KV in HBM, averaged over
    the waves ``ws``, and the bottleneck of the first."""
    place = core.make_placement("all-hbm", "ddr")
    reps = [core.phase_time(core.decode_phase(cfg, int(round(ctx)), B, 2),
                            hier, place) for B, ctx in ws]
    return 1e3 * statistics.mean(r.total for r in reps), reps[0].bottleneck


def model_vs_card(core, rows, hiers, smi):
    """(c) The model's decode step under each hierarchy beside the measured
    step and the byte bound. Gate: llava (a) and (b), where the model and
    the bound count the same weights and KV, within 2% on the published
    H100."""
    out = {}
    for label, cfg, ws, meas, bound in rows:
        pred = {name: model_step_ms(core, cfg, ws, h)
                for name, h in hiers.items()}
        out[label] = dict(waves=ws, measured_ms=meas, bound_ms=bound,
                          **{f"{name}_ms": p for name, (p, _) in pred.items()},
                          bottleneck=pred["spec"][1])
        log(f"model {label:16s} " + " ".join(
            f"B={B} ctx={ctx:.0f}" for B, ctx in ws)
            + f": measured {meas:.3f}ms; model spec {pred['spec'][0]:.3f}ms "
            f"(measured/model {meas / pred['spec'][0]:.2f}x), card rates "
            f"{pred['card'][0]:.3f}ms ({meas / pred['card'][0]:.2f}x), "
            f"bound {'%.3fms' % bound if bound else 'none'}, model "
            f"bottleneck {pred['spec'][1]} ({smi})")
    for key in LLAVA_RUNS:
        r = out[f"llava ({key})"]
        err = r["spec_ms"] / r["bound_ms"] - 1
        r["spec_vs_bound"] = err
        check(abs(err) <= 0.02, f"model: llava ({key})'s step on the "
              f"published H100 is {100 * err:+.2f}% off its byte bound "
              f"(limit 2%)")
    return out


def h100_answers(core, h100, hiers, get_config, smi):
    """(d) ``beyond_gpu_tiers`` under each hierarchy, and the host-tier rate
    at which llava15-13b holds 10 tokens/s of decode at 32k positions with
    its KV in host DRAM."""
    from repro_torch.paper import beyond_gpu_tiers
    cfg = get_config("llava15-13b")
    kv_host = core.make_placement("kv-host", "ddr", kv="hbs")
    out = {}
    for name, hier in hiers.items():
        rows = []
        summary = beyond_gpu_tiers.run(lambda n, us, d: rows.append((n, d)),
                                       hier=hier)
        for n, d in rows:
            log(f"tiers ({name}) {n}: {d}")
        need = h100.required_level_bandwidth(
            cfg, hier, kv_host, target_tps=10.0, prefill=32128, decode=64)
        at = core.run_inference(cfg, hier, kv_host, 32128, 64, n_samples=5)
        log(f"tiers ({name}) {summary}; llava15-13b KV in host DRAM at "
            f"32,128-32,192 positions: {at.tps_decode_only:.2f} tokens/s "
            f"decode at {hier.level('hbs').bandwidth / 1e9:.1f} GB/s, 10 "
            f"tokens/s needs "
            f"{'%.1f GB/s' % need if need else 'more than 4096 GB/s'} of "
            f"host link ({smi})")
        out[name] = dict(rows=rows, summary=summary, required_gbps=need,
                         kv_host_tps=at.tps_decode_only)
    return out


def extractor_on_cpu(torch, tm, h100, get_config, busy_ms, smi):
    """(e) The cost extractor over one full-width llama3.2-1b paged decode
    step of phase 4's block shape (B=8, 300 cached, 36 pages a slot) on
    the CPU (bf16 weights drawn on the card, then copied): its FLOPs
    against ``model_flops_for``, its bytes against
    ``decode_compulsory_bytes``, the three roofline terms with H100
    constants, beside the card's busy time a step of phase 4's K=8 block.
    The extractor must refuse a CUDA tensor."""
    from repro_torch.core.cost_analysis import analyze
    try:
        analyze(torch.mm, torch.ones(2, 2, device="cuda"),
                torch.ones(2, 2, device="cuda"))
        refused = False
    except ValueError:
        refused = True
    check(refused, "cost_analysis counted a CUDA tensor's op")
    cfg = get_config("llama3.2-1b")
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, n_pp = 8, -(-MAX_LEN // PS)
    params = _to(tm.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "bfloat16", "cuda"), "cpu")
    torch.cuda.empty_cache()
    cache = tm.init_paged_cache(cfg, B * n_pp + 1, PS, opts, "cpu")
    pt = torch.arange(1, B * n_pp + 1, dtype=torch.int32).reshape(B, n_pp)
    lens = torch.full((B,), 300, dtype=torch.int32)
    tok = torch.arange(1, B + 1, dtype=torch.int32)
    t0 = time.perf_counter()
    costs = analyze(tm.decode_step_paged, cfg, params, tok, lens, pt, cache,
                    opts)
    secs = time.perf_counter() - t0
    mflops = h100.model_flops_for(cfg, "decode", 1, B)
    floor = h100.decode_compulsory_bytes(cfg, 301, B, 1)
    terms = h100.terms_from_costs(costs, n_dev=1, model_flops=mflops)
    check(costs.flops >= mflops and costs.bytes >= floor,
          f"extractor: {costs.flops:.4g} FLOP / {costs.bytes:.4g} B below "
          f"the model's {mflops:.4g} / {floor:.4g}")
    log(f"extractor (CPU, {secs:.1f}s): llama3.2-1b decode step B={B} len=300 "
        f"FLOPs {costs.flops:.5g} ("
        + " ".join(f"{k}={v:.4g}" for k, v in costs.flops_by_op.items())
        + f") vs model_flops_for {mflops:.5g} ({costs.flops / mflops:.3f}x); "
        f"bytes {costs.bytes:.5g} vs decode_compulsory_bytes {floor:.5g} "
        f"({costs.bytes / floor:.2f}x; by op "
        + " ".join(f"{k}={v:.4g}" for k, v in sorted(
            costs.bytes_by_op.items(), key=lambda kv: -kv[1])[:6])
        + f"); terms with H100 constants: compute "
        f"{terms.compute_s * 1e3:.4f}ms memory {terms.memory_s * 1e3:.4f}ms "
        f"collective {terms.collective_s * 1e3:.4f}ms ({terms.bottleneck}); "
        f"the card's busy time a step of phase 4's block "
        f"{busy_ms:.3f}ms ({smi})")
    return dict(flops=costs.flops, flops_by_op=costs.flops_by_op,
                bytes=costs.bytes, bytes_by_op=costs.bytes_by_op,
                model_flops=mflops, compulsory_bytes=floor,
                compute_ms=terms.compute_s * 1e3,
                memory_ms=terms.memory_s * 1e3,
                collective_ms=terms.collective_s * 1e3,
                card_busy_ms=busy_ms, cpu_s=secs)


# (f)'s counters: they follow the requests' lengths and the pool alone, so
# the card's full-width run must repeat the CPU twin's
SWEEP_COUNTERS = ("decode_steps", "preemptions", "peak_pages_used",
                  "pages_deduped", "prefill_tokens_computed")
# (f)'s tokens: each must be within this many standard deviations of its
# position's logits of the top f32 logit, given the tokens before it
SWEEP_GAP_STD = 0.5


@contextlib.contextmanager
def serves_recorded(kern, ServeEngine):
    """Every ``ServeEngine.serve`` while the block runs, with the counts
    set to 0 just before it and read just after: its scheduler, its
    launches by entry and by the KV heads of the pool each was given (the
    wrappers' ``launches_by_heads``), its layers, waves (distinct prompt
    lengths) and decode micro-steps, and on the continuous engine its
    verify passes, prefill chunks, speculation, the model draft's passes
    (``ModelDraft.passes``: prefill chunks, catch-up passes and decode
    micro-steps), its trace's reconcile and the pages it left."""
    runs, serve = [], ServeEngine.serve

    def recorded(eng, reqs, new):
        steps, blocks = eng.stats.decode_steps, eng.stats.spec_blocks
        zero_counts()
        out = serve(eng, reqs, new)
        paged = eng.scheduler == "continuous"
        model = paged and eng.spec_mode == "model"
        runs.append(dict(
            scheduler=eng.scheduler, launches=read_counts(),
            by_heads=read_heads(),
            draft=dict(eng.drafter.passes) if model else {},
            layers=eng.cfg.n_layers,
            kv_heads=eng.cfg.n_kv_heads // eng.shards,
            draft_kv_heads=eng.draft_cfg.n_kv_heads if model else None,
            spec_mode=eng.spec_mode, spec_k=eng.spec_k,
            waves=len({len(r) for r in reqs}),
            steps=eng.stats.decode_steps - steps,
            blocks=eng.stats.spec_blocks - blocks,
            chunks=n_prefill_chunks(eng) if paged else 0,
            ok=eng.trace_report["ok"] if paged else None,
            pages_left=eng.kv_manager.n_used if paged else None))
        return out
    ServeEngine.serve = recorded
    try:
        yield runs
    finally:
        ServeEngine.serve = serve


def sweep_launches(run) -> dict:
    """The launches one serve of (f) must make: the static engine flash
    once a layer a wave and the dense decode once a layer a micro-step,
    the continuous one the chunk kernel once a layer a prefill chunk and
    the paged decode once a layer a micro-step."""
    L = run["layers"]
    want = dict.fromkeys(KERNELS, 0)
    if run["scheduler"] == "static":
        want.update(flash_attention=L * run["waves"],
                    decode_attention=L * run["steps"])
    else:
        want.update(chunk_prefill_attention=L * run["chunks"],
                    paged_decode_attention=L * run["steps"])
    return want


def teacher_forced_gaps(torch, tm, cfg, params, seqs, batch=8):
    """For each (prompt, output) of ``seqs``: one f32 prefill of prompt +
    output on the CPU's plain path, and at each output position the top
    logit minus the output token's, over that position's logits' standard
    deviation (0 where the token is the f32 argmax)."""
    opts = tm.RuntimeOptions(dtype="float32")
    gaps = []
    for i in range(0, len(seqs), batch):
        group = seqs[i:i + batch]
        full = [p + o[:-1] for p, o in group]
        T = max(map(len, full))
        n_pp = -(-T // PS)
        toks = torch.zeros((len(group), T), dtype=torch.int32)
        for j, seq in enumerate(full):
            toks[j, :len(seq)] = torch.tensor(seq)
        cache = tm.init_paged_cache(cfg, len(group) * n_pp + 1, PS, opts,
                                    "cpu")
        pt = torch.arange(1, len(group) * n_pp + 1,
                          dtype=torch.int32).reshape(len(group), n_pp)
        lens = torch.tensor([len(seq) for seq in full], dtype=torch.int32)
        with torch.inference_mode():
            lg, _ = tm.prefill_paged_chunk(cfg, params, toks, cache, pt, 0,
                                           lens, opts)
        for j, (p, o) in enumerate(group):
            rows = lg[j, len(p) - 1:len(p) - 1 + len(o)].float()
            got = rows.gather(-1, torch.tensor(o)[:, None])[:, 0]
            gaps += ((rows.max(-1).values - got)
                     / rows.std(-1)).tolist()
    return gaps


def concurrency_on_card(torch, kern, tm, smi):
    """(f) ``concurrency_sweep``'s runtime halves on the card: llama3.2-1b
    at full width in bf16 (the seeded init), static vs continuous at n =
    2, 4, 8 ragged requests, and the shared-document stream with the
    prefix cache off and on. Every serve (warm-up ones too) must launch
    exactly its kernels (``sweep_launches``) and no plain version; the
    counters must equal the CPU twin's (``SWEEP_COUNTERS``; the lengths
    are the same); each output token must be within ``SWEEP_GAP_STD``
    standard deviations of the f32 argmax of the same weights on the CPU,
    given the tokens before it; the prefix cache must dedup pages."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.paper import concurrency_sweep as cs
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    cfg = cs.runtime_model("cuda")[0]
    params = tm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), "bfloat16", "cuda")
    with count_plain(kern, flash) as plain, \
            serves_recorded(kern, ServeEngine) as runs:
        rt = cs.runtime("cuda", params=params)
        sp = cs.shared_prefix_runtime("cuda", params=params)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    check(not plain, f"concurrency sweep: plain versions called on the "
          f"card: {plain}")
    launches = dict.fromkeys(KERNELS, 0)
    for i, run in enumerate(runs):
        want = sweep_launches(run)
        check(run["launches"] == want, f"concurrency sweep serve {i} "
              f"({run['scheduler']}): launches {run['launches']} != {want}")
        for k, v in run["launches"].items():
            launches[k] += v
    check(len(runs) == 4 * len(rt) + 4, f"concurrency sweep: {len(runs)} "
          f"serves recorded")

    cpu_rt = cs.runtime("cpu")
    cpu_sp = cs.shared_prefix_runtime("cpu")
    pairs = [(rt[n][s], cpu_rt[n][s], rt[n]["requests"],
              cpu_rt[n]["requests"], f"n={n} {s}")
             for n in rt for s in ("static", "continuous")]
    pairs += [(sp[pc], cpu_sp[pc], sp["requests"], cpu_sp["requests"],
               f"prefix cache {'on' if pc else 'off'}") for pc in (False,
                                                                  True)]
    seqs = set()
    for card, cpu, reqs, cpu_reqs, label in pairs:
        check(list(map(len, reqs)) == list(map(len, cpu_reqs)),
              f"concurrency sweep {label}: the card's prompt lengths are "
              f"not the CPU twin's")
        got = {k: card["stats"][k] for k in SWEEP_COUNTERS}
        want = {k: cpu["stats"][k] for k in SWEEP_COUNTERS}
        check(got == want, f"concurrency sweep {label}: counters {got} != "
              f"the CPU twin's {want}")
        check(all(len(o) == 16 and all(0 <= t < cfg.vocab for t in o)
                  for o in card["tokens"]),
              f"concurrency sweep {label}: malformed outputs")
        seqs |= {(tuple(p), tuple(o)) for p, o in zip(reqs, card["tokens"])}
    on, off = sp[True]["stats"], sp[False]["stats"]
    check(on["pages_deduped"] > 0 and on["prefill_tokens_computed"]
          < off["prefill_tokens_computed"],
          f"concurrency sweep: the prefix cache saved nothing ({on})")

    t1 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.to("cpu", torch.float32)
                          if t.is_floating_point() else t.cpu(), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gaps = teacher_forced_gaps(torch, tm, cfg, cpu_params,
                               [(list(p), list(o)) for p, o in sorted(seqs)])
    del cpu_params
    gc.collect()
    ref_s = time.perf_counter() - t1
    worst = max(gaps)
    exact = sum(g == 0 for g in gaps)
    log(f"concurrency sweep on the card ({card_s:.1f}s, {len(runs)} serves): "
        f"launches exact in every serve ("
        + " ".join(f"{k.split('_')[0]}={v}" for k, v in launches.items())
        + f"), no plain version, counters equal the CPU twin's in "
        f"{len(pairs)} runs; {len(seqs)} distinct outputs, {exact}/"
        f"{len(gaps)} tokens the f32 argmax on the CPU, the largest gap "
        f"{worst:.4f} std (limit {SWEEP_GAP_STD}; CPU {ref_s:.1f}s) ({smi})")
    check(worst <= SWEEP_GAP_STD, f"concurrency sweep: a bf16 token "
          f"{worst:.3f} std below the f32 argmax on the CPU")
    return dict(runtime={n: {s: rt[n][s]["stats"] for s in ("static",
                                                            "continuous")}
                         for n in rt},
                shared_prefix={str(pc): sp[pc]["stats"]
                               for pc in (False, True)},
                predicted_dedup=sp["predicted"], measured_dedup=sp["measured"],
                launches=launches, serves=len(runs), tokens=len(gaps),
                tokens_argmax=exact, worst_gap_std=worst, card_s=card_s,
                cpu_ref_s=ref_s)


def analytic_phase(torch, kern, tm, get_config, smi, served,
                   busy_ms) -> dict:
    """Phase 19 (a)-(f); ``served``: (c)'s rows (``served_steps``),
    ``busy_ms``: the card's busy time a step of phase 4's decode block."""
    import repro_torch.core as core
    from repro_torch.core import h100_roofline as h100
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card = measure_card(torch, smi)
    hiers = {"spec": h100.h100_hierarchy(),
             "card": h100.h100_hierarchy(
                 flops=card["bf16_flops"],
                 hbm_bw=card["hbm copy"]["bytes_per_s"],
                 host_bw=card["host->device"]["bytes_per_s"],
                 host_latency=max(card["host->device"]["intercept_s"], 0.0))}
    out = dict(card=card)
    out["model_vs_card"] = model_vs_card(core, served, hiers, smi)
    out["h100_answers"] = h100_answers(core, h100, hiers, get_config, smi)
    out["extractor"] = extractor_on_cpu(torch, tm, h100, get_config, busy_ms,
                                        smi)
    out["concurrency"] = concurrency_on_card(torch, kern, tm, smi)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 19 (the analytic model against the card) "
        f"{out['phase_s']:.1f}s")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def kernels_only(torch, args, smi, kern, flash, tm, get_config, built, hmma,
                 chunk_hmma, paged_regs, t_start):
    """--kernels-only: every kernel entry against its plain version and
    timed (phase 3), then the paged decode block, the prefill chunk and
    the verify pass profiled on full-width llama3.2-1b (seeded bf16
    init)."""
    rows = check_kernels(torch, kern, flash)
    cfg = get_config("llama3.2-1b")
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "bfloat16", "cuda")
    blocks = dict(decode_block=profile_decode_block(torch, tm, cfg, params),
                  chunk_block=profile_chunk_block(torch, tm, cfg, params),
                  verify_block=profile_verify_block(torch, tm, cfg, params))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            gpu=smi, src=args.src, kernel_cases=rows, build_s=built,
            flash_hmma=hmma, chunk_hmma=chunk_hmma, paged_ptxas=paged_regs,
            **blocks), indent=1))


# ------------- phase 20: the dry run's sharded paths on the card ------------- #
# (a) llama3.2-1b at full width, static: B prompts of S tokens, NEW decode
# steps, a MAXLEN-position cache length-sharded over 2 ranks on the card
SEQ_B, SEQ_S, SEQ_NEW, SEQ_MAXLEN, SEQ_TIMED = 4, 512, 32, 4096, 10
# (b) arctic-480b at full width cut to EP_LAYERS layers, each of 2 ranks
# holding half the experts; a forward of EP_FWD tokens
EP_LAYERS, EP_FWD = 2, (4, 64)
# one MoE layer at T=8 in phase 7, measured on the H100 at 700 W (CHANGES.md)
PHASE7_MOE_LAYER_MS = 8.688
# (c) cells whose dry run on a 1 x 1 mesh holds under 70 GB a rank
DRYRUN_CELLS = (("mamba2-130m", "long_500k"), ("mamba2-130m", "decode_32k"),
                ("zamba2-2.7b", "long_500k"))
PHASE20_TIMEOUT_S = 600.0


def _seq_prompts(torch, vocab: int):
    g = torch.Generator().manual_seed(20)
    return torch.randint(1, vocab, (SEQ_B, SEQ_S), generator=g,
                         dtype=torch.int32)


def _static_decode(torch, tm, cfg, params, toks, opts, n_new, group=None):
    """Prefill (replicated) and ``n_new`` greedy decode steps on the card;
    with ``group`` the cache is cut to this rank's length slice and the
    steps run the sequence-sharded attention. Returns (logits (n_new, B,
    V) f32 on the CPU, tokens, the final cache)."""
    from repro_torch.models.seq_shard_attn import length_slice
    cache = tm.init_cache(cfg, toks.shape[0], SEQ_MAXLEN, opts, "cuda")
    logits, cache = tm.prefill(cfg, params, toks, cache, opts)
    if group is not None:
        cache = length_slice(cache, group)
        opts = dataclasses.replace(opts, seq_shard_attn=True,
                                   seq_shard_mesh=group)
    tok = logits.argmax(-1).to(torch.int32)
    rows, out = [], []
    for j in range(n_new):
        logits, cache = tm.decode_step(cfg, params, tok, toks.shape[1] + j,
                                       cache, opts)
        tok = logits.argmax(-1).to(torch.int32)
        rows.append(logits.float().cpu())
        out.append(tok.cpu())
    return torch.stack(rows), torch.stack(out), cache


def _step_ms(torch, tm, cfg, params, toks, opts, group=None):
    """Median CUDA-event time of one decode step after the prefill (the
    sequence-sharded one with ``group``), over SEQ_TIMED steps."""
    from repro_torch.models.seq_shard_attn import length_slice
    cache = tm.init_cache(cfg, toks.shape[0], SEQ_MAXLEN, opts, "cuda")
    logits, cache = tm.prefill(cfg, params, toks, cache, opts)
    if group is not None:
        cache = length_slice(cache, group)
        opts = dataclasses.replace(opts, seq_shard_attn=True,
                                   seq_shard_mesh=group)
    tok = logits.argmax(-1).to(torch.int32)
    times = []
    for j in range(SEQ_TIMED + 3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        logits, cache = tm.decode_step(cfg, params, tok, SEQ_S + j, cache,
                                       opts)
        b.record()
        torch.cuda.synchronize()
        if j >= 3:
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def seq_rank(rank, n, check_f32):
    """One rank of phase 20 (a) (spawned): in f32 (when ``check_f32``) the
    unsharded decode on the card (the dense decode kernel, a launch a
    layer a step) and the sequence-sharded one on this rank's length
    slice (no launch); then the bf16 step time of the sharded path, and
    of the kernel path. Returns what the parent compares."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels.sharded import ShardGroup
    import repro_torch.models as tm
    torch.backends.cuda.matmul.allow_tf32 = False
    group = ShardGroup.from_world(n, "cuda")
    cfg = cut_llama(get_config)
    L = cfg.n_layers
    toks = _seq_prompts(torch, cfg.vocab).to("cuda")
    out = dict(device=str(group.device))
    if check_f32:
        opts = tm.RuntimeOptions(dtype="float32")
        params = tm.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "float32", "cuda")
        zero_counts()
        with count_plain(kern, flash) as plain:
            ref, ref_tok, whole = _static_decode(torch, tm, cfg, params, toks,
                                                 opts, SEQ_NEW)
        n_ref = read_counts()
        check(n_ref["decode_attention"] == L * SEQ_NEW
              and n_ref["flash_attention"] == L and not plain,
              f"rank {rank}: the unsharded decode's launches {n_ref} "
              f"(plain {plain})")
        zero_counts()
        with count_plain(kern, flash) as plain:
            got, got_tok, mine = _static_decode(torch, tm, cfg, params, toks,
                                                opts, SEQ_NEW, group)
        n_got = read_counts()
        check(n_got["decode_attention"] == 0 and n_got["flash_attention"] == L
              and not plain,
              f"rank {rank}: the sequence-sharded decode launched "
              f"{n_got} (plain {plain}); its attention is no kernel")
        top2 = ref.topk(2, dim=-1).values
        tied = (top2[..., 0] - top2[..., 1] < 1e-4).any(dim=-1)
        prefix = int(tied.nonzero()[0, 0]) if bool(tied.any()) else SEQ_NEW
        err = float((got[:prefix] - ref[:prefix]).abs().max()) if prefix \
            else 0.0
        per = SEQ_MAXLEN // n
        lo = rank * per
        bits, cache_err = {}, 0.0
        for name in ("k", "v"):
            want = whole["stack"][name][:, :, lo:lo + per]
            have = mine["stack"][name]
            pre = max(0, min(SEQ_S - lo, per))
            new = slice(pre, max(pre, min(SEQ_S + SEQ_NEW - lo, per)))
            bits[name] = dict(
                prefill=bool(torch.equal(have[:, :, :pre], want[:, :, :pre])),
                decoded_layer0=bool(torch.equal(have[0, :, new],
                                                want[0, :, new])))
            cache_err = max(cache_err,
                            float((have - want).abs().max()))
        out.update(prefix=prefix, logit_err=err,
                   tokens_equal=bool(torch.equal(got_tok[:prefix],
                                                 ref_tok[:prefix])),
                   cache_bits=bits, cache_err=cache_err,
                   launches_unsharded=n_ref, launches_sharded=n_got)
        del params, whole, mine
        torch.cuda.empty_cache()
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "bfloat16", "cuda")
    opts = tm.RuntimeOptions()
    out["sharded_step_ms"] = _step_ms(torch, tm, cfg, params, toks, opts,
                                      group)
    out["kernel_step_ms"] = _step_ms(torch, tm, cfg, params, toks, opts)
    return out


def seq_shard_on_card(torch, smi):
    """Phase 20 (a): llama3.2-1b's static decode with the cache length-
    sharded over 2 ranks on the one card (gloo), against the unsharded
    decode on the card in f32; the bf16 step at N = 1, 2 and on the
    kernel path."""
    from repro_torch.launch.ranks import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (one,) = run_ranks(seq_rank, 1, (1, False), backend="gloo",
                       timeout=PHASE20_TIMEOUT_S)
    two = run_ranks(seq_rank, 2, (2, True), backend="gloo",
                    timeout=PHASE20_TIMEOUT_S)
    for r, res in enumerate(two):
        check(res["prefix"] > 0 and res["tokens_equal"],
              f"seq-shard rank {r}: tokens differ from the unsharded decode "
              f"within the tie-free prefix of {res['prefix']} steps")
        check(res["logit_err"] <= 1e-4, f"seq-shard rank {r}: logits "
              f"{res['logit_err']:.3g} from the unsharded decode > 1e-4")
        check(all(b["prefill"] and b["decoded_layer0"]
                  for b in res["cache_bits"].values()),
              f"seq-shard rank {r}: its cache slice is not bitwise the "
              f"unsharded cache's ({res['cache_bits']})")
        check(res["cache_err"] <= 1e-4, f"seq-shard rank {r}: cache slice "
              f"{res['cache_err']:.3g} from the unsharded cache's > 1e-4")
    r0 = two[0]
    log(f"seq-shard llama3.2-1b B={SEQ_B} S={SEQ_S} +{SEQ_NEW} max_len "
        f"{SEQ_MAXLEN}, 2 ranks on one card (gloo), f32: tokens == "
        f"unsharded (dense decode kernel, "
        f"{r0['launches_unsharded']['decode_attention']} launches; sharded "
        f"0) over the tie-free "
        f"prefix of {r0['prefix']} steps, logits max err "
        f"{max(r['logit_err'] for r in two):.2e} (tol 1e-4), cache slices "
        f"bitwise at the prefilled positions and layer 0's decoded ones, "
        f"max err {max(r['cache_err'] for r in two):.2e} elsewhere")
    log(f"seq-shard bf16 decode step ({smi}): N=1 "
        f"{one['sharded_step_ms']:.3f}ms, N=2 {r0['sharded_step_ms']:.3f}ms "
        f"(rank 0; rank 1 {two[1]['sharded_step_ms']:.3f}ms), kernel path "
        f"{one['kernel_step_ms']:.3f}ms ({time.perf_counter() - t0:.1f}s)")
    return dict(n1=one, n2=two, phase_s=time.perf_counter() - t0)


def _ep_inputs(torch, cfg):
    g = torch.Generator().manual_seed(21)
    toks = torch.randint(1, cfg.vocab, EP_FWD, generator=g, dtype=torch.int32)
    x8 = torch.randn((1, 8, cfg.d_model), generator=g).bfloat16()
    x64 = torch.randn((1, 64, cfg.d_model), generator=g).bfloat16()
    return toks, x8, x64


def ep_rank(rank, n, layers):
    """One rank of phase 20 (b) (spawned): arctic-480b's full width at
    ``layers`` layers holding its E/N experts (drawn from the whole
    init's stream), the forward and one layer's MoE FFN through the
    expert-parallel path, and that layer's time at T=8."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.kernels.sharded import ShardGroup
    import repro_torch.models as tm
    from repro_torch.models import moe as tmoe
    group = ShardGroup.from_world(n, "cuda")
    cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=layers)
    E_loc = cfg.moe.n_experts // n
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "bfloat16", "cuda",
                            experts=slice(rank * E_loc, (rank + 1) * E_loc))
    held = torch.cuda.memory_allocated()
    opts = tm.RuntimeOptions(moe_impl="shard_map", moe_shard_map_mesh=group)
    toks, x8, x64 = (t.to("cuda") for t in _ep_inputs(torch, cfg))
    zero_counts()
    with torch.no_grad():
        logits = tm.forward(cfg, params, toks, opts)
        p0 = _layer(params["stack"], 0)["moe"]
        y, aux = tmoe.moe_ffn(p0, x64, cfg, impl="shard_map",
                              shard_map_mesh=group)
        ms = median_ms(torch, lambda: tmoe.moe_ffn(
            p0, x8, cfg, impl="shard_map", shard_map_mesh=group), iters=10)
    # numpy, not CPU tensors: a tensor crosses the queue as a shared-memory
    # handle that dies with this process
    return dict(logits=logits.float().cpu().numpy(),
                y=y.float().cpu().numpy(),
                aux=[float(aux["load_balance"]), float(aux["router_z"])],
                layer_ms=ms, held_bytes=held, experts=E_loc,
                launches=read_counts())


def ep_on_card(torch, tm, get_config, smi):
    """Phase 20 (b): the capacity path on the whole (cut) model here, then
    2 spawned ranks each holding half the experts (gloo, one card): the
    forward's logits within phase 7's bf16 tolerance, one layer's output
    and aux losses; the EP layer's time beside phase 7's."""
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import moe as tmoe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=EP_LAYERS)
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "bfloat16", "cuda")
    whole = torch.cuda.memory_allocated()
    toks, x8, x64 = (t.to("cuda") for t in _ep_inputs(torch, cfg))
    with torch.no_grad():
        ref = tm.forward(cfg, params, toks).float().cpu()
        ref_y, ref_aux = tmoe.moe_ffn(_layer(params["stack"], 0)["moe"], x64,
                                      cfg)
    ref_y = ref_y.float().cpu()
    ref_aux = [float(ref_aux["load_balance"]), float(ref_aux["router_z"])]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(ep_rank, 2, (2, EP_LAYERS), backend="gloo",
                      timeout=PHASE20_TIMEOUT_S)

    def ulps2(t):
        # two bf16 ulps at the largest magnitude (phase 7's tolerance)
        scale = float(t.abs().max())
        return 2 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    errs = []
    for r, res in enumerate(ranks):
        e_log = float((torch.from_numpy(res["logits"]) - ref).abs().max())
        e_y = float((torch.from_numpy(res["y"]) - ref_y).abs().max())
        e_aux = max(abs(a - b) for a, b in zip(res["aux"], ref_aux))
        check(e_log <= ulps2(ref), f"EP rank {r}: logits {e_log:.3g} from "
              f"the capacity path > {ulps2(ref):.3g}")
        check(e_y <= ulps2(ref_y), f"EP rank {r}: layer output {e_y:.3g} "
              f"> {ulps2(ref_y):.3g}")
        check(e_aux <= 1e-5, f"EP rank {r}: aux {res['aux']} vs {ref_aux}")
        check(res["held_bytes"] < whole, f"EP rank {r} holds "
              f"{res['held_bytes']} B, not less than the whole {whole} B")
        errs.append((e_log, e_y, e_aux))
    log(f"EP arctic-480b {EP_LAYERS} of 35 layers, 2 ranks x "
        f"{ranks[0]['experts']} experts on one card (gloo): "
        f"{ranks[0]['held_bytes'] / 1e9:.1f} GB a rank vs {whole / 1e9:.1f} "
        f"GB whole; {EP_FWD[0]}x{EP_FWD[1]} forward logits max err "
        f"{max(e[0] for e in errs):.3g} (tol {ulps2(ref):.3g}), layer "
        f"{max(e[1] for e in errs):.3g}, aux {max(e[2] for e in errs):.2e} "
        f"(tol 1e-5) vs the capacity path")
    log(f"EP one MoE layer T=8 ({smi}): N=2 {ranks[0]['layer_ms']:.3f}ms "
        f"(rank 0; rank 1 {ranks[1]['layer_ms']:.3f}ms) beside phase 7's "
        f"{PHASE7_MOE_LAYER_MS}ms on one rank "
        f"({time.perf_counter() - t0:.1f}s)")
    for res in ranks:
        del res["logits"], res["y"]
    return dict(ranks=ranks, whole_bytes=whole, errs=errs, ref_aux=ref_aux,
                phase_s=time.perf_counter() - t0)


def _requested(torch) -> int:
    """The bytes the live tensors asked the caching allocator for (before
    its rounding)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dryrun_on_card(torch, tm, get_config, smi):
    """Phase 20 (c): each DRYRUN_CELLS cell's dry run on a 1 x 1 mesh (this
    machine's CPU, fake ranks), then its params, cache and inputs built on
    the card (the bytes they ask the allocator for = the dry run's
    argument bytes; what it allocates, within its rounding) and one real
    step (peak and CUDA-event time beside the dry run's peak and step
    bound)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.tree import leaves
    out = {}
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh_shape=MeshShape(
            ("data", "model"), (1, 1)), write=False)
        check("error" not in rec, f"dry run {arch} x {shape}: "
              f"{rec.get('error')}")
        mem = rec["memory"]
        check(mem["peak_bytes"] < 70e9, f"dry run {arch} x {shape}: peak "
              f"{mem['peak_bytes']} B is not under 70 GB")
        cfg, sp = get_config(arch), tm.SHAPES[shape]
        max_len = ((sp.seq_len + 8 + 255) // 256) * 256
        opts = tm.RuntimeOptions()
        gc.collect()
        torch.cuda.empty_cache()
        base, base_req = torch.cuda.memory_allocated(), _requested(torch)
        params = tm.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "bfloat16", "cuda")
        cache = tm.init_cache(cfg, sp.global_batch, max_len, opts, "cuda")
        token = torch.zeros((sp.global_batch,), dtype=torch.int32,
                            device="cuda")
        pos = torch.tensor(sp.seq_len, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        asked = _requested(torch) - base_req
        n_t = len(leaves(params)) + len(leaves(cache)) + 2
        # the bytes the tensors asked for are the dry run's exactly; the
        # allocator hands out 512-byte multiples, and a block of 1 MiB or
        # more keeps the unsplit rest of its 2 MiB-rounded segment (< 1
        # MiB)
        check(asked == mem["argument_bytes"]
              and 0 <= grown - asked <= 2 ** 20 * n_t,
              f"{arch} x {shape}: the card's inputs asked for {asked} B "
              f"(allocated {grown}), the dry run counts "
              f"{mem['argument_bytes']} ({n_t} tensors)")
        torch.cuda.reset_peak_memory_stats()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.no_grad():
            tm.decode_step(cfg, params, token, int(pos), cache, opts)
            torch.cuda.synchronize()
            a.record()
            logits, _ = tm.decode_step(cfg, params, token, int(pos), cache,
                                       opts)
            b.record()
        torch.cuda.synchronize()
        step_ms = a.elapsed_time(b)
        peak = torch.cuda.max_memory_allocated() - base
        peak_req = torch.cuda.memory_stats()["requested_bytes.all.peak"] \
            - base_req
        check(bool(torch.isfinite(logits).all()), f"{arch} x {shape}: "
              f"logits not finite")
        bound_ms = rec["roofline"]["step_time_lower_bound_s"] * 1e3
        log(f"dry run vs card {arch} x {shape} (1x1 mesh; {smi}): argument "
            f"{mem['argument_bytes']} B, card asked +{asked} B (allocated "
            f"+{grown} B, {n_t} tensors); peak dry "
            f"{mem['peak_bytes'] / 1e9:.3f} GB vs card "
            f"{peak_req / 1e9:.3f} GB asked ({peak / 1e9:.3f} allocated); step {step_ms:.3f}ms vs bound "
            f"{bound_ms:.3f}ms ({rec['roofline']['bottleneck']}); trace "
            f"{rec['compile_s']:.1f}s ({time.perf_counter() - t0:.1f}s)")
        out[f"{arch} x {shape}"] = dict(
            argument_bytes=mem["argument_bytes"], card_asked=asked,
            card_bytes=grown, tensors=n_t, peak_dry=mem["peak_bytes"],
            peak_card_asked=peak_req, peak_card=peak,
            step_ms=step_ms, bound_ms=bound_ms,
            bottleneck=rec["roofline"]["bottleneck"],
            trace_s=rec["compile_s"])
        del params, cache, token, pos, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_paths_phase(torch, kern, tm, get_config, smi) -> dict:
    """Phase 20: the dry run's two sharded paths on the card and the dry
    run's byte accounting against the card's allocator. No kernel is on
    either sharded path (the counts stay 0 there)."""
    t0 = time.perf_counter()
    out = dict(seq_shard=seq_shard_on_card(torch, smi),
               ep=ep_on_card(torch, tm, get_config, smi),
               dryrun=dryrun_on_card(torch, tm, get_config, smi))
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 20 (the dry run's sharded paths) {out['phase_s']:.1f}s")
    return out


# ------------------ phase 21: the sync audit on the card ------------------ #

# the requests (of phase 4's 16) and new tokens of the audit's two
# continuous serves; the static wave (B, S) and its new tokens
AUDIT_REQS, AUDIT_NEW, AUDIT_WAVE = 4, 16, (2, 64)
SYNC_MSG = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def sync_warnings(torch):
    """Sync debug mode "warn" while entered; yields the list that gets each
    of its warnings' Python frames (file, line, qualname). No warning is
    dropped: any other goes on to the old handler."""
    import warnings
    records = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_MSG not in str(message):
                return old(message, category, filename, lineno, file, line)
            frames, f = [], sys._getframe(1)
            while f is not None:
                frames.append((f.f_code.co_filename, f.f_lineno,
                               f.f_code.co_qualname.replace(".<locals>", "")))
                f = f.f_back
            records.append(frames)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield records
        finally:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def root_calls(modules, names):
    """Wrap ``names`` in each of ``modules`` (where the engines look them
    up): count each wrapped root's calls and keep its first call's
    arguments, to run it again under sync debug mode "error"."""
    calls, saved = {}, []
    for mod in modules:
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=name, **kw):
                rec = calls.setdefault(_name, {"n": 0, "fn": _fn})
                rec["n"] += 1
                rec.setdefault("args", (a, kw))
                return _fn(*a, **kw)
            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def audit_table(project, host_sync, purity, records, src, label) -> dict:
    """Each recorded sync by its innermost ``repro_torch`` site (file, line,
    function, class) and the serving statement that led to it; the pulls
    at no counted site; the syncs under a capture root at a site with no
    justified pragma or baseline entry."""
    from repro_torch.analysis.core import load_baseline
    counted = host_sync.counted_sites(project)
    pkg = str(src / "repro_torch") + "/"
    roots = set()
    for r in purity.CAPTURE_ROOTS:
        roots.add((str(src / r.path), r.qualname))
    justified = {(e.get("path"), e.get("line"))
                 for e in load_baseline(ROOT / "analysis_baseline_torch.json")
                 .values() if e.get("rule") == purity.RULE}
    sites, bad_pulls, bad_roots = {}, [], []
    for frames in records:
        ours = [(f, ln, q) for f, ln, q in frames if f.startswith(pkg)]
        if not ours:
            bad_pulls.append(f"{label}: a sync outside repro_torch at "
                             f"{frames[0][:2]}")
            continue
        f, ln, q = ours[0]
        rel = f[len(str(src)) + 1:]
        mod = project.module(rel)
        cls = host_sync.sync_class(mod, ln) if mod is not None else "other"
        # the serving statement it came from (an upload's caller of _dev)
        via = next(((g[len(str(src)) + 1:], m, r) for g, m, r in ours
                    if "/serving/" in g and not r.endswith("._dev")),
                   ("", 0, ""))
        key = (rel, ln, q, cls, f"{via[0].split('/')[-1]}:{via[1]}")
        sites[key] = sites.get(key, 0) + 1
        if cls == "pull" and not any(
                s.path == rel and s.line <= ln <= s.end_line
                for s in counted):
            bad_pulls.append(f"{label}: pull at {rel}:{ln} ({q}) is no "
                             f"counted site of the host-sync rule")
        in_root = [r for g, m, r in frames if (g, r) in roots]
        if in_root and not ((mod is not None
                             and mod.allowed(purity.RULE, ln))
                            or (rel, ln) in justified):
            bad_roots.append(f"{label}: {cls} at {rel}:{ln} ({q}) inside "
                             f"capture root {in_root[-1]}")
    return dict(sites=sites, bad_pulls=bad_pulls, bad_roots=bad_roots)


def sync_audit(torch, tm, ServeEngine, get_config, smi) -> dict:
    """Phase 21: the host-sync checker and the capture roots of
    ``repro_torch.analysis`` against the syncs the card takes (sync debug
    mode "warn", every warning's Python stack kept) on llama3.2-1b at
    full width, bf16: phase 4's continuous engine on 4 of its requests (16
    new tokens), greedy and n-gram k=4, and a static ``generate`` (B=2 x
    64, 16 new). Every pull must lie at a site the checker counts, no
    sync may lie under a capture root unless its site is justified, and
    each root these paths call runs once more, at its first call's
    arguments, under sync debug mode "error"."""
    import numpy as np

    import repro_torch.serving.engine as eng_mod
    from repro_torch.analysis import load_project
    from repro_torch.analysis.checkers import host_sync, purity
    t0 = time.perf_counter()
    src = Path(tm.__file__).resolve().parents[2]
    project = load_project(src)
    cfg = get_config("llama3.2-1b")
    reqs = requests(cfg.vocab)[:AUDIT_REQS]
    B, S = AUDIT_WAVE
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, size=(B, S))
    names = sorted({r.qualname for r in purity.CAPTURE_ROOTS
                    if "." not in r.qualname})
    runs, params, calls_all = {}, None, {}
    for label, kw in (("continuous", {}),
                      ("ngram", dict(spec_mode="ngram", spec_k=4)),
                      ("static", None)):
        opts = tm.RuntimeOptions(dtype="bfloat16")
        if kw is None:
            eng = ServeEngine(cfg, params, opts, device="cuda", seed=0,
                              scheduler="static", decode_lookahead=8,
                              max_len=S + AUDIT_NEW + 8)
        else:
            eng = ServeEngine(cfg, params, opts, device="cuda", seed=0,
                              scheduler="continuous", page_size=PS,
                              max_batch=8, prefill_chunk=C,
                              decode_lookahead=8, max_len=MAX_LEN, **kw)
        params = eng.params
        torch.cuda.synchronize()
        with root_calls((eng_mod, tm.sampling), names) as calls, \
                sync_warnings(torch) as records:
            if kw is None:
                outs = eng.generate(prompts, AUDIT_NEW)
            else:
                outs = eng.serve([r[:] for r in reqs], AUDIT_NEW)
        check(all(len(o) == AUDIT_NEW and all(0 <= t < cfg.vocab for t in o)
                  for o in outs), f"audit {label}: malformed outputs")
        tab = audit_table(project, host_sync, purity, records, src, label)
        pulls = sum(n for k, n in tab["sites"].items() if k[3] == "pull")
        ups = sum(n for k, n in tab["sites"].items() if k[3] == "upload")
        other = sum(n for k, n in tab["sites"].items() if k[3] == "other")
        for (rel, ln, q, cls, via), n in sorted(tab["sites"].items()):
            log(f"sync {label} {rel}:{ln} {q} {cls} x{n} (via {via})")
        log(f"sync audit {label}: host_syncs={eng.stats.host_syncs} "
            f"pulls={pulls} uploads={ups} other={other} root calls "
            + " ".join(f"{k}={v['n']}" for k, v in sorted(calls.items())))
        for msg in tab["bad_pulls"] + tab["bad_roots"]:
            log(f"FAIL {msg}")
        check(not tab["bad_pulls"], f"audit {label}: pulls outside the "
              f"host-sync rule's counted sites: {tab['bad_pulls']}")
        check(not tab["bad_roots"], f"audit {label}: unjustified syncs "
              f"under a capture root: {tab['bad_roots']}")
        runs[label] = dict(
            host_syncs=eng.stats.host_syncs, pulls=pulls, uploads=ups,
            other=other, root_calls={k: v["n"] for k, v in calls.items()},
            sites=[dict(path=k[0], line=k[1], function=k[2], cls=k[3],
                        via=k[4], count=n)
                   for k, n in sorted(tab["sites"].items())])
        for name, rec_call in calls.items():
            calls_all.setdefault(name, rec_call)
        del eng
    # every root these paths call, once more under "error", at its first
    # call's arguments (the pool it writes is the finished serve's)
    for name, rec_call in sorted(calls_all.items()):
        a, kw = rec_call["args"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rec_call["fn"](*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"capture root {name}: no host sync under sync debug mode "
            f"\"error\"")
    check({"prefill_paged_chunk", "decode_steps_paged", "spec_decode_verify",
           "prefill", "decode_steps"} <= set(calls_all),
          f"the audit's paths called only the roots {sorted(calls_all)}")
    del params, calls_all
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(runs=runs, smi=smi, phase_s=time.perf_counter() - t0)
    log(f"phase 21 (the sync audit) {out['phase_s']:.1f}s")
    return out


# -------- phase 22: head width 256, paligemma-3b's decoder text-only -------- #

def serve_paligemma_text(torch, kern, tm, cm, ServeEngine, get_config,
                         derive=PALI_TEXT, name="paligemma text", phase=22):
    """paligemma-3b's Gemma-2B decoder served as a text-only causal LM
    (``derive``: ``PALI_TEXT``, d_model 2048, 8 heads over 1 KV head at
    head width 256; ``WIDE_TEXT``, its heads regrouped as 4 of 512; or
    ``WIDER_TEXT``, as 2 of 1024) at full width, cut to ``TEXT_LAYERS`` of
    its 18 layers, in bf16, the port's seeded init: the
    continuous engine (native, int8, n-gram k=4; pages of 32 keys) and the
    static engine (serve_bucketed, native and int8), each run twice
    through ``engine_twice`` (the same tokens, exact launches, no plain
    version, no masked attention). Prints each spec-off run's decode
    micro-step and tokens/s beside its byte bound over 3.35 TB/s: the
    weights a step reads (every parameter: the tied head reads the whole
    embedding table) and the KV its tokens read, averaged over the run's
    micro-steps. Then ``f32_text_card_vs_cpu``."""
    cfg = get_config("paligemma-3b").replace(**derive,
                                             n_layers=TEXT_LAYERS)
    for path in ("paged", "static"):
        check(tm.kernel_width_reason(cfg, path) is None,
              f"{cfg.name} text-only: the {path} path refuses head width "
              f"{cfg.head_dim}")
    t_phase = time.perf_counter()
    params = _init_on_card(torch, tm, cfg, "bfloat16")
    L = cfg.n_layers
    w_bytes = _param_bytes(params)
    kv_pos = 2 * L * cfg.n_kv_heads * cfg.head_dim        # a position, x1 B
    reqs = requests(cfg.vocab, PALI_TEXT_REQS)
    static_reqs = qwen_requests(cfg.vocab)
    runs, launches = {}, {}
    for label, sched, kw in (
            ("native", "continuous", {}),
            ("int8", "continuous", dict(kv_policy="int8")),
            ("ngram", "continuous", dict(spec_mode="ngram", spec_k=4)),
            ("static native", "static", {}),
            ("static int8", "static", dict(kv_policy="int8"))):
        launches[label], runs[label] = engine_twice(
            torch, kern, ServeEngine, tm.RuntimeOptions, cfg, params,
            static_reqs if sched == "static" else reqs, label, sched,
            PALI_TEXT_NEW, model=name, page_size=PALI_TEXT_PS,
            cm=cm, **kw)
        if "ngram" in label:
            continue
        row = runs[label]["runs"][0]
        # every decoded token reads its own sequence's KV once: the
        # prompt and the tokens before it (the first comes from prefill)
        elem = 1 if "int8" in label else 2
        kv = elem * kv_pos * sum(len(r) + j for r in
                                 (static_reqs if sched == "static" else reqs)
                                 for j in range(1, PALI_TEXT_NEW))
        steps = max(row["decode_steps"], 1)
        row.update(step_ms=1e3 * row["decode_s"] / steps,
                   bound_ms=(w_bytes * steps + kv) / steps
                   / HBM_BYTES_PER_S * 1e3,
                   weight_bytes=w_bytes, kv_bytes_per_step=kv / steps)
        log(f"{name} {label}: decode micro-step {row['step_ms']:.2f}"
            f"ms (host clock, mean of {steps}), tokens/s "
            f"{row['tokens_per_s']:.1f}, against its byte bound "
            f"{row['bound_ms']:.3f}ms ({w_bytes / 1e9:.2f} GB weights + "
            f"{kv / steps / 1e6:.1f} MB KV a step)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = f32_text_card_vs_cpu(torch, tm, ServeEngine, cfg, name)
    phase_s = time.perf_counter() - t_phase
    log(f"phase {phase} ({name}, head width {cfg.head_dim}) {phase_s:.1f}s")
    return dict(runs=runs, n_layers=L, params_bytes=w_bytes,
                kv_bytes_per_position=kv_pos * 2, f32=f32,
                phase_s=phase_s), launches


def f32_text_card_vs_cpu(torch, tm, ServeEngine, cfg_full, name):
    """The text-only decoder at full width cut to ``PALI_TEXT_F32_LAYERS``
    layers, in f32 (the kernels' FMA bodies at its head width): the
    continuous engine and the static engine on the card against the same
    engines on the CPU (plain versions), the
    same seeded weights; tokens equal over each request's tie-free prefix
    (``tie_free_prefix``, on the card's spec-off logits)."""
    import numpy as np
    cfg = dataclasses.replace(cfg_full, n_layers=PALI_TEXT_F32_LAYERS)
    params = tm.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                            "float32", "cuda")
    opts = tm.RuntimeOptions(dtype="float32")
    rng = np.random.default_rng(7)
    reqs = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
            for n in (72, 33, 50, 17)]
    new = 16
    cont = dict(scheduler="continuous", page_size=PALI_TEXT_PS, max_batch=8,
                prefill_chunk=C, max_len=MAX_LEN, overlap=False)
    runs = (("continuous", cont),
            ("static", dict(scheduler="static", decode_lookahead=8,
                            max_len=MAX_LEN)))
    outs = {}
    cpu_params = _to(params, "cpu")
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else cpu_params
        for label, kw in runs:
            eng = ServeEngine(cfg, p, opts, device=dev, **kw)
            outs[dev, label] = eng.serve([r[:] for r in reqs], new)
    result = {}
    for label, _ in runs:
        n_tie = 0
        for prompt, got, want in zip(reqs, outs["cuda", label],
                                     outs["cpu", label]):
            if got != want:
                n = tie_free_prefix(torch, tm, cfg, params, opts, prompt,
                                    want)
                check(n < len(want) and got[:n] == want[:n],
                      f"f32 {name} {label}: card tokens diverged "
                      f"from the CPU's before any near-tie: {got} vs {want}")
                n_tie += 1
        result[label] = dict(near_tie_requests=n_tie)
        log(f"f32 {name} ({cfg.n_layers} layers, full width) "
            f"{label}: card == CPU on {len(reqs)} x {new} tokens "
            f"({n_tie} requests differ after a top-2 gap < 1e-4)")
    del params, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------- phase 24: the port's examples (A16) ------------------- #

def _ckpt_leaves(step_dir):
    import numpy as np
    with np.load(step_dir / "leaves.npz") as z:
        return {k: z[k] for k in z.files}


def examples_on_card(torch, kern) -> dict:
    """``repro_torch.examples.serve_batched`` at its defaults on the card
    (8 x 64 prompt tokens, 64 new, native and int8, then the ragged
    requests bucketed and continuous, which must agree; no plain version
    of a kernel); then ``train_100m --tiny`` for ``EXAMPLE_STEPS`` steps
    with a checkpoint every half of them, and the same command restarted
    from the middle (the last checkpoint removed, the command run again):
    the resumed steps' losses and the last checkpoint must equal the
    straight run's bitwise. The checkpoints live under build/ and are
    removed."""
    import json as _json
    import shutil
    from repro_torch.examples import serve_batched, train_100m
    from repro_torch.kernels import flash_attention as flash
    t0 = time.perf_counter()
    zero_counts()
    with count_plain(kern, flash) as plain:
        served = serve_batched.main(["--device", "cuda"])
    check(not plain, f"serve_batched called plain versions: {plain}")
    launched = read_counts()
    check(all(v > 0 for k, v in launched.items()
              if k != "spec_verify_attention"),
          f"serve_batched did not launch its paths' kernels: {launched}")
    serve_s = time.perf_counter() - t0
    base = ROOT / "build" / "smoke_train100m"
    straight, restarted = base / "straight", base / "restarted"
    half = EXAMPLE_STEPS // 2     # the example checkpoints every half run
    argv = ["--tiny", "--steps", str(EXAMPLE_STEPS), "--device", "cuda"]

    def losses(d):
        return [_json.loads(x)["loss"]
                for x in (d / "metrics.jsonl").read_text().splitlines()]
    t0 = time.perf_counter()
    try:
        train_100m.main(argv + ["--ckpt-dir", str(straight), "--fresh"])
        train_100m.main(argv + ["--ckpt-dir", str(restarted), "--fresh"])
        shutil.rmtree(restarted / f"step_{EXAMPLE_STEPS}")
        text = train_100m.main(argv + ["--ckpt-dir", str(restarted)])
        first, again = losses(straight), losses(restarted)
        a = _ckpt_leaves(straight / f"step_{EXAMPLE_STEPS}")
        b = _ckpt_leaves(restarted / f"step_{EXAMPLE_STEPS}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check(f"resumed from step {half}" in text, "train_100m did not resume")
    check(first[-1] < first[0], f"train_100m's loss did not fall: {first}")
    check(again[:EXAMPLE_STEPS] == first and again[EXAMPLE_STEPS:]
          == first[half:], f"the restarted run's losses {again} are not "
          f"the straight run's {first} bitwise")
    check(a.keys() == b.keys() and all(
        (a[k] == b[k]).all() and a[k].dtype == b[k].dtype for k in a),
        f"the restarted run's step-{EXAMPLE_STEPS} checkpoint is not the "
        f"straight run's bitwise")
    train_s = time.perf_counter() - t0
    log(f"examples: serve_batched {serve_s:.1f}s (launches "
        + " ".join(f"{k.split('_')[0]}={v}" for k, v in launched.items())
        + f"); train_100m --tiny {EXAMPLE_STEPS} steps, restarted at step "
        f"{half}: losses and the step-{EXAMPLE_STEPS} checkpoint ({len(a)} "
        f"leaves) bitwise the straight run's, {train_s:.1f}s")
    return dict(serve_batched=served, launches=launched, serve_s=serve_s,
                train_losses=first, resumed_losses=again[EXAMPLE_STEPS:],
                train_s=train_s)


# -------------------------------- main ---------------------------------- #

# -------- phase 25: the paper's memory levers, HBS and the chiplet -------- #

# the hbs_sweep decoder's pool as the kernels see it: 4 slots of up to 120
# positions (96 prompt + 24 new), pages of 16, chunks of 32 (the engine's
# default at pages of 16), the scalar-start chunk at the third chunk of a
# 96-token prompt
TIER_SLOTS, TIER_MAX_LEN, TIER_CHUNK, TIER_START = 4, 120, 32, 64
TIER_MAIN = {
    "paged_decode_attention":
        "group=1 pool=bfloat16 dh=128 slots=4 max_len=120",
    "chunk_prefill_attention":
        "group=1 pool=bfloat16 start=scalar dh=128 slots=4 max_len=120 C=32"}
# the chiplet sweep's pool: the same requests and pages at llama3.2-1b's
# width (32 heads of 64 over 32 KV heads)
LLAMA_WIDTH = (32, 64, 32)
TIER_MAIN_1B = {
    "paged_decode_attention": "group=1 pool=bfloat16 slots=4 max_len=120",
    "chunk_prefill_attention":
        "group=1 pool=bfloat16 start=scalar slots=4 max_len=120 C=32"}


def tier_cases(torch, kern):
    """The paged decode and the chunk in bf16 at phase 25's pool
    (``TIER_*``) at both sweeps' widths: llava15-13b's decoder (40 heads
    of 128 over 40 KV heads) and llama3.2-1b (32 of 64 over 32)."""
    for H, DH, Hkv in (LLAVA_WIDTH, LLAMA_WIDTH):
        yield from paged_cases(torch, kern, H, DH, Hkv, pools=("bfloat16",),
                               verify_c=(), chunk_edges=False,
                               slots=TIER_SLOTS, max_len=TIER_MAX_LEN,
                               chunk_len=TIER_CHUNK, scalar_start=TIER_START,
                               main_only=True)


def _tier_cell_line(sweep, c) -> str:
    name = (f"bw={c['bw_gbps']:g}GB/s lat={c['latency_us']:g}us"
            if sweep == "hbs" else
            f"chiplet={c['chiplet_pages']}p {c['policy']}/"
            f"{c['writeback_link']} bw={c['bw_gbps']:g}GB/s")
    chip = (f" chiplet_hit={c['chiplet_hit_rate']:.4f} saved="
            f"{c['stall_saved_ms']:.3f}ms" if sweep == "chiplet" else "")
    return (f"tiers {sweep} {name}: tokens/s={c['tps']:.1f} itl p50/p95="
            f"{c['itl_p50_ms']:.2f}/{c['itl_p95_ms']:.2f}ms stall="
            f"{c['stall_ms']:.3f}ms spill={c['spill_mb']:.2f}MB fetch="
            f"{c['fetch_mb']:.2f}MB prefetch_hit={c['prefetch_hit_rate']:.3f}"
            f"{chip} breakdown_ms="
            + json.dumps({k: round(v, 2)
                          for k, v in c["breakdown_ms"].items()}))


# the sweeps of phase 25, and the CPU threads of each process of reduced
# twins, which run beside the kernels' build (one nvcc a source takes the
# other cores)
TIER_SWEEPS = ("hbs_sweep", "chiplet_sweep")
TWIN_THREADS = 4


def twin_sweeps(send, names) -> None:
    """Spawned: sends {name: (result, seconds)} of
    ``repro_torch.paper.<name>`` on the CPU (its reduced twin) for each of
    ``names``, streams serialized, through ``send`` (or the error's text):
    the measured half of phase 25's sweeps, ``twin_sections`` of phase
    26's."""
    import importlib
    import traceback
    import torch
    torch.set_num_threads(TWIN_THREADS)
    try:
        out = {}
        for name in names:
            mod = importlib.import_module(f"repro_torch.paper.{name}")
            t0 = time.perf_counter()
            res = (twin_sections(name) if name in SPEC_SHARD_SWEEPS else
                   mod.measured_section(
                       mod.parser().parse_args(["--device", "cpu"]),
                       overlap=False))
            out[name] = (res, time.perf_counter() - t0)
        send.send(("ok", out))
    except BaseException:
        send.send(("error", traceback.format_exc()))
    send.close()


def start_twins(groups):
    """The CPU twins of the sweeps of phases 25 and 26, one spawned,
    daemonic process (it ends with this one) for each tuple of sweep names
    in ``groups``, side by side, started before the kernels' build so that
    they run beside it and not beside a measurement. Returns [(process,
    receiving end)]."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    started = []
    for names in groups:
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=twin_sweeps, args=(send, names),
                           daemon=True)
        proc.start()
        send.close()
        started.append((proc, recv))
    return started


def join_twins(started) -> dict:
    """The twins' {name: (result, seconds)}, once their processes have
    ended (they are waited for before any phase that measures)."""
    t0 = time.perf_counter()
    out = {}
    for proc, recv in started:
        try:
            status, res = recv.recv()
        except EOFError:
            status, res = "error", "the process ended without a result"
        proc.join()
        check(status == "ok", f"the sweeps' CPU twins failed: {res}")
        out.update(res)
    log("sweeps' CPU twins beside the build: "
        + " ".join(f"{n} {s:.1f}s" for n, (_, s) in out.items())
        + f", waited {time.perf_counter() - t0:.1f}s after the build")
    return out


def tier_sweep_on_card(torch, kern, mod, sweep) -> dict:
    """One sweep module: its analytic half, and its measured half on the
    card (streams serialized, so that its page counters follow the
    requests) with every serve's launches recorded and checked."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.serving import ServeEngine
    args = mod.parser().parse_args([])
    analytic = mod.analytic_section(args)
    t0 = time.perf_counter()
    with count_plain(kern, flash) as plain, \
            serves_recorded(kern, ServeEngine) as runs:
        card = mod.measured_section(args, overlap=False)
    card_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    check(not plain, f"{sweep} sweep: plain versions called on the card: "
          f"{plain}")
    # each cell's engine serves twice after the baseline's two serves; the
    # tiers change the bookkeeping, not the schedule: every serve makes
    # exactly the baseline's launches
    check(len(runs) == 2 * (len(card["grid"]) + 1),
          f"{sweep} sweep: {len(runs)} serves recorded")
    base = runs[0]
    launches = dict.fromkeys(KERNELS, 0)
    for i, run in enumerate(runs):
        want = sweep_launches(run)
        check(run["launches"] == want == sweep_launches(base)
              and want["paged_decode_attention"] > 0
              and want["chunk_prefill_attention"] > 0,
              f"{sweep} sweep serve {i}: launches {run['launches']} != "
              f"{want} or != the baseline's {sweep_launches(base)}")
        for k, v in run["launches"].items():
            launches[k] += v
    return dict(analytic=analytic, card=card, launches=launches,
                serves=len(runs), card_s=card_s)


def tier_sweep_gates(mod, sweep, smi, res, twin, twin_s) -> dict:
    """Phase 25's gates on one sweep's card run ``res``
    (``tier_sweep_on_card``), its page counters held against ``twin``,
    the reduced twin's measured half with the same page size and tier
    sizes in pages on this machine's CPU."""
    analytic, card = res["analytic"], res["card"]
    check(twin["fast_pages"] == card["fast_pages"]
          and len(twin["grid"]) == len(card["grid"]),
          f"{sweep} sweep: the CPU twin's tiers differ from the card's")
    cells, d = card["grid"], card["derived"]
    for c, t in zip(cells, twin["grid"]):
        log(_tier_cell_line(sweep, c))
        check(c["counters"] == t["counters"], f"{sweep} sweep cell "
              f"{c['bw_gbps']:g}GB/s: counters {c['counters']} != the CPU "
              f"twin's {t['counters']}")
    check(d["all_token_identical"], f"{sweep} sweep: a cell's tokens differ "
          f"from the card's no-offload baseline")
    check(d["all_traces_reconciled"], f"{sweep} sweep: a trace did not "
          f"reconcile")
    generous = [c for c in cells if c["bw_gbps"] == mod.GENEROUS_GBPS]
    check(len(generous) == 1 and round(generous[0]["stall_ms"]) == 0,
          f"{sweep} sweep: the generous point stalled {generous}")
    if sweep == "hbs":
        check(d["stall_grows_as_bw_shrinks"], "hbs sweep: the stingiest "
              "cell's stall is not above the generous one's")
        env = analytic["min_bw_gbps_for_target"]
        log(f"tiers hbs analytic (llava15-13b, {analytic['context']} "
            f"positions): min HBS GB/s per ITL target " + json.dumps(env))
        by_bw = {}
        for c in cells:
            by_bw.setdefault(c["bw_gbps"], []).append(
                f"{c['latency_us']:g}us:{c['itl_p95_ms']:.2f}ms")
        log(f"tiers hbs card ITL p95 by bandwidth (GB/s at "
            f"{card['page_kb'] / 1e3:.2f} MB pages): "
            + "; ".join(f"{bw:g}: " + " ".join(v)
                        for bw, v in by_bw.items()))
    else:
        for c in cells:
            if c["policy"] == "overlap":
                check(c["stall_saved_s"] >= 0.0, f"chiplet sweep: an "
                      f"overlap cell stalled more than its barrier "
                      f"counterfactual: {c}")
            else:
                check(c["stall_saved_s"] == 0.0, f"chiplet sweep: a barrier "
                      f"cell saved stall: {c}")
            # the ddr->chiplet link's bytes over the page's bytes
            moved = c["counters"]["channel_pages"].get("ddr->chiplet", 0)
            if c["chiplet_pages"]:
                check(c["chiplet_promotions"] > 0
                      and moved == c["chiplet_promotions"],
                      f"chiplet sweep: promotions and ddr->chiplet bytes "
                      f"disagree: {c}")
        # the barrier run's stall follows the schedule (its fetches wait on
        # the stingy link, not on the step times): each overlap run on the
        # dedicated link stalls at most that
        for p in card["overlap_vs_barrier"]:
            check(p["overlap_stall_ms"] <= p["barrier_run_stall_ms"],
                  f"chiplet sweep: the overlap run stalled more than the "
                  f"barrier run: {p}")
        hit = d["hit_rate_by_chiplet_pages"]
        rates = [hit[k] for k in sorted(hit) if k]
        check(rates and rates[0] > 0 and rates == sorted(rates),
              f"chiplet sweep: the hit rate is 0 or does not grow with the "
              f"chiplet: {hit}")
        log(f"tiers chiplet analytic (llama3.2-1b, {analytic['context']} "
            f"positions): min HBS GB/s per ITL target by chiplet size "
            + json.dumps({k: v["min_bw_gbps_for_target"]
                          for k, v in analytic["by_chiplet_size"].items()}))
        log("tiers chiplet overlap vs barrier " + json.dumps(
            card["overlap_vs_barrier"]) + f" overlap_le_barrier_everywhere="
            f"{d['overlap_le_barrier_everywhere']} (the reference's 2 ms / "
            f"5% tolerance)")
    log(f"tiers {sweep} sweep on the card ({card['arch']}, {card['dtype']}, "
        f"{res['card_s']:.1f}s, {res['serves']} serves, bw_scale "
        f"{card['bw_scale']:g}): launches exact in every serve ("
        + " ".join(f"{k.split('_')[0]}={v}"
                   for k, v in res["launches"].items())
        + f"), no plain version, every cell token-identical to the "
        f"no-offload baseline, counters equal the CPU twin's in "
        f"{len(cells)} cells (CPU twin {twin_s:.1f}s, beside the build) "
        f"({smi})")
    return dict(res, twin=twin, twin_s=twin_s)


def tiers_phase(torch, kern, smi, twins) -> dict:
    """Phase 25: the paged decode and the chunk at the sweeps' shapes
    against their plain versions, then ``paper.hbs_sweep`` (llava15-13b's
    decoder, ``hbs_sweep.CARD_LAYERS`` layers, full width) and
    ``paper.chiplet_sweep`` (llama3.2-1b at full width and depth) on the
    card, each held against ``twins`` (``join_twins``: their reduced
    twins on this machine's CPU)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.paper import chiplet_sweep, hbs_sweep
    t0 = time.perf_counter()
    sweeps = {"hbs": hbs_sweep, "chiplet": chiplet_sweep}
    out = dict(kernel_rows=check_kernels(torch, kern, flash,
                                         tier_cases(torch, kern)))
    for sweep, mod in sweeps.items():
        out[sweep] = tier_sweep_gates(
            mod, sweep, smi, tier_sweep_on_card(torch, kern, mod, sweep),
            *twins[mod.__name__.rsplit(".", 1)[1]])
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 25 (HBS offload and the chiplet) {out['phase_s']:.1f}s")
    return out


# --------- phase 26: the paper's last two sweeps, spec and shard ---------- #

# spec_sweep's pool as the kernels see it: 4 slots of up to 168 positions
# (a 96-token document + 8, 64 new), pages of 16, chunks of 32 (the
# engine's default at pages of 16, and the model draft's), the
# scalar-start chunk at the third chunk of a 104-token prompt; the verify
# windows of one row and of k = 4, 8 and 12
SPEC_SLOTS, SPEC_MAX_LEN, SPEC_CHUNK, SPEC_START = 4, 168, 32, 64
SPEC_VERIFY_C = (1, 5, 9, 13)
# the model draft's width (heads, head_dim, kv heads): llama3.2-1b at half
# width with heads of 64; its catch-up passes feed one row a sequence
# when it accepts nothing
DRAFT_WIDTH = (16, 64, 16)
DRAFT_VERIFY_C = (1,)
# shard_sweep's pool: 3 slots of 40 positions (24 + 16 new), pages of 8,
# one chunk of 32 at 0 a prompt
SHARD_SWEEP_SLOTS, SHARD_SWEEP_MAX_LEN, SHARD_SWEEP_PS = 3, 40, 8
SHARD_SWEEP_CHUNK = 32
# the sweeps' shapes as ``paged_cases`` labels them (kernels line rows)
SPEC_POOL = f"slots={SPEC_SLOTS} max_len={SPEC_MAX_LEN}"
SPEC_MAIN = {
    ("paged_decode_attention", None):
        f"group=1 pool=bfloat16 {SPEC_POOL}",
    ("chunk_prefill_attention", None):
        f"group=1 pool=bfloat16 start=scalar {SPEC_POOL} C={SPEC_CHUNK}",
    **{("spec_verify_attention", c - 1):
       f"group=1 pool=bfloat16 C={c} {SPEC_POOL}" for c in (5, 9, 13)}}
DRAFT_TAG = f" heads={DRAFT_WIDTH[0]}"
DRAFT_MAIN = {
    "paged_decode_attention": f"group=1 pool=bfloat16 {SPEC_POOL}{DRAFT_TAG}",
    "chunk_prefill_attention": f"group=1 pool=bfloat16 start=scalar "
                               f"{SPEC_POOL}{DRAFT_TAG} C={SPEC_CHUNK}",
    "spec_verify_attention":
        f"group=1 pool=bfloat16 C=1 {SPEC_POOL}{DRAFT_TAG}"}
SHARD_SWEEP_POOL = (f"ps={SHARD_SWEEP_PS} slots={SHARD_SWEEP_SLOTS} "
                    f"max_len={SHARD_SWEEP_MAX_LEN}")
# the sweeps' twins: spec_sweep's sections, and shard_sweep's cells at one
# shard (the twins' process is daemonic: it cannot spawn ranks)
SPEC_SHARD_SWEEPS = ("spec_sweep", "shard_sweep")


def sweep_cases(torch, kern):
    """The paged entries in bf16 at phase 26's pools: spec_sweep's at
    llama3.2-1b's width (decode, the chunk, the windows of
    ``SPEC_VERIFY_C``) and at its model draft's (``DRAFT_WIDTH``: decode,
    the chunk and the one-row catch-up window); shard_sweep's at a shard's
    heads of 2 and of 4 (decode and the chunk, split as the whole pool of
    32 KV heads)."""
    for (H, DH, Hkv), verify_c, tag in (
            (LLAMA_WIDTH, SPEC_VERIFY_C, ""),
            (DRAFT_WIDTH, DRAFT_VERIFY_C, DRAFT_TAG)):
        yield from paged_cases(torch, kern, H, DH, Hkv, pools=("bfloat16",),
                               verify_c=verify_c, chunk_edges=False,
                               slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
                               chunk_len=SPEC_CHUNK, scalar_start=SPEC_START,
                               main_only=True, tag=tag)
    H, DH, Hkv = LLAMA_WIDTH
    for n in (2, 4):
        yield from paged_cases(torch, kern, H // n, DH, Hkv // n,
                               pools=("bfloat16",), verify_c=(),
                               chunk_edges=False, split_kv_heads=Hkv,
                               ps=SHARD_SWEEP_PS, slots=SHARD_SWEEP_SLOTS,
                               max_len=SHARD_SWEEP_MAX_LEN,
                               chunk_len=SHARD_SWEEP_CHUNK, scalar_start=0,
                               main_only=True)


def sweep_serve_launches(run) -> dict:
    """The launches one serve of phase 26 must make, by (entry, KV heads):
    the target n_layers paged decodes a decode micro-step that is not a
    verify pass, n_layers chunks a prefill chunk and n_layers verify
    windows a verify pass, at its pool's heads (Hkv/N on a shard); a
    model draft one paged decode a micro-step of its own, one chunk a
    prefill chunk and one verify window a catch-up pass, at its 1 layer
    and its heads."""
    L, h = run["layers"], run["kv_heads"]
    want = {("paged_decode_attention", h): L * (run["steps"] - run["blocks"]),
            ("chunk_prefill_attention", h): L * run["chunks"],
            ("spec_verify_attention", h): L * run["blocks"]}
    if run["draft_kv_heads"] is not None:
        d, hd = run["draft"], run["draft_kv_heads"]
        for name, key in (("paged_decode_attention", "steps"),
                          ("chunk_prefill_attention", "chunks"),
                          ("spec_verify_attention", "catchups")):
            want[name, hd] = want.get((name, hd), 0) + d.get(key, 0)
    return {k: v for k, v in want.items() if v}


def need(fails, ok: bool, msg: str) -> None:
    """A gate of phase 26, kept in ``fails`` so that the phase prints all
    it measured before it fails (``sweeps_phase`` raises on any)."""
    if not ok:
        fails.append(msg)


def check_sweep_serves(label, runs, fails) -> dict:
    """Each recorded serve: its launches exact by entry and by heads, its
    trace reconciled and its pages freed (a miss goes to ``fails``).
    Returns the launches by (entry, KV heads), summed."""
    total = {}
    for i, run in enumerate(runs):
        want = sweep_serve_launches(run)
        by_entry = dict.fromkeys(KERNELS, 0)
        for (name, _), n in want.items():
            by_entry[name] += n
        need(fails, run["by_heads"] == want and run["launches"] == by_entry,
             f"{label} serve {i} ({run['spec_mode']}, k={run['spec_k']}): "
             f"launches {run['launches']} by heads {run['by_heads']} != "
             f"{want}")
        need(fails, want.get(("paged_decode_attention", run["kv_heads"]), 0) > 0
             or run["blocks"] > 0, f"{label} serve {i}: no decode ran")
        need(fails, run["ok"], f"{label} serve {i}: the trace did not reconcile")
        need(fails, run["pages_left"] == 0, f"{label} serve {i}: "
             f"{run['pages_left']} pages left")
        for k, v in want.items():
            total[k] = total.get(k, 0) + v
    return total


def twin_sections(name) -> dict:
    """One sweep of phase 26 on this machine's CPU at its reduced twin,
    streams serialized: spec_sweep's n-gram and spec x HBS sections (the
    model draft's counters follow its own weights, so the card's are not
    held to a twin's), shard_sweep's cells at one shard."""
    import importlib
    mod = importlib.import_module(f"repro_torch.paper.{name}")
    args = mod.parser().parse_args(["--device", "cpu"])
    if name == "spec_sweep":
        ngram = mod.ngram_section(args, overlap=False)
        return dict(ngram=ngram, spec_x_hbs=mod.spec_x_hbs_section(
            args, overlap=False, want=ngram["baseline_outputs"]))
    return dict(overlap=mod.overlap_section(args, overlap=False),
                mesh=mod.mesh_section(args, overlap=False, shard_counts=(1,)),
                capacity=mod.capacity_section(args, overlap=False,
                                              shard_counts=(1,)))


def _differ(label, got, want, out):
    """Append ``label`` to ``out`` where ``got`` != ``want``."""
    if got != want:
        out.append(f"{label}: card {got} != CPU twin {want}")


def spec_token_free(counters) -> dict:
    """The counters of a speculative serve that no token moves: its
    preemptions, its peak fast-tier pages and the host syncs besides the
    one pull a verify pass takes."""
    return dict(preemptions=counters["preemptions"],
                peak_fast_pages=counters["peak_fast_pages"],
                syncs_besides_passes=(counters["host_syncs"]
                                      - counters["spec_blocks"]))


def _spec_cell_line(label, c) -> str:
    g = c["goodput"]
    return (f"spec {label}: tokens/s={c['tps']:.1f} itl p50/p95="
            f"{c['itl_p50_ms']:.2f}/{c['itl_p95_ms']:.2f}ms accept="
            f"{c['acceptance_rate']:.3f} ({c['counters']['draft_accepted']}/"
            f"{c['counters']['draft_proposed']}, {c['counters']['spec_blocks']}"
            f" passes) stall={c.get('stall_ms', 0.0):.3f}ms fetch="
            f"{c.get('fetch_mb', 0.0):.2f}MB decode_steps="
            f"{c['counters']['decode_steps']} host_syncs="
            f"{c['counters']['host_syncs']} goodput={g['goodput_frac']:.2f}"
            f" breakdown_ms=" + json.dumps(
                {k: round(v, 2) for k, v in c["breakdown_ms"].items()}))


def spec_sweep_on_card(torch, kern, smi, twin, twin_s, fails) -> dict:
    """``paper.spec_sweep`` on the card (llama3.2-1b at full width,
    ``spec_sweep.CARD_LAYERS`` layers, bf16; its model draft at half
    width, 1 layer) with streams serialized: every serve's launches exact
    (the draft's apart, at its heads) and no plain version; every n-gram
    cell, the model draft and each spec x HBS cell token-identical to the
    spec-off baseline; the model draft has a proposal rejected; the
    generous point stalls 0 ms, and in each mode the stingiest point
    stalls more and stall does not shrink with the bandwidth; the
    counters that no token moves equal the CPU twin's (``twin``)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import init_params
    from repro_torch.paper import spec_sweep as spec
    from repro_torch.serving import ServeEngine
    args = spec.parser().parse_args([])
    cfg, opts = spec.measured_model(args)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, opts.dtype, "cuda")
    with count_plain(kern, flash) as plain, \
            serves_recorded(kern, ServeEngine) as runs:
        ngram = spec.ngram_section(args, params, overlap=False)
        draft = spec.model_draft_section(args, params, overlap=False)
        hbs = spec.spec_x_hbs_section(args, params, overlap=False,
                                      want=ngram["baseline_outputs"])
    card_s = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    need(fails, not plain, f"spec sweep: plain versions called on the card: "
         f"{plain}")
    # ngram: the baseline and each k twice; model draft: the baseline and
    # the draft twice; spec x HBS: each cell's off and n-gram twice
    n_serves = 2 * (1 + len(ngram["sweep"]) + 2 + 2 * len(hbs["grid"]))
    need(fails, len(runs) == n_serves, f"spec sweep: {len(runs)} serves recorded, "
         f"not {n_serves}")
    launches = check_sweep_serves("spec sweep", runs, fails)
    by_k = {}
    for run in runs:
        if run["blocks"]:
            key = ("spec_verify_attention", run["kv_heads"])
            by_k[run["spec_k"]] = (by_k.get(run["spec_k"], 0)
                                   + run["by_heads"].get(key, 0))
    dcfg = spec.draft_config(cfg, args)
    # token identity, traces, pages
    need(fails, ngram["derived"]["all_token_identical"],
         "spec sweep: an n-gram cell's tokens differ from spec-off's")
    need(fails, draft["token_identical"], "spec sweep: the model draft's tokens "
         "differ from spec-off's")
    cells = [(f"x hbs {c['bw_gbps']:g}GB/s {m}", c[m]) for c in hbs["grid"]
             for m in ("off", "ngram")]
    for label, c in cells:
        need(fails, c["token_identical"], f"spec sweep {label}: tokens differ "
             f"from the spec-off baseline without tiers")
    # the draft's untied head proposes other tokens than the target's
    # repeats (spec_sweep.draft_config), so the reject, rollback and
    # catch-up path runs: some proposal must be rejected
    need(fails, 0 <= draft["draft_accepted"] < draft["draft_proposed"],
         f"spec sweep: the model draft accepted {draft['draft_accepted']} "
         f"of {draft['draft_proposed']}: no proposal was rejected")
    generous = hbs["grid"][-1]
    need(fails, generous["bw_gbps"] == spec.GENEROUS_GBPS
         and all(round(generous[m]["stall_ms"]) == 0
                  for m in ("off", "ngram")),
         f"spec sweep: the generous point stalled {generous}")
    # the stingy cells stall more than the generous one, in each mode, and
    # stall never shrinks as the bandwidth drops
    for m in ("off", "ngram"):
        stalls = [c[m]["stall_ms"] for c in hbs["grid"]]
        need(fails, stalls[0] > stalls[-1],
             f"spec sweep: the {m} cells' stingiest stall does not exceed "
             f"the generous one's: {stalls}")
        need(fails, stalls == sorted(stalls, reverse=True),
             f"spec sweep: the {m} cells' stall does not shrink as the "
             f"bandwidth grows: {stalls}")
    # the counters against the CPU twin's: every counter of a spec-off
    # cell (its schedule follows the requests alone); of an n-gram cell
    # the ones no token moves (its proposals follow the tokens, which
    # follow the weights: the card's model and the twin accept at other
    # rates), SPEC_TOKEN_FREE; the model draft's follow its own weights
    # too: only its bounds are held above
    differ = []
    _differ("baseline", ngram["baseline"]["counters"],
            twin["ngram"]["baseline"]["counters"], differ)
    for r, t in zip(ngram["sweep"], twin["ngram"]["sweep"]):
        _differ(f"n-gram k={r['k']}", spec_token_free(r["counters"]),
                spec_token_free(t["counters"]), differ)
    for c, t in zip(hbs["grid"], twin["spec_x_hbs"]["grid"]):
        _differ(f"x hbs {c['bw_gbps']:g}GB/s off", c["off"]["counters"],
                t["off"]["counters"], differ)
        _differ(f"x hbs {c['bw_gbps']:g}GB/s ngram",
                spec_token_free(c["ngram"]["counters"]),
                spec_token_free(t["ngram"]["counters"]), differ)
    need(fails, hbs["fast_pages"] == twin["spec_x_hbs"]["fast_pages"]
         and len(hbs["grid"]) == len(twin["spec_x_hbs"]["grid"]),
         "spec sweep: the CPU twin's tiers differ from the card's")
    log(_spec_cell_line("spec-off baseline", dict(
        ngram["baseline"], tps=ngram["baseline_tps"], acceptance_rate=0.0,
        goodput={"goodput_frac": float("nan")}, breakdown_ms={})))
    for r, t in zip(ngram["sweep"], twin["ngram"]["sweep"]):
        log(_spec_cell_line(f"n-gram k={r['k']}", r)
            + f" speedup={r['speedup']:.3f} (the twin accepts "
            f"{t['draft_accepted']}/{t['draft_proposed']} in "
            f"{t['spec_blocks']} passes)")
    log(_spec_cell_line(f"model draft k={draft['k']} ({dcfg.d_model} wide, "
                        f"{dcfg.n_heads} heads of {dcfg.head_dim}, 1 layer)",
                        dict(draft, goodput={"goodput_frac": float("nan")},
                             breakdown_ms={}))
        + f" speedup={draft['speedup']:.3f}")
    twin_cells = [t[m] for t in twin["spec_x_hbs"]["grid"]
                  for m in ("off", "ngram")]
    for (label, c), t in zip(cells, twin_cells):
        log(_spec_cell_line(label, c) + f" (the twin's stall "
            f"{t['stall_ms']:.3f}ms)")
    stingy, t_stingy = hbs["grid"][0], twin["spec_x_hbs"]["grid"][0]
    log(f"spec x hbs at the stingiest {stingy['bw_gbps']:g} GB/s: spec-off "
        f"stalls {stingy['off']['stall_ms']:.3f} ms, n-gram "
        f"{stingy['ngram']['stall_ms']:.3f} ms (the twin's "
        f"{t_stingy['off']['stall_ms']:.3f} and "
        f"{t_stingy['ngram']['stall_ms']:.3f} ms)")
    log(f"spec sweep derived: speedup_ge_1_2x="
        f"{ngram['derived']['speedup_ge_1_2x']} (best "
        f"{ngram['derived']['best_speedup']} at k="
        f"{ngram['derived']['best_k']}; recorded, not asserted: it compares "
        f"the wall times of two runs, and host time moves by up to 2.5x "
        f"between runs); weights {spec.WEIGHTS}")
    log(f"spec sweep on the card ({ngram['arch']}, {ngram['n_layers']} "
        f"layers, {ngram['dtype']}, {card_s:.1f}s, {len(runs)} serves, "
        f"bw_scale {hbs['bw_scale']:g}, fast tier {hbs['fast_pages']} "
        f"pages): launches exact in every serve by heads ("
        + " ".join(f"{k.split('_')[0]}@{h}={v}"
                   for (k, h), v in sorted(launches.items()))
        + f"), no plain version, every cell token-identical to spec-off; "
        f"counters vs the CPU twin ({twin_s:.1f}s beside the build): "
        + ("equal in every cell" if not differ else
           f"{len(differ)} cells differ") + f" ({smi})")
    for line in differ:
        log(f"spec sweep counters {line}")
    return dict(ngram=ngram, model_draft=draft, spec_x_hbs=hbs,
                n_layers=cfg.n_layers,
                launches={f"{k}@{h}": v for (k, h), v in launches.items()},
                verify_by_k=by_k, serves=len(runs), card_s=card_s,
                draft_width=dict(d_model=dcfg.d_model, n_heads=dcfg.n_heads,
                                 n_kv_heads=dcfg.n_kv_heads),
                counters_differ=differ, twin=twin, twin_s=twin_s)


def sweep_rank(rank, args, shards, names, params, overlap):
    """One rank of phase 26's shard_sweep cells (on phase 17's ranks):
    ``shard_sweep.rank_cells`` with every serve's launches
    recorded and checked (exact, at its pool's Hkv/N heads), no plain
    version, and each serve's trace reconciled and its pages freed."""
    import torch
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.paper import shard_sweep
    from repro_torch.serving import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    with count_plain(kern, flash) as plain, \
            serves_recorded(kern, ServeEngine) as runs:
        out = shard_sweep.rank_cells(rank, args, shards, names, params,
                                     overlap)
    label = f"shard sweep rank {rank}/{shards}"
    check(not plain, f"{label}: plain versions called: {plain}")
    n_kv = shard_sweep.measured_model(args)[0].n_kv_heads // shards
    check(len(runs) == 2 * len(names)
          and all(run["kv_heads"] == n_kv for run in runs),
          f"{label}: {len(runs)} serves, pools of "
          f"{sorted({run['kv_heads'] for run in runs})} KV heads, not {n_kv}")
    fails = []
    out["launches"] = {f"{k}@{h}": v for (k, h), v in
                       check_sweep_serves(label, runs, fails).items()}
    check(not fails, "; ".join(fails))
    return out


def shard_sweep_on_card(torch, kern, smi, twin, twin_s, fails,
                        groups) -> dict:
    """``paper.shard_sweep`` on the card (llama3.2-1b at full width,
    ``shard_sweep.CARD_LAYERS`` layers, bf16): ``groups``, its rank cells
    at 2 and 4 shards as phase 17's ranks served them (``sweep_rank``),
    then its overlap, mesh and capacity sections here, held to the card's
    shards=1 serve with streams serialized; every serve's launches exact,
    no plain version; the counters of the one-shard cells equal the CPU
    twin's (``twin``)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.paper import shard_sweep as shard
    from repro_torch.serving import ServeEngine
    args = shard.parser().parse_args([])
    cfg, opts = shard.measured_model(args)
    reqs = shard._workload(cfg, args)
    t0 = time.perf_counter()
    with count_plain(kern, flash) as plain, \
            serves_recorded(kern, ServeEngine) as runs:
        base, want = shard._run(cfg, None, opts, reqs, args, overlap=False)
        params = base.params
        over = shard.overlap_section(args, params, want=want)
        mesh = shard.mesh_section(args, params, overlap=False, want=want,
                                  groups=groups)
        cap = shard.capacity_section(args, params, overlap=False,
                                     groups=groups)
    card_s = time.perf_counter() - t0
    del base, params
    gc.collect()
    torch.cuda.empty_cache()
    need(fails, not plain, f"shard sweep: plain versions called on the card: "
         f"{plain}")
    launches = check_sweep_serves("shard sweep", runs, fails)
    for n, ranks in groups.items():
        for r, res in enumerate(ranks):
            for name in shard.GROUP_CELLS[n]:
                c = res[name]
                need(fails, c["backend"] == ("nccl" if torch.cuda.device_count()
                                       >= n else "gloo"),
                     f"shard sweep: rank {r}/{n} backend {c['backend']}")
                need(fails, c["cell"]["trace_reconciled"]
                     and c["cell"]["pages_left"] == 0,
                     f"shard sweep: rank {r}/{n} {name}: trace or pages")
    need(fails, over["token_identical"], "shard sweep: an overlap run's tokens "
         "differ from the shards=1 serve's")
    cells = mesh["cells"]
    need(fails, mesh["shard_counts"] == [1, 2, 4] and mesh["all_token_identical"],
         f"shard sweep: a mesh cell's tokens differ from shards=1's on some "
         f"rank: {[(k, c['token_identical']) for k, c in cells.items()]}")
    for n in (2, 4):
        need(fails, cells[f"mesh{n}"]["pool_bytes"] * n
             == cells["mesh1"]["pool_bytes"],
             f"shard sweep: a rank at N={n} holds "
             f"{cells[f'mesh{n}']['pool_bytes']} pool bytes, not 1/{n} of "
             f"{cells['mesh1']['pool_bytes']}")
    pb = shard._page_nbytes(cfg, opts, args)
    need(fails, cap["single_device_rejects"], "shard sweep: the single device did "
         "not reject the long request across all its tiers")
    need(fails, cap["mesh4_serves_token_identical"], "shard sweep: four shards "
         "did not serve the long request token-identically")
    need(fails, cap["n1"]["preemptions"] > 0 and cap["n4"]["preemptions"] == 0
         and cap["n1"]["token_identical"] and cap["n4"]["token_identical"],
         f"shard sweep: serialized, N=1 must preempt and N=4 not, both "
         f"token-identical: {cap['n1']} {cap['n4']}")
    differ = []
    _differ("overlap serialized", over["serialized"]["counters"],
            twin["overlap"]["serialized"]["counters"], differ)
    _differ("mesh1", cells["mesh1"]["counters"],
            twin["mesh"]["cells"]["mesh1"]["counters"], differ)
    _differ("capacity n1", cap["n1"]["counters"],
            twin["capacity"]["n1"]["counters"], differ)
    _differ("capacity single_device_rejects", cap["single_device_rejects"],
            twin["capacity"]["single_device_rejects"], differ)
    o, s = over["overlapped"], over["serialized"]
    log(f"shard overlap: overlapped serve_ms={o['serve_ms']:.3f} "
        f"tokens/s={o['tps']:.1f}, serialized serve_ms={s['serve_ms']:.3f} "
        f"tokens/s={s['tps']:.1f}, speedup {over['speedup']:.3f}; "
        f"overlap_beats_serialized={over['overlap_beats_serialized']} "
        f"(recorded, not asserted: it compares the wall times of two runs, "
        f"and host time moves by up to 2.5x between runs)")
    for key, c in cells.items():
        log(f"shard {key}: tokens/s={c['tps']:.1f} serve_ms="
            f"{c['serve_ms']:.3f} decode_ms={c['decode_ms']:.3f} pool="
            f"{c['pool_bytes']}B a rank, decode_steps="
            f"{c['counters']['decode_steps']} host_syncs="
            f"{c['counters']['host_syncs']} token_identical="
            f"{c['token_identical']}")
    log("shard analytic (llava15-13b, 4 x 4,096 + 256): "
        + json.dumps(mesh["analytic_13b_per_chip"]))
    log(f"shard capacity: single device rejects={cap['single_device_rejects']}"
        f", N=4 serves the long request token-identically (peak fast pages "
        f"{cap['mesh4_peak_fast_pages']}, a page {pb // 4} B a rank of "
        f"{pb}); the mix preempts {cap['n1']['preemptions']}x at N=1 (peak "
        f"fast pages {cap['n1']['peak_fast_pages']}) and "
        f"{cap['n4']['preemptions']}x at N=4 ({cap['n4']['peak_fast_pages']})")
    log(f"shard sweep on the card ({cfg.name}, {opts.dtype}, {card_s:.1f}s, "
        f"the rank cells on phase 17's ranks, {len(runs)} serves here): "
        f"launches exact in every serve by heads ("
        + " ".join(f"{k.split('_')[0]}@{h}={v}"
                   for (k, h), v in sorted(launches.items()))
        + "; rank 0 of 2: " + " ".join(
            f"{k.split('_')[0]}={v}"
            for k, v in groups[2][0]["launches"].items())
        + "; rank 0 of 4: " + " ".join(
            f"{k.split('_')[0]}={v}"
            for k, v in groups[4][0]["launches"].items())
        + f"), no plain version; counters vs the CPU twin ({twin_s:.1f}s "
        f"beside the build): "
        + ("equal in every one-shard cell" if not differ else
           f"{len(differ)} differ") + f" ({smi})")
    for line in differ:
        log(f"shard sweep counters {line}")
    return dict(overlap=over, mesh=mesh, capacity=cap,
                launches={f"{k}@{h}": v for (k, h), v in launches.items()},
                rank_launches={n: [r["launches"] for r in ranks]
                               for n, ranks in groups.items()},
                serves=len(runs), card_s=card_s,
                page_bytes=pb, counters_differ=differ, twin=twin,
                twin_s=twin_s)


def sweeps_phase(torch, kern, smi, twins, groups) -> dict:
    """Phase 26: the paged entries at the sweeps' pools against their plain
    versions (``sweep_cases``), then ``paper.spec_sweep`` and
    ``paper.shard_sweep`` on the card, each held against ``twins``
    (``join_twins``: their reduced twins on this machine's CPU);
    ``groups``: shard_sweep's rank cells, served on phase 17's ranks
    (``serve_sharded``)."""
    from repro_torch.kernels import flash_attention as flash
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(kernel_rows=check_kernels(torch, kern, flash,
                                         sweep_cases(torch, kern)))
    out["kernels_s"] = time.perf_counter() - t0
    fails = []
    out["spec"] = spec_sweep_on_card(torch, kern, smi, *twins["spec_sweep"],
                                     fails)
    out["shard"] = shard_sweep_on_card(torch, kern, smi,
                                       *twins["shard_sweep"], fails, groups)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 26 (spec_sweep and shard_sweep) {out['phase_s']:.1f}s "
        f"(kernel cases {out['kernels_s']:.1f}s)")
    differ = out["spec"]["counters_differ"] + out["shard"]["counters_differ"]
    if differ:
        fails.append(f"{len(differ)} cells' counters differ from the CPU "
                     f"twins': {differ}")
    check(not fails, "phase 26: " + "; ".join(fails))
    return out


# ------------- phase 28: the serving blocks as CUDA graphs ------------- #

# phase 4's runs that phase 28 serves again (label -> engine options; the
# sampled run also serialized the streams in phase 4) and the kernels each
# must launch
GRAPH_RUNS = {"native": (dict(kv_policy="native"), PAGED[:2]),
              "int8": (dict(kv_policy="int8"), PAGED[:2]),
              "ngram": (dict(spec_mode="ngram", spec_k=4), PAGED[1:]),
              "sampled-0": (dict(spec_mode="ngram", spec_k=4,
                                 temperature=0.8, top_k=50, top_p=0.9,
                                 sample_seed=7), PAGED[1:])}
# what a capture must leave exactly as the eager blocks make it
GRAPH_COUNTERS = ("host_syncs", "decode_steps", "decode_compiles",
                  "prefill_compiles", "launches")
# phase 4's requests that (a) serves: all 16 (8 is the one cut allowed
# should the script outgrow its time)
GRAPH_REQS = 16


def same_up_to_ties(torch, tm, cfg, params, reqs, got, want, label) -> int:
    """``got`` equals ``want`` request by request, but for a divergence
    after a near tie (phase 6's rule: a spec-off top-2 logit gap below
    1e-4 at the first differing token or before it). Returns the number
    of requests that differ."""
    opts = tm.RuntimeOptions(dtype="bfloat16")
    n = 0
    for prompt, g, w in zip(reqs, got, want):
        if g != w:
            k = tie_free_prefix(torch, tm, cfg, params, opts, prompt, w)
            check(k < len(w) and g[:k] == w[:k],
                  f"{label}: tokens diverge before any near tie: {g} vs {w}")
            n += 1
    return n


def graphs_against_eager(torch, kern, tm, ServeEngine, cfg, params,
                         phase4) -> dict:
    """(a): each of ``GRAPH_RUNS`` served eagerly (``graphs=False``) and
    captured, both with the streams serialized (with overlap on, which
    requests join a decode block follows measured wall times, which the
    capture changes by design); tokens, ``GRAPH_COUNTERS`` and the launch
    counts equal, captures = compiles, the captured native engine's second
    serve captures nothing; every run's tokens also equal those of phase
    4's captured run (``phase4``) up to a near tie."""
    reqs = requests(cfg.vocab)[:GRAPH_REQS]
    out = {}
    for label, (kw, need) in GRAPH_RUNS.items():
        sides = {}
        for side, graphs in (("eager", False), ("captured", None)):
            eng, outs, row = serve_run(
                torch, kern, ServeEngine, tm.RuntimeOptions, cfg, params,
                reqs, f"{label} {side}", need, graphs=graphs, overlap=False,
                **kw)
            check((eng.graphs is None) == (side == "eager"),
                  f"{label} {side}: the engine's graphs are "
                  f"{eng.graphs!r}")
            sides[side] = (eng, outs, row)
        (_, want, erow), (ceng, got, crow) = sides["eager"], sides["captured"]
        for row in (crow, phase4[label]):
            check(row["captures"] == row["decode_compiles"]
                  + row["prefill_compiles"],
                  f"{label}: {row['captures']} captures for "
                  f"{row['decode_compiles']} + {row['prefill_compiles']} "
                  f"compiles")
        differ = {c: (crow[c], erow[c]) for c in GRAPH_COUNTERS
                  if crow[c] != erow[c]}
        check(not differ, f"{label}: captured != eager in {differ}")
        ties = same_up_to_ties(torch, tm, cfg, params, reqs, got, want,
                               f"{label} captured vs eager")
        ties4 = same_up_to_ties(torch, tm, cfg, params, reqs,
                                phase4[label]["outputs"][:len(reqs)], want,
                                f"{label} phase 4 vs eager")
        again = None
        if label == "native":
            n = ceng.graphs.captures
            again = ceng.serve([r[:] for r in reqs], 64)
            check(again == got and ceng.graphs.captures == n,
                  f"native: a second serve on the captured engine captured "
                  f"{ceng.graphs.captures - n} blocks or changed its tokens")
        out[label] = dict(
            eager=erow, captured=crow, ties=ties, ties_phase4=ties4,
            second_serve_captures=(None if again is None
                                   else ceng.graphs.captures - n))
        log(f"graphs {label}: captured == eager in tokens ({ties} requests "
            f"differ after a near tie; {ties4} against phase 4's captured "
            f"run) and " + ", ".join(f"{c}={crow[c]}" for c in
                                     GRAPH_COUNTERS[:-1])
            + f", launches; captures {crow['captures']} = compiles "
            f"({crow['capture_s']:.2f}s), graphs' memory "
            f"{crow['graph_bytes'] / 2**20:.1f} MiB; tokens/s "
            f"{erow['tokens_per_s']:.1f} -> {crow['tokens_per_s']:.1f}, "
            f"wall {erow['wall_s']:.2f} -> {crow['wall_s']:.2f}s"
            + ("" if again is None else "; a second serve captured 0"))
        del sides, ceng, eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _decode_inputs(B, K, n_pp, lens):
    import numpy as np
    return dict(tokens=np.arange(1, B + 1, dtype=np.int32),
                seq_lens=np.full((B,), lens, np.int32),
                tables=np.arange(1, B * n_pp + 1, dtype=np.int32)
                .reshape(B, n_pp),
                done=np.zeros((B,), bool), quota=np.full((B,), K, np.int32))


def replays_bitwise(torch, tm, cfg, params) -> dict:
    """(b): one K=8 decode block over 8 slots of 300 cached tokens (a pool
    of seeded random pages): its eager run and two replays of its graph,
    each from the same pool state, give the same tokens and pool bitwise."""
    from repro_torch.serving.graphs import BlockGraphs
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, K = 8, 8
    n_pp = -(-MAX_LEN // PS)
    pool = tm.init_paged_cache(cfg, B * n_pp + 1, PS, opts, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(28)
    for t in pool["stack"].values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    start = {n: t.clone() for n, t in pool["stack"].items()}
    inputs = _decode_inputs(B, K, n_pp, 300)

    def block(tokens, seq_lens, tables, done, quota):
        return tm.decode_steps_paged(cfg, params, tokens, seq_lens, tables,
                                     pool, K, opts, done=done,
                                     quota=quota)[0]
    runner = BlockGraphs("cuda")
    runs = []
    for _ in range(3):
        for n, t in pool["stack"].items():
            t.copy_(start[n])
        toks = runner.run("decode", block, **inputs).clone()
        torch.cuda.synchronize()
        runs.append((toks, {n: t.clone() for n, t in pool["stack"].items()}))
        runner.capture_pending()
    check(runner.captures == 1, f"{runner.captures} captures of one key")
    for i, (toks, rows) in enumerate(runs[1:], 1):
        check(torch.equal(toks, runs[0][0]),
              f"replay {i}'s tokens differ from the eager block's")
        for n, t in rows.items():
            check(torch.equal(t, runs[0][1][n]),
                  f"replay {i}'s pool {n} differs from the eager block's")
    log(f"graphs: the K={K} decode block (B={B}, 300 cached) replayed twice "
        f"== its eager run bitwise (tokens and the whole pool)")
    del runs, start, pool
    return dict(tokens_equal=True, pool_equal=True, replays=2)


def graph_blocks(torch, tm, cfg, params) -> dict:
    """(c): PERF.md's three llama blocks, the K=8 decode over 8 slots x 300
    cached tokens, the prefill chunk B=1, C=64 at start 384 and the verify
    pass B=8, C=5 over 300, each eager (inputs uploaded as the engine
    does) and captured (copied into the graph's buffers, then replayed):
    wall ms (median of 5), device busy ms (torch.profiler, which records
    a replay's kernels), busy share of the wall, seconds of the one
    capture and the graph's memory. The launches the runner adds for one
    replay must equal the eager block's, and the profiler must see each
    attention kernel the eager block ran that count of times in one
    replay (its pass 1, and its combine where it splits)."""
    import numpy as np
    opts = tm.RuntimeOptions(dtype="bfloat16")
    n_pp = -(-MAX_LEN // PS)
    B, K, Cv = 8, 8, 5
    pool = tm.init_paged_cache(cfg, B * n_pp + 1, PS, opts, "cuda")
    one = tm.init_paged_cache(cfg, n_pp + 1, PS, opts, "cuda")
    dec = _decode_inputs(B, K, n_pp, 300)

    def decode(tokens, seq_lens, tables, done, quota):
        return tm.decode_steps_paged(cfg, params, tokens, seq_lens, tables,
                                     pool, K, opts, done=done,
                                     quota=quota)[0]

    def chunk(tokens, table, start, n_valid):
        return tm.prefill_paged_chunk(cfg, params, tokens, one, table, start,
                                      n_valid, opts)[0]

    def verify(tokens, draft_len, seq_lens, tables):
        out, n_acc, _ = tm.spec_decode_verify(
            cfg, params, tokens, draft_len, seq_lens, tables, pool,
            opts=opts)
        return torch.cat([out, n_acc[:, None]], dim=1)
    blocks = {
        f"decode block K={K} B={B} len=300": (decode, dec, False),
        f"prefill chunk B=1 C={C} start=384": (chunk, dict(
            tokens=np.arange(1, C + 1, dtype=np.int32)[None],
            table=np.arange(1, n_pp + 1, dtype=np.int32)[None],
            start=np.asarray([384], np.int32),
            n_valid=np.asarray([384 + C], np.int32)), True),
        f"verify pass B={B} C={Cv} len=300": (verify, dict(
            tokens=np.arange(1, B * Cv + 1, dtype=np.int32).reshape(B, Cv),
            draft_len=np.full((B,), Cv - 1, np.int32),
            seq_lens=dec["seq_lens"], tables=dec["tables"]), True)}
    out = {label: block_row(torch, label, fn, inputs, pass2)
           for label, (fn, inputs, pass2) in blocks.items()}
    del pool, one
    return out


def block_row(torch, label, fn, inputs, pass2=False) -> dict:
    """One block ``fn(**inputs)`` eager (inputs uploaded as the engine
    does) and captured (copied into the graph's buffers, then replayed),
    each under ``profile_block``; the launches one replay adds to the
    counters must equal the eager block's, the replay must run the
    attention kernels the eager block ran, and the profiler must see
    each of them that count of times in the replay (a launch makes one of
    each: its pass 1, and its combine where it splits). The eager block's
    own profile is not held to a count: its window holds thousands of
    host-launched kernels, and torch.profiler has been seen to lose a
    couple of their records there (574 of 576 kernels in one run of the
    qwen block, 576 in others on the same tree)."""
    from repro_torch.serving.graphs import BlockGraphs

    def eager():
        fn(**{n: torch.as_tensor(v, device="cuda")
              for n, v in inputs.items()})
        torch.cuda.synchronize()
    zero_counts()
    eager()
    launched = {n: k for n, k in read_counts().items() if k}
    check(len(launched) == 1,
          f"{label}: launches {launched}, not one kernel entry")
    entry, = launched
    e = profile_block(torch, eager, f"{label} eager", chunk_pass2=pass2)
    runner = BlockGraphs("cuda")
    runner.run(label, fn, **inputs)
    torch.cuda.synchronize()
    runner.capture_pending()

    def replay():
        runner.run(label, fn, **inputs)
        torch.cuda.synchronize()
    # the count the runner adds for one replay, held against the kernels
    # the profiler sees that replay launch
    zero_counts()
    replay()
    added = {n: k for n, k in read_counts().items() if k}
    check(added == launched, f"{label}: a replay adds {added}, the eager "
          f"block launched {launched}")
    c = profile_block(torch, replay, f"{label} captured", chunk_pass2=pass2)
    per_name = {n: k["launches"] for n, k in c["attention_kernels"].items()}
    check(set(per_name) == set(e["attention_kernels"]),
          f"{label}: one replay ran the attention kernels {sorted(per_name)}"
          f", the eager block {sorted(e['attention_kernels'])}")
    check(all(k == added[entry] for k in per_name.values()),
          f"{label}: the profiler saw {per_name} in one replay, the runner "
          f"counts {added[entry]} launches of {entry}")
    per_launch = len(per_name)      # pass 1, and a combine if split
    replayed = sum(per_name.values())
    row = dict(eager_wall_ms=e["wall_ms"], eager_busy_ms=e["device_busy_ms"],
               eager_busy_share=e["busy_share"],
               captured_wall_ms=c["wall_ms"],
               captured_busy_ms=c["device_busy_ms"],
               captured_busy_share=c["busy_share"],
               capture_s=runner.capture_s, graph_bytes=runner.memory_bytes,
               entry=entry, launches_per_replay=added[entry],
               kernels_per_launch=per_launch, replay_kernels_seen=replayed)
    log(f"graphs block {label}: wall {row['eager_wall_ms']:.2f} -> "
        f"{row['captured_wall_ms']:.2f}ms, busy "
        f"{row['eager_busy_ms']:.2f} -> {row['captured_busy_ms']:.2f}ms, "
        f"busy share {100 * row['eager_busy_share']:.1f}% -> "
        f"{100 * row['captured_busy_share']:.1f}%, one capture "
        f"{row['capture_s']:.3f}s, graph "
        f"{row['graph_bytes'] / 2**20:.1f} MiB; a replay counts "
        f"{added[entry]} {entry} launches, the profiler saw {replayed} "
        f"kernels ({per_launch} a launch)")
    return row


def static_graph_block(torch, tm, cfg, params) -> dict:
    """(c), the static engine's block: ``profile_static_block``'s K=8
    block (B=4, a 512-token prompt cached, native), eager and captured
    through ``block_row``, its position a device value as the engine
    passes it."""
    import numpy as np
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, K, S = 4, 8, max(QWEN_PROMPTS)
    cache = tm.init_cache(cfg, B, S + 1 + QWEN_NEW, opts, "cuda")

    def block(tok, pos):
        return tm.decode_steps(cfg, params, tok, pos, cache, K, opts)[0]
    row = block_row(torch, f"{cfg.name} static decode block K={K} B={B} "
                    f"pos={S} cache=native", block,
                    dict(tok=np.arange(1, B + 1, dtype=np.int32),
                         pos=np.asarray(S, np.int32)))
    del cache
    return row


def _recording(runner) -> list:
    """The keys ``runner`` is asked to run, in order (its ``run``
    wrapped)."""
    keys, run = [], runner.run

    def record(key, fn, **inputs):
        keys.append(key)
        return run(key, fn, **inputs)
    runner.run = record
    return keys


def static_graphs_against_eager(torch, kern, tm, ServeEngine, cfg,
                                params) -> dict:
    """(e): qwen2.5-3b at full width, bf16, through the static engine on
    phase 5's two waves (4 x 256 and 4 x 512 tokens, 32 new), native and
    int8, served eagerly (``graphs=False``) and captured: tokens equal but
    for a divergence after a near tie, host syncs, decode steps, decode
    compiles and every launch count equal, no plain version called, and
    captures equal to the distinct (B, L, k_eff) keys the serve made."""
    from repro_torch.kernels import flash_attention as flash
    reqs = qwen_requests(cfg.vocab)
    out = {}
    for policy in ("native", "int8"):
        sides = {}
        for side, graphs in (("eager", False), ("captured", None)):
            eng = ServeEngine(cfg, params, tm.RuntimeOptions(
                dtype="bfloat16"), device="cuda", scheduler="static",
                kv_policy=policy, decode_lookahead=8, max_len=QWEN_MAX_LEN,
                graphs=graphs)
            g = eng.static_graphs
            check((g is None) == (side == "eager"),
                  f"static {policy} {side}: the engine's static graphs are "
                  f"{g!r}")
            keys = _recording(g) if g is not None else []
            before = read_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with count_plain(kern, flash) as plain:
                t0 = time.perf_counter()
                outs = eng.serve([r[:] for r in reqs], QWEN_NEW)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            s = eng.stats
            check(not plain, f"static {policy} {side}: plain versions "
                  f"called on the card: {plain}")
            check(all(len(o) == QWEN_NEW and all(0 <= t < cfg.vocab
                                                 for t in o) for o in outs),
                  f"static {policy} {side}: malformed outputs")
            sides[side] = (outs, dict(
                tokens_per_s=s.tps, prefill_s=s.prefill_s,
                decode_s=s.decode_s, host_syncs=s.host_syncs,
                decode_steps=s.decode_steps,
                decode_compiles=s.decode_compiles, wall_s=wall,
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches={k: v - before[k] for k, v in read_counts().items()},
                captures=g.captures if g else 0,
                capture_s=g.capture_s if g else 0.0,
                graph_bytes=g.memory_bytes if g else 0,
                keys=sorted(set(keys), key=str)))
            del eng
        (want, erow), (got, crow) = sides["eager"], sides["captured"]
        label = f"static {policy}"
        differ = {c: (crow[c], erow[c]) for c in
                  ("host_syncs", "decode_steps", "decode_compiles",
                   "launches") if crow[c] != erow[c]}
        check(not differ, f"{label}: captured != eager in {differ}")
        check(crow["captures"] == len(crow["keys"]) > 0,
              f"{label}: {crow['captures']} captures for the distinct keys "
              f"{crow['keys']}")
        ties = same_up_to_ties(torch, tm, cfg, params, reqs, got, want,
                               f"{label} captured vs eager")
        out[policy] = dict(eager=erow, captured=crow, ties=ties)
        log(f"graphs {label}: captured == eager in tokens ({ties} requests "
            f"differ after a near tie), host_syncs={crow['host_syncs']} "
            f"decode_steps={crow['decode_steps']} "
            f"decode_compiles={crow['decode_compiles']}, launches; "
            f"captures {crow['captures']} = keys {crow['keys']} "
            f"({crow['capture_s']:.2f}s, graphs' memory "
            f"{crow['graph_bytes'] / 2**20:.1f} MiB); tokens/s "
            f"{erow['tokens_per_s']:.1f} -> {crow['tokens_per_s']:.1f}, "
            f"decode_s {erow['decode_s']:.3f} -> {crow['decode_s']:.3f}, "
            f"wall {erow['wall_s']:.2f} -> {crow['wall_s']:.2f}s, peak "
            f"{erow['peak_bytes'] / 1e9:.2f} -> "
            f"{crow['peak_bytes'] / 1e9:.2f} GB")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def draft_graphs_against_eager(torch, kern, tm, ServeEngine, cfg,
                               params) -> dict:
    """(f): phase 4's self-draft run (llama3.2-1b drafting for itself,
    k=4) served eagerly and captured, the streams serialized as in (a):
    tokens equal up to a near tie, ``GRAPH_COUNTERS`` and the draft's
    passes equal, the engine's captures equal to its compiles and the
    draft's one a key; a second serve on the captured engine captures
    nothing and repeats its tokens."""
    reqs = requests(cfg.vocab)[:GRAPH_REQS]
    kw = dict(spec_mode="model", spec_k=4, draft_cfg=cfg,
              draft_params=params, overlap=False)
    sides = {}
    for side, graphs in (("eager", False), ("captured", None)):
        eng, outs, row = serve_run(
            torch, kern, ServeEngine, tm.RuntimeOptions, cfg, params, reqs,
            f"self-draft {side}", PAGED, graphs=graphs, **kw)
        dg = eng.drafter.graphs
        check((dg is None) == (side == "eager"),
              f"self-draft {side}: the draft's graphs are {dg!r}")
        row.update(passes=dict(eng.drafter.passes),
                   draft_captures=dg.captures if dg else 0,
                   draft_keys=len(dg._blocks) if dg else 0,
                   draft_capture_s=dg.capture_s if dg else 0.0,
                   draft_graph_bytes=dg.memory_bytes if dg else 0)
        sides[side] = (eng, outs, row)
    (_, want, erow), (ceng, got, crow) = sides["eager"], sides["captured"]
    differ = {c: (crow[c], erow[c]) for c in GRAPH_COUNTERS + ("passes",)
              if crow[c] != erow[c]}
    check(not differ, f"self-draft: captured != eager in {differ}")
    check(crow["captures"] == crow["decode_compiles"]
          + crow["prefill_compiles"], f"self-draft: {crow['captures']} "
          f"engine captures for {crow['decode_compiles']} + "
          f"{crow['prefill_compiles']} compiles")
    check(crow["draft_captures"] == crow["draft_keys"] > 0,
          f"self-draft: {crow['draft_captures']} draft captures for "
          f"{crow['draft_keys']} keys")
    ties = same_up_to_ties(torch, tm, cfg, params, reqs, got, want,
                           "self-draft captured vs eager")
    dg = ceng.drafter.graphs
    n = (ceng.graphs.captures, dg.captures)
    again = ceng.serve([r[:] for r in reqs], 64)
    check(again == got and (ceng.graphs.captures, dg.captures) == n,
          f"self-draft: a second serve on the captured engine captured "
          f"{(ceng.graphs.captures, dg.captures)} after {n} or changed its "
          f"tokens")
    mib = (crow["graph_bytes"] + crow["draft_graph_bytes"]) / 2**20
    log(f"graphs self-draft: captured == eager in tokens ({ties} requests "
        f"differ after a near tie), " + ", ".join(
            f"{c}={crow[c]}" for c in GRAPH_COUNTERS[:-1])
        + f", launches, passes {crow['passes']}; captures engine "
        f"{crow['captures']} = compiles, draft {crow['draft_captures']} = "
        f"keys ({crow['capture_s'] + crow['draft_capture_s']:.2f}s, "
        f"graphs' memory {mib:.1f} MiB); tokens/s "
        f"{erow['tokens_per_s']:.1f} -> "
        f"{crow['tokens_per_s']:.1f}, decode_s {erow['decode_s']:.3f} -> "
        f"{crow['decode_s']:.3f}, wall {erow['wall_s']:.2f} -> "
        f"{crow['wall_s']:.2f}s; a second serve captured 0")
    del sides, ceng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(eager=erow, captured=crow, ties=ties,
                second_serve_captures=0)


def graphs_phase(torch, kern, tm, ServeEngine, get_config, smi,
                 phase4=None) -> dict:
    """Phase 28: the continuous engine's decode block, prefill chunk and
    verify pass captured as CUDA graphs (the engine's default on the
    card) against the same blocks run eagerly, on llama3.2-1b at full
    width and all 16 layers with phase 4's weights (seed 0, bf16): (a)
    ``graphs_against_eager``, (b) ``replays_bitwise``, (c)
    ``graph_blocks``, (d) the graphs' memory of each engine (in (a)'s
    lines). ``phase4``: phase 4's runs by label; without it (as with
    ``--graphs-only``) they are served here first, captured, as phase 4
    serves them."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tm.init_params(cfg, gen, "bfloat16", "cuda")
    if phase4 is None:
        phase4 = {}
        for label, (kw, need) in GRAPH_RUNS.items():
            serial = dict(overlap=False) if "temperature" in kw else {}
            _, _, phase4[label] = serve_run(
                torch, kern, ServeEngine, tm.RuntimeOptions, cfg, params,
                requests(cfg.vocab), f"{label} (phase 4)", need, **kw,
                **serial)
    out = dict(smi=smi)
    out["runs"] = graphs_against_eager(torch, kern, tm, ServeEngine, cfg,
                                       params, phase4)
    out["replays"] = replays_bitwise(torch, tm, cfg, params)
    out["blocks"] = graph_blocks(torch, tm, cfg, params)
    out["draft"] = draft_graphs_against_eager(torch, kern, tm, ServeEngine,
                                              cfg, params)
    out["graph_bytes"] = {label: r["captured"]["graph_bytes"]
                          for label, r in out["runs"].items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    qwen = get_config("qwen2.5-3b")
    qparams = tm.init_params(qwen, torch.Generator(device="cuda")
                             .manual_seed(0), "bfloat16", "cuda")
    out["blocks"]["static"] = static_graph_block(torch, tm, qwen, qparams)
    out["static"] = static_graphs_against_eager(torch, kern, tm, ServeEngine,
                                                qwen, qparams)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 28 (the blocks as CUDA graphs) {out['phase_s']:.1f}s on "
        f"{smi}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--kernels-only", action="store_true",
                    help="only build, check and time the kernel entries and "
                    "profile the paged blocks (to compare two checkouts in "
                    "one run); prints no result line")
    ap.add_argument("--sharded-only", action="store_true",
                    help="only build the kernels and run phase 17 (head-"
                    "sharded serving; with a card a rank, over nccl); prints "
                    "no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="only build the kernels and run phase 18 "
                    "(training); prints no result line")
    ap.add_argument("--shard-paths-only", action="store_true",
                    help="only build the kernels and run phase 20 (the dry "
                    "run's sharded paths); prints no result line")
    ap.add_argument("--sync-audit-only", action="store_true",
                    help="only build the kernels and run phase 21 (the "
                    "sync audit); prints no result line")
    ap.add_argument("--head256-only", action="store_true",
                    help="only build the kernels, report their head-width-"
                    "256 instances, check and time the head-width-256 "
                    "kernel cases and run phase 22; prints no result line")
    ap.add_argument("--wide-heads-only", action="store_true",
                    help="only build the kernels, report their head-width-"
                    "384 and -512 instances, check and time the wide-head "
                    "kernel cases and run phase 23; prints no result line")
    ap.add_argument("--wider-heads-only", action="store_true",
                    help="only build the kernels, report their width-generic "
                    "instances (head widths above 512), check and time the "
                    "kernel cases above 512 and run phase 27; prints no "
                    "result line")
    ap.add_argument("--tiers-only", action="store_true",
                    help="only build the kernels and run phase 25 (HBS "
                    "offload and the chiplet); prints no result line")
    ap.add_argument("--sweeps-only", action="store_true",
                    help="only build the kernels and run phase 26 "
                    "(spec_sweep and shard_sweep); prints no result line")
    ap.add_argument("--graphs-only", action="store_true",
                    help="only build the kernels and run phase 28 (the "
                    "serving blocks as CUDA graphs against eager); prints "
                    "no result line")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is run "
                    "(default: this checkout's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("[smoke] FAIL: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print("[smoke] FAIL: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    phase_s, t_mark = {}, [t_start]

    def mark(name):
        """Log and keep the seconds of the phases that just ended."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"phases {name}: {phase_s[name]:.1f}s (at {now - t_start:.1f}s)")

    # ---- phase 1 ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2 ----
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.kernels import flash_attention as flash
    import repro_torch.models as tm
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    # phases 25's and 26's CPU twins run beside the build, never beside a
    # measurement: they are waited for as soon as it ends
    twin_groups = ((TIER_SWEEPS,) if args.tiers_only else
                   (SPEC_SHARD_SWEEPS,) if args.sweeps_only else
                   None if any((args.kernels_only, args.sharded_only,
                                args.train_only, args.shard_paths_only,
                                args.sync_audit_only, args.head256_only,
                                args.wide_heads_only,
                                args.wider_heads_only,
                                args.graphs_only)) else
                   (TIER_SWEEPS, SPEC_SHARD_SWEEPS))
    twins = None if twin_groups is None else start_twins(twin_groups)
    built = kbuild.build_kernels()
    log(f"build {time.perf_counter() - t0:.1f}s "
        + " ".join(f"{k}={v:.1f}s" for k, v in built.items()))
    if twins is not None:
        twins = join_twins(twins)
    for name in kbuild.SOURCES:
        text = kbuild.build_log(name)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        smem = [int(n) for n in re.findall(r"(\d+) bytes smem", text)]
        log(f"ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, smem max "
            f"{max(smem, default=0)} B, spill stores max "
            f"{max(spills, default=0)} B")

    hmma = hmma_counts(kbuild, "flash_attention", "flash_mma_kernel")
    log("sass flash_attention: HMMA "
        + " ".join(f"{n}={c}" for n, c in hmma.items()))
    check(any("bfloat16" in n for n in hmma) and all(hmma.values()),
          f"the flash library's bf16/f16 kernels lack HMMA: {hmma}")
    check(all(c == FLASH_HMMA_DH128 for n, c in hmma.items() if "Li128E" in n),
          f"the flash dh=128 kernels no longer hold {FLASH_HMMA_DH128} HMMA "
          f"each: {hmma}")
    chunk_hmma = hmma_counts(kbuild, "chunk_prefill_attention",
                             "chunk_mma_kernel")
    log("sass chunk_prefill_attention: HMMA "
        + " ".join(f"{n}={c}" for n, c in chunk_hmma.items()))
    check(args.kernels_only or (any("bfloat16" in n for n in chunk_hmma)
                              and all(chunk_hmma.values())),
          f"the chunk library's bf16/f16 kernels lack HMMA: {chunk_hmma}")
    paged_lib = kbuild.lib_path("paged_decode_attention").name
    paged_hdrs = set(kbuild.headers("paged_decode_attention"))
    check(args.kernels_only or (paged_lib != OLD_PAGED_DECODE_LIB
                                and paged_hdrs == PAGED_DECODE_HEADERS),
          f"the paged decode library {paged_lib} is not built from the "
          f"redesigned source and its headers {sorted(paged_hdrs)}")
    paged_regs = paged_ptxas(kbuild)
    regs256 = width_ptxas(kbuild, 256)
    regs_wide = {dh: width_ptxas(kbuild, dh) for dh in WIDE_DIMS}
    regs_wider = width_ptxas(kbuild, "wide")
    wider_hmma = {lib: hmma_counts(kbuild, lib, "wide_mma_kernel")
                  for lib in ("chunk_prefill_attention", "flash_attention")}
    for lib, counts in wider_hmma.items():
        log(f"sass {lib} width-generic: HMMA "
            + " ".join(f"{n}={c}" for n, c in counts.items()))
        check(counts and all(counts.values()),
              f"the {lib} library's width-generic tensor-core kernels lack "
              f"HMMA: {counts}")

    if args.head256_only:
        from repro_torch.models import common as cm
        rows = check_kernels(torch, kern, flash,
                             head256_cases(torch, kern, flash))
        pali_text, _ = serve_paligemma_text(torch, kern, tm, cm,
                                            ServeEngine, get_config)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(
                smi=smi, build_s=built, head256_ptxas=regs256,
                kernel_cases=rows, paligemma_text=pali_text), indent=1,
                default=str))
        return
    if args.wide_heads_only:
        from repro_torch.models import common as cm
        t0 = time.perf_counter()
        rows = check_kernels(torch, kern, flash,
                             wide_cases(torch, kern, flash))
        log(f"phase 3 dh=384/512 {time.perf_counter() - t0:.1f}s")
        wide_text, _ = serve_paligemma_text(
            torch, kern, tm, cm, ServeEngine, get_config, WIDE_TEXT,
            "dh-512 text", 23)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(
                smi=smi, build_s=built, wide_ptxas=regs_wide,
                kernel_cases=rows, wide_text=wide_text), indent=1,
                default=str))
        return
    if args.wider_heads_only:
        from repro_torch.models import common as cm
        t0 = time.perf_counter()
        rows = check_kernels(torch, kern, flash,
                             wider_cases(torch, kern, flash), WIDER_TIMED)
        log(f"phase 3 dh>512 {time.perf_counter() - t0:.1f}s")
        wider_text, _ = serve_paligemma_text(
            torch, kern, tm, cm, ServeEngine, get_config, WIDER_TEXT,
            "dh-1024 text", 27)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(
                smi=smi, build_s=built, wider_ptxas=regs_wider,
                wider_hmma=wider_hmma, kernel_cases=rows,
                wider_text=wider_text), indent=1, default=str))
        return
    if args.graphs_only:
        graphs = graphs_phase(torch, kern, tm, ServeEngine, get_config, smi)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(smi=smi, graphs=graphs),
                                                 indent=1, default=str))
        return
    if args.tiers_only:
        tiers = tiers_phase(torch, kern, smi, twins)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(smi=smi, tiers=tiers),
                                                 indent=1, default=str))
        return
    if args.sweeps_only:
        sharded, _, _ = serve_sharded(torch, kern, tm, ServeEngine,
                                      get_config)
        sweeps = sweeps_phase(torch, kern, smi, twins,
                              sharded.pop("sweep_groups"))
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(smi=smi,
                                                      sweeps=sweeps),
                                                 indent=1, default=str))
        return
    if args.kernels_only:
        kernels_only(torch, args, smi, kern, flash, tm, get_config, built,
                     hmma, chunk_hmma, paged_regs, t_start)
        return
    if args.sharded_only:
        sharded, shard_rows, _ = serve_sharded(torch, kern, tm, ServeEngine,
                                               get_config)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).write_text(json.dumps(dict(
                smi=smi, sharded=sharded, shard_rows=shard_rows), indent=1,
                default=str))
        return
    if args.shard_paths_only:
        shard_paths = shard_paths_phase(torch, kern, tm, get_config, smi)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(
                smi=smi, shard_paths=shard_paths), indent=1, default=str))
        return
    if args.sync_audit_only:
        audit = sync_audit(torch, tm, ServeEngine, get_config, smi)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(smi=smi, audit=audit),
                                                 indent=1, default=str))
        return
    if args.train_only:
        from repro_torch.models import common as cm
        train = train_phase(torch, kern, tm, cm, get_config)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(smi=smi, train=train),
                                                 indent=1, default=str))
        return
    mark("1-2")

    # ---- phase 3 ----
    n_sm = kern._sm_count(torch.cuda.current_device())
    split = kern.decode_split(4, 2, 545, 8, n_sm)
    blocks = -(-545 // split) * 4 * 2
    log(f"dense decode at B=4 Hkv=2 L=545: split={split} keys, {blocks} "
        f"pass-1 blocks on {n_sm} SMs")
    check(blocks >= n_sm, f"dense decode fills {blocks} < {n_sm} blocks")
    rows = check_kernels(torch, kern, flash)
    mark("3")
    rows += check_kernels(torch, kern, flash,
                          head256_cases(torch, kern, flash))
    mark("3 dh=256")
    rows += check_kernels(torch, kern, flash, wide_cases(torch, kern, flash))
    mark("3 dh=384/512")
    rows += check_kernels(torch, kern, flash, wider_cases(torch, kern, flash),
                          WIDER_TIMED)
    mark("3 dh>512")

    # ---- phase 4 ----
    cfg = get_config("llama3.2-1b")
    engine, launches, params = serve_full_width(torch, kern, ServeEngine,
                                                tm.RuntimeOptions, cfg)
    spec_runs, spec_launches = serve_spec(torch, kern, ServeEngine,
                                          tm.RuntimeOptions, cfg, params)
    engine.update(spec_runs)
    breakdown = profile_decode_block(torch, tm, cfg, params)
    chunk_block = profile_chunk_block(torch, tm, cfg, params)
    verify_block = profile_verify_block(torch, tm, cfg, params)
    del params
    torch.cuda.empty_cache()
    mark("4")

    # ---- phase 5: the static engine ----
    qwen = get_config("qwen2.5-3b")
    static, static_launches, params = serve_static(
        torch, kern, ServeEngine, tm.RuntimeOptions, qwen)
    static_breakdown = {policy: profile_static_block(torch, tm, qwen, params,
                                                     cache_dtype)
                        for policy, cache_dtype in (("native", ""),
                                                    ("int8", "int8"))}
    del params
    torch.cuda.empty_cache()
    mark("5")

    # ---- phase 6 ----
    f32_err = f32_checks(torch, tm, ServeEngine, cfg)
    f32_static = f32_static_checks(torch, tm, ServeEngine, qwen)
    mark("6")

    # ---- phase 7: arctic-480b (MoE, group 7) on both engines ----
    arctic, arctic_launches = serve_arctic(torch, kern, tm, ServeEngine,
                                           get_config)
    mark("7")

    # ---- phases 8-11: the VLMs and the masked attention ----
    from repro_torch.models import common as cm
    llava = serve_llava(torch, kern, tm, cm, ServeEngine, get_config)
    paligemma = serve_paligemma(torch, kern, tm, cm, ServeEngine, get_config)
    gemma3 = serve_gemma3(torch, kern, tm, cm, ServeEngine, get_config)
    f32_masked = f32_masked_checks(torch, tm, ServeEngine, get_config)
    mark("8-11")

    # ---- phases 12-16: MLA, Mamba-2, Zamba2, Whisper ----
    deepseek = serve_deepseek(torch, kern, tm, cm, ServeEngine, get_config)
    mamba = serve_mamba(torch, kern, tm, cm, ServeEngine, get_config)
    zamba = serve_zamba(torch, kern, tm, cm, ServeEngine, get_config)
    whisper = serve_whisper(torch, kern, tm, cm, ServeEngine, get_config)
    f32_families = f32_family_checks(torch, tm, ServeEngine, get_config)
    mark("12-16")

    # ---- phase 17: head-sharded continuous serving ----
    sharded, shard_rows, shard_launches = serve_sharded(
        torch, kern, tm, ServeEngine, get_config)
    mark("17")

    # ---- phase 18: training ----
    train = train_phase(torch, kern, tm, cm, get_config)
    mark("18")

    # ---- phase 19: the analytic model against the card ----
    analytic = analytic_phase(
        torch, kern, tm, get_config, smi,
        served_steps(get_config, requests(cfg.vocab), engine, static, arctic,
                     llava, paligemma, gemma3, deepseek, mamba, zamba,
                     whisper),
        breakdown["device_busy_ms"] / 8)
    mark("19")

    # ---- phase 20: the dry run's sharded paths on the card ----
    shard_paths = shard_paths_phase(torch, kern, tm, get_config, smi)
    mark("20")

    # ---- phase 21: the sync audit ----
    audit = sync_audit(torch, tm, ServeEngine, get_config, smi)
    mark("21")

    # ---- phase 22: head width 256, paligemma-3b's decoder text-only ----
    pali_text, pali_text_launches = serve_paligemma_text(
        torch, kern, tm, cm, ServeEngine, get_config)

    mark("22")

    # ---- phase 23: head width 512, the text decoder regrouped ----
    wide_text, wide_text_launches = serve_paligemma_text(
        torch, kern, tm, cm, ServeEngine, get_config, WIDE_TEXT,
        "dh-512 text", 23)
    mark("23")

    # ---- phase 24: the port's examples ----
    examples = examples_on_card(torch, kern)
    mark("24")

    # ---- phase 25: HBS offload and the chiplet, the paper's sweeps ----
    tiers = tiers_phase(torch, kern, smi, twins)
    mark("25")

    # ---- phase 26: speculative decoding and head-sharded serving ----
    sweeps = sweeps_phase(torch, kern, smi, twins,
                          sharded.pop("sweep_groups"))
    mark("26")

    # ---- phase 27: head width 1024, the width-generic instances ----
    wider_text, wider_text_launches = serve_paligemma_text(
        torch, kern, tm, cm, ServeEngine, get_config, WIDER_TEXT,
        "dh-1024 text", 27)
    mark("27")

    # ---- phase 28: the serving blocks as CUDA graphs against eager ----
    graphs = graphs_phase(torch, kern, tm, ServeEngine, get_config, smi,
                          engine)
    mark("28")

    # the main paths' configurations: for the paged entries a bf16 pool,
    # group 1 (llama3.2-1b as the paper sizes it: 32 KV heads), the
    # engine's scalar-start chunk and the full verify window of spec_k 4;
    # for the static entries qwen2.5-3b's width (group 8) at the 512-token
    # wave. Launches: the spec-off path's for the first two, the
    # speculative path's for the verify entry, the static path's for the
    # last two.
    # arctic-480b's path adds each kernel at group 7, with the launches of
    # its own runs (native continuous, n-gram, static native)
    head = {"paged_decode_attention": "group=1 pool=bfloat16",
            "chunk_prefill_attention":
                "group=1 pool=bfloat16 start=scalar",
            "spec_verify_attention": "group=1 pool=bfloat16 C=5",
            "decode_attention": "group=8 pool=bfloat16 L=545 dh=128",
            "flash_attention": "group=8 bfloat16 S=512 causal"}
    arctic_head = {
        "paged_decode_attention": ("group=7 pool=bfloat16 dh=128", "native"),
        "chunk_prefill_attention":
            ("group=7 pool=bfloat16 start=scalar dh=128", "native"),
        "spec_verify_attention": ("group=7 pool=bfloat16 C=5 dh=128",
                                  "ngram"),
        "decode_attention": ("group=7 pool=bfloat16 L=545 dh=128",
                             "static native"),
        "flash_attention": ("group=7 bfloat16 S=512 causal",
                            "static native")}
    replaces = {"paged_decode_attention":
                    "src/repro/kernels/decode_attention.py:180",
                "chunk_prefill_attention":
                    "src/repro/kernels/decode_attention.py:284",
                "spec_verify_attention":
                    "src/repro/kernels/decode_attention.py:360",
                "decode_attention":
                    "src/repro/kernels/decode_attention.py:91",
                "flash_attention":
                    "src/repro/kernels/flash_attention.py:71"}
    launches["spec_verify_attention"] = spec_launches["spec_verify_attention"]
    for name in ("decode_attention", "flash_attention"):
        launches[name] = static_launches[name]
    source = dict(kbuild.SOURCES,
                  spec_verify_attention=kbuild.SOURCES[
                      "chunk_prefill_attention"])
    kernels = []
    entries = [(name, case, launches[name], "llama3.2-1b/qwen2.5-3b")
               for name, case in head.items()]
    entries += [(name, case, arctic_launches[run][name], "arctic-480b")
                for name, (case, run) in arctic_head.items()]
    # the VLM paths: the dense decode at llava15-13b's long context (its
    # (b) native run) and at paligemma-3b's head width 256, flash at
    # llava's group 1 (its (a) native run)
    L_b = LLAVA_PATCHES + LLAVA_RUNS["b"][1] + LLAVA_RUNS["b"][2]
    S_a = LLAVA_PATCHES + LLAVA_RUNS["a"][1]
    entries += [
        ("decode_attention", f"group=1 pool=float16 L={L_b} dh=128 B=1",
         llava["runs"]["b native"]["launches"]["decode_attention"],
         "llava15-13b"),
        ("decode_attention", "group=8 pool=bfloat16 L=545 dh=256",
         paligemma["runs"]["native"]["launches"]["decode_attention"],
         "paligemma-3b"),
        ("flash_attention", f"group=1 float16 S={S_a} causal",
         llava["runs"]["a native"]["launches"]["flash_attention"],
         "llava15-13b")]
    # the head-sharded paths: the three paged entries at a shard's heads
    # (group 1, bf16 pool, split as the whole pool), with each rank's
    # launches in its native run (n-gram for the verify entry); at four
    # shards no verify pass runs: its launches there are 0
    for n, ln in shard_launches.items():
        entries += [(name, f"{head[name]} shard=1/{n}", ln[name],
                     f"llama3.2-1b ({CUT_LAYERS} of 16 layers) shards={n}")
                    for name in PAGED]
    # the concurrency sweep's paths (phase 19 (f)): the paged entries at
    # their main-path case (llama3.2-1b's width), the static ones at the
    # sweep's longest wave, with the launches of every serve of the sweep
    sweep = analytic["concurrency"]["launches"]
    B, S, L = max(sweep_waves(), key=lambda w: w[1])
    sweep_case = {"paged_decode_attention": head["paged_decode_attention"],
                  "chunk_prefill_attention":
                      head["chunk_prefill_attention"],
                  "decode_attention":
                      f"group=1 pool=bfloat16 L={L} dh=64 B={B}",
                  "flash_attention":
                      f"group=1 bfloat16 S={S} dh=64 B={B} causal"}
    entries += [(name, case, sweep[name], "llama3.2-1b concurrency sweep")
                for name, case in sweep_case.items()]
    # the head-width-256 paths (phase 22): each kernel at its main-path
    # case, with the launches of the spec-off continuous run (paged decode,
    # chunk), the n-gram run (verify) and the static native run (flash,
    # dense decode)
    pali_run = {"paged_decode_attention": "native",
                "chunk_prefill_attention": "native",
                "spec_verify_attention": "ngram",
                "decode_attention": "static native",
                "flash_attention": "static native"}
    entries += [(name, PALI_TEXT_MAIN[name],
                 pali_text_launches[run][name],
                 f"paligemma-3b text-only ({TEXT_LAYERS} of 18 layers)")
                for name, run in pali_run.items()]
    # the head-width-512 paths (phase 23), the same runs' launches
    entries += [(name, WIDE_MAIN[name], wide_text_launches[run][name],
                 f"paligemma-3b text-only ({TEXT_LAYERS} of 18 layers), 4 "
                 f"heads of 512")
                for name, run in pali_run.items()]
    # the head-width-1024 paths (phase 27), the same runs' launches
    entries += [(name, WIDER_MAIN[name], wider_text_launches[run][name],
                 f"paligemma-3b text-only ({TEXT_LAYERS} of 18 layers), 2 "
                 f"heads of 1024")
                for name, run in pali_run.items()]
    # the tiered paths (phase 25): the paged decode and the chunk at each
    # sweep's shapes with its serves' launches
    hbs_layers = tiers["hbs"]["card"]["n_layers"]
    entries += [(name, TIER_MAIN[name], tiers["hbs"]["launches"][name],
                 f"llava15-13b decoder ({hbs_layers} of 40 layers) "
                 f"hbs_sweep") for name in TIER_MAIN]
    entries += [(name, TIER_MAIN_1B[name],
                 tiers["chiplet"]["launches"][name],
                 "llama3.2-1b chiplet_sweep") for name in TIER_MAIN_1B]
    # the last two sweeps (phase 26): spec_sweep's paged entries at
    # llama3.2-1b's width with the target's launches (the verify windows
    # of k = 4, 8 and 12 with the launches of the serves at that k), at
    # its model draft's width with the draft's, and shard_sweep's paged
    # decode and chunk at a shard's heads with rank 0's launches
    spec_l = sweeps["spec"]["launches"]
    for (name, k), case in SPEC_MAIN.items():
        n_launch = (spec_l[f"{name}@{LLAMA_WIDTH[2]}"] if k is None
                    else sweeps["spec"]["verify_by_k"][k])
        entries.append((name, case, n_launch,
                        f"llama3.2-1b ({sweeps['spec']['n_layers']} of 16 "
                        f"layers) spec_sweep"
                        + ("" if k is None else f" k={k}")))
    entries += [(name, case, spec_l[f"{name}@{DRAFT_WIDTH[2]}"],
                 "llama3.2-1b spec_sweep model draft (1024 wide, 1 "
                 "layer)")
                for name, case in DRAFT_MAIN.items()]
    for n, ranks in sweeps["shard"]["rank_launches"].items():
        for name, label in (("paged_decode_attention", ""),
                            ("chunk_prefill_attention", " start=scalar")):
            case = (f"group=1 pool=bfloat16{label} shard=1/{n} "
                    f"{SHARD_SWEEP_POOL}"
                    + ("" if not label else f" C={SHARD_SWEEP_CHUNK}"))
            entries.append((name, case,
                            ranks[0][f"{name}@{LLAMA_WIDTH[2] // n}"],
                            f"llama3.2-1b ({CUT_LAYERS} of 16 layers) "
                            f"shard_sweep shards={n}"))
    rows = rows + shard_rows + tiers["kernel_rows"] + sweeps["kernel_rows"]
    for name, case, n_launch, model in entries:
        r = next(r for r in rows if r["name"] == name and r["case"] == case)
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source[name]}",
            replaces=replaces[name], launches=n_launch,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], case=case, model=model))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            gpu=smi, kernel_cases=rows, engine=engine,
            spec_path_launches=spec_launches, static=static,
            static_path_launches=static_launches,
            decode_block=breakdown, chunk_block=chunk_block,
            verify_block=verify_block, static_decode_block=static_breakdown,
            f32_logit_err=f32_err, f32_static=f32_static, arctic=arctic,
            arctic_launches=arctic_launches, llava=llava,
            paligemma=paligemma, gemma3=gemma3, f32_masked=f32_masked,
            deepseek=deepseek, mamba=mamba, zamba=zamba, whisper=whisper,
            f32_families=f32_families, sharded=sharded, train=train,
            analytic=analytic, shard_paths=shard_paths, sync_audit=audit,
            paligemma_text=pali_text, wide_text=wide_text,
            wider_text=wider_text,
            examples=examples, tiers=tiers, sweeps=sweeps, graphs=graphs,
            wide_384={name: next(r for r in rows if r["name"] == name
                                 and r["case"] == case)
                      for name, case in WIDE_384.items()},
            wider_rows={dh: {name: next(r for r in rows if r["name"] == name
                                        and r["case"] == case)
                             for name, case in cases.items()}
                        for dh, cases in WIDER_ROWS.items()},
            phase_s=phase_s, build_s=built,
            flash_hmma=hmma,
            chunk_hmma=chunk_hmma, paged_ptxas=paged_regs,
            head256_ptxas=regs256, wide_ptxas=regs_wide,
            wider_ptxas=regs_wider, wider_hmma=wider_hmma,
            decode_split=dict(split=split, blocks=blocks, n_sm=n_sm),
            kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
