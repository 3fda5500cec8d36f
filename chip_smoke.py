#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of VersaQ-3D.

Run from the repository root on a machine with one NVIDIA GPU (written for
an H100) and the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and does, in order:

1. builds the six CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the served paths below give it (two scenes of S=8 frames x
   P=1024 patches per forward: M = 2 * 8 * 1029 = 16464 tokens), the
   branches a planned tier reaches at those shapes (an A4 ``wqkv`` prologue,
   FFNs with A4 input and an A8 or A4 hidden), plus small cases (W8, A4, a requant
   epilogue, a pre-quantized input, a gated SiLU FFN, ragged M, causal and
   GQA attention), ``quant_matmul`` at the LM paths' shapes (qwen3-14b
   decode and prefill, rwkv6-1.6b decode at 4 slots, deepseek-v2-lite-16b's
   MLA sites ``wq``, ``w_kv_down`` with its ragged N 576 and
   ``w_k_up``/``w_v_up`` with K 512 at M 1, 4 and 1024), and its batched launch
   at deepseek-moe-16b's routed experts (E 64, W4: M 120, a 2 x 512
   prefill's capacity, and M 1, decode's, through gate/up K 2048 x N 1408
   and down K 1408 x N 2048) and jamba-v0.1-52b's (E 16: M 160, a 2 x 512
   prefill's capacity, and M 1, through gate/up K 4096 x N 14,336 and down K
   14,336 x N 4096), ``quant_matmul`` at starcoder2-7b's ``w_up``/``w_down``
   and jamba's Mamba ``w_in``/``w_out`` at M 2 and 1024, ``fused_matmul`` at
   deepseek-moe-16b's fused
   ``wqkv`` (K 2048, N 6144, RMS prologue) and ``wo`` (N 2048) at M 1024, 1
   and 4 (the ``lm_cases`` of its record), and the two-stage kernel at the
   LM scoring shapes (qwen3-14b dh 128, phi3-mini-3.8b dh 96, paligemma-3b
   dh 256 MQA, starcoder2-7b 36/4 and internlm2-20b 48/8 at dh 128,
   musicgen-large 32/32 at dh 64, [2, 2048] causal) and a ragged non-causal
   case at dh 96 and
   256 (Lq 1000, Lk 1500), with every instance's registers and spills (none
   may spill); times kernel, plain version,
   the card's bound and, where one PyTorch call computes the same function,
   that call (``torch._int_mm``, ``F.scaled_dot_product_attention``,
   ``torch.matmul`` with the blocked Hadamard); for ``quant_matmul``, the
   two-stage kernel, ``fused_matmul`` and ``fused_ffn`` also their
   registers, shared memory per block, resident blocks per SM and spills
   (at the served widths), and how many of the two-stage kernel's int8
   probabilities differ from the plain version's (read back through a
   one-hot V);
3. runs vggt-1b width with 2 AA pairs once with the kernels and once with
   the plain versions, for the unfused W4A8 plan and for the fused one, and
   holds each block as in 5;
4. serves vggt-1b at full width and depth (24 AA pairs, random weights from
   seed 0) with the unfused plan ``PrecisionPlan(default="w4a8",
   use_kernel=True)``: 288 ``quant_matmul`` and 48 ``two_stage_attention``
   launches per forward;
5. serves the same model with the fused plan ``PrecisionPlan(default="w4a8",
   use_kernel=True, fuse=True)``: 96 ``fused_matmul``, 48 ``fused_ffn``, 48
   ``two_stage_attention`` and 0 ``quant_matmul`` launches per forward,
   finite outputs, the first micro-batch against a plain-version forward
   (rel L2 < 1e-3) and the served outputs against the unfused plan's on the
   same weights (rel L2 < 1e-2).  vggt-1b's LayerScale (1e-5) keeps each
   block's part of those outputs small, and a larger one (0.2) lets the
   random weights amplify last-bit differences to ~4e-2 on the pose at 2
   pairs (those of the unfused path, whose matmul is bit-exact), so the
   paths are also held block by block: every block's two residual branches
   (attention and FFN, what the block adds to the stream), fed the stream
   of that forward, against the plain versions (< 1e-3) and against the
   other plan's block (< 1e-2), which no LayerScale hides or amplifies;
6. drives ``ops.norm_quant_prologue`` into three pre-quantized
   ``ops.fused_linear`` launches sharing its output (Q/K/V), and
   ``ops.online_wht_2d`` on the FFN hidden's shape;
7. serves vggt-1b (full width and depth, the same seed-0 weights) the way
   ``python -m repro_torch.launch.serve`` does: one ``VGGTEngine`` with the
   tiers ``quality=fp,balanced=w4a8,fast=w4a8:fused`` behind
   ``AsyncServer(metrics_port=0)`` with live telemetry on, 6 requests of one
   scene round-robin over the tiers, the second carrying the fault plan
   ``nan@scene:req=1``.  It checks that only that request fails (with
   ``NumericFault``), each tier's kernel launches (``quality`` none,
   ``balanced`` ``quant_matmul`` + ``two_stage_attention``, ``fast``
   ``fused_matmul`` + ``fused_ffn`` + ``two_stage_attention``), each tier's
   outputs against the plain versions' forward (rel L2 < 1e-3; ``quality``
   against ``models/vggt.py::forward`` on the raw weights, < 1e-5),
   ``/metrics`` (the per-tier bucket series, kernel counters equal to the
   probe's global counters) and ``/healthz``; then that a second engine
   with ``max_pending=1`` refuses a second request with ``QueueFull`` and
   serves the first on ``flush``;
8. plans mixed precision for vggt-1b (full width and depth, seed-0
   weights) with ``core/precision/planner.py::plan_model``, compiles the
   ``plan:fused`` plan with two-stage attention and a tuner that times each
   kernel signature on the card (``core/precision/compiler.py``,
   ``tuner.py``), recompiles on the filled tuning DB (0 timing runs) and
   saves and loads the schedule (same hash); serves 4 requests through
   ``VGGTEngine(schedule=path)`` with the launches the schedule predicts
   (``KernelSchedule.launches_per_forward``), the first micro-batch against
   the plain versions (rel L2 < 1e-3) and each block's branches as in 5;
   then the launcher's ``planned=plan:fused`` tier beside ``fast``
   (launches, plain-version outputs, forward time, scenes/s, peak memory),
   and prints the proxy reconstruction error of the planned, uniform W4A8
   and uniform W4A4 plans against the fp forward;
9. runs the LM path (``models/lm.py``, ``serving/engine.py``): (a)
   qwen3-14b-smoke (seed-0 weights) in three tiers, fp, W4A8 unfused and
   W4A8 fused, a left-padded prefill and 4 decode steps each, logits
   against the plain versions (rel L2 < 1e-3) and each forward's launches
   (the fused tier: ``fused_matmul`` for ``wqkv`` and ``wo`` and
   ``fused_ffn``, no ``quant_matmul``), and a full-mode forward through the
   two-stage kernel at dh 32; (b) serves qwen3-14b at full width, cut to
   ``LM_LAYERS`` layers, the way ``python -m repro_torch.launch.serve
   --arch qwen3-14b`` does: one bucket-mode ``Engine`` with the tiers
   ``quality=fp,balanced=w4a8`` and two-stage attention behind
   ``AsyncServer(metrics_port=0)``, 4 requests of ``mixed_len_prompts``
   (512 and 384 tokens: the balanced pair is a masked bucket), 32 new
   tokens each, ``max_batch=2``; checks every request is delivered, the
   balanced tier launches 7 ``quant_matmul`` per layer per prefill and per
   decode step and no two-stage attention, the quality tier no kernel, and
   the balanced tier's logits, teacher-forced on its own tokens, against
   the plain versions at the prefill and 4 decode steps (rel L2 < 1e-3);
   prints the token agreement, prefill ms, ms per decode step, decode
   tok/s and peak memory; (c) one scoring forward, ``lm.forward(mode=
   "full")``, of the W4A8 tree on [2, ``LM_SCORE_LEN``] tokens: one dh-128
   two-stage launch per layer, logits against the plain versions (rel L2
   < 1e-3);
10. serves qwen3-14b (the same 8 layers and seed-0 weights) through the
   continuous scheduler (``phase_lm_continuous``): one ``Engine`` whose
   ``mode="auto"`` must resolve to continuous, tiers ``quality=fp,
   balanced=w4a8``, slot widths (1, 2, 4), 8 decode steps a burst, behind
   ``AsyncServer``; 8 ``mixed_len_prompts`` requests (512 and 384 tokens),
   32 new tokens each, two first and six while those two decode; request 3
   sampled from a seeded generator, request 4 failing its slot allocation
   (``slot_alloc``) and request 5 poisoned (``nan@decode.logits``).  It
   holds the two faults to their requests, every other request delivered,
   at least one admission mid-decode, ``quant_matmul`` launches equal to 7
   x layers x (balanced prefill waves + balanced decode steps) and none
   for ``quality``, greedy ids equal to a bucket-mode engine's and the
   sampled request's ids equal to the same request served alone (at a
   divergence, the logits each engine itself produced there, kept by
   ``_LogitTap``, must pick the emitted tokens, agree within ``_hold_lm``'s
   bound, and show a near tie: see ``_hold_same_ids``); prints TTFT p50,
   ms per decode step
   and tok/s per tier, slot occupancy and peak memory, and profiles one
   8-step burst at 4 slots per tier;
11. serves rwkv6-1.6b at full width and depth (24 layers, seed-0 weights)
   the same way through ``StateDecodeRunner`` (``phase_rwkv``), tiers fp
   and w4a8, 6 requests at exact prompt lengths of 96-256 tokens, 32 new
   tokens, four joining mid-decode; holds every W4A8 layer's time-mix and
   channel-mix against the plain versions (< 1e-3, full forward and
   prefill + decode), exact-length prefill buckets, ids against bucket
   mode, and 7 x 24 ``quant_matmul`` launches per w4a8 prefill wave and
   decode step; prints the same numbers and the WKV loop's share of a
   256-token prefill (one layer's recurrence, host clock);
12. serves deepseek-moe-16b at full width (d 2048, 64 routed experts of
   1408 at top-6, 2 shared, vocab 102,400), cut to ``MOE_LAYERS`` layers
   (the dense layer 0 and 7 MoE layers, seed-0 weights), through the
   continuous scheduler behind ``AsyncServer`` (``phase_moe``): tiers
   ``quality=fp,balanced=w4a8``, two-stage attention, 8
   ``mixed_len_prompts`` requests (512 and 384 tokens, both lengths in each
   tier), two first and six while those decode, request 5 poisoned
   (``nan@decode.logits``).  It holds the fault to its request, every other
   request delivered, an admission mid-decode, and the balanced tier's
   launches: 7 x layers 2-D ``quant_matmul`` (attention, the dense layer 0,
   the shared experts) and 3 x MoE layers ``quant_matmul_batched`` (the
   routed experts, one launch a projection) per prefill wave and decode
   step, none on ``quality``.  Capacity makes a MoE model's ids depend on
   its batch (decode keeps one slot an expert), so no cross-mode hold is
   made (the CPU tests hold each mode against the reference's same mode);
   instead the balanced tier's logits, teacher-forced on two served
   requests at the same rows and pads, against the plain versions, and
   every layer's branches (attention, dense and MoE FFN) against the plain
   versions; then a [2, ``LM_SCORE_LEN``] scoring forward of the W4A8 tree
   through the dh-128 two-stage kernel (16/16 heads) held the same way.
   Prints prefill ms, decode ms per step, tok/s, TTFT p50/max, slot
   occupancy and peak memory, and profiles one 8-step burst per tier.
11b. (run after 10, on its weights; ``phase_lm_schedule``) plans, tunes,
   compiles and serves LM kernel schedules (``core/precision/planner.py``,
   ``compiler.py``, ``tuner.py``, ``Engine(schedule=path)``): (a)
   qwen3-14b, the same 8 layers and seed-0 weights: ``plan_model(...,
   use_kernel=True, fuse=True)`` with each site's errors, a compile with the
   tuner timing each signature on the card into a fresh DB and a recompile
   that times nothing, each fallback reason (nothing fuses at d 5120), the
   saved schedule served behind ``AsyncServer`` through the continuous
   scheduler (4 ``mixed_len_prompts`` requests, two joining mid-decode, 16
   new tokens) with every prefill wave's and decode step's launches equal
   to ``launches_per_forward(two_stage_attention=False)``, the
   teacher-forced logits against the plain versions (< 1e-3), and a [1,
   512] scoring forward under the schedule's attention tiles (one dh-128
   two-stage launch a layer, held as in 9c); (b) deepseek-moe-16b at full
   width cut to 2 layers (layer 0 dense, one MoE layer), ``w4a8:fused``:
   ``fused_matmul`` for ``wqkv`` and ``wo``, 3 ``quant_matmul_batched``
   for the routed experts, ``quant_matmul`` for the shared experts and the
   dense FFN (each with its fallback reason), one prefill wave and 4 decode
   steps each launching what the schedule predicts, the teacher-forced
   logits against the plain versions (each step within 3x the plain
   versions' largest movement over the steps under two last-bit embedding
   changes: routing turns a flipped rounding into a step) and every layer's
   branches against the plain versions; (c) rwkv6-1.6b: a 24-layer ``w4a8`` compile
   on ``meta`` (timed), and a 2-layer cut served for one prefill wave and
   2 decode steps with the predicted launches; (d) ``python -m
   repro_torch.launch.compile --arch qwen3-14b --spec w4a8:fused`` as a
   subprocess (40 layers on ``meta``): exit 0 and the in-process
   compile's site and group counts and hash.  Prints the phase's seconds.
13. serves phi3-mini-3.8b (MHA 32/32 heads of 96, SwiGLU) at full width and
   depth (32 layers, seed-0 weights; ``phase_phi3``) with the tiers
   ``quality=fp,balanced=w4a8`` and two-stage attention: through the
   continuous scheduler behind ``AsyncServer`` (6 ``mixed_len_prompts``
   requests of ``ZOO_PROMPT`` and 3/4 of that tokens, ``ZOO_GEN`` new tokens,
   four joining while two decode) and in bucket mode; holds every request
   delivered, an admission mid-decode, 7 x 32 ``quant_matmul`` per balanced
   prefill wave and decode step in each mode and none on ``quality``, ids of
   the two modes as in 10 (``_hold_same_ids``), the balanced tier's
   teacher-forced logits against the plain versions (``_hold_lm``) and
   every layer's branches (< 1e-3); then a [2, ``LM_SCORE_LEN``] scoring
   forward of the W4A8 tree: 7 x 32 ``quant_matmul`` and 32 dh-96
   two-stage launches, held as in 9c.  Prints TTFT, decode ms per step,
   tok/s, occupancy and peak memory per mode;
14. runs paligemma-3b (MQA 8/1 heads of 256, GeGLU, embedding inputs) at
   full width and depth (18 layers, seed-0 weights; ``phase_paligemma``):
   the ``Engine``'s refusals as the reference's (bucket mode under
   ``auto``, ``mode="continuous"``, ``enqueue`` and ``generate`` of
   embeddings); a W4A8 left-padded prefill of 2 x ``ZOO_PROMPT`` seeded
   embeddings and 4 ``decode_step`` calls with [2, 1, d] embeddings over
   the int8 cache, 7 x 18 ``quant_matmul`` each, logits and branches held
   as in 13, prefill and decode times; a [2, ``LM_SCORE_LEN``] scoring
   forward through 18 dh-256 two-stage launches (its [2, 2048, 257216]
   logits, 4.2 GB of float32, are compared in chunks, ``_rel``); and the
   compiled ``w4a8:fused`` schedule (``wqkv`` and ``wo`` on
   ``fused_matmul``, the FFN on ``quant_matmul``): a full forward and a
   prefill with 2 decode steps launching what the schedule predicts,
   logits and branches held.  Each prints its seconds;
15. serves deepseek-v2-lite-16b (MLA with kv_lora_rank 512, q/k head dim
   192, v 128; the MoE FFN of 12) at full width, cut to ``MLA_LAYERS``
   layers (the dense layer 0 and 7 MoE layers, seed-0 weights;
   ``phase_mla``), tiers ``quality=fp,balanced=w4a8``: compiles the
   ``w4a8`` schedule (5 ``quant_matmul`` an MLA layer a prefill wave, 3 a
   decode step, whose absorbed decode reads ``w_k_up``/``w_v_up``
   dequantized; one batched launch a routed projection), serves 6
   ``mixed_len_prompts`` requests (``MLA_PROMPT`` and 3/4 of that tokens,
   ``MLA_GEN`` new tokens) through the continuous scheduler behind
   ``AsyncServer`` (slot widths 1, 2, 4, four joining mid-decode) and in
   bucket mode (``max_batch=2``), each with the launches the schedule
   predicts per balanced prefill wave and decode step and none on
   ``quality``; holds the balanced tier's teacher-forced logits (prefill
   and 4 absorbed decode steps) equal to the plain versions' (only the
   exact ``quant_matmul`` launches differ) and every layer's branches
   (< 1e-3); times one layer's absorbed decode over a full compressed
   cache; serves ``Engine(schedule=path)`` with every prefill wave and
   decode step launching what the schedule predicts; and runs a [2,
   ``LM_SCORE_LEN``] scoring forward (float attention, no two-stage
   launch) held as in 9c.  Prints TTFT, decode ms per step, tok/s,
   occupancy and peak memory per mode;
16. serves the last dense configs (``phase_dense_zoo``): starcoder2-7b (GQA
   36/4 x 128, LayerNorm and attention biases, GELU) and musicgen-large (MHA
   32 x 64, LayerNorm with bias, GELU, sinusoid positions) at full depth,
   internlm2-20b (GQA 48/8 x 128) cut to ``DENSE_CUT`` of its 48 layers;
   each through the continuous scheduler with the tiers
   ``quality=fp,balanced=w4a8`` and two-stage attention (4
   ``mixed_len_prompts`` requests of ``DENSE_PROMPT`` and 3/4 of that tokens,
   ``DENSE_GEN`` new tokens, two joining mid-decode), the balanced tier's
   launches equal to the compiled ``w4a8`` schedule's
   ``launches_per_forward`` a prefill wave and decode step, its
   teacher-forced logits held against the plain versions (``_hold_lm``), and
   a [2, ``LM_SCORE_LEN``] scoring forward through the two-stage kernel
   (GQA groups of 9 and 6 at dh 128, causal dh 64) held as in 9c; for
   musicgen also the compiled ``w4a8:fused`` schedule served through
   ``Engine(schedule=path)`` (``fused_matmul`` on ``wqkv`` with its
   LayerNorm prologue and on ``wo``, the FFN on ``quant_matmul``), each call
   launching what it predicts, logits held.  Prints each model's seconds;
17. serves jamba-v0.1-52b (``phase_jamba``) cut to ``JAMBA_LAYERS``, one
   period of its pattern (7 Mamba layers, 1 attention layer 32/8 x 128
   without positions, 4 MoE FFNs of 16 experts x 14,336 at top-2, 4 dense),
   in bucket mode (``mode="auto"`` resolves to it) with the tiers
   ``quality=fp,balanced=w4a8``: 4 requests at exact prompt lengths
   ``JAMBA_PROMPTS``, ``JAMBA_GEN`` new tokens, every balanced prefill wave
   and decode step launching what the compiled ``w4a8`` schedule predicts (2
   ``quant_matmul`` a Mamba layer, 4 for the attention layer, 3 a dense FFN,
   3 ``quant_matmul_batched`` a MoE layer); the balanced tier's
   teacher-forced logits and every layer's branches against the plain
   versions, and its prefill + decode through the ``MambaState`` against a
   full forward over the same tokens (dropless routing, within the
   reference's own bound); the selective scan's share of a
   ``max(JAMBA_PROMPTS)``-token prefill on the host clock;
   ``Engine(schedule=path)`` launching what the schedule predicts; and a
   [2, ``JAMBA_SCORE_LEN``] scoring forward through the dh-128 two-stage
   kernel held as in 9c.  Prints its seconds;
18. trains (``phase_train``): (a) one ``make_train_step`` on the card
   against the same step on the CPU at smoke size for qwen3, deepseek-moe,
   deepseek-v2-lite (MLA), rwkv6, jamba and vggt (the loss and the updated
   parameters held to the CPU tests' bounds); (b) vggt-1b's gradients with
   ``remat=True`` against ``remat=False`` at full width and depth on a small
   scene (1 x 2 frames x 256 patches); (c) vggt-1b trained at full width and
   depth on ``scene_batch(2, 8, 1024, 1024, step)``, ``remat=True``, AdamW lr
   1e-3 with warmup 2, ``TRAIN_STEPS`` steps (loss, grad norm, ms a step,
   scenes/s, peak memory; finite, and the parameters moved); (d) the trained
   tree quantized with the fused W4A8 plan and served through
   ``VGGTEngine`` with two-stage attention (4 one-scene requests,
   ``max_batch=2``: 96 ``fused_matmul``, 48 ``fused_ffn`` and 48
   ``two_stage_attention`` launches a forward), the first micro-batch held to
   the plain versions (< 1e-3) and the W4A8 points to the fp forward of the
   trained weights (rel L2 < 0.25); (e) qwen3-14b at full width cut to
   ``TRAIN_LM_LAYERS`` layers, 3 steps of ``token_batch(2, 512)`` with
   ``remat=True`` (ms a step, tokens/s, peak memory); (f) the ``Trainer`` at
   qwen3-14b-smoke: a failure injected at step 12, a checkpoint every 5, the
   resumed run's losses and parameters against the uninterrupted run's, bit
   for bit; then ``python -m repro_torch.launch.train --steps 20
   --checkpoint-every 10`` and the same with ``--steps 30``, which resumes
   from step 20.  Prints its seconds.
19. runs the multi-device layer at world size 1 (``phase_parallel``; NCCL
   refuses two ranks on one device, so N > 1 runs only in the CPU tests on
   gloo ranks): a one-rank NCCL group joined through a file and
   ``make_local_mesh(1, 1)``; (a) qwen3-14b at ``LM_LAYERS`` layers, W4A8,
   one [2, ``PARALLEL_SEQ``] scoring forward (two-stage attention) on the
   unsharded tree and on the tree placed by ``sharding.distribute_tree``
   under ``implicit_replication()``, its kernel sites on local shards
   (``parallel/sites.py``): the same launches (7 ``quant_matmul`` and one
   ``two_stage_attention`` a layer) and bit-equal logits, and each route's
   first call and the median of ``PARALLEL_WARM`` warm calls; (b)
   ``PARALLEL_DDP_STEPS`` steps each of ``make_train_step`` and
   ``make_ddp_compressed_step`` at ``phase_train``'s qwen3-14b shapes from
   the same seed-0 weights (ms a step, peak memory, the losses, the first
   equal; the int8 wire bytes by ``compression.wire_bytes``); (c)
   ``pipeline_apply`` at one stage equal to the stage applied alone.
20. runs ``examples/torch_long_context.py``'s ``measure`` on the card
   (``phase_long_context``): rwkv6-1.6b uncut and jamba-v0.1-52b at
   ``JAMBA_LAYERS``, fp, batch 1, a 64-token prefill then 16 timed decode
   steps at contexts 128, 512 and 2048: ms a token, the cache's bytes
   (rwkv6's equal at every context) and jamba's int8 K/V bytes against
   bf16 (exactly half).
21. runs the sharded paths of the dry run's cells at world size 1
   (``phase_cells``, a one-rank NCCL group as in 19): (a) vggt-1b at full
   width and depth, W4A8, two-stage attention, ``CELL_SCENES`` scenes of
   ``S_FRAMES`` x ``N_PATCHES``, on the ``vggt_serve_s8`` cell's
   batch-sharded stream (``specs.vggt_stream_specs``) with no
   ``act_sharding`` and again with the act-SP spec: every output bit-equal
   to the unsharded forward's and the same ``quant_matmul`` and
   ``two_stage_attention`` launches, first-call and warm times; (b)
   jamba-v0.1-52b at ``JAMBA_LAYERS``, W4A8, batch 1: a ``CELL_PROMPT``-token
   prefill and ``CELL_DECODE`` greedy decode steps through a KV cache placed
   by ``cache_pspecs(seq_axis_shard=True)``, and again by
   ``seq_model_shard=True``: ids and logits equal to the unsharded cache's;
   (c) ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELLS`` (CPU-only
   subprocesses on a fake 256-rank mesh, started first and run beside (a)
   and (b)): each cell's terms and seconds, ``status`` ``ok``, and no
   collective of the jamba ``long_500k`` decode whose result spans the
   cache's whole sequence (524,288 slots).

The configs of 16-17 serve on the CPU at their smoke sizes through the
launcher, e.g. ``PYTHONPATH=src python -m repro_torch.launch.serve --device
cpu --arch jamba-v0.1-52b-smoke --tiers quality=fp,balanced=w4a8 --requests
4 --prompt-len 8 --gen 8 --batch 2`` (bucket mode, with the ``mode='auto'``
reason on its scheduler line; ``internlm2-20b-smoke``, ``starcoder2-7b-smoke``
and ``musicgen-large-smoke`` serve continuous).

Each of the paths 4-21 runs with the launch counts set to 0 just before it
and read just after.  Both serve paths use 4 requests of one scene each,
``max_batch=2``, two-stage attention.  Any failed check raises, so the
script exits non-zero.  The kernels' JSON line carries, per kernel, its
launches on the path that ran it (``path``); ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are isolated timings (each distinct shape
timed once, L2 flushed) weighted by those launches, and ``inplace_ms`` is
the kernel's device time when that path's forwards are replayed under
``torch.profiler``.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Hopper H100 SXM peaks (NVIDIA data sheet, dense): the int8 tensor-core
# rate and HBM3 bandwidth come from the port's
# ``repro_torch.launch.roofline_util`` (read in ``main``, once the sources
# are on the path); f32 on the CUDA cores here; the special-function units
# give 16 results per clock per SM: 132 SMs x 16 x 1.83 GHz.
PEAK_INT8_OPS = PEAK_BYTES = None
PEAK_F32 = 67e12
PEAK_SFU = 132 * 16 * 1.83e9

S_FRAMES, N_PATCHES, BATCH = 8, 1024, 2
# phase 9: qwen3-14b at full width, cut to LM_LAYERS of its 40 layers (f32
# weights at full depth are ~59 GB before quantize_lm's temporaries; at 8
# layers ~16.8 GB, 6.2 GB of them the embedding and lm_head); served
# prompts of LM_PROMPT tokens (and 3/4 of that), LM_GEN new tokens each;
# the scoring forward over [2, LM_SCORE_LEN] tokens
LM_LAYERS, LM_PROMPT, LM_GEN, LM_SCORE_LEN = 8, 512, 32, 2048
# phase 10: the continuous engine's cache (the shared clock runs on while
# requests join, so it needs room past one prompt and its generation)
CONT_MAX_LEN = 1024
# phase 11: rwkv6-1.6b requests at these exact prompt lengths, RWKV_GEN new
# tokens each
RWKV_PROMPTS, RWKV_GEN = (256, 96, 200, 128, 160, 224), 32
# phase 12: deepseek-moe-16b at full width, cut to MOE_LAYERS of its 28
# layers (f32 weights: one MoE layer 2.35 GB, the full model 65.5 GB, with
# its W4 tier ~74 GB before activations; 8 layers 18.5 GB)
MOE_LAYERS = 8
# phases 13-14: phi3-mini-3.8b and paligemma-3b at full depth (f32 weights
# 15.7 and 12.2 GB); served prompts of ZOO_PROMPT tokens (and 3/4 of that),
# ZOO_GEN new tokens each
ZOO_PROMPT, ZOO_GEN = 256, 16
# phase 15: deepseek-v2-lite-16b at full width, cut to MLA_LAYERS of its 27
# layers (f32 weights: the full model 62.8 GB, beside which its W4 tier does
# not fit in 80 GB; 8 layers ~18.4 GB, 1.7 GB of them the embedding and
# lm_head); served prompts of MLA_PROMPT tokens (and 3/4 of that), MLA_GEN
# new tokens each
MLA_LAYERS, MLA_PROMPT, MLA_GEN = 8, 256, 16
# phase 16: starcoder2-7b and musicgen-large at full depth (f32 weights 29.6
# and 9.7 GB), internlm2-20b cut to DENSE_CUT of its 48 layers (79.5 GB at
# full depth does not fit 80 GB; 8 layers ~19 GB, 4.6 GB of them the
# embedding and lm_head); served prompts of DENSE_PROMPT tokens (and 3/4 of
# that), DENSE_GEN new tokens each
DENSE_CUT, DENSE_PROMPT, DENSE_GEN = 8, 256, 16
# phase 17: jamba-v0.1-52b cut to JAMBA_LAYERS of its 32 layers, one whole
# period of its pattern (7 Mamba layers, 1 attention layer, 4 MoE FFNs of 16
# experts x 14,336): f32 weights 205.6 GB at full depth, ~53 GB at 8 (one MoE
# layer 11.27 GB); prompts of exact lengths JAMBA_PROMPTS, JAMBA_GEN new
# tokens, a [2, JAMBA_SCORE_LEN] scoring forward
JAMBA_LAYERS, JAMBA_PROMPTS, JAMBA_GEN, JAMBA_SCORE_LEN = 8, (256, 192, 224, 160), 16, 1024
# phase 18: vggt-1b trained TRAIN_STEPS steps at full width and depth;
# qwen3-14b trained at full width cut to TRAIN_LM_LAYERS of its 40 layers
# (~2.9 B parameters, 1.56 B of them the embedding and lm_head: ~46 GB of
# f32 parameters, gradients and AdamW moments) on [2, TRAIN_LM_SEQ] tokens
TRAIN_STEPS, TRAIN_LM_LAYERS, TRAIN_LM_SEQ = 4, 4, 512
# phase 18 (a): the card's train step against the CPU's, at the bounds of
# tests/test_torch_train.py (the loss; each updated parameter leaf)
TRAIN_LOSS_REL, TRAIN_PARAM_REL, REMAT_REL = 1e-5, 1e-4, 1e-6
# phase 19: the sharded W4A8 forward's [2, PARALLEL_SEQ] tokens (qwen3-14b at
# LM_LAYERS); PARALLEL_DDP_STEPS steps each of the plain and the compressed
# DDP train step at phase 18's qwen3-14b shapes; PARALLEL_WARM timed calls
# of each route of the forward after its first
PARALLEL_SEQ, PARALLEL_DDP_STEPS, PARALLEL_WARM = 512, 3, 3
# phase 21: vggt-1b on the vggt_serve_s8 cell's stream (CELL_SCENES scenes of
# S_FRAMES x N_PATCHES); jamba at JAMBA_LAYERS decoding CELL_DECODE greedy
# tokens after a CELL_PROMPT-token prefill through sequence-sharded caches;
# the dry run's DRYRUN_CELLS, each a subprocess of at most DRYRUN_TIMEOUT s
CELL_SCENES, CELL_PROMPT, CELL_DECODE = 2, 64, 8
DRYRUN_CELLS = (("vggt-1b", "vggt_serve_s8"), ("jamba-v0.1-52b", "long_500k"))
DRYRUN_TIMEOUT = 420
# A fast 64-point DCT (Chen/Loeffler: N/2 log2 N multiplies and 3N/2
# log2 N adds, 192 + 576 per block) does 12 f32 operations per output: the
# least work of the fused kernels' block IDCT.  Both run a generated fast
# DCT-III (csrc/idct64.cuh) at ~10-12 operations an output.
IDCT_OPS = (64 // 2 * 6 + 3 * 64 // 2 * 6) / 64
# the two-stage kernel phase's rows at the LM paths' shapes
LM_ATTENTION_ROWS = ("qwen3 scoring", "phi3 scoring", "paligemma scoring", "dh96 ragged",
                     "dh256 ragged", "starcoder2 scoring", "musicgen scoring", "internlm2 scoring")
KERNELS = ("quant_matmul", "two_stage_attention", "fused_matmul", "fused_ffn", "norm_quant",
           "wht", "quant_matmul_batched")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global PEAK_INT8_OPS, PEAK_BYTES
    from repro_torch.launch.roofline_util import HBM_BW, PEAK_FLOPS

    PEAK_INT8_OPS, PEAK_BYTES = PEAK_FLOPS, HBM_BW
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(report)}")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kernels = phase_kernels(torch, dev)
    phase_model(torch, dev)
    unfused = phase_serve(torch, dev, fused=False)
    fused = phase_serve(torch, dev, fused=True, compare=unfused)
    paths = {"serve_unfused": unfused, "serve_fused": fused, "prologue": phase_prologue(torch, dev)}
    del unfused["outs"], fused["outs"]
    paths["server"] = phase_server(torch, dev)
    paths["schedule"] = phase_schedule(torch, dev)
    paths["lm"] = phase_lm(torch, dev)
    raw = paths["lm"].pop("raw")
    paths["lm_continuous"] = phase_lm_continuous(torch, dev, raw)
    paths["lm_schedule"] = phase_lm_schedule(torch, dev, raw)
    del raw
    paths["rwkv"] = phase_rwkv(torch, dev)
    paths["moe"] = phase_moe(torch, dev)
    paths["phi3"] = phase_phi3(torch, dev)
    paths["paligemma"] = phase_paligemma(torch, dev)
    paths["mla"] = phase_mla(torch, dev)
    paths["dense_zoo"] = phase_dense_zoo(torch, dev)
    paths["jamba"] = phase_jamba(torch, dev)
    paths["train"] = phase_train(torch, dev)
    paths["parallel"] = phase_parallel(torch, dev)
    paths["long_context"] = phase_long_context(torch, dev)
    paths["cells"] = phase_cells(torch, dev)
    out = summarize(kernels, paths)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# the path whose launches each kernel's JSON record reports (every path's
# launches, the LM path's too, are in ``launches_by_path``)
HOME = {"quant_matmul": "serve_unfused", "two_stage_attention": "serve_fused",
        "fused_matmul": "serve_fused", "fused_ffn": "serve_fused", "norm_quant": "prologue",
        "wht": "prologue", "quant_matmul_batched": "moe"}


def summarize(kernels: dict[str, dict], paths: dict[str, dict]) -> list[dict]:
    """Each kernel's record: launches on its home path (and on every path),
    timings weighted by that path's runs, in-place time from its profile."""
    out = []
    for name in KERNELS:
        k, path = kernels[name], paths[HOME[name]]
        k["path"] = HOME[name]
        k["launches"] = path["counts"].get(name, 0)
        k["launches_by_path"] = {p: v["counts"].get(name, 0) for p, v in paths.items()}
        _check(k["launches"] > 0, f"{name} was not launched on the {HOME[name]} path")
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None:
                k[key] *= path["runs"]  # forwards (or prologue passes) of that path
        k["timing"] = "isolated per-shape medians (L2 flushed) weighted by the path's launches"
        k["inplace_ms"] = path["inplace"].get(name)
        out.append(k)
    return out


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def _bound_ms(nbytes: float, int8_ops: float = 0.0, sfu: float = 0.0,
              f32_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth against each
    operation type over its own peak (they run on separate units)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(int8_ops / PEAK_INT8_OPS, sfu / PEAK_SFU, f32_ops / PEAK_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(torch, got, want) -> float:
    """Relative L2 in float64, summed over chunks of 2^26 entries: a [2,
    2048] forward's logits at paligemma-3b's vocabulary are 4.2 GB of
    float32, and whole float64 copies of two of them would take 25 GB."""
    g, w = got.reshape(-1), want.reshape(-1)
    d = r = 0.0
    for i in range(0, g.numel(), 1 << 26):
        gd, wd = g[i:i + (1 << 26)].double(), w[i:i + (1 << 26)].double()
        d += (gd - wd).square().sum().item()
        r += wd.square().sum().item()
    return math.sqrt(d) / max(math.sqrt(r), 1e-30)


def _q_flips(torch, got, want) -> int:
    """Entries of two int8 tensors that differ; raises if any differs by
    more than one step."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    _check(int(d.max()) <= 1, f"int8 outputs differ by {int(d.max())} steps")
    return int((d > 0).sum())


class _Entry:
    """One kernel's record: errors and per-forward weighted timings."""

    def __init__(self, name, source, replaces, library_note=None):
        self.d = dict(name=name, route="cuda", source=source, replaces=replaces,
                      max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      library_ms=None if library_note else 0.0)
        if library_note:
            self.d["library_note"] = library_note
        self._by = {}

    def add(self, err, nper, ms, plain, bound, by, lib=None):
        self.d["max_abs_err"] = max(self.d["max_abs_err"], err)
        if not nper:
            return
        self.d["ms"] += nper * ms
        self.d["plain_ms"] += nper * plain
        self.d["bound_ms"] += nper * bound
        if self.d["library_ms"] is not None:
            self.d["library_ms"] += nper * lib
        self._by[by] = self._by.get(by, 0.0) + nper * bound

    def done(self) -> dict:
        self.d["bound_by"] = max(self._by, key=self._by.get)
        return self.d


# ---------------------------------------------------------------------------
# phase 2: each kernel vs its plain version at the served shapes
# ---------------------------------------------------------------------------


def phase_kernels(torch, dev) -> dict[str, dict]:
    from repro_torch.configs import get_config

    cfg = get_config("vggt-1b")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    m = BATCH * S_FRAMES * (cfg.n_special_tokens + N_PATCHES)
    out = {}
    out["quant_matmul"] = _kernel_quant_matmul(torch, cfg, m, randn)
    out["two_stage_attention"] = _kernel_attention(torch, cfg, randn)
    out["fused_matmul"] = _kernel_fused_matmul(torch, dev, cfg, m, randn)
    out["fused_ffn"] = _kernel_fused_ffn(torch, dev, cfg, m, randn)
    out["norm_quant"] = _kernel_norm_quant(torch, dev, cfg, m, randn)
    out["wht"] = _kernel_wht(torch, dev, cfg, m, randn)
    out["quant_matmul_batched"] = _kernel_quant_matmul_batched(torch, randn)
    return out


def _own_randn(torch, seed: int):
    """``randn`` from a generator of its own on the card: the rows added for
    internlm2-20b, starcoder2-7b, musicgen-large and jamba-v0.1-52b draw
    from it, so every earlier row of the kernel phase keeps the inputs it
    had before them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape: torch.randn(shape, generator=gen, device="cuda")


def _kernel_quant_matmul(torch, cfg, m, randn) -> dict:
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.measure import time_ms

    d, dff = cfg.d_model, cfg.d_ff
    # (label, K, N, w_bits, launches per AA pair and forward)
    cases = [("wq/wk/wv/wo", d, d, 4, 8), ("w_up", d, dff, 4, 2), ("w_down", dff, d, 4, 2),
             ("w8 check", d, dff, 8, 0)]
    e = _Entry("quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
               "src/repro/kernels/quant_matmul.py:151")
    attrs, res = _attrs("quant_matmul", d, d, 1)  # the W4 instance, at wq's widths
    e.d.update(attrs)
    e.d["lm_cases"] = _quant_matmul_lm_rows(torch, randn)
    for label, k, n, bits, per_pair in cases:
        nper = per_pair * cfg.n_layers
        xq = quantize_per_token(randn(m, k), 8)
        wq = quantize_weight(randn(k, n), bits)
        ws = wq.scale.reshape(1, -1).contiguous()
        args = (xq.values, xq.scale, wq.values, ws)
        got = qm.quant_matmul(*args, packed=wq.packed)
        want = qm.quant_matmul_plain(*args, packed=wq.packed)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)  # integer part is exact
        del got, want
        ms = time_ms(lambda: qm.quant_matmul(*args, packed=wq.packed))
        plain = time_ms(lambda: qm.quant_matmul_plain(*args, packed=wq.packed), reps=3)
        w_cm = (unpack_int4(wq.values, 0) if wq.packed else wq.values).t().contiguous().t()
        lib = time_ms(lambda: torch._int_mm(xq.values, w_cm).float() * xq.scale * ws)
        nbytes = m * k + 4 * m + wq.values.numel() + 4 * n + 4 * m * n
        bound, by = _bound_ms(nbytes, 2.0 * m * k * n)
        print(f"quant_matmul {label:12s} M={m} K={k} N={n} W{bits}: err={err:.3g} "
              f"kernel={ms:.4f}ms plain={plain:.4f}ms int_mm={lib:.4f}ms bound={bound:.4f}ms "
              f"({by}) x{nper}/forward; {res}")
        e.add(err, nper, ms, plain, bound, by, lib)
    return e.done()


def _quant_matmul_lm_rows(torch, randn) -> dict:
    """``quant_matmul`` at the LM paths' W4 shapes: qwen3-14b decode's
    M = 2 rows (``max_batch=2``) through ``w_up``/``w_gate`` (K 5120, N
    17,408) and ``w_down`` (K 17,408), and a 1024-row prefill ``w_down``;
    rwkv6-1.6b decode's M = 4 slots through the time-mix projections
    (2048 x 2048), the channel-mix ``w_up`` (2048 x 7168) and ``w_down``
    (7168 x 2048); deepseek-v2-lite-16b's MLA sites at decode's M 1 and 4
    and a 1024-row prefill: ``wq`` (K 2048, N 3072), ``w_kv_down`` (K
    2048, N 576: its last 256-column tile holds 64 columns) and
    ``w_k_up``/``w_v_up`` (K 512, N 2048); starcoder2-7b's ``w_up`` (K 4608,
    N 18,432) and ``w_down`` (K 18,432, N 4608) and jamba-v0.1-52b's Mamba
    ``w_in`` (K 4096, N 16,384) and ``w_out`` (K 8192, N 4096) at M 2 and
    1024; each against its plain version,
    timed beside its bound and, where ``torch._int_mm`` takes the shape (M >
    16), the library call.  These rows are not weighted into the record's
    vggt-1b totals."""
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.measure import time_ms

    rows = {}
    zoo_randn = _own_randn(torch, 29)
    for label, m, k, n in (("qwen3 decode w_up", 2, 5120, 17408),
                           ("qwen3 decode w_down", 2, 17408, 5120),
                           ("qwen3 prefill w_down", 1024, 17408, 5120),
                           ("rwkv6 decode wr..wo", 4, 2048, 2048),
                           ("rwkv6 decode w_up", 4, 2048, 7168),
                           ("rwkv6 decode w_down", 4, 7168, 2048),
                           *((f"mla {site} M{m}", m, k, n) for site, k, n in
                             (("wq", 2048, 3072), ("w_kv_down", 2048, 576),
                              ("w_k_up/w_v_up", 512, 2048)) for m in (1, 4, 1024)),
                           *((f"{site} M{m}", m, k, n) for site, k, n in
                             (("starcoder2 w_up", 4608, 18432),
                              ("starcoder2 w_down", 18432, 4608),
                              ("jamba w_in", 4096, 16384), ("jamba w_out", 8192, 4096))
                             for m in (2, 1024))):
        rnd = zoo_randn if label.startswith(("starcoder2", "jamba")) else randn
        xq = quantize_per_token(rnd(m, k), 8)
        wq = quantize_weight(rnd(k, n), 4)
        ws = wq.scale.reshape(1, -1).contiguous()
        args = (xq.values, xq.scale, wq.values, ws)
        got = qm.quant_matmul(*args, packed=True)
        want = qm.quant_matmul_plain(*args, packed=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        ms = time_ms(lambda: qm.quant_matmul(*args, packed=True))
        plain = time_ms(lambda: qm.quant_matmul_plain(*args, packed=True), reps=3)
        nbytes = m * k + 4 * m + wq.values.numel() + 4 * n + 4 * m * n
        bound, by = _bound_ms(nbytes, 2.0 * m * k * n)
        lib, note = None, "torch._int_mm needs M > 16 rows"
        if m > 16:
            w_cm = unpack_int4(wq.values, 0).t().contiguous().t()
            lib = time_ms(lambda: torch._int_mm(xq.values, w_cm).float() * xq.scale * ws)
            note = None
        rows[label] = dict(m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib, library_note=note)
        print(f"quant_matmul {label:24s} M={m} K={k} N={n} W4: err={err:.3g} "
              f"kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"int_mm={'n/a (' + note + ')' if lib is None else f'{lib:.4f}ms'} "
              f"bound={bound:.4f}ms ({by}), {ms / bound:.2f}x bound")
        del got, want, xq, wq
    return rows


def _kernel_quant_matmul_batched(torch, randn) -> dict:
    """``quant_matmul``'s batched launch at deepseek-moe-16b's routed experts
    (E 64, W4; the routed experts' weights are those of one layer): gate/up
    (K 2048, N 1408) and down (K 1408, N 2048) at M 120, each expert's
    capacity in a 2 x 512 prefill, and at M 1, decode's.  Each against its
    plain version, timed beside its bound and, where ``torch._int_mm`` takes
    the shape (M > 16), a per-expert loop of ``torch._int_mm`` and the
    scaling (no one PyTorch call computes the batched function).  The
    record's totals weight each shape by its launches in one 2 x 512 prefill
    and one decode step through ``MOE_LAYERS - 1`` MoE layers."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.measure import time_ms
    from repro_torch.models.ffn import _cap

    cfg = get_config("deepseek-moe-16b")
    e, d, dff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    cap = _cap(cfg, BATCH * LM_PROMPT)
    # (label, M, K, N, launches per MoE layer)
    cases = [("prefill gate/up", cap, d, dff, 2), ("prefill down", cap, dff, d, 1),
             ("decode gate/up", 1, d, dff, 2), ("decode down", 1, dff, d, 1)]
    ent = _Entry("quant_matmul_batched", "src/repro_torch/csrc/quant_matmul.cu",
                 "src/repro/kernels/quant_matmul.py:151",
                 library_note="no one PyTorch call: torch._int_mm is 2-D; moe_cases time a "
                              "per-expert torch._int_mm + scaling loop where M > 16")
    rows = {}
    for label, m, k, n, per in cases:
        xq = quantize_per_token(randn(e, m, k), 8)
        wqs = [quantize_weight(randn(k, n), 4) for _ in range(e)]
        wv = torch.stack([w.values for w in wqs])
        ws = torch.stack([w.scale.reshape(1, -1) for w in wqs])
        del wqs
        args = (xq.values, xq.scale, wv, ws)
        got = qm.quant_matmul_batched(*args, packed=True)
        want = qm.quant_matmul_batched_plain(*args, packed=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)  # integer part is exact
        del got, want
        ms = time_ms(lambda: qm.quant_matmul_batched(*args, packed=True))
        plain = time_ms(lambda: qm.quant_matmul_batched_plain(*args, packed=True), reps=3)
        bound, by = _bound_ms(qm.batched_function_bytes(e, e, m, k, n, packed=True),
                              2.0 * e * m * k * n)
        lib = None
        if m > 16:
            w_cm = [unpack_int4(wv[j], 0).t().contiguous().t() for j in range(e)]

            def loop(w_cm=w_cm, args=args):
                xv, xs, _, ws_ = args
                return [torch._int_mm(xv[j], w_cm[j]).float() * xs[j] * ws_[j] for j in range(e)]

            lib = time_ms(loop)
            del w_cm
        rows[label] = dict(e=e, m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib,
                           library_note=None if lib is not None else
                           "torch._int_mm needs M > 16 rows")
        print(f"quant_matmul_batched {label:16s} E={e} M={m} K={k} N={n} W4: err={err:.3g} "
              f"kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"int_mm loop={'n/a (M <= 16)' if lib is None else f'{lib:.4f}ms'} "
              f"bound={bound:.4f}ms ({by}), {ms / bound:.2f}x bound")
        ent.add(err, per * (MOE_LAYERS - 1), ms, plain, bound, by)
        del xq, wv, ws, args
    out = ent.done()
    out["moe_cases"] = rows
    out["moe_cases"].update(_jamba_expert_rows(torch, _own_randn(torch, 30)))
    return out


def _jamba_expert_rows(torch, randn) -> dict:
    """The batched launch at jamba-v0.1-52b's routed experts (E 16, W4):
    gate/up (K 4096, N 14,336) and down (K 14,336, N 4096) at M 1,
    decode's, and at a 2 x 512 prefill's capacity; each against its plain
    version, timed beside its bound and, where M > 16, a per-expert
    ``torch._int_mm`` loop.  Not weighted into the record's totals."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import quantize_per_token, quantize_weight, unpack_int4
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.measure import time_ms
    from repro_torch.models.ffn import _cap

    cfg = get_config("jamba-v0.1-52b")
    e, d, dff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    cap = _cap(cfg, BATCH * 512)
    rows = {}
    for label, m, k, n in (("jamba prefill gate/up", cap, d, dff),
                           ("jamba prefill down", cap, dff, d),
                           ("jamba decode gate/up", 1, d, dff), ("jamba decode down", 1, dff, d)):
        xq = quantize_per_token(randn(e, m, k), 8)
        wqs = [quantize_weight(randn(k, n), 4) for _ in range(e)]
        wv = torch.stack([w.values for w in wqs])
        ws = torch.stack([w.scale.reshape(1, -1) for w in wqs])
        del wqs
        args = (xq.values, xq.scale, wv, ws)
        got = qm.quant_matmul_batched(*args, packed=True)
        want = qm.quant_matmul_batched_plain(*args, packed=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)  # integer part is exact
        del got, want
        ms = time_ms(lambda: qm.quant_matmul_batched(*args, packed=True))
        plain = time_ms(lambda: qm.quant_matmul_batched_plain(*args, packed=True), reps=3)
        bound, by = _bound_ms(qm.batched_function_bytes(e, e, m, k, n, packed=True),
                              2.0 * e * m * k * n)
        lib = None
        if m > 16:
            w_cm = [unpack_int4(wv[j], 0).t().contiguous().t() for j in range(e)]

            def loop(w_cm=w_cm, args=args):
                xv, xs, _, ws_ = args
                return [torch._int_mm(xv[j], w_cm[j]).float() * xs[j] * ws_[j] for j in range(e)]

            lib = time_ms(loop)
            del w_cm
        rows[label] = dict(e=e, m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib,
                           library_note=None if lib is not None else
                           "torch._int_mm needs M > 16 rows")
        print(f"quant_matmul_batched {label:22s} E={e} M={m} K={k} N={n} W4: err={err:.3g} "
              f"kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"int_mm loop={'n/a (M <= 16)' if lib is None else f'{lib:.4f}ms'} "
              f"bound={bound:.4f}ms ({by}), {ms / bound:.2f}x bound")
        del xq, wv, ws, args
    return rows


def _attrs(kernel: str, *args) -> tuple[dict, str]:
    """A kernel's resources from ``vq_<kernel>_attrs(*args)``, and their line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.measure import kernel_attrs

    a = kernel_attrs(_build.load(kernel), kernel, *args)
    return a, (f"regs={a['registers']} smem/block={a['smem_per_block']}B "
               f"blocks/SM={a['blocks_per_sm']} spill={a['spill_bytes']}B")


def _kernel_attention(torch, cfg, randn) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import two_stage_attention as tsa
    from repro_torch.kernels.measure import attention_inputs, pq_flips, time_ms

    h, dh = cfg.n_heads, cfg.head_dim
    t = cfg.n_special_tokens + N_PATCHES
    # (label, B, H, Hkv, Lq, Lk, dh, causal, launches per forward of the fused
    # path); the LM rows (LM_ATTENTION_ROWS: one layer of a [2, 2048] scoring
    # forward of qwen3-14b, phi3-mini-3.8b, paligemma-3b, starcoder2-7b
    # (GQA groups of 9), musicgen-large (causal dh 64) and internlm2-20b
    # (groups of 6), and a ragged non-causal check at dh 96 and 256) are
    # recorded apart in ``lm_cases``
    L = LM_SCORE_LEN
    cases = [("frame", BATCH * S_FRAMES, h, h, t, t, dh, False, cfg.n_layers),
             ("global", BATCH, h, h, S_FRAMES * t, S_FRAMES * t, dh, False, cfg.n_layers),
             ("causal check", 1, 4, 4, 300, 300, dh, True, 0),
             ("gqa check", 1, 8, 2, 500, 500, dh, False, 0),
             ("qwen3 scoring", 2, 40, 8, L, L, 128, True, 0),
             ("phi3 scoring", 2, 32, 32, L, L, 96, True, 0),
             ("paligemma scoring", 2, 8, 1, L, L, 256, True, 0),
             ("dh96 ragged", 1, 4, 4, 1000, 1500, 96, False, 0),
             ("dh256 ragged", 1, 8, 1, 1000, 1500, 256, False, 0),
             ("starcoder2 scoring", 2, 36, 4, L, L, 128, True, 0),
             ("musicgen scoring", 2, 32, 32, L, L, 64, True, 0),
             ("internlm2 scoring", 2, 48, 8, L, L, 128, True, 0)]
    e = _Entry("two_stage_attention", "src/repro_torch/csrc/two_stage_attention.cu",
               "src/repro/kernels/two_stage_attention.py:210")
    res = {}
    for d in (32, 64, 96, 128, 256):  # every instance's resources; none may spill
        a, res[d] = _attrs("two_stage_attention", d, 1.0 / math.sqrt(d))
        print(f"two_stage_attention dh {d} instance: {res[d]}")
        _check(a["spill_bytes"] == 0, f"two_stage_attention dh {d} spills: {a}")
        if d == dh:
            e.d.update(a)
        else:
            e.d[f"attrs_dh{d}"] = a
    e.d.update(pq_flips={}, lm_cases={})
    zoo_randn = _own_randn(torch, 31)
    for label, b, hq, hkv, lq, lk, dh, causal, nper in cases:
        lm_row = label in LM_ATTENTION_ROWS
        rnd = zoo_randn if label.startswith(("starcoder2", "musicgen", "internlm2")) else randn
        args, gqa, vscale = attention_inputs(rnd, b, hq, hkv, lq, dh, lk=lk)
        got = tsa.two_stage_attention(*args, causal=causal, **gqa)
        want = tsa.two_stage_attention_plain(*args, causal=causal, **gqa)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
        del got, want
        ms = time_ms(lambda: tsa.two_stage_attention(*args, causal=causal, **gqa))
        plain = time_ms(lambda: tsa.two_stage_attention_plain(*args, causal=causal, **gqa),
                        reps=2, warmup=1)
        # top-left causal at Lq == Lk: row r sees keys 0..r
        pairs = lq * (lq + 1) / 2 if causal else float(lq) * lk
        nbytes = (b * hq * lq * (dh + 4) + 2 * b * hkv * lk * dh + b * hkv * lk * 4
                  + 4 * b * hq + 4 * b * hq * lq * dh)
        # the function's own work, not the kernel's: QK^T once and P.V once
        # (2 ops per multiply-add), and one exp per score (the row max needs
        # none; p = exp(s - m) then feeds both l and pq)
        bound, by = _bound_ms(nbytes, 4.0 * b * hq * pairs * dh, sfu=1.0 * b * hq * pairs)
        lib = flips = None
        if nper or lm_row:  # the yardstick: bf16 SDPA on the dequantized tensors, made once
            qf = (args[0].float() * args[1]).to(torch.bfloat16).view(b, hq, lq, dh)
            kf = (args[2].float() * args[3]).to(torch.bfloat16).view(b, hkv, lk, dh)
            vf = (args[4].float() * vscale).to(torch.bfloat16).view(b, hkv, lk, dh)
            sdpa = dict(is_causal=causal, enable_gqa=hq != hkv)
            lib = time_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf, **sdpa))
            ref = F.scaled_dot_product_attention(qf, kf, vf, **sdpa).float()
            ref = ref.view(b * hq, lq, dh)
            rel = ((ref - tsa.two_stage_attention(*args, causal=causal, **gqa)).norm()
                   / ref.norm()).item()
            print(f"  two-stage int8 vs bf16 SDPA rel L2 = {rel:.3g}")
            del qf, kf, vf, ref
            flips, n = pq_flips(args)
            e.d["pq_flips"][label] = [flips, n]
            print(f"  pq flips vs plain (head 0, no mask): {flips} of {n}")
        print(f"two_stage_attention {label:17s} B={b} H={hq} Hkv={hkv} Lq={lq} Lk={lk} dh={dh} "
              f"causal={causal}: err={err:.3g} kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"sdpa={'n/a' if lib is None else f'{lib:.4f}ms'} bound={bound:.4f}ms ({by}) "
              f"x{ms / bound:.1f} bound, x{nper}/forward; {res[dh]}")
        if lm_row:
            e.d["lm_cases"][label] = dict(
                b=b, h=hq, hkv=hkv, lq=lq, lk=lk, dh=dh, causal=causal, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                pq_flips=[flips, n])
            e.d["max_abs_err"] = max(e.d["max_abs_err"], err)
            continue
        e.add(err, nper, ms, plain, bound, by, lib)
    return e.done()


# Tolerances of the fused kernels against their plain versions.  Both
# quantize the same float values, but the kernels' sums (norm statistics,
# the H_128 factor, the IDCT) run in another order, so an int8 value within
# an ulp of a rounding boundary may differ by one step (~1 in 1e5).  So:
# int8 outputs within ±1 on at most 0.1% of entries; float outputs fed by
# an in-kernel quantization within rel L2 1e-3 of the plain version (one
# flipped input entry moves its row by ~1e-3), and within 1e-5 of the plain
# version fed the kernel's own int8 prologue output (norm_quant runs the
# same device code); the FFN, whose hidden is requantized in the kernel,
# within 1e-3.
FLIP_SHARE = 1e-3


def _fused_ops(m, k, n, *, prologue, idct, wht_block=None, act=False):
    """f32 operations (and special-function results) of one fused linear:
    the IDCT's ``IDCT_OPS`` per output, the prologue's ~5 per input element
    plus the WHT's log2(block) adds, 3 per output for scale and bias, and
    the activation's ~8 plus one tanh/exp per output."""
    f32 = m * n * (3 + (IDCT_OPS if idct else 0) + (8 if act else 0))
    if prologue:
        f32 += m * k * (5 + (math.log2(wht_block) if wht_block else 0))
    return f32, (m * n if act else 0)


def _kernel_fused_matmul(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.core import versaq as V
    from repro_torch.core.quantize import quantize_per_token, quantize_weight
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import time_ms

    d = cfg.d_model
    u = V.make_folded_norm("ln", d, device=dev).u
    # (label, M, K, N, w_bits, a_bits, norm, pro WHT, act, epi WHT, requant, IDCT,
    #  pre-quantized, launches per forward of the fused path)
    cases = [
        ("wqkv", m, d, 3 * d, 4, 8, "ln", False, "none", False, None, True, False, 2 * cfg.n_layers),
        ("wo", m, d, d, 4, 8, None, False, "none", False, None, True, False, 2 * cfg.n_layers),
        ("w8 ragged M", 1000, d, d, 8, 8, "rms", True, "none", False, None, True, False, 0),
        ("a4 gelu", 1000, d, 1024, 4, 4, "ln", True, "gelu", False, None, True, False, 0),
        ("requant a8", 1000, d, 4096, 4, 8, None, False, "gelu", True, 8, False, False, 0),
        ("requant a4", 777, d, 1024, 8, 4, "rms", False, "silu", True, 4, True, False, 0),
        ("prequant", 1000, 4096, d, 4, 8, None, False, "none", False, None, True, True, 0),
        # a planned tier's A4 wqkv (phase 8): the served shape, A4 prologue
        ("wqkv a4", m, d, 3 * d, 4, 4, "ln", False, "none", False, None, True, False, 0),
    ]
    e = _Entry("fused_matmul", "src/repro_torch/csrc/fused_matmul.cu",
               "src/repro/kernels/fused.py:358",
               library_note="no single PyTorch call computes norm+WHT+quantize+int matmul+IDCT")
    attrs, res = _attrs("fused_matmul", 3 * d, d, 0, 0)  # at wqkv's widths
    e.d.update(attrs)
    e.d["lm_cases"] = _fused_matmul_lm_rows(torch, randn)
    for (label, mm, k, n, wb, ab, norm, pwht, act, ewht, rq, idct, preq, nper) in cases:
        wq = quantize_weight(randn(k, n) / math.sqrt(k), wb)
        ws = wq.scale.reshape(1, -1).contiguous()
        bias = randn(n)
        x = randn(mm, k)
        pro_b = k if pwht else None
        kw = dict(packed=wq.packed, a_bits=ab, norm_kind=norm, pro_wht_block=pro_b, act=act,
                  epi_wht_block=n if ewht else None, requant_bits=rq,
                  dct_block=64 if idct else None)
        xs, nu = None, (u if norm == "ln" else None)
        if preq:
            xq = quantize_per_token(x, ab)
            x, xs = xq.values, xq.scale
            kw.update(norm_kind=None, pro_wht_block=None)
        args = (x, wq.values, ws, xs, bias, nu)
        got = fz.fused_matmul(*args, **kw)
        want = fz.fused_matmul_plain(*args, **kw)
        torch.cuda.synchronize()
        if rq is None:
            err = (got - want).abs().max().item()
            rel = _rel(torch, got, want)
            _check(rel < (1e-5 if preq else 1e-3), f"fused_matmul {label}: rel L2 {rel}")
            note = f"rel={rel:.3g}"
            if not preq:
                q, s = fz.norm_quant(x, nu, norm_kind=norm, wht_block=pro_b, a_bits=ab)
                exact = fz.fused_matmul_plain(q, wq.values, ws, s, bias, **{**kw, "norm_kind": None})
                rel_x = _rel(torch, got, exact)
                _check(rel_x < 1e-5, f"fused_matmul {label}: vs its own prologue {rel_x}")
                note += f" rel(own prologue)={rel_x:.3g}"
        else:
            flips = _q_flips(torch, got[0], want[0])
            _check(flips <= FLIP_SHARE * got[0].numel(), f"fused_matmul {label}: {flips} flips")
            # the per-token scales are held against the plain version fed the
            # kernel's own prologue (norm_quant, the in-kernel prologue's
            # device code), as the float cases are: a +-1 prologue flip moves
            # a scale of the plain version's own prologue by ~1.5e-5
            # (tools/fused_requant_margin.py), which that reading still shows
            q, s = fz.norm_quant(x, nu, norm_kind=norm, wht_block=pro_b, a_bits=ab)
            exact = fz.fused_matmul_plain(q, wq.values, ws, s, bias, **{**kw, "norm_kind": None})
            torch.testing.assert_close(got[1], exact[1], rtol=1e-5, atol=0)
            err = (got[1] - exact[1]).abs().max().item()
            own = ((got[1] - exact[1]).abs() / exact[1].abs()).max().item()
            vs_plain = ((got[1] - want[1]).abs() / want[1].abs()).max().item()
            note = (f"int8 flips={flips} (vs own prologue {_q_flips(torch, got[0], exact[0])}) "
                    f"scale max rel: own prologue {own:.3g}, plain version's {vs_plain:.3g}")
            del exact
        del got, want
        ms = time_ms(lambda: fz.fused_matmul(*args, **kw))
        plain = time_ms(lambda: fz.fused_matmul_plain(*args, **kw), reps=3, warmup=1)
        in_bytes = mm * k + 4 * mm if preq else 4 * mm * k + (4 * k if nu is not None else 0)
        out_bytes = mm * n + 4 * mm if rq else 4 * mm * n
        nbytes = in_bytes + wq.values.numel() + 8 * n + (16384 if idct else 0) + out_bytes
        f32, sfu = _fused_ops(mm, k, n, prologue=not preq, idct=idct, wht_block=pro_b,
                              act=act != "none")
        if ewht:
            f32 += mm * n * (math.log2(n) + 2)
        bound, by = _bound_ms(nbytes, 2.0 * mm * k * n, sfu=sfu, f32_ops=f32)
        print(f"fused_matmul {label:12s} M={mm} K={k} N={n} W{wb}A{ab} norm={norm} "
              f"pro_wht={pwht} act={act} epi_wht={ewht} requant={rq} idct={idct} prequant={preq}: "
              f"err={err:.3g} {note} kernel={ms:.4f}ms plain={plain:.4f}ms bound={bound:.4f}ms "
              f"({by}) x{nper}/forward; {res}")
        e.add(err, nper, ms, plain, bound, by)
    return e.done()


def _fused_matmul_lm_rows(torch, randn) -> dict:
    """``fused_matmul`` at deepseek-moe-16b's fused sites under a
    ``w4a8:fused`` schedule (``phase_lm_schedule``): ``wqkv`` (K 2048, N
    6144, the RMS norm absorbed into the prologue, W4A8, IDCT, no bias) and
    ``wo`` with its epilogue (K 2048, N 2048, the input quantized in the
    prologue, IDCT), at a 2 x 512 prefill wave's M = 1024 and decode's M = 1
    and 4; the flags are read off the compiled schedule.  Each against its
    plain version (rel L2 < 1e-3) and against the plain version fed the
    kernel's own prologue (< 1e-5), timed beside its bound; no PyTorch call
    computes the function.  Not weighted into the record's vggt-1b totals."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPlan, compile_schedule
    from repro_torch.core.quantize import quantize_weight
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import time_ms

    sched = compile_schedule(get_config("deepseek-moe-16b").with_(n_layers=2),
                             PrecisionPlan(default="w4a8", use_kernel=True, fuse=True))
    sites = {"wqkv": sched.site("blocks.l0.mixer.wq"), "wo": sched.site("blocks.l0.mixer.wo")}
    rows = {}
    for name, site in sites.items():
        k = site.d_in
        n = 3 * site.d_out if name == "wqkv" else site.d_out
        norm = site.prologue["norm"] if site.prologue else None
        wq = quantize_weight(randn(k, n) / math.sqrt(k), 4)
        ws = wq.scale.reshape(1, -1).contiguous()
        kw = dict(packed=True, a_bits=8, norm_kind=norm, pro_wht_block=None, act="none",
                  epi_wht_block=None, requant_bits=None, dct_block=64 if site.idct else None)
        for m in (1024, 1, 4):
            label = f"deepseek {name} {'prefill' if m > 4 else 'decode'}"
            x = randn(m, k)
            args = (x, wq.values, ws, None, None, None)
            got = fz.fused_matmul(*args, **kw)
            want = fz.fused_matmul_plain(*args, **kw)
            q, sc = fz.norm_quant(x, None, norm_kind=norm, wht_block=None, a_bits=8)
            exact = fz.fused_matmul_plain(q, wq.values, ws, sc, None, **{**kw, "norm_kind": None})
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel, rel_x = _rel(torch, got, want), _rel(torch, got, exact)
            _check(rel < 1e-3 and rel_x < 1e-5, f"fused_matmul {label} M={m}: rel L2 {rel}, vs "
                                                f"its own prologue {rel_x}")
            del got, want, exact
            ms = time_ms(lambda: fz.fused_matmul(*args, **kw))
            plain = time_ms(lambda: fz.fused_matmul_plain(*args, **kw), reps=3, warmup=1)
            nbytes = 4 * m * k + wq.values.numel() + 8 * n + 16384 + 4 * m * n
            f32, sfu = _fused_ops(m, k, n, prologue=True, idct=site.idct)
            bound, by = _bound_ms(nbytes, 2.0 * m * k * n, sfu=sfu, f32_ops=f32)
            rows[f"{label} M={m}"] = dict(m=m, k=k, n=n, norm=norm, max_abs_err=err, rel=rel,
                                          ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                          library_ms=None)
            print(f"fused_matmul {label:22s} M={m} K={k} N={n} W4A8 norm={norm} idct={site.idct}: "
                  f"err={err:.3g} rel={rel:.3g} rel(own prologue)={rel_x:.3g} kernel={ms:.4f}ms "
                  f"plain={plain:.4f}ms bound={bound:.4f}ms ({by}), {ms / bound:.2f}x bound")
    return rows


def _kernel_fused_ffn(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import ffn_inputs, time_ms

    d, dff = cfg.d_model, cfg.d_ff
    # (label, M, D, d_ff, w_bits, a_bits in, a_bits mid, gated, norm, input WHT,
    #  launches per forward); the A4 cases are a planned tier's FFNs (phase 8)
    cases = [("vggt-1b FFN", m, d, dff, 4, 8, 8, False, "ln", False, 2 * cfg.n_layers),
             ("gated silu", 1000, d, 2816, 4, 8, 8, True, "rms", False, 0),
             ("w8 input wht", 333, 512, 1536, 8, 8, 8, True, None, True, 0),
             ("a4 in a8 mid", m, d, dff, 4, 4, 8, False, "ln", False, 0),
             ("a4 in a4 mid", m, d, dff, 4, 4, 4, False, "ln", False, 0)]
    e = _Entry("fused_ffn", "src/repro_torch/csrc/fused_ffn.cu", "src/repro/kernels/fused.py:512",
               library_note="no single PyTorch call computes the quantized FFN layer")
    attrs, res = _attrs("fused_ffn", d, dff, 1)  # at the served widths
    e.d.update(attrs)
    for label, mm, dd, ff, wb, ab, ab_mid, gated, norm, pwht, nper in cases:
        args, kw = ffn_inputs(randn, mm, dd, ff, w_bits=wb, a_bits=ab, a_bits_mid=ab_mid,
                              gated=gated, norm=norm, pro_wht=pwht)
        hblock = kw["mid_wht_block"]
        got = fz.fused_ffn(*args, **kw)
        want = fz.fused_ffn_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = _rel(torch, got, want)
        _check(rel < 1e-3, f"fused_ffn {label}: rel L2 {rel}")
        del got, want
        per_sm = fz._blocks_per_sm("fused_ffn", dev, dd, ff, 1)
        grid = fz.grid_for(dev, -(-mm // fz.FFN_BM), per_sm)
        scratch = grid * fz.FFN_BM * (4 * ff + max(dd, ff)) / 1e6
        ms = time_ms(lambda: fz.fused_ffn(*args, **kw))
        plain = time_ms(lambda: fz.fused_ffn_plain(*args, **kw), reps=3, warmup=1)
        wbytes = sum(w.numel() for w in (args[1], args[3], args[5]) if w is not None)
        nbytes = 4 * mm * dd * 2 + wbytes + 4 * (3 * ff + 2 * dd) + 16384
        mats = 3 if gated else 2
        int8 = 2.0 * mm * dd * ff * (mats - 1) + 2.0 * mm * ff * dd
        f32 = (mm * dd * (5 + (math.log2(dd) if pwht else 0))  # prologue
               + mm * ff * (mats - 1) * (3 + IDCT_OPS)  # gate/up: scale, IDCT, bias
               + mm * ff * (8 + math.log2(hblock) + 2 + 3)  # act, hidden WHT, requant
               + mm * dd * (3 + IDCT_OPS))  # down: scale, IDCT, bias
        bound, by = _bound_ms(nbytes, int8, sfu=mm * ff, f32_ops=f32)
        print(f"fused_ffn {label:12s} M={mm} D={dd} d_ff={ff} W{wb}A{ab}/A{ab_mid} gated={gated} "
              f"norm={norm} input_wht={pwht}: err={err:.3g} rel={rel:.3g} kernel={ms:.4f}ms "
              f"plain={plain:.4f}ms bound={bound:.4f}ms ({by}) x{nper}/forward; grid {grid} "
              f"blocks ({per_sm}/SM), scratch {scratch:.1f} MB; {res}")
        e.add(err, nper, ms, plain, bound, by)
    return e.done()


def _kernel_norm_quant(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.core import versaq as V
    from repro_torch.kernels import fused as fz
    from repro_torch.kernels.measure import time_ms

    d = cfg.d_model
    # (label, M, D, norm, WHT, bits, launches per prologue pass): the served
    # call, then one case for each other instance the kernel dispatches to
    # (register rows of 1, 2, 4, 16 and 32 chunks a lane; the shared-memory
    # routine for D % 128 != 0)
    cases = [("served ln+wht", m, d, "ln", True, 8, 1), ("rms a4 ragged", 999, 4096, "rms", True, 4, 0),
             ("none no-wht", 1000, 768, None, False, 8, 0), ("ln D=128", 777, 128, "ln", True, 8, 0),
             ("rms D=256", 500, 256, "rms", True, 4, 0), ("ln D=512", 600, 512, "ln", True, 8, 0),
             ("ln D=2048", 1000, 2048, "ln", True, 8, 0), ("ln D=96 smem", 333, 96, "ln", True, 8, 0)]
    e = _Entry("norm_quant", "src/repro_torch/csrc/norm_quant.cu", "src/repro/kernels/fused.py:195",
               library_note="no single PyTorch call computes norm+WHT+per-token quantization")
    e.d.update(_attrs("norm_quant", d)[0])  # at the served width
    for label, mm, dd, norm, wht, bits, nper in cases:
        x = randn(mm, dd)
        kw = dict(norm_kind=norm, wht_block=(dd & -dd) if wht else None, a_bits=bits)
        nu = V.make_folded_norm("ln", dd, device=dev).u if norm == "ln" else None
        q, s = fz.norm_quant(x, nu, **kw)
        wq, ws = fz.norm_quant_plain(x, nu, **kw)
        torch.cuda.synchronize()
        flips = _q_flips(torch, q, wq)
        _check(flips <= FLIP_SHARE * q.numel(), f"norm_quant {label}: {flips} flips")
        torch.testing.assert_close(s, ws, rtol=1e-5, atol=0)
        err = (s - ws).abs().max().item()
        ms = time_ms(lambda: fz.norm_quant(x, nu, **kw))
        plain = time_ms(lambda: fz.norm_quant_plain(x, nu, **kw), reps=5)
        f32 = mm * dd * (5 + (math.log2(kw["wht_block"]) + 2 if wht else 0) + 3)
        nbytes = 5 * mm * dd + 4 * mm
        bound, by = _bound_ms(nbytes, f32_ops=f32)
        print(f"norm_quant {label:14s} M={mm} D={dd} norm={norm} wht={wht} A{bits}: "
              f"scale err={err:.3g} int8 flips={flips} kernel={ms:.4f}ms "
              f"({nbytes / ms / 1e9:.3f} TB/s) plain={plain:.4f}ms bound={bound:.4f}ms ({by}) "
              f"x{nper}/pass; {_attrs('norm_quant', dd)[1]}")
        e.add(err, nper, ms, plain, bound, by)
    return e.done()


def _kernel_wht(torch, dev, cfg, m, randn) -> dict:
    from repro_torch.core import transforms
    from repro_torch.kernels import wht as whtk
    from repro_torch.kernels.measure import time_ms

    # the served call, then one case for each other instance the kernel
    # dispatches to (register rows of 1, 2, 4, 8 and 16 chunks a lane; the
    # shared-memory routine for d % 128 != 0)
    cases = [("ffn hidden", m, cfg.d_ff, None, 1), ("d=1024 blk128", 1000, 1024, 128, 0),
             ("d=64", 999, 64, None, 0), ("d=128", 700, 128, None, 0),
             ("d=256 blk64", 500, 256, 64, 0), ("d=512", 600, 512, None, 0),
             ("d=2048", 1000, 2048, None, 0)]
    e = _Entry("wht", "src/repro_torch/csrc/wht.cu", "src/repro/kernels/wht.py:74")
    e.d.update(_attrs("wht", cfg.d_ff)[0])  # at the served width
    for label, r, d, block, nper in cases:
        x = randn(r, d)
        got = whtk.wht(x, block=block)
        want = whtk.wht_plain(x, block=block)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = _rel(torch, got, want)
        _check(rel < 1e-6, f"wht {label}: rel L2 {rel}")
        blk = block or transforms.block_size_for(d)
        ms = time_ms(lambda: whtk.wht(x, block=block))
        plain = time_ms(lambda: whtk.wht_plain(x, block=block), reps=5)
        # the yardstick: one f32 matmul with the blocked Hadamard (TF32 off)
        hb = transforms.hadamard_matrix(blk, device=dev)
        xb = x.view(r, d // blk, blk)
        lib = time_ms(lambda: torch.matmul(xb, hb))
        lrel = _rel(torch, torch.matmul(xb, hb).view(r, d), want)
        nbytes = 8.0 * r * d
        bound, by = _bound_ms(nbytes, f32_ops=r * d * (math.log2(blk) + 2))
        print(f"wht {label:14s} R={r} d={d} block={blk}: err={err:.3g} rel={rel:.3g} "
              f"kernel={ms:.4f}ms ({nbytes / ms / 1e9:.3f} TB/s) plain={plain:.4f}ms "
              f"matmul={lib:.4f}ms (rel {lrel:.3g}) bound={bound:.4f}ms ({by}) x{nper}/pass; "
              f"{_attrs('wht', d)[1]}")
        e.add(err, nper, ms, plain, bound, by, lib)
    return e.done()


# ---------------------------------------------------------------------------
# phase 3: whole model, kernels vs plain versions
# ---------------------------------------------------------------------------


class _PlainKernels:
    """Route the kernel wrappers to their plain versions for CUDA tensors
    too, for the duration of a with-block (the comparison runs only)."""

    def _mods(self):
        from repro_torch.kernels import fused as fz
        from repro_torch.kernels import quant_matmul as qm
        from repro_torch.kernels import two_stage_attention as tsa
        from repro_torch.kernels import wht as whtk

        return [(qm, "quant_matmul"), (tsa, "two_stage_attention"), (fz, "fused_matmul"),
                (fz, "fused_ffn"), (fz, "norm_quant"), (whtk, "wht"),
                (qm, "quant_matmul_batched")]

    def __enter__(self):
        self._saved = []
        for mod, name in self._mods():
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, f"{name}_plain"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _rel_l2(torch, got: dict, want: dict) -> dict:
    return {k: ((got[k] - want[k]).norm() / want[k].norm()).item()
            for k in ("pose", "points", "depth")}


def _scenes(torch, dev, n: int, step: int):
    from repro_torch.data.pipeline import scene_batch

    return torch.as_tensor(scene_batch(n, S_FRAMES, N_PATCHES, 1024, step, seed=0)["patches"],
                           device=dev)


def _plan(fused: bool):
    from repro_torch.core.precision.plan import PrecisionPlan

    return PrecisionPlan(default="w4a8", use_kernel=True, fuse=fused)


def phase_model(torch, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_vggt
    from repro_torch.kernels import probe
    from repro_torch.kernels.measure import time_ms
    from repro_torch.models import vggt

    cfg = get_config("vggt-1b").with_(n_layers=2, attn_impl="two_stage")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(2))
    x = _scenes(torch, dev, BATCH, step=100)
    want_launches = {False: {"quant_matmul": 24, "two_stage_attention": 4},
                     True: {"fused_matmul": 8, "fused_ffn": 4, "two_stage_attention": 4}}
    trees = {}
    for fused in (False, True):
        with torch.inference_mode():
            qp = trees[fused] = quantize_vggt(cfg, params, _plan(fused))
            with probe.tracking() as log:
                got = vggt.forward(cfg, qp, x)
            torch.cuda.synchronize()
            with _PlainKernels():
                want = vggt.forward(cfg, qp, x)
            torch.cuda.synchronize()
            ms = time_ms(lambda: vggt.forward(cfg, qp, x), reps=3, warmup=1)
            with _PlainKernels():
                plain = time_ms(lambda: vggt.forward(cfg, qp, x), reps=2, warmup=0)
        _check(log.by_name() == want_launches[fused],
               f"2-pair forward (fused={fused}) launches {log.by_name()}")
        rel = _rel_l2(torch, got, want)
        print(f"model (vggt-1b width, 2 AA pairs, {BATCH}x{S_FRAMES}x{N_PATCHES}, fused={fused}): "
              f"kernels vs plain rel L2 {rel}; forward kernels={ms:.2f}ms plain={plain:.2f}ms")
        _check(all(v < 1e-3 for v in rel.values()), f"model kernels vs plain: {rel}")
        check_blocks(torch, cfg, qp, x, f"model fused={fused}",
                     other=trees[False] if fused else None)


# ---------------------------------------------------------------------------
# phases 4-5: the served paths
# ---------------------------------------------------------------------------


def phase_serve(torch, dev, *, fused: bool, compare: dict | None = None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_vggt
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    tag = "serve fused" if fused else "serve unfused"
    gc.collect()  # an earlier engine (a reference cycle through its queue) must not count
    torch.cuda.empty_cache()
    cfg = get_config("vggt-1b")

    def weights():  # vggt-1b's random weights, the same for both plans
        return vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    eng = VGGTEngine(cfg, weights(), policy=_plan(fused), attn_impl="two_stage", max_batch=BATCH,
                     device="cuda")
    t0 = time.perf_counter()
    served = eng.params  # quantize once, before the measured requests
    torch.cuda.synchronize()
    print(f"{tag}: quantized vggt-1b ({cfg.n_layers} AA pairs) in {time.perf_counter() - t0:.1f}s")
    requests = [_scenes(torch, dev, 1, step=r) for r in range(4)]
    pairs = cfg.n_layers
    want = ({"fused_matmul": 4 * pairs, "fused_ffn": 2 * pairs, "two_stage_attention": 2 * pairs}
            if fused else {"quant_matmul": 12 * pairs, "two_stage_attention": 2 * pairs})
    run = _serve_requests(torch, eng, requests, tag, want)
    counts, calls, outs = run["counts"], run["calls"], run["outs"]

    # the first micro-batch against a plain-version forward of the same weights
    first = torch.cat(requests[:2], dim=0)
    with torch.inference_mode(), _PlainKernels():
        plain = vggt.forward(eng.cfg, served, first)
    got = {k: torch.cat([outs[0][k], outs[1][k]], dim=0) for k in ("pose", "points", "depth")}
    rel = _rel_l2(torch, got, plain)
    print(f"{tag}: served vs plain-version forward ({pairs} AA pairs) rel L2 {rel}")
    _check(all(v < 1e-3 for v in rel.values()), f"{tag}: served vs plain forward: {rel}")
    _check(all(math.isfinite(v) for v in rel.values()), "non-finite comparison")
    del plain
    other = None
    if compare is not None:
        rels = [_rel_l2(torch, o, c) for o, c in zip(outs, compare["outs"])]
        worst = {k: max(r[k] for r in rels) for k in rels[0]}
        print(f"{tag}: fused vs unfused plan on the same weights, worst request rel L2 {worst}")
        _check(all(v < 1e-2 for v in worst.values()), f"fused vs unfused: {worst}")
        with torch.inference_mode():  # made after the measured run, so its peak memory holds
            other = quantize_vggt(eng.cfg, weights(), _plan(False))
    check_blocks(torch, eng.cfg, served, first, tag, other=other)
    del other
    batches = [torch.cat(requests[i:i + BATCH], dim=0) for i in range(0, len(requests), BATCH)]
    inplace = profile_forwards(torch, [lambda x=x: vggt.forward(eng.cfg, served, x)
                                       for x in batches])
    return {"counts": counts, "runs": calls, "inplace": inplace,
            "outs": [{k: o[k] for k in ("pose", "points", "depth")} for o in outs]}


def _serve_requests(torch, eng, requests: list, tag: str, want: dict) -> dict:
    """Serve one-scene ``requests`` through ``eng`` (``max_batch=2``: every
    2nd request fills its group and runs it), counting launches from 0 over
    exactly that run; checks the launches against ``want`` per forward,
    two forwards, finite outputs of the served shape, and prints p50
    request latency, scenes/s and peak memory."""
    from repro_torch.kernels import probe

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs, latency = [], {}
    t_all = time.perf_counter()
    with probe.tracking() as log:  # counts start at 0 here and cover exactly the served run
        for x in requests:
            reqs.append(eng.enqueue(x))
            now = time.perf_counter()
            for i, r in enumerate(reqs):
                if r.ready and i not in latency:
                    latency[i] = now - r.t_enqueue
        eng.flush()
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = log.by_name()
    calls = eng.stats.calls
    print(f"{tag}: launches {counts} over {calls} forwards")
    _check(calls == 2, f"{tag}: expected 2 micro-batched forwards, got {calls}")
    _check(counts == {k: v * calls for k, v in want.items()},
           f"{tag}: launches {counts}, expected {want} per forward")
    outs = [r.result() for r in reqs]
    for o in outs:
        for k in ("pose", "points", "depth", "conf"):
            _check(bool(torch.isfinite(o[k]).all()), f"{tag}: {k} not finite")
        _check(tuple(o["points"].shape) == (1, S_FRAMES, N_PATCHES, 3), f"{tag}: points shape")
    _check(len(latency) == len(requests), f"{tag}: every request answered")
    p50 = statistics.median(latency.values()) * 1e3
    print(f"{tag}: {len(requests)} requests x 1 scene ({S_FRAMES} frames x {N_PATCHES} "
          f"patches), max_batch={BATCH}: p50 request latency {p50:.1f}ms, "
          f"{len(requests) / wall:.2f} scenes/s, peak memory {peak:.2f} GiB")
    print(eng.stats.format())
    return {"counts": counts, "calls": calls, "outs": outs}


def _branches(torch, block, p, cfg, x, kv_mask):
    """The two residual branches ``block`` (``vggt._block``) adds to the
    stream ``x`` (the attention output and the FFN output, LayerScale
    folded in), and the block's output."""
    from repro_torch.models import attention as A
    from repro_torch.models import ffn as F

    outs, attn, ffn = [], A.gqa_attention, F.dense_ffn

    def keep(fn):
        def run(*a, **kw):
            r = fn(*a, **kw)
            outs.append(r[0] if isinstance(r, tuple) else r)  # attention: (out, cache)
            return r
        return run

    A.gqa_attention, F.dense_ffn = keep(attn), keep(ffn)
    try:
        y = block(p, cfg, x, kv_mask=kv_mask)
    finally:
        A.gqa_attention, F.dense_ffn = attn, ffn
    return outs, y


def check_blocks(torch, cfg, served, x, tag, other=None, noise=False) -> None:
    """One forward of ``served`` on ``x``; at every block, its residual
    branches with the kernels against the same block with the plain
    versions (rel L2 < 1e-3) and, given ``other`` (the other plan's tree on
    the same weights), against that plan's block (< 1e-2), all fed the
    stream this forward reaches the block with.  A branch's relative error
    does not shrink with LayerScale, so a wrong block fails here.

    ``noise``: also run the plain versions on the block input with its
    last bit flipped at random (``x·(1 ± 2^-23)``): how far the branch
    itself moves when its float inputs change in the last place, as a
    kernel's other summation order changes them.  At A4 one flipped
    rounding moves a row 127/7 times as far as at A8, so a branch that
    quantizes at A4 is held within ``NOISE_MARGIN`` times that movement
    where it exceeds 1e-3."""
    from repro_torch.models import vggt
    from repro_torch.tree import tree_index

    block, calls = vggt._block, []
    worst = {"plain": [0.0, 0.0], "other": [0.0, 0.0]}
    over = []  # (block, branch, rel vs plain, the branch's own movement)
    gen = torch.Generator(device=x.device).manual_seed(7)

    def checked(p, cfg_, xin, kv_mask=None):
        i = len(calls)
        calls.append(i)
        got, y = _branches(torch, block, p, cfg_, xin, kv_mask)
        with _PlainKernels():
            want, _ = _branches(torch, block, p, cfg_, xin, kv_mask)
            if noise:
                sign = torch.randint(0, 2, xin.shape, generator=gen, device=xin.device) * 2 - 1
                moved, _ = _branches(torch, block, p, cfg_, xin * (1 + sign * 2.0**-23), kv_mask)
        refs = {"plain": want}
        if other is not None:
            op = tree_index(other["blocks"], i // 2)["frame" if i % 2 == 0 else "global"]
            refs["other"], _ = _branches(torch, block, op, cfg_, xin, kv_mask)
        for name, ref in refs.items():
            for j in (0, 1):
                rel = _rel(torch, got[j], ref[j])
                worst[name][j] = max(worst[name][j], rel)
                if name == "plain" and rel >= 1e-3:
                    over.append((i, j, rel, _rel(torch, moved[j], want[j]) if noise else None))
        return y

    vggt._block = checked
    try:
        with torch.inference_mode():
            vggt.forward(cfg, served, x)
    finally:
        vggt._block = block
    _check(len(calls) == 2 * cfg.n_layers, f"{tag}: {len(calls)} blocks checked")
    print(f"{tag}: per-block residual branches over {len(calls)} blocks, worst rel L2 "
          f"(attention, FFN): kernels vs plain {worst['plain']}"
          + ("" if other is None else f", vs the other plan {worst['other']}"))
    for i, j, rel, moved in over:
        print(f"  block {i} ({'frame' if i % 2 == 0 else 'global'} {i // 2}) "
              f"{('attention', 'FFN')[j]} branch: kernels vs plain {rel:.3g}, the plain "
              f"versions' own movement under a last-bit input change {moved}")
    for i, j, rel, moved in over:
        _check(noise and rel < NOISE_MARGIN * moved,
               f"{tag}: block {i} branch {j} vs plain: {rel} (own movement {moved})")
    if other is not None:
        _check(max(worst["other"]) < 1e-2, f"{tag}: a block's branch vs the other plan: "
               f"{worst['other']}")


# A branch quantizing at A4 against the plain versions: within this many
# times the plain versions' own movement under a last-bit input change.
NOISE_MARGIN = 3.0


def profile_forwards(torch, fwds) -> dict[str, float]:
    """Replay a served run's forwards under torch.profiler.  Prints, per
    forward, the device time of the hand-written kernels and of the PyTorch
    operators between them, and the device's idle share of the (profiled,
    so slightly slower) wall time.  Returns each kernel's in-place device
    time summed over the forwards (empty if the profiler saw no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fwd in fwds:
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device time")
        return {}
    n = len(fwds)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ours = {}
    for e in kernels:
        for name in KERNELS:
            if f"{name}_kernel" in e.name:
                ours[name] = ours.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"profile: {n} forwards, per forward {wall_ms / n:.1f}ms wall, device busy "
          f"{busy / n:.1f}ms (idle {100 * (1 - busy / wall_ms):.1f}%), hand-written kernels "
          + ", ".join(f"{k} {v / n:.1f}ms" for k, v in ours.items())
          + f", everything else {(busy - sum(ours.values())) / n:.1f}ms")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  profile op {e.key:32s} calls/forward={e.count / n:7.1f} "
              f"device/forward={e.self_device_time_total / 1e3 / n:9.2f}ms")
    return ours


# ---------------------------------------------------------------------------
# phase 6: the shared prologue and the stand-alone WHT
# ---------------------------------------------------------------------------


def phase_prologue(torch, dev) -> dict:
    """One Q/K/V input quantized once by ``norm_quant_prologue`` and fed to
    three pre-quantized ``fused_linear`` launches; ``online_wht_2d`` over
    the FFN hidden's shape.  Checked against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.core import versaq as V
    from repro_torch.kernels import ops, probe

    cfg = get_config("vggt-1b")
    d, t = cfg.d_model, cfg.n_special_tokens + N_PATCHES
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((BATCH, S_FRAMES, t, d), generator=gen, device=dev)
    hidden = torch.randn((BATCH * S_FRAMES * t, cfg.d_ff), generator=gen, device=dev)
    pol = V.QuantPolicy(4, 8, "versaq")
    sites = [V.prepare_linear(torch.randn((d, d), generator=gen, device=dev) / math.sqrt(d), pol,
                              rotate_in_offline=True, use_kernel=True, epilogue=V.Epilogue())
             for _ in range(3)]
    u = V.make_folded_norm("ln", d, device=dev).u

    def run():
        qt = ops.norm_quant_prologue(x, norm="ln", norm_u=u, wht=True)
        return [ops.fused_linear(qt, s) for s in sites], ops.online_wht_2d(hidden)

    with probe.tracking() as log:  # counts start at 0 here and cover exactly this pass
        outs, rot = run()
    torch.cuda.synchronize()
    counts = log.by_name()
    _check(counts == {"norm_quant": 1, "fused_matmul": 3, "wht": 1}, f"prologue launches {counts}")
    with _PlainKernels():
        want_outs, want_rot = run()
    rels = [_rel(torch, a, b) for a, b in zip(outs, want_outs)] + [_rel(torch, rot, want_rot)]
    print(f"prologue: launches {counts}; q/k/v vs plain rel L2 {rels[:3]}, wht {rels[3]:.3g}")
    _check(all(r < 1e-3 for r in rels[:3]) and rels[3] < 1e-6, f"prologue vs plain: {rels}")
    return {"counts": counts, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 7: the server a user starts (launch/serve.py's engine and server)
# ---------------------------------------------------------------------------

SERVER_TIERS = "quality=fp,balanced=w4a8,fast=w4a8:fused"


def phase_server(torch, dev) -> dict:
    """Six requests, round-robin over three tiers, through ``AsyncServer``;
    see the module docstring (7).  With a long ``max_wait_s`` and
    ``max_batch=2`` a tier's pair fills its group and runs inside the
    second request's ``submit``, so each submit is its own counted window."""
    import urllib.request

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import vggt
    from repro_torch.serving.batching import NumericFault, QueueFull
    from repro_torch.serving.server import AsyncServer
    from repro_torch.serving.vggt_engine import VGGTEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("vggt-1b")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = {n: s.materialize() for n, s in ServeSpec.parse_tiers(SERVER_TIERS).items()}
    names = list(tiers)
    kw = dict(tiers=tiers, attn_impl="two_stage", max_batch=BATCH, max_wait_s=60.0, device="cuda")
    eng = VGGTEngine(cfg, params, faults="nan@scene:req=1", **kw)
    t0 = time.perf_counter()
    for t in names:  # quantize every tier before the measured requests
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"server: tiers {SERVER_TIERS}, quantized in {time.perf_counter() - t0:.1f}s")
    requests = [_scenes(torch, dev, 1, step=200 + r) for r in range(6)]
    torch.cuda.synchronize()
    pairs = cfg.n_layers
    want = {"quality": {},
            "balanced": {"quant_matmul": 12 * pairs, "two_stage_attention": 2 * pairs},
            "fast": {"fused_matmul": 4 * pairs, "fused_ffn": 2 * pairs,
                     "two_stage_attention": 2 * pairs}}
    logs, peak, latency, reqs = {}, {}, {}, []
    try:
        with AsyncServer(eng, metrics_port=0) as srv:
            _check(obs.enabled(), "server: telemetry is not on")
            for i, x in enumerate(requests):
                tier = names[i % len(names)]
                torch.cuda.reset_peak_memory_stats()
                with probe.tracking() as log:  # counts start at 0 here
                    reqs.append(srv.submit(x, tier=tier))
                torch.cuda.synchronize()
                if i < len(names):
                    _check(log.count == 0, f"server: request {i} ran early: {log.by_name()}")
                    continue
                now = time.perf_counter()
                logs[tier], peak[tier] = log.by_name(), torch.cuda.max_memory_allocated() / 2**30
                latency[tier] = [now - r.t_enqueue for r in reqs[i - len(names)::len(names)]]
            outs = []
            for i, r in enumerate(reqs):
                try:
                    outs.append(srv.result(r, timeout=600))
                except NumericFault:
                    outs.append(None)
            host, port = srv.metrics_address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=60) as resp:
                _check(resp.status == 200, f"/metrics answered {resp.status}")
                text = resp.read().decode()
            with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as resp:
                health = (resp.status, resp.read().decode().strip())
            counts = dict(probe.global_counters().counts)
    finally:
        obs.disable_all()
    print(f"server: launches per tier {logs}")
    _check([o is None for o in outs] == [i == 1 for i in range(6)],
           f"server: failed requests {[i for i, o in enumerate(outs) if o is None]}, expected [1]")
    _check(eng.stats.scheduler.numeric_faults == 1, "server: numeric faults")
    for o in outs:
        if o is not None:
            for k in ("pose", "points", "depth", "conf"):
                _check(bool(torch.isfinite(o[k]).all()), f"server: {k} not finite")
    for tier in names:
        _check(logs[tier] == want[tier], f"server {tier}: launches {logs[tier]}, expected "
                                         f"{want[tier]}")
    total = {}
    for log in logs.values():
        for k, v in log.items():
            total[k] = total.get(k, 0) + v
    _check(counts == total, f"server: global counters {counts} vs the tiers' launches {total}")

    # each tier against its reference forward of the same scenes
    rels = {}
    with torch.inference_mode():
        for tier, idx in (("quality", [0, 3]), ("balanced", [4]), ("fast", [2, 5])):
            x = torch.cat([requests[i] for i in idx], dim=0)
            if tier == "quality":
                want_out = vggt.forward(eng.cfg, params, x)
            else:
                with _PlainKernels():
                    want_out = vggt.forward(eng.cfg, eng.tier_params(tier), x)
            got = {k: torch.cat([outs[i][k] for i in idx], dim=0)
                   for k in ("pose", "points", "depth")}
            rels[tier] = _rel_l2(torch, got, want_out)
            del want_out
    print(f"server: each tier vs its reference forward, rel L2 {rels}")
    for tier, rel in rels.items():
        bound = 1e-5 if tier == "quality" else 1e-3
        _check(all(v < bound for v in rel.values()), f"server {tier} vs reference: {rel}")

    # telemetry: per-tier bucket series, kernel counters equal to the probe's
    bucket = f"b{BATCH}xs{S_FRAMES}xp{N_PATCHES}"
    for tier in names:
        line = (f'serve_bucket_calls_total{{kind="vggt",bucket="{tier}:{bucket}",tier="{tier}"}} 1')
        _check(line in text, f"/metrics lacks {line}")
    for name, n in counts.items():
        line = f'kernel_launches_total{{kernel="{name}"}} {n}'
        _check(line in text, f"/metrics lacks {line}")
    _check(health == (200, "ok"), f"/healthz answered {health}")
    print(f"server: /metrics {len(text.splitlines())} lines, kernel counters {counts}, "
          f"/healthz {health}")
    for tier in names:
        bs = eng.stats.buckets[next(b for b in eng.stats.buckets if b.tier == tier)]
        print(f"server {tier}: p50 request latency {statistics.median(latency[tier]) * 1e3:.1f}ms "
              f"(enqueue to delivery, {len(latency[tier])} requests), forward "
              f"{bs.p50_ms:.1f}ms, {bs.scenes_per_s:.2f} scenes/s, peak memory "
              f"{peak[tier]:.2f} GiB")
    print(eng.stats.format())
    del outs, reqs
    # where the quality tier's time goes (no kernel: float projections and
    # the float two-stage emulation), one forward of its pair replayed
    pair = torch.cat([requests[0], requests[3]], dim=0)
    profile_forwards(torch, [lambda: vggt.forward(eng.cfg, params, pair)])

    # admission: a second engine, the same tiers, room for one request
    adm = VGGTEngine(cfg, params, max_pending=1, **kw)
    first = adm.enqueue(requests[0], tier="fast")
    refused = False
    try:
        adm.enqueue(requests[1], tier="fast")
    except QueueFull as e:
        refused = True
        print(f"admission: second request refused: {e}")
    _check(refused and adm.stats.scheduler.rejected == 1, "admission: no QueueFull")
    _check(not first.ready, "admission: the first request ran before flush")
    adm.flush()
    _check(bool(torch.isfinite(first.result()["points"]).all()), "admission: flush result")
    print("admission: flush served the first request")
    del adm, eng, params
    return {"counts": total, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 8: plan, compile and serve a mixed-precision schedule
# ---------------------------------------------------------------------------

SCHEDULE_TIERS = "planned=plan:fused,fast=w4a8:fused"


def phase_schedule(torch, dev) -> dict:
    """The sensitivity planner on the seed-0 vggt-1b weights, the plan
    compiled with the tuner timing each kernel signature on the card (a
    second compile on the filled DB times nothing), the saved schedule
    served through ``VGGTEngine(schedule=path)``, then the launcher's
    ``planned=plan:fused`` tier beside ``fast``; see the module docstring
    (8).  Expected launches come from the schedules, not from constants."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import (
        Autotuner, KernelSchedule, PrecisionPlan, TuningDB, compile_schedule, plan_model,
        proxy_recon_error,
    )
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import vggt
    from repro_torch.serving.vggt_engine import VGGTEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("vggt-1b").with_(attn_impl="two_stage")
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    t0 = time.perf_counter()
    plan, report = plan_model(cfg, params, name="plan", use_kernel=True, fuse=True)
    print(f"schedule: planned vggt-1b ({cfg.n_layers} AA pairs) in "
          f"{time.perf_counter() - t0:.1f}s: levels {report['level_counts']}, default "
          f"{plan.default}, overrides {list(plan.overrides)}; modeled weights "
          f"{report['weight_bytes'] / 1e6:.1f} of {report['weight_bytes_budget'] / 1e6:.1f} MB, "
          f"latency {report['modeled_latency_s'] * 1e3:.3f} of "
          f"{report['latency_budget_s'] * 1e3:.3f} ms")
    for site, errs in report["site_errors"].items():
        print(f"  site {site:20s} {report['assignment'][site]:5s} errors "
              + " ".join(f"{lv}={e:.4g}" for lv, e in errs.items()))

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    db_path, path = work / "tune.json", work / "vggt.schedule.json"
    db_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    tuner = Autotuner(db=TuningDB(str(db_path)), device="cuda")
    sched = compile_schedule(cfg, plan, tuner=tuner)
    print(f"schedule: compiled in {time.perf_counter() - t0:.1f}s: {sched.summary()}, "
          f"{len(sched.groups)} fused groups, {tuner.timing_runs} timing runs, "
          f"hash {sched.hash[:12]}")
    for key, e in sorted(tuner.db.entries.items()):
        print(f"  tuned {key}: {e['cost']:.4f} ms (tiles {e['tiles']})")
    for s in sched.sites:
        if s.fallback:
            print(f"  fallback {s.site}: {s.fallback}")
    _check(tuner.timing_runs == len(tuner.db.entries) > 0, "schedule: one timing run a signature")
    again = Autotuner(db=TuningDB(str(db_path)), device="cuda")
    sched2 = compile_schedule(cfg, plan, tuner=again)
    print(f"schedule: recompiled on the filled DB: {again.timing_runs} timing runs, "
          f"{again.db.hits} hits / {again.db.misses} misses")
    _check(again.timing_runs == 0 and again.db.misses == 0, "schedule: the recompile timed")
    _check(sched2.hash == sched.hash, "schedule: the recompile changed the schedule")
    sched.save(path)
    _check(KernelSchedule.load(path).hash == sched.hash, "schedule: save/load changed the hash")

    # the compiled schedule, served
    tag = "schedule"
    eng = VGGTEngine(cfg, params, schedule=str(path), attn_impl="two_stage", max_batch=BATCH,
                     device="cuda")
    _check(eng.cfg.attn_tiles == sched.attention_targets(), "schedule: attention tiles")
    served = eng.params
    torch.cuda.synchronize()
    requests = [_scenes(torch, dev, 1, step=300 + r) for r in range(4)]
    want = sched.launches_per_forward(two_stage_attention=True)
    print(f"{tag}: launches the schedule predicts per forward: {want}")
    run = _serve_requests(torch, eng, requests, tag, want)
    counts, calls, outs = run["counts"], run["calls"], run["outs"]
    first = torch.cat(requests[:2], dim=0)
    with torch.inference_mode(), _PlainKernels():
        plain = vggt.forward(eng.cfg, served, first)
    got = {k: torch.cat([outs[0][k], outs[1][k]], dim=0) for k in ("pose", "points", "depth")}
    rel = _rel_l2(torch, got, plain)
    print(f"{tag}: served vs plain-version forward rel L2 {rel}")
    _check(all(v < 1e-3 for v in rel.values()), f"{tag}: served vs plain forward: {rel}")
    del plain, outs
    check_blocks(torch, eng.cfg, served, first, tag, noise=True)
    batches = [torch.cat(requests[i:i + BATCH], dim=0) for i in range(0, len(requests), BATCH)]
    inplace = profile_forwards(torch, [lambda x=x: vggt.forward(eng.cfg, served, x)
                                       for x in batches])
    del eng, served

    # the launcher's planned tier beside fast (ServeSpec, as launch/serve.py --tiers)
    tiers = {n: s.materialize(cfg, params, name=n, verbose=True)
             for n, s in ServeSpec.parse_tiers(SCHEDULE_TIERS).items()}
    _check((tiers["planned"].default, tiers["planned"].overrides) == (plan.default, plan.overrides),
           "schedule: the launcher's plan differs from the planner's")
    eng = VGGTEngine(cfg, params, tiers=tiers, attn_impl="two_stage", max_batch=BATCH,
                     max_wait_s=60.0, device="cuda")
    for t in tiers:
        eng.tier_params(t)
    pair = torch.cat(requests[:2], dim=0)
    for tier, pol in tiers.items():
        want = compile_schedule(cfg, pol).launches_per_forward(two_stage_attention=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probe.tracking() as log:  # counts start at 0 here
            reqs = [eng.enqueue(requests[0], tier=tier), eng.enqueue(requests[1], tier=tier)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check(log.by_name() == want, f"tier {tier}: launches {log.by_name()}, expected {want}")
        got = {k: torch.cat([r.result()[k] for r in reqs], dim=0) for k in ("pose", "points", "depth")}
        with torch.inference_mode(), _PlainKernels():
            plain = vggt.forward(eng.cfg, eng.tier_params(tier), pair)
        rel = _rel_l2(torch, got, plain)
        _check(all(v < 1e-3 for v in rel.values()), f"tier {tier} vs plain forward: {rel}")
        bs = eng.stats.buckets[next(b for b in eng.stats.buckets if b.tier == tier)]
        print(f"tier {tier}: launches {log.by_name()} (as its schedule predicts); forward "
              f"{bs.p50_ms:.1f}ms, {bs.scenes_per_s:.2f} scenes/s, peak memory {peak:.2f} GiB; "
              f"vs plain rel L2 {rel}")
        del plain, reqs
    del eng

    # the paper's accuracy axis: proxy error to the fp forward (no threshold)
    errs = {}
    for name, pol in (("planned", plan),
                      ("w4a8", PrecisionPlan(default="w4a8", use_kernel=True, fuse=True)),
                      ("w4a4", PrecisionPlan(default="w4a4", use_kernel=True, fuse=True))):
        errs[name] = proxy_recon_error(cfg, params, pol)
    print(f"schedule: proxy reconstruction error vs the fp forward (2 scenes x 2 frames x 32 "
          f"patches): {errs}")
    _check(all(math.isfinite(v) for v in errs.values()), "schedule: proxy errors")
    return {"counts": counts, "runs": calls, "inplace": inplace}


# ---------------------------------------------------------------------------
# phase 9: the LM path (qwen3-14b)
# ---------------------------------------------------------------------------


def _lm_tiers():
    from repro_torch.core.precision.plan import PrecisionPlan

    return {"fp": None, "w4a8": PrecisionPlan(default="w4a8", use_kernel=True),
            "w4a8:fused": PrecisionPlan(default="w4a8", use_kernel=True, fuse=True)}


def _last_bit(torch, w, seed):
    """``w·(1 ± 2^-23)``, the sign of each entry drawn from ``seed``."""
    gen = torch.Generator(device=w.device).manual_seed(seed)
    sign = torch.randint(0, 2, w.shape, generator=gen, device=w.device, dtype=torch.int8)
    return w * (1 + (sign * 2 - 1) * 2.0**-23)


def _noised(torch, params, seed=7):
    """``params`` with every embedding entry's last bit flipped at random:
    the forward's float inputs changed in the last place, as another
    summation order changes them.  (An ``embed_inputs`` model reads no
    embedding table: ``_last_bit`` its inputs instead.)"""
    return {**params, "embed": {"w": _last_bit(torch, params["embed"]["w"], seed)}}


# A quantized LM's whole-model logits at qwen3-14b-smoke width, kernels
# against plain versions: one int8 activation rounding that the kernels'
# other summation order flips changes its token's row, and causal attention
# and the next layers carry it on; on the CPU such flips move the logits of
# the same model up to 1.3e-2 against the JAX package's
# (tests/test_torch_lm.py, REL_L2_FLIP).
LM_FLIP_BOUND = 2e-2
# A quantized LM's prefill + decode steps against one full forward over the
# same tokens: the decode attends over the int8 KV cache, the full forward
# in float, and the W4 weights and A8 activations round on both paths; the
# reference's own bound for it (tests/models/test_decode.py, W4A8).
DECODE_VS_FULL_W4A8 = 0.35


def _hold_lm(torch, tag, rels, moved_fn) -> None:
    """Whole-model logits of a quantized LM, kernels against plain versions:
    each reading under 1e-3, or within ``NOISE_MARGIN`` times the plain
    versions' own movement under a last-bit change of the embedding
    (``moved_fn()``, run only when needed).  For long sequences, where
    rounding flips are certain, that movement measures how far the model
    carries them: a [2, 2048] scoring forward of qwen3-14b over 8 layers
    reads ~2.6e-2 (PERF.md, PR 23).  The layers themselves are held to 1e-3
    apart from this (``_lm_branches``)."""
    if max(rels) < 1e-3:
        return
    moved = moved_fn()
    print(f"  {tag}: readings {[f'{r:.3g}' for r in rels]}; the plain versions' own movement "
          f"under a last-bit embedding change {[f'{m:.3g}' for m in moved]}")
    for r, m in zip(rels, moved):
        _check(r < 1e-3 or r < NOISE_MARGIN * m, f"{tag}: kernels vs plain {r}, own movement {m}")


def _lm_branches(torch, cfg, params, toks, tag, pad=None, steps=None) -> None:
    """Every layer's two branches (the mixer, attention or Mamba, and the
    FFN, dense or MoE; for rwkv, time-mix and channel-mix) with the kernels
    against the same layer with the plain
    versions, fed the same input: over one full-mode forward, or
    (``steps``) over a (left-padded) prefill and decode steps, where the
    plain call writes the same cache slots again (an rwkv mixer returns its
    state and writes nothing).  The rel L2 of each branch kind over all its
    calls must stay under 1e-3: a decode call has 2 rows, and one hidden
    rounding flipped by the kernel's summation order moves such a call by
    ~1.5e-3 at smoke width."""
    from repro_torch.models import attention as A
    from repro_torch.models import ffn as F
    from repro_torch.models import lm
    from repro_torch.models import rwkv as R
    from repro_torch.models import ssm as S

    if "rwkv" in cfg.pattern:
        sites = [(R, "rwkv_time_mix"), (R, "rwkv_channel_mix")]
    else:
        sites = (([(S, "mamba_mixer")] if "mamba" in cfg.pattern else [])
                 + ([(A, "mla_attention" if cfg.mla else "gqa_attention")]
                    if "attn" in cfg.pattern else [])
                 + [(F, "dense_ffn")] + ([(F, "moe_ffn")] if cfg.moe else []))
    sums = [[0.0, 0.0] for _ in sites]  # per kind: squared difference, reference
    worst = [0.0 for _ in sites]
    saved = [getattr(mod, name) for mod, name in sites]

    inside = [False]  # a MoE layer's shared experts are held within its branch

    def checked(j, fn):
        def run(*a, **kw):
            if inside[0]:
                return fn(*a, **kw)
            inside[0] = True
            try:
                r = fn(*a, **kw)
                with _PlainKernels():
                    w = fn(*a, **kw)
            finally:
                inside[0] = False
            got, want = (r[0], w[0]) if isinstance(r, tuple) else (r, w)
            sums[j][0] += ((got.double() - want.double()) ** 2).sum().item()
            sums[j][1] += (want.double() ** 2).sum().item()
            worst[j] = max(worst[j], _rel(torch, got, want))
            return r
        return run

    for j, ((mod, name), fn) in enumerate(zip(sites, saved)):
        setattr(mod, name, checked(j, fn))
    try:
        if steps is None:
            with torch.inference_mode():
                lm.forward(cfg, params, toks)
        else:
            _teacher_forced(torch, cfg, params, toks, pad, steps, toks.shape[1] + steps.shape[1])
    finally:
        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, fn)
    pooled = [math.sqrt(d / max(r, 1e-300)) for d, r in sums]
    print(f"  {tag}: per-layer branches vs plain ({'full' if steps is None else 'prefill+decode'}"
          f"), rel L2 over all calls ({' and '.join(n for _, n in sites)}) "
          f"{[f'{p:.3g}' for p in pooled]}, worst "
          f"call {[f'{w:.3g}' for w in worst]}")
    _check(max(pooled) < 1e-3, f"{tag}: the layers' branches vs plain: {pooled}")


def _teacher_forced(torch, cfg, params, toks, pad_lens, steps, max_len):
    """Logits of a left-padded prefill and of decode steps fed ``steps``
    ([B, n] tokens, or [B, n, d] embeddings for an ``embed_inputs``
    config): a list of [B, V] tensors."""
    from repro_torch.models import lm

    with torch.inference_mode():
        cache = lm.init_cache(cfg, toks.shape[0], max_len, device=toks.device)
        logits, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill",
                                   pad_lens=pad_lens)
        out = [logits[:, -1]]
        del logits
        for i in range(steps.shape[1]):
            step = steps[:, i:i + 1] if cfg.embed_inputs else steps[:, i]
            logits, cache = lm.decode_step(cfg, params, step, cache, pad_lens=pad_lens)
            out.append(logits[:, 0])
    return out


def phase_lm(torch, dev) -> dict:
    """See the module docstring (9)."""
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.kernels import probe
    from repro_torch.models import lm

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # (a) qwen3-14b-smoke, three tiers, kernels against plain versions
    cfg = get_config("qwen3-14b-smoke").with_(attn_impl="two_stage")
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab_size, (2, 4), generator=gen, device=dev)
    pad = torch.tensor([0, 3], device=dev)
    n = cfg.n_layers
    want = {"fp": {}, "w4a8": {"quant_matmul": 7 * n},
            "w4a8:fused": {"fused_matmul": 2 * n, "fused_ffn": n}}
    counts = {}  # the phase's launches: the counted windows of (a), (b) and (c)

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    for tier, pol in _lm_tiers().items():
        with torch.inference_mode():
            params = raw if pol is None else quantize_lm(cfg, raw, pol)
        with probe.tracking() as log:
            got = _teacher_forced(torch, cfg, params, toks, pad, steps, 32)
        torch.cuda.synchronize()
        add(log.by_name())
        per = {k: v / (1 + steps.shape[1]) for k, v in log.by_name().items()}
        _check(per == want[tier], f"lm smoke {tier}: launches per forward {per}, expected "
                                  f"{want[tier]}")
        with _PlainKernels():
            plain = _teacher_forced(torch, cfg, params, toks, pad, steps, 32)
        rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
        with torch.inference_mode(), probe.tracking() as flog:
            full, _ = lm.forward(cfg, params, toks)
        with torch.inference_mode(), _PlainKernels():
            full_plain, _ = lm.forward(cfg, params, toks)
        add(flog.by_name())
        rels.append(_rel(torch, full, full_plain))
        print(f"lm smoke {tier}: launches per prefill/decode forward {per}; prefill, 4 decode "
              f"steps and a full forward vs plain rel L2 {[f'{r:.3g}' for r in rels]}; full "
              f"forward launches {flog.by_name()}")
        _check(all(torch.isfinite(g).all() for g in got), f"lm smoke {tier}: non-finite logits")
        _check(max(rels) < (1e-3 if pol is None else LM_FLIP_BOUND),
               f"lm smoke {tier}: vs plain {rels}")
        if pol is not None:
            _check(flog.by_name().get("two_stage_attention") == n,
                   f"lm smoke {tier}: full forward launches {flog.by_name()}")
            _lm_branches(torch, cfg, params, toks, f"lm smoke {tier}")
            _lm_branches(torch, cfg, params, toks, f"lm smoke {tier}", pad=pad, steps=steps)
    del raw, params

    # (b) qwen3-14b at full width, served through the LM engine
    paths = _lm_serve(torch, dev)
    # (c) one scoring forward of the W4A8 tree through the dh-128 kernel
    score = _lm_score(torch, dev, paths.pop("params"), paths.pop("cfg"))
    smoke = dict(counts)
    add(paths["counts"])
    add(score)
    print(f"lm: phase {time.perf_counter() - t_phase:.1f}s; launches smoke tiers {smoke}, served "
          f"{paths['counts']}, scoring forward {score}")
    # the raw qwen3-14b weights go on to phase_lm_continuous
    return {"counts": counts, "runs": 1, "inplace": {}, "raw": paths["raw"]}


def _lm_serve(torch, dev) -> dict:
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import AsyncServer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-14b").with_(n_layers=LM_LAYERS)
    print(f"lm: qwen3-14b depth {LM_LAYERS} of 40 layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = {n: s.materialize() for n, s in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    max_len = LM_PROMPT + LM_GEN
    eng = Engine(cfg, params, tiers=tiers, attn_impl="two_stage", mode="bucket",
                 max_len=max_len, max_batch=BATCH, max_wait_s=60.0, device="cuda")
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"lm: weights and tiers quantized in {time.perf_counter() - t0:.1f}s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompts = mixed_len_prompts(cfg.vocab_size, 4, LM_PROMPT)
    names = list(tiers)
    n = cfg.n_layers
    want = {"quality": {}, "balanced": {"quant_matmul": 7 * n * LM_GEN}}
    logs, peak, reqs = {}, {}, []
    try:
        with AsyncServer(eng, metrics_port=0) as srv:
            for i, p in enumerate(prompts):
                tier = names[i % len(names)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with probe.tracking() as log:  # counts start at 0 here
                    reqs.append(srv.submit(p, LM_GEN, tier=tier))
                torch.cuda.synchronize()
                if i >= len(names):  # the tier's pair filled its group and ran here
                    logs[tier] = log.by_name()
                    peak[tier] = torch.cuda.max_memory_allocated() / 2**30
                else:
                    _check(log.count == 0, f"lm: request {i} ran early: {log.by_name()}")
            outs = [srv.result(r, timeout=600) for r in reqs]
    finally:
        obs.disable_all()
    print(f"lm: launches per tier {logs}")
    _check(all(o.shape == (LM_GEN,) for o in outs), "lm: every request delivered")
    for tier in names:
        _check(logs[tier] == want[tier], f"lm {tier}: launches {logs[tier]}, expected "
                                         f"{want[tier]} (7 x {n} per prefill and decode step)")
    print(eng.stats.format())
    for tier in names:
        pb = next(s for b, s in eng.stats.buckets.items()
                  if b.tier == tier and type(b).__name__ == "PrefillBucket")
        db = next(s for b, s in eng.stats.buckets.items()
                  if b.tier == tier and type(b).__name__ == "DecodeBucket")
        print(f"lm {tier}: prefill {pb.p50_ms:.2f}ms ({BATCH}x{LM_PROMPT} tokens), decode "
              f"{db.p50_ms:.3f}ms per step, {db.tokens / db.total_s:.1f} decode tok/s, peak "
              f"memory {peak[tier]:.2f} GiB")

    # the balanced pair (requests 1 and 3, 384 tokens left-padded to 512),
    # teacher-forced on its own tokens: kernels against plain versions
    params_b = eng.tier_params("balanced")
    idx = [i for i in range(len(prompts)) if names[i % len(names)] == "balanced"]
    L = eng.prompt_bucket(max(len(prompts[i]) for i in idx))
    toks = torch.stack([torch.nn.functional.pad(torch.as_tensor(prompts[i], device=dev).long(),
                                                (L - len(prompts[i]), 0)) for i in idx])
    pad = torch.tensor([L - len(prompts[i]) for i in idx], device=dev)
    served = torch.stack([torch.as_tensor(outs[i]) for i in idx]).to(dev).long()
    got = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served[:, :4], max_len)
    with _PlainKernels():
        plain = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served[:, :4], max_len)
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
    picked = torch.stack([w.argmax(dim=-1) for w in plain], dim=1)
    agree = int((picked == served[:, :5]).sum())
    print(f"lm balanced: teacher-forced logits vs plain rel L2 (prefill, 4 decode steps) "
          f"{[f'{r:.3g}' for r in rels]}; plain versions pick the served token {agree} of "
          f"{picked.numel()} times")
    _check(max(rels) < 1e-3, f"lm balanced vs plain: {rels}")
    del got, plain

    # where the time goes: each tier's prefill of the pair and 4 decode steps
    for tier in names:
        p_t = eng.tier_params(tier)
        state = {}

        def prefill(p_t=p_t, state=state):
            state["cache"] = lm.init_cache(eng.cfg, len(idx), max_len, device=dev)
            _, state["cache"] = lm.forward(eng.cfg, p_t, toks, cache=state["cache"],
                                           mode="prefill", pad_lens=pad)

        def step(i, p_t=p_t, state=state):
            _, state["cache"] = lm.decode_step(eng.cfg, p_t, served[:, i], state["cache"],
                                               pad_lens=pad)

        print(f"lm {tier}: profile of the pair's prefill")
        profile_forwards(torch, [prefill])
        print(f"lm {tier}: profile of 4 decode steps")
        profile_forwards(torch, [lambda i=i: step(i) for i in range(4)])
        del state
    del eng
    counts = {}
    for log in logs.values():
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v
    return {"counts": counts, "params": params_b, "cfg": cfg, "raw": params}


def _lm_score(torch, dev, params, cfg, want=None, length=None) -> dict:
    """One W4A8 scoring forward over [2, ``length``] tokens (default
    ``LM_SCORE_LEN``; seeded [2, length, d] embeddings for an
    ``embed_inputs`` config):
    its launches (``want``, by default a dense GQA stack's 7
    ``quant_matmul`` and one two-stage launch a layer), the logits against
    the plain versions, every layer's branches."""
    from repro_torch.kernels import probe
    from repro_torch.models import lm

    cfg = cfg.with_(attn_impl="two_stage")
    length = length or LM_SCORE_LEN
    gen = torch.Generator(device=dev).manual_seed(4)
    if cfg.embed_inputs:
        toks = torch.randn((2, length, cfg.d_model), generator=gen, device=dev)
    else:
        toks = torch.randint(0, cfg.vocab_size, (2, length), generator=gen, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode(), probe.tracking() as log:  # counts start at 0 here
        got, _ = lm.forward(cfg, params, toks)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = cfg.n_layers
    want = want or {"quant_matmul": 7 * n, "two_stage_attention": n}
    _check(log.by_name() == want, f"lm scoring forward launches {log.by_name()}, expected {want}")
    with torch.inference_mode(), _PlainKernels():
        want, _ = lm.forward(cfg, params, toks)
    rel = _rel(torch, got, want)
    dims = (f"MLA q/k dh {cfg.qk_nope_dim + cfg.qk_rope_dim}, v dh {cfg.v_head_dim}" if cfg.mla
            else f"dh {cfg.head_dim}")
    print(f"lm scoring forward ({cfg.name} W4A8, [2, {length}], causal, {dims}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}): launches "
          f"{log.by_name()}, {dt * 1e3:.1f}ms (first call), peak memory {peak:.2f} GiB; "
          f"vs plain rel L2 {rel:.3g}")
    _check(bool(torch.isfinite(got).all()), "lm scoring forward: non-finite logits")
    del got

    def moved():
        with torch.inference_mode(), _PlainKernels():
            if cfg.embed_inputs:
                out, _ = lm.forward(cfg, params, _last_bit(torch, toks, 7))
            else:
                out, _ = lm.forward(cfg, _noised(torch, params), toks)
        return [_rel(torch, out, want)]

    _hold_lm(torch, "lm scoring forward", [rel], moved)
    del want
    _lm_branches(torch, cfg, params, toks, "lm scoring forward")
    return log.by_name()


# ---------------------------------------------------------------------------
# phases 10-11: continuous LM serving (qwen3-14b) and rwkv6-1.6b
# ---------------------------------------------------------------------------


def _wall_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` from a synchronized start to a
    synchronized end (after one warm-up call): what a caller waits,
    launch overhead included."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _ttft_ms(tracer, reqs) -> list[float]:
    """Per delivered request: enqueue to the end of its prefill (which
    yields its first token), from the span events."""
    out = []
    for r in reqs:
        t = {ev.phase: ev.t for ev in reversed(tracer.recent(request=r.req_id))}
        if "enqueue" in t and "prefill" in t and r._error is None:
            out.append((t["prefill"] - t["enqueue"]) * 1e3)
    return out


def _serve_report(torch, eng, tag, ttft, wall_s, peak_gib) -> None:
    """TTFT p50, decode ms per step and tok/s per tier, slot occupancy."""
    print(eng.stats.format())
    for tier in eng.tiers:
        ds = [s for b, s in eng.stats.buckets.items()
              if b.tier == tier and type(b).__name__ == "DecodeBucket"]
        calls, total, toks = (sum(s.calls for s in ds), sum(s.total_s for s in ds),
                              sum(s.tokens for s in ds))
        print(f"{tag} {tier}: decode {1e3 * total / max(calls, 1):.3f}ms per step over {calls} "
              f"steps, {toks / max(total, 1e-9):.1f} decode tok/s")
    sched = eng.stats.scheduler
    print(f"{tag}: TTFT p50 {statistics.median(ttft):.1f}ms (of {len(ttft)} requests; max "
          f"{max(ttft):.1f}ms), slot occupancy {sched.slot_occupancy:.3f}, admitted "
          f"{sched.admitted} ({sched.admitted_mid_decode} mid-decode), served in {wall_s:.2f}s, "
          f"peak memory {peak_gib:.2f} GiB")


class _LogitTap:
    """Keeps a served engine's own logits per (request id, prompt row,
    generated index): each prefill wave's last-slot rows
    (``PrefillRunner.run``) and each decode step's rows (``lm.decode_step``),
    mapped to requests by the wave's rows (bucket mode decodes the wave it
    prefilled) or by a burst's slots at its start (``DecodeRunner.run_steps``).
    The tensors are the engine's own, kept by reference: the tap adds no
    device work, only the memory of the logits it keeps."""

    def __init__(self, eng):
        self.eng = eng
        self.rows = {}
        self._ctx = None  # [(request id, rows, generated index of the next step)]

    def __enter__(self):
        from repro_torch.models import lm
        from repro_torch.serving import engine as E

        eng, tap = self.eng, self
        run, step, burst = eng._prefill.run, lm.decode_step, E.DecodeRunner.run_steps

        def prefill(reqs, L, tier):
            pre = run(reqs, L, tier)
            i0, ctx = 0, []
            for r in reqs:
                b = r.prompts.shape[0]
                for j in range(b):  # a copy: the row is a view of the whole prefill's logits
                    tap.rows[(r.req_id, j, 0)] = pre.logits_last[i0 + j].clone()
                ctx.append((r.req_id, list(range(i0, i0 + b)), 1))
                i0 += b
            tap._ctx = ctx
            return pre

        def decode_step(*a, **kw):
            logits, cache = step(*a, **kw)
            for rid, rows, k in tap._ctx or ():
                for j, s_ in enumerate(rows):
                    tap.rows[(rid, j, k)] = logits[s_, 0]
            tap._ctx = [(rid, rows, k + 1) for rid, rows, k in tap._ctx or ()]
            return logits, cache

        def run_steps(runner, max_steps):
            if runner.eng is eng:
                tap._ctx = [(a.req.req_id, list(a.rows), a.req.n_steps - a.remaining)
                            for a in runner.active]
            try:
                return burst(runner, max_steps)
            finally:
                tap._ctx = None

        eng._prefill.run = prefill
        lm.decode_step = decode_step
        E.DecodeRunner.run_steps = run_steps
        self._saved = (step, burst)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm
        from repro_torch.serving import engine as E

        del self.eng._prefill.run  # the bound method again
        lm.decode_step, E.DecodeRunner.run_steps = self._saved
        return False

    def gib(self) -> float:
        """Device memory the kept logits hold."""
        seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in self.rows.values()}
        return sum(seen.values()) / 2**30

    def at(self, req, s: int):
        """The engine's own logits [V] for ``req``'s (first) row at
        generated index ``s``."""
        return self.rows[(req.req_id, 0, s)]


def _forced_at(torch, cfg, prompt, L, pad_prompts, ids, max_len):
    """``f(params, s)``: the plain versions' teacher-forced logits [V] at
    generated index ``s`` of ``prompt`` + ``ids[:s]``, one row, left-padded
    to the request's bucket ``L`` as the engine serves it."""
    def at(params, s):
        dev = params["embed"]["w"].device
        pad = L - len(prompt)
        toks = torch.nn.functional.pad(torch.as_tensor(prompt, device=dev).long(), (pad, 0))[None]
        forced = torch.as_tensor(np.asarray(ids[:s]), device=dev).long()[None]
        with _PlainKernels():
            return _teacher_forced(torch, cfg, params, toks,
                                   torch.tensor([pad], device=dev) if pad_prompts else None,
                                   forced, max_len)[s][0]
    return at


def _hold_same_ids(torch, tag, want, got, ref_at, own_at, forced_at, params,
                   noise_at=None) -> None:
    """Ids of one request served under two layouts (bucket mode and a
    continuous slot, or alone and coalesced) must agree, or part only at a
    near tie that the other layout's float sums flip (``aten::mm`` picks
    other kernels at another batch width, the masked attention sums another
    cache span).  At the first step ``s`` where they differ, with
    ``ref_at(s)``/``own_at(s)`` the logits that each engine itself produced
    there (:class:`_LogitTap`) and ``noise_at(s)`` a sampled request's
    Gumbel noise:

    - each side's token is the argmax of its own logits (plus the noise):
      the logits held are the ones that emitted the tokens;
    - the reference side's margin between its token and the one the engine
      emitted is at most ``NOISE_MARGIN`` times the largest logit movement
      of the plain versions under a last-bit change of the embedding, there
      (``forced_at``, teacher-forced on the same prefix);
    - the two sides' logits agree to ``_hold_lm``'s bound."""
    want, got = np.asarray(want), np.asarray(got)
    if np.array_equal(want, got):
        return
    s = int(np.argmax(want != got))
    w, g = int(want[s]), int(got[s])
    ref, own = ref_at(s).float(), own_at(s).float()
    z = noise_at(s) if noise_at is not None else torch.zeros_like(ref)
    _check(int(torch.argmax(ref + z)) == w and int(torch.argmax(own + z)) == g,
           f"{tag}: the tapped logits at step {s} do not pick the emitted tokens {w} and {g}")
    base = forced_at(params, s)
    moved = forced_at(_noised(torch, params), s) - base
    spread = moved.abs().max().item()
    margin = ((ref + z)[w] - (ref + z)[g]).item()
    rel = _rel(torch, own, ref)
    print(f"  {tag}: ids diverge at step {s} of {len(want)} ({w} vs {g}); the engines' own "
          f"logits there rel L2 {rel:.3g}; the reference side's margin {margin:.3g} against the "
          f"plain versions' largest logit movement under a last-bit embedding change "
          f"{spread:.3g} (bound x{NOISE_MARGIN:g})")
    _check(margin <= NOISE_MARGIN * spread,
           f"{tag}: margin {margin} at step {s} is no near tie (movement {spread})")
    _hold_lm(torch, tag, [rel], lambda: [_rel(torch, base + moved, base)])


def _profile_burst(torch, eng, prompts, tag) -> None:
    """Replay one decode burst (``decode_steps_per_poll`` steps, 4 slots)
    of each tier under the profiler: admit 4 requests with no steps, then
    profile one ``poll``."""
    n_steps = eng.decode_steps_per_poll
    for tier in eng.tiers:
        eng.decode_steps_per_poll = 0
        for p in prompts[:4]:
            eng.enqueue(p, n_steps + 2, tier=tier)
        time.sleep(2 * eng.max_wait_s)
        eng.poll()  # admits the wave, runs no step
        _check(eng.active == 4, f"{tag} {tier}: profile wave not admitted ({eng.active})")
        eng.decode_steps_per_poll = n_steps
        print(f"{tag} {tier}: profile of one {n_steps}-step burst at 4 slots (a 'forward' below "
              f"is the burst)")
        profile_forwards(torch, [eng.poll])
        eng.flush()


def phase_lm_continuous(torch, dev, raw) -> dict:
    """See the module docstring (10)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving.batching import ServeError
    from repro_torch.serving.engine import DecodeRunner, Engine, gumbel_rows
    from repro_torch.serving.server import AsyncServer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-14b").with_(n_layers=LM_LAYERS)
    tiers = {n: s.materialize() for n, s in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    names = list(tiers)
    n_req, sampled, alloc, nan = 8, 3, 4, 5  # enqueue ordinals
    prompts = mixed_len_prompts(cfg.vocab_size, n_req, LM_PROMPT)
    assign = [names[i % 2] for i in range(n_req)]
    kw = dict(tiers=tiers, attn_impl="two_stage", max_len=CONT_MAX_LEN, batch_buckets=(1, 2, 4),
              device="cuda")
    eng = Engine(cfg, raw, mode="auto", max_batch=8, decode_steps_per_poll=8,
                 faults=f"slot_alloc:req={alloc};nan@decode.logits:req={nan},step=3", **kw)
    _check(eng.mode == "continuous" and eng.stats.mode == "continuous",
           f"lm continuous: mode='auto' resolved to {eng.stats.mode}")
    for t in tiers:
        eng.tier_params(t)
    print(f"lm continuous: qwen3-14b depth {LM_LAYERS}, tiers {names}, max_len {CONT_MAX_LEN}, "
          f"slot widths {eng.batch_buckets}, {eng.decode_steps_per_poll} steps a burst; "
          f"{n_req} requests of {sorted({len(p) for p in prompts})} tokens, request {sampled} "
          f"sampled, faults slot_alloc@{alloc}, nan@decode.logits@{nan}")
    tracer = obs_trace.Tracer(capacity=8192)
    prev = obs_trace.install(tracer)
    reqs = [None] * n_req
    outcome = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with probe.tracking() as log, _LogitTap(eng) as tap, \
                AsyncServer(eng) as srv:  # counts start at 0 here
            def submit(i):
                g = torch.Generator(device=dev).manual_seed(11) if i == sampled else None
                reqs[i] = srv.submit(prompts[i], LM_GEN, tier=assign[i], generator=g)

            submit(0)
            submit(1)
            t_wait = time.perf_counter() + 300
            while eng.active < 2 and time.perf_counter() < t_wait:
                time.sleep(0.002)
            _check(eng.active >= 2, "lm continuous: the first two requests never ran")
            for i in range(2, n_req):  # arrive while the first two decode
                submit(i)
            for i, r in enumerate(reqs):
                try:
                    outcome[i] = srv.result(r, timeout=600)
                except ServeError as e:
                    outcome[i] = e
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        obs_trace.install(prev)
    ttft = _ttft_ms(tracer, reqs)
    _serve_report(torch, eng, "lm continuous", ttft, wall, peak)
    print(f"lm continuous: the logit tap keeps {tap.gib():.3f} GiB of that peak")
    _check(type(outcome[alloc]).__name__ == "InjectedFault", f"slot_alloc: {outcome[alloc]!r}")
    _check(type(outcome[nan]).__name__ == "NumericFault", f"nan fault: {outcome[nan]!r}")
    served = [i for i in range(n_req) if i not in (alloc, nan)]
    for i in served:
        _check(isinstance(outcome[i], np.ndarray) and outcome[i].shape == (LM_GEN,),
               f"lm continuous: request {i} not delivered: {outcome[i]!r}")
    sched = eng.stats.scheduler
    _check(sched.admitted_mid_decode >= 1, "lm continuous: nothing joined mid-decode")
    _check(sched.numeric_faults == 1, f"numeric faults {sched.numeric_faults}")
    _check(all(type(r) is DecodeRunner for r in eng._sched._runners.values()),
           "lm continuous: served through DecodeRunner")

    n = cfg.n_layers
    calls = {t: [sum(s.calls for b, s in eng.stats.buckets.items()
                     if b.tier == t and type(b).__name__ == k)
                 for k in ("PrefillBucket", "DecodeBucket")] for t in names}
    want = {"quant_matmul": 7 * n * sum(calls["balanced"])}
    print(f"lm continuous: launches {log.by_name()}; (prefill waves, decode steps) per tier "
          f"{calls}")
    _check(log.by_name() == want, f"lm continuous: launches {log.by_name()}, expected {want} (7 x "
                                  f"{n} per balanced prefill wave and decode step, none on "
                                  "quality)")

    # greedy ids against bucket mode; the sampled request against itself alone
    beng = Engine(cfg, raw, mode="bucket", max_batch=4, max_wait_s=60.0, **kw)
    greedy = [i for i in served if i != sampled]
    with _LogitTap(beng) as btap:
        breqs = {i: beng.enqueue(prompts[i], LM_GEN, tier=assign[i]) for i in greedy}
        beng.flush()
    same = 0
    for i in greedy:
        want_ids = breqs[i].result()
        same += int(np.array_equal(want_ids, outcome[i]))
        _hold_same_ids(torch, f"lm continuous request {i} ({assign[i]}) vs bucket mode", want_ids,
                       outcome[i], lambda s_, i=i: btap.at(breqs[i], s_),
                       lambda s_, i=i: tap.at(reqs[i], s_),
                       _forced_at(torch, eng.cfg, prompts[i], eng.prompt_bucket(len(prompts[i])),
                                  True, want_ids, CONT_MAX_LEN),
                       eng.tier_params(assign[i]))
    del beng, btap
    with _LogitTap(eng) as atap:
        alone = eng.enqueue(prompts[sampled], LM_GEN, tier=assign[sampled],
                            generator=torch.Generator(device=dev).manual_seed(11))
        eng.flush()
    _check(np.array_equal(alone.seeds, reqs[sampled].seeds), "sampled request: seeds differ")
    same_sampled = bool(np.array_equal(alone.result(), outcome[sampled]))
    seed = torch.as_tensor(alone.seeds[:1], device=dev)
    _hold_same_ids(torch, f"lm continuous sampled request {sampled} alone vs coalesced",
                   alone.result(), outcome[sampled], lambda s_: atap.at(alone, s_),
                   lambda s_: tap.at(reqs[sampled], s_),
                   _forced_at(torch, eng.cfg, prompts[sampled],
                              eng.prompt_bucket(len(prompts[sampled])), True, alone.result(),
                              CONT_MAX_LEN),
                   eng.tier_params(assign[sampled]),
                   noise_at=lambda s_: gumbel_rows(seed, torch.full_like(seed, s_),
                                                   eng.cfg.vocab_size)[0])
    del tap, atap
    print(f"lm continuous: greedy ids equal bucket mode's for {same} of {len(greedy)} requests; "
          f"the sampled request served alone gives the same ids: {same_sampled}")
    _profile_burst(torch, eng, prompts, "lm continuous")
    del eng
    print(f"lm continuous: phase {time.perf_counter() - t_phase:.1f}s")
    return {"counts": log.by_name(), "runs": 1, "inplace": {}}


def phase_rwkv(torch, dev) -> dict:
    """See the module docstring (11)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.models import rwkv as R
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving.engine import Engine, StateDecodeRunner

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("rwkv6-1.6b")
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = {n_: s.materialize() for n_, s in ServeSpec.parse_tiers("fp=fp,w4a8=w4a8").items()}
    names = list(tiers)
    kw = dict(tiers=tiers, max_len=max(RWKV_PROMPTS) + RWKV_GEN, batch_buckets=(1, 2, 4),
              device="cuda")
    eng = Engine(cfg, raw, mode="auto", max_batch=8, decode_steps_per_poll=8, **kw)
    _check(eng.mode == "continuous" and not eng.pad_prompts, f"rwkv: mode {eng.stats.mode}")
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"rwkv: rwkv6-1.6b, {n} layers (d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim}"
          f" heads of {cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), seed-0 weights "
          f"and both tiers in {time.perf_counter() - t_phase:.1f}s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (m,)).astype(np.int32) for m in RWKV_PROMPTS]
    assign = [names[i % 2] for i in range(len(prompts))]

    # each W4A8 layer's two branches against the plain versions
    qparams = eng.tier_params("w4a8")
    toks = torch.as_tensor(prompts[0][None], device=dev).long()
    steps = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 4)), device=dev).long()
    _lm_branches(torch, cfg, qparams, toks, "rwkv w4a8")
    _lm_branches(torch, cfg, qparams, toks, "rwkv w4a8", steps=steps)

    # the WKV loop's share of a prefill of the longest prompt: the whole
    # forward's wall time, and the recurrence's own calls timed inside one
    # more forward (synchronized around each call)
    L = max(RWKV_PROMPTS)
    longest = torch.as_tensor(prompts[int(np.argmax(RWKV_PROMPTS))][None], device=dev).long()
    loop, pre = R.wkv_recurrence, {}
    for t in names:
        p_t = eng.tier_params(t)

        def prefill(p_t=p_t):
            lm.forward(cfg, p_t, longest, cache=lm.init_cache(cfg, 1, L, device=dev),
                       mode="prefill")

        with torch.inference_mode():
            wall = _wall_ms(torch, prefill)
            spent = []

            def timed(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = loop(*a)
                torch.cuda.synchronize()
                spent.append((time.perf_counter() - t0) * 1e3)
                return out

            R.wkv_recurrence = timed
            try:
                prefill()
            finally:
                R.wkv_recurrence = loop
        pre[t] = (wall, sum(spent))
    print(f"rwkv: [1, {L}] prefill forward (wall, median of 3) and its {n} WKV loops (one more "
          "forward, each loop synchronized): "
          + "; ".join(f"{t} {w:.1f}ms, loops {s_:.1f}ms ({s_ / n:.2f}ms a layer)"
                      for t, (w, s_) in pre.items()))

    # serve: two requests first, the rest join mid-decode
    tracer = obs_trace.Tracer(capacity=8192)
    prev = obs_trace.install(tracer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with probe.tracking() as log, _LogitTap(eng) as tap:  # counts start at 0 here
            reqs = [eng.enqueue(prompts[i], RWKV_GEN, tier=assign[i]) for i in (0, 1)]
            time.sleep(2 * eng.max_wait_s)
            eng.poll()
            _check(eng.active == 2, f"rwkv: the first two requests are not decoding ({eng.active})")
            reqs += [eng.enqueue(prompts[i], RWKV_GEN, tier=assign[i])
                     for i in range(2, len(prompts))]
            while not all(q.ready for q in reqs):
                eng.poll()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        obs_trace.install(prev)
    outs = [q.result() for q in reqs]
    _serve_report(torch, eng, "rwkv", _ttft_ms(tracer, reqs), wall, peak)
    print(f"rwkv: the logit tap keeps {tap.gib():.3f} GiB of that peak")
    _check(all(o.shape == (RWKV_GEN,) for o in outs), "rwkv: every request delivered")
    _check(eng.stats.scheduler.admitted_mid_decode >= 1, "rwkv: nothing joined mid-decode")
    _check(all(isinstance(r_, StateDecodeRunner) for r_ in eng._sched._runners.values()),
           "rwkv: served through StateDecodeRunner")
    _check(all(any(type(b).__name__ == "PrefillBucket" and b.prompt_len == len(p)
                   for b in eng.stats.buckets) for p in prompts), "rwkv: exact-length buckets")
    calls = {t: [sum(s.calls for b, s in eng.stats.buckets.items()
                     if b.tier == t and type(b).__name__ == k)
                 for k in ("PrefillBucket", "DecodeBucket")] for t in names}
    want = {"quant_matmul": 7 * n * sum(calls["w4a8"])}
    print(f"rwkv: launches {log.by_name()}; (prefill waves, decode steps) per tier {calls}")
    _check(log.by_name() == want, f"rwkv: launches {log.by_name()}, expected {want} (7 x {n} per "
                                  "w4a8 prefill wave and decode step, none on fp)")

    beng = Engine(cfg, raw, mode="bucket", max_batch=4, max_wait_s=60.0, **kw)
    with _LogitTap(beng) as btap:
        breqs = [beng.enqueue(p, RWKV_GEN, tier=t) for p, t in zip(prompts, assign)]
        beng.flush()
    same = 0
    for i, (b, o) in enumerate(zip(breqs, outs)):
        same += int(np.array_equal(b.result(), o))
        _hold_same_ids(torch, f"rwkv request {i} ({assign[i]}) vs bucket mode", b.result(), o,
                       lambda s_, b=b: btap.at(b, s_), lambda s_, i=i: tap.at(reqs[i], s_),
                       _forced_at(torch, cfg, prompts[i], len(prompts[i]), False, b.result(),
                                  kw["max_len"]),
                       eng.tier_params(assign[i]))
    del beng, btap, tap
    print(f"rwkv: ids equal bucket mode's for {same} of {len(outs)} requests")
    _profile_burst(torch, eng, prompts, "rwkv")
    del eng, raw, qparams
    print(f"rwkv: phase {time.perf_counter() - t_phase:.1f}s")
    return {"counts": log.by_name(), "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 11b: LM schedules (the planner's and the compiler's LM walks)
# ---------------------------------------------------------------------------


class _CallLaunches:
    """Each served prefill wave's and decode step's kernel launches, read
    from ``kernels.probe``: every ``lm.forward`` call (the engine's prefill,
    and ``lm.decode_step``, which calls it with ``mode="decode"``) runs
    under a ``probe.tracking`` log of its own, kept here as ``(mode,
    launches)``.  The logs nest in any outer one, so the phase's counted
    window still sees every launch."""

    def __enter__(self):
        from repro_torch.kernels import probe
        from repro_torch.models import lm

        self.calls = []
        self._saved = fwd = lm.forward

        def run(*a, **kw):
            with probe.tracking() as log:
                out = fwd(*a, **kw)
            self.calls.append((kw.get("mode", "full"), log.by_name()))
            return out

        lm.forward = run
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm

        lm.forward = self._saved
        return False

    def hold(self, tag, want) -> dict:
        """Every call launched ``want``; returns {kind: calls}."""
        n = {}
        for kind, got in self.calls:
            _check(got == want, f"{tag}: a {kind} call launched {got}, the schedule predicts "
                                f"{want}")
            n[kind] = n.get(kind, 0) + 1
        _check(n.get("prefill", 0) >= 1 and n.get("decode", 0) >= 1,
               f"{tag}: prefill waves and decode steps {n}")
        return n


def _padded(torch, dev, prompts, idx, L):
    """Requests ``idx`` left-padded to ``L`` tokens, and their pad counts."""
    toks = torch.stack([torch.nn.functional.pad(torch.as_tensor(prompts[i], device=dev).long(),
                                                (L - len(prompts[i]), 0)) for i in idx])
    return toks, torch.tensor([L - len(prompts[i]) for i in idx], device=dev)


def _bucket_ms(eng, kind: str) -> tuple[float, int]:
    """Mean ms a call over every bucket of ``kind`` (PrefillBucket or
    DecodeBucket), and the calls."""
    ss = [s for b, s in eng.stats.buckets.items() if type(b).__name__ == kind]
    calls = sum(s.calls for s in ss)
    return 1e3 * sum(s.total_s for s in ss) / max(calls, 1), calls


def phase_lm_schedule(torch, dev, raw) -> dict:
    """See the module docstring (11b)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import (
        Autotuner, KernelSchedule, PrecisionPlan, TuningDB, compile_schedule, plan_model,
    )
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import AsyncServer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    counts = {}

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    # (a) qwen3-14b, 8 of 40 layers: plan, tune, compile, serve the schedule
    cfg = get_config("qwen3-14b").with_(n_layers=LM_LAYERS)
    t0 = time.perf_counter()
    plan, report = plan_model(cfg, raw, name="plan", use_kernel=True, fuse=True)
    print(f"lm schedule: planned qwen3-14b ({LM_LAYERS} layers) in "
          f"{time.perf_counter() - t0:.1f}s: levels {report['level_counts']}, default "
          f"{plan.default}, overrides {list(plan.overrides)}; modeled weights "
          f"{report['weight_bytes'] / 1e6:.1f} of {report['weight_bytes_budget'] / 1e6:.1f} MB, "
          f"latency {report['modeled_latency_s'] * 1e3:.3f} of "
          f"{report['latency_budget_s'] * 1e3:.3f} ms")
    for site, errs in report["site_errors"].items():
        print(f"  site {site:24s} {report['assignment'][site]:5s} errors "
              + " ".join(f"{lv}={e:.4g}" for lv, e in errs.items()))
    db_path, path = work / "lm_tune.json", work / "qwen3.schedule.json"
    db_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    tuner = Autotuner(db=TuningDB(str(db_path)), device="cuda")
    sched = compile_schedule(cfg, plan, tuner=tuner)
    print(f"lm schedule: compiled in {time.perf_counter() - t0:.1f}s: {sched.summary()}, "
          f"{len(sched.groups)} fused groups, {tuner.timing_runs} timing runs, "
          f"hash {sched.hash[:12]}")
    for key, e in sorted(tuner.db.entries.items()):
        print(f"  tuned {key}: {e['cost']:.4f} ms (tiles {e['tiles']})")
    for s in sched.sites:
        if s.fallback:
            print(f"  fallback {s.site}: {s.fallback}")
    _check(tuner.timing_runs == len(tuner.db.entries) > 0, "lm schedule: one timing run a "
                                                           "signature")
    again = Autotuner(db=TuningDB(str(db_path)), device="cuda")
    _check(compile_schedule(cfg, plan, tuner=again).hash == sched.hash,
           "lm schedule: the recompile changed the schedule")
    print(f"lm schedule: recompiled on the filled DB: {again.timing_runs} timing runs, "
          f"{again.db.hits} hits / {again.db.misses} misses")
    _check(again.timing_runs == 0 and again.db.misses == 0, "lm schedule: the recompile timed")
    sched.save(path)
    _check(KernelSchedule.load(path).hash == sched.hash, "lm schedule: save/load")
    want = sched.launches_per_forward(two_stage_attention=False)
    print(f"lm schedule: launches the schedule predicts per prefill wave and decode step: {want}")

    eng = Engine(cfg, raw, schedule=str(path), mode="auto", max_len=CONT_MAX_LEN,
                 batch_buckets=(1, 2, 4), max_batch=4, decode_steps_per_poll=8, device="cuda")
    _check(eng.continuous, f"lm schedule: mode='auto' resolved to {eng.stats.mode}")
    _check(eng.cfg.attn_tiles == sched.attention_targets(), "lm schedule: attention tiles")
    params_s = eng.params
    torch.cuda.synchronize()
    prompts = mixed_len_prompts(cfg.vocab_size, 4, LM_PROMPT)
    gen = 16
    reqs = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with probe.tracking() as log, _CallLaunches() as calls, AsyncServer(eng) as srv:
        reqs += [srv.submit(p, gen) for p in prompts[:2]]
        t_wait = time.perf_counter() + 300
        while eng.active < 2 and time.perf_counter() < t_wait:
            time.sleep(0.002)
        _check(eng.active >= 2, "lm schedule: the first two requests never ran")
        reqs += [srv.submit(p, gen) for p in prompts[2:]]
        outs = [srv.result(r, timeout=600) for r in reqs]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    add(log.by_name())
    n_calls = calls.hold("lm schedule", want)
    _check(all(o.shape == (gen,) for o in outs), "lm schedule: every request delivered")
    _check(eng.stats.scheduler.admitted_mid_decode >= 1, "lm schedule: nothing joined mid-decode")
    _check(all(key[-1] == sched.hash for key in eng._seen), "lm schedule: first-use keys")
    pre_ms, waves = _bucket_ms(eng, "PrefillBucket")
    dec_ms, steps = _bucket_ms(eng, "DecodeBucket")
    print(eng.stats.format())
    print(f"lm schedule: qwen3-14b planned schedule served {len(outs)} requests of "
          f"{sorted({len(p) for p in prompts})} tokens, {gen} new each, in {wall:.2f}s: prefill "
          f"{pre_ms:.2f}ms a wave over {waves} waves, decode {dec_ms:.3f}ms a step over {steps} "
          f"steps, admitted mid-decode {eng.stats.scheduler.admitted_mid_decode}, peak memory "
          f"{peak:.2f} GiB; every one of {n_calls} calls launched {want}")

    # teacher-forced on the served tokens (requests 1 and 2: 384 and 512)
    idx = [1, 2]
    L = eng.prompt_bucket(max(len(prompts[i]) for i in idx))
    toks, pad = _padded(torch, dev, prompts, idx, L)
    served = torch.stack([torch.as_tensor(outs[i]) for i in idx]).to(dev).long()
    got = _teacher_forced(torch, eng.cfg, params_s, toks, pad, served[:, :4], CONT_MAX_LEN)
    with _PlainKernels():
        plain = _teacher_forced(torch, eng.cfg, params_s, toks, pad, served[:, :4], CONT_MAX_LEN)
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
    print(f"lm schedule: teacher-forced logits vs plain rel L2 (prefill, 4 decode steps) "
          f"{[f'{r:.3g}' for r in rels]}")
    _check(max(rels) < 1e-3, f"lm schedule vs plain: {rels}")
    del got, plain, eng

    # one scoring forward [1, 512] under the schedule's attention tiles
    scfg = cfg.with_(attn_impl="two_stage", attn_tiles=sched.attention_targets())
    want_full = sched.launches_per_forward(two_stage_attention=True)
    x = toks[1:]
    with torch.inference_mode(), probe.tracking() as flog:
        full, _ = lm.forward(scfg, params_s, x)
        torch.cuda.synchronize()
    add(flog.by_name())
    _check(flog.by_name() == want_full, f"lm schedule scoring forward launches "
                                        f"{flog.by_name()}, expected {want_full}")
    _check(flog.by_name().get("two_stage_attention") == LM_LAYERS,
           "lm schedule: the scoring forward's dh-128 two-stage launches")
    with torch.inference_mode(), _PlainKernels():
        full_plain, _ = lm.forward(scfg, params_s, x)
    rel = _rel(torch, full, full_plain)
    print(f"lm schedule: scoring forward [1, {x.shape[1]}] launches {flog.by_name()}; vs plain "
          f"rel L2 {rel:.3g}")

    def moved():
        with torch.inference_mode(), _PlainKernels():
            out, _ = lm.forward(scfg, _noised(torch, params_s), x)
        return [_rel(torch, out, full_plain)]

    _hold_lm(torch, "lm schedule scoring forward", [rel], moved)
    del full, full_plain, params_s, toks, x

    # (b) deepseek-moe-16b at full width, 2 layers, w4a8:fused: fused_matmul
    # for wqkv and wo, the batched launch for the routed experts
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get_config("deepseek-moe-16b").with_(n_layers=2)
    mraw = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0))
    mtuner = Autotuner(db=TuningDB(str(db_path)), device="cuda")
    msched = compile_schedule(mcfg, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True,
                                                  name="w4a8"), tuner=mtuner)
    for key, e in sorted(mtuner.db.entries.items()):
        if key not in tuner.db.entries:
            print(f"  tuned {key}: {e['cost']:.4f} ms (tiles {e['tiles']})")
    mpath = work / "deepseek.schedule.json"
    msched.save(mpath)
    mwant = msched.launches_per_forward(two_stage_attention=False)
    print(f"lm schedule: deepseek-moe-16b (2 of 28 layers) w4a8:fused: {msched.summary()}, "
          f"groups {[g.name for g in msched.groups]} (wo epilogue "
          f"{[g.wo_epilogue for g in msched.groups]}); predicted per call {mwant}")
    for s in msched.sites:
        if s.fallback:
            print(f"  fallback {s.site}: {s.fallback}")
    moe_layers = mcfg.n_layers - mcfg.first_dense
    _check(mwant.get("fused_matmul") == 2 * mcfg.n_layers
           and mwant.get("quant_matmul_batched") == 3 * moe_layers,
           f"deepseek schedule predicts {mwant}: wqkv and wo on fused_matmul a layer, the "
           "routed experts on 3 batched launches a MoE layer")
    meng = Engine(mcfg, mraw, schedule=str(mpath), mode="auto", max_len=CONT_MAX_LEN,
                  batch_buckets=(1, 2, 4), max_batch=4, device="cuda")
    mparams = meng.params
    mprompts = mixed_len_prompts(mcfg.vocab_size, 2, LM_PROMPT)
    with probe.tracking() as mlog, _CallLaunches() as mcalls:
        mreqs = [meng.enqueue(p, 5) for p in mprompts]
        meng.flush()
        torch.cuda.synchronize()
    add(mlog.by_name())
    n_m = mcalls.hold("deepseek schedule", mwant)
    _check(n_m == {"prefill": 1, "decode": 4}, f"deepseek schedule: calls {n_m}")
    mouts = [r.result() for r in mreqs]
    print(f"lm schedule: deepseek served {n_m['prefill']} prefill wave and {n_m['decode']} decode "
          f"steps, launches {mlog.by_name()}")
    mtoks, mpad = _padded(torch, dev, mprompts, [0, 1], meng.prompt_bucket(LM_PROMPT))
    msteps = torch.stack([torch.as_tensor(o) for o in mouts]).to(dev).long()[:, :4]
    # The whole-model logits: fused_matmul's prologue sums the RMS norm in
    # another order than the plain version (rel 1.8e-7 a launch), an int8
    # rounding it flips can move a token to another expert, and routing
    # turns that into a step in the logits at whichever step it happens, as
    # a last-bit change of the embedding does.  So each step's reading is
    # held to NOISE_MARGIN times the plain versions' largest movement over
    # the run's steps under two such changes (PERF.md, section 6: a
    # step-by-step pairing failed once, 0.0756 against 3 x 0.0247, while
    # the next step moved 0.0742).  The layers are held below, each fed the
    # same input.
    got = _teacher_forced(torch, meng.cfg, mparams, mtoks, mpad, msteps, CONT_MAX_LEN)
    with _PlainKernels():
        plain = _teacher_forced(torch, meng.cfg, mparams, mtoks, mpad, msteps, CONT_MAX_LEN)
    _check(all(torch.isfinite(g).all() for g in got), "deepseek schedule: non-finite logits")
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
    print(f"lm schedule: deepseek teacher-forced logits vs plain rel L2 (prefill, 4 decode "
          f"steps) {[f'{r:.3g}' for r in rels]}")

    def moved():
        runs = []
        with _PlainKernels():
            for seed in (7, 8):
                again = _teacher_forced(torch, meng.cfg, _noised(torch, mparams, seed), mtoks,
                                        mpad, msteps, CONT_MAX_LEN)
                runs.append([_rel(torch, a, w) for a, w in zip(again, plain)])
        print(f"  deepseek schedule: the plain versions' own movement per step under last-bit "
              f"embedding changes (seeds 7, 8) {[[f'{m:.3g}' for m in r] for r in runs]}")
        return [max(max(r) for r in runs)] * len(rels)

    _hold_lm(torch, "deepseek schedule teacher-forced", rels, moved)
    del got, plain
    _lm_branches(torch, meng.cfg, mparams, mtoks, "deepseek schedule", pad=mpad, steps=msteps)
    del meng, mparams, mraw

    # (c) rwkv6-1.6b: a full-depth compile on meta, a 2-layer cut served
    rcfg = get_config("rwkv6-1.6b")
    w4a8 = PrecisionPlan(default="w4a8", use_kernel=True, name="w4a8")
    t0 = time.perf_counter()
    rfull = compile_schedule(rcfg, w4a8)
    print(f"lm schedule: rwkv6-1.6b ({rcfg.n_layers} layers) w4a8 compiled on meta in "
          f"{(time.perf_counter() - t0) * 1e3:.1f}ms: {rfull.summary()}, attention "
          f"{rfull.attention}, predicted per call {rfull.launches_per_forward(two_stage_attention=False)}")
    rcut = rcfg.with_(n_layers=2)
    rsched = compile_schedule(rcut, w4a8)
    rwant = rsched.launches_per_forward(two_stage_attention=False)
    _check(rwant == {"quant_matmul": 14}, f"rwkv6 schedule predicts {rwant}")
    rraw = lm.init_params(rcut, torch.Generator(device=dev).manual_seed(0))
    reng = Engine(rcut, rraw, schedule=rsched, mode="auto", max_len=CONT_MAX_LEN, device="cuda")
    reng.params
    with probe.tracking() as rlog, _CallLaunches() as rcalls:
        rreq = reng.enqueue(mixed_len_prompts(rcut.vocab_size, 1, 96)[0], 3)
        reng.flush()
        torch.cuda.synchronize()
    add(rlog.by_name())
    n_r = rcalls.hold("rwkv6 schedule", rwant)
    _check(n_r == {"prefill": 1, "decode": 2} and rreq.result().shape == (3,),
           f"rwkv6 schedule: calls {n_r}")
    print(f"lm schedule: rwkv6 (2 layers) served 1 prefill wave and 2 decode steps, launches "
          f"{rlog.by_name()}")
    del reng, rraw

    # (d) the launcher: a 40-layer qwen3-14b compile on meta, as a subprocess
    out_path = work / "qwen3-14b.w4a8-fused.schedule.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.compile", "--arch", "qwen3-14b", "--spec",
         "w4a8:fused", "--out", str(out_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    print(f"lm schedule: python -m repro_torch.launch.compile --arch qwen3-14b --spec w4a8:fused "
          f"exited {proc.returncode} in {time.perf_counter() - t0:.1f}s: "
          f"{proc.stdout.strip().splitlines()[:1]}")
    _check(proc.returncode == 0, f"launcher: {proc.stderr[-2000:]}")
    inproc = compile_schedule(get_config("qwen3-14b"), PrecisionPlan(
        default="w4a8", use_kernel=True, fuse=True, name="w4a8"))
    _check(f"sites={len(inproc.sites)} groups={len(inproc.groups)}" in proc.stdout
           and KernelSchedule.load(out_path).hash == inproc.hash,
           f"launcher: {proc.stdout} vs sites={len(inproc.sites)} groups={len(inproc.groups)}")
    print(f"lm schedule: the launcher's schedule equals the in-process compile (hash "
          f"{inproc.hash[:12]}, {inproc.launches_per_forward(two_stage_attention=False)} a call)")
    print(f"lm schedule: phase {time.perf_counter() - t_phase:.1f}s")
    return {"counts": counts, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 12: deepseek-moe-16b (the MoE FFN and quant_matmul's batched launch)
# ---------------------------------------------------------------------------


def _moe_launches(cfg, calls: int) -> dict:
    """A W4A8 deepseek stack's launches in ``calls`` prefill waves or decode
    steps: 2-D ``quant_matmul`` for the 4 attention projections a layer,
    the dense first layers' 3 FFN sites and each MoE layer's 3 shared-expert
    sites (7 a layer in all); one batched launch a routed projection."""
    n, moe = cfg.n_layers, cfg.n_layers - cfg.first_dense
    return {"quant_matmul": (4 * n + 3 * cfg.first_dense + 3 * moe) * calls,
            "quant_matmul_batched": 3 * moe * calls}


def phase_moe(torch, dev) -> dict:
    """See the module docstring (12)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving.batching import ServeError
    from repro_torch.serving.engine import DecodeRunner, Engine
    from repro_torch.serving.server import AsyncServer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("deepseek-moe-16b").with_(n_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = {n: s.materialize() for n, s in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    names = list(tiers)
    n_req, nan = 8, 5  # request 5 (an enqueue ordinal) is poisoned
    prompts = mixed_len_prompts(cfg.vocab_size, n_req, LM_PROMPT)
    # q b b q q b b q: each tier serves both prompt lengths
    assign = [names[((i + 1) // 2) % 2] for i in range(n_req)]
    eng = Engine(cfg, raw, tiers=tiers, attn_impl="two_stage", mode="auto", max_len=CONT_MAX_LEN,
                 batch_buckets=(1, 2, 4), max_batch=8, decode_steps_per_poll=8,
                 faults=f"nan@decode.logits:req={nan},step=3", device="cuda")
    _check(eng.mode == "continuous", f"moe: mode='auto' resolved to {eng.stats.mode}")
    t0 = time.perf_counter()
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"moe: deepseek-moe-16b depth {MOE_LAYERS} of 28 layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_experts} routed experts "
          f"of {cfg.moe_d_ff} at top-{cfg.top_k}, {cfg.n_shared_experts} shared, dense layer 0 "
          f"at {cfg.dense_d_ff}, vocab {cfg.vocab_size}); tiers quantized in "
          f"{time.perf_counter() - t0:.1f}s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    tracer = obs_trace.Tracer(capacity=8192)
    prev = obs_trace.install(tracer)
    reqs = [None] * n_req
    outcome = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with probe.tracking() as log, AsyncServer(eng) as srv:  # counts start at 0 here
            def submit(i):
                reqs[i] = srv.submit(prompts[i], LM_GEN, tier=assign[i])

            submit(0)
            submit(1)
            t_wait = time.perf_counter() + 300
            while eng.active < 2 and time.perf_counter() < t_wait:
                time.sleep(0.002)
            _check(eng.active >= 2, "moe: the first two requests never ran")
            for i in range(2, n_req):  # arrive while the first two decode
                submit(i)
            for i, r in enumerate(reqs):
                try:
                    outcome[i] = srv.result(r, timeout=600)
                except ServeError as e:
                    outcome[i] = e
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        obs_trace.install(prev)
    _serve_report(torch, eng, "moe", _ttft_ms(tracer, reqs), wall, peak)
    for tier in names:
        pre = [s for b, s in eng.stats.buckets.items()
               if b.tier == tier and type(b).__name__ == "PrefillBucket"]
        print(f"moe {tier}: prefill {1e3 * sum(s.total_s for s in pre) / sum(s.calls for s in pre):.2f}"
              f"ms a wave over {sum(s.calls for s in pre)} waves of "
              f"{sum(s.items for s in pre)} requests")
    _check(type(outcome[nan]).__name__ == "NumericFault", f"moe nan fault: {outcome[nan]!r}")
    served = [i for i in range(n_req) if i != nan]
    for i in served:
        _check(isinstance(outcome[i], np.ndarray) and outcome[i].shape == (LM_GEN,),
               f"moe: request {i} not delivered: {outcome[i]!r}")
    sched = eng.stats.scheduler
    _check(sched.admitted_mid_decode >= 1, "moe: nothing joined mid-decode")
    _check(sched.numeric_faults == 1, f"moe: numeric faults {sched.numeric_faults}")
    _check(all(type(r) is DecodeRunner for r in eng._sched._runners.values()),
           "moe: served through DecodeRunner")
    calls = {t: [sum(s.calls for b, s in eng.stats.buckets.items()
                     if b.tier == t and type(b).__name__ == k)
                 for k in ("PrefillBucket", "DecodeBucket")] for t in names}
    want = _moe_launches(cfg, sum(calls["balanced"]))
    print(f"moe: launches {log.by_name()}; (prefill waves, decode steps) per tier {calls}")
    _check(log.by_name() == want, f"moe: launches {log.by_name()}, expected {want} (per balanced "
                                  "prefill wave and decode step; none on quality)")

    # the balanced tier against the plain versions at the same rows and
    # pads (so routing and capacity are the same): requests 1 (384 tokens)
    # and 2 (512) teacher-forced on their served tokens
    params_b = eng.tier_params("balanced")
    idx = [1, 2]
    L = eng.prompt_bucket(max(len(prompts[i]) for i in idx))
    toks = torch.stack([torch.nn.functional.pad(torch.as_tensor(prompts[i], device=dev).long(),
                                                (L - len(prompts[i]), 0)) for i in idx])
    pad = torch.tensor([L - len(prompts[i]) for i in idx], device=dev)
    served_ids = torch.stack([torch.as_tensor(outcome[i]) for i in idx]).to(dev).long()
    got = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served_ids[:, :4], CONT_MAX_LEN)
    with _PlainKernels():
        plain = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served_ids[:, :4],
                                CONT_MAX_LEN)
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
    picked = torch.stack([w.argmax(dim=-1) for w in plain], dim=1)
    agree = int((picked == served_ids[:, :5]).sum())
    print(f"moe balanced: teacher-forced logits vs plain rel L2 (prefill, 4 decode steps) "
          f"{[f'{r:.3g}' for r in rels]}; plain versions pick the served token {agree} of "
          f"{picked.numel()} times (the served rows decoded beside other slots)")

    def moved():
        with _PlainKernels():
            again = _teacher_forced(torch, eng.cfg, _noised(torch, params_b), toks, pad,
                                    served_ids[:, :4], CONT_MAX_LEN)
        return [_rel(torch, a, w) for a, w in zip(again, plain)]

    _hold_lm(torch, "moe balanced teacher-forced", rels, moved)
    del got, plain
    _lm_branches(torch, eng.cfg, params_b, toks, "moe balanced", pad=pad, steps=served_ids[:, :4])
    _profile_burst(torch, eng, prompts, "moe")
    del eng
    # one scoring forward of the W4A8 tree through the dh-128 two-stage kernel
    n = cfg.n_layers
    score = _lm_score(torch, dev, params_b, cfg,
                      want={**_moe_launches(cfg, 1), "two_stage_attention": n})
    counts = dict(log.by_name())
    for k, v in score.items():
        counts[k] = counts.get(k, 0) + v
    del raw, params_b
    print(f"moe: phase {time.perf_counter() - t_phase:.1f}s; launches served {log.by_name()}, "
          f"scoring forward {score}")
    return {"counts": counts, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phases 13-14: phi3-mini-3.8b and paligemma-3b at full width and depth
# ---------------------------------------------------------------------------


def _raises(fn, exc, text: str, tag: str) -> None:
    """``fn()`` must raise ``exc`` with ``text`` in its message."""
    try:
        fn()
    except exc as e:
        _check(text in str(e), f"{tag}: {type(e).__name__}: {e}")
        return
    _fail(f"{tag}: no {exc.__name__} raised")


def phase_phi3(torch, dev) -> dict:
    """See the module docstring (13)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import AsyncServer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("phi3-mini-3.8b")
    n = cfg.n_layers
    print(f"phi3: phi3-mini-3.8b at full depth, {n} layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_counts()[0] / 1e9:.2f} B parameters)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tiers = {k: v.materialize() for k, v in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    names = list(tiers)
    kw = dict(tiers=tiers, attn_impl="two_stage", max_len=CONT_MAX_LEN, batch_buckets=(1, 2, 4),
              device="cuda")
    eng = Engine(cfg, raw, mode="auto", max_batch=4, decode_steps_per_poll=8, **kw)
    _check(eng.mode == "continuous", f"phi3: mode='auto' resolved to {eng.stats.mode}")
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"phi3: weights and tiers quantized in {time.perf_counter() - t0:.1f}s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_req = 6
    prompts = mixed_len_prompts(cfg.vocab_size, n_req, ZOO_PROMPT)
    assign = [names[i % 2] for i in range(n_req)]
    counts = {}

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    # continuous: two requests first, four joining while those decode
    tracer = obs_trace.Tracer(capacity=4096)
    prev = obs_trace.install(tracer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with probe.tracking() as log, _LogitTap(eng) as tap, AsyncServer(eng) as srv:
            reqs = [srv.submit(prompts[i], ZOO_GEN, tier=assign[i]) for i in (0, 1)]
            t_wait = time.perf_counter() + 300
            while eng.active < 2 and time.perf_counter() < t_wait:
                time.sleep(0.002)
            _check(eng.active >= 2, "phi3: the first two requests never ran")
            reqs += [srv.submit(prompts[i], ZOO_GEN, tier=assign[i]) for i in range(2, n_req)]
            outs = [srv.result(r, timeout=600) for r in reqs]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        obs_trace.install(prev)
    _serve_report(torch, eng, "phi3 continuous", _ttft_ms(tracer, reqs), wall, peak)
    _check(all(o.shape == (ZOO_GEN,) for o in outs), "phi3 continuous: every request delivered")
    _check(eng.stats.scheduler.admitted_mid_decode >= 1, "phi3: nothing joined mid-decode")
    calls = {t: [sum(s.calls for b, s in eng.stats.buckets.items()
                     if b.tier == t and type(b).__name__ == k)
                 for k in ("PrefillBucket", "DecodeBucket")] for t in names}
    want = {"quant_matmul": 7 * n * sum(calls["balanced"])}
    print(f"phi3 continuous: launches {log.by_name()}; (prefill waves, decode steps) per tier "
          f"{calls}")
    _check(log.by_name() == want, f"phi3 continuous: launches {log.by_name()}, expected {want}")
    add(log.by_name())

    # bucket mode on the same requests: its launches, its ids against continuous
    beng = Engine(cfg, raw, mode="bucket", max_batch=2, max_wait_s=60.0, **kw)
    for t in tiers:
        beng.tier_params(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with probe.tracking() as blog, _LogitTap(beng) as btap:
        breqs = [beng.enqueue(p, ZOO_GEN, tier=assign[i]) for i, p in enumerate(prompts)]
        beng.flush()
        torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    bcalls = {t: [sum(s.calls for b, s in beng.stats.buckets.items()
                      if b.tier == t and type(b).__name__ == k)
                  for k in ("PrefillBucket", "DecodeBucket")] for t in names}
    bwant = {"quant_matmul": 7 * n * sum(bcalls["balanced"])}
    _check(blog.by_name() == bwant, f"phi3 bucket: launches {blog.by_name()}, expected {bwant}")
    add(blog.by_name())
    print(beng.stats.format())
    for tier in names:
        for kind in ("PrefillBucket", "DecodeBucket"):
            ss = [st for b, st in beng.stats.buckets.items()
                  if b.tier == tier and type(b).__name__ == kind]
            c, tot, tk = (sum(x.calls for x in ss), sum(x.total_s for x in ss),
                          sum(x.tokens for x in ss))
            print(f"phi3 bucket {tier}: {kind[:-6].lower()} {1e3 * tot / max(c, 1):.3f}ms a call "
                  f"over {c} calls, {tk / max(tot, 1e-9):.1f} tok/s")
    print(f"phi3 bucket: served {n_req} requests in {bwall:.2f}s; (prefill waves, decode steps) "
          f"per tier {bcalls}")
    same = 0
    for i in range(n_req):
        want_ids = breqs[i].result()
        same += int(np.array_equal(want_ids, outs[i]))
        _hold_same_ids(torch, f"phi3 request {i} ({assign[i]}) continuous vs bucket", want_ids,
                       outs[i], lambda s_, i=i: btap.at(breqs[i], s_),
                       lambda s_, i=i: tap.at(reqs[i], s_),
                       _forced_at(torch, eng.cfg, prompts[i], eng.prompt_bucket(len(prompts[i])),
                                  True, want_ids, CONT_MAX_LEN),
                       eng.tier_params(assign[i]))
    print(f"phi3: greedy ids equal between modes for {same} of {n_req} requests")
    del beng, btap, tap

    # the balanced pair, teacher-forced on its own tokens: kernels against plain
    params_b = eng.tier_params("balanced")
    idx = [i for i in range(n_req) if assign[i] == "balanced"][:2]
    toks, pad = _padded(torch, dev, prompts, idx,
                        eng.prompt_bucket(max(len(prompts[i]) for i in idx)))
    served = torch.stack([torch.as_tensor(outs[i]) for i in idx]).to(dev).long()[:, :4]
    got = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served, CONT_MAX_LEN)
    with _PlainKernels():
        plain = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served, CONT_MAX_LEN)
    _check(all(torch.isfinite(g).all() for g in got), "phi3 balanced: non-finite logits")
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
    print(f"phi3 balanced: teacher-forced logits vs plain rel L2 (prefill, 4 decode steps) "
          f"{[f'{r:.3g}' for r in rels]}")

    def moved():
        with _PlainKernels():
            again = _teacher_forced(torch, eng.cfg, _noised(torch, params_b), toks, pad, served,
                                    CONT_MAX_LEN)
        return [_rel(torch, a, w) for a, w in zip(again, plain)]

    _hold_lm(torch, "phi3 balanced teacher-forced", rels, moved)
    del got, plain
    _lm_branches(torch, eng.cfg, params_b, toks, "phi3 balanced", pad=pad, steps=served)
    del eng
    # a [2, LM_SCORE_LEN] scoring forward through the dh-96 two-stage kernel
    score = _lm_score(torch, dev, params_b, cfg)
    _check(score == {"quant_matmul": 7 * n, "two_stage_attention": n},
           f"phi3 scoring forward launches {score}")
    add(score)
    del raw, params_b
    print(f"phi3: phase {time.perf_counter() - t_phase:.1f}s; launches {counts}")
    return {"counts": counts, "runs": 1, "inplace": {}}


def phase_paligemma(torch, dev) -> dict:
    """See the module docstring (14)."""
    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.core.precision import PrecisionPlan, compile_schedule
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("paligemma-3b").with_(attn_impl="two_stage")
    n = cfg.n_layers
    print(f"paligemma: paligemma-3b at full depth, {n} layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"{cfg.act}, vocab {cfg.vocab_size}, embedding inputs, "
          f"{cfg.param_counts()[0] / 1e9:.2f} B parameters)")
    torch.cuda.reset_peak_memory_stats()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    counts = {}

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    # the Engine refuses as the reference's does: it constructs in bucket
    # mode, refuses continuous mode and refuses embeddings
    tiers = {k: v.materialize() for k, v in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    eng = Engine(cfg, raw, tiers=tiers, max_len=CONT_MAX_LEN, device="cuda")
    _check(eng.mode == "bucket" and "stub frontends can't serve" in eng.stats.mode,
           f"paligemma engine: {eng.stats.mode}")
    _raises(lambda: Engine(cfg, raw, tiers=tiers, max_len=CONT_MAX_LEN, mode="continuous",
                           device="cuda"), ValueError, "mode='continuous' needs",
            "paligemma continuous")
    emb = torch.randn((2, 8, cfg.d_model), device=dev)
    _raises(lambda: eng.enqueue(emb, 4), ValueError,
            "embed_inputs stub frontends are not servable", "paligemma enqueue")
    _raises(lambda: eng.generate(emb, 4), ValueError, "prompts must be [B, L] ints",
            "paligemma generate")
    print(f"paligemma: Engine mode {eng.stats.mode!r}; continuous mode, enqueue and generate "
          "of embeddings refused as the reference refuses them")
    del eng

    # W4A8: a left-padded prefill and 4 decode steps over the int8 cache,
    # embedding inputs; then a scoring forward through the dh-256 kernel
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = quantize_lm(cfg, raw, PrecisionPlan(default="w4a8", use_kernel=True))
    torch.cuda.synchronize()
    print(f"paligemma: W4A8 tree in {time.perf_counter() - t0:.1f}s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, ZOO_PROMPT + 4, cfg.d_model), generator=gen, device=dev)
    toks, steps = x[:, :ZOO_PROMPT], x[:, ZOO_PROMPT:]
    pad = torch.tensor([0, ZOO_PROMPT // 4], device=dev)
    with probe.tracking() as log, _CallLaunches() as cl:
        got = _teacher_forced(torch, cfg, params, toks, pad, steps, ZOO_PROMPT + 4)
        torch.cuda.synchronize()
    ncalls = cl.hold("paligemma prefill+decode", {"quant_matmul": 7 * n})
    add(log.by_name())
    with _PlainKernels():
        plain = _teacher_forced(torch, cfg, params, toks, pad, steps, ZOO_PROMPT + 4)
    _check(all(torch.isfinite(g).all() for g in got), "paligemma: non-finite logits")
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]

    def moved():
        with _PlainKernels():
            again = _teacher_forced(torch, cfg, params, _last_bit(torch, toks, 7), pad,
                                    _last_bit(torch, steps, 8), ZOO_PROMPT + 4)
        return [_rel(torch, a, w) for a, w in zip(again, plain)]

    print(f"paligemma W4A8: calls {ncalls}, launches {log.by_name()}; teacher-forced logits vs "
          f"plain rel L2 (prefill, 4 decode steps) {[f'{r:.3g}' for r in rels]}")
    _hold_lm(torch, "paligemma W4A8 teacher-forced", rels, moved)
    del got, plain
    _lm_branches(torch, cfg, params, toks, "paligemma W4A8", pad=pad, steps=steps)
    state = {}

    def prefill():
        state["cache"] = lm.init_cache(cfg, 2, ZOO_PROMPT + 4, device=dev)
        with torch.inference_mode():
            _, state["cache"] = lm.forward(cfg, params, toks, cache=state["cache"],
                                           mode="prefill", pad_lens=pad)

    def step():  # the prefilled cache's dict keeps its clock: each call writes slot ZOO_PROMPT
        with torch.inference_mode():
            lm.decode_step(cfg, params, steps[:, :1], state["cache"], pad_lens=pad)

    pre_ms = _wall_ms(torch, prefill)
    dec_ms = _wall_ms(torch, step)
    print(f"paligemma W4A8: prefill {pre_ms:.2f}ms (2 x {ZOO_PROMPT} embeddings), decode "
          f"{dec_ms:.3f}ms a step (batch 2), {2e3 / dec_ms:.1f} decode tok/s (host clock)")
    del state
    score = _lm_score(torch, dev, params, cfg)
    _check(score == {"quant_matmul": 7 * n, "two_stage_attention": n},
           f"paligemma scoring forward launches {score}")
    add(score)
    del params

    # the compiled w4a8:fused schedule: wqkv (2048 x 2560, a 2.6 MB W4 panel)
    # and wo on fused_matmul, the FFN (panels over the budget) on quant_matmul
    gc.collect()
    torch.cuda.empty_cache()
    sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True,
                                                name="w4a8"))
    served_want = sched.launches_per_forward(two_stage_attention=False)
    score_want = sched.launches_per_forward(two_stage_attention=True)
    print(f"paligemma schedule w4a8:fused: {sched.summary()}, groups "
          f"{[g.name for g in sched.groups][:2]}... ({len(sched.groups)}); predicted per served "
          f"call {served_want}, per scoring forward {score_want}")
    for st in sched.sites[:8]:
        if st.fallback:
            print(f"  fallback {st.site}: {st.fallback}")
    _check(served_want == {"fused_matmul": 2 * n, "quant_matmul": 3 * n}
           and score_want == {**served_want, "two_stage_attention": n},
           f"paligemma schedule predicts {served_want} / {score_want}")
    scfg = cfg.with_(attn_tiles=sched.attention_targets() or None)
    with torch.inference_mode():
        fparams = quantize_lm(scfg, raw, sched)
    del raw
    sx = x[:1]
    with torch.inference_mode(), probe.tracking() as flog:
        fout, _ = lm.forward(scfg, fparams, sx)
        torch.cuda.synchronize()
    _check(flog.by_name() == score_want,
           f"paligemma schedule forward launches {flog.by_name()}, expected {score_want}")
    add(flog.by_name())
    with probe.tracking() as tlog, _CallLaunches() as fcl:
        fgot = _teacher_forced(torch, scfg, fparams, toks, pad, steps[:, :2], ZOO_PROMPT + 4)
    add(tlog.by_name())
    fcl.hold("paligemma schedule prefill+decode", served_want)
    with torch.inference_mode(), _PlainKernels():
        fplain, _ = lm.forward(scfg, fparams, sx)
        fgot_plain = _teacher_forced(torch, scfg, fparams, toks, pad, steps[:, :2],
                                     ZOO_PROMPT + 4)
    rels = [_rel(torch, fout, fplain)] + [_rel(torch, g, w) for g, w in zip(fgot, fgot_plain)]
    print(f"paligemma schedule: full forward ([1, {ZOO_PROMPT + 4}]) launches {flog.by_name()}; "
          f"logits vs plain rel L2 (full, prefill, 2 decode steps) {[f'{r:.3g}' for r in rels]}")

    def fmoved():
        with torch.inference_mode(), _PlainKernels():
            again, _ = lm.forward(scfg, fparams, _last_bit(torch, sx, 7))
            forced = _teacher_forced(torch, scfg, fparams, _last_bit(torch, toks, 7), pad,
                                     _last_bit(torch, steps[:, :2], 8), ZOO_PROMPT + 4)
        return [_rel(torch, again, fplain)] + [_rel(torch, a, w)
                                               for a, w in zip(forced, fgot_plain)]

    _hold_lm(torch, "paligemma schedule", rels, fmoved)
    del fout, fplain, fgot, fgot_plain
    _lm_branches(torch, scfg, fparams, sx, "paligemma schedule")
    del fparams
    print(f"paligemma: phase {time.perf_counter() - t_phase:.1f}s; launches {counts}")
    return {"counts": counts, "runs": 1, "inplace": {}}



# ---------------------------------------------------------------------------
# phase 15: deepseek-v2-lite-16b (MLA: its compressed cache, absorbed decode)
# ---------------------------------------------------------------------------


def _mla_per_call(eng) -> dict:
    """(prefill waves, decode steps) of each tier of an engine's run."""
    return {t: [sum(s.calls for b, s in eng.stats.buckets.items()
                    if b.tier == t and type(b).__name__ == k)
                for k in ("PrefillBucket", "DecodeBucket")] for t in eng.tiers}


def _mla_want(pre: dict, dec: dict, waves: int, steps: int) -> dict:
    """Launches of ``waves`` prefill waves and ``steps`` decode steps."""
    out = {k: pre.get(k, 0) * waves + dec.get(k, 0) * steps for k in {*pre, *dec}}
    return {k: v for k, v in out.items() if v}


def phase_mla(torch, dev) -> dict:
    """See the module docstring (15)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPlan, compile_schedule
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import AsyncServer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("deepseek-v2-lite-16b").with_(n_layers=MLA_LAYERS)
    n, moe = cfg.n_layers, cfg.n_layers - cfg.first_dense
    rank, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    # the compressed cache a token and layer: k [1, rank + dr] int8, its f32
    # scale, and the [1, 1] int8 and f32 placeholders of v and v_scale
    kv_bytes = (rank + dr) + 4 + 1 + 4
    print(f"mla: deepseek-v2-lite-16b depth {n} of 27 layers (d_model {cfg.d_model}, MLA "
          f"{cfg.n_heads} heads, kv_lora_rank {rank}, qk_nope {cfg.qk_nope_dim} / qk_rope {dr} / "
          f"v_head {cfg.v_head_dim}, {cfg.n_experts} routed experts of {cfg.moe_d_ff} at "
          f"top-{cfg.top_k}, {cfg.n_shared_experts} shared, dense layer 0 at {cfg.dense_d_ff}, "
          f"vocab {cfg.vocab_size}); compressed cache {kv_bytes} B a token and layer")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    counts = {}

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    # the compiled w4a8 schedule: 5 quant_matmul an MLA layer a prefill
    # wave, 3 a decode step (the absorbed decode reads w_k_up and w_v_up
    # dequantized), one batched launch a routed projection
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, name="w4a8"))
    spath = work / "deepseek-v2-lite.w4a8.schedule.json"
    sched.save(spath)
    pre = sched.launches_per_forward(two_stage_attention=False)
    dec = sched.launches_per_forward(two_stage_attention=False, decode=True)
    print(f"mla: w4a8 schedule {sched.summary()}; predicted per prefill wave {pre}, per decode "
          f"step {dec}")
    _check(pre == {"quant_matmul": 5 * n + 3 * cfg.first_dense + 3 * moe,
                   "quant_matmul_batched": 3 * moe}
           and dec == {**pre, "quant_matmul": pre["quant_matmul"] - 2 * n},
           f"mla schedule predicts {pre} / {dec}")

    tiers = {k: v.materialize() for k, v in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    names = list(tiers)
    kw = dict(tiers=tiers, max_len=CONT_MAX_LEN, batch_buckets=(1, 2, 4), device="cuda")
    eng = Engine(cfg, raw, mode="auto", max_batch=4, decode_steps_per_poll=8, **kw)
    _check(eng.mode == "continuous" and eng.pad_prompts,
           f"mla: mode='auto' resolved to {eng.stats.mode}")
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"mla: weights and tiers quantized in {time.perf_counter() - t0:.1f}s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_req = 6
    prompts = mixed_len_prompts(cfg.vocab_size, n_req, MLA_PROMPT)
    assign = [names[((i + 1) // 2) % 2] for i in range(n_req)]  # q b b q q b

    # continuous, behind AsyncServer: two requests first, four joining
    tracer = obs_trace.Tracer(capacity=4096)
    prev = obs_trace.install(tracer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with probe.tracking() as log, AsyncServer(eng) as srv:  # counts start at 0 here
            reqs = [srv.submit(prompts[i], MLA_GEN, tier=assign[i]) for i in (0, 1)]
            t_wait = time.perf_counter() + 300
            while eng.active < 2 and time.perf_counter() < t_wait:
                time.sleep(0.002)
            _check(eng.active >= 2, "mla: the first two requests never ran")
            reqs += [srv.submit(prompts[i], MLA_GEN, tier=assign[i]) for i in range(2, n_req)]
            outs = [srv.result(r, timeout=600) for r in reqs]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        obs_trace.install(prev)
    _serve_report(torch, eng, "mla continuous", _ttft_ms(tracer, reqs), wall, peak)
    _check(all(o.shape == (MLA_GEN,) for o in outs), "mla continuous: every request delivered")
    _check(eng.stats.scheduler.admitted_mid_decode >= 1, "mla: nothing joined mid-decode")
    calls = _mla_per_call(eng)
    for tier in names:
        ss = [s for b, s in eng.stats.buckets.items()
              if b.tier == tier and type(b).__name__ == "PrefillBucket"]
        print(f"mla continuous {tier}: prefill {1e3 * sum(s.total_s for s in ss) / max(sum(s.calls for s in ss), 1):.2f}"
              f"ms a wave over {sum(s.calls for s in ss)} waves")
    want = _mla_want(pre, dec, *calls["balanced"])
    print(f"mla continuous: launches {log.by_name()}; (prefill waves, decode steps) per tier "
          f"{calls}; per balanced wave {pre}, per balanced step {dec}")
    _check(log.by_name() == want, f"mla continuous: launches {log.by_name()}, expected {want}")
    add(log.by_name())

    # bucket mode, max_batch 2, the same requests
    beng = Engine(cfg, raw, mode="bucket", max_batch=2, max_wait_s=60.0, **kw)
    for t in tiers:
        beng.tier_params(t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with probe.tracking() as blog:
        breqs = [beng.enqueue(p, MLA_GEN, tier=assign[i]) for i, p in enumerate(prompts)]
        beng.flush()
        torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    bpeak = torch.cuda.max_memory_allocated() / 2**30
    bouts = [r.result() for r in breqs]
    _check(all(o.shape == (MLA_GEN,) for o in bouts), "mla bucket: every request delivered")
    bcalls = _mla_per_call(beng)
    bwant = _mla_want(pre, dec, *bcalls["balanced"])
    _check(blog.by_name() == bwant, f"mla bucket: launches {blog.by_name()}, expected {bwant}")
    add(blog.by_name())
    print(beng.stats.format())
    for tier in names:
        for kind in ("PrefillBucket", "DecodeBucket"):
            ss = [st for b, st in beng.stats.buckets.items()
                  if b.tier == tier and type(b).__name__ == kind]
            c, tot, tk = (sum(x.calls for x in ss), sum(x.total_s for x in ss),
                          sum(x.tokens for x in ss))
            print(f"mla bucket {tier}: {kind[:-6].lower()} {1e3 * tot / max(c, 1):.3f}ms a call "
                  f"over {c} calls, {tk / max(tot, 1e-9):.1f} tok/s")
    print(f"mla bucket: served {n_req} requests in {bwall:.2f}s, peak memory {bpeak:.2f} GiB; "
          f"(prefill waves, decode steps) per tier {bcalls}; launches {blog.by_name()}")
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, bouts))
    print(f"mla: greedy ids equal between modes for {same} of {n_req} requests (MoE capacity "
          "couples co-batched rows: not held)")
    del beng

    # the balanced tier against the plain versions at the same rows and
    # pads: a prefill and 4 absorbed decode steps, teacher-forced on served
    # tokens.  Only quant_matmul and its batched launch differ from the
    # plain versions here, and both are exact: the logits must be equal.
    params_b = eng.tier_params("balanced")
    idx = [i for i in range(n_req) if assign[i] == "balanced"][:2]
    toks, pad = _padded(torch, dev, prompts, idx,
                        eng.prompt_bucket(max(len(prompts[i]) for i in idx)))
    served = torch.stack([torch.as_tensor(outs[i]) for i in idx]).to(dev).long()[:, :4]
    with probe.tracking() as tlog, _CallLaunches() as tcl:
        got = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served, CONT_MAX_LEN)
        torch.cuda.synchronize()
    for mode, got_log in tcl.calls:
        _check(got_log == (pre if mode == "prefill" else dec),
               f"mla teacher-forced: a {mode} call launched {got_log}")
    add(tlog.by_name())
    with _PlainKernels():
        plain = _teacher_forced(torch, eng.cfg, params_b, toks, pad, served, CONT_MAX_LEN)
    _check(all(torch.isfinite(g).all() for g in got), "mla balanced: non-finite logits")
    diffs = [(g - w).abs().max().item() for g, w in zip(got, plain)]
    print(f"mla balanced: teacher-forced logits vs plain, max |diff| (prefill, 4 absorbed decode "
          f"steps) {diffs}")
    _check(max(diffs) == 0.0, f"mla balanced: logits differ from the plain versions' {diffs}")
    del got, plain
    _lm_branches(torch, eng.cfg, params_b, toks, "mla balanced", pad=pad, steps=served)

    # the absorbed decode's own cost: one layer's mla_attention decode call
    # at 4 slots over a CONT_MAX_LEN-slot compressed cache (it dequantizes
    # the whole cache each step), against a whole decode step
    from repro_torch.tree import tree_index

    mixer = tree_index(params_b["blocks"]["l0"], 0)["mixer"]
    cache = A.init_kv_cache(cfg, 4, CONT_MAX_LEN, 1, device=dev)
    cache = cache._replace(k=cache.k[0], v=cache.v[0], k_scale=cache.k_scale[0],
                           v_scale=cache.v_scale[0], length=CONT_MAX_LEN - 1)
    xs = torch.randn((4, 1, cfg.d_model), device=dev)
    pos = torch.full((4, 1), CONT_MAX_LEN - 1, device=dev)

    def absorbed():
        with torch.inference_mode():
            A.mla_attention(mixer, cfg, xs, positions=pos, cache=cache, mode="decode")

    att_ms = _wall_ms(torch, absorbed)
    with probe.tracking() as alog:
        absorbed()
    print(f"mla: one layer's absorbed decode (4 slots, {CONT_MAX_LEN}-slot cache, W4A8) "
          f"{att_ms:.3f}ms host clock, launches {alog.by_name()}; x {n} layers = "
          f"{att_ms * n:.2f}ms of a decode step")
    del cache, xs

    # Engine(schedule=path): every prefill wave and decode step launches what
    # the schedule predicts
    del eng
    seng = Engine(cfg, raw, schedule=str(spath), mode="auto", max_len=CONT_MAX_LEN,
                  batch_buckets=(1, 2, 4), max_batch=4, device="cuda")
    seng.params
    with probe.tracking() as slog, _CallLaunches() as scl:
        sreqs = [seng.enqueue(p, 5) for p in prompts[:2]]
        seng.flush()
        torch.cuda.synchronize()
    add(slog.by_name())
    ncalls = {}
    for mode, got_log in scl.calls:
        _check(got_log == (pre if mode == "prefill" else dec),
               f"mla schedule: a {mode} call launched {got_log}, the schedule predicts "
               f"{pre if mode == 'prefill' else dec}")
        ncalls[mode] = ncalls.get(mode, 0) + 1
    _check(ncalls.get("prefill", 0) >= 1 and ncalls.get("decode", 0) >= 1
           and all(r.result().shape == (5,) for r in sreqs), f"mla schedule: calls {ncalls}")
    print(f"mla schedule: Engine(schedule=path) served {ncalls} calls, each launching what the "
          f"schedule predicts; launches {slog.by_name()}")
    del seng, raw

    # a [2, LM_SCORE_LEN] scoring forward: the materialized branch (float
    # attention at q/k head dim 192, v 128; no two-stage launch)
    score = _lm_score(torch, dev, params_b, cfg, want=pre)
    add(score)
    del params_b
    print(f"mla: phase {time.perf_counter() - t_phase:.1f}s; launches {counts}")
    return {"counts": counts, "runs": 1, "inplace": {}}



# ---------------------------------------------------------------------------
# phase 16: internlm2-20b, starcoder2-7b and musicgen-large
# ---------------------------------------------------------------------------


def _serve_two_waves(torch, eng, prompts, assign, gen, tag):
    """Two requests first, then the rest (joining mid-decode where the mode
    allows), polled to the end; returns (requests, ids, wall s, peak GiB,
    TTFT ms)."""
    from repro_torch.obs import trace as obs_trace

    tracer = obs_trace.Tracer(capacity=4096)
    prev = obs_trace.install(tracer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reqs = [eng.enqueue(prompts[i], gen, tier=assign[i]) for i in (0, 1)]
        time.sleep(2 * eng.max_wait_s)
        eng.poll()
        reqs += [eng.enqueue(prompts[i], gen, tier=assign[i]) for i in range(2, len(prompts))]
        while not all(q.ready for q in reqs):
            eng.poll()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        obs_trace.install(prev)
    outs = [q.result() for q in reqs]
    _check(all(o.shape == (gen,) for o in outs), f"{tag}: every request delivered")
    return reqs, outs, wall, peak, _ttft_ms(tracer, reqs)


def _forced_hold(torch, dev, eng, tag, params, prompts, idx, outs, pad_prompts=True):
    """Requests ``idx`` (one tier) teacher-forced on their served ids: a
    prefill (left-padded to the prompt bucket, or at its exact length) and 4
    decode steps with the kernels against the plain versions, held by
    ``_hold_lm``."""
    if pad_prompts:
        toks, pad = _padded(torch, dev, prompts, idx,
                            eng.prompt_bucket(max(len(prompts[i]) for i in idx)))
    else:
        toks, pad = torch.as_tensor(prompts[idx[0]][None], device=dev).long(), None
        idx = idx[:1]
    served = torch.stack([torch.as_tensor(outs[i]) for i in idx]).to(dev).long()[:, :4]
    max_len = toks.shape[1] + 4
    got = _teacher_forced(torch, eng.cfg, params, toks, pad, served, max_len)
    with _PlainKernels():
        plain = _teacher_forced(torch, eng.cfg, params, toks, pad, served, max_len)
    _check(all(torch.isfinite(g).all() for g in got), f"{tag}: non-finite logits")
    rels = [_rel(torch, g, w) for g, w in zip(got, plain)]
    print(f"{tag}: teacher-forced logits vs plain rel L2 (prefill, 4 decode steps) "
          f"{[f'{r:.3g}' for r in rels]}")

    def moved():
        with _PlainKernels():
            again = _teacher_forced(torch, eng.cfg, _noised(torch, params), toks, pad, served,
                                    max_len)
        return [_rel(torch, a, w) for a, w in zip(again, plain)]

    _hold_lm(torch, f"{tag} teacher-forced", rels, moved)
    return toks, pad, served


def _dense_one(torch, dev, arch: str, cut) -> dict:
    """One dense config of phase 16 (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPlan, compile_schedule
    from repro_torch.data.pipeline import mixed_len_prompts
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()
    t_arch = time.perf_counter()
    full = get_config(arch)
    cfg = full.with_(n_layers=cut) if cut else full
    n = cfg.n_layers
    counts = {}

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    print(f"dense_zoo: {arch} at {n} of {full.n_layers} layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff} {cfg.act}, "
          f"{cfg.norm} norm{' + bias' if cfg.norm_bias else ''}"
          f"{', attention bias' if cfg.attn_bias else ''}, pos {cfg.pos}, vocab "
          f"{cfg.vocab_size}; f32 weights {4 * cfg.param_counts()[0] / 1e9:.1f} GB"
          f"{f', {4 * full.param_counts()[0] / 1e9:.1f} GB at full depth' if cut else ''})")
    torch.cuda.reset_peak_memory_stats()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, name="w4a8"))
    per = sched.launches_per_forward(two_stage_attention=False)
    sites = 4 + (3 if cfg.act in ("swiglu", "geglu") else 2)
    _check(per == {"quant_matmul": sites * n}, f"{arch}: the w4a8 schedule predicts {per}")
    tiers = {k: v.materialize() for k, v in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    names = list(tiers)
    eng = Engine(cfg, raw, mode="auto", max_batch=4, decode_steps_per_poll=8, tiers=tiers,
                 attn_impl="two_stage", max_len=CONT_MAX_LEN, batch_buckets=(1, 2, 4),
                 device="cuda")
    _check(eng.mode == "continuous" and eng.pad_prompts, f"{arch}: mode {eng.stats.mode}")
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"dense_zoo {arch}: weights and both tiers in {time.perf_counter() - t_arch:.1f}s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompts = mixed_len_prompts(cfg.vocab_size, 4, DENSE_PROMPT)
    assign = [names[i % 2] for i in range(4)]
    with probe.tracking() as log:  # counts start at 0 here
        reqs, outs, wall, peak, ttft = _serve_two_waves(torch, eng, prompts, assign, DENSE_GEN,
                                                        f"dense_zoo {arch}")
    _serve_report(torch, eng, f"dense_zoo {arch}", ttft, wall, peak)
    _check(eng.stats.scheduler.admitted_mid_decode >= 1, f"{arch}: nothing joined mid-decode")
    calls = _mla_per_call(eng)
    want = _mla_want(per, per, *calls["balanced"])
    print(f"dense_zoo {arch}: launches {log.by_name()}; (prefill waves, decode steps) per tier "
          f"{calls}; per balanced call {per}")
    _check(log.by_name() == want, f"{arch}: launches {log.by_name()}, expected {want}")
    add(log.by_name())
    params_b = eng.tier_params("balanced")
    _forced_hold(torch, dev, eng, f"dense_zoo {arch} balanced", params_b, prompts,
                 [i for i in range(4) if assign[i] == "balanced"], outs)
    del eng
    score = _lm_score(torch, dev, params_b, cfg,
                      want=sched.launches_per_forward(two_stage_attention=True))
    add(score)
    del params_b

    if arch == "musicgen-large":
        # the compiled w4a8:fused schedule: wqkv (2048 x 6144, a 6.3 MB W4
        # panel) with its LayerNorm prologue and wo on fused_matmul, the FFN
        # (16.8 MB of panels) on quant_matmul
        fsched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True,
                                                     name="w4a8"))
        fper = fsched.launches_per_forward(two_stage_attention=False)
        _check(fper == {"fused_matmul": 2 * n, "quant_matmul": 2 * n}
               and [g.name for g in fsched.groups] == ["blocks.l0.mixer.wqkv"],
               f"musicgen w4a8:fused predicts {fper}, groups {[g.name for g in fsched.groups]}")
        work = ROOT / "build" / "chip_smoke"
        work.mkdir(parents=True, exist_ok=True)
        spath = work / "musicgen-large.w4a8-fused.schedule.json"
        fsched.save(spath)
        seng = Engine(cfg, raw, schedule=str(spath), mode="auto", attn_impl="two_stage",
                      max_len=CONT_MAX_LEN, batch_buckets=(1, 2, 4), max_batch=4, device="cuda")
        sparams = seng.params
        with probe.tracking() as slog, _CallLaunches() as scl:
            sreqs = [seng.enqueue(p, 5) for p in prompts[:2]]
            seng.flush()
            torch.cuda.synchronize()
        ncalls = scl.hold("musicgen schedule", fper)
        _check(all(r.result().shape == (5,) for r in sreqs), "musicgen schedule: delivered")
        add(slog.by_name())
        print(f"dense_zoo musicgen-large: Engine(schedule=w4a8:fused) served {ncalls} calls, "
              f"each launching {fper}; launches {slog.by_name()}")
        _forced_hold(torch, dev, seng, "dense_zoo musicgen-large schedule", sparams, prompts,
                     [0, 1], [r.result() for r in sreqs])
        del seng, sparams
    del raw
    print(f"dense_zoo {arch}: {time.perf_counter() - t_arch:.1f}s; launches {counts}")
    return counts


def phase_dense_zoo(torch, dev) -> dict:
    """See the module docstring (16)."""
    t_phase = time.perf_counter()
    counts = {}
    for arch, cut in (("starcoder2-7b", None), ("musicgen-large", None),
                      ("internlm2-20b", DENSE_CUT)):
        for k, v in _dense_one(torch, dev, arch, cut).items():
            counts[k] = counts.get(k, 0) + v
    print(f"dense_zoo: phase {time.perf_counter() - t_phase:.1f}s; launches {counts}")
    return {"counts": counts, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 17: jamba-v0.1-52b (Mamba + attention + MoE)
# ---------------------------------------------------------------------------


def phase_jamba(torch, dev) -> dict:
    """See the module docstring (17)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPlan, compile_schedule
    from repro_torch.kernels import probe
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.models import lm
    from repro_torch.models import ssm as S
    from repro_torch.serving.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    full = get_config("jamba-v0.1-52b")
    cfg = full.with_(n_layers=JAMBA_LAYERS)
    n = cfg.n_layers
    kinds = [(lm.mixer_kind(cfg, i), lm.ffn_kind(cfg, i)) for i in range(n)]
    n_mamba = sum(k == "mamba" for k, _ in kinds)
    n_moe = sum(f == "moe" for _, f in kinds)
    print(f"jamba: jamba-v0.1-52b at {n} of {full.n_layers} layers ({n_mamba} Mamba, "
          f"{n - n_mamba} attention {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}; {n_moe} MoE "
          f"FFNs of {cfg.n_experts} x {cfg.moe_d_ff} at top-{cfg.top_k}, {n - n_moe} dense; "
          f"d_model {cfg.d_model}, d_inner {cfg.mamba_expand * cfg.d_model}, d_state "
          f"{cfg.mamba_d_state}, vocab {cfg.vocab_size}); f32 weights "
          f"{4 * cfg.param_counts()[0] / 1e9:.1f} GB, {4 * full.param_counts()[0] / 1e9:.1f} GB "
          "at full depth")
    counts = {}

    def add(log):
        for k, v in log.items():
            counts[k] = counts.get(k, 0) + v

    torch.cuda.reset_peak_memory_stats()
    raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sched = compile_schedule(cfg, PrecisionPlan(default="w4a8", use_kernel=True, name="w4a8"))
    spath = work / "jamba.w4a8.schedule.json"
    sched.save(spath)
    per = sched.launches_per_forward(two_stage_attention=False)
    n_dense = n - n_moe
    want_per = {"quant_matmul": 2 * n_mamba + 4 * (n - n_mamba) + 3 * n_dense,
                "quant_matmul_batched": 3 * n_moe}
    print(f"jamba: w4a8 schedule compiled in {time.perf_counter() - t0:.1f}s: {sched.summary()}; "
          f"predicted per prefill wave and decode step {per}")
    _check(per == want_per, f"jamba schedule predicts {per}, expected {want_per}")
    tiers = {k: v.materialize() for k, v in
             ServeSpec.parse_tiers("quality=fp,balanced=w4a8").items()}
    names = list(tiers)
    max_len = max(JAMBA_PROMPTS) + JAMBA_GEN
    eng = Engine(cfg, raw, mode="auto", max_batch=2, max_wait_s=60.0, tiers=tiers,
                 attn_impl="two_stage", max_len=max_len, batch_buckets=(1, 2), device="cuda")
    _check(eng.mode == "bucket" and not eng.pad_prompts
           and "neither attention-only nor position-free recurrent" in eng.stats.mode,
           f"jamba: mode {eng.stats.mode}")
    print(f"jamba: Engine mode {eng.stats.mode!r}")
    t0 = time.perf_counter()
    for t in tiers:
        eng.tier_params(t)
    torch.cuda.synchronize()
    print(f"jamba: seed-0 weights and both tiers in {time.perf_counter() - t_phase:.1f}s (W4A8 "
          f"tree {time.perf_counter() - t0:.1f}s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (m,)).astype(np.int32) for m in JAMBA_PROMPTS]
    assign = [names[i % 2] for i in range(len(prompts))]

    # bucket mode: each tier's pair prefills at its exact lengths and decodes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with probe.tracking() as log, _CallLaunches() as cl:  # counts start at 0 here
        reqs = [eng.enqueue(p, JAMBA_GEN, tier=assign[i]) for i, p in enumerate(prompts)]
        eng.flush()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    outs = [r.result() for r in reqs]
    _check(all(o.shape == (JAMBA_GEN,) for o in outs), "jamba: every request delivered")
    _check(all(got in ({}, per) for _, got in cl.calls),
           f"jamba: a call launched {[g for _, g in cl.calls if g not in ({}, per)]}")
    calls = _mla_per_call(eng)
    want = _mla_want(per, per, *calls["balanced"])
    _check(log.by_name() == want, f"jamba: launches {log.by_name()}, expected {want}")
    add(log.by_name())
    _check(all(any(type(b).__name__ == "PrefillBucket" and b.prompt_len == len(p)
                   for b in eng.stats.buckets) for p in prompts), "jamba: exact-length buckets")
    print(eng.stats.format())
    for tier in names:
        for kind in ("PrefillBucket", "DecodeBucket"):
            ss = [st for b, st in eng.stats.buckets.items()
                  if b.tier == tier and type(b).__name__ == kind]
            c, tot, tk = (sum(x.calls for x in ss), sum(x.total_s for x in ss),
                          sum(x.tokens for x in ss))
            print(f"jamba bucket {tier}: {kind[:-6].lower()} {1e3 * tot / max(c, 1):.3f}ms a call "
                  f"over {c} calls, {tk / max(tot, 1e-9):.1f} tok/s")
    print(f"jamba: served {len(prompts)} requests in {wall:.2f}s, peak memory {peak:.2f} GiB; "
          f"(prefill waves, decode steps) per tier {calls}; every balanced call launched {per}")

    # the balanced tier: prefill + decode through the MambaState (and the
    # attention layer's int8 KV cache) against the plain versions, and
    # against a teacher-forced full forward over the same tokens, routed
    # dropless (capacity_factor = n_experts, as the reference's decode test
    # routes it: a prefill's and a full forward's expert capacities differ)
    params_b = eng.tier_params("balanced")
    bi = assign.index("balanced")
    toks, _, served = _forced_hold(torch, dev, eng, "jamba balanced", params_b, prompts, [bi],
                                   outs, pad_prompts=False)
    seq = torch.cat([toks, served[:, :3]], dim=1)
    dcfg = cfg.with_(capacity_factor=float(cfg.n_experts))
    with torch.inference_mode():
        full_lg, _ = lm.forward(dcfg, params_b, seq)
        stepwise = _teacher_forced(torch, dcfg, params_b, toks, None, served[:, :3],
                                   seq.shape[1])
    rels = [_rel(torch, g, full_lg[:, toks.shape[1] - 1 + i]) for i, g in enumerate(stepwise)]
    print(f"jamba balanced: prefill + 3 decode steps through the MambaState vs one full forward "
          f"over the same tokens (dropless), rel L2 {[f'{r:.3g}' for r in rels]}")
    _check(max(rels) < DECODE_VS_FULL_W4A8, f"jamba decode vs full: {rels}")
    del full_lg, stepwise
    _lm_branches(torch, cfg, params_b, toks, "jamba balanced", steps=served)

    # the selective scan's share of a 256-token prefill (host clock): the
    # whole forward, and the scan's own calls timed inside one more forward
    L = max(JAMBA_PROMPTS)
    longest = torch.as_tensor(prompts[int(np.argmax(JAMBA_PROMPTS))][None], device=dev).long()
    scan, pre = S._selective_scan, {}
    for t in names:
        p_t = eng.tier_params(t)

        def prefill(p_t=p_t):
            lm.forward(cfg, p_t, longest, cache=lm.init_cache(cfg, 1, L, device=dev),
                       mode="prefill")

        with torch.inference_mode():
            wall_ms = _wall_ms(torch, prefill)
            spent = []

            def timed(*a):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = scan(*a)
                torch.cuda.synchronize()
                spent.append((time.perf_counter() - t1) * 1e3)
                return out

            S._selective_scan = timed
            try:
                prefill()
            finally:
                S._selective_scan = scan
        pre[t] = (wall_ms, sum(spent))
    print(f"jamba: [1, {L}] prefill forward (wall, median of 3) and its {n_mamba} selective "
          "scans (one more forward, each scan synchronized): "
          + "; ".join(f"{t} {w:.1f}ms, scans {s_:.1f}ms ({100 * s_ / w:.0f}%, "
                      f"{s_ / n_mamba:.2f}ms a layer)" for t, (w, s_) in pre.items()))
    del eng

    # Engine(schedule=path): every prefill wave and decode step launches what
    # the schedule predicts
    seng = Engine(cfg, raw, schedule=str(spath), mode="auto", attn_impl="two_stage",
                  max_len=max_len, max_batch=2, batch_buckets=(1, 2), device="cuda")
    _check(seng.mode == "bucket", f"jamba schedule engine: {seng.stats.mode}")
    seng.params
    with probe.tracking() as slog, _CallLaunches() as scl:
        sreqs = [seng.enqueue(p, 5) for p in prompts[:2]]
        seng.flush()
        torch.cuda.synchronize()
    ncalls = scl.hold("jamba schedule", per)
    _check(all(r.result().shape == (5,) for r in sreqs), "jamba schedule: delivered")
    add(slog.by_name())
    print(f"jamba schedule: Engine(schedule=path) served {ncalls} calls, each launching {per}")
    del seng, raw

    # a [2, JAMBA_SCORE_LEN] scoring forward: the attention layer through
    # the dh-128 two-stage kernel (32/8 heads, no positions)
    score = _lm_score(torch, dev, params_b, cfg, length=JAMBA_SCORE_LEN,
                      want=sched.launches_per_forward(two_stage_attention=True))
    add(score)
    del params_b
    print(f"jamba: phase {time.perf_counter() - t_phase:.1f}s; launches {counts}")
    return {"counts": counts, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 18: training
# ---------------------------------------------------------------------------

# the families of tests/test_torch_train.py at their smoke sizes
TRAIN_FAMILIES = {
    "qwen3": ("qwen3-14b-smoke", dict(n_layers=2)),
    "deepseek-moe": ("deepseek-moe-16b-smoke", dict(n_layers=2)),
    "deepseek-v2-lite": ("deepseek-v2-lite-16b-smoke", dict(n_layers=2)),
    "rwkv6": ("rwkv6-1.6b-smoke", dict(n_layers=2)),
    "jamba": ("jamba-v0.1-52b-smoke", dict(n_layers=2, pattern=("mamba", "attn"), moe_period=2)),
    "vggt": ("vggt-1b-smoke", dict(n_layers=1, layerscale_init=0.2)),
}


def _leaf_rels(torch, got, want) -> dict:
    from repro_torch.tree import tree_paths

    w = tree_paths(want)
    return {p: _rel(torch, x.detach().float().cpu(), w[p].detach().float().cpu())
            for p, x in tree_paths(got).items()}


def _train_card_vs_cpu(torch, dev) -> None:
    """(a): one train step on each device from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, scene_batch, token_batch
    from repro_torch.models import lm, vggt
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import make_train_step
    from repro_torch.tree import tree_map

    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for name, (arch, kw) in TRAIN_FAMILIES.items():
        cfg = get_config(arch).with_(**kw)
        if name == "vggt":
            cpu = vggt.init_params(cfg, torch.Generator().manual_seed(0))
            batch = scene_batch(2, 2, 16, cfg.d_model, 3)
            loss_fn = lambda p, b, cfg=cfg: vggt.reconstruction_loss(cfg, p, b)  # noqa: E731
        else:
            cpu = lm.init_params(cfg, torch.Generator().manual_seed(0))
            batch = token_batch(DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=16), 3)
            loss_fn = None
        card = tree_map(lambda x: x.to(dev, copy=True), cpu)
        step = make_train_step(cfg, opt_cfg, loss_fn)
        out = {}
        for where, params in (("cpu", cpu), ("card", card)):
            p, _, m = step(params, adamw.init(params), batch)
            out[where] = (p, float(m["loss"]), float(m["grad_norm"]))
        loss_rel = abs(out["card"][1] - out["cpu"][1]) / abs(out["cpu"][1])
        rels = _leaf_rels(torch, out["card"][0], out["cpu"][0])
        worst = max(rels, key=rels.get)
        print(f"train (a) {name} ({arch}, {kw}): loss card {out['card'][1]:.7f} cpu "
              f"{out['cpu'][1]:.7f} (rel {loss_rel:.3g}), grad norm card {out['card'][2]:.6g} "
              f"cpu {out['cpu'][2]:.6g}; updated params worst leaf rel L2 {rels[worst]:.3g} "
              f"({worst})")
        _check(loss_rel <= TRAIN_LOSS_REL, f"train (a) {name}: loss rel {loss_rel}")
        _check(rels[worst] <= TRAIN_PARAM_REL, f"train (a) {name}: {worst} rel {rels[worst]}")


def _vggt_grads(torch, cfg, params, batch, remat):
    from repro_torch.models import vggt
    from repro_torch.tree import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = vggt.reconstruction_loss(cfg, live, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), grads


def phase_train(torch, dev) -> dict:
    """See the module docstring (18)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_vggt
    from repro_torch.data.pipeline import DataConfig, scene_batch, token_batch
    from repro_torch.models import lm, vggt
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, lm_loss, make_train_step
    from repro_torch.serving.vggt_engine import VGGTEngine
    from repro_torch.tree import tree_leaves, tree_paths

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _train_card_vs_cpu(torch, dev)
    print(f"train (a): {time.perf_counter() - t0:.1f}s")

    # (b) remat at full width and depth, small scene
    cfg = get_config("vggt-1b")
    t0 = time.perf_counter()
    params = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    small = scene_batch(1, 2, 256, cfg.d_model, 0)
    loss0, g0 = _vggt_grads(torch, cfg, params, small, remat=False)
    loss1, g1 = _vggt_grads(torch, cfg, params, small, remat=True)
    worst = max(_rel(torch, a, b) for a, b in zip(g1, g0))
    print(f"train (b) vggt-1b ({cfg.n_layers} AA pairs, 1 x 2 x 256): loss {loss0:.6f} / remat "
          f"{loss1:.6f}; gradients remat vs not, worst leaf rel L2 {worst:.3g} "
          f"({time.perf_counter() - t0:.1f}s)")
    _check(loss1 == loss0 and worst <= REMAT_REL, f"train (b): remat moves the gradients {worst}")
    del g0, g1

    # (c) vggt-1b trained at full width and depth on the served scene shape
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    opt = adamw.init(params)
    before = [x.clone() for x in tree_leaves(params)]
    step = make_train_step(cfg, opt_cfg,
                           lambda p, b: vggt.reconstruction_loss(cfg, p, b, remat=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for s in range(TRAIN_STEPS):
        batch = scene_batch(BATCH, S_FRAMES, N_PATCHES, cfg.d_model, s)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        m = {k: float(v) for k, v in m.items()}  # waits for the card
        times.append(time.perf_counter() - t0)
        print(f"train (c) vggt-1b step {s}: loss {m['loss']:.6f} grad norm {m['grad_norm']:.6g} "
              f"lr {m['lr']:.3g} {times[-1] * 1e3:.1f} ms")
        _check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
               f"train (c): step {s} not finite: {m}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = statistics.median(times[1:])
    print(f"train (c) vggt-1b ({cfg.n_layers} AA pairs, d {cfg.d_model}, {BATCH} x {S_FRAMES} x "
          f"{N_PATCHES}, remat): median warm step {warm * 1e3:.1f} ms, "
          f"{BATCH / warm:.3f} scenes/s, peak memory {peak:.2f} GiB")
    _check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)),
           "train (c): parameters not finite")
    moved = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(params), before))
    _check(moved == len(before), f"train (c): {len(before) - moved} leaves did not move")
    del opt, before, step

    # (d) the trained tree, quantized W4A8 (fused) and served
    t0 = time.perf_counter()
    eng = VGGTEngine(cfg, params, policy=_plan(True), attn_impl="two_stage", max_batch=BATCH,
                     device="cuda")
    served = eng.params
    requests = [_scenes(torch, dev, 1, step=1000 + r) for r in range(4)]
    pairs = cfg.n_layers
    want = {"fused_matmul": 4 * pairs, "fused_ffn": 2 * pairs, "two_stage_attention": 2 * pairs}
    run = _serve_requests(torch, eng, requests, "train (d) trained W4A8 fused", want)
    first = torch.cat(requests[:2], dim=0)
    got = {k: torch.cat([run["outs"][0][k], run["outs"][1][k]], dim=0)
           for k in ("pose", "points", "depth")}
    with torch.inference_mode():
        with _PlainKernels():
            plain = vggt.forward(eng.cfg, served, first)
        fp = vggt.forward(cfg, params, first)
    rel = _rel_l2(torch, got, plain)
    rel_fp = _rel_l2(torch, got, fp)
    print(f"train (d): served trained W4A8 vs plain-version forward rel L2 {rel}; vs the fp "
          f"forward of the trained weights {rel_fp} ({time.perf_counter() - t0:.1f}s)")
    _check(all(v < 1e-3 for v in rel.values()), f"train (d): served vs plain {rel}")
    _check(rel_fp["points"] < 0.25, f"train (d): W4A8 points vs fp {rel_fp}")
    counts, calls = run["counts"], run["calls"]
    del eng, served, plain, fp, params, run, got
    gc.collect()
    torch.cuda.empty_cache()

    # (e) qwen3-14b at full width, TRAIN_LM_LAYERS layers
    full = get_config("qwen3-14b")
    lcfg = full.with_(n_layers=TRAIN_LM_LAYERS)
    t0 = time.perf_counter()
    lp = lm.init_params(lcfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(lp))
    lopt = adamw.init(lp)
    lstep = make_train_step(lcfg, adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=10),
                            functools.partial(lm_loss, lcfg, remat=True))
    dc = DataConfig(vocab_size=lcfg.vocab_size, batch=2, seq_len=TRAIN_LM_SEQ)
    torch.cuda.synchronize()
    print(f"train (e) qwen3-14b ({TRAIN_LM_LAYERS} of {full.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters) ready in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for s in range(3):
        t0 = time.perf_counter()
        lp, lopt, m = lstep(lp, lopt, token_batch(dc, s))
        m = {k: float(v) for k, v in m.items()}
        times.append(time.perf_counter() - t0)
        print(f"train (e) qwen3-14b step {s}: loss {m['loss']:.5f} grad norm "
              f"{m['grad_norm']:.5g} {times[-1] * 1e3:.1f} ms")
        _check(math.isfinite(m["loss"]), f"train (e): step {s} loss {m['loss']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = statistics.median(times[1:])
    print(f"train (e) qwen3-14b: median warm step {warm * 1e3:.1f} ms, "
          f"{2 * TRAIN_LM_SEQ / warm:.0f} tokens/s, peak memory {peak:.2f} GiB")
    del lp, lopt, lstep
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the trainer on the card: restart exactness, then the launcher
    scfg = get_config("qwen3-14b-smoke")
    sopt = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    sdc = DataConfig(vocab_size=scfg.vocab_size, batch=4, seq_len=32)
    tc = TrainerConfig(total_steps=20, checkpoint_every=5, log_every=1000)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t_full = Trainer(scfg, sopt, sdc, tc, os.path.join(tmp, "full"), device="cuda")
        hist_full = {h["step"]: h["loss"] for h in t_full.run()["history"]}
        t_crash = Trainer(scfg, sopt, sdc, tc, os.path.join(tmp, "crash"), device="cuda")
        t_crash.fail_at = 12
        try:
            t_crash.run()
            _fail("train (f): the injected failure did not raise")
        except RuntimeError as e:
            _check("injected failure at step 12" in str(e), f"train (f): {e}")
        t_res = Trainer(scfg, sopt, sdc, tc, os.path.join(tmp, "crash"), device="cuda")
        _check(t_res.start_step == 10, f"train (f): resumed at {t_res.start_step}")
        hist_res = {h["step"]: h["loss"] for h in t_res.run()["history"]}
        same = all(hist_res[k] == hist_full[k] for k in hist_res)
        want_p = tree_paths({"params": t_full.params, "opt": t_full.opt_state})
        diff = [p for p, x in tree_paths({"params": t_res.params, "opt": t_res.opt_state}).items()
                if not torch.equal(x, want_p[p])]
        print(f"train (f) restart at step 12 from step 10: losses of steps 10-19 equal: {same}; "
              f"leaves that differ: {len(diff)} of {len(want_p)} {diff[:3]} "
              f"({time.perf_counter() - t0:.1f}s)")
        _check(same and not diff, "train (f): the resumed run differs from the uninterrupted")

        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(SRC))
        for steps, resume in ((20, None), (30, 20)):
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-14b-smoke",
                 "--steps", str(steps), "--checkpoint-every", "10",
                 "--ckpt", os.path.join(tmp, "launch"), "--device", "cuda"],
                capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
            tail = r.stdout.strip().splitlines()[-1:] if r.stdout.strip() else []
            print(f"train (f) launch.train --steps {steps}: exit {r.returncode}, {tail}")
            _check(r.returncode == 0, f"train (f): launch.train failed:\n{r.stderr[-2000:]}")
            _check(resume is None or f"[resume] continuing from step {resume}" in r.stdout,
                   f"train (f): --steps {steps} did not resume from step {resume}")
        print(f"train (f) launcher: {time.perf_counter() - t0:.1f}s")
    print(f"train: phase {time.perf_counter() - t_phase:.1f}s")
    return {"counts": counts, "runs": calls, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 19: the multi-device layer at world size 1
# ---------------------------------------------------------------------------


def _process_group(torch, dev, path: str):
    """A one-rank process group: NCCL on the card (gloo for a CPU
    rehearsal), joined through a file."""
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} if dev.type == "cuda" \
        else {}
    dist.init_process_group(backend, init_method=f"file://{path}", rank=0, world_size=1, **kw)
    return backend


def _timed(torch, dev, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_parallel(torch, dev) -> dict:
    """See the module docstring (19)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm
    from repro_torch.core.precision import PrecisionPlan
    from repro_torch.data.pipeline import DataConfig, token_batch
    from repro_torch.kernels import probe
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression, sharding
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.runtime.trainer import lm_loss, make_ddp_compressed_step, make_train_step
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        backend = _process_group(torch, dev, os.path.join(tmp, "pg"))
        try:
            mesh = make_local_mesh(1, 1, device_type=dev.type)
            print(f"parallel: world size 1 over {backend}, mesh {tuple(mesh.shape)} "
                  f"{mesh.mesh_dim_names}")

            # (a) qwen3-14b W4A8, one [2, PARALLEL_SEQ] scoring forward (two-stage
            # attention) sharded and not
            full = get_config("qwen3-14b")
            cfg = full.with_(n_layers=LM_LAYERS, attn_impl="two_stage")
            t0 = time.perf_counter()
            raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                params = quantize_lm(cfg, raw, PrecisionPlan(default="w4a8", use_kernel=True))
            del raw
            gen = torch.Generator(device=dev).manual_seed(5)
            toks = torch.randint(0, cfg.vocab_size, (2, PARALLEL_SEQ), generator=gen, device=dev)
            sharded = sharding.distribute_tree(params, mesh)
            stoks = sharding.distribute_tree(
                toks, mesh, lambda p, x: (sharding.batch_axes(mesh), None))
            plain_fwd = lambda: lm.forward(cfg, params, toks)[0]  # noqa: E731
            sharded_fwd = lambda: lm.forward(cfg, sharded, stoks)[0]  # noqa: E731
            with torch.no_grad(), probe.tracking() as log1:
                want, ms1 = _timed(torch, dev, plain_fwd)
            with torch.no_grad(), implicit_replication(), probe.tracking() as log2:
                got, ms2 = _timed(torch, dev, sharded_fwd)
            got = got.full_tensor()
            for k, v in log2.by_name().items():
                counts[k] = counts.get(k, 0) + v
            with torch.no_grad(), implicit_replication():  # warm: after each route's first
                warm1 = [_timed(torch, dev, plain_fwd)[1] for _ in range(PARALLEL_WARM)]
                warm2 = [_timed(torch, dev, sharded_fwd)[1] for _ in range(PARALLEL_WARM)]
            same = torch.equal(got, want)
            print(f"parallel (a) qwen3-14b ({LM_LAYERS} of {full.n_layers} layers) W4A8 "
                  f"[2, {PARALLEL_SEQ}]: unsharded first call {ms1:.1f} ms, warm "
                  f"{[f'{t:.1f}' for t in warm1]} ms (median {statistics.median(warm1):.1f}) "
                  f"{log1.by_name()}; sharded route first call {ms2:.1f} ms, warm "
                  f"{[f'{t:.1f}' for t in warm2]} ms (median {statistics.median(warm2):.1f}) "
                  f"{log2.by_name()}; logits bit-equal: {same} (max |diff| "
                  f"{float((got - want).abs().max()):.3g}); {time.perf_counter() - t0:.1f}s")
            _check(log1.by_name() == {"quant_matmul": 7 * LM_LAYERS,
                                      "two_stage_attention": LM_LAYERS},
                   f"parallel (a): unsharded launches {log1.by_name()}")
            _check(log2.by_name() == log1.by_name(),
                   f"parallel (a): sharded launches {log2.by_name()} vs {log1.by_name()}")
            _check(same and bool(torch.isfinite(got).all()), "parallel (a): logits differ")
            del params, sharded, want, got
            gc.collect()
            torch.cuda.empty_cache()

            # (b) compressed DDP against the plain step at phase_train's shapes
            lcfg = full.with_(n_layers=TRAIN_LM_LAYERS)
            t0 = time.perf_counter()
            opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=10)
            loss_fn = functools.partial(lm_loss, lcfg, remat=True)
            dc = DataConfig(vocab_size=lcfg.vocab_size, batch=2, seq_len=TRAIN_LM_SEQ)
            res = {}
            for name in ("plain", "ddp"):  # each from the same seed-0 weights
                lp = lm.init_params(lcfg, torch.Generator(device=dev).manual_seed(0))
                n_params = sum(x.numel() for x in tree_leaves(lp))
                opt = adamw.init(lp)
                if name == "plain":
                    step = make_train_step(lcfg, opt_cfg, loss_fn)
                    run = lambda s: step(lp, opt, token_batch(dc, s))  # noqa: E731
                else:
                    err = compression.init_error_state(lp)
                    step = make_ddp_compressed_step(lcfg, opt_cfg, mesh, loss_fn=loss_fn)
                    run = lambda s: step(lp, opt, err, token_batch(dc, s))  # noqa: E731
                torch.cuda.reset_peak_memory_stats()
                times, losses = [], []
                for s in range(PARALLEL_DDP_STEPS):
                    out, ms = _timed(torch, dev, lambda: run(s))
                    times.append(ms)
                    losses.append(float(out[-1]["loss"]))
                res[name] = (times, losses, torch.cuda.max_memory_allocated() / 2**30)
                wire = compression.wire_bytes(lp, 1)
                del opt, step, run, out, lp
                if name == "ddp":
                    del err
                gc.collect()
                torch.cuda.empty_cache()
            for name, (times, losses, peak) in res.items():
                print(f"parallel (b) qwen3-14b ({TRAIN_LM_LAYERS} layers, {n_params / 1e9:.3f} B "
                      f"parameters) [2, {TRAIN_LM_SEQ}] {name}: {PARALLEL_DDP_STEPS} steps "
                      f"{[f'{t:.1f}' for t in times]} ms, median warm "
                      f"{statistics.median(times[1:]):.1f} ms; losses "
                      f"{[f'{x:.5f}' for x in losses]}; peak memory {peak:.2f} GiB")
            print(f"parallel (b): int8 bytes on the wire a step by compression.wire_bytes "
                  f"(N (1 + 1/n) at n = 1): {wire / 1e9:.3f} GB, against {8 * n_params / 1e9:.3f}"
                  f" GB for an f32 ring all-reduce (2 N 4); {time.perf_counter() - t0:.1f}s")
            _check(all(math.isfinite(x) for x in res["ddp"][1] + res["plain"][1]),
                   "parallel (b): a loss is not finite")
            _check(abs(res["ddp"][1][0] - res["plain"][1][0]) <= 1e-5 * abs(res["plain"][1][0]),
                   f"parallel (b): first losses {res['ddp'][1][0]} vs {res['plain'][1][0]}")

            # (c) the pipeline at one stage
            pmesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("pipe",))
            g = torch.Generator(device=dev).manual_seed(6)
            w = torch.randn((1, 1024, 1024), generator=g, device=dev) * 0.03
            x = torch.randn((8, 1024), generator=g, device=dev)
            fn = lambda p, h: torch.tanh(h @ p)  # noqa: E731
            got = pipeline_apply(pmesh, fn, w, x, n_micro=4)
            alone = torch.cat([fn(w[0], xm) for xm in x.reshape(4, 2, 1024)])
            print(f"parallel (c) pipeline_apply at S=1, 4 microbatches: equal to the stage "
                  f"alone: {torch.equal(got, alone)}")
            _check(torch.equal(got, alone), "parallel (c): the pipeline differs")
        finally:
            dist.destroy_process_group()
    print(f"parallel: phase {time.perf_counter() - t_phase:.1f}s")
    return {"counts": counts, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 20: long-context decode (examples/torch_long_context.py)
# ---------------------------------------------------------------------------


def phase_long_context(torch, dev) -> dict:
    """See the module docstring (20)."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_long_context as ex

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    for arch, cut in (("rwkv6-1.6b", None), ("jamba-v0.1-52b", JAMBA_LAYERS)):
        full = get_config(arch)
        cfg = full if cut is None else full.with_(n_layers=cut)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        got = {}
        for ctx in ex.CONTEXTS:
            ms, got[ctx] = ex.measure(cfg, params, ctx, dev)
            line = (f"long context {arch} ({cfg.n_layers} of {full.n_layers} layers) ctx "
                    f"{ctx}: {ms:.2f} ms/token over {ex.DECODE} decode steps after a "
                    f"{ex.PROMPT}-token prefill, cache {got[ctx]} bytes")
            if "attn" in cfg.pattern:
                i8, bf = ex.kv_bytes(cfg, ctx, torch.int8), ex.kv_bytes(cfg, ctx, torch.bfloat16)
                line += f"; K/V int8 {i8} bytes vs bf16 {bf} ({i8 / bf:.2f}x)"
                _check(2 * i8 == bf, f"long context {arch}: int8 K/V {i8} vs bf16 {bf}")
            print(line)
            _check(math.isfinite(ms) and ms > 0, f"long context {arch}: {ms} ms")
        if "attn" not in cfg.pattern:
            _check(len(set(got.values())) == 1, f"long context {arch}: cache bytes {got}")
        print(f"long context {arch}: {time.perf_counter() - t0:.1f}s")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"long context: phase {time.perf_counter() - t_phase:.1f}s")
    return {"counts": {}, "runs": 1, "inplace": {}}


# ---------------------------------------------------------------------------
# phase 21: the dry run's cells and their sharded paths
# ---------------------------------------------------------------------------


def _dryrun_procs(tmp: str) -> list:
    """Start ``launch.dryrun`` on each of ``DRYRUN_CELLS`` (CPU-only: no
    card is visible to them)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(os.path.join(tmp, f"{arch}.{shape}.log"), "w+")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", "single", "--out", tmp]
        procs.append((arch, shape, log, time.perf_counter(),
                      subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT)))
    return procs


def _dryrun_results(procs, tmp: str, deadline: float) -> None:
    """Wait for the dry runs, print each cell's terms, check each."""
    try:
        for arch, shape, log, t0, p in procs:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = None
            log.seek(0)
            text = log.read()
            _check(rc == 0, f"cells (c): dryrun {arch} x {shape} exit {rc}: {text[-3000:]}")
            with open(os.path.join(tmp, f"{arch}__{shape}__single__baseline.json")) as f:
                res = json.load(f)
            _check(res["status"] == "ok", f"cells (c): {arch} x {shape} status {res['status']}")
            terms = {k: res[k] for k in ("flops_per_dev", "hbm_bytes_per_dev",
                                         "coll_bytes_per_dev", "t_compute_s", "t_memory_s",
                                         "t_collective_s", "dominant", "useful_flops_ratio")}
            print(f"cells (c) dry run {arch} x {shape} x single (256 ranks): "
                  f"{json.dumps(terms)}; memory {json.dumps(res['memory'])}; run "
                  f"{res['run_s']} s, process {time.perf_counter() - t0:.1f} s")
            if shape == "long_500k":
                seq = 524288
                whole = [e for e in res["collective_log"] if seq in e[1]]
                print(f"cells (c) {arch} long_500k: {len(res['collective_log'])} distinct "
                      f"collectives, none spanning the {seq}-slot cache: {not whole}")
                _check(not whole, f"cells (c): collectives over the whole cache {whole}")
    finally:
        for *_, log, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def phase_cells(torch, dev) -> dict:
    """See the module docstring (21)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm, quantize_vggt
    from repro_torch.kernels import probe
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm, vggt
    from repro_torch.parallel import sharding
    from repro_torch.sharded import is_dtensor

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    counts: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = _dryrun_procs(tmp)
        deadline = time.perf_counter() + DRYRUN_TIMEOUT
        backend = _process_group(torch, dev, os.path.join(tmp, "pg"))
        try:
            mesh = make_local_mesh(1, 1, device_type=dev.type)

            # (a) vggt-1b on the vggt_serve_s8 cell's stream, with and without act-SP
            cfg = get_config("vggt-1b").with_(attn_impl="two_stage")
            t0 = time.perf_counter()
            raw = vggt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                params = quantize_vggt(cfg, raw, _plan(False))
            del raw
            x = _scenes(torch, dev, CELL_SCENES, 0)
            bspec, aspec = specs.vggt_stream_specs(mesh, CELL_SCENES)
            ps = sharding.distribute_tree(params, mesh)
            xs = sharding.distribute_tree(x, mesh, lambda p, t: bspec)
            keys = ("pose", "depth", "points", "conf")
            runs = {"unsharded": lambda: vggt.forward(cfg, params, x)}
            for name, act in (("batch", None), ("batch + act-SP", aspec)):
                spec = None if act is None else sharding.NamedSharding(mesh, act)
                runs[name] = lambda spec=spec: vggt.forward(cfg, ps, xs, act_sharding=spec)
            outs, logs = {}, {}
            for name, fwd in runs.items():
                with torch.no_grad(), implicit_replication(), probe.tracking() as log:
                    out, first = _timed(torch, dev, fwd)
                    warm = [_timed(torch, dev, fwd)[1] for _ in range(2)]
                outs[name] = {k: out[k].full_tensor() if is_dtensor(out[k]) else out[k]
                              for k in keys}
                logs[name] = {k: v // 3 for k, v in log.by_name().items()}
                if name != "unsharded":
                    for k, v in log.by_name().items():
                        counts[k] = counts.get(k, 0) + v
                print(f"cells (a) vggt-1b W4A8 two-stage {CELL_SCENES} x {S_FRAMES} x "
                      f"{N_PATCHES} {name}: first call {first:.1f} ms, warm "
                      f"{[f'{t:.1f}' for t in warm]} ms; launches a forward {logs[name]}")
            for name in runs:
                same = all(torch.equal(outs[name][k], outs["unsharded"][k]) for k in keys)
                print(f"cells (a) {name}: outputs bit-equal to the unsharded forward: {same}")
                _check(same, f"cells (a): {name} outputs differ")
                _check(logs[name] == logs["unsharded"],
                       f"cells (a): {name} launches {logs[name]} vs {logs['unsharded']}")
            _check(logs["unsharded"] == {"quant_matmul": 12 * cfg.n_layers,
                                         "two_stage_attention": 2 * cfg.n_layers},
                   f"cells (a): unsharded launches {logs['unsharded']}")
            _check(all(bool(torch.isfinite(v).all()) for v in outs["unsharded"].values()),
                   "cells (a): outputs not finite")
            print(f"cells (a): {time.perf_counter() - t0:.1f}s")
            del params, ps, outs
            gc.collect()
            torch.cuda.empty_cache()

            # (b) jamba decode through sequence-sharded caches
            full = get_config("jamba-v0.1-52b")
            cfg = full.with_(n_layers=JAMBA_LAYERS)
            t0 = time.perf_counter()
            raw = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                params = quantize_lm(cfg, raw, _plan(False))
            del raw
            gc.collect()
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(8)
            prompt = torch.randint(0, cfg.vocab_size, (1, CELL_PROMPT), generator=gen, device=dev)
            ps = sharding.distribute_tree(params, mesh)

            def greedy(tree, cache):
                logits, cache = lm.forward(cfg, tree, prompt, cache=cache, mode="prefill")
                steps = []
                for _ in range(CELL_DECODE):
                    last = logits.full_tensor() if is_dtensor(logits) else logits
                    nxt = last[:, -1].argmax(-1)
                    logits, cache = lm.decode_step(cfg, tree, nxt, cache)
                    steps.append((nxt, logits.full_tensor() if is_dtensor(logits) else logits))
                return torch.stack([i for i, _ in steps]), torch.stack([g for _, g in steps])

            length = CELL_PROMPT + CELL_DECODE
            with torch.no_grad():
                want_ids, want = greedy(params, lm.init_cache(cfg, 1, length, device=dev))
            for name, flags in (("seq_axis_shard", dict(seq_axis_shard=True)),
                                ("seq_model_shard", dict(seq_axis_shard=False,
                                                         seq_model_shard=True))):
                cache = lm.init_cache(cfg, 1, length, device=dev)
                cache = sharding.distribute_tree(cache, mesh, sharding.spec_at(
                    sharding.cache_pspecs(cfg, cache, mesh, **flags)))
                with torch.no_grad(), implicit_replication(), probe.tracking() as log:
                    (ids, got), ms = _timed(torch, dev, lambda: greedy(ps, cache))
                for k, v in log.by_name().items():
                    counts[k] = counts.get(k, 0) + v
                same = torch.equal(ids, want_ids) and torch.equal(got, want)
                print(f"cells (b) jamba ({JAMBA_LAYERS} of {full.n_layers} layers) W4A8, cache "
                      f"{name}: {CELL_PROMPT}-token prefill + {CELL_DECODE} decode steps "
                      f"{ms:.1f} ms; ids {ids.flatten().tolist()}; ids and logits equal to "
                      f"the unsharded cache's: {same} (max |diff| "
                      f"{float((got - want).abs().max()):.3g}); launches {log.by_name()}")
                _check(same, f"cells (b): {name} decode differs")
            print(f"cells (b): {time.perf_counter() - t0:.1f}s")
            del params, ps, cache
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        _dryrun_results(procs, tmp, deadline)
    print(f"cells: phase {time.perf_counter() - t_phase:.1f}s ({backend})")
    return {"counts": counts, "runs": 1, "inplace": {}}


if __name__ == "__main__":
    sys.exit(main())
